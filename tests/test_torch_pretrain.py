"""Oscar+ pretraining, ``explore`` and the discrete-code features in the
port against the JAX package on the CPU, in f32 at a tiny size
(``tiny_bert_config``, or 2 layers of 32): the ``dis_code`` / ``dis_code_t``
forwards and ``BertImgForPreTraining``'s logits, the code table through
``utils/convert``, ``run_vqa --img_feature_type dis_code[_t]`` against the
JAX ``main`` (with a VQ-VAE codebook), ``data/pretrain`` batches bit for bit,
``run_oscarplus_pretrain.main`` against the JAX ``main`` (and its
``--resume``), ``explore``'s template and soft modes against the JAX tool
and ``soft_prompt_optimizer`` against optax.

JAX trees cross into the port through ``params_from_jax`` (the fresh heads
are flax's draws); dropout is 0 in both packages (their masks come from
different generators)."""
import dataclasses
import functools
import json
import os
import pickle
import random
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.data import pretrain as jpretrain
from cpt_tpu.models.bert import heads as jheads
from cpt_tpu.tools import explore as jexplore
from cpt_tpu.tools import run_oscarplus_pretrain as jpre
from cpt_tpu.tools import run_vqa as jrun_vqa
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu.utils.tsv import encode_feature, tsv_writer
from cpt_tpu_torch.config import bert as bert_cfg
from cpt_tpu_torch.data import pretrain
from cpt_tpu_torch.engine import scoring
from cpt_tpu_torch.models.bert.heads import BertImgForPreTraining
from cpt_tpu_torch.tools import explore
from cpt_tpu_torch.tools import run_oscarplus_pretrain as pre
from cpt_tpu_torch.tools import run_vqa
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from test_torch_oscar_data import D, fixture_paths
from test_torch_oscar_runners import JitSpy, no_dropout
from test_torch_distributed import multi_process_env
from test_torch_watchdog import guards

guard_module, guard_case = guards(600)

FORWARD_TOL = 1e-5       # logits, as a fraction of their largest magnitude
LOSS_TOL = 1e-4          # pretraining losses over 3 steps
PARAM_ATOL = 1e-4        # parameters after a few optimizer steps
SOFT_OPT_ATOL = 1e-6     # the soft-prompt optimizer against optax
CAPTIONS = ("a man with a dog", "the woman in a blue shirt stands", "a red car",
            "two cats on a tree", "a tree near the water", "a dog on the grass")


def tokenizers():
    return (jtok.BertTokenizer(jtok.toy_vocab()),
            tok.BertTokenizer(tok.toy_vocab()))


def code_config(kind: str, pkg):
    kw = dict(img_feature_type=kind, code_voc=8, code_dim=16, vocab_size=192)
    if kind == "dis_code_t":
        kw["code_size"] = 5
    elif kind == "faster_r-cnn":
        kw = dict(vocab_size=192, img_feature_dim=D)
    return pkg.tiny_bert_config(**kw)


@pytest.mark.parametrize("kind,classes", [("dis_code", 2), ("dis_code_t", 2),
                                          ("faster_r-cnn", 3)])
def test_pretraining_forward_matches_jax(kind, classes):
    """``BertImgForPreTraining`` (MLM and NSP logits) on code ids through the
    code table (``dis_code``; ``dis_code_t`` transposed, 16 image
    positions) and on region features with a 3-way head, within FORWARD_TOL
    of the JAX model carrying the same tree."""
    jcfg = dataclasses.replace(code_config(kind, jbert_cfg),
                               num_contrast_classes=classes)
    cfg = dataclasses.replace(code_config(kind, bert_cfg),
                              num_contrast_classes=classes)
    rng = np.random.RandomState(3)
    b, t = 3, 10
    ids = rng.randint(5, 190, (b, t)).astype(np.int32)
    segs = (np.arange(t) > 5).astype(np.int32)[None].repeat(b, 0)
    if kind == "faster_r-cnn":
        feats = rng.randn(b, 6, D).astype(np.float32)
    else:
        feats = rng.randint(0, 8, (b, 5)).astype(np.int32)
    n_img = 16 if kind == "dis_code_t" else feats.shape[1]
    attn = np.ones((b, t + n_img), np.int32)
    attn[0, -3:] = 0
    jmodel = jheads.BertImgForPreTraining(jcfg)
    args = tuple(map(jnp.asarray, (ids, segs, attn, feats)))
    params = jmodel.init(jax.random.PRNGKey(1), *args)
    _, jmlm, jnsp = jmodel.apply(params, *args)
    model = BertImgForPreTraining(cfg)
    model.load_state_dict(bconv.params_from_jax(params, cfg, "pretraining"))
    _, mlm, nsp = model(*(torch.from_numpy(a) for a in (ids, segs, attn, feats)))
    for got, want in ((mlm, jmlm), (nsp, jnsp)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.detach().numpy() - want).max()) <= (
            FORWARD_TOL * float(np.abs(want).max()))
    assert nsp.shape[-1] == classes


def test_code_table_crosses_convert_both_ways():
    """An Oscar state dict with ``bert.code_embeddings.weight`` into both
    packages: the port's table equals the JAX converter's, and
    ``params_from_jax`` carries it back; ``jax_paths`` names it; the random
    state dict draws it last, after the region-feature layout's draws."""
    cfg = code_config("dis_code", bert_cfg)
    jcfg = code_config("dis_code", jbert_cfg)
    sd = bconv.random_oscar_state_dict(cfg, seed=4)
    assert sd["bert.code_embeddings.weight"].shape == (8, 16)
    assert sd["bert.img_embedding.weight"].shape == (32, 16)
    port = bconv.state_from_reference(sd, cfg, "rec_mlm_cpt")
    jtree = jconv.convert_bert_state_dict(sd, jcfg)
    np.testing.assert_array_equal(port["bert.code_embeddings"].numpy(),
                                  jtree["bert"]["code_embeddings"]["embedding"])
    back = bconv.params_from_jax({"params": jconv.params_for_task(
        jtree, "rec_mlm_cpt")}, cfg, "rec_mlm_cpt")
    assert torch.equal(back["bert.code_embeddings"], port["bert.code_embeddings"])
    assert bconv.jax_paths(cfg, "bert_only")["bert.code_embeddings"] == (
        "bert", "code_embeddings", "embedding")
    plain = bconv.random_oscar_state_dict(
        bert_cfg.tiny_bert_config(vocab_size=192, img_feature_dim=16), seed=4)
    for k, v in plain.items():
        np.testing.assert_array_equal(sd[k], v)


def code_fixture(root, codebook: bool) -> str:
    """The JAX package's dis_code runner fixture: 8 images of 5 code ids in
    3..7, the first the answer's signal (1 + label); with ``codebook`` a
    ``vqvae/`` holding the top level's codes and a [16, 8] codebook.""" 
    rng = np.random.RandomState(0)
    feats, qla = {}, []
    for q in range(8):
        sig = q % 2
        codes = rng.randint(3, 8, size=(5,))
        codes[0] = 1 + sig
        feats[f"im{q}"] = torch.tensor(codes, dtype=torch.long)
        qla.append({"q": "is the dog red", "o": "park", "an": [sig],
                    "s": [1.0], "img_id": f"im{q}", "q_id": q})
    torch.save(feats, os.path.join(root, "train2014_img_frcnn_feats.pt"))
    with open(os.path.join(root, "train2014_qla.json"), "w") as f:
        json.dump(qla, f)
    if codebook:
        # the runner reads the codebook from vqvae/train.pt, the loader a
        # split's codes from vqvae/{split}.pt
        os.makedirs(os.path.join(root, "vqvae"))
        vq = {"embeddings_t": rng.randn(16, 8).astype(np.float32),
              "feats_top": feats}
        for name in ("train", "train2014"):
            torch.save(vq, os.path.join(root, "vqvae", f"{name}.pt"))
    return root


@pytest.mark.parametrize("kind", ["dis_code", "dis_code_t"])
def test_run_vqa_discrete_codes_match_jax(kind, tmp_path, monkeypatch):
    """``run_vqa --img_feature_type dis_code`` with a codebook (the code
    table initialized from it, the geometry read from it) and
    ``dis_code_t`` without one, 2 epochs of 1 step, against the JAX
    ``main``: the same score and predictions, and the trained parameters
    within PARAM_ATOL."""
    root = code_fixture(str(tmp_path), codebook=kind == "dis_code")
    monkeypatch.setattr(jrun_vqa, "model_config", no_dropout(jrun_vqa.model_config))
    monkeypatch.setattr(run_vqa, "model_config", no_dropout(run_vqa.model_config))
    trees, built = [], []
    real_init = jrun_vqa.load_or_init
    monkeypatch.setattr(jrun_vqa, "load_or_init", lambda *a, **kw: trees.append(
        real_init(*a, **kw)) or trees[-1])
    spy = JitSpy()
    monkeypatch.setattr(jrun_vqa, "jax", spy)
    real_build = run_vqa.build_model

    def build(*a):
        model = real_build(*a)
        if kind == "dis_code":
            # the codebook's transpose, before the JAX tree replaces it
            emb = torch.load(os.path.join(root, "vqvae", "train.pt"),
                             weights_only=False)["embeddings_t"].T
            np.testing.assert_array_equal(
                model.bert.code_embeddings.detach().numpy(), emb)
        model.load_state_dict(bconv.params_from_jax(trees[-1], model.config,
                                                    model.TASK))
        built.append(model)
        return model

    monkeypatch.setattr(run_vqa, "build_model", build)
    argv = ["--qla_data_dir", root, "--split", "train2014",
            "--img_feature_type", kind, "--num_labels", "2", "--loss_type",
            "bce", "--max_seq_length", "16", "--max_img_seq_length", "6",
            "--num_train_epochs", "2", "--learning_rate", "1e-3",
            "--per_gpu_train_batch_size", "8", "--hidden_size", "32",
            "--num_hidden_layers", "2", "--dtype", "float32"]
    if kind == "dis_code_t":
        argv += ["--code_voc", "8", "--code_dim", "16", "--code_size", "5"]
    jacc = jrun_vqa.main(argv + ["--output", str(tmp_path / "j.pk")])
    acc = run_vqa.main(argv + ["--device", "cpu", "--output",
                               str(tmp_path / "p.pk")])
    assert acc == jacc
    with open(tmp_path / "p.pk", "rb") as f, open(tmp_path / "j.pk", "rb") as g:
        assert pickle.load(f) == pickle.load(g)
    model = built[-1]
    assert model.bert.code_embeddings.shape == (8, 16)
    want = bconv.params_from_jax(spy.params[-1], model.config, model.TASK)
    h = model.config.hidden_size

    def kept(k, v):
        # the key third of bqkv has an exact gradient of zero (the softmax
        # ignores a shift shared by a row's scores), so AdamW turns each
        # package's rounding noise into steps of its own: it is left out
        return torch.cat([v[:h], v[2 * h:]]) if k.endswith("bqkv") else v

    gaps = {k: float((kept(k, v) - kept(k, want[k])).abs().max())
            for k, v in model.state_dict().items()}
    assert max(gaps.values()) <= PARAM_ATOL, sorted(gaps.items(),
                                                    key=lambda kv: -kv[1])[:3]


def test_run_vqa_keeps_a_checkpoints_code_table(tmp_path):
    """A checkpoint that carries a code table keeps it: the raw codebook
    does not overwrite a fine-tuned code embedding; without one the
    codebook fills it."""
    root = code_fixture(str(tmp_path), codebook=True)
    flags = ["--qla_data_dir", root, "--img_feature_type", "dis_code",
             "--num_labels", "2", "--hidden_size", "32", "--num_hidden_layers",
             "2", "--dtype", "float32", "--device", "cpu"]
    cfg = run_vqa.model_config(run_vqa.build_args().parse_args(
        flags + ["--code_voc", "8", "--code_dim", "16"]), num_labels=2)
    sd = bconv.random_oscar_state_dict(cfg, seed=9)
    ckpt = tmp_path / "ckpt.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    for with_ckpt in (True, False):
        args = run_vqa.build_args().parse_args(
            flags + (["--checkpoint", str(ckpt)] if with_ckpt else []))
        vq = run_vqa.load_codebook(args)
        model = run_vqa.build_model(args, run_vqa.model_config(
            args, num_labels=2), torch.device("cpu"), vq)
        want = (sd["bert.code_embeddings.weight"] if with_ckpt
                else np.asarray(vq["embeddings_t"]).T)
        np.testing.assert_array_equal(model.bert.code_embeddings.detach().numpy(),
                                      want)


@functools.lru_cache(maxsize=None)
def pretrain_fixture() -> dict:
    """The oscar data fixture's region TSV with a caption for each image,
    a second caption file for the extra corpus, and a multi-corpus yaml
    (coco, flickr30k, googlecc in two chunks, an sbu row outside the
    corpus)."""
    p = dict(fixture_paths())
    root = tempfile.mkdtemp(prefix="pretrain_fx_")
    for name, shift in (("captions", 0), ("extra_captions", 3)):
        p[name] = os.path.join(root, f"{name}.json")
        with open(p[name], "w") as f:
            json.dump({f"im{i}": CAPTIONS[(i + shift) % 6] for i in range(6)}, f)
    rng = np.random.RandomState(0)

    def feat_rows(keys):
        return [[k, json.dumps({"objects": [
            {"rect": [0, 0, 5, 5], "class": ("dog", "red car", "tree")[j],
             "conf": 0.9, "feature": encode_feature(f)}
            for j, f in enumerate(rng.randn(3, D).astype(np.float32))]})]
            for k in keys]

    for name, keys in (("coco", [f"c{i}" for i in range(4)]),
                       ("flickr", [f"f{i}" for i in range(3)]),
                       ("cc_chunk0", ["g0", "g1"]), ("cc_chunk1", ["g2", "g3"])):
        tsv_writer(feat_rows(keys), os.path.join(root, f"{name}.tsv"))
    tsv_writer([[f"coco_c{i}", f"a dog picture {i}"] for i in range(4)]
               + [[f"flickr30k_f{i}", f"red cat {i}"] for i in range(3)]
               + [[f"cc_g{i}", f"cc caption {i}"] for i in range(4)]
               + [["sbu_x0", "excluded dataset row"]],
               os.path.join(root, "corpus.tsv"))
    p["yaml"] = os.path.join(root, "pretrain.yaml")
    with open(p["yaml"], "w") as f:
        f.write("corpus: coco_flickr30k_googlecc\ncorpus_file: corpus.tsv\n"
                "image_feature_path:\n  coco: coco.tsv\n  flickr30k: flickr.tsv\n"
                "  googlecc:\n    \"0\": cc_chunk0.tsv\n    \"1\": cc_chunk1.tsv\n"
                "  sbu: missing.tsv\n")
    return p


BATCH_CASES = {
    "default": {}, "three_way": {"texta_false_prob": 0.25},
    "no_text_b": {"use_b": False}, "textb_mode_1": {"textb_sample_mode": 1},
    "textb_mode_2": {"textb_sample_mode": 2},
    "unmatched_dropped": {"mask_loss_for_unmatched": False},
    "swap_all": {"text_b_swap_prob": 1.0, "texta_false_prob": 0.4},
    "multi_corpus": {}, "multi_corpus_chunk_0": {"chunk_start_id": 0,
                                                 "chunk_end_id": 1}}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_pretrain_batches_equal_jax(case):
    """``data/pretrain`` batches (ids, segments, mask, features, MLM labels,
    contrastive labels) equal the JAX module's bit for bit from the same
    ``random.Random`` seeds: the 2- and 3-way ladders, ``textb_sample_mode``
    0/1/2, the multi-corpus yaml and its chunk ranges."""
    p = pretrain_fixture()
    kw = BATCH_CASES[case]
    jt, pt = tokenizers()
    if case.startswith("multi"):
        jdata = jpretrain.MultiCorpusPretrainData(p["yaml"], jt, 24, 4, D, **kw)
        data = pretrain.MultiCorpusPretrainData(p["yaml"], pt, 24, 4, D, **kw)
        assert data.keys == jdata.keys and len(data) == (9 if kw else 11)
    else:
        with open(p["captions"]) as f:
            caps = json.load(f)
        jdata = jpretrain.OscarPretrainData(p["feat_file"], caps, jt, 24, 6, D, **kw)
        data = pretrain.OscarPretrainData(p["feat_file"], caps, pt, 24, 6, D, **kw)
    assert data.num_contrast_classes == jdata.num_contrast_classes
    labels = set()
    for seed in range(6):
        idx = [(seed * 3 + j) % len(data) for j in range(4)]
        got = data.batch(idx, random.Random(seed), pad_to=5)
        want = jdata.batch(idx, random.Random(seed), pad_to=5)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        labels |= set(got[5].tolist())
    if case == "swap_all":
        assert {1, 2} <= labels


PRETRAIN_CASES = {
    "default": [],
    "text_only": ["--text_only"],
    "three_way": ["--texta_false_prob", "0.25"],
    "extra_weighted": ["--extra_feat_file", "{feat_file}", "--extra_captions",
                       "{extra_captions}", "--extra_loss_weight", "0.3"],
    "yaml": ["--yaml", "{yaml}", "--max_img_seq_length", "4"]}


def pretrain_argv(case) -> list:
    p = pretrain_fixture()
    base = ([] if case == "yaml" else ["--feat_file", p["feat_file"],
                                       "--captions", p["captions"]])
    return base + [a.format(**p) for a in PRETRAIN_CASES[case]] + [
        "--train_steps", "3", "--per_gpu_train_batch_size", "4",
        "--max_seq_length", "24", "--hidden_size", "32",
        "--num_hidden_layers", "2", "--img_feature_dim", str(D), "--dtype",
        "float32", "--learning_rate", "1e-3", "--warmup_ratio", "0"] + (
        [] if case == "yaml" else ["--max_img_seq_length", "6"])


@functools.lru_cache(maxsize=None)
def jax_pretrain(case: str):
    """The JAX tool's losses and its initialized tree (dropout 0)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpre, "model_config", no_dropout(jpre.model_config))
    trees = []
    real = jpre.load_or_init
    mp.setattr(jpre, "load_or_init", lambda *a, **kw: trees.append(
        real(*a, **kw)) or trees[-1])
    try:
        losses = jpre.main(pretrain_argv(case))
    finally:
        mp.undo()
    return losses, trees[-1]


def run_port_pretrain(case, monkeypatch, extra=(), tree=None):
    """The port's tool on ``case`` (dropout 0), its model carrying ``tree``
    (the JAX init) where given. → (losses, model)."""
    monkeypatch.setattr(pre, "model_config", no_dropout(pre.model_config))
    built = []
    real = pre.build_model

    def build(*a):
        model = real(*a)
        if tree is not None:
            # a text-only JAX model has no image projection
            missing, _ = model.load_state_dict(bconv.params_from_jax(
                tree, model.config, "pretraining"), strict=False)
            assert set(missing) <= {"bert.img_embedding.kernel",
                                    "bert.img_embedding.bias"}
        built.append(model)
        return model

    monkeypatch.setattr(pre, "build_model", build)
    losses = pre.main(pretrain_argv(case) + ["--device", "cpu"] + list(extra))
    return losses, built[-1]


@pytest.mark.parametrize("case", sorted(PRETRAIN_CASES))
def test_pretrain_main_matches_jax(case, monkeypatch):
    """``run_oscarplus_pretrain.main`` against the JAX ``main`` from the
    same initialized tree: 3 steps' losses within LOSS_TOL (the default run,
    ``--text_only``, the 3-way head, a weighted second corpus and the
    multi-corpus yaml)."""
    want, tree = jax_pretrain(case)
    losses, model = run_port_pretrain(case, monkeypatch, tree=tree)
    assert len(losses) == len(want) == 3
    np.testing.assert_allclose(losses, want, rtol=0, atol=LOSS_TOL)
    assert model.nsp_head.dense.kernel.shape[1] == (3 if case == "three_way" else 2)


def test_pretrain_resume_equals_uninterrupted(monkeypatch, tmp_path):
    """A run cut at step 2 (``--max_steps 2 --save_every 1``) and resumed
    from ``--output`` to step 4 takes the uninterrupted run's last two
    losses and ends on its parameters, bit for bit (one thread)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        steps = ["--train_steps", "4"]
        whole, model = run_port_pretrain("default", monkeypatch, steps + [
            "--output", str(tmp_path / "a")])
        run_port_pretrain("default", monkeypatch, steps + [
            "--output", str(tmp_path / "b"), "--max_steps", "2", "--save_every", "1"])
        tail, resumed = run_port_pretrain("default", monkeypatch, steps + [
            "--output", str(tmp_path / "b"), "--resume"])
    finally:
        torch.set_num_threads(old)
    assert tail == whole[2:]
    for (k, a), b in zip(model.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), k


def test_pretrain_checkpoint_loads_the_encoder_alone(tmp_path):
    """``--checkpoint`` loads the encoder and drops the checkpoint's MLM and
    NSP heads for fresh ones, as the JAX tool's ``"bert_only"`` load does
    (ROADMAP, "Defects of the reference, mirrored")."""
    args = pre.build_args().parse_args(pretrain_argv("default") + [
        "--device", "cpu"])
    cfg = pre.model_config(args, num_contrast_classes=2)
    sd = bconv.random_oscar_state_dict(cfg, seed=3)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "c.pth")
    args.checkpoint = str(tmp_path / "c.pth")
    model = pre.build_model(args, cfg, torch.device("cpu"))
    np.testing.assert_array_equal(
        model.bert.embeddings.word_embeddings.detach().numpy(),
        sd["bert.embeddings.word_embeddings.weight"])
    assert not model.mlm_head.bias.any()
    assert not np.allclose(model.nsp_head.dense.kernel.detach().numpy(),
                           sd["cls.seq_relationship.weight"].T)


class F32:
    """Stands for ``jax.numpy`` in the JAX explore tool: its bf16 model
    computes in f32."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


@functools.lru_cache(maxsize=None)
def refcoco_fixture() -> dict:
    from cpt_tpu.data.synthetic import generate_refcoco_fixture

    return generate_refcoco_fixture(tempfile.mkdtemp(prefix="explore_fx_"),
                                    n_queries=6, feat_dim=134)


def explore_argv(mode) -> list:
    p = refcoco_fixture()
    return ["--synthetic", "--mode", mode, "--data_file", p["data_file"],
            "--ann_file", p["ann_file"], "--det_file", p["det_file"],
            "--templates", "1,2,3,4,5,6", "--soft_steps", "3",
            "--train_batch_size", "4"]


@functools.lru_cache(maxsize=None)
def jax_explore(mode: str):
    """The JAX tool's results in f32 and its initialized tree."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jexplore, "jnp", F32())
    trees = []
    real = jexplore._setup

    def setup(*a):
        out = real(*a)
        # a copy: the JAX train step donates (deletes) the tree it is given
        trees.append(jax.tree_util.tree_map(np.array, out[1]))
        return out

    mp.setattr(jexplore, "_setup", setup)
    try:
        return jexplore.main(explore_argv(mode)), trees[0]
    finally:
        mp.undo()


@pytest.mark.parametrize("mode", ["templates", "soft"])
def test_explore_matches_jax(mode, monkeypatch):
    """``explore`` in f32 on the JAX tool's initialized tree: every
    template's zero-shot accuracy (templates mode), and the accuracy before
    and after 3 soft-prompt steps with each slot's readout tokens (soft
    mode), equal to the JAX tool's; every query's best candidate clears
    its second by more than 1e-4 (so the accuracies are not decided by a
    near-tie); the table's rows off the slots stay bit-equal."""
    want, tree = jax_explore(mode)
    gaps, models = [], []
    real_collect = scoring.refcoco_collect_scores

    def collect(*a):
        grouped = real_collect(*a)
        for scores, _ in grouped.values():
            top = sorted(scores, reverse=True)[:2]
            gaps.append(top[0] - top[1] if len(top) == 2 else np.inf)
        return grouped

    real_build = explore.build_model

    def build(*a):
        model, t = real_build(*a)
        model.load_state_dict(bconv.params_from_jax(tree, model.config,
                                                    "rec_mlm_cpt"))
        models.append((model, model.bert.embeddings.word_embeddings.detach().clone()))
        return model, t

    monkeypatch.setattr(scoring, "refcoco_collect_scores", collect)
    monkeypatch.setattr(explore, "build_model", build)
    got = explore.main(explore_argv(mode) + ["--device", "cpu", "--dtype",
                                             "float32"])
    assert min(gaps) > 1e-4
    if mode == "templates":
        assert got == want and len(got) == 6
        return
    assert got["soft_before"] == want["soft_before"]
    assert got["soft_after"] == want["soft_after"]
    for g, w in zip(got["soft_readout"], want["soft_readout"]):
        assert [t for t, _ in g[:5]] == [t for t, _ in w[:5]]
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                   atol=1e-4)
    model, start = models[0]
    table = model.bert.embeddings.word_embeddings.detach()
    slots = tok.BertTokenizer(tok.toy_vocab()).convert_tokens_to_ids(
        [f"[unused{i}]" for i in range(1, 5)])
    rest = torch.ones(table.shape[0], dtype=torch.bool)
    rest[slots] = False
    assert torch.equal(table[rest], start[rest])
    assert not torch.equal(table[slots], start[slots])


def test_soft_prompt_optimizer_matches_optax():
    """Three AdamW steps on random gradients: the slot rows within
    SOFT_OPT_ATOL of the JAX ``soft_prompt_optimizer`` (optax's ``adamw``
    with its default decay 1e-4), every other row bit-equal to its start
    (gradient and update both zeroed, so no decay)."""
    rng = np.random.RandomState(8)
    table0 = rng.randn(40, 8).astype(np.float32)
    slots = [2, 3, 7, 11]
    jtx = jexplore.soft_prompt_optimizer(slots, 0.02)
    jparams = {"params": {"bert": {"embeddings": {"word_embeddings": {
        "embedding": jnp.asarray(table0)}}}, "mlm_head": {"bias": jnp.ones(40)}}}
    jstate = jtx.init(jparams)
    tx = explore.SoftPromptOptimizer(slots, 0.02)
    table = torch.from_numpy(table0.copy())
    state = tx.init([table])
    for _ in range(3):
        g = rng.randn(40, 8).astype(np.float32)
        jg = {"params": {"bert": {"embeddings": {"word_embeddings": {
            "embedding": jnp.asarray(g)}}}, "mlm_head": {"bias": jnp.ones(40)}}}
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tx.update([torch.from_numpy(g)], state, [table])
    want = np.asarray(jparams["params"]["bert"]["embeddings"]["word_embeddings"]
                      ["embedding"])
    np.testing.assert_allclose(table.numpy(), want, rtol=0, atol=SOFT_OPT_ATOL)
    rest = np.setdiff1d(np.arange(40), slots)
    np.testing.assert_array_equal(table.numpy()[rest], table0[rest])
    np.testing.assert_array_equal(np.asarray(jparams["params"]["mlm_head"]["bias"]),
                                  np.ones(40))


def test_explore_checkpoint_loads_where_jax_raises(tmp_path):
    """``explore --checkpoint`` raises in JAX (``merge_pretrained_into_init``
    called with three arguments, ``cpt_tpu/tools/explore.py:90-93``); the
    port loads the checkpoint in the ``REC_MLM_CPT`` layout (ROADMAP, "Known
    and kept on purpose")."""
    cfg = bert_cfg.tiny_bert_config(vocab_size=192, img_feature_dim=134)
    sd = bconv.random_oscar_state_dict(cfg, seed=12)
    path = tmp_path / "c.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    argv = explore_argv("templates") + ["--checkpoint", str(path),
                                        "--templates", "1"]
    with pytest.raises(TypeError):
        jexplore.main(argv)
    args = explore.build_args().parse_args(argv + ["--device", "cpu",
                                                   "--dtype", "float32"])
    model, _ = explore.build_model(args, torch.device("cpu"))
    np.testing.assert_array_equal(
        model.bert.embeddings.word_embeddings.detach().numpy(),
        sd["bert.embeddings.word_embeddings.weight"])
    np.testing.assert_array_equal(model.mlm_head.bias.detach().numpy(),
                                  sd["cls.predictions.bias"])
    assert np.isfinite(explore.main(argv + ["--device", "cpu", "--dtype",
                                            "float32"])["template1"])


def test_pretrain_refusals(monkeypatch):
    """The discrete codes are refused with the JAX tool's message (its
    loaders read region features only); a multi-process launch named item
    9 until the process runtime was ported: the tool now runs under one
    (``test_torch_distributed.multi_process_env``)."""
    with pytest.raises(SystemExit, match="supported by run_vqa / run_gqa"):
        pre.main(pretrain_argv("default") + ["--device", "cpu",
                                             "--img_feature_type", "dis_code"])
    calls = multi_process_env(monkeypatch)
    pre.main(pretrain_argv("default") + ["--device", "cpu"])
    assert calls == [True]


def test_phase15_dry_run():
    """``chip_smoke.run_pretraining_phase`` on the CPU at a narrow width (2
    layers of 32): every reading is taken; what fails are the kernel-launch
    checks (no card) and, at so narrow a random encoder, the loss faults.
    One thread, so the resumed run is bit-equal to its twin."""
    import ast

    import chip_smoke as cs
    from cpt_tpu_torch.config.bert import OSCAR_BASE

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(AssertionError) as e:
            cs.run_pretraining_phase(
                cs.kernel_counters(), "cpu", [], torch.device("cpu"),
                torch.float32, dataclasses.replace(
                    OSCAR_BASE, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=2, intermediate_size=128))
    finally:
        torch.set_num_threads(old)
    failures = ast.literal_eval(e.value.args[0][len("phase 15: "):])
    launch = [f for f in failures if "launches" in f or "--drop_out 0" in f]
    assert len(launch) == 4, failures
    assert all(f.startswith("pretraining losses: a fault passes")
               for f in failures if f not in launch), failures
