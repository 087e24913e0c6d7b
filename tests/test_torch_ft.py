"""The full-finetune baselines, the port against the JAX package on the CPU
in f32 at a tiny size (2 layers, hidden 64), from the same numpy-seeded
inputs and the same parameters (the JAX model's whole tree, fresh heads
included, carried over by ``params_from_jax``): the six FT heads' outputs
and losses, the fresh heads' initializers, the ``bert_only`` load, three
``make_cls_train_step`` steps against optax, ``refcoco_ft``'s data and
tool, and the FT variants of ``gqa_cpt`` (with ``--save_dir``) and
``vcr_nsp_cpt``."""
import functools
import json
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.data.synthetic import generate_gqa_fixture, generate_vcr_fixture
from cpt_tpu.engine import train as jtrain
from cpt_tpu.models.bert import heads as jheads
from cpt_tpu.tools import gqa_cpt as jgqa_tool
from cpt_tpu.tools import refcoco_ft as jrefcoco_ft
from cpt_tpu.tools import vcr_nsp_cpt as jvcr_tool
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.engine import train
from cpt_tpu_torch.models.bert import heads
from cpt_tpu_torch.tools import gqa_cpt, refcoco_ft, vcr_nsp_cpt
from cpt_tpu_torch.utils import checkpoint as ckpt_lib
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

# logits, scores and losses of a tiny BERT in f32, as a fraction of the
# largest |value| (losses: of max(1, |loss|)): summation-order noise only
LOGIT_TOL = 1e-5
# the tools' candidate and class scores in f32 (absolute)
SCORE_TOL = 1e-4
# 3 AdamW steps on gradients that agree to f32 noise (parameters O(0.1-1)),
# the tolerance tests/test_torch_train.py holds the MLM step to
PARAM_ATOL = 1e-5

VOCAB, DIM, T, R = 160, 20, 12, 6


def _configs(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=64, num_attention_heads=4,
                intermediate_size=128, img_feature_dim=DIM, num_labels=5)
    base.update(kw)
    return jax_tiny_bert_config(**base), tiny_bert_config(**base)


def _inputs(seed, n=4, nc=None):
    """ids, segment ids, attention mask and features of ``n`` sequences
    (``n × nc`` reshaped to [n, nc, ...] with ``nc``), some padding."""
    rng = np.random.RandomState(seed)
    m = n * (nc or 1)
    ids = rng.randint(1, VOCAB, (m, T)).astype(np.int32)
    ids[:, 0] = 101
    seg = (np.arange(T) >= 5).astype(np.int32)[None].repeat(m, 0)
    mask = np.ones((m, T + R), np.int32)
    mask[1, 9:T] = 0
    mask[2, T + 3:] = 0
    feats = rng.randn(m, R, DIM).astype(np.float32)
    out = (ids, seg, mask, feats)
    return tuple(a.reshape((n, nc) + a.shape[1:]) for a in out) if nc else out


def _labels(name, loss_type, seed=7, n=4):
    """The label arguments of one head's forward (JAX names)."""
    rng = np.random.RandomState(seed)
    if name == "rec_ft":
        box_mask = np.ones((n, R), bool)
        box_mask[0, 4:] = False
        box_mask[3, 2:] = False
        return {"box_mask": box_mask,
                "target_idx": np.asarray([2, 5, -1, 1], np.int32)}
    if name in ("nsp_ft", "vcr_qar_nsp_ft"):
        return {"next_sentence_label": np.asarray([0, 1, -1, 1], np.int32)}
    if name == "vg_ft":
        pairs = rng.randint(0, R, (n, 3, 2)).astype(np.int32)
        rel = rng.randint(0, 51, (n, 3)).astype(np.int32)
        rel[1, 2] = rel[3, 0] = -100
        return {"pairs": pairs, "rel_labels": rel}
    if name == "multiple_choice":
        return {"labels": np.asarray([0, 1, 1, -1], np.int32)}
    if loss_type == "kl":
        soft = rng.rand(n, 5) * (rng.rand(n, 5) > 0.4)
        soft[:, 0] += 0.1
        return {"labels": (soft / soft.sum(1, keepdims=True)).astype(np.float32)}
    if loss_type == "bce":
        return {"labels": rng.choice([0.0, 0.3, 1.0], (n, 5)).astype(np.float32)}
    return {"labels": np.asarray([3, 0, -1, 4], np.int32)}


# name → (JAX class, port class, constructor kwargs, config kwargs)
HEADS = {
    "rec_ft": (jheads.REC_FT, heads.REC_FT, {"txt_seq_len": T}),
    "nsp_ft": (jheads.NSPFT, heads.NSPFT, {}),
    "vcr_qar_nsp_ft": (jheads.VCR_QAR_NSPFT, heads.VCR_QAR_NSPFT, {}),
    "vg_ft": (jheads.VGFT, heads.VGFT, {"txt_seq_len": T}),
    "seq_classification": (jheads.ImageBertForSequenceClassification,
                           heads.ImageBertForSequenceClassification, {}),
    "multiple_choice": (jheads.ImageBertForMultipleChoice,
                        heads.ImageBertForMultipleChoice, {"num_choices": 2}),
}
CASES = [("rec_ft", {}, {}), ("nsp_ft", {}, {}),
         ("vcr_qar_nsp_ft", {}, {"head": "ans"}),
         ("vcr_qar_nsp_ft", {}, {"head": "rat"}), ("vg_ft", {}, {})]
CASES += [("seq_classification", {"classifier": c, "loss_type": l}, {})
          for c in ("linear", "mlp") for l in ("xe", "kl", "bce")]
CASES += [("multiple_choice", {"classifier": "linear"}, {}),
          ("multiple_choice", {"classifier": "mlp"}, {}),
          ("multiple_choice", {"classifier": "mlp", "use_img_layernorm": True}, {})]


def _case_id(case):
    name, ckw, kw = case
    return "-".join([name] + [str(v) for v in ckw.values()]
                    + [str(v) for v in kw.values()])


@functools.lru_cache(maxsize=None)
def _models(name, ckw_items=()):
    """(JAX model, JAX params, port model) of head ``name``: the JAX tree
    is flax's init with the encoder of a seeded reference-layout state dict
    merged in (the tools' ``bert_only`` load); the port takes that whole
    tree through ``params_from_jax``."""
    jcls, pcls, kw = HEADS[name]
    jcfg, cfg = _configs(**dict(ckw_items))
    jmodel = jcls(jcfg, dtype=jnp.float32, **kw)
    nc = kw.get("num_choices")
    inputs = _inputs(0, nc=nc)
    extra = ({"pairs": _labels("vg_ft", None)["pairs"]} if name == "vg_ft"
             else {})
    init = jax.jit(functools.partial(jmodel.init, **extra))(
        jax.random.PRNGKey(3), *inputs[:3], img_feats=inputs[3])
    sd = jconv.random_oscar_state_dict(jcfg, seed=5)
    jparams = {"params": jconv.merge_pretrained_into_init(
        init["params"], jconv.params_for_task(
            jconv.convert_bert_state_dict(sd, jcfg), "bert_only"))}
    port = pcls(cfg, dtype=torch.float32, **kw).eval()
    port.load_state_dict(bconv.params_from_jax(jparams, cfg, port.TASK))
    return jmodel, jparams, port


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_heads_match_jax(case):
    """Each head's outputs and loss on the same inputs and parameters."""
    name, ckw, kw = case
    jmodel, jparams, port = _models(name, tuple(sorted(ckw.items())))
    nc = HEADS[name][2].get("num_choices")
    inputs = _inputs(1, nc=nc)
    labels = _labels(name, ckw.get("loss_type"))
    want = jax.jit(lambda p, *a, **k: jmodel.apply(p, *a, **k, **kw))(
        jparams, *inputs[:3], img_feats=inputs[3], **labels)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in inputs[:3]),
                   img_feats=torch.from_numpy(inputs[3]),
                   **{k: torch.from_numpy(v) for k, v in labels.items()}, **kw)
    assert len(got) == len(want)
    wloss, gloss = float(want[0]), float(got[0])
    assert np.isfinite(gloss) and abs(gloss - wloss) <= LOGIT_TOL * max(1.0, abs(wloss))
    w, g = np.asarray(want[1]), got[1].numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL * np.abs(w).max())
    if name == "rec_ft":        # the argmax, and the filled empty slots
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert (g[~labels["box_mask"]] == heads.ATTN_FILL).all()


@pytest.mark.parametrize("case", CASES[:5] + CASES[6:7] + CASES[-1:],
                         ids=_case_id)
def test_bert_only_load_matches_jax(case):
    """``load_bert_only`` fills the encoder as JAX's ``bert_only`` merge
    does (bit for bit) and leaves exactly the fresh head unloaded; the CPT
    loads refuse a finetune task."""
    name, ckw, _ = case
    _, jparams, want = _models(name, tuple(sorted(ckw.items())))
    jcls, pcls, kw = HEADS[name]
    cfg = want.config
    port = pcls(cfg, dtype=torch.float32, **kw)
    port.init_heads(torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in port.state_dict().items()}
    jcfg = _configs(**ckw)[0]
    bconv.load_bert_only(port, jconv.random_oscar_state_dict(jcfg, seed=5))
    head = set(bconv.jax_paths(cfg, port.TASK)) - set(bconv.jax_paths(cfg, "bert_only"))
    assert head and all(not k.startswith("bert.") for k in head)
    for k, v in port.state_dict().items():
        assert torch.equal(v, fresh[k] if k in head else want.state_dict()[k]), k
    with pytest.raises(ValueError, match="bert_only"):
        bconv.state_from_reference({}, cfg, port.TASK)
    # a parameter outside the known head is left unloaded: the load refuses
    port.stray = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(KeyError, match="fresh head"):
        bconv.load_bert_only(port, jconv.random_oscar_state_dict(jcfg, seed=5))


def test_fresh_heads_draw_flax_defaults():
    """``init_heads``: Dense kernels from flax's lecun_normal (a normal of
    variance 1/fan_in truncated at two of its standard deviations), biases
    0, LayerNorm scales 1; the same generator seed gives the same head."""
    _, cfg = _configs(classifier="mlp", use_img_layernorm=True,
                      hidden_size=256, num_attention_heads=4,
                      intermediate_size=256, cls_hidden_scale=2)
    model = heads.ImageBertForMultipleChoice(cfg, num_choices=2)
    model.init_heads(torch.Generator().manual_seed(0))
    w = model.cls_hidden.kernel.detach().numpy()          # [512, 512]
    flax = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), w.shape, jnp.float32))
    bound = 2.0 * (1.0 / w.shape[0]) ** 0.5 / 0.87962566103423978
    for x in (w, flax):
        assert np.abs(x).max() <= bound * (1 + 1e-6)
        assert abs(x.std() * np.sqrt(w.shape[0]) - 1.0) < 0.01
        assert abs(x.mean()) < 3e-3
    assert (model.cls_out.bias.detach() == 0).all()
    assert (model.cls_LayerNorm.scale.detach() == 1).all()
    assert (model.cls_LayerNorm.bias.detach() == 0).all()
    again = heads.ImageBertForMultipleChoice(cfg, num_choices=2)
    again.init_heads(torch.Generator().manual_seed(0))
    assert torch.equal(again.cls_out.kernel, model.cls_out.kernel)


@pytest.mark.parametrize("classifier,loss_type", [("linear", "xe"),
                                                  ("mlp", "kl"),
                                                  ("mlp", "bce")])
def test_cls_train_step_matches_jax(classifier, loss_type):
    """3 dropout-free ``make_cls_train_step`` steps (AdamW, clip 1.0, the
    ``cls_*`` head at lr_mul 2) against JAX's: each loss and every
    parameter after the third."""
    name = "seq_classification"
    jmodel, cached, _ = _models(name, tuple(sorted(
        {"classifier": classifier, "loss_type": loss_type}.items())))
    # the step donates its state: a copy of the shared tree
    jparams = jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)), cached)
    _, cfg = _configs(classifier=classifier, loss_type=loss_type)
    port = heads.ImageBertForSequenceClassification(cfg)
    initial = bconv.params_from_jax(cached, cfg, port.TASK)
    port.load_state_dict(initial)
    batches = [_inputs(10 + i) + (_labels(name, loss_type, seed=20 + i)["labels"],)
               for i in range(3)]
    ocfg = dict(learning_rate=1e-3, weight_decay=0.05, warmup_steps=1,
                num_train_steps=10, lr_mul=2.0, max_grad_norm=1.0)

    def pred(path):
        return any(part.startswith("cls_") for part in path)

    jtx = jtrain.build_optimizer(jparams, jtrain.OptimConfig(**ocfg), pred)
    jstate = jtrain.create_train_state(jparams, jtx)
    jstep = jtrain.make_cls_train_step(jmodel, jtx, dropout=False)
    tx = train.build_optimizer(port, train.OptimConfig(**ocfg), pred)
    state = train.create_train_state(port, tx)
    step = train.make_cls_train_step(port, tx, dropout=False)
    for b in batches:
        jstate, wloss = jstep(jstate, tuple(jnp.asarray(a) for a in b),
                              jax.random.PRNGKey(0))
        state, loss = step(state, tuple(torch.from_numpy(a) for a in b))
        assert abs(float(loss) - float(wloss)) <= LOGIT_TOL * max(1.0, abs(float(wloss)))
    assert state.step == 3 and not port.training
    want = bconv.params_from_jax(jax.device_get(jstate.params), cfg, port.TASK)
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        moved += not torch.equal(want[k], initial[k])
    assert moved > 20


def test_cls_step_dropout_draws_from_the_generator():
    """In training mode the classifier's input dropout (and the encoder's)
    draw from the step's generator: the same seed gives the same loss, and
    no generator raises."""
    _, _, sound = _models("seq_classification",
                          (("classifier", "linear"), ("loss_type", "xe")))
    _, cfg = _configs(hidden_dropout_prob=0.1)
    port = heads.ImageBertForSequenceClassification(cfg)
    port.load_state_dict(sound.state_dict())
    batch = tuple(torch.from_numpy(a) for a in
                  _inputs(4) + (_labels("seq_classification", "xe")["labels"],))
    port.train()
    with torch.no_grad():
        losses = [float(port(*batch[:3], img_feats=batch[3], labels=batch[4],
                             generator=torch.Generator().manual_seed(s))[0])
                  for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="Generator"):
        port(*batch[:3], img_feats=batch[3], labels=batch[4])


# --- refcoco_ft ----------------------------------------------------------------

N_BOXES = (3, 5, 7, 4, 6, 2)
WORDS = ("dog", "cat", "man", "woman", "person", "car", "red")


def _refcoco_ft_fixture(root, layout):
    """6 queries (3-7 candidates, one past the 6 region slots), the gt box
    near one candidate; ``layout`` "plain" ({"objects": boxlist}, the
    caption in the ann) or "refcoco" (stage 1's colored layout)."""
    rng = np.random.RandomState(11)
    rows, anns = [], []
    for q, n in enumerate(N_BOXES):
        xy = rng.uniform(0, 200, (n, 2))
        wh = rng.uniform(20, 120, (n, 2))
        rects = np.round(np.concatenate([xy, xy + wh], 1)).tolist()
        boxes = [{"rect": r, "class": WORDS[(q + b) % len(WORDS)], "conf": 0.9,
                  "feature": encode_feature(rng.randn(DIM).astype(np.float32))}
                 for b, r in enumerate(rects)]
        g = rects[(2 * q + 1) % n]
        gt = [g[0] + 2, g[1] - 1, g[2] - g[0] - 2, g[3] - g[1] + 3]
        caption = f"the {WORDS[q % len(WORDS)]} on the left."
        if layout == "plain":
            payload = {"objects": boxes}
            anns.append({"id": f"k{q}", "bbox": gt, "caption": caption})
        else:
            payload = {"objects": [[boxes, boxes[::-1]], caption,
                                   [["red"], ["blue"]], [[rects[0]], [rects[1]]]]}
            anns.append({"id": f"k{q}", "bbox": gt})
        rows.append([f"k{q}", json.dumps(payload)])
    paths = {"data_file": os.path.join(root, "predictions.tsv"),
             "ann_file": os.path.join(root, "ann.json")}
    tsv_writer(rows, paths["data_file"])
    with open(paths["ann_file"], "w") as f:
        json.dump(anns, f)
    return paths


@functools.lru_cache(maxsize=None)
def _ft_paths(layout):
    return _refcoco_ft_fixture(tempfile.mkdtemp(prefix=f"rec_ft_{layout}_"),
                               layout)


@pytest.mark.parametrize("layout", ["plain", "refcoco"])
def test_refcoco_ft_data_matches_jax(layout):
    """Each query's sequence, features, box mask, best-IoU target and
    boxes, and a padded batch, against the JAX tool's data."""
    paths = _ft_paths(layout)
    got = refcoco_ft.RefcocoFTData(paths["data_file"], paths["ann_file"],
                                   tok.BertTokenizer(tok.toy_vocab()), 16, 6, DIM)
    want = jrefcoco_ft.RefcocoFTData(paths["data_file"], paths["ann_file"],
                                     jtok.BertTokenizer(jtok.toy_vocab()), 16, 6,
                                     DIM)
    assert len(got) == len(want) == len(N_BOXES)
    targets = []
    for i in range(len(got)):
        g, w = got.example(i), want.example(i)
        assert g[0] == w[0] and g[4] == w[4] and g[5] == w[5]
        for f in ("input_ids", "segment_ids", "attention_mask"):
            np.testing.assert_array_equal(getattr(g[1], f), getattr(w[1], f))
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        targets.append(g[4])
    assert targets == [(2 * q + 1) % n for q, n in enumerate(N_BOXES)]
    gb, wb = got.batch([4, 0, 2], pad_to=5), want.batch([4, 0, 2], pad_to=5)
    for a, b in zip(gb[:6], wb[:6]):
        np.testing.assert_array_equal(a, b)
    assert gb[6:] == wb[6:] and gb[5][3] == -1
    got.tsv.close()


def _rec_ft_args(layout):
    paths = _ft_paths(layout)
    return ["--data_file", paths["data_file"], "--ann_file", paths["ann_file"],
            "--hidden_size", "64", "--num_hidden_layers", "2",
            "--img_feature_dim", str(DIM), "--max_seq_length", "16",
            "--max_img_seq_length", "6", "--per_gpu_eval_batch_size", "4",
            "--dtype", "float32"]


@functools.lru_cache(maxsize=None)
def _oscar_checkpoint(tool, argv: tuple) -> str:
    """An Oscar-layout checkpoint at the config the JAX ``tool`` builds
    from ``argv``."""
    jcfg = tool.model_config(tool.build_args().parse_args(list(argv)))
    path = os.path.join(tempfile.mkdtemp(prefix="ft_ckpt_"), "oscar.bin")
    torch.save({k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jcfg, seed=6).items()}, path)
    return path


def _port_from(captured, task):
    """A replacement for a port tool's model builder: the real one, then
    the JAX tool's captured parameter tree loaded over it."""
    def load(model):
        tree = captured[-1]
        model.load_state_dict(bconv.params_from_jax(
            {"params": tree.get("params", tree)}, model.config, task))
        return model
    return load


@pytest.mark.parametrize("layout", ["plain", "refcoco"])
def test_refcoco_ft_tool_matches_jax(layout, tmp_path, monkeypatch):
    """The same ``--checkpoint`` into both tools, the port carrying the JAX
    tool's initialized tree: the same accuracy and predicted boxes, and
    the port's per-box scores against the JAX model's."""
    captured, built = [], []
    real_init = jrefcoco_ft.load_or_init

    def spy(*a, **kw):
        captured.append(real_init(*a, **kw))
        return captured[-1]

    monkeypatch.setattr(jrefcoco_ft, "load_or_init", spy)
    common = _rec_ft_args(layout) + ["--checkpoint", _oscar_checkpoint(
        jrefcoco_ft, tuple(_rec_ft_args(layout)))]
    want = jrefcoco_ft.main(common + ["--output", str(tmp_path / "jax.pk")])
    real_build, load = refcoco_ft.build_model, _port_from(captured, "rec_ft")

    def build(*a, **kw):
        built.append(load(real_build(*a, **kw)))
        return built[-1]

    monkeypatch.setattr(refcoco_ft, "build_model", build)
    got = refcoco_ft.main(common + ["--device", "cpu", "--output",
                                    str(tmp_path / "port.pk")])
    assert got == want
    with open(tmp_path / "jax.pk", "rb") as f, open(tmp_path / "port.pk", "rb") as g:
        w, p = pickle.load(f), pickle.load(g)
    assert p == w and len(p["predictions"]) == len(N_BOXES)
    # the scores behind them, against the JAX model on the same batch
    data = refcoco_ft.RefcocoFTData(*_ft_paths(layout).values(),
                                    tok.BertTokenizer(tok.toy_vocab()), 16, 6, DIM)
    _, preds, scores = refcoco_ft.evaluate(built[-1], data, 4)
    jcfg = jrefcoco_ft.model_config(jrefcoco_ft.build_args().parse_args(common))
    jmodel = jheads.REC_FT(jcfg, txt_seq_len=16, dtype=jnp.float32)
    b = data.batch(list(range(len(data))))
    _, wscores, _ = jmodel.apply(captured[-1], *b[:3], img_feats=b[3],
                                 box_mask=b[4])
    for j, key in enumerate(b[6]):
        n = min(len(b[7][j]), 6)
        np.testing.assert_allclose(scores[key][:n], np.asarray(wscores)[j, :n],
                                   rtol=0, atol=SCORE_TOL)
    assert preds == w["predictions"]
    data.tsv.close()


def test_refcoco_ft_tool_trains(monkeypatch):
    """Two epochs of batch 4 on the CPU (2 steps an epoch, the last
    padded): finite losses, the scorer and the encoder move, then eval."""
    losses, models = [], []
    real = refcoco_ft.train

    def spy(model, *a, **kw):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        losses.extend(real(model, *a, **kw))
        models.append((before, model.state_dict()))
        return losses

    monkeypatch.setattr(refcoco_ft, "train", spy)
    acc = refcoco_ft.main(_rec_ft_args("plain") + [
        "--device", "cpu", "--num_train_epochs", "2",
        "--per_gpu_train_batch_size", "4"])
    assert 0.0 <= acc <= 100.0
    assert len(losses) == 4 and np.isfinite(losses).all()
    before, after = models[0]
    for k in ("cls_out.kernel", "cls_dense.kernel",
              "bert.encoder.layer.0.attention.wqkv"):
        assert not torch.equal(before[k], after[k]), k


# --- the FT variants of the CPT tools -------------------------------------------

@functools.lru_cache(maxsize=None)
def _gqa_paths():
    return generate_gqa_fixture(tempfile.mkdtemp(prefix="ft_gqa_"),
                                n_questions=10, feat_dim=24)


def _gqa_args():
    p = _gqa_paths()
    return ["--img_feat_file", p["img_feat_file"], "--color_img_feat_file",
            p["color_img_feat_file"], "--questions", p["questions"],
            "--ans2label", p["ans2label"], "--hidden_size", "32",
            "--num_hidden_layers", "2", "--img_feature_dim", "24",
            "--max_seq_length", "16", "--max_img_seq_length", "5",
            "--per_gpu_eval_batch_size", "4", "--dtype", "float32",
            "--model_variant", "ft"]


def _spy_merge(monkeypatch):
    """Capture each tree the JAX tools build (flax init + the checkpoint)."""
    captured = []
    real = jconv.merge_pretrained_into_init

    def spy(*a, **kw):
        captured.append(real(*a, **kw))
        return captured[-1]

    monkeypatch.setattr(jconv, "merge_pretrained_into_init", spy)
    return captured


def test_gqa_ft_tool_matches_jax(tmp_path, monkeypatch):
    """``gqa_cpt --model_variant ft`` zero-shot on the same checkpoint, the
    port carrying the JAX tool's tree: the same accuracy, picks, and class
    logits within SCORE_TOL."""
    captured = _spy_merge(monkeypatch)
    common = _gqa_args() + ["--checkpoint", _oscar_checkpoint(
        jgqa_tool, tuple(_gqa_args())),
                            "--num_train_epochs", "0"]
    want = jgqa_tool.main(common + ["--output", str(tmp_path / "jax.pk")])
    real, load = gqa_cpt.load_ft_model, _port_from(captured, "seq_classification")
    monkeypatch.setattr(gqa_cpt, "load_ft_model",
                        lambda *a, **kw: load(real(*a, **kw)))
    got = gqa_cpt.main(common + ["--device", "cpu", "--output",
                                 str(tmp_path / "port.pk")])
    assert got == want
    with open(tmp_path / "jax.pk", "rb") as f, open(tmp_path / "port.pk", "rb") as g:
        w, p = pickle.load(f)["results"], pickle.load(g)["results"]
    assert sorted(p) == sorted(w) and len(p) == 10
    for q in w:
        assert p[q]["pred"] == w[q]["pred"] and p[q]["scores"].shape == (
            len(json.load(open(_gqa_paths()["ans2label"]))),)
        np.testing.assert_allclose(p[q]["scores"], w[q]["scores"], rtol=0,
                                   atol=SCORE_TOL)


def test_gqa_ft_trains_then_saves(tmp_path, monkeypatch):
    """``--model_variant ft --save_dir``: the classifier trains on answer
    labels (8 samples, batch 4, 2 epochs), ``save_model`` writes the
    parameters and ``config.json``, and a fresh model loaded with
    ``load_model`` gives the same logits bit for bit."""
    seen, losses = [], []
    real_eval, real_train = gqa_cpt.evaluate, gqa_cpt.train

    def eval_spy(model, *a, **kw):
        seen.append((model, real_eval(model, *a, **kw)))
        return seen[-1][1]

    def train_spy(*a, **kw):
        losses.extend(real_train(*a, **kw))
        return losses

    monkeypatch.setattr(gqa_cpt, "evaluate", eval_spy)
    monkeypatch.setattr(gqa_cpt, "train", train_spy)
    save = tmp_path / "saved"
    gqa_cpt.main(_gqa_args() + ["--device", "cpu", "--num_train_epochs", "2",
                                "--n_sample", "8", "--per_gpu_train_batch_size",
                                "4", "--save_dir", str(save)])
    assert len(losses) == 4 and np.isfinite(losses).all()
    model, (acc, results) = seen[-1]
    with open(save / "config.json") as f:
        assert json.load(f)["num_labels"] == model.config.num_labels
    assert ckpt_lib.last_checkpoint_name(str(save)) == "model"
    args = gqa_cpt.build_args().parse_args(_gqa_args() + ["--random_seed", "1"])
    fresh = gqa_cpt.load_ft_model(args, gqa_cpt.model_config(args), "cpu",
                                  torch.float32, model.config.num_labels)
    assert not torch.equal(fresh.cls_out.kernel, model.cls_out.kernel)
    fresh.load_state_dict(ckpt_lib.load_model(str(save), fresh.state_dict()))
    data = gqa_cpt.GQACPTData(
        _gqa_paths()["img_feat_file"], None,
        gqa_cpt.load_gqa_examples(_gqa_paths()["questions"]),
        json.load(open(_gqa_paths()["ans2label"])),
        tok.BertTokenizer(tok.toy_vocab()), 16, 5, 24, use_color=False)
    acc2, results2 = real_eval(fresh, data, 4, "ft")
    assert acc2 == acc and sorted(results2) == sorted(results)
    for q in results:
        np.testing.assert_array_equal(results2[q]["scores"], results[q]["scores"])
    data.img_feat_tsv.close()


@functools.lru_cache(maxsize=None)
def _vcr_paths():
    return generate_vcr_fixture(tempfile.mkdtemp(prefix="ft_vcr_"),
                                n_questions=8, feat_dim=24)


def _vcr_args(task):
    p = _vcr_paths()
    return ["--feat_file", p["feat_file"], "--examples", p["examples"],
            "--task", task, "--hidden_size", "32", "--num_hidden_layers", "2",
            "--img_feature_dim", "24", "--max_seq_length", "20",
            "--max_img_seq_length", "6", "--per_gpu_eval_batch_size", "3",
            "--dtype", "float32", "--model_variant", "ft"]


@pytest.mark.parametrize("task", ["qa", "qar"])
def test_vcr_ft_tool_matches_jax(task, tmp_path, monkeypatch):
    """``vcr_nsp_cpt --model_variant ft`` (NSPFT; VCR_QAR_NSPFT's twin
    classifiers for q→ar) on the same checkpoint, the port carrying the JAX
    tool's tree: the same accuracy, picks and scores within SCORE_TOL."""
    captured = _spy_merge(monkeypatch)
    common = _vcr_args(task) + ["--checkpoint", _oscar_checkpoint(
        jvcr_tool, tuple(_vcr_args("qa")))]
    want = jvcr_tool.main(common + ["--output", str(tmp_path / "jax.pkl")])
    real = vcr_nsp_cpt.load_model

    def load(*a, **kw):
        model = real(*a, **kw)
        return _port_from(captured, model.TASK)(model)

    monkeypatch.setattr(vcr_nsp_cpt, "load_model", load)
    got = vcr_nsp_cpt.main(common + ["--device", "cpu", "--output",
                                     str(tmp_path / "port.pkl")])
    assert got == want
    with open(tmp_path / "jax.pkl", "rb") as f, open(tmp_path / "port.pkl",
                                                      "rb") as g:
        w, p = pickle.load(f), pickle.load(g)
    groups = ([(p["results"][k], w["results"][k]) for k in ("qa", "qar")]
              if task == "qar" else [(p["results"], w["results"])])
    for pres, wres in groups:
        assert sorted(pres) == sorted(wres) and len(pres) == 8
        for q in wres:
            assert pres[q]["pred"] == wres[q]["pred"]
            np.testing.assert_allclose(pres[q]["scores"], wres[q]["scores"],
                                       rtol=0, atol=SCORE_TOL)


def test_vcr_ft_tool_trains(monkeypatch):
    """The twin classifiers train through ``make_nsp_train_step`` (the
    "ans" one on q→a batches); the rationale classifier stays at its
    fresh draw."""
    models = []
    real = vcr_nsp_cpt.train

    def spy(model, *a, **kw):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        out = real(model, *a, **kw)
        models.append((before, model.state_dict(), out))
        return out

    monkeypatch.setattr(vcr_nsp_cpt, "train", spy)
    vcr_nsp_cpt.main(_vcr_args("qar") + ["--device", "cpu", "--num_train_epochs",
                                         "1", "--per_gpu_train_batch_size", "4"])
    before, after, losses = models[0]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not torch.equal(before["classifier_ans.dense.kernel"],
                           after["classifier_ans.dense.kernel"])
    # AdamW's weight decay still moves the untouched head, as in optax
    assert torch.allclose(before["classifier_rat.dense.kernel"],
                          after["classifier_rat.dense.kernel"], rtol=1e-3)


def test_ft_tools_refuse_what_waits_for_later_items(monkeypatch, tmp_path):
    """The discrete-code image features refuse, naming Queue 1 item 6; a
    multi-process launch of ``refcoco_ft`` or ``sweep`` refuses, naming
    item 9, before it reads anything."""
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 6"):
        refcoco_ft.main(_rec_ft_args("plain") + ["--img_feature_type",
                                                 "dis_code"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 9"):
        refcoco_ft.main(_rec_ft_args("plain"))
    from cpt_tpu_torch.tools import sweep

    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 9"):
        sweep.main(["--results_dir", str(tmp_path / "r"), "--stage2", "--"])
    assert not (tmp_path / "r").exists()
