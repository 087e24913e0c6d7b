"""The Oscar classification runners (``run_vqa``, ``run_gqa``,
``run_nlvr``, ``run_retrieval``), the port's ``main`` against the JAX
package's on the CPU in f32 at a tiny size (2 layers, hidden 64), on the
fixtures of ``test_torch_oscar_data.py``: one Oscar-layout ``.pth``
checkpoint into both, the JAX runner's initialized tree (its fresh head
drawn by flax) carried into the port through ``params_from_jax``, dropout
off in both (the two packages draw their masks from different
generators). After 2-4 optimizer steps: the same score, accuracy or R@K,
the same pickled results and submission rows, eval logits (retrieval:
match scores) within LOGIT_TOL of their scale, trained parameters within
PARAM_ATOL."""
import dataclasses
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

from cpt_tpu.data import nlvr as jnlvr
from cpt_tpu.data import vqa as jvqa
from cpt_tpu.models.bert import heads as jheads
from cpt_tpu.tools import _common as jcommon
from cpt_tpu.tools import run_gqa as jrun_gqa
from cpt_tpu.tools import run_nlvr as jrun_nlvr
from cpt_tpu.tools import run_retrieval as jrun_retrieval
from cpt_tpu.tools import run_vqa as jrun_vqa
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.data import nlvr, vqa
from cpt_tpu_torch.tools import run_gqa, run_nlvr, run_retrieval, run_vqa
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from test_torch_oscar_data import D, fixture_paths
from test_torch_watchdog import guards

guard_module, guard_case = guards(600)

# eval logits of a tiny BERT in f32 after a few steps, as a fraction of the
# largest |logit|; retrieval's match scores (in [0, 1]) absolutely
LOGIT_TOL = 1e-4
# parameters after 2-4 AdamW / Adamax steps from the same tree
PARAM_ATOL = 1e-4

TINY = ["--hidden_size", "64", "--num_hidden_layers", "2", "--img_feature_dim",
        str(D), "--dtype", "float32", "--learning_rate", "1e-3"]

# runner → (JAX module, port module, the module whose main, model_config,
# load_or_init / build_model and evaluate it runs: run_gqa is run_vqa's)
RUNNERS = {"vqa": (jrun_vqa, run_vqa, jrun_vqa, run_vqa),
           "gqa": (jrun_gqa, run_gqa, jrun_vqa, run_vqa),
           "nlvr": (jrun_nlvr, run_nlvr, jrun_nlvr, run_nlvr),
           "retrieval": (jrun_retrieval, run_retrieval, jrun_retrieval,
                         run_retrieval)}


def no_dropout(model_config):
    def config(args, **kw):
        return dataclasses.replace(model_config(args, **kw),
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
    return config


@functools.lru_cache(maxsize=None)
def oscar_checkpoint() -> str:
    """An Oscar-layout checkpoint at the tiny encoder's size."""
    args = jrun_vqa.build_args().parse_args(TINY)
    path = os.path.join(tempfile.mkdtemp(prefix="oscar_ckpt_"), "oscar.pth")
    torch.save({k: torch.from_numpy(v) for k, v in jconv.random_oscar_state_dict(
        jcommon.model_config(args), seed=6).items()}, path)
    return path


class JitSpy:
    """Stands for ``jax`` in a JAX runner: ``jit`` as jax's, recording the
    parameters each call of the runner's jitted forward (``fwd``, or
    run_vqa's ``raw``) gets."""

    def __init__(self):
        self.params = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)
        if fn.__name__ not in ("fwd", "raw"):
            return jitted

        def call(params, *a):
            self.params.append(params)
            return jitted(params, *a)
        return call


def run_both(name, argv, tmp_path, monkeypatch) -> dict:
    """Run the JAX runner, then the port's carrying its initialized tree,
    with ``argv`` and one checkpoint; each writes ``--output`` and, given
    ``--output_dir``, its own directory. → both results, pickles, the JAX
    final parameters and the port's model."""
    jentry, pentry, jmod, pmod = RUNNERS[name]
    monkeypatch.setattr(jmod, "model_config", no_dropout(jmod.model_config))
    monkeypatch.setattr(pmod, "model_config", no_dropout(pmod.model_config))
    trees, built = [], []
    real_init = jmod.load_or_init
    monkeypatch.setattr(jmod, "load_or_init", lambda *a, **kw: trees.append(
        real_init(*a, **kw)) or trees[-1])
    spy = JitSpy()
    monkeypatch.setattr(jmod, "jax", spy)
    real_build = pmod.build_model

    def build(*a):
        model = real_build(*a)
        model.load_state_dict(bconv.params_from_jax(trees[-1], model.config,
                                                    model.TASK))
        built.append(model)
        return model

    monkeypatch.setattr(pmod, "build_model", build)
    argv = argv + TINY + ["--checkpoint", oscar_checkpoint()]
    out = {}
    for pkg, entry, extra in (("jax", jentry, []),
                              ("port", pentry, ["--device", "cpu"])):
        flags = [f.replace("{pkg}", pkg) for f in argv]
        out[pkg] = entry.main(flags + extra + ["--output",
                                               str(tmp_path / f"{pkg}.pk")])
        with open(tmp_path / f"{pkg}.pk", "rb") as f:
            out[pkg + "_pickle"] = pickle.load(f)
    out["jax_params"], out["model"] = spy.params[-1], built[-1]
    return out


def assert_params_close(model, jax_params):
    want = bconv.params_from_jax(jax_params, model.config, model.TASK)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    gaps = {k: float((got[k] - torch.as_tensor(want[k])).abs().max()) for k in want}
    assert max(gaps.values()) <= PARAM_ATOL, sorted(gaps.items(),
                                                    key=lambda kv: -kv[1])[:3]


def assert_logits_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale


def jax_logits(jmodel, params, batches):
    return np.concatenate([np.asarray(jmodel.apply(
        params, *b[:3], img_feats=b[3])[1], np.float32) for b in batches])


def tokenizers():
    return (jtok.BertTokenizer(jtok.toy_vocab()),
            tok.BertTokenizer(tok.toy_vocab()))


def vqa_argv(loss_type):
    p = fixture_paths()
    return ["--feat_file", p["feat_file"], "--examples", p["vqa"],
            "--num_labels", "5", "--max_seq_length", "16",
            "--max_img_seq_length", "6", "--per_gpu_train_batch_size", "4",
            "--per_gpu_eval_batch_size", "4", "--test_examples", p["vqa_test"],
            "--label2ans", p["label2ans"], "--output_dir", "{out}/{pkg}"
            ] + (["--loss_type", loss_type] if loss_type else [])


@pytest.mark.parametrize("case", ["vqa_bce", "vqa_kl_adjust_loss", "gqa_xe"])
def test_vqa_gqa_match_jax(case, tmp_path, monkeypatch):
    """VQA with bce over 5 soft labels (2 epochs of 2 steps, eval each epoch,
    the best epoch kept, ``checkpoint-{epoch}`` saved), VQA with kl then bce
    (``--adjust_loss --adjust_loss_epoch 1``) and GQA with xe: the same VQA
    score, predictions and submission rows (``vqa`` and ``gqa`` formats),
    the eval logits and the trained parameters."""
    name = case.split("_")[0]
    argv = [f.replace("{out}", str(tmp_path)) for f in vqa_argv(
        {"vqa_bce": "bce", "vqa_kl_adjust_loss": "kl", "gqa_xe": None}[case])]
    argv += ["--num_train_epochs", "2"]
    if case == "vqa_bce":
        argv += ["--eval_every", "1"]
    elif case == "vqa_kl_adjust_loss":
        argv += ["--adjust_loss", "--adjust_loss_epoch", "1"]
    out = run_both(name, argv, tmp_path, monkeypatch)
    assert out["port"] == out["jax"] and np.isfinite(out["port"])
    assert out["port_pickle"] == out["jax_pickle"]
    assert len(out["port_pickle"]["results"]) == 10
    assert_params_close(out["model"], out["jax_params"])
    # the eval logits on the val (= train) questions
    p = fixture_paths()
    jt, pt = tokenizers()
    jdata = jvqa.VQAData(p["feat_file"], jvqa.load_vqa_examples(p["vqa"]), 5,
                         jt, 16, 6, D)
    data = vqa.VQAData(p["feat_file"], vqa.load_vqa_examples(p["vqa"]), 5,
                       pt, 16, 6, D)
    jcfg = jrun_vqa.model_config(jrun_vqa.build_args().parse_args(TINY),
                                 num_labels=5)
    jmodel = jheads.ImageBertForSequenceClassification(jcfg, dtype=jnp.float32)
    batches = []
    for idx in ([0, 1, 2, 3], [4, 5, 6, 7], [8, 9]):
        b = jdata.batch(idx)[0]
        batches.append((b.input_ids, b.segment_ids, b.attention_mask,
                        b.img_feats))
    score, results, logits = run_vqa.evaluate(out["model"], data, 4)
    assert score == out["port"] and results == out["port_pickle"]["results"]
    assert_logits_close(logits, jax_logits(jmodel, out["jax_params"], batches))
    test_name = "submission" if name == "gqa" else "test2015"
    rows = {}
    for pkg in ("jax", "port"):
        with open(tmp_path / pkg / f"{test_name}_results.json") as f:
            rows[pkg] = json.load(f)
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 6
    assert set(rows["port"][0]) == ({"questionId", "prediction"} if name == "gqa"
                                    else {"question_id", "answer"})
    if case == "vqa_bce":
        assert sorted(os.listdir(tmp_path / "port")) == sorted(
            os.listdir(tmp_path / "jax")) == [
            "checkpoint-1", "checkpoint-2", "test2015_results.json"]


@pytest.mark.parametrize("case", ["pair", "pair_adamax", "concat"])
def test_nlvr_matches_jax(case, tmp_path, monkeypatch):
    """NLVR2 in pair mode (the multiple-choice head over both choices, with
    AdamW and with Adamax) and in concat mode (both images' regions in one
    sequence): 2 epochs of 2 steps (batch 4), then the same accuracy and
    predictions, the eval logits and the trained parameters."""
    p = fixture_paths()
    mode = case.split("_")[0]
    argv = ["--feat_file", p["feat_file"], "--examples", p["nlvr"],
            "--max_seq_length", "12", "--max_img_seq_length", "6",
            "--pair_mode", mode, "--num_train_epochs", "2",
            "--per_gpu_train_batch_size", "4", "--per_gpu_eval_batch_size", "8"]
    if case == "pair_adamax":
        argv += ["--optim", "adamax"]
    out = run_both("nlvr", argv, tmp_path, monkeypatch)
    assert out["port"] == out["jax"]
    assert out["port_pickle"] == out["jax_pickle"]
    assert len(out["port_pickle"]["results"]) == 8
    assert_params_close(out["model"], out["jax_params"])
    jt, pt = tokenizers()
    jdata = jnlvr.NLVRData(p["feat_file"], jnlvr.load_nlvr_examples(p["nlvr"]),
                           jt, 12, 6, D, mode=mode)
    data = nlvr.NLVRData(p["feat_file"], nlvr.load_nlvr_examples(p["nlvr"]),
                         pt, 12, 6, D, mode=mode)
    jcfg = jrun_nlvr.model_config(jrun_nlvr.build_args().parse_args(TINY),
                                  num_labels=2, classifier="mlp")
    jmodel = (jheads.ImageBertForMultipleChoice(jcfg, num_choices=2,
                                                dtype=jnp.float32)
              if mode == "pair" else
              jheads.ImageBertForSequenceClassification(jcfg, dtype=jnp.float32))
    acc, results, logits = run_nlvr.evaluate(out["model"], data, 8)
    assert acc == out["port"] and results == out["port_pickle"]["results"]
    assert_logits_close(logits, jax_logits(jmodel, out["jax_params"],
                                           [jdata.batch(list(range(8)))]))


@pytest.mark.parametrize("case", ["clr_val_cap", "cl", "rerank"])
def test_retrieval_matches_jax(case, tmp_path, monkeypatch):
    """Retrieval trained 3 steps of 8 balanced pairs, then: every caption ×
    image pair ranked (CLR, the eval pool capped at one caption an image
    from the full pool), the same under the 3-D CL mask, and the
    hard-negative re-rank over 4 eval images (``--eval_img_keys_file``,
    negatives for training from the candidates, 2 candidates an image):
    the same R@K, the match scores within LOGIT_TOL, the trained
    parameters."""
    p = fixture_paths()
    argv = ["--feat_file", p["feat_file"], "--captions", p["captions"],
            "--max_seq_length", "14", "--max_img_seq_length", "6",
            "--train_steps", "3", "--per_gpu_train_batch_size", "8",
            "--per_gpu_eval_batch_size", "16"]
    if case == "clr_val_cap":
        argv += ["--num_captions_per_img", "2", "--num_captions_per_img_val", "1"]
    elif case == "cl":
        argv += ["--att_mask_type", "CL"]
    else:
        argv += ["--eval_caption_index_file", p["cand_keys"], "--eval_img_keys_file",
                 p["eval_keys"], "--hard_negative_training",
                 "--num_captions_per_img_val", "2"]
    out = run_both("retrieval", argv, tmp_path, monkeypatch)
    assert out["port"] == out["jax"]
    keys = {"rerank": {f"i2t_R@{k}" for k in (1, 5, 10)}}.get(
        case, {f"{d}_R@{k}" for d in ("t2i", "i2t") for k in (1, 5, 10)})
    assert set(out["port"]) == keys
    got, want = out["port_pickle"]["scores"], out["jax_pickle"]["scores"]
    assert got.shape == want.shape == {"clr_val_cap": (6, 6), "cl": (12, 6),
                                       "rerank": (8,)}[case]
    assert got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= LOGIT_TOL
    assert_params_close(out["model"], out["jax_params"])


def test_phase13_dry_run():
    """``chip_smoke.run_oscar_runners`` on the CPU at a narrow width (2
    layers of 32): every reading is taken; what fails are the kernel-launch
    checks (no card) and the faults that so narrow a random encoder cannot
    see (swapped choices, the 2-D mask). One thread, so the resumed run is
    bit-equal to its twin."""
    import ast

    import chip_smoke as cs
    from cpt_tpu_torch.config.bert import OSCAR_BASE

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(AssertionError) as e:
            cs.run_oscar_runners(cs.kernel_counters(), "cpu", [],
                                 torch.device("cpu"), torch.float32,
                                 dataclasses.replace(OSCAR_BASE, hidden_size=32,
                                                     num_hidden_layers=2,
                                                     img_feature_dim=D))
    finally:
        torch.set_num_threads(old)
    failures = ast.literal_eval(e.value.args[0][len("phase 13: "):])
    launch = [f for f in failures if "launches" in f]
    assert len(launch) == 7, failures
    assert {f.split(":")[0] for f in failures if f not in launch} <= {
        "nlvr_pair", "retrieval_cl"}, failures
