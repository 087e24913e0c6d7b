"""``tools/run_captioning``, the port's ``main`` against the JAX package's on
the CPU in f32 at a tiny size (2 layers, hidden 32, a caption canvas of
10, 6 region slots), on the reference-layout ``--dataset_yaml`` fixture of
``tests/test_captioning.py`` (a feature TSV of base64 features, a label
TSV, a COCO-style caption json): one Oscar-layout checkpoint into both,
the JAX runner's initialized tree carried into the port, dropout off in
both (the packages draw their masks from different generators). The
fresh MLM head's decoder and bias are drawn anew in that tree (std 1; the
ids past the toy vocabulary biased down), so that the decode's logits
spread: flax's 0.02-std tables leave near-ties between the two packages.
After a few XE steps: the same captions, beam confidences within
SCORE_TOL, the same metrics and ``eval_logs.json``. Then, on the port
alone: ``--resume`` bit-equal to an uninterrupted run (on one thread:
multi-threaded CPU BLAS is not bit-reproducible run to run), sampling with
``--num_return_sequences``, SCST through ``main`` and the multi-process
refusal."""
import base64
import dataclasses
import functools
import json
import os
import pickle
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cpt_tpu.tools import run_captioning as jrc
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils.tokenization import toy_vocab
from cpt_tpu_torch.tools import run_captioning as rc
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils.tsv import tsv_writer
from test_torch_distributed import multi_process_env
from test_torch_watchdog import guards

guard_module, guard_case = guards(600)

D = 24
SCORE_TOL = 1e-4
TINY = ["--hidden_size", "32", "--num_hidden_layers", "2", "--img_feature_dim",
        str(D), "--max_seq_length", "24", "--max_seq_a_length", "10",
        "--max_img_seq_length", "6", "--dtype", "float32", "--learning_rate",
        "3e-3", "--per_gpu_train_batch_size", "6"]
WORDS = ("dog", "cat", "man", "woman", "person", "left", "right")


def write_set(root: str, name: str, n: int, seed: int) -> str:
    """A caption dataset in the reference's CaptionTSVDataset layout: n
    images of 4 regions, each with two od labels and two captions. → the
    yaml's path."""
    rng = np.random.RandomState(seed)
    feat_rows, label_rows, caps = [], [], []
    for q in range(n):
        feats = (rng.randn(4, D) * 0.5).astype(np.float32)
        feat_rows.append([f"{name}{q}", json.dumps(
            {"num_boxes": 4,
             "features": base64.b64encode(feats.tobytes()).decode()})])
        labels = [WORDS[q % 7], WORDS[(q + 2) % 7]]
        label_rows.append([f"{name}{q}", json.dumps([{"class": c} for c in labels])])
        caps += [{"image_id": f"{name}{q}",
                  "caption": f"the {'red' if q % 2 else 'blue'} {labels[0]}"},
                 {"image_id": f"{name}{q}", "caption": f"a {labels[1]} on the left"}]
    tsv_writer(feat_rows, f"{root}/{name}_features.tsv")
    tsv_writer(label_rows, f"{root}/{name}_labels.tsv")
    with open(f"{root}/{name}_captions.json", "w") as f:
        json.dump(caps, f)
    with open(f"{root}/{name}.yaml", "w") as f:
        yaml.safe_dump({"feature": f"{name}_features.tsv",
                        "label": f"{name}_labels.tsv",
                        "caption": f"{name}_captions.json"}, f)
    return f"{root}/{name}.yaml"


@functools.lru_cache(maxsize=None)
def fixture() -> dict:
    """The training set (6 images), a held-out set (3 images) and an
    Oscar-layout checkpoint of the tiny encoder, in a fresh directory."""
    root = tempfile.mkdtemp(prefix="caption_fx_")
    args = jrc.build_args().parse_args(TINY)
    ckpt = os.path.join(root, "oscar.pth")
    torch.save({k: torch.from_numpy(v) for k, v in jconv.random_oscar_state_dict(
        jrc.model_config(args), seed=6).items()}, ckpt)
    return {"train": write_set(root, "im", 6, 0), "held": write_set(root, "held", 3, 1),
            "checkpoint": ckpt}


def no_dropout(model_config):
    def config(args, **kw):
        return dataclasses.replace(model_config(args, **kw),
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
    return config


def spread_head(tree: dict) -> dict:
    """The tree with its MLM head's decoder (untied) and bias drawn anew
    from seed 5: decoder N(0, 1), bias N(0, 0.25) over the toy vocabulary
    and −10 past it."""
    rng = np.random.RandomState(5)
    inner = dict(tree["params"])
    head = dict(inner["mlm_head"])
    vocab, hidden = head["bias"].shape[0], inner["bert"]["embeddings"][
        "word_embeddings"]["embedding"].shape[1]
    if "decoder" in head:
        head["decoder"] = jnp.asarray(rng.randn(vocab, hidden).astype(np.float32))
    bias = (rng.randn(vocab) * 0.5).astype(np.float32)
    bias[len(toy_vocab()):] = -10.0
    head["bias"] = jnp.asarray(bias)
    inner["mlm_head"] = head
    return {"params": inner}


def run_both(argv, tmp_path, monkeypatch) -> dict:
    """The JAX runner, then the port's carrying its initialized tree (head
    spread by ``spread_head``), with ``argv`` and the fixture's checkpoint;
    ``{pkg}`` in a flag becomes the package's name. → each one's (CIDEr,
    outputs) and pickle."""
    for mod in (jrc, rc):
        monkeypatch.setattr(mod, "model_config", no_dropout(mod.model_config))
    trees = []
    real_init = jrc.load_or_init
    monkeypatch.setattr(jrc, "load_or_init", lambda *a, **kw: trees.append(
        spread_head(real_init(*a, **kw))) or trees[-1])
    real_build = rc.build_model

    def build(args, cfg, device):
        model = real_build(args, cfg, device)
        model.load_state_dict(bconv.params_from_jax(trees[-1], cfg, model.TASK))
        return model

    monkeypatch.setattr(rc, "build_model", build)
    argv = argv + TINY + ["--checkpoint", fixture()["checkpoint"]]
    out = {}
    for pkg, entry, extra in (("jax", jrc, []), ("port", rc, ["--device", "cpu"])):
        flags = [f.replace("{pkg}", pkg) for f in argv]
        out[pkg] = entry.main(flags + extra + ["--output", str(tmp_path / f"{pkg}.pk")])
        with open(tmp_path / f"{pkg}.pk", "rb") as f:
            out[pkg + "_pickle"] = pickle.load(f)
    return out


def assert_same_outputs(got, want):
    """Equal captions; beam hypotheses' confidences within SCORE_TOL."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        else:
            assert [h["caption"] for h in g] == [h["caption"] for h in w], k
            for h, x in zip(g, w):
                assert abs(h["confidence"] - x["confidence"]) <= SCORE_TOL


CASES = {
    "greedy": ["--num_beams", "1", "--drop_worst_ratio", "0.3",
               "--drop_worst_after", "2", "--no_tie_weights"],
    "beam": ["--num_beams", "3", "--num_keep_best", "2", "--length_penalty",
             "0.6", "--repetition_penalty", "1.3", "--no_tie_weights",
             "--freeze_embedding"],
    "cbs": ["--use_cbs", "--num_beams", "2", "--num_constraints", "2",
            "--no_tie_weights"],
    "tied_max_gen_length": ["--num_beams", "1", "--max_gen_length", "7"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_main_matches_jax(case, tmp_path, monkeypatch):
    """4 XE steps (batch 6; drop-worst from step 2, ``--freeze_embedding``
    or a tied decoder in some cases), then the test decode: greedy, beam
    (2 hypotheses kept, their confidences), constrained beam search over
    each image's 2 od labels, or greedy on a canvas cut by
    ``--max_gen_length``: the same captions, CIDEr-D and metrics, and the
    same pickle."""
    argv = ["--dataset_yaml", fixture()["train"], "--train_steps", "4",
            "--spice_lite"] + CASES[case]
    out = run_both(argv, tmp_path, monkeypatch)
    (jcider, jout), (cider, pout) = out["jax"], out["port"]
    assert cider == pytest.approx(jcider, abs=1e-9) and np.isfinite(cider)
    assert_same_outputs(pout, jout)
    assert len(pout) == 6
    want, got = out["jax_pickle"], out["port_pickle"]
    assert sorted(got["metrics"]) == sorted(want["metrics"]) == sorted(
        ["CIDEr", "METEOR", "ROUGE_L", "SPICE_lite"]
        + [f"Bleu_{i}" for i in range(1, 5)])
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, abs=1e-9), k
    assert_same_outputs(got["captions"], want["captions"])
    texts = [v if isinstance(v, str) else v[0]["caption"] for v in pout.values()]
    assert any(t for t in texts)
    if case == "beam":
        assert all(len(v) == 2 for v in pout.values())
    if case == "cbs":
        # each caption holds at least one of its image's two od labels
        for k, text in pout.items():
            q = int(k[2:])
            assert {WORDS[q % 7], WORDS[(q + 2) % 7]} & set(text.split()), text


def test_val_test_yaml_and_eval_every_match_jax(tmp_path, monkeypatch):
    """``--val_yaml`` / ``--test_yaml`` with ``--eval_every 2
    --eval_subset 2`` over 4 steps: the same ``eval_logs.json`` (each eval's
    CIDEr and the best), the model ending on its best eval's parameters in
    both, the same captions of the 3 held-out images."""
    fx = fixture()
    argv = ["--dataset_yaml", fx["train"], "--val_yaml", fx["held"],
            "--test_yaml", fx["held"], "--train_steps", "4", "--eval_every", "2",
            "--eval_subset", "2", "--num_beams", "1", "--no_tie_weights",
            "--output_dir", str(tmp_path / "{pkg}")]
    out = run_both(argv, tmp_path, monkeypatch)
    assert_same_outputs(out["port"][1], out["jax"][1])
    assert sorted(out["port"][1]) == ["held0", "held1", "held2"]
    logs = {}
    for pkg in ("jax", "port"):
        with open(tmp_path / pkg / "eval_logs.json") as f:
            logs[pkg] = json.load(f)
    assert [e["step"] for e in logs["port"]] == [2, 4]
    for g, w in zip(logs["port"], logs["jax"]):
        assert g["step"] == w["step"]
        assert g["CIDEr"] == pytest.approx(w["CIDEr"], abs=1e-9)
        assert g["best_CIDEr"] == pytest.approx(w["best_CIDEr"], abs=1e-9)


@torch.no_grad()
def spread_port_head(model) -> None:
    """``spread_head``'s draws on the port's (untied) model."""
    rng = np.random.RandomState(5)
    head = model.mlm_head
    head.decoder.copy_(torch.from_numpy(rng.randn(*head.decoder.shape).astype(
        np.float32)))
    bias = (rng.randn(head.bias.shape[0]) * 0.5).astype(np.float32)
    bias[len(toy_vocab()):] = -10.0
    head.bias.copy_(torch.from_numpy(bias))


def port_run(argv, monkeypatch):
    """The port's ``main`` alone (dropout off, the head spread by
    ``spread_port_head``) → (CIDEr, outputs, the final model's state
    dict)."""
    monkeypatch.setattr(rc, "model_config", no_dropout(rc.model_config))
    built = []
    real_build = rc.build_model

    def build(*a):
        built.append(real_build(*a))
        spread_port_head(built[-1])
        return built[-1]

    monkeypatch.setattr(rc, "build_model", build)
    cider, outputs = rc.main(argv + TINY + ["--device", "cpu", "--checkpoint",
                                           fixture()["checkpoint"]])
    return cider, outputs, {k: v.clone() for k, v in built[-1].state_dict().items()}


def test_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """A run cut at step 2 (``--max_steps 2 --save_every 2``) and
    ``--resume``d to step 4 ends bit-equal to the uninterrupted run: the
    final parameters, the saved step-4 train state (moments included) and
    the captions."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        base = ["--dataset_yaml", fixture()["train"], "--train_steps", "4",
                "--save_every", "2", "--num_beams", "1", "--no_tie_weights"]
        a = port_run(base + ["--output_dir", str(tmp_path / "a")], monkeypatch)
        cut = port_run(base + ["--output_dir", str(tmp_path / "b"),
                               "--max_steps", "2"], monkeypatch)
        b = port_run(base + ["--output_dir", str(tmp_path / "b"), "--resume"],
                     monkeypatch)
    finally:
        torch.set_num_threads(old)
    assert a[1] == b[1] and a[0] == b[0]
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])
    assert not all(torch.equal(a[2][k], cut[2][k]) for k in a[2])
    sa = torch.load(tmp_path / "a" / "state" / "step4" / "state.pt",
                    weights_only=True)
    sb = torch.load(tmp_path / "b" / "state" / "step4" / "state.pt",
                    weights_only=True)
    flat_a, flat_b = [], []

    def flatten(x, out):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                flatten(x[k], out)
        elif isinstance(x, (list, tuple)):
            for v in x:
                flatten(v, out)

    flatten(sa, flat_a)
    flatten(sb, flat_b)
    assert len(flat_a) == len(flat_b) > 0
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))


def test_sampling_and_scst_through_main(tmp_path, monkeypatch):
    """``--do_sample --top_k 5 --num_return_sequences 2``: two draws an
    image with their log-prob confidences, the same on a second run (the
    generator seeded from ``--seed``); ``--scst_steps 2`` (3 rollouts, the
    leave-one-out baseline) after 2 XE steps moves the parameters and
    decodes finite captions."""
    fx = fixture()
    sample = ["--dataset_yaml", fx["train"], "--do_sample", "--top_k", "5",
              "--num_return_sequences", "2", "--no_tie_weights"]
    _, out1, _ = port_run(sample, monkeypatch)
    _, out2, _ = port_run(sample, monkeypatch)
    assert out1 == out2 and all(len(v) == 2 for v in out1.values())
    assert all(h["confidence"] < 0 for v in out1.values() for h in v)
    xe = ["--dataset_yaml", fx["train"], "--train_steps", "2", "--num_beams",
          "1", "--no_tie_weights"]
    _, _, before = port_run(xe, monkeypatch)
    cider, outputs, after = port_run(xe + ["--scst_steps", "2",
                                           "--sc_train_sample_n", "3",
                                           "--sc_baseline_type", "sample"],
                                     monkeypatch)
    assert np.isfinite(cider) and len(outputs) == 6
    assert not all(torch.equal(before[k], after[k]) for k in before)


def test_multi_process_launch_refused(monkeypatch):
    """A multi-process environment was refused naming ROADMAP item 9 until
    the process runtime was ported: the tool now calls
    ``initialize_from_env`` first and trains and decodes under one
    (``test_torch_distributed.multi_process_env``). The discrete-code
    features are refused as JAX refuses them."""
    calls = multi_process_env(monkeypatch)
    cider, outputs = rc.main(["--dataset_yaml", fixture()["train"],
                              "--train_steps", "2", "--num_beams", "1",
                              "--device", "cpu", "--checkpoint",
                              fixture()["checkpoint"]] + TINY)
    assert calls == [True] and np.isfinite(cider) and len(outputs) == 6
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="supported by run_vqa / run_gqa"):
        rc.main(["--dataset_yaml", "missing.yaml", "--device", "cpu",
                 "--img_feature_type", "dis_code"])


def test_phase14_dry_run():
    """``chip_smoke.run_captioning_phase`` on the CPU at a narrow width (2
    layers of 32): every reading is taken; what fails are the kernel-launch
    checks of its six decode kinds (no card) and the log-prob faults that
    so narrow a random encoder cannot see. One thread, so the resumed run
    is bit-equal to its twin."""
    import ast

    import chip_smoke as cs
    from cpt_tpu_torch.config.bert import OSCAR_BASE

    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(AssertionError) as e:
            cs.run_captioning_phase(cs.kernel_counters(), "cpu", [],
                                    torch.device("cpu"), torch.float32,
                                    dataclasses.replace(OSCAR_BASE, hidden_size=32,
                                                        num_hidden_layers=2,
                                                        img_feature_dim=D))
    finally:
        torch.set_num_threads(old)
    failures = ast.literal_eval(e.value.args[0][len("phase 14: "):])
    launch = [f for f in failures if "decodes" in f or "SCST steps" in f]
    assert len(launch) == 6, failures
    assert all(f.startswith("caption log-probs: a fault passes")
               for f in failures if f not in launch), failures
