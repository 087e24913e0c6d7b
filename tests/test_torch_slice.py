"""The whole grounding slice, port vs JAX package, on one tiny fixture: the
JAX ``make_extract_fn`` (through its ``Extractor``) + ``refcoco_evaluate``
against the port's ``cpt_predict.predict``, from the same reference-layout
random weights. Also: the port imports and runs with jax blocked, and the
kernel build/dispatch rules."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.data.refcoco import RefcocoCPTData as JaxData
from cpt_tpu.engine import extract as jext
from cpt_tpu.engine import scoring as jscore
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.models.detector.attr_rcnn import AttrRCNN as JaxRCNN
from cpt_tpu.models.detector.config import \
    tiny_detector_config as jax_tiny_detector_config
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.tools.validate_checkpoints import det_json_for_stage2
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils.tokenization import BertTokenizer as JaxTokenizer
from cpt_tpu.utils.tokenization import toy_vocab as jax_toy_vocab
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.data.refcoco import tsv_region_features
from cpt_tpu_torch.kernels import build
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.config import tiny_detector_config
from cpt_tpu_torch.tools import cpt_predict
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils.tokenization import BertTokenizer, toy_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTION = "the woman on the left"
DETS = [[4, 4, 30, 30], [32, 8, 58, 40], [1, 20, 20, 55], [25, 30, 60, 52],
        [10, 2, 50, 14]]


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    # each package gets its own configs and tokenizer; the weights are one
    # reference-layout state dict
    det_cfg = tiny_detector_config()
    bert_cfg = tiny_bert_config(
        vocab_size=160, img_feature_dim=cpt_predict.region_feature_dim(det_cfg))
    jdet_cfg = jax_tiny_detector_config()
    jbert_cfg = jax_tiny_bert_config(vocab_size=160,
                                     img_feature_dim=bert_cfg.img_feature_dim)
    det_sd = random_vinvl_state_dict(jdet_cfg, seed=11)
    bert_sd = jconv.random_oscar_state_dict(jbert_cfg, seed=12)
    img = np.random.RandomState(13).randint(0, 256, (48, 60, 3)).astype(np.uint8)
    jtok = JaxTokenizer(jax_toy_vocab())

    # JAX package: stage 1 through its Extractor, stage 2 through its scoring
    wd = tmp_path_factory.mktemp("jax")
    det = JaxRCNN(jdet_cfg, dtype=jnp.float32)
    ex = jext.Extractor(det, {"params": convert_detector_state_dict(det_sd,
                                                                    jdet_cfg)},
                        jdet_cfg, copies_per_chunk=None)
    tsv = str(wd / "predictions.tsv")
    ex.run([jext.refcoco_task("q0", img, img.shape[:2], DETS, CAPTION)], tsv)
    json.dump([{"id": "q0", "caption": CAPTION}], open(wd / "ann.json", "w"))
    det_json_for_stage2(tsv, str(wd / "det.json"))
    data = JaxData(tsv, str(wd / "ann.json"), str(wd / "det.json"), jtok,
                   img_feat_dim=jbert_cfg.img_feature_dim)
    rec = JaxRec(jbert_cfg, dtype=jnp.float32)
    params = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(bert_sd, jbert_cfg), "rec_mlm_cpt")}
    _, preds = jscore.refcoco_evaluate(rec, params, data, jtok, batch_size=16)
    fn = jscore.make_mlm_at_mask_fn(rec)
    (batch, _), = jscore.iter_eval_batches(data, 16)
    scores = jscore.refcoco_collect_scores(
        jscore.run_mlm_batch(fn, params, batch), batch, jtok)[0][0]
    jax_out = {"feats": tsv_region_features(tsv), "box": preds["q0"], "scores": scores}

    # the port, from the same reference-layout weights
    res = cpt_predict.Resident(
        det_cfg, dconv.state_from_reference(det_sd, det_cfg), bert_cfg,
        bconv.state_from_reference(bert_sd, bert_cfg),
        BertTokenizer(toy_vocab()), torch.device("cpu"), torch.float32)
    pwd = tmp_path_factory.mktemp("port")
    box = cpt_predict.predict(res, img, CAPTION, DETS, workdir=str(pwd))
    return jax_out, res, pwd, box


def test_slice_features_match(slice_case):
    jax_out, _, pwd, _ = slice_case
    feats = tsv_region_features(str(pwd / "predictions.tsv"))
    assert feats.shape == jax_out["feats"].shape == (5, 5, 134)
    assert np.isfinite(feats).all()
    # f32 through the tiny detector: summation-order noise only
    np.testing.assert_allclose(feats, jax_out["feats"], atol=2e-4, rtol=2e-4)


def test_slice_picks_the_same_box(slice_case):
    jax_out, res, pwd, box = slice_case
    assert box == [float(v) for v in jax_out["box"]]
    assert box in [[float(v) for v in d] for d in DETS]
    scores = cpt_predict.candidate_scores(res, str(pwd))
    np.testing.assert_allclose(scores, jax_out["scores"], rtol=1e-4)


def test_port_runs_without_jax(tmp_path):
    """``import cpt_tpu_torch`` and the tiny slice through the CLI entry
    point, with ``--dets`` and with ``--detect``, in a fresh interpreter
    where importing jax, flax or the JAX package fails."""
    from PIL import Image

    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 56, 3)).astype(np.uint8)).save(tmp_path / "photo.png")
    script = f"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["cpt_tpu"] = None
import pkgutil, importlib, cpt_tpu_torch
for m in pkgutil.walk_packages(cpt_tpu_torch.__path__, "cpt_tpu_torch."):
    importlib.import_module(m.name)
from cpt_tpu_torch.tools.cpt_predict import main
pred = main(["--image", {str(tmp_path / 'photo.png')!r}, "--caption", "a dog",
             "--dets", "[[2, 2, 20, 30], [22, 4, 50, 36]]", "--tiny",
             "--device", "cpu", "--dtype", "float32", "--hidden_size", "32",
             "--num_hidden_layers", "2", "--out", {str(tmp_path / 'o.png')!r}])
assert pred in ([2, 2, 20, 30], [22, 4, 50, 36]), pred
pred = main(["--image", {str(tmp_path / 'photo.png')!r}, "--caption", "a dog",
             "--detect", "--conf", "0", "--tiny", "--device", "cpu",
             "--dtype", "float32", "--hidden_size", "32",
             "--num_hidden_layers", "2"])
assert len(pred) == 4 and all(0 <= v < 56 for v in pred), pred
assert not [k for k, v in sys.modules.items()
            if v is not None and k.split(".")[0] in ("jax", "flax", "cpt_tpu")]
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    assert (tmp_path / "o.png").exists()


def test_build_command_targets_hopper(monkeypatch, tmp_path):
    """The build compiles every csrc/*.cu for sm_90a into a shared library
    named by the sources' hash, and reports a failing compiler."""
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    names = {p.name for p in build.sources()}
    assert {"grouped_conv.cu", "roi_align.cu", "gemm.cu",
            "attention.cu", "nms.cu", "flash_attention.cu"} <= names
    assert build.library_path().name.startswith("libcpt_kernels-")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")
    with pytest.raises(build.KernelError, match="nvcc failed"):
        build.build()


def test_dispatch_rule():
    assert build.uses_kernel(torch.zeros(1)) is False
    with pytest.raises(build.KernelError):
        build.uses_kernel(torch.zeros(1, device="meta"))
