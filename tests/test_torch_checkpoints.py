"""Every checkpoint the JAX package loads loads into the port, with the same
parameters: a ``module.``-wrapped (DDP) VinVL ``.pth``, a legacy
Detectron/Caffe2 ``.pkl`` and a ``module.``-wrapped Oscar ``.bin``, through
the loaders (``load_vinvl_checkpoint``, ``load_caffe2_pickle``, Oscar's
aligning ``state_from_reference``) and through each tool's
``--checkpoint`` / ``--oscar_checkpoint``. The port's parameters must equal
what ``params_from_jax`` carries over from the JAX package's parameters
loaded from the same file (both packages are f32 here: bit for bit)."""
import argparse
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector import convert as jdconv
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.tools import cpt_predict, extract_features, refcoco_cpt
from cpt_tpu_torch.utils import convert as bconv
from test_torch_watchdog import guards

guard_module, guard_case = guards(120)


def _same(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_array_equal(got[k].detach().float().numpy(),
                                      want[k].float().numpy(), err_msg=k)


def _save(path, sd, prefix="module."):
    torch.save({"model": {prefix + k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}}, path)
    return str(path)


def _c2_blobs(sd, cfg):
    """A Detectron blob dict of ``sd`` (identity BN stats), as
    ``tests/test_c2_import.py`` builds it."""
    c2 = {}

    def put_bn(c2p, tp):
        c2[c2p + "_s"], c2[c2p + "_b"] = sd[tp + ".weight"], sd[tp + ".bias"]

    c2["conv1_w"] = sd["backbone.body.stem.conv1.weight"]
    put_bn("res_conv1_bn", "backbone.body.stem.bn1")

    def put_stage(res_idx, prefix, blocks):
        for b in range(blocks):
            tp, cp = f"{prefix}.{b}", f"res{res_idx}_{b}"
            for j, br in ((1, "branch2a"), (2, "branch2b"), (3, "branch2c")):
                c2[f"{cp}_{br}_w"] = sd[f"{tp}.conv{j}.weight"]
                put_bn(f"{cp}_{br}_bn", f"{tp}.bn{j}")
            if f"{tp}.downsample.0.weight" in sd:
                c2[f"{cp}_branch1_w"] = sd[f"{tp}.downsample.0.weight"]
                put_bn(f"{cp}_branch1_bn", f"{tp}.downsample.1")

    for si, blocks in enumerate(cfg.backbone.stage_blocks):
        put_stage(si + 2, f"backbone.body.layer{si + 1}", blocks)
    nl = len(cfg.backbone.stage_blocks) + 1
    put_stage(nl + 1, f"roi_heads.box.feature_extractor.head.layer{nl}",
              cfg.backbone.head_blocks)
    for name, tk in (("conv_rpn", "rpn.head.conv"),
                     ("rpn_cls_logits", "rpn.head.cls_logits"),
                     ("rpn_bbox_pred", "rpn.head.bbox_pred")):
        c2[name + "_w"], c2[name + "_b"] = sd[tk + ".weight"], sd[tk + ".bias"]
    for name in ("cls_score", "bbox_pred"):
        c2[name + "_w"] = sd[f"roi_heads.box.predictor.{name}.weight"]
        c2[name + "_b"] = sd[f"roi_heads.box.predictor.{name}.bias"]
    c2["cls_score_momentum"] = np.zeros(1, np.float32)   # dropped by both
    return c2


@pytest.fixture(scope="module")
def det_files(tmp_path_factory):
    """(port cfg, {kind: path}) for a wrapped .pth and a Detectron .pkl of
    the tiny detector's random weights."""
    root = tmp_path_factory.mktemp("det")
    jcfg, cfg = jdet_cfg.tiny_detector_config(), det_cfg.tiny_detector_config()
    sd = jdconv.random_vinvl_state_dict(jcfg, seed=4)
    stats = {k: (np.zeros_like(v) if k.endswith(".running_mean") else
                 np.ones_like(v) if k.endswith(".running_var") else v)
             for k, v in sd.items()}
    pkl = root / "model_final.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": _c2_blobs(stats, jcfg)}, f)
    return cfg, {"wrapped_pth": _save(root / "wrapped.pth", sd),
                 "pkl": str(pkl)}


def _jax_det_state(path, cfg):
    tree = jdconv.load_vinvl_checkpoint(path, jdet_cfg.tiny_detector_config())
    return dconv.params_from_jax({"params": tree}, cfg)


@pytest.mark.parametrize("kind", ["wrapped_pth", "pkl"])
def test_vinvl_checkpoint_loads_as_in_jax(det_files, kind):
    cfg, files = det_files
    want = _jax_det_state(files[kind], cfg)
    got = dconv.load_vinvl_checkpoint(files[kind], cfg)
    assert got.keys() == want.keys()
    assert any(k.startswith("attr_predictor.") for k in got)
    _same(got, want)
    if kind == "pkl":
        _same(dconv.load_caffe2_pickle(files[kind], cfg), want)
        # no running stats in a Detectron file: identity stats, scale = weight
        sd = dconv.random_vinvl_state_dict(cfg, seed=4)
        np.testing.assert_array_equal(got["backbone.stem.bn1.scale"].numpy(),
                                      sd["backbone.body.stem.bn1.weight"])
    else:
        with pytest.raises(KeyError):
            dconv.state_from_reference(dconv.load_torch_file(files[kind]), cfg)


@pytest.mark.parametrize("kind", ["wrapped_pth", "pkl"])
def test_extract_features_and_cpt_predict_take_the_checkpoint(det_files, kind):
    """``extract_features --checkpoint`` and ``cpt_predict --checkpoint``."""
    cfg, files = det_files
    want = _jax_det_state(files[kind], cfg)
    model = extract_features.build_detector(cfg, argparse.Namespace(
        dtype="float32", checkpoint=files[kind], seed=0, device="cpu"))
    _same(model.state_dict(), want)
    res = cpt_predict.build_resident("cpu", torch.float32, tiny=True,
                                     checkpoint=files[kind], hidden_size=32,
                                     num_hidden_layers=2)
    _same(res.detector.state_dict(), want)


@pytest.fixture(scope="module")
def oscar_file(tmp_path_factory):
    """A ``module.``-wrapped Oscar .bin of the tiny tools' config."""
    cfg = cpt_predict.bert_config(32, 2, cpt_predict.region_feature_dim(
        det_cfg.tiny_detector_config()))
    jcfg = jbert_cfg.BertConfig(**dataclasses.asdict(cfg))
    sd = jconv.random_oscar_state_dict(jcfg, seed=6)
    path = tmp_path_factory.mktemp("oscar") / "pytorch_model.bin"
    torch.save({"module." + k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jsd = jconv.load_torch_file(str(path))
    want = bconv.params_from_jax({"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(jsd, jcfg), "rec_mlm_cpt")}, cfg)
    return cfg, str(path), want


def test_wrapped_oscar_checkpoint_loads_as_in_jax(oscar_file, monkeypatch):
    """``state_from_reference`` aligns a wrapped Oscar state dict; it loads
    through ``cpt_predict --oscar_checkpoint`` and ``refcoco_cpt
    --checkpoint``."""
    cfg, path, want = oscar_file
    _same(bconv.state_from_reference(dconv.load_torch_file(path), cfg), want)
    res = cpt_predict.build_resident("cpu", torch.float32, tiny=True,
                                     oscar_checkpoint=path, hidden_size=32,
                                     num_hidden_layers=2)
    _same(res.oscar.state_dict(), want)
    args = refcoco_cpt.build_args().parse_args(
        ["--data_file", "d", "--ann_file", "a", "--det_file", "t",
         "--checkpoint", path, "--hidden_size", "32", "--num_hidden_layers",
         "2", "--img_feature_dim", str(cfg.img_feature_dim)])
    assert refcoco_cpt.model_config(args) == cfg
    model = refcoco_cpt.load_model(cfg, args, "cpu", torch.float32)
    _same(model.state_dict(), want)
