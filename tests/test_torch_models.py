"""The tiny detector (``forward_batch_force``) and tiny ``REC_MLM_CPT``
(``mask_pos`` fast path) against the JAX package on the CPU, with weights
carried both ways: the native load of the reference-layout state dicts
(``random_vinvl_state_dict`` / ``random_oscar_state_dict``) and
``params_from_jax`` of the JAX parameter trees."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector.attr_rcnn import AttrRCNN as JaxRCNN
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.config import bert as bert_cfg
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.utils import convert as bconv
from test_torch_watchdog import guards

guard_module, guard_case = guards(120)

# f32 on the CPU through a whole tiny network: summation-order noise only
TOL = dict(atol=2e-4, rtol=2e-4)


def _same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def _chunked(config_module):
    """The tiny detector config with 4-slot head chunks, built from one
    package's own config module."""
    cfg = config_module.tiny_detector_config()
    return dataclasses.replace(cfg, roi_heads=dataclasses.replace(
        cfg.roi_heads, head_chunk=4))


@pytest.fixture(scope="module")
def detector_case():
    jcfg, cfg = _chunked(jdet_cfg), _chunked(det_cfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = random_vinvl_state_dict(jcfg, seed=3)
    jparams = {"params": convert_detector_state_dict(sd, jcfg)}
    rng = np.random.RandomState(0)
    images = (rng.rand(3, 64, 64, 3) * 255 - 120).astype(np.float32)
    boxes = np.asarray([[2, 3, 40, 50], [10, 10, 60, 30], [0, 0, 63, 63],
                        [30, 5, 45, 20], [5, 40, 25, 62], [1, 1, 3, 3],
                        [20, 20, 52, 61], [0, 0, 0, 0]], np.float32)
    valid = np.asarray([True] * 7 + [False])
    hw = np.asarray([60, 62], np.int32)
    model = JaxRCNN(jcfg, dtype=jnp.float32)
    out = jax.jit(lambda p, *a: model.apply(p, *a,
                                            method=model.forward_batch_force))(
        jparams, jnp.asarray(images), jnp.asarray(hw), jnp.asarray(boxes),
        jnp.asarray(valid))
    return cfg, sd, jparams, (images, hw, boxes, valid), jax.tree_util.tree_map(
        np.asarray, out)


def test_detector_weights_both_ways(detector_case):
    cfg, sd, jparams, _, _ = detector_case
    _same_state(dconv.state_from_reference(sd, cfg),
                dconv.params_from_jax(jparams, cfg))


def test_detector_forward_batch_force_matches(detector_case):
    cfg, sd, _, (images, hw, boxes, valid), want = detector_case
    model = AttrRCNN(cfg, torch.float32).eval()
    model.load_state_dict(dconv.state_from_reference(sd, cfg))
    with torch.inference_mode():
        got = model.forward_batch_force(torch.from_numpy(images), tuple(hw),
                                        torch.from_numpy(boxes),
                                        torch.from_numpy(valid))
    for k in ("box_features", "scores", "scores_all", "boxes"):
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])


@pytest.fixture(scope="module")
def bert_case():
    jcfg = jbert_cfg.tiny_bert_config(vocab_size=160, img_feature_dim=20)
    cfg = bert_cfg.tiny_bert_config(vocab_size=160, img_feature_dim=20)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = jconv.random_oscar_state_dict(jcfg, seed=5)
    jparams = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    rng = np.random.RandomState(1)
    n, t, r = 4, 14, 6
    ids = rng.randint(1, 160, (n, t)).astype(np.int32)
    seg = (rng.rand(n, t) > 0.5).astype(np.int32)
    mask = np.ones((n, t + r), np.int32)
    mask[1, 10:] = 0
    mask[2, t + 3:] = 0
    feats = rng.randn(n, r, 20).astype(np.float32)
    pos = np.asarray([3, 0, 7, 13], np.int32)
    model = JaxRec(jcfg, dtype=jnp.float32)
    _, logits = jax.jit(lambda p, *a: model.apply(p, *a[:3], img_feats=a[3],
                                                  mask_pos=a[4]))(
        jparams, *map(jnp.asarray, (ids, seg, mask, feats, pos)))
    return (jcfg, cfg), sd, jparams, (ids, seg, mask, feats, pos), np.asarray(logits)


def test_bert_weights_both_ways(bert_case):
    (_, cfg), sd, jparams, _, _ = bert_case
    _same_state(bconv.state_from_reference(sd, cfg),
                bconv.params_from_jax(jparams, cfg))


@pytest.mark.parametrize("impl", ["auto", "einsum"])
def test_rec_mlm_cpt_mask_pos_matches(bert_case, impl):
    """``auto`` routes every layer through the K3/K4 wrappers; ``einsum``
    takes the plain einsum/dense path."""
    (_, cfg), sd, _, inputs, want = bert_case
    cfg = dataclasses.replace(cfg, attention_impl=impl,
                              ffn_impl="dense" if impl == "einsum" else "auto")
    model = REC_MLM_CPT(cfg, torch.float32).eval()
    model.load_state_dict(bconv.state_from_reference(sd, cfg))
    ids, seg, mask, feats, pos = map(torch.from_numpy, inputs)
    with torch.inference_mode():
        _, got = model(ids, seg, mask, img_feats=feats, mask_pos=pos)
    assert got.shape == want.shape == (4, 160)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", ["mask_3d", "head_mask", "history"])
def test_bert_img_model_einsum_path_matches(bert_case, case):
    """The cases the K3 gate sends to the plain einsum path: a 3-D
    attention mask, a head mask, KV history. ``BertImgModel`` against the
    JAX module on the same weights."""
    from cpt_tpu.models.bert.model import BertImgModel as JaxBert
    from cpt_tpu_torch.models.bert.model import BertImgModel

    (jcfg, cfg), sd, jparams, (ids, seg, mask, feats, _), _ = bert_case
    rng = np.random.RandomState(9)
    n, s = mask.shape
    kw = {}
    if case == "mask_3d":
        mask = (rng.rand(n, s, s) > 0.3).astype(np.int32)
    elif case == "head_mask":
        kw["head_mask"] = rng.rand(cfg.num_hidden_layers, 1,
                                   cfg.num_attention_heads, 1, 1
                                   ).astype(np.float32)
    else:
        kw["history_states"] = [(rng.randn(n, 3, cfg.hidden_size) * 0.5
                                 ).astype(np.float32)
                                for _ in range(cfg.num_hidden_layers)]
        # keys are [history, sequence]: the mask covers both
        mask = np.concatenate([np.ones((n, 3), np.int32), mask], 1)
    jbert = JaxBert(jcfg, dtype=jnp.float32)
    want, _ = jbert.apply({"params": jparams["params"]["bert"]},
                          *map(jnp.asarray, (ids, seg, mask)),
                          img_feats=jnp.asarray(feats),
                          **{k: (jnp.asarray(v) if k == "head_mask" else
                                 tuple(map(jnp.asarray, v)))
                             for k, v in kw.items()})
    model = BertImgModel(cfg, torch.float32).eval()
    state = bconv.state_from_reference(sd, cfg)
    model.load_state_dict({k[len("bert."):]: v for k, v in state.items()
                           if k.startswith("bert.")})
    tkw = {k: (torch.from_numpy(v) if k == "head_mask" else
               [torch.from_numpy(h) for h in v]) for k, v in kw.items()}
    with torch.inference_mode():
        got, _ = model(torch.from_numpy(ids), torch.from_numpy(seg),
                       torch.from_numpy(mask), img_feats=torch.from_numpy(feats),
                       **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
