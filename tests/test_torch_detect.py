"""The RPN detect slice, port vs JAX package, on the CPU in f32 at tiny
sizes, from inputs drawn with numpy seeds: NMS (against JAX ``nms_padded``
and the Pallas ``nms_pallas`` in interpret mode), box decoding and
anchors, proposal selection, the three RPN-mode post-processors,
``AttrRCNN`` in RPN mode, and the whole ``--detect`` slice (detect →
``--conf`` filter → grounding) against the JAX ``make_detect_fn`` +
``Extractor`` + ``refcoco_evaluate``."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.data.refcoco import RefcocoCPTData as JaxData
from cpt_tpu.engine import extract as jext
from cpt_tpu.engine import scoring as jscore
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.models.detector import heads as jheads
from cpt_tpu.models.detector import rpn as jrpn
from cpt_tpu.models.detector.attr_rcnn import AttrRCNN as JaxRCNN
from cpt_tpu.models.detector.config import \
    tiny_detector_config as jax_tiny_detector_config
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.ops.nms import nms_padded as jax_nms
from cpt_tpu.ops.nms_pallas import nms_pallas as jax_nms_pallas
from cpt_tpu.structures.boxes import decode_boxes as jax_decode
from cpt_tpu.tools.validate_checkpoints import det_json_for_stage2
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils.tokenization import BertTokenizer as JaxTokenizer
from cpt_tpu.utils.tokenization import toy_vocab as jax_toy_vocab
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.data.refcoco import tsv_region_features
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector import heads
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.models.detector.config import tiny_detector_config
from cpt_tpu_torch.models.detector.rpn import (cell_anchors, grid_anchors,
                                               select_proposals)
from cpt_tpu_torch.ops.nms import nms_indices_list, nms_padded
from cpt_tpu_torch.ops.nms_pallas import nms_pallas
from cpt_tpu_torch.structures.boxes import decode_boxes
from cpt_tpu_torch.tools import cpt_predict
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils.tokenization import BertTokenizer, toy_vocab

# f32 through the same formulas in another framework: summation-order and
# exp/log rounding noise only (box coordinates are O(100) pixels)
TOL = dict(atol=2e-4, rtol=2e-4)
# decode_boxes: a handful of f32 operations per value, with cancellation
# between the centre and half the width, so 1e-6 of the largest coordinate
# (a few ulps of it); the anchors are exact
BOX_REL = 1e-6


def nms_case(seed, k=150, thr=0.5):
    """Boxes with 5 score levels (ties everywhere), a fifth invalid, and
    planted pairs at IoU exactly ``thr`` under either convention."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 60, (k, 2)).astype(np.float32)
    wh = rng.randint(1, 30, (k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = (rng.randint(0, 5, k) / 4).astype(np.float32)
    valid = rng.rand(k) > 0.2
    boxes[:2] = [[200, 200, 210, 210], [200, 200, 210, 200 + 10 * thr]]
    scores[:2], valid[:2] = 1.0, True
    return boxes, scores, valid


def _port_nms(boxes, scores, valid, thr, max_out, off=0.0):
    idx, keep = nms_pallas(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.from_numpy(valid), thr, max_out, off)
    return idx.numpy(), keep.numpy()


def _assert_same_nms(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("seed,thr,offset", [(0, 0.5, 0.0), (1, 0.7, 0.0),
                                             (2, 0.3, 1.0), (3, 0.5, 1.0)])
def test_nms_matches_jax_nms_padded(seed, thr, offset):
    """Exact indices and keep, slot for slot (unused slots hold 0)."""
    boxes, scores, valid = nms_case(seed, thr=thr)
    want = jax_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                   thr, 60, offset)
    _assert_same_nms(_port_nms(boxes, scores, valid, thr, 60, offset), want)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_nms_matches_jax_nms_pallas_interpret(offset):
    """K5's TPU kernel, run in interpret mode on the CPU as the JAX
    package's own test runs it: exact indices where kept, and keep."""
    boxes, scores, valid = nms_case(4, k=100)
    want_idx, want_keep = jax_nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.5, 40,
        offset, interpret=True)
    idx, keep = _port_nms(boxes, scores, valid, 0.5, 40, offset)
    np.testing.assert_array_equal(keep, np.asarray(want_keep))
    np.testing.assert_array_equal(idx[keep], np.asarray(want_idx)[keep])


def test_nms_exact_threshold_pair_is_kept():
    """IoU exactly equal to the threshold does not suppress (strict >)."""
    boxes = np.asarray([[0, 0, 10, 10], [0, 0, 10, 5]], np.float32)
    idx, keep = _port_nms(boxes, np.ones(2, np.float32), np.ones(2, bool),
                          0.5, 2)
    assert keep.all() and idx.tolist() == [0, 1]
    idx, keep = _port_nms(boxes, np.ones(2, np.float32), np.ones(2, bool),
                          0.49, 2)
    assert keep.tolist() == [True, False] and idx.tolist() == [0, 0]


def test_nms_ties_go_to_the_lowest_index():
    boxes = np.tile(np.asarray([[0, 0, 10, 10]], np.float32), (4, 1))
    boxes += np.arange(4, dtype=np.float32)[:, None] * 50   # disjoint
    scores = np.asarray([0.5, 0.9, 0.9, 0.9], np.float32)
    idx, keep = _port_nms(boxes, scores, np.ones(4, bool), 0.5, 4)
    assert idx.tolist() == [1, 2, 3, 0] and keep.all()
    assert torch.argmax(torch.tensor([0.5, 0.9, 0.9])).item() == 1


def test_nms_batched_matches_a_loop():
    cases = [nms_case(s, k=80) for s in range(5)]
    boxes, scores, valid = (np.stack(a) for a in zip(*cases))
    idx, keep = _port_nms(boxes, scores, valid, 0.5, 30)
    assert idx.shape == keep.shape == (5, 30) and idx.dtype == np.int32
    for i, (b, s, v) in enumerate(cases):
        one = nms_padded(torch.from_numpy(b), torch.from_numpy(s),
                         torch.from_numpy(v), 0.5, 30)
        np.testing.assert_array_equal(idx[i], one[0].numpy())
        np.testing.assert_array_equal(keep[i], one[1].numpy())


def test_nms_indices_list_and_cpu_dispatch():
    boxes, scores, _ = nms_case(5)
    from cpt_tpu.ops.nms import nms_indices_list as jax_list

    assert nms_indices_list(boxes, scores, 0.5, 50) == jax_list(
        boxes, scores, 0.5, 50)
    before = nms_pallas.launches
    _port_nms(boxes, scores, np.ones(len(scores), bool), 0.5, 10)
    assert nms_pallas.launches == before   # the CPU runs the plain version


def test_anchors_and_decode_match_jax():
    cfg, jcfg = tiny_detector_config().rpn, jax_tiny_detector_config().rpn
    np.testing.assert_array_equal(
        cell_anchors(16, (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)),
        jrpn.cell_anchors(16, (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)))
    np.testing.assert_array_equal(grid_anchors(cfg, 5, 7),
                                  jrpn.grid_anchors(jcfg, 5, 7))
    rng = np.random.RandomState(6)
    anchors = grid_anchors(cfg, 3, 4)
    deltas = (rng.randn(len(anchors), 12) * 2).astype(np.float32)
    deltas[0, 2] = 9.0                        # past bbox_xform_clip
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        got = decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors), w)
        want = jax_decode(jnp.asarray(deltas), jnp.asarray(anchors), w)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=BOX_REL * np.abs(want).max())


def test_select_proposals_matches_jax():
    cfg, jcfg = tiny_detector_config().rpn, jax_tiny_detector_config().rpn
    rng = np.random.RandomState(7)
    h, w, a = 4, 5, cfg.num_anchors
    logits = (rng.randn(h, w, a) * 2).astype(np.float32)
    logits.reshape(-1)[rng.choice(h * w * a, 20, replace=False)] = 40.0
    deltas = (rng.randn(h, w, 4 * a) * 0.3).astype(np.float32)
    anchors = grid_anchors(cfg, h, w)
    hw = (60, 75)
    want = jrpn.select_proposals(jcfg, jnp.asarray(logits), jnp.asarray(deltas),
                                 jnp.asarray(anchors), jnp.asarray(hw))
    got = select_proposals(cfg, torch.from_numpy(logits),
                           torch.from_numpy(deltas), torch.from_numpy(anchors),
                           hw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)


@pytest.fixture(scope="module")
def head_inputs():
    """Logits, deltas, features and proposals of 24 RoIs over 7 classes,
    with one invalid proposal; logits spread so several classes clear the
    0.2 score threshold."""
    cfg = tiny_detector_config()
    rng = np.random.RandomState(8)
    n, c = 24, cfg.roi_heads.num_classes
    xy = rng.uniform(0, 40, (n, 2))
    proposals = np.concatenate([xy, xy + rng.uniform(4, 24, (n, 2))],
                               1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[5] = False
    return (jax_tiny_detector_config(), cfg), (np.float32(rng.randn(n, c) * 2.5),
                 np.float32(rng.randn(n, 4 * c) * 0.5),
                 np.float32(rng.randn(n, 16)), proposals, valid)


@pytest.mark.parametrize("name", ["postprocess_fast", "postprocess_per_class",
                                  "postprocess_per_class_with_retry",
                                  "postprocess_peter"])
def test_postprocess_matches_jax(head_inputs, name):
    (jcfg, cfg), inputs = head_inputs
    hw = (56, 61)
    want = getattr(jheads, name)(jcfg, *map(jnp.asarray, inputs),
                                 jnp.asarray(hw))
    got = getattr(heads, name)(cfg, *map(torch.from_numpy, inputs), hw)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert got["valid"].sum() >= 2
    for k in ("boxes", "scores", "box_features", "scores_all"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.fixture(scope="module")
def rpn_case():
    jcfg, cfg = jax_tiny_detector_config(), tiny_detector_config()
    sd = random_vinvl_state_dict(jcfg, seed=3)
    # spread the class scores, so that some clear the per-class filter's
    # 0.2 threshold (the seeded weights leave them near uniform)
    sd["roi_heads.box.predictor.cls_score.weight"] *= 40
    rng = np.random.RandomState(0)
    image = (rng.rand(64, 64, 3) * 255 - 120).astype(np.float32)
    return (jcfg, cfg), sd, image, (60, 62), grid_anchors(cfg.rpn, 4, 4)


def test_detector_weights_both_ways_with_attributes(rpn_case):
    (jcfg, cfg), sd, _, _, _ = rpn_case
    a = dconv.state_from_reference(sd, cfg)
    b = dconv.params_from_jax({"params": convert_detector_state_dict(sd, jcfg)},
                              cfg)
    assert a.keys() == b.keys()
    assert "attr_predictor.cls_embedding.weight" in a
    assert any(k.startswith("attr_extractor.head.layer4.") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


@pytest.mark.parametrize("nms_filter,with_attributes",
                         [(2, True), (2, False), (0, True), (1, False)])
def test_attr_rcnn_rpn_mode_matches_jax(rpn_case, nms_filter, with_attributes):
    """``AttrRCNN`` in RPN mode against JAX ``AttrRCNN.apply(...,
    anchors=...)`` from the same reference-layout weights: boxes, scores
    and features within TOL, labels and valid exact."""
    (jcfg, cfg), sd, image, hw, anchors = rpn_case
    jcfg, cfg = (dataclasses.replace(c, roi_heads=dataclasses.replace(
        c.roi_heads, nms_filter=nms_filter)) for c in (jcfg, cfg))
    model = JaxRCNN(jcfg, dtype=jnp.float32)
    want = jax.jit(lambda p, x, s: model.apply(
        p, x, s, anchors=jnp.asarray(anchors),
        with_attributes=with_attributes))(
        {"params": convert_detector_state_dict(sd, jcfg)}, jnp.asarray(image),
        jnp.asarray(hw))
    port = AttrRCNN(cfg, torch.float32).eval()
    port.load_state_dict(dconv.state_from_reference(sd, cfg))
    with torch.inference_mode():
        got = port(torch.from_numpy(image), hw, torch.from_numpy(anchors),
                   with_attributes)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert got["valid"].any()
    for k in set(got) - {"valid", "labels"}:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


CAPTION = "the dog on the right"


@pytest.fixture(scope="module")
def detect_slice(tmp_path_factory):
    """The JAX package's ``--detect`` chain (``make_detect_fn``, the
    ``--conf`` filter and sort of ``run_detector``, then its Extractor and
    ``refcoco_evaluate``) and the port's ``predict`` without dets, from the
    same weights, at ``conf`` 0."""
    det_cfg = tiny_detector_config()
    bert_cfg = tiny_bert_config(
        vocab_size=160, img_feature_dim=cpt_predict.region_feature_dim(det_cfg))
    jdet_cfg = jax_tiny_detector_config()
    jbert_cfg = jax_tiny_bert_config(vocab_size=160,
                                     img_feature_dim=bert_cfg.img_feature_dim)
    det_sd = random_vinvl_state_dict(jdet_cfg, seed=21)
    bert_sd = jconv.random_oscar_state_dict(jbert_cfg, seed=22)
    img = np.random.RandomState(23).randint(0, 256, (48, 60, 3)).astype(np.uint8)
    jtok = JaxTokenizer(jax_toy_vocab())

    det = JaxRCNN(jdet_cfg, dtype=jnp.float32)
    params = {"params": convert_detector_state_dict(det_sd, jdet_cfg)}
    canvas = np.zeros((64, 64, 3), np.uint8)
    canvas[:48, :60] = img
    _, boxes, _, scores, valid, _ = jext.make_detect_fn(
        det, jdet_cfg, with_attributes=False)(
        params, jnp.asarray(canvas), jnp.asarray(jrpn.grid_anchors(jdet_cfg.rpn, 4, 4)),
        jnp.asarray([48, 60], jnp.int32))
    boxes, scores = np.asarray(boxes), np.asarray(scores)
    keep = np.asarray(valid) & (scores > 0.0)
    dets = boxes[keep][np.argsort(-scores[keep])]

    wd = tmp_path_factory.mktemp("jax_detect")
    ex = jext.Extractor(det, params, jdet_cfg, copies_per_chunk=None)
    tsv = str(wd / "predictions.tsv")
    ex.run([jext.refcoco_task("q0", img, img.shape[:2], dets, CAPTION)], tsv)
    json.dump([{"id": "q0", "caption": CAPTION}], open(wd / "ann.json", "w"))
    det_json_for_stage2(tsv, str(wd / "det.json"))
    data = JaxData(tsv, str(wd / "ann.json"), str(wd / "det.json"), jtok,
                   img_feat_dim=jbert_cfg.img_feature_dim)
    _, preds = jscore.refcoco_evaluate(
        JaxRec(jbert_cfg, dtype=jnp.float32),
        {"params": jconv.params_for_task(
            jconv.convert_bert_state_dict(bert_sd, jbert_cfg), "rec_mlm_cpt")},
        data, jtok, batch_size=16)

    res = cpt_predict.Resident(
        det_cfg, dconv.state_from_reference(det_sd, det_cfg), bert_cfg,
        bconv.state_from_reference(bert_sd, bert_cfg), BertTokenizer(toy_vocab()),
        torch.device("cpu"), torch.float32)
    pwd = tmp_path_factory.mktemp("port_detect")
    box = cpt_predict.predict(res, img, CAPTION, None, workdir=str(pwd),
                              conf=0.0)
    candidates = cpt_predict.detect_candidates(res, img, 0.0)
    return (dets, tsv_region_features(tsv), preds["q0"]), (candidates, pwd, box)


def test_detect_slice_same_candidates(detect_slice):
    (dets, _, _), (candidates, _, _) = detect_slice
    assert len(candidates) == len(dets) >= 2
    np.testing.assert_allclose(candidates, dets, **TOL)


def test_detect_slice_same_features_and_box(detect_slice):
    (dets, feats, jax_box), (candidates, pwd, box) = detect_slice
    got = tsv_region_features(str(pwd / "predictions.tsv"))
    assert got.shape == feats.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, feats, **TOL)
    assert box in candidates
    assert candidates.index(box) == [list(map(float, d)) for d in dets].index(
        [float(v) for v in jax_box])
