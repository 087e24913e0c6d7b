"""The detector's remaining evaluators and test-time augmentation, port vs
JAX package, on the CPU: ``engine/sg_eval`` (both recall protocols, every
mode of the motifs evaluator, OI-VRD triplet and phrase AP) and
``engine/cityscapes_eval`` (box and mask AP) on entries drawn from seeds,
``tools/cityscapes_eval`` on JSON files with RLE masks, and
``engine/bbox_aug`` (hflip and rescales, merged by K5's wrapper, which
runs its plain version here) with a deterministic detector and through
``test_detector --tiny --bbox_aug``. Nothing here reads the reference
checkout."""
import functools
import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from cpt_tpu.engine import bbox_aug as jaug
from cpt_tpu.engine import cityscapes_eval as jcity
from cpt_tpu.engine import sg_eval as jsg
from cpt_tpu.models.detector.config import tiny_detector_config as jtiny
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.tools import cityscapes_eval as jcity_tool
from cpt_tpu.tools import test_detector as jtest_tool
from cpt_tpu_torch.engine import bbox_aug, cityscapes_eval, sg_eval
from cpt_tpu_torch.ops import nms_pallas
from cpt_tpu_torch.tools import cityscapes_eval as city_tool
from cpt_tpu_torch.tools import test_detector as test_tool
from cpt_tpu_torch.utils import rle
from test_torch_watchdog import guards

guard_module, guard_case = guards(200)

W, H = 96, 80
CLASSES = ("cat", "dog", "bird")


def same(a, b) -> bool:
    """Equal, NaN equal to NaN, through dicts, lists and arrays."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple, np.ndarray)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
        return a.shape == b.shape and bool((a == b).all())
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


# --- engine/sg_eval ---------------------------------------------------------------

def sg_entry(rng, n_gt=5, n_pred=8, n_rel=6, n_classes=6, n_preds=4):
    """A (gt_entry, pred_entry) pair: half the predicted boxes jittered gt
    boxes (they match), a predicate matrix for the IMP protocol."""
    def boxes(n):
        return np.sort(rng.uniform(0, 200, (n, 2, 2)), axis=1).reshape(n, 4).round()

    gt_boxes = boxes(n_gt)
    gt_classes = rng.randint(1, n_classes, n_gt)
    pairs = [(i, j) for i in range(n_gt) for j in range(n_gt) if i != j]
    sel = rng.choice(len(pairs), size=n_rel, replace=False)
    gt_rels = np.array([[*pairs[s], rng.randint(1, n_preds)] for s in sel])
    matrix = np.zeros((n_gt, n_gt), np.int64)
    matrix[gt_rels[:, 0], gt_rels[:, 1]] = gt_rels[:, 2]
    half = n_pred // 2
    pred_boxes = np.concatenate([gt_boxes[:half] + rng.uniform(-3, 3, (half, 4)),
                                 boxes(n_pred - half)])
    pred_classes = np.concatenate([gt_classes[:half],
                                   rng.randint(1, n_classes, n_pred - half)])
    ppairs = [(i, j) for i in range(n_pred) for j in range(n_pred) if i != j]
    psel = rng.choice(len(ppairs), size=min(30, len(ppairs)), replace=False)
    return ({"gt_relations": gt_rels, "gt_boxes": gt_boxes,
             "gt_classes": gt_classes, "pred_label_matrix": matrix},
            {"pred_boxes": pred_boxes, "pred_classes": pred_classes,
             "obj_scores": rng.uniform(0.3, 1.0, n_pred),
             "pred_rel_inds": np.array([ppairs[s] for s in psel]),
             "rel_scores": rng.uniform(0, 1, (len(psel), n_preds))})


@functools.lru_cache(maxsize=None)
def sg_entries(n_pred: int = 8):
    """Six seeded images; ``n_pred`` 5, one prediction a gt box, for the
    modes that read the gt boxes (sgcls, predcls)."""
    rng = np.random.RandomState(31)
    return [sg_entry(rng, n_pred=n_pred) for _ in range(6)]


def test_do_sg_evaluation_matches_jax():
    """Both recall protocols over six seeded images: the port's copy's
    numbers equal the JAX module's, and some recall is strictly between 0
    and 1."""
    got = sg_eval.do_sg_evaluation(sg_entries())
    assert same(got, jsg.do_sg_evaluation(sg_entries()))
    assert any(0 < v < 1 for m in got.values() for v in m.values())


@pytest.mark.parametrize("mode,multiple", [
    ("sgdet", False), ("sgcls", False), ("predcls", False), ("sgdet", True),
    ("preddet", True), ("phrdet", True)])
def test_motifs_evaluator_modes_match_jax(mode, multiple):
    """``SceneGraphEvaluator`` in each mode (the VRD modes with multiple
    predicates a pair): the recall means equal JAX's."""
    got = sg_eval.SceneGraphEvaluator(mode, multiple_preds=multiple)
    want = jsg.SceneGraphEvaluator(mode, multiple_preds=multiple)
    for gt, pred in sg_entries(5 if mode in ("sgcls", "predcls") else 8):
        got.evaluate_scene_graph_entry(gt, pred)
        want.evaluate_scene_graph_entry(gt, pred)
    assert same(got.means(), want.means())


@pytest.mark.parametrize("phrase", [False, True])
def test_openimages_vrd_eval_matches_jax(phrase):
    """OI-VRD triplet (subject / object boxes) or phrase (union box) AP and
    recall@50 over seeded detections, some true, some displaced."""
    rng = np.random.RandomState(32 + phrase)
    gt, pred = {}, {}
    for c in [(1, 2, 1), (2, 1, 3), (1, 3, 2)]:
        for img in ("im0", "im1", "im2"):
            rects = []
            for _ in range(rng.randint(1, 3)):
                b = np.sort(rng.uniform(0, 150, (2, 2, 2)), axis=1).reshape(2, 4)
                rects.append(b.round().tolist())
            key = ("rect",) if phrase else ("subject_rect", "object_rect")
            gt.setdefault(c, {})[img] = [dict(zip(key, r)) for r in rects]
            pred.setdefault(c, {})[img] = [
                {"score": float(rng.rand()),
                 **dict(zip(key, (np.asarray(r) + rng.uniform(-4, 4, (2, 4))
                                  * (1 + 20 * (rng.rand() < 0.4))).tolist()))}
                for r in rects + rects[:1]]
    got = sg_eval.openimages_vrd_relation_eval(gt, pred, eval_phrase=phrase)
    assert same(got, jsg.openimages_vrd_relation_eval(gt, pred, eval_phrase=phrase))
    assert 0 < got["map"] < 1


# --- engine/cityscapes_eval and its tool ---------------------------------------------

def blob(box) -> np.ndarray:
    x0, y0, x1, y1 = box
    yy, xx = np.mgrid[0:H, 0:W]
    rx, ry = max((x1 - x0) / 2, 1.0), max((y1 - y0) / 2, 1.0)
    return ((xx - (x0 + x1) / 2) / rx) ** 2 + ((yy - (y0 + y1) / 2) / ry) ** 2 <= 1


@functools.lru_cache(maxsize=None)
def city_records():
    """Seeded ground truth and predictions on a W×H canvas: jittered
    copies of each gt (some relabelled), duplicates, tied scores, small
    (ignored) gts, an image without gt and one without predictions."""
    rng = np.random.RandomState(33)
    gts, preds = [], []
    for i in range(5):
        n = 0 if i == 3 else rng.randint(2, 5)
        xy = rng.uniform(0, 60, (n, 2))
        wh = np.where(rng.rand(n, 1) < 0.2, 6.0, rng.uniform(12, 30, (n, 2)))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [W - 1, H - 1])], 1).round()
        labels = rng.randint(0, len(CLASSES) - (i < 2), n)
        gts.append({"boxes": boxes, "labels": labels,
                    "masks": np.stack([blob(b) for b in boxes]) if n
                    else np.zeros((0, H, W), bool)})
        if i == 4:
            preds.append({"boxes": np.zeros((0, 4)), "labels": np.zeros(0, np.int64),
                          "scores": np.zeros(0), "masks": np.zeros((0, H, W), bool)})
            continue
        pb = np.concatenate([boxes + rng.uniform(-3, 3, boxes.shape), boxes[:1]])
        pl = np.concatenate([np.where(rng.rand(n) < 0.2, (labels + 1) % 3, labels),
                             labels[:1]]) if n else np.zeros(0, np.int64)
        sc = rng.choice([0.3, 0.5, 0.9], len(pb))
        pb = np.clip(pb, 0, [W - 1, H - 1, W - 1, H - 1])
        preds.append({"boxes": pb, "labels": pl.astype(np.int64), "scores": sc,
                      "masks": np.stack([blob(b) for b in pb]) if len(pb)
                      else np.zeros((0, H, W), bool)})
    return gts, preds


def test_cityscapes_eval_matches_jax():
    """Box and mask AP of the port's copy equal the JAX module's, results
    matrix, averages and table alike."""
    gts, preds = city_records()
    got = cityscapes_eval.cityscapes_instance_eval(gts, preds, CLASSES)
    want = jcity.cityscapes_instance_eval(gts, preds, CLASSES)
    assert same(got, want)
    assert 0 < got["bbox"]["averages"]["allAp"] < 1


def test_cityscapes_tool_matches_jax(tmp_path):
    """``tools/cityscapes_eval`` on JSON files whose masks are COCO RLE (the
    port's ``utils/rle``): the JAX tool's results, and the JSON it writes."""
    gts, preds = city_records()

    def write(recs, name):
        out = []
        for r in recs:
            rec = {"boxes": r["boxes"].tolist(), "labels": r["labels"].tolist(),
                   "masks": [rle.encode(np.asfortranarray(m.astype(np.uint8)))
                             for m in r["masks"]]}
            for m in rec["masks"]:
                if isinstance(m["counts"], bytes):
                    m["counts"] = m["counts"].decode()
            if "scores" in r:
                rec["scores"] = r["scores"].tolist()
            out.append(rec)
        path = tmp_path / name
        path.write_text(json.dumps(out))
        return str(path)

    args = ["--gt", write(gts, "gt.json"), "--pred", write(preds, "pred.json"),
            "--classes", ",".join(CLASSES)]
    got = city_tool.main(args + ["--output_json", str(tmp_path / "a.json")])
    want = jcity_tool.main(args + ["--output_json", str(tmp_path / "b.json")])
    assert same(got, want)
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert same(got, cityscapes_eval.cityscapes_instance_eval(gts, preds, CLASSES))


# --- engine/bbox_aug ------------------------------------------------------------------

def fake_detector(seed):
    """A deterministic ``detect_fn``: boxes from the image's column means
    (so a flipped or rescaled image gives other boxes), scores and labels
    from a seeded stream; every call's inputs recorded."""
    calls = []

    def detect(img, hw):
        img = np.asarray(img)
        calls.append((img.copy(), tuple(hw)))
        rng = np.random.RandomState(seed + len(calls))
        n = 12
        h, w = hw
        col = img[:h, :w].mean(axis=(0, 2))
        x0 = (np.argsort(col)[:n] * 0.8).astype(np.float32)
        y0 = rng.uniform(0, h / 2, n).astype(np.float32)
        boxes = np.stack([x0, y0, np.minimum(x0 + rng.uniform(5, 30, n), w - 1),
                          np.minimum(y0 + rng.uniform(5, 30, n), h - 1)], 1)
        valid = rng.rand(n) < 0.8
        return {"boxes": boxes.astype(np.float32),
                "scores": rng.uniform(0.1, 1, n).astype(np.float32),
                "labels": rng.randint(1, 6, n), "valid": valid}
    return detect, calls


def test_bbox_aug_matches_jax():
    """hflip and scales 0.5, 1.5 with the same deterministic detector: the
    same passes (the flipped and rescaled images equal), the merged
    detections equal; the merge is one K5 call at the pooled K."""
    rng = np.random.RandomState(34)
    image = rng.randint(0, 256, (64, 80, 3)).astype(np.uint8)
    det, calls = fake_detector(5)
    jdet, jcalls = fake_detector(5)
    before = nms_pallas.nms_pallas.launches
    got = bbox_aug.im_detect_bbox_aug(det, image, (60, 72), scales=(0.5, 1.5),
                                      device="cpu")
    want = jaug.im_detect_bbox_aug(jdet, image, (60, 72), scales=(0.5, 1.5))
    assert nms_pallas.nms_pallas.launches == before   # the CPU: the plain version
    assert len(calls) == len(jcalls) == 4
    for (a, hw), (b, jhw) in zip(calls, jcalls):
        assert hw == jhw and np.array_equal(a, b)
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert 0 < got["valid"].sum() < 4 * 12 * 0.8      # the merge suppressed some


@functools.lru_cache(maxsize=None)
def checkpoint() -> str:
    d = tempfile.mkdtemp(prefix="test_torch_detector_eval_extras_")
    path = os.path.join(d, "det.pth")
    sd = random_vinvl_state_dict(jtiny(), seed=8)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def test_test_detector_bbox_aug_matches_jax(monkeypatch):
    """``test_detector --tiny --synthetic 2 --bbox_aug --bbox_aug_scales
    0.75`` from one checkpoint: the results (mAP) equal the JAX tool's (its
    detector init patched to the checkpoint's tree, which ``--checkpoint``
    replaces anyway)."""
    tree = convert_detector_state_dict(random_vinvl_state_dict(jtiny(), seed=8),
                                       jtiny())

    class JDetector(jtest_tool.AttrRCNN):
        def init(self, rngs, *args, **kw):
            return {"params": tree}

    monkeypatch.setattr(jtest_tool, "AttrRCNN", JDetector)
    flags = ["--tiny", "--synthetic", "2", "--dtype", "float32", "--checkpoint",
             checkpoint(), "--bbox_aug", "--bbox_aug_scales", "0.75"]
    want, want_ok = jtest_tool.main(flags)
    got, ok = test_tool.main(flags + ["--device", "cpu"])
    assert ok and want_ok and sorted(got) == sorted(want)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, k
