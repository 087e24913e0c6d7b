"""The RefCOCO SEG task (each candidate's segmentation mask painted instead
of its box), the port against the JAX package on the CPU in f32 at tiny
sizes, from the same seeded reference-layout weights: the task builder,
the extractor's mask copies on the full path and windowed (against JAX's
and against the port's own full path), and ``extract_features`` on a det
file where one image's dets carry ``"rle"`` masks and another's do not."""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from chip_smoke import ellipse_masks
from cpt_tpu.engine import extract as jextract
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector.attr_rcnn import AttrRCNN as JaxRCNN
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.tools import extract_features as jextract_tool
from cpt_tpu_torch.engine.extract import Extractor, refcoco_mask_task
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.ops.render import paste_mask, paste_rects
from cpt_tpu_torch.tools import extract_features
from cpt_tpu_torch.utils import rle
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_watchdog import guards

guard_module, guard_case = guards(240)

CANVAS = (256, 288)
PARITY = 1e-5       # port against JAX, of the JAX output's largest magnitude
EXACT = 2e-4        # windowed against its own package's full path (f32)
HALO = 32           # ≥ 2·13, the deep config's early RF
LADDER = [(96, 112), (128, 144)]
# the candidates: four whose masks fit a window (one central, three flush
# with a canvas edge) and one too large for any (the full path)
BOXES = np.asarray([[92, 90, 114, 112], [2, 2, 18, 20], [266, 236, 286, 254],
                    [102, 2, 120, 18], [10, 10, 230, 200]], np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _config(m):
    cfg = m.tiny_detector_config()
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, stage_blocks=(1, 1, 6)),
        input=dataclasses.replace(cfg.input, pad_h=CANVAS[0], pad_w=CANVAS[1],
                                  buckets=(CANVAS,)))


@functools.lru_cache(maxsize=None)
def _case():
    """(port cfg, JAX cfg, port model, JAX model, JAX params, port task,
    JAX task) from one seeded reference-layout state dict."""
    from cpt_tpu.engine.extract import refcoco_mask_task as jmask_task

    cfg, jcfg = _config(det_cfg), _config(jdet_cfg)
    sd = random_vinvl_state_dict(jcfg, seed=9)
    model = AttrRCNN(cfg).eval()
    model.load_state_dict(dconv.state_from_reference(sd, cfg), strict=False)
    jparams = {"params": convert_detector_state_dict(sd, jcfg)}
    rng = np.random.RandomState(12)
    image = rng.randint(0, 256, CANVAS + (3,)).astype(np.uint8)
    masks = ellipse_masks(BOXES, CANVAS)
    task = refcoco_mask_task("q0", image, CANVAS, BOXES, masks, "the thing")
    jtask = jmask_task("q0", image, CANVAS, BOXES, masks, "the thing")
    return cfg, jcfg, model, JaxRCNN(jcfg), jparams, task, jtask


def test_refcoco_mask_task_matches_jax():
    *_, task, jtask = _case()
    for f in ("key", "caption", "image_hw", "copy_color_names"):
        assert getattr(task, f) == getattr(jtask, f), f
    for f in ("image_rgb", "det_boxes", "copy_rects", "copy_rect_valid",
              "copy_colors_rgba", "copy_masks", "copy_mask_colors"):
        np.testing.assert_array_equal(getattr(task, f), getattr(jtask, f), f)
    assert task.n_copies == 5 and not task.copy_colors_rgba[..., 3].any()
    # the rects paint at alpha 0 (an exact no-op); the mask paints
    img = torch.from_numpy(task.image_rgb)
    rect = paste_rects(img, torch.from_numpy(task.copy_rects[0]),
                       torch.from_numpy(task.copy_colors_rgba[0]),
                       torch.from_numpy(task.copy_rect_valid[0]))
    assert torch.equal(rect, img)
    painted = paste_mask(img, torch.from_numpy(task.copy_masks[0]),
                         torch.from_numpy(task.copy_mask_colors[0])).numpy()
    on = task.copy_masks[0].astype(bool)
    assert (painted[on] != task.image_rgb[on]).any()
    np.testing.assert_array_equal(painted[~on], task.image_rgb[~on])


@functools.lru_cache(maxsize=None)
def _extract(package: str, windowed: bool):
    """One package's Extractor (mask copies, 2 a chunk) on the task."""
    cfg, jcfg, model, jmodel, jparams, task, jtask = _case()
    kw = dict(copies_per_chunk=2)
    if windowed:
        kw.update(windowed=True, window=LADDER, halo=HALO)
    if package == "jax":
        return jextract.Extractor(jmodel, jparams, jcfg, with_masks=True,
                                  **kw).extract_task(jtask)
    ex = Extractor(model, cfg, **kw)
    out = ex.extract_task(task)
    if windowed:
        assert ex.windowed_mode == "two_level"
        assert ex.route_copies == {"96x112": 3, "128x144": 1, "full": 1}, (
            ex.route_copies)
    return out


@pytest.mark.parametrize("windowed", [False, True])
def test_mask_copies_match_jax(windowed):
    got, want = _extract("port", windowed), _extract("jax", windowed)
    assert got[0].shape == want[0].shape == (5, 8, 134)
    assert np.isfinite(got[0]).all()
    assert _rel(got[0], want[0]) <= PARITY
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=PARITY)


def test_windowed_mask_copies_equal_the_full_path():
    full, win = _extract("port", False), _extract("port", True)
    assert _rel(win[0], full[0]) <= EXACT
    np.testing.assert_array_equal(win[1], full[1])


def test_mask_paint_moves_the_features():
    """The rectangle painted in the mask's place (the named fault of the
    card's check) gives other features."""
    cfg, _, model, _, _, task, _ = _case()
    full = _extract("port", False)
    rect = dataclasses.replace(task, copy_masks=None, copy_mask_colors=None,
                               copy_colors_rgba=np.tile(
                                   task.copy_mask_colors[:, None], (1, 1, 1)))
    bad = Extractor(model, cfg, copies_per_chunk=2).extract_task(rect)
    assert _rel(bad[0], full[0]) > 100 * EXACT


def _write_refcoco_inputs(root) -> list:
    """Two RefCOCO images: image 7's dets are boxes, image 8's carry RLE
    masks (the reference decides per image) → the tools' arguments."""
    from PIL import Image

    rng = np.random.RandomState(5)
    anns, dets = [], {}
    for q in (7, 8):
        name = f"COCO_val2014_{q:012d}.jpg"
        Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
            root / name)
        anns.append({"id": f"r{q}", "caption": "the red thing",
                     "file_name": name})
        boxes = np.asarray([[4, 4, 24, 30], [30, 8, 58, 40], [10, 34, 50, 60]],
                           np.float32)
        masks = ellipse_masks(boxes, (64, 64))
        dets[str(q)] = [
            dict({"box": [float(b[0]), float(b[1]), float(b[2] - b[0] + 1),
                          float(b[3] - b[1] + 1)]},
                 **({"rle": rle.encode(m)} if q == 8 else {}))
            for b, m in zip(boxes, masks)]
    with open(root / "ann.json", "w") as f:
        json.dump(anns, f)
    with open(root / "det.json", "w") as f:
        json.dump(dets, f)
    ckpt = root / "vinvl.pth"
    torch.save({k: torch.from_numpy(v) for k, v in random_vinvl_state_dict(
        jdet_cfg.tiny_detector_config(), seed=31).items()}, ckpt)
    return ["--ann_file", str(root / "ann.json"), "--det_file",
            str(root / "det.json"), "--image_root", str(root), "--tiny",
            "--dtype", "float32", "--checkpoint", str(ckpt),
            "--copies_per_chunk", "2"]


def _rows(path) -> dict:
    tsv = TSVFile(str(path))
    rows = {tsv.seek(i)[0]: json.loads(tsv.seek(i)[1])["objects"]
            for i in range(len(tsv))}
    tsv.close()
    return rows


def test_extract_features_seg_matches_jax(tmp_path):
    args = _write_refcoco_inputs(tmp_path)
    jextract_tool.main(args + ["--output", str(tmp_path / "jax.tsv")])
    extract_features.main(args + ["--device", "cpu", "--output",
                                  str(tmp_path / "port.tsv")])
    got, want = _rows(tmp_path / "port.tsv"), _rows(tmp_path / "jax.tsv")
    assert sorted(got) == sorted(want) == ["r7", "r8"]
    for q in want:
        (gobjs, *gmeta), (wobjs, *wmeta) = got[q], want[q]
        assert gmeta == wmeta
        gb = [b for copy in gobjs for b in copy]
        wb = [b for copy in wobjs for b in copy]
        assert len(gb) == 9
        assert [b["rect"] for b in gb] == [b["rect"] for b in wb]
        gf = np.stack([decode_feature(b["feature"]) for b in gb])
        wf = np.stack([decode_feature(b["feature"]) for b in wb])
        assert np.isfinite(gf).all() and _rel(gf, wf) <= 2e-4


def test_rle_round_trip_and_bbox():
    """The port's RLE codec on ellipse masks: encode → decode is the mask,
    the area and box agree with it."""
    masks = ellipse_masks(BOXES[:3], (260, 300))
    for m in masks:
        code = rle.encode(m)
        np.testing.assert_array_equal(rle.decode(code), m)
        assert rle.area(code) == int(m.sum())
        ys, xs = np.nonzero(m)
        if ys.size:
            np.testing.assert_array_equal(
                rle.to_bbox(code), [xs.min(), ys.min(), xs.max() - xs.min() + 1,
                                    ys.max() - ys.min() + 1])
