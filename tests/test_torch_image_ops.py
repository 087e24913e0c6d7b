"""``cpt_tpu_torch/utils/image_ops`` (the port's Pillow-free bilinear and
nearest resize and polygon fill) bit for bit against Pillow 12.1.0 on
seeded corpora, the five port call sites that use it against the JAX
package's Pillow calls on the same inputs, the five run with Pillow
blocked, and ``chip_smoke.RESIZE_DIGESTS`` against Pillow.

Pillow's polygon fill has changed between releases (its corner rule and
the handling of degenerate edges); the fill here follows 12.1.0, the
version ``test_pillow_is_the_version_the_rules_follow`` names."""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import PIL
import pytest
from PIL import Image

import chip_smoke as cs
from cpt_tpu.data import stage1_tasks as jstage1
from cpt_tpu.engine import bbox_aug as jaug
from cpt_tpu.models.detector import config as jdet_config
from cpt_tpu.tools import extract_features as jextract
from cpt_tpu.tools import serve as jserve
from cpt_tpu_torch.data import stage1_tasks
from cpt_tpu_torch.engine import bbox_aug
from cpt_tpu_torch.models.detector import config as det_config
from cpt_tpu_torch.tools import extract_features, serve
from cpt_tpu_torch.utils.image_ops import (fill_polygon, resize_bilinear,
                                           resize_nearest)
from test_torch_watchdog import guards

guard_module, guard_case = guards(120)

PILLOW_VERSION = "12.1.0"
REPO = Path(__file__).resolve().parents[1]


def pillow_bilinear(img, size):
    return np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))


def pillow_nearest(mask, size):
    return np.asarray(Image.fromarray(mask.astype(np.uint8)).resize(
        size, Image.NEAREST))


def pillow_fill(polygon, h, w):
    """The JAX package's rasterizer: ImageDraw's fill of each part."""
    return jstage1.rasterize_polygon(polygon, h, w)


def test_pillow_is_the_version_the_rules_follow():
    assert PIL.__version__ == PILLOW_VERSION


def _resize_cases(seed: int, n: int, rgb: bool):
    """(array, (w, h)) pairs: sides 1-300, up and down, every fifth case
    keeping the height and every fifth the width."""
    rng = np.random.RandomState(seed)
    for t in range(n):
        h, w = (int(v) for v in rng.randint(1, 301, 2))
        oh, ow = (int(v) for v in rng.randint(1, 301, 2))
        if t % 5 == 0:
            oh = h
        elif t % 5 == 1:
            ow = w
        shape = (h, w, 3) if rgb else (h, w)
        yield rng.randint(0, 256, shape).astype(np.uint8), (ow, oh)


@pytest.mark.parametrize("rgb", [False, True], ids=["L", "RGB"])
@pytest.mark.parametrize("chunk", range(5))
def test_resize_bilinear_is_pillows(chunk, rgb):
    """500 cases over the ten chunks."""
    for img, size in _resize_cases(100 * chunk + rgb, 50, rgb):
        np.testing.assert_array_equal(resize_bilinear(img, size),
                                      pillow_bilinear(img, size),
                                      err_msg=f"{img.shape} -> {size}")


@pytest.mark.parametrize("chunk", range(5))
def test_resize_nearest_is_pillows(chunk):
    """500 masks over the five chunks: binary, and uint8 of any value."""
    for t, (img, size) in enumerate(_resize_cases(500 + chunk, 100, False)):
        mask = img if t % 2 else (img > 127).astype(np.uint8)
        np.testing.assert_array_equal(resize_nearest(mask, size),
                                      pillow_nearest(mask, size),
                                      err_msg=f"{mask.shape} -> {size}")


@pytest.mark.parametrize("name", ["serve_up", "serve_down", "bbox_aug_0.75",
                                  "bbox_aug_1.25", "mask_nearest", "polygons"])
def test_resize_digests_are_pillows(name):
    """``chip_smoke.RESIZE_DIGESTS`` (which the card must reproduce) are
    Pillow's output on ``resize_digest_inputs`` (phase 8's 480×640 → 600×800
    and 1200×1600 → 600×800 requests, phase 17's 1024² image at ×0.75 and
    ×1.25, a 480×640 mask at ×1.25, phase 9's polygons), and image_ops'
    output equals Pillow's there."""
    fn, args = cs.resize_digest_inputs()[name]
    want = {"resize_bilinear": pillow_bilinear, "resize_nearest": pillow_nearest,
            "fill_polygon": pillow_fill}[fn](*args)
    got = {"resize_bilinear": resize_bilinear, "resize_nearest": resize_nearest,
           "fill_polygon": fill_polygon}[fn](*args)
    np.testing.assert_array_equal(got, want)
    assert hashlib.sha256(np.ascontiguousarray(want).tobytes()).hexdigest() \
        == cs.RESIZE_DIGESTS[name]


@pytest.mark.parametrize("fault", cs.IMAGE_OP_FAULTS)
def test_named_faults_change_a_digest(fault):
    """Each of ``chip_smoke.IMAGE_OP_FAULTS`` changes the digest it is
    aimed at (so the card's digest check would see it)."""
    aimed = {"nearest_multiplied": "mask_nearest",
             "narrow_support": "serve_down", "vertical_first": "serve_up",
             "span_ends_plain": "polygons"}[fault]
    inputs = {aimed: cs.resize_digest_inputs()[aimed]}
    with cs.image_op_fault(fault):
        changed = cs.image_op_digests(inputs)[0]
    assert changed[aimed] != cs.RESIZE_DIGESTS[aimed]
    assert cs.image_op_digests(inputs)[0][aimed] == cs.RESIZE_DIGESTS[aimed]


def _polygon_case(rng, kind: int):
    """A polygon (one part, or a list of parts) and its canvas (h, w), of
    one of eight kinds: float vertices around and off the canvas, integer
    lattice vertices, half-integer vertices, axis-parallel walks (horizontal
    and vertical edges), self-intersecting stars, far-off large
    coordinates, two-point and repeated-vertex parts, and multi-part input
    with empty and one-point parts."""
    h, w = (int(v) for v in rng.randint(1, 61, 2))
    n = int(rng.randint(1, 12))
    if kind == 0:
        return np.c_[rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)].tolist(), h, w
    if kind == 1:
        return rng.randint(-3, max(h, w) + 3, (n, 2)).astype(float).tolist(), h, w
    if kind == 2:
        return (rng.randint(-6, 2 * max(h, w) + 6, (n, 2)) / 2.0).tolist(), h, w
    if kind == 3:
        pts = [[float(rng.randint(0, w)), float(rng.randint(0, h))]]
        for q in range(n):
            x, y = pts[-1]
            if q % 2:
                x = float(rng.randint(-2, w + 2))
            else:
                y = float(rng.randint(-2, h + 2))
            pts.append([x, y])
        return pts, h, w
    if kind == 4:
        ang = rng.uniform(0, 2 * np.pi, n + 3)
        r = rng.uniform(1, max(h, w), n + 3)
        return np.c_[w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)].tolist(), h, w
    if kind == 5:
        return np.c_[rng.uniform(-2000, 2000, n), rng.uniform(-2000, 2000, n)].tolist(), h, w
    if kind == 6:
        pts = rng.uniform(-3, max(h, w) + 3, (int(rng.randint(1, 4)), 2))
        pts = pts[rng.randint(0, len(pts), int(rng.randint(1, 7)))]
        return pts.round(int(rng.randint(0, 2))).tolist(), h, w
    parts = []
    for _ in range(int(rng.randint(1, 5))):
        m = int(rng.randint(0, 7))
        parts.append(np.c_[rng.uniform(-3, w + 3, m), rng.uniform(-3, h + 3, m)]
                     .round(int(rng.randint(0, 3))).tolist())
    return parts, h, w


@pytest.mark.parametrize("chunk", range(10))
def test_fill_polygon_is_pillows(chunk):
    """2000 polygons over the ten chunks, 25 of each kind a chunk."""
    rng = np.random.RandomState(900 + chunk)
    for t in range(200):
        poly, h, w = _polygon_case(rng, t % 8)
        np.testing.assert_array_equal(fill_polygon(poly, h, w),
                                      pillow_fill(poly, h, w),
                                      err_msg=f"kind {t % 8}: {poly} on {h}x{w}")


def test_fill_polygon_parts():
    """The part forms ``rasterize_polygon`` accepts: a list of parts whose
    first is empty, an empty polygon, one point, a numpy array."""
    square = [[2.0, 2.0], [9.0, 2.0], [9.0, 8.0], [2.0, 8.0]]
    for poly in ([[], square], [], [[4.0, 5.0]], np.asarray(square),
                 [square, [[12.5, 1.5]], [[11.0, 6.0], [15.0, 9.0]]]):
        np.testing.assert_array_equal(fill_polygon(poly, 12, 16),
                                      pillow_fill(poly, 12, 16))
    assert fill_polygon([], 12, 16).sum() == 0


# --- the call sites against the JAX package's Pillow calls --------------------

def _vinvl_services():
    """The port's and the JAX package's CPTService, only their detector
    config set (``_resize`` reads nothing else)."""
    svc = serve.CPTService.__new__(serve.CPTService)
    jsvc = jserve.CPTService.__new__(jserve.CPTService)
    svc.dcfg, jsvc.dcfg = det_config.VINVL_X152C4, jdet_config.VINVL_X152C4
    return svc, jsvc


@pytest.mark.parametrize("name", ["up", "down"])
def test_serve_resize_matches_jax(name):
    """``CPTService._resize`` on phase 8's two resized requests (×1.25 and
    ×0.5, to 600×800) equals the JAX service's Pillow resize."""
    img, _ = cs.resized_request(name)
    svc, jsvc = _vinvl_services()
    got, scale = svc._resize(img)
    want, jscale = jsvc._resize(img)
    assert scale == jscale and got.shape == (600, 800, 3)
    np.testing.assert_array_equal(got, want)


def test_load_image_resize_matches_jax(tmp_path):
    """``extract_features.load_image`` with the 600/1000 rule on a PNG
    (427×640, ×1.405, then clipped to the canvas) equals the JAX tool's."""
    path = str(tmp_path / "img.png")
    Image.fromarray(np.random.RandomState(41).randint(
        0, 256, (427, 640, 3)).astype(np.uint8)).save(path)
    got, hw = extract_features.load_image(path, 640, 1024, 600, 1000)
    want, jhw = jextract.load_image(path, 640, 1024, 600, 1000)
    assert tuple(hw) == tuple(jhw) == (600, 899)
    np.testing.assert_array_equal(got, want)


def test_scale_mask_matches_jax():
    """``extract_features.scale_mask`` (--resize's mask scaling) equals the
    JAX tool's, up and down."""
    rng = np.random.RandomState(42)
    for shape, sc in (((480, 640), 1.25), ((1200, 1600), 0.5), ((333, 517), 1.37)):
        mask = (rng.rand(*shape) < 0.3).astype(np.uint8)
        np.testing.assert_array_equal(extract_features.scale_mask(mask, sc),
                                      jextract.scale_mask(mask, sc))


def test_vcr_color_task_from_polygons_matches_jax():
    """``vcr_color_task`` on phase 9's polygon fixture (multi-part, an
    empty part, a one-point part, a member without a polygon): the
    composited image bit for bit and the meta equal the JAX package's."""
    fx = cs.vcr_polygon_fixture()
    for q in fx["questions"]:
        args = ("v", fx["image"], fx["image"].shape[:2], np.asarray(fx["boxes"]),
                q["entity_ids"], fx["polygons"], dict(enumerate(fx["names"])))
        got = stage1_tasks.vcr_color_task(*args, color_d=3)
        want = jstage1.vcr_color_task(*args, color_d=3)
        np.testing.assert_array_equal(got.image_rgb, want.image_rgb)
        assert got.meta == want.meta and got.meta["obj_colors"]


# --- the five port functions with Pillow blocked ------------------------------

NO_PILLOW = r"""
import sys, json
import numpy as np
sys.modules["PIL"] = None
from cpt_tpu_torch.data import stage1_tasks
from cpt_tpu_torch.engine import bbox_aug
from cpt_tpu_torch.models.detector import config as det_config
from cpt_tpu_torch.tools import extract_features, serve

inp = dict(np.load(sys.argv[1], allow_pickle=True))
out = {}
svc = serve.CPTService.__new__(serve.CPTService)
svc.dcfg = det_config.VINVL_X152C4
out["serve"] = svc._resize(inp["serve"])[0]
out["mask"] = extract_features.scale_mask(inp["mask"], 1.25)
out["polygon"] = stage1_tasks.rasterize_polygon(
    json.loads(str(inp["polygon"])), 600, 800)
seen = []
def detect(img, hw):
    seen.append(np.array(img))
    return {"boxes": np.zeros((1, 4), np.float32), "scores": np.ones(1, np.float32),
            "labels": np.ones(1, np.int64), "valid": np.ones(1, bool)}
bbox_aug.im_detect_bbox_aug(detect, inp["aug"], inp["aug"].shape[:2],
                            scales=(0.75, 1.25), device="cpu")
out["aug_075"], out["aug_125"] = seen[2], seen[3]
# load_image: the file decoded by utils/image_codec, Pillow still blocked
out["load"] = extract_features.load_image(sys.argv[2], 640, 1024, 600, 1000)[0]
np.savez(sys.argv[3], **out)
print("OK")
"""


def test_port_functions_run_without_pillow(tmp_path):
    """In a process where ``import PIL`` fails, the five sites give the
    arrays the JAX package's Pillow calls give (``load_image`` reads a PNG
    through ``utils/image_codec``)."""
    rng = np.random.RandomState(43)
    serve_img, _ = cs.resized_request("up")
    mask = (rng.rand(480, 640) < 0.4).astype(np.uint8)
    fx = cs.vcr_polygon_fixture()
    polygon = fx["polygons"][2]
    aug = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    photo = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    np.savez(tmp_path / "in.npz", serve=serve_img, mask=mask, aug=aug,
             polygon=np.asarray(json.dumps(polygon)))
    Image.fromarray(photo).save(tmp_path / "photo.png")
    proc = subprocess.run(
        [sys.executable, "-c", NO_PILLOW, str(tmp_path / "in.npz"),
         str(tmp_path / "photo.png"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, timeout=100,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")

    _, jsvc = _vinvl_services()
    np.testing.assert_array_equal(got["serve"], jsvc._resize(serve_img)[0])
    np.testing.assert_array_equal(got["mask"], jextract.scale_mask(mask, 1.25))
    np.testing.assert_array_equal(got["polygon"],
                                  jstage1.rasterize_polygon(polygon, 600, 800))
    seen = []

    def detect(img, hw):
        seen.append(np.array(img))
        return {"boxes": np.zeros((1, 4), np.float32),
                "scores": np.ones(1, np.float32),
                "labels": np.ones(1, np.int64), "valid": np.ones(1, bool)}

    jaug.im_detect_bbox_aug(detect, aug, aug.shape[:2], scales=(0.75, 1.25))
    np.testing.assert_array_equal(got["aug_075"], seen[2])
    np.testing.assert_array_equal(got["aug_125"], seen[3])
    np.testing.assert_array_equal(got["load"], jextract.load_image(
        str(tmp_path / "photo.png"), 640, 1024, 600, 1000)[0])


# --- chip_smoke.py's new checks, dry-run here ---------------------------------

def test_check_resize_digests_passes_here():
    """``chip_smoke.check_resize_digests`` (phase 8's first check): every
    digest matches and every named fault changes one."""
    out = cs.check_resize_digests()
    assert all(out["matched"].values()) and all(out["faults"].values())


def test_vcr_polygons_dry_run():
    """``chip_smoke.run_vcr_polygons`` (phase 9) with the tiny detector on
    the CPU: the polygon run's TSV equals the from-masks run's byte for
    byte; no kernel launches here."""
    out = cs.run_vcr_polygons(cs.kernel_counters(), "cpu", "float32",
                              tiny=True)
    assert out["equal"] and out["rows"] == 2 and out["finite"]
    assert all(out["colored"]) and not any(out["launches"].values())
