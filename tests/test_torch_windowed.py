"""Windowed extraction (``cpt_tpu_torch/engine/windowed.py`` and the
windowed ``Extractor``) against ``cpt_tpu/engine/windowed.py`` on the CPU
in f32, from the same seeded reference-layout state dict: the host-side
routing, the one-level, two-level and cascaded extractors, the Extractor's
mode selection, ladder routing, batched base passes and drift harness, and
the ``--windowed`` tools end to end. Canvases are small (256×288) so each
case stays within seconds; the cascade still runs two windowed blocks
there, on windows smaller than the map."""
import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cpt_tpu.engine import extract as jextract
from cpt_tpu.engine import windowed as jwnd
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector.attr_rcnn import AttrRCNN as JaxRCNN
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu_torch.engine import windowed as wnd
from cpt_tpu_torch.engine.extract import (Extractor, make_extract_fn,
                                          refcoco_task)
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_watchdog import guards

guard_module, guard_case = guards(150)

CANVAS = (256, 288)
PARITY = 1e-5       # port against JAX, of the JAX output's largest magnitude
EXACT = 2e-4        # windowed against its own package's full path (f32)
# copies: central, flush top-left, flush bottom-right, flush top, and one
# central rect too large for the window (full path in the Extractor)
RECTS = np.asarray([[[96, 96, 110, 108]], [[2, 2, 16, 18]],
                    [[268, 238, 284, 252]], [[104, 3, 118, 15]]], np.float32)
WINDOW = (96, 112)
HALO = 32           # ≥ 2·13, the deep config's early RF; < 2·101, its full RF
# window and halo of each mode: one level is exact at ≥ 2·21 on the
# shallow tiny config
GEOMETRY = {"one_level": ((128, 144), 48), "two_level": (WINDOW, HALO),
            "cascade": (WINDOW, HALO)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _config(m, stage_blocks=(1, 1, 1)):
    """One package's tiny detector on the test canvas, with
    ``stage_blocks`` (``(1, 1, 6)``: the deep config whose full RF exceeds
    the halo while its early RF does not)."""
    cfg = m.tiny_detector_config()
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone,
                                          stage_blocks=stage_blocks),
        input=dataclasses.replace(cfg.input, pad_h=CANVAS[0], pad_w=CANVAS[1],
                                  buckets=(CANVAS,)))


@functools.lru_cache(maxsize=None)
def _case(stage_blocks):
    """(port cfg, JAX cfg, port model, JAX model, JAX params, image, dets)
    from one seeded reference-layout state dict."""
    cfg, jcfg = _config(det_cfg, stage_blocks), _config(jdet_cfg, stage_blocks)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    sd = random_vinvl_state_dict(jcfg, seed=7)
    model = AttrRCNN(cfg).eval()
    model.load_state_dict(dconv.state_from_reference(sd, cfg), strict=False)
    jparams = {"params": convert_detector_state_dict(sd, jcfg)}
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, CANVAS + (3,)).astype(np.uint8)
    # the candidates: a box around each copy's paint (as RefCOCO paints its
    # candidates), then boxes drawn at random over the canvas
    m = cfg.max_force_boxes
    xy = rng.uniform(0, 150, (m - len(RECTS), 2))
    drawn = np.concatenate([xy, xy + rng.uniform(8, 80, xy.shape)], 1)
    around = RECTS[:, 0] + np.asarray([-6, -6, 6, 6], np.float32)
    dets = np.clip(np.concatenate([around, drawn]), 0,
                   [CANVAS[1] - 1, CANVAS[0] - 1] * 2).astype(np.float32)
    return cfg, jcfg, model, JaxRCNN(jcfg), jparams, image, dets


def _inputs(dets, n):
    colors = np.tile(np.asarray([240, 0, 30, 127], np.uint8), (n, 1, 1))
    return (RECTS[:n], np.ones((n, 1), bool), colors, np.ones((n,), bool),
            dets, np.ones((len(dets),), bool),
            np.asarray(CANVAS, np.int32))


@functools.lru_cache(maxsize=None)
def _jax_outputs(stage_blocks, mode):
    """JAX's full path and its ``mode`` windowed path ("one_level",
    "two_level" or "cascade") on the four copies → numpy tuples."""
    cfg, jcfg, _, jmodel, jparams, image, dets = _case(stage_blocks)
    args = [jnp.asarray(a) for a in _inputs(dets, 4)]
    full = jextract.make_extract_fn(jmodel, jcfg)(
        jparams, jnp.asarray(image), *args[:4],
        jnp.zeros((4,) + CANVAS, jnp.uint8), jnp.zeros((4, 4), jnp.uint8),
        *args[4:])
    window, halo = GEOMETRY[mode]
    origins, fits = jwnd.window_origins(RECTS, window, CANVAS, halo)
    assert fits.all()
    if mode == "one_level":
        base = jwnd.make_base_features_fn(jmodel, jcfg)(jparams,
                                                        jnp.asarray(image))
        fn = jwnd.make_windowed_extract_fn(jmodel, jcfg, window=window,
                                           halo=halo)
    else:
        base = jwnd.make_base_early_fn(jmodel, jcfg, 2)(jparams,
                                                        jnp.asarray(image))
        fn = jwnd.make_two_level_extract_fn(jmodel, jcfg, window=window,
                                            halo=halo,
                                            cascade=mode == "cascade")
    got = fn(jparams, jnp.asarray(image), base, jnp.asarray(origins), *args)
    return (tuple(np.asarray(a) for a in full),
            tuple(np.asarray(a) for a in got))


def _port(stage_blocks, mode):
    """The port's full path and its ``mode`` windowed path, as _jax_outputs."""
    cfg, _, model, _, _, image, dets = _case(stage_blocks)
    t = [torch.from_numpy(a) for a in _inputs(dets, 4)]
    hw = tuple(CANVAS)
    img = torch.from_numpy(image)
    full = make_extract_fn(model, cfg)(img, *t[:6], hw)
    window, halo = GEOMETRY[mode]
    origins, fits = wnd.window_origins(RECTS, window, CANVAS, halo)
    assert fits.all()
    if mode == "one_level":
        base = wnd.make_base_features_fn(model, cfg)(img)
        fn = wnd.make_windowed_extract_fn(model, cfg, window=window,
                                          halo=halo)
    else:
        base = wnd.make_base_early_fn(model, cfg)(img)
        fn = wnd.make_two_level_extract_fn(model, cfg, window=window,
                                           halo=halo,
                                           cascade=mode == "cascade")
    got = fn(img, base, origins, *t[:6], hw)
    return (tuple(a.numpy() for a in full), tuple(a.numpy() for a in got))


# --- host side ----------------------------------------------------------------

@pytest.mark.parametrize("name,blocks,split,want", [
    ("tiny", (1, 1, 1), None, 21), ("deep", (1, 1, 6), 2, 13),
    ("deep", (1, 1, 6), None, 101), ("x152", None, 2, 77),
    ("x152", None, None, 645)])
def test_backbone_receptive_field(name, blocks, split, want):
    def cfg(m):
        if blocks is None:
            return m.VINVL_X152C4
        return _config(m, blocks)

    got = wnd.backbone_receptive_field(cfg(det_cfg), split)
    assert got == jwnd.backbone_receptive_field(cfg(jdet_cfg), split) == want


def test_window_origins_and_mask_bboxes_match_jax():
    rng = np.random.RandomState(3)
    canvas = (640, 1024)
    x1 = rng.uniform(0, 900, (60, 2, 1))
    y1 = rng.uniform(0, 560, (60, 2, 1))
    rects = np.concatenate([x1, y1, x1 + rng.uniform(5, 300, (60, 2, 1)),
                            y1 + rng.uniform(5, 300, (60, 2, 1))], 2)
    # rects flush with each canvas edge and corner
    rects[:4] = np.asarray([[0, 0, 40, 30], [980, 600, 1023, 639],
                            [500, 0, 530, 20], [0, 300, 25, 340]])[:, None]
    rects = rects.astype(np.float32)
    for window in wnd.WINDOW_LADDER + ((640, 1024), (704, 1024)):
        for halo in (0, 96, 160):
            got = wnd.window_origins(rects, window, canvas, halo)
            want = jwnd.window_origins(rects, window, canvas, halo)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    flush = wnd.window_origins(rects[:4], (384, 512), canvas, 160)
    assert flush[1].all()          # the halo is waived on flush sides
    masks = np.zeros((3, 20, 30), np.uint8)
    masks[0, 5:10, 7:12] = 1
    masks[2, 0:20:3, 29] = 1
    np.testing.assert_array_equal(wnd.mask_bboxes(masks),
                                  jwnd.mask_bboxes(masks))


# --- the extractors against JAX and against their own full path --------------

@pytest.mark.parametrize("blocks,mode", [((1, 1, 1), "one_level"),
                                         ((1, 1, 6), "two_level"),
                                         ((1, 1, 6), "cascade")])
def test_windowed_extractors_match_jax(blocks, mode):
    (jfull, jgot), (full, got) = _jax_outputs(blocks, mode), _port(blocks, mode)
    assert _rel(got[0], jgot[0]) <= PARITY
    assert _rel(got[2], jgot[2]) <= PARITY
    np.testing.assert_array_equal(got[1], jgot[1])
    # each exact against its own package's full path
    for pf, pw in ((full, got), (jfull, jgot)):
        assert _rel(pw[0], pf[0]) <= EXACT
        np.testing.assert_array_equal(pw[1], pf[1])


def test_cascade_runs_windowed_blocks():
    """At this canvas the cascade's dirty windows are smaller than the
    map on both axes, so blocks 1 and 2 of the deep stage run on windows
    (k_max ≥ 1, and each window leaves its slice start free to move)."""
    cfg = _case((1, 1, 6))[0]
    h16, w16 = CANVAS[0] // 16, CANVAS[1] // 16
    d0h, d0w = WINDOW[0] // 16 + 3, WINDOW[1] // 16 + 3
    k_max = min((h16 - d0h - 2) // 2, (w16 - d0w - 2) // 2,
                cfg.backbone.stage_blocks[2] - 1, 16)
    assert k_max == 2
    assert d0h + 2 * k_max + 2 < h16 and d0w + 2 * k_max + 2 < w16


def test_one_level_drifts_more_than_two_level():
    """At a halo below 2·RF of the whole deep body, one level is
    approximate and two levels stay exact, in the port as in JAX."""
    cfg, _, model, _, _, image, dets = _case((1, 1, 6))
    full, two = _port((1, 1, 6), "two_level")
    t = [torch.from_numpy(a) for a in _inputs(dets, 4)]
    img = torch.from_numpy(image)
    origins, _ = wnd.window_origins(RECTS, WINDOW, CANVAS, HALO)
    one = wnd.make_windowed_extract_fn(model, cfg, window=WINDOW, halo=HALO)(
        img, wnd.make_base_features_fn(model, cfg)(img), origins, *t[:6],
        CANVAS)
    d_one = wnd.feature_drift(full, [a.numpy() for a in one])
    d_two = wnd.feature_drift(full, two)
    assert d_one["feat_max_rel"] > max(d_two["feat_max_rel"], EXACT)


@pytest.mark.parametrize("fault", chip_smoke.WINDOW_FAULTS)
def test_named_window_faults_miss(fault):
    """Each named fault that ``chip_smoke.py`` holds the windowed request to
    breaks the two-level path's exactness here."""
    full, _ = _port((1, 1, 6), "two_level")
    with chip_smoke.window_fault(fault):
        _, got = _port((1, 1, 6), "two_level")
    assert _rel(got[0], full[0]) > 10 * EXACT


# --- the Extractor ---------------------------------------------------------------

@pytest.mark.parametrize("blocks,halo,approx,want", [
    ((1, 1, 1), 160, False, "one_level"), ((1, 1, 6), 48, False, "two_level"),
    ("x152", 160, False, "two_level"), ("x152", 64, False, None),
    ("x152", 64, True, "one_level"), ((1, 2, 1), 16, False, None),
    ((1, 2, 1), 16, True, "one_level")])
def test_extractor_mode_selection_matches_jax(blocks, halo, approx, want):
    if blocks == "x152":
        cfg, jcfg = det_cfg.VINVL_X152C4, jdet_cfg.VINVL_X152C4
        with torch.device("meta"):
            model = AttrRCNN(cfg)
    else:
        cfg, jcfg = _config(det_cfg, blocks), _config(jdet_cfg, blocks)
        model = AttrRCNN(cfg)
    got = Extractor(model, cfg, windowed=True, halo=halo,
                    allow_approximate=approx)
    ref = jextract.Extractor(JaxRCNN(jcfg), None, jcfg, windowed=True,
                             halo=halo, allow_approximate=approx)
    assert got.windowed_mode == ref.windowed_mode == want
    assert got.windowed == ref.windowed == (want is not None)
    assert got._windowed_approx == ref._windowed_approx


def _ladder_task(image, dets):
    # one copy for each rung of the ladder, one flush with the top-left
    # corner, and one too large for any rung (the full path)
    rects = np.asarray([[100, 96, 112, 108], [90, 88, 122, 124],
                        [80, 72, 140, 128], [1, 1, 20, 20],
                        [10, 10, 230, 200]], np.float32)
    task = refcoco_task("q0", image, CANVAS, dets, "the thing")
    return dataclasses.replace(task, copy_rects=rects[:, None],
                               copy_rect_valid=np.ones((5, 1), bool),
                               copy_colors_rgba=task.copy_colors_rgba[:1].repeat(5, 0),
                               copy_color_names=[["red"]] * 5)


def test_extractor_ladder_routing_is_exact():
    cfg, _, model, _, _, image, dets = _case((1, 1, 6))
    task = _ladder_task(image, dets)
    full = Extractor(model, cfg, copies_per_chunk=2).extract_task(task)
    ex = Extractor(model, cfg, copies_per_chunk=2, windowed=True,
                   window=[(128, 144), (96, 112), (112, 128)], halo=HALO)
    assert ex.windowed_mode == "two_level"
    assert ex.windows == [(96, 112), (112, 128), (128, 144)]
    got = ex.extract_task(task)
    assert ex.route_copies == {"96x112": 2, "112x128": 1, "128x144": 1,
                               "full": 1}
    assert _rel(got[0], full[0]) <= EXACT
    np.testing.assert_array_equal(got[1], full[1])


def test_base_maps_batched_equals_per_task():
    cfg, _, model, _, _, image, dets = _case((1, 1, 6))
    rng = np.random.RandomState(5)
    tasks = [refcoco_task(f"q{i}", rng.randint(0, 256, CANVAS + (3,))
                          .astype(np.uint8), CANVAS, dets[:3], "c")
             for i in range(3)]
    ex = Extractor(model, cfg, copies_per_chunk=2, windowed=True,
                   window=WINDOW, halo=HALO)
    batched = ex.base_maps(tasks)
    for task, base in zip(tasks, batched):
        solo = ex.base_fn(torch.from_numpy(task.image_rgb))
        assert base.shape == solo.shape
        assert _rel(base, solo) <= 1e-6
        got = ex.extract_task(task, base=base)
        want = ex.extract_task(task)
        assert _rel(got[0], want[0]) <= 1e-6
    plain = Extractor(model, cfg, copies_per_chunk=2)
    assert plain.base_maps(tasks) == [None, None, None]


def _tsv_rows(path):
    tsv = TSVFile(str(path))
    rows = [tsv.seek(i) for i in range(len(tsv))]
    tsv.close()
    return rows


def test_run_base_batch_writes_identical_tsvs(tmp_path):
    cfg, _, model, _, _, image, dets = _case((1, 1, 6))

    def tasks():
        rng = np.random.RandomState(6)
        return [refcoco_task(f"q{i}", rng.randint(0, 256, CANVAS + (3,))
                             .astype(np.uint8), CANVAS, dets[:3],
                             f"query {i}") for i in range(9)]

    ex = Extractor(model, cfg, copies_per_chunk=4, windowed=True,
                   window=WINDOW, halo=HALO)
    calls = []
    real = ex.base_maps
    ex.base_maps = lambda ts: calls.append(len(ts)) or real(ts)
    ex.run(tasks(), str(tmp_path / "b8.tsv"), base_batch=8)
    ex.run(tasks(), str(tmp_path / "b1.tsv"), base_batch=1)
    assert calls == [8]             # then one task alone, without base_maps
    assert (tmp_path / "b8.tsv").read_bytes() == (tmp_path / "b1.tsv").read_bytes()
    assert len(_tsv_rows(tmp_path / "b8.tsv")) == 9


def test_approximate_run_measures_its_drift(caplog):
    """Below both exact thresholds, ``allow_approximate`` runs one level
    anyway and measures the drift against the full path on its first
    windowed task only, as the JAX Extractor does."""
    cfg, _, model, _, _, image, dets = _case((1, 2, 1))
    ex = Extractor(model, cfg, copies_per_chunk=2, windowed=True,
                   window=(96, 96), halo=16, allow_approximate=True)
    assert ex._windowed_approx and not ex._drift_logged
    task = refcoco_task("q0", image, CANVAS, np.asarray(
        [[100, 100, 130, 130], [110, 90, 140, 120]], np.float32), "q")
    with caplog.at_level("WARNING"):
        first = ex.extract_task(task)
    assert ex._drift_logged and "feature_drift" in caplog.text
    assert ex.last_drift["feat_max_rel"] > EXACT
    assert 0 <= ex.last_drift["label_agreement"] <= 1
    assert ex.route_copies["96x96"] == 2
    again = ex.extract_task(task)
    np.testing.assert_array_equal(again[0], first[0])


# --- the tools end to end ---------------------------------------------------------

def _features(path):
    return [np.stack([decode_feature(b["feature"]) for copy in
                      json.loads(v)["objects"][0] for b in copy])
            for _, v in _tsv_rows(path)]


def test_extract_features_windowed_tiny(tmp_path):
    from cpt_tpu_torch.tools import extract_features as tool

    common = ["--tiny", "--synthetic", "2", "--device", "cpu", "--dtype",
              "float32", "--copies_per_chunk", "2"]
    plain = tool.main(common + ["--output", str(tmp_path / "plain.tsv")])
    got = tool.main(common + ["--windowed", "--windows", "64x64",
                              "--output", str(tmp_path / "wnd.tsv")])
    assert plain["windowed_mode"] is None
    assert got["windowed_mode"] == "one_level"
    # the synthetic query's first rect fits the 64x64 canvas-sized window,
    # the other two reach past the canvas and take the full path
    assert got["route_copies"] == {"64x64": 2, "full": 4}
    for g, w in zip(_features(tmp_path / "wnd.tsv"),
                    _features(tmp_path / "plain.tsv")):
        assert _rel(g, w) <= 1e-4


def test_cpt_predict_windowed_tiny(tmp_path):
    from PIL import Image

    from cpt_tpu_torch.tools import cpt_predict

    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, (40, 56, 3)).astype(np.uint8)).save(tmp_path / "photo.png")
    runs = {}
    for name, flags in (("plain", []), ("windowed", ["--windowed"])):
        wd = tmp_path / name
        runs[name] = cpt_predict.main(
            ["--image", str(tmp_path / "photo.png"), "--caption", "a dog",
             "--dets", "[[2, 2, 20, 30], [22, 4, 50, 36], [0, 0, 55, 39]]",
             "--tiny", "--device", "cpu", "--dtype", "float32",
             "--hidden_size", "32", "--num_hidden_layers", "2",
             "--workdir", str(wd)] + flags)
    assert runs["windowed"] == runs["plain"]
    res = cpt_predict.build_resident("cpu", torch.float32, tiny=True,
                                     hidden_size=32, num_hidden_layers=2,
                                     windowed=True)
    assert res.extractor.windowed_mode == "one_level"
    assert res.extractor.windows == list(wnd.WINDOW_LADDER)
    np.testing.assert_allclose(
        cpt_predict.candidate_scores(res, str(tmp_path / "windowed")),
        cpt_predict.candidate_scores(res, str(tmp_path / "plain")), rtol=1e-4,
        atol=1e-4)
