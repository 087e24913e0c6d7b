"""The detector library modules, port vs JAX package, on the CPU in f32:
focal loss, RoIPool, the FPN (a pyramid that is not an exact ×2, on an
800×1333 canvas), multi-level RoI pooling, the mask / keypoint / RetinaNet
heads (``ConvTranspose`` at odd inputs, ``paste_masks`` across the canvas
edge, ``retinanet_select`` with tied scores and class offsets), deformable
conv and RoI pooling with offsets and a mask, FBNet and MsViT (with
globals, with ``rpe``).

Each flax module is initialised by flax, every leaf then moved by seeded
noise (so that zero-initialised biases and offset convs take part), and the
tree carried into the port by ``models/detector/convert.
module_params_from_jax``. Inputs are drawn from a seed with numpy.

Tolerances, as max |Δ| over max |reference|: ``TOL`` 1e-5 for a module's
float outputs (the two packages sum in other orders in f32; the largest gap
seen at these sizes is under 2e-6); index outputs (top-k, NMS, argmax,
level maps, anchors, RetinaNet's picks through the K5 wrapper) and
thresholded masks must match exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.models.detector import extra_heads as jeh
from cpt_tpu.models.detector import fbnet as jfb
from cpt_tpu.models.detector import fpn as jfpn
from cpt_tpu.models.detector import msvit as jvit
from cpt_tpu.models.detector.config import tiny_detector_config as jtiny
from cpt_tpu.ops import deform_conv as jdc
from cpt_tpu.ops import focal_loss as jfl
from cpt_tpu.ops import roi_pool as jrp
from cpt_tpu_torch.models.detector import extra_heads as eh
from cpt_tpu_torch.models.detector import fbnet as fb
from cpt_tpu_torch.models.detector import fpn
from cpt_tpu_torch.models.detector import msvit as vit
from cpt_tpu_torch.models.detector.config import tiny_detector_config
from cpt_tpu_torch.models.detector.convert import module_params_from_jax
from cpt_tpu_torch.ops import deform_conv as dc
from cpt_tpu_torch.ops import focal_loss as fl
from cpt_tpu_torch.ops import roi_pool as rp
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

TOL = 1e-5


def gap(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def jax_init(model, *args, seed: int = 0, noise: float = 0.05):
    """flax's init, then every leaf moved by N(0, noise²) from ``seed``."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), *args)
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32)
        + rng.normal(0, noise, np.shape(v)).astype(np.float32), params)


def japply(model, params, *args):
    """The flax module's forward as one jitted call (eager JAX compiles
    every op on its own and is several times slower here)."""
    return jax.jit(model.apply)(params, *args)


def ported(model, params):
    model.load_state_dict(module_params_from_jax(params, model))
    return model.eval()


# --- ops ----------------------------------------------------------------------

def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (40, 7)).astype(np.float32)
    targets = rng.randint(-1, 8, 40).astype(np.int32)
    want = jfl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = fl.sigmoid_focal_loss(t(logits), t(targets))
    assert gap(got, want) <= TOL


def test_roi_pool_matches_jax():
    """Corners on half-integers after scaling (round half to even), RoIs
    past the map's edge and an empty bin."""
    rng = np.random.RandomState(1)
    feats = rng.normal(size=(20, 24, 5)).astype(np.float32)
    rois = np.array([[2, 2, 30, 40], [1, 3, 5, 7], [-20, -8, 60, 90],
                     [80, 70, 120, 100], [10, 6, 11, 7], [0, 0, 95, 79]],
                    np.float32)
    want = jrp.roi_pool(jnp.asarray(feats), jnp.asarray(rois),
                        spatial_scale=0.25, pooled=4)
    got = rp.roi_pool(t(feats), t(rois), spatial_scale=0.25, pooled=4)
    assert gap(got, want) == 0.0


# --- FPN ------------------------------------------------------------------------

def fpn_backbone_cfg(cfg):
    import dataclasses

    return dataclasses.replace(cfg.backbone, stage_blocks=(1, 1, 1, 1))


@functools.lru_cache(maxsize=None)
def fpn_run():
    """The tiny ResNetFPN (4 stages) on one 800×1333 canvas: C3 is 167
    wide, C4 84, C5 42 (so every top-down upsample is a non-×2 resize);
    JAX's pyramid, its params, the image."""
    model = jfpn.ResNetFPN(fpn_backbone_cfg(jtiny()), out_channels=16)
    x = np.random.RandomState(2).normal(size=(1, 800, 1333, 3)).astype(np.float32)
    params = jax_init(model, jnp.zeros((1, 64, 64, 3)))
    pyramid = jax.jit(model.apply)(params, jnp.asarray(x))
    return [np.asarray(p) for p in pyramid], params, x


def test_fpn_matches_jax_at_a_non_x2_pyramid():
    want, params, x = fpn_run()
    assert [p.shape[2] for p in want] == [334, 167, 84, 42, 21]
    model = ported(fpn.ResNetFPN(fpn_backbone_cfg(tiny_detector_config()), 16),
                   params)
    with torch.no_grad():
        got = model(t(x))
    for g, w in zip(got, want):
        assert gap(g, w) <= TOL


def test_fpn_top_down_alone_matches_jax():
    """FPNTopDown on odd, non-×2 C2..C5 sizes (13×17 → 7×9 → 4×5 → 2×3),
    with and without P6."""
    rng = np.random.RandomState(3)
    sizes = [(13, 17), (7, 9), (4, 5), (2, 3)]
    widths = [6, 8, 10, 12]
    feats = [rng.normal(size=(2, h, w, c)).astype(np.float32)
             for (h, w), c in zip(sizes, widths)]
    for with_p6 in (True,):
        model = jfpn.FPNTopDown(8, with_p6=with_p6)
        params = jax_init(model, [jnp.asarray(f) for f in feats])
        want = japply(model, params, [jnp.asarray(f) for f in feats])
        port = ported(fpn.FPNTopDown(widths, 8, with_p6), params)
        with torch.no_grad():
            got = port([t(f) for f in feats])
        assert len(got) == len(want) == 4 + with_p6
        for g, w in zip(got, want):
            assert gap(g, w) <= TOL


def test_fpn_level_map_matches_jax():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 600, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 900, (64, 2))], 1).astype(
        np.float32)
    boxes[:3] = [[0, 0, 55, 55], [0, 0, 223, 223], [10, 10, 10, 10]]
    for k_max in (4, 5):
        want = jfpn.fpn_level_map(jnp.asarray(boxes), k_min=2, k_max=k_max)
        got = fpn.fpn_level_map(t(boxes), k_min=2, k_max=k_max)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_multilevel_roi_align_matches_jax():
    """1000/16 RoIs of every size over the 800×1333 pyramid's four levels,
    pooled 7², sampling 2, on K2's plain version here."""
    pyramid, _, _ = fpn_run()
    rng = np.random.RandomState(5)
    xy = rng.uniform(-50, 1200, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 700, (64, 2))], 1).astype(
        np.float32)
    scales = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
    levels = [p[0] for p in pyramid[:4]]
    want = jfpn.multilevel_roi_align([jnp.asarray(p) for p in levels],
                                     jnp.asarray(boxes), scales=scales)
    got = fpn.multilevel_roi_align([t(p) for p in levels], t(boxes),
                                   scales=scales)
    assert len(set(fpn.fpn_level_map(t(boxes), k_max=5).tolist())) == 4
    assert gap(got, want) <= TOL


# --- the mask and keypoint heads -------------------------------------------------

@pytest.mark.parametrize("kernel,stride", [(2, 2), (4, 2), (3, 1)])
def test_conv_transpose_matches_flax_at_an_odd_input(kernel, stride):
    import flax.linen as fnn

    x = np.random.RandomState(6).normal(size=(2, 5, 7, 3)).astype(np.float32)
    model = fnn.ConvTranspose(4, (kernel, kernel), strides=(stride, stride))
    params = jax_init(model, jnp.asarray(x))
    want = japply(model, params, jnp.asarray(x))
    assert want.shape[1:3] == (5 * stride, 7 * stride)
    port = torch.nn.Module()
    port.ct = eh.ConvTranspose(3, 4, kernel, stride)
    port = ported(port, {"ct": params["params"]}).ct
    with torch.no_grad():
        got = port(t(x))
    assert gap(got, want) <= TOL


@pytest.mark.parametrize("conv_layers", [(), (12, 12)])
def test_mask_head_and_losses_match_jax(conv_layers):
    """C4 and FPN flavours on 7×7 pooled features (odd), then mask_loss,
    select_class_masks."""
    rng = np.random.RandomState(7)
    x = rng.normal(size=(5, 7, 7, 10)).astype(np.float32)
    model = jeh.MaskHead(num_classes=4, conv_layers=conv_layers, dim_reduced=8)
    params = jax_init(model, jnp.asarray(x))
    want = np.asarray(japply(model, params, jnp.asarray(x)))
    port = ported(eh.MaskHead(10, 4, conv_layers, 8), params)
    with torch.no_grad():
        got = port(t(x))
    assert want.shape == (5, 14, 14, 4) and gap(got, want) <= TOL
    gt = (rng.uniform(size=(5, 14, 14)) > 0.5).astype(np.float32)
    labels = np.array([0, 1, 3, 2, 5], np.int32)
    valid = np.array([True, True, True, False, True])
    want_loss = jeh.mask_loss(jnp.asarray(want), jnp.asarray(gt),
                              jnp.asarray(labels), jnp.asarray(valid))
    got_loss = eh.mask_loss(t(want), t(gt), t(labels), t(valid))
    assert gap(got_loss, want_loss) <= TOL
    assert gap(eh.select_class_masks(t(want), t(labels)),
               jeh.select_class_masks(jnp.asarray(want), jnp.asarray(labels))
               ) <= TOL


def test_paste_masks_matches_jax_across_the_canvas_edge():
    """Boxes inside, across every edge, past a corner, degenerate; the
    binary maps must match exactly."""
    rng = np.random.RandomState(8)
    masks = rng.uniform(size=(7, 14, 14)).astype(np.float32)
    boxes = np.array([[10, 12, 40, 30], [-15, 5, 20, 25], [50, -9, 70, 20],
                      [45, 30, 90, 70], [-30, -30, 100, 90], [20, 20, 20.5, 21],
                      [3.7, 8.2, 33.1, 51.9]], np.float32)
    want = np.asarray(jax.jit(jeh.paste_masks, static_argnums=(2, 3))(
        jnp.asarray(masks), jnp.asarray(boxes), 48, 64))
    got = eh.paste_masks(t(masks), t(boxes), 48, 64)
    assert want.any() and np.array_equal(got.numpy(), want)


def test_keypoint_head_and_decode_match_jax():
    """A 9×9 input (odd) through the k4 s2 deconv and the ×2 bilinear, then
    the argmax decode, with a tied maximum."""
    rng = np.random.RandomState(9)
    x = rng.normal(size=(3, 9, 9, 6)).astype(np.float32)
    model = jeh.KeypointHead(num_keypoints=5, conv_layers=(8, 8))
    params = jax_init(model, jnp.asarray(x))
    want = np.asarray(japply(model, params, jnp.asarray(x)))
    port = ported(eh.KeypointHead(6, 5, (8, 8)), params)
    with torch.no_grad():
        got = port(t(x)).numpy()
    assert want.shape == (3, 36, 36, 5) and gap(got, want) <= TOL
    heat = np.round(want * 4) / 4                 # ties in every map
    rois = np.array([[10, 20, 50, 70], [0, 0, 3, 2], [5, 5, 300, 200]],
                    np.float32)
    wxy, ws = jeh.heatmaps_to_keypoints(jnp.asarray(heat), jnp.asarray(rois))
    gxy, gs = eh.heatmaps_to_keypoints(t(heat), t(rois))
    assert np.array_equal(gxy.numpy(), np.asarray(wxy))
    assert np.array_equal(gs.numpy(), np.asarray(ws))


# --- RetinaNet -------------------------------------------------------------------

RETINA_SHAPES = [(8, 10), (4, 5), (2, 3)]
RETINA_STRIDES = [8, 16, 32]


def test_retinanet_anchors_match_jax():
    want = jeh.retinanet_grid_anchors(RETINA_SHAPES, RETINA_STRIDES)
    got = eh.retinanet_grid_anchors(RETINA_SHAPES, RETINA_STRIDES)
    assert np.array_equal(got, want)


@functools.lru_cache(maxsize=None)
def retina_run():
    rng = np.random.RandomState(10)
    feats = [rng.normal(size=(1, h, w, 8)).astype(np.float32)
             for h, w in RETINA_SHAPES]
    model = jeh.RetinaNetHead(num_classes=3, num_anchors=9, num_convs=2)
    params = jax_init(model, [jnp.asarray(f) for f in feats])
    logits, deltas = japply(model, params, [jnp.asarray(f) for f in feats])
    return (feats, params, [np.asarray(v) for v in logits],
            [np.asarray(v) for v in deltas])


def test_retinanet_head_and_loss_match_jax():
    feats, params, logits, deltas = retina_run()
    port = ported(eh.RetinaNetHead(3, 9, 2, in_channels=8), params)
    with torch.no_grad():
        got_l, got_d = port([t(f) for f in feats])
    for g, w in zip(got_l + got_d, logits + deltas):
        assert gap(g, w) <= TOL
    anchors = eh.retinanet_grid_anchors(RETINA_SHAPES, RETINA_STRIDES)
    gt = np.array([[10, 12, 60, 50], [30, 5, 70, 40], [0, 0, 1, 1]], np.float32)
    labels = np.array([1, 3, 2], np.int32)
    valid = np.array([True, True, False])
    want = jax.jit(functools.partial(jeh.retinanet_loss, num_classes=3))(
        [jnp.asarray(v) for v in logits], [jnp.asarray(v) for v in deltas],
        jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(valid))
    got = eh.retinanet_loss([t(v) for v in logits], [t(v) for v in deltas],
                            t(anchors), t(gt), t(labels), t(valid),
                            num_classes=3)
    for k in want:
        assert gap(got[k], want[k]) <= TOL


def test_retinanet_select_matches_jax_with_ties_and_class_offsets():
    """Scores rounded to a coarse grid (many ties, so the top-k order among
    them decides which candidates reach the NMS) and boxes of three classes
    that overlap across classes (the class offset keeps them apart): boxes,
    scores, labels and keep equal to JAX's exactly."""
    _, _, logits, deltas = retina_run()
    logits = [np.round(v * 2) / 2 for v in logits]
    deltas = [v * 3 for v in deltas]
    per_level = [eh.retinanet_grid_anchors([s], [st])
                 for s, st in zip(RETINA_SHAPES, RETINA_STRIDES)]
    kw = dict(num_classes=3, image_size=(64, 80), pre_nms_top_n=60,
              score_thresh=0.3, nms_thresh=0.4, max_det=100)
    want = jax.jit(functools.partial(jeh.retinanet_select, **kw))(
        [jnp.asarray(v) for v in logits], [jnp.asarray(v) for v in deltas],
        [jnp.asarray(a) for a in per_level])
    got = eh.retinanet_select([t(v) for v in logits], [t(v) for v in deltas],
                              [t(a) for a in per_level], **kw)
    # the decoded boxes' exp and products round differently under XLA (1
    # ulp); the picks, their scores, labels and keep flags are exact
    assert gap(got[0], want[0]) <= TOL
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    keep = np.asarray(want[3])
    assert 3 < keep.sum() < 100
    assert len(set(np.asarray(want[2])[keep].tolist())) == 3


# --- deformable conv and RoI pooling ----------------------------------------------

@pytest.mark.parametrize("stride,dilation,groups,modulated", [
    (1, 1, 1, True), (2, 1, 1, False), (1, 2, 2, True)])
def test_dfconv_matches_jax_with_offsets_and_mask(stride, dilation, groups,
                                                  modulated):
    """DFConv2d with its offset conv moved off zero (offsets of a pixel or
    so, some past the map's edge), v2's sigmoid mask, a bias."""
    x = np.random.RandomState(11).normal(size=(2, 9, 11, 4)).astype(np.float32)
    model = jdc.DFConv2d(features=6, stride=stride, dilation=dilation,
                         deformable_groups=groups,
                         with_modulated_dcn=modulated, use_bias=True)
    params = jax_init(model, jnp.asarray(x), noise=0.2)
    want = japply(model, params, jnp.asarray(x))
    port = ported(dc.DFConv2d(4, 6, 3, stride, dilation, groups, modulated,
                              True), params)
    with torch.no_grad():
        got = port(t(x))
    assert gap(got, want) <= TOL


def test_deform_roi_pool_and_pack_match_jax():
    rng = np.random.RandomState(12)
    feats = rng.normal(size=(16, 20, 3)).astype(np.float32)
    rois = np.array([[4, 4, 40, 52], [-10, 8, 30, 90], [50, 30, 79, 63]],
                    np.float32)
    offsets = rng.normal(0, 1, (3, 3, 3, 2)).astype(np.float32)
    for off in (None, offsets):
        want = jdc.deform_roi_pool(jnp.asarray(feats), jnp.asarray(rois),
                                   None if off is None else jnp.asarray(off),
                                   spatial_scale=0.25, out_size=3)
        got = dc.deform_roi_pool(t(feats), t(rois),
                                 None if off is None else t(off),
                                 spatial_scale=0.25, out_size=3)
        assert gap(got, want) <= TOL
    model = jdc.ModulatedDeformRoIPoolingPack(out_size=3, spatial_scale=0.25,
                                              deform_fc_channels=16)
    params = jax_init(model, jnp.asarray(feats), jnp.asarray(rois), noise=0.3)
    want = japply(model, params, jnp.asarray(feats), jnp.asarray(rois))
    port = ported(dc.ModulatedDeformRoIPoolingPack(3, 3, 0.25,
                                                   deform_fc_channels=16),
                  params)
    with torch.no_grad():
        got = port(t(feats), t(rois))
    assert gap(got, want) <= TOL


# --- FBNet ------------------------------------------------------------------------

FBNET_ARCH = {"block_op_type": [["ir_k5_e3_se", "skip"], ["ir_k3_s4", "skip"]],
              "block_cfg": {"first": [8, 2],
                            "stages": [[[1, 8, 1, 1], [1, 12, 1, 2]],
                                       [[4, 16, 1, 1], [1, 16, 1, 1]]]}}


@pytest.mark.parametrize("arch", ["default", "custom"])
def test_fbnet_trunk_matches_jax(arch):
    """The default trunk, and one with squeeze-excite, the channel shuffle
    (grouped 1×1s) and skips (a strided 1×1 and an identity)."""
    a = None if arch == "default" else FBNET_ARCH
    x = np.random.RandomState(13).normal(size=(2, 33, 30, 3)).astype(np.float32)
    model = jfb.FBNetTrunk(arch=a)
    params = jax_init(model, jnp.asarray(x))
    want = japply(model, params, jnp.asarray(x))
    port = ported(fb.FBNetTrunk(a), params)
    with torch.no_grad():
        got = port(t(x))
    assert gap(got, want) <= TOL


def test_fbnet_parse_op_matches_jax():
    for op in ("ir_k3", "ir_k5_e1", "ir_k3_s4", "ir_k5_e6_se", "ir_k3_s4_se",
               "skip"):
        assert fb.parse_op(op, 6) == jfb.parse_op(op, 6)
    with pytest.raises(ValueError, match="unknown FBNet op"):
        fb.parse_op("conv3", 6)


# --- MsViT ------------------------------------------------------------------------

@pytest.mark.parametrize("arch,window,rpe", [
    ("l1,h2,d16,n1,s1,g1,p4,f4,a1_l2,h2,d32,n1,s0,g0,p2", 4, False),
    ("l1,h2,d16,n2,s1,g2,p4,f3,a0_l2,h2,d24,n1,s1,g1,p2", 3, True),
    ("l1,h2,d16,n1,s1,g0,p4,f3,a0", 3, True)])
def test_msvit_matches_jax(arch, window, rpe):
    """Grids that do not fill whole chunks (9×11 tokens in windows of 3 or
    4, padded keys masked), global tokens (1 and 2) and none, the relative
    position biases, an absolute position embedding, a full-attention
    stage."""
    x = np.random.RandomState(14).normal(size=(2, 36, 44, 3)).astype(np.float32)
    model = jvit.MsViT(arch=arch, window=window, rpe=rpe)
    params = jax_init(model, jnp.asarray(x))
    want = japply(model, params, jnp.asarray(x))
    port = ported(vit.MsViT(arch, window, rpe, image_hw=(36, 44)), params)
    with torch.no_grad():
        got = port(t(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert gap(g, w) <= TOL


def test_msvit_pieces_match_jax():
    assert vit.parse_arch("l1,h3,d96,n2,s1,g1,p4,f7,a1_l2,h6,d192") == \
        jvit.parse_arch("l1,h3,d96,n2,s1,g1,p4,f7,a1_l2,h6,d192")
    for w in (2, 3, 7):
        assert np.array_equal(vit.relative_position_index(w),
                              jvit.relative_position_index(w))
    rng = np.random.RandomState(15)
    q, k, v = (rng.normal(size=(2, 3, 5 * 7, 4)).astype(np.float32)
               for _ in range(3))
    want = jvit.sliding_chunk_attention_2d(*(jnp.asarray(a) for a in (q, k, v)),
                                           5, 7, 3)
    got = vit.sliding_chunk_attention_2d(t(q), t(k), t(v), 5, 7, 3)
    assert gap(got, want) <= TOL


def test_phase18_dry_run():
    """``chip_smoke.run_library_modules`` at narrow widths on the CPU: every
    path runs and every reading is taken; what fails is only what needs
    the card (the kernel launches of the FPN body, the pooling and the
    RetinaNet merge)."""
    import ast

    import chip_smoke as cs

    with pytest.raises(AssertionError) as e:
        cs.run_library_modules(cs.kernel_counters(), "cpu", [],
                               torch.device("cpu"), tiny=True)
    failures = ast.literal_eval(e.value.args[0][len("phase 18: "):])
    assert failures and all("launches" in f for f in failures), failures
    assert {f.split()[0] for f in failures} == {"fpn", "pool", "retina"}
