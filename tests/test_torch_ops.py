"""Port ops vs the JAX package on the CPU: prompt rendering (bit-exact on
uint8), K1 grouped conv and K2 RoIAlign (their plain versions, which the
CPU dispatch takes) against the Pallas kernels run in interpret mode and
against the XLA formulations. Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpt_tpu.ops.roi_align_pallas as RP
from cpt_tpu.ops import grouped_conv as jgc
from cpt_tpu.ops import render as jrender
from cpt_tpu.ops.roi_align import interp_matrices as j_interp
from cpt_tpu_torch.ops import render
from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3
from cpt_tpu_torch.ops.roi_align import interp_matrices, roi_align
from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(120)

# f32 CPU comparisons: the two frameworks sum in different orders
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _rects(rng, n, h, w):
    x1 = rng.randint(-4, w - 2, n)
    y1 = rng.randint(-4, h - 2, n)
    x2 = x1 + rng.randint(0, w // 2, n)
    y2 = y1 + rng.randint(0, h // 2, n)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32) + 0.6


@pytest.mark.parametrize("inclusive", [False, True])
def test_paste_rects_bit_exact(inclusive):
    rng = np.random.RandomState(0)
    h, w, c, k = 24, 40, 5, 3
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    rects = _rects(rng, c * k, h, w).reshape(c, k, 4)
    colors = rng.randint(0, 256, (c, k, 4)).astype(np.uint8)
    valid = rng.rand(c, k) > 0.3
    want = np.stack([np.asarray(jrender.paste_rects(
        jnp.asarray(img), jnp.asarray(rects[i]), jnp.asarray(colors[i]),
        jnp.asarray(valid[i]), inclusive=inclusive)) for i in range(c)])
    got = render.paste_rects(torch.from_numpy(img), torch.from_numpy(rects),
                             torch.from_numpy(colors), torch.from_numpy(valid),
                             inclusive=inclusive)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paste_mask_and_composite_bit_exact():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (3, 16, 20, 3)).astype(np.uint8)
    mask = (rng.rand(3, 16, 20) > 0.5).astype(np.uint8)
    colors = rng.randint(0, 256, (3, 4)).astype(np.uint8)
    want = np.stack([np.asarray(jrender.paste_mask(
        jnp.asarray(img[i]), jnp.asarray(mask[i]), jnp.asarray(colors[i])))
        for i in range(3)])
    got = render.paste_mask(torch.from_numpy(img), torch.from_numpy(mask),
                            torch.from_numpy(colors))
    np.testing.assert_array_equal(got.numpy(), want)
    alpha = rng.randint(0, 256, (16, 20))
    want = jrender.alpha_composite_u8(jnp.asarray(img[0]), (10, 200, 30),
                                      jnp.asarray(alpha))
    got = render.alpha_composite_u8(torch.from_numpy(img[0]), (10, 200, 30),
                                    torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_to_detector_input_matches():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8)
    mean = (103.530, 116.280, 123.675)
    want = jrender.to_detector_input(jnp.asarray(img), mean)
    got = render.to_detector_input(torch.from_numpy(img), mean)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _conv_inputs(n, h, w, ch, g, seed):
    rng = np.random.RandomState(seed)
    cpg = ch // g
    return (rng.randn(n, h, w, ch).astype(np.float32),
            (rng.randn(3, 3, cpg, ch) * 0.1).astype(np.float32),
            (rng.rand(ch) + 0.5).astype(np.float32),
            rng.randn(ch).astype(np.float32))


def _port_conv(x, w, s, b, g, stride, relu=True):
    return grouped_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(s), torch.from_numpy(b), g, stride,
                           relu).numpy()


@pytest.mark.parametrize("cpg", [8, 16, 32])
def test_grouped_conv_matches_sd_kernel(cpg):
    """K1 (stride 1) vs the slice-dense Pallas kernel in interpret mode."""
    x, w, s, b = _conv_inputs(2, 8, 8, 128, 128 // cpg, seed=cpg)
    want = run_interpret(lambda *a: jgc.grouped_conv3x3_sd(*a, 128 // cpg, True),
                         x, w, s, b)
    np.testing.assert_allclose(_port_conv(x, w, s, b, 128 // cpg, 1),
                               want, **F32_TOL)


@pytest.mark.parametrize("h,w,ch,g", [(9, 12, 64, 8), (16, 16, 32, 4)])
def test_grouped_conv_stride2_matches_kernel(h, w, ch, g):
    """K1 at stride 2 (the first block of a stage) vs the im2col Pallas
    kernel in interpret mode and the XLA reference."""
    x, wt, s, b = _conv_inputs(1, h, w, ch, g, seed=h)
    args = (jnp.asarray(x), jnp.asarray(wt), jnp.asarray(s), jnp.asarray(b))
    want = run_interpret(lambda *a: jgc.grouped_conv3x3(*a, g, 2, True), *args)
    ref = jgc.reference_grouped_conv3x3(*args, g, 2, True)
    got = _port_conv(x, wt, s, b, g, 2)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


def test_grouped_conv_without_affine():
    x, w, _, _ = _conv_inputs(1, 6, 7, 16, 2, seed=3)
    ref = jgc.reference_grouped_conv3x3(jnp.asarray(x), jnp.asarray(w), None,
                                        None, 2, 1, False)
    got = grouped_conv3x3(torch.from_numpy(x), torch.from_numpy(w), groups=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def _rois(rng, n, lim):
    r = np.sort(rng.uniform(-20, lim, (n, 2, 2)), axis=1)
    rois = r.transpose(0, 2, 1).reshape(n, 4).astype(np.float32)
    rois[0] = [0.0, 0.0, lim * 1.5, lim * 1.2]   # large: hits the 8-sample cap
    return rois


@pytest.mark.parametrize("sampling", [0, 2])
def test_interp_matrices_match(sampling):
    rng = np.random.RandomState(4)
    rois = _rois(rng, 6, 300.0)
    want = j_interp(jnp.asarray(rois), 20, 24, spatial_scale=1 / 16.0,
                    pooled=7, sampling=sampling)
    got = interp_matrices(torch.from_numpy(rois), 20, 24,
                          spatial_scale=1 / 16.0, pooled=7, sampling=sampling)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_batched_roi_align_matches_pallas_and_xla(monkeypatch):
    """K2 vs the Pallas pooling kernel (interpret mode) and the XLA path.
    The Pallas kernel tiles channels by 256 and RoIs by 8."""
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 12, 20, 256).astype(np.float32)
    rois = _rois(rng, 8, 300.0)
    got = batched_roi_align(torch.from_numpy(feats), torch.from_numpy(rois),
                            1 / 16.0, 7, 0, 8).numpy()
    xla = RP.batched_roi_align(jnp.asarray(feats), jnp.asarray(rois),
                               1 / 16.0, 7, 0, 8, "xla")
    monkeypatch.setattr(RP, "_INTERPRET", True)
    pallas = RP.batched_roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                  1 / 16.0, 7, 0, 8, "pallas")
    assert got.shape == (2, 8, 7, 7, 256)
    np.testing.assert_allclose(got, np.asarray(xla), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)


def test_roi_align_single_map_bf16_matches_xla():
    """bf16 on the CPU: the same rounding of the intermediate as the JAX
    path; tolerance two bf16 ulps of the output scale."""
    from cpt_tpu.ops.roi_align import roi_align as j_roi_align

    rng = np.random.RandomState(6)
    feats = rng.randn(10, 14, 16).astype(np.float32)
    rois = _rois(rng, 5, 200.0)
    want = np.asarray(j_roi_align(jnp.asarray(feats, jnp.bfloat16),
                                  jnp.asarray(rois), spatial_scale=1 / 16.0,
                                  pooled=4, sampling=0), np.float32)
    got = roi_align(torch.from_numpy(feats).bfloat16(), torch.from_numpy(rois),
                    spatial_scale=1 / 16.0, pooled=4, sampling=0).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 * 2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("h,w,c,groups,stride", [
    (10, 12, 64, 8, 1), (10, 12, 64, 8, 2), (9, 7, 128, 4, 2),
    (6, 8, 128, 2, 1)])
def test_grouped_conv_named_faults_miss(h, w, c, groups, stride):
    """The faults ``chip_smoke.py`` holds K1 to (neighbouring group, taps
    transposed, bias dropped, at stride 2 the grid one pixel off), on
    inputs drawn as it draws them, each miss the plain version by more
    than K1's tolerance, so a kernel with that slip would fail the check."""
    import chip_smoke

    rng = np.random.RandomState(h + c + stride)
    x = np.maximum(rng.randn(2, h, w, c), 0).astype(np.float32)
    tap_mean = np.linspace(-0.03, 0.03, 9).reshape(3, 3, 1, 1)
    wt = (rng.randn(3, 3, c // groups, c) * 0.05 + tap_mean).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32)
    b = (rng.randn(c) * 0.5).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, wt, s, b)]
    want = _port_conv(x, wt, s, b, groups, stride)
    tol = chip_smoke.TOL["K1"] * np.abs(want).max()
    faults = chip_smoke.k1_faults(*args, groups, stride)
    assert sorted(faults) == sorted(["neighbour_group", "taps_transposed",
                                     "no_bias"] + ["grid_shifted"] * (stride == 2))
    for name, fault in faults.items():
        got = fault().numpy()
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() > 3 * tol, name
    if stride == 2:   # the unshifted grid is the stride-2 output itself
        full = _port_conv(x, wt, s, b, groups, 1)
        np.testing.assert_allclose(full[:, ::2, ::2], want, **F32_TOL)


@pytest.mark.parametrize("key,groups,family", [
    ("void (anonymous namespace)::flash_attention_kernel<64>(cpt::mma_attn::Args)",
     "REQUEST_GROUPS", "K6"),
    ("void (anonymous namespace)::attention_kernel<64>(cpt::mma_attn::Args)",
     "REQUEST_GROUPS", "K3 / K4"),
    ("void (anonymous namespace)::gemm_bias_act_kernel<1>(...)", "REQUEST_GROUPS",
     "K3 / K4"),
    ("void (anonymous namespace)::gemm_residual_ln_kernel(...)", "REQUEST_GROUPS",
     "K3 / K4"),
    ("void (anonymous namespace)::grouped_conv3x3_mma_kernel<2>(...)",
     "REQUEST_GROUPS", "K1"),
    ("void (anonymous namespace)::roi_align_kernel(...)", "REQUEST_GROUPS", "K2"),
    ("void (anonymous namespace)::nms_kernel(...)", "REQUEST_GROUPS", "K5"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<64>((anonymous namespace)::BwdArgs)",
     "KERNEL_GROUPS", "K6b"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<64>((anonymous namespace)::BwdArgs)",
     "KERNEL_GROUPS", "K6c"),
    ("void (anonymous namespace)::flash_attention_kernel<64>(cpt::mma_attn::Args)",
     "KERNEL_GROUPS", "K6"),
    ("void (anonymous namespace)::grouped_conv3x3_int8_kernel<1>(...)",
     "EXTRACT_GROUPS", "K1q"),
    ("void (anonymous namespace)::grouped_conv3x3_mma_kernel<2>(...)",
     "EXTRACT_GROUPS", "K1"),
])
def test_profile_families_classify_port_kernels(key, groups, family):
    """``chip_smoke.device_groups`` sums each device kernel into the first
    family one of whose patterns its name holds: each of the port's
    kernels lands in its own family (K6's ``flash_attention_kernel`` is
    not K3's ``attention_kernel``)."""
    import chip_smoke

    assert chip_smoke.kernel_group(key, getattr(chip_smoke, groups)) == family

