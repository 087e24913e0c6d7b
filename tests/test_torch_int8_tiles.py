"""K1q's and K7's designs held against the JAX package on the CPU.

K1q (``csrc/grouped_conv.cu``, the int8 tensor-core implicit GEMM) packs
the reduction of a grouped 3×3 into k32 steps of ``mma.sync`` m16n8k32
(k = tap · cpg + ci: half a tap at cpg 64, one at 32, two at 16, four at 8,
whose tail 72 → 96 is zero weights against repeated tap-8 reads) and
stages a stride-2 patch with its even columns before its odd ones. A plain
model of that addressing, byte for byte as the kernel's lanes compute it,
equals ``exact_conv`` and the JAX package's ``int8_conv`` bit for bit, and
the named faults of ``chip_smoke.K1Q_FAULTS`` miss the card's tolerance.

K7 (``csrc/ffn_int8.cu``) reduces max |h| of each [tm, F] tile over the 128
× 128 blocks that write it (an atomicMax on the f32's bits): a model of that
combination and of h's quantization equals ``ffn_int8_hidden`` +
``_tile_quant`` bit for bit, and a block-local maximum does not. Each of
``chip_smoke.K7_FAULTS`` misses 1e-2 of scale at ``chip_smoke.K7_FAULT_SHAPE``,
the shape ``tests/test_torch_gpu.py`` holds the kernel to; and the plain
version agrees with ``bench_int8.py``'s Pallas kernel in interpret mode."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from cpt_tpu.ops import quant as jquant
from cpt_tpu_torch.ops import quant
from cpt_tpu_torch.ops.grouped_conv import (exact_conv,
                                            reference_grouped_conv3x3_int8)
from test_torch_quant import _study
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(120)

SLICE, PIXEL = 64, 80      # K1q's channels a block, patch bytes a pixel


def k1q_model(xq: np.ndarray, wq: np.ndarray, stride: int,
              odd_start_shift: int = 0, tail_weight: int = 0) -> np.ndarray:
    """K1q's int32 sums as the kernel addresses them, one tile per image
    (TH = Ho, TW = Wo): each 64-channel slice's patch as a byte array of
    80-byte pixels (input columns in even/odd order at stride 2, zeros for
    the padding), the weights as [n][k] rows of K = 9·cpg padded to the
    k32 step with ``tail_weight`` (0 in the kernel), and for each k32 step
    and lane byte the (tap, channel) the kernel's A offset reads (ldmatrix
    rows at cpg ≥ 16, 4-byte loads at cpg 8; taps past 8 read tap 8).
    ``odd_start_shift`` moves where the centre tap finds the odd columns
    (a fault)."""
    n, h, w, c = xq.shape
    cpg = wq.shape[2]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    pr, pw = (ho - 1) * stride + 3, (wo - 1) * stride + 3
    pwe = (pw + 1) // 2
    kr = (9 * cpg + 31) // 32 * 32
    out = np.zeros((n, ho, wo, c), np.int64)
    oy, ox = np.meshgrid(np.arange(ho), np.arange(wo), indexing="ij")
    apix = (oy * stride * pw + ox) * PIXEL                      # [ho, wo]
    gbyte = (np.arange(SLICE) // cpg * cpg)[:, None, None]      # [64, 1, 1]

    def tap_off(t):
        ky, kx = divmod(min(t, 8), 3)
        col = kx if stride == 1 else (pwe + odd_start_shift if kx == 1 else kx >> 1)
        return (ky * pw + col) * PIXEL

    def source(kc: int, kk: int) -> int:
        """The byte offset, from an output pixel's (0, 0) tap and its
        group's first channel, of the A byte that lane byte kk of k32
        step kc reads."""
        if cpg >= 32:
            return tap_off((kc * 32) // cpg) + (kc * 32) % cpg + kk
        if cpg == 16:
            return tap_off(2 * kc + kk // 16) + kk % 16
        t4 = (kk % 16) // 4        # cpg 8: a0/a1 taps t/2, a2/a3 taps 2 + t/2
        return tap_off(4 * kc + 2 * (kk // 16) + t4 // 2) + (t4 & 1) * 4 + kk % 4

    for c0 in range(0, c, SLICE):
        wk = np.full((SLICE, kr), tail_weight, np.int64)         # [n][k]
        wk[:, :9 * cpg] = wq.reshape(9 * cpg, c)[:, c0:c0 + SLICE].T
        for b in range(n):
            patch = np.zeros((pr, pw, PIXEL), np.int64)
            for j in range(pw):
                ix = j - 1
                if 0 <= ix < w:
                    col = j if stride == 1 else (j >> 1 if j % 2 == 0 else pwe + (j >> 1))
                    rows = min(pr - 1, h)
                    patch[1:rows + 1, col, :SLICE] = xq[b, :rows, ix, c0:c0 + SLICE]
            flat = patch.reshape(-1)
            acc = np.zeros((SLICE, ho, wo), np.int64)
            for k in range(kr):
                acc += flat[apix[None] + gbyte + source(k // 32, k % 32)] * wk[:, k, None, None]
            out[b, :, :, c0:c0 + SLICE] = acc.transpose(1, 2, 0)
    return out


@functools.lru_cache(maxsize=None)
def _k1q_case(cpg: int, stride: int):
    """int8 x [2, 9, 13, 128] and HWIO weights with every output channel
    holding a ±127 (so a power-of-two scale quantizes them back exactly)."""
    rng = np.random.RandomState(cpg * 10 + stride)
    xq = rng.randint(-127, 128, (2, 9, 13, 128)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, cpg, 128)).astype(np.int8)
    wq[0, 0, 0, :] = 127
    return xq, wq


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cpg", [8, 16, 32, 64])
def test_k1q_packing_model_is_the_grouped_conv(cpg, stride):
    """The model of K1q's k32 packing equals the port's exact conv and the
    JAX package's ``int8_conv`` (eager, f32 out, scales powers of two, so
    its integer sums come back exactly) bit for bit."""
    xq, wq = _k1q_case(cpg, stride)
    groups = 128 // cpg
    model = k1q_model(xq, wq, stride)
    exact = exact_conv(torch.from_numpy(xq), torch.from_numpy(wq), stride, 1,
                       groups).numpy()
    np.testing.assert_array_equal(model.astype(np.float32), exact)
    scale = np.float32(2.0 ** -10)
    qx = jquant.QuantTensor(jnp.asarray(xq), jnp.float32(1.0))
    jax_y = np.asarray(jquant.int8_conv(qx, jnp.asarray(wq.astype(np.float32) * scale),
                                        stride, 1, groups, out_dtype=jnp.float32))
    np.testing.assert_array_equal(jax_y / scale, model.astype(np.float32))


@pytest.mark.parametrize("cpg", [8, 16, 32, 64])
def test_k1q_packing_faults_change_the_sums(cpg):
    """Within the model: the last k32 step left out is chip_smoke's
    ``dropped_tap_tail`` emulation exactly, and moving the start of the
    stride-2 patch's odd columns changes the sums; the tail's zero weights
    are what keeps its repeated tap-8 reads out (weights of 1 there change
    them)."""
    xq, wq = _k1q_case(cpg, 2)
    groups = 128 // cpg
    want = k1q_model(xq, wq, 2)
    assert not np.array_equal(k1q_model(xq, wq, 2, odd_start_shift=-1), want)
    flat = wq.reshape(9 * cpg, 128).copy()
    flat[cs.k1q_last_step(cpg):] = 0
    dropped = k1q_model(xq, flat.reshape(wq.shape), 2)
    ones = torch.ones(128)
    emulated = cs.k1q_with_fault(torch.from_numpy(xq), torch.from_numpy(wq), ones,
                                 torch.zeros(128), groups, 2, "dropped_tap_tail")
    np.testing.assert_array_equal(np.maximum(dropped, 0).astype(np.float32),
                                  emulated.numpy())
    assert not np.array_equal(dropped, want)
    if 9 * cpg % 32:                     # cpg 8 and 16: a zero tail
        assert not np.array_equal(k1q_model(xq, wq, 2, tail_weight=1), want)


@pytest.mark.parametrize("fault,stride", [("dropped_tap_tail", 1),
                                          ("dropped_tap_tail", 2),
                                          ("stride2_column_order", 2)])
@pytest.mark.parametrize("cpg", [8, 16, 32, 64])
def test_k1q_fault_misses_tolerance(fault, stride, cpg):
    """Each K1Q_FAULTS emulation, on chip_smoke's kind of inputs
    (``k1q_inputs``: a ReLU'd map, weight channels spread 8×, the BN scale
    evening them out), misses K1q's tolerance by more than 3×; without a
    fault the emulation's path (a float64 conv) is the plain version."""
    c = 32 * cpg
    g = torch.Generator().manual_seed(cpg + stride)
    x, wt, bn_s, bn_b = cs.k1q_inputs(2, 9, 11, c, g)
    qx, qw = quant.quant_act(x), quant.quant_weight(wt, (0, 1, 2))
    m = qx.scale * qw.scale * bn_s
    want = reference_grouped_conv3x3_int8(qx.data, qw.data, m, bn_b, 32, stride,
                                          True, torch.float32)
    got = cs.k1q_with_fault(qx.data, qw.data, m, bn_b, 32, stride, fault)
    tol = cs.TOL["K1q"] * float(want.abs().max())
    assert got.shape == want.shape
    assert float((got - want).abs().max()) > 3 * tol
    with pytest.raises(ValueError):
        cs.k1q_with_fault(qx.data, qw.data, m, bn_b, 32, 1, "stride2_column_order")


# --- K7 -------------------------------------------------------------------------

def _k7_torch(m, h, f, seed=0):
    x, w1, w2, b1, b2, gamma, beta = (torch.from_numpy(a)
                                      for a in cs.k7_inputs(m, h, f, seed))
    x = x.bfloat16().float()
    q1, q2 = quant.quant_ffn_weights(w1), quant.quant_ffn_weights(w2)
    return x, w1, w2, b1, b2, gamma, beta, q1, q2


def _combined_scale(hid: np.ndarray, block: int) -> np.ndarray:
    """K7's tile scale as the kernel forms it: each block's max |h| (f32),
    combined over the tile's blocks by the order of the f32 bits as int32
    (atomicMax; every value is >= 0), then max(·, 1e-8) / 127 in f32."""
    t, tm, f = hid.shape
    blocks = np.abs(hid).reshape(t, tm // block, block, f // block, block)
    block_max = blocks.max(axis=(2, 4)).astype(np.float32)
    bits = block_max.view(np.int32).reshape(t, -1).max(axis=1)
    amax = bits.view(np.float32)
    return (np.maximum(amax, np.float32(1e-8)) / np.float32(127)).astype(np.float32)


@pytest.mark.parametrize("tm", [128, 256])
def test_k7_tile_max_and_h_quantization_match_the_plain_version(tm):
    """The blocks' maxima combined over each [tm, F] tile give the plain
    version's tile scale and h codes bit for bit; block-local scales (the
    ``block_local_h_scale`` fault) give other codes."""
    m, h, f, _ = cs.K7_FAULT_SHAPE
    x, w1, w2, b1, b2, gamma, beta, q1, q2 = _k7_torch(m, h, f)
    hid = quant.ffn_int8_hidden(x, q1.data, q1.scale, b1, tm)
    plain = quant._tile_quant(hid)
    sh = _combined_scale(hid.numpy(), cs.K7_BLOCK)
    np.testing.assert_array_equal(sh, plain.scale.reshape(-1).numpy())
    codes = np.clip(np.rint(hid.numpy() / sh[:, None, None]), -127, 127)
    np.testing.assert_array_equal(codes.astype(np.int8), plain.data.numpy())
    b = cs.K7_BLOCK
    blocks = hid.reshape(-1, b, f // b, b).transpose(1, 2).reshape(-1, b, b)
    local = quant._tile_quant(blocks).data.reshape(-1, f // b, b, b).transpose(1, 2)
    assert not torch.equal(local.reshape(plain.data.shape), plain.data)


def test_k7_faults_miss_tolerance():
    """At ``K7_FAULT_SHAPE`` on ``k7_inputs`` (the shape and inputs of the
    card's ``test_ffn_int8_faults_miss``), each of ``K7_FAULTS`` lands more
    than 1.5× K7's tolerance from the plain version, and the emulation
    without a fault within 1% of it."""
    m, h, f, tm = cs.K7_FAULT_SHAPE
    x, w1, w2, b1, b2, gamma, beta, q1, q2 = _k7_torch(m, h, f)
    want = quant.reference_ffn_int8(x, q1.data, q1.scale, b1, q2.data, q2.scale,
                                    b2, gamma, beta, tm)
    tol = cs.TOL["K7"] * float(want.abs().max())
    sound = cs.ffn_int8_with_fault(x, w1, b1, w2, b2, gamma, beta, tm)
    assert float((sound - want).abs().max()) < 0.01 * tol
    for fault in cs.K7_FAULTS:
        got = cs.ffn_int8_with_fault(x, w1, b1, w2, b2, gamma, beta, tm, fault)
        assert float((got - want).abs().max()) > 1.5 * tol, fault


def test_k7_plain_version_matches_the_pallas_kernel():
    """K7's plain version against ``bench_int8.py``'s kernel in interpret
    mode on ``k7_inputs`` at M 256, H 128, F 256, tm 128, within 1e-5 of
    scale on every row but those where an h code flips at a rounding tie
    (XLA rounds h and its scale one ulp apart from the source, as
    ``test_torch_quant.py`` shows): each such row holds an h / sh within
    1e-5 of a half, and moves by about one code's worth."""
    m, h, f, tm = 256, 128, 256, 128
    x, w1, w2, b1, b2, gamma, beta = cs.k7_inputs(m, h, f, seed=3)
    ns = _study(m, h, f)
    (w1q, s1), (w2q, s2) = ns["qw"](jnp.asarray(w1)), ns["qw"](jnp.asarray(w2))
    want = run_interpret(lambda *a: ns["ffn_int8"](*a, tm), x, w1q, s1, b1, w2q,
                         s2, b2, gamma, beta)
    args = [torch.from_numpy(np.array(a)) for a in (x, w1q, s1, b1, w2q, s2, b2,
                                                     gamma, beta)]
    got = quant.reference_ffn_int8(*args, tm).numpy()
    err = np.abs(got - want).max(1) / np.abs(want).max()
    off = np.nonzero(err > 1e-5)[0]
    hid = quant.ffn_int8_hidden(args[0], args[1], args[2], args[3], tm)
    codes = (hid / (hid.abs().amax((1, 2), keepdim=True) / 127.0)).reshape(m, f)
    to_half = (codes.abs() - codes.abs().floor() - 0.5).abs().numpy()
    assert all(to_half[r].min() < 1e-5 for r in off), off
    assert err.max() < 4e-3
