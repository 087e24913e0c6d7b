"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card, at small shapes that exercise the ragged edges (odd widths, stride
2, S not a multiple of the query tile, M not a multiple of the row tile).

These need the card: they skip where CUDA is unavailable. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from cpt_tpu_torch.kernels.build import KernelError
from cpt_tpu_torch.kernels.gemm import (attention_core, gemm_bias_act,
                                        gemm_bias_residual_ln)
from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                         flash_mha_bwd_dq, flash_mha_fwd,
                                         reference_flash_mha,
                                         reference_flash_mha_bwd)
from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                               reference_attention_block,
                                               reference_attention_core)
from cpt_tpu_torch.ops.fused_ffn import fused_ffn, reference_ffn
from cpt_tpu_torch.ops.nms import nms_padded
from cpt_tpu_torch.ops.nms_pallas import nms_pallas
from cpt_tpu_torch.ops.grouped_conv import (conv_path, grouped_conv3x3,
                                            launch_grouped_conv3x3,
                                            reference_grouped_conv3x3)
from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                batched_roi_align_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, frac):
    """bf16 kernel vs the f32 plain version on the same bf16 inputs:
    |Δ| within ``frac`` of the output scale."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    assert err <= frac * max(float(want.abs().max()), 1e-3), err


@pytest.mark.parametrize("n,h,w,c,groups,stride", [
    (2, 9, 13, 256, 32, 1), (2, 9, 13, 256, 32, 2), (3, 14, 14, 128, 2, 2),
    (1, 5, 7, 16, 4, 1)])
def test_grouped_conv_kernel(dev, n, h, w, c, groups, stride):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, h, w, c, generator=g, device=dev).bfloat16()
    wt = (torch.randn(3, 3, c // groups, c, generator=g, device=dev) * 0.1).bfloat16()
    s = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev)
    got = grouped_conv3x3(x, wt, s, b, groups, stride, True)
    want = reference_grouped_conv3x3(x.float(), wt.float(), s, b, groups,
                                     stride, True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


@pytest.mark.parametrize("sampling", [0, 2])
@pytest.mark.parametrize("b,h,w,c,pooled", [
    (3, 11, 17, 64, 7), (1, 11, 17, 64, 7), (1, 16, 16, 1024, 14),
    (11, 11, 17, 200, 7), (101, 9, 13, 136, 7)])
def test_roi_align_kernel(dev, b, h, w, c, pooled, sampling):
    """K2 in bf16 against its plain version in f32, at each code its
    launcher picks by shape: one copy (one block over all C channels; C =
    1024 as in the detect step's box head), and B·P·16 >= 1024 (128-channel
    slices, the last one ragged, copies in groups, an odd copy at the end).
    The second RoI reaches past the map, so each of K2's named faults that
    applies to the grid (``chip_smoke.k2_faults``) misses the tolerance."""
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(1 if b == 3 else b + c)
    feats = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    rois = torch.tensor([[0, 0, 400, 300], [-50, -40, 900, 700],
                         [30.5, 20.25, 31, 21], [100, 60, 250, 170],
                         [260, 170, 280, 190]], device=dev)
    got = batched_roi_align(feats, rois, 1 / 16.0, pooled, sampling, 8)
    want = batched_roi_align_plain(feats.float(), rois, 1 / 16.0, pooled,
                                   sampling, 8)
    _close(got, want, 1e-2)
    faults = {f: fn() for f, fn in cs.k2_faults(feats, rois, 1 / 16.0, pooled,
                                                 sampling, 8).items()}
    assert len(faults) == (4 if sampling == 0 else 3)
    assert _attn_faults_missed(want, faults, 1e-2) == []


def _attn_faults_missed(want, faults, frac):
    """Names of the faulty references that land within ``frac`` of
    ``want``'s scale, i.e. that the check could not tell from the kernel."""
    tol = frac * float(want.float().abs().max())
    return [name for name, f in faults.items()
            if not float((f.float() - want.float()).abs().max()) > tol]


@pytest.mark.parametrize("s_len", [37, 78, 120, 140])
def test_attention_kernel(dev, s_len):
    """The whole sub-block on chip_smoke's kind of inputs (``k3_inputs``:
    projections scaled so the scores spread, std ≈ 2; a QKV bias of std
    0.5; output-bias slices with different means): uniform attention, a
    dropped mask and each of the shared GEMM's named faults miss the
    tolerance."""
    import chip_smoke as cs

    heads = 4
    args = cs.on_card(cs.k3_inputs(3, s_len, 256, seed=s_len), dev)
    got = fused_attention_block(*args, heads, 1e-12)
    fargs = [a.float() for a in args]
    want = reference_attention_block(*fargs, num_heads=heads, eps=1e-12)
    _close(got, want, 2e-2)
    no_q = [a.clone() for a in fargs]
    no_q[1][:, :256] = 0.0
    no_q[2][:256] = 0.0
    faults = {"uniform": reference_attention_block(*no_q, num_heads=heads,
                                                   eps=1e-12),
              "no_mask": reference_attention_block(
                  *fargs[:7], torch.zeros_like(fargs[7]), num_heads=heads,
                  eps=1e-12)}
    faults.update({f: cs.attention_block_with_fault(*fargs, heads, 1e-12, f)
                   for f in cs.GEMM_FAULTS})
    assert _attn_faults_missed(want, faults, 2e-2) == []


@pytest.mark.parametrize("b,s_len", [(128, 90), (48, 120), (64, 120)])
def test_blocks_at_the_task_batches(dev, b, s_len):
    """K3's block and K4 at GQA's eval batch (128 × (45 + 45)), VG's
    (48 × (70 + 50)) and REC_FT's (64 × (70 + 50), K4 at 7,680 rows) at
    full width, on chip_smoke's inputs: within the
    tolerance of their plain versions in f32, and the shared GEMM's named
    faults (with uniform attention for K3) miss it."""
    import chip_smoke as cs

    heads, hdim = 12, 768
    args = cs.on_card(cs.k3_inputs(b, s_len, hdim, seed=s_len), dev)
    fargs = [a.float() for a in args]
    want = reference_attention_block(*fargs, num_heads=heads, eps=1e-12)
    _close(fused_attention_block(*args, heads, 1e-12), want, 2e-2)
    no_q = [a.clone() for a in fargs]
    no_q[1][:, :hdim] = 0.0
    no_q[2][:hdim] = 0.0
    faults = {"uniform": reference_attention_block(*no_q, num_heads=heads,
                                                   eps=1e-12)}
    faults.update({f: cs.attention_block_with_fault(*fargs, heads, 1e-12, f)
                   for f in cs.GEMM_FAULTS})
    assert _attn_faults_missed(want, faults, 2e-2) == []
    args = cs.on_card(cs.k4_inputs(b * s_len, hdim, 3072, seed=b), dev)
    fargs = [a.float() for a in args]
    want = reference_ffn(*fargs, 1e-12, False)
    _close(fused_ffn(*args), want, 2e-2)
    assert _attn_faults_missed(want, {f: cs.ffn_with_fault(*fargs, 1e-12, False, f)
                                      for f in cs.GEMM_FAULTS}, 2e-2) == []


# Sequence lengths around the attention tiles' 64-row and 64-key edges, the
# server's smallest bucket (70 text + 8 regions), VCR's 80 + 60 (the core's
# streamed branch) and the long-context 70 text + 950 region slots
EDGE_S = [1, 15, 16, 17, 37, 63, 64, 65, 78, 120, 127, 128, 129, 140, 200,
          1020]


def _pad_keys(t, dim, n):
    """``t`` with ``n`` zero rows appended along ``dim``."""
    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim)


def _core_edge_unmasked(qkv, kb, heads, scale):
    """The attention core's fault ``edge_unmasked``: the keys from S up to
    the next multiple of 64 enter with score 0 and zero V."""
    s = qkv.shape[1]
    pad = -s % 64
    return reference_attention_core(_pad_keys(qkv, 1, pad), _pad_keys(kb, 1, pad),
                                    heads, scale)[:, :s]


def _flash_edge_unmasked(q, k, v, kb, scale):
    """K6's fault ``edge_unmasked`` (see :func:`_core_edge_unmasked`)."""
    s = q.shape[2]
    pad = -s % 64
    kb = _pad_keys(kb, 3, pad)
    if kb.shape[2] > 1:
        kb = _pad_keys(kb, 2, pad)
    return reference_flash_mha(*(_pad_keys(t, 2, pad) for t in (q, k, v)), kb,
                               sm_scale=scale)[:, :, :s]


def _flash_no_rescale(q, k, v, bias, scale):
    """K6's fault ``no_rescale``: the online softmax over 64-key tiles with
    the running accumulator not rescaled by exp(m_old − m_new) when the
    row max rises (the running sum is)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if bias is not None:
        s = s + bias
    s = s * scale
    m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, s.shape[-1], 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        l = l * torch.exp(m - m_new) + p.sum(-1)
        acc = acc + p @ v[:, :, k0:k0 + 64]
        m = m_new
    return acc / l[..., None]


@pytest.mark.parametrize("s_len", EDGE_S)
def test_attention_core_kernel(dev, s_len):
    """The attention core alone against softmax(QKᵀ·scale + key_bias)·V in
    f32 on the same packed projection (std 1.5, so scores have std ≈ 2), at
    S on both sides of the 64-row and 64-key tile edges and at the
    long-context 1020 (the kernel once refused S ≥ 815), the last sequence
    fully masked. Uniform attention, a dropped mask and a dropped scale miss
    the tolerance (from S = 32, where a softmax has room to differ), and so
    do keys past S that enter unmasked (``edge_unmasked``, wherever S is not
    a multiple of 64: the fully masked sequence's −1e4 scores lose to them)."""
    g = torch.Generator(device=dev).manual_seed(4)
    b, h, heads = 3, 256, 4
    scale = 1.0 / (h // heads) ** 0.5
    qkv = (torch.randn(b, s_len, 3 * h, generator=g, device=dev) * 1.5
           ).bfloat16()
    kb = torch.where(torch.rand(b, s_len, generator=g, device=dev) > 0.3,
                     0.0, -10000.0)
    kb[-1] = -10000.0
    got = attention_core(qkv, kb, heads, scale)
    assert got.shape == (b, s_len, h) and got.dtype == torch.bfloat16
    want = reference_attention_core(qkv, kb, heads, scale)
    _close(got, want, 1e-2)
    faults = {}
    if s_len >= 32:
        no_q = qkv.clone()
        no_q[..., :h] = 0
        faults = {"uniform": reference_attention_core(no_q, kb, heads, scale),
                  "no_mask": reference_attention_core(qkv, torch.zeros_like(kb),
                                                      heads, scale),
                  "no_scale": reference_attention_core(qkv, kb, heads, 1.0)}
    if s_len % 64:
        faults["edge_unmasked"] = _core_edge_unmasked(qkv, kb, heads, scale)
    assert _attn_faults_missed(want, faults, 1e-2) == []


@pytest.mark.parametrize("d,heads", [(16, 4), (24, 4), (40, 2), (80, 2),
                                     (200, 1), (256, 2), (512, 1), (36, 2),
                                     (12, 8)])
def test_attention_core_kernel_at_every_kind_of_head_dim(dev, d, heads):
    """K3's core at the head dims of each code path (``attention_path``):
    the tile (16, 80, 256), the zero-padded tile (24, 40, 200), the
    CUDA-core kernel (512, 36, 12), at S 130, against its plain version;
    uniform attention and, on the padded tile, the pad read from memory
    (``pad_not_zeroed``) miss."""
    import chip_smoke as cs
    from cpt_tpu_torch.kernels.gemm import attention_path

    g = torch.Generator(device=dev).manual_seed(d)
    b, s_len, h = 2, 130, d * heads
    scale = d ** -0.5
    qkv = (torch.randn(b, s_len, 3 * h, generator=g, device=dev) * 1.5).bfloat16()
    kb = torch.where(torch.rand(b, s_len, generator=g, device=dev) > 0.3,
                     0.0, -10000.0)
    path = attention_path(d)
    before = dict(attention_core.path_launches)
    got = attention_core(qkv, kb, heads, scale)
    assert attention_core.path_launches[path] == before[path] + 1
    want = reference_attention_core(qkv, kb, heads, scale)
    _close(got, want, 1e-2)
    no_q = qkv.clone()
    no_q[..., :h] = 0
    faults = {"uniform": reference_attention_core(no_q, kb, heads, scale)}
    if path == "mma" and d % 16:
        faults["pad_not_zeroed"] = cs.core_pad_not_zeroed(qkv, kb, heads, scale)
    assert _attn_faults_missed(want, faults, 1e-2) == []


@pytest.mark.parametrize("approximate", [False, True])
def test_ffn_kernel(dev, approximate):
    """K4 on chip_smoke's kind of inputs (``k4_inputs``), H = 256 (a
    cluster of 2), F = 1024, 74 rows; each of the shared GEMM's named
    faults misses the tolerance."""
    import chip_smoke as cs

    args = cs.on_card(cs.k4_inputs(74, 256, 1024, seed=int(approximate)), dev)
    args[0] = args[0].view(2, 37, 256)
    got = fused_ffn(*args, approximate=approximate)
    fargs = [a.float() for a in args]
    want = reference_ffn(*fargs, 1e-12, approximate)
    _close(got, want, 3e-2)
    faults = {f: cs.ffn_with_fault(*fargs, 1e-12, approximate, f)
              for f in cs.GEMM_FAULTS}
    assert _attn_faults_missed(want, faults, 3e-2) == []


# The shared GEMM (csrc/gemm.cu) at M on both sides of its 64- and 128-row
# tiles and K on both sides of its 64-deep k tile (72: one full tile and a
# ragged one), against f32 matmuls on the same bf16 inputs.
GEMM_M = [1, 63, 130, 1920]
GEMM_K = [72, 768, 3072]


def _gemm_inputs(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = (torch.randn(m, k, generator=g, device=dev) * 0.5).bfloat16()
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).bfloat16()
    return a, w, g


@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("act", ["none", "gelu", "gelu_new"])
def test_gemm_bias_act_kernel(dev, act, m, k):
    """Epilogues (a) and (b) at N = 2304 (K3's QKV width), and at a ragged
    N = 136 for K = 72; the last k tile dropped and the bias dropped miss
    the tolerance."""
    import torch.nn.functional as F

    import chip_smoke as cs

    n = 136 if k == 72 else 2304
    a, w, g = _gemm_inputs(dev, m, k, n, seed=m + k)
    b = torch.randn(n, generator=g, device=dev) * 0.5
    got = gemm_bias_act(a, w, b, act)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16

    def plain(wt, bias):
        y = a.float() @ wt.float() + bias
        if act == "none":
            return y
        return F.gelu(y, approximate="tanh" if act == "gelu_new" else "none")

    want = plain(w, b)
    _close(got, want, 1e-2)
    faults = {"k_tail_dropped": plain(cs.k_tail_dropped(w.float()), b),
              "no_bias": plain(w, torch.zeros_like(b))}
    assert _attn_faults_missed(want, faults, 1e-2) == []


@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("nf", [1, 3, 6, 8])
def test_gemm_bias_residual_ln_kernel(dev, nf, m, k):
    """Epilogue (c) on a cluster of nf blocks: N = 128·nf (8: Oscar-large's
    1024), bias slices with different means; the statistics per 128-column
    slice (nf > 1), the last k tile dropped and the residual dropped miss
    the tolerance."""
    import chip_smoke as cs
    from cpt_tpu_torch.ops.fused_attention import layer_norm_f32

    n = 128 * nf
    a, w, g = _gemm_inputs(dev, m, k, n, seed=nf * 7 + m + k)
    b = (torch.randn(n, generator=g, device=dev) * 0.1
         + torch.from_numpy(cs.slice_offsets(np.random.RandomState(nf), n)).float().to(dev))
    res = (torch.randn(m, n, generator=g, device=dev) * 0.5).bfloat16()
    gamma = torch.rand(n, generator=g, device=dev) + 0.5
    beta = torch.randn(n, generator=g, device=dev) * 0.1
    got = gemm_bias_residual_ln(a, w, b, res, gamma, beta, 1e-12)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16

    def plain(wt, residual=True, norm=layer_norm_f32):
        y = a.float() @ wt.float() + b + (res.float() if residual else 0.0)
        return norm(y, gamma, beta, 1e-12)

    want = plain(w)
    _close(got, want, 2e-2)
    faults = {"k_tail_dropped": plain(cs.k_tail_dropped(w.float())),
              "no_residual": plain(w, residual=False)}
    if nf > 1:
        faults["ln_slice_stats"] = plain(w, norm=cs.ln_slice_stats)
    assert _attn_faults_missed(want, faults, 2e-2) == []


def test_gemm_refused_launch_raises(dev):
    """The LN-GEMM's cluster entry point returns an error for a row it
    cannot hold on one cluster (N = 9·128: 9 blocks, over the portable 8),
    and the wrapper's check turns it into a KernelError; the wrapper takes
    the split path there (``ln_gemm_path``) and refuses a width off 128."""
    from cpt_tpu_torch.kernels.build import check, lib

    m, k, n = 64, 64, 9 * 128
    a, w, _ = _gemm_inputs(dev, m, k, n, seed=0)
    vec = torch.zeros(n, device=dev)
    res = torch.zeros(m, n, device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(res)
    status = lib().cpt_gemm_bias_residual_ln(
        a.data_ptr(), w.data_ptr(), vec.data_ptr(), res.data_ptr(),
        vec.data_ptr(), vec.data_ptr(), out.data_ptr(), m, n, k, 1e-12,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(KernelError):
        check(status, "cpt_gemm_bias_residual_ln")
    with pytest.raises(KernelError, match="multiple of 128"):
        gemm_bias_residual_ln(a[:, :64], w[:64, :1000], vec[:1000],
                              res[:, :1000], vec[:1000], vec[:1000], 1e-12)
    before = dict(gemm_bias_residual_ln.path_launches)
    assert gemm_bias_residual_ln(a, w, vec, res, vec, vec, 1e-12).shape == (m, n)
    assert gemm_bias_residual_ln.path_launches["split"] == before["split"] + 1


@pytest.mark.parametrize("nf", [9, 10, 12, 16, 24, 32])
def test_gemm_bias_residual_ln_split_path(dev, nf):
    """Epilogue (c) on the split path (f32 rows and per-tile statistics,
    merged by the row kernel): N = 128·nf past the cluster's 1024, where
    ``ln_gemm_path`` sends it; the statistics per slice, the last tile's
    statistics dropped from the merge, the last k tile and the residual
    dropped miss the tolerance."""
    import chip_smoke as cs
    from cpt_tpu_torch.kernels.gemm import gemm_bias_residual_ln as ln_gemm
    from cpt_tpu_torch.ops.fused_attention import layer_norm_f32

    n, m, k = 128 * nf, 200, 320
    a, w, g = _gemm_inputs(dev, m, k, n, seed=nf)
    b = (torch.randn(n, generator=g, device=dev) * 0.1
         + torch.from_numpy(cs.slice_offsets(np.random.RandomState(nf), n)).float().to(dev))
    res = (torch.randn(m, n, generator=g, device=dev) * 0.5).bfloat16()
    gamma = torch.rand(n, generator=g, device=dev) + 0.5
    beta = torch.randn(n, generator=g, device=dev) * 0.1
    before = dict(ln_gemm.path_launches)
    got = ln_gemm(a, w, b, res, gamma, beta, 1e-12)
    assert ln_gemm.path_launches["split"] == before["split"] + 1

    def plain(wt, residual=True, norm=layer_norm_f32):
        y = a.float() @ wt.float() + b + (res.float() if residual else 0.0)
        return norm(y, gamma, beta, 1e-12)

    want = plain(w)
    _close(got, want, 2e-2)
    faults = {"k_tail_dropped": plain(cs.k_tail_dropped(w.float())),
              "no_residual": plain(w, residual=False)}
    if nf > 1:
        faults["ln_slice_stats"] = plain(w, norm=cs.ln_slice_stats)
    if 1 < nf <= 16:
        # one tile of nf carries ~1/nf of the statistics: at 32 tiles these
        # inputs' slices do not spread enough for it to show (chip_smoke's
        # phase 22 holds it at N 4096 on its own inputs)
        faults["tile_stats_dropped"] = plain(w, norm=cs.ln_tile_stats_dropped)
    assert _attn_faults_missed(want, faults, 2e-2) == []


def _conv_case(dev, n, h, w, c, cpg, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn(n, h, w, c, generator=g, device=dev)).bfloat16()
    tap_mean = torch.linspace(-0.03, 0.03, 9, device=dev).view(3, 3, 1, 1)
    wt = (torch.randn(3, 3, cpg, c, generator=g, device=dev) * 0.05
          + tap_mean).bfloat16()
    s = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.5
    return x, wt, s, b


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n,h,w,c,cpg", [
    (2, 19, 37, 128, 8), (2, 19, 37, 128, 16), (2, 19, 37, 128, 32),
    (2, 19, 37, 128, 64), (1, 7, 7, 256, 64), (1, 5, 9, 64, 8),
    (3, 33, 17, 192, 16)])
def test_grouped_conv_mma_path(dev, n, h, w, c, cpg, stride):
    """K1's tensor-core path at cpg 8, 16, 32 and 64, stride 1 and 2, on
    ragged maps (H and W not multiples of the 8x16, 4x16 or 8x8 tiles, W
    odd, N = 1, maps of at most 64 output pixels) with several groups in a
    64-channel slice; counted on its path; and a wrong-group fault (x's
    group axis rolled) misses the tolerance."""
    groups = c // cpg
    assert conv_path(c, cpg) == "mma"
    x, wt, s, b = _conv_case(dev, n, h, w, c, cpg)
    before = dict(grouped_conv3x3.path_launches)
    total = grouped_conv3x3.launches
    got = grouped_conv3x3(x, wt, s, b, groups, stride, True)
    assert grouped_conv3x3.launches == total + 1
    assert grouped_conv3x3.path_launches == {"mma": before["mma"] + 1,
                                             "simt": before["simt"]}
    want = reference_grouped_conv3x3(x.float(), wt.float(), s, b, groups,
                                     stride, True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want, 1e-2)
    wrong = reference_grouped_conv3x3(
        x.float().view(n, h, w, groups, cpg).roll(1, 3).view(n, h, w, c),
        wt.float(), s, b, groups, stride, True)
    assert float((wrong - want).abs().max()) > 3e-2 * float(want.abs().max())


@pytest.mark.parametrize("n,h,w,c,stride", [(2, 96, 128, 512, 2),
                                             (2, 31, 39, 1024, 1)])
def test_grouped_conv_windowed_shapes(dev, n, h, w, c, stride):
    """K1 at one of the windowed path's window shapes (layer2's first block
    on the 384x512 window) and one of the cascade's odd layer3 windows,
    with chip_smoke's inputs and named faults."""
    import chip_smoke as cs

    g = torch.Generator(device=dev).manual_seed(3)
    x, wt, s, b = cs.k1_inputs(n, h, w, c, g)
    want = reference_grouped_conv3x3(x.float(), wt.float(), s, b, 32, stride,
                                     True)
    mma = grouped_conv3x3.path_launches["mma"]
    _close(grouped_conv3x3(x, wt, s, b, 32, stride, True), want, cs.TOL["K1"])
    assert grouped_conv3x3.path_launches["mma"] == mma + 1
    scale = float(want.abs().max())
    for fault, fn in cs.k1_faults(x.float(), wt.float(), s, b, 32,
                                  stride).items():
        assert float((fn() - want).abs().max()) > cs.TOL["K1"] * scale, fault


def test_windowed_extraction_matches_full_path(dev):
    """The two-level windowed Extractor in bf16 on the card against the
    full path at a small size (a deep tiny detector, 208x240 canvas, a
    window ladder with one copy past every rung): features within
    chip_smoke's WINDOW_TOL, labels equal, every route taken, and each of
    the named faults missing the tolerance."""
    import chip_smoke as cs
    from cpt_tpu_torch.engine.extract import Extractor, refcoco_task
    from cpt_tpu_torch.models.detector import config as det_cfg
    from cpt_tpu_torch.models.detector import convert as dconv
    from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN

    cfg = det_cfg.tiny_detector_config()
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, stage_blocks=(1, 1, 6)),
        input=dataclasses.replace(cfg.input, pad_h=208, pad_w=240,
                                  buckets=((208, 240),)))
    with torch.device(dev):
        model = AttrRCNN(cfg, torch.bfloat16).eval()
    model.load_state_dict(dconv.state_from_reference(
        dconv.random_vinvl_state_dict(cfg, seed=7), cfg), strict=False)
    rng = np.random.RandomState(11)
    image = rng.randint(0, 256, (208, 240, 3)).astype(np.uint8)
    rects = np.asarray([[100, 96, 112, 108], [90, 88, 122, 124],
                        [80, 72, 140, 128], [1, 1, 20, 20],
                        [10, 10, 230, 200]], np.float32)
    task = refcoco_task("q", image, (208, 240), rects, "c")
    full = Extractor(model, cfg, copies_per_chunk=2).extract_task(task)
    ex = Extractor(model, cfg, copies_per_chunk=2, windowed=True,
                   window=[(96, 112), (112, 128), (128, 144)], halo=32)
    assert ex.windowed_mode == "two_level"
    got = ex.extract_task(task)
    assert all(n >= 1 for n in ex.route_copies.values()), ex.route_copies
    assert np.isfinite(got[0]).all()
    assert cs.feature_gap(got[0], full[0]) <= cs.WINDOW_TOL
    np.testing.assert_array_equal(got[1], full[1])
    for fault in cs.WINDOW_FAULTS:
        with cs.window_fault(fault):
            bad = ex.extract_task(task)
        assert cs.feature_gap(bad[0], full[0]) > cs.WINDOW_TOL, fault


def test_mask_copies_on_the_card(dev):
    """RefCOCO SEG's mask copies in bf16 on the card (a deep tiny detector,
    208x240 canvas): the two-level windowed route equals the full path
    within chip_smoke's WINDOW_TOL with every route taken, and the full
    path's features equal those of the same copies composited on the host
    (``chip_smoke.host_paint`` of the masks' blend) and run unpainted, bit
    for bit: the device paint is exact integer math."""
    import chip_smoke as cs
    from cpt_tpu_torch.engine.extract import Extractor, refcoco_mask_task
    from cpt_tpu_torch.models.detector import config as det_cfg
    from cpt_tpu_torch.models.detector import convert as dconv
    from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN

    cfg = det_cfg.tiny_detector_config()
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, stage_blocks=(1, 1, 6)),
        input=dataclasses.replace(cfg.input, pad_h=208, pad_w=240,
                                  buckets=((208, 240),)))
    with torch.device(dev):
        model = AttrRCNN(cfg, torch.bfloat16).eval()
    model.load_state_dict(dconv.state_from_reference(
        dconv.random_vinvl_state_dict(cfg, seed=8), cfg), strict=False)
    rng = np.random.RandomState(12)
    image = rng.randint(0, 256, (208, 240, 3)).astype(np.uint8)
    boxes = np.asarray([[100, 96, 112, 108], [90, 88, 122, 124],
                        [80, 72, 140, 128], [1, 1, 20, 20],
                        [10, 10, 230, 200]], np.float32)
    masks = cs.ellipse_masks(boxes, (208, 240))
    task = refcoco_mask_task("q", image, (208, 240), boxes, masks, "c")
    full = Extractor(model, cfg, copies_per_chunk=5)
    want = full.extract_task(task)
    ex = Extractor(model, cfg, copies_per_chunk=2, windowed=True,
                   window=[(96, 112), (112, 128), (128, 144)], halo=32)
    got = ex.extract_task(task)
    assert all(n >= 1 for n in ex.route_copies.values()), ex.route_copies
    assert np.isfinite(want[0]).all()
    assert cs.feature_gap(got[0], want[0]) <= cs.WINDOW_TOL
    np.testing.assert_array_equal(got[1], want[1])
    blended = []
    for m, c in zip(masks, task.copy_mask_colors):
        a = m.astype(np.int32)[..., None] * int(c[3])
        blended.append(((np.asarray(c[:3], np.int32) * a
                         + image.astype(np.int32) * (255 - a) + 127) // 255
                        ).astype(np.uint8))
    plain = [dataclasses.replace(task, image_rgb=b, copy_rects=task.copy_rects[:1],
                                 copy_rect_valid=np.zeros((1, 1), bool),
                                 copy_colors_rgba=task.copy_colors_rgba[:1],
                                 copy_masks=None, copy_mask_colors=None)
             for b in blended]
    np.testing.assert_array_equal(cs.host_painted_features(full, plain), want[0])


def test_grouped_conv_paths_agree_and_count(dev):
    """Both of K1's kernels on the same X152-like inputs agree within the
    tolerance, each counted on its own path; the rule sends cpg 4 to the
    CUDA-core kernel and the tensor-core kernel refuses it."""
    x, wt, s, b = _conv_case(dev, 2, 20, 24, 256, 32, seed=1)
    want = reference_grouped_conv3x3(x.float(), wt.float(), s, b, 8, 2, True)
    before = dict(grouped_conv3x3.path_launches)
    for path in ("mma", "simt"):
        _close(launch_grouped_conv3x3(path, x, wt, s, b, 8, 2, True), want, 1e-2)
    assert grouped_conv3x3.path_launches == {k: v + 1 for k, v in before.items()}
    assert conv_path(16, 4) == "simt" and conv_path(2048, 64) == "mma"
    with pytest.raises(ValueError, match="tensor-core"):
        launch_grouped_conv3x3("mma", x[..., :16], wt[:, :, :4, :16], None,
                               None, 4, 1, False)


def test_grouped_conv_mma_takes_misaligned_views(dev):
    x, wt, s, b = _conv_case(dev, 2, 11, 13, 128, 32, seed=2)
    assert torch.equal(grouped_conv3x3(_misaligned(x), _misaligned(wt), s, b, 4,
                                       1, True),
                       grouped_conv3x3(x, wt, s, b, 4, 1, True))


def test_non_bf16_input_raises(dev):
    x = torch.zeros(1, 4, 4, 16, device=dev)
    with pytest.raises(TypeError):
        grouped_conv3x3(x, torch.zeros(3, 3, 4, 16, device=dev), groups=4)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary (a view at storage offset 1)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def test_kernels_take_misaligned_views(dev):
    """The kernels load 16 bytes at a time; a view at an odd storage offset
    gives the same result as an aligned tensor."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(2, 6, 7, 64, generator=g, device=dev).bfloat16()
    wt = torch.randn(3, 3, 8, 64, generator=g, device=dev).bfloat16()
    assert torch.equal(grouped_conv3x3(_misaligned(x), wt, groups=8),
                       grouped_conv3x3(x, wt, groups=8))
    rois = torch.tensor([[0.0, 0, 60, 50], [10, 5, 100, 90]], device=dev)
    assert torch.equal(batched_roi_align(_misaligned(x), rois, 1 / 16.0, 4),
                       batched_roi_align(x, rois, 1 / 16.0, 4))


def test_launch_counters_count_launches(dev):
    before = batched_roi_align.launches
    feats = torch.zeros(1, 4, 4, 8, device=dev, dtype=torch.bfloat16)
    batched_roi_align(feats, torch.tensor([[0.0, 0, 30, 30]], device=dev),
                      1 / 16.0, 2, 0, 8)
    assert batched_roi_align.launches == before + 1


def _nms_inputs(dev, b, k, thr, seed):
    """Boxes with 9 score levels (ties everywhere), a fifth invalid, a
    planted pair at IoU exactly ``thr`` at the top score, and after it a
    chain A > B > C (ties broken by index) with IoU(A, B), IoU(B, C) > thr
    >= IoU(A, C), so that C survives."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, k) if b else (k,)
    xy = torch.rand(*shape, 2, generator=g, device=dev) * 400
    wh = torch.rand(*shape, 2, generator=g, device=dev) * 150 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.randint(0, 9, shape, generator=g, device=dev) / 8.0
    valid = torch.rand(*shape, generator=g, device=dev) > 0.2
    boxes[..., 0, :] = torch.tensor([900.0, 900, 910, 910], device=dev)
    boxes[..., 1, :] = torch.tensor([900.0, 900, 910, 900 + 10 * thr],
                                    device=dev)
    d = 7.5 * (1 - thr) / (1 + thr)   # 0.75 of the shift at IoU = thr
    for q in range(3):
        boxes[..., 2 + q, :] = torch.tensor([950.0 + q * d, 900, 960 + q * d,
                                             910], device=dev)
    scores[..., :5] = 1.0
    valid[..., :5] = True
    return boxes, scores, valid


@pytest.mark.parametrize("b,k,max_out,thr,offset", [
    (None, 300, 100, 0.5, 0.0), (None, 2000, 300, 0.7, 0.0),
    (None, 257, 300, 0.3, 1.0), (9, 300, 32, 0.5, 0.0), (5, 40, 40, 0.3, 0.0),
    (None, 10000, 300, 0.7, 0.0)])
def test_nms_kernel_matches_plain(dev, b, k, max_out, thr, offset):
    """K5 equals the plain loop exactly, slot for slot, on the same f32
    inputs (ties, invalid slots, an exact-threshold pair, a suppression
    chain, K not a multiple of the 64-box chunk, max_out above the number
    of survivors, and K = 10,000, past the mask words a chunk stages in
    shared memory: K has no limit)."""
    boxes, scores, valid = _nms_inputs(dev, b, k, thr, seed=k)
    got = nms_pallas(boxes, scores, valid, thr, max_out, offset)
    want = nms_padded(boxes, scores, valid, thr, max_out, offset)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("path", ["block", "grid"])
@pytest.mark.parametrize("b,k,max_out,thr", [
    (1, 300, 100, 0.5), (7, 300, 300, 0.3), (2, 1500, 300, 0.7),
    (1, 6000, 300, 0.7)])
def test_nms_paths_match_plain(dev, path, b, k, max_out, thr):
    """Each of K5's two paths equals the plain loop on both sides of the
    dispatch rule's cutoff (``nms_path``), so the rule can move without a
    path going unchecked; one launch a call, and the block path takes no
    scratch."""
    from cpt_tpu_torch.ops.nms_pallas import NMS_BLOCK_K, launch_nms, nms_path

    assert nms_path(2, NMS_BLOCK_K) == "block"
    assert nms_path(2, NMS_BLOCK_K + 1) == nms_path(1, 300) == "grid"
    boxes, scores, valid = _nms_inputs(dev, b, k, thr, seed=k + b)
    before = nms_pallas.launches
    got = launch_nms(path, boxes, scores, valid, thr, max_out)
    assert nms_pallas.launches == before + 1
    want = nms_padded(boxes, scores, valid, thr, max_out)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_nms_kernel_ties_and_one_launch_per_batch(dev):
    boxes = torch.tensor([[0.0, 0, 10, 10]], device=dev).repeat(4, 1)
    boxes += torch.arange(4, device=dev)[:, None] * 50.0       # disjoint
    scores = torch.tensor([0.5, 0.9, 0.9, 0.9], device=dev)
    before = nms_pallas.launches
    idx, keep = nms_pallas(boxes[None].repeat(3, 1, 1), scores[None].repeat(3, 1),
                           torch.ones(3, 4, dtype=torch.bool, device=dev), 0.5, 4)
    assert nms_pallas.launches == before + 1
    assert idx.tolist() == [[1, 2, 3, 0]] * 3 and keep.all()


def _flash_inputs(dev, b, h, s, d, bias, seed):
    """q/k/v [b, h, s, d] bf16 with scores of std ≈ 2, and a bias: a
    0/−10000 key bias [b, 1, 1, s] (~20% masked, the last sequence fully
    masked), a finite [b, 1, s, s] bias of std 4, or none."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev) for _ in range(3))
    q = (q * 2).bfloat16()
    if bias == "key":
        kb = torch.where(torch.rand(b, 1, 1, s, generator=g, device=dev) > 0.2,
                         0.0, -10000.0)
        kb[-1] = -10000.0
    elif bias == "3d":
        kb = torch.randn(b, 1, s, s, generator=g, device=dev) * 4
    else:
        kb = None
    return q, k.bfloat16(), v.bfloat16(), kb


@pytest.mark.parametrize("b,h,s,d,bias", [
    (16, 12, 120, 64, "key"), (4, 12, 512, 64, "3d"), (2, 12, 2048, 64, "key"),
    (16, 12, 140, 64, "key"), (3, 2, 37, 64, "key"), (2, 3, 130, 32, "3d"),
    (1, 2, 200, 128, None), (16, 12, 90, 64, "key"), (24, 12, 120, 64, "key"),
    (2, 4, 130, 24, "key"), (2, 4, 178, 80, "3d"), (2, 2, 100, 256, "key"),
    (2, 2, 70, 36, "key"), (1, 1, 90, 512, "3d")])
def test_flash_kernel(dev, b, h, s, d, bias):
    """K6 in bf16 against its plain version in f32 on the same inputs: the
    three main-path shapes and ragged S at head_dim 32/64/128. Uniform
    attention, a dropped bias and a dropped scale miss the tolerance, and
    so does the bias added after the scale where the bias is finite (a
    0/−10000 mask masks in either order)."""
    q, k, v, kb = _flash_inputs(dev, b, h, s, d, bias, seed=s)
    scale = d ** -0.5
    got = flash_mha(q, k, v, kb, sm_scale=scale)
    assert got.shape == (b, h, s, d) and got.dtype == torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    want = reference_flash_mha(qf, kf, vf, kb, sm_scale=scale)
    _close(got, want, 1e-2)
    faults = {"uniform": reference_flash_mha(qf * 0, kf, vf, kb,
                                             sm_scale=scale),
              "no_scale": reference_flash_mha(qf, kf, vf, kb, sm_scale=1.0)}
    if kb is not None:
        faults["no_bias"] = reference_flash_mha(qf, kf, vf, sm_scale=scale)
    if bias == "3d":
        faults["bias_after_scale"] = reference_flash_mha(qf, kf, vf, kb / scale,
                                                         sm_scale=scale)
    if bias == "key" and s % 64:
        faults["edge_unmasked"] = _flash_edge_unmasked(qf, kf, vf, kb, scale)
    if s >= 2048:
        faults["no_rescale"] = _flash_no_rescale(qf, kf, vf, kb, scale)
    assert _attn_faults_missed(want, faults, 1e-2) == []


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", EDGE_S)
def test_flash_kernel_ragged_edges(dev, s, d):
    """K6 against its plain version in f32 at S on both sides of the tile
    edges and at 1020, at each head dim: a key bias with the last sequence
    fully masked at odd S (keys past S entering unmasked then miss the
    tolerance), a finite [b, 1, S, S] bias at even S."""
    bias = "key" if s % 2 else "3d"
    q, k, v, kb = _flash_inputs(dev, 2, 2, s, d, bias, seed=s + d)
    scale = d ** -0.5
    got = flash_mha(q, k, v, kb, sm_scale=scale)
    assert got.shape == (2, 2, s, d) and got.dtype == torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    want = reference_flash_mha(qf, kf, vf, kb, sm_scale=scale)
    _close(got, want, 1e-2)
    if bias == "key" and s % 64:
        assert _attn_faults_missed(want, {"edge_unmasked": _flash_edge_unmasked(
            qf, kf, vf, kb, scale)}, 1e-2) == []


@pytest.mark.parametrize("s,d", [(77, 64), (5, 32), (1020, 128)])
def test_flash_kernel_takes_strided_views(dev, s, d):
    """q/k/v as the model passes them (head-transposed views of one packed
    projection) and a misaligned copy give the same result as contiguous
    tensors, within tolerance of the plain version with the last sequence
    fully masked; the output is a [B, H, S, D] view of a [B, S, H, D]
    buffer."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, h = 2, 3
    proj = torch.randn(b, s, 3, h, d, generator=g, device=dev).bfloat16()
    q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    kb = torch.where(torch.rand(b, 1, 1, s, generator=g, device=dev) > 0.2,
                     0.0, -10000.0).bfloat16()
    kb[-1] = -10000.0
    want = flash_mha(q.contiguous(), k.contiguous(), v.contiguous(), kb,
                     sm_scale=0.125)
    _close(want, reference_flash_mha(q.float(), k.float(), v.float(), kb,
                                     sm_scale=0.125), 1e-2)
    assert torch.equal(flash_mha(q, k, v, kb, sm_scale=0.125), want)
    assert torch.equal(flash_mha(_misaligned(q.contiguous()), k, v, kb,
                                 sm_scale=0.125), want)
    assert want.transpose(1, 2).is_contiguous()


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    """f32 input and q, k, v of different shapes are refused; every head
    dim runs (48 on the tile, 36 on the CUDA-core kernel)."""
    q = torch.zeros(1, 2, 16, 64, device=dev)
    with pytest.raises(TypeError):
        flash_mha(q, q, q, sm_scale=0.125)
    q = torch.zeros(1, 2, 16, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(KernelError, match="share one"):
        flash_mha(q, q, q[..., :32], sm_scale=0.125)
    for d in (48, 36):
        q = torch.zeros(1, 2, 16, d, device=dev, dtype=torch.bfloat16)
        assert flash_mha(q, q, q, sm_scale=0.125).shape == q.shape


def test_flash_launch_counter_counts(dev):
    q = torch.zeros(2, 2, 70, 64, device=dev, dtype=torch.bfloat16)
    before = flash_mha.launches
    flash_mha(q, q, q, torch.zeros(2, 1, 1, 70, device=dev), sm_scale=0.125)
    assert flash_mha.launches == before + 1


@pytest.mark.parametrize("b,h,s,d,bias", [
    (3, 2, 37, 64, "key"), (2, 3, 130, 32, "3d"), (1, 2, 200, 128, None),
    (2, 3, 300, 64, "3d"), (16, 12, 140, 64, "key"), (16, 12, 90, 64, "key"),
    (24, 12, 120, 64, "key"), (16, 12, 120, 64, "key"), (2, 4, 130, 24, "key"),
    (2, 4, 178, 80, "3d"), (2, 2, 100, 256, "key"), (2, 2, 70, 36, "key"),
    (1, 1, 90, 512, "3d")])
def test_flash_backward_kernels(dev, b, h, s, d, bias):
    """K6b (dK, dV) and K6c (dQ) through ``flash_mha``'s autograd in bf16
    against the plain backward in f32 on the same inputs, within 2e-2 of
    each gradient's scale; dropping di or the 1/l normalisation misses,
    and so does a 3-D bias read transposed (random, so asymmetric), which
    K6b's transposed scores would read by a slip of its indices."""
    q, k, v, kb = _flash_inputs(dev, b, h, s, d, bias, seed=s + 1)
    g = torch.Generator(device=dev).manual_seed(s)
    do = torch.randn(b, h, s, d, generator=g, device=dev).bfloat16()
    scale = d ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_mha_bwd_dkv.launches, flash_mha_bwd_dq.launches)
    got = torch.autograd.grad(flash_mha(*leaves, kb, sm_scale=scale), leaves, do)
    assert (flash_mha_bwd_dkv.launches, flash_mha_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    want = reference_flash_mha_bwd(qf, kf, vf, kb, dof, sm_scale=scale)
    for got_i, want_i in zip(got, want):
        assert got_i.dtype == torch.bfloat16 and got_i.shape == (b, h, s, d)
        _close(got_i, want_i, 2e-2)
    # the faults through the plain versions (CPU tensors take them)
    cpu = [None if t is None else t.cpu() for t in (qf, kf, vf, kb, dof)]
    o, m, l = flash_mha_fwd(*cpu[:4], sm_scale=scale, stats=True)
    di = (o * cpu[4]).sum(-1)
    no_di = flash_mha_bwd_dq(*cpu, m, l, torch.zeros_like(di), sm_scale=scale)
    no_l = flash_mha_bwd_dq(*cpu, m, torch.ones_like(l), di, sm_scale=scale)
    assert _attn_faults_missed(want[0].cpu(), {"no_di": no_di, "no_l": no_l},
                               2e-2) == []
    if bias == "3d":
        swapped = reference_flash_mha_bwd(qf, kf, vf, kb.transpose(-1, -2), dof,
                                          sm_scale=scale)
        assert any(_attn_faults_missed(w, {"bias_transposed": x}, 2e-2) == []
                   for x, w in zip(swapped, want))


def test_flash_backward_finite_at_huge_scores(dev):
    """Scores of ~1e17, as layer 0 of Oscar-base gets them from a random
    detector's features: K6b/K6c recompute the scores in another order
    than K6's tensor cores, and an ulp of excess over the saved row max
    must not overflow exp(); every gradient stays finite."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = ((torch.randn(2, 3, 120, 64, generator=g, device=dev) * 3e8
                ).bfloat16().requires_grad_() for _ in range(3))
    do = (torch.randn(2, 3, 120, 64, generator=g, device=dev) * 1e-11).bfloat16()
    kb = torch.where(torch.rand(2, 1, 1, 120, generator=g, device=dev) > 0.2,
                     0.0, -10000.0)
    grads = torch.autograd.grad(flash_mha(q, k, v, kb, sm_scale=0.125),
                                (q, k, v), do)
    assert all(torch.isfinite(t).all() for t in grads)


def test_flash_backward_rejects_a_bias_gradient(dev):
    q = torch.zeros(1, 2, 16, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    bias = torch.zeros(1, 1, 1, 16, device=dev, requires_grad=True)
    with pytest.raises(KernelError, match="bias gradient"):
        torch.autograd.grad(flash_mha(q, q, q, bias, sm_scale=0.125).sum(), q)


def test_flash_train_step_launches(dev):
    """One full-width prompt-tuning step (Oscar-base under "flash" with
    attention dropout 0, batch 4 of 70 text + 50 region slots): K6, K6b and
    K6c launch once a layer, K3 and K4 not at all (hidden dropout is on),
    and the loss is finite."""
    from cpt_tpu_torch.config.bert import OSCAR_BASE
    from cpt_tpu_torch.engine import train
    from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
    from cpt_tpu_torch.utils import convert

    cfg = dataclasses.replace(OSCAR_BASE, attention_impl="flash",
                              attention_probs_dropout_prob=0.0)
    with torch.device(dev):
        model = REC_MLM_CPT(cfg, torch.bfloat16)
    model.load_state_dict(convert.state_from_reference(
        convert.random_oscar_state_dict(cfg, seed=0), cfg))
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(1000, 30000, (4, 70), generator=g, device=dev)
    mask = torch.ones(4, 120, dtype=torch.long, device=dev)
    mask[1, 60:70] = 0
    feats = torch.rand(4, 50, 2054, generator=g, device=dev)
    batch = (ids, torch.zeros_like(ids), mask, feats,
             torch.tensor([5, 9, 3, 7], device=dev),
             torch.tensor([2417, 3904, -1, 2417], device=dev))
    tx = train.build_optimizer(model, train.OptimConfig(warmup_steps=0))
    step = train.make_mlm_train_step(model, tx)
    counters = (flash_mha, flash_mha_bwd_dkv, flash_mha_bwd_dq,
                fused_attention_block, fused_ffn)
    before = [fn.launches for fn in counters]
    _, loss = step(train.create_train_state(model, tx), batch, g)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert [fn.launches - n for fn, n in zip(counters, before)] == [12, 12, 12, 0, 0]


# --- the W8A8 path: K1q, the _int_mm route, K7 -----------------------------------

def _int8(g, dev, *shape):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("n,h,w,c,groups,stride", [
    (2, 9, 13, 256, 32, 1), (2, 9, 13, 256, 32, 2), (3, 14, 14, 128, 2, 2),
    (1, 5, 7, 64, 16, 1), (2, 10, 10, 1024, 32, 2), (2, 19, 37, 512, 32, 1),
    (2, 19, 37, 512, 32, 2), (3, 33, 17, 192, 12, 1), (1, 7, 7, 2048, 32, 1),
    (2, 14, 14, 2048, 32, 2), (1, 5, 9, 64, 8, 2), (2, 20, 24, 1024, 32, 1)])
def test_grouped_conv_int8_kernel(dev, n, h, w, c, groups, stride):
    """K1q against its plain version on the same int8 inputs, on the path
    the rule names (the int8 tensor-core kernel at cpg 8, 16, 32 and 64 on
    ragged maps, maps of at most 64 output pixels and several groups in a
    slice; the ``__dp4a`` kernel at cpg 4): exact sums and the same
    two-rounding epilogue, so equal bit for bit. The weights' channels
    swapped within their groups and each of ``chip_smoke.K1Q_FAULTS``
    (the last k32 step dropped; at stride 2 the centre tap's columns read
    one pair early) change the result."""
    import chip_smoke as cs
    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3_int8,
                                                reference_grouped_conv3x3_int8)

    g = torch.Generator(device=dev).manual_seed(11)
    xq, wq = _int8(g, dev, n, h, w, c), _int8(g, dev, 3, 3, c // groups, c)
    scale = torch.rand(c, generator=g, device=dev) * 1e-3
    bias = torch.randn(c, generator=g, device=dev)
    path = conv_path(c, c // groups)
    before = dict(grouped_conv3x3_int8.path_launches)
    total = grouped_conv3x3_int8.launches
    got = grouped_conv3x3_int8(xq, wq, scale, bias, groups, stride, True)
    assert grouped_conv3x3_int8.launches == total + 1
    assert grouped_conv3x3_int8.path_launches == {
        k: v + (k == path) for k, v in before.items()}
    want = reference_grouped_conv3x3_int8(xq, wq, scale, bias, groups, stride,
                                          True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not torch.equal(got, reference_grouped_conv3x3_int8(
        xq, wq.flip(3), scale, bias, groups, stride, True))
    for fault in cs.K1Q_FAULTS:
        if fault == "stride2_column_order" and stride != 2:
            continue
        wrong = cs.k1q_with_fault(xq, wq, scale, bias, groups, stride, fault)
        assert not torch.equal(got, wrong.bfloat16()), fault


def test_grouped_conv_int8_paths_agree_and_count(dev):
    """Both of K1q's kernels on the same inputs equal the plain version bit
    for bit, each counted on its own path."""
    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3_int8,
                                                launch_grouped_conv3x3_int8,
                                                reference_grouped_conv3x3_int8)

    g = torch.Generator(device=dev).manual_seed(14)
    xq, wq = _int8(g, dev, 2, 20, 24, 256), _int8(g, dev, 3, 3, 8, 256)
    scale = torch.rand(256, generator=g, device=dev) * 1e-3
    bias = torch.randn(256, generator=g, device=dev)
    before = dict(grouped_conv3x3_int8.path_launches)
    for stride in (1, 2):
        want = reference_grouped_conv3x3_int8(xq, wq, scale, bias, 32, stride, True)
        for path in ("mma", "simt"):
            assert torch.equal(launch_grouped_conv3x3_int8(
                path, xq, wq, scale, bias, 32, stride, True), want), (path, stride)
    assert grouped_conv3x3_int8.path_launches == {k: v + 2 for k, v in before.items()}
    with pytest.raises(ValueError, match="tensor-core"):
        launch_grouped_conv3x3_int8("mma", xq[..., :16], wq[:, :, :4, :16],
                                    scale[:16], bias[:16], 4, 1, False)


def test_grouped_conv_int8_rejects(dev):
    from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3_int8

    g = torch.Generator(device=dev).manual_seed(12)
    ones = torch.ones(8, device=dev)
    with pytest.raises(ValueError):
        grouped_conv3x3_int8(_int8(g, dev, 1, 4, 4, 8), _int8(g, dev, 3, 3, 4, 8),
                             ones, ones, 2)
    ones = torch.ones(64, device=dev)
    with pytest.raises(TypeError):
        grouped_conv3x3_int8(_int8(g, dev, 1, 4, 4, 64), _int8(g, dev, 3, 3, 4, 64),
                             ones, ones, 16, out_dtype=torch.float32)


@pytest.mark.parametrize("kernel,cin,cout,stride,padding", [
    (1, 256, 64, 1, 0), (1, 512, 1024, 2, 0), (7, 3, 64, 2, 3)])
def test_int8_conv_dense_route(dev, kernel, cin, cout, stride, padding):
    """``int8_conv``'s card route (``torch._int_mm``; the stem with K padded
    to 152) equals the exact conv bit for bit."""
    from cpt_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(2, 24, 20, cin, generator=g, device=dev).bfloat16()
    w = torch.randn(kernel, kernel, cin, cout, generator=g, device=dev) * 0.05
    s = torch.rand(cout, generator=g, device=dev) + 0.5
    b = torch.randn(cout, generator=g, device=dev)
    qx = quant.quant_act(x)
    got = quant.int8_conv(qx, w, stride, padding, 1, s, b, True)
    cpu = quant.int8_conv(quant.QuantTensor(qx.data.cpu(), qx.scale.cpu()),
                          w.cpu(), stride, padding, 1, s.cpu(), b.cpu(), True)
    assert torch.equal(got.cpu(), cpu)
    with pytest.raises(ValueError, match="M > 16"):
        quant.int8_conv(quant.quant_act(x[:1, :4, :4]), w, 1, padding, 1)


def _k7_args(dev, m, h, f, seed):
    from cpt_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = (r(m, h) * torch.linspace(0.5, 4.0, m, device=dev)[:, None]).bfloat16()
    q1 = quant.quant_ffn_weights(r(h, f, scale=0.05))
    q2 = quant.quant_ffn_weights(r(f, h, scale=0.05))
    return (x, q1.data, q1.scale, r(f, scale=0.1), q2.data, q2.scale,
            r(h, scale=0.1), torch.rand(h, generator=g, device=dev) + 0.5,
            r(h, scale=0.1))


@pytest.mark.parametrize("m,h,f,tm", [(256, 128, 512, 128), (512, 256, 1024, 256),
                                      (1024, 768, 3072, 512), (2048, 768, 3072, 1024),
                                      (256, 1024, 384, 128)])
def test_ffn_int8_kernel(dev, m, h, f, tm):
    """K7 in bf16 against its plain version in f32 on the same inputs, at
    clusters of 1-8 blocks (H 128-1024) and tiles of 1-8 row blocks."""
    from cpt_tpu_torch.ops import quant

    args = _k7_args(dev, m, h, f, m)
    before = quant.ffn_int8.launches
    got = quant.ffn_int8(*args, tm)
    assert quant.ffn_int8.launches == before + 1
    want = quant.reference_ffn_int8(args[0].float(), *args[1:], tm)
    _close(got, want, 1e-2)
    # one scale for all of M (x's rows range 0.5x..4x) would not pass
    whole = quant.reference_ffn_int8(args[0].float(), *args[1:], m)
    assert _attn_faults_missed(want, {"whole": whole}, 1e-2) == []


def test_ffn_int8_faults_miss(dev):
    """K7 on ``chip_smoke.k7_inputs`` (tiles whose ranges differ 8×,
    weight columns spread 8×) within 1e-2 of scale of its plain version,
    and each of ``chip_smoke.K7_FAULTS`` misses that; the CPU test
    ``test_torch_int8_tiles.py`` shows the same faults missing at this
    shape and seed with the plain version."""
    import chip_smoke as cs
    from cpt_tpu_torch.ops import quant

    m, h, f, tm = cs.K7_FAULT_SHAPE
    x, w1, w2, b1, b2, gamma, beta = (torch.from_numpy(a).to(dev)
                                      for a in cs.k7_inputs(m, h, f, seed=0))
    x = x.bfloat16()
    q1, q2 = quant.quant_ffn_weights(w1), quant.quant_ffn_weights(w2)
    args = (x, q1.data, q1.scale, b1, q2.data, q2.scale, b2, gamma, beta)
    got = quant.ffn_int8(*args, tm)
    want = quant.reference_ffn_int8(x.float(), *args[1:], tm)
    _close(got, want, 1e-2)
    faults = {fault: cs.ffn_int8_with_fault(x, w1, b1, w2, b2, gamma, beta, tm,
                                            fault) for fault in cs.K7_FAULTS}
    assert _attn_faults_missed(want, faults, 1e-2) == []


def test_ffn_int8_rejects(dev):
    from cpt_tpu_torch.ops import quant

    args = _k7_args(dev, 256, 128, 512, 3)
    with pytest.raises(ValueError):
        quant.ffn_int8(*args, 64)                      # tm % 128
    for width in (192, 1152):                          # H % 128, a cluster of 9
        wide = _k7_args(dev, 256, width, 512, 4)
        with pytest.raises(ValueError):
            quant.ffn_int8(*wide, 128)
