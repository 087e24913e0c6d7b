"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card, at small shapes that exercise the ragged edges (odd widths, stride
2, S not a multiple of the query tile, M not a multiple of the row tile).

These need the card: they skip where CUDA is unavailable. On the card:

    python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import pytest
import torch

from cpt_tpu_torch.kernels.gemm import attention_core
from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                               reference_attention_block,
                                               reference_attention_core)
from cpt_tpu_torch.ops.fused_ffn import fused_ffn, reference_ffn
from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3,
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
def test_roi_align_kernel(dev, sampling):
    g = torch.Generator(device=dev).manual_seed(1)
    feats = torch.randn(3, 11, 17, 64, generator=g, device=dev).bfloat16()
    rois = torch.tensor([[0, 0, 400, 300], [-50, -40, 900, 700],
                         [30.5, 20.25, 31, 21], [100, 60, 250, 170],
                         [260, 170, 280, 190]], device=dev)
    got = batched_roi_align(feats, rois, 1 / 16.0, 7, sampling, 8)
    want = batched_roi_align_plain(feats.float(), rois, 1 / 16.0, 7,
                                   sampling, 8)
    _close(got, want, 1e-2)


def _attn_faults_missed(want, faults, frac):
    """Names of the faulty references that land within ``frac`` of
    ``want``'s scale, i.e. that the check could not tell from the kernel."""
    tol = frac * float(want.float().abs().max())
    return [name for name, f in faults.items()
            if not float((f.float() - want.float()).abs().max()) > tol]


@pytest.mark.parametrize("s_len", [37, 120])
def test_attention_kernel(dev, s_len):
    """The whole sub-block, with projections scaled so the scores spread
    (std ≈ 2): uniform attention or a dropped mask misses the tolerance."""
    g = torch.Generator(device=dev).manual_seed(2)
    b, h, heads = 3, 256, 4

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    kb = torch.where(torch.rand(b, s_len, generator=g, device=dev) > 0.3,
                     0.0, -10000.0)
    kb[-1] = -10000.0
    args = [r(b, s_len, h, scale=0.5).bfloat16(),
            r(h, 3 * h, scale=0.18).bfloat16(), r(3 * h, scale=0.02),
            r(h, h, scale=0.05).bfloat16(), r(h, scale=0.02),
            torch.rand(h, generator=g, device=dev) + 0.5, r(h, scale=0.1), kb]
    got = fused_attention_block(*args, heads, 1e-12)
    fargs = [a.float() for a in args]
    want = reference_attention_block(*fargs, num_heads=heads, eps=1e-12)
    _close(got, want, 2e-2)
    no_q = [a.clone() for a in fargs]
    no_q[1][:, :h] = 0.0
    no_q[2][:h] = 0.0
    faults = {"uniform": reference_attention_block(*no_q, num_heads=heads,
                                                   eps=1e-12),
              "no_mask": reference_attention_block(
                  *fargs[:7], torch.zeros_like(kb), num_heads=heads,
                  eps=1e-12)}
    assert _attn_faults_missed(want, faults, 2e-2) == []


@pytest.mark.parametrize("s_len", [37, 120])
def test_attention_core_kernel(dev, s_len):
    """The attention core alone against softmax(QKᵀ·scale + key_bias)·V in
    f32 on the same packed projection (std 1.5, so scores have std ≈ 2)."""
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
    no_q = qkv.clone()
    no_q[..., :h] = 0
    faults = {"uniform": reference_attention_core(no_q, kb, heads, scale),
              "no_mask": reference_attention_core(qkv, torch.zeros_like(kb),
                                                  heads, scale),
              "no_scale": reference_attention_core(qkv, kb, heads, 1.0)}
    assert _attn_faults_missed(want, faults, 1e-2) == []


@pytest.mark.parametrize("approximate", [False, True])
def test_ffn_kernel(dev, approximate):
    g = torch.Generator(device=dev).manual_seed(3)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    args = [r(2, 37, 256, scale=0.5).bfloat16(), r(256, 1024, scale=0.05).bfloat16(),
            r(1024, scale=0.1), r(1024, 256, scale=0.05).bfloat16(),
            r(256, scale=0.1), torch.rand(256, generator=g, device=dev) + 0.5,
            r(256, scale=0.1)]
    got = fused_ffn(*args, approximate=approximate)
    want = reference_ffn(*[a.float() for a in args], 1e-12, approximate)
    _close(got, want, 3e-2)


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
