"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card, at small shapes that exercise the ragged edges (odd widths, stride
2, S not a multiple of the query tile, M not a multiple of the row tile).

These need the card: they skip where CUDA is unavailable. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import dataclasses

import pytest
import torch

from cpt_tpu_torch.kernels.gemm import attention_core
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


def _nms_inputs(dev, b, k, thr, seed):
    """Boxes with 9 score levels (ties everywhere), a fifth invalid, and a
    planted pair at IoU exactly ``thr`` at the top score."""
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
    scores[..., :2] = 1.0
    valid[..., :2] = True
    return boxes, scores, valid


@pytest.mark.parametrize("b,k,max_out,thr,offset", [
    (None, 300, 100, 0.5, 0.0), (None, 2000, 300, 0.7, 0.0),
    (None, 257, 300, 0.3, 1.0), (9, 300, 32, 0.5, 0.0), (5, 40, 40, 0.3, 0.0)])
def test_nms_kernel_matches_plain(dev, b, k, max_out, thr, offset):
    """K5 equals the plain loop exactly, slot for slot, on the same f32
    inputs (ties, invalid slots, an exact-threshold pair, K not a multiple
    of the block, max_out above the number of survivors)."""
    boxes, scores, valid = _nms_inputs(dev, b, k, thr, seed=k)
    got = nms_pallas(boxes, scores, valid, thr, max_out, offset)
    want = nms_padded(boxes, scores, valid, thr, max_out, offset)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
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


def test_nms_kernel_rejects_k_too_large(dev):
    k = 10000            # 240 KB of boxes, areas and scores: above a block's
    with pytest.raises(ValueError, match="shared"):
        nms_pallas(torch.zeros(k, 4, device=dev), torch.zeros(k, device=dev),
                   torch.ones(k, dtype=torch.bool, device=dev), 0.5, 10)


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
    (3, 2, 37, 64, "key"), (2, 3, 130, 32, "3d"), (1, 2, 200, 128, None)])
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
    assert _attn_faults_missed(want, faults, 1e-2) == []


def test_flash_kernel_takes_strided_views(dev):
    """q/k/v as the model passes them (head-transposed views of one packed
    projection) and a misaligned copy give the same result as contiguous
    tensors; the output is a [B, H, S, D] view of a [B, S, H, D] buffer."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, s, h, d = 2, 77, 3, 64
    proj = torch.randn(b, s, 3, h, d, generator=g, device=dev).bfloat16()
    q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    kb = torch.where(torch.rand(b, 1, 1, s, generator=g, device=dev) > 0.2,
                     0.0, -10000.0).bfloat16()
    want = flash_mha(q.contiguous(), k.contiguous(), v.contiguous(), kb,
                     sm_scale=0.125)
    assert torch.equal(flash_mha(q, k, v, kb, sm_scale=0.125), want)
    assert torch.equal(flash_mha(_misaligned(q.contiguous()), k, v, kb,
                                 sm_scale=0.125), want)
    assert want.transpose(1, 2).is_contiguous()


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 2, 16, 64, device=dev)
    with pytest.raises(TypeError):
        flash_mha(q, q, q, sm_scale=0.125)
    q = torch.zeros(1, 2, 16, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_mha(q, q, q, sm_scale=0.125)


def test_flash_launch_counter_counts(dev):
    q = torch.zeros(2, 2, 70, 64, device=dev, dtype=torch.bfloat16)
    before = flash_mha.launches
    flash_mha(q, q, q, torch.zeros(2, 1, 1, 70, device=dev), sm_scale=0.125)
    assert flash_mha.launches == before + 1


@pytest.mark.parametrize("b,h,s,d,bias", [
    (3, 2, 37, 64, "key"), (2, 3, 130, 32, "3d"), (1, 2, 200, 128, None)])
def test_flash_backward_kernels(dev, b, h, s, d, bias):
    """K6b (dK, dV) and K6c (dQ) through ``flash_mha``'s autograd in bf16
    against the plain backward in f32 on the same inputs, within 2e-2 of
    each gradient's scale; dropping di or the 1/l normalisation misses."""
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


def test_flash_backward_rejects_a_bias_gradient(dev):
    q = torch.zeros(1, 2, 16, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    bias = torch.zeros(1, 1, 1, 16, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="bias gradient"):
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
