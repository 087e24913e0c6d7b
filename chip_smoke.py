#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``cpt_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py [--json details.json]

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``cpt_tpu_torch/csrc`` (nvcc);
3. hold each kernel (K1 grouped conv, K2 RoIAlign, K3 attention block and
   its attention core alone, K4 FFN block, K6 flash attention, K6b/K6c its
   backward) in bf16 against its plain PyTorch version in f32 on the same
   inputs, and K5 (greedy NMS) against its plain version exactly on the
   same f32 inputs, at the main paths' shapes; time each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call (a yardstick the port never calls) with CUDA events, and compute
   each one's bound (the least time for its bytes and operations at the
   card's published peaks);
4. at full width (VinVL X152-C4 + Oscar-base, random weights from a seed in
   the reference layouts) answer 3 grounding requests through
   ``cpt_predict.predict`` with given candidates, then 3 ``--detect``
   requests whose candidates the detector proposes, then the 3 grounding
   requests again with an Oscar-base built with ``attention_impl="flash"``
   beside the same detector (same boxes, scores within tolerance, K6 12
   launches a scoring batch, K3 none), then one long-context
   ``BertImgModel`` forward under ``"flash"`` (batch 4, 70 text tokens + 950
   regions) against the einsum path in f32; check that every kernel of each
   path ran on it;
5. few-shot prompt tuning at full width: extract stage-1 features of 16
   grounding queries with the resident detector, then train Oscar-base
   under ``attention_impl="flash"`` (attention dropout 0, hidden dropout
   0.1) through ``refcoco_cpt.train`` for 20 steps of batch 32 (K6, K6b and
   K6c 12 launches a step, K3 and K4 none); hold one step's gradients and a
   10-step loss curve (dropout off) against the f32 einsum path; then 3
   deterministic steps under ``"auto"`` (K3 and K4 12 a step, their
   backward the plain VJP).

The last two lines of standard output are a JSON summary of the kernels
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances of each kernel in bf16 against its plain version in f32 on the
# same bf16 inputs (cuDNN/cuBLAS with TF32 off), as a fraction of the
# reference's largest magnitude. bf16 keeps 8 bits (relative rounding
# 2^-9 ≈ 0.2%); K1/K2 round once (the output), the attention core twice
# (probabilities, context), K3/K4 three to four times.
TOL = {"K1": 1e-2, "K2": 1e-2, "K3": 2e-2, "K3 core": 1e-2, "K4": 2e-2,
       "K6": 1e-2}
# K6b/K6c: of each gradient's largest magnitude; bf16 rounds p and ds before
# three products, and dq, dk, dv once more
BWD_TOL = 2e-2
# Full-width request checks, as a fraction of the reference's largest
# magnitude. The long-context flash forward (bf16) against the einsum path
# (f32): twelve layers of bf16 rounding (2^-9 each, several per layer).
# Candidate scores (bf16 paths against each other and against the einsum
# path in f32): a score is the reference's ratio of two raw MLM logits,
# logit[color] / logit["none"], and with these weights the logits are
# ~0.5 in size while twelve bf16 layers leave each with an error of a few
# hundredths (0.036-0.042 at full width on the CPU, for the "auto", flash
# and einsum paths alike), so a ratio moves by up to ~15%. The f32 path
# runs on the matrices and tables rounded to bf16, as the bf16 paths
# compute with them (``rebuilt_scorer``).
SCORE_TOL = 0.15
LONG_TOL = 5e-2
# Phase 5, one step's gradients (flash path in bf16 against the einsum path
# in f32, same weights and batch, dropout off), as the largest per-tensor
# ‖g − g_f32‖ / ‖g_f32‖, on grad_gap's synthetic batch (32 sequences, seed
# 0) and the resident's weights. Derived from the plain path's own
# bf16-vs-f32 gap at full width on the CPU (`python -m
# cpt_tpu_torch.tools.grad_gap --batch 32 --seed 0`, and `--seed 1`):
# 1.243e-2 and 1.411e-2; the flash path there sits at 1.246e-2 and
# 1.371e-2, the flash path with K6b's dK zeroed at 0.106 and 0.113. 4e-2
# is 2.8x the larger plain gap and 2.6x below the fault's.
GRAD_TOL = 4e-2
# Phase 5, losses of 10 deterministic AdamW steps (lr 2.5e-5, one warmup
# step) on grad_gap's two synthetic batches, flash bf16 against einsum f32,
# in nats. The same CPU run: the losses fall from 10.81 to 3.39 and the
# plain path in bf16 stays within 7.6e-3 of the f32 path at every step
# (the flash path within 8.1e-3). 2.5e-2 is 3.3x the plain gap.
LOSS_TOL = 2.5e-2

# One H100 SXM's published peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BYTES_S, BF16_OPS_S, F32_OPS_S = 3.35e12, 989e12, 67e12

KERNELS = {
    "K1": ("grouped_conv3x3", "cpt_tpu_torch/csrc/grouped_conv.cu",
           "cpt_tpu/ops/grouped_conv.py:418"),
    "K2": ("batched_roi_align", "cpt_tpu_torch/csrc/roi_align.cu",
           "cpt_tpu/ops/roi_align_pallas.py:92"),
    "K3": ("fused_attention_block", "cpt_tpu_torch/csrc/attention.cu",
           "cpt_tpu/ops/fused_attention.py:121"),
    "K4": ("fused_ffn", "cpt_tpu_torch/csrc/gemm.cu",
           "cpt_tpu/ops/fused_ffn.py:113"),
    "K5": ("nms_pallas", "cpt_tpu_torch/csrc/nms.cu",
           "cpt_tpu/ops/nms_pallas.py:92"),
    "K6": ("flash_mha", "cpt_tpu_torch/csrc/flash_attention.cu",
           "cpt_tpu/ops/attention.py:70"),
    "K6b": ("flash_mha_bwd_dkv", "cpt_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "K6c": ("flash_mha_bwd_dq", "cpt_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its peak for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, label: str, kernel, plain, exact, rows: list,
            faults: dict | None = None, work: tuple = (0, 0, BF16_OPS_S),
            library=None) -> None:
    """Check the kernel's max |Δ| against ``exact()`` (the plain version in
    f32 on the same inputs) within the tolerance, then time the kernel,
    ``plain()`` (the plain version in the kernel's dtype) and ``library()``
    (one PyTorch call computing the same function, or None) over their own
    loops of launches. ``faults`` maps a named fault (uniform attention, a
    dropped mask, ...) to the reference computed with that fault: each must
    miss the tolerance, which shows the check can fail. ``work`` is
    (bytes moved, operations, peak operations/s of their type) for the
    bound."""
    import torch

    got = kernel()
    want = exact()
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name} {label}: non-finite output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = TOL[name] * max(scale, 1e-3)
    fault_errs = {f: float((fn().float() - want).abs().max())
                  for f, fn in (faults or {}).items()}
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    library_ms = None if library is None else cuda_ms(library)
    bound_ms, bound_by = bound(*work)
    rows.append({"kernel": name, "shape": label, "max_abs_err": err,
                 "tol": tol, "max_abs_ref": scale, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "fault_errs": fault_errs})
    faults_txt = "".join(f" {f}={e:.3e} ({e / tol:.1f}x tol)"
                         for f, e in fault_errs.items())
    lib_txt = "" if library_ms is None else f" library_ms={library_ms:.4f}"
    print(f"{name} {label}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"({tol / max(err, 1e-30):.1f}x err) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}{lib_txt} bound_ms={bound_ms:.4f} "
          f"({bound_by}){faults_txt}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")
    caught = [f for f, e in fault_errs.items() if not e > tol]
    if caught:
        raise AssertionError(f"{name} {label}: the check would pass {caught}")


def check_kernels(rows: list) -> dict:
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.kernels.gemm import attention_core
    from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                                   reference_attention_block,
                                                   reference_attention_core)
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn, reference_ffn
    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3,
                                                reference_grouped_conv3x3)
    from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                    batched_roi_align_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def f32(args):
        return [a.float() for a in args]

    # K1 at the X152 bottleneck shapes of an 8-copy request on the
    # 640×1024 canvas (stage 5 at 8 copies × 8 RoIs)
    for n, h, w, c, stride in [(8, 160, 256, 256, 1), (8, 160, 256, 512, 2),
                               (8, 80, 128, 512, 1), (8, 80, 128, 1024, 2),
                               (8, 40, 64, 1024, 1), (64, 14, 14, 2048, 2),
                               (64, 7, 7, 2048, 1)]:
        groups = 32
        x = torch.relu(randn(n, h, w, c))
        wt = randn(3, 3, c // groups, c, scale=0.05)
        s = torch.rand(c, generator=g, device=dev) + 0.5
        b = randn(c, scale=0.1, dtype=torch.float32)
        out_px = n * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)       # channels-last NCHW view
        compare("K1", f"x=[{n},{h},{w},{c}] cpg={c // groups} stride={stride}",
                lambda: grouped_conv3x3(x, wt, s, b, groups, stride, True),
                lambda: reference_grouped_conv3x3(x, wt, s, b, groups, stride,
                                                  True),
                lambda: reference_grouped_conv3x3(x.float(), wt.float(), s, b,
                                                  groups, stride, True), rows,
                work=(nbytes(x, wt, s, b) + out_px * c * 2,
                      2 * out_px * c * 9 * (c // groups), BF16_OPS_S),
                library=lambda: F.conv2d(x_nchw, w_oihw, stride=stride,
                                         padding=1, groups=groups))

    # K2 on the C4 map of 8 copies at 640×1024; the first RoI is wider
    # than the canvas so its grid hits the 8-sample cap
    feats = randn(8, 40, 64, 1024)
    for n_rois in (8, 32):
        rng = np.random.RandomState(n_rois)
        xy = rng.uniform(0, 600, (n_rois, 2))
        wh = rng.uniform(16, 420, (n_rois, 2))
        rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        rois[0] = [-300.0, -200.0, 1500.0, 1000.0]
        rois_t = torch.from_numpy(rois).to(dev)
        # adaptive grid: ceil(bin) samples a side, capped at 8; each sample
        # is 4 bilinear taps (a multiply-add each) for every channel
        bins = np.maximum((rois[:, 2:] - rois[:, :2]) / 16.0, 1.0) / 14
        samples = np.clip(np.ceil(bins), 1, 8).prod(1).sum()
        compare("K2", f"feats=[8,40,64,1024] rois={n_rois}",
                lambda: batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8),
                lambda: batched_roi_align_plain(feats, rois_t, 1 / 16.0, 14,
                                                0, 8),
                lambda: batched_roi_align_plain(feats.float(), rois_t,
                                                1 / 16.0, 14, 0, 8), rows,
                work=(nbytes(feats, rois_t) + 8 * n_rois * 14 * 14 * 1024 * 2,
                      8 * 1024 * 14 * 14 * samples * 4 * 2, F32_OPS_S))

    # K3 at the scoring shape: 16 sequences of 70 text + 50 region slots,
    # and S = 128; the last sequence has every key masked. The projections
    # are scaled so the scores spread (std ≈ 2): softmax is far from
    # uniform, so uniform attention or a dropped mask misses the tolerance.
    hdim, heads = 768, 12
    scale = 1.0 / (hdim // heads) ** 0.5
    for s_len in (120, 128):
        x = randn(16, s_len, hdim, scale=0.5)
        keep = torch.rand(16, s_len, generator=g, device=dev) > 0.3
        keep[-1] = False
        kb = torch.where(keep, 0.0, -10000.0).float()
        args = [x, randn(hdim, 3 * hdim, scale=0.1),
                randn(3 * hdim, scale=0.02, dtype=torch.float32),
                randn(hdim, hdim, scale=0.03),
                randn(hdim, scale=0.02, dtype=torch.float32),
                torch.rand(hdim, generator=g, device=dev) + 0.5,
                randn(hdim, scale=0.1, dtype=torch.float32), kb]
        no_q = f32(args)
        no_q[1][:, :hdim] = 0.0
        no_q[2][:hdim] = 0.0
        no_mask = f32(args)
        no_mask[7] = torch.zeros_like(kb)

        def block_ref(a):
            return lambda: reference_attention_block(*a, num_heads=heads,
                                                     eps=1e-12)

        tokens = 16 * s_len
        compare("K3", f"x=[16,{s_len},768] heads=12",
                lambda: fused_attention_block(*args, heads, 1e-12),
                block_ref(args), block_ref(f32(args)), rows,
                {"uniform": block_ref(no_q), "no_mask": block_ref(no_mask)},
                work=(nbytes(*args) + nbytes(x),
                      2 * tokens * hdim * 4 * hdim + 4 * tokens * s_len * hdim,
                      BF16_OPS_S))

        # the attention core alone on a packed projection with std 1.5
        qkv = randn(16, s_len, 3 * hdim, scale=1.5)
        qkv_no_q = qkv.clone()
        qkv_no_q[..., :hdim] = 0

        def core_ref(q, bias, sc):
            return lambda: reference_attention_core(q, bias, heads, sc)

        qh, kh, vh = qkv.view(16, s_len, 3, heads, 64).unbind(2)
        kb_mask = kb[:, None, None, :].to(bf)
        compare("K3 core", f"qkv=[16,{s_len},2304] heads=12",
                lambda: attention_core(qkv, kb, heads, scale),
                core_ref(qkv, kb, scale), core_ref(qkv, kb, scale), rows,
                {"uniform": core_ref(qkv_no_q, kb, scale),
                 "no_mask": core_ref(qkv, torch.zeros_like(kb), scale),
                 "no_scale": core_ref(qkv, kb, 1.0)},
                work=(nbytes(qkv, kb) + tokens * hdim * 2,
                      4 * tokens * s_len * hdim, BF16_OPS_S),
                library=lambda: F.scaled_dot_product_attention(
                    qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                    attn_mask=kb_mask, scale=scale))

    # K4 on 8 sequences × 120 slots
    x = randn(960, hdim, scale=0.5)
    args = (x, randn(hdim, 3072, scale=0.03),
            randn(3072, scale=0.02, dtype=torch.float32),
            randn(3072, hdim, scale=0.03),
            randn(hdim, scale=0.02, dtype=torch.float32),
            torch.rand(hdim, generator=g, device=dev) + 0.5,
            randn(hdim, scale=0.1, dtype=torch.float32))
    for approx in (False, True):
        compare("K4", f"x=[960,768] F=3072 gelu={'tanh' if approx else 'erf'}",
                lambda: fused_ffn(*args, approximate=approx),
                lambda: reference_ffn(*args, 1e-12, approx),
                lambda: reference_ffn(*f32(args), 1e-12, approx), rows,
                work=(nbytes(*args) + nbytes(x), 4 * 960 * hdim * 3072,
                      BF16_OPS_S))
    check_nms(rows)
    check_flash(rows)
    check_flash_bwd(rows)
    return {k: [r for r in rows if r["kernel"].split()[0] == k]
            for k in KERNELS}


def nms_with_fault(boxes, scores, valid, thr, max_out, fault):
    """The plain greedy loop of ``ops/nms.py`` with one named fault:
    ``ge`` suppresses at IoU >= thr, ``ties_high`` breaks score ties to the
    higher index, ``no_valid`` ignores the validity mask."""
    import torch

    from cpt_tpu_torch.ops.nms import NEG_INF, _iou_row

    if fault == "no_valid":
        valid = torch.ones_like(valid)
    live = torch.where(valid, scores, NEG_INF)
    b, k = scores.shape
    rows = torch.arange(b, device=boxes.device)
    out_idx = torch.zeros((b, max_out), dtype=torch.int32, device=boxes.device)
    out_keep = torch.zeros((b, max_out), dtype=torch.bool, device=boxes.device)
    for i in range(max_out):
        pick = (k - 1 - torch.argmax(live.flip(1), dim=1) if fault == "ties_high"
                else torch.argmax(live, dim=1))
        ok = live[rows, pick] > NEG_INF / 2
        iou = _iou_row(boxes[rows, pick], boxes, 0.0)
        hit = iou >= thr if fault == "ge" else iou > thr
        live = torch.where(ok[:, None] & hit, NEG_INF, live)
        live[rows, pick] = NEG_INF
        out_idx[:, i] = torch.where(ok, pick, 0).to(torch.int32)
        out_keep[:, i] = ok
    return out_idx, out_keep


def check_nms(rows: list) -> None:
    """K5 against the plain ``nms_padded`` on the card, on the same f32
    inputs, at the RPN, fast-filter and batched per-class shapes. The check
    is exact equality of ``keep`` and of the kept indices. The inputs have
    many tied scores and planted pairs at IoU exactly equal to the
    threshold, and a fifth of the boxes invalid, so a ``>=`` for ``>``,
    ties broken to the higher index and an ignored mask each change the
    result; the check asserts that they do."""
    import torch

    from cpt_tpu_torch.ops.nms import nms_padded
    from cpt_tpu_torch.ops.nms_pallas import nms_pallas

    dev = torch.device("cuda")
    for b, k, max_out, thr in [(1, 6000, 300, 0.7), (1, 300, 100, 0.5),
                               (1594, 300, 32, 0.5)]:
        rng = np.random.RandomState(k + b)
        xy = rng.uniform(0, 900, (b, k, 2))
        wh = rng.uniform(8, 300, (b, k, 2))
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        # 21 score levels, so ties are everywhere (sigmoid scores of a
        # randomly initialised RPN saturate at 1.0 just so)
        scores = (rng.randint(0, 21, (b, k)) / 20).astype(np.float32)
        valid = rng.rand(b, k) > 0.2
        # pairs [x, y, x+10, y+10] / [x, y, x+10, y+10·thr] clear of the
        # random boxes: exclusive IoU exactly thr, both at the top score
        for p in range(8):
            x0, y0 = 1300.0 + 20 * p, 1300.0
            boxes[:, 2 * p] = [x0, y0, x0 + 10, y0 + 10]
            boxes[:, 2 * p + 1] = [x0, y0, x0 + 10, y0 + 10 * thr]
            scores[:, 2 * p:2 * p + 2] = 1.0
            valid[:, 2 * p:2 * p + 2] = True
        bx, sc, va = (torch.from_numpy(a).to(dev) for a in (boxes, scores, valid))
        squeeze = b == 1
        args = ((bx[0], sc[0], va[0]) if squeeze else (bx, sc, va))
        label = (f"boxes=[{k},4] max_out={max_out} thr={thr}" if squeeze else
                 f"boxes=[{b},{k},4] max_out={max_out} thr={thr}")

        def flat(out):
            idx, keep = out
            return idx.reshape(b, -1), keep.reshape(b, -1)

        got_idx, got_keep = flat(nms_pallas(*args, thr, max_out))
        want_idx, want_keep = flat(nms_padded(*args, thr, max_out))
        torch.cuda.synchronize()
        err = float((got_idx - want_idx).abs().max())
        same = (torch.equal(got_keep, want_keep)
                and torch.equal(got_idx[got_keep], want_idx[want_keep]))

        def differs(out):
            idx, keep = out
            return not (torch.equal(keep, want_keep)
                        and torch.equal(idx[keep], want_idx[want_keep]))

        faults = {f: differs(nms_with_fault(bx, sc, va, thr, max_out, f))
                  for f in ("ge", "ties_high", "no_valid")}
        ms = cuda_ms(lambda: nms_pallas(*args, thr, max_out))
        plain_ms = cuda_ms(lambda: nms_padded(*args, thr, max_out), reps=3,
                           warmup=1)
        kept = int(want_keep.sum())
        # each kept box is scored against all K boxes of its problem: an
        # IoU is ~12 f32 operations (areas, intersection, union, divide)
        bound_ms, bound_by = bound(nbytes(bx, sc, va) + b * max_out * 5,
                                   kept * k * 12, F32_OPS_S)
        rows.append({"kernel": "K5", "shape": label, "max_abs_err": err,
                     "tol": 0.0, "exact": same, "kept": kept, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "faults_differ": faults})
        print(f"K5 {label}: exact={same} max_abs_idx_err={err:.0f} "
              f"kept={kept} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}) faults differ: {faults}",
              flush=True)
        if not same:
            raise AssertionError(f"K5 {label}: kernel differs from plain")
        caught = [f for f, d in faults.items() if not d]
        if caught:
            raise AssertionError(f"K5 {label}: the check would pass {caught}")


def check_flash(rows: list) -> None:
    """K6 at the serving shape (16 sequences of 70 text + 50 region slots,
    a 0/−10000 key bias with ~20% of keys masked and the last sequence fully
    masked), with a finite [4, 1, 512, 512] bias of std 4, and at long
    context (S = 2048, key bias). q is drawn so the scores have std ≈ 2.
    Named faults: uniform attention (q dropped), a dropped bias, a dropped
    scale and, where the bias is finite, the bias added after the scale
    (the einsum order; a 0/−10000 mask masks in either order)."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.attention import flash_mha, reference_flash_mha

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    for b, h, s_len, bias in [(16, 12, 120, "key"), (4, 12, 512, "3d"),
                              (2, 12, 2048, "key")]:
        q, k, v = (torch.randn(b, h, s_len, 64, generator=g, device=dev)
                   for _ in range(3))
        q, k, v = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16()
        if bias == "key":
            kb = torch.where(torch.rand(b, 1, 1, s_len, generator=g,
                                        device=dev) > 0.2, 0.0, -10000.0)
            kb[-1] = -10000.0
        else:
            kb = torch.randn(b, 1, s_len, s_len, generator=g, device=dev) * 4
        scale = 0.125
        qf, kf, vf = q.float(), k.float(), v.float()

        def plain(qq, kk, vv, bb, sc=scale):
            return lambda: reference_flash_mha(qq, kk, vv, bb, sm_scale=sc)

        faults = {"uniform": plain(qf * 0, kf, vf, kb),
                  "no_bias": plain(qf, kf, vf, None),
                  "no_scale": plain(qf, kf, vf, kb, 1.0)}
        if bias == "3d":
            faults["bias_after_scale"] = plain(qf, kf, vf, kb / scale)
        mask = (kb * scale).bfloat16()
        compare("K6", f"q=[{b},{h},{s_len},64] bias={list(kb.shape)}",
                lambda: flash_mha(q, k, v, kb, sm_scale=scale),
                plain(q, k, v, kb), plain(qf, kf, vf, kb), rows, faults,
                work=(nbytes(q, k, v, kb) + nbytes(q),
                      4 * b * h * s_len * s_len * 64, BF16_OPS_S),
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale))


def flash_bwd_with_fault(q, k, v, bias, do, scale, fault=None):
    """(dq, dk, dv) of softmax((q·kᵀ + bias)·scale)·v in f32 by the
    library's backward formula, with one named fault: ``no_di`` drops di
    (``ds = dp·p``), ``ds_unscaled`` leaves ds unscaled, ``no_l`` leaves p
    undivided by l, ``bias_after_scale`` adds the bias after the scale."""
    import torch

    if fault == "bias_after_scale":
        bias = bias / scale
    s = (torch.einsum("bhqd,bhkd->bhqk", q, k) + bias) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p_true = e / e.sum(-1, keepdim=True)
    p = e if fault == "no_l" else p_true
    o = torch.einsum("bhqk,bhkd->bhqd", p_true, v)
    di = 0.0 if fault == "no_di" else (o * do).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = (dp - di) * p * (1.0 if fault == "ds_unscaled" else scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q),
            torch.einsum("bhqk,bhqd->bhkd", p, do))


def check_flash_bwd(rows: list) -> None:
    """K6b and K6c: ``torch.autograd.grad`` of ``flash_mha`` in bf16 (K6
    with row stats, di, K6b, K6c) against ``reference_flash_mha_bwd`` in f32
    on the same inputs, each of dq, dk, dv within BWD_TOL of its scale, at
    the training shape (32 sequences of 70 text + 50 region slots, a key
    bias with ~20% of keys masked and the last sequence fully masked), with
    a finite [4, 1, 512, 512] bias of std 4, and at S = 2048; q is drawn so
    the scores have std ≈ 2. Named faults (di dropped, ds unscaled, p not
    divided by l and, at the finite bias, the bias after the scale) must
    miss. Then each kernel alone, its plain version and SDPA's backward
    (the whole dq, dk, dv; graph built outside the loop) are timed."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                             flash_mha_bwd_dkv_plain,
                                             flash_mha_bwd_dq,
                                             flash_mha_bwd_dq_plain,
                                             flash_mha_fwd,
                                             reference_flash_mha_bwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    for b, h, s_len, bias in [(32, 12, 120, "key"), (4, 12, 512, "3d"),
                              (2, 12, 2048, "key")]:
        q, k, v, do = (torch.randn(b, h, s_len, 64, generator=g, device=dev)
                       for _ in range(4))
        q, k, v, do = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16(), do.bfloat16()
        if bias == "key":
            kb = torch.where(torch.rand(b, 1, 1, s_len, generator=g,
                                        device=dev) > 0.2, 0.0, -10000.0)
            kb[-1] = -10000.0
        else:
            kb = torch.randn(b, 1, s_len, s_len, generator=g, device=dev) * 4
        scale = 0.125
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_mha(*leaves, kb, sm_scale=scale),
                                  leaves, do)
        f32 = [t.float() for t in (q, k, v, do)]
        want = reference_flash_mha_bwd(*f32[:3], kb, f32[3], sm_scale=scale)
        torch.cuda.synchronize()
        tols = [BWD_TOL * max(float(w.abs().max()), 1e-3) for w in want]
        errs = [float((x.float() - w).abs().max()) for x, w in zip(got, want)]
        if not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f"K6b/K6c {b},{h},{s_len}: non-finite gradient")
        faults = ["no_di", "ds_unscaled", "no_l"] + (
            ["bias_after_scale"] if bias == "3d" else [])
        fault_miss = {}
        for f in faults:
            fx = flash_bwd_with_fault(*f32[:3], kb, f32[3], scale, f)
            fault_miss[f] = max(float((x - w).abs().max()) / t
                                for x, w, t in zip(fx, want, tols))
        o, m, l = flash_mha_fwd(q, k, v, kb, sm_scale=scale, stats=True)
        di = (o.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, kb, do, m, l, di)
        sdpa = [t.clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*sdpa, attn_mask=(kb * scale).bfloat16(),
                                             scale=scale)
        library_ms = cuda_ms(lambda: torch.autograd.grad(out, sdpa, do,
                                                         retain_graph=True))
        label = f"q=[{b},{h},{s_len},64] bias={list(kb.shape)}"
        sq = b * h * s_len * s_len * 64
        in_bytes = nbytes(q, k, v, do, m, l, di, kb)
        whole_ms, whole_by = bound(in_bytes + nbytes(o) + 3 * nbytes(q),
                                   10 * sq, BF16_OPS_S)
        for name, kernel, plain, outs, ops, (lo, hi) in (
                ("K6b", flash_mha_bwd_dkv, flash_mha_bwd_dkv_plain, 2, 8 * sq, (1, 3)),
                ("K6c", flash_mha_bwd_dq, flash_mha_bwd_dq_plain, 1, 6 * sq, (0, 1))):
            ms = cuda_ms(lambda: kernel(*args, sm_scale=scale))
            plain_ms = cuda_ms(lambda: plain(*args, scale))
            bound_ms, bound_by = bound(in_bytes + outs * nbytes(q), ops, BF16_OPS_S)
            rows.append({"kernel": name, "shape": label,
                         "max_abs_err": max(errs[lo:hi]), "errs": errs[lo:hi],
                         "tols": tols[lo:hi], "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "fault_miss": fault_miss,
                         "backward_bound_ms": whole_ms})
        print(f"K6b/K6c {label}: dq/dk/dv err " + "/".join(f"{e:.3e}" for e in errs)
              + " tol " + "/".join(f"{t:.3e}" for t in tols) + "; K6b ms="
              f"{rows[-2]['ms']:.4f} plain_ms={rows[-2]['plain_ms']:.4f} "
              f"bound_ms={rows[-2]['bound_ms']:.4f} ({rows[-2]['bound_by']}); "
              f"K6c ms={rows[-1]['ms']:.4f} plain_ms={rows[-1]['plain_ms']:.4f} "
              f"bound_ms={rows[-1]['bound_ms']:.4f} ({rows[-1]['bound_by']}); "
              f"SDPA backward library_ms={library_ms:.4f}; whole-backward bound "
              f"{whole_ms:.4f} ms ({whole_by}); faults miss by "
              + ", ".join(f"{f} {x:.1f}x" for f, x in fault_miss.items()),
              flush=True)
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"K6b/K6c {label}: errors {errs} > {tols}")
        caught = [f for f, x in fault_miss.items() if not x > 1.0]
        if caught:
            raise AssertionError(f"K6b/K6c {label}: the check would pass {caught}")


def build_resident():
    """VinVL X152-C4 + Oscar-base at full width, random weights from seed 0
    in the reference layouts, resident on the card."""
    import torch

    from cpt_tpu_torch.tools import cpt_predict as cp

    t0 = time.perf_counter()
    res = cp.build_resident("cuda", torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"full-width models resident in {setup_s:.1f} s "
          f"(X152-C4 detector, Oscar-base 12x768, vocab "
          f"{res.bert_cfg.vocab_size})", flush=True)
    return res, setup_s


def run_requests(res, counters, idle=("K5", "K6", "K6b", "K6c"),
                 oracle=None) -> dict:
    """Full-width grounding requests with given candidates
    (``cpt_predict.predict`` with dets): a warm-up, then 8, 8 and 16
    candidates, each in its own work directory; then each request's
    candidate scores (and, given ``oracle``, that resident's scores of the
    same features) and scoring-batch count are read back from its
    interchange files, after the launch counts are taken. The kernels in
    ``idle`` must not launch; every other counted kernel must."""
    import torch

    from cpt_tpu_torch.data.refcoco import (RefcocoCPTData,
                                            iter_eval_batches,
                                            tsv_region_features)
    from cpt_tpu_torch.tools import cpt_predict as cp

    rng = np.random.RandomState(2024)

    def request(n_dets):
        img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        xy = rng.uniform(0, 400, (n_dets, 2))
        wh = rng.uniform(24, 240, (n_dets, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [639, 479])], 1)
        return img, np.round(boxes).tolist()

    def answer(img, dets, wd):
        t = time.perf_counter()
        box = cp.predict(res, img, "the person on the left", dets, workdir=wd)
        torch.cuda.synchronize()
        return box, time.perf_counter() - t

    def scoring_batches(wd):
        data = RefcocoCPTData(f"{wd}/predictions.tsv", f"{wd}/ann.json",
                              f"{wd}/stage2_det.json", res.tokenizer,
                              img_feat_dim=res.bert_cfg.img_feature_dim)
        n = sum(1 for _ in iter_eval_batches(data, cp.SCORE_BATCH))
        data.tsv.close()
        return n

    with tempfile.TemporaryDirectory() as root:
        _, cold_s = answer(*request(8), f"{root}/warmup")
        print(f"warm-up request (8 candidates, attention_impl="
              f"{res.bert_cfg.attention_impl!r}): {cold_s * 1e3:.1f} ms",
              flush=True)
        for fn in counters.values():
            fn.launches = 0
        reqs = []
        for n_dets in (8, 8, 16):
            img, dets = request(n_dets)
            wd = f"{root}/request{len(reqs)}"
            box, sec = answer(img, dets, wd)
            feats = tsv_region_features(f"{wd}/predictions.tsv")
            if box not in dets:
                raise AssertionError(f"predicted {box} is not a candidate")
            if feats.shape != (n_dets, n_dets, 2054) or not np.isfinite(feats).all():
                raise AssertionError(f"bad features {feats.shape}")
            reqs.append({"candidates": n_dets, "ms": sec * 1e3, "box": box,
                         "dets": dets, "workdir": wd})
            print(f"request {len(reqs)} ({n_dets} candidates, 480x640 image, "
                  f"640x1024 canvas): {sec * 1e3:.1f} ms", flush=True)
        launches = {k: fn.launches for k, fn in counters.items()}
        for r in reqs:
            wd = r.pop("workdir")
            r["scores"] = cp.candidate_scores(res, wd)
            if oracle is not None:
                r["scores_f32"] = cp.candidate_scores(oracle, wd)
            r["scoring_batches"] = scoring_batches(wd)
    total = sum(r["ms"] for r in reqs) / 1e3
    copies = sum(r["candidates"] for r in reqs)
    print(f"copies/s over the 3 requests: {copies / total:.2f}; launches "
          f"{launches}", flush=True)
    missing = [k for k, n in launches.items() if n <= 0 and k not in idle]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    busy = [k for k in idle if launches[k] != 0]
    if busy:
        raise AssertionError(f"kernels {busy} launched off their path: "
                             f"{launches}")
    return {"warmup_ms": cold_s * 1e3, "requests": reqs,
            "copies_per_s": copies / total, "launches": launches}


def rebuilt_scorer(res, dtype, **config_changes):
    """``res`` with its detector shared and its Oscar-base rebuilt with
    ``config_changes`` in ``dtype``, loaded with the weights ``res``
    computes with: its matrices and tables rounded to its compute dtype
    (the vectors, biases and LayerNorm parameters, stay f32: K3 and K4 and
    every LayerNorm read them so), so an f32 rebuild is the f32 path on the
    bf16 model's weights (the flash resident is what
    ``cpt_predict.build_resident(..., attention_impl="flash")`` builds)."""
    import torch

    from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT

    out = copy.copy(res)
    out.bert_cfg = dataclasses.replace(res.bert_cfg, **config_changes)
    with torch.device(res.device):
        out.oscar = REC_MLM_CPT(out.bert_cfg, dtype).eval()
    out.oscar.load_state_dict({
        k: v.to(res.oscar.dtype).float() if v.dim() > 1 else v
        for k, v in res.oscar.state_dict().items()})
    return out


def check_flash_requests(auto: dict, flash: dict) -> None:
    """The flash path answers each request as the "auto" path does: K6
    launched 12 times (one a layer) for each scoring batch, K4 as often, K3
    never; candidate scores within SCORE_TOL of the largest, both against
    the "auto" path's and against the f32 einsum path's on the same
    features; the same box, unless the "auto" path's own top two scores
    are within that tolerance of each other (a tie at bf16 resolution),
    where the flash path's pick must score within it of the top."""
    n_layers = 12
    batches = sum(r["scoring_batches"] for r in flash["requests"])
    want = {"K6": n_layers * batches, "K4": n_layers * batches, "K3": 0}
    got = {k: flash["launches"][k] for k in want}
    print(f"flash requests: {batches} scoring batches, launches {got} "
          f"(want {want})", flush=True)
    if got != want:
        raise AssertionError(f"flash path launches {got}, want {want}")
    for i, (a, f) in enumerate(zip(auto["requests"], flash["requests"])):
        sa, sf, s32 = (np.asarray(x) for x in (a["scores"], f["scores"],
                                               f["scores_f32"]))
        tol = SCORE_TOL * float(np.abs(sa).max())
        errs = {"flash-auto": float(np.abs(sf - sa).max()),
                "flash-f32": float(np.abs(sf - s32).max()),
                "auto-f32": float(np.abs(sa - s32).max())}
        gap = float(np.diff(np.sort(sa)[-2:])[0])
        tie = gap <= tol
        f.update(score_errs=errs, score_tol=tol, auto_top2_gap=gap)
        print(f"flash request {i + 1}: box {f['box']} (auto {a['box']}; auto "
              f"top-2 gap {gap:.3e}{', a tie' if tie else ''}); max |score "
              f"diff| " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {tol:.3e}, max score {np.abs(sa).max():.4f})",
              flush=True)
        # scores follow the candidates' order (copy i paints candidate i)
        same_box = (f["box"] == a["box"] if not tie
                    else sa[f["dets"].index(f["box"])] >= sa.max() - tol)
        if not same_box or not max(errs["flash-auto"], errs["flash-f32"]) <= tol:
            raise AssertionError(f"flash request {i + 1} differs from auto")


def run_long_context(flash_res, oracle) -> dict:
    """One full-width ``BertImgModel`` forward under ``"flash"``: batch 4,
    70 text tokens + 950 regions (S = 1020), some keys masked, against the
    einsum path in f32 (``oracle``'s) on the same weights. K6 launches once
    a layer."""
    import torch

    from cpt_tpu_torch.ops.attention import flash_mha

    bert, ref = flash_res.oscar.bert, oracle.oscar.bert
    cfg = flash_res.bert_cfg
    rng = np.random.RandomState(31)
    b, t, r = 4, 70, 950
    ids = rng.randint(1000, cfg.vocab_size, (b, t))
    ids[:, 0] = 101
    mask = np.zeros((b, t + r), np.int64)
    for i, (nt, nr) in enumerate([(70, 950), (40, 900), (25, 600), (12, 300)]):
        mask[i, :nt] = 1
        mask[i, t:t + nr] = 1
    feats = (rng.rand(b, r, cfg.img_feature_dim) * 2).astype(np.float32)
    dev = torch.device("cuda")
    ids_t, mask_t = (torch.from_numpy(a).to(dev) for a in (ids, mask))
    feats_t = torch.from_numpy(feats).to(dev)
    seg = torch.zeros_like(ids_t)

    def forward(model):
        t0 = time.perf_counter()
        out, _ = model(ids_t, seg, mask_t, img_feats=feats_t)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        forward(bert)
        forward(ref)
        before = flash_mha.launches
        got, ms = forward(bert)
        launches = flash_mha.launches - before
        want, ref_ms = forward(ref)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all() or got.shape != (b, t + r, 768):
        raise AssertionError(f"long-context output {tuple(got.shape)} "
                             f"or non-finite")
    err = float((got - want).abs().max())
    tol = LONG_TOL * float(want.abs().max())
    print(f"long-context forward (batch 4, 70 text + 950 regions, 12x768, "
          f"flash, bf16): {ms:.2f} ms, K6 launches {launches}; einsum f32 "
          f"{ref_ms:.2f} ms; max_abs_err {err:.3e} (tol {tol:.3e})",
          flush=True)
    if launches != cfg.num_hidden_layers or not err <= tol:
        raise AssertionError(f"long-context flash forward: launches "
                             f"{launches}, err {err} > {tol}")
    return {"ms": ms, "einsum_f32_ms": ref_ms, "max_abs_err": err,
            "tol": tol, "launches": launches}


def run_detect_requests(res, counters) -> dict:
    """Full-width ``--detect`` requests: ``cpt_predict.predict`` without
    dets, so the detector proposes the candidates (RPN → K5 → box head on
    K2/K1 → ``NMS_FILTER`` 2 on K5 → ``conf`` 0), then grounds them. The
    detect step is timed and its launches counted by wrapping
    ``Resident.detect``."""
    import torch

    from cpt_tpu_torch.data.refcoco import tsv_region_features
    from cpt_tpu_torch.tools import cpt_predict as cp

    rng = np.random.RandomState(2025)
    step: dict = {}
    detect = res.detect

    def timed_detect(image, conf):
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        out = detect(image, conf)
        step["ms"] = (time.perf_counter() - t) * 1e3
        step["candidates"] = [[float(v) for v in b] for b in out[0]]
        step["launches"] = {k: fn.launches - before[k]
                            for k, fn in counters.items()}
        return out

    res.detect = timed_detect

    def answer(img, wd):
        t = time.perf_counter()
        box = cp.predict(res, img, "the person on the left", None,
                         workdir=wd, conf=0.0)
        torch.cuda.synchronize()
        return box, time.perf_counter() - t

    def image():
        return rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)

    try:
        with tempfile.TemporaryDirectory() as wd:
            _, cold_s = answer(image(), wd)
            print(f"warm-up detect request: {cold_s * 1e3:.1f} ms", flush=True)
            for fn in counters.values():
                fn.launches = 0
            reqs = []
            for _ in range(3):
                before = {k: fn.launches for k, fn in counters.items()}
                box, sec = answer(image(), wd)
                n_k5 = counters["K5"].launches - before["K5"]
                feats = tsv_region_features(f"{wd}/predictions.tsv")
                n_cand = len(step["candidates"])
                if box not in step["candidates"]:
                    raise AssertionError(f"predicted {box} is not a detected "
                                         f"candidate")
                if (n_cand < 2 or feats.shape != (n_cand, n_cand, 2054)
                        or not np.isfinite(feats).all()):
                    raise AssertionError(f"{n_cand} candidates, features "
                                         f"{feats.shape}")
                det_l = step["launches"]
                if n_k5 < 2 or det_l["K1"] <= 0 or det_l["K2"] <= 0:
                    raise AssertionError(f"detect step launches {det_l}, K5 "
                                         f"{n_k5} in the request")
                reqs.append({"candidates": n_cand, "ms": sec * 1e3,
                             "detect_ms": step["ms"],
                             "ground_ms": sec * 1e3 - step["ms"],
                             "detect_launches": det_l, "k5_launches": n_k5,
                             "box": box})
                print(f"detect request {len(reqs)} (480x640 image, 1024x1024 "
                      f"detect canvas, conf 0): {sec * 1e3:.1f} ms = detect "
                      f"{step['ms']:.1f} + ground {sec * 1e3 - step['ms']:.1f}"
                      f"; {n_cand} candidates; detect-step launches K1 "
                      f"{det_l['K1']} K2 {det_l['K2']} K5 {det_l['K5']}",
                      flush=True)
            launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        res.detect = detect
    print(f"launches over the 3 detect requests: {launches}", flush=True)
    flash = ("K6", "K6b", "K6c")
    missing = [k for k, n in launches.items() if n <= 0 and k not in flash]
    if missing or any(launches[k] for k in flash):
        raise AssertionError(f"kernels not launched on the detect path: "
                             f"{missing}, or K6/K6b/K6c launched: {launches}")
    return {"warmup_ms": cold_s * 1e3, "requests": reqs, "launches": launches}


CAPTIONS = ("the person on the left", "a dog near the car", "the red chair",
            "man holding an umbrella")


def training_data(res, root: str, n_queries: int = 16, n_cands: int = 4):
    """Stage-1 features of ``n_queries`` grounding queries (a 480x640 image
    and ``n_cands`` candidate boxes each; the gt box is candidate
    ``i % n_cands``), extracted by the resident detector into
    ``predictions.tsv`` with its ann and od-label jsons → (RefcocoCPTData,
    their paths, extraction seconds)."""
    import torch

    from cpt_tpu_torch.data.refcoco import RefcocoCPTData, det_json_for_stage2
    from cpt_tpu_torch.engine.extract import refcoco_task

    rng = np.random.RandomState(2026)
    tasks, anns = [], []
    for i in range(n_queries):
        img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        xy = rng.uniform(0, 400, (n_cands, 2))
        wh = rng.uniform(24, 240, (n_cands, 2))
        boxes = np.round(np.concatenate([xy, np.minimum(xy + wh, [639, 479])], 1))
        x1, y1, x2, y2 = boxes[i % n_cands].tolist()
        caption = CAPTIONS[i % len(CAPTIONS)]
        tasks.append(refcoco_task(f"q{i}", img, img.shape[:2], boxes, caption))
        anns.append({"id": f"q{i}", "caption": caption, "height": 480,
                     "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1]})
    paths = {k: f"{root}/{v}" for k, v in (("data_file", "predictions.tsv"),
                                           ("ann_file", "ann.json"),
                                           ("det_file", "stage2_det.json"))}
    t0 = time.perf_counter()
    res.extractor.run(tasks, paths["data_file"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    with open(paths["ann_file"], "w") as f:
        json.dump(anns, f)
    det_json_for_stage2(paths["data_file"], paths["det_file"])
    data = RefcocoCPTData(paths["data_file"], paths["ann_file"],
                          paths["det_file"], res.tokenizer,
                          img_feat_dim=res.bert_cfg.img_feature_dim)
    return data, paths, extract_s


KERNEL_GROUPS = (("K6b", ("flash_bwd_dkv",)), ("K6c", ("flash_bwd_dq",)),
                 ("K6", ("flash_attention_kernel",)),
                 ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
                 ("elementwise / reduce", ("elementwise", "vectorized", "reduce",
                                          "foreach", "multi_tensor")))


def profile_train_step(model, batch, dev, reps: int = 3) -> dict:
    """Where a prompt-tuning step's time goes: ``reps`` steps timed on the
    host clock (the optimizer's update timed alone, between two
    synchronisations), then ``reps`` steps under ``torch.profiler`` (device
    kernels only) grouped by kernel family."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpt_tpu_torch.engine import train as train_lib

    tx = train_lib.build_optimizer(model, train_lib.OptimConfig(warmup_steps=0))
    state = train_lib.create_train_state(model, tx)
    step = train_lib.make_mlm_train_step(model, tx)
    gen = torch.Generator(device=dev).manual_seed(1)
    real, opt_ms = tx.update, []

    def timed_update(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(*a)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t) * 1e3)

    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    tx.update = timed_update
    for _ in range(reps):
        step(state, batch, gen)
    tx.update = real
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3 / reps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms in kernels:
        low = key.lower()
        name = next((n for n, pats in KERNEL_GROUPS if any(x in low for x in pats)),
                    "other")
        groups[name] += ms
    busy = sum(ms for _, ms in kernels)
    top = sorted(kernels, key=lambda kv: -kv[1])[:8]
    print(f"phase 5 step breakdown (batch of {batch[0].shape[0]}, flash, bf16): "
          f"{step_ms:.2f} ms/step on the host clock; optimizer update alone "
          f"{np.mean(opt_ms):.2f} ms; device kernels {busy:.2f} ms/step (busy "
          f"share {busy / step_ms:.3f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
          + "; top kernels: " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top),
          flush=True)
    return {"step_ms": step_ms, "optimizer_ms": float(np.mean(opt_ms)),
            "device_ms": busy, "groups": groups, "top": top}


def run_training(res, counters) -> dict:
    """Phase 5. Prompt tuning through ``refcoco_cpt.train`` (the tool's
    defaults: batch 32, AdamW lr 2.5e-5, weight decay 0.05, warmup 10%,
    20 epochs of the 16 queries' 32 sampled copies = 20 steps) of
    Oscar-base under "flash" with attention dropout 0 in bf16, counting
    each step's launches and profiling a step; then, on the same initial
    weights and ``grad_gap``'s synthetic batches (those the tolerances were
    derived on), one step's gradients and 10 deterministic steps' losses
    against the einsum path in f32 (with K6b's dK zeroed as the fault the
    gradient check must catch); then 3 deterministic steps under "auto"."""
    import torch

    from cpt_tpu_torch.data.refcoco import iter_train_batches
    from cpt_tpu_torch.engine import train as train_lib
    from cpt_tpu_torch.ops import fused_attention, fused_ffn
    from cpt_tpu_torch.tools import grad_gap, refcoco_cpt

    dev, cfg = res.device, res.bert_cfg
    init = {k: v.clone() for k, v in res.oscar.state_dict().items()}
    with tempfile.TemporaryDirectory() as root:
        data, paths, extract_s = training_data(res, root)
        print(f"phase 5: stage-1 features of {len(data)} queries extracted in "
              f"{extract_s * 1e3:.1f} ms", flush=True)
        args = refcoco_cpt.build_args().parse_args(
            ["--train_data_file", paths["data_file"]]
            + [x for k, v in paths.items() for x in (f"--{k}", v)])
        model = grad_gap.build(init, cfg, torch.bfloat16, dev, **grad_gap.FLASH)
        steps = []
        mark = [time.perf_counter(), {k: 0 for k in counters}]

        def on_step(step, loss):
            now = time.perf_counter()
            seen = {k: fn.launches for k, fn in counters.items()}
            steps.append({"step": step, "loss": loss, "ms": (now - mark[0]) * 1e3,
                          "launches": {k: seen[k] - mark[1][k] for k in seen}})
            mark[:] = [now, seen]

        for fn in counters.values():
            fn.launches = 0
        t0 = mark[0] = time.perf_counter()
        losses = refcoco_cpt.train(model, data, args, dev, on_step)
        train_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        batches = [train_lib.batch_arrays_mlm(
            next(iter_train_batches(data, args.per_gpu_train_batch_size, seed)), dev)
            for seed in (0, 1)]
        data.tsv.close()
    n_seq = args.per_gpu_train_batch_size
    steady = [st["ms"] for st in steps[1:]]
    print(f"phase 5: {len(losses)} steps of batch {n_seq} (flash, bf16) in "
          f"{train_s:.2f} s; ms/step {np.mean(steady):.2f} after the first "
          f"({steps[0]['ms']:.1f}); {n_seq * len(steady) / (sum(steady) / 1e3):.1f}"
          f" sequences/s; losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
          f"{launches}", flush=True)
    want = {"K6": 12, "K6b": 12, "K6c": 12, "K3": 0, "K4": 0}
    bad = [st for st in steps if any(st["launches"][k] != n for k, n in want.items())]
    if len(losses) < 20 or not np.isfinite(losses).all() or bad:
        raise AssertionError(f"phase 5 training: {len(losses)} losses "
                             f"{losses}; steps off their launch counts: {bad[:2]}")
    breakdown = profile_train_step(model, batches[0], dev)
    del model

    # one step's gradients, dropout off, against the f32 einsum path, on
    # the batch GRAD_TOL was derived on (grad_gap's synthetic batch 32,
    # seed 0; these are its weights too). On a batch of the random
    # detector's features the per-tensor gap measures nothing: there layer
    # 0's qkv bias gets an f32 gradient orders of magnitude below the bf16
    # paths' rounding noise, for the plain path in bf16 as for the flash one.
    oracle = grad_gap.build(init, cfg, torch.float32, dev, **grad_gap.PLAIN)
    flash = grad_gap.build(init, cfg, torch.bfloat16, dev, **grad_gap.FLASH)
    plain16 = grad_gap.build(init, cfg, torch.bfloat16, dev, **grad_gap.PLAIN)
    synth = grad_gap.synthetic_batch(cfg, n_seq, 0, dev)
    _, ref = grad_gap.step_grads(oracle, synth)
    gaps = {"flash": grad_gap.gap(grad_gap.step_grads(flash, synth)[1], ref),
            "plain_bf16": grad_gap.gap(grad_gap.step_grads(plain16, synth)[1], ref)}
    with grad_gap.zeroed_dk():
        gaps["flash_dk_zeroed"] = grad_gap.gap(
            grad_gap.step_grads(flash, synth)[1], ref)
    del ref, plain16
    print("phase 5 gradients vs f32 einsum (largest per-tensor relative L2): "
          + ", ".join(f"{k} {v[0]:.4e} ({v[1]})" for k, v in gaps.items())
          + f"; tol {GRAD_TOL}", flush=True)
    if not gaps["flash"][0] <= GRAD_TOL < gaps["flash_dk_zeroed"][0]:
        raise AssertionError(f"phase 5 gradient check: {gaps}")

    # 10 deterministic steps on two fixed batches (the derivation's two
    # synthetic batches), flash bf16 vs einsum f32
    synth2 = [synth, grad_gap.synthetic_batch(cfg, n_seq, 1, dev)]
    curves = {"flash_bf16": grad_gap.loss_curve(flash, synth2, 10),
              "einsum_f32": grad_gap.loss_curve(oracle, synth2, 10)}
    loss_gap = float(np.abs(np.subtract(*curves.values())).max())
    print(f"phase 5 losses over 10 deterministic steps: flash bf16 "
          f"{curves['flash_bf16'][0]:.4f} -> {curves['flash_bf16'][-1]:.4f}, "
          f"einsum f32 {curves['einsum_f32'][0]:.4f} -> "
          f"{curves['einsum_f32'][-1]:.4f}; max gap {loss_gap:.3e} "
          f"(tol {LOSS_TOL})", flush=True)
    if not loss_gap <= LOSS_TOL:
        raise AssertionError(f"phase 5 loss curves differ: {curves}")
    del oracle, flash

    # 3 deterministic steps under "auto": K3 and K4 forward, plain VJPs back
    auto = grad_gap.build(init, cfg, torch.bfloat16, dev)
    vjps = {"K3": 0, "K4": 0}

    def counting(module, key):
        real = module.plain_vjp

        def wrapped(*a, **kw):
            vjps[key] += 1
            return real(*a, **kw)
        return real, wrapped

    patched = [(m, *counting(m, k)) for m, k in ((fused_attention, "K3"),
                                                 (fused_ffn, "K4"))]
    tx = train_lib.build_optimizer(auto, train_lib.OptimConfig(warmup_steps=0))
    state = train_lib.create_train_state(auto, tx)
    step = train_lib.make_mlm_train_step(auto, tx, dropout=False)
    step(state, batches[0])                                  # warm-up
    torch.cuda.synchronize()
    try:
        for m, _, wrapped in patched:
            m.plain_vjp = wrapped
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        auto_losses = [float(step(state, batches[i % 2])[1]) for i in range(3)]
        auto_s = time.perf_counter() - t0
    finally:
        for m, real, _ in patched:
            m.plain_vjp = real
    auto_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"phase 5 deterministic steps under 'auto': {auto_s / 3 * 1e3:.2f} "
          f"ms/step, {3 * n_seq / auto_s:.1f} sequences/s; losses "
          f"{auto_losses}; launches {auto_launches}; plain VJPs {vjps}",
          flush=True)
    if (auto_launches["K3"] != 36 or auto_launches["K4"] != 36
            or auto_launches["K6"] or vjps != {"K3": 36, "K4": 36}
            or not np.isfinite(auto_losses).all()):
        raise AssertionError(f"phase 5 'auto' steps: launches {auto_launches}, "
                             f"plain VJPs {vjps}")
    return {"train": {"extract_ms": extract_s * 1e3, "seconds": train_s,
                      "losses": losses, "steps": steps, "launches": launches,
                      "ms_per_step": float(np.mean(steady)),
                      "sequences_per_s": n_seq * len(steady) / (sum(steady) / 1e3)},
            "step_breakdown": breakdown, "gradient_gaps": gaps,
            "loss_curves": curves, "loss_gap": loss_gap,
            "auto_train": {"ms_per_step": auto_s / 3 * 1e3,
                           "sequences_per_s": 3 * n_seq / auto_s,
                           "losses": auto_losses, "launches": auto_launches,
                           "plain_vjps": vjps}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from cpt_tpu_torch.kernels import build
    from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                             flash_mha_bwd_dq)
    from cpt_tpu_torch.ops.fused_attention import fused_attention_block
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn
    from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3
    from cpt_tpu_torch.ops.nms_pallas import nms_pallas
    from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align

    build.lib()
    print(f"kernels built and loaded in {build.LIBRARY.build_seconds:.1f} s "
          f"({build.library_path().name})", flush=True)

    rows: list = []
    per_kernel = check_kernels(rows)
    counters = {"K1": grouped_conv3x3, "K2": batched_roi_align,
                "K3": fused_attention_block, "K4": fused_ffn,
                "K5": nms_pallas, "K6": flash_mha, "K6b": flash_mha_bwd_dkv,
                "K6c": flash_mha_bwd_dq}
    res, setup_s = build_resident()
    e2e = {"setup_s": setup_s, "ground": run_requests(res, counters),
           "detect": run_detect_requests(res, counters)}
    flash = rebuilt_scorer(res, torch.bfloat16, attention_impl="flash")
    oracle = rebuilt_scorer(res, torch.float32, attention_impl="einsum",
                            ffn_impl="dense")
    e2e["flash_ground"] = run_requests(flash, counters,
                                       idle=("K3", "K5", "K6b", "K6c"),
                                       oracle=oracle)
    check_flash_requests(e2e["ground"], e2e["flash_ground"])
    e2e["long_context"] = run_long_context(flash, oracle)
    del flash, oracle
    e2e.update(run_training(res, counters))

    # headline shape per kernel for the summary line: the most frequent
    # main-path call (layer3 blocks; 32 RoIs; S=120; erf gelu; the RPN's
    # NMS; the serving shape; the training shape); launches over the
    # request and training paths, each counted from 0 around its run
    headline = {"K1": 4, "K2": 1, "K3": 0, "K4": 0, "K5": 0, "K6": 0,
                "K6b": 0, "K6c": 0}
    paths = ("ground", "detect", "flash_ground", "train", "auto_train")
    summary = []
    for k, (fn_name, src, replaces) in KERNELS.items():
        r = per_kernel[k][headline[k]]
        summary.append({"name": f"{k} {fn_name}", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": sum(e2e[p]["launches"][k] for p in paths),
                        "max_abs_err": max(x["max_abs_err"] for x in per_kernel[k]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "build_s": build.LIBRARY.build_seconds,
                       "checks": rows, "requests": e2e}, f, indent=1)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
