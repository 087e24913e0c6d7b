#!/usr/bin/env python3
"""Time one checkout of the PyTorch + CUDA port (``cpt_tpu_torch``) end to
end on one NVIDIA Hopper card with ``chip_smoke.py``'s functions, so that two
commits are timed by one script on one card.

    python3 chip_e2e.py [--package DIR] [--json out.json]

``--package DIR`` imports ``cpt_tpu_torch`` from another checkout (say the
parent commit, unpacked with ``git archive``); without it, this one's. The
run times K1 at ``chip_smoke.py``'s seven X152 shapes through the package's
``grouped_conv3x3`` (CUDA events, on the path its dispatch rule picks, with
its error against the plain version in f32), K3's attention core and K6 at
chip_smoke's five attention shapes by device time beside SDPA's, K3's
block and K4 at chip_smoke's shapes and the shared GEMM's epilogue (a)
beside ``torch.addmm`` by device time (``time_blocks``), K6b and
K6c at chip_smoke's three backward shapes by device time beside SDPA's
backward, K5 at chip_smoke's NMS shapes and K2 at the request, detect-step,
``--detect`` grounding and chip_smoke shapes by device time (``time_k5``,
``time_k2``; K2 beside its plain version and its bound), then phase
4's 3 grounding
requests and 3 ``--detect`` requests (one of each under
``torch.profiler``), then ``tools/extract_features --synthetic 4
--copies_per_chunk 4 --precision bf16`` (the second of two runs), K1q at
the seven shapes beside K1 and K7 at its study's shape beside K4 and the
``xla_int8`` yardstick by device time (``time_k1q``, ``time_k7``), the int8
extraction's copies/s and its chunk's profile by kernel family
(``time_int8_extract``), and prints one JSON line. It checks what those
functions check; ``chip_smoke.py``
is the correctness gate. Run it in turns (parent, change, change, parent)
to see the spread of the host-clock numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as cs


def time_k1() -> list:
    """K1 through ``grouped_conv3x3`` at each of ``cs.K1_SHAPES``: ms (mean
    of 10 launches after 2 warm-ups) and max |Δ| / max |reference| against
    the plain version in f32 on the same inputs."""
    import torch

    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3,
                                                reference_grouped_conv3x3)

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n, h, w, c, stride in cs.K1_SHAPES:
        x, wt, s, b = cs.k1_inputs(n, h, w, c, g)
        got = grouped_conv3x3(x, wt, s, b, 32, stride, True).float()
        want = reference_grouped_conv3x3(x.float(), wt.float(), s, b, 32,
                                         stride, True)
        err = float((got - want).abs().max() / want.abs().max())
        ms = cs.cuda_ms(lambda: grouped_conv3x3(x, wt, s, b, 32, stride, True))
        rows.append({"shape": [n, h, w, c], "stride": stride, "ms": ms,
                     "rel_err": err})
        print(f"K1 x=[{n},{h},{w},{c}] stride={stride}: {ms:.4f} ms, "
              f"max |Δ| / max |ref| {err:.3e}", flush=True)
    return rows


def time_attention() -> list:
    """K3's core (``attention_core``) at ``[16,12,120,64]`` and
    ``[16,12,128,64]`` and K6 (``flash_mha``) at ``[16,12,120,64]`` with a
    key bias, ``[4,12,512,64]`` with a 3-D bias and ``[2,12,2048,64]`` with
    a key bias, on chip_smoke's kinds of inputs: the kernel's device time
    (``cs.device_ms``, 10 launches), its CUDA-event mean of back-to-back
    launches, SDPA's device time on the same inputs, and max |Δ| / max |ref|
    against the plain version in f32."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.kernels.gemm import attention_core
    from cpt_tpu_torch.ops.attention import flash_mha, reference_flash_mha
    from cpt_tpu_torch.ops.fused_attention import reference_attention_core

    g = torch.Generator(device="cuda").manual_seed(6)
    rows = []

    def keys(b, s_len):
        kb = torch.where(torch.rand(b, s_len, generator=g, device="cuda") > 0.2,
                         0.0, -10000.0)
        kb[-1] = -10000.0
        return kb

    def row(label, kernel, name, plain, sdpa):
        got, want = kernel().float(), plain()
        err = float((got - want).abs().max() / want.abs().max())
        dev_ms, how = cs.device_ms(kernel, name)
        sdpa_ms, _ = cs.device_ms(sdpa)
        rows.append({"shape": label, "device_ms": dev_ms, "timed_by": how,
                     "ms": cs.cuda_ms(kernel), "sdpa_device_ms": sdpa_ms,
                     "rel_err": err})
        print(f"{label}: device {dev_ms:.4f} ms ({how}), back-to-back "
              f"{rows[-1]['ms']:.4f} ms, SDPA device {sdpa_ms:.4f} ms, max |Δ| "
              f"/ max |ref| {err:.3e}", flush=True)

    for s_len in (120, 128):
        qkv = (torch.randn(16, s_len, 2304, generator=g, device="cuda") * 1.5
               ).bfloat16()
        kb = keys(16, s_len)
        qh, kh, vh = (t.transpose(1, 2) for t in
                      qkv.view(16, s_len, 3, 12, 64).unbind(2))
        mask = kb[:, None, None, :].bfloat16()
        row(f"K3 core qkv=[16,{s_len},2304]",
            lambda: attention_core(qkv, kb, 12, 0.125), "attention_kernel",
            lambda: reference_attention_core(qkv, kb, 12, 0.125),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                   scale=0.125))
    for b, s_len, bias in ((16, 120, "key"), (4, 512, "3d"), (2, 2048, "key")):
        q, k, v = (torch.randn(b, 12, s_len, 64, generator=g, device="cuda")
                   for _ in range(3))
        q, k, v = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16()
        kb = (keys(b, s_len)[:, None, None, :] if bias == "key" else
              torch.randn(b, 1, s_len, s_len, generator=g, device="cuda") * 4)
        mask = (kb * 0.125).bfloat16()
        row(f"K6 q=[{b},12,{s_len},64] bias={list(kb.shape)}",
            lambda: flash_mha(q, k, v, kb, sm_scale=0.125),
            "flash_attention_kernel",
            lambda: reference_flash_mha(q.float(), k.float(), v.float(), kb,
                                        sm_scale=0.125),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   scale=0.125))
    return rows


def time_blocks() -> list:
    """K3 (``fused_attention_block``) at ``[16,120,768]`` and
    ``[16,128,768]``, K4 (``fused_ffn``, erf gelu) at ``[960,768]``,
    ``[1920,768]`` (the scoring batch) and ``[1264,768]``, and the shared
    GEMM's epilogue (a) alone (``kernels.gemm.gemm_bias_act``) at the
    scoring batch's QKV and FFN-1 shapes beside ``torch.addmm`` (the one
    PyTorch call that computes it), on chip_smoke's inputs (``k3_inputs``,
    ``k4_inputs``), through the public wrappers only, so that a parent
    checkout's kernels are timed the same way: device time of every kernel
    of the call (``cs.device_ms``, 10 launches), the blocks' plain
    versions in bf16 by device time too, and max |Δ| / max |ref| against
    the plain version in f32."""
    import torch

    from cpt_tpu_torch.kernels.gemm import gemm_bias_act
    from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                                   reference_attention_block)
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn, reference_ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def row(label, kernel, exact, plain=None, library=None):
        got, want = kernel().float(), exact().float()
        err = float((got - want).abs().max() / want.abs().max())
        dev_ms, how = cs.device_ms(kernel)
        rows.append({"shape": label, "device_ms": dev_ms, "timed_by": how,
                     "rel_err": err})
        txt = ""
        if plain is not None:
            rows[-1]["plain_device_ms"], _ = cs.device_ms(plain)
            txt += f", plain (bf16) device {rows[-1]['plain_device_ms']:.4f} ms"
        if library is not None:
            rows[-1]["addmm_device_ms"], _ = cs.device_ms(library)
            txt += f", addmm device {rows[-1]['addmm_device_ms']:.4f} ms"
        print(f"{label}: device {dev_ms:.4f} ms ({how}){txt}, max |Δ| / max "
              f"|ref| {err:.3e}", flush=True)

    for s_len in (120, 128):
        args = cs.on_card(cs.k3_inputs(16, s_len, 768, seed=s_len), "cuda")
        fargs = [a.float() for a in args]
        row(f"K3 x=[16,{s_len},768]",
            lambda: fused_attention_block(*args, 12, 1e-12),
            lambda: reference_attention_block(*fargs, num_heads=12, eps=1e-12),
            lambda: reference_attention_block(*args, num_heads=12, eps=1e-12))
    for m in (960, 1920, 1264):
        args = cs.on_card(cs.k4_inputs(m, 768, 3072, seed=m), "cuda")
        fargs = [a.float() for a in args]
        row(f"K4 x=[{m},768] F=3072 erf", lambda: fused_ffn(*args),
            lambda: reference_ffn(*fargs, 1e-12, False),
            lambda: reference_ffn(*args, 1e-12, False))
    g = torch.Generator(device="cuda").manual_seed(9)
    for n in (2304, 3072):
        a = (torch.randn(1920, 768, generator=g, device="cuda") * 0.5).bfloat16()
        w = (torch.randn(768, n, generator=g, device="cuda") * 0.03).bfloat16()
        b = torch.randn(n, generator=g, device="cuda") * 0.5
        b_bf = b.bfloat16()
        row(f"GEMM (a) a=[1920,768] w=[768,{n}]", lambda: gemm_bias_act(a, w, b),
            lambda: a.float() @ w.float() + b, library=lambda: torch.addmm(b_bf, a, w))
    return rows


def time_flash_bwd() -> list:
    """K6b (``flash_mha_bwd_dkv``) and K6c (``flash_mha_bwd_dq``) at
    ``[32,12,120,64]`` with a key bias (the training shape),
    ``[4,12,512,64]`` with a 3-D bias and ``[2,12,2048,64]`` with a key
    bias, on chip_smoke's kinds of inputs, through the public wrappers
    only (so a parent checkout's kernels are timed the same way): each
    kernel's device time (``cs.device_ms``, 10 launches), SDPA's whole
    backward (dq, dk, dv) by device time on the same inputs, and each
    gradient's max |Δ| / max |ref| against the plain backward in f32."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.attention import (flash_mha_bwd_dkv,
                                             flash_mha_bwd_dq, flash_mha_fwd,
                                             reference_flash_mha_bwd)

    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for b, s_len, bias in ((32, 120, "key"), (4, 512, "3d"), (2, 2048, "key")):
        q, k, v, do = (torch.randn(b, 12, s_len, 64, generator=g, device="cuda")
                       for _ in range(4))
        q, k, v, do = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16(), do.bfloat16()
        if bias == "key":
            kb = torch.where(torch.rand(b, 1, 1, s_len, generator=g,
                                        device="cuda") > 0.2, 0.0, -10000.0)
            kb[-1] = -10000.0
        else:
            kb = torch.randn(b, 1, s_len, s_len, generator=g, device="cuda") * 4
        o, m, l = flash_mha_fwd(q, k, v, kb, sm_scale=0.125, stats=True)
        di = (o.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, kb, do, m, l, di)
        dk, dv = flash_mha_bwd_dkv(*args, sm_scale=0.125)
        dq = flash_mha_bwd_dq(*args, sm_scale=0.125)
        want = reference_flash_mha_bwd(q.float(), k.float(), v.float(), kb,
                                       do.float(), sm_scale=0.125)
        errs = [float((x.float() - w).abs().max() / w.abs().max())
                for x, w in zip((dq, dk, dv), want)]
        dkv_ms, how = cs.device_ms(lambda: flash_mha_bwd_dkv(*args, sm_scale=0.125),
                                   "flash_bwd_dkv")
        dq_ms, _ = cs.device_ms(lambda: flash_mha_bwd_dq(*args, sm_scale=0.125),
                                "flash_bwd_dq")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        # built on its own stream, where device_ms's fallback can capture
        # the backward
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=(kb * 0.125).bfloat16(), scale=0.125)
        torch.cuda.current_stream().wait_stream(stream)
        sdpa_ms, _ = cs.device_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                              retain_graph=True),
                                  stream=stream)
        label = f"K6b/K6c q=[{b},12,{s_len},64] bias={list(kb.shape)}"
        rows.append({"shape": label, "dkv_device_ms": dkv_ms, "dq_device_ms": dq_ms,
                     "timed_by": how, "sdpa_bwd_device_ms": sdpa_ms,
                     "rel_err": errs})
        print(f"{label}: K6b device {dkv_ms:.4f} ms, K6c device {dq_ms:.4f} ms "
              f"({how}), sum {dkv_ms + dq_ms:.4f}; SDPA backward device "
              f"{sdpa_ms:.4f} ms; dq/dk/dv max |Δ| / max |ref| "
              + "/".join(f"{e:.3e}" for e in errs), flush=True)
    return rows


def kernel_split(fn, match: str, reps: int = 10) -> dict:
    """Device ms per call of each kernel whose name holds ``match``, from
    one ``torch.profiler`` trace of ``reps`` calls (each kernel by the word
    of its name that holds ``match``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and match in e.key:
            name = re.search(rf"\w*{match}\w*", e.key).group(0)
            split[name] = split.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return split


def time_k5() -> list:
    """K5 (``nms_pallas``) at ``cs.NMS_SHAPES`` on ``cs.nms_inputs``,
    through the public wrapper only: device time of all of the call's
    kernels (``cs.device_ms``, 10 launches; names holding "nms_"), that
    time split by kernel (:func:`kernel_split`), and whether it equals
    ``nms_padded`` slot for slot. Where the package has K5's two paths
    (``launch_nms``), each path's device time and exactness too, so that
    the dispatch rule's cutoff is read on the card."""
    import torch

    from cpt_tpu_torch.ops import nms_pallas as k5
    from cpt_tpu_torch.ops.nms import nms_padded

    rows = []
    for b, k, max_out, thr, off, ones in cs.NMS_SHAPES:
        bx, sc, va = (torch.from_numpy(a).cuda()
                      for a in cs.nms_inputs(b, k, thr, off, ones, seed=k + b))
        args = (bx[0], sc[0], va[0]) if b == 1 else (bx, sc, va)
        got = k5.nms_pallas(*args, thr, max_out, off)
        want = nms_padded(*args, thr, max_out, off)
        exact = all(torch.equal(x, y) for x, y in zip(got, want))
        dev_ms, how = cs.device_ms(
            lambda: k5.nms_pallas(*args, thr, max_out, off), "nms_")
        split = kernel_split(lambda: k5.nms_pallas(*args, thr, max_out, off),
                             "nms_")
        label = cs.nms_label(b, k, max_out, thr, off, ones)
        rows.append({"shape": label, "device_ms": dev_ms, "timed_by": how,
                     "kernels_ms": split, "exact": exact})
        paths = {}
        for path in ("block", "grid") if hasattr(k5, "launch_nms") else ():
            def run(path=path):
                return k5.launch_nms(path, bx, sc, va, thr, max_out, off)

            want_b = nms_padded(bx, sc, va, thr, max_out, off)
            ok = all(torch.equal(x, y) for x, y in zip(run(), want_b))
            paths[path] = {"device_ms": cs.device_ms(run, "nms_")[0],
                           "exact": ok}
        if paths:
            rows[-1].update(path=k5.nms_path(b, k), paths=paths)
        print(f"K5 {label}: device {dev_ms:.4f} ms ({how}), by kernel "
              + ", ".join(f"{n} {v:.4f}" for n, v in split.items())
              + f"; exact {exact}"
              + "".join(f"; {p} path {v['device_ms']:.4f} ms, exact "
                        f"{v['exact']}" for p, v in paths.items()), flush=True)
    return rows


def time_k2() -> list:
    """K2 (``batched_roi_align``, 14x14, adaptive grid capped at 8) at
    ``cs.k2_shapes``, through the public wrappers only: the kernel's device
    time (``cs.device_ms``, 10 launches), the plain version's in bf16 (3
    launches), the bound (``cs.k2_work``: the feature pixels some RoI
    reads, the RoIs and the output, each moved once, at 3.35 TB/s), the
    device time of writing the output alone (a ``fill_`` of a tensor of
    its size: the store floor the kernel sits on), and max |Δ| / max |ref|
    against the plain version in f32."""
    import torch

    from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                    batched_roi_align_plain)

    g = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for label, shape, rois in cs.k2_shapes():
        feats = torch.randn(*shape, generator=g, device="cuda").bfloat16()
        rois_t = torch.from_numpy(rois).cuda()
        out = batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8)
        want = batched_roi_align_plain(feats.float(), rois_t, 1 / 16.0, 14, 0, 8)
        err = float((out.float() - want).abs().max() / want.abs().max())
        del want
        dev_ms, how = cs.device_ms(
            lambda: batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8),
            "roi_align")
        plain_ms, _ = cs.device_ms(lambda: batched_roi_align_plain(
            feats, rois_t, 1 / 16.0, 14, 0, 8), reps=3, warmup=1)
        bound_ms, _ = cs.bound(*cs.k2_work(shape, rois, 1 / 16.0), cs.F32_OPS_S)
        fill = torch.empty_like(out)
        write_ms, _ = cs.device_ms(lambda: fill.fill_(1.0))
        del fill
        rows.append({"shape": f"{label}: feats={list(shape)} rois={len(rois)}",
                     "device_ms": dev_ms, "timed_by": how,
                     "plain_device_ms": plain_ms, "bound_ms": bound_ms,
                     "write_device_ms": write_ms, "rel_err": err})
        print(f"K2 {rows[-1]['shape']}: device {dev_ms:.4f} ms ({how}), plain "
              f"(bf16) device {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_ms / dev_ms:.2f} of it), output write alone "
              f"{write_ms:.4f} ms, max |Δ| / max |ref| "
              f"{err:.3e}", flush=True)
        del feats, out
        torch.cuda.empty_cache()
    return rows


def time_k1q() -> list:
    """K1q (``grouped_conv3x3_int8``) at each of ``cs.K1_SHAPES`` on
    ``cs.k1q_inputs`` (int8 from a ReLU'd bf16 map and per-channel weight
    scales) beside K1 (``grouped_conv3x3``, bf16) on the same map and
    weights, by device time (``cs.device_ms``, 10 launches), through the
    public wrappers only, so that a parent checkout's kernels are timed the
    same way; and whether K1q equals its plain version bit for bit."""
    import torch

    from cpt_tpu_torch.ops import quant
    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3,
                                                grouped_conv3x3_int8,
                                                reference_grouped_conv3x3_int8)

    g = torch.Generator(device="cuda").manual_seed(9)
    k1q = []
    for n, h, w, c, stride in cs.K1_SHAPES:
        x, wt, bn_s, bn_b = cs.k1q_inputs(n, h, w, c, g)
        qx, qw = quant.quant_act(x), quant.quant_weight(wt, (0, 1, 2))
        m = qx.scale * qw.scale * bn_s
        want = reference_grouped_conv3x3_int8(qx.data, qw.data, m, bn_b, 32,
                                              stride, True)
        exact = bool(torch.equal(grouped_conv3x3_int8(qx.data, qw.data, m, bn_b, 32,
                                                      stride, True), want))
        ms, how = cs.device_ms(lambda: grouped_conv3x3_int8(
            qx.data, qw.data, m, bn_b, 32, stride, True), "grouped_conv3x3_int8")
        w16 = wt.bfloat16()
        k1_ms, _ = cs.device_ms(lambda: grouped_conv3x3(x, w16, bn_s, bn_b, 32,
                                                        stride, True), "grouped_conv3x3")
        k1q.append({"shape": [n, h, w, c], "stride": stride, "device_ms": ms,
                    "timed_by": how, "k1_bf16_device_ms": k1_ms, "exact": exact})
        print(f"K1q x=[{n},{h},{w},{c}] stride={stride}: device {ms:.4f} ms ({how}), "
              f"K1 (bf16) device {k1_ms:.4f} ms; bit-equal to plain {exact}",
              flush=True)
        del x, wt, qx, qw, want
        torch.cuda.empty_cache()
    return k1q


def time_k7() -> dict:
    """K7 (``ffn_int8``) at the study's shape (M 16384, tm 1024, 768 → 3072
    → 768, the study's kind of inputs) beside K4 (``fused_ffn``, bf16) and
    the ``xla_int8`` yardstick, by device time (``cs.device_ms``, 10
    launches; K7's time sums every kernel of its call, "ffn_int8_" or, in
    older checkouts' "absmax_tiles", and is split by kernel), through
    the public wrappers only; K7's max |Δ| / max |ref| against its plain
    version in f32."""
    import torch

    from cpt_tpu_torch.ops import quant
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn

    mm, hh, ff, tm = 16384, 768, 3072, 1024
    g = torch.Generator(device="cuda").manual_seed(10)
    x = (torch.randn(mm, hh, generator=g, device="cuda") * 0.5).bfloat16()
    w1 = torch.randn(hh, ff, generator=g, device="cuda") * 0.02
    w2 = torch.randn(ff, hh, generator=g, device="cuda") * 0.02
    b1, b2 = torch.zeros(ff, device="cuda"), torch.zeros(hh, device="cuda")
    gamma, beta = torch.ones(hh, device="cuda"), torch.zeros(hh, device="cuda")
    q1, q2 = quant.quant_ffn_weights(w1), quant.quant_ffn_weights(w2)
    args = (x, q1.data, q1.scale, b1, q2.data, q2.scale, b2, gamma, beta)
    want = quant.reference_ffn_int8(x.float(), *args[1:], tm)
    err = float((quant.ffn_int8(*args, tm).float() - want).abs().max()
                / want.abs().max())
    del want
    k7_ms, how = cs.device_ms(lambda: quant.ffn_int8(*args, tm),
                              ("ffn_int8_", "absmax_tiles"))
    k7_split = {**kernel_split(lambda: quant.ffn_int8(*args, tm), "ffn_int8_"),
                **kernel_split(lambda: quant.ffn_int8(*args, tm), "absmax_tiles")}
    w1h, w2h = w1.bfloat16(), w2.bfloat16()
    k4_ms, _ = cs.device_ms(lambda: fused_ffn(x, w1h, b1, w2h, b2, gamma, beta))
    cm = [quant.QuantTensor(q.data.t().contiguous().t(), q.scale) for q in (q1, q2)]
    yard_ms, _ = cs.device_ms(lambda: cs.xla_int8_ffn(x, cm[0], b1, cm[1], b2,
                                                      gamma, beta))
    k7 = {"shape": f"x=[{mm},{hh}] F={ff} tm={tm}", "device_ms": k7_ms,
          "timed_by": how, "kernels_ms": k7_split, "k4_device_ms": k4_ms,
          "yardstick_device_ms": yard_ms, "rel_err": err}
    print(f"K7 {k7['shape']}: device {k7_ms:.4f} ms ({how}), by kernel "
          + ", ".join(f"{k} {v:.4f}" for k, v in k7_split.items())
          + f"; K4 (bf16) device {k4_ms:.4f} ms; xla_int8 yardstick device "
          f"{yard_ms:.4f} ms; max |Δ| / max |ref| {err:.3e}", flush=True)
    return k7


def time_int8_extract(counters) -> dict:
    """``tools/extract_features --synthetic 4 --copies_per_chunk 4
    --precision int8`` (chip_smoke's phase-6 tasks): copies/s of the second
    of two runs, then one run under ``torch.profiler``: device ms per chunk
    by family (``cs.EXTRACT_GROUPS``: K1q, K1, K2, cuBLAS / cuDNN,
    elementwise / reduce) and the busy share of the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpt_tpu_torch.tools import extract_features

    chunks = 4
    with tempfile.TemporaryDirectory() as root:
        flags = ["--synthetic", "4", "--copies_per_chunk", str(chunks),
                 "--precision", "int8", "--output", f"{root}/int8.tsv",
                 "--overwrite"]
        for _ in range(2):
            cs.zero_counts(counters)
            info = extract_features.main(flags)
            torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_info = extract_features.main(flags)
            torch.cuda.synchronize()
    groups, busy, top = cs.device_groups(prof, chunks, cs.EXTRACT_GROUPS)
    wall = prof_info["seconds"] * 1e3 / chunks
    print(f"extract_features --precision int8: {info['copies']} copies, "
          f"{info['copies_per_s']:.2f} copies/s; launches {launches}; per chunk "
          f"under torch.profiler {wall:.2f} ms on the host clock, device kernels "
          f"{busy:.2f} ms (busy share {busy / wall:.3f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
          + "; top: " + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top), flush=True)
    return {"copies_per_s": info["copies_per_s"], "seconds": info["seconds"],
            "launches": launches, "chunk_ms": wall, "device_ms": busy,
            "groups": groups, "top": top}


def record_k2_launches() -> list:
    """Wrap the detector's calls of ``batched_roi_align`` (box head and
    stage-5 pooling) to record each launch's (feats shape, RoI count)."""
    from cpt_tpu_torch.models.detector import attr_rcnn, heads

    seen = []
    for mod in (attr_rcnn, heads):
        def record(feats, rois, *args, _fn=mod.batched_roi_align, **kwargs):
            seen.append((tuple(feats.shape), int(rois.shape[0])))
            return _fn(feats, rois, *args, **kwargs)

        mod.batched_roi_align = record
    return seen


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--package", default=None,
                   help="import cpt_tpu_torch from this checkout")
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    args = p.parse_args(argv)
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))

    import torch

    if not torch.cuda.is_available():
        print("chip_e2e: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    from cpt_tpu_torch.kernels import build
    from cpt_tpu_torch.tools import extract_features

    package = os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))
    build.lib()
    counters = cs.kernel_counters()
    if not hasattr(counters["K1"], "path_launches"):
        # a checkout from before K1 had two kernels: every launch takes its
        # one path
        cs.k1_paths = lambda counters, launches, where: {}

    out = {"card": smi, "package": package, "k1": time_k1(),
           "attention": time_attention(), "blocks": time_blocks(),
           "flash_bwd": time_flash_bwd(), "k5": time_k5(), "k2": time_k2(),
           "int8": {"k1q": time_k1q(), "k7": time_k7()}}
    res, _ = cs.build_resident()
    out["ground"] = cs.run_requests(res, counters, profile=True)
    k2_seen = record_k2_launches()
    out["detect"] = cs.run_detect_requests(res, counters)
    out["detect"]["k2_launch_shapes"] = [
        [list(shape), n_rois, count]
        for (shape, n_rois), count in collections.Counter(k2_seen).items()]
    print("K2 launches over the --detect phase (warm-up, 3 requests, one "
          f"profiled detect step): {out['detect']['k2_launch_shapes']}",
          flush=True)
    del res
    with tempfile.TemporaryDirectory() as root:
        for _ in range(2):
            cs.zero_counts(counters)
            info = extract_features.main(["--synthetic", "4", "--copies_per_chunk",
                                          "4", "--precision", "bf16", "--output",
                                          f"{root}/bf16.tsv", "--overwrite"])
            torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    cs.k1_paths(counters, launches, "extract_features --precision bf16")
    out["bf16_extract"] = {"copies_per_s": info["copies_per_s"],
                           "seconds": info["seconds"], "launches": launches}
    print(f"extract_features --precision bf16: {info['copies']} copies, "
          f"{info['copies_per_s']:.2f} copies/s; launches {launches}", flush=True)
    out["int8_extract"] = time_int8_extract(counters)
    summary = {"k1_ms": [r["ms"] for r in out["k1"]],
               "attention_device_ms": [r["device_ms"] for r in out["attention"]],
               "sdpa_device_ms": [r["sdpa_device_ms"] for r in out["attention"]],
               "blocks_device_ms": {r["shape"]: r["device_ms"] for r in out["blocks"]},
               "flash_bwd_device_ms": [[r["dkv_device_ms"], r["dq_device_ms"]]
                                       for r in out["flash_bwd"]],
               "sdpa_bwd_device_ms": [r["sdpa_bwd_device_ms"]
                                      for r in out["flash_bwd"]],
               "k5_device_ms": {r["shape"]: r["device_ms"] for r in out["k5"]},
               "k5_path_device_ms": {r["shape"]: {p: v["device_ms"] for p, v in
                                                  r.get("paths", {}).items()}
                                     for r in out["k5"]},
               "k2_device_ms": {r["shape"]: r["device_ms"] for r in out["k2"]},
               "k2_launch_shapes": out["detect"]["k2_launch_shapes"],
               "ground_ms": [r["ms"] for r in out["ground"]["requests"]],
               "ground_copies_per_s": out["ground"]["copies_per_s"],
               "detect_step_ms": [r["detect_ms"] for r in out["detect"]["requests"]],
               "detect_ms": [r["ms"] for r in out["detect"]["requests"]],
               "bf16_extract_copies_per_s": info["copies_per_s"],
               "k1q_device_ms": [r["device_ms"] for r in out["int8"]["k1q"]],
               "k1q_k1_device_ms": [r["k1_bf16_device_ms"] for r in out["int8"]["k1q"]],
               "k7_device_ms": out["int8"]["k7"]["device_ms"],
               "k7_k4_device_ms": out["int8"]["k7"]["k4_device_ms"],
               "int8_extract_copies_per_s": out["int8_extract"]["copies_per_s"],
               "int8_extract_groups": out["int8_extract"]["groups"],
               "profiles": {k: {"ms": out[k]["profile"]["ms"],
                                "device_ms": out[k]["profile"]["device_ms"],
                                "groups": out[k]["profile"]["groups"]}
                            for k in ("ground", "detect")}}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps({"e2e": summary, "package": package}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
