#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``cpt_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py [--json details.json]

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``cpt_tpu_torch/csrc`` (nvcc);
3. hold each kernel (K1 grouped conv, K2 RoIAlign, K3 attention block and
   its attention core alone, K4 FFN block) in bf16 against its plain
   PyTorch version in f32 on the same inputs, at the main path's shapes,
   and time the kernel and the plain version in bf16 with CUDA events;
4. at full width (VinVL X152-C4 + Oscar-base, random weights from a seed in
   the reference layouts) answer 3 grounding requests through
   ``cpt_predict.predict`` and check that every kernel ran on that path.

The last two lines of standard output are a JSON summary of the kernels
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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
TOL = {"K1": 1e-2, "K2": 1e-2, "K3": 2e-2, "K3 core": 1e-2, "K4": 2e-2}

KERNELS = {
    "K1": ("grouped_conv3x3", "cpt_tpu_torch/csrc/grouped_conv.cu",
           "cpt_tpu/ops/grouped_conv.py:418"),
    "K2": ("batched_roi_align", "cpt_tpu_torch/csrc/roi_align.cu",
           "cpt_tpu/ops/roi_align_pallas.py:92"),
    "K3": ("fused_attention_block", "cpt_tpu_torch/csrc/attention.cu",
           "cpt_tpu/ops/fused_attention.py:121"),
    "K4": ("fused_ffn", "cpt_tpu_torch/csrc/gemm.cu",
           "cpt_tpu/ops/fused_ffn.py:113"),
}


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
            faults: dict | None = None) -> None:
    """Check the kernel's max |Δ| against ``exact()`` (the plain version in
    f32 on the same inputs) within the tolerance, then time the kernel and
    ``plain()`` (the plain version in the kernel's dtype) over their own
    loops of launches. ``faults`` maps a named fault (uniform attention, a
    dropped mask, ...) to the reference computed with that fault: each must
    miss the tolerance, which shows the check can fail."""
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
    rows.append({"kernel": name, "shape": label, "max_abs_err": err,
                 "tol": tol, "max_abs_ref": scale, "ms": ms,
                 "plain_ms": plain_ms, "fault_errs": fault_errs})
    faults_txt = "".join(f" {f}={e:.3e} ({e / tol:.1f}x tol)"
                         for f, e in fault_errs.items())
    print(f"{name} {label}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"({tol / max(err, 1e-30):.1f}x err) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}{faults_txt}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")
    caught = [f for f, e in fault_errs.items() if not e > tol]
    if caught:
        raise AssertionError(f"{name} {label}: the check would pass {caught}")


def check_kernels(rows: list) -> dict:
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
        compare("K1", f"x=[{n},{h},{w},{c}] cpg={c // groups} stride={stride}",
                lambda: grouped_conv3x3(x, wt, s, b, groups, stride, True),
                lambda: reference_grouped_conv3x3(x, wt, s, b, groups, stride,
                                                  True),
                lambda: reference_grouped_conv3x3(x.float(), wt.float(), s, b,
                                                  groups, stride, True), rows)

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
        compare("K2", f"feats=[8,40,64,1024] rois={n_rois}",
                lambda: batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8),
                lambda: batched_roi_align_plain(feats, rois_t, 1 / 16.0, 14,
                                                0, 8),
                lambda: batched_roi_align_plain(feats.float(), rois_t,
                                                1 / 16.0, 14, 0, 8), rows)

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

        compare("K3", f"x=[16,{s_len},768] heads=12",
                lambda: fused_attention_block(*args, heads, 1e-12),
                block_ref(args), block_ref(f32(args)), rows,
                {"uniform": block_ref(no_q), "no_mask": block_ref(no_mask)})

        # the attention core alone on a packed projection with std 1.5
        qkv = randn(16, s_len, 3 * hdim, scale=1.5)
        qkv_no_q = qkv.clone()
        qkv_no_q[..., :hdim] = 0

        def core_ref(q, bias, sc):
            return lambda: reference_attention_core(q, bias, heads, sc)

        compare("K3 core", f"qkv=[16,{s_len},2304] heads=12",
                lambda: attention_core(qkv, kb, heads, scale),
                core_ref(qkv, kb, scale), core_ref(qkv, kb, scale), rows,
                {"uniform": core_ref(qkv_no_q, kb, scale),
                 "no_mask": core_ref(qkv, torch.zeros_like(kb), scale),
                 "no_scale": core_ref(qkv, kb, 1.0)})

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
                lambda: reference_ffn(*f32(args), 1e-12, approx), rows)
    return {k: [r for r in rows if r["kernel"].split()[0] == k]
            for k in KERNELS}


def run_requests(counters) -> dict:
    """Full-width requests through ``cpt_predict.predict``."""
    import torch

    from cpt_tpu_torch.data.refcoco import tsv_region_features
    from cpt_tpu_torch.tools import cpt_predict as cp

    t0 = time.perf_counter()
    res = cp.build_resident("cuda", torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"full-width models resident in {setup_s:.1f} s "
          f"(X152-C4 detector, Oscar-base 12x768, vocab "
          f"{res.bert_cfg.vocab_size})", flush=True)

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

    with tempfile.TemporaryDirectory() as wd:
        _, cold_s = answer(*request(8), wd)
        print(f"warm-up request (8 candidates): {cold_s * 1e3:.1f} ms",
              flush=True)
        for fn in counters.values():
            fn.launches = 0
        reqs = []
        for n_dets in (8, 8, 16):
            img, dets = request(n_dets)
            box, sec = answer(img, dets, wd)
            feats = tsv_region_features(f"{wd}/predictions.tsv")
            if box not in dets:
                raise AssertionError(f"predicted {box} is not a candidate")
            if feats.shape != (n_dets, n_dets, 2054) or not np.isfinite(feats).all():
                raise AssertionError(f"bad features {feats.shape}")
            reqs.append({"candidates": n_dets, "ms": sec * 1e3, "box": box})
            print(f"request {len(reqs)} ({n_dets} candidates, 480x640 image, "
                  f"640x1024 canvas): {sec * 1e3:.1f} ms", flush=True)
        launches = {k: fn.launches for k, fn in counters.items()}
    total = sum(r["ms"] for r in reqs) / 1e3
    copies = sum(r["candidates"] for r in reqs)
    print(f"copies/s over the 3 requests: {copies / total:.2f}; launches "
          f"{launches}", flush=True)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return {"setup_s": setup_s, "warmup_ms": cold_s * 1e3, "requests": reqs,
            "copies_per_s": copies / total, "launches": launches}


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
    from cpt_tpu_torch.ops.fused_attention import fused_attention_block
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn
    from cpt_tpu_torch.ops.grouped_conv import grouped_conv3x3
    from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align

    build.lib()
    print(f"kernels built and loaded in {build.LIBRARY.build_seconds:.1f} s "
          f"({build.library_path().name})", flush=True)

    rows: list = []
    per_kernel = check_kernels(rows)
    counters = {"K1": grouped_conv3x3, "K2": batched_roi_align,
                "K3": fused_attention_block, "K4": fused_ffn}
    e2e = run_requests(counters)

    # headline shape per kernel for the summary line: the most frequent
    # main-path call (layer3 blocks; 32 RoIs; S=120; erf gelu)
    headline = {"K1": 4, "K2": 1, "K3": 0, "K4": 0}
    summary = []
    for k, (fn_name, src, replaces) in KERNELS.items():
        r = per_kernel[k][headline[k]]
        summary.append({"name": f"{k} {fn_name}", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": e2e["launches"][k],
                        "max_abs_err": max(x["max_abs_err"] for x in per_kernel[k]),
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
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
