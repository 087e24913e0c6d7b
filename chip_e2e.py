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
chip_smoke's five attention shapes by device time beside SDPA's, K6b and
K6c at chip_smoke's three backward shapes by device time beside SDPA's
backward, then phase
4's 3 grounding
requests and 3 ``--detect`` requests (one of each under
``torch.profiler``), then ``tools/extract_features --synthetic 4
--copies_per_chunk 4 --precision bf16`` (the second of two runs), and
prints one JSON line. It checks what those functions check; ``chip_smoke.py``
is the correctness gate. Run it in turns (parent, change, change, parent)
to see the spread of the host-clock numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

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
        out = F.scaled_dot_product_attention(*leaves, attn_mask=(kb * 0.125).bfloat16(),
                                             scale=0.125)
        sdpa_ms, _ = cs.device_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                              retain_graph=True))
        label = f"K6b/K6c q=[{b},12,{s_len},64] bias={list(kb.shape)}"
        rows.append({"shape": label, "dkv_device_ms": dkv_ms, "dq_device_ms": dq_ms,
                     "timed_by": how, "sdpa_bwd_device_ms": sdpa_ms,
                     "rel_err": errs})
        print(f"{label}: K6b device {dkv_ms:.4f} ms, K6c device {dq_ms:.4f} ms "
              f"({how}), sum {dkv_ms + dq_ms:.4f}; SDPA backward device "
              f"{sdpa_ms:.4f} ms; dq/dk/dv max |Δ| / max |ref| "
              + "/".join(f"{e:.3e}" for e in errs), flush=True)
    return rows


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
           "attention": time_attention(), "flash_bwd": time_flash_bwd()}
    res, _ = cs.build_resident()
    out["ground"] = cs.run_requests(res, counters, profile=True)
    out["detect"] = cs.run_detect_requests(res, counters)
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
    summary = {"k1_ms": [r["ms"] for r in out["k1"]],
               "attention_device_ms": [r["device_ms"] for r in out["attention"]],
               "sdpa_device_ms": [r["sdpa_device_ms"] for r in out["attention"]],
               "flash_bwd_device_ms": [[r["dkv_device_ms"], r["dq_device_ms"]]
                                       for r in out["flash_bwd"]],
               "sdpa_bwd_device_ms": [r["sdpa_bwd_device_ms"]
                                      for r in out["flash_bwd"]],
               "ground_ms": [r["ms"] for r in out["ground"]["requests"]],
               "ground_copies_per_s": out["ground"]["copies_per_s"],
               "detect_step_ms": [r["detect_ms"] for r in out["detect"]["requests"]],
               "detect_ms": [r["ms"] for r in out["detect"]["requests"]],
               "bf16_extract_copies_per_s": info["copies_per_s"],
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
