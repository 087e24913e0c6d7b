#!/usr/bin/env python3
"""Time one checkout of the PyTorch + CUDA port (``cpt_tpu_torch``) end to
end on one NVIDIA Hopper card with ``chip_smoke.py``'s functions, so that two
commits are timed by one script on one card.

    python3 chip_e2e.py [--package DIR] [--json out.json]

``--package DIR`` imports ``cpt_tpu_torch`` from another checkout (say the
parent commit, unpacked with ``git archive``); without it, this one's. The
run times K1 at ``chip_smoke.py``'s seven X152 shapes through the package's
``grouped_conv3x3`` (CUDA events, on the path its dispatch rule picks, with
its error against the plain version in f32), then phase 4's 3 grounding
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

    out = {"card": smi, "package": package, "k1": time_k1()}
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
