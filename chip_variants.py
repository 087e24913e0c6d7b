#!/usr/bin/env python3
"""Time variants of one kernel source on one card: each variant is this
checkout's ``cpt_tpu_torch`` with one line of one source replaced, unpacked
under ``build/variants/``, built and timed in a fresh process by one of
``chip_e2e.py``'s timing functions (the library's name hashes the sources,
so each variant builds its own). The unchanged source runs first and last,
so the spread between two runs of one build shows.

    python3 chip_variants.py --source cpt_tpu_torch/csrc/ffn_int8.cu \\
        --line 'constexpr int kG2Wgs = 1, kG2Stages = 3, kG2MinBlocks = 3;' \\
        --variant 'constexpr int kG2Wgs = 1, kG2Stages = 4, kG2MinBlocks = 2;' \\
        --measure time_k7

``--line`` must occur exactly once in the source. Each variant's output is
printed after a line naming it; a variant that fails to build or run says
so and the others go on.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", required=True, help="path of the source, from the repo root")
    p.add_argument("--line", required=True, help="the line to replace, as it stands")
    p.add_argument("--variant", action="append", required=True,
                   help="a replacement for --line (repeat for more variants)")
    p.add_argument("--measure", required=True, help="a function of chip_e2e.py to call")
    p.add_argument("--timeout", type=int, default=300, help="seconds a variant may take")
    args = p.parse_args(argv)
    text = (ROOT / args.source).read_text()
    if text.count(args.line) != 1:
        raise SystemExit(f"--line occurs {text.count(args.line)} times in {args.source}")
    lines = [args.line, *args.variant, args.line]
    failed = 0
    for i, line in enumerate(lines):
        pkg = ROOT / "build" / "variants" / str(i)
        shutil.rmtree(pkg, ignore_errors=True)
        shutil.copytree(ROOT / "cpt_tpu_torch", pkg / "cpt_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (pkg / args.source).write_text(text.replace(args.line, line))
        print(f"=== variant {i}: {line}", flush=True)
        code = (f"import sys; sys.path.insert(0, {str(pkg)!r}); "
                f"sys.path.insert(1, {str(ROOT)!r}); import chip_e2e; "
                f"chip_e2e.{args.measure}()")
        try:
            rc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                                timeout=args.timeout).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed += 1
            print(f"=== variant {i} failed: {rc}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
