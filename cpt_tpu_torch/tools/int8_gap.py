"""Feature gaps of the W8A8 (int8) detector on RefCOCO extraction.

    python -m cpt_tpu_torch.tools.int8_gap [--synthetic 4]
        [--copies_per_chunk 4] [--device cuda|cpu]

Extracts ``tools/extract_features``'s ``--synthetic`` RefCOCO queries (VinVL
X152-C4 at full width, random weights from ``--seed``, 1024×1024 canvases,
three candidates each) at ``--precision int8`` and prints how far two
variants of the same run move the pooled part of the 2054-d features (the
six geometry dims do not depend on the detector), as the largest
``|Δ feature|`` over the int8 run's largest ``|feature|``, and as
``‖Δ‖ / ‖features‖`` over all of them:

* ``fma``: every dequant epilogue ``y·m + b`` rounded once, as a fused
  multiply-add, instead of twice. A compiler that contracts the epilogue
  moves a value by one ulp, and that can flip a later quantization tie:
  the noise between two correct int8 implementations;
* ``bf16``: the bf16 detector on the same weights and tasks (what int8
  quantization itself changes).

``chip_smoke.py`` derives its tolerance for the int8 features of the card's
kernels against their plain versions from the first gap.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from cpt_tpu_torch.ops import quant
from cpt_tpu_torch.ops.grouped_conv import exact_conv
from cpt_tpu_torch.tools import extract_features
from cpt_tpu_torch.data.refcoco import tsv_region_features
from cpt_tpu_torch.utils.tsv import TSVFile


def tsv_features(path: str) -> np.ndarray:
    """Every region's pooled feature (the geometry dims dropped) of an
    extraction TSV, in row order → [n, D - 6]."""
    tsv = TSVFile(path)
    rows = len(tsv)
    tsv.close()
    feats = [tsv_region_features(path, i) for i in range(rows)]
    return np.concatenate([f.reshape(-1, f.shape[-1])[:, :-6] for f in feats])


def _fma(y: torch.Tensor, m: torch.Tensor, bias) -> torch.Tensor:
    """``y·m + bias`` rounded once to f32 (through float64, where the
    product of two f32 values is exact)."""
    out = y.double() * m.double()
    if bias is not None:
        out = out + bias.double()
    return out.float()


@contextlib.contextmanager
def fused_epilogues():
    """Every int8 conv's epilogue rounded once (the ``fma`` variant); the
    grouped convs take their exact plain route."""
    real_epilogue, real_grouped = quant._epilogue, quant.grouped_conv3x3_int8

    def epilogue(y, m, bias, relu, out_dtype):
        y = _fma(y, m, bias)
        return (torch.relu(y) if relu else y).to(out_dtype)

    def grouped(xq, w33q, scale, bias, groups, stride=1, relu=False,
                out_dtype=torch.bfloat16):
        return epilogue(exact_conv(xq, w33q, stride, 1, groups), scale, bias,
                        relu, out_dtype)

    quant._epilogue, quant.grouped_conv3x3_int8 = epilogue, grouped
    try:
        yield
    finally:
        quant._epilogue, quant.grouped_conv3x3_int8 = real_epilogue, real_grouped


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", type=int, default=4)
    p.add_argument("--copies_per_chunk", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    dtype = "bfloat16" if args.device != "cpu" else "float32"
    common = ["--synthetic", str(args.synthetic), "--copies_per_chunk",
              str(args.copies_per_chunk), "--device", args.device,
              "--seed", str(args.seed), "--dtype", dtype] + (
                  ["--tiny"] if args.tiny else [])
    with tempfile.TemporaryDirectory() as root:
        def run(name, precision, ctx=contextlib.nullcontext()):
            out = os.path.join(root, f"{name}.tsv")
            with ctx:
                extract_features.main(common + ["--precision", precision,
                                                "--output", out])
            return tsv_features(out)

        ref = run("int8", "int8")
        variants = {name: run(name, prec, ctx) for name, prec, ctx in (
            ("fma", "int8", fused_epilogues()),
            ("bf16", "bf16", contextlib.nullcontext()))}
    scale = float(np.abs(ref).max())
    gaps = {}
    for name, feats in variants.items():
        gaps[name] = float(np.abs(feats - ref).max()) / scale
        gaps[name + " l2"] = float(np.linalg.norm(feats - ref) / np.linalg.norm(ref))
    print(f"int8 features: {ref.shape[0]} regions, largest |feature| "
          f"{scale:.4f} ({args.device}, {dtype})")
    for name in variants:
        print(f"{name}: max |Δ feature| / max |feature| = {gaps[name]:.4e}; "
              f"‖Δ‖ / ‖features‖ = {gaps[name + ' l2']:.4e}", flush=True)
    return gaps


if __name__ == "__main__":
    main()
