#!/usr/bin/env python3
"""How far the port's bf16 grounding scores move with the scoring batch's
shape. Phase 8's two resized requests (``chip_smoke.RESIZED_REQUESTS``),
each as the raw array and as its quality-95 JPEG upload, go through
``cpt_predict.predict`` on the full-width service's weights; the
interchange files it writes are then scored at (region slots, rows)
(50, 16), cpt_predict's shape, and at (8, 8), the served bucket, (8, 16)
and (50, 8), by the kernel path, the plain bf16 path and the f32 einsum
path, with cuBLAS's reduced-precision bf16 reduction
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``)
on and off. Prints one JSON line per request, path and setting: each
shape's largest score gap to (50, 16) and the largest gap of an encoder
layer's output over the real sequences and tokens. Needs a CUDA card;
``--tiny --device cpu`` runs the code paths on the CPU.

    python3 score_shape_gap.py [--tiny --device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from cpt_tpu_torch.data.refcoco import RefcocoCPTData, iter_eval_batches
from cpt_tpu_torch.engine.scoring import (make_mlm_at_mask_fn,
                                          refcoco_collect_scores, run_mlm_batch)
from cpt_tpu_torch.tools import cpt_predict as cp
from cpt_tpu_torch.tools import serve

SHAPES = ((50, 16), (8, 8), (8, 16), (50, 8))


def score(model, wd: str, tokenizer, img_dim: int, slots: int, rows: int):
    """(scores, [per layer: output over the real sequences]) of the
    request whose interchange files are in ``wd``, at one shape."""
    layers = []
    hooks = [layer.register_forward_hook(
        lambda _m, _i, out: layers.append(out.float()))
        for layer in model.bert.encoder.layer]
    data = RefcocoCPTData(os.path.join(wd, "predictions.tsv"),
                          os.path.join(wd, "ann.json"),
                          os.path.join(wd, "stage2_det.json"), tokenizer,
                          img_seq_len=slots, img_feat_dim=img_dim)
    fn = make_mlm_at_mask_fn(model)
    scores, n_seq = [], 0
    try:
        for batch, _ in iter_eval_batches(data, rows):
            for sc, _ in refcoco_collect_scores(run_mlm_batch(fn, batch), batch,
                                                tokenizer).values():
                scores.extend(sc)
            n_seq += len(batch.slot_meta)
    finally:
        data.tsv.close()
        for h in hooks:
            h.remove()
    return np.asarray(scores), [t[:n_seq] for t in layers]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("score_shape_gap: no CUDA device", file=sys.stderr)
        return 1
    svc = serve.CPTService(serve.build_args().parse_args(
        ["--device", args.device, "--no_warmup"] + (["--tiny"] if args.tiny else [])))
    res = svc.res
    dim = res.bert_cfg.img_feature_dim
    paths = {"kernel": res.oscar,
             "plain_bf16": cs.rebuilt_scorer(res, torch.bfloat16,
                                             attention_impl="einsum",
                                             ffn_impl="dense").oscar,
             "f32": cs.rebuilt_scorer(res, torch.float32,
                                      attention_impl="einsum",
                                      ffn_impl="dense").oscar}
    flags = torch.backends.cuda.matmul
    for name in cs.RESIZED_REQUESTS:
        for kind in ("raw", "jpeg"):
            img, dets = cs.resized_request(name)
            if kind == "jpeg":
                img = cs.jpeg_upload(img)[1]
            small, scale = svc._resize(img)
            sdets = (np.asarray(dets, np.float32) * scale).tolist()
            with tempfile.TemporaryDirectory() as wd:
                cp.predict(res, small, cs.SERVE_CAPTION, sdets, workdir=wd)
                for path, model in paths.items():
                    for reduced in (True, False):
                        flags.allow_bf16_reduced_precision_reduction = reduced
                        try:
                            got = {s: score(model, wd, res.tokenizer, dim, *s)
                                   for s in SHAPES}
                        finally:
                            flags.allow_bf16_reduced_precision_reduction = False
                        ref_scores, ref_layers = got[SHAPES[0]]
                        row = {"request": f"{name} {kind}", "path": path,
                               "reduced_precision_reduction": reduced,
                               "score_gap": {}, "layer_gap": {}}
                        for (slots, rows), (scores, layers) in got.items():
                            if (slots, rows) == SHAPES[0]:
                                continue
                            key = f"{slots}x{rows}"
                            row["score_gap"][key] = float(
                                np.abs(scores - ref_scores).max())
                            t = min(a.shape[1] for a in (layers[0], ref_layers[0]))
                            row["layer_gap"][key] = max(
                                float((a[:, :t] - b[:, :t]).abs().max())
                                for a, b in zip(layers, ref_layers))
                        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
