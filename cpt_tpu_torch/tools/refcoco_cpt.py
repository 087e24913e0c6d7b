"""RefCOCO CPT grounding tool — zero-shot eval and few-shot prompt tuning
(port of ``cpt_tpu/tools/refcoco_cpt.py``).

Mirrors the reference entry points ``Oscar/oscar/fewshot/refcoco_cpt.py`` and
``Oscar/oscar/zeroshot/refcoco_cpt.py``: loads cached stage-1 features
(predictions.tsv), optionally prompt-tunes ``REC_MLM_CPT`` for N epochs
(``--train_data_file``), then reports grounding accuracy (IoU > 0.5).

Usage:
  python -m cpt_tpu_torch.tools.refcoco_cpt \\
      --data_file .../predictions.tsv --ann_file .../finetune_refcoco.json \\
      --det_file .../dets.json --vocab .../vocab.txt \\
      [--checkpoint .../pytorch_model.bin] [--train_data_file ...] \\
      [--num_train_epochs 20] [--learning_rate 2.5e-5] [--device cuda]

Without ``--checkpoint`` the weights are random, drawn from ``--seed`` in
the Oscar layout. On a CUDA device the kernels need bf16 (the default
``--dtype``); ``--device cpu --dtype float32`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, List, Optional

import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, BertConfig
from cpt_tpu_torch.data.refcoco import RefcocoCPTData, iter_train_batches
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.engine.scoring import refcoco_evaluate
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.detector.convert import load_torch_file
from cpt_tpu_torch.utils import convert as cv
from cpt_tpu_torch.utils.tokenization import BertTokenizer, toy_vocab


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_file", required=True, help="eval predictions.tsv")
    p.add_argument("--train_data_file", default=None,
                   help="train predictions.tsv (few-shot); omit for zero-shot")
    p.add_argument("--ann_file", required=True)
    p.add_argument("--train_ann_file", default=None)
    p.add_argument("--det_file", required=True)
    p.add_argument("--train_det_file", default=None)
    p.add_argument("--vocab", default=None,
                   help="vocab.txt (bert-base-uncased); toy vocab if omitted")
    p.add_argument("--checkpoint", default=None,
                   help="Oscar pytorch_model.bin (random weights if omitted)")
    p.add_argument("--output", default=None, help="predictions json out")
    p.add_argument("--txt_seq_len", type=int, default=70)
    p.add_argument("--img_seq_len", type=int, default=50)
    p.add_argument("--per_gpu_eval_batch_size", type=int, default=128)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel devices (only 1 until the parallel "
                        "port)")
    p.add_argument("--per_gpu_train_batch_size", type=int, default=32)
    p.add_argument("--num_train_epochs", type=int, default=20)
    p.add_argument("--learning_rate", type=float, default=2.5e-5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--lr_mul", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=8)
    p.add_argument("--zsl_template", type=int, default=None,
                   help="zero-shot template variant 1-6 (reference "
                        "refcoco_zsl_cpt_dataset.py); default = fsl template")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    # tiny-config escape hatch for smoke runs without a checkpoint
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--img_feature_dim", type=int, default=None)
    return p


def model_config(args) -> BertConfig:
    overrides = {}
    for k in ("hidden_size", "num_hidden_layers", "img_feature_dim"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.hidden_size is not None and args.hidden_size < 768:
        overrides.setdefault("num_attention_heads",
                             max(1, args.hidden_size // 16))
        overrides.setdefault("intermediate_size", args.hidden_size * 4)
        overrides.setdefault("vocab_size", 30522)
    return dataclasses.replace(OSCAR_BASE, **overrides)


def load_model(cfg: BertConfig, args, device, dtype) -> REC_MLM_CPT:
    """``REC_MLM_CPT`` on ``device`` from ``--checkpoint`` (an Oscar
    ``pytorch_model.bin``) or from random Oscar-layout weights drawn from
    ``--seed``."""
    if args.checkpoint:
        sd = load_torch_file(args.checkpoint)
        print(f"loaded checkpoint {args.checkpoint}")
    else:
        sd = cv.random_oscar_state_dict(cfg, seed=args.seed)
        print("WARNING: random init (no --checkpoint)")
    with torch.device(device):
        model = REC_MLM_CPT(cfg, dtype)
    model.load_state_dict(cv.state_from_reference(sd, cfg))
    return model


def train(model: REC_MLM_CPT, train_data: RefcocoCPTData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """Few-shot prompt tuning (the reference's train loop): AdamW with the
    warmup-linear schedule sized like the reference (iterations per epoch ×
    epochs), dropout from a generator seeded with ``--seed``. Returns each
    step's loss; ``on_step(step, loss)`` is called after each step.

    A batch that raises ``RuntimeError`` is skipped, as the reference skips
    it (``refcoco_cpt.py:244-253``). A kernel fault (``KernelError``, not a
    ``RuntimeError``) and a device fault (``torch.AcceleratorError``, which
    leaves the device unusable) propagate."""
    approx_steps = max(1, (len(train_data) * 2 //
                           args.per_gpu_train_batch_size)) * args.num_train_epochs
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(approx_steps * args.warmup_ratio),
        num_train_steps=approx_steps, lr_mul=args.lr_mul)
    tx = train_lib.build_optimizer(model, ocfg)
    state = train_lib.create_train_state(model, tx)
    step_fn = train_lib.make_mlm_train_step(model, tx)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    losses: List[float] = []
    t0 = time.time()
    for epoch in range(args.num_train_epochs):
        for fb in iter_train_batches(train_data, args.per_gpu_train_batch_size,
                                     seed=args.seed + epoch):
            try:
                state, loss = step_fn(
                    state, train_lib.batch_arrays_mlm(fb, device), generator)
            except RuntimeError as e:
                if isinstance(e, getattr(torch, "AcceleratorError", ())):
                    raise
                print(f"runtime error, skipping batch: {e}")
                continue
            losses.append(float(loss))
            if on_step is not None:
                on_step(state.step, losses[-1])
        if losses:
            print(f"epoch {epoch}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s elapsed)")
    model.eval()
    return losses


def main(argv=None):
    args = build_args().parse_args(argv)
    if args.dp > 1:
        raise NotImplementedError("--dp > 1: data parallelism is not ported yet")
    device = torch.device(args.device)
    tokenizer = BertTokenizer(args.vocab if args.vocab else toy_vocab())
    cfg = model_config(args)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = load_model(cfg, args, device, dtype).eval()
    data = RefcocoCPTData(args.data_file, args.ann_file, args.det_file,
                          tokenizer, args.txt_seq_len, args.img_seq_len,
                          cfg.img_feature_dim, zsl_template=args.zsl_template)
    if args.train_data_file:
        train_data = RefcocoCPTData(
            args.train_data_file, args.train_ann_file or args.ann_file,
            args.train_det_file or args.det_file, tokenizer,
            args.txt_seq_len, args.img_seq_len, cfg.img_feature_dim)
        train(model, train_data, args, device)

    t0 = time.time()
    acc, preds = refcoco_evaluate(model, data, tokenizer,
                                  batch_size=args.per_gpu_eval_batch_size)
    dt = time.time() - t0
    print(f"miou: {acc:.2f}")
    print(f"eval wall-clock: {dt:.1f}s "
          f"({len(data) / max(dt, 1e-9):.1f} queries/s)")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"accuracy": acc, "predictions": preds}, f)
    return acc


if __name__ == "__main__":
    main()
