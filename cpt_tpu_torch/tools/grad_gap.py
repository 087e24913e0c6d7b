"""Gradient and loss-curve gaps of ``REC_MLM_CPT`` prompt tuning between
model variants (attention backend × compute dtype) on the same weights and
batches. Its pieces also take ``NSPCPT`` and VCR-shaped NSP batches
(:func:`nsp_batch`), which ``chip_smoke.py`` holds to the same gaps.

    python -m cpt_tpu_torch.tools.grad_gap [--batch 4] [--steps 10] [--device cuda|cpu]

Builds Oscar-base at full width (12 × 768, vocab 30522) from seeded random
Oscar-layout weights and synthetic batches (70 text + 50 region slots, some
padding, one [MASK] per sequence labelled with the color word or "none",
as in RefCOCO prompt tuning), with dropout off. It prints each variant's
gradients against the f32 einsum path (``attention_impl="einsum"``, dense
FFN): the plain path in bf16, the flash path in bf16 (K6/K6b/K6c; their
plain versions on the CPU), and the flash path with K6b's dK zeroed. The
gradient gap of a variant is the largest, over parameter tensors, of
``‖g − g_f32‖ / ‖g_f32‖``. Then (``--steps``) each variant trains that
many deterministic AdamW steps on two alternating batches, and the loss
gap is the largest difference from the f32 path's loss at the same step.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, BertConfig
from cpt_tpu_torch.engine import train
from cpt_tpu_torch.engine.train import OptimConfig
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT, cross_entropy_ignore_index
from cpt_tpu_torch.ops import attention
from cpt_tpu_torch.utils import convert

FLASH = dict(attention_impl="flash", attention_probs_dropout_prob=0.0)
PLAIN = dict(attention_impl="einsum", ffn_impl="dense")
# "red" and "none" in bert-base-uncased's vocabulary: the two kinds of
# label of RefCOCO prompt tuning (a colored copy's color, or "none")
LABEL_IDS = (2417, 3904)
# refcoco_cpt's optimizer over a 10-step run (warmup ratio 0.1)
CURVE_OPTIM = OptimConfig(learning_rate=2.5e-5, weight_decay=0.05,
                          warmup_steps=1, num_train_steps=10)


def synthetic_batch(cfg: BertConfig, n: int, seed: int, device,
                    text: int = 70, regions: int = 50) -> Tuple[torch.Tensor, ...]:
    """(input_ids, segment_ids, attention_mask, img_feats, mask_pos,
    labels) with per-sequence text and region lengths drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1000, cfg.vocab_size, (n, text))
    ids[:, 0] = 101
    mask = np.zeros((n, text + regions), np.int64)
    for i in range(n):
        mask[i, :rng.randint(20, text + 1)] = 1
        mask[i, text:text + rng.randint(8, regions + 1)] = 1
    feats = (rng.rand(n, regions, cfg.img_feature_dim) * 2).astype(np.float32)
    pos = rng.randint(1, 20, n)
    labels = np.asarray(LABEL_IDS)[rng.randint(0, 2, n)]
    arrays = (ids, np.zeros_like(ids), mask, feats, pos, labels)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def nsp_batch(cfg: BertConfig, n: int, seed: int, device, text: int = 80,
              regions: int = 60) -> Tuple[torch.Tensor, ...]:
    """(input_ids, segment_ids, attention_mask, img_feats, labels): VCR-shaped
    NSP sequences (a question in segment 0, then a candidate in segment 1
    from a drawn split point), the text and regions of
    :func:`synthetic_batch`, and one label a sequence: 0 on the first of
    each group of 4 candidates, 1 on the others."""
    ids, _, mask, feats, _, _ = synthetic_batch(cfg, n, seed, device, text,
                                                regions)
    split = np.random.RandomState(seed + 1).randint(8, 20, n)
    seg = (torch.arange(text, device=device)[None]
           >= torch.from_numpy(split).to(device)[:, None]) & (mask[:, :text] > 0)
    labels = torch.from_numpy((np.arange(n) % 4 != 0).astype(np.int64))
    return ids, seg.long(), mask, feats, labels.to(device)


def build(state: Dict[str, torch.Tensor], cfg: BertConfig, dtype, device,
          model_cls=REC_MLM_CPT, **config_changes):
    with torch.device(device):
        model = model_cls(dataclasses.replace(cfg, **config_changes), dtype)
    model.load_state_dict(state)
    return model.eval()


def step_grads(model, batch) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, f32 gradient of every parameter) of one step with dropout off:
    at [MASK] for ``REC_MLM_CPT``, the NSP loss for ``NSPCPT`` (batches of
    :func:`nsp_batch`); a parameter the loss does not reach gets zeros."""
    if model.TASK == "nsp_cpt":
        ids, seg, mask, feats, labels = batch
        loss, _ = model.eval()(ids, seg, mask, img_feats=feats,
                               next_sentence_label=labels)
    else:
        ids, seg, mask, feats, pos, labels = batch
        _, at_mask = model.eval()(ids, seg, mask, img_feats=feats, mask_pos=pos)
        loss = cross_entropy_ignore_index(at_mask, labels)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return float(loss.detach()), {
        n: (torch.zeros_like(p) if g is None else g.float())
        for (n, p), g in zip(params.items(), grads)}


def gap(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
        ) -> Tuple[float, str]:
    """(largest per-tensor ‖g − ref‖ / ‖ref‖, that tensor's name), over the
    tensors whose reference gradient is not zero."""
    worst = (0.0, "")
    for n, r in ref.items():
        norm = float(r.norm())
        if norm > 0:
            worst = max(worst, (float((grads[n] - r).norm()) / norm, n))
    return worst


def loss_curve(model: REC_MLM_CPT, batches, steps: int) -> List[float]:
    """The losses of ``steps`` deterministic prompt-tuning steps (AdamW,
    ``CURVE_OPTIM``) on ``batches`` in turn."""
    tx = train.build_optimizer(model, CURVE_OPTIM)
    state = train.create_train_state(model, tx)
    step = train.make_mlm_train_step(model, tx, dropout=False)
    return [float(step(state, batches[i % len(batches)])[1]) for i in range(steps)]


@contextlib.contextmanager
def zeroed_dk():
    """K6b's dK replaced by zeros (a fault the gradient check must catch)."""
    real = attention.flash_mha_bwd_dkv

    def faulty(*args, **kwargs):
        dk, dv = real(*args, **kwargs)
        return torch.zeros_like(dk), dv

    faulty.launches = 0   # the wrapper counts its launches under this name
    attention.flash_mha_bwd_dkv = faulty
    try:
        yield
    finally:
        attention.flash_mha_bwd_dkv = real


def main(argv=None) -> Dict[str, Tuple[float, str]]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=10,
                   help="loss-curve steps (0: gradients only)")
    p.add_argument("--device", default="cuda",
                   help="cpu runs every kernel's plain version (the "
                        "derivation chip_smoke.py cites ran so)")
    args = p.parse_args(argv)
    cfg = OSCAR_BASE
    state = convert.state_from_reference(
        convert.random_oscar_state_dict(cfg, seed=args.seed), cfg)
    batch = synthetic_batch(cfg, args.batch, args.seed, args.device)
    loss, ref = step_grads(build(state, cfg, torch.float32, args.device, **PLAIN),
                           batch)
    print(f"f32 einsum: loss {loss:.6f}")
    out = {}
    flash = build(state, cfg, torch.bfloat16, args.device, **FLASH)
    for name, model, fault in (
            ("bf16 einsum", build(state, cfg, torch.bfloat16, args.device, **PLAIN),
             contextlib.nullcontext()),
            ("bf16 flash", flash, contextlib.nullcontext()),
            ("bf16 flash, dK zeroed", flash, zeroed_dk())):
        with fault:
            loss_v, grads = step_grads(model, batch)
        out[name] = gap(grads, ref)
        print(f"{name}: loss {loss_v:.6f}; gradient gap {out[name][0]:.4e} "
              f"(worst tensor {out[name][1]})", flush=True)
    if args.steps:
        batches = [batch, synthetic_batch(cfg, args.batch, args.seed + 1,
                                          args.device)]
        curves = {name: loss_curve(build(state, cfg, dtype, args.device, **kw),
                                   batches, args.steps)
                  for name, dtype, kw in (("f32 einsum", torch.float32, PLAIN),
                                          ("bf16 einsum", torch.bfloat16, PLAIN),
                                          ("bf16 flash", torch.bfloat16, FLASH))}
        ref_curve = np.asarray(curves["f32 einsum"])
        for name, c in curves.items():
            print(f"{name}: losses " + " ".join(f"{x:.4f}" for x in c)
                  + f"; max gap to f32 {np.abs(np.asarray(c) - ref_curve).max():.4e}",
                  flush=True)
    return out


if __name__ == "__main__":
    main()
