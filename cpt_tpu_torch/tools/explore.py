"""Prompt-design search: rank paint colors or zero-shot templates by RefCOCO
zero-shot accuracy, or tune a continuous template (port of
``cpt_tpu/tools/explore.py``).

The reference's exploration scripts (``Oscar/oscar/explore/
explore_color_recog.py``, ``explore_template.py``,
``sgd_to_explore_template.py``) as one tool: each candidate (a color's
predictions.tsv, or a template id) goes through the standard zero-shot
RefCOCO pipeline and is ranked by accuracy; ``--mode soft`` trains the
``[unusedN]`` slot rows of the word-embedding table around [MASK] and
reads each slot out through the MLM head.

  python -m cpt_tpu_torch.tools.explore --mode templates \\
      --data_file predictions.tsv --ann_file anns.json --det_file dets.json \\
      --vocab vocab.txt [--checkpoint pytorch_model.bin]

Sweeping a color fully needs features extracted with that paint color
(stage 1): ``--color_data`` maps each color to its predictions.tsv.
Without ``--checkpoint`` the weights are random, drawn from seed 0 in the
Oscar layout; ``--checkpoint`` loads an Oscar ``pytorch_model.bin`` with
the ``REC_MLM_CPT`` layout (the JAX tool's loader raises there).
``--synthetic`` runs a tiny config on the toy vocabulary. On a CUDA device
the kernels need bf16 (the default ``--dtype``); ``--device cpu --dtype
float32`` runs their plain versions.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, tiny_bert_config
from cpt_tpu_torch.data.refcoco import RefcocoCPTData, iter_train_batches
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.engine.scoring import refcoco_evaluate
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.detector.convert import load_torch_file
from cpt_tpu_torch.utils import convert as cv
from cpt_tpu_torch.utils.tokenization import (BertTokenizer, load_vocab,
                                              toy_vocab)


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["templates", "colors", "soft"],
                   default="templates")
    p.add_argument("--soft_slots", default="2,2",
                   help="soft mode: n_pre,n_post learnable [unusedN] "
                        "slots around [MASK]")
    p.add_argument("--soft_steps", type=int, default=100,
                   help="soft mode: optimizer steps")
    p.add_argument("--soft_lr", type=float, default=0.02,
                   help="soft mode: AdamW lr on the slot embeddings "
                        "(reference sgd_to_explore_template.py:392)")
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=8)
    p.add_argument("--data_file", default=None,
                   help="predictions.tsv (templates and soft modes)")
    p.add_argument("--color_data", default=None,
                   help='json {"red": "red_predictions.tsv", ...} '
                        "(colors mode)")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--det_file", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--templates", default="1,2,3,4,5,6")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N queries")
    p.add_argument("--output", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="tiny self-contained sweep (random weights)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    return p


def build_model(args, device) -> Tuple[REC_MLM_CPT, BertTokenizer]:
    """``REC_MLM_CPT`` on ``device`` and the tokenizer: Oscar-base with the
    ``--vocab`` vocabulary, or under ``--synthetic`` the tiny config on the
    toy vocabulary; weights from ``--checkpoint`` (the ``REC_MLM_CPT``
    layout) or random Oscar-layout weights from seed 0."""
    if args.synthetic:
        tok = BertTokenizer(toy_vocab())
        cfg = tiny_bert_config(vocab_size=192, img_feature_dim=134)
    else:
        tok = BertTokenizer(load_vocab(args.vocab))
        cfg = OSCAR_BASE
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with torch.device(device):
        model = REC_MLM_CPT(cfg, dtype)
    sd = (load_torch_file(args.checkpoint) if args.checkpoint
          else cv.random_oscar_state_dict(cfg, seed=0))
    model.load_state_dict(cv.state_from_reference(
        sd, cfg, "rec_mlm_cpt", warn=bool(args.checkpoint)))
    return model.eval(), tok


def data_factory(args, tok, cfg) -> Callable[..., RefcocoCPTData]:
    """``data_for(data_file, template=None, soft_slots=None)``: the RefCOCO
    CPT dataset of one predictions.tsv under a zero-shot template, the
    few-shot one, or the soft slots."""
    def data_for(data_file: str, template: Optional[int] = None,
                 soft_slots: Optional[Tuple[int, int]] = None):
        return RefcocoCPTData(data_file, args.ann_file, args.det_file, tok,
                              img_feat_dim=cfg.img_feature_dim,
                              zsl_template=template, soft_slots=soft_slots)
    return data_for


def _limit(args, data) -> Optional[List[int]]:
    return list(range(min(args.limit, len(data)))) if args.limit else None


class SoftPromptOptimizer:
    """optax ``adamw(lr, eps=1e-8)`` (its default weight decay 1e-4, not
    torch's 1e-2) on the ``slot_ids`` rows of the word-embedding table
    alone, the JAX tool's ``soft_prompt_optimizer``
    (``cpt_tpu/tools/explore.py:97-135``): the gradient is zeroed off those
    rows before the moments and the update after them, so AdamW's decoupled
    decay moves no other row; every other parameter is frozen. The
    reference trains a 21-row table substituted at ids 1-20
    (sgd_to_explore_template.py:26-57), which comes to the same since those
    ids occur only in the slots. Takes the one-parameter train state of
    :func:`soft_prompt_state`."""

    def __init__(self, slot_ids: Sequence[int], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.slot_ids = list(slot_ids)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> train_lib.OptState:
        (table,) = params
        zero = torch.zeros_like(table, dtype=torch.float32)
        return train_lib.OptState(count=0, mu=[zero], nu=[zero.clone()])

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        keep[self.slot_ids] = 1
        return x * keep

    @torch.no_grad()
    def update(self, grads, state: train_lib.OptState,
               params: Sequence[torch.Tensor]) -> None:
        (table,), (g,) = params, grads
        g = self._rows(torch.zeros_like(table) if g is None else g.float())
        t = state.count + 1
        state.mu[0] = (1 - self.b1) * g + self.b1 * state.mu[0]
        state.nu[0] = (1 - self.b2) * g.square() + self.b2 * state.nu[0]
        fix1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** t
        fix2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** t
        u = ((state.mu[0] / fix1) / (torch.sqrt(state.nu[0] / fix2) + self.eps)
             + self.weight_decay * table)
        table.add_(self._rows(u * -self.lr))
        state.count = t


def soft_prompt_state(model: REC_MLM_CPT, tx: SoftPromptOptimizer
                      ) -> train_lib.TrainState:
    """The train state of the word-embedding table alone (the one leaf the
    soft-prompt optimizer moves; autograd computes no other gradient)."""
    params = [model.bert.embeddings.word_embeddings]
    return train_lib.TrainState(params=params, opt_state=tx.init(params))


@torch.no_grad()
def slot_readout(model: REC_MLM_CPT, tok: BertTokenizer,
                 slot_ids: Sequence[int], top: int = 20
                 ) -> List[List[Tuple[str, float]]]:
    """Each slot's trained row through the MLM head against the whole
    table (the reference's readout, sgd_to_explore_template.py:419-426):
    its ``top`` tokens with their logits, best first."""
    table = model.bert.embeddings.word_embeddings
    logits = model.mlm_head(table[list(slot_ids)].to(model.dtype), table)
    logits = logits.float().cpu().numpy()
    readout = []
    for row in logits:
        order = np.argsort(-row)[:top]
        readout.append(list(zip(tok.convert_ids_to_tokens(order.tolist()),
                                row[order].tolist())))
    return readout


def run_soft_mode(args, results: dict, device) -> dict:
    """Continuous-template search: zero-shot accuracy with the slots, then
    ``--soft_steps`` deterministic MLM steps on the slot rows alone, the
    accuracy after, and each slot's nearest vocabulary tokens."""
    n_pre, n_post = (int(x) for x in args.soft_slots.split(","))
    k = n_pre + n_post
    model, tok = build_model(args, device)
    # the vocab rows behind [unused1]..[unusedK] (id 2..K+1 in a real BERT
    # vocab, where [unused0] is 1)
    slot_ids = tok.convert_tokens_to_ids([f"[unused{i}]"
                                          for i in range(1, k + 1)])
    data = data_factory(args, tok, model.config)(args.data_file,
                                                 soft_slots=(n_pre, n_post))
    idx = _limit(args, data)
    acc0, _ = refcoco_evaluate(model, data, tok, batch_size=args.batch_size,
                               indices=idx)
    results["soft_before"] = acc0
    print(f"soft slots {n_pre}+{n_post}: zero-shot acc {acc0:.2f}")

    tx = SoftPromptOptimizer(slot_ids, args.soft_lr)
    state = soft_prompt_state(model, tx)
    step_fn = train_lib.make_mlm_train_step(model, tx, dropout=False)
    it = 0
    while it < args.soft_steps:
        for fb in iter_train_batches(data, args.train_batch_size,
                                     seed=args.seed + it):
            state, loss = step_fn(state, train_lib.batch_arrays_mlm(fb, device))
            it += 1
            if it % 20 == 0:
                print(f"soft step {it}: loss {float(loss):.4f}")
            if it >= args.soft_steps:
                break
    model.eval()
    acc1, _ = refcoco_evaluate(model, data, tok, batch_size=args.batch_size,
                               indices=idx)
    results["soft_after"] = acc1
    print(f"soft-tuned acc {acc1:.2f} (was {acc0:.2f})")
    readout = slot_readout(model, tok, slot_ids)
    for s, row in enumerate(readout):
        print(f"slot {s + 1}: {' '.join(t for t, _ in row[:5])}")
    results["soft_readout"] = readout
    return results


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_args().parse_args(argv)
    device = torch.device(args.device)
    results: dict = {}
    if args.mode == "soft":
        run_soft_mode(args, results, device)
    else:
        model, tok = build_model(args, device)
        data_for = data_factory(args, tok, model.config)
        if args.mode == "templates":
            cands = [(f"template{t}", data_for(args.data_file, int(t)))
                     for t in args.templates.split(",")]
        else:
            with open(args.color_data) as f:
                cands = [(color, data_for(tsv))
                         for color, tsv in json.load(f).items()]
        for name, data in cands:
            acc, _ = refcoco_evaluate(model, data, tok,
                                      batch_size=args.batch_size,
                                      indices=_limit(args, data))
            results[name] = acc
            print(f"{name}: acc {acc:.2f}")
        best = max(results, key=results.get)
        print(f"best: {best} ({results[best]:.2f})")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f)
    return results


if __name__ == "__main__":
    main()
