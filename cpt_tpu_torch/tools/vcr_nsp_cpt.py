"""VCR CPT tool: q→a / qa→r NSP candidate scoring, and q→ar with twin
heads (port of ``cpt_tpu/tools/vcr_nsp_cpt.py``).

As the reference ``Oscar/oscar/fewshot/vcr_nsp_cpt.py`` and
``vcr_qar_nsp_cpt.py`` do it: each question's candidates become sequence
pairs; ``NSPCPT`` (the pretrained NSP head) scores each, score =
1 − softmax[:, 1]; the argmax over a question's candidates is its answer.
Training labels: 0 at the correct candidate, 1 elsewhere. ``--task qar``
uses ``VCRQAR_NSPCPT``'s twin heads: answers with the "ans" head,
rationales (conditioned on the gt answer) with "rat"; q→ar is right only
when both are.

  python -m cpt_tpu_torch.tools.vcr_nsp_cpt --feat_file predictions.tsv \\
      --examples val.jsonl --task qa --vocab vocab.txt \\
      [--checkpoint pytorch_model.bin] [--num_train_epochs 10]

``predictions.tsv`` comes from ``extract_features --task vcr``. Without
``--checkpoint`` the weights are random, drawn from ``--seed`` in the Oscar
layout. On a CUDA device the kernels need bf16 (the default ``--dtype``);
``--device cpu --dtype float32`` runs the plain versions.

``--model_variant ft`` is the full-finetune baseline (reference
``vcr_ft.py``): ``NSPFT`` (``VCR_QAR_NSPFT``'s twin classifiers for
``--task qar``), fresh classifiers drawn from ``--seed`` over the encoder
alone, scored and trained as the CPT models are.
"""
from __future__ import annotations

import argparse
import pickle
import random
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from cpt_tpu_torch.data.vcr import VCRCPTData, load_vcr_examples
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.engine.scoring import make_nsp_score_fn
from cpt_tpu_torch.models.bert.heads import (NSPCPT, NSPFT, VCR_QAR_NSPFT,
                                             VCRQAR_NSPCPT)
from cpt_tpu_torch.tools._common import (add_clip_arg, build_tokenizer,
                                         clip_of, dtype_of, load_or_init,
                                         model_config, refuse_multi_process)


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--feat_file", required=True)
    p.add_argument("--examples", required=True, help="examples json/jsonl")
    p.add_argument("--val_examples", default=None)
    p.add_argument("--val_feat_file", default=None,
                   help="eval-split feature TSV; the reference loads train "
                        "and eval features from separate dirs "
                        "(vcr_nsp_cpt.py:774-776,968-981). Defaults to "
                        "--feat_file")
    p.add_argument("--task", default="qa", choices=["qa", "qar_r", "qar"],
                   help="qa: q->a; qar_r: qa->r; qar: q->ar twin heads")
    p.add_argument("--model_variant", default="cpt", choices=["cpt", "ft"],
                   help="cpt: pretrained NSP head (NSPCPT); ft: fresh "
                        "classifier (NSPFT, reference vcr_ft.py)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--num_train_epochs", type=int, default=0)
    p.add_argument("--per_gpu_train_batch_size", type=int, default=4,
                   help="examples per batch (x num candidates sequences)")
    p.add_argument("--per_gpu_eval_batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=2.5e-5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    add_clip_arg(p, "vcr_nsp_cpt.py:458-461")
    p.add_argument("--max_seq_length", type=int, default=80)
    p.add_argument("--max_img_seq_length", type=int, default=60)
    p.add_argument("--seed", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--img_feature_dim", type=int, default=None)
    return p


def group_scores(flat_scores: np.ndarray, meta, n_examples: int):
    """[(example idx, cand idx)] + flat scores → {example: [cand scores]}."""
    grouped = {}
    for s, (ex_i, ci) in zip(flat_scores, meta):
        grouped.setdefault(ex_i, {})[ci] = float(s)
    return {k: [v[i] for i in sorted(v)] for k, v in grouped.items()}


def run_eval(model, data: VCRCPTData, batch_size: int, *, head=None,
             use_rationale=False):
    """→ (accuracy·100, {q_id: {"pred", "scores", "gt"}}); each batch of
    ``batch_size`` examples is padded to ``batch_size`` × its largest
    candidate count sequences."""
    fn = make_nsp_score_fn(model, head=head)
    results, n_correct, n_total = {}, 0, 0
    for start in range(0, len(data), batch_size):
        idxs = list(range(start, min(start + batch_size, len(data))))
        max_cands = max(
            len(data.examples[i].rationale_choices if use_rationale
                else data.examples[i].choices) for i in idxs)
        b, _labels, meta = data.batch(idxs, use_rationale=use_rationale,
                                      pad_to=batch_size * max_cands)
        scores = fn(b.input_ids, b.segment_ids, b.attention_mask, b.img_feats)
        grouped = group_scores(scores[: len(meta)], meta, len(idxs))
        for ex_i, cand_scores in grouped.items():
            ex = data.examples[ex_i]
            pred = int(np.argmax(cand_scores))
            gt = ex.rationale_label if use_rationale else ex.label
            results[ex.q_id] = {"pred": pred, "scores": cand_scores, "gt": gt}
            if gt is not None:
                n_correct += int(pred == gt)
                n_total += 1
    return 100.0 * n_correct / max(n_total, 1), results


def load_model(args, cfg, device, dtype):
    """``NSPCPT`` (``VCRQAR_NSPCPT`` for ``--task qar``) on ``device`` from
    ``--checkpoint`` (an Oscar ``pytorch_model.bin``: the NSP head, copied
    into both twin heads) or from random Oscar-layout weights drawn from
    ``--seed``; with ``--model_variant ft``, ``NSPFT`` (``VCR_QAR_NSPFT``)
    with the encoder alone from there and fresh classifiers from
    ``--seed``."""
    twin = args.task == "qar"
    if args.model_variant == "ft":
        model_cls, task = (VCR_QAR_NSPFT if twin else NSPFT), "bert_only"
    else:
        model_cls = VCRQAR_NSPCPT if twin else NSPCPT
        task = model_cls.TASK
    with torch.device(device):
        model = model_cls(cfg, dtype)
    return load_or_init(model, args, cfg, task).eval()


def train(model, data: VCRCPTData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """Few-shot NSP prompt tuning, the JAX tool's loop: stock AdamW betas,
    ``--max_grad_norm`` clip and the warmup-linear schedule sized by
    (examples // batch) × epochs (reference vcr_nsp_cpt.py:385,458); each
    epoch visits the examples in the order a ``random.Random(--seed)``
    shuffles them, ``--per_gpu_train_batch_size`` examples (× their
    candidates) a step; dropout from a generator seeded with ``--seed``.
    → each step's loss; ``on_step(step, loss)`` after each step."""
    use_rat = args.task == "qar_r"
    twin = args.task == "qar"
    n_cands = len(data.examples[0].rationale_choices if use_rat
                  else data.examples[0].choices)
    bsz = args.per_gpu_train_batch_size
    steps = max(1, len(data) // bsz) * args.num_train_epochs
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(steps * args.warmup_ratio), num_train_steps=steps,
        betas=(0.9, 0.999), max_grad_norm=clip_of(args))
    tx = train_lib.build_optimizer(model, ocfg)
    state = train_lib.create_train_state(model, tx)
    head = ("rat" if use_rat else "ans") if twin else None
    step_fn = train_lib.make_nsp_train_step(model, tx, head=head)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    order_rng = random.Random(args.seed)
    losses: List[float] = []
    t0 = time.time()
    for epoch in range(args.num_train_epochs):
        order = list(range(len(data)))
        order_rng.shuffle(order)
        for start in range(0, len(order), bsz):
            b, labels, _meta = data.batch(order[start:start + bsz],
                                          use_rationale=use_rat,
                                          pad_to=bsz * n_cands)
            batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (b.input_ids, b.segment_ids,
                                    b.attention_mask, b.img_feats, labels))
            state, loss = step_fn(state, batch, generator)
            losses.append(float(loss))
            if on_step is not None:
                on_step(state.step, losses[-1])
        if (epoch + 1) % 5 == 0:
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
    model.eval()
    return losses


def main(argv=None):
    refuse_multi_process("vcr_nsp_cpt")
    args = build_args().parse_args(argv)
    device = torch.device(args.device)
    tokenizer = build_tokenizer(args)
    cfg = model_config(args)
    model = load_model(args, cfg, device, dtype_of(args))

    data = VCRCPTData(args.feat_file, load_vcr_examples(args.examples),
                      tokenizer, args.max_seq_length, args.max_img_seq_length,
                      cfg.img_feature_dim)
    val_data = (VCRCPTData(args.val_feat_file or args.feat_file,
                           load_vcr_examples(args.val_examples), tokenizer,
                           args.max_seq_length, args.max_img_seq_length,
                           cfg.img_feature_dim)
                if args.val_examples else data)
    if args.num_train_epochs > 0:
        train(model, data, args, device)

    bs = args.per_gpu_eval_batch_size
    if args.task == "qar":
        acc_a, res_a = run_eval(model, val_data, bs, head="ans")
        acc_r, res_r = run_eval(model, val_data, bs, head="rat",
                                use_rationale=True)
        both = [int(res_a[q]["pred"] == res_a[q]["gt"]
                    and res_r[q]["pred"] == res_r[q]["gt"])
                for q in res_a if res_a[q]["gt"] is not None]
        acc = 100.0 * float(np.mean(both)) if both else 0.0
        print(f"q->a: {acc_a:.2f}  qa->r: {acc_r:.2f}  q->ar: {acc:.2f}")
        results = {"qa": res_a, "qar": res_r}
    else:
        acc, results = run_eval(model, val_data, bs,
                                use_rationale=args.task == "qar_r")
        print(f"accuracy: {acc:.2f}")
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump({"accuracy": acc, "results": results}, f)
    return acc


if __name__ == "__main__":
    main()
