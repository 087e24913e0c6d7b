"""GQA CPT tool: answer-vocabulary scoring at [MASK], few-shot prompt
tuning and the few-shot finetune baseline (port of
``cpt_tpu/tools/gqa_cpt.py``).

As the reference ``Oscar/oscar/fewshot/gqa_cpt.py`` does it:
``REC_MLM_CPT`` scores the answer vocabulary's first tokens at the [MASK]
slot of ``[CLS] question [SEP] [MASK] [SEP]``, the question rewritten with
the color of its painted entity where the colored TSV has the question;
training samples ``--n_sample`` colored questions with replacement and
takes one optimizer step over all of them (``grad_accum_steps``,
``gqa_cpt.py:328-334``), AdamW with stock betas and a 1.0 clip; with
``--eval_every`` the best parameters by val accuracy are kept. Results go
to a ``val_results.pk``-style pickle for ``tools/show_ensemble.py``:

  python -m cpt_tpu_torch.tools.gqa_cpt --img_feat_file plain.tsv \\
      --color_img_feat_file color.tsv --questions train.json \\
      --val_questions testdev.json --ans2label ans2label.json \\
      --vocab vocab.txt [--checkpoint pytorch_model.bin] [--n_sample 16]

The TSVs come from ``extract_features --task plain`` and ``--task gqa``.
Without ``--checkpoint`` the weights are random, drawn from
``--random_seed`` in the Oscar layout. On a CUDA device the kernels need
bf16 (the default ``--dtype``); ``--device cpu --dtype float32`` runs the
plain versions.

``--model_variant ft`` is the few-shot finetune baseline (reference
``fewshot/gqa_ft.py`` + ``modeling_gqa.py:23-76``): the raw (uncolored)
question, the plain features, and a fresh linear classifier over the
pooled output (``ImageBertForSequenceClassification``, drawn from
``--random_seed``) scoring every answer label with cross entropy; only the
encoder comes from ``--checkpoint``. ``--save_dir`` saves the final (best)
parameters and the config (``utils/checkpoint.save_model``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from cpt_tpu_torch.data.gqa import GQACPTData, load_gqa_examples
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.engine.scoring import gqa_answer_scores, make_mlm_at_mask_fn
from cpt_tpu_torch.models.bert.heads import (REC_MLM_CPT,
                                             ImageBertForSequenceClassification)
from cpt_tpu_torch.models.detector.convert import load_torch_file
from cpt_tpu_torch.tools._common import (add_clip_arg, build_tokenizer,
                                         clip_of, dtype_of, load_or_init,
                                         model_config, refuse_multi_process)
from cpt_tpu_torch.utils import checkpoint as ckpt_lib
from cpt_tpu_torch.utils import convert as cv


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--img_feat_file", required=True)
    p.add_argument("--color_img_feat_file", default=None)
    p.add_argument("--questions", required=True, help="train questions json")
    p.add_argument("--val_questions", default=None)
    p.add_argument("--val_img_feat_file", default=None,
                   help="eval-split feature TSV; the reference keeps train "
                        "and test-dev colored features in separate files "
                        "(gqa_cpt.py:797-798,997-1002). Defaults to "
                        "--img_feat_file")
    p.add_argument("--val_color_img_feat_file", default=None,
                   help="eval-split colored-feature TSV; defaults to "
                        "--color_img_feat_file")
    p.add_argument("--ans2label", required=True, help="json {answer: label}")
    p.add_argument("--vocab", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None, help="val_results.pk path")
    p.add_argument("--n_sample", type=int, default=16)
    p.add_argument("--random_seed", type=int, default=88)
    p.add_argument("--num_train_epochs", type=int, default=40)
    p.add_argument("--per_gpu_train_batch_size", type=int, default=16)
    p.add_argument("--per_gpu_eval_batch_size", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=2.5e-5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    add_clip_arg(p, "gqa_cpt.py:451-454")
    p.add_argument("--max_seq_length", type=int, default=45)
    p.add_argument("--max_img_seq_length", type=int, default=45)
    p.add_argument("--use_color", type=int, default=1)
    p.add_argument("--model_variant", default="cpt", choices=["cpt", "ft"],
                   help="cpt: [MASK] answer-vocab scoring (REC_MLM_CPT); "
                        "ft: fresh pooled linear classifier over answer "
                        "labels (reference fewshot/gqa_ft.py)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="epochs between val evals; keeps the best parameters "
                        "(reference best-model deepcopy, gqa_cpt.py:381-386)")
    p.add_argument("--save_dir", default=None,
                   help="save the final (best) parameters and the config")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--img_feature_dim", type=int, default=None)
    return p


def load_model(checkpoint: Optional[str], seed: int, cfg, device, dtype
               ) -> REC_MLM_CPT:
    """``REC_MLM_CPT`` on ``device`` from ``checkpoint`` (an Oscar
    ``pytorch_model.bin``) or, without one, from random Oscar-layout weights
    drawn from ``seed``."""
    if checkpoint:
        sd = load_torch_file(checkpoint)
    else:
        sd = cv.random_oscar_state_dict(cfg, seed=seed)
        print("WARNING: random init (no --checkpoint)")
    with torch.device(device):
        model = REC_MLM_CPT(cfg, dtype).eval()
    model.load_state_dict(cv.state_from_reference(sd, cfg))
    return model


def load_ft_model(args, cfg, device, dtype, num_labels: int
                  ) -> ImageBertForSequenceClassification:
    """The finetune baseline on ``device``: one linear layer over the pooled
    output, cross entropy over the ``num_labels`` answers (reference
    modeling_gqa.py:30-35, fewshot/gqa_ft.py:430), fresh from
    ``--random_seed``; the encoder from ``--checkpoint`` or random
    Oscar-layout weights from the same seed."""
    cfg = dataclasses.replace(cfg, num_labels=num_labels, classifier="linear",
                              loss_type="xe")
    with torch.device(device):
        model = ImageBertForSequenceClassification(cfg, dtype)
    return load_or_init(model, args, cfg, seed=args.random_seed).eval()


def evaluate(model, data: GQACPTData, batch_size: int, variant: str = "cpt"):
    """→ (accuracy·100, {q_id: {"pred", "scores"}}): each batch of
    ``batch_size`` questions (the last one padded to it) scored at its
    [MASK] over the answer vocabulary's first tokens (``variant`` "cpt"),
    or by the classifier's f32 logits over the answer labels ("ft")."""
    fn = make_mlm_at_mask_fn(model) if variant == "cpt" else _class_logits_fn(model)
    n_correct, n_total = 0, 0
    results = {}
    for start in range(0, len(data), batch_size):
        idxs = list(range(start, min(start + batch_size, len(data))))
        batch, _tokens, answers = data.batch(idxs, pad_to=batch_size)
        out = fn(batch.input_ids, batch.segment_ids, batch.attention_mask,
                 batch.img_feats, batch.mask_pos)
        scores = (gqa_answer_scores(out, data.answer_token_ids)
                  if variant == "cpt" else out)
        pred = scores.argmax(-1)
        for j, idx in enumerate(idxs):
            ex = data.examples[idx]
            results[str(ex.q_id)] = {"pred": int(pred[j]), "scores": scores[j]}
            if answers[j] >= 0:
                n_correct += int(pred[j] == answers[j])
                n_total += 1
    return 100.0 * n_correct / max(n_total, 1), results


def _class_logits_fn(model):
    """fn(input_ids, segment_ids, attention_mask, img_feats, _mask_pos),
    numpy in → the classifier's f32 logits [N, num_labels] in numpy."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def fn(input_ids, segment_ids, attention_mask, img_feats, _mask_pos):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        _, logits = model(dev(input_ids), dev(segment_ids),
                          dev(attention_mask), img_feats=dev(img_feats))
        return logits.float().cpu().numpy()

    return fn


def train(model, data: GQACPTData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None,
          val_data: Optional[GQACPTData] = None) -> List[float]:
    """Few-shot prompt tuning, the reference recipe: ``--n_sample``
    colored questions drawn with replacement under ``--random_seed``, one
    optimizer step over all of them (``grad_accum_steps`` = samples //
    batch), AdamW betas (0.9, 0.999), ``--max_grad_norm`` clip, the
    warmup-linear schedule over the optimizer steps; each epoch visits the
    samples in order, ``--per_gpu_train_batch_size`` a call; dropout from a
    generator seeded with ``--random_seed``. With ``--eval_every`` and
    ``val_data`` the parameters of the best val accuracy are restored at
    the end. ``--model_variant ft`` trains the classifier on the answer
    labels (``make_cls_train_step``), the same recipe. → each call's loss;
    ``on_step(step, loss)`` after each call."""
    ft = args.model_variant == "ft"
    idxs = data.train_indices(args.n_sample, args.random_seed)
    if not idxs:
        print("no color-marked train examples; evaluating zero-shot only")
        return []
    bsz = args.per_gpu_train_batch_size
    accum = max(1, len(idxs) // bsz)
    total = max(1, len(idxs) // (bsz * accum)) * args.num_train_epochs
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(total * args.warmup_ratio), num_train_steps=total,
        grad_accum_steps=accum, betas=(0.9, 0.999), max_grad_norm=clip_of(args))
    tx = train_lib.build_optimizer(model, ocfg)
    state = train_lib.create_train_state(model, tx)
    step_fn = (train_lib.make_cls_train_step(model, tx) if ft
               else train_lib.make_mlm_train_step(model, tx))
    generator = torch.Generator(device=device).manual_seed(args.random_seed)
    losses: List[float] = []
    best_acc, best = -1.0, None
    t0 = time.time()
    for epoch in range(args.num_train_epochs):
        for start in range(0, len(idxs), bsz):
            b, label_tokens, answers = data.batch(idxs[start:start + bsz],
                                                  pad_to=bsz)
            labels = ((answers,) if ft else (b.mask_pos, label_tokens))
            batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (b.input_ids, b.segment_ids,
                                    b.attention_mask, b.img_feats) + labels)
            state, loss = step_fn(state, batch, generator)
            losses.append(float(loss))
            if on_step is not None:
                on_step(state.step, losses[-1])
        if (epoch + 1) % 10 == 0:
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
        if (args.eval_every and val_data is not None
                and (epoch + 1) % args.eval_every == 0):
            model.eval()
            acc, _ = evaluate(model, val_data, args.per_gpu_eval_batch_size,
                              args.model_variant)
            if acc > best_acc:
                best_acc = acc
                best = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
            print(f"epoch {epoch + 1}: val acc {acc:.2f} (best {best_acc:.2f})")
    if best is not None:
        model.load_state_dict(best)
    model.eval()
    return losses


def main(argv=None):
    refuse_multi_process("gqa_cpt")
    args = build_args().parse_args(argv)
    device = torch.device(args.device)
    tokenizer = build_tokenizer(args)
    cfg = model_config(args)
    with open(args.ans2label) as f:
        ans2label = json.load(f)
    ft = args.model_variant == "ft"
    if ft:         # no color marking: the raw question, plain features
        model = load_ft_model(args, cfg, device, dtype_of(args), len(ans2label))
    else:
        model = load_model(args.checkpoint, args.random_seed, cfg, device,
                           dtype_of(args))

    def data_of(questions, feat_file, color_file):
        return GQACPTData(feat_file, color_file, load_gqa_examples(questions),
                          ans2label, tokenizer, args.max_seq_length,
                          args.max_img_seq_length, cfg.img_feature_dim,
                          use_color=bool(args.use_color) and not ft)

    train_data = data_of(args.questions, args.img_feat_file,
                         args.color_img_feat_file)
    val_data = (data_of(args.val_questions,
                        args.val_img_feat_file or args.img_feat_file,
                        args.val_color_img_feat_file or args.color_img_feat_file)
                if args.val_questions else None)
    if args.num_train_epochs > 0:
        train(model, train_data, args, device, val_data=val_data)

    acc, results = evaluate(model, val_data or train_data,
                            args.per_gpu_eval_batch_size, args.model_variant)
    print(f"accuracy: {acc:.2f}")
    if args.save_dir:
        ckpt_lib.save_model(args.save_dir, model.state_dict(), model.config)
        print(f"saved model to {args.save_dir}")
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump({"accuracy": acc, "results": results}, f)
    return acc


if __name__ == "__main__":
    main()
