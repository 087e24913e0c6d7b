"""VG relation-detection CPT tool: multi-mask predicate scoring (port of
``cpt_tpu/tools/vg_cpt.py``).

As the reference ``Oscar/oscar/fewshot/vg_cpt.py`` does it: per subject /
object pair six template sequences, "<subj> in red color is [MASK]×k a
<obj> in blue color" for k = 1..3 in both directions; a predicate's score
is the mean log-softmax probability of its k tokens at the masks of the
width-k sequence (``vg_cpt.py:255-306``); recall R@20/50/100 and
mean-recall over the predicate vocabulary against ``--gt_file``
(``utils/vg_eval.py``). Training: ``REC_MLM_CPT``'s masked-LM loss at the
three masks (the true relation at its width, the "no relation" fillers at
the others), AdamW betas (0.9, 0.98):

  python -m cpt_tpu_torch.tools.vg_cpt --feat_file predictions.tsv \\
      --predicate_vocab VG-SGG-dicts.json --gt_file gt.pk --vocab vocab.txt \\
      [--checkpoint pytorch_model.bin] [--train_feat_file train.tsv \\
      --num_train_epochs 10]

``predictions.tsv`` comes from ``extract_features --task vg``. Without
``--checkpoint`` the weights are random, drawn from ``--seed`` in the Oscar
layout. On a CUDA device the kernels need bf16 (the default ``--dtype``);
``--device cpu --dtype float32`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import pickle
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cpt_tpu_torch.data import prompts
from cpt_tpu_torch.data.vg import (VGCPTData, reverse_imkey,
                                   vg_predicate_scores)
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.engine.evaluate import vg_recall_eval
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import build_tokenizer, dtype_of, model_config
from cpt_tpu_torch.tools.refcoco_cpt import load_model


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--feat_file", required=True, help="eval predictions.tsv")
    p.add_argument("--train_feat_file", default=None)
    p.add_argument("--predicate_vocab", required=True,
                   help='json {"idx_to_predicate": {"1": "on", ...}}')
    p.add_argument("--gt_file", default=None,
                   help="pickle [{img_path, relations [R,3]}] for recall eval")
    p.add_argument("--vocab", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--num_train_epochs", type=int, default=0)
    p.add_argument("--per_gpu_train_batch_size", type=int, default=8,
                   help="pairs a step (x3 width sequences)")
    p.add_argument("--per_gpu_eval_batch_size", type=int, default=48,
                   help="sequences a batch (6 a pair)")
    p.add_argument("--learning_rate", type=float, default=2.5e-5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--seed", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--img_feature_dim", type=int, default=None)
    return p


def predicate_tokens(tokenizer, vocab_file: str) -> Dict[int, List[int]]:
    """{predicate index: its (canonicalized) word's token ids} from the
    ``--predicate_vocab`` json."""
    with open(vocab_file) as f:
        vocab = json.load(f)
    return {int(i): tokenizer.convert_tokens_to_ids(tokenizer.tokenize(
        prompts.REL_CANONICALIZE.get(p, p)))
        for i, p in vocab["idx_to_predicate"].items()}


def make_multi_mask_fn(model) -> Callable:
    """fn(input_ids, segment_ids, attention_mask, img_feats, mask_positions
    [N, W]), numpy in → f32 [N, W, vocab] numpy: the softmax in f32 of the
    MLM logits at each sequence's W mask positions."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def fn(input_ids, segment_ids, attention_mask, img_feats, mask_positions):
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        _, logits = model(dev(input_ids), dev(segment_ids), dev(attention_mask),
                          img_feats=dev(img_feats), mask_pos=dev(mask_positions))
        return torch.softmax(logits.float(), dim=-1).cpu().numpy()

    return fn


def evaluate(model, data: VGCPTData, idx2pred_tokens: Dict[int, List[int]],
             batch_size: int) -> Dict[str, np.ndarray]:
    """→ {imkey: logits [num_pred + 1]} for both directions of every pair
    (the reversed key for the reversed pair): ``batch_size`` // 6 pairs a
    batch, padded to whole pairs."""
    fn = make_multi_mask_fn(model)
    w = prompts.VG_MAX_MASK_WIDTH
    per_pair = 2 * w
    pairs_per_batch = max(1, batch_size // per_pair)
    predictions = {}
    for start in range(0, len(data), pairs_per_batch):
        idxs = list(range(start, min(start + pairs_per_batch, len(data))))
        b, _labels, mask_positions, meta = data.batch(
            idxs, both_directions=True, pad_to=pairs_per_batch * per_pair)
        probs = fn(b.input_ids, b.segment_ids, b.attention_mask, b.img_feats,
                   np.maximum(mask_positions, 0))
        for j in range(len(idxs)):
            img_key = meta[j * per_pair][1]
            rows = probs[j * per_pair:(j + 1) * per_pair]     # [6, W, V]
            for direction, key in ((0, img_key), (1, reverse_imkey(img_key))):
                predictions[key] = vg_predicate_scores(
                    rows[direction * w:(direction + 1) * w],
                    range(1, w + 1), idx2pred_tokens)
    return predictions


def train(model, data: VGCPTData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """Prompt tuning, the JAX tool's loop: AdamW with the default betas
    (0.9, 0.98), no clip, the warmup-linear schedule over (pairs // batch)
    × epochs steps; each epoch visits the pairs in the order a
    ``random.Random(--seed)`` shuffles them, ``--per_gpu_train_batch_size``
    pairs (× 3 width sequences, one direction) a step; dropout from a
    generator seeded with ``--seed``. → each step's loss; ``on_step(step,
    loss)`` after each step."""
    w = prompts.VG_MAX_MASK_WIDTH
    bsz = args.per_gpu_train_batch_size
    steps = max(1, len(data) // bsz) * args.num_train_epochs
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(steps * args.warmup_ratio), num_train_steps=steps)
    tx = train_lib.build_optimizer(model, ocfg)
    state = train_lib.create_train_state(model, tx)
    step_fn = train_lib.make_mlm_train_step(model, tx)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    order_rng = random.Random(args.seed)
    losses: List[float] = []
    t0 = time.time()
    for epoch in range(args.num_train_epochs):
        order = list(range(len(data)))
        order_rng.shuffle(order)
        for start in range(0, len(order), bsz):
            b, mlm_labels, mask_positions, _meta = data.batch(
                order[start:start + bsz], both_directions=False,
                pad_to=bsz * w)
            batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (b.input_ids, b.segment_ids,
                                    b.attention_mask, b.img_feats,
                                    np.maximum(mask_positions, 0), mlm_labels))
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
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    device = torch.device(args.device)
    tokenizer = build_tokenizer(args)
    cfg = model_config(args)
    model = load_model(cfg, args, device, dtype_of(args)).eval()
    idx2pred_tokens = predicate_tokens(tokenizer, args.predicate_vocab)
    data = VGCPTData(args.feat_file, tokenizer, args.max_seq_length,
                     args.max_img_seq_length, cfg.img_feature_dim)
    if args.num_train_epochs > 0 and args.train_feat_file:
        train(model, VGCPTData(args.train_feat_file, tokenizer,
                               args.max_seq_length, args.max_img_seq_length,
                               cfg.img_feature_dim), args, device)

    predictions = evaluate(model, data, idx2pred_tokens,
                           args.per_gpu_eval_batch_size)
    result = None
    if args.gt_file:
        with open(args.gt_file, "rb") as f:
            gts = pickle.load(f)
        result = vg_recall_eval(predictions, gts,
                                num_classes=max(idx2pred_tokens) + 1)
        print("  ".join(f"{k}: {v:.4f}" for k, v in result.items()))
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump({"predictions": predictions, "recall": result}, f)
    return predictions, result


if __name__ == "__main__":
    main()
