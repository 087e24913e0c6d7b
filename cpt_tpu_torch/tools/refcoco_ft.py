"""RefCOCO full-finetune baseline tool, ``REC_FT`` (port of
``cpt_tpu/tools/refcoco_ft.py``).

As the reference ``Oscar/oscar/fewshot/refcoco_ft.py`` (with
``datasets/refcoco_ft_dataset.py``) does it: ONE sequence a query, the
caption and the od labels with ALL candidate-region features; the per-box
MLP scorer ranks the image hidden states; the target is the candidate of
best IoU against the gt box; cross entropy over the candidates. The
prediction is right where its IoU with the gt box is above 0.5 ("miou").

  python -m cpt_tpu_torch.tools.refcoco_ft --data_file predictions.tsv \\
      --ann_file ann.json --vocab vocab.txt [--checkpoint pytorch_model.bin] \\
      [--num_train_epochs 10] [--output result.pk]

``predictions.tsv`` holds plain rows (``{"objects": boxlist}``) or the
refcoco layout that ``extract_features --task refcoco`` writes (its first
copy's boxes and its caption). Without ``--checkpoint`` the encoder's
weights are random, drawn from ``--seed`` in the Oscar layout; the scorer
starts fresh either way. On a CUDA device the kernels need bf16 (the
default ``--dtype``); ``--device cpu --dtype float32`` runs the plain
versions.
"""
from __future__ import annotations

import argparse
import json
import pickle
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cpt_tpu_torch.data.tensorize import pad_img_feats, tensorize_pair
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.models.bert.heads import REC_FT
from cpt_tpu_torch.structures.boxes import xywh_iou
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_common_args, build_tokenizer,
                                         check_img_feature_type, dtype_of,
                                         load_or_init, model_config, on_device,
                                         optim_overrides)
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_file", required=True,
                   help="plain predictions.tsv (rows: key \\t "
                        "{objects: boxlist} or the refcoco layout)")
    p.add_argument("--ann_file", required=True)
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    add_common_args(p)
    # the reference refcoco_ft defines --max_grad_norm but never clips
    # (fewshot/refcoco_ft.py:352): no clipping unless the flag asks
    p.set_defaults(max_grad_norm=0.0)
    return p


def _xywh(box) -> list:
    return [box[0], box[1], box[2] - box[0] + 1, box[3] - box[1] + 1]


class RefcocoFTData:
    """One example a query: (key, tensorized caption + od labels, padded
    features, box mask, target = the best-IoU candidate, candidate boxes)."""

    def __init__(self, data_file, ann_file, tokenizer, txt_len, img_len, dim):
        self.tsv = TSVFile(data_file)
        with open(ann_file) as f:
            self.anns = {str(d["id"]): d for d in json.load(f)}
        self.tokenizer = tokenizer
        self.txt_len, self.img_len, self.dim = txt_len, img_len, dim

    def __len__(self):
        return len(self.tsv)

    def example(self, idx):
        key, payload = self.tsv.seek(idx)
        info = json.loads(payload)
        objs = info["objects"]
        if isinstance(objs, list) and objs and isinstance(objs[0], list):
            # refcoco color layout: the first copy's boxlist
            boxlist = objs[0][0] if isinstance(objs[0][0], list) else objs[0]
            caption = info["objects"][1]
        else:
            boxlist = objs
            caption = self.anns[key].get("caption", "")
        feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
        boxes = [o["rect"] for o in boxlist]
        od = " ".join(o["class"] for o in boxlist)
        gt = self.anns[key]["bbox"]
        target = int(np.argmax([xywh_iou(gt, _xywh(b)) for b in boxes]))
        seq = tensorize_pair(self.tokenizer, caption.replace(".", "").strip(),
                             od, feats.shape[0], self.txt_len, self.img_len)
        box_mask = np.zeros((self.img_len,), bool)
        box_mask[:min(feats.shape[0], self.img_len)] = True
        return (key, seq, pad_img_feats(feats, self.img_len), box_mask,
                target, boxes)

    def batch(self, indices, pad_to=None):
        """→ (ids, segs, attn, feats, box_mask, targets, keys, boxes); rows
        past ``len(indices)`` up to ``pad_to`` are empty (target −1)."""
        total = pad_to if pad_to is not None else len(indices)
        t, r, d = self.txt_len, self.img_len, self.dim
        ids = np.zeros((total, t), np.int32)
        segs = np.zeros((total, t), np.int32)
        attn = np.zeros((total, t + r), np.int32)
        feats = np.zeros((total, r, d), np.float32)
        box_mask = np.zeros((total, r), bool)
        targets = np.full((total,), -1, np.int32)
        keys, boxes_list = [], []
        for i, idx in enumerate(indices):
            key, seq, f, bm, tgt, boxes = self.example(idx)
            ids[i], segs[i], attn[i] = (seq.input_ids, seq.segment_ids,
                                        seq.attention_mask)
            feats[i], box_mask[i], targets[i] = f, bm, tgt
            keys.append(key)
            boxes_list.append(boxes)
        return ids, segs, attn, feats, box_mask, targets, keys, boxes_list


def build_model(args, cfg, device) -> REC_FT:
    """``REC_FT`` on ``device``: the encoder from ``--checkpoint`` or random
    Oscar-layout weights from ``--seed``, the scorer fresh from ``--seed``."""
    with torch.device(device):
        model = REC_FT(cfg, txt_seq_len=args.max_seq_length,
                       dtype=dtype_of(args))
    return load_or_init(model, args, cfg).eval()


def train(model: REC_FT, data: RefcocoFTData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None
          ) -> List[float]:
    """The JAX tool's loop: AdamW with OptimConfig's betas (0.9, 0.98,
    reference refcoco_ft.py:444), ``--adam_epsilon``, the clip only where
    ``--max_grad_norm`` > 0, the warmup-linear schedule over (queries //
    batch) × epochs steps, one parameter group for the ``cls_*`` head at
    lr_mul 1; each epoch visits the queries in the order a
    ``random.Random(--seed)`` shuffles them, ``--per_gpu_train_batch_size``
    a step (the last padded); dropout from a generator seeded with
    ``--seed``. → each step's loss; ``on_step(step, loss)`` after each."""
    bsz = args.per_gpu_train_batch_size
    steps = max(1, len(data) // bsz) * args.num_train_epochs
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(steps * args.warmup_ratio), num_train_steps=steps,
        lr_mul=1.0, **optim_overrides(args))
    tx = train_lib.build_optimizer(model, ocfg, classifier_pred=lambda p: any(
        part.startswith("cls_") for part in p))
    state = train_lib.create_train_state(model, tx)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    order_rng = random.Random(args.seed)
    losses: List[float] = []
    t0 = time.time()
    model.train()
    for epoch in range(args.num_train_epochs):
        order = list(range(len(data)))
        order_rng.shuffle(order)
        for start in range(0, len(order), bsz):
            ids, segs, attn, feats, box_mask, targets = on_device(
                device, data.batch(order[start:start + bsz], pad_to=bsz)[:6])
            loss, _, _ = model(ids, segs, attn, img_feats=feats,
                               box_mask=box_mask, target_idx=targets,
                               generator=generator)
            grads = torch.autograd.grad(loss, state.params, allow_unused=True)
            tx.update(grads, state.opt_state, state.params)
            state.step += 1
            losses.append(float(loss.detach()))
            if on_step is not None:
                on_step(state.step, losses[-1])
        if (epoch + 1) % 10 == 0:
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)")
    model.eval()
    return losses


@torch.inference_mode()
def evaluate(model: REC_FT, data: RefcocoFTData, batch_size: int
             ) -> Tuple[float, Dict[str, list], Dict[str, np.ndarray]]:
    """→ (accuracy·100, {key: predicted box}, {key: f32 scores of its
    candidates}); each batch of ``batch_size`` queries (the last padded)."""
    device = next(model.parameters()).device
    model.eval()
    n_correct, n_total = 0, 0
    preds_out, scores_out = {}, {}
    for start in range(0, len(data), batch_size):
        idxs = list(range(start, min(start + batch_size, len(data))))
        b = data.batch(idxs, pad_to=batch_size)
        _, scores, pred = model(*on_device(device, b[:3]),
                                img_feats=on_device(device, b[3:4])[0],
                                box_mask=on_device(device, b[4:5])[0])
        scores, pred = scores.float().cpu().numpy(), pred.cpu().numpy()
        for j in range(len(idxs)):
            key, boxes = b[6][j], b[7][j]
            scores_out[key] = scores[j, :len(boxes)]
            pi = int(pred[j])
            if pi < len(boxes):
                box = boxes[pi]
                preds_out[key] = box
                gt = data.anns[key]["bbox"]
                n_correct += xywh_iou(gt, _xywh(box)) > 0.5
                n_total += 1
    return 100.0 * n_correct / max(n_total, 1), preds_out, scores_out


def main(argv=None):
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    check_img_feature_type(args, "refcoco_ft")
    device = torch.device(args.device)
    cfg = model_config(args)
    model = build_model(args, cfg, device)
    data = RefcocoFTData(args.data_file, args.ann_file, build_tokenizer(args),
                         args.max_seq_length, args.max_img_seq_length,
                         cfg.img_feature_dim)
    if args.num_train_epochs > 0:
        train(model, data, args, device)
    acc, preds, _ = evaluate(model, data, args.per_gpu_eval_batch_size)
    print(f"miou: {acc:.2f}")
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump({"accuracy": acc, "predictions": preds}, f)
    data.tsv.close()
    return acc


if __name__ == "__main__":
    main()
