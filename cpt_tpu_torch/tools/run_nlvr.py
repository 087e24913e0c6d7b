"""NLVR2 runner: a statement over an image pair (port of
``cpt_tpu/tools/run_nlvr.py``).

As the reference ``Oscar/oscar/run_nlvr.py`` does it. ``--pair_mode pair``
(the published recipe, ``--use_pair``): the statement goes with each image
as one of two choices, and ``ImageBertForMultipleChoice`` (mlp) reads both
pooled outputs to classify true / false. ``--pair_mode concat``: one
sequence with both images' od labels and both images' regions (2 × the
region length), ``ImageBertForSequenceClassification`` (xe, mlp).

  python -m cpt_tpu_torch.tools.run_nlvr --feat_file predictions.tsv \\
      --examples train.json --val_examples dev.json --vocab vocab.txt \\
      [--checkpoint pytorch_model.bin] [--num_train_epochs 20] \\
      [--optim adamax]

or ``--nlvr2_data_dir`` with the reference's own files. Without
``--checkpoint`` the encoder is random, drawn from ``--seed`` in the Oscar
layout; the classifier starts fresh either way. On a CUDA device the kernels
need bf16 (the default ``--dtype``); ``--device cpu --dtype float32`` runs
their plain versions. ``--dp`` above 1, a multi-process launch and the
discrete-code features are refused.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cpt_tpu_torch.data.nlvr import NLVRData, Nlvr2JsonData, load_nlvr_examples
from cpt_tpu_torch.models.bert.heads import (ImageBertForMultipleChoice,
                                             ImageBertForSequenceClassification)
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_common_args, build_tokenizer,
                                         check_img_feature_type, dp_forward,
                                         dp_mesh, dtype_of, load_or_init,
                                         model_config, on_device, train_epochs,
                                         writes)


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--feat_file", default=None)
    p.add_argument("--examples", default=None)
    p.add_argument("--nlvr2_data_dir", default=None,
                   help="reference NLVR2 layout: nlvr2_{split}.json + "
                        "nlvr2_img_frcnn_feats.pt here (run_nlvr.py:73-107"
                        "; loads the reference's own data files)")
    p.add_argument("--split", default="train",
                   help="train split in --nlvr2_data_dir mode "
                        "(train/dev/balanced_dev/...)")
    p.add_argument("--val_split", default=None,
                   help="val split in --nlvr2_data_dir mode")
    p.add_argument("--val_examples", default=None)
    p.add_argument("--max_seq_length", type=int, default=55)
    p.add_argument("--max_img_seq_length", type=int, default=40)
    p.add_argument("--pair_mode", default="pair",
                   choices=["pair", "concat"],
                   help="pair = two choice sequences + multiple-choice "
                        "head (reference --use_pair, the published NLVR2 "
                        "recipe); concat = one sequence with both images' "
                        "labels/features + a binary classifier (the "
                        "reference's default tensorize_example path)")
    p.add_argument("--optim", default="adamw", choices=["adamw", "adamax"],
                   help="optimizer family (reference run_nlvr.py:403-405 "
                        "AdamW | Adamax; the published NLVR2 recipe uses "
                        "AdamW)")
    p.add_argument("--no_od_labels", action="store_true",
                   help="drop the od-label text segment (reference "
                        "--use_label_seq off, run_nlvr.py:713; the "
                        "published recipe keeps labels on, our default)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel processes, one a card (the launch needs a "
                        "world of this many; parallel/mesh.py): each batch "
                        "is split over them")
    p.add_argument("--max_steps", type=int, default=0,
                   help="cap total optimizer steps; the LR schedule keeps "
                        "the full epoch horizon (exact-resume kill point)")
    p.add_argument("--save_every", type=int, default=0,
                   help="save full train state to {output_dir}/state "
                        "every N steps")
    p.add_argument("--resume", action="store_true",
                   help="restore {output_dir}/state and continue from the "
                        "saved step (exact: seed-derived shuffles and "
                        "dropout generators)")
    p.add_argument("--output_dir", default=None)
    return add_common_args(p)


def load_data(args, tokenizer, cfg) -> Tuple[NLVRData, NLVRData]:
    """(train, val) from ``--nlvr2_data_dir`` or ``--feat_file`` +
    ``--examples``; val is train without a val split."""
    kw = dict(mode=args.pair_mode, use_od_labels=not args.no_od_labels)
    sizes = (args.max_seq_length, args.max_img_seq_length, cfg.img_feature_dim)
    if args.nlvr2_data_dir:
        def load(split):
            return Nlvr2JsonData(args.nlvr2_data_dir, split, tokenizer,
                                 *sizes, **kw)

        data = load(args.split)
        return data, load(args.val_split) if args.val_split else data
    if not (args.feat_file and args.examples):
        raise SystemExit("need --feat_file + --examples, or --nlvr2_data_dir")

    def tsv(path):
        return NLVRData(args.feat_file, load_nlvr_examples(path), tokenizer,
                        *sizes, **kw)

    data = tsv(args.examples)
    return data, tsv(args.val_examples) if args.val_examples else data


def build_model(args, cfg, device):
    """``ImageBertForMultipleChoice`` (2 choices) in pair mode, the sequence
    classifier in concat mode, on ``device``: the encoder from
    ``--checkpoint`` or random Oscar-layout weights from ``--seed``, the
    head fresh from ``--seed``."""
    with torch.device(device):
        model = (ImageBertForMultipleChoice(cfg, num_choices=2,
                                            dtype=dtype_of(args))
                 if args.pair_mode == "pair" else
                 ImageBertForSequenceClassification(cfg, dtype=dtype_of(args)))
    return load_or_init(model, args, cfg).eval()


def train(model, data: NLVRData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None,
          mesh=None) -> List[float]:
    """The JAX runner's loop (``_common.train_epochs``: ``--optim`` AdamW or
    Adamax, the seeded per-epoch shuffle and per-step dropout,
    ``--max_steps``, ``--save_every`` / ``--resume``), the last batch of
    an epoch padded (label −1). → each step's loss; ``on_step(step,
    loss)`` after each. ``mesh`` (``--dp``): each batch split over its dp
    axis (``train_steps``)."""
    def batch(indices, epoch):
        return on_device(device, data.batch(
            indices, pad_to=args.per_gpu_train_batch_size))

    def end_epoch(epoch, losses):
        if (epoch + 1) % 10 == 0 and losses:
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f}")

    return train_epochs(model, args, device, len(data), batch, on_step,
                        end_epoch=end_epoch, mesh=mesh)


@torch.inference_mode()
def evaluate(model, data: NLVRData, batch_size: int, mesh=None
             ) -> Tuple[float, Dict[str, int], np.ndarray]:
    """→ (accuracy·100 over the labeled examples, {ex_id: predicted label},
    f32 logits [len(data), 2]); batches of ``batch_size`` examples (2 ×
    ``batch_size`` sequences in pair mode). With ``mesh`` each batch,
    padded to ``batch_size``, is split over its dp axis."""
    device = next(model.parameters()).device
    model.eval()
    n_correct, n_total, results, out = 0, 0, {}, []
    for start in range(0, len(data), batch_size):
        idxs = list(range(start, min(start + batch_size, len(data))))
        ids, segs, attn, feats, labels = data.batch(
            idxs, pad_to=batch_size if mesh else None)
        logits = dp_forward(model, mesh, *on_device(
            device, (ids, segs, attn, feats)))[:len(idxs)].cpu().numpy()
        pred = logits.argmax(-1)
        for j, idx in enumerate(idxs):
            results[data.examples[idx].ex_id] = int(pred[j])
            if labels[j] >= 0:
                n_correct += int(pred[j] == labels[j])
                n_total += 1
        out.append(logits)
    logits = np.concatenate(out) if out else np.zeros((0, 2), np.float32)
    return 100.0 * n_correct / max(n_total, 1), results, logits


def main(argv=None):
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    check_img_feature_type(args, "run_nlvr")
    device = torch.device(args.device)
    mesh = dp_mesh(args, device, args.per_gpu_train_batch_size,
                   args.per_gpu_eval_batch_size)
    tokenizer = build_tokenizer(args)
    # the reference's NLVR recipe: an mlp classifier, 2 labels; concat mode
    # classifies one sequence with cross entropy
    cfg = (model_config(args, num_labels=2, classifier="mlp")
           if args.pair_mode == "pair" else
           model_config(args, num_labels=2, loss_type="xe", classifier="mlp"))
    data, val = load_data(args, tokenizer, cfg)
    model = build_model(args, cfg, device)
    if args.num_train_epochs > 0:
        train(model, data, args, device, mesh=mesh)
    acc, results, _ = evaluate(model, val, args.per_gpu_eval_batch_size, mesh)
    print(f"nlvr2 accuracy: {acc:.2f}")
    if args.output and writes(mesh):
        with open(args.output, "wb") as f:
            pickle.dump({"accuracy": acc, "results": results}, f)
    return acc


if __name__ == "__main__":
    main()
