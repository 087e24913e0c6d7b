"""Image-text retrieval runner: binary match scoring and R@K ranking (port
of ``cpt_tpu/tools/run_retrieval.py``).

As the reference ``Oscar/oscar/run_retrieval.py`` does it: a binary
``ImageBertForSequenceClassification`` over (caption, image) pairs,
trained on balanced positive and negative pairs; the match score of a pair
is the softmax of its logits at column 1, in f32. The eval ranks every
caption × image pair (R@1/5/10 both ways) or, with
``--eval_caption_index_file``, each image's hard-negative candidates
(image → text R@K, the setting of the reference's published numbers).
``--att_mask_type CL / CR / LR`` gives each sequence a 3-D attention mask
(caption / od labels / regions, full within a block plus one named
cross-block pair); the encoder then bypasses kernel K3, which takes a
key-only mask.

  python -m cpt_tpu_torch.tools.run_retrieval --feat_file predictions.tsv \\
      --captions captions.json --vocab vocab.txt \\
      [--checkpoint pytorch_model.bin] [--train_steps 1000] \\
      [--eval_caption_index_file cand.json] [--att_mask_type CL]

or ``--data_dir`` + ``--img_feat_file`` with the reference's coco_ir files.
Without ``--checkpoint`` the encoder is random, drawn from ``--seed`` in the
Oscar layout; the classifier starts fresh either way. On a CUDA device the
kernels need bf16 (the default ``--dtype``); ``--device cpu --dtype
float32`` runs their plain versions. ``--dp`` above 1, a multi-process
launch and the discrete-code features are refused.
"""
from __future__ import annotations

import argparse
import json
import pickle
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cpt_tpu_torch.data.retrieval import (CocoIRRetrievalData, RetrievalData,
                                          rank_rerank, rank_scores)
from cpt_tpu_torch.models.bert.heads import ImageBertForSequenceClassification
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_common_args, build_tokenizer,
                                         check_img_feature_type, dp_forward,
                                         dp_mesh, dtype_of, load_or_init,
                                         model_config, on_device, train_steps,
                                         writes)


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--feat_file", default=None)
    p.add_argument("--data_dir", default=None,
                   help="reference coco_ir layout: {split}_captions.pt "
                        "here + imageid2idx.json/predictions.tsv beside "
                        "--img_feat_file (loads the reference's own data "
                        "files, run_retrieval.py:23-75)")
    p.add_argument("--img_feat_file", default=None,
                   help="3-column (key, num_boxes, b64) feature TSV for "
                        "--data_dir mode")
    p.add_argument("--split", default="train",
                   help="{split}_captions.pt to load in --data_dir mode")
    p.add_argument("--captions", default=None,
                   help="json {img_key: [captions]}")
    p.add_argument("--train_steps", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop the loop early while keeping the "
                        "--train_steps LR-schedule horizon")
    p.add_argument("--save_every", type=int, default=0,
                   help="save full train state to {output_dir}/state "
                        "every N steps")
    p.add_argument("--resume", action="store_true",
                   help="restore {output_dir}/state and continue mid-run "
                        "(exact: per-step seeded streams)")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--eval_img_keys_file", default="",
                   help="text file of image keys (one per line) selecting "
                        "an eval subset, e.g. the COCO 1k/5k folds "
                        "(reference run_retrieval.py:76-84)")
    p.add_argument("--eval_caption_index_file", default="",
                   help="json {img_key: [[img_key, cap_idx], ...]} of "
                        "hard-negative caption candidates per image — "
                        "enables the re-rank evaluation setting the "
                        "reference's published R@K numbers use "
                        "(run_retrieval.py:86-95); .pt files saved by "
                        "torch.save are also accepted")
    p.add_argument("--hard_negative_training", action="store_true",
                   help="sample training negatives from the image's "
                        "caption-index candidates instead of uniformly")
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--att_mask_type", default="CLR",
                   choices=["CLR", "CL", "CR", "LR"],
                   help="caption/od-label/region attention structure "
                        "(reference run_retrieval.py:169-194)")
    p.add_argument("--num_captions_per_img", type=int, default=None,
                   help="cap the captions used per image (reference "
                        "--num_captions_per_img_train)")
    p.add_argument("--num_captions_per_img_val", type=int, default=None,
                   help="separate cap for the EVAL ranking pool "
                        "(reference --num_captions_per_img_val, default 5 "
                        "there). Unset: full-pairwise eval uses the whole "
                        "caption pool, and the re-rank branch uses ALL "
                        "candidates from the caption-index file")
    p.add_argument("--no_od_labels", action="store_true",
                   help="drop od-label text_b (reference --add_od_labels "
                        "off; the published recipes keep it on, our "
                        "default)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel processes, one a card (the launch needs a "
                        "world of this many; parallel/mesh.py): each batch "
                        "is split over them")
    return add_common_args(p)


def _load_caption_indexs(path):
    """{img_key: [(img_key, cap_idx), ...]} from json, or from a
    torch.save'd dict (reference run_retrieval.py:92-95 — values may be
    json-encoded strings there)."""
    if path.endswith((".pt", ".bin", ".pth")):
        obj = torch.load(path, map_location="cpu", weights_only=False)
    else:
        with open(path) as f:
            obj = json.load(f)
    return {k: (json.loads(v) if isinstance(v, str) else v)
            for k, v in obj.items()}


def load_data(args, tokenizer, cfg) -> RetrievalData:
    """The pairs' data from ``--feat_file`` + ``--captions`` or the coco_ir
    files, with the eval subset, the caption candidates, the mask type,
    the caption cap and the od-label switch of ``args``."""
    eval_keys = None
    if args.eval_img_keys_file:
        with open(args.eval_img_keys_file) as f:
            eval_keys = [line.strip() for line in f if line.strip()]
    common = dict(max_seq_len=args.max_seq_length,
                  img_seq_len=args.max_img_seq_length,
                  img_feat_dim=cfg.img_feature_dim, eval_img_keys=eval_keys,
                  caption_indexs=(_load_caption_indexs(
                      args.eval_caption_index_file)
                      if args.eval_caption_index_file else None),
                  att_mask_type=args.att_mask_type,
                  num_captions_per_img=args.num_captions_per_img,
                  use_od_labels=not args.no_od_labels)
    if args.data_dir:
        if not args.img_feat_file:
            raise SystemExit("--data_dir mode needs --img_feat_file")
        return CocoIRRetrievalData(args.data_dir, args.img_feat_file,
                                   tokenizer, split=args.split, **common)
    if not (args.feat_file and args.captions):
        raise SystemExit("need --feat_file + --captions, or "
                         "--data_dir + --img_feat_file")
    with open(args.captions) as f:
        return RetrievalData(args.feat_file, json.load(f), tokenizer, **common)


def build_model(args, cfg, device) -> ImageBertForSequenceClassification:
    """The binary classifier on ``device``: the encoder from
    ``--checkpoint`` or random Oscar-layout weights from ``--seed``, the
    head fresh from ``--seed``."""
    with torch.device(device):
        model = ImageBertForSequenceClassification(cfg, dtype=dtype_of(args))
    return load_or_init(model, args, cfg).eval()


def train(model, data: RetrievalData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None,
          mesh=None) -> List[float]:
    """The JAX runner's loop (``_common.train_steps``: AdamW, the per-step
    dropout, ``--max_steps``, ``--save_every`` / ``--resume``) over
    ``--train_steps`` steps, step ``it`` on the balanced pairs
    ``data.train_batch`` draws from ``random.Random(seed · 1000003 + it)``
    (``--hard_negative_training``: negatives from the caption candidates).
    → each step's loss; ``on_step(step, loss)`` after each. ``mesh``
    (``--dp``): each batch split over its dp axis (``train_steps``)."""
    t0 = time.time()

    def batch_for(it):
        return on_device(device, data.train_batch(
            args.per_gpu_train_batch_size,
            random.Random(args.seed * 1_000_003 + it),
            hard_negatives=args.hard_negative_training))

    def after(step, loss):
        if on_step is not None:
            on_step(step, loss)
        if step % 20 == 0:
            print(f"step {step}: loss {loss:.4f} ({time.time() - t0:.1f}s)")

    return train_steps(model, args, device, args.train_steps, batch_for, after,
                       mesh)


@torch.inference_mode()
def pair_logits(model, data: RetrievalData,
                pairs: Sequence[Tuple[str, str]], batch_size: int,
                mesh=None) -> np.ndarray:
    """f32 logits [len(pairs), 2] of [(caption, img_key)], tensorized by
    ``data`` (its attention-mask type), in batches of ``batch_size``; with
    ``mesh`` each batch, padded to ``batch_size``, split over its dp
    axis."""
    device = next(model.parameters()).device
    model.eval()
    t, r, d = data.max_seq_len, data.img_seq_len, data.img_feat_dim
    out = []
    for start in range(0, len(pairs), batch_size):
        chunk = pairs[start:start + batch_size]
        n = batch_size if mesh else len(chunk)
        ids = np.zeros((n, t), np.int32)
        segs = np.zeros((n, t), np.int32)
        attn = np.zeros((n, *data.attn_shape), np.int32)
        feats = np.zeros((n, r, d), np.float32)
        for k, (cap, ik) in enumerate(chunk):
            seq, f = data.tensorize(cap, ik)
            ids[k], segs[k], attn[k], feats[k] = (
                seq.input_ids, seq.segment_ids, seq.attention_mask, f)
        logits = dp_forward(model, mesh, *on_device(device, (ids, segs, attn,
                                                              feats)))
        out.append(logits[:len(chunk)].cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 2), np.float32)


def match_scores(logits: np.ndarray) -> np.ndarray:
    """A pair's match score: the softmax of its logits at column 1, f32."""
    return torch.softmax(torch.from_numpy(logits).float(), -1)[:, 1].numpy()


def evaluate(model, data: RetrievalData, args, mesh=None
             ) -> Tuple[Dict[str, float], np.ndarray]:
    """→ (R@K metrics, scores): with caption candidates the re-rank (each
    image against its first ``--num_captions_per_img_val`` candidates,
    scores flat in (image, candidate) order), else every caption × image
    pair (scores [captions, images], the caption pool capped from the
    full pool at ``--num_captions_per_img_val``). ``mesh``: as
    :func:`pair_logits`."""
    ebsz = args.per_gpu_eval_batch_size
    if data.caption_indexs is not None:
        entries = data.rerank_entries(args.num_captions_per_img_val)
        n_cand = len(entries) // len(data.img_keys)
        # a candidate's cap_idx indexes the full caption pool
        scores = match_scores(pair_logits(
            model, data, [(data.full_captions[ik][ci], key)
                          for key, ik, ci, _ in entries], ebsz, mesh))
        labels = np.asarray([lab for *_, lab in entries])
        return rank_rerank(scores, labels, n_cand), scores
    if args.num_captions_per_img_val is not None:
        data.captions = {k: v[:args.num_captions_per_img_val]
                         for k, v in data.full_captions.items()}
    captions_flat, owners = [], []
    for ci, key in enumerate(data.img_keys):
        for cap in data.captions[key]:
            captions_flat.append(cap)
            owners.append(ci)
    n_img = len(data.img_keys)
    scores = match_scores(pair_logits(
        model, data, [(cap, ik) for cap in captions_flat
                      for ik in data.img_keys], ebsz, mesh)).reshape(
        len(captions_flat), n_img)
    return rank_scores(scores, owners, n_img), scores


def main(argv=None):
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    check_img_feature_type(args, "run_retrieval")
    device = torch.device(args.device)
    mesh = dp_mesh(args, device, args.per_gpu_train_batch_size,
                   args.per_gpu_eval_batch_size)
    cfg = model_config(args, num_labels=2, loss_type="xe")
    data = load_data(args, build_tokenizer(args), cfg)
    model = build_model(args, cfg, device)
    if args.train_steps > 0:
        train(model, data, args, device, mesh=mesh)
    metrics, scores = evaluate(model, data, args, mesh)
    print("  ".join(f"{k}: {v:.2f}" for k, v in metrics.items()))
    if args.output and writes(mesh):
        with open(args.output, "wb") as f:
            pickle.dump({"metrics": metrics, "scores": scores}, f)
    return metrics


if __name__ == "__main__":
    main()
