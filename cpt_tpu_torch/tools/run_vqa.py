"""VQA full-finetune runner, ``ImageBertForSequenceClassification`` with
bce (port of ``cpt_tpu/tools/run_vqa.py``).

As the reference ``Oscar/oscar/run_vqa.py`` does it: soft-target bce over
the answer vocabulary, the VQA score as the sum of the gt score of the
argmax answer, periodic eval with best-model selection
(``run_vqa.py:560-585``), and the eval server's submission rows,
``{name}_results.json`` of ``{"question_id": int, "answer": str}``
(``run_vqa.py:815-840``; GQA's test-std rows ``{"questionId",
"prediction"}`` through ``run_gqa.py:698``).

  python -m cpt_tpu_torch.tools.run_vqa --feat_file predictions.tsv \\
      --examples train.json --val_examples val.json --vocab vocab.txt \\
      [--checkpoint pytorch_model.bin] [--num_train_epochs 25] \\
      [--test_examples test.json --label2ans trainval_label2ans.pkl]

or ``--qla_data_dir`` with the reference's own files. Without
``--checkpoint`` the encoder is random, drawn from ``--seed`` in the Oscar
layout; the classifier starts fresh either way. On a CUDA device the kernels
need bf16 (the default ``--dtype``); ``--device cpu --dtype float32`` runs
their plain versions. ``--dp`` above 1 and a multi-process launch are
refused.

``--img_feature_type dis_code[_t]`` reads integer VQ-VAE code ids from the
qla ``.pt`` feature dict. Where ``{qla_data_dir}/vqvae/`` holds a codebook
(``train.pt``, else ``{split}.pt``), ``--code_level top|bottom|both`` picks
the codes, the code geometry comes from the codebook, and for ``top`` /
``bottom`` the code embedding starts from the codebook, unless the
checkpoint has its own (reference ``run_vqa.py:1103-1125,1188``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cpt_tpu_torch.data.vqa import QlaVQAData, VQAData, load_vqa_examples
from cpt_tpu_torch.models.bert.heads import ImageBertForSequenceClassification
from cpt_tpu_torch.models.bert.model import Dropout
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_common_args, build_tokenizer,
                                         dp_forward, dp_mesh, dtype_of,
                                         load_or_init, model_config,
                                         on_device, train_epochs, writes)
from cpt_tpu_torch.utils import checkpoint as ckpt_lib


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--feat_file", default=None)
    p.add_argument("--examples", default=None)
    p.add_argument("--qla_data_dir", default=None,
                   help="reference VQA layout: {split}_img_frcnn_feats.pt "
                        "+ {split}_qla.json here (run_vqa.py:82-133; "
                        "loads the reference's own data files)")
    p.add_argument("--split", default="train2014",
                   help="train split name in --qla_data_dir mode; the "
                        "reference's composite splits work directly "
                        "(train+val2014 = --do_train_val, train2014_vg = "
                        "--use_vg, vg = --use_vg_dev; run_vqa.py:47-67)")
    p.add_argument("--val_split", default=None,
                   help="val split name in --qla_data_dir mode")
    p.add_argument("--feat_split", default=None,
                   help="feature .pt split name when the composite qla "
                        "split reuses another split's features")
    p.add_argument("--val_examples", default=None)
    p.add_argument("--test_examples", default=None,
                   help="unlabeled test split; writes {test_name}_results.json")
    p.add_argument("--test_name", default="test2015",
                   help="submission file prefix (test2015 / test-dev2015 / "
                        "submission)")
    p.add_argument("--label2ans", default=None,
                   help="json list or {label: answer} mapping labels to "
                        "answer strings for submission output")
    p.add_argument("--output_dir", default=None,
                   help="submission jsons + periodic checkpoints")
    p.add_argument("--num_labels", type=int, default=3129)
    p.add_argument("--loss_type", default="bce", choices=["bce", "kl", "xe"])
    p.add_argument("--adjust_dp", action="store_true",
                   help="raise every hidden dropout to 0.3 from epoch 3 on "
                        "(reference run_vqa.py:534-542)")
    p.add_argument("--adjust_loss", action="store_true",
                   help="switch the loss from kl to bce at "
                        "--adjust_loss_epoch (reference run_vqa.py:545-547)")
    p.add_argument("--adjust_loss_epoch", type=int, default=-1)
    p.add_argument("--submission_format", default="vqa",
                   choices=["vqa", "gqa"])
    p.add_argument("--max_seq_length", type=int, default=128)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--eval_every", type=int, default=0,
                   help="eval val every N epochs and keep the best params "
                        "(0 = only at the end)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel processes, one a card (the launch needs a "
                        "world of this many; parallel/mesh.py): each batch "
                        "is split over them")
    p.add_argument("--max_steps", type=int, default=0,
                   help="cap total optimizer steps (reference run_vqa.py "
                        "t_total/max_steps); 0 = run all epochs")
    p.add_argument("--save_every", type=int, default=0,
                   help="save a full train-state checkpoint (params+"
                        "optimizer+step) to {output_dir}/state every N "
                        "steps — enables mid-epoch resume")
    p.add_argument("--resume", action="store_true",
                   help="restore {output_dir}/state and continue from the "
                        "saved step; per-epoch shuffles and per-step "
                        "dropout generators are seed-derived, so the "
                        "continued run matches an uninterrupted one exactly")
    return add_common_args(p)


def load_codebook(args) -> Optional[dict]:
    """The VQ-VAE codebook file under ``{qla_data_dir}/vqvae`` of a
    discrete-code run, or None. Sets ``args.code_dim`` / ``code_voc`` /
    ``code_size`` from it for ``--code_level`` (``both``: the two levels'
    dims concatenated, and no codebook init), as the JAX runner does."""
    if args.img_feature_type == "faster_r-cnn" or not args.qla_data_dir:
        return None
    vqdir = os.path.join(args.qla_data_dir, "vqvae")
    if not os.path.isdir(vqdir):
        return None
    # the reference hardcodes vqvae/train.pt; vqvae/{split}.pt is the
    # fallback for other split names
    path = os.path.join(vqdir, "train.pt")
    if not os.path.exists(path):
        path = os.path.join(vqdir, f"{args.split}.pt")
    vq = torch.load(path, weights_only=False)
    if args.code_level in ("top", "bottom"):
        tag = "t" if args.code_level == "top" else "b"
        emb = np.asarray(vq[f"embeddings_{tag}"])
        args.code_dim, args.code_voc = emb.shape
        args.code_size = len(next(iter(vq[f"feats_{args.code_level}"].values())))
    else:
        args.code_dim = (np.asarray(vq["embeddings_t"]).shape[0]
                         + np.asarray(vq["embeddings_b"]).shape[0])
        args.code_size = len(next(iter(vq["feats_both"].values())))
    return vq


def load_data(args, tokenizer, cfg, vq: Optional[dict] = None
              ) -> Tuple[VQAData, VQAData]:
    """(train, val) from ``--qla_data_dir`` or ``--feat_file`` +
    ``--examples``; val is train without a val split. With a codebook
    ``vq`` the features are its ``--code_level`` codes; a discrete-code
    run needs integer features (``dis_code_t`` pads them to ``code_size``),
    and a region-feature run refuses them."""
    if args.qla_data_dir:
        level = args.code_level if vq is not None else None

        def qla(split, feat_split=None):
            return QlaVQAData(args.qla_data_dir, split, args.num_labels,
                              tokenizer, args.max_seq_length,
                              args.max_img_seq_length, cfg.img_feature_dim,
                              feat_split=feat_split, vqvae_level=level)

        data = qla(args.split, args.feat_split)
        val = qla(args.val_split) if args.val_split else data
    else:
        if not (args.feat_file and args.examples):
            raise SystemExit("need --feat_file + --examples, or "
                             "--qla_data_dir")

        def tsv(path):
            return VQAData(args.feat_file, load_vqa_examples(path),
                           args.num_labels, tokenizer, args.max_seq_length,
                           args.max_img_seq_length, cfg.img_feature_dim)

        data = tsv(args.examples)
        val = tsv(args.val_examples) if args.val_examples else data
    if args.img_feature_type != "faster_r-cnn":
        if not data.code_mode:
            raise SystemExit(
                "--img_feature_type dis_code[_t] needs integer code-id "
                "arrays in the feature file (qla .pt loader)")
        if args.img_feature_type == "dis_code_t":
            for d in {id(data): data, id(val): val}.values():
                d.enable_code_t(args.code_size, args.code_dim)
    elif data.code_mode or val.code_mode:
        raise SystemExit("run_vqa: integer code-id features need "
                         "--img_feature_type dis_code or dis_code_t")
    return data, val


def build_model(args, cfg, device, vq: Optional[dict] = None
                ) -> ImageBertForSequenceClassification:
    """The classifier on ``device``: the encoder from ``--checkpoint`` or
    random Oscar-layout weights from ``--seed``, the head fresh from
    ``--seed``. With a codebook ``vq`` and ``--code_level top|bottom`` the
    code embedding starts from the codebook, transposed to
    ``[code_voc, code_dim]``, unless the checkpoint supplied one: a
    fine-tuned code embedding is not clobbered by the raw codebook."""
    with torch.device(device):
        model = ImageBertForSequenceClassification(cfg, dtype=dtype_of(args))
    info = {}
    load_or_init(model, args, cfg, info=info)
    if (vq is not None and args.code_level in ("top", "bottom")
            and not info["ckpt_has_code"]):
        tag = "t" if args.code_level == "top" else "b"
        emb = torch.as_tensor(np.asarray(vq[f"embeddings_{tag}"]).T)
        table = model.bert.code_embeddings
        assert table.shape == emb.shape, (tuple(table.shape), tuple(emb.shape))
        with torch.no_grad():
            table.copy_(emb)
        print(f"initialized code embedding from the {args.code_level} "
              f"codebook {tuple(emb.shape)}")
    return model.eval()


def reconfigure(model, cfg, hidden_dropout: float, loss_type: str) -> None:
    """Give every module of ``model`` that carries the BERT config ``cfg``
    with ``hidden_dropout`` and ``loss_type``, and every dropout but the
    attention probabilities' the rate ``hidden_dropout``: what the JAX
    runner gets by building the model anew on the same parameters."""
    new = dataclasses.replace(cfg, hidden_dropout_prob=hidden_dropout,
                              loss_type=loss_type)
    for name, m in model.named_modules():
        if hasattr(m, "config"):
            m.config = new
        if isinstance(m, Dropout) and not name.endswith("probs_dropout"):
            m.rate = hidden_dropout


def train(model, data: VQAData, args, device,
          on_step: Optional[Callable[[int, float], None]] = None,
          val: Optional[VQAData] = None, mesh=None) -> List[float]:
    """The JAX runner's loop (``_common.train_epochs``: AdamW, the seeded
    per-epoch shuffle and per-step dropout, ``--max_steps``,
    ``--save_every`` / ``--resume``), the last batch of an epoch padded
    (soft targets 0, hard label −1). ``--adjust_dp`` / ``--adjust_loss``
    change the dropout and the loss between epochs on the same parameters
    and optimizer state. With ``--eval_every`` the model ends on the
    parameters of its best val score, each evaluated epoch saved as
    ``checkpoint-{epoch}`` under ``--output_dir``. → each step's loss;
    ``on_step(step, loss)`` after each. ``mesh`` (``--dp``): each batch
    split over its dp axis (``train_steps``), the evaluations too."""
    cfg = model.config
    best = {"acc": -1.0, "state": None, "epoch": 0}

    def loss_type(epoch):
        # reference run_vqa.py:545: bce from --adjust_loss_epoch (default
        # -1: from the start)
        return ("bce" if args.adjust_loss and epoch >= args.adjust_loss_epoch
                else cfg.loss_type)

    def begin_epoch(epoch):
        # reference run_vqa.py:534-542: dropout 0.3 from epoch 3
        reconfigure(model, cfg, 0.3 if args.adjust_dp and epoch >= 3
                    else cfg.hidden_dropout_prob, loss_type(epoch))

    def batch(indices, epoch):
        b, soft, hard = data.batch(indices, pad_to=args.per_gpu_train_batch_size)
        return on_device(device, (
            b.input_ids, b.segment_ids, b.attention_mask, b.img_feats,
            soft if loss_type(epoch) in ("bce", "kl") else hard))

    def end_epoch(epoch, losses):
        nonlocal best
        reconfigure(model, cfg, cfg.hidden_dropout_prob, cfg.loss_type)
        if (epoch + 1) % 5 == 0 and losses:
            print(f"epoch {epoch + 1}: loss {losses[-1]:.4f}")
        if args.eval_every and (epoch + 1) % args.eval_every == 0:
            acc = evaluate(model, val, args.per_gpu_eval_batch_size, mesh)[0]
            print(f"epoch {epoch + 1}: val {acc:.2f}")
            if acc > best["acc"]:
                best = {"acc": acc, "epoch": epoch + 1, "state": {
                    k: v.detach().clone() for k, v in model.state_dict().items()}}
            if args.output_dir and writes(mesh):
                ckpt_lib.save_model(os.path.join(
                    args.output_dir, f"checkpoint-{epoch + 1}"),
                    model.state_dict())

    losses = train_epochs(model, args, device, len(data), batch, on_step,
                          begin_epoch, end_epoch, mesh)
    if best["state"] is not None:
        model.load_state_dict(best["state"])
        print(f"best val {best['acc']:.2f} at epoch {best['epoch']}")
    return losses


@torch.inference_mode()
def evaluate(model, data: VQAData, batch_size: int, mesh=None
             ) -> Tuple[float, Dict[str, int], np.ndarray]:
    """→ (VQA score·100: the mean over labeled questions of the gt score of
    the argmax answer, {q_id: predicted label}, f32 logits [len(data),
    num_labels]); batches of ``batch_size`` questions. With ``mesh`` each
    batch, padded to ``batch_size``, is split over its dp axis and the
    logits gathered back (``cpt_tpu/tools/run_vqa.py:96-111``)."""
    device = next(model.parameters()).device
    model.eval()
    total_score, n, results, out = 0.0, 0, {}, []
    for start in range(0, len(data), batch_size):
        idxs = list(range(start, min(start + batch_size, len(data))))
        b, soft, _ = data.batch(idxs, pad_to=batch_size if mesh else None)
        logits = dp_forward(model, mesh, *on_device(device, (
            b.input_ids, b.segment_ids, b.attention_mask, b.img_feats))
        )[:len(idxs)].cpu().numpy()
        pred = logits.argmax(-1)
        for j, idx in enumerate(idxs):
            ex = data.examples[idx]
            results[ex.q_id] = int(pred[j])
            if ex.label_scores:
                total_score += soft[j, pred[j]]
                n += 1
        out.append(logits)
    logits = (np.concatenate(out) if out
              else np.zeros((0, model.config.num_labels), np.float32))
    return 100.0 * total_score / max(n, 1), results, logits


def load_label2ans(path, num_labels):
    """json list / {label: answer} dict, or the reference's pickled
    ``trainval_label2ans.pkl`` list (run_vqa.py cmds)."""
    if path is None:
        return [str(i) for i in range(num_labels)]
    with open(path, "rb") as f:
        blob = pickle.load(f) if path.endswith(".pkl") else json.load(f)
    if isinstance(blob, dict):
        return [blob.get(str(i), str(i)) for i in range(num_labels)]
    return list(blob)


def write_submission(results, label2ans, out_path, fmt: str):
    """Eval-server output rows (reference run_vqa.py:827-840 /
    run_gqa.py:696-703)."""
    rows = []
    for q_id, label in results.items():
        ans = label2ans[label]
        if fmt == "gqa":
            rows.append({"questionId": str(q_id), "prediction": ans})
        else:
            rows.append({"question_id": int(q_id)
                         if str(q_id).lstrip("-").isdigit() else q_id,
                         "answer": ans})
    with open(out_path, "w") as f:
        json.dump(rows, f)
    print(f"wrote {out_path} ({len(rows)} rows)")


def main(argv=None):
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    device = torch.device(args.device)
    mesh = dp_mesh(args, device, args.per_gpu_train_batch_size,
                   args.per_gpu_eval_batch_size)
    tokenizer = build_tokenizer(args)
    vq = load_codebook(args)
    cfg = model_config(args, num_labels=args.num_labels,
                       loss_type=args.loss_type)
    data, val = load_data(args, tokenizer, cfg, vq)
    model = build_model(args, cfg, device, vq)
    if args.num_train_epochs > 0:
        train(model, data, args, device, val=val, mesh=mesh)
    acc, results, _ = evaluate(model, val, args.per_gpu_eval_batch_size, mesh)
    print(f"vqa score: {acc:.2f}")
    if args.output and writes(mesh):
        with open(args.output, "wb") as f:
            pickle.dump({"accuracy": acc, "results": results}, f)
    if args.test_examples:
        test = VQAData(args.feat_file, load_vqa_examples(args.test_examples),
                       args.num_labels, tokenizer, args.max_seq_length,
                       args.max_img_seq_length, cfg.img_feature_dim)
        test_results = evaluate(model, test, args.per_gpu_eval_batch_size,
                                mesh)[1]
        if not writes(mesh):
            return acc
        out_dir = args.output_dir or "."
        os.makedirs(out_dir, exist_ok=True)
        write_submission(
            test_results, load_label2ans(args.label2ans, args.num_labels),
            os.path.join(out_dir, f"{args.test_name}_results.json"),
            args.submission_format)
    return acc


if __name__ == "__main__":
    main()
