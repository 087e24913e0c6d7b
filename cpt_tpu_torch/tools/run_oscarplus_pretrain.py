"""Oscar+ pretraining: masked-LM plus contrastive cross entropy over TSV
corpora (port of ``cpt_tpu/tools/run_oscarplus_pretrain.py``).

As the reference ``Oscar/oscar/run_oscarplus_pretrain.py`` does it (and
``run_mlm.py``'s text-only variant, ``--text_only``): the masked-LM cross
entropy over caption and tag tokens plus the NSP-style contrastive cross
entropy over the corruption ladder of ``data/pretrain.py`` (polluted tags,
and with ``--texta_false_prob`` the wrong-caption triplets of a 3-way
head), optionally with a second corpus weighted in each step
(``--extra_*``).

  python -m cpt_tpu_torch.tools.run_oscarplus_pretrain \\
      --feat_file features.tsv --captions captions.json \\
      [--yaml corpus.yaml] [--checkpoint pytorch_model.bin] \\
      [--train_steps 100] [--output out_dir --save_every 20 [--resume]]

The encoder comes from ``--checkpoint`` or from random Oscar-layout weights
drawn from ``--seed``; the MLM and NSP heads start fresh either way, as the
JAX tool loads the encoder alone. AdamW with the stock betas (0.9, 0.999)
and no gradient clip unless ``--max_grad_norm`` > 0 (the reference's
default −1). Each step's batch and dropout depend only on (``--seed``,
step), so ``--resume`` from ``--output`` goes on as an uninterrupted run.
On a CUDA device the kernels need bf16 (the default ``--dtype``);
``--device cpu --dtype float32`` runs their plain versions.
"""
from __future__ import annotations

import argparse
import json
import random
from typing import Callable, List, Optional, Tuple

import torch

from cpt_tpu_torch.data.pretrain import (MultiCorpusPretrainData,
                                         OscarPretrainData,
                                         pretrain_contrast_classes)
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.models.bert.heads import (BertImgForPreTraining,
                                             cross_entropy_ignore_index)
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_common_args, build_tokenizer,
                                         check_img_feature_type, dtype_of,
                                         last_step, load_or_init, model_config,
                                         on_device, optim_overrides,
                                         restore_train_state, step_generator)
from cpt_tpu_torch.utils import checkpoint as ckpt_lib


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--feat_file", default=None)
    p.add_argument("--captions", default=None,
                   help="json {img_key: caption}")
    p.add_argument("--yaml", default=None,
                   help="multi-corpus descriptor (reference oscar_tsv.py "
                        "format: corpus/corpus_file/image_feature_path)")
    p.add_argument("--chunk_start_id", type=int, default=-1)
    p.add_argument("--chunk_end_id", type=int, default=-1)
    p.add_argument("--train_steps", type=int, default=100)
    p.add_argument("--max_seq_length", type=int, default=35)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--text_only", action="store_true",
                   help="text-only MLM (run_mlm.py equivalent)")
    p.add_argument("--extra_yaml", default=None,
                   help="second (QA-style) corpus descriptor trained "
                        "alongside the main one with --extra_loss_weight "
                        "(reference --extra_dataset_file, "
                        "run_oscarplus_pretrain.py:50,408-425)")
    p.add_argument("--extra_feat_file", default=None)
    p.add_argument("--extra_captions", default=None)
    p.add_argument("--extra_loss_weight", type=float, default=0.0,
                   help="per-step loss = (1-w)*main + w*extra, the "
                        "reference's two-dataloader weighting "
                        "(run_oscarplus_pretrain.py:410-425)")
    p.add_argument("--mask_loss_for_unmatched", type=int, default=1,
                   help="keep MLM loss on polluted od-label tokens "
                        "(reference flag; 0 = drop, oscar_tsv.py:693-694)")
    p.add_argument("--texta_false_prob", type=float, default=0.0,
                   help="absolute probability that the caption is swapped "
                        "(the wrong-text_a triplet; od-label swaps fill "
                        "0.5 - p): the reference's single-dice ladder, "
                        "oscar_tsv.py:263-283. p < 0.5 makes the "
                        "contrastive head 3-way")
    p.add_argument("--use_b", type=int, default=1,
                   help="1 = caption [SEP] od-labels [SEP] layout; 0 = "
                        "caption-only text side (reference --use_b)")
    p.add_argument("--textb_sample_mode", type=int, default=0,
                   choices=[0, 1, 2],
                   help="polluting-text_b source: 0 = random line "
                        "(caption or tags) of a random other doc, 1/2 = "
                        "its tags line (reference "
                        "run_oscarplus_pretrain.py:78-82)")
    p.add_argument("--extra_textb_sample_mode", type=int, default=1,
                   choices=[0, 1, 2],
                   help="same for the --extra_* corpus (reference "
                        "default 1)")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop the loop after this many steps while keeping "
                        "the --train_steps schedule, so an interrupted "
                        "run's steps match an uninterrupted one's (0 = run "
                        "to --train_steps)")
    p.add_argument("--save_every", type=int, default=0,
                   help="save the train state (params, optimizer, step) "
                        "under --output every N steps")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest train state under --output and "
                        "go on from its step; batches and dropout depend "
                        "only on (--seed, step), so the continued run is the "
                        "uninterrupted one")
    add_common_args(p)
    # the reference pretraining runner does not clip by default
    # (run_oscarplus_pretrain.py:114 --max_grad_norm -1.0, :436)
    p.set_defaults(max_grad_norm=-1.0)
    return p


def load_corpora(args, tokenizer, cfg) -> Tuple[OscarPretrainData,
                                               Optional[OscarPretrainData]]:
    """(main corpus, the ``--extra_*`` corpus or None), with the corruption
    flags; ``--yaml`` / ``--extra_yaml`` read multi-corpus descriptors."""
    corrupt = dict(texta_false_prob=args.texta_false_prob,
                   use_b=bool(args.use_b),
                   mask_loss_for_unmatched=bool(args.mask_loss_for_unmatched),
                   textb_sample_mode=args.textb_sample_mode)
    sizes = (args.max_seq_length, args.max_img_seq_length, cfg.img_feature_dim)
    if args.yaml:
        data = MultiCorpusPretrainData(
            args.yaml, tokenizer, *sizes, chunk_start_id=args.chunk_start_id,
            chunk_end_id=args.chunk_end_id, **corrupt)
        print(f"mixed corpus: {len(data)} samples from "
              f"{'_'.join(data.datasets)}")
    else:
        if not (args.feat_file and args.captions):
            raise SystemExit("--yaml or --feat_file/--captions required")
        with open(args.captions) as f:
            data = OscarPretrainData(args.feat_file, json.load(f), tokenizer,
                                     *sizes, **corrupt)
    extra_kw = dict(corrupt, textb_sample_mode=args.extra_textb_sample_mode)
    extra = None
    if args.extra_yaml:
        extra = MultiCorpusPretrainData(args.extra_yaml, tokenizer, *sizes,
                                        **extra_kw)
    elif args.extra_feat_file:
        if not args.extra_captions:
            raise SystemExit("--extra_captions required")
        with open(args.extra_captions) as f:
            extra = OscarPretrainData(args.extra_feat_file, json.load(f),
                                      tokenizer, *sizes, **extra_kw)
    return data, extra


def build_model(args, cfg, device) -> BertImgForPreTraining:
    """The pretraining model on ``device``: the encoder from
    ``--checkpoint`` or random Oscar-layout weights from ``--seed``, both
    heads fresh from ``--seed``. A checkpoint's own MLM and NSP heads are
    dropped, as the JAX tool's ``load_or_init(..., task="bert_only")`` drops
    them."""
    with torch.device(device):
        model = BertImgForPreTraining(cfg, dtype=dtype_of(args))
    return load_or_init(model, args, cfg)


def pretrain_batch(data, indices, rng: random.Random, args, device
                   ) -> Tuple[torch.Tensor, ...]:
    """One corpus batch of ``indices`` (padded to the train batch) on
    ``device``: (ids, segs, attn, feats, mlm_labels, contrastive_labels);
    text-only runs keep the text columns of the mask."""
    ids, segs, attn, feats, mlm, contrast = on_device(device, data.batch(
        indices, rng, pad_to=args.per_gpu_train_batch_size))
    if args.text_only:
        attn = attn[:, :args.max_seq_length]
    return ids, segs, attn, feats, mlm, contrast


def batch_loss(model, batch, text_only: bool,
               generator: Optional[torch.Generator]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked-LM loss, contrastive loss) of one batch; the MLM labels are
    cut to the logits' positions (the text's under ``text_only``)."""
    ids, segs, attn, feats, mlm, contrast = batch
    _, mlm_logits, nsp_logits = model(
        ids, segs, attn, img_feats=None if text_only else feats,
        generator=generator)
    mlm_loss = cross_entropy_ignore_index(mlm_logits,
                                          mlm[:, :mlm_logits.shape[1]])
    return mlm_loss, cross_entropy_ignore_index(nsp_logits, contrast)


def train(model, data, extra, args, device,
          on_step: Optional[Callable[[int, float], None]] = None
          ) -> List[float]:
    """The JAX tool's loop: step ``it`` takes the corpus in order from
    ``it · batch`` (cycling), draws its corruption and masking from
    ``random.Random(seed · 1000003 + it)`` and its dropout from
    ``step_generator(--seed, it)``; the extra corpus, where there is one,
    cycles on its own and enters as ``(1 − w)·main + w·extra``. AdamW over
    ``--train_steps`` (``--max_steps`` cuts the loop, not the schedule);
    ``--save_every`` / ``--resume`` keep and restore the train state under
    ``--output``. → this run's losses; ``on_step(step, loss)`` after each
    step."""
    w_extra = args.extra_loss_weight if extra is not None else 0.0
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(args.train_steps * args.warmup_ratio),
        num_train_steps=args.train_steps, scheduler=args.scheduler,
        **optim_overrides(args, betas=(0.9, 0.999)))
    tx = train_lib.build_optimizer(model, ocfg)
    state = train_lib.create_train_state(model, tx)
    if args.resume and args.output and restore_train_state(args.output, state):
        print(f"resumed from {ckpt_lib.last_checkpoint_name(args.output)} "
              f"at step {state.step}")
    bsz = args.per_gpu_train_batch_size
    model.train()
    losses: List[float] = []
    for it in range(state.step, last_step(args, args.train_steps)):
        step_py = random.Random(args.seed * 1_000_003 + it)
        batch = pretrain_batch(data, [(it * bsz + j) % len(data)
                                      for j in range(bsz)], step_py, args, device)
        extra_batch = (None if extra is None else pretrain_batch(
            extra, [(it * bsz + j) % len(extra) for j in range(bsz)],
            step_py, args, device))
        gen = step_generator(device, args.seed, it)
        mlm_loss, nsp_loss = batch_loss(model, batch, args.text_only, gen)
        loss = mlm_loss + nsp_loss
        if extra_batch is not None:
            me, ne = batch_loss(model, extra_batch, args.text_only, gen)
            loss = (1.0 - w_extra) * loss + w_extra * (me + ne)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        losses.append(float(loss.detach()))
        if state.step % 20 == 0:
            print(f"step {state.step}: loss {losses[-1]:.4f} "
                  f"(mlm {float(mlm_loss):.4f} nsp {float(nsp_loss):.4f})")
        if (args.save_every and args.output
                and state.step % args.save_every == 0):
            ckpt_lib.save_checkpoint(args.output, f"step{state.step}", state)
        if on_step is not None:
            on_step(state.step, losses[-1])
    model.eval()
    if losses:
        print(f"pretrain done: first {losses[0]:.4f} -> last {losses[-1]:.4f}")
    if args.output:
        ckpt_lib.save_checkpoint(args.output, "pretrained", state)
    return losses


def main(argv=None):
    distributed.initialize_from_env()
    args = build_args().parse_args(argv)
    check_img_feature_type(args, "run_oscarplus_pretrain")
    device = torch.device(args.device)
    tokenizer = build_tokenizer(args)
    cfg = model_config(args, num_contrast_classes=pretrain_contrast_classes(
        args.texta_false_prob, bool(args.use_b)))
    data, extra = load_corpora(args, tokenizer, cfg)
    model = build_model(args, cfg, device)
    return train(model, data, extra, args, device)


if __name__ == "__main__":
    main()
