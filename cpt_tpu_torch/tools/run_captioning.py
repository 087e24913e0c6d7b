"""COCO captioning runner (port of ``cpt_tpu/tools/run_captioning.py``):
masked-LM (XE) training, greedy / beam / sampling decoding, constrained
beam search, CIDEr-D and the caption metrics, and an optional SCST
finetune, as the reference ``Oscar/oscar/run_captioning.py`` (+
``utils/cbs.py``) does them.

  python -m cpt_tpu_torch.tools.run_captioning --feat_file predictions.tsv \\
      --captions captions.json [--train_steps 1000] [--scst_steps 100] \\
      [--num_beams 5 --num_keep_best 2 | --do_sample | --use_cbs] \\
      [--checkpoint pytorch_model.bin] [--output out.pkl]

or ``--dataset_yaml`` (``--val_yaml`` / ``--test_yaml``) with the
reference's own caption data files. Data: a feature TSV and a json
``{img_key: [reference captions]}``. Without ``--checkpoint`` the encoder
is random, drawn from ``--seed`` in the Oscar layout; the MLM head starts
fresh either way, as the JAX runner's does. On a CUDA device the kernels
need bf16 (the default ``--dtype``); ``--device cpu --dtype float32`` runs
their plain versions. A multi-process launch and the discrete-code
features (``--img_feature_type dis_code[_t]``) are refused.

The caption forward carries a ``[B, S, S]`` seq2seq mask: each decode step
and SCST rollout launches K4 in each layer (K3 takes only a key-only
mask), or K6 under ``attention_impl="flash"``; XE training runs the plain
layers while dropout is on (0.1 by default). SCST passes the od labels
as ``text_b`` even under ``--no_od_labels``, as the JAX runner does
(``cpt_tpu/tools/run_captioning.py:429``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.engine.caption_eval import corpus_bleu, rouge_l
from cpt_tpu_torch.engine.generation import (GenerationConfig, beam_search,
                                             decode_caption, eval_mode,
                                             greedy_or_sample,
                                             make_step_logits_fn)
from cpt_tpu_torch.engine.scst import scst_step
from cpt_tpu_torch.models.bert.captioning import (BertForImageCaptioning,
                                                  CaptionTensorizer)
from cpt_tpu_torch.tools._common import (add_common_args, build_tokenizer,
                                         check_img_feature_type, clip_of,
                                         dtype_of, load_or_init, model_config,
                                         on_device, optim_overrides,
                                         refuse_multi_process,
                                         restore_train_state, step_generator)
from cpt_tpu_torch.utils import checkpoint as ckpt_lib
from cpt_tpu_torch.utils.cbs import build_fsm, constrained_beam_search
from cpt_tpu_torch.utils.cider import CiderD
from cpt_tpu_torch.utils.meteor import meteor
from cpt_tpu_torch.utils.spice_lite import spice_lite_corpus
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature


def build_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--feat_file", default=None)
    p.add_argument("--captions", default=None,
                   help="json {img_key: [captions]}")
    p.add_argument("--dataset_yaml", default=None,
                   help="reference CaptionTSVDataset yaml (feature/label "
                        "TSVs + COCO-style caption json) — loads the "
                        "reference's own caption data files directly "
                        "(reference --train_yaml)")
    p.add_argument("--val_yaml", default=None,
                   help="separate dataset for the --eval_every "
                        "during-training CIDEr eval (reference --val_yaml)")
    p.add_argument("--test_yaml", default=None,
                   help="separate dataset for the final decode + metric "
                        "eval (reference --test_yaml; defaults to the "
                        "training set)")
    p.add_argument("--max_seq_length", type=int, default=70)
    p.add_argument("--max_seq_a_length", type=int, default=40)
    p.add_argument("--max_img_seq_length", type=int, default=50)
    p.add_argument("--max_masked_tokens", type=int, default=3)
    p.add_argument("--mask_prob", type=float, default=0.15,
                   help="caption-token masking probability "
                        "(run_captioning.py:836)")
    p.add_argument("--no_od_labels", action="store_true",
                   help="drop od-label context (text_b) from training and "
                        "decoding (reference --add_od_labels off; CPT/VinVL "
                        "recipes keep it on, so on is our default)")
    p.add_argument("--label_smoothing", type=float, default=0.1,
                   help="BertCaptioningLoss label smoothing "
                        "(modeling_bert.py:575-600)")
    p.add_argument("--drop_worst_ratio", type=float, default=0.0,
                   help="fraction of highest-loss slots dropped from the "
                        "caption loss (run_captioning.py:855)")
    p.add_argument("--drop_worst_after", type=int, default=0,
                   help="apply --drop_worst_ratio only from this step on "
                        "(run_captioning.py:857)")
    p.add_argument("--num_beams", type=int, default=5)
    p.add_argument("--num_keep_best", type=int, default=1,
                   help="beams kept per image in the prediction output "
                        "(run_captioning.py:909)")
    p.add_argument("--max_gen_length", type=int, default=0,
                   help="decode-step cap; 0 = full --max_seq_a_length "
                        "canvas (run_captioning.py:902)")
    p.add_argument("--do_sample", action="store_true",
                   help="sampling decode instead of greedy/beam")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--repetition_penalty", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--no_tie_weights", action="store_true",
                   help="UNTIE the caption decoder from the word "
                        "embeddings — the reference's default "
                        "(config.tie_weights=False, modeling_bert.py:"
                        "616-625); our default ties, matching "
                        "--tie_weights recipes")
    p.add_argument("--freeze_embedding", action="store_true",
                   help="freeze the word-embedding table during training "
                        "(reference modeling_bert.py:622-625 "
                        "requires_grad=False)")
    p.add_argument("--num_return_sequences", type=int, default=1,
                   help="independent sampling decodes kept per image "
                        "(reference run_captioning.py:668; sampling mode "
                        "only)")
    p.add_argument("--scst_steps", type=int, default=0)
    p.add_argument("--sc_beam_size", type=int, default=1,
                   help="beam size of the SCST baseline decode "
                        "(reference run_captioning.py:543,895; 1 = greedy)")
    p.add_argument("--sc_train_sample_n", type=int, default=5,
                   help="SCST rollouts per image (run_captioning.py:891)")
    p.add_argument("--sc_baseline_type", default="greedy",
                   choices=["greedy", "sample"],
                   help="REINFORCE baseline: greedy decode or leave-one-out "
                        "sample mean (caption_evaluate.py:133-144)")
    p.add_argument("--train_steps", type=int, default=0)
    p.add_argument("--eval_every", type=int, default=0,
                   help="evaluate CIDEr-D on a val subset every N steps, "
                        "track the best model and append eval_logs.json "
                        "(reference --evaluate_during_training + "
                        "best_CIDEr, run_captioning.py:508-521)")
    p.add_argument("--eval_subset", type=int, default=32,
                   help="images per during-training eval (greedy decode)")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop the loop early while keeping the "
                        "--train_steps LR-schedule horizon (exact-resume "
                        "kill point)")
    p.add_argument("--save_every", type=int, default=0,
                   help="save full train state to {output_dir}/state "
                        "every N steps")
    p.add_argument("--resume", action="store_true",
                   help="restore {output_dir}/state and continue "
                        "mid-run; per-step seeded streams make the "
                        "continued run exact")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--spice_lite", action="store_true",
                   help="add the approximate SPICE_lite tuple-F1 to eval "
                        "metrics (utils/spice_lite.py; NOT comparable to "
                        "Java SPICE)")
    p.add_argument("--use_cbs", action="store_true",
                   help="constrained beam search: constraints = each "
                        "image's top od-label words (reference cbs.py)")
    p.add_argument("--min_constraints_to_satisfy", type=int, default=1)
    p.add_argument("--num_constraints", type=int, default=2)
    return add_common_args(p)


def load_feats(tsv, imgid2idx, key):
    _, payload = tsv.seek(imgid2idx[key])
    info = json.loads(payload)
    boxlist = info["objects"]
    feats = np.stack([decode_feature(o["feature"]) for o in boxlist])
    od = " ".join(o["class"] for o in boxlist)
    return feats, od


class CaptionYamlData:
    """Reference caption-dataset yaml (``run_captioning.py:29-127``
    CaptionTSVDataset layout): ``feature`` TSV rows
    ``(key, {"num_boxes", "features": b64 f32 [n, D]})``, optional
    ``label`` TSV rows ``(key, [{"class": ...}])``, ``caption`` json
    ``[{"image_id", "caption"}]``. Loads the reference's own data files
    without conversion."""

    def __init__(self, yaml_file: str):
        import base64

        import yaml as _yaml

        self._b64 = base64
        cfg = _yaml.safe_load(open(yaml_file))
        root = os.path.dirname(os.path.abspath(yaml_file))

        def path(v):
            if v is None:
                return None
            return v if os.path.isfile(v) else os.path.join(root, v)

        self.feat_tsv = TSVFile(path(cfg["feature"]))
        lbl = path(cfg.get("label"))
        self.label_tsv = TSVFile(lbl) if lbl and os.path.isfile(lbl) \
            else None
        self.key2idx = {self.feat_tsv.seek(i)[0]: i
                        for i in range(len(self.feat_tsv))}
        cap_path = path(cfg.get("caption"))
        self.captions = {}
        if cap_path and os.path.isfile(cap_path):
            for row in json.load(open(cap_path)):
                self.captions.setdefault(
                    str(row["image_id"]), []).append(row["caption"])

    def load(self, key):
        i = self.key2idx[key]
        info = json.loads(self.feat_tsv.seek(i)[1])
        feats = np.frombuffer(
            self._b64.b64decode(info["features"]), np.float32).reshape(
            int(info["num_boxes"]), -1)
        od = ""
        if self.label_tsv is not None:
            objs = json.loads(self.label_tsv.seek(i)[1])
            od = " ".join(o["class"] for o in objs)
        return feats, od


@dataclasses.dataclass
class CaptionSources:
    """The training captions ``{key: [captions]}`` and ``get_feats(key)`` →
    (features [n, D], od-label text), and the val and test sets' (the
    training set's own objects where ``--val_yaml`` / ``--test_yaml`` are
    not given)."""

    captions: Dict[str, List[str]]
    get_feats: Callable
    val_captions: Dict[str, List[str]]
    val_get_feats: Callable
    test_captions: Dict[str, List[str]]
    test_get_feats: Callable


def load_sources(args) -> CaptionSources:
    """``--dataset_yaml`` (the reference's CaptionTSVDataset files) or
    ``--feat_file`` + ``--captions``, with the separate val / test sets of
    ``--val_yaml`` / ``--test_yaml`` (reference run_captioning.py:809-813,
    980-997); only keys that have features are kept."""
    def yaml_source(path):
        ydata = CaptionYamlData(path)
        caps = {k: v for k, v in ydata.captions.items()
                if k in ydata.key2idx}
        return caps, ydata.load

    if args.dataset_yaml:
        captions, get_feats = yaml_source(args.dataset_yaml)
    else:
        if not (args.feat_file and args.captions):
            raise SystemExit("need --feat_file + --captions, or "
                             "--dataset_yaml")
        tsv = TSVFile(args.feat_file)
        imgid2idx = {tsv.seek(i)[0]: i for i in range(len(tsv))}
        with open(args.captions) as f:
            captions = {k: v for k, v in json.load(f).items()
                        if k in imgid2idx}

        def get_feats(k):
            return load_feats(tsv, imgid2idx, k)
    val = (yaml_source(args.val_yaml) if args.val_yaml
           else (captions, get_feats))
    test = (yaml_source(args.test_yaml) if args.test_yaml
            else (captions, get_feats))
    return CaptionSources(captions, get_feats, *val, *test)


def build_model(args, cfg, device) -> BertForImageCaptioning:
    """The caption model on ``device``: the encoder from ``--checkpoint``
    or random Oscar-layout weights from ``--seed``, the MLM head fresh from
    ``--seed`` (the JAX runner loads a checkpoint's encoder alone,
    ``load_or_init``'s ``"bert_only"``)."""
    with torch.device(device):
        model = BertForImageCaptioning(cfg, dtype=dtype_of(args))
    return load_or_init(model, args, cfg).eval()


def tensorizers(args, tokenizer) -> Tuple[CaptionTensorizer, CaptionTensorizer]:
    """(training tensorizer with the masking flags, test tensorizer whose
    caption slots are all [MASK])."""
    return (CaptionTensorizer(
        tokenizer, args.max_img_seq_length, args.max_seq_length,
        args.max_seq_a_length, max_masked_tokens=args.max_masked_tokens,
        mask_prob=args.mask_prob),
        CaptionTensorizer(tokenizer, args.max_img_seq_length,
                          args.max_seq_length, args.max_seq_a_length,
                          is_train=False))


def decode_context(tens_test: CaptionTensorizer, feats: np.ndarray,
                   od: Optional[str], device) -> tuple:
    """One image's decode inputs on ``device``: (segment_ids, attn,
    img_feats, base_ids), each with a batch axis of 1."""
    ids, segs, attn, f, _, _, _ = tens_test.tensorize("", feats, text_b=od)
    return on_device(device, (segs[None], attn[None], f[None], ids[None]))


def freeze_embedding(tx, args):
    """--freeze_embedding: the word-embedding table's update zeroed (the
    reference sets requires_grad=False on exactly that table,
    modeling_bert.py:622-625)."""
    return (train_lib.freeze_params(tx, "word_embeddings")
            if args.freeze_embedding else tx)


def quick_cider(model, src: CaptionSources, args, device, tokenizer) -> float:
    """The during-training eval: a greedy decode of the first
    ``--eval_subset`` val images (full ``--max_seq_a_length`` canvas, no
    penalties) and their CIDEr-D against every val image's references."""
    eval_cfg = GenerationConfig(
        max_seq_a_len=args.max_seq_a_length,
        bos_token_id=tokenizer.cls_token_id,
        eos_token_id=tokenizer.sep_token_id,
        mask_token_id=tokenizer.mask_token_id)
    tens_test = tensorizers(args, tokenizer)[1]
    scorer = CiderD({k: [c.split() for c in v]
                     for k, v in src.val_captions.items()})
    hyps = {}
    for k in sorted(src.val_captions)[: args.eval_subset]:
        fe, od = src.val_get_feats(k)
        segs, attn, f, base = decode_context(
            tens_test, fe, None if args.no_od_labels else od, device)
        toks, _ = greedy_or_sample(model, eval_cfg, segs, attn, f,
                                   base_ids=base)
        hyps[k] = decode_caption(tokenizer, toks[0].cpu().numpy(),
                                 eval_cfg).split()
    return scorer.corpus_score(hyps)


def train(model, src: CaptionSources, args, device, tokenizer,
          on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """XE training as the JAX runner's loop: AdamW (betas (0.9, 0.999),
    ``--scheduler`` over ``--train_steps``, the clip of ``--max_grad_norm``,
    ``--freeze_embedding``), step ``it`` on the batch of keys ``it·B ..``
    (cycling over the sorted training keys) tensorized with a
    ``random.Random`` seeded from (``--seed``, it), dropout from
    ``step_generator(--seed, it)``, the label-smoothed loss with
    ``--drop_worst_ratio`` from step ``--drop_worst_after`` on;
    ``--max_steps`` cuts the loop but not the schedule; ``--save_every`` /
    ``--resume`` keep and restore the train state under
    ``{output_dir}/state``. ``--eval_every`` runs :func:`quick_cider`, logs
    ``eval_logs.json`` and ends the model on its best parameters. → this
    run's losses; ``on_step(step, loss)`` after each step (and its save,
    before its eval)."""
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(args.train_steps * args.warmup_ratio),
        num_train_steps=args.train_steps, scheduler=args.scheduler,
        **optim_overrides(args, betas=(0.9, 0.999)))
    tx = freeze_embedding(train_lib.build_optimizer(model, ocfg), args)
    state = train_lib.create_train_state(model, tx)
    state_dir = os.path.join(args.output_dir or "", "state")
    if args.resume and args.output_dir and restore_train_state(state_dir, state):
        print(f"resumed at step {state.step}")
    tens_train = tensorizers(args, tokenizer)[0]
    use_od = not args.no_od_labels
    keys = sorted(src.captions)
    bsz = args.per_gpu_train_batch_size
    stop_at = (min(args.train_steps, args.max_steps) if args.max_steps
               else args.train_steps)
    best_cider, best_state, eval_log, losses = -1.0, None, [], []
    for it in range(state.step, stop_at):
        # per-step seeded streams: a resumed run replays the uninterrupted
        # sequence (masking, caption choice, dropout)
        step_py = random.Random(args.seed * 1_000_003 + it)
        rows = []
        for k in (keys[(it * bsz + j) % len(keys)] for j in range(bsz)):
            feats, od = src.get_feats(k)
            cap = step_py.choice(src.captions[k])
            rows.append(tens_train.tensorize(
                cap, feats, text_b=od if use_od else None, rng=step_py))
        # tensorize → (ids, segs, attn, feats, mpos, mids); the model takes
        # (input_ids, attention_mask, token_type_ids, ...)
        batch = on_device(device, [np.stack([r[i] for r in rows])
                                   for i in (0, 2, 1, 3, 4, 5)])
        ratio = args.drop_worst_ratio if it >= args.drop_worst_after else 0.0
        model.train()
        loss, _ = model(*batch, label_smoothing=args.label_smoothing,
                        drop_worst_ratio=ratio,
                        generator=step_generator(device, args.seed, it))
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        losses.append(float(loss.detach()))
        model.eval()
        if state.step % 20 == 0:
            print(f"step {state.step}: loss {losses[-1]:.4f}")
        if args.save_every and args.output_dir and state.step % args.save_every == 0:
            ckpt_lib.save_checkpoint(state_dir, f"step{state.step}", state)
        if on_step is not None:
            on_step(state.step, losses[-1])
        if args.eval_every and state.step % args.eval_every == 0:
            c = quick_cider(model, src, args, device, tokenizer)
            if c > best_cider:
                best_cider = c
                best_state = {k: v.detach().clone()
                              for k, v in model.state_dict().items()}
            eval_log.append({"step": state.step, "CIDEr": c,
                             "best_CIDEr": best_cider})
            if args.output_dir:
                os.makedirs(args.output_dir, exist_ok=True)
                with open(os.path.join(args.output_dir, "eval_logs.json"),
                          "w") as f:
                    json.dump(eval_log, f)
            print(f"eval step {state.step}: CIDEr {c:.3f} "
                  f"(best {best_cider:.3f})")
    model.eval()
    if best_state is not None:
        model.load_state_dict(best_state)
    return losses


def scst_optimizer(model, args) -> train_lib.Optimizer:
    """The JAX runner's SCST optimizer, optax's ``adam(lr)`` (betas (0.9,
    0.999), eps 1e-8, no decay, a constant rate) after
    ``clip_by_global_norm(--max_grad_norm)`` where that is above 0, with
    ``--freeze_embedding``."""
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=0.0,
        betas=(0.9, 0.999), eps=1e-8, warmup_steps=0,
        num_train_steps=max(args.scst_steps, 1), scheduler="constant",
        max_grad_norm=clip_of(args))
    return freeze_embedding(train_lib.build_optimizer(model, ocfg), args)


def scst_train(model, src: CaptionSources, args, device, tokenizer,
               gen_cfg: GenerationConfig, scorer: CiderD) -> List[Tuple[float, float]]:
    """``--scst_steps`` SCST updates, step ``it`` on the training image
    ``keys[it % n]`` with rollouts drawn from ``step_generator(--seed + 1,
    it)`` and the rewards of ``scorer`` (the training references). The od
    labels go in as ``text_b`` even under ``--no_od_labels``, as in the
    JAX runner. → each step's (mean sampled reward, mean baseline
    reward)."""
    tx = scst_optimizer(model, args)
    params = list(model.parameters())
    opt = tx.init(params)
    tens_test = tensorizers(args, tokenizer)[1]
    keys = sorted(src.captions)
    rewards = []
    for it in range(args.scst_steps):
        k = keys[it % len(keys)]
        feats, od = src.get_feats(k)
        batch = decode_context(tens_test, feats, od, device)
        grads, r_s, r_g = scst_step(
            model, gen_cfg, scorer, tokenizer, batch, [k],
            step_generator(device, args.seed + 1, it),
            sample_n=args.sc_train_sample_n,
            baseline_type=args.sc_baseline_type,
            baseline_beams=args.sc_beam_size)
        tx.update(grads, opt, params)
        rewards.append((r_s, r_g))
        if (it + 1) % 10 == 0:
            print(f"scst {it + 1}: sample {r_s:.2f} "
                  f"{args.sc_baseline_type} baseline {r_g:.2f}")
    return rewards


def generation_config(args, tokenizer) -> GenerationConfig:
    gen_len = (min(args.max_gen_length, args.max_seq_a_length)
               if args.max_gen_length else args.max_seq_a_length)
    return GenerationConfig(
        max_seq_a_len=gen_len,
        bos_token_id=tokenizer.cls_token_id,
        eos_token_id=tokenizer.sep_token_id,
        mask_token_id=tokenizer.mask_token_id,
        num_beams=args.num_beams,
        num_keep_best=args.num_keep_best,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        length_penalty=args.length_penalty)


def cbs_decode(model, gen_cfg: GenerationConfig, ctx: tuple, od: str, args,
               tokenizer, vocab_size: int) -> np.ndarray:
    """Constrained beam search on one image: the constraints are its first
    ``--num_constraints`` distinct od-label words (wordpieces), at least
    ``--min_constraints_to_satisfy`` of them (or all there are) to be met,
    ``max(--num_beams, 2)`` beams a state. → the caption's tokens [La]."""
    words = list(dict.fromkeys(od.split()))[: args.num_constraints]
    constraints = [tokenizer.convert_tokens_to_ids(tokenizer.tokenize(w))
                   for w in words if w]
    trans, nsat = build_fsm(constraints, vocab_size)
    k = max(args.num_beams, 2)
    n = trans.shape[0] * k
    step = make_step_logits_fn(model, gen_cfg)
    context = tuple(x.expand(n, *x.shape[1:]) for x in ctx)
    with eval_mode(model):
        toks, _ = constrained_beam_search(
            step, context, transitions=trans, num_satisfied=nsat,
            beams_per_state=k, max_len=gen_cfg.max_seq_a_len,
            bos_id=gen_cfg.bos_token_id, eos_id=gen_cfg.eos_token_id,
            pad_id=gen_cfg.pad_token_id,
            min_constraints=min(args.min_constraints_to_satisfy,
                                len(constraints)),
            num_group_states=1 << len(constraints), device=ctx[0].device)
    return toks.cpu().numpy()


def decode_all(model, src: CaptionSources, args, device, tokenizer,
               gen_cfg: GenerationConfig, vocab_size: int
               ) -> Tuple[Dict[str, List[str]], dict]:
    """Caption every test image, by ``--use_cbs``, beam search
    (``--num_beams`` > 1; ``--num_keep_best`` hypotheses with their
    scores), or greedy / sampling (``--num_return_sequences`` draws with
    theirs), the draws from a generator seeded ``--seed + 2``. → (the
    captions' words by key, the output captions by key)."""
    tens_test = tensorizers(args, tokenizer)[1]
    generator = torch.Generator(device=device).manual_seed(args.seed + 2)
    hyps, outputs = {}, {}
    for k in sorted(src.test_captions):
        feats, od = src.test_get_feats(k)
        segs, attn, f, base = decode_context(
            tens_test, feats, None if args.no_od_labels else od, device)
        if args.use_cbs:
            toks = cbs_decode(model, gen_cfg, (segs, attn, f, base), od, args,
                              tokenizer, vocab_size)
            text = decode_caption(tokenizer, toks, gen_cfg)
        elif args.num_beams > 1 and not args.do_sample:
            toks, scores = beam_search(model, gen_cfg, segs, attn, f,
                                       base_ids=base)
            toks, scores = toks.cpu().numpy(), scores.cpu().numpy()
            text = decode_caption(tokenizer, toks[0, 0], gen_cfg)
            if args.num_keep_best > 1:
                outputs[k] = [
                    {"caption": decode_caption(tokenizer, toks[0, j], gen_cfg),
                     "confidence": float(scores[0, j])}
                    for j in range(toks.shape[1])]
        else:
            seqs = []
            for _ in range(args.num_return_sequences if args.do_sample else 1):
                toks, scores = greedy_or_sample(model, gen_cfg, segs, attn, f,
                                                generator, base_ids=base)
                seqs.append({"caption": decode_caption(
                    tokenizer, toks[0].cpu().numpy(), gen_cfg),
                    "confidence": float(scores[0])})
            text = seqs[0]["caption"]
            if len(seqs) > 1:
                # reference generate(num_return_sequences=n): n independent
                # sampling decodes an image (run_captioning.py:668)
                outputs[k] = seqs
        hyps[k] = text.split()
        outputs.setdefault(k, text)
    return hyps, outputs


def caption_metrics(hyps: Dict[str, List[str]], refs: Dict[str, List[List[str]]],
                    scorer: CiderD, spice: bool = False) -> Dict[str, float]:
    """CIDEr-D, METEOR and ROUGE-L (each image's mean), corpus BLEU-1..4
    and, with ``spice``, SPICE_lite (the coco-caption protocol,
    caption_evaluate.py:59-90)."""
    n = max(len(hyps), 1)
    metrics = {
        "CIDEr": scorer.corpus_score(hyps),
        "METEOR": sum(meteor(h, refs[k]) for k, h in hyps.items()) / n,
        "ROUGE_L": sum(rouge_l(h, refs[k]) for k, h in hyps.items()) / n,
    }
    bleu = corpus_bleu(hyps, {k: refs[k] for k in hyps})
    metrics.update({f"Bleu_{i + 1}": bleu[i] for i in range(4)})
    if spice:
        metrics["SPICE_lite"] = spice_lite_corpus(
            {k: " ".join(h) for k, h in hyps.items()},
            {k: [" ".join(r) for r in refs[k]] for k in hyps})
    return metrics


def main(argv=None):
    refuse_multi_process("run_captioning")
    args = build_args().parse_args(argv)
    check_img_feature_type(args, "run_captioning")
    device = torch.device(args.device)
    tokenizer = build_tokenizer(args)
    cfg = model_config(args)
    if args.no_tie_weights:
        cfg = dataclasses.replace(cfg, tie_weights=False)
    src = load_sources(args)
    model = build_model(args, cfg, device)
    if args.train_steps > 0:
        train(model, src, args, device, tokenizer)

    gen_cfg = generation_config(args, tokenizer)
    refs = {k: [c.split() for c in v] for k, v in src.test_captions.items()}
    scorer = CiderD(refs)
    # SCST rewards come from the training references (the reference builds
    # ScstRewardCriterion from the train dataset's captions)
    scst_scorer = (scorer if src.test_captions is src.captions else
                   CiderD({k: [c.split() for c in v]
                           for k, v in src.captions.items()}))
    if args.scst_steps > 0:
        scst_train(model, src, args, device, tokenizer, gen_cfg, scst_scorer)

    hyps, outputs = decode_all(model, src, args, device, tokenizer, gen_cfg,
                               cfg.vocab_size)
    metrics = caption_metrics(hyps, refs, scorer, args.spice_lite)
    cider = metrics["CIDEr"]
    print(f"CIDEr-D: {cider:.2f}")
    print(" ".join(f"{k}={v:.3f}" for k, v in sorted(metrics.items())))
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump({"cider": cider, "metrics": metrics,
                         "captions": outputs}, f)
    return cider, outputs


if __name__ == "__main__":
    main()
