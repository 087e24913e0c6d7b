"""Self-critical sequence training (SCST) for captioning (port of
``cpt_tpu/engine/scst.py``).

As the reference's SCST finetune path (``run_captioning.py`` ``--scst`` +
``ScstRewardCriterion``, ``utils/caption_evaluate.py:115-158``) does it:
``sample_n`` captions sampled per image (``--sc_train_sample_n``), the
baseline either the greedy (or beam) decode (``--sc_baseline_type
greedy``) or the leave-one-out mean of the other samples' rewards
(``'sample'``: ``(sum − self)/(n − 1)``, ``caption_evaluate.py:143-144``),
the reward CIDEr-D, the loss the mean over samples of
−(r − baseline)·log P(sample). The rollouts run on the device
(``engine/generation``), the rewards on the host, and the gradient of the
teacher-forced log-prob comes from autograd: the model runs in eval mode
(no dropout, as JAX's deterministic forward), so K4 (or K6) carries each
layer's forward and its backward is the plain VJP.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cpt_tpu_torch.engine.generation import (GenerationConfig, beam_search,
                                             decode_caption, eval_mode,
                                             greedy_or_sample,
                                             make_step_logits_fn)
from cpt_tpu_torch.utils.cider import CiderD


def sequence_logprob_fn(model, cfg: GenerationConfig):
    """Teacher-forced caption log-prob: fn(tokens [B, La], segment_ids,
    attn, img_feats, base_ids=None) → f32 [B] sum over steps t ≥ 1 of
    log P(token_t | <t), PAD targets left out. One forward a step over the
    fixed canvas (the decode's canvas, [MASK] at t, logits read at t), on
    the model's parameters, differentiable where grad is on."""
    step_fn = make_step_logits_fn(model, cfg)

    def fn(tokens, segment_ids, attn, img_feats, base_ids=None):
        total = torch.zeros(tokens.shape[0], dtype=torch.float32,
                            device=tokens.device)
        with eval_mode(model):
            for step in range(1, tokens.shape[1]):
                logp = torch.log_softmax(step_fn(tokens, step, segment_ids, attn,
                                                 img_feats, base_ids), -1)
                tgt = tokens[:, step].long()
                tok_logp = torch.gather(logp, 1, tgt[:, None])[:, 0]
                live = tgt != cfg.pad_token_id
                total = total + torch.where(live, tok_logp, 0.0)
        return total

    return fn


def scst_advantages(sample_scores: np.ndarray,
                    greedy_scores: np.ndarray | None,
                    baseline_type: str = "greedy") -> np.ndarray:
    """[B, n] sample rewards → [B, n] advantages (reference
    ``ScstRewardCriterion.forward``, ``caption_evaluate.py:133-150``).

    ``'greedy'``: baseline = the image's greedy reward. ``'sample'``:
    leave-one-out mean of the OTHER samples, ``(sum − self)/(n − 1)``
    (``:143-144``) — per image the advantages then sum to zero."""
    s = np.asarray(sample_scores, np.float32)
    if baseline_type == "greedy":
        assert greedy_scores is not None and len(greedy_scores) == s.shape[0]
        base = np.asarray(greedy_scores, np.float32)[:, None]
    elif baseline_type == "sample":
        assert s.shape[1] >= 2, "sample baseline needs sample_n >= 2"
        base = (s.sum(1, keepdims=True) - s) / (s.shape[1] - 1)
    else:
        raise ValueError(f"unknown baseline_type {baseline_type!r}")
    return s - base


def scst_loss(model, cfg: GenerationConfig, sampled: torch.Tensor,
              advantage: torch.Tensor, ctx: Sequence[torch.Tensor],
              base_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """−mean(advantage · log P(sampled)), the teacher-forced log-prob under
    autograd; ``ctx`` = (segment_ids, attn, img_feats) of the rollouts."""
    logp = sequence_logprob_fn(model, cfg)(sampled, *ctx, base_ids)
    return -torch.mean(advantage * logp)


def scst_step(model, cfg: GenerationConfig, scorer: CiderD, tokenizer, batch,
              image_ids: Sequence[str], generator: torch.Generator,
              sample_n: int = 1, baseline_type: str = "greedy",
              baseline_beams: int = 1
              ) -> Tuple[List[Optional[torch.Tensor]], float, float]:
    """One SCST gradient. ``batch`` = (segment_ids, attn, img_feats) and an
    optional 4th element ``base_ids`` (the od-label context ids of the
    decode canvas).

    ``sample_n`` rollouts an image (tiled contiguously, as the reference's
    ``gt_idx = i // seq_per_img``), drawn from ``generator``; the baseline
    per :func:`scst_advantages`. ``baseline_beams > 1`` decodes the greedy
    baseline with beam search instead (the reference's ``--sc_beam_size``,
    run_captioning.py:543). → (the gradient of each of
    ``model.parameters()``, None where it gets none; the mean sampled
    reward; the mean baseline reward)."""
    segment_ids, attn, img_feats = batch[:3]
    base_ids = batch[3] if len(batch) > 3 else None
    b = segment_ids.shape[0]
    ctx = (segment_ids, attn, img_feats)
    if sample_n > 1:
        ctx = tuple(torch.repeat_interleave(x, sample_n, dim=0) for x in ctx)
        base_rep = (None if base_ids is None
                    else torch.repeat_interleave(base_ids, sample_n, dim=0))
    else:
        base_rep = base_ids

    sample_cfg = dataclasses.replace(cfg, do_sample=True)
    sampled, _ = greedy_or_sample(model, sample_cfg, *ctx, generator,
                                  base_ids=base_rep)

    def tokens_to_words(row):
        return decode_caption(tokenizer, row, cfg).split()

    ids_rep = [i for i in image_ids for _ in range(sample_n)]
    r_sample = np.asarray([scorer.score(i, tokens_to_words(t))
                           for i, t in zip(ids_rep, sampled.cpu().numpy())]
                          ).reshape(b, sample_n)
    if baseline_type == "greedy":
        if baseline_beams > 1:
            beam_cfg = dataclasses.replace(cfg, do_sample=False,
                                           num_beams=baseline_beams,
                                           num_keep_best=1)
            toks, _ = beam_search(model, beam_cfg, segment_ids, attn,
                                  img_feats, base_ids=base_ids)
            greedy = toks[:, 0]
        else:
            greedy, _ = greedy_or_sample(model, cfg, segment_ids, attn,
                                         img_feats, base_ids=base_ids)
        r_base = np.asarray([scorer.score(i, tokens_to_words(t))
                             for i, t in zip(image_ids, greedy.cpu().numpy())])
    else:
        r_base = None
    advantage = torch.from_numpy(
        scst_advantages(r_sample, r_base, baseline_type).reshape(-1)).to(
        segment_ids.device)

    params = list(model.parameters())
    with torch.enable_grad():
        loss = scst_loss(model, cfg, sampled, advantage, ctx, base_rep)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    base_mean = (float(np.mean(r_base)) if r_base is not None
                 else float(r_sample.mean()))
    return list(grads), float(r_sample.mean()), base_mean
