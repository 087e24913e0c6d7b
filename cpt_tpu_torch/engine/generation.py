"""Caption generation: greedy / sampling / beam search on a fixed canvas
(port of ``cpt_tpu/engine/generation.py``).

The JAX package replaces the reference's ``CaptionPreTrainedModel.generate``
and its KV-cache slicing (``Oscar/oscar/modeling/modeling_utils.py:21-678``,
``modeling_bert.py:658-913``) by one step function over the full static
canvas: step t writes a [MASK] at caption position t, runs the
seq2seq-masked forward and reads the logits at t. The port keeps that
design (no KV cache) and its fixed ``La − 1`` steps: each step's work is
queued on the device without a host sync (no ``.item()``), and the model
runs in eval mode (JAX's ``deterministic=True``), so every step's forward
launches K4 (or K6 under ``attention_impl="flash"``) in each layer.

Ported: eos / pad handling, the repetition penalty, the length penalty,
per-example ``num_keep_best`` beams, temperature / top-k / top-p sampling.
Ties keep JAX's order: top-k is a stable descending sort (the lower index
first, as ``jax.lax.top_k``), and ``torch.argmax`` returns the first
maximum as ``jnp.argmax`` does. Sampling draws ``argmax(logits + Gumbel)``
as ``jax.random.categorical`` does, from a ``torch.Generator``: it is
deterministic given the generator, but draws other samples than JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cpt_tpu_torch.models.bert.captioning import top_k_stable

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_seq_a_len: int = 40          # caption canvas (incl CLS/SEP slots)
    bos_token_id: int = 101          # [CLS]
    eos_token_id: int = 102          # [SEP]
    pad_token_id: int = 0
    mask_token_id: int = 103
    num_beams: int = 1
    num_keep_best: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0


@contextlib.contextmanager
def eval_mode(model):
    """``model`` in eval mode meanwhile (the JAX forward's
    ``deterministic=True``), its mode restored after."""
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def _apply_repetition_penalty(logits: torch.Tensor, tokens: torch.Tensor,
                              penalty: float,
                              pad_id: Optional[int] = None) -> torch.Tensor:
    """CTRL-style repetition penalty over the tokens generated so far.
    ``pad_id`` slots are excluded: the fixed canvas is PAD-filled beyond
    the current step, but the reference penalizes only emitted tokens."""
    if penalty == 1.0:
        return logits
    seen = torch.zeros(logits.shape, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, tokens.long(), True)
    if pad_id is not None:
        seen[:, pad_id] = False
    return torch.where(seen, torch.where(logits > 0, logits / penalty,
                                         logits * penalty), logits)


def _filter_top_k_top_p(logits: torch.Tensor, top_k: int,
                        top_p: float) -> torch.Tensor:
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, NEG, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1).values.flip(-1)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff_count = torch.sum(cum - probs < top_p, dim=-1, keepdim=True)
        kth = torch.gather(sorted_logits, -1,
                           torch.clamp(cutoff_count - 1, min=0))
        logits = torch.where(logits < kth, NEG, logits)
    return logits


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of softmax(``logits``): ``argmax(logits + g)``
    with g standard Gumbel noise from ``generator``, the form of
    ``jax.random.categorical``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def make_step_logits_fn(model, cfg: GenerationConfig):
    """fn(caption_tokens [B, La], step, segment_ids [B, S], attn [B, S, S],
    img_feats, base_ids=None) → f32 logits [B, V] at caption position
    ``step``, the caption canvas occupying the first La slots of S.
    ``base_ids`` ([B, S], optional) carries the context token ids beyond
    the caption canvas, the od-label segment; without it those slots
    decode as PAD and the model loses the tag conditioning. The model's
    parameters are its own (autograd reaches them where grad is on)."""

    def fn(tokens, step: int, segment_ids, attn, img_feats, base_ids=None):
        b, la = tokens.shape
        s = segment_ids.shape[1]
        if base_ids is None:
            canvas = torch.zeros((b, s), dtype=torch.long, device=tokens.device)
        else:
            canvas = base_ids.long().clone()
        canvas[:, :la] = tokens
        canvas[:, step] = cfg.mask_token_id
        pos = torch.full((b, 1), step, dtype=torch.long, device=tokens.device)
        _, logits = model(canvas, attn, segment_ids, img_feats=img_feats,
                          masked_pos=pos)
        return logits[:, 0].float()

    return fn


def _generator(device, generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or one seeded 0 on ``device`` (JAX's ``PRNGKey(0)``
    default)."""
    return (generator if generator is not None
            else torch.Generator(device=device).manual_seed(0))


@torch.no_grad()
def greedy_or_sample(model, cfg: GenerationConfig, segment_ids, attn,
                     img_feats, generator: Optional[torch.Generator] = None,
                     base_ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, La], f32 log-prob sums [B]). Greedy unless
    ``cfg.do_sample`` (then the draws come from ``generator``).
    ``base_ids`` [B, S]: the context (od-label) token ids beyond the
    caption canvas (see :func:`make_step_logits_fn`)."""
    step_fn = make_step_logits_fn(model, cfg)
    b = segment_ids.shape[0]
    la = cfg.max_seq_a_len
    dev = segment_ids.device
    tokens = torch.full((b, la), cfg.pad_token_id, dtype=torch.long, device=dev)
    tokens[:, 0] = cfg.bos_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    score = torch.zeros(b, dtype=torch.float32, device=dev)
    if cfg.do_sample:
        generator = _generator(dev, generator)
    with eval_mode(model):
        for step in range(1, la):
            logits = step_fn(tokens, step, segment_ids, attn, img_feats,
                             base_ids)
            logits = _apply_repetition_penalty(
                logits, tokens, cfg.repetition_penalty, cfg.pad_token_id)
            if cfg.do_sample:
                nxt = categorical(_filter_top_k_top_p(
                    logits / cfg.temperature, cfg.top_k, cfg.top_p), generator)
            else:
                nxt = torch.argmax(logits, dim=-1)
            logp = torch.log_softmax(logits, dim=-1)
            tok_logp = torch.gather(logp, 1, nxt[:, None])[:, 0]
            nxt = torch.where(finished, cfg.pad_token_id, nxt)
            score = score + torch.where(finished, 0.0, tok_logp)
            tokens[:, step] = nxt
            finished = finished | (nxt == cfg.eos_token_id)
    return tokens, score


@torch.no_grad()
def beam_search(model, cfg: GenerationConfig, segment_ids, attn, img_feats,
                base_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens [B, num_keep_best, La], scores [B, num_keep_best]) with
    length-penalty-normalized log-prob scores.

    The reference's semantics (``modeling_utils.py``
    ``_generate_beam_search`` + ``BeamHypotheses``) in the JAX package's
    static-shape form: each step takes the top ``2K`` candidates in sorted
    order; EOS candidates met before the K-th live continuation are banked
    as hypotheses (score ``sum_logprobs / cur_len**penalty`` over the
    prefix without the EOS, whose log-prob is in the sum); the first K
    non-EOS candidates become the live beams. On the final step every
    candidate is banked. A batch row is done once the bank holds
    ``num_keep_best`` hypotheses none of the live paths can beat
    (``worst >= best / (La-1)**penalty``). Output hypotheses get EOS
    appended, as the reference's decode step writes it."""
    k = cfg.num_beams
    nb = cfg.num_keep_best
    step_fn = make_step_logits_fn(model, cfg)
    b = segment_ids.shape[0]
    la = cfg.max_seq_a_len
    dev = segment_ids.device

    def expand(x):
        return None if x is None else torch.repeat_interleave(x, k, dim=0)

    seg_e, attn_e, img_e, base_e = (expand(x) for x in (segment_ids, attn,
                                                         img_feats, base_ids))
    live_tok = torch.full((b, k, la), cfg.pad_token_id, dtype=torch.long,
                          device=dev)
    live_tok[:, :, 0] = cfg.bos_token_id
    # the first beam active, the others at NEG so step 1 fans out
    live_sc = torch.tensor([0.0] + [NEG] * (k - 1), dtype=torch.float32,
                           device=dev).repeat(b, 1)
    max_norm_len = float(la - 1) ** cfg.length_penalty
    bank_tok = torch.full((b, nb, la), cfg.pad_token_id, dtype=torch.long,
                          device=dev)
    bank_sc = torch.full((b, nb), NEG, dtype=torch.float32, device=dev)
    bank_len = torch.ones((b, nb), dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pos = torch.arange(2 * k, device=dev)[None, :]

    def take(x, idx):
        """x [B, n, ...] rows ``idx`` [B, m] → [B, m, ...]."""
        return x[torch.arange(b, device=dev)[:, None], idx]

    with eval_mode(model):
        for step in range(1, la):
            flat = live_tok.reshape(b * k, la)
            logits = step_fn(flat, step, seg_e, attn_e, img_e, base_e)
            logits = _apply_repetition_penalty(
                logits, flat, cfg.repetition_penalty, cfg.pad_token_id)
            logp = torch.log_softmax(logits, dim=-1)        # [B*K, V]
            vocab = logp.shape[-1]
            cand = (live_sc.reshape(-1)[:, None] + logp).reshape(b, k * vocab)
            top_sc, top_idx = top_k_stable(cand, 2 * k)     # sorted desc
            src = top_idx // vocab                           # [B, 2K]
            word = top_idx % vocab
            is_last = step == la - 1

            # done before processing, by this step's best candidate
            # (BeamHypotheses.is_done, early_stopping=False)
            bank_full = bank_sc[:, nb - 1] > NEG / 2
            new_done = done | (bank_full
                               & (bank_sc[:, nb - 1] >= top_sc[:, 0] / max_norm_len))

            eos_cand = (word == cfg.eos_token_id) | is_last
            noneos = ~eos_cand
            nrank = torch.cumsum(noneos.long(), dim=1)       # 1-indexed
            # the index of the K-th non-EOS candidate (the loop breaks there)
            kth = torch.argmax(((nrank == k) & noneos).long(), dim=1)
            banked = eos_cand & (True if is_last else pos < kth[:, None])
            banked = banked & ~new_done[:, None]

            # bank merge: the score normalized over the prefix (length =
            # step tokens with BOS, without the EOS being added); the power
            # in f32 as JAX takes it on its traced step, on the host (no
            # copy to the device, so no sync)
            norm = top_sc / float(np.float32(step)
                                  ** np.float32(cfg.length_penalty))
            cand_sc = torch.where(banked, norm, NEG)
            prefix = take(live_tok, src)
            merged_sc = torch.cat([bank_sc, cand_sc], dim=1)
            merged_tok = torch.cat([bank_tok, prefix], dim=1)
            merged_len = torch.cat(
                [bank_len, torch.full((b, 2 * k), step, dtype=torch.long,
                                      device=dev)], dim=1)
            # old-first among ties (generation.py:226's lax.top_k order)
            bank_sc, keep = top_k_stable(merged_sc, nb)
            bank_tok = take(merged_tok, keep)
            bank_len = torch.gather(merged_len, 1, keep)

            # live update: the first K non-EOS candidates in sorted order
            order = torch.argsort(torch.where(noneos, pos, 2 * k + pos), dim=1,
                                  stable=True)
            chosen = order[:, :k]                            # [B, K]
            new_sc = torch.gather(top_sc, 1, chosen)
            new_src = torch.gather(src, 1, chosen)
            new_word = torch.gather(word, 1, chosen)
            new_tok = take(live_tok, new_src)
            new_tok[:, :, step] = new_word
            keep_old = new_done[:, None] | is_last
            live_tok = torch.where(keep_old[..., None], live_tok, new_tok)
            live_sc = torch.where(keep_old, live_sc, new_sc)
            done = new_done

    # append EOS at the end of each hypothesis (reference decode step)
    slots = torch.arange(la, device=dev)[None, None, :]
    is_eos_slot = slots == bank_len[..., None]
    in_prefix = slots < bank_len[..., None]
    bank_tok = torch.where(
        in_prefix, bank_tok,
        torch.where(is_eos_slot, cfg.eos_token_id, cfg.pad_token_id))
    return bank_tok[:, :nb], bank_sc[:, :nb]


def decode_caption(tokenizer, token_row: np.ndarray, cfg: GenerationConfig
                   ) -> str:
    """Token ids → caption text (strips BOS, stops at EOS)."""
    out = []
    for t in np.asarray(token_row).tolist()[1:]:
        if t in (cfg.eos_token_id, cfg.pad_token_id):
            break
        out.append(int(t))
    toks = tokenizer.convert_ids_to_tokens(out)
    text = " ".join(toks).replace(" ##", "")
    return text
