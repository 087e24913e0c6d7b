"""Prompt-tuning and fine-tuning training engine (port of
``cpt_tpu/engine/train.py``).

The JAX engine is an optax chain around a jitted step; here the same
arithmetic runs eagerly on the model's f32 parameters, updated in place:

  * ``warmup_linear`` (with the reference's 1e-8 floor) and
    ``warmup_constant`` schedules, evaluated in f32 as JAX evaluates them
  * AdamW with the BERT no-decay rule on bias/LayerNorm parameters, decided
    on each parameter's path in the JAX tree (``utils/convert.jax_paths``),
    and an ``lr_mul`` group for classifier-head parameters; or Adamax with
    coupled L2 (``add_decayed_weights`` before the moments), written to
    optax's formula (``torch.optim.Adamax`` puts eps inside its max)
  * ``clip_by_global_norm`` ahead of the groups, and ``grad_accum_steps``
    as optax ``MultiSteps``: the running mean of the micro-gradients, one
    optimizer step (and one schedule step) per ``grad_accum_steps`` calls
  * ``freeze_params``: the update of matching parameters is zeroed after
    the optimizer, so they are neither stepped nor decayed

A parameter that gets no gradient (the pooler, under the MLM loss) takes a
zero gradient, as in JAX, so weight decay still moves it.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from cpt_tpu_torch.models.bert.heads import cross_entropy_ignore_index
from cpt_tpu_torch.utils.convert import jax_paths


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 3e-5
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-8
    warmup_steps: int = 0
    num_train_steps: int = 1000
    lr_mul: float = 1.0              # classifier-head LR multiplier
    grad_accum_steps: int = 1
    max_grad_norm: Optional[float] = None
    scheduler: str = "linear"        # linear | constant (after warmup)
    optim: str = "adamw"             # adamw | adamax (run_nlvr.py:403-405)


_f32 = np.float32


def warmup_linear(step, warmup_steps: int, total_steps: int) -> np.float32:
    """BERT schedule with the reference's 1e-8 floor, in f32."""
    step = _f32(step)
    warm = step / _f32(max(warmup_steps, 1))
    decay = (_f32(total_steps) - step) / _f32(max(total_steps - warmup_steps, 1))
    factor = warm if step < warmup_steps else max(decay, _f32(0.0))
    return max(factor, _f32(1e-8))


def warmup_constant(step, warmup_steps: int) -> np.float32:
    """Reference ``WarmupConstantSchedule`` (--scheduler constant): linear
    ramp over warmup, then flat 1."""
    step = _f32(step)
    return step / _f32(max(warmup_steps, 1)) if step < warmup_steps else _f32(1.0)


def make_lr_schedule(cfg: OptimConfig, mul: float = 1.0
                     ) -> Callable[[int], np.float32]:
    def sched(step):
        if cfg.scheduler == "constant":
            f = warmup_constant(step, cfg.warmup_steps)
        else:
            f = warmup_linear(step, cfg.warmup_steps, cfg.num_train_steps)
        return max(_f32(cfg.learning_rate * mul) * f, _f32(1e-8))

    return sched


def _is_no_decay(path: Tuple[str, ...]) -> bool:
    """bias / LayerNorm params are excluded from weight decay."""
    leaf = path[-1]
    return leaf == "bias" or any("LayerNorm" in p for p in path) or leaf == "scale"


def _keystr(path: Tuple[str, ...]) -> str:
    """``jax.tree_util.keystr`` of the parameter in ``{"params": ...}``."""
    return "".join(f"[{k!r}]" for k in ("params",) + tuple(path))


@dataclasses.dataclass
class OptState:
    """Moments and counters (optax's ``count``, ``mu``, ``nu`` and the
    ``MultiSteps`` accumulator)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mini_step: int = 0
    acc: Optional[List[torch.Tensor]] = None


class Optimizer:
    """The transformation :func:`build_optimizer` returns (the port's
    ``tx``): ``init(params)`` → :class:`OptState`, ``update(grads, state,
    params)`` steps the parameters in place. Per-parameter settings follow
    the model's ``named_parameters`` order."""

    def __init__(self, paths: Sequence[Tuple[str, ...]], cfg: OptimConfig,
                 classifier_pred: Optional[Callable[[Tuple[str, ...]], bool]]):
        if cfg.optim not in ("adamw", "adamax"):
            raise ValueError(f"optim must be adamw or adamax, got {cfg.optim!r}")
        self.cfg = cfg
        self.paths = list(paths)
        self.decay = [not _is_no_decay(p) for p in self.paths]
        muls = [cfg.lr_mul if classifier_pred is not None and classifier_pred(p)
                else 1.0 for p in self.paths]
        self.schedules = [make_lr_schedule(cfg, mul) for mul in muls]
        self.frozen = [False] * len(self.paths)

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(count=0, mu=zeros, nu=[z.clone() for z in zeros],
                        acc=([z.clone() for z in zeros]
                             if self.cfg.grad_accum_steps > 1 else None))

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]], state: OptState,
               params: Sequence[torch.Tensor]) -> None:
        cfg = self.cfg
        g = [torch.zeros_like(p, dtype=torch.float32) if gi is None
             else gi.float() for gi, p in zip(grads, params)]
        if cfg.grad_accum_steps > 1:
            n = state.mini_step
            state.acc = [a + (gi - a) / (n + 1) for gi, a in zip(g, state.acc)]
            state.mini_step = (n + 1) % cfg.grad_accum_steps
            if state.mini_step:
                return
            g, state.acc = state.acc, [torch.zeros_like(a) for a in state.acc]
        if cfg.max_grad_norm is not None:
            norm = torch.sqrt(sum(gi.square().sum() for gi in g))
            if not norm < cfg.max_grad_norm:
                g = [gi / norm * cfg.max_grad_norm for gi in g]
        b1, b2 = cfg.betas
        t = state.count + 1
        fix1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        fix2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        for i, p in enumerate(params):
            gi = g[i]
            if cfg.optim == "adamax":
                # coupled L2 (torch.optim.Adamax's weight decay), then
                # optax's infinity moment max(|g| + eps, b2·nu)
                if self.decay[i]:
                    gi = gi + cfg.weight_decay * p
                state.mu[i] = (1 - b1) * gi + b1 * state.mu[i]
                state.nu[i] = torch.maximum(gi.abs() + cfg.eps, b2 * state.nu[i])
                u = (state.mu[i] / fix1) / state.nu[i]
            else:
                state.mu[i] = (1 - b1) * gi + b1 * state.mu[i]
                state.nu[i] = (1 - b2) * gi.square() + b2 * state.nu[i]
                u = (state.mu[i] / fix1) / (torch.sqrt(state.nu[i] / fix2) + cfg.eps)
                if self.decay[i]:
                    u = u + cfg.weight_decay * p
            if not self.frozen[i]:
                p.add_(u * -self.schedules[i](state.count))
        state.count = t


def build_optimizer(model: nn.Module, cfg: OptimConfig,
                    classifier_pred: Optional[Callable[[Tuple[str, ...]], bool]] = None
                    ) -> Optimizer:
    """AdamW (or Adamax) with the no-decay rule on each parameter's JAX path
    (in the tree of the model's ``TASK``) and the ``lr_mul`` group of the
    parameters ``classifier_pred`` picks."""
    paths = jax_paths(model.config, model.TASK)
    return Optimizer([paths[n] for n, _ in model.named_parameters()], cfg,
                     classifier_pred)


def freeze_params(tx: Optimizer, substring: str) -> Optimizer:
    """``tx`` with the update of every parameter whose JAX tree path (as
    ``jax.tree_util.keystr`` prints it) contains ``substring`` zeroed — the
    reference's ``requires_grad = False`` freezing (``--freeze_embedding``
    freezes ``word_embeddings``). Its moments still advance, as in optax."""
    out = copy.copy(tx)
    out.frozen = [f or substring in _keystr(p) for f, p in zip(tx.frozen, tx.paths)]
    return out


@dataclasses.dataclass
class TrainState:
    params: List[torch.Tensor]      # the model's parameters, stepped in place
    opt_state: OptState
    step: int = 0


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    params = list(model.parameters())
    return TrainState(params=params, opt_state=tx.init(params))


def scatter_mlm_labels(labels: torch.Tensor, mask_pos: torch.Tensor,
                       seq_len: int) -> torch.Tensor:
    """[N] gt token ids (−1 = padded slot) + [N] mask positions →
    [N, seq_len] masked-LM label array (−1 everywhere else)."""
    n = labels.shape[0]
    full = torch.full((n, seq_len), -1, dtype=torch.long, device=labels.device)
    safe = mask_pos.long().clamp(0, seq_len - 1)
    scattered = full.clone()
    scattered[torch.arange(n, device=labels.device), safe] = labels.long()
    return torch.where(labels[:, None] >= 0, scattered, full)


def make_mlm_train_step(model: nn.Module, tx: Optimizer, *, dropout: bool = True):
    """MLM prompt-tuning step for ``REC_MLM_CPT``: ``step(state, batch,
    generator)`` → (state, loss). With ``dropout`` the model runs in training
    mode and draws its dropout masks from ``generator``; without it the
    model is deterministic (eval mode), so under ``attention_impl="auto"``
    the layers take K3 and K4, whose backward is the plain VJP. The loss is
    the cross entropy at the gathered [MASK] positions (the vocab
    projection runs only there), the same math as full-sequence MLM CE with
    ignore index −1."""

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, torch.Tensor]:
        input_ids, segment_ids, attention_mask, img_feats, mask_pos, labels = batch
        model.train(dropout)
        _, at_mask = model(input_ids, segment_ids, attention_mask,
                           img_feats=img_feats, mask_pos=mask_pos,
                           generator=generator if dropout else None)
        loss = cross_entropy_ignore_index(at_mask, labels)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, loss.detach()

    return step


def make_nsp_train_step(model: nn.Module, tx: Optimizer, *,
                        head: Optional[str] = None, dropout: bool = True):
    """NSP-scoring step for ``NSPCPT`` / ``VCRQAR_NSPCPT`` (``head`` "ans"
    or "rat" for the twin-head model): ``step(state, batch, generator)`` →
    (state, loss), ``batch`` = (input_ids, segment_ids, attention_mask,
    img_feats, labels [N], −1 on padded slots). The loss is the NSP cross
    entropy; dropout as in :func:`make_mlm_train_step`."""
    kwargs = {} if head is None else {"head": head}

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, torch.Tensor]:
        input_ids, segment_ids, attention_mask, img_feats, labels = batch
        model.train(dropout)
        loss, _ = model(input_ids, segment_ids, attention_mask,
                        img_feats=img_feats, next_sentence_label=labels,
                        generator=generator if dropout else None, **kwargs)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, loss.detach()

    return step


def make_cls_train_step(model: nn.Module, tx: Optimizer, *, dropout: bool = True):
    """Classifier step for ``ImageBertForSequenceClassification`` (the
    full-finetune baselines train so): ``step(state, batch, generator)`` →
    (state, loss), ``batch`` = (input_ids, segment_ids, attention_mask,
    img_feats, labels); the model computes its own loss from ``labels``
    (xe, kl or bce by its config); dropout as in
    :func:`make_mlm_train_step`."""

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None
             ) -> Tuple[TrainState, torch.Tensor]:
        input_ids, segment_ids, attention_mask, img_feats, labels = batch
        model.train(dropout)
        loss, _ = model(input_ids, segment_ids, attention_mask,
                        img_feats=img_feats, labels=labels,
                        generator=generator if dropout else None)
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, loss.detach()

    return step


def batch_arrays_mlm(flat_batch, device) -> Tuple[torch.Tensor, ...]:
    """A training ``FlatBatch`` → (input_ids, segment_ids, attention_mask,
    img_feats, mask_pos, labels) on ``device``."""
    t = flat_batch.tensors
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (t.input_ids, t.segment_ids, t.attention_mask,
                           t.img_feats, t.mask_pos, flat_batch.labels))
