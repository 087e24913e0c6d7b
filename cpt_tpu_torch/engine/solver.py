"""Detector-training solver (port of ``cpt_tpu/engine/solver.py``):
``SolverConfig`` (which ``models/detector/yacs_bridge`` fills from a
reference yaml's ``SOLVER`` keys), ``warmup_multistep_lr`` and
``build_detector_optimizer``.

As the reference ``maskrcnn_benchmark/solver`` and the JAX optax chains:
  * ``build.py:9-21``: SGD with momentum 0.9 and per-leaf groups, biases at
    ``lr × BIAS_LR_FACTOR`` (2) and ``WEIGHT_DECAY_BIAS`` (0), everything
    else at the base rate and ``WEIGHT_DECAY``; optax's order, the decay
    added to the gradient first (``add_decayed_weights``), then the trace
    ``m = g + μ·m`` and the update ``−lr·m``;
  * ``build.py:24-80``: ADAMW (optax's ``adamw`` on the schedule, weight
    decay per group, no bias doubling) after a global-norm clip at
    ``clip_gradients`` or 5.0;
  * ``lr_scheduler.py:10-52``: WarmupMultiStepLR, a linear (or constant)
    warmup, then ×γ at each milestone, evaluated in f32.

The optimizer steps a list of leaves in place: every tensor of the JAX
parameter tree (the model's parameters and its FrozenBN buffers), each with
an f32 master copy, so a bf16 model trains as JAX's f32 parameters under a
bf16 compute dtype do. A leaf without a gradient takes a zero one, so its
decay and momentum still move it, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 0.01
    bias_lr_factor: float = 2.0
    momentum: float = 0.9
    weight_decay: float = 1e-4
    weight_decay_bias: float = 0.0
    gamma: float = 0.1
    steps: Tuple[int, ...] = (49000, 65000)
    max_iter: int = 90000
    warmup_factor: float = 1.0 / 3
    warmup_iters: int = 500
    warmup_method: str = "linear"       # linear | constant
    optimizer: str = "SGD"              # SGD | ADAMW
    clip_gradients: float = 0.0         # 0 disables (ADAMW path uses 5.0)


_f32 = np.float32


def warmup_multistep_lr(cfg: SolverConfig) -> Callable[[int], np.float32]:
    """step → learning rate: ``base_lr · warmup · γ^(milestones passed)``,
    in f32 as the JAX schedule computes it."""
    milestones = [_f32(s) for s in cfg.steps]

    def schedule(step) -> np.float32:
        step = _f32(step)
        factor = _f32(cfg.gamma) ** _f32(sum(step >= m for m in milestones))
        if cfg.warmup_method == "linear":
            alpha = step / _f32(max(cfg.warmup_iters, 1))
            wf = _f32(cfg.warmup_factor) * (_f32(1) - alpha) + alpha
        else:
            wf = _f32(cfg.warmup_factor)
        warm = wf if step < cfg.warmup_iters else _f32(1.0)
        return _f32(cfg.base_lr) * warm * factor

    return schedule


def _is_bias(path: Tuple[str, ...]) -> bool:
    """The JAX package's bias rule, kept as it is: ``"bn" in path[-2:]``
    asks whether the *element* "bn" is in the pair, and the FrozenBN scopes
    are named ``bn1``/``bn2``/``bn3``/``downsample_bn``, so a FrozenBN
    ``scale`` is not a bias and takes the weight decay (ROADMAP, "Defects of
    the reference, mirrored")."""
    return path[-1] in ("bias",) or "bn" in path[-2:] and path[-1] == "scale"


def clip_gradients(grads: Sequence[torch.Tensor], max_norm: float
                   ) -> List[torch.Tensor]:
    """optax ``clip_by_global_norm``: every gradient scaled by
    ``max_norm / ‖g‖`` unless the global norm is below ``max_norm``."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    if norm < max_norm:
        return list(grads)
    return [g / norm * max_norm for g in grads]


@dataclasses.dataclass
class DetectorOptState:
    """optax's ``count``, the SGD trace (ADAMW: the first moment), ADAMW's
    second moment, and the f32 master copy of every leaf."""

    count: int
    trace: List[torch.Tensor]
    master: List[torch.Tensor]
    nu: Optional[List[torch.Tensor]] = None


class DetectorOptimizer:
    """The transformation :func:`build_detector_optimizer` returns:
    ``init(leaves)`` → :class:`DetectorOptState`; ``update(grads, state,
    leaves)`` steps the leaves in place (a None gradient counts as zero).
    ``paths`` are the leaves' paths in the JAX tree, which decide the bias
    group."""

    def __init__(self, paths: Sequence[Tuple[str, ...]], cfg: SolverConfig):
        if cfg.optimizer not in ("SGD", "ADAMW"):
            raise ValueError(f"optimizer must be SGD or ADAMW, got "
                             f"{cfg.optimizer!r}")
        self.cfg = cfg
        self.paths = list(paths)
        self.bias = [_is_bias(p) for p in self.paths]
        self.schedule = warmup_multistep_lr(cfg)

    def init(self, leaves: Sequence[torch.Tensor]) -> DetectorOptState:
        zeros = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        return DetectorOptState(
            count=0, trace=zeros,
            master=[t.detach().float().clone() for t in leaves],
            nu=([z.clone() for z in zeros] if self.cfg.optimizer == "ADAMW"
                else None))

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]],
               state: DetectorOptState, leaves: Sequence[torch.Tensor]) -> None:
        cfg = self.cfg
        g = [torch.zeros_like(m) if gi is None else gi.float()
             for gi, m in zip(grads, state.master)]
        clip = (cfg.clip_gradients or 5.0) if cfg.optimizer == "ADAMW" \
            else cfg.clip_gradients
        if clip > 0:
            g = clip_gradients(g, clip)
        lr = self.schedule(state.count)
        t = state.count + 1
        if cfg.optimizer == "ADAMW":
            fix1 = 1 - torch.tensor(0.9, dtype=torch.float32) ** t
            fix2 = 1 - torch.tensor(0.999, dtype=torch.float32) ** t
        for i, p in enumerate(state.master):
            wd = cfg.weight_decay_bias if self.bias[i] else cfg.weight_decay
            if cfg.optimizer == "ADAMW":
                state.trace[i] = 0.1 * g[i] + 0.9 * state.trace[i]
                state.nu[i] = 0.001 * g[i].square() + 0.999 * state.nu[i]
                u = ((state.trace[i] / fix1)
                     / (torch.sqrt(state.nu[i] / fix2) + 1e-8) + wd * p)
                p.add_(u * -lr)
            else:
                mul = cfg.bias_lr_factor if self.bias[i] else 1.0
                state.trace[i] = (g[i] + wd * p) + cfg.momentum * state.trace[i]
                p.add_(state.trace[i] * -(lr * _f32(mul)))
            leaves[i].copy_(p)
        state.count = t


def build_detector_optimizer(paths: Sequence[Tuple[str, ...]],
                             cfg: SolverConfig) -> DetectorOptimizer:
    """SGD with bias doubling (or ADAMW with its clip) over leaves whose
    JAX-tree paths are ``paths`` (``models/detector/convert.jax_path``),
    under ``warmup_multistep_lr``."""
    return DetectorOptimizer(paths, cfg)
