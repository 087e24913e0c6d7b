"""Detector-training solver settings (the port's copy of ``SolverConfig`` in
``cpt_tpu/engine/solver.py``), which ``models/detector/yacs_bridge`` fills
from a reference yaml's ``SOLVER`` keys.

The solver itself, SGD with bias doubling (reference
``maskrcnn_benchmark/solver/build.py:9-21``) and ``warmup_multistep_lr``
(``lr_scheduler.py:10-52``), comes with detector training (ROADMAP.md
Queue 1 item 7) and extends this file.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
