"""Detector training loop (port of ``cpt_tpu/engine/detector_train.py``,
reference ``maskrcnn_benchmark/engine/trainer.py:44-``): iteration-based,
the loss dict summed, ``MetricLogger`` with ETA, a JSONL log, periodic
checkpoints and resume.

Freezing is the JAX package's, which the port keeps as it is: the stem and
the stages before ``FREEZE_CONV_BODY_AT`` and every FrozenBN pair get a
zero gradient, but they stay in the optimizer, so SGD's weight decay and
momentum still move the frozen conv kernels and the FrozenBN scales every
step (``cpt_tpu/engine/detector_train.py:62-63``; the reference's frozen
stages and FrozenBatchNorm buffers never change; ROADMAP, "Defects of the
reference, mirrored"). The port computes no gradient for a frozen leaf
(``requires_grad`` off) and hands the optimizer a zero one.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from cpt_tpu_torch.engine.solver import (DetectorOptimizer, SolverConfig,
                                         build_detector_optimizer)
from cpt_tpu_torch.engine.train import TrainState
from cpt_tpu_torch.models.detector.convert import jax_path
from cpt_tpu_torch.utils import checkpoint as ckpt_lib
from cpt_tpu_torch.utils.metrics import JSONLLogger, MetricLogger, Timer


def detector_leaves(model: torch.nn.Module) -> Tuple[List[str],
                                                     List[torch.Tensor]]:
    """(names, tensors) of every leaf of the JAX parameter tree: the
    model's state-dict entries (parameters and FrozenBN buffers; the int8
    copies are not in it), the tensors themselves."""
    sd = model.state_dict(keep_vars=True)
    return list(sd), [t.data if isinstance(t, torch.nn.Parameter) else t
                      for t in sd.values()]


def freeze_mask(names: List[str], freeze_conv_body_at: int = 2
                ) -> Dict[str, bool]:
    """{leaf name: trainable}, decided on the JAX paths: the stem and
    ``layer1`` .. ``layer{freeze_conv_body_at - 1}`` of the backbone, and
    every FrozenBN pair (``bn*`` / ``*_bn`` scopes), are frozen."""
    frozen_stages = ["stem"] + [f"layer{i}" for i in range(1, freeze_conv_body_at)]

    def trainable(path):
        if "backbone" in path and any(s in path for s in frozen_stages):
            return False
        return not any(p.startswith("bn") or p.endswith("_bn") for p in path)

    return {n: trainable(jax_path(n)) for n in names}


def set_trainable(model: torch.nn.Module, trainable: Dict[str, bool]) -> None:
    """Turn autograd on for the trainable parameters and off for the rest
    (the FrozenBN buffers never need it)."""
    for name, p in model.named_parameters():
        p.requires_grad_(trainable[name])


def make_detector_train_step(trainer_model, tx: DetectorOptimizer,
                             trainable: Dict[str, bool], mesh=None) -> Callable:
    """``step(state, batch, generator)`` → (state, total, losses): the
    summed loss dict of ``trainer_model(*batch, generator)``, its gradients
    for the trainable leaves (zero for the frozen ones), one optimizer
    update of ``state.params`` in place. With ``mesh`` the gradients and
    the losses are averaged over its ``dp`` axis (DDP) before the update;
    each rank's ``trainer_model`` takes its own share of the batch."""
    set_trainable(trainer_model, trainable)
    names = list(trainer_model.state_dict())
    params = dict(trainer_model.named_parameters())
    wanted = [params[n] for n in names if n in params and trainable[n]]

    def step(state: TrainState, batch, generator: torch.Generator):
        trainer_model.train()
        losses = trainer_model(*batch, generator)
        total = sum(losses.values())
        got = list(torch.autograd.grad(total, wanted, allow_unused=True))
        if mesh is not None:
            got, total, losses = _dp_mean(mesh, got, wanted, total, losses)
        got = iter(got)
        grads = [next(got) if n in params and trainable[n] else None
                 for n in names]
        tx.update(grads, state.opt_state, state.params)
        state.step += 1
        return state, total.detach(), {k: v.detach() for k, v in losses.items()}

    return step


def _dp_mean(mesh, grads, wanted, total, losses):
    """Gradients (None → zero), total and loss dict averaged over ``dp``
    in one all-reduce."""
    from cpt_tpu_torch.parallel.mesh import dp_mean

    keys = sorted(losses)
    *grads, total, stacked = dp_mean(
        [torch.zeros_like(p) if g is None else g for g, p in zip(grads, wanted)]
        + [total.detach().float(),
           torch.stack([losses[k].detach().float() for k in keys])], mesh)
    return grads, total, dict(zip(keys, stacked))


def image_generator(generator: torch.Generator, index: int) -> torch.Generator:
    """The generator of image ``index`` of a batched step, seeded from the
    step's generator's seed (``do_train``'s (seed, step)) and the index, as
    JAX splits the step's key per image: an image draws the same samples
    whichever rank of a mesh runs it."""
    seed = (generator.initial_seed() * 1_000_003 + index) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def make_detector_train_step_batched(trainer_model, tx: DetectorOptimizer,
                                     trainable: Dict[str, bool],
                                     mesh=None) -> Callable:
    """Image-batched step (the reference's ``IMS_PER_BATCH``): every batch
    leaf but the anchors carries a leading image axis; the total and each
    loss are means over the images, image ``i`` drawing its samples from
    :func:`image_generator` ``(generator, i)``. With ``mesh``
    (``cpt_tpu/engine/detector_train.py:121-176``) the images are split
    over its ``dp`` axis, each rank running its slice, and the gradients
    and losses averaged (DDP); the image count must divide by dp."""
    return make_detector_train_step(_Batched(trainer_model, mesh), tx,
                                    trainable, mesh)


class _Batched:
    """A trainer over a batch of images (this rank's slice of them over a
    mesh): the mean of the per-image loss dicts; its leaves are the
    wrapped trainer's."""

    def __init__(self, trainer_model, mesh=None):
        self.inner = trainer_model
        self.mesh = mesh

    def state_dict(self, *args, **kwargs):
        return self.inner.state_dict(*args, **kwargs)

    def named_parameters(self):
        return self.inner.named_parameters()

    def train(self, mode: bool = True):
        return self.inner.train(mode)

    def __call__(self, image, image_hw, gt_boxes, gt_labels, gt_valid,
                 gt_attributes, anchors, generator):
        per_image = (image, image_hw, gt_boxes, gt_labels, gt_valid,
                     gt_attributes)
        first = 0
        if self.mesh is not None:
            from cpt_tpu_torch.parallel import mesh as meshlib

            first = (meshlib.axis_index(self.mesh, "dp") * image.shape[0]
                     // meshlib.num_dp(self.mesh))
            per_image = [meshlib.dp_split(x, self.mesh) for x in per_image]
        out = [self.inner(*one, anchors, image_generator(generator, first + i))
               for i, one in enumerate(zip(*per_image))]
        return {k: sum(o[k] for o in out) / len(out) for k in out[0]}


def do_train(trainer_model, data_iter: Iterable, *, solver: SolverConfig,
             device, checkpoint_dir: Optional[str] = None,
             checkpoint_period: int = 10000, log_period: int = 20,
             freeze_conv_body_at: int = 2, seed: int = 0,
             logger: Optional[Callable[[str], None]] = print,
             metrics_jsonl: Optional[str] = None,
             on_step: Optional[Callable[[int, float, Dict[str, float]], None]] = None
             ) -> TrainState:
    """Iteration-based training of ``trainer_model`` (an
    ``AttrRCNNTrainer``, its weights loaded) over ``data_iter``, which
    yields (image, hw, gt_boxes, gt_labels, gt_valid, gt_attributes,
    anchors) on ``device``, to ``solver.max_iter``. The samples of step
    ``it`` are drawn from a generator seeded with (``seed``, ``it``). A
    checkpoint under ``checkpoint_dir`` is resumed from, and the batches the
    run already took are skipped, so the resumed run goes on as the
    uninterrupted one (the JAX loop restarts its data and its random
    stream). Checkpoints ``model_{it:07d}`` every ``checkpoint_period``
    steps and ``model_final``; ``on_step(it, total, losses)`` after each
    step."""
    names, leaves = detector_leaves(trainer_model)
    tx = build_detector_optimizer([jax_path(n) for n in names], solver)
    state = TrainState(params=leaves, opt_state=tx.init(leaves))
    if checkpoint_dir and ckpt_lib.has_checkpoint(checkpoint_dir):
        saved = ckpt_lib.restore_checkpoint(checkpoint_dir, state)
        with torch.no_grad():
            for t, s in zip(state.params, saved.params):
                t.copy_(s)
        state.opt_state, state.step = saved.opt_state, saved.step
        logger(f"resumed from {ckpt_lib.last_checkpoint_name(checkpoint_dir)}")

    trainable = freeze_mask(names, freeze_conv_body_at)
    step_fn = make_detector_train_step(trainer_model, tx, trainable)
    meters, timer = MetricLogger(), Timer()
    jsonl = JSONLLogger(metrics_jsonl) if metrics_jsonl else None
    it = state.step
    data = iter(data_iter)
    for _ in range(it):
        next(data)
    for batch in data:
        if it >= solver.max_iter:
            break
        timer.tic()
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + it)
        state, total, losses = step_fn(state, batch, gen)
        total = float(total)
        vals = {k: float(v) for k, v in losses.items()}
        meters.update(time=timer.toc(average=False), loss=total, **vals)
        it += 1
        if on_step is not None:
            on_step(it, total, vals)
        if it % log_period == 0:
            logger(meters.log_line(it, solver.max_iter))
            if jsonl is not None:
                jsonl.log(it, loss=total, **vals)
        if checkpoint_dir and it % checkpoint_period == 0:
            ckpt_lib.save_checkpoint(checkpoint_dir, f"model_{it:07d}", state)
    if checkpoint_dir:
        ckpt_lib.save_checkpoint(checkpoint_dir, "model_final", state)
    trainer_model.eval()
    return state
