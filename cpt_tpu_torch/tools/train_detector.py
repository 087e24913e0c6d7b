"""Detector training (port of ``cpt_tpu/tools/train_detector.py``, the
reference ``prompt_feat/tools/train_sg_net.py`` + ``engine/trainer.py``):
iteration-based SGD training of the VinVL detector (RPN, box and attribute
losses) with WarmupMultiStepLR, stage freezing, periodic checkpoints and
resume from the last one.

  python -m cpt_tpu_torch.tools.train_detector --tsv train.yaml \\
      [--checkpoint vinvl_vg_x152c4.pth] [--output_dir ckpt] \\
      [--max_iter 90000 --steps 49000 65000 --base_lr 0.01]

Data: an od / VG TSV yaml (``--tsv``; several, comma-separated, train over
their concatenation), a json list ``[{img, boxes [[x, y, w, h], ...],
labels [...], attributes [[...], ...]}]`` with ``--image_root``
(``--ann_file``; JPEG, PNG, GIF, BMP, WEBP or TIFF through
``utils/image_codec``), or
``--synthetic N`` (random canvases with two fixed boxes). Images go onto
the ``input.pad_h`` × ``pad_w`` canvas as
they are, as in the JAX tool. Without ``--checkpoint`` the weights are
random, drawn from seed 0 in the VinVL layout. ``--config_file`` /
``--opts`` read a reference yacs yaml (the detector and the full solver;
the schedule flags override). On a CUDA device the kernels need bf16 (the
default ``--dtype``); ``--device cpu --dtype float32`` runs their plain
versions. A multi-process launch is refused (ROADMAP.md Queue 1 item 9).

``--sg`` trains a ``SceneParser``'s relation head instead (the reference's
``train_sg_net.py`` with ``RELATION_ON``; ``train_scene_graph``): the
first ``--tsv`` yaml's gt boxes (the first ``--max_rel_dets``) stand for the
detections and its relations (the first ``--max_rels`` among them) label the
pairs, the predicate cross entropy over all pairs; the dataset's frequency
prior feeds RelDN; SGD with momentum 0.9 and no weight decay (optax's
``sgd``) on ``warmup_multistep_lr``. The detector is frozen: it runs under
``torch.no_grad`` and stays out of the optimizer (JAX zeroes its gradient,
which leaves it unchanged under momentum SGD without decay). The relation
head starts from flax's initializers drawn from ``--seed``; ``--output_dir``
gets a ``scene_parser`` checkpoint (``utils/checkpoint.py``):

  python -m cpt_tpu_torch.tools.train_detector --sg --tsv vg_rel.yaml \
      --rel_algorithm sg_reldn [--checkpoint det.pth] --max_iter 1000
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from cpt_tpu_torch.data.detector_transforms import TrainTransforms
from cpt_tpu_torch.engine.detector_train import do_train
from cpt_tpu_torch.engine.solver import SolverConfig
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNNTrainer
from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                  tiny_detector_config)
from cpt_tpu_torch.models.detector.rpn import grid_anchors
from cpt_tpu_torch.models.detector.scene_parser import ALGORITHMS, SceneParser
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_detector_config_args,
                                         apply_reference_config)

MAX_ATTR = 16


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ann_file", default=None)
    p.add_argument("--tsv", default=None,
                   help="od/vg-TSV dataset yaml (reference vg_tsv.py "
                        "format: img/label/hw TSVs + labelmap jsondict); "
                        "comma-separate several yamls to train over their "
                        "concatenation (DATASETS.TRAIN tuple)")
    p.add_argument("--image_root", default=None)
    p.add_argument("--checkpoint", default=None, help="init weights .pth")
    p.add_argument("--output_dir", default="./detector_ckpt")
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--max_iter", type=int, default=90000)
    p.add_argument("--steps", type=int, nargs="+", default=[49000, 65000])
    p.add_argument("--warmup_iters", type=int, default=500)
    p.add_argument("--checkpoint_period", type=int, default=10000)
    p.add_argument("--freeze_conv_body_at", type=int, default=2)
    p.add_argument("--max_gt", type=int, default=32)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--synthetic", type=int, default=None)
    p.add_argument("--hflip_prob", type=float, default=0.5,
                   help="train-time horizontal flip (reference "
                        "transforms/build.py:14: FLIP_PROB_TRAIN=0.5)")
    p.add_argument("--vflip_prob", type=float, default=0.0)
    p.add_argument("--color_jitter", type=float, nargs=4,
                   default=[0.0, 0.0, 0.0, 0.0],
                   metavar=("B", "C", "S", "H"),
                   help="brightness/contrast/saturation/hue jitter")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="the RPN's and the box head's sampling streams; "
                        "with --sg, the relation head's initialization")
    p.add_argument("--sg", action="store_true",
                   help="train the SceneParser relation head over a "
                        "VG-TSV with relations (reference train_sg_net.py "
                        "with RELATION_ON: detector frozen, gt boxes as "
                        "detections, predicate CE)")
    p.add_argument("--rel_algorithm", default="sg_reldn", choices=ALGORITHMS)
    p.add_argument("--max_rel_dets", type=int, default=16)
    p.add_argument("--max_rels", type=int, default=32,
                   help="gt relation slots per image (padded)")
    return add_detector_config_args(p)


def pad_gt(boxes, labels, attrs, g: int):
    """(boxes [g, 4], labels [g], valid [g], attributes [g, 16]): the first
    ``g`` gt objects, zero-padded."""
    b = np.zeros((g, 4), np.float32)
    lab = np.zeros((g,), np.int64)
    a = np.zeros((g, MAX_ATTR), np.int64)
    v = np.zeros((g,), bool)
    n = min(len(boxes), g)
    b[:n] = boxes[:n]
    lab[:n] = labels[:n]
    v[:n] = True
    for i in range(n):
        row = (attrs[i] if attrs else [])[:MAX_ATTR]
        a[i, :len(row)] = row
    return b, lab, v, a


def batches(args, cfg, device, anchors):
    """The JAX tool's sample stream, endless, each sample on ``device``:
    (canvas [H, W, 3], hw, gt boxes, labels, valid, attributes, anchors).
    The ``--ann_file`` stream flips the boxes after the canvas is filled,
    as the JAX tool does (ROADMAP, "Defects of the reference, mirrored")."""
    h, w = cfg.input.pad_h, cfg.input.pad_w
    aug = TrainTransforms(args.hflip_prob, args.vflip_prob, *args.color_jitter,
                          seed=1)

    def sample(canvas, hw, b, lab, v, a):
        return (torch.from_numpy(canvas).to(device),
                torch.as_tensor(hw, dtype=torch.int32, device=device),
                torch.from_numpy(b).to(device), torch.from_numpy(lab).to(device),
                torch.from_numpy(v).to(device), torch.from_numpy(a).to(device),
                anchors)

    if args.tsv:
        from cpt_tpu_torch.data.vg_tsv import (ConcatDetectionDataset,
                                               DetectionTSVDataset)

        parts = [DetectionTSVDataset(p, attribute_on=True)
                 for p in args.tsv.split(",")]
        ds = parts[0] if len(parts) == 1 else ConcatDetectionDataset(parts)
        while True:
            for i in range(len(ds)):
                img, target, _ = ds[i]
                img, tboxes = aug(img, target["boxes"])
                canvas = np.zeros((h, w, 3), np.float32)
                ih, iw = img.shape[:2]
                canvas[:min(ih, h), :min(iw, w)] = img[:h, :w]
                yield sample(canvas, [min(ih, h), min(iw, w)], *pad_gt(
                    tboxes, target["labels"],
                    target.get("attributes", np.zeros(0)).tolist(), args.max_gt))
    if args.synthetic is not None:
        rng = np.random.RandomState(0)
        boxes = np.array([[8, 8, 40, 40], [50, 20, 60, 60]], np.float32)
        while True:
            img = rng.randn(h, w, 3).astype(np.float32) * 30
            yield sample(img, [h, w], *pad_gt(boxes, [1, 2], [[1], [2]],
                                              args.max_gt))
    from cpt_tpu_torch.tools.extract_features import load_image

    with open(args.ann_file) as f:
        anns = json.load(f)
    while True:
        for ann in anns:
            img, hw = load_image(f"{args.image_root}/{ann['img']}", h, w)
            canvas = np.zeros((h, w, 3), np.float32)
            canvas[:img.shape[0], :img.shape[1]] = img
            boxes = np.asarray(ann["boxes"], np.float32)
            boxes[:, 2] = boxes[:, 0] + boxes[:, 2] - 1
            boxes[:, 3] = boxes[:, 1] + boxes[:, 3] - 1
            img, boxes = aug(img, boxes)
            yield sample(canvas, hw, *pad_gt(boxes, ann["labels"],
                                             ann.get("attributes"), args.max_gt))


def _dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def detector_weights(args, cfg) -> dict:
    """The detector's state dict: ``--checkpoint``, or random VinVL-layout
    weights drawn from seed 0."""
    if args.checkpoint:
        sd = dconv.load_vinvl_checkpoint(args.checkpoint, cfg)
        print(f"loaded {args.checkpoint}")
        return sd
    return dconv.state_from_reference(dconv.random_vinvl_state_dict(cfg, seed=0),
                                      cfg)


def build_trainer(args, cfg, device) -> AttrRCNNTrainer:
    """The trainer on ``device`` in ``--dtype``, its weights from
    :func:`detector_weights`."""
    with torch.device(device):
        trainer = AttrRCNNTrainer(cfg, _dtype(args))
    trainer.load_state_dict(detector_weights(args, cfg))
    return trainer


def build_scene_parser(args, cfg, num_rel_classes: int, device) -> SceneParser:
    """``--sg``'s SceneParser on ``device`` in ``--dtype``: the detector from
    :func:`detector_weights`, the relation head from flax's initializers
    drawn from ``--seed``."""
    with torch.device(device):
        parser = SceneParser(cfg, num_rel_classes, args.max_rel_dets,
                             args.rel_algorithm, _dtype(args))
    parser.detector.load_state_dict(detector_weights(args, cfg))
    parser.init_relation(torch.Generator().manual_seed(args.seed))
    return parser


def sg_samples(args, cfg, ds, device):
    """The JAX tool's ``--sg`` sample stream, endless over ``ds``: (canvas
    [H, W, 3] f32 as it is, hw, boxes [k, 4], labels [k], valid [k], rels
    [r, 3], rel_valid [r]) with k = ``--max_rel_dets`` gt boxes and r =
    ``--max_rels`` of the relations between them, zero-padded."""
    h = w = cfg.input.pad_h
    k, r = args.max_rel_dets, args.max_rels
    while True:
        for i in range(len(ds)):
            img, target, _ = ds[i]
            canvas = np.zeros((h, w, 3), np.float32)
            ih, iw = img.shape[:2]
            canvas[:min(ih, h), :min(iw, w)] = img[:h, :w]
            boxes = np.zeros((k, 4), np.float32)
            labels = np.zeros((k,), np.int64)
            valid = np.zeros((k,), bool)
            n = min(len(target["boxes"]), k)
            boxes[:n] = target["boxes"][:n]
            labels[:n] = target["labels"][:n]
            valid[:n] = True
            rels = np.zeros((r, 3), np.int64)
            rel_valid = np.zeros((r,), bool)
            tr = target.get("relation_triplets", np.zeros((0, 3), np.int64))
            tr = tr[(tr[:, 0] < n) & (tr[:, 1] < n)][:r]
            rels[:len(tr)] = tr
            rel_valid[:len(tr)] = True
            yield ((torch.from_numpy(canvas).to(device),
                    (min(ih, h), min(iw, w)))
                   + tuple(torch.from_numpy(a).to(device)
                           for a in (boxes, labels, valid, rels, rel_valid)))


def sg_solver(args, ref) -> SolverConfig:
    """``--sg``'s optimizer, optax's ``sgd(schedule, momentum=0.9)``: the
    (yaml's) schedule, no weight decay, no bias doubling, no clipping."""
    return dataclasses.replace(
        ref.solver if ref is not None else SolverConfig(),
        base_lr=args.base_lr, steps=tuple(args.steps), max_iter=args.max_iter,
        warmup_iters=args.warmup_iters, optimizer="SGD", momentum=0.9,
        weight_decay=0.0, weight_decay_bias=0.0, bias_lr_factor=1.0,
        clip_gradients=0.0)


def make_sg_train_step(parser: SceneParser, solver: SolverConfig,
                       freq: torch.Tensor):
    """``step(batch)`` → the loss: one relation-head step on an
    :func:`sg_samples` batch, the detector under ``torch.no_grad``, the
    gradients of every leaf outside it (FrozenBN pairs of its stage-5
    extractor included, as JAX trains them) into one SGD update."""
    from cpt_tpu_torch.engine.solver import DetectorOptimizer

    leaves = parser.relation_parameters()
    for t in leaves.values():
        t.requires_grad_(True)
    tx = DetectorOptimizer([dconv.jax_path(n) for n in leaves], solver)
    tensors = [t.data for t in leaves.values()]
    opt_state = tx.init(tensors)

    def step(batch) -> torch.Tensor:
        image, hw, boxes, labels, valid, rels, rel_valid = batch
        with torch.no_grad():
            frozen = parser.detector_outputs(image, boxes, valid)
        loss = parser.relation_train_loss(image, hw, boxes, labels, valid, rels,
                                          boxes, rel_valid, freq, frozen=frozen)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        tx.update(grads, opt_state, tensors)
        return loss.detach()

    return step


def train_scene_graph(args, cfg, ref, device, on_step=None):
    """``--sg``: relation-head training (gt boxes as detections, the detector
    frozen; the reference SceneParser freezes it, ``scene_parser.py:39`` +
    ``train_sg_net.py``). ``on_step(i, loss)`` sees each step's loss (a
    tensor). → (the SceneParser, the steps' losses)."""
    from cpt_tpu_torch.data.vg_tsv import VGTSVDataset
    from cpt_tpu_torch.utils import checkpoint as ckpt_lib

    if not args.tsv:
        raise SystemExit("train_detector: --sg requires --tsv (a VG-TSV with "
                         "relations)")
    ds = VGTSVDataset(args.tsv.split(",")[0], attribute_on=False,
                      relation_on=True)
    parser = build_scene_parser(args, cfg, len(ds.relation_to_ind), device)
    freq = torch.from_numpy(ds.compute_freq_prior().astype(np.float32)).to(device)
    step = make_sg_train_step(parser, sg_solver(args, ref), freq)
    data = sg_samples(args, cfg, ds, device)
    losses = []
    for i in range(args.max_iter):
        loss = step(next(data))
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, loss)
        if (i + 1) % 20 == 0 or i + 1 == args.max_iter:
            print(f"iter {i + 1}: rel loss {losses[-1]:.4f}")
    if args.output_dir:
        ckpt_lib.save_checkpoint(args.output_dir, "scene_parser",
                                 {"params": parser.state_dict()})
    return parser, losses


def main(argv=None):
    distributed.initialize_from_env()
    parser = build_args()
    ref = apply_reference_config(parser, argv)
    args = parser.parse_args(argv)
    if ref is not None:
        cfg = ref.detector
    else:
        cfg = tiny_detector_config() if args.tiny else VINVL_X152C4
    device = torch.device(args.device)
    if args.sg:
        return train_scene_graph(args, cfg, ref, device)
    trainer = build_trainer(args, cfg, device)
    anchors = torch.from_numpy(grid_anchors(
        cfg.rpn, cfg.input.pad_h // 16, cfg.input.pad_w // 16)).to(device)
    # --config_file supplies the whole reference solver (weight decay,
    # momentum, optimizer, clipping); the flags set the rate and schedule
    solver = dataclasses.replace(
        ref.solver if ref is not None else SolverConfig(),
        base_lr=args.base_lr, steps=tuple(args.steps), max_iter=args.max_iter,
        warmup_iters=args.warmup_iters)
    state = do_train(trainer, batches(args, cfg, device, anchors),
                     solver=solver, device=device,
                     checkpoint_dir=args.output_dir,
                     checkpoint_period=args.checkpoint_period,
                     freeze_conv_body_at=args.freeze_conv_body_at,
                     seed=args.seed)
    print(f"trained to step {state.step}")
    return state


if __name__ == "__main__":
    main()
