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
(``--ann_file``; Pillow), or ``--synthetic N`` (random canvases with two
fixed boxes). Images go onto the ``input.pad_h`` × ``pad_w`` canvas as
they are, as in the JAX tool. Without ``--checkpoint`` the weights are
random, drawn from seed 0 in the VinVL layout. ``--config_file`` /
``--opts`` read a reference yacs yaml (the detector and the full solver;
the schedule flags override). On a CUDA device the kernels need bf16 (the
default ``--dtype``); ``--device cpu --dtype float32`` runs their plain
versions. ``--sg`` (the scene-graph relation head) and a multi-process
launch are refused.
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
from cpt_tpu_torch.tools._common import (add_detector_config_args,
                                         apply_reference_config,
                                         refuse_multi_process)

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
                   help="the RPN's and the box head's sampling streams")
    p.add_argument("--sg", action="store_true",
                   help="train the SceneParser relation head (not ported "
                        "yet: ROADMAP.md Queue 1 item 7)")
    p.add_argument("--rel_algorithm", default="sg_reldn",
                   choices=["sg_reldn", "sg_imp", "sg_msdn", "sg_grcnn",
                            "sg_nm"])
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


def build_trainer(args, cfg, device) -> AttrRCNNTrainer:
    """The trainer on ``device`` in ``--dtype``, its weights from
    ``--checkpoint`` or random VinVL-layout weights drawn from seed 0."""
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with torch.device(device):
        trainer = AttrRCNNTrainer(cfg, dtype)
    if args.checkpoint:
        sd = dconv.load_vinvl_checkpoint(args.checkpoint, cfg)
        print(f"loaded {args.checkpoint}")
    else:
        sd = dconv.state_from_reference(
            dconv.random_vinvl_state_dict(cfg, seed=0), cfg)
    trainer.load_state_dict(sd)
    return trainer


def main(argv=None):
    refuse_multi_process("train_detector")
    parser = build_args()
    ref = apply_reference_config(parser, argv)
    args = parser.parse_args(argv)
    if args.sg:
        raise SystemExit("train_detector: --sg (the SceneParser relation "
                         "head) is not ported yet (ROADMAP.md Queue 1 item 7)")
    if ref is not None:
        cfg = ref.detector
    else:
        cfg = tiny_detector_config() if args.tiny else VINVL_X152C4
    device = torch.device(args.device)
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
