"""Stage-1 extraction tool for colorful-prompt features (port of
``cpt_tpu/tools/extract_features.py`` but its multi-device options).

Loads the VinVL X152-C4 detector, paints colored copies of each image,
extracts 2054-d region features in force-boxes mode and writes the
interchange ``predictions.tsv``. ``--task`` picks the paint and the
payload: ``refcoco`` one copy per candidate box in red (or, where the dets
carry ``"rle"`` masks, the SEG variant: each candidate's mask painted);
``gqa`` one copy per question, the entity the question names (``--to_mark``
or, without it, ``stage1_tasks.parse_gqa_marks``) painted inclusively;
``vcr`` the entities' segmentation masks in up to ``--color_d`` palette
colors, composited on the host; ``vg`` one copy per subject/object pair
(subject red, object blue; a pickle ``--ann_file`` in the reference's own
layout expands every overlapping pair); ``plain`` no paint:

  python -m cpt_tpu_torch.tools.extract_features --ann_file refs.json \\
      --det_file dets.json --image_root images/ --output predictions.tsv \\
      [--checkpoint vinvl_vg_x152c4.pth] [--precision int8|int8:<s>]
  python -m cpt_tpu_torch.tools.extract_features --task vcr \\
      --ann_file vcr_val.json --det_file dets.json --to_mark to_mark.json \\
      --image_root vcr1images/ --output predictions.tsv
  python -m cpt_tpu_torch.tools.extract_features --task gqa \\
      --yaml gqa_testdev.yaml --labelmap VG-SGG-dicts.json --output p.tsv
  python -m cpt_tpu_torch.tools.extract_features --task vg \\
      --ann_file vg_test.pk --vocab_file VG-SGG-dicts.json \\
      --image_root vg/ --output predictions.tsv

``--yaml`` reads a task descriptor (``ann``, ``det``, ``image_root``,
``to_mark``, ``vocab`` keys, the reference's ``prompt_feat/data/*/yamls``
convention; needs PyYAML); ``--labelmap`` names the detector's classes in
the TSV (``{"idx_to_label": {...}}`` or a flat map).

``--config_file`` takes the reference's own yacs yaml and ``--opts`` its
trailing ``KEY VALUE`` overrides (``tools/_common.apply_reference_config``):
the detector config comes from the yaml, ``DATASETS.TEST`` picks
``--task``, ``DATA_DIR`` gives ``--yaml``, ``OUTPUT_DIR`` the output
``<OUTPUT_DIR>/inference/<DATA_DIR stem>/predictions.tsv``, and the CPT keys
of the opts (``N_SHOT``, ``RAND_SEED``, ``TOTAL_STEP``, ``CUR_STEP``,
``COLOR_D``, ``COLOR_NAME``, ``COLOR_RGB``) their flags; explicit flags
win:

  python -m cpt_tpu_torch.tools.extract_features \\
      --config_file sgg_configs/vgattr/vinvl_x152c4.yaml \\
      --opts TEST.IGNORE_BOX_REGRESSION True MODEL.ROI_HEADS.NMS_FILTER 2 \\
      DATASETS.TEST "('RefCoCoDataset',)" DATA_DIR refcoco_val.yaml \\
      OUTPUT_DIR out/

``--image_dir`` runs plain RPN-mode detection over every ``*.jpg`` of a
folder (the reference's ``ImgDataset`` pass, ``cmds/gqa/_ext.sh``): one
row a file, keyed by its stem, with each detection's rect, class, conf
and 2054-d feature:

  python -m cpt_tpu_torch.tools.extract_features --image_dir images/ \\
      --output plain.tsv [--labelmap VG-SGG-dicts.json]

  python -m cpt_tpu_torch.tools.extract_features --synthetic 4 \\
      --output out.tsv --copies_per_chunk 4 --precision int8
  python -m cpt_tpu_torch.tools.extract_features --synthetic 8 --windowed \\
      --copies_per_chunk 8 --output out.tsv

``--windowed`` reuses one base map per query (``engine/windowed.py``):
each copy recomputes the backbone's first two stages only on the smallest
window of ``--windows`` its paint fits, the rest of the copies take the
full path. It is exact on X152 (two-level, halo 160); where the halo
cannot make it exact the tool keeps the full path, unless
``--allow-approximate``, which logs the measured drift on the first query.

``--precision int8`` runs the conv body in W8A8 (``ops/quant.py``; the
grouped 3x3 on kernel K1q). Its activation scales are per tensor over a
whole chunk of copies, padding copies included, so a copy's int8 features
depend on the copies batched with it (in the JAX package too): fix
``--copies_per_chunk`` to compare runs. ``--total_step/--cur_step`` slice
the annotations as the reference's resumable shard loop does (under a
multi-process launch, ``--shard_by_process`` sets them from the process
group and writes one ``.shard<i>`` output a process),
``--n_shot/--rand_seed`` sample its few-shot subset. Without
``--checkpoint`` the weights are random, drawn from ``--seed`` in the
reference layout; ``--synthetic N`` extracts N random queries instead of
real data. On a CUDA device the kernels take bf16 (the default
``--dtype``); ``--device cpu --dtype float32`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import time

import numpy as np
import torch

from cpt_tpu_torch.data.prompts import CROSS_TASK_COLORS, REFCOCO_COLORS
from cpt_tpu_torch.engine.extract import (Extractor, gqa_payload,
                                          make_detect_fn, plain_payload,
                                          refcoco_mask_task, refcoco_payload,
                                          refcoco_task, vcr_payload,
                                          vg_payload)
from cpt_tpu_torch.engine.windowed import WINDOW_LADDER
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                  tiny_detector_config)
from cpt_tpu_torch.models.detector.rpn import grid_anchors
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_detector_config_args,
                                         apply_reference_config, dp_mesh)
from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer

def build_args():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default=None,
                   choices=["refcoco", "gqa", "vcr", "vg", "plain"],
                   help="the coloring scheme and the TSV payload layout "
                        "(default refcoco, or DATASETS.TEST of "
                        "--config_file)")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--det_file", default=None)
    p.add_argument("--to_mark", default=None,
                   help="gqa: parsed entity marks {q_id: [[box, positions], "
                        "...]} (parsed from the question where a q_id has "
                        "none); vcr, the reference's annot_id layout: "
                        "{img_id: {boxes, names}}")
    p.add_argument("--yaml", default=None,
                   help="task descriptor yaml with ann / det / image_root / "
                        "to_mark / vocab keys (the reference's "
                        "prompt_feat/data/*/yamls convention)")
    p.add_argument("--image_root", default=None)
    p.add_argument("--labelmap", default=None,
                   help="class names of the detector's labels in the TSV: "
                        "json {\"idx_to_label\": {\"1\": name}} or {\"1\": name}")
    p.add_argument("--vocab_file", default=None,
                   help="idx_to_label vocab json of VG's pickle annotations "
                        "(default: the task yaml's 'vocab' entry)")
    p.add_argument("--checkpoint", default=None,
                   help="vinvl_vg_x152c4.pth (reference layout, a "
                        "'module.'-wrapped one too) or a Detectron .pkl")
    p.add_argument("--output", default=None,
                   help="predictions.tsv path (required unless "
                        "--config_file supplies OUTPUT_DIR)")
    p.add_argument("--total_step", type=int, default=None)
    p.add_argument("--cur_step", type=int, default=None)
    p.add_argument("--overwrite", action="store_true",
                   help="re-extract even if the output TSV exists")
    p.add_argument("--n_shot", type=int, default=None)
    p.add_argument("--rand_seed", type=int, default=None)
    p.add_argument("--color_name", default=None,
                   help="paint-color override: the color word of the payload")
    p.add_argument("--color_rgb", default=None,
                   help="paint-color override, 'R-G-B'")
    p.add_argument("--color_d", type=int, default=None,
                   help="refcoco: paint alpha of the color override "
                        "(refcocodataset.py:359); vcr: number of palette "
                        "colors painted, 0 = the uncolored 'pt' variant "
                        "(vcrdataset.py:127)")
    p.add_argument("--copies_per_chunk", type=int, default=None,
                   help="fixed chunk size; default auto (a pixel budget)")
    p.add_argument("--resize", action="store_true",
                   help="apply the MIN/MAX_SIZE_TEST 600/1000 resize rule")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--precision", default="bf16",
                   help="conv-body precision: bf16, int8 (W8A8, dynamic "
                        "activation scales) or int8:<s> (scale pinned to s)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny detector config (smoke tests)")
    p.add_argument("--nms_filter", type=int, default=None,
                   help="override MODEL.ROI_HEADS.NMS_FILTER (0/1/2)")
    p.add_argument("--ignore_box_regression", action="store_true",
                   help="TEST.IGNORE_BOX_REGRESSION")
    p.add_argument("--synthetic", type=int, default=None,
                   help="extract N synthetic queries instead of real data")
    p.add_argument("--windowed", action="store_true",
                   help="windowed extraction over one base map a query; "
                        "exact where the halo covers 2x the receptive field "
                        "of what is recomputed, else the full path unless "
                        "--allow-approximate")
    p.add_argument("--allow-approximate", action="store_true",
                   dest="allow_approximate",
                   help="keep --windowed where it is approximate (the "
                        "drift is measured and logged on the first query)")
    p.add_argument("--windows",
                   default=",".join(f"{h}x{w}" for h, w in WINDOW_LADDER),
                   help="comma-separated HxW window ladder of --windowed: "
                        "each copy takes the smallest window its paint fits")
    p.add_argument("--image_dir", default=None,
                   help="plain RPN-mode detection and features over the "
                        "*.jpg files of a folder, one row a file keyed by "
                        "its stem, in sorted order")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without --checkpoint")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel processes, one a card (the launch "
                        "needs a world of this many; parallel/mesh.py): each "
                        "chunk's copies are split over them and rank 0 "
                        "writes the TSV")
    p.add_argument("--shard_by_process", action="store_true",
                   help="under a multi-process launch (parallel/"
                        "distributed.py) each process extracts its own "
                        "--cur_step slice into <output>.shard<i>.tsv")
    return add_detector_config_args(p)


# the reference's dataset class (DATASETS.TEST in its cmds/ scripts) → the
# task; VQAColorDataset shares the GQA color-marking pipeline
# (vqadataset.py:63-140)
_DATASET_CLASS_TO_TASK = {
    "RefCoCoDataset": "refcoco", "GQAColorDataset": "gqa",
    "VQAColorDataset": "gqa", "VCRColorDataset": "vcr", "VGDataset": "vg",
    "ImgDataset": "plain",
}


def apply_ref_to_extract_args(args, ref):
    """Map a resolved reference run config onto the extraction flags that
    were not set: DATASETS.TEST → --task, DATA_DIR (a task-yaml path in
    every cmds/ script) → --yaml, OUTPUT_DIR → the reference's
    ``<OUTPUT_DIR>/inference/<DATA_DIR stem>/predictions.tsv``
    (``tools/test_refcoco_net.py:38-44``), and the CPT data keys of the
    opts (defaults.py:535-542, e.g. ``N_SHOT $NSHOT RAND_SEED $SEED COLOR_D
    $4`` in cmds/vcr/vcr_train.sh) → their flags. → ``args``."""
    if args.task is None and ref.datasets_test:
        cls = ref.datasets_test[0]
        if cls not in _DATASET_CLASS_TO_TASK:
            raise SystemExit(
                f"DATASETS.TEST class {cls!r} has no extraction task "
                f"mapping (known: {sorted(_DATASET_CLASS_TO_TASK)}); "
                "pass --task explicitly")
        args.task = _DATASET_CLASS_TO_TASK[cls]
    if args.yaml is None and str(ref.data_dir).endswith((".yaml", ".yml")):
        args.yaml = ref.data_dir
    if args.output is None and ref.output_dir:
        stem = os.path.splitext(os.path.basename(ref.data_dir or "out"))[0]
        args.output = os.path.join(ref.output_dir, "inference", stem,
                                   "predictions.tsv")
    raw = getattr(ref, "raw", None) or {}
    for yk, attr in (("N_SHOT", "n_shot"), ("RAND_SEED", "rand_seed"),
                     ("TOTAL_STEP", "total_step"),
                     ("CUR_STEP", "cur_step"), ("COLOR_D", "color_d")):
        if getattr(args, attr) is None and raw.get(yk) is not None:
            setattr(args, attr, int(raw[yk]))
    if args.color_name is None and raw.get("COLOR_NAME") is not None:
        args.color_name = str(raw["COLOR_NAME"])
    if args.color_rgb is None and raw.get("COLOR_RGB") is not None:
        args.color_rgb = str(raw["COLOR_RGB"])
    return args


def shard(items, args):
    """This ``--cur_step``'s slice of ``--total_step`` (the reference's
    resumable shard loop, ``refcocodataset.py:186-196``)."""
    if args.total_step is None or args.cur_step is None:
        return items
    period = len(items) // args.total_step
    if args.cur_step == args.total_step - 1:
        return items[period * args.cur_step:]
    return items[period * args.cur_step: period * (args.cur_step + 1)]


def shard_and_sample(anns, args):
    """The shard, then the ``--n_shot`` sample under ``--rand_seed``
    (``refcocodataset.py:199-206``)."""
    anns = shard(anns, args)
    if args.n_shot is not None:
        rng = random.Random()
        rng.seed(args.rand_seed)
        anns = list(anns)
        rng.shuffle(anns)
        anns = anns[: args.n_shot]
    return anns


def apply_yaml(args) -> None:
    """Fill ``--ann_file``, ``--det_file``, ``--image_root``, ``--to_mark``
    and ``--vocab_file`` that are not set from the ``--yaml`` descriptor;
    a path is taken as it is where that file exists, else under the
    descriptor's ``ann_root`` (default its directory), the reference's
    ``find_file_path_in_yaml`` rule (load_files.py:67-76)."""
    import yaml

    with open(args.yaml) as f:
        desc = yaml.safe_load(f) or {}
    root = desc.get("ann_root", os.path.dirname(args.yaml))

    def resolve(p):
        return p if os.path.isfile(str(p)) else os.path.join(root, p)

    if args.vocab_file is None and "vocab" in desc:
        args.vocab_file = resolve(desc["vocab"])
    for key, attr in (("ann", "ann_file"), ("det", "det_file"),
                      ("image_root", "image_root"), ("to_mark", "to_mark")):
        if key in desc and getattr(args, attr) is None:
            setattr(args, attr, desc[key] if key == "image_root"
                    else resolve(desc[key]))


def load_labelmap(path: str) -> dict:
    """{label id: class name} from a labelmap json (the VG-SGG-dicts
    layout's ``idx_to_label``, or a flat map)."""
    with open(path) as f:
        lm = json.load(f)
    return {int(k): v for k, v in lm.get("idx_to_label", lm).items()}


def load_image(path, pad_h, pad_w, resize_min=None, resize_max=None):
    """RGB array, optionally resized by the min/max-size rule, clipped to
    the largest canvas → (array, (h, w)). Needs Pillow."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    if resize_min:
        scale = resize_min / min(h, w)
        if resize_max and scale * max(h, w) > resize_max:
            scale = resize_max / max(h, w)
        w, h = int(round(w * scale)), int(round(h * scale))
        img = img.resize((w, h), Image.BILINEAR)
    arr = np.asarray(img)[:pad_h, :pad_w]
    return arr, arr.shape[:2]


def load_task_image(args, cfg, path: str, orig_h=None):
    """An annotation's image under ``--image_root``, resized by the
    min/max-size rule with ``--resize`` → (array, (h, w), the scale of its
    boxes: the resized height over ``orig_h``, 1.0 without both)."""
    img, hw = load_image(
        os.path.join(args.image_root, path), cfg.input.pad_h, cfg.input.pad_w,
        resize_min=cfg.input.min_size_test if args.resize else None,
        resize_max=cfg.input.max_size_test if args.resize else None)
    return img, hw, hw[0] / float(orig_h) if args.resize and orig_h else 1.0


def paint_color(args):
    """The paint color: the production red, or the --color_* override."""
    name, rgba = REFCOCO_COLORS[0]
    if not (args.color_name or args.color_rgb or args.color_d is not None):
        return name, rgba
    rgb = rgba[:3]
    if args.color_rgb:
        rgb = tuple(int(v) for v in args.color_rgb.split("-"))
        if len(rgb) != 3:
            raise SystemExit(f"--color_rgb expects 'R-G-B', got "
                             f"{args.color_rgb!r}")
    alpha = args.color_d if args.color_d is not None else rgba[3]
    return args.color_name or name, rgb + (alpha,)


def detector_config(args, ref=None):
    """The reference yaml's detector (``ref.detector``), else the tiny
    config or VinVL X152-C4, with ``--precision``, ``--nms_filter`` and
    ``--ignore_box_regression`` applied."""
    if ref is not None:
        cfg = ref.detector
    else:
        cfg = tiny_detector_config() if args.tiny else VINVL_X152C4
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, precision=args.precision))
    rh = cfg.roi_heads
    if args.nms_filter is not None:
        rh = dataclasses.replace(rh, nms_filter=args.nms_filter)
    if args.ignore_box_regression:
        rh = dataclasses.replace(rh, ignore_box_regression=True)
    return dataclasses.replace(cfg, roi_heads=rh)


def build_detector(cfg, args) -> AttrRCNN:
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.checkpoint:
        state = dconv.load_vinvl_checkpoint(args.checkpoint, cfg)
        print(f"loaded {args.checkpoint}")
    else:
        print("WARNING: random detector weights (no --checkpoint)")
        state = dconv.state_from_reference(
            dconv.random_vinvl_state_dict(cfg, seed=args.seed), cfg)
    with torch.device(args.device):
        model = AttrRCNN(cfg, dtype).eval()
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing
               if not k.startswith(("attr_extractor.", "attr_predictor."))]
    if missing or unexpected:
        raise RuntimeError(f"detector state: missing {missing}, unexpected "
                           f"{unexpected}")
    return model


def scale_mask(mask, sc):
    """--resize scaling of a decoded binary mask (nearest, so it keeps hard
    edges as the resized paint rects do). Needs Pillow where sc ≠ 1."""
    if sc == 1.0:
        return mask
    from PIL import Image

    h, w = mask.shape
    out = Image.fromarray(mask.astype(np.uint8)).resize(
        (int(round(w * sc)), int(round(h * sc))), Image.NEAREST)
    return np.asarray(out)


def tasks(args, cfg, color, det_dic: dict):
    """The tasks to extract: ``--synthetic`` RefCOCO queries (the JAX tool's
    fixture: per-query seeds, three fixed boxes) or the annotations' under
    ``--task``, whose dets ``det_dic`` holds (``--det_file``)."""
    if args.synthetic is not None:
        for q in shard(list(range(args.synthetic)), args):
            rq = np.random.RandomState(1000 + q)
            img = rq.randint(0, 256, (cfg.input.pad_h, cfg.input.pad_w, 3)
                             ).astype(np.uint8)
            dets = np.array([[4, 4, 60, 60], [70, 10, 130, 80],
                             [20, 90, 90, 160]], np.float32)
            yield refcoco_task(f"syn{q}", img, (cfg.input.pad_h, cfg.input.pad_w),
                               dets, f"the red thing {q}")
        return
    if args.task == "vg" and args.ann_file.endswith((".pk", ".pkl", ".pickle")):
        yield from vg_pickle_tasks(args, cfg)
        return
    with open(args.ann_file) as f:
        anns = shard_and_sample(json.load(f), args)
    if args.task == "vcr":
        yield from vcr_tasks(args, cfg, anns, det_dic)
    elif args.task == "gqa":
        yield from gqa_tasks(args, cfg, anns, det_dic)
    elif args.task in ("vg", "plain"):
        yield from vg_or_plain_tasks(args, cfg, anns, det_dic)
    else:
        yield from refcoco_tasks(args, cfg, anns, det_dic, color)


def refcoco_tasks(args, cfg, anns, det_dic: dict, color):
    """One RefCOCO task per referring expression; an image whose dets carry
    ``"rle"`` masks gives the SEG task (:func:`refcoco_mask_task`)."""
    from cpt_tpu_torch.utils.rle import decode

    for ann in anns:
        name = ann["file_name"]
        rawdets = det_dic[str(int(name.replace(".jpg", "").split("_")[-1]))]
        dets = xywh_to_xyxy([d["box"] for d in rawdets])
        img, hw, sc = load_task_image(args, cfg, name, ann.get("height"))
        if rawdets and isinstance(rawdets[0], dict) and "rle" in rawdets[0]:
            masks = np.stack([scale_mask(decode(d["rle"]), sc) for d in rawdets])
            yield refcoco_mask_task(str(ann["id"]), img, hw, dets * sc, masks,
                                    ann["caption"], color=color)
            continue
        yield refcoco_task(str(ann["id"]), img, hw, dets * sc, ann["caption"],
                           color=color)


def gqa_tasks(args, cfg, anns, det_dic: dict):
    """One GQA task per question (VQA's annotations too, which spell the
    question id "qid", vqadataset.py:63-140): the entity of ``--to_mark``, or
    of :func:`stage1_tasks.parse_gqa_marks` on the question and the dets'
    class names, painted; a question with no mark is skipped."""
    from cpt_tpu_torch.data.stage1_tasks import gqa_mark_task, parse_gqa_marks

    to_mark = {}
    if args.to_mark:
        with open(args.to_mark) as f:
            to_mark = json.load(f)
    for ann in anns:
        key = str(ann.get("img_id", ann.get("img_path")))
        q_id = ann.get("q_id", ann.get("qid"))
        dets = np.asarray([d[1] if isinstance(d, list) else d["box"]
                           for d in det_dic[key]], np.float32)
        img, hw, sc = load_task_image(args, cfg, ann["img_path"], ann.get("h"))
        marks = to_mark.get(str(q_id))
        if marks is None:
            names = [d[0] if isinstance(d, list) else d["class"]
                     for d in det_dic[key]]
            marks = parse_gqa_marks(ann["question"], dets.tolist(), names)
        if not marks:
            continue
        yield gqa_mark_task(q_id, img, hw, dets * sc, marks)


def vg_or_plain_tasks(args, cfg, anns, det_dic: dict):
    """``--task vg``: one pair task per annotation (its subject and object
    indices, names and relation); ``--task plain``: one unpainted task per
    image. Both with xywh dets."""
    from cpt_tpu_torch.data.stage1_tasks import plain_task, vg_pair_task

    for ann in anns:
        if args.task == "vg":
            dets = xywh_to_xyxy([d["box"] for d in det_dic[ann["img"]]])
            img, hw, sc = load_task_image(args, cfg, ann["img_path"],
                                          ann.get("h"))
            yield vg_pair_task(ann["img"], img, hw, dets * sc, ann["subj_idx"],
                               ann["obj_idx"], ann["subj_name"],
                               ann["obj_name"], ann["rel"])
            continue
        key = str(ann.get("img_id", ann.get("img_path")))
        dets = xywh_to_xyxy([d["box"] for d in det_dic[key]])
        img, hw, sc = load_task_image(args, cfg, ann["img_path"], ann.get("h"))
        yield plain_task(key, img, hw, dets * sc)


def vg_pickle_tasks(args, cfg):
    """The reference's own VG layout (vgdataset.py:25-53): a pickle of
    {img_path, width, height, boxes xyxy [N, 4], labels [N], relations
    [R, 3]} records and an idx_to_label ``--vocab_file``, expanded to one
    task per overlapping pair (subject < object; inclusive +1 IoU > 0), as
    ``process_vg_data`` does (vgdataset.py:99-115)."""
    import pickle

    from cpt_tpu_torch.data.stage1_tasks import vg_pair_task
    from cpt_tpu_torch.structures.boxes import box_iou_np

    if args.vocab_file is None:
        raise SystemExit("--task vg with pickle annotations needs --vocab_file "
                         "(or a task --yaml with a 'vocab' entry)")
    with open(args.ann_file, "rb") as f:
        records = shard_and_sample(pickle.load(f), args)
    with open(args.vocab_file) as f:
        names = json.load(f)["idx_to_label"]
    for d in records:
        boxes = np.asarray(d["boxes"], np.float32)
        iou = box_iou_np(boxes, boxes)
        np.fill_diagonal(iou, -1.0)
        labels = np.asarray(d["labels"]).astype(np.int64)
        img, hw, sc = load_task_image(args, cfg, d["img_path"], d.get("height"))
        for s, o in zip(*np.nonzero(iou > 0)):
            if s >= o:
                continue
            yield vg_pair_task(d["img_path"], img, hw, boxes * sc, int(s),
                               int(o), names[str(int(labels[s]))],
                               names[str(int(labels[o]))], None)


def xywh_to_xyxy(dets) -> np.ndarray:
    """[[x, y, w, h], ...] → inclusive xyxy boxes."""
    dets = np.asarray(dets, np.float32)
    dets[:, 2] = dets[:, 0] + dets[:, 2] - 1
    dets[:, 3] = dets[:, 1] + dets[:, 3] - 1
    return dets


def _scale_poly(poly, sc):
    # the multi-part test of rasterize_polygon: an empty first part
    # ([[], [...]]) still marks a list of parts, not a point list
    if len(poly) and (not len(poly[0]) or hasattr(poly[0][0], "__len__")):
        return [_scale_poly(part, sc) for part in poly]
    return [[float(x) * sc, float(y) * sc] for x, y, *_ in poly]


def scale_polys(polys, sc):
    """--resize scales the canvas and dets; the segm polygons follow, or
    the painted masks land at original-size coordinates."""
    if sc == 1.0:
        return polys
    return {k: _scale_poly(p, sc) for k, p in polys.items()}


def vcr_tasks(args, cfg, anns, det_dic: dict):
    """The VCR tasks of the annotations, in either layout of the JAX tool:
    the reference's own (``annot_id``: mixed-token sentences, ``--to_mark``
    {img_id: {boxes, names}}, [name, xyxy] dets and a per-image
    ``<img>.json`` of segms, vcrdataset.py:139-172), or ``img_key`` records
    that carry their entity groups, polygons and names, with xywh dets.
    ``--color_d`` palette colors are painted (6 by default, at most the
    palette's size: the reference fails past it, vcrdataset.py:231)."""
    from cpt_tpu_torch.data.stage1_tasks import vcr_color_task, vcr_entity_groups

    color_d = min(args.color_d if args.color_d is not None else 6,
                  len(CROSS_TASK_COLORS))
    to_mark = json.load(open(args.to_mark)) if args.to_mark else {}
    for ann in anns:
        if "annot_id" in ann:
            img_id = ann["img_id"]
            names = dict(enumerate(to_mark[img_id]["names"]))
            with open(os.path.join(args.image_root, ann["img_path"].replace(
                    ".jpg", ".json"))) as f:
                polys = dict(enumerate(json.load(f)["segms"]))
            vis, txt = vcr_entity_groups(ann)
            dets = np.asarray([d[1] for d in det_dic[img_id]], np.float32)
            img, hw, sc = load_task_image(args, cfg, ann["img_path"],
                                          ann.get("h"))
            yield vcr_color_task(ann["annot_id"], img, hw, dets * sc, vis,
                                 scale_polys(polys, sc), names,
                                 color_d=color_d, txt_entity_ids=txt)
            continue
        dets = xywh_to_xyxy([d["box"] for d in det_dic[ann["img_key"]]])
        img, hw, sc = load_task_image(args, cfg, ann["img_path"], ann.get("h"))
        polys = {int(k): v for k, v in ann["entity_polygons"].items()}
        names = {int(k): v for k, v in ann["entity_names"].items()}
        yield vcr_color_task(ann["img_key"], img, hw, dets * sc,
                             ann["entity_ids"], scale_polys(polys, sc), names,
                             color_d=color_d)


def image_dir_rows(files, args, cfg, model, labelmap):
    """Plain RPN-mode detection and features over image ``files`` (the
    reference's ``ImgDataset`` pass, refcocodataset.py:21-64, through the
    generic ``engine/inference.py`` and its NMS filters): one (stem, row) a
    file, the row holding each detection's rect, bbox_id, class, conf and
    base64 2054-d feature."""
    h0, w0 = cfg.input.pad_h, cfg.input.pad_w
    stride = cfg.rpn.anchor_stride
    device = next(model.parameters()).device
    anchors = torch.from_numpy(grid_anchors(cfg.rpn, h0 // stride,
                                            w0 // stride)).to(device)
    fn = make_detect_fn(model, cfg, with_attributes=False)
    for path in files:
        img, hw = load_image(
            path, h0, w0,
            resize_min=cfg.input.min_size_test if args.resize else None,
            resize_max=cfg.input.max_size_test if args.resize else None)
        canvas = np.zeros((h0, w0, 3), np.uint8)
        canvas[: hw[0], : hw[1]] = img
        feats, boxes, labels, scores, valid, _ = fn(
            torch.from_numpy(canvas).to(device), anchors, hw)
        n = int(valid.sum())
        feats, boxes, labels, scores = (t[:n].cpu().numpy() for t in
                                        (feats, boxes, labels, scores))
        objects = [{"rect": [float(v) for v in boxes[i]], "bbox_id": i,
                    "class": (labelmap or {}).get(int(labels[i]),
                                                  str(int(labels[i]))),
                    "conf": float(scores[i]),
                    "feature": encode_feature(feats[i])} for i in range(n)]
        key = os.path.splitext(os.path.basename(path))[0]
        yield key, json.dumps({"objects": objects, "relations": None})


def main(argv=None) -> dict:
    """Extract, write ``--output``; → {"output", "copies", "seconds",
    "copies_per_s" (e2e), "windowed_mode", and with ``--windowed``
    "route_copies" (copies per window of the ladder and "full")}; with
    ``--image_dir`` {"output", "images", "seconds"}; {} when the output
    exists."""
    distributed.initialize_from_env()
    parser = build_args()
    ref = apply_reference_config(parser, argv)
    args = parser.parse_args(argv)
    if args.dp > 1 and args.shard_by_process:
        parser.error("--dp splits each chunk over the processes; "
                     "--shard_by_process gives each its own queries: one of them")
    if ref is not None:
        args = apply_ref_to_extract_args(args, ref)
    if args.task is None:
        args.task = "refcoco"
    if args.output is None:
        parser.error("--output is required (or --config_file with "
                     "OUTPUT_DIR)")
    if args.yaml and args.synthetic is None:
        apply_yaml(args)
    if args.shard_by_process:
        # one contiguous slice and one output a process; .tsv stays the
        # last extension (the .lineidx sidecar's path is derived from it)
        args.total_step = distributed.process_count()
        args.cur_step = distributed.process_index()
        base, ext = os.path.splitext(args.output)
        args.output = f"{base}.shard{args.cur_step}{ext}"
    mesh = dp_mesh(args, args.device)
    if os.path.dirname(args.output):
        os.makedirs(os.path.dirname(args.output), exist_ok=True)
    if os.path.exists(args.output) and not args.overwrite:
        print(f"{args.output} exists; skipping (use --overwrite to redo)")
        return {}
    cfg = detector_config(args, ref)
    model = build_detector(cfg, args)
    labelmap = load_labelmap(args.labelmap) if args.labelmap else None
    if args.image_dir:
        if mesh is not None and not distributed.is_main_process():
            return {}   # one card writes the plain detection, as in JAX
        import glob

        files = shard_and_sample(
            sorted(glob.glob(os.path.join(args.image_dir, "*.jpg"))), args)
        t0 = time.time()
        tsv_writer(image_dir_rows(files, args, cfg, model, labelmap),
                   args.output)
        dt = time.time() - t0
        print(f"wrote {args.output}: {len(files)} images (RPN mode) in "
              f"{dt:.1f}s")
        return {"output": args.output, "images": len(files), "seconds": dt}
    windows = [tuple(int(v) for v in w.split("x"))
               for w in args.windows.split(",") if w]
    det_dic = {}
    if args.det_file and args.synthetic is None:
        with open(args.det_file) as f:
            det_dic = json.load(f)
    extractor = Extractor(model, cfg,
                          copies_per_chunk=args.copies_per_chunk,
                          windowed=args.windowed, window=windows,
                          allow_approximate=args.allow_approximate,
                          labelmap=labelmap, mesh=mesh)
    payload = {"refcoco": refcoco_payload, "gqa": gqa_payload,
               "vcr": vcr_payload, "vg": vg_payload,
               "plain": plain_payload}[args.task]
    t0 = time.time()
    extractor.run(tasks(args, cfg, paint_color(args), det_dic), args.output,
                  payload_fn=payload)
    dt = time.time() - t0
    routes = (f"; {extractor.windowed_mode} windowed, copies by window "
              f"{extractor.route_copies}" if extractor.windowed else "")
    print(f"wrote {args.output}: {extractor.n_copies} copies in {dt:.1f}s "
          f"({extractor.n_copies / max(extractor.infer_seconds, 1e-9):.2f} "
          f"copies/s device, {extractor.n_copies / dt:.2f} copies/s e2e)"
          f"{routes}")
    out = {"output": args.output, "copies": extractor.n_copies,
           "seconds": dt, "copies_per_s": extractor.n_copies / dt,
           "windowed_mode": extractor.windowed_mode}
    if extractor.windowed:
        out["route_copies"] = dict(extractor.route_copies)
    return out


if __name__ == "__main__":
    main()
