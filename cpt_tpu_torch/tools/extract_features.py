"""Stage-1 extraction tool for RefCOCO and VCR colorful-prompt features
(port of the ``--task refcoco`` and ``--task vcr`` paths of
``cpt_tpu/tools/extract_features.py``).

Loads the VinVL X152-C4 detector, paints colored copies of each image on
the device (RefCOCO: one per candidate box) or on the host (VCR: the
entities' segmentation masks in up to ``--color_d`` palette colors, one
copy), extracts 2054-d region features in force-boxes mode and writes the
interchange ``predictions.tsv``:

  python -m cpt_tpu_torch.tools.extract_features --ann_file refs.json \\
      --det_file dets.json --image_root images/ --output predictions.tsv \\
      [--checkpoint vinvl_vg_x152c4.pth] [--precision int8|int8:<s>]
  python -m cpt_tpu_torch.tools.extract_features --task vcr \\
      --ann_file vcr_val.json --det_file dets.json --to_mark to_mark.json \\
      --image_root vcr1images/ --output predictions.tsv
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
the annotations as the reference's resumable shard loop does,
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
from cpt_tpu_torch.engine.extract import (Extractor, refcoco_payload,
                                          refcoco_task, vcr_payload)
from cpt_tpu_torch.engine.windowed import WINDOW_LADDER
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                  tiny_detector_config)

# flags of the JAX tool this port does not run yet → their ROADMAP.md item
_UNPORTED = {
    "--task gqa, vg or plain": "Queue 1 item 3 (the other CPT tasks)",
    "--yaml": "Queue 1 item 3 (the other CPT tasks)",
    "--config_file/--opts": "Queue 1 item 3 (the other CPT tasks)",
    "--labelmap": "Queue 1 item 3 (the other CPT tasks)",
    "SEG (rle) dets": "Queue 1 item 3 (the other CPT tasks)",
    "--image_dir": "Queue 1 item 5 (the detect path's entry points)",
    "--dp > 1": "Queue 1 item 9 (parallelism)",
    "--shard_by_process": "Queue 1 item 9 (parallelism)",
}


def build_args():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--task", default=None,
                   help="refcoco (the default) or vcr: the coloring scheme "
                        "and the TSV payload layout")
    p.add_argument("--ann_file", default=None)
    p.add_argument("--det_file", default=None)
    p.add_argument("--to_mark", default=None,
                   help="vcr, the reference's annot_id layout: {img_id: "
                        "{boxes, names}} json")
    p.add_argument("--image_root", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="vinvl_vg_x152c4.pth (reference layout, a "
                        "'module.'-wrapped one too) or a Detectron .pkl")
    p.add_argument("--output", required=True, help="predictions.tsv path")
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
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without --checkpoint")
    # the JAX tool's flags that are not ported: each refuses with its item
    p.add_argument("--yaml", default=None)
    p.add_argument("--config_file", default=None)
    p.add_argument("--opts", nargs="*", default=None)
    p.add_argument("--labelmap", default=None)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--shard_by_process", action="store_true")
    return p


def refuse(what: str) -> SystemExit:
    return SystemExit(f"extract_features: {what} is not ported yet "
                      f"(ROADMAP.md {_UNPORTED[what]})")


def check_ported(args) -> None:
    for flag, asked in (("--task gqa, vg or plain",
                         args.task not in (None, "refcoco", "vcr")),
                        ("--yaml", args.yaml),
                        ("--config_file/--opts",
                         args.config_file or args.opts is not None),
                        ("--labelmap", args.labelmap),
                        ("--image_dir", args.image_dir),
                        ("--dp > 1", args.dp > 1),
                        ("--shard_by_process", args.shard_by_process)):
        if asked:
            raise refuse(flag)


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


def detector_config(args):
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


def tasks(args, cfg, color):
    """The tasks to extract: ``--synthetic`` RefCOCO queries (the JAX tool's
    fixture: per-query seeds, three fixed boxes) or the annotations'
    (``--task vcr``: :func:`vcr_tasks`)."""
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
    anns = shard_and_sample(json.load(open(args.ann_file)), args)
    if args.task == "vcr":
        yield from vcr_tasks(args, cfg, anns)
        return
    det_dic = json.load(open(args.det_file))
    for ann in anns:
        name = ann["file_name"]
        rawdets = det_dic[str(int(name.replace(".jpg", "").split("_")[-1]))]
        if rawdets and isinstance(rawdets[0], dict) and "rle" in rawdets[0]:
            raise refuse("SEG (rle) dets")
        dets = xywh_to_xyxy([d["box"] for d in rawdets])
        img, hw, sc = load_task_image(args, cfg, name, ann.get("height"))
        yield refcoco_task(str(ann["id"]), img, hw, dets * sc, ann["caption"],
                           color=color)


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


def vcr_tasks(args, cfg, anns):
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
    det_dic = json.load(open(args.det_file))
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


def main(argv=None) -> dict:
    """Extract, write ``--output``; → {"output", "copies", "seconds",
    "copies_per_s" (e2e), "windowed_mode", and with ``--windowed``
    "route_copies" (copies per window of the ladder and "full")}, or {}
    when the output exists."""
    args = build_args().parse_args(argv)
    check_ported(args)
    if os.path.dirname(args.output):
        os.makedirs(os.path.dirname(args.output), exist_ok=True)
    if os.path.exists(args.output) and not args.overwrite:
        print(f"{args.output} exists; skipping (use --overwrite to redo)")
        return {}
    cfg = detector_config(args)
    windows = [tuple(int(v) for v in w.split("x"))
               for w in args.windows.split(",") if w]
    extractor = Extractor(build_detector(cfg, args), cfg,
                          copies_per_chunk=args.copies_per_chunk,
                          windowed=args.windowed, window=windows,
                          allow_approximate=args.allow_approximate)
    t0 = time.time()
    extractor.run(tasks(args, cfg, paint_color(args)), args.output,
                  payload_fn=vcr_payload if args.task == "vcr" else refcoco_payload)
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
