"""Detector evaluation tool: RPN-mode detection over a split → VOC mAP (port
of ``cpt_tpu/tools/test_detector.py``).

Mirrors the reference's ``prompt_feat/tools/test_sg_net.py`` (detection eval
on VG, ``vg_eval.py``): runs ``AttrRCNN`` in RPN mode (the RPN's NMS and the
``NMS_FILTER`` post-processor on kernel K5, the box head's pooling on K2,
stage 5 on K1) over the images of a split, evaluates VOC-style mAP against
the ground-truth boxes (``--coco_eval`` adds COCO AP / AP50 / AP75), and
applies the ``TEST.EXPECTED_RESULTS`` σ-tolerance check when given.
``--attr_eval`` runs the attribute head on the ground-truth boxes instead
(force-boxes mode) and reports attribute mAP.

The samples come from a VG/od-TSV dataset yaml (``--tsv``, the reference's
``vg_tsv.py`` format; ``tools/convert_dataset.py`` makes one from COCO or
VOC), from a json list ``[{img, width, height, boxes [[x, y, w, h], ...],
labels [...]}]`` with ``--image_root``, or ``--synthetic N`` random images:

  python -m cpt_tpu_torch.tools.test_detector --tsv vg_test.yaml \\
      --checkpoint vinvl_vg_x152c4.pth --coco_eval \\
      [--expected_results '[["mAP", 0.35, 0.01]]']
  python -m cpt_tpu_torch.tools.test_detector \\
      --config_file sgg_configs/vgattr/vinvl_x152c4.yaml --tsv vg_test.yaml \\
      --opts MODEL.ROI_HEADS.NMS_FILTER 2
  python -m cpt_tpu_torch.tools.test_detector --tiny --synthetic 2 \\
      --device cpu --dtype float32

``--config_file`` / ``--opts`` take the reference's own yacs yaml and its
overrides (``tools/_common.apply_reference_config``): the detector config
comes from the yaml, ``TEST.EXPECTED_RESULTS`` gives
``--expected_results`` and ``MODEL.WEIGHT`` ``--checkpoint``; explicit flags
win. Without ``--checkpoint`` the weights are random, drawn from ``--seed``
in the reference layout.

``--bbox_aug`` pools each image's detections over its horizontal flip and
the ``--bbox_aug_scales`` rescales (``utils/image_ops``, no Pillow) and
merges them with one NMS on kernel K5 (``engine/bbox_aug.py``). ``--sg`` (a
relation yaml sets it) also evaluates scene graphs over the ``--tsv``'s
relations: a ``SceneParser`` (``--rel_algorithm``, ``--max_rel_dets``) on
this detector, its relation head at its initialization drawn from
``--seed`` (the JAX tool loads no scene-parser checkpoint here either),
both recall protocols as ``sg_<protocol>_<k>`` results
(``engine/sg_infer.py``):

  python -m cpt_tpu_torch.tools.test_detector --tsv vg_rel.yaml --sg \
      --rel_algorithm sg_reldn --max_rel_dets 16 [--checkpoint det.pth]
  python -m cpt_tpu_torch.tools.test_detector --tsv vg_test.yaml \
      --bbox_aug [--bbox_aug_scales 0.75,1.25]
"""
from __future__ import annotations

import argparse
import json
import pickle
import time

import numpy as np
import torch

from cpt_tpu_torch.engine.detection_eval import (check_expected_results,
                                                 eval_detection_attributes,
                                                 eval_detection_coco,
                                                 eval_detection_voc)
from cpt_tpu_torch.engine.extract import make_detect_fn
from cpt_tpu_torch.engine.bbox_aug import im_detect_bbox_aug
from cpt_tpu_torch.engine.sg_infer import evaluate_scene_graphs
from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                  tiny_detector_config)
from cpt_tpu_torch.models.detector.scene_parser import ALGORITHMS, SceneParser
from cpt_tpu_torch.ops.render import to_detector_input
from cpt_tpu_torch.parallel import distributed
from cpt_tpu_torch.tools._common import (add_detector_config_args,
                                         apply_reference_config)
from cpt_tpu_torch.tools.demo import canvas_anchors, detector_canvas
from cpt_tpu_torch.tools.extract_features import build_detector, load_image

def build_args():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ann_file", default=None)
    p.add_argument("--tsv", default=None,
                   help="od/vg-TSV dataset yaml (reference vg_tsv.py "
                        "format: img/label/hw TSVs + labelmap jsondict)")
    p.add_argument("--image_root", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="vinvl_vg_x152c4.pth (reference layout) or a "
                        "Detectron .pkl; random weights from --seed if "
                        "omitted")
    p.add_argument("--output", default=None,
                   help="pickle of the results and per-image predictions "
                        "(json of the results with --attr_eval)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--synthetic", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without --checkpoint")
    p.add_argument("--expected_results", default=None,
                   help='json [["mAP", 0.35, 0.01], ...]')
    p.add_argument("--attr_eval", action="store_true",
                   help="force-box attribute mAP over the TSV gt boxes "
                        "(the reference test_sg_net.py:115 attribute "
                        "evaluation: vg_eval eval_attributes=True)")
    p.add_argument("--voc_box_convention", action="store_true",
                   help="use the plain-VOC evaluator's double-inclusive "
                        "box convention (reference voc_eval.py) instead "
                        "of the VG-TSV protocol's single +1 "
                        "(vg_eval.py, the default)")
    p.add_argument("--coco_eval", action="store_true",
                   help="also report COCO-protocol AP/AP50/AP75")
    p.add_argument("--bbox_aug", action="store_true",
                   help="test-time bbox augmentation (reference "
                        "TEST.BBOX_AUG / engine/bbox_aug.py): pool "
                        "detections over hflip + --bbox_aug_scales and "
                        "merge with NMS")
    p.add_argument("--bbox_aug_scales", default="",
                   help="comma-separated rescale factors, e.g. 0.75,1.25")
    p.add_argument("--sg", action="store_true",
                   help="scene-graph relation eval over a VG-TSV (--tsv "
                        "with relations): SceneParser inference + both SG "
                        "recall protocols (reference test_sg_net.py + "
                        "evaluation/sg)")
    p.add_argument("--rel_algorithm", default="sg_reldn", choices=ALGORITHMS)
    p.add_argument("--max_rel_dets", type=int, default=16)
    return add_detector_config_args(p)


def samples(args, cfg):
    """(key, canvas, (h, w), gt {"boxes" inclusive xyxy, "labels"}) of each
    image of ``--tsv``, ``--synthetic`` or ``--ann_file``, on the square
    ``pad_h`` canvas (``demo.detector_canvas``)."""
    h = w = cfg.input.pad_h
    if args.tsv:
        from cpt_tpu_torch.data.vg_tsv import DetectionTSVDataset

        ds = DetectionTSVDataset(args.tsv, attribute_on=False)
        for i in range(len(ds)):
            img, target, _ = ds[i]
            canvas, hw = detector_canvas(img, cfg)
            yield ds.get_img_key(i), canvas, hw, {
                "boxes": target["boxes"], "labels": target["labels"]}
        return
    if args.synthetic is not None:
        rng = np.random.RandomState(0)
        for i in range(args.synthetic):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            gt = {"boxes": np.array([[8, 8, 40, 40]], np.float32),
                  "labels": np.array([1])}
            yield f"syn{i}", img, (h, w), gt
        return
    with open(args.ann_file) as f:
        anns = json.load(f)
    for ann in anns:
        canvas, hw = detector_canvas(
            load_image(f"{args.image_root}/{ann['img']}", h, w)[0], cfg)
        boxes = np.asarray(ann["boxes"], np.float32)
        boxes[:, 2] = boxes[:, 0] + boxes[:, 2] - 1
        boxes[:, 3] = boxes[:, 1] + boxes[:, 3] - 1
        yield ann["img"], canvas, hw, {
            "boxes": boxes, "labels": np.asarray(ann["labels"])}


@torch.inference_mode()
def attr_eval(args, model, cfg) -> dict:
    """Force-box attribute evaluation (reference ``test_sg_net.py:115`` →
    ``vg_eval.py`` ``eval_attributes=True``): the attribute head on the gt
    boxes of ``--tsv`` (``AttrRCNN.forward_batch_force``, pooling on K2,
    stage 5 on K1), post-processed on the host as the reference's
    AttributePostProcessor does (softmax with the background zeroed,
    ``postprocess_threshold``, the top ``max_num_attr_per_obj`` slots),
    then attribute mAP. → the results dict."""
    from cpt_tpu_torch.data.vg_tsv import DetectionTSVDataset

    ds = DetectionTSVDataset(args.tsv, attribute_on=True)
    ac = cfg.attributes
    k = min(ac.max_num_attr_per_obj, ac.num_attributes - 1)
    device = next(model.parameters()).device
    preds, gts = [], []
    t0 = time.time()
    for i in range(len(ds)):
        img, target, _ = ds[i]
        canvas, hw = detector_canvas(img, cfg)
        gt_boxes = np.asarray(target["boxes"], np.float32)
        n = min(len(gt_boxes), cfg.max_force_boxes)
        logits = np.zeros((0, ac.num_attributes), np.float32)
        if n:
            x = to_detector_input(torch.from_numpy(canvas).to(device)[None],
                                  cfg.input.pixel_mean, dtype=model.dtype)
            out = model.forward_batch_force(
                x, hw, torch.from_numpy(gt_boxes[:n]).to(device),
                torch.ones(n, dtype=torch.bool, device=device),
                with_attributes=True)
            logits = out["attr_logits"][0].cpu().numpy()
        prob = np.exp(logits - logits.max(-1, keepdims=True))
        prob /= prob.sum(-1, keepdims=True)
        prob[:, 0] = 0.0                       # __no_attribute__
        prob[prob <= ac.postprocess_threshold] = 0.0
        order = np.argsort(-prob, axis=-1)[:, :k]
        preds.append({"boxes": gt_boxes[:n],
                      "attr_labels": order.astype(np.int64),
                      "attr_scores": np.take_along_axis(prob, order, axis=-1)})
        gts.append({"boxes": gt_boxes[:n],
                    "attributes": np.asarray(target.get(
                        "attributes", np.zeros((n, 1), np.int64)))[:n]})
    print(f"attr-eval: {len(preds)} images in {time.time() - t0:.1f}s")
    results = eval_detection_attributes(preds, gts, ac.num_attributes)
    print(f"attr mAP: {results['attr_mAP']:.4f} "
          f"(weighted {results['attr_weighted_mAP']:.4f})")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({k2: float(v) for k2, v in results.items()}, f)
    return results


def build_scene_parser(cfg, num_rel_classes: int, args, detector) -> SceneParser:
    """A ``SceneParser`` on ``detector`` (its weights reused, on its device
    and in its dtype), the relation head drawn from ``--seed``."""
    device = next(detector.parameters()).device
    with torch.device(device):
        parser = SceneParser(cfg, num_rel_classes, args.max_rel_dets,
                             args.rel_algorithm, detector.dtype,
                             detector=detector)
    parser.init_relation(torch.Generator().manual_seed(args.seed))
    return parser.eval()


def scene_graph_eval(args, cfg, detector, anchors) -> dict:
    """``--sg``: the SceneParser over the ``--tsv``'s images with relations
    → {``sg_<protocol>_<k>``: recall}."""
    if not args.tsv:
        raise SystemExit("test_detector: --sg requires --tsv (a VG-TSV with "
                         "relations)")
    from cpt_tpu_torch.data.vg_tsv import VGTSVDataset

    ds = VGTSVDataset(args.tsv, attribute_on=False, relation_on=True)
    parser = build_scene_parser(cfg, len(ds.relation_to_ind), args, detector)
    h = w = cfg.input.pad_h
    sg = evaluate_scene_graphs(parser, ds, anchors, (h, w))
    for proto, metric in sg.items():
        print(f"{proto}: " + " ".join(f"{k}={v:.4f}"
                                      for k, v in sorted(metric.items())))
    return {f"sg_{p}_{k}": v for p, m in sg.items() for k, v in m.items()}


def main(argv=None):
    """Detect and evaluate → (results, ok: every ``--expected_results``
    entry within its tolerance); with ``--attr_eval`` the attribute
    results alone, as the JAX tool returns them."""
    distributed.initialize_from_env()
    parser = build_args()
    ref = apply_reference_config(parser, argv)
    args = parser.parse_args(argv)
    if ref is not None:
        cfg = ref.detector
    else:
        cfg = tiny_detector_config() if args.tiny else VINVL_X152C4
    model = build_detector(cfg, args)
    if args.attr_eval:
        if args.coco_eval or args.expected_results or args.bbox_aug:
            raise SystemExit(
                "--attr_eval is a standalone force-box attribute "
                "evaluation and cannot combine with --coco_eval/"
                "--expected_results/--bbox_aug")
        return attr_eval(args, model, cfg)

    device = next(model.parameters()).device
    anchors = canvas_anchors(cfg, device)
    fn = make_detect_fn(model, cfg, with_attributes=False)
    aug_scales = [float(s) for s in args.bbox_aug_scales.split(",") if s]

    def detect_one(img, hw):
        _, boxes, labels, scores, valid, _ = fn(
            torch.from_numpy(np.ascontiguousarray(img)).to(device), anchors, hw)
        return {"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
                "labels": labels.cpu().numpy(), "valid": valid.cpu().numpy()}

    preds, gts = [], []
    t0 = time.time()
    for _key, img, hw, gt in samples(args, cfg):
        if args.bbox_aug:
            out = im_detect_bbox_aug(detect_one, img, hw, scales=aug_scales,
                                     device=device)
        else:
            out = detect_one(img, hw)
        v = out["valid"]
        preds.append({k: out[k][v] for k in ("boxes", "labels", "scores")})
        gts.append(gt)
    dt = time.time() - t0
    n = len(preds)
    print(f"detected {n} images in {dt:.1f}s ({n / max(dt, 1e-9):.2f} img/s)")

    results = eval_detection_voc(preds, gts, cfg.roi_heads.num_classes,
                                 double_inclusive=args.voc_box_convention)
    print(f"mAP: {results['mAP']:.4f}")
    if args.coco_eval:
        coco = eval_detection_coco(preds, gts)
        results.update({f"coco_{k}": v for k, v in coco.items()})
        print(f"COCO AP: {coco['AP']:.4f}  AP50: {coco['AP50']:.4f}  "
              f"AP75: {coco['AP75']:.4f}")
    if args.sg:
        results.update(scene_graph_eval(args, cfg, model, anchors))
    ok = True
    if args.expected_results:
        expected = [tuple(e) for e in json.loads(args.expected_results)]
        ok = check_expected_results(results, expected)
    if args.output:
        with open(args.output, "wb") as f:
            pickle.dump({"results": results, "predictions": preds}, f)
    return results, ok


if __name__ == "__main__":
    main()
