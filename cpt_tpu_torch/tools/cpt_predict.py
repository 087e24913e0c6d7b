"""One-shot CPT grounding: image + referring expression → predicted box
(port of ``cpt_tpu/tools/cpt_predict.py``).

The candidates are given (``--dets``) or proposed by the detector itself
(``--detect``: VinVL X152-C4 in RPN mode on the padded canvas, the
``NMS_FILTER`` post-processor, then the ``--conf`` filter; ``tools/demo.py``).
Stage 1 paints one colored copy of the image per candidate box and runs
VinVL X152-C4 in force-boxes mode over the copies (``engine/extract.py``),
writing ``predictions.tsv``; stage 2 reads it back and scores color words
at ``[MASK]`` with ``REC_MLM_CPT`` (``engine/scoring.py``) to pick the box.

:class:`Resident` keeps both models on one device, the way a serving
process keeps them; :func:`predict` answers one request from an in-memory
RGB array. ``main()`` wraps it for the command line:

  python -m cpt_tpu_torch.tools.cpt_predict --image photo.jpg \\
      --caption "the dog on the left" --dets '[[10,20,120,200],...]' \\
      --checkpoint vinvl_vg_x152c4.pth --oscar_checkpoint pytorch_model.bin \\
      --vocab vocab.txt --out overlay.png
  (--detect [--conf 0.5] proposes the candidates instead of --dets;
  --windowed extracts on the window ladder of ``engine/windowed.py``.)

Without checkpoints the weights are random, drawn from ``--seed`` in the
reference layouts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, BertConfig
from cpt_tpu_torch.data.refcoco import (RefcocoCPTData, det_json_for_stage2,
                                        iter_eval_batches)
from cpt_tpu_torch.engine.extract import (Extractor, make_detect_fn,
                                          refcoco_task)
from cpt_tpu_torch.engine.scoring import (make_mlm_at_mask_fn,
                                          refcoco_collect_scores,
                                          refcoco_evaluate, run_mlm_batch)
from cpt_tpu_torch.engine.windowed import WINDOW_LADDER
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.models.detector.config import (VINVL_X152C4, DetectorConfig,
                                                  tiny_detector_config)
from cpt_tpu_torch.tools.demo import canvas_anchors, run_detector
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils.tokenization import BertTokenizer, toy_vocab

SCORE_BATCH = 16   # sequences per scoring batch (the JAX tool's batch_size)


def region_feature_dim(det_cfg: DetectorConfig) -> int:
    """Stage-5 pooled width (res2_out × 8) + 6 geometry dims."""
    return det_cfg.backbone.res2_out_channels * 8 + 6


def bert_config(hidden_size: Optional[int] = None,
                num_hidden_layers: Optional[int] = None,
                img_feature_dim: int = 2054,
                attention_impl: str = "auto") -> BertConfig:
    """Oscar-base with the tool's size overrides (narrow widths get
    hidden/16 heads and a 4× FFN, as the JAX tools do) and attention
    backend (``"flash"``: every layer's attention core through kernel K6,
    as ``dataclasses.replace(OSCAR_BASE, attention_impl="flash")`` does in
    the JAX package)."""
    kw = {"img_feature_dim": img_feature_dim, "attention_impl": attention_impl}
    if num_hidden_layers is not None:
        kw["num_hidden_layers"] = num_hidden_layers
    if hidden_size is not None:
        kw["hidden_size"] = hidden_size
        if hidden_size < 768:
            kw["num_attention_heads"] = max(1, hidden_size // 16)
            kw["intermediate_size"] = hidden_size * 4
    return dataclasses.replace(OSCAR_BASE, **kw)


class Resident:
    """Both stages resident on ``device``: the detector behind an
    :class:`Extractor` (force-boxes) and an RPN-mode detect function, and
    ``REC_MLM_CPT``. State dicts are in the port's layout
    (``models/detector/convert.py``, ``utils/convert.py``); a detector
    checkpoint without the attribute head loads (that head is not run
    here). ``windowed`` gives the extractor the windowed mode over
    ``WINDOW_LADDER``."""

    def __init__(self, det_cfg: DetectorConfig, det_state: dict,
                 bert_cfg: BertConfig, bert_state: dict,
                 tokenizer: BertTokenizer, device, dtype=torch.bfloat16,
                 windowed: bool = False):
        with torch.device(device):
            self.detector = AttrRCNN(det_cfg, dtype).eval()
            self.oscar = REC_MLM_CPT(bert_cfg, dtype).eval()
        missing, unexpected = self.detector.load_state_dict(det_state,
                                                            strict=False)
        missing = [k for k in missing
                   if not k.startswith(("attr_extractor.", "attr_predictor."))]
        if missing or unexpected:
            raise RuntimeError(f"detector state: missing {missing}, "
                               f"unexpected {unexpected}")
        self.oscar.load_state_dict(bert_state)
        self.det_cfg = det_cfg
        self.bert_cfg = bert_cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.extractor = Extractor(self.detector, det_cfg,
                                   copies_per_chunk=None, windowed=windowed,
                                   window=WINDOW_LADDER)
        self.detect_fn = make_detect_fn(self.detector, det_cfg,
                                        with_attributes=False)
        self.anchors = canvas_anchors(det_cfg, self.device)
        self.detect_seconds = 0.0

    def detect(self, image_rgb: np.ndarray, conf: float):
        """RPN-mode detection on the image's canvas → (boxes, labels,
        scores) numpy above ``conf``, by descending score."""
        t0 = time.perf_counter()
        out = run_detector(self.detect_fn, self.anchors, self.det_cfg,
                           np.asarray(image_rgb, np.uint8), conf)
        self.detect_seconds += time.perf_counter() - t0
        return out


def detect_candidates(res: Resident, image_rgb: np.ndarray,
                      conf: float) -> List[List[float]]:
    """The detector's boxes above ``conf`` as candidate lists; raises
    ``ValueError`` when there are none."""
    boxes, _labels, _scores = res.detect(image_rgb, conf)
    if not len(boxes):
        raise ValueError(f"the detector proposed no boxes above conf {conf}")
    return [[float(v) for v in b] for b in boxes]


def predict(res: Resident, image_rgb: np.ndarray, caption: str,
            dets_xyxy: Optional[Sequence[Sequence[float]]] = None,
            workdir: Optional[str] = None, conf: float = 0.5) -> List[float]:
    """→ the candidate box (inclusive xyxy) the caption refers to.

    Without ``dets_xyxy`` the detector proposes the candidates
    (:meth:`Resident.detect`, above ``conf``). Builds the RefCOCO task
    straight from the array, writes the ``predictions.tsv`` interchange
    (and its ann/det jsons) into ``workdir`` (a temporary directory when
    None), reads it back for stage 2, and returns the best-scoring
    candidate."""
    if dets_xyxy is None:
        dets_xyxy = detect_candidates(res, image_rgb, conf)
    c = res.det_cfg.input
    img = np.ascontiguousarray(np.asarray(image_rgb, np.uint8)[: c.pad_h, : c.pad_w])
    with tempfile.TemporaryDirectory(prefix="cpt_predict_") as tmp:
        wd = workdir or tmp
        os.makedirs(wd, exist_ok=True)
        tsv = os.path.join(wd, "predictions.tsv")
        ann = os.path.join(wd, "ann.json")
        det = os.path.join(wd, "stage2_det.json")
        task = refcoco_task("q0", img, img.shape[:2], dets_xyxy, caption)
        res.extractor.run([task], tsv)
        with open(ann, "w") as f:
            json.dump([{"id": "q0", "caption": caption,
                        "height": int(img.shape[0])}], f)
        det_json_for_stage2(tsv, det)
        data = RefcocoCPTData(tsv, ann, det, res.tokenizer,
                              img_feat_dim=res.bert_cfg.img_feature_dim)
        _acc, preds = refcoco_evaluate(res.oscar, data, res.tokenizer,
                                       batch_size=SCORE_BATCH)
        data.tsv.close()
    return [float(v) for v in preds["q0"]]


def candidate_scores(res: Resident, workdir: str) -> List[float]:
    """The per-candidate color/none scores of the request whose interchange
    files :func:`predict` left in ``workdir``."""
    data = RefcocoCPTData(os.path.join(workdir, "predictions.tsv"),
                          os.path.join(workdir, "ann.json"),
                          os.path.join(workdir, "stage2_det.json"),
                          res.tokenizer,
                          img_feat_dim=res.bert_cfg.img_feature_dim)
    fn = make_mlm_at_mask_fn(res.oscar)
    scores: List[float] = []
    for batch, _ in iter_eval_batches(data, SCORE_BATCH):
        grouped = refcoco_collect_scores(run_mlm_batch(fn, batch), batch,
                                         res.tokenizer)
        for sc, _rects in grouped.values():
            scores.extend(sc)
    data.tsv.close()
    return scores


def draw_box_outline(img: np.ndarray, box, color, width: int = 3) -> np.ndarray:
    """Paint a rectangle outline (inclusive xyxy) onto an RGB array in place."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    x1, x2 = max(0, min(x1, w - 1)), max(0, min(x2, w - 1))
    y1, y2 = max(0, min(y1, h - 1)), max(0, min(y2, h - 1))
    img[y1:y1 + width, x1:x2 + 1] = color
    img[max(y2 - width + 1, 0):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + width] = color
    img[y1:y2 + 1, max(x2 - width + 1, 0):x2 + 1] = color
    return img


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image", required=True)
    p.add_argument("--caption", required=True)
    p.add_argument("--dets", default=None,
                   help="json [[x1,y1,x2,y2], ...] candidate boxes "
                        "(inclusive xyxy); omit with --detect")
    p.add_argument("--detect", action="store_true",
                   help="propose the candidates with the detector (RPN mode)")
    p.add_argument("--conf", type=float, default=0.5,
                   help="--detect keeps detections scoring above this")
    p.add_argument("--checkpoint", default=None,
                   help="vinvl_vg_x152c4.pth (reference layout, a "
                        "'module.'-wrapped one too) or a Detectron .pkl")
    p.add_argument("--oscar_checkpoint", default=None,
                   help="Oscar pretrained_base pytorch_model.bin (a "
                        "'module.'-wrapped one too)")
    p.add_argument("--vocab", default=None)
    p.add_argument("--out", default=None, help="overlay PNG path")
    p.add_argument("--workdir", default=None,
                   help="keep intermediates here (default: temp dir)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="float32 runs on the CPU only (the kernels take bf16)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights used without checkpoints")
    p.add_argument("--windowed", action="store_true",
                   help="two-level windowed extraction (engine/windowed.py)")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    return p


def build_resident(device, dtype=torch.bfloat16, tiny: bool = False,
                   checkpoint: Optional[str] = None,
                   oscar_checkpoint: Optional[str] = None,
                   vocab: Optional[str] = None, seed: int = 0,
                   hidden_size: Optional[int] = None,
                   num_hidden_layers: Optional[int] = None,
                   attention_impl: str = "auto",
                   windowed: bool = False) -> Resident:
    """Both models from reference-layout checkpoints, or from random
    reference-layout state dicts drawn from ``seed`` when a checkpoint is
    not given (VinVL X152-C4 and Oscar-base at full width unless ``tiny``).
    ``attention_impl`` picks Oscar's attention backend (:func:`bert_config`);
    ``windowed`` the extractor's windowed mode (:class:`Resident`)."""
    det_cfg = tiny_detector_config() if tiny else VINVL_X152C4
    bert_cfg = bert_config(hidden_size, num_hidden_layers,
                           region_feature_dim(det_cfg), attention_impl)
    if checkpoint:
        det_state = dconv.load_vinvl_checkpoint(checkpoint, det_cfg)
    else:
        print("WARNING: random detector weights (no --checkpoint)")
        det_state = dconv.state_from_reference(
            dconv.random_vinvl_state_dict(det_cfg, seed=seed), det_cfg)
    if oscar_checkpoint:
        bert_sd = dconv.load_torch_file(oscar_checkpoint)
    else:
        print("WARNING: random Oscar weights (no --oscar_checkpoint)")
        bert_sd = bconv.random_oscar_state_dict(bert_cfg, seed=seed)
    tokenizer = BertTokenizer(vocab if vocab else toy_vocab())
    return Resident(det_cfg, det_state,
                    bert_cfg, bconv.state_from_reference(bert_sd, bert_cfg),
                    tokenizer, torch.device(device), dtype, windowed)


def main(argv=None) -> List[float]:
    args = build_args().parse_args(argv)
    from PIL import Image

    if not (args.detect or args.dets):
        raise SystemExit("--dets or --detect required")
    img = np.asarray(Image.open(args.image).convert("RGB"))
    res = build_resident(
        args.device, torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        args.tiny, args.checkpoint, args.oscar_checkpoint, args.vocab,
        args.seed, args.hidden_size, args.num_hidden_layers,
        windowed=args.windowed)
    dets = (detect_candidates(res, img, args.conf) if args.detect
            else json.loads(args.dets))
    pred = predict(res, img, args.caption, dets, workdir=args.workdir)
    print(json.dumps({"caption": args.caption, "pred_box": pred,
                      "candidates": len(dets)}))
    if args.out:
        Image.fromarray(draw_box_outline(img.copy(), pred, (0, 255, 0))).save(
            args.out)
        print(f"wrote {args.out}")
    return pred


if __name__ == "__main__":
    main()
