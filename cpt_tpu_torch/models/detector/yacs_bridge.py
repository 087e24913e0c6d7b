"""Load the reference's own yacs yaml configs (the port's copy of
``cpt_tpu/models/detector/yacs_bridge.py``).

The reference drives every detector run from yaml files under
``prompt_feat/{configs,sgg_configs}`` merged over the yacs default tree
(``maskrcnn_benchmark/config/defaults.py:1-543`` ⊕
``scene_graph_benchmark/config/sg_defaults.py:1-146``), plus command-line
``--opts KEY VALUE`` overrides (``tools/test_sg_net.py:43-47``). This module
reproduces that resolution order — reference defaults, then the yaml,
then opts — and maps the result onto the port's dataclasses
(``models/detector/config.py``, ``engine/solver.SolverConfig``), so
``test_detector`` / ``extract_features`` take e.g.
``sgg_configs/vgattr/vinvl_x152c4.yaml`` unchanged.

yacs decodes python-literal strings (``"(49000, 65000)"``) with
``ast.literal_eval`` (yacs/config.py ``_decode_cfg_value``); so does this.
Keys with no counterpart (dataloader workers, FPN-level pooler scale
lists beyond the first, DCN stages, …) are kept verbatim in ``.raw``.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from cpt_tpu_torch.engine.solver import SolverConfig
from cpt_tpu_torch.models.detector.config import (AttributeConfig,
                                                  BackboneConfig,
                                                  DetectorConfig,
                                                  InputConfig, ROIHeadsConfig,
                                                  RPNConfig)

# Reference defaults for every key this bridge maps (NOT the VinVL-tuned
# dataclass defaults — yacs semantics require the defaults.py values for
# keys a yaml leaves unset). file:line cites are to defaults.py unless
# marked sg (= sg_defaults.py).
_REF_DEFAULTS: Dict[str, Any] = {
    "MODEL.META_ARCHITECTURE": "GeneralizedRCNN",            # :30
    "MODEL.WEIGHT": "",                                      # :36
    "MODEL.CLS_AGNOSTIC_BBOX_REG": False,                    # :31
    "MODEL.ATTRIBUTE_ON": False,                             # sg:16
    "MODEL.RELATION_ON": False,                              # sg:40
    "MODEL.USE_FREQ_PRIOR": False,                           # sg:41
    "MODEL.FREQ_PRIOR": "visualgenome/label_danfeiX_clipped.freq_prior.npy",
    "MODEL.BACKBONE.CONV_BODY": "R-50-C4",                   # :107
    "MODEL.RESNETS.NUM_GROUPS": 1,                           # :282
    "MODEL.RESNETS.WIDTH_PER_GROUP": 64,                     # :285
    "MODEL.RESNETS.STRIDE_IN_1X1": True,                     # :289
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS": 1024,             # :299
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 256,                  # :300
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 64,                   # :301
    "MODEL.RPN.ANCHOR_SIZES": (32, 64, 128, 256, 512),       # :139
    "MODEL.RPN.ASPECT_RATIOS": (0.5, 1.0, 2.0),              # :144
    "MODEL.RPN.ANCHOR_STRIDE": (16,),                        # :142
    "MODEL.RPN.STRADDLE_THRESH": 0,                          # :147
    "MODEL.RPN.FG_IOU_THRESHOLD": 0.7,                       # :151
    "MODEL.RPN.BG_IOU_THRESHOLD": 0.3,                       # :155
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 256,                   # :157
    "MODEL.RPN.POSITIVE_FRACTION": 0.5,                      # :159
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN": 12000,                  # :162
    "MODEL.RPN.PRE_NMS_TOP_N_TEST": 6000,                    # :163
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN": 2000,                  # :165
    "MODEL.RPN.POST_NMS_TOP_N_TEST": 1000,                   # :166
    "MODEL.RPN.NMS_THRESH": 0.7,                             # :168
    "MODEL.RPN.MIN_SIZE": 0,                                 # :171
    "MODEL.RPN.FORCE_BOXES": False,                          # :182
    "MODEL.ROI_HEADS.FG_IOU_THRESHOLD": 0.5,                 # :191
    "MODEL.ROI_HEADS.BG_IOU_THRESHOLD": 0.5,                 # :194
    "MODEL.ROI_HEADS.BBOX_REG_WEIGHTS": (10.0, 10.0, 5.0, 5.0),  # :197
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 512,             # :202
    "MODEL.ROI_HEADS.POSITIVE_FRACTION": 0.25,               # :204
    "MODEL.ROI_HEADS.SCORE_THRESH": 0.05,                    # :211
    "MODEL.ROI_HEADS.NMS": 0.5,                              # :214
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG": 100,               # :217
    "MODEL.ROI_HEADS.MIN_DETECTIONS_PER_IMG": 0,             # :220
    "MODEL.ROI_HEADS.NMS_FILTER": 0,                         # :223
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION": 14,              # :229
    "MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO": 0,           # :230
    "MODEL.ROI_BOX_HEAD.POOLER_SCALES": (1.0 / 16,),         # :231
    "MODEL.ROI_BOX_HEAD.NUM_CLASSES": 81,                    # :232
    "MODEL.ROI_BOX_HEAD.FORCE_BOXES": False,                 # :241
    "MODEL.ROI_ATTRIBUTE_HEAD.NUM_ATTRIBUTES": 401,          # sg:24
    "MODEL.ROI_ATTRIBUTE_HEAD.CLS_EMD_DIM": 256,             # sg:26
    "MODEL.ROI_ATTRIBUTE_HEAD.ATTR_EMD_DIM": 512,            # sg:27
    "MODEL.ROI_ATTRIBUTE_HEAD.MAX_NUM_ATTR_PER_OBJ": 16,     # sg:29
    "MODEL.ROI_ATTRIBUTE_HEAD.POSTPROCESS_ATTRIBUTES_THRESHOLD": 0.0,  # sg:30
    "MODEL.ROI_RELATION_HEAD.ALGORITHM": "sg_baseline",      # sg:49
    "MODEL.ROI_RELATION_HEAD.NUM_CLASSES": 51,               # sg:63
    "MODEL.ROI_RELATION_HEAD.MODE": "sgdet",                 # sg:50
    "MODEL.ROI_RELATION_HEAD.USE_BIAS": False,               # sg:53
    "MODEL.ROI_RELATION_HEAD.FILTER_NON_OVERLAP": True,      # sg:55
    "MODEL.ROI_RELATION_HEAD.TRIPLETS_PER_IMG": 100,         # sg:57
    "MODEL.ROI_RELATION_HEAD.POSTPROCESS_METHOD": "constrained",  # sg:46
    "MODEL.ROI_RELATION_HEAD.CONTRASTIVE_LOSS.USE_FLAG": False,
    "INPUT.MIN_SIZE_TEST": 800,                              # :48
    "INPUT.MAX_SIZE_TEST": 1333,                             # :50
    "INPUT.PIXEL_MEAN": (102.9801, 115.9465, 122.7717),      # :52
    "INPUT.PIXEL_STD": (1.0, 1.0, 1.0),                      # :54
    "SOLVER.BASE_LR": 0.001,                                 # :434
    "SOLVER.BIAS_LR_FACTOR": 2.0,                            # :435
    "SOLVER.MOMENTUM": 0.9,                                  # :437
    "SOLVER.WEIGHT_DECAY": 0.0005,                           # :439
    "SOLVER.WEIGHT_DECAY_BIAS": 0.0,                         # :440
    "SOLVER.GAMMA": 0.1,                                     # :442
    "SOLVER.STEPS": (30000,),                                # :443
    "SOLVER.MAX_ITER": 40000,                                # :432
    "SOLVER.WARMUP_FACTOR": 1.0 / 3,                         # :445
    "SOLVER.WARMUP_ITERS": 500,                              # :446
    "SOLVER.WARMUP_METHOD": "linear",                        # :447
    "SOLVER.OPTIMIZER": "SGD",                               # :459
    "SOLVER.CLIP_GRADIENTS.ENABLED": False,                  # :461
    "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 5.0,
    "SOLVER.IMS_PER_BATCH": 16,                              # :455
    "SOLVER.CHECKPOINT_PERIOD": 2500,                        # :449
    "DATASETS.TRAIN": (),                                    # :73
    "DATASETS.TEST": (),                                     # :77
    "DATASETS.FACTORY_TRAIN": (),                            # :75
    "DATASETS.FACTORY_TEST": (),                             # :79
    "DATASETS.LABELMAP_FILE": "",                            # :95
    "DATALOADER.SIZE_DIVISIBILITY": 0,                       # :89
    "TEST.IMS_PER_BATCH": 8,                                 # :481
    "TEST.OUTPUT_FEATURE": False,                            # :513
    "TEST.SAVE_RESULTS_TO_TSV": False,                       # :472
    "TEST.TSV_SAVE_SUBSET": ("rect", "class", "conf"),       # :475
    "TEST.SKIP_PERFORMANCE_EVAL": False,                     # :489
    "TEST.IGNORE_BOX_REGRESSION": False,                     # :514
    "TEST.EXPECTED_RESULTS": (),                             # :476
    "TEST.EXPECTED_RESULTS_SIGMA_TOL": 4,                    # :477
    "OUTPUT_DIR": ".",
    "DATA_DIR": "",
}

# ResNet depth → (stage2, stage3, stage4) block counts, resnet.py:40-48 of
# the reference (R-*-C4 bodies stop at stage 4; stage 5 is the RoI head).
_DEPTH_BLOCKS = {50: (3, 4, 6), 101: (3, 4, 23), 152: (3, 8, 36)}


def _decode(v: Any) -> Any:
    """yacs ``_decode_cfg_value``: literal-eval strings when possible."""
    if isinstance(v, dict):
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _parse_conv_body(body: str) -> Dict[str, Any]:
    """"R-152-C4" / "X-101-32x8d-FPN" → backbone kwargs (+ fpn flag)."""
    parts = body.split("-")
    info: Dict[str, Any] = {"fpn": body.endswith("FPN")}
    for p in parts:
        if p.isdigit() and int(p) in _DEPTH_BLOCKS:
            info["stage_blocks"] = _DEPTH_BLOCKS[int(p)]
        elif "x" in p and p[0].isdigit():  # "32x8d" cardinality spec
            g, w = p.rstrip("d").split("x")
            info["num_groups"], info["width_per_group"] = int(g), int(w)
    return info


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclass(frozen=True)
class ReferenceRunConfig:
    """Everything a reference yaml decides, in the port's configs."""

    detector: DetectorConfig
    solver: SolverConfig
    meta_architecture: str
    conv_body: str
    weight: str
    attribute_on: bool
    relation_on: bool
    relation_algorithm: str
    relation_num_classes: int
    relation_use_bias: bool
    relation_filter_non_overlap: bool
    relation_triplets_per_img: int
    use_freq_prior: bool
    freq_prior: str
    datasets_train: Tuple[str, ...]
    datasets_test: Tuple[str, ...]
    labelmap_file: str
    data_dir: str
    output_dir: str
    ims_per_batch: int
    checkpoint_period: int
    test_ims_per_batch: int
    tsv_save_subset: Tuple[str, ...]
    skip_performance_eval: bool
    expected_results: Tuple[Any, ...]
    expected_results_sigma_tol: float
    raw: Dict[str, Any]


def load_reference_yaml(path: str,
                        opts: Optional[Sequence[str]] = None
                        ) -> ReferenceRunConfig:
    """Resolve a reference yacs yaml (+ ``KEY VALUE`` opts) to the port's
    configs.

    ``opts`` mirrors the reference tools' trailing ``--opts`` overrides
    (``tools/test_sg_net.py:43-47`` → ``cfg.merge_from_list``): a flat
    ``[key, value, key, value, ...]`` list, values decoded like yaml values.
    """
    import yaml

    with open(path) as f:
        tree = _decode(yaml.safe_load(f) or {})
    flat = dict(_REF_DEFAULTS)
    yaml_flat = _flatten(tree)
    flat.update(yaml_flat)
    if opts:
        if len(opts) % 2:
            raise ValueError(f"--opts needs KEY VALUE pairs, got {opts}")
        for k, v in zip(opts[::2], opts[1::2]):
            flat[k] = _decode(v)

    g = flat.__getitem__
    body = _parse_conv_body(str(g("MODEL.BACKBONE.CONV_BODY")))

    backbone = BackboneConfig(
        stage_blocks=body.get("stage_blocks", (3, 4, 6)),
        num_groups=body.get("num_groups", int(g("MODEL.RESNETS.NUM_GROUPS"))),
        width_per_group=body.get(
            "width_per_group", int(g("MODEL.RESNETS.WIDTH_PER_GROUP"))),
        stem_out_channels=int(g("MODEL.RESNETS.STEM_OUT_CHANNELS")),
        res2_out_channels=int(g("MODEL.RESNETS.RES2_OUT_CHANNELS")),
        stride_in_1x1=bool(g("MODEL.RESNETS.STRIDE_IN_1X1")),
        out_channels=int(g("MODEL.RESNETS.BACKBONE_OUT_CHANNELS")),
    )
    # explicit RESNETS cardinality overrides win over the CONV_BODY name
    if "MODEL.RESNETS.NUM_GROUPS" in yaml_flat:
        backbone = dataclasses.replace(
            backbone, num_groups=int(g("MODEL.RESNETS.NUM_GROUPS")))
    if "MODEL.RESNETS.WIDTH_PER_GROUP" in yaml_flat:
        backbone = dataclasses.replace(
            backbone, width_per_group=int(g("MODEL.RESNETS.WIDTH_PER_GROUP")))

    stride = g("MODEL.RPN.ANCHOR_STRIDE")
    rpn = RPNConfig(
        anchor_sizes=tuple(g("MODEL.RPN.ANCHOR_SIZES")),
        aspect_ratios=tuple(g("MODEL.RPN.ASPECT_RATIOS")),
        anchor_stride=int(stride[0] if isinstance(stride, (tuple, list))
                          else stride),
        straddle_thresh=int(g("MODEL.RPN.STRADDLE_THRESH")),
        pre_nms_top_n_test=int(g("MODEL.RPN.PRE_NMS_TOP_N_TEST")),
        post_nms_top_n_test=int(g("MODEL.RPN.POST_NMS_TOP_N_TEST")),
        pre_nms_top_n_train=int(g("MODEL.RPN.PRE_NMS_TOP_N_TRAIN")),
        post_nms_top_n_train=int(g("MODEL.RPN.POST_NMS_TOP_N_TRAIN")),
        nms_thresh=float(g("MODEL.RPN.NMS_THRESH")),
        min_size=int(g("MODEL.RPN.MIN_SIZE")),
        fg_iou_threshold=float(g("MODEL.RPN.FG_IOU_THRESHOLD")),
        bg_iou_threshold=float(g("MODEL.RPN.BG_IOU_THRESHOLD")),
        batch_size_per_image=int(g("MODEL.RPN.BATCH_SIZE_PER_IMAGE")),
        positive_fraction=float(g("MODEL.RPN.POSITIVE_FRACTION")),
    )

    scales = g("MODEL.ROI_BOX_HEAD.POOLER_SCALES")
    roi_heads = ROIHeadsConfig(
        score_thresh=float(g("MODEL.ROI_HEADS.SCORE_THRESH")),
        nms_thresh=float(g("MODEL.ROI_HEADS.NMS")),
        detections_per_img=int(g("MODEL.ROI_HEADS.DETECTIONS_PER_IMG")),
        min_detections_per_img=int(g("MODEL.ROI_HEADS.MIN_DETECTIONS_PER_IMG")),
        nms_filter=int(g("MODEL.ROI_HEADS.NMS_FILTER")),
        num_classes=int(g("MODEL.ROI_BOX_HEAD.NUM_CLASSES")),
        pooler_resolution=int(g("MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION")),
        pooler_scale=float(scales[0] if isinstance(scales, (tuple, list))
                           else scales),
        pooler_sampling_ratio=int(g("MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO")),
        cls_agnostic_bbox_reg=bool(g("MODEL.CLS_AGNOSTIC_BBOX_REG")),
        ignore_box_regression=bool(g("TEST.IGNORE_BOX_REGRESSION")),
        bbox_reg_weights=tuple(g("MODEL.ROI_HEADS.BBOX_REG_WEIGHTS")),
        batch_size_per_image=int(g("MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE")),
        positive_fraction=float(g("MODEL.ROI_HEADS.POSITIVE_FRACTION")),
    )

    attributes = AttributeConfig(
        num_attributes=int(g("MODEL.ROI_ATTRIBUTE_HEAD.NUM_ATTRIBUTES")),
        cls_emd_dim=int(g("MODEL.ROI_ATTRIBUTE_HEAD.CLS_EMD_DIM")),
        attr_emd_dim=int(g("MODEL.ROI_ATTRIBUTE_HEAD.ATTR_EMD_DIM")),
        postprocess_threshold=float(
            g("MODEL.ROI_ATTRIBUTE_HEAD.POSTPROCESS_ATTRIBUTES_THRESHOLD")),
        max_num_attr_per_obj=int(
            g("MODEL.ROI_ATTRIBUTE_HEAD.MAX_NUM_ATTR_PER_OBJ")),
    )

    # static-shape canvas: the reference pads each batch to its largest
    # image (inference_ref.py collator); the canvas here is fixed at the
    # resize envelope (min/max test sizes rounded up to 64 — 600/1000 →
    # the 640/1024 buckets of InputConfig).
    min_t = int(g("INPUT.MIN_SIZE_TEST"))
    max_t = int(g("INPUT.MAX_SIZE_TEST"))
    short, long_ = _round_up(min_t, 64), _round_up(max_t, 64)
    div = max(16, int(g("DATALOADER.SIZE_DIVISIBILITY")))
    inp = InputConfig(
        min_size_test=min_t, max_size_test=max_t,
        pixel_mean=tuple(g("INPUT.PIXEL_MEAN")),
        pixel_std=tuple(g("INPUT.PIXEL_STD")),
        pad_h=long_, pad_w=long_,
        buckets=((short, long_), (long_, short), (long_, long_)),
        size_divisibility=div,
    )

    detector = DetectorConfig(
        backbone=backbone, rpn=rpn, roi_heads=roi_heads,
        attributes=attributes, input=inp,
        force_boxes=bool(g("MODEL.ROI_BOX_HEAD.FORCE_BOXES")
                         or g("MODEL.RPN.FORCE_BOXES")),
        output_feature=bool(g("TEST.OUTPUT_FEATURE")),
    )

    solver = SolverConfig(
        base_lr=float(g("SOLVER.BASE_LR")),
        bias_lr_factor=float(g("SOLVER.BIAS_LR_FACTOR")),
        momentum=float(g("SOLVER.MOMENTUM")),
        weight_decay=float(g("SOLVER.WEIGHT_DECAY")),
        weight_decay_bias=float(g("SOLVER.WEIGHT_DECAY_BIAS")),
        gamma=float(g("SOLVER.GAMMA")),
        steps=tuple(g("SOLVER.STEPS")),
        max_iter=int(g("SOLVER.MAX_ITER")),
        warmup_factor=float(g("SOLVER.WARMUP_FACTOR")),
        warmup_iters=int(g("SOLVER.WARMUP_ITERS")),
        warmup_method=str(g("SOLVER.WARMUP_METHOD")),
        optimizer=str(g("SOLVER.OPTIMIZER")),
        clip_gradients=(float(g("SOLVER.CLIP_GRADIENTS.CLIP_VALUE"))
                        if g("SOLVER.CLIP_GRADIENTS.ENABLED") else 0.0),
    )

    def _tup(key: str) -> Tuple[Any, ...]:
        v = g(key)
        return tuple(v) if isinstance(v, (tuple, list)) else (v,)

    return ReferenceRunConfig(
        detector=detector, solver=solver,
        meta_architecture=str(g("MODEL.META_ARCHITECTURE")),
        conv_body=str(g("MODEL.BACKBONE.CONV_BODY")),
        weight=str(g("MODEL.WEIGHT")),
        attribute_on=bool(g("MODEL.ATTRIBUTE_ON")),
        relation_on=bool(g("MODEL.RELATION_ON")),
        relation_algorithm=str(g("MODEL.ROI_RELATION_HEAD.ALGORITHM")),
        relation_num_classes=int(g("MODEL.ROI_RELATION_HEAD.NUM_CLASSES")),
        relation_use_bias=bool(g("MODEL.ROI_RELATION_HEAD.USE_BIAS")),
        relation_filter_non_overlap=bool(
            g("MODEL.ROI_RELATION_HEAD.FILTER_NON_OVERLAP")),
        relation_triplets_per_img=int(
            g("MODEL.ROI_RELATION_HEAD.TRIPLETS_PER_IMG")),
        use_freq_prior=bool(g("MODEL.USE_FREQ_PRIOR")),
        freq_prior=str(g("MODEL.FREQ_PRIOR")),
        datasets_train=_tup("DATASETS.TRAIN"),
        datasets_test=_tup("DATASETS.TEST"),
        labelmap_file=str(g("DATASETS.LABELMAP_FILE")),
        data_dir=str(g("DATA_DIR")),
        output_dir=str(g("OUTPUT_DIR")),
        ims_per_batch=int(g("SOLVER.IMS_PER_BATCH")),
        checkpoint_period=int(g("SOLVER.CHECKPOINT_PERIOD")),
        test_ims_per_batch=int(g("TEST.IMS_PER_BATCH")),
        tsv_save_subset=_tup("TEST.TSV_SAVE_SUBSET"),
        skip_performance_eval=bool(g("TEST.SKIP_PERFORMANCE_EVAL")),
        expected_results=_tup("TEST.EXPECTED_RESULTS"),
        expected_results_sigma_tol=float(g("TEST.EXPECTED_RESULTS_SIGMA_TOL")),
        raw=flat,
    )
