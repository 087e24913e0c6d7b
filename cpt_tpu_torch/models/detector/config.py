"""Detector configuration — VinVL ResNeXt-152-C4 defaults (the port's copy
of ``cpt_tpu/models/detector/config.py``: the same fields, defaults and
presets). ``grouped_conv_impl`` and ``pooler_impl`` choose among the JAX
package's backends; the port reads neither (its grouped 3x3 is always K1,
its pooling always K2). ``precision`` is read as in the JAX package: "bf16"
runs the conv body in the model dtype, "int8" / "int8:<s>" in W8A8
(``models/detector/resnet.py``, ``ops/quant.py``).

Condenses the reference's yacs tree (``maskrcnn_benchmark/config/defaults.py``
⊕ ``scene_graph_benchmark/config/sg_defaults.py`` ⊕
``sgg_configs/vgattr/vinvl_x152c4.yaml``) into one frozen dataclass holding
exactly the knobs the CPT extraction + detector-training paths use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    """R-152-C4 ResNeXt 32x8d with frozen BN (vinvl_x152c4.yaml:4-10)."""

    stage_blocks: Tuple[int, ...] = (3, 8, 36)   # C4 body: layer1..layer3
    head_blocks: int = 3                          # layer4 (RoI head stage)
    num_groups: int = 32
    width_per_group: int = 8
    stem_out_channels: int = 64
    res2_out_channels: int = 256
    stride_in_1x1: bool = False
    out_channels: int = 1024                      # BACKBONE_OUT_CHANNELS
    # the JAX package's grouped 3x3 backend ("xla" | "pallas" | "auto")
    grouped_conv_impl: str = "xla"
    # conv-body precision: "bf16" (the model dtype) | "int8" (W8A8, dynamic
    # activation scales) | "int8:<s>" (W8A8, activation scale pinned to s)
    precision: str = "bf16"

    @property
    def stage2_bottleneck_channels(self) -> int:
        return self.num_groups * self.width_per_group


@dataclass(frozen=True)
class RPNConfig:
    """defaults.py:137-182 + vinvl yaml overrides."""

    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_stride: int = 16
    straddle_thresh: int = 0
    pre_nms_top_n_test: int = 6000
    post_nms_top_n_test: int = 300
    pre_nms_top_n_train: int = 12000
    post_nms_top_n_train: int = 2000
    nms_thresh: float = 0.7
    min_size: int = 0
    fg_iou_threshold: float = 0.7
    bg_iou_threshold: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.aspect_ratios)


@dataclass(frozen=True)
class ROIHeadsConfig:
    """defaults.py:205-231 + vinvl yaml overrides."""

    score_thresh: float = 0.2
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    min_detections_per_img: int = 10
    nms_filter: int = 2                # filter_results_fast
    num_classes: int = 1595            # VG object vocabulary + background
    pooler_resolution: int = 14
    pooler_scale: float = 1.0 / 16
    # 0 = adaptive per-RoI grid (ceil(bin size)), exactly the reference's
    # POOLER_SAMPLING_RATIO = 0; max grid 8 covers any RoI ≤ 1790px at 1/16
    pooler_sampling_ratio: int = 0
    cls_agnostic_bbox_reg: bool = False
    # TEST.IGNORE_BOX_REGRESSION: RPN-mode post-processing keeps the raw
    # proposals instead of regression-decoded boxes (the reference's
    # GQA/VQA plain-feature extraction runs with this True,
    # cmds/gqa/_ext.sh; box_head/inference.py:84-90)
    ignore_box_regression: bool = False
    # force-boxes head RoI-slot chunking (extraction peak-memory cap): the
    # pooled [C, M, 14, 14, 1024] tensor dominates HBM at large copy
    # batches; processing M in chunks of this size lets C grow instead.
    # None = no chunking.
    head_chunk: Optional[int] = 32
    # the JAX package's force-boxes pooling backend ("auto" | "xla" |
    # "pallas")
    pooler_impl: str = "auto"
    bbox_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    batch_size_per_image: int = 384
    positive_fraction: float = 0.5


@dataclass(frozen=True)
class AttributeConfig:
    """sg_defaults.py:26-27 + vinvl yaml."""

    num_attributes: int = 525
    cls_emd_dim: int = 256
    attr_emd_dim: int = 512
    postprocess_threshold: float = 0.05
    max_num_attr_per_obj: int = 16


@dataclass(frozen=True)
class InputConfig:
    """BGR255 + VinVL pixel means (vinvl yaml:26-28); static padded sizes."""

    min_size_test: int = 600
    max_size_test: int = 1000
    pixel_mean: Tuple[float, float, float] = (103.530, 116.280, 123.675)  # BGR
    pixel_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # static shapes: images are resized (min/max rules above) then padded
    # to the smallest fitting canvas bucket (stride-16-aligned). The square
    # bucket is the fallback; the rectangular ones halve backbone pixels
    # for typical landscape/portrait photos.
    pad_h: int = 1024
    pad_w: int = 1024
    buckets: Tuple[Tuple[int, int], ...] = ((640, 1024), (1024, 640),
                                            (1024, 1024))
    size_divisibility: int = 16


@dataclass(frozen=True)
class DetectorConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi_heads: ROIHeadsConfig = field(default_factory=ROIHeadsConfig)
    attributes: AttributeConfig = field(default_factory=AttributeConfig)
    input: InputConfig = field(default_factory=InputConfig)
    force_boxes: bool = False          # extraction mode: proposals = given dets
    output_feature: bool = True        # attach pooled box_features
    max_force_boxes: int = 128         # static slot count in force-boxes mode


VINVL_X152C4 = DetectorConfig()


def tiny_detector_config(**kw) -> DetectorConfig:
    """Small config for CPU tests: same code paths, toy sizes."""
    from dataclasses import replace

    cfg = DetectorConfig(
        # head_blocks=3 matches the reference's hard-coded stage-5 spec
        # (roi_box_feature_extractors.py:41: block_count=3)
        backbone=BackboneConfig(stage_blocks=(1, 1, 1), head_blocks=3,
                                num_groups=2, width_per_group=4,
                                stem_out_channels=8, res2_out_channels=16,
                                out_channels=64),
        rpn=RPNConfig(pre_nms_top_n_test=64, post_nms_top_n_test=16,
                      anchor_sizes=(16, 32), aspect_ratios=(0.5, 1.0, 2.0)),
        roi_heads=ROIHeadsConfig(num_classes=7, pooler_resolution=4,
                                 detections_per_img=8,
                                 min_detections_per_img=2),
        attributes=AttributeConfig(num_attributes=5, cls_emd_dim=4,
                                   attr_emd_dim=8),
        input=InputConfig(pad_h=64, pad_w=64, buckets=((64, 64),)),
        max_force_boxes=8,
    )
    return replace(cfg, **kw) if kw else cfg
