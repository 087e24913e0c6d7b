"""K5 — greedy NMS in one kernel (port of ``cpt_tpu/ops/nms_pallas.py``).

``nms_pallas`` has ``ops/nms.py::nms_padded``'s signature and semantics,
with the same optional leading batch dim. On a Hopper card it launches
``csrc/nms.cu``, a sorted-order bitmask NMS (rank the live boxes, mark
the pairs whose IoU is above the threshold in that order, scan the order
in chunks of 64; in a batch, a problem of up to NMS_BLOCK_K boxes in one
block), so a batch of per-class problems is one call and one count in
``nms_pallas.launches``, whatever the number of CUDA kernels; on the CPU
it runs the plain version, :func:`cpt_tpu_torch.ops.nms.nms_padded`.
The outputs are indices, so the kernel and the plain version agree exactly
on the same f32 inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from cpt_tpu_torch.kernels.build import (aligned16, check, lib, require,
                                         stream, uses_kernel)
from cpt_tpu_torch.ops.nms import nms_padded

# the kernel's grids put the problems on a grid axis of at most 65535 blocks
NMS_MAX_PROBLEMS = 65535
# a batch of problems of up to this many boxes takes the one-block path
NMS_BLOCK_K = 1024


def nms_path(b: int, k: int) -> str:
    """The dispatch rule between K5's two paths in ``csrc/nms.cu``:
    ``"block"`` (one block a problem, rank and scan in shared memory, only
    the mask words the scan reads) for a batch of problems of up to
    NMS_BLOCK_K boxes, ``"grid"`` (rank, mask and scan kernels over the
    whole card, with device scratch) for one problem or larger ones. On the
    H100 (``chip_e2e.time_k5``, PERF.md §6) the grid path wins for one
    problem (1.17× at the box head's 300, 25× at the RPN's 6000: one
    block's O(K²) rank is serial there) and the block path for the
    per-class batches of [1594, 300] (3.6× at 32 picks, 1.02× at 300)."""
    return "block" if b > 1 and k <= NMS_BLOCK_K else "grid"


def nms_pallas(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int, iou_offset: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [(B,) K, 4] · scores [(B,) K] · valid [(B,) K] bool →
    (indices [(B,) max_out] int32, keep [(B,) max_out] bool)."""
    if not uses_kernel(boxes):
        return nms_padded(boxes, scores, valid, iou_threshold, max_out,
                          iou_offset)
    batched = boxes.dim() == 3
    if not batched:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    out_idx, out_keep = launch_nms(nms_path(*scores.shape), boxes, scores,
                                   valid, iou_threshold, max_out, iou_offset)
    if not batched:
        return out_idx[0], out_keep[0]
    return out_idx, out_keep


def launch_nms(path: str, boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_threshold: float, max_out: int,
               iou_offset: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5's ``path`` (``"block"`` or ``"grid"``) on CUDA tensors
    boxes [B, K, 4] · scores [B, K] · valid [B, K] → (indices [B, max_out]
    int32, keep [B, max_out] bool). :func:`nms_pallas` passes
    :func:`nms_path`'s choice; ``chip_e2e.py`` times the other path through
    this too. Each call counts once in ``nms_pallas.launches``, however
    many CUDA kernels it runs."""
    if path not in ("block", "grid"):
        raise ValueError(f"unknown NMS path {path!r}")
    b, k = scores.shape
    if b > NMS_MAX_PROBLEMS:
        raise ValueError(f"NMS kernel takes at most {NMS_MAX_PROBLEMS} "
                         f"problems a call, got {b}")
    boxes = aligned16(require(boxes.to(torch.float32), "boxes", torch.float32,
                              (b, k, 4)))
    scores = require(scores.to(torch.float32), "scores", torch.float32, (b, k))
    valid = require(valid, "valid", torch.bool, (b, k))
    dev = boxes.device
    if not (b and k and max_out):
        return (torch.zeros((b, max_out), dtype=torch.int32, device=dev),
                torch.zeros((b, max_out), dtype=torch.bool, device=dev))
    # the kernel writes every slot (kept picks, then zeros)
    out_idx = torch.empty((b, max_out), dtype=torch.int32, device=dev)
    out_keep = torch.empty((b, max_out), dtype=torch.bool, device=dev)
    one_block = path == "block"
    scratch = None if one_block else torch.empty(
        lib().cpt_nms_scratch_bytes(b, k), dtype=torch.uint8, device=dev)
    check(lib().cpt_nms(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                        out_idx.data_ptr(), out_keep.data_ptr(),
                        None if one_block else scratch.data_ptr(), b, k,
                        max_out, int(one_block), float(iou_threshold),
                        float(iou_offset), stream(boxes)), "cpt_nms")
    nms_pallas.launches += 1
    return out_idx, out_keep


nms_pallas.launches = 0
