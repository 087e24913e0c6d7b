"""K5 — greedy NMS in one kernel (port of ``cpt_tpu/ops/nms_pallas.py``).

``nms_pallas`` has ``ops/nms.py::nms_padded``'s signature and semantics,
with the same optional leading batch dim. On a Hopper card it launches
``csrc/nms.cu`` (one thread block per problem, the whole greedy loop in
shared memory, so a batch of per-class problems is one launch); on the CPU
it runs the plain version, :func:`cpt_tpu_torch.ops.nms.nms_padded`. The
outputs are indices, so the kernel and the plain version agree exactly on
the same f32 inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from cpt_tpu_torch.kernels.build import (HOPPER_SMEM_PER_BLOCK, check, lib,
                                         require, stream, uses_kernel)
from cpt_tpu_torch.ops.nms import nms_padded

# the kernel's static shared scratch (per-warp argmax) stays under 1 KB
NMS_SMEM_LIMIT = HOPPER_SMEM_PER_BLOCK - 1024


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
    b, k = scores.shape
    smem = lib().cpt_nms_smem_bytes(k)
    if smem > NMS_SMEM_LIMIT:
        raise ValueError(f"NMS kernel stages K boxes in one block's shared "
                         f"memory: K={k} needs {smem} B, a Hopper block has "
                         f"{NMS_SMEM_LIMIT} B for them")
    boxes = require(boxes.to(torch.float32), "boxes", torch.float32, (b, k, 4))
    scores = require(scores.to(torch.float32), "scores", torch.float32, (b, k))
    valid = require(valid, "valid", torch.bool, (b, k))
    out_idx = torch.zeros((b, max_out), dtype=torch.int32, device=boxes.device)
    out_keep = torch.zeros((b, max_out), dtype=torch.bool, device=boxes.device)
    if b and k and max_out:
        check(lib().cpt_nms(boxes.data_ptr(), scores.data_ptr(),
                            valid.data_ptr(), out_idx.data_ptr(),
                            out_keep.data_ptr(), b, k, max_out,
                            float(iou_threshold), float(iou_offset),
                            stream(boxes)), "cpt_nms")
        nms_pallas.launches += 1
    if not batched:
        return out_idx[0], out_keep[0]
    return out_idx, out_keep


nms_pallas.launches = 0
