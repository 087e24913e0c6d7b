"""cpt_tpu_torch — the PyTorch + CUDA port of ``cpt_tpu`` for NVIDIA Hopper.

Mirrors ``cpt_tpu``'s layout module by module, so each port module has an
obvious JAX counterpart that its tests hold it against:

  csrc/        hand-written CUDA kernels (sm_90a) for the TPU's Pallas kernels
  kernels/     nvcc + ctypes build of csrc/, dispatch rule, GEMM launchers
  ops/         prompt rendering, RoIAlign, grouped conv (bf16 and int8),
               fused BERT blocks, greedy NMS, flash attention and its
               backward, W8A8 quantization and the fused int8 FFN
  structures/  box helpers and box decoding
  models/      the VinVL X152-C4 detector (force-boxes and RPN modes) and
               Oscar BERT
  engine/      colored-copy extraction (rects or masks, full or windowed),
               RPN-mode detection, color-word and NSP scoring,
               prompt-tuning training, VG recall and ensembles
  data/        stage-1 task builders and the RefCOCO, GQA, VG and VCR
               stage-2 datasets
  tools/       the one-shot grounding entry point (cpt_predict, with
               --dets or --detect), the server (serve), the detector
               demo's run_detector, the task tools (refcoco_cpt, gqa_cpt,
               vg_cpt, vcr_nsp_cpt: zero-shot eval, few-shot prompt
               tuning; show_ensemble), the stage-1 extraction driver
               (extract_features, bf16 or W8A8 int8) and its TSV helpers
               (merge_shards, ext_objects, img_info), validate_checkpoints,
               grad_gap (bf16/flash gradient gaps) and int8_gap (int8
               feature gaps)

Public functions keep the JAX package's layouts: NHWC feature maps,
[B, S, H] hidden states, inclusive xyxy boxes.
"""

import torch

__version__ = "0.1.0"

# PyTorch lets cuBLAS reduce a bf16 GEMM's split-K partial sums in bf16, so
# a bf16 result moved with the batch's shape (a scoring batch of 16 × 50
# region slots against 8 × 8: the image embedding's [M, 2054] projection).
# The JAX reference accumulates in f32 and rounds once; with this off, so
# does every cuBLAS GEMM of the port (PERF.md, PR 24).
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
