"""cpt_tpu_torch — the PyTorch + CUDA port of ``cpt_tpu`` for NVIDIA Hopper.

Mirrors ``cpt_tpu``'s layout module by module, so each port module has an
obvious JAX counterpart that its tests hold it against:

  csrc/        hand-written CUDA kernels (sm_90a) for the TPU's Pallas kernels
  kernels/     nvcc + ctypes build of csrc/, dispatch rule, GEMM launchers
  ops/         prompt rendering, RoIAlign, grouped conv, fused BERT blocks
  structures/  host-side box helpers
  models/      the VinVL X152-C4 detector (force-boxes mode) and Oscar BERT
  engine/      colored-copy extraction and color-word scoring
  data/        the RefCOCO stage-2 dataset
  tools/       the one-shot grounding entry point (cpt_predict)

Public functions keep the JAX package's layouts: NHWC feature maps,
[B, S, H] hidden states, inclusive xyxy boxes.
"""

__version__ = "0.1.0"
