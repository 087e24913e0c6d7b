"""Shared plumbing of the task tools (the port's copy of the parts of
``cpt_tpu/tools/_common.py`` its tools use): the Oscar config from the
size flags, the gradient-clip flag, the tokenizer and the compute dtype,
and the refusal of a multi-process launch, which waits for the parallel
port."""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, OSCAR_LARGE, BertConfig
from cpt_tpu_torch.utils.tokenization import BertTokenizer, toy_vocab


def clip_of(args):
    """--max_grad_norm → OptimConfig.max_grad_norm (reference semantics:
    ``if args.max_grad_norm > 0`` gates the clip, so 0/negative disable —
    run_oscarplus_pretrain.py:436)."""
    return args.max_grad_norm if args.max_grad_norm > 0 else None


def add_clip_arg(p: argparse.ArgumentParser, ref: str,
                 default: float = 1.0) -> argparse.ArgumentParser:
    """The clip flag alone, for tools that don't take the full common
    surface (gqa_cpt / vcr_nsp_cpt)."""
    p.add_argument("--max_grad_norm", type=float, default=default,
                   help="global-norm gradient clip; <= 0 disables "
                        f"(reference {ref})")
    return p


def model_config(args, **extra) -> BertConfig:
    """Oscar-base (or ``--model_size large``) with the size, head and
    image-feature flags of ``args`` that are set, and ``extra``; a narrow
    ``--hidden_size`` gets hidden/16 heads and a 4× FFN."""
    base = (OSCAR_LARGE if getattr(args, "model_size", "base") == "large"
            else OSCAR_BASE)
    overrides = dict(extra)
    for k in ("hidden_size", "num_hidden_layers", "img_feature_dim",
              "classifier", "cls_hidden_scale"):
        if getattr(args, k, None) is not None:
            overrides[k] = getattr(args, k)
    if getattr(args, "drop_out", None) is not None:
        overrides["hidden_dropout_prob"] = args.drop_out
    if getattr(args, "img_feature_type", "faster_r-cnn") != "faster_r-cnn":
        overrides["img_feature_type"] = args.img_feature_type
        for k in ("code_voc", "code_dim", "code_size"):
            overrides[k] = getattr(args, k)
    if getattr(args, "use_img_layernorm", False):
        overrides["use_img_layernorm"] = True
    if args.hidden_size is not None and args.hidden_size < 768:
        overrides.setdefault("num_attention_heads",
                             max(1, args.hidden_size // 16))
        overrides.setdefault("intermediate_size", args.hidden_size * 4)
    return dataclasses.replace(base, **overrides) if overrides else base


def build_tokenizer(args) -> BertTokenizer:
    return BertTokenizer(args.vocab if args.vocab else toy_vocab())


def dtype_of(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def refuse_multi_process(tool: str) -> None:
    """Raise where the environment asks for the multi-process run that the
    JAX package's ``initialize_from_env`` would start (the variables it
    reads: ``CPT_NUM_PROCESSES`` or ``WORLD_SIZE`` above 1 with a
    coordinator, or ``CPT_MULTIHOST``); a single process goes on."""
    env = os.environ
    num = int(env.get("CPT_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    coord = env.get("CPT_COORDINATOR") or env.get("MASTER_ADDR")
    if (num > 1 and coord) or env.get("CPT_MULTIHOST"):
        raise SystemExit(f"{tool}: multi-process runs are not ported yet "
                         f"(ROADMAP.md Queue 1 item 9 (parallelism))")
