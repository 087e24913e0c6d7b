"""Shared plumbing of the task tools (port of
``cpt_tpu/tools/_common.py``): the common flags, the Oscar config from the
size flags, the optimizer and gradient-clip flags, the tokenizer and the
compute dtype, the model's weights from a checkpoint or a seed, the
refusal of a multi-process launch, which waits for the parallel port, and
the detector tools' front end to the reference's own yacs yamls
(``--config_file`` / ``--opts``, ``models/detector/yacs_bridge``)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, OSCAR_LARGE, BertConfig
from cpt_tpu_torch.models.detector.convert import load_torch_file
from cpt_tpu_torch.utils import convert as cv
from cpt_tpu_torch.utils.tokenization import BertTokenizer, toy_vocab


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX tools' common flags, with their defaults, and ``--device``
    (the card unless ``cpu`` is asked for)."""
    p.add_argument("--vocab", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--seed", type=int, default=88)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--num_train_epochs", type=int, default=0)
    p.add_argument("--per_gpu_train_batch_size", type=int, default=16)
    p.add_argument("--per_gpu_eval_batch_size", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--model_size", default="base",
                   choices=["base", "large"],
                   help="Oscar encoder geometry: base (VinVL_B) or large "
                        "(VinVL_L, Oscar/README.md:30)")
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--img_feature_dim", type=int, default=None)
    p.add_argument("--classifier", default=None, choices=["linear", "mlp"],
                   help="task-head shape (reference run_vqa.py --classifier)")
    p.add_argument("--cls_hidden_scale", type=int, default=None,
                   help="mlp classifier hidden width multiplier")
    p.add_argument("--drop_out", type=float, default=None,
                   help="BERT hidden dropout override (reference --drop_out)")
    p.add_argument("--use_img_layernorm", action="store_true",
                   help="LayerNorm on the image-feature embedding "
                        "(modeling_bert.py:166-171)")
    p.add_argument("--scheduler", default="linear",
                   choices=["linear", "constant"],
                   help="LR schedule after warmup (reference --scheduler)")
    p.add_argument("--img_feature_type", default="faster_r-cnn",
                   choices=["faster_r-cnn", "dis_code", "dis_code_t"],
                   help="image-feature variant; the discrete-code ones "
                        "(dis_code[_t]) are not ported yet")
    p.add_argument("--code_voc", type=int, default=512,
                   help="dis_code vocabulary size")
    p.add_argument("--code_dim", type=int, default=512,
                   help="dis_code embedding width")
    p.add_argument("--code_size", type=int, default=0,
                   help="dis_code_t code length per image")
    p.add_argument("--code_level", default="top",
                   choices=["top", "bottom", "both"],
                   help="which VQ-VAE code level a dis_code run reads")
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global-norm gradient clip; <= 0 disables (the "
                        "reference finetune runners clip at 1.0, "
                        "run_vqa.py:577,989)")
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    return p


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


def optim_overrides(args, betas=None) -> dict:
    """OptimConfig kwargs from the shared optimizer flags: ``eps`` and the
    clip (the upstream finetune runners' stock AdamW betas (0.9, 0.999)
    where ``betas`` says so; the CPT drivers keep OptimConfig's (0.9,
    0.98), refcoco_cpt.py:342,511)."""
    kw = {"eps": args.adam_epsilon, "max_grad_norm": clip_of(args)}
    if betas is not None:
        kw["betas"] = betas
    return kw


def check_img_feature_type(args, runner: str) -> None:
    """Refuse ``--img_feature_type dis_code[_t]``: the port's
    ``BertImgModel`` takes region features only, and the discrete-code
    variants wait for the Oscar runners (ROADMAP.md Queue 1 item 6)."""
    kind = getattr(args, "img_feature_type", "faster_r-cnn")
    if kind != "faster_r-cnn":
        raise SystemExit(f"{runner}: --img_feature_type {kind} is not ported "
                         f"yet (ROADMAP.md Queue 1 item 6)")


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


def load_or_init(model, args, cfg: BertConfig, task: str = "bert_only",
                 seed=None):
    """Fill ``model`` (built on its device) from ``--checkpoint`` (an Oscar
    ``pytorch_model.bin``) or, without one, from random Oscar-layout
    weights drawn from ``seed`` (``--seed`` by default). ``task``
    "bert_only" loads the encoder alone and draws the model's fresh head
    from a CPU generator seeded with ``seed`` (a full-finetune model);
    a CPT task loads its whole layout. → ``model``."""
    seed = args.seed if seed is None else seed
    if args.checkpoint:
        sd = load_torch_file(args.checkpoint)
    else:
        sd = cv.random_oscar_state_dict(cfg, seed=seed)
        print("WARNING: random init (no --checkpoint)")
    if task == "bert_only":
        model.init_heads(torch.Generator().manual_seed(seed))
        cv.load_bert_only(model, sd)
    else:
        model.load_state_dict(cv.state_from_reference(sd, cfg, task))
    return model


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


def add_detector_config_args(p: argparse.ArgumentParser):
    """--config_file / --opts: drive a detector tool from the reference's
    own yacs yaml (prompt_feat configs / sgg_configs) unchanged."""
    p.add_argument("--config_file", default=None,
                   help="reference yacs yaml; resolved over the reference "
                        "defaults as the reference tools resolve it "
                        "(models/detector/yacs_bridge.py)")
    p.add_argument("--opts", nargs="*", default=None,
                   help="trailing KEY VALUE yacs overrides (the reference "
                        "tools' --opts / cfg.merge_from_list)")
    return p


def apply_reference_config(parser: argparse.ArgumentParser, argv):
    """Pre-scan ``argv`` for --config_file, resolve the yaml, and install its
    values as ``parser``'s DEFAULTS, so explicit flags still win: the
    reference's defaults ← yaml ← opts ← argparse precedence. A relation
    yaml sets ``--sg`` and ``--rel_algorithm``; ``MODEL.WEIGHT`` becomes
    ``--checkpoint`` where that file exists, as given or next to the yaml.
    → the ``ReferenceRunConfig``, or None without --config_file."""
    import sys

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    add_detector_config_args(pre)
    known, _ = pre.parse_known_args(argv)
    if not known.config_file:
        return None
    from cpt_tpu_torch.models.detector.yacs_bridge import load_reference_yaml

    ref = load_reference_yaml(known.config_file, opts=known.opts)
    cand = {
        "base_lr": ref.solver.base_lr,
        "max_iter": ref.solver.max_iter,
        "steps": list(ref.solver.steps),
        "warmup_iters": ref.solver.warmup_iters,
        "checkpoint_period": ref.checkpoint_period,
        "output_dir": ref.output_dir,
    }
    if ref.relation_on:
        cand["rel_algorithm"] = ref.relation_algorithm
        cand["sg"] = True
    if ref.expected_results:
        cand["expected_results"] = json.dumps(
            [list(e) for e in ref.expected_results])
    # the reference loads MODEL.WEIGHT relative to its working directory;
    # next to the yaml is tried too, so a checked-out tree works in place
    for root in ("", os.path.dirname(os.path.abspath(known.config_file))):
        w = os.path.join(root, ref.weight) if root else ref.weight
        if ref.weight and os.path.isfile(w):
            cand["checkpoint"] = w
            break
    dests = {a.dest for a in parser._actions}
    parser.set_defaults(**{k: v for k, v in cand.items() if k in dests})
    return ref
