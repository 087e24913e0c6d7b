"""Shared plumbing of the task tools (port of
``cpt_tpu/tools/_common.py``): the common flags, the Oscar config from the
size flags, the optimizer and gradient-clip flags, the tokenizer and the
compute dtype, the model's weights from a checkpoint or a seed, the
refusals of a multi-process launch and of ``--dp``, which wait for the
parallel port, the Oscar runners' step and epoch loops with their exact
resume, and the detector tools' front end to the reference's own yacs
yamls (``--config_file`` / ``--opts``, ``models/detector/yacs_bridge``)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
from typing import Callable, List, Optional

import numpy as np
import torch

from cpt_tpu_torch.config.bert import OSCAR_BASE, OSCAR_LARGE, BertConfig
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.models.detector.convert import load_torch_file
from cpt_tpu_torch.utils import checkpoint as ckpt_lib
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
                   help="image-feature variant: faster_r-cnn = float "
                        "region features; dis_code[_t] = VQ-VAE discrete "
                        "code ids through an embedding table (reference "
                        "modeling_bert.py:167-176)")
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
    """Refuse ``--img_feature_type dis_code[_t]`` in a tool whose data
    loader emits float region features only: the discrete codes flow through
    the VQA / GQA qla loaders alone, which read integer arrays from the
    ``.pt`` feature dict (the JAX package's refusal, word for word)."""
    if getattr(args, "img_feature_type", "faster_r-cnn") != "faster_r-cnn":
        raise SystemExit(
            f"--img_feature_type {args.img_feature_type} is supported by "
            f"run_vqa / run_gqa (qla feature loader) only, not {runner}")


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
                 seed=None, info: Optional[dict] = None):
    """Fill ``model`` (built on its device) from ``--checkpoint`` (an Oscar
    ``pytorch_model.bin``) or, without one, from random Oscar-layout
    weights drawn from ``seed`` (``--seed`` by default). ``task``
    "bert_only" loads the encoder alone and draws the model's fresh head
    from a CPU generator seeded with ``seed`` (a full-finetune model);
    a CPT task loads its whole layout. A discrete-code model's code table
    comes from the checkpoint where it has one, else from flax's ``nn.Embed``
    init (a normal of std 1/√code_dim) drawn after the head. ``info``, where
    given, gets ``"ckpt_has_code"``: whether ``--checkpoint`` supplied the
    code table. → ``model``."""
    seed = args.seed if seed is None else seed
    if args.checkpoint:
        sd = load_torch_file(args.checkpoint)
    else:
        sd = cv.random_oscar_state_dict(cfg, seed=seed)
        print("WARNING: random init (no --checkpoint)")
    # the tied-decoder warning is about a checkpoint's decoder
    warn = bool(args.checkpoint)
    has_code = False
    if task == "bert_only":
        gen = torch.Generator().manual_seed(seed)
        model.init_heads(gen)
        has_code = cv.load_bert_only(model, sd, warn)
        table = model.bert.code_embeddings
        if table is not None and not has_code:
            with torch.no_grad():
                table.copy_(torch.randn(table.shape, generator=gen)
                            / cfg.code_dim ** 0.5)
    else:
        model.load_state_dict(cv.state_from_reference(sd, cfg, task, warn))
    if info is not None:
        info["ckpt_has_code"] = bool(args.checkpoint) and has_code
    return model


def dtype_of(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def dp_mesh(args, device, *batch_sizes: int):
    """The data-parallel mesh of ``--dp`` (None for 1): a world of
    ``--dp`` processes, one a card (``parallel/mesh.make_mesh`` raises
    ``SystemExit`` with the launch recipe otherwise); each of
    ``batch_sizes`` must divide by it, as the JAX tools assert."""
    dp = getattr(args, "dp", 1)
    if dp <= 1:
        return None
    from cpt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, device=device)
    for b in batch_sizes:
        if b % dp:
            raise SystemExit(f"--dp {dp}: batch size {b} does not divide by it")
    return mesh


def writes(mesh) -> bool:
    """Whether this process writes a tool's files: always without a mesh;
    rank 0 of one (every rank holds the same results)."""
    from cpt_tpu_torch.parallel.distributed import is_main_process

    return mesh is None or is_main_process()


def dp_forward(model, mesh, *arrays):
    """``model(ids, segs, attn, img_feats=feats)``'s logits (f32) on
    ``arrays``; with a mesh each rank runs its dp slice and the logits come
    back in rank order."""
    def logits(ids, segs, attn, feats):
        return model(ids, segs, attn, img_feats=feats)[1].float()

    if mesh is None:
        return logits(*arrays)
    from cpt_tpu_torch.parallel.mesh import dp_call

    return dp_call(logits, mesh, *arrays)


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The dropout generator of optimizer step ``step``, seeded from
    (``seed``, ``step``) where the JAX runners fold the step into
    ``PRNGKey(seed)``: a resumed run draws what an uninterrupted one
    draws."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def restore_train_state(state_dir: str, state) -> bool:
    """Load the train state that ``--save_every`` saved under ``state_dir``
    (``utils/checkpoint``) into ``state``: the model's parameters in place,
    the optimizer's moments and the step. → whether there was one."""
    if not ckpt_lib.has_checkpoint(state_dir):
        return False
    saved = ckpt_lib.restore_checkpoint(state_dir, state)
    with torch.no_grad():
        for p, s in zip(state.params, saved.params):
            p.copy_(s)
    state.opt_state, state.step = saved.opt_state, saved.step
    return True


def on_device(device, arrays) -> tuple:
    """numpy arrays → tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def last_step(args, n_steps: int) -> int:
    """The step a run stops at: ``--max_steps`` cuts the loop of
    ``n_steps`` steps (but not its schedule)."""
    return min(n_steps, args.max_steps) if args.max_steps else n_steps


def train_steps(model, args, device, n_steps: int,
                batch_for: Callable[[int], tuple],
                on_step: Optional[Callable[[int, float], None]] = None,
                mesh=None) -> List[float]:
    """The JAX runners' step loop on ``make_cls_train_step``: ``--optim``
    (AdamW unless the tool has the flag) with the stock betas (0.9, 0.999),
    the clip of ``--max_grad_norm`` and ``--scheduler`` over ``n_steps``
    steps; step ``it`` on ``batch_for(it)`` (tensors on ``device``), dropout
    from ``step_generator(--seed, it)``; ``--max_steps`` cuts the loop but
    not the schedule; ``--save_every`` / ``--resume`` keep and restore the
    train state under ``{output_dir}/state``, so a resumed run goes on as
    an uninterrupted one. → this run's losses; ``on_step(step, loss)``
    after each step (and its save). ``mesh`` (``--dp``): each rank takes
    its slice of every batch, the gradients are averaged (DDP), each rank
    draws its own dropout masks and rank 0 saves."""
    ocfg = train_lib.OptimConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=int(n_steps * args.warmup_ratio), num_train_steps=n_steps,
        scheduler=args.scheduler, optim=getattr(args, "optim", "adamw"),
        **optim_overrides(args, betas=(0.9, 0.999)))
    tx = train_lib.build_optimizer(model, ocfg)
    state = train_lib.create_train_state(model, tx)
    step = train_lib.make_cls_train_step(model, tx, mesh=mesh)
    state_dir = os.path.join(args.output_dir or "", "state")
    if args.resume and args.output_dir and restore_train_state(state_dir, state):
        print(f"resumed at step {state.step}")
    losses: List[float] = []
    for it in range(state.step, last_step(args, n_steps)):
        state, loss = step(state, batch_for(it),
                           step_generator(device, args.seed, it))
        losses.append(float(loss))
        if (args.save_every and args.output_dir and writes(mesh)
                and state.step % args.save_every == 0):
            ckpt_lib.save_checkpoint(state_dir, f"step{state.step}", state)
        if on_step is not None:
            on_step(state.step, losses[-1])
    model.eval()
    return losses


def train_epochs(model, args, device, n_examples: int,
                 batch_fn: Callable[[List[int], int], tuple],
                 on_step: Optional[Callable[[int, float], None]] = None,
                 begin_epoch: Optional[Callable[[int], None]] = None,
                 end_epoch: Optional[Callable[[int, List[float]], None]] = None,
                 mesh=None) -> List[float]:
    """The epoch loop of the JAX runners (run_vqa, run_nlvr) on
    ``train_steps``, over (examples // batch) × epochs steps: each epoch in
    the order a ``random.Random`` seeded from (``--seed``, epoch) shuffles
    it, a step on ``batch_fn(indices, epoch)``. ``begin_epoch(epoch)`` runs
    before an epoch's first step in this run, ``end_epoch(epoch, losses)``
    after its last (or after the step ``--max_steps`` stops at). → this
    run's losses; ``on_step(step, loss)`` after each step. ``mesh``: as
    :func:`train_steps`."""
    bsz = args.per_gpu_train_batch_size
    per_epoch = max(1, n_examples // bsz)
    n_steps = per_epoch * args.num_train_epochs
    stop_at = last_step(args, n_steps)
    orders = {}
    losses: List[float] = []

    def batch_for(it):
        epoch, si = divmod(it, per_epoch)
        if epoch not in orders:
            if begin_epoch is not None:
                begin_epoch(epoch)
            orders[epoch] = list(range(n_examples))
            random.Random((args.seed + 1) * 7919 + epoch).shuffle(orders[epoch])
        return batch_fn(orders[epoch][si * bsz:(si + 1) * bsz], epoch)

    def after(step, loss):
        losses.append(loss)
        if on_step is not None:
            on_step(step, loss)
        if end_epoch is not None and (step % per_epoch == 0 or step == stop_at):
            end_epoch((step - 1) // per_epoch, losses)

    train_steps(model, args, device, n_steps, batch_for, after, mesh)
    return losses


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
