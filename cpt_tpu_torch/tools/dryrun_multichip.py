"""Multi-process dry run of the sharded paths (port of
``__graft_entry__.dryrun_multichip``)::

    python -m cpt_tpu_torch.tools.dryrun_multichip N [--device cpu]

starts N processes, one gloo group over localhost (``parallel/
distributed``), one rank each on the card (or the CPU), and runs at a tiny
width:

  * a dp × tp mesh (tp 2 where N is even) with FSDP placement of the
    encoder (the tp rules with dp grafted on), and two MLM prompt-tuning
    steps with two-step accumulation and the global-norm clip;
  * extraction over the tiny detector, N copies split over dp;
  * pipelined scoring on a dp × pp mesh (pp 2 where N is even): the
    logits must match the sequential model's, and the gradients of the
    stage parameters must be finite.

Rank 0 prints one line, as the JAX dry run does; a process that fails (or
outlives ``--timeout``) ends the run with its exit code. The encoder's
heads are 64 wide (hidden 256 over 4 heads, where the JAX dry run has 8):
the card's attention kernel takes head_dim 64.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

# the JAX dry run's tiny flagship (``__graft_entry__._flagship``) but for
# the head count; its batch has dp × 2 rows of 16 text and 8 region slots
BERT = dict(vocab_size=512, hidden_size=256, num_attention_heads=4,
            intermediate_size=512, num_hidden_layers=2, img_feature_dim=2054)
TXT, IMG = 16, 8
LOGIT_ATOL = 5e-2   # pipelined against sequential scoring (JAX's bound)


def build_args():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, nargs="?", default=2,
                   help="processes (ranks) to start")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=int, default=600,
                   help="seconds each process may take")
    return p


def example_batch(cfg, batch: int):
    """``__graft_entry__._example_batch`` at 16 + 8 slots."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, TXT)).astype(np.int64)
    ids[:, 5] = 103    # [MASK]
    return (ids, np.zeros((batch, TXT), np.int64),
            np.ones((batch, TXT + IMG), np.int64),
            rng.randn(batch, IMG, cfg.img_feature_dim).astype(np.float32),
            np.full((batch,), 5, np.int64), np.full((batch,), 7, np.int64))


def bert_model(cfg, dtype, device):
    from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
    from cpt_tpu_torch.utils import convert

    with torch.device(device):
        model = REC_MLM_CPT(cfg, dtype)
    model.load_state_dict(convert.state_from_reference(
        convert.random_oscar_state_dict(cfg, seed=0), cfg))
    return model


def train_section(cfg, dtype, device, n: int):
    """Two FSDP MLM steps on a dp × tp mesh → (mesh, first loss, second)."""
    from cpt_tpu_torch.engine import train
    from cpt_tpu_torch.parallel import mesh as meshlib

    tp = 2 if n % 2 == 0 else 1
    mesh = meshlib.make_mesh(dp=n // tp, tp=tp, device=device.type)
    model = bert_model(cfg, dtype, device)
    placed = meshlib.shard_params_fsdp(model, mesh)
    tx = train.build_optimizer(model, train.OptimConfig(
        learning_rate=1e-4, warmup_steps=2, num_train_steps=10,
        grad_accum_steps=2, max_grad_norm=1.0))
    state = train.create_train_state(model, tx, placed)
    step = train.make_mlm_train_step(model, tx, mesh=mesh, placed=placed)
    batch = tuple(torch.from_numpy(a).to(device) for a in
                  example_batch(cfg, meshlib.num_dp(mesh) * 2))
    gen = torch.Generator(device=device).manual_seed(1)
    losses = [float(step(state, batch, gen)[1]) for _ in range(2)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    return mesh, losses


def extract_section(mesh, device, n: int):
    """Extraction over the tiny detector, ``n`` copies split over dp → the
    features' shape."""
    from cpt_tpu_torch.engine.extract import make_sharded_extract_fn
    from cpt_tpu_torch.models.detector import convert as dconv
    from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
    from cpt_tpu_torch.models.detector.config import tiny_detector_config

    dcfg = tiny_detector_config()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with torch.device(device):
        det = AttrRCNN(dcfg, dtype).eval()
    det.load_state_dict(dconv.state_from_reference(
        dconv.random_vinvl_state_dict(dcfg, seed=0), dcfg), strict=False)
    m, (h, w) = dcfg.max_force_boxes, dcfg.input.buckets[0]
    rng = np.random.RandomState(0)
    rects = (np.sort(rng.uniform(0, h - 8, (n, 1, 2, 2)), axis=2)
             .transpose(0, 1, 3, 2).reshape(n, 1, 4).astype(np.float32))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    feats, _, _ = make_sharded_extract_fn(det, dcfg, mesh)(
        dev(np.zeros((h, w, 3), np.uint8)), dev(rects), dev(np.ones((n, 1), bool)),
        dev(np.tile(np.asarray([240, 0, 30, 127], np.uint8), (n, 1, 1))),
        dev(np.ones((n,), bool)), dev(np.zeros((m, 4), np.float32)),
        dev(np.ones((m,), bool)), (h, w))
    if not torch.isfinite(feats).all():
        raise AssertionError("non-finite extraction features")
    return tuple(feats.shape)


def pipeline_section(cfg, dtype, device, n: int) -> str:
    """Pipelined scoring on a dp × pp mesh against the sequential model,
    and finite gradients through it."""
    from cpt_tpu_torch.parallel import pipeline

    if n % 2:
        return "pp skipped (odd process count)"
    pp = 2
    ppmesh = pipeline.make_pp_mesh(dp=n // pp, pp=pp, device=device.type)
    model = bert_model(cfg, dtype, device).eval()
    ids, tt, mask, feats, pos, labels = (
        torch.from_numpy(a).to(device) for a in example_batch(cfg, n))
    with torch.no_grad():
        _, want = model(ids, tt, mask, img_feats=feats, mask_pos=pos)
    stage = pipeline.pipelined_stage(model, ppmesh)
    for t in stage.values():
        t.requires_grad_(True)
    score = pipeline.make_pp_scoring_fn(cfg, ppmesh, n_micro=2, dtype=dtype)
    logits = score(model, stage, ids, tt, mask, feats, pos)
    gap = float((logits.detach() - want.float()).abs().max())
    if not gap <= LOGIT_ATOL:
        raise AssertionError(f"pipelined scoring diverges from sequential: "
                             f"{gap}")
    loss = -torch.log_softmax(logits, -1)[torch.arange(n), labels].mean()
    grads = torch.autograd.grad(loss, list(stage.values()))
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("non-finite pipeline gradients")
    return (f"pp ok (dp{n // pp}×pp{pp}, logits match within {gap:.2e}, "
            f"grads finite)")


def run(args) -> str:
    """One rank's dry run → rank 0's line (every rank returns it)."""
    from cpt_tpu_torch.config.bert import tiny_bert_config
    from cpt_tpu_torch.parallel import distributed

    distributed.initialize_from_env()
    n = distributed.process_count()
    if n != args.n:
        raise SystemExit(f"dryrun_multichip {args.n} runs in a world of "
                         f"{args.n}; this one has {n}")
    device = (torch.device("cpu") if args.device == "cpu"
              else distributed.local_device())
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = tiny_bert_config(**BERT)
    mesh, losses = train_section(cfg, dtype, device, n)
    shape = extract_section(mesh, device, n)
    pp_note = pipeline_section(cfg, dtype, device, n)
    distributed.sync("dryrun")
    return (f"dryrun_multichip ok: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
            f"loss={losses[0]:.4f}/{losses[1]:.4f}, extract feats {shape} "
            f"sharded over dp, {pp_note}")


def launch(args) -> int:
    """Start ``args.n`` ranks of this module, each under ``timeout``; print
    rank 0's line; → the first non-zero exit code, else 0."""
    from cpt_tpu_torch.parallel.distributed import free_port

    port = free_port()
    argv = [sys.executable, "-m", "cpt_tpu_torch.tools.dryrun_multichip",
            str(args.n), "--device", args.device]
    procs = [subprocess.Popen(
        ["timeout", "-k", "10", str(args.timeout)] + argv,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CPT_COORDINATOR=f"127.0.0.1:{port}",
                 CPT_NUM_PROCESSES=str(args.n), CPT_PROCESS_ID=str(i),
                 LOCAL_RANK=str(i)))
        for i in range(args.n)]
    rc = 0
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=args.timeout + 30)
            if p.returncode and not rc:
                rc = p.returncode
                sys.stderr.write(f"rank {i} exited {p.returncode}:\n{err[-3000:]}")
            if i == 0 and out.strip():
                print(out.strip().splitlines()[-1], flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv=None) -> int:
    args = build_args().parse_args(argv)
    if "CPT_NUM_PROCESSES" in os.environ:   # a rank of a launch
        print(run(args), flush=True)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: no CUDA device (--device cpu "
                         "runs on the CPU)")
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())
