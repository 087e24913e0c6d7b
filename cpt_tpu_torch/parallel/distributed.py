"""Multi-process startup and per-process data sharding (port of
``cpt_tpu/parallel/distributed.py``).

The reference's launch stack (``torch.distributed.launch`` +
``init_process_group`` + ``DistributedSampler``;
``Oscar/oscar/fewshot/refcoco_cpt.py:516-522``, ``utils/comm.py:49-168``),
on ``torch.distributed``: start the process group from the environment,
give each process its slice of a work list, sum host scalars across the
processes and wait for all of them.

Launch recipe (one command a process)::

    CPT_COORDINATOR=host0:8476 CPT_NUM_PROCESSES=2 CPT_PROCESS_ID=$i \\
        python -m cpt_tpu_torch.tools.<tool> ...

``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (torchrun's)
are read where the ``CPT_*`` variables are missing, and ``CPT_MULTIHOST=1``
alone starts the group from torchrun's environment (``env://``). The group
runs the gloo backend: it moves host scalars and barriers, and it takes two
processes on one card, which NCCL refuses. Each process computes on
``cuda:(LOCAL_RANK or 0) % device_count`` (:func:`local_device`), which
:func:`initialize_from_env` makes the current card, so that a tool's
``--device cuda`` lands there.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_PORT = "8476"


def initialize_from_env() -> bool:
    """Start the process group from the environment; True if a
    multi-process runtime was started (or already is up), False (and
    nothing done) in the single-process case, so that every tool calls it
    unconditionally. Reads, in order of preference:

    * ``CPT_COORDINATOR`` (host:port), ``CPT_NUM_PROCESSES``,
      ``CPT_PROCESS_ID``;
    * ``MASTER_ADDR`` (+ ``MASTER_PORT``, default 8476), ``WORLD_SIZE``,
      ``RANK``;
    * ``CPT_MULTIHOST=1``: ``init_method="env://"`` (torchrun's variables).
    """
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    num = int(env.get("CPT_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    coord = env.get("CPT_COORDINATOR")
    if coord is None and "MASTER_ADDR" in env:
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', DEFAULT_PORT)}"
    if num > 1 and coord is not None:
        pid = int(env.get("CPT_PROCESS_ID", env.get("RANK", "0")))
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=num, rank=pid)
    elif env.get("CPT_MULTIHOST"):
        dist.init_process_group("gloo", init_method="env://")
    else:
        return False
    close_at_exit()
    if torch.cuda.is_available():
        torch.cuda.set_device(local_device())
    return True


def close_at_exit() -> None:
    """At the interpreter's exit, wait for every process (a barrier), then
    destroy the process group: a gloo group left to the interpreter's
    teardown while a peer was still at work ended a process with SIGABRT
    ("terminate called without an active exception") now and then, after
    its work was done."""
    import atexit

    def close():
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()

    atexit.register(close)


def free_port() -> int:
    """A free TCP port on localhost (for a group that the caller starts)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device() -> torch.device:
    """The card this process computes on: ``LOCAL_RANK`` (0 if unset)
    modulo the cards there are."""
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return (dist.get_world_size() if dist.is_available() and dist.is_initialized()
            else 1)


def is_main_process() -> bool:
    """Reference ``utils/comm.py:49-56``: logging, checkpoint writes and
    eval reports come from one process."""
    return process_index() == 0


def host_shard(items: Sequence, index: Optional[int] = None,
               count: Optional[int] = None, strided: bool = True) -> list:
    """This process's slice of a work list. ``strided=True`` is
    ``DistributedSampler``'s rank::world interleaving; ``strided=False`` the
    contiguous split of the reference's resumable extraction loop
    (``refcocodataset.py:186-196``), the last process taking the rest."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    items = list(items)
    if n <= 1:
        return items
    if strided:
        return items[i::n]
    period = len(items) // n
    return items[period * i:] if i == n - 1 else (
        items[period * i: period * (i + 1)])


def global_batch(local_batch: Any, mesh: Any, axis: str = "dp") -> Any:
    """This process's slice of a batch → one DTensor a leaf, sharded on its
    leading dimension over ``axis`` of ``mesh`` (``parallel/mesh.make_mesh``)
    and replicated over the other axes, as ``jax.make_array_from_process_local_data``
    forms a global array (``cpt_tpu/parallel/distributed.py:113-126``). Each
    process passes its own slice; a leaf without dimensions is replicated.
    The slices live on the mesh's device type (the current card for a
    CUDA mesh)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))

    def put(x):
        t = torch.as_tensor(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                            ).to(device)
        place = [Shard(0) if name == axis and t.dim() >= 1 else Replicate()
                 for name in mesh.mesh_dim_names]
        return DTensor.from_local(t, mesh, place, run_check=False)

    if isinstance(local_batch, dict):
        return {k: put(v) for k, v in local_batch.items()}
    if isinstance(local_batch, (list, tuple)):
        return type(local_batch)(put(v) for v in local_batch)
    return put(local_batch)


def allreduce_sum(*scalars: float) -> tuple:
    """Sum Python scalars across the processes (reference ``comm.py:146-168``)
    in float64; the identity for one process."""
    if process_count() == 1:
        return tuple(scalars)
    t = torch.tensor(scalars, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return tuple(t.tolist())


def sync(name: str = "barrier") -> None:
    """A barrier across the processes (reference ``comm.py:57-76``)."""
    if process_count() > 1:
        dist.barrier()
