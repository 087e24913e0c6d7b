"""Device meshes and sharding rules (port of ``cpt_tpu/parallel/mesh.py``).

The JAX package drives every device of a mesh from one process. Here a
mesh is one process per card, PyTorch's idiom (DDP, ``DeviceMesh``):
:func:`make_mesh` builds a ``torch.distributed`` ``DeviceMesh`` with
dimensions ``("dp", "tp")`` over the world that
``parallel/distributed.initialize_from_env`` started, and ``--dp N`` needs a
world of N processes (:func:`require_world` says how to launch one).

Axes:
  * ``dp`` — data parallel: each rank computes its slice of the batch
    (:func:`dp_split`), the results come back in rank order
    (:func:`dp_gather`), gradients are averaged over it.
  * ``tp`` — tensor parallel placement of the BERT weights by rule. The
    fused kernels (K3, K4) take whole weights, so a placed weight is
    gathered (:meth:`Placed.gather`) before the forward sees it, as XLA
    hands a Pallas call its operands whole.

A partition spec :class:`P` names one mesh axis (or None) per dimension
of a parameter's *view*: the port stores the attention's fused QKV kernel
as ``[h, 3h]`` where the JAX model stores ``[h, 3, heads, head_dim]``, so
its rule shards the head axis of that 4-D view (``BERT_TP_RULES``), and
the specs equal the JAX package's leaf by leaf.

Collectives run on the process group's backend (gloo, which takes two
processes on one card). :func:`host_staged` is the one place where a
collective's CUDA tensors go through host memory: the point-to-point
step of :func:`exchange`, which gloo refuses on CUDA tensors; any other
failure raises.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cpt_tpu_torch.parallel import distributed


class P(tuple):
    """A partition spec: per tensor dimension, the mesh axis it is split
    over or None (``P()`` is replicated)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


LAUNCH_RECIPE = (
    "CPT_COORDINATOR=127.0.0.1:8476 CPT_NUM_PROCESSES={n} CPT_PROCESS_ID=<i> "
    "python -m cpt_tpu_torch.tools.<tool> ... for i in 0..{last}, or "
    "CPT_MULTIHOST=1 torchrun --nproc_per_node {n} -m cpt_tpu_torch.tools.<tool> ...")


def require_world(n: int, what: str) -> None:
    """Raise ``SystemExit`` unless the world holds ``n`` processes: a mesh
    is one process a card, never fewer."""
    world = distributed.process_count()
    if world != n:
        raise SystemExit(
            f"{what} needs {n} processes, one a card (this run has "
            f"{world}); launch them with "
            + LAUNCH_RECIPE.format(n=n, last=n - 1))


def _ensure_group() -> None:
    """A one-process world gets a gloo group of its own, so that a mesh of
    size 1 runs the same code as a larger one."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{distributed.free_port()}",
        world_size=1, rank=0)
    distributed.close_at_exit()


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def make_mesh(dp: int, tp: int = 1, device=None):
    """A ``DeviceMesh`` of ``dp × tp`` processes, dims ``("dp", "tp")``,
    over the world (rank = dp index · tp + tp index). ``device`` (default
    the card) picks the mesh's device type."""
    require_world(dp * tp, f"a mesh of dp {dp} × tp {tp}")
    _ensure_group()
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(device), (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def num_dp(mesh) -> int:
    return mesh["dp"].size()


def axis_index(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def replicated(mesh) -> tuple:
    """The placements of a replicated tensor on ``mesh``."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


# --- collectives ------------------------------------------------------------------

def host_staged(fn: Callable, outputs: Sequence[torch.Tensor],
                inputs: Sequence[torch.Tensor]) -> None:
    """Run ``fn(host outputs, host inputs)``, a collective that gloo refuses
    on CUDA tensors, on host copies; then copy the host outputs back into
    ``outputs``. The one place a collective goes through host memory: on
    an H100 with torch 2.11, two gloo processes' send / recv and isend /
    irecv raise "Bad address" on CUDA tensors, while all_reduce,
    broadcast, all_gather, all_gather_into_tensor, reduce_scatter_tensor,
    all_to_all_single and barrier run on them (PERF.md)."""
    host_in = [t.cpu() for t in inputs]
    host_out = [torch.empty_like(t, device="cpu") for t in outputs]
    fn(host_out, host_in)
    for t, h in zip(outputs, host_out):
        t.copy_(h)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``x`` over ``group``; → ``x``."""
    dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated on dim 0 in the
    group's rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def broadcast(x: torch.Tensor, src_index: int, group) -> torch.Tensor:
    """In-place broadcast of ``x`` from the group's rank ``src_index``."""
    dist.broadcast(x, src=dist.get_global_rank(group, src_index), group=group)
    return x


def exchange(x: torch.Tensor, send_to: int, recv_from: int, group
             ) -> torch.Tensor:
    """Send ``x`` to the group's rank ``send_to`` while receiving a tensor
    of its shape from ``recv_from`` (a ring step); → the received one. A
    CUDA tensor in a gloo group goes through :func:`host_staged`."""
    x = x.contiguous()
    out = torch.empty_like(x)

    def fn(o, i):
        reqs = [dist.isend(i[0], dist.get_global_rank(group, send_to), group=group),
                dist.irecv(o[0], dist.get_global_rank(group, recv_from),
                           group=group)]
        for r in reqs:
            r.wait()

    if x.is_cuda and dist.get_backend(group) == "gloo":
        host_staged(fn, [out], [x])
    else:
        fn([out], [x])
    return out


def dp_split(x, mesh):
    """This rank's slice of the leading (batch) dimension of ``x`` (a
    tensor or numpy array) over the mesh's ``dp`` axis; the dimension must
    divide by dp."""
    n, r = num_dp(mesh), axis_index(mesh, "dp")
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not divide by dp {n}")
    return x[r * (b // n):(r + 1) * (b // n)]


def dp_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every dp rank's ``x`` concatenated on dim 0 in rank order."""
    return all_gather_cat(x, mesh.get_group("dp"))


def dp_mean(tensors: Sequence[torch.Tensor], mesh) -> list:
    """The mean over the ``dp`` ranks of each tensor (f32 or wider), in
    one all-reduce of their concatenation (DDP's gradient average)."""
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                      mesh.get_group("dp")) / num_dp(mesh)
    return [piece.view(t.shape) for piece, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def dp_call(fn: Callable, mesh, *args):
    """``fn`` over this rank's dp slice of each argument (None stays None),
    its output (a tensor or a tuple of them; None stays None) gathered
    back in rank order: the global result on every rank."""
    local = [None if a is None else dp_split(a, mesh) for a in args]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(None if o is None else dp_gather(o, mesh) for o in out)
    return dp_gather(out, mesh)


def process_allgather(tree: Any) -> Any:
    """Host-level gather across the processes: the identity in a world of
    one; else each leaf (a tensor, array or scalar) becomes a numpy array
    with one entry a process stacked in front, as JAX's
    ``multihost_utils.process_allgather`` does. Replaces the reference's
    pickle-based ``all_gather`` (``utils/comm.py:102-143``)."""
    if distributed.process_count() == 1:
        return tree

    def gather(leaf):
        t = torch.as_tensor(np.asarray(leaf.cpu() if torch.is_tensor(leaf)
                                       else leaf))
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        return torch.stack(parts).numpy()

    return _tree_map(gather, tree)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


# --- BERT placement rules ------------------------------------------------------------

# view name → the parameter's view in the JAX model's layout, from its
# stored shape and the number of heads
VIEWS: Dict[str, Callable[[Tuple[int, ...], int], Tuple[int, ...]]] = {
    "qkv": lambda s, nh: (s[0], 3, nh, s[1] // (3 * nh)),
    "qkv_bias": lambda s, nh: (3, nh, s[0] // (3 * nh)),
    "heads_in": lambda s, nh: (nh, s[0] // nh, s[1]),
}

# (port state-dict name regex, spec over the view, view or None) — first
# match wins; default replicated (cpt_tpu/parallel/mesh.py:38-50)
BERT_TP_RULES: Tuple[Tuple[str, P, Optional[str]], ...] = (
    # fused qkv kernel, viewed (hidden, 3, heads, head_dim): shard heads
    (r"attention\.wqkv$", P(None, None, "tp", None), "qkv"),
    (r"attention\.bqkv$", P(None, "tp", None), "qkv_bias"),
    # attention out kernel, viewed (heads, head_dim, hidden): shard heads
    (r"attention\.wo$", P("tp", None, None), "heads_in"),
    # MLP: column-parallel intermediate, row-parallel output
    (r"intermediate\.kernel$", P(None, "tp"), None),
    (r"intermediate\.bias$", P("tp"), None),
    (r"output\.kernel$", P("tp", None), None),
)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _num_heads(params, num_heads: Optional[int]) -> int:
    if num_heads is None:
        num_heads = params.config.num_attention_heads
    return num_heads


def view_shape(name: str, shape: Sequence[int], num_heads: int,
               rules=BERT_TP_RULES) -> Tuple[int, ...]:
    """The shape a parameter is placed in: its rule's view, else its own."""
    for pattern, _, view in rules:
        if re.search(pattern, name):
            return VIEWS[view](tuple(shape), num_heads) if view else tuple(shape)
    return tuple(shape)


def param_specs(params, rules=BERT_TP_RULES, num_heads: Optional[int] = None
                ) -> Dict[str, P]:
    """{name: spec} for a model (or a {name: tensor} dict with
    ``num_heads``) by the rules; the spec applies to the view."""
    named, nh = _named(params), _num_heads(params, num_heads)
    out = {}
    for name, t in named.items():
        out[name] = P()
        for pattern, spec, _ in rules:
            if re.search(pattern, name):
                if len(view_shape(name, t.shape, nh, rules)) == len(spec):
                    out[name] = spec
                break
    return out


def fsdp_specs(params, dp_size: int, min_size: int = 2 ** 16,
               tp_rules=BERT_TP_RULES, num_heads: Optional[int] = None
               ) -> Dict[str, P]:
    """FSDP-style placement (``cpt_tpu/parallel/mesh.py:78-99``): a
    tp-ruled parameter takes ``dp`` on its first unsharded dimension that
    divides; any other with ≥ 2 dimensions, ≥ ``min_size`` elements and a
    first dimension that divides is split over ``dp`` there."""
    named, nh = _named(params), _num_heads(params, num_heads)
    out = {}
    for name, t in named.items():
        shape = view_shape(name, t.shape, nh, tp_rules)
        spec = None
        for pattern, s, _ in tp_rules:
            if re.search(pattern, name):
                if len(shape) == len(s):
                    dims = list(s)
                    for i, d in enumerate(dims):
                        if d is None and shape[i] % dp_size == 0:
                            dims[i] = "dp"
                            break
                    spec = P(*dims)
                break
        if spec is None:
            spec = (P("dp") if len(shape) >= 2 and t.numel() >= min_size
                    and shape[0] % dp_size == 0 else P())
        out[name] = spec
    return out


def _local_chunk(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    for i, name in enumerate(spec):
        if name is not None:
            n, r = mesh[name].size(), axis_index(mesh, name)
            if x.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(x.shape)} does not "
                                 f"divide by {name} {n}")
            x = x.narrow(i, r * (x.shape[i] // n), x.shape[i] // n)
    return x


class Placed:
    """Parameters placed on a mesh: each one's local shard of its view
    (``locals``, what the optimizer steps), its spec, and its shape in the
    model. :meth:`gather` → the whole tensors in the model's layout (an
    ``all_gather`` over each mesh axis a parameter is split on: on CUDA
    tensors in a gloo group, ``DTensor.full_tensor``'s functional
    all-gather ended the process with SIGSEGV under torch 2.11);
    :meth:`shard` → this rank's piece of a whole tensor (a gradient, say)
    under the same placement."""

    def __init__(self, mesh, named: Dict[str, torch.Tensor],
                 specs: Dict[str, P], num_heads: int, rules=BERT_TP_RULES):
        self.mesh = mesh
        self.names = list(named)
        self.specs = specs
        self.shapes = {n: tuple(t.shape) for n, t in named.items()}
        self.views = {n: view_shape(n, t.shape, num_heads, rules)
                      for n, t in named.items()}
        self.locals = [self.shard(n, t.detach()).clone()
                       for n, t in named.items()]

    def shard(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        return _local_chunk(whole.reshape(self.views[name]), self.mesh,
                            self.specs[name])

    def gather(self) -> Dict[str, torch.Tensor]:
        out = {}
        for n, x in zip(self.names, self.locals):
            for i, axis in enumerate(self.specs[n]):
                if axis is not None:
                    x = all_gather_cat(x.movedim(i, 0),
                                       self.mesh.get_group(axis)).movedim(0, i)
            out[n] = x.reshape(self.shapes[n])
        return out

    def sum_squares(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """Σ x² over the whole parameters from this rank's ``pieces``: each
        piece's sum over its copies on the mesh, summed over the world."""
        world = dist.get_world_size()
        total = sum(p.float().square().sum() * _pieces(self.mesh, self.specs[n])
                    / world for n, p in zip(self.names, pieces))
        return all_reduce(total, None)


def _pieces(mesh, spec: P) -> int:
    return int(np.prod([mesh[a].size() for a in spec if a is not None]))


def shard_params(params, mesh, rules=BERT_TP_RULES,
                 num_heads: Optional[int] = None) -> Placed:
    """Place a model's parameters (whole on every rank) by the tp rules."""
    nh = _num_heads(params, num_heads)
    return Placed(mesh, _named(params), param_specs(params, rules, nh), nh, rules)


def shard_params_fsdp(params, mesh, num_heads: Optional[int] = None,
                      **kw) -> Placed:
    """Place a model's parameters by :func:`fsdp_specs` (tp rules + dp)."""
    nh = _num_heads(params, num_heads)
    specs = fsdp_specs(params, num_dp(mesh), num_heads=nh, **kw)
    return Placed(mesh, _named(params), specs, nh,
                  kw.get("tp_rules", BERT_TP_RULES))


def batch_specs(batch: Any) -> Any:
    """``P("dp")`` for every leaf with a leading dimension, ``P()`` else."""
    return _tree_map(lambda x: P("dp") if getattr(x, "ndim", 0) >= 1 else P(),
                     batch)


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's dp slice of every leaf with a leading dimension."""
    return _tree_map(lambda x: dp_split(x, mesh)
                     if getattr(x, "ndim", 0) >= 1 else x, batch)
