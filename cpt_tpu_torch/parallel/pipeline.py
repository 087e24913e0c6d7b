"""Pipeline parallelism (GPipe micro-batch schedule) for the BERT encoder
(port of ``cpt_tpu/parallel/pipeline.py``).

The encoder's layers are stacked into ``[L, ...]`` tensors
(:func:`stack_layer_params`) whose leading dimension is split over the
``pp`` axis of a ``("dp", "pp")`` mesh (:func:`make_pp_mesh`), one process
a stage. Each stage runs its ``L/pp`` layers through the port's
``BertLayer`` (K3 and K4 on the card in eval) over the micro-batch it
holds, then passes the activation ring-wise to the next stage: the
classic GPipe loop, ``n_micro`` micro-batches draining the bubble in
``n_micro + pp − 1`` ticks, the JAX program's ``scan`` + ``ppermute``
tick for tick, but for the bubble: a stage computes only on the ticks
that hold one of its micro-batches (``L/pp × n_micro`` layer calls),
where the JAX program computes every tick and masks the bubble out. The result lives on the last stage and goes to every ``pp``
rank (JAX's closing ``psum``), then to every ``dp`` rank in rank order.

The schedule is differentiable: each communication is a
``torch.autograd.Function`` whose backward is its transpose (the ring
step sends the gradient back the other way; the broadcast from the last
stage hands its gradient to that stage; the stage parameters sum their
gradients over ``dp``, as a replicated JAX leaf does). ``torch.distributed
.pipelining`` was not used: its schedules drive the backward themselves
from a loss on the last stage, where the JAX function is an ordinary
differentiable function of the stacked parameters that every rank can
take a gradient of; and its stages move activations with point-to-point
sends, which gloo refuses on CUDA tensors (``parallel/mesh.py``).

Every rank builds a graph of the same ring steps (stage 0 selects its
micro-batch over the received buffer with ``torch.where``, which keeps the
buffer in the graph; a bubble tick's output carries a zero tied to the
stage parameters), so the autograd engine runs the backward's ring steps
in the same order on every rank.
"""
from __future__ import annotations

from typing import Dict

import torch

from cpt_tpu_torch.parallel import mesh as meshlib
from cpt_tpu_torch.parallel.mesh import P


def make_pp_mesh(dp: int = 1, pp: int = 2, device=None):
    """A ``DeviceMesh`` of ``dp × pp`` processes, dims ``("dp", "pp")``
    (rank = dp index · pp + stage)."""
    meshlib.require_world(dp * pp, f"a mesh of dp {dp} × pp {pp}")
    meshlib._ensure_group()
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(meshlib._device_type(device), (dp, pp),
                            mesh_dim_names=("dp", "pp"))


def stack_layer_params(encoder, num_layers: int) -> Dict[str, torch.Tensor]:
    """A ``BertEncoder`` (or its state dict, ``layer.{i}.<name>``) → one
    ``[L, ...]`` tensor per ``BertLayer`` parameter name."""
    sd = encoder.state_dict() if isinstance(encoder, torch.nn.Module) else encoder
    names = [k[len("layer.0."):] for k in sd if k.startswith("layer.0.")]
    return {n: torch.stack([sd[f"layer.{i}.{n}"] for i in range(num_layers)])
            for n in names}


def unstack_layer_params(stacked: Dict[str, torch.Tensor], num_layers: int
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params` (an encoder state dict)."""
    return {f"layer.{i}.{n}": t[i] for i in range(num_layers)
            for n, t in stacked.items()}


def stacked_specs(stacked: Dict[str, torch.Tensor]) -> Dict[str, P]:
    return {n: P("pp") for n in stacked}


def shard_stacked(stacked: Dict[str, torch.Tensor], mesh
                  ) -> Dict[str, torch.Tensor]:
    """This rank's stage: the ``L/pp`` consecutive layers of each stacked
    tensor (a copy of its own)."""
    pp, s = mesh["pp"].size(), meshlib.axis_index(mesh, "pp")
    out = {}
    for n, t in stacked.items():
        k = t.shape[0] // pp
        out[n] = t[s * k:(s + 1) * k].detach().clone()
    return out


class _RingStep(torch.autograd.Function):
    """Send to the next stage, receive from the previous one (JAX's
    ``ppermute`` over the ring); the backward goes the other way."""

    @staticmethod
    def forward(ctx, x, group, pp, s):
        ctx.group, ctx.pp, ctx.s = group, pp, s
        return meshlib.exchange(x, (s + 1) % pp, (s - 1) % pp, group)

    @staticmethod
    def backward(ctx, g):
        pp, s = ctx.pp, ctx.s
        return (meshlib.exchange(g, (s - 1) % pp, (s + 1) % pp, ctx.group),
                None, None, None)


class _FromLastStage(torch.autograd.Function):
    """The last stage's ``out`` on every ``pp`` rank. ``tail`` (the ring's
    last received buffer) takes a zero gradient, so that every rank's
    backward starts its chain of ring steps."""

    @staticmethod
    def forward(ctx, out, tail, group, pp, s):
        ctx.last = s == pp - 1
        ctx.tail = (tail.shape, tail.dtype, tail.device)
        out = out.clone()
        return meshlib.broadcast(out, pp - 1, group) if pp > 1 else out

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail
        return (g if ctx.last else None,
                torch.zeros(shape, dtype=dtype, device=device), None, None, None)


class _DpGather(torch.autograd.Function):
    """Every dp rank's slice in rank order; the backward keeps this rank's
    slice of the gradient (every rank takes the same loss of the whole)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n, ctx.r = meshlib.num_dp(mesh), meshlib.axis_index(mesh, "dp")
        return meshlib.dp_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        b = g.shape[0] // ctx.n
        return g[ctx.r * b:(ctx.r + 1) * b], None


class _DpSlice(torch.autograd.Function):
    """This rank's dp slice of a batch that every rank holds whole; the
    backward sums the slices' gradients over the world into the whole
    batch's (stage 0 of each dp row holds its slice's)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.shape = mesh, x.shape
        return meshlib.dp_split(x, mesh)

    @staticmethod
    def backward(ctx, g):
        n, r = meshlib.num_dp(ctx.mesh), meshlib.axis_index(ctx.mesh, "dp")
        whole = g.new_zeros(ctx.shape)
        b = ctx.shape[0] // n
        whole[r * b:(r + 1) * b] = g
        return meshlib.all_reduce(whole, None), None


class _DpSum(torch.autograd.Function):
    """The identity on a stage parameter, whose gradient is summed over
    ``dp`` (a leaf replicated over dp, as in JAX)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return meshlib.all_reduce(g.contiguous(), ctx.group), None


def make_pp_encoder_fn(cfg, mesh, n_micro: int,
                       dtype: torch.dtype = torch.float32):
    """→ ``fn(stage_params, hidden [B, S, H], attn_bias) → [B, S, H]``.

    ``stage_params`` is this rank's :func:`shard_stacked` stage; ``hidden``
    and ``attn_bias`` are the whole batch, the same on every rank (each dp
    row runs its slice). The output, the whole batch's on every rank,
    equals ``BertEncoder``'s (the same per-layer math in the same order).
    ``B / dp`` must divide by ``n_micro``."""
    from cpt_tpu_torch.models.bert.model import BertLayer

    pp = mesh["pp"].size()
    L = cfg.num_hidden_layers
    if L % pp:
        raise ValueError(f"num_hidden_layers({L}) % pp({pp}) != 0")
    with torch.device("meta"):
        layer = BertLayer(cfg, dtype).eval()
    s = meshlib.axis_index(mesh, "pp")
    pp_group = mesh.get_group("pp")
    dp_group = mesh.get_group("dp")
    n_dp = meshlib.num_dp(mesh)

    def local_stack(stage, x, bias):
        for i in range(L // pp):
            x = torch.func.functional_call(
                layer, {n: t[i] for n, t in stage.items()}, (x, bias))
        return x

    def fn(stage_params, hidden, attn_bias):
        stage = {n: _DpSum.apply(t, dp_group) if n_dp > 1 else t
                 for n, t in stage_params.items()}
        x_loc = _DpSlice.apply(hidden, mesh)
        a_loc = meshlib.dp_split(attn_bias, mesh)
        b = x_loc.shape[0]
        if b % n_micro:
            raise ValueError(f"local batch {b} does not divide by n_micro "
                             f"{n_micro}")
        mb = x_loc.reshape(n_micro, b // n_micro, *x_loc.shape[1:])
        ab = a_loc.reshape(n_micro, b // n_micro, *a_loc.shape[1:])
        first = torch.tensor(s == 0, device=hidden.device)
        buf = torch.zeros_like(mb[0])
        outs = [None] * n_micro
        # a zero that depends on every stage parameter: a bubble tick's
        # output carries it, so that under autograd every tick's ring step
        # leads to the parameters on every rank, and the backward (which
        # skips what leads to no requested input) takes the same ring steps
        # everywhere
        tie = (sum(t.reshape(-1)[0] for t in stage.values()) * 0
               if torch.is_grad_enabled() else None)
        for t in range(n_micro + pp - 1):
            idx = min(max(t - s, 0), n_micro - 1)
            x = torch.where(first, mb[idx], buf)
            # a bubble tick passes its buffer on: the next stage drops it
            # (JAX's program computes it and masks it out)
            valid = 0 <= t - s < n_micro
            if valid:
                y = local_stack(stage, x, ab[idx])
            else:
                y = x if tie is None else x + tie.to(x.dtype)
            if s == pp - 1 and valid:
                outs[idx] = y
            buf = _RingStep.apply(y, pp_group, pp, s) if pp > 1 else y
        out = (torch.cat(outs) if s == pp - 1
               else x_loc.new_zeros(x_loc.shape))
        out = _FromLastStage.apply(out, buf, pp_group, pp, s)
        return _DpGather.apply(out, mesh)

    return fn


def make_pp_scoring_fn(cfg, mesh, n_micro: int,
                       dtype: torch.dtype = torch.float32):
    """Pipelined REC_MLM_CPT scoring forward → ``fn(model, stage_params,
    input_ids, token_type_ids, attention_mask, img_feats, mask_pos) →
    logits [B, vocab]`` (f32). ``model`` is a ``REC_MLM_CPT`` whose
    embeddings and MLM head run on every rank (its encoder is unused: the
    encoder runs from ``stage_params``, this rank's
    ``shard_stacked(stack_layer_params(model.bert.encoder, L), mesh)``).
    Matches ``REC_MLM_CPT.forward`` with ``mask_pos``."""
    enc_fn = make_pp_encoder_fn(cfg, mesh, n_micro, dtype)

    def fn(model, stage_params, input_ids, token_type_ids, attention_mask,
           img_feats, mask_pos):
        emb, bias = model.bert.embed(input_ids, token_type_ids,
                                     attention_mask, img_feats=img_feats)
        seq = enc_fn(stage_params, emb, bias)
        idx = mask_pos.long()[:, None, None].expand(-1, 1, seq.shape[-1])
        logits = model.mlm_head(torch.gather(seq, 1, idx),
                                model.bert.embeddings.word_embeddings)
        return logits[:, 0].float()

    return fn


def pipelined_stage(model, mesh) -> Dict[str, torch.Tensor]:
    """This rank's stage of ``model``'s encoder (a ``REC_MLM_CPT`` or any
    model with ``.bert.encoder``)."""
    return shard_stacked(stack_layer_params(model.bert.encoder,
                                            model.config.num_hidden_layers),
                         mesh)

