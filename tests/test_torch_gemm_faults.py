"""The shared GEMM's card checks (K3's projections, K4) on the CPU: each
named fault that ``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold
the kernels to misses the tolerance by more than 3× at a small width on
the same kind of numpy-seeded inputs, and the plain versions the card
compares against still match the Pallas kernels in interpret mode and the
JAX references at f32, at M and H on both sides of the kernels' tile
edges (64 and 128 rows, 128-column slices)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from cpt_tpu.ops import fused_attention as jfa
from cpt_tpu.ops import fused_ffn as jff
from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                               reference_attention_block)
from cpt_tpu_torch.ops.fused_ffn import fused_ffn, reference_ffn
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(120)

# f32 CPU: the kernels and references differ only in summation order
F32_TOL = dict(atol=3e-5, rtol=3e-5)
H, F = 256, 1024          # two 128-column slices: a cluster of 2 on the card


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _k4():
    args = _torch(cs.k4_inputs(74, H, F, seed=0))
    return args, reference_ffn(*args, 1e-12, False)


@functools.lru_cache(maxsize=None)
def _k3():
    args = _torch(cs.k3_inputs(3, 37, H, seed=0))
    return args, reference_attention_block(*args, num_heads=4, eps=1e-12)


@pytest.mark.parametrize("fault", cs.GEMM_FAULTS)
@pytest.mark.parametrize("block", ["K3", "K4"])
def test_gemm_fault_misses_tolerance(block, fault):
    if block == "K4":
        args, want = _k4()
        got = cs.ffn_with_fault(*args, 1e-12, False, fault)
    else:
        args, want = _k3()
        got = cs.attention_block_with_fault(*args, 4, 1e-12, fault)
    tol = cs.TOL[block] * float(want.abs().max())
    assert float((got - want).abs().max()) > 3 * tol


@pytest.mark.parametrize("block", ["K3", "K4"])
def test_gemm_fault_emulations_without_a_fault_are_the_references(block):
    """With no fault the emulations compute the references themselves, so
    a fault's distance is the fault's alone."""
    if block == "K4":
        args, want = _k4()
        got = cs.ffn_with_fault(*args, 1e-12, False)
    else:
        args, want = _k3()
        got = cs.attention_block_with_fault(*args, 4, 1e-12)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    with pytest.raises(ValueError):
        cs.ffn_with_fault(*_k4()[0], 1e-12, False, "no_such_fault")


def test_ln_slice_stats_is_layer_norm_on_one_slice():
    y = torch.from_numpy(np.random.RandomState(3).randn(5, 128).astype(np.float32))
    gamma, beta = torch.full((128,), 1.5), torch.full((128,), 0.25)
    from cpt_tpu_torch.ops.fused_attention import layer_norm_f32

    np.testing.assert_allclose(cs.ln_slice_stats(y, gamma, beta, 1e-12).numpy(),
                               layer_norm_f32(y, gamma, beta, 1e-12).numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("h", [128, 384])
@pytest.mark.parametrize("m", [1, 65, 130])
def test_plain_ffn_matches_jax_across_tile_edges(m, h):
    args = cs.k4_inputs(m, h, 4 * h, seed=m + h)
    got = fused_ffn(*_torch(args)).numpy()
    jargs = list(map(jnp.asarray, args))
    kern = run_interpret(lambda *a: jff.fused_ffn(*a), *jargs)
    ref = jff._reference_ffn(*jargs, 1e-12, False)
    assert got.shape == (m, h) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("h", [128, 384])
@pytest.mark.parametrize("b,s", [(1, 1), (1, 65), (2, 65)])
def test_plain_attention_block_matches_jax_across_tile_edges(b, s, h):
    args = cs.k3_inputs(b, s, h, seed=b * s + h)
    heads = h // 64
    got = fused_attention_block(*_torch(args), heads, 1e-12).numpy()
    jargs = list(map(jnp.asarray, args))
    kern = run_interpret(
        lambda *a: jfa.fused_attention_block(*a, heads, 1e-12, 1), *jargs)
    ref = jfa.reference_attention_block(*jargs, num_heads=heads, eps=1e-12)
    assert got.shape == (b, s, h) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)
