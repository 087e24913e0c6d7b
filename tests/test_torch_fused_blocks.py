"""K3 (attention sub-block) and K4 (FFN block) on the CPU, where the port
takes their plain versions: against the Pallas kernels in interpret mode
and the JAX references, at sequence lengths that are and are not multiples
of 128, with fully masked rows, and with the tanh gelu."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.ops import fused_attention as jfa
from cpt_tpu.ops import fused_ffn as jff
from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                               layer_norm_f32,
                                               reference_attention_core)
from cpt_tpu_torch.ops.fused_ffn import fused_ffn
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(120)

# f32 CPU: the kernels and references differ only in summation order
F32_TOL = dict(atol=3e-5, rtol=3e-5)


def _attn_inputs(b, s, h, seed):
    rng = np.random.RandomState(seed)
    kb = np.where(rng.rand(b, s) > 0.2, 0.0, -10000.0).astype(np.float32)
    kb[-1, :] = -10000.0          # one sequence whose keys are all masked
    return [(rng.randn(b, s, h) * 0.5).astype(np.float32),
            (rng.randn(h, 3 * h) * 0.05).astype(np.float32),
            (rng.randn(3 * h) * 0.02).astype(np.float32),
            (rng.randn(h, h) * 0.05).astype(np.float32),
            (rng.randn(h) * 0.02).astype(np.float32),
            (rng.rand(h) + 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32), kb]


@pytest.mark.parametrize("s", [24, 128])
def test_attention_block_matches_kernel_and_reference(s):
    args = _attn_inputs(3, s, 64, seed=s)
    got = fused_attention_block(*map(torch.from_numpy, args), 4, 1e-12).numpy()
    jargs = list(map(jnp.asarray, args))
    kern = run_interpret(lambda *a: jfa.fused_attention_block(*a, 4, 1e-12, 1),
                         *jargs)
    ref = jfa.reference_attention_block(*jargs, num_heads=4, eps=1e-12)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("s", [24, 128])
def test_attention_core_plain_version_composes_the_block(s):
    """The attention core's plain version (what the card's core kernel is
    held against), placed between the projections, gives the JAX
    reference block."""
    x, wqkv, bqkv, wo, bo, gamma, beta, kb = map(
        torch.from_numpy, _attn_inputs(3, s, 64, seed=s + 1))
    qkv = x @ wqkv + bqkv
    ctx = reference_attention_core(qkv, kb, 4, 1.0 / 16 ** 0.5)
    got = layer_norm_f32(ctx @ wo + bo + x, gamma, beta, 1e-12).numpy()
    ref = jfa.reference_attention_block(
        *map(jnp.asarray, _attn_inputs(3, s, 64, seed=s + 1)), num_heads=4,
        eps=1e-12)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


def _ffn_inputs(m, h, f, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, m, h) * 0.5).astype(np.float32),
            (rng.randn(h, f) * 0.05).astype(np.float32),
            (rng.randn(f) * 0.1).astype(np.float32),
            (rng.randn(f, h) * 0.05).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32),
            (rng.rand(h) + 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("approximate", [False, True])
def test_ffn_matches_kernel_and_reference(approximate):
    args = _ffn_inputs(12, 64, 256, seed=int(approximate))
    got = fused_ffn(*map(torch.from_numpy, args),
                    approximate=approximate).numpy()
    jargs = list(map(jnp.asarray, args))
    kern = run_interpret(lambda *a: jff.fused_ffn(*a, approximate=approximate),
                         *jargs)
    ref = jff._reference_ffn(*jargs, 1e-12, approximate)
    # the Pallas kernel's erf is the A&S polynomial (|err| <= 5e-7)
    np.testing.assert_allclose(got, np.asarray(kern), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


def test_plain_versions_keep_bf16():
    """The CPU dispatch returns the input dtype in bf16 too."""
    args = [torch.from_numpy(a) for a in _attn_inputs(2, 10, 32, seed=7)]
    args[0] = args[0].bfloat16()
    out = fused_attention_block(*args, 4, 1e-12)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    fargs = [torch.from_numpy(a) for a in _ffn_inputs(5, 32, 64, seed=8)]
    fargs[0] = fargs[0].bfloat16()
    assert fused_ffn(*fargs).dtype == torch.bfloat16
