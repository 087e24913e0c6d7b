"""K6b / K6c (the flash-attention backward) on the CPU: the port's plain
backward and ``flash_mha``'s autograd against ``jax.vjp`` through the JAX
``flash_mha`` (the library's TPU flash-attention custom VJP, whose
backward kernels run in interpret mode on the CPU) in f32. Shapes stay
tiny: interpret mode costs seconds per call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cpt_tpu.ops import attention as jattn
from cpt_tpu_torch.ops import attention
from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                         flash_mha_bwd_dq, flash_mha_fwd,
                                         reference_flash_mha_bwd)

# f32 through the same formulas: summation-order noise only (gradients O(1))
ATOL = 1e-5


def _inputs(s, bias, seed=0, d=32):
    """q/k/v/do [2, 2, s, d] with scores of std ≈ 2, and a bias: a finite
    [2, 1, s, s] bias of std 4, or a 0/−10000 key bias [2, 1, 1, s] with
    ~20% of keys masked and the second sequence fully masked. q and k are
    multiples of 1/8, so q·k (and, at d = 64, ``(q·k + bias)/8``) is exact
    in f32 in any order: next to the −10000 mask the scores sit where f32
    resolves 1e-4, and a rounding that differs with the order of the
    operations would move the masked sequence's gradients by ~5e-5."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(2, 2, s, d).astype(np.float32) for _ in range(4))
    q, k = np.round(q * 16) / 8, np.round(k * 8) / 8
    if bias == "3d":
        b = (rng.randn(2, 1, s, s) * 4).astype(np.float32)
    else:
        b = np.where(rng.rand(2, 1, 1, s) > 0.2, 0.0, -10000.0).astype(np.float32)
        b[1] = -10000.0
    return q, k, v, do, b


def _jax_grads(q, k, v, do, b, scale):
    """(dq, dk, dv) of the JAX ``flash_mha``; ``jax.vjp`` runs inside the
    interpret-mode context so that the backward kernels run there too."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jattn.flash_mha(q_, k_, v_, jnp.asarray(b),
                                               sm_scale=scale),
            *map(jnp.asarray, (q, k, v)))
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("s,d,bias", [(40, 32, "3d"), (130, 64, "key")])
def test_flash_backward_matches_jax(s, d, bias):
    """Ragged S (40 pads to one 128-block in the JAX wrapper, 130 to two),
    a finite bias and a key bias with a fully masked sequence: the plain
    backward and the autograd Function both equal the library's VJP."""
    q, k, v, do, b = _inputs(s, bias, d=d)
    scale = 1.0 / d ** 0.5
    want = _jax_grads(q, k, v, do, b, scale)
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, do, b))
    plain = reference_flash_mha_bwd(tq, tk, tv, tb, tdo, sm_scale=scale)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash_mha(*leaves, tb, sm_scale=scale)
    got = torch.autograd.grad(out, leaves, tdo)
    for name, p, g, w in zip("qkv", plain, got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 2, s, d)
        np.testing.assert_allclose(p.numpy(), w, rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL, err_msg=name)
    if bias == "3d":
        # the einsum order (bias after the scale) misses the tolerance
        wrong = reference_flash_mha_bwd(tq, tk, tv, tb / scale, tdo,
                                        sm_scale=scale)
        assert max(np.abs(x.numpy() - w).max() for x, w in zip(wrong, want)) > 100 * ATOL


def test_flash_backward_runs_the_two_kernel_wrappers(monkeypatch):
    """The Function's backward computes di = Σ o·do, then K6b's wrapper for
    dK, dV and K6c's for dQ, each once, from the forward's row stats; on
    the CPU neither counts a launch."""
    q, k, v, do, b = map(torch.from_numpy, _inputs(24, "key", seed=3))
    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            assert a[5].shape == a[6].shape == a[7].shape == (2, 2, 24)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(attention, "flash_mha_bwd_dkv", spy(flash_mha_bwd_dkv))
    monkeypatch.setattr(attention, "flash_mha_bwd_dq", spy(flash_mha_bwd_dq))
    before = (flash_mha.launches, flash_mha_bwd_dkv.launches,
              flash_mha_bwd_dq.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(flash_mha(*leaves, b, sm_scale=0.2), leaves, do)
    assert calls == ["flash_mha_bwd_dkv", "flash_mha_bwd_dq"]
    assert (flash_mha.launches, flash_mha_bwd_dkv.launches,
            flash_mha_bwd_dq.launches) == before
    o, m, l = flash_mha_fwd(q, k, v, b, sm_scale=0.2, stats=True)
    assert m.shape == l.shape == (2, 2, 24) and bool((l >= 1).all())


def test_flash_backward_guards_and_bias_gradient():
    """A row whose scores are all −inf (l == 0) gets zero gradients and adds
    nothing to dK/dV; asking for the bias gradient raises."""
    q, k, v, do, _ = map(torch.from_numpy, _inputs(9, "key", seed=5))
    dead = torch.zeros(2, 1, 9, 9)
    dead[0, 0, 4] = float("-inf")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(flash_mha(*leaves, dead, sm_scale=0.5),
                                     leaves, do)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert torch.equal(dq[0, :, 4], torch.zeros_like(dq[0, :, 4]))
    do_dead = do.clone()
    do_dead[0, :, 4] = 7.0       # the dead row's output gradient is ignored
    _, dk2, dv2 = torch.autograd.grad(flash_mha(*leaves, dead, sm_scale=0.5),
                                      leaves, do_dead)
    assert torch.allclose(dk2, dk) and torch.allclose(dv2, dv)
    bias = torch.zeros(2, 1, 1, 9, requires_grad=True)
    with pytest.raises(NotImplementedError, match="bias gradient"):
        torch.autograd.grad(flash_mha(*leaves, bias, sm_scale=0.5).sum(),
                            leaves)


def test_flash_serving_path_keeps_no_graph():
    """Without gradients (inference) flash_mha is the plain forward: no
    autograd node, the same output as the Function's."""
    q, k, v, _, b = map(torch.from_numpy, _inputs(17, "3d", seed=6))
    with torch.inference_mode():
        served = flash_mha(q, k, v, b, sm_scale=0.3)
    assert served.grad_fn is None
    trained = flash_mha(q.requires_grad_(), k, v, b, sm_scale=0.3)
    assert trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
