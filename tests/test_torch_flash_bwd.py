"""K6b / K6c (the flash-attention backward) on the CPU: the port's plain
backward and ``flash_mha``'s autograd against ``jax.vjp`` through the JAX
``flash_mha`` (the library's TPU flash-attention custom VJP, whose
backward kernels run in interpret mode on the CPU) in f32. Shapes stay
tiny: interpret mode costs seconds per call."""
import functools

import jax
import numpy as np
import pytest
import torch

from cpt_tpu.ops import attention as jattn
from cpt_tpu_torch.kernels.build import KernelError
from cpt_tpu_torch.ops import attention
from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                         flash_mha_bwd_dq, flash_mha_fwd,
                                         reference_flash_mha_bwd)
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(120)

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
    def grads(q_, k_, v_, do_, b_):
        _, vjp = jax.vjp(lambda *a: jattn.flash_mha(*a, b_, sm_scale=scale),
                         q_, k_, v_)
        return vjp(do_)

    return list(run_interpret(grads, q, k, v, do, b))


@functools.lru_cache(maxsize=None)
def _case(s, d, bias):
    """The inputs of one case and the JAX gradients on them, computed once
    per worker (the cases that share them call this, so each case's
    watchdog covers the interpret-mode run)."""
    q, k, v, do, b = _inputs(s, bias, d=d)
    scale = 1.0 / d ** 0.5
    return (q, k, v, do, b), scale, _jax_grads(q, k, v, do, b, scale)


@pytest.mark.parametrize("s,d,bias", [(40, 32, "3d"), (130, 64, "key"),
                                      (200, 64, "3d")])
def test_flash_backward_matches_jax(s, d, bias):
    """Ragged S (40 pads to one 128-block in the JAX wrapper, 130 and 200
    to two; 200 is two 64-row query tiles and two 64-key tiles of the
    kernels, each with a ragged edge), a finite bias (random, so
    bias[q][k] != bias[k][q]) and a key bias with a fully masked sequence:
    the plain backward and the autograd Function both equal the library's
    VJP."""
    (q, k, v, do, b), scale, want = _case(s, d, bias)
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


@pytest.mark.parametrize("fault", ["no_di", "ds_unscaled", "no_l",
                                   "bias_after_scale", "bias_transposed"])
def test_flash_backward_named_faults_miss(fault):
    """Each named fault that ``chip_smoke.py`` holds K6b/K6c to (di dropped,
    ds unscaled, p not divided by l, the bias after the scale, the bias
    read transposed) misses the JAX gradients by more than ``BWD_TOL`` of a
    gradient's scale at S = 200 with an asymmetric 3-D bias, so a kernel
    with that slip would fail the card's check."""
    import chip_smoke

    (q, k, v, do, b), scale, want = _case(200, 64, "3d")
    tq, tk, tv, tb, tdo = map(torch.from_numpy, (q, k, v, b, do))
    # without a fault the emulation is the library's backward
    sound = chip_smoke.flash_bwd_with_fault(tq, tk, tv, tb, tdo, scale)
    for x, w in zip(sound, want):
        np.testing.assert_allclose(x.numpy(), w, rtol=0, atol=1e-4)
    got = chip_smoke.flash_bwd_with_fault(tq, tk, tv, tb, tdo, scale, fault)
    miss = max(np.abs(x.numpy() - w).max() / (chip_smoke.BWD_TOL * np.abs(w).max())
               for x, w in zip(got, want))
    assert miss > 1.0, (fault, miss)


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
    with pytest.raises(KernelError, match="bias gradient"):
        torch.autograd.grad(flash_mha(*leaves, bias, sm_scale=0.5).sum(),
                            leaves)
    assert not issubclass(KernelError, RuntimeError)


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
