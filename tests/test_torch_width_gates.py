"""The widths at which the port's BERT layer sends work to K3 and K4.

Under ``"auto"`` the port takes the JAX gate's width rule (a hidden size,
and for the FFN an intermediate size, that is a multiple of 128); the
TPU's ``S % 128`` rule and its backend test are not kept. Under
``"fused"`` the layer calls the blocks at any width. K3 takes head_dim 64
and K4 and K3 a hidden size up to 1024: at other widths their launchers
raise ``KernelError`` on the card (ROADMAP lists those widths as kernel
gaps), and nothing falls back to the plain path there."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from cpt_tpu_torch.config.bert import BertConfig
from cpt_tpu_torch.kernels.build import KernelError
from cpt_tpu_torch.models.bert import model as port_model
from test_torch_watchdog import guards

guard_module, guard_case = guards(120)

# hidden, heads, intermediate, and whether "auto" fuses attention / FFN
WIDTHS = [(32, 2, 128, False, False),        # validate_checkpoints --dryrun
          (64, 2, 256, False, False),        # the tests' tiny Oscar
          (128, 2, 512, True, True),
          (128, 4, 512, True, True),         # head_dim 32: a K3 gap
          (768, 12, 3072, True, True),       # Oscar-base
          (1024, 16, 4096, True, True),      # BERT-large
          (1280, 20, 5120, True, True),      # past the LN GEMM's 1024: a gap
          (768, 12, 3000, True, False)]      # an intermediate size off 128
S = 128                            # a length the JAX gate takes


def spy(name: str, calls: list):
    """A stand-in for the block ``name``: records the name and returns the
    block's input (the layer's shapes are kept)."""
    def record(x, *args, **kwargs):
        calls.append(name)
        return x
    return record


def jax_route(hidden, heads, inter, monkeypatch) -> list:
    """The blocks the JAX ``BertLayer`` calls under ``"auto"`` with its
    backend test passed (as on the TPU)."""
    from cpt_tpu.config.bert import BertConfig as JaxConfig
    from cpt_tpu.models.bert import model as jax_model
    from cpt_tpu.ops import fused_attention, fused_ffn

    calls = []
    monkeypatch.setattr(jax_model, "_fused_ffn_available", lambda: True)
    for mod, name in ((fused_attention, "fused_attention_block"),
                      (fused_ffn, "fused_ffn")):
        monkeypatch.setattr(mod, name, spy(name, calls))
    cfg = JaxConfig(hidden_size=hidden, num_attention_heads=heads,
                    intermediate_size=inter, num_hidden_layers=1,
                    attention_impl="auto", ffn_impl="auto")
    layer = jax_model.BertLayer(cfg, jnp.float32)
    x = jnp.zeros((1, S, hidden), jnp.float32)
    bias = jnp.zeros((1, 1, 1, S), jnp.float32)
    params = jax.eval_shape(layer.init, jax.random.PRNGKey(0), x, bias)
    calls.clear()
    jax.eval_shape(layer.apply, params, x, bias)
    return calls


def port_route(hidden, heads, inter, impl, monkeypatch) -> list:
    calls = []
    for name in ("fused_attention_block", "fused_ffn"):
        monkeypatch.setattr(port_model, name, spy(name, calls))
    cfg = BertConfig(hidden_size=hidden, num_attention_heads=heads,
                     intermediate_size=inter, num_hidden_layers=1,
                     attention_impl=impl, ffn_impl=impl)
    with torch.device("meta"):
        layer = port_model.BertLayer(cfg, torch.float32).eval()
        x = torch.zeros(1, S, hidden)
        bias = torch.zeros(1, 1, 1, S)
    with torch.inference_mode():
        layer(x, bias)
    return calls


@pytest.mark.parametrize("hidden,heads,inter,attn,ffn", WIDTHS)
def test_kernel_width_gates(hidden, heads, inter, attn, ffn, monkeypatch):
    """Under ``"auto"`` the port calls the fused blocks at exactly the
    widths where the JAX layer calls its Pallas blocks."""
    want = ["fused_attention_block"] * attn + ["fused_ffn"] * ffn
    assert jax_route(hidden, heads, inter, monkeypatch) == want
    assert port_route(hidden, heads, inter, "auto", monkeypatch) == want
    cfg = BertConfig(hidden_size=hidden, num_attention_heads=heads,
                     intermediate_size=inter)
    assert port_model.auto_fuses_attention(cfg) is attn
    assert port_model.auto_fuses_ffn(cfg) is ffn


@pytest.mark.parametrize("hidden,heads,fused", [(32, 2, False), (128, 2, True)])
def test_layer_routes_by_width(hidden, heads, fused, monkeypatch):
    """A ``BertLayer`` under ``"auto"`` calls the fused blocks (their plain
    versions here) only at a width the JAX gate takes, and computes."""
    calls = []

    def spy(name, real):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(port_model, "fused_attention_block", spy(
        "attention", port_model.fused_attention_block))
    monkeypatch.setattr(port_model, "fused_ffn", spy("ffn", port_model.fused_ffn))
    cfg = dataclasses.replace(BertConfig(
        hidden_size=hidden, num_attention_heads=heads,
        intermediate_size=4 * hidden, num_hidden_layers=1),
        attention_impl="auto", ffn_impl="auto")
    layer = port_model.BertLayer(cfg, torch.float32).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    x = torch.randn(2, 5, hidden, generator=g)
    bias = torch.zeros(2, 1, 1, 5)
    with torch.inference_mode():
        out = layer(x, bias)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert calls == (["attention", "ffn"] if fused else [])


@pytest.mark.parametrize("hidden,heads,inter", [w[:3] for w in WIDTHS[::3]])
def test_fused_routes_at_every_width(hidden, heads, inter, monkeypatch):
    """``"fused"`` asks for the kernels: the layer calls both blocks at any
    width (on the card a width the kernels do not take raises there)."""
    assert port_route(hidden, heads, inter, "fused", monkeypatch) == [
        "fused_attention_block", "fused_ffn"]


def test_launchers_refuse_widths_the_kernels_do_not_take():
    """The refusals come before any launch, as ``KernelError`` (not a
    ``RuntimeError``, which the trainer would skip as a bad batch)."""
    from cpt_tpu_torch.kernels.gemm import attention_core, gemm_bias_residual_ln

    qkv = torch.zeros(1, 4, 3 * 128, dtype=torch.bfloat16)
    with pytest.raises(KernelError, match="head_dim 64"):
        attention_core(qkv, torch.zeros(1, 4), 4, 0.125)
    a = torch.zeros(4, 1280, dtype=torch.bfloat16)
    with pytest.raises(KernelError, match="up to 1024|128..1024"):
        gemm_bias_residual_ln(a, torch.zeros(1280, 1280, dtype=torch.bfloat16),
                              torch.zeros(1280), a, torch.ones(1280),
                              torch.zeros(1280), 1e-12)
    assert not issubclass(KernelError, RuntimeError)
