"""K6 (flash attention) on the CPU: the port's plain ``flash_mha`` against
the JAX ``flash_mha`` (the library's TPU flash-attention forward, run in
interpret mode as on the CPU) in f32, and tiny ``REC_MLM_CPT`` /
``BertImgModel`` under ``attention_impl="flash"`` against the JAX model.
Shapes stay tiny: interpret mode costs seconds per call."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.models.bert.model import BertImgModel as JaxBert
from cpt_tpu.ops import attention as jattn
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.models.bert import model as bert_model
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.bert.model import BertImgModel
from cpt_tpu_torch.ops.attention import einsum_mha, flash_mha
from cpt_tpu_torch.tools import cpt_predict
from cpt_tpu_torch.utils import convert as bconv

# f32 through the same formulas: summation-order noise only (outputs O(1))
ATOL = 1e-5
# a whole tiny network in f32 (as tests/test_torch_models.py)
TOL = dict(atol=2e-4, rtol=2e-4)


def _qkv_bias(s, bias, seed=0):
    """q/k/v [2, 2, s, 32] with scores of std ≈ 2, and a bias: none, a
    0/−10000 key bias [2, 1, 1, s] with ~20% of keys masked, or a finite
    [2, 1, s, s] bias of std 4."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(2, 2, s, 32).astype(np.float32) for _ in range(3))
    q *= 2.0
    if bias == "key":
        b = np.where(rng.rand(2, 1, 1, s) > 0.2, 0.0, -10000.0).astype(np.float32)
    elif bias == "3d":
        b = (rng.randn(2, 1, s, s) * 4).astype(np.float32)
    else:
        b = None
    return q, k, v, b


@pytest.mark.parametrize("bias", [None, "key", "3d"])
@pytest.mark.parametrize("s", [120, 200])
def test_flash_mha_matches_jax(s, bias):
    """S = 120 and 200 pad to one and two 128-blocks in the JAX wrapper."""
    q, k, v, b = _qkv_bias(s, bias)
    scale = 1.0 / 32 ** 0.5
    want = np.asarray(jattn.flash_mha(
        *map(jnp.asarray, (q, k, v)), None if b is None else jnp.asarray(b),
        sm_scale=scale))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tb = None if b is None else torch.from_numpy(b)
    got = flash_mha(tq, tk, tv, tb, sm_scale=scale)
    assert got.shape == (2, 2, s, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if bias == "3d":
        # the einsum order (bias after the scale) misses the tolerance
        wrong = einsum_mha(tq, tk, tv, tb, sm_scale=scale).numpy()
        assert np.abs(wrong - want).max() > 100 * ATOL


def test_flash_is_einsum_with_a_scaled_bias():
    q, k, v, b = map(lambda a: torch.from_numpy(a) if a is not None else a,
                     _qkv_bias(70, "3d", seed=1))
    scale = 0.125
    np.testing.assert_allclose(
        flash_mha(q, k, v, b, sm_scale=scale).numpy(),
        einsum_mha(q, k, v, b * scale, sm_scale=scale).numpy(), rtol=0,
        atol=ATOL)


def test_flash_bias_cast_and_guards():
    """The bias is cast to q.dtype before it is added (bf16 here); a row
    whose scores are all −inf comes out 0 (the library's
    ``l_next_inv_safe``)."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv_bias(9, None, 2)[:3])
    bias = torch.linspace(-3.01, 2.99, 9)[None, None, None]
    assert not torch.equal(bias.bfloat16().float(), bias)
    got = flash_mha(q, k, v, bias, sm_scale=0.5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, flash_mha(q, k, v, bias.bfloat16(), sm_scale=0.5))
    dead = torch.zeros(2, 1, 9, 9)
    dead[0, 0, 4] = float("-inf")
    got = flash_mha(q.float(), k.float(), v.float(), dead, sm_scale=0.5)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0, :, 4], torch.zeros_like(got[0, :, 4]))


@pytest.fixture(scope="module")
def flash_case():
    """Tiny Oscar configs under ``attention_impl="flash"`` (one per
    package), reference-layout weights and a batch with masked keys."""
    kw = dict(vocab_size=160, img_feature_dim=20, attention_impl="flash")
    jcfg, cfg = jax_tiny_bert_config(**kw), tiny_bert_config(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    sd = jconv.random_oscar_state_dict(jcfg, seed=7)
    jparams = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    rng = np.random.RandomState(3)
    n, t, r = 3, 12, 5
    ids = rng.randint(1, 160, (n, t)).astype(np.int32)
    seg = (rng.rand(n, t) > 0.5).astype(np.int32)
    mask = np.ones((n, t + r), np.int32)
    mask[1, 9:] = 0
    mask[2, t + 2:] = 0
    feats = rng.randn(n, r, 20).astype(np.float32)
    pos = np.asarray([3, 0, 7], np.int32)
    return (jcfg, cfg), sd, jparams, (ids, seg, mask, feats, pos)


def test_rec_mlm_cpt_flash_matches_jax(flash_case, monkeypatch):
    """Every layer's attention core goes through ``flash_mha`` (and never
    through K3's wrapper), and the logits at [MASK] match the JAX model."""
    (jcfg, cfg), sd, jparams, inputs = flash_case
    model = JaxRec(jcfg, dtype=jnp.float32)
    _, want = jax.jit(lambda p, *a: model.apply(p, *a[:3], img_feats=a[3],
                                                mask_pos=a[4]))(
        jparams, *map(jnp.asarray, inputs))
    calls = []

    def counting_flash(*a, **kw):
        calls.append(a[0].shape)
        return flash_mha(*a, **kw)

    def no_k3(*a, **kw):
        raise AssertionError("K3 ran under attention_impl='flash'")

    monkeypatch.setattr(bert_model, "flash_mha", counting_flash)
    monkeypatch.setattr(bert_model, "fused_attention_block", no_k3)
    port = REC_MLM_CPT(cfg, torch.float32).eval()
    port.load_state_dict(bconv.state_from_reference(sd, cfg))
    ids, seg, mask, feats, pos = map(torch.from_numpy, inputs)
    with torch.inference_mode():
        _, got = port(ids, seg, mask, img_feats=feats, mask_pos=pos)
    assert calls == [(3, 4, 17, 8)] * cfg.num_hidden_layers
    assert got.shape == (3, 160)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["mask_3d", "head_mask"])
def test_bert_img_model_flash_cases_match_jax(flash_case, case):
    """A 3-D attention mask goes to flash as a [B, 1, S, S] bias; a head
    mask sends the layer to the einsum path (as in the JAX module)."""
    (jcfg, cfg), sd, jparams, (ids, seg, mask, feats, _) = flash_case
    rng = np.random.RandomState(11)
    n, s = mask.shape
    kw = {}
    if case == "mask_3d":
        mask = (rng.rand(n, s, s) > 0.3).astype(np.int32)
    else:
        kw["head_mask"] = rng.rand(cfg.num_hidden_layers, 1,
                                   cfg.num_attention_heads, 1, 1
                                   ).astype(np.float32)
    want, _ = JaxBert(jcfg, dtype=jnp.float32).apply(
        {"params": jparams["params"]["bert"]},
        *map(jnp.asarray, (ids, seg, mask)), img_feats=jnp.asarray(feats),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    model = BertImgModel(cfg, torch.float32).eval()
    state = bconv.state_from_reference(sd, cfg)
    model.load_state_dict({k[len("bert."):]: v for k, v in state.items()
                           if k.startswith("bert.")})
    with torch.inference_mode():
        got, _ = model(torch.from_numpy(ids), torch.from_numpy(seg),
                       torch.from_numpy(mask), img_feats=torch.from_numpy(feats),
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_build_resident_with_flash_answers_as_auto(tmp_path):
    """``build_resident(..., attention_impl="flash")`` (the tool's
    counterpart of ``replace(OSCAR_BASE, attention_impl="flash")``) picks
    the box the default resident picks, with the same candidate scores."""
    img = np.random.RandomState(4).randint(0, 256, (48, 60, 3)).astype(np.uint8)
    dets = [[4, 4, 30, 30], [32, 8, 58, 40], [1, 20, 20, 55]]
    out = {}
    for impl in ("auto", "flash"):
        res = cpt_predict.build_resident(
            "cpu", torch.float32, tiny=True, seed=3, hidden_size=32,
            num_hidden_layers=2, attention_impl=impl)
        assert res.bert_cfg.attention_impl == impl
        wd = tmp_path / impl
        box = cpt_predict.predict(res, img, "the dog on the left", dets,
                                  workdir=str(wd))
        out[impl] = box, cpt_predict.candidate_scores(res, str(wd))
    assert out["flash"][0] == out["auto"][0] in dets
    np.testing.assert_allclose(out["flash"][1], out["auto"][1], rtol=1e-4)
