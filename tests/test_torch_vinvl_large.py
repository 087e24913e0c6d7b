"""VinVL_L (``--model_size large``: OSCAR_LARGE, 24 × 1024, 16 heads, FFN
4096) and the kernel widths the JAX gates send to their Pallas kernels, on
the CPU in f32 against the JAX package.

* ``run_vqa.main`` and ``refcoco_cpt.main`` with ``--model_size large`` at
  full width, cut to ``--num_hidden_layers 2``: one Oscar-layout checkpoint
  into both packages (run_vqa's fresh head drawn by flax and carried over
  with ``params_from_jax``), dropout off in both (their generators differ);
  the first step's loss, the eval logits (refcoco_cpt: the predictions and
  the accuracy) and the trained parameters. The JAX ``refcoco_cpt`` has no
  ``--model_size`` flag: its ``model_config`` is set to the same geometry.
* K3's and K4's JAX kernels (``fused_attention_block``, ``fused_ffn``) in
  TPU interpret mode against the port's blocks (their plain versions here)
  at hidden / heads that the JAX gate takes and the port's kernels did not:
  head_dims 32, 24, 80, 128, 128 and 512, hidden sizes past 1024.
* the JAX ``flash_mha`` (the library's forward and backward in interpret
  mode) against the port's K6 / K6b / K6c plain versions at head_dim 80 and
  256.
* the kernels' path rules as pure functions: every head_dim and every
  LayerNorm width the gates take maps to a path.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config import bert as jbert
from cpt_tpu.data import vqa as jvqa
from cpt_tpu.data.synthetic import generate_refcoco_fixture
from cpt_tpu.engine import train as jtrain
from cpt_tpu.models.bert import heads as jheads
from cpt_tpu.ops import fused_attention as jfa
from cpt_tpu.ops import fused_ffn as jff
from cpt_tpu.tools import _common as jcommon
from cpt_tpu.tools import refcoco_cpt as jrefcoco_cpt
from cpt_tpu.tools import run_vqa as jrun_vqa
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.config import bert as pbert
from cpt_tpu_torch.data import vqa
from cpt_tpu_torch.engine import train as ptrain
from cpt_tpu_torch.kernels.build import KernelError
from cpt_tpu_torch.kernels.gemm import attention_path, ln_gemm_path
from cpt_tpu_torch.ops.attention import flash_mha, reference_flash_mha_bwd
from cpt_tpu_torch.ops.fused_attention import fused_attention_block
from cpt_tpu_torch.ops.fused_ffn import fused_ffn
from cpt_tpu_torch.tools import _common
from cpt_tpu_torch.tools import refcoco_cpt, run_vqa
from cpt_tpu_torch.utils import convert as bconv
from test_torch_flash_bwd import _jax_grads, _inputs
from test_torch_oscar_data import D, fixture_paths
from test_torch_oscar_runners import JitSpy, jax_logits, no_dropout, tokenizers
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(300)

LARGE = ["--model_size", "large", "--num_hidden_layers", "2", "--dtype",
         "float32"]
# f32 at full width, 2 layers: summation order only. Eval logits of the
# sequence classifier as a fraction of the largest |logit|; a step's loss
# (nats) and the trained parameters absolutely (a few AdamW steps from the
# same tree move them by ~lr)
LOGIT_TOL = 2e-4
LOSS_ATOL = 1e-4
PARAM_ATOL = 1e-4
# the fused blocks' post-LN outputs (O(1)) at hidden up to 2048 and FFN
# widths up to 8192: f32 sums of as many terms in other orders
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)
# the flash forward and backward in f32 through the same formulas (outputs
# and gradients O(1), d up to 256)
FLASH_ATOL = 2e-5
# hidden, heads → head_dim: 32, 24, 80, 128, 128, 512
WIDTHS = [(128, 4), (384, 16), (1280, 16), (1536, 12), (2048, 16), (512, 1)]


def test_oscar_large_is_the_jax_geometry():
    """OSCAR_LARGE field by field, and ``--model_size large`` through both
    packages' ``_common.model_config``; the port's refcoco_cpt builds the
    same geometry."""
    assert dataclasses.asdict(pbert.OSCAR_LARGE) == dataclasses.asdict(
        jbert.OSCAR_LARGE)
    assert (pbert.OSCAR_LARGE.hidden_size, pbert.OSCAR_LARGE.num_hidden_layers,
            pbert.OSCAR_LARGE.num_attention_heads,
            pbert.OSCAR_LARGE.intermediate_size) == (1024, 24, 16, 4096)
    for flags in ([], ["--num_hidden_layers", "2"], ["--hidden_size", "1280"]):
        argv = ["--model_size", "large"] + flags
        want = jcommon.model_config(jrun_vqa.build_args().parse_args(argv))
        got = _common.model_config(run_vqa.build_args().parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    args = refcoco_cpt.build_args().parse_args(
        ["--data_file", "d", "--ann_file", "a", "--det_file", "t",
         "--model_size", "large"])
    assert dataclasses.asdict(refcoco_cpt.model_config(args)) == \
        dataclasses.asdict(jbert.OSCAR_LARGE)


def test_attention_path_takes_every_head_dim():
    """K3's core and K6 / K6b / K6c: the tile at every multiple of 8 up to
    256, the CUDA-core kernel at every other head_dim from 1 to 512; none
    refused."""
    for head_dim in range(1, 513):
        want = "mma" if head_dim % 8 == 0 and head_dim <= 256 else "simt"
        assert attention_path(head_dim) == want, head_dim


def test_ln_gemm_path_takes_every_width_the_gate_takes():
    """The row-LayerNorm GEMM: a cluster up to N 1024, the split path past
    it, every multiple of 128 up to 8192; a width off 128 (which the JAX
    gate sends to no kernel either) raises ``KernelError``."""
    for n in range(128, 8192 + 1, 128):
        assert ln_gemm_path(n) == ("cluster" if n <= 1024 else "split")
    for n in (0, 64, 1000, 1290):
        with pytest.raises(KernelError):
            ln_gemm_path(n)


def _attn_inputs(b, s, h, seed):
    """K3's inputs, ~20% of the keys masked. No sequence is wholly masked
    (``test_torch_fused_blocks.py`` holds that case at hidden 64): near the
    −10000 shift f32 resolves a score to ~1e-3, and at these widths the two
    packages' orders of operations (the JAX kernel scales, the reference
    divides) then differ by ~1.6e-4 in the post-LN output."""
    rng = np.random.RandomState(seed)
    kb = np.where(rng.rand(b, s) > 0.2, 0.0, -10000.0).astype(np.float32)
    return [(rng.randn(b, s, h) * 0.5).astype(np.float32),
            (rng.randn(h, 3 * h) * 1.5 / h ** 0.5).astype(np.float32),
            (rng.randn(3 * h) * 0.02).astype(np.float32),
            (rng.randn(h, h) / h ** 0.5).astype(np.float32),
            (rng.randn(h) * 0.02).astype(np.float32),
            (rng.rand(h) + 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32), kb]


@functools.lru_cache(maxsize=None)
def _jax_attention_block(h, heads):
    args = _attn_inputs(2, 40, h, seed=h + heads)
    out = run_interpret(
        lambda *a: jfa.fused_attention_block(*a, heads, 1e-12, 1),
        *map(jnp.asarray, args))
    return args, out


@pytest.mark.parametrize("h,heads", WIDTHS)
def test_attention_block_matches_kernel_at_wide_and_odd_heads(h, heads):
    """K3 at hidden / heads where the port's launchers used to stop (head_dim
    ≠ 64, hidden > 1024): the port's block equals the JAX Pallas kernel."""
    args, want = _jax_attention_block(h, heads)
    got = fused_attention_block(*map(torch.from_numpy, args), heads,
                                1e-12).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


def _ffn_inputs(m, h, f, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(m, h) * 0.5).astype(np.float32),
            (rng.randn(h, f) / h ** 0.5).astype(np.float32),
            (rng.randn(f) * 0.1).astype(np.float32),
            (rng.randn(f, h) / f ** 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32),
            (rng.rand(h) + 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("h", sorted({h for h, _ in WIDTHS}))
def test_ffn_matches_kernel_past_1024(h):
    """K4 at the same hidden sizes, FFN 4 × hidden: the row LayerNorm over
    up to 2048 columns (the split path's widths on the card)."""
    args = _ffn_inputs(48, h, 4 * h, seed=h)
    want = run_interpret(lambda *a: jff.fused_ffn(*a), *map(jnp.asarray, args))
    got = fused_ffn(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, **BLOCK_TOL)


@functools.lru_cache(maxsize=None)
def _flash_case(d, bias):
    """``test_torch_flash_bwd._inputs`` at head_dim d, the key bias's second
    sequence masked as its first rather than wholly (at d = 80 the scale is
    not a power of two, and f32's ~1e-4 resolution of the wholly masked
    row's scores near −10000 · scale moves its outputs by ~6e-5 between the
    two packages' orders of operations). S 100: one block of the library's
    128, its last 28 keys padded."""
    q, k, v, do, b = _inputs(100, bias, seed=d, d=d)
    if bias == "key":
        b[1] = b[0]
    scale = 1.0 / d ** 0.5
    from cpt_tpu.ops import attention as jattn

    out = run_interpret(lambda *a: jattn.flash_mha(*a, sm_scale=scale),
                        q, k, v, b)
    return (q, k, v, do, b), scale, out, _jax_grads(q, k, v, do, b, scale)


@pytest.mark.parametrize("d", [80, 256])
@pytest.mark.parametrize("bias", ["key", "3d"])
def test_flash_matches_jax_at_head_dims_80_and_256(d, bias):
    """K6's plain forward and K6b / K6c's plain backward (what the card's
    kernels are held to) against the library's kernels at head_dim 80 (the
    tile of 80, an odd pitch in shared memory) and 256 (its largest)."""
    (q, k, v, do, b), scale, want_o, want_g = _flash_case(d, bias)
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, do, b))
    got = flash_mha(tq, tk, tv, tb, sm_scale=scale)
    np.testing.assert_allclose(got.numpy(), want_o, rtol=0, atol=FLASH_ATOL)
    grads = reference_flash_mha_bwd(tq, tk, tv, tb, tdo, sm_scale=scale)
    for name, g, w in zip("qkv", grads, want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=FLASH_ATOL,
                                   err_msg=name)


class LossSpy(JitSpy):
    """``JitSpy`` that also records the loss each call of the runner's
    jitted train step (``step_raw``) returns."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def jit(self, fn, **kw):
        if fn.__name__ != "step_raw":
            return super().jit(fn, **kw)
        jitted = jax.jit(fn, **kw)

        def call(*a):
            state, loss = jitted(*a)
            self.losses.append(float(loss))
            return state, loss
        return call


def _large_checkpoint(root, feature_dim: int) -> str:
    """An Oscar-layout checkpoint at VinVL_L's width, 2 layers, in root."""
    args = jrun_vqa.build_args().parse_args(
        LARGE + ["--img_feature_dim", str(feature_dim)])
    path = str(root / "oscar.pth")
    torch.save({k: torch.from_numpy(v) for k, v in jconv.random_oscar_state_dict(
        jcommon.model_config(args), seed=25).items()}, path)
    return path


def test_run_vqa_large_matches_jax(tmp_path, monkeypatch):
    """``run_vqa.main --model_size large`` (1 epoch of 2 steps, batch 4,
    bce): the first step's loss, the VQA score and results, the eval logits
    on the questions and the trained parameters."""
    monkeypatch.setattr(jrun_vqa, "model_config",
                        no_dropout(jrun_vqa.model_config))
    monkeypatch.setattr(run_vqa, "model_config", no_dropout(run_vqa.model_config))
    trees, built, losses = [], [], []
    real_init = jrun_vqa.load_or_init
    monkeypatch.setattr(jrun_vqa, "load_or_init", lambda *a, **kw: trees.append(
        real_init(*a, **kw)) or trees[-1])
    spy = LossSpy()
    monkeypatch.setattr(jrun_vqa, "jax", spy)
    real_build, real_train = run_vqa.build_model, run_vqa.train

    def build(*a):
        model = real_build(*a)
        model.load_state_dict(bconv.params_from_jax(trees[-1], model.config,
                                                    model.TASK))
        built.append(model)
        return model

    def train(*a, **kw):
        return real_train(*a, on_step=lambda step, loss: losses.append(loss),
                          **kw)

    monkeypatch.setattr(run_vqa, "build_model", build)
    monkeypatch.setattr(run_vqa, "train", train)
    p = fixture_paths()
    argv = ["--feat_file", p["feat_file"], "--examples", p["vqa"],
            "--num_labels", "5", "--max_seq_length", "16",
            "--max_img_seq_length", "6", "--per_gpu_train_batch_size", "4",
            "--per_gpu_eval_batch_size", "4", "--num_train_epochs", "1",
            "--loss_type", "bce", "--learning_rate",
            "1e-4", "--img_feature_dim", str(D), "--checkpoint",
            _large_checkpoint(tmp_path, D)] + LARGE
    want = jrun_vqa.main(argv + ["--output", str(tmp_path / "jax.pk")])
    got = run_vqa.main(argv + ["--device", "cpu", "--output",
                               str(tmp_path / "port.pk")])
    model = built[-1]
    assert model.config.hidden_size == 1024 and len(model.bert.encoder.layer) == 2
    assert model.config.num_attention_heads == 16
    assert model.config.intermediate_size == 4096
    assert len(losses) == len(spy.losses) == 2
    np.testing.assert_allclose(losses, spy.losses, rtol=0, atol=LOSS_ATOL)
    assert got == want and np.isfinite(got)
    want_params = bconv.params_from_jax(spy.params[-1], model.config,
                                        model.TASK)
    gaps = {k: float((t - torch.as_tensor(want_params[k])).abs().max())
            for k, t in model.state_dict().items()}
    assert max(gaps.values()) <= PARAM_ATOL, sorted(gaps.items(),
                                                    key=lambda kv: -kv[1])[:3]
    jt, pt = tokenizers()
    jdata = jvqa.VQAData(p["feat_file"], jvqa.load_vqa_examples(p["vqa"]), 5,
                         jt, 16, 6, D)
    data = vqa.VQAData(p["feat_file"], vqa.load_vqa_examples(p["vqa"]), 5,
                       pt, 16, 6, D)
    jcfg = jrun_vqa.model_config(jrun_vqa.build_args().parse_args(
        LARGE + ["--img_feature_dim", str(D)]), num_labels=5)
    jmodel = jheads.ImageBertForSequenceClassification(jcfg, dtype=jnp.float32)
    batches = []
    for idx in ([0, 1, 2, 3], [4, 5, 6, 7], [8, 9]):
        b = jdata.batch(idx)[0]
        batches.append((b.input_ids, b.segment_ids, b.attention_mask,
                        b.img_feats))
    _, _, logits = run_vqa.evaluate(model, data, 4)
    want_logits = jax_logits(jmodel, spy.params[-1], batches)
    assert logits.shape == want_logits.shape
    assert float(np.abs(logits - want_logits).max()) <= LOGIT_TOL * float(
        np.abs(want_logits).max())


def test_refcoco_cpt_large_matches_jax(tmp_path, monkeypatch):
    """``refcoco_cpt.main --model_size large``: one prompt-tuning step
    (batch 8 over 4 queries × 3 copies) then the scoring of one eval batch
    of 12 sequences, against the JAX tool at the same geometry: the step's
    loss, the accuracy and every query's prediction."""
    (tmp_path / "fixture").mkdir()
    p = generate_refcoco_fixture(str(tmp_path / "fixture"), n_queries=4,
                                 n_copies=3, n_objects=4, feat_dim=134)
    large = dataclasses.replace(jbert.OSCAR_LARGE, num_hidden_layers=2,
                                img_feature_dim=134, hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)
    monkeypatch.setattr(jrefcoco_cpt, "model_config", lambda args: large)
    monkeypatch.setattr(refcoco_cpt, "model_config",
                        no_dropout(refcoco_cpt.model_config))
    steps = {"jax": [], "port": []}
    for pkg, lib in (("jax", jtrain), ("port", ptrain)):
        real = lib.make_mlm_train_step

        def make(*a, real=real, out=steps[pkg], **kw):
            step = real(*a, **kw)

            def run(*b, **kwb):
                state, loss = step(*b, **kwb)
                out.append(float(loss))
                return state, loss
            return run
        monkeypatch.setattr(lib, "make_mlm_train_step", make)
    ckpt = tmp_path / "oscar.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(large, seed=25).items()}, ckpt)
    argv = ["--data_file", p["data_file"], "--ann_file", p["ann_file"],
            "--det_file", p["det_file"], "--train_data_file", p["data_file"],
            "--img_feature_dim", "134", "--num_hidden_layers", "2",
            "--txt_seq_len", "24", "--img_seq_len", "6",
            "--per_gpu_eval_batch_size", "12", "--per_gpu_train_batch_size",
            "8", "--num_train_epochs", "1", "--learning_rate", "1e-4",
            "--dtype", "float32", "--checkpoint", str(ckpt)]
    want = jrefcoco_cpt.main(argv + ["--output", str(tmp_path / "jax.json")])
    got = refcoco_cpt.main(argv + ["--model_size", "large", "--device", "cpu",
                                   "--output", str(tmp_path / "port.json")])
    assert refcoco_cpt.model_config(refcoco_cpt.build_args().parse_args(
        argv + ["--model_size", "large"])).hidden_size == 1024
    assert len(steps["port"]) == len(steps["jax"]) >= 1
    np.testing.assert_allclose(steps["port"], steps["jax"], rtol=0,
                               atol=LOSS_ATOL)
    assert got == want
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(g)["predictions"] == json.load(f)["predictions"]


def _ln_inputs(m, n, seed):
    """Pre-LN rows whose 128-column slices have different means (as the
    card's LN GEMM check draws its bias), gamma, beta."""
    import chip_smoke as cs

    rng = np.random.RandomState(seed)
    y = rng.randn(m, n) * 0.8 + cs.slice_offsets(rng, n)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        y, rng.rand(n) + 0.5, rng.randn(n) * 0.1)]


@pytest.mark.parametrize("n", [1024, 1280, 4096])
def test_split_ln_merge_is_the_layer_norm_and_its_faults_miss(n):
    """The split LN path's merge of per-tile statistics (Chan's formula, as
    ``csrc/gemm.cu``'s row kernel forms it) is the fused kernels' LayerNorm
    ``E[(y−μ)²]``; the named faults of phase 22 (the last tile's statistics
    dropped; on the cluster path every rank reading rank 0's sums) miss
    ``TOL["K4 LN GEMM"]`` of the output's scale."""
    import chip_smoke as cs
    from cpt_tpu_torch.ops.fused_attention import layer_norm_f32

    y, gamma, beta = _ln_inputs(64, n, seed=n)
    want = layer_norm_f32(y, gamma, beta, 1e-12)
    np.testing.assert_allclose(cs.ln_tile_merge(y, gamma, beta, 1e-12).numpy(),
                               want.numpy(), rtol=0, atol=2e-5)
    tol = cs.TOL["K4 LN GEMM"] * float(want.abs().max())
    for fault in (cs.ln_tile_stats_dropped, cs.ln_rank0_sums, cs.ln_slice_stats):
        assert float((fault(y, gamma, beta, 1e-12) - want).abs().max()) > tol


@pytest.mark.parametrize("d,heads", [(24, 16), (40, 4), (88, 2)])
def test_pad_not_zeroed_misses_on_the_padded_tile(d, heads):
    """On the zero-padded tile (head_dim a multiple of 8, not of 16) the
    pad chunk read from memory instead of zeroed (``pad_not_zeroed``) misses
    ``TOL["K3 core"]``, at the card check's projection of std 1.5; where
    the 8 columns after each head are zero it is the attention core
    itself."""
    import chip_smoke as cs
    from cpt_tpu_torch.ops.fused_attention import reference_attention_core

    g = torch.Generator().manual_seed(d)
    qkv = torch.randn(2, 70, 3 * d * heads, generator=g) * 1.5
    kb = torch.where(torch.rand(2, 70, generator=g) > 0.3, 0.0, -10000.0)
    scale = d ** -0.5
    want = reference_attention_core(qkv, kb, heads, scale)
    got = cs.core_pad_not_zeroed(qkv, kb, heads, scale)
    tol = cs.TOL["K3 core"] * float(want.abs().max())
    assert float((got - want).abs().max()) > 3 * tol
    # each head's first 8 columns zero: the pad (the next head's first 8
    # columns, or the next part's) then adds nothing
    masked = qkv.clone().unflatten(-1, (3, heads, d))
    masked[..., :8] = 0
    masked = masked.flatten(-3)
    np.testing.assert_allclose(
        cs.core_pad_not_zeroed(masked, kb, heads, scale).numpy(),
        reference_attention_core(masked, kb, heads, scale).numpy(),
        rtol=0, atol=1e-5)


def test_phase22_dry_run(monkeypatch):
    """``chip_smoke.run_vinvl_large`` at the tiny size on the CPU (hidden
    512, 2 layers; the widths at 1 layer): every reading is taken, the f32
    paths sit within the tolerances, each named fault misses them, and only
    the kernel-launch checks fail (no card)."""
    import ast

    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    with pytest.raises(AssertionError) as e:
        cs.run_vinvl_large(cs.kernel_counters(), "cpu", [], torch.device("cpu"),
                           tiny=True)
    failures = ast.literal_eval(e.value.args[0][len("phase 22: "):])
    assert len(failures) == 6 and all("launches" in f for f in failures), failures


def test_cached_random_weights_are_the_draws():
    """``chip_smoke.cached_random_weights``, which lets ``chip_smoke.py``
    draw each random encoder once: an Oscar draw of fewer layers served from
    a deeper one of the same geometry and seed, and an X152 draw shared by
    configs that differ only in what the draw does not read (the conv
    body's precision), equal the package's own draws; another seed, and a
    discrete-code model (its code table is drawn after the layers), draw
    anew."""
    import chip_smoke as cs
    from cpt_tpu_torch.models.detector import convert as dconv
    from cpt_tpu_torch.models.detector.config import tiny_detector_config

    real_oscar, real_vinvl = bconv.random_oscar_state_dict, dconv.random_vinvl_state_dict
    deep = dataclasses.replace(pbert.OSCAR_BASE, hidden_size=32,
                               intermediate_size=64, num_hidden_layers=4,
                               vocab_size=50, img_feature_dim=6)
    shallow = dataclasses.replace(deep, num_hidden_layers=2)
    codes = dataclasses.replace(deep, img_feature_type="dis_code", code_voc=5,
                                code_dim=3)
    codes2 = dataclasses.replace(codes, num_hidden_layers=2)
    tiny = tiny_detector_config()
    int8 = dataclasses.replace(tiny, backbone=dataclasses.replace(
        tiny.backbone, precision="int8"))
    asks = [("oscar", deep, 3), ("oscar", shallow, 3), ("oscar", shallow, 4),
            ("oscar", codes, 3), ("oscar", codes2, 3), ("vinvl", tiny, 0),
            ("vinvl", int8, 0)]
    with cs.cached_random_weights() as log:
        got = [(bconv.random_oscar_state_dict if kind == "oscar" else
                dconv.random_vinvl_state_dict)(cfg, seed=seed)
               for kind, cfg, seed in asks]
    assert len(log) == 5, log
    assert bconv.random_oscar_state_dict is real_oscar
    assert dconv.random_vinvl_state_dict is real_vinvl
    for sd, (kind, cfg, seed) in zip(got, asks):
        want = (real_oscar if kind == "oscar" else real_vinvl)(cfg, seed)
        assert list(sd) == list(want)
        assert all(np.array_equal(sd[k], want[k]) for k in want), (kind, seed)
