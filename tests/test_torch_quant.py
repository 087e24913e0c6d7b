"""The W8A8 int8 path of the port against the JAX package on the CPU, in
f32: ``ops/quant.py`` (quantizers, ``int8_conv``, ``int8_matmul``, K7's
plain version against ``bench_int8.py``'s own Pallas kernel in interpret
mode), the tiny detector at ``precision="int8"`` and ``"int8:0.05"``
(``ResNetC4`` and force-boxes extraction), its weights quantized from f32,
and ``tools/extract_features --precision int8`` against the JAX tool on the
same checkpoint.

JAX runs its models under ``jit``, where XLA rewrites ``amax / 127`` into
``amax · (1/127)``; the port divides, as the JAX source (and eager JAX)
does. The model-level tests compare with the jitted package and stay at
1e-5 of scale: at these sizes no quantization tie flips."""
import ast
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cpt_tpu.data.prompts import REFCOCO_COLORS as JAX_REFCOCO_COLORS
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector.attr_rcnn import AttrRCNN as JaxRCNN
from cpt_tpu.models.detector.convert import (convert_detector_state_dict,
                                             random_vinvl_state_dict)
from cpt_tpu.models.detector.resnet import ResNetC4 as JaxResNetC4
from cpt_tpu.ops import quant as jquant
from cpt_tpu.ops.fused_ffn import _gelu
from cpt_tpu_torch.data.prompts import REFCOCO_COLORS
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.models.detector import convert as dconv
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.models.detector.resnet import ResNetC4
from cpt_tpu_torch.ops import quant
from cpt_tpu_torch.ops.grouped_conv import (exact_conv,
                                            reference_grouped_conv3x3_int8)
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_watchdog import guards, run_interpret

REPO = Path(__file__).resolve().parent.parent
PRECISIONS = ["int8", "int8:0.05"]
guard_module, guard_case = guards(300)


def _rel(got, want) -> float:
    """max |got − want| as a fraction of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# --- ops/quant.py against cpt_tpu/ops/quant.py ---------------------------------

@pytest.mark.parametrize("scale", [None, 0.03])
def test_quant_act_matches(scale):
    x = (np.random.RandomState(0).randn(2, 7, 9, 16) * 3).astype(np.float32)
    want = jquant.quant_act(jnp.asarray(x),
                            None if scale is None else jnp.float32(scale))
    got = quant.quant_act(_t(x), scale)
    assert got.data.dtype == torch.int8
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert float(got.scale) == float(want.scale)


@pytest.mark.parametrize("shape,axes", [((3, 3, 8, 32), (0, 1, 2)),
                                        ((1, 1, 16, 24), (0, 1, 2)),
                                        ((48, 40), (0,))])
def test_quant_weight_matches(shape, axes):
    w = (np.random.RandomState(1).randn(*shape) * 0.05).astype(np.float32)
    want = jquant.quant_weight(jnp.asarray(w), axes)
    got = quant.quant_weight(_t(w), axes)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


# (kernel, cin, cout, stride, padding, groups): the body's 1×1, the
# downsample's strided 1×1, the grouped 3×3 at stride 1 and 2, the stem
CONVS = [(1, 16, 24, 1, 0, 1), (1, 16, 32, 2, 0, 1), (3, 32, 32, 1, 1, 4),
         (3, 32, 32, 2, 1, 8), (7, 3, 16, 2, 3, 1)]


@pytest.mark.parametrize("kernel,cin,cout,stride,padding,groups", CONVS)
def test_int8_conv_matches(kernel, cin, cout, stride, padding, groups):
    rng = np.random.RandomState(kernel + stride + groups)
    x = rng.randn(2, 11, 13, cin).astype(np.float32)
    w = (rng.randn(kernel, kernel, cin // groups, cout) * 0.1).astype(np.float32)
    s = (rng.rand(cout) + 0.5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    want = np.asarray(jquant.int8_conv(
        jquant.quant_act(jnp.asarray(x)), jnp.asarray(w), stride, padding,
        groups, jnp.asarray(s), jnp.asarray(b), relu=True,
        out_dtype=jnp.float32))
    got = quant.int8_conv(quant.quant_act(_t(x)), _t(w), stride, padding,
                          groups, _t(s), _t(b), relu=True,
                          out_dtype=torch.float32)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-6


def test_int8_matmul_matches():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 6, 40).astype(np.float32)
    w = (rng.randn(40, 24) * 0.05).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    want = np.asarray(jquant.int8_matmul(jquant.quant_act(jnp.asarray(x)),
                                         jnp.asarray(w), jnp.asarray(b),
                                         out_dtype=jnp.float32))
    got = quant.int8_matmul(quant.quant_act(_t(x)), _t(w), _t(b),
                            out_dtype=torch.float32)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("kernel,cin,cout,stride,padding,groups",
                         [c for c in CONVS if c[5] == 1])
def test_int_mm_conv_is_exact(kernel, cin, cout, stride, padding, groups):
    """The card's dense route (subsample or im2col, K padded to a multiple
    of 8, one ``_int_mm``) on the CPU's ``_int_mm``: the exact conv."""
    rng = np.random.RandomState(5)
    xq = _t(rng.randint(-127, 128, (2, 11, 13, cin)).astype(np.int8))
    wq = _t(rng.randint(-127, 128, (kernel, kernel, cin, cout)).astype(np.int8))
    torch.testing.assert_close(quant.int_mm_conv(xq, wq, stride, padding),
                               exact_conv(xq, wq, stride, padding), rtol=0, atol=0)


def test_int_mm_refuses_what_the_library_refuses():
    a = torch.zeros(16, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="M > 16"):
        quant.int_mm(a, torch.zeros(32, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int_mm(torch.zeros(32, 12, dtype=torch.int8),
                     torch.zeros(12, 8, dtype=torch.int8))


def test_grouped_conv_int8_plain_is_exact():
    """K1q's plain version against an int64 sum of the same products."""
    rng = np.random.RandomState(6)
    n, h, w, c, groups = 2, 6, 7, 16, 4
    xq = rng.randint(-127, 128, (n, h, w, c)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, c // groups, c)).astype(np.int8)
    scale = (rng.rand(c) * 1e-3).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    got = reference_grouped_conv3x3_int8(_t(xq), _t(wq), _t(scale), _t(bias),
                                         groups, 2, False, torch.float32)
    xp = np.pad(xq.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    cpg = c // groups
    acc = np.zeros((n, 3, 4, c), np.int64)
    for ky in range(3):
        for kx in range(3):
            patch = xp[:, ky:ky + 5:2, kx:kx + 7:2]
            for co in range(c):
                g0 = (co // cpg) * cpg
                acc[..., co] += patch[..., g0:g0 + cpg] @ wq[ky, kx, :, co].astype(np.int64)
    want = acc.astype(np.float32) * scale + bias
    np.testing.assert_array_equal(got.numpy(), want)


def test_precision_strings():
    assert quant.static_scale("int8:0.05") == 0.05
    assert quant.static_scale("int8") is None
    assert quant.is_int8("int8") and quant.is_int8("int8:2") and not quant.is_int8("bf16")
    with pytest.raises(ValueError):
        quant.is_int8("fp8")
    assert REFCOCO_COLORS == JAX_REFCOCO_COLORS


# --- the tiny detector at int8 ---------------------------------------------------

def _cfg(module, precision):
    """One package's tiny detector config at ``precision``, 4-slot head chunks."""
    c = module.tiny_detector_config()
    return dataclasses.replace(
        c, backbone=dataclasses.replace(c.backbone, precision=precision),
        roi_heads=dataclasses.replace(c.roi_heads, head_chunk=4))


@functools.lru_cache(maxsize=None)
def _inputs():
    sd = random_vinvl_state_dict(jdet_cfg.tiny_detector_config(), seed=3)
    rng = np.random.RandomState(0)
    images = (rng.rand(3, 64, 64, 3) * 255 - 120).astype(np.float32)
    boxes = np.asarray([[2, 3, 40, 50], [10, 10, 60, 30], [0, 0, 63, 63],
                        [30, 5, 45, 20], [5, 40, 25, 62], [1, 1, 3, 3],
                        [20, 20, 52, 61], [0, 0, 0, 0]], np.float32)
    valid = np.asarray([True] * 7 + [False])
    return sd, images, boxes, valid


@pytest.fixture(scope="module")
def fixture():
    return _inputs()


@functools.lru_cache(maxsize=None)
def _jax_force(precision):
    """The jitted JAX force-boxes forward of the tiny detector on
    :func:`_inputs`, once per precision for the whole module (called from
    the cases, so each first call runs under its case's watchdog)."""
    sd, images, boxes, valid = _inputs()
    jcfg = _cfg(jdet_cfg, precision)
    model = JaxRCNN(jcfg, dtype=jnp.float32)
    params = {"params": convert_detector_state_dict(sd, jcfg)}
    out = jax.jit(lambda p, *a: model.apply(p, *a, method=model.forward_batch_force))(
        params, jnp.asarray(images), jnp.asarray([60, 62]), jnp.asarray(boxes),
        jnp.asarray(valid))
    return jax.tree_util.tree_map(np.asarray, out)


def _port_force(sd, precision, images, boxes, valid, dtype=torch.float32):
    cfg = _cfg(det_cfg, precision)
    model = AttrRCNN(cfg, dtype).eval()
    model.load_state_dict(dconv.state_from_reference(sd, cfg))
    with torch.inference_mode():
        out = model.forward_batch_force(_t(images).to(dtype), (60, 62),
                                        _t(boxes), _t(valid))
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("precision", PRECISIONS)
def test_resnet_c4_int8_matches(fixture, precision):
    sd, images, _, _ = fixture
    jcfg = _cfg(jdet_cfg, precision)
    bb = convert_detector_state_dict(sd, jcfg)["backbone"]
    jmodel = JaxResNetC4(jcfg.backbone, dtype=jnp.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": bb}, jnp.asarray(images)))
    cfg = _cfg(det_cfg, precision)
    model = ResNetC4(cfg.backbone, torch.float32).eval()
    model.load_state_dict({k[len("backbone."):]: v for k, v in
                           dconv.state_from_reference(sd, cfg).items()
                           if k.startswith("backbone.")})
    with torch.inference_mode():
        got = model(_t(images)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("precision", PRECISIONS)
def test_force_boxes_int8_matches(fixture, precision):
    sd, images, boxes, valid = fixture
    want = _jax_force(precision)
    got = _port_force(sd, precision, images, boxes, valid)
    for k in ("box_features", "scores", "scores_all"):
        assert _rel(got[k], want[k]) <= 1e-5, k
    np.testing.assert_array_equal(got["labels"], want["labels"])


def test_precision_is_honoured(fixture):
    """The repaired fault: the port's int8 detector computes W8A8 (its
    features differ from its bf16 ones by far more than the tolerance, and
    match the JAX package's int8 ones)."""
    sd, images, boxes, valid = fixture
    int8 = _port_force(sd, "int8", images, boxes, valid)["box_features"]
    bf16 = _port_force(sd, "bf16", images, boxes, valid)["box_features"]
    want = _jax_force("int8")["box_features"]
    assert _rel(bf16, want) > 100 * 1e-5
    assert _rel(int8, want) <= 1e-5


def test_int8_weights_are_quantized_from_f32(fixture):
    """A bf16 model's int8 weights and scales are JAX's ``quant_weight`` of
    the f32 parameters, bit for bit, and not a quantization of the
    bf16-rounded weights (which moves amax / 127)."""
    sd = fixture[0]
    cfg = _cfg(det_cfg, "int8")
    model = AttrRCNN(cfg, torch.bfloat16).eval()
    model.load_state_dict(dconv.state_from_reference(sd, cfg))
    tree = convert_detector_state_dict(sd, _cfg(jdet_cfg, "int8"))
    checked = differs = 0
    for name, mod in model.named_modules():
        if getattr(mod, "qdata", None) is None:
            continue
        node = tree
        for part in name.split("."):
            node = node[part]
        want = jquant.quant_weight(jnp.asarray(node["kernel"]), (0, 1, 2))
        got = mod.qweight
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data),
                                      err_msg=name)
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale),
                                      err_msg=name)
        rounded = quant.quant_weight(mod.weight.float().permute(*mod._to_hwio),
                                     (0, 1, 2))
        differs += not (torch.equal(rounded.data, got.data)
                        and torch.equal(rounded.scale, got.scale))
        checked += 1
    # the stem, 3 body blocks of 4 convs, 2 stage-5 heads of 10
    assert checked == 1 + 3 * 4 + 2 * 10
    assert differs > checked // 2


# --- K7's plain version against bench_int8.py's kernel ---------------------------

def _study(m, h, f):
    """``kern``, ``ffn_int8`` and ``qw`` from ``bench_int8.py``'s
    ``ffn_pallas_study`` (nested there), with M, H, F rebound."""
    tree = ast.parse((REPO / "bench_int8.py").read_text())
    study = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "ffn_pallas_study")
    nested = [n for n in study.body if isinstance(n, ast.FunctionDef)
              and n.name in ("kern", "ffn_int8", "qw")]
    ns = {"functools": functools, "jax": jax, "jnp": jnp, "pl": pl,
          "pltpu": pltpu, "_gelu": _gelu, "M": m, "H": h, "F": f}
    exec(compile(ast.Module(body=nested, type_ignores=[]), "bench_int8.py",
                 "exec"), ns)
    return ns


def _k7_inputs(m, h, f, seed):
    """x whose tiles' ranges differ 8×; weights whose columns' ranges differ
    8×; nonzero biases and LayerNorm parameters."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, h) * np.repeat([0.5, 4.0], m // 2)[:, None]
    w1 = rng.randn(h, f) * 0.05 * np.exp2(rng.uniform(0, 3, f))
    w2 = rng.randn(f, h) * 0.05 * np.exp2(rng.uniform(0, 3, h))
    vecs = [rng.randn(f) * 0.1, rng.randn(h) * 0.1, rng.rand(h) + 0.5,
            rng.randn(h) * 0.1]
    return [a.astype(np.float32) for a in (x, w1, w2, *vecs)]


@pytest.mark.parametrize("tm", [64, 128])
def test_ffn_int8_plain_matches_the_pallas_kernel(tm):
    """K7's plain version against ``bench_int8.py``'s kernel in interpret
    mode, at 1e-5 of scale on every row but those where an h code flips at
    a rounding tie. Under jit XLA computes h and its tile scale with other
    roundings than the source (fused multiply-adds; ``amax · f32(1/127)``
    for ``amax / 127``); one ulp apart, an h / sh that sits on a half
    rounds the other way, and its row moves by one code's worth (1.6e-3 of
    scale). At tm = 128 that happens in one row: each such row must hold an
    h / sh within 1e-5 of a half in the port's own arithmetic."""
    m, h, f = 256, 128, 512
    x, w1, w2, b1, b2, gamma, beta = _k7_inputs(m, h, f, tm)
    ns = _study(m, h, f)
    (w1q, s1), (w2q, s2) = ns["qw"](jnp.asarray(w1)), ns["qw"](jnp.asarray(w2))
    for w, (wq, s) in ((w1, (w1q, s1)), (w2, (w2q, s2))):
        got = quant.quant_ffn_weights(_t(w))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(s))
    want = run_interpret(lambda *a: ns["ffn_int8"](*a, tm), x, w1q, s1, b1, w2q,
                         s2, b2, gamma, beta)
    args = [_t(a) for a in (x, np.asarray(w1q), np.asarray(s1), b1,
                            np.asarray(w2q), np.asarray(s2), b2, gamma, beta)]
    got = quant.ffn_int8(*args, tm).numpy()
    err = np.abs(got - want).max(1) / np.abs(want).max()
    off = np.nonzero(err > 1e-5)[0]
    assert off.tolist() == ([9] if tm == 128 else []), (off, err.max())
    hid = quant.ffn_int8_hidden(args[0], args[1], args[2], args[3], tm)
    codes = (hid / (hid.abs().amax((1, 2), keepdim=True) / 127.0)).reshape(m, f)
    to_half = (codes.abs() - codes.abs().floor() - 0.5).abs().numpy()
    assert all(to_half[r].min() < 1e-5 for r in off)
    assert err[off].max(initial=0) < 4e-3        # about one code's worth
    # per-tile scales matter here: one scale for all of M misses
    whole = quant.reference_ffn_int8(*args, m).numpy()
    assert _rel(whole, want) > 100 * 1e-5


# --- tools/extract_features -------------------------------------------------------

def _rows(path):
    tsv = TSVFile(str(path))
    rows = [tsv.seek(i) for i in range(len(tsv))]
    tsv.close()
    return [(k, json.loads(v)["objects"]) for k, v in rows]


def test_extract_features_int8_matches_jax_tool(tmp_path):
    from cpt_tpu.tools import extract_features as jtool
    from cpt_tpu_torch.tools import extract_features as tool

    sd = random_vinvl_state_dict(jdet_cfg.tiny_detector_config(), seed=8)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "det.pth")
    common = ["--tiny", "--synthetic", "2", "--precision", "int8",
              "--copies_per_chunk", "4", "--dtype", "float32",
              "--checkpoint", str(tmp_path / "det.pth")]
    jtool.main(common + ["--output", str(tmp_path / "jax.tsv")])
    out = tool.main(common + ["--device", "cpu", "--output",
                              str(tmp_path / "port.tsv")])
    assert out["copies"] == 6
    assert_rows_match(tmp_path / "port.tsv", tmp_path / "jax.tsv")


def assert_rows_match(got_tsv, want_tsv):
    """Two extraction TSVs of the synthetic queries ``syn0``, ``syn1``: the
    same keys, payloads, rects and classes; features and confidences within
    1e-5 of their scale."""
    want, got = _rows(want_tsv), _rows(got_tsv)
    assert [k for k, _ in got] == [k for k, _ in want] == ["syn0", "syn1"]
    for (_, g), (_, w) in zip(got, want):
        assert g[1:] == w[1:]                       # caption, colors, rects
        gb = [b for copy in g[0] for b in copy]
        wb = [b for copy in w[0] for b in copy]
        assert [b["rect"] for b in gb] == [b["rect"] for b in wb]
        assert [b["class"] for b in gb] == [b["class"] for b in wb]
        gf = np.stack([decode_feature(b["feature"]) for b in gb])
        wf = np.stack([decode_feature(b["feature"]) for b in wb])
        assert np.isfinite(gf).all() and _rel(gf, wf) <= 1e-5
        assert _rel([b["conf"] for b in gb], [b["conf"] for b in wb]) <= 1e-5


@pytest.mark.parametrize("flags,item", [
    (["--opts", "MODEL.X", "1"], "item 3"), (["--dp", "2"], "item 9"),
    (["--shard_by_process"], "item 9"),
    (["--config_file", "c.yaml", "--opts", "A", "1"], "item 3"),
    (["--config_file", "c.yaml"], "item 3"),
    (["--opts"], "item 3"), (["--image_dir", "d"], "item 5")])
def test_extract_features_refuses_what_is_not_ported(tmp_path, flags, item):
    """``--dp 2`` named Queue 1 item 9(b) until the meshes were ported: it
    now runs in two processes against the JAX tool's ``--dp 2``
    (:func:`run_dp2_against_jax`); ``--shard_by_process`` (item 9(a)) runs: in one process its one shard, ``o.shard0.tsv``, is
    the whole extraction. The flags of items 3 and 5 are ported and run: --config_file reads its yaml (a
    missing one raises as in JAX), --opts without it changes nothing, and
    --image_dir over a folder without .jpg files writes an empty TSV."""
    from cpt_tpu_torch.tools import extract_features as tool

    out = tmp_path / "o.tsv"
    argv = ["--output", str(out)] + [
        str(tmp_path / f) if f == "d" else f for f in flags]
    tiny = ["--tiny", "--synthetic", "1", "--device", "cpu", "--dtype",
            "float32", "--copies_per_chunk", "4"]
    if flags == ["--shard_by_process"]:
        tool.main(argv + tiny)
        tool.main(["--output", str(tmp_path / "plain.tsv")] + tiny)
        assert not out.exists()
        assert (tmp_path / "o.shard0.tsv").read_bytes() == (
            tmp_path / "plain.tsv").read_bytes()
    elif item == "item 9":
        run_dp2_against_jax(tmp_path)
    elif "--config_file" in flags:
        with pytest.raises(FileNotFoundError, match="c.yaml"):
            tool.main(argv)
        assert not out.exists()
    elif item == "item 3":
        got = tool.main(argv + tiny)
        assert got["copies"] == 3
        tool.main(["--output", str(tmp_path / "plain.tsv")] + tiny)
        assert out.read_bytes() == (tmp_path / "plain.tsv").read_bytes()
    else:
        (tmp_path / "d").mkdir()
        got = tool.main(argv + ["--tiny", "--device", "cpu"])
        assert got["images"] == 0 and out.read_text() == ""


DP_EXTRACT = r'''
import json
from cpt_tpu_torch.parallel import distributed as D
from cpt_tpu_torch.tools import extract_features

out = extract_features.main(json.load(open("argv.json")))
print(json.dumps({"pid": D.process_index(), "copies": out["copies"]}),
      flush=True)
'''


def run_dp2_against_jax(tmp_path):
    """``extract_features --tiny --synthetic 2 --dp 2`` in two processes
    (each chunk of 4 copies split 2 and 2, rank 0 writing the TSV) against
    the JAX tool's ``--dp 2`` on the same checkpoint."""
    from cpt_tpu.tools import extract_features as jtool
    from test_torch_distributed import run_pair

    sd = random_vinvl_state_dict(jdet_cfg.tiny_detector_config(), seed=8)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "det.pth")
    common = ["--tiny", "--synthetic", "2", "--copies_per_chunk", "4",
              "--dtype", "float32", "--checkpoint", str(tmp_path / "det.pth"),
              "--dp", "2"]
    jtool.main(common + ["--output", str(tmp_path / "jax.tsv")])
    (tmp_path / "argv.json").write_text(json.dumps(
        common + ["--device", "cpu", "--output", str(tmp_path / "port.tsv")]))
    ranks = run_pair(DP_EXTRACT, tmp_path)
    assert [r["copies"] for r in ranks] == [6, 6]
    assert_rows_match(tmp_path / "port.tsv", tmp_path / "jax.tsv")


def test_int8_gap_tool_runs_tiny():
    """``tools/int8_gap`` at a tiny size on the CPU: the fused-epilogue
    variant stays far closer to the int8 run than bf16 does."""
    from cpt_tpu_torch.tools import int8_gap

    gaps = int8_gap.main(["--tiny", "--device", "cpu", "--synthetic", "2"])
    assert set(gaps) == {"fma", "fma l2", "bf16", "bf16 l2"}
    assert gaps["fma"] < 1e-5 < gaps["bf16"]
