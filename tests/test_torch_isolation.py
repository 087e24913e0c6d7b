"""The port stands alone: every module of ``cpt_tpu_torch`` imports with
``jax`` and ``cpt_tpu`` blocked, no source of the port (nor
``chip_smoke.py``) imports either, and the port's copies of the JAX
package's jax-free modules (configs, tokenizer, TSV codec, prompts,
tensorization, random reference-layout weights) behave as the originals."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cpt_tpu.config import bert as jbert_cfg
from cpt_tpu.data import prompts as jprompts
from cpt_tpu.data import tensorize as jtensorize
from cpt_tpu.models.detector import config as jdet_cfg
from cpt_tpu.models.detector.convert import random_vinvl_state_dict as jax_vinvl
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu.utils import tsv as jtsv
from cpt_tpu.utils.convert import random_oscar_state_dict as jax_oscar
from cpt_tpu_torch.config import bert as bert_cfg
from cpt_tpu_torch.data import prompts, tensorize
from cpt_tpu_torch.models.detector import config as det_cfg
from cpt_tpu_torch.models.detector.convert import random_vinvl_state_dict
from cpt_tpu_torch.utils import tokenization as tok
from cpt_tpu_torch.utils import tsv
from cpt_tpu_torch.utils.convert import random_oscar_state_dict
from test_torch_watchdog import guards

guard_module, guard_case = guards(150)

REPO = Path(__file__).resolve().parent.parent
CAPTIONS = ["The woman on the left.", "a dog, and a cat?", "what's RED",
            "Café person in the right", "the man is in [MASK] color."]


def test_every_module_imports_without_jax_or_cpt_tpu():
    script = """
import sys
for name in ("jax", "flax", "cpt_tpu"):
    sys.modules[name] = None
import importlib, pkgutil, cpt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cpt_tpu_torch.__path__,
                                                "cpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None]
assert not [k for k in loaded if k.split(".")[0] in ("jax", "flax", "cpt_tpu")]
print(len(names), "OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, ok = proc.stdout.split()
    assert ok == "OK" and int(count) >= 30


def _foreign_imports(path: Path):
    """(line, module) for every import of jax, flax or cpt_tpu (not
    cpt_tpu_torch) in one source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] in ("jax", "flax", "cpt_tpu"):
                yield node.lineno, name


def test_no_source_of_the_port_imports_jax_or_cpt_tpu(tmp_path):
    files = sorted((REPO / "cpt_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_e2e.py"]
    assert len(files) > 30
    found = {str(f.relative_to(REPO)): list(_foreign_imports(f)) for f in files}
    assert {f: v for f, v in found.items() if v} == {}
    # the scan does see such imports
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom cpt_tpu.utils import tsv\n"
                     "def f():\n    import jax.numpy\n")
    assert list(_foreign_imports(probe)) == [(2, "cpt_tpu.utils"),
                                             (4, "jax.numpy")]


@pytest.mark.parametrize("name", ["OSCAR_BASE", "OSCAR_LARGE", "tiny"])
def test_bert_config_copy(name):
    def make(m):
        return m.tiny_bert_config() if name == "tiny" else getattr(m, name)

    j, p = make(jbert_cfg), make(bert_cfg)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert j.head_dim == p.head_dim
    assert ([(f.name, f.type) for f in dataclasses.fields(j)]
            == [(f.name, f.type) for f in dataclasses.fields(p)])
    kw = dict(attention_impl="flash", hidden_size=64)
    assert (dataclasses.asdict(dataclasses.replace(j, **kw))
            == dataclasses.asdict(dataclasses.replace(p, **kw)))


@pytest.mark.parametrize("name", ["VINVL_X152C4", "tiny"])
def test_detector_config_copy(name):
    def make(m):
        return m.tiny_detector_config() if name == "tiny" else getattr(m, name)

    j, p = make(jdet_cfg), make(det_cfg)
    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert j.rpn.num_anchors == p.rpn.num_anchors
    assert (j.backbone.stage2_bottleneck_channels
            == p.backbone.stage2_bottleneck_channels)
    for part in ("backbone", "rpn", "roi_heads", "attributes", "input"):
        assert ([f.name for f in dataclasses.fields(getattr(j, part))]
                == [f.name for f in dataclasses.fields(getattr(p, part))])


def test_tokenizer_copy():
    extra = ("café", "##ing", "walk")
    assert tok.toy_vocab(extra) == jtok.toy_vocab(extra)
    jt, pt = (m.BertTokenizer(m.toy_vocab(extra)) for m in (jtok, tok))
    for caption in CAPTIONS + ["walking the dog"]:
        assert pt.tokenize(caption) == jt.tokenize(caption), caption
        assert pt.encode(caption) == jt.encode(caption)
    assert pt.mask_token_id == jt.mask_token_id == 103
    assert pt.vocab_size == jt.vocab_size


def test_prompts_and_tensorize_copy():
    jt, pt = (m.BertTokenizer(m.toy_vocab()) for m in (jtok, tok))
    labels = ["man", "dog", "cat", "woman"]
    for i, caption in enumerate(CAPTIONS):
        prompt = prompts.refcoco_fsl_prompt(caption)
        assert prompt == jprompts.refcoco_fsl_prompt(caption)
        text_b = prompts.refcoco_od_labels_with_color(labels, i % 4, "red")
        assert text_b == jprompts.refcoco_od_labels_with_color(labels, i % 4,
                                                               "red")
        # a short max_seq_len exercises the pair truncation
        for seq_len in (70, 9):
            got = tensorize.tensorize_pair(pt, prompt, text_b, 3 + i,
                                           max_seq_len=seq_len,
                                           max_img_seq_len=5)
            want = jtensorize.tensorize_pair(jt, prompt, text_b, 3 + i,
                                             max_seq_len=seq_len,
                                             max_img_seq_len=5)
            assert got.mask_positions == want.mask_positions
            for f in ("input_ids", "segment_ids", "attention_mask"):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    seqs = [tensorize.tensorize_pair(pt, "a dog", None, 2, 12, 4),
            tensorize.tensorize_pair(pt, "the cat is in [MASK] color", "red cat",
                                     7, 12, 4)]
    jseqs = [jtensorize.tensorize_pair(jt, "a dog", None, 2, 12, 4),
             jtensorize.tensorize_pair(jt, "the cat is in [MASK] color",
                                       "red cat", 7, 12, 4)]
    feats = [np.full((2, 3), 1.5, np.float32), np.arange(21, dtype=np.float32
                                                         ).reshape(7, 3)]
    got = tensorize.stack_batch(seqs, feats, 4, 3, pad_to=3)
    want = jtensorize.stack_batch(jseqs, feats, 4, 3, pad_to=3)
    for f in ("input_ids", "segment_ids", "attention_mask", "img_feats",
              "mask_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_valid == want.num_valid == 2
    # the VCR text: the palette, entity keys and textization
    assert prompts.CROSS_TASK_COLORS == jprompts.CROSS_TASK_COLORS
    colors, names = {"0": "red", "1_2": "blue"}, {"0": "person", "1_2": "people",
                                                  "3": "dog"}
    for sent in (["is", [0], "near", [2, 1], "?"], [[3], "runs"], []):
        assert prompts.vcr_entity_key([2, 1]) == jprompts.vcr_entity_key([2, 1])
        for colorful in (True, False):
            assert (prompts.vcr_textize(sent, colors, names, colorful)
                    == jprompts.vcr_textize(sent, colors, names, colorful))


def test_tsv_copy(tmp_path):
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 7).astype(np.float32)
    rows = [(f"img{i}", tsv.encode_feature(f)) for i, f in enumerate(feats)]
    assert [r[1] for r in rows] == [jtsv.encode_feature(f) for f in feats]
    tsv.tsv_writer(rows, str(tmp_path / "a.tsv"))
    jtsv.tsv_writer(rows, str(tmp_path / "b.tsv"))
    for name in ("a", "b"):
        assert ((tmp_path / f"{name}.lineidx").read_text()
                == (tmp_path / "a.lineidx").read_text())
        os.remove(tmp_path / f"{name}.lineidx")   # regenerated on open
        port, ref = tsv.TSVFile(str(tmp_path / f"{name}.tsv")), jtsv.TSVFile(
            str(tmp_path / f"{name}.tsv"))
        assert len(port) == len(ref) == 3
        for i in (2, 0, 1):
            assert port.seek(i) == ref.seek(i)
            np.testing.assert_array_equal(tsv.decode_feature(port.seek(i)[1]),
                                          feats[i])
        port.close()
        ref.close()


def _same_arrays(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_state_dicts_copy(seed):
    _same_arrays(random_vinvl_state_dict(det_cfg.tiny_detector_config(), seed),
                 jax_vinvl(jdet_cfg.tiny_detector_config(), seed))
    kw = dict(vocab_size=150, img_feature_dim=22)
    _same_arrays(random_oscar_state_dict(bert_cfg.tiny_bert_config(**kw), seed),
                 jax_oscar(jbert_cfg.tiny_bert_config(**kw), seed))


def test_checkpoint_loader_copies():
    """The port's copies of ``rename_c2_keys`` and ``align_state_dict`` give
    the JAX package's mapping on the same keys."""
    from cpt_tpu.models.detector.convert import rename_c2_keys as jrename
    from cpt_tpu.utils.convert import align_state_dict as jalign
    from cpt_tpu_torch.models.detector.convert import rename_c2_keys
    from cpt_tpu_torch.utils.convert import align_state_dict

    keys = ["conv1_w", "res_conv1_bn_s", "res_conv1_bn_b", "res2_0_branch2a_w",
            "res2_0_branch2b_bn_s", "res3_2_branch2c_bn_b", "res4_7_branch1_w",
            "res5_1_branch1_bn_s", "conv_rpn_w", "conv_rpn_b",
            "rpn_cls_logits_w", "rpn_bbox_pred_b", "cls_score_w",
            "bbox_pred_b", "pred_w", "pred_b", "fc6_w"]
    assert rename_c2_keys(keys) == jrename(keys)
    expected = {"bert.a.weight": np.zeros((2, 2)), "b.weight": np.zeros(3),
                "c.bias": np.zeros(4), "head.layer4.0.conv1.weight": np.zeros(1)}
    loaded = {"module.bert.a.weight": np.ones((2, 2)), "b.weight": np.ones(5),
              "x.c.bias": np.full(4, 2.0), "layer4.0.conv1.weight": np.ones(1),
              "conv1.weight": np.full(1, 3.0)}
    _same_arrays(align_state_dict(loaded, expected), jalign(loaded, expected))
    assert sorted(align_state_dict(loaded, expected)) == [
        "bert.a.weight", "c.bias", "head.layer4.0.conv1.weight"]


def test_windowed_host_copies():
    """``engine/windowed.py``'s host-side copies (receptive field, window
    origins, mask boxes, drift) give the originals' results."""
    from cpt_tpu.engine import windowed as jwnd
    from cpt_tpu_torch.engine import windowed as wnd

    for name in ("VINVL_X152C4", "tiny"):
        j = (jdet_cfg.tiny_detector_config() if name == "tiny"
             else jdet_cfg.VINVL_X152C4)
        p = (det_cfg.tiny_detector_config() if name == "tiny"
             else det_cfg.VINVL_X152C4)
        for split in (None, 1, 2):
            assert (wnd.backbone_receptive_field(p, split)
                    == jwnd.backbone_receptive_field(j, split))
    rng = np.random.RandomState(1)
    xy = rng.uniform(-10, 900, (40, 3, 2))
    rects = np.concatenate([xy, xy + rng.uniform(1, 400, (40, 3, 2))],
                           2).astype(np.float32)
    for window in ((384, 512), (512, 640), (640, 1024), (656, 1024)):
        for halo in (0, 160):
            for got, want in zip(wnd.window_origins(rects, window, (640, 1024), halo),
                                 jwnd.window_origins(rects, window, (640, 1024), halo)):
                np.testing.assert_array_equal(got, want)
    masks = (rng.rand(4, 9, 11) > 0.9).astype(np.uint8)
    masks[1] = 0
    np.testing.assert_array_equal(wnd.mask_bboxes(masks), jwnd.mask_bboxes(masks))
    exact = (rng.randn(3, 4, 6), rng.randint(0, 3, (3, 4)), rng.rand(3, 4))
    approx = (exact[0] + 0.01 * rng.randn(3, 4, 6), rng.randint(0, 3, (3, 4)),
              rng.rand(3, 4))
    assert wnd.feature_drift(exact, approx) == jwnd.feature_drift(exact, approx)


def test_validate_checkpoints_host_copies(tmp_path):
    """``tools/validate_checkpoints.py``'s TSV readers give the originals'
    results on the same TSVs."""
    from cpt_tpu.tools import validate_checkpoints as jvck
    from cpt_tpu_torch.tools import validate_checkpoints as vck

    rng = np.random.RandomState(2)

    def write(path, shift):
        rows = []
        for q in range(3):
            objs = [[{"class": str(rng.randint(3)), "conf": 0.5, "rect": [0, 0, 1, 1],
                      "feature": tsv.encode_feature(
                          (rng.randn(7) + shift).astype(np.float32))}
                     for _ in range(2)] for _ in range(2)]
            rows.append((f"q{q}", json.dumps({"objects": [objs, "c", [], []]})))
        tsv.tsv_writer(rows, str(path))

    write(tmp_path / "a.tsv", 0.0)
    write(tmp_path / "b.tsv", 0.1)
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    assert vck.tsv_feature_dim(a) == jvck.tsv_feature_dim(a) == 7
    assert vck.tsv_feature_drift(a, b) == jvck.tsv_feature_drift(a, b)


@pytest.mark.parametrize("flags", [
    [], ["--hidden_size", "64"], ["--hidden_size", "1024", "--num_hidden_layers", "3"],
    ["--model_size", "large", "--img_feature_dim", "134", "--drop_out", "0.2"],
    ["--use_img_layernorm", "--classifier", "mlp", "--cls_hidden_scale", "3"]])
def test_tools_common_copy(flags):
    """``tools/_common.py``'s copies (the Oscar config from the flags, the
    clip flag, the tokenizer, the dtype) give the originals' results."""
    import argparse

    from cpt_tpu.tools import _common as jcommon
    from cpt_tpu_torch.tools import _common as common

    def parse(m):
        p = argparse.ArgumentParser()
        for name in ("--hidden_size", "--num_hidden_layers", "--img_feature_dim",
                     "--cls_hidden_scale"):
            p.add_argument(name, type=int, default=None)
        p.add_argument("--drop_out", type=float, default=None)
        p.add_argument("--model_size", default="base")
        p.add_argument("--classifier", default=None)
        p.add_argument("--use_img_layernorm", action="store_true")
        p.add_argument("--vocab", default=None)
        p.add_argument("--dtype", default="float32")
        m.add_clip_arg(p, "ref")
        return p.parse_args(flags)

    args, jargs = parse(common), parse(jcommon)
    assert vars(args) == vars(jargs)
    assert (dataclasses.asdict(common.model_config(args, attention_impl="flash"))
            == dataclasses.asdict(jcommon.model_config(jargs,
                                                       attention_impl="flash")))
    assert common.clip_of(args) == jcommon.clip_of(jargs) == 1.0
    args.max_grad_norm = jargs.max_grad_norm = 0.0
    assert common.clip_of(args) is jcommon.clip_of(jargs) is None
    assert common.build_tokenizer(args).vocab == jcommon.build_tokenizer(jargs).vocab
    for dt in ("float32", "bfloat16"):
        args.dtype = jargs.dtype = dt
        assert str(common.dtype_of(args)).split(".")[-1] == jcommon.dtype_of(
            jargs).__name__
