"""The port stands alone: every module of ``cpt_tpu_torch`` imports with
``jax``, ``cpt_tpu`` and Pillow (``PIL``) blocked, no source of the port
(nor ``chip_smoke.py``) imports any of them, and the port's copies of the
JAX package's jax-free modules (configs, tokenizer, TSV codec, prompts,
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
    """Every module of the port imports with jax, flax, cpt_tpu and PIL
    blocked, and loads none of them."""
    script = """
import sys
for name in ("jax", "flax", "cpt_tpu", "PIL"):
    sys.modules[name] = None
import importlib, pkgutil, cpt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cpt_tpu_torch.__path__,
                                                "cpt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None]
assert not [k for k in loaded
            if k.split(".")[0] in ("jax", "flax", "cpt_tpu", "PIL")]
print(len(names), "OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, ok = proc.stdout.split()
    assert ok == "OK" and int(count) >= 30


SLICE_MODULES = ("data.pretrain", "tools.run_oscarplus_pretrain", "tools.explore",
                 "models.detector.losses", "data.detector_transforms",
                 "engine.detector_train", "tools.train_detector",
                 "engine.solver", "models.detector.attr_rcnn",
                 # the scene-graph slice
                 "models.detector.scene_parser", "models.detector.relation_head",
                 "models.detector.relation_variants", "models.detector.motif",
                 "engine.sg_infer", "engine.sg_eval", "engine.bbox_aug",
                 "engine.cityscapes_eval", "tools.cityscapes_eval",
                 "tools.test_detector",
                 # the detector library modules and the process runtime
                 "ops.focal_loss", "ops.roi_pool", "ops.deform_conv",
                 "models.detector.fpn", "models.detector.extra_heads",
                 "models.detector.fbnet", "models.detector.msvit",
                 "parallel.distributed",
                 # the meshes, the pipeline and the synthetic fixtures
                 "parallel.mesh", "parallel.pipeline", "data.synthetic",
                 "tools.dryrun_multichip",
                 # the Pillow-free pixel operations, image codec (its
                 # other raster formats' readers among them) and captions,
                 # and the demo that draws them
                 "utils.image_ops", "utils.image_codec", "utils.raster_formats",
                 "utils.text", "tools.demo")


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_training_slice_modules_import_without_jax(name):
    """The pretraining, explore, detector-training and scene-graph modules,
    the detector library modules, the process runtime, the meshes, the
    pipeline, the pixel operations, the image codec, the captions and the
    demo import, each in a fresh process with ``jax``, ``flax``,
    ``cpt_tpu`` and ``PIL`` blocked, and load none of them."""
    script = f"""
import sys
for name in ("jax", "flax", "cpt_tpu", "PIL"):
    sys.modules[name] = None
import importlib
importlib.import_module("cpt_tpu_torch.{name}")
assert not [k for k, v in sys.modules.items() if v is not None
            and k.split(".")[0] in ("jax", "flax", "cpt_tpu", "PIL")]
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-3000:]


def _foreign_imports(path: Path):
    """(line, module) for every import of jax, flax, cpt_tpu (not
    cpt_tpu_torch) or PIL in one source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] in ("jax", "flax", "cpt_tpu", "PIL"):
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
                     "def f():\n    import jax.numpy\n"
                     "    from PIL import ImageDraw\n")
    assert list(_foreign_imports(probe)) == [(2, "cpt_tpu.utils"),
                                             (4, "jax.numpy"), (5, "PIL")]


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
def test_tools_common_copy(tmp_path, flags):
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
    # the detector-config front end: no --config_file leaves the parser as
    # it was; with one, both install the same defaults
    parsers = []
    for m in (common, jcommon):
        p = m.add_detector_config_args(argparse.ArgumentParser())
        p.add_argument("--max_iter", type=int, default=1)
        assert m.apply_reference_config(p, flags) is None
        parsers.append(p)
    assert vars(parsers[0].parse_args([])) == vars(parsers[1].parse_args([]))
    yaml_path = tmp_path / "c.yaml"
    yaml_path.write_text("SOLVER:\n  MAX_ITER: 9\n")
    argv = ["--config_file", str(yaml_path)] + flags[:0]
    got = [vars((m.apply_reference_config(p, argv), p.parse_args(argv))[1])
           for m, p in zip((common, jcommon), parsers)]
    assert got[0] == got[1] and got[0]["max_iter"] == 9
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


def test_rle_copy():
    """``utils/rle.py``: the same counts strings, masks, areas, boxes and
    merges as the original on random and edge-case masks."""
    from cpt_tpu.utils import rle as jrle
    from cpt_tpu_torch.utils import rle

    rng = np.random.RandomState(4)
    masks = [(rng.rand(13, 17) > p).astype(np.uint8) for p in (0.2, 0.5, 0.97)]
    masks += [np.zeros((5, 6), np.uint8), np.ones((4, 3), np.uint8),
              np.zeros((0, 4), np.uint8)]
    for m in masks:
        for compress in (True, False):
            code = rle.encode(m, compress)
            assert code == jrle.encode(m, compress)
            np.testing.assert_array_equal(rle.decode(code), jrle.decode(code))
            np.testing.assert_array_equal(rle.decode(code), m)
            assert rle.area(code) == jrle.area(code)
            if m.size:
                np.testing.assert_array_equal(rle.to_bbox(code),
                                              jrle.to_bbox(code))
    codes = [rle.encode(m) for m in masks[:3]]
    for intersect in (False, True):
        assert rle.merge(codes, intersect) == jrle.merge(codes, intersect)


GQA_ENTRIES = {
    "0": {"question": "Is the man that is wearing a black shirt tall?",
          "annotations": {"question": {"2": "1", "7:9": "2"}},
          "semantic": [{"operation": "select", "argument": "shirt (2)",
                        "dependencies": []},
                       {"operation": "filter color", "argument": "black",
                        "dependencies": [0]},
                       {"operation": "relate",
                        "argument": "man,wearing,o (1)",
                        "dependencies": [1]},
                       {"operation": "verify", "argument": "tall",
                        "dependencies": [2]}]},
    "1": {"question": "What is on the table and the chair?",
          "annotations": {"question": {"4": "3", "7": "4"}},
          "semantic": [{"operation": "select", "argument": "table (3)",
                        "dependencies": []},
                       {"operation": "relate", "argument": "_,on,s (5)",
                        "dependencies": [0]}]},
    "2": {"question": "Who is holding the cup near the window?",
          "annotations": {"question": {"4": "6", "7": "7"}},
          "semantic": [{"operation": "select", "argument": "window (7)",
                        "dependencies": []},
                       {"operation": "relate", "argument": "cup,near,s (6)",
                        "dependencies": [0]},
                       {"operation": "relate",
                        "argument": "person,holding,o (6)",
                        "dependencies": [1]}]},
}


def test_gqa_parse_copy():
    from cpt_tpu.data import gqa_parse as jparse
    from cpt_tpu_torch.data import gqa_parse

    for use_semantic in (True, False):
        assert (gqa_parse.build_to_mark(GQA_ENTRIES, use_semantic)
                == jparse.build_to_mark(GQA_ENTRIES, use_semantic))
    for entry in GQA_ENTRIES.values():
        assert gqa_parse.simple_parse(entry) == jparse.simple_parse(entry)
        assert gqa_parse.gt_parse(entry) == jparse.gt_parse(entry)
    assert gqa_parse.simple_parse(GQA_ENTRIES["0"]) == "Is the man tall?"


def test_evaluate_copy():
    from cpt_tpu.engine import evaluate as jevaluate
    from cpt_tpu_torch.engine import evaluate

    rng = np.random.RandomState(6)
    preds = {f"a.jpg_{s}_{o}": rng.randn(5) for s in range(3) for o in range(3)
             if s != o}
    preds["a.jpg_0_1"][2] += 4.0
    gts = [{"img_path": "a.jpg", "relations": np.asarray([[0, 1, 2], [1, 2, 3]])},
           {"img_path": "b.jpg", "relations": np.asarray([[0, 1, 1]])}]
    for softmax in (True, False):
        got = evaluate.vg_recall_eval(preds, gts, apply_softmax=softmax,
                                      num_classes=5)
        assert got == jevaluate.vg_recall_eval(preds, gts,
                                               apply_softmax=softmax,
                                               num_classes=5)
        assert got["R@20"] == 25.0
    sweep = {4: {0: 40.0, 1: 42.5}}
    assert evaluate.seed_sweep_report(sweep) == jevaluate.seed_sweep_report(sweep)
    np.testing.assert_array_equal(evaluate.ensemble_logits([1.0, 2.0], [3.0, 0.0]),
                                  jevaluate.ensemble_logits([1.0, 2.0], [3.0, 0.0]))
    assert evaluate.imkey2pair("x_y.jpg_3_9") == jevaluate.imkey2pair("x_y.jpg_3_9")


def test_gqa_and_vg_prompt_copies():
    jt, pt = (m.BertTokenizer(m.toy_vocab()) for m in (jtok, tok))
    for name in ("REL_CANONICALIZE", "VG_NA_FILLERS", "VG_MAX_MASK_WIDTH",
                 "VG_PAIR_COLORS", "VG_PAIR_COLOR_NAMES"):
        assert getattr(prompts, name) == getattr(jprompts, name), name
    labels = ["man", "horse", "hat", "dog"]
    for colors in (("red", "blue"), ("green", "purple")):
        assert (prompts.vg_subject_object_names("man", "horse", colors)
                == jprompts.vg_subject_object_names("man", "horse", colors))
        for k in (1, 2, 3):
            assert (prompts.vg_prompt("man", "horse", k, colors)
                    == jprompts.vg_prompt("man", "horse", k, colors))
        for pair in ((0, 1), (3, 2), (1, 1)):
            assert (prompts.vg_od_labels_with_colors(labels, pair, colors)
                    == jprompts.vg_od_labels_with_colors(labels, pair, colors))
    for rel in ("on", "sitting on", "in front of"):
        ids = pt.convert_tokens_to_ids(pt.tokenize(rel))
        assert (prompts.vg_filler_label_ids(ids, lambda s: pt.convert_tokens_to_ids(
            pt.tokenize(s))) == jprompts.vg_filler_label_ids(
            ids, lambda s: jt.convert_tokens_to_ids(jt.tokenize(s))))
    q = "Is the cup on the table next to the man?"
    for marks in ([], [[[6], "red"]], [[[10], "blue"], [[22], "green"]]):
        assert (prompts.gqa_rewrite_question(q, marks)
                == jprompts.gqa_rewrite_question(q, marks))


def test_merge_tsv_shards_and_box_iou_copies(tmp_path):
    from cpt_tpu.structures.boxes import box_iou_np as jbox_iou_np
    from cpt_tpu_torch.structures.boxes import box_iou_np

    for i in range(3):
        tsv.tsv_writer([(f"k{i}{j}", f"v\t{j}") for j in range(i + 1)],
                       str(tmp_path / f"s{i}.tsv"))
    shards = [str(tmp_path / f"s{i}.tsv") for i in (2, 0, 1)]
    tsv.merge_tsv_shards(shards, str(tmp_path / "a.tsv"))
    jtsv.merge_tsv_shards(shards, str(tmp_path / "b.tsv"))
    for ext in ("tsv", "lineidx"):
        assert ((tmp_path / f"a.{ext}").read_bytes()
                == (tmp_path / f"b.{ext}").read_bytes())
    assert tsv.TSVFile(str(tmp_path / "a.tsv")).seek(5) == ["k11", "v", "1"]
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 50, (7, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(-2, 30, (7, 2))], 1)
    got = box_iou_np(boxes, boxes[:4])
    np.testing.assert_array_equal(got, jbox_iou_np(boxes, boxes[:4]))
    assert got.dtype == np.float32 and got.shape == (7, 4)


def _code(path: Path, names=None, skip=()) -> str:
    """The module's code without its docstrings, with the port's package
    name read as the JAX package's: what a copy must keep of its original
    (``names``: only these top-level definitions; ``skip``: without these
    top-level definitions and imported names)."""
    tree = ast.parse(path.read_text())
    body = []
    for node in tree.body:
        if names is not None and getattr(node, "name", None) not in names:
            continue
        if getattr(node, "name", None) in skip:
            continue
        if isinstance(node, ast.Import):
            node.names = [a for a in node.names
                          if (a.asname or a.name) not in skip]
            if not node.names:
                continue
        body.append(node)
    for node in ast.walk(ast.Module(body=body, type_ignores=[])):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.Module)):
            if (node.body and isinstance(node.body[0], ast.Expr)
                    and isinstance(node.body[0].value, ast.Constant)
                    and isinstance(node.body[0].value.value, str)):
                node.body = node.body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("cpt_tpu_torch", "cpt_tpu")
        if isinstance(node, ast.FunctionDef):
            # PyYAML is imported where a file is read (the JAX package's
            # config/core imports it at the top)
            node.body = [n for n in node.body if not (
                isinstance(n, ast.Import) and n.names[0].name == "yaml")]
    body = [n for n in body if not (isinstance(n, ast.Expr) and isinstance(
        getattr(n, "value", None), ast.Constant))]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


# The definitions of the AST-held copies that read or write image files,
# and the imports only they used: the port's call utils/image_codec.
IMAGE_IO_SITES = {
    "data/vg_tsv.py": {"img_from_base64", "write_detection_tsv", "io"},
    "data/coco_json.py": {"coco_to_tsv", "voc_to_tsv", "np"},
}


@pytest.mark.parametrize("module,names", [
    ("engine/detection_eval.py", None), ("data/vg_tsv.py", None),
    ("data/coco_json.py", None), ("models/detector/yacs_bridge.py", None),
    ("tools/convert_dataset.py", None), ("engine/solver.py", {"SolverConfig"}),
    ("config/core.py", {"merge_dict", "replace_path", "apply_overrides",
                        "from_yaml", "to_dict", "dumps"}),
    ("data/vqa.py", None), ("data/nlvr.py", None), ("data/retrieval.py", None),
    ("data/tensorize.py", {"truncate_seq_pair", "tensorize_pair",
                           "pad_img_feats"}),
    ("utils/ptb_tokenizer.py", None), ("utils/cider.py", None),
    ("utils/meteor.py", None), ("utils/spice_lite.py", None),
    ("engine/caption_eval.py", None), ("utils/cbs.py", {"build_fsm"}),
    ("engine/scst.py", {"scst_advantages"}),
    ("models/bert/captioning.py", {"caption_attention_mask",
                                   "CaptionTensorizer"}),
    ("engine/generation.py", {"GenerationConfig", "decode_caption"}),
    ("tools/run_captioning.py", {"build_args", "load_feats",
                                 "CaptionYamlData"}),
    ("data/pretrain.py", None), ("data/detector_transforms.py", None),
    ("engine/sg_eval.py", None), ("engine/cityscapes_eval.py", None)])
def test_jax_free_copies_keep_the_originals_code(module, names):
    """The port's copies of the JAX package's jax-free modules (or of the
    named definitions) are the originals' code but for docstrings and the
    package name: ``config/core``'s front end, ``SolverConfig``, the yacs
    bridge and its tables, the detection evaluators and the detection
    datasets, the Oscar runners' datasets and the pair tensorizer, the
    caption evaluators (PTB tokenizer, CIDEr-D, METEOR, SPICE-lite, the
    coco-caption protocol), the CBS state machine, SCST's advantages, the
    caption tensorizer and mask, the generation config and
    ``run_captioning``'s flags and data readers, the pretraining datasets,
    the detector's training augmentations and the scene-graph and
    Cityscapes evaluators (their behaviour against the originals' is held
    in ``test_torch_config_front_end.py``, ``test_torch_detector_tools.py``,
    ``test_torch_oscar_data.py``, ``test_torch_captioning.py``,
    ``test_torch_detector_eval_extras.py`` and the caption metrics' case
    below). The detection datasets' image readers and writers
    (``IMAGE_IO_SITES``) call ``utils/image_codec`` where the originals call
    Pillow: they are held apart, to the codec here and to the originals'
    output in ``test_torch_image_codec.py``."""
    skip = IMAGE_IO_SITES.get(module, set())
    got = _code(REPO / "cpt_tpu_torch" / module, names, skip)
    want = _code(REPO / "cpt_tpu" / module, names, skip)
    assert len(want) > 500 and got == want
    if skip:
        port = (REPO / "cpt_tpu_torch" / module).read_text()
        tree = ast.parse(port)
        for node in tree.body:
            if getattr(node, "name", None) in skip:
                src = ast.get_source_segment(port, node)
                assert "image_codec" in src and "PIL" not in src, node.name


def test_solver_config_copy():
    from cpt_tpu.engine.solver import SolverConfig as JSolver
    from cpt_tpu_torch.engine.solver import SolverConfig

    assert dataclasses.asdict(SolverConfig()) == dataclasses.asdict(JSolver())
    assert ([(f.name, f.type) for f in dataclasses.fields(SolverConfig)]
            == [(f.name, f.type) for f in dataclasses.fields(JSolver)])


def test_caption_metrics_match_the_originals():
    """A small corpus through both packages' ``CiderD``, ``corpus_bleu``,
    ``meteor``, ``rouge_l``, ``spice_lite_corpus`` and the PTB tokenizer:
    the same numbers, bit for bit."""
    from cpt_tpu.engine import caption_eval as jeval
    from cpt_tpu.utils import cider as jcider
    from cpt_tpu.utils import meteor as jmeteor
    from cpt_tpu.utils import ptb_tokenizer as jptb
    from cpt_tpu.utils import spice_lite as jspice
    from cpt_tpu_torch.engine import caption_eval
    from cpt_tpu_torch.utils import cider, meteor, ptb_tokenizer, spice_lite

    refs = {"a": ["a man riding a red horse on the beach",
                  "the man rides a horse near the sea"],
            "b": ["two dogs are playing in the grass", "dogs play outside"],
            "c": ["a woman holding an umbrella in the rain",
                  "a person with an umbrella walks down a wet street"]}
    hyps = {"a": "a man is riding a horse", "b": "two dogs playing on grass",
            "c": "a woman walking with umbrellas"}
    for text in list(hyps.values()) + CAPTIONS:
        assert ptb_tokenizer.ptb_tokenize(text) == jptb.ptb_tokenize(text)
    ref_w = {k: [r.split() for r in v] for k, v in refs.items()}
    hyp_w = {k: v.split() for k, v in hyps.items()}
    assert (cider.CiderD(ref_w).corpus_score(hyp_w)
            == jcider.CiderD(ref_w).corpus_score(hyp_w) > 0)
    assert (caption_eval.corpus_bleu(hyp_w, ref_w)
            == jeval.corpus_bleu(hyp_w, ref_w))
    for k in hyps:
        assert (meteor.meteor(hyp_w[k], ref_w[k])
                == jmeteor.meteor(hyp_w[k], ref_w[k]) > 0)
        assert (caption_eval.rouge_l(hyp_w[k], ref_w[k])
                == jeval.rouge_l(hyp_w[k], ref_w[k]) > 0)
        assert cider.bleu4(hyp_w[k], ref_w[k]) == jcider.bleu4(hyp_w[k], ref_w[k])
    assert (spice_lite.spice_lite_corpus(hyps, refs)
            == jspice.spice_lite_corpus(hyps, refs) > 0)


# --- the routed image sites with Pillow blocked ---------------------------------

NO_PILLOW = r"""
import base64, io, json, sys, threading, types, urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path
for name in ("PIL", "jax", "flax", "cpt_tpu"):
    sys.modules[name] = None
import numpy as np
from cpt_tpu_torch.data import coco_json, vg_tsv
from cpt_tpu_torch.tools import (cpt_predict, demo, extract_features,
                                 img_info, serve, validate_checkpoints)

src, out = Path(sys.argv[1]), Path(sys.argv[2])
arrays, res = {}, {}
arrays["load_jpg"] = extract_features.load_image(
    str(src / "photo.jpg"), 640, 1024, 600, 1000)[0]
arrays["load_png"] = extract_features.load_image(str(src / "photo.png"), 640, 1024)[0]
arrays["b64"] = vg_tsv.img_from_base64(
    base64.b64encode((src / "photo.jpg").read_bytes()).decode())
vg_tsv.write_detection_tsv(str(out / "tsv"), "t", {"a": arrays["load_png"][:40, :50]},
                           {"a": {"objects": []}}, {"label_to_idx": {}})
coco_json.coco_to_tsv(str(src / "coco" / "instances.json"),
                      str(src / "coco" / "images"), str(out / "coco"))
res["img_info"] = img_info.create_img_info(str(src / "info"), str(out / "info.json"))
img_info.create_all_color_imgs(str(out / "colors"), 128, size=16)
validate_checkpoints.make_synthetic_fixture(str(out / "fixture"), 3, (96, 128))
res["pred"] = cpt_predict.main([
    "--image", str(src / "photo.jpg"), "--caption", "the dog", "--dets",
    "[[2,2,20,30],[22,4,50,36]]", "--tiny", "--device", "cpu", "--dtype",
    "float32", "--hidden_size", "32", "--num_hidden_layers", "2", "--out",
    str(out / "pred.png")])
demo.main(["--image", str(src / "photo.png"), "--boxes", "[[2,2,20,30]]",
           "--out", str(out / "demo.png"), "--device", "cpu"])
for kind in ("gif", "cmyk"):
    dets = demo.main([
        "--image", str(src / f"photo_{kind}.{'gif' if kind == 'gif' else 'jpg'}"),
        "--detect", "--tiny", "--conf", "0", "--device", "cpu", "--dtype",
        "float32", "--labelmap", str(src / "labelmap.json"), "--out",
        str(out / f"detect_{kind}.png")])
    for name, value in zip(("boxes", "labels", "scores"), dets):
        arrays[f"detect_{kind}_{name}"] = value
seen = []
svc = types.SimpleNamespace(
    device=types.SimpleNamespace(type="cpu"), n_requests=0,
    predict=lambda img, caption, dets: seen.append(img) or ([0.0] * 4, [1.0]))
httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
threading.Thread(target=httpd.serve_forever, daemon=True).start()
body = json.dumps({"image_b64": base64.b64encode(
    (src / "photo.jpg").read_bytes()).decode(), "caption": "x",
    "dets": [[0, 0, 1, 1]]}).encode()
opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
req = urllib.request.Request(
    f"http://127.0.0.1:{httpd.server_address[1]}/predict", data=body)
with opener.open(req, timeout=60) as r:
    res["serve_status"] = r.status
httpd.shutdown()
arrays["served"] = seen[0]
np.savez(out / "arrays.npz", **arrays)
(out / "res.json").write_text(json.dumps(res))
assert "PIL" not in [k.split(".")[0] for k, v in sys.modules.items() if v is not None]
print("OK")
"""


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_routed_image_sites_run_without_pillow(tmp_path, monkeypatch):
    """In a process where ``import PIL`` (and jax, and cpt_tpu) fails, every
    site that read or wrote image files through Pillow reads and writes
    them through ``utils/image_codec``: ``extract_features.load_image``,
    ``vg_tsv.img_from_base64`` and ``write_detection_tsv``,
    ``coco_json.coco_to_tsv``, ``img_info``'s size scan and colour probes,
    ``validate_checkpoints``' fixture, ``cpt_predict --image/--out``,
    ``demo --image/--out``, ``demo --tiny --detect`` on a GIF and on a CMYK
    JPEG (its captions drawn by ``utils/text``, non-ASCII class names
    among them) and serve's HTTP handler. Each output equals the JAX
    package's Pillow call's on the same files (arrays, file bytes; for
    ``demo --detect`` the JAX tool's PNG for the same detections), or, for
    the tools without a JAX counterpart run here, Pillow's reading of the
    written file."""
    import chip_smoke as cs
    from PIL import Image

    from cpt_tpu.data import coco_json as jcoco
    from cpt_tpu.data import vg_tsv as jvg_tsv
    from cpt_tpu.tools import demo as jdemo
    from cpt_tpu.tools import extract_features as jextract
    from cpt_tpu.tools import img_info as jimg_info
    from cpt_tpu.tools import validate_checkpoints as jvalidate
    from cpt_tpu_torch.tools import demo
    from cpt_tpu_torch.tools.cpt_predict import draw_box_outline

    src, out, ref = tmp_path / "src", tmp_path / "out", tmp_path / "ref"
    for d in (src, out, ref, src / "info"):
        d.mkdir()
    photo = cs.codec_photo(60, 96, 128)
    Image.fromarray(photo).save(src / "photo.jpg", quality=90)
    Image.fromarray(photo).save(src / "photo.png")
    Image.fromarray(photo).quantize(64).save(src / "photo_gif.gif")
    Image.fromarray(photo).convert("CMYK").save(src / "photo_cmyk.jpg")
    labelmap = {"idx_to_label": {str(i): f"clâsse {i} – {'ü' * (i % 4)}€"
                                 for i in range(2000)}}
    (src / "labelmap.json").write_text(json.dumps(labelmap))
    cs.coco_fixture(str(src / "coco"))
    for name, (h, w) in cs.INFO_SIZES.items():
        Image.fromarray(cs.codec_photo(61, h, w)).save(src / "info" / name)
    proc = subprocess.run([sys.executable, "-c", NO_PILLOW, str(src), str(out)],
                          capture_output=True, text=True, timeout=150,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), \
        proc.stderr[-3000:]
    got = np.load(out / "arrays.npz")
    res = json.loads((out / "res.json").read_text())

    decoded = np.asarray(Image.open(src / "photo.jpg").convert("RGB"))
    np.testing.assert_array_equal(got["load_jpg"], jextract.load_image(
        str(src / "photo.jpg"), 640, 1024, 600, 1000)[0])
    np.testing.assert_array_equal(got["load_png"], jextract.load_image(
        str(src / "photo.png"), 640, 1024)[0])
    np.testing.assert_array_equal(got["b64"], decoded)
    np.testing.assert_array_equal(got["served"], decoded)
    assert res["serve_status"] == 200
    jvg_tsv.write_detection_tsv(str(ref / "tsv"), "t", {"a": photo[:40, :50]},
                                {"a": {"objects": []}}, {"label_to_idx": {}})
    jcoco.coco_to_tsv(str(src / "coco" / "instances.json"),
                      str(src / "coco" / "images"), str(ref / "coco"))
    jimg_info.create_all_color_imgs(str(ref / "colors"), 128, size=16)
    jvalidate.make_synthetic_fixture(str(ref / "fixture"), 3, (96, 128))
    for sub in ("tsv", "coco", "colors", "fixture"):
        mine, theirs = _tree(out / sub), _tree(ref / sub)
        assert mine.keys() == theirs.keys() and mine, sub
        for k in mine:
            assert mine[k] == theirs[k].replace(str(ref).encode(),
                                                str(out).encode()), (sub, k)
    assert res["img_info"] == jimg_info.create_img_info(
        str(src / "info"), str(ref / "info.json"))
    np.testing.assert_array_equal(
        np.asarray(Image.open(out / "pred.png")),
        draw_box_outline(decoded.copy(), res["pred"], (0, 255, 0)))
    np.testing.assert_array_equal(
        np.asarray(Image.open(out / "demo.png")),
        demo.paint(photo, [[2, 2, 20, 30]], False, "cpu")[0][1])
    for kind, image in (("gif", "photo_gif.gif"), ("cmyk", "photo_cmyk.jpg")):
        dets = tuple(got[f"detect_{kind}_{n}"]
                     for n in ("boxes", "labels", "scores"))
        assert len(dets[0]) > 0
        monkeypatch.setattr(jdemo, "run_detector", lambda args, img: dets)
        jdemo.main(["--image", str(src / image), "--detect", "--tiny",
                    "--labelmap", str(src / "labelmap.json"), "--out",
                    str(ref / f"detect_{kind}.png")])
        np.testing.assert_array_equal(
            np.asarray(Image.open(out / f"detect_{kind}.png")),
            np.asarray(Image.open(ref / f"detect_{kind}.png")))
