"""The port stands alone: every module of ``cpt_tpu_torch`` imports with
``jax`` and ``cpt_tpu`` blocked, no source of the port (nor
``chip_smoke.py``) imports either, and the port's copies of the JAX
package's jax-free modules (configs, tokenizer, TSV codec, prompts,
tensorization, random reference-layout weights) behave as the originals."""
import ast
import dataclasses
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
    files = sorted((REPO / "cpt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
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
