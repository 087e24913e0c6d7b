"""CPT's GQA and VG relation paths, the port against the JAX package on the
CPU in f32 at tiny sizes, from the same seeded inputs and reference-layout
weights: the stage-1 builders (images pixel for pixel, fields), the
question parser's marks, ``extract_features --task gqa | vg | plain`` (and
VG's pickle route through ``--yaml``, ``--labelmap``, ``--to_mark``)
against the JAX tool's TSVs, the GQA and VG batches, ``REC_MLM_CPT``'s
answer scores and VG's multi-mask probabilities, one masked-LM step with
``grad_accum_steps`` 2, both tools zero-shot and training, recall,
``show_ensemble`` and the small TSV tools."""
import functools
import json
import os
import pickle
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.data import gqa as jgqa
from cpt_tpu.data import stage1_tasks as jstage1
from cpt_tpu.data import vg as jvg
from cpt_tpu.data.synthetic import generate_gqa_fixture, generate_vg_fixture
from cpt_tpu.engine import evaluate as jevaluate
from cpt_tpu.engine import extract as jextract
from cpt_tpu.engine import scoring as jscoring
from cpt_tpu.engine import train as jtrain
from cpt_tpu.models.bert import heads as jheads
from cpt_tpu.models.detector.config import \
    tiny_detector_config as jax_tiny_detector_config
from cpt_tpu.models.detector.convert import random_vinvl_state_dict
from cpt_tpu.tools import extract_features as jextract_tool
from cpt_tpu.tools import gqa_cpt as jgqa_tool
from cpt_tpu.tools import vg_cpt as jvg_tool
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.data import gqa, stage1_tasks, vg
from cpt_tpu_torch.engine import evaluate, extract, scoring, train
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.tools import extract_features, gqa_cpt, vg_cpt
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

# extraction through the tiny detector in f32: summation-order noise only
# (the slice test's tolerance)
FEATURE_TOL = 2e-4
# logits, probabilities and scores of a tiny BERT in f32
LOGIT_TOL = 1e-5
SCORE_TOL = 1e-4
# VG's mean log-probabilities (about −5 with a toy vocabulary) in f32
LOGPROB_TOL = 1e-4
# AdamW updates on gradients that agree to f32 noise (parameters O(0.1))
PARAM_ATOL = 1e-5


def _image(seed, h=60, w=60):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


DETS = np.array([[4, 4, 24, 26], [30, 8, 50, 30], [8, 28, 42, 56],
                 [40, 40, 59, 59]], np.float32)


def _same_task(got, want):
    for f in ("key", "caption", "image_hw", "copy_color_names", "meta"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("image_rgb", "det_boxes", "copy_rects", "copy_rect_valid",
              "copy_colors_rgba", "copy_masks", "copy_mask_colors"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.n_copies == want.n_copies


TASK_CASES = {
    "gqa_one": lambda m: m.gqa_mark_task(
        "q1", _image(1), (60, 60), DETS, [[DETS[1].tolist(), [9]]]),
    "gqa_three_marks_two_colors": lambda m: m.gqa_mark_task(
        "q2", _image(2), (60, 60), DETS,
        [[DETS[0].tolist(), [4]], [DETS[2].tolist(), 11], [DETS[3].tolist(), [20]]],
        n_color=2),
    "gqa_no_marks": lambda m: m.gqa_mark_task("q3", _image(3), (60, 60), DETS, []),
    "vg_pair": lambda m: m.vg_pair_task("im.jpg", _image(4), (60, 60), DETS, 2,
                                        0, "man", "horse", "riding"),
    "plain": lambda m: m.plain_task("im5", _image(5), (60, 60), DETS),
}


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_stage1_builders_match_jax(case):
    got = TASK_CASES[case](stage1_tasks)
    _same_task(got, TASK_CASES[case](jstage1))
    # GQA's rects are painted [x1, x2] (the JAX extractor's inclusive_paint)
    assert got.inclusive_paint == case.startswith("gqa")


QUESTIONS = ["What color is the dog?", "Is the DOGS near the car.",
             "which cats are on the table, the man or the woman?",
             "what is it?", "Is there a car to the left of the dog and a cat?"]
NAMES = ["cat", "dog", "table", "car", "dog"]


@pytest.mark.parametrize("max_marks", [1, 3])
@pytest.mark.parametrize("qi", range(len(QUESTIONS)))
def test_parse_gqa_marks_matches_jax(qi, max_marks):
    boxes = np.concatenate([DETS, DETS[:1] + 1]).tolist()
    got = stage1_tasks.parse_gqa_marks(QUESTIONS[qi], boxes, NAMES, max_marks)
    want = jstage1.parse_gqa_marks(QUESTIONS[qi], boxes, NAMES, max_marks)
    assert got == want
    assert stage1_tasks.STOPWORDS == jstage1.STOPWORDS


def test_payloads_match_jax():
    objs = [[{"rect": [0, 0, 1, 1], "class": "a"}]]
    for case in ("gqa_one", "vg_pair", "plain"):
        task = TASK_CASES[case](stage1_tasks)
        fn = {"gqa_one": "gqa_payload", "vg_pair": "vg_payload",
              "plain": "plain_payload"}[case]
        assert (getattr(extract, fn)(task, objs)
                == getattr(jextract, fn)(TASK_CASES[case](jstage1), objs))


# --- extract_features --task gqa | vg | plain -----------------------------

def _write_inputs(root: str, case: str) -> list:
    """Images, annotations and dets of one extraction case → the tools'
    arguments (both packages take the same)."""
    from PIL import Image

    rng = np.random.RandomState(17)
    names = ["dog", "car", "dog", "person"]
    paths = {}

    def dump(key, obj, binary=False):
        paths[key] = os.path.join(root, f"{key}.{'pk' if binary else 'json'}")
        with open(paths[key], "wb" if binary else "w") as f:
            (pickle.dump if binary else json.dump)(obj, f)

    anns, dets, records = [], {}, []
    for i in range(3):
        img = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img{i}.png"))
        boxes = [[4 + i, 4, 24, 26], [30, 8 + i, 50, 30], [10, 30, 40, 60 - i],
                 [36, 24, 62, 62]]
        xywh = [{"box": [b[0], b[1], b[2] - b[0] + 1, b[3] - b[1] + 1],
                 "class": n} for b, n in zip(boxes, names)]
        if case == "gqa":
            dets[f"im{i}"] = ([[n, b] for n, b in zip(names, boxes)] if i
                              else xywh)
            anns += [{"q_id": f"q{i}a", "img_id": f"im{i}",
                      "img_path": f"img{i}.png",
                      "question": "What color is the dog on the left?"},
                     {"qid": f"q{i}b", "img_id": f"im{i}",
                      "img_path": f"img{i}.png", "question": "Is it a cat?"}]
        elif case == "vg":
            dets[f"img{i}.png"] = xywh
            anns.append({"img": f"img{i}.png", "img_path": f"img{i}.png",
                         "subj_idx": i, "obj_idx": 3 - i, "subj_name": names[i],
                         "obj_name": names[3 - i], "rel": "on"})
        elif case == "plain":
            dets[f"im{i}"] = xywh
            anns.append({"img_id": f"im{i}", "img_path": f"img{i}.png"})
        else:    # vg_pickle: boxes overlapping in some pairs only
            records.append({"img_path": f"img{i}.png", "width": 64,
                            "height": 64, "boxes": np.asarray(boxes, np.float32),
                            "labels": np.asarray([1, 2, 1, 3]),
                            "relations": np.asarray([[0, 2, 1]])})
    ckpt = os.path.join(root, "vinvl.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_vinvl_state_dict(
        jax_tiny_detector_config(), seed=23).items()}, ckpt)
    dump("labelmap", {"idx_to_label": {"1": "dog", "2": "car", "3": "person"}})
    args = ["--task", "vg" if case == "vg_pickle" else case, "--tiny",
            "--dtype", "float32", "--checkpoint", ckpt,
            "--labelmap", paths["labelmap"]]
    if case == "vg_pickle":
        dump("ann", records, binary=True)
        dump("vocab", {"idx_to_label": {"1": "dog", "2": "car", "3": "person"}})
        with open(os.path.join(root, "task.yaml"), "w") as f:
            f.write(f"ann: ann.pk\nvocab: vocab.json\nimage_root: {root}\n")
        return args + ["--yaml", os.path.join(root, "task.yaml")]
    dump("ann", anns)
    dump("det", dets)
    args += ["--ann_file", paths["ann"], "--det_file", paths["det"],
             "--image_root", root]
    if case == "gqa":
        # one question's mark given, the others parsed from the question
        dump("to_mark", {"q1a": [[[30.0, 9.0, 50.0, 30.0], [18]]]})
        args += ["--to_mark", paths["to_mark"]]
    return args


def _rows(path: str) -> list:
    tsv = TSVFile(path)
    rows = [(tsv.seek(i)[0], json.loads(tsv.seek(i)[1])) for i in range(len(tsv))]
    tsv.close()
    return rows


@functools.lru_cache(maxsize=None)
def _extraction(case: str):
    """Both tools' TSV rows on the same inputs and detector weights."""
    root = tempfile.mkdtemp(prefix=f"ext_{case}_")
    args = _write_inputs(root, case)
    jextract_tool.main(args + ["--output", os.path.join(root, "jax.tsv")])
    extract_features.main(args + ["--device", "cpu", "--output",
                                  os.path.join(root, "port.tsv")])
    return (_rows(os.path.join(root, "port.tsv")),
            _rows(os.path.join(root, "jax.tsv")))


def same_rows(got, want, tol=FEATURE_TOL) -> int:
    """Hold one TSV payload to another: every field equal, but features and
    confidences (within ``tol`` of scale) → the number of boxes compared."""
    if isinstance(want, dict) and "feature" in want:
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in ("feature", "conf")} == {
            k: v for k, v in want.items() if k not in ("feature", "conf")}
        gf, wf = decode_feature(got["feature"]), decode_feature(want["feature"])
        assert gf.shape == wf.shape and np.isfinite(gf).all()
        np.testing.assert_allclose(gf, wf, atol=tol * max(np.abs(wf).max(), 1),
                                   rtol=0)
        assert abs(got["conf"] - want["conf"]) <= tol
        return 1
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        return sum(same_rows(g, w, tol) for g, w in zip(got, want))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        return sum(same_rows(got[k], want[k], tol) for k in want)
    assert got == want
    return 0


@pytest.mark.parametrize("case", ["gqa", "vg", "vg_pickle", "plain"])
def test_extract_features_matches_jax(case):
    got, want = _extraction(case)
    assert [k for k, _ in got] == [k for k, _ in want]
    n_rows = {"gqa": 3, "vg": 3, "plain": 3, "vg_pickle": 9}[case]
    assert len(got) == n_rows, [k for k, _ in got]
    assert same_rows([p for _, p in got], [p for _, p in want]) == 4 * n_rows
    classes = {b["class"] for _, p in got for b in _boxes(p["objects"])}
    assert classes and classes <= {"dog", "car", "person", "0", "4", "5", "6"}
    if case == "gqa":
        # q*b ("Is it a cat?") has no mark and no class named in it
        assert [k for k, _ in got] == ["q0a", "q1a", "q2a"]
        assert got[1][1]["objects"][1] == [[[[18], "blue"]]]


def _boxes(objects):
    while isinstance(objects, list) and objects and isinstance(objects[0], list):
        objects = objects[0]
    return objects


# --- stage 2: data ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fixtures():
    root = tempfile.mkdtemp(prefix="gqa_vg_fixture_")
    return (generate_gqa_fixture(os.path.join(root, "gqa"), n_questions=10,
                                 feat_dim=24),
            generate_vg_fixture(os.path.join(root, "vg"), n_pairs=6,
                                feat_dim=24))


def _gqa_data(pkg, tokenizer, use_color=True):
    paths, _ = _fixtures()
    with open(paths["ans2label"]) as f:
        ans2label = json.load(f)
    return pkg.GQACPTData(paths["img_feat_file"], paths["color_img_feat_file"],
                          pkg.load_gqa_examples(paths["questions"]), ans2label,
                          tokenizer, max_seq_len=16, img_seq_len=5,
                          img_feat_dim=24, use_color=use_color)


def _vg_data(pkg, tokenizer):
    _, paths = _fixtures()
    return pkg.VGCPTData(paths["feat_file"], tokenizer, max_seq_len=30,
                         img_seq_len=5, img_feat_dim=24)


def _tokenizers():
    return tok.BertTokenizer(tok.toy_vocab()), jtok.BertTokenizer(jtok.toy_vocab())


def _same_batch(got, want):
    for f in ("input_ids", "segment_ids", "attention_mask", "img_feats",
              "mask_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("use_color", [True, False])
def test_gqa_batches_match_jax(use_color):
    pt, jt = _tokenizers()
    data, jdata = _gqa_data(gqa, pt, use_color), _gqa_data(jgqa, jt, use_color)
    np.testing.assert_array_equal(data.answer_token_ids, jdata.answer_token_ids)
    picks = data.train_indices(12, 88)
    assert picks == jdata.train_indices(12, 88)
    assert len(set(picks)) < 12             # drawn with replacement
    for idxs, pad in (([0, 3], 4), ([5, 6, 7, 9], None)):
        got, glab, gans = data.batch(idxs, pad_to=pad)
        want, wlab, wans = jdata.batch(idxs, pad_to=pad)
        _same_batch(got, want)
        np.testing.assert_array_equal(glab, wlab)
        np.testing.assert_array_equal(gans, wans)
        assert (got.segment_ids[: len(idxs), 0] == 1).all()     # CLS seg 1
    assert data.features_for(data.examples[2])[0] == jdata.features_for(
        jdata.examples[2])[0]
    for d in (data, jdata):
        d.img_feat_tsv.close()


@pytest.mark.parametrize("both", [False, True])
def test_vg_batches_match_jax(both):
    pt, jt = _tokenizers()
    data, jdata = _vg_data(vg, pt), _vg_data(jvg, jt)
    for idxs, pad in (([0, 2], 16), ([1, 3, 5], None)):
        got, glab, gpos, gmeta = data.batch(idxs, both_directions=both,
                                            pad_to=pad)
        want, wlab, wpos, wmeta = jdata.batch(idxs, both_directions=both,
                                              pad_to=pad)
        _same_batch(got, want)
        np.testing.assert_array_equal(glab, wlab)
        np.testing.assert_array_equal(gpos, wpos)
        assert gmeta == wmeta
    assert vg.pair_from_key("a_b.jpg_3_7") == jvg.pair_from_key("a_b.jpg_3_7")
    assert vg.reverse_imkey("a_b.jpg_3_7") == jvg.reverse_imkey("a_b.jpg_3_7")
    data.tsv.close()


def test_vg_predicate_scores_match_jax():
    rng = np.random.RandomState(3)
    probs = rng.dirichlet(np.ones(40), (3, 3)).astype(np.float32)
    tokens = {1: [5], 2: [7, 9], 4: [1, 2, 3], 5: [39]}
    np.testing.assert_array_equal(vg.vg_predicate_scores(probs, [1, 2, 3], tokens),
                                  jvg.vg_predicate_scores(probs, [1, 2, 3], tokens))
    logits = rng.randn(6, 40).astype(np.float32)
    np.testing.assert_array_equal(
        scoring.gqa_answer_scores(logits, np.asarray([3, 1])),
        jscoring.gqa_answer_scores(logits, np.asarray([3, 1])))


# --- stage 2: the model -------------------------------------------------------

def _models(seed=5):
    """(JAX model, JAX params, port model) of REC_MLM_CPT from one seeded
    reference-layout state dict (vocab 160, feature dim 24)."""
    kw = dict(vocab_size=160, img_feature_dim=24)
    jcfg, cfg = jax_tiny_bert_config(**kw), tiny_bert_config(**kw)
    sd = jconv.random_oscar_state_dict(jcfg, seed=seed)
    jparams = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    port = REC_MLM_CPT(cfg, torch.float32).eval()
    port.load_state_dict(bconv.state_from_reference(sd, cfg))
    return jheads.REC_MLM_CPT(jcfg, dtype=jnp.float32), jparams, port


def _small_vocab(a):
    return np.minimum(a, 159)


def test_gqa_answer_scores_match_jax():
    pt, jt = _tokenizers()
    data = _gqa_data(gqa, pt)
    b, _, _ = data.batch(list(range(6)), pad_to=8)
    jmodel, jparams, port = _models()
    arrays = (_small_vocab(b.input_ids), b.segment_ids, b.attention_mask,
              b.img_feats, b.mask_pos)
    want = np.asarray(jscoring.make_mlm_at_mask_fn(jmodel)(jparams, *arrays))
    got = scoring.make_mlm_at_mask_fn(port)(*arrays)
    assert got.shape == want.shape == (8, 160)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    ans = np.asarray([3, 150, 7])
    np.testing.assert_allclose(scoring.gqa_answer_scores(got, ans),
                               jscoring.gqa_answer_scores(want, ans), rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    data.img_feat_tsv.close()


def test_vg_multi_mask_probabilities_match_jax():
    pt, _ = _tokenizers()
    data = _vg_data(vg, pt)
    b, _, pos, _ = data.batch([0, 1], both_directions=True, pad_to=12)
    jmodel, jparams, port = _models(6)
    arrays = (_small_vocab(b.input_ids), b.segment_ids, b.attention_mask,
              b.img_feats, np.maximum(pos, 0))
    want = np.asarray(jvg_tool.make_multi_mask_fn(jmodel)(jparams, *arrays))
    got = vg_cpt.make_multi_mask_fn(port)(*arrays)
    assert got.shape == want.shape == (12, 3, 160) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    data.tsv.close()


def test_mlm_train_step_accumulates_like_jax():
    """Two calls of ``make_mlm_train_step`` under ``grad_accum_steps`` 2
    (GQA's recipe: stock betas, clip 1.0, dropout off): the first leaves
    the parameters, the second steps them once with the mean gradient, as
    optax's ``MultiSteps`` does."""
    pt, _ = _tokenizers()
    data = _gqa_data(gqa, pt)
    jmodel, jparams, port = _models(7)
    ocfg = dict(learning_rate=1e-3, weight_decay=0.05, warmup_steps=0,
                num_train_steps=4, betas=(0.9, 0.999), max_grad_norm=1.0,
                grad_accum_steps=2)
    jtx = jtrain.build_optimizer(jparams, jtrain.OptimConfig(**ocfg))
    jstate = jtrain.create_train_state(jparams, jtx)
    jstep = jtrain.make_mlm_train_step(jmodel, jtx, dropout=False)
    tx = train.build_optimizer(port, train.OptimConfig(**ocfg))
    state = train.create_train_state(port, tx)
    step = train.make_mlm_train_step(port, tx, dropout=False)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for call, idxs in enumerate(([0, 1, 2, 3], [4, 5, 6, 7])):
        b, labels, _ = data.batch(idxs)
        batch = (_small_vocab(b.input_ids), b.segment_ids, b.attention_mask,
                 b.img_feats, b.mask_pos, _small_vocab(labels))
        jstate, wloss = jstep(jstate, tuple(jnp.asarray(a) for a in batch),
                              jax.random.PRNGKey(0))
        state, loss = step(state, tuple(torch.from_numpy(a) for a in batch))
        assert abs(float(loss) - float(wloss)) <= LOGIT_TOL
        if call == 0:
            assert all(torch.equal(v, before[k])
                       for k, v in port.state_dict().items())
    assert state.opt_state.count == 1 and state.step == 2
    want = bconv.params_from_jax(jax.device_get(jstate.params), port.config)
    got = port.state_dict()
    moved = 0
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        moved += not torch.equal(got[k], before[k])
    assert moved > 10
    data.img_feat_tsv.close()


# --- the tools ----------------------------------------------------------------

def _gqa_args():
    paths, _ = _fixtures()
    return ["--img_feat_file", paths["img_feat_file"], "--color_img_feat_file",
            paths["color_img_feat_file"], "--questions", paths["questions"],
            "--ans2label", paths["ans2label"], "--hidden_size", "32",
            "--num_hidden_layers", "2", "--img_feature_dim", "24",
            "--max_seq_length", "16", "--max_img_seq_length", "5",
            "--per_gpu_eval_batch_size", "4", "--dtype", "float32"]


def _vg_args():
    _, paths = _fixtures()
    return ["--feat_file", paths["feat_file"], "--predicate_vocab",
            paths["predicate_vocab"], "--gt_file", paths["gt_file"],
            "--hidden_size", "32", "--num_hidden_layers", "2",
            "--img_feature_dim", "24", "--max_seq_length", "30",
            "--max_img_seq_length", "5", "--per_gpu_eval_batch_size", "12",
            "--dtype", "float32"]


@functools.lru_cache(maxsize=None)
def _checkpoint() -> str:
    jcfg = jgqa_tool.model_config(jgqa_tool.build_args().parse_args(_gqa_args()))
    path = os.path.join(tempfile.mkdtemp(prefix="gqa_vg_ckpt_"), "oscar.bin")
    torch.save({k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jcfg, seed=6).items()}, path)
    return path


def test_gqa_tool_zero_shot_matches_jax(tmp_path):
    common = _gqa_args() + ["--checkpoint", _checkpoint(), "--num_train_epochs",
                            "0"]
    want = jgqa_tool.main(common + ["--output", str(tmp_path / "jax.pk")])
    got = gqa_cpt.main(common + ["--device", "cpu", "--output",
                                 str(tmp_path / "port.pk")])
    assert got == want
    with open(tmp_path / "jax.pk", "rb") as f, open(tmp_path / "port.pk", "rb") as g:
        w, p = pickle.load(f)["results"], pickle.load(g)["results"]
    assert sorted(p) == sorted(w) and len(p) == 10
    for q in w:
        assert p[q]["pred"] == w[q]["pred"]
        np.testing.assert_allclose(p[q]["scores"], w[q]["scores"], rtol=0,
                                   atol=SCORE_TOL)


def test_vg_tool_zero_shot_matches_jax(tmp_path):
    common = _vg_args() + ["--checkpoint", _checkpoint()]
    wpred, wrec = jvg_tool.main(common)
    gpred, grec = vg_cpt.main(common + ["--device", "cpu", "--output",
                                        str(tmp_path / "port.pk")])
    assert sorted(gpred) == sorted(wpred) and len(gpred) == 12
    for k in wpred:
        np.testing.assert_allclose(gpred[k], wpred[k], rtol=0, atol=LOGPROB_TOL)
    assert grec == wrec
    with open(tmp_path / "port.pk", "rb") as f:
        assert pickle.load(f)["recall"] == grec


def test_gqa_tool_trains_with_accumulation(monkeypatch):
    """8 samples at batch 4: 2 calls an optimizer step; ``--eval_every``
    keeps the parameters of the best val accuracy."""
    calls = []
    real = gqa_cpt.train

    def spy(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(gqa_cpt, "train", spy)
    paths, _ = _fixtures()
    acc = gqa_cpt.main(_gqa_args() + [
        "--device", "cpu", "--num_train_epochs", "2", "--n_sample", "8",
        "--per_gpu_train_batch_size", "4", "--eval_every", "1",
        "--val_questions", paths["questions"]])
    assert 0.0 <= acc <= 100.0
    assert len(calls[0]) == 4 and np.isfinite(calls[0]).all()


def test_vg_tool_trains_then_evaluates():
    _, paths = _fixtures()
    pred, rec = vg_cpt.main(_vg_args() + [
        "--device", "cpu", "--train_feat_file", paths["feat_file"],
        "--num_train_epochs", "2", "--per_gpu_train_batch_size", "4"])
    assert len(pred) == 12 and all(np.isfinite(v).all() for v in pred.values())
    assert set(rec) == {"R@20", "R@50", "R@100", "mR@20", "mR@50", "mR@100"}


@pytest.mark.parametrize("flags,item", [
    (["--model_variant", "ft"], "item 4"), (["--save_dir", "d"], "item 4")])
def test_gqa_tool_refuses_what_is_not_ported(flags, item, monkeypatch,
                                             tmp_path):
    """The flags Queue 1 ``item`` ported (the finetune baseline and
    ``--save_dir``; tests/test_torch_ft.py holds them to JAX) now run; a
    multi-process launch still refuses, naming item 9."""
    flags = [str(tmp_path / f) if f == "d" else f for f in flags]
    acc = gqa_cpt.main(_gqa_args() + flags + ["--device", "cpu",
                                              "--num_train_epochs", "0"])
    assert 0.0 <= acc <= 100.0
    if "--save_dir" in flags:
        assert (tmp_path / "d" / "config.json").exists()
        assert (tmp_path / "d" / "last_checkpoint").read_text() == "model"
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    for tool, args in ((gqa_cpt, _gqa_args()), (vg_cpt, _vg_args())):
        with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 9"):
            tool.main(args)


def test_extract_features_refuses_the_config_front_end(tmp_path):
    for flags in (["--config_file", "c.yaml"], ["--opts", "MODEL.X", "1"]):
        with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 3"):
            extract_features.main(["--output", str(tmp_path / "o.tsv")] + flags)
    assert not (tmp_path / "o.tsv").exists()


# --- evaluation, ensembles and the small tools -------------------------------

@pytest.mark.parametrize("softmax", [True, False])
def test_vg_recall_eval_matches_jax(softmax):
    rng = np.random.RandomState(4)
    preds = {f"im{i}.jpg_{s}_{o}": rng.randn(8).astype(np.float32)
             for i in range(3) for s in range(3) for o in range(3) if s != o}
    for i in range(3):                  # one right relation an image
        preds[f"im{i}.jpg_0_1"][1 + i] += 5.0
    gts = [{"img_path": f"im{i}.jpg",
            "relations": np.asarray([[0, 1, 1 + i], [2, 0, 3], [1, 2, 7]])}
           for i in range(4)]
    got = evaluate.vg_recall_eval(preds, gts, apply_softmax=softmax, num_classes=8)
    want = jevaluate.vg_recall_eval(preds, gts, apply_softmax=softmax,
                                    num_classes=8)
    assert got == want and got["R@100"] > 0
    sweep = {1: {0: 50.0, 1: 60.0}, 16: {0: 70.0, 5: 71.5, 6: 69.0}}
    assert evaluate.seed_sweep_report(sweep) == jevaluate.seed_sweep_report(sweep)
    a, b = rng.randn(5, 4), rng.randn(5, 4)
    np.testing.assert_array_equal(evaluate.ensemble_logits(a, b, 2.0, 0.5),
                                  jevaluate.ensemble_logits(a, b, 2.0, 0.5))


@pytest.mark.parametrize("task", ["gqa", "vcr", "vcr_qar"])
def test_show_ensemble_matches_jax(task, tmp_path):
    from cpt_tpu.tools import show_ensemble as jshow
    from cpt_tpu_torch.tools import show_ensemble

    rng = np.random.RandomState(8)

    def results():
        res = {f"q{i}": {"scores": rng.randn(4).tolist(), "gt": i % 4}
               for i in range(9)}
        return {"qa": res, "qar": dict(res)} if task == "vcr_qar" else res

    for name in ("pt", "cpt"):
        with open(tmp_path / f"{name}.pk", "wb") as f:
            pickle.dump({"results": results()}, f)
    with open(tmp_path / "labels.json", "w") as f:
        json.dump({f"q{i}": i % 4 for i in range(9)}, f)
    args = ["--pt_results", str(tmp_path / "pt.pk"), "--cpt_results",
            str(tmp_path / "cpt.pk"), "--task", task, "--labels",
            str(tmp_path / "labels.json"), "--pt_weight", "2.5"]
    assert show_ensemble.main(args) == jshow.main(args)


def test_tsv_tools_match_jax(tmp_path):
    """``merge_shards`` (globs, in order), ``ext_objects`` (both layouts)
    and ``img_info`` (image scan, bbox.pk, the RefCOCO ceiling) write what
    the JAX tools write."""
    from cpt_tpu.tools import ext_objects as jext
    from cpt_tpu.tools import img_info as jinfo
    from cpt_tpu.tools import merge_shards as jmerge
    from cpt_tpu_torch.tools import ext_objects, img_info, merge_shards
    from cpt_tpu_torch.utils.tsv import tsv_writer

    got_rows, _ = _extraction("vg")
    rows = [(k, json.dumps(p)) for k, p in got_rows]
    for i in range(3):
        tsv_writer(rows[i:i + 1], str(tmp_path / f"s.shard{i}.tsv"))
    outs = {}
    for name, m in (("port", merge_shards), ("jax", jmerge)):
        m.main(["--shards", str(tmp_path / "s.shard*.tsv"), "--output",
                str(tmp_path / f"{name}.tsv")])
        outs[name] = (tmp_path / f"{name}.tsv").read_bytes()
    assert outs["port"] == outs["jax"] and outs["port"].count(b"\n") == 3
    plain_rows, _ = _extraction("plain")
    tsv_writer([(k, json.dumps(p)) for k, p in plain_rows],
               str(tmp_path / "plain.tsv"))
    for src in ("port.tsv", "plain.tsv"):
        for extra in ([], ["--classes_only"]):
            for name, m in (("p", ext_objects), ("j", jext)):
                m.main(["--tsv", str(tmp_path / src), "--output",
                        str(tmp_path / f"{name}.json")] + extra)
            assert ((tmp_path / "p.json").read_text()
                    == (tmp_path / "j.json").read_text())
    from PIL import Image

    root = tmp_path / "images"
    for d in ("images", "p", "j"):
        (tmp_path / d).mkdir()
    for i in range(2):
        Image.fromarray(_image(i, 20 + i, 30)).save(root / f"{i}.jpg")
    assert (img_info.create_img_info(str(root), str(tmp_path / "a.json"))
            == jinfo.create_img_info(str(root), str(tmp_path / "b.json")))
    got = img_info.create_img_bbox(str(tmp_path / "plain.tsv"),
                                   str(tmp_path / "p" / "x"))
    want = jinfo.create_img_bbox(str(tmp_path / "plain.tsv"),
                                 str(tmp_path / "j" / "x"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with open(tmp_path / "ann.json", "w") as f:
        json.dump([{"file_name": "COCO_val2014_000000000007.jpg",
                    "bbox": [4, 4, 20, 20]},
                   {"file_name": "COCO_val2014_000000000008.jpg",
                    "bbox": [40, 40, 10, 10]}], f)
    with open(tmp_path / "dets.json", "w") as f:
        json.dump({"7": [{"box": [5, 5, 20, 20]}], "8": [{"box": [0, 0, 5, 5]}]},
                  f)
    args = (str(tmp_path / "ann.json"), str(tmp_path / "dets.json"))
    assert img_info.refcoco_upper_bound(*args) == jinfo.refcoco_upper_bound(
        *args) == 0.5
