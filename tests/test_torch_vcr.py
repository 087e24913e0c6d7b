"""CPT's VCR path, the port against the JAX package on the CPU in f32 at
tiny sizes, from the same seeded inputs and reference-layout weights:
the VCR prompt text, the stage-1 entity groups and color task (image bit
for bit), ``extract_features --task vcr`` in both annotation layouts, the
stage-2 batches, ``NSPCPT`` / ``VCRQAR_NSPCPT`` logits, the NSP scorer,
one NSP training step, and the ``vcr_nsp_cpt`` tool for each task."""
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
from cpt_tpu.data import prompts as jprompts
from cpt_tpu.data import stage1_tasks as jstage1
from cpt_tpu.data import vcr as jvcr
from cpt_tpu.data.synthetic import generate_vcr_fixture
from cpt_tpu.engine import scoring as jscoring
from cpt_tpu.engine import train as jtrain
from cpt_tpu.models.bert import heads as jheads
from cpt_tpu.models.detector.config import \
    tiny_detector_config as jax_tiny_detector_config
from cpt_tpu.models.detector.convert import random_vinvl_state_dict
from cpt_tpu.tools import extract_features as jextract_tool
from cpt_tpu.tools import vcr_nsp_cpt as jvcr_tool
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.data import prompts, stage1_tasks, vcr
from cpt_tpu_torch.engine import scoring, train
from cpt_tpu_torch.engine.extract import vcr_payload
from cpt_tpu_torch.models.bert.heads import NSPCPT, VCRQAR_NSPCPT
from cpt_tpu_torch.tools import extract_features, vcr_nsp_cpt
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

# extraction through the tiny detector in f32: summation-order noise only
# (the slice test's tolerance)
FEATURE_TOL = 2e-4
# logits and scores of a tiny BERT in f32
LOGIT_TOL = 1e-5
SCORE_TOL = 1e-4
# one AdamW step on gradients that agree to f32 noise (parameters O(0.1))
PARAM_ATOL = 1e-5

COLORS = {"0": "blue", "1_2": "red", "3": "yellow"}
NAMES = {"0": "person", "1_2": "people", "3": "dog", "4": "cat"}
SENTENCES = [["what", "is", [0], "doing", "?"],
             ["why", "are", [2, 1], "near", [3], "and", [4], "?"],
             [[4], "is", "a", "cat"], []]


def test_vcr_textize_copy():
    assert prompts.CROSS_TASK_COLORS == jprompts.CROSS_TASK_COLORS
    for ids in ([2, 1], [0], [3, 10, 2]):
        assert prompts.vcr_entity_key(ids) == jprompts.vcr_entity_key(ids)
    for sent in SENTENCES:
        for colorful in (True, False):
            assert (prompts.vcr_textize(sent, COLORS, NAMES, colorful)
                    == jprompts.vcr_textize(sent, COLORS, NAMES, colorful))


ANN = {"question": ["is", [1], "with", [0, 2], "?"],
       "answers": [[[2, 0], "is"], [[3], "yes"], ["no", [1]]],
       "rationales": [[[4], "sees", [3]], [[5, 1]]]}


def test_vcr_entity_groups_copy():
    assert stage1_tasks.vcr_entity_groups(ANN) == jstage1.vcr_entity_groups(ANN)
    vis, txt = stage1_tasks.vcr_entity_groups(ANN)
    assert vis == [[1], [0, 2], [3]] and txt == vis + [[4], [1, 5]]


# polygons: a square, a multi-part member whose first part is empty, a
# triangle with float vertices, one member without a polygon
POLYS = {0: [(5, 5), (20, 5), (20, 20), (5, 20)],
         1: [[], [(30.5, 10.2), (48, 10), (47.3, 28.9), (30, 28)]],
         2: [(10, 30), (40.7, 35.5), (22.2, 55)],
         4: [(50, 50), (58, 51)]}
ENTITY_NAMES = {0: "person", 1: "person", 2: "dog", 3: "person", 4: "cat"}
DETS = np.array([[4, 4, 24, 24], [30, 8, 50, 30], [8, 28, 42, 56],
                 [4, 4, 24, 24], [48, 48, 59, 59]], np.float32)
COLOR_CASES = {
    # groups: colors advance per group; member 3 shares member 0's box, so
    # it is skipped, its group takes no color and the count does not
    # advance ([4] takes the third color)
    "groups": dict(entity_ids=[[0], [1, 2], [3], [4]]),
    # one group whose members' paints disagree (3 skipped): no color word
    "dedup_same_group": dict(entity_ids=[[0, 3], [4]]),
    "color_d_0": dict(entity_ids=[[0], [1, 2]], color_d=0),
    "color_d_2": dict(entity_ids=[[0], [1], [2], [4]], color_d=2),
    "txt_ids": dict(entity_ids=[[0], [2]], txt_entity_ids=[[0], [2], [1, 4]]),
}


def _image(seed=3):
    return np.random.RandomState(seed).randint(0, 256, (60, 60, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("case", sorted(COLOR_CASES))
def test_vcr_color_task_matches_jax(case):
    """The composited image bit for bit, the meta, and the one unpainted
    copy, on the same polygons, boxes and names."""
    kw = COLOR_CASES[case]
    img = _image()
    got = stage1_tasks.vcr_color_task("v", img, (60, 60), DETS,
                                      entity_polygons=POLYS,
                                      entity_names=ENTITY_NAMES, **kw)
    want = jstage1.vcr_color_task("v", img, (60, 60), DETS,
                                  entity_polygons=POLYS,
                                  entity_names=ENTITY_NAMES, **kw)
    np.testing.assert_array_equal(got.image_rgb, want.image_rgb)
    assert got.meta == want.meta
    for f in ("det_boxes", "copy_rects", "copy_rect_valid", "copy_colors_rgba"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.n_copies == 1 and not got.copy_rect_valid.any()
    if case == "groups":
        assert got.meta["obj_colors"] == {"0": "blue", "1_2": "red",
                                          "4": "yellow"}
        assert not np.array_equal(got.image_rgb, img)
    if case == "color_d_0":
        np.testing.assert_array_equal(got.image_rgb, img)


def test_vcr_color_task_is_its_mask_step():
    """``vcr_color_task`` is the rasterizer followed by
    ``vcr_color_task_from_masks``: numpy masks give the same task."""
    img = _image(4)
    ids = COLOR_CASES["groups"]["entity_ids"]
    masks = {i: stage1_tasks.rasterize_polygon(POLYS.get(i, []), 60, 60)
             for g in ids for i in g}
    for i, p in POLYS.items():
        np.testing.assert_array_equal(
            masks.get(i, stage1_tasks.rasterize_polygon(p, 60, 60)),
            jstage1.rasterize_polygon(p, 60, 60))
    got = stage1_tasks.vcr_color_task_from_masks("v", img, (60, 60), DETS, ids,
                                                 masks, ENTITY_NAMES)
    want = stage1_tasks.vcr_color_task("v", img, (60, 60), DETS, ids, POLYS,
                                       ENTITY_NAMES)
    np.testing.assert_array_equal(got.image_rgb, want.image_rgb)
    assert got.meta == want.meta
    assert vcr_payload(got, [["boxes"]]) == {
        "objects": [["boxes"], [got.meta["obj_colors"], got.meta["obj_names"]]]}


def _write_vcr_inputs(root: str, layout: str) -> list:
    """Images, annotations and dets of 3 VCR questions in ``layout``
    ("annot_id": the reference's own, with ``--to_mark`` and a segms json
    per image; "img_key": records with their own groups and polygons) →
    the tools' arguments."""
    from PIL import Image

    rng = np.random.RandomState(9)
    anns, dets, to_mark = [], {}, {}
    for q in range(3):
        name = f"img{q}"
        Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
            os.path.join(root, name + (".jpg" if layout == "annot_id"
                                       else ".png")))
        boxes = [[4 + q, 4, 24, 26], [30, 8 + q, 50, 30], [4 + q, 4, 24, 26],
                 [10, 34, 58, 60]]
        names = ["person", "person", "dog", "car"]
        polys = [[[5 + q, 5], [20, 5], [20, 20.5], [5, 21]],
                 [[[31, 9], [48, 10], [47.5, 28], [30, 27]]],
                 [[6, 6], [18, 7], [12, 19]],
                 [[12, 36], [56, 40], [40, 59]]]
        if layout == "annot_id":
            anns.append({"annot_id": f"val-{q}", "img_id": name,
                         "img_path": name + ".jpg",
                         "question": ["is", [0], "near", [1, 2], "?"],
                         "answers": [[[2], "is"], [[3], "yes"]],
                         "rationales": [[[1], "sees", [3]]]})
            dets[name] = [[n, b] for n, b in zip(names, boxes)]
            to_mark[name] = {"boxes": boxes, "names": names}
            with open(os.path.join(root, name + ".json"), "w") as f:
                json.dump({"segms": polys}, f)
        else:
            anns.append({"img_key": f"k{q}", "img_path": name + ".png",
                         "entity_ids": [[0], [1, 2], [3]],
                         "entity_polygons": {str(i): p for i, p in
                                             enumerate(polys)},
                         "entity_names": {str(i): n for i, n in
                                          enumerate(names)}})
            dets[f"k{q}"] = [{"box": [b[0], b[1], b[2] - b[0] + 1,
                                      b[3] - b[1] + 1]} for b in boxes]
    paths = {k: os.path.join(root, f"{k}.json") for k in ("ann", "det", "tm")}
    for key, obj in (("ann", anns), ("det", dets), ("tm", to_mark)):
        with open(paths[key], "w") as f:
            json.dump(obj, f)
    ckpt = os.path.join(root, "vinvl.pth")
    torch.save({k: torch.from_numpy(v) for k, v in random_vinvl_state_dict(
        jax_tiny_detector_config(), seed=21).items()}, ckpt)
    args = ["--task", "vcr", "--ann_file", paths["ann"], "--det_file",
            paths["det"], "--image_root", root, "--tiny", "--dtype", "float32",
            "--checkpoint", ckpt, "--color_d", "3"]
    return args + (["--to_mark", paths["tm"]] if layout == "annot_id" else [])


def _rows(path: str) -> list:
    tsv = TSVFile(path)
    rows = [(tsv.seek(i)[0], json.loads(tsv.seek(i)[1])) for i in range(len(tsv))]
    tsv.close()
    return rows


@functools.lru_cache(maxsize=None)
def _extraction(layout: str):
    """Both tools' TSV rows on the same inputs and detector weights."""
    root = tempfile.mkdtemp(prefix=f"vcr_{layout}_")
    args = _write_vcr_inputs(root, layout)
    jextract_tool.main(args + ["--output", os.path.join(root, "jax.tsv")])
    extract_features.main(args + ["--device", "cpu", "--output",
                                  os.path.join(root, "port.tsv")])
    return _rows(os.path.join(root, "port.tsv")), _rows(os.path.join(root,
                                                                      "jax.tsv"))


@pytest.mark.parametrize("layout", ["annot_id", "img_key"])
def test_extract_features_vcr_matches_jax(layout):
    got, want = _extraction(layout)
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 3
    for (_, g), (_, w) in zip(got, want):
        (gboxes, gmeta), (wboxes, wmeta) = g["objects"], w["objects"]
        assert gmeta == wmeta and gmeta[0]      # some group was colored
        assert [b["rect"] for b in gboxes] == [b["rect"] for b in wboxes]
        assert [b["class"] for b in gboxes] == [b["class"] for b in wboxes]
        gf = np.stack([decode_feature(b["feature"]) for b in gboxes])
        wf = np.stack([decode_feature(b["feature"]) for b in wboxes])
        assert gf.shape == (4, 134) and np.isfinite(gf).all()
        np.testing.assert_allclose(gf, wf, atol=FEATURE_TOL, rtol=FEATURE_TOL)
        np.testing.assert_allclose([b["conf"] for b in gboxes],
                                   [b["conf"] for b in wboxes],
                                   atol=FEATURE_TOL, rtol=FEATURE_TOL)


@functools.lru_cache(maxsize=None)
def _fixture():
    root = tempfile.mkdtemp(prefix="vcr_fixture_")
    return generate_vcr_fixture(root, n_questions=8, feat_dim=24)


def _data(pkg_vcr, tokenizer):
    paths = _fixture()
    return pkg_vcr.VCRCPTData(paths["feat_file"],
                              pkg_vcr.load_vcr_examples(paths["examples"]),
                              tokenizer, max_seq_len=20, img_seq_len=6,
                              img_feat_dim=24)


@pytest.mark.parametrize("use_rationale", [False, True])
def test_vcr_batches_match_jax(use_rationale):
    data = _data(vcr, tok.BertTokenizer(tok.toy_vocab()))
    jdata = _data(jvcr, jtok.BertTokenizer(jtok.toy_vocab()))
    assert len(data) == len(jdata) == 8
    for idxs, pad in (([0, 3], 8), ([5, 6, 7], None)):
        got, glab, gmeta = data.batch(idxs, use_rationale=use_rationale,
                                      pad_to=pad)
        want, wlab, wmeta = jdata.batch(idxs, use_rationale=use_rationale,
                                        pad_to=pad)
        for f in ("input_ids", "segment_ids", "attention_mask", "img_feats",
                  "valid"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(glab, wlab)
        assert gmeta == wmeta
    data.tsv.close()


def _configs():
    kw = dict(vocab_size=160, img_feature_dim=20)
    return jax_tiny_bert_config(**kw), tiny_bert_config(**kw)


def _nsp_inputs(seed=2):
    rng = np.random.RandomState(seed)
    n, t, r = 6, 12, 5
    ids = rng.randint(1, 160, (n, t)).astype(np.int32)
    ids[:, 0] = 101
    seg = (np.arange(t) >= 5).astype(np.int32)[None].repeat(n, 0)
    mask = np.ones((n, t + r), np.int32)
    mask[1, 9:t] = 0
    mask[2, t + 2:] = 0
    feats = rng.randn(n, r, 20).astype(np.float32)
    labels = np.asarray([0, 1, 1, 1, 0, -1], np.int32)
    return ids, seg, mask, feats, labels


def _nsp_models(task, from_jax, seed=5):
    """(JAX model, JAX params, port model) of ``task`` from one seeded
    reference-layout state dict; the port loads it natively
    (``state_from_reference``) or through the JAX tree
    (``params_from_jax``), whose twin "rat" head is then moved off the
    copied NSP head so the two heads differ."""
    jcfg, cfg = _configs()
    sd = jconv.random_oscar_state_dict(jcfg, seed=seed)
    jparams = jconv.params_for_task(jconv.convert_bert_state_dict(sd, jcfg), task)
    twin = task == "vcr_qar_nsp_cpt"
    if twin and from_jax:
        rat = jparams["cls_rat"]["dense"]
        rat["kernel"] = rat["kernel"] + 0.05 * np.random.RandomState(1).randn(
            *rat["kernel"].shape).astype(np.float32)
    jparams = {"params": jparams}
    jmodel = (jheads.VCRQAR_NSPCPT if twin else jheads.NSPCPT)(jcfg, dtype=jnp.float32)
    port = (VCRQAR_NSPCPT if twin else NSPCPT)(cfg, torch.float32).eval()
    state = (bconv.params_from_jax(jparams, cfg, task) if from_jax
             else bconv.state_from_reference(sd, cfg, task))
    port.load_state_dict(state)
    return jmodel, jparams, port


NSP_CASES = [("nsp_cpt", None), ("vcr_qar_nsp_cpt", "ans"),
             ("vcr_qar_nsp_cpt", "rat")]


@pytest.mark.parametrize("from_jax", [False, True])
@pytest.mark.parametrize("task,head", NSP_CASES)
def test_nsp_logits_match_jax(task, head, from_jax):
    jmodel, jparams, port = _nsp_models(task, from_jax)
    ids, seg, mask, feats, labels = _nsp_inputs()
    kw = {} if head is None else {"head": head}
    wloss, want = jmodel.apply(jparams, ids, seg, mask, img_feats=feats,
                               next_sentence_label=labels, **kw)
    with torch.no_grad():
        gloss, got = port(*(torch.from_numpy(a) for a in (ids, seg, mask)),
                          img_feats=torch.from_numpy(feats),
                          next_sentence_label=torch.from_numpy(labels), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    assert abs(float(gloss) - float(wloss)) <= LOGIT_TOL


@pytest.mark.parametrize("task,head", NSP_CASES)
def test_nsp_score_fn_matches_jax(task, head):
    jmodel, jparams, port = _nsp_models(task, from_jax=True)
    ids, seg, mask, feats, _ = _nsp_inputs(3)
    want = jscoring.make_nsp_score_fn(jmodel, head=head)(jparams, ids, seg,
                                                         mask, feats)
    got = scoring.make_nsp_score_fn(port, head=head)(ids, seg, mask, feats)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("task,head", NSP_CASES)
def test_nsp_train_step_matches_jax(task, head):
    """One AdamW step with dropout off (stock betas, clip 1.0, the VCR
    tool's optimizer): the loss and every updated parameter."""
    jmodel, jparams, port = _nsp_models(task, from_jax=True)
    batch = _nsp_inputs(4)
    ocfg = dict(learning_rate=1e-4, weight_decay=0.05, warmup_steps=0,
                num_train_steps=10, betas=(0.9, 0.999), max_grad_norm=1.0)
    jtx = jtrain.build_optimizer(jparams, jtrain.OptimConfig(**ocfg))
    jstate = jtrain.create_train_state(jparams, jtx)
    jstep = jtrain.make_nsp_train_step(jmodel, jtx, head=head, dropout=False)
    jstate, wloss = jstep(jstate, tuple(jnp.asarray(a) for a in batch),
                          jax.random.PRNGKey(0))
    want = bconv.params_from_jax(jax.device_get(jstate.params), port.config, task)

    tx = train.build_optimizer(port, train.OptimConfig(**ocfg))
    state = train.create_train_state(port, tx)
    step = train.make_nsp_train_step(port, tx, head=head, dropout=False)
    state, loss = step(state, tuple(torch.from_numpy(a) for a in batch))
    assert state.step == 1 and not port.training
    assert abs(float(loss) - float(wloss)) <= LOGIT_TOL
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def _tool_args(task):
    paths = _fixture()
    return ["--feat_file", paths["feat_file"], "--examples", paths["examples"],
            "--task", task, "--hidden_size", "32", "--num_hidden_layers", "2",
            "--img_feature_dim", "24", "--max_seq_length", "20",
            "--max_img_seq_length", "6", "--per_gpu_eval_batch_size", "3",
            "--dtype", "float32"]


@functools.lru_cache(maxsize=None)
def _checkpoint() -> str:
    jcfg = jvcr_tool.model_config(jvcr_tool.build_args().parse_args(
        _tool_args("qa")))
    path = os.path.join(tempfile.mkdtemp(prefix="vcr_ckpt_"), "oscar.bin")
    torch.save({k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jcfg, seed=6).items()}, path)
    return path


@pytest.mark.parametrize("task", ["qa", "qar_r", "qar"])
def test_tool_zero_shot_matches_jax(task, tmp_path):
    """The same Oscar-layout ``--checkpoint`` into both tools: the same
    accuracy, the same pick per question and per-candidate scores within
    SCORE_TOL (q→ar: both heads' results)."""
    common = _tool_args(task) + ["--checkpoint", _checkpoint()]
    want = jvcr_tool.main(common + ["--output", str(tmp_path / "jax.pkl")])
    got = vcr_nsp_cpt.main(common + ["--device", "cpu", "--output",
                                     str(tmp_path / "port.pkl")])
    assert got == want
    with open(tmp_path / "jax.pkl", "rb") as f, open(tmp_path / "port.pkl",
                                                      "rb") as g:
        w, p = pickle.load(f), pickle.load(g)
    groups = ([(p["results"][k], w["results"][k]) for k in ("qa", "qar")]
              if task == "qar" else [(p["results"], w["results"])])
    for pres, wres in groups:
        assert sorted(pres) == sorted(wres) and len(pres) == 8
        for q in wres:
            assert pres[q]["pred"] == wres[q]["pred"]
            assert pres[q]["gt"] == wres[q]["gt"]
            np.testing.assert_allclose(pres[q]["scores"], wres[q]["scores"],
                                       rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("task", ["qa", "qar"])
def test_tool_trains_then_evaluates(task, monkeypatch):
    losses = []
    real = vcr_nsp_cpt.train

    def spy(*a, **kw):
        losses.extend(real(*a, **kw))
        return losses

    monkeypatch.setattr(vcr_nsp_cpt, "train", spy)
    acc = vcr_nsp_cpt.main(_tool_args(task) + [
        "--device", "cpu", "--num_train_epochs", "2",
        "--per_gpu_train_batch_size", "4"])
    assert 0.0 <= acc <= 100.0
    assert len(losses) == 4 and np.isfinite(losses).all()


def test_tool_refuses_what_is_not_ported(monkeypatch):
    """``--model_variant ft`` (Queue 1 item 4) now runs (NSPFT;
    tests/test_torch_ft.py holds it to JAX); a multi-process launch still
    refuses, naming item 9."""
    acc = vcr_nsp_cpt.main(_tool_args("qa") + ["--model_variant", "ft",
                                               "--device", "cpu"])
    assert 0.0 <= acc <= 100.0
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 9"):
        vcr_nsp_cpt.main(_tool_args("qa"))
