"""The Oscar runners' data modules (``data/vqa.py``, ``nlvr.py``,
``retrieval.py``), the port's copies against the JAX package's on the same
fixtures, exactly: every batch array, the soft and hard labels, NLVR2's
pair and concat layouts, each attention-mask type of retrieval, the
training pairs and the re-rank entries, on the JSON/TSV files and on the
reference's own ``.pt`` layouts; the ranking functions on golden cases;
then, without JAX, the runners' refusals, ``--adjust_dp`` /
``--adjust_loss`` and ``--resume`` bit-equal to an uninterrupted run."""
import base64
import dataclasses
import functools
import json
import os
import pickle
import random
import tempfile

import numpy as np
import pytest
import torch

from cpt_tpu.data import nlvr as jnlvr
from cpt_tpu.data import retrieval as jretrieval
from cpt_tpu.data import vqa as jvqa
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.data import nlvr, retrieval, vqa
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.models.bert.model import Dropout
from cpt_tpu_torch.tools import run_gqa, run_nlvr, run_retrieval, run_vqa
from cpt_tpu_torch.utils import tokenization as tok
from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer
from test_torch_watchdog import guards

guard_module, guard_case = guards(150)

D = 20                       # feature width of the fixtures
N_IMG = 6
N_REGIONS = (3, 9, 5, 6, 1, 7)   # some past the 6 region slots
CLASSES = ("man", "dog", "red car", "woman", "cat", "blue shirt", "tree")
STATEMENTS = ("the dog is on the left", "there is a man and a woman in "
              "the picture wearing a blue shirt next to a red car",
              "two cats", "a tree")
CAPTIONS = ("a man with a dog", "the woman in a blue shirt stands next to "
            "the red car by the tree", "cats", "a dog", "the man on the left",
            "two people")


@functools.lru_cache(maxsize=None)
def fixture_paths() -> dict:
    """Seeded fixtures of every layout the runners read, in a fresh
    directory: the predictions TSV (``im{i}``), the VQA / NLVR2 /
    retrieval JSON files, the caption candidates and eval keys, and the
    reference's ``.pt`` layouts (qla, nlvr2, coco_ir)."""
    root = tempfile.mkdtemp(prefix="oscar_fx_")
    rng = np.random.RandomState(0)
    feats = {f"im{i}": rng.randn(n, D).astype(np.float32)
             for i, n in enumerate(N_REGIONS)}
    rows = []
    for i, (key, f) in enumerate(feats.items()):
        boxlist = [{"rect": [0, 0, 5 + j, 5], "class": CLASSES[(i + j) % 7],
                    "conf": 0.9, "feature": encode_feature(x)}
                   for j, x in enumerate(f)]
        rows.append([key, json.dumps({"objects": boxlist})])
    p = {"root": root, "feat_file": os.path.join(root, "predictions.tsv")}
    tsv_writer(rows, p["feat_file"])

    def dump(name, obj):
        p[name] = os.path.join(root, f"{name}.json")
        with open(p[name], "w") as f:
            json.dump(obj, f)

    # VQA: soft scores over 5 labels (ties at the top for the hard label),
    # a question without labels, one on an image the TSV lacks
    vqa_rows = []
    for q in range(10):
        labels = {str(a): float(s) for a, s in zip(
            rng.choice(5, 1 + q % 3, replace=False), rng.choice(
                [0.3, 0.6, 0.9, 1.0], 1 + q % 3))}
        vqa_rows.append({"q_id": str(100 + q), "img_id": f"im{q % N_IMG}",
                         "question": STATEMENTS[q % 4] + " ?",
                         "label_scores": labels if q != 3 else {}})
    vqa_rows.append({"q_id": "999", "img_id": "missing", "question": "a",
                     "label_scores": {"1": 1.0}})
    dump("vqa", vqa_rows)
    dump("vqa_test", [{"q_id": str(200 + q), "img_id": f"im{q}",
                       "question": STATEMENTS[q % 4]} for q in range(N_IMG)])
    dump("label2ans", ["yes", "no", "red", "two", "dog"])
    dump("nlvr", [{"ex_id": f"e{q}", "img_left": f"im{q % N_IMG}",
                   "img_right": f"im{(q + 2) % N_IMG}",
                   "statement": STATEMENTS[q % 4],
                   **({"label": q % 2} if q != 5 else {})} for q in range(8)])
    caps = {f"im{i}": [CAPTIONS[(i + c) % 6] for c in range(1 + i % 3)]
            for i in range(N_IMG)}
    dump("captions", caps)
    dump("cand", {f"im{i}": [[f"im{i}", 0]] + [
        [f"im{(i + k) % N_IMG}", 0] for k in (1, 3)] for i in range(N_IMG)})
    keys = [f"im{i}" for i in (4, 1, 2, 5)]
    p["eval_keys"] = os.path.join(root, "eval_keys.txt")
    with open(p["eval_keys"], "w") as f:
        f.write("\n".join(keys) + "\n")
    # candidates among the eval keys only (the training negatives are drawn
    # from them too)
    dump("cand_keys", {k: [[k, 0]] + [[keys[(i + s) % 4], s % 2] for s in (1, 2)]
                       for i, k in enumerate(keys)})

    # the reference's qla layout (VQA)
    torch.save({k: torch.from_numpy(v) for k, v in feats.items()},
               os.path.join(root, "train2014_img_frcnn_feats.pt"))
    with open(os.path.join(root, "train2014_qla.json"), "w") as f:
        json.dump([{"q": r["question"], "o": ";".join(CLASSES[:2 + i % 3]),
                    "an": [int(a) for a in r["label_scores"]],
                    "s": list(r["label_scores"].values()),
                    "img_id": r["img_id"], "q_id": int(r["q_id"])}
                   for i, r in enumerate(vqa_rows)], f)
    # the reference's NLVR2 layout
    torch.save({k: torch.from_numpy(v) for k, v in feats.items()},
               os.path.join(root, "nlvr2_img_frcnn_feats.pt"))
    with open(os.path.join(root, "nlvr2_train.json"), "w") as f:
        json.dump([{"q": STATEMENTS[q % 4],
                    "o": {f"im{q % N_IMG}": "dog;man", f"im{(q + 1) % N_IMG}": "cat"},
                    "label": q % 2,
                    "img_id": [f"im{q % N_IMG}", f"im{(q + 1) % N_IMG}"]}
                   for q in range(8)], f)
    # the reference's coco_ir layout (retrieval)
    coco = os.path.join(root, "coco")
    os.makedirs(coco)
    tsv_writer([[str(i), str(len(f)), base64.b64encode(f.tobytes()).decode()]
                for i, f in enumerate(feats.values())],
               os.path.join(coco, "features.tsv"))
    tsv_writer([[str(i), json.dumps({"objects": [{"class": c} for c in
                                                 CLASSES[i:i + 2]]})]
                for i in range(N_IMG)], os.path.join(coco, "predictions.tsv"))
    with open(os.path.join(coco, "imageid2idx.json"), "w") as f:
        json.dump({str(i): i for i in range(N_IMG)}, f)
    torch.save({i: (v if i % 2 else json.dumps(v))
                for i, v in enumerate(caps.values())},
               os.path.join(root, "train_captions.pt"))
    p["coco_feat_file"] = os.path.join(coco, "features.tsv")
    return p


def tokenizers():
    return (jtok.BertTokenizer(jtok.toy_vocab()),
            tok.BertTokenizer(tok.toy_vocab()))


def same(got, want):
    """Equal arrays (or dataclasses / tuples / lists of them), dtypes too."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# --- data/vqa.py ----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["tsv", "qla"])
def test_vqa_batches_match(layout):
    """Ids, segments, masks, features, soft targets and hard labels of every
    question (the unlabeled one's hard label −1), padded and not."""
    p = fixture_paths()
    jt, pt = tokenizers()
    if layout == "tsv":
        j = jvqa.VQAData(p["feat_file"], jvqa.load_vqa_examples(p["vqa"]), 5,
                         jt, 16, 6, D)
        g = vqa.VQAData(p["feat_file"], vqa.load_vqa_examples(p["vqa"]), 5,
                        pt, 16, 6, D)
    else:
        j = jvqa.QlaVQAData(p["root"], "train2014", 5, jt, 16, 6, D,
                            is_test=True)
        g = vqa.QlaVQAData(p["root"], "train2014", 5, pt, 16, 6, D,
                           is_test=True)
    assert len(g) == len(j) == 10
    assert [dataclasses.asdict(e) for e in g.examples] == [
        dataclasses.asdict(e) for e in j.examples]
    for idx, pad in (([0, 1, 2, 3], None), ([9, 4, 7], 5), (list(range(10)), None)):
        want = j.batch(idx, pad_to=pad)
        same(g.batch(idx, pad_to=pad), want)
    assert (want[2] == -1).sum() == 1 and want[1].sum() > 0


# --- data/nlvr.py ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["pair", "concat"])
@pytest.mark.parametrize("layout", ["tsv", "nlvr2"])
@pytest.mark.parametrize("od", [True, False])
def test_nlvr_batches_match(mode, layout, od):
    """Both choices' arrays in pair mode ([N, 2, ...], the statement's
    truncation carried from the left choice to the right one), the stacked
    2 × r regions in concat mode, with and without the od labels."""
    p = fixture_paths()
    jt, pt = tokenizers()
    kw = dict(mode=mode, use_od_labels=od)
    if layout == "tsv":
        j = jnlvr.NLVRData(p["feat_file"], jnlvr.load_nlvr_examples(p["nlvr"]),
                           jt, 12, 6, D, **kw)
        g = nlvr.NLVRData(p["feat_file"], nlvr.load_nlvr_examples(p["nlvr"]),
                          pt, 12, 6, D, **kw)
    else:
        j = jnlvr.Nlvr2JsonData(p["root"], "train", jt, 12, 6, D, **kw)
        g = nlvr.Nlvr2JsonData(p["root"], "train", pt, 12, 6, D, **kw)
    assert len(g) == len(j) == 8
    for idx, pad in ((list(range(8)), None), ([6, 1, 3], 4)):
        want = j.batch(idx, pad_to=pad)
        same(g.batch(idx, pad_to=pad), want)
    ids, _, attn, feats, _ = want
    assert feats.shape[-2] == (6 if mode == "pair" else 12)
    assert attn.shape[-1] == 12 + feats.shape[-2]
    if mode == "pair":
        assert ids.shape == (4, 2, 12)


# --- data/retrieval.py ----------------------------------------------------------

def retrieval_pair(att_mask_type="CLR", layout="tsv", **kw):
    p = fixture_paths()
    jt, pt = tokenizers()
    with open(p["captions"]) as f:
        caps = json.load(f)
    kw = dict(max_seq_len=14, img_seq_len=6, img_feat_dim=D,
              att_mask_type=att_mask_type, **kw)
    if layout == "coco_ir":
        return (jretrieval.CocoIRRetrievalData(p["root"], p["coco_feat_file"],
                                               jt, split="train", **kw),
                retrieval.CocoIRRetrievalData(p["root"], p["coco_feat_file"],
                                              pt, split="train", **kw))
    return (jretrieval.RetrievalData(p["feat_file"], caps, jt, **kw),
            retrieval.RetrievalData(p["feat_file"], caps, pt, **kw))


@pytest.mark.parametrize("att_mask_type", ["CLR", "CL", "CR", "LR"])
@pytest.mark.parametrize("layout", ["tsv", "coco_ir"])
def test_retrieval_tensorize_matches(att_mask_type, layout):
    """Every caption × image pair's arrays: the 1-D mask of CLR, the 3-D
    block masks of CL / CR / LR (text_b-only truncation of the long
    caption), and the features."""
    j, g = retrieval_pair(att_mask_type, layout)
    assert g.attn_shape == j.attn_shape
    assert len(g.attn_shape) == (1 if att_mask_type == "CLR" else 2)
    pairs = g.all_pairs()
    assert pairs == j.all_pairs() and len(pairs) == 12 * N_IMG
    for cap, _, ik in pairs:
        same(g.tensorize(cap, ik), j.tensorize(cap, ik))


@pytest.mark.parametrize("hard", [False, True])
def test_retrieval_train_batches_match(hard):
    """``train_batch`` from the same ``random.Random`` seeds: the balanced
    positive / negative pairs, uniform or from the caption candidates."""
    p = fixture_paths()
    with open(p["cand"]) as f:
        cand = json.load(f)
    j, g = retrieval_pair("CL", caption_indexs=cand, num_captions_per_img=2)
    for seed in (0, 1, 2):
        same(g.train_batch(8, random.Random(seed), hard_negatives=hard),
             j.train_batch(8, random.Random(seed), hard_negatives=hard))


def test_retrieval_rerank_entries_and_eval_keys():
    """The re-rank entries (capped and not), the eval-key subset and the
    capped caption pools."""
    p = fixture_paths()
    with open(p["cand"]) as f:
        cand = json.load(f)
    with open(p["eval_keys"]) as f:
        keys = [k.strip() for k in f if k.strip()]
    j, g = retrieval_pair(caption_indexs=cand, eval_img_keys=keys,
                          num_captions_per_img=1)
    assert g.img_keys == j.img_keys == keys
    assert g.captions == j.captions and g.full_captions == j.full_captions
    for n in (None, 2):
        assert g.rerank_entries(n) == j.rerank_entries(n)
    assert len(g.rerank_entries(2)) == 2 * len(keys)
    with pytest.raises(KeyError):
        retrieval_pair(eval_img_keys=["im0", "nope"])


def test_rank_functions_golden():
    """``rank_rerank`` and ``rank_scores`` (numpy, copied as they are) on
    hand-built scores, and on random ones against the JAX package's."""
    scores = np.asarray([[0.9, 0.5, 0.1], [0.2, 0.8, 0.4],
                         [0.3, 0.9, 0.1]]).reshape(-1)
    labels = np.asarray([1, 0, 0, 1, 0, 0, 0, 1, 0])
    m = retrieval.rank_rerank(scores, labels, 3)
    assert m["i2t_R@1"] == pytest.approx(100.0 * 2 / 3) and m["i2t_R@5"] == 100.0
    # 3 captions of 2 images: caption 2 (image 1) ranks image 1 second
    s = np.asarray([[0.9, 0.1], [0.7, 0.2], [0.6, 0.5]])
    got = retrieval.rank_scores(s, [0, 0, 1], 2)
    assert got["t2i_R@1"] == pytest.approx(200 / 3) and got["i2t_R@1"] == 100.0
    rng = np.random.RandomState(3)
    for _ in range(3):
        s = rng.rand(12, 5).astype(np.float32)
        s[3, 1] = s[3, 2]                       # a tie
        owners = list(rng.randint(0, 5, 12))
        assert retrieval.rank_scores(s, owners, 5) == jretrieval.rank_scores(
            s, owners, 5)
        flat, lab = rng.rand(20), (rng.rand(20) > 0.7).astype(int)
        assert retrieval.rank_rerank(flat, lab, 4) == jretrieval.rank_rerank(
            flat, lab, 4)


# --- the runners without JAX ----------------------------------------------------

TINY = ["--hidden_size", "32", "--num_hidden_layers", "2", "--img_feature_dim",
        str(D), "--device", "cpu", "--dtype", "float32"]


def runner_args(name: str) -> list:
    p = fixture_paths()
    if name in ("run_vqa", "run_gqa"):
        return ["--feat_file", p["feat_file"], "--examples", p["vqa"],
                "--num_labels", "5", "--max_seq_length", "16",
                "--max_img_seq_length", "6"] + TINY
    if name == "run_nlvr":
        return ["--feat_file", p["feat_file"], "--examples", p["nlvr"],
                "--max_seq_length", "12", "--max_img_seq_length", "6"] + TINY
    return ["--feat_file", p["feat_file"], "--captions", p["captions"],
            "--max_seq_length", "14", "--max_img_seq_length", "6"] + TINY


RUNNERS = {"run_vqa": run_vqa, "run_gqa": run_gqa, "run_nlvr": run_nlvr,
           "run_retrieval": run_retrieval}


@pytest.mark.parametrize("name", sorted(RUNNERS))
@pytest.mark.parametrize("ask", ["dp", "world_size", "dis_code"])
def test_runner_refusals(name, ask, monkeypatch):
    """``--dp 2`` and a two-process environment name ROADMAP item 9 (the
    parallel port); the discrete-code features name item 6."""
    argv = runner_args(name)
    if ask == "dp":
        argv += ["--dp", "2"]
    elif ask == "world_size":
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
    else:
        argv += ["--img_feature_type", "dis_code"]
    item = "item 6" if ask == "dis_code" else "item 9"
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {item}"):
        RUNNERS[name].main(argv)


def test_vqa_integer_features_refused(tmp_path):
    """A qla feature file of integer code ids (the dis_code layout) under
    region features is refused, naming item 6."""
    p = fixture_paths()
    torch.save({f"im{i}": torch.arange(4) for i in range(N_IMG)},
               tmp_path / "train2014_img_frcnn_feats.pt")
    with open(os.path.join(p["root"], "train2014_qla.json")) as f:
        (tmp_path / "train2014_qla.json").write_text(f.read())
    with pytest.raises(SystemExit, match="item 6"):
        run_vqa.main(["--qla_data_dir", str(tmp_path), "--num_labels", "5"]
                     + TINY)


def test_vqa_adjust_dp_and_loss(monkeypatch):
    """``--adjust_dp --adjust_loss --adjust_loss_epoch 2`` over 4 epochs:
    the loss is kl in epochs 0-1 and bce after, every hidden dropout 0.3
    from epoch 3 (the attention probabilities' keeps its rate), on the same
    parameters and optimizer state; after training the model has its own
    configuration back."""
    seen = []
    real = train_lib.make_cls_train_step

    def spy(model, tx, **kw):
        step = real(model, tx, **kw)

        def recorded(state, batch, generator=None):
            rates = {n: m.rate for n, m in model.named_modules()
                     if isinstance(m, Dropout)}
            seen.append((state.step, model.config.loss_type,
                         model.bert.encoder.layer[0].config.hidden_dropout_prob,
                         rates, batch[4].dtype))
            return step(state, batch, generator)
        return recorded

    monkeypatch.setattr(train_lib, "make_cls_train_step", spy)
    built = []
    real_build = run_vqa.build_model
    monkeypatch.setattr(run_vqa, "build_model",
                        lambda *a: built.append(real_build(*a)) or built[-1])
    run_vqa.main(runner_args("run_vqa") + [
        "--loss_type", "kl", "--adjust_dp", "--adjust_loss",
        "--adjust_loss_epoch", "2", "--num_train_epochs", "4",
        "--per_gpu_train_batch_size", "5", "--drop_out", "0.1"])
    assert [s[0] for s in seen] == list(range(8))       # 2 steps an epoch
    assert [s[1] for s in seen] == ["kl"] * 4 + ["bce"] * 4
    assert [s[2] for s in seen] == [0.1] * 6 + [0.3] * 2
    for step_, _, drop, rates, dtype in seen:
        assert dtype == torch.float32                    # soft targets
        probs = {n: r for n, r in rates.items() if n.endswith("probs_dropout")}
        assert len(probs) == 2 and set(probs.values()) == {0.1}
        assert {r for n, r in rates.items() if n not in probs} == {drop}
    model = built[-1]
    assert model.config.loss_type == "kl"
    assert all(m.rate == 0.1 for m in model.modules() if isinstance(m, Dropout))


def final_state(module, argv, monkeypatch) -> tuple:
    """(main's result, the model's parameters after it)."""
    built = []
    real = module.build_model
    monkeypatch.setattr(module, "build_model",
                        lambda *a: built.append(real(*a)) or built[-1])
    out = module.main(argv)
    monkeypatch.setattr(module, "build_model", real)
    return out, {k: v.clone() for k, v in built[-1].state_dict().items()}


@pytest.fixture
def one_thread():
    """One intra-op thread: with several, the CPU's BLAS may sum in an order
    that changes from run to run, and two uninterrupted runs then differ in
    their last bits."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", ["run_vqa", "run_nlvr", "run_retrieval"])
def test_resume_is_bit_equal(name, tmp_path, monkeypatch, one_thread):
    """``--max_steps`` with ``--save_every``, then ``--resume``: the final
    parameters and the result are bit-equal to an uninterrupted run (VQA
    and NLVR2 stop mid-epoch, at step 3 of 2-step epochs; dropout on)."""
    module = RUNNERS[name]
    if name == "run_retrieval":
        argv = runner_args(name) + ["--train_steps", "5",
                                    "--per_gpu_train_batch_size", "4"]
        cut = ["--max_steps", "3", "--save_every", "3"]
    else:
        argv = runner_args(name) + ["--num_train_epochs", "3",
                                    "--per_gpu_train_batch_size", "4"]
        cut = ["--max_steps", "3", "--save_every", "1"]
    argv += ["--learning_rate", "1e-3", "--drop_out", "0.1"]
    full, want = final_state(module, argv, monkeypatch)
    out = ["--output_dir", str(tmp_path / "out")]
    cut_result, cut_state = final_state(module, argv + cut + out, monkeypatch)
    resumed, got = final_state(module, argv + ["--resume"] + out, monkeypatch)
    assert resumed == full
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the cut run stopped short of the whole run
    assert any(not torch.equal(cut_state[k], want[k]) for k in want)
    assert os.path.exists(tmp_path / "out" / "state" / "last_checkpoint")


@pytest.mark.parametrize("layout", ["qla", "nlvr2", "coco_ir"])
def test_reference_layouts_drive_the_runners(layout):
    """Each runner reads the reference's own files (the qla ``.pt`` + json,
    the NLVR2 json + ``.pt``, the coco_ir captions ``.pt`` + 3-column TSV)
    through ``main``, trains a step and evaluates."""
    p = fixture_paths()
    if layout == "qla":
        got = run_vqa.main(["--qla_data_dir", p["root"], "--split", "train2014",
                            "--num_labels", "5", "--max_seq_length", "16",
                            "--max_img_seq_length", "6", "--num_train_epochs",
                            "1", "--per_gpu_train_batch_size", "8"] + TINY)
        assert 0.0 <= got <= 100.0
    elif layout == "nlvr2":
        got = run_nlvr.main(["--nlvr2_data_dir", p["root"], "--split", "train",
                             "--max_seq_length", "12", "--max_img_seq_length",
                             "6", "--num_train_epochs", "1",
                             "--per_gpu_train_batch_size", "8"] + TINY)
        assert got in {100.0 * k / 8 for k in range(9)}
    else:
        got = run_retrieval.main(["--data_dir", p["root"], "--img_feat_file",
                                  p["coco_feat_file"], "--max_seq_length", "14",
                                  "--max_img_seq_length", "6", "--train_steps",
                                  "1", "--per_gpu_train_batch_size", "4"] + TINY)
        assert len(got) == 6 and all(0.0 <= v <= 100.0 for v in got.values())


@pytest.mark.parametrize("fmt", ["json_list", "json_dict", "pkl", "none"])
def test_label2ans_and_submission_rows(fmt, tmp_path):
    """``load_label2ans`` on a json list, a json {label: answer} dict (with
    a label missing), the reference's pickled list and no file, and
    ``write_submission``'s VQA and GQA rows, as the JAX runner's."""
    from cpt_tpu.tools import run_vqa as jrun_vqa

    answers = ["yes", "no", "two"]
    path = str(tmp_path / f"l2a.{'pkl' if fmt == 'pkl' else 'json'}")
    if fmt == "pkl":
        with open(path, "wb") as f:
            pickle.dump(answers, f)
    elif fmt != "none":
        with open(path, "w") as f:
            json.dump(answers if fmt == "json_list" else {"0": "yes", "2": "two"},
                      f)
    else:
        path = None
    got = run_vqa.load_label2ans(path, 3)
    assert got == jrun_vqa.load_label2ans(path, 3) and len(got) == 3
    results = {"17": 2, "-3": 0, "q9": 1}
    for sub in ("vqa", "gqa"):
        run_vqa.write_submission(results, got, str(tmp_path / "p.json"), sub)
        jrun_vqa.write_submission(results, got, str(tmp_path / "j.json"), sub)
        with open(tmp_path / "p.json") as f, open(tmp_path / "j.json") as g:
            assert json.load(f) == json.load(g)


@pytest.mark.parametrize("ext", ["json", "pt"])
def test_caption_index_files(ext, tmp_path):
    """``_load_caption_indexs`` on a json file and on a ``torch.save``d dict
    whose values are json strings (the reference's layout), as JAX's."""
    from cpt_tpu.tools import run_retrieval as jrun_retrieval

    cand = {"im0": [["im0", 0], ["im3", 1]], "im1": [["im1", 2], ["im0", 0]]}
    path = str(tmp_path / f"cand.{ext}")
    if ext == "pt":
        torch.save({k: json.dumps(v) for k, v in cand.items()}, path)
    else:
        with open(path, "w") as f:
            json.dump(cand, f)
    got = run_retrieval._load_caption_indexs(path)
    assert got == jrun_retrieval._load_caption_indexs(path) == cand
