"""Synthetic RefCOCO / GQA / VCR / VG fixtures (port of
``cpt_tpu/data/synthetic.py``): the stage-1 feature TSVs and the json files
beside them, written with the port's own TSV codec, byte for byte what the
JAX package writes at the same seed.

Used by smoke drivers and tests where no real CPT data or checkpoints are
on disk. The generated data carries a learnable signal: the correct
candidate's region features carry a marker, so prompt tuning can
demonstrably improve accuracy.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer


def _dump_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def generate_gqa_fixture(root: str, n_questions: int = 12, n_objects: int = 6,
                         feat_dim: int = 64, seed: int = 0,
                         answers=("red", "blue", "green")) -> dict:
    """GQA-style fixture: plain + color feature TSVs, questions, ans2label.

    The correct answer's index is marked into the features (dim 0) so
    prompt-tuning can learn; color rows carry rewrite metadata.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    plain_rows, color_rows, questions = [], [], []
    for q in range(n_questions):
        ans = q % len(answers)
        feats = rng.randn(n_objects, feat_dim).astype(np.float32) * 0.1
        feats[:, 0] = float(ans)
        boxlist = [{"rect": [0, 0, 5, 5], "class": "dog",
                    "conf": 0.9, "feature": encode_feature(f)} for f in feats]
        img_id = f"im{q}"
        plain_rows.append([img_id, json.dumps({"objects": boxlist})])
        # color row keyed by q_id; reference layout: objects[1][0] =
        # positions_and_colors = [[(start,), color_name], ...]
        meta = [[[[4], "red"]]]
        color_rows.append([f"q{q}", json.dumps(
            {"objects": [boxlist, meta]})])
        questions.append({"q_id": f"q{q}", "img_id": img_id,
                          "question": f"what color is the dog {q}",
                          "label": ans})
    paths = {
        "img_feat_file": os.path.join(root, "predictions.tsv"),
        "color_img_feat_file": os.path.join(root, "color_predictions.tsv"),
        "questions": os.path.join(root, "questions.json"),
        "ans2label": os.path.join(root, "ans2label.json"),
    }
    tsv_writer(plain_rows, paths["img_feat_file"])
    tsv_writer(color_rows, paths["color_img_feat_file"])
    _dump_json(questions, paths["questions"])
    _dump_json({a: i for i, a in enumerate(answers)}, paths["ans2label"])
    return paths


def generate_vcr_fixture(root: str, n_questions: int = 8, n_objects: int = 4,
                         n_choices: int = 4, feat_dim: int = 32,
                         seed: int = 0) -> dict:
    """VCR-style fixture: feature TSV with [boxlist, [obj_colors, obj_names]]
    meta + examples json. The correct choice index is marked into feature
    dim 0 so the NSP head can learn."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows, examples = [], []
    for q in range(n_questions):
        label = q % n_choices
        feats = rng.randn(n_objects, feat_dim).astype(np.float32) * 0.1
        feats[:, 0] = float(label)
        boxlist = [{"rect": [0, 0, 5, 5], "class": "person", "conf": 0.9,
                    "feature": encode_feature(f)} for f in feats]
        obj_colors = {"0": "red", "1": "blue"}
        obj_names = {"0": "person", "1": "person", "0_1": "people"}
        img_key = f"vcr{q}"
        rows.append([img_key, json.dumps(
            {"objects": [boxlist, [obj_colors, obj_names]]})])
        # candidate texts must differ by in-vocab words (toy vocab has no
        # digits) — use color words as the distinguishing token
        words = ["red", "blue", "green", "yellow", "purple", "pink"]
        examples.append({
            "q_id": f"q{q}", "img_key": img_key,
            "question": ["what", "is", [0], "doing", "?"],
            "choices": [[[0], "is", words[c]] for c in range(n_choices)],
            "label": label,
            "rationale_choices": [[[1], "is", "the", words[c]]
                                  for c in range(n_choices)],
            "rationale_label": (q + 1) % n_choices,
        })
    paths = {
        "feat_file": os.path.join(root, "predictions.tsv"),
        "examples": os.path.join(root, "examples.json"),
    }
    tsv_writer(rows, paths["feat_file"])
    _dump_json(examples, paths["examples"])
    return paths


def generate_vg_fixture(root: str, n_pairs: int = 6, n_objects: int = 4,
                        feat_dim: int = 32, seed: int = 0,
                        predicates=("on", "has", "near")) -> dict:
    """VG-style fixture: rows keyed <img>_<s>_<o> with
    [[boxlist], color_names, pair_labels, rel_label] payloads (the
    reference inference_vg layout) + predicate vocab + gt relations
    pickle."""
    import pickle

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows, gts = [], []
    for q in range(n_pairs):
        rel = predicates[q % len(predicates)]
        feats = rng.randn(n_objects, feat_dim).astype(np.float32) * 0.1
        feats[:, 0] = float(q % len(predicates))
        boxlist = [{"rect": [0, 0, 5, 5], "class": "dog", "conf": 0.9,
                    "feature": encode_feature(f)} for f in feats]
        img_key = f"im{q}.jpg_0_1"
        rows.append([img_key, json.dumps(
            {"objects": [[boxlist], ["red", "blue"], ["dog", "cat"], rel]})])
        gts.append({"img_path": f"im{q}.jpg",
                    "relations": np.array([[0, 1, (q % len(predicates)) + 1]])})
    paths = {
        "feat_file": os.path.join(root, "predictions.tsv"),
        "predicate_vocab": os.path.join(root, "vocab.json"),
        "gt_file": os.path.join(root, "gt.pk"),
    }
    tsv_writer(rows, paths["feat_file"])
    _dump_json({"idx_to_predicate": {str(i + 1): p
                                     for i, p in enumerate(predicates)}},
               paths["predicate_vocab"])
    with open(paths["gt_file"], "wb") as f:
        pickle.dump(gts, f)
    return paths


def generate_refcoco_fixture(root: str, n_queries: int = 8, n_copies: int = 4,
                             n_objects: int = 10, feat_dim: int = 2054,
                             seed: int = 0, marker: float = 3.0,
                             split: str = "val") -> dict:
    """Write predictions.tsv / ann.json / det.json under ``root``.

    Returns the paths dict. Query q's correct candidate is copy ``q % n_copies``.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows, anns = [], []

    def gt_box(q):
        return [10.0 * q, 10.0, 10.0 * q + 19.0, 29.0]

    for q in range(n_queries):
        objs, colors, rects = [], [], []
        correct = q % n_copies
        for c in range(n_copies):
            feats = rng.randn(n_objects, feat_dim).astype(np.float32) * 0.1
            if c == correct:
                feats[:, 0] = marker
            boxes = [{
                "rect": [0, 0, 5, 5],
                "class": "dog" if b else "cat",
                "conf": 0.9,
                "feature": encode_feature(feats[b]),
            } for b in range(n_objects)]
            objs.append(boxes)
            colors.append(["red"])
            cand = (gt_box(q) if c == correct
                    else [200.0 + 30 * c, 200.0, 229.0 + 30 * c, 229.0])
            rects.append([cand])
        payload = {"objects": [objs, f"the red dog {q}", colors, rects]}
        rows.append([f"{split}{q}", json.dumps(payload)])
        g = gt_box(q)
        anns.append({"id": f"{split}{q}",
                     "bbox": [g[0], g[1], g[2] - g[0] + 1, g[3] - g[1] + 1]})

    paths = {
        "data_file": os.path.join(root, f"predictions_{split}.tsv"),
        "ann_file": os.path.join(root, f"ann_{split}.json"),
        "det_file": os.path.join(root, f"det_{split}.json"),
    }
    tsv_writer(rows, paths["data_file"])
    _dump_json(anns, paths["ann_file"])
    _dump_json({f"{split}{q}": ["cat"] + ["dog"] * (n_objects - 1)
                for q in range(n_queries)}, paths["det_file"])
    return paths
