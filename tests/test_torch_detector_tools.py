"""The detector's entry points, port vs JAX package, on the CPU in f32 at
the tiny config: ``engine/detection_eval`` on predictions drawn from seeds,
the VG-TSV / COCO / VOC datasets and ``tools/convert_dataset`` on the
fixtures of ``tests/test_vg_tsv.py`` and ``tests/test_coco_json.py``
(rebuilt here), ``tools/test_detector`` (detection, VOC / COCO metrics,
``--expected_results``, ``--attr_eval``), ``tools/extract_features
--image_dir`` and ``tools/demo`` (overlays, paints, the webcam loop). The
same seeded reference-layout detector goes into both tools through
``--checkpoint``. Also the refusals of what ``test_detector`` does not
port, and a dry run of ``chip_smoke.py``'s phase 12 at the tiny size."""
import ast
import functools
import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
from cpt_tpu.data import coco_json as jcoco
from cpt_tpu.data import vg_tsv as jvg
from cpt_tpu.engine import detection_eval as jeval
from cpt_tpu.models.detector.config import tiny_detector_config
from cpt_tpu.models.detector.convert import random_vinvl_state_dict
from cpt_tpu.tools import convert_dataset as jconvert
from cpt_tpu.tools import demo as jdemo
from cpt_tpu.tools import extract_features as jextract
from cpt_tpu.tools import test_detector as jtool
from cpt_tpu_torch.data import coco_json, vg_tsv
from cpt_tpu_torch.engine import detection_eval
from cpt_tpu_torch.tools import convert_dataset, demo, extract_features
from cpt_tpu_torch.tools import test_detector as tool
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_distributed import multi_process_env
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

# f32 through the same formulas in another framework (tests/test_torch_detect.py)
TOL = dict(atol=2e-4, rtol=2e-4)
METRIC_TOL = 1e-6
LABELMAP = {
    "label_to_idx": {"cat": 1, "dog": 2, "car": 3},
    "attribute_to_idx": {"red": 1, "furry": 2},
    "predicate_to_idx": {"on": 1, "near": 2, "to the left of": 3},
}


@functools.lru_cache(maxsize=None)
def work_dir() -> str:
    """A directory for the whole module's shared inputs (cached calls
    below write there; pytest's tmp_path is per case)."""
    import tempfile

    return tempfile.mkdtemp(prefix="test_torch_detector_tools_")


@functools.lru_cache(maxsize=None)
def checkpoint() -> str:
    """The tiny detector's seeded reference-layout weights as a ``.pth``,
    the ``--checkpoint`` both packages' tools load."""
    path = os.path.join(work_dir(), "det.pth")
    sd = random_vinvl_state_dict(tiny_detector_config(), seed=8)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def _common():
    return ["--tiny", "--dtype", "float32", "--checkpoint", checkpoint()]


def _gradient(i, h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(yy * 2 + i * 10) % 256, (xx * 2) % 256,
                     ((yy + xx) // 2) % 256], axis=-1).astype(np.uint8)


def _vg_fixture(m, root):
    """tests/test_vg_tsv.py's dataset, written by package ``m``."""
    images, labels = {}, {}
    for i in range(4):
        images[f"im{i}"] = _gradient(i)
        labels[f"im{i}"] = {
            "objects": [
                {"rect": [4, 4, 40, 40], "class": "cat", "attributes": ["red"]},
                {"rect": [30, 10, 90, 80], "class": "dog",
                 "attributes": ["furry", "red"]},
                {"rect": [200, 5, 300, 50], "class": "car", "attributes": []},
            ],
            "relations": [
                {"subj_id": 0, "obj_id": 1, "class": "on"},
                {"subj_id": 1, "obj_id": 2, "class": "to the left of"},
            ],
        }
    return m.write_detection_tsv(str(root), "train", images, labels, LABELMAP)


def _same_tree(root_a, root_b):
    names = sorted(os.listdir(root_a))
    assert names == sorted(os.listdir(root_b))
    for n in names:
        assert (root_a / n).read_bytes() == (root_b / n).read_bytes(), n


def _same_target(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- engine/detection_eval -----------------------------------------------------

def _random_detections(seed, n_img=5, n_cls=4):
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for _ in range(n_img):
        m = rng.randint(1, 6)
        xy = rng.uniform(0, 200, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(4, 150, (m, 2))], 1)
        gl = rng.randint(1, n_cls, m)
        # predictions: jittered gts, duplicates of some, and clutter
        k = rng.randint(0, 8)
        xy2 = rng.uniform(0, 200, (k, 2))
        clutter = np.concatenate([xy2, xy2 + rng.uniform(2, 100, (k, 2))], 1)
        pb = np.concatenate([gt + rng.normal(0, 6, gt.shape),
                             gt[: m // 2 + 1], clutter])
        pl = np.concatenate([gl, gl[: m // 2 + 1], rng.randint(1, n_cls, k)])
        ps = rng.rand(len(pb)).round(2)          # ties on purpose
        preds.append({"boxes": pb, "labels": pl, "scores": ps,
                      "attr_labels": rng.randint(0, 5, (len(pb), 3)),
                      "attr_scores": rng.rand(len(pb), 3) * (
                          rng.rand(len(pb), 3) > 0.3)})
        gts.append({"boxes": gt, "labels": gl,
                    "difficult": rng.rand(m) > 0.8,
                    "attributes": rng.randint(0, 5, (m, 2))})
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_eval_matches_jax(seed):
    preds, gts = _random_detections(seed)
    for conv in (False, True):
        for use_07 in (False, True):
            got = detection_eval.eval_detection_voc(
                preds, gts, 4, use_07_metric=use_07, double_inclusive=conv)
            assert got == jeval.eval_detection_voc(
                preds, gts, 4, use_07_metric=use_07, double_inclusive=conv)
            assert 0.0 <= got["mAP"] <= 1.0
    got = detection_eval.eval_detection_coco(preds, gts)
    want = jeval.eval_detection_coco(preds, gts)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(list(got.values()), list(want.values()))
    assert (detection_eval.eval_detection_attributes(preds, gts, 5)
            == jeval.eval_detection_attributes(preds, gts, 5))
    rng = np.random.RandomState(seed)
    rec = np.sort(rng.rand(9))
    prec = rng.rand(9)
    for use_07 in (False, True):
        assert (detection_eval.voc_ap(rec, prec, use_07)
                == jeval.voc_ap(rec, prec, use_07))
    results = {"mAP": 0.3, "AP": 0.2}
    for expected in ([("mAP", 0.3, 0.01)], [("mAP", 0.3, 0.01), ("AP", 0.5, 0.1)]):
        assert (detection_eval.check_expected_results(results, expected,
                                                      logger=lambda m: None)
                == jeval.check_expected_results(results, expected,
                                                logger=lambda m: None))


def test_detection_eval_penalises_duplicates():
    """A second detection of a matched gt is a false positive, under both
    box conventions; a difficult gt's detections count for nothing."""
    gt = {"boxes": np.array([[10, 10, 50, 50], [60, 60, 90, 90],
                             [100, 5, 120, 30]], float),
          "labels": np.array([1, 1, 1]),
          "difficult": np.array([False, False, True])}
    clean = {"boxes": np.array([[10, 10, 50, 50], [60, 60, 90, 90],
                                [100, 5, 120, 30]], float),
             "labels": np.array([1, 1, 1]), "scores": np.array([0.9, 0.7, 0.95])}
    dup = {"boxes": np.array([[10, 10, 50, 50], [11, 10, 50, 50],
                              [60, 60, 90, 90]], float),
           "labels": np.array([1, 1, 1]), "scores": np.array([0.9, 0.8, 0.7])}
    for conv in (False, True):
        a = detection_eval.eval_detection_voc([clean], [gt], 2,
                                              double_inclusive=conv)
        b = detection_eval.eval_detection_voc([dup], [gt], 2,
                                              double_inclusive=conv)
        assert a == jeval.eval_detection_voc([clean], [gt], 2,
                                             double_inclusive=conv)
        assert b == jeval.eval_detection_voc([dup], [gt], 2,
                                             double_inclusive=conv)
        # recall 1/2 at precision 1, then 2/2 at 2/3
        assert a["mAP"] == 1.0 and abs(b["mAP"] - (0.5 + 0.5 * 2 / 3)) < 1e-12


# --- data/vg_tsv, data/coco_json, tools/convert_dataset --------------------------

def test_vg_tsv_matches_jax(tmp_path):
    """The same TSV files from both writers; the same images, keys, boxes,
    labels, attributes, relations, frequency prior and line lists from
    both readers."""
    yp = _vg_fixture(vg_tsv, tmp_path / "port")
    yj = _vg_fixture(jvg, tmp_path / "jax")
    _same_tree(tmp_path / "port", tmp_path / "jax")
    for cls in ("DetectionTSVDataset", "VGTSVDataset"):
        port = getattr(vg_tsv, cls)(yp, attribute_on=True)
        ref = getattr(jvg, cls)(yj, attribute_on=True)
        assert len(port) == len(ref) == 4
        assert port.class_to_ind == ref.class_to_ind
        for i in range(4):
            assert port.get_img_key(i) == ref.get_img_key(i)
            assert port.get_img_info(i) == ref.get_img_info(i)
            np.testing.assert_array_equal(port.get_image(i), ref.get_image(i))
            _same_target(port.get_target(i), ref.get_target(i))
            _same_target(port.get_target(i, remove_empty=True),
                         ref.get_target(i, remove_empty=True))
    port, ref = vg_tsv.VGTSVDataset(yp), jvg.VGTSVDataset(yj)
    assert port.relation_to_ind == ref.relation_to_ind
    assert port.split == ref.split
    for overlap in (False, True):
        np.testing.assert_array_equal(port.compute_freq_prior(overlap),
                                      ref.compute_freq_prior(overlap))
    boxes = np.array([[0, 0, 10, 10], [5, 5, 20, 20], [50, 50, 60, 60]],
                     np.float32)
    for overlap in (False, True):
        np.testing.assert_array_equal(vg_tsv._box_filter(boxes, overlap),
                                      jvg._box_filter(boxes, overlap))
    np.testing.assert_array_equal(
        vg_tsv.clip_boxes_to_image(boxes * 3, 40, 30),
        jvg.clip_boxes_to_image(boxes * 3, 40, 30))
    # a line list and a concatenation
    (tmp_path / "port" / "sub.linelist").write_text("1\n3\n")
    sub = tmp_path / "port" / "sub.yaml"
    sub.write_text((tmp_path / "port" / "train.yaml").read_text()
                   + "linelist: sub.linelist\n")
    assert (vg_tsv.load_linelist_file(str(tmp_path / "port" / "sub.linelist"))
            == jvg.load_linelist_file(str(tmp_path / "port" / "sub.linelist")))
    for path in (str(sub), "nowhere.yaml"):
        assert (vg_tsv.find_file_path_in_yaml(path, str(tmp_path))
                == jvg.find_file_path_in_yaml(path, str(tmp_path)))
    cat = vg_tsv.ConcatDetectionDataset([vg_tsv.DetectionTSVDataset(yp),
                                         vg_tsv.DetectionTSVDataset(str(sub))])
    jcat = jvg.ConcatDetectionDataset([jvg.DetectionTSVDataset(yj),
                                       jvg.DetectionTSVDataset(str(sub))])
    assert len(cat) == len(jcat) == 6
    for i in range(6):
        assert cat.get_img_key(i) == jcat.get_img_key(i)
        assert cat.get_img_info(i) == jcat.get_img_info(i)
        _same_target(cat.get_target(i), jcat.get_target(i))
        np.testing.assert_array_equal(cat[i][0], jcat[i][0])
    with pytest.raises(IndexError):
        cat[6]


def _coco_fixture(root):
    """tests/test_coco_json.py's COCO fixture."""
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    for i, name in enumerate(["a.jpg", "b.jpg", "c.jpg", "d.jpg"]):
        Image.fromarray(_gradient(i)).save(img_dir / name)
    ann = {
        "images": [
            {"id": 7, "file_name": "b.jpg", "width": 128, "height": 96},
            {"id": 3, "file_name": "a.jpg", "width": 128, "height": 96},
            {"id": 9, "file_name": "c.jpg", "width": 128, "height": 96},
            {"id": 11, "file_name": "d.jpg", "width": 128, "height": 96},
        ],
        "categories": [{"id": 18, "name": "dog"}, {"id": 2, "name": "cat"},
                       {"id": 44, "name": "car"}],
        "annotations": [
            {"image_id": 3, "category_id": 2, "bbox": [4, 4, 37, 37],
             "iscrowd": 0},
            {"image_id": 3, "category_id": 18, "bbox": [30, 10, 61, 71],
             "iscrowd": 0},
            {"image_id": 7, "category_id": 44, "bbox": [0, 0, 50, 50],
             "iscrowd": 1},
            {"image_id": 9, "category_id": 2, "bbox": [5, 5, 1, 30],
             "iscrowd": 0},
            {"image_id": 11, "category_id": 44, "bbox": [100, 60, 60, 60],
             "iscrowd": 0},
        ],
    }
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps(ann))
    return str(ann_file), str(img_dir)


def _voc_fixture(root):
    """tests/test_coco_json.py's VOC fixture."""
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(root / sub)
    xml = """<annotation><size><width>64</width><height>48</height></size>
      <object><name>Dog</name><difficult>0</difficult>
        <bndbox><xmin>5</xmin><ymin>6</ymin><xmax>30</xmax><ymax>40</ymax>
        </bndbox></object>
      <object><name>person</name><difficult>1</difficult>
        <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>10</xmax><ymax>10</ymax>
        </bndbox></object></annotation>"""
    (root / "Annotations" / "x1.xml").write_text(xml)
    Image.fromarray(_gradient(5, 48, 64)).save(root / "JPEGImages" / "x1.jpg")
    (root / "ImageSets" / "Main" / "test.txt").write_text("x1\n")
    return str(root)


def test_coco_json_and_convert_dataset_match_jax(tmp_path):
    """The same images, targets and label maps from both COCO / VOC
    readers, and byte-equal TSV trees from both converters."""
    ann_file, img_dir = _coco_fixture(tmp_path / "coco")
    got, want = coco_json.load_coco_json(ann_file), jcoco.load_coco_json(ann_file)
    assert got == want
    assert [im["id"] for im in got[0]] == [3, 7, 11]
    for keep in (False,):
        assert (coco_json.load_coco_json(ann_file, keep)
                == jcoco.load_coco_json(ann_file, keep))
    voc = _voc_fixture(tmp_path / "VOC2007")
    xml = os.path.join(voc, "Annotations", "x1.xml")
    assert coco_json.load_voc_xml(xml) == jcoco.load_voc_xml(xml)
    assert coco_json.PASCAL_CLASSES == jcoco.PASCAL_CLASSES
    for fmt, flags in (("coco", ["--ann", ann_file, "--img_dir", img_dir]),
                       ("voc", ["--voc_root", voc, "--split", "test"])):
        outs = []
        for m, name in ((convert_dataset, "port"), (jconvert, "jax")):
            root = tmp_path / f"{fmt}_{name}"
            y = m.main([fmt] + flags + ["--out", str(root)])
            outs.append(root)
            assert os.path.basename(y) == ("coco.yaml" if fmt == "coco"
                                           else "voc_test.yaml")
        _same_tree(*outs)
        ds = vg_tsv.DetectionTSVDataset(
            str(outs[0] / ("coco.yaml" if fmt == "coco" else "voc_test.yaml")))
        assert len(ds) == (3 if fmt == "coco" else 1)
        assert ds.get_image(0).shape == ((96, 128, 3) if fmt == "coco"
                                         else (48, 64, 3))


# --- tools/test_detector -----------------------------------------------------------

def _tsv_images():
    rng = np.random.RandomState(21)
    return {f"k{i}": rng.randint(0, 256, (64 - 4 * i, 64, 3)).astype(np.uint8)
            for i in range(2)}


@functools.lru_cache(maxsize=None)
def detector_tsv() -> str:
    """A 2-image VG-TSV whose ground truth the tiny detector partly finds:
    two of the port's own detections an image (from a first run on the same
    images), one shifted by a pixel, and a box it misses; classes c1..c6,
    attributes a1..a4."""
    images = _tsv_images()
    names = {f"c{i}": i for i in range(1, 7)}
    labelmap = {"label_to_idx": names,
                "attribute_to_idx": {f"a{i}": i for i in range(1, 5)}}
    root = os.path.join(work_dir(), "tsv")
    first = vg_tsv.write_detection_tsv(
        root + "0", "det", images,
        {k: {"objects": []} for k in images}, labelmap)
    out = os.path.join(work_dir(), "first.pk")
    tool.main(_common() + ["--device", "cpu", "--tsv", first, "--output", out])
    with open(out, "rb") as f:
        preds = pickle.load(f)["predictions"]
    labels = {}
    rng = np.random.RandomState(3)
    for (key, img), p in zip(images.items(), preds):
        objects = []
        for j, (box, lab) in enumerate(zip(p["boxes"][:2], p["labels"][:2])):
            box = [float(v) + (1.0 if j else 0.0) for v in box]
            objects.append({"rect": box, "class": f"c{int(lab)}",
                            "attributes": [f"a{int(a)}" for a in
                                           rng.choice(4, 2, replace=False) + 1]})
        objects.append({"rect": [1.0, 2.0, 9.0, 7.0], "class": "c3",
                        "attributes": ["a1"]})
        labels[key] = {"objects": objects}
    return vg_tsv.write_detection_tsv(root, "det", images, labels, labelmap)


MEET = json.dumps([["mAP", 0.5, 0.51]])     # any mAP in [0, 1] meets it
MISS = json.dumps([["mAP", 0.5, 0.51], ["coco_AP", 2.0, 0.5]])


@functools.lru_cache(maxsize=None)
def jax_detector_run(source: str):
    """The JAX tool's (results, ok, per-image predictions) on ``source``:
    "synthetic" (2 images, an --expected_results it misses) or "tsv"
    (:func:`detector_tsv`, one it meets), with --coco_eval."""
    flags = (["--synthetic", "2", "--expected_results", MISS]
             if source == "synthetic" else
             ["--tsv", detector_tsv(), "--expected_results", MEET])
    out = os.path.join(work_dir(), f"jax_{source}.pk")
    results, ok = jtool.main(_common() + flags + ["--coco_eval", "--output", out])
    with open(out, "rb") as f:
        return results, ok, pickle.load(f)["predictions"]


def _same_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= METRIC_TOL, k


@pytest.mark.parametrize("source", ["synthetic", "tsv"])
def test_test_detector_matches_jax(tmp_path, source):
    """Per-image detections within TOL, labels exact; VOC mAP and COCO AP /
    AP50 / AP75 within 1e-6; the same ``ok`` from --expected_results (met on
    the TSV, missed on the synthetic images)."""
    want_results, want_ok, want_preds = jax_detector_run(source)
    flags = (["--synthetic", "2", "--expected_results", MISS]
             if source == "synthetic" else
             ["--tsv", detector_tsv(), "--expected_results", MEET])
    out = tmp_path / "port.pk"
    results, ok = tool.main(_common() + flags + [
        "--device", "cpu", "--coco_eval", "--output", str(out)])
    with open(out, "rb") as f:
        saved = pickle.load(f)
    preds = saved["predictions"]
    _same_metrics(saved["results"], results)
    assert ok is want_ok is (source == "tsv")
    assert len(preds) == len(want_preds) == 2
    for p, w in zip(preds, want_preds):
        np.testing.assert_array_equal(p["labels"], w["labels"])
        np.testing.assert_allclose(p["boxes"], w["boxes"], **TOL)
        np.testing.assert_allclose(p["scores"], w["scores"], **TOL)
    _same_metrics(results, want_results)
    if source == "tsv":
        assert 0.0 < results["mAP"] < 1.0
        assert results["coco_AP50"] > 0.0


def test_test_detector_voc_convention_and_ann_file(tmp_path):
    """``--voc_box_convention`` changes the VOC matching as the JAX
    evaluator's does; ``--ann_file`` + ``--image_root`` reads xywh gts and
    puts the image on the canvas."""
    images = _tsv_images()
    for key, img in images.items():
        Image.fromarray(img).save(tmp_path / f"{key}.png")
    anns = [{"img": f"{k}.png", "width": 64, "height": img.shape[0],
             "boxes": [[10, 10, 20, 20]], "labels": [5]}
            for k, img in images.items()]
    (tmp_path / "anns.json").write_text(json.dumps(anns))
    common = _common() + ["--device", "cpu"]
    by_ann, _ = tool.main(common + ["--ann_file", str(tmp_path / "anns.json"),
                                    "--image_root", str(tmp_path)])
    assert 0.0 <= by_ann["mAP"] <= 1.0
    out = tmp_path / "p.pk"
    tool.main(common + ["--tsv", detector_tsv(), "--output", str(out)])
    with open(out, "rb") as f:
        preds = pickle.load(f)["predictions"]
    ds = vg_tsv.DetectionTSVDataset(detector_tsv())
    gts = [ds.get_target(i) for i in range(len(ds))]
    got, _ = tool.main(common + ["--tsv", detector_tsv(),
                                 "--voc_box_convention"])
    assert got == jeval.eval_detection_voc(preds, gts, 7,
                                           double_inclusive=True)


def test_test_detector_attr_eval_matches_jax():
    """--attr_eval (force-boxes attribute head on the gt boxes, the
    reference's post-processing on the host): attribute mAP within 1e-6 of
    the JAX tool's."""
    flags = _common() + ["--tsv", detector_tsv(), "--attr_eval"]
    want = jtool.main(flags)
    got = tool.main(flags + ["--device", "cpu"])
    _same_metrics(got, want)
    assert 0.0 < got["attr_mAP"] <= 1.0
    with pytest.raises(SystemExit, match="standalone"):
        tool.main(flags + ["--device", "cpu", "--coco_eval"])


@pytest.mark.parametrize("flags", [["--bbox_aug"], ["--sg"], ["relation"]])
def test_test_detector_refuses_what_is_not_ported(tmp_path, monkeypatch, flags):
    """--bbox_aug, --sg and a relation yaml (which sets --sg and
    --rel_algorithm) refused, naming ROADMAP.md Queue 1 item 7, until the
    scene-graph slice ported them: now each runs and returns its results
    (the augmented detections' mAP; the ``sg_<protocol>_<k>`` recalls over
    the relations of tests/test_vg_tsv.py's fixture). A multi-process
    launch named item 9 until the process runtime was ported: the case now
    runs under one (``test_torch_distributed.multi_process_env``), the
    tool calling ``initialize_from_env`` first."""
    import dataclasses

    from cpt_tpu_torch.models.detector import yacs_bridge
    from cpt_tpu_torch.models.detector.config import \
        tiny_detector_config as port_tiny

    argv = ["--tiny", "--device", "cpu", "--dtype", "float32", "--checkpoint",
            checkpoint()]
    if flags == ["--bbox_aug"]:
        argv += ["--synthetic", "1", "--bbox_aug"]
    else:
        argv += ["--tsv", _vg_fixture(vg_tsv, tmp_path), "--max_rel_dets", "4"]
    if flags == ["relation"]:
        (tmp_path / "rel.yaml").write_text(
            "MODEL:\n  RELATION_ON: True\n  ROI_RELATION_HEAD:\n"
            "    ALGORITHM: sg_imp\n")
        real = yacs_bridge.load_reference_yaml
        # the yaml's detector is X152; the case runs it at the tiny size
        monkeypatch.setattr(yacs_bridge, "load_reference_yaml", lambda *a, **kw:
                            dataclasses.replace(real(*a, **kw), detector=port_tiny()))
        argv += ["--config_file", str(tmp_path / "rel.yaml")]
    else:
        argv += flags
    built = []
    real_build = tool.build_scene_parser
    monkeypatch.setattr(tool, "build_scene_parser",
                        lambda *a: built.append(real_build(*a)) or built[-1])
    calls = multi_process_env(monkeypatch)
    results, ok = tool.main(argv)
    assert calls == [True]
    assert ok and 0.0 <= results["mAP"] <= 1.0
    sg = {k: v for k, v in results.items() if k.startswith("sg_")}
    if flags == ["--bbox_aug"]:
        assert not sg and not built
    else:
        assert [p.algorithm for p in built] == [
            "sg_imp" if flags == ["relation"] else "sg_reldn"]
        assert sorted(sg) == sorted(f"sg_{p}_metric_sgdet{k}" for p in
                                    ("rowan", "danfei") for k in (20, 50, 100))
        assert all(0.0 <= v <= 1.0 for v in sg.values())


# --- tools/extract_features --image_dir ------------------------------------------

@functools.lru_cache(maxsize=None)
def image_dir() -> str:
    d = os.path.join(work_dir(), "images")
    os.makedirs(d)
    for i, (h, w) in enumerate([(60, 56), (64, 64)]):
        Image.fromarray(np.random.RandomState(40 + i).randint(
            0, 256, (h, w, 3)).astype(np.uint8)).save(f"{d}/im{i}.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(f"{d}/skip.png")
    return d


def _rows(path):
    tsv = TSVFile(str(path))
    rows = [tsv.seek(i) for i in range(len(tsv))]
    tsv.close()
    return [(k, json.loads(v)) for k, v in rows]


@functools.lru_cache(maxsize=None)
def jax_image_dir_rows():
    out = os.path.join(work_dir(), "jax_plain.tsv")
    jextract.main(_common() + ["--image_dir", image_dir(), "--output", out])
    return _rows(out)


def test_extract_features_image_dir_matches_jax(tmp_path):
    """One row a .jpg (sorted stems): the same keys, classes and bbox_ids
    as the JAX tool's, rects, confs and decoded 2054-d-layout features
    within TOL."""
    want = jax_image_dir_rows()
    out = extract_features.main(_common() + [
        "--image_dir", image_dir(), "--device", "cpu",
        "--output", str(tmp_path / "plain.tsv")])
    assert out["images"] == 2
    got = _rows(tmp_path / "plain.tsv")
    assert [k for k, _ in got] == [k for k, _ in want] == ["im0", "im1"]
    for (_, g), (_, w) in zip(got, want):
        assert g["relations"] is w["relations"] is None
        go, wo = g["objects"], w["objects"]
        assert [o["class"] for o in go] == [o["class"] for o in wo]
        assert [o["bbox_id"] for o in go] == [o["bbox_id"] for o in wo]
        np.testing.assert_allclose([o["rect"] for o in go],
                                   [o["rect"] for o in wo], **TOL)
        np.testing.assert_allclose([o["conf"] for o in go],
                                   [o["conf"] for o in wo], **TOL)
        gf = np.stack([decode_feature(o["feature"]) for o in go])
        wf = np.stack([decode_feature(o["feature"]) for o in wo])
        assert np.isfinite(gf).all()
        np.testing.assert_allclose(gf, wf, **TOL)


def test_extract_features_image_dir_labelmap_and_shards(tmp_path):
    """--labelmap names the classes; --total_step / --cur_step take a
    shard of the sorted files, as the JAX tool's shard_and_sample does."""
    (tmp_path / "lm.json").write_text(json.dumps(
        {"idx_to_label": {str(i): f"name{i}" for i in range(1, 7)}}))
    common = _common() + ["--image_dir", image_dir(), "--device", "cpu"]
    extract_features.main(common + ["--labelmap", str(tmp_path / "lm.json"),
                                    "--output", str(tmp_path / "a.tsv")])
    named = _rows(tmp_path / "a.tsv")
    assert all(o["class"].startswith("name") for _, r in named
               for o in r["objects"])
    extract_features.main(common + ["--total_step", "2", "--cur_step", "1",
                                    "--output", str(tmp_path / "b.tsv")])
    assert [k for k, _ in _rows(tmp_path / "b.tsv")] == ["im1"]


# --- tools/demo -------------------------------------------------------------------

def test_demo_drawing_matches_jax():
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    labels = np.array([1, 7, 42, 1593])
    np.testing.assert_array_equal(demo.colors_for_labels(labels),
                                  jdemo.colors_for_labels(labels))
    boxes = np.array([[4, 4, 30, 30], [-5, 10, 70, 40], [20.7, 3.2, 21, 4],
                      [60, 40, 63, 47]], np.float32)
    for box, thick in zip(boxes, (1, 2, 3, 5)):
        np.testing.assert_array_equal(
            demo.draw_box_outline(img, box, (0, 255, 0), thick),
            jdemo.draw_box_outline(img, box, (0, 255, 0), thick))
    scores = np.array([0.91, 0.5, 0.123, 0.05], np.float32)
    for names in (None, {1: "person", 7: "dog"}):
        np.testing.assert_array_equal(
            demo.overlay_detections(img.copy(), boxes, labels, scores, names),
            jdemo.overlay_detections(img.copy(), boxes, labels, scores, names))


@pytest.mark.parametrize("mode", [[], ["--multi_color"]])
def test_demo_paint_matches_jax(tmp_path, mode):
    """The paint modes' PNGs, bit-equal to the JAX tool's."""
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)).save(
        tmp_path / "img.png")
    boxes = json.dumps([[4, 4, 30, 30], [20, 20, 50, 50], [40, 2, 63, 20]])
    argv = ["--image", str(tmp_path / "img.png"), "--boxes", boxes,
            "--pred_box", json.dumps([4, 4, 30, 30])] + mode
    demo.main(argv + ["--device", "cpu", "--out", str(tmp_path / "p.png")])
    jdemo.main(argv + ["--out", str(tmp_path / "j.png")])
    tags = ["all"] if mode else ["copy0", "copy1", "copy2"]
    for tag in tags:
        suffix = "" if mode else f"_{tag}"
        got = np.asarray(Image.open(tmp_path / f"p{suffix}.png"))
        want = np.asarray(Image.open(tmp_path / f"j{suffix}.png"))
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, np.asarray(Image.open(tmp_path / "img.png")))


def _fake_cv2(frames, written):
    class Cam:
        def __init__(self, dev):
            self.i = 0

        def isOpened(self):
            return True

        def read(self):
            if self.i >= len(frames):
                return False, None
            self.i += 1
            return True, frames[self.i - 1]

        def release(self):
            pass

    mod = types.ModuleType("cv2")
    mod.VideoCapture = Cam
    mod.imwrite = lambda path, arr: written.setdefault(path, arr.copy())
    return mod


def test_demo_detect_and_webcam_match_jax(tmp_path, monkeypatch):
    """--detect draws the detector's boxes over the image; --webcam (a fake
    cv2 capture of 3 frames, 2 taken) gives the JAX tool's frames for the
    same detections."""
    frames = [np.random.RandomState(i).randint(0, 256, (64, 64, 3)).astype(
        np.uint8) for i in range(3)]
    dets = (np.array([[4, 4, 30, 30], [10, 20, 60, 50]], np.float32),
            np.array([3, 5]), np.array([0.8, 0.4], np.float32))
    got, want = {}, {}
    argv = ["--webcam", "--max_frames", "2", "--tiny", "--conf", "0.0"]
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(frames, want))
    monkeypatch.setattr(jdemo, "run_detector", lambda args, img: dets)
    jdemo.main(argv + ["--out", str(tmp_path / "cam.png")])
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(frames, got))
    calls = []
    monkeypatch.setattr(demo, "build_detect",
                        lambda args: lambda img: calls.append(img) or dets)
    demo.main(argv + ["--out", str(tmp_path / "cam.png")])
    assert sorted(got) == sorted(want) == [str(tmp_path / f"cam_000{i}.png")
                                           for i in range(2)]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(calls) == 2
    np.testing.assert_array_equal(calls[1], frames[1][:, :, ::-1])
    # --detect on a real (tiny) detector through run_detector
    monkeypatch.undo()
    Image.fromarray(frames[0]).save(tmp_path / "img.png")
    demo.main(["--image", str(tmp_path / "img.png"), "--detect", "--tiny",
               "--conf", "0.0", "--device", "cpu", "--dtype", "float32",
               "--checkpoint", checkpoint(), "--out", str(tmp_path / "d.png")])
    arr = np.asarray(Image.open(tmp_path / "d.png"))
    assert arr.shape == (64, 64, 3) and not np.array_equal(arr, frames[0])


# --- chip_smoke.py phase 12 --------------------------------------------------------

def test_phase12_dry_run():
    """``chip_smoke.run_detector_tools`` at the tiny size on the CPU: every
    reading is taken and only the kernel-launch checks fail (no card)."""
    from cpt_tpu_torch.tools import cpt_predict

    res = cpt_predict.build_resident("cpu", torch.float32, tiny=True,
                                     hidden_size=32, num_hidden_layers=2)
    with pytest.raises(AssertionError) as e:
        cs.run_detector_tools(res, cs.kernel_counters(), [], tiny=True)
    failures = ast.literal_eval(e.value.args[0][len("phase 12: "):])
    assert failures and all("launches" in f for f in failures), failures
