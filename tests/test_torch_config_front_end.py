"""The port's front end to the reference's own yacs yamls against the JAX
package's: ``config/core`` (from_yaml, merge_dict, replace_path,
apply_overrides), ``models/detector/yacs_bridge.load_reference_yaml``,
``tools/_common.apply_reference_config`` and
``tools/extract_features.apply_ref_to_extract_args``, on yamls and opts
lists written here (the reference tree is not in the repository), and the
tools whose JAX ``main`` starts a distributed runtime running under a
multi-process launch's environment (they refused it before the process
runtime was ported)."""
import argparse
import dataclasses
import json
from typing import Optional, Tuple

import pytest

import chip_smoke as cs
from cpt_tpu.config import core as jcore
from cpt_tpu.models.detector import yacs_bridge as jbridge
from cpt_tpu.models.detector.config import VINVL_X152C4 as J_VINVL
from cpt_tpu.tools import _common as jcommon
from cpt_tpu.tools import extract_features as jextract
from cpt_tpu.tools import test_detector as jtest_detector
from cpt_tpu_torch.config import core
from cpt_tpu_torch.models.detector import yacs_bridge as bridge
from cpt_tpu_torch.models.detector.config import VINVL_X152C4
from cpt_tpu_torch.tools import _common as common
from cpt_tpu_torch.tools import extract_features, test_detector
from test_torch_distributed import multi_process_env
from test_torch_watchdog import guards

guard_module, guard_case = guards(120)

# a maskrcnn-benchmark zoo yaml (configs/e2e_mask_rcnn_R_50_C4_1x.yaml's keys)
MASK_RCNN_YAML = """\
MODEL:
  META_ARCHITECTURE: "GeneralizedRCNN"
  WEIGHT: "catalog://ImageNetPretrained/MSRA/R-50"
  RPN:
    PRE_NMS_TOP_N_TEST: 6000
    POST_NMS_TOP_N_TEST: 1000
  ROI_MASK_HEAD:
    PREDICTOR: "MaskRCNNC4Predictor"
    SHARE_BOX_FEATURE_EXTRACTOR: True
  MASK_ON: True
DATASETS:
  TRAIN: ("coco_2014_train", "coco_2014_valminusminival")
  TEST: ("coco_2014_minival",)
SOLVER:
  BASE_LR: 0.01
  WEIGHT_DECAY: 0.0001
  STEPS: (120000, 160000)
  MAX_ITER: 180000
"""
# a scene-graph yaml (sgg_configs/vg_vrd/rel_danfeiX_FPN50_reldn.yaml's keys)
RELATION_YAML = """\
MODEL:
  META_ARCHITECTURE: "SceneParser"
  BACKBONE:
    CONV_BODY: "R-50-FPN"
  RELATION_ON: True
  USE_FREQ_PRIOR: True
  ROI_BOX_HEAD:
    NUM_CLASSES: 151
  ROI_RELATION_HEAD:
    ALGORITHM: "sg_reldn"
    NUM_CLASSES: 51
    USE_BIAS: True
    TRIPLETS_PER_IMG: 50
INPUT:
  MIN_SIZE_TEST: 592
  MAX_SIZE_TEST: 1000
DATALOADER:
  SIZE_DIVISIBILITY: 32
TEST:
  EXPECTED_RESULTS: (("bbox", "AP", 0.3, 0.02),)
"""


def _yaml(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _same_run_config(port, ref):
    """Both packages' ReferenceRunConfigs agree field by field, ``raw``
    included; → the port's."""
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    assert core.to_dict(port) == jcore.to_dict(ref)
    return port


@pytest.mark.parametrize("name,text,opts", [
    ("vinvl", cs.VINVL_YAML, None),
    ("vinvl_refcoco", cs.VINVL_YAML, list(cs.REFCOCO_OPTS)),
    ("vinvl_detector_tools", cs.VINVL_YAML, list(cs.DETECTOR_OPTS)),
    ("mask_rcnn_r50_c4", MASK_RCNN_YAML, None),
    ("relation", RELATION_YAML, ["MODEL.ROI_RELATION_HEAD.ALGORITHM", "sg_imp"]),
    ("literals", "MODEL:\n  ATTRIBUTE_ON: True\n",
     ["SOLVER.STEPS", "(30000, 40000)", "MODEL.RELATION_ON", "True",
      "INPUT.PIXEL_MEAN", "[1.0, 2.0, 3.0]", "MODEL.BACKBONE.CONV_BODY",
      "X-101-32x8d-FPN", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
      "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 0.1, 0.01]]",
      "OUTPUT_DIR", "/tmp/o", "N_SHOT", "4"]),
])
def test_load_reference_yaml_matches_jax(tmp_path, name, text, opts):
    path = _yaml(tmp_path, f"{name}.yaml", text)
    got = _same_run_config(bridge.load_reference_yaml(path, opts),
                           jbridge.load_reference_yaml(path, opts))
    if name == "vinvl_refcoco":
        assert cs.resolves_to_vinvl(got)
    if name == "vinvl":        # the yaml alone keeps the reference defaults
        assert got.detector.roi_heads.nms_filter == 0
        assert not got.detector.force_boxes
        assert got.solver.steps == (49000, 65000)
    if name == "mask_rcnn_r50_c4":
        assert got.detector.backbone.stage_blocks == (3, 4, 6)
        assert got.detector.rpn.post_nms_top_n_test == 1000
        assert got.datasets_train == ("coco_2014_train",
                                      "coco_2014_valminusminival")
    if name == "relation":
        assert got.relation_on and got.relation_algorithm == "sg_imp"
        assert got.detector.input.size_divisibility == 32
        assert got.expected_results == (("bbox", "AP", 0.3, 0.02),)
    if name == "literals":
        assert got.solver.steps == (30000, 40000)
        assert got.detector.input.pixel_mean == (1.0, 2.0, 3.0)
        assert got.solver.clip_gradients == 5.0
        assert got.raw["N_SHOT"] == 4


def test_refcoco_cmd_resolves_to_builtin_vinvl(tmp_path):
    """refcoco_val.sh's yaml + opts gives the port's VINVL_X152C4 field for
    field, as the JAX package's gives its own; the canvas rule rounds the
    600/1000 test sizes up to 640/1024."""
    path = _yaml(tmp_path, "vinvl.yaml", cs.VINVL_YAML)
    got = bridge.load_reference_yaml(path, list(cs.REFCOCO_OPTS))
    want = jbridge.load_reference_yaml(path, list(cs.REFCOCO_OPTS))
    for part in ("backbone", "rpn", "roi_heads", "attributes", "input"):
        assert getattr(got.detector, part) == getattr(VINVL_X152C4, part)
        assert (dataclasses.asdict(getattr(want.detector, part))
                == dataclasses.asdict(getattr(J_VINVL, part)))
    assert got.detector.input.buckets == ((640, 1024), (1024, 640),
                                          (1024, 1024))
    assert (got.weight, got.data_dir) == ("models/vinvl/vinvl_vg_x152c4.pth",
                                          "data/refcoco/yamls/refcoco_val.yaml")


@pytest.mark.parametrize("opts", [["ODD"], ["A", "1", "B"]])
def test_odd_opts_raise(tmp_path, opts):
    path = _yaml(tmp_path, "c.yaml", "MODEL:\n  ATTRIBUTE_ON: True\n")
    for m in (bridge, jbridge):
        with pytest.raises(ValueError, match="KEY VALUE"):
            m.load_reference_yaml(path, opts)


@pytest.mark.parametrize("body", ["R-152-C4", "R-50-C4", "R-101-C4",
                                  "X-101-32x8d-FPN", "X-152-64x4d-C4", "odd"])
def test_bridge_tables_copy(body):
    assert bridge._REF_DEFAULTS == jbridge._REF_DEFAULTS
    assert bridge._DEPTH_BLOCKS == jbridge._DEPTH_BLOCKS
    assert bridge._parse_conv_body(body) == jbridge._parse_conv_body(body)
    for v in ("(1, 2)", "[3, 'a']", "sg_imp", "True", "1e-3", "{'a': '(1,)'}"):
        assert bridge._decode(v) == jbridge._decode(v)
    tree = {"A": {"B": 1, "C": {"D": (2,)}}, "E": "x"}
    assert bridge._flatten(tree) == jbridge._flatten(tree)
    assert [bridge._round_up(x, 64) for x in (600, 640, 1000, 1)] == [
        jbridge._round_up(x, 64) for x in (600, 640, 1000, 1)]


@dataclasses.dataclass(frozen=True)
class _Inner:
    a: int = 1
    b: Tuple[float, ...] = (1.0,)
    c: Optional[str] = None
    flag: bool = False


@dataclasses.dataclass(frozen=True)
class _Outer:
    inner: _Inner = dataclasses.field(default_factory=_Inner)
    name: str = "x"
    pair: Tuple[int, int] = (1, 2)


def test_config_core_matches_jax(tmp_path):
    """``from_yaml`` / ``merge_dict`` / ``replace_path`` /
    ``apply_overrides`` coerce and merge as the JAX package's do, and
    refuse an unknown key alike."""
    path = _yaml(tmp_path, "c.yaml",
                 "inner:\n  a: '7'\n  b: [2, 3]\n  flag: 'yes'\nname: 5\n")
    opts = {"inner.c": 9, "pair": ["4", "5"], "inner.flag": "off"}
    got, want = (m.from_yaml(_Outer, path, opts) for m in (core, jcore))
    assert got == want == _Outer(_Inner(7, (2.0, 3.0), "9", False), "5",
                                 (4, 5))
    assert (core.replace_path(_Outer(), "inner.b", [1, 2])
            == jcore.replace_path(_Outer(), "inner.b", [1, 2]))
    assert (core.apply_overrides(_Outer(), {"name": 3, "inner.a": 2.0})
            == jcore.apply_overrides(_Outer(), {"name": 3, "inner.a": 2.0}))
    assert core.dumps(got) == jcore.dumps(want)
    for m in (core, jcore):
        with pytest.raises(KeyError, match="unknown config key"):
            m.merge_dict(_Outer(), {"nope": 1})
        with pytest.raises(TypeError):
            m.merge_dict({"a": 1}, {})
    # the detector config tree too
    dpath = _yaml(tmp_path, "d.yaml", "rpn:\n  post_nms_top_n_test: 100\n"
                  "input:\n  buckets: [[64, 64]]\n  pad_h: '64'\n")
    from cpt_tpu.models.detector.config import DetectorConfig as JDet
    from cpt_tpu_torch.models.detector.config import DetectorConfig

    got = core.from_yaml(DetectorConfig, dpath, {"roi_heads.nms_filter": "1"})
    want = jcore.from_yaml(JDet, dpath, {"roi_heads.nms_filter": "1"})
    assert core.to_dict(got) == jcore.to_dict(want)
    assert got.input.buckets == ((64, 64),) and got.roi_heads.nms_filter == 1


def _solver_parser(m):
    """A parser with every flag ``apply_reference_config`` may fill (the
    JAX package's train_detector, which the port does not have yet), and
    the detector-config flags."""
    p = argparse.ArgumentParser()
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--max_iter", type=int, default=100)
    p.add_argument("--steps", type=int, nargs="*", default=[10])
    p.add_argument("--warmup_iters", type=int, default=5)
    p.add_argument("--checkpoint_period", type=int, default=50)
    p.add_argument("--output_dir", default="out")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--expected_results", default=None)
    p.add_argument("--sg", action="store_true")
    p.add_argument("--rel_algorithm", default="sg_reldn")
    return m.add_detector_config_args(p)


@pytest.mark.parametrize("case", ["yaml", "opts", "cli", "none", "relation",
                                  "weight"])
def test_apply_reference_config_precedence_matches_jax(tmp_path, case):
    """defaults ← yaml ← opts ← CLI: yaml values become parser defaults,
    ``--opts`` override the yaml, explicit flags win; no --config_file is a
    no-op; a relation yaml sets --sg and --rel_algorithm; MODEL.WEIGHT is
    found next to the yaml."""
    (tmp_path / "w.pth").write_bytes(b"x")
    text = {"relation": RELATION_YAML,
            "weight": "MODEL:\n  WEIGHT: w.pth\n"}.get(
        case, "SOLVER:\n  BASE_LR: 0.02\n  MAX_ITER: 123\n"
              "  STEPS: \"(50, 100)\"\n  CHECKPOINT_PERIOD: 7\n"
              "OUTPUT_DIR: /tmp/refout\n")
    path = _yaml(tmp_path, "c.yaml", text)
    argv = {"yaml": ["--config_file", path],
            "opts": ["--config_file", path, "--opts", "SOLVER.MAX_ITER", "77",
                     "SOLVER.WARMUP_ITERS", "9"],
            "cli": ["--config_file", path, "--opts", "SOLVER.MAX_ITER", "77",
                    "--max_iter", "999", "--steps", "3", "4"],
            "none": ["--opts", "SOLVER.MAX_ITER", "77"]}.get(
        case, ["--config_file", path])
    got = []
    for m in (common, jcommon):
        parser = _solver_parser(m)
        ref = m.apply_reference_config(parser, argv)
        got.append((ref is None, vars(parser.parse_args(argv))))
    assert got[0] == got[1]
    none, args = got[0]
    assert none == (case == "none")
    if case == "none":
        assert args["max_iter"] == 100 and args["base_lr"] == 0.01
    if case in ("yaml", "opts", "cli"):
        assert args["base_lr"] == 0.02 and args["output_dir"] == "/tmp/refout"
        assert args["max_iter"] == {"yaml": 123, "opts": 77, "cli": 999}[case]
        assert args["steps"] == ([3, 4] if case == "cli" else [50, 100])
    if case == "relation":
        assert args["sg"] and args["rel_algorithm"] == "sg_reldn"
        assert json.loads(args["expected_results"]) == [["bbox", "AP", 0.3,
                                                          0.02]]
    if case == "weight":
        assert args["checkpoint"] == str(tmp_path / "w.pth")


def test_test_detector_takes_the_reference_config(tmp_path):
    """Both test_detector parsers take the same defaults from a yaml:
    TEST.EXPECTED_RESULTS → --expected_results, MODEL.WEIGHT next to the
    yaml → --checkpoint, a relation yaml → --sg; flags win."""
    (tmp_path / "w.pth").write_bytes(b"x")
    path = _yaml(tmp_path, "c.yaml",
                 RELATION_YAML.replace("MODEL:\n", "MODEL:\n  WEIGHT: w.pth\n"))
    argv = ["--config_file", path, "--opts", "MODEL.ROI_HEADS.NMS_FILTER",
            "1", "--rel_algorithm", "sg_imp"]
    got = []
    for m, tool in ((common, test_detector), (jcommon, jtest_detector)):
        parser = tool.build_args()
        ref = m.apply_reference_config(parser, argv)
        args = vars(parser.parse_args(argv))
        got.append((args["sg"], args["rel_algorithm"], args["checkpoint"],
                    args["expected_results"], ref.detector.roi_heads.nms_filter))
    assert got[0] == got[1] == (True, "sg_imp", str(tmp_path / "w.pth"),
                                json.dumps([["bbox", "AP", 0.3, 0.02]]), 1)


def _extract_args(m, argv, ref):
    return vars(m.apply_ref_to_extract_args(m.build_args().parse_args(argv),
                                            ref))


@pytest.mark.parametrize("case", ["mapping", "explicit", "cpt_keys",
                                  "cpt_keys_explicit", "unmapped"])
def test_apply_ref_to_extract_args_matches_jax(tmp_path, case):
    """DATASETS.TEST → --task, DATA_DIR → --yaml, OUTPUT_DIR →
    <OUTPUT_DIR>/inference/<stem>/predictions.tsv, the CPT keys of the opts
    → their flags; explicit flags win (the JAX package's
    test_extract_args_mapping and test_extract_args_cpt_keys_from_opts,
    against both packages)."""
    path = _yaml(tmp_path, "c.yaml", "OUTPUT_DIR: /tmp/o\n")
    opts = {"mapping": ["DATASETS.TEST", '("GQAColorDataset",)',
                        "DATA_DIR", "data/gqa/yamls/gqa_val.yaml"],
            "explicit": ["DATASETS.TEST", '("GQAColorDataset",)',
                         "DATA_DIR", "data/gqa/yamls/gqa_val.yaml"],
            "unmapped": ["DATASETS.TEST", '("NoSuchDataset",)']}.get(
        case, ["N_SHOT", "4", "RAND_SEED", "7", "COLOR_D", "3",
               "TOTAL_STEP", "15", "CUR_STEP", "2", "COLOR_NAME", "green",
               "COLOR_RGB", "0-255-0"])
    argv = {"explicit": ["--task", "plain", "--output", "x.tsv"],
            "cpt_keys": ["--task", "vcr", "--output", "x.tsv"],
            "cpt_keys_explicit": ["--task", "vcr", "--output", "x.tsv",
                                  "--n_shot", "9", "--color_d", "0"]}.get(
        case, [])
    argv = ["--config_file", path] + argv
    ref = bridge.load_reference_yaml(path, opts)
    jref = jbridge.load_reference_yaml(path, opts)
    if case == "unmapped":
        for m, r in ((extract_features, ref), (jextract, jref)):
            with pytest.raises(SystemExit, match="NoSuchDataset"):
                _extract_args(m, argv, r)
        return
    got = _extract_args(extract_features, argv, ref)
    want = _extract_args(jextract, argv, jref)
    for k in ("task", "yaml", "output", "n_shot", "rand_seed", "color_d",
              "total_step", "cur_step", "color_name", "color_rgb"):
        assert got[k] == want[k], k
    if case == "mapping":
        assert (got["task"], got["yaml"], got["output"]) == (
            "gqa", "data/gqa/yamls/gqa_val.yaml",
            "/tmp/o/inference/gqa_val/predictions.tsv")
    if case == "explicit":
        assert (got["task"], got["output"]) == ("plain", "x.tsv")
    if case == "cpt_keys":
        assert (got["n_shot"], got["rand_seed"], got["color_d"],
                got["total_step"], got["cur_step"]) == (4, 7, 3, 15, 2)
        assert (got["color_name"], got["color_rgb"]) == ("green", "0-255-0")
    if case == "cpt_keys_explicit":
        assert got["n_shot"] == 9 and got["color_d"] == 0


def test_extract_features_output_from_the_config(tmp_path):
    """Without --output the tool takes OUTPUT_DIR's layout from the yaml
    (and refuses without either), and ``--task`` falls back to refcoco."""
    path = _yaml(tmp_path, "c.yaml",
                 f"OUTPUT_DIR: {tmp_path / 'out'}\nDATA_DIR: d/val\n")
    with pytest.raises(SystemExit):
        extract_features.main(["--tiny", "--device", "cpu"])
    (tmp_path / "out" / "inference" / "val").mkdir(parents=True)
    out = tmp_path / "out" / "inference" / "val" / "predictions.tsv"
    out.write_text("")
    # the output exists: the tool stops before it builds anything
    assert extract_features.main(["--config_file", path]) == {}


# --- the former multi-process refusals ----------------------------------------

@pytest.mark.parametrize("tool", ["extract_features", "refcoco_cpt",
                                  "validate_checkpoints", "test_detector"])
def test_tool_refuses_a_multi_process_launch(tmp_path, monkeypatch, tool):
    """Under a torchrun-style environment these tools refused, naming
    ROADMAP.md Queue 1 item 9, until the process runtime was ported: now
    each calls ``parallel/distributed.initialize_from_env`` first, where
    its JAX ``main`` does, and runs to its end (the runtime's start is
    recorded, not made: ``test_torch_distributed.multi_process_env``; that
    file runs two real processes)."""
    import importlib

    from cpt_tpu.data.synthetic import generate_refcoco_fixture

    mod = importlib.import_module(f"cpt_tpu_torch.tools.{tool}")
    out = tmp_path / "o.tsv"
    cpu = ["--device", "cpu", "--dtype", "float32"]
    if tool == "refcoco_cpt":
        p = generate_refcoco_fixture(str(tmp_path / "fx"), n_queries=3,
                                     n_copies=3, n_objects=4, feat_dim=134)
        argv = ["--data_file", p["data_file"], "--ann_file", p["ann_file"],
                "--det_file", p["det_file"], "--img_feature_dim", "134",
                "--hidden_size", "32", "--num_hidden_layers", "2",
                "--txt_seq_len", "24", "--img_seq_len", "6",
                "--output", str(out)] + cpu
    else:
        argv = {"extract_features": ["--tiny", "--synthetic", "1",
                                     "--output", str(out)] + cpu,
                "validate_checkpoints": ["--dryrun", "--workdir",
                                         str(tmp_path / "w"), "--n_images",
                                         "2"] + cpu,
                "test_detector": ["--tiny", "--synthetic", "1", "--output",
                                  str(out)] + cpu}[tool]
    calls = multi_process_env(monkeypatch)
    mod.main(argv)
    # the dry run calls extract_features' and refcoco_cpt's mains in turn
    assert calls == [True] * (3 if tool == "validate_checkpoints" else 1)
    assert (tmp_path / "w").exists() if tool == "validate_checkpoints" \
        else out.exists()


def test_refcoco_cpt_refuses_data_parallel():
    """``--dp 2`` named ROADMAP item 9(b) until the meshes were ported; in
    a world of one process it now raises with the launch recipe of a
    world of two (one process a card; it runs there,
    ``test_torch_train.test_tool_data_parallel_matches_jax``)."""
    from cpt_tpu_torch.tools import refcoco_cpt

    with pytest.raises(SystemExit,
                       match=r"dp 2 × tp 1 needs 2 processes.*CPT_NUM_PROCESSES=2"):
        refcoco_cpt.main(["--data_file", "d", "--ann_file", "a",
                          "--det_file", "t", "--dp", "2", "--device", "cpu"])
