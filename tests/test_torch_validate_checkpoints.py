"""``tools/validate_checkpoints --dryrun`` of the port against the JAX tool
on the CPU in f32: the same synthetic fixture (seeded), random checkpoints
in the real ``.pth`` / ``.bin`` layouts, both stages on tiny configs."""
import functools
import json
import shutil

import numpy as np
import pytest

from cpt_tpu.tools import validate_checkpoints as jtool
from cpt_tpu_torch.tools import validate_checkpoints as tool
from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

WINDOWED_KEYS = {"windowed_tsv", "windowed_drift"}


def _args(workdir):
    return ["--dryrun", "--workdir", str(workdir), "--n_images", "4",
            "--dtype", "float32", "--windowed_drift"]


@functools.lru_cache(maxsize=None)
def _jax_report(root):
    """The JAX tool's report of a dry run with ``--windowed_drift`` (its
    exact TSV is the one without it), and its fixture."""
    return jtool.main(_args(f"{root}/jax"))


def _features(path):
    tsv = TSVFile(str(path))
    rows = [json.loads(tsv.seek(i)[1])["objects"] for i in range(len(tsv))]
    tsv.close()
    return ([np.stack([decode_feature(b["feature"]) for copy in r[0]
                       for b in copy]) for r in rows],
            [[b["class"] for copy in r[0] for b in copy] for r in rows])


@pytest.mark.parametrize("windowed_drift", [False, True])
def test_dryrun_matches_jax_tool(tmp_path_factory, windowed_drift):
    root = tmp_path_factory.getbasetemp() / "validate_checkpoints"
    want = _jax_report(str(root))
    workdir = tmp_path_factory.mktemp("port")
    # the same fixture: both tools draw it from seed 0
    shutil.copytree(f"{root}/jax/fixture", workdir / "fixture")
    argv = _args(workdir)[:-1] + ["--device", "cpu"]
    got = tool.main(argv + (["--windowed_drift"] if windowed_drift else []))
    keys = set(want) if windowed_drift else set(want) - WINDOWED_KEYS
    assert set(got) == keys
    assert got["vinvl"].endswith(".pth") and got["oscar"].endswith(".bin")
    assert got["zero_shot_accuracy"] == want["zero_shot_accuracy"]
    (gf, gl), (wf, wl) = _features(got["exact_tsv"]), _features(want["exact_tsv"])
    assert gl == wl
    for g, w in zip(gf, wf):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    if windowed_drift:
        assert got["windowed_drift"] == pytest.approx(want["windowed_drift"],
                                                      abs=1e-6)
        assert got["windowed_drift"]["label_agreement"] == 1.0


def test_synthetic_fixture_is_the_jax_tools(tmp_path):
    tool.make_synthetic_fixture(str(tmp_path / "port"), 3, (96, 128), seed=2)
    jtool.make_synthetic_fixture(str(tmp_path / "jax"), 3, (96, 128), seed=2)
    for name in ("ann.json", "det.json", "images/img_000002.jpg"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
