"""The synthetic fixtures (``cpt_tpu_torch/data/synthetic.py``) against
the JAX package's (``cpt_tpu/data/synthetic.py``): at the same seed each
generator writes the same files, byte for byte, through the port's own
TSV writer."""
import os
import pickle

import numpy as np
import pytest

from cpt_tpu.data import synthetic as jsynthetic
from cpt_tpu_torch.data import synthetic


@pytest.mark.parametrize("name,kw", [
    ("generate_refcoco_fixture", {}),
    ("generate_refcoco_fixture", {"n_queries": 5, "n_copies": 3,
                                  "n_objects": 4, "feat_dim": 134, "seed": 3,
                                  "split": "train"}),
    ("generate_gqa_fixture", {"seed": 2}),
    ("generate_vcr_fixture", {"seed": 1}),
    ("generate_vg_fixture", {"seed": 4})])
def test_fixtures_equal_jax_byte_for_byte(tmp_path, name, kw):
    got = getattr(synthetic, name)(str(tmp_path / "port"), **kw)
    want = getattr(jsynthetic, name)(str(tmp_path / "jax"), **kw)
    assert got.keys() == want.keys()
    for key in got:
        assert os.path.basename(got[key]) == os.path.basename(want[key])
        with open(got[key], "rb") as f, open(want[key], "rb") as g:
            a, b = f.read(), g.read()
        if key == "gt_file":   # the pickled relations: equal arrays
            ga, wa = pickle.loads(a), pickle.loads(b)
            assert [d["img_path"] for d in ga] == [d["img_path"] for d in wa]
            for x, y in zip(ga, wa):
                np.testing.assert_array_equal(x["relations"], y["relations"])
        else:
            assert len(a) > 0 and a == b, key
    lineidx = [p for p in os.listdir(tmp_path / "port") if p.endswith(".lineidx")]
    for p in lineidx:
        assert (tmp_path / "port" / p).read_bytes() == (
            tmp_path / "jax" / p).read_bytes()
