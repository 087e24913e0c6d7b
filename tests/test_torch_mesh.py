"""Device meshes (``cpt_tpu_torch/parallel/mesh.py``) and the sharded
engine paths against the JAX package at tiny f32 configs. The port's mesh
is one gloo process a rank on localhost (``test_torch_distributed.
run_group``); the JAX side runs in this process on its 8 virtual CPU
devices. The placement rules leaf by leaf through ``utils/convert``'s name
map, dp-sharded scoring (1e-5), the dp × tp FSDP train step at world 4
(1e-5 after two steps), ``global_batch`` / ``process_allgather`` against
the JAX two-process case, the sharded windowed extractor and the sharded
detector step against the port's one-process runs, and ``--dp`` in a
world of one."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.engine import scoring as jscoring
from cpt_tpu.engine import train as jtrain
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.parallel import mesh as jmesh
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.parallel import mesh
from cpt_tpu_torch.utils import convert as bconv
from test_torch_distributed import run_group, run_pair
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

CFG = dict(vocab_size=192, num_attention_heads=4, hidden_size=32,
           img_feature_dim=20)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def models():
    """(JAX config, JAX params, port config, port state dict) of one
    reference state dict."""
    jcfg = jax_tiny_bert_config(**CFG)
    sd = jconv.random_oscar_state_dict(jcfg, seed=0)
    jparams = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    cfg = tiny_bert_config(**CFG)
    return jcfg, jparams, cfg, bconv.state_from_reference(sd, cfg)


def port_model():
    _, _, cfg, sd = models()
    model = REC_MLM_CPT(cfg, torch.float32).eval()
    model.load_state_dict(sd)
    return model


def jax_leaf(tree, path):
    return functools.reduce(lambda t, k: t[k], path, tree)


def mlm_batch(seed, b=8, t=10, r=4, padded=True):
    rng = np.random.RandomState(seed)
    labels = np.full((b,), 7, np.int32)
    if padded:   # unequal labelled shares: 3 in the first half, 4 in the second
        labels[1] = -1
    return (rng.randint(0, 150, (b, t)).astype(np.int32),
            np.zeros((b, t), np.int32), np.ones((b, t + r), np.int32),
            rng.randn(b, r, CFG["img_feature_dim"]).astype(np.float32),
            np.full((b,), 3, np.int32), labels)


def save_case(tmp_path, **arrays):
    torch.save(models()[3], tmp_path / "sd.pt")
    np.savez(tmp_path / "data.npz", **arrays)
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))


PRELUDE = r'''
import json
import numpy as np
import torch
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.parallel import distributed as D, mesh as M

assert D.initialize_from_env()
pid = D.process_index()
cfg = tiny_bert_config(**json.load(open("cfg.json")))
model = REC_MLM_CPT(cfg, torch.float32).eval()
model.load_state_dict(torch.load("sd.pt"))
data = dict(np.load("data.npz"))
'''


# --- placement rules ------------------------------------------------------------------

@pytest.mark.parametrize("kind,min_size", [("tp", None), ("fsdp", 2 ** 16),
                                           ("fsdp", 256)])
def test_specs_match_jax_leaf_by_leaf(kind, min_size):
    """``param_specs`` / ``fsdp_specs`` (dp 2, tp 2) name, for every port
    parameter, the JAX spec of the same leaf (over the JAX layout, which
    the port's rules view its fused QKV and out kernels in)."""
    jcfg, jparams, cfg, _ = models()
    model = port_model()
    if kind == "tp":
        want, got = jmesh.param_specs(jparams["params"]), mesh.param_specs(model)
    else:
        want = jmesh.fsdp_specs(jparams["params"], 2, min_size=min_size)
        got = mesh.fsdp_specs(model, 2, min_size=min_size)
    paths = bconv.jax_paths(cfg)
    assert got.keys() == paths.keys()
    for name, path in paths.items():
        assert tuple(got[name]) == tuple(jax_leaf(want, path)), name
        view = mesh.view_shape(name, model.state_dict()[name].shape,
                               cfg.num_attention_heads)
        assert view == tuple(jax_leaf(jparams["params"], path).shape), name
    assert any("tp" in s for s in got.values())
    if kind == "fsdp":
        # the tp-ruled leaves take dp anyway; min_size decides the rest
        assert any(s == ("dp",) for s in got.values()) == (min_size == 256)


# --- scoring ----------------------------------------------------------------------------

SCORING = PRELUDE + r'''
from cpt_tpu_torch.engine.scoring import make_mlm_at_mask_fn
mesh = M.make_mesh(dp=2, device="cpu")
out = make_mlm_at_mask_fn(model, mesh)(*[data[k] for k in
                                          ("ids", "tt", "mask", "feats", "pos")])
np.save(f"out{pid}.npy", out)
print(json.dumps({"pid": pid, "dp": M.num_dp(mesh),
                  "rank": mesh.get_local_rank("dp")}), flush=True)
'''


def test_dp_scoring_matches_jax(tmp_path):
    """Each rank scores its half of 16 sequences; both hold the whole
    batch's logits, JAX's ``make_mlm_at_mask_fn(model, mesh)`` (dp 2)."""
    jcfg, jparams, _, _ = models()
    ids, tt, mask, feats, pos, _ = mlm_batch(0, b=16)
    mask[3, 8:] = 0
    jm = jmesh.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    want = np.asarray(jscoring.make_mlm_at_mask_fn(JaxRec(jcfg), mesh=jm)(
        jparams, *(jnp.asarray(a) for a in (ids, tt, mask, feats, pos))))
    save_case(tmp_path, ids=ids.astype(np.int64), tt=tt.astype(np.int64),
              mask=mask.astype(np.int64), feats=feats, pos=pos.astype(np.int64))
    ranks = run_pair(SCORING, tmp_path)
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        np.testing.assert_allclose(np.load(tmp_path / f"out{r['pid']}.npy"),
                                   want, rtol=TOL, atol=TOL)


# --- the FSDP × TP train step ----------------------------------------------------------

FSDP = PRELUDE + r'''
from cpt_tpu_torch.engine import train
opt = json.load(open("opt.json"))
mesh = M.make_mesh(dp=2, tp=2, device="cpu")
placed = M.shard_params_fsdp(model, mesh, min_size=256)
tx = train.build_optimizer(model, train.OptimConfig(**opt))
state = train.create_train_state(model, tx, placed)
step = train.make_mlm_train_step(model, tx, dropout=False, mesh=mesh,
                                 placed=placed)
batch = tuple(torch.from_numpy(data[k]) for k in
              ("ids", "tt", "mask", "feats", "pos", "labels"))
losses = [float(step(state, batch)[1]) for _ in range(2)]
whole = placed.gather()
if pid == 0:
    np.savez("params.npz", **{k: v.numpy() for k, v in whole.items()})
print(json.dumps({"pid": pid, "losses": losses,
                  "pieces": sum(t.numel() for t in placed.locals),
                  "whole": sum(t.numel() for t in whole.values())}), flush=True)
'''


@pytest.mark.parametrize("opt", [
    {}, {"grad_accum_steps": 2, "max_grad_norm": 0.05}])
def test_fsdp_tp_train_step_matches_jax(tmp_path, opt):
    """Two MLM steps at world 4 (dp 2 × tp 2) on FSDP-placed parameters
    (the tp rules with dp grafted on, ``min_size`` 256): each rank's loss
    and the gathered parameters equal JAX's FSDP step on a 2 × 2 mesh,
    with two accumulated micro-steps and the global-norm clip too."""
    jcfg, jparams, _, _ = models()
    opt = dict(learning_rate=1e-3, warmup_steps=1, num_train_steps=5, **opt)
    batch = mlm_batch(3)
    jmodel = JaxRec(jcfg)
    tx = jtrain.build_optimizer(jparams, jtrain.OptimConfig(**opt))
    step = jtrain.make_mlm_train_step(jmodel, tx, dropout=False)
    jm = jmesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    copy = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jparams)
    with jm:
        state = jtrain.create_train_state(
            jmesh.shard_params_fsdp(copy, jm, min_size=256), tx)
        b = jmesh.shard_batch(tuple(jnp.asarray(a) for a in batch), jm)
        want_losses = []
        for _ in range(2):
            state, loss = step(state, b, jax.random.PRNGKey(5))
            want_losses.append(float(loss))
    want = bconv.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        state.params),
                                 models()[2])
    save_case(tmp_path, ids=batch[0].astype(np.int64),
              tt=batch[1].astype(np.int64), mask=batch[2].astype(np.int64),
              feats=batch[3], pos=batch[4].astype(np.int64),
              labels=batch[5].astype(np.int64))
    (tmp_path / "opt.json").write_text(json.dumps(opt))
    ranks = run_group(FSDP, tmp_path, 4)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=TOL, atol=TOL)
        assert r["pieces"] < r["whole"]
    got = np.load(tmp_path / "params.npz")
    moved = 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)
        moved += not np.array_equal(got[name], models()[3][name].numpy())
    assert moved > len(want) // 2


# --- global_batch / process_allgather -------------------------------------------------

GLOBAL = PRELUDE + r'''
from cpt_tpu_torch.engine import train
mesh = M.make_mesh(dp=2, device="cpu")
g = D.global_batch(np.arange(4, dtype=np.float32) + pid * 4, mesh)
total = float(g.full_tensor().sum())
gathered = M.process_allgather({"a": torch.tensor([pid, pid + 1]), "b": 2.5})
lo = slice(pid * 4, pid * 4 + 4)
local = tuple(data[k][lo] for k in ("ids", "tt", "mask", "feats", "pos", "labels"))
batch = tuple(t.full_tensor() for t in D.global_batch(local, mesh))
tx = train.build_optimizer(model, train.OptimConfig(learning_rate=1e-3,
                                                    warmup_steps=1,
                                                    num_train_steps=4))
state = train.create_train_state(model, tx)
step = train.make_mlm_train_step(model, tx, dropout=False, mesh=mesh)
loss = float(step(state, batch)[1])
print(json.dumps({"pid": pid, "total": total, "shape": list(g.shape),
                  "local": g.to_local().tolist(),
                  "a": gathered["a"].tolist(), "b": gathered["b"].tolist(),
                  "loss": loss, "world": D.process_count()}), flush=True)
'''


def test_global_batch_and_process_allgather(tmp_path):
    """The JAX two-process case (``tests/test_distributed.py:50-105``):
    each process's 4-row slice forms one global batch of 8 (sum 28), and
    one MLM step on the slices of a batch of 8 has the loss of JAX's
    step on the whole batch (dropout off); ``process_allgather`` stacks
    one entry a process, and is the identity in a world of one."""
    jcfg, jparams, _, _ = models()
    batch = mlm_batch(0, t=12, r=6, padded=False)
    jmodel = JaxRec(jcfg)
    tx = jtrain.build_optimizer(jparams, jtrain.OptimConfig(
        learning_rate=1e-3, warmup_steps=1, num_train_steps=4))
    state = jtrain.create_train_state(
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jparams), tx)
    _, want = jtrain.make_mlm_train_step(jmodel, tx, dropout=False)(
        state, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1))
    save_case(tmp_path, **dict(zip(("ids", "tt", "mask", "feats", "pos",
                                    "labels"), batch)))
    ranks = run_pair(GLOBAL, tmp_path)
    for r in ranks:
        assert r["total"] == 28.0 and r["shape"] == [8] and r["world"] == 2
        assert r["local"] == [4.0 * r["pid"] + i for i in range(4)]
        assert r["a"] == [[0, 1], [1, 2]] and r["b"] == [2.5, 2.5]
        assert abs(r["loss"] - float(want)) <= TOL * max(1.0, abs(float(want)))
    tree = {"a": np.arange(3)}
    assert mesh.process_allgather(tree) is tree
    assert jmesh.process_allgather(tree) is tree


# --- a mesh needs a world of its size ---------------------------------------------------

@pytest.mark.parametrize("make", ["mesh", "pp_mesh", "tool"])
def test_dp_needs_a_world_of_its_size(make):
    """``--dp 2`` (or any mesh of 2) in a world of one raises SystemExit
    with the launch recipe, before any process group is started."""
    from cpt_tpu_torch.parallel import pipeline
    from cpt_tpu_torch.tools import run_vqa

    call = {"mesh": lambda: mesh.make_mesh(dp=2, device="cpu"),
            "pp_mesh": lambda: pipeline.make_pp_mesh(1, 2, device="cpu"),
            "tool": lambda: run_vqa.main(["--feat_file", "f", "--dp", "2",
                                          "--device", "cpu"])}[make]
    with pytest.raises(SystemExit, match=r"needs 2 processes.*"
                       r"CPT_NUM_PROCESSES=2.*torchrun"):
        call()
    assert not torch.distributed.is_initialized()


def test_mesh_step_takes_the_gradients_of_the_state():
    """Under a mesh without placement ``loss_and_grads`` differentiates
    ``state.params``, as without one: a state that holds a subset of the
    model's parameters gets its own gradients, in its order (here over a
    mesh of one, where the dp average is the identity)."""
    from cpt_tpu_torch.engine import train

    model = port_model()
    named = dict(model.named_parameters())
    subset = [named[n] for n in ("mlm_head.transform.dense.bias",
                                 "bert.embeddings.word_embeddings")]
    state = train.TrainState(params=subset, opt_state=None)
    rng = np.random.RandomState(3)
    batch = (torch.from_numpy(rng.randint(5, 190, (2, 9))),
             torch.zeros(2, 9, dtype=torch.long), torch.ones(2, 13, dtype=torch.long),
             torch.from_numpy(rng.randn(2, 4, 20).astype(np.float32)),
             torch.tensor([3, 4]), torch.tensor([7, 11]))

    def loss_of(b):
        ids, segs, attn, feats, pos, labels = b
        _, at_mask = model(ids, segs, attn, img_feats=feats, mask_pos=pos)
        return train.cross_entropy_ignore_index(at_mask, labels)

    want_loss, want = train.loss_and_grads(model, state, batch, loss_of,
                                           train._labelled)
    try:
        loss, got = train.loss_and_grads(
            model, state, batch, loss_of, train._labelled,
            mesh.make_mesh(dp=1, device="cpu"))
    finally:
        torch.distributed.destroy_process_group()
    assert [g.shape for g in got] == [p.shape for p in subset]
    torch.testing.assert_close(loss, want_loss, rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=TOL, atol=TOL)


# --- sharded extraction paths ------------------------------------------------------------

WINDOWED = r'''
import json
import numpy as np
import torch
from cpt_tpu_torch.engine.extract import Extractor, refcoco_task
from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
from cpt_tpu_torch.parallel import distributed as D, mesh as M
import pickle

assert D.initialize_from_env()
pid = D.process_index()
cfg, task = pickle.load(open("case.pkl", "rb"))
model = AttrRCNN(cfg).eval()
model.load_state_dict(torch.load("sd.pt"), strict=False)
mesh = M.make_mesh(dp=2, device="cpu")
kw = dict(copies_per_chunk=3, windowed=True,
          window=[(128, 144), (96, 112), (112, 128)], halo=32)
ex = Extractor(model, cfg, mesh=mesh, **kw)
feats, labels, scores = ex.extract_task(task)
full = Extractor(model, cfg, copies_per_chunk=3, mesh=mesh).extract_task(task)
np.savez(f"out{pid}.npz", feats=feats, labels=labels, scores=scores,
         full=full[0], full_labels=full[1])
if pid == 0:
    one = Extractor(model, cfg, **kw).extract_task(task)
    one_full = Extractor(model, cfg, copies_per_chunk=3).extract_task(task)
    np.savez("one.npz", feats=one[0], labels=one[1], scores=one[2],
             full=one_full[0], full_labels=one_full[1])
print(json.dumps({"pid": pid, "mode": ex.windowed_mode,
                  "routes": ex.route_copies}), flush=True)
'''


def test_sharded_windowed_and_full_extraction_match_one_process(tmp_path):
    """The windowed Extractor over a dp 2 mesh (``make_sharded_windowed_fn``
    on each rung of the ladder, the full path for the copy that fits
    none; chunks padded to a multiple of dp) and the full path over it
    (``make_sharded_extract_fn``, a chunk of 3 rounded up to 4) against
    the same extractors in one process, on every rank."""
    import pickle

    from test_torch_windowed import _case, _ladder_task

    cfg, _, model, _, _, image, dets = _case((1, 1, 6))
    task = _ladder_task(image, dets)
    torch.save(model.state_dict(), tmp_path / "sd.pt")
    with open(tmp_path / "case.pkl", "wb") as f:
        pickle.dump((cfg, task), f)
    ranks = run_pair(WINDOWED, tmp_path, timeout=240)
    one = np.load(tmp_path / "one.npz")
    for r in ranks:
        assert r["mode"] == "two_level"
        assert r["routes"] == {"96x112": 2, "112x128": 1, "128x144": 1,
                               "full": 1}
        got = np.load(tmp_path / f"out{r['pid']}.npz")
        for k in ("feats", "full"):
            scale = np.abs(one[k]).max()
            assert np.abs(got[k] - one[k]).max() <= 1e-5 * scale, k
        np.testing.assert_array_equal(got["labels"], one["labels"])
        np.testing.assert_array_equal(got["full_labels"], one["full_labels"])


# --- the dry run ----------------------------------------------------------------------------

def test_dryrun_multichip_runs_on_the_cpu():
    """``python -m cpt_tpu_torch.tools.dryrun_multichip 4 --device cpu``:
    four gloo processes, a dp 2 × tp 2 FSDP mesh, two accumulated steps,
    extraction over dp, pipelined scoring on dp 2 × pp 2; one line."""
    import os
    import subprocess
    import sys

    from test_torch_distributed import REPO

    proc = subprocess.run(
        [sys.executable, "-m", "cpt_tpu_torch.tools.dryrun_multichip", "4",
         "--device", "cpu", "--timeout", "200"], capture_output=True, text=True,
        cwd=str(REPO), timeout=260,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()
    assert len(line) == 1 and line[0].startswith(
        "dryrun_multichip ok: mesh={'dp': 2, 'tp': 2}"), proc.stdout
    assert "extract feats (4, " in line[0] and "pp ok (dp2×pp2" in line[0]
