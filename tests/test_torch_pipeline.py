"""The pipeline (``cpt_tpu_torch/parallel/pipeline.py``) against the JAX
package's GPipe program (``cpt_tpu/parallel/pipeline.py``) at a tiny f32
config: the port's stages are gloo processes on localhost (one a stage and
dp row), the JAX program runs on the 8 virtual CPU devices. The encoder's
output (2e-5) and its stacked-parameter gradients (2e-4) at (dp, pp,
n_micro) = (1, 2, 2), (1, 4, 4) and (2, 2, 4), and the pipelined scoring
forward (2e-5), the tolerances of ``tests/test_pipeline.py``."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.models.bert.model import extend_attention_mask
from cpt_tpu.parallel import pipeline as jpipe
from cpt_tpu.utils import convert as jconv
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.parallel import pipeline
from cpt_tpu_torch.utils import convert as bconv
from test_torch_distributed import run_group
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

CFG = dict(vocab_size=128, hidden_size=64, num_attention_heads=4,
           intermediate_size=128, num_hidden_layers=4, img_feature_dim=16)
B, S = 8, 10
OUT_TOL = 2e-5
GRAD_TOL = 2e-4

WORKER = r'''
import json
import numpy as np
import torch
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.bert.model import extend_attention_mask
from cpt_tpu_torch.parallel import distributed as D, pipeline

assert D.initialize_from_env()
pid = D.process_index()
case = json.load(open("case.json"))
cfg = tiny_bert_config(**case["cfg"])
model = REC_MLM_CPT(cfg, torch.float32).eval()
model.load_state_dict(torch.load("sd.pt"))
data = {k: torch.from_numpy(v) for k, v in np.load("data.npz").items()}
mesh = pipeline.make_pp_mesh(case["dp"], case["pp"], device="cpu")
stage = pipeline.pipelined_stage(model, mesh)
out = {}
if case["mode"] == "encoder":
    for t in stage.values():
        t.requires_grad_(True)
    bias = extend_attention_mask(data["mask"], torch.float32)
    fn = pipeline.make_pp_encoder_fn(cfg, mesh, case["n_micro"])
    seq = fn(stage, data["hidden"], bias)
    grads = torch.autograd.grad((seq ** 2).sum(), list(stage.values()))
    out["out"] = seq.detach().numpy()
    out.update({"grad." + n: g.numpy() for n, g in zip(stage, grads)})
else:
    fn = pipeline.make_pp_scoring_fn(cfg, mesh, case["n_micro"])
    with torch.inference_mode():
        out["out"] = fn(model, stage, data["ids"], data["tt"], data["mask"],
                        data["feats"], data["mask_pos"]).numpy()
np.savez(f"out{pid}.npz", **out)
print(json.dumps({"pid": pid, "stage": mesh.get_local_rank("pp"),
                  "row": mesh.get_local_rank("dp")}), flush=True)
'''


@functools.lru_cache(maxsize=None)
def models():
    """(JAX config, JAX params, the port's state dict) of one reference
    state dict."""
    jcfg = jax_tiny_bert_config(**CFG)
    sd = jconv.random_oscar_state_dict(jcfg, seed=0)
    jparams = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    return jcfg, jparams, bconv.state_from_reference(sd, tiny_bert_config(**CFG))


def run_workers(tmp_path, mode, dp, pp, n_micro, data):
    torch.save(models()[2], tmp_path / "sd.pt")
    np.savez(tmp_path / "data.npz", **data)
    (tmp_path / "case.json").write_text(json.dumps(
        {"cfg": CFG, "mode": mode, "dp": dp, "pp": pp, "n_micro": n_micro}))
    ranks = run_group(WORKER, tmp_path, dp * pp, timeout=240)
    return ranks, [dict(np.load(tmp_path / f"out{r['pid']}.npz"))
                   for r in ranks]


def port_encoder_grads(jgrads_stacked):
    """JAX ``[L, ...]`` gradients of the stacked layers → the port's
    stacked names and layouts (through ``utils/convert``'s name map)."""
    jcfg, jparams, _ = models()
    L = jcfg.num_hidden_layers
    tree = jax.tree_util.tree_map(np.asarray, jparams["params"])
    tree["bert"]["encoder"] = jpipe.unstack_layer_params(
        jax.tree_util.tree_map(np.asarray, jgrads_stacked), L)
    flat = bconv.params_from_jax(tree, tiny_bert_config(**CFG))
    enc = {k[len("bert.encoder."):]: v for k, v in flat.items()
           if k.startswith("bert.encoder.")}
    return {n: t.numpy() for n, t in pipeline.stack_layer_params(enc, L).items()}


@pytest.mark.parametrize("dp,pp,n_micro", [(1, 2, 2), (1, 4, 4), (2, 2, 4)])
def test_pp_encoder_matches_jax(tmp_path, dp, pp, n_micro):
    """Every rank returns the whole batch's encoder output, equal to JAX's
    pipelined program's; each stage's gradients of ``sum(out²)`` equal
    JAX's for its layers (summed over dp, as a replicated JAX leaf's)."""
    jcfg, jparams, _ = models()
    rng = np.random.RandomState(0)
    hidden = rng.randn(B, S, CFG["hidden_size"]).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[:, -2:] = 0
    bias = extend_attention_mask(jnp.asarray(mask), jnp.float32)
    L = jcfg.num_hidden_layers
    stacked = jpipe.stack_layer_params(jparams["params"]["bert"]["encoder"], L)
    mesh = jpipe.make_pp_mesh(dp, pp, devices=jax.devices()[:dp * pp])
    fn = jpipe.make_pp_encoder_fn(jcfg, mesh, n_micro)

    def loss(st):
        with mesh:
            return jnp.sum(fn(st, jnp.asarray(hidden), bias) ** 2)

    with mesh:
        want = np.asarray(jax.jit(fn)(stacked, jnp.asarray(hidden), bias))
    want_grads = port_encoder_grads(jax.jit(jax.grad(loss))(stacked))

    ranks, outs = run_workers(tmp_path, "encoder", dp, pp, n_micro,
                              {"hidden": hidden, "mask": mask})
    k = L // pp
    for r, o in zip(ranks, outs):
        np.testing.assert_allclose(o["out"], want, rtol=OUT_TOL, atol=OUT_TOL)
        s = r["stage"]
        for name, g in want_grads.items():
            np.testing.assert_allclose(o["grad." + name], g[s * k:(s + 1) * k],
                                       rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"rank {r['pid']} {name}")


def test_pp_scoring_matches_jax(tmp_path):
    """Pipelined REC_MLM_CPT scoring (dp 2 × pp 2, 2 micro-batches) against
    JAX's ``make_pp_scoring_fn`` on every rank."""
    jcfg, jparams, _ = models()
    rng = np.random.RandomState(1)
    txt, img = 8, 4
    data = {"ids": rng.randint(0, CFG["vocab_size"], (B, txt)).astype(np.int64),
            "tt": np.zeros((B, txt), np.int64),
            "mask": np.ones((B, txt + img), np.int64),
            "feats": rng.randn(B, img, CFG["img_feature_dim"]).astype(np.float32),
            "mask_pos": np.full((B,), 3, np.int64)}
    data["mask"][:3, -2:] = 0
    mesh = jpipe.make_pp_mesh(2, 2, devices=jax.devices()[:4])
    stacked = jpipe.stack_layer_params(
        jparams["params"]["bert"]["encoder"], jcfg.num_hidden_layers)
    fn = jpipe.make_pp_scoring_fn(jcfg, mesh, n_micro=2)
    with mesh:
        want = np.asarray(fn(jparams, stacked, *(
            jnp.asarray(data[k], jnp.int32 if data[k].dtype == np.int64
                        else jnp.float32)
            for k in ("ids", "tt", "mask", "feats", "mask_pos"))))
    _, want_seq = JaxRec(jcfg).apply(
        jparams, jnp.asarray(data["ids"], jnp.int32),
        jnp.asarray(data["tt"], jnp.int32), jnp.asarray(data["mask"], jnp.int32),
        jnp.asarray(data["feats"]),
        mask_pos=jnp.asarray(data["mask_pos"], jnp.int32))
    np.testing.assert_allclose(want, np.asarray(want_seq), rtol=OUT_TOL,
                               atol=OUT_TOL)
    _, outs = run_workers(tmp_path, "scoring", 2, 2, 2, data)
    for o in outs:
        np.testing.assert_allclose(o["out"], want, rtol=OUT_TOL, atol=OUT_TOL)


def test_stack_roundtrip_and_specs():
    """``unstack_layer_params`` inverts ``stack_layer_params`` over the
    port's encoder state dict; every stacked leaf is ``P("pp")``."""
    _, _, sd = models()
    enc = {k[len("bert.encoder."):]: v for k, v in sd.items()
           if k.startswith("bert.encoder.")}
    stacked = pipeline.stack_layer_params(enc, CFG["num_hidden_layers"])
    assert all(t.shape[0] == CFG["num_hidden_layers"] for t in stacked.values())
    back = pipeline.unstack_layer_params(stacked, CFG["num_hidden_layers"])
    assert back.keys() == enc.keys()
    assert all(torch.equal(back[k], enc[k]) for k in enc)
    assert set(pipeline.stacked_specs(stacked).values()) == {pipeline.P("pp")}
