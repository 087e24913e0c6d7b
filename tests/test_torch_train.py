"""Few-shot prompt tuning on the CPU, the port against the JAX trainer in
f32 at tiny sizes: K3/K4 autograd against the JAX custom VJPs (interpret
mode), ``REC_MLM_CPT`` loss and gradients under ``"einsum"`` and
``"flash"``, the schedules, the decay mask, 3 optimizer steps per optimizer
variant against optax, the train batches, dropout, and the
``refcoco_cpt`` tool (training, zero-shot parity, the batch skip)."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.data import refcoco as jrefcoco
from cpt_tpu.data.synthetic import generate_refcoco_fixture
from cpt_tpu.engine import train as jtrain
from cpt_tpu.models.bert.heads import REC_MLM_CPT as JaxRec
from cpt_tpu.ops import fused_attention as jfa
from cpt_tpu.ops import fused_ffn as jff
from cpt_tpu.tools import refcoco_cpt as jtool
from cpt_tpu.utils import convert as jconv
from cpt_tpu.utils import tokenization as jtok
from cpt_tpu_torch.config.bert import tiny_bert_config
from cpt_tpu_torch.data import refcoco
from cpt_tpu_torch.engine import train
from cpt_tpu_torch.kernels.build import KernelError
from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
from cpt_tpu_torch.models.bert.model import BertImgModel, Dropout
from cpt_tpu_torch.ops.fused_attention import fused_attention_block
from cpt_tpu_torch.ops.fused_ffn import fused_ffn
from cpt_tpu_torch.tools import refcoco_cpt
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import tokenization as tok
from test_torch_watchdog import guards, run_interpret

guard_module, guard_case = guards(300)

# a tiny network in f32, gradients against JAX's: summation-order noise
# relative to each tensor's largest gradient
GRAD_RTOL = 1e-4
# 3 optimizer steps on the same gradients in f32 (parameters O(0.1-1))
PARAM_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("block", ["attention", "ffn"])
def test_fused_block_grads_match_jax_vjp(block):
    """K3 and K4 as autograd Functions: the plain forward and autograd
    through the plain version, against ``jax.vjp`` of the JAX blocks (the
    Pallas forward in interpret mode, the reference VJP)."""
    rng = np.random.RandomState(0)
    b, s, h = 2, 20, 128
    r = lambda *sh, sc=1.0: (rng.randn(*sh) * sc).astype(np.float32)
    if block == "attention":
        kb = np.where(rng.rand(b, s) > 0.2, 0.0, -10000.0).astype(np.float32)
        args = [r(b, s, h, sc=0.5), r(h, 3 * h, sc=0.1), r(3 * h, sc=0.02),
                r(h, h, sc=0.05), r(h, sc=0.02), rng.rand(h).astype(np.float32) + 0.5,
                r(h, sc=0.1), kb]
        jfn = lambda *a: jfa.fused_attention_block(*a, 4, 1e-12, 1)
        pfn = lambda *a: fused_attention_block(*a, 4, 1e-12)
        n_diff = 7
    else:
        args = [r(b, s, h, sc=0.5), r(h, 256, sc=0.05), r(256, sc=0.1),
                r(256, h, sc=0.05), r(h, sc=0.1), rng.rand(h).astype(np.float32) + 0.5,
                r(h, sc=0.1)]
        jfn = lambda *a: jff.fused_ffn(*a, 1e-12, False)
        pfn = lambda *a: fused_ffn(*a, 1e-12, False)
        n_diff = 7
    g = r(b, s, h)
    def out_and_grads(g_, *a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp(g_)

    want_out, want = run_interpret(out_and_grads, g, *args)
    leaves = [_t(a).requires_grad_(i < n_diff) for i, a in enumerate(args)]
    out = pfn(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves[:n_diff], _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=3e-5)
    for i, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(), err_msg=str(i))


@pytest.fixture(scope="module")
def train_case():
    """A tiny REC_MLM_CPT per package from one reference-layout state dict,
    and a batch with padded slots (label −1)."""
    rng = np.random.RandomState(3)
    n, t, r = 4, 12, 5
    ids = rng.randint(1, 160, (n, t)).astype(np.int32)
    seg = (rng.rand(n, t) > 0.5).astype(np.int32)
    mask = np.ones((n, t + r), np.int32)
    mask[1, 9:] = 0
    mask[2, t + 2:] = 0
    feats = rng.randn(n, r, 20).astype(np.float32)
    pos = np.asarray([3, 0, 7, 5], np.int32)
    labels = np.asarray([11, 42, -1, 7], np.int32)
    return ids, seg, mask, feats, pos, labels


def _configs(**kw):
    kw = dict(vocab_size=160, img_feature_dim=20, **kw)
    jcfg, cfg = jax_tiny_bert_config(**kw), tiny_bert_config(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _models(attention_impl, seed=7):
    jcfg, cfg = _configs(attention_impl=attention_impl)
    sd = jconv.random_oscar_state_dict(jcfg, seed=seed)
    jparams = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    port = REC_MLM_CPT(cfg, torch.float32)
    port.load_state_dict(bconv.state_from_reference(sd, cfg))
    return JaxRec(jcfg, dtype=jnp.float32), jparams, port


@pytest.mark.parametrize("attention_impl", ["einsum", "flash"])
def test_rec_mlm_cpt_loss_and_grads_match_jax(train_case, attention_impl):
    """The loss at [MASK] (the JAX step's loss_fn, dropout off) and every
    parameter's gradient; the pooler gets none in either package."""
    jmodel, jparams, port = _models(attention_impl)
    ids, seg, mask, feats, pos, labels = train_case

    def loss_fn(params):
        _, at_mask = jmodel.apply(params, *map(jnp.asarray, (ids, seg, mask)),
                                  img_feats=jnp.asarray(feats),
                                  mask_pos=jnp.asarray(pos), deterministic=True)
        from cpt_tpu.models.bert.heads import cross_entropy_ignore_index
        return cross_entropy_ignore_index(at_mask, jnp.asarray(labels))

    want_loss, want_grads = run_interpret(jax.value_and_grad(loss_fn), jparams)
    want = bconv.params_from_jax(want_grads, port.config)
    port.eval()
    _, at_mask = port(*map(_t, (ids, seg, mask)), img_feats=_t(feats),
                      mask_pos=_t(pos))
    from cpt_tpu_torch.models.bert.heads import cross_entropy_ignore_index
    loss = cross_entropy_ignore_index(at_mask, _t(labels))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()), allow_unused=True)
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-5
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        if g is None:
            assert name.startswith("bert.pooler.") and not w.any(), name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(w).max(), 1e-8),
                                   err_msg=name)


def test_masked_lm_labels_loss_matches_jax(train_case):
    """``masked_lm_labels`` (full-sequence CE, −1 ignored) and
    ``scatter_mlm_labels`` against the JAX model and engine."""
    jmodel, jparams, port = _models("auto", seed=2)
    ids, seg, mask, feats, pos, labels = train_case
    s = mask.shape[1]            # text and region slots
    jl = jtrain.scatter_mlm_labels(jnp.asarray(labels), jnp.asarray(pos), s)
    pl_ = train.scatter_mlm_labels(_t(labels), _t(pos), s)
    np.testing.assert_array_equal(pl_.numpy(), np.asarray(jl))
    want, _ = jmodel.apply(jparams, *map(jnp.asarray, (ids, seg, mask)),
                           img_feats=jnp.asarray(feats), masked_lm_labels=jl)
    with torch.inference_mode():
        got, logits = port.eval()(*map(_t, (ids, seg, mask)), img_feats=_t(feats),
                                  masked_lm_labels=pl_)
    assert logits.shape == (4, s, 160)
    assert abs(float(got) - float(want)) < 1e-5


def test_schedules_equal_jax():
    for kw in (dict(warmup_steps=3, num_train_steps=17),
               dict(warmup_steps=0, num_train_steps=5, learning_rate=2.5e-5),
               dict(warmup_steps=4, num_train_steps=9, scheduler="constant")):
        for mul in (1.0, 10.0):
            jcfg, cfg = jtrain.OptimConfig(**kw), train.OptimConfig(**kw)
            js, ps = jtrain.make_lr_schedule(jcfg, mul), train.make_lr_schedule(cfg, mul)
            for step in range(22):
                assert np.float32(js(step)) == ps(step), (kw, mul, step)


def test_decay_mask_is_optax_mask_through_params_from_jax():
    """The no-decay rule on each port parameter is the JAX rule on its path
    in the JAX tree: attention.bqkv / bo (JAX qkv/out bias) and every
    LayerNorm are not decayed."""
    jcfg, cfg = _configs()
    tree = jconv.params_for_task(jconv.convert_bert_state_dict(
        jconv.random_oscar_state_dict(jcfg, seed=0), jcfg), "rec_mlm_cpt")
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    decayed = jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(leaf), not jtrain._is_no_decay(
            tuple(getattr(k, "key", str(k)) for k in path)))
        for path, leaf in flat])
    want = {k: bool(v.all()) for k, v in bconv.params_from_jax(decayed, cfg).items()}
    model = REC_MLM_CPT(cfg)
    tx = train.build_optimizer(model, train.OptimConfig())
    got = dict(zip([n for n, _ in model.named_parameters()], tx.decay))
    assert got == want
    assert not got["bert.encoder.layer.0.attention.bqkv"]
    assert got["bert.encoder.layer.0.attention.wqkv"]


OPTIMIZERS = {
    "adamw": (dict(), None),
    "adamax": (dict(optim="adamax"), None),
    # one real step, at schedule step 0: no warmup, so that it moves
    "accum2": (dict(grad_accum_steps=2, warmup_steps=0), None),
    "clip": (dict(max_grad_norm=0.5), None),
    "freeze": (dict(), "word_embeddings"),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_optimizer_steps_match_optax(name):
    """The same three gradient sets (zero for the pooler, which the MLM
    loss does not reach) through optax's chain and the port's optimizer."""
    kw, frozen = OPTIMIZERS[name]
    jcfg, cfg = _configs()
    sd = jconv.random_oscar_state_dict(jcfg, seed=4)
    params = {"params": jconv.params_for_task(
        jconv.convert_bert_state_dict(sd, jcfg), "rec_mlm_cpt")}
    ocfg = dict(learning_rate=1e-2, weight_decay=0.05, warmup_steps=1,
                num_train_steps=6)
    ocfg.update(kw)
    rng = np.random.RandomState(9)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.randn(*np.shape(a)) * 0.1).astype(np.float32), params)
        for _ in range(3)]
    for g in grads:
        g["params"]["bert"]["pooler"] = jax.tree_util.tree_map(
            np.zeros_like, g["params"]["bert"]["pooler"])
    tx = jtrain.build_optimizer(params, jtrain.OptimConfig(**ocfg))
    if frozen:
        tx = jtrain.freeze_params(tx, frozen)
    state = jtrain.create_train_state(params, tx)
    for g in grads:
        upd, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                             state.opt_state, state.params)
        state = jtrain.TrainState(optax.apply_updates(state.params, upd), opt,
                                  state.step + 1)
    want = bconv.params_from_jax(state.params, cfg)

    model = REC_MLM_CPT(cfg)
    model.load_state_dict(bconv.state_from_reference(sd, cfg))
    names = [n for n, _ in model.named_parameters()]
    ptx = train.build_optimizer(model, train.OptimConfig(**ocfg))
    if frozen:
        ptx = train.freeze_params(ptx, frozen)
        assert [n for n, f in zip(names, ptx.frozen) if f] == [
            "bert.embeddings.word_embeddings"]
    pstate = train.create_train_state(model, ptx)
    for g in grads:
        pg = bconv.params_from_jax(g, cfg)
        ptx.update([None if n.startswith("bert.pooler.") else pg[n] for n in names],
                   pstate.opt_state, pstate.params)
    moved = 0
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        moved += not torch.equal(p.detach(), bconv.state_from_reference(sd, cfg)[n])
    # all but the pooler's bias (no gradient, no decay) and a frozen table
    assert moved == len(names) - 1 - (1 if frozen else 0)


@pytest.fixture(scope="module")
def fixture_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("refcoco_train")
    return generate_refcoco_fixture(str(root), n_queries=6, n_copies=3,
                                    n_objects=4, feat_dim=134)


def test_train_batches_match_jax(fixture_paths):
    p = fixture_paths
    jdata = jrefcoco.RefcocoCPTData(p["data_file"], p["ann_file"], p["det_file"],
                                    jtok.BertTokenizer(jtok.toy_vocab()), 24, 6, 134)
    data = refcoco.RefcocoCPTData(p["data_file"], p["ann_file"], p["det_file"],
                                  tok.BertTokenizer(tok.toy_vocab()), 24, 6, 134)
    assert data.none_id == jdata.none_id
    for i in range(len(data)):
        assert data.example(i).gt_color_ids == jdata.example(i).gt_color_ids
    for seed in (0, 5):
        want = list(jrefcoco.iter_train_batches(jdata, 4, seed, num_epochs=2))
        got = list(refcoco.iter_train_batches(data, 4, seed, num_epochs=2))
        assert len(got) == len(want) > 2
        for g, w in zip(got, want):
            assert g.slot_meta == w.slot_meta
            np.testing.assert_array_equal(g.labels, w.labels)
            for f in ("input_ids", "segment_ids", "attention_mask", "img_feats",
                      "mask_pos"):
                np.testing.assert_array_equal(getattr(g.tensors, f),
                                              getattr(w.tensors, f))


def test_dropout_rate_scale_and_generator():
    drop = Dropout(0.1).train()
    x = torch.ones(200_000)
    out = drop(x, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert torch.equal(out, drop(x, torch.Generator().manual_seed(0)))
    assert not torch.equal(out, drop(x, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="Generator"):
        drop(x, None)
    assert drop.eval()(x, None) is x


def test_train_step_dropout_draws_from_the_generator(train_case):
    """With dropout the step's loss depends only on the generator's seed;
    without it the step is deterministic and ignores the generator."""
    ids, seg, mask, feats, pos, labels = train_case
    batch = tuple(map(_t, (ids, seg, mask, feats, pos, labels)))
    cfg = tiny_bert_config(vocab_size=160, img_feature_dim=20,
                           hidden_dropout_prob=0.3)
    sd = bconv.state_from_reference(bconv.random_oscar_state_dict(cfg, 1), cfg)

    def first_loss(dropout, seed):
        model = REC_MLM_CPT(cfg)
        model.load_state_dict(sd)
        tx = train.build_optimizer(model, train.OptimConfig())
        step = train.make_mlm_train_step(model, tx, dropout=dropout)
        _, loss = step(train.create_train_state(model, tx), batch,
                       torch.Generator().manual_seed(seed))
        return float(loss)

    assert first_loss(True, 0) == first_loss(True, 0) != first_loss(True, 1)
    assert first_loss(False, 0) == first_loss(False, 1)


def _tool_args(p, device_args=True):
    args = ["--data_file", p["data_file"], "--ann_file", p["ann_file"],
            "--det_file", p["det_file"], "--img_feature_dim", "134",
            "--hidden_size", "32", "--num_hidden_layers", "2",
            "--txt_seq_len", "24", "--img_seq_len", "6",
            "--per_gpu_eval_batch_size", "8", "--dtype", "float32"]
    return args + (["--device", "cpu"] if device_args else [])


def test_tool_zero_shot_matches_jax(fixture_paths, tmp_path):
    """The same Oscar-layout ``--checkpoint`` into both tools: the same
    accuracy and the same predicted box for every query."""
    jcfg = jtool.model_config(jtool.build_args().parse_args(
        _tool_args(fixture_paths, False)))
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save({k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jcfg, seed=5).items()}, ckpt)
    common = ["--checkpoint", str(ckpt)]
    want = jtool.main(_tool_args(fixture_paths, False) + common
                      + ["--output", str(tmp_path / "jax.json")])
    got = refcoco_cpt.main(_tool_args(fixture_paths) + common
                           + ["--output", str(tmp_path / "port.json")])
    assert got == want
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(f)["predictions"] == json.load(g)["predictions"]


def test_tool_trains_then_evaluates(fixture_paths, monkeypatch):
    losses = []
    real_train = refcoco_cpt.train

    def spy(*a, **kw):
        losses.extend(real_train(*a, **kw))
        return losses

    monkeypatch.setattr(refcoco_cpt, "train", spy)
    acc = refcoco_cpt.main(_tool_args(fixture_paths) + [
        "--train_data_file", fixture_paths["data_file"],
        "--num_train_epochs", "3", "--per_gpu_train_batch_size", "4"])
    assert 0.0 <= acc <= 100.0
    assert len(losses) == 9 and all(np.isfinite(losses))


DP_TOOL = r'''
import functools
import json
import sys
from cpt_tpu_torch.engine import train as train_lib
from cpt_tpu_torch.parallel import distributed as D
from cpt_tpu_torch.tools import refcoco_cpt

train_lib.make_mlm_train_step = functools.partial(train_lib.make_mlm_train_step,
                                                  dropout=False)
losses = []
real_train = refcoco_cpt.train
refcoco_cpt.train = lambda *a, **kw: losses.extend(real_train(*a, **kw))
acc = refcoco_cpt.main(json.load(open("argv.json")))
print(json.dumps({"pid": D.process_index(), "acc": acc, "losses": losses}),
      flush=True)
'''


def test_tool_data_parallel_matches_jax(fixture_paths, tmp_path, monkeypatch):
    """``--dp 2`` named ROADMAP item 9(b) until the meshes were ported: two
    processes, one rank each, now train 3 epochs of batch 4 (2 a rank,
    gradients averaged, dropout off) and evaluate batches of 8 split over
    them, against the JAX tool's ``--dp 2`` on the same checkpoint: the
    same accuracy and predicted boxes (rank 0 writes them); both ranks
    report the whole batches' losses, those of the one-process run."""
    from test_torch_distributed import run_pair

    jcfg = jtool.model_config(jtool.build_args().parse_args(
        _tool_args(fixture_paths, False)))
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save({k: torch.from_numpy(v) for k, v in
                jconv.random_oscar_state_dict(jcfg, seed=5).items()}, ckpt)
    common = ["--checkpoint", str(ckpt), "--train_data_file",
              fixture_paths["data_file"], "--num_train_epochs", "3",
              "--per_gpu_train_batch_size", "4", "--learning_rate", "1e-3"]
    monkeypatch.setattr(jtrain, "make_mlm_train_step", functools.partial(
        jtrain.make_mlm_train_step, dropout=False))
    want = jtool.main(_tool_args(fixture_paths, False) + common
                      + ["--dp", "2", "--output", str(tmp_path / "jax.json")])
    (tmp_path / "argv.json").write_text(json.dumps(
        _tool_args(fixture_paths) + common
        + ["--dp", "2", "--output", str(tmp_path / "port.json")]))
    ranks = run_pair(DP_TOOL, tmp_path)
    assert [r["acc"] for r in ranks] == [want] * 2
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(f)["predictions"] == json.load(g)["predictions"]
    losses = []
    real_train = refcoco_cpt.train
    monkeypatch.setattr(train, "make_mlm_train_step", functools.partial(
        train.make_mlm_train_step, dropout=False))
    monkeypatch.setattr(refcoco_cpt, "train", lambda *a, **kw: losses.extend(
        real_train(*a, **kw)))
    refcoco_cpt.main(_tool_args(fixture_paths) + common)
    assert len(losses) == 9
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fault", [RuntimeError, KernelError, "bias_grad"])
def test_batch_skip_does_not_swallow_kernel_faults(fixture_paths, monkeypatch,
                                                   fault):
    """``refcoco_cpt.train`` skips a batch that raises RuntimeError (as the
    reference does); a kernel fault is not a RuntimeError and ends the run.
    ``bias_grad``: a real step under ``attention_impl="flash"`` whose
    attention bias needs a gradient reaches ``flash_mha``'s gate, which
    must stop the tool instead of letting it skip every batch."""
    argv = _tool_args(fixture_paths) + [
        "--train_data_file", fixture_paths["data_file"],
        "--num_train_epochs", "1", "--per_gpu_train_batch_size", "4"]
    if fault == "bias_grad":
        config = refcoco_cpt.model_config
        embed = BertImgModel.embed

        def leaf_bias(self, *a, **kw):
            emb, bias = embed(self, *a, **kw)
            return emb, bias.detach().requires_grad_(self.training)

        monkeypatch.setattr(refcoco_cpt, "model_config", lambda args: dataclasses.replace(
            config(args), attention_impl="flash", attention_probs_dropout_prob=0.0))
        monkeypatch.setattr(BertImgModel, "embed", leaf_bias)
        with pytest.raises(KernelError, match="bias gradient"):
            refcoco_cpt.main(argv)
        return

    def failing_step(*a, **kw):
        def step(*args):
            raise fault("injected")
        return step

    monkeypatch.setattr(refcoco_cpt.train_lib, "make_mlm_train_step", failing_step)
    if fault is KernelError:
        with pytest.raises(KernelError, match="injected"):
            refcoco_cpt.main(argv)
    else:
        assert 0.0 <= refcoco_cpt.main(argv) <= 100.0
