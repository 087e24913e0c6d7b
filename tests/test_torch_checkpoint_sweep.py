"""The port's checkpoints, metric loggers and few-shot sweep tools against
the JAX package's on the CPU: ``save_model``'s ``config.json``, a train
state's round trip bit for bit with the ``last_checkpoint`` tag and
``keep_last`` pruning as JAX keeps them, the sweep's template splitting
and filling, ``fewshot_eval``'s report on the same pickles, a
``sweep --task gqa`` over the port's tool, and the meters and loggers of
``utils/metrics``."""
import collections
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpt_tpu.config.bert import OSCAR_BASE as JAX_OSCAR_BASE
from cpt_tpu.config.bert import tiny_bert_config as jax_tiny_bert_config
from cpt_tpu.data.synthetic import generate_gqa_fixture
from cpt_tpu.engine.train import TrainState as JaxTrainState
from cpt_tpu.tools import fewshot_eval as jfewshot_eval
from cpt_tpu.tools import sweep as jsweep
from cpt_tpu.utils import checkpoint as jckpt
from cpt_tpu.utils import metrics as jmetrics
from cpt_tpu_torch.config.bert import OSCAR_BASE, tiny_bert_config
from cpt_tpu_torch.engine import train
from cpt_tpu_torch.engine.evaluate import seed_sweep_report
from cpt_tpu_torch.models.bert.heads import NSPFT
from cpt_tpu_torch.tools import fewshot_eval, sweep
from cpt_tpu_torch.utils import checkpoint as ckpt
from cpt_tpu_torch.utils import convert as bconv
from cpt_tpu_torch.utils import metrics
from test_torch_watchdog import guards

guard_module, guard_case = guards(200)


@pytest.mark.parametrize("which", ["tiny", "oscar_ft"])
def test_save_model_config_json_matches_jax(which, tmp_path):
    """``config.json`` as JAX's ``save_model`` writes it (``to_dict``)."""
    kw = ({} if which == "tiny" else
          dict(num_labels=1842, classifier="mlp", loss_type="kl",
               attention_impl="flash", use_img_layernorm=True))
    if which == "tiny":
        jcfg, cfg = jax_tiny_bert_config(), tiny_bert_config()
    else:
        jcfg = dataclasses.replace(JAX_OSCAR_BASE, **kw)
        cfg = dataclasses.replace(OSCAR_BASE, **kw)
    jckpt.save_model(str(tmp_path / "jax"),
                     {"params": {"w": jnp.arange(6.0).reshape(2, 3)}}, jcfg)
    ckpt.save_model(str(tmp_path / "port"), {"w": torch.arange(6.0)}, cfg)
    texts = [(tmp_path / d / "config.json").read_text() for d in ("jax", "port")]
    assert texts[0] == texts[1] and json.loads(texts[1])["hidden_size"] == (
        cfg.hidden_size)


def _trained_state():
    """A train state after one AdamW step of a tiny NSPFT: parameters,
    moments and counters that are not their init."""
    cfg = tiny_bert_config(vocab_size=64, img_feature_dim=8)
    model = NSPFT(cfg)
    model.init_heads(torch.Generator().manual_seed(0))
    bconv.load_bert_only(model, bconv.random_oscar_state_dict(cfg, seed=1))
    tx = train.build_optimizer(model, train.OptimConfig(warmup_steps=0))
    state = train.create_train_state(model, tx)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, 64, (3, 6)))
    batch = (ids, torch.zeros_like(ids), torch.ones(3, 10, dtype=torch.long),
             torch.from_numpy(rng.randn(3, 4, 8).astype(np.float32)),
             torch.tensor([0, 1, 1]))
    train.make_nsp_train_step(model, tx, dropout=False)(state, batch)
    return model, tx, state


def _equal(a, b):
    """Two states alike in structure, types, dtypes and every bit."""
    if isinstance(a, torch.Tensor):         # a parameter restores as a tensor
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
        return
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


def test_train_state_round_trip_is_bit_exact(tmp_path):
    """A ``TrainState`` (parameters, AdamW moments, counts) and a mixed
    state (a named tuple, numpy, a bf16 tensor, numbers) restore bit for
    bit into a blank target of the same structure; the saved file loads
    with ``weights_only=True``."""
    model, tx, state = _trained_state()
    assert state.step == 1 and state.opt_state.count == 1
    ckpt.save_checkpoint(str(tmp_path), "model_0000001", state)
    blank = train.TrainState(params=[torch.zeros_like(p) for p in state.params],
                             opt_state=tx.init(state.params))
    restored = ckpt.restore_checkpoint(str(tmp_path), blank)
    _equal(restored, state)
    Pair = collections.namedtuple("Pair", "a b")
    mixed = {"pair": Pair(np.arange(5, dtype=np.int64),
                          torch.randn(3, 2).bfloat16()),
             "lr": 2.5e-5, "step": 7, "names": ["x", "y"]}
    ckpt.save_checkpoint(str(tmp_path), "mixed", mixed)
    target = {"pair": Pair(np.zeros(5, np.int64),
                           torch.zeros(3, 2, dtype=torch.bfloat16)),
              "lr": 0.0, "step": 0, "names": ["", ""]}
    _equal(ckpt.restore_checkpoint(str(tmp_path), target), mixed)
    torch.load(tmp_path / "mixed" / ckpt.STATE_FILE, weights_only=True)
    # save_model / load_model: a state dict into a fresh model
    ckpt.save_model(str(tmp_path / "m"), model.state_dict(), model.config)
    fresh = NSPFT(model.config)
    fresh.load_state_dict(ckpt.load_model(str(tmp_path / "m"), fresh.state_dict()))
    _equal(fresh.state_dict(), model.state_dict())


def _jax_state(step):
    return JaxTrainState(params={"a": jnp.arange(4.0) + step,
                                 "b": {"c": jnp.ones((2, 2))}},
                         opt_state={"m": jnp.zeros(3)},
                         step=jnp.asarray(step, jnp.int32))


def test_tag_and_keep_last_match_jax(tmp_path):
    """The same saves in both packages (JAX's own test's sequence, then a
    save that re-points the tag at an older name): the same directories,
    ``last_checkpoint`` names and pruning; a restore without a name follows
    the tag, and one in an empty directory returns the target."""
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    assert ckpt.restore_checkpoint(pd, {"step": 3}) == {"step": 3}
    assert not ckpt.has_checkpoint(pd) and ckpt.last_checkpoint_name(pd) is None
    ops = [("model_0000007", None), ("model_0000008", None),
           ("model_0000009", 2), ("model_0000008", 2), ("model_0000010", 1)]
    for name, keep in ops:
        step = int(name[-2:])
        jckpt.save_checkpoint(jd, name, _jax_state(step), keep_last=keep)
        ckpt.save_checkpoint(pd, name, {"a": torch.arange(4.0) + step,
                                        "step": step}, keep_last=keep)
        assert ckpt.list_checkpoints(pd) == jckpt.list_checkpoints(jd)
        assert ckpt.last_checkpoint_name(pd) == jckpt.last_checkpoint_name(jd) == name
        got = ckpt.restore_checkpoint(pd, {"a": torch.zeros(4), "step": 0})
        want = jckpt.restore_checkpoint(jd, jax.tree_util.tree_map(
            jnp.zeros_like, _jax_state(0)))
        assert got["step"] == int(want.step) == step
        np.testing.assert_array_equal(got["a"].numpy(),
                                      np.asarray(want.params["a"]))
    assert ckpt.list_checkpoints(pd) == ["model_0000010"]
    # an explicit name that the tag does not point at
    jckpt.save_checkpoint(jd, "model_0000011", _jax_state(11))
    ckpt.save_checkpoint(pd, "model_0000011", {"a": torch.zeros(4), "step": 11})
    assert ckpt.restore_checkpoint(pd, {"a": torch.ones(4), "step": 0},
                                   name="model_0000010")["step"] == 10
    assert ckpt.list_checkpoints(pd) == jckpt.list_checkpoints(jd)


SPLIT_CASES = [
    ["--task", "refcoco", "--shots", "1", "2", "--extract", "--", "--n_shot",
     "{shot}", "--stage2", "--", "--seed", "{seed}"],
    ["--results_dir", "x", "--stage2", "--a", "b"],
    ["--stage2", "--", "--x", "{batch}", "--extract", "--y", "{train_tsv}"],
    ["--task", "gqa", "--seeds", "0"],
    ["--extract"],
]


@pytest.mark.parametrize("argv", SPLIT_CASES)
def test_sweep_templates_match_jax(argv):
    assert sweep._split_templates(argv) == jsweep._split_templates(argv)
    mapping = {"shot": 4, "seed": 1, "batch": 4, "train_tsv": "t.tsv"}
    for tpl in jsweep._split_templates(argv):
        if tpl is not None:
            assert sweep._fill(tpl, mapping) == jsweep._fill(tpl, mapping)
    assert vars(sweep.build_args().parse_args(["--results_dir", "r"])) == vars(
        jsweep.build_args().parse_args(["--results_dir", "r"]))


def test_fewshot_eval_matches_jax(tmp_path, capsys):
    """Both packages' ``fewshot_eval`` over the same pickles (a results
    directory, explicit ``--runs``, another metric): the same results and
    the same printed report."""
    rng = np.random.RandomState(3)
    for shot in (1, 4, 16):
        for seed in range(3):
            with open(tmp_path / f"gqa_shot{shot}_seed{seed}.pk", "wb") as f:
                pickle.dump({"accuracy": float(rng.uniform(20, 80)),
                             "miou": float(rng.uniform(0, 1))}, f)
    (tmp_path / "notes.pk").write_bytes(pickle.dumps({"accuracy": 1.0}))
    extra = tmp_path / "extra.pk"
    extra.write_bytes(pickle.dumps({"accuracy": 55.5, "miou": 0.5}))
    for argv in (["--results_dir", str(tmp_path)],
                 ["--results_dir", str(tmp_path), "--runs", f"32:0:{extra}",
                  f"32:1:{extra}"],
                 ["--results_dir", str(tmp_path), "--metric", "miou"]):
        want = jfewshot_eval.main(argv)
        want_out = capsys.readouterr().out
        got = fewshot_eval.main(argv)
        assert got == want and capsys.readouterr().out == want_out
        assert want_out.strip() == seed_sweep_report(got).strip()


def test_gqa_sweep_over_the_port_tool(tmp_path, capsys):
    """``sweep --task gqa`` over shots 1 2 × seeds 0 1 through the port's
    ``gqa_cpt`` on the CPU: one ``gqa_shot{N}_seed{S}.pk`` a run, whose
    ``fewshot_eval`` report is ``seed_sweep_report`` of the returned
    accuracies; ``--resume`` reads them back."""
    paths = generate_gqa_fixture(str(tmp_path / "gqa"), n_questions=10,
                                 feat_dim=24)
    res = tmp_path / "results"
    stage2 = ["--img_feat_file", paths["img_feat_file"],
              "--color_img_feat_file", paths["color_img_feat_file"],
              "--questions", paths["questions"], "--ans2label",
              paths["ans2label"], "--hidden_size", "32",
              "--num_hidden_layers", "1", "--img_feature_dim", "24",
              "--max_seq_length", "16", "--max_img_seq_length", "5",
              "--per_gpu_eval_batch_size", "4", "--dtype", "float32",
              "--device", "cpu", "--num_train_epochs", "1",
              "--n_sample", "{shot}", "--random_seed", "{seed}",
              "--per_gpu_train_batch_size", "{batch}"]
    results = sweep.main(["--task", "gqa", "--shots", "1", "2", "--seeds", "0",
                          "1", "--results_dir", str(res), "--stage2", "--"]
                         + stage2)
    assert sorted(results) == [1, 2] and all(sorted(r) == [0, 1]
                                             for r in results.values())
    for shot in (1, 2):
        for seed in (0, 1):
            with open(res / f"gqa_shot{shot}_seed{seed}.pk", "rb") as f:
                blob = pickle.load(f)
            assert blob == {"accuracy": results[shot][seed], "shot": shot,
                            "seed": seed}
    capsys.readouterr()
    report = fewshot_eval.main(["--results_dir", str(res)])
    assert capsys.readouterr().out.strip() == seed_sweep_report(results).strip()
    assert {k: dict(v) for k, v in report.items()} == results
    cached = sweep.main(["--task", "gqa", "--shots", "2", "--seeds", "1",
                         "--resume", "--results_dir", str(res), "--stage2",
                         "--"] + stage2)
    assert cached == {2: {1: results[2][1]}}


def test_meters_and_loggers_match_jax(tmp_path, monkeypatch):
    """``SmoothedValue``, ``MetricLogger`` (its line with the ETA and lr),
    ``Timer`` and ``JSONLLogger`` on the same series as JAX's; the trace
    context and the environment dump."""
    series = [0.5, 2.0, 1.25, 3.5, 0.75, 4.0] * 5
    pairs = [(m.SmoothedValue(window_size=7), m.MetricLogger(" | "))
             for m in (jmetrics, metrics)]
    for (sv, ml) in pairs:
        for i, v in enumerate(series):
            sv.update(v)
            ml.update(loss=v, time=0.1 * (i % 3 + 1), lr_hint=np.float32(v / 2))
    (jsv, jml), (psv, pml) = pairs
    assert (psv.median, psv.avg, psv.global_avg, psv.count) == (
        jsv.median, jsv.avg, jsv.global_avg, jsv.count)
    assert str(pml) == str(jml)
    assert pml.log_line(30, 1000, lr=2.5e-5) == jml.log_line(30, 1000, lr=2.5e-5)
    assert pml.loss.global_avg == jml.loss.global_avg
    with pytest.raises(AttributeError):
        pml.nothing
    for mod in (jmetrics, metrics):
        clock = iter([10.0, 10.5, 20.0, 21.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        t = mod.Timer()
        t.tic()
        t.toc()
        t.tic()
        assert t.toc(average=False) == 1.5 and t.average_time == 1.0
        assert mod.get_time_str(3725.9) == "1:02:05"
    monkeypatch.undo()
    for mod, name in ((jmetrics, "jax.jsonl"), (metrics, "port.jsonl")):
        log = mod.JSONLLogger(str(tmp_path / "logs" / name))
        log.log(1, loss=0.5, acc=12.5)
        log.log(2, loss=0.25)
        log.close()
    assert ((tmp_path / "logs" / "port.jsonl").read_text()
            == (tmp_path / "logs" / "jax.jsonl").read_text())
    with metrics.TraceContext(str(tmp_path / "trace")):
        torch.ones(4).sum()
    with metrics.TraceContext(None):
        pass
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and "traceEvents" in json.loads(
        (tmp_path / "trace" / traces[0]).read_text())
    info = metrics.collect_env_info()
    assert f"torch: {torch.__version__}" in info and "cuda" in info
