"""The process runtime (``cpt_tpu_torch/parallel/distributed.py``) against
the JAX package's: the single-process identities and ``host_shard``; then
two processes in a gloo group on localhost (each a subprocess with its own
timeout) for ``allreduce_sum`` / ``sync``, for ``extract_features
--shard_by_process`` (the merged shards equal a one-process run's TSV byte
for byte, as ``tests/test_distributed.py`` holds the JAX tool) and for
``refcoco_cpt``'s host-sharded accuracy against one process's.

``multi_process_env`` is the stand-in that the tools' former refusal cases
use: a two-process launch's environment with the runtime's start recorded
instead of made, so that a case runs the tool in one process.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from cpt_tpu.parallel import distributed as jdist
from cpt_tpu_torch.parallel import distributed
from test_torch_watchdog import guards

guard_module, guard_case = guards(300)

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 120


def multi_process_env(monkeypatch) -> list:
    """A two-process launch's environment (``WORLD_SIZE`` 2 and a
    ``MASTER_ADDR``) in which ``initialize_from_env`` records its call and
    starts nothing (the group would wait for a second process): the
    returned list gets one entry a call."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setattr(distributed, "initialize_from_env",
                        lambda: calls.append(True) or True)
    return calls


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(script: str, cwd: Path, timeout: int = WORKER_TIMEOUT_S) -> list:
    """``script`` in two processes of one gloo group (``CPT_COORDINATOR``
    on a free localhost port), each under ``timeout``; → the last JSON line
    each printed, by process id."""
    return run_group(script, cwd, 2, timeout)


def run_group(script: str, cwd: Path, n: int, timeout: int = WORKER_TIMEOUT_S
              ) -> list:
    """``script`` in ``n`` processes of one gloo group, as :func:`run_pair`."""
    path = cwd / "worker.py"
    path.write_text(script)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(path)], cwd=str(cwd), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                 CPT_COORDINATOR=f"127.0.0.1:{port}", CPT_NUM_PROCESSES=str(n),
                 CPT_PROCESS_ID=str(i))) for i in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads([ln for ln in out.splitlines()
                                    if ln.startswith("{")][-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return sorted(outs, key=lambda o: o["pid"])


# --- one process ------------------------------------------------------------------

def test_single_process_identities(monkeypatch):
    for var in ("CPT_COORDINATOR", "CPT_NUM_PROCESSES", "CPT_PROCESS_ID",
                "MASTER_ADDR", "WORLD_SIZE", "RANK", "CPT_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env() is False
    assert not distributed.dist.is_initialized()
    assert (distributed.process_index(), distributed.process_count(),
            distributed.is_main_process()) == (0, 1, True)
    assert distributed.allreduce_sum(1.5, 2) == (1.5, 2)
    distributed.sync("alone")
    # WORLD_SIZE above 1 without a coordinator is one process, as in JAX
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert distributed.initialize_from_env() is jdist.initialize_from_env() is False
    # global_batch named ROADMAP item 9(b) until the meshes were ported: in
    # a world of one, over a mesh of one, the local batch is the global one
    from cpt_tpu_torch.parallel.mesh import make_mesh

    try:
        g = distributed.global_batch({"x": [1, 2]}, make_mesh(dp=1, device="cpu"))
        assert g["x"].full_tensor().tolist() == [1, 2]
        assert distributed.process_count() == 1
    finally:
        distributed.dist.destroy_process_group()


@pytest.mark.parametrize("n,count", [(10, 3), (7, 2), (2, 4), (0, 2), (5, 1)])
def test_host_shard_matches_jax(n, count):
    items = list(range(n))
    for strided in (True, False):
        shards = [distributed.host_shard(items, i, count, strided)
                  for i in range(count)]
        assert shards == [jdist.host_shard(items, i, count, strided)
                          for i in range(count)]
        assert sorted(x for s in shards for x in s) == items
    assert distributed.host_shard(items) == items


def test_local_device_follows_local_rank(monkeypatch):
    monkeypatch.setattr(distributed.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.local_device() == distributed.torch.device("cuda", 0)
    monkeypatch.setattr(distributed.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device().index == 3
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.local_device().index == 0


# --- two processes ------------------------------------------------------------------

COLLECTIVES = r'''
import json
from cpt_tpu_torch.parallel import distributed as D

assert D.initialize_from_env() and D.initialize_from_env()
pid = D.process_index()
assert D.process_count() == 2
total = D.allreduce_sum(float(pid + 1), 10.0, 0.25 * pid)
D.sync("summed")
print(json.dumps({"pid": pid, "total": total, "is_main": D.is_main_process(),
                  "shard": D.host_shard(list(range(9))),
                  "block": D.host_shard(list(range(9)), strided=False)}),
      flush=True)
D.sync("done")
'''


def test_two_processes_allreduce_and_sync(tmp_path):
    outs = run_pair(COLLECTIVES, tmp_path)
    assert outs[0]["total"] == outs[1]["total"] == [3.0, 20.0, 0.25]
    assert outs[0]["is_main"] and not outs[1]["is_main"]
    assert [o["shard"] for o in outs] == [[0, 2, 4, 6, 8], [1, 3, 5, 7]]
    assert [o["block"] for o in outs] == [[0, 1, 2, 3], [4, 5, 6, 7, 8]]


EXTRACT = r'''
import json
from cpt_tpu_torch.parallel import distributed as D
from cpt_tpu_torch.tools import extract_features, merge_shards

flags = ["--tiny", "--synthetic", "5", "--device", "cpu", "--dtype",
         "float32"]
extract_features.main(flags + ["--shard_by_process", "--output", "pred.tsv"])
pid = D.process_index()
D.sync("extracted")
out = {"pid": pid, "count": D.process_count()}
if D.is_main_process():
    merge_shards.main(["--shards", "pred.shard*.tsv", "--output", "merged.tsv"])
    out["merged"] = open("merged.tsv").read()
D.sync("merged")
print(json.dumps(out), flush=True)
'''


def test_two_process_shard_by_process_matches_one_process(tmp_path):
    """Each process extracts its contiguous slice of 5 synthetic queries
    into ``pred.shard<i>.tsv``; the merged shards are byte-identical to one
    process's TSV (same keys, boxes and features, bit for bit)."""
    from cpt_tpu_torch.tools import extract_features

    outs = run_pair(EXTRACT, tmp_path)
    assert [o["count"] for o in outs] == [2, 2]
    shards = [(tmp_path / f"pred.shard{i}.tsv").read_text() for i in (0, 1)]
    assert [s.count("\n") for s in shards] == [2, 3]
    single = tmp_path / "single.tsv"
    extract_features.main(["--tiny", "--synthetic", "5", "--device", "cpu",
                           "--dtype", "float32", "--output", str(single)])
    assert outs[0]["merged"] == single.read_text() == "".join(shards)


REFCOCO = r'''
import json, sys
from cpt_tpu_torch.parallel import distributed as D
from cpt_tpu_torch.tools import refcoco_cpt

acc = refcoco_cpt.main(json.loads(sys.argv[1]) if len(sys.argv) > 1 else
                       json.loads(open("args.json").read()))
print(json.dumps({"pid": D.process_index(), "acc": acc}), flush=True)
'''


def test_two_process_refcoco_cpt_accuracy_matches_one_process(tmp_path):
    """``refcoco_cpt`` zero-shot on 12 queries in two processes: each scores
    its ``host_shard`` and the counts are summed, so both report one
    process's accuracy; each writes its own predictions (``.shard<i>``),
    which together are one process's."""
    from cpt_tpu.data.synthetic import generate_refcoco_fixture
    from cpt_tpu_torch.tools import refcoco_cpt

    p = generate_refcoco_fixture(str(tmp_path / "fx"), n_queries=12,
                                 n_copies=3, n_objects=4, feat_dim=134)
    args = ["--data_file", p["data_file"], "--ann_file", p["ann_file"],
            "--det_file", p["det_file"], "--img_feature_dim", "134",
            "--hidden_size", "32", "--num_hidden_layers", "2",
            "--txt_seq_len", "24", "--img_seq_len", "6",
            "--per_gpu_eval_batch_size", "4", "--dtype", "float32",
            "--device", "cpu", "--seed", "3"]
    (tmp_path / "args.json").write_text(json.dumps(
        args + ["--output", str(tmp_path / "pair.json")]))
    outs = run_pair(REFCOCO, tmp_path)
    want = refcoco_cpt.main(args + ["--output", str(tmp_path / "one.json")])
    assert [o["acc"] for o in outs] == [want, want]
    one = json.loads((tmp_path / "one.json").read_text())["predictions"]
    parts = [json.loads((tmp_path / f"pair.json.shard{i}").read_text())
             for i in (0, 1)]
    assert all(pt["accuracy"] == want for pt in parts)
    merged = {**parts[0]["predictions"], **parts[1]["predictions"]}
    assert len(parts[0]["predictions"]) == 6 and merged == one
