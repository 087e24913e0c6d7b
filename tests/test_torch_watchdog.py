"""Guards for the port's CPU parity tests, and their own tests.

``guards(limit_s)`` gives a test module two autouse fixtures:

* a watchdog. Each case (and the module's own fixtures, which the first
  case sets up) gets ``limit_s`` seconds. A case that outlives them has
  every thread's stack written to the process's real standard error (not
  pytest's captured output) by ``faulthandler``, and its process ends with
  exit code 1. Under pytest-xdist the run goes on: the master prints
  ``[gwN] node down``, reports ``worker 'gwN' crashed while running
  '<test id>'`` among the failures, starts a new worker and runs the rest
  of the file. xdist queues the crashed case again; a marker file left in
  the run's temporary root makes that second run fail at once, naming the
  case, instead of hanging again. ``signal.alarm`` could not do this: it
  cannot interrupt a thread stuck in C code, such as an XLA compile or an
  OpenMP barrier.
* a cap of TORCH_THREADS on torch's intra-op threads for the module (the
  old value is restored after it): the modules run JAX and torch in one
  process, and several such processes run at once, each with two thread
  pools as wide as the host.

Set ``limit_s`` to at least 10× the module's slowest case in a full run on
the CPU, and never under 120 s. Work that several cases share goes into a
cached function that the cases call (its first caller's watchdog covers
it), not into a module fixture that a later case sets up.

``run_interpret(fn, *args)`` runs JAX code that reaches a Pallas TPU kernel
in TPU interpret mode as one jitted call and brings its outputs to the
host before anything else is dispatched. The interpreter serves a kernel
through ``io_callback``s that dispatch JAX work of their own; a caller that
keeps dispatching eager work meanwhile can deadlock with them (one case
hung so in about 1 of 10 runs on 8 busy cores, its main thread at an eager
op after the kernel, a callback waiting on an array). Every interpret-mode
call of the port's tests goes through it.
"""
import faulthandler
import hashlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

MIN_LIMIT_S = 120
TORCH_THREADS = 4
_STDERR = []


def _real_stderr(config):
    """A file on standard error as it was before pytest captured it (the
    stream an xdist worker shares with the master), opened once."""
    if not _STDERR:
        capman = config.pluginmanager.getplugin("capturemanager")
        if capman is None:
            _STDERR.append(sys.stderr)
        else:
            with capman.global_and_fixture_disabled():
                _STDERR.append(os.fdopen(os.dup(sys.stderr.fileno()), "w"))
    return _STDERR[0]


def guards(limit_s: float):
    """(module fixture, case fixture): assign both in a test module, e.g.
    ``guard_module, guard_case = guards(300)``."""
    if limit_s < MIN_LIMIT_S:
        raise ValueError(f"a watchdog limit under {MIN_LIMIT_S} s")

    @pytest.fixture(scope="module", autouse=True, name="guard_module")
    def guard_module(request):
        old = torch.get_num_threads()
        torch.set_num_threads(min(TORCH_THREADS, old))
        faulthandler.dump_traceback_later(limit_s, exit=True,
                                          file=_real_stderr(request.config))
        yield
        faulthandler.cancel_dump_traceback_later()
        torch.set_num_threads(old)

    @pytest.fixture(autouse=True, name="guard_case")
    def guard_case(request, guard_module, tmp_path_factory):
        root = tmp_path_factory.getbasetemp()
        if hasattr(request.config, "workerinput"):   # xdist: popen-gwN's parent
            root = root.parent
        nodeid = request.node.nodeid
        marker = root / (hashlib.sha1(nodeid.encode()).hexdigest()[:16]
                         + ".running")
        if marker.exists():
            pytest.fail(f"{nodeid}: its worker ended while running it (hung "
                        f"past the {limit_s} s watchdog, whose stacks are in "
                        f"the log, or crashed); not run again", pytrace=False)
        marker.write_text(nodeid)
        faulthandler.dump_traceback_later(limit_s, exit=True,
                                          file=_real_stderr(request.config))
        yield
        faulthandler.cancel_dump_traceback_later()
        marker.unlink()

    return guard_module, guard_case


def run_interpret(fn, *args):
    """``fn(*args)`` in TPU interpret mode, jitted, as numpy arrays."""
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(fn)(*args)
        return jax.tree_util.tree_map(np.asarray, out)


guard_module, guard_case = guards(120)


def test_threads_are_capped_and_restored():
    assert torch.get_num_threads() <= TORCH_THREADS


def test_a_hung_case_is_named_and_the_run_goes_on(tmp_path):
    """A case that sleeps past a 2 s limit under xdist: the worker dies
    with the stacks in the log, the case is named among the failures, its
    second run fails at once, and the next case of the file passes."""
    (tmp_path / "test_hang.py").write_text(textwrap.dedent("""
        import time
        import test_torch_watchdog

        test_torch_watchdog.MIN_LIMIT_S = 0
        guard_module, guard_case = test_torch_watchdog.guards(2)

        def test_hangs():
            time.sleep(60)

        def test_after():
            assert True
    """))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).parent), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "xdist", "-n", "1", "--dist", "loadfile", "-p", "no:randomly",
         "--noconftest", str(tmp_path / "test_hang.py")],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=100)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    assert "Timeout (0:00:02)!" in out and "test_hangs" in out, out
    assert out.count("Timeout (0:00:02)!") == 1, out
    assert "crashed while running 'test_hang.py::test_hangs'" in out, out
    assert "its worker ended while running it" in out, out
    assert "1 passed" in out, out
