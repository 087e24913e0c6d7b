"""Timers, smoothed meters and the training metric logger (port of
``cpt_tpu/utils/metrics.py``).

Parity with reference ``maskrcnn_benchmark/utils/{timer,metric_logger}.py``
and Oscar's ``utils/metric_logger.py``: wall-clock ``Timer``, windowed
``SmoothedValue``, ``MetricLogger`` with ETA formatting, the ``JSONLLogger``
structured log, a ``torch.profiler`` trace context (host and CUDA
activity, written as a Chrome trace) and the environment dump.
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        return self.average_time if average else self.diff

    @property
    def average_time(self) -> float:
        return self.total_time / self.calls if self.calls > 0 else 0.0


def get_time_str(seconds: float) -> str:
    return str(datetime.timedelta(seconds=int(seconds)))


class SmoothedValue:
    """Track a series and report the median/avg over a sliding window."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())

    def log_line(self, iteration: int, max_iter: int,
                 lr: Optional[float] = None) -> str:
        eta = ""
        if "time" in self.meters and max_iter:
            eta_seconds = self.meters["time"].global_avg * (max_iter - iteration)
            eta = f"eta: {get_time_str(eta_seconds)}  "
        lr_s = f"  lr: {lr:.6f}" if lr is not None else ""
        return f"{eta}iter: {iteration}/{max_iter}  {self}{lr_s}"


class JSONLLogger:
    """Structured metrics log (the reference's optional TensorboardLogger
    counterpart, dependency-free): one json object per update, suitable for
    plotting or the ``eval_logs.json`` convention (``gqa_cpt.py:520-524``)."""

    def __init__(self, path: str):
        import os

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._fh = open(path, "a")

    def log(self, step: int, **metrics):
        import json

        self._fh.write(json.dumps({"step": step, **metrics}) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


class TraceContext:
    """``with TraceContext("/tmp/traces"):`` records a ``torch.profiler``
    trace of the block (CPU, and CUDA where a card is present) and writes
    it as a Chrome trace under ``log_dir``; ``log_dir=None`` does
    nothing."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.profiler = None

    def __enter__(self):
        if self.log_dir:
            import os

            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.log_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=acts)
            self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        if self.profiler is not None:
            import os

            self.profiler.__exit__(*exc)
            self.profiler.export_chrome_trace(os.path.join(
                self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
            self.profiler = None
        return False


def collect_env_info() -> str:
    """Startup environment dump (the reference's ``collect_env_info()``
    call at ``test_refcoco_net.py:180-181``): torch, CUDA and the card."""
    import platform

    import torch

    lines = [f"python: {platform.python_version()}",
             f"torch: {torch.__version__}",
             f"cuda: {torch.version.cuda}",
             f"cuda available: {torch.cuda.is_available()}"]
    if torch.cuda.is_available():
        lines.append(f"device_count: {torch.cuda.device_count()}")
        for i in range(torch.cuda.device_count()):
            cap = torch.cuda.get_device_capability(i)
            lines.append(f"device {i}: {torch.cuda.get_device_name(i)} "
                         f"(capability {cap[0]}.{cap[1]})")
    import numpy

    lines.append(f"numpy: {numpy.__version__}")
    return "\n".join(lines)
