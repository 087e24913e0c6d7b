"""Build, load and dispatch the port's CUDA kernels.

The sources in ``cpt_tpu_torch/csrc/*.cu`` are compiled on first use, one
process per source, all at once,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c <source>.cu

and linked with ``nvcc -shared`` into
``build/cpt_tpu_torch/libcpt_kernels-<hash>.so`` at the repository root
(git ignores it), then loaded with ``ctypes``. The library name carries a
hash of the sources and flags, so an edited source is never served from a
stale build. Every entry point takes its pointers and the stream as
``c_void_p`` and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero status.

Dispatch rule shared by every kernel wrapper (:func:`uses_kernel`): a tensor
on the CPU takes the wrapper's plain PyTorch version; a tensor on a CUDA
device of compute capability (9, 0) takes the kernel; anything else raises.
There is no fallback from a failed build or launch: each raises
:class:`KernelError`, which is not a ``RuntimeError``, so a caller that skips
a batch on ``RuntimeError`` (as ``tools/refcoco_cpt.train`` does) does not
swallow it.

Host code (``cpt_tpu_torch/csrc/*.cpp``: the image codec) is built the same
way by :func:`build_host`, with the host C++ compiler (``$CXX``, else
``c++``) as ``-O2 -shared -fPIC`` into ``libcpt_host-<hash>.so`` beside the
kernel library; it needs no CUDA toolkit, so the CPU runs it too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch


class KernelError(Exception):
    """A kernel could not be built, dispatched or launched."""


CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cpt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
NVCC_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)
SIGNATURES = {
    # x, w, scale, bias, out, N, H, W, C, cpg, stride, relu, stream
    "cpt_grouped_conv3x3": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # K1's tensor-core path: the same arguments
    "cpt_grouped_conv3x3_mma": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # K1q, the int8 grouped conv (CUDA-core path): x, w, scale, bias, out, N,
    # H, W, C, cpg, stride, relu, stream
    "cpt_grouped_conv3x3_int8": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # K1q's tensor-core path: the same arguments
    "cpt_grouped_conv3x3_int8_mma": ([_P] * 5 + [_I] * 7 + [_P], _I),
    # K7, the W8A8 FFN: x, w1q, s1, b1, w2q, s2, b2, gamma, beta, xq, w1t,
    # w2t, h, hq, amax, out, M, H, F, tm, eps, stream
    "cpt_ffn_int8": ([_P] * 16 + [_I] * 4 + [_F, _P], _I),
    # feats, rois, out, B, H, W, C, N, P, spatial_scale, sampling, max_sampling, stream
    "cpt_roi_align": ([_P] * 3 + [_I] * 6 + [_F, _I, _I, _P], _I),
    # a, b, bias, c, M, N, K, act, stream
    "cpt_gemm_bias_act": ([_P] * 4 + [_I] * 4 + [_P], _I),
    # a, b, bias, residual, gamma, beta, out, M, N, K, eps, stream
    "cpt_gemm_bias_residual_ln": ([_P] * 7 + [_I] * 3 + [_F, _P], _I),
    # qkv, key_bias, ctx, B, S, H, num_heads, scale, stream
    "cpt_attention": ([_P] * 3 + [_I] * 4 + [_F, _P], _I),
    # boxes, scores, valid, out_idx, out_keep, scratch, B, K, max_out,
    # one_block, iou_threshold, iou_offset, stream
    "cpt_nms": ([_P] * 6 + [_I] * 4 + [_F, _F, _P], _I),
    # B, K
    "cpt_nms_scratch_bytes": ([_I, _I], ctypes.c_longlong),
    # q, k, v, bias (or NULL), out, m_out, l_out (or NULL), strides[16],
    # B, H, S, D, scale, stream
    "cpt_flash_attention": ([_P] * 7 + [_LL] + [_I] * 4 + [_F, _P], _I),
    # q, k, v, bias (or NULL), dout, m, l, di, dk, dv, strides[25],
    # B, H, S, D, scale, stream
    "cpt_flash_attention_bwd_dkv": ([_P] * 10 + [_LL] + [_I] * 4 + [_F, _P], _I),
    # q, k, v, bias (or NULL), dout, m, l, di, dq, strides[25],
    # B, H, S, D, scale, stream
    "cpt_flash_attention_bwd_dq": ([_P] * 9 + [_LL] + [_I] * 4 + [_F, _P], _I),
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise KernelError("no CUDA toolkit found (nvcc is needed to build "
                          "the cpt_tpu_torch kernels)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NVCC_LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcpt_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of the current sources exists:
    one ``nvcc -c`` per source, all started together, then one link. The
    compilers' output (``-Xptxas=-v``: registers, shared memory and spills
    per kernel) goes to ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    objs, procs, log = [], [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    failed = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{text}")
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelError("nvcc failed " + "\n".join(failed))
    os.replace(tmp, out)
    return out


HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def host_sources() -> list:
    return sorted(CSRC.glob("*.cpp"))


def host_compiler() -> str:
    return os.environ.get("CXX") or "c++"


def host_library_path() -> Path:
    """The library's path, named by a hash of the sources, the flags and
    the compiler's ``--version`` (so that a checkout copied to another
    machine never loads a library built by another compiler)."""
    try:
        version = subprocess.run([host_compiler(), "--version"],
                                 capture_output=True, text=True).stdout
    except OSError as e:
        raise KernelError(f"host compiler {host_compiler()!r} did not run: "
                          f"{e}")
    digest = hashlib.sha256(" ".join((host_compiler(), version) + HOST_FLAGS)
                            .encode())
    for src in host_sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcpt_host-{digest.hexdigest()[:16]}.so"


def build_host() -> Path:
    """Compile the host sources unless a build of them exists: one compiler
    call into a file of this process's own, then ``os.replace``, so that
    processes building at once never load a half-written library."""
    out = host_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [host_compiler(), *HOST_FLAGS, *map(str, host_sources()),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                          f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


class Library:
    """A shared library built (``build_fn``) and loaded at first use, with
    the ctypes signatures ``signatures`` (name → (argtypes, restype))."""

    def __init__(self, build_fn, signatures: dict):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._build = build_fn
        self._signatures = signatures
        self.build_seconds: Optional[float] = None

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                lib = ctypes.CDLL(str(self._build()))
                for name, (argtypes, restype) in self._signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                self.build_seconds = time.perf_counter() - t0
                self._lib = lib
            return self._lib


LIBRARY = Library(build, SIGNATURES)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return LIBRARY.get()


def uses_kernel(t: torch.Tensor) -> bool:
    """False for a CPU tensor (take the plain version), True for a tensor
    on a Hopper card (launch the kernel); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise KernelError(f"cpt_tpu_torch kernels run on CUDA; got {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise KernelError(
            f"cpt_tpu_torch kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} has capability {cap}")
    return True


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Optional[tuple] = None) -> torch.Tensor:
    """Validate a kernel argument; returns it contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t.contiguous()


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a fresh copy where its data is not 16-byte aligned
    (a view at an odd storage offset): the kernels load 16 bytes at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(status: int, name: str) -> None:
    if status != 0:
        raise KernelError(f"{name}: CUDA error {status} at launch")
