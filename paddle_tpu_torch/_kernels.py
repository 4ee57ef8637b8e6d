"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library per source, each with a plain C
interface, and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. Libraries land in ``_build/`` beside this file (listed
in ``.gitignore``), named by a hash of their sources and flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is
built at import: the first launch builds what it needs, and
``build()`` builds every library at once, one ``nvcc`` per source, all
started together.

Every C entry point returns the ``cudaGetLastError()`` of its launch;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["build", "lib", "check", "dtype_code", "ptr", "stream_ptr",
           "SOURCES", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention", "stream_linear")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures, by library
_SIGNATURES = {
    "paged_attention": {
        # q, new_k, new_v, k_pool, v_pool, seq_lens, block_tables, out,
        # dtype, b, n_q, n_kv, d, page_size, pages_per_seq, pool_base,
        # pool_pages, scale, stream
        "ptt_paged_decode_attention":
            [_P] * 8 + [_I] * 9 + [_F, _P],
    },
    "stream_linear": {
        # x, w, bias, bias_dt, residual, residual_dt, out, out_dt,
        # dtype, M, K, N, activation, stream
        "ptt_stream_linear":
            [_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
        # x, x_dt, scale, scale_dt, bias, bias_dt, out, out_dt, M, D,
        # eps, stream
        "ptt_layer_norm":
            [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _F, _P],
    },
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of paddle_tpu_torch are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, ptxas_verbose: bool = False) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all in parallel. Returns ``{name: {"seconds":
    s, "log": compiler stderr}}`` for the sources compiled now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                   else []),
               "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True),
                      tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0,
                      "log": stdout + stderr}
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with every
    entry point's ``argtypes``/``restype`` declared."""
    with _LOCK:
        handle = _LIBS.get(name)
        if handle is None:
            build([name])
            handle = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = handle
    return handle


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with "
                           f"cudaError {code}")


#: kernel dtype codes shared with csrc/common.cuh
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        "CUDA kernel (float32 or bfloat16)")
    return code


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
