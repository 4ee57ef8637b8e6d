"""Build and bind the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library per source, each with a plain C
interface, and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. Libraries land in ``_build/`` beside this file (listed
in ``.gitignore``), named by a hash of their sources and flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is
built at import: the first launch builds what it needs, and
``build()`` builds every library at once, one ``nvcc`` per source, all
started together (``--split-compile=0`` lets each one optimize its
kernels on every core: the two flash sources hold 18 kernels each).

Every C entry point returns the ``cudaGetLastError()`` of its launch;
``check`` turns a non-zero code into an exception.

Kernels that load tiles by TMA (``csrc/hopper.cuh``: B14's bf16 wgmma
kernel) encode their tensor maps on the host at each call with the
driver's ``cuTensorMapEncodeTiled``, which they reach through the CUDA
runtime's driver entry point (``cudaGetDriverEntryPointByVersion``, or
``cudaGetDriverEntryPoint`` before CUDA 12.5): no library links against
``libcuda``, so the flags below carry no ``-lcuda``. A driver without the
entry point makes such a launch return ``cudaErrorNotSupported`` (801).
``wgmma`` needs the ``sm_90a`` target.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["build", "lib", "check", "dtype_code", "weight_code", "ptr",
           "stream_ptr", "sm_count", "SOURCES", "BUILD_DIR"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention", "stream_linear", "flash_varlen",
           "paged_attention_q", "stream_linear_a8w8", "grouped_gemm",
           "flash_attention", "flash_varlen_packed", "paged_backends")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
#: C signatures, by library
_SIGNATURES = {
    "paged_attention": {
        # q, new_k, new_v, k_pool, v_pool, seq_lens, block_tables, out,
        # ws, dtype, b, n_q, n_kv, d, page_size, pages_per_seq, pool_base,
        # pool_pages, n_split, scale, stream
        "ptt_paged_decode_attention":
            [_P] * 9 + [_I] * 10 + [_F, _P],
    },
    "stream_linear": {
        # x, w, w_dt, scale, scale_dt, bias, bias_dt, residual,
        # residual_dt, out, out_dt, dtype, M, K, N, activation, ws,
        # counters, split, steps, stream
        "ptt_stream_linear":
            [_P, _P, _I] + [_P, _I] * 4 + [_I] * 5 + [_P, _P, _I, _I, _P],
        # x, x_dt, scale, scale_dt, bias, bias_dt, out, out_dt, M, D,
        # eps, stream
        "ptt_layer_norm":
            [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _F, _P],
    },
    "flash_varlen": {
        # q, k_pool, v_pool, block_tables, start, out, ws, dtype, b, c,
        # n_q, n_kv, d, page_size, pages_per_seq, num_pages, n_split,
        # scale, stream
        "ptt_paged_prefill_attention": [_P] * 7 + [_I] * 10 + [_F, _P],
    },
    "paged_attention_q": {
        # q, new_k, new_v, kq_pool, ks_plane, vq_pool, vs_plane,
        # seq_lens, block_tables, out, ws, dtype, b, n_q, n_kv, d,
        # page_size, pages_per_seq, pool_base, pool_pages, plane_cols,
        # n_split, scale, stream
        "ptt_paged_decode_attention_q": [_P] * 11 + [_I] * 11 + [_F, _P],
    },
    "stream_linear_a8w8": {
        # x_q, x_scale, w, w_scale, bias, bias_dt, out, out_dt, M, K, N,
        # activation, ws, counters, split, steps, stream
        "ptt_stream_linear_a8w8":
            [_P] * 5 + [_I, _P] + [_I] * 5 + [_P, _P, _I, _I, _P],
    },
    "grouped_gemm": {
        # x, w, bias, bias_dt, offsets, out, out_dt, dtype, T, K, N, E,
        # bm, activation, trans_w, stream
        "ptt_grouped_gemm": [_P] * 3 + [_I] + [_P] * 2 + [_I] * 9 + [_P],
        # x, dz, offsets, out, out_dt, dtype, T, K, N, E, stream
        "ptt_grouped_dw": [_P] * 4 + [_I] * 6 + [_P],
        # offsets, E, K, N, tiles, stream
        "ptt_grouped_dw_tiles": [_P] + [_I] * 3 + [_P] * 2,
        # x, x_dt, a, a_dt, b, b_dt, offsets, out, out_dt, T, K, N, S, R,
        # bm, stream
        "ptt_lora_delta": [_P, _I] * 3 + [_P] * 2 + [_I] * 7 + [_P],
        # offsets, E, nm, bm, gids, tids, lo, hi, stream
        "ptt_grouped_work_map": [_P] + [_I] * 3 + [_P] * 5,
    },
    "flash_attention": {
        # q, k, v, out, lse, dtype, b, sq, sk, h, d, the (batch, seq,
        # head) strides of q, k and v, causal, scale, stream
        "ptt_flash_fwd": [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I, _F, _P],
        # q, k, v, dout, lse, di, dq, dtype, b, sq, sk, h, d, strides,
        # causal, scale, stream
        "ptt_flash_bwd_dq":
            [_P] * 7 + [_I] * 6 + [_L] * 9 + [_I, _F, _P],
        # q, k, v, dout, lse, di, dk, dv, dtype, b, sq, sk, h, d,
        # strides, causal, scale, stream
        "ptt_flash_bwd_dkv":
            [_P] * 8 + [_I] * 6 + [_L] * 9 + [_I, _F, _P],
    },
    "flash_varlen_packed": {
        # q, k, v, out, lse, the 11 block-map arrays, dtype, tq, tk,
        # tq_pad, tk_pad, h, d, the (row, head) strides of q, k and v,
        # causal, scale, stream
        "ptt_flash_varlen_fwd":
            [_P] * 16 + [_I] * 7 + [_L] * 6 + [_I, _F, _P],
        # q, k, v, dout, lse, delta, dq, map, shape as above
        "ptt_flash_varlen_bwd_dq":
            [_P] * 18 + [_I] * 7 + [_L] * 6 + [_I, _F, _P],
        # q, k, v, dout, lse, delta, dk, dv, map, shape as above
        "ptt_flash_varlen_bwd_dkv":
            [_P] * 19 + [_I] * 7 + [_L] * 6 + [_I, _F, _P],
    },
    "paged_backends": {
        # q, k_pool, v_pool, seq_lens, membership, ws_ml, ws_acc, out,
        # dtype, b, n_q, n_kv, d, page_size, pool_base, pool_pages,
        # blocks, chunks_per_block, run_pages, scale, stream
        "ptt_paged_stream": [_P] * 8 + [_I] * 11 + [_F, _P],
        # q, k_pool, v_pool, seq_lens, block_tables, out, dtype, b, n_q,
        # n_kv, d, page_size, pages_per_seq, num_pages, ws, n_split,
        # scale, stream
        "ptt_paged_fused": [_P] * 6 + [_I] * 8 + [_P, _I, _F, _P],
        # as ptt_paged_fused, with pages_per_compute_block after num_pages
        "ptt_paged_pallas": [_P] * 6 + [_I] * 9 + [_P, _I, _F, _P],
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
#: the code of int8 weights (csrc/common.cuh kI8)
INT8_CODE = 2


def dtype_code(t: torch.Tensor, what: str) -> int:
    """Code of a float operand (float32 or bfloat16)."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        "CUDA kernel (float32 or bfloat16)")
    return code


def weight_code(t: torch.Tensor, what: str) -> int:
    """Code of a weight operand: a float dtype, or int8."""
    return INT8_CODE if t.dtype == torch.int8 else dtype_code(t, what)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, which the wrappers size their
    grids by (read once a device: the query takes microseconds)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
