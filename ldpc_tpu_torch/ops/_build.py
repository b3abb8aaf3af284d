"""Builds and loads the package's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` source into an object, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, ``build/ldpc_tpu_torch/libldpc_kernels.so`` under
the checkout, at first use and again whenever a source is newer than the
library. The library is loaded with ``ctypes``. A failed build raises with
nvcc's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["ARCH_FLAGS", "CSRC", "LIB_PATH", "NVCC_FLAGS", "build", "load",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
LIB_PATH = _PKG.parent / "build" / "ldpc_tpu_torch" / "libldpc_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _raise_failed(cmd: list[str], code: int, log: str) -> None:
    raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{log}")


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or stale. Returns
    nvcc's log (ptxas register and shared-memory use), or "" when the
    library was already current."""
    srcs = _sources()
    newest = max(p.stat().st_mtime for p in srcs)
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return ""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), os.getpid()
    objs = [LIB_PATH.with_name(f"{src.stem}.{tag}.o") for src in srcs]
    jobs = []
    for src, obj in zip(srcs, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], None
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    try:
        if failed is not None:
            _raise_failed(*failed)
        tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            _raise_failed(cmd, proc.returncode, proc.stdout + proc.stderr)
        os.replace(tmp, LIB_PATH)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ldpc_bp_decode.argtypes = [p, p, p, p, p, p,
                                           i, i, i, i, i, i, p]
            lib.ldpc_bp_decode.restype = i
            lib.ldpc_pdhg_chunk.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                            p, i, i, i, ll, i, i, p]
            lib.ldpc_pdhg_chunk.restype = i
            lib.ldpc_pdhg_chunk_plan.argtypes = [i, i, i,
                                                 ctypes.POINTER(ll)]
            lib.ldpc_pdhg_chunk_plan.restype = i
            lib.ldpc_gemv_fwd.argtypes = [p, p, p, i, i, i, i, p]
            lib.ldpc_gemv_fwd.restype = i
            lib.ldpc_gemv_tr.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         p]
            lib.ldpc_gemv_tr.restype = i
            lib.ldpc_gemv_chunk_rows.argtypes = [i]
            lib.ldpc_gemv_chunk_rows.restype = i
            lib.ldpc_normal_build.argtypes = [p, p, p, p, i, i, i, i,
                                              ctypes.c_float, p]
            lib.ldpc_normal_build.restype = i
            lib.ldpc_chol_diag_inv.argtypes = [p, p, p, i, i, p]
            lib.ldpc_chol_diag_inv.restype = i
            lib.ldpc_chol_factor.argtypes = [p, p, p, i, i, i, p]
            lib.ldpc_chol_factor.restype = i
            lib.ldpc_chol_solve.argtypes = [p, p, p, p, i, i, i, p]
            lib.ldpc_chol_solve.restype = i
            lib.ldpc_chol_fused_max_n.argtypes = []
            lib.ldpc_chol_fused_max_n.restype = i
            lib.ldpc_gf2_gauss.argtypes = [p, p, p, i, i, i, i, i, i, p]
            lib.ldpc_gf2_gauss.restype = i
            f = ctypes.c_float
            lib.ldpc_ipm_prep.argtypes = [p] * 22 + [i, i, i, f, f, i, i, p]
            lib.ldpc_ipm_prep.restype = i
            lib.ldpc_ipm_predict.argtypes = [p] * 24 + [i, i, i, f, f, i, i,
                                                        p]
            lib.ldpc_ipm_predict.restype = i
            lib.ldpc_ipm_correct.argtypes = [p] * 18 + [i, i, i, f, f, f, i,
                                                        i, p]
            lib.ldpc_ipm_correct.restype = i
            lib.ldpc_ipm_empty.argtypes = [i, i, p]
            lib.ldpc_ipm_empty.restype = i
            lib.ldpc_admm_iterate.argtypes = [p] * 17 + [i] * 5 + [f] + [
                i] * 5 + [p]
            lib.ldpc_admm_iterate.restype = i
            for name in ("ldpc_admm_iterate_plan",
                         "ldpc_admm_iterate_occupancy"):
                getattr(lib, name).argtypes = [i, i, i, ctypes.POINTER(i)]
                getattr(lib, name).restype = i
            lib.ldpc_awgn_channel.argtypes = [p, p, ll, p, p, f, f,
                                              ctypes.c_uint, p, p, p, i, i,
                                              p]
            lib.ldpc_awgn_channel.restype = i
            lib.ldpc_smem_optin_limit.argtypes = [i]
            lib.ldpc_smem_optin_limit.restype = i
            lib.ldpc_cuda_error_string.argtypes = [i]
            lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
