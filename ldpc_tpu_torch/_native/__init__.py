"""ctypes bindings of the native host core, ``ldpc_host.cpp`` (counterpart
of ``ldpc_tpu/_native``): bit-packed GF(2) elimination and the cascaded
ADMM/LP structure builder.

``g++ -O3 -shared -fPIC -std=c++17`` compiles ``ldpc_host.cpp`` into
``build/ldpc_tpu_torch/libldpc_host.so`` under the checkout, beside the
kernels' library, at first use and again whenever the source is newer than
the library. The compiler writes a file tagged with its process and thread,
which ``os.replace`` then puts in place, so processes that build at once
leave one whole library. A failed build raises with g++'s output; nothing
falls back. Setting ``LDPC_TPU_NO_NATIVE`` (the JAX package's switch) is the
one way onto the NumPy bodies of ``codes.gf2`` and ``decoders.admm``: then
``load`` and every function below return None.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["GXX_FLAGS", "LIB_PATH", "SRC", "admm_build", "build", "disabled",
           "gf2_matmul", "gxx_path", "load", "nullspace", "rank"]

SRC = Path(__file__).resolve().with_name("ldpc_host.cpp")
LIB_PATH = SRC.parents[2] / "build" / "ldpc_tpu_torch" / "libldpc_host.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None


def disabled() -> bool:
    """True when ``LDPC_TPU_NO_NATIVE`` selects the NumPy path."""
    return bool(os.environ.get("LDPC_TPU_NO_NATIVE"))


def gxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native host core needs a C++ "
                           "compiler (or set LDPC_TPU_NO_NATIVE)")
    return found


def build(force: bool = False, src: str | Path = SRC,
          lib: str | Path = LIB_PATH) -> str:
    """Compile ``src`` into ``lib`` if the library is missing or older than
    the source. Returns g++'s output, or "" when the library was current."""
    src, lib = Path(src), Path(lib)
    if not force and lib.exists() and (lib.stat().st_mtime
                                       >= src.stat().st_mtime):
        return ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = [gxx_path(), *GXX_FLAGS, str(src), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return proc.stdout + proc.stderr


def load():
    """The host library with its C signatures set, built on first use; None
    when ``LDPC_TPU_NO_NATIVE`` is set."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i = ctypes.c_int
            lib.ldpc_gf2_nullspace.restype = i
            lib.ldpc_gf2_nullspace.argtypes = [u8p, i, i, u8p]
            lib.ldpc_gf2_rank.restype = i
            lib.ldpc_gf2_rank.argtypes = [u8p, i, i]
            lib.ldpc_gf2_matmul.restype = None
            lib.ldpc_gf2_matmul.argtypes = [u8p, u8p, u8p, i, i, i]
            lib.ldpc_admm_build.restype = i
            lib.ldpc_admm_build.argtypes = [
                u8p, i, i, i, i, i, i32p, f32p, f32p, i32p, f32p, f32p,
                ctypes.POINTER(i)]
            _lib = lib
        return _lib


def nullspace(h: np.ndarray):
    """The reference's ``GetOrtogonal`` on 0/1 ``h``: ``(G, ok)`` as
    ``codes.gf2.gf2_nullspace`` returns it; None when n <= m or the library
    is switched off."""
    h = np.ascontiguousarray(h, dtype=np.uint8)
    m, n = h.shape
    lib = load() if n > m else None
    if lib is None:
        return None
    g = np.zeros((n - m, n), np.uint8)
    ok = lib.ldpc_gf2_nullspace(h, m, n, g)
    return (g if ok else None), bool(ok)


def rank(h: np.ndarray):
    """GF(2) rank of 0/1 ``h``; None when the library is switched off."""
    lib = load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, dtype=np.uint8)
    return int(lib.ldpc_gf2_rank(h, h.shape[0], h.shape[1]))


def gf2_matmul(a: np.ndarray, b: np.ndarray):
    """GF(2) product of 0/1 matrices; None when the library is switched
    off."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    c = np.zeros((a.shape[0], b.shape[1]), np.uint8)
    lib.ldpc_gf2_matmul(a, b, c, a.shape[0], a.shape[1], b.shape[1])
    return c


def admm_build(h: np.ndarray, nv_cap: int, nc_cap: int, k_cap: int):
    """The cascade's tables of 0/1 ``h`` padded to the capacities, as
    ``decoders.admm.ADMMStructure`` holds them, plus ``n_var`` and
    ``n_con``; None when a capacity is too small or the library is
    switched off."""
    lib = load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, np.uint8)
    m, n = h.shape
    con_var = np.empty((nc_cap, 3), np.int32)
    con_coef = np.empty((nc_cap, 3), np.float32)
    b = np.empty((nc_cap,), np.float32)
    var_con = np.empty((nv_cap, k_cap), np.int32)
    var_coef = np.empty((nv_cap, k_cap), np.float32)
    e = np.empty((nv_cap,), np.float32)
    n_var = ctypes.c_int(0)
    n_con = lib.ldpc_admm_build(h, m, n, nv_cap, nc_cap, k_cap, con_var,
                                con_coef, b, var_con, var_coef, e,
                                ctypes.byref(n_var))
    if n_con < 0:
        return None
    return {"con_var": con_var, "con_coef": con_coef, "b": b,
            "var_con": var_con, "var_coef": var_coef, "e": e,
            "n_var": int(n_var.value), "n_con": int(n_con)}
