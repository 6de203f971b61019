"""ctypes bindings of the port's native host library (native.cpp).

The counterpart of bigclam_tpu/graph/native/__init__.py: the same four
functions with the same argument types — `parse_edge_list`,
`triangle_counts`, `triangle_counts_capped` and `select_seeds_covering` —
over this package's own copy of native.cpp.

The library is built at first use, never at import: `g++ -O3 -std=c++17
-fPIC -fopenmp -shared` (the JAX Makefile's flags) compiles native.cpp
with the first compiler that takes them — `$CXX`, then g++ on PATH (an
installation's `$CXX` may lack OpenMP) — into `bigclam_tpu_torch/_build/`, named by a
hash of the source and the flags, so a changed source builds a new
library and an unchanged one loads at once. Each build writes a temporary
file of its own and `os.replace`s it into place, so processes that build
at the same time all end with a whole library, and no library another
process may have loaded is ever deleted.

Callers (graph.ingest, ops.seeding) take the native function first and
their numpy path when the library is unavailable (NativeUnavailableError):
a host without g++ runs slower, not differently. `status()` says whether
the library loaded, and why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp", "-shared")
BUILD_TIMEOUT_S = 120


class NativeUnavailableError(ImportError):
    """The native library could not be built or loaded (the reason is the
    message); callers fall back to their numpy path."""


_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


def compilers() -> list:
    """The C++ compilers to try, in order: `$CXX`, then g++ on PATH."""
    found = [c for c in (os.environ.get("CXX"), shutil.which("g++")) if c]
    if not found:
        raise NativeUnavailableError("g++ not found on PATH (and $CXX unset)")
    return list(dict.fromkeys(found))


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbigclam_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native.cpp into library_path() unless it is there; returns
    the path. Raises NativeUnavailableError when no compiler is found or
    every one refuses the source."""
    final = library_path()
    if final.exists():
        return final
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".native-", suffix=".so")
    os.close(fd)
    try:
        refused = []
        for cxx in compilers():
            try:
                r = subprocess.run(
                    [cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                    capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
                )
            except OSError as e:
                refused.append(f"{cxx}: {e}")
                continue
            if r.returncode == 0:
                break
            refused.append(f"{cxx} refused {SOURCE.name} (rc {r.returncode}): "
                           f"{r.stderr.strip()}")
        else:
            raise NativeUnavailableError("; ".join(refused))
        os.replace(tmp, final)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailableError(f"cannot build {SOURCE.name}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return final


def _register(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature."""
    P64, P32 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
    I64 = ctypes.c_int64
    lib.bc_parse_edge_list.restype = P64
    lib.bc_parse_edge_list.argtypes = [ctypes.c_char_p, P64]
    lib.bc_free.restype = None
    lib.bc_free.argtypes = [ctypes.c_void_p]
    lib.bc_triangle_counts.restype = None
    lib.bc_triangle_counts.argtypes = [P64, P32, I64, P64]
    lib.bc_triangle_counts_capped.restype = None
    lib.bc_triangle_counts_capped.argtypes = [
        P64, P32, I64, I64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_double),
    ]
    lib.bc_select_seeds_covering.restype = I64
    lib.bc_select_seeds_covering.argtypes = [
        P64, P32, I64, P64, I64, I64, I64, I64, P64,
    ]
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed. A failure is remembered:
    later calls raise the same NativeUnavailableError without rebuilding."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise NativeUnavailableError(_ERROR)
    try:
        path = build()
        _LIB = _register(ctypes.CDLL(str(path)))
    except NativeUnavailableError as e:
        _ERROR = str(e)
        raise
    except (OSError, AttributeError) as e:
        _ERROR = f"cannot load the native library: {e}"
        raise NativeUnavailableError(_ERROR) from e
    return _LIB


def status() -> dict:
    """{"loaded": bool, "path": the library or None, "reason": why it did
    not load or None}; builds the library if it is not there yet."""
    try:
        library()
    except NativeUnavailableError as e:
        return {"loaded": False, "path": None, "reason": str(e)}
    return {"loaded": True, "path": str(library_path()), "reason": None}


def _csr(g):
    indptr = np.ascontiguousarray(g.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(g.indices, dtype=np.int32)
    return (indptr, indices,
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))


def parse_edge_list(path: str) -> np.ndarray:
    """Parse a SNAP edge-list file into an (M, 2) int64 array."""
    lib = library()
    n_pairs = ctypes.c_int64(0)
    ptr = lib.bc_parse_edge_list(str(path).encode(), ctypes.byref(n_pairs))
    if not ptr:
        if n_pairs.value == -1:
            raise ValueError(
                f"{path}: malformed edge list: expected an even number of "
                "integers (odd or non-integer tokens)"
            )
        raise OSError(f"{path}: cannot read")
    try:
        m = n_pairs.value
        out = (np.ctypeslib.as_array(ptr, shape=(m, 2)).copy() if m
               else np.empty((0, 2), np.int64))
    finally:
        lib.bc_free(ptr)
    return out


def triangle_counts(g) -> np.ndarray:
    """tri(u) = #edges among N(u) via the OpenMP two-hop pass."""
    lib = library()
    indptr, indices, p_ptr, p_ind = _csr(g)
    out = np.zeros(g.num_nodes, dtype=np.int64)
    lib.bc_triangle_counts(
        p_ptr, p_ind, ctypes.c_int64(g.num_nodes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def triangle_counts_capped(g, cap: int, seed: int = 0) -> np.ndarray:
    """Degree-capped tri(u) estimator (O(n*cap^2); exact when cap >= max
    degree). Semantics: ops.seeding.triangle_counts_sampled."""
    lib = library()
    indptr, indices, p_ptr, p_ind = _csr(g)
    out = np.zeros(g.num_nodes, dtype=np.float64)
    lib.bc_triangle_counts_capped(
        p_ptr, p_ind, ctypes.c_int64(g.num_nodes), ctypes.c_int64(int(cap)),
        ctypes.c_uint64(int(seed) & (2**64 - 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def select_seeds_covering(
    g, order: np.ndarray, k: int, hops: int, cap: int
) -> np.ndarray:
    """Greedy covering walk over the prepared candidate `order`, seed for
    seed the choices of ops.seeding._covering_walk_numpy."""
    lib = library()
    indptr, indices, p_ptr, p_ind = _csr(g)
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(max(int(k), 1), dtype=np.int64)
    cnt = lib.bc_select_seeds_covering(
        p_ptr, p_ind, ctypes.c_int64(g.num_nodes),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(order.size), ctypes.c_int64(int(k)),
        ctypes.c_int64(int(hops)), ctypes.c_int64(int(cap)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out[:cnt].copy()
