"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` (with the shared `csrc/*.cuh` headers) is compiled
by `nvcc` for Hopper (`sm_90a`) into an object, one nvcc per source, all
started together; the objects are linked into one shared library with a
plain C interface, loaded with `ctypes`. The library lands in
`bigclam_tpu_torch/_build/`, named by a hash of the sources and flags, so
a changed source rebuilds and an unchanged tree loads at once. It is built
at first use; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

SOURCES = (
    "fused_superstep", "grad_llh", "candidates",
    "edge_dots_kb", "grad_from_x", "cand_dots_kb", "cand_from_x",
    "member_lookup", "candidate_edge_terms",
    "ring_grad_phase", "ring_cand_phase",
)

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",                # registers / spills into the build log
)
LINK_FLAGS = (*ARCH, "-shared")

# ctypes argument types of the C entries: every pointer and the stream as
# c_void_p (a plain int would be cut to 32 bits)
P, I, L, R = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ENTRIES = {
    # F, F_dst, sumF, indptr, indices, n, K, etas, coefs, num_s, omp_lo,
    # omp_hi, min_f, max_f, F_new, grad, node_llh, ok, smem_bytes, stream
    "bigclam_fused_superstep": [P, P, P, P, P, I, I, P, P, I, R, R, R, R, P, P, P, P, I, P],
    # F, F_dst, sumF, indptr, indices, n, K, omp_lo, omp_hi, grad, node_llh,
    # stream
    "bigclam_grad_llh": [P, P, P, P, P, I, I, R, R, P, P, P],
    # F, F_dst, grad, sumF, indptr, indices, n, K, etas, num_s, omp_lo,
    # omp_hi, min_f, max_f, cand, smem_bytes, stream
    "bigclam_candidates": [P, P, P, P, P, P, I, I, P, I, R, R, R, R, P, I, P],
    # F_loc, F_rot, indptr, indices, order (null: all rows), m, n, K, omp_lo,
    # omp_hi, gn, ln, stream
    "bigclam_ring_grad_phase": [P, P, P, P, P, I, I, I, R, R, P, P, P],
    # F_loc, grad, F_rot, indptr, indices, n, K, etas, num_s, omp_lo, omp_hi,
    # min_f, max_f, cb, smem_bytes, stream
    "bigclam_ring_cand_phase": [P, P, P, P, P, I, I, P, I, R, R, R, R, P, I, P],
    # F, indptr, indices, rev, n, k_pad, col0, kc, x, stream
    "bigclam_edge_dots_kb": [P, P, P, P, I, I, I, I, P, P],
    # x, F, sumF, indptr, indices, n, k_pad, col0, kc, omp_lo, omp_hi, fold,
    # grad_kb, ld_grad, llh_nbr (null: not written), stream
    "bigclam_grad_from_x": [P, P, P, P, P, I, I, I, I, R, R, I, P, I, P, P],
    # F, grad_kb, ld_grad, indptr, indices, n, E, k_pad, col0, kc, etas,
    # num_s, omp_lo, omp_hi, min_f, max_f, xc, smem_bytes, stream
    "bigclam_cand_dots_kb": [P, P, I, P, P, I, L, I, I, I, P, I, R, R, R, R, P, I, P],
    # xc, indptr, n, E, num_s, omp_lo, omp_hi, out, stream
    "bigclam_cand_from_x": [P, P, I, L, I, R, R, P, P],
    # xc, E, indptr, F, sumF, grad, llh_nbr, n, K, etas, coefs, num_s,
    # omp_lo, omp_hi, min_f, max_f, F_new, node_llh, ok, stream
    "bigclam_cand_select_from_x": [P, L, P, P, P, P, P, I, I, P, P, I, R, R, R, R,
                                   P, P, P, P],
    # F, sumF, grad, node_llh, cand_nbr, n, K, etas, coefs, num_s, min_f,
    # max_f, F_new, ok, stream
    "bigclam_armijo_select": [P, P, P, P, P, I, I, P, P, I, R, R, P, P, P],
    # ids, w, src, dst, E, M, k_pad, out, stream
    "bigclam_member_lookup": [P, P, P, P, L, I, I, P, P],
    # F, grad, src, dst, runs, n_runs, E, K, etas, num_s, omp_lo, omp_hi,
    # min_f, max_f, out, smem_bytes, stream
    "bigclam_candidate_edge_terms": [P, P, P, P, P, L, L, I, P, I, R, R, R, R, P, I, P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch was refused."""


def nvcc_path() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels build only where the CUDA toolkit is "
        "installed"
    )


def source_hash(csrc: Path = CSRC_DIR) -> str:
    h = hashlib.sha256()
    paths = [csrc / f"{n}.cu" for n in SOURCES] + sorted(csrc.glob("*.cuh"))
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(csrc: Path = CSRC_DIR) -> Path:
    return BUILD_DIR / f"libbigclam-{source_hash(csrc)}.so"


def build(csrc: Path = CSRC_DIR) -> dict:
    """Build the kernel library of the sources in `csrc` (default: this
    package's) unless it is there: one nvcc per source, all started
    together, then one link. Returns {"seconds", "cached", "logs", "path"}
    ("logs" holds each source's ptxas register and spill report). Raises
    KernelBuildError naming every failed source."""
    final = library_path(csrc)
    if final.exists():
        return {"seconds": 0.0, "cached": True, "logs": {}, "path": final}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="work-"))
    try:
        procs = {
            name: subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-I", str(csrc), "-c",
                 "-o", str(work / f"{name}.o"), str(csrc / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name in SOURCES
        }
        logs, failed = {}, []
        for name, proc in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{logs[name]}")
        if failed:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(work / "lib.so"),
             *(str(work / f"{name}.o") for name in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise KernelBuildError(
                f"kernel link failed (nvcc rc {link.returncode}):\n{link.stdout}"
            )
        os.replace(work / "lib.so", final)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"seconds": time.perf_counter() - t0, "cached": False, "logs": logs,
            "path": final}


_LIBRARY: Optional[ctypes.CDLL] = None


def bind(path: Path, require_all: bool = True) -> ctypes.CDLL:
    """The kernel library at `path`, loaded with every C entry of ENTRIES
    bound (argtypes set, int cudaError_t return) and
    `bigclam_error_string(int)`. With require_all=False an entry the
    library lacks (another tree's build, say) is left unbound instead of
    raising AttributeError."""
    lib = ctypes.CDLL(str(path))
    lib.bigclam_error_string.argtypes = [I]
    lib.bigclam_error_string.restype = ctypes.c_char_p
    for entry, argtypes in ENTRIES.items():
        if not require_all and not hasattr(lib, entry):
            continue
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = I
    return lib


def load_library() -> ctypes.CDLL:
    """This package's kernel library, built first if needed, and bound;
    the build (or the load of a library already built) is a `compile`
    event of the run telemetry."""
    global _LIBRARY
    if _LIBRARY is None:
        from bigclam_tpu_torch.obs.telemetry import note_compile

        t0 = time.perf_counter()
        path = library_path()
        cached = path.exists()
        if not cached:
            build()
        _LIBRARY = bind(path)
        note_compile("nvcc:kernels", time.perf_counter() - t0, cached=cached)
    return _LIBRARY


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise KernelLaunchError when a C entry returned a CUDA error."""
    if rc != 0:
        msg = lib.bigclam_error_string(rc).decode()
        raise KernelLaunchError(f"{what} launch failed: {msg} (cuda error {rc})")


def stream_handle(device) -> int:
    """The current torch stream of `device` as a raw cudaStream_t."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(device, entry: str, *args) -> None:
    """Call the C entry `entry` of the library with `args` and then the
    current stream of `device`, with `device` the current CUDA device for
    the call (a kernel launches on the current device, which on a mesh of
    several cards is not always the tensors' one); raise KernelLaunchError
    when it returns a CUDA error."""
    lib = load_library()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, stream_handle(device))
    check_launch(lib, rc, entry.removeprefix("bigclam_"))
