"""The split CSR edge kernels (path `csr`): per-node gradient + LLH
(kernel B) and the full Armijo candidate LLH (kernel C).

Port of bigclam_tpu/ops/pallas_csr.py `grad_llh_csr` and
`candidates_csr`. The CUDA sources are csrc/grad_llh.cu and
csrc/candidates.cu (one warp per node over the graph's CSR; C walks the
neighbourhood on the staged candidate ladder of csrc/edge_common.cuh; see
their headers for the design and what bounds each on an H100). Each wrapper:

* on CPU tensors runs its plain PyTorch version (the same function,
  edge-chunked; the CPU tests hold it against the JAX kernels in
  interpret mode);
* on CUDA tensors checks device, dtype, contiguity and shapes, launches
  its kernel and counts the launch in `<wrapper>.launches`, or raises.
  It never falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.ops.linesearch import candidates_pass, step_etas
from bigclam_tpu_torch.ops.objective import EdgeChunks, edge_chunk_bound, grad_llh

# kernel bounds (csrc/edge_common.cuh): 32 columns per lane, 16 candidates
MAX_K = 1024
MAX_S = 16


# the candidate-ladder kernels' launch geometry (csrc/edge_common.cuh)
LADDER_ROWS = 32            # neighbour rows a staged tile
LADDER_CHUNK = 32           # columns a staged chunk
LADDER_WARPS = 4            # warps (nodes) a block
SMEM_DEFAULT = 48 * 1024    # above this a block needs cudaFuncSetAttribute


class KernelKLimitError(ValueError):
    """More columns than one warp's row (or K-blocked window) holds in
    registers."""


def kernel_supports(cfg: BigClamConfig, dtype: torch.dtype) -> str:
    """Why the CUDA kernels (the CSR ones and the candidate edge-terms
    kernel alike) cannot run F of `dtype` under `cfg`, or "" when they
    can: they take float32 F, accumulate in float32 and hold at most
    MAX_S step candidates. K and the chunk length are limited elsewhere
    (KernelKLimitError) or not at all."""
    if dtype != torch.float32 or cfg.accum_dtype not in (None, "float32"):
        return (
            f"float32 F and accumulation are required (dtype={dtype}, "
            f"accum_dtype={cfg.accum_dtype})"
        )
    if len(cfg.step_candidates) > MAX_S:
        return (
            f"at most {MAX_S} step candidates are supported, got "
            f"{len(cfg.step_candidates)} (max_backtracks={cfg.max_backtracks})"
        )
    return ""


def kpl_bucket(k: int) -> int:
    """Columns per lane of the single-pass kernels at K (edge_common.cuh
    `kpl_bucket`): ceil(K/32) rounded up to a power of two."""
    need = -(-k // 32)
    return 1 << (need - 1).bit_length()


LADDER_KERNELS = (
    "fused_superstep", "candidates_csr", "ring_cand_phase",
    "candidate_edge_terms", "cand_dots_kb",
)


def ladder_launch_plan(kernel: str, k: int) -> dict:
    """The launch geometry of a staged-ladder kernel (csrc/edge_common.cuh
    `ladder_range`) at K columns (for "cand_dots_kb": a window of kc = k
    columns), as the C entries compute it: blocks of LADDER_WARPS warps,
    one node (#14: one run of edges) a warp; per warp two staged tiles of
    LADDER_ROWS rows of LADDER_CHUNK + 4 floats and the 16 candidate rows of
    a chunk, 4 groups of 4 LADDER_CHUNK + 4 floats. Kernel A
    ("fused_superstep") adds F_u (32 kpl floats) and the 16 candidate sums,
    C ("candidates_csr") the 16 sums; #9 ("ring_cand_phase"), #14
    ("candidate_edge_terms") and "cand_dots_kb" nothing. The wrappers pass
    `smem_bytes` and the entries refuse any other value; `opt_in` says the
    entry raises the block's limit with cudaFuncSetAttribute. #14 reads F_u
    and grad_u per column chunk, so it takes any K (its `kpl` is None); A,
    C and #9 take K <= MAX_K, cand_dots_kb a window of kc <= MAX_K."""
    if kernel not in LADDER_KERNELS:
        raise ValueError(f"no ladder kernel named {kernel!r}")
    edge_terms = kernel == "candidate_edge_terms"
    if kernel == "cand_dots_kb" and not 1 <= k <= MAX_K:
        raise KernelKLimitError(
            f"a K block of kc={k} columns is outside the K-blocked CUDA "
            f"kernels' range 1..{MAX_K} (32 columns per lane)"
        )
    if not (1 <= k if edge_terms else 1 <= k <= MAX_K):
        raise KernelKLimitError(
            f"K={k} is outside the single-pass CUDA kernels' range 1..{MAX_K}; "
            "BigClamModel takes the K-blocked path (csr_fused_kb, or "
            "csr_grouped_kb with csr_fused=False) above that bound by itself"
        )
    kpl = None if edge_terms else kpl_bucket(k)
    ladder = 2 * LADDER_ROWS * (LADDER_CHUNK + 4) + 4 * (4 * LADDER_CHUNK + 4)
    per_warp = ladder
    if kernel == "fused_superstep":
        per_warp += 32 * kpl + MAX_S
    elif kernel == "candidates_csr":
        per_warp += MAX_S
    smem = 4 * LADDER_WARPS * per_warp
    return {
        "kpl": kpl, "rows": LADDER_ROWS, "chunk": LADDER_CHUNK,
        "warps_per_block": LADDER_WARPS, "smem_bytes": smem,
        "opt_in": smem > SMEM_DEFAULT,
    }


def edge_chunks(F: torch.Tensor, csr: DeviceCSR, cfg: BigClamConfig) -> EdgeChunks:
    """The CSR's directed edges, chunked for the plain versions."""
    return EdgeChunks(
        csr.src, csr.dst,
        edge_chunk_bound(cfg, F.shape[1], F.element_size()),
    )


def kernel_constants(cfg: BigClamConfig) -> dict:
    """The scalars the kernels take, rounded to float32 as the JAX kernels
    see them: step sizes, float32(alpha*eta) (the fused kernel's threshold
    coefficient, product taken in float64), and the clip bounds
    1-max_p / 1-min_p (computed in float64)."""
    etas = cfg.step_candidates
    if len(etas) > MAX_S:
        raise ValueError(
            f"the CUDA kernels take at most {MAX_S} step candidates, "
            f"got {len(etas)} (max_backtracks={cfg.max_backtracks})"
        )
    return {
        "etas": np.asarray(etas, np.float32),
        "coefs": np.asarray([cfg.alpha * e for e in etas], np.float32),
        "num_s": len(etas),
        "omp_lo": float(np.float32(1.0 - cfg.max_p)),
        "omp_hi": float(np.float32(1.0 - cfg.min_p)),
        "min_f": float(np.float32(cfg.min_f)),
        "max_f": float(np.float32(cfg.max_f)),
    }


def check_float32(device: torch.device, named) -> None:
    """Each (name, tensor, shape) of `named` is float32, contiguous, of that
    shape and on `device`."""
    for name, t, shape in named:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")


def check_csr(csr: DeviceCSR, n: int, device: torch.device) -> None:
    """int64 indptr of n+1 entries and contiguous int32 indices on `device`."""
    if csr.indptr.device != device or csr.indices.device != device:
        raise ValueError(f"the CSR must be on {device}")
    if csr.indptr.dtype != torch.int64 or tuple(csr.indptr.shape) != (n + 1,):
        raise ValueError("indptr must be int64 of n+1 entries")
    if csr.indices.dtype != torch.int32 or not csr.indices.is_contiguous():
        raise ValueError("indices must be contiguous int32")


def check_cuda_inputs(
    F: torch.Tensor, csr: DeviceCSR, *vecs, rows=(), dst=None
) -> None:
    """Validate what the single-pass CUDA kernels take: float32,
    contiguous, on one cuda device; (n, K) matrices with K <= MAX_K; (K,)
    vectors; int64 indptr of n+1 entries and int32 indices; `dst`, the
    matrix of destination rows (any row count, K columns), when given."""
    if F.dim() != 2:
        raise ValueError(f"F must be (n, K), got {tuple(F.shape)}")
    n, k = F.shape
    if k > MAX_K:
        raise KernelKLimitError(
            f"K={k} exceeds the single-pass CUDA kernels' bound of {MAX_K} "
            "columns, and these wrappers refuse it; BigClamModel takes the "
            "K-blocked path (csr_fused_kb, or csr_grouped_kb with "
            "csr_fused=False) above that bound by itself"
        )
    if k < 1:
        raise ValueError("F needs at least one column")
    check_float32(
        F.device,
        [("F", F, (n, k))]
        + [(f"row matrix {i}", t, (n, k)) for i, t in enumerate(rows)]
        + [(f"vector {i}", t, (k,)) for i, t in enumerate(vecs)]
        + ([] if dst is None else [("F_dst", dst, (dst.shape[0], k))]),
    )
    check_csr(csr, n, F.device)


# --- kernel B: gradient + node LLH -----------------------------------------


def grad_llh_csr_plain(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel B: (grad (n,K), node_llh (n,)), the -sumF + F
    fold and the node tail included."""
    return grad_llh(F, sumF, edge_chunks(F, csr, cfg), cfg, F_dst)


def grad_llh_csr(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node gradient + LLH (kernel B; counterpart of the TPU
    `grad_llh_csr`). Returns (grad (n,K), node_llh (n,)). The CSR's
    indices are rows of F_dst (default F: one device; on a mesh's
    all-gather schedule, the gathered F)."""
    if F.device.type == "cpu":
        return grad_llh_csr_plain(F, sumF, csr, cfg, F_dst)
    F_dst = F if F_dst is None else F_dst
    check_cuda_inputs(F, csr, sumF, dst=F_dst)
    c = kernel_constants(cfg)
    n, k = F.shape
    grad = torch.empty_like(F)
    node_llh = torch.empty(n, dtype=F.dtype, device=F.device)
    build.launch(
        F.device, "bigclam_grad_llh",
        F.data_ptr(), F_dst.data_ptr(), sumF.data_ptr(), csr.indptr.data_ptr(),
        csr.indices.data_ptr(), n, k, c["omp_lo"], c["omp_hi"],
        grad.data_ptr(), node_llh.data_ptr(),
    )
    grad_llh_csr.launches += 1
    return grad, node_llh


grad_llh_csr.launches = 0


# --- kernel C: candidate LLH, tails included --------------------------------


def candidates_csr_plain(
    F: torch.Tensor,
    grad: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch kernel C: (S, n) full candidate LLH, the neighbor
    terms plus the Armijo tails nf.(F - sumF) (the TPU kernel's form)."""
    fms = F - sumF[None, :]
    tails = torch.stack([
        (torch.clamp(F + eta * grad, cfg.min_f, cfg.max_f) * fms).sum(dim=1)
        for eta in step_etas(cfg, F)
    ])
    return tails + candidates_pass(F, grad, edge_chunks(F, csr, cfg), cfg, F_dst)


def candidates_csr(
    F: torch.Tensor,
    grad: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """FULL candidate LLH (neighbor terms + Armijo tails) for every step
    (kernel C; counterpart of the TPU `candidates_csr`). Returns (S, n);
    feed it to armijo_select, not armijo_update. The CSR's indices are rows
    of F_dst (default F), as in grad_llh_csr."""
    if F.device.type == "cpu":
        return candidates_csr_plain(F, grad, sumF, csr, cfg, F_dst)
    F_dst = F if F_dst is None else F_dst
    check_cuda_inputs(F, csr, sumF, rows=(grad,), dst=F_dst)
    c = kernel_constants(cfg)
    n, k = F.shape
    cand = torch.empty((c["num_s"], n), dtype=F.dtype, device=F.device)
    build.launch(
        F.device, "bigclam_candidates",
        F.data_ptr(), F_dst.data_ptr(), grad.data_ptr(), sumF.data_ptr(),
        csr.indptr.data_ptr(), csr.indices.data_ptr(), n, k,
        c["etas"].ctypes.data, c["num_s"], c["omp_lo"], c["omp_hi"],
        c["min_f"], c["max_f"], cand.data_ptr(),
        ladder_launch_plan("candidates_csr", k)["smem_bytes"],
    )
    candidates_csr.launches += 1
    return cand


candidates_csr.launches = 0
