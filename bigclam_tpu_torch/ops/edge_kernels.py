"""The candidate edge-terms kernel of the non-CSR step (path `pallas_vmem`).

Port of bigclam_tpu/ops/pallas_kernels.py. For every edge e = (u, v) of a
chunk and every candidate step eta_s:

    out[s, e] = ell(clip(F_u + eta_s * grad_u, min_f, max_f) . F_v)

with ell the LLH edge term of ops.objective.edge_terms. The per-node sum
stays in torch (`index_add_` in ops.linesearch.candidates_scan), as the
JAX version keeps its `segment_sum` in XLA.

The TPU kernel takes three (chunk, K_pad) rows that XLA gathered into HBM
and loads them in blocks of 1,024 edges into VMEM, so it needs K_pad a
multiple of 128, a 1,024-aligned chunk and K_pad <= 768 (its VMEM
budget). The CUDA kernel (csrc/candidate_edge_terms.cu) reads the rows
by index from F and grad instead, so no gathered copy reaches device
memory, and it takes any K, any chunk length and any edge order. One warp
walks one run of the chunk (consecutive edges with one source,
`edge_runs`) on the staged candidate ladder; a model's edge chunks carry
their runs, computed once (`with_runs`), and bare src/dst get theirs at
the call. Its limits are those of the CSR kernels
(`ops.csr_kernels.kernel_supports`): float32 F and accumulation, and at
most 16 step candidates.

`candidate_edge_terms` runs the plain version on CPU tensors; on CUDA
tensors it checks its inputs, launches the kernel and counts the launch in
`candidate_edge_terms.launches`, or raises. It never falls back to the
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.ops.csr_kernels import (
    check_float32,
    kernel_constants,
    kernel_supports,
    ladder_launch_plan,
)
from bigclam_tpu_torch.ops.linesearch import candidate_edge_terms_body, candidates_scan
from bigclam_tpu_torch.ops.objective import EdgeChunks


class CandidateKernelError(ValueError):
    """The candidate edge-terms CUDA kernel cannot take this configuration
    (a non-float32 accumulation or more than 16 steps)."""


def candidate_edge_terms_plain(
    fs: torch.Tensor,
    gs: torch.Tensor,
    fd: torch.Tensor,
    mask: Optional[torch.Tensor],
    cfg: BigClamConfig,
) -> torch.Tensor:
    """Plain PyTorch version of the TPU kernel's function: (S, chunk) LLH
    edge terms from gathered (chunk, K) rows F_src, grad_src, F_dst, times
    the (chunk,) mask of a padded chunk (None: no mask)."""
    ell = candidate_edge_terms_body(fs, gs, fd, cfg)
    return ell if mask is None else ell * mask


def edge_runs(src: torch.Tensor) -> torch.Tensor:
    """(R + 1,) int64 offsets of the runs of `src`, the maximal ranges of
    consecutive equal entries: run r is [runs[r], runs[r + 1]), runs[0] = 0
    and runs[R] = len(src) (R = 0 for an empty src)."""
    e = int(src.shape[0])
    if e == 0:
        return torch.zeros(1, dtype=torch.int64, device=src.device)
    starts = torch.nonzero(src[1:] != src[:-1]).flatten() + 1
    ends = torch.tensor([0, e], dtype=torch.int64, device=src.device)
    return torch.cat([ends[:1], starts, ends[1:]])


def with_runs(edges: EdgeChunks) -> EdgeChunks:
    """`edges` with each chunk's run offsets (edge_runs) cached."""
    return edges._replace(runs=tuple(edge_runs(s) for s, _ in edges.slices()))


def _check_cuda(F, grad, src, dst) -> None:
    if F.dim() != 2 or F.shape[1] < 1:
        raise ValueError(f"F must be (n, K) with K >= 1, got {tuple(F.shape)}")
    check_float32(F.device, [("F", F, F.shape), ("grad", grad, F.shape)])
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 vector")
        if t.device != F.device:
            raise ValueError(f"{name} is on {t.device}, F on {F.device}")
    if src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} differ")


def candidate_edge_terms(
    F: torch.Tensor,
    grad: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    cfg: BigClamConfig,
    runs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(S, chunk) candidate LLH edge terms of the edges src -> dst, the rows
    read by index from F and grad (counterpart of the TPU
    `candidate_edge_terms`, which takes them pre-gathered). `runs`: the
    chunk's edge_runs(src), computed here when not given (the result does
    not depend on it)."""
    if F.device.type == "cpu":
        return candidate_edge_terms_plain(
            F.index_select(0, src), grad.index_select(0, src),
            F.index_select(0, dst), None, cfg,
        )
    _check_cuda(F, grad, src, dst)
    reason = kernel_supports(cfg, F.dtype)
    if reason:
        raise CandidateKernelError(f"candidate_edge_terms cannot run: {reason}")
    e, k = int(src.shape[0]), int(F.shape[1])
    if runs is None:
        runs = edge_runs(src)
    elif (runs.dtype != torch.int64 or runs.dim() != 1 or runs.device != F.device
          or not runs.is_contiguous() or not 1 <= runs.shape[0] <= e + 1):
        raise ValueError(
            f"runs must be a contiguous 1-D int64 vector of at most {e + 1} "
            "offsets on F's device (edge_runs of src)"
        )
    c = kernel_constants(cfg)
    plan = ladder_launch_plan("candidate_edge_terms", k)
    out = torch.empty((c["num_s"], e), dtype=F.dtype, device=F.device)
    build.launch(
        F.device, "bigclam_candidate_edge_terms",
        F.data_ptr(), grad.data_ptr(), src.data_ptr(), dst.data_ptr(),
        runs.data_ptr(), int(runs.shape[0]) - 1, e, k,
        c["etas"].ctypes.data, c["num_s"], c["omp_lo"], c["omp_hi"],
        c["min_f"], c["max_f"], out.data_ptr(), plan["smem_bytes"],
    )
    candidate_edge_terms.launches += 1
    return out


candidate_edge_terms.launches = 0


def candidates_pass_kernel(
    F: torch.Tensor, grad: torch.Tensor, edges: EdgeChunks, cfg: BigClamConfig
) -> torch.Tensor:
    """ops.linesearch.candidates_pass with the edge terms from
    candidate_edge_terms, one launch per edge chunk on the card, with the
    chunks' cached runs where `edges` carries them (counterpart of the TPU
    `candidates_pass_pallas`). Returns (S, N)."""
    runs = iter(edges.runs or ())
    return candidates_scan(
        F, edges, cfg,
        lambda s, d: candidate_edge_terms(F, grad, s, d, cfg, next(runs, None)),
    )


def reset_launch_counts() -> None:
    """Set the candidate edge-terms kernel's launch counter to 0."""
    candidate_edge_terms.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {"candidate_edge_terms": candidate_edge_terms.launches}
