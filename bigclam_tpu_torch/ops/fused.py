"""The fused edge superstep (path `csr_fused`, kernel A): gradient, LLH,
the 16-step Armijo ladder, selection and projection in one launch.

Port of bigclam_tpu/ops/pallas_fused.py `fused_superstep_csr`. The CUDA
source is csrc/fused_superstep.cu (one warp per node over the graph's CSR,
the candidate pass on staged neighbour tiles in shared memory sized by
`csr_kernels.ladder_launch_plan`; its header says what bounds it on an
H100 and what the design does about it). The wrapper runs the plain
PyTorch version for CPU tensors; for CUDA tensors it launches the kernel
and counts the launch in `fused_superstep.launches`, or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR
from bigclam_tpu_torch.ops import build, csr_kernels
from bigclam_tpu_torch.ops.csr_kernels import (
    candidates_csr_plain,
    check_cuda_inputs,
    grad_llh_csr_plain,
    kernel_constants,
    ladder_launch_plan,
)
from bigclam_tpu_torch.ops.linesearch import step_etas


def acceptance_inputs_plain(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """What kernel A's acceptance test compares, in plain PyTorch:
    (grad (n,K), node_llh (n,), cand (S,n), threshold (S,n)), the
    threshold rounded as the fused TPU kernel rounds it:
    llh + float32(alpha*eta) * ||g||^2."""
    grad, node_llh = grad_llh_csr_plain(F, sumF, csr, cfg, F_dst)
    cand = candidates_csr_plain(F, grad, sumF, csr, cfg, F_dst)
    coefs = torch.tensor(
        [cfg.alpha * e for e in cfg.step_candidates], dtype=F.dtype,
        device=F.device,
    )
    gg = (grad * grad).sum(dim=1)
    return grad, node_llh, cand, node_llh[None, :] + coefs[:, None] * gg[None, :]


def project_accepted(
    F: torch.Tensor, grad: torch.Tensor, ok: torch.Tensor, cfg: BigClamConfig
) -> torch.Tensor:
    """Kernel A's selection: clip(F + best * grad) with best the largest
    accepted step of each row (ok (S,n)), or F where none is accepted."""
    etas = step_etas(cfg, F)
    best = torch.where(ok, etas[:, None], torch.zeros_like(etas)[:, None])
    best = best.max(dim=0).values
    return torch.where(
        ok.any(dim=0)[:, None],
        torch.clamp(F + best[:, None] * grad, cfg.min_f, cfg.max_f),
        F,
    )


def fused_superstep_plain(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch kernel A. Returns (F_new (n,K), grad (n,K),
    node_llh (n,), ok (S,n) bool)."""
    grad, node_llh, cand, thr = acceptance_inputs_plain(F, sumF, csr, cfg, F_dst)
    ok = cand >= thr
    return project_accepted(F, grad, ok, cfg), grad, node_llh, ok


def fused_superstep(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole edge superstep (kernel A; counterpart of the TPU
    `fused_superstep_csr`). Returns (F_new (n,K), grad (n,K),
    node_llh (n,), ok (S,n) bool acceptance mask — feed accept_stats).
    The CSR's indices are rows of F_dst (default F: one device; on a mesh's
    all-gather schedule, the gathered F, the TPU kernel's F_gather)."""
    if F.device.type == "cpu":
        return fused_superstep_plain(F, sumF, csr, cfg, F_dst)
    F_dst = F if F_dst is None else F_dst
    check_cuda_inputs(F, csr, sumF, dst=F_dst)
    c = kernel_constants(cfg)
    n, k = F.shape
    plan = ladder_launch_plan("fused_superstep", k)
    F_new = torch.empty_like(F)
    grad = torch.empty_like(F)
    node_llh = torch.empty(n, dtype=F.dtype, device=F.device)
    ok = torch.empty((c["num_s"], n), dtype=torch.bool, device=F.device)
    build.launch(
        F.device, "bigclam_fused_superstep",
        F.data_ptr(), F_dst.data_ptr(), sumF.data_ptr(), csr.indptr.data_ptr(),
        csr.indices.data_ptr(), n, k, c["etas"].ctypes.data,
        c["coefs"].ctypes.data, c["num_s"], c["omp_lo"], c["omp_hi"],
        c["min_f"], c["max_f"], F_new.data_ptr(), grad.data_ptr(),
        node_llh.data_ptr(), ok.data_ptr(), plan["smem_bytes"],
    )
    fused_superstep.launches += 1
    return F_new, grad, node_llh, ok


fused_superstep.launches = 0


def reset_launch_counts() -> None:
    """Set the launch counter of every kernel wrapper to 0."""
    fused_superstep.launches = 0
    csr_kernels.grad_llh_csr.launches = 0
    csr_kernels.candidates_csr.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {
        "fused_superstep": fused_superstep.launches,
        "grad_llh_csr": csr_kernels.grad_llh_csr.launches,
        "candidates_csr": csr_kernels.candidates_csr.launches,
    }
