"""The two ring-phase edge kernels (paths `csr_ring_fused` and `csr_ring`):
one (shard, phase) bucket of the gradient pass (#8) and of the candidate
pass (#9), each added into a per-shard accumulator.

Port of bigclam_tpu/ops/pallas_fused.py `_grad_blocks_fused` and
`_cand_blocks_fused`, the kernels the JAX ring schedule runs per phase
(bigclam_tpu/parallel/ring.py, `make_ring_csr_train_step`). The CUDA
sources are csrc/ring_grad_phase.cu and csrc/ring_cand_phase.cu (one warp
per node over the bucket's CSR, #8 taking the nodes in the bucket's visit
order; their headers say what bounds each on an H100). A bucket is a
DeviceCSR over the shard's n rows whose indices are rows of the rotating
shard F_rot, or on the 2D partition (parallel/twod.py) an edge block over
a row group's rows whose indices are rows of the closure table: F_rot may
have any number of rows. Each wrapper:

* on CPU tensors runs its plain PyTorch version (the same partials,
  edge-chunked, with index_select/index_add_ in the input dtype, added to
  the accumulator once);
* on CUDA tensors checks device, dtype, contiguity and shapes, launches
  its kernel on the shard device's current stream and counts the launch in
  `<wrapper>.launches`, or raises. It never falls back to the plain
  version.

The accumulators are updated in place and returned.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.ops.csr_kernels import (
    check_cuda_inputs,
    check_float32,
    edge_chunks,
    kernel_constants,
    ladder_launch_plan,
)
from bigclam_tpu_torch.ops.linesearch import candidates_pass
from bigclam_tpu_torch.ops.objective import neighbour_sums


def ring_grad_phase_plain(
    F_loc: torch.Tensor,
    F_rot: torch.Tensor,
    bucket: DeviceCSR,
    gn: torch.Tensor,
    ln: torch.Tensor,
    cfg: BigClamConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain kernel #8: gn += sum_v F_rot[v] / omp(F_u.F_rot[v]) and
    ln += sum_v ell over the bucket's edges (partials formed from zero,
    then added once). No fold, no node tail."""
    part_g, part_l = neighbour_sums(F_loc, edge_chunks(F_loc, bucket, cfg), cfg, F_rot)
    gn.add_(part_g)
    ln.add_(part_l.to(ln.dtype))
    return gn, ln


def ring_grad_phase(
    F_loc: torch.Tensor,
    F_rot: torch.Tensor,
    bucket: DeviceCSR,
    gn: torch.Tensor,
    ln: torch.Tensor,
    cfg: BigClamConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring phase of the gradient pass (kernel #8; counterpart of the
    TPU `_grad_blocks_fused`): adds the bucket's neighbour-gradient and
    neighbour-LLH partials to gn (n, K) and ln (n,) in place. The kernel's
    warps take the rows in `bucket.order` where it is set (the result does
    not depend on it), else all n rows in order."""
    if F_loc.device.type == "cpu":
        return ring_grad_phase_plain(F_loc, F_rot, bucket, gn, ln, cfg)
    n, k = F_loc.shape
    check_cuda_inputs(F_loc, bucket, rows=(gn,), dst=F_rot)
    check_float32(F_loc.device, [("ln", ln, (n,))])
    order = bucket.order
    if order is not None and (
        order.dtype != torch.int32 or order.dim() != 1 or not order.is_contiguous()
        or order.device != F_loc.device or order.shape[0] > n
    ):
        raise ValueError(
            f"the bucket's visit order must be a contiguous int32 vector of at "
            f"most {n} rows on {F_loc.device}"
        )
    c = kernel_constants(cfg)
    build.launch(
        F_loc.device, "bigclam_ring_grad_phase",
        F_loc.data_ptr(), F_rot.data_ptr(), bucket.indptr.data_ptr(),
        bucket.indices.data_ptr(), 0 if order is None else order.data_ptr(),
        0 if order is None else int(order.shape[0]), n, k,
        c["omp_lo"], c["omp_hi"], gn.data_ptr(), ln.data_ptr(),
    )
    ring_grad_phase.launches += 1
    return gn, ln


ring_grad_phase.launches = 0


def ring_cand_phase_plain(
    F_loc: torch.Tensor,
    grad: torch.Tensor,
    F_rot: torch.Tensor,
    bucket: DeviceCSR,
    cb: torch.Tensor,
    cfg: BigClamConfig,
) -> torch.Tensor:
    """Plain kernel #9: cb[s] += sum_v ell(clip(F_u + eta_s grad_u) .
    F_rot[v]) over the bucket's edges (partials from zero, added once). No
    Armijo tails."""
    part = candidates_pass(F_loc, grad, edge_chunks(F_loc, bucket, cfg), cfg, F_rot)
    return cb.add_(part.to(cb.dtype))


def ring_cand_phase(
    F_loc: torch.Tensor,
    grad: torch.Tensor,
    F_rot: torch.Tensor,
    bucket: DeviceCSR,
    cb: torch.Tensor,
    cfg: BigClamConfig,
) -> torch.Tensor:
    """One ring phase of the candidate pass (kernel #9; counterpart of the
    TPU `_cand_blocks_fused`): adds the bucket's neighbour candidate LLH
    partials to cb (S, n) in place."""
    if F_loc.device.type == "cpu":
        return ring_cand_phase_plain(F_loc, grad, F_rot, bucket, cb, cfg)
    n, k = F_loc.shape
    c = kernel_constants(cfg)
    check_cuda_inputs(F_loc, bucket, rows=(grad,), dst=F_rot)
    plan = ladder_launch_plan("ring_cand_phase", k)
    check_float32(F_loc.device, [("cb", cb, (c["num_s"], n))])
    build.launch(
        F_loc.device, "bigclam_ring_cand_phase",
        F_loc.data_ptr(), grad.data_ptr(), F_rot.data_ptr(),
        bucket.indptr.data_ptr(), bucket.indices.data_ptr(), n, k,
        c["etas"].ctypes.data, c["num_s"], c["omp_lo"], c["omp_hi"],
        c["min_f"], c["max_f"], cb.data_ptr(), plan["smem_bytes"],
    )
    ring_cand_phase.launches += 1
    return cb


ring_cand_phase.launches = 0


def reset_launch_counts() -> None:
    """Set the launch counter of both ring-phase wrappers to 0."""
    ring_grad_phase.launches = 0
    ring_cand_phase.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {
        "ring_grad_phase": ring_grad_phase.launches,
        "ring_cand_phase": ring_cand_phase.launches,
    }
