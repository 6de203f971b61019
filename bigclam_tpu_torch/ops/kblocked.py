"""The K-blocked edge kernels (paths `csr_fused_kb` and `csr_grouped_kb`):
large K on one card, kc columns of F at a time.

Port of the single-chip large-K passes of the JAX package,
bigclam_tpu/ops/pallas_fused.py `train_pass_csr_kblocked_fused` and
bigclam_tpu/ops/pallas_csr.py `train_pass_csr_grouped_kblocked`. A step
runs four kernels:

* `edge_dots_kb`   — window share of every edge dot F_u.F_v, added into x
  (csrc/edge_dots_kb.cu; the TPU's `edge_dots_fused` and `edge_dots_csr`),
  each undirected pair computed once and written to both of its positions
  through the CSR's reverse-edge index (`reverse_edges`, cached as
  `DeviceCSR.rev`);
* `grad_from_x_kb` — from the full x, the window's gradient columns
  (optionally folded with -sumF + F), written in place into the step's
  gradient, and the neighbour LLH (csrc/grad_from_x.cu;
  `grad_nbr_from_x_fused`, `grad_nbr_from_x_csr`);
* `cand_dots_kb`   — window share of every edge's 16 candidate dots, added
  into xc (csrc/cand_dots_kb.cu, on the staged candidate ladder of
  csrc/edge_common.cuh; `cand_dots_fused`, `cand_dots_csr`);
* `cand_select_from_x` — the node pass that ends the step: from the full
  xc, each node's neighbour candidate sums, its node tail and the 16 Armijo
  tails, the acceptance test and the selection, F_new written once
  (csrc/cand_from_x.cu; it absorbs `cand_nbr_from_x_csr`). The neighbour
  sums alone stay as `cand_nbr_from_x`, the JAX function, for callers that
  psum them before the tails (`train_pass_kblocked`).

On a mesh the first three take `F_dst`, the tensor the CSR's destination
ids index (the all-gathered F on the all-gather schedule, the rotating
shard in a ring phase), and `edge_dots_kb` walks every directed edge where
a shard's CSR or a ring bucket is not symmetric (its directed mode);
`grad_from_x_kb` can add into the gradient and the LLH it is given (its
accumulate mode: the ring sums them over its phases). The mesh passes
(`edge_dots_windows`, `grad_cand_windows`) run every window of a node
row's columns, so a K-sharded mesh can psum the dots between them.

The TPU keeps two copies of the first three (one DMAs the window in-kernel,
one takes a gathered fd); on the card a warp reads each neighbour row's
window directly, so each pair is one kernel. Per-edge arrays (x (E,), xc
(S, E)) are indexed by CSR position, the order of `DeviceCSR.src/dst`.

Each wrapper runs its plain PyTorch version on CPU tensors; on CUDA tensors
it checks its inputs, launches its kernel and counts the launch in
`<wrapper>.launches`, or raises. It never falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.ops.csr_kernels import (
    MAX_K,
    KernelKLimitError,
    check_csr,
    check_float32,
    kernel_constants,
    ladder_launch_plan,
)
from bigclam_tpu_torch.ops.linesearch import armijo_tail_select_plain, step_etas
from bigclam_tpu_torch.ops.objective import (
    accum_dtype,
    edge_chunk_bound,
    edge_terms,
    node_tail,
)

# plain versions' edge chunking where no config is given (edge_dots_kb)
_DEFAULT_CFG = BigClamConfig()


def _chunks(csr: DeviceCSR, cols: int, like: torch.Tensor, cfg: BigClamConfig):
    """(lo, src, dst) edge chunks in CSR order, each gather of `cols`
    columns bounded as the plain edge sweeps bound theirs."""
    e = csr.num_directed_edges
    step = edge_chunk_bound(cfg, cols, like.element_size())
    for lo in range(0, e, step):
        yield lo, csr.src[lo : lo + step], csr.dst[lo : lo + step]


def check_window(F: torch.Tensor, col0: int, kc: int) -> None:
    """A window of kc in [1, MAX_K] columns inside F's rows."""
    if F.dim() != 2:
        raise ValueError(f"F must be (n, K_pad), got {tuple(F.shape)}")
    if not 1 <= kc <= MAX_K:
        raise KernelKLimitError(
            f"a K block of kc={kc} columns is outside the K-blocked CUDA "
            f"kernels' range 1..{MAX_K} (32 columns per lane)"
        )
    if col0 < 0 or col0 + kc > F.shape[1]:
        raise ValueError(
            f"window [{col0}, {col0 + kc}) is outside F's {F.shape[1]} columns"
        )


def _check_cuda(F: torch.Tensor, csr: DeviceCSR, col0: int, kc: int, named) -> None:
    check_window(F, col0, kc)
    check_float32(F.device, [("F", F, tuple(F.shape)), *named])
    check_csr(csr, F.shape[0], F.device)


def check_window_rows(name: str, t: torch.Tensor, n: int, kc: int,
                      device: torch.device) -> int:
    """`t` is an (n, kc) float32 matrix on `device` whose rows are
    contiguous (a window of a wider matrix, or a matrix of its own); returns
    its row stride, which the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != (n, kc):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {(n, kc)}")
    if (t.stride(1) != 1 and kc > 1) or t.stride(0) < kc:
        raise ValueError(f"{name} must have contiguous rows, got strides {t.stride()}")
    return t.stride(0)


# --- the reverse-edge index ---------------------------------------------------


class AsymmetricCSRError(ValueError):
    """A CSR that edge_dots_kb cannot take: some edge (u, v) has no
    (v, u), or an edge is a self-loop."""


def reverse_edges(csr: DeviceCSR) -> torch.Tensor:
    """(2E,) int32: for each CSR position of (u, v), the position of
    (v, u). The rows are sorted, so it is the stable argsort of the key
    dst * n + src. Raises AsymmetricCSRError for a CSR that is not
    symmetric (a ring bucket's, say) or holds a self-loop, where
    edge_dots_kb's one pass per pair would give a wrong x."""
    n, e = csr.num_nodes, csr.num_directed_edges
    if e >= 2**31:
        raise ValueError(f"{e} directed edges exceed the int32 reverse-edge index")
    if bool((csr.src == csr.dst).any()):
        raise AsymmetricCSRError("edge_dots_kb needs a CSR without self-loops")
    rev = torch.argsort(csr.dst * n + csr.src, stable=True)
    if not (torch.equal(csr.src[rev], csr.dst) and torch.equal(csr.dst[rev], csr.src)):
        raise AsymmetricCSRError(
            "edge_dots_kb needs a symmetric CSR with sorted rows (each edge "
            "(u, v) with its (v, u)); this one is not"
        )
    return rev.to(torch.int32)


def with_rev(csr: DeviceCSR) -> DeviceCSR:
    """`csr` with its reverse-edge index (reverse_edges) cached."""
    return csr if csr.rev is not None else csr._replace(rev=reverse_edges(csr))


# --- edge dots ----------------------------------------------------------------


def edge_dots_kb_plain(
    F: torch.Tensor, csr: DeviceCSR, col0: int, kc: int, x: torch.Tensor,
    F_dst: Optional[torch.Tensor] = None, rev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch edge_dots_kb: x[e] += F_u[win] . F_dst_v[win]. With
    `rev` (the pair mode, F_dst None) each pair (u, v), v > u, is computed
    once and added at e and rev[e], as the kernel does."""
    Fw = F[:, col0 : col0 + kc]
    Fd = Fw if F_dst is None else F_dst[:, col0 : col0 + kc]
    if rev is None:
        for lo, s, d in _chunks(csr, kc, F, _DEFAULT_CFG):
            x[lo : lo + s.shape[0]] += (Fw.index_select(0, s) * Fd.index_select(0, d)).sum(dim=1)
        return x
    pos = torch.nonzero(csr.dst > csr.src).flatten()
    step = edge_chunk_bound(_DEFAULT_CFG, kc, F.element_size())
    for lo in range(0, pos.shape[0], step):
        p = pos[lo : lo + step]
        d = (Fw.index_select(0, csr.src[p]) * Fw.index_select(0, csr.dst[p])).sum(dim=1)
        r = rev[p].long()
        x[p] += d
        x[r] += d
    return x


def edge_mode(csr: DeviceCSR, F_dst: Optional[torch.Tensor] = None,
              directed: Optional[bool] = None) -> Optional[torch.Tensor]:
    """The reverse-edge index edge_dots_kb's pair mode reads, or None for
    the directed mode. directed=None takes the directed mode where F_dst
    is given or the CSR is not symmetric without self-loops; False asks
    for the pair mode (reverse_edges refuses another CSR)."""
    if directed or (directed is None and F_dst is not None):
        return None
    if F_dst is not None:
        raise ValueError("the pair mode reads both ends from F; F_dst needs directed")
    if csr.rev is not None:
        return csr.rev
    if directed is None:
        try:
            return reverse_edges(csr)
        except AsymmetricCSRError:
            return None
    return reverse_edges(csr)


def edge_dots_kb(
    F: torch.Tensor, csr: DeviceCSR, col0: int, kc: int, x: torch.Tensor,
    F_dst: Optional[torch.Tensor] = None, directed: Optional[bool] = None,
) -> torch.Tensor:
    """Add window [col0, col0+kc) of every directed edge's dot F_u.F_v into
    x (E,), in place; returns x. Over every window in order, x ends as the
    full dots. F_dst (default F) holds the destination rows. The pair mode
    computes each pair once through `csr.rev` (built here when it is not
    cached); the directed mode every edge (edge_mode picks: directed where
    F_dst is given or the CSR is not symmetric). Both give the same bits on
    a symmetric CSR."""
    rev = edge_mode(csr, F_dst, directed)
    if F.device.type == "cpu":
        return edge_dots_kb_plain(F, csr, col0, kc, x, F_dst, rev)
    e = csr.num_directed_edges
    _check_cuda(F, csr, col0, kc, [("x", x, (e,))])
    Fd = _check_dst(F_dst, F)
    if rev is not None and (
        rev.dtype != torch.int32 or tuple(rev.shape) != (e,) or rev.device != F.device
    ):
        raise ValueError(f"csr.rev must be ({e},) int32 on {F.device}")
    n, k_pad = F.shape
    build.launch(
        F.device, "bigclam_edge_dots_kb",
        F.data_ptr(), Fd, csr.indptr.data_ptr(), csr.indices.data_ptr(),
        None if rev is None else rev.data_ptr(), n, k_pad, col0, kc, x.data_ptr(),
    )
    edge_dots_kb.launches += 1
    return x


edge_dots_kb.launches = 0


def _check_dst(F_dst: Optional[torch.Tensor], F: torch.Tensor):
    """The destination-row pointer the kernels take: None (they read F) or
    F_dst's, a float32 contiguous matrix of F's columns on F's device."""
    if F_dst is None:
        return None
    check_float32(F.device, [("F_dst", F_dst, (F_dst.shape[0], F.shape[1]))])
    return F_dst.data_ptr()


# --- gradient columns from x --------------------------------------------------


def grad_from_x_kb_plain(
    x: torch.Tensor,
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    col0: int,
    kc: int,
    cfg: BigClamConfig,
    fold: bool,
    out: Optional[torch.Tensor] = None,
    F_dst: Optional[torch.Tensor] = None,
    accumulate: bool = False,
    llh_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch grad_from_x_kb."""
    _check_modes(fold, accumulate, out, llh_out, col0)
    n = F.shape[0]
    Fw = F[:, col0 : col0 + kc]
    Fd = Fw if F_dst is None else F_dst[:, col0 : col0 + kc]
    omp, ell = edge_terms(x, cfg)
    coeff = 1.0 / omp
    acc = torch.zeros((n, kc), dtype=F.dtype, device=F.device)
    for lo, s, d in _chunks(csr, kc, F, cfg):
        acc.index_add_(0, s, Fd.index_select(0, d) * coeff[lo : lo + s.shape[0], None])
    llh_nbr = None
    if col0 == 0:
        adt = accum_dtype(cfg, F)
        llh_nbr = torch.zeros(n, dtype=adt, device=F.device).index_add_(
            0, csr.src, ell.to(adt)
        )
        if accumulate:
            llh_nbr = llh_out.add_(llh_nbr.to(llh_out.dtype))
        elif llh_out is not None:
            llh_nbr = llh_out.copy_(llh_nbr)
    if fold:
        acc = acc - sumF[None, col0 : col0 + kc] + Fw
    if accumulate:
        acc = out.add_(acc)
    elif out is not None:
        acc = out.copy_(acc)
    return acc, llh_nbr


def _check_modes(fold, accumulate, out, llh_out, col0) -> None:
    if accumulate and fold:
        raise ValueError("grad_from_x_kb adds into `out` or folds, not both")
    if accumulate and (out is None or (col0 == 0 and llh_out is None)):
        raise ValueError("accumulate adds into `out` (and `llh_out` at col0 == 0)")


def grad_from_x_kb(
    x: torch.Tensor,
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    col0: int,
    kc: int,
    cfg: BigClamConfig,
    fold: bool,
    out: Optional[torch.Tensor] = None,
    F_dst: Optional[torch.Tensor] = None,
    accumulate: bool = False,
    llh_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """From the FULL edge dots x (E,): the gradient columns [col0, col0+kc)
    (n, kc), sum_v F_dst_v[win]/omp(x) (F_dst default F) with the -sumF + F
    fold when `fold`, and the neighbour LLH (n,). The columns go into `out`
    when it is given (an (n, kc) matrix with contiguous rows, such as the
    window's columns of the step's (n, K_pad) gradient), else into a new
    (n, kc) matrix; the LLH into `llh_out` when given. With `accumulate`
    both are ADDED to what `out` and `llh_out` hold (no fold). The LLH does
    not depend on the window, so it is computed for the window at col0 == 0
    only and is None for the others."""
    if F.device.type == "cpu":
        return grad_from_x_kb_plain(x, F, sumF, csr, col0, kc, cfg, fold, out,
                                    F_dst, accumulate, llh_out)
    _check_modes(fold, accumulate, out, llh_out, col0)
    _check_cuda(F, csr, col0, kc, [
        ("x", x, (csr.num_directed_edges,)), ("sumF", sumF, (F.shape[1],)),
    ])
    Fd = _check_dst(F_dst, F)
    c = kernel_constants(cfg)
    n, k_pad = F.shape
    if out is None:
        out = torch.empty((n, kc), dtype=F.dtype, device=F.device)
    ld = check_window_rows("out", out, n, kc, F.device)
    llh_nbr = None
    if col0 == 0:
        llh_nbr = torch.empty(n, dtype=F.dtype, device=F.device) if llh_out is None else llh_out
        check_float32(F.device, [("llh_out", llh_nbr, (n,))])
    build.launch(
        F.device, "bigclam_grad_from_x",
        x.data_ptr(), F.data_ptr(), Fd, sumF.data_ptr(), csr.indptr.data_ptr(),
        csr.indices.data_ptr(), n, k_pad, col0, kc, c["omp_lo"], c["omp_hi"],
        int(bool(fold)), int(bool(accumulate)), out.data_ptr(), ld,
        None if llh_nbr is None else llh_nbr.data_ptr(),
    )
    grad_from_x_kb.launches += 1
    return out, llh_nbr


grad_from_x_kb.launches = 0


# --- candidate dots -----------------------------------------------------------


def cand_dots_kb_plain(
    F: torch.Tensor,
    grad_kb: torch.Tensor,
    csr: DeviceCSR,
    col0: int,
    kc: int,
    cfg: BigClamConfig,
    xc: torch.Tensor,
    F_dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch cand_dots_kb."""
    Fw = F[:, col0 : col0 + kc]
    Fd = Fw if F_dst is None else F_dst[:, col0 : col0 + kc]
    etas = step_etas(cfg, F)
    for lo, s, d in _chunks(csr, kc, F, cfg):
        fs, gs, fd = Fw.index_select(0, s), grad_kb.index_select(0, s), Fd.index_select(0, d)
        for i in range(etas.shape[0]):
            nf = torch.clamp(fs + etas[i] * gs, cfg.min_f, cfg.max_f)
            xc[i, lo : lo + s.shape[0]] += (nf * fd).sum(dim=1)
    return xc


def cand_dots_kb(
    F: torch.Tensor,
    grad_kb: torch.Tensor,
    csr: DeviceCSR,
    col0: int,
    kc: int,
    cfg: BigClamConfig,
    xc: torch.Tensor,
    F_dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Add window [col0, col0+kc) of every edge's candidate dots
    clip(F_u + eta_s grad_u, min_f, max_f) . F_dst_v (F_dst default F) into
    xc (S, E), in place; grad_kb (n, kc) holds the window's (folded)
    gradient columns, with contiguous rows (a window of the step's gradient
    will do). Returns xc."""
    if F.device.type == "cpu":
        return cand_dots_kb_plain(F, grad_kb, csr, col0, kc, cfg, xc, F_dst)
    c = kernel_constants(cfg)
    e = csr.num_directed_edges
    _check_cuda(F, csr, col0, kc, [("xc", xc, (c["num_s"], e))])
    Fd = _check_dst(F_dst, F)
    n, k_pad = F.shape
    ld = check_window_rows("grad_kb", grad_kb, n, kc, F.device)
    build.launch(
        F.device, "bigclam_cand_dots_kb",
        F.data_ptr(), Fd, grad_kb.data_ptr(), ld, csr.indptr.data_ptr(),
        csr.indices.data_ptr(), n, e, k_pad, col0, kc, c["etas"].ctypes.data,
        c["num_s"], c["omp_lo"], c["omp_hi"], c["min_f"], c["max_f"],
        xc.data_ptr(), ladder_launch_plan("cand_dots_kb", kc)["smem_bytes"],
    )
    cand_dots_kb.launches += 1
    return xc


cand_dots_kb.launches = 0


# --- candidate LLH from xc ----------------------------------------------------


def cand_nbr_from_x_plain(
    xc: torch.Tensor, csr: DeviceCSR, cfg: BigClamConfig
) -> torch.Tensor:
    """Plain PyTorch cand_nbr_from_x."""
    out = torch.zeros((xc.shape[0], csr.num_nodes), dtype=xc.dtype, device=xc.device)
    for i in range(xc.shape[0]):
        _, ell = edge_terms(xc[i], cfg)
        out[i].index_add_(0, csr.src, ell)
    return out


def cand_nbr_from_x(
    xc: torch.Tensor, csr: DeviceCSR, cfg: BigClamConfig
) -> torch.Tensor:
    """NEIGHBOR candidate LLH (S, n) from the FULL candidate dots xc (S, E):
    sum over each node's edges of log(omp(xc)) + xc. No Armijo tails: feed
    armijo_update (or armijo_update_kernel), which adds them; the one-card
    step takes cand_select_from_x, which does all of it in one pass."""
    if xc.device.type == "cpu":
        return cand_nbr_from_x_plain(xc, csr, cfg)
    c = kernel_constants(cfg)
    n, e = csr.num_nodes, csr.num_directed_edges
    check_float32(xc.device, [("xc", xc, (c["num_s"], e))])
    check_csr(csr, n, xc.device)
    out = torch.empty((c["num_s"], n), dtype=xc.dtype, device=xc.device)
    build.launch(
        xc.device, "bigclam_cand_from_x",
        xc.data_ptr(), csr.indptr.data_ptr(), n, e, c["num_s"], c["omp_lo"],
        c["omp_hi"], out.data_ptr(),
    )
    cand_nbr_from_x.launches += 1
    return out


cand_nbr_from_x.launches = 0


# --- the node pass -------------------------------------------------------------


def cand_select_from_x_plain(
    xc: torch.Tensor,
    F: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    llh_nbr: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch cand_select_from_x: cand_nbr_from_x_plain, then the node
    tail, then armijo_update's tails and selection."""
    adt = accum_dtype(cfg, F)
    cand_nbr = cand_nbr_from_x_plain(xc, csr, cfg)
    node_llh = llh_nbr.to(adt) + node_tail(F, sumF).to(adt)
    F_new, ok = armijo_tail_select_plain(F, sumF, grad, node_llh, cand_nbr.to(adt), cfg)
    return F_new, node_llh, ok


def cand_select_from_x(
    xc: torch.Tensor,
    F: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    llh_nbr: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The node pass that ends a K-blocked step: from the FULL candidate
    dots xc (S, E), F (n, K_pad), sumF, the folded gradient (n, K_pad) and
    the neighbour LLH (n,), per node the neighbour candidate sums, the node
    tail -F.sumF + F.F, the Armijo tails clip(F + eta g).(F - sumF), the
    acceptance test (threshold rounded as kernel A rounds it) and the
    largest accepted step. Returns (F_new (n, K_pad), node_llh (n,), ok
    (S, n) bool), as fused_superstep returns them."""
    if xc.device.type == "cpu":
        return cand_select_from_x_plain(xc, F, sumF, grad, llh_nbr, csr, cfg)
    if F.dim() != 2:
        raise ValueError(f"F must be (n, K_pad), got {tuple(F.shape)}")
    c = kernel_constants(cfg)
    n, k_pad = F.shape
    e = csr.num_directed_edges
    check_float32(F.device, [
        ("xc", xc, (c["num_s"], e)), ("F", F, (n, k_pad)), ("grad", grad, (n, k_pad)),
        ("sumF", sumF, (k_pad,)), ("llh_nbr", llh_nbr, (n,)),
    ])
    check_csr(csr, n, F.device)
    F_new = torch.empty_like(F)
    node_llh = torch.empty(n, dtype=F.dtype, device=F.device)
    ok = torch.empty((c["num_s"], n), dtype=torch.bool, device=F.device)
    build.launch(
        F.device, "bigclam_cand_select_from_x",
        xc.data_ptr(), e, csr.indptr.data_ptr(), F.data_ptr(), sumF.data_ptr(),
        grad.data_ptr(), llh_nbr.data_ptr(), n, k_pad, c["etas"].ctypes.data,
        c["coefs"].ctypes.data, c["num_s"], c["omp_lo"], c["omp_hi"], c["min_f"],
        c["max_f"], F_new.data_ptr(), node_llh.data_ptr(), ok.data_ptr(),
    )
    cand_select_from_x.launches += 1
    return F_new, node_llh, ok


cand_select_from_x.launches = 0


# --- the K-blocked train pass -------------------------------------------------


def _windows(k_pad: int, kc: int) -> range:
    if kc < 1 or k_pad % kc:
        raise ValueError(f"K block kc={kc} must divide K_pad={k_pad}")
    return range(0, k_pad, kc)


def edge_dots_windows(
    F: torch.Tensor, csr: DeviceCSR, kc: int, F_dst: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """x (E,): every window's edge_dots_kb (kc | F.shape[1]) summed in
    window order, F_dst the destination rows (directed mode where given).
    plain=True runs the plain versions on any device (the `xla` step)."""
    x = torch.zeros(csr.num_directed_edges, dtype=F.dtype, device=F.device)
    for col0 in _windows(F.shape[1], kc):
        if plain:
            edge_dots_kb_plain(F, csr, col0, kc, x, F_dst, edge_mode(csr, F_dst))
        else:
            edge_dots_kb(F, csr, col0, kc, x, F_dst)
    return x


def grad_cand_windows(
    x: torch.Tensor,
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    kc: int,
    fold: bool,
    F_dst: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """From the FULL dots x, per window: grad_from_x_kb into that window's
    columns of the step's gradient, folded in the kernel (`fold`) or in
    torch after it, then cand_dots_kb on them. Returns (grad (n, K_pad),
    llh_nbr (n,), xc (S, E)); xc holds this F's columns' share of the
    candidate dots (all of them where F holds whole rows)."""
    grad_fn = grad_from_x_kb_plain if plain else grad_from_x_kb
    cand_fn = cand_dots_kb_plain if plain else cand_dots_kb
    e = csr.num_directed_edges
    xc = torch.zeros((len(cfg.step_candidates), e), dtype=F.dtype, device=F.device)
    grad = torch.empty_like(F)
    for col0 in _windows(F.shape[1], kc):
        grad_kb = grad[:, col0 : col0 + kc]
        _, llh = grad_fn(x, F, sumF, csr, col0, kc, cfg, fold, grad_kb, F_dst)
        if col0 == 0:
            llh_nbr = llh
        if not fold:
            grad_kb.sub_(sumF[None, col0 : col0 + kc]).add_(F[:, col0 : col0 + kc])
        cand_fn(F, grad_kb, csr, col0, kc, cfg, xc, F_dst)
    return grad, llh_nbr, xc


def kblocked_terms(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    kc: int,
    fold: bool = True,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's edge terms over K blocks of kc columns (kc | F.shape[1]):
    (1) every block's edge_dots_kb, so x holds the FULL dots before any
    consumer reads it; (2) per block, grad_from_x_kb into that block's
    columns of the step's gradient, then cand_dots_kb on them. With
    fold=True the -sumF + F fold runs in the gradient kernel
    (`csr_fused_kb`), else in torch, in place (`csr_grouped_kb`). F_dst
    (default F) holds the destination rows: the gathered F of a tp = 1
    all-gather mesh. Returns (grad (n, K_pad), llh_nbr (n,), xc (S, E)),
    the full candidate dots."""
    x = edge_dots_windows(F, csr, kc, F_dst)
    return grad_cand_windows(x, F, sumF, csr, cfg, kc, fold, F_dst)


def train_pass_kblocked(
    F: torch.Tensor,
    sumF: torch.Tensor,
    csr: DeviceCSR,
    cfg: BigClamConfig,
    kc: int,
    fold: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX K-blocked pass's interface: kblocked_terms, then one
    cand_nbr_from_x. Returns (grad (n, K_pad), llh_nbr (n,), cand_nbr
    (S, n)); the candidate terms are neighbour-only (a caller that psums
    them over a K-sharded mesh adds the tails after). The one-card step
    ends with cand_select_from_x instead."""
    grad, llh_nbr, xc = kblocked_terms(F, sumF, csr, cfg, kc, fold)
    return grad, llh_nbr, cand_nbr_from_x(xc, csr, cfg)


def reset_launch_counts() -> None:
    """Set the launch counter of every K-blocked wrapper to 0."""
    for fn in (edge_dots_kb, grad_from_x_kb, cand_dots_kb, cand_nbr_from_x,
               cand_select_from_x):
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {
        "edge_dots_kb": edge_dots_kb.launches,
        "grad_from_x": grad_from_x_kb.launches,
        "cand_dots_kb": cand_dots_kb.launches,
        "cand_from_x": cand_nbr_from_x.launches,
        "cand_select_from_x": cand_select_from_x.launches,
    }
