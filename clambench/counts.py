"""The cost of each unit of work, from the sizes alone: float32 operations
and bytes moved, and the least time an H100 could take for them.

Frozen from the port's proof script (`chip_smoke.py` `bounds` and
`member_bound`, as of the first benchmark) so that the yardstick cannot
move with the program. Bytes count each input read once and each output
written once, whatever a kernel reads again; operations count what these
inputs need. The least time is the larger of operations over the float32
peak and bytes over the HBM rate. A kernel added later gets a count file
of its own beside this one.

Sizes: n nodes, e directed edges (2E), k live communities (not padded),
m member slots, s Armijo candidates (16).
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least(nbytes: float, ops: float) -> dict:
    """{"bound_ms", "bound_by", "bytes", "ops"} of one unit of work."""
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return {"bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops}


def _fused_work(n: int, e: int, k: int, s: int) -> tuple:
    """(bytes, ops) of the fused superstep's work. Per directed edge the
    dot and the gradient accumulation are 4K operations (+3 for expm1, log
    and the division), each candidate's dot nf_s . F_v 2K (+2); nf_s =
    clip(F_u + eta_s g_u) depends on u alone. Per node: fold and tail 6K,
    nf_s and its tail 6K a candidate, the selection 6K. Bytes: F and the
    CSR read, F_new and the gradient written, the node LLH and the (S, n)
    acceptance mask."""
    f4 = 4.0 * n * k
    csr_bytes = 8.0 * (n + 1) + 4.0 * e + 4.0 * k
    ops = (e * (4.0 * k + 3) + n * 6.0 * k
           + e * s * (2.0 * k + 2) + n * s * 6.0 * k + n * 6.0 * k)
    return f4 + csr_bytes + 2 * f4 + 4.0 * n + 1.0 * s * n, ops


def fused_superstep_bound(n: int, e: int, k: int, s: int) -> dict:
    """Least time of one fused-superstep launch over the whole graph."""
    return least(*_fused_work(n, e, k, s))


def member_bound(n: int, e: int, m: int) -> dict:
    """Least time of one member-lookup sweep over e edges at m slots: the n
    state rows read once (ids and weights, 8 bytes a slot), src and dst
    (16 bytes an edge) and the (e, m) float32 output written once; the
    binary-search compares (log2 m + 1 a slot) over the float32 rate, as
    the card's table names no int32 rate."""
    return least(8.0 * n * m + 16.0 * e + 4.0 * e * m,
                 e * m * (math.log2(m) + 1.0))


def dense_step(n: int, e: int, k: int, s: int) -> dict:
    """Least time of one whole dense iteration, whatever implements it: F,
    sumF and the CSR read once, F_new and its column sums written once;
    the fused superstep's operations plus the column sums (K a node)."""
    f4 = 4.0 * n * k
    nbytes = f4 + 8.0 * (n + 1) + 4.0 * e + 4.0 * k + f4 + 4.0 * k
    ops = _fused_work(n, e, k, s)[1] + n * 1.0 * k
    return least(nbytes, ops)


def sparse_step(n: int, e: int, m: int, k: int, s: int) -> dict:
    """Least time of one whole sparse iteration: the member state (ids and
    weights, 8 bytes a slot) and the CSR read once, the new state and sumF
    written once. Operations: the support update's neighbour rank sums
    (one add a neighbour slot, one an own slot), one member lookup a
    directed edge (log2 m + 1 a slot), the dot and the gradient in slot
    space (4M + 3 an edge) with the fold and tail (6M a node), each
    candidate's dot (2M + 2 an edge) and its nf_s and tail (6M a node),
    the selection (6M a node) and the column sums (M a node)."""
    nbytes = 8.0 * n * m + 8.0 * (n + 1) + 4.0 * e + 8.0 * n * m + 4.0 * k
    ops = (e * m + n * m
           + e * m * (math.log2(m) + 1.0)
           + e * (4.0 * m + 3) + n * 6.0 * m
           + e * s * (2.0 * m + 2) + n * s * 6.0 * m
           + n * 6.0 * m + n * 1.0 * m)
    return least(nbytes, ops)
