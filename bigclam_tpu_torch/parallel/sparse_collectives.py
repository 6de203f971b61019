"""The sparse allreduce of the sharded sparse trainer (arXiv:1312.3020).

Port of bigclam_tpu/parallel/sparse_collectives.py (the 1D exchange; the
2D partition's `closure_grad_allreduce` waits for the 2D trainer). The
dense mesh steps psum a (K,) sumF every iteration. On the sparse
representation a shard's contribution touches only the communities
present in ITS member lists, so the collective exchanges (id, value)
pairs of the touched communities only, in fixed-capacity buffers:

    compact:   a shard's dense (K,) contribution -> (cap,) touched ids
               and values, sentinel-padded (a stable sort of the
               presence mask: no host sync, the ids in ascending order as
               jnp.nonzero gives them)
    exchange:  ONE all-gather of the (cap,) id/value buffers
               (parallel/sharded.py `all_gather`)
    combine:   on each distinct device, every shard's pairs scattered
               into a (K,) buffer of its own, the buffers added in shard
               order

On a single-controller mesh (parallel/mesh.py) the collectives are
sequences of copies between the shards' devices, as the dense helpers
`psum` and `all_gather` are; on a multi-process one their Axis carries
the process group and the gathers and `pmax` cross ranks
(parallel/multihost.py `exchange`), so the host read of the worst count
is every rank's, and every rank takes the same branch. The combine adds in the order
`psum` adds the shards' partials, and an untouched community adds an
exact 0, so the sparse exchange and the dense psum give the same bits
on every device; an index_add_ of all shards' pairs into one (K,) vector
would not (its atomic order varies between runs on a card).

OVERFLOW: the touched set only changes at support updates, but an
admission burst can exceed the build-time cap. The compaction counts
its touched ids, a pmax takes the worst shard's count, and the host
reads it (once per exchange: the JAX `lax.cond` becomes a host branch)
and falls back to the dense psum FOR THAT STEP when it exceeds the cap.
Correctness never depends on the cap, only the exchange volume does.
Callers above a density threshold (cfg.sparse_dense_fallback) build the
step with the dense psum instead (static_mode), and pay no host read.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

from bigclam_tpu_torch.obs import comms as _comms
from bigclam_tpu_torch.parallel import multihost as _mh
from bigclam_tpu_torch.parallel.sharded import _nbytes, all_gather, psum

# comms sites of the exchange (the JAX site names, obs.comms
# sparse_step_model)
SITE_TOUCHED = "sparse/allreduce_touched"
SITE_COUNT = "sparse/pmax_touched_count"
SITE_SUMF = "sparse/psum_sumF"


# --- host functions (copied from bigclam_tpu/parallel/sparse_collectives.py)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def exchange_payload_bytes(cap: int, itemsize: int = 4) -> int:
    """Local bytes ONE shard contributes to the sparse-allreduce
    exchange: the (cap,) int32 id buffer plus the (cap,) value buffer.
    The WIRE cost of the sparse branch is this cap-sized pair regardless
    of how many ids are actually touched (occupancy below cap is
    headroom, not saved bytes) — the single payload formula the comms
    accounting (obs.comms) and the trainer's modeled-vs-measured
    reconciliation both price the exchange with."""
    return int(cap) * (4 + int(itemsize))


def auto_cap(
    touched_per_shard: int, k_pad: int, slack: float, m: int
) -> int:
    """Exchange-buffer capacity from the initial worst-shard touched
    count: slack headroom for support growth, at least one M row, never
    beyond K (cap == K degenerates to a dense-sized exchange)."""
    est = max(int(touched_per_shard), 1)
    return min(k_pad, _round_up(max(int(slack * est), m, 8), 8))


def static_mode(cap: int, k_pad: int, density_threshold: float) -> str:
    """'sparse' when the capped exchange is worth it, 'dense' when the
    cap already covers >= density_threshold of K (the psum moves fewer
    bytes than 2*cap id/value pairs would)."""
    if k_pad <= 0 or cap >= max(1.0, density_threshold * k_pad):
        return "dense"
    return "sparse"


# --- device functions ---------------------------------------------------------


def compact_touched(
    vals: torch.Tensor, pres: torch.Tensor, cap: int, k_pad: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(touched ids (cap,) int32 in ascending order, sentinel-padded with
    k_pad; their values (cap,); the 0-d int32 touched count). Ids beyond
    cap are DROPPED here — the caller's overflow branch is what keeps that
    correct. A stable sort puts the touched ids first, in ascending order
    (as jnp.nonzero lists them): no host sync, no scatter."""
    order = torch.argsort((~pres).to(torch.uint8), stable=True)[:cap]
    tids = torch.where(pres[order], order,
                       torch.full_like(order, k_pad)).to(torch.int32)
    if tids.shape[0] < cap:
        tids = torch.cat([tids, torch.full((cap - tids.shape[0],), k_pad,
                                           dtype=torch.int32, device=tids.device)])
    ok = tids < k_pad
    tvals = torch.where(ok, vals[tids.clamp_max(k_pad - 1).long()],
                        torch.zeros((), dtype=vals.dtype, device=vals.device))
    return tids, tvals, pres.sum().to(torch.int32)


def pmax(parts, devices, site: str = "") -> list:
    """The largest of the shards' partials, taken on the first device and
    copied to every shard's device (counted as `psum` counts: each other
    position's partial in, the result back out)."""
    group = getattr(devices, "group", None)
    if group is not None:
        parts = _mh.exchange(parts, group)
    top = parts[0].to(devices[0])
    for p in parts[1:]:
        top = torch.maximum(top, p.to(devices[0]))
    if _comms.counting_on() and len(parts) > 1:
        _comms.count(site, sum(_nbytes(p) for p in parts[1:])
                     + (len(parts) - 1) * _nbytes(top))
    return [top.to(d) for d in devices]


def capped_exchange(
    dense_fn: Callable[[], list],
    sparse_fn: Callable[[], list],
    counts: List[torch.Tensor],
    cap: int,
    devices: list,
    count_site: str = SITE_COUNT,
) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """The touched-ids exchange skeleton: pmax the shards' touched
    `counts` (comms site `count_site`), read the maximum on the host, run
    `sparse_fn` when every shard fits the build-time `cap` and `dense_fn`
    otherwise, FOR THIS STEP. Returns (the result on each shard's device,
    the max count, the dense-fallback flag, both 0-d int32 on the first
    device) — the counter pair the gates read."""
    max_count = pmax(counts, devices, count_site)[0]
    overflow = int(max_count) > cap
    out = dense_fn() if overflow else sparse_fn()
    flag = torch.tensor(int(overflow), dtype=torch.int32, device=devices[0])
    return out, max_count, flag


def _combine(tids: torch.Tensor, tvals: torch.Tensor, dp: int, cap: int,
             k_pad: int) -> torch.Tensor:
    """The gathered (dp * cap,) pairs summed into a (K,) vector: shard
    i's pairs added into a zero buffer of its own (its ids are distinct,
    so each entry takes one value, and every sentinel carries 0: exact
    whatever the order of the adds), the buffers added in shard order."""
    total = None
    for i in range(dp):
        buf = torch.zeros(k_pad + 1, dtype=tvals.dtype, device=tvals.device)
        buf.index_add_(0, tids[i * cap:(i + 1) * cap].long(),
                       tvals[i * cap:(i + 1) * cap])
        total = buf[:k_pad] if total is None else total + buf[:k_pad]
    return total


def sparse_allreduce_sum(
    vals: List[torch.Tensor],
    pres: List[torch.Tensor],
    cap: int,
    k_pad: int,
    devices: list,
) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """Allreduce of the shards' dense (K_pad,) contributions `vals`
    exchanging only touched community ids (`pres`: each shard's presence
    mask, ops.sparse_members.presence). Returns (the sums on each shard's
    device, the max touched count over shards, the dense-fallback flag) —
    the last two are the exchange-volume counters the gates assert on."""
    compact = [compact_touched(v, p, cap, k_pad) for v, p in zip(vals, pres)]

    def dense_fn():
        return psum(vals, devices, SITE_SUMF)

    def sparse_fn():
        tids = all_gather([c[0] for c in compact], devices, SITE_TOUCHED)
        tvals = all_gather([c[1] for c in compact], devices, SITE_TOUCHED)
        out = {}
        for d, t, v in zip(devices, tids, tvals):
            if d not in out:
                # every shard's pairs, those of other ranks' too
                out[d] = _combine(t, v, t.shape[0] // cap, cap, k_pad)
        return [out[d] for d in devices]

    return capped_exchange(dense_fn, sparse_fn, [c[2] for c in compact],
                           cap, devices)


def psum_allreduce_sum(
    vals: List[torch.Tensor], pres: List[torch.Tensor], devices: list,
) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """The static-psum form (static_mode 'dense'): the dense psum of
    `vals`, the max touched count for the counters, and the flag 1 — the
    JAX step's psum branch, with no host read."""
    sums = psum(vals, devices, SITE_SUMF)
    counts = [p.sum().to(torch.int32) for p in pres]
    max_count = pmax(counts, devices, SITE_COUNT)[0]
    return sums, max_count, torch.ones((), dtype=torch.int32, device=devices[0])


# --- the 2D partition's gradient exchange ------------------------------------


def closure_grad_allreduce(
    partials: List[torch.Tensor],
    out_tabs: List[torch.Tensor],
    in_tabs: List[torch.Tensor],
    counts: List[torch.Tensor],
    cap: int,
    devices: list,
    site: str,
    count_site: str,
) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """Touched-rows-only replacement for the 2D trainer's dense
    neighbour-gradient psum over one processor row's C positions (JAX
    `closure_grad_allreduce`, single-controller). partials[j] is position
    j's dense (n_row, K) partial on devices[j]; out_tabs[j] (C, cap) the
    group-local rows of block c its edges touched (sentinel n_row);
    in_tabs[j] (C, cap) the rows of its own block that position c touched
    (block-local, sentinel n_blk); counts[j] its true worst pair size.

      phase A: position j sends peer c the partial rows of block c it
               touched; each position adds what it receives into a zero
               (n_blk, K) accumulator, in position order — the
               cols-complete sums of its own rows;
      phase B: the reverse route: position c sends every toucher j the
               summed rows j touched; j scatters them into a zero
               (n_row, K) and overwrites its own block's slot with its
               accumulator.

    Every real row of one table is distinct, so each add writes one value
    and the accumulator takes the partials in position order, as `psum`
    adds them: the result is the psum's bits in every row a position
    touched and in its own block (an untouched partial is an exact 0).
    Rows a position neither touched nor owns stay 0 (nothing reads them).
    When a position's count exceeds `cap` the whole row group takes the
    dense psum FOR THIS STEP (capped_exchange), counted at `site` as the
    exchange is. Returns (the result on each position's device, the max
    count, the dense-fallback flag)."""
    C = len(partials)
    n_row, k = partials[0].shape
    n_blk = n_row // C

    def dense_fn():
        return psum(partials, devices, site)

    def routed(src, tabs, limit, dst_of):
        """send[j][c]: the rows tabs[j][c] names of src[j] (sentinel rows
        0), moved to position c; counted as one all_to_all."""
        out = [[None] * C for _ in range(C)]
        for j in range(C):
            t = tabs[j].reshape(-1)
            rows = src[j].index_select(0, t.clamp_max(limit - 1))
            buf = rows.masked_fill_((t >= limit)[:, None], 0).reshape(C, cap, k)
            for c in range(C):
                out[c][j] = buf[c].to(dst_of(c))
        if _comms.counting_on():
            _comms.count(site, C * (C - 1) * cap * k * partials[0].element_size())
        return out

    def sparse_fn():
        recv = routed(partials, out_tabs, n_row, lambda c: devices[c])
        blk = []
        for c in range(C):
            acc = torch.zeros((n_blk + 1, k), dtype=partials[c].dtype,
                              device=devices[c])
            for j in range(C):
                acc.index_add_(0, in_tabs[c][j], recv[c][j])
            blk.append(acc[:n_blk])
        del recv
        back = routed(blk, in_tabs, n_blk, lambda j: devices[j])
        out = []
        for j in range(C):
            full = torch.zeros((n_row + 1, k), dtype=partials[j].dtype,
                               device=devices[j])
            for c in range(C):
                full.index_add_(0, out_tabs[j][c], back[j][c])
            full[j * n_blk : (j + 1) * n_blk] = blk[j]
            out.append(full[:n_row])
        return out

    return capped_exchange(dense_fn, sparse_fn, counts, cap, devices, count_site)
