"""Connected components of thresholded columns: batched min-label
propagation over the graph's directed edges, on a torch device.

Port of bigclam_tpu/ops/components.py. The quality pipeline's discrete
stage (models/quality.py atomize_reassign, repair_plan) needs the graph
components of EVERY thresholded column; the host path is a scipy call per
column over an induced-subgraph CSR, a K-long sequential scan. Here all
columns of a batch propagate together over the src-sorted edge arrays,
batched over columns to bound the (CB, E) working set.

Algorithm: min-label propagation with pointer jumping (path halving).

    labels0[v] = v if member[v] else N          (slot N = sentinel)
    per round:
      (1) edge relaxation — for each directed edge (s, d) with BOTH
          endpoints members, label[d] is offered to s; a segment-min
          (scatter_reduce_ "amin" over src) folds all offers per node;
      (2) pointer jumping — labels <- min(labels, labels[labels]): a
          member's label is always a member node id of the same component,
          so the label chain can be followed and halved.

The loop runs until no label changed: the JAX package's `while_loop` is a
host loop here, which reads one flag a round (one sync per round, as the
fold-in loop of ops/foldin.py pays one a step). Labels are minima, so they
are deterministic; sizes and internal edge counts are integer sums. All
three equal the JAX pass and the scipy oracle (models.quality
_graph_components) bit for bit.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from bigclam_tpu_torch.graph.csr import host_tensor

# below this many (node x column) cells the per-column host scipy path is
# faster than a device pass and its download; override with
# BIGCLAM_COMPONENTS=host|device (the JAX package's floor and hook)
DEVICE_MIN_CELLS = 1 << 21
# per-batch edge element budget: CB ~ EDGE_ELEM_BUDGET / E columns a batch,
# so the (CB, E) relaxation arrays stay bounded regardless of K
EDGE_ELEM_BUDGET = 1 << 26


def components_backend(
    num_nodes: int, num_cols: int, override: str = "auto", device=None
) -> str:
    """'host' (the scipy oracle) or 'device' (batched label propagation).
    `override` other than 'auto' wins; then the BIGCLAM_COMPONENTS env
    hook; then the auto rule, on the device the tensors live on: the CPU
    (or no device) gives host, the card gives device at or above
    DEVICE_MIN_CELLS (node x column) cells."""
    if override in ("host", "device"):
        return override
    env = os.environ.get("BIGCLAM_COMPONENTS", "")
    if env in ("host", "device"):
        return env
    if device is None or torch.device(device).type == "cpu":
        return "host"
    return (
        "device"
        if num_nodes * max(num_cols, 1) >= DEVICE_MIN_CELLS
        else "host"
    )


def _labels_and_stats(src, dst, member, n: int):
    """The pass for one column batch.

    src, dst: (E,) int64 directed edges, src sorted (CSR order).
    member:   (CB, n) bool, one thresholded column per row.
    Returns (labels, comp_size, comp_edges), each (CB, n) int32:
      labels[c, v]     min member node id of v's component (n if not member)
      comp_size[c, v]  node count of v's component (0 if not member)
      comp_edges[c, v] internal DIRECTED edge count of v's component
    """
    cb = member.shape[0]
    dev = member.device
    sentinel = n
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    lab0 = torch.where(member, iota[None, :], sentinel)
    # sentinel slot n: labels[n] = n, so pointer jumps through non-members
    # are fixed points
    labels = torch.cat(
        [lab0, torch.full((cb, 1), sentinel, dtype=torch.int32, device=dev)],
        dim=1,
    )
    ok_edge = member[:, src] & member[:, dst]          # (CB, E)
    src_b = src.expand(cb, -1)
    dst_b = dst.expand(cb, -1)
    while True:
        cand = torch.where(ok_edge, labels.gather(1, dst_b), sentinel)
        seg = torch.full_like(labels, sentinel).scatter_reduce_(
            1, src_b, cand, "amin"
        )
        new = torch.minimum(labels, seg)
        # pointer jumping; the min keeps a member's label decreasing
        # toward its component root
        new = torch.minimum(new, new.gather(1, new.long()))
        changed = bool((new != labels).any())          # one sync a round
        labels = new
        if not changed:
            break
    del cand, seg, new
    lab = labels[:, :n].long()
    sizes_root = torch.zeros_like(labels).scatter_add_(
        1, lab, member.to(torch.int32)
    )
    e_lab = torch.where(ok_edge, labels.gather(1, src_b), sentinel)
    edges_root = torch.zeros_like(labels).scatter_add_(
        1, e_lab.long(), (e_lab < sentinel).to(torch.int32)
    )
    del e_lab
    live = labels[:, :n] < sentinel
    comp_size = sizes_root.gather(1, labels.long())[:, :n]
    comp_edges = edges_root.gather(1, labels.long())[:, :n]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (
        labels[:, :n],
        torch.where(live, comp_size, zero),
        torch.where(live, comp_edges, zero),
    )


def device_edges(g, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The graph's directed-edge arrays as int64 tensors on `device` (one
    upload; callers that loop rounds hold on to the result)."""
    return host_tensor(g.src, np.int64, device), host_tensor(g.dst, np.int64, device)


def column_component_stats(
    member_cols,
    src_dev,
    dst_dev,
    num_nodes: int,
    col_batch: int = 0,
    as_numpy: bool = True,
):
    """Component labels + fused stats for every column of `member_cols`.

    member_cols: (C, N) bool, a numpy array or a tensor (on any device);
    rows are independent induced-subgraph membership masks, one per
    thresholded column. Columns run in batches of `col_batch` (auto:
    EDGE_ELEM_BUDGET / E) on the device of `src_dev`.

    Returns (labels, comp_size, comp_edges), (C, N) int32 each, as host
    numpy (as_numpy=True) or device tensors. labels[c, v] == num_nodes
    marks a non-member. The quality pipeline downloads these int32 arrays
    instead of F; nothing here reads F.
    """
    c_total = int(member_cols.shape[0])
    n = int(num_nodes)
    e = int(src_dev.shape[0])
    dev = src_dev.device
    if col_batch <= 0:
        col_batch = max(int(EDGE_ELEM_BUDGET // max(e, 1)), 1)
    cb = min(max(col_batch, 1), max(c_total, 1))
    outs: List[tuple] = []
    for lo in range(0, c_total, cb):
        hi = min(lo + cb, c_total)
        batch = member_cols[lo:hi]
        batch = (batch.to(dev, torch.bool) if isinstance(batch, torch.Tensor)
                 else host_tensor(batch, np.bool_, dev))
        lab, siz, cnt = _labels_and_stats(src_dev, dst_dev, batch, n)
        if as_numpy:
            lab, siz, cnt = (x.cpu().numpy() for x in (lab, siz, cnt))
        outs.append((lab, siz, cnt))
    if not outs:
        z = np.zeros((0, n), np.int32)
        if as_numpy:
            return z, z.copy(), z.copy()
        z = torch.from_numpy(z).to(dev)
        return z, z.clone(), z.clone()
    labs, sizs, cnts = zip(*outs)
    if as_numpy:
        return np.concatenate(labs), np.concatenate(sizs), np.concatenate(cnts)
    return torch.cat(labs), torch.cat(sizs), torch.cat(cnts)


def components_from_labels(
    labels_row: np.ndarray, num_nodes: int, min_size: int = 1
) -> List[np.ndarray]:
    """One column's label vector -> list of sorted member-id arrays
    (components ordered by root id; the host oracle orders by scipy label,
    so parity tests compare partitions, not list order). Copied from
    bigclam_tpu/ops/components.py."""
    lab = np.asarray(labels_row)
    members = np.flatnonzero(lab < num_nodes)
    if members.size == 0:
        return []
    labm = lab[members]
    order = np.argsort(labm, kind="stable")
    nodes_sorted = members[order]
    lab_sorted = labm[order]
    bounds = np.flatnonzero(np.r_[True, np.diff(lab_sorted) != 0])
    return [
        nodes_sorted[lo:hi]
        for lo, hi in zip(bounds, np.r_[bounds[1:], lab_sorted.size])
        if hi - lo >= min_size
    ]


def graph_components_device(
    mem: np.ndarray, g, src_dev=None, dst_dev=None, device=None
) -> List[List[int]]:
    """Device twin of models.quality._graph_components for ONE membership
    set: the same (members -> component lists) contract, components by
    root id. The oracle-parity surface; the quality pipeline calls
    column_component_stats to batch all columns."""
    m = np.asarray(mem, np.int64)
    if m.size == 0:
        return []
    if src_dev is None or dst_dev is None:
        src_dev, dst_dev = device_edges(g, device)
    n = g.num_nodes
    member = np.zeros((1, n), bool)
    member[0, m] = True
    labels, _, _ = column_component_stats(member, src_dev, dst_dev, n)
    return [c.tolist() for c in components_from_labels(labels[0], n)]
