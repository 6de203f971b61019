"""Quality mode: noise-floor init, restart annealing, discrete repair and
atomize re-tiling, on the host loop and device-resident.

Port of bigclam_tpu/models/quality.py (read its module docstring for the
measurements behind each mechanism). A flag-gated extension of the
reference (cfg.quality_mode, default off = exact parity): with faithful
semantics every node whose F row is all zero is frozen forever (its
gradient is -sumF <= 0, which clips back to zero), so unseeded blocks never
acquire mass. Quality mode escapes that fixed point:

  1. noise floor + restart annealing: each cycle kicks the kept F with
     U(0, eps) on the live (num_nodes, kick_cols) block and refits; a cycle
     is kept only when its converged LLH improves, and the loop stops after
     cfg.restart_patience cycles below cfg.restart_tol;
  2. MAX_P_ relaxation: during the cycles the probability clip is
     1 - avg_deg/(16 N) (auto_quality_max_p) instead of the parity 0.9999,
     so a noise-level entry can grow; the trainer rebuilds its step with
     the relaxed clip (rebuild_step) and gets the parity step back after;
  3. the discrete stage (_repair_stage): atomize re-tiling
     (atomize_reassign) and merge/split repair (repair_communities), each
     refit and kept only on LLH gain, a round at a time.

`fit_quality` is the host loop (numpy kicks from the streams
[seed, 0x5EED, cycle] and [seed, 0xF17, round, polish], the JAX package's,
so its schedule reproduces JAX's in float64). `fit_quality_device` keeps F
on the device through the whole schedule: one upload, kicks drawn on the
device (DeviceNoise), repairs applied as scatter edits, every refit
through the trainer's state-resident `fit_state(reset_state(F))`, at most
one full-F fetch a repair round plus the final one. The component passes
of the discrete stage run on the trainer's device through ops.components
(scipy on the CPU).

Works with every dense trainer: BigClamModel and the all-gather and ring
mesh trainers (whose state F is a tuple of per-shard row blocks in the
internal row order; edits arrive in original ids and map through the
trainer's `_perm`). The CLI refuses the sparse representation, as the JAX
CLI does, and the store-native trainers, which hold no global CSR for the
discrete stage.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from bigclam_tpu_torch.models.bigclam import FitResult
from bigclam_tpu_torch.parallel.mesh import state_blocks
from bigclam_tpu_torch.utils.dist import is_primary


def _cycle_event(cycle: int, llh: float, kept: bool, iters: int) -> None:
    """Telemetry for one annealing cycle (host and device schedules share
    this): `cycle` events make the restart dynamics — which kicks were
    kept, how long each cycle annealed — readable from events.jsonl, and
    each completed cycle beats the stall heartbeat."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is None:
        return
    tel.event(
        "cycle", cycle=int(cycle), llh=float(llh), kept=bool(kept),
        iters=int(iters),
    )
    if tel.heartbeat is not None:
        tel.heartbeat.beat(cycle=int(cycle), llh=float(llh))


def auto_quality_max_p(
    num_nodes: int, avg_deg: float, floor: float = 0.0
) -> float:
    """The auto MAX_P_ relaxation rule (single source — quality_gate.py
    records it too): amp = 16*N/avg_deg covers node degrees down to
    avg/16. `floor` is the parity max_p (never relax BELOW it); the
    1-1e-15 ceiling applies to the combined value — even a floor above it
    is clamped. The ceiling is where max_p itself stops being f64-
    representable (1 - 1e-16 rounds to 1.0 and 1-max_p = 0 poisons the
    clip); the KERNELS no longer impose a floor at all — edge_terms forms
    1-p as -expm1(-x), exact to f32 relative eps at any amplification
    (see config.quality_max_p)."""
    amp = 16.0 * num_nodes / max(avg_deg, 1.0)
    return min(max(floor, 1.0 - 1.0 / amp), 1.0 - 1e-15)


def _relax_params(model, n_live: int) -> Tuple[float, float]:
    """(relaxed MAX_P_, kick scale eps) for this model's graph — shared by
    the host (fit_quality) and device (fit_quality_device) annealing loops.

    MAX_P_ relaxation: the clip caps the gradient's 1/(1-p) neighbor
    amplification; a noise-level column entry at node u only grows when
    deg(u)*amp > N (its neighbor term must beat -sumF), so the parity
    0.9999 freezes every kick dead once N > 1e4*avg_deg (the K=5000
    gate's original failure: 4 gainless cycles, F1 0.001). Auto rule in
    auto_quality_max_p; explicit overrides validated against the f64
    representability ceiling here. Kick scale: the kick's per-column
    sumF contribution
    (~eps*N/2) must stay comparable to one seeded ego-net column's mass
    (~avg_degree + 1) regardless of N (see config.init_noise).
    """
    cfg = model.cfg
    avg_deg = model.g.num_directed_edges / max(model.g.num_nodes, 1)
    max_p_q = cfg.quality_max_p
    if max_p_q is None:
        max_p_q = auto_quality_max_p(
            model.g.num_nodes, avg_deg, floor=cfg.max_p
        )
    elif not (0.0 < max_p_q <= 1.0 - 1e-15):
        # beyond 1-1e-15 the f64 value of max_p rounds toward 1.0 and the
        # host-computed clip floor 1-max_p collapses to 0: log(0) = -inf
        # poisons every cycle's LLH and NaN defeats the patience stop —
        # fail fast instead of burning restart_cycles of chip time
        raise ValueError(
            f"quality_max_p={max_p_q} out of range (need 0 < p <= 1-1e-15, "
            "the f64 representability floor of 1-max_p)"
        )
    elif max_p_q < cfg.max_p:
        # sub-floor pinning TIGHTENS the clip mid-quality-run; measured to
        # collapse recovery (F1 0.045 at amp=100, N=2400). Legal as an
        # explicit measurement hook, but never what a production run wants.
        warnings.warn(
            f"quality_max_p={max_p_q} is BELOW the parity clip "
            f"max_p={cfg.max_p}: the quality run will use a TIGHTER clip "
            "than the faithful fit (gradient amplification capped at "
            f"{1.0 / (1.0 - max_p_q):.3g}). This collapses recovery except "
            "as a deliberate measurement hook.",
            stacklevel=2,
        )
    eps = (
        cfg.init_noise
        if cfg.init_noise is not None
        else min(
            0.02, cfg.init_noise_mass * (avg_deg + 1.0) / max(n_live, 1)
        )
    )
    return max_p_q, eps


def _graph_components(mem: np.ndarray, indptr, indices) -> List[List[int]]:
    """Connected components of the subgraph induced by `mem` — shared by
    repair_communities (fat-column splits) and atomize_reassign (which
    calls it for EVERY thresholded column, so per-edge Python scans are
    out of budget at com-Amazon K~5k). Vectorized: induced-subgraph CSR
    via one flat neighbor gather + searchsorted remap, then
    scipy.sparse.csgraph.connected_components; iterative-BFS fallback
    when scipy is absent."""
    m = np.asarray(mem, np.int64)
    if m.size == 0:
        return []
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import connected_components
    except ImportError:
        return _graph_components_bfs(m, indptr, indices)
    nbr = _gather_neighbors(m, indptr, indices)
    deg = indptr[m + 1] - indptr[m]
    srcs = np.repeat(np.arange(m.size), deg)
    loc = np.searchsorted(m, nbr)              # mem is sorted (flatnonzero)
    ok = (loc < m.size) & (m[np.minimum(loc, m.size - 1)] == nbr)
    a = csr_matrix(
        (np.ones(int(ok.sum()), np.int8), (srcs[ok], loc[ok])),
        shape=(m.size, m.size),
    )
    _, labels = connected_components(a, directed=False)
    order = np.argsort(labels, kind="stable")
    bounds = np.flatnonzero(np.r_[True, np.diff(labels[order]) != 0])
    return [
        m[order[lo:hi]].tolist()
        for lo, hi in zip(bounds, np.r_[bounds[1:], order.size])
    ]


def _graph_components_bfs(mem: np.ndarray, indptr, indices) -> List[List[int]]:
    """Pure-Python fallback (no scipy): iterative BFS over CSR adjacency."""
    mset = set(mem.tolist())
    seen, comps = set(), []
    for s0 in mem.tolist():
        if s0 in seen:
            continue
        stack, comp = [int(s0)], []
        seen.add(s0)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in indices[indptr[u] : indptr[u + 1]]:
                v = int(v)
                if v in mset and v not in seen:
                    seen.add(v)
                    stack.append(v)
        comps.append(comp)
    return comps


def _gather_neighbors(nodes: np.ndarray, indptr, indices) -> np.ndarray:
    """Concatenated CSR adjacency of `nodes` in one flat fancy-index
    (position arange offset by each row's start) — the shared gather under
    both density counters below."""
    starts, ends = indptr[nodes], indptr[nodes + 1]
    deg = ends - starts
    total = int(deg.sum())
    if total == 0:
        return indices[:0]
    off = np.repeat(np.cumsum(deg) - deg, deg)
    return indices[np.repeat(starts, deg) + (np.arange(total) - off)]


def _internal_density(members: np.ndarray, indptr, indices) -> float:
    """Directed within-set edge density cnt/(s(s-1)) via one flat
    neighbor gather + sort-based isin."""
    m = np.asarray(members)
    if m.size < 2:
        return 0.0
    nbr = _gather_neighbors(m, indptr, indices)
    if nbr.size == 0:
        return 0.0
    cnt = int(np.isin(nbr, m).sum())
    return cnt / (m.size * (m.size - 1))


def _column_atoms_host(
    mask: np.ndarray, indptr, indices, min_comp: int
) -> List[Tuple[np.ndarray, Optional[float]]]:
    """Per-column atoms via the host scipy oracle (_graph_components) —
    the small-problem path and the parity reference for the device
    backend. Density is deferred (None): computed later for KEPT atoms
    only (one bounded _internal_density gather each)."""
    atoms: List[Tuple[np.ndarray, Optional[float]]] = []
    for c in range(mask.shape[1]):
        mem = np.flatnonzero(mask[:, c])
        if mem.size < min_comp:
            continue
        for comp in _graph_components(mem, indptr, indices):
            if len(comp) >= min_comp:
                atoms.append((np.sort(np.asarray(comp, np.int64)), None))
    return atoms


def _column_atoms_device(
    member_cols, g, min_comp: int, edges_dev=None, device=None
) -> List[Tuple[np.ndarray, Optional[float]]]:
    """Per-column atoms via the batched device label-propagation pass
    (ops.components) on `device` (the device of `edges_dev` when given):
    one batched pass covers every thresholded column, with component
    sizes and internal edge counts fused into it, so atom densities come
    from device reductions instead of host edge scans. `member_cols` is
    (C, N) bool, a host array or a tensor (the device quality path passes
    the thresholded F slice without downloading F; only int32 label/stat
    arrays cross to the host)."""
    from bigclam_tpu_torch.ops.components import (
        column_component_stats,
        components_from_labels,
        device_edges,
    )

    n = g.num_nodes
    if edges_dev is None:
        edges_dev = device_edges(g, device)
    labels, _sizes, counts = column_component_stats(
        member_cols, edges_dev[0], edges_dev[1], n
    )
    atoms: List[Tuple[np.ndarray, Optional[float]]] = []
    for c in range(labels.shape[0]):
        for comp in components_from_labels(labels[c], n, min_size=min_comp):
            s = comp.size
            # root label == min member id == comp[0] (components_from_labels
            # returns sorted members), so the fused stats index directly
            cnt = int(counts[c][comp[0]])
            d = cnt / (s * (s - 1)) if s > 1 else 0.0
            atoms.append((comp.astype(np.int64), d))
    return atoms


def _plan_atoms(
    atoms: List[Tuple[np.ndarray, Optional[float]]], n: int, ka: int
) -> List[Tuple[np.ndarray, Optional[float]]]:
    """Greedy largest-first dedupe + column assignment, shared by both
    component backends. Size ties break on min member id — a DETERMINISTIC
    order independent of the backend's collection order (host: scipy label
    order per column; device: root id per column), so the kept-atom set is
    identical across backends (pinned by test_components.py)."""
    atoms.sort(key=lambda a: (-len(a[0]), int(a[0][0])))
    kept: List[Tuple[np.ndarray, Optional[float]]] = []
    owner = np.full(n, -1, np.int64)
    for at, d in atoms:
        if len(kept) >= ka:
            break
        owners = owner[at]
        hit = owners[owners >= 0]
        if hit.size:
            _, counts = np.unique(hit, return_counts=True)
            if counts.max() >= 0.5 * at.size:
                continue          # majority-duplicate of a kept atom
        unowned = at[owners < 0]
        owner[unowned] = len(kept)
        kept.append((at, d))
    return kept


def _atom_strength(at: np.ndarray, d: Optional[float], indptr, indices
                   ) -> float:
    """AGM-consistent seed strength s = sqrt(-log(1-d)); the host backend
    defers density (d=None) to a bounded gather here."""
    if d is None:
        d = _internal_density(at, indptr, indices)
    d = min(max(float(d), 0.05), 0.95)
    return float(np.sqrt(-np.log1p(-d)))


def atomize_reassign(
    F: np.ndarray,
    g,
    delta: float,
    k_active: int,
    min_comp: int = 5,
    components: str = "auto",
    device=None,
) -> Tuple[np.ndarray, int]:
    """Discrete re-tiling move (cfg.quality_reassign): shatter every
    thresholded column into its graph components ("atoms"), dedupe atoms
    that majority-overlap an already-kept one (largest first), and
    re-seed the K columns on the kept atoms at their AGM-consistent
    strength s = sqrt(-log(1-d)) (d = atom's internal edge density — for
    a planted p_in=0.3 block this is the 0.597 the prototype validated).

    Why it exists (PARITY.md small-community account + the round-5
    planted anchor, MIDSCALE_ANCHOR_r05.json): annealing's plateau at
    24-node blocks consists of SHIFTED partitions — each column one
    block plus a shard of a neighbor — and gradient dynamics cannot
    unshift them, while the likelihood optimum band (planted F and its
    near-degenerate re-tilings) sits 7-10% of LLH above. Shattering to
    components + refit reaches that band (measured: -173.8K -> -156.26K
    at N=12K K=500 p_in=0.3, 2 accepted rounds). The caller refits and
    LLH-gates, so the move can only improve the model's own objective;
    at sub-identifiability p_in the extracted F1 may move either way
    (documented in PARITY.md) because the band is F1-degenerate.

    `components` picks the per-column connected-components backend
    (ops.components.components_backend): "host" = the scipy oracle (one
    induced-subgraph scan per column — the round-5 quality-stage cost),
    "device" = one batched label-propagation pass over all columns with
    fused density stats on `device`, "auto" = device on a card above the
    work-size threshold. The two backends produce the same atom PARTITION; kept-atom choice can
    differ on exact size ties (both orders are valid and LLH-gated).

    Returns (reassigned F, number of kept atoms); num_atoms == 0 means
    nothing to do (no thresholded structure).
    """
    from bigclam_tpu_torch.ops.components import components_backend

    F = np.asarray(F, np.float64)
    n = g.num_nodes
    ka = int(k_active)
    mask = F[:n, :ka] >= delta
    indptr, indices = g.indptr, g.indices
    if components_backend(n, ka, components, device) == "device":
        atoms = _column_atoms_device(mask.T, g, min_comp, device=device)
    else:
        atoms = _column_atoms_host(mask, indptr, indices, min_comp)
    if not atoms:
        return F.copy(), 0
    kept = _plan_atoms(atoms, n, ka)
    F_new = np.zeros_like(F)
    for c, (at, d) in enumerate(kept):
        F_new[at, c] = _atom_strength(at, d, indptr, indices)
    return F_new, len(kept)


def repair_plan(
    F: np.ndarray,
    g,
    delta: float,
    k_active: int,
    min_comp: int = 5,
    strength: float = 1.0,
    components: str = "auto",
    edges_dev=None,
    device=None,
) -> Tuple[list, int]:
    """Merge+split repair DETECTION over the thresholded communities —
    returns the edit list implementing one repair pass without touching F.

    Gradient dynamics cannot move a whole column across the graph, so two
    stable defect classes survive annealing (diagnosed on the planted
    probe): (a) a FAT column whose threshold members span multiple
    graph components (a merged community — its pieces share no edges),
    and (b) a PAIR of columns tiling one densely-connected region (two
    fragments of one community). The fix is one discrete move: merge each
    dense fragment pair into one column (freeing the other) and re-seed
    every freed column on an extra component of a fat column. The caller
    refits and accepts on LLH.

    Detection cost: O(N*K) vectorized mask/top-2 work (the dominant term
    — ~2e9 element ops at com-Amazon N=335K K=5120, seconds of host
    time) plus O(E) edge counting and component scans over fat columns
    only (batched on the device backend — see `components`, the same
    backend switch as atomize_reassign). Cross/within column edge counts
    use each node's top-2 above-threshold columns (exact for <= 2
    memberships, a subsample for more); nominees are verified with an
    exact exclusive-to-exclusive density scan.
    Only columns < k_active are touched (the K-sweep's padding columns
    must stay zero).

    Returns (edits, repairs): edits is an ORDERED list of
    ("clear", col) and ("set", rows, col, value) steps.
    repair_communities applies them to a host F; the device repair stage
    (fit_quality_device) applies them to the RESIDENT F as scatter
    updates — index vectors cross the host boundary, F does not.
    """
    F = np.asarray(F, np.float64)
    n = g.num_nodes
    ka = int(k_active)
    Fa = F[:n, :ka]
    mask = Fa >= delta
    sizes = mask.sum(axis=0)
    if not sizes.any():
        return [], 0
    # top-2 above-threshold columns per node
    if ka >= 2:
        top2 = np.argpartition(-Fa, 1, axis=1)[:, :2]
    else:
        top2 = np.zeros((n, 2), np.int64)
    valid = np.take_along_axis(Fa, top2, axis=1) >= delta
    # cross/within edge counts over the 4 (slot_u, slot_v) combos
    keys = []
    for su in range(2):
        for sv in range(2):
            m = valid[g.src, su] & valid[g.dst, sv]
            keys.append(
                top2[g.src[m], su].astype(np.int64) * ka
                + top2[g.dst[m], sv]
            )
    uk, uc = np.unique(np.concatenate(keys), return_counts=True)
    ca, cb = uk // ka, uk % ka
    within = np.zeros(ka)
    within[ca[ca == cb]] = uc[ca == cb]
    # within counts are DIRECTED (each undirected edge twice), normalized
    # by ordered pairs — i.e. plain undirected density, the same scale as
    # excl_cross_density's unordered cnt/(|ea|*|eb|) below
    dens_w = within / np.maximum(sizes * (sizes - 1), 1)
    cross: dict = {}
    for a, b, e in zip(ca, cb, uc):
        if a != b:
            key = (min(int(a), int(b)), max(int(a), int(b)))
            cross[key] = cross.get(key, 0) + int(e)
    members = [np.flatnonzero(mask[:, c]) for c in range(ka)]
    msets = [set(m.tolist()) for m in members]
    # merge candidates: the coarse cross counts (which include edges
    # incident to SHARED members, inflating genuine-overlap pairs) only
    # nominate; each nominee is verified with the EXACT
    # exclusive-to-exclusive edge density — the clean discriminator,
    # because two genuinely overlapping communities have (near-)zero
    # edges between their exclusive parts while two fragments of one
    # community are densely cross-connected at any overlap level.
    #   rule 1 (duplicates): inter/min >= 0.5
    #   rule 2 (fragments):  exact d_excl >= 0.25 * min(within density)
    indptr, indices = g.indptr, g.indices

    def excl_cross_density(a: int, b: int) -> float:
        # vectorized exact count: gather the concatenated adjacency of the
        # smaller exclusive side in one fancy-index, membership-test it
        # against the other side with one sort-based np.isin — O((deg_sum
        # + |other|) log) instead of a per-edge Python set scan (which at
        # com-Amazon K~5k grew the detector's worst case to minutes)
        ma, mb = members[a], members[b]          # sorted unique
        ea = np.setdiff1d(ma, mb, assume_unique=True)
        eb = np.setdiff1d(mb, ma, assume_unique=True)
        if ea.size == 0 or eb.size == 0:
            return 0.0
        small, other = (ea, eb) if ea.size <= eb.size else (eb, ea)
        nbr = _gather_neighbors(small, indptr, indices)
        if nbr.size == 0:
            return 0.0
        cnt = int(np.isin(nbr, other, assume_unique=False).sum())
        return cnt / (ea.size * eb.size)

    merges, used = [], set()
    nominees = sorted(cross.items(), key=lambda kv: -kv[1])[: 4 * ka]
    for (a, b), _e in nominees:
        la, lb = len(msets[a]), len(msets[b])
        if not la or not lb or a in used or b in used:
            continue
        inter_frac = len(msets[a] & msets[b]) / min(la, lb)

        def dense_excl(a=a, b=b):      # exact scan only when rule 1
            d = excl_cross_density(a, b)       # didn't already decide
            return d >= 0.25 * min(dens_w[a], dens_w[b]) and d > 0.025

        # rule 1 (duplicates/straddling fragments): heavy member overlap.
        # This DOES nominate some wrong merges (two merged columns sharing
        # one region); they are cheap — the LLH acceptance gate rejects
        # them (measured at N=12K) — and the freed column they would hand
        # to the split side is where the probe's measured gain comes from,
        # so precision-tightening this rule costs real recall (measured:
        # requiring connected exclusives here drops the probe's accepted
        # repair and its F1 0.894 -> 0.914 gain entirely).
        # rule 2 (disjoint fragments): dense exclusive-to-exclusive edges
        # — genuinely overlapping communities have none, so they never
        # merge by either rule at their ~0.2 overlap level.
        if inter_frac >= 0.5 or dense_excl():
            merges.append((a, b))
            used.update((a, b))
    if not merges:
        # repairs = min(#merges, #splits): without a freed column the
        # split component scan below would be a guaranteed no-op
        return [], 0
    # split candidates: extra components of fat columns. The candidate set
    # only depends on merge-used columns, so it can be precomputed — which
    # lets the device backend run ONE batched label-propagation pass over
    # all fat candidates instead of a host scipy scan per column.
    from bigclam_tpu_torch.ops.components import components_backend

    cand = [
        int(c)
        for c in np.argsort(-sizes)
        if int(c) not in used and sizes[int(c)] >= 2 * min_comp
    ]
    comp_of = None
    if cand and components_backend(
        n, len(cand), components, device
    ) == "device":
        from bigclam_tpu_torch.ops.components import (
            column_component_stats,
            components_from_labels,
            device_edges,
        )

        if edges_dev is None:      # round-looping callers pass their cache
            edges_dev = device_edges(g, device)
        member = np.zeros((len(cand), n), bool)
        for i, c in enumerate(cand):
            member[i, members[c]] = True
        labels, _, _ = column_component_stats(member, *edges_dev, n)
        comp_of = {
            c: components_from_labels(labels[i], n, min_size=min_comp)
            for i, c in enumerate(cand)
        }
    splits = []
    for c in cand:
        comps = (
            list(comp_of[c])
            if comp_of is not None
            else [
                np.asarray(cc, np.int64)
                for cc in _graph_components(members[c], indptr, indices)
                if len(cc) >= min_comp
            ]
        )
        if len(comps) <= 1:
            continue
        # min-id tiebreak: backend-independent primary-component choice
        # (component member arrays are ascending on both backends)
        comps.sort(key=lambda cc: (-len(cc), int(cc[0])))
        for comp in comps[1:]:
            splits.append((c, np.asarray(comp, np.int64)))
    edits: list = []
    repairs = 0
    freed = []
    for a, b in merges:
        if repairs >= len(splits):
            break
        gained = np.fromiter(
            sorted(msets[b] - msets[a]), np.int64,
            count=len(msets[b] - msets[a]),
        )
        edits.append(("set", gained, int(a), float(strength)))
        edits.append(("clear", int(b)))
        freed.append(b)
        repairs += 1
    for (c, comp), v in zip(splits, freed):
        edits.append(("set", comp, int(v), float(strength)))
        edits.append(("set", comp, int(c), 0.0))
    return edits, repairs


def apply_repair_edits(F: np.ndarray, edits: list, num_nodes: int
                       ) -> np.ndarray:
    """Apply a repair_plan edit list to a host F in place (rows beyond
    num_nodes — padding — are never named by edits)."""
    for e in edits:
        if e[0] == "clear":
            F[:num_nodes, e[1]] = 0.0
        else:
            _, rows, col, val = e
            F[rows, col] = val
    return F


def repair_communities(
    F: np.ndarray,
    g,
    delta: float,
    k_active: int,
    min_comp: int = 5,
    strength: float = 1.0,
    components: str = "auto",
    edges_dev=None,
    device=None,
) -> Tuple[np.ndarray, int]:
    """One merge+split repair pass over the thresholded communities:
    repair_plan detection + host application of the edit list. Returns
    (repaired F, number of repairs); see repair_plan for the move's
    rationale and cost model."""
    F = np.asarray(F, np.float64).copy()
    edits, repairs = repair_plan(
        F, g, delta, k_active, min_comp=min_comp, strength=strength,
        components=components, edges_dev=edges_dev, device=device,
    )
    if not repairs:
        return F, 0
    return apply_repair_edits(F, edits, g.num_nodes), repairs


@dataclasses.dataclass(frozen=True)
class QualityResult:
    fit: FitResult            # best-LLH cycle's result
    cycles_llh: Tuple[float, ...]   # converged LLH per cycle (as run)
    num_cycles: int
    total_iters: int
    num_repairs: int = 0      # accepted merge+split repair rounds (the
    # repair stage can push fit.llh ABOVE max(cycles_llh))
    stages: Optional[dict] = None   # per-stage wall-clock + transfer
    # counters (utils.profiling.StageProfile.report()); populated by the
    # device schedule and by callers that pass a profile to fit_quality


def _repair_stamp(
    cfg, anneal_llh: float, kc: int, eps: float, min_comp: int, rng: str
) -> dict:
    """The invalidation stamp a repair checkpoint must match to resume
    (see _repair_stage). `rng` names the kick-stream family — "host"
    (NumPy streams) vs "device" (the device generator's streams): the two
    stages draw different polish kicks, so their checkpoints must never
    cross-resume."""
    return {
        "anneal_llh": float(anneal_llh),
        "kick_cols": int(kc),
        "reassign": bool(cfg.quality_reassign),
        "seed": cfg.seed,
        "eps": float(eps),
        "min_comp": int(min_comp),
        "rng": rng,
    }


def _repair_ckpt_open(checkpoints, stamp: dict):
    """(manager under <dir>/repair, restored (rr_done, arrays, meta) or
    None). A checkpoint whose meta mismatches ANY stamp key — including
    one written before a stamp key existed (.get() misses) — is stale:
    deleted, and a fresh manager is returned. The anneal_llh stamp is the
    resume-extension rule: a restart with more restart_cycles changes the
    post-annealing best, so the stale repair work is discarded and repair
    restarts from the NEW annealed state, exactly as an uninterrupted run
    would (ADVICE round-5 for the eps/min_comp keys)."""
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    rep_ckpt = CheckpointManager(
        os.path.join(checkpoints.directory, "repair")
    )
    restored = rep_ckpt.restore()
    if restored is None:
        return rep_ckpt, None
    meta = restored[2]
    if all(meta.get(k) == v for k, v in stamp.items()):
        return rep_ckpt, restored
    shutil.rmtree(rep_ckpt.directory, ignore_errors=True)
    return CheckpointManager(rep_ckpt.directory), None


def _repair_stage(
    model,
    best: FitResult,
    kc: int,
    eps: float,
    callback,
    checkpoints=None,
    min_comp: int = 5,
    resume: bool = True,
) -> Tuple[FitResult, int, int]:
    """The DISCRETE improvement stage shared by fit_quality and
    fit_quality_device. Each round tries (a) the atomize re-tiling
    (atomize_reassign; cfg.quality_reassign) and (b) the merge/split
    repair (repair_communities), each refit and kept only on LLH
    improvement; the loop stops when a round accepts neither. Runs with model.cfg already swapped to the RELAXED
    quality config (the polish fits anneal under the same clip the cycles
    did); reads schedule knobs (repair_rounds, seed, min_f, max_f) off the
    live cfg — identical values to the caller's saved cfg since the swap
    touches only conv_tol/max_p.

    Returns (best, accepted_repairs, extra_iters).

    Checkpointing (SURVEY §5; VERDICT r4 item 7): with `checkpoints`, each
    completed repair round saves under <dir>/repair/ with the
    POST-ANNEALING best LLH stamped in the meta. A crash mid-repair
    resumes from the last completed round instead of redoing hours of
    polish fits. The stamp is also the invalidation rule that preserves
    resume-extension exactness: a restart with a larger restart_cycles
    changes the post-annealing best, the stamp mismatches, and the stale
    repair checkpoint is discarded — repair restarts from the NEW
    annealed state, exactly as an uninterrupted run would. Repair kick
    streams are fixed per (round, polish) so a resumed round reproduces
    the uninterrupted schedule.
    """
    from bigclam_tpu_torch.ops.extraction import delta_threshold

    cfg = model.cfg
    n = best.F.shape[0]
    accepted_repairs = 0
    extra_iters = 0
    anneal_llh = float(best.llh)       # the post-annealing stamp
    start_round = 0
    rep_ckpt = None
    stamp: dict = {}
    if checkpoints is not None:
        # the stamp (incl. eps/min_comp — a checkpoint written under a
        # different polish kick scale or component floor replays a
        # different schedule on resume, ADVICE round-5) gates the restore
        stamp = _repair_stamp(cfg, anneal_llh, kc, eps, min_comp, "host")
        rep_ckpt, restored = _repair_ckpt_open(checkpoints, stamp)
        if not resume:
            restored = None      # cold start: keep saving, never restore
        if restored is not None:
            rr_done, arrays, meta = restored
            F_r = np.asarray(arrays["F"])
            best = FitResult(
                F=F_r,
                sumF=F_r.sum(axis=0),
                llh=float(meta["best_llh"]),
                num_iters=int(meta.get("fit_num_iters", best.num_iters)),
                llh_history=tuple(
                    np.asarray(arrays.get("llh_history", ())).tolist()
                ),
            )
            accepted_repairs = int(meta.get("accepted_repairs", 0))
            extra_iters = int(meta.get("extra_iters", 0))
            start_round = rr_done + 1
            if meta.get("done"):
                return best, accepted_repairs, extra_iters

    g_orig = getattr(model, "g_original", model.g)
    delta = delta_threshold(g_orig.num_nodes, g_orig.num_edges)
    device = getattr(model, "device", None)    # the component passes' device

    def _save(rr: int, done: bool) -> None:
        if rep_ckpt is not None and is_primary():
            rep_ckpt.save(
                rr,
                {
                    "F": np.asarray(best.F),
                    "llh_history": np.asarray(best.llh_history, np.float64),
                },
                meta={
                    **stamp,
                    "best_llh": float(best.llh),
                    "fit_num_iters": int(best.num_iters),
                    "accepted_repairs": accepted_repairs,
                    "extra_iters": extra_iters,
                    "done": done,
                },
            )

    for rr in range(start_round, max(cfg.repair_rounds, 0)):
        changed = False
        # -- atomize re-tiling attempt (cfg.quality_reassign): one plain
        # refit from the shattered seeding, no polish kicks (the validated
        # prototype schedule) --
        if cfg.quality_reassign:
            F_at, n_atoms = atomize_reassign(
                best.F, g_orig, delta, kc, min_comp=min_comp, device=device
            )
            if n_atoms:
                res = model.fit(F_at, callback=callback)
                extra_iters += res.num_iters
                if res.llh > best.llh:
                    best = res
                    accepted_repairs += 1
                    changed = True
        # -- merge/split attempt with the round-4 kick-polish schedule --
        F_rep, nrep = repair_communities(
            best.F, g_orig, delta, kc, device=device
        )
        if nrep:
            cand = None
            F_c = F_rep
            for pc in range(6):        # polish: short re-annealing
                prng = np.random.default_rng([cfg.seed, 0xF17, rr, pc])
                F_try = np.asarray(F_c, np.float64).copy()
                F_try[:, :kc] = np.clip(
                    F_try[:, :kc] + prng.uniform(0.0, eps, size=(n, kc)),
                    cfg.min_f, cfg.max_f,
                )
                res = model.fit(F_try, callback=callback)
                extra_iters += res.num_iters
                if cand is None or res.llh > cand.llh:
                    cand = res
                    F_c = res.F
            if cand.llh > best.llh:
                best = cand
                accepted_repairs += 1
                changed = True
        _save(rr, not changed)
        if not changed:
            break
    return best, accepted_repairs, extra_iters


def fit_quality(
    model,
    F0: np.ndarray,
    callback: Optional[Callable[[int, float], None]] = None,
    checkpoints=None,
    kick_cols: Optional[int] = None,
    profile=None,
    resume: bool = True,
) -> QualityResult:
    """Train with the quality-mode schedule (see module docstring).

    model: any trainer exposing .cfg, .g, .rebuild_step(), and
    .fit(F0, callback=) -> FitResult (BigClamModel / ShardedBigClamModel /
    RingBigClamModel all do).

    `checkpoints` (utils.checkpoint.CheckpointManager) is used at CYCLE
    granularity: after each cycle the kept F is saved under step=cycle and
    a restart resumes from the newest cycle. With cfg.checkpoint_every > 0
    each cycle's fit ADDITIONALLY checkpoints within the cycle (under
    checkpoints.directory/cycle_<c>/, deleted once the cycle is
    journaled — the sweep's per-K pattern), so a crash deep inside a long
    cycle resumes inside it instead of restarting the cycle. Noise is
    drawn from per-cycle streams ([cfg.seed, 0x5EED, cycle]) so resume
    reproduces the uninterrupted schedule exactly either way.

    `kick_cols` restricts the noise kick to F[:, :kick_cols] (default: all
    columns). The K-sweep passes the active K here — its F buffer is sized
    to the grid max with columns >= K masked to zero, and an unrestricted
    kick would lift those padding columns off their inert zeros.

    `profile` (utils.profiling.StageProfile, created when omitted)
    accumulates anneal/repair wall-clock; the report lands in
    QualityResult.stages so artifacts can attribute the quality stage's
    cost (the device loop records finer stages plus transfer counts).

    `resume=False` (cli --resume never) ignores any existing cycle
    checkpoints — cold start from F0 — while still SAVING new ones.
    """
    import time

    from bigclam_tpu_torch.utils.profiling import StageProfile

    profile = profile if profile is not None else StageProfile()
    cfg = model.cfg
    n, k = F0.shape
    kc = k if kick_cols is None else int(kick_cols)
    if not (0 < kc <= k):
        raise ValueError(f"kick_cols={kick_cols} out of range for K={k}")
    F_cur = np.asarray(F0, np.float64)
    cycles_llh: List[float] = []
    best: Optional[FitResult] = None
    total_iters = 0
    start_cycle = 0
    restored_gainless = 0
    max_p_q, eps = _relax_params(model, n)

    if checkpoints is not None and resume:
        restored = checkpoints.restore()
        if restored is not None:
            cyc, arrays, meta = restored
            if meta.get("quality_nk") != [n, k]:
                raise ValueError(
                    f"quality checkpoint incompatible: nk={meta.get('quality_nk')} "
                    f"vs ({n}, {k}) (dir: {checkpoints.directory})"
                )
            if int(meta.get("kick_cols", k)) != kc:
                raise ValueError(
                    f"quality checkpoint incompatible: kick_cols="
                    f"{meta.get('kick_cols')} vs {kc} "
                    f"(dir: {checkpoints.directory})"
                )
            # LLHs are computed under the step's clip bound: a checkpoint
            # written under a different effective max_p carries best_llh /
            # cycles_llh on a systematically different scale, silently
            # skewing acceptance and patience on resume. A meta WITHOUT
            # the stamp predates the stamp itself — the clip it actually
            # ran under is unrecorded, so refuse whenever this run would
            # relax (don't claim a max_p the checkpoint never wrote).
            ck_max_p = meta.get("quality_max_p")
            if ck_max_p is None:
                if max_p_q != cfg.max_p:
                    raise ValueError(
                        "quality checkpoint predates the quality_max_p "
                        "stamp (the clip bound its LLHs were computed "
                        f"under is unrecorded), but this run relaxes "
                        f"MAX_P_ to {max_p_q} — cannot verify the LLH "
                        f"scales match; restart without the stale "
                        f"checkpoint (dir: {checkpoints.directory})"
                    )
            elif ck_max_p != max_p_q:
                raise ValueError(
                    f"quality checkpoint incompatible: written under "
                    f"max_p={ck_max_p}, this run relaxes to {max_p_q} — "
                    f"LLH scales differ (dir: {checkpoints.directory})"
                )
            F_cur = np.asarray(arrays["F"])
            cycles_llh = list(meta.get("cycles_llh", []))
            best_llh = float(meta["best_llh"])
            best = FitResult(
                F=F_cur, sumF=F_cur.sum(axis=0), llh=best_llh,
                num_iters=int(meta.get("total_iters", 0)), llh_history=(),
            )
            total_iters = int(meta.get("total_iters", 0))
            start_cycle = cyc + 1
            restored_gainless = int(meta.get("gainless", 0))

    max_cycles = max(cfg.restart_cycles, 1)
    cfg_saved = model.cfg
    accepted_repairs = 0
    # patience state survives resume (persisted in the checkpoint meta) so
    # the resumed schedule stops exactly where the uninterrupted one would
    gainless = restored_gainless
    rebuilt = False
    try:
        # within-cycle fits use the TIGHTER quality_conv_tol (host-side
        # only); the max_p swap changes step-baked constants, so the step
        # is recompiled — same kernels/schedule, different clip bound
        # (cached by step_cfg_key)
        model.cfg = cfg.replace(
            conv_tol=cfg.quality_conv_tol, max_p=max_p_q
        )
        if max_p_q != cfg.max_p:
            model.rebuild_step()
            rebuilt = True
        t_anneal = time.perf_counter()
        from bigclam_tpu_torch.obs import trace as _trace

        for cycle in range(start_cycle, max_cycles):
            if gainless >= cfg.restart_patience:
                break          # a restored run that already tripped
                # patience must not anneal further (resume-exactness)
            crng = np.random.default_rng([cfg.seed, 0x5EED, cycle])
            kick = crng.uniform(0.0, eps, size=(n, kc))
            F_try = np.asarray(F_cur, np.float64).copy()
            F_try[:, :kc] = np.clip(
                F_try[:, :kc] + kick, cfg.min_f, cfg.max_f
            )
            cyc_ckpt = cyc_dir = None
            if checkpoints is not None and cfg.checkpoint_every > 0:
                from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

                cyc_dir = os.path.join(
                    checkpoints.directory, f"cycle_{cycle:05d}"
                )
                cyc_ckpt = CheckpointManager(cyc_dir)
            # checkpoints= only when active: the documented trainer surface
            # (.cfg, .g, .fit(F0, callback=), .rebuild_step()) stays
            # sufficient for duck-typed trainers unless within-cycle
            # checkpointing was explicitly requested
            try:
                # one span per annealing cycle (obs.trace): the restart
                # schedule's time-per-cycle rides the span breakdown next
                # to the `cycle` events
                with _trace.span("cycle", cycle=cycle):
                    res = (
                        model.fit(
                            F_try, callback=callback, checkpoints=cyc_ckpt
                        )
                        if cyc_ckpt is not None
                        else model.fit(F_try, callback=callback)
                    )
            except FloatingPointError as e:
                # a kick blew up past the fit loop's rollback budget
                # (models.bigclam run_fit_loop): annealing is an OPTIONAL
                # refinement on top of a kept-best state, so with a best in
                # hand the right move is degrade-not-die — revert the kick,
                # keep the best, stop annealing. Without one (cycle 0)
                # there is nothing to fall back to: propagate.
                if best is None:
                    raise
                warnings.warn(
                    f"annealing cycle {cycle} aborted non-finite ({e}); "
                    "keeping the best converged state and stopping the "
                    "annealing loop"
                )
                from bigclam_tpu_torch.obs import telemetry as _obs_t

                tel = _obs_t.current()
                if tel is not None:
                    tel.event(
                        "note",
                        msg="quality_cycle_nonfinite_abort",
                        cycle=cycle,
                        kept_llh=best.llh,
                    )
                break
            total_iters += res.num_iters
            cycles_llh.append(res.llh)
            prev_best = best.llh if best is not None else None
            kept = best is None or res.llh > best.llh
            _cycle_event(cycle, res.llh, kept, res.num_iters)
            if kept:
                best = res
                F_cur = res.F              # kick accepted: anneal from here
            # else: converged worse than the kept state — revert the kick
            if prev_best is not None and prev_best != 0.0:
                gain = (best.llh - prev_best) / abs(prev_best)
                gainless = gainless + 1 if gain < cfg.restart_tol else 0
            if checkpoints is not None:
                if is_primary():
                    checkpoints.save(
                        cycle,
                        {"F": F_cur},
                        meta={
                            "best_llh": best.llh,
                            "cycles_llh": cycles_llh,
                            "total_iters": total_iters,
                            "gainless": gainless,
                            "quality_nk": [n, k],
                            "kick_cols": kc,
                            "quality_max_p": max_p_q,
                        },
                    )
                    if cyc_dir is not None:
                        # journaled: the cycle's within-fit checkpoints are
                        # spent (and must not leak into a later cycle)
                        shutil.rmtree(cyc_dir, ignore_errors=True)
            if gainless >= cfg.restart_patience:
                break
        profile.add_seconds("anneal", time.perf_counter() - t_anneal)
        # --- discrete repair stage (cfg.quality_repair; _repair_stage):
        # runs after the cycle loop, checkpointed under <dir>/repair/ with
        # the post-annealing best LLH as its invalidation stamp — a
        # restart with a larger restart_cycles changes that stamp, the
        # stale repair checkpoint is discarded, and repair restarts from
        # the NEW annealed state (resume-extension exactness preserved).
        # Repairs use the ORIGINAL-id graph: FitResult.F is in original
        # ids even when a balanced sharded trainer relabeled rows.
        if cfg.quality_repair and best is not None:
            t_rep = time.perf_counter()
            best, accepted_repairs, rep_iters = _repair_stage(
                model, best, kc, eps, callback, checkpoints=checkpoints,
                resume=resume,
            )
            total_iters += rep_iters
            profile.add_seconds("repair", time.perf_counter() - t_rep)
    finally:
        model.cfg = cfg_saved
        if rebuilt:
            model.rebuild_step()           # restore the parity-clip step
    return QualityResult(
        fit=best,
        cycles_llh=tuple(cycles_llh),
        num_cycles=len(cycles_llh),
        total_iters=total_iters,
        num_repairs=accepted_repairs,
        stages=profile.report(),
    )




# --------------------------------------------------------------------------
# the device-resident schedule
# --------------------------------------------------------------------------


def _parts(F) -> list:
    """The row parts of a state's F: the dense trainer's one padded
    tensor, or a mesh trainer's per-shard row blocks (internal row order);
    at tp > 1 a part is its shard's tuple of column blocks."""
    return [F] if isinstance(F, torch.Tensor) else list(F)


def _as_layout(F, parts):
    """`parts` in the layout of F: one tensor, or a tuple of shards."""
    return parts[0] if isinstance(F, torch.Tensor) else tuple(parts)


def _map_parts(fn, parts: list) -> list:
    """fn applied to every block of the row parts, in their layout."""
    return [fn(p) if isinstance(p, torch.Tensor) else tuple(fn(b) for b in p)
            for p in parts]


def _origin(model) -> tuple:
    """(first internal row, first column) of the state this process holds:
    (0, 0) but on a multi-process mesh, whose rank holds a block of the
    grid (parallel/multihost.py)."""
    mesh = getattr(model, "mesh", None)
    if not getattr(mesh, "distributed", False):
        return (0, 0)
    return (model.row0 * (model.n_pad // model.dp),
            model.col0 * (model.k_pad // model.tp))


def _col_blocks(part, c0: int = 0):
    """(block, its first column, the column past its last) for each column
    block of a row part (the first at column c0): the part itself at
    tp = 1."""
    for b in state_blocks(part):
        c1 = c0 + int(b.shape[1])
        yield b, c0, c1
        c0 = c1


def _row_blocks(F, n: int, lo: int = 0):
    """(row part, its first internal row, its live rows) for each part of
    F (the first at internal row lo); rows at or past n are padding."""
    for p in _parts(F):
        r = int(state_blocks(p)[0].shape[0])
        yield p, lo, max(min(n - lo, r), 0)
        lo += r


def kick_F(F, noise: torch.Tensor, n: int, kc: int, min_f: float,
           max_f: float, origin: tuple = (0, 0)):
    """New tensors holding clip(F + noise, min_f, max_f) on the live
    (n, kc) block and F elsewhere: padding rows and columns keep their
    exact zeros. `noise` is (n, kc) in the internal row order; column
    block j of a tp > 1 shard takes its columns [c0, c0 + K_loc) of it
    that fall below kc. `origin` (_origin) places a rank's blocks in the
    global draw, so every rank's kicks are the single controller's."""
    out = []
    for p, lo, live in _row_blocks(F, n, origin[0]):
        blocks = []
        for f, c0, c1 in _col_blocks(p, origin[1]):
            f = f.clone()
            w = min(kc, c1) - c0
            if live and w > 0:
                blk = f[:live, :w] + noise[lo:lo + live, c0:c0 + w].to(f.device)
                f[:live, :w] = blk.clamp_(min_f, max_f)
            blocks.append(f)
        out.append(blocks[0] if isinstance(p, torch.Tensor) else tuple(blocks))
    return _as_layout(F, out)


def scatter_set_(parts: list, rows, cols, vals, origin: tuple = (0, 0)) -> None:
    """parts[rows, cols] = vals in place (internal row ids over the
    stacked parts, columns over a part's column blocks; the parts start at
    `origin`). Entries outside the parts are dropped, never raised, as the
    JAX package's `.at[].set(mode="drop")`."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.broadcast_to(np.asarray(vals, np.float64), rows.shape)
    lo = origin[0]
    for p in parts:
        r = int(state_blocks(p)[0].shape[0])
        for f, c0, c1 in _col_blocks(p, origin[1]):
            sel = ((rows >= lo) & (rows < lo + r) & (cols >= c0)
                   & (cols < c1))
            if sel.any():
                idx = (torch.from_numpy(rows[sel] - lo).to(f.device),
                       torch.from_numpy(cols[sel] - c0).to(f.device))
                f.index_put_(idx, torch.from_numpy(
                    np.ascontiguousarray(vals[sel])).to(f.device, f.dtype))
        lo += r


def clear_col_(parts: list, col: int, origin: tuple = (0, 0)) -> None:
    """Column `col` of every part set to zero in place, in the column
    block that owns it (the parts' columns start at origin[1])."""
    for p in parts:
        for f, c0, c1 in _col_blocks(p, origin[1]):
            if c0 <= col < c1:
                f[:, col - c0] = 0.0


# the polish kicks' tags: JAX folds 0x0F17_0000 + 64 * round + polish into
# the base key (cycle kicks fold the cycle)
POLISH_TAG = 0x0F17_0000


class DeviceNoise:
    """The device schedule's kicks: U(0, eps) over the live block in the
    trainer's row order, drawn on the device from an explicit
    torch.Generator seeded per (seed ^ 0x5EED, key_salt, tag), tag the
    cycle or POLISH_TAG + 64 * round + polish. Deterministic for a seed
    on one device type; not the host schedule's numpy streams, nor JAX's
    threefry draws (the tests feed those in through fit_quality_device's
    `noise`)."""

    def __init__(self, seed: int, key_salt: int = 0):
        self.base = [(int(seed) ^ 0x5EED) & 0xFFFFFFFF,
                     int(key_salt) & 0xFFFFFFFF]

    def stream_seed(self, tag: int) -> int:
        return int(np.random.SeedSequence(self.base + [int(tag)])
                   .generate_state(1, np.uint64)[0])

    def __call__(self, tag: int, shape: tuple, eps: float, dtype,
                 device) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(self.stream_seed(tag))
        return torch.rand(shape, generator=gen, dtype=dtype, device=device) * eps


def _repair_stage_device(
    model,
    best_state,
    best_llh: float,
    best_iters: int,
    best_hist: tuple,
    kc: int,
    eps: float,
    callback,
    kick_fn,
    profile,
    checkpoints=None,
    min_comp: int = 5,
    resume: bool = True,
):
    """DEVICE-RESIDENT discrete stage: the _repair_stage twin that keeps F
    on the device (port of the JAX `_repair_stage_device`).

    * components and density stats for atomize and the fat-column splits
      come from the batched label-propagation pass (ops.components) on the
      trainer's device: int32 label/stat arrays cross to the host, F does
      not (scipy on a CPU trainer, where device memory is host memory);
    * merge/split runs before atomize within a round: its detection reads
      thresholded F VALUES on the host, so it takes the round's one F
      fetch, which doubles as the previous round's checkpoint payload;
      atomize needs only the thresholded mask, which stays on the device;
    * repairs reach the resident F as scatter edits (repair_plan's edit
      list in original ids, through the trainer's `_perm`; the atomize
      plan's (rows, cols, vals) in internal ids), and every refit (the
      atomize refit and the 6 polish fits) runs through
      model.fit_state(model.reset_state(F));
    * polish kicks come from `kick_fn(F, tag)` (tag POLISH_TAG + 64 *
      round + polish), so repair checkpoints carry rng="device" and never
      cross-resume with the host stage's.

    Round checkpoints are DEFERRED one fetch: round rr's state is saved by
    round rr+1's fetch (the identical F) and the last round's by the
    caller's final fetch, through the returned `finalize(F_host)`.
    Returns (best_state, best_llh, best_iters, best_hist,
    accepted_repairs, extra_iters, finalize).
    """
    from bigclam_tpu_torch.ops.components import (
        components_backend,
        device_edges,
    )
    from bigclam_tpu_torch.ops.extraction import delta_threshold

    cfg = model.cfg
    g = model.g
    g_orig = getattr(model, "g_original", g)
    n = g.num_nodes
    delta = delta_threshold(g_orig.num_nodes, g_orig.num_edges)
    accepted_repairs = 0
    extra_iters = 0
    anneal_llh = float(best_llh)
    start_round = 0
    rep_ckpt = None
    stamp: dict = {}
    if checkpoints is not None:
        stamp = _repair_stamp(cfg, anneal_llh, kc, eps, min_comp, "device")
        rep_ckpt, restored = _repair_ckpt_open(checkpoints, stamp)
        if not resume:
            restored = None      # cold start: keep saving, never restore
        if restored is not None:
            rr_done, arrays, meta = restored
            best_state = model.init_state(np.asarray(arrays["F"]))
            profile.count("f_host_uploads")
            best_llh = float(meta["best_llh"])
            best_iters = int(meta.get("fit_num_iters", best_iters))
            best_hist = tuple(
                np.asarray(arrays.get("llh_history", ())).tolist()
            )
            accepted_repairs = int(meta.get("accepted_repairs", 0))
            extra_iters = int(meta.get("extra_iters", 0))
            start_round = rr_done + 1
            if meta.get("done"):
                return (
                    best_state, best_llh, best_iters, best_hist,
                    accepted_repairs, extra_iters, lambda F_host: None,
                )

    perm = getattr(model, "_perm", None)   # edits arrive in ORIGINAL ids
    origin = _origin(model)
    dev = state_blocks(best_state.F)[0].device
    edges_dev = device_edges(g, dev)       # one upload for every round
    # merge/split detection runs in ORIGINAL ids (on the fetched F); a
    # balanced trainer's g is relabeled, so its edges cannot serve there
    edges_dev_orig = edges_dev if g_orig is g else device_edges(g_orig, dev)

    pending: list = [None]     # (round, done) awaiting an F fetch

    def _save(rr: int, done: bool, F_host: np.ndarray) -> None:
        if rep_ckpt is not None and is_primary():
            rep_ckpt.save(
                rr,
                {
                    "F": np.asarray(F_host),
                    "llh_history": np.asarray(best_hist, np.float64),
                },
                meta={
                    **stamp,
                    "best_llh": float(best_llh),
                    "fit_num_iters": int(best_iters),
                    "accepted_repairs": accepted_repairs,
                    "extra_iters": extra_iters,
                    "done": done,
                },
            )

    def finalize(F_host) -> None:
        if pending[0] is not None:
            _save(pending[0][0], pending[0][1], F_host)
            pending[0] = None

    for rr in range(start_round, max(cfg.repair_rounds, 0)):
        changed = False
        # --- the round's ONE F fetch: the previous round's deferred
        # checkpoint payload + the merge/split detection input ---
        with profile.stage("repair_fetch"):
            F_host = model.extract_F(best_state)
        profile.count("f_device_fetches")
        finalize(F_host)
        # --- (a) merge/split repair; polish refits state-resident ---
        with profile.stage("repair_detect"):
            edits, nrep = repair_plan(
                F_host, g_orig, delta, kc, min_comp=min_comp,
                edges_dev=edges_dev_orig, device=dev,
            )
        del F_host
        if nrep:
            parts = _map_parts(torch.clone, _parts(best_state.F))
            for e in edits:
                if e[0] == "clear":
                    clear_col_(parts, e[1], origin)
                else:
                    _, rows, col, val = e
                    rows = rows if perm is None else perm[rows]
                    scatter_set_(parts, rows, np.full(rows.size, col), val,
                                 origin)
            F_c = _as_layout(best_state.F, parts)
            del parts
            cand_state = None
            cand_llh = None
            cand_iters, cand_hist = 0, ()
            with profile.stage("repair_polish"):
                for pc in range(6):    # polish: short re-annealing
                    final, llh, iters, hist = model.fit_state(
                        model.reset_state(
                            kick_fn(F_c, POLISH_TAG + rr * 64 + pc)),
                        callback=callback,
                    )
                    extra_iters += iters
                    if cand_llh is None or llh > cand_llh:
                        cand_state, cand_llh = final, llh
                        cand_iters, cand_hist = iters, hist
                        F_c = final.F
                    del final          # rejected polish buffers die now
            del F_c
            if cand_llh is not None and cand_llh > best_llh:
                best_state, best_llh = cand_state, cand_llh
                best_iters, best_hist = cand_iters, cand_hist
                accepted_repairs += 1
                changed = True
                profile.count("repair_accepted")
            del cand_state
        # --- (b) atomize re-tiling from the DEVICE mask (no F fetch) ---
        if cfg.quality_reassign:
            with profile.stage("atomize_components"):
                if not getattr(getattr(model, "mesh", None), "distributed", False):
                    # the live columns of every column block, joined per
                    # shard
                    mask_cols = torch.cat([
                        torch.cat([
                            (f[:live, :max(min(kc, c1) - c0, 0)] >= delta).to(dev)
                            for f, c0, c1 in _col_blocks(p)
                        ], dim=1)
                        for p, _, live in _row_blocks(best_state.F, n)
                    ]).T
                else:
                    # a rank holds part of F: the mask of the whole, read
                    # through the all-gather every rank enters
                    from bigclam_tpu_torch.parallel.multihost import fetch_global

                    mask_cols = torch.from_numpy(
                        fetch_global(best_state.F, model.mesh)[:n, :kc] >= delta
                    ).to(dev).T
                # on a card the batched pass keeps F resident; on the CPU
                # the scipy oracle runs on the same bool mask (kc x n
                # bools, not F)
                if components_backend(n, kc, device=dev) == "device":
                    atoms = _column_atoms_device(
                        mask_cols, g, min_comp, edges_dev
                    )
                else:
                    atoms = _column_atoms_host(
                        mask_cols.cpu().numpy().T, g.indptr, g.indices,
                        min_comp,
                    )
                del mask_cols
            if atoms:
                kept = _plan_atoms(atoms, n, kc)
                rows = np.concatenate([at for at, _ in kept])
                cols = np.concatenate([
                    np.full(at.size, c, np.int64)
                    for c, (at, _) in enumerate(kept)
                ])
                vals = np.concatenate([
                    np.full(
                        at.size,
                        _atom_strength(at, d, g.indptr, g.indices),
                    )
                    for at, d in kept
                ])
                parts = _map_parts(torch.zeros_like, _parts(best_state.F))
                scatter_set_(parts, rows, cols, vals, origin)
                F_at = _as_layout(best_state.F, parts)
                del parts
                with profile.stage("atomize_refit"):
                    final, llh, iters, hist = model.fit_state(
                        model.reset_state(F_at), callback=callback
                    )
                del F_at
                extra_iters += iters
                if llh > best_llh:
                    best_state, best_llh = final, llh
                    best_iters, best_hist = iters, hist
                    accepted_repairs += 1
                    changed = True
                    profile.count("atomize_accepted")
                del final
        profile.count("repair_rounds")
        pending[0] = (rr, not changed)
        if not changed:
            break
    return (
        best_state, best_llh, best_iters, best_hist, accepted_repairs,
        extra_iters, finalize,
    )


def fit_quality_device(
    model,
    F0: np.ndarray,
    callback: Optional[Callable[[int, float], None]] = None,
    kick_cols: Optional[int] = None,
    key_salt: int = 0,
    checkpoints=None,
    profile=None,
    resume: bool = True,
    noise: Optional[Callable] = None,
) -> QualityResult:
    """DEVICE-RESIDENT annealing + discrete stage (port of the JAX
    `fit_quality_device`).

    The state stays on the device for the whole schedule: one init_state
    upload, then per cycle a kick of the live (num_nodes, kick_cols) block
    (padding rows and columns stay exactly zero) and the trainer's
    state-resident loop (fit_state on reset_state); only per-iteration LLH
    scalars cross to the host. The discrete stage (_repair_stage_device)
    keeps F resident as well and fetches it at most once a repair round;
    the final best F is fetched once at the end.

    `noise(tag, shape, eps, dtype, device)` returns the U(0, eps) kick of
    the live block, (num_nodes, kick_cols) in the trainer's internal row
    order; tag is the cycle, or POLISH_TAG + 64 * round + polish. The
    default is DeviceNoise(cfg.seed, key_salt); `key_salt`
    makes callers' schedules independent restarts (the K sweep salts with
    K). `checkpoints` wires REPAIR-ROUND checkpoints (<dir>/repair, stamped
    rng="device"); cycle checkpoints stay a host-loop feature.
    `resume=False` skips the repair-round restore while still saving.

    Stop rule, patience, MAX_P_ relaxation and the kept-LLH semantics are
    fit_quality's (shared _relax_params); the kick stream differs, and the
    discrete stage runs merge/split before atomize within a round. Stage
    seconds and transfer counts (f_host_uploads, f_device_fetches, ...)
    land in QualityResult.stages.
    """
    from bigclam_tpu_torch.obs import trace as _trace
    from bigclam_tpu_torch.utils.profiling import StageProfile

    profile = profile if profile is not None else StageProfile()
    cfg = model.cfg
    n, k = F0.shape
    kc = k if kick_cols is None else int(kick_cols)
    if not (0 < kc <= k):
        raise ValueError(f"kick_cols={kick_cols} out of range for K={k}")
    max_cycles = max(cfg.restart_cycles, 1)
    max_p_q, eps = _relax_params(model, n)

    state0 = model.init_state(F0)          # the ONE host->device upload
    profile.count("f_host_uploads")
    dtype, dev = state_blocks(state0.F)[0].dtype, state_blocks(state0.F)[0].device
    if noise is None:
        noise = DeviceNoise(cfg.seed, key_salt)

    origin = _origin(model)

    def kick_fn(F, tag: int):
        # every rank draws the whole (n, kc) block from the same seeded
        # stream and takes its own rows and columns
        return kick_F(F, noise(tag, (n, kc), eps, dtype, dev),
                      n, kc, cfg.min_f, cfg.max_f, origin)

    cfg_saved = model.cfg
    rebuilt = False
    cycles_llh: List[float] = []
    best_state = None
    best_llh = None
    total_iters = 0
    gainless = 0
    F_cur = state0.F
    del state0          # only F is needed
    try:
        model.cfg = cfg.replace(
            conv_tol=cfg.quality_conv_tol, max_p=max_p_q
        )
        if max_p_q != cfg.max_p:
            model.rebuild_step()
            rebuilt = True
        best_iters, best_hist = 0, ()
        with profile.stage("anneal"):
            for cycle in range(max_cycles):
                with _trace.span("cycle", cycle=cycle):
                    F_try = kick_fn(F_cur, cycle)
                    final, llh, iters, hist = model.fit_state(
                        model.reset_state(F_try), callback=callback
                    )
                    del F_try              # free the kicked input buffer
                total_iters += iters
                profile.count("anneal_cycles")
                cycles_llh.append(llh)
                _cycle_event(
                    cycle, llh, best_llh is None or llh > best_llh, iters
                )
                prev_best = best_llh
                if best_llh is None or llh > best_llh:
                    best_state, best_llh = final, llh
                    best_iters, best_hist = iters, hist
                    F_cur = final.F        # kick accepted: anneal from here
                # a rejected cycle's converged state must not stay live
                # through the next cycle (an extra F-sized buffer)
                del final
                if prev_best is not None and prev_best != 0.0:
                    gain = (best_llh - prev_best) / abs(prev_best)
                    gainless = gainless + 1 if gain < cfg.restart_tol else 0
                if gainless >= cfg.restart_patience:
                    break
        # still under the RELAXED cfg: the discrete stage's refits anneal
        # under the clip the cycles did, and F stays on the device
        finalize = None
        accepted_repairs = 0
        if cfg.quality_repair:
            (
                best_state, best_llh, best_iters, best_hist,
                accepted_repairs, rep_iters, finalize,
            ) = _repair_stage_device(
                model, best_state, best_llh, best_iters, best_hist, kc,
                eps, callback, kick_fn, profile,
                checkpoints=checkpoints, resume=resume,
            )
            total_iters += rep_iters
        with profile.stage("final_fetch"):
            F_best = model.extract_F(best_state)   # ONE device->host fetch
        profile.count("f_device_fetches")
        if finalize is not None:
            finalize(F_best)   # deferred last-round repair checkpoint
        # the host loop's FitResult contract: the BEST fit's iteration
        # count and LLH trace (total_iters on the QualityResult)
        fit = FitResult(
            F=F_best, sumF=F_best.sum(axis=0), llh=best_llh,
            num_iters=best_iters, llh_history=best_hist,
        )
    finally:
        model.cfg = cfg_saved
        if rebuilt:
            model.rebuild_step()
    return QualityResult(
        fit=fit,
        cycles_llh=tuple(cycles_llh),
        num_cycles=len(cycles_llh),
        total_iters=total_iters,
        num_repairs=accepted_repairs,
        stages=profile.report(),
    )
