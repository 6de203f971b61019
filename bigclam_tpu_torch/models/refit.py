"""Warm-start incremental refit + the continuous fit->publish loop.

Port of bigclam_tpu/models/refit.py. A graph delta costs only the work it
touched:

* `warm_start_refit` starts from the PREVIOUS converged F, restricts the
  optimization to the delta's touched rows plus a configurable HALO of
  their neighbours, and sweeps them with the batched fold-in operator
  (ops.foldin — the trainer's own per-node Armijo ascent against the
  frozen remainder). Each round is one block-coordinate sweep: every
  batch folds against the CURRENT frozen state and commits its rows (the
  trainers' refit_commit) before the next batch runs, so the restricted
  objective ascends round over round like the full fit's global LLH.

* The health detectors run on the RESTRICTED objective series
  (obs.health.run_detectors, divergence/plateau): drift the local
  updates cannot absorb surfaces as a detector firing, and the result is
  flagged `escalated` so the caller (cli refit / the follow loop) runs a
  FULL fit instead of publishing a degraded snapshot.

* `follow_deltas` is the loop: watch a delta directory
  (graph.stream.scan_edge_files), and for each new edge file run delta
  re-ingest (GraphStore.apply_delta) -> warm-start refit -> atomic
  snapshot publication (serve.snapshot.publish_snapshot with monotonic
  generations via CheckpointManager.publish_next). A running `cli serve
  --watch-snapshots` hot-swaps each generation without dropping queries.

Batching: fold-in batches are padded to a FIXED (B, D) shape (B a power of
two, D a multiple of 64), as in the JAX module; padding query slots carry
zero rows and masks and stay at zero, and commits scatter only the real
slots. The padded neighbour batches are uploaded once, not once a round.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RefitResult:
    """One warm-start refit outcome (see warm_start_refit)."""

    F: np.ndarray            # (N, K) refit affiliation matrix
    llh: float               # restricted objective of the final round
    rounds: int              # block-coordinate sweeps run
    foldin_iters: int        # total per-node fold-in iterations
    touched: int             # delta-touched rows
    refit_nodes: int         # touched + halo rows actually optimized
    touched_frac: float      # refit_nodes / N
    halo: int                # halo hops requested
    converged: bool          # round-over-round rel change < conv_tol
    escalated: bool          # divergence/plateau fired on the
    #                          restricted objective: run a full fit
    anomalies: tuple         # detector findings (dicts)
    history: tuple           # restricted objective per round
    wall_s: float


def expand_halo(
    indptr: np.ndarray,
    indices: np.ndarray,
    touched: np.ndarray,
    hops: int,
) -> np.ndarray:
    """touched rows + `hops` rings of CSR neighbors, sorted unique — the
    refit's working set. A touched node's update shifts the objective of
    its neighbors (their frozen-F terms reference its row), so hop 1 is
    the default; hop 0 refits strictly the touched rows."""
    nodes = np.unique(np.asarray(touched, np.int64))
    frontier = nodes
    for _ in range(max(int(hops), 0)):
        if frontier.size == 0:
            break
        starts = indptr[frontier]
        counts = (indptr[frontier + 1] - starts).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            break
        take = np.repeat(starts, counts) + (
            np.arange(total, dtype=np.int64)
            - np.repeat(
                np.concatenate([[0], np.cumsum(counts[:-1])]), counts
            )
        )
        nbrs = np.unique(np.asarray(indices)[take].astype(np.int64))
        frontier = nbrs[~np.isin(nbrs, nodes, assume_unique=True)]
        nodes = np.union1d(nodes, frontier)
    return nodes


def touched_rows_from_delta(raw_ids: np.ndarray, delta_path: str):
    """Internal rows touched by a delta edge file: both endpoints of
    every edge, mapped through the cache/graph raw-id table (unknown ids
    raise — a delta cannot grow N, see
    GraphStore.apply_delta)."""
    from bigclam_tpu_torch.graph.store import rows_of_raw_ids
    from bigclam_tpu_torch.graph.stream import load_edge_list_streaming

    pairs = load_edge_list_streaming(delta_path)
    if pairs.size == 0:
        return np.empty(0, dtype=np.int64)
    raw_ids = np.asarray(raw_ids)
    order = np.argsort(raw_ids, kind="stable")
    flat = np.unique(pairs)
    rows, known = rows_of_raw_ids(flat, order, raw_ids[order])
    if not known.all():
        raise ValueError(
            f"{delta_path}: contains node ids absent from the graph "
            f"(e.g. {flat[~known][:3].tolist()}) — re-ingest the merged "
            "edge list instead of refitting a delta"
        )
    return np.unique(rows)


def _rel_change(new: float, old: float) -> float:
    if old == 0.0:
        return 0.0 if new == 0.0 else float("inf")
    return abs(1.0 - new / old)


def _pow2(x: int, lo: int = 1) -> int:
    return max(1 << max(int(x) - 1, 0).bit_length(), lo)


def warm_start_refit(
    model,
    F_prev: np.ndarray,
    touched,
    halo: int = 1,
    max_rounds: int = 12,
    conv_tol: Optional[float] = None,
    batch: int = 512,
    foldin_max_iters: int = 100,
    foldin_conv_tol: Optional[float] = None,
    max_deg: int = 4096,
    thresholds: Optional[dict] = None,
    callback: Optional[Callable[[int, float], None]] = None,
) -> RefitResult:
    """Incremental refit of `touched` rows (+ halo) against the frozen
    remainder, warm-started from `F_prev` (see module docstring).

    `conv_tol` (default: the model's cfg.conv_tol) is the round-over-
    round stop rule on the restricted objective; `foldin_conv_tol`
    (default: same) the per-node stop inside each fold-in batch. The
    health detectors (obs.health.run_detectors) watch the round series:
    divergence or plateau-before-tol marks the result `escalated` — the
    caller should fall back to a full fit. Works on the dense and
    sparse trainers (both expose foldin-compatible state + a
    refit_commit scatter)."""
    import torch

    from bigclam_tpu_torch.obs import telemetry as _obs
    from bigclam_tpu_torch.obs.health import run_detectors
    from bigclam_tpu_torch.ops import foldin as fi
    from bigclam_tpu_torch.serve.snapshot import pad_neighbor_batch

    t0 = time.perf_counter()
    g, cfg = model.g, model.cfg
    n = g.num_nodes
    tol = float(cfg.conv_tol if conv_tol is None else conv_tol)
    ftol = float(tol if foldin_conv_tol is None else foldin_conv_tol)
    touched = np.unique(np.asarray(touched, np.int64))
    nodes = expand_halo(g.indptr, g.indices, touched, halo)
    state = model.init_state(np.asarray(F_prev, np.float64))
    sparse = hasattr(state, "ids")
    k_pad = model.k_pad
    dev, dt = state.F.device, state.F.dtype
    fit = fi.make_foldin_fit(cfg, max_iters=int(foldin_max_iters),
                             conv_tol=ftol)
    b = min(_pow2(max(batch, 1)), _pow2(max(nodes.size, 1)))
    # padded neighbour batches depend only on the (fixed) graph and the
    # chunking: build and upload them ONCE, not once per round
    chunks: List[tuple] = []
    for i in range(0, nodes.size, b):
        chunk = nodes[i: i + b]
        real = chunk.size
        nodes_b = np.zeros(b, np.int64)
        nodes_b[:real] = chunk
        nbr_ids, nbr_mask, _ = pad_neighbor_batch(
            g.indptr, g.indices, nodes_b, max_deg=max_deg,
            pad_deg_to=64,
        )
        nbr_mask[real:] = 0.0              # padding query slots
        sel = (np.arange(b) < real).astype(np.float64)[:, None]
        chunks.append((
            chunk, real,
            torch.from_numpy(nodes_b).to(dev),
            torch.from_numpy(nbr_ids.astype(np.int64)).to(dev),
            torch.from_numpy(nbr_mask).to(device=dev, dtype=dt),
            torch.from_numpy(sel).to(device=dev, dtype=dt),
        ))
    history: List[float] = []
    samples: List[dict] = []
    anomalies: List[dict] = []
    best: Optional[float] = None
    converged = escalated = False
    rounds = 0
    foldin_iters = 0
    k = cfg.num_communities
    for r in range(max(int(max_rounds), 1)):
        round_llh = 0.0
        for chunk, real, nodes_dev, nbr_dev, mask, sel in chunks:
            if sparse:
                nbr_rows = fi.densify_member_rows(
                    state.ids, state.F, nbr_dev, k_pad
                )
                own = fi.densify_rows(state.ids, state.F, nodes_dev, k_pad)
            else:
                nbr_rows = fi.gather_neighbor_rows(state.F, nbr_dev)
                own = state.F[nodes_dev]
            own = own * sel                # pad slots: zero rows, stay zero
            sumF_others = state.sumF[None, :] - own
            rows, llh, iters = fit(own, nbr_rows, mask, sumF_others)
            rows_h = rows[:real].cpu().numpy()
            round_llh += float(llh.cpu().numpy()[:real].sum())
            foldin_iters += int(iters.cpu().numpy()[:real].sum())
            state = model.refit_commit(state, chunk, rows_h[:, :k])
        rounds = r + 1
        history.append(round_llh)
        if callback is not None:
            callback(r, round_llh)
        samples.append({"iter": r, "llh": round_llh})
        if best is None or round_llh > best:
            best = round_llh
        found = [
            a for a in run_detectors(samples, best, tol, thresholds)
            if a["check"] in ("divergence", "plateau")
        ]
        if found:
            anomalies.extend(found)
            escalated = True
            break
        if r > 0 and _rel_change(history[-1], history[-2]) < tol:
            converged = True
            break
    F = model.extract_F(state)
    wall = time.perf_counter() - t0
    res = RefitResult(
        F=F,
        llh=history[-1] if history else float("-inf"),
        rounds=rounds,
        foldin_iters=foldin_iters,
        touched=int(touched.size),
        refit_nodes=int(nodes.size),
        touched_frac=round(nodes.size / n, 6) if n else 0.0,
        halo=int(halo),
        converged=converged,
        escalated=escalated,
        anomalies=tuple(anomalies),
        history=tuple(history),
        wall_s=round(wall, 4),
    )
    tel = _obs.current()
    if tel is not None:
        tel.event(
            "refit",
            touched=res.touched,
            rounds=res.rounds,
            refit_nodes=res.refit_nodes,
            touched_frac=res.touched_frac,
            halo=res.halo,
            foldin_iters=res.foldin_iters,
            converged=res.converged,
            escalated=res.escalated,
            llh=res.llh,
            seconds=res.wall_s,
        )
        for a in anomalies:
            tel.event("anomaly", **{**a, "source": "refit"})
    return res


def follow_deltas(
    store,
    cfg,
    F_start: np.ndarray,
    publish_dir: str,
    delta_dir: str,
    model_factory: Optional[Callable] = None,
    halo: int = 1,
    max_rounds: int = 12,
    interval_s: float = 0.5,
    max_deltas: int = 0,
    timeout_s: Optional[float] = None,
    escalate: bool = True,
    quiet: bool = False,
    refit_kw: Optional[dict] = None,
    device=None,
) -> dict:
    """The continuous fit->publish loop: poll
    `delta_dir` for new edge files, and for each run delta re-ingest ->
    warm-start refit -> publish (next generation, atomic pointer flip a
    running `cli serve` hot-swaps). Deltas already recorded in the cache
    manifest are skipped, so a restarted loop never re-applies.

    Stops after `max_deltas` processed files (0 = only the timeout
    stops it), or when no new delta arrives for `timeout_s` seconds
    (None = poll forever). An `escalated` refit (detector-flagged drift)
    falls back to a FULL fit warm-started from the refit F when
    `escalate` is True. Returns {generations, processed, escalations,
    last_step}."""
    from bigclam_tpu_torch.graph.stream import scan_edge_files
    from bigclam_tpu_torch.serve.snapshot import publish_snapshot
    from bigclam_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        published_step_of,
    )

    if model_factory is None:
        from bigclam_tpu_torch.models.bigclam import BigClamModel

        def model_factory(g, c):
            # the port's own K padding (a multiple of 32 where the CSR
            # kernels engage), on `device`
            return BigClamModel(g, c, device=device)

    processed = {
        d.get("path") for d in store.manifest.get("deltas", [])
    }
    F_cur = np.asarray(F_start, np.float64)
    out = {
        "generations": 0, "processed": [], "skipped_empty": [],
        "failed": [], "escalations": 0, "last_step": None,
    }
    # the full-fit cost baseline propagates through every generation
    # this loop publishes, so `cli refit` cost ratios keep meaning
    # "vs a from-scratch fit" — read it off the snapshot being
    # continued (None when the chain never recorded one)
    base_wall = None
    got = CheckpointManager(publish_dir).load_published()
    if got is not None:
        bw = got[2].get("fit_wall_s")
        if isinstance(bw, (int, float)) and not isinstance(bw, bool):
            base_wall = float(bw)
    kw = dict(refit_kw or {})
    idle_since = time.monotonic()
    try:
        return _follow_loop(
            store, cfg, F_cur, publish_dir, delta_dir, model_factory,
            halo, max_rounds, interval_s, max_deltas, timeout_s,
            escalate, quiet, kw, processed, out, base_wall, idle_since,
            scan_edge_files, publish_snapshot, published_step_of,
        )
    except KeyboardInterrupt:
        # an open-ended watch is stopped by Ctrl-C: the summary (and
        # with it the caller's fit JSON + telemetry final) must
        # survive the interrupt, not vanish in a traceback
        out["interrupted"] = True
        return out


def _follow_loop(
    store, cfg, F_cur, publish_dir, delta_dir, model_factory, halo,
    max_rounds, interval_s, max_deltas, timeout_s, escalate, quiet, kw,
    processed, out, base_wall, idle_since, scan_edge_files,
    publish_snapshot, published_step_of,
) -> dict:
    while True:
        fresh = scan_edge_files(delta_dir, processed)
        if not fresh:
            if max_deltas and len(out["processed"]) >= max_deltas:
                return out
            if timeout_s is not None and (
                time.monotonic() - idle_since > timeout_s
            ):
                return out
            time.sleep(max(interval_s, 0.01))
            continue
        for path in fresh:
            try:
                info = store.apply_delta(path)
            except ValueError as e:
                # a poison delta (new node ids, torn file) must not
                # kill an hours-long loop: skip it for the rest of this run,
                # surface it, keep watching. It stays unrecorded in
                # the manifest, so a restart retries it once (and
                # logs again) in case the producer fixed the file.
                print(
                    f"[bigclam] delta {os.path.basename(path)} "
                    f"REFUSED: {e}",
                    file=sys.stderr,
                )
                processed.add(os.path.abspath(path))
                out["failed"].append(os.path.abspath(path))
                idle_since = time.monotonic()
                continue
            processed.add(info["delta_path"])
            if not info["edges_added"]:
                # empty or duplicate-only delta: the graph did not
                # change — no refit, no generation churn (and no
                # pointless serve hot-swap). Counted separately so
                # max_deltas still bounds real work.
                out["skipped_empty"].append(info["delta_path"])
                idle_since = time.monotonic()
                continue
            g = store.load_graph()
            model = model_factory(g, cfg)
            res = warm_start_refit(
                model, F_cur, info["touched_rows"], halo=halo,
                max_rounds=max_rounds, **kw,
            )
            meta = {
                "refit": True,
                "delta_seq": int(info["delta_seq"]),
                "touched_frac": res.touched_frac,
                "refit_rounds": res.rounds,
                "refit_wall_s": res.wall_s,
                # propagate the from-scratch cost baseline (see above)
                "fit_wall_s": base_wall,
            }
            F_new = res.F
            if res.escalated and escalate:
                if not quiet:
                    print(
                        f"[bigclam] refit escalated on {path}: "
                        f"{[a['check'] for a in res.anomalies]} — "
                        "running a full fit",
                        file=sys.stderr,
                    )
                full = model.fit(res.F)
                F_new = full.F
                meta["escalated_full_fit"] = True
                meta["llh"] = full.llh
                out["escalations"] += 1
            spath = publish_snapshot(
                publish_dir, step=None, F=F_new, raw_ids=g.raw_ids,
                num_edges=g.num_edges, cfg=cfg, meta=meta,
            )
            step = published_step_of(spath)
            F_cur = np.asarray(F_new, np.float64)
            out["generations"] += 1
            out["last_step"] = step
            out["processed"].append(info["delta_path"])
            if not quiet:
                print(
                    f"[bigclam] delta {os.path.basename(path)}: "
                    f"{info['edges_added']} directed edges, "
                    f"{res.refit_nodes} rows refit in {res.rounds} "
                    f"round(s) ({res.wall_s:.2f}s) -> generation {step}",
                    file=sys.stderr,
                )
            idle_since = time.monotonic()
            if max_deltas and len(out["processed"]) >= max_deltas:
                return out
