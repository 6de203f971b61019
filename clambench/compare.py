"""The comparison that decides `correct`: the program's first iterations,
as the window's own call ran them, against the reference's.

Numbers compared (each against its cell's limit in `limits/<cell>.json`):

* `seeds`     the seeds (the first K) that differ from the reference's;
* `edges`     |directed edges of the program's graph - the reference's|;
* `llh_rel`   the worst relative LLH gap over the iterations;
* `hist_share` the worst share of rows that the accepted-step histograms
              put in another step, over the iterations. Steps of 1e-6 and less
              and no step are one bin: at such a step the Armijo test
              compares two LLHs of a row that differ by less than float32
              resolves, so float32 accepts or refuses them by rounding;
* `sumF_rel`  ||sumF - sumF_ref|| / ||sumF_ref|| after the last iteration;
* `delta_rel` the gap of the norms of the change from the seeded state,
              over the reference's norm;
* `rows_rel`  the gap of the sampled rows after the last iteration, over
              the norm of the reference's change of those rows. Sparse rows
              are compared as the rows of F they stand for
              (`sparse_delta_norm`), so wrong ids and wrong weights both
              show; a list that differs only in members of weight 0 (an
              admission whose rank is a rounding above or at 0) is the
              same F.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def dense_delta_norm(F: torch.Tensor, F0: torch.Tensor, block: int = 1 << 16) -> float:
    """||F - F0|| in float64, a block of rows at a time."""
    acc = 0.0
    for r0 in range(0, F.shape[0], block):
        d = F[r0:r0 + block].double() - F0[r0:r0 + block].double()
        acc += float((d * d).sum())
    return math.sqrt(acc)


def sparse_delta_norm(ids: torch.Tensor, w: torch.Tensor, ids0: torch.Tensor,
                      w0: torch.Tensor, k: int, block: int = 1 << 15) -> float:
    """||F - F0|| of two member-list states (rows (ids, w), ids = k empty),
    in float64: per row ||w||^2 + ||w0||^2 - 2 <F_u, F0_u>, the inner
    product over the ids both lists hold."""
    acc = 0.0
    for r0 in range(0, ids.shape[0], block):
        a, b = ids[r0:r0 + block].long(), ids0[r0:r0 + block].long()
        wa, wb = w[r0:r0 + block].double(), w0[r0:r0 + block].double()
        eq = (a[:, :, None] == b[:, None, :]) & (a < k)[:, :, None]
        dot = torch.bmm(eq.double(), wb[:, :, None])[:, :, 0]
        acc += float((wa * wa).sum() + (wb * wb).sum() - 2.0 * (wa * dot).sum())
    return math.sqrt(max(acc, 0.0))


def densify(ids: np.ndarray, w: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros((ids.shape[0], k + 1))
    np.put_along_axis(out, np.minimum(ids, k), w, axis=1)
    return out[:, :k]


# the first histogram slot pooled with every later one (step beta^6 = 1e-6)
POOL_FROM = 6


def pooled(hist) -> np.ndarray:
    h = np.asarray(hist, np.int64)
    return np.concatenate([h[:POOL_FROM], [h[POOL_FROM:].sum()]])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / den if den > 0 else float(
        np.linalg.norm(a - b) > 0) * math.inf


def readings(rep: str, prog: dict, ref: dict, k: int, n_live: int) -> dict:
    """The compared numbers of one run (module docstring). `prog` and
    `ref` hold seeds, edges, llh (per iteration), hists (per update) and
    state (the capture after the last iteration; `ref` also `rows0`)."""
    out = {}
    ps, rs = np.asarray(prog["seeds"][:k]), np.asarray(ref["seeds"][:k])
    out["seeds"] = (float(np.sum(ps != rs)) if len(ps) == len(rs)
                    else float(max(len(ps), len(rs))))
    out["edges"] = float(abs(int(prog["edges"]) - int(ref["edges"])))
    n_it = min(len(prog["llh"]), len(ref["llh"]))
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["llh"][:n_it], ref["llh"][:n_it])]
    if len(prog["llh"]) != len(ref["llh"]) or not all(map(math.isfinite, gaps)):
        gaps.append(math.inf)
    out["llh_rel"] = max(gaps)
    out["hist_share"] = max(
        float(np.abs(pooled(p) - pooled(r)).sum()) / (2.0 * n_live)
        for p, r in zip(prog["hists"], ref["hists"]))
    P, R = prog["state"], ref["state"]
    out["sumF_rel"] = _rel(P["sumF"], R["sumF"])
    out["delta_rel"] = (abs(P["delta_norm"] - R["delta_norm"]) / R["delta_norm"]
                        if R["delta_norm"] > 0 else math.inf)
    if rep == "sparse":
        def t(side):
            ids = np.asarray(side["ids"])
            w = np.where(ids < k, np.asarray(side["w"], np.float64), 0.0)
            return torch.from_numpy(ids), torch.from_numpy(w)

        gap = sparse_delta_norm(*t(P), *t(R), k)
        den = sparse_delta_norm(*t(R), *t(ref["rows0"]), k)
    else:
        gap = float(np.linalg.norm(P["rows"] - R["rows"]))
        den = float(np.linalg.norm(R["rows"] - ref["rows0"]))
    out["rows_rel"] = gap / den if den > 0 else math.inf
    return {name: (v if math.isfinite(v) else math.inf) for name, v in out.items()}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number within its limit; a
    number without a limit, or a limit without a number, is not correct."""
    rows, ok = [], set(values) == set(limits)
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name, math.inf), limits.get(name, -math.inf)
        rows.append((name, v, lim))
        ok = ok and v <= lim
    return ok, rows
