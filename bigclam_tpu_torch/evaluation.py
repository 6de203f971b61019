"""Evaluation against ground-truth communities: average best-match F1 and
overlapping NMI.

Copied from bigclam_tpu/evaluation.py.

F1: the symmetric average best-match F1 of Yang & Leskovec (WSDM'13 §5):
    F1(P, T) = 1/2 * ( mean_i max_j f1(p_i, t_j) + mean_j max_i f1(p_i, t_j) )

NMI: overlapping-cover NMI of Lancichinetti, Fortunato & Kertesz (NJP 2009),
per-community binary variables with the admissibility constraint
h(P11) + h(P00) >= h(P01) + h(P10) on candidate matches.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def f1_score_pair(a: frozenset, b: frozenset) -> float:
    inter = len(a & b)
    if inter == 0:
        return 0.0
    p = inter / len(a)
    r = inter / len(b)
    return 2 * p * r / (p + r)


def avg_f1(pred: Sequence[Iterable[int]], truth: Sequence[Iterable[int]]) -> float:
    """Symmetric average best-match F1 in [0, 1]."""
    P = [frozenset(c) for c in pred if len(c)]
    T = [frozenset(c) for c in truth if len(c)]
    if not P or not T:
        return 0.0
    # inverted index: only communities sharing >= 1 node can score f1 > 0
    node_to_t: dict[int, list[int]] = {}
    for j, t in enumerate(T):
        for u in t:
            node_to_t.setdefault(u, []).append(j)
    best_pt = np.zeros(len(P))
    best_tp = np.zeros(len(T))
    for i, p in enumerate(P):
        cands = {j for u in p for j in node_to_t.get(u, ())}
        for j in cands:
            s = f1_score_pair(p, T[j])
            if s > best_pt[i]:
                best_pt[i] = s
            if s > best_tp[j]:
                best_tp[j] = s
    return 0.5 * (best_pt.mean() + best_tp.mean())


def _h(p):
    """Entropy contribution -p*log2(p) (elementwise, 0 at p=0)."""
    p = np.asarray(p, dtype=np.float64)
    out = np.zeros_like(p)
    nz = p > 0
    out[nz] = -p[nz] * np.log2(p[nz])
    return out if out.ndim else float(out)


def _cover_matrix(cover: Sequence[Iterable[int]], nodes: dict[int, int]) -> np.ndarray:
    M = np.zeros((len(cover), len(nodes)), dtype=bool)
    for i, c in enumerate(cover):
        for u in c:
            M[i, nodes[u]] = True
    return M


def overlapping_nmi(
    pred: Sequence[Iterable[int]], truth: Sequence[Iterable[int]]
) -> float:
    """LFK overlapping NMI in [0, 1] over the union of covered nodes."""
    pred = [list(c) for c in pred if len(c)]
    truth = [list(c) for c in truth if len(c)]
    if not pred or not truth:
        return 0.0
    nodes = {u: i for i, u in enumerate(sorted({u for c in pred + truth for u in c}))}
    n = len(nodes)
    X = _cover_matrix(pred, nodes)
    Y = _cover_matrix(truth, nodes)

    def cond_norm(A: np.ndarray, B: np.ndarray) -> float:
        """mean_i min_j H(a_i | b_j) / H(a_i), with the LFK admissibility rule."""
        pb1 = B.mean(axis=1)
        hB = _h(pb1) + _h(1 - pb1)
        ratios = []
        for i in range(A.shape[0]):
            a = A[i]
            pa1 = a.mean()
            ha = float(_h(pa1) + _h(1 - pa1))
            if ha == 0.0:
                ratios.append(1.0)  # degenerate (empty/full) community carries
                continue            # no information about the other cover
            d = (B & a).sum(axis=1) / n          # P(a=1, b=1)
            c = (~B & a).sum(axis=1) / n         # P(a=1, b=0)
            b_ = (B & ~a).sum(axis=1) / n        # P(a=0, b=1)
            e = (~B & ~a).sum(axis=1) / n        # P(a=0, b=0)
            hd, hc, hb, he = _h(d), _h(c), _h(b_), _h(e)
            admissible = (hd + he) >= (hc + hb)
            h_cond = (hd + hc + hb + he) - hB     # H(a,b) - H(b)
            h_cond = np.where(admissible, h_cond, ha)
            ratios.append(float(np.min(h_cond)) / ha)
        return float(np.mean(ratios))

    return 1.0 - 0.5 * (cond_norm(X, Y) + cond_norm(Y, X))
