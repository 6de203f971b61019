"""Plain PyTorch graph of the raw pairs: the reference's own CSR.

Self loops are dropped, each unordered pair kept once, and both
directions listed in (source, destination) order. Imports nothing of the
program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RefGraph(NamedTuple):
    n: int
    src: torch.Tensor      # (2E,) int64, sorted by (src, dst)
    dst: torch.Tensor      # (2E,) int64
    indptr: torch.Tensor   # (n+1,) int64

    @property
    def num_directed_edges(self) -> int:
        return int(self.src.shape[0])

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]


def build(pairs: np.ndarray, n: int, device) -> RefGraph:
    t = torch.from_numpy(np.ascontiguousarray(pairs, dtype=np.int64)).to(device)
    a = torch.minimum(t[:, 0], t[:, 1])
    b = torch.maximum(t[:, 0], t[:, 1])
    keep = a != b
    key = torch.unique(a[keep] * n + b[keep])
    lo, hi = key // n, key % n
    directed = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    src, dst = directed // n, directed % n
    counts = torch.bincount(src, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    return RefGraph(n=n, src=src, dst=dst, indptr=indptr)
