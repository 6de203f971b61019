"""The dense program under test: `BigClamModel` on its CSR path (on the
card, `csr_fused`: one fused-superstep launch an iteration).

The seeded state is made on the device: column c is the ego-net
indicator of seed c (the seed and its neighbours at 1.0), as the program's
`ops/seeding.py` `init_F` defines it, without a host (N, K) array.
"""

from __future__ import annotations

import numpy as np
import torch

from bigclam_tpu_torch.models.bigclam import BigClamModel
from clambench.compare import dense_delta_norm


def ego_pairs(csr, seeds: torch.Tensor):
    """(rows, cols): every (member, c) of the ego-nets {s_c} + N(s_c)."""
    starts, ends = csr.indptr[seeds], csr.indptr[seeds + 1]
    counts = ends - starts
    c = torch.arange(seeds.shape[0], device=seeds.device)
    cols = torch.repeat_interleave(c, counts)
    offset = torch.arange(cols.shape[0], device=seeds.device) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    nbrs = csr.indices[torch.repeat_interleave(starts, counts) + offset].long()
    return torch.cat([nbrs, seeds]), torch.cat([cols, c])


class Trainer:
    def __init__(self, g, cfg, device):
        self.model = BigClamModel(g, cfg, device=device)
        self.n, self.k = g.num_nodes, cfg.num_communities

    def seeded(self, seeds: np.ndarray):
        m = self.model
        s = torch.as_tensor(np.asarray(seeds[:self.k], np.int64), device=m.device)
        rows, cols = ego_pairs(m.csr, s)
        F = torch.zeros((m.n_pad, m.k_pad), dtype=m.dtype, device=m.device)
        F[rows, cols] = 1.0
        return m.reset_state(F)

    def fresh(self, state0):
        """A device copy of the seeded state, as a new fit starts from."""
        return self.model.reset_state(state0.F.clone())

    def padding_rows(self) -> int:
        return self.model.n_pad - self.n

    def capture(self, state, state0, rows: np.ndarray) -> dict:
        """What the comparison reads of a state: sampled rows, sumF and the
        norm of the change from the seeded state (float64, on the host)."""
        n, k = self.n, self.k
        F = state.F[:n, :k]
        r = torch.as_tensor(rows, device=F.device)
        return {"rows": F[r].double().cpu().numpy(),
                "sumF": state.sumF[:k].double().cpu().numpy(),
                "delta_norm": dense_delta_norm(F, state0.F[:n, :k])}
