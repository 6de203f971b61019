"""The sparse program under test: `SparseBigClamModel` on the top-M member
lists (on the card, `sparse_merge_pallas`: the member lookups in the
program's CUDA kernel, the rest in torch).

The seeded lists are made on the device from the ego-nets of the seeds,
without a dense (N, K) array: node u lists the seeds' columns whose
ego-net holds it, weight 1.0, the lowest M ids where it is in more than M
(the program's `from_dense` rule: top M by weight, ties to the lower id).
They enter through `SparseBigClamModel.reset_state`.
"""

from __future__ import annotations

import numpy as np
import torch

from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from clambench.compare import sparse_delta_norm
from clambench.trainers.dense import ego_pairs


class Trainer:
    def __init__(self, g, cfg, device):
        self.model = SparseBigClamModel(g, cfg, device=device)
        self.n, self.k = g.num_nodes, cfg.num_communities

    def seeded(self, seeds: np.ndarray):
        m = self.model
        s = torch.as_tensor(np.asarray(seeds[:self.k], np.int64), device=m.device)
        rows, cols = ego_pairs(m.csr, s)
        key = torch.sort(rows * (self.k + 1) + cols).values
        node, cid = key // (self.k + 1), key % (self.k + 1)
        pos = torch.arange(node.shape[0], device=node.device) - torch.searchsorted(
            node, node)
        take = pos < m.m
        ids = torch.full((m.n_pad, m.m), self.k, dtype=torch.int32, device=m.device)
        ids[node[take], pos[take]] = cid[take].to(torch.int32)
        w = torch.zeros((m.n_pad, m.m), dtype=m.dtype, device=m.device)
        w[node[take], pos[take]] = 1.0
        return m.reset_state(ids, w)

    def fresh(self, state0):
        return self.model.reset_state(state0.ids.clone(), state0.F.clone())

    def padding_rows(self) -> int:
        return self.model.n_pad - self.n

    def capture(self, state, state0, rows: np.ndarray) -> dict:
        n, k = self.n, self.k
        r = torch.as_tensor(rows, device=state.F.device)
        return {"ids": state.ids[r].long().cpu().numpy(),
                "w": state.F[r].double().cpu().numpy(),
                "sumF": state.sumF[:k].double().cpu().numpy(),
                "delta_norm": sparse_delta_norm(state.ids[:n], state.F[:n],
                                                state0.ids[:n], state0.F[:n], k)}
