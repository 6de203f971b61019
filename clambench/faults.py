"""Faults planted in the program's train step, to see the comparison fail
(the CPU tests, and the readings that set each limit's upper end). Never
used by a benchmark run.

* `frozen`     the step returns its state unchanged (its LLH still read);
* `half_rows`  the update of the second half of the rows left out;
* `altered`    one answer altered where it is produced: the largest
               entry of F + 1.
"""

from __future__ import annotations

import torch


def _sumF(state, F):
    if getattr(state, "ids", None) is None:
        return F.sum(0)
    k = state.sumF.shape[0]
    valid = state.ids < k
    out = torch.zeros(k + 1, dtype=F.dtype, device=F.device)
    out.index_add_(0, torch.where(valid, state.ids, k).reshape(-1).long(),
                   torch.where(valid, F, 0.0).reshape(-1))
    return out[:k]


def frozen(step):
    def f(state):
        new = step(state)
        return new._replace(F=state.F, sumF=state.sumF,
                            **({"ids": state.ids} if hasattr(state, "ids") else {}))
    return f


def half_rows(step):
    def f(state):
        new = step(state)
        F = new.F.clone()
        half = F.shape[0] // 2
        if hasattr(state, "ids"):
            # the old weights where the lists agree, 0 where a slot is new
            same = new.ids[half:] == state.ids[half:]
            F[half:] = torch.where(same, state.F[half:], torch.zeros_like(F[half:]))
        else:
            F[half:] = state.F[half:]
        return new._replace(F=F, sumF=_sumF(new, F))
    return f


def altered(step):
    def f(state):
        new = step(state)
        F = new.F.clone()
        F.view(-1)[torch.argmax(F)] += 1.0
        return new._replace(F=F, sumF=_sumF(new, F))
    return f


FAULTS = {"frozen": frozen, "half_rows": half_rows, "altered": altered}
