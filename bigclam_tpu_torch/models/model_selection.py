"""Automatic selection of the community count K (`cli sweep`).

Port of bigclam_tpu/models/model_selection.py, itself from the v4
reference (bigclam4-7.scala:115-133, the log-spaced K grid, and :244-266,
the sweep): seeds are computed once, at K_max, and reused for every K; each
K in the grid is seeded and trained to convergence; the sweep stops at the
first K whose relative LLH improvement over the previous K falls below
ksweep_tol ((1 - LLH_K/LLH_Kold) < tol, a signed ratio, as the reference
has it), the first K priming LLH_Kold.

F is allocated once at K_max and the columns >= K are zero (inert: their
edge terms and steps are 0 while min_f == 0), so one model serves every K.
Each K draws its random padding columns from its own generator
(default_rng([seed, K]), or child seeds drawn once from a caller's rng),
so a sweep resumed from its journal (state_dir/sweep_state.json, written
through a .tmp file and os.replace, the JAX format) equals the
uninterrupted one. With cfg.checkpoint_every > 0 each K's fit also
checkpoints WITHIN the K (state_dir/k_<K>/, the JAX layout), so a crash
inside one K resumes inside it; a K's checkpoints are deleted once its LLH
is journaled.

Not ported yet, and refused by name (NotPortedError): quality mode and
device annealing, and a mesh.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
from typing import Callable, Dict, List, Optional

import numpy as np

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel, FitResult
from bigclam_tpu_torch.ops import seeding


class NotPortedError(NotImplementedError):
    """A sweep option of the JAX package that the port does not have yet."""


def build_kset(min_com: int, max_com: int, div_com: int) -> List[int]:
    """The log-spaced K grid, exactly as bigclam4-7.scala:116-133.

    conGap = exp(log(maxCom/minCom)/divCom) with Scala *integer* division of
    maxCom/minCom; the walk multiplies-and-truncates, bumps by 1 when stuck,
    stops at maxCom and appends it. Golden: (50, 200, 15) reproduces the
    pasted run artifact Array(50, 54, 59, ..., 184, 200) at v4:268.
    """
    if min_com <= 0 or max_com < min_com:
        raise ValueError(f"need 0 < min_com <= max_com, got {min_com}, {max_com}")
    ratio = max_com // min_com               # Scala Int/Int division
    if ratio < 1:
        return [int(min_com), int(max_com)]
    con_gap = math.exp(math.log(ratio) / div_com)
    kset = [int(min_com)]
    x = int(min_com)
    while True:
        xtemp = int(x * con_gap)             # .toInt truncation
        if xtemp == x:
            xtemp += 1
        x = xtemp
        if x >= max_com:
            break
        kset.append(x)
    kset.append(int(max_com))
    return kset


@dataclasses.dataclass(frozen=True)
class SweepResult:
    chosen_k: int                 # KforC: first K with sub-tol improvement
    llh_by_k: Dict[int, float]    # converged LLH per trained K
    kset: List[int]               # the full grid (sweep may stop early)
    best_fit: Optional[FitResult]  # fit at the last trained K


def check_sweep_supported(cfg: BigClamConfig, device_annealing: bool = False) -> None:
    """Raise NotPortedError for the sweep options the port lacks."""
    if cfg.quality_mode or device_annealing:
        raise NotPortedError(
            "the quality-mode sweep (annealing per K, device annealing) is "
            "not ported yet (ROADMAP queue 1 item 13)"
        )
    if tuple(cfg.mesh_shape) != (1, 1) or cfg.partition != "1d":
        raise NotPortedError(
            "a sweep over a device mesh is not ported yet (ROADMAP queue 1 "
            "item 14); the port sweeps on one device"
        )


def sweep_k(
    g: Graph,
    cfg: BigClamConfig,
    model_factory: Optional[Callable[[BigClamConfig], object]] = None,
    callback: Optional[Callable[[int, float], None]] = None,
    rng: Optional[np.random.Generator] = None,
    state_dir: Optional[str] = None,
    device_annealing: bool = False,
    resume: bool = True,
    device=None,
    seed_backend: str = "auto",
) -> SweepResult:
    """Train across the K grid and pick KforC (bigclam4-7.scala:244-266).

    model_factory(cfg_at_kmax) may supply another trainer (the sparse one);
    the default is BigClamModel(g, cfg_at_kmax, device), with F at the grid
    max so one model serves every K.

    When state_dir is given, per-K converged LLHs are journaled to
    state_dir/sweep_state.json and already-trained Ks are skipped on
    restart; `resume=False` ignores an existing journal (every K retrains)
    while still journaling fresh results. With cfg.checkpoint_every > 0 a
    K's fit also checkpoints into state_dir/k_<K>/ (resumed unless
    resume=False), deleted once the K is journaled. callback(k, llh) is called for
    every K the sweep reaches, journaled or trained. The seeds come from
    ops.seeding.conductance_seeds at K_max with cfg.seeding_degree_cap and
    the `seed_backend` scorer, its device backends on the model's device.
    """
    check_sweep_supported(cfg, device_annealing)
    kset = build_kset(cfg.min_com, cfg.max_com, cfg.div_com)
    k_max = kset[-1]
    cfg_max = cfg.replace(num_communities=k_max)
    model = (
        model_factory(cfg_max) if model_factory is not None
        else BigClamModel(g, cfg_max, device=device)
    )
    # per-K generators fixed up front: a journaled K skips init_F on
    # resume, so a shared generator would leave later Ks at another stream
    # position than the uninterrupted run
    if rng is None:
        k_rngs = {k: np.random.default_rng([cfg.seed, k]) for k in kset}
    else:
        child = rng.integers(2**63, size=len(kset))
        k_rngs = {
            k: np.random.default_rng(int(s)) for k, s in zip(kset, child)
        }
    seeds = seeding.conductance_seeds(                # once, at K_max
        g, cfg_max, backend=seed_backend, device=model.device
    )

    llh_by_k: Dict[int, float] = {}
    state_path = None
    if state_dir is not None:
        os.makedirs(state_dir, exist_ok=True)
        state_path = os.path.join(state_dir, "sweep_state.json")
        if resume and os.path.exists(state_path):
            with open(state_path) as f:
                llh_by_k = {int(k): v for k, v in json.load(f).items()}

    llh_old: Optional[float] = None
    chosen = kset[-1]
    best_fit: Optional[FitResult] = None
    for k in kset:
        if k in llh_by_k:                           # journaled on a prior run
            res_llh = llh_by_k[k]
        else:
            ckpt_k = ckpt_dir = None
            if state_dir is not None and cfg.checkpoint_every > 0:
                from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

                ckpt_dir = os.path.join(state_dir, f"k_{k:06d}")
                ckpt_k = CheckpointManager(ckpt_dir)
            F0k = seeding.init_F(
                g, seeds, cfg.replace(num_communities=k), k_rngs[k]
            )
            F0 = np.zeros((g.num_nodes, k_max))
            F0[:, :k] = F0k                         # columns >= k stay zero
            res = model.fit(F0, checkpoints=ckpt_k, resume=resume)
            res_llh = res.llh
            llh_by_k[k] = res_llh
            best_fit = res
            if state_path is not None:
                with open(state_path + ".tmp", "w") as f:
                    json.dump({str(kk): v for kk, v in llh_by_k.items()}, f)
                os.replace(state_path + ".tmp", state_path)
            if ckpt_dir is not None:
                # journaled: the K's checkpoints are spent, and must never
                # leak into a later K, whose model shape they would match
                shutil.rmtree(ckpt_dir, ignore_errors=True)
        if callback is not None:
            callback(k, res_llh)
        if llh_old is not None and llh_old != 0.0:
            if (1.0 - res_llh / llh_old) < cfg.ksweep_tol:
                chosen = k                          # KforC = current K (v4:260)
                break
        llh_old = res_llh
    return SweepResult(
        chosen_k=chosen, llh_by_k=llh_by_k, kset=kset, best_fit=best_fit
    )
