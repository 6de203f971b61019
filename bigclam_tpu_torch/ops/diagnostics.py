"""Model-health diagnostics computed inside the train step.

Port of bigclam_tpu/ops/diagnostics.py (the JAX version is jnp, not a
Pallas kernel, so this is plain torch). On cadence iterations the steps
pack

    grad norm / max, update norm, effective Armijo step + accept
    fraction, active-community count, top-community mass share, max F
    entry, and (sparse) support churn

into one (HEALTH_LEN,) float32 vector riding the train state
(`state.health`). The pack is gated by `cfg.health_every`:

* `health_every == 0` (the config default): the steps return
  `health=None` and compute NOTHING — the trajectory is bit-identical to
  a trainer without health.
* `health_every > 0`: the iteration counter is a host int in the port's
  states, so the step computes the pack only when `it % health_every ==
  0` (a host `if`); other iterations return None (the sparse step returns
  its latched support churn instead, see latch_extras) and cost nothing
  on the dense paths.

The field order, names and NA sentinel are the JAX package's, so the two
packs compare slot by slot, in float32 as there. Each reduction reads its
inputs once and writes no temporary the size of F (a dot product for the
sum of squares, the inf-norm for max |grad|, torch.dist for the update):
the pack is a handful of passes over F and the gradient. All of them
propagate NaN, as jnp.max does.

The host side (obs.health.HealthMonitor, driven from run_fit_loop)
fetches the vector only on cadence iterations and adds the LLH-window
derivatives and the membership churn against a rolling top-community
signature (the `*_top_community` maps below — an (N,) int32 argmax, not an
F copy).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

# Field order of the health vector (bigclam_tpu/ops/diagnostics.py)
HEALTH_FIELDS = (
    "iter",            # iteration the pack describes (the update it->it+1)
    "llh",             # LLH of the step's INPUT F (host-stamped; NaN here)
    "grad_norm",       # global L2 norm of the gradient
    "grad_max",        # global max |grad| entry
    "update_norm",     # global L2 norm of F_new - F_old (the applied update)
    "step_eff",        # accept-weighted mean Armijo step (0 = all rejected)
    "accept_frac",     # fraction of rows that accepted any candidate step
    "active_comms",    # communities with column mass > ACTIVE_EPS
    "top_share",       # largest column mass / total mass
    "f_max",           # max F entry (box-ceiling proximity)
    "support_churn",   # sparse: fraction of member-id slots changed by the
                       # support update (NA on dense)
    "cap_occupancy",   # sparse sharded exchange (not ported: NA)
    "dense_fallback",  # sparse sharded exchange (not ported: NA)
    "exchanged_ids",   # sparse sharded exchange (not ported: NA)
)
HEALTH_LEN = len(HEALTH_FIELDS)
HEALTH_INDEX = {name: i for i, name in enumerate(HEALTH_FIELDS)}

# sentinel for slots a trainer does not produce
NA = -1.0
# a community column counts as alive above this mass (padding columns
# are exact zeros, so they never count)
ACTIVE_EPS = 1e-12

F32 = torch.float32
Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def health_on(cfg) -> bool:
    """The single engagement predicate (the steps branch on it; the off
    path adds nothing)."""
    return int(getattr(cfg, "health_every", 0) or 0) > 0


def on_cadence(cfg, it: int) -> bool:
    """Does the step whose input iteration is `it` compute the pack?"""
    return health_on(cfg) and int(it) % max(int(cfg.health_every), 1) == 0


def _shards(x: Tensors) -> list:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def grad_stats(grad: Tensors) -> torch.Tensor:
    """(2,) float32 [sum of grad^2, max |grad|] over a gradient or its row
    shards (summed and maxed in shard order on the first shard's
    device)."""
    parts = _shards(grad)
    dev = parts[0].device
    gsq = sum(torch.dot(g.reshape(-1), g.reshape(-1)).to(F32).to(dev)
              for g in parts)
    gmax = torch.stack([
        torch.linalg.vector_norm(g, ord=float("inf")).to(F32).to(dev)
        for g in parts
    ]).amax()
    return torch.stack([gsq, gmax])


def latch_extras(prev_health: Optional[torch.Tensor], extras: Dict[str, torch.Tensor]):
    """Max-since-last-sample latch for the cheap per-step slots (the
    sparse support churn): a burst on an OFF-cadence step must still show
    in the next health sample, so the scalar is computed every step and
    folded into a running max that resets after each computed sample. NA
    (-1) is the max identity, so never-produced slots stay NA.

    Returns (latched extras dict, carry vector): the pack emits the
    latched values on cadence; off cadence the step returns the carry so
    the latch rides state.health (iter slot NA)."""
    if prev_health is None:
        dev = next(iter(extras.values())).device
        prev_health = torch.full((HEALTH_LEN,), NA, dtype=F32, device=dev)
    sampled_last = prev_health[HEALTH_INDEX["iter"]] >= 0
    out: Dict[str, torch.Tensor] = {}
    carry = torch.full((HEALTH_LEN,), NA, dtype=F32, device=prev_health.device)
    na = torch.tensor(NA, dtype=F32, device=prev_health.device)
    for name, cur in extras.items():
        idx = HEALTH_INDEX[name]
        base = torch.where(sampled_last, na, prev_health[idx])
        val = torch.maximum(base, cur.to(F32))
        out[name] = val
        carry[idx] = val
    return out, carry


def health_pack(
    cfg,
    it: int,
    F_old: Tensors,
    F_new: Tensors,
    sumF_new: torch.Tensor,
    accept_hist: torch.Tensor,
    grad: Tensors = None,
    extras: Optional[Dict[str, torch.Tensor]] = None,
    skip_carry: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """The (HEALTH_LEN,) float32 pack on cadence iterations; off cadence
    `skip_carry` (None unless a latch rides it) and no work.

    `it` is the step's INPUT iteration counter; F_old / F_new / grad may
    be tensors or tuples of row shards (the mesh trainers). `extras` are named
    overrides of the sparse slots (pre-latched via latch_extras). llh is
    stamped by the host monitor."""
    if not on_cadence(cfg, it):
        return skip_carry
    gs = grad_stats(grad)
    olds, news = _shards(F_old), _shards(F_new)
    dev = sumF_new.device
    norms = [torch.dist(n, o).to(F32).to(dev) for o, n in zip(olds, news)]
    update_norm = norms[0] if len(norms) == 1 else torch.sqrt(
        sum(x * x for x in norms))
    etas = torch.tensor(cfg.step_candidates, dtype=F32, device=accept_hist.device)
    hist = accept_hist.to(F32)
    total = torch.clamp(hist.sum(), min=1.0)
    accepted = hist[:-1]
    colmass = sumF_new.to(F32)
    mass = colmass.sum()
    f_max = torch.stack([torch.amax(n).to(dev) for n in news]).amax().to(F32)
    slots = {
        "iter": torch.tensor(float(it), dtype=F32, device=dev),
        "llh": torch.tensor(float("nan"), dtype=F32, device=dev),
        "grad_norm": torch.sqrt(gs[0]).to(dev),
        "grad_max": gs[1].to(dev),
        "update_norm": update_norm,
        "step_eff": ((etas * accepted).sum() / total).to(dev),
        "accept_frac": (accepted.sum() / total).to(dev),
        "active_comms": (colmass > ACTIVE_EPS).sum().to(F32),
        "top_share": torch.amax(colmass) / torch.clamp(mass, min=ACTIVE_EPS),
        "f_max": f_max,
        "support_churn": torch.tensor(NA, dtype=F32, device=dev),
        "cap_occupancy": torch.tensor(NA, dtype=F32, device=dev),
        "dense_fallback": torch.tensor(NA, dtype=F32, device=dev),
        "exchanged_ids": torch.tensor(NA, dtype=F32, device=dev),
    }
    for name, val in (extras or {}).items():
        assert name in slots, name
        slots[name] = val.to(F32).to(dev)
    return torch.stack([slots[name] for name in HEALTH_FIELDS])


# ------------------------------------------------------- membership churn
# (N,) int32 top-community signatures: the rolling snapshot the monitor
# keeps on the device between health samples. -1 marks empty (all-zero)
# rows, so padding rows compare equal forever and never contribute churn.


def dense_top_community(F: Tensors) -> torch.Tensor:
    """Top community of every row of F (or of its row shards, concatenated
    on the first shard's device); -1 for an all-zero row."""
    parts = _shards(F)
    dev = parts[0].device
    out = []
    for f in parts:
        arg = torch.argmax(f, dim=1).to(torch.int32)
        out.append(torch.where(torch.amax(f, dim=1) > 0, arg,
                               torch.full_like(arg, -1)).to(dev))
    return torch.cat(out)


def sparse_top_community(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Top community of every row of a member-list state; -1 on empty
    rows."""
    j = torch.argmax(w, dim=1)
    top = torch.gather(ids, 1, j[:, None])[:, 0].to(torch.int32)
    return torch.where(torch.amax(w, dim=1) > 0, top, torch.full_like(top, -1))


def sig_changed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count of signature entries that differ (the host divides by the
    live row count for the churn fraction)."""
    return (a != b).sum().to(torch.int32)
