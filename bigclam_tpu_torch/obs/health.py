"""Model-health monitoring + anomaly detection (host half).

Copied from bigclam_tpu/obs/health.py, pointed at the port's
ops.diagnostics. The device half (ops.diagnostics) computes a compact
health pack inside the train step on cadence iterations; this module is the
consumer run_fit_loop drives at the cfg.health_every cadence:

* HealthMonitor fetches the pack (one tiny D2H per cadence iteration,
  after the loop's existing LLH sync), adds what only the host can know —
  LLH delta / slope / relative change over the sample window, membership
  churn against a rolling device-resident top-community signature, the
  exchanged-ids high-water — and emits one `health` event per sample.

* run_detectors is a PURE function over the sample window (list of
  dicts in, list of anomaly dicts out — unit-testable without a device), with
  deterministic, threshold-based rules:

    divergence    LLH below the best-so-far by more than div_tol for
                  div_patience consecutive samples (catches both the
                  monotone slope blow-up and a growing oscillation; a
                  healthy Armijo ascent never degrades past float noise)
    plateau       |relative LLH change| inside max(plateau_mult *
                  conv_tol, plateau_floor) for plateau_patience
                  consecutive samples — the fit is crawling just above
                  the stop rule (or, at conv_tol=0, flat outright):
                  plateau-before-tol, the K-sweep stop rule's blind spot
    oscillation   LLH deltas strictly alternating sign with relative
                  magnitude above osc_min_rel for osc_patience
                  consecutive alternations (step ladder too hot)
    dead_communities   dead-column fraction >= dead_frac_max (gradient
                  dynamics can never revive an all-zero column — see
                  PARITY.md; quality mode exists for this)
    cap_pressure  sparse-allreduce occupancy >= cap_frac of the comm
                  cap, or a runtime dense-psum fallback fired — the
                  build-time cap guess (arXiv:1312.3020) is invalidated

Each anomaly kind fires at most ONCE per monitor (= per fit loop): the
events are findings, and a 40-sample divergence is one finding, not 40
lines. Thresholds are host-side knobs (DEFAULTS, overridable per
monitor), deliberately NOT config fields: they gate nothing and must not
rebaseline the perf ledger's cfg digests.

The emitted `health` events also enrich the rest of the stack: telemetry
keeps the last snapshot (RunTelemetry.last_health) so heartbeat stall /
stall_escalated reports distinguish "stuck compiling" from "diverging",
and the run report grows a health section.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

# NOTE: ops.diagnostics (and with it torch) is imported LAZILY inside the
# monitor methods; run_detectors is pure numpy by design.

# detector thresholds (see module docstring); all overridable via the
# HealthMonitor `thresholds` kwarg / run_detectors argument
DEFAULTS: Dict[str, float] = {
    "div_tol": 0.02,         # rel degradation vs best-so-far LLH
    "div_patience": 3,       # consecutive degraded samples
    "plateau_mult": 3.0,     # plateau band = plateau_mult * conv_tol ...
    "plateau_floor": 1e-7,   # ... floored here (conv_tol=0 probe runs)
    "plateau_patience": 8,   # consecutive flat samples
    "osc_patience": 5,       # consecutive sign alternations
    "osc_min_rel": 1e-6,     # alternation magnitude floor (rel to |llh|)
    "dead_frac_max": 0.75,   # dead-community fraction alarm
    "cap_frac": 0.85,        # comm-cap occupancy alarm
}

# trailing samples the detectors look at (divergence additionally uses
# the monitor's running best, so the bound does not blunt it)
WINDOW = 64

# pack slots that mean "not produced by this trainer" when negative
_NA_SLOTS = (
    "support_churn", "cap_occupancy", "dense_fallback", "exchanged_ids",
)
_INT_FIELDS = ("active_comms", "exchanged_ids")


def _rel(a: float, b: float) -> float:
    """|a - b| relative to |b| with the b == 0 corner (all-zero F0 has
    LLH exactly 0.0) handled like models.bigclam._rel_change."""
    if b == 0.0:
        return 0.0 if a == 0.0 else float("inf")
    return abs(a - b) / abs(b)


def run_detectors(
    samples: List[Dict[str, Any]],
    best_llh: Optional[float],
    conv_tol: float,
    thresholds: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """Anomalies present in the CURRENT window (pure; see module
    docstring for the rules). `samples` is the ordered health-sample
    window (dicts with at least iter + llh; optional dead_frac,
    cap_occupancy, dense_fallback), `best_llh` the best LLH ever
    observed by the monitor (None = use the window max). De-duplication
    across calls is the caller's job (HealthMonitor fires each check
    once)."""
    th = {**DEFAULTS, **(thresholds or {})}
    out: List[Dict[str, Any]] = []
    if not samples:
        return out
    last = samples[-1]
    it = int(last.get("iter", -1))
    if best_llh is not None:
        best = best_llh
    else:
        llhs = [s["llh"] for s in samples if isinstance(
            s.get("llh"), (int, float)) and math.isfinite(s.get("llh"))]
        best = max(llhs) if llhs else None

    # --- divergence: trailing run of samples degraded past div_tol ---
    if best is not None and math.isfinite(best):
        run = 0
        worst_drop = 0.0
        for s in reversed(samples):
            llh = s.get("llh")
            if not isinstance(llh, (int, float)) or not math.isfinite(llh):
                break
            drop = _rel(llh, best) if llh < best else 0.0
            if llh < best and drop > th["div_tol"]:
                run += 1
                worst_drop = max(worst_drop, drop)
            else:
                break
        if run >= th["div_patience"]:
            out.append({
                "check": "divergence", "iter": it, "samples": run,
                "rel_drop": round(worst_drop, 6), "best_llh": best,
            })

    # --- plateau-before-tol: trailing run of flat samples ---
    band = max(th["plateau_mult"] * float(conv_tol), th["plateau_floor"])
    run = 0
    for prev, cur in zip(reversed(samples[:-1]), reversed(samples)):
        a, b = cur.get("llh"), prev.get("llh")
        if not (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and math.isfinite(a) and math.isfinite(b)):
            break
        if _rel(a, b) < band:
            run += 1
        else:
            break
    if run >= th["plateau_patience"]:
        out.append({
            "check": "plateau", "iter": it, "samples": run,
            "band": band, "conv_tol": conv_tol,
        })

    # --- oscillation: trailing strict sign alternation of LLH deltas ---
    deltas = []
    for prev, cur in zip(samples[:-1], samples[1:]):
        a, b = prev.get("llh"), cur.get("llh")
        if not (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and math.isfinite(a) and math.isfinite(b)):
            deltas.append(0.0)
            continue
        deltas.append(b - a)
    flips = 0
    for d_prev, d_cur in zip(reversed(deltas[:-1]), reversed(deltas)):
        scale = max(abs(samples[-1]["llh"]), 1e-30)
        if (
            d_prev * d_cur < 0
            and abs(d_cur) / scale > th["osc_min_rel"]
            and abs(d_prev) / scale > th["osc_min_rel"]
        ):
            flips += 1
        else:
            break
    if flips >= th["osc_patience"]:
        out.append({
            "check": "oscillation", "iter": it, "alternations": flips,
        })

    # --- dead communities ---
    df = last.get("dead_frac")
    if isinstance(df, (int, float)) and df >= th["dead_frac_max"]:
        out.append({
            "check": "dead_communities", "iter": it,
            "dead_frac": round(float(df), 4),
            "dead_comms": last.get("dead_comms"),
        })

    # --- sparse comm-cap pressure ---
    occ = last.get("cap_occupancy")
    fb = last.get("dense_fallback")
    occ_hot = isinstance(occ, (int, float)) and occ >= th["cap_frac"]
    fell_back = isinstance(fb, (int, float)) and fb >= 1.0
    if occ_hot or fell_back:
        out.append({
            "check": "cap_pressure", "iter": it,
            "cap_occupancy": occ, "dense_fallback": fell_back,
        })
    return out


class HealthMonitor:
    """One fit loop's health consumer (constructed by run_fit_loop when
    telemetry is active and cfg.health_every > 0). Not thread-safe — it
    runs on the fit loop's thread, like the loop's other bookkeeping."""

    def __init__(self, cfg, telemetry, sig_fn=None, n_live=None,
                 thresholds: Optional[Dict[str, float]] = None):
        self.every = max(int(getattr(cfg, "health_every", 1) or 1), 1)
        self.k = max(int(cfg.num_communities), 1)
        self.conv_tol = float(cfg.conv_tol)
        self.tel = telemetry
        self.sig_fn = sig_fn
        # live node count for the churn denominator (the signature is
        # PADDED; padding rows are -1 forever and never churn, so
        # dividing by the padded length would systematically dilute the
        # fraction). None = unknown, fall back to the signature length.
        self.n_live = int(n_live) if n_live else None
        self.th = {**DEFAULTS, **(thresholds or {})}
        self.samples: List[Dict[str, Any]] = []
        self.best_llh: Optional[float] = None
        self.exchanged_max = 0.0
        self._sig = None
        self._fired: set = set()

    def maybe_observe(self, it: int, llh: float, state) -> None:
        """Per-iteration hook (run_fit_loop): one modulo + one getattr
        off-cadence."""
        if it % self.every:
            return
        pack = getattr(state, "health", None)
        if pack is None:
            return
        import torch

        from bigclam_tpu_torch.ops.diagnostics import HEALTH_INDEX

        vec = pack.detach().to("cpu", torch.float64).numpy()
        if vec[HEALTH_INDEX["iter"]] < 0:
            return              # pack's cond disagreed (resumed mid-cadence)
        self.observe(it, llh, vec, state)

    def observe(self, it: int, llh: float, vec: np.ndarray, state) -> None:
        from bigclam_tpu_torch.ops.diagnostics import HEALTH_FIELDS, HEALTH_INDEX, NA

        fields: Dict[str, Any] = {}
        for name in HEALTH_FIELDS:
            if name in ("iter", "llh"):
                continue        # stamped from the loop's own scalars
            v = float(vec[HEALTH_INDEX[name]])
            if name in _NA_SLOTS and v == NA:
                continue        # trainer does not produce this slot
            fields[name] = int(v) if name in _INT_FIELDS else round(v, 8)
        active = int(fields.get("active_comms", self.k))
        dead = max(self.k - active, 0)
        fields["dead_comms"] = dead
        fields["dead_frac"] = round(dead / self.k, 6)
        if "exchanged_ids" in fields:
            self.exchanged_max = max(
                self.exchanged_max, fields["exchanged_ids"]
            )
            fields["exchanged_max"] = int(self.exchanged_max)
        # membership churn vs the rolling snapshot: an (N,) int32 device
        # signature, compared device-side — no F fetch
        if self.sig_fn is not None:
            from bigclam_tpu_torch.ops.diagnostics import sig_changed

            try:
                sig = self.sig_fn(state)
            except Exception:
                sig = None      # diagnostics must never kill the fit
            if sig is not None:
                if self._sig is not None:
                    changed = int(sig_changed(self._sig, sig))
                    denom = self.n_live or int(np.prod(sig.shape))
                    fields["churn"] = round(changed / max(denom, 1), 6)
                self._sig = sig
        # LLH-window derivatives
        prev = self.samples[-1] if self.samples else None
        if prev is not None and math.isfinite(llh) and math.isfinite(prev["llh"]):
            delta = llh - prev["llh"]
            fields["llh_delta"] = delta
            if it > prev["iter"]:
                fields["llh_slope"] = delta / (it - prev["iter"])
            fields["llh_rel_change"] = _rel(llh, prev["llh"])
        sample = {"iter": it, "llh": llh, **fields}
        self.samples.append(sample)
        del self.samples[:-WINDOW]
        if math.isfinite(llh) and (
            self.best_llh is None or llh > self.best_llh
        ):
            self.best_llh = llh
        self.tel.event("health", **sample)
        for anomaly in run_detectors(
            self.samples, self.best_llh, self.conv_tol, self.th
        ):
            if anomaly["check"] in self._fired:
                continue
            self._fired.add(anomaly["check"])
            self.tel.event("anomaly", **anomaly)
