"""Typed configuration of the PyTorch port.

Copied from bigclam_tpu/config.py (`BigClamConfig`): the same field names,
defaults and order, so a JAX config carries over unchanged with
`BigClamConfig(**dataclasses.asdict(jax_cfg))`. The port reads the
model, clipping, line-search, loop, K-sweep, seeding, quality-mode
(models/quality.py), resilience, numerics, kernel-path, 1D-mesh (K
sharding included), 2D-partition (`partition`, `replica_cols`,
`grad_exchange`, `closure_grad_cap`: parallel/twod.py) and
sparse-representation fields (the sharded exchange's cap among them);
the TPU tile fields are carried for that round trip only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BigClamConfig:
    """Hyper-parameters of BigCLAM gradient ascent (reference defaults)."""

    # --- model size ---
    num_communities: int = 100          # K

    # --- probability / F clipping ---
    min_p: float = 1e-4                 # lower clip of exp(-Fu.Fv)
    max_p: float = 0.9999               # upper clip of exp(-Fu.Fv)
    min_f: float = 0.0                  # box lower bound on F entries
    max_f: float = 1000.0               # box upper bound on F entries

    # --- Armijo backtracking line search ---
    alpha: float = 0.05                 # Armijo slope factor
    beta: float = 0.1                   # geometric step shrink factor
    max_backtracks: int = 15            # 16 candidates {1, beta, ..., beta^15}

    # --- outer loop ---
    conv_tol: float = 1e-4              # stop when |1 - LLH_new/LLH_old| < tol
    max_iters: int = 1000               # safety cap

    # --- K-sweep model selection (models/model_selection.py) ---
    min_com: int = 1000
    max_com: int = 9000
    div_com: int = 100
    ksweep_tol: float = 1e-3

    # --- seeding ---
    seed_include_self: bool = True      # ego-net indicator includes the seed
    isolated_phi_sentinel: float = 10.0  # conductance of neighbor-less nodes
    seeding_degree_cap: Optional[int] = None  # sample at most this many
                                        # neighbors per node in seeding

    # --- quality mode (models/quality.py, `fit`/`sweep --quality`) ---
    quality_mode: bool = False
    init_noise: Optional[float] = None
    init_noise_mass: float = 4.0
    restart_cycles: int = 40
    restart_tol: float = 1e-4
    restart_patience: int = 3
    seed_exclusion: Optional[bool] = None  # covering seed walk; None = on
                                        # iff quality_mode
    quality_max_p: Optional[float] = None
    quality_conv_tol: float = 1e-6
    quality_repair: bool = True
    repair_rounds: int = 3
    quality_reassign: bool = True

    # --- resilience (models/bigclam.py run_fit_loop rollback) ---
    rollback_budget: int = 3
    rollback_shrink: float = 0.1
    rollback_snapshot_every: int = 8
    step_scale: float = 1.0             # global scale on the Armijo ladder

    # --- sparse membership representation (models/sparse.py) ---
    representation: str = "dense"       # "dense" (N, K) F, or "sparse"
    sparse_m: int = 64                  # member slots per node (clamped to K)
    support_every: int = 1              # iterations between support updates
    sparse_score_block: int = 1 << 22   # support-update block size budget
    sparse_comm_cap: int = 0            # sharded sparse exchange buffer ids
                                        # (0: auto from the touched counts)
    sparse_cap_slack: float = 2.0       # auto cap headroom
    sparse_dense_fallback: float = 0.5  # cap/K at which the step psums

    # --- numerics ---
    dtype: str = "float32"              # F / gradient dtype
    accum_dtype: Optional[str] = None   # LLH accumulation dtype; None = dtype
    seed: int = 0                       # host RNG seed of the {0,1} inits

    # --- execution shape ---
    ring_overlap: bool = True           # (sharded schedules; not in slice)
    donate_state: bool = True           # (JAX buffer donation; no port use)
    edge_chunk: int = 1 << 20           # directed edges per edge-sweep chunk
                                        # of the plain torch paths
    mesh_shape: Tuple[int, int] = (1, 1)
    partition: str = "1d"
    replica_cols: int = 1
    grad_exchange: str = "closure"
    closure_grad_cap: int = 0
    use_pallas: Optional[bool] = None   # candidate edge-terms kernel of
                                        # the non-CSR step: None = auto
                                        # (on for cuda), True = require
                                        # (plain version on cpu), False =
                                        # the plain `xla` path
    use_pallas_csr: Optional[bool] = None  # CSR edge kernels: None = auto
                                        # (on for cuda devices), True =
                                        # require (plain versions on cpu),
                                        # False = the plain `xla` path
    csr_block_b: int = 256              # (TPU tile shape; the CUDA kernels
    csr_tile_t: int = 512               #  read the CSR directly)
    csr_store_pad_tiles: int = 0
    csr_k_block: int = 0
    csr_fused: Optional[bool] = None    # fused superstep kernel: None = on
                                        # whenever the CSR kernels engage;
                                        # False = the split grad/candidate
                                        # kernel pair (path `csr`)
    sparse_pallas_merge: Optional[bool] = None  # member-lookup kernel:
                                        # None = auto (on for cuda), True =
                                        # require (plain version on cpu),
                                        # False = the plain `sparse_xla` path
    pallas_interpret: bool = False      # (Pallas interpret mode; no port use)

    # --- model-health diagnostics (ops/diagnostics.py, obs/health.py) ---
    health_every: int = 0

    # --- checkpointing / logging (utils/checkpoint.py, utils/metrics.py) ---
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    metrics_path: Optional[str] = None

    @property
    def step_candidates(self) -> Tuple[float, ...]:
        """The candidate step sizes {1, beta, ..., beta^max_backtracks},
        descending, scaled by step_scale; the chosen step is the max
        accepted one, so consumers must not rely on the order."""
        steps = [1.0]
        s = 1.0
        for _ in range(self.max_backtracks):
            s *= self.beta
            steps.append(s)
        if self.step_scale != 1.0:
            steps = [self.step_scale * v for v in steps]
        return tuple(steps)

    def replace(self, **kw) -> "BigClamConfig":
        return dataclasses.replace(self, **kw)
