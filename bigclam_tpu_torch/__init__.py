"""PyTorch/CUDA port of tpu-bigclam for NVIDIA Hopper (H100).

The JAX package `bigclam_tpu` stays the reference; this package imports
`torch` and `numpy` only, never `jax` and nothing of `bigclam_tpu`, and
keeps its own copy of what it needs. Ported so far: the single-device
`fit` — graph ingest, conductance seeding, the train loop on the CSR edge
kernels (CUDA C++ for sm_90a, csrc/) at any K, on the non-CSR step with
the candidate edge-terms kernel, or on the sparse top-M member lists
with the member-lookup kernel, extraction — the K sweep and scoring, and
the CLI (`python -m bigclam_tpu_torch.cli fit|sweep|eval`).
"""

from bigclam_tpu_torch.config import BigClamConfig

__all__ = ["BigClamConfig"]
