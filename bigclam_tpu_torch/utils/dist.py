"""Single-writer gating for multi-process runs.

Port of bigclam_tpu/utils/dist.py. Under a torch.distributed process group
every rank runs the same program, so any host-side file write
(checkpoints, sweep journals, metrics JSONL, communities) would be raced
by N processes renaming onto the same shared-directory paths. Rank 0 is
the sole writer; every rank still READS checkpoints on resume, which
assumes the checkpoint directory is on a filesystem all hosts share.

The JAX module's `request_cpu_devices` has no counterpart: the port's CPU
mesh repeats the `cpu` device (parallel/mesh.py) instead of provisioning
virtual devices.
"""

from __future__ import annotations

import sys


def _group_joined() -> bool:
    """Is a process group joined? Never imports torch: a process that has
    not loaded torch.distributed has joined no group."""
    dist = sys.modules.get("torch.distributed")
    return dist is not None and dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the joined group; 0 before or without one."""
    if not _group_joined():
        return 0
    return sys.modules["torch.distributed"].get_rank()


def process_count() -> int:
    """The number of ranks in the joined group; 1 before or without one."""
    if not _group_joined():
        return 1
    return sys.modules["torch.distributed"].get_world_size()


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes (rank 0).

    Trivially True single-process; safe to call before the group is joined
    (the index is 0 then)."""
    return process_index() == 0
