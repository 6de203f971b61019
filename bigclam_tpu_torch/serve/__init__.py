"""Membership serving: batched fold-in inference, snapshot hot-swap, and
the query surface behind `cli serve`.

Port of bigclam_tpu/serve with the JAX package's LAZY attribute
re-exports (PEP 562): the package init does not decide for its submodules
what gets imported. The sharded fleet (serve.fleet, serve.router) is not
ported: its names raise FleetNotPortedError.
"""

_LAZY = {
    "FOLDIN_CFG_FIELDS": (
        "bigclam_tpu_torch.serve.snapshot", "FOLDIN_CFG_FIELDS",
    ),
    "ServingSnapshot": ("bigclam_tpu_torch.serve.snapshot", "ServingSnapshot"),
    "SnapshotError": ("bigclam_tpu_torch.serve.snapshot", "SnapshotError"),
    "pad_neighbor_batch": (
        "bigclam_tpu_torch.serve.snapshot", "pad_neighbor_batch",
    ),
    "publish_snapshot": (
        "bigclam_tpu_torch.serve.snapshot", "publish_snapshot",
    ),
    "publish_fleet_snapshot": (
        "bigclam_tpu_torch.serve.snapshot", "publish_fleet_snapshot",
    ),
    "load_fleet_shard": (
        "bigclam_tpu_torch.serve.snapshot", "load_fleet_shard",
    ),
    "Future": ("bigclam_tpu_torch.serve.batcher", "Future"),
    "OverloadedError": ("bigclam_tpu_torch.serve.batcher", "OverloadedError"),
    "RequestBatcher": ("bigclam_tpu_torch.serve.batcher", "RequestBatcher"),
    "FAMILIES": ("bigclam_tpu_torch.serve.server", "FAMILIES"),
    "FoldInEngine": ("bigclam_tpu_torch.serve.server", "FoldInEngine"),
    "HotCommunityCache": (
        "bigclam_tpu_torch.serve.server", "HotCommunityCache",
    ),
    "MembershipServer": (
        "bigclam_tpu_torch.serve.server", "MembershipServer",
    ),
}

# the JAX package's fleet names (serve.fleet, serve.router)
FLEET_NAMES = (
    "ShardReplica", "ReplicaServer", "LocalReplica", "FleetRouter",
    "TcpReplica", "RouterError",
)


class FleetNotPortedError(NotImplementedError):
    """A name of the sharded serving fleet, which the port lacks."""


__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in FLEET_NAMES:
        raise FleetNotPortedError(
            f"{name}: not ported yet: ROADMAP item 18 (the serving fleet's "
            "router and replicas; the JAX package's jax-free fleet serves "
            "the port's `fit --publish-shards` archives)"
        )
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
