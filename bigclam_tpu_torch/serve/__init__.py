"""Membership serving: batched fold-in inference, snapshot hot-swap, and
the query surface behind `cli serve`.

Port of bigclam_tpu/serve with the JAX package's LAZY attribute
re-exports (PEP 562): the package init does not decide for its submodules
what gets imported. The sharded fleet is serve.fleet (a shard's replica),
serve.router (the query router) and serve.supervise (the replicas'
process parent).
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
    # the sharded fleet: replicas, their router, and its transport
    "ShardReplica": ("bigclam_tpu_torch.serve.fleet", "ShardReplica"),
    "ReplicaServer": ("bigclam_tpu_torch.serve.fleet", "ReplicaServer"),
    "LocalReplica": ("bigclam_tpu_torch.serve.fleet", "LocalReplica"),
    "FleetRouter": ("bigclam_tpu_torch.serve.router", "FleetRouter"),
    "TcpReplica": ("bigclam_tpu_torch.serve.router", "TcpReplica"),
    "RouterError": ("bigclam_tpu_torch.serve.router", "RouterError"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
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
