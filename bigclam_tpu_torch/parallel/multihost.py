"""Multi-process runtime: the torch.distributed process group, meshes that
span its ranks, process-local placement and global reads.

Port of bigclam_tpu/parallel/multihost.py. Every rank runs the same
program; `initialize_distributed` joins the process group and
`make_multihost_mesh` lays the (nodes, k) grid over the ranks slice-major:
with `world` ranks, rank r owns positions [r*P/world, (r+1)*P/world) of the
P = dp*tp positions in row-major order, so consecutive node shards stay in
one rank and ranks are host-major (the GPU's NVLink domain in the place of
the TPU's ICI slice). A rank builds, holds and steps only its own
positions, on one card (`cuda:LOCAL_RANK`) or the CPU.

The trainers' collectives (parallel/sharded.py `psum`, `all_gather`,
`column_psum`, `kpsum`; parallel/ring.py `RingRotation`) keep their call
sites; an axis whose members span ranks carries its process group
(parallel/mesh.py `Axis`), and then:

* an all-gather of row shards is a `dist.all_gather` of equal shards;
* a psum all-gathers every position's partial and sums them in shard
  order, so every rank holds the single controller's bits;
* a ring hop across a rank boundary is a `dist.batch_isend_irecv` pair.

The backend follows the mesh device, `nccl` for cuda and `gloo` for the
CPU; BIGCLAM_DIST_BACKEND=gloo selects gloo for cuda too, and the helpers
then stage cuda tensors through host memory (gloo's all-gather and
send/recv take CPU tensors). Under gloo the ranks of a host share its
cards round-robin; NCCL wants one card a rank and refuses fewer by name.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigclam_tpu_torch.parallel.mesh import Mesh, make_mesh, state_blocks
from bigclam_tpu_torch.utils.dist import process_count, process_index

# coordinator env vars: torchrun's first, then the JAX package's names, so
# one launch script drives both packages
_COORD_ENVS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
BACKEND_ENV = "BIGCLAM_DIST_BACKEND"

# bytes this process sent to and received from other ranks through the
# helpers below (a finding, read by chip_smoke; reset_cross_rank_bytes)
_CROSS = {"sent": 0, "received": 0, "calls": 0}


def reset_cross_rank_bytes() -> None:
    for k in _CROSS:
        _CROSS[k] = 0


def cross_rank_bytes() -> dict:
    """{"sent", "received", "calls"} since the last reset."""
    return dict(_CROSS)


def _count(nbytes: int, world: int) -> None:
    """One all-gather of nbytes a rank over `world` ranks: each rank sends
    its piece to, and receives one from, every other."""
    _CROSS["sent"] += nbytes * (world - 1)
    _CROSS["received"] += nbytes * (world - 1)
    _CROSS["calls"] += 1


def _dist():
    import torch.distributed as dist

    return dist


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val else None


def _resolve_launch(coordinator_address, num_processes, process_id):
    """(address 'host:port', world size, rank) from the arguments, then the
    torchrun variables, then the JAX names; address None: no coordinator."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        num_processes = num_processes or _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    if coordinator_address is None:
        for k in _COORD_ENVS:
            if os.environ.get(k):
                coordinator_address = os.environ[k]
                break
    if coordinator_address is None:
        return None, None, None
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or _env_int("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK")
        if process_id is None:
            process_id = _env_int("JAX_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} named but the world size or "
            "rank is not (set WORLD_SIZE and RANK, or JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID, on every process)"
        )
    return coordinator_address, int(num_processes), int(process_id)


def backend_for(device) -> str:
    """The process group's backend for a mesh on `device`: nccl for cuda,
    gloo for the CPU, and gloo wherever BIGCLAM_DIST_BACKEND=gloo."""
    want = os.environ.get(BACKEND_ENV, "")
    if want not in ("", "gloo", "nccl"):
        raise ValueError(f"{BACKEND_ENV}={want!r}: use gloo or nccl")
    if torch.device(device).type == "cpu":
        if want == "nccl":
            raise ValueError(f"{BACKEND_ENV}=nccl needs a cuda device")
        return "gloo"
    return want or "nccl"


def rank_device(device=None, local_rank: Optional[int] = None) -> torch.device:
    """The device this rank runs on: the CPU for `device` cpu, else
    `cuda:LOCAL_RANK` (nccl: one card a rank, fewer cards refused by
    name; gloo: the host's cards shared round-robin). Raises
    DeviceUnavailableError where no card is present."""
    from bigclam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK") or 0
    cards = torch.cuda.device_count()
    if local_rank >= cards:
        if backend_for(dev) == "nccl":
            raise ValueError(
                f"nccl wants one card a rank: local rank {local_rank} on a "
                f"host with {cards} card(s); launch at most {cards} ranks a "
                f"host, or set {BACKEND_ENV}=gloo to share the cards"
            )
        local_rank %= cards
    return torch.device("cuda", local_rank)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device=None,
) -> bool:
    """Join the torch.distributed process group; returns True if joined.

    Resolution order: explicit arguments > the torchrun variables
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) > the JAX
    names (JAX_COORDINATOR_ADDRESS or COORDINATOR_ADDRESS as host:port,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) > no-op. `device` (cuda by
    default, or cpu) picks the backend (backend_for) and this rank's card
    (rank_device; local_device_ids[0] in the place of LOCAL_RANK).
    Idempotent. Commits the telemetry's single-writer gate on every exit
    and emits `distributed_init` once joined, as the JAX function does. A
    failed initialisation raises: it never switches backend."""
    dist = _dist()

    def _commit_telemetry_gate():
        # the single-writer event-log gate was deferred until membership is
        # known (RunTelemetry(auto_gate=False)); it is decidable on every
        # exit, the single-process fallback included, where leaving it
        # deferred would buffer the whole run's events in memory
        from bigclam_tpu_torch.obs import telemetry as _obs

        t = _obs.current()
        if t is not None:
            t.commit_gate()

    if dist.is_initialized():
        _commit_telemetry_gate()
        return True
    addr, world, rank = _resolve_launch(coordinator_address, num_processes,
                                        process_id)
    if addr is None:
        _commit_telemetry_gate()
        return False
    local = local_device_ids[0] if local_device_ids else None
    dev = rank_device(device, local)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is not None:
        # membership is now known: commit the single-writer gate (events
        # buffered since RunTelemetry construction flush here) and record
        # the join
        tel.commit_gate()
        tel.event("distributed_init", processes=world, coordinator=addr,
                  backend=backend)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group if one is joined (the CLI's exit)."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()


def slice_groups(hosts: Optional[Sequence[str]] = None) -> Dict[int, List[int]]:
    """Ranks grouped by host, groups in order of first appearance: the
    GPU's NVLink domain, in the place of the TPU's ICI slice. `hosts` is
    each rank's host name (default: gathered from the joined group, or
    this host alone)."""
    if hosts is None:
        me = socket.gethostname()
        if process_count() > 1:
            hosts = [None] * process_count()
            _dist().all_gather_object(hosts, me)
        else:
            hosts = [me]
    order: Dict[str, int] = {}
    groups: Dict[int, List[int]] = {}
    for rank, h in enumerate(hosts):
        groups.setdefault(order.setdefault(h, len(order)), []).append(rank)
    return groups


def _owner_plan(dp: int, tp: int, world: int) -> int:
    """Positions a rank owns; raises where the ranks do not tile the grid
    in whole rows or equal parts of one row."""
    size = dp * tp
    if size % world:
        raise ValueError(
            f"mesh shape {(dp, tp)} has {size} positions, not a multiple of "
            f"the {world} processes"
        )
    per = size // world
    if per % tp and tp % per:
        raise ValueError(
            f"mesh shape {(dp, tp)} over {world} processes gives each "
            f"{per} positions, neither whole rows of {tp} nor an equal part "
            "of one row"
        )
    return per


def owner(i: int, j: int, tp: int, per: int) -> int:
    """The rank owning position (i, j) of a grid of tp columns, `per`
    positions a rank."""
    return (i * tp + j) // per


def make_multihost_mesh(
    shape: Optional[Tuple[int, int]] = None,
    device=None,
    hosts: Optional[Sequence[str]] = None,
) -> Mesh:
    """Build the (nodes, k) mesh across every rank of the joined group.

    shape = (node_shards, k_shards); default (world x local cards, 1): one
    card a rank under a group, every card of the host single-process.
    Without a group this is parallel/mesh.make_mesh over the local
    device(s). Under a group the nodes axis is host-major (slice_groups):
    rank r owns positions [r*P/world, (r+1)*P/world) row-major, all on its
    one device (rank_device), and the mesh carries the process groups of
    the axes whose members span ranks. Raises JAX's errors for a bad shape
    and for node_shards not a multiple of the host count."""
    dev = rank_device(device)
    dist = _dist()
    if not dist.is_initialized():
        cards = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                 if dev.type == "cuda" else [dev])
        if shape is None:
            shape = (len(cards), 1)
        dp, tp = shape
        return make_mesh(shape, [cards[i % len(cards)] for i in range(dp * tp)])
    world, rank = process_count(), process_index()
    if shape is None:
        shape = (world, 1)
    dp, tp = (int(x) for x in shape)
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh shape {tuple(shape)} needs positive axes")
    per = _owner_plan(dp, tp, world)
    groups = slice_groups(hosts)
    n_hosts = len(groups)
    if n_hosts > 1:
        if dp % n_hosts != 0:
            raise ValueError(
                f"node_shards={dp} must be a multiple of the {n_hosts} slices"
            )
        if [r for g in groups.values() for r in g] != list(range(world)):
            raise ValueError(
                "ranks are not host-major (each host's ranks must be "
                "consecutive, as torchrun numbers them)"
            )
    everyone = list(range(world))

    def make_group(ranks: List[int], whole: bool):
        # every rank runs this for every axis in one global order, as
        # new_group requires
        if ranks == everyone:
            return dist.group.WORLD if (whole or world > 1) else None
        if len(ranks) == 1:
            return None
        return dist.new_group(ranks)

    col = [make_group(sorted({owner(i, j, tp, per) for i in range(dp)}), True)
           for j in range(tp)]
    row = [make_group(sorted({owner(i, j, tp, per) for j in range(tp)}), False)
           for i in range(dp)]
    p0 = rank * per
    i0, j0 = divmod(p0, tp)
    n_rows = max(per // tp, 1)
    n_cols = tp if per >= tp else per
    return Mesh(
        devices=tuple(tuple(dev for _ in range(n_cols)) for _ in range(n_rows)),
        dims=(dp, tp),
        origin=(i0, j0),
        col_groups=tuple(col[j0 : j0 + n_cols]),
        row_groups=tuple(row[i0 : i0 + n_rows]),
    )


def ring_peers(mesh) -> Optional[Tuple[int, int]]:
    """(predecessor, successor) ranks of this process on its columns'
    ring, or None where the whole ring is local (a single-controller mesh,
    or every node row in this rank)."""
    if not getattr(mesh, "distributed", False):
        return None
    dp, tp = mesh.shape["nodes"], mesh.shape["k"]
    rows = mesh.local_rows()
    if len(rows) == dp:
        return None
    per = dp * tp // process_count()
    j0 = mesh.origin[1]
    return (owner((rows.start - 1) % dp, j0, tp, per),
            owner(rows.stop % dp, j0, tp, per))


def addressable_row_bounds(mesh: Mesh, n_rows: int) -> Tuple[int, int]:
    """[lo, hi) of the rows of an n_rows-row array split over the mesh's
    node shards that this process's positions hold."""
    dp = mesh.shape["nodes"]
    if n_rows % dp:
        raise ValueError(f"{n_rows} rows do not split over {dp} node shards")
    rows = n_rows // dp
    local = mesh.local_rows()
    return local.start * rows, local.stop * rows


def place_rows(rows: np.ndarray, grid, tp: int, col0: int = 0,
               dtype=None) -> list:
    """The blocks [il][jl] of a local grid (rows of devices, the first at
    global column col0 of tp) cut from the host rows those positions hold,
    each on its device (columns cut into the tp blocks when the array is
    2-D)."""
    n_loc = rows.shape[0] // len(grid)
    t = torch.from_numpy(np.ascontiguousarray(rows))
    if dtype is not None:
        t = t.to(dtype)
    out = []
    for il, row in enumerate(grid):
        r = t[il * n_loc : (il + 1) * n_loc]
        if r.dim() < 2:
            out.append([r.to(d, copy=True) for d in row])
            continue
        cols = r.shape[1] // tp
        out.append([r[:, (col0 + jl) * cols : (col0 + jl + 1) * cols]
                    .to(d, copy=True).contiguous() for jl, d in enumerate(row)])
    return out


def put_process_local(host_array: np.ndarray, mesh: Mesh, grid=None,
                      dtype=None) -> list:
    """Place a row-sharded array giving this process only its rows: the
    blocks [il][jl] of its positions, cut from a host-global array."""
    lo, hi = addressable_row_bounds(mesh, host_array.shape[0])
    grid = mesh.grid() if grid is None else grid
    return place_rows(host_array[lo:hi], grid, mesh.shape["k"], mesh.origin[1],
                      dtype)


def put_host_local(local_rows: np.ndarray, mesh: Mesh, global_shape,
                   grid=None, dtype=None) -> list:
    """Place a row-sharded global array from ONLY this process's rows (the
    global array never exists anywhere). Raises when the row count
    disagrees with the mesh's bounds rather than mis-placing."""
    global_shape = tuple(global_shape)
    lo, hi = addressable_row_bounds(mesh, global_shape[0])
    local_rows = np.ascontiguousarray(local_rows)
    if local_rows.shape != (hi - lo,) + global_shape[1:]:
        raise ValueError(
            f"local rows shape {local_rows.shape} != addressable block "
            f"{(hi - lo,) + global_shape[1:]} of global {global_shape}"
        )
    grid = mesh.grid() if grid is None else grid
    return place_rows(local_rows, grid, mesh.shape["k"], mesh.origin[1], dtype)


def put_sharded(host_array: np.ndarray, mesh: Mesh, grid=None, dtype=None) -> list:
    """The blocks of a host array this process holds: all of them on a
    single-controller mesh, only this rank's rows under a group."""
    return put_process_local(np.asarray(host_array), mesh, grid, dtype)


def host_shard_ids(
    num_shards: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> range:
    """Store-shard indices this process owns under the slice-major
    contiguous layout (rank r of R owns shards [r*S/R, (r+1)*S/R))."""
    from bigclam_tpu_torch.utils import dist as _d

    pid = _d.process_index() if process_index is None else process_index
    pc = _d.process_count() if process_count is None else process_count
    if pc <= 0 or num_shards % pc != 0:
        raise ValueError(
            f"num_shards={num_shards} not divisible by "
            f"process_count={pc}; compile the cache with one shard per "
            "node-shard of the mesh"
        )
    per = num_shards // pc
    return range(pid * per, (pid + 1) * per)


def load_shard_ids(store, ids: range, verify: bool = True):
    """Shards [ids.start, ids.stop) of a graph cache as one HostShard,
    reading ONLY their files, under the transient-retry policy (site
    `store.load_host_shard`)."""
    from bigclam_tpu_torch.resilience.retry import call_with_retry

    return call_with_retry(
        lambda: store.load_shard_range(ids.start, ids.stop, verify=verify),
        site="store.load_host_shard",
    )


def load_host_shard(
    store,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    verify: bool = True,
):
    """This process's node-contiguous slice of a graph cache
    (graph/store.GraphStore): reads ONLY the shard files of the ranges
    this rank owns, so no rank materializes the global CSR on the
    store-backed path. The read runs under the resilience retry policy;
    checksum failures are not retried here (the store self-heals inside
    the attempt when opened so)."""
    ids = host_shard_ids(store.num_shards, process_index, process_count)
    return load_shard_ids(store, ids, verify)


def _buffer_device(group=None) -> torch.device:
    """Where a collective of host data stages its buffers: this rank's card
    under nccl (it takes cuda tensors only), the host under gloo."""
    if _dist().get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_max_int(value: int) -> int:
    """Cross-process max of one host-side integer (one int64 a rank).
    Single-process: the identity, no collective."""
    if process_count() == 1:
        return int(value)
    dev = _buffer_device()
    parts = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(process_count())]
    _dist().all_gather(parts, torch.tensor([int(value)], dtype=torch.int64,
                                           device=dev))
    return int(max(int(p) for p in parts))


def load_host_seed_scores(
    store,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    verify: bool = True,
):
    """This process's slice of the ingest-baked seed scores
    (GraphStore.load_seed_scores): reads ONLY the phi blobs of the shards
    this rank owns, under the same transient-retry policy."""
    from bigclam_tpu_torch.resilience.retry import call_with_retry

    ids = host_shard_ids(store.num_shards, process_index, process_count)
    return call_with_retry(
        lambda: store.load_seed_scores(ids.start, ids.stop, verify=verify),
        site="store.load_host_seed_scores",
    )


# ------------------------------------------------------------ collectives


def _staged(t: torch.Tensor, group) -> bool:
    """Does this group's backend take `t` only through host memory?"""
    return t.is_cuda and _dist().get_backend(group) == "gloo"


def exchange(parts: list, group) -> list:
    """Every member's parts of one collective, in member order: each rank
    of `group` gives its local parts (equal count and shape on every
    rank), and gets back all of them as tensors on its first part's
    device. A `dist.all_gather` of equal shards."""
    dist = _dist()
    world = dist.get_world_size(group)
    local = torch.stack([p.to(parts[0].device) for p in parts])
    stage = _staged(local, group)
    src = local.cpu() if stage else local.contiguous()
    out = src.new_empty((world,) + tuple(src.shape))
    dist.all_gather(list(out.unbind(0)), src, group=group)
    _count(src.numel() * src.element_size(), world)
    if stage:
        out = out.to(parts[0].device)
    return list(out.reshape((-1,) + tuple(src.shape[1:])).unbind(0))


def hop(send: list, recv_like: list, peers: Tuple[int, int], group) -> list:
    """One ring hop across a rank boundary: `send` goes to the predecessor
    rank, and the successor's matching tensors come back (shaped like
    `recv_like`, on their devices), by one dist.batch_isend_irecv."""
    dist = _dist()
    pred, succ = peers
    stage = _staged(send[0], group)
    src = [t.cpu() if stage else t.contiguous() for t in send]
    bufs = [torch.empty(t.shape, dtype=t.dtype,
                        device="cpu" if stage else t.device) for t in recv_like]
    ops = [dist.P2POp(dist.isend, t, pred, group) for t in src]
    ops += [dist.P2POp(dist.irecv, b, succ, group) for b in bufs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    n = sum(t.numel() * t.element_size() for t in src)
    _CROSS["sent"] += n
    _CROSS["received"] += sum(b.numel() * b.element_size() for b in bufs)
    _CROSS["calls"] += 1
    return [b.to(r.device) if stage else b for b, r in zip(bufs, recv_like)]


def fetch_rows(x, mesh: Optional[Mesh] = None) -> list:
    """Each global node row of a mesh state tensor (the layouts of
    parallel/mesh.py `row_shards`) as a host array, its column blocks
    joined: on a multi-process mesh every rank gets every row (an
    all-gather of the ranks' blocks), else this process's rows."""
    from bigclam_tpu_torch.parallel.mesh import row_shards

    if not getattr(mesh, "distributed", False):
        return [r.cpu().numpy() for r in row_shards(x)]
    dist = _dist()
    dp, tp = mesh.shape["nodes"], mesh.shape["k"]
    blocks = state_blocks(x)
    dev = _buffer_device()
    local = torch.stack([b.to(dev) for b in blocks])
    world = dist.get_world_size()
    out = local.new_empty((world,) + tuple(local.shape))
    dist.all_gather(list(out.unbind(0)), local)
    _count(local.numel() * local.element_size(), world)
    flat = out.reshape((-1,) + tuple(local.shape[1:])).cpu().numpy()
    return [np.concatenate(list(flat[i * tp : (i + 1) * tp]), axis=-1)
            for i in range(dp)]


def fetch_global(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """np.asarray of a mesh state tensor that works across processes: the
    node rows concatenated, every rank getting the whole array (fine for
    results and checkpoints, which are O(N*K) host RAM by construction).
    A tensor alone, or a single-controller mesh, reads locally."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.concatenate(fetch_rows(x, mesh))
