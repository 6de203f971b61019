"""Memory-bounded streaming parse of SNAP edge lists.

Copied from bigclam_tpu/graph/stream.py. The file is scanned in fixed-size
byte-range chunks whose boundaries are snapped to newlines, so peak RSS is
O(chunk_bytes) (times a small tokenizer constant), not O(file): each chunk
is parsed independently (``#``-comment aware) and either yielded to a
consumer (the graph store's out-of-core compile, graph/store.py) or
concatenated for an in-memory build.

Chunks are independent, so the scan parallelizes across a spawn-based
process pool (`workers > 1`); results are yielded IN FILE ORDER with at most
`workers` chunks in flight, keeping the parent's memory bound intact. The
pool uses the spawn context: the parent typically has torch (and its thread
pools) loaded, and forking a threaded process is undefined behavior. A
spawned worker unpickles `parse_span` by its qualified name, so it imports
this module and what it imports (numpy), never the JAX package.
"""

from __future__ import annotations

import collections
import os
from typing import Iterator, List, Tuple

import numpy as np

DEFAULT_CHUNK_BYTES = 64 << 20
# bound on how far a chunk boundary scans forward for its newline; SNAP
# edge-list lines are two integers, so 1 MiB is beyond generous
_MAX_LINE_BYTES = 1 << 20


def byte_ranges(path: str, chunk_bytes: int) -> List[Tuple[int, int]]:
    """Partition the file into ~chunk_bytes [start, end) spans snapped to
    newlines: every boundary except 0/EOF sits just after a ``\\n``, so no
    span starts or ends mid-line (and therefore never mid-token)."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    size = os.path.getsize(path)
    if size == 0:
        return []
    cuts = [0]
    with open(path, "rb") as f:
        target = chunk_bytes
        while target < size:
            f.seek(target)
            buf = f.read(_MAX_LINE_BYTES)
            nl = buf.find(b"\n")
            if nl < 0:
                if len(buf) == _MAX_LINE_BYTES:
                    # a >1 MiB line is not a SNAP edge list; falling back
                    # to one giant span would silently void the O(chunk)
                    # RSS contract, so refuse instead
                    raise ValueError(
                        f"{path}: no newline within {_MAX_LINE_BYTES} "
                        f"bytes of offset {target} — not a SNAP edge list?"
                    )
                break                       # short read: inside the final
                                            # (unterminated) line, bounded
            cut = target + nl + 1
            if cut >= size:
                break
            cuts.append(cut)
            target = cut + chunk_bytes
    cuts.append(size)
    return list(zip(cuts[:-1], cuts[1:]))


def parse_bytes(data: bytes, where: str = "") -> np.ndarray:
    """Parse whole lines of a SNAP edge list into an (M, 2) int64 array
    (``#``-prefixed comment lines and blank lines dropped)."""
    lines = data.split(b"\n")
    body = b" ".join(
        ln for ln in lines if ln.strip() and not ln.lstrip().startswith(b"#")
    )
    if not body:
        return np.empty((0, 2), dtype=np.int64)
    flat = np.array(body.split(), dtype=np.int64)
    if flat.size % 2 != 0:
        raise ValueError(
            f"{where or 'edge list'}: expected an even number of integers, "
            f"got {flat.size}"
        )
    return flat.reshape(-1, 2)


def parse_span(path: str, start: int, end: int) -> np.ndarray:
    """Parse one newline-snapped byte range of the file (the process-pool
    work unit: workers re-open the file and read only their span)."""
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    return parse_bytes(data, where=f"{path}[{start}:{end}]")


def stream_edge_list(
    path: str,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    workers: int = 0,
) -> Iterator[np.ndarray]:
    """Yield (m, 2) int64 raw-id pair arrays chunk by chunk, in file order.

    workers <= 1 parses in-process; workers > 1 fans the chunks across a
    spawn process pool with a bounded in-flight window (ordered yields, at
    most `workers` parsed chunks resident at once).
    """
    spans = byte_ranges(path, chunk_bytes)
    if workers <= 1 or len(spans) <= 1:
        for start, end in spans:
            yield parse_span(path, start, end)
        return

    import collections
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        pending: collections.deque = collections.deque()
        it = iter(spans)
        for start, end in it:
            pending.append(ex.submit(parse_span, path, start, end))
            if len(pending) >= workers:
                break
        for start, end in it:
            yield pending.popleft().result()
            pending.append(ex.submit(parse_span, path, start, end))
        while pending:
            yield pending.popleft().result()


def scan_edge_files(directory: str, seen=()) -> List[str]:
    """Unprocessed edge files of a delta directory, in NAME order (the
    continuous fit->publish->serve loop's watch primitive):
    plain files not in `seen` (absolute paths), skipping dotfiles and
    in-flight temporaries (`.tmp`/`.part` suffixes — publish deltas by
    writing to a temp name and renaming, the same atomicity discipline
    as the snapshot publisher). Name order IS the application order, so
    producers should use sortable names (delta_000001.txt ...)."""
    seen = set(seen)
    out: List[str] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if name.startswith(".") or name.endswith((".tmp", ".part")):
            continue
        path = os.path.abspath(os.path.join(directory, name))
        if path in seen or not os.path.isfile(path):
            continue
        out.append(path)
    return out


class BoundedBlobCache:
    """np.load results keyed by path with at most `capacity` blobs resident
    (LRU). The ingest-time seed bake (graph/store.bake_seed_scores) sweeps
    shard PAIRS — each shard's blobs are re-read O(num_shards) times — and
    this keeps the sweep's residency at O(capacity * shard bytes) while the
    hot outer-loop shard never re-reads. Same O(shard)-not-O(E) contract as
    the chunked parse above, applied to the binary blobs."""

    def __init__(self, capacity: int = 4):
        assert capacity >= 1
        self.capacity = capacity
        self._cache: "collections.OrderedDict[str, np.ndarray]" = (
            collections.OrderedDict()
        )

    def get(self, path: str) -> np.ndarray:
        hit = self._cache.get(path)
        if hit is not None:
            self._cache.move_to_end(path)
            return hit
        arr = np.load(path)
        self._cache[path] = arr
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return arr


def load_edge_list_streaming(
    path: str,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    workers: int = 0,
) -> np.ndarray:
    """In-memory (M, 2) pairs via the streaming scanner: O(chunk) transient
    parse state instead of the seed's whole-file token blowup (the pairs
    array itself is still O(E) — out-of-core callers use the graph store)."""
    parts = [
        p for p in stream_edge_list(path, chunk_bytes, workers) if p.size
    ]
    if not parts:
        return np.empty((0, 2), dtype=np.int64)
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts, axis=0)
