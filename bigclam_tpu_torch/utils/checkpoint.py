"""Checkpoint / resume for long fits and K-sweeps.

Copied from bigclam_tpu/utils/checkpoint.py: archives read across both
packages.

The reference had NO checkpointing (SURVEY.md §5): a crashed run restarted
from scratch, with Spark's lineage-based RDD recomputation as the only
implicit recovery. A long fit on an accelerator has no in-job elasticity, so
the equivalent capability is periodic checkpointing of the full state tuple
(F, sumF, iteration, PRNG seed, K-sweep position) + restart-from-checkpoint.

Format: one .npz per checkpoint (atomic tmp+rename) with a JSON sidecar of
scalar metadata; rotation keeps the newest `keep` checkpoints. No external
dependencies (orbax users can layer it on top; this manager is deliberately
self-contained so restores work anywhere NumPy does).

Integrity: `save` stamps a crc32 PER ARRAY into the
sidecar and `restore` verifies them, so SILENT corruption (a flipped byte
the filesystem never reports) is distinguished from truncation (a lost
writeback) — both fall back to the next-older checkpoint, with the cause
named in the warning. Rotation counts only VALID checkpoints toward
`keep`: when the newest files are corrupt, the newest readable checkpoint
is never deleted out from under the resume path.

Publication: `publish`/`latest`/`load_published` are
the snapshot API a running `cli serve` hot-swaps from. A published
snapshot is the same fsync-rename + per-array-crc32 archive as a
checkpoint under a `snap_` prefix, plus an atomically-replaced
`latest.json` pointer — so fit (the publisher) and serve (the consumer)
agree on ONE publication primitive, and a reader either sees the previous
complete snapshot or the new complete snapshot, never a torn one.
A corrupted newest snapshot falls back to the previous published one at
load, exactly like restore() does for checkpoints. Published snapshots
are never rotated away by the checkpoint rotation (different prefix).

Fleet publication: `publish_fleet_next` publishes ONE
generation as S per-shard `snap_` archives (each under `shard<NNNN>/`,
the same fsync-rename + per-array-crc32 primitive) plus a
`fleet_<step>.json` generation manifest listing every shard's row range,
raw-id range, archive path and crc set. The whole publication — head
selection, every shard archive, the manifest, the latest.json flip —
runs under the SAME publish.lock as single-archive publication, so fleet
and single-process generations share one strictly-monotonic counter and
the never-backward pointer rule, fleet-wide. A serving-fleet reader
(serve.router) resolves the manifest; a shard replica loads only its own
archive — nothing ever materializes the full N-row block on one host.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import zipfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

# np.load on a truncated/corrupted .npz surfaces any of these depending on
# where the truncation landed (zip directory, member header, deflate stream);
# CheckpointCorruption (a ValueError) covers the sidecar-crc mismatches
_CORRUPT_ERRORS = (
    OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile, zlib.error,
)


class CheckpointCorruption(ValueError):
    """A checkpoint's payload failed its per-array crc32 (silent
    corruption — the file reads fine, the bytes are wrong)."""


def _array_crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def published_step_of(path: str) -> int:
    """Generation step of a published snapshot archive path — the ONE
    place that knows the `snap_<step>.npz` naming scheme outside the
    manager's own path builders (callers must never slice filenames)."""
    name = os.path.basename(path)
    if not (name.startswith("snap_") and name.endswith(".npz")):
        raise ValueError(f"{path}: not a published snapshot archive")
    return int(name[5:-4])


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        # step -> ((size, mtime_ns), valid): integrity probes are full-file
        # reads (zip member CRCs), so results are memoized per on-disk
        # identity — rotation then costs stats, not re-reads, per save
        self._valid_cache: Dict[int, Tuple[Tuple[int, int], bool]] = {}
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.npz")

    def _snap_path(self, step: int) -> str:
        return os.path.join(self.directory, f"snap_{step:09d}.npz")

    def _fleet_manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"fleet_{step:09d}.json")

    def _shard_dir(self, shard: int) -> str:
        return os.path.join(self.directory, f"shard{shard:04d}")

    def _write_archive(
        self,
        path: str,
        step: int,
        arrays: Dict[str, np.ndarray],
        meta: Optional[Dict[str, Any]],
    ) -> Dict[str, np.ndarray]:
        """The shared atomic-write primitive (fsync + rename, per-array
        crc32 sidecar) behind both `save` (checkpoints) and `publish`
        (serving snapshots)."""
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                # fsync BEFORE the rename: os.replace is atomic in the
                # namespace but not in the page cache — a preemption between
                # rename and writeback would leave a fully-named, truncated
                # checkpoint, exactly what restore must never see
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        mp = path + ".json"
        sidecar = {
            "step": step,
            "array_crc32": {k: _array_crc32(v) for k, v in arrays.items()},
            **(meta or {}),
        }
        with open(mp + ".tmp", "w") as f:
            json.dump(sidecar, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mp + ".tmp", mp)
        return arrays

    def save(
        self,
        step: int,
        arrays: Dict[str, np.ndarray],
        meta: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Atomically write arrays + metadata for `step`, then rotate. The
        sidecar always carries a crc32 per array (restore verifies)."""
        path = self._path(step)
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._write_archive(path, step, arrays, meta)
        # the file we just wrote and fsynced is valid by construction:
        # seed the probe cache so rotation never re-reads it (any later
        # mutation — including the fault site below — changes its stat
        # key and forces a real probe)
        key = self._stat_key(step)
        if key is not None:
            self._valid_cache[step] = (key, True)
        # fault-injection site (resilience.faults): a truncate/corrupt here
        # models a lost page-cache writeback / silent bit flip AFTER the
        # rename — the failure class restore()'s fallback exists for
        from bigclam_tpu_torch.resilience import faults as _faults

        spec = _faults.maybe_fire("checkpoint.save", step=step, path=path)
        if spec is not None and spec["kind"] in (
            "truncate_checkpoint", "corrupt_checkpoint"
        ):
            _faults.apply_file_fault(spec, path)
        self._rotate()
        return path

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_") and name.endswith(".npz"):
                out.append(int(name[5:-4]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def latest_valid_step(self) -> Optional[int]:
        """The newest step whose archive passes the container integrity
        probe — the step restore() will actually use (modulo meta checks).
        The resume lineage records this, not the newest filename."""
        for s in reversed(self.steps()):
            if self._is_valid(s):
                return s
        return None

    def restore(
        self, step: Optional[int] = None
    ) -> Optional[Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
        """Load (step, arrays, meta); newest VALID checkpoint when step is
        None — a truncated newest file (lost writeback after a preemption)
        or a silently corrupted one (per-array crc mismatch) falls back to
        the next-older checkpoint with a warning naming the cause, instead
        of crashing (or worse, resuming from) the bad state. An explicitly
        requested step propagates its error."""
        if step is not None:
            return self._load(step)
        for s in reversed(self.steps()):
            try:
                return self._load(s)
            except _CORRUPT_ERRORS as e:
                cause = (
                    "silently corrupted"
                    if isinstance(e, CheckpointCorruption)
                    else "unreadable"
                )
                print(
                    f"warning: checkpoint step {s} {cause} "
                    f"({type(e).__name__}: {e}); trying an older one",
                    file=sys.stderr,
                )
        return None

    # ------------------------------------------------ publication (serve)
    def publish(
        self,
        step: int,
        arrays: Dict[str, np.ndarray],
        meta: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Atomically publish a serving snapshot for `step` (see module
        docstring): fsync-rename archive + crc32 sidecar under the
        `snap_` prefix, then an atomic `latest.json` pointer update. The
        pointer flip is the publication instant — a concurrent reader
        resolves either the previous snapshot or this one, complete.

        The pointer NEVER moves backward: when a
        newer generation is already published, the archive is written
        but latest.json is left pointing at the newer step — a slow
        publisher losing a race cannot roll the serving fleet back.
        The check-then-flip runs under the publish lock, so two
        racing publishers cannot interleave between the read and the
        replace."""
        path = self._snap_path(step)
        self._write_archive(path, step, arrays, meta)
        with self._publish_lock():
            self._flip_pointer_locked(step)
        return path

    def _publish_lock(self):
        """Exclusive cross-process publish lock (fcntl on a lock file
        inside the snapshot dir). ONE acquisition per publication —
        fcntl locks are per open-file-description, so nesting two
        acquisitions in one process would self-deadlock; callers that
        already hold it use the *_locked helpers directly."""
        import contextlib
        import fcntl

        lock_path = os.path.join(self.directory, "publish.lock")

        @contextlib.contextmanager
        def held():
            with open(lock_path, "w") as lock:
                fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
                yield

        return held()

    def _flip_pointer_locked(self, step: int) -> None:
        """Atomically point latest.json at `step` unless a NEWER
        readable generation is already published (never backward).
        Caller holds the publish lock."""
        current = self._pointer_step()
        if current is not None and current > step and (
            os.path.exists(self._snap_path(current))
            or os.path.exists(self._fleet_manifest_path(current))
        ):
            # a fleet generation is as real as a single archive: a slow
            # single-process publisher must not roll a fleet back either
            return
        lp = os.path.join(self.directory, "latest.json")
        with open(lp + ".tmp", "w") as f:
            json.dump({"step": step}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(lp + ".tmp", lp)

    def _pointer_step(self) -> Optional[int]:
        """The raw latest.json step (no archive-existence fallback)."""
        try:
            with open(os.path.join(self.directory, "latest.json")) as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def publish_next(
        self,
        arrays: Dict[str, np.ndarray],
        meta: Optional[Dict[str, Any]] = None,
    ) -> Tuple[int, str]:
        """Publish at the NEXT generation: step = newest published + 1,
        chosen and written under an exclusive file lock so concurrent
        publishers (the continuous refit loop racing a manual `cli fit
        --publish-dir`) always take strictly monotonic,
        distinct generations. Returns (step, path)."""
        with self._publish_lock():
            steps = self.published_steps()
            head = max(
                steps[-1] if steps else 0, self._pointer_step() or 0
            )
            step = head + 1
            path = self._snap_path(step)
            self._write_archive(path, step, arrays, meta)
            self._flip_pointer_locked(step)
        return step, path

    def published_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("snap_") and name.endswith(".npz"):
                out.append(int(name[5:-4]))
        return sorted(out)

    # --------------------------------------------- fleet publication
    def fleet_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("fleet_") and name.endswith(".json"):
                try:
                    out.append(int(name[6:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def publish_fleet_next(
        self,
        shard_arrays: list,
        shard_meta: list,
        meta: Optional[Dict[str, Any]] = None,
    ) -> Tuple[int, str]:
        """Publish the NEXT generation as per-shard archives + a fleet
        manifest (see module docstring). `shard_arrays[s]` is shard s's
        array dict (its row range only — never the full block);
        `shard_meta[s]` its sidecar meta (must carry lo/hi and, for
        routing, raw_lo/raw_hi). One lock hold covers head selection,
        every shard write, the manifest, and the pointer flip — exactly
        `publish_next`'s monotonicity contract, fleet-wide. Returns
        (step, manifest_path)."""
        if len(shard_arrays) != len(shard_meta) or not shard_arrays:
            raise ValueError(
                "publish_fleet_next needs one meta per shard array "
                f"(got {len(shard_arrays)} arrays, {len(shard_meta)} meta)"
            )
        with self._publish_lock():
            steps = self.published_steps()
            fleet = self.fleet_steps()
            head = max(
                steps[-1] if steps else 0,
                fleet[-1] if fleet else 0,
                self._pointer_step() or 0,
            )
            step = head + 1
            entries = []
            for s, (arrays, smeta) in enumerate(
                zip(shard_arrays, shard_meta)
            ):
                sub = CheckpointManager(self._shard_dir(s))
                path = sub._snap_path(step)
                written = sub._write_archive(path, step, arrays, smeta)
                entries.append(
                    {
                        "shard": s,
                        "path": os.path.relpath(path, self.directory),
                        "bytes": os.path.getsize(path),
                        "array_crc32": {
                            k: _array_crc32(v) for k, v in written.items()
                        },
                        **{
                            k: smeta[k]
                            for k in (
                                "lo", "hi", "raw_lo", "raw_hi", "n",
                                "representation",
                            )
                            if k in smeta
                        },
                    }
                )
            manifest = {
                "step": step,
                "num_shards": len(entries),
                "shards": entries,
                **(meta or {}),
            }
            mp = self._fleet_manifest_path(step)
            with open(mp + ".tmp", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mp + ".tmp", mp)
            self._flip_pointer_locked(step)
        return step, mp

    def latest_fleet(self) -> Optional[int]:
        """The currently-published FLEET generation: the latest.json
        pointer when it names a readable fleet manifest, else the newest
        manifest on disk. None when no fleet generation exists (the dir
        may still hold single-archive publications)."""
        ptr = self._pointer_step()
        if ptr is not None and os.path.exists(
            self._fleet_manifest_path(ptr)
        ):
            return ptr
        fleet = self.fleet_steps()
        return fleet[-1] if fleet else None

    def load_fleet_manifest(
        self, step: Optional[int] = None
    ) -> Optional[Dict[str, Any]]:
        """Decode a fleet generation manifest (latest when step=None,
        falling back past an unreadable newest one — the manifest twin
        of load_published's corrupt-newest fallback). None when no
        readable fleet manifest exists."""
        if step is not None:
            with open(self._fleet_manifest_path(step)) as f:
                return json.load(f)
        steps = self.fleet_steps()
        head = self.latest_fleet()
        if head in steps:
            steps = [s for s in steps if s <= head]
        for s in reversed(steps):
            try:
                with open(self._fleet_manifest_path(s)) as f:
                    return json.load(f)
            except (OSError, ValueError) as e:
                print(
                    f"warning: fleet manifest step {s} unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous fleet generation",
                    file=sys.stderr,
                )
        return None

    def load_fleet_shard(
        self, manifest: Dict[str, Any], shard: int
    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
        """Load + crc-verify ONE shard's archive of a fleet generation.
        The manifest's own per-array crc set must agree with the shard
        sidecar's (a manifest pointing at a republished/torn archive is
        corruption, not a fallback case — the generation is atomic or it
        is nothing)."""
        entry = manifest["shards"][shard]
        path = os.path.join(self.directory, entry["path"])
        step, arrays, meta = self._load_archive(path, int(manifest["step"]))
        want = entry.get("array_crc32") or {}
        for name, expect in want.items():
            if name not in arrays:
                raise CheckpointCorruption(
                    f"{path}: array {name!r} in the fleet manifest is "
                    "missing from the shard archive"
                )
            if _array_crc32(arrays[name]) != int(expect):
                raise CheckpointCorruption(
                    f"{path}: array {name!r} does not match the fleet "
                    f"manifest crc for generation {manifest['step']} — "
                    "torn or republished shard archive"
                )
        return step, arrays, meta

    def latest(self) -> Optional[int]:
        """The currently-published snapshot step: the `latest.json`
        pointer when it names a readable archive, else the newest
        published snapshot on disk (pointer lost/corrupt — the archive
        set is still authoritative). None when nothing is published."""
        lp = os.path.join(self.directory, "latest.json")
        try:
            with open(lp) as f:
                step = int(json.load(f)["step"])
            if os.path.exists(self._snap_path(step)):
                return step
        except (OSError, ValueError, KeyError, TypeError):
            pass
        steps = self.published_steps()
        return steps[-1] if steps else None

    def load_published(
        self, step: Optional[int] = None
    ) -> Optional[Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
        """Load a published snapshot, crc-verified. With step=None, the
        `latest()` snapshot — falling back past a truncated/corrupted
        newest one to the PREVIOUS published snapshot (the serve-side
        twin of restore()'s fallback). An explicit step propagates its
        error."""
        if step is not None:
            return self._load_archive(self._snap_path(step), step)
        steps = self.published_steps()
        head = self.latest()
        if head in steps:
            # try the pointed-at snapshot first, then strictly older ones
            steps = [s for s in steps if s <= head]
        for s in reversed(steps):
            try:
                return self._load_archive(self._snap_path(s), s)
            except _CORRUPT_ERRORS as e:
                cause = (
                    "silently corrupted"
                    if isinstance(e, CheckpointCorruption)
                    else "unreadable"
                )
                print(
                    f"warning: published snapshot step {s} {cause} "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous published snapshot",
                    file=sys.stderr,
                )
        return None

    def _load(
        self, step: int
    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
        return self._load_archive(self._path(step), step)

    def _load_archive(
        self, path: str, step: int
    ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta: Dict[str, Any] = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        crcs = meta.get("array_crc32")
        if crcs:
            for name, expect in crcs.items():
                if name not in arrays:
                    raise CheckpointCorruption(
                        f"{path}: array {name!r} stamped in the sidecar is "
                        "missing from the payload"
                    )
                got = _array_crc32(arrays[name])
                if got != int(expect):
                    raise CheckpointCorruption(
                        f"{path}: array {name!r} checksum mismatch "
                        f"(expected {expect}, got {got}) — silent "
                        "corruption"
                    )
        return step, arrays, meta

    def _stat_key(self, step: int) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(self._path(step))
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns)

    def _is_valid(self, step: int) -> bool:
        """Integrity probe for rotation: the zip container's own member
        CRCs cover truncation AND byte flips without a numpy parse (npz
        members are stored with per-member crc32s). The full-file read is
        memoized against (size, mtime_ns) — any later mutation of the
        file (truncation, in-place flip) changes the key and re-probes."""
        key = self._stat_key(step)
        if key is None:
            return False
        cached = self._valid_cache.get(step)
        if cached is not None and cached[0] == key:
            return cached[1]
        try:
            with zipfile.ZipFile(self._path(step)) as z:
                ok = z.testzip() is None
        except Exception:
            ok = False
        self._valid_cache[step] = (key, ok)
        return ok

    def _rotate(self) -> None:
        """Delete old checkpoints, keeping the newest `keep` — counting
        only VALID ones: if the newest files are corrupt, the cutoff walks
        back so the newest restorable checkpoint always survives. Corrupt
        files newer than the cutoff are left in place as evidence (restore
        skips past them)."""
        if self.keep <= 0:
            return
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        valid = 0
        cutoff = None
        for s in reversed(steps):
            if self._is_valid(s):
                valid += 1
                if valid == self.keep:
                    cutoff = s
                    break
        if cutoff is None:
            return      # fewer than `keep` valid checkpoints: delete nothing
        for s in steps:
            if s >= cutoff:
                continue
            p = self._path(s)
            os.unlink(p)
            self._valid_cache.pop(s, None)
            if os.path.exists(p + ".json"):
                os.unlink(p + ".json")
