"""Checkpoint engines (port of ``deepspeed_tpu/checkpoint/engine.py``;
reference ``runtime/checkpoint_engine/checkpoint_engine.py:9``).

Crash consistency is the JAX package's: every committed checkpoint carries
an integrity manifest (``ds_manifest.json``: each entry's byte size and
CRC32) and a commit marker (``ds_commit``) written LAST. A directory without
the marker is a torn write; one whose entries disagree with the manifest is
corrupt. ``verify_checkpoint`` checks both, ``find_latest_valid_checkpoint``
scans a save dir newest first (numeric step order) and quarantines the
provably bad tags, ``prune_checkpoints`` keeps the ``keep_last_n`` newest
committed tags; every storage mutation is bounded by retry with backoff.

Where JAX writes through orbax (logical arrays, each host its shards), the
port writes PyTorch tensors with the same contract:

- each rank writes its own state (``state_rank<r>.pt``, ``torch.save`` of
  CPU tensors; each tensor of 64 MiB or more in a file of its own,
  ``state_rank<r>.<i>.pt``, so the files are written, summed and read
  side by side) and, beside it, that state's layout in JSON
  (``layout_rank<r>.json``: for each flat buffer, which element ranges of
  which named parameter it holds);
- one rank (rank 0) writes the host state (``ds_host_state.pkl``: step
  counters, the LR schedule, client state), under a temporary name
  renamed into place before the manifest is sealed, so no two processes
  ever open the final name for writing (the JAX engine's ``"wb"`` race);
- ``commit`` waits for every rank's files (the caller's ``barrier``), and
  rank 0 seals: the manifest, then the marker;
- ``ShardedReader`` reads a checkpoint written by any world at any stage:
  a parameter's range is assembled from the pieces that cover it, each
  rank's file opened memory-mapped, so a load reads only the ranges it
  needs (orbax's logical arrays, restored into another topology).
"""

import json
import logging
import os
import pickle
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.fault_injection import corrupt_file_in, get_fault_injector, tear_checkpoint_dir
from ..utils.retry import retry_with_backoff

logger = logging.getLogger(__name__)

MANIFEST_FILE = "ds_manifest.json"
COMMIT_MARKER_FILE = "ds_commit"
QUARANTINE_SUFFIX = ".quarantined"
MANIFEST_VERSION = 1
HOST_STATE_FILE = "ds_host_state.pkl"
STATE_FILE = "state_rank{rank}.pt"
PART_FILE = "state_rank{rank}.{part}.pt"  # a tensor of SPLIT_BYTES or more, in its own file
LAYOUT_FILE = "layout_rank{rank}.json"
SPLIT_BYTES = 1 << 26
_PART = "__part__"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed manifest verification (torn or corrupt)."""


# ---------------------------------------------------------------------------
# integrity manifest
# ---------------------------------------------------------------------------


def _crc32_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc
            crc = zlib.crc32(b, crc)


def _crc32_files(paths: List[str]) -> List[int]:
    """Each file's CRC32, the files in threads: ``zlib.crc32`` releases the
    interpreter lock over a large buffer, so a rank's buffer files are
    summed side by side."""
    if len(paths) <= 1:
        return [_crc32_file(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        return list(pool.map(_crc32_file, paths))


def _manifest_entries(path: str) -> Dict[str, Dict[str, int]]:
    files = sorted(os.path.join(root, f) for root, _, names in os.walk(path)
                   for f in names if f not in (MANIFEST_FILE, COMMIT_MARKER_FILE))
    return {os.path.relpath(p, path): {"size": os.path.getsize(p), "crc32": crc}
            for p, crc in zip(files, _crc32_files(files))}


def write_manifest(path: str, tag: Any) -> None:
    """Write the integrity manifest, then the commit marker — in that order,
    each atomically (tmp + rename): a crash at any point leaves either no
    marker (torn, detectable) or a fully consistent checkpoint."""
    manifest = {
        "version": MANIFEST_VERSION,
        "tag": str(tag),
        "entries": _manifest_entries(path),
    }

    def _write():
        tmp = os.path.join(path, MANIFEST_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, MANIFEST_FILE))

    retry_with_backoff(_write, desc=f"write manifest {path}")

    def _mark():
        tmp = os.path.join(path, COMMIT_MARKER_FILE + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(tag))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, COMMIT_MARKER_FILE))

    retry_with_backoff(_mark, desc=f"write commit marker {path}")


def verify_checkpoint(path: str, require_manifest: bool = True) -> Tuple[bool, str]:
    """Integrity-check one checkpoint directory. Returns ``(ok, reason)``.

    ``require_manifest=False`` grandfathers pre-manifest checkpoints: a dir
    with NO manifest and NO marker passes (legacy), but a manifest that is
    present must verify and a manifest without its marker is a torn write."""
    if not os.path.isdir(path):
        return False, "missing directory"
    has_manifest = os.path.exists(os.path.join(path, MANIFEST_FILE))
    has_marker = os.path.exists(os.path.join(path, COMMIT_MARKER_FILE))
    if not has_manifest and not has_marker:
        if require_manifest:
            return False, "uncommitted (no manifest/commit marker)"
        return True, "legacy checkpoint (no manifest); verification skipped"
    if not has_marker:
        return False, "torn write (manifest present but no commit marker)"
    if not has_manifest:
        return False, "commit marker without manifest"
    try:
        with open(os.path.join(path, MANIFEST_FILE)) as f:
            manifest = json.load(f)
        entries = manifest["entries"]
    except (json.JSONDecodeError, KeyError, OSError) as e:
        return False, f"unreadable manifest: {e}"
    for rel, meta in entries.items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            return False, f"missing entry {rel}"
        size = os.path.getsize(p)
        if size != meta["size"]:
            return False, f"size mismatch on {rel}: {size} != {meta['size']}"
    rels = list(entries)
    for rel, crc in zip(rels, _crc32_files([os.path.join(path, r) for r in rels])):
        if crc != entries[rel]["crc32"]:
            return False, f"checksum mismatch on {rel}"
    return True, "ok"


# ---------------------------------------------------------------------------
# save-dir scanning / quarantine / retention
# ---------------------------------------------------------------------------

_STEP_RE = re.compile(r"(\d+)\s*$")


def _tag_sort_key(load_dir: str, tag: str):
    """Newest-first ordering: numeric step suffix (global_step<N>) wins,
    falling back to directory mtime, then name."""
    m = _STEP_RE.search(tag)
    step = int(m.group(1)) if m else -1
    try:
        mtime = os.path.getmtime(os.path.join(load_dir, tag))
    except OSError:
        mtime = 0.0
    return (step, mtime, tag)


def scan_tags(load_dir: str) -> List[str]:
    """Checkpoint tags under ``load_dir``, newest first (quarantined dirs
    excluded)."""
    if not os.path.isdir(load_dir):
        return []
    tags = [d for d in os.listdir(load_dir)
            if os.path.isdir(os.path.join(load_dir, d))
            and not d.endswith(QUARANTINE_SUFFIX)]
    return sorted(tags, key=lambda t: _tag_sort_key(load_dir, t), reverse=True)


def quarantine_checkpoint(load_dir: str, tag: str) -> Optional[str]:
    """Move a bad checkpoint dir aside (``<tag>.quarantined[.N]``) so scans
    never retry it; kept (not deleted) as evidence for postmortems."""
    src = os.path.join(load_dir, tag)
    dst = src + QUARANTINE_SUFFIX
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{src}{QUARANTINE_SUFFIX}.{n}"
    try:
        retry_with_backoff(lambda: os.replace(src, dst),
                           desc=f"quarantine {src}")
    except Exception as e:  # noqa: BLE001 — quarantine is best-effort
        logger.warning(f"could not quarantine {src}: {e}")
        return None
    logger.warning(f"quarantined corrupt checkpoint {src} -> {dst}")
    return dst


def find_latest_valid_checkpoint(load_dir: str, quarantine: bool = True,
                                 require_manifest: bool = True) -> Optional[str]:
    """Newest tag under ``load_dir`` that passes manifest verification,
    falling back through older tags.

    Only *provably* bad dirs (a manifest or commit marker is present but
    verification fails: torn or corrupt) are quarantined; dirs with neither
    file are merely skipped when ``require_manifest`` — they could be a
    legacy-format checkpoint or another process's in-flight save, and a
    crash-time scan must not destroy either."""
    for tag in scan_tags(load_dir):
        path = os.path.join(load_dir, tag)
        ok, reason = verify_checkpoint(path, require_manifest=require_manifest)
        if ok:
            return tag
        provable = (os.path.exists(os.path.join(path, MANIFEST_FILE))
                    or os.path.exists(os.path.join(path, COMMIT_MARKER_FILE)))
        logger.warning(f"checkpoint {tag} failed verification ({reason}); "
                       "falling back to an older tag")
        if quarantine and provable:
            quarantine_checkpoint(load_dir, tag)
    return None


def read_latest_tag(load_dir: str) -> Optional[str]:
    latest = os.path.join(load_dir, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        tag = f.read().strip()
    return tag or None


def write_latest_tag(load_dir: str, tag: Any) -> None:
    """Atomic ``latest`` pointer update (tmp + rename): readers never see a
    half-written tag."""

    def _write():
        tmp = os.path.join(load_dir, "latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(tag))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(load_dir, "latest"))

    retry_with_backoff(_write, desc=f"write latest pointer in {load_dir}")


def prune_checkpoints(save_dir: str, keep_last_n: int,
                      protect: Tuple[str, ...] = ()) -> List[str]:
    """Retention GC: keep the ``keep_last_n`` newest committed tags (plus
    anything in ``protect`` and the current ``latest`` target), delete the
    rest with bounded retry. Returns the deleted tags. ``keep_last_n <= 0``
    keeps everything."""
    if keep_last_n <= 0:
        return []
    keep = set(protect)
    latest = read_latest_tag(save_dir)
    if latest:
        keep.add(latest)
    tags = scan_tags(save_dir)  # newest first
    committed = [t for t in tags
                 if os.path.exists(os.path.join(save_dir, t, COMMIT_MARKER_FILE))]
    keep.update(committed[:keep_last_n])
    deleted = []
    for tag in committed[keep_last_n:]:
        if tag in keep:
            continue
        path = os.path.join(save_dir, tag)
        try:
            retry_with_backoff(lambda p=path: shutil.rmtree(p),
                               desc=f"prune checkpoint {path}")
            deleted.append(tag)
        except Exception as e:  # noqa: BLE001 — GC failure must not kill training
            logger.warning(f"retention GC could not delete {path}: {e}")
    if deleted:
        logger.info(f"retention (keep_last_n={keep_last_n}): pruned {deleted}")
    return deleted


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _to_cpu(obj):
    """``obj`` with every tensor copied to the CPU (a snapshot: training may
    overwrite the device buffers as soon as this returns)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _split_parts(obj, parts: list):
    """``obj`` with each tensor of ``SPLIT_BYTES`` or more replaced by a
    reference to its own file (appended to ``parts``), so a rank's large
    buffers are written, summed and read side by side."""
    if isinstance(obj, torch.Tensor) and obj.nbytes >= SPLIT_BYTES:
        parts.append(obj)
        return {_PART: len(parts) - 1}
    if isinstance(obj, dict):
        return {k: _split_parts(v, parts) for k, v in obj.items()}
    return obj


def _join_parts(obj, load_part):
    if isinstance(obj, dict):
        if set(obj) == {_PART}:
            return load_part(obj[_PART])
        return {k: _join_parts(v, load_part) for k, v in obj.items()}
    return obj


def load_rank_state(path: str, rank: int):
    """One rank's saved state, its tensors memory-mapped."""
    def load(name):
        return torch.load(os.path.join(path, name), map_location="cpu", mmap=True,
                          weights_only=True)
    return _join_parts(load(STATE_FILE.format(rank=rank)),
                       lambda i: load(PART_FILE.format(rank=rank, part=i)))


def _atomic_write(path: str, write: Callable[[Any], None], mode: str = "wb"):
    """``write(f)`` into ``path`` through a temporary name in the same
    directory, flushed, then renamed into place."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, mode) as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointEngine:
    """ABC (reference checkpoint_engine.py:9)."""

    def __init__(self, config_params=None):
        pass

    def create(self, tag):
        ...

    def save(self, state_dict, path: str):
        raise NotImplementedError

    def load(self, path: str, map_location=None):
        raise NotImplementedError

    def commit(self, tag):
        raise NotImplementedError

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)


class TorchCheckpointEngine(CheckpointEngine):
    """Each rank's state as ``torch.save`` files, rank 0's host state, and
    the seal at ``commit`` (the JAX ``OrbaxCheckpointEngine``'s contract).

    ``rank`` is this process's index among the ranks that write
    one checkpoint; ``barrier()`` returns once every rank has reached it,
    and ``agree(ok)`` returns rank 0's ``ok`` on every rank (defaults: one
    process). ``commit(tag)`` is the durability barrier and the seal: every
    rank's write has ended, the host state is in place, then rank 0 writes
    the manifest and (last) the marker. It returns False, and the caller
    must not advance the ``latest`` pointer, when the checkpoint could not
    be sealed."""

    HOST_STATE_FILE = HOST_STATE_FILE

    def __init__(self, config_params=None, rank: int = 0,
                 barrier: Optional[Callable[[], None]] = None,
                 agree: Optional[Callable[[bool], bool]] = None, use_async: bool = False):
        super().__init__(config_params)
        self.rank = int(rank)
        self._barrier = barrier or (lambda: None)
        self._agree = agree or (lambda ok: ok)
        self._async = use_async
        self._pending_path = None
        self._pending_host = None
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self.last_save_bytes = 0

    def create(self, tag):
        logger.info(f"[TorchCheckpointEngine] Checkpoint {tag} is about to be saved!")

    def save(self, state_dict: Dict[str, Any], path: str, host_state: Optional[Dict] = None,
             layout: Optional[Dict] = None):
        """Write this rank's ``state_dict`` (tensors, nested in dicts) and
        its ``layout`` under ``path``; rank 0 also ``host_state``. The async
        engine returns once the tensors are snapshotted on the host and
        writes in the background; ``commit`` waits for it."""
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        snapshot = _to_cpu(state_dict)
        self._pending_path = path
        self._pending_host = (path, host_state)
        if self._async:
            self._write_error = None

            def run():
                try:
                    self._write_rank(path, snapshot, layout)
                except Exception as e:  # noqa: BLE001 — surfaced at commit
                    self._write_error = e
            self._writer = threading.Thread(target=run, daemon=True)
            self._writer.start()
            return path
        self._write_rank(path, snapshot, layout)
        self._write_host_state(path, host_state)
        self._pending_host = None
        return path

    def _write_rank(self, path, snapshot, layout):
        parts = []
        files = [(os.path.join(path, STATE_FILE.format(rank=self.rank)),
                  _split_parts(snapshot, parts))]
        files += [(os.path.join(path, PART_FILE.format(rank=self.rank, part=i)), t)
                  for i, t in enumerate(parts)]

        def write(job):
            file, obj = job
            retry_with_backoff(lambda: _atomic_write(file, lambda f: torch.save(obj, f)),
                               desc=f"write {file}")
            return os.path.getsize(file)

        with ThreadPoolExecutor(max_workers=min(8, len(files))) as pool:
            size = sum(pool.map(write, files))
        if layout is not None:
            lfile = os.path.join(path, LAYOUT_FILE.format(rank=self.rank))
            retry_with_backoff(lambda: _atomic_write(lfile, lambda f: json.dump(layout, f),
                                                     mode="w"),
                               desc=f"write {lfile}")
            size += os.path.getsize(lfile)
        self.last_save_bytes = size

    def _write_host_state(self, path, host_state):
        # pickle, not JSON: client state may hold arbitrary objects (the
        # reference torch.save()s it, engine.py:3109); one rank writes it
        if host_state is None or self.rank != 0:
            return
        file = os.path.join(path, HOST_STATE_FILE)
        retry_with_backoff(lambda: _atomic_write(file, lambda f: pickle.dump(host_state, f)),
                           desc=f"write {file}")

    def load(self, path: str, map_location=None, verify: bool = True, rank: Optional[int] = None):
        """``(state of rank ``rank`` (default this one's, else rank 0's),
        host state)``, the tensors memory-mapped. ``verify`` checks the
        manifest first (a directory with neither manifest nor marker passes
        as legacy) and raises :class:`CheckpointCorruptionError`."""
        path = os.path.abspath(path)
        if verify:
            ok, reason = verify_checkpoint(path, require_manifest=False)
            if not ok:
                raise CheckpointCorruptionError(f"{path}: {reason}")
        r = self.rank if rank is None else rank
        if not os.path.exists(os.path.join(path, STATE_FILE.format(rank=r))):
            r = 0
        return load_rank_state(path, r), read_host_state(path)

    def commit(self, tag) -> bool:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        ok = self._write_error is None
        if not ok:
            logger.error(f"[TorchCheckpointEngine] write of {tag} failed: {self._write_error}")
        if self._pending_host is not None and ok:
            self._write_host_state(*self._pending_host)
        self._pending_host = None
        path, self._pending_path = self._pending_path, None
        self._barrier()  # every rank's files are in place
        if path is not None and self.rank == 0 and ok:
            ok = self._seal(path, tag)
        ok = self._agree(ok)
        if ok:
            logger.info(f"[TorchCheckpointEngine] Checkpoint {tag} is ready now!")
        return ok

    def _seal(self, path, tag) -> bool:
        fi = get_fault_injector()
        torn = fi.fire("checkpoint.torn_write", path=path, tag=tag)
        if torn is not None:
            # a simulated crash mid-write: a truncated entry and no
            # manifest or marker; the load path must detect it and fall back
            tear_checkpoint_dir(path, truncate_to=int(torn.get("truncate_to", 16)))
            logger.error(f"[TorchCheckpointEngine] commit of {tag} failed (torn write)")
            return False
        try:
            write_manifest(path, tag)
        except Exception as e:  # noqa: BLE001 — a seal failure is no commit
            logger.error(f"[TorchCheckpointEngine] could not seal {tag}: {e}")
            return False
        if fi.fire("checkpoint.corrupt", path=path, tag=tag) is not None:
            # silent bit-rot after the commit: only the manifest's check at
            # load stands between it and a bad resume
            corrupt_file_in(path, seed=fi.seed)
        return True


class AsyncCheckpointEngine(TorchCheckpointEngine):
    """``save`` returns once the snapshot is on the host; the files are
    written in the background and ``commit`` (the durability barrier)
    waits for them before it seals (reference
    nebula_checkpoint_engine.py)."""

    def __init__(self, config_params=None, **kw):
        super().__init__(config_params, use_async=True, **kw)


def read_host_state(path: str) -> Optional[Dict]:
    """The host state of the checkpoint at ``path`` (None without one)."""
    file = os.path.join(path, HOST_STATE_FILE)
    if not os.path.exists(file):
        return None
    with open(file, "rb") as f:
        return pickle.load(f)


class ShardedReader:
    """The flat buffers of a checkpoint written by any number of ranks,
    read by parameter name and element range. Each rank's layout
    (``layout_rank<r>.json``) is ``{"params": {name: shape}, "pieces":
    {buffer: [[name, start, end, offset], ...]}, "buffers": {kind:
    buffer}}``: element ``start..end`` of that rank's flat ``buffer`` holds
    elements ``offset..`` of the flattened parameter ``name``; ``buffers``
    maps each saved kind (``fp32``, the optimizer's moments, ``grad_acc``)
    to the flat buffer whose pieces it follows. Replicas' duplicate pieces
    are read once."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        files = sorted(f for f in os.listdir(self.path)
                       if re.fullmatch(r"layout_rank\d+\.json", f))
        if not files:
            raise FileNotFoundError(f"{self.path}: no layout_rank*.json (not a checkpoint of "
                                    "the port's training engine)")
        self.layouts = {}
        for f in files:
            with open(os.path.join(self.path, f)) as fh:
                self.layouts[int(re.findall(r"\d+", f)[0])] = json.load(fh)
        first = self.layouts[min(self.layouts)]
        self.shapes = {k: tuple(v) for k, v in first["params"].items()}
        self.kinds = dict(first["buffers"])
        self.meta = first.get("meta", {})
        self._states: Dict[int, Any] = {}
        # buffer -> name -> [(offset, end_in_param, rank, start)]
        self._index: Dict[str, Dict[str, list]] = {}
        for r, lay in sorted(self.layouts.items()):
            for buf, pieces in lay["pieces"].items():
                by_name = self._index.setdefault(buf, {})
                for name, s, e, off in pieces:
                    by_name.setdefault(name, []).append((off, off + e - s, r, s))

    def _state(self, r):
        if r not in self._states:
            self._states[r] = load_rank_state(self.path, r)
        return self._states[r]

    def has(self, kind: str) -> bool:
        return kind in self.kinds

    def read(self, kind: str, name: str, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Elements ``lo..hi`` of the flattened parameter ``name`` of the
        saved buffer ``kind``, as a CPU fp32 tensor (or the buffer's dtype)."""
        if hi is None:
            hi = int(np.prod(self.shapes[name]))
        pieces = self._index[self.kinds[kind]].get(name, [])
        out, filled = None, lo
        for off, end, r, s in sorted(pieces):
            if end <= filled or off >= hi:
                continue
            if off > filled:
                break
            a, b = filled, min(end, hi)
            src = self._state(r)["buffers"][kind][s + a - off:s + b - off]
            if out is None:
                out = torch.empty(hi - lo, dtype=src.dtype)
            out[a - lo:b - lo] = src
            filled = b
            if filled >= hi:
                break
        if filled < hi:
            raise ValueError(f"{self.path}: {kind} of {name} has no piece covering elements "
                             f"{filled}..{hi}")
        return out if out is not None else torch.empty(0)

    def full(self, kind: str, name: str) -> torch.Tensor:
        return self.read(kind, name).view(self.shapes[name])

    def scalars(self, r: int = 0) -> Dict[str, Any]:
        return self._state(r).get("scalars", {})


