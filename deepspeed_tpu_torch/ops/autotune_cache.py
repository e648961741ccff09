"""Persistent on-disk autotune cache for per-shape attention decisions
(port of ``deepspeed_tpu/ops/autotune_cache.py``: ``cache_dir :38``,
``_load_table :53``, ``AutotuneCache :68``, ``get_cache :131``).

One JSON table maps a shape signature (leg + device kind + shape + dtype +
mask flags, ``kernel_dispatch.signature``) to the implementation and
(block_q, block_k) that measured fastest for it. The sweep
(``python -m deepspeed_tpu_torch.ops.attn_sweep``) writes it;
``kernel_dispatch.resolve`` reads it. Without a measurement the dispatcher
falls back to its heuristic: the cache only ever upgrades a decision.

File format, the JAX package's (version-stamped)::

    {"version": 1,
     "entries": {"<signature>": {"impl": "xla|pallas|folded",
                                 "block_q": 128, "block_k": 128,
                                 "ms": 1.7, "utc": "...", "note": "..."}}}

A commit writes a temporary file, fsyncs it and renames it over the table,
so a writer killed mid-commit leaves the old table or the new one. A torn
or unreadable table, or one of another version, reads as empty.

Location, the JAX package's precedence: ``$DS_TPU_ATTN_CACHE_DIR`` when
set, else ``$XDG_CACHE_HOME`` (or ``~/.cache``) ``/deepspeed_tpu_torch``.
The default directory is the port's own: on a CPU both packages key their
entries on device kind ``cpu``, and the port's ``xla`` leg is plain
PyTorch, not XLA, so the two must not read each other's measurements.
"""

import json
import os
import time
from typing import Dict, Optional

CACHE_VERSION = 1
CACHE_FILENAME = "attn_dispatch.json"


def cache_dir() -> str:
    """``$DS_TPU_ATTN_CACHE_DIR`` if set, else the per-user XDG cache tree
    (outside any checkout)."""
    env = os.environ.get("DS_TPU_ATTN_CACHE_DIR")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "deepspeed_tpu_torch")


def cache_path() -> str:
    return os.path.join(cache_dir(), CACHE_FILENAME)


def _load_table(path: str) -> Dict:
    """The entries of the table at ``path``; missing, torn or of another
    version reads as empty."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION:
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


class AutotuneCache:
    """A view of the on-disk table, re-read when its path or mtime changes,
    and its commit writer."""

    def __init__(self, path: Optional[str] = None):
        self._explicit_path = path
        self._loaded_for = None  # (path, mtime) the entries mirror
        self._entries: Dict[str, Dict] = {}

    @property
    def path(self) -> str:
        return self._explicit_path or cache_path()

    def _refresh(self) -> None:
        path = self.path
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            mtime = None
        key = (path, mtime)
        if key == self._loaded_for:
            return
        self._entries = _load_table(path) if mtime is not None else {}
        self._loaded_for = key

    def lookup(self, signature: str) -> Optional[Dict]:
        self._refresh()
        ent = self._entries.get(signature)
        return dict(ent) if isinstance(ent, dict) else None

    def entries(self) -> Dict[str, Dict]:
        self._refresh()
        return dict(self._entries)

    def commit(self, signature: str, entry: Dict) -> None:
        """Merge one measured winner into the table and replace the file
        atomically (temporary file, fsync, rename)."""
        path = self.path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        entries = _load_table(path)
        entries[signature] = dict(entry,
                                  utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                    time.gmtime()))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries}, f,
                      indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._loaded_for = None  # the next lookup re-reads the table

    def source_description(self) -> str:
        """Where decisions come from right now, in one line."""
        self._refresh()
        if self._entries:
            return f"measured ({self.path}, {len(self._entries)} entries)"
        return f"heuristic (no measured table at {self.path})"


_default_cache: Optional[AutotuneCache] = None


def get_cache() -> AutotuneCache:
    """The process-wide view. Its path is resolved again on every lookup,
    so a change of ``DS_TPU_ATTN_CACHE_DIR`` takes effect at once."""
    global _default_cache
    if _default_cache is None:
        _default_cache = AutotuneCache()
    return _default_cache
