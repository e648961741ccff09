"""Deterministic fault-injection harness (port of
``deepspeed_tpu/utils/fault_injection.py``).

The resilience layer (crash-consistent checkpoints, preemption autosave,
anomaly rollback) is only trustworthy if every failure path
is exercised by tests — so the production code carries explicit, normally
inert fault *sites*, and this module decides when a site fires.

Faults are configured from the ``resilience.fault_injection`` config block or
the ``DS_FAULT_INJECT`` env var; firing is purely occurrence-counted (the
``nth`` visit to a site, for ``times`` visits), never random — a configured
fault plan replays identically on every run. Corruption *content* uses a
seeded RNG for the same reason.

Registered sites (the code that hosts them decides the fault's meaning):

- ``checkpoint.torn_write``   — commit() tears the checkpoint (truncated
  entry, no manifest/commit marker) and reports failure: a crash mid-write.
- ``checkpoint.corrupt``      — after a successful commit, flip bytes in one
  manifest-covered entry: silent storage corruption the manifest must catch.
- ``train.sigterm``           — deliver SIGTERM to this process mid-step:
  a preemption notice arriving while the step pipeline is in flight.
- ``train.nan_grads``         — poison the micro-batch with NaNs so the
  backward produces non-finite gradients: a NaN episode.

The JAX package's other sites (``comm.init_timeout`` and the serving,
journal, disaggregation and router sites) live in layers the port has not
ported yet; they come with those layers.

Env syntax: ``DS_FAULT_INJECT="site[@nth][*times][;site2...]"`` e.g.
``DS_FAULT_INJECT="checkpoint.torn_write@2;train.nan_grads@5*3"``.
"""

import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

KNOWN_SITES = (
    "checkpoint.torn_write",
    "checkpoint.corrupt",
    "train.sigterm",
    "train.nan_grads",
)


class FaultInjector:
    """Occurrence-counted fault plan. One global instance drives the whole
    process (fault sites live in several layers); tests configure/reset it
    around each scenario."""

    def __init__(self):
        self._plans: Dict[str, List[dict]] = {}
        self._visits: Dict[str, int] = {}
        self._fired: List[str] = []
        self.seed = 0

    # -- configuration ---------------------------------------------------

    def configure(self, spec: Optional[Dict[str, Any]]):
        """Install a fault plan from a ``resilience.fault_injection``-shaped
        dict: ``{"seed": 0, "faults": [{"site": ..., "nth": 1, "times": 1,
        "args": {...}}]}``. Replaces any existing plan and resets counters."""
        self.reset()
        if not spec:
            return
        if not isinstance(spec, dict):  # the config's FaultInjectionConfig
            spec = vars(spec)
        if not spec.get("enabled", True):
            return
        self.seed = int(spec.get("seed", 0))
        for f in spec.get("faults", []):
            site = f["site"]
            if site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; known: {KNOWN_SITES}")
            self._plans.setdefault(site, []).append({
                "nth": int(f.get("nth", 1)),
                "times": int(f.get("times", 1)),
                "args": dict(f.get("args", {})),
            })

    def configure_env(self, text: Optional[str] = None):
        """Parse ``DS_FAULT_INJECT`` (see module docstring)."""
        text = text if text is not None else os.environ.get("DS_FAULT_INJECT", "")
        faults = []
        for part in filter(None, (p.strip() for p in text.split(";"))):
            site, nth, times = part, 1, 1
            if "*" in site:
                site, t = site.rsplit("*", 1)
                times = int(t)
            if "@" in site:
                site, n = site.rsplit("@", 1)
                nth = int(n)
            faults.append({"site": site, "nth": nth, "times": times})
        if faults:
            self.configure({"faults": faults})

    def reset(self):
        self._plans.clear()
        self._visits.clear()
        self._fired.clear()
        self.seed = 0

    # -- firing ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return bool(self._plans)

    def fire(self, site: str, **ctx) -> Optional[dict]:
        """Record a visit to ``site``; return the fault's ``args`` dict if a
        configured fault covers this visit, else None. Sites without a plan
        are not counted (zero steady-state overhead)."""
        plans = self._plans.get(site)
        if not plans:
            return None
        n = self._visits.get(site, 0) + 1
        self._visits[site] = n
        for p in plans:
            if p["nth"] <= n < p["nth"] + p["times"]:
                self._fired.append(f"{site}#{n}")
                logger.warning(f"[fault-injection] firing {site} (visit {n})")
                return p["args"]
        return None

    @property
    def fired(self) -> List[str]:
        """Every fault fired so far (``site#visit``), for test assertions."""
        return list(self._fired)


_INJECTOR = FaultInjector()
_ENV_LOADED = False


def get_fault_injector() -> FaultInjector:
    """The process-global injector; lazily absorbs ``DS_FAULT_INJECT`` once."""
    global _ENV_LOADED
    if not _ENV_LOADED:
        _ENV_LOADED = True
        try:
            _INJECTOR.configure_env()
        except (ValueError, KeyError) as e:
            logger.warning(f"DS_FAULT_INJECT ignored (parse error: {e})")
    return _INJECTOR


# ---------------------------------------------------------------------------
# fault actions — the concrete damage a firing site inflicts
# ---------------------------------------------------------------------------


def tear_checkpoint_dir(path: str, truncate_to: int = 16) -> Optional[str]:
    """Simulate a crash mid-write: truncate the largest file under ``path``
    (a half-flushed array shard). Returns the torn file's path."""
    victim, size = None, truncate_to
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > size:
                victim, size = p, s
    if victim is not None:
        with open(victim, "r+b") as fh:
            fh.truncate(truncate_to)
        logger.warning(f"[fault-injection] tore {victim} to {truncate_to}B")
    return victim


def corrupt_file_in(path: str, seed: int = 0, skip=("ds_manifest.json", "ds_commit")) -> Optional[str]:
    """Silent bit-rot: deterministically flip bytes mid-file in the largest
    entry under ``path`` not in ``skip`` — the manifest checksum must catch
    it. Returns the corrupted file's path."""
    victim, size = None, 0
    for root, _, files in os.walk(path):
        for f in files:
            if f in skip:
                continue
            p = os.path.join(root, f)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > size:
                victim, size = p, s
    if victim is not None:
        rng = np.random.default_rng(seed)
        n = min(64, max(1, size // 4))
        off = size // 2
        with open(victim, "r+b") as fh:
            fh.seek(off)
            orig = fh.read(n)
            garbage = bytes(rng.integers(0, 256, len(orig), dtype=np.uint8))
            if garbage == orig:  # vanishingly unlikely; force a difference
                garbage = bytes((orig[0] ^ 0xFF, )) + garbage[1:]
            fh.seek(off)
            fh.write(garbage)
        logger.warning(f"[fault-injection] corrupted {len(orig)}B in {victim}")
    return victim
