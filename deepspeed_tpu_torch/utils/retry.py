"""Bounded retry with exponential backoff (port of
``deepspeed_tpu/utils/retry.py``).

Storage writes (checkpoint manifests, `latest` pointers, retention GC) and
the distributed rendezvous both talk to systems that fail transiently —
NFS/GCS hiccups, a coordinator that isn't up yet. Every resilience-layer
caller routes through this one helper so the retry budget is bounded and
uniform: no unbounded spin, no bare ``while True`` around IO.

Jitter: with a whole replica fleet retrying against the same peers (the
router's failover submits, the supervisor's relaunch backoff), plain
exponential backoff synchronizes every client onto the same retry
instants — a thundering-herd storm exactly when the surviving replica is
most loaded. ``jitter="full"`` draws each delay uniformly from
``[0, min(max_delay, base * 2**i)]`` (the AWS "full jitter" policy), which
decorrelates the fleet while keeping the same expected backoff envelope.
The draw comes from a caller-suppliable RNG so tests replay the exact
delay sequence from a seed.
"""

import logging
import random
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger(__name__)


class RetriesExhausted(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""


def backoff_delay(attempt: int,
                  base_delay: float = 0.05,
                  max_delay: float = 2.0,
                  jitter: str = "none",
                  rng: Optional[random.Random] = None) -> float:
    """Delay before retry ``attempt`` (0-based): ``base * 2**attempt``
    capped at ``max_delay``; with ``jitter="full"`` a uniform draw from
    ``[0, cap]``. Deterministic when ``rng`` is seeded."""
    if jitter not in ("none", "full"):
        raise ValueError(f"jitter must be 'none' or 'full', got {jitter!r}")
    cap = min(max_delay, base_delay * (2 ** attempt))
    if jitter == "none":
        return cap
    return (rng or random).uniform(0.0, cap)


def retry_with_backoff(fn: Callable,
                       retries: int = 3,
                       base_delay: float = 0.05,
                       max_delay: float = 2.0,
                       exceptions: Tuple[Type[BaseException], ...] = (OSError, ),
                       desc: Optional[str] = None,
                       sleep: Callable[[float], None] = time.sleep,
                       jitter: str = "none",
                       rng: Optional[random.Random] = None):
    """Call ``fn()`` up to ``retries`` times, sleeping ``base_delay * 2**i``
    (capped at ``max_delay``, uniformly jittered down under
    ``jitter="full"``) between attempts. Non-matching exceptions propagate
    immediately; exhausting the budget raises :class:`RetriesExhausted`
    chained to the last error."""
    retries = max(1, int(retries))
    last = None
    for attempt in range(retries):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203 — the retry IS the point
            last = e
            if attempt + 1 < retries:
                delay = backoff_delay(attempt, base_delay, max_delay,
                                      jitter=jitter, rng=rng)
                logger.warning(
                    f"{desc or getattr(fn, '__name__', 'op')}: attempt "
                    f"{attempt + 1}/{retries} failed ({e}); retrying in "
                    f"{delay:.2f}s")
                sleep(delay)
    raise RetriesExhausted(
        f"{desc or getattr(fn, '__name__', 'op')} failed after {retries} "
        f"attempts: {last}") from last
