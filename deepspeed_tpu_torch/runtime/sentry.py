"""Anomaly sentry: windowed loss-spike / overflow / NaN detection (port of
``deepspeed_tpu/runtime/sentry.py``).

The fp16 loss scaler already detects overflow per step (and skips the
update), but it cannot see two other production failure modes: NaN episodes
in full precision (no scaler in the loop — the poisoned update is applied),
and loss spikes from bad data that are numerically finite. The sentry
watches all three signals at step boundaries and, after
``max_consecutive_anomalies`` consecutive bad steps, tells the engine to
roll back to the last good checkpoint (``runtime/engine.py`` performs the
actual restore, keeping the data sampler's position so the offending window
is skipped rather than replayed).

Detection is host-side and cheap: the port runs the engine's sync mode
only (the async step window is not ported), so each step's loss, which
the step already fetched, is observed at the step boundary. No extra
device-to-host syncs are introduced.
"""

import logging
import math
from collections import deque
from typing import Optional

logger = logging.getLogger(__name__)


class AnomalySentry:
    """Consecutive-anomaly counter over three signals.

    ``observe(loss, overflow, step)`` returns the anomaly kind for this step
    (``"overflow"``, ``"nonfinite_loss"``, ``"loss_spike"``) or None; the
    engine checks ``should_rollback`` afterwards. A healthy step resets the
    consecutive counter and joins the spike-detector's reference window.
    """

    def __init__(self, max_consecutive: int = 3, spike_window: int = 20,
                 spike_factor: float = 3.0, spike_min_history: int = 5,
                 monitor=None):
        self.max_consecutive = max(1, int(max_consecutive))
        self.spike_factor = float(spike_factor)
        self.spike_min_history = max(1, int(spike_min_history))
        self._good = deque(maxlen=max(2, int(spike_window)))
        self.consecutive = 0
        self.total_anomalies = 0
        self.rollbacks = 0
        self._monitor = monitor

    # -- detection ---------------------------------------------------------

    def _spike_threshold(self) -> Optional[float]:
        if len(self._good) < self.spike_min_history:
            return None
        ordered = sorted(self._good)
        mid = len(ordered) // 2
        median = (ordered[mid] if len(ordered) % 2
                  else 0.5 * (ordered[mid - 1] + ordered[mid]))
        # abs() keeps the factor meaningful for near-zero / negative losses
        # (e.g. log-prob objectives); +1e-8 avoids a degenerate 0 threshold
        return abs(median) * self.spike_factor + 1e-8

    def observe(self, loss: Optional[float], overflow: bool,
                step: int) -> Optional[str]:
        kind = None
        if overflow:
            kind = "overflow"
        elif loss is not None and not math.isfinite(loss):
            kind = "nonfinite_loss"
        elif loss is not None:
            thr = self._spike_threshold()
            if thr is not None and abs(loss) > thr:
                kind = "loss_spike"
        if kind is None:
            if loss is not None and math.isfinite(loss):
                self._good.append(float(loss))
            self.consecutive = 0
            return None
        self.consecutive += 1
        self.total_anomalies += 1
        logger.warning(
            f"[sentry] step {step}: {kind} (loss={loss}), consecutive "
            f"{self.consecutive}/{self.max_consecutive}")
        if self._monitor is not None:
            self._monitor.write_events([
                ("Train/Sentry/anomaly", self.consecutive, step)])
        return kind

    @property
    def should_rollback(self) -> bool:
        return self.consecutive >= self.max_consecutive

    # -- rollback bookkeeping ---------------------------------------------

    def note_rollback(self, tag, step: int):
        self.rollbacks += 1
        self.consecutive = 0
        self._good.clear()  # post-rollback losses define a fresh baseline
        logger.warning(f"[sentry] step {step}: rolling back to checkpoint "
                       f"{tag!r} (rollback #{self.rollbacks})")
        if self._monitor is not None:
            self._monitor.write_events([
                ("Train/Sentry/rollback", self.rollbacks, step)])

    def reset(self):
        self.consecutive = 0
        self._good.clear()
