"""Predictor-drift monitor: rolling per-lane residuals of sim vs measured
(a copy of ``repro.obs.drift``).

Algorithm 1's schedule and the adaptive controller both run on
``simulate_steps`` predictions; the offload runtime measures the same steps.
The controller's refit nudges its cost model from (measured, tokens) pairs,
but its trust region (``ControllerConfig.damping``) clamps each refit, so a
SYSTEMATIC model error does not show up as a bad fit: it shows up as the
trust region absorbing the same correction every window.  This monitor
makes that visible:

  * ``observe(measured, predicted)`` folds one step's per-lane busy times
    (pcie / pcie_up / gpu / cpu, plus the end-to-end total) into bounded
    rolling deques of ``(measured_s, predicted_s)`` pairs;
  * relative drift per lane = ``(sum(meas) - sum(pred)) / sum(pred)`` over
    the window: positive means the simulator is optimistic;
  * ``drifting()`` flags lanes whose |drift| exceeds ``flag_rel`` once
    ``min_samples`` steps are in the window;
  * registered on a ``MetricsRegistry`` the monitor exports
    ``predictor_drift_rel{lane=...}`` / ``predictor_drift_abs_s{lane=...}``
    gauges and a ``predictor_drift_flagged`` counter at ``snapshot()``.

Identity pairs (device-resident paths hand over ``measured is predicted``)
are skipped: a zero residual carries no information.  All host-side.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry

#: lanes tracked: download copies, upload stores (``tag_busy["st"]`` — the
#: TimelineResult schema carries no dedicated pcie_up field), device
#: compute, host-attention compute (``cpu_busy``), and wall total
DRIFT_LANES = ("pcie", "pcie_up", "gpu", "cpu", "total")

#: default flag threshold.  The controller refit clamps each window's
#: correction to ~1/damping (damping=4 -> 25%); persistent relative drift
#: beyond that is error the trust region can only chase, never close.
DEFAULT_FLAG_REL = 0.25


def _lane_busy(res, lane: str) -> float:
    if lane == "total":
        return float(getattr(res, "total", 0.0))
    if lane == "gpu":
        return float(getattr(res, "gpu_busy", 0.0))
    if lane == "pcie_up":
        return float((getattr(res, "tag_busy", None) or {}).get("st", 0.0))
    if lane == "cpu":
        return float(getattr(res, "cpu_busy", 0.0) or 0.0)
    return float(getattr(res, "pcie_busy", 0.0) or 0.0)


class DriftMonitor:
    """Rolling sim-vs-measured residuals per lane (see module docstring)."""

    def __init__(self, window: int = 256, flag_rel: float = DEFAULT_FLAG_REL,
                 min_samples: int = 8,
                 registry: Optional[MetricsRegistry] = None):
        self.window = window
        self.flag_rel = flag_rel
        self.min_samples = min_samples
        self._resid: Dict[str, Deque[Tuple[float, float]]] = {
            lane: deque(maxlen=window) for lane in DRIFT_LANES}
        self.samples = 0
        self.skipped_identity = 0
        self.skipped_faulted = 0
        self._reg = registry
        if registry is not None:
            registry.register_collector(self._collect)

    # ------------------------------------------------------------------ feed
    def observe(self, measured, predicted) -> bool:
        """Fold one step's (measured, predicted) TimelineResult pair.
        Returns True if the pair entered the window."""
        if measured is None or predicted is None or measured is predicted:
            self.skipped_identity += 1
            return False
        if getattr(measured, "faulted", False):
            # fault-degraded steps are recovery's problem, not the model's
            self.skipped_faulted += 1
            return False
        for lane in DRIFT_LANES:
            self._resid[lane].append(
                (_lane_busy(measured, lane), _lane_busy(predicted, lane)))
        self.samples += 1
        return True

    def observe_steps(self, measured_seq, predicted_seq) -> int:
        """Fold aligned per-step sequences; returns pairs accepted."""
        n = 0
        for m, p in zip(measured_seq or (), predicted_seq or ()):
            n += int(self.observe(m, p))
        return n

    # ----------------------------------------------------------------- reads
    def residuals(self, lane: str) -> List[Tuple[float, float]]:
        return list(self._resid[lane])

    def drift(self, lane: str) -> float:
        """Relative drift over the window; 0.0 until data arrives."""
        pairs = self._resid[lane]
        if not pairs:
            return 0.0
        meas = sum(m for m, _ in pairs)
        pred = sum(p for _, p in pairs)
        if pred <= 0.0:
            return 0.0
        return (meas - pred) / pred

    def drift_abs(self, lane: str) -> float:
        """Mean absolute residual per step (seconds)."""
        pairs = self._resid[lane]
        if not pairs:
            return 0.0
        return sum(m - p for m, p in pairs) / len(pairs)

    def drifting(self) -> List[str]:
        """Lanes whose |relative drift| exceeds the flag threshold with a
        warm window — i.e. where the controller's damped refit is absorbing
        systematic model error."""
        if self.samples < self.min_samples:
            return []
        return [lane for lane in DRIFT_LANES
                if any(True for _ in self._resid[lane])
                and len(self._resid[lane]) >= self.min_samples
                and abs(self.drift(lane)) > self.flag_rel]

    def summary(self) -> Dict[str, object]:
        return {
            "samples": self.samples,
            "skipped_identity": self.skipped_identity,
            "skipped_faulted": self.skipped_faulted,
            "window": self.window,
            "flag_rel": self.flag_rel,
            "rel": {lane: self.drift(lane) for lane in DRIFT_LANES},
            "abs_s": {lane: self.drift_abs(lane) for lane in DRIFT_LANES},
            "flagged": self.drifting(),
        }

    # ------------------------------------------------------------- collector
    def _collect(self, reg: MetricsRegistry) -> None:
        for lane in DRIFT_LANES:
            reg.gauge("predictor_drift_rel", lane=lane).set(self.drift(lane))
            reg.gauge("predictor_drift_abs_s",
                      lane=lane).set(self.drift_abs(lane))
        reg.gauge("predictor_drift_samples").set(float(self.samples))
        reg.counter("predictor_drift_flagged").set(len(self.drifting()))
