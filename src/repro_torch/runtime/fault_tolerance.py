"""Serving watchdog: rolling-median straggler detection.  The
`StragglerReport` / `StragglerMonitor` / `DecodeWatchdog` part of
`repro.runtime.fault_tolerance`, copied (numpy only).  The server builds
the watchdog with the tuner's predicted step time
(`kernels.autotune.predict_decode_step_us`), and the summary reports it
beside the measured step times and the stragglers."""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    ratio: float


class StragglerMonitor:
    """Rolling-median step-time watchdog (the paper's 'system-level
    simulation' instinct applied at runtime: the model of normal tells you
    what abnormal is)."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.times: deque = deque(maxlen=window)
        self.threshold = threshold
        self.reports: list[StragglerReport] = []

    def observe(self, step: int, step_time: float) -> StragglerReport | None:
        median = float(np.median(self.times)) if self.times else step_time
        self.times.append(step_time)
        if len(self.times) >= 8 and step_time > self.threshold * median:
            report = StragglerReport(step, step_time, median,
                                     step_time / median)
            self.reports.append(report)
            return report
        return None


class DecodeWatchdog:
    """Serving-side watchdog: the StragglerMonitor wired to the autotuner's
    predicted decode-step time.

    The coarse-grain estimator line of work (PAPERS.md) uses a
    predicted-vs-measured performance model as the natural misbehaving-
    execution signal; here the prediction is `autotune.predict_decode_step_us`
    (the same analytic machine model the kernel tuner ranks with) and the
    measurement is the serve loop's per-step wall clock.  Two signals come
    out: *stragglers* (a step way off the rolling median — transient) and
    *divergence* (the run's median vs the model — systematic), both
    reported in the serving summary rather than gated: on CPU
    interpret-mode the model predicts TPU time, so divergence is
    informational there and a gate only on real hardware.
    """

    def __init__(self, predicted_us: float | None,
                 threshold: float = 2.0):
        self.predicted_us = predicted_us
        self.monitor = StragglerMonitor(threshold=threshold)

    def observe(self, step: int, step_time_s: float) -> StragglerReport | None:
        return self.monitor.observe(step, step_time_s)

    def summary(self) -> dict:
        times = list(self.monitor.times)
        measured_us = float(np.median(times)) * 1e6 if times else None
        divergence = None
        if measured_us is not None and self.predicted_us:
            divergence = measured_us / self.predicted_us
        return {
            "predicted_step_us": self.predicted_us,
            "measured_step_us_p50": measured_us,
            "divergence": divergence,
            "stragglers": [dataclasses.asdict(r)
                           for r in self.monitor.reports],
        }
