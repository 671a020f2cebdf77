"""Fault-tolerance runtime: straggler detection, heartbeats and the
restart policy.  Counterpart of `repro.runtime.fault_tolerance`.

Serving: the server builds the `DecodeWatchdog` with the tuner's
predicted step time (`kernels.autotune.predict_decode_step_us`), and the
summary reports it beside the measured step times and the stragglers.

Training: the trainer wraps its step loop in `run_resilient`, which
checkpoints every N steps (async, atomic: `checkpoint.manager`), watches
step wall time against a rolling median, and on an exception restores
the latest committed checkpoint through the trainer's ``on_restore`` and
resumes from the restored step with the same data order (the pipeline is
(seed, step, shard)-deterministic).  The trainer's ``on_restore`` is
`restore_onto`: the checkpoint's whole arrays placed on a mesh by their
specs, which may be a smaller mesh rebuilt from the surviving ranks
(`runtime.elastic`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

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


class Heartbeat:
    """Per-host liveness: hosts `beat()`; the coordinator calls `dead()`."""

    def __init__(self, num_hosts: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.last = {h: clock() for h in range(num_hosts)}
        self.timeout = timeout_s
        self.clock = clock

    def beat(self, host: int):
        self.last[host] = self.clock()

    def dead(self) -> list[int]:
        now = self.clock()
        return [h for h, t in self.last.items()
                if now - t > self.timeout]


@dataclasses.dataclass
class ResilienceConfig:
    checkpoint_every: int = 50
    max_restarts: int = 3
    straggler_threshold: float = 2.0


def run_resilient(step_fn, state, num_steps: int, ckpt_manager,
                  batch_fn, start_step: int = 0,
                  config: ResilienceConfig = ResilienceConfig(),
                  fault_hook=None, on_restore=None):
    """Drive ``state = step_fn(state, batch)`` with checkpoint/restart.

    ``fault_hook(step)`` may raise to inject a failure (tests).
    ``on_restore(step)`` -> (state, step) rebuilds state from the latest
    checkpoint.  A step's time runs to the host's reading of its metrics
    (`to_float`, which waits for the card).  The final state is saved,
    blocking, at ``num_steps``.  Returns (state, metrics_history,
    monitor).
    """
    monitor = StragglerMonitor(threshold=config.straggler_threshold)
    history = []
    restarts = 0
    step = start_step
    while step < num_steps:
        try:
            t0 = time.monotonic()
            if fault_hook is not None:
                fault_hook(step)
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            floats = to_float(metrics)
            dt = time.monotonic() - t0
            monitor.observe(step, dt)
            history.append({"step": step, "time": dt, **floats})
            step += 1
            if step % config.checkpoint_every == 0:
                ckpt_manager.save(step, state)
        except KeyboardInterrupt:
            raise
        except Exception:
            restarts += 1
            if restarts > config.max_restarts or on_restore is None:
                raise
            try:
                ckpt_manager.wait()  # drain any in-flight async save first
            except Exception:
                pass
            state, step = on_restore(step)
    ckpt_manager.save(num_steps, state, blocking=True)
    return state, history, monitor


def restore_onto(ckpt_manager, like, mesh, pspecs, step=None):
    """``(state, step)``: a checkpoint (the latest committed, or
    ``step``) restored on the host into ``like``'s structure and placed
    on ``mesh`` by ``pspecs`` (`elastic.reshard_state`), which need not
    be the mesh that wrote it."""
    from repro_torch.runtime import elastic
    host, meta = ckpt_manager.restore(step, like)
    return elastic.reshard_state(host, mesh, pspecs), meta["step"]


def to_float(metrics: dict) -> dict:
    """The metrics that convert to a Python float (0-d tensors, numbers);
    the counterpart of the reference's ``jax_to_float``."""
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            pass
    return out
