"""Deterministic fault injection for the serving loop (the chaos
harness), numpy and the standard library only.  Counterpart of
`repro.runtime.faults`: the same seeded schedules, event for event, and
the same injector.

A :class:`FaultPlan` is a list of :class:`FaultEvent`\\ s keyed on the
serve loop's step counter (decode step; prefill ordinal for prefill
interrupts), drawn from an integer seed, so the same ``--fault-seed``
gives the same faults at the same points and must give the same outcome
trace (per-request final states and retry counts).

Fault classes (one of each in the smoke schedule):

``nan_logits``        NaN into one slot's logits for one decode step
                      (the per-slot guard must quarantine it).
``kv_corrupt``        NaN over one slot's float cache leaves (the f32 or
                      bf16 K/V rows; the f32 scales of an int8 cache):
                      poisoned state, which the decode kernels must carry
                      into that slot's logits.
``kernel_dispatch``   raise :class:`KernelDispatchFault` before the decode
                      step's forward.  The port has no plain path on a
                      CUDA tensor, so the serve loop re-plans the decode
                      kernel and re-runs the step on it
                      (`launch.serve.serve_loop`).
``straggler``         stall one decode step by ``stall_s`` (the
                      measured-against-predicted decode watchdog).
``prefill_interrupt`` raise :class:`PrefillInterrupt` mid-prefill, after
                      the slot reset and before the forward.
``crash``             raise :class:`CrashFault`, which the loop does not
                      absorb (``serve --crash``; scheduled by
                      :meth:`FaultPlan.crash`, never by ``smoke``).

Injection points are explicit hooks: ``Server.prefill`` calls
``prefill_hook``, ``Server.decode_step`` calls ``apply_decode_faults``,
and ``kernels.autotune.dispatch`` consults the hook installed by
``install_dispatch_hook``.  The injector touches the server only through
its ``poison`` mask, ``corrupt_kv`` and ``slot_req``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class InjectedFault(Exception):
    """Base class for every injected failure."""


class KernelDispatchFault(InjectedFault):
    """Injected kernel-dispatch failure (stands in for a kernel launch
    that the card refuses, such as shared memory the plan did not fit)."""


class PrefillInterrupt(InjectedFault):
    """Injected mid-prefill interruption (stands in for preemption or a
    host fault between slot reset and cache write)."""


class CrashFault(InjectedFault):
    """Injected process death at a decode step (stands in for power loss,
    a watchdog reboot, or an OOM kill — the paper's embedded operating
    conditions).  Unlike every other fault class this one is NOT absorbed
    by the serve loop: it propagates out, the process exits without a
    summary, and only the journal + snapshots survive.  `serve --resume`
    must then reproduce the uninterrupted run token-for-token
    (the JAX package's docs/ROBUSTNESS.md, "Crash recovery")."""

    def __init__(self, msg: str, step: int = -1):
        super().__init__(msg)
        self.step = step


# Classes the --chaos smoke schedule absorbs in-process.  "crash" is the
# sixth class (FaultPlan.crash / serve --crash): it kills the loop instead
# of being absorbed, so it is scheduled explicitly, never by smoke().
SMOKE_FAULT_CLASSES = ("nan_logits", "kv_corrupt", "kernel_dispatch",
                       "straggler", "prefill_interrupt")
FAULT_CLASSES = SMOKE_FAULT_CLASSES + ("crash",)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str          # one of FAULT_CLASSES
    step: int          # decode step index; prefill ordinal for interrupts
    slot: int          # target slot hint (resolved modulo batch, occupied)
    stall_s: float = 0.0

    def record(self) -> dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """An ordered, seeded fault schedule."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e.step, e.kind, e.slot))

    @classmethod
    def smoke(cls, seed: int, *, max_step: int = 14,
              stall_s: float = 0.25) -> "FaultPlan":
        """One fault of every class at seeded-random steps/slots — the
        ``serve --chaos`` schedule.  Steps are
        drawn from [2, max_step] so the batch is warm when faults land;
        the straggler lands late enough (>= 8 observations) for the
        rolling-median watchdog to have a baseline."""
        rng = np.random.default_rng(seed)
        events = []
        for kind in ("nan_logits", "kv_corrupt", "kernel_dispatch"):
            events.append(FaultEvent(kind, int(rng.integers(2, max_step + 1)),
                                     int(rng.integers(0, 64))))
        events.append(FaultEvent("straggler",
                                 int(rng.integers(9, max_step + 3)),
                                 0, stall_s=stall_s))
        # prefill ordinal 1 = the second prefill of the run: slot 0's very
        # first fill stays clean so the loop always gets off the ground.
        events.append(FaultEvent("prefill_interrupt",
                                 int(rng.integers(1, 3)),
                                 int(rng.integers(0, 64))))
        return cls(events)

    @classmethod
    def crash(cls, seed: int, *, step: int | None = None,
              max_step: int = 14) -> "FaultPlan":
        """A single seeded crash fault: the serve loop dies at an
        arbitrary decode step in [4, max_step] (or exactly ``step`` when
        pinned).  Combine with the smoke schedule via
        :meth:`FaultPlan.merge`."""
        return cls([crash_event(seed, step=step, max_step=max_step)])

    def merge(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(self.events + other.events)

    def record(self) -> list[dict]:
        return [e.record() for e in self.events]


def crash_event(seed: int, *, step: int | None = None,
                max_step: int = 14) -> FaultEvent:
    if step is None:
        step = int(np.random.default_rng(
            np.random.SeedSequence([seed, 0xC4A54])).integers(4,
                                                              max_step + 1))
    return FaultEvent("crash", int(step), 0)


class FaultInjector:
    """Executes a FaultPlan against a live server via the explicit hooks.

    Events whose virtual-clock point has arrived are *consumed* (each
    fires at most once), and everything that fired lands in ``self.fired``
    for the serving summary.  Slot hints resolve deterministically onto an
    occupied slot; an event with no occupied slot to hit is consumed and
    recorded as skipped.
    """

    def __init__(self, plan: FaultPlan, *, sleep=None):
        import time
        self.plan = plan
        self.pending = list(plan.events)
        self.fired: list[dict] = []
        self.prefill_count = 0
        self._sleep = sleep if sleep is not None else time.sleep

    # -- hooks --------------------------------------------------------------

    def prefill_hook(self, slot: int, rid: int) -> None:
        """Called by Server.prefill after the slot reset, before the
        forward; may raise PrefillInterrupt."""
        ordinal = self.prefill_count
        self.prefill_count += 1
        for ev in list(self.pending):
            if ev.kind == "prefill_interrupt" and ev.step == ordinal:
                self.pending.remove(ev)
                self.fired.append({**ev.record(), "slot": slot, "rid": rid})
                raise PrefillInterrupt(
                    f"injected prefill interrupt (request {rid}, "
                    f"slot {slot}, prefill #{ordinal})")

    def apply_decode_faults(self, server, step: int) -> None:
        """Called by Server.decode_step before the forward.  Applies every
        event scheduled at ``step``: corrupts KV, arms the logits-poison
        mask, stalls, and — last, so same-step state faults still land —
        raises KernelDispatchFault.

        A due ``crash`` event preempts everything: a real power cut does
        not let the other faults of the step fire first, so the crash is
        consumed alone (the rest stay pending — a snapshot taken earlier
        carries them into the resumed process) and CrashFault propagates
        out of the serve loop entirely."""
        for ev in list(self.pending):
            if ev.kind == "crash" and ev.step <= step:
                self.pending.remove(ev)
                self.fired.append({**ev.record(), "fired_step": step})
                raise CrashFault(
                    f"injected crash at decode step {step} (scheduled "
                    f"step {ev.step})", step)
        due = [ev for ev in self.pending if ev.kind != "prefill_interrupt"
               and ev.step <= step]
        raise_dispatch = None
        for ev in due:
            self.pending.remove(ev)
            slot = self._resolve_slot(server, ev.slot)
            if slot is None:
                self.fired.append({**ev.record(), "skipped": True})
                continue
            rec = {**ev.record(), "slot": slot, "fired_step": step}
            if ev.kind == "nan_logits":
                server.poison[slot] = True
            elif ev.kind == "kv_corrupt":
                server.corrupt_kv(slot)
            elif ev.kind == "straggler":
                self._sleep(ev.stall_s)
            elif ev.kind == "kernel_dispatch":
                raise_dispatch = ev
            self.fired.append(rec)
        if raise_dispatch is not None:
            raise KernelDispatchFault(
                f"injected kernel-dispatch failure at step {step}")

    def dispatch_hook(self, family: str) -> None:
        """autotune.dispatch-level hook: fail the next kernel launch of a
        family with a pending kernel_dispatch event at step <= 0 (the
        unit-level injection point; the serve loop handles step-scheduled
        dispatch faults itself, as the JAX server does)."""
        for ev in list(self.pending):
            if ev.kind == "kernel_dispatch" and ev.step < 0:
                self.pending.remove(ev)
                self.fired.append({**ev.record(), "family": family})
                raise KernelDispatchFault(
                    f"injected dispatch failure for family '{family}'")

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _resolve_slot(server, hint: int) -> int | None:
        """Deterministically aim a slot hint at an occupied slot."""
        occupied = [s for s in range(server.batch) if server.slot_req[s] >= 0]
        if not occupied:
            return None
        return occupied[hint % len(occupied)]

    def record(self) -> dict:
        return {"schedule": self.plan.record(), "fired": list(self.fired),
                "pending": [e.record() for e in self.pending]}

    # -- crash-tolerance (snapshot payload) ---------------------------------

    def state(self) -> dict:
        """JSON-able injector state for `runtime.snapshot`: which events
        are still pending and how many prefills have run, so a resumed
        process keeps executing the *same* seeded schedule instead of
        restarting it."""
        return {"pending": [e.record() for e in self.pending],
                "fired": list(self.fired),
                "prefill_count": self.prefill_count}

    @classmethod
    def restore(cls, plan: "FaultPlan", state: dict, *,
                resume_step: int = 0, sleep=None) -> "FaultInjector":
        """Rebuild an injector from snapshot state.  Pending ``crash``
        events scheduled at or before ``resume_step`` are dropped — they
        are the fault that killed the previous process (the snapshot
        predates the crash, so the event still looks pending); replaying
        one would crash-loop the recovery.  Every other pending event is
        kept: a fault scheduled inside the replay window is simply
        absorbed again."""
        inj = cls(plan, sleep=sleep)
        inj.pending = [
            ev for ev in (FaultEvent(**{k: r[k] for k in
                                        ("kind", "step", "slot", "stall_s")})
                          for r in state.get("pending", []))
            if not (ev.kind == "crash" and ev.step <= resume_step)]
        inj.fired = list(state.get("fired", []))
        inj.prefill_count = int(state.get("prefill_count", 0))
        return inj
