"""Pluggable admission scheduling over the `Lifecycle` queue.
Counterpart of `repro.launch.scheduler`.

``serve --sched fcfs|spf|paged-aware`` picks which eligible queued request
fills an idle slot next.  With a paged KV cache the scheduler is also the
backpressure valve: a request is admitted only when the
:class:`~repro_torch.runtime.paging.PageAllocator` can cover its predicted
footprint (``pages_for(prompt + gen)``), which is reserved at admission
and consumed as the slot grows, so a full pool shows as queued requests,
never as a failure in the middle of decoding.

Policies (deterministic; ties broken by rid):

- ``fcfs``: arrival order among the backoff-eligible requests; if the head
  does not fit the pool, nothing is admitted.
- ``spf``: shortest predicted footprint (``prompt + gen``) first.
- ``paged-aware``: arrival order, first fit: requests the pool cannot
  cover now are passed over for the first one it can.

A request whose footprint exceeds what an empty pool could hold is
rejected (QUEUED -> REJECTED) instead of queueing forever.
"""

from __future__ import annotations

from repro_torch.runtime.lifecycle import Lifecycle, Request
from repro_torch.runtime.paging import PageAllocator

POLICIES = ("fcfs", "spf", "paged-aware")


class Scheduler:
    """Admission policy over ``Lifecycle.eligible``; pool-aware when an
    allocator is attached, plain request ordering when not."""

    def __init__(self, policy: str = "fcfs",
                 allocator: PageAllocator | None = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {POLICIES}")
        self.policy = policy
        self.allocator = allocator
        self.rejected_oversize = 0

    @staticmethod
    def footprint_tokens(req: Request) -> int:
        """Predicted resident KV tokens at completion: the prompt plus one
        cache entry per generated token."""
        return int(len(req.prompt)) + int(req.gen_len)

    def _fits_now(self, req: Request) -> bool:
        return self.allocator is None or \
            self.allocator.can_admit(self.footprint_tokens(req))

    def pop_ready(self, lc: Lifecycle, step: int) -> Request | None:
        """Admit (and reserve pool pages for) the next request, or None
        when nothing eligible fits.  Drop-in for ``Lifecycle.pop_ready``."""
        candidates = lc.eligible(step)
        if self.allocator is not None:
            for req in list(candidates):
                if not self.allocator.fits_pool(self.footprint_tokens(req)):
                    lc.reject(req, step)
                    self.rejected_oversize += 1
                    candidates.remove(req)
        if not candidates:
            return None

        if self.policy == "spf":
            candidates.sort(key=lambda r: (self.footprint_tokens(r), r.rid))
            pick = candidates[0] if self._fits_now(candidates[0]) else None
        elif self.policy == "paged-aware":
            pick = next((r for r in candidates if self._fits_now(r)), None)
        else:                               # fcfs: head of line or nothing
            pick = candidates[0] if self._fits_now(candidates[0]) else None
        if pick is None:
            return None

        lc.take(pick)
        if self.allocator is not None:
            self.allocator.reserve(pick.rid, self.footprint_tokens(pick))
        return pick
