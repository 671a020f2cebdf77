"""Paged KV-cache allocation, on the host (numpy and the standard library
only).  Counterpart of `repro.runtime.paging`, kept as the port's own copy.

A fixed pool of ``num_pages`` KV pages of ``page_size`` tokens each is
shared by every slot and every layer (one physical page index is the same
pool row in every layer's K and V pool), and a per-slot page table maps a
slot's logical page to its physical page.

- **Canonical allocation order.**  The free list is a min-heap, so the
  lowest free page is always handed out next, and the allocator's whole
  state is a function of the page table (:meth:`PageAllocator.adopt`).
- **Reservations price admission.**  The scheduler reserves a request's
  predicted footprint (``pages_for(prompt + gen)``) when it admits it, and
  `ensure` consumes the pledge page by page as the slot grows, so
  ``can_admit`` never promises pages already pledged.  :class:`PageOOM`
  is the loud guard for an overcommitted pool.
- **Frees are idempotent** and the pool is conserved:
  ``free + allocated == num_pages`` always.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

__all__ = ["PageSpec", "PageAllocator", "PageOOM"]


class PageOOM(RuntimeError):
    """The pool has no free page for a required allocation.

    Carries ``slot`` and ``rid`` so the serve loop can turn the failure
    into scheduler backpressure (evict / requeue) instead of a crash.
    """

    def __init__(self, msg: str, *, slot: int = -1, rid: int = -1):
        super().__init__(msg)
        self.slot = slot
        self.rid = rid


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Static shape of a paged KV pool (passed beside the cache, never
    stored in it: it fixes the cache's layout)."""

    page_size: int     # tokens per page
    num_pages: int     # physical pages in the pool (shared by all layers)
    max_pages: int     # page-table width = ceil(max_len / page_size)

    def __post_init__(self):
        if self.page_size < 1 or self.num_pages < 1 or self.max_pages < 1:
            raise ValueError(f"invalid PageSpec {self!r}")

    @staticmethod
    def build(batch: int, max_len: int, page_size: int,
              pool_pages: int = 0) -> "PageSpec":
        """Spec for a ``batch x max_len`` serving cache.  ``pool_pages=0``
        sizes the pool contiguous-equivalent (batch * per-slot worst
        case); smaller pools are how paging beats contiguous at the same
        KV-memory budget."""
        max_pages = -(-max_len // page_size)
        return PageSpec(page_size=page_size,
                        num_pages=pool_pages or batch * max_pages,
                        max_pages=max_pages)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` resident KV entries."""
        return max(0, -(-int(n_tokens) // self.page_size))


class PageAllocator:
    """Host-side truth for the paged pool: per-slot page table, min-heap
    free list, per-request footprint reservations."""

    def __init__(self, spec: PageSpec, batch: int):
        self.spec = spec
        self.batch = batch
        self.table = np.full((batch, spec.max_pages), -1, dtype=np.int32)
        # owner[page] = slot holding it, -1 if free (the double-assign guard)
        self._owner = np.full(spec.num_pages, -1, dtype=np.int32)
        self._free = list(range(spec.num_pages))
        heapq.heapify(self._free)
        self._reserved: dict[int, int] = {}     # rid -> pages still pledged
        # tokens each slot has asked `ensure` to cover — the numerator of
        # the pages-vs-tokens utilization the serve summary reports
        self._tokens = np.zeros(batch, dtype=np.int64)

    # -- queries ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self.spec.num_pages - len(self._free)

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved.values())

    def slot_pages(self, slot: int) -> int:
        return int((self.table[slot] >= 0).sum())

    def pages_for(self, n_tokens: int) -> int:
        return self.spec.pages_for(n_tokens)

    def can_admit(self, n_tokens: int) -> bool:
        """True if the pool can cover ``n_tokens`` on top of every page
        already pledged to in-flight requests."""
        return (self.free_pages - self.reserved_pages
                >= self.pages_for(n_tokens))

    def fits_pool(self, n_tokens: int) -> bool:
        """True if ``n_tokens`` could *ever* fit (an empty pool would
        cover it); False means reject loudly, not queue forever."""
        return self.pages_for(n_tokens) <= self.spec.num_pages

    def utilization(self, tokens_resident: int | None = None) -> dict:
        """Pages allocated vs tokens actually resident in them — the
        KV-memory utilization block the serve summary reports.  With no
        explicit ``tokens_resident`` the allocator's own per-slot ensure
        bookkeeping is the numerator."""
        if tokens_resident is None:
            tokens_resident = int(self._tokens.sum())
        cap = self.allocated_pages * self.spec.page_size
        return {
            "page_size": self.spec.page_size,
            "num_pages": self.spec.num_pages,
            "pages_allocated": self.allocated_pages,
            "pages_free": self.free_pages,
            "pages_reserved": self.reserved_pages,
            "tokens_resident": int(tokens_resident),
            "token_capacity": cap,
            "utilization": (tokens_resident / cap) if cap else 1.0,
        }

    # -- reservations (admission pricing) -----------------------------------

    def reserve(self, rid: int, n_tokens: int) -> None:
        self._reserved[rid] = self._reserved.get(rid, 0) \
            + self.pages_for(n_tokens)

    def release_reservation(self, rid: int) -> None:
        self._reserved.pop(rid, None)

    # -- alloc / free -------------------------------------------------------

    def ensure(self, slot: int, n_tokens: int, rid: int = -1) -> bool:
        """Grow ``slot``'s page table until it covers ``n_tokens``.
        Returns True if any page was assigned (the device table needs a
        refresh).  Raises :class:`PageOOM` when the pool is exhausted —
        the caller turns that into backpressure, never a crash."""
        have = self.slot_pages(slot)
        need = self.pages_for(n_tokens)
        if need > self.spec.max_pages:
            raise PageOOM(
                f"slot {slot}: {n_tokens} tokens need {need} pages > "
                f"page-table width {self.spec.max_pages}",
                slot=slot, rid=rid)
        grew = False
        while have < need:
            if not self._free:
                raise PageOOM(
                    f"slot {slot} (rid {rid}): pool exhausted growing to "
                    f"{need} pages ({self.allocated_pages}/"
                    f"{self.spec.num_pages} allocated, "
                    f"{self.reserved_pages} reserved)",
                    slot=slot, rid=rid)
            page = heapq.heappop(self._free)
            if self._owner[page] != -1:      # pragma: no cover - invariant
                raise AssertionError(f"page {page} double-assigned")
            self.table[slot, have] = page
            self._owner[page] = slot
            have += 1
            grew = True
            if rid in self._reserved:        # consume the pledge as it lands
                left = self._reserved[rid] - 1
                if left > 0:
                    self._reserved[rid] = left
                else:
                    del self._reserved[rid]
        self._tokens[slot] = max(int(self._tokens[slot]), int(n_tokens))
        return grew

    def free_slot(self, slot: int, rid: int = -1) -> bool:
        """Return every page of ``slot`` to the pool (idempotent) and
        drop ``rid``'s outstanding reservation.  True if anything was
        actually freed."""
        if rid != -1:
            self.release_reservation(rid)
        self._tokens[slot] = 0
        pages = self.table[slot]
        freed = False
        for i in range(self.spec.max_pages):
            page = int(pages[i])
            if page < 0:
                continue
            self._owner[page] = -1
            heapq.heappush(self._free, page)
            pages[i] = -1
            freed = True
        return freed

    # -- invariants / recovery ----------------------------------------------

    def check_conserved(self) -> None:
        """free + allocated == pool, table and owner agree, no page in
        two slots.  Raises AssertionError on violation."""
        allocated = self.table[self.table >= 0]
        assert len(set(allocated.tolist())) == allocated.size, \
            "a page appears in two page-table entries"
        assert allocated.size + len(self._free) == self.spec.num_pages, \
            (f"pool leak: {allocated.size} allocated + {len(self._free)} "
             f"free != {self.spec.num_pages}")
        assert set(allocated.tolist()) | set(self._free) \
            == set(range(self.spec.num_pages))
        for slot in range(self.batch):
            row = self.table[slot]
            held = row[row >= 0]
            assert (self._owner[held] == slot).all(), \
                f"owner map disagrees with page table for slot {slot}"

    @classmethod
    def adopt(cls, spec: PageSpec, table: np.ndarray) -> "PageAllocator":
        """Rebuild an allocator from a restored page table (crash
        recovery).  Because allocation order is canonical (min-heap),
        the rebuilt free list is exactly the one the dead process had;
        reservations are re-created by the scheduler for whatever is
        still queued."""
        table = np.asarray(table, dtype=np.int32)
        alloc = cls(spec, table.shape[0])
        alloc.table[...] = table
        alloc._owner[...] = -1
        for slot in range(table.shape[0]):
            for page in table[slot]:
                if page >= 0:
                    if alloc._owner[page] != -1:
                        raise ValueError(
                            f"restored page table assigns page {page} to "
                            f"slots {alloc._owner[page]} and {slot}")
                    alloc._owner[page] = slot
        alloc._free = [p for p in range(spec.num_pages)
                       if alloc._owner[p] == -1]
        heapq.heapify(alloc._free)
        alloc.check_conserved()
        return alloc
