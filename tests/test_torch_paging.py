"""`repro_torch.runtime.paging` and `repro_torch.launch.scheduler` against
the JAX package's `repro.runtime.paging` and `repro.launch.scheduler`.

Both are host code over numpy, so every observable must be equal, not
close: page tables, free lists, utilization blocks, the pages `adopt`
rebuilds, the `PageOOM` raised, and the sequence of requests each
admission policy picks (tolerance 0).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.launch import scheduler as jsched  # noqa: E402
from repro.runtime import lifecycle as jlife  # noqa: E402
from repro.runtime import paging as jpaging  # noqa: E402
from repro_torch.launch import scheduler as tsched  # noqa: E402
from repro_torch.runtime import lifecycle as tlife  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402


def _state(a):
    return (a.table.tolist(), a.free_pages, a.allocated_pages,
            a.reserved_pages, a.utilization(), sorted(a._free))


def _apply(a, op):
    kind, *args = op
    try:
        if kind == "ensure":
            return ("grew", a.ensure(*args))
        if kind == "free":
            return ("freed", a.free_slot(*args))
        if kind == "reserve":
            return ("reserved", a.reserve(*args))
        return ("released", a.release_reservation(*args))
    except (jpaging.PageOOM, tpaging.PageOOM) as e:
        return ("oom", str(e), e.slot, e.rid)


def _trace(seed, batch, n_ops):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        slot = int(rng.integers(batch))
        rid = int(rng.integers(6))
        r = rng.random()
        if r < 0.55:
            ops.append(("ensure", slot, int(rng.integers(0, 40)), rid))
        elif r < 0.75:
            ops.append(("free", slot, rid))
        elif r < 0.9:
            ops.append(("reserve", rid, int(rng.integers(1, 30))))
        else:
            ops.append(("release", rid))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("page_size, pool", [(4, 0), (3, 11), (16, 5)])
def test_seeded_trace_keeps_equal_state(seed, page_size, pool):
    batch, max_len = 3, 40
    js = jpaging.PageSpec.build(batch, max_len, page_size, pool_pages=pool)
    ts = tpaging.PageSpec.build(batch, max_len, page_size, pool_pages=pool)
    assert (ts.page_size, ts.num_pages, ts.max_pages) == (
        js.page_size, js.num_pages, js.max_pages)
    ja, ta = jpaging.PageAllocator(js, batch), tpaging.PageAllocator(ts,
                                                                   batch)
    for op in _trace(seed, batch, 120):
        assert _apply(ta, op) == _apply(ja, op), op
        assert _state(ta) == _state(ja), op
        ta.check_conserved()
    assert ts.pages_for(17) == js.pages_for(17)
    assert ta.can_admit(9) == ja.can_admit(9)
    assert ta.fits_pool(10 ** 4) == ja.fits_pool(10 ** 4)


def test_adopt_and_oom_match():
    spec_j = jpaging.PageSpec(page_size=4, num_pages=6, max_pages=4)
    spec_t = tpaging.PageSpec(page_size=4, num_pages=6, max_pages=4)
    table = np.array([[5, 1, -1, -1], [-1, -1, -1, -1], [0, 3, 2, -1]],
                     np.int32)
    ja = jpaging.PageAllocator.adopt(spec_j, table)
    ta = tpaging.PageAllocator.adopt(spec_t, table)
    assert _state(ta) == _state(ja)
    assert _apply(ta, ("ensure", 1, 16, 7)) == _apply(ja, ("ensure", 1, 16,
                                                           7))
    assert _apply(ta, ("ensure", 1, 17, 7)) == _apply(ja, ("ensure", 1, 17,
                                                           7))
    oom = _apply(ta, ("ensure", 0, 200, 3))
    assert oom[0] == "oom" and oom == _apply(ja, ("ensure", 0, 200, 3))
    bad = np.array([[1, -1, -1, -1], [1, -1, -1, -1], [-1] * 4], np.int32)
    with pytest.raises(ValueError, match="assigns page 1"):
        tpaging.PageAllocator.adopt(spec_t, bad)
    with pytest.raises(ValueError):
        tpaging.PageSpec(page_size=0, num_pages=1, max_pages=1)


# (prompt_len, gen) per request: small, large, one too large for any pool
REQUESTS = [(12, 6), (40, 20), (5, 3), (70, 40), (8, 8), (30, 2), (3, 30)]


def _admission_run(mod_life, mod_sched, mod_paging, policy, pool):
    """Admit into 3 slots until nothing fits, free the oldest slot, repeat:
    the sequence of (step, picked rid) and the final counters."""
    lc = mod_life.Lifecycle(clock=lambda: 0.0)
    for rid, (plen, gen) in enumerate(REQUESTS):
        lc.submit(rid, np.zeros(plen, np.int32), gen)
    alloc = None
    if pool is not None:
        spec = mod_paging.PageSpec(page_size=8, num_pages=pool, max_pages=14)
        alloc = mod_paging.PageAllocator(spec, 3)
    sched = mod_sched.Scheduler(policy, allocator=alloc)
    slots, picks = [None] * 3, []
    for step in range(40):
        for s in range(3):
            if slots[s] is None:
                req = sched.pop_ready(lc, step)
                if req is None:
                    break
                slots[s] = req.rid
                picks.append((step, req.rid))
                if alloc is not None:
                    alloc.ensure(s, len(req.prompt), rid=req.rid)
        busy = [s for s in range(3) if slots[s] is not None]
        if not busy and not lc.eligible(step):
            break
        if busy:
            s = busy[0]
            if alloc is not None:
                alloc.free_slot(s, rid=slots[s])
            slots[s] = None
    return (picks, sched.rejected_oversize,
            [r.state.name for r in lc.requests.values()],
            None if alloc is None else _state(alloc))


@pytest.mark.parametrize("pool", [None, 20, 9])
@pytest.mark.parametrize("policy", ["fcfs", "spf", "paged-aware"])
def test_scheduler_picks_the_same_requests(policy, pool):
    want = _admission_run(jlife, jsched, jpaging, policy, pool)
    got = _admission_run(tlife, tsched, tpaging, policy, pool)
    assert got == want
    if pool == 9:                       # 110 tokens need 14 pages of 8 > 9
        assert got[1] >= 1 and "REJECTED" in got[2]


def test_unknown_policy_raises():
    assert tsched.POLICIES == jsched.POLICIES
    with pytest.raises(ValueError, match="unknown policy"):
        tsched.Scheduler("lifo")
