"""The traffic generator and the closed loop: determinism from the seed,
the same sizes for every seed, the staggered start, the window."""

import numpy as np
import pytest

from bench import traffic

MIX = {"loop": "closed", "clients": 4, "think_s": 0,
       "prompt": {"kind": "uniform", "lo": 512, "hi": 1024},
       "output": {"kind": "uniform", "lo": 8, "hi": 32}}
BIG = 2 ** 31 + 12345


def test_the_seed_draws_the_prompts_and_not_the_lengths():
    a, b = traffic.Plan(MIX, BIG, 1000), traffic.Plan(MIX, BIG, 1000)
    c = traffic.Plan(MIX, BIG + 1, 1000)
    assert np.array_equal(a.prompt(7, 600), b.prompt(7, 600))
    assert not np.array_equal(a.prompt(7, 600), c.prompt(7, 600))
    assert all(0 <= t < 1000 for t in a.prompt(3, 100))
    assert [a.lengths(j) for j in range(50)] == \
        [c.lengths(j) for j in range(50)]


def test_every_window_serves_the_mix():
    """Every stretch of the sequence spreads over the range: the mean of
    any 40 consecutive requests is the range's mean within 2 % (40
    uniform draws would stray by 3 % at one standard deviation)."""
    p = traffic.Plan(MIX, 0, 1000)
    for start in (4, 50, 333):
        prompts, outs = zip(*(p.lengths(j) for j in range(start,
                                                           start + 40)))
        assert abs(np.mean(prompts) - 768) < 0.02 * 768
        assert abs(np.mean(outs) - 20) < 0.05 * 20
        assert min(prompts) >= 512 and max(prompts) <= 1024
        assert min(outs) >= 8 and max(outs) <= 32


def test_first_requests_are_staggered():
    p = traffic.Plan({**MIX, "clients": 8,
                      "output": {"kind": "uniform", "lo": 80, "hi": 80}},
                     3, 100)
    firsts = sorted(p.lengths(j)[1] for j in range(8))
    assert firsts == [5, 15, 25, 35, 45, 55, 65, 75]
    assert p.lengths(8)[1] == 80


class _Req:
    def __init__(self, rid, prompt, out, t):
        self.rid, self.prompt, self.gen_len = rid, prompt, out
        self.submit_t, self.first_token_t, self.finish_t = t, None, None


class _Lc:
    def __init__(self, clock):
        self.requests, self.clock = {}, clock

    def submit(self, rid, prompt, out):
        self.requests[rid] = _Req(rid, prompt, out, self.clock())


def test_closed_loop_keeps_one_request_a_client_and_closes():
    now = [0.0]
    clock = lambda: now[0]  # noqa: E731
    plan = traffic.Plan(MIX, 9, 100)
    src = traffic.ClosedLoop(plan, 10.0, clock=clock)
    lc = _Lc(clock)
    src.pump(lc, 0)
    assert sorted(lc.requests) == [0, 1, 2, 3] and src.t_open is None
    for r in lc.requests.values():
        r.first_token_t = 0.5
    now[0] = 1.0
    src.pump(lc, 1)
    assert (src.t_open, src.t_close) == (1.0, 11.0)
    lc.requests[2].finish_t = 2.0
    now[0] = 2.0
    src.pump(lc, 2)
    assert sorted(lc.requests) == [0, 1, 2, 3, 6]       # client 2's next
    assert not src.exhausted() and src.next_arrival_step(lc, 2) == 3
    now[0] = 11.0
    with pytest.raises(traffic.WindowClosed):
        src.pump(lc, 3)
