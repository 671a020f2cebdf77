"""The port's chaos harness against the JAX package's: `runtime/faults.py`
(seeded schedules, the injector and its snapshot state), the
``kv_corrupt`` fault (`transformer.cache_poison_slot`), the dispatch hook
of `kernels.autotune.dispatch`, and `launch.serve.serve_loop` under the
smoke schedule, whose outcome trace and ``fired`` record must equal the
JAX server's for the same fault seed.

The port has no plain path on a CUDA tensor, so an injected
``kernel_dispatch`` fault re-plans the decode kernel and runs the step
again on it where the JAX server falls back to its jnp path
(`launch/serve.py`'s docstring); both keep the tokens, so the outcome
traces stay equal.  Schedules, records and outcome traces are integers
and strings, compared with ``==``; caches after a poisoning are compared
bit for bit, NaN included.

The JAX server copies its poison mask to the device without waiting for
the step that reads it, and clears it right after (ROADMAP queue C: on
the CPU, JAX may alias the numpy buffer).  So the JAX side here waits for
each of its steps before the mask is cleared (`_blocking`); nothing of
the JAX package changes.
"""

import io
import json
import pathlib
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.runtime import faults as jfaults  # noqa: E402
from repro.runtime import paging as jpaging  # noqa: E402
from repro.runtime.lifecycle import Lifecycle as JLifecycle  # noqa: E402

from repro_torch.convert import (cache_from_numpy, disable_tf32,  # noqa: E402
                                 params_from_numpy)
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.runtime import faults, paging  # noqa: E402
from repro_torch.runtime.lifecycle import Lifecycle as TLifecycle  # noqa: E402
from repro_torch.runtime.lifecycle import State  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import check_serve  # noqa: E402

MAX_LEN = 28


@pytest.fixture(autouse=True)
def _setup(monkeypatch, tmp_path):
    disable_tf32()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "j.json"))


def _cfgs():
    base = dict(name="tiny-chaos", family="dense", num_layers=2, d_model=32,
                d_ff=64, vocab_size=101, num_heads=4, num_kv_heads=2)
    return JConfig(**base), TConfig(**base)


def _requests(vocab, spec):
    return [(rid, np.asarray(jax.random.randint(
                jax.random.PRNGKey(100 + rid), (plen,), 0, vocab), np.int32),
             gen) for rid, (plen, gen) in enumerate(spec)]


def _block(fn):
    return lambda *a: jax.block_until_ready(fn(*a))


def _blocking(server):
    """Wait for each JAX step before the server clears its poison mask."""
    server.serve_step = _block(server.serve_step)
    ref_step = server._ref_step
    server._ref_step = lambda: _block(ref_step())
    return server


def _servers(batch, *, paged=False, int8=False, plans=(None, None),
             page_size=4):
    """A JAX and a port server with the same weights and cache layout
    (pages of ``page_size`` tokens when paged), each with its own
    injector."""
    jcfg, tcfg = _cfgs()
    jspec = tspec = None
    if paged:
        jspec = jpaging.PageSpec.build(batch, MAX_LEN, page_size)
        tspec = paging.PageSpec.build(batch, MAX_LEN, page_size)
    jinj, tinj = plans
    js = _blocking(jserve.Server(
        jcfg, batch, MAX_LEN, autotune_kernels=False, paged=jspec,
        kv_dtype=jnp.int8 if int8 else jnp.float32,
        injector=(jfaults.FaultInjector(jinj, sleep=lambda s: None)
                  if jinj is not None else None)))
    ts = tserve.Server(
        tcfg, batch, MAX_LEN, device="cpu", autotune_kernels=False,
        params=params_from_numpy(jax.tree.map(np.asarray, js.params)),
        paged=tspec, kv_dtype=torch.int8 if int8 else torch.float32,
        injector=(faults.FaultInjector(tinj, sleep=lambda s: None)
                  if tinj is not None else None))
    return js, ts


def _loop(server, pkg, Lc, reqs, max_retries=2):
    lc = Lc(max_retries=max_retries, clock=lambda: 0.0)
    for rid, prompt, gen in reqs:
        lc.submit(rid, prompt, gen)
    stats = pkg.serve_loop(server, lc, max_steps=500)
    return lc, stats


def _tokens(lc):
    return {rid: list(r.tokens) for rid, r in lc.requests.items()}


# -- schedules and the injector -----------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_fault_plans_equal_the_reference(seed):
    assert faults.FaultPlan.smoke(seed).record() == \
        jfaults.FaultPlan.smoke(seed).record()
    for step in (None, 5):
        assert faults.FaultPlan.crash(seed, step=step).record() == \
            jfaults.FaultPlan.crash(seed, step=step).record()
    merged = faults.FaultPlan.smoke(seed).merge(faults.FaultPlan.crash(seed))
    assert merged.record() == jfaults.FaultPlan.smoke(seed).merge(
        jfaults.FaultPlan.crash(seed)).record()
    assert faults.SMOKE_FAULT_CLASSES == jfaults.SMOKE_FAULT_CLASSES
    assert faults.FAULT_CLASSES == jfaults.FAULT_CLASSES


class _FakeServer:
    """The surface the injector touches: ``batch``, ``slot_req``,
    ``poison`` and ``corrupt_kv``."""

    def __init__(self, occupied):
        self.batch = 4
        self.slot_req = np.asarray([r if o else -1 for r, o in
                                    zip(range(4), occupied)], np.int32)
        self.poison = np.zeros(4, bool)
        self.corrupted = []

    def corrupt_kv(self, slot):
        self.corrupted.append(slot)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_injector_fires_and_restores_like_the_reference(seed):
    """The same hook calls on both injectors (prefills, then decode steps
    over a batch that empties and refills, a crash merged in) fire the
    same events at the same slots, raise the same faults, and leave the
    same snapshot state, from which both restore alike."""
    plan = faults.FaultPlan.smoke(seed).merge(faults.FaultPlan.crash(seed))
    jplan = jfaults.FaultPlan.smoke(seed).merge(jfaults.FaultPlan.crash(seed))
    runs = []
    for mod, p in ((faults, plan), (jfaults, jplan)):
        inj = mod.FaultInjector(p, sleep=lambda s: None)
        events = []
        for slot in range(4):
            try:
                inj.prefill_hook(slot, slot)
            except mod.PrefillInterrupt:
                events.append(("interrupt", slot))
        for step in range(16):
            server = _FakeServer([step % 5 != 0, True, step % 3 == 0,
                                  step > 6])
            try:
                inj.apply_decode_faults(server, step)
            except mod.KernelDispatchFault:
                events.append(("dispatch", step))
            except mod.CrashFault as cf:
                events.append(("crash", cf.step))
            events.append((step, server.poison.tolist(), server.corrupted))
        state = inj.state()
        restored = mod.FaultInjector.restore(p, state, resume_step=9)
        runs.append((events, inj.record(), state, restored.state()))
    assert runs[0] == runs[1]


def test_dispatch_hook_fails_the_launch_and_poisons_the_plan(monkeypatch):
    """`install_dispatch_hook`: `dispatch` consults the hook before the
    launch; an injected failure poisons the plan and propagates (no plain
    fallback on a card), and the event fires once."""
    real_tune = autotune.tune
    monkeypatch.setattr(autotune, "_device_of",
                        lambda args: torch.device("cuda"))
    monkeypatch.setattr(autotune, "tune", lambda spec, problem, dtype, *,
                        device, cache: real_tune(spec, problem, dtype,
                                                 device="cpu", cache=cache))
    inj = faults.FaultInjector(faults.FaultPlan(
        [faults.FaultEvent("kernel_dispatch", -1, 0)]))
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    autotune.install_dispatch_hook(inj.dispatch_hook)
    try:
        with pytest.raises(faults.KernelDispatchFault, match="matmul"):
            autotune.dispatch("matmul", a, b)
        entries = autotune.get_cache()._load()["entries"]
        assert [e["poisoned"] for e in entries.values()] == [True]
        assert inj.record()["fired"] == [{"kind": "kernel_dispatch",
                                          "step": -1, "slot": 0,
                                          "stall_s": 0.0,
                                          "family": "matmul"}]
        torch.testing.assert_close(autotune.dispatch("matmul", a, b),
                                   a @ b)
    finally:
        autotune.install_dispatch_hook(None)


# -- kv_corrupt: cache_poison_slot --------------------------------------------

def _filled(jcfg, batch, *, paged=None, int8=False, seed=0):
    cache = jtf.cache_init(jcfg, batch, MAX_LEN,
                           dtype=jnp.int8 if int8 else jnp.float32,
                           paged=paged)
    rng = np.random.default_rng(seed)
    blocks = {k: (rng.integers(-127, 128, a.shape).astype(np.int8)
                  if a.dtype == jnp.int8
                  else rng.standard_normal(a.shape).astype(np.float32))
              for k, a in cache["blocks"].items()}
    cache = {**cache, "blocks": {k: jnp.asarray(v) for k, v in
                                 blocks.items()}}
    if paged is not None:
        table = -np.ones((batch, paged.max_pages), np.int32)
        table[0, :3] = [5, 1, 6]
        table[1, :2] = [2, 3]
        table[2, :1] = [0]
        cache["pages"] = jnp.asarray(table)
    return cache


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_poison_slot_equals_the_reference(paged, int8):
    """NaN over the slot's float leaves only (the f32 K/V, or the int8
    layout's scales), in the slot's rows or its pool pages; the codes,
    lengths and page table untouched.  Bitwise equal to JAX's, NaN
    included."""
    jcfg, tcfg = _cfgs()
    spec = paged and jpaging.PageSpec.build(3, MAX_LEN, 4, 9)
    tspec = paged and paging.PageSpec.build(3, MAX_LEN, 4, 9)
    jc = _filled(jcfg, 3, paged=spec or None, int8=int8)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc))
    for slot in (1, 0):                  # slot 2 holds page 0: see below
        jc = jtf.cache_poison_slot(jc, slot, paged=spec or None)
        out = ttf.cache_poison_slot(tc, slot, paged=tspec or None)
        assert out is tc
        for k, a in jc["blocks"].items():
            np.testing.assert_array_equal(tc["blocks"][k].numpy(),
                                          np.asarray(a))
        assert bool(torch.isnan(tc["blocks"]["k" if not int8
                                             else "k_scale"]).any())
        for k in ("lengths", "index", "pages"):
            if k in jc:
                np.testing.assert_array_equal(tc[k].numpy(),
                                              np.asarray(jc[k]))
    if int8:
        assert not any(t.is_floating_point() and torch.isnan(t).any()
                       for k, t in tc["blocks"].items() if k in ("k", "v"))


def test_reference_page_mask_drops_page_0():
    """A fault of the reference (ROADMAP queue C): JAX's
    `_slot_page_mask` clips a table row's -1 entries to page 0 and
    scatters their False over the row's own True, so a slot holding page
    0 and fewer pages than its row has entries is neither poisoned nor
    zeroed there.  The port poisons and zeroes every page the row
    names."""
    jcfg, tcfg = _cfgs()
    spec = jpaging.PageSpec.build(3, MAX_LEN, 4, 9)
    tspec = paging.PageSpec.build(3, MAX_LEN, 4, 9)
    jc = _filled(jcfg, 3, paged=spec)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc))
    jk = np.asarray(jtf.cache_poison_slot(jc, 2, paged=spec)["blocks"]["k"])
    ttf.cache_poison_slot(tc, 2, paged=tspec)
    assert not np.isnan(jk[:, 0]).any()
    assert bool(torch.isnan(tc["blocks"]["k"][:, 0]).all())
    jz = np.asarray(jtf.cache_reset_slot(jc, 2, paged=spec)["blocks"]["v"])
    ttf.cache_reset_slot(tc, 2, paged=tspec)
    assert np.abs(jz[:, 0]).max() > 0
    assert not bool(tc["blocks"]["v"][:, 0].any())


def test_cache_poison_slot_never_touches_the_trash_page():
    """Entries of -1 in a slot's table name no page: the trash page past
    the pool, where other slots' masked writes land, keeps its bytes."""
    _, tcfg = _cfgs()
    spec = paging.PageSpec.build(2, MAX_LEN, 4, 6)
    cache = ttf.cache_init(tcfg, 2, MAX_LEN, dtype=torch.float32,
                           device="cpu", paged=spec)
    for a in cache["blocks"].values():
        layers.with_trash_page(a, axis=1)[:, spec.num_pages] = 7.0
    cache["pages"][0, :2] = torch.tensor([4, 2])
    ttf.cache_poison_slot(cache, 0, paged=spec)
    for a in cache["blocks"].values():
        full = layers.with_trash_page(a, axis=1)
        assert bool((full[:, spec.num_pages] == 7.0).all())
        assert bool(torch.isnan(a[:, [4, 2]]).all())
        assert not bool(torch.isnan(a[:, [0, 1, 3, 5]]).any())


# -- the serve loop under the smoke schedule ----------------------------------

CHAOS_SPEC = [(5, 10), (4, 10), (6, 10), (3, 10), (5, 10), (4, 10)]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_smoke_schedule_outcomes_equal_the_jax_serve_loop(seed, paged):
    """The whole loop at batch 2 under ``FaultPlan.smoke(seed)``: the
    per-request final states and retries, the ``fired`` and pending
    records, the counters and the generated tokens equal the JAX
    loop's.  The dispatch fault is a fallback there and a re-plan here.

    Paged, the pages hold 2 tokens, so every slot holds at least two
    pages when a fault lands (prompts of 3 or more tokens): a slot whose
    only page is page 0 would meet the reference's page-mask fault
    (`test_reference_page_mask_drops_page_0`), which would leave its
    ``kv_corrupt`` without effect in the JAX run."""
    jcfg, _ = _cfgs()
    reqs = _requests(jcfg.vocab_size, CHAOS_SPEC)
    js, ts = _servers(2, paged=paged, page_size=2,
                      plans=(jfaults.FaultPlan.smoke(seed),
                             faults.FaultPlan.smoke(seed)))
    jlc, jstats = _loop(js, jserve, JLifecycle, reqs)
    tlc, tstats = _loop(ts, tserve, TLifecycle, reqs)
    assert tlc.outcome_trace() == jlc.outcome_trace()
    assert ts.injector.record() == js.injector.record()
    assert tlc.counters() == jlc.counters()
    fired = {e["kind"] for e in ts.injector.record()["fired"]
             if not e.get("skipped")}
    assert fired == set(faults.SMOKE_FAULT_CLASSES)
    assert jstats["kernel_fallbacks"] == tstats["kernel_replans"] == 1
    assert tstats["kernel_fallbacks"] == 0
    for key in ("generated", "steps", "max_concurrent"):
        assert tstats[key] == jstats[key], key
    assert tlc.counters()["evicted"] >= 2 and tlc.conserved()
    if paged:
        assert ts.allocator.allocated_pages == 0


def test_dispatch_fault_replans_with_the_fault_free_tokens(tmp_path):
    """A kernel-dispatch fault mid-run on a server with tuned plans: the
    step runs again after the re-plan, no request is evicted, every token
    equals the fault-free run's, the poisoned plan is tuned afresh and
    the cache decodes at the re-planned span."""
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size, [(5, 8), (7, 8)])

    def run(plan):
        server = tserve.Server(
            tcfg, 2, MAX_LEN, device="cpu", prefill_len=7,
            slot_lengths=[9, 13],
            injector=faults.FaultInjector(plan) if plan else None)
        lc, stats = _loop(server, tserve, TLifecycle, reqs)
        return server, lc, stats

    _, base, base_stats = run(None)
    server, lc, stats = run(faults.FaultPlan(
        [faults.FaultEvent("kernel_dispatch", 4, 0)]))
    assert stats["kernel_replans"] == 1 and base_stats["kernel_replans"] == 0
    assert stats["kernel_fallbacks"] == 0
    assert lc.counters()["evicted"] == 0
    assert _tokens(lc) == _tokens(base)
    dp = next(p for p in server.kernel_plan if p.op == "attn_decode")
    entry = autotune.get_cache()._load()["entries"][dp.plan.key]
    assert not entry.get("poisoned")
    assert server.cache["decode_span"] == server.decode_span == \
        dp.plan.knobs["block_k"]


def test_dispatch_fault_keeps_the_logits_poison_armed_at_its_step():
    """A ``nan_logits`` and a ``kernel_dispatch`` at one step: the re-run
    step still quarantines the poisoned slot, as the JAX fallback does."""
    jcfg, _ = _cfgs()
    reqs = _requests(jcfg.vocab_size, [(5, 8), (7, 8)])
    events = [("nan_logits", 3, 1), ("kernel_dispatch", 3, 0)]
    js, ts = _servers(2, plans=(
        jfaults.FaultPlan([jfaults.FaultEvent(*e) for e in events]),
        faults.FaultPlan([faults.FaultEvent(*e) for e in events])))
    jlc, _ = _loop(js, jserve, JLifecycle, reqs)
    tlc, stats = _loop(ts, tserve, TLifecycle, reqs)
    assert stats["kernel_replans"] == 1
    assert tlc.counters()["evicted"] == 1
    assert tlc.outcome_trace() == jlc.outcome_trace()


@pytest.mark.parametrize("kind", ["kv_corrupt", "nan_logits",
                                  "prefill_interrupt"])
def test_retried_request_equals_its_solo_run(kind):
    """A request quarantined by the fault and retried from a zeroed slot
    reproduces its solo decode token for token, and its neighbours keep
    their fault-free tokens."""
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size, [(5, 7), (9, 6), (3, 8)])
    step = 0 if kind == "prefill_interrupt" else 2
    plan = faults.FaultPlan([faults.FaultEvent(kind, step, 1)])
    js, ts = _servers(2, plans=(None, plan))
    lc, _ = _loop(ts, tserve, TLifecycle, reqs)
    assert lc.counters()["evicted"] == 1 and lc.counters()["completed"] == 3
    retried = [r.rid for r in lc.requests.values() if r.retries == 1]
    assert len(retried) == 1
    for rid, prompt, gen in reqs:
        _, solo = _servers(1)
        slc, _ = _loop(solo, tserve, TLifecycle, [(rid, prompt, gen)])
        assert _tokens(lc)[rid] == _tokens(slc)[rid], rid


def test_no_retry_budget_fails_cleanly():
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size, [(5, 8), (7, 8)])
    _, ts = _servers(2, plans=(None, faults.FaultPlan(
        [faults.FaultEvent("kv_corrupt", 3, 0)])))
    lc, _ = _loop(ts, tserve, TLifecycle, reqs, max_retries=0)
    c = lc.counters()
    assert c["completed"] == 1 and c["failed"] == 1 and c["retried"] == 0
    assert lc.conserved()
    assert {r.state for r in lc.requests.values()} == {State.COMPLETED,
                                                       State.FAILED}


def test_chaos_disables_chunked_prefill():
    _, ts = _servers(2, plans=(None, faults.FaultPlan([])))
    _, clean = _servers(2)
    assert not ts.can_chunk() and clean.can_chunk()


@pytest.mark.parametrize("flags", [
    [],
    ["--paged", "--page-size", "4", "--kv-dtype", "int8", "--sched", "spf"],
])
@pytest.mark.parametrize("seed", ["0", "1"])
def test_cli_chaos_passes_check_serve(flags, seed):
    """``serve --chaos`` on the CPU: the log passes ``check_serve.py
    --chaos`` (every scheduled class fired, no request failed), with one
    re-plan and no fallback."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = tserve.main(["--smoke", "--device", "cpu", "--batch", "2",
                          "--requests", "6", "--prompt-len", "8", "--gen",
                          "10", "--chaos", "--fault-seed", seed, *flags])
    log = buf.getvalue()
    assert rc == 0
    assert check_serve.check(log, requests=6, chaos=True) == []
    summary = check_serve._json_lines(log)[-1]
    assert summary["kernel_replans"] == 1
    assert summary["kernel_fallbacks"] == 0
    plan = next(r["fault_plan"] for r in check_serve._json_lines(log)
                if "fault_plan" in r)
    assert plan["schedule"] == jfaults.FaultPlan.smoke(int(seed)).record()
    assert json.loads(log.splitlines()[-1])["faults"]["pending"] == []
