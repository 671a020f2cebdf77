"""The port's admissions compute only the rows they carry.

`Server.prefill` runs a one-slot admission as a (1, S) forward over a
view of its slot's cache rows (`transformer.cache_rows`), and
`Server.admit_chunk` one forward per run of adjacent admitted slots plus
one decode column for the riding slots.  Each is held here to the
padded (B, S) forward it replaces, on one server state, in f32: the
same first tokens, logits within 1e-5 of the largest |logit|, and the
other slots' rows untouched.  A model with an MoE layer keeps the
padded forward (its expert capacity counts every row).  No JAX here:
the card test at the end runs where only the port is installed.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.convert import disable_tf32  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime import paging, trace  # noqa: E402
from repro_torch.runtime.lifecycle import Lifecycle  # noqa: E402

BATCH, MAX_LEN = 5, 32
TINY = ModelConfig(name="tiny-admit", family="dense", num_layers=2,
                   d_model=32, d_ff=64, vocab_size=101, num_heads=4,
                   num_kv_heads=2)
# name -> (config, kv dtype, paged)
LAYOUTS = {
    "f32": (TINY, torch.float32, False),
    "paged": (TINY, torch.float32, True),
    "int8": (TINY, torch.int8, False),
    "ring": (configs.get_smoke("h2o_danube_1_8b"), torch.float32, False),
    "rwkv6": (configs.get_smoke("rwkv6_7b"), torch.float32, False),
}


@pytest.fixture(autouse=True)
def _f32(monkeypatch, tmp_path):
    """Servers that compute in f32, and a tuning cache of the test's
    own."""
    monkeypatch.setattr(serve, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _server(cfg, kv_dtype=torch.float32, paged=False, params=None,
            batch=BATCH):
    spec = paging.PageSpec.build(batch, MAX_LEN, 4) if paged else None
    return serve.Server(cfg, batch, MAX_LEN, device="cpu", params=params,
                        autotune_kernels=False, kv_dtype=kv_dtype,
                        paged=spec)


def _twins(cfg, kv_dtype=torch.float32, paged=False, batch=BATCH):
    """Two servers with one set of weights: the first admits narrowly,
    the second through the padded (B, S) forward."""
    narrow = _server(cfg, kv_dtype, paged, batch=batch)
    padded = _server(cfg, kv_dtype, paged, params=narrow.params,
                     batch=batch)
    assert narrow.narrow_admissions
    padded.narrow_admissions = False
    return narrow, padded


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).astype(np.int32)


def _leaves(server):
    return {name: t.clone() for name, t in
            serve._tensor_leaves(server.cache["blocks"])}


def _slot_rows(server, name, t, slot):
    """Mask of the entries of stacked leaf ``t`` that belong to
    ``slot``: its batch row, or in a page pool the pages its table
    names."""
    mask = torch.zeros(t.shape, dtype=torch.bool)
    if server.paged is not None and transformer._is_pool_leaf(
            t, server.paged):
        row = server.cache["pages"][slot]
        mask[:, row[row >= 0].long()] = True
    else:
        mask[:, slot] = True
    return mask


def _fill(server, cfg, slots, steps=2):
    """Occupy ``slots`` with prompts of different lengths and decode
    ``steps`` steps."""
    for i, s in enumerate(slots):
        server.prefill(s, 100 + s, _prompt(cfg, 3 + 2 * i, s), 20)
    for _ in range(steps):
        server.decode_step()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_slot_admission_equals_the_padded_forward(layout):
    """On one server state, the narrowed admission of slot 2 gives the
    padded forward's first token, its logits within 1e-5 of the largest
    |logit|, and leaves every other slot's cache rows bitwise as they
    were; the padded server's rows of slot 2 agree with the narrow
    one's."""
    cfg, kv_dtype, paged = LAYOUTS[layout]
    narrow, padded = _twins(cfg, kv_dtype, paged)
    prompt = _prompt(cfg, 11, 7)
    out = {}
    for server in (narrow, padded):
        _fill(server, cfg, [0, 1, 3])
        before = _leaves(server)
        lengths = server.cache["lengths"].clone()
        ok, logits = server._prefill(2, 9, prompt, 5, logits=True)
        assert ok
        after = _leaves(server)
        for name, t in after.items():
            other = ~_slot_rows(server, name, t, 2)
            assert torch.equal(t[other], before[name][other]), name
        want = lengths.clone()
        want[2] = min(prompt.size, cfg.sliding_window or prompt.size)
        assert torch.equal(server.cache["lengths"], want)
        out[server] = (int(server.last_tok[2, 0]), logits, after)
    (tok, got, rows), (tok_p, want, rows_p) = out[narrow], out[padded]
    assert tok == tok_p
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    for name, t in rows.items():
        mine = _slot_rows(narrow, name, t, 2)
        torch.testing.assert_close(t[mine].float(), rows_p[name][mine].float(),
                                   rtol=0, atol=1e-5)
    assert int(narrow.cache["index"]) == int(padded.cache["index"])


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_a_chunk_of_scattered_slots_equals_one_slot_admissions(paged):
    """Slots 1 and 4 ride while slots 0, 2 and 3 are admitted in one
    chunk: runs [0] and [2, 3] (at the run's widest prompt) and the
    riders' decode column.  The riders' tokens and rows equal one
    `decode_step`'s; the admitted slots' first tokens equal one-slot
    admissions', their rows within 1e-5."""
    batch = 6
    chunked = _server(TINY, paged=paged, batch=batch)
    solo = _server(TINY, paged=paged, params=chunked.params, batch=batch)
    admits = [(s, 50 + s, _prompt(TINY, n, s), 6)
              for s, n in ((0, 4), (2, 9), (3, 5))]
    for server in (chunked, solo):
        _fill(server, TINY, [1, 4])
    ok_admit, nxt, rode, done, bad = chunked.admit_chunk(admits)
    assert rode == [1, 4] and not done and not bad
    assert all(ok_admit.values())
    want, _, _ = solo.decode_step()
    for s in rode:
        assert nxt[s, 0] == want[s, 0] == chunked.last_tok[s, 0]
    for slot, rid, prompt, gen in admits:
        assert solo.prefill(slot, rid, prompt, gen)
    assert np.array_equal(chunked.last_tok, solo.last_tok)
    assert np.array_equal(chunked.slot_len, solo.slot_len)
    assert torch.equal(chunked.cache["lengths"], solo.cache["lengths"])
    got, want = _leaves(chunked), _leaves(solo)
    for name, t in got.items():
        for s in rode:
            mask = _slot_rows(chunked, name, t, s)
            assert torch.equal(t[mask], want[name][mask]), (name, s)
        torch.testing.assert_close(t, want[name], rtol=0, atol=1e-5)


def test_the_runs_of_a_chunk():
    assert serve._runs([0, 2, 3, 5, 6, 7]) == [(0, 1), (2, 4), (5, 8)]
    assert serve._runs([4]) == [(4, 5)]
    assert serve._runs(list(range(64))) == [(0, 64)]


def test_cache_rows_are_views_of_the_batch():
    """`transformer.cache_rows` cuts every batch-major leaf, the lengths
    and the page table, and hands page pools and the index whole: a
    write through it lands in the cache."""
    spec = paging.PageSpec.build(4, MAX_LEN, 4)
    cache = transformer.cache_init(TINY, 4, MAX_LEN, dtype=torch.float32,
                                   device="cpu", paged=spec)
    view = transformer.cache_rows(cache, 1, 3, paged=spec)
    assert view["blocks"]["k"] is cache["blocks"]["k"]
    assert view["pages"].shape == (2, spec.max_pages)
    assert view["index"] is cache["index"]
    view["pages"][0, 0] = 7
    view["lengths"][1] = 5
    assert cache["pages"][1, 0] == 7 and cache["lengths"][2] == 5
    flat = transformer.cache_init(TINY, 4, MAX_LEN, dtype=torch.float32,
                                  device="cpu", decode_span=16)
    view = transformer.cache_rows(flat, 2, 3)
    assert view["decode_span"] == 16
    for a, v in zip(tree_lib.leaves(flat["blocks"]),
                    tree_lib.leaves(view["blocks"])):
        assert v.shape == (a.shape[0], 1, *a.shape[2:])
        v.fill_(3.0)
        assert bool((a[:, 2] == 3).all()) and not a[:, :2].any()


# Prompts of one width, so that no run pads: (prompt, gen)
EVEN = [(6, 2), (6, 2), (6, 9), (6, 3), (6, 4), (6, 2)]


def _loop(server, mix):
    lc = Lifecycle(clock=lambda: 0.0)
    rng = np.random.default_rng(0)
    for rid, (n, gen) in enumerate(mix):
        lc.submit(rid, rng.integers(0, server.cfg.vocab_size, n)
                  .astype(np.int32), gen)
    return serve.serve_loop(server, lc), lc


@pytest.mark.parametrize("arch", ["dense", "phi3_5_moe_42b"])
def test_admissions_count_the_rows_they_compute(arch):
    """A dense model's admissions compute what they carry: one-slot
    admissions alone, and a loop whose prompts are of one width, chunks
    with riders included.  An MoE model's admissions stay (B, S)
    forwards: each computes batch x width."""
    cfg = TINY if arch == "dense" else configs.get_smoke(arch)
    server = _server(cfg, batch=3)
    assert server.narrow_admissions == (arch == "dense")
    for slot, n in ((0, 5), (2, 7)):
        server.prefill(slot, slot, _prompt(cfg, n, slot), 4)
    assert server.positions_carried["admit"] == 12
    assert server.positions_computed["admit"] == (
        12 if arch == "dense" else 3 * 12)
    server = _server(cfg, batch=3)
    widths = []
    step = server._step

    def counted(tokens, active, *a, **k):
        if k.get("kind", "admit") == "admit":
            lo, hi = k.get("rows") or (0, server.batch)
            widths.append((hi - lo, tokens.shape[1]))
        return step(tokens, active, *a, **k)
    server._step = counted
    stats, lc = _loop(server, EVEN)
    assert lc.counters()["completed"] == len(EVEN)
    assert stats["chunked_prefills"] >= 2
    computed = stats["positions_computed"]["admit"]
    if arch == "dense":
        assert computed == stats["positions_carried"]["admit"] == 6 * 6
        assert any(rows < 3 for rows, _ in widths)
    else:
        assert computed == len(widths) * 3 * 6
        assert all(rows == 3 for rows, _ in widths)


class _Timed(serve.Server):
    """Overrides the public forwards as `bench/timed.py`'s server does,
    and notes any call made inside another."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.calls, self.open = [], 0

    def _call(self, kind, fn, *a, **k):
        self.calls.append((kind, self.open))
        self.open += 1
        try:
            return fn(*a, **k)
        finally:
            self.open -= 1

    def prefill(self, *a, **k):
        return self._call("prefill", super().prefill, *a, **k)

    def admit_chunk(self, *a, **k):
        return self._call("admit_chunk", super().admit_chunk, *a, **k)

    def decode_step(self, *a, **k):
        return self._call("decode_step", super().decode_step, *a, **k)


def test_an_overriding_server_sees_one_call_per_admission_and_step():
    """No public forward runs inside another: the loop's admissions and
    decode steps each reach the subclass once, chunks with riders
    included."""
    server = _Timed(TINY, 3, MAX_LEN, device="cpu", autotune_kernels=False)
    trace.clear()
    trace.enable()
    try:
        stats, lc = _loop(server, [(5, 2), (7, 2), (4, 9), (6, 3), (3, 4),
                                   (8, 2)])
        recs = trace.records()
    finally:
        trace.disable()
        trace.clear()
    assert lc.counters()["completed"] == 6
    assert all(depth == 0 for _, depth in server.calls)
    kinds = [k for k, _ in server.calls]
    assert kinds.count("decode_step") == sum(
        r.name == "serve.decode" for r in recs)
    assert kinds.count("prefill") + kinds.count("admit_chunk") == sum(
        r.name == "serve.admit" for r in recs)
    assert kinds.count("admit_chunk") == stats["chunked_prefills"] >= 2


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
def test_narrow_admission_at_phi3_mini_width(cuda, monkeypatch):
    """Phi-3-mini-3.8B at full width and 2 layers, 64 slots of 768 rows,
    a bf16 cache, weights from the seed 0, computed in bf16: a one-slot
    admission of 160 tokens beside 8 occupied slots gives the padded
    forward's logits within `serve.BF16_LOGIT_REL` of the largest
    |logit|, and allocates less at its peak."""
    monkeypatch.setattr(serve, "COMPUTE_DTYPE", torch.bfloat16)
    cfg = dataclasses.replace(configs.get("phi3_mini_3_8b"), num_layers=2)
    server = serve.Server(cfg, 64, 768, device=cuda, kv_dtype=torch.bfloat16,
                          autotune_kernels=False)
    for s in range(8):
        server.prefill(s, s, _prompt(cfg, 100 + 10 * s, s), 8)
    prompt = _prompt(cfg, 160, 99)
    out = {}
    for narrow in (True, False):
        server.narrow_admissions = narrow
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        ok, logits = server._prefill(40, 40, prompt, 8, logits=True)
        torch.cuda.synchronize()
        assert ok
        out[narrow] = (logits, torch.cuda.max_memory_allocated(cuda) - base)
    (got, peak), (want, peak_padded) = out[True], out[False]
    scale = float(np.abs(want).max())
    print(f"gap {float(np.abs(got - want).max()) / scale:.3e}, peak above "
          f"the resident {peak / 2**20:.1f} MiB narrow, "
          f"{peak_padded / 2**20:.1f} MiB padded")
    assert float(np.abs(got - want).max()) <= serve.BF16_LOGIT_REL * scale
    assert peak < peak_padded
