"""The port's crash tolerance against the JAX package's: the journal
(`runtime/journal.py`, the JAX record format both ways), the snapshot
store (`runtime/snapshot.py`, bitwise for f32, bf16 and int8 leaves and
the cache's decode span), the server's state export and restore, the
re-prefill check of `Server.restore_slot` with its near-tie rule, and
``serve --crash`` / ``serve --resume`` token for token against an
uninterrupted run on a contiguous, a paged and an int8 cache, with a
crash before the first snapshot too.

Journals, folds and token streams are integers and strings, compared with
``==``; snapshots and restored caches are compared bit for bit (bf16
through its 16-bit pattern).  A resumed bf16 cache holds the re-prefilled
slots' K/V as a prefill-shaped forward rounds them, so its streams are
held to the near-tie rule of ROADMAP queue C instead (`_near_tie_or_equal`).
"""

import contextlib
import io
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.runtime import journal as jjournal  # noqa: E402
from repro.runtime import snapshot as jsnapshot  # noqa: E402
from repro.runtime.lifecycle import Lifecycle as JLifecycle  # noqa: E402

from repro_torch.convert import disable_tf32, params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.runtime import faults, journal, paging, snapshot  # noqa: E402
from repro_torch.runtime.lifecycle import Lifecycle, State  # noqa: E402

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
    base = dict(name="tiny-recovery", family="dense", num_layers=2,
                d_model=32, d_ff=64, vocab_size=101, num_heads=4,
                num_kv_heads=2)
    return JConfig(**base), TConfig(**base)


def _requests(vocab, spec):
    return [(rid, np.asarray(jax.random.randint(
                jax.random.PRNGKey(100 + rid), (plen,), 0, vocab), np.int32),
             gen) for rid, (plen, gen) in enumerate(spec)]


# -- the journal --------------------------------------------------------------

def _write(mod, path):
    with mod.Journal(path, durable=False) as j:
        j.submit(0, np.asarray([1, 2, 3], np.int32), gen_len=4,
                 ttft_deadline_s=0.5)
        j.state(0, "prefilling", 0)
        for i in range(3):
            j.token(0, i, np.int32(10 + i), step=i)
        j.state(0, "evicted", 3, retries=0)
        j.state(0, "queued", 3, retries=1, not_before_step=7)
        j.token(0, 0, 42, step=8)
        j.snapshot(8, "snap-00000008.json")


def test_journals_cross_between_the_packages(tmp_path):
    """A journal either package writes is the same bytes, read and folded
    alike by both; token ids land as JSON ints."""
    _write(jjournal, tmp_path / "j.jsonl")
    _write(journal, tmp_path / "t.jsonl")
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    for path in ("j.jsonl", "t.jsonl"):
        recs = journal.read_journal(tmp_path / path)
        assert recs == jjournal.read_journal(tmp_path / path)
        assert journal.replay(recs) == jjournal.replay(recs)
    assert journal.replay(recs)[0]["tokens"] == [42]
    with pytest.raises(TypeError):
        with journal.Journal(tmp_path / "x.jsonl", durable=False) as j:
            j.token(0, 0, torch.tensor(5), step=0)


@pytest.mark.parametrize("tail, torn", [
    ('{"kind": "token", "seq": 8, "ri', True),         # cut mid-append
    ('{"kind": "token", "i": 1, "rid": 0, "seq": 9, "step": 9, "tok": 7}',
     False),                                          # complete, no newline
])
def test_torn_final_line_like_the_reference(tmp_path, tail, torn):
    _write(jjournal, tmp_path / "j.jsonl")
    with open(tmp_path / "j.jsonl", "a") as f:
        f.write(tail)
    mine, my_torn = journal.read_journal(tmp_path / "j.jsonl",
                                         return_torn=True)
    ref, ref_torn = jjournal.read_journal(tmp_path / "j.jsonl",
                                          return_torn=True)
    assert mine == ref and my_torn == ref_torn
    assert (my_torn is not None) == torn
    j = journal.Journal(tmp_path / "j.jsonl", durable=False)
    assert j.seq == len(ref)
    j.close()


def test_interior_corruption_raises_like_the_reference(tmp_path):
    _write(jjournal, tmp_path / "j.jsonl")
    lines = (tmp_path / "j.jsonl").read_text().splitlines(keepends=True)
    (tmp_path / "bad.jsonl").write_text("".join(lines[:2] + ["{oops\n"]
                                                + lines[2:]))
    (tmp_path / "gap.jsonl").write_text("".join(lines[:2] + lines[3:]))
    for name, match in (("bad", "corrupt journal line"), ("gap", "jumped")):
        for mod in (journal, jjournal):
            with pytest.raises(mod.JournalError, match=match):
                mod.read_journal(tmp_path / f"{name}.jsonl")


def test_a_jax_serve_journal_folds_alike_in_the_port(tmp_path):
    """The JAX serve loop's journal (submits, transitions, tokens,
    snapshot markers), read and folded by the port: the same requests,
    states and tokens as the JAX fold and as the JAX run's lifecycle, and
    ``check_serve``'s own fold agrees."""
    jcfg, _ = _cfgs()
    jr = jjournal.Journal(tmp_path / "j.jsonl", durable=False)
    lc = JLifecycle(clock=lambda: 0.0, journal=jr)
    for rid, prompt, gen in _requests(jcfg.vocab_size,
                                      [(5, 6), (4, 7), (6, 5)]):
        lc.submit(rid, prompt, gen)
    server = jserve.Server(jcfg, 2, MAX_LEN, autotune_kernels=False)
    jserve.serve_loop(server, lc, journal=jr,
                      snapshots=jsnapshot.SnapshotStore(tmp_path / "s",
                                                        every=3))
    jr.close()
    recs = journal.read_journal(tmp_path / "j.jsonl")
    assert any(r["kind"] == "snapshot" for r in recs)
    mine = journal.replay(recs)
    assert mine == jjournal.replay(jjournal.read_journal(tmp_path /
                                                         "j.jsonl"))
    for rid, req in lc.requests.items():
        assert mine[rid]["tokens"] == [int(t) for t in req.tokens]
        assert mine[rid]["state"] == req.state.value == "completed"
    folded, problems = check_serve.fold_journal(tmp_path / "j.jsonl")
    assert problems == [] and {r: f["tokens"] for r, f in folded.items()} \
        == {r: len(m["tokens"]) for r, m in mine.items()}


# -- snapshots and the server's state -----------------------------------------

def _server(layout, batch=2, **kw):
    """A port server on the CPU: ``layout`` f32, bf16, int8, paged (f32)
    or paged_bf16, pages of 4 tokens; weights from the JAX init."""
    from repro.models import transformer as jtf
    jcfg, tcfg = _cfgs()
    spec = (paging.PageSpec.build(batch, MAX_LEN, 4)
            if layout.startswith("paged") else None)
    kv = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          "paged": torch.float32, "paged_bf16": torch.bfloat16}[layout]
    params = jtf.init(jcfg, jax.random.PRNGKey(0))
    return tserve.Server(tcfg, batch, MAX_LEN, device="cpu",
                         params=params_from_numpy(
                             jax.tree.map(np.asarray, params)),
                         paged=spec, kv_dtype=kv, **kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _fill(server, reqs, steps):
    for slot, (rid, prompt, gen) in enumerate(reqs):
        server.prefill(slot, rid, prompt, gen)
    for step in range(steps):
        server.decode_step(step)


@pytest.mark.parametrize("layout", ["f32", "bf16", "int8", "paged",
                                    "paged_bf16"])
def test_snapshot_round_trip_is_bitwise(tmp_path, layout):
    """`export_state` -> `SnapshotStore.save` -> `latest_snapshot` ->
    `restore_state` into a fresh server: every cache tensor bit for bit
    (a bf16 leaf travels as its uint16 view, its dtype in the manifest),
    the slot vectors, the decode span, the page allocator; the next
    decode step of both servers is the same."""
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size, [(5, 10), (7, 10)])
    a = _server(layout, autotune_kernels=True, prefill_len=7,
                slot_lengths=[9, 14])
    _fill(a, reqs, 3)
    arrays, dtypes = a.export_state()
    store = snapshot.SnapshotStore(tmp_path / "snaps", every=2)
    store.save(step=3, arrays=arrays, meta={"decode_span": a.decode_span},
               journal_seq=11, dtypes=dtypes)
    manifest, loaded = snapshot.latest_snapshot(tmp_path / "snaps")
    want = {"bf16": "bfloat16", "paged_bf16": "bfloat16"}.get(layout)
    kinds = snapshot.leaf_dtypes(manifest)
    assert (kinds["cache['blocks']['k']"] ==
            (want or ("int8" if layout == "int8" else "float32")))
    if want:
        assert loaded["cache['blocks']['k']"].dtype == np.uint16
    if layout == "int8":
        assert kinds["cache['blocks']['k_scale']"] == "float32"

    b = _server(layout, autotune_kernels=False)
    b.restore_state(loaded, kinds, decode_span=manifest["meta"]
                    ["decode_span"])
    assert b.decode_span == a.decode_span
    assert b.cache.get("decode_span") == a.cache.get("decode_span")
    if layout in ("f32", "bf16", "int8"):
        assert a.decode_span is not None
    for (name, ta), (_, tb) in zip(tserve._tensor_leaves(a.cache),
                                   tserve._tensor_leaves(b.cache)):
        assert ta.dtype == tb.dtype, name
        np.testing.assert_array_equal(_bits(ta), _bits(tb), err_msg=name)
    for key in ("slot_len", "slot_target", "slot_req", "last_tok"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    if a.allocator is not None:
        assert b.allocator.allocated_pages == a.allocator.allocated_pages
        assert b.allocator.free_pages == a.allocator.free_pages
        np.testing.assert_array_equal(b.allocator.table, a.allocator.table)
    na, _, _ = a.decode_step(3)
    nb, _, _ = b.decode_step(3)
    np.testing.assert_array_equal(na, nb)


@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
def test_recurrent_state_snapshot_is_bitwise(tmp_path, arch, kv):
    """A snapshot of an RWKV6 or Jamba server carries the recurrent leaves
    bit for bit through the store: the RWKV shifts (and a Mamba conv tail)
    in the cache's dtype, as uint16 when bf16, the WKV and SSM states in
    f32, the hybrid's group leaves under their group keys; the next
    decode step of the restored server is the same."""
    import repro_torch.configs as tconfigs
    from repro.models import transformer as jtf
    import repro.configs as jconfigs
    tcfg = tconfigs.get_smoke(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jtf.init(
        jconfigs.get_smoke(arch), jax.random.PRNGKey(0))))
    dt = torch.float32 if kv == "f32" else torch.bfloat16

    def server():
        return tserve.Server(tcfg, 2, MAX_LEN, device="cpu", params=params,
                             kv_dtype=dt, autotune_kernels=False)
    a = server()
    _fill(a, _requests(tcfg.vocab_size, [(5, 10), (7, 10)]), 3)
    arrays, dtypes = a.export_state()
    store = snapshot.SnapshotStore(tmp_path / "snaps", every=2)
    store.save(step=3, arrays=arrays, meta={}, journal_seq=1, dtypes=dtypes)
    manifest, loaded = snapshot.latest_snapshot(tmp_path / "snaps")
    kinds = snapshot.leaf_dtypes(manifest)
    shift, state = (("cache['blocks']['shift_t']", "cache['blocks']['wkv']")
                    if arch == "rwkv6_7b" else
                    ("cache['blocks']['0']['conv']",
                     "cache['blocks']['0']['h']"))
    assert kinds[shift] == ("float32" if kv == "f32" else "bfloat16")
    assert kinds[state] == "float32"
    assert loaded[shift].dtype == (np.float32 if kv == "f32" else np.uint16)
    b = server()
    b.restore_state(loaded, kinds)
    leaves = list(tserve._tensor_leaves(a.cache, "cache"))
    assert any(name == shift for name, _ in leaves)
    for (name, ta), (_, tb) in zip(leaves,
                                   tserve._tensor_leaves(b.cache, "cache")):
        assert ta.dtype == tb.dtype, name
        np.testing.assert_array_equal(_bits(ta), _bits(tb), err_msg=name)
        assert _bits(ta).any() or name.endswith("['index']"), name
    np.testing.assert_array_equal(a.decode_step(3)[0], b.decode_step(3)[0])


def test_restore_refuses_a_snapshot_of_another_layout():
    a, b = _server("bf16"), _server("f32")
    arrays, dtypes = a.export_state()
    with pytest.raises(ValueError, match="different serving configuration"):
        b.restore_state(arrays, dtypes)
    c = _server("bf16")
    with pytest.raises(ValueError, match="different serving configuration"):
        c.restore_state({**arrays, "cache['blocks']['k']":
                         arrays["cache['blocks']['k']"].view(np.int16)},
                        dtypes)


def test_snapshot_store_is_incremental_and_prunes_like_the_reference(
        tmp_path):
    """An unchanged leaf is referenced from the older payload, a torn
    newest payload falls back to the older snapshot, and pruning keeps
    what a surviving manifest references: the same files as the JAX
    store writes for the same saves."""
    rng = np.random.default_rng(0)
    frozen = rng.standard_normal((4, 8)).astype(np.float32)
    for mod, d in ((snapshot, tmp_path / "t"), (jsnapshot, tmp_path / "j")):
        store = mod.SnapshotStore(d, every=1, keep=2)
        for step in range(4):
            store.save(step=step, arrays={"frozen": frozen,
                                          "moving": np.full(3, step)},
                       meta={"step": step}, journal_seq=step)
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    man, arrays = snapshot.latest_snapshot(tmp_path / "t")
    assert man["step"] == 3 and man["arrays"]["frozen"]["file"] == \
        "snap-00000000.npz"
    np.testing.assert_array_equal(arrays["frozen"], frozen)
    (tmp_path / "t" / "snap-00000003.npz").write_bytes(b"torn")
    man, arrays = snapshot.latest_snapshot(tmp_path / "t")
    assert man["step"] == 2 and arrays["moving"].tolist() == [2, 2, 2]


def test_lifecycle_state_round_trips_like_the_reference():
    jcfg, _ = _cfgs()
    lc = Lifecycle(clock=lambda: 1.5, max_retries=3)
    for rid, prompt, gen in _requests(jcfg.vocab_size, [(4, 3), (5, 2),
                                                        (3, 4)]):
        lc.submit(rid, prompt, gen, deadline_s=9.0)
    req = lc.pop_ready(0)
    lc.transition(req, State.PREFILLING, 0)
    lc.transition(req, State.DECODING, 0)
    req.tokens += [7, 8]
    lc.evict(req, 2)
    state = snapshot.lifecycle_state(lc)
    back = snapshot.restore_lifecycle(json.loads(json.dumps(state)))
    assert snapshot.lifecycle_state(back) == state
    assert jsnapshot.lifecycle_state(jsnapshot.restore_lifecycle(state)) \
        == state
    assert [r.rid for r in back._queue] == [1, 2, 0]


# -- restore_slot --------------------------------------------------------------

def _journaled(server, reqs, steps):
    rid, prompt, gen = reqs[0]
    server.prefill(0, rid, prompt, gen)
    tokens = [int(server.last_tok[0, 0])]
    for step in range(steps):
        nxt, _, _ = server.decode_step(step)
        tokens.append(int(nxt[0, 0]))
    return tokens


def test_restore_slot_reprefill_continues_the_stream():
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size, [(5, 12)])
    a = _server("f32")
    tokens = _journaled(a, reqs, 4)
    b = _server("f32")
    b.restore_slot(0, 0, reqs[0][1], tokens, 12)
    assert int(b.slot_len[0]) == len(tokens) - 1 and b.near_ties == []
    na, _, _ = a.decode_step(4)
    nb, _, _ = b.decode_step(4)
    assert int(na[0, 0]) == int(nb[0, 0])


def test_restore_slot_near_tie_rule(monkeypatch):
    """A journaled token the re-prefill does not predict: refused when
    its logit is far below the argmax's, accepted (recorded, and the slot
    continues from the journaled token) when the gap is under the bound;
    a bound of 0 refuses every difference."""
    _, tcfg = _cfgs()
    reqs = _requests(tcfg.vocab_size, [(5, 12)])
    tokens = _journaled(_server("f32"), reqs, 3)
    probe = _server("f32")
    _, last = probe._prefill(0, 0, np.concatenate(
        [reqs[0][1], tokens[:-1]]), 12, logits=True)
    worst = int(np.argmin(last))
    tampered = tokens[:-1] + [worst]
    with pytest.raises(RuntimeError, match="deterministic recovery"):
        _server("f32").restore_slot(0, 0, reqs[0][1], tampered, 12)
    monkeypatch.setattr(tserve, "BF16_LOGIT_REL", 1e9)
    s = _server("f32")
    s.restore_slot(0, 0, reqs[0][1], tampered, 12)
    (tie,) = s.near_ties
    assert tie["journaled"] == worst and tie["predicted"] == tokens[-1]
    assert tie["position"] == len(tokens) - 1 and tie["gap"] > 0
    assert int(s.last_tok[0, 0]) == worst
    monkeypatch.setattr(tserve, "BF16_LOGIT_REL", 0.0)
    with pytest.raises(RuntimeError, match="deterministic recovery"):
        _server("f32").restore_slot(0, 0, reqs[0][1], tampered, 12)


# -- the serve loop and the CLI -----------------------------------------------

def test_crash_fault_propagates_and_the_journal_survives(tmp_path):
    _, tcfg = _cfgs()
    jr = journal.Journal(tmp_path / "j.jsonl", durable=False)
    lc = Lifecycle(clock=lambda: 0.0, journal=jr)
    for rid, prompt, gen in _requests(tcfg.vocab_size, [(5, 10), (4, 10)]):
        lc.submit(rid, prompt, gen)
    server = _server("f32", injector=faults.FaultInjector(
        faults.FaultPlan.crash(0, step=5)))
    with pytest.raises(faults.CrashFault):
        tserve.serve_loop(server, lc, journal=jr)
    jr.close()
    recs = journal.read_journal(tmp_path / "j.jsonl")
    assert any(r["kind"] == "token" for r in recs)
    assert all(isinstance(r["tok"], int) for r in recs
               if r["kind"] == "token")
    assert tserve.CRASH_EXIT == jserve.CRASH_EXIT == 17


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(argv)
    return rc, buf.getvalue()


def _near_tie_or_equal(got, want, journal_reqs, kv_dtype):
    """Each resumed stream equals the uninterrupted one, or first parts
    from it at a near-tie: there, a teacher-forced prefill of the prompt
    and the uninterrupted tokens before it (the CLI's seeded weights)
    puts the two tokens' logits closer than the bf16 logit bound.  The
    re-prefill at resume writes the prefix's K/V from a prefill-shaped
    forward, which a bf16 cache rounds differently from the decode steps
    that wrote them in the uninterrupted run."""
    import repro_torch.configs as configs
    server = tserve.Server(configs.get_smoke("qwen3_14b"), 1, 64,
                           device="cpu", kv_dtype=kv_dtype,
                           autotune_kernels=False)
    ties = []
    for rid in want:
        if got[rid] == want[rid]:
            continue
        m = next(i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                 if a != b)
        prefix = list(journal_reqs[rid]["prompt"]) + want[rid][:m]
        _, last = server._prefill(0, rid, prefix, 1, logits=True)
        gap = abs(float(last[want[rid][m]] - last[got[rid][m]]))
        bound = tserve.BF16_LOGIT_REL * float(np.abs(last).max())
        assert gap < bound, (rid, m, gap, bound)
        ties.append((rid, m, gap, bound))
    return ties


def _folded(state_dir):
    reqs = journal.replay(journal.read_journal(
        pathlib.Path(state_dir) / "journal.jsonl"))
    return {rid: r["tokens"] for rid, r in reqs.items()}, reqs


BASE = ["--smoke", "--device", "cpu", "--requests", "5", "--batch", "2",
        "--prompt-len", "8", "--gen", "8", "--snapshot-every", "3"]


@pytest.mark.parametrize("flags, crash_step", [
    ([], "5"),
    (["--paged", "--page-size", "4", "--sched", "spf"], "5"),
    (["--kv-dtype", "int8"], "7"),
    (["--paged", "--page-size", "4", "--kv-dtype", "bf16"], "4"),
    ([], "2"),                                   # before the first snapshot
], ids=["f32", "paged", "int8", "paged_bf16", "before_snapshot"])
def test_crash_and_resume_token_for_token(tmp_path, flags, crash_step):
    """``serve --crash`` exits 17 with a crash line and no summary;
    ``serve --resume`` passes ``check_serve.py --recovery`` (journal fold,
    bounded replay) and ``--serving-json``; the journal's streams equal
    an uninterrupted run's; both processes print the same weights
    digest, and a contiguous cache resumes at its decode span."""
    crashed, clean = str(tmp_path / "crashed"), str(tmp_path / "clean")
    rc, crash_log = _run(BASE + flags + ["--state-dir", crashed, "--crash",
                                         "--crash-step", crash_step])
    assert rc == tserve.CRASH_EXIT
    rc, resume_log = _run(["--resume", "--state-dir", crashed, "--device",
                           "cpu"])
    assert rc == 0
    assert check_serve.check(resume_log, require_plan=False) == []
    assert check_serve.check_recovery(
        resume_log, crash_text=crash_log,
        journal=pathlib.Path(crashed) / "journal.jsonl",
        snapshot_every=3) == []
    serving = json.loads((pathlib.Path(crashed) / "serving.json")
                         .read_text())
    assert check_serve.check_serving_json(resume_log, serving) == []
    rc, clean_log = _run(BASE + flags + ["--state-dir", clean])
    assert rc == 0
    got, reqs = _folded(crashed)
    want = _folded(clean)[0]
    assert all(len(t) == 9 for t in got.values())
    if "bf16" in flags:
        _near_tie_or_equal(got, want, reqs, torch.bfloat16)
    else:
        assert got == want

    def lines(log, key):
        return [r[key] for r in check_serve._json_lines(log) if key in r]
    assert lines(crash_log, "params_digest") == \
        lines(resume_log, "params_digest") == lines(clean_log,
                                                    "params_digest")
    summary = lines(resume_log, "recovery")[-1]
    first = check_serve._json_lines(clean_log)[-1]
    assert summary["decode_span"] == first["decode_span"]
    if "--paged" not in flags:
        assert summary["decode_span"] is not None
    if crash_step == "2":
        assert summary["snapshot_step"] is None
    else:
        assert summary["snapshot_step"] is not None
    assert summary["near_ties"] == []


@pytest.mark.parametrize("crash_step", ["5", "2"])
def test_crash_and_resume_token_for_token_on_rwkv6(tmp_path, crash_step):
    """``serve --crash`` / ``--resume`` on RWKV6's SMOKE config, after a
    snapshot and before the first: the resumed slots rebuild their shifts
    and WKV states from the snapshot or by re-prefill, and the journal's
    streams equal an uninterrupted run's token for token."""
    argv = BASE + ["--arch", "rwkv6_7b"]
    crashed, clean = str(tmp_path / "crashed"), str(tmp_path / "clean")
    rc, crash_log = _run(argv + ["--state-dir", crashed, "--crash",
                                 "--crash-step", crash_step])
    assert rc == tserve.CRASH_EXIT
    rc, resume_log = _run(["--resume", "--state-dir", crashed, "--device",
                           "cpu"])
    assert rc == 0
    assert check_serve.check(resume_log, require_plan=False) == []
    assert check_serve.check_recovery(
        resume_log, crash_text=crash_log,
        journal=pathlib.Path(crashed) / "journal.jsonl",
        snapshot_every=3) == []
    rc, _ = _run(argv + ["--state-dir", clean])
    assert rc == 0
    got, want = _folded(crashed)[0], _folded(clean)[0]
    assert got == want and all(len(t) == 9 for t in got.values())
    summary = [r for r in check_serve._json_lines(resume_log)
               if "recovery" in r][-1]["recovery"]
    assert summary["near_ties"] == [] and summary["decode_span"] is None
    assert (summary["snapshot_step"] is None) == (crash_step == "2")


def test_resume_after_a_chaos_crash_finishes_the_schedule(tmp_path):
    """``--chaos --crash``: the resumed process keeps the seeded schedule
    it restored (the crash itself dropped), fires what was left, and the
    resumed log passes ``check_serve.py --chaos`` as well."""
    sd = str(tmp_path / "sd")
    rc, crash_log = _run(BASE + ["--state-dir", sd, "--chaos", "--crash",
                                 "--crash-step", "6"])
    assert rc == tserve.CRASH_EXIT
    rc, log = _run(["--resume", "--state-dir", sd, "--device", "cpu"])
    assert rc == 0
    summary = check_serve._json_lines(log)[-1]
    assert summary["faults"]["pending"] == []
    assert summary["outcomes"]["failed"] == 0
    # the crash fired in the dead process, after the snapshot that the
    # resumed injector restored: its record is the crash log's line
    kinds = {e["kind"] for e in summary["faults"]["fired"]}
    assert kinds == set(faults.SMOKE_FAULT_CLASSES)
    assert summary["kernel_replans"] + summary["retries_total"] >= 1
    assert check_serve.check_recovery(
        log, crash_text=crash_log,
        journal=pathlib.Path(sd) / "journal.jsonl") == []
