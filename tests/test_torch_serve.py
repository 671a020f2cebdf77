"""The port's `Server` and serve CLI against the JAX serving stack.

Greedy token streams must be equal, not close: both servers decode in
bf16 from the same (converted) parameters, with an f32, a paged or an int8
cache, and a differing stream is a fault of the port unless it parts at a
bf16 near-tie (ROADMAP queue C): where it first differs, JAX's own top-2
logit gap is below the bf16 logit bound.  Lifecycle outcomes, the
scheduler's picks and the paged `kv` numbers must be equal.
"""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import redirect_stdout  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.runtime import paging as jpaging  # noqa: E402
from repro.runtime.lifecycle import Lifecycle as JLifecycle  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.convert import disable_tf32, params_from_numpy  # noqa: E402
from repro_torch.launch import scheduler as tsched  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.runtime import paging as tpaging  # noqa: E402
from repro_torch.runtime.lifecycle import Lifecycle as TLifecycle  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import check_serve  # noqa: E402


@pytest.fixture(autouse=True)
def _full_f32():
    disable_tf32()


def _cfgs(**kw):
    base = dict(name="tiny-serve", family="dense", num_layers=2, d_model=32,
                d_ff=64, vocab_size=101, num_heads=4, num_kv_heads=2)
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def _requests(vocab, spec):
    """spec: [(prompt_len, gen_len)] -> [(rid, prompt, gen)], the prompts
    of tests/test_serving.py."""
    return [(rid, np.asarray(jax.random.randint(
                jax.random.PRNGKey(100 + rid), (plen,), 0, vocab), np.int32),
             gen) for rid, (plen, gen) in enumerate(spec)]


def _serve_all(server, batch, requests):
    """Prefill/decode/refill loop of tests/test_serving.py, for either
    server: {rid: [first token, decode tokens...]}."""
    queue = list(requests)
    tokens = {rid: [] for rid, _, _ in requests}
    slot_rid = {}

    def fill(slot):
        rid, prompt, gen = queue.pop(0)
        server.prefill(slot, rid, prompt, gen)
        slot_rid[slot] = rid
        tokens[rid].append(int(server.last_tok[slot, 0]))

    for slot in range(min(batch, len(queue))):
        fill(slot)
    completed = 0
    for _ in range(200):
        if completed == len(requests):
            return tokens
        nxt, done, _ = server.decode_step()
        for slot, rid in slot_rid.items():
            if server.slot_req[slot] == rid:
                tokens[rid].append(int(nxt[slot, 0]))
        for slot in done:
            completed += 1
            server.slot_req[slot] = -1
            if queue:
                fill(slot)
    raise AssertionError("serve loop failed to drain the queue")


@pytest.fixture(autouse=True)
def _own_tune_cache(monkeypatch, tmp_path):
    """The port's servers tune their plans at start-up: into a cache file
    of the test's own, never the checkout's."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "torch_autotune.json"))


def _random_biases(params, seed=5):
    """``params`` with its QKV biases drawn N(0, 1): both inits leave them
    zero, which would hide a bias the port drops or misplaces."""
    rng = np.random.default_rng(seed)
    mixer = dict(params["blocks"]["mixer"])
    for name in ("bq", "bk", "bv"):
        mixer[name] = jnp.asarray(rng.standard_normal(mixer[name].shape),
                                  mixer[name].dtype)
    return {**params, "blocks": {**params["blocks"], "mixer": mixer}}


def _servers(jcfg, tcfg, batch, max_len, layout="f32", pool_pages=0):
    """A JAX and a port server with the same parameters and KV cache:
    ``layout`` f32, int8, paged (f32) or paged_int8, pages of 4 tokens; a
    model with a QKV bias gets random biases (`_random_biases`)."""
    int8 = layout.endswith("int8")
    jspec = tspec = None
    if layout.startswith("paged"):
        jspec = jpaging.PageSpec.build(batch, max_len, 4, pool_pages)
        tspec = tpaging.PageSpec.build(batch, max_len, 4, pool_pages)
    js = jserve.Server(jcfg, batch, max_len, autotune_kernels=False,
                       paged=jspec,
                       kv_dtype=jnp.int8 if int8 else jnp.float32)
    if jcfg.qkv_bias:
        js.params = _random_biases(js.params)
    ts = tserve.Server(tcfg, batch, max_len, device="cpu",
                       params=params_from_numpy(
                           jax.tree.map(np.asarray, js.params)),
                       paged=tspec,
                       kv_dtype=torch.int8 if int8 else torch.float32)
    return js, ts


@pytest.mark.parametrize("jax_kernel", ["interpret", "off"])
def test_token_streams_match_jax_server(jax_kernel, monkeypatch, tmp_path):
    """Ragged batch of 2 with a refill (tests/test_serving.py's spec): the
    JAX server decodes through its Pallas kernel in interpret mode or
    through its jnp path; the port through `gqa_decode_attention`."""
    monkeypatch.setenv("REPRO_DECODE_KERNEL", jax_kernel)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    jcfg, tcfg = _cfgs()
    spec = [(5, 7), (9, 4), (3, 6)]
    reqs = _requests(jcfg.vocab_size, spec)
    max_len = max(p + g for p, g in spec) + 4
    js, ts = _servers(jcfg, tcfg, 2, max_len)
    want = _serve_all(js, 2, reqs)
    got = _serve_all(ts, 2, reqs)
    assert got == want
    assert all(len(got[rid]) == gen + 1 for rid, _, gen in reqs)
    assert ts.decode_forwards > 0


def test_serve_step_active_none_advances_everyone():
    """`make_serve_step` with ``active=None`` advances every slot, and its
    greedy tokens equal the JAX step's over a few teacher-free steps."""
    from repro.launch import steps as jsteps
    from repro.models import transformer as jtf_
    from repro_torch.convert import cache_from_numpy
    from repro_torch.launch import steps as tsteps
    jcfg, tcfg = _cfgs()
    jparams = jtf_.init(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    jstep = jax.jit(jsteps.make_serve_step(jcfg))
    tstep = tsteps.make_serve_step(tcfg)
    jcache = jtf_.cache_init(jcfg, 2, 8, dtype=jnp.float32)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jcache))
    jtok = jnp.asarray([[1], [7]], jnp.int32)
    ttok = torch.tensor([[1], [7]], dtype=torch.int32)
    for _ in range(4):
        jtok, jcache = jstep(jparams, jcache, jtok)
        ttok, tcache = tstep(tparams, tcache, ttok)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tcache["lengths"].tolist() == [4, 4] and int(tcache["index"]) == 4


# The port's bf16 logits agree with JAX's to within this share of the
# largest logit (tests/test_torch_model.py states why).
BF16_LOGIT_REL = 3e-2


def _jax_solo_gaps(jcfg, params, prompt, gen, kv_dtype=jnp.float32):
    """Replay one request alone on a JAX server and return, for each of
    its tokens, the top-2 gap of the logits it was drawn from and the
    bound the port's logits are held to there."""
    server = jserve.Server(jcfg, 1, len(prompt) + gen + 4,
                           autotune_kernels=False, kv_dtype=kv_dtype)
    fwd = jax.jit(lambda p, c, t, a: jtf.forward(
        jcfg, p, {"tokens": t}, cache=c, active=a)[0][:, -1])
    out = []

    def record(tokens):
        last = np.asarray(fwd(params, server.cache, jnp.asarray(tokens),
                              jnp.ones((1,), bool)), np.float32)[0]
        top2 = np.sort(last)[-2:]
        out.append((int(last.argmax()), float(top2[1] - top2[0]),
                    BF16_LOGIT_REL * float(np.abs(last).max())))
    record(np.asarray(prompt, np.int32)[None])
    server.prefill(0, 0, prompt, gen)
    for _ in range(gen):
        record(np.asarray(server.last_tok))
        server.decode_step()
    return out


def test_serve_loop_chunked_prefill_matches_jax():
    """The whole loop, with chunked prefill and riding decode slots: the
    outcomes equal the JAX loop's, every request equals the port's own solo
    decode (the JAX package's invariant), and every token equals JAX's up
    to a bf16 near-tie: where a stream first differs, JAX's own top-2
    logit gap there is below the bf16 logit bound (ROADMAP queue C)."""
    jcfg, tcfg = _cfgs()
    spec = [(5, 6), (3, 4), (7, 5), (4, 6)]
    reqs = _requests(jcfg.vocab_size, spec)
    max_len = max(p + g for p, g in spec) + 4
    js, ts = _servers(jcfg, tcfg, 2, max_len)
    jlc, tlc = JLifecycle(clock=lambda: 0.0), TLifecycle(clock=lambda: 0.0)
    for rid, prompt, gen in reqs:
        jlc.submit(rid, prompt, gen)
        tlc.submit(rid, prompt, gen)
    jstats = jserve.serve_loop(js, jlc, max_steps=400)
    tstats = tserve.serve_loop(ts, tlc, max_steps=400)
    assert tstats["chunked_prefills"] == jstats["chunked_prefills"] >= 1
    assert tstats["generated"] == jstats["generated"]
    assert tlc.outcome_trace() == jlc.outcome_trace()
    for rid, prompt, gen in reqs:
        got, want = tlc.requests[rid].tokens, jlc.requests[rid].tokens
        _, solo_port = _servers(jcfg, tcfg, 1, max_len)
        assert got == _serve_all(solo_port, 1, [(rid, prompt, gen)])[rid]
        if got == want:
            continue
        m = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        tok, gap, bound = _jax_solo_gaps(jcfg, js.params, prompt, gen)[m]
        assert tok == want[m], "solo JAX replay left the batched stream"
        assert gap < bound, (
            f"request {rid} token {m}: port {got[m]} != JAX {want[m]} with "
            f"a JAX top-2 gap {gap} above the bf16 bound {bound}")


def _near_tie_or_equal(jcfg, js, reqs, got_of, want_of, kv_dtype):
    """Every request's stream equals JAX's, or first parts from it where
    JAX's solo top-2 gap is below the bf16 logit bound."""
    for rid, prompt, gen in reqs:
        got, want = got_of(rid), want_of(rid)
        if got == want:
            continue
        m = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        tok, gap, bound = _jax_solo_gaps(jcfg, js.params, prompt, gen,
                                         kv_dtype)[m]
        assert tok == want[m], "solo JAX replay left the batched stream"
        assert gap < bound, (
            f"request {rid} token {m}: port {got[m]} != JAX {want[m]} with "
            f"a JAX top-2 gap {gap} above the bf16 bound {bound}")


# Requests of 9-12 tokens (3 pages of 4) and one of 35 that no pool of 8
# pages can hold: with batch 2 and 8 pages at most two fit at once.
SCHED_SPEC = [(5, 6), (3, 4), (7, 5), (20, 15), (4, 6), (9, 3)]


@pytest.mark.parametrize("policy", ["fcfs", "spf", "paged-aware"])
@pytest.mark.parametrize("layout", ["paged", "int8", "paged_int8"])
def test_serve_loop_layouts_and_policies_match_jax(layout, policy):
    """The whole loop under each admission policy with a paged, an int8
    and a paged int8 cache: outcomes, the scheduler's rejections, the
    pool's peak and end state, and the token streams equal the JAX
    loop's."""
    _loop_matches_jax(*_cfgs(), layout, policy)


@pytest.mark.parametrize("layout", ["f32", "paged", "int8", "paged_int8"])
@pytest.mark.parametrize("arch", ["phi3_mini_3_8b", "qwen2_5_32b"])
def test_dense_arch_serve_loop_layouts_match_jax(arch, layout):
    """Phi-3-mini (plain MHA) and Qwen2.5-32B (a QKV bias, random here)
    at their SMOKE configs, the whole loop under ``fcfs`` with each cache
    layout: outcomes, rejections, the pool's counters and the token
    streams equal the JAX loop's."""
    import repro.configs as jconfigs
    _loop_matches_jax(jconfigs.get_smoke(arch), tconfigs.get_smoke(arch),
                      layout, "fcfs")


@pytest.mark.parametrize("arch", ["phi3_mini_3_8b", "qwen2_5_32b"])
def test_dense_arch_forward_matches_jax(arch):
    """The SMOKE configs' f32 forward, Qwen2.5's with random QKV biases,
    within 1e-5 of JAX's largest |logit|: at SMOKE width a greedy stream
    barely feels the attention, so this is where a bias the port drops
    or misplaces shows."""
    import repro.configs as jconfigs
    from repro_torch.models import transformer as ttf
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp = jtf.init(jcfg, jax.random.PRNGKey(1))
    if jcfg.qkv_bias:
        jp = _random_biases(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 12), 0,
                                         jcfg.vocab_size), np.int32)
    want = np.asarray(jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  compute_dtype=jnp.float32)[0])
    got = ttf.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                      compute_dtype=torch.float32)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _loop_matches_jax(jcfg, tcfg, layout, policy):
    """`SCHED_SPEC`'s requests through both loops at batch 2 (a pool of
    8 pages of 4 where paged), held to each other."""
    reqs = _requests(jcfg.vocab_size, SCHED_SPEC)
    max_len = max(p + g for p, g in SCHED_SPEC) + 4
    paged = layout.startswith("paged")
    js, ts = _servers(jcfg, tcfg, 2, max_len, layout,
                      pool_pages=8 if paged else 0)
    jlc, tlc = JLifecycle(clock=lambda: 0.0), TLifecycle(clock=lambda: 0.0)
    for rid, prompt, gen in reqs:
        jlc.submit(rid, prompt, gen)
        tlc.submit(rid, prompt, gen)
    jsc = jsched.Scheduler(policy, allocator=js.allocator)
    tsc = tsched.Scheduler(policy, allocator=ts.allocator)
    jstats = jserve.serve_loop(js, jlc, max_steps=400, scheduler=jsc)
    tstats = tserve.serve_loop(ts, tlc, max_steps=400, scheduler=tsc)
    assert tlc.outcome_trace() == jlc.outcome_trace()
    assert tlc.counters() == jlc.counters()
    assert tsc.rejected_oversize == jsc.rejected_oversize == int(paged)
    for key in ("generated", "max_concurrent", "chunked_prefills",
                "kv_pages_peak", "kv_peak", "kv_ooms"):
        assert tstats[key] == jstats[key], key
    if paged:
        assert tstats["max_concurrent"] <= 2 and tstats["kv_ooms"] == 0
        assert ts.allocator.utilization() == js.allocator.utilization()
        assert ts.allocator.allocated_pages == 0
        assert (ts.cache["pages"] == -1).all()
    _near_tie_or_equal(jcfg, js, reqs, lambda r: tlc.requests[r].tokens,
                       lambda r: jlc.requests[r].tokens,
                       jnp.int8 if layout.endswith("int8") else jnp.float32)


# (arch, layout, [(prompt, gen)]): Danube's prompts of 12 and 10 tokens
# pass its window of 8, so the ring wraps in prefill and in decode.
FAMILY_SERVE = [
    ("h2o_danube_1_8b", "f32", [(12, 5), (5, 6), (10, 4), (3, 7)]),
    ("phi3_5_moe_42b", "f32", [(5, 6), (9, 4), (3, 6), (7, 5)]),
    ("phi3_5_moe_42b", "paged", [(5, 6), (9, 4), (3, 6), (7, 5)]),
    ("qwen3_moe_235b", "f32", [(5, 6), (9, 4), (3, 6), (7, 5)]),
    ("rwkv6_7b", "f32", [(5, 6), (9, 4), (3, 6), (7, 5)]),
    ("jamba_1_5_large_398b", "f32", [(5, 6), (9, 4), (3, 6), (7, 5)]),
]


@pytest.mark.parametrize("arch, layout, spec", FAMILY_SERVE,
                         ids=[f"{a}-{l}" for a, l, _ in FAMILY_SERVE])
def test_family_serve_loop_matches_jax(arch, layout, spec):
    """The whole loop at batch 2 on each family's SMOKE config: outcomes,
    chunked prefills (dense and MoE only), the generated count and every
    token stream equal the JAX loop's, up to a bf16 near-tie."""
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    reqs = _requests(jcfg.vocab_size, spec)
    max_len = max(p + g for p, g in spec) + 4
    js, ts = _servers(jcfg, tcfg, 2, max_len, layout)
    if tcfg.sliding_window:
        assert ts.cache["blocks"]["k"].shape[2] == tcfg.sliding_window
    jlc, tlc = JLifecycle(clock=lambda: 0.0), TLifecycle(clock=lambda: 0.0)
    for rid, prompt, gen in reqs:
        jlc.submit(rid, prompt, gen)
        tlc.submit(rid, prompt, gen)
    jstats = jserve.serve_loop(js, jlc, max_steps=400)
    tstats = tserve.serve_loop(ts, tlc, max_steps=400)
    assert tlc.outcome_trace() == jlc.outcome_trace()
    assert ts.can_chunk() == js.can_chunk() == (
        tcfg.family in ("dense", "moe") and not tcfg.sliding_window)
    for key in ("generated", "chunked_prefills", "max_concurrent"):
        assert tstats[key] == jstats[key], key
    assert tstats["generated"] == sum(g for _, g in spec)
    if layout == "paged":
        assert ts.allocator.allocated_pages == 0
    _near_tie_or_equal(jcfg, js, reqs, lambda r: tlc.requests[r].tokens,
                       lambda r: jlc.requests[r].tokens, jnp.float32)


def _leaf_dtypes(tree):
    return {name: t.dtype for name, t in tserve._tensor_leaves(tree)}


@pytest.mark.parametrize("arch", sorted(tconfigs.list_archs()))
def test_server_weights_keep_the_init_dtypes(arch):
    """The server casts to bf16 only the leaves the forward reads through
    ``.to(compute dtype)``: its own weights have, leaf for leaf, the
    dtypes of ``transformer.init(..., dtype=bf16)``; from an f32 tree (a
    converted JAX one) each leaf that init keeps in f32 stays f32, and
    besides only the leaves init draws in the compute dtype but the
    forward reads in their own (norm scales, Mamba's step projection and
    bias)."""
    from repro_torch.models import transformer as ttf
    cfg = tconfigs.get_smoke(arch)
    bf16, f32 = torch.bfloat16, torch.float32
    want = _leaf_dtypes(ttf.init(cfg, torch.Generator().manual_seed(0),
                                 dtype=bf16))
    own = tserve.Server(cfg, 1, 8, device="cpu", autotune_kernels=False)
    assert _leaf_dtypes(own.params) == want
    wide = ttf.init(cfg, torch.Generator().manual_seed(0), dtype=f32)
    got = _leaf_dtypes(tserve.Server(cfg, 1, 8, device="cpu", params=wide,
                                     autotune_kernels=False).params)
    assert got.keys() == want.keys()
    kept = {n for n, d in want.items() if d == f32}
    assert kept <= {n for n, d in got.items() if d == f32}
    assert {n for n, d in got.items() if d == f32} - kept <= {
        n for n in want if n.endswith(("['scale']", "['dt_proj']",
                                       "['dt_bias']"))}
    assert any(d == bf16 for d in got.values())


@pytest.mark.parametrize("argv", [
    ["--arch", "h2o_danube_1_8b", "--prompt-len", "12"],
    ["--arch", "phi3_5_moe_42b"],
    ["--arch", "phi3_5_moe_42b", "--paged"],
    ["--arch", "qwen3_moe_235b"],
    ["--arch", "rwkv6_7b"],
    ["--arch", "jamba_1_5_large_398b"],
    ["--arch", "internvl2_2b"],
    ["--arch", "phi3_mini_3_8b"],
    ["--arch", "qwen2_5_32b"],
], ids=lambda a: "-".join(x.lstrip("-") for x in a[1:]))
def test_cli_serves_every_family(argv):
    """The CLI at its defaults (``--batch 0``: the tuner's sweep) on each
    family's SMOKE config passes ``check_serve.py``; Danube's prompts of
    12 tokens pass its window of 8."""
    rc, log = _run_main(["--smoke", "--device", "cpu", *argv])
    assert rc == 0
    assert check_serve.check(log, requests=6, min_tokens=72) == []
    summary = check_serve._json_lines(log)[-1]
    assert summary["decode_forwards"] > 0
    plan = check_serve._json_lines(log)[0]["serving_plan"]
    assert plan["source"] == "autotune"


def test_serve_moe_example_runs_on_the_cpu(capsys):
    """`repro_torch.examples.serve_moe`, the counterpart of
    `examples/serve_moe.py`, serves its 6 requests on the CPU and its log
    passes ``check_serve.py``."""
    from repro_torch.examples import serve_moe
    assert serve_moe.main(["--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert check_serve.check(log, requests=6, min_tokens=48) == []
    assert check_serve._json_lines(log)[-1]["arch"] == "phi3.5-moe-smoke"


def _run_main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tserve.main(argv)
    return rc, out.getvalue()


def test_cli_log_passes_check_serve():
    rc, log = _run_main(["--smoke", "--batch", "2", "--requests", "3",
                         "--prompt-len", "6", "--gen", "4",
                         "--device", "cpu"])
    assert rc == 0
    assert check_serve.check(log, requests=3, min_tokens=12) == []
    assert '{"serving_plan": {"batch": 2, "source": "flag"}}' in log
    summary = check_serve._json_lines(log)[-1]
    assert summary["kv_dtype"] == "float32"
    assert summary["decode_forwards"] > 0
    # the server tunes its plans at start-up whatever the batch's source
    plan = {p["op"]: p for p in summary["kernel_plan"]}
    assert list(plan) == ["qkv_proj", "out_proj", "ffn_up", "ffn_down",
                          "logits", "attn_prefill", "attn_decode"]
    assert summary["decode_span"] == plan["attn_decode"]["knobs"]["block_k"]


@pytest.mark.parametrize("flags", [
    ["--paged", "--sched", "spf", "--kv-dtype", "int8"],
    ["--paged", "--page-size", "4", "--pool-pages", "12", "--sched",
     "paged-aware"],
    ["--kv-dtype", "int8", "--sched", "spf"],
])
def test_cli_paged_int8_and_sched_pass_check_serve(flags):
    rc, log = _run_main(["--smoke", "--batch", "2", "--requests", "6",
                         "--prompt-len", "6", "--gen", "4", "--device", "cpu",
                         *flags])
    assert rc == 0
    assert check_serve.check(log, requests=6, min_tokens=24) == []
    summary = check_serve._json_lines(log)[-1]
    assert summary["sched"]["policy"] == flags[flags.index("--sched") + 1]
    assert summary["kv_dtype"] == ("int8" if "int8" in flags else "float32")
    if "--paged" in flags:
        assert '{"paging": ' in log
        kv = summary["kv"]
        assert kv["pages_allocated"] == 0 and kv["kv_ooms"] == 0
        assert kv["pages_peak"] > 0


@pytest.mark.parametrize("arch", ["rwkv6_7b", "h2o_danube_1_8b",
                                  "jamba_1_5_large_398b", "hubert_xlarge"])
def test_cli_refusals_and_messages_match_the_reference(arch, capsys):
    """``--paged`` for an arch that is not a dense or MoE causal model
    without a window exits 2 with the JAX CLI's message; an encoder-only
    arch prints the JAX CLI's line and exits 0, paged or not."""
    argv = ["--smoke", "--arch", arch, "--paged", "--requests", "2",
            "--prompt-len", "4", "--gen", "2"]
    lines = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device",
                                                          "cpu"])):
        if arch == "hubert_xlarge":
            assert main(argv + extra) == 0
            lines.append(capsys.readouterr().out.splitlines()[-1])
        else:
            with pytest.raises(SystemExit) as exc:
                main(argv + extra)
            assert exc.value.code == 2
            lines.append(capsys.readouterr().err.splitlines()[-1])
    assert lines[0] == lines[1]
    assert (("encoder-only arch has no decode path; nothing to serve"
             if arch == "hubert_xlarge" else "error: --paged needs a "
             "dense/moe causal arch") in lines[1])


def _flags(main):
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    import re
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", out.getvalue()))


def test_cli_accepts_every_flag_of_the_reference():
    """Every flag of the JAX server's CLI, the chaos, crash-recovery and
    trace-replay ones included, is the port's too; the port adds only
    ``--device``."""
    mine, ref = _flags(tserve.main), _flags(jserve.main)
    assert {"--chaos", "--fault-seed", "--state-dir", "--snapshot-every",
            "--snapshot-keep", "--crash", "--crash-step", "--resume",
            "--load-trace", "--step-time-us"} <= ref
    assert mine - ref == {"--device"} and ref <= mine


def test_cli_batch_0_runs_the_sweep():
    """``--batch 0`` (the default) takes the batch from the tuner's sweep
    over the candidates up to ``--requests``, and the run then serves at
    that batch."""
    for argv in (["--batch", "0"], []):
        rc, log = _run_main(["--smoke", "--requests", "3", "--prompt-len",
                             "6", "--gen", "4", "--device", "cpu", *argv])
        assert rc == 0
        assert check_serve.check(log, requests=3, min_tokens=12) == []
        plan = check_serve._json_lines(log)[0]["serving_plan"]
        assert plan["source"] == "autotune"
        assert [r["batch"] for r in plan["sweep"]] == [1, 2]
        summary = check_serve._json_lines(log)[-1]
        assert summary["batch"] == plan["batch"]
        assert summary["batch_source"] == "autotune"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.Server(tcfg, 1, 8)


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        roots = {n.split(".")[0] for n in names}
        assert not roots & {"jax", "jaxlib", "repro"}, (path, names)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ,
                               "PYTHONPATH": str(REPO / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
