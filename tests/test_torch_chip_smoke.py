"""`chip_smoke.py` on a host without a card: its per-row tolerance check
and its refusal to run.  The script itself drives the card."""

import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from repro_torch.kernels.attention import decode  # noqa: E402


def _bf16_case():
    rng = torch.Generator().manual_seed(0)
    q = torch.randn((3, 4, 16), generator=rng).bfloat16()
    k = torch.randn((3, 40, 2, 16), generator=rng).bfloat16()
    v = torch.randn((3, 40, 2, 16), generator=rng).bfloat16()
    v[:, :1] *= 50                      # row 1 (length 1) has a large scale
    lengths = torch.tensor([0, 1, 40])
    return decode.decode_ref(q, k, v, length=lengths), lengths


def test_row_errors_hold_each_row_to_its_own_scale():
    """An error of 2 % of a long row's own size fails, although it is far
    below 2^-7 of the length-1 row's larger outputs."""
    ref, _ = _bf16_case()
    assert chip_smoke.row_errors(torch, ref, ref, False) == (0.0, 0.0)
    long_row = float(ref[2, 1].float().abs().max())
    assert long_row * 0.02 < 2.0 ** -7 * float(ref.float().abs().max())
    bad = ref.clone()
    bad[2, 1, 3] += 0.02 * long_row
    _, ratio = chip_smoke.row_errors(torch, bad, ref, False)
    assert ratio > 1


def test_row_errors_require_exact_zeros_for_length_0():
    ref, lengths = _bf16_case()
    assert lengths[0] == 0 and not ref[0].any()
    bad = ref.clone()
    bad[0, 0, 0] = 1e-3
    assert chip_smoke.row_errors(torch, bad, ref, False)[1] > 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card exit")
def test_chip_smoke_refuses_a_host_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_keys_per_row_counts_the_mask():
    """The pair count behind the flash kernel's bound, against the mask
    itself, and at the two prefill shapes of the card run."""
    from repro_torch.kernels.attention import ref
    for sq, sk, causal, window in [(45, 30, True, 8), (37, 53, False, None),
                                   (64, 64, True, None), (50, 40, False, 7),
                                   (700, 500, True, 64)]:
        keep = ref.mask(torch.arange(sq), torch.arange(sk), causal=causal,
                        window=window)
        rows = chip_smoke.keys_per_row(sq, sk, causal, window)
        assert rows.tolist() == keep.sum(-1).tolist()
    assert int(chip_smoke.keys_per_row(32768, 32768, True, None).sum()) \
        == 32768 * 32769 // 2
    danube = int(chip_smoke.keys_per_row(32768, 32768, True, 4096).sum())
    assert danube == 4096 * 4097 // 2 + (32768 - 4096) * 4096


def test_prefill_vs_forward_on_a_smoke_model(monkeypatch):
    """The phase's check, run on the CPU at Danube's SMOKE size (window 8,
    a prompt of 40): it passes, and the flash entry ran once per layer in
    the two prefill forwards and the step, never in the full forwards."""
    import repro_torch.configs as configs
    from repro_torch.kernels.attention import decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.runtime import quantize
    cfg = configs.get_smoke("h2o_danube_1_8b")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    real = ops.mha_attention

    def counting(*a, **kw):        # on the CPU no kernel launches: count
        flash.launches += 1        # the entry's calls in their place
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mha_attention", counting)
    res = chip_smoke.prefill_vs_forward(
        torch, steps, transformer, (decode, decode_int8, quantize, flash),
        cfg, params, 40)
    assert res["ok"], res
    assert res["flash_launches_prefill"] == 3 * cfg.num_layers
    assert res["flash_launches_forward"] == 0


def test_prefill_vs_forward_catches_the_tiled_gqa_fold(monkeypatch):
    """A flash entry that groups heads as the JAX wrapper does (query
    head h reads KV head h % Hkv) fails the phase's check."""
    import repro_torch.configs as configs
    from repro_torch.kernels.attention import decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.runtime import quantize
    cfg = configs.get_smoke("qwen3_14b")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    real = ops.mha_attention

    def tiled(q, k, v, **kw):
        g = q.shape[2] // k.shape[2]
        return real(q, k.repeat(1, 1, g, 1), v.repeat(1, 1, g, 1), **kw)

    monkeypatch.setattr(ops, "mha_attention", tiled)
    res = chip_smoke.prefill_vs_forward(
        torch, steps, transformer, (decode, decode_int8, quantize, flash),
        cfg, params, 40)
    assert not res["ok"]
    assert res["f32_max_abs_err"] > 100 * res["f32_tolerance"]


def test_prefill_vs_forward_checks_every_sequence(monkeypatch):
    """On HuBERT's frames at batch 2, a flash entry that gives the second
    sequence the first one's output (a batch-indexing fault) fails the
    phase's check."""
    import repro_torch.configs as configs
    from repro_torch.kernels.attention import decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.runtime import quantize
    cfg = configs.get_smoke("hubert_xlarge")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    real = ops.mha_attention

    def first_twice(*a, **kw):
        out = real(*a, **kw)
        return torch.cat([out[:1], out[:1]])

    monkeypatch.setattr(ops, "mha_attention", first_twice)
    inputs = chip_smoke.frontend_inputs(torch, cfg, 40, None, 2, "cpu")
    res = chip_smoke.prefill_vs_forward(
        torch, steps, transformer, (decode, decode_int8, quantize, flash),
        cfg, params, 40, inputs=inputs)
    assert res["sequences"] == 2
    assert not res["ok"]
    assert res["f32_max_abs_err"] > 100 * res["f32_tolerance"]


def test_large_spmv_matrix_statistics_at_a_small_size():
    """The 1M-row generator behind ``spmv_1m_*`` (`table2_spmv.build`), as
    `chip_smoke.spmv_matrix` packs it, at 3,000 rows: LD_pilot87's per-row
    range, the nonzero total, and a CSR copy with sorted rows for
    `torch.sparse_csr_tensor`."""
    import types

    import numpy as np

    from repro_torch.benchmarks import table2_spmv
    from repro_torch.kernels.spmv import ops
    small = types.SimpleNamespace(
        build=lambda name: table2_spmv.synthesize_large(3000, 500, 1, 96,
                                                        seed=5))
    mat, x, (indptr, indices, data) = chip_smoke.spmv_matrix(
        torch, small, ops, "spmv_1m_narrow", torch.device("cpu"))
    per_row = np.diff(indptr.numpy())
    assert mat.shape == (3000, 500) and len(per_row) == 3000
    assert per_row.min() >= 1 and per_row.max() <= 96
    assert mat.nnz == int(per_row.sum()) == len(indices) == len(data)
    assert abs(mat.nnz / 3000 - 48.5) < 2
    assert mat.cols.shape[1] == 128                # ELL width of the 1M cases
    torch.sparse_csr_tensor(indptr, indices, data, size=(3000, 500),
                            check_invariants=True)
    dense = torch.sparse_csr_tensor(indptr, indices, data,
                                    size=(3000, 500)).to_dense()
    torch.testing.assert_close(ops.spmv(mat, x), dense @ x, rtol=1e-4,
                               atol=1e-4)


def test_bytes_and_operations_bounds():
    nbytes, ops, ms, by = chip_smoke.matmul_bound(4096, 4096, 4096, 2, 2,
                                                  False)
    assert nbytes == 3 * 4096 * 4096 * 2 and ops == 2 * 4096 ** 3
    assert by == "operations" and ms == pytest.approx(ops / 989e12 * 1e3)
    _, _, ms32, by32 = chip_smoke.matmul_bound(4096, 4096, 4096, 4, 4, True)
    assert by32 == "operations" and ms32 == pytest.approx(ops / 67e12 * 1e3)
    nbytes, _, ms, by = chip_smoke.matmul_bound(1, 128, 256, 2, 2, False)
    assert by == "bytes" and nbytes == (256 + 256 * 128 + 128) * 2
    # SpMV: the function's bytes are the nonzeros' cols and vals, x and
    # y; the padded ELL's bytes (the walk of earlier kernels) beside them
    nbytes, ops, ms, by, padded = chip_smoke.spmv_bound(
        1_000_000, 32768, 5 * 10**7, 1 << 20, 128)
    assert nbytes == 5 * 10**7 * 8 + 32768 * 4 + 1_000_000 * 4
    assert padded == (1 << 20) * 128 * 8 + 32768 * 4 + (1 << 20) * 4
    assert ops == 10 ** 8 and by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_matmul_row_tolerance():
    """B6's per-row bound: one bf16 ulp of the row's largest |ref| passes
    anywhere in the row, two fail; f32 is held to 1e-5 of it."""
    from repro_torch.kernels.matmul import ref
    want = torch.tensor([[300.0, 1.0, -2.0], [0.5, 0.25, 0.0]])
    tol = ref.row_tolerance(want, torch.bfloat16)
    assert tol.flatten().tolist() == [300 * 2 ** -7, 0.5 * 2 ** -7]
    one_ulp = want.clone()
    one_ulp[0, 1] += 2.0                           # bf16 ulp at 256..512
    assert bool(((one_ulp - want).abs() <= tol).all())
    two_ulp = want.clone()
    two_ulp[1, 2] += 2 * 2 ** -8                   # 2 ulps of the row's 0.5
    assert not bool(((two_ulp - want).abs() <= tol).all())
    assert ref.row_tolerance(want, torch.float32)[0, 0] == \
        pytest.approx(3e-3)


@pytest.fixture
def counting(monkeypatch):
    """On the CPU no kernel launches: count the four decode entries'
    calls in their place, each in its own wrapper's count."""
    from repro_torch.kernels.attention import decode_int8
    for mod, name, attr in (
            (decode, "gqa_decode_attention", "launches"),
            (decode, "paged_gqa_decode_attention", "paged_launches"),
            (decode_int8, "quantized_gqa_decode_attention", "launches"),
            (decode_int8, "paged_quantized_gqa_decode_attention",
             "paged_launches")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _mod=mod, _attr=attr, **kw):
            setattr(_mod, _attr, getattr(_mod, _attr) + 1)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)


def _smoke_mods():
    from repro_torch.kernels.attention import decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.runtime import quantize
    return (decode, decode_int8, quantize, flash)


SMOKE_CLI = ["--smoke", "--device", "cpu"]


@pytest.mark.parametrize("phase", range(2))
def test_chaos_phase_on_a_smoke_model(counting, tmp_path, monkeypatch,
                                      phase):
    """`chaos_phase` with the card run's flags on the SMOKE model: every
    smoke class fires, one re-plan, the quarantined slots are the ones
    ``fired`` names, the layout's kernel counted once per layer a decode
    forward and no other."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_serve
    name, argv, kernel, _ = chip_smoke.CHAOS_PHASES[phase]
    argv = [a if a != "600" else "12" for a in argv] + SMOKE_CLI
    out = chip_smoke.chaos_phase(
        torch, serve, check_serve, _smoke_mods(), phase=name, argv=argv,
        kernel=kernel, clean=None,
        layers=configs.get_smoke("qwen3_14b").num_layers)
    assert out["fired_kinds"] == sorted(chip_smoke.SMOKE_FAULTS)
    assert out["quarantined"] == out["named_by_fired"] != []
    assert out["kernel_replans"] == 1 and out["kernel_launches"] > 0


@pytest.mark.parametrize("phase", range(2))
def test_crash_resume_phase_on_a_smoke_model(counting, tmp_path,
                                             monkeypatch, phase):
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_serve
    name, flags, kernel = chip_smoke.RESUME_PHASES[phase]
    out = chip_smoke.crash_resume_phase(
        torch, serve, check_serve, _smoke_mods(), configs, phase=name,
        flags=flags, kernel=kernel, cli=SMOKE_CLI, state_root=tmp_path,
        layers=configs.get_smoke("qwen3_14b").num_layers)
    assert out["rcs"] == {"clean": 0, "crash": 17, "resume": 0}
    assert 1 <= out["replayed_steps"] <= chip_smoke.SNAPSHOT_EVERY
    assert out["snapshot_bytes"]["clean"] > 0
    assert len(set(d for ds in out["params_digests"].values()
                   for d in ds)) == 1
    assert not (tmp_path / name).exists()


def test_serving_load_phase_on_a_smoke_model(counting, tmp_path,
                                             monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_load
    import check_serve
    out = chip_smoke.serving_load_phase(
        torch, serve, check_serve, check_load, _smoke_mods(), device="cpu",
        state_root=tmp_path)
    assert out["check_load_problems"] == [] and out["replay"]["equal"]
    assert set(out["mixes"]) == {"steady", "bursty", "interactive",
                                 "quantized", "heavytail"}
    assert out["kernel_launches"]["quantized_decode_attention"] > 0
    assert out["kernel_launches"]["paged_decode_attention"] > 0


# -- the other model families' phases, rehearsed on SMOKE models --------------

def _family_argv(arch, *flags):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--requests", "4", "--prompt-len", "6", "--gen", "4", *flags]


FAMILY_SMOKE = [
    ("h2o_danube_1_8b", ["--prompt-len", "12"], None, None),
    ("phi3_5_moe_42b", [], "decode_attention", 1),
    ("phi3_5_moe_42b", ["--paged", "--page-size", "4"],
     "paged_decode_attention", 1),
    ("qwen3_moe_235b", [], "decode_attention", None),
    ("rwkv6_7b", [], None, None),
    ("jamba_1_5_large_398b", [], "decode_attention", None),
]


@pytest.mark.parametrize("arch, flags, kernel, depth", FAMILY_SMOKE,
                         ids=[f"{a}-{len(f)}" for a, f, _, _ in FAMILY_SMOKE])
def test_family_serve_on_a_smoke_model(counting, tmp_path, monkeypatch, arch,
                                       flags, kernel, depth):
    """`family_serve` on each family's SMOKE model: the log passes
    ``check_serve.py``, the decode kernel of its attention layers counted
    once per attention layer a decode forward (none for the ring buffer
    and RWKV), the depth cut applied, Danube's ring at its window."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_serve
    out = chip_smoke.family_serve(
        torch, serve, configs, check_serve, _smoke_mods(),
        phase="rehearsal", argv=_family_argv(arch, *flags), kernel=kernel,
        depth=depth)
    cfg = configs.get_smoke(arch)
    assert out["layers"] == (depth or cfg.num_layers)
    assert configs.get_smoke(arch).num_layers == cfg.num_layers
    assert (out["kernel_launches"] > 0) == (kernel is not None)
    if cfg.sliding_window:
        assert out["cache_rows"] == cfg.sliding_window
    assert set(out["streams"]) == set(range(4))


def test_family_decode_shapes_are_the_serve_phases():
    """The shapes `family_kernel_cases` holds B1-B4 at are those of the
    family serve runs: Phi-3.5-MoE at the Qwen3-14B serve lengths and rows
    with g 4 (paged: pages of 16), Qwen3-MoE with g 16, Jamba SMOKE at the
    CLI's default prompt and generation, Phi-3-mini at g 1 and head_dim
    96 in its four cache layouts, InternVL2 at g 2."""
    import repro_torch.configs as configs
    shapes = [chip_smoke.family_decode_shape(configs, argv)
              for argv in chip_smoke.FAMILY_DECODE]
    serve = (chip_smoke.SERVE_LENGTHS, chip_smoke.SERVE_LEN)
    phi = (32, 8, 128, *serve)
    phi3 = (32, 32, 96, *serve)
    assert shapes == [phi, phi, (64, 4, 128, [129, 132, 134, 136], 144),
                      (4, 2, 16, [17, 22, 25, 28], 36),
                      phi3, phi3, phi3, phi3, (16, 8, 128, *serve)]
    assert "--paged" in chip_smoke.FAMILY_DECODE[1]
    assert chip_smoke.FAMILY_DECODE[1][-2:] == ["--page-size", "16"]
    layouts = [("--paged" in a, chip_smoke._flag(a, "--kv-dtype", "f32"))
               for a in chip_smoke.FAMILY_DECODE[4:8]]
    assert layouts == [(False, "f32"), (True, "f32"), (False, "int8"),
                       (True, "int8")]
    assert chip_smoke.FAMILY_DECODE[8] == chip_smoke.INTERNVL2_ARGV


def _smoke_serve(argv):
    """A card serve run's argv at SMOKE size on the CPU: prompts of 12
    tokens, 4 generated."""
    out = list(argv)
    out[out.index("--prompt-len") + 1] = "12"
    out[out.index("--gen") + 1] = "4"
    return out + SMOKE_CLI


def test_dense_phases_on_smoke_models(counting, tmp_path, monkeypatch,
                                      capsys):
    """`dense_phases` with every serve run's flags at SMOKE size on the
    CPU: each phase runs in order and passes its checks; the layouts'
    kernels are counted once per layer a decode forward, B1 in the
    teacher forcing once per layer a step, the flash entry 3 x layers in
    Qwen2.5's `prefill_vs_forward`, and the int8 run takes the tuner's
    batch."""
    import repro_torch.configs as configs
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import serve, steps
    from repro_torch.models import transformer
    from repro_torch.runtime import lifecycle
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_serve
    real = ops.mha_attention

    def counting_flash(*a, **kw):
        flash.launches += 1
        return real(*a, **kw)
    monkeypatch.setattr(ops, "mha_attention", counting_flash)
    monkeypatch.setattr(chip_smoke, "DENSE_SERVE", [
        (p, _smoke_serve(a), k) for p, a, k in chip_smoke.DENSE_SERVE])
    monkeypatch.setattr(chip_smoke, "PHI3_TF_TOKENS", 12)
    monkeypatch.setattr(chip_smoke, "QWEN25_PREFILL", 40)
    launches = chip_smoke.dense_phases(
        torch, serve, configs, check_serve, steps, transformer, lifecycle,
        _smoke_mods(), card=None, device="cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"phase"')]
    phases = [r["phase"] for r in lines]
    assert phases == [
        "serve_phi3_mini", "phi3_mini_vs_teacher_forcing",
        "serve_phi3_mini_paged", "phi3_mini_paged_vs_contiguous",
        "serve_phi3_mini_int8", "serve_phi3_mini_paged_int8",
        "serve_internvl2", "qwen2_5_32b_memory", "serve_qwen2_5_32b",
        "serve_qwen2_5_32b_paged_bf16", "prefill_qwen2_5_32b"]
    by = {r["phase"]: r for r in lines}
    assert by["serve_phi3_mini_int8"]["batch_source"] == "autotune"
    assert by["serve_phi3_mini_int8"]["predicted_step_us"] > 0
    assert by["serve_phi3_mini"]["batch_source"] == "flag"
    assert by["qwen2_5_32b_memory"]["depth_cut"] is None
    assert by["qwen2_5_32b_memory"]["weight_bytes"] == chip_smoke.param_bytes(
        torch, configs.get_smoke("qwen2_5_32b"))
    layers = configs.get_smoke("phi3_mini_3_8b").num_layers
    assert launches["decode_attention"]["phi3_mini_vs_teacher_forcing"] \
        == 12 * layers
    for name in ("quantized_decode_attention",
                 "paged_quantized_decode_attention"):
        assert all(n > 0 for n in launches[name].values())
    assert set(launches["paged_decode_attention"]) == {
        "serve_phi3_mini_paged", "serve_qwen2_5_32b_paged_bf16"}
    assert launches["flash_attention"] == {"prefill_qwen2_5_32b": 3 * 2}


@pytest.mark.parametrize("arch, tokens, prefill", [
    ("h2o_danube_1_8b", 20, 8), ("rwkv6_7b", 12, 0),
    ("phi3_5_moe_42b", 12, 0), ("jamba_1_5_large_398b", 12, 4)])
def test_decode_vs_forward_on_smoke_models(arch, tokens, prefill):
    """The teacher-forcing phases' check at SMOKE size on the CPU: Danube's
    ring of 8 rows prefilled full and then overwritten 12 times."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.models import transformer
    cfg = dataclasses.replace(configs.get_smoke(arch), capacity_factor=64.0)
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    res = chip_smoke.decode_vs_forward(torch, transformer, cfg, params,
                                       tokens=tokens, prefill=prefill,
                                       device="cpu")
    assert res["ok"], res
    assert res["steps"] == tokens - prefill
    if cfg.sliding_window:
        assert res["cache_rows"] == cfg.sliding_window < tokens


def test_moe_paged_vs_contiguous_on_a_smoke_model(counting, tmp_path,
                                                  monkeypatch):
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    from repro_torch.runtime import lifecycle
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_serve
    argv = _family_argv("phi3_5_moe_42b", "--batch", "4", "--paged",
                        "--page-size", "4")
    run = chip_smoke.family_serve(
        torch, serve, configs, check_serve, _smoke_mods(), phase="r",
        argv=argv, kernel="paged_decode_attention")
    res = chip_smoke.paged_run_vs_contiguous(
        torch, serve, lifecycle, run["cfg"], run["params"], argv,
        run["streams"])
    assert res["ok"]
    assert res["tokens"] == sum(len(t) for t in run["streams"].values())


def test_jamba_chaos_on_a_smoke_model(counting, tmp_path, monkeypatch):
    """The Jamba chaos phase: every smoke class fires, the quarantined
    slots are those ``fired`` names, and the ``kv_corrupt`` hook leaves
    each slot it hit with its Mamba leaves NaN and the other slots'
    finite."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t"))
    sys.path.insert(0, str(REPO / "tools"))
    import check_serve
    argv = chip_smoke.JAMBA_ARGV + chip_smoke.CHAOS_FLAGS + ["--device",
                                                             "cpu"]
    out = chip_smoke.jamba_chaos(torch, serve, configs, check_serve,
                                 _smoke_mods(), phase="r", argv=argv,
                                 layers=1)
    assert out["fired_kinds"] == sorted(chip_smoke.SMOKE_FAULTS)
    assert out["quarantined"] == out["named_by_fired"] != []
    assert out["kv_corrupt"] and all(s["mamba_leaves"] == 14
                                     for s in out["kv_corrupt"])


@pytest.mark.parametrize("arch, feats, toks, batch", [
    ("hubert_xlarge", 40, None, 2), ("internvl2_2b", 8, 16, 1)])
def test_frontend_prefill_on_smoke_models(monkeypatch, arch, feats, toks,
                                          batch):
    """`frontend_prefill` on HuBERT's frames (non-causal) and InternVL2's
    patches ahead of tokens: the flash entry once per layer a step and in
    `prefill_vs_forward`'s three prefill forwards, never in the full
    forwards, and the gates pass."""
    import repro_torch.configs as configs
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = configs.get_smoke(arch)
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    real = ops.mha_attention
    causal = []

    def counting_flash(*a, **kw):
        flash.launches += 1
        causal.append(kw["causal"])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "mha_attention", counting_flash)
    inputs = chip_smoke.frontend_inputs(torch, cfg, feats, toks, batch, "cpu")
    res = chip_smoke.frontend_prefill(torch, steps, transformer,
                                      _smoke_mods(), cfg, params, inputs)
    assert res["ok"], res
    assert res["flash_launches"] == chip_smoke.PREFILL_TIMED * cfg.num_layers
    assert res["vs_forward"]["flash_launches_forward"] == 0
    assert set(causal) == {cfg.causal}


@pytest.fixture
def two_threads():
    """Two intra-op threads for the training rehearsals: the suite runs
    in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_bf16_logit_bound_grows_with_depth_from_the_2_layer_bound():
    """The derived bound is queue C's 3e-2 at the 2 layers it was set at
    and grows as the square root of the residual stream's roundings."""
    rel = chip_smoke.bf16_logit_rel
    assert rel(chip_smoke.SHALLOW) == pytest.approx(3e-2)
    assert rel(8) == pytest.approx(3e-2 * (17 / 5) ** 0.5)
    assert rel(24) == pytest.approx(0.0939, abs=1e-4)
    assert rel(40) == pytest.approx(0.1207, abs=1e-4)
    assert rel(64) == pytest.approx(0.152, abs=5e-4)   # Qwen2.5-32B
    assert all(rel(n) < rel(n + 1) for n in range(1, 100))


def test_near_tie_reports_the_gap_beside_both_bounds(two_threads):
    """Where a resumed stream parts, `_near_tie` reports the two tokens'
    gap as a share of max |logit| beside the rule's 3e-2 and the bound
    derived at the model's depth, and decides on 3e-2."""
    import numpy as np

    import repro_torch.configs as configs
    from repro_torch.launch import serve
    cfg = configs.get_smoke("qwen3_14b")
    prompt = list(np.random.default_rng(0).integers(0, cfg.vocab_size, 6))
    want, got = [3, 5, 7, 9], [3, 5, 8, 9]
    res = chip_smoke._near_tie(torch, serve, cfg, "cpu", torch.float32,
                               prompt, want, got)
    assert res["position"] == 2 and res["layers"] == cfg.num_layers
    assert res["gap_rel"] == pytest.approx(res["gap"]
                                           / res["max_abs_logit"])
    assert res["bound_rel"] == serve.BF16_LOGIT_REL == 3e-2
    assert res["derived_bound_rel"] == serve.bf16_logit_rel(cfg.num_layers)
    assert res["near_tie"] == (res["gap_rel"] < 3e-2)


def test_prefill_vs_forward_records_every_depth(two_threads, monkeypatch):
    """At a depth past ``MID_DEPTH`` the phase compares the two bf16 paths
    at 2, 8 and all layers of the same weights, each row beside the
    depth's derived bound, and gates on it."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.kernels.attention import decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.runtime import quantize
    cfg = dataclasses.replace(configs.get_smoke("qwen3_14b"), num_layers=10)
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    real = ops.mha_attention

    def counting(*a, **kw):
        flash.launches += 1
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mha_attention", counting)
    res = chip_smoke.prefill_vs_forward(
        torch, steps, transformer, (decode, decode_int8, quantize, flash),
        cfg, params, 40)
    assert res["ok"], res
    assert [d["layers"] for d in res["depths"]] == [2, 8, 10]
    for d in res["depths"]:
        assert d["derived_bound"] == pytest.approx(
            chip_smoke.bf16_logit_rel(d["layers"]) * d["max_abs_logit"])
    assert res["depths"][-1]["bf16_prefill_vs_forward"] == \
        res["bf16_max_abs_err"]


@pytest.mark.parametrize("phase", ["quickstart", "spmv_pipeline"])
def test_design_flow_phase_on_the_cpu(phase):
    res = chip_smoke.design_flow_phase(torch, _smoke_mods(), phase,
                                       device="cpu")
    assert res["ok"], res
    assert res["launches"] == dict.fromkeys(
        ("blocked_matmul", "ell_spmv", "ell_spmv_blocked"), 0)


def test_design_flow_phase_fails_a_kernel_that_did_not_launch(monkeypatch):
    """On a card the phase requires the example's kernels to have
    launched: an example whose results pass but that launched nothing
    fails it."""
    from repro_torch.examples import quickstart

    def run(device):
        print("the flow ran")
        return {"matmul": {"ok": True}, "spmv": {"ok": True}}

    monkeypatch.setattr(quickstart, "run", run)
    res = chip_smoke.design_flow_phase(torch, _smoke_mods(), "quickstart",
                                       device="cuda")
    assert not res["ok"] and res["last_line"] == "the flow ran"


def test_train_step_parity_on_the_cpu(two_threads):
    import repro_torch.configs as configs
    res = chip_smoke.train_step_parity(torch, configs, _smoke_mods(),
                                       device="cpu")
    assert res["ok"], res
    assert [r["arch"] for r in res["rows"]] == ["qwen3-14b-smoke",
                                                "phi3.5-moe-smoke"]
    for r in res["rows"]:
        assert r["step_is_its_parts_bitwise"]
        assert r["step_params_max_abs_err"] == 0.0
        assert 0 <= r["step_params_below_floor"] < r["step_params"]


def test_train_step_parity_fails_a_step_that_is_not_its_parts(
        two_threads, monkeypatch):
    """A second side's train step that moves one parameter 1e-4 past the
    update (far above a gradient's floor) fails both the bitwise check of
    the step against its parts and the 1e-5 check against the first
    side's step."""
    import repro_torch.configs as configs
    from repro_torch.launch import steps
    real = steps.make_train_step
    calls = []

    def make(cfg, opt_cfg, **kw):
        step = real(cfg, opt_cfg, **kw)
        calls.append(cfg.name)
        if len(calls) % 2:                   # the first side's, as it is
            return step

        def nudged(state, batch):
            state, m = step(state, batch)
            state["params"]["final_norm"]["scale"][0] += 1e-4
            return state, m
        return nudged

    monkeypatch.setattr(steps, "make_train_step", make)
    res = chip_smoke.train_step_parity(torch, configs, _smoke_mods(),
                                       device="cpu", archs=("qwen3_14b",))
    (row,) = res["rows"]
    assert not res["ok"]
    assert not row["step_is_its_parts_bitwise"]
    assert row["step_params_max_abs_err"] > chip_smoke.TRAIN_STEP_ABS


def test_train_danube_on_a_smoke_model(two_threads):
    import dataclasses

    import repro_torch.configs as configs
    cfg = dataclasses.replace(configs.get_smoke("h2o_danube_1_8b"),
                              remat="full")
    res = chip_smoke.train_danube(torch, configs, _smoke_mods(), "cpu",
                                  cfg=cfg, shape=(2, 16), timed=2,
                                  device="cpu")
    assert res["ok"], res
    assert len(res["step_ms"]) == 2 and len(res["losses"]) == 3
    assert res["bound_ms"] == pytest.approx(
        8 * cfg.param_count() * 32 / 989e12 * 1e3)
    assert res["flash_launches"] == 0
    # through the trainer CLI's mesh: a one-rank gloo group on the CPU
    assert res["mesh"] == {"data": 1, "model": 1}
    assert res["backend"] == "gloo"
    assert res["all_reduce_ms"] > 0 and res["compressed_psum_ms"] > 0
    assert res["grad_bytes"] == 4 * cfg.param_count()
    # one more step counted on the CPU and on meta in a process of its own
    # (a one-rank fake group): equal FLOPs, collectives and bytes
    counts = res["dryrun_counts"]
    assert counts["ok"], counts
    assert counts["flops_equal"] and counts["collectives_equal"]
    assert counts["bytes_rel_diff"] == 0.0 and counts["differing_ops"] == 0
    # one all-reduce a gradient leaf and one of the loss
    assert counts["card"]["collective_counts"]["all-reduce"] > 2
    # read around the counted step: the f32 training never reaches B5
    assert counts["launches"] == {"flash_attention": 0}
    assert counts["card"]["flops"] > 0 and counts["bound_ms"] > 0


def test_train_mesh_parity_on_a_smoke_model(two_threads):
    import repro_torch.configs as configs
    res = chip_smoke.train_mesh_parity(
        torch, configs, _smoke_mods(), "cpu",
        cfg=configs.get_smoke("h2o_danube_1_8b"), shape=(2, 16),
        device="cpu")
    assert res["ok"], res
    assert res["backend"] == "gloo"
    assert 0 < res["compressed_worst_ratio_to_half_scale"] <= 1


def test_train_mesh_parity_catches_a_mesh_step_that_differs(two_threads,
                                                            monkeypatch):
    """A mesh step whose gradients differ in one element from the plain
    step's fails the phase."""
    import repro_torch.configs as configs
    from repro_torch.launch import steps
    real = steps.data_parallel_step

    def nudged(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch, return_grads=False):
            state, m, g = step(state, batch, return_grads=True)
            g["final_norm"]["scale"][0] += 1e-6
            return (state, m, g) if return_grads else (state, m)
        return run

    monkeypatch.setattr(steps, "data_parallel_step", nudged)
    res = chip_smoke.train_mesh_parity(
        torch, configs, _smoke_mods(), "cpu",
        cfg=configs.get_smoke("h2o_danube_1_8b"), shape=(2, 16),
        device="cpu")
    assert not res["ok"] and not res["grads_bitwise"]


def test_moe_expert_parallel_on_a_smoke_model(two_threads):
    """The phase at Phi-3.5-MoE's SMOKE width: the serve CLI's rules on
    the CPU (gloo), the exchange equal to its plain two-stage version,
    and the repeated token's experts overflowing."""
    import repro_torch.configs as configs
    res = chip_smoke.moe_expert_parallel(
        torch, configs, "cpu", device="cpu",
        cfg=configs.get_smoke("phi3_5_moe_42b"), tokens=(4, 16), repeat=14)
    assert res["ok"], res
    assert res["send_stage_dropped"] == 0
    assert res["expert_stage_dropped"] > 0
    assert sum(res["items_per_expert"]) == res["items"] == 4 * 16 * 2


def test_tensor_parallel_parts_on_smoke_models(tmp_path):
    """The ``tensor_parallel`` phase's decode layouts, RWKV6 and Mamba
    parts on two gloo ranks on the CPU at SMOKE width: Qwen3-14B's f32
    and int8 caches split by sequence and its paged bf16 and int8 pools
    whole (every paged call on a strided view of the cache's own pool;
    the CPU's plain versions launch no kernel, where the card's phase
    holds each part to its kernel once a layer a step), RWKV6's train step,
    prefill and decode, and Mamba's forward, gradients and decode state,
    each as the phase gates it on the card."""
    import _torch_ranks
    res = _torch_ranks.spawn("chip_tp", 2, tmp_path,
                             {"shape": (2, 16), "prefill": 24}, timeout=240)
    for rank in res:
        for part, rec in rank.items():
            assert rec["ok"], (part, rec)
        layouts = ("qwen3_decode", "qwen3_decode_int8",
                   "qwen3_decode_paged_bf16", "qwen3_decode_paged_int8")
        assert [rank[p]["kv_split"] for p in layouts] == \
            [True, True, False, False]
        assert all(rank[p]["launches"] == {} for p in layouts)
        assert rank["qwen3_decode_paged_int8"]["pool_views"]["calls"] == \
            2 * chip_smoke.TP_DECODE_STEPS
        assert rank["mamba"]["split"] == 2
        assert rank["mamba"]["rank_d_in"] == 64


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_mamba_parallel_fails_gradients_rounded_on_each_rank(tmp_path,
                                                             device):
    """`mamba_parallel`'s limits pass the sound split and fail one that
    rounds each rank's part of the gradients entering the scan to bf16
    before the ranks' sum: at SMOKE width on the CPU (where the fault
    shows on x_proj's own error), at Jamba-1.5-Large's width on a card.
    Prints both splits' errors."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import _torch_ranks
    keys = ("grad_rel_err", "dx_rel_err", "grad_rel_err_by_leaf", "ok")
    res = {}
    for fault in (False, True):
        res[fault] = _torch_ranks.spawn(
            "chip_mamba", 2, tmp_path,
            {"device": device, "round_on_each_rank": fault}, timeout=240)
        print(json.dumps({"device": device, "round_on_each_rank": fault,
                          "ranks": [{k: r[k] for k in keys}
                                    for r in res[fault]]}))
    assert all(r["ok"] for r in res[False]), res[False]
    assert not any(r["ok"] for r in res[True]), res[True]


def test_train_resume_cut_on_a_smoke_model(two_threads, tmp_path):
    import repro_torch.configs as configs
    res = chip_smoke.train_resume_cut(
        torch, configs, _smoke_mods(),
        cfg=configs.get_smoke("h2o_danube_1_8b"), shape=(2, 16),
        device="cpu", state_root=tmp_path)
    assert res["ok"], res
    assert res["fault_steps_run"] == list(range(10))
    assert res["restored_at"] == [4] and res["fault_fired_at"] == [4]
    assert not (tmp_path / "train_resume_danube_cut").exists()


def test_train_resume_cut_catches_a_state_that_differs(two_threads, tmp_path,
                                                       monkeypatch):
    """A replay that is not bit for bit (here: one parameter nudged after
    the restore) fails the phase."""
    import repro_torch.configs as configs
    from repro_torch.checkpoint import CheckpointManager
    real = CheckpointManager.restore

    def nudged(self, step, like, device=None):
        state, meta = real(self, step, like, device)
        state["params"]["final_norm"]["scale"][0] += 1e-3
        return state, meta

    monkeypatch.setattr(CheckpointManager, "restore", nudged)
    res = chip_smoke.train_resume_cut(
        torch, configs, _smoke_mods(),
        cfg=configs.get_smoke("h2o_danube_1_8b"), shape=(2, 16),
        device="cpu", state_root=tmp_path)
    assert not res["ok"]
    assert not res["replay_bitwise"] and not res["fault_bitwise"]


def test_train_cli_phase_on_the_cpu(two_threads, tmp_path, monkeypatch):
    """The card run's two processes and checks, at a smaller batch."""
    monkeypatch.setattr(chip_smoke, "TRAIN_CLI", [
        "--arch", "qwen3_14b", "--smoke", "--batch", "2", "--seq", "16"])
    res = chip_smoke.train_cli(torch, cli=("--device", "cpu"),
                               state_root=tmp_path)
    assert res["ok"], res
    assert [r["summary"]["final_ckpt"] for r in res["runs"]] == [30, 40]
    assert all(r["tokens_per_s"] > 0 for r in res["runs"])


def tiny_lm(hundred_m: bool):
    """A stand-in for the example's configs on the CPU: the same family
    and code path at a width a test affords."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="lm-tiny", family="dense", num_layers=2,
                       d_model=64, d_ff=128, vocab_size=256, num_heads=4,
                       num_kv_heads=2)


def test_train_lm_phase_on_the_cpu(two_threads, tmp_path, monkeypatch):
    from repro_torch.examples import train_lm
    monkeypatch.setattr(train_lm, "model_config", tiny_lm)
    res = chip_smoke.train_lm_phase(
        torch, argv=["--device", "cpu", "--steps", "20", "--seq", "32"],
        state_root=tmp_path)
    assert res["ok"], res
    assert res["first_line"].startswith("training lm-tiny")
    assert not (tmp_path / "train_lm").exists()


# -- compile analysis: the dry run's counts and cells -------------------------

def _rec(ops):
    flops = sum(v[1] for v in ops.values())
    nbytes = sum(v[2] for v in ops.values())
    return {"flops": flops, "bytes_accessed": nbytes, "ops": ops,
            "collective_counts": {"all-reduce": 1},
            "collectives": {"all-reduce": 8.0}}


def test_compare_counts_names_the_operator_that_differs():
    a = _rec({"aten.mm": [1, 10.0, 100], "aten.add": [2, 0.0, 1000]})
    assert chip_smoke.compare_counts(a, a)["ok"]
    b = _rec({"aten.mm": [1, 10.0, 100], "aten.add": [2, 0.0, 1005]})
    res = chip_smoke.compare_counts(a, b)
    assert res["ok"] and res["differing"] == {
        "aten.add": {"card": [2, 0.0, 1000], "meta": [2, 0.0, 1005]}}
    c = _rec({"aten.mm": [1, 12.0, 100], "aten.add": [2, 0.0, 1000]})
    assert not chip_smoke.compare_counts(a, c)["ok"]
    d = _rec({"aten.mm": [1, 10.0, 100], "aten.add": [2, 0.0, 2000]})
    assert chip_smoke.compare_counts(a, d)["bytes_rel_diff"] > 0.01
    assert not chip_smoke.compare_counts(a, d)["ok"]
    e = {**a, "collective_counts": {"all-reduce": 2}}
    assert not chip_smoke.compare_counts(a, e)["collectives_equal"]


def test_decode_counts_on_a_smoke_model(two_threads):
    """A ring-buffer model decodes on the plain path on both sides, so
    the CPU's counts equal meta's exactly; no decode kernel launched."""
    import numpy as np

    import repro_torch.configs as configs
    from repro_torch.launch import serve
    cfg = configs.get_smoke("h2o_danube_1_8b")
    server = serve.Server(cfg, 2, 24, device="cpu")
    rng = np.random.default_rng(0)
    server.admit_chunk([(s, s, rng.integers(0, cfg.vocab_size, 6), 4)
                        for s in range(2)])
    res = chip_smoke.decode_counts(torch, _smoke_mods(), server, 1.0)
    assert res["flops_equal"] and res["collectives_equal"]
    assert res["bytes_rel_diff"] == 0.0 and res["differing_ops"] == 0
    assert res["launches"] == {"decode_attention": 0} and not res["ok"]
    assert res["card"]["flops"] > 0 and res["bound_ms"] > 0


def test_prefill_counts_name_the_kernel_the_cpu_does_not_run(two_threads):
    """On the CPU the prefill runs the flash kernel's plain version, whose
    operators the counter sees; on meta the kernel charges its cost.  So
    the two differ, and the kernel is named."""
    import repro_torch.configs as configs
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = configs.get_smoke("qwen3_14b")
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    res = chip_smoke.prefill_counts(torch, steps, _smoke_mods(), cfg,
                                    params, 1.0, seq=64)
    assert res["meta"]["kernels"]["flash_attention"]["calls"] == \
        cfg.num_layers
    assert "flash_attention" not in res["card"]["kernels"]
    assert "kernel:flash_attention" in res["differing"]
    assert not res["ok"]


def test_dryrun_cells_on_the_cpu(tmp_path):
    """Two cells through the dry run's CLI, each ok with its roofline
    row: a decode over a cache split by sequence, and the MoE train cell,
    its experts trained over the model axis."""
    res = chip_smoke.dryrun_cells(
        cells=[("qwen3_14b", "decode_32k"), ("qwen3_moe_235b", "train_4k")],
        out=tmp_path / "dryrun", timeout=300)
    assert res["ok"], res
    for cell in res["cells"]:
        assert cell["status"] == "ok" and "roofline" in cell
    assert res["csv"][0].startswith("roofline.qwen3_14b.decode_32k.single,")
    assert "| qwen3_moe_235b | train_4k |" in res["table"]


def test_prefill_vs_forward_reads_40_layers_on_a_deeper_model(two_threads,
                                                              monkeypatch):
    """On a model deeper than ``DEEP_DEPTH`` (Qwen2.5-32B's SMOKE config
    at 42 layers) the bf16 bound is read at 2, 8, 40 and all layers."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.kernels.attention import decode_int8
    from repro_torch.kernels.attention import kernel as flash
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.runtime import quantize
    cfg = dataclasses.replace(configs.get_smoke("qwen2_5_32b"), num_layers=42)
    params = transformer.init(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.bfloat16)
    real = ops.mha_attention

    def counting(*a, **kw):
        flash.launches += 1
        return real(*a, **kw)

    monkeypatch.setattr(ops, "mha_attention", counting)
    res = chip_smoke.prefill_vs_forward(
        torch, steps, transformer, (decode, decode_int8, quantize, flash),
        cfg, params, 24)
    assert res["ok"], res
    assert [d["layers"] for d in res["depths"]] == [2, 8, 40, 42]


def _bf16_bytes(torch, tree):
    from repro_torch import tree as tree_lib
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree))


@pytest.mark.parametrize("arch", ["qwen2_5_32b", "phi3_mini_3_8b",
                                  "internvl2_2b", "jamba_1_5_large_398b"])
def test_param_bytes_are_the_init_trees(arch):
    """`param_bytes` at SMOKE width is exactly the bytes of
    `transformer.init`'s bf16 tree (its f32 leaves at 4 bytes)."""
    import repro_torch.configs as configs
    from repro_torch.models import transformer
    cfg = configs.get_smoke(arch)
    tree = transformer.init(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.bfloat16)
    assert chip_smoke.param_bytes(torch, cfg) == _bf16_bytes(torch, tree)


def test_param_bytes_at_full_width():
    """Qwen2.5-32B's bf16 tree by hand (65.5 GB: 64 layers of 487.6 M
    parameters, an untied embedding and head of 152,064 x 5,120, f32
    norms) and one period of 8 Jamba-1.5-Large layers (about 90 GB, more
    than one card)."""
    import dataclasses

    import repro_torch.configs as configs
    cfg = configs.get("qwen2_5_32b")
    d, ff, kv = cfg.d_model, cfg.d_ff, cfg.kv_dim
    layer = 2 * (2 * d * d + 2 * d * kv + d + 2 * kv + 3 * d * ff) + 4 * 2 * d
    want = 64 * layer + 2 * 2 * cfg.vocab_size * d + 4 * d
    assert chip_smoke.param_bytes(torch, cfg) == want
    assert want == pytest.approx(65.5e9, rel=1e-3)
    jamba = configs.get("jamba_1_5_large_398b")
    period = dataclasses.replace(jamba, num_layers=jamba.attn_period)
    assert 85e9 < chip_smoke.param_bytes(torch, period) < 95e9


def test_fitting_depth_cuts_only_what_does_not_fit():
    """Qwen2.5-32B's 64 layers, an f32 cache of the serve runs and the
    reserve fit in an 80 GB card's free memory (no cut); in 40 GB the
    depth is the deepest whose bytes fit."""
    import dataclasses

    import repro_torch.configs as configs
    from repro_torch.models import transformer
    cfg = configs.get("qwen2_5_32b")

    def need(n):
        c = dataclasses.replace(cfg, num_layers=n)
        cache = transformer.cache_init(c, 4, chip_smoke.SERVE_LEN,
                                       dtype=torch.float32, device="meta")
        return (chip_smoke.param_bytes(torch, c)
                + chip_smoke.state_bytes(torch, cache)
                + chip_smoke.QWEN25_RESERVE)
    assert chip_smoke.fitting_depth(torch, cfg, 84e9, batch=4,
                                    rows=chip_smoke.SERVE_LEN) is None
    n = chip_smoke.fitting_depth(torch, cfg, 40e9, batch=4,
                                 rows=chip_smoke.SERVE_LEN)
    assert need(n) <= 40e9 < need(n + 1)
