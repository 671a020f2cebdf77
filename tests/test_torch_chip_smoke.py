"""`chip_smoke.py` on a host without a card: its per-row tolerance check
and its refusal to run.  The script itself drives the card."""

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
    """The shapes `family_kernel_cases` holds B1 and B2 at are those of the
    family serve runs: Phi-3.5-MoE at the Qwen3-14B serve lengths and rows
    with g 4 (paged: pages of 16), Qwen3-MoE with g 16, Jamba SMOKE at the
    CLI's default prompt and generation."""
    import repro_torch.configs as configs
    shapes = [chip_smoke.family_decode_shape(configs, argv)
              for argv in chip_smoke.FAMILY_DECODE]
    phi = (32, 8, 128, chip_smoke.SERVE_LENGTHS, chip_smoke.SERVE_LEN)
    assert shapes == [phi, phi, (64, 4, 128, [129, 132, 134, 136], 144),
                      (4, 2, 16, [17, 22, 25, 28], 36)]
    assert "--paged" in chip_smoke.FAMILY_DECODE[1]
    assert chip_smoke.FAMILY_DECODE[1][-2:] == ["--page-size", "16"]


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
    res = chip_smoke.moe_paged_vs_contiguous(
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
