"""The compile-analysis slice of the port against the JAX package's:
`core.estimate`, `core.hlo_stats` (its HLO reader and `count_step`), the
kernel wrappers' meta branch and charges, `launch.dryrun`,
`launch.sweep` and `benchmarks.roofline_report`.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported,
and its multi-device HLO needs forced host devices, so both run in a
subprocess with a time limit of its own.  The port's dry runs make a
``fake`` process group in the test's process; a fixture destroys it.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

import repro.configs as ref_configs
from repro.core import estimate as ref_estimate
from repro.core import hlo_stats as ref_hlo
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.core import cost_model, estimate, hlo_stats
from repro_torch.kernels.attention import decode, decode_int8
from repro_torch.kernels.attention import kernel as flash
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")


@pytest.fixture
def no_group():
    """No process group before the test (another test file of this worker
    may have left its one-rank group) and none after it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _run(snippet: str, *args, timeout=120, env=None):
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(snippet), *map(str, args)],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu", **(env or {})})
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


# -- core.estimate ------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.list_archs())
@pytest.mark.parametrize("kind", KINDS)
def test_bytes_model_and_recurrence_equal_the_reference(arch, kind):
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    kw = dict(batch=8, seq=1 if kind == "decode" else 4096, kind=kind,
              param_bytes=2, moment_bytes=1.03,
              cache_len=32768 if kind == "decode" else 0)
    assert estimate.bytes_model(cfg, **kw) == ref_estimate.bytes_model(
        rcfg, **kw)
    assert (estimate.bytes_model(cfg, **kw, loss_fused_kernel=True,
                                 flash_block_q=128)
            == ref_estimate.bytes_model(rcfg, **kw, loss_fused_kernel=True,
                                        flash_block_q=128))
    for c, r in ((cfg, rcfg), (dataclasses.replace(cfg, remat="full"),
                               dataclasses.replace(rcfg, remat="full"))):
        assert (estimate.recurrence_correction(c, 12345.0, kind)
                == ref_estimate.recurrence_correction(r, 12345.0, kind))


# -- core.hlo_stats: the HLO reader ---------------------------------------------

SYNTHETIC_HLO = """
HloModule m
ENTRY %main (p0: f32[128,64]) -> f32[128,64] {
  %p0 = f32[128,64]{1,0} parameter(0)
  %ar = f32[128,64]{1,0} all-reduce(%p0), replica_groups={}
  %ag = f32[256,64]{1,0} all-gather(%ar), dimensions={0}
  %a2a = f32[128,64]{1,0} all-to-all(%ar), dimensions={0}
  ROOT %out = f32[128,64]{1,0} add(%ar, %a2a)
}
"""


@pytest.mark.parametrize("shape", ["f32[256,1024]{1,0}", "bf16[8]", "pred[]",
                                   "(f32[2,2], s32[4])", "token[]",
                                   "u16[3,5]", "f8e4m3[7]"])
def test_shape_bytes_equal_the_reference(shape):
    assert hlo_stats.shape_bytes(shape) == ref_hlo.shape_bytes(shape)


def test_collectives_of_the_synthetic_module_equal_the_reference():
    got = hlo_stats.collect_collectives(SYNTHETIC_HLO)
    want = ref_hlo.collect_collectives(SYNTHETIC_HLO)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.bytes_by_op["all-gather"] == 128 * 64 * 4  # the operand
    assert got.summary() == want.summary()


JAX_COLLECTIVES = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
mesh = Mesh(jax.devices()[:4], ("x",))
def f(a):
    return jax.lax.psum(a, "x"), jax.lax.all_gather(a, "x")
g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("x"),
                          out_specs=(P(), P()), check_vma=False))
print(g.lower(jax.ShapeDtypeStruct((64, 32), jnp.float32))
       .compile().as_text())
"""


def test_collectives_of_a_jax_module_equal_the_reference():
    """The HLO of an all-reduce and an all-gather over 4 host devices."""
    text = _run(JAX_COLLECTIVES)
    got = hlo_stats.collect_collectives(text)
    want = ref_hlo.collect_collectives(text)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert {"all-reduce", "all-gather"} <= set(got.count_by_op)
    assert got.bytes_by_op["all-gather"] == 16 * 32 * 4


# -- core.hlo_stats: count_step ------------------------------------------------

def _hand(a, b):
    return torch.relu(a @ b)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_count_step_counts_a_matmul_by_hand(device):
    m, k, n = 48, 32, 16
    a = torch.ones((m, k), device=device)
    b = torch.ones((k, n), device=device)
    c = hlo_stats.count_step(_hand, a, b)
    assert c.flops == 2 * m * n * k
    # mm reads a and b and writes (m, n); relu reads and writes (m, n)
    assert c.bytes_accessed == 4 * (m * k + k * n + m * n + 2 * m * n)
    assert c.argument_bytes == 4 * (m * k + k * n)
    assert c.peak_bytes == c.argument_bytes + 2 * 4 * m * n
    assert c.ops["aten.mm"] == [1, 2.0 * m * n * k, 4 * (m * k + k * n
                                                       + m * n)]
    assert c.collectives.total_bytes == 0 and not c.kernels
    assert tuple(c.result.shape) == (m, n)


def test_count_step_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    a = torch.randn(8, 16, 32, requires_grad=True)
    w = torch.randn(32, 24)

    def step(a, w):
        y = torch.einsum("bsd,de->bse", a, w).sum()
        return torch.autograd.grad(y, a)[0]

    with FlopCounterMode(display=False) as fm:
        step(a, w)
    assert hlo_stats.count_step(step, a, w).flops == fm.get_total_flops()


def test_count_step_counts_collectives_by_their_operand(no_group):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    x = torch.ones(10, 4)

    def step(x):
        dist.all_reduce(x)
        out = [torch.empty_like(x)]
        dist.all_gather(out, x)
        return out[0]

    c = hlo_stats.count_step(step, x)
    assert c.collectives.count_by_op == {"all-reduce": 1, "all-gather": 1}
    assert c.collectives.bytes_by_op == {"all-reduce": 160,
                                         "all-gather": 160}
    torch.testing.assert_close(c.result, x)


# -- the kernel wrappers on meta ------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,dh,causal,window", [
    (torch.bfloat16, 128, True, None), (torch.bfloat16, 80, True, 64),
    (torch.float32, 16, False, None)])
def test_flash_meta_branch_charges_the_active_pairs(dtype, dh, causal,
                                                    window):
    b, sq, sk, hq, hkv = 2, 300, 260, 8, 2
    q, k, v = _meta(b, sq, hq, dh, dtype=dtype), \
        _meta(b, sk, hkv, dh, dtype=dtype), _meta(b, sk, hkv, dh, dtype=dtype)
    before = flash.launches
    c = hlo_stats.count_step(
        lambda q, k, v: flash.flash_attention(q, k, v, scale=0.1,
                                              causal=causal, window=window),
        q, k, v)
    assert c.result.device.type == "meta" and c.result.shape == q.shape
    assert c.result.dtype == dtype and flash.launches == before
    bq, bk = flash.tile(dtype, dh)
    active, _ = cost_model.attention_active_block_pairs(
        sq, sk, bq, bk, causal=causal, window=window)
    elt = q.element_size()
    want = (4.0 * dh * hq * b * active * bq * bk,
            float(elt * (2 * q.numel() + k.numel() + v.numel())))
    assert flash.cost(q, k, v, causal=causal, window=window) == want
    assert c.kernels == {"flash_attention": {"calls": 1, "flops": want[0],
                                             "bytes": want[1]}}
    assert c.flops == want[0]


def test_flash_charge_of_a_32k_causal_prefill():
    """Qwen3-14B at 32k, causal, the wgmma tile: about 1.10e13
    operations (the 128-row tiles on the diagonal count whole), 11.16 ms
    at 989 TFLOP/s."""
    q, k = _meta(1, 32768, 40, 128), _meta(1, 32768, 8, 128)
    ops, _ = flash.cost(q, k, k, causal=True)
    assert ops == 4 * 128 * 40 * (256 * 257 // 2) * 128 * 128
    assert 1.10e13 < ops < 1.105e13
    assert 11.1 < ops / 989e12 * 1e3 < 11.2


def test_decode_meta_branches_charge_every_row():
    b, hq, hkv, dh, rows = 3, 8, 2, 16, 40
    q = _meta(b, hq, dh)
    k, v = _meta(b, rows, hkv, dh), _meta(b, rows, hkv, dh)
    kq, vq = (_meta(b, rows, hkv, dh, dtype=torch.int8) for _ in range(2))
    ks, vs = (_meta(b, rows, hkv, dtype=torch.float32) for _ in range(2))
    pool = _meta(7, 8, hkv, dh, dtype=torch.float32)
    qpool = _meta(7, 8, hkv, dh, dtype=torch.int8)
    spool = _meta(7, 8, hkv, dtype=torch.float32)
    pages = torch.empty((b, 5), dtype=torch.int32, device="meta")
    lengths = torch.empty((b,), dtype=torch.int32, device="meta")
    qb = q.numel() * 2
    cases = [
        ("decode_attention", rows, hkv * dh * 2 * 2,
         lambda: decode.gqa_decode_attention(q, k, v, length=lengths)),
        ("paged_decode_attention", 40, hkv * dh * 4 * 2,
         lambda: decode.paged_gqa_decode_attention(q, pool, pool, pages,
                                                   length=lengths)),
        ("quantized_decode_attention", rows, hkv * (dh + 4) * 2,
         lambda: decode_int8.quantized_gqa_decode_attention(
             q, kq, ks, vq, vs, length=lengths)),
        ("paged_quantized_decode_attention", 40, hkv * (dh + 4) * 2,
         lambda: decode_int8.paged_quantized_gqa_decode_attention(
             q, qpool, spool, qpool, spool, pages, length=lengths)),
    ]
    counts = (decode.launches, decode.paged_launches, decode_int8.launches,
              decode_int8.paged_launches)
    for name, rows_read, row_bytes, call in cases:
        c = hlo_stats.count_step(call)
        assert c.result.shape == q.shape and c.result.device.type == "meta"
        want = {"calls": 1, "flops": 4.0 * dh * hq * b * rows_read,
                "bytes": 2.0 * qb + b * rows_read * row_bytes}
        assert c.kernels == {name: want}, name
    assert counts == (decode.launches, decode.paged_launches,
                      decode_int8.launches, decode_int8.paged_launches)
    # no counter: the meta branch still answers
    assert decode.gqa_decode_attention(q, k, v, length=3).shape == q.shape


def test_cpu_results_are_unchanged_under_the_counter():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, generator=g)
    k, v = torch.randn(2, 9, 2, 16, generator=g), \
        torch.randn(2, 9, 2, 16, generator=g)
    want = decode.gqa_decode_attention(q, k, v, length=torch.tensor([3, 9]))
    c = hlo_stats.count_step(
        lambda: decode.gqa_decode_attention(q, k, v,
                                            length=torch.tensor([3, 9])))
    assert torch.equal(c.result, want) and not c.kernels
    qf = torch.randn(1, 20, 4, 16, generator=g)
    kf = torch.randn(1, 20, 2, 16, generator=g)
    c = hlo_stats.count_step(
        lambda: flash.flash_attention(qf, kf, kf, scale=0.25))
    assert torch.equal(c.result, flash.flash_attention(qf, kf, kf,
                                                       scale=0.25))
    assert not c.kernels


# -- launch.dryrun ------------------------------------------------------------

def _smoke(arch, layers):
    return dataclasses.replace(configs.get_smoke(arch), num_layers=layers)


@pytest.mark.parametrize("arch,layers,kind", [
    ("qwen3_14b", 5, "train"), ("phi3_5_moe_42b", 5, "prefill"),
    ("jamba_1_5_large_398b", 24, "prefill"), ("rwkv6_7b", 5, "train"),
    ("qwen3_14b", 5, "decode"), ("rwkv6_7b", 5, "decode")])
def test_extrapolated_probes_equal_the_full_depth_count(no_group, arch,
                                                        layers, kind):
    """On a (4, 4) fake mesh (the SMOKE MoE's 4 experts split over the
    model axis).  FLOPs and collectives extrapolate exactly; so do the
    bytes, but for a train step's: at depth 1 some of its shard slices
    are contiguous, so their copies (`aten.clone`) vanish, a few in a
    thousand of the step's bytes."""
    cfg = _smoke(arch, layers)
    shape = ShapeSpec("t", kind, 64 if kind == "decode" else 8, 32)
    mesh = make_mesh((4, 4), ("data", "model"), device_type="meta")
    rules = specs.rules_for(mesh, shape)
    fn, args = dryrun._rank_step(cfg, shape, mesh, rules)
    full = dryrun._counted_stats(hlo_stats.count_step(fn, *args), 16)
    ext = dryrun.probe_cell(cfg, shape, mesh, rules)
    assert ext["flops"] == pytest.approx(full["flops"], rel=1e-12)
    assert ext["bytes_accessed"] == pytest.approx(
        full["bytes_accessed"], rel=1e-3 if kind == "train" else 1e-12)
    assert set(ext["collectives"]) == set(full["collectives"])
    for op, n in full["collectives"].items():
        assert ext["collectives"][op] == pytest.approx(n, rel=1e-12)
    assert full["flops"] > 0


REF_FUNCTIONS = """
import json, sys
import repro.configs as configs
from repro.configs.shapes import SHAPES
from repro.core import cost_model
from repro.launch import dryrun
s1 = {"flops": 10.0, "bytes_accessed": 7.0, "collectives": {"all-gather": 3.0}}
s2 = {"flops": 16.0, "bytes_accessed": 9.0,
      "collectives": {"all-gather": 5.0, "all-reduce": 1.0}}
out = {"variants": dryrun.VARIANTS,
       "scale": dryrun._scale_stats(s1, s2, 2, 4, 40),
       "probe_layers": {a: dryrun._probe_layers(configs.get(a))
                        for a in configs.list_archs()},
       "model_flops": {}}
for a in configs.list_archs():
    cfg = configs.get(a)
    n = cfg.active_param_count()
    for name, shape in SHAPES.items():
        if shape.kind == "decode":
            t, f = shape.global_batch, cost_model.model_flops_decode(
                n, shape.global_batch)
        else:
            t = shape.global_batch * shape.seq_len
            f = (cost_model.model_flops_train(n, t) if shape.kind == "train"
                 else cost_model.model_flops_decode(n, t))
        out["model_flops"][f"{a}/{name}"] = [t, f]
print(json.dumps(out))
"""


def test_dryrun_functions_equal_the_reference():
    ref = json.loads(_run(REF_FUNCTIONS).strip().splitlines()[-1])
    assert ref["variants"] == json.loads(json.dumps(dryrun.VARIANTS))
    s1 = {"flops": 10.0, "bytes_accessed": 7.0,
          "collectives": {"all-gather": 3.0}}
    s2 = {"flops": 16.0, "bytes_accessed": 9.0,
          "collectives": {"all-gather": 5.0, "all-reduce": 1.0}}
    assert dryrun._scale_stats(s1, s2, 2, 4, 40) == ref["scale"]
    for arch in configs.list_archs():
        assert list(dryrun._probe_layers(configs.get(arch))) == \
            ref["probe_layers"][arch]
        for name, shape in SHAPES.items():
            assert list(dryrun.model_flops(configs.get(arch), shape)) == \
                ref["model_flops"][f"{arch}/{name}"]


def test_variants_apply_as_the_reference_names_them():
    cfg = configs.get("qwen3_14b")
    rules = specs.rules_for(MeshShape(("data", "model"), (16, 16)))
    c, r, sr, kw = dryrun.apply_variant(cfg, rules, "sp_bf16grad_lowcap")
    assert c.capacity_factor == 1.0 and kw == {"grad_dtype": torch.bfloat16}
    assert r.table["res_seq"] == ("model",) and sr is r
    _, r, sr, _ = dryrun.apply_variant(cfg, rules, "attn_dp")
    assert r.table["zero3_attn"] and sr is rules


def test_dryrun_cli_one_cell(tmp_path):
    """``qwen3_14b decode_32k single`` in a subprocess: ok, with its
    roofline row, 256 chips and the decode kernel charged once a layer."""
    out = _run("from repro_torch.launch import dryrun; import sys; "
               "sys.exit(dryrun.main(sys.argv[1:]))", "--arch", "qwen3_14b",
               "--shape", "decode_32k", "--mesh", "single", "--out",
               tmp_path, timeout=240)
    assert "[ok     ] qwen3_14b__decode_32k__single" in out
    rec = json.loads((tmp_path / "qwen3_14b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "useful_fraction", "mfu_bound"} <= set(rec["roofline"])
    assert rec["raw"]["kernels"]["decode_attention"]["calls"] == 40
    assert rec["extrapolated"]["flops"] == pytest.approx(rec["raw"]["flops"])
    assert rec["temp_size_in_bytes"] == (rec["peak_bytes"]
                                         - rec["argument_size_in_bytes"])
    assert rec["roofline"]["memory_s"] == pytest.approx(
        rec["bytes_model"]["total"] / (256 * 3.35e12))


@pytest.mark.parametrize("arch", ["phi3_5_moe_42b", "qwen3_moe_235b"])
def test_moe_training_over_a_model_axis_is_skipped(no_group, arch):
    """No longer skipped: the MoE train cell trains its experts over the
    16-way model axis (the tokens' exchange an all-to-all) and comes out
    ``ok`` with a roofline row."""
    rec = dryrun.run_cell(arch, "train_4k", "single", probes=False)
    assert rec["status"] == "ok", rec.get("reason")
    assert "roofline" in rec and "reason" not in rec
    assert rec["raw"]["collectives"]["all-to-all"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rank_flops_on_a_data_2_model_4_mesh_are_an_eighth(no_group, kind):
    """Phi-3-mini SMOKE splits every mapping over a model axis of 4 (4
    query and KV heads, d_ff 128, vocab 128): rank 0's counted FLOPs on a
    fake (2, 4) mesh are the one-rank count of the global batch over 8,
    within 1 %."""
    cfg = configs.get_smoke("phi3_mini_3_8b")
    shape = ShapeSpec("t", kind, 64, 8)
    flops = []
    for mesh_shape in ((1, 1), (2, 4)):
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="meta")
        fn, args = dryrun._rank_step(cfg, shape, mesh,
                                     specs.rules_for(mesh, shape))
        flops.append(hlo_stats.cost_analysis_stats(
            hlo_stats.count_step(fn, *args))[0])
    assert flops[1] == pytest.approx(flops[0] / 8, rel=1e-2)


def _whole_matmul_flops(cfg, tokens: int) -> tuple[float, int]:
    """The forward matmul FLOPs of a step over ``tokens`` that a model
    rank of a (2, 4) mesh does not split four ways, and the ways it
    splits them: RWKV6's gate ``cr`` and the first half of its decay LoRA
    (whole on every model rank, 1), Jamba's K and V projections (the one
    KV head of two the rank's query head reads, 2)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return cfg.num_layers * 2.0 * tokens * d * (d + cfg.rwkv_lora_dim), 1
    attn = sum(cfg.is_attn_layer(l) for l in range(cfg.num_layers))
    return attn * 2 * 2.0 * tokens * d * cfg.num_kv_heads * cfg.head_dim, 2


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_recurrent_rank_flops_on_a_data_2_model_4_mesh_by_hand(
        no_group, arch, kind):
    """RWKV6 and Jamba SMOKE split their mixers over the model axis: rank
    0's counted FLOPs on a fake (2, 4) mesh equal the one-rank count of
    the global batch with every matmul split eight ways, but those the
    model ranks compute whole (RWKV6's ``cr`` and the first half of its
    decay LoRA) or halved (Jamba's K and V projections), which divide by
    the data axis's 2 only (by 4), within 1 %.  A train step's matmuls
    cost three times their forward."""
    cfg = configs.get_smoke(arch)
    shape = ShapeSpec("t", kind, 64, 8)
    flops = []
    for mesh_shape in ((1, 1), (2, 4)):
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="meta")
        fn, args = dryrun._rank_step(cfg, shape, mesh,
                                     specs.rules_for(mesh, shape))
        flops.append(hlo_stats.cost_analysis_stats(
            hlo_stats.count_step(fn, *args))[0])
    whole, ways = _whole_matmul_flops(cfg, 64 * 8)
    whole *= 3 if kind == "train" else 1
    hand = (flops[0] - whole) / 8 + whole / (2 * ways)
    assert flops[1] == pytest.approx(hand, rel=1e-2)
    assert flops[1] < flops[0] / 6


def test_a_foreign_not_implemented_error_is_an_error(no_group, tmp_path,
                                                     monkeypatch):
    """Only `sharding.NotInPort` makes a cell ``skipped``: an operator
    without a meta kernel raises another `NotImplementedError`, and the
    cell comes out ``error``, the run's exit code 1."""
    def no_meta_kernel(*a, **kw):
        raise NotImplementedError("Could not run 'aten::bincount' with "
                                  "arguments from the 'Meta' backend")

    monkeypatch.setattr(dryrun, "_rank_step", no_meta_kernel)
    assert dryrun.main(["--arch", "qwen3_14b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "qwen3_14b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "error" and "aten::bincount" in rec["error"]
    assert "reason" not in rec


def test_the_fake_mesh_replaces_a_fake_group_of_another_size(no_group):
    assert math.prod(dryrun._mesh("single").shape) == 256
    assert dist.get_world_size() == 256 and dist.get_backend() == "fake"
    multi = dryrun._mesh("multi")
    assert dict(zip(multi.mesh_dim_names, multi.shape)) == {
        "pod": 2, "data": 16, "model": 16}
    assert dist.get_world_size() == 512


# -- launch.sweep and the roofline report ----------------------------------------

def test_sweep_lines_equal_the_reference_sweep(tmp_path, monkeypatch,
                                               capsys):
    """Both sweeps under one stubbed ``subprocess.run``: one cell fails,
    one times out, one has a cached record, the rest succeed."""
    import repro.launch.sweep as ref_sweep
    from repro_torch.launch import sweep

    archs = ["qwen3_14b", "hubert_xlarge", "rwkv6_7b"]

    def stub(cmd, **kw):
        cell = tuple(cmd[cmd.index("--arch") + 1::2][:3])
        if cell[:2] == ("qwen3_14b", "prefill_32k"):
            return subprocess.CompletedProcess(cmd, 3, "", "")
        if cell[:2] == ("rwkv6_7b", "long_500k"):
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        return subprocess.CompletedProcess(cmd, 0, "", "")

    lines = []
    for mod, cfgs in ((ref_sweep, ref_sweep.configs),
                      (sweep, sweep.configs)):
        art = tmp_path / mod.__name__
        art.mkdir()
        (art / "qwen3_14b__train_4k__single.json").write_text(json.dumps(
            {"status": "ok", "extrapolated": {}}))
        monkeypatch.setattr(mod, "ARTIFACTS", art)
        monkeypatch.setattr(cfgs, "list_archs", lambda: archs)
        monkeypatch.setattr(subprocess, "run", stub)
        assert mod.main(["--mesh", "both", "--timeout", "5"]) == 1
        text = capsys.readouterr().out
        lines.append([ln.rsplit(" (", 1)[0] if ln.startswith(
            ("[ok]", "[FAIL]")) else ln for ln in text.splitlines()])
        monkeypatch.undo()
        assert sorted(p.name for p in art.iterdir())
    assert lines[0] == lines[1]
    assert lines[1][-1] == "sweep complete: ok=14 failed=4 skipped=6"


def test_sweep_counts_a_cell_not_in_the_port_as_skipped(tmp_path,
                                                       monkeypatch, capsys):
    """A dry run that exits 0 with a ``skipped`` record (a cell the port
    cannot form) is counted skipped, not ok; the records go to the
    directory the sweep names with ``--out``."""
    from repro_torch.launch import sweep

    def stub(cmd, **kw):
        out = Path(cmd[cmd.index("--out") + 1])
        assert out == tmp_path
        arch, shape, mesh = cmd[cmd.index("--arch") + 1::2][:3]
        if (arch, shape) == ("qwen3_moe_235b", "train_4k"):
            (out / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(
                {"status": "skipped", "reason": "not in the port: why"}))
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(sweep, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(sweep.configs, "list_archs",
                        lambda: ["qwen3_14b", "qwen3_moe_235b"])
    monkeypatch.setattr(subprocess, "run", stub)
    assert sweep.main(["--mesh", "single"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert ("[skip] qwen3_moe_235b__train_4k__single: not in the port: why"
            in lines)
    assert lines[-1] == "sweep complete: ok=5 failed=0 skipped=3"


def _records(d: Path):
    d.mkdir()
    roof = {"compute_s": 0.5, "memory_s": 0.25, "collective_s": 0.125,
            "dominant": "compute", "useful_fraction": 0.75,
            "mfu_bound": 0.5}
    recs = {
        "a__train_4k__single": {"arch": "a", "shape": "train_4k",
                                "status": "ok", "roofline": roof},
        "b__decode_32k__single": {
            "arch": "b", "shape": "decode_32k", "status": "ok",
            "roofline": {**roof, "memory_s": 0.75, "dominant": "memory"}},
        "c__long_500k__single": {"arch": "c", "shape": "long_500k",
                                 "status": "skipped", "reason": "why"},
        "d__prefill_32k__single": {"arch": "d", "shape": "prefill_32k",
                                   "status": "error", "error": "boom"},
        "a__train_4k__multi": {"arch": "a", "shape": "train_4k",
                               "status": "ok", "roofline": roof},
    }
    for tag, rec in recs.items():
        (d / f"{tag}.json").write_text(json.dumps(rec))


def test_roofline_report_lines_equal_the_reference(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmarks import roofline_report as ref_report
    from repro_torch.benchmarks import roofline_report as report
    _records(tmp_path / "d")
    monkeypatch.setattr(ref_report, "ARTIFACTS", tmp_path / "d")
    for mesh in ("single", "multi"):
        assert report.csv_lines(mesh, tmp_path / "d") == \
            ref_report.csv_lines(mesh)
    monkeypatch.setattr(report, "ARTIFACTS", tmp_path / "d")
    assert report.main() == ref_report.main()
    assert len(report.main()) == 2
    mine, ref = (r.markdown_table("single").splitlines()
                 for r in (report, ref_report))
    # the same rows but the fix notes, rewritten for Hopper
    assert [ln.rsplit("|", 2)[0] for ln in mine] == \
        [ln.rsplit("|", 2)[0] for ln in ref]
    assert "wgmma" in report.markdown_table("single")


# -- MoE dispatch on meta ------------------------------------------------------

def test_dispatch_indices_on_meta_and_without_a_host_read():
    flat = torch.randint(0, 6, (40,), generator=torch.Generator()
                         .manual_seed(1))
    slot, keep = moe._dispatch_indices(flat, 6, 5)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=6)
    pos = torch.arange(40) - (torch.cumsum(counts, 0) - counts)[flat[order]]
    inv = torch.argsort(order, stable=True)
    assert torch.equal(keep, (pos < 5)[inv])
    assert torch.equal(slot, (flat[order] * 5 + pos.clamp(max=4))[inv])
    ms, mk = moe._dispatch_indices(flat.to("meta"), 6, 5)
    assert ms.device.type == "meta" and ms.shape == mk.shape == (40,)
