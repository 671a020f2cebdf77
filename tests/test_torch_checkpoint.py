"""Checkpoints and the resilient loop of the port against the JAX
package: `checkpoint.manager` (round trip, keep-N, uncommitted
directories ignored, a structure mismatch refused, async save, restore
onto a device; tests/test_checkpoint.py), checkpoints written by one
package and restored by the other with the same keys, shapes, dtypes and
bytes (f32, int32 and int8 leaves; a bf16 leaf as its uint16 bits), the
training half of `runtime.fault_tolerance` (`run_resilient`'s recovery and
its restart limit, `Heartbeat`; tests/test_fault_tolerance.py), resume
bit for bit (tests/test_train_loop.py), and the trainer CLI and the
train_lm example on the CPU."""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import COMMITTED  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.data import DataConfig, SyntheticSource  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    Heartbeat, ResilienceConfig, run_resilient, to_float)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in several processes at once,
    and more threads than cores slow every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g),
                   "b": torch.zeros(16)},
        "opt": {"step": torch.tensor(3, dtype=torch.int32),
                "m": {"w": torch.ones(8, 16)}},
    }


def _equal(a, b):
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    state = _state()
    mgr.save(10, state, blocking=True)
    restored, meta = mgr.restore(None, state)
    assert meta["step"] == 10
    _equal(state, restored)
    assert meta["keys"] == ["['opt']/['m']/['w']", "['opt']/['step']",
                            "['params']/['b']", "['params']/['w']"]


def test_uncommitted_checkpoints_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(10, _state(), blocking=True)
    fake = tmp_path / "step_0000000020"
    fake.mkdir()
    (fake / "0.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 10
    _, meta = mgr.restore(None, _state())
    assert meta["step"] == 10


def test_keep_n_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(), blocking=True)
    assert sorted(mgr._committed_steps()) == [3, 4]


def test_structure_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state(), blocking=True)
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(None, {"params": {"w": torch.zeros(8, 16)}})


def test_async_save_copies_to_the_host_before_returning(tmp_path):
    """The consistency point: a leaf changed in place after `save`
    returns is saved as it was."""
    mgr = CheckpointManager(tmp_path)
    state = _state()
    want = state["params"]["w"].clone()
    mgr.save(5, state)                     # non-blocking
    state["params"]["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(None, state)
    assert torch.equal(restored["params"]["w"], want)


def test_restore_onto_a_device_and_a_bf16_leaf(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = {"p": torch.randn(4, 3).bfloat16(), "s": torch.tensor(2)}
    mgr.save(7, state, blocking=True)
    meta = json.loads((tmp_path / "step_0000000007" / "meta.json").read_text())
    assert meta["dtypes"] == ["bfloat16", "int64"]
    assert np.load(tmp_path / "step_0000000007" / "0.npy").dtype == np.uint16
    restored, _ = mgr.restore(7, state, torch.device("cpu"))
    _equal(state, restored)
    assert mgr.restore(None, state)[0]["p"].device.type == "cpu"


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(None, _state())


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def _jax_train_state(arch, moment_dtype):
    cfg = jconfigs.get_smoke(arch)
    jp = jtf.init(cfg, jax.random.PRNGKey(0))
    ocfg = jadamw.AdamWConfig(moment_dtype=moment_dtype)
    js = jadamw.init_state(jp, ocfg)
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.01), jp)
    jp, js, _ = jadamw.update(jp, g, js, ocfg)
    return {"params": jp, "opt": js}


def _port_like(arch, moment_dtype):
    cfg = tconfigs.get_smoke(arch)
    tp = ttf.init(cfg, torch.Generator().manual_seed(1))
    return {"params": tp, "opt": tadamw.init_state(
        tp, tadamw.AdamWConfig(moment_dtype=moment_dtype))}


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "jamba_1_5_large_398b"])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, arch,
                                               moment_dtype):
    jstate = _jax_train_state(arch, moment_dtype)
    JManager(tmp_path, keep=1).save(4, jstate, blocking=True)
    restored, meta = CheckpointManager(tmp_path).restore(
        None, _port_like(arch, moment_dtype))
    assert meta["step"] == 4
    dtypes = set()
    for a, b in zip(jax.tree.leaves(jstate), tree_lib.leaves(restored)):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
        dtypes.add(str(a.dtype))
    assert dtypes == ({"float32", "int32", "int8"} if moment_dtype == "int8"
                      else {"float32", "int32"})


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_a_port_checkpoint_restores_in_jax(tmp_path, moment_dtype):
    jstate = _jax_train_state("qwen3_14b", moment_dtype)
    tstate = {"params": params_from_numpy(jax.tree.map(np.asarray,
                                                       jstate["params"])),
              "opt": opt_state_from_numpy(jax.tree.map(np.asarray,
                                                       jstate["opt"]))}
    CheckpointManager(tmp_path).save(9, tstate, blocking=True)
    restored, meta = JManager(tmp_path).restore(
        None, jax.eval_shape(lambda: jstate))
    assert meta["step"] == 9
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(restored)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # and the meta the reference reads is the reference's own
    ref_dir = tmp_path / "ref"
    JManager(ref_dir).save(9, jstate, blocking=True)
    ours = json.loads((tmp_path / "step_0000000009" / "meta.json").read_text())
    theirs = json.loads((ref_dir / "step_0000000009" / "meta.json").read_text())
    for k in ("step", "keys", "shapes", "dtypes"):
        assert ours[k] == theirs[k], k


# ---------------------------------------------------------------------------
# The resilient loop
# ---------------------------------------------------------------------------

def test_run_resilient_recovers_from_injected_fault(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=3)
    calls = {"faults": 0}

    def step_fn(state, batch):
        return state + batch, {"loss": state.float()}

    def fault_hook(step):
        if step == 7 and calls["faults"] == 0:
            calls["faults"] += 1
            raise RuntimeError("injected node failure")

    def on_restore(step):
        st, meta = ckpt.restore(None, torch.tensor(0))
        return st, meta["step"]

    state, history, _ = run_resilient(
        step_fn, torch.tensor(0), 12, ckpt, lambda step: 1,
        config=ResilienceConfig(checkpoint_every=5),
        fault_hook=fault_hook, on_restore=on_restore)
    assert calls["faults"] == 1
    assert int(state) == 12                 # replayed from step 5
    assert ckpt.latest_step() == 12
    assert [h["step"] for h in history] == list(range(7)) + list(range(5, 12))
    assert history[-1]["loss"] == 11.0


def test_run_resilient_gives_up_after_max_restarts(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    restores = []

    def always_fail(step):
        raise RuntimeError("hard failure")

    def on_restore(step):
        restores.append(step)
        return torch.tensor(0), 0

    with pytest.raises(RuntimeError, match="hard failure"):
        run_resilient(lambda s, b: (s, {}), torch.tensor(0), 5, ckpt,
                      lambda s: 0, config=ResilienceConfig(max_restarts=2),
                      fault_hook=always_fail, on_restore=on_restore)
    assert len(restores) == 2
    with pytest.raises(RuntimeError):       # no on_restore: the first fault
        run_resilient(lambda s, b: (s, {}), torch.tensor(0), 5, ckpt,
                      lambda s: 0, fault_hook=always_fail)


def test_heartbeat_detects_dead_host():
    t = [0.0]
    hb = Heartbeat(4, timeout_s=10, clock=lambda: t[0])
    t[0] = 5.0
    hb.beat(0)
    hb.beat(1)
    hb.beat(2)
    t[0] = 12.0
    assert hb.dead() == [3]


def test_to_float_keeps_what_converts():
    out = to_float({"a": torch.tensor(1.5), "b": 2, "c": torch.ones(3),
                    "d": "x"})
    assert out == {"a": 1.5, "b": 2.0}


# ---------------------------------------------------------------------------
# Resume and the CLI
# ---------------------------------------------------------------------------

def _setup(arch="qwen3_14b", steps_total=20):
    cfg = tconfigs.get_smoke(arch)
    opt = tadamw.AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                             total_steps=steps_total)
    tp = ttf.init(cfg, torch.Generator().manual_seed(0))
    state = {"params": tp, "opt": tadamw.init_state(tp, opt)}
    src = SyntheticSource(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=4, seed=1))
    return state, src, tsteps.make_train_step(cfg, opt)


def _batch(src, t):
    return {k: torch.from_numpy(v) for k, v in src.batch(t, 0, 1).items()}


@pytest.mark.parametrize("through", ["loop", "run_resilient"])
def test_resume_is_bit_exact(tmp_path, through):
    """Ten steps with a checkpoint at 6; restored at 6 and replayed to 10,
    the state is the uninterrupted run's, bit for bit.  Through
    `run_resilient`, a fault at step 8 restores the step-6 checkpoint and
    ends with the same state too."""
    state, src, step = _setup()
    ckpt = CheckpointManager(tmp_path / "a")
    for t in range(10):
        state, _ = step(state, _batch(src, t))
        if t + 1 == 6:
            ckpt.save(6, state, blocking=True)
    like, _, _ = _setup()
    restored, meta = ckpt.restore(None, like)
    assert meta["step"] == 6
    if through == "loop":
        for t in range(6, 10):
            restored, _ = step(restored, _batch(src, t))
    else:
        ckpt2 = CheckpointManager(tmp_path / "b")
        fired = []

        def fault_hook(t):
            if t == 8 and not fired:
                fired.append(t)
                raise RuntimeError("injected")

        def on_restore(_t):
            st, m = ckpt2.restore(None, like)
            return st, m["step"]

        fresh, _, _ = _setup()
        restored, history, _ = run_resilient(
            step, fresh, 10, ckpt2, lambda t: _batch(src, t),
            config=ResilienceConfig(checkpoint_every=6),
            fault_hook=fault_hook, on_restore=on_restore)
        assert fired == [8] and ckpt2.latest_step() == 10
    _equal(state, restored)


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "12", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    assert ttrain.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(first) == {"arch", "steps", "wall_s", "first_loss",
                          "last_loss", "stragglers", "final_ckpt"}
    assert first["arch"] == "qwen3-14b-smoke" and first["steps"] == 12
    assert first["final_ckpt"] == 12
    assert first["last_loss"] < first["first_loss"]
    argv[argv.index("12")] = "16"
    assert ttrain.main(argv + ["--resume"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "resumed from step 12"
    second = json.loads(lines[-1])
    assert second["steps"] == 4 and second["final_ckpt"] == 16
    assert second["first_loss"] < first["first_loss"]
    with pytest.raises(SystemExit, match="256 ranks"):
        ttrain.main(argv + ["--production-mesh"])


def test_train_lm_example_on_the_cpu(tmp_path, monkeypatch):
    """The example's loop, checkpoints and JSON, at a width a CPU test
    affords (its two configs are held to the reference's below)."""
    from repro.models.config import ModelConfig as JConfig
    from repro_torch.examples import train_lm
    from repro_torch.models.config import ModelConfig
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm.py"
    spec = importlib.util.spec_from_file_location("ref_train_lm", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for hundred_m in (False, True):
        assert dataclasses.asdict(train_lm.model_config(hundred_m)) == \
            dataclasses.asdict(ref.model_config(hundred_m))
    assert isinstance(ref.model_config(False), JConfig)
    monkeypatch.setattr(train_lm, "model_config", lambda hundred_m: (
        ModelConfig(name="lm-tiny", family="dense", num_layers=2,
                    d_model=64, d_ff=128, vocab_size=256, num_heads=4,
                    num_kv_heads=2)))
    res = train_lm.main(["--device", "cpu", "--steps", "10", "--seq", "32",
                         "--ckpt-dir", str(tmp_path)])
    assert set(res) == {"params_m", "steps", "wall_s", "tokens_per_s",
                        "loss_first", "loss_last", "stragglers_flagged",
                        "final_checkpoint"}
    assert res["steps"] == 10 and res["final_checkpoint"] == 10
    assert res["loss_last"] < res["loss_first"]
    assert (tmp_path / "lm-tiny" / "step_0000000010" / COMMITTED).exists()
