"""Where the decode-attention kernel's time goes, on one CUDA card.

Times `decode.gqa_decode_attention` (B1) at batch 1 and Hkv 8 over cache
lengths from 64 to 32,768 keys while one factor changes at a time: the
cache's element size (f32, bf16), the group g (1, 5, 16) and the head
dim (16, 128).  The slope of time over keys says what a key costs: a
slope that follows the bytes is the memory, one that follows g x dh is
arithmetic, and one that follows neither is a chain of fixed latencies.
Beside it, ptxas's registers, spills and shared memory of every decode
source, and the kernel's device time in `torch.profiler` against the
call's event time.

    python -m repro_torch.benchmarks.decode_probe [--out FILE]

Each result is one JSON line; times are medians of calls between CUDA
events after an L2-evicting write and a spin of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import decode

LENGTHS = (64, 256, 1024, 4096, 32768)
# (name, dh, g, cache dtype)
SHAPES = (("f32_dh128_g5", 128, 5, torch.float32),
          ("bf16_dh128_g5", 128, 5, torch.bfloat16),
          ("f32_dh128_g1", 128, 1, torch.float32),
          ("f32_dh128_g16", 128, 16, torch.float32),
          ("f32_dh16_g5", 16, 5, torch.float32))
HKV = 8
SOURCES = ("decode_attention", "paged_decode_attention",
           "quantized_decode_attention", "paged_quantized_decode_attention")


def ptxas(name: str) -> list[str]:
    """ptxas's resource lines for ``csrc/<name>.cu``."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             f"{tmp}/probe.so", str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "error" in ln]


def median_ms(fn, n: int, flush) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def inputs(b: int, rows: int, dh: int, g: int, kv_dtype, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, HKV * g, dh), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn((b, rows, HKV, dh), generator=gen, device="cuda",
                    dtype=kv_dtype)
    v = torch.randn((b, rows, HKV, dh), generator=gen, device="cuda",
                    dtype=kv_dtype)
    return q, k, v


def kernel_device_ms(fn, reps: int = 10) -> float:
    """Mean device time a call spends in kernels named like the decode
    body, from `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if "decode_kernel" in e.key:
            us += float(getattr(e, "self_device_time_total", 0.0)
                        or getattr(e, "self_cuda_time_total", 0.0))
    return us / 1e3 / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="also write the lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    lines = []

    def emit(**rec):
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    emit(probe="device", kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    _build.build(list(SOURCES))
    for name in SOURCES:
        emit(probe="ptxas", source=name, lines=ptxas(name))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for name, dh, g, kv_dtype in SHAPES:
        times = {}
        for n in LENGTHS:
            q, k, v = inputs(1, n, dh, g, kv_dtype)
            lv = torch.tensor([n], dtype=torch.int32, device="cuda")
            times[n] = median_ms(lambda: decode.gqa_decode_attention(
                q, k, v, length=lv), 11, flush)
            del q, k, v
        lo, hi = LENGTHS[0], LENGTHS[-1]
        emit(probe="length_sweep", shape=name, batch=1, hkv=HKV, dh=dh, g=g,
             kv_dtype=str(kv_dtype).removeprefix("torch."),
             ms_by_keys=times,
             us_per_64_keys=(times[hi] - times[lo]) * 1e3 / ((hi - lo) / 64))
    for b in (1, 4, 8):
        q, k, v = inputs(b, 4096, 128, 5, torch.bfloat16)
        lv = torch.full((b,), 4096, dtype=torch.int32, device="cuda")

        def call():
            return decode.gqa_decode_attention(q, k, v, length=lv)
        emit(probe="batch", batch=b, keys=4096, kv_dtype="bfloat16",
             event_ms=median_ms(call, 11, flush),
             kernel_device_ms=kernel_device_ms(call))
        del q, k, v
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
