"""The device time of an admission's attention, ms: the mean, over the
program's ``repro.serve.admit`` ranges wholly in the traced window, of
the union of the device intervals of the work launched inside their
``repro.model.attn`` ranges (each layer's attention after the cache
write, whichever kernel computes it; `bench.progtrace`)."""

from bench import progtrace


def read(run):
    return progtrace.admit_attn_ms(run)
