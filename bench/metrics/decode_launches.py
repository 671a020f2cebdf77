"""Host calls that put work on the device per decode step: the mean,
over the program's ``repro.serve.decode`` ranges wholly in the traced
window, of the calls into the CUDA runtime (``cuda*``) or its lower
level (``cu*``) inside each that launch a kernel, copy, set or graph (a
graph launch counts once), known by name (`bench.progtrace`)."""

from bench import progtrace


def read(run):
    return progtrace.decode_launches(run)
