"""B1's share of its roofline, %: the least time its calls in the traced
window could take (`bench.counts.decode_attention_bound_s`: each slot's
K and V rows up to its length, its query and output rows, once, at the
chip's bandwidth) over B1's device time there.

B1 is the contiguous-cache decode attention kernel
(`src/repro_torch/csrc/decode_body.cuh`, ``decode_kernel<T, false, G>``);
the bound counts 2-byte rows, so only its bf16 cache's instance
(``T = __nv_bfloat16``) is read.  Only decode calls whose whole range lies
in the trace count, and each B1 launch inside such a range is one
layer's attention of that call: it adds that call's bound for one layer.
With no such launch the metric is not reported."""

import bisect
import re

from bench import counts

B1 = re.compile(r"decode_kernel<\s*__nv_bfloat16\s*,\s*false\b")


def read(run):
    if run.trace is None or run.chip is None:
        return None
    by_seq = {r.seq: r for r in run.records if r.kind == "decode"}
    spans = []
    for name, s, e in run.trace.spans:
        kind, _, seq = name.removeprefix("bench.").partition("#")
        if kind == "decode" and s >= run.trace.window[0] \
                and e <= run.trace.window[1] and int(seq) in by_seq:
            spans.append((s, e, by_seq[int(seq)]))
    kernels = sorted((k0, k1) for name, k0, k1 in run.trace.device
                     if B1.search(name))
    starts = [k0 for k0, _ in kernels]
    bound = device = 0.0
    launches = 0
    for s, e, rec in spans:
        lengths = [depth + n for _, depth, n in rec.rows]
        per_layer = counts.decode_attention_bound_s(run.model, lengths,
                                                    run.chip)
        for k0, k1 in kernels[bisect.bisect_left(starts, s):
                              bisect.bisect_left(starts, e)]:
            bound += per_layer
            device += (k1 - k0) * 1e-9
            launches += 1
    if not launches:
        return None
    return 100.0 * bound / device
