"""95th percentile of the gaps between consecutive output tokens of one
request, ms: every gap whose two tokens both came in the window."""

import collections

import numpy as np


def read(run):
    times = collections.defaultdict(list)
    for rec in run.window_records():
        for rid in rec.emitted:
            times[rid].append(rec.t1)
    gaps = [b - a for ts in times.values() for a, b in zip(ts, ts[1:])]
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
