"""Mean decode step, ms: host clock over the decode calls that returned
in the window."""


def read(run):
    recs = run.window_records("decode")
    return 1e3 * sum(r.t1 - r.t0 for r in recs) / len(recs) if recs else None
