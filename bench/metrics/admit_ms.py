"""Mean admission forward, ms: host clock over the admission calls that
returned in the window (each ends in the copy of its tokens to the
host, which waits for the card)."""


def read(run):
    recs = run.window_records("admit")
    return 1e3 * sum(r.t1 - r.t0 for r in recs) / len(recs) if recs else None
