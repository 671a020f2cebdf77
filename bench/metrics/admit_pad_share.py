"""Padding of the admission forwards in the window, %: positions that
carry no prompt or riding token, over batch x width, summed over every
forward wider than one column."""


def read(run):
    recs = [r for r in run.window_records("admit") if r.width > 1]
    total = sum(run.batch * r.width for r in recs)
    if not total:
        return None
    used = sum(n for r in recs for _, _, n in r.rows)
    return 100.0 * (total - used) / total
