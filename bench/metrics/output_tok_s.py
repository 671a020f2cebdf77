"""Output tokens/s: every token given to a request in the window (its
forward returned in the window), over the window's seconds."""


def read(run):
    return sum(len(r.emitted) for r in run.window_records()) / run.seconds
