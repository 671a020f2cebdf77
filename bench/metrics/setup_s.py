"""Set-up, s: process start to the window's opening (imports, weights,
the server, the first builds, the warm-up, the first fill)."""


def read(run):
    return run.t_open - run.t_start
