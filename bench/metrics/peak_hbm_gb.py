"""Peak device memory of the run, GB (1e9 bytes): what
`torch.cuda.max_memory_allocated` read after the window."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
