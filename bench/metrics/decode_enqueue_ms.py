"""Mean host enqueue of a decode step, ms: over the program's
``serve.decode`` spans that ended in the host clock's window, the
``step.enqueue`` span inside each (the forward's Python enqueue up to its
return, before any copy to the host), from the program's tracer
(`bench.progtrace`); nothing where the run carries no program spans."""

from bench import progtrace


def read(run):
    return progtrace.decode_enqueue_ms(run)
