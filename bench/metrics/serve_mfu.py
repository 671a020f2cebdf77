"""The whole serving window's share of the chip's bf16 peak, %: the
useful operations of every forward that returned in the window
(`bench.counts.forward_flops`: matmuls per position carried, the
unembedding of each position that gave a token, causal attention over
the keys each position sees; no padding), over the window's seconds at
the peak."""

from bench import counts


def read(run):
    if run.chip is None:
        return None
    flops = sum(counts.forward_flops(run.model, r.rows, len(r.emitted))
                for r in run.window_records())
    return 100.0 * flops / (run.seconds * run.chip["bf16_flops"])
