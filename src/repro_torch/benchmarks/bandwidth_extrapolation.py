"""The paper's bandwidth extrapolation (§V-B) for the card: the rate of an
ELL SpMV against the memory rate.  Counterpart of
``benchmarks/bandwidth_extrapolation.py`` of the JAX package.

The paper extrapolates its SpMV across memory bandwidths and reports its
efficiency (sustained over the bandwidth-ideal rate) at 44-66 %, against
80-90 % for designs whose models idealise memory.  The loss is the
random access's over-fetch: a DRAM hit for x[col] drags a whole line.
Three designs are modelled at each bandwidth:

  ideal        every byte useful (the bound of the idealised designs)
  cacheline    the paper's DMA line buffer: half of each fetched 64-byte
               line reused
  smem_x       B7's design (``csrc/ell_spmv.cu``): x resident in shared
               memory, so the gathers never touch device memory; only the
               ELL entries (value and column) are read, each row's
               nonzeros alone (its lengths bound the walk), so no padding

Sustained GFLOP/s = 2 flops per nonzero / (bytes per nonzero / rate).
The rows are a model, not a measurement; the last rate is the H100's
device memory, ``hardware.H100_SXM.hbm_bw``, where the JAX package puts
its TPU's, and each row names the chip whose rate it models.
"""

from __future__ import annotations

from repro_torch.core import hardware

CACHELINE = 64.0
VAL_IDX = 8.0          # 4 B value + 4 B column index per nonzero
# The paper's rates (GB/s), then the card's.
RATES_GBS = (1.6, 3.2, 6.4, 12.8, 25.6)


def bytes_per_nnz(design: str) -> float:
    if design == "ideal":
        return VAL_IDX + 4.0                     # + one useful x word
    if design == "cacheline":
        return VAL_IDX + 0.5 * CACHELINE         # half the line wasted
    if design == "smem_x":
        return VAL_IDX                           # x gathers stay on chip
    raise ValueError(design)


def rows(chip: hardware.Chip = hardware.H100_SXM) -> list[dict]:
    """One row per (rate, design): the paper's rates and ``chip``'s."""
    ideal = bytes_per_nnz("ideal")
    out = []
    for bw_gbs, label in [*((r, "paper") for r in RATES_GBS),
                          (chip.hbm_bw / 1e9, chip.variant)]:
        for design in ("ideal", "cacheline", "smem_x"):
            bpn = bytes_per_nnz(design)
            out.append({"design": design, "bw_gbs": bw_gbs, "chip": label,
                        "gflops_model": 2.0 / bpn * bw_gbs,
                        "eff_vs_ideal": ideal / bpn})
    return out


def main() -> list[str]:
    return [f"bandwidth.spmv_{r['design']}_at_{r['bw_gbs']:g}GBs,0.0,"
            f"gflops_model={r['gflops_model']:.2f};"
            f"eff_vs_ideal={r['eff_vs_ideal']:.2f};chip={r['chip']}"
            for r in rows()]


if __name__ == "__main__":
    print("\n".join(main()))
