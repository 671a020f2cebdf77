"""Communication-minimising blocked-matmul tiling: the paper's eq. 2, and
its Hopper form.  Counterpart of `repro.core.tiling`.

Paper model (section V-A): ``C = A @ B`` with n x n operands, p cores
sharing a column panel, each core owning y x x blocks of C with a z-deep
contraction step.  External traffic

    Q(x, y) = n^3 / (p*x)  +  n^3 / y  +  n^2

under ``x*(2z + y) <= L`` with z = 1; Lagrange gives eq. 2,
``y = sqrt(p*L)``, ``x = L / (2 + sqrt(p*L))``.  `Tile`, `comm_volume`,
`comm_volume_rect`, `solve_paper` and `brute_force_paper` are the JAX
package's, verbatim.

Hopper form (`solve_hopper`, in place of the TPU's `solve_tpu`): the CUDA
kernels stage A (y, z) and B (z, x) tiles in shared memory and keep the
(y, x) C tile in f32 registers.  bf16 runs ``csrc/blocked_matmul_wgmma.cu``
(TMA and ``wgmma``): a ring of unpadded, swizzled stages, two mbarriers
a stage, at least `WGMMA_MIN_STAGES` and as many as a block's shared
memory holds.  f32 runs the CUDA-core kernel of ``csrc/blocked_matmul.cu``:
two stages, rows padded by 16 bytes.  `hopper_smem_bytes` is what each
allocates at launch, `hopper_min_smem_bytes` the least it runs in.  So a
tile must fit two budgets, the block's shared memory (the paper's ``L``,
against the least footprint) and the registers an SM can give its
accumulators, and must be one of the tiles the kernels are built for
(`HOPPER_TILES`).  Q does not depend on z, so z is the deepest that
fits.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hardware

# (y, x) C tiles and z depths the CUDA kernel is built for.  256 x 256
# is left out: its f32 accumulators would take the whole register file.
HOPPER_YX = ((64, 64), (64, 128), (64, 256), (128, 64), (128, 128),
             (128, 256), (256, 64), (256, 128))
HOPPER_Z = (32, 64)
STAGES = 2                      # the f32 kernel's stages
# The bf16 (wgmma) kernel's ring: as many stages of (A, B, two 8-byte
# mbarriers) as a block's shared memory holds after the slack that lets
# the ring start on 1024 bytes, and never fewer than three.
WGMMA_SMEM_LIMIT = 232_448
WGMMA_MIN_STAGES = 3
WGMMA_ALIGN_SLACK = 1024
MBARRIER_BYTES = 8


@dataclasses.dataclass(frozen=True)
class Tile:
    """A (y, x, z) block assignment: C tile is y*x, contraction depth z."""

    y: int  # rows of the C tile (M axis)
    x: int  # cols of the C tile (N axis)
    z: int  # contraction tile (K axis)

    def vmem_elems(self, double_buffer: bool = True) -> int:
        db = 2 if double_buffer else 1
        return self.y * self.z + db * self.z * self.x + self.y * self.x

    def as_block_shapes(self):
        """Block shapes of (A, B, C) of a y/x/z-tiled matmul."""
        return (self.y, self.z), (self.z, self.x), (self.y, self.x)


HOPPER_TILES = tuple(Tile(y, x, z) for y, x in HOPPER_YX for z in HOPPER_Z)


def comm_volume(n: int, tile: Tile, p: int = 1) -> float:
    """External-memory traffic (elements) for an n x n matmul — paper's Q."""
    if tile.x <= 0 or tile.y <= 0:
        return math.inf
    return n**3 / (p * tile.x) + n**3 / tile.y + n**2


def comm_volume_rect(m: int, n: int, k: int, tile: Tile, p: int = 1) -> float:
    """Rectangular generalization of Q for an (m,k) @ (k,n) product.

    Each operand is streamed at least once (the ``max(1, ...)`` floors):
    below one tile per axis the fractional panel counts would otherwise
    charge less than one full pass over B.
    """
    if tile.x <= 0 or tile.y <= 0:
        return math.inf
    a_traffic = (m * k) * max(1.0, n / (p * tile.x))  # A loaded once per N-panel
    b_traffic = (k * n) * max(1.0, m / tile.y)        # B reloaded per row-block
    c_traffic = m * n
    return a_traffic + b_traffic + c_traffic


def solve_paper(L: int, p: int = 1) -> Tile:
    """Eq. 2 of the paper, verbatim: z = 1, y = sqrt(pL), x = L/(2+sqrt(pL))."""
    if L <= 4:
        return Tile(1, 1, 1)
    y_star = math.sqrt(p * L)
    x_star = L / (2.0 + y_star)
    # Integer repair of the continuous optimum.  The feasible set x(2+y)<=L
    # is a sawtooth in integers, so probe both axes: for integer y near y*,
    # the best x is the constraint maximum L//(2+y); for integer x near x*,
    # the best y is L//x - 2.  Pick the lowest-traffic candidate.
    cands = set()
    for y in {max(1, math.floor(y_star)), max(1, math.ceil(y_star))}:
        cands.add((int(y), max(1, L // (2 + int(y)))))
    for x in {max(1, math.floor(x_star)), max(1, math.ceil(x_star))}:
        y = max(1, L // int(x) - 2)
        cands.add((int(y), int(x)))
    best, best_q = None, math.inf
    for y, x in cands:
        if x * (2 + y) > L:
            continue
        t = Tile(y, x, 1)
        q = comm_volume(4096, t, p)
        if q < best_q:
            best, best_q = t, q
    return best if best is not None else Tile(1, 1, 1)


def brute_force_paper(L: int, p: int = 1, n: int = 4096) -> Tile:
    """Exhaustive integer search of the paper's constrained problem (tests).
    x >= 1 requires 2 + y <= L, so y ranges over [1, L-2]."""
    best, best_q = Tile(1, 1, 1), math.inf
    for y in range(1, max(L - 1, 2)):
        x = L // (2 + y)
        if x >= 1:
            q = comm_volume(n, Tile(y, x, 1), p)
            if q < best_q:
                best_q, best = q, Tile(y, x, 1)
    return best


def _wgmma_stage_bytes(tile: Tile) -> int:
    return (tile.y * tile.z + tile.z * tile.x) * 2 + 2 * MBARRIER_BYTES


def wgmma_stages(tile: Tile) -> int:
    """Stages of the bf16 kernel's ring for ``tile``."""
    return (WGMMA_SMEM_LIMIT - WGMMA_ALIGN_SLACK) // _wgmma_stage_bytes(tile)


def hopper_smem_bytes(tile: Tile, dtype_bytes: int) -> int:
    """Dynamic shared memory a launch of the CUDA kernel for ``tile``
    takes.  bf16 (2-byte operands): `wgmma_stages` stages of unpadded A
    (y, z) and B (z, x) with their two mbarriers, plus the alignment
    slack.  f32: ``STAGES`` copies of A and B, each row padded by 16 bytes
    (so the CUDA cores' reads are free of bank conflicts)."""
    if dtype_bytes == 2:
        return (wgmma_stages(tile) * _wgmma_stage_bytes(tile)
                + WGMMA_ALIGN_SLACK)
    pad = 16 // dtype_bytes
    return STAGES * (tile.y * (tile.z + pad) + tile.z * (tile.x + pad)) \
        * dtype_bytes


def hopper_min_smem_bytes(tile: Tile, dtype_bytes: int) -> int:
    """The least shared memory the kernel for ``tile`` runs in: in bf16
    a ring of `WGMMA_MIN_STAGES` (the launch fills the card's budget with
    more, which only hides more latency); in f32 its fixed two stages."""
    if dtype_bytes == 2:
        return WGMMA_MIN_STAGES * _wgmma_stage_bytes(tile) + WGMMA_ALIGN_SLACK
    return hopper_smem_bytes(tile, dtype_bytes)


def hopper_fits(tile: Tile, dtype_bytes: int, smem_bytes: int,
                accum_bytes: int) -> bool:
    """Whether the kernel's least footprint for ``tile`` fits
    ``smem_bytes`` and the f32 C tile fits ``accum_bytes`` of
    registers."""
    return (hopper_min_smem_bytes(tile, dtype_bytes) <= smem_bytes
            and tile.y * tile.x * 4 <= accum_bytes)


def solve_hopper(
    smem_bytes: int | None = None,
    dtype_bytes: int = 2,
    p: int = 1,
    m: int | None = None,
    n: int | None = None,
    k: int | None = None,
    chip: hardware.Chip = hardware.H100_SXM,
) -> Tile:
    """The kernel tile of least traffic under both Hopper budgets.

    The local search of `solve_tpu` around the eq. 2 point, over the
    tiles the kernel is built for: that set is small enough to walk
    whole.  Every fitting (y, x) takes the deepest z that fits; the tile
    of least ``comm_volume_rect`` wins, ties going to the one nearest the
    eq. 2 seed (``solve_paper`` of the budget in elements), then to the
    smaller (y, x).  With nothing fitting, the smallest tile.
    """
    budget = smem_bytes if smem_bytes is not None else chip.smem_bytes
    regs = chip.accum_regs_bytes()
    seed = solve_paper(max(budget // max(dtype_bytes, 1), 1), p)
    mm, nn, kk = m or 8192, n or 8192, k or 8192
    best, best_key = None, None
    for y, x in HOPPER_YX:
        z = max((z for z in HOPPER_Z
                 if hopper_fits(Tile(y, x, z), dtype_bytes, budget, regs)),
                default=None)
        if z is None:
            continue
        t = Tile(y, x, z)
        key = (comm_volume_rect(mm, nn, kk, t, p),
               abs(math.log(y / seed.y)) + abs(math.log(x / seed.x)), y, x)
        if best_key is None or key < best_key:
            best, best_key = t, key
    return best if best is not None else HOPPER_TILES[0]
