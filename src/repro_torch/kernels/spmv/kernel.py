"""ELL sparse matrix-vector product, x resident or streamed in slabs.
Counterpart of the Pallas kernels `repro.kernels.spmv.kernel.ell_spmv`
and `ell_spmv_blocked`.

The work is done by the hand-written CUDA kernels of
``csrc/ell_spmv.cu``; `ref.spmv_ell_ref` and `ref.spmv_blocked_ref` are
their plain PyTorch versions.  A wrapper takes the plain version only
when every operand lies on the CPU; a CUDA tensor launches the kernel or
raises, and refuses cols that point outside x (`check_columns`).
``launches`` and ``blocked_launches`` count kernel launches.

``block_rows`` sets the lanes a row: ``threads / block_rows`` (1024
threads for `ell_spmv`, 512 for `ell_spmv_blocked`).  `ell_spmv` sizes
its launch from the matrix (`launch_geometry`): few rows get more lanes
and smaller blocks, so they spread over the SMs, and several block_rows
may give one launch (`distinct_block_rows`).  Given each packed row's
length (``row_lens``) it reads only the row's entries, in 16-byte vectors,
and uses none of its padding; the plain version then masks the padding
too.  The blocked kernel keeps its rows' entries in
registers, at most `MAX_PER_LANE` a lane, which bounds ``block_rows`` by
the width (`blocked_fits`).  It stages x in shared memory when x is one
slab and otherwise gathers each entry's x directly from L2, so a slab
that none of a block's entries falls in costs nothing (`slab_plan`
counts what it does).  Unlike the Pallas kernels these mask a ragged
last row block and x's last slab themselves: nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.core import hardware
from repro_torch.kernels import _build
from repro_torch.kernels.spmv import ref

RESIDENT_THREADS = 1024
BLOCKED_THREADS = 512
VECTOR = 4                                    # entries a 16-byte load reads
RESIDENT_ROWS = (32, 64, 128, 256, 512, 1024)  # 32 .. 1 lanes a row
BLOCKED_ROWS = (16, 32, 64, 128, 256, 512)    # 32 .. 1 lanes a row
MAX_PER_LANE = 32
SMEM_PER_SM = 233_472                         # 228 KB of an H100 SM

launches = 0
blocked_launches = 0

# cols tensors whose columns were found in range, with the version
# (`Tensor._version`) and the n they were checked at; row_lens tensors
# found in [0, width], with the version and the width.
_cols_checked = WeakTensorKeyDictionary()
_lens_checked = WeakTensorKeyDictionary()


def smem_bytes(n: int, block_cols: int | None = None) -> int:
    """Shared memory a block of the kernel takes: all of x, or a slab."""
    return 4 * (n if block_cols is None else block_cols)


def launch_geometry(rows: int, width: int, lanes: int, n: int,
                    sms: int) -> dict:
    """Threads a block, lanes a row and blocks of `ell_spmv` for ``rows``
    rows of ``width`` entries and x of ``n`` columns on ``sms`` SMs,
    starting from ``lanes`` a row (the tuner's block_rows).

    While the rows at that many lanes would not give each SM a full
    block of threads, a row gets twice the lanes (at most 32, and only
    while each lane keeps at least one 16-byte vector of a full row).
    Then the block halves (down to one warp, or one row) while it would
    leave an SM without a block.  The grid is one block per row block, at
    most as many as fit on the SMs at once (x in shared memory and 2,048
    threads an SM bound it), each walking row blocks with a grid stride."""
    while (lanes < 32 and rows * lanes < sms * RESIDENT_THREADS
           and 2 * lanes * VECTOR <= width):
        lanes *= 2
    threads = RESIDENT_THREADS
    while threads > max(32, lanes) and -(-rows // (threads // lanes)) < sms:
        threads //= 2
    per_block = threads // lanes
    per_sm = max(1, min(2048 // threads, 32,
                        SMEM_PER_SM // (smem_bytes(n) + 1024)))
    return {"threads": threads, "lanes": lanes, "rows_per_block": per_block,
            "grid": min(-(-rows // per_block), sms * per_sm)}


def distinct_block_rows(rows: int, width: int, n: int, sms: int,
                        block_rows=RESIDENT_ROWS) -> list[int]:
    """The values of ``block_rows``, in their order, on which `ell_spmv`
    launches differently: the first of each `launch_geometry`."""
    seen, out = set(), []
    for br in block_rows:
        geo = launch_geometry(rows, width, RESIDENT_THREADS // br, n, sms)
        key = tuple(sorted(geo.items()))
        if key not in seen:
            seen.add(key)
            out.append(br)
    return out


def slab_plan(cols: torch.Tensor, vals: torch.Tensor, n: int,
              block_rows: int, block_cols: int) -> dict:
    """What `ell_spmv_blocked` does with each (row block, slab) pair: x
    of one slab is staged by every block; of several, a pair that holds
    some of the block's nonzero entries is gathered (those entries read x
    directly) and the others are skipped.  Returns the pair counts and
    the nonzero entries gathered directly; runs on ``cols``' device."""
    rows = cols.shape[0]
    slabs = -(-n // block_cols)
    blocks = -(-rows // block_rows)
    live = vals != 0
    entries = int(live.sum())
    if slabs == 1:
        staged, gathered, direct = blocks, 0, 0
    else:
        row_block = torch.arange(rows, device=cols.device) // block_rows
        key = (row_block[:, None].expand_as(cols)[live] * slabs
               + cols[live].long() // block_cols)
        staged, gathered, direct = 0, int(torch.unique(key).numel()), entries
    return {"blocks": blocks, "slabs": slabs, "pairs": blocks * slabs,
            "staged": staged, "gathered": gathered,
            "skipped": blocks * slabs - staged - gathered,
            "direct_entries": direct, "entries": entries}


def blocked_fits(width: int, block_rows: int) -> bool:
    """Whether the blocked kernel can hold ``block_rows`` rows of
    ``width`` entries in registers."""
    if block_rows not in BLOCKED_ROWS:
        return False
    lanes = BLOCKED_THREADS // block_rows
    return -(-width // lanes) <= MAX_PER_LANE


def _check(x, cols, vals) -> None:
    if (cols.ndim != 2 or vals.shape != cols.shape or x.ndim != 1
            or min(cols.shape) < 1 or x.shape[0] < 1):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, cols "
                         f"{tuple(cols.shape)}, vals {tuple(vals.shape)}")


def _check_cuda(x, cols, vals, smem: int) -> None:
    if not (x.is_cuda and cols.device == x.device
            and vals.device == x.device):
        raise ValueError(f"x, cols and vals must lie on one CUDA device (got "
                         f"{x.device}, {cols.device}, {vals.device})")
    if (x.dtype != torch.float32 or vals.dtype != torch.float32
            or cols.dtype != torch.int32):
        raise ValueError(f"dtypes x={x.dtype}, cols={cols.dtype}, "
                         f"vals={vals.dtype}: the kernels take float32 x and "
                         f"vals and int32 cols")
    if not (x.is_contiguous() and cols.is_contiguous()
            and vals.is_contiguous()):
        raise ValueError("x, cols and vals must be contiguous")
    check_columns(cols, x.shape[0])
    if smem > hardware.H100_SXM.smem_bytes:
        raise ValueError(f"{smem} bytes of x do not fit a block's "
                         f"{hardware.H100_SXM.smem_bytes} bytes of shared "
                         f"memory: stream x in slabs (ell_spmv_blocked)")


def check_columns(cols: torch.Tensor, n: int) -> None:
    """Raise unless every column of ``cols`` lies in [0, n): the kernels
    gather x (or its staged copy) at them unchecked.  Read once for each
    cols tensor, and again after it is changed in place."""
    seen = _cols_checked.get(cols)
    if seen is not None and seen[0] == cols._version and seen[1] <= n:
        return
    lo, hi = (int(v) for v in torch.aminmax(cols))
    if lo < 0 or hi >= n:
        raise ValueError(f"cols hold columns in [{lo}, {hi}], outside x's "
                         f"[0, {n})")
    _cols_checked[cols] = (cols._version, hi + 1)


def _check_row_lens(row_lens, x, cols) -> None:
    """Shape (rows,), int32 and x's device; on the card every length
    also in [0, width], read once for each row_lens tensor and again
    after it is changed in place."""
    if tuple(row_lens.shape) != (cols.shape[0],):
        raise ValueError(f"row_lens {tuple(row_lens.shape)} is not "
                         f"({cols.shape[0]},): one length a packed row")
    if row_lens.dtype != torch.int32:
        raise ValueError(f"row_lens dtype {row_lens.dtype}: the kernel "
                         f"takes int32")
    if row_lens.device != x.device:
        raise ValueError(f"row_lens lies on {row_lens.device}, x on "
                         f"{x.device}")
    if not row_lens.is_cuda:
        return
    if not row_lens.is_contiguous():
        raise ValueError("row_lens must be contiguous")
    width = cols.shape[1]
    seen = _lens_checked.get(row_lens)
    if seen is not None and seen[0] == row_lens._version and seen[1] <= width:
        return
    lo, hi = (int(v) for v in torch.aminmax(row_lens))
    if lo < 0 or hi > width:
        raise ValueError(f"row_lens hold lengths in [{lo}, {hi}], outside "
                         f"[0, {width}]")
    _lens_checked[row_lens] = (row_lens._version, hi)


def _lib():
    lib = _build.library("ell_spmv")
    if lib.ell_spmv.argtypes is None:
        lib.ell_spmv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
        lib.ell_spmv.restype = ctypes.c_int
        lib.ell_spmv_blocked.argtypes = ([ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 5
                                         + [ctypes.c_void_p])
        lib.ell_spmv_blocked.restype = ctypes.c_int
    return lib


def ell_spmv(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             block_rows: int = 32,
             row_lens: torch.Tensor | None = None) -> torch.Tensor:
    """y = A @ x for A in padded ELL form (cols int32, vals float32, both
    (rows, W); every column below len(x)), x staged whole in shared
    memory.  ``row_lens`` (int32 (rows,) on x's device, each in [0, W]):
    row r's entries are its first row_lens[r]; None: all W.  y (rows,)
    in vals' dtype."""
    _check(x, cols, vals)
    if row_lens is not None:
        _check_row_lens(row_lens, x, cols)
    if all(t.device.type == "cpu" for t in (x, cols, vals)):
        return ref.spmv_ell_ref(cols, vals, x, row_lens)
    n = x.shape[0]
    _check_cuda(x, cols, vals, smem_bytes(n))
    if block_rows not in RESIDENT_ROWS:
        raise ValueError(f"block_rows {block_rows} not supported by "
                         f"ell_spmv (supported: {RESIDENT_ROWS})")
    rows, width = cols.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    geo = launch_geometry(rows, width, RESIDENT_THREADS // block_rows, n,
                          sms)
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    err = _lib().ell_spmv(x.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                          None if row_lens is None else row_lens.data_ptr(),
                          y.data_ptr(), rows, width, n, geo["lanes"],
                          geo["threads"], geo["grid"],
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return y


def ell_spmv_blocked(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                     block_rows: int = 16,
                     block_cols: int = 4096) -> torch.Tensor:
    """y = A @ x with x streamed in slabs of ``block_cols`` columns, so n
    is not bounded by shared memory.  As `ell_spmv` otherwise."""
    _check(x, cols, vals)
    if block_cols < 1:
        raise ValueError(f"block_cols must be >= 1, got {block_cols}")
    if all(t.device.type == "cpu" for t in (x, cols, vals)):
        return ref.spmv_blocked_ref(cols, vals, x, block_cols)
    _check_cuda(x, cols, vals, smem_bytes(x.shape[0], block_cols))
    rows, width = cols.shape
    if not blocked_fits(width, block_rows):
        raise ValueError(
            f"block_rows {block_rows} not supported by ell_spmv_blocked at "
            f"width {width}: block_rows in {BLOCKED_ROWS} with "
            f"ceil(width / ({BLOCKED_THREADS} / block_rows)) <= "
            f"{MAX_PER_LANE}")
    y = torch.empty(rows, dtype=torch.float32, device=x.device)
    err = _lib().ell_spmv_blocked(
        x.data_ptr(), cols.data_ptr(), vals.data_ptr(), y.data_ptr(), rows,
        width, x.shape[0], BLOCKED_THREADS // block_rows, block_cols,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv_blocked kernel launch failed: CUDA "
                           f"error {err}")
    global blocked_launches
    blocked_launches += 1
    return y
