"""Single-query GQA decode attention over a contiguous or a paged KV cache.

Counterpart of `repro.kernels.attention.decode`: the Pallas kernels
``decode_attention`` (GQA wrapper ``gqa_decode_attention``) and
``paged_gqa_decode_attention``.  The work is done by the hand-written
CUDA kernels ``csrc/decode_attention.cu`` and
``csrc/paged_decode_attention.cu``; ``decode_ref`` and ``paged_decode_ref``
are their plain PyTorch versions, ports of the JAX oracles.

The kernels split each row's keys into spans of ``block_k`` keys (an
argument of every call, default ``SPLIT_KEYS``; the decode tuner picks it
for the cache depth, `kernels.attention.spec`), one block each, and the
last block of a row to finish combines the spans' partial softmaxes
(``csrc/decode_body.cuh``).  That law is here in plain PyTorch too:
`split_bounds`, `combine_partials` and `split_decode_ref`.  A call
allocates the spans' workspace from the caching allocator, sized for its
own span, and shares one zeroed array of ticket counters per device and
stream (`_launch`); the kernel leaves it zero.

A wrapper takes the plain version only for tensors that lie on the CPU.
A CUDA tensor launches the kernel or raises: there is no fallback.
``launches`` and ``paged_launches`` count kernel launches, so a run can
show that its decode steps went through the kernels.

On ``meta`` tensors (the dry run's, `launch.dryrun`) a wrapper runs its
shape checks and returns an empty meta tensor of the output's shape: it
computes nothing and launches nothing, so it is no fallback.  On a meta
tensor and on a launch it adds its operations and bytes (`cost`) to the
running `core.hlo_stats.count_step`, if one runs.  A meta tensor holds no
lengths, so the charge reads every row of the cache: an upper bound where
the slots are shallower than the cache, and the same on the card, where
reading the lengths would cost a host synchronisation.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import hlo_stats
from repro_torch.kernels import _build

NEG_INF = -1e30
# Every head_dim of the configs and their SMOKE variants, plus the tiny
# test configs' 8.  The kernels give one thread to each of dh <= 128
# output columns and copy K/V rows in 16-byte pieces.
HEAD_DIMS = (8, 16, 80, 96, 128)
MAX_GROUP = 16                      # query heads per KV head (kMaxGroup)
SPLIT_KEYS = 256                    # keys per split unless a call says
_DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # decode_attention.cu
paged_launches = 0    # paged_decode_attention.cu
_tickets: dict = {}   # (device index, stream) -> zeroed int32 counters


def _lengths(length, b: int, kl: int, device) -> torch.Tensor:
    """``length`` (int, 0-d or (B,) tensor) as a clamped (B,) int32 tensor
    on ``device`` — `_row_lengths` of the JAX kernel, before the fold.  A
    contiguous (B,) int32 tensor on a card is passed as it is, with no
    device operation: the kernels clamp each length to [0, rows]."""
    if (isinstance(length, torch.Tensor) and length.is_cuda
            and length.device == torch.device(device)
            and length.dtype == torch.int32 and length.shape == (b,)
            and length.is_contiguous()):
        return length
    lv = torch.as_tensor(length, dtype=torch.int32, device=device)
    if lv.ndim == 0:
        lv = lv.expand(b)
    elif lv.shape != (b,):
        raise ValueError(f"length must be a scalar or a ({b},) per-sequence "
                         f"vector, got shape {tuple(lv.shape)}")
    return torch.clamp(lv, 0, kl).to(torch.int32).contiguous()


def num_splits(rows: int, span: int = SPLIT_KEYS) -> int:
    """Splits of the kernels' grid for a cache of ``rows`` rows: sized from
    the shape alone, never from the lengths, and at least one."""
    return max(1, -(-rows // span))


def split_bounds(length: int, rows: int, span: int = SPLIT_KEYS
                 ) -> list[tuple[int, int]]:
    """The key ranges [lo, hi) of the splits that hold keys of a row of
    ``length`` valid keys (clamped to [0, rows]): split s holds keys
    [s * span, (s + 1) * span) cut at the length.  The grid's other
    splits, of `num_splits` (rows), start at or past the length and write
    nothing.  The bounds follow key positions alone, so a paged cache
    (rows = max_pages * page_size) splits a row as a contiguous one does."""
    n = min(max(int(length), 0), rows)
    return [(lo, min(lo + span, n)) for lo in range(0, n, span)]


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                     ) -> torch.Tensor:
    """The kernels' combine of split partials, in f32: splits along dim 0
    (m, l: (S, ...); acc: (S, ..., dh)).  With M = max m_i, the output is
    sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), both sums taken in
    ascending split order; an empty partial (l = 0, m = -1e30) weighs 0,
    and a row with no key gives 0."""
    mx = m.amax(0)
    o = torch.zeros_like(acc[0])
    lsum = torch.zeros_like(l[0])
    for i in range(m.shape[0]):
        w = torch.exp(m[i] - mx)
        lsum = lsum + l[i] * w
        o = o + acc[i] * w[..., None]
    return o / lsum.clamp_min(1e-30)[..., None]


def split_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length, scale: float | None = None,
                     span: int = SPLIT_KEYS) -> torch.Tensor:
    """Plain version of the kernels' split law: `decode_ref` computed as
    the kernels compute it, each split's partial softmax (its max m, sum l
    and unnormalised p @ V) on its own, then `combine_partials`.  Shapes as
    `decode_ref`; f32 throughout, q's dtype out."""
    b, hq, dh = q.shape
    _, kl, hkv, _ = k.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    ns = num_splits(kl, span)
    pad = ns * span - kl
    kr, vr = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
              .transpose(1, 2).reshape(b, hkv, ns, span, dh) for x in (k, v))
    qr = q.reshape(b, hkv, g, dh).float()
    s = torch.einsum("bhgd,bhsjd->bhsgj", qr, kr) * scale
    lv = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    lv = lv.expand(b) if lv.ndim == 0 else lv
    pos = torch.arange(ns * span, device=q.device).reshape(ns, span)
    valid = (pos[None] < lv.clamp(0, kl)[:, None, None])[:, None, :, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhsgj,bhsjd->bhsgd", p, vr)
    out = combine_partials(m.movedim(2, 0), p.sum(-1).movedim(2, 0),
                           acc.movedim(2, 0))
    return out.reshape(b, hq, dh).to(q.dtype)


def split_span(block_k: int | None) -> int:
    """The keys of one split for a call's ``block_k``: `SPLIT_KEYS` for
    None, else ``block_k`` itself, which must be a positive int (the
    kernels take any span: a block's walk stops at the end of its span)."""
    if block_k is None:
        return SPLIT_KEYS
    if isinstance(block_k, bool) or int(block_k) != block_k or block_k < 1:
        raise ValueError(f"block_k must be a positive int (keys per split) "
                         f"or None, got {block_k!r}")
    return int(block_k)


def _launch(name: str, q: torch.Tensor, ptrs, ints, strides, *, batch: int,
            hkv: int, g: int, dh: int, rows: int, span: int, scale: float
            ) -> torch.Tensor:
    """Launch the C entry ``name`` of ``csrc/<name>.cu`` (built on first
    use): its pointers up to the lengths, then the output, the workspace
    and the tickets; its ints and the span; its 64-bit strides, then the
    workspace's size, the f32 scale and the stream.  The workspace of the
    split partials comes from the caching allocator, sized for this call's
    ``span`` (two calls of different spans never share a size); the
    ticket counters of q's
    device and stream are one zeroed int32 array kept between calls
    (every launch leaves it zero), replaced by a larger zeroed one when a
    call needs more and dropped if a launch fails.  Returns the output."""
    lib = _build.library(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (len(ptrs) + 3)
                       + [ctypes.c_int] * (len(ints) + 1)
                       + [ctypes.c_longlong] * (len(strides) + 1)
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    stream = _stream(q)
    nsplit = num_splits(rows, span)
    part = torch.empty(batch * hkv * nsplit * g * (dh + 2),
                       dtype=torch.float32, device=q.device)
    key = (q.device.index, stream)
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < batch * hkv:
        tickets = torch.zeros(max(batch * hkv, 64), dtype=torch.int32,
                              device=q.device)
        _tickets[key] = tickets
    out = torch.empty((batch, hkv * g, dh), dtype=q.dtype, device=q.device)
    err = fn(*ptrs, out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
             *ints, span, *strides, part.numel(), float(scale), stream)
    if err != 0:
        _tickets.pop(key, None)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def cost(q: torch.Tensor, rows: int, *caches: torch.Tensor,
         stats: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one decode call over ``rows`` key rows a
    slot: ``4 dh Hq B rows`` operations; q and the output, and every
    slot's ``rows`` rows of each cache array (K and V codes or values,
    int8 scales; a row of a (.., rows, Hkv[, dh]) array or pool is its
    trailing dims), each once; with ``stats`` the (2, B, Hq) f32
    statistics written too."""
    b, hq, dh = q.shape
    row_bytes = sum(math.prod(c.shape[2:]) * c.element_size()
                    for c in caches)
    return (4.0 * dh * hq * b * rows,
            2.0 * q.numel() * q.element_size() + float(b * rows * row_bytes)
            + (8.0 * b * hq if stats else 0.0))


def charge(name: str, q: torch.Tensor, rows: int, *caches,
           stats: bool = False) -> None:
    """A call's `cost` added to the running `count_step`, if one
    runs."""
    if hlo_stats.counting():
        hlo_stats.charge(name, *cost(q, rows, *caches, stats=stats))


def meta_output(name: str, q: torch.Tensor, rows: int, *caches
                ) -> torch.Tensor:
    """The meta branch of a decode wrapper: its `charge`, and an empty
    (B, Hq, dh) meta output in q's dtype."""
    charge(name, q, rows, *caches)
    return torch.empty(q.shape, dtype=q.dtype, device="meta")


def check_gqa(q: torch.Tensor, hkv: int, dh: int) -> int:
    """The group size g = Hq / Hkv of ``q`` (B, Hq, dh) against a cache of
    ``hkv`` heads of ``dh``; raises on a mismatch."""
    hq = q.shape[1]
    if q.shape[2] != dh:
        raise ValueError(f"q head_dim {q.shape[2]} != cache head_dim {dh}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    return hq // hkv


def check_cuda(q: torch.Tensor, tensors, g: int) -> None:
    """What every CUDA decode kernel needs of its operands: one card, a
    supported head_dim and group, a contiguous last axis of q, and cache
    rows copied in 16-byte pieces (address and every stride but the last a
    multiple of 16 bytes).  ``tensors`` are the cache arrays of (.., dh)
    rows."""
    dh = q.shape[2]
    if not (q.is_cuda and all(t.is_cuda for t in tensors)):
        raise ValueError("q and the cache must all lie on one CUDA device "
                         f"(got {q.device}, "
                         f"{', '.join(str(t.device) for t in tensors)})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the CUDA decode "
                         f"kernels (supported: {HEAD_DIMS})")
    if g > MAX_GROUP:
        raise ValueError(f"GQA group {g} > {MAX_GROUP} query heads per KV "
                         f"head is not supported by the CUDA decode kernels")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: must be float32 or bfloat16")
    if q.stride(2) != 1 or any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("q and the cache need a contiguous last (dh) axis")
    for t in tensors:
        elt = t.element_size()
        if t.data_ptr() % 16 or any(s * elt % 16 for s in t.stride()[:-1]):
            raise ValueError(
                "the kernels copy cache rows in 16-byte pieces: their "
                "address and strides must be multiples of 16 bytes"
                + (" (int8 rows: head_dim a multiple of 16)"
                   if t.dtype == torch.int8 else ""))


def page_table(pages: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``pages`` as the contiguous (B, max_pages) int32 table on q's card
    that the kernels read."""
    if pages.ndim != 2 or pages.shape[0] != q.shape[0]:
        raise ValueError(f"pages must be ({q.shape[0]}, max_pages), got "
                         f"{tuple(pages.shape)}")
    if pages.device != q.device:
        raise ValueError(f"pages lie on {pages.device}, q on {q.device}")
    return pages.to(torch.int32).contiguous()


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               length, scale: float | None = None,
               return_stats: bool = False):
    """Plain version (materialized logits), a port of the JAX
    ``decode_ref``.  q: (B, Hq, dh); k, v: (B, L, Hkv, dh); ``length`` a
    scalar or (B,).  Computes in f32 and returns q's dtype; a slot with
    length 0 returns zeros.  As in the kernels, no key or value row at or
    past a slot's length enters its output: a NaN there (another slot's
    poisoned page, through a table entry clamped to page 0) stays out,
    where a probability of 0 times NaN would not.  ``return_stats`` also
    returns each row's softmax statistics, (B, Hq) f32 m (the largest
    scaled score) and l (the sum of e^(s - m)): m = -1e30 and l = 0 for
    a slot of length 0."""
    b, hq, dh = q.shape
    _, kl, hkv, _ = k.shape
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    qr = q.reshape(b, hkv, g, dh).float()
    kr = k.transpose(1, 2).float()                       # (b, hkv, kl, dh)
    vr = v.transpose(1, 2).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qr, kr) * scale
    lv = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    if lv.ndim == 0:
        lv = lv.expand(b)
    valid = torch.arange(kl, device=q.device)[None, :] < lv[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    vr = torch.where(valid[:, None, :, None], vr, 0.0)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, vr)
    out = torch.where((lv > 0)[:, None, None, None], out, 0.0)
    out = out.reshape(b, hq, dh).to(q.dtype)
    if not return_stats:
        return out
    m = s.amax(-1)
    live = (lv > 0)[:, None, None]
    l = torch.where(live, torch.where(valid[:, None, None, :],
                                      torch.exp(s - m[..., None]),
                                      0.0).sum(-1), 0.0)
    m = torch.where(live, m, NEG_INF)
    return out, m.reshape(b, hq), l.reshape(b, hq)


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Each slot's pages of ``pool`` (num_pages, page_size, ...) copied
    into a (B, max_pages * page_size, ...) tensor, as a contiguous cache
    would hold them; entries are clamped to [0, num_pages), as the kernels
    clamp them."""
    b, mp = pages.shape
    safe = pages.long().clamp(0, pool.shape[0] - 1)
    g = pool[safe]                           # (B, mp, page_size, ...)
    return g.reshape(b, mp * pool.shape[1], *pool.shape[2:])


def paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, pages: torch.Tensor, *, length,
                     scale: float | None = None) -> torch.Tensor:
    """Plain version of `paged_gqa_decode_attention`, a port of the JAX
    ``paged_decode_ref``: gather each slot's pages back into a contiguous
    view, then `decode_ref`."""
    lv = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    if lv.ndim == 0:
        lv = lv.expand(q.shape[0])
    return decode_ref(q, gather_pages(k_pool, pages),
                      gather_pages(v_pool, pages), length=lv, scale=scale)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, length, scale: float | None = None,
                         block_k: int | None = None,
                         return_stats: bool = False):
    """q: (B, Hq, dh); k, v: (B, L, Hkv, dh) -> (B, Hq, dh) in q's dtype.

    ``length`` is a scalar or a (B,) vector of valid cache prefixes,
    clamped to L.  Keys at or past a slot's length are never read; a slot
    of length 0 gets zeros.  The cache is read in place through its
    strides (no transpose or fold copies), which needs its last axis
    contiguous.  ``block_k`` is the keys of one split (`split_span`); the
    plain version on the CPU computes the same function at any span.  On
    meta tensors: the output's shape, nothing computed, and the call's
    `cost` at L rows charged to a running count.

    ``return_stats`` also returns each (b, query head) row's softmax
    statistics, (B, Hq) f32 ``m`` (its largest scaled score) and ``l``
    (the sum of e^(s - m) over its keys), written by the block that
    writes the row's output (the only split, or the last to finish, at
    its combine); a slot of length 0 gives m = -1e30, l = 0, the empty
    partial `combine_partials` weighs 0.  So a row whose keys lie in
    several caches (a cache split by sequence over ranks) is the
    `combine_partials` of the parts' ``out * l``.
    """
    b, hq, dh = q.shape
    _, kl, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    g = check_gqa(q, hkv, dh)
    span = split_span(block_k)
    if q.device.type == "meta":
        if not return_stats:
            return meta_output("decode_attention", q, kl, k, v)
        charge("decode_attention", q, kl, k, v, stats=True)
        st = torch.empty((2, b, hq), dtype=torch.float32, device="meta")
        return torch.empty(q.shape, dtype=q.dtype, device="meta"), st[0], \
            st[1]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lengths = _lengths(length, b, kl, q.device)
    if q.device.type == "cpu" and k.device.type == "cpu":
        return decode_ref(q, k, v, length=lengths, scale=scale,
                          return_stats=return_stats)
    check_cuda(q, (k, v), g)
    if k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"cache dtypes k={k.dtype}, v={v.dtype}: the cache "
                         f"must be float32 or bfloat16")
    stats = (torch.empty((2, b, hq), dtype=torch.float32, device=q.device)
             if return_stats else None)
    out = _launch(
        "decode_attention", q,
        (q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
         None if stats is None else stats.data_ptr()),
        (int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), b,
         hkv, g, dh, kl),
        (q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3]),
        batch=b, hkv=hkv, g=g, dh=dh, rows=kl, span=span, scale=scale)
    global launches
    launches += 1
    charge("decode_attention", q, kl, k, v, stats=return_stats)
    return out if stats is None else (out, stats[0], stats[1])


def paged_gqa_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, pages: torch.Tensor, *,
                               length, scale: float | None = None,
                               block_k: int | None = None) -> torch.Tensor:
    """Decode attention through a paged KV cache.

    q: (B, Hq, dh); k_pool, v_pool: (num_pages, page_size, Hkv, dh), the
    layer's page pools shared by every slot; pages: (B, max_pages) int32
    page table, -1 = no page; ``length`` a scalar or (B,) vector of valid
    prefixes, clamped to max_pages * page_size.  Key t of slot b is row
    t % page_size of pool page pages[b, t // page_size] (clamped to the
    pool); keys at or past a slot's length, and so the -1 entries past its
    last page, are never read.  ``block_k`` is the keys of one split
    (`split_span`), counted in key positions whatever the page size.
    Returns (B, Hq, dh) in q's dtype.  On meta tensors as
    `gqa_decode_attention`, at max_pages * page_size rows.
    """
    b, _, dh = q.shape
    num_pages, page_size, hkv, _ = k_pool.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != dh:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}")
    g = check_gqa(q, hkv, dh)
    span = split_span(block_k)
    max_pages = pages.shape[1]
    if q.device.type == "meta":
        return meta_output("paged_decode_attention", q,
                           max_pages * page_size, k_pool, v_pool)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    lengths = _lengths(length, b, max_pages * page_size, q.device)
    if q.device.type == "cpu" and k_pool.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, pages, length=lengths,
                                scale=scale)
    check_cuda(q, (k_pool, v_pool), g)
    if k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"pool dtypes k={k_pool.dtype}, v={v_pool.dtype}: "
                         f"the pools must be float32 or bfloat16")
    table = page_table(pages, q)
    out = _launch(
        "paged_decode_attention", q,
        (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
         table.data_ptr(), lengths.data_ptr()),
        (int(q.dtype == torch.bfloat16), int(k_pool.dtype == torch.bfloat16),
         b, hkv, g, dh, num_pages, page_size, max_pages),
        (q.stride(0), q.stride(1), *k_pool.stride()[:3],
         *v_pool.stride()[:3]),
        batch=b, hkv=hkv, g=g, dh=dh, rows=max_pages * page_size,
        span=span, scale=scale)
    global paged_launches
    paged_launches += 1
    charge("paged_decode_attention", q, max_pages * page_size, k_pool,
           v_pool)
    return out
