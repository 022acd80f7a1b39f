"""K11: the table gradient of a row gather, the CUDA kernel
``csrc/gather_rows.cu``, and ``GatherRows``, the autograd function of
``ops/intersect.gather_rows``.

Port of the custom VJP ``tpu_ray/ops/intersect.py`` ``gather_rows``
(``_gather_rows_bwd``): no ``pallas_call``, but the JAX package wrote its
transpose by hand because XLA's scatter-add was serial, and PyTorch's
backward of ``table[idx]`` is too (one warp a run of equal indices; every
miss gathers row 0). K11 puts the lanes in a stable order by idx with its
own LSD counting sort (int32 keys and lane ids, over only the bits n - 1
needs), then sums each row in one fixed order, split over levels of
32-entry chunks, with no float atomics (the kernel's header has both).

``gather_rows_bwd`` takes the plain version ``gather_rows_bwd_plain`` for
CPU tensors only; for CUDA tensors it launches K11 or raises. The plain
version repeats K11's order of sums, so the two agree bit for bit; it
takes the stable order from ``torch.sort``, which is the same order as
K11's sort (its plain mirror is ``stable_order_plain``). ``stable_order``
and ``gather_rows_fold`` run K11's sort and its fold alone, for checks
and timing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_ray_torch.kernels import build

__all__ = ["CHUNK", "GatherRows", "RADIX_BITS", "TILE", "fold_plain",
           "gather_rows_bwd", "gather_rows_bwd_plain", "gather_rows_fold",
           "radix_passes", "stable_order", "stable_order_plain"]

# entries one lane folds at each level (csrc/gather_rows.cu TRT_GR_CHUNK)
CHUNK = 32
# entries of a tile of the sort, and bits of a pass at most
# (TRT_GR_TILE, TRT_GR_RADIX)
TILE = 4096
RADIX_BITS = 9
# one-hot entries a step of stable_order_plain's rank holds at most
_RANK_BUDGET = 1 << 22


def radix_passes(n: int):
    """[(shift, bits)] of K11's sort over keys in [0, n): the bits n - 1
    needs, split as evenly as possible over the fewest passes of at most
    RADIX_BITS, the larger passes first (csrc/gather_rows.cu gr_plan)."""
    b = max(int(n) - 1, 0).bit_length()
    p = -(-b // RADIX_BITS)
    out, shift = [], 0
    for i in range(p):
        bits = b // p + (i < b % p)
        out.append((shift, bits))
        shift += bits
    return out


def _tile_ranks(d, n_dig: int):
    """[R]: the rank of each entry among the entries of its digit d in its
    tile of TILE, in lane order."""
    r = d.shape[0]
    nt = -(-r // TILE)
    dt = F.pad(d, (0, nt * TILE - r), value=n_dig).view(nt, TILE)
    rank = torch.empty_like(dt)
    step = max(1, _RANK_BUDGET // (TILE * (n_dig + 1)))
    for t in range(0, nt, step):
        at = dt[t:t + step, :, None]
        oh = torch.zeros((at.shape[0], TILE, n_dig + 1), dtype=torch.int32,
                         device=d.device).scatter_(2, at, 1)
        seen = oh.cumsum(1, dtype=torch.int32).gather(2, at)[..., 0]
        rank[t:t + step] = seen - 1
    return rank.view(-1)[:r]


def stable_order_plain(idx, n: int):
    """(keys [R] int32, ids [R] int32): idx [R] (in [0, n)) in stable
    sorted order and the lane of each, by K11's passes (``radix_passes``)
    in vectorised PyTorch. A pass: each entry's digit and tile of TILE
    entries; the digit counts of every tile, scanned exclusively in (digit,
    tile) order; an entry's place the scan at its (digit, tile) + its rank
    among its digit in its tile, in lane order."""
    r = idx.shape[0]
    keys = idx.long()
    ids = torch.arange(r, device=idx.device)
    if r:
        nt = -(-r // TILE)
        tile = ids // TILE
        for shift, bits in radix_passes(n):
            n_dig = 1 << bits
            d = (keys >> shift) & (n_dig - 1)
            slot = d * nt + tile
            counts = torch.bincount(slot, minlength=n_dig * nt)
            at = (counts.cumsum(0) - counts)[slot] + _tile_ranks(d, n_dig)
            keys = keys.new_empty(r).index_put_((at,), keys)
            ids = ids.new_empty(r).index_put_((at,), ids)
    return keys.int(), ids.int()


def _run_ends(keys):
    """[m] bool: True at the last entry of each run of equal keys."""
    ends = torch.ones_like(keys, dtype=torch.bool)
    ends[:-1] = keys[1:] != keys[:-1]
    return ends


def _fold_level(keys, vals):
    """One level of K11's order over keys [m] int64 (sorted) and vals [m,w]
    -> [m,w], each run's sum at its last entry (other rows: partial
    folds). Each chunk of CHUNK entries folds its runs in order from +0.0
    (the down pass); the chunks' tails are the next level; a run that
    began in an earlier chunk takes the next level's sum over those chunks
    (the up pass)."""
    m, w = vals.shape
    nb = -(-m // CHUNK)
    pad = nb * CHUNK - m
    # entry s of every block at [s]: one contiguous [nb,w] slab a step
    kb = F.pad(keys, (0, pad), value=-1).view(nb, CHUNK).T
    vb = F.pad(vals, (0, 0, 0, pad)).view(nb, CHUNK, w).transpose(0, 1)
    vb = vb.contiguous()
    new = torch.ones_like(kb, dtype=torch.bool)
    new[1:] = kb[1:] != kb[:-1]
    new = new[..., None]
    fold = torch.empty_like(vb)
    acc = vals.new_zeros(nb, w)
    for s in range(CHUNK):
        acc = torch.add(acc.masked_fill(new[s], 0.0), vb[s], out=fold[s])
    out = fold.transpose(0, 1).reshape(-1, w)[:m]
    if nb == 1:
        return out
    dev = keys.device
    last = (torch.arange(nb, device=dev) * CHUNK + CHUNK - 1).clamp(max=m - 1)
    up = _fold_level(keys[last], out[last])
    b = torch.arange(1, nb, device=dev)
    start = b * CHUNK
    eb = F.pad(_run_ends(keys), (0, pad), value=True).view(nb, CHUNK)[1:]
    # block b's first run began in an earlier block and ends in block b
    sel = (keys[start - 1] == keys[start]) & eb.any(1)
    b = b[sel]
    p = start[sel] + eb[sel].int().argmax(1)
    at_last = (p == last[b])[:, None]
    out[p] = torch.where(at_last, up[b], up[b - 1] + out[p])
    return out


def fold_plain(keys, ids, g, n: int):
    """d_table [n,w]: row k the sum of the rows g[ids[j]] of g [R,w] over
    the entries j with keys[j] == k (keys [R] sorted, the order stable),
    rows no entry names +0.0, in K11's order. Vectorised: a loop over the
    CHUNK entries of a chunk at each level, none over lanes or rows."""
    r, w = g.shape
    d = g.new_zeros(n, w)
    if r == 0:
        return d
    keys = keys.long()
    out = _fold_level(keys, g.index_select(0, ids.long()))
    ends = _run_ends(keys)
    d[keys[ends]] = out[ends]
    return d


def gather_rows_bwd_plain(idx, g, n: int):
    """d_table [n,w]: row k the sum of g[r] [R,w] over every lane r with
    idx[r] == k (idx [R] int in [0, n)), rows no lane gathers +0.0, in K11's
    order: ``fold_plain`` over ``torch.sort(idx, stable=True)``."""
    keys, ids = torch.sort(idx, stable=True)
    return fold_plain(keys, ids, g, n)


def _launch_checks(idx, g, n: int):
    """(r, w) of a K11 launch on idx [R] int32 and g [R,w] f32 CUDA
    tensors on one device into n rows; raises on anything else."""
    if g.dim() != 2:
        raise ValueError(f"g: expected [R,w], got {tuple(g.shape)}")
    r, w = g.shape
    build.require(g, "g", torch.float32, (r, w), g.device)
    build.require(idx, "idx", torch.int32, (r,), g.device)
    if n < 1:
        raise ValueError(f"n: a table of {n} rows")
    return r, w


def _scratch(lib, r: int, w: int, n: int, dev):
    words = lib.trt_gather_rows_scratch(r, w, n)
    if words < 0:
        raise ValueError(f"K11: the scratch of {r} lanes of width {w} into "
                         f"{n} rows passes 2^31 - 1 words")
    return torch.empty(words, dtype=torch.int32, device=dev)


def gather_rows_bwd(idx, g, n: int):
    """idx [R] int32, g [R,w] f32 -> d_table [n,w] f32, the sums of
    ``gather_rows_bwd_plain`` (bit for bit). CUDA tensors launch K11 (one
    launch counted: its stable sort by idx, then its fold); CPU tensors
    take the plain version."""
    if not g.is_cuda:
        return gather_rows_bwd_plain(idx, g, n)
    r, w = _launch_checks(idx, g, n)
    dev = g.device
    lib = build.load()
    with torch.cuda.device(dev):
        scratch = _scratch(lib, r, w, n, dev)
        d = torch.empty((n, w), dtype=torch.float32, device=dev)
        err = lib.trt_gather_rows_bwd(idx.data_ptr(), g.data_ptr(), r, w, n,
                                      d.data_ptr(), scratch.data_ptr(),
                                      build.stream_of(g))
    build.check("trt_gather_rows_bwd", err)
    gather_rows_bwd.launches += 1
    return d


def stable_order(idx, n: int):
    """(keys [R] int32, ids [R] int32): idx [R] int32 (in [0, n)) in stable
    sorted order and the lane of each. CUDA tensors launch K11's sort alone
    (counted apart from ``gather_rows_bwd``); CPU tensors take
    ``stable_order_plain``."""
    if not idx.is_cuda:
        return stable_order_plain(idx, n)
    r = idx.shape[0]
    build.require(idx, "idx", torch.int32, (r,))
    if n < 1:
        raise ValueError(f"n: a table of {n} rows")
    dev = idx.device
    lib = build.load()
    with torch.cuda.device(dev):
        scratch = _scratch(lib, r, 1, n, dev)
        keys = torch.empty(r, dtype=torch.int32, device=dev)
        ids = torch.empty(r, dtype=torch.int32, device=dev)
        err = lib.trt_gather_rows_sort(idx.data_ptr(), r, n, keys.data_ptr(),
                                       ids.data_ptr(), scratch.data_ptr(),
                                       build.stream_of(idx))
    build.check("trt_gather_rows_sort", err)
    stable_order.launches += 1
    return keys, ids


def gather_rows_fold(keys, ids, g, n: int):
    """K11's fold alone: keys, ids [R] int32 (``stable_order``'s), g [R,w]
    f32 -> d_table [n,w] f32. CUDA tensors launch it (counted apart from
    ``gather_rows_bwd``); CPU tensors take ``fold_plain``."""
    if not g.is_cuda:
        return fold_plain(keys, ids, g, n)
    r, w = _launch_checks(keys, g, n)
    dev = g.device
    build.require(ids, "ids", torch.int32, (r,), dev)
    lib = build.load()
    with torch.cuda.device(dev):
        scratch = _scratch(lib, r, w, n, dev)
        d = torch.empty((n, w), dtype=torch.float32, device=dev)
        err = lib.trt_gather_rows_fold(keys.data_ptr(), ids.data_ptr(),
                                       g.data_ptr(), r, w, n, d.data_ptr(),
                                       scratch.data_ptr(), build.stream_of(g))
    build.check("trt_gather_rows_fold", err)
    gather_rows_fold.launches += 1
    return d


stable_order.launches = 0
gather_rows_fold.launches = 0
gather_rows_bwd.launches = 0


class GatherRows(torch.autograd.Function):
    """table[idx] (``index_select``, as JAX's forward is XLA's gather);
    the table's gradient by ``gather_rows_bwd`` (K11 on the card), idx's
    none."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, = ctx.saved_tensors
        return gather_rows_bwd(idx, g.contiguous(), ctx.n), None
