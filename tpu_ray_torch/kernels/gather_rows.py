"""K11: the table gradient of a row gather, the CUDA kernel
``csrc/gather_rows.cu``, and ``GatherRows``, the autograd function of
``ops/intersect.gather_rows``.

Port of the custom VJP ``tpu_ray/ops/intersect.py`` ``gather_rows``
(``_gather_rows_bwd``): no ``pallas_call``, but the JAX package wrote its
transpose by hand because XLA's scatter-add was serial, and PyTorch's
backward of ``table[idx]`` is too (one warp a run of equal indices; every
miss gathers row 0). K11 sums each row in one fixed order, split over
levels of 32-entry blocks, with no float atomics (the kernel's header has
the order). The lanes are first put in a stable order by idx with
``torch.sort(stable=True)``, the library sort, on the card and on the CPU
alike; the sums are K11's.

``gather_rows_bwd`` takes the plain version ``gather_rows_bwd_plain`` for
CPU tensors only; for CUDA tensors it launches K11 or raises. The plain
version repeats K11's order, so the two agree bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_ray_torch.kernels import build

__all__ = ["CHUNK", "GatherRows", "gather_rows_bwd", "gather_rows_bwd_plain"]

# entries one thread folds at each level (csrc/gather_rows.cu TRT_GR_CHUNK)
CHUNK = 32


def _run_ends(keys):
    """[m] bool: True at the last entry of each run of equal keys."""
    ends = torch.ones_like(keys, dtype=torch.bool)
    ends[:-1] = keys[1:] != keys[:-1]
    return ends


def _fold_level(keys, vals):
    """One level of K11's order over keys [m] int64 (sorted) and vals [m,w]
    -> [m,w], each run's sum at its last entry (other rows: partial
    folds). Each block of CHUNK entries folds its runs in order from +0.0
    (gather_rows_down_kernel); the blocks' tails are the next level; a
    run that began in an earlier block takes the next level's sum over
    those blocks (gather_rows_up_kernel)."""
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


def gather_rows_bwd_plain(idx, g, n: int):
    """d_table [n,w]: row k the sum of g[r] [R,w] over every lane r with
    idx[r] == k (idx [R] int in [0, n)), rows no lane gathers +0.0, in K11's
    order. Vectorised: a loop over the CHUNK entries of a block at each
    level, none over lanes or rows."""
    r, w = g.shape
    d = g.new_zeros(n, w)
    if r == 0:
        return d
    keys, perm = torch.sort(idx, stable=True)
    keys = keys.long()
    out = _fold_level(keys, g.index_select(0, perm))
    ends = _run_ends(keys)
    d[keys[ends]] = out[ends]
    return d


def gather_rows_bwd(idx, g, n: int):
    """idx [R] int32, g [R,w] f32 -> d_table [n,w] f32, the sums of
    ``gather_rows_bwd_plain`` (bit for bit). CUDA tensors launch K11 (one
    launch counted: the stable sort by idx, then its level passes); CPU
    tensors take the plain version."""
    if not g.is_cuda:
        return gather_rows_bwd_plain(idx, g, n)
    if g.dim() != 2:
        raise ValueError(f"g: expected [R,w], got {tuple(g.shape)}")
    r, w = g.shape
    dev = g.device
    build.require(g, "g", torch.float32, (r, w), dev)
    build.require(idx, "idx", torch.int32, (r,), dev)
    if n < 1:
        raise ValueError(f"n: a table of {n} rows")
    lib = build.load()
    with torch.cuda.device(dev):
        keys, perm = torch.sort(idx, stable=True)
        rows = lib.trt_gather_rows_scratch(r)
        skeys = torch.empty(rows, dtype=torch.int32, device=dev)
        svals = torch.empty((rows, w), dtype=torch.float32, device=dev)
        sout = torch.empty((rows, w), dtype=torch.float32, device=dev)
        d = torch.empty((n, w), dtype=torch.float32, device=dev)
        err = lib.trt_gather_rows_bwd(
            keys.data_ptr(), perm.data_ptr(), g.data_ptr(), r, w, n,
            d.data_ptr(), skeys.data_ptr(), svals.data_ptr(),
            sout.data_ptr(), build.stream_of(g))
    build.check("trt_gather_rows_bwd", err)
    gather_rows_bwd.launches += 1
    return d


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
