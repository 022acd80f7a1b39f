"""Port parity, the row gather and its hand-written backward:
``ops/intersect.gather_rows`` (``kernels/gather_rows.GatherRows``, K11's
plain version on the CPU) against the JAX package's custom VJP
``tpu_ray.ops.intersect.gather_rows``, and the payloads built on it.

Bounds. The table's gradient: within 1e-6 x sum_r |g[r]| of JAX's per
entry (the lanes of that row), plus 1e-30. Both are f32 sums of the same
terms in different orders; JAX's one-hot product and an f32 index_add_ are
each within 1.5e-7 of that against an f64 sum, and not bit-equal to each
other. The forward is table[idx] bit for bit, and the plain backward
repeats itself bit for bit. The payloads' table gradients: the bounds of
tests/test_grad.py's remat equality (rtol 1e-4, atol 1e-7 + 1e-5 x max).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.ops import intersect as jint
from tpu_ray.ops import intersect_tri as jtri

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.gather_rows import (gather_rows_bwd,
                                               gather_rows_bwd_plain)
from tpu_ray_torch.ops import intersect_tri as ttri
from tpu_ray_torch.ops.intersect import (gather_rows, hit_payload,
                                         nearest_hit, payload_tables)
from tpu_ray_torch.ops.raygen import camera_rays

OBJ = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")
# a row that idx never takes: k % SKIP == SKIP_AT (for n > SKIP_AT)
SKIP, SKIP_AT = 7, 3


def _case(w, n, r, row0, seed=0):
    """(table [n,w], idx [r] int32, g [r,w]) numpy: idx uniform over the
    rows but those with k % 7 == 3, then a share row0 of the lanes moved
    to row 0; g standard normal."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, w)).astype(np.float32)
    rows = np.array([k for k in range(n) if k % SKIP != SKIP_AT] or [0])
    idx = rows[rng.integers(0, rows.size, r)].astype(np.int32)
    idx[rng.permutation(r)[:int(round(row0 * r))]] = 0
    g = rng.standard_normal((r, w)).astype(np.float32)
    return table, idx, g


# JAX's reference runs at one padded shape a width, so it compiles twice
# in all: the table to N_PAD rows, the lanes to R_PAD with idx 0 and g 0.
# The padded lanes add only zero terms, and rows >= n are sliced away.
N_PAD, R_PAD = 1000, 8192


@jax.jit
def _jax_bwd(table, idx, g):
    return jax.vjp(jint.gather_rows, table, idx)[1](g)[0]


def _jax_vjp(table, idx, g):
    (n, w), r = table.shape, idx.shape[0]
    tp = np.zeros((N_PAD, w), np.float32)
    tp[:n] = table
    ip = np.zeros(R_PAD, np.int32)
    ip[:r] = idx
    gp = np.zeros((R_PAD, w), np.float32)
    gp[:r] = g
    return np.asarray(_jax_bwd(tp, ip, gp))[:n]


def _abs_sum(idx, g, n):
    """sum over the lanes of each row of |g| [n,w], in f64."""
    out = np.zeros((n, g.shape[1]))
    np.add.at(out, idx, np.abs(g).astype(np.float64))
    return out


@pytest.mark.parametrize("row0", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("r", [1, 513, 8192])
@pytest.mark.parametrize("n", [1, 128, 1000])
@pytest.mark.parametrize("w", [12, 17])
def test_gather_rows_matches_jax_vjp(w, n, r, row0):
    table, idx, g = _case(w, n, r, row0, seed=w * 7 + n + r)
    t_table = torch.tensor(table, requires_grad=True)
    t_idx = torch.as_tensor(idx)
    out = gather_rows(t_table, t_idx)
    assert out.grad_fn.name() == "GatherRowsBackward"
    assert torch.equal(out.detach().view(torch.int32),
                       t_table.detach()[t_idx.long()].view(torch.int32))
    out.backward(torch.as_tensor(g))
    got = t_table.grad.numpy()
    want = _jax_vjp(table, idx, g)
    assert got.dtype == np.float32 and got.shape == (n, w)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 1e-6 * _abs_sum(idx, g, n) + 1e-30).all(), err.max()
    # rows no lane gathers: +0.0
    untouched = np.ones(n, bool)
    untouched[idx] = False
    assert (got[untouched].view(np.int32) == 0).all()
    assert untouched.any() == (n > SKIP_AT)
    # the plain backward repeats itself bit for bit; the wrapper takes it
    # on CPU tensors
    again = gather_rows_bwd_plain(t_idx, torch.as_tensor(g), n)
    assert np.array_equal(again.numpy().view(np.int32), got.view(np.int32))
    before = gather_rows_bwd.launches
    wrapped = gather_rows_bwd(t_idx, torch.as_tensor(g), n)
    assert gather_rows_bwd.launches == before
    assert torch.equal(wrapped.view(torch.int32), again.view(torch.int32))


def _gather_nodes(t):
    """The autograd nodes reachable from t's grad_fn, by name."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(node.name())
        todo += [nxt for nxt, _ in node.next_functions]
    return names


def _grads_close(a, b):
    np.testing.assert_allclose(
        a, b, rtol=1e-4, atol=1e-7 + 1e-5 * max(1e-30, np.abs(b).max()))


def _weights(p, rng):
    """A fixed random weight for each differentiable payload field."""
    return {k: rng.standard_normal(np.shape(getattr(p, k))).astype(np.float32)
            for k in ("t", "next_origin", "normal_raw", "albedo", "emissive",
                      "specular", "ior")}


def _loss_t(p, wts):
    return sum((getattr(p, k) * torch.as_tensor(v)).sum()
               for k, v in wts.items())


def _loss_j(p, wts):
    return sum((getattr(p, k) * jnp.asarray(v)).sum()
               for k, v in wts.items())


def _rays(ts, w=16, h=12, n_random=256):
    """The default camera's primary rays at w x h and seeded random rays
    from around the scene, as numpy [R,3] pairs."""
    o, d, _ = camera_rays(default_camera(ts), w, h, torch.arange(w * h), 0, 0)
    rng = np.random.default_rng(1)
    o2 = rng.uniform(-0.3, 0.3, (n_random, 3)).astype(np.float32)
    o2[:, 1] = np.abs(o2[:, 1])
    d2 = rng.normal(size=(n_random, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return np.concatenate([o.numpy(), o2]), np.concatenate([d.numpy(), d2])


def test_hit_payload_table_grad_matches_jax():
    js = jmake_scene("rtweekend")
    ts = make_scene("rtweekend", device="cpu")
    o, d = _rays(ts)
    hit = nearest_hit(ts.center, ts.radius, torch.as_tensor(o),
                      torch.as_tensor(d))
    assert 0 < int((hit.t >= 1e30).sum()) < o.shape[0]   # misses: row 0
    jh = jint.Hit(t=jnp.asarray(hit.t.numpy()),
                  idx=jnp.asarray(hit.idx.numpy()))
    table = np.asarray(jint.payload_tables(js))
    assert np.array_equal(payload_tables(ts).numpy(), table)
    t_table = torch.tensor(table, requires_grad=True)
    p = hit_payload(ts, torch.as_tensor(o), torch.as_tensor(d), hit, t_table)
    names = _gather_nodes(p.albedo)
    assert "GatherRowsBackward" in names and "IndexBackward0" not in names
    wts = _weights(p, np.random.default_rng(2))
    _loss_t(p, wts).backward()

    def jloss(tab):
        return _loss_j(jint.hit_payload(js, jnp.asarray(o), jnp.asarray(d),
                                        jh, tables=tab), wts)

    _grads_close(t_table.grad.numpy(),
                 np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(table))))


def test_tri_payload_table_grad_matches_jax():
    js = jmake_scene(f"obj:{OBJ}")
    ts = make_scene(f"obj:{OBJ}", device="cpu")
    o, d = _rays(ts)
    hit = ttri.nearest_hit_tri(ttri.tri_search_table(ts.tris),
                               torch.as_tensor(o), torch.as_tensor(d))
    assert 0 < int((hit.t < 1e30).sum()) < o.shape[0]
    jh = jint.Hit(t=jnp.asarray(hit.t.numpy()),
                  idx=jnp.asarray(hit.idx.numpy()))
    table = np.asarray(jtri.tri_payload_tables(js.tris))
    assert np.array_equal(ttri.tri_payload_tables(ts.tris).numpy(), table)
    t_table = torch.tensor(table, requires_grad=True)
    p = ttri.tri_payload(ts.tris, torch.as_tensor(o), torch.as_tensor(d),
                         hit, t_table)
    names = _gather_nodes(p.t)
    assert "GatherRowsBackward" in names and "IndexBackward0" not in names
    wts = _weights(p, np.random.default_rng(3))
    _loss_t(p, wts).backward()

    def jloss(tab):
        return _loss_j(jtri.tri_payload(js.tris, jnp.asarray(o),
                                        jnp.asarray(d), jh, tables=tab), wts)

    _grads_close(t_table.grad.numpy(),
                 np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(table))))
