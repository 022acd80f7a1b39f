"""K1's skip of the slots that cannot hit, held on the CPU.

K1 (``csrc/sphere_intersect.cu``) folds only the slots whose r * r is > 0
in f32, in ascending slot order, each with its own id. The card tests
(tests/test_torch_cuda.py ``test_k1_edge_tables_match_plain_on_card``) hold
it bit for bit against the plain version ``ops/intersect.nearest_hit`` on
edge tables (``k1_edge_table``); here the plain version is held on the
same tables against JAX's ``nearest_hit_jnp`` (winners and hit masks
equal, t within tests/test_pallas.py's bounds) and
``nearest_hit_pallas(exact=True)`` in interpret mode (tests/test_pallas.py's
bounds, as tests/test_torch_kernels.py holds it on the scenes), and the
skip itself is shown exact: the search over the kept slots alone,
their ids mapped back, is the search over the whole table bit for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.kernels.sphere_intersect import nearest_hit_pallas
from tpu_ray.ops.intersect import nearest_hit_jnp

from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                    sphere_nearest_hit)
from test_torch_cuda import K1_CASES, K1_DUP, k1_edge_table, k1_rays
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)

R = 512


def _inputs(case):
    center, radius = k1_edge_table(case, "cpu")
    o, d = k1_rays(R, "cpu")
    return center, radius, o, d


def _check(got, ref, same_winners: bool):
    i0, t0 = np.asarray(ref.idx), np.asarray(ref.t)
    i1, t1 = got.idx.numpy(), got.t.numpy()
    assert ((t0 < 1e29) == (t1 < 1e29)).all()
    if same_winners:
        np.testing.assert_array_equal(i1, i0)
    else:
        assert (i0 == i1).mean() > 0.995, (i0 != i1).sum()
    hit = (t0 < 1e29) & (i0 == i1)
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["zeros", "negative", "underflow",
                                  "duplicates", "nan", "inside"])
def test_k1_plain_matches_jax_on_edge_tables(case):
    """Interleaved padding, negative, NaN and underflowing radii, an exact
    tie of two copies of a sphere, rays inside a sphere: the plain version
    against nearest_hit_jnp and the Pallas kernel (exact) in interpret
    mode."""
    center, radius, o, d = _inputs(case)
    got = nearest_hit_plain(center, radius, o, d)
    args = [jnp.asarray(x.numpy()) for x in (center, radius, o, d)]
    _check(got, nearest_hit_jnp(*args), True)
    _check(got, nearest_hit_pallas(*args, exact=True), False)
    if case == "duplicates":      # the lower copy wins every tie
        assert (got.idx == K1_DUP[0]).any()
        assert not (got.idx == K1_DUP[1]).any()


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_skips_padding_exactly(case):
    """The search over the slots with r * r > 0 alone, in ascending slot
    order with their ids mapped back, equals the search over every slot
    bit for bit (a miss: t = 1e30, idx 0), as K1's skip needs."""
    center, radius, o, d = _inputs(case)
    full = nearest_hit_plain(center, radius, o, d)
    kept = torch.nonzero(radius * radius > 0)[:, 0]
    if kept.numel():
        part = nearest_hit_plain(center[kept], radius[kept], o, d)
        idx = torch.where(part.t < 1e29, kept[part.idx.long()],
                          0).to(torch.int32)
        t = part.t
    else:
        t = torch.full((R,), 1e30)
        idx = torch.zeros(R, dtype=torch.int32)
    assert torch.equal(full.t.view(torch.int32), t.view(torch.int32))
    assert torch.equal(full.idx, idx)


def test_k1_wrapper_takes_plain_with_slices_on_cpu():
    """On CPU tensors the wrapper accepts slices= and launches nothing."""
    center, radius, o, d = _inputs("zeros")
    before = sphere_nearest_hit.launches
    want = nearest_hit_plain(center, radius, o, d)
    for slices in (None, 1, 7):
        got = sphere_nearest_hit(center, radius, o, d, slices=slices)
        assert torch.equal(got.t, want.t) and torch.equal(got.idx, want.idx)
    assert sphere_nearest_hit.launches == before
