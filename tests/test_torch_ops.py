"""Port parity, ops layer: each tpu_ray_torch.ops function against its
tpu_ray.ops twin on random inputs made with numpy."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.ops import accumulate as jacc
from tpu_ray.ops import intersect as jint
from tpu_ray.ops import shade as jshade
from tpu_ray.ops import tonemap as jtone
from tpu_ray.ops import vec as jvec

from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.ops import accumulate as tacc
from tpu_ray_torch.ops import intersect as tint
from tpu_ray_torch.ops import shade as tshade
from tpu_ray_torch.ops import tonemap as ttone
from tpu_ray_torch.ops import vec as tvec

R = 4096


def _t(a):
    return torch.as_tensor(np.array(a))


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rays(g, scene_name):
    """Origins spread over the scene's extent, random unit directions."""
    c = np.asarray(jmake_scene(scene_name).center)
    lo, hi = c.min(0), c.max(0)
    span = np.maximum(hi - lo, 1e-3)
    o = (lo + span * g.uniform(-0.2, 1.2, (R, 3))).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])   # above the big ground spheres
    return o, _unit(g, R)


@pytest.fixture(scope="module", params=["rgb", "randomized", "rtweekend"])
def hits(request):
    """(scene name, origins, directions, jax Hit, port Hit)."""
    name = request.param
    g = np.random.default_rng(3)
    o, d = _rays(g, name)
    js = jmake_scene(name)
    ts = make_scene(name, device="cpu")
    jh = jint.nearest_hit_jnp(js.center, js.radius, jnp.asarray(o),
                              jnp.asarray(d))
    th = tint.nearest_hit(ts.center, ts.radius, _t(o), _t(d))
    return name, o, d, jh, th


def test_nearest_hit(hits):
    _, _, _, jh, th = hits
    np.testing.assert_array_equal(th.idx.numpy(), np.asarray(jh.idx))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6,
                               atol=1e-6)
    assert th.idx.dtype == torch.int32


def test_nearest_hit_hits_something(hits):
    # the random rays exercise both hits and misses
    _, _, _, _, th = hits
    hit = th.t.numpy() < 1e29
    assert 0.05 < hit.mean() < 0.999


def test_nearest_hit_tie_takes_lowest_index():
    center = _t(np.float32([[0, 0, 5], [0, 0, 5], [0, 0, 9]]))
    radius = _t(np.float32([1, 1, 1]))
    o = _t(np.float32([[0, 0, 0], [0, 0, 5], [9, 9, 9]]))
    d = _t(np.float32([[0, 0, 1], [0, 0, 1], [1, 0, 0]]))
    h = tint.nearest_hit(center, radius, o, d)
    # ray 1 starts inside spheres 0/1 -> far root; ray 2 misses -> (1e30, 0)
    assert h.idx.tolist() == [0, 0, 0]
    np.testing.assert_allclose(h.t.numpy(), [4.0, 1.0, 1e30], rtol=1e-6)


def test_hit_payload(hits):
    name, o, d, jh, th = hits
    js = jmake_scene(name)
    ts = make_scene(name, device="cpu")
    jp = jint.hit_payload(js, jnp.asarray(o), jnp.asarray(d), jh)
    tp = tint.hit_payload(ts, _t(o), _t(d), th)
    hit = np.asarray(jp.hit)
    np.testing.assert_array_equal(tp.hit.numpy(), hit)
    for f in ("inside", "idx"):
        np.testing.assert_array_equal(getattr(tp, f).numpy()[hit],
                                      np.asarray(getattr(jp, f))[hit], f)
    for f in ("t", "next_origin", "normal_raw", "albedo", "emissive",
              "specular", "ior"):
        np.testing.assert_allclose(getattr(tp, f).numpy()[hit],
                                   np.asarray(getattr(jp, f))[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.fixture(scope="module")
def scatter_inputs():
    g = np.random.default_rng(11)
    n = 8192
    d = _unit(g, n)
    nrm = (_unit(g, n) * g.uniform(0.01, 2.0, (n, 1))).astype(np.float32)
    inside = g.random(n) < 0.3
    spec = np.where(g.random(n) < 0.5, g.random(n), 0.0).astype(np.float32)
    ior = np.where(g.random(n) < 0.4, 1.5, 0.0).astype(np.float32)
    rand3 = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    rr = g.uniform(0, 1, n).astype(np.float32)
    return d, nrm, inside, spec, ior, rand3, rr


def test_scatter_direction(scatter_inputs):
    args = scatter_inputs
    ref = np.asarray(jshade.scatter_direction(*map(jnp.asarray, args)))
    got = tshade.scatter_direction(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_schlick_reflectance():
    g = np.random.default_rng(2)
    c = g.uniform(-1, 1, 1000).astype(np.float32)
    ri = g.uniform(0.5, 2.0, 1000).astype(np.float32)
    np.testing.assert_allclose(
        tshade.schlick_reflectance(_t(c), _t(ri)).numpy(),
        np.asarray(jshade.schlick_reflectance(jnp.asarray(c), jnp.asarray(ri))),
        rtol=1e-6, atol=1e-7)


def test_sky_color():
    d = _unit(np.random.default_rng(5), 2048)
    np.testing.assert_allclose(tshade.sky_color(_t(d)).numpy(),
                               np.asarray(jshade.sky_color(jnp.asarray(d))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["dot", "safe_sqrt", "normalize_eps",
                                "reflect"])
def test_vec(fn):
    g = np.random.default_rng(9)
    a = g.normal(size=(4096, 3)).astype(np.float32) * 0.05
    b = _unit(g, 4096)
    args = {"dot": (a, b), "safe_sqrt": (a[:, 0],), "normalize_eps": (a,),
            "reflect": (a, b)}[fn]
    np.testing.assert_allclose(
        getattr(tvec, fn)(*map(_t, args)).numpy(),
        np.asarray(getattr(jvec, fn)(*map(jnp.asarray, args))),
        rtol=1e-6, atol=1e-7)


def test_accumulate():
    g = np.random.default_rng(1)
    h, w = 12, 9
    st_j = jacc.AccumState.zeros(h, w)
    st_t = tacc.AccumState.zeros(h, w, device="cpu")
    for k in (1, 4, 2):
        batch = g.uniform(0, 3, (h, w, 3)).astype(np.float32)
        st_j = jacc.accumulate(st_j, jnp.asarray(batch), k)
        st_t = tacc.accumulate(st_t, _t(batch), k)
    assert st_t.samples == int(st_j.samples) == 7
    np.testing.assert_allclose(st_t.mean.numpy(), np.asarray(st_j.mean),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("exact", [False, True])
def test_tonemap(exact):
    g = np.random.default_rng(4)
    x = g.uniform(-0.5, 1.5, (16, 16, 3)).astype(np.float32)
    x[0, :4, 0] = [0.0, 0.001, 0.0031307, 0.0031309]
    s_t = ttone.linear_to_srgb(_t(x), exact=exact)
    s_j = jtone.linear_to_srgb(jnp.asarray(x), exact=exact)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6,
                               atol=1e-7)
    # packing on identical inputs is exact (C truncation)
    np.testing.assert_array_equal(ttone.pack_rgba8(_t(np.asarray(s_j))).numpy(),
                                  np.asarray(jtone.pack_rgba8(s_j)))
