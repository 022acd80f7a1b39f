"""Port parity, triangle ops: ops/intersect_tri (the Möller-Trumbore
search, the payload, the merge with the spheres), the triangle branch of
the shading chain (kernels/bounce_step.shade_plain / shade_vjp_plain) and
the eager route on triangle scenes, against the JAX package.

Bounds. The search against nearest_hit_tri_jnp: winners equal and t
within rtol 1e-6 (measured bit-equal on trimesh and objico); against the
Pallas kernel in interpret mode, whose det, t*det, u*det and v*det come
from bf16-split MXU products, the bound tests/test_triangles.py holds it
to against jnp (winners on >= 0.995 of rays, rtol 2e-3; measured: all
winners equal, t within 1.4e-5). The shading: rtol = atol = 2e-5, the
bound of the sphere branch (tests/test_torch_regen_grad.py). The eager
route against the JAX jnp render: rays exact, the image within the
golden suite's rtol 1e-5 / atol 1e-6 (measured max 2.4e-7).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.bounce_step import _shade, _shade_vjp
from tpu_ray.kernels.tri_intersect import nearest_hit_tri_pallas
from tpu_ray.models.path_tracer import render_pass as jrender_pass
from tpu_ray.ops import intersect_tri as jtri
from tpu_ray.ops.intersect import hit_payload as jhit_payload
from tpu_ray.ops.intersect import nearest_hit_jnp
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.bounce_step import shade_plain, shade_vjp_plain
from tpu_ray_torch.kernels.tri_intersect import tri_nearest_hit
from tpu_ray_torch.models.path_tracer import render_pass
from tpu_ray_torch.ops import intersect_tri as ttri
from tpu_ray_torch.ops.intersect import Hit, hit_payload

OBJ = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")


def _name(name):
    return f"obj:{OBJ}" if name == "objico" else name


def _rays(name, w=32, h=24, n_random=2048):
    """The default camera's primary rays at w x h plus random rays from
    around the meshes, as numpy [R,3] pairs."""
    js = jmake_scene(_name(name))
    o, d, _ = jcamera_rays(jdefault_camera(js), w, h,
                           jnp.arange(w * h, dtype=jnp.int32), 0, 0)
    g = np.random.default_rng(5)
    o2 = g.uniform(-0.2, 0.2, (n_random, 3)).astype(np.float32)
    o2[:, 1] = np.abs(o2[:, 1])
    d2 = g.normal(size=(n_random, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return js, (np.concatenate([np.asarray(o), o2]),
                np.concatenate([np.asarray(d), d2]))


def _agree(t_idx, ref):
    t, idx = (np.asarray(x) for x in t_idx)
    rt, ridx = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(t, rt, rtol=1e-6)


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_nearest_hit_tri_matches_jnp(name):
    js, (o, d) = _rays(name)
    ts = make_scene(_name(name), device="cpu")
    tab = ttri.tri_search_table(ts.tris)
    got = ttri.nearest_hit_tri(tab, torch.as_tensor(o), torch.as_tensor(d))
    ref = jtri.nearest_hit_tri_jnp(js.tris, jnp.asarray(o), jnp.asarray(d))
    _agree((got.t, got.idx), (ref.t, ref.idx))
    assert (got.t < 1e29).float().mean() > 0.3
    # the K7 wrapper on CPU tensors takes the plain version, unlaunched
    before = tri_nearest_hit.launches
    h = tri_nearest_hit(tab, torch.as_tensor(o), torch.as_tensor(d))
    assert torch.equal(h.t, got.t) and torch.equal(h.idx, got.idx)
    assert tri_nearest_hit.launches == before


def test_nearest_hit_tri_slabs_and_ties(monkeypatch):
    """Slabs of rays give the one-slab answer; an exact tie in t goes to
    the lower index (two copies of one triangle), a degenerate triangle
    never hits."""
    _, (o, d) = _rays("objico", 8, 8, 256)
    ts = make_scene(_name("objico"), device="cpu")
    o_t, d_t = torch.as_tensor(o), torch.as_tensor(d)
    tab = ttri.tri_search_table(ts.tris)
    one = ttri.nearest_hit_tri(tab, o_t, d_t)
    monkeypatch.setattr(ttri, "_SLAB_ELEMS", 1000)
    many = ttri.nearest_hit_tri(tab, o_t, d_t)
    assert torch.equal(one.t, many.t) and torch.equal(one.idx, many.idx)
    tab = torch.tensor([[0, 0, 0, 0, 0, 0, 0, 0, 0],
                        [-1, -1, 5, 2, 0, 0, 0, 2, 0],
                        [-1, -1, 5, 2, 0, 0, 0, 2, 0]], dtype=torch.float32)
    h = ttri.nearest_hit_tri(tab, torch.zeros(1, 3),
                             torch.tensor([[0.0, 0.0, 1.0]]))
    assert h.idx.item() == 1 and h.t.item() == 5.0


def test_nearest_hit_tri_matches_pallas_interpret():
    """Against the Pallas kernel it replaces (#12), in interpret mode, on
    the 82-triangle objico soup."""
    js, (o, d) = _rays("objico", 16, 12, 512)
    ts = make_scene(_name("objico"), device="cpu")
    got = ttri.nearest_hit_tri(ttri.tri_search_table(ts.tris),
                               torch.as_tensor(o), torch.as_tensor(d))
    for exact in (False, True):
        ref = nearest_hit_tri_pallas(js.tris, jnp.asarray(o),
                                     jnp.asarray(d), exact=exact)
        t, rt = got.t.numpy(), np.asarray(ref.t)
        same = got.idx.numpy() == np.asarray(ref.idx)
        assert same.mean() >= 0.995, (exact, same.mean())
        assert ((t < 1e29) == (rt < 1e29)).mean() >= 0.995
        both = same & (t < 1e29) & (rt < 1e29)
        np.testing.assert_allclose(t[both], rt[both], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_tri_payload_and_merge_match_jax(name):
    """tri_payload (the Möller-Trumbore t, the area-scaled normal, the
    backface rule) and merge_payloads (strict <: a sphere wins a tie,
    triangle ids offset by n_pad) against JAX's, from the same winners."""
    js, (o, d) = _rays(name)
    ts = make_scene(_name(name), device="cpu")
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    th = jtri.nearest_hit_tri_jnp(js.tris, jo, jd)
    sh = nearest_hit_jnp(js.center, js.radius, jo, jd)
    ref = jtri.merge_payloads(jhit_payload(js, jo, jd, sh),
                              jtri.tri_payload(js.tris, jo, jd, th),
                              js.n_pad)
    t_th = Hit(t=torch.as_tensor(np.array(th.t)),
               idx=torch.as_tensor(np.array(th.idx)))
    t_sh = Hit(t=torch.as_tensor(np.array(sh.t)),
               idx=torch.as_tensor(np.array(sh.idx)))
    o_t, d_t = torch.as_tensor(o), torch.as_tensor(d)
    tp = ttri.tri_payload(ts.tris, o_t, d_t, t_th)
    got = ttri.merge_payloads(hit_payload(ts, o_t, d_t, t_sh), tp, ts.n_pad)
    for field in ("hit", "idx", "inside"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    hit = got.hit.numpy()
    for field in ("t", "next_origin", "normal_raw", "albedo", "emissive",
                  "specular", "ior"):
        a = getattr(got, field).numpy()[hit]
        b = np.asarray(getattr(ref, field))[hit]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-6))
    assert (got.idx.numpy()[hit] >= ts.n_pad).mean() > 0.5


def test_merge_prefers_the_sphere_on_a_tie():
    z = torch.zeros(2, 3)
    one = torch.ones(2)

    def pay(t, idx):
        from tpu_ray_torch.ops.intersect import Payload
        return Payload(hit=torch.tensor([True, True]), idx=idx, t=t,
                       next_origin=z, normal_raw=z,
                       inside=torch.tensor([False, False]), albedo=z,
                       emissive=z, specular=one, ior=one)
    sp = pay(torch.tensor([2.0, 2.0]), torch.tensor([3, 3], dtype=torch.int32))
    tp = pay(torch.tensor([2.0, 1.0]), torch.tensor([5, 5], dtype=torch.int32))
    m = ttri.merge_payloads(sp, tp, 128)
    assert m.idx.tolist() == [3, 133] and m.t.tolist() == [2.0, 1.0]


def _tri_shade_inputs(use_sky, seed=11, br=512):
    """Randomized states and winners with a triangle on some live lanes:
    its winner row holds a normal n facing the ray and the k = n . p of a
    point p ahead of the origin, so the plane-form t is well conditioned."""
    rng = np.random.default_rng(seed)
    st = rng.standard_normal((16, br)).astype(np.float32)
    st[12] = (rng.random(br) < 0.8).astype(np.float32)
    st[3:6] /= np.linalg.norm(st[3:6], axis=0, keepdims=True)
    w = rng.standard_normal((16, br)).astype(np.float32)
    w[3] = np.abs(w[3]) + 0.1
    w[10] = rng.random(br).astype(np.float32)
    w[11] = np.where(rng.random(br) < 0.5, 0.0, 1.5).astype(np.float32)
    is_tri = rng.random(br) < 0.5
    n = -st[3:6] + 0.6 * rng.standard_normal((3, br))
    n *= rng.uniform(0.5, 2.0, br) / np.linalg.norm(n, axis=0)
    n[:, ::7] *= -1.0                        # some backfaces
    p = st[0:3] + st[3:6] * rng.uniform(0.5, 3.0, br)
    w[0:3] = np.where(is_tri, n, w[0:3])
    w[3] = np.where(is_tri, (n * p).sum(0), w[3])
    live = (st[12] > 0.5) & (rng.random(br) < 0.7)
    sky = (st[12] > 0.5) & ~live
    rand = [rng.uniform(-1, 1, br).astype(np.float32) for _ in range(3)]
    rand.append(rng.uniform(0, 1, br).astype(np.float32))
    g = rng.standard_normal((16, br)).astype(np.float32)
    g[12:16] = 0.0
    return st, w, live, sky, rand, g, is_tri & live


@pytest.mark.parametrize("use_sky", [True, False])
def test_tri_shade_matches_jax(use_sky):
    st, w, live, sky, rand, g, is_tri = _tri_shade_inputs(use_sky)
    j = dict(st=jnp.asarray(st), w=jnp.asarray(w), live=jnp.asarray(
        live[None]), sky=jnp.asarray(sky[None]), is_tri=jnp.asarray(
        is_tri[None]), rand=tuple(jnp.asarray(r[None]) for r in rand))
    t = dict(st=torch.as_tensor(st), w=torch.as_tensor(w),
             live=torch.as_tensor(live), sky=torch.as_tensor(sky),
             is_tri=torch.as_tensor(is_tri),
             rand=[torch.as_tensor(r) for r in rand])
    out_j = _shade(j["st"], j["w"], j["live"], j["sky"], j["rand"], use_sky,
                   j["is_tri"])
    out = shade_plain(t["st"], t["w"], t["live"], t["sky"], t["rand"],
                      use_sky, t["is_tri"])
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-5,
                               atol=2e-5)
    d_st_j, d_w_j = _shade_vjp(j["st"], j["w"], j["live"], j["sky"],
                               j["rand"], use_sky, jnp.asarray(g),
                               j["is_tri"])
    d_st, d_w = shade_vjp_plain(t["st"], t["w"], t["live"], t["sky"],
                                t["rand"], use_sky, torch.as_tensor(g),
                                t["is_tri"])
    np.testing.assert_allclose(d_st.numpy()[0:12], np.asarray(d_st_j)[0:12],
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(d_w_j)[0:12],
                               rtol=2e-5, atol=2e-5)
    # the triangle lanes moved along their plane-form t
    tri = is_tri
    assert tri.sum() > 50
    tt = ((w[3] - (st[0:3] * w[0:3]).sum(0)) / (st[3:6] * w[0:3]).sum(0))
    np.testing.assert_allclose(out.numpy()[0:3, tri],
                               (st[0:3] + st[3:6] * tt)[:, tri], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("use_sky", [True, False])
def test_tri_shade_vjp_matches_autograd(use_sky):
    st, w, live, sky, rand, g, is_tri = _tri_shade_inputs(use_sky, seed=12)
    st_v = torch.as_tensor(st).requires_grad_()
    w_v = torch.as_tensor(w).requires_grad_()
    args = (torch.as_tensor(live), torch.as_tensor(sky),
            [torch.as_tensor(r) for r in rand])
    out = shade_plain(st_v, w_v, *args, use_sky, torch.as_tensor(is_tri))
    d_st_ref, d_w_ref = torch.autograd.grad(out, (st_v, w_v),
                                            torch.as_tensor(g))
    d_st, d_w = shade_vjp_plain(torch.as_tensor(st), torch.as_tensor(w),
                                *args, use_sky, torch.as_tensor(g),
                                torch.as_tensor(is_tri))
    torch.testing.assert_close(d_st[0:12], d_st_ref[0:12], rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(d_w, d_w_ref[0:12], rtol=2e-5, atol=2e-5)
    # a sphere scene's chain is the one without the triangle branch
    none = shade_vjp_plain(torch.as_tensor(st), torch.as_tensor(w), *args,
                           use_sky, torch.as_tensor(g))
    spheres = ~torch.as_tensor(is_tri)
    assert torch.equal(none[0][:, spheres], d_st[:, spheres])
    assert torch.equal(none[1][:, spheres], d_w[:, spheres])


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_eager_route_matches_jax_jnp(name):
    """backend torch (and cuda, on CPU tensors the same search) against the
    JAX jnp render at 32x24, 1 spp."""
    js = jmake_scene(_name(name))
    ref, rays_ref = jrender_pass(js, jdefault_camera(js), width=32,
                                 height=24, spp=1, sample_start=0, seed=0)
    ts = make_scene(_name(name), device="cpu")
    img, rays = render_pass(ts, default_camera(ts), width=32, height=24,
                            spp=1, seed=0)
    assert rays == int(rays_ref)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    img_c, rays_c = render_pass(ts, default_camera(ts), width=32, height=24,
                                spp=1, seed=0, backend="cuda")
    assert rays_c == rays and torch.equal(img_c, img)
