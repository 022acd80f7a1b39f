"""K4's triangle mode and its culled sphere search (kernels/bounce_step.py
``bounce_fwd_plain(tri=, sph=)``), and the per-sample route that takes
them: ``trace_rays_fused`` / ``make_fused_sample`` with ``tri_list=False``
(JAX's streamed sweep of every triangle, ``bounce_fwd(..., tri_tab=)``)
and the Morton sphere tiles that ``fused_tables`` carries.

- (a) K4's triangle mode, plain, against JAX's exact-argmin
  ``bounce_fwd(t48, stab_full, st, b, None, tri_full)`` in interpret mode
  on small trimesh (``make_trimesh_scene(subdivisions=2)``) and objico, a
  32x24 tile-ordered wavefront, each bounce handed JAX's own state: the
  bounds of tests/test_torch_tri_fused.py ``test_k8_plain_matches_jax``
  (winner ids equal; rows 0-11 within 1e-5 on at least 0.98 of lanes and
  within 1e-3 on all, rows 12-15 bit for bit: XLA contracts FMAs and
  approximates rsqrt, ROADMAP.md queue C).
- (b) the port's routes with tri_list=False bit-equal to the listed
  route, colours, rays and gradients, as tests/test_tri_list.py:38-50
  holds JAX's (the lists skip only a grazing hit outside its tile's box,
  which these sizes do not meet).
- (c) the culled sphere search bit-equal to the fold over every sphere on
  rgb, randomized and rtweekend, bounces 0 and 1 of one sample, its
  counters equal to ``regen.nearest_sphere_culled``'s.
- (d) ``fused_tables`` carries ``regen.sphere_tiles`` of the permuted
  sphere rows, and the route renders the frozen JAX goldens
  (tests/goldens/*-fused-exact.npz) at tests/test_torch_fused_route.py's
  bound, and its own unculled image bit for bit.

tests/test_torch_cuda.py holds the kernel against these plain versions on
the card.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.kernels import bounce_step as J
from tpu_ray.models.path_tracer import tile_order as jtile_order
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch.core.camera import default_camera, trainable_camera
from tpu_ray_torch.core.scene import (make_scene, make_trimesh_scene,
                                      trainable_scene)
from tpu_ray_torch.kernels.bounce_step import (
    bounce_fwd, bounce_fwd_list, bounce_fwd_list_plain, bounce_fwd_plain,
    bounce_replay_plain, fused_tables, init_state, make_fused_sample,
    nearest_prim, origin_bound, trace_rays_fused)
from tpu_ray_torch.kernels.regen import (culled_sphere_fold,
                                         nearest_sphere_culled, sphere_tiles)
from tpu_ray_torch.models.path_tracer import render_pass, tile_order
from tpu_ray_torch.ops.intersect import nearest_hit
from tpu_ray_torch.ops.raygen import camera_rays
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
OBJ = os.path.join(ROOT, "tests", "fixtures", "ico1.obj")
W, H, MB = 32, 24, 3
SPHERES = {"rgb": 1.0, "randomized": 1.0, "rtweekend": 0.97}


def _scenes(name):
    """(JAX scene, port scene) of a test scene, neither permuted."""
    if name == "small":
        return (jmake_trimesh(subdivisions=2),
                make_trimesh_scene(subdivisions=2, device="cpu"))
    full = f"obj:{OBJ}" if name == "objico" else name
    return jmake_scene(full), make_scene(full, device="cpu")


def _bits(t):
    return t.view(torch.int32)


def _wave(scene, s=0):
    """The camera rays of a W x H tile-ordered wavefront, sample s."""
    px = torch.as_tensor(tile_order(W, H)[0])
    return camera_rays(default_camera(scene), W, H, px, s, 0)


@pytest.fixture(scope="module")
def jax_sweep():
    """For small trimesh and objico: the input state and winner ids of MB
    bounces of JAX's exact-argmin bounce_fwd with the triangle table and
    no mask (the streamed sweep of trace_rays_fused(tri_list=False))."""
    out = {}
    for name in ("small", "objico"):
        js = J.permute_scene(_scenes(name)[0])
        tb = J._fused_tables(js)
        px = jnp.asarray(jtile_order(W, H)[0])
        o, d, base = jcamera_rays(jdefault_camera(js), W, H, px, 0, 0)
        st, r, _ = J._init_state(o, d, base, J.BLOCK_R)
        states, idxs = [], []
        for b in range(MB):
            states.append(np.asarray(st)[:, :r])
            st, idx = J.bounce_fwd(tb["t48"], tb["stab_full"], st,
                                   jnp.int32(b), None, tb["tri_full"],
                                   use_sky=js.use_sky, exact_argmin=True)
            idxs.append(np.asarray(idx)[:r])
        ts = _scenes(name)[1]
        out[name] = dict(js=js, states=states, idxs=idxs,
                         final=np.asarray(st)[:, :r],
                         ftb=fused_tables(ts, origin_bound(
                             default_camera(ts).position[None])))
    return out


def _assert_state_close(got, want, b):
    err = np.abs(got[0:12] - want[0:12])
    close = (err <= 1e-5).all(axis=0)
    assert close.mean() >= 0.98, (b, close.mean())
    assert err.max() <= 1e-3, (b, err.max())
    np.testing.assert_array_equal(got[12:16].view(np.uint32),
                                  want[12:16].view(np.uint32))


@pytest.mark.parametrize("name", ["small", "objico"])
@pytest.mark.parametrize("culled", [False, True])
def test_k4_tri_plain_matches_jax(jax_sweep, name, culled):
    """(a) K4's triangle mode against JAX's streamed bounce_fwd, with the
    spheres folded whole and culled by their tiles."""
    ref = jax_sweep[name]
    ftb = ref["ftb"]
    assert ftb.tri.shape[0] == ref["js"].tris.n_pad
    nexts = ref["states"][1:] + [ref["final"]]
    for b in range(MB):
        st = torch.as_tensor(ref["states"][b].copy())
        out, idx = bounce_fwd_plain(st, ftb.table, b,
                                    use_sky=ref["js"].use_sky, tri=ftb.tri,
                                    n_sph=ftb.n_sph,
                                    sph=ftb.sph if culled else None)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), ref["idxs"][b])
        _assert_state_close(out.numpy(), nexts[b], b)
    assert (np.stack(ref["idxs"]) >= ftb.n_sph).mean() > 0.1


@pytest.mark.parametrize("name", ["small", "objico"])
def test_k4_tri_mode_is_nearest_prim_then_shading(jax_sweep, name):
    """The triangle mode's winners are nearest_prim's over every triangle
    and its state bounce_replay_plain's with the triangle branch; the
    wrapper takes the plain version on CPU tensors, and n_sph must agree
    with the table."""
    ftb = jax_sweep[name]["ftb"]
    st = torch.as_tensor(jax_sweep[name]["states"][1].copy())
    out, idx = bounce_fwd(st, ftb.table, 1, use_sky=True, tri=ftb.tri,
                          n_sph=ftb.n_sph, sph=ftb.sph)
    want = torch.where(st[12] > 0.5, nearest_prim(st, ftb.table, ftb.tri),
                       -1).to(torch.int32)
    assert torch.equal(idx, want)
    rep = bounce_replay_plain(st, ftb.table, idx, 1, use_sky=True,
                              n_sph=ftb.n_sph)
    assert torch.equal(_bits(out), _bits(rep))
    with pytest.raises(ValueError):
        bounce_fwd_plain(st, ftb.table, 1, use_sky=True, tri=ftb.tri,
                         n_sph=ftb.n_sph + 1)


@pytest.mark.parametrize("name", ["small", "objico"])
def test_trace_rays_fused_tri_list_off_matches_listed(name):
    """(b) trace_rays_fused(tri_list=False), K4's triangle mode at every
    bounce, bit-equal to the listed route (K8), colours and rays, at 5
    bounces, 2 samples."""
    scene = _scenes(name)[1]
    for s in range(2):
        o, d, base = _wave(scene, s)
        c_on, r_on = trace_rays_fused(scene, o, d, base, 5)
        c_off, r_off = trace_rays_fused(scene, o, d, base, 5,
                                        tri_list=False)
        assert torch.equal(r_on, r_off)
        assert torch.equal(_bits(c_on), _bits(c_off))
        assert r_on.sum() > W * H


def test_make_fused_sample_tri_list_off_matches_listed():
    """(b) make_fused_sample(tri_list=False): colours, rays and the
    gradients of every scene leaf and the camera equal to the listed
    route's on small trimesh (the backward replays the same winners)."""
    base = _scenes("small")[1]
    cam0 = default_camera(base)
    px = torch.as_tensor(tile_order(W, H)[0])
    got = {}
    for tri_list in (True, False):
        sc = trainable_scene(base)
        cam = trainable_camera(cam0)
        sample = make_fused_sample(W, H, 0, 5, tri_list=tri_list)
        col, rays = sample(sc, cam, px, 1)
        (col * col).sum().backward()
        grads = {k: sc.leaf(k).grad for k in sc.leaves}
        grads.update(position=cam.position.grad, look_at=cam.look_at.grad)
        got[tri_list] = (col.detach(), rays, grads)
    assert torch.equal(_bits(got[True][0]), _bits(got[False][0]))
    assert torch.equal(got[True][1], got[False][1])
    for k, g in got[True][2].items():
        assert g is not None and torch.equal(g, got[False][2][k]), k
    assert got[True][2]["tris.v0"].abs().max() > 0


@pytest.fixture(scope="module")
def sphere_states():
    """For rgb, randomized and rtweekend: the per-sample tables (with the
    sphere tiles) and the input states of bounces 0 and 1 of sample 0."""
    out = {}
    for name in SPHERES:
        scene = make_scene(name, device="cpu")
        o, d, base = _wave(scene)
        tb = fused_tables(scene, origin_bound(o))
        st0 = init_state(o, d, base)
        st1, _ = bounce_fwd_plain(st0, tb.table, 0, use_sky=scene.use_sky)
        out[name] = (scene, tb, [st0, st1])
    return out


@pytest.mark.parametrize("name", list(SPHERES))
def test_culled_search_matches_every_sphere(sphere_states, name):
    """(c) bounce_fwd_plain(sph=) bit-equal to the fold over every sphere,
    state and winners, at bounces 0 and 1; its counters are
    nearest_sphere_culled's and test fewer pairs than every sphere's; the
    fold's t is nearest_hit's on every alive lane."""
    scene, tb, states = sphere_states[name]
    n = tb.table.shape[0]
    for b, st in enumerate(states):
        stats = torch.zeros(3, dtype=torch.int64)
        got, gidx = bounce_fwd_plain(st, tb.table, b, use_sky=scene.use_sky,
                                     sph=tb.sph, stats=stats)
        want, widx = bounce_fwd_plain(st, tb.table, b,
                                      use_sky=scene.use_sky)
        assert torch.equal(gidx, widx)
        assert torch.equal(_bits(got), _bits(want))
        idx_m, counts = nearest_sphere_culled(st, tb.table, tb.sph)
        assert torch.equal(stats, counts)
        assert torch.equal(torch.where(st[12] > 0.5, idx_m, -1).int(), widx)
        alive = st[12] > 0.5
        assert 0 < counts[2] < int(alive.sum()) * n
        t, _, _ = culled_sphere_fold(st, tb.table, tb.sph)
        hit = nearest_hit(tb.table[:, 0:3], tb.table[:, 3], st[0:3].T,
                          st[3:6].T)
        assert torch.equal(_bits(t[alive]), _bits(hit.t[alive]))


def test_culled_search_arguments(sphere_states):
    """The sphere tiles cull in place of a mask; stats need the tiles on
    the card and K8's counters are the kernel's own."""
    scene, tb, (st, _) = sphere_states["rtweekend"]
    mask = torch.ones((-(-st.shape[1] // 256), 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        bounce_fwd_plain(st, tb.table, 0, mask, use_sky=True, sph=tb.sph)
    with pytest.raises(ValueError):
        bounce_fwd(st, tb.table, 0, mask, use_sky=True, sph=tb.sph)
    small = _scenes("small")[1]
    ttb = fused_tables(small,
                       origin_bound(default_camera(small).position[None]))
    with pytest.raises(ValueError):
        bounce_fwd_list(st, ttb.table, ttb.tri, ttb.boxes, 0,
                        n_sph=ttb.n_sph, use_sky=True,
                        stats=torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("name", list(SPHERES) + ["small"])
def test_fused_tables_carry_sphere_tiles(name):
    """(d) fused_tables' sphere tiles are sphere_tiles of the permuted
    table's sphere rows at the given origin bound, field for field."""
    scene = make_scene(name, device="cpu") if name in SPHERES else \
        _scenes(name)[1]
    bound = origin_bound(default_camera(scene).position[None])
    tb = fused_tables(scene, bound)
    n_sph = tb.table.shape[0] if tb.n_sph is None else tb.n_sph
    want = sphere_tiles(tb.table[:n_sph], bound)
    assert tb.sph.n == n_sph and tb.sph.o_lim == want.o_lim
    for f in ("boxes", "starts", "gboxes", "gstarts"):
        assert torch.equal(getattr(tb.sph, f), getattr(want, f)), f
    assert tb.sph.o_lim >= bound


@pytest.mark.parametrize("name", list(SPHERES))
def test_culled_route_renders_goldens(sphere_states, name):
    """(d) The route with the sphere tiles: the JAX goldens at the bound
    of tests/test_torch_fused_route.py, and bit for bit the samples the
    same tables give without the tiles (every sphere folded)."""
    scene, _, _ = sphere_states[name]
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}-fused-exact.npz"))
    cam = default_camera(scene)
    img, rays = render_pass(scene, cam, width=W, height=H, spp=1,
                            backend="fused", regen=False)
    img = img.numpy()
    assert rays == int(z["rays"])
    ok = np.isclose(img, z["image"], rtol=1e-5, atol=1e-6).all(axis=-1)
    assert ok.mean() >= SPHERES[name], ok.mean()
    assert np.abs(img - z["image"]).max() < 2e-3
    px = torch.as_tensor(tile_order(W, H)[0])
    tb = fused_tables(scene, origin_bound(cam.position[None]))
    sample = make_fused_sample(W, H, 0, 5)
    with torch.no_grad():
        a, ra = sample(scene, cam, px, 0, tb)
        b, rb = sample(scene, cam, px, 0, tb._replace(sph=None))
    assert torch.equal(ra, rb) and torch.equal(_bits(a), _bits(b))


def test_listed_plain_is_the_k4_sweep_on_trimesh(jax_sweep):
    """K8's plain version (the block lists) and K4's triangle mode give
    the same winners and state on the JAX chain's states of small trimesh
    (no grazing hit outside a tile's box here)."""
    ftb = jax_sweep["small"]["ftb"]
    for b, st_np in enumerate(jax_sweep["small"]["states"]):
        st = torch.as_tensor(st_np.copy())
        a, ia = bounce_fwd_list_plain(st, ftb.table, ftb.tri, ftb.boxes, b,
                                      n_sph=ftb.n_sph, use_sky=True)
        k, ik = bounce_fwd_plain(st, ftb.table, b, use_sky=True,
                                 tri=ftb.tri, n_sph=ftb.n_sph, sph=ftb.sph)
        assert torch.equal(ia, ik) and torch.equal(_bits(a), _bits(k))
