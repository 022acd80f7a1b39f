"""Port parity, kernel layer.

On the CPU each kernel wrapper takes its plain PyTorch version, which is
held here against the Pallas kernel it replaces, run in interpret mode as
the JAX suite runs it:

- K1 ``sphere_nearest_hit`` (plain: ops/intersect.nearest_hit) against
  ``nearest_hit_pallas(exact=True)``, with tests/test_pallas.py's bounds.
- K2 ``regen_steps`` (plain: ``regen_steps_plain``) against ``regen_step``
  (exact_argmin, steps=2) on one ``_wave_init`` state.

tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.bounce_step import BLOCK_R as JBLOCK_R, _fused_tables
from tpu_ray.kernels.regen import _cam13, _wave_init, regen_step
from tpu_ray.kernels.sphere_intersect import nearest_hit_pallas
from tpu_ray.models.path_tracer import tile_order as jtile_order
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch.core.camera import camera_from_numpy, default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels import build
from tpu_ray_torch.kernels.regen import (cam13, regen_steps,
                                         regen_steps_plain, wave_init)
from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                    sphere_nearest_hit)
from tpu_ray_torch.models.path_tracer import tile_order
from tpu_ray_torch.ops.intersect import payload_tables

W, H = 32, 24
REGEN_KW = dict(use_sky=True, max_bounces=5, width=W, height=H)


def _jcam_to_port(jc):
    return camera_from_numpy({"position": np.asarray(jc.position),
                              "look_at": np.asarray(jc.look_at)},
                             device="cpu")


@pytest.mark.parametrize("name", ["rgb", "randomized", "rtweekend"])
def test_k1_plain_matches_pallas(name):
    js = jmake_scene(name)
    jc = jdefault_camera(js)
    o, d, _ = jcamera_rays(jc, 48, 32, jnp.arange(48 * 32, dtype=jnp.int32),
                           0, 0)
    ref = nearest_hit_pallas(js.center, js.radius, o, d, exact=True)
    ts = make_scene(name, device="cpu")
    got = sphere_nearest_hit(ts.center, ts.radius,
                             torch.as_tensor(np.array(o)),
                             torch.as_tensor(np.array(d)))
    i0, i1 = np.asarray(ref.idx), got.idx.numpy()
    t0, t1 = np.asarray(ref.t), got.t.numpy()
    assert (i0 == i1).mean() > 0.995, (i0 != i1).sum()
    assert ((t0 < 1e29) == (t1 < 1e29)).all()
    hit = (t0 < 1e29) & (i0 == i1)
    np.testing.assert_allclose(t1[hit], t0[hit], rtol=1e-4, atol=1e-5)


def test_k1_wrapper_takes_plain_on_cpu():
    ts = make_scene("rgb", device="cpu")
    g = np.random.default_rng(0)
    o = torch.as_tensor(g.normal(size=(300, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.as_tensor(g.normal(size=(300, 3)).astype(np.float32)), dim=1)
    before = sphere_nearest_hit.launches
    a = sphere_nearest_hit(ts.center, ts.radius, o, d)
    b = nearest_hit_plain(ts.center, ts.radius, o, d)
    assert torch.equal(a.t, b.t) and torch.equal(a.idx, b.idx)
    assert sphere_nearest_hit.launches == before   # no kernel launch


@pytest.fixture(scope="module")
def jax_wave():
    """One _wave_init state of rtweekend at 32x24, 1 spp, and JAX's
    regen_step (exact argmin, steps=2) applied to it."""
    js = jmake_scene("rtweekend")
    jc = jdefault_camera(js)
    perm, _ = jtile_order(W, H)
    st0, jcam, r = _wave_init(jc, jnp.asarray(perm), 1, 0, 0, W, H, JBLOCK_R)
    tb = _fused_tables(js)
    out = regen_step(jcam, tb["t48"], tb["stab_full"], st0, exact_argmin=True,
                     steps=2, **REGEN_KW)
    return dict(jc=jc, perm=perm, st0=np.asarray(st0), cam=np.asarray(jcam),
                r=r, out=np.asarray(out))


def test_wave_init_matches_jax(jax_wave):
    cam = _jcam_to_port(jax_wave["jc"])
    st, c13, r = wave_init(cam, torch.as_tensor(jax_wave["perm"]).long(), 1,
                           0, 0, W, H)
    assert r == jax_wave["r"]
    full = jax_wave["st0"]
    # JAX pads the lanes to its block; its padding lanes are dead and spent
    assert (full[12, r:] == 0).all() and (full[14, r:] == 1.0).all()
    ref = full[:, :r]
    got = st.numpy()
    assert got.shape == ref.shape
    exact_rows = [k for k in range(24) if k not in (3, 4, 5)]
    np.testing.assert_array_equal(got[exact_rows].view(np.uint32),
                                  ref[exact_rows].view(np.uint32))
    # directions: the film math of camera_rays, within its 1e-6 bound
    np.testing.assert_allclose(got[3:6], ref[3:6], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c13.numpy(), jax_wave["cam"][0], rtol=1e-6,
                               atol=1e-7)


def test_cam13_matches_jax():
    jc = jdefault_camera(jmake_scene("rgb"))
    np.testing.assert_allclose(cam13(_jcam_to_port(jc), 7).numpy(),
                               np.asarray(_cam13(jc, 7.0))[0], rtol=1e-6,
                               atol=1e-7)


def test_k2_plain_matches_pallas(jax_wave):
    """JAX's search roots come from bf16x6 splits and its f32 chains are
    contracted into FMAs, so rare near-tie winners may differ and a few
    scatter directions drift (ROADMAP.md queue C)."""
    tb = payload_tables(make_scene("rtweekend", device="cpu"))
    st = torch.as_tensor(jax_wave["st0"].copy())
    cam = torch.as_tensor(jax_wave["cam"][0].copy())
    regen_steps_plain(st, cam, tb, 2, **REGEN_KW)
    a, b = st.numpy(), jax_wave["out"]
    ctrl = (12, 14, 15, 22)
    for ch in ctrl:
        assert (a[ch] == b[ch]).mean() >= 0.99, ch
    assert abs(a[22].sum() - b[22].sum()) <= 0.01 * b[22].sum()
    agree = np.logical_and.reduce([a[ch] == b[ch] for ch in ctrl])
    for ch in (13, 21):
        np.testing.assert_array_equal(a[ch].view(np.uint32)[agree],
                                      b[ch].view(np.uint32)[agree])
    smooth = [6, 7, 8, 9, 10, 11, 16, 17, 18, 19, 20, 23]
    np.testing.assert_allclose(a[smooth][:, agree], b[smooth][:, agree],
                               rtol=1e-5, atol=1e-5)
    # origin and direction rows: 1e-5 on >= 0.97 of the agreeing lanes
    close = np.isclose(a[0:6], b[0:6], rtol=1e-5, atol=1e-5).all(axis=0)
    assert close[agree].mean() >= 0.97, close[agree].mean()


def _regen_state(spp=2):
    ts = make_scene("rtweekend", device="cpu")
    perm, _ = tile_order(W, H)
    st, cam, r = wave_init(default_camera(ts), torch.as_tensor(perm), spp, 0,
                           0, W, H)
    return payload_tables(ts), st, cam, r


def test_k2_wrapper_takes_plain_on_cpu():
    tb, st, cam, _ = _regen_state()
    ref = st.clone()
    before = regen_steps.launches
    regen_steps(st, cam, tb, 3, **REGEN_KW)
    regen_steps_plain(ref, cam, tb, 3, **REGEN_KW)
    assert torch.equal(st.view(torch.int32), ref.view(torch.int32))
    assert regen_steps.launches == before


def test_k2_steps_compose():
    """k steps in one call == k calls of one step, bit for bit (the early
    exit over dead lanes included)."""
    tb, st, cam, _ = _regen_state()
    one = st.clone()
    regen_steps_plain(st, cam, tb, 12, **REGEN_KW)
    for _ in range(12):
        regen_steps_plain(one, cam, tb, 1, **REGEN_KW)
    assert torch.equal(st.view(torch.int32), one.view(torch.int32))


def test_k2_runs_every_lane_to_exhaustion():
    tb, st, cam, r = _regen_state(spp=2)
    regen_steps_plain(st, cam, tb, 2 * 5, **REGEN_KW)
    assert not (st[12] > 0.5).any()
    assert (st[14, :r] == 2.0).all()          # every sample finished
    rays = st[22, :r]
    assert (rays >= 2).all() and (rays <= 10).all()
    assert torch.isfinite(st[16:19]).all()


def test_dead_lanes_only_advance_bounce_row():
    tb, st, cam, r = _regen_state()
    st[12] = 0.0
    before = st.clone()
    regen_steps_plain(st, cam, tb, 4, **REGEN_KW)
    assert torch.equal(st[15], before[15] + 4.0)
    rows = [k for k in range(24) if k != 15]
    assert torch.equal(st[rows].view(torch.int32),
                       before[rows].view(torch.int32))


def test_require_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        build.require(torch.zeros(3), "x", torch.float32)


def test_build_digest_tracks_sources():
    d = build._digest()
    assert d == build._digest() and len(d) == 64
    names = {p.rsplit("/", 1)[-1] for p in build._sources()}
    assert {"common.cuh", "sphere_intersect.cu", "regen.cu"} <= names
