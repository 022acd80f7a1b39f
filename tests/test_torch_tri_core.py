"""Port parity, triangle core: tpu_ray_torch.core.trimesh, the triangle
scenes and the triangle parts of kernels/bounce_step (the Morton
permutation, prim_table, resident_tables_fit) against the JAX package.

The builders run the same numpy code, so their arrays must be equal; the
permutations must be equal; prim_table's triangle columns are computed in
f32 by both (n = e1 x e2, k = n . v0), held to 1e-6 relative to each
column's largest entry (XLA contracts a*b - c*d into an FMA on the CPU,
ROADMAP.md queue C).
"""
import os

import numpy as np
import pytest

from tpu_ray.core import scene as jscene
from tpu_ray.core import trimesh as jtrimesh
from tpu_ray.kernels import bounce_step as jbs

from tpu_ray_torch.core import scene as tscene
from tpu_ray_torch.core import trimesh as ttrimesh
from tpu_ray_torch.core.scene import (TRI_SCENE_LEAVES, scene_from_numpy,
                                      scene_to_numpy, trainable_scene)
from tpu_ray_torch.kernels import bounce_step as tbs

OBJ = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")
SPHERE_FIELDS = ("center", "radius", "albedo", "emissive", "specular",
                 "ior", "look_at")
STATIC = ("use_sky", "n_real", "default_distance", "default_x_angle",
          "default_y_height")


def _scene_name(name):
    return f"obj:{OBJ}" if name == "objico" else name


@pytest.fixture(scope="module")
def scenes():
    return {name: (jscene.make_scene(_scene_name(name)),
                   tscene.make_scene(_scene_name(name), device="cpu"))
            for name in ("trimesh", "objico")}


def _assert_tris_equal(jt, tt):
    assert tt.n_real == jt.n_real and tt.n_pad == jt.n_pad
    for k in ttrimesh.TRI_LEAVES:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))


def test_pack_triangles_matches_jax():
    g = np.random.default_rng(0)
    v = g.standard_normal((40, 3)).astype(np.float32)
    f = g.integers(0, 40, (130, 3))
    alb = g.random((130, 3)).astype(np.float32)
    args = (v, f, alb)
    kw = dict(emissive=(0.5, 0.25, 0.0), specular=0.3, ior=1.5)
    _assert_tris_equal(jtrimesh.pack_triangles(*args, **kw),
                       ttrimesh.pack_triangles(*args, device="cpu", **kw))
    # a uniform albedo, and padding to a multiple of TRI_PAD
    t = ttrimesh.pack_triangles(v, f[:5], (0.1, 0.2, 0.3), device="cpu")
    assert t.n_pad == ttrimesh.TRI_PAD and t.n_real == 5
    assert not t.e1[5:].any() and not t.e2[5:].any()


@pytest.mark.parametrize("sub", [0, 1, 3])
def test_icosphere_quad_merge_match_jax(sub):
    jv, jf = jtrimesh.icosphere(sub)
    tv, tf = ttrimesh.icosphere(sub)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    q = ((-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1))
    for a, b in zip(ttrimesh.quad(*q), jtrimesh.quad(*q)):
        np.testing.assert_array_equal(a, b)
    meshes = [(tv, tf, (0.8, 0.3, 0.2)), (*ttrimesh.quad(*q), (0.5,) * 3)]
    for a, b in zip(ttrimesh.merge(meshes), jtrimesh.merge(meshes)):
        np.testing.assert_array_equal(a, b)


def test_load_obj_matches_jax(tmp_path):
    """The fixture, and every face index form, negative indices and a
    polygon fan."""
    path = tmp_path / "forms.obj"
    path.write_text("# forms\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                    "vt 0 0\nvn 0 0 1\nf 1 2 3\nf 1/1 3/1 4/1\n"
                    "f 1/1/1 2/1/1 4/1/1\nf 1//1 2//1 3//1\n"
                    "f -4 -3 -2 -1\n")
    for p in (OBJ, str(path)):
        for a, b in zip(ttrimesh.load_obj(p), jtrimesh.load_obj(p)):
            np.testing.assert_array_equal(a, b)
    bad = tmp_path / "empty.obj"
    bad.write_text("v 0 0 0\n")
    with pytest.raises(ValueError):
        ttrimesh.load_obj(str(bad))


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_triangle_scenes_match_jax(scenes, name):
    js, ts = scenes[name]
    for k in SPHERE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
    for k in STATIC:
        assert getattr(ts, k) == getattr(js, k), k
    _assert_tris_equal(js.tris, ts.tris)
    if name == "trimesh":
        assert (ts.n_pad, ts.tris.n_real, ts.tris.n_pad) == (128, 10242,
                                                             10368)
        # scene index 6 is trimesh, as in the JAX package
        _assert_tris_equal(js.tris, tscene.make_scene(6, device="cpu").tris)


def test_bigmesh_is_past_the_residency_rule():
    """bigmesh builds (164k triangles) and falls outside
    resident_tables_fit in both packages, so every route takes the
    streaming triangle search (tests/test_torch_core.py::
    test_unported_scenes_refuse, tests/test_torch_tri_stream.py)."""
    big = tscene.make_scene("bigmesh", device="cpu")
    assert big.tris.n_real == 2 * 20 * 4 ** 6 + 2
    assert not tbs.resident_tables_fit(big.n_pad, big.tris.n_pad)
    assert not jbs.resident_tables_fit(big.n_pad, big.tris.n_pad)


@pytest.mark.parametrize("n_pad,m_pad", [(128, 10368), (128, 163968),
                                         (128, 128), (512, 0),
                                         (1152, 256), (128, 12800),
                                         (128, 13056)])
def test_resident_tables_fit_matches_jax(n_pad, m_pad):
    assert tbs.resident_tables_fit(n_pad, m_pad) == \
        jbs.resident_tables_fit(n_pad, m_pad)


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_tri_morton_perm_matches_jax(scenes, name):
    js, ts = scenes[name]
    np.testing.assert_array_equal(tbs.tri_morton_perm(ts.tris).numpy(),
                                  np.asarray(jbs.tri_morton_perm(js.tris)))
    np.testing.assert_array_equal(tbs.morton_perm(ts).numpy(),
                                  np.asarray(jbs.morton_perm(js)))
    jp, tp = jbs.permute_scene(js), tbs.permute_scene(ts)
    _assert_tris_equal(jp.tris, tp.tris)
    np.testing.assert_array_equal(tp.center.numpy(), np.asarray(jp.center))


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_prim_table_matches_jax(scenes, name):
    js, ts = scenes[name]
    want = np.asarray(jbs.prim_table(js)).T[:, :12]
    got = tbs.prim_table(ts).numpy()
    assert got.shape == want.shape == (ts.n_pad + ts.tris.n_pad, 12)
    n = ts.n_pad
    np.testing.assert_array_equal(got[:n], want[:n])
    # materials are copied; n and k are f32 products
    np.testing.assert_array_equal(got[n:, 4:], want[n:, 4:])
    for c in range(4):
        top = np.abs(want[n:, c]).max()
        np.testing.assert_allclose(got[n:, c], want[n:, c], rtol=0,
                                   atol=1e-6 * top)
    assert not got[n + ts.tris.n_real:].any()


def test_triangle_leaves_round_trip(scenes):
    """scene_from_numpy takes the JAX scene's arrays (triangles under
    "tris.<name>"), scene_to_numpy gives them back, trainable_scene makes
    every triangle leaf trainable, and autograd reaches them through
    prim_table."""
    js, ts = scenes["objico"]
    arrays = {k: np.asarray(getattr(js, k)) for k in SPHERE_FIELDS}
    arrays.update({f"tris.{k}": np.asarray(getattr(js.tris, k))
                   for k in ttrimesh.TRI_LEAVES})
    sc = scene_from_numpy(arrays, device="cpu", tri_n_real=js.tris.n_real,
                          **{k: getattr(js, k) for k in STATIC})
    assert sc.tris.n_real == js.tris.n_real
    back = scene_to_numpy(sc)
    assert set(back) == set(sc.leaves)
    for k, v in back.items():
        np.testing.assert_array_equal(v, arrays[k])
    tr = trainable_scene(sc)
    assert all(tr.leaf(k).requires_grad for k in TRI_SCENE_LEAVES)
    frozen = trainable_scene(sc, ("center",))
    assert not any(frozen.leaf(k).requires_grad for k in TRI_SCENE_LEAVES)
    tbs.prim_table(tbs.permute_scene(tr)).sum().backward()
    grads = scene_to_numpy(tr, grad=True)
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo"):
        assert np.abs(grads[k]).max() > 0, k
