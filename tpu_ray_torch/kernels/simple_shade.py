"""K9: the fused flat and Lambert+shadow estimators, the CUDA kernel
``csrc/simple_shade.cu``, its plain version and its autograd function.

Replaces ``tpu_ray/kernels/simple_shade.py::make_simple_trace``
(``_simple_kernel``) with exact_argmin: every spp sample of a lane in one
launch, each one in-lane raygen (bit-equal to ``ops/raygen.camera_rays``),
the nearest-hit search over the spheres and then the triangles, and the
estimator of ``ops/shading_modes``: flat (albedo + emissive of the hit) or
Lambert (the emissive plus, per light, albedo * light emissive *
max(0, n . l) when a shadow ray from the hit point toward the light centre
first meets that light). A miss adds the sky (or zero). Rays: 1 a sample,
plus 1 a light on a hit.

As in the JAX package, the spheres are Morton-permuted (``morton_perm``;
an exact tie in t goes to the lower permuted id) and the triangles keep
their scene order; lights are global sphere indices, mapped to their
permuted ids for the shadow test. The shading follows ``_simple_kernel``:
the sphere normal from o + d t - c, a triangle winner in the plane form
(t = (k - n.o) / (n.d), normal n, backface flips it), the shadow ray from
o + d t with no offset. The eager estimators reach the same values
through ``hit_payload``/``tri_payload`` in another op order (and the
Möller-Trumbore t for triangles), so K9 agrees with its plain version bit
for bit and with the eager route within rounding.

Each search folds the spheres over their Morton tiles (``simple_tables``'
``sph``: ``regen.sphere_tiles``, K2's and K4's culled fold, bit-equal to
the fold over every slot), then on a triangle scene the tiles its 256-lane
block lists (``bounce_step.tri_block_lists`` of the block's rays, built in
the launch as K2, K8 and K10 build theirs): a primary fold lists from the
sample's primary rays, a shadow fold, for each light, from its hit lanes'
shadow rays. A lane whose grazing hit Möller-Trumbore accepts outside its
tile's inflated box can differ from a full sweep, as on the per-sample
route. Without ``boxes`` every fold sweeps every tile (the mode a caller
names).

- ``simple_trace_plain``: the kernel's function in plain PyTorch (the CPU
  path, and the reference the card checks hold K9 to);
- ``simple_trace``: the K9 wrapper, which takes the plain version for CPU
  tensors only;
- ``SimpleTrace``: the differentiable trace (the JAX custom VJP). Its
  forward runs K9 and saves only its inputs; its backward re-runs the
  eager estimator (``models/path_tracer.render_pixels`` on backend "cuda":
  K1 and K7 on the card) sample by sample under autograd;
- ``make_simple_trace``: (scene, camera, pixel, s0) -> (color_sum [R,3],
  rays_cast int).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, film_extent
from tpu_ray_torch.core.scene import F32_EPS, Scene
from tpu_ray_torch.kernels import build
from tpu_ray_torch.kernels.bounce_step import (BLOCK_R, TRI_BLOCK_M,
                                               _block_reach, _dot3,
                                               init_state, morton_perm,
                                               nearest_prim, nrm3_fwd,
                                               origin_bound,
                                               permute_spheres, prim_table,
                                               resident_tables_fit,
                                               tri_tile_boxes)
from tpu_ray_torch.kernels.regen import (SphereTiles, _check_sph, cam13,
                                         sphere_tiles)
from tpu_ray_torch.ops.intersect_tri import tri_search_table
from tpu_ray_torch.ops.raygen import film_rays
from tpu_ray_torch.ops.shade import sky_color
from tpu_ray_torch.ops.vec import safe_sqrt

__all__ = ["simple_trace", "simple_trace_plain", "simple_tables",
           "pass_tables", "lane_rows", "SimpleTrace", "make_simple_trace",
           "MODES", "N_STATS"]

MODES = ("flat", "lambert_shadow")
_EPS = float(F32_EPS)
# K9's stats: primary and shadow tiles listed, primary and shadow live
# block-folds, ray-triangle pairs tested, sphere boxes tested, sphere
# tiles folded, ray-sphere pairs tested
N_STATS = 8


def lane_rows(pixel, width: int, seed: int):
    """The kernel's per-lane input [3,R] f32 for the flat pixel indices
    [R]: pixel x, pixel y, and the per-(pixel, seed) hash h1 (u32 bits;
    sample s's stream base is pcg_hash(h1 + s * MIX_SAMPLE))."""
    ax = (pixel % width).to(torch.float32)
    ay = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    h1 = rng.u32_to_bits(rng.pixel_hash(seed, pixel))
    return torch.stack([ax, ay, h1]).contiguous()


def _rays(o, d, active):
    """The searches' rays o, d [3,R'] of the lanes ``active`` [R'] as the
    [13,R'] state rows ``nearest_prim`` reads (0-5 the ray, 12 alive)."""
    return torch.cat([o, d, torch.zeros_like(o), torch.zeros_like(o),
                      active[None].to(o.dtype)])


@torch.no_grad()
def simple_trace_plain(rows, cam, table, tri, boxes, lidx, ldat, *,
                       n_sph: int, spp: int, s0: int, width: int,
                       height: int, use_sky: bool, flat: bool, lanes=None,
                       folds=None, sph: SphereTiles | None = None,
                       stats=None):
    """Plain version of K9 -> out [4,R'] f32: the colour sum over samples
    s0 .. s0 + spp - 1 (rows 0-2) and the rays cast (row 3) of the lanes
    ``lanes`` (an index tensor into the R lanes; None = all).

    rows [3,R] (``lane_rows``), cam [13] (``kernels/regen.cam13``), table
    [n_sph + M, 12] (``bounce_step.prim_table``), tri [M,9] (the
    triangles' ``tri_search_table``, None for a sphere scene), boxes
    [M/TRI_BLOCK_M, 6] (``tri_tile_boxes``; None: every fold sweeps every
    tile), lidx [L] i32 the lights' ids in the table, ldat [L,6] their
    centres and emissives; flat: the flat estimator, else Lambert; sph:
    the sphere rows' tiles (``regen.sphere_tiles``), folded as
    ``regen.culled_sphere_fold``, K9's fold, or None: every fold tests
    every sphere slot, the reference that fold is held to (both give the
    same winners).

    Each fold's tiles are those its BLOCK_R-lane block of the full launch
    lists (``tri_block_lists``): a primary fold's from the block's primary
    rays, a shadow fold's from the shadow rays of the block's hit lanes. A
    lane slice gets the lists K9 gives it: the primary lists come from
    every lane's ray, and where shadow lists are needed the slice's blocks
    run whole. folds: a list that, when given, receives each search's
    (origins [3,R''], directions [3,R''], tiles [R'',T] bool or None,
    searching lanes [R''] bool) over the lanes run, each sample's primary
    search and then one a light: the rays whose work a bound counts.
    stats: None, or an int64 [N_STATS] tensor that the counts of a whole
    launch (no ``lanes``) are added to, as K9 counts them: primary and
    shadow tiles listed over the live block-folds, primary and shadow live
    block-folds (the triangle folds a block runs), ray-triangle pairs
    tested (every listed pair, where K9's walk stops early), sphere boxes
    tested, tiles folded and pairs tested (with ``sph``)."""
    r, dev = rows.shape[1], rows.device
    lights = [int(v) for v in lidx.tolist()] if not flat else []
    if lanes is not None and stats is not None:
        raise ValueError("stats count a whole launch: no lanes")
    if lanes is not None and lights and tri is not None and boxes is not None:
        # a shadow list is its whole block's: run the slice's blocks whole
        blocks = torch.unique(lanes // BLOCK_R)
        work = (blocks[:, None] * BLOCK_R
                + torch.arange(BLOCK_R, device=dev)).flatten()
        work = work[work < r]
        out = simple_trace_plain(
            rows[:, work].contiguous(), cam, table, tri, boxes, lidx, ldat,
            n_sph=n_sph, spp=spp, s0=s0, width=width, height=height,
            use_sky=use_sky, flat=flat, folds=folds, sph=sph)
        return out[:, torch.searchsorted(work, lanes)]
    sel = torch.arange(r, device=dev) if lanes is None else lanes
    blk = sel // BLOCK_R
    h1 = rng.bits_to_u32(rows[2])
    pos, fc, cx, cy = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    o = pos[:, None].expand(3, sel.shape[0])
    acc = torch.zeros((3, sel.shape[0]), dtype=torch.float32, device=dev)
    rays = torch.zeros(sel.shape[0], dtype=torch.float32, device=dev)
    every = torch.ones(sel.shape[0], dtype=torch.bool, device=dev)
    sph_stats = None if stats is None else stats[5:8]

    def record(o_, d_, active, tiles, shadow: bool):
        """One search's fold record and triangle counts."""
        if folds is not None:
            folds.append((o_, d_, tiles, active))
        if stats is None or tri is None:
            return
        live = torch.zeros(int(blk.max()) + 1, dtype=torch.bool, device=dev)
        live[blk[active]] = True
        stats[2 + shadow] += int(live.sum())
        if tiles is None:
            stats[4] += int(active.sum()) * tri.shape[0]
        else:
            stats[4] += int(tiles[active].sum()) * (tri.shape[0]
                                                   // tiles.shape[1])

    for s in range(s0, s0 + spp):
        base = rng.sample_base(h1, s)
        tiles = None
        if tri is not None and boxes is not None:
            # the lists of the full launch's blocks, all of whose lanes
            # search
            d_all = film_rays(rows[0], rows[1], base, width, height, pos, fc,
                              cx, cy)
            reach = _block_reach(boxes, init_state(pos.expand(r, 3), d_all,
                                                   base))
            tiles = reach[blk]
            d = d_all[sel].T
            if stats is not None:
                stats[0] += int(reach.sum())
        else:
            d = film_rays(rows[0, sel], rows[1, sel], base[sel], width,
                          height, pos, fc, cx, cy).T
        idx = nearest_prim(_rays(o, d, every), table, tri, tiles, sph,
                           sph_stats)
        hit = idx >= 0
        record(o, d, every, tiles, False)
        w = table[idx.clamp(min=0)].T
        alb, emis = w[4:7], w[7:10]
        rays = rays + 1.0
        if flat:
            color = alb + emis
        else:
            # ops/intersect.hit_payload's roots from the winner row
            m0, m1, m2 = w[0] - o[0], w[1] - o[1], w[2] - o[2]
            tp = _dot3(m0, m1, m2, d[0], d[1], d[2])
            q0, q1, q2 = m0 - d[0] * tp, m1 - d[1] * tp, m2 - d[2] * tp
            x = safe_sqrt(w[3] * w[3] - _dot3(q0, q1, q2, q0, q1, q2))
            tn = tp - x
            inside = tn < _EPS
            t = torch.where(inside, tp + x, tn)
            nr = [(o[k] + d[k] * t) - w[k] for k in range(3)]
            n = list(nrm3_fwd(*nr)[:3])
            if tri is not None:
                # a triangle row holds its plane (n, k) in the (centre,
                # radius) slots
                is_tri = idx >= n_sph
                nd = _dot3(d[0], d[1], d[2], w[0], w[1], w[2])
                no = _dot3(o[0], o[1], o[2], w[0], w[1], w[2])
                t = torch.where(is_tri,
                                (w[3] - no) / torch.where(nd == 0.0, 1.0, nd),
                                t)
                inside = torch.where(is_tri, nd > 0.0, inside)
                nt = nrm3_fwd(w[0], w[1], w[2])
                n = [torch.where(is_tri, nt[k], n[k]) for k in range(3)]
            no3 = torch.stack([o[k] + d[k] * t for k in range(3)])
            n = [torch.where(inside, -n[k], n[k]) for k in range(3)]
            color = emis
            for j, li in enumerate(lights):
                ld = torch.stack(nrm3_fwd(*[ldat[j, k] - no3[k]
                                            for k in range(3)])[:3])
                stiles = None
                if tri is not None and boxes is not None:
                    # the block's list of its hit lanes' shadow rays (sel
                    # is every lane here)
                    sst = init_state(no3.T, ld.T, torch.zeros_like(blk))
                    sst[12] = hit.to(torch.float32)
                    sreach = _block_reach(boxes, sst)
                    stiles = sreach[blk]
                    if stats is not None:
                        stats[1] += int(sreach.sum())
                sidx = nearest_prim(_rays(no3, ld, hit), table, tri, stiles,
                                    sph, sph_stats)
                record(no3, ld, hit, stiles, True)
                lam = torch.clamp_min(_dot3(*n, *ld), 0.0)
                visible = (sidx == li) & hit
                color = color + torch.where(
                    visible, alb * ldat[j, 3:6, None] * lam, 0.0)
                rays = rays + hit
        miss = (sky_color(d.T).T if use_sky else torch.zeros_like(d))
        acc = acc + torch.where(hit, color, miss)
    return torch.cat([acc, rays[None]])


def simple_trace(rows, cam, table, tri, boxes, lidx, ldat, *, n_sph: int,
                 spp: int, s0: int, width: int, height: int, use_sky: bool,
                 flat: bool, sph: SphereTiles | None, stats=None):
    """K9 (``csrc/simple_shade.cu``): ``simple_trace_plain``'s contract on
    all R lanes in one launch, one thread per lane -> out [4,R]; the
    sphere tiles ``sph`` are needed on the card. stats: None, or an int64
    [N_STATS] tensor the launch adds its counts to (see
    ``simple_trace_plain``; the pairs tested are those K9's front-to-back
    walk reaches). CPU tensors take ``simple_trace_plain``."""
    kw = dict(n_sph=n_sph, spp=spp, s0=s0, width=width, height=height,
              use_sky=use_sky, flat=flat, sph=sph, stats=stats)
    if not rows.is_cuda:
        return simple_trace_plain(rows, cam, table, tri, boxes, lidx, ldat,
                                  **kw)
    dev, r = rows.device, rows.shape[1]
    build.require(rows, "rows", torch.float32, (3, r), dev)
    build.require(cam, "cam", torch.float32, (13,), dev)
    build.require(table, "table", torch.float32, (table.shape[0], 12), dev)
    m = 0 if tri is None else tri.shape[0]
    if n_sph + m != table.shape[0]:
        raise ValueError(f"table of {table.shape[0]} rows, {n_sph} spheres "
                         f"and {m} triangles")
    n_tiles = 0
    if tri is not None:
        build.require(tri, "tri", torch.float32, (m, 9), dev)
        if boxes is not None:
            build.require(boxes, "boxes", torch.float32,
                          (boxes.shape[0], 6), dev)
            n_tiles = boxes.shape[0]
        else:
            n_tiles = m // TRI_BLOCK_M
    if sph is None:
        raise ValueError("K9 folds the spheres over their tiles: give sph "
                         "(simple_tables)")
    _check_sph(sph, table[:n_sph], None, None, dev)
    if stats is not None:
        build.require(stats, "stats", torch.int64, (N_STATS,), dev)
    n_lights = -1
    if not flat:
        n_lights = lidx.shape[0]
        build.require(lidx, "lidx", torch.int32, (n_lights,), dev)
        build.require(ldat, "ldat", torch.float32, (n_lights, 6), dev)
    film_w, film_h = film_extent(width, height)
    out = torch.empty((4, r), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_simple_trace(
            rows.data_ptr(), r, cam.data_ptr(), table.data_ptr(), n_sph,
            ptr(tri), m, ptr(boxes), n_tiles, sph.boxes.data_ptr(),
            sph.starts.data_ptr(), sph.boxes.shape[0], sph.gboxes.data_ptr(),
            sph.gstarts.data_ptr(), sph.gboxes.shape[0], float(sph.o_lim),
            None if flat else ptr(lidx), None if flat else ptr(ldat),
            n_lights, int(spp), int(s0), int(bool(use_sky)), int(width),
            int(height), float(film_w), float(film_h), ptr(stats),
            out.data_ptr(), build.stream_of(rows))
    build.check("trt_simple_trace", err)
    simple_trace.launches += 1
    return out


simple_trace.launches = 0


@torch.no_grad()
def simple_tables(scene: Scene, lights: tuple, bound: float):
    """K9's scene inputs (no autograd history) -> dict(table, tri, boxes,
    sph, lidx, ldat, n_sph, use_sky): the winner table of the scene with
    its spheres Morton-permuted and its triangles in scene order, the
    triangles' search table and inflated tile boxes, the Morton tiles of
    the sphere rows (``regen.sphere_tiles``) for origins within the larger
    of ``bound`` (the camera's |position|_inf, ``origin_bound``: no
    default, as for ``fused_tables``) and the triangles' extent (a shadow
    ray starts at a hit point; a lane whose origin lies past the bound
    folds every sphere tile), the lights' permuted ids and their centres
    and emissives. A triangle scene past ``resident_tables_fit`` is
    refused: ``models/path_tracer.render_pixels`` sends it to the eager
    estimator on the probe route, with a warning."""
    if scene.tris is not None and not resident_tables_fit(
            scene.n_pad, scene.tris.n_pad):
        raise NotImplementedError(
            f"{scene.tris.n_pad} padded triangles are past "
            "resident_tables_fit: K9's fused tables are resident; "
            "render_pixels routes such a scene to the probe route and the "
            "streaming triangle search")
    perm = morton_perm(scene)
    table = prim_table(permute_spheres(scene, perm)).contiguous()
    tri = boxes = None
    if scene.tris is not None:
        tri = tri_search_table(scene.tris)
        boxes = tri_tile_boxes(scene.tris).contiguous()
        tr = scene.tris
        bound = max(bound, origin_bound(
            torch.cat([tr.v0, tr.v0 + tr.e1, tr.v0 + tr.e2])))
    li = torch.tensor(list(lights), dtype=torch.int64, device=scene.device)
    where = torch.empty_like(perm)
    where[perm] = torch.arange(perm.shape[0], device=perm.device)
    return dict(table=table, tri=tri, boxes=boxes,
                sph=sphere_tiles(table[:scene.n_pad], bound),
                lidx=where[li].to(torch.int32),
                ldat=torch.cat([scene.center[li], scene.emissive[li]],
                               dim=1).contiguous(),
                n_sph=scene.n_pad, use_sky=scene.use_sky)


def _key(v):
    """A key of v that changes when v does: a tensor by its identity and
    its version counter (which every in-place write bumps), a dataclass
    by its fields, any other value as itself."""
    if torch.is_tensor(v):
        return id(v), v._version
    if dataclasses.is_dataclass(v):
        return tuple(_key(getattr(v, f.name)) for f in dataclasses.fields(v))
    return v


_LAST_TABLES: list = []     # [(key, (scene, camera), tables)]


def pass_tables(scene: Scene, camera: Camera, lights: tuple):
    """``simple_tables(scene, lights, origin_bound(camera.position[None]))``,
    kept for the last scene, camera and lights: a pass over a scene and a
    camera that nothing has written to since the last pass (the
    progressive loop's next pass) builds nothing on the host (a write
    through ``.data`` bypasses the version counter and goes unseen). The
    scene and camera are held with the tables, so that their tensors' ids
    stay theirs."""
    key = (_key(scene), _key(camera), tuple(lights))
    if not _LAST_TABLES or _LAST_TABLES[0][0] != key:
        _LAST_TABLES[:] = [(key, (scene, camera), simple_tables(
            scene, lights, origin_bound(camera.position[None])))]
    return _LAST_TABLES[0][2]


def _run(scene: Scene, camera: Camera, pixel, s0: int, cfg, tb):
    """K9 over the pixel set [R] -> (color_sum [R,3], rays [] int64).
    tb: ``simple_tables`` of the scene and camera, or None to build
    them."""
    width, height, seed, spp, mode, lights = cfg
    with torch.no_grad():
        if tb is None:
            tb = simple_tables(scene, lights,
                               origin_bound(camera.position[None]))
        out = simple_trace(
            lane_rows(pixel, width, seed), cam13(camera, s0 + spp),
            tb["table"], tb["tri"], tb["boxes"], tb["lidx"], tb["ldat"],
            n_sph=tb["n_sph"], spp=spp, s0=s0, width=width, height=height,
            use_sky=tb["use_sky"], flat=mode == "flat", sph=tb["sph"])
    return out[0:3].T.contiguous(), out[3].to(torch.int64).sum()


def _rebuild(scene: Scene, camera: Camera, leaves):
    """The scene and camera with their leaves (``Scene.leaves`` order,
    then position and look_at) replaced by ``leaves``."""
    vals = dict(zip(scene.leaves, leaves))
    tris = scene.tris
    if tris is not None:
        tris = dataclasses.replace(tris, **{
            k[5:]: v for k, v in vals.items() if k.startswith("tris.")})
    scene = dataclasses.replace(scene, tris=tris, **{
        k: v for k, v in vals.items() if not k.startswith("tris.")})
    return scene, Camera(*leaves[-2:])


class SimpleTrace(torch.autograd.Function):
    """The fused estimator trace with its backward (the JAX custom VJP of
    ``make_simple_trace``).

    Differentiable inputs: every scene leaf and the camera's position and
    look_at. Forward: K9; nothing is saved but the inputs. Backward: the
    eager estimator (``render_pixels`` on backend "cuda", whose searches
    are K1 and K7 on the card) re-run one sample at a time under autograd,
    each sample's vector-Jacobian product summed, so its activations live
    for one sample. The gradient is that of the eager route, which agrees
    with K9's forward except on a ray whose winner the lists or the
    rounding of the two op orders change. cfg: (width, height, seed, spp,
    mode, lights, s0, the forward's ``simple_tables`` or None, the scene
    and camera whose leaves the tensors replace)."""

    @staticmethod
    def forward(ctx, pixel, cfg, *leaves):
        scene, camera = _rebuild(cfg[-2], cfg[-1], leaves)
        color, rays = _run(scene, camera, pixel, cfg[6], cfg[:6], cfg[7])
        ctx.save_for_backward(pixel, *leaves)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(rays)
        return color, rays

    @staticmethod
    def backward(ctx, d_color, _):
        from tpu_ray_torch.models.path_tracer import render_pixels
        width, height, seed, spp, mode, lights, s0 = ctx.cfg[:7]
        pixel, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        grads = [None] * len(leaves)
        with torch.enable_grad():
            inputs = [v.detach().requires_grad_(bool(g))
                      for v, g in zip(leaves, need)]
            scene, camera = _rebuild(ctx.cfg[-2], ctx.cfg[-1], inputs)
            wanted = [k for k, g in enumerate(need) if g]
            for s in range(s0, s0 + spp):
                color, _ = render_pixels(
                    scene, camera, pixel, width=width, height=height, spp=1,
                    sample_start=s, seed=seed, backend="cuda", shading=mode,
                    lights=lights)
                parts = torch.autograd.grad(
                    color, [inputs[k] for k in wanted], d_color,
                    allow_unused=True)
                for k, g in zip(wanted, parts):
                    if g is not None:
                        grads[k] = g if grads[k] is None else grads[k] + g
        return (None, None, *grads)


@functools.lru_cache(maxsize=None)
def make_simple_trace(width: int, height: int, seed: int, spp: int,
                      mode: str, lights: tuple = ()):
    """Differentiable fused estimator trace: (scene, camera, pixel, s0=0,
    tables=None) -> (color_sum [R,3] over samples s0 .. s0 + spp - 1,
    rays_cast int). mode "flat" or "lambert_shadow" (lights: the global
    indices of the light spheres, ``ops/shading_modes.scene_light_indices``).
    tables: ``pass_tables(scene, camera, lights)``, to share among the
    chunks and passes (None: built here). Where nothing asks for a
    gradient this is K9 alone; otherwise ``SimpleTrace``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    lights = tuple(int(i) for i in lights)

    def trace(scene: Scene, camera: Camera, pixel, s0: int = 0,
              tables=None):
        leaves = [scene.leaf(k) for k in scene.leaves] + [camera.position,
                                                          camera.look_at]
        cfg = (width, height, seed, spp, mode, lights)
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in leaves)):
            color, rays = _run(scene, camera, pixel, int(s0), cfg, tables)
            return color, int(rays)
        color, rays = SimpleTrace.apply(
            pixel, cfg + (int(s0), tables, scene, camera), *leaves)
        return color, int(rays)

    return trace
