"""Time K2's culled sphere search and K3 against variants built from
patched copies of the package.

    python -m tpu_ray_torch.tools.cull_variants [--reps 2]

Each variant (VARIANTS) is a copy of the package under the git-ignored
``.chip_check/variants/<name>/`` with one change: K2's sphere tiles of 32
spheres (``kernels/regen.py`` ``SPH_TILE``), groups of 1 or 8 tiles
(``SPH_GROUP``), a tile folded by the warp where at most 4, 8 or 12 lanes
need it (``csrc/common.cuh`` ``TRT_SPH_SHARE_LANES``, 6), and the tiles
taken front to back (each lane its own order by box entry, a tile folded
with the (t, id) compare, stopping at the first tile entered past its
best); K3 (``csrc/regen_bwd.cu``) in blocks of one warp with no barrier,
in the 256-thread blocks of eight warps it replaced, and with its two
warps taking turns on named barriers in place of the two block barriers
a step. The copies build at once, one nvcc each. Then each build runs in
a process of its own, in turns: this build, every variant, this build,
at rtweekend 1920x1080, 64 spp, the regen route's own state and records.
Each times K2's culled search (this build also the sweep of every
sphere) and K3. Every K2 variant must end in the sweep's state bit for
bit; every K3 variant must give this build's d_state bit for bit, and
d_table and d_cam within 1e-4 of each column's max. One JSON line a run;
the last line is a summary with the card's name and power limit. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_OUT = os.path.join(_ROOT, ".chip_check", "variants")
WIDTH, HEIGHT, SPP, MAX_BOUNCES, SEED = 1920, 1080, 64, 5, 0

REGEN_PY = "kernels/regen.py"
COMMON = "csrc/common.cuh"
SHADE = "csrc/shade.cuh"
BWD = "csrc/regen_bwd.cu"

# K2 front to back: every lane enters the tile boxes of the groups it
# enters, then folds the tile of least entry (the lowest id on a tie) while
# that entry is at most its best, with the (t, id) compare, so that a later
# tile of the same t and a lower id still wins; a lane past o_lim, or a
# table of more than 64 tiles, folds every sphere in order
FRONT_TO_BACK = """\
__device__ __forceinline__ void trt_fold_sph_tiles(
    const float4* sph, const float* box, const int* tst, const float* gbox,
    const int* gst, int n_groups, float o_lim, bool active,
    float ox, float oy, float oz, float dx, float dy, float dz, float& best,
    int& bi, unsigned* counts) {
  best = TRT_F32_MAX;
  bi = 0;
  if (!active) return;
  const TrtRay ray = trt_ray(ox, oy, oz, dx, dy, dz);
  const int n_tiles = gst[n_groups];
  const float inf = __int_as_float(0x7f800000);
  if (!(fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz)) <= o_lim) ||
      n_tiles > 64) {
    trt_fold_spheres(sph, 0, tst[n_tiles], ox, oy, oz, dx, dy, dz, best,
                     bi);
    counts[1] += (unsigned)n_tiles;
    counts[2] += (unsigned)tst[n_tiles];
    return;
  }
  float ent[64];
  for (int g = 0; g < n_groups; ++g) {
    const int t0 = gst[g], t1 = gst[g + 1];
    bool in_g = true;
    if (t1 - t0 > 1) {
      in_g = trt_box_entry(ray, gbox + 6 * g) < inf;
      counts[0] += 1u;
    }
    for (int t = t0; t < t1; ++t) {
      ent[t] = inf;
      if (in_g) {
        ent[t] = trt_box_entry(ray, box + 6 * t);
        counts[0] += 1u;
      }
    }
  }
  for (;;) {
    int tb = -1;
    float eb = inf;
    for (int t = 0; t < n_tiles; ++t) {
      if (ent[t] < eb) {
        eb = ent[t];
        tb = t;
      }
    }
    if (tb < 0 || !(eb <= best)) break;
    ent[tb] = inf;
    const int j0 = tst[tb], j1 = tst[tb + 1];
    counts[1] += 1u;
    counts[2] += (unsigned)(j1 - j0);
    for (int j = j0; j < j1; ++j) {
      float th;
      if (trt_sphere_hit(sph[j], ox, oy, oz, dx, dy, dz, th) &&
          (th < best || (th == best && j < bi))) {
        best = th;
        bi = j;
      }
    }
  }
}

"""
FOLD_START = "__device__ __forceinline__ void trt_fold_sph_tiles("
FOLD_END = "// Stage n spheres"

# K3's barrier of a step in the shared-row branch (csrc/shade.cuh
# trt_row_turns, which K6 shares in blocks of 256 threads), and what the
# variants put in its place
BARRIER_LOOP = """\
  for (int wp = 0; wp < n_warps; ++wp) {
    if (warp == wp && leader) {
      for (int k = 0; k < 12; ++k) {
        acc[12 * key + k] = acc[12 * key + k] + sum[k];
      }
    }
    __syncthreads();
  }
"""
# one warp a block owns its row: no block barrier
ONE_WARP_LOOP = """\
  if (blockDim.x == 32) {
    if (leader) {
      for (int k = 0; k < 12; ++k) {
        acc[12 * key + k] = acc[12 * key + k] + sum[k];
      }
    }
    __syncwarp();
  } else
""" + BARRIER_LOOP
# warp 0 adds, then warp 1, each waiting only for the other's last turn
# (barriers 1 and 2; warp 1 opens barrier 1 before the first tile, warp 0
# takes its last arrival after the last)
TURNS_LOOP = """\
  if (blockDim.x == 64) {
    asm volatile("bar.sync %0, 64;" :: "r"(1 + warp) : "memory");
    if (leader) {
      for (int k = 0; k < 12; ++k) {
        acc[12 * key + k] = acc[12 * key + k] + sum[k];
      }
    }
    __threadfence_block();
    asm volatile("bar.arrive %0, 64;" :: "r"(2 - warp) : "memory");
    __syncwarp();
  } else
""" + BARRIER_LOOP
BEFORE_TILES = """\
  // every loop bound below is the same for all threads of the block, so"""
OPEN_TURNS = """\
  if (SMEM_ROW && THREADS == 64 && (threadIdx.x >> 5) == 1) {
    asm volatile("bar.arrive 1, 64;" ::: "memory");
  }
"""
AFTER_TILES = """\
  // the block's camera cotangents, summed over its threads in order"""
CLOSE_TURNS = """\
  if (SMEM_ROW && THREADS == 64 && (threadIdx.x >> 5) == 0) {
    asm volatile("bar.sync 1, 64;" ::: "memory");
  }
"""
SMEM_THREADS = "#define TRT_BWD_SMEM_THREADS 64\n"
SMEM_PARTS = "#define TRT_BWD_SMEM_PARTS 1024\n"
SMEM_BLOCKS = "#define TRT_BWD_SMEM_BLOCKS 8\n"


def _k2(old: str, new: str, path: str = REGEN_PY):
    return [(path, old, new)]


# name -> [(file under the package, text, its replacement)]
VARIANTS = {
    "k2 tile 32": _k2("SPH_TILE = 16\n", "SPH_TILE = 32\n"),
    "k2 group 1": _k2("SPH_GROUP = 4\n", "SPH_GROUP = 1\n"),
    "k2 group 8": _k2("SPH_GROUP = 4\n", "SPH_GROUP = 8\n"),
    "k2 share 4": _k2("#define TRT_SPH_SHARE_LANES 6\n",
                      "#define TRT_SPH_SHARE_LANES 4\n", COMMON),
    "k2 share 8": _k2("#define TRT_SPH_SHARE_LANES 6\n",
                      "#define TRT_SPH_SHARE_LANES 8\n", COMMON),
    "k2 share 12": _k2("#define TRT_SPH_SHARE_LANES 6\n",
                       "#define TRT_SPH_SHARE_LANES 12\n", COMMON),
    "k2 front to back": [(COMMON, None, FRONT_TO_BACK)],
    "k3 1 warp": [(BWD, SMEM_THREADS, "#define TRT_BWD_SMEM_THREADS 32\n"),
                  (SHADE, BARRIER_LOOP, ONE_WARP_LOOP)],
    "k3 8 warps": [(BWD, SMEM_THREADS,
                    "#define TRT_BWD_SMEM_THREADS 256\n"),
                   (BWD, SMEM_PARTS, "#define TRT_BWD_SMEM_PARTS 256\n"),
                   (BWD, SMEM_BLOCKS, "#define TRT_BWD_SMEM_BLOCKS 1\n")],
    "k3 turns": [(SHADE, BARRIER_LOOP, TURNS_LOOP),
                 (BWD, BEFORE_TILES, OPEN_TURNS + BEFORE_TILES),
                 (BWD, AFTER_TILES, CLOSE_TURNS + AFTER_TILES)],
}


def _patch(text: str, old, new: str) -> str:
    """text with old replaced by new; old None: trt_fold_sph_tiles."""
    if old is None:
        a, e = text.find(FOLD_START), text.find(FOLD_END)
        if a < 0 or e < a or text.count(FOLD_START) != 1:
            raise RuntimeError("csrc/common.cuh no longer holds the fold "
                               "this script replaces")
        return text[:a] + new + text[e:]
    if text.count(old) != 1:
        raise RuntimeError(f"the package no longer holds {old[:60]!r}")
    return text.replace(old, new)


def _copy(name: str, edits) -> str:
    """The package under .chip_check/variants/<name>/ with edits -> root."""
    root = os.path.join(_OUT, name.replace(" ", "_"))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(root, "tpu_ray_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = os.path.join(root, "tpu_ray_torch", rel)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(_patch(text, old, new))
    return root


def _setup(torch, root: str):
    """The route's tables, state and search tiles of rtweekend at
    WIDTHxHEIGHT, SPP, from the package under root."""
    sys.path.insert(0, root)
    import tpu_ray_torch
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.core.scene import make_scene
    from tpu_ray_torch.kernels import regen
    from tpu_ray_torch.models.path_tracer import tile_order

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    dev = torch.device("cuda", 0)
    scene = make_scene("rtweekend", device=dev)
    table, _, _ = regen.regen_tables(scene)
    cam = default_camera(scene)
    perm, _ = tile_order(WIDTH, HEIGHT)
    st0, c13, _ = regen.wave_init(cam, torch.as_tensor(perm, device=dev),
                                  SPP, SEED, 0, WIDTH, HEIGHT)
    kw = dict(use_sky=scene.use_sky, max_bounces=MAX_BOUNCES, width=WIDTH,
              height=HEIGHT)
    sph = regen.sphere_tiles(table, float(cam.position.abs().max()))
    return regen, dev, table, st0, c13, kw, sph


def _ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _bits(torch, t):
    return t.contiguous().view(torch.int32)


def _child(root: str, name: str, ref_path: str, reps: int) -> dict:
    """K2 and K3 of the package under root at the route's state; K3's
    outputs are saved to ref_path where it does not exist, else held
    against it."""
    import torch
    regen, dev, table, st0, c13, kw, sph = _setup(torch, root)
    steps = SPP * MAX_BOUNCES
    sweep = st0.clone()
    _, sweep_ms = _ms(torch, lambda: regen.regen_steps(sweep, c13, table,
                                                       steps, **kw))
    rays = int(sweep[22].to(torch.int64).sum())
    k2_ms = []
    for _ in range(reps + 1):                 # the first call warms up
        st = st0.clone()
        k2_ms.append(_ms(torch, lambda: regen.regen_steps(
            st, c13, table, steps, sph=sph, **kw))[1])
        if not torch.equal(_bits(torch, st), _bits(torch, sweep)):
            raise RuntimeError(f"{name}: K2 ends in another state than the "
                               f"sweep")
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    regen.regen_steps(st0.clone(), c13, table, steps, sph=sph, stats=stats,
                      **kw)
    boxes, folded, pairs = stats.tolist()
    recs = regen.regen_record(st0.clone(), c13, table, steps, regen.SEG_MAX,
                              sph=sph, **kw)
    g = torch.Generator(device=dev).manual_seed(SEED)
    d_out = torch.zeros_like(st0)
    d_out[16:19] = torch.randn((3, st0.shape[1]), generator=g,
                               device=dev) * 1e-3
    k3_ms = []
    for _ in range(reps + 1):
        out, t = _ms(torch, lambda: regen.regen_bwd(recs, d_out, c13, table,
                                                    **kw))
        k3_ms.append(t)
    if not os.path.exists(ref_path):
        torch.save([x.cpu() for x in out], ref_path)
    d_st, d_tab, d_cam = torch.load(ref_path)
    if not torch.equal(_bits(torch, out[0].cpu()), _bits(torch, d_st)):
        raise RuntimeError(f"{name}: K3's d_state differs")
    # d_table by column, d_cam by its four rows of three
    for got, want in ((out[1].cpu(), d_tab),
                      (out[2].cpu().view(4, 3).T, d_cam.view(4, 3).T)):
        tol = 1e-4 * want.abs().amax(dim=0)
        if bool(((got - want).abs() > tol).any()):
            raise RuntimeError(f"{name}: K3's d_table or d_cam differs")
    return dict(run=name, rays=rays, k2_ms=k2_ms[1:], sweep_ms=sweep_ms,
                tiles=int(sph.boxes.shape[0]),
                groups=int(sph.gboxes.shape[0]), boxes_a_ray=boxes / rays,
                tiles_a_ray=folded / rays, pairs_a_ray=pairs / rays,
                k3_ms=k3_ms[1:], k3=regen.regen_bwd_info(table.shape[0], dev))


def _build(root: str) -> subprocess.Popen:
    """Start the build of the library of the package under root."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tpu_ray_torch.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code, root], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child, args.reps)), flush=True)
        return 0
    os.makedirs(_OUT, exist_ok=True)
    ref_path = os.path.join(_OUT, "k3_reference.pt")
    if os.path.exists(ref_path):
        os.remove(ref_path)
    roots = {"this build": _ROOT}
    roots.update((name, _copy(name, edits))
                 for name, edits in VARIANTS.items())
    builds = {name: _build(root) for name, root in roots.items()}
    for name, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {name} failed:\n{err[-4000:]}")
    runs = []
    for name in ["this build", *VARIANTS, "this build"]:
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_ray_torch.tools.cull_variants",
             "--reps", str(args.reps), "--child", roots[name], name,
             ref_path],
            cwd=roots[name], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the run of {name} failed:\n"
                               f"{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": card, "k2_ms": {}, "k3_ms": {}, "sweep_ms": []}
    for r in runs:
        summary["sweep_ms"].append(r["sweep_ms"])
        summary["k2_ms"].setdefault(r["run"], []).extend(r["k2_ms"])
        summary["k3_ms"].setdefault(r["run"], []).extend(r["k3_ms"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
