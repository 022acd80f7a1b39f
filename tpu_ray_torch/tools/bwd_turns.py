"""Time the backward kernels K3 and K6 of this build against another
checkout's, and against patched copies, in turns.

    python -m tpu_ray_torch.tools.bwd_turns --other DIR [--rounds 1]
        [--reps 3] [--variants [TEXT]] [--probes]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into the git-ignored
``.chip_check/``). ``--variants`` adds copies of this build with the
global-row block shape of K3 or K6 changed, or with part of the global-row
sum changed or taken out (VARIANTS; those named "probe" are timing probes
whose d_table is wrong by design; texts after it, comma-separated, keep
only the variants whose name holds one of them). ``--probes`` adds copies
of the other checkout with part of its global-row sum taken out (PROBES:
written against the code of K3 and K6 before their merge, the turns of
commit 1fbfafd, each a timing probe too). Every copy lives under the
git-ignored ``.chip_check/bwd_turns/`` and all builds run at once, one
nvcc each. Then each build runs in a process of its own, in turns: this
build, the other, every variant and probe, then the same backwards,
``--rounds`` times. Each run times, by CUDA events, after one warm-up
call:

- K3's triangle branch: one ``regen_bwd`` at trimesh 1920x1080, 2 spp, on
  the regen route's own records (K2's listed recording), a random colour
  cotangent;
- K6 on trimesh: a per-sample step's 10 ``bounce_bwd`` launches (2
  samples x 5 bounces) at the route's own states (K8's);
- the controls, the shared-row branches: K3 at rtweekend 1920x1080, 64
  spp (K2's culled recording), and K6 over rtweekend's sample 0 (5
  launches, K4 culled);

and then one trimesh fwd+bwd step on each route (``render_mean(...,
backend="fused")``, regen and per-sample) for its wall seconds and its
peak device memory above what the run held before. Every run saves its
d_table and d_cam; the summary says, for each build against this build
and against the other, whether they are bit-equal, and whether d_state is
(by a digest of its bits). One JSON line a run; the last line is a summary
with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_OUT = os.path.join(_ROOT, ".chip_check", "bwd_turns")
WIDTH, HEIGHT, MAX_BOUNCES, SEED = 1920, 1080, 5, 0
TRI_SPP, SPH_SPP = 2, 64
CELLS = ("k3 trimesh", "k6 trimesh", "k3 rtweekend", "k6 rtweekend")

BWD = "csrc/regen_bwd.cu"
BOUNCE = "csrc/bounce.cu"

# the global-row block shapes of K3 and K6 in this build
SHAPE = ("#define TRT_BWD_THREADS {}\n#define TRT_BWD_PARTS {}\n"
         "#define TRT_BWD_BLOCKS {}\n")
THIS_SHAPE = SHAPE.format(256, 256, 2)
K6_SHAPE = ("#define TRT_BWD_ROW_THREADS {}\n#define TRT_BWD_ROW_PARTS {}\n"
            "#define TRT_BWD_ROW_BLOCKS {}\n")
THIS_K6_SHAPE = K6_SHAPE.format(256, 256, 2)
SHADE = "csrc/shade.cuh"


def _shape(threads: int, parts: int, blocks: int):
    return [(BWD, THIS_SHAPE, SHAPE.format(threads, parts, blocks))]


def _k6_shape(threads: int, parts: int, blocks: int):
    return [(BOUNCE, THIS_K6_SHAPE, K6_SHAPE.format(threads, parts, blocks))]


# probes of this build's global-row branch, each a timing probe whose
# d_table is wrong by design: K6 with no merge at all (the d_winner kept
# alive by a test no cotangent of the runs passes), the merge of K3 and K6
# without the row's read and write, and K3 and K6 without the sum launch
_K6_MERGE = "      trt_row_merge(mg, key, d_w, row, counts);\n"
_K6_NO_MERGE = """\
      float z = 0.0f;
      for (int k = 0; k < 12; ++k) z = z + d_w[k];
      counts[1] += z == -1e38f ? 1u : 0u;
"""
_ROW_READ = """\
      if (seen) {
        for (int q = 0; q < 3; ++q) {
          const float4 x = dst[q];
          v[4 * q] = x.x; v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
        }
      } else {
        for (int k = 0; k < 12; ++k) v[k] = 0.0f;
      }
"""
_ROW_WRITE = """\
      for (int q = 0; q < 3; ++q) {
        dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                             v[4 * q + 3]);
      }
"""
_NO_ROW_WRITE = """\
      float z = 0.0f;
      for (int k = 0; k < 12; ++k) z = z + v[k];
      if (z == -1e38f) dst[0].x = z;
"""
_K3_SUM_LAUNCH = "  trt_sum_parts_launch(part, cfg.smem_row"
_K6_SUM_LAUNCH = "  trt_sum_parts_launch(part, smem_row"

# the merge with the slots in one buffer and a second barrier a step; each
# block's lane tiles contiguous (tiles [k T / grid, (k + 1) T / grid)) in
# place of k, k + grid, ...: a probe too, as the plain order is the latter
_BUFS = "#define TRT_MERGE_BUFS 2\n"
_K3_TILES = ("  for (int tile = blockIdx.x; tile < n_tiles; "
             "tile += gridDim.x) {\n")
_K6_TILES = ("  for (int tile = blockIdx.x; tile < n_lane_tiles; "
             "tile += gridDim.x) {\n")


def _contiguous(tiles: str) -> str:
    return (f"  for (int tile = blockIdx.x * {tiles} / gridDim.x; tile < "
            f"(blockIdx.x + 1) * {tiles} / gridDim.x; ++tile) {{\n")


# the merge's key search four keys a read (16-byte loads: each warp's keys
# start 128 bytes apart); the sum launch's loop over the parts unrolled
_SLOT = """\
  for (int j = 0; j < m; ++j) at = keys[j] == key ? j : at;
"""
_SLOT_X4 = """\
  for (int j = 0; j < m; j += 4) {
    const int4 q = *reinterpret_cast<const int4*>(keys + j);
    at = q.x == key ? j : at;
    at = j + 1 < m && q.y == key ? j + 1 : at;
    at = j + 2 < m && q.z == key ? j + 2 : at;
    at = j + 3 < m && q.w == key ? j + 3 : at;
  }
"""
_SUM_LOOP = """\
  for (int k = 0; k < parts; ++k) {
    if (s_bits[k] & bit) s = s + part[(size_t)k * m + j];
  }
"""

# name -> [(file under the package, text, its replacement)], on this
# build: K3's global-row blocks of 64 and 128 threads (8 and 4 blocks an
# SM, 16 warps as this build) in as many parts as fit, 128 threads in
# 1,024 parts, and 256 threads at one block an SM (the turns' occupancy);
# K6's in blocks of 128 and 64 threads (16 warps an SM, as this build),
# and held to 3 blocks of 256 or 6 of 128 an SM (at most 85 registers a
# thread); the merge's two barriers a step; its key search four keys a
# read; the sum launch unrolled by 8; the probes
VARIANTS = {
    "k3 global 64": _shape(64, 1024, 8),
    "k3 global 128": _shape(128, 512, 4),
    "k3 global 128, 1024 parts": _shape(128, 1024, 4),
    "k3 global 256, 1 an SM": _shape(256, 256, 1),
    "k6 global 128": _k6_shape(128, 512, 4),
    "k6 global 64": _k6_shape(64, 1024, 8),
    "k6 global 256, 3 an SM": _k6_shape(256, 256, 3),
    "k6 global 128, 6 an SM": _k6_shape(128, 512, 6),
    "two barriers a step": [(SHADE, _BUFS, "#define TRT_MERGE_BUFS 1\n")],
    "key search four keys a read": [(SHADE, _SLOT, _SLOT_X4)],
    "sum unrolled": [(SHADE, _SUM_LOOP, "#pragma unroll 8\n" + _SUM_LOOP)],
    "probe: contiguous tiles": [
        (BWD, _K3_TILES, _contiguous("n_tiles")),
        (BOUNCE, _K6_TILES, _contiguous("n_lane_tiles"))],
    "probe: k6 no merge": [(BOUNCE, _K6_MERGE, _K6_NO_MERGE)],
    "probe: no row read or write": [(SHADE, _ROW_READ, "      for (int k = 0; "
                                     "k < 12; ++k) v[k] = 0.0f;\n"),
                                    (SHADE, _ROW_WRITE, _NO_ROW_WRITE)],
    "probe: no sum launch": [
        (BWD, _K3_SUM_LAUNCH, "  if (cfg.smem_row) " + _K3_SUM_LAUNCH[2:]),
        (BOUNCE, _K6_SUM_LAUNCH, "  if (smem_row) " + _K6_SUM_LAUNCH[2:])],
}

# the turns of the global-row sum before the merge (the shared-row branch
# runs the same loop); the probe keeps the leader's sum alive with a test
# that no cotangent of the runs passes, and takes out the row's
# read-add-write
_TURNS = """\
{i}if (warp == {w} && leader) {{
{i}  for (int {k} = 0; {k} < 12; ++{k}) {{
{i}    acc[12 * key + {k}] = acc[12 * key + {k}] + sum[{k}];
{i}  }}
{i}}}
"""
_NO_RMW = """\
{i}if (warp == {w} && leader) {{
{i}  float z = 0.0f;
{i}  for (int {k} = 0; {k} < 12; ++{k}) z = z + sum[{k}];
{i}  if (z == -1e38f) acc[12 * key] = z;
{i}}}
"""
_ZERO = ("  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) "
         "acc[k] = 0.0f;\n")
_ZERO_SMEM = ("  if (smem_row) {\n"
              "    for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) "
              "acc[k] = 0.0f;\n  }\n")
_K3_SUM = "  if (m > 0) {\n    regen_bwd_sum_kernel"
_K3_SUM_SMEM = "  if (m > 0 && cfg.smem_row) {\n    regen_bwd_sum_kernel"
_K6_SUM = "  sum_parts_kernel<<<"
_K6_SUM_SMEM = "  if (smem_row) sum_parts_kernel<<<"

# name -> edits, on the other checkout
PROBES = {
    "other, no row turns": [
        (BWD, *(t.format(i=" " * 10, w="wp", k="k")
                for t in (_TURNS, _NO_RMW))),
        (BOUNCE, *(t.format(i=" " * 6, w="w", k="c")
                   for t in (_TURNS, _NO_RMW)))],
    "other, no zeroing or sum": [
        (BWD, _ZERO, _ZERO_SMEM), (BWD, _K3_SUM, _K3_SUM_SMEM),
        (BOUNCE, _ZERO, _ZERO_SMEM), (BOUNCE, _K6_SUM, _K6_SUM_SMEM)],
}


def _copy(src_root: str, name: str, edits) -> str:
    """The package of src_root under _OUT/<name>/ with edits -> root."""
    root = os.path.join(_OUT, "".join(c if c.isalnum() else "_"
                                      for c in name))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(src_root, "tpu_ray_torch"),
                    os.path.join(root, "tpu_ray_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = os.path.join(root, "tpu_ray_torch", rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {rel} no longer holds "
                               f"{old[:60]!r} once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def _build(root: str) -> subprocess.Popen:
    """Start the build of the library of the package under root."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tpu_ray_torch.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code, root], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _child(root: str, name: str, out: str, reps: int) -> dict:
    """The four backwards and the two fwd+bwd steps on the package under
    root -> their numbers; d_table and d_cam saved under out."""
    sys.path.insert(0, root)
    import torch

    import tpu_ray_torch
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import make_scene, trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.kernels import bounce_step as bs
    from tpu_ray_torch.kernels import regen
    from tpu_ray_torch.models.path_tracer import tile_order
    from tpu_ray_torch.ops.raygen import camera_rays

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    dev = torch.device("cuda", 0)
    perm, _ = tile_order(WIDTH, HEIGHT)
    px = torch.as_tensor(perm, device=dev)
    run = dict(run=name)
    saved = {}

    def ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(reps + 1):           # the first call warms up
            torch.cuda.synchronize()
            start.record()
            res = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return res, times[1:]

    def digest(t):
        bits = t.contiguous().view(torch.int32).to(torch.int64).flatten()
        w = torch.arange(bits.numel(), device=dev) % 1021 + 1
        return [int(bits.sum()), int((bits * w).sum())]

    def k3(scene_name, spp, search):
        sc = make_scene(scene_name, device=dev)
        table, tri, n_tri = regen.regen_tables(sc)
        cam = default_camera(sc)
        st0, c13, _ = regen.wave_init(cam, px, spp, SEED, 0, WIDTH, HEIGHT)
        kw = dict(use_sky=sc.use_sky, max_bounces=MAX_BOUNCES, width=WIDTH,
                  height=HEIGHT)
        steps = spp * MAX_BOUNCES
        if tri is not None:
            srch = dict(tri=tri, boxes=bs.tab_tile_boxes(tri))
        else:
            srch = dict(sph=regen.sphere_tiles(
                table, float(cam.position.abs().max())))
        recs = regen.regen_record(st0.clone(), c13, table, steps,
                                  min(regen.SEG_MAX, steps), **srch, **kw)
        g = torch.Generator(device=dev).manual_seed(SEED)
        d_out = torch.zeros_like(st0)
        d_out[16:19] = torch.randn((3, st0.shape[1]), generator=g,
                                   device=dev) * 1e-3
        (d_st, d_tab, d_cam), t = ms(lambda: regen.regen_bwd(
            recs, d_out, c13, table, n_tri=n_tri, **kw))
        saved[search] = dict(d_table=d_tab.cpu(), d_cam=d_cam.cpu(),
                             d_state=digest(d_st))
        run[search] = dict(ms=t, lanes=st0.shape[1],
                           table_rows=table.shape[0],
                           k3=regen.regen_bwd_info(table.shape[0], dev))

    def k6(scene_name, samples, cell):
        sc = make_scene(scene_name, device=dev)
        cam = default_camera(sc)
        tb = bs.fused_tables(sc, bs.origin_bound(cam.position[None]))
        kw = dict(use_sky=sc.use_sky, n_sph=tb.n_sph)
        chains = []
        with torch.no_grad():
            for k in range(samples):
                st = bs.init_state(*camera_rays(cam, WIDTH, HEIGHT, px, k,
                                                SEED))
                states, idxs = [], []
                for b in range(MAX_BOUNCES):
                    if tb.tri is not None:
                        out, idx = bs.bounce_fwd_list(st, tb.table, tb.tri,
                                                      tb.boxes, b, **kw)
                    else:
                        out, idx = bs.bounce_fwd(st, tb.table, b, sph=tb.sph,
                                                 **kw)
                    states.append(st)
                    idxs.append(idx)
                    st = out
                d = torch.zeros_like(st)
                d[9:12] = st[9:12]           # the cotangent of sum(c^2)/2
                chains.append((states, idxs, d))

        def step():
            tabs = []
            for states, idxs, d0 in chains:
                d = d0.clone()
                for b in reversed(range(MAX_BOUNCES)):
                    d, tab = bs.bounce_bwd(states[b], tb.table, idxs[b], b,
                                           d, **kw)
                    tabs.append(tab)
            return d, torch.stack(tabs)

        (d, tabs), t = ms(step)
        saved[cell] = dict(d_table=tabs.cpu(), d_state=digest(d))
        run[cell] = dict(ms=t, launches=samples * MAX_BOUNCES,
                         lanes=px.shape[0], table_rows=tb.table.shape[0])

    k3("trimesh", TRI_SPP, "k3 trimesh")
    k6("trimesh", TRI_SPP, "k6 trimesh")
    k3("rtweekend", SPH_SPP, "k3 rtweekend")
    k6("rtweekend", 1, "k6 rtweekend")
    torch.save(saved, os.path.join(out, name.replace(" ", "_") + ".pt"))

    # one trimesh fwd+bwd step on each route: wall seconds and peak memory
    sc = make_scene("trimesh", device=dev)
    for route, regen_on in (("trimesh fwd+bwd regen", True),
                            ("trimesh fwd+bwd per-sample", False)):
        s2 = trainable_scene(sc)
        c2 = trainable_camera(default_camera(sc))
        secs, peaks = [], []
        for _ in range(reps + 1):
            for k in s2.leaves:
                s2.leaf(k).grad = None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            img = render_mean(s2, c2, width=WIDTH, height=HEIGHT,
                              spp=TRI_SPP, seed=SEED, max_bounces=MAX_BOUNCES,
                              backend="fused", regen=regen_on)
            image_mse(img, torch.zeros_like(img)).backward()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - held)
            del img
        run[route] = dict(step_s=secs[1:], peak_bytes=max(peaks))
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", nargs="?", const="", default=None,
                    help="add the variants whose name holds one of these "
                         "comma-separated texts (all without one)")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child, args.reps)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("bwd_turns needs a CUDA device")
    other = os.path.abspath(args.other)
    os.makedirs(_OUT, exist_ok=True)
    roots = {"this build": _ROOT, "other": other}
    if args.variants is not None:
        keep = args.variants.split(",")
        roots.update((n, _copy(_ROOT, n, e)) for n, e in VARIANTS.items()
                     if any(k in n for k in keep))
    if args.probes:
        roots.update((n, _copy(other, n, e)) for n, e in PROBES.items())
    builds = {n: _build(r) for n, r in roots.items()}
    for n, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {n} failed:\n{err[-4000:]}")
    names = list(roots)
    runs = []
    for name in (names + names[::-1]) * args.rounds:
        # this file as a script, so that a checkout without it runs too
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--reps",
             str(args.reps), "--child", roots[name], name, _OUT],
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
    saved = {n: torch.load(os.path.join(_OUT, n.replace(" ", "_") + ".pt"))
             for n in names}
    summary = {"card": card, "bits_equal": {}}
    for ref in ("this build", "other"):
        summary["bits_equal"][f"to {ref}"] = {
            name: {cell: {k: (v == saved[ref][cell][k]
                              if isinstance(v, list) else
                              torch.equal(v.view(torch.int32),
                                          saved[ref][cell][k].view(
                                              torch.int32)))
                          for k, v in saved[name][cell].items()}
                   for cell in CELLS}
            for name in names if name != ref}
    for r in runs:
        for key, v in r.items():
            if key == "run":
                continue
            s = summary.setdefault(key, {}).setdefault(r["run"], {})
            for field in ("ms", "step_s", "peak_bytes"):
                if field in v:
                    s.setdefault(field, []).extend(
                        v[field] if isinstance(v[field], list)
                        else [v[field]])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
