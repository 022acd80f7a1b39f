"""One run of one cell: resolve the cell from its files, set up the
program, measure the window, check what it produced, report.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives:
  configs/<config>.json    the scene and the render settings as run
  traffic/<traffic>.json   the loop (``"loop"``) and what the check samples
  cells/<workload>.json    the check's limits and the launches the route
                           must show
  metrics/<metric>.py      a reader: ``read(r)`` -> a number, or None
                           where the run has nothing for it to read
The loops are the two ways users drive the program: ``fwdbwd`` (an
inverse-rendering step: ``render_mean`` + ``image_mse(...).backward()``
over every scene leaf and the camera) and ``pass`` (a progressive
``PathTracer.step``), each in a closed loop with one caller, each step
ending in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import random
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import check, devtrace, scenes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ray")
PROFILE_AT = 0.4          # share of the window before the traced stretch
PROFILE_MIN_S = 1.0       # the traced stretch covers at least this long
PROFILE_TRIES = 3


class MissingKernel(RuntimeError):
    """A kernel whose launch counter moved is absent from the trace."""


@dataclass
class Cell:
    name: str
    chips: int
    config: str
    cfg: dict
    traffic: dict
    spec: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def render(self) -> dict:
        out = dict(self.cfg["render"])
        out.update(self.traffic.get("render", {}))
        return out


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def resolve(name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    wl = [w for w in spec["workloads"] if w["name"] == name]
    if len(wl) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    conf = [c for c in spec["configs"] if c["name"] == wl["config"]][0]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]
    return Cell(name=name, chips=int(wl["chips"]), config=conf["name"],
                cfg=_json(os.path.join(root, conf["file"])),
                traffic=_json(os.path.join(bench_dir, "traffic",
                                           wl["traffic"] + ".json")),
                spec=_json(os.path.join(bench_dir, "cells", name + ".json")),
                end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                per_layer=[m for m in spec["per_layer"] if applies(m)])


def load_reader(metric: str, bench_dir: str = HERE):
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    mod_name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def counter(path: str) -> int:
    """A launch counter of the program, ``"module:function.attribute"``."""
    mod, attr = path.split(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return int(obj)


def forbidden_modules(modules) -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load
    (compared whole: ``tpu_ray_torch`` is not ``tpu_ray``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@dataclass
class Seeds:
    render: int
    target: int
    pick: int

    @staticmethod
    def of(seed: int) -> "Seeds":
        words = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(
            3, np.uint32)
        return Seeds(*(int(w) for w in words))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    return torch.profiler.record_function(name)


def import_program(root: str = ROOT):
    """Import the port from this checkout, and fail if it comes from
    anywhere else."""
    import tpu_ray_torch
    pkg = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if pkg != os.path.join(os.path.abspath(root), "tpu_ray_torch"):
        raise RuntimeError(f"tpu_ray_torch must come from {root}, got {pkg}")
    return tpu_ray_torch


class Loop:
    """A traffic loop: set-up in ``__init__``, one step a call of
    ``step(k)`` (returning the rays it cast), then ``check()`` once the
    window has closed and ``release()`` has freed the program's state."""

    def __init__(self, cell: Cell, seeds: Seeds, device):
        from tpu_ray_torch.core.camera import Camera
        from tpu_ray_torch.core.scene import scene_from_numpy
        self.cell, self.seeds, self.device = cell, seeds, device
        self.r = cell.render
        self.arrays, self.static = scenes.build(cell.cfg["scene"])
        self.pos, self.look_at = scenes.orbit(self.arrays["look_at"],
                                              self.static)
        st = self.static
        self.scene = scene_from_numpy(
            self.arrays, device=device, requires_grad=self.grad,
            tri_n_real=st["tri_n_real"] or None, use_sky=st["use_sky"],
            n_real=st["n_real"])
        self.camera = Camera(*(torch.tensor(a, device=device,
                                            requires_grad=self.grad)
                               for a in (self.pos, self.look_at)))

    grad = False

    @property
    def lanes(self) -> int:
        return self.r["width"] * self.r["height"]

    @property
    def table_rows(self) -> int:
        rows = self.arrays["radius"].shape[0]
        if "tris.v0" in self.arrays:
            rows += self.arrays["tris.v0"].shape[0]
        return rows

    def window_step(self):
        """Called after each step of the window."""

    def release(self):
        self.scene = self.camera = None

    def ref_scene(self, dtype=torch.float32, grad: bool = False):
        from benchmark import reference
        sc = reference.Scene(self.arrays, self.static, self.device, dtype,
                             grad)
        cam = [torch.tensor(a, device=self.device).to(dtype)
               .requires_grad_(grad) for a in (self.pos, self.look_at)]
        return sc, cam


class FwdBwd(Loop):
    """An inverse-rendering step at a fixed scene: the spp-mean image of
    fresh samples, its MSE against a target the harness makes from the
    seed, the gradient of every scene leaf and of the camera's position
    and look_at. The step checked is drawn from the seed among the
    window's steps (a reservoir of one, so no step is copied)."""

    grad = True

    def __init__(self, cell, seeds, device):
        super().__init__(cell, seeds, device)
        from tpu_ray_torch.grad.render_grad import image_mse, render_mean
        self._render, self._mse = render_mean, image_mse
        g = torch.Generator(device=device)
        g.manual_seed(seeds.target)
        self.target = torch.rand((self.r["height"], self.r["width"], 3),
                                 generator=g, device=device)
        self.leaves = ([(k, self.scene.leaf(k)) for k in self.scene.leaves]
                       + [("camera.position", self.camera.position),
                          ("camera.look_at", self.camera.look_at)])
        self.pick = random.Random(seeds.pick)
        self.kept = None
        self.window_steps = 0

    def step(self, k: int) -> int:
        r = self.r
        for _, t in self.leaves:
            t.grad = None
        with span("bench.render_mean"):
            img, rays = self._render(
                self.scene, self.camera, width=r["width"],
                height=r["height"], spp=r["spp"], sample_start=k * r["spp"],
                seed=self.seeds.render, max_bounces=r["max_bounces"],
                backend=r["backend"], ray_chunk=r["ray_chunk"],
                regen=r["regen"], return_rays=True)
        with span("bench.loss"):
            loss = self._mse(img, self.target)
        with span("bench.backward"):
            loss.backward()
        with span("bench.sync"):
            sync(self.device)
        self.last = (k, img.detach(), int(rays),
                     {n: t.grad for n, t in self.leaves})
        return int(rays)

    def release(self):
        super().release()
        self.leaves = self.last = self._render = None

    def window_step(self):
        """Called after each step of the window: keep it with chance 1/i."""
        self.window_steps += 1
        if self.pick.random() * self.window_steps < 1.0:
            self.kept = self.last

    def check(self, limits: dict, dtype=torch.float32):
        from benchmark import reference
        k, img, rays, grads = self.kept
        r = self.r
        sc, (pos, look_at) = self.ref_scene(dtype, grad=True)
        spp = r["spp"]
        target = self.target.to(dtype)

        def cotangent(total):
            cs = total.detach().clone().requires_grad_()
            im = (cs / torch.tensor(float(spp), dtype=dtype,
                                    device=cs.device)).reshape(img.shape)
            torch.mean((im - target) ** 2).backward()
            return cs.grad
        pixels = torch.arange(self.lanes, device=self.device)
        total, ref_rays = reference.render(
            sc, pos, look_at, width=r["width"], height=r["height"],
            pixels=pixels, spp=spp, sample_start=k * spp,
            seed=self.seeds.render, max_bounces=r["max_bounces"],
            cotangent=cotangent)
        ref_img = (total / torch.tensor(float(spp), dtype=dtype,
                                        device=total.device)
                   ).reshape(img.shape)
        ref_grads = dict(sc.leaves)
        ref_grads = {n: t.grad for n, t in ref_grads.items()}
        ref_grads["camera.position"] = pos.grad
        ref_grads["camera.look_at"] = look_at.grad
        gaps = check.leaf_gaps(grads, ref_grads)
        got = dict(image=check.rel_l2(img, ref_img),
                   rays=check.rel_gap(rays, ref_rays),
                   grad=max(gaps.values()),
                   grad_off=check.entries_off(grads, ref_grads))
        return check.judge(got, limits), dict(step=k, rays=rays,
                                              ref_rays=ref_rays,
                                              leaf_gaps=gaps, numbers=got)


class Pass(Loop):
    """Progressive passes: ``PathTracer.step`` folds each pass of spp
    fresh samples into the running mean, carried from pass to pass."""

    def __init__(self, cell, seeds, device):
        super().__init__(cell, seeds, device)
        from tpu_ray_torch import PathTracer, RenderConfig
        r = self.r
        conf = RenderConfig(scene=cell.config, width=r["width"],
                            height=r["height"], spp=r["spp"],
                            max_bounces=r["max_bounces"],
                            backend=r["backend"], seed=self.seeds.render,
                            ray_chunk=r["ray_chunk"], regen=r["regen"])
        self.tracer = PathTracer(conf, scene=self.scene, device=device)
        self.state = self.tracer.init_state()
        self.prev = None
        self.passes = 0
        self.last_rays = 0

    def step(self, k: int) -> int:
        with span("bench.pass"):
            state, rays = self.tracer.step(self.state, self.camera)
        with span("bench.sync"):
            sync(self.device)
        self.prev, self.state = self.state, state
        self.passes += 1
        self.last_rays = int(rays)
        return int(rays)

    def release(self):
        super().release()
        self.tracer = None

    def check(self, limits: dict, dtype=torch.float32):
        """The running mean at pixels drawn from the seed, re-traced over
        every pass from the first; the last pass over every pixel (its
        mean folded into the program's previous mean, as ``accumulate``
        folds it) and its rays."""
        from benchmark import reference
        r, spp = self.r, self.r["spp"]
        sc, (pos, look_at) = self.ref_scene(dtype)
        n_pick = min(int(self.cell.traffic["check_pixels"]), self.lanes)
        pick = np.sort(np.random.default_rng(self.seeds.pick).choice(
            self.lanes, n_pick, replace=False))
        px = torch.as_tensor(pick, device=self.device)
        kw = dict(width=r["width"], height=r["height"], spp=spp,
                  seed=self.seeds.render, max_bounces=r["max_bounces"])
        with torch.no_grad():
            mean = torch.zeros((n_pick, 3), dtype=dtype, device=self.device)
            for p in range(self.passes):
                s, _ = reference.render(sc, pos, look_at, pixels=px,
                                        sample_start=p * spp, **kw)
                mean = check.fold(mean, p * spp, s, spp)
            full, ref_rays = reference.render(
                sc, pos, look_at,
                pixels=torch.arange(self.lanes, device=self.device),
                sample_start=(self.passes - 1) * spp, **kw)
            prev = self.prev.mean.to(dtype)
            last = check.fold(prev.reshape(-1, 3), (self.passes - 1) * spp,
                              full, spp)
        got_mean = self.state.mean.reshape(-1, 3)
        got = dict(history=check.rel_l2(got_mean[px], mean),
                   last=check.rel_l2(got_mean, last),
                   rays=check.rel_gap(self.last_rays, ref_rays))
        return check.judge(got, limits), dict(passes=self.passes,
                                              rays=self.last_rays,
                                              ref_rays=ref_rays, numbers=got)


LOOPS = {"fwdbwd": FwdBwd, "pass": Pass}


@dataclass
class Reading:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    loop: str
    lanes: int
    table_rows: int
    setup_s: float
    window_s: float
    step_s: List[float]
    rays: List[int]
    peak_bytes: int
    host_step_s: List[float] = field(default_factory=list)
    trace: Optional[devtrace.TraceSummary] = None
    trace_steps: int = 0
    trace_rays: List[int] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)

    def kernel_seconds(self, kernels, counters) -> Optional[float]:
        """Device seconds of the named kernels over the traced stretch;
        None where none of them launched there; ``MissingKernel`` where
        one launched and the trace holds none of them."""
        if self.trace is None:
            return None
        launched = sum(self.launches.get(c, 0) for c in counters)
        if launched == 0:
            return None
        s = self.trace.seconds(kernels)
        if s <= 0:
            raise MissingKernel(f"{kernels} launched {launched} times in the "
                                "traced stretch and are not in the trace")
        return s


def _profile_warm(device):
    """Start the profiler once in set-up, so its first start (CUPTI) is
    not paid inside the window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(1024, device=device).sum().item()
    return acts


class Tracer:
    """The traced stretch of a ``--trace 1`` run: ``PROFILE_MIN_S`` or
    more of whole steps, begun after ``PROFILE_AT`` of the window, read and
    validated when it ends; tried again on the next steps where a kernel
    that launched is missing from the trace."""

    def __init__(self, device, readers):
        self.acts = _profile_warm(device)
        self.counters = sorted({c for m in readers.values()
                                for c in getattr(m, "COUNTERS", ())})
        self.checks = [(getattr(m, "KERNELS", ()), getattr(m, "COUNTERS", ()))
                       for m in readers.values()]
        self.start_at = math.inf
        self.prof = None
        self.summary = None
        self.tries = 0

    def before(self, now: float, step_s: List[float]):
        if self.summary is not None or self.prof is not None:
            return
        if now < self.start_at:
            return
        from torch.profiler import profile
        med = sorted(step_s)[len(step_s) // 2] if step_s else 1.0
        self.want = max(3, min(50, math.ceil(PROFILE_MIN_S / max(med, 1e-3))))
        self.steps, self.rays = 0, []
        self.before_counts = {c: counter(c) for c in self.counters}
        self.prof = profile(activities=self.acts)
        self.prof.__enter__()

    def after(self, rays: int) -> bool:
        """-> whether the step just run was traced."""
        if self.prof is None:
            return False
        self.steps += 1
        self.rays.append(rays)
        if self.steps >= self.want:
            self._finish()
        return True

    def _finish(self):
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        launches = {c: counter(c) - self.before_counts[c]
                    for c in self.counters}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = devtrace.load(path)
        lo, hi = devtrace.span_bounds(events, "bench.step")
        summary = devtrace.summarize(events, lo, hi)
        self.tries += 1
        missing = [k for k, c in self.checks
                   if c and k and sum(launches[x] for x in c) > 0
                   and summary.seconds(k) <= 0]
        if missing:
            if self.tries >= PROFILE_TRIES:
                raise MissingKernel(f"{missing} launched but absent from "
                                    f"{self.tries} traces")
            return
        self.summary, self.launches = summary, launches
        self.traced_steps, self.traced_rays = self.steps, self.rays


def step_summary(step_s: List[float]) -> dict:
    """The window's step times in ms: quartiles, and the mean of its first
    and last fifths (a drift inside the window shows there)."""
    ms = sorted(1e3 * x for x in step_s)
    fifth = max(1, len(step_s) // 5)
    q = [ms[int(f * (len(ms) - 1))] for f in (0.25, 0.5, 0.75)]
    return dict(n=len(step_s), q1_ms=q[0], median_ms=q[1], q3_ms=q[2],
                first_fifth_ms=1e3 * sum(step_s[:fifth]) / fifth,
                last_fifth_ms=1e3 * sum(step_s[-fifth:]) / fifth)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: Optional[float] = None,
             log=print, require_route: bool = True,
             marks: Optional[Dict[str, float]] = None) -> dict:
    """Set up, warm up, measure ``seconds`` of the cell's loop, check the
    output against the reference -> the result line's object.
    require_route=False (CPU tests: the plain versions count no launches)
    skips the check that the cell's kernels launched. ``marks``: set-up
    stages already passed, each (wall seconds from ``t_process``, the
    process's CPU seconds); the result's ``setup_stages`` adds this
    function's own."""
    t_process = time.perf_counter() if t_process is None else t_process
    marks = dict(marks or {})

    def mark(name):
        marks[name] = (time.perf_counter() - t_process, time.process_time())
    import_program()
    mark("import_program")
    seeds = Seeds.of(seed)
    loop = LOOPS[cell.traffic["loop"]](cell, seeds, device)
    sync(device)
    mark("scene")
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    route = dict(cell.spec.get("launches", {})) if require_route else {}

    k = 0
    for _ in range(int(cell.traffic.get("warmup_steps", 2))):
        loop.step(k)
        mark(f"warmup_{k}")
        k += 1
    tracer = Tracer(device, readers) if trace else None
    sync(device)
    mark("profiler")
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    route_at = {c: counter(c) for c in route}
    step_s, rays, host_s = [], [], []
    t_start = time.perf_counter()
    mark("window")
    deadline = t_start + seconds
    if tracer is not None:
        tracer.start_at = t_start + PROFILE_AT * seconds
    while True:
        t0 = time.perf_counter()
        if tracer is not None:
            tracer.before(t0, host_s)
        with span("bench.step"):
            n = loop.step(k)
        t1 = time.perf_counter()
        k += 1
        loop.window_step()
        step_s.append(t1 - t0)
        rays.append(n)
        if tracer is None or not tracer.after(n):
            host_s.append(t1 - t0)
        if t1 >= deadline and (tracer is None or (
                tracer.prof is None and tracer.summary is not None)):
            break
    t_end = t1
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launched = {c: counter(c) - route_at[c] for c in route}
    for c, per_step in route.items():
        if launched[c] < per_step * len(step_s):
            raise RuntimeError(f"the route did not take {c}: {launched[c]} "
                               f"launches in {len(step_s)} steps")
    if tracer is not None and tracer.summary is None:
        raise MissingKernel("no traced stretch could be read")

    reading = Reading(loop=cell.traffic["loop"], lanes=loop.lanes,
                      table_rows=loop.table_rows,
                      setup_s=t_start - t_process, window_s=t_end - t_start,
                      step_s=step_s, rays=rays, peak_bytes=window_peak,
                      host_step_s=host_s)
    if tracer is not None:
        reading.trace = tracer.summary
        reading.trace_steps = tracer.traced_steps
        reading.trace_rays = tracer.traced_rays
        reading.launches = tracer.launches
    out_metrics = {}
    for m in metrics:
        v = readers[m["name"]].read(reading)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    (correct, checks), facts = loop.check(cell.spec["limits"])
    log(f"check: {time.perf_counter() - t_check:.1f} s, {facts}")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct), "attempted": len(step_s),
              "failed": 0, "metrics": out_metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.summary.busy_s
        dev["window_s"] = tracer.summary.window_s
        result["breakdown"] = {
            "device_ops": tracer.summary.device_ops(),
            "idle_gaps": tracer.summary.idle_gaps}
    result["steps"] = step_summary(step_s)
    result["setup_stages"] = marks
    result["numbers"] = facts.pop("numbers")
    result["launches"] = launched
    result["checks"] = checks
    return result
