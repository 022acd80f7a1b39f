"""The host spans and host-device counters of the regen and probe routes
(``tpu_ray_torch/utils/metrics.py``), and the benchmark readers' paths to
them.

On the CPU: a span's self time, the profiler annotation only while a
profiler records, the route's spans nested as the readers sum them, and
every counter path a reader names. Marked ``cuda`` (they skip where there
is no GPU): a warm regen fwd+bwd step on a sphere and on a triangle scene,
the probe route's step on bigmesh (past the residency rule ``fused``
falls back to it), and a progressive pass, their host syncs held to
``torch.cuda``'s sync-debug warnings and their host-to-device bytes to
the copies in a profiler trace of the same step. This file imports no
JAX, so it runs on the card without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_trace.py -q
"""
import json
import threading
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)
from tpu_ray_torch import PathTracer, RenderConfig
from tpu_ray_torch.core.camera import default_camera, trainable_camera
from tpu_ray_torch.core.scene import make_scene, trainable_scene
from tpu_ray_torch.grad.render_grad import image_mse, render_mean
from tpu_ray_torch.utils.metrics import (EVENT_PREFIX, SPANS, TRANSFERS,
                                         span)

READERS = [f"{n}.{s}" for n in ("route_ms", "host_syncs", "htod_mib")
           for s in ("fwdbwd", "fwd")] + ["probe_ms"]
# the route's stages in the order each route opens them
FWDBWD_STAGES = ("tile_order", "regen_tables", "wave_init", "search_tables",
                 "regen_forward", "untile")
PASS_STAGES = ("tile_order", "regen_tables", "search_tables", "wave_init",
               "regen_forward", "untile", "accumulate")


def snapshot():
    return {n: (c.calls, c.ns, c.self_ns) for n, c in vars(SPANS).items()}


def since(before):
    return {n: tuple(a - b for a, b in zip(c, before[n]))
            for n, c in snapshot().items()}


def test_self_time_leaves_out_child_spans():
    before = snapshot()
    with span("render_mean"):
        time.sleep(0.002)
        with span("tile_order"):
            time.sleep(0.001)
            with span("wait"):
                time.sleep(0.001)
        with span("untile"):
            time.sleep(0.001)
    d = since(before)
    top, mid, wait, leaf = (d[n] for n in ("render_mean", "tile_order",
                                           "wait", "untile"))
    assert [x[0] for x in (top, mid, wait, leaf)] == [1, 1, 1, 1]
    assert wait[2] == wait[1] >= 1_000_000
    assert mid[2] == mid[1] - wait[1] >= 1_000_000
    assert top[2] == top[1] - mid[1] - leaf[1] >= 2_000_000
    assert all(v == (0, 0, 0) for n, v in d.items()
               if n not in ("render_mean", "tile_order", "wait", "untile"))


def test_span_closes_on_raise_and_other_threads_are_not_children():
    before = snapshot()
    with pytest.raises(ValueError):
        with span("untile"):
            raise ValueError("inside")

    def other():
        with span("regen_backward"):
            time.sleep(0.002)
    with span("render_mean"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    d = since(before)
    assert d["untile"][0] == 1
    assert d["regen_backward"][0] == 1
    # the other thread's span takes nothing from this thread's self time,
    # and the span that raised left nothing open to charge a child to
    assert d["render_mean"][2] == d["render_mean"][1] >= 2_000_000
    with pytest.raises(AttributeError):
        span("no_such_stage")


def test_spans_reach_the_profiler_only_while_it_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with span("wait"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("wait"):
            pass
    assert opened == ["tpu_ray_torch.wait"]
    assert "tpu_ray_torch.wait" in {e.name for e in prof.events()}
    with span("wait"):
        pass
    assert opened == ["tpu_ray_torch.wait"]


def traced_spans(fn):
    """fn() under the profiler -> {span name: [(start, end) us, ...]}."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name.startswith(EVENT_PREFIX):
            out.setdefault(e.name[len(EVENT_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    return out


def held_nested(got, top, stages):
    """Each stage opened once, inside the one ``top`` span, in order."""
    (lo, hi), = got[top]
    starts = []
    for s in stages:
        (a, b), = got[s]
        assert lo <= a <= b <= hi, s
        starts.append(a)
    assert starts == sorted(starts)


def test_regen_step_and_pass_open_the_route_spans_on_the_cpu():
    w, h, kw = 8, 8, dict(spp=1, max_bounces=2, backend="fused", regen=True)
    scene = trainable_scene(make_scene("rtweekend", device="cpu"))
    camera = trainable_camera(default_camera(scene))
    syncs, htod = TRANSFERS.host_syncs, TRANSFERS.htod_bytes
    before = snapshot()

    def fwdbwd():
        img = render_mean(scene, camera, width=w, height=h, **kw)
        image_mse(img, torch.zeros_like(img)).backward()
    got = traced_spans(fwdbwd)
    held_nested(got, "render_mean", FWDBWD_STAGES)
    (lo, hi), = got["render_mean"]
    (a, b), = got["regen_backward"]
    assert a >= hi
    d = since(before)
    assert all(d[s][0] == 1 for s in FWDBWD_STAGES + ("render_mean",
                                                      "regen_backward"))

    conf = RenderConfig(scene="rtweekend", width=w, height=h, **kw)
    tracer = PathTracer(conf, device="cpu")
    state = tracer.init_state()
    got = traced_spans(lambda: tracer.step(state))
    held_nested(got, "pass", PASS_STAGES)
    assert "regen_backward" not in got and "render_mean" not in got
    # CPU tensors are neither copied to nor read from a card
    assert (TRANSFERS.host_syncs, TRANSFERS.htod_bytes) == (syncs, htod)


@pytest.mark.parametrize("name", READERS)
def test_every_counter_a_reader_names_resolves(name):
    mod = harness.load_reader(name)
    assert mod.PATHS and mod.COUNTERS == mod.PATHS
    for path in mod.PATHS:
        assert isinstance(harness.counter(path), int)


# ---- on the card ------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def fwdbwd_step(kind, dev, w, h, spp):
    scene = trainable_scene(make_scene(kind, device=dev))
    camera = trainable_camera(default_camera(scene))
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    target = torch.rand((h, w, 3), generator=g, device=dev)
    leaves = [scene.leaf(k) for k in scene.leaves] + [camera.position,
                                                      camera.look_at]

    def step():
        for t in leaves:
            t.grad = None
        img = render_mean(scene, camera, width=w, height=h, spp=spp,
                          backend="fused", regen=True)
        image_mse(img, target).backward()
    return step


def htod_copied(prof, path) -> int:
    """Bytes of the trace's host-to-device copies."""
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(int(e["args"]["bytes"]) for e in events
               if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))


def held_to_the_card(step, tmp_path):
    """A warm step's counters against sync-debug mode's warnings and a
    profiler trace's copies -> (syncs counted, warnings, bytes counted,
    bytes copied, where each warning came from)."""
    step()
    step()
    torch.cuda.synchronize()
    s0 = TRANSFERS.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = TRANSFERS.host_syncs - s0
    warned = [f"{w.filename}:{w.lineno}" for w in caught
              if "synchronizing CUDA operation" in str(w.message)]
    b0 = TRANSFERS.htod_bytes
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return (syncs, len(warned), TRANSFERS.htod_bytes - b0,
            htod_copied(prof, tmp_path / "trace.json"), warned)


W, H = 320, 180


@pytest.mark.cuda
@pytest.mark.parametrize("kind,spp", [("rtweekend", 4), ("trimesh", 1),
                                      ("bigmesh", 1)])
def test_fwdbwd_counters_match_the_card(cuda_device, tmp_path, kind, spp):
    syncs, warned, htod, copied, where = held_to_the_card(
        fwdbwd_step(kind, cuda_device, W, H, spp), tmp_path)
    print(f"{kind}: {syncs} syncs, {htod} B to the card; warned at {where}")
    assert syncs == warned, where
    assert htod == copied
    # a warm step sends no tile table (one is W * H * 8 bytes)
    assert htod < W * H * 8


@pytest.mark.cuda
def test_pass_counters_match_the_card(cuda_device, tmp_path):
    conf = RenderConfig(scene="rtweekend", width=W, height=H, spp=4,
                        backend="fused", regen=True)
    tracer = PathTracer(conf, device=cuda_device)
    state = [tracer.init_state()]

    def step():
        state[0], _ = tracer.step(state[0])
    syncs, warned, htod, copied, where = held_to_the_card(step, tmp_path)
    print(f"pass: {syncs} syncs, {htod} B to the card; warned at {where}")
    assert syncs == warned, where
    assert htod == copied
    # a warm step sends no tile table (one is W * H * 8 bytes)
    assert htod < W * H * 8
