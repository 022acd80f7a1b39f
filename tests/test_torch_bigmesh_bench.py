"""The benchmark's bigmesh configuration and the probe route it measures,
on the CPU.

bigmesh (``benchmark/configs/bigmesh.json``) is the program's own
``make_scene("bigmesh")``, built by the benchmark's ``scenes.py``. Its
cell runs ``render_mean(backend="fused")``, which past the residency rule
falls back to the probe route (K1 and K10 on the card; their plain
versions here). At ``subdivisions=5`` (40,962 triangles, already past the
rule) on a 16x9 frame the route is held to the plain reference
(``benchmark/reference.py``) through the harness's own fwd+bwd loop and
check, the bfloat16 control fails every tolerance, the route opens its
six spans, and the new readers read what they should.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import (calibrate, check, control_chunked, devtrace, harness,
                       reference, scenes)
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.bounce_step import resident_tables_fit
from tpu_ray_torch.models.path_tracer import past_residency
from tpu_ray_torch.ops import shade
from tpu_ray_torch.utils.metrics import EVENT_PREFIX, SPANS, TRANSFERS

PROBE_SPANS = ("probe_tables", "ray_sort", "sphere_search", "tri_search",
               "payload", "shade")
NEW_CELLS = ("bigmesh-fwdbwd", "trimesh-pass")
SEED = 2 ** 31 + 4242
# The CPU route computes every f32 operation in the reference's order on
# the same winners, so image and rays agree to the bit here; the image's
# limit leaves room for a vectorised CPU kernel rounding a few lanes
# apart, far below the ~0.3 that the bfloat16 reference reads.
IMAGE_TOL = 1e-6
# Autograd adds the lanes' terms of a leaf in another order than the
# reference's (K11's plain fixed order against index_select's backward):
# a few f32 ulps of the leaf, ~1e-7 relative; bfloat16 reads 0.08-1.5.
LEAF_TOL = 1e-5
# The share of gradient entries that matter and miss by over 1e-3 of
# themselves (check.entries_off): none here, where every lane takes the
# reference's path; a lane that took another would move the few entries
# its primitives own. bfloat16 misses ~0.9 of them.
GRAD_OFF_TOL = 1e-3


def small_cell(subdivisions=5, width=16, height=9):
    """bigmesh-fwdbwd with a smaller mesh and frame, and limits that pass
    everything (the test holds the numbers to its own tolerances)."""
    cell = harness.resolve("bigmesh-fwdbwd")
    cfg = copy.deepcopy(cell.cfg)
    cfg["scene"]["subdivisions"] = subdivisions
    cfg["render"].update(width=width, height=height)
    cell.cfg = cfg
    cell.spec = dict(cell.spec, limits={k: 1e9 for k in
                                        ("image", "rays", "grad",
                                         "grad_off")})
    return cell


def counts():
    return {n: c.calls for n, c in vars(SPANS).items()}


@pytest.fixture(scope="module")
def probe_step():
    """One fwd+bwd step of the small cell through the harness's loop,
    under the profiler -> (the program's leaves, the loop's check facts,
    span calls the step added, {span: [(start, end)]}, the transfers
    counted)."""
    cell = small_cell()
    loop = harness.FwdBwd(cell, harness.Seeds.of(SEED), "cpu")
    assert past_residency(loop.scene)
    before, transfers = counts(), (TRANSFERS.host_syncs,
                                   TRANSFERS.htod_bytes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.step(0)
    added = {n: c - before[n] for n, c in counts().items()}
    spans = {}
    for e in prof.events():
        if e.name.startswith(EVENT_PREFIX):
            spans.setdefault(e.name[len(EVENT_PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    moved = (TRANSFERS.host_syncs - transfers[0],
             TRANSFERS.htod_bytes - transfers[1])
    loop.window_step()
    leaves = [n for n, _ in loop.leaves]
    (_, _), facts = loop.check(cell.spec["limits"])
    return leaves, facts, added, spans, moved


def test_bigmesh_config_is_the_programs_bigmesh():
    path = os.path.join(harness.ROOT, "benchmark", "configs", "bigmesh.json")
    with open(path) as fh:
        cfg = json.load(fh)
    arrays, static = scenes.build(cfg["scene"])
    sc = make_scene("bigmesh", device="cpu")
    for k in sc.leaves:
        np.testing.assert_array_equal(arrays[k], sc.leaf(k).numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(arrays["look_at"], sc.look_at.numpy())
    assert static["use_sky"] == sc.use_sky
    assert int((arrays["radius"] > 0).sum()) == cfg["spheres"]
    assert arrays["radius"].shape[0] == cfg["spheres_padded"]
    assert static["tri_n_real"] == cfg["triangles"]
    assert arrays["tris.v0"].shape[0] == cfg["triangles_padded"]
    # past the residency rule, so "fused" falls back to the probe route
    assert past_residency(sc)
    assert not resident_tables_fit(cfg["spheres_padded"],
                                   cfg["triangles_padded"])
    # the harness's orbit camera is the program's default camera
    pos, look_at = scenes.orbit(arrays["look_at"], static)
    cam = default_camera(sc)
    np.testing.assert_array_equal(pos, cam.position.numpy())
    np.testing.assert_array_equal(look_at, cam.look_at.numpy())


def test_probe_route_holds_to_the_reference(probe_step):
    leaves, facts, _, _, _ = probe_step
    numbers = facts["numbers"]
    assert facts["rays"] == facts["ref_rays"] > 0
    assert numbers["rays"] == 0.0
    assert numbers["image"] <= IMAGE_TOL
    assert numbers["grad_off"] <= GRAD_OFF_TOL
    # every scene leaf and the camera's two, each within its tolerance
    gaps = facts["leaf_gaps"]
    assert set(gaps) == set(leaves) and len(leaves) == 15
    assert max(gaps.values()) <= LEAF_TOL, gaps


def test_the_bf16_control_fails_every_tolerance():
    """calibrate.py's control (the reference in bfloat16 in the program's
    place) fails each of the tolerances above; control_chunked.py's, which
    takes the frame in chunks of pixels, reads as it does."""
    cell = small_cell()
    seeds = harness.Seeds.of(SEED + 1000)
    _, checks, facts = calibrate.control_fwdbwd(harness, reference, check,
                                                cell, seeds, "cpu")
    n = facts["numbers"]
    assert n["image"] > 100 * IMAGE_TOL
    assert n["rays"] > 0.0
    assert n["grad_off"] > 0.1
    assert max(facts["leaf_gaps"].values()) > 100 * LEAF_TOL

    # control_chunked.py's control on a smaller mesh: the same forward,
    # chunk by chunk, so the same image and rays; the gradients differ
    # only in the order the chunks' terms are added
    cell = small_cell(subdivisions=2)
    _, _, whole = calibrate.control_fwdbwd(harness, reference, check, cell,
                                           seeds, "cpu")
    (_, _), chunked = control_chunked.control_fwdbwd_chunked(
        harness, reference, cell, seeds, "cpu", chunk=50)
    n, m = whole["numbers"], chunked["numbers"]
    assert (m["image"], m["rays"]) == (n["image"], n["rays"])
    assert m["grad_off"] == pytest.approx(n["grad_off"], rel=0.05)


BIGMESH_LIMITS = harness.resolve("bigmesh-fwdbwd").spec["limits"]


@pytest.mark.parametrize("number", sorted(BIGMESH_LIMITS))
def test_the_cells_limits_hold_the_route(probe_step, number):
    """Each of bigmesh-fwdbwd's own limits, ``grad`` (the worst leaf, which
    sees a fault in the camera's two leaves or the glass sphere's that the
    share ``grad_off`` pooled over ~10^6 entries would not) among them,
    holds the probe route with ten times room or more."""
    _, facts, _, _, _ = probe_step
    assert facts["numbers"][number] * 10 <= BIGMESH_LIMITS[number]


def test_the_cells_grad_limit_refuses_the_bf16_control():
    cell = small_cell()
    cell.spec = dict(cell.spec, limits=BIGMESH_LIMITS)
    ok, checks, _ = calibrate.control_fwdbwd(
        harness, reference, check, cell, harness.Seeds.of(SEED + 1000),
        "cpu")
    assert not ok
    assert checks["grad"]["value"] > 7 * checks["grad"]["limit"]


def test_probe_route_opens_its_spans(probe_step):
    _, _, added, spans, moved = probe_step
    bounces = added["shade"]
    assert 1 <= bounces <= 5
    assert added["probe_tables"] == 1
    assert added["sphere_search"] == added["tri_search"] == bounces
    assert added["payload"] == 2 * bounces
    # a sort at the top of each bounce and the unsort at the end
    assert added["ray_sort"] == bounces + 1
    assert added["render_mean"] == 1
    # the regen route's stages stay shut on the probe route
    assert all(added[s] == 0 for s in ("regen_tables", "search_tables",
                                       "wave_init", "regen_forward",
                                       "regen_backward"))
    (lo, hi), = spans["render_mean"]
    for s in PROBE_SPANS:
        assert all(lo <= a <= b <= hi for a, b in spans[s]), s
    # the tables are built once, before the first sort
    assert spans["probe_tables"][0][1] <= min(a for a, _ in spans["ray_sort"])
    # CPU tensors are neither copied to nor read from a card
    assert moved == (0, 0)


def test_sky_color_makes_no_table_on_the_host(monkeypatch):
    """The probe route's sky (``ops/shade.sky_color``) fills its colours
    on the rays' device: a tensor made from a host list was a blocking
    copy to the card at every bounce that ``TRANSFERS`` did not count
    (on the card ``test_fwdbwd_counters_match_the_card[bigmesh-1]`` of
    ``test_torch_trace.py`` holds the count to sync-debug mode)."""
    g = torch.Generator().manual_seed(5)
    d = torch.nn.functional.normalize(
        torch.randn((257, 3), generator=g), dim=1)
    want = reference.sky_color(d)

    def no_host_table(*args, **kwargs):
        raise AssertionError("sky_color made a tensor from host data")
    monkeypatch.setattr(torch, "tensor", no_host_table)
    assert torch.equal(shade.sky_color(d), want)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_new_cells_resolve_and_name_the_programs_counters(name):
    cell = harness.resolve(name)
    assert cell.chips == 1 and cell.traffic["loop"] in harness.LOOPS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                     "peak_mem_gib"}
    for m in cell.end_to_end + cell.per_layer:
        mod = harness.load_reader(m["name"])
        assert callable(mod.read)
        for path in getattr(mod, "COUNTERS", ()):
            assert isinstance(harness.counter(path), int)
    for path in cell.spec["launches"]:
        assert isinstance(harness.counter(path), int)
    assert all(v > 0 for v in cell.spec["limits"].values())


# ---- the readers on hand-built readings ---------------------------------

LANES, ROWS = 1920 * 1080, 128 + 163968
K10 = ("tpu_ray_torch.kernels.tri_intersect:"
       "tri_nearest_hit_stream.launches")
K11 = "tpu_ray_torch.kernels.gather_rows:gather_rows_bwd.launches"


def reading(loop="fwdbwd", kernel_s=None, launches=None, steps=4,
            rays=5_161_301, traced=True):
    kw = {}
    if traced:
        kw = dict(trace=devtrace.TraceSummary(window_s=1.0, busy_s=0.7,
                                              kernel_s=dict(kernel_s or {})),
                  trace_steps=steps, trace_rays=[rays] * steps,
                  launches=dict(launches or {}))
    return harness.Reading(loop=loop, lanes=LANES, table_rows=ROWS,
                           setup_s=1.0, window_s=1.0, step_s=[0.2] * 4,
                           rays=[rays] * 4, peak_bytes=2 ** 30, **kw)


def test_kernel_readers_sum_their_kernels_a_step():
    kernels = {"tri_stream_kernel": 0.108, "gather_rows_down_kernel": 0.004,
               "gather_rows_hist_kernel": 0.002,
               "at::native::elementwise_kernel<128, 2>": 0.2,
               "at_cuda_detail::cub::DeviceRadixSortOnesweepKernel": 0.04,
               "indexing_backward_kernel_small_stride<float>": 0.036,
               "sphere_nearest_hit_kernel": 0.001, "Memset (Device)": 0.5}
    r = reading(kernel_s=kernels, launches={K10: 20, K11: 40})
    assert harness.load_reader("k10_ms").read(r) == pytest.approx(27.0)
    assert harness.load_reader("k11_ms").read(r) == pytest.approx(1.5)
    assert harness.load_reader("eager_ms").read(r) == pytest.approx(69.0)
    for name in ("k10_ms", "k11_ms", "eager_ms", "probe_ms"):
        mod = harness.load_reader(name)
        assert mod.read(reading(loop="pass", kernel_s=kernels,
                                launches={K10: 20, K11: 40})) is None
        assert mod.read(reading(traced=False)) is None
    # a counted kernel that did not launch in the stretch reads nothing
    assert harness.load_reader("k10_ms").read(
        reading(kernel_s=kernels, launches={K10: 0})) is None


def test_probe_ms_reads_its_spans_and_nothing_without_them(monkeypatch):
    mod = harness.load_reader("probe_ms")
    assert len(mod.COUNTERS) == len(PROBE_SPANS)
    # six stages, 2e6 ns each, over 4 steps: 3 ms a step
    got = mod.read(reading(launches={c: 2_000_000 for c in mod.COUNTERS}))
    assert got == pytest.approx(3.0)

    def missing(path):
        raise AttributeError(path)
    monkeypatch.setattr(harness, "counter", missing)
    bare = harness.load_reader("probe_ms")
    assert bare.COUNTERS == ()
    assert bare.read(reading()) is None
