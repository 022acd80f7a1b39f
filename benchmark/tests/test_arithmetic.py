"""The rate, tail, idle and roofline arithmetic, on synthetic inputs."""
import math

import pytest

from benchmark import devtrace, harness, roofline, stats


def reading(step_s, rays, **kw):
    return harness.Reading(loop="fwdbwd", lanes=100, table_rows=10,
                           setup_s=1.0, window_s=sum(step_s), step_s=step_s,
                           rays=rays, peak_bytes=2 ** 30, **kw)


def read(name, r):
    return harness.load_reader(name).read(r)


def test_rate_and_tail_of_steady_steps():
    r = reading([0.1] * 200, [1000] * 200)
    assert read("fwdbwd_rays_per_s", r) == pytest.approx(10000.0)
    assert read("step_ms_p95", r) == pytest.approx(100.0)
    assert read("peak_mem_gib", r) == 1.0
    assert read("fwd_rays_per_s", r) is None


def test_a_stall_moves_the_rate_and_the_tail():
    steady = [0.1] * 200
    stalled = [0.1] * 180 + [0.5] * 20
    a = reading(steady, [1000] * 200)
    b = reading(stalled, [1000] * 200)
    assert read("fwdbwd_rays_per_s", b) < 0.75 * read("fwdbwd_rays_per_s", a)
    assert read("step_ms_p95", b) == pytest.approx(500.0)
    # one slow step in 200 stays below the 95th percentile
    c = reading([0.1] * 199 + [0.5], [1000] * 200)
    assert read("step_ms_p95", c) == pytest.approx(100.0)


def test_percentile():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert devtrace.union_length(iv) == 4
    assert devtrace.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert devtrace.gaps([], 1, 2) == [(1, 2)]


def _events():
    k = lambda name, ts, dur: dict(ph="X", cat="kernel", name=name, ts=ts,
                                   dur=dur)
    h = lambda name, ts, dur, cat="cpu_op": dict(ph="X", cat=cat, name=name,
                                                 ts=ts, dur=dur)
    return [h("bench.step", 0, 500, "user_annotation"),
            h("bench.step", 500, 500, "user_annotation"),
            h("bench.backward", 600, 340, "user_annotation"),
            h("aten::item", 100, 150),
            k("void (anonymous namespace)::regen_bwd_kernel<64, 8, true>"
              "(float*, int)", 300, 100),
            k("trt_sum_parts(float const*)", 400, 10),
            k("regen_sph_kernel<true>(float*)", 0, 100),
            k("regen_sph_kernel<true>(float*)", 700, 200),
            dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=950,
                 dur=50)]


def test_summary_of_a_trace():
    ev = _events()
    lo, hi = devtrace.span_bounds(ev, "bench.step")
    s = devtrace.summarize(ev, lo, hi)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(460e-6)
    assert s.seconds(("regen_sph_kernel",)) == pytest.approx(300e-6)
    assert s.seconds(("regen_bwd_kernel", "trt_sum_parts")) == \
        pytest.approx(110e-6)
    assert s.device_ops()[0] == ["regen_sph_kernel<true>", pytest.approx(3e-4)]
    # named by the host's state halfway through each gap
    assert s.idle_gaps[0] == ["bench.step", pytest.approx(290e-6)]
    assert s.idle_gaps[1] == ["bench.step > aten::item",
                              pytest.approx(200e-6)]
    assert s.idle_gaps[2] == ["bench.backward", pytest.approx(50e-6)]
    r = reading([1e-3], [100], trace=s, trace_steps=2, trace_rays=[50, 50],
                launches={"m:regen_bwd.launches": 2,
                          "m:regen_record.launches": 2})
    assert read("device_idle.fwdbwd", r) == pytest.approx(54.0)
    assert harness.Reading.kernel_seconds(
        r, ("regen_bwd_kernel", "trt_sum_parts"),
        ("m:regen_bwd.launches",)) == pytest.approx(110e-6)


def test_a_launched_kernel_missing_from_the_trace_fails():
    s = devtrace.TraceSummary(window_s=1.0, busy_s=0.5,
                              kernel_s={"other": 0.5})
    r = reading([1.0], [10], trace=s, trace_steps=1, trace_rays=[10],
                launches={"tpu_ray_torch.kernels.regen:regen_bwd.launches": 1})
    with pytest.raises(harness.MissingKernel):
        read("k3_ms", r)
    with pytest.raises(harness.MissingKernel):
        read("k3_roofline", r)
    # nothing launched: nothing to read, and no zero
    r.launches = {"tpu_ray_torch.kernels.regen:regen_bwd.launches": 0}
    assert read("k3_ms", r) is None


def test_k3_count_and_share():
    flops, nbytes = roofline.k3_work(rays=280_296_360, lanes=2_073_600,
                                     table_rows=512)
    assert flops == 550 * 280_296_360
    assert nbytes == 36 * 2_073_600 + 96 * 512 + 100
    assert roofline.k3_least_time(280_296_360, 2_073_600, 512) == \
        pytest.approx(flops / 67e12)
    # trimesh: still bound by operations
    t = roofline.k3_least_time(10_321_001, 2_073_600, 128 + 10_368)
    assert t == pytest.approx(550 * 10_321_001 / 67e12)
    s = devtrace.TraceSummary(window_s=1.0, busy_s=0.5,
                              kernel_s={"regen_bwd_kernel<64>": 2 * 0.0337})
    r = reading([1.0], [1], trace=s, trace_steps=2,
                trace_rays=[280_296_360] * 2,
                launches={"tpu_ray_torch.kernels.regen:regen_bwd.launches": 2})
    r.lanes, r.table_rows = 2_073_600, 512
    share = read("k3_roofline", r)
    assert share == pytest.approx(100 * flops / 67e12 / 0.0337)
    assert 0 < share < 100
    assert read("k3_ms", r) == pytest.approx(33.7)


def test_seeds_are_fixed_by_the_seed():
    a, b = harness.Seeds.of(2 ** 31 + 7), harness.Seeds.of(2 ** 31 + 7)
    assert a == b and a != harness.Seeds.of(2 ** 31 + 8)
    assert all(0 <= v < 2 ** 32 for v in (a.render, a.target, a.pick))
    assert math.isfinite(harness.Seeds.of(-5).render)
