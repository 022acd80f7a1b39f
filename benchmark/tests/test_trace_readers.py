"""The route's readers (route_ms, host_syncs, htod_mib) on hand-built
readings: None without a trace or in the other loop, the counters' deltas
divided by the traced steps, and nothing (no error) where the program
lacks the counters."""
import pytest

from benchmark import devtrace, harness

NAMES = ("route_ms", "host_syncs", "htod_mib")
LOOPS = {"fwdbwd": "fwdbwd", "fwd": "pass"}


def reading(loop, traced=True, launches=None, steps=4):
    kw = {}
    if traced:
        kw = dict(trace=devtrace.TraceSummary(window_s=1.0, busy_s=0.8,
                                              kernel_s={}),
                  trace_steps=steps, trace_rays=[100] * steps,
                  launches=dict(launches or {}))
    return harness.Reading(loop=loop, lanes=100, table_rows=10, setup_s=1.0,
                           window_s=1.0, step_s=[0.25] * 4, rays=[100] * 4,
                           peak_bytes=2 ** 30, **kw)


def counts(mod, each: int):
    return {c: each for c in mod.COUNTERS}


@pytest.mark.parametrize("suffix", sorted(LOOPS))
@pytest.mark.parametrize("name", NAMES)
def test_none_without_a_trace_or_in_the_other_loop(name, suffix):
    mod = harness.load_reader(f"{name}.{suffix}")
    loop = LOOPS[suffix]
    other = "pass" if loop == "fwdbwd" else "fwdbwd"
    assert mod.read(reading(loop, traced=False)) is None
    assert mod.read(reading(other, launches=counts(mod, 8))) is None


@pytest.mark.parametrize("suffix", sorted(LOOPS))
def test_each_reading_divides_by_the_traced_steps(suffix):
    loop = LOOPS[suffix]
    route = harness.load_reader(f"route_ms.{suffix}")
    # seven stages, 3e6 ns each, over 4 steps: 5.25 ms a step
    assert len(route.COUNTERS) == 7
    assert route.read(reading(loop, launches=counts(route, 3_000_000))) == (
        pytest.approx(5.25))
    syncs = harness.load_reader(f"host_syncs.{suffix}")
    assert syncs.read(reading(loop, launches=counts(syncs, 52))) == 13
    htod = harness.load_reader(f"htod_mib.{suffix}")
    got = htod.read(reading(loop, launches=counts(htod, 4 * 3 * 2 ** 20)))
    assert got == pytest.approx(3.0)
    # a traced stretch with nothing counted reads 0, not None
    assert syncs.read(reading(loop, launches=counts(syncs, 0))) == 0


@pytest.mark.parametrize("name", [f"{n}.{s}" for n in NAMES for s in LOOPS])
def test_a_program_without_the_counters_reads_nothing(name, monkeypatch):
    """The parent of the change that added the spans has neither
    ``SPANS`` nor ``TRANSFERS``: the reader then asks for no counter and
    reads None from a traced run."""
    def missing(path):
        raise AttributeError(path)
    monkeypatch.setattr(harness, "counter", missing)
    mod = harness.load_reader(name)
    assert mod.COUNTERS == ()
    assert mod.read(reading(LOOPS[name.split(".")[1]])) is None
