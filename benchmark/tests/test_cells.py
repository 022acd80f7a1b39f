"""Every cell resolves from its files, and BENCHMARK.json keeps to the
benchmark's contract."""
import json
import os
import re

import pytest

from benchmark import harness, scenes

SPEC = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["reduced"] == []
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(WORKLOADS)
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_resolves(name):
    cell = harness.resolve(name)
    assert cell.traffic["loop"] in harness.LOOPS
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
    arrays, static = scenes.build(cell.cfg["scene"])
    assert int((arrays["radius"] > 0).sum()) == cell.cfg["spheres"]
    n_tri = static["tri_n_real"]
    assert n_tri == cell.cfg["triangles"]
    assert set(cell.spec["limits"]) and set(cell.spec["launches"])
    for path in cell.spec["launches"]:
        assert path.startswith("tpu_ray_torch.")


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
             if f.endswith(".py")}
    metrics = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert files == metrics


def test_scenes_match_the_programs():
    """The harness's own scene builders give the program's scenes, bit for
    bit (the program is imported here by the test only)."""
    import numpy as np
    from tpu_ray_torch.core.scene import make_scene
    for kind in ("rtweekend", "trimesh"):
        arrays, static = scenes.build({"kind": kind})
        sc = make_scene(kind, device="cpu")
        for k in sc.leaves:
            np.testing.assert_array_equal(
                arrays[k], sc.leaf(k).numpy(), err_msg=f"{kind} {k}")
        np.testing.assert_array_equal(arrays["look_at"], sc.look_at.numpy())
        assert static["use_sky"] == sc.use_sky
