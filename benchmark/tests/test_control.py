"""The control, the reference computed in bfloat16 in the program's place,
comes out not correct under every cell's limits (tiny size, CPU). On the
card it runs at each cell's own size through ``benchmark/calibrate.py``."""
import pytest

from benchmark import calibrate, check, harness, reference

WORKLOADS = ["rtweekend-fwdbwd", "trimesh-fwdbwd", "rtweekend-pass"]


@pytest.mark.parametrize("name", WORKLOADS)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12])
def test_control_fails(tiny_cell, name, seed):
    cell = tiny_cell(name)
    seeds = harness.Seeds.of(seed)
    if cell.traffic["loop"] == "fwdbwd":
        ok, checks, _ = calibrate.control_fwdbwd(harness, reference, check,
                                                 cell, seeds, "cpu")
    else:
        ok, checks, _ = calibrate.control_pass(harness, reference, check,
                                               cell, seeds, "cpu", 4)
    assert not ok
    assert any(c["value"] > 3 * c["limit"] for c in checks.values()), checks
