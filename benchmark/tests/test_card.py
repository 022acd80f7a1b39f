"""Each cell end to end on the card, with a short window: the result line
and ``correct``. Run on a machine with an NVIDIA GPU:
``python -m pytest -m cuda benchmark/tests/test_card.py``."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness

SPEC = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(2 ** 31 + 77), "--seconds", "3",
                        "--trace", str(trace)], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    want = {m["name"] for m in (SPEC["per_layer"] if trace
                                else SPEC["end_to_end"])
            if name in m.get("workloads", [name])}
    assert set(res["metrics"]) == want
