"""Port parity, the CLI's progressive surface: ``render --checkpoint`` /
``--resume`` (a resumed render equal to the uninterrupted one, bit for
bit, with its rays carried over), ``--metrics`` (a ``log_pass`` line a
pass), ``--profile`` (a Chrome trace in the directory), ``animate``
(frames equal to the JAX CLI's on rgb at 32x16, 1 spp, 2 frames, the size
of tests/test_cli.py:43-55), and ``--mesh`` refused when the launch has
too few ranks. Backend "fused" runs the regen route (K2's plain version
here), the route the card's smoke run drives."""
import json
import os

import numpy as np
import pytest

from tpu_ray.cli import main as jmain

from tests.test_torch_threads import one_thread  # noqa: F401
from tpu_ray_torch.cli import main
from tpu_ray_torch.utils import load_checkpoint

BASE = ["--device", "cpu", "--scene", "rtweekend", "--width", "32",
        "--height", "24", "--spp", "1"]


def _render(tmp_path, name, *extra):
    out = tmp_path / f"{name}.png"
    assert main(["render", *BASE, "--out", str(out), *extra]) == 0
    return out


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_resume_equals_uninterrupted(tmp_path, backend):
    kw = ("--backend", backend)
    full = tmp_path / "full.npz"
    half = tmp_path / "half.npz"
    resumed = tmp_path / "resumed.npz"
    a = _render(tmp_path, "a", *kw, "--passes", "2", "--checkpoint",
                str(full))
    _render(tmp_path, "h", *kw, "--passes", "1", "--checkpoint", str(half))
    # scene, width, height and seed come from the file
    b = tmp_path / "b.png"
    assert main(["render", "--device", "cpu", "--scene", "rgb", "--width",
                 "8", "--spp", "1", *kw, "--resume", str(half), "--passes",
                 "1", "--out", str(b), "--checkpoint", str(resumed)]) == 0
    s_full, _, _, c_full, r_full = load_checkpoint(str(full), device="cpu")
    s_res, _, _, c_res, r_res = load_checkpoint(str(resumed), device="cpu")
    assert s_full.samples == s_res.samples == 2
    assert r_full == r_res > 0
    assert np.array_equal(s_full.mean.numpy(), s_res.mean.numpy())
    assert c_full == c_res and c_res.scene == "rtweekend"
    assert a.read_bytes() == b.read_bytes()


def test_metrics_and_profile(tmp_path):
    met = tmp_path / "m.jsonl"
    prof = tmp_path / "trace"
    _render(tmp_path, "m", "--backend", "fused", "--passes", "2",
            "--metrics", str(met), "--profile", str(prof))
    rows = [json.loads(line) for line in met.read_text().splitlines()]
    assert [r["render_pass"] for r in rows] == [0, 1]
    assert [r["samples"] for r in rows] == [1, 2]
    for r in rows:
        assert r["rays_cast"] >= 32 * 24 and r["seconds"] > 0
        assert r["rays_per_s"] == pytest.approx(
            r["rays_cast"] / r["seconds"], rel=1e-3)
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    trace = json.loads((prof / files[0]).read_text())
    assert trace["traceEvents"]


def test_animate_matches_jax_cli(tmp_path):
    args = ["animate", "--scene", "rgb", "--width", "32", "--height", "16",
            "--spp", "1", "--frames", "2"]
    mine, ref = tmp_path / "port", tmp_path / "jax"
    met = tmp_path / "a.jsonl"
    assert main([*args, "--device", "cpu", "--out-dir", str(mine),
                 "--metrics", str(met)]) == 0
    assert jmain([*args, "--out-dir", str(ref)]) == 0
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(ref)) == ["frame_0000.png",
                                                "frame_0001.png"]
    for n in names:
        assert (mine / n).read_bytes() == (ref / n).read_bytes(), n
    assert (mine / names[0]).read_bytes() != (mine / names[1]).read_bytes()
    rows = [json.loads(line) for line in met.read_text().splitlines()]
    assert [r["frame"] for r in rows] == [0, 1]
    assert all(r["rays_cast"] >= 32 * 16 for r in rows)


@pytest.mark.parametrize("spec", ["2", "1x2", "2x2x1", "x"])
def test_mesh_needs_the_launch_ranks(tmp_path, spec):
    with pytest.raises(SystemExit) as e:
        main(["render", *BASE, "--mesh", spec, "--out",
              str(tmp_path / "x.png")])
    assert "--mesh" in str(e.value)
