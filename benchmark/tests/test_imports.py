"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole), and the reference loads nothing of the program."""
import os
import subprocess
import sys

from benchmark import harness

ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _py(code: str, timeout=300):
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          env=ENV, capture_output=True, text=True,
                          timeout=timeout)


def test_names_are_compared_whole():
    mods = ["tpu_ray_torch", "tpu_ray_torch.kernels", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "tpu_ray"]) == [
        "jax", "tpu_ray"]


def test_reference_imports_nothing_of_the_program():
    p = _py("import sys; from benchmark import reference, scenes, check, "
            "stats, roofline, devtrace; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tpu_ray_torch', 'tpu_ray', 'jax', 'jaxlib', 'flax'}))")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_dry_run_loads_no_jax():
    p = _py("import sys, torch; torch.set_num_threads(2)\n"
            "from benchmark import harness\n"
            "for name in ('rtweekend-fwdbwd', 'rtweekend-pass'):\n"
            "    c = harness.resolve(name)\n"
            "    c.traffic['render'] = {'width': 16, 'height': 9, 'spp': 1}\n"
            "    c.traffic['check_pixels'] = 16\n"
            "    r = harness.run_cell(c, 5, 0.2, False, device='cpu',\n"
            "                         log=lambda m: None,\n"
            "                         require_route=False)\n"
            "    assert r['correct'], r\n"
            "print(harness.forbidden_modules(list(sys.modules)))")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "rtweekend-fwdbwd", "--seed", "1", "--seconds", "1"],
                       cwd=harness.ROOT, env=ENV, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
