"""Port parity of the public names: each subpackage of the JAX package
(and the package top) exports from ``tpu_ray_torch.<same>`` every name in
its ``__all__``, and each name resolves.

One stated exception: ``tpu_ray.kernels`` exports ``nearest_hit_pallas``,
the Pallas sphere search, a TPU mechanism; the port's contract for it is
K1, ``tpu_ray_torch.kernels.sphere_intersect.sphere_nearest_hit``.
``tpu_ray.oracle`` is ported like every other subpackage: its modules
import ``tpu_ray.core.scene``, which imports jax, and the card's machine
has no JAX, so the port keeps its own oracles (``tpu_ray_torch.oracle``),
and the oracle's case holds their ``__all__`` as it holds the others'.
"""
import importlib
import pkgutil

import pytest

import tpu_ray

SUBPACKAGES = [""] + sorted(m.name for m in pkgutil.iter_modules(
    tpu_ray.__path__) if m.ispkg)
# JAX name -> the port's counterpart ("module:name"), where they differ
RENAMED = {"kernels": {"nearest_hit_pallas":
                       "tpu_ray_torch.kernels.sphere_intersect:"
                       "sphere_nearest_hit"}}


def _module(pkg: str, sub: str):
    return importlib.import_module(f"{pkg}.{sub}" if sub else pkg)


def test_subpackages_listed():
    assert {"core", "grad", "kernels", "models", "ops", "parallel",
            "utils"} <= set(SUBPACKAGES)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_exports_jax_names(sub):
    jax_names = list(getattr(_module("tpu_ray", sub), "__all__", []))
    port = _module("tpu_ray_torch", sub)
    port_names = list(getattr(port, "__all__", []))
    renamed = RENAMED.get(sub, {})
    missing = [n for n in jax_names if n not in port_names
               and n not in renamed]
    assert not missing, f"tpu_ray_torch.{sub} lacks {missing}"
    for name in port_names:
        assert hasattr(port, name), f"tpu_ray_torch.{sub}.{name}"
    for name, where in renamed.items():
        assert name in jax_names
        mod, attr = where.split(":")
        assert callable(getattr(importlib.import_module(mod), attr))


def test_models_imports():
    from tpu_ray_torch.models import PathTracer, render_pass, trace_rays
    from tpu_ray_torch.models import path_tracer
    assert PathTracer is path_tracer.PathTracer
    assert trace_rays is path_tracer.trace_rays
    assert render_pass is path_tracer.render_pass
