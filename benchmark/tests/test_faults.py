"""A whole run of a cell, the chip's look skipped, on the CPU at a tiny
size: ``correct`` comes out true as the program stands, and false with
the timed path broken underneath by each fault the cell can have. (One
card a cell: no exchange between cards to leave out.)"""
import pytest
import torch

from benchmark import harness

SEED = 2 ** 31 + 4242


def run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                            log=lambda m: None, require_route=False)


def fwdbwd_faults(monkeypatch, fault):
    from tpu_ray_torch.grad import render_grad
    from tpu_ray_torch.kernels import regen
    orig = render_grad.render_pixels
    if fault == "state_unchanged":      # the backward leaves every leaf
        def bwd(recs, d_out, cam, table, **kw):
            return (torch.zeros_like(d_out), torch.zeros_like(table),
                    torch.zeros(12))
        monkeypatch.setattr(regen, "regen_bwd", bwd)
    elif fault == "half_batch":         # half the samples, mean of the rest
        def half(*a, spp, **kw):
            c, r = orig(*a, spp=spp // 2, **kw)
            return c * (spp / (spp // 2)), r
        monkeypatch.setattr(render_grad, "render_pixels", half)
    elif fault == "answer_altered":     # one lane's colour where it is made
        def altered(*a, **kw):
            c, r = orig(*a, **kw)
            bump = torch.zeros_like(c)
            bump[0] = 1.0
            return c + bump, r
        monkeypatch.setattr(render_grad, "render_pixels", altered)


def pass_faults(monkeypatch, fault):
    from tpu_ray_torch.models import path_tracer
    orig = path_tracer.render_pass
    if fault == "state_unchanged":      # a pass that returns its state
        monkeypatch.setattr(path_tracer, "accumulate",
                            lambda state, batch_sum, k: state)
    elif fault == "half_batch":
        def half(*a, spp, **kw):
            img, r = orig(*a, spp=spp // 2, **kw)
            return img * (spp / (spp // 2)), r
        monkeypatch.setattr(path_tracer, "render_pass", half)
    elif fault == "answer_altered":
        def altered(*a, **kw):
            img, r = orig(*a, **kw)
            img = img.clone()
            img[0, 0] += 1.0
            return img, r
        monkeypatch.setattr(path_tracer, "render_pass", altered)


FAULTS = ["state_unchanged", "half_batch", "answer_altered"]


@pytest.mark.parametrize("name", ["rtweekend-fwdbwd", "rtweekend-pass"])
def test_sound_run_is_correct(tiny_cell, name):
    res = run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["rtweekend-fwdbwd", "trimesh-fwdbwd"])
def test_fwdbwd_fault_fails(tiny_cell, monkeypatch, name, fault):
    fwdbwd_faults(monkeypatch, fault)
    res = run(tiny_cell(name))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_pass_fault_fails(tiny_cell, monkeypatch, fault):
    pass_faults(monkeypatch, fault)
    res = run(tiny_cell("rtweekend-pass"))
    assert not res["correct"], res["checks"]
