"""K11, the payload gathers' backward (csrc/gather_rows.cu: its sort's
hist, scan, scatter and iota kernels and its fold's down, up and top
kernels, all named gather_rows_*), device ms a step over the traced
stretch."""
KERNELS = ("gather_rows_",)
COUNTERS = ("tpu_ray_torch.kernels.gather_rows:gather_rows_bwd.launches",)


def read(r):
    if r.loop != "fwdbwd":
        return None
    s = r.kernel_seconds(KERNELS, COUNTERS)
    return None if s is None else 1e3 * s / r.trace_steps
