"""K3, the regen backward (csrc/regen_bwd.cu regen_bwd_kernel and its
partial-sum launches, trt_sum_parts*), device ms a step over the traced
stretch."""
KERNELS = ("regen_bwd_kernel", "trt_sum_parts")
COUNTERS = ("tpu_ray_torch.kernels.regen:regen_bwd.launches",)


def read(r):
    if r.loop != "fwdbwd":
        return None
    s = r.kernel_seconds(KERNELS, COUNTERS)
    return None if s is None else 1e3 * s / r.trace_steps
