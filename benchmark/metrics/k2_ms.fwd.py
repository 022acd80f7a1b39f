"""K2 forward (csrc/regen.cu), device ms a progressive pass over the
traced stretch."""
KERNELS = ("regen_sph_kernel", "regen_list_kernel", "regen_steps_kernel")
COUNTERS = ("tpu_ray_torch.kernels.regen:regen_steps.launches",)


def read(r):
    if r.loop != "pass":
        return None
    s = r.kernel_seconds(KERNELS, COUNTERS)
    return None if s is None else 1e3 * s / r.trace_steps
