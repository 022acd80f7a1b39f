"""K2 in recording mode (csrc/regen.cu: the culled sphere mode
regen_sph_kernel, the listed triangle mode regen_list_kernel, the sweeps
regen_steps_kernel), device ms a step over the traced stretch."""
KERNELS = ("regen_sph_kernel", "regen_list_kernel", "regen_steps_kernel")
COUNTERS = ("tpu_ray_torch.kernels.regen:regen_record.launches",)


def read(r):
    if r.loop != "fwdbwd":
        return None
    s = r.kernel_seconds(KERNELS, COUNTERS)
    return None if s is None else 1e3 * s / r.trace_steps
