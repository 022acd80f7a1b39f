"""K10, the probe route's streamed triangle search (csrc/tri_stream.cu
tri_stream_kernel, the one kernel ``trt_tri_stream`` launches), device ms
a step over the traced stretch."""
KERNELS = ("tri_stream_kernel",)
COUNTERS = ("tpu_ray_torch.kernels.tri_intersect:"
            "tri_nearest_hit_stream.launches",)


def read(r):
    if r.loop != "fwdbwd":
        return None
    s = r.kernel_seconds(KERNELS, COUNTERS)
    return None if s is None else 1e3 * s / r.trace_steps
