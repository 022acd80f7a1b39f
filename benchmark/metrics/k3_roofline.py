"""K3's share of its roofline (%): the least time of the traced
steps' K3 work (benchmark/roofline.py: 550 fp32 operations a ray cast,
the cotangent and table bytes once) over K3's device time there."""
from benchmark import roofline

KERNELS = ("regen_bwd_kernel", "trt_sum_parts")
COUNTERS = ("tpu_ray_torch.kernels.regen:regen_bwd.launches",)


def read(r):
    if r.loop != "fwdbwd":
        return None
    s = r.kernel_seconds(KERNELS, COUNTERS)
    if s is None:
        return None
    least = sum(roofline.k3_least_time(n, r.lanes, r.table_rows)
                for n in r.trace_rays)
    return 100.0 * least / s
