"""PyTorch's own kernels, device ms a step over the traced stretch: every
kernel whose name holds ``at::native`` (elementwise, index, reduce and
gather kernels), ``at_cuda_detail`` (its cub sorts and scans) or
``indexing_backward_kernel`` (the backward of an index, whose name the
profiler records with no namespace). On the probe route that is the
eager bounce loop's glue and its autograd backward, beside the
hand-written K1, K10 and K11."""
KERNELS = ("at::native", "at_cuda_detail", "indexing_backward_kernel")


def read(r):
    if r.loop != "fwdbwd" or r.trace is None or not r.trace_steps:
        return None
    return 1e3 * r.trace.seconds(KERNELS) / r.trace_steps
