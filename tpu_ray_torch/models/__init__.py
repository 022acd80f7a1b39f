from tpu_ray_torch.models.path_tracer import PathTracer, trace_rays, render_pass

__all__ = ["PathTracer", "trace_rays", "render_pass"]
