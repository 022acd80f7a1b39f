from tpu_ray_torch.oracle.cpu_oracle import CpuOracle

__all__ = ["CpuOracle"]
