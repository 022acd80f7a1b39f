"""The benchmark of the PyTorch / CUDA port (``tpu_ray_torch``): one cell
a run, ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (see ``run.py`` and ``harness.py``)."""
