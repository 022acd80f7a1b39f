"""Seconds from the process's start to the window's: imports, the
kernels' build or load, the scene, the warm-up steps."""


def read(r):
    return r.setup_s
