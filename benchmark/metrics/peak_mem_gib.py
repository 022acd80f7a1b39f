"""Peak device memory allocated over the window (GiB), counted from a
reset at its start."""


def read(r):
    return r.peak_bytes / 2 ** 30 if r.peak_bytes else None
