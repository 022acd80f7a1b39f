"""Share of the traced stretch in which no operation ran on the device
(%): 1 - (the union of device operation intervals) / (the stretch's wall
time)."""


def read(r):
    if r.loop != "pass" or r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
