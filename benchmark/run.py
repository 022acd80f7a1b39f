"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload rtweekend-fwdbwd --seed 7 \\
        --seconds 36 --trace 0

Measures the cell's loop on the card for ``--seconds`` after its set-up
and warm-up, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard
output (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics, from ``torch.profiler`` over a stretch of the window).
The numbers compared for ``correct`` end standard error, each beside its
limit. Exits non-zero, printing no result, where the card is missing, the
cell asks for more cards than there are, the program is not this
checkout's, or a module of JAX or of the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYCACHE = os.path.join(ROOT, ".pycache")

# Bytecode of every module the run imports is kept in the checkout, so that
# only a checkout's first run compiles it. Where the environment forbids
# bytecode (PYTHONDONTWRITEBYTECODE), ``import torch`` otherwise compiles its
# ~2,100 sources again in every run: about 1.5 s of CPU in a ~8 s set-up on
# an H100 host.
sys.dont_write_bytecode = False
sys.pycache_prefix = PYCACHE

import argparse  # noqa: E402
import json  # noqa: E402


def pin_cpus() -> None:
    """Hold the process, and every thread it starts, to two of its CPUs
    (the third and fourth it may use). A step's host part is most of its
    time, and left to move over the machine's cores the same runs spread
    three times as wide (trimesh fwd+bwd on an H100 host: rays/s over 4
    runs 9.5% apart free, 3.4% pinned; step p95 16% and 1.4%)."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        os.sched_setaffinity(0, cpus[2:4])


def open_card_early():
    """Create card 0's primary context (``cuInit``, then
    ``cuDevicePrimaryCtxRetain``) on a thread of its own while the main
    thread imports torch; torch's first call on the card then finds it
    made. That takes the 0.6-1.9 s it costs on an H100 host off the serial
    path of set-up, since the import keeps one CPU busy. Where there is no CUDA driver, this does nothing. -> the thread,
    or None."""
    import ctypes
    import threading
    try:
        drv = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None

    def work():
        dev, ctx = ctypes.c_int(), ctypes.c_void_p()
        if (drv.cuInit(0) == 0
                and drv.cuDeviceGet(ctypes.byref(dev), 0) == 0):
            drv.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)
    thread = threading.Thread(target=work, name="open-card", daemon=True)
    thread.start()
    return thread


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_cpus()
    sys.path.insert(0, ROOT)
    marks = {}

    def mark(name):
        marks[name] = (time.perf_counter() - T_PROCESS, time.process_time())
    mark("args")
    opening = open_card_early()
    import torch
    mark("import_torch")
    if opening is not None:
        opening.join()
    if not torch.cuda.is_available():
        print("run.py: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from benchmark import harness
    cell = harness.resolve(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    mark("cuda_context")
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_PROCESS, log=log, marks=marks)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"run.py: modules loaded that the benchmark must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    log("setup stages (s from start, wall/cpu): " + ", ".join(
        f"{k} {w:.3f}/{c:.3f}" for k, (w, c) in result["setup_stages"].items()))
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
