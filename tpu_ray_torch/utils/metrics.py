"""Step timing and JSONL metrics (port of the parts of
``tpu_ray/utils/metrics.py`` that the CLI's ``fit`` uses).

Every timing ends in ``torch.cuda.synchronize()`` when the work runs on
the card: PyTorch returns before the device finishes, so a host clock
without it measures the enqueue.
"""
from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-time a computation, device-synchronised on both edges."""

    @staticmethod
    def timed(fn, *args):
        """Run fn(*args) -> (result, seconds)."""
        _sync()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        return out, time.perf_counter() - t0


class MetricsLogger:
    """JSONL metrics stream: one JSON object per line."""

    def __init__(self, stream: Optional[IO] = None,
                 path: Optional[str] = None):
        self._own = open(path, "a") if path is not None else None
        self.stream = self._own or stream or sys.stdout

    def log(self, **record) -> dict:
        record.setdefault("ts", time.time())
        self.stream.write(json.dumps(record) + "\n")
        self.stream.flush()
        return record

    def close(self):
        if self._own is not None:
            self._own.close()
