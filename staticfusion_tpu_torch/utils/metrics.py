"""Structured per-frame metrics: JSONL logging + timing aggregation (port
of staticfusion_tpu/utils/metrics.py).

The reference's observability is printf + GUI panels (SURVEY.md section 5);
here every frame emits a JSON record and the run ends with an aggregate
summary.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self._f: Optional[IO] = open(path, "w") if path else None
        self.echo = echo
        self.records = []

    def log(self, **fields):
        rec = {"t_wall": time.time(), **fields}
        self.records.append(rec)
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)

    def summary(self) -> dict:
        if not self.records:
            return {}
        keys = [k for k, v in self.records[-1].items()
                if isinstance(v, (int, float)) and k != "t_wall"]
        out = {}
        for k in keys:
            vals = [r[k] for r in self.records if k in r
                    and isinstance(r[k], (int, float))]
            if vals:
                out[k] = {"mean": sum(vals) / len(vals),
                          "last": vals[-1], "n": len(vals)}
        return out

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class StageTimer:
    """Wall-clock stage timer (the reference's dead CTicTac, done right).
    When CUDA is in use the current stream is synchronised on entering and
    leaving a stage, so a stage's time covers its device work."""

    def __init__(self):
        self.acc = {}

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                _sync()
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                _sync()
                timer.acc.setdefault(name, []).append(
                    time.perf_counter() - self.t0)

        return _Ctx()

    def means(self) -> dict:
        return {k: sum(v) / len(v) for k, v in self.acc.items()}
