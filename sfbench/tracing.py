"""What a traced run (`--trace 1`) reads from the program, from outside.

* Spans (`spans/<name>.json`): a wrapper around one attribute of the
  program, named by `"target": "module:Attr.path"`.  In the span frames
  (mode "time", after the window) it synchronises the device before and
  after the call and records its seconds, and, with `"replaced":
  "<attr>"`, whether the call replaced that attribute of its first
  argument; in the profiled frames (mode "profile", after those) it only
  labels the host time it covers
  (`torch.profiler.record_function("sfbench.<name>")`).  A target that the
  program no longer has is left out, and the metrics that read the span
  read nothing.
* Probes (`probes/<name>.py`): a module with `TARGET` (as above),
  `record(args, kwargs, result) -> dict` and `finish(records, module)`,
  run around each call in the profiled sub-window.  `finish` turns what
  `record` kept (device tensors included) into plain numbers after the
  window, so no probe reads the device inside it.
* The profiler's trace of the profiled frames (`summarize`).

Per-layer metrics (`metrics/<name>.py`, `read(trace) -> float | None`)
read the `Trace` that these fill.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
import importlib.util
import json
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
FRAME_SPAN = "sfbench.frame"


@dataclasses.dataclass
class Trace:
    frames_profiled: int = 0   # frames in the profiled sub-window
    window_s: float = 0.0      # its length, first frame start to last end
    busy_s: float = 0.0        # union of device operations inside it
    kernels: int = 0           # device kernels (memcpy and memset apart)
    device_time: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    cpu_ops: Counter = dataclasses.field(default_factory=Counter)
    idle_gaps: Dict[str, float] = dataclasses.field(default_factory=dict)
    frames_timed: int = 0      # the span frames (spans synchronised)
    # Each frame's seconds in the window, nothing instrumented.
    frame_seconds: list = dataclasses.field(default_factory=list)
    spans: Dict[str, list] = dataclasses.field(default_factory=dict)
    probes: Dict[str, list] = dataclasses.field(default_factory=dict)

    def breakdown(self) -> dict:
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.device_time),
                "idle_gaps": top(self.idle_gaps)}


def _resolve(target: str):
    """(owner, attribute name) of "module:Attr.path", or None when the
    program has no such attribute."""
    mod_name, _, path = target.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError:
        return None
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    return (owner, attr) if hasattr(owner, attr) else None


def load_file(path: Path, prefix: str):
    """The module in `path` (a probe or a metric reader, found by name)."""
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Instruments:
    """The spans and probes of a traced run, installed for its window and
    removed after it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.mode = "off"  # "profile", "time" or "off"
        self.trace = Trace()
        self._saved = []
        self._finish = []
        for f in sorted((HERE / "spans").glob("*.json")):
            self._span(f.stem, json.loads(f.read_text()))
        for f in sorted((HERE / "probes").glob("*.py")):
            self._probe(f.stem, load_file(f, "sfbench_probe_"))

    def _patch(self, target: str, make) -> bool:
        found = _resolve(target)
        if found is None:
            return False
        owner, attr = found
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, functools.wraps(orig)(make(orig)))
        return True

    def _span(self, name: str, spec: dict) -> None:
        label = f"sfbench.{name}"
        replaced = spec.get("replaced")
        records = []

        def make(fn):
            def wrapper(*args, **kwargs):
                if self.mode == "profile":
                    with torch.profiler.record_function(label):
                        return fn(*args, **kwargs)
                if self.mode != "time":
                    return fn(*args, **kwargs)
                before = getattr(args[0], replaced) if replaced else None
                _sync(self.device)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                _sync(self.device)
                records.append((time.perf_counter() - t0,
                                replaced is not None
                                and getattr(args[0], replaced) is not before))
                return out
            return wrapper
        if self._patch(spec["target"], make):
            self.trace.spans[name] = records

    def _probe(self, name: str, mod) -> None:
        records = []

        def make(fn):
            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.mode == "profile":
                    records.append(mod.record(args, kwargs, out))
                return out
            return wrapper
        if self._patch(mod.TARGET, make):
            self._finish.append((name, mod, records))

    def close(self) -> Trace:
        """Remove every wrapper and resolve the probes' records."""
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved = []
        for name, mod, records in self._finish:
            module = importlib.import_module(mod.TARGET.partition(":")[0])
            self.trace.probes[name] = mod.finish(records, module)
        return self.trace


def _intervals_union(iv: List[tuple]) -> List[tuple]:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(prof, trace: Trace) -> None:
    """Fill `trace` from the profiler's events of the sub-window: the
    window (first frame span's start to the last one's end), the union
    of device operations inside it, kernels by name, CPU operations by
    name, and the idle gaps labelled by what the host ran when the device
    went idle (the innermost sfbench span and the outermost aten
    operation at the gap's start)."""
    from torch.autograd import DeviceType
    events = prof.events()
    cpu, dev = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            cpu.append(e)
        elif not e.name.startswith("sfbench."):
            # (the device-side copies of the spans' record_function ranges
            # are annotations, not operations)
            dev.append(e)
    frames = [(e.time_range.start, e.time_range.end) for e in cpu
              if e.name == FRAME_SPAN]
    if not frames or not dev:
        return
    w0, w1 = min(f[0] for f in frames), max(f[1] for f in frames)
    trace.frames_profiled = len(frames)
    trace.window_s = (w1 - w0) * 1e-6
    iv = []
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        iv.append((s, t))
        if not e.name.startswith(("Memcpy", "Memset")):
            trace.kernels += 1
        trace.device_time[e.name] = (trace.device_time.get(e.name, 0.0)
                                     + (e.time_range.end
                                        - e.time_range.start) * 1e-6)
        trace.device_count[e.name] = trace.device_count.get(e.name, 0) + 1
    busy = _intervals_union(iv)
    trace.busy_s = sum(t - s for s, t in busy) * 1e-6
    in_window = [e for e in cpu if w0 <= e.time_range.start <= w1]
    trace.cpu_ops = Counter(e.name for e in in_window)
    # Host activity at each gap's start: the innermost sfbench span (they
    # do not overlap one another) and the outermost aten operation.
    def table(keep):
        rows = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in in_window if keep(e))
        return rows, [r[0] for r in rows]

    def covering(rows, starts, t, default):
        i = bisect.bisect_right(starts, t) - 1
        return rows[i][2] if i >= 0 and rows[i][1] >= t else default

    spans, span_starts = table(lambda e: e.name.startswith("sfbench.")
                               and e.name != FRAME_SPAN)
    aten, aten_starts = table(
        lambda e: e.name.startswith("aten::")
        and not (e.cpu_parent is not None
                 and e.cpu_parent.name.startswith("aten::")))
    gaps: Dict[str, float] = {}
    prev = w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            span = covering(spans, span_starts, prev, "sfbench.frame")
            op = covering(aten, aten_starts, prev, "python")
            key = f"{span[len('sfbench.'):]}/{op}"
            gaps[key] = gaps.get(key, 0.0) + (s - prev) * 1e-6
        prev = max(prev, t)
    trace.idle_gaps = gaps


def read_metrics(names, trace: Trace) -> Dict[str, Optional[float]]:
    """Each per-layer metric by its reader `metrics/<name>.py`; None where
    the reader finds nothing to read (or there is no reader)."""
    out = {}
    for name in names:
        path = HERE / "metrics" / f"{name}.py"
        out[name] = (load_file(path, "sfbench_metric_").read(trace)
                     if path.exists() else None)
    return out
