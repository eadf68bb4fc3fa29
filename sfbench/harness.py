"""The benchmark of the PyTorch port (`staticfusion_tpu_torch`): one cell
(a configuration under a traffic mix, named in BENCHMARK.json) run for a
window of `--seconds`, then checked against the frozen reference.

Everything that belongs to one configuration, traffic mix, per-layer
metric, span or probe is a file that this module finds by its name:
`configs/<config>.json` (through BENCHMARK.json's `file`),
`traffic/<traffic>.json`, `limits/<config>.json`, `metrics/<metric>.py`,
`spans/*.json` and `probes/*.py` (tracing.py).  A traffic file holds
exactly the keys of TRAFFIC_KEYS.

A run is one session in a closed loop: the next frame goes to
`SlamSystem.process` once the last frame's pose is on the host, and the
traffic's frames replay in time-reversed passes once the window outruns
them, so the motion never jumps.

1. set-up: renders the traffic's frames on the device from the seed
   (gen/adversarial.py) and copies them to host memory as the float32
   arrays that `SlamSystem.process` takes; bootstraps the session and
   warms it up on the traffic's first frames (the cell's own shapes);
2. the window: `SlamSystem.process` a frame, then the pose read to the
   host, until a frame completes past `--seconds` (with `--trace 1`, and
   at least `tail_frames` frames);
3. with `--trace 1`, after the window: `span_frames` frames with the
   synchronised spans on, then `trace_frames` frames under
   `torch.profiler` with the probes on; the trace is read after them;
4. the check: the bootstrap, `check_samples` frames drawn from the seed
   among the window's first `check_span`, the window's last frame,
   `tier_samples` drawn from the window's first four tier checks that
   repacked, and its first that archived, are judged against the
   reference (reference/compare.py) and held to the limits.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "staticfusion_tpu")
TRAFFIC_KEYS = {"profile", "frames", "frame_hz", "warmup_frames",
                "check_span", "check_samples", "tier_samples", "tail_frames",
                "span_frames", "trace_frames", "render_batch"}


class CellError(RuntimeError):
    pass


def _load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metric names,
    each found by name."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = root / "sfbench"
    traffic = _load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    if set(traffic) != TRAFFIC_KEYS:
        raise CellError(f"traffic {cell['traffic']!r}: keys "
                        f"{sorted(set(traffic) ^ TRAFFIC_KEYS)} differ from "
                        "the ones the harness reads")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]
    return {
        "cell": cell,
        "config": _load_json(root / config["file"]),
        "traffic": traffic,
        "limits": _load_json(bench_dir / "limits" / f"{cell['config']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def replay_index(k: int, n: int) -> int:
    """The frame handed over at step k: 0..n-1, then time-reversed
    passes back and forth, so the motion never jumps."""
    if n < 2:
        return 0
    p = k % (2 * n - 2)
    return p if p < n else 2 * n - 2 - p


def draw_picks(seed: int, traffic: dict) -> tuple:
    """(window frames, repacking tier checks) checked, by their index in
    the window, drawn from the seed."""
    rng = np.random.default_rng(seed)
    span = int(traffic["check_span"])
    frames = rng.choice(span, size=min(span, int(traffic["check_samples"])),
                        replace=False)
    tiers = rng.choice(4, size=min(4, int(traffic["tier_samples"])),
                       replace=False)
    return {int(x) for x in frames}, {int(x) for x in tiers}


class StepCapture:
    """Wraps the program's step functions as `SlamSystem` calls them, to
    keep the last call's input state and its (state, outputs) for the
    check.  It holds references only: the step never writes its input
    state, so nothing is copied."""

    def __init__(self, system_module):
        self.module = system_module
        self.saved = {}
        self.last = None

        def wrap(name):
            fn = getattr(system_module, name)
            self.saved[name] = fn

            def wrapper(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.last = (args[0], out)
                return out
            setattr(system_module, name, wrapper)
        wrap("slam_step")
        wrap("bootstrap_step")

    def close(self):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


class TierCapture:
    """Wraps `SlamSystem._maybe_resize_map` to keep, while `on`, the live
    map and the archive before and after the picked tier checks that
    replaced either (by their index among those that did) and the first
    that moved surfels to the archive, as references: a repack builds
    new maps and never writes the old ones."""

    def __init__(self, system_cls, picks: set):
        self.cls = system_cls
        self.saved = system_cls._maybe_resize_map
        self.on = False
        self.seen = 0
        self.archived = False
        self.samples = []
        saved = self.saved

        def wrapper(slam):
            before = (slam.state.smap, slam.archive)
            tick = slam.state.tick
            saved(slam)
            after = (slam.state.smap, slam.archive)
            if not self.on or (after[0] is before[0]
                               and after[1] is before[1]):
                return
            archived = after[1] is not before[1]
            if self.seen in picks or (archived and not self.archived):
                self.samples.append((tick, before, after))
                self.archived |= archived
            self.seen += 1
        system_cls._maybe_resize_map = wrapper

    def close(self):
        self.cls._maybe_resize_map = self.saved


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: Optional[float] = None, device: str = "cuda",
             overrides: Optional[dict] = None, root: Path = ROOT,
             control: bool = False) -> dict:
    """One run of a cell; returns the result line's object.  `device` and
    `overrides` (merged into the configuration's `sfconfig` and into the
    traffic) exist for the CPU rehearsals of the tests; the command always
    runs the cell as committed, on the card.  `control` adds every
    variant's numbers of the program and of the control on the same
    samples (`calibrate.py`; the command never runs it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from sfbench import tracing
    from sfbench.gen.adversarial import Camera, render_sequence
    from sfbench.reference import compare
    from staticfusion_tpu_torch.config import SFConfig
    from staticfusion_tpu_torch.pipeline import system as sf_system

    spec = load_cell(workload, root)
    overrides = overrides or {}
    sfconfig = _merge(spec["config"]["sfconfig"], overrides.get("config", {}))
    traffic = _merge(spec["traffic"], overrides.get("traffic", {}))
    limits = spec["limits"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # Set-up: the frames, from the seed, on the device; then the session.
    cam_cfg = compare.reference_config(sfconfig).camera
    cam = Camera(cam_cfg.width, cam_cfg.height, cam_cfg.fx, cam_cfg.fy,
                 cam_cfg.cx, cam_cfg.cy)
    n_frames = int(traffic["frames"])
    seq = render_sequence(traffic["profile"], n_frames, cam, seed, dev,
                          batch=int(traffic["render_batch"]))
    rgb, depth = seq.rgb, seq.depth_mm
    del seq
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    config = SFConfig.from_json(json.dumps(sfconfig))
    hz = float(traffic["frame_hz"])
    picks, tier_picks = draw_picks(seed, traffic)
    capture = StepCapture(sf_system)
    tiers = TierCapture(sf_system.SlamSystem, tier_picks)
    instruments = None
    traced = None
    latencies = []
    attempted = failed = 0
    try:
        slam = sf_system.SlamSystem(config, device=dev)
        samples = []
        k = 0
        for k in range(int(traffic["warmup_frames"])):
            i = replay_index(k, n_frames)
            out = slam.process(rgb[i], depth[i], k / hz)
            if out is not None:
                out.curr_pose.cpu()
                if not samples:
                    samples.append(compare.Sample(
                        "bootstrap", None,
                        (rgb[replay_index(0, n_frames)],
                         depth[replay_index(0, n_frames)], rgb[i], depth[i],
                         slam.initial_pose), capture.last[1]))
        if not samples:
            raise CellError("the warm-up never bootstrapped the session")

        def frame(record_as=None):
            """One closed-loop frame: (seconds, pose on the host)."""
            nonlocal k, attempted, failed
            k += 1
            i = replay_index(k, n_frames)
            before = slam.state
            attempted += 1
            t_a = time.perf_counter()
            if record_as is not None:
                with torch.profiler.record_function(record_as):
                    out = slam.process(rgb[i], depth[i], k / hz)
                    pose = out.curr_pose.cpu() if out is not None else None
            else:
                out = slam.process(rgb[i], depth[i], k / hz)
                pose = out.curr_pose.cpu() if out is not None else None
            dt = time.perf_counter() - t_a
            if pose is None or not bool(torch.all(torch.isfinite(pose))):
                failed += 1
            return dt, before, (rgb[i], depth[i])

        def keep(before, inputs):
            step_before, after = capture.last
            if step_before is not before:
                raise CellError("the captured step did not start from "
                                "the session's state")
            samples.append(compare.Sample("step", before, inputs, after))

        # The window.
        min_frames = int(traffic["tail_frames"]) if trace else 0
        tiers.on = True
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            w = len(latencies)
            dt, before, inputs = frame()
            latencies.append(dt)
            t_end = time.perf_counter()
            done = t_end - t0 >= seconds and len(latencies) >= min_frames
            if w in picks or done:
                keep(before, inputs)
            if done:
                break
        window_s = t_end - t0
        tiers.on = False
        memory_peak = (int(torch.cuda.max_memory_allocated(dev))
                       if cuda else 0)

        # With --trace 1: the spans' frames, then the profiled frames.
        if trace:
            instruments = tracing.Instruments(dev)
            instruments.mode = "time"
            for _ in range(int(traffic["span_frames"])):
                frame()
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            instruments.mode = "profile"
            with profile(activities=acts) as prof:
                for _ in range(int(traffic["trace_frames"])):
                    frame(tracing.FRAME_SPAN)
            instruments.mode = "off"
            traced = instruments.close()
            instruments = None
            tracing.summarize(prof, traced)
            del prof
            traced.frames_timed = int(traffic["span_frames"])
            traced.frame_seconds = list(latencies)
    finally:
        if instruments is not None:
            instruments.close()
        tiers.close()
        capture.close()
    tier_samples = [compare.TierSample(int(t), b, a)
                    for t, b, a in tiers.samples]
    tiers.samples = []
    del slam, out
    capture.last = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The check, once the window has closed and the session is freed.
    rows, tier, values = compare.judge(samples, tier_samples, sfconfig,
                                       dev, limits, detail=control)
    checks = {k: {"value": values[k], "limit": v}
              for k, v in compare.held_limits(limits).items()}
    correct = failed == 0 and compare.is_correct(values, limits)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": device_info}
    if not trace:
        e2e = {"fps": (len(latencies) / window_s, "frames/s"),
               "setup_s": (setup_s, "s")}
        for m in spec["end_to_end"]:
            value, unit = e2e[m["name"]]
            result["metrics"][m["name"]] = {"value": value, "unit": unit}
    else:
        names = [m["name"] for m in spec["per_layer"]]
        read = tracing.read_metrics(names, traced)
        for m in spec["per_layer"]:
            if read[m["name"]] is not None:
                result["metrics"][m["name"]] = {"value": read[m["name"]],
                                                "unit": m["unit"]}
        device_info["busy_s"] = traced.busy_s
        device_info["window_s"] = traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checked"] = compare.checked(rows, tier_samples)
    if control:
        result["rows"], result["tier"] = rows, tier
        result["control_rows"], _, result["control"] = compare.judge(
            samples, [], sfconfig, dev, limits, control=True, detail=True)
    result["checks"] = checks
    return result


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`staticfusion_tpu_torch` is not `staticfusion_tpu`)."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})
