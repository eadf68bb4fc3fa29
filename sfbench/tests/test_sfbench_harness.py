"""The harness on the CPU at 160x120: every cell of BENCHMARK.json runs
through its logic; a cell, a traffic mix and a per-layer metric added as
files alone are found by name; the command refuses to run without a
card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sfbench import harness
from sfbench.reference import compare

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_rehearses_on_the_cpu(workload, small):
    r = harness.run_cell(workload, 2**31 + 17, 3.0, False, device="cpu",
                         overrides=small)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    spec = harness.load_cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(compare.held_limits(spec["limits"]))


def test_traced_run_reads_the_spans(small):
    r = harness.run_cell(CELLS[0], 5, 3.0, True, device="cpu",
                         overrides=small)
    assert r["correct"] is True
    # On the CPU the profiler sees no device: the device metrics read
    # nothing and are left out, the synchronised spans are read.
    assert "device.idle_share" not in r["metrics"]
    assert r["metrics"]["solver.ms_per_frame"]["value"] > 0
    assert r["metrics"]["fusion.ms_per_frame"]["value"] > 0
    # The window's tail is read only from 200 frames up.
    assert "frame_ms_p95.single" not in r["metrics"]
    assert set(r["device"]) >= {"busy_s", "window_s"}


def test_tail_reads_two_hundred_frames_or_nothing():
    from sfbench import tracing
    reader = tracing.load_file(
        ROOT / "sfbench/metrics/frame_ms_p95.single.py", "t_")
    trace = tracing.Trace(frame_seconds=[0.1] * 199)
    assert reader.read(trace) is None
    trace.frame_seconds = [0.1] * 190 + [0.3] * 10
    assert reader.read(trace) == pytest.approx(110.0)  # numpy's linear


def test_traffic_with_a_key_the_harness_does_not_read_is_refused(tmp_path):
    root = _copy_bench(tmp_path)
    path = root / "sfbench/traffic/walk.json"
    traffic = json.loads(path.read_text())
    traffic["sessions"] = 4
    path.write_text(json.dumps(traffic))
    with pytest.raises(harness.CellError, match="sessions"):
        harness.load_cell(CELLS[0], root)


def test_replay_runs_back_and_forth():
    order = [harness.replay_index(k, 4) for k in range(10)]
    assert order == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]


def _copy_bench(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "sfbench", root / "sfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_traffic_and_metric_are_files_alone(tmp_path, small):
    """A traffic mix, a cell and a per-layer metric added as new files
    and entries, with no edit to a file the harness already has, run in
    a copy of the benchmark."""
    root = _copy_bench(tmp_path)
    traffic = json.loads((root / "sfbench/traffic/walk.json").read_text())
    traffic.update(frames=12, warmup_frames=5)
    (root / "sfbench/traffic/throwaway.json").write_text(json.dumps(traffic))
    (root / "sfbench/metrics/driver.throwaway_frames.py").write_text(
        "def read(trace):\n    return float(trace.frames_timed)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qvga_f4.throwaway",
                               "config": "qvga_f4", "traffic": "throwaway",
                               "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({
        "name": "driver.throwaway_frames", "unit": "frames",
        "better": "higher", "source": "program_span",
        "layer": "driver (pipeline/system.py)", "moves": "fps",
        "workloads": ["qvga_f4.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "from sfbench import harness\n"
        f"assert harness.__file__.startswith({str(root)!r})\n"
        f"small = json.loads({json.dumps(json.dumps(small))})\n"
        "small['traffic'].pop('frames')\n"
        "for trace in (False, True):\n"
        "    r = harness.run_cell('qvga_f4.throwaway', 3, 3.0, trace,\n"
        "                         device='cpu', overrides=small)\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(l) for l in out.stdout.strip().splitlines())
    assert plain["correct"] and traced["correct"]
    assert "fps" in plain["metrics"]
    assert traced["metrics"]["driver.throwaway_frames"]["value"] >= 1


def test_command_without_a_card_prints_no_result():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "sfbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_is_refused():
    with pytest.raises(harness.CellError):
        harness.load_cell("no_such.cell")
