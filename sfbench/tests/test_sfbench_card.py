"""On the card only (marked `card`): the control comes out not correct
at a cell's own size, on three seeds; and the command run in a directory
that holds only BENCHMARK.json and sfbench/ exits non-zero with no
result."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from sfbench import harness
from sfbench.reference import compare

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["qvga_f4.walk", "vga_f1_routed.walk"])
def test_control_is_not_correct(workload, card):
    limits = harness.load_cell(workload)["limits"]
    for seed in (31, 32, 2**31 + 33):
        r = harness.run_cell(workload, seed, 8.0, False, control=True)
        assert r["correct"] is True, r["checks"]
        assert not compare.is_correct(r["control"], limits), (
            seed, r["control"])


@pytest.mark.card
def test_command_needs_the_port(card, tmp_path):
    shutil.copytree(ROOT / "sfbench", tmp_path / "sfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "sfbench/run.py", "--workload", "qvga_f4.walk",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{"), lines[-1]
