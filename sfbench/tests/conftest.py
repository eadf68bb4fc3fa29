"""The benchmark's own tests: on the CPU at 160x120, and, marked `card`,
on the card (`python -m pytest sfbench/tests -m card` on a machine with
one).  Whether there is a card is decided inside the `card` fixture,
never while a module is imported."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A cell at 160x120 with a short traffic: the CPU rehearsal's size.
SMALL = {"config": {"camera": {"width": 160, "height": 120},
                    "fusion": {"capacity": 1 << 16}},
         "traffic": {"frames": 16, "warmup_frames": 6, "check_span": 5,
                     "check_samples": 4, "tier_samples": 4,
                     "tail_frames": 4, "span_frames": 8, "trace_frames": 2,
                     "render_batch": 4}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda")


@pytest.fixture
def small():
    return SMALL
