"""The benchmark's own tests: the harness, the reference and the program's
package on the import path, and a fixture that finds the card."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (HERE, BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 exists only there")
    return "cuda"


def tiny(cell, batch: int = 6):
    """``cell`` cut to a size the CPU runs in seconds, every lane checked."""
    cell.traffic = dict(cell.traffic, batch=batch, warmup_ticks=3,
                        check_lanes=batch, check_tick_below=3, trace_ticks=2,
                        gap_ticks=1, sync_ticks=1)
    return cell
