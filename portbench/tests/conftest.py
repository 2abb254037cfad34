"""Settings of the benchmark's own tests (``portbench/tests``): the repo
root on the path, the ``cuda`` marker, and tiny sizes per runner."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Per runner, the overrides that make a cell tiny enough for the CPU.
TINY = {
    "percase_learned": {"cases": 3, "sample_within": 3, "sample_requests": 2,
                        "trace_start_s": 0.2, "trace_slice_s": 0.3},
    "batched_learned": {"cases": 3, "sample_within": 2, "sample_requests": 1,
                        "trace_start_s": 0.2, "trace_slice_s": 0.3},
    "train_fsai": {"cases": 8, "mesh_cells": 1, "n_pad": 256,
                   "batch_size": 2, "pcg_steps": 3, "trace_start_s": 0.2,
                   "trace_slice_s": 0.3},
    "structured_learned": {"grid": [12, 12, 12], "fields": 2,
                           "sample_within": 3, "sample_requests": 2,
                           "trace_start_s": 0.2, "trace_slice_s": 0.3},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (the PyTorch port's kernels); "
        "skips without one",
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
