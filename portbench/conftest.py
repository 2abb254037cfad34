"""Settings of the benchmark's tests beside ``tests/conftest.py``: the tiny
CPU sizes of the runners added after its ``TINY``, merged into it before
each test (the tests read ``TINY[runner]`` by the runner's name)."""

import sys

import pytest

TINY_ADDED = {
    "structured_sequence": {"grid": [12, 12, 12], "fields": 2,
                            "sequence": 2, "sample_within": 6,
                            "sample_requests": 2, "trace_start_s": 0.2,
                            "trace_slice_s": 0.3},
}


@pytest.fixture(autouse=True)
def tiny_sizes_of_added_runners():
    tiny = getattr(sys.modules.get("conftest"), "TINY", None)
    if tiny is not None:
        for runner, sizes in TINY_ADDED.items():
            tiny.setdefault(runner, sizes)
    yield
