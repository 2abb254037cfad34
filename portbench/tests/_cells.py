"""The cells of ``BENCHMARK.json`` and their runners, for the tests."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def cells() -> list:
    """[(workload, runner name)] of every cell."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = []
    for w in bench["workloads"]:
        traffic = json.loads((ROOT / "portbench" / "traffic"
                              / f"{w['traffic']}.json").read_text())
        out.append((w["name"], traffic["runner"]))
    return out
