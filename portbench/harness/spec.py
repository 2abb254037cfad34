"""What a run reads by name: the cell, its configuration, its traffic mix,
the runner the mix names and the readers of the cell's per-layer metrics.

``BENCHMARK.json`` names a cell's ``config`` and ``traffic``; the files
are ``portbench/configs/<config>.json`` and
``portbench/traffic/<traffic>.json``, and the mix's ``"runner"`` key names
``portbench/runners/<runner>.py``.  A per-layer metric ``<name>`` is read
by ``portbench/metrics/<name>.py``.  Adding any of them is adding a file
and an entry: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class CellSpec:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> CellSpec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    return CellSpec(
        name=workload, config_name=cell["config"],
        traffic_name=cell["traffic"], chips=int(cell["chips"]),
        config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def load_runner(name: str, bench_dir: Path = BENCH_DIR):
    return _load_module(bench_dir / "runners" / f"{name}.py",
                        f"portbench_runner_{name}")


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(view)`` of per-layer metric ``name``."""
    module = _load_module(bench_dir / "metrics" / f"{name}.py",
                          "portbench_metric_" + name.replace(".", "_"))
    return module.read
