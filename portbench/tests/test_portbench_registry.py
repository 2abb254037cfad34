"""A configuration, a traffic mix and a per-layer metric added as new
files and entries in a copy of the benchmark are found by name, with no
file of the copy edited."""

import json
import shutil
import time

from conftest import ROOT, TINY
from portbench.harness.loop import run_cell


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench_dir,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    before[tmp_path / "BENCHMARK.json"] = (
        tmp_path / "BENCHMARK.json").read_bytes()

    config = json.loads((bench_dir / "configs/sludge2d.json").read_text())
    config["name"] = "sludge2d-copy"
    (bench_dir / "configs/sludge2d-copy.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic/percase100.json").read_text())
    mix["cases"] = 2
    (bench_dir / "traffic/percase-two.json").write_text(json.dumps(mix))
    (bench_dir / "metrics/requests_traced.py").write_text(
        "def read(view):\n    return float(len(view.records))\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "sludge2d-copy", "source": "a copy", "reduced": [],
        "file": "portbench/configs/sludge2d-copy.json", "why": "test"})
    bench["workloads"].append({
        "name": "copy-cell", "config": "sludge2d-copy",
        "traffic": "percase-two", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "requests_traced", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "harness",
        "moves": "solves_per_s", "workloads": ["copy-cell"]})
    new_bench = json.dumps(bench)
    # only additions: every old byte of BENCHMARK.json's lists stays
    (tmp_path / "BENCHMARK.json").write_text(new_bench)

    sizes = {k: v for k, v in TINY["percase_learned"].items()
             if k != "cases"}
    res = run_cell("copy-cell", 11, 0.6, True, time.perf_counter(),
                   device="cpu", root=tmp_path, bench_dir=bench_dir,
                   sizes=sizes)
    assert res.line["correct"] is True
    assert res.line["metrics"]["requests_traced"]["value"] >= 1
    assert res.line["route"]["range_cases"] + res.line["route"][
        "generic_cases"] == 2
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path
