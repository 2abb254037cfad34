"""Metric logging: JSON lines, a latest-values summary and an HTML report.

Counterpart of ``deeppreconditioning_tpu/utils/logging.py`` with the same
files and record keys: ``metrics.jsonl`` (one ``{"step", "name",
"value", "time"}`` record per logged value, appended), ``metrics.json``
(the latest value of every series at each ``next_step``) and, on close,
``report.html`` (one inline-SVG line chart per series of this run).  The
trainer logs four series per epoch: train/loss/inverse, val/loss/inverse,
val/metric/durations and val/metric/iterations.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL metric logger with a latest-values summary."""

    def __init__(self, directory: Path | str) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._file = (self.directory / "metrics.jsonl").open("a")
        self.step = 0
        self._latest: dict = {}
        self._series: dict = {}  # name -> [(step, value)] (this run)

    def log_metric(self, name: str, value: float) -> None:
        record = {
            "step": self.step,
            "name": name,
            "value": float(value),
            "time": time.time(),
        }
        self._file.write(json.dumps(record) + "\n")
        self._latest[name] = float(value)
        self._series.setdefault(name, []).append(
            (self.step, float(value))
        )

    def next_step(self) -> None:
        self._file.flush()
        (self.directory / "metrics.json").write_text(
            json.dumps({"step": self.step, **self._latest}, indent=2)
        )
        self.step += 1

    def render_report(self) -> Path:
        """Write report.html: one inline-SVG line chart per series
        (this run only) — the dvclive HTML report analog."""
        w, h, pad = 480, 160, 34
        charts = []
        for name in sorted(self._series):
            pts = self._series[name]
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            x0, x1 = min(xs), max(xs) or 1
            y0, y1 = min(ys), max(ys)
            yr = (y1 - y0) or 1.0
            xr = (x1 - x0) or 1
            poly = " ".join(
                f"{pad + (x - x0) / xr * (w - 2 * pad):.1f},"
                f"{h - pad - (y - y0) / yr * (h - 2 * pad):.1f}"
                for x, y in pts
            )
            charts.append(
                f"<h3>{name}</h3>"
                f"<svg width='{w}' height='{h}' "
                f"style='background:#fafafa'>"
                f"<polyline points='{poly}' fill='none' "
                f"stroke='#1f77b4' stroke-width='1.5'/>"
                f"<text x='{pad}' y='12' font-size='10'>"
                f"max {y1:.4g}</text>"
                f"<text x='{pad}' y='{h - 4}' font-size='10'>"
                f"min {y0:.4g} · last {ys[-1]:.4g} · "
                f"{len(pts)} steps</text></svg>"
            )
        html = (
            "<!doctype html><meta charset='utf-8'>"
            "<title>metrics report</title>"
            "<body style='font-family:sans-serif'>"
            + "".join(charts) + "</body>"
        )
        out = self.directory / "report.html"
        out.write_text(html)
        return out

    def close(self) -> None:
        if self._series:
            self.render_report()
        self._file.close()
