"""Metric logging: stdout + JSONL + CSV, the port's own copy of
``stil_tta_tpu/utils/logging.py:MetricLogger``."""

from __future__ import annotations

import csv
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional


class MetricLogger:
    """Appends each ``log`` call to ``<logdir>/metrics.jsonl`` and dumps
    summaries as one-row CSVs."""

    def __init__(self, logdir: os.PathLike, echo: bool = True):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.path = self.logdir / "metrics.jsonl"
        self.echo = echo
        self.latest: Dict[str, float] = {}

    def log(self, metrics: Dict[str, float], step: Optional[int] = None,
            prefix: str = "") -> None:
        record = {f"{prefix}{k}": (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}
        self.latest.update(record)
        record["_step"] = step
        record["_time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.echo:
            body = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                             else f"{k}: {v}" for k, v in record.items()
                             if not k.startswith("_"))
            print(f"[step {step}] {body}", flush=True)

    def dump_csv(self, filename: str,
                 metrics: Optional[Dict[str, float]] = None) -> Path:
        metrics = metrics if metrics is not None else self.latest
        out = self.logdir / filename
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(list(metrics.keys()))
            w.writerow([metrics[k] for k in metrics])
        return out
