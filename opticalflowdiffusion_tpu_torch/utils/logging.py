"""Run logger: scalar metrics as JSON lines (JAX ``utils/logging.py::RunLogger``
without its image dumps and wandb sink).

    out_dir/metrics.jsonl    one JSON object per log_dict call
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class RunLogger:
    def __init__(self, out_dir):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / "metrics.jsonl"

    def log_dict(self, metrics: Dict, step: int) -> dict:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        return record


__all__ = ["RunLogger"]
