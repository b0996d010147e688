"""Run metrics: JSONL event log + optional TensorBoard (copy of
``tpubody.utils.metrics``: pure Python; the port imports nothing of
``tpubody``).

The reference's observability is bare prints and an unused
``--summary_folder`` TensorBoard flag (smpl_config.py:70-71,
SURVEY.md §5).  This gives pipelines and training loops a real sink:
every ``log()`` appends one JSON line (machine-readable, append-only,
crash-safe) and mirrors scalars to TensorBoard when ``tb_dir`` is set
(tensorboardX, optional import).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only metrics sink.

    >>> m = MetricsLogger("out/metrics.jsonl")
    >>> m.log("train", step=10, loss=0.5)
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 tb_dir: Optional[str] = None):
        self._path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
        self._tb = None
        if tb_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(tb_dir)
            except Exception:
                self._tb = None
        self._t0 = time.time()

    def log(self, tag: str, step: Optional[int] = None,
            **scalars: Any) -> Dict[str, Any]:
        rec = {"tag": tag, "t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._tb is not None and step is not None:
            for k, v in rec.items():
                if k not in ("tag", "t", "step") and isinstance(v, float):
                    self._tb.add_scalar(f"{tag}/{k}", v, step)
        return rec

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str):
    """Load a metrics JSONL file back into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
