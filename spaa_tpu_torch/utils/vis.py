"""Training-curve logging (counterpart of ``spaa_tpu/utils/vis.py``'s
``CurveLogger``): one JSON object per line, so a headless run keeps its
curves without a display server. The visdom plots wait for ROADMAP.md
queue A item 4."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class CurveLogger:
    """Appends ``{"step", "t", <scalars>}`` records to a JSONL file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def append(self, step: int, **scalars) -> None:
        if self._f:
            rec = {"step": int(step), "t": time.time()}
            rec.update({k: float(v) for k, v in scalars.items()})
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
