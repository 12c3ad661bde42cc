"""Training callbacks that use no framework.

For now the metric sink of mapping_tpu/train/callbacks.py (`MetricSink`),
copied, so that the port's `metrics.jsonl` gets the JAX package's lines.
The callbacks that touch a framework are ROADMAP item 11.
"""

import json
import logging
import os
import time
from typing import Optional

logger = logging.getLogger(__name__)


class MetricSink:
    """stdout + optional JSONL channel sink (neptune send_metric analog)."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.jsonl_path = jsonl_path

    def send(self, channel: str, x: float, y: float):
        if self.jsonl_path:
            # lazy dir creation: constructing a manager (e.g. `--help`)
            # should not scaffold experiment directories
            os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps({"channel": channel, "x": float(x),
                                    "y": float(y), "ts": time.time()}) + "\n")

    def send_metric(self, name: str, value: float):
        logger.info("metric %s = %s", name, value)
        self.send(name, 0, value)
