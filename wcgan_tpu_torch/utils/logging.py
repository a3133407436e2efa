"""Training logs: reference-parity log.txt lines + structured JSONL.

The port's own copy of ``wcgan_tpu/utils/logging.py`` (the same lines as
the original, tests/test_torch_imports.py compares them): one loss line
per epoch in ``output_dir/log.txt``, and a machine-readable
``metrics.jsonl`` (losses, imgs/sec, timings) alongside."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:

  def __init__(self, output_dir: str, echo: bool = True):
    os.makedirs(output_dir, exist_ok=True)
    self.log_path = os.path.join(output_dir, "log.txt")
    self.jsonl_path = os.path.join(output_dir, "metrics.jsonl")
    self.echo = echo

  def epoch_line(self, epoch: int, metrics: Dict[str, Any],
                 extra: Optional[str] = None) -> None:
    parts = "; ".join(f"{k} = {float(v):.5f}" for k, v in metrics.items())
    line = f"Epoch {epoch}: {parts}"
    if extra:
      line += f"; {extra}"
    with open(self.log_path, "a") as f:
      f.write(line + "\n")
    if self.echo:
      print(line, flush=True)

  def line(self, text: str) -> None:
    with open(self.log_path, "a") as f:
      f.write(text + "\n")
    if self.echo:
      print(text, flush=True)

  def jsonl(self, record: Dict[str, Any]) -> None:
    record = dict(record, ts=time.time())
    with open(self.jsonl_path, "a") as f:
      f.write(json.dumps(record) + "\n")
