"""Run logs: stdout plus a per-run logfile, an append-only metrics.jsonl
and the config snapshot.

Counterpart of parsenet_tpu/core/logging.py (reference train_parsenet.py:
37-60), without the TensorBoard writer: the metrics live in the jsonl.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict


def setup_logging(log_dir: str, name: str) -> logging.Logger:
    """The package logger, to stdout and {log_dir}/logs/{name}.log. A
    later call with another log_dir or name moves the file handler there
    (the previous file is closed); stdout keeps one handler."""
    os.makedirs(f"{log_dir}/logs", exist_ok=True)
    path = os.path.abspath(f"{log_dir}/logs/{name}.log")
    logger = logging.getLogger("parsenet_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename != path:
            logger.removeHandler(h)
            h.close()
    kinds = {isinstance(h, logging.FileHandler) for h in logger.handlers}
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for is_file, make in ((False, logging.StreamHandler),
                          (True, lambda: logging.FileHandler(path))):
        if is_file not in kinds:
            handler = make()
            handler.setFormatter(fmt)
            logger.addHandler(handler)
    return logger


class MetricsLogger:
    """One JSON line per log() in {log_dir}/tensorboard/{name}/metrics.jsonl
    (the JAX package's path)."""

    def __init__(self, log_dir: str, name: str):
        self.dir = os.path.join(log_dir, "tensorboard", name)
        os.makedirs(self.dir, exist_ok=True)
        self.jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()


def snapshot_config(config, log_dir: str, name: str) -> None:
    """{log_dir}/configs/{name}.json (reference: train_parsenet.py:52-60)."""
    os.makedirs(f"{log_dir}/configs", exist_ok=True)
    config.write(f"{log_dir}/configs/{name}.json")
