"""Experiment configuration, the port's copy.

Counterpart of parsenet_tpu/core/config.py: the typed `Config` and a parser
for the reference's INI-style configs/*.yml (ConfigObj dialect, one [train]
section; reference: read_config.py:6-66). Field names match the files, so
configs/*.yml load unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional


def _coerce(value: str) -> Any:
    v = value.strip().strip('"').strip("'")
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for kind in (int, float):
        try:
            return kind(v)
        except ValueError:
            pass
    return v


def parse_ini(path: str) -> Dict[str, Any]:
    """The file as a flat dict; section headers, `#` comments and blank
    lines are skipped."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("["):
                continue
            m = re.match(r"([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.*)", line)
            if m:
                out[m.group(1)] = _coerce(m.group(2))
    return out


@dataclasses.dataclass
class Config:
    """Trainer hyperparameters (reference: read_config.py:14-66), with the
    JAX package's defaults and additions. dropout, encoder_drop, proportion
    and accum are parsed and unused, as in the reference."""

    comment: str = ""
    model_path: str = "model"
    dataset: str = ""
    preload_model: bool = False
    pretrain_model_path: str = ""
    normals: bool = False
    proportion: float = 1.0
    num_train: int = 0
    num_val: int = 0
    num_test: int = 0
    num_points: int = 700
    loss_weight: float = 0.9
    num_epochs: int = 100
    grid_size: int = 20
    batch_size: int = 8
    optim: str = "adam"
    accum: int = 1
    weight_decay: float = 0.0
    dropout: float = 0.0
    lr: float = 1e-3
    encoder_drop: float = 0.0
    lr_sch: bool = True
    patience: int = 8
    mode: int = 0
    seed: int = 0
    num_devices: int = 0
    half_precision: bool = False
    fast_step: bool = False
    log_dir: str = "logs"
    knn_k: int = 80

    @classmethod
    def from_file(cls, path: str) -> "Config":
        raw = parse_ini(path)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def write(self, path: str) -> None:
        """Snapshot the config as JSON (reference: read_config.py:68-76)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def load_config(path: Optional[str] = None, **overrides) -> Config:
    cfg = Config.from_file(path) if path else Config()
    return cfg.replace(**overrides) if overrides else cfg
