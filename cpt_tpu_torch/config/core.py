"""Config serialization (the port's copy of ``to_dict`` / ``dumps`` of
``cpt_tpu/config/core.py``): a frozen-dataclass config tree → plain
dicts and lists, as ``utils/checkpoint.save_model`` writes it to
``config.json``. The YAML front end (``from_yaml``, ``merge_dict``,
``replace_path``) comes with the detector-config port (ROADMAP.md Queue 1
item 3)."""
from __future__ import annotations

import json
from dataclasses import fields, is_dataclass
from typing import Any


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return [to_dict(v) for v in cfg]
    return cfg


def dumps(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)
