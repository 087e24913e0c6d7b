"""Typed configuration tree (the port's copy of ``cpt_tpu/config/core.py``).

Every config is a frozen dataclass; ``from_yaml`` deep-merges a YAML dict
into the defaults, ``replace_path`` / ``apply_overrides`` apply dotted-key
overrides ("a.b.c" → value) functionally, and ``to_dict`` / ``dumps``
turn a tree back into plain dicts and lists, as
``utils/checkpoint.save_model`` writes it to ``config.json``. YAML is read
through PyYAML, imported where a file is read.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import fields, is_dataclass
from typing import Any, Mapping, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


def _coerce(value: Any, typ: Any) -> Any:
    """Best-effort coercion of YAML/CLI scalars into the annotated type."""
    import typing

    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(typ) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0]) if len(args) == 1 else value
    if origin in (tuple, Tuple):
        args = typing.get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        return tuple(_coerce(v, a) for v, a in zip(value, args))
    if is_dataclass(typ) and isinstance(value, Mapping):
        return merge_dict(typ(), value)
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (int, float, str) and value is not None:
        return typ(value)
    return value


def merge_dict(cfg: T, overrides: Mapping[str, Any]) -> T:
    """Return a copy of dataclass ``cfg`` with ``overrides`` deep-merged in."""
    if not is_dataclass(cfg):
        raise TypeError(f"merge_dict expects a dataclass, got {type(cfg)}")
    by_name = {f.name: f for f in fields(cfg)}
    updates = {}
    for key, val in overrides.items():
        if key not in by_name:
            raise KeyError(
                f"unknown config key {key!r} for {type(cfg).__name__}; "
                f"valid keys: {sorted(by_name)}"
            )
        cur = getattr(cfg, key)
        if is_dataclass(cur) and isinstance(val, Mapping):
            updates[key] = merge_dict(cur, val)
        else:
            updates[key] = _coerce(val, by_name[key].type_resolved
                                   if hasattr(by_name[key], "type_resolved")
                                   else _resolve_type(type(cfg), key))
    return dataclasses.replace(cfg, **updates)


def _resolve_type(cls: Type, name: str) -> Any:
    import typing

    hints = typing.get_type_hints(cls)
    return hints[name]


def replace_path(cfg: T, dotted: str, value: Any) -> T:
    """Apply one dotted-path override, e.g. ``replace_path(c, "rpn.nms_thresh", 0.7)``."""
    head, _, rest = dotted.partition(".")
    if rest:
        child = getattr(cfg, head)
        return dataclasses.replace(cfg, **{head: replace_path(child, rest, value)})
    return merge_dict(cfg, {head: value})


def apply_overrides(cfg: T, opts: Mapping[str, Any]) -> T:
    """Apply a flat {dotted-key: value} mapping (the CLI ``opts`` list)."""
    for k, v in opts.items():
        cfg = replace_path(cfg, k, v)
    return cfg


def from_yaml(cls: Type[T], path: str, opts: Optional[Mapping[str, Any]] = None) -> T:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = merge_dict(cls(), raw)
    if opts:
        cfg = apply_overrides(cfg, opts)
    return cfg


def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, tuple):
        return [to_dict(v) for v in cfg]
    return cfg


def dumps(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)
