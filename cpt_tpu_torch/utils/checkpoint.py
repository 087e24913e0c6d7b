"""Checkpoint save and restore (port of ``cpt_tpu/utils/checkpoint.py``,
with ``torch.save`` where JAX uses Orbax).

  * ``save_checkpoint`` / ``restore_checkpoint``: any nested state (dicts,
    lists, tuples, named tuples, dataclasses such as the trainer's
    ``TrainState`` and ``OptState``, tensors, numpy arrays, numbers) under
    ``ckpt_dir/name/state.pt``; restored into the structure, dtypes and
    devices of a target. The file holds plain containers and tensors only,
    so it is read with ``torch.load(..., weights_only=True)``.
  * the ``last_checkpoint`` tag file of the reference's ``Checkpointer``
    (resume follows it), ``keep_last`` pruning, and retries of transient
    IO failures (the reference's save-retry loop, ``gqa_cpt.py:508-517``);
  * ``save_model`` / ``load_model``: the ``save_pretrained`` counterpart,
    the parameters (a model's ``state_dict``) with the config as
    ``config.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as op
import shutil
import time
from typing import Any, List, Optional

import numpy as np
import torch

from cpt_tpu_torch.config.core import to_dict

STATE_FILE = "state.pt"


def _tag_path(ckpt_dir: str) -> str:
    return op.join(ckpt_dir, "last_checkpoint")


def _plain(obj: Any) -> Any:
    """``obj`` as dicts, lists and CPU tensors (what ``weights_only``
    loads)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _restore(target: Any, saved: Any) -> Any:
    """``saved`` (from :func:`_plain`) in the structure of ``target``, each
    tensor in its target's dtype and on its device."""
    if isinstance(target, torch.Tensor):
        return saved.to(dtype=target.dtype, device=target.device)
    if isinstance(target, np.ndarray):
        return saved.numpy().astype(target.dtype)
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _restore(getattr(target, f.name), saved[f.name])
            for f in dataclasses.fields(target) if f.init})
    if isinstance(target, dict):
        return type(target)((k, _restore(v, saved[k])) for k, v in target.items())
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_restore(t, s) for t, s in zip(target, saved)))
    if isinstance(target, (list, tuple)):
        if len(target) != len(saved):
            raise ValueError(f"checkpoint holds {len(saved)} entries where "
                             f"the target has {len(target)}")
        return type(target)(_restore(t, s) for t, s in zip(target, saved))
    if isinstance(target, (bool, int, float)) and not isinstance(saved, torch.Tensor):
        return type(target)(saved)
    return saved


def save_checkpoint(ckpt_dir: str, name: str, state: Any,
                    keep_last: Optional[int] = None,
                    retries: int = 10) -> str:
    """Save ``state`` under ``ckpt_dir/name``; update ``last_checkpoint``.

    Retries transient IO failures up to ``retries`` times."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = op.abspath(op.join(ckpt_dir, name))
    host_state = _plain(state)
    last_err = None
    for attempt in range(max(retries, 1)):
        try:
            if op.exists(path):
                shutil.rmtree(path)
            os.makedirs(path)
            torch.save(host_state, op.join(path, STATE_FILE))
            break
        except OSError as e:                     # pragma: no cover - IO flake
            last_err = e
            time.sleep(min(2 ** attempt, 30))
    else:                                        # pragma: no cover
        raise last_err
    with open(_tag_path(ckpt_dir), "w") as f:
        f.write(name)
    if keep_last:
        prune_checkpoints(ckpt_dir, keep_last)
    return path


def has_checkpoint(ckpt_dir: str) -> bool:
    return op.exists(_tag_path(ckpt_dir))


def last_checkpoint_name(ckpt_dir: str) -> Optional[str]:
    if not has_checkpoint(ckpt_dir):
        return None
    with open(_tag_path(ckpt_dir)) as f:
        return f.read().strip()


def restore_checkpoint(ckpt_dir: str, target: Any,
                       name: Optional[str] = None) -> Any:
    """Restore into the structure of ``target`` (its dtypes and devices).

    With ``name=None``, follows the ``last_checkpoint`` tag; returns
    ``target`` unchanged if no checkpoint exists (fresh start)."""
    if name is None:
        name = last_checkpoint_name(ckpt_dir)
        if name is None:
            return target
    path = op.join(op.abspath(op.join(ckpt_dir, name)), STATE_FILE)
    return _restore(target, torch.load(path, map_location="cpu",
                                       weights_only=True))


def list_checkpoints(ckpt_dir: str) -> List[str]:
    if not op.isdir(ckpt_dir):
        return []
    return sorted(d for d in os.listdir(ckpt_dir)
                  if op.isdir(op.join(ckpt_dir, d)))


def save_model(save_dir: str, params: Any, config: Any = None,
               retries: int = 10, retry_sleep: float = 1.0) -> str:
    """``save_pretrained`` counterpart: ``params`` (a ``state_dict``) as the
    checkpoint ``model`` + the config as ``config.json``, the saves retried
    on transient IO errors."""
    last_err = None
    for _ in range(max(retries, 1)):
        try:
            path = save_checkpoint(save_dir, "model", params)
            break
        except OSError as e:                     # transient fs hiccups
            last_err = e
            time.sleep(retry_sleep)
    else:
        raise last_err
    if config is not None:
        with open(op.join(save_dir, "config.json"), "w") as f:
            json.dump(to_dict(config), f, indent=2)
    return path


def load_model(save_dir: str, target_params: Any) -> Any:
    """The parameters ``save_model`` saved, in ``target_params``' structure
    (load them with ``model.load_state_dict``)."""
    return restore_checkpoint(save_dir, target_params, name="model")


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    names = list_checkpoints(ckpt_dir)
    last = last_checkpoint_name(ckpt_dir)
    removable = [n for n in names if n != last]
    for n in removable[: max(0, len(names) - keep_last)]:
        shutil.rmtree(op.join(ckpt_dir, n))
