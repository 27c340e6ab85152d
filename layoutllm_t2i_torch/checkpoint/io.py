"""Native checkpoint save/load with embedded config + auto-resume
(layoutllm_t2i_tpu/checkpoint/io.py).

Mirrors the reference's two resilience mechanisms: a dict checkpoint with
its config embedded as the source of truth (trainer_combined_layout.py:
523-535), here a directory holding ``state.pt`` (``torch.save`` of a dict
of tensors and numbers, written to a temporary file and renamed into place)
and ``config.json``; and auto-resume by scanning the run directory for the
newest ``checkpoint_*`` (trainer_combined_layout.py:147), with the tagNN run
directories of the JAX package (io.py:85-100).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

STATE_FILE = "state.pt"


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: Any, config: Optional[dict] = None) -> None:
    """``state``: nested dicts/lists of CPU tensors, numbers and None."""
    os.makedirs(path, exist_ok=True)
    _atomic_write(os.path.join(path, STATE_FILE),
                  lambda tmp: torch.save(state, tmp))
    if config is not None:
        def write_json(tmp):
            with open(tmp, "w") as f:
                json.dump(_jsonable(config), f, indent=2)
        _atomic_write(os.path.join(path, "config.json"), write_json)


def load_checkpoint(path: str) -> Tuple[Any, Optional[dict]]:
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True)
    config = None
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            config = json.load(f)
    return state, config


def _jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")


def find_latest_checkpoint(run_dir: str) -> Optional[str]:
    """checkpoint_latest if it holds a state, else the newest
    checkpoint_NNNNNNNN subdirectory that does."""
    if not os.path.isdir(run_dir):
        return None
    latest = os.path.join(run_dir, "checkpoint_latest")
    if os.path.exists(os.path.join(latest, STATE_FILE)):
        return latest
    best, best_iter = None, -1
    for name in os.listdir(run_dir):
        m = _CKPT_RE.match(name)
        if m and int(m.group(1)) > best_iter:
            cand = os.path.join(run_dir, name)
            if os.path.exists(os.path.join(cand, STATE_FILE)):
                best, best_iter = cand, int(m.group(1))
    return best


def create_run_dir_with_auto_resume(output_root: str,
                                    name: str) -> Tuple[str, Optional[str]]:
    """(run_dir, resume_ckpt_or_None): the newest tagNN directory when it
    holds a checkpoint, else a new tagNN one past it, so distinct launches
    never clobber each other."""
    base = os.path.join(output_root, name)
    os.makedirs(base, exist_ok=True)
    tags = sorted(d for d in os.listdir(base) if re.match(r"^tag\d+$", d))
    if tags:
        newest = os.path.join(base, tags[-1])
        ckpt = find_latest_checkpoint(newest)
        if ckpt is not None:
            return newest, ckpt
        run_dir = os.path.join(base, f"tag{int(tags[-1][3:]) + 1:02d}")
    else:
        run_dir = os.path.join(base, "tag00")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir, None
