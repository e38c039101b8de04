"""Checkpointing with atomic manifests and resume-from-latest, on the JAX
package's on-disk layout.

Layout::

    <dir>/step_00000420.tmp<host>/...  (write)
    <dir>/step_00000420/               (atomic rename on completion)
        manifest.json                  (step, host, leaves, treedef)
        <leaf-path>.h<host>.npy        (one file per leaf, per host)

Leaves are named and shaped as the JAX package's: a ``DecoderLM``'s
layer leaves are stacked (L, ...) into one file, keys are joined by
``__`` (``params__layers__wq``, ``opt__m__embed``, ``opt__step``; see
:mod:`repro_torch.models.tree`), and a dtype numpy cannot hold
(bfloat16) is written as float32 with its own name in the manifest.  So
a checkpoint written by either package restores in the other.  Writes
are crash-safe: a partially written step directory never carries the
final name, and ``latest_step`` only believes directories with a
complete manifest.  Retention keeps the most recent k checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.tree import leaves, rebuild

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]

#: dtypes numpy writes as they are; any other goes to disk as float32
_NATIVE = (np.float32, np.float64, np.int32, np.int64, np.int8, np.uint8,
           np.bool_, np.int16, np.uint16, np.uint32, np.uint64, np.float16)


def _host_array(t) -> np.ndarray:
    """A leaf (tensor, array or number) as a numpy array on the host;
    bfloat16 widened to float32 exactly."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(t)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _grouped(tree):
    """(name, [leaves]) per file: a stacked leaf's layers together."""
    groups: Dict[str, List] = {}
    for leaf in leaves(tree):
        groups.setdefault(leaf.name, []).append(leaf)
    return groups


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    host_id: int = 0, keep: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{host_id}"
    os.makedirs(tmp, exist_ok=True)
    meta: List[Dict] = []
    for name, group in _grouped(tree).items():
        if group[0].index is None:
            arr = _host_array(group[0].value)
        else:                               # layers stacked (L, ...)
            first = _host_array(group[0].value)
            arr = np.empty((len(group),) + first.shape, first.dtype)
            arr[0] = first
            for i, leaf in enumerate(group[1:], 1):
                arr[i] = _host_array(leaf.value)
        orig_dtype = _dtype_name(group[0].value)
        if arr.dtype not in _NATIVE:
            arr = arr.astype(np.float32)
        np.save(os.path.join(tmp, f"{name}.h{host_id}.npy"), arr)
        meta.append({"name": name, "shape": list(arr.shape),
                     "dtype": orig_dtype})
    manifest = {"step": step, "time": time.time(), "host": host_id,
                "leaves": meta, "treedef": _describe(tree)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final) if not os.path.exists(final) else shutil.rmtree(tmp)
    _retain(ckpt_dir, keep)
    return final


def _describe(tree) -> str:
    """The tree's structure as text: its leaves' names in order."""
    return "Tree(" + ", ".join(_grouped(tree)) + ")"


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith("tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith("tmp") or ".tmp" in d:
            continue
        if not os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            continue                      # incomplete -> crash during write
        try:
            s = int(d.split("_")[1])
        except ValueError:
            continue
        best = s if best is None else max(best, s)
    return best


def _like(arr: np.ndarray, leaf) -> Any:
    """``arr`` in the dtype and on the device of ``leaf`` (a tensor; a
    numpy array or number keeps numpy)."""
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.array(arr))          # a writable copy
        return t.to(device=leaf.device).to(leaf.dtype)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def restore_checkpoint(ckpt_dir: str, step: int, like: Any, *,
                       host_id: int = 0) -> Any:
    """Restore into the structure, dtypes and devices of ``like``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    values, name, arr = [], None, None
    for leaf in leaves(like):        # a stacked leaf's layers are adjacent
        if leaf.name != name:
            name = leaf.name
            arr = np.load(os.path.join(d, f"{name}.h{host_id}.npy"),
                          mmap_mode="r")
        values.append(_like(arr if leaf.index is None else arr[leaf.index],
                            leaf.value))
    return rebuild(like, values)
