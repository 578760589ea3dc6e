"""Checkpoints on the reference's on-disk layout, the port of
``repro.train.checkpoint``: atomic, async, keep-k.

Layout: ``<dir>/step_<n:09d>/`` holds one ``.npy`` per leaf, named by its
``__``-joined path (``tree.leaf_name``), and ``meta.json`` with the step,
a description of the tree, ``"sharding": "replicated"`` and the leaf
names. A save writes ``step_<n>.tmp`` and renames it when complete, so an
interrupted save never leaves a partial latest checkpoint; old steps
beyond the newest ``keep`` are deleted. At most one save is in flight:
the next one (and ``wait()``) joins the writer thread first.

bfloat16 leaves are written as their 2-byte payload (numpy dtype
``V2``), as the reference's ``np.save`` of an ``ml_dtypes`` array
writes them, so the dtype is not on disk: ``restore`` views a 2-byte
payload as the dtype of the matching leaf of ``like``, and a checkpoint
the reference wrote restores here. Leaves are copied to host memory
before the writer thread starts: the training step updates parameters
and moments in place.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.train.tree import leaf_name, map_tree, named_leaves


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf``; bfloat16 as its 2-byte payload."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(arr: np.ndarray, like_leaf, name: str) -> torch.Tensor:
    """``arr`` as a CPU tensor of ``like_leaf``'s dtype: a 2-byte void
    payload is viewed as it; any other dtype must be its own."""
    dtype = like_leaf.dtype if isinstance(like_leaf, torch.Tensor) else None
    if arr.dtype.kind == "V":
        if dtype is None or arr.dtype.itemsize != 2 or dtype.itemsize != 2:
            raise ValueError(
                f"checkpoint leaf {name}: a {arr.dtype.itemsize}-byte payload cannot "
                f"be read as {dtype}"
            )
        raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return raw.view(dtype)
    out = torch.from_numpy(np.array(arr))
    if dtype is not None and out.dtype != dtype:
        raise ValueError(f"checkpoint leaf {name}: dtype {out.dtype} != {dtype}")
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- write ----------------------------------------------------------
    def save(self, step: int, state: dict[str, Any], blocking: bool = False):
        """state: a tree (e.g. ``{"params": ..., "opt_state": ...}``)."""
        self.wait()  # at most one in-flight save
        arrays = {leaf_name(path): _to_numpy(leaf) for path, leaf in named_leaves(state)}
        meta = {
            "step": int(step),
            "treedef": "repro_torch state tree: " + ", ".join(arrays),
            "sharding": "replicated",
            "leaves": list(arrays),
        }

        def _write():
            final = os.path.join(self.directory, f"step_{step:09d}")
            if os.path.exists(final):  # idempotent re-save after resume
                return
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for name, arr in arrays.items():
                np.save(os.path.join(tmp, name + ".npy"), arr)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"))

    # -- read -----------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: dict[str, Any]) -> dict[str, Any]:
        """Restore into the structure of ``like`` (a tree of tensors; a
        module becomes the dict of its parameters): CPU tensors of the
        dtypes of ``like``'s leaves. The caller moves them where it wants
        them (``tree.copy_into``)."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        wanted = {leaf_name(path): leaf for path, leaf in named_leaves(like)}

        def load(leaf):
            name = names.pop(0)
            arr = np.load(os.path.join(d, name + ".npy"))
            expected = tuple(leaf.shape)
            if tuple(arr.shape) != expected:
                raise ValueError(f"checkpoint leaf {name}: shape {arr.shape} != {expected}")
            return _from_numpy(arr, wanted[name], name)

        names = list(wanted)
        return map_tree(load, like)
