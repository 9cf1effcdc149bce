"""Checkpointing: atomic, async, restorable onto any device (the
counterpart of ``repro/train/checkpoint.py``).

* **Atomic**: write to ``step_K.tmp/`` then ``os.replace`` to ``step_K/``;
  a crash mid-save never corrupts the restore point.
* **Async**: ``save`` copies the leaves to host memory (the one blocking
  part) and hands serialization to a background thread; one save is in
  flight at a time, and an error in it is raised by the next ``wait()``
  (``save`` and ``restore`` wait first).
* **Portable**: each leaf is stored as its raw bytes (``leaves.npz``, one
  uint8 array a leaf) with a ``meta.json`` of dtype names and shapes, the
  layout of ``repro``'s files. bf16 is stored under the name
  ``"bfloat16"`` and read back by viewing its bytes as ``torch.bfloat16``
  (numpy has no bf16 without ``ml_dtypes``, which the port does not need).
  Leaves are taken in ``train/tree.py``'s fixed order: dicts by sorted
  key, lists, NamedTuple fields.
* **Restore onto a device**: ``restore(like, step)`` puts each leaf on the
  device and dtype of its ``like`` leaf; ``restore(like, step,
  shardings=)`` on the device of each leaf's sharding's mesh (a tree of
  ``launch/sharding.py::NamedSharding``, as a ``StepBundle``'s
  ``in_shardings`` holds it). A mesh of several cards raises
  (``launch/mesh.py::MULTI_CARD``).
* **Retention**: keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from .tree import leaves, structure, unflatten


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot now (a host copy of every leaf), serialize in the
        background."""
        self.wait()                      # one in-flight save at a time
        host = [torch.as_tensor(x).detach().to("cpu", copy=True)
                .contiguous() for x in leaves(tree)]
        shape = structure(tree)

        def work():
            try:
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "leaves.npz",
                         **{f"leaf_{i}": _raw_bytes(t)
                            for i, t in enumerate(host)})
                (tmp / "meta.json").write_text(json.dumps({
                    "step": step, "n_leaves": len(host),
                    "dtypes": [_dtype_name(t) for t in host],
                    "shapes": [list(t.shape) for t in host],
                    "treedef": shape}))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore -----------------------------------------------------------
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like``; each tensor leaf takes
        the dtype of its ``like`` leaf, and the device of its ``like``
        leaf, or with ``shardings`` (a tree with ``like``'s leaves) the
        device of its sharding's mesh."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step}"
        meta = json.loads((path / "meta.json").read_text())
        like_leaves = leaves(like)
        if meta["n_leaves"] != len(like_leaves):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, expected "
                f"{len(like_leaves)}: structure changed?")
        devices = [None] * len(like_leaves) if shardings is None else \
            [sh.mesh.device for sh in leaves(shardings)]
        if len(devices) != len(like_leaves):
            raise ValueError(f"{len(devices)} shardings for "
                             f"{len(like_leaves)} leaves")
        out = []
        with np.load(path / "leaves.npz") as z:
            for i, ref in enumerate(like_leaves):
                shape = tuple(meta["shapes"][i])
                t = torch.from_numpy(z[f"leaf_{i}"]).view(
                    getattr(torch, meta["dtypes"][i])).reshape(shape)
                if isinstance(ref, torch.Tensor):
                    if tuple(ref.shape) != shape:
                        raise ValueError(
                            f"leaf {i}: checkpoint shape {shape}, expected "
                            f"{tuple(ref.shape)}")
                    t = t.to(device=devices[i] or ref.device,
                             dtype=ref.dtype)
                out.append(t)
        return unflatten(like, out)
