"""Meshes: the port's counterpart of ``repro/launch/mesh.py``.

A ``Mesh`` names its axes and holds its devices in an object array of the
mesh's shape, so that ``mesh.devices.shape`` reads as a JAX mesh's does
(the sharding rules read it so). The port places tensors on one device:

* ``make_production_mesh`` gives the pod shapes the dry run prices,
  (data=16, model=16) or (pod=2, data=16, model=16). Its devices are
  placeholders on ``meta`` that hold nothing: a step built on it runs on
  meta tensors, shapes and counts only.
* ``make_debug_mesh`` covers the devices that exist: the card unless the
  caller asks for the CPU. A mesh of more than one card is not placed:
  the step builders and ``CheckpointManager.restore`` raise for it
  (``MULTI_CARD``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import device_count, resolve_device

MULTI_CARD = ("a mesh of several cards (torch.distributed placement of the "
              "specs, shard_rows over cards, restore onto several cards) "
              "is ROADMAP Queue 1, item 31")


class Mesh:
    """``axis_names`` and an object array ``devices`` of the mesh's shape,
    one ``torch.device`` an entry."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 devices):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(shape, dtype=object)
        flat = self.devices.reshape(-1)
        for i, d in enumerate(devices):
            flat[i] = d

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The one device a step on this mesh runs on: ``meta`` for the
        production meshes, the device of a one-device mesh. Raises for a
        mesh over several real devices."""
        kinds = {str(d) for d in self.devices.reshape(-1)}
        if kinds == {"meta"}:
            return torch.device("meta")
        if self.size != 1:
            raise NotImplementedError(
                f"{self.size}-device mesh: {MULTI_CARD}")
        return self.devices.reshape(-1)[0]

    def abstract(self) -> "Mesh":
        """The same axes over placeholder devices on ``meta``."""
        return Mesh(self.devices.shape, self.axis_names,
                    [torch.device("meta")] * self.size)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.devices.reshape(-1)[0]})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod": the
    shapes the dry run prices, on placeholder devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, [torch.device("meta")] * int(np.prod(shape)))


def make_debug_mesh(data: int = 1, model: int = 1,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Mesh:
    """A (data, model) mesh over the devices that exist: the cards
    (``device`` None or ``cuda``) or the CPU (``device="cpu"``)."""
    dev = resolve_device(device)
    n = device_count(dev)
    assert data * model <= n, (data, model, n)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(data * model)]
    else:
        devs = [dev] * (data * model)
    return Mesh((data, model), ("data", "model"), devs)


def batch_axes(mesh) -> tuple:
    """Mesh axes a global-batch dimension shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
