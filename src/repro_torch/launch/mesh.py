"""Meshes: the port's counterpart of ``repro/launch/mesh.py``.

A ``Mesh`` names its axes and holds its devices in an object array of the
mesh's shape, so that ``mesh.devices.shape`` reads as a JAX mesh's does
(the sharding rules read it so):

* ``make_production_mesh`` gives the pod shapes the dry run prices,
  (data=16, model=16) or (pod=2, data=16, model=16). Its devices are
  placeholders on ``meta`` that hold nothing: a step built on it runs on
  meta tensors, shapes and counts only.
* ``make_debug_mesh`` covers the devices that exist. Inside an initialised
  ``torch.distributed`` world of ``data * model`` ranks it is a real mesh:
  it holds a ``DeviceMesh`` (``device_mesh``) with the dim names ("data",
  "model"), each rank runs on its own device (``cuda:<local rank>``, or
  the CPU when asked), and the step builders place their tensors on it as
  DTensors (``launch/sharding.py::place``). Outside a world it is the one
  card, or the CPU.

Every family's steps run on a mesh of more than one device.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..device import device_count, resolve_device

class Mesh:
    """``axis_names`` and an object array ``devices`` of the mesh's shape,
    one ``torch.device`` an entry."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 devices, device_mesh=None, local_device=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh      # torch DeviceMesh, in a world
        self._local = local_device
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
    def distributed(self) -> bool:
        """True for a mesh over the ranks of a ``torch.distributed`` world
        (its steps place DTensors)."""
        return self.device_mesh is not None

    @property
    def device(self) -> torch.device:
        """The device a step on this mesh runs on: ``meta`` for the
        production meshes, this rank's device on a distributed mesh, the
        device of a one-device mesh."""
        kinds = {str(d) for d in self.devices.reshape(-1)}
        if kinds == {"meta"}:
            return torch.device("meta")
        if self.distributed:
            return self._local
        if self.size != 1:
            raise ValueError(f"a {self.size}-device mesh runs inside a "
                             "torch.distributed world of as many ranks")
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
    (``device`` None or ``cuda``) or the CPU (``device="cpu"``).

    Inside an initialised ``torch.distributed`` world the world must hold
    ``data * model`` ranks, and the mesh is theirs: rank r runs on
    ``cuda:<LOCAL_RANK>`` (r where the variable is unset) or on the CPU,
    over a ``DeviceMesh`` of dims ("data", "model")."""
    dev = resolve_device(device)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        world = dist.get_world_size()
        if world != data * model:
            raise ValueError(f"a ({data}, {model}) mesh in a world of "
                             f"{world} ranks")
        if dev.type == "cuda":
            local = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", dist.get_rank())))
            torch.cuda.set_device(local)
        else:
            local = dev
        dm = init_device_mesh(local.type, (data, model),
                              mesh_dim_names=("data", "model"))
        devs = [torch.device(local.type, int(r)) if local.type == "cuda"
                else local for r in dm.mesh.reshape(-1).tolist()]
        return Mesh((data, model), ("data", "model"), devs, dm, local)
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
