"""Device meshes and logical-axis rules (port of :mod:`repro.launch.mesh`).

One process drives every card of a mesh, as the reference's single
controller drives its devices.  A :class:`Mesh` names its axes and holds a
numpy object array of ``torch.device``\\ s in that shape; an abstract mesh
has the axes and no devices and serves spec inference only.  The
production layouts are the reference's: one pod of 16 x 16 = 256 cards
with axes ``("data", "model")``, two pods of 512 with ``("pod", "data",
"model")``.  On a machine with fewer cards building one raises, as
``jax.make_mesh`` does on a host without the devices.

A mesh may list one device several times: the CPU device, or a card named
with its index (``"cuda:0"``).  That is the counterpart of the reference's
forced host devices: the tests hold the port's padding, slicing and
cross-block reductions to the reference's multi-device runs with it, and
one card runs every block of a larger mesh.  A replicated leaf placed on
a device it already lives on stays the same tensor, so the blocks of one
card share one copy of it.

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Named axes over an array of devices (``devices=None``: abstract)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[np.ndarray] = None):
        self.axis_names = tuple(axis_names)
        self._shape = tuple(int(n) for n in shape)
        if len(self._shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self._shape} does not match axes "
                             f"{self.axis_names}")
        if devices is not None and devices.shape != self._shape:
            raise ValueError(f"devices of shape {devices.shape} for a mesh "
                             f"of shape {self._shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        """``{axis name: size}`` in axis order (``dict(mesh.shape)`` as in
        the reference)."""
        return dict(zip(self.axis_names, self._shape))

    @property
    def size(self) -> int:
        return int(np.prod(self._shape, dtype=np.int64))

    def __repr__(self) -> str:
        if self.devices is None:
            return f"Mesh({self.shape}, abstract)"
        names = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, on {', '.join(names)})"


def _visible(device_type: str) -> int:
    return torch.cuda.device_count() if device_type == "cuda" else 1


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh of ``prod(shape)`` devices of ``device``'s type: CUDA cards
    0, 1, ... for a bare ``"cuda"`` (``ValueError`` when fewer are
    visible), or that many copies of a CPU device or of a card named with
    its index (``"cuda:0"``)."""
    dev = torch.device(device)
    n = int(np.prod(tuple(shape), dtype=np.int64))
    if n < 1:
        raise ValueError(f"a mesh of shape {tuple(shape)} holds no device")
    if dev.type == "cuda" and dev.index is None:
        have = _visible("cuda")
        if n > have:
            raise ValueError(
                f"a mesh of shape {tuple(shape)} needs {n} CUDA cards; "
                f"{have} {'is' if have == 1 else 'are'} visible")
        flat = [torch.device("cuda", i) for i in range(n)]
    else:
        flat = [dev] * n
    devices = np.empty(n, dtype=object)
    devices[:] = flat
    return Mesh(shape, axes, devices.reshape(tuple(shape)))


def make_abstract_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A device-less mesh for spec inference."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The pod layout over 256 (512 with ``multi_pod``) CUDA cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, "cuda")


def make_host_mesh(device="cuda") -> Mesh:
    """A 1 x 1 ``("data", "model")`` mesh: the card, or the CPU under
    ``device="cpu"``."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_fleet_mesh(n_devices: Optional[int] = None,
                    device="cuda") -> Mesh:
    """A 1-D ``("dev",)`` mesh for the fleet simulator's independent device
    axis (:mod:`repro_torch.fleet`, :mod:`repro_torch.adapt`): every visible
    card by default (one CPU device under ``device="cpu"``, one card under
    ``"cuda:0"``); ``n_devices`` copies of a CPU device or of an indexed
    card when one is asked for."""
    dev = torch.device(device)
    n = (int(n_devices) if n_devices is not None
         else _visible(dev.type) if dev.index is None else 1)
    return make_mesh((n,), ("dev",), dev)


def logical_rules(mesh: Mesh) -> Mapping[str, object]:
    """Logical-axis -> mesh-axis mapping (the reference's table)."""
    has_pod = "pod" in mesh.axis_names
    batch = ("pod", "data") if has_pod else ("data",)
    return {
        "batch": batch,
        # the FSDP dim of weights and optimizer state; on the multi-pod
        # mesh it extends across pods
        "embed": (("pod", "data") if has_pod else ("data",)),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "seq": None,
        "qseq": None,
    }
