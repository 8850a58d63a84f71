"""Containers of the fleet simulator and the live-serving engine (port of
:mod:`repro.fleet.state`).

The fleet-level names alias the step core's NamedTuples — a fleet is the
same tensors with a leading ``D`` (device) axis on every leaf:
:class:`FleetConfig` = :class:`StepParams`, :class:`DeviceState` =
:class:`DeviceCarry`, :class:`FleetResult` = :class:`StepResult`,
:class:`FleetStatics` = :class:`StepStatics`.

:func:`pack_carry` / :func:`unpack_carry` give the carry a
checkpoint layout (booleans as int32 0/1).  Live serving adds the runtime
k-means state (:class:`ServeBank`) and a
per-job outcome log (:class:`ServeLog`); :class:`ServeCarry` bundles them
with the device state into one checkpointable carry.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.step import (
    DeviceCarry,
    StepParams,
    StepResult,
    StepStatics,
    init_carry,
)

FleetStatics = StepStatics
FleetConfig = StepParams
DeviceState = DeviceCarry
FleetResult = StepResult
init_state = init_carry

#: the DeviceCarry leaves that are booleans
BOOL_CARRY_FIELDS = ("was_off", "q_active", "q_correct", "q_apass")


def pack_carry(carry: DeviceCarry) -> DeviceCarry:
    """The carry with its boolean leaves as int32 0/1 — the layout the
    reference's checkpoints use.  Round-trips exactly through
    :func:`unpack_carry`."""
    return DeviceCarry(*[
        v.to(torch.int32) if f in BOOL_CARRY_FIELDS else v
        for f, v in zip(DeviceCarry._fields, carry)])


def unpack_carry(carry: DeviceCarry) -> DeviceCarry:
    """Inverse of :func:`pack_carry`: the int32 0/1 leaves as booleans
    (``!= 0``)."""
    return DeviceCarry(*[
        (v != 0) if f in BOOL_CARRY_FIELDS else v
        for f, v in zip(DeviceCarry._fields, carry)])


class ServeBank(NamedTuple):
    """Stacked centroid bank — the *mutable* half of the classifier state,
    padded to ``(K tasks, U units, C clusters, F features)``; in
    ``per-device`` bank mode every leaf gains a leading ``D`` axis."""

    centroids: torch.Tensor  # ([D,] K, U, C, F) f32
    counts: torch.Tensor     # ([D,] K, U, C) f32


class ServeLog(NamedTuple):
    """Per-job outcome log, ``(D, K, J)`` each, written as units complete.
    ``pred``/``correct``/``margin`` reflect the deepest executed unit;
    ``exit_unit`` is where the bank utility test first passed (-1 = never);
    ``sched`` mirrors the step core's mandatory-before-deadline test."""

    units: torch.Tensor      # int32, units executed
    pred: torch.Tensor       # int32, last prediction (-1 = never)
    correct: torch.Tensor    # bool
    margin: torch.Tensor     # f32
    exit_unit: torch.Tensor  # int32
    sched: torch.Tensor      # bool


class ServeCarry(NamedTuple):
    """Full live-serving carry: device state + centroid bank + job log."""

    dev: DeviceCarry         # every leaf (D, ...)
    bank: ServeBank
    log: ServeLog


__all__ = [
    "DeviceState",
    "FleetConfig",
    "FleetResult",
    "FleetStatics",
    "ServeBank",
    "ServeCarry",
    "ServeLog",
    "init_state",
    "pack_carry",
    "unpack_carry",
]
