"""Intermittent execution substrate (paper §2, §7 — SONIC/Alpaca-style),
ported from :mod:`repro.core.intermittent`.

A *job* is an ordered list of atomic, idempotent *fragments* (pure
functions of a state tree).  After each fragment commits, the state is
snapshotted to "FRAM" (a host-side store).  On power failure the MCU
reboots and resumes from the last committed snapshot; because fragments
are pure functions of explicit state, re-execution is idempotent by
construction: a run with power failures equals a run without them, bit
for bit.

A torch tensor, unlike a JAX array, can be written in place, so
:meth:`FRAMStore.commit` and :meth:`FRAMStore.restore` copy the state
(tensor leaves cloned, numpy arrays copied): an in-place write cannot
reach a committed snapshot.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .energy import Capacitor, Harvester


@dataclass(frozen=True)
class Fragment:
    """An atomic execution quantum."""

    fn: Callable[[Any], Any]      # pure: state -> state
    time_s: float
    energy_j: float
    name: str = ""


def _snapshot(tree: Any) -> Any:
    """A copy of ``tree``: dict, list, tuple and NamedTuple containers
    rebuilt, tensor leaves cloned, numpy arrays copied, every other leaf
    (python scalars, strings, None) kept."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, dict):
        return type(tree)((k, _snapshot(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_snapshot(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


@dataclass
class FRAMStore:
    """Non-volatile snapshot store (double-buffered commit)."""

    _slots: dict = field(default_factory=dict)
    commits: int = 0

    def commit(self, key: str, state: Any) -> None:
        self._slots[key] = _snapshot(state)
        self.commits += 1

    def restore(self, key: str) -> Any:
        # a copy, as FRAM is read back into volatile memory: a fragment that
        # writes its input in place leaves the snapshot as committed
        return _snapshot(self._slots[key])

    def __contains__(self, key: str) -> bool:
        return key in self._slots


@dataclass
class RunStats:
    wall_time: float = 0.0
    busy_time: float = 0.0
    off_time: float = 0.0
    reboots: int = 0
    fragments_run: int = 0
    fragments_reexecuted: int = 0
    energy_used: float = 0.0


def run_intermittent(
    fragments: Sequence[Fragment],
    state: Any,
    harvester: Harvester,
    cap: Capacitor | None = None,
    *,
    fram: FRAMStore | None = None,
    job_key: str = "job",
    dt: float = 0.01,
    seed: int = 0,
    max_wall: float = 1e6,
) -> tuple[Any, RunStats]:
    """Execute ``fragments`` over ``state`` under intermittent power.

    A fragment executes only if the capacitor holds its energy cost; if
    power runs out mid-fragment the partial work is discarded (time
    wasted) and the fragment re-executes after recharge, resuming from the
    last committed FRAM snapshot.
    """
    cap = dataclasses.replace(cap) if cap is not None else Capacitor()
    if cap.energy_j == 0.0:
        cap.energy_j = cap.capacity_j
    fram = fram if fram is not None else FRAMStore()
    rng = np.random.default_rng(seed)
    stats = RunStats()

    n_slots = int(max_wall / harvester.slot_s) + 2
    events = harvester.sample_events(rng, min(n_slots, 10_000_000), init=1)

    def power_at(t: float) -> float:
        slot = min(int(t / harvester.slot_s), len(events) - 1)
        return float(events[slot]) * harvester.power_on

    fram.commit(job_key, state)  # initial checkpoint
    t = 0.0
    i = 0
    attempted = set()
    while i < len(fragments):
        frag = fragments[i]
        if cap.energy_j < frag.energy_j:
            # power failure: lose volatile progress, wait for recharge
            if (job_key, i) in attempted:
                stats.fragments_reexecuted += 1
            was_running = stats.busy_time > 0 or i > 0
            off_start = t
            while cap.energy_j < frag.energy_j and t < max_wall:
                cap.charge(power_at(t) * dt)
                t += dt
            stats.off_time += t - off_start
            if t >= max_wall:
                break
            if was_running:
                stats.reboots += 1
            state = fram.restore(job_key)  # resume from committed snapshot
            continue
        attempted.add((job_key, i))
        cap.charge(power_at(t) * frag.time_s)
        cap.discharge(frag.energy_j)
        state = frag.fn(state)
        t += frag.time_s
        stats.busy_time += frag.time_s
        stats.energy_used += frag.energy_j
        stats.fragments_run += 1
        fram.commit(job_key, state)
        i += 1

    stats.wall_time = t
    return state, stats


def fragment_unit(
    unit_fn: Callable[[Any], Any],
    n_fragments: int,
    time_s: float,
    energy_j: float,
    name: str = "unit",
) -> list[Fragment]:
    """Split one DNN unit into n atomic fragments.

    The first n-1 fragments are bookkeeping-sized slices of the unit's cost
    (in a SONIC deployment these are loop tiles with idempotent
    loop-continuation); the final fragment applies the actual (pure) unit
    function.  Costs are spread evenly, as the paper's EnergyTrace++
    per-fragment accounting does.
    """
    frags = [
        Fragment(lambda s: s, time_s / n_fragments, energy_j / n_fragments,
                 f"{name}/f{i}")
        for i in range(n_fragments - 1)
    ]
    frags.append(
        Fragment(unit_fn, time_s / n_fragments, energy_j / n_fragments,
                 f"{name}/commit")
    )
    return frags
