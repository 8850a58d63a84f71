"""Host-side telemetry reduction and JSONL export (port of
:mod:`repro.telemetry.export`).

* **adaptation** — :func:`summarize` reduces a ``(D, ...)``
  :class:`repro_torch.telemetry.state.Telemetry` into a
  :class:`TelemetrySummary` of numpy arrays at a segment boundary;
  :meth:`TelemetrySummary.delta` diffs two cumulative summaries into the
  per-segment view the :class:`repro_torch.adapt.online.OnlineAdapter`
  controllers consume (its ``miss_rate`` equals the adapter's carry-diff
  measurement: both difference the same step counters).
* **offline analysis** — :class:`TelemetryLogger` streams JSONL: one
  ``meta`` line, one ``summary`` line per segment and one line per drained
  ring event, rendered by ``python -m repro_torch.telemetry.report`` and
  read back by :func:`read_jsonl`.

Ring draining is incremental: the logger remembers each device's last seen
``ring_head`` and emits only newer events; events overwritten before a
drain are counted in the summary's ``events_dropped``.  Telemetry leaves
may be tensors on any device or numpy arrays.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import IO, Optional

import numpy as np
import torch

from .state import EVENT_NAMES, Telemetry, TelemetryConfig

_COUNTERS = ("releases", "misses", "scheduled", "retired", "power_fails",
             "reboots", "knob_updates", "steps", "events_seen")


@dataclasses.dataclass(frozen=True)
class TelemetrySummary:
    """Numpy reduction of a fleet's telemetry at one point in time.

    Counter fields are cumulative since t=0 (or since the summary this one
    was :meth:`delta`-ed against); extrema (``slack_min`` / ``occ_max`` /
    ``energy_min``) are always cumulative over the whole run.  All
    per-device fields are ``(D,)`` (histogram: ``(D, U+1)``).
    """

    t_end: float
    steps: np.ndarray
    releases: np.ndarray
    misses: np.ndarray
    scheduled: np.ndarray
    retired: np.ndarray
    power_fails: np.ndarray
    reboots: np.ndarray
    knob_updates: np.ndarray
    slack_mean: np.ndarray       # mean deadline slack at retirement (s)
    slack_min: np.ndarray
    exit_hist: np.ndarray        # (D, U+1); last bin = never exited
    occ_mean: np.ndarray
    occ_max: np.ndarray
    energy_mean: np.ndarray
    energy_min: np.ndarray
    events_seen: np.ndarray      # total ring events ever pushed
    events_dropped: np.ndarray   # overwritten before any drain saw them

    @property
    def n_devices(self) -> int:
        return int(self.steps.shape[0])

    @property
    def miss_rate(self) -> np.ndarray:
        """Per-device missed fraction of the jobs released in this
        summary's window — the adaptation controllers' feedback signal."""
        return self.misses / np.maximum(self.releases, 1.0)

    def delta(self, prev: Optional["TelemetrySummary"]) -> "TelemetrySummary":
        """This summary's counters minus ``prev``'s (per-segment view).
        Extrema and means stay cumulative — they cannot be un-aggregated.
        ``prev=None`` returns self (the first segment is its own delta)."""
        if prev is None:
            return self
        diffs = {k: getattr(self, k) - getattr(prev, k) for k in _COUNTERS}
        diffs["exit_hist"] = self.exit_hist - prev.exit_hist
        return dataclasses.replace(self, **diffs)

    def as_dict(self, per_device: bool = False) -> dict:
        """JSON-serializable export: cohort aggregates, plus the full
        per-device columns when ``per_device`` is set."""
        out = {
            "t_end": float(self.t_end),
            "n_devices": self.n_devices,
            "releases": int(self.releases.sum()),
            "misses": int(self.misses.sum()),
            "scheduled": int(self.scheduled.sum()),
            "retired": int(self.retired.sum()),
            "power_fails": int(self.power_fails.sum()),
            "reboots": int(self.reboots.sum()),
            "knob_updates": int(self.knob_updates.sum()),
            "miss_rate": float(np.mean(self.miss_rate)),
            "slack_mean": float(np.mean(self.slack_mean)),
            "slack_min": _finite(float(np.min(self.slack_min))),
            "exit_hist": self.exit_hist.sum(axis=0).tolist(),
            "occ_mean": float(np.mean(self.occ_mean)),
            "occ_max": int(np.max(self.occ_max)),
            "energy_mean": float(np.mean(self.energy_mean)),
            "energy_min": _finite(float(np.min(self.energy_min))),
            "events_seen": int(self.events_seen.sum()),
            "events_dropped": int(self.events_dropped.sum()),
        }
        if per_device:
            out["per_device"] = {
                "miss_rate": np.round(self.miss_rate, 6).tolist(),
                "misses": self.misses.tolist(),
                "releases": self.releases.tolist(),
                "energy_mean": np.round(self.energy_mean, 6).tolist(),
                "occ_mean": np.round(self.occ_mean, 4).tolist(),
            }
        return out


def _finite(x: float, fallback: float = 0.0) -> float:
    return x if np.isfinite(x) else fallback


def _host(leaf) -> np.ndarray:
    """A telemetry leaf as numpy (one device-to-host copy for a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def summarize(tel: Telemetry, t_end: float,
              ring_size: Optional[int] = None) -> TelemetrySummary:
    """Reduce a stacked ``(D, ...)`` telemetry pytree host-side."""
    as_np = {k: _host(v) for k, v in tel._asdict().items()}
    steps = as_np["n_steps"].astype(np.int64)
    retired = as_np["c_retired"].astype(np.int64)
    r = int(ring_size if ring_size is not None else as_np["ring_t"].shape[-1])
    head = as_np["ring_head"].astype(np.int64)
    return TelemetrySummary(
        t_end=float(t_end),
        steps=steps,
        releases=as_np["c_release"].astype(np.int64),
        misses=as_np["c_miss"].astype(np.int64),
        scheduled=as_np["c_sched"].astype(np.int64),
        retired=retired,
        power_fails=as_np["c_power_fail"].astype(np.int64),
        reboots=as_np["c_reboot"].astype(np.int64),
        knob_updates=as_np["c_knob"].astype(np.int64),
        slack_mean=as_np["slack_sum"] / np.maximum(retired, 1),
        slack_min=as_np["slack_min"],
        exit_hist=as_np["exit_hist"].astype(np.int64),
        occ_mean=as_np["occ_sum"] / np.maximum(steps, 1),
        occ_max=as_np["occ_max"].astype(np.int64),
        energy_mean=as_np["energy_sum"] / np.maximum(steps, 1),
        energy_min=as_np["energy_min"],
        events_seen=head,
        events_dropped=np.maximum(head - r, 0),
    )


class TelemetryLogger:
    """Streaming JSONL writer for one telemetry-enabled run.

    Usage (a ``run_segments`` hook that declares ``telemetry=``)::

        with TelemetryLogger(path, label="fleet") as log:
            log.meta(statics, tcfg, n_devices=D)
            ...                      # after each segment:
            log.segment(seg, summarize(tel, t_end), tel)
    """

    def __init__(self, path, label: str = "run", per_device: bool = False):
        self.path = Path(path)
        self.label = label
        self.per_device = per_device
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f: Optional[IO[str]] = open(self.path, "w")
        self._drained: Optional[np.ndarray] = None  # per-device ring head
        self._prev: Optional[TelemetrySummary] = None

    # ------------------------------------------------------------------ #
    def _write(self, obj: dict) -> None:
        assert self._f is not None, "logger already closed"
        self._f.write(json.dumps(obj) + "\n")

    def meta(self, statics, tcfg: TelemetryConfig, n_devices: int) -> None:
        self._write({
            "event": "meta", "label": self.label, "n_devices": n_devices,
            "dt": float(statics.dt), "horizon": float(statics.horizon),
            "queue_size": int(statics.queue_size),
            "ring_size": int(tcfg.ring_size),
        })

    def segment(self, seg: int, summary: TelemetrySummary,
                tel: Optional[Telemetry] = None) -> None:
        """One segment boundary: the cumulative-minus-previous summary
        line, then every ring event that arrived since the last drain."""
        delta = summary.delta(self._prev)
        self._prev = summary
        row = {"event": "summary", "seg": int(seg), **delta.as_dict(
            per_device=self.per_device)}
        self._write(row)
        if tel is not None:
            self.drain_rings(tel)

    def drain_rings(self, tel: Telemetry) -> int:
        """Emit ring events newer than the previous drain; returns the
        number of lines written.  Events lost to overflow between drains
        are skipped (counted in the summary's ``events_dropped``)."""
        t = _host(tel.ring_t)
        kind = _host(tel.ring_kind)
        val = _host(tel.ring_val)
        head = _host(tel.ring_head).astype(np.int64)
        r = t.shape[-1]
        if self._drained is None:
            self._drained = np.zeros_like(head)
        n = 0
        for d in range(head.shape[0]):
            start = max(int(self._drained[d]), int(head[d]) - r)
            for i in range(start, int(head[d])):
                j = i % r
                self._write({
                    "event": EVENT_NAMES.get(int(kind[d, j]), "unknown"),
                    "device": d, "t": round(float(t[d, j]), 6),
                    "val": round(float(val[d, j]), 6),
                })
                n += 1
        self._drained = head
        return n

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TelemetryLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path) -> list[dict]:
    """Parse a telemetry JSONL stream back into a list of event dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
