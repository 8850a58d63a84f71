"""Observability for the fleet, serve and adaptation paths (port of
:mod:`repro.telemetry`).

* :class:`Telemetry` — per-device counters, extrema, an exit-depth
  histogram and a fixed-size event ring, carried beside
  :class:`repro_torch.core.step.DeviceCarry` through the time loops.
  Enabling it changes no bit of any result (events are carry deltas);
  ``telemetry=None``, the default everywhere, runs the plain path.
* :class:`TelemetryConfig` — pass it to ``fleet.simulate_fleet`` /
  ``fleet.run_segments`` / ``FleetServeEngine.run`` / ``run_stream`` /
  ``AnytimeServeEngine.run`` as ``telemetry=``.
* :func:`summarize` / :class:`TelemetrySummary` — host-side per-segment
  reduction, what :class:`repro_torch.adapt.online.OnlineAdapter` reads.
* :class:`TelemetryLogger` / :func:`read_jsonl` — JSONL event streams,
  rendered by ``python -m repro_torch.telemetry.report``.

Usage::

    tcfg = TelemetryConfig(ring_size=512)
    res, carry, tel = fleet.run_segments(cfg, statics, n_segments=8,
                                         telemetry=tcfg)
    summary = summarize(tel, statics.horizon)
    summary.miss_rate, summary.exit_hist, summary.energy_min
"""
from .export import (  # noqa: F401
    TelemetryLogger,
    TelemetrySummary,
    read_jsonl,
    summarize,
)
from .state import (  # noqa: F401
    EVENT_KINDS,
    EVENT_NAMES,
    Telemetry,
    TelemetryConfig,
    init_fleet_telemetry,
    init_telemetry,
    record_anytime_step,
    record_knob_updates,
    record_step,
)
