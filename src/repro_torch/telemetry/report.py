"""Text dashboard over a telemetry JSONL stream.

Port of :mod:`repro.telemetry.report`.  Renders the event stream a
:class:`repro_torch.telemetry.export.TelemetryLogger` wrote — per-segment
miss/occupancy/energy trajectories, the exit-depth
histogram, and per-device-cohort event timelines — as plain text::

    PYTHONPATH=src python -m repro_torch.telemetry.report run.jsonl
    PYTHONPATH=src python -m repro_torch.telemetry.report run.jsonl --cohorts 8 --width 64

Devices are grouped into ``--cohorts`` contiguous index ranges (fleet grids
stack related configs contiguously, so cohorts line up with sweep cells);
each cohort gets one timeline row per event kind, binned over the run
horizon and drawn with density glyphs.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from .export import read_jsonl

_SPARK = " .:-=+*#%@"
_TIMELINE_KINDS = ("miss", "power_fail", "complete", "knob_update")


def _spark(values, lo=None, hi=None) -> str:
    """Density string: one glyph per value, scaled over [lo, hi]."""
    vals = list(values)
    if not vals:
        return ""
    lo = min(vals) if lo is None else lo
    hi = max(vals) if hi is None else hi
    span = (hi - lo) or 1.0
    out = []
    for v in vals:
        i = int((v - lo) / span * (len(_SPARK) - 1))
        out.append(_SPARK[max(0, min(i, len(_SPARK) - 1))])
    return "".join(out)


def _bin_events(events, t_max: float, width: int):
    """events [(t, val)] -> per-bin counts over [0, t_max]."""
    bins = [0.0] * width
    for t, _ in events:
        i = int(t / t_max * width) if t_max > 0 else 0
        bins[max(0, min(i, width - 1))] += 1
    return bins


def _cohort_of(device: int, n_devices: int, n_cohorts: int) -> int:
    per = max(1, -(-n_devices // n_cohorts))     # ceil division
    return min(device // per, n_cohorts - 1)


def render(path, out=sys.stdout, *, cohorts: int = 4,
           width: int = 60) -> None:
    records = read_jsonl(path)
    meta = next((r for r in records if r.get("event") == "meta"), {})
    summaries = [r for r in records if r.get("event") == "summary"]
    ring = [r for r in records if r.get("event") in _TIMELINE_KINDS
            or r.get("event") == "reboot"]
    n_devices = int(meta.get("n_devices", 1))
    horizon = float(meta.get("horizon", 0.0)) or max(
        [r.get("t", 0.0) for r in ring] + [1.0])
    n_cohorts = max(1, min(cohorts, n_devices))

    w = out.write
    w(f"telemetry report — {meta.get('label', path)}\n")
    w(f"  devices={n_devices}  dt={meta.get('dt', '?')}  "
      f"horizon={horizon}  ring_size={meta.get('ring_size', '?')}\n")

    if summaries:
        w(f"\nper-segment trajectory ({len(summaries)} segments)\n")
        header = (f"  {'seg':>4} {'t_end':>8} {'released':>9} "
                  f"{'missed':>7} {'miss_rate':>9} {'occ':>6} "
                  f"{'energy':>9} {'pwr_fail':>8} {'knobs':>6}\n")
        w(header)
        for s in summaries:
            w(f"  {s['seg']:>4} {s['t_end']:>8.2f} {s['releases']:>9} "
              f"{s['misses']:>7} {s['miss_rate']:>9.3f} "
              f"{s['occ_mean']:>6.2f} {s['energy_mean']:>9.4f} "
              f"{s['power_fails']:>8} {s['knob_updates']:>6}\n")
        w("  miss_rate   |" + _spark(
            [s["miss_rate"] for s in summaries], lo=0.0) + "|\n")
        w("  occupancy   |" + _spark(
            [s["occ_mean"] for s in summaries], lo=0.0) + "|\n")
        w("  energy_mean |" + _spark(
            [s["energy_mean"] for s in summaries], lo=0.0) + "|\n")

        last = summaries[-1]
        hist = [0] * len(last.get("exit_hist", []))
        for s in summaries:                     # summaries are per-segment
            for i, v in enumerate(s.get("exit_hist", [])):
                hist[i] += v
        if hist:
            w("\nexit-depth histogram (retired jobs; last bin = no exit)\n")
            top = max(hist) or 1
            for i, v in enumerate(hist):
                label = f"unit {i}" if i < len(hist) - 1 else "no-exit"
                bar = "#" * int(round(40 * v / top))
                w(f"  {label:>8} {v:>8} |{bar}\n")
        dropped = sum(s.get("events_dropped", 0) for s in summaries)
        if dropped:
            w(f"\n  note: {dropped} ring events overwritten before drain "
              f"(raise TelemetryConfig.ring_size to keep them)\n")

    if ring:
        w(f"\nevent timelines — {n_cohorts} cohort(s) of "
          f"~{-(-n_devices // n_cohorts)} device(s), "
          f"{width} bins over [0, {horizon:g}]s\n")
        by_kind_cohort = defaultdict(list)
        for r in ring:
            c = _cohort_of(int(r.get("device", 0)), n_devices, n_cohorts)
            by_kind_cohort[(r["event"], c)].append(
                (float(r.get("t", 0.0)), float(r.get("val", 0.0))))
        for kind in _TIMELINE_KINDS:
            rows = [(c, by_kind_cohort.get((kind, c), []))
                    for c in range(n_cohorts)]
            if not any(ev for _, ev in rows):
                continue
            w(f"  {kind}\n")
            for c, ev in rows:
                bins = _bin_events(ev, horizon, width)
                w(f"    cohort {c:>2} ({len(ev):>5} ev) |"
                  + _spark(bins, lo=0.0) + "|\n")
    out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a telemetry JSONL stream as a text dashboard")
    ap.add_argument("path", help="telemetry .jsonl written by "
                                 "repro_torch.telemetry.TelemetryLogger")
    ap.add_argument("--cohorts", type=int, default=4,
                    help="device cohorts (contiguous index ranges)")
    ap.add_argument("--width", type=int, default=60,
                    help="timeline bins")
    args = ap.parse_args(argv)
    render(args.path, cohorts=args.cohorts, width=args.width)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
