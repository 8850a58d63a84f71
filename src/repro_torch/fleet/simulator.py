"""Fleet finalisation (port of the part of :mod:`repro.fleet.simulator`
that live serving needs).  The replay simulator (``simulate_fleet``,
``run_segments`` and its fused kernel) is not part of this slice."""
from __future__ import annotations

from ..core import step as S
from .state import DeviceState, FleetConfig, FleetResult, FleetStatics


def finalize_fleet(cfg: FleetConfig, states: DeviceState,
                   statics: FleetStatics, live: bool = False) -> FleetResult:
    """Flush the carry into a :class:`FleetResult` — the step core's
    batch-polymorphic :func:`repro_torch.core.step.finalize` over the
    device axis.  ``live`` counts correctness from the live registers."""
    return S.finalize(cfg, states, statics, live)
