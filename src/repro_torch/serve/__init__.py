"""Live serving (port of :mod:`repro.serve`): the vectorized fleet engine
and the anytime continuous-batching engine of the model configs."""
from .engine import Request, ServeConfig, per_task  # noqa: F401
from .fleet_engine import FleetServeEngine, FleetServeResult  # noqa: F401
from .anytime import (  # noqa: F401
    AnytimeConfig,
    AnytimeKnobs,
    AnytimeRequest,
    AnytimeResult,
    AnytimeServeEngine,
    AnytimeTables,
)
