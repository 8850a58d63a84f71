"""Live serving (port of :mod:`repro.serve`): the scalar event-driven
engine, the vectorized fleet engine and the anytime continuous-batching
engine of the model configs."""
from .engine import (  # noqa: F401
    DynamicJobProfile,
    Request,
    ServeConfig,
    ServeEngine,
    per_task,
)
from .fleet_engine import FleetServeEngine, FleetServeResult  # noqa: F401
from .anytime import (  # noqa: F401
    AnytimeConfig,
    AnytimeKnobs,
    AnytimeRequest,
    AnytimeResult,
    AnytimeServeEngine,
    AnytimeTables,
)
