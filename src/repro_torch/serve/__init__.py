"""Live serving (port of :mod:`repro.serve`): the vectorized fleet engine."""
from .engine import Request, ServeConfig, per_task  # noqa: F401
from .fleet_engine import FleetServeEngine, FleetServeResult  # noqa: F401
