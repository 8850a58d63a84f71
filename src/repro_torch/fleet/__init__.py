"""Fleet containers and grid builders (port of :mod:`repro.fleet`; the
replay simulator comes with a later slice)."""
from .grid import (  # noqa: F401
    as_task_set,
    device_config,
    sample_events,
    stack_configs,
)
from .simulator import finalize_fleet  # noqa: F401
from .state import (  # noqa: F401
    DeviceState,
    FleetConfig,
    FleetResult,
    FleetStatics,
    ServeBank,
    ServeCarry,
    ServeLog,
)
