"""Fleet simulator, containers and grid builders (port of
:mod:`repro.fleet`).

Public API::

    result, meta = fleet.sweep(fleet.SweepGrid(task=..., policies=(...)))
    result = fleet.simulate_fleet(cfg, statics, mode="fused")
    result = fleet.simulate_fleet_sharded(cfg, statics, mesh=mesh)
    result, carry = fleet.run_segments(cfg, statics, n_segments=8, hook=...)
    cfg, statics = fleet.from_sim_config(tasks, harv, eta, cap, sim)
"""
from .grid import (  # noqa: F401
    SweepGrid,
    as_task_set,
    build,
    device_config,
    from_sim_config,
    sample_events,
    stack_configs,
    sweep,
)
from .simulator import (  # noqa: F401
    FLEET_MODES,
    TUNABLE_FIELDS,
    finalize_fleet,
    init_fleet,
    run_segments,
    simulate_fleet,
    simulate_fleet_sharded,
)
from .state import (  # noqa: F401
    DeviceState,
    FleetConfig,
    FleetResult,
    FleetStatics,
    ServeBank,
    ServeCarry,
    ServeLog,
    pack_carry,
    unpack_carry,
)
