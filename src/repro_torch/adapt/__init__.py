"""Online policy search: closed-loop tuning of Zygarde's scheduler knobs
(port of :mod:`repro.adapt`).

The paper's headline is *adaptation* — the scheduler should fit its
energy gate (eta), optional-unit target (E_opt) and utility thresholds to
the deployment's harvesting pattern, not run fixed constants.  Offline
tuning turns the fleet simulator (:mod:`repro_torch.fleet`) into the inner
loop of a search: a candidate *population* becomes the fleet device axis,
so one fused fleet run (one launch of the ``fleet_fused_steps`` kernel on a
card) scores every candidate against every harvester pattern x seed cell::

    from repro_torch import adapt

    problem = adapt.TuneProblem(task=task, harvesters=(h1, h2, h3))
    space = adapt.SearchSpace.of(eta=(0.05, 1.0), e_opt_fraction=(0.05, 0.95))
    result = adapt.tune(problem.objective(), space, budget=256, driver="es")
    result.best_params                     # {"eta": ..., "e_opt_fraction": ...}
    problem.score(problem.default_params())  # the paper-default baseline

Drivers: ``random`` / ``grid``, ``es``, ``es-grad`` and ``cma`` — see
:mod:`repro_torch.adapt.search`.

:mod:`repro_torch.adapt.online` closes the loop *inside* a run: an
:class:`OnlineAdapter` composes controllers into a
:func:`repro_torch.fleet.run_segments` hook that rewrites the tunable
FleetConfig tensors between segments — the paper's runtime eta loop
(:class:`EtaController`) with the reactive :class:`FeedbackController` for
E_opt by default, or the anticipatory :class:`ForecastController` of
:mod:`repro_torch.adapt.forecast`, which clusters observed harvest windows
online (the ``pairwise_l1``, ``l1_topk2`` and ``centroid_update``
kernels)::

    adapter = adapt.OnlineAdapter(statics, cfg, controllers=[
        adapt.EtaController(window_s=20.0),
        adapt.ForecastController(window_s=8.0),
    ])
    res, carry = fleet.run_segments(cfg, statics, n_segments=24,
                                    hook=adapter.hook, mode="fused")

:mod:`repro_torch.adapt.anytime` tunes the anytime serving engine's knobs
(exit thresholds, the energy gate) the same way: ``anytime_space``,
``make_anytime_objective``, ``knobs_from_params``.
"""
from .anytime import (  # noqa: F401
    anytime_space,
    knobs_from_params,
    make_anytime_objective,
)
from .forecast import (  # noqa: F401
    FEATURES,
    ForecastController,
    HarvestForecaster,
    window_features,
)
from .objective import (  # noqa: F401
    PAPER_E_OPT_FRACTION,
    Objective,
    TuneProblem,
    apply_params,
)
from .online import (  # noqa: F401
    ESTIMATORS,
    Controller,
    EtaController,
    EwmaEstimator,
    FeedbackController,
    Observation,
    OnlineAdapter,
    QuantileEstimator,
    miss_rate,
    observed_eta,
    observed_supply,
    workload_demand,
)
from .search import DRIVERS, TuneResult, tune  # noqa: F401
from .space import Param, SearchSpace  # noqa: F401
