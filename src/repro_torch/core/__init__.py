"""Zygarde core, ported: energy, policy, the scheduler and its
event-driven simulator, the step core, the k-means classifier bank, the
utility test and its calibration, the agile-DNN execution engine and the
intermittent fragment substrate."""
from . import (  # noqa: F401
    agile, energy, intermittent, kmeans, policy, scheduler, step, utility,
)
