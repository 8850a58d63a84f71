"""Zygarde core, ported: energy, policy, scheduler types, the step core,
the k-means classifier bank, the utility test and its calibration, and the
agile-DNN execution engine."""
from . import (  # noqa: F401
    agile, energy, kmeans, policy, scheduler, step, utility,
)
