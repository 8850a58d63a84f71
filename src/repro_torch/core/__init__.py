"""Zygarde core, ported: energy, policy, scheduler types, the step core,
the k-means classifier bank and the agile-DNN execution engine."""
from . import agile, energy, kmeans, policy, scheduler, step  # noqa: F401
