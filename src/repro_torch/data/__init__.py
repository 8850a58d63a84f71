"""Synthetic datasets (port of :mod:`repro.data.synthetic`)."""
from .synthetic import Dataset, make_dataset  # noqa: F401
