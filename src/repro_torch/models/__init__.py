"""The paper's agile CNNs (port of :mod:`repro.models.cnn`)."""
from . import cnn  # noqa: F401
