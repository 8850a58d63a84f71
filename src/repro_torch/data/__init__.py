"""Synthetic datasets and the input pipeline (port of :mod:`repro.data`)."""
from .pipeline import batches, siamese_batches  # noqa: F401
from .synthetic import (Dataset, make_dataset, make_lm_tokens,  # noqa: F401
                        make_siamese_pairs, make_token_dataset)
