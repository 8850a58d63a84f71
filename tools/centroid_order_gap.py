"""Measure the port's centroid update against the JAX reference's sum order.

For each (clusters k, rows B) case, runs ``repro.kernels.ops.
fleet_centroid_update`` (the Pallas kernel in interpret mode on the CPU)
and the port's ``repro_torch.kernels.centroid_update`` (its plain version
on a CPU tensor) on the same inputs -- rows from [0, 100), F = 6 features,
each row assigned at random to one of the k clusters or to -1 (ignored),
weight 10, as ``tests/test_torch_models.py`` makes them -- and prints
whether they are bit-equal, the largest absolute and ulp gaps, and a hash
of the reference's result.  The reference's
one-hot matmul is a runtime call whose summation tree depends on the CPUs
the process may use once the work is large enough, so run it under
``taskset`` to compare CPU sets::

    for c in 0 0,1 0-7; do
        JAX_PLATFORMS=cpu PYTHONPATH=src taskset -c $c \\
            python tools/centroid_order_gap.py
    done

Pass ``k:B`` pairs to measure other cases (``... centroid_order_gap.py
16:1024 4:4096``).
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

DEFAULT_CASES = [(4, 2048), (4, 4096), (5, 1664), (5, 1792), (5, 1800),
                 (5, 2048), (8, 1040), (8, 1200), (8, 2048), (16, 552),
                 (16, 568), (16, 576), (16, 1024), (16, 2048)]


def _inputs(B: int, k: int, F: int = 6):
    rng = np.random.default_rng(B)
    c = rng.uniform(0, 100, (k, F)).astype(np.float32)
    x = rng.uniform(0, 100, (B, F)).astype(np.float32)
    a = rng.integers(-1, k, B).astype(np.int32)
    return c, x, a


def main(argv: list[str]) -> None:
    import torch

    from repro.kernels import ops
    from repro_torch.kernels import centroid_update as cu

    cases = ([tuple(int(v) for v in s.split(":")) for s in argv]
             or DEFAULT_CASES)
    cpus = len(os.sched_getaffinity(0))
    for k, B in cases:
        c, x, a = _inputs(B, k)
        ref = np.asarray(ops.fleet_centroid_update(c, x, a, 10.0))
        out = cu.centroid_update(*map(torch.from_numpy, (c, x, a)),
                                 10.0).numpy()
        gap = np.abs(out.astype(np.float64) - ref).max()
        ulp = np.abs(out.view(np.int32).astype(np.int64)
                     - ref.view(np.int32)).max()
        print(f"cpus={cpus} k={k} B={B} B*k={B * k} "
              f"equal={np.array_equal(out, ref)} max_abs={gap:.3g} "
              f"max_ulp={ulp} reference={hashlib.md5(ref.tobytes()).hexdigest()[:8]}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
