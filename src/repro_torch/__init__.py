"""PyTorch/CUDA port of the Zygarde reproduction (``repro``).

The JAX package :mod:`repro` is the reference; this package mirrors its
subpackage and module names so each counterpart is easy to find, imports
only ``torch`` and ``numpy``, and runs its hot path through hand-written
CUDA kernels for Hopper (``sm_90a``) under :mod:`repro_torch.kernels`.

Every entry point takes an explicit ``device`` (default ``"cuda"``); a
wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor — there is no environment switch.

This slice ports live fleet serving: the device-step core, the k-means
classifier bank, the paper's agile CNNs and
:class:`repro_torch.serve.fleet_engine.FleetServeEngine` (scan and fused
modes), with the kernels ``l1_topk2``, ``centroid_update`` and
``serve_fused_steps``.
"""
