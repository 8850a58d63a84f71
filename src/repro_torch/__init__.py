"""PyTorch/CUDA port of the Zygarde reproduction (``repro``).

The JAX package :mod:`repro` is the reference; this package mirrors its
subpackage and module names so each counterpart is easy to find, imports
only ``torch`` and ``numpy``, and runs its hot path through hand-written
CUDA kernels for Hopper (``sm_90a``) under :mod:`repro_torch.kernels`.

Every entry point takes an explicit ``device`` (default ``"cuda"``); a
wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor — there is no environment switch.

Ported so far: the device-step core, the event-driven scheduler loop
:func:`repro_torch.core.scheduler.simulate` and its fixed-step sibling
``simulate_stepped``; the intermittent fragment substrate
(:mod:`repro_torch.core.intermittent`); the replay fleet simulator
(:mod:`repro_torch.fleet`: ``sweep``, ``simulate_fleet`` and
``run_segments`` in the ``vmap``, ``pallas`` and ``fused`` modes); live
serving of the paper's agile CNNs with the k-means classifier bank, on one
device (:class:`repro_torch.serve.engine.ServeEngine`) and across a fleet
(:class:`repro_torch.serve.fleet_engine.FleetServeEngine`: ``run`` and the
O(chunk) ``run_stream``, scan and fused modes); online adaptation (:mod:`repro_torch.adapt`: offline tuning with
``TuneProblem`` and ``tune``, the runtime eta/E_opt loop of
``OnlineAdapter`` and the harvest forecaster); the model configs
(:mod:`repro_torch.configs`) and anytime serving of every one of them
(:mod:`repro_torch.models.transformer`, :mod:`repro_torch.models.moe`,
:mod:`repro_torch.models.rglru`, :mod:`repro_torch.models.xlstm`,
:mod:`repro_torch.models.anytime`,
:class:`repro_torch.serve.anytime.AnytimeServeEngine`); telemetry
(:mod:`repro_torch.telemetry`: the ``telemetry=`` of ``simulate_fleet``,
``run_segments``, ``FleetServeEngine.run``/``run_stream``,
``OnlineAdapter.hook`` and ``AnytimeServeEngine``); training
(:mod:`repro_torch.train`: AdamW, checkpoints, ``train_agile_cnn`` and the
LM step, with :mod:`repro_torch.core.losses` and the data pipeline).
Kernels: ``fleet_priority``, ``fleet_fused_steps``, ``serve_fused_steps``,
``l1_topk2``, ``centroid_update``, ``pairwise_l1``, ``flash_attention``,
``decode_gqa`` and ``rglru_scan``, and the backward kernels
``flash_attention_bwd`` and ``rglru_scan_bwd``.
"""
from . import adapt  # noqa: F401
from . import telemetry  # noqa: F401
