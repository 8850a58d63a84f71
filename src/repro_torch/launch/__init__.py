"""Launch drivers (port of :mod:`repro.launch`): the LM training CLI
(:mod:`repro_torch.launch.train`) and the serving CLI
(:mod:`repro_torch.launch.serve`), both on the CUDA card or on the CPU
under ``--device cpu``; the meshes and their logical-axis rules
(:mod:`repro_torch.launch.mesh`), the spec tables and the placement over a
mesh (:mod:`repro_torch.launch.sharding`), the shape stand-ins of every
model input (:mod:`repro_torch.launch.inputs`); the op-level cost model
(:mod:`repro_torch.launch.op_cost`), the H100 roofline terms
(:mod:`repro_torch.launch.op_stats`), steps counted on ``meta``
(:mod:`repro_torch.launch.lowering`), the multi-pod dry run
(:mod:`repro_torch.launch.dryrun`) and the profiling harness
(:mod:`repro_torch.launch.profiling`)."""
from __future__ import annotations

import sys

import torch


def resolve_device(name: str, prog: str) -> torch.device:
    """``--device`` as a ``torch.device``; without a CUDA card a ``cuda``
    device ends the program with a message that says so (there is no CPU
    fallback: ``--device cpu`` asks for the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA card is visible; the port's kernels run "
                 f"on an H100 (pass --device cpu to run on the CPU)")
    return device
