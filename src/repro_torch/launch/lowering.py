"""Train / prefill / decode steps counted on ``meta`` for a mesh (port of
:mod:`repro.launch.lowering`).

The reference lowers and compiles each step for its mesh and reads the
compiled program.  The port has no compiler: :func:`lower_step` runs the
step once on ``meta`` tensors (nothing is allocated or computed) under
the op counter (:mod:`repro_torch.launch.op_cost`), kernels G, H and I
and their backward kernels taking the card's route as single items.  The
counted items stand for the HLO text.

The port has no SPMD partitioner, so a mesh divides the work by the spec
tables' even split: the per-device ``op_flops`` and ``op_bytes`` are the
whole step's divided by ``mesh.size`` (``"split": "even"`` in the
record), and the collectives are the ones the step issues (none today).
One device's argument and output bytes come from the spec tables
(:func:`repro_torch.launch.op_stats.memory_record`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..configs import InputShape, ModelConfig
from ..models import transformer as tfm
from ..train.optimizer import adamw_init
from ..train.trainer import make_train_step
from .inputs import LoweringSpec, input_specs
from .mesh import Mesh
from .op_cost import Cost, Counter, top_cost_items
from .op_stats import memory_record, model_flops, roofline_terms


@dataclass
class LoweringResult:
    """``ops``: the counted items, costliest first (op or kernel, output
    type, calls, flops, bytes), the counterpart of the HLO text; ``cost``
    the whole step's; ``memory`` one device's bytes (``None`` with
    ``compile=False``)."""

    ops: list
    cost: Optional[Cost]
    spec: LoweringSpec
    mesh: Mesh
    memory: Optional[dict] = None


def step_inputs(cfg: ModelConfig, shape):
    """``(spec, params, opt_state or None)`` on ``meta``: the shape
    stand-ins, the parameters and for a train step the AdamW state (its
    step count a CPU scalar: the update reads it on the host)."""
    spec = input_specs(cfg, shape)
    params = tfm.init_params(cfg, device="meta")
    opt = None
    if spec.step_kind == "train":
        opt = adamw_init(params)._replace(
            step=torch.zeros((), dtype=torch.int32))
    return spec, params, opt


def step_fn(spec: LoweringSpec):
    """The step the input shape dictates, as ``fn(params, opt_state,
    *spec.args)``: ``make_train_step`` for train, ``prefill`` and the
    unrolled ``decode_step`` (without autograd) for serving."""
    cfg, window = spec.cfg, spec.window
    if spec.step_kind == "train":
        return make_train_step(cfg, window=window)

    @torch.no_grad()
    def serve(params, opt, *args):
        if spec.step_kind == "prefill":
            return tfm.prefill(cfg, params, args[0], window=window)
        state, token = args
        return tfm.decode_step(cfg, params, state, token, window=window,
                               unroll=True)

    return serve


def lower_step(cfg: ModelConfig, shape: str | InputShape, mesh: Mesh, *,
               compile: bool = True) -> LoweringResult:
    """Count the step ``shape`` dictates for ``cfg`` on ``mesh``: one run
    on ``meta`` under the op counter (``compile=False``: the stand-ins
    only, nothing run).  Raises :class:`~repro_torch.launch.inputs
    .ShapeSkip` for the documented skips."""
    spec, params, opt = step_inputs(cfg, shape)
    if not compile:
        return LoweringResult([], None, spec, mesh)
    with Counter(mesh.size) as counter:
        outputs = step_fn(spec)(params, opt, *spec.args)
    cost = counter.cost
    memory = memory_record(spec, mesh, params, opt, outputs)
    return LoweringResult(top_cost_items(cost, len(cost.items)), cost, spec,
                          mesh, memory)


def analyze(result: LoweringResult) -> dict:
    """Dry-run record: memory, op cost, collectives and roofline terms per
    device (the reference's record with ``hlo_*`` keys as ``op_*``)."""
    spec, mesh, cost = result.spec, result.mesh, result.cost
    n_dev = mesh.size
    flops, nbytes = cost.flops / n_dev, cost.bytes / n_dev
    terms = roofline_terms(flops=flops, bytes_accessed=nbytes,
                           ici_bytes=cost.ici_bytes,
                           tc_flops=cost.tc_flops / n_dev)
    mflops = model_flops(spec.cfg, spec.step_kind, spec.shape.global_batch,
                         spec.shape.seq_len)
    mflops_dev = mflops / n_dev
    return {
        "arch": spec.cfg.name,
        "shape": spec.shape.name,
        "step_kind": spec.step_kind,
        "window": spec.window,
        "mesh": list(mesh.shape.values()),
        "mesh_axes": list(mesh.axis_names),
        "n_devices": n_dev,
        "split": "even",
        "memory": result.memory,
        "op_flops_per_device": flops,
        "op_dot_flops_per_device": cost.dot_flops / n_dev,
        "op_dot_flops_by_dtype_per_device": {
            k: v / n_dev for k, v in cost.dot_flops_by_dtype.items()},
        "op_bytes_per_device": nbytes,
        "kernels": dict(cost.kernels),
        "collectives": {
            "ici_bytes": cost.ici_bytes,
            "counts": cost.coll_counts,
            "by_kind_bytes": cost.coll_bytes,
        },
        "roofline": terms,
        "model_flops_total": mflops,
        "model_flops_per_device": mflops_dev,
        "useful_flops_ratio": (mflops_dev / flops) if flops else 0.0,
        "params_total": spec.cfg.param_count(),
        "params_active": spec.cfg.active_param_count(),
    }
