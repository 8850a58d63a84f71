"""Carry weights and state from the JAX package into the port.

Every function takes plain numpy data — dicts, tuples or NamedTuples whose
leaves are numpy arrays (``jax.tree.map(np.asarray, obj)`` of a JAX object,
or anything laid out the same way) — and returns the port's tensors on
``device``.  Nothing here imports JAX.  Dtypes are kept as they come
(``float32``, ``int32``, ``bool``), so a converted pytree computes exactly
what the JAX one does.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.kmeans import UnitClassifier
from .core.step import DeviceCarry, StepParams
from .fleet.state import ServeBank, ServeCarry, ServeLog
from .serve.fleet_engine import ServeTables
from .telemetry.state import Telemetry


def tensor(a, device="cuda") -> torch.Tensor:
    """One numpy array (or scalar) as a tensor of the same dtype; a
    bfloat16 array (``ml_dtypes``, as JAX hands it to numpy) goes through
    its bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _fields(obj, names: Sequence[str]) -> list:
    if isinstance(obj, dict):
        return [obj[n] for n in names]
    if hasattr(obj, "_asdict"):
        d = obj._asdict()
        return [d[n] for n in names]
    if len(obj) != len(names):
        raise ValueError(f"expected {len(names)} leaves, got {len(obj)}")
    return list(obj)


def named_tuple(cls, obj, device="cuda"):
    """Any of the port's flat NamedTuples (``StepParams``, ``DeviceCarry``,
    ``ServeBank``, ``ServeLog``, ``ServeTables``) from numpy leaves, matched
    by field name (dicts, NamedTuples) or by position (plain tuples)."""
    return cls(*[tensor(v, device) for v in _fields(obj, cls._fields)])


def step_params(obj, device="cuda") -> StepParams:
    return named_tuple(StepParams, obj, device)


def device_carry(obj, device="cuda") -> DeviceCarry:
    return named_tuple(DeviceCarry, obj, device)


def serve_tables(obj, device="cuda") -> ServeTables:
    return named_tuple(ServeTables, obj, device)


def serve_carry(obj, device="cuda") -> ServeCarry:
    """A ``ServeCarry`` of ``(dev, bank, log)`` numpy pytrees."""
    dev, bank, log = _fields(obj, ServeCarry._fields)
    return ServeCarry(dev=device_carry(dev, device),
                      bank=named_tuple(ServeBank, bank, device),
                      log=named_tuple(ServeLog, log, device))


def telemetry(obj, device="cuda") -> Telemetry:
    """A :class:`repro_torch.telemetry.Telemetry` from numpy leaves (a JAX
    run's ``jax.tree.map(np.asarray, tel)``, a dict, or anything laid out
    the same way), e.g. to resume a JAX run's ``telemetry_carry``."""
    return named_tuple(Telemetry, obj, device)


def to_numpy(obj) -> dict:
    """A NamedTuple of tensors (a port ``Telemetry``, carry, ...) as a dict
    of numpy arrays by field name, the way back to the JAX package:
    ``repro.telemetry.Telemetry(**to_numpy(tel))``."""
    return {k: v.detach().cpu().numpy() for k, v in obj._asdict().items()}


def cnn_params(params: dict, device="cuda") -> dict:
    """The reference CNN's parameter dict: conv weights HWIO -> OIHW; FC
    weights stay ``(in, out)`` (their input index is NHWC-flattened in
    both packages)."""
    return {
        "convs": [{"w": tensor(np.transpose(np.asarray(p["w"], np.float32),
                                            (3, 2, 0, 1)), device),
                   "b": tensor(np.asarray(p["b"], np.float32), device)}
                  for p in params["convs"]],
        "fcs": [{"w": tensor(np.asarray(p["w"], np.float32), device),
                 "b": tensor(np.asarray(p["b"], np.float32), device)}
                for p in params["fcs"]],
    }


def cnn_params_to_reference(params: dict) -> dict:
    """The inverse of :func:`cnn_params`: the port's CNN parameters as the
    reference's numpy pytree (conv weights OIHW -> HWIO)."""
    def arr(t):
        return t.detach().cpu().numpy()

    return {
        "convs": [{"w": np.ascontiguousarray(np.transpose(arr(p["w"]),
                                                          (2, 3, 1, 0))),
                   "b": arr(p["b"])} for p in params["convs"]],
        "fcs": [{"w": arr(p["w"]), "b": arr(p["b"])} for p in params["fcs"]],
    }


def tree(obj, device="cuda"):
    """Dicts, tuples and lists of numpy leaves (or tensors) as the same
    structure of tensors on ``device`` (tuples stay tuples)."""
    if isinstance(obj, dict):
        return {k: tree(v, device) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree(v, device) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return tensor(obj, device)


def transformer_params(params, device="cuda") -> dict:
    """The reference transformer's parameter pytree (``embed``, ``layers``
    with its stacked ``stack`` and its ``rem`` blocks, ``final_norm``,
    ``lm_head``; an MoE block's ``moe`` with its f32 ``router``, an xLSTM
    block's ``cell`` with its f32 gates, an encoder-decoder's ``enc`` and
    ``frontend_proj``) as the port's: the same nested dicts and tuples,
    every leaf a tensor of the same dtype and layout (bf16 leaves arrive as
    ``ml_dtypes.bfloat16`` numpy arrays and become ``torch.bfloat16``).  A
    decode state converts with :func:`tree` too: an xLSTM cell stays a
    tuple, an encoder-decoder's ``enc_out`` and ``xk``/``xv`` carry
    over."""
    return tree(params, device)


def adamw_state(obj, device="cuda"):
    """A reference ``AdamWState(step, mu, nu)`` (its numpy leaves) as the
    port's :class:`repro_torch.train.AdamWState`; ``mu`` and ``nu`` keep
    the params' tree, as :func:`transformer_params` or :func:`cnn_params`
    lays it out (a CNN's moments of conv weights go OIHW like the
    weights: pass them through :func:`cnn_params` first)."""
    from .train.optimizer import AdamWState

    step, mu, nu = _fields(obj, AdamWState._fields)
    return AdamWState(tensor(np.asarray(step, np.int32), device),
                      tree(mu, device), tree(nu, device))


def unit_classifier(obj, device="cuda") -> UnitClassifier:
    """One unit's classifier (centroids, labels, feature_idx, counts,
    threshold)."""
    return named_tuple(UnitClassifier, obj, device)


def bank(objs, device="cuda") -> list[UnitClassifier]:
    """A model's per-unit classifier bank."""
    return [unit_classifier(o, device) for o in objs]
