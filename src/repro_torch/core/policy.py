"""Scheduler policy/priority logic as pure tensor functions (paper Eqs. 6-7).

Port of :mod:`repro.core.policy`.  The priority functions use only
arithmetic and comparisons (booleans are blended by multiplication) on
tensors; :func:`policy_scores` is the batched form the step core calls
with ``(..., Q)`` queue tensors.  Larger score = higher priority
everywhere; EDF-style "earliest wins" keys are negated deadlines.

Numerics: three multiply-adds are one f32 rounding, as the compiled
reference forms them (:mod:`repro_torch.core._fma`): ``1 - alpha *
laxity``, ``1 - beta * utility`` and the EDF key's ``deadline + 1e-9 *
release``.  Every other product and sum is its own rounding (the CUDA
kernels build with ``-fmad=false``).  ``jnp.select`` becomes nested
:func:`torch.where`.
"""
from __future__ import annotations

import torch

from ._fma import fma_f32

# Policy identifiers shared by the scalar and fleet paths.
POLICY_IDS = {"zygarde": 0, "edf": 1, "edf-m": 2, "rr": 3}
IMPRECISE_POLICIES = ("zygarde", "edf-m")   # early exit enabled

# Sentinel for "never schedulable".
NEG = -1e30

# Deadline ties are broken by release order at a scale far below any
# deadline difference.
_TIE = 1e-9

# Round-robin task rotation weight: the rotation distance of a slot's task
# from the per-device cursor dominates the within-task FIFO release key.
RR_TASK_W = 1e4


def _num(x):
    """Booleans blend as 0/1 f32 (python bools and bool tensors alike)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bool:
        return x.to(torch.float32)
    return 1.0 * x


def exit_test(margin, threshold):
    """The utility test (paper §4.1): exit when the classifier margin clears
    the per-unit threshold (strict ``>``)."""
    return margin > threshold


def _base(laxity, utility, alpha, beta):
    """``(1 - alpha * laxity) + (1 - beta * utility)``, each term one
    rounding."""
    return fma_f32(-alpha, laxity, 1.0) + fma_f32(-beta, utility, 1.0)


def zeta_priority(laxity, utility, mandatory, alpha, beta):
    """Eq. 6 (continuous power): dynamic priority zeta."""
    gamma = _num(mandatory)
    return _base(laxity, utility, alpha, beta) + gamma


def zeta_intermittent_priority(laxity, utility, mandatory, alpha, beta,
                               eta, energy, e_opt):
    """Eq. 7 (intermittent power): the eta-weighted energy gate zeroes the
    priority of optional units while the store is below E_opt."""
    base = _base(laxity, utility, alpha, beta)
    gamma = _num(mandatory)
    gate = _num(eta * energy >= e_opt)
    return gate * (base + gamma) + (1.0 - gate) * gamma * base


def edf_key(deadline, release):
    """Earliest-deadline-first as a max-score key (release breaks ties)."""
    return -fma_f32(_TIE, release, deadline)


def edfm_key(deadline, release, mandatory):
    """EDF over mandatory units only: optional work is never schedulable."""
    m = _num(mandatory)
    return m * edf_key(deadline, release) + (1.0 - m) * NEG


def rr_key(release, task_rank=0.0):
    """Round-robin at unit granularity: rotate across tasks, FIFO-by-release
    within a task (``task_rank`` = ``(task - cursor) mod K``)."""
    return -(task_rank * RR_TASK_W + release)


def policy_scores(policy_id, active, laxity, release, utility, mandatory,
                  alpha, beta, eta, energy, e_opt, persistent,
                  task_rank=0.0):
    """Batched score matrix + validity threshold for every policy.

    Queue-shaped args (``active`` .. ``mandatory``, ``task_rank``) carry a
    trailing queue axis; per-device args (``policy_id`` .. ``persistent``)
    broadcast against them (callers pass ``x[..., None]`` shapes).  Returns
    ``(scores, threshold)``: pick ``argmax(scores)`` and treat the device as
    idle when ``max(scores) <= threshold``.
    """
    zyg = torch.where(
        persistent.to(torch.bool),
        zeta_priority(laxity, utility, mandatory, alpha, beta),
        zeta_intermittent_priority(laxity, utility, mandatory, alpha, beta,
                                   eta, energy, e_opt),
    )
    edf = edf_key(laxity, release)
    edfm = edfm_key(laxity, release, mandatory)
    rr = rr_key(release, task_rank)
    scores = torch.where(
        policy_id == 0, zyg,
        torch.where(policy_id == 1, edf,
                    torch.where(policy_id == 2, edfm, rr)))
    scores = torch.where(active.to(torch.bool), scores,
                         torch.full_like(scores, NEG))
    # zygarde idles when even the best score is <= 0 (energy-gated optional
    # work); the deadline-keyed policies only idle on an empty queue.
    threshold = torch.where(
        policy_id == 0,
        torch.zeros((), dtype=torch.float32, device=scores.device),
        torch.full((), 0.5 * NEG, dtype=torch.float32, device=scores.device))
    return scores, threshold
