"""The port's anytime engine against the JAX engine, bit for bit: the tiny
model of ``tests/test_anytime.py`` (weights carried over) under
``anytime``, ``edf`` and ``edf-m`` over 1 and 4 segments, and the reduced
recurrentgemma-9b (rec, rec, attn: 3 units), xlstm-125m and dbrx-132b.
The helpers, and the rest of the anytime tests, are in
``tests/test_torch_anytime.py``; these cases sit in a file of their own so
that ``pytest --dist loadfile`` runs them beside it.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_anytime as TA  # noqa: E402
from test_torch_anytime import tiny  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("n_segments", [1, 4])
@pytest.mark.parametrize("policy", ["anytime", "edf", "edf-m"])
def test_engine_matches_jax(tiny, policy, n_segments):
    je, pe = TA._engines(tiny, policy=policy)
    jreqs, preqs = TA._requests()
    jres = je.run(jreqs, n_segments=n_segments)
    pres = pe.run(preqs, n_segments=n_segments)
    assert pres.completed == len(preqs)
    TA._assert_same(jres, pres)


@pytest.mark.parametrize("policy", ["anytime", "edf", "edf-m"])
def test_hybrid_engine_matches_jax(policy):
    """The reduced recurrentgemma-9b behind the engine: admission resets a
    slot's recurrent state (``h``, the conv buffer) with its KV cache, and
    the result arrays equal the JAX engine's."""
    hybrid = TA._port_model("recurrentgemma-9b")
    je, pe = TA._engines(hybrid, policy=policy, max_steps=96)
    jreqs, preqs = TA._requests(ragged=True)
    jres, pres = je.run(jreqs), pe.run(preqs)
    assert pres.completed == len(preqs) and pres.n_units == 3
    TA._assert_same(jres, pres)


@pytest.mark.parametrize("policy", ["anytime", "edf", "edf-m"])
def test_xlstm_engine_matches_jax(policy):
    """The reduced xlstm-125m (mLSTM, sLSTM: 2 units) behind the engine:
    admission resets a slot's xLSTM cells (``m`` back to -1e30) like any
    other leaf, and the result arrays equal the JAX engine's."""
    je, pe = TA._engines(TA._port_model("xlstm-125m"), policy=policy,
                         max_steps=96)
    jreqs, preqs = TA._requests(ragged=True)
    jres, pres = je.run(jreqs), pe.run(preqs)
    assert pres.completed == len(preqs) and pres.n_units == 2
    TA._assert_same(jres, pres)


@pytest.mark.parametrize("policy", ["anytime", "edf", "edf-m"])
def test_moe_engine_matches_jax(policy):
    """The reduced dbrx-132b (2 MoE layers: 2 units) behind the engine, the
    batch slots one dispatch group per step; the result arrays equal the
    JAX engine's."""
    je, pe = TA._engines(TA._port_model("dbrx-132b"), policy=policy,
                         max_steps=96)
    jreqs, preqs = TA._requests(ragged=True)
    jres, pres = je.run(jreqs), pe.run(preqs)
    assert pres.completed == len(preqs) and pres.n_units == 2
    TA._assert_same(jres, pres)
