"""``telemetry=full`` through the port's anytime engine against the JAX
package on the CPU (the serve engines' telemetry is in
``tests/test_torch_telemetry_serve.py``): the result arrays equal the
plain run's and the JAX engine's, the telemetry JAX's at
``tests/test_telemetry.py``'s tolerances.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_telemetry import assert_tel_close  # noqa: E402
from test_torch_telemetry_serve import _tcfg  # noqa: E402
import test_torch_anytime as TA  # noqa: E402
from test_torch_anytime import tiny  # noqa: E402,F401
from _torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("n_segments", [1, 4])
@pytest.mark.parametrize("policy", ["anytime", "edf", "edf-m"])
def test_anytime_telemetry_matches_jax(tiny, policy, n_segments):
    """The anytime engine with ``telemetry=full`` on a charging capacitor:
    the result arrays equal the plain run's and JAX's, the telemetry
    JAX's, and the depth histogram counts every generated token."""
    je, pe = TA._engines(tiny, supply=np.full(64, 3.3), policy=policy,
                         max_steps=120, capacity=2.0, start_frac=0.5)
    jk = je.default_knobs(exit_thr=jnp.full((4,), 0.3, jnp.float32),
                          eta=0.8, e_opt_fraction=0.3)
    pk = pe.default_knobs(exit_thr=np.full((4,), 0.3, np.float32), eta=0.8,
                          e_opt_fraction=0.3)
    jreqs, preqs = TA._requests(8, gap=0.4, slack=1.2, ragged=True)
    jt, pt = _tcfg("full", 8)
    jres = je.run(jreqs, knobs=jk, telemetry=jt, n_segments=n_segments)
    pres = pe.run(preqs, knobs=pk, telemetry=pt, n_segments=n_segments)
    plain = pe.run(preqs, knobs=pk, n_segments=n_segments)
    TA._assert_same(jres, pres)
    for name in TA.RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(pres, name),
                                      getattr(plain, name), err_msg=name)
    assert plain.telemetry is None
    tel = pres.telemetry
    assert_tel_close(tel, jres.telemetry)
    assert int(tel.exit_hist.sum()) == int(pres.tokens.sum()) > 0
    assert int(tel.c_sched) == pres.on_time
    assert int(tel.c_retired) == pres.completed
    assert int(tel.n_steps) == 120
    jax.block_until_ready(jres.telemetry)
