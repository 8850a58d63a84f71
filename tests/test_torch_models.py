"""The port's agile CNNs, k-means bank and the plain versions of its two
k-means kernels (``l1_topk2``, ``centroid_update``) against the JAX package.

Inputs are numpy arrays made from a seed and handed to both packages.  CNN
features are held to ``rtol=1e-5, atol=1e-5``: an f32 convolution or matmul
sums in another order in each framework.  Everything else is bit-equal: the
L1 distances take the reference's own summation order.  The kernels
themselves are held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import kmeans as JK
from repro.core.agile import AgileCNN as JAgileCNN
from repro.kernels import ops as JO
from repro.models import cnn as JC

from repro_torch import convert
from repro_torch.core import kmeans as PK
from repro_torch.core.agile import AgileCNN
from repro_torch.kernels import centroid_update as PCU
from repro_torch.kernels import l1_topk2 as PL1
from repro_torch.kernels import ops as PO
from repro_torch.models import cnn as PC

from _subproc import sub_env
from _torch_threads import one_torch_thread  # noqa: F401

TINY = ("tiny", (16, 16, 1), ((4, 5, True), (8, 5, True)), (16,), 3)
CNN_TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint8) if a.dtype != np.bool_ else a


def _cnn(name, seed=0):
    jcfg = JC.CNNConfig(*TINY) if name == "tiny" else JC.PAPER_CNNS[name]
    pcfg = PC.CNNConfig(*TINY) if name == "tiny" else PC.PAPER_CNNS[name]
    params = JC.init_cnn_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, pcfg, params, convert.cnn_params(
        jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("name,batch", [("tiny", 5), ("mnist", 4)])
def test_cnn_unit_forward_matches_jax(name, batch):
    jcfg, pcfg, params, pparams = _cnn(name)
    x = np.random.default_rng(1).normal(
        size=(batch,) + jcfg.input_shape).astype(np.float32)
    hj, hp = jnp.asarray(x), torch.from_numpy(x)
    for u in range(jcfg.n_units):
        hj, fj = JC.cnn_unit_forward(jcfg, params, hj, u)
        hp, fp = PC.cnn_unit_forward(pcfg, pparams, hp, u)
        assert fp.dtype == torch.float32 and fp.shape == fj.shape
        np.testing.assert_allclose(fp.numpy(), np.asarray(fj), **CNN_TOL,
                                   err_msg=f"unit {u}")
        assert tuple(hp.shape) == tuple(hj.shape)


def test_cnn_features_are_nhwc_flattened():
    """Unit-0 features flatten the pooled NHWC activation, channel
    fastest: feature ``(h * W + w) * C + c`` is channel ``c`` at
    ``(h, w)`` of the conv output."""
    _, pcfg, _, pparams = _cnn("tiny")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2,) + pcfg.input_shape).astype(np.float32))
    act, feat = PC.cnn_unit_forward(pcfg, pparams, x, 0)
    B, H, W, C = act.shape
    assert (H, W, C) == (8, 8, 4)
    ref = torch.nn.functional.max_pool2d(torch.relu(torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), pparams["convs"][0]["w"],
        pparams["convs"][0]["b"], padding=2)), 2)          # NCHW
    for h, w, c in [(0, 0, 1), (3, 5, 2), (7, 7, 3)]:
        assert torch.equal(feat[:, (h * W + w) * C + c], ref[:, c, h, w])


def _feats(seed, n, dims):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.int32)
    feats = [(rng.normal(size=(n, d)) + 2.0 * y[:, None] * (
        rng.random(d) < 0.3)).astype(np.float32) for d in dims]
    return feats, y


def test_select_k_best_and_fit_match_jax():
    feats, y = _feats(0, 60, (256, 40))
    for f in feats:
        np.testing.assert_array_equal(PK.select_k_best(f, y, 30),
                                      JK.select_k_best(f, y, 30))
        pj = JK.fit_unit_classifier(f, y, n_sel=30, threshold=0.07, seed=3)
        pp = PK.fit_unit_classifier(f, y, n_sel=30, threshold=0.07, seed=3,
                                    device="cpu")
        for fld, a, b in zip(pp._fields, pp, pj):
            assert a.numpy().dtype == np.asarray(b).dtype, fld
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                          err_msg=fld)


def test_classify_adapt_propagate_match_jax():
    """kmeans.classify (kernel D's plain version), adapt (kernel E's) and
    propagate on a fitted bank, one sample as the serving path runs it."""
    jcfg, pcfg, params, pparams = _cnn("tiny")
    x = np.random.default_rng(3).normal(size=(40, 16, 16, 1)).astype(
        np.float32)
    y = (np.arange(40) % 3).astype(np.int32)
    fj = [np.array(f) for f in JC.cnn_forward_all(jcfg, params,
                                                   jnp.asarray(x))]
    bank = JK.fit_bank(fj, y, thresholds=[0.02] * 3)
    pbank = convert.bank([jax.tree.map(np.asarray, uc) for uc in bank],
                         "cpu")
    for u, (uc, pu) in enumerate(zip(bank, pbank)):
        rj = JK.classify(uc, jnp.asarray(fj[u]))
        rp = PK.classify(pu, torch.from_numpy(fj[u]))
        for a, b in zip(rp, rj):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # adapt unit 0 with one sample, then propagate to unit 1
    one = fj[0][:1]
    _, _, _, idx, _ = JK.classify(bank[0], jnp.asarray(one))
    aj = JK.adapt(bank[0], jnp.asarray(one), idx)
    ap = PK.adapt(pbank[0], torch.from_numpy(one),
                  torch.from_numpy(np.array(idx)))
    np.testing.assert_array_equal(ap.centroids.numpy(),
                                  np.asarray(aj.centroids))
    np.testing.assert_array_equal(ap.counts.numpy(), np.asarray(aj.counts))
    jm = JAgileCNN(jcfg, params, bank)
    pm = AgileCNN(pcfg, pparams, pbank)
    pj = JK.propagate(aj, bank[1], lambda f: jm.unit_apply_flat(1, f), idx)
    pp = PK.propagate(ap, pbank[1], lambda f: pm.unit_apply_flat(1, f),
                      torch.from_numpy(np.array(idx)))
    np.testing.assert_allclose(pp.centroids.numpy(),
                               np.asarray(pj.centroids), **CNN_TOL)


def _tiny_agile(n=40, seed=3):
    """The tiny CNN in both packages, with one bank fitted by the JAX
    package on its features and converted; plus the inputs it was fit on."""
    jcfg, pcfg, params, pparams = _cnn("tiny")
    x = np.random.default_rng(seed).normal(size=(n, 16, 16, 1)).astype(
        np.float32)
    y = (np.arange(n) % 3).astype(np.int32)
    fj = [np.array(f) for f in JC.cnn_forward_all(jcfg, params,
                                                   jnp.asarray(x))]
    bank = JK.fit_bank(fj, y, thresholds=[0.02] * 3)
    pbank = convert.bank([jax.tree.map(np.asarray, uc) for uc in bank],
                         "cpu")
    return (JAgileCNN(jcfg, params, bank), AgileCNN(pcfg, pparams, pbank),
            x, y, fj)


def test_classify_batch_and_bank_accuracy_match_jax():
    """kmeans.classify_batch on a fleet-shaped batch against a raw table
    (idx, d1, d2, margin bit-equal) and bank_accuracy on the same features
    (equal)."""
    jm, pm, _, y, fj = _tiny_agile()
    for u, f in enumerate(fj):
        table = np.array(jm.bank[u].centroids)
        xb = f[:36].reshape(4, 9, f.shape[1])
        ref = JK.classify_batch(jnp.asarray(table), jnp.asarray(xb))
        out = PK.classify_batch(torch.from_numpy(table),
                                torch.from_numpy(xb))
        for name, a, b in zip(("idx", "d1", "d2", "margin"), out, ref):
            assert tuple(a.shape) == (4, 9), name
            assert a.numpy().dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b),
                                          err_msg=f"unit {u} {name}")
    assert PK.bank_accuracy(pm.bank, fj, y) == JK.bank_accuracy(jm.bank, fj,
                                                                y)


def test_profile_batch_matches_jax():
    """AgileCNN.profile_batch on inputs neither bank was fit on: passes and
    correctness exact, margins within the CNN tolerance (each package
    computes its own features)."""
    jm, pm, _, _, _ = _tiny_agile()
    x = np.random.default_rng(8).normal(size=(24, 16, 16, 1)).astype(
        np.float32)
    y = (np.arange(24) % 3).astype(np.int32)
    pj = jm.profile_batch(jnp.asarray(x), y)
    pp = pm.profile_batch(x, y)
    assert len(pp) == len(pj) == 24
    for i, (a, b) in enumerate(zip(pp, pj)):
        np.testing.assert_array_equal(a.passes, b.passes, err_msg=str(i))
        np.testing.assert_array_equal(a.correct, b.correct, err_msg=str(i))
        np.testing.assert_allclose(a.margins, b.margins, **CNN_TOL,
                                   err_msg=str(i))


@pytest.mark.parametrize("adapt,budget", [(True, None), (False, 2)])
def test_infer_matches_jax(adapt, budget):
    """AgileCNN.infer over a stream of single inputs, the bank adapting and
    propagating between them: every discrete outcome exact, margins and the
    evolving centroids within the CNN tolerance, counts exact."""
    jm, pm, _, _, _ = _tiny_agile()
    x = np.random.default_rng(11).normal(size=(12, 16, 16, 1)).astype(
        np.float32)
    exits = 0
    for i in range(len(x)):
        rj = jm.infer(jnp.asarray(x[i]), adapt=adapt, unit_budget=budget)
        rp = pm.infer(x[i], adapt=adapt, unit_budget=budget)
        for f in ("prediction", "exit_unit", "units_executed", "adapted"):
            assert getattr(rp, f) == getattr(rj, f), (i, f)
        np.testing.assert_allclose(rp.margin, rj.margin, **CNN_TOL)
        exits += rj.exit_unit >= 0
    assert exits > 0
    for u, (a, b) in enumerate(zip(pm.bank, jm.bank)):
        np.testing.assert_allclose(a.centroids.numpy(),
                                   np.asarray(b.centroids), **CNN_TOL,
                                   err_msg=f"unit {u}")
        np.testing.assert_array_equal(a.counts.numpy(), np.asarray(b.counts),
                                      err_msg=f"unit {u}")


L1_CASES = [(1, 1, 1), (7, 33, 3), (50, 150, 5), (13, 257, 4), (9, 1025, 2),
            (5, 8193, 5), (64, 31, 8), (250, 150, 5)]


def _l1_inputs(B, d, k, seed=0):
    rng = np.random.default_rng(seed + B * 7 + d)
    x = (rng.normal(size=(B, d)) * rng.uniform(0.1, 30)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    c[0] = x[0]                 # an identical point: d1 == 0
    if k > 2:
        c[2] = c[1]             # a tie between two centroids
    return x, c


@pytest.mark.parametrize("B,d,k", L1_CASES)
def test_l1_topk2_plain_matches_jax(B, d, k):
    """The plain version vs the Pallas kernel (interpret mode): d1, d2 and
    idx bit-equal, odd sizes, ties (first index) and an identical point."""
    x, c = _l1_inputs(B, d, k)
    ref = JO.l1_topk2(x, c)
    out = PL1.l1_topk2(torch.from_numpy(x), torch.from_numpy(c))
    for a, b in zip(out, ref):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_l1_topk2_per_row_centroids():
    """One centroid set per row (the serve scan's shape) == row by row."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 70)).astype(np.float32)
    c = rng.normal(size=(6, 4, 70)).astype(np.float32)
    d1, d2, idx = PL1.l1_topk2(torch.from_numpy(x), torch.from_numpy(c))
    for b in range(6):
        r = JO.l1_topk2(x[b:b + 1], c[b])
        for a, e in zip((d1[b:b + 1], d2[b:b + 1], idx[b:b + 1]), r):
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(e))


@pytest.mark.parametrize("B,d,k", [(8, 300, 5), (64, 8192, 5), (3, 17, 4)])
def test_centroid_update_plain_matches_jax(B, d, k):
    """At most one row per cluster (the serve path), several rows per
    cluster, an empty cluster and ignored (``< 0``) rows: bit-equal."""
    rng = np.random.default_rng(B + d)
    c = rng.normal(size=(k, d)).astype(np.float32)
    x = rng.normal(size=(B, d)).astype(np.float32)
    one = np.where(np.arange(B) < k, np.arange(B), -1).astype(np.int32)
    rng.shuffle(one)
    ref = np.asarray(JO.fleet_centroid_update(c, x, one, 32.0))
    out = PCU.centroid_update(torch.from_numpy(c), torch.from_numpy(x),
                              torch.from_numpy(one), 32.0).numpy()
    np.testing.assert_array_equal(out, ref)
    many = rng.integers(-1, k - 1, B).astype(np.int32)  # cluster k-1 empty
    ref = np.asarray(JO.fleet_centroid_update(c, x, many, 32.0))
    out = PCU.centroid_update(torch.from_numpy(c), torch.from_numpy(x),
                              torch.from_numpy(many), 32.0).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[k - 1], ref[k - 1])


def _cu_inputs(B, k=4, F=6, seed=None):
    """Rows from [0, 100), ignored rows (-1) and weight 10 (``w * c``
    rounds, so the reference's fused multiply-add shows)."""
    rng = np.random.default_rng(B if seed is None else seed)
    c = rng.uniform(0, 100, (k, F)).astype(np.float32)
    x = rng.uniform(0, 100, (B, F)).astype(np.float32)
    a = rng.integers(-1, k, B).astype(np.int32)
    return c, x, a


@pytest.mark.parametrize("B", [392, 400, 448, 500, 512, 600, 768, 1000,
                               1024, 2048])
def test_centroid_update_plain_row_order_matches_jax(B):
    """Beyond 384 rows the reference's one-hot matmul sums a cluster's rows
    in blocks (``row_blocks``): bit-equal at k = 4, F = 6."""
    c, x, a = _cu_inputs(B)
    ref = np.asarray(JO.fleet_centroid_update(c, x, a, 10.0))
    out = PCU.centroid_update(*map(torch.from_numpy, (c, x, a)), 10.0)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("k,B", [(5, 1664), (8, 1040), (16, 552)])
def test_centroid_update_plain_row_order_wider_k_matches_jax(k, B):
    """More clusters at the largest row counts where the reference's sum
    order does not depend on the CPUs the process may use (B * k below
    about 8,900; measured on 1, 2 and 8 CPUs): bit-equal."""
    c, x, a = _cu_inputs(B, k=k)
    ref = np.asarray(JO.fleet_centroid_update(c, x, a, 10.0))
    out = PCU.centroid_update(*map(torch.from_numpy, (c, x, a)), 10.0)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_centroid_update_plain_fleet_windows_match_jax():
    """The forecaster's fleet shape: (D, W, F) windows flattened to rows,
    k = 4 clusters (256 x 3 = 768 rows, two blocks)."""
    rng = np.random.default_rng(17)
    D, W, F, k = 256, 3, 6, 4
    c = rng.uniform(0, 1, (k, F)).astype(np.float32)
    x = rng.uniform(0, 1, (D, W, F)).astype(np.float32)
    a = rng.integers(-1, k, (D, W)).astype(np.int32)
    ref = np.asarray(JO.fleet_centroid_update(c, x, a, 7.0))
    out = PCU.centroid_update(torch.from_numpy(c),
                              torch.from_numpy(x.reshape(-1, F)),
                              torch.from_numpy(a.reshape(-1)), 7.0)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_centroid_update_plain_4096_rows_within_jax_tolerance():
    """At 4,096 rows the reference's sum order depends on the CPUs the
    process may use (measured on 8 CPUs: the same inputs summed under
    ``taskset -c 0``, ``0,1``, ``0-3`` and ``0-7`` gave different trees:
    14 sequential blocks of 296/272 rows on one CPU, halves joined in a
    tree on more), so it is no fixed function of its inputs; held at the
    JAX suite's own rtol = atol = 1e-5 (``test_centroid_update_sweep``)."""
    c, x, a = _cu_inputs(4096)
    ref = np.asarray(JO.fleet_centroid_update(c, x, a, 10.0))
    out = PCU.centroid_update(*map(torch.from_numpy, (c, x, a)), 10.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


#: (k, rows) where the reference's sum order depends on the CPU set (B * k
#: past ~8,900 on 8 CPUs, and k = 4 at 4,096 rows)
WIDE_K = [(4, 4096), (5, 1792), (5, 1800), (5, 2048), (8, 1200), (8, 2048),
          (16, 568), (16, 576), (16, 1024), (16, 2048)]

_PINNED = """
import os, sys
os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
import numpy as np
from repro.kernels import ops
data = np.load(sys.argv[1])
out = {}
for key in sorted({k.split("_")[0] for k in data.files}):
    out[key] = np.asarray(ops.fleet_centroid_update(
        data[key + "_c"], data[key + "_x"], data[key + "_a"], 10.0))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def single_cpu_reference(tmp_path_factory):
    """The reference's centroid update at every ``WIDE_K`` case, computed in
    one subprocess that may use one CPU only (its affinity set before JAX
    is imported, so the runtime's thread pool has one thread)."""
    tmp = tmp_path_factory.mktemp("centroid_order")
    inputs = {}
    for k, B in WIDE_K:
        c, x, a = _cu_inputs(B, k=k)
        inputs.update({f"k{k}B{B}_c": c, f"k{k}B{B}_x": x,
                       f"k{k}B{B}_a": a})
    src, dst = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(src, **inputs)
    subprocess.run([sys.executable, "-c", _PINNED, str(src), str(dst)],
                   env=sub_env(), check=True, timeout=600)
    with np.load(dst) as ref:
        return {key: ref[key] for key in ref.files}


@pytest.mark.parametrize("k,B", WIDE_K)
def test_centroid_update_plain_wider_k_matches_single_cpu_jax(
        single_cpu_reference, k, B):
    """Past B * k ~ 8,900 the reference's one-hot matmul switches to a
    threaded tree that depends on the CPUs the process may use; on one CPU
    it keeps the sequential block order that ``row_blocks`` forms, and the
    port's plain version equals it bit for bit."""
    c, x, a = _cu_inputs(B, k=k)
    out = PCU.centroid_update(*map(torch.from_numpy, (c, x, a)), 10.0)
    np.testing.assert_array_equal(_bits(out.numpy()),
                                  _bits(single_cpu_reference[f"k{k}B{B}"]))


@pytest.mark.parametrize("k,B", WIDE_K)
def test_centroid_update_plain_wider_k_within_jax_tolerance(k, B):
    """The same cases against the reference on every CPU of the host, at
    the JAX suite's rtol = atol = 1e-5 (``test_centroid_update_sweep``)."""
    c, x, a = _cu_inputs(B, k=k)
    ref = np.asarray(JO.fleet_centroid_update(c, x, a, 10.0))
    out = PCU.centroid_update(*map(torch.from_numpy, (c, x, a)), 10.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_online_update_matches_jax():
    rng = np.random.default_rng(9)
    c = rng.normal(size=(5, 40)).astype(np.float32)
    n = rng.uniform(1, 9, 5).astype(np.float32)
    x = rng.normal(size=(2, 3, 40)).astype(np.float32)
    idx = np.array([[0, -1, 3], [-1, 2, -1]], np.int32)
    cj, nj = JK.online_update(c, n, x, idx, weight=32.0)
    cp, np_ = PK.online_update(torch.from_numpy(c), torch.from_numpy(n),
                               torch.from_numpy(x), torch.from_numpy(idx),
                               weight=32.0)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(np_.numpy(), np.asarray(nj))


def test_utility_test_matches_jax():
    """``utility_test``: the margin above the unit's threshold, on a fitted
    unit and margins at, around and far from it."""
    feats, y = _feats(0, 60, (256, 40))
    uj = JK.fit_unit_classifier(feats[0], y, n_sel=30, threshold=0.07)
    up = PK.fit_unit_classifier(feats[0], y, n_sel=30, threshold=0.07,
                                device="cpu")
    m = np.concatenate([np.float32([0.07, np.nextafter(np.float32(0.07),
                                                       np.float32(1))]),
                        np.random.default_rng(1).uniform(-1, 1, 64)
                        ]).astype(np.float32)
    got = PK.utility_test(up, torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JK.utility_test(uj, m)))
    assert got.dtype == np.bool_ and got[1] and not got[0]


def test_online_update_blocks_sums_each_block_then_the_blocks():
    """``online_update_blocks`` (kernel E's partial and finish entries):
    each block's rows per cluster in row order, the blocks' sums added in
    block order, then E's finish; one block is ``online_update``."""
    rng = np.random.default_rng(11)
    c = rng.normal(size=(5, 40)).astype(np.float32)
    n = rng.uniform(1, 9, 5).astype(np.float32)
    x = (rng.normal(size=(16, 40)) * 10.0 ** rng.integers(
        -3, 4, (16, 40))).astype(np.float32)
    idx = rng.integers(-1, 5, 16).astype(np.int32)
    t = torch.from_numpy
    cut = [slice(4 * i, 4 * i + 4) for i in range(4)]
    got_c, got_n = PK.online_update_blocks(
        t(c), t(n), [t(x[s]) for s in cut], [t(idx[s]) for s in cut])
    total = np.zeros_like(c)
    for s in cut:
        part = np.zeros_like(c)
        for row, j in zip(x[s], idx[s]):
            if j >= 0:
                part[j] = part[j] + row
        total = total + part
    hits = np.bincount(idx[idx >= 0], minlength=5).astype(np.float32)
    want = PCU.centroid_finish_plain(t(c), t(total), t(hits), 32.0)
    np.testing.assert_array_equal(got_c.numpy(), want.numpy())
    np.testing.assert_array_equal(got_n.numpy(), n + hits)
    one = PK.online_update_blocks(t(c), t(n), [t(x)], [t(idx)])
    whole = PK.online_update(t(c), t(n), t(x), t(idx))
    for a, b in zip(one, whole):
        assert torch.equal(a, b)


def test_kernel_wrappers_reject_bad_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        PO.l1_topk2(x.double(), torch.zeros(3, 8).double())
    with pytest.raises(ValueError):
        PO.l1_topk2(x, torch.zeros(3, 9))
    with pytest.raises(ValueError):
        PO.l1_topk2(x, torch.zeros(5, 3, 8))
    with pytest.raises(TypeError):
        PO.centroid_update(torch.zeros(3, 8), x, torch.zeros(4), 32.0)
    with pytest.raises(ValueError):
        PO.centroid_update(torch.zeros(3, 8), x,
                           torch.zeros(5, dtype=torch.int32), 32.0)
    before = PO.launch_counts()
    PO.l1_topk2(x, torch.zeros(3, 8))          # the CPU never launches
    assert PO.launch_counts() == before
