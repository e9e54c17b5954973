"""The quantizer's remainder and the baselines against the reference, on
the CPU: ``ptqtp_error``, ``quantize_with_history`` and RTN, GPTQ, AWQ and
BiLLM (``repro_torch.core.baselines``).

Inputs are made with numpy from a seed and go through both packages
(the reference's functions jitted, as it runs them). Tolerances, measured
on these inputs and stated with their margin:

  * ``quantize_with_history``: planes and iteration count exact (and equal
    to ``ptqtp_quantize``'s); α to rtol 1e-5 of its largest |α| (measured
    ≤ 2.1e-7: the ridge sums b1, b2 run in another order); the errors to
    rtol 1e-5 (measured ≤ 1.7e-7); ``ptqtp_error`` to rtol 1e-5;
  * RTN: codes, scales, zeros and Ŵ exact (the division by the constant
    qmax is XLA's product with its f32 reciprocal in both);
  * GPTQ: the factor U of H⁻¹ within 2e-4 of its largest |U| (measured ≤
    6.6e-5: ``torch.linalg`` and XLA's LAPACK paths differ); Ŵ's elements
    more than half a quantization step apart ≤ 0.5 % (measured ≤ 0.13 %,
    at most 2 steps: a code flip feeds the later columns' compensation),
    the x-weighted error within 0.5 % (measured ≤ 0.14 %); with x = None
    (an identity Hessian) exact in Ŵ's codes;
  * AWQ: the chosen ratio equal (unless the two smallest attempt errors lie
    within 1e-5 of each other: then only the error), its error to rtol
    1e-5 (measured ≤ 4e-7), Ŵ to rtol 2e-6 (measured ≤ 4.2e-7: ``pow``
    differs by an ulp);
  * BiLLM: the salient columns exact, Ŵ to rtol 2e-6 (measured ≤ 6.7e-7:
    the means sum in another order), signs exact.

Each at an even d (the row median the mean of two middle values, as
``jnp.median`` takes it) and an odd one. The reference's property tests of
these functions are ported too: the error never increases over the
iterations, GPTQ beats RTN in its x-weighted error, PTQTP lands between
binary and 4-bit RTN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptqtp as jptqtp
from repro.core.baselines import awq_quantize as jawq
from repro.core.baselines import billm_quantize as jbillm
from repro.core.baselines import gptq_quantize as jgptq
from repro.core.baselines import rtn_quantize as jrtn
from repro.core.baselines.gptq import _hessian_inv_chol as jhessian_inv_chol
from repro_torch.core import ptqtp
from repro_torch.core.baselines import (awq_quantize, billm_quantize,
                                        gptq_quantize, rtn_quantize)
from repro_torch.core.baselines.awq import ratio_grid
from repro_torch.core.baselines.billm import median_last
from repro_torch.core.baselines.gptq import hessian_inv_chol

torch.set_num_threads(1)

# (n, d, group size): an even d in 128-groups, an odd d as one group a row
SHAPES = [(128, 512, 128), (96, 135, 0)]


def _w(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.02).astype(np.float32)


def _x(d, seed):
    return np.random.default_rng(seed).standard_normal((128, d)).astype(
        np.float32)


def _llm_w(shape=(64, 512), seed=0):
    """Heavy-tailed, per-column scaled weights (the reference's ``_w``)."""
    r = np.random.default_rng(seed)
    w = r.standard_t(4, size=shape).astype(np.float32)
    w *= np.exp(r.normal(0, 0.5, size=(1, shape[1]))).astype(np.float32)
    return w * 0.02


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel(w, w_hat):
    return float(np.linalg.norm(w - w_hat) / np.linalg.norm(w))


# ------------------------------------------------------------------- PTQTP
@pytest.mark.parametrize("shape,g,t_max,seed", [((64, 512), 128, 20, 0),
                                                ((8, 256), 128, 30, 3),
                                                ((128, 256), 64, 5, 1)])
def test_quantize_with_history_equals_reference(shape, g, t_max, seed):
    w = _w(shape, seed)
    jq, jerrs = jptqtp.quantize_with_history(
        jnp.asarray(w), jptqtp.PTQTPConfig(group_size=g, t_max=t_max))
    cfg = ptqtp.PTQTPConfig(group_size=g, t_max=t_max)
    q, errs = ptqtp.quantize_with_history(_t(w), cfg)
    assert q.iters == int(jq.iters) and len(errs) == q.iters + 1
    np.testing.assert_array_equal(q.t1.numpy(), np.asarray(jq.t1))
    np.testing.assert_array_equal(q.t2.numpy(), np.asarray(jq.t2))
    ja = np.asarray(jq.alpha)
    np.testing.assert_allclose(q.alpha.numpy(), ja, rtol=0,
                               atol=1e-5 * np.abs(ja).max())
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), rtol=1e-5)
    # the quantizer's planes and iterations; no final α refit here
    full = ptqtp.ptqtp_quantize(_t(w), cfg)
    assert full.iters == q.iters
    assert torch.equal(full.t1, q.t1) and torch.equal(full.t2, q.t2)
    err = ptqtp.ptqtp_error(_t(w), q)
    assert err.dtype == torch.float32 and err.dim() == 0
    np.testing.assert_allclose(float(err), float(jptqtp.ptqtp_error(
        jnp.asarray(w), jq)), rtol=1e-5)
    np.testing.assert_allclose(float(errs[-1] / torch.linalg.norm(_t(w))),
                               float(err), rtol=1e-5)


def test_error_monotonically_non_increasing():
    """The reference's App. C property: no iteration increases ||W − Ŵ||."""
    w = np.random.default_rng(3).standard_normal((8, 256)).astype(np.float32)
    _, errors = ptqtp.quantize_with_history(_t(w),
                                            ptqtp.PTQTPConfig(t_max=30))
    e = errors.numpy()
    assert np.all(e[1:] <= e[:-1] + 1e-4 * e[0]), e


def test_ptqtp_error_of_a_zero_matrix_is_finite():
    """max(||W||, 1e-30) in the denominator, as in the reference."""
    w = np.zeros((4, 128), np.float32)
    q = ptqtp.ptqtp_quantize(_t(w), ptqtp.PTQTPConfig(t_max=2))
    assert float(ptqtp.ptqtp_error(_t(w), q)) == float(
        jptqtp.ptqtp_error(jnp.asarray(w), jptqtp.ptqtp_quantize(
            jnp.asarray(w), jptqtp.PTQTPConfig(t_max=2)))) == 0.0


# --------------------------------------------------------------------- RTN
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("n,d,g", [(128, 512, 128), (96, 256, 64)])
def test_rtn_codes_equal_reference(n, d, g, bits, symmetric):
    w = _w((n, d), bits + 10 * symmetric)
    jw, jm = jax.jit(jrtn, static_argnames=("bits", "group_size",
                                            "symmetric"))(
        jnp.asarray(w), bits=bits, group_size=g, symmetric=symmetric)
    tw, tm = rtn_quantize(_t(w), bits=bits, group_size=g,
                          symmetric=symmetric)
    assert tm["q"].dtype == torch.int32
    for key in ("q", "scale", "zero"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    lo = -(2 ** (bits - 1)) if symmetric else 0
    hi = 2 ** (bits - 1) - 1 if symmetric else 2 ** bits - 1
    assert lo <= int(tm["q"].min()) and int(tm["q"].max()) <= hi


def test_rtn_refuses_a_ragged_group():
    with pytest.raises(ValueError, match="group size"):
        rtn_quantize(torch.zeros(4, 100), group_size=64)


# -------------------------------------------------------------------- GPTQ
@pytest.mark.parametrize("with_x", [True, False])
@pytest.mark.parametrize("n,d,g", SHAPES)
def test_gptq_equals_reference_within_the_stated_tolerance(n, d, g, with_x):
    w = _w((n, d), d)
    x = _x(d, d + 1) if with_x else None
    ju = np.asarray(jax.jit(lambda x: jhessian_inv_chol(x, d))(_j(x)))
    tu = hessian_inv_chol(_t(x), d).numpy()
    np.testing.assert_allclose(tu, ju, rtol=0, atol=2e-4 * np.abs(ju).max())
    jw, jm = jgptq(jnp.asarray(w), _j(x), bits=3, group_size=g)
    tw, tm = gptq_quantize(_t(w), _t(x), bits=3, group_size=g)
    np.testing.assert_array_equal(tm["scale"].numpy(), np.asarray(jm["scale"]))
    jw, tw = np.asarray(jw), tw.numpy()
    step = np.repeat(np.asarray(jm["scale"]), g or d, axis=1)
    apart = np.abs(jw - tw) / step > 0.5
    if x is None:
        assert not apart.any()
        return
    assert apart.mean() <= 5e-3, apart.mean()

    def xerr(wh):
        return float(np.sum(((wh - w) @ x.T) ** 2))

    assert abs(xerr(tw) - xerr(jw)) <= 5e-3 * xerr(jw)


def test_gptq_beats_rtn_weighted_error():
    """The reference's property: Hessian compensation wins in the
    x-weighted metric."""
    w = _llm_w(seed=9)
    x = np.random.default_rng(10).standard_normal((256, 512),
                                                  dtype=np.float32)
    w_rtn, _ = rtn_quantize(_t(w), bits=3, group_size=128)
    w_gptq, _ = gptq_quantize(_t(w), _t(x), bits=3, group_size=128)
    err_rtn = float(np.linalg.norm(x @ (w - w_rtn.numpy()).T))
    err_gptq = float(np.linalg.norm(x @ (w - w_gptq.numpy()).T))
    assert np.isfinite(err_gptq) and err_gptq <= err_rtn * 1.02


# --------------------------------------------------------------------- AWQ
def test_ratio_grid_is_jnp_linspace():
    for n in (1, 2, 20, 33):
        want = np.asarray(jnp.linspace(0.0, 1.0, n))
        assert np.array_equal(np.asarray(ratio_grid(n), np.float32), want)


@pytest.mark.parametrize("n,d,g", SHAPES + [(128, 256, 64)])
def test_awq_equals_reference(n, d, g):
    w, x = _w((n, d), d + 2), _x(d, d + 3)
    jw, jm = jawq(jnp.asarray(w), jnp.asarray(x), bits=3, group_size=g)
    tw, tm = awq_quantize(_t(w), _t(x), bits=3, group_size=g)
    np.testing.assert_allclose(float(tm["err"]), float(jm["err"]), rtol=1e-5)
    # each attempt's error (the port's): a near tie may pick either ratio
    xf = _t(x)
    errs = []
    for r in ratio_grid(20):
        s = torch.pow(xf.abs().mean(0).clamp(min=1e-8), r)
        s = (s / torch.sqrt(torch.clamp(s.amax() * s.amin(), min=1e-20))
             ).clamp(min=1e-4)
        wh = rtn_quantize(_t(w) * s, bits=3, group_size=g)[0] / s
        errs.append(float((((wh - _t(w)) @ xf.T) ** 2).sum()))
    first, second = sorted(errs)[:2]
    if second - first > 1e-5 * first:
        assert float(tm["ratio"]) == float(jm["ratio"])
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-6,
                                   atol=0)


# ------------------------------------------------------------------- BiLLM
def test_median_is_jnp_median():
    """The midpoint of the two middle values at an even count, the middle
    one at an odd count; ``torch.median`` would take the lower."""
    rng = np.random.default_rng(0)
    for d in (8, 9, 512, 135):
        a = np.abs(rng.standard_normal((6, d))).astype(np.float32)
        np.testing.assert_array_equal(median_last(_t(a)).numpy(),
                                      np.asarray(jnp.median(a, axis=-1)))
    a = _t([[1.0, 2.0, 4.0, 8.0]])
    assert float(median_last(a)) == 3.0 != float(a.median())


@pytest.mark.parametrize("with_x", [True, False])
@pytest.mark.parametrize("n,d,g", SHAPES)
def test_billm_equals_reference(n, d, g, with_x):
    w = _w((n, d), d + 4)
    x = _x(d, d + 5) if with_x else None
    jw, jm = jbillm(jnp.asarray(w), _j(x))
    tw, tm = billm_quantize(_t(w), _t(x))
    np.testing.assert_array_equal(tm["salient"].numpy(),
                                  np.asarray(jm["salient"]))
    assert int(tm["salient"].sum()) >= max(1, int(d * 0.05))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-6, atol=0)
    np.testing.assert_array_equal(np.sign(tw.numpy()), np.sign(np.asarray(jw)))
    assert tm["effective_bits"] == jm["effective_bits"]


def test_ptqtp_between_binary_and_4bit():
    """The reference's Table 1 ordering at the matrix level: PTQTP beats
    BiLLM and 2-bit RTN, 4-bit RTN keeps an edge."""
    w = _llm_w(seed=7)
    q = ptqtp.ptqtp_quantize(_t(w), ptqtp.PTQTPConfig(t_max=30))
    e_ptqtp = _rel(w, ptqtp.ptqtp_dequantize(q).numpy())
    e_billm = _rel(w, billm_quantize(_t(w))[0].numpy())
    e_rtn4 = _rel(w, rtn_quantize(_t(w), bits=4, group_size=128)[0].numpy())
    e_rtn2 = _rel(w, rtn_quantize(_t(w), bits=2, group_size=128)[0].numpy())
    assert e_ptqtp < e_billm and e_ptqtp < e_rtn2 and e_rtn4 < e_ptqtp
