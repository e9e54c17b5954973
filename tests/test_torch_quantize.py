"""The port's PTQTP quantizer against the reference's, same weights.

Weights are made with numpy from a seed. Trit-planes and iteration counts
are integers and must match exactly; the port's trit step goes through
its search op (the plain walk on the CPU), the reference's through XLA
and, with ``use_search_kernel=True``, through its Pallas kernel in
interpret mode. α is float32 and
agrees to rtol 1e-5: s11, s12 and s22 are sums of trit products, integers
exact in any order, but b1 = Σ t1·w and b2 = Σ t2·w run in another order
(measured on these inputs: every plane entry equal, max relative α
difference ~2e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import ptqtp as jptqtp
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core import ptqtp
from repro_torch.core.packing import unpack_trits
from repro_torch.core.quantize_model import quantize_tree
from repro_torch.models.common import Dense

# The suite runs one xdist worker per core: keep torch to one intra-op
# thread so it does not oversubscribe the CPU that the other workers share.
torch.set_num_threads(1)

ALPHA_RTOL = 1e-5


@pytest.mark.parametrize("n,d,g,t_max", [(64, 128, 64, 20), (96, 256, 32, 20),
                                         (128, 128, 128, 50),
                                         (512, 64, 64, 20)])
def test_quantize_matches_reference(n, d, g, t_max):
    w = np.random.default_rng(n + d).standard_normal((n, d)).astype(np.float32)
    ref = jptqtp.ptqtp_quantize(jnp.asarray(w), jptqtp.PTQTPConfig(
        group_size=g, t_max=t_max))
    got = ptqtp.ptqtp_quantize(torch.from_numpy(w), ptqtp.PTQTPConfig(
        group_size=g, t_max=t_max))
    assert got.iters == int(ref.iters)
    np.testing.assert_array_equal(got.t1.numpy(), np.asarray(ref.t1))
    np.testing.assert_array_equal(got.t2.numpy(), np.asarray(ref.t2))
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha),
                               rtol=ALPHA_RTOL, atol=1e-7)


@pytest.mark.parametrize("n,d,g", [(64, 128, 64), (96, 256, 32)])
def test_search_op_path_matches_reference_kernel_path(n, d, g,
                                                      monkeypatch):
    """The port's quantizer, whose every trit step goes through the search
    op, against the reference with its Pallas search kernel
    (``use_search_kernel=True``) and with XLA's search."""
    w = np.random.default_rng(n * d).standard_normal((n, d)).astype(
        np.float32)
    calls = []
    op = ptqtp.search_ops.ptqtp_search
    monkeypatch.setattr(ptqtp.search_ops, "ptqtp_search",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    got = ptqtp.ptqtp_quantize(torch.from_numpy(w), ptqtp.PTQTPConfig(
        group_size=g, t_max=10))
    assert len(calls) == got.iters  # one row chunk per trit step here
    for use_kernel in (True, False):
        ref = jptqtp.ptqtp_quantize(jnp.asarray(w), jptqtp.PTQTPConfig(
            group_size=g, t_max=10, use_search_kernel=use_kernel))
        assert got.iters == int(ref.iters)
        np.testing.assert_array_equal(got.t1.numpy(), np.asarray(ref.t1))
        np.testing.assert_array_equal(got.t2.numpy(), np.asarray(ref.t2))
        np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha),
                                   rtol=ALPHA_RTOL, atol=1e-7)


def test_search_chunks_are_exact(monkeypatch):
    """Walking the trit search in row chunks changes nothing."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 128)).astype(np.float32))
    cfg = ptqtp.PTQTPConfig(group_size=32, t_max=10)
    whole = ptqtp.ptqtp_quantize(w, cfg)
    monkeypatch.setattr(ptqtp, "_CHUNK_ELEMS", 32 * 7)
    chunked = ptqtp.ptqtp_quantize(w, cfg)
    assert torch.equal(whole.t1, chunked.t1)
    assert torch.equal(whole.alpha, chunked.alpha)


def test_ties_prefer_first_candidate():
    """w == 0 ties every symmetric pair; (0, 0) comes first and wins."""
    w = torch.zeros((2, 8))
    w[0, :4] = 1.0
    q = ptqtp.ptqtp_quantize(w, ptqtp.PTQTPConfig(group_size=8, t_max=5))
    ref = jptqtp.ptqtp_quantize(jnp.asarray(w.numpy()),
                                jptqtp.PTQTPConfig(group_size=8, t_max=5))
    np.testing.assert_array_equal(q.t1.numpy(), np.asarray(ref.t1))
    np.testing.assert_array_equal(q.t2.numpy(), np.asarray(ref.t2))


def test_quantize_tree_matches_reference_model():
    """Quantizing the smoke model in both packages gives the same packed
    planes per layer (the reference quantizes each stacked layer with its
    own convergence loop, as the port does layer by layer)."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    cfg = configs.get_smoke_config("qwen2-1.5b")
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    qcfg = dict(group_size=64, t_max=8)
    jq, jrep = jquantize_tree(jparams, jptqtp.PTQTPConfig(**qcfg))
    model = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    model, rep = quantize_tree(model, ptqtp.PTQTPConfig(**qcfg))
    # per-layer entries here, one per stacked leaf there: same bytes in total
    assert rep["__total__"]["after_bytes"] == jrep["__total__"]["after_bytes"]
    assert rep["__total__"]["before_bytes"] == \
        jrep["__total__"]["before_bytes"]
    ported = from_jax_params(jax.tree.map(np.asarray, jq), cfg, device="cpu")
    mismatched = total = 0
    for (name, a), b in zip(model.named_modules(), ported.modules()):
        if not isinstance(a, Dense):
            continue
        assert a.t1p is not None, name
        for pa, pb in ((a.t1p, b.t1p), (a.t2p, b.t2p)):
            mismatched += int((unpack_trits(pa) != unpack_trits(pb)).sum())
            total += pa.numel() * 4
        np.testing.assert_allclose(a.alpha.numpy(), b.alpha.numpy(),
                                   rtol=ALPHA_RTOL, atol=1e-7, err_msg=name)
    assert mismatched == 0, f"{mismatched} of {total} trits differ"
