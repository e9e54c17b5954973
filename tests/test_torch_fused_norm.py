"""The fused residual add + RMSNorm (``add_rms_norm``) and the per-thread
launch counter, against the reference on the same inputs.

``add_rms_norm``'s plain version (what its wrapper runs on CPU tensors)
is held against the reference's ``x + y`` followed by
``repro.models.common.rms_norm``: the sum exactly, the norm within rtol =
atol = 1e-5 in f32 and one bf16 step (2^-7 of the value) in bf16, as the
plain ``rms_norm`` is in ``test_torch_kernels.py``. The serving steps
(``prefill_chunk``, ``decode_step``) of smoke qwen2-1.5b, rwkv6-3b and
recurrentgemma-2b, which now take every norm that follows a residual add
through ``add_rms_norm``, are held against the reference's on its own f32
params at the tolerances the existing model tests use (1e-4 for qwen2,
2e-4 for the recurrent models), with the count of fused and plain norms
each step makes. The CUDA kernel is held against these plain versions on
a card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models import prefill_chunk as jprefill_chunk
from repro.models.common import rms_norm as jrms_norm
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _build
from repro_torch.kernels.rms_norm import ops as norm_ops
from repro_torch.models import (decode_step, init_decode_state,
                                prefill_chunk)
from repro_torch.models import transformer

# The suite runs one xdist worker per core: keep torch to one intra-op
# thread so it does not oversubscribe the CPU that the other workers share.
torch.set_num_threads(1)

NORM_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
MODEL_TOL = {"qwen2-1.5b": 1e-4, "rwkv6-3b": 2e-4, "recurrentgemma-2b": 2e-4}


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ the function
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 64), (8, 1536), (2, 5, 2560),
                                   (4, 5376)])
def test_add_rms_norm_plain_matches_reference(shape, dtype):
    """qwen2's, rwkv6's and recurrentgemma's, and gemma3's widths."""
    rng = np.random.default_rng(shape[-1] + len(shape))
    x, y = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    scale = rng.uniform(0.5, 1.5, shape[-1:]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jsum = jnp.asarray(x, jdt) + jnp.asarray(y, jdt)
    want = jrms_norm({"scale": jnp.asarray(scale, jdt)}, jsum, 1e-6)
    got_sum, got = norm_ops.add_rms_norm(_t(scale).to(tdt), _t(x).to(tdt),
                                         _t(y).to(tdt), 1e-6)
    assert got_sum.dtype == got.dtype == tdt
    assert tuple(got_sum.shape) == tuple(got.shape) == shape
    np.testing.assert_array_equal(got_sum.float().numpy(),
                                  np.asarray(jsum.astype(jnp.float32)))
    tol = NORM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # its norm is the plain norm of its sum, bit for bit
    assert torch.equal(got, norm_ops.rms_norm(_t(scale).to(tdt), got_sum,
                                              1e-6))


def test_add_rms_norm_cpu_path_launches_nothing():
    before = _build.launch_counts()
    norm_ops.add_rms_norm(torch.ones(64), torch.randn(4, 64),
                          torch.randn(4, 64))
    assert _build.launch_counts() == before


def test_add_rms_norm_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        norm_ops.add_rms_norm_cuda(torch.ones(64), torch.randn(4, 64),
                                   torch.randn(4, 64))
    with pytest.raises(ValueError, match="delta"):  # another dtype
        norm_ops.add_rms_norm_cuda(torch.ones(64), torch.randn(4, 64),
                                   torch.randn(4, 64).double())


# ------------------------------------------------- the serving steps, wired
STEPS = [("prefill", [[5, 9, 17, 2, 33, 8], [7, 7, 300, 2, 0, 0],
                      [0] * 6], [6, 4, 0]),
         ("decode", [42, 43, 44], [True, True, False]),
         ("prefill", [[11, 12, 13, 0, 0, 0], [0] * 6, [3, 4, 5, 6, 7, 8]],
          [3, 0, 6]),
         ("decode", [1, 2, 3], [True, True, True])]
B, CAP = 3, 32


# ------------------------------------------- the backward kernel's tiling
@pytest.mark.parametrize("rows,d,warps,blocks", [
    (4096, 1536, 8, 128),   # (t)'s shape: one block on 128 of the 132 SMs
    (1, 1536, 8, 1), (70, 64, 8, 3), (33, 2560, 8, 2), (1040, 5376, 6, 33),
    (4096, 16384, 2, 128)])
def test_norm_backward_tiling(rows, d, warps, blocks):
    """The norm backward kernel's tiling (warps a block, rows a block,
    blocks), which fixes the order of its dscale sums, depends on (rows,
    d) only; the tiles cover the rows once, and a block's warps' rows of
    d f32 fit the card's 227 KB of shared memory."""
    w, tile, n = norm_ops.backward_tiling(rows, d)
    assert (w, n) == (warps, blocks)
    assert (n - 1) * tile < rows <= n * tile
    assert 1 <= w <= 8 and w * d * 4 <= 227 * 1024


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b",
                                  "recurrentgemma-2b"])
def test_serving_steps_fuse_the_norms_and_match_reference(arch, monkeypatch):
    """Each ``prefill_chunk`` and ``decode_step`` calls ``add_rms_norm``
    for every norm after a residual add and the plain norm once (after the
    embedding); the logits of the live rows and the positions equal the
    reference's (its own f32 smoke params) after every step."""
    jcfg = jconfigs.get_smoke_config(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(1))
    cfg = configs.get_smoke_config(arch)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    calls = {"fused": 0, "plain": 0}
    fused, plain = transformer.add_rms_norm, norm_ops.rms_norm

    def count_fused(*a, **kw):
        calls["fused"] += 1
        return fused(*a, **kw)

    def count_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(transformer, "add_rms_norm", count_fused)
    monkeypatch.setattr("repro_torch.models.common.rms_norm", count_plain)
    # two norms a block and the final one; all but the first follow an add
    want_calls = {"fused": 2 * cfg.n_layers, "plain": 1}
    tol = dict(rtol=MODEL_TOL[arch], atol=MODEL_TOL[arch])
    jstate = jinit_decode_state(jcfg, B, CAP)
    state = init_decode_state(cfg, B, CAP, device="cpu")
    for step, (kind, toks, arg) in enumerate(STEPS):
        tok = np.asarray(toks, np.int32)
        calls.update(fused=0, plain=0)
        if kind == "prefill":
            lens = np.asarray(arg, np.int32)
            jl, jstate = jprefill_chunk(params, jcfg, jstate,
                                        {"tokens": jnp.asarray(tok)},
                                        jnp.asarray(lens))
            logits, state = prefill_chunk(model, cfg, state,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(lens))
            rows = lens > 0
        else:
            act = np.asarray(arg)
            jl, jstate = jdecode_step(params, jcfg, jstate, jnp.asarray(tok),
                                      jnp.asarray(act))
            logits, state = decode_step(model, cfg, state,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(act))
            rows = act
        assert calls == want_calls, (step, calls)
        np.testing.assert_allclose(logits.numpy()[rows], np.asarray(jl)[rows],
                                   **tol, err_msg=f"{arch} step {step}")
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(jstate["pos"]))


# ------------------------------------------------- launches per thread
def test_launches_since_counts_only_the_calling_thread():
    """A thread counts launches while another holds a snapshot: each
    thread's ``launches_since`` sees its own launches only, and the process
    counts see both."""
    proc = _build.launch_counts()
    mine = _build.thread_launch_counts()
    seen = {}
    snapped, counted = threading.Event(), threading.Event()

    def other():
        theirs = _build.thread_launch_counts()
        snapped.set()
        for _ in range(50):
            _build.count("wkv6")
        _build.count("ternary_matvec", 7)
        seen.update(_build.launches_since(theirs))
        counted.set()

    worker = threading.Thread(target=other)
    worker.start()
    assert snapped.wait(10)
    _build.count("add_rms_norm", 3)
    assert counted.wait(10)
    worker.join(10)
    assert not worker.is_alive()
    delta = _build.launches_since(mine)
    assert delta["add_rms_norm"] == 3 and sum(delta.values()) == 3
    assert seen["wkv6"] == 50 and seen["ternary_matvec"] == 7
    assert sum(seen.values()) == 57
    total = _build.launch_counts()
    assert {k: total[k] - proc[k] for k in total if total[k] != proc[k]} == {
        "wkv6": 50, "ternary_matvec": 7, "add_rms_norm": 3}
    _build.add_launches({"wkv6": 50, "ternary_matvec": 7, "add_rms_norm": 3},
                        -1)
    assert _build.launch_counts() == proc


def test_process_counts_add_up_across_threads():
    """Threads counting at once, switched often, lose no launch in the
    process's counts, and each thread's tally holds its own."""
    n_threads, n = 32, 2000
    proc = _build.launch_counts()
    tallies = [None] * n_threads

    def worker(i):
        before = _build.thread_launch_counts()
        for _ in range(n):
            _build.count("rglru_scan")
        tallies[i] = _build.launches_since(before)["rglru_scan"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tallies == [n] * n_threads
    added = _build.launch_counts()["rglru_scan"] - proc["rglru_scan"]
    _build.add_launches({"rglru_scan": added}, -1)
    assert added == n * n_threads
