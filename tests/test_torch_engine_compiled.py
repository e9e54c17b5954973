"""The port's compiled dispatches, the serial-admit baseline and whole-prompt
``prefill`` against the reference's, on the CPU.

On the CPU the engine's dispatch caches hold the eager bodies under the
keys the card captures CUDA graphs for: one decode loop per (chunk length,
masked sampling, stop width, poison) — the reference's four-component key
— plus the port's threefry-draw flag, and one prefill per bucket (per
prompt length on the serial baseline). For the same workload the keys, with
the draw flag projected out, and ``compile_stats()`` equal the reference
engine's; ``warmup()`` changes no token and leaves nothing for a fleet to
compile; ``memory_stats()`` counts the reference's plane and KV bytes.
``SerialAdmitEngine`` streams equal the reference's and the bucketed
engine's. The graphs' precondition: no dispatch, row reset or page
maintenance rebinds a tensor of the decode state.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serving as jserving
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.kernels import _build
from repro_torch.models import decode_step, prefill, prefill_chunk
from repro_torch.serving import (EngineConfig, SamplingParams,
                                 SerialAdmitEngine, ServingEngine)

torch.set_num_threads(1)

# lengths of one token, a few, more than prefill_chunk (8) and more than
# capacity (32); five requests on three slots; one sampled, one masked, one
# with a two-token stop set
LENS = (1, 3, 9, 20, 40)
BUDGETS = (5, 4, 6, 3, 5)
ENGINE = dict(max_slots=3, capacity=32, prefill_chunk=8, decode_chunk=4)


@pytest.fixture(scope="module")
def both():
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                               JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return (params, jcfg), (model, cfg)


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(1, 500, size=n).tolist() for n in LENS]


def _params(SP, sampled=True):
    out = [SP(max_new_tokens=n) for n in BUDGETS]
    if sampled:
        out[1] = SP(max_new_tokens=BUDGETS[1], temperature=0.8, seed=7)
        out[2] = SP(max_new_tokens=BUDGETS[2], temperature=0.8, seed=2,
                    top_k=20, top_p=0.9)
        out[3] = SP(max_new_tokens=BUDGETS[3], stop={3, 499})
    return out


def _serve(eng, SP, sampled=True):
    hs = [eng.submit(p, sp) for p, sp in zip(_prompts(), _params(SP,
                                                                 sampled))]
    eng.run()
    return [(list(h.output), h.finish_reason) for h in hs]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_dispatch_keys_and_compile_stats_equal_reference(both, layout):
    (params, jcfg), (model, cfg) = both
    kw = dict(ENGINE, kv_layout=layout, page_size=8)
    ref = jserving.ServingEngine(params, jcfg, jserving.EngineConfig(**kw))
    want = _serve(ref, jserving.SamplingParams)
    eng = ServingEngine(model, cfg, EngineConfig(**kw))
    assert _serve(eng, SamplingParams) == want
    assert {k[:4] for k in eng._loop_cache} == set(ref._loop_cache)
    assert any(k[4] for k in eng._loop_cache)          # the draw variant ran
    assert sorted(eng._prefill_cache) == sorted(ref._prefill_cache)
    assert eng.compile_stats() == ref.compile_stats()
    stats = eng.graph_stats()
    assert stats["capture_s"] == 0.0                    # eager bodies here
    assert all(not d["graph"] and d["replays"] > 0
               for d in stats["dispatches"])


def test_warmup_covers_every_dispatch_and_changes_no_token(both):
    (params, jcfg), (model, cfg) = both
    ref = jserving.ServingEngine(params, jcfg, jserving.EngineConfig(**ENGINE))
    ref.warmup()
    cold = ServingEngine(model, cfg, EngineConfig(**ENGINE))
    want = _serve(cold, SamplingParams, sampled=False)
    eng = ServingEngine(model, cfg, EngineConfig(**ENGINE))
    eng.warmup()
    before = eng.compile_stats()
    assert {k[:4] for k in eng._loop_cache} == set(ref._loop_cache)
    for field in ("prefill_bucket_lengths", "n_prefill_compiles",
                  "decode_chunk_lengths"):
        assert before[field] == ref.compile_stats()[field]
    assert before["prefill_bucket_lengths"] == [1, 2, 4, 8]
    keys = sorted(eng._loop_cache)
    assert _serve(eng, SamplingParams, sampled=False) == want
    after = eng.compile_stats()
    assert sorted(eng._loop_cache) == keys
    for field in ("prefill_bucket_lengths", "n_prefill_compiles",
                  "decode_chunk_lengths", "n_decode_compiles"):
        assert after[field] == before[field]


@pytest.mark.parametrize("preunpack", [None, False, True])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_memory_stats_count_the_reference_bytes(both, layout, preunpack):
    """Plane, parameter and KV bytes equal the reference engine's; None
    pre-unpacks on the CPU in both (resident planes 4× the packed ones),
    and the caller's model keeps its packed planes."""
    (params, jcfg), (model, cfg) = both
    kw = dict(ENGINE, kv_layout=layout, page_size=8,
              preunpack_decode=preunpack)
    ref = jserving.ServingEngine(params, jcfg, jserving.EngineConfig(**kw))
    eng = ServingEngine(model, cfg, EngineConfig(**kw))
    for e, SP in ((ref, jserving.SamplingParams), (eng, SamplingParams)):
        e.submit(list(range(1, 20)), SP(max_new_tokens=30))
        e.step()
    got, want = eng.memory_stats(), ref.memory_stats()
    for field in ("preunpack_decode", "packed_plane_bytes",
                  "resident_plane_bytes", "preunpack_ratio", "param_bytes",
                  "kv_layout"):
        assert got[field] == want[field], field
    assert got["packed_plane_bytes"] > 0
    assert got["preunpack_decode"] == (preunpack is not False)
    assert got["preunpack_ratio"] == (1.0 if preunpack is False else 4.0)
    assert model.layers[0].attn.wq.t1p.dtype == torch.uint8
    if layout == "ring":
        for field in ("kv_pool_bytes", "kv_resident_bytes",
                      "decode_state_bytes", "resident_total_bytes"):
            assert got[field] == want[field], field
        return
    # one physical page (all layers) is equal; the port's pool has one
    # scratch page more and one page table for all layers, the reference's
    # one table per layer
    page = want["kv_page_bytes"]
    assert got["kv_page_bytes"] == page
    table = int(eng.state["table"].nbytes)
    assert got["kv_pool_bytes"] == (want["kv_pool_bytes"] + page
                                    - (cfg.n_layers - 1) * table)
    assert got["kv_resident_bytes"] == (want["kv_resident_bytes"]
                                        - (cfg.n_layers - 1) * table)


def test_serial_admit_equals_reference_and_bucketed(both):
    (params, jcfg), (model, cfg) = both
    ref = jserving.SerialAdmitEngine(params, jcfg,
                                     jserving.EngineConfig(**ENGINE))
    want = _serve(ref, jserving.SamplingParams)
    serial = SerialAdmitEngine(model, cfg, EngineConfig(**ENGINE))
    got = _serve(serial, SamplingParams)
    assert got == want
    assert _serve(ServingEngine(model, cfg, EngineConfig(**ENGINE)),
                  SamplingParams) == got
    # one dispatch per distinct clipped prompt length, as the reference
    assert serial.compile_stats() == ref.compile_stats()
    assert serial.compile_stats()["n_prefill_compiles"] == len(
        {min(n, 32) for n in LENS})
    with pytest.raises(ValueError, match="ring"):
        SerialAdmitEngine(model, cfg, EngineConfig(kv_layout="paged"))


@pytest.mark.parametrize("chunk", [None, 8])
def test_prefill_equals_reference(both, chunk):
    """Whole-prompt prefill: the last position's logits and the ring state
    equal the reference's ``prefill`` (f32: the same causal attention in
    another summation order; tolerance 1e-4 of the logits' scale)."""
    (params, jcfg), (model, cfg) = both
    tokens = np.random.default_rng(3).integers(0, 512, (2, 20)).astype(
        np.int32)
    jlogits, jstate = jprefill(params, jcfg, {"tokens": jnp.asarray(tokens)},
                               capacity=32)
    logits, state = prefill(model, cfg, torch.from_numpy(tokens), 32,
                            chunk=chunk)
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    assert state["pos"].tolist() == [20, 20]
    ring = np.asarray(jstate["blocks"]["b0"]["pos"])[0]
    assert np.array_equal(state["layers"][0]["pos"].numpy(), ring)
    k = np.asarray(jstate["blocks"]["b0"]["k"])[1]
    np.testing.assert_allclose(state["layers"][1]["k"].numpy(), k,
                               atol=1e-4 * np.abs(k).max(), rtol=0)
    # a reused state resets in place first: the same result again
    again, same = prefill(model, cfg, torch.from_numpy(tokens), 32,
                          chunk=chunk, state=state)
    assert same is state and torch.equal(again, logits)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_state_tensors_keep_their_storage(both, layout):
    """A CUDA graph replays fixed addresses: decode steps, prefill chunks,
    row resets and page maintenance update the state in place."""
    _, (model, cfg) = both
    eng = ServingEngine(model, cfg, EngineConfig(**ENGINE, kv_layout=layout,
                                                 page_size=8))

    def ptrs():
        out = {"pos": eng.state["pos"].data_ptr()}
        for i, c in enumerate(eng.state["layers"]):
            out.update({f"{i}/{n}": t.data_ptr() for n, t in c.items()})
        for name in ("table",):
            if name in eng.state:
                out[name] = eng.state[name].data_ptr()
        for n, t in eng.state.get("pool", {}).items():
            out[f"pool/{n}"] = t.data_ptr()
        return out

    before = ptrs()
    nb = len(eng.slots)
    lengths = torch.tensor([3, 0, 5], dtype=torch.int32)
    prefill_chunk(model, cfg, eng.state, torch.ones((nb, 8), dtype=torch.int32),
                  lengths)
    assert eng.state["pos"].tolist() == [3, 0, 5]
    decode_step(model, cfg, eng.state, torch.ones((nb,), dtype=torch.int32),
                torch.tensor([True, False, True]))
    assert eng.state["pos"].tolist() == [4, 0, 6]
    eng._reset_rows(np.array([True, False, False]),
                    np.array([2, 0, 0], np.int32))
    assert eng.state["pos"].tolist() == [2, 0, 6]
    if layout == "paged":
        eng._tables[0, :2] = [1, 2]
        eng._page_maintenance(copies=[(1, 3)], clear=[2])
        assert eng.state["table"][0, :2].tolist() == [1, 2]
    assert ptrs() == before
    # and through the engine's own dispatches
    _serve(eng, SamplingParams)
    assert ptrs() == before


def test_launch_accounting_of_replays():
    """A capture's launches leave the counts; each replay adds them back."""
    before = _build.launch_counts()
    mine = _build.thread_launch_counts()
    _build.count("rms_norm", 3)
    delta = _build.launches_since(mine)
    assert delta["rms_norm"] == 3 and sum(delta.values()) == 3
    _build.add_launches(delta, -1)
    assert _build.launch_counts() == before
    _build.add_launches(delta, 4)
    assert _build.launch_counts()["rms_norm"] == before["rms_norm"] + 12
    _build.add_launches(delta, -4)


def test_serve_launcher_with_warmup_serial_trace_and_metrics(tmp_path,
                                                             capsys):
    from repro_torch.launch import serve

    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    results = serve.main([
        "--device", "cpu", "--requests", "3", "--max-new", "3", "--t-max",
        "2", "--warmup", "--scheduler", "serial", "--trace-out", str(trace),
        "--metrics-out", str(prom), "--metrics-interval", "1", "--top-k",
        "5", "--temperature", "0.7", "--deadline", "600"])
    assert [len(r.tokens) for r in results] == [3, 3, 3]
    out = capsys.readouterr().out
    assert "[serve] warmup:" in out and "[serve] health: queue=0" in out
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"warmup", "engine_init", "prefill_dispatch", "decode_dispatch",
            "decode_sync", "request"} <= names
    text = prom.read_text()
    assert "serving_requests_completed_total 3" in text
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["serving_tokens_generated_total"] == 9
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--scheduler", "serial",
                    "--kv-layout", "paged"])


def test_dense_rows_do_not_depend_on_the_batch_and_equal_reference(both):
    """C.2: a floating-point layer runs in GEMMs of one row-block shape, so
    a row's bits do not depend on how many rows share the call; the
    unquantized model's greedy streams equal the reference engine's."""
    from repro_torch.models import common

    (_, jcfg), (_, cfg) = both
    layer = common.Dense(64, 48, bias=True)
    torch.manual_seed(0)
    layer.weight.normal_()
    layer.bias.normal_()
    x = torch.randn(300, 64)
    full = common.dense(layer, x)
    for lo, hi in ((0, 1), (5, 13), (127, 129), (250, 300)):
        assert torch.equal(common.dense(layer, x[lo:hi]), full[lo:hi])
    torch.testing.assert_close(full, x @ layer.weight.T + layer.bias)
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    assert model.lm_head.t1p is None  # served unquantized
    ref = jserving.ServingEngine(params, jcfg, jserving.EngineConfig(**ENGINE))
    want = _serve(ref, jserving.SamplingParams, sampled=False)
    got = _serve(ServingEngine(model, cfg, EngineConfig(**ENGINE)),
                 SamplingParams, sampled=False)
    assert got == want
