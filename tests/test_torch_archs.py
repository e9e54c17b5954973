"""The registry's attention-family archs in the port against the reference,
at smoke size: gemma3-27b (5 sliding-window ``local`` layers to 1 global,
head dim 168), deepseek-moe-16b (a dense layer 0, then MoE layers with a
shared expert), grok-1-314b (MoE, no shared expert), llama3-405b and
qwen1.5-32b (dense GQA; qwen1.5 with QKV bias).

Each arch is initialised by the reference from ``PRNGKey(0)``; the port
loads the same bytes (``from_jax_params``). Exact: the planes of the
port's ``quantize_tree`` (G = 64, t_max = 5) and which leaves it
quantizes, the ring positions, the artifacts either package writes (shard
bytes and manifests, timing fields aside) and reads, the tree of
``to_reference_tree`` (paths, order, bytes), the paged-layout refusal of a
sliding window, and the committed JAX-written fixtures' streams. Within
rtol = atol = 1e-4 (f32 sums in another order; logits ~ 4): logits of
``forward``, ``prefill``, ``prefill_chunk`` and ``decode_step``, the
caches' k and v; α within rtol 1e-5 (the ridge sums run in another order,
ROADMAP C). The engines' token streams are in
``tests/test_torch_archs_serving.py``.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import artifacts as jart
from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro.models.transformer import decode_step as jdecode_step
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_decode_state as jinit_decode_state
from repro.models.transformer import prefill as jprefill
from repro.models.transformer import prefill_chunk as jprefill_chunk
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import artifacts as part
from repro_torch import configs
from repro_torch.artifacts import format as pfmt
from repro_torch.convert import from_jax_params, to_reference_tree
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import QuantizedKernel, quantize_tree
from repro_torch.models import (decode_step, forward, init_decode_state,
                                prefill, prefill_chunk)
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

torch.set_num_threads(1)

ARCHS = ("gemma3-27b", "deepseek-moe-16b", "grok-1-314b", "llama3-405b",
         "qwen1.5-32b")
G, T_MAX = 64, 5
TOL = dict(rtol=1e-4, atol=1e-4)
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
TIMING = ("created", "finalized")


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """(reference config, its fp params, its quantized tree)."""
    jcfg = jconfigs.get_smoke_config(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    qtree, _ = jquantize_tree(params, JPTQTPConfig(group_size=G, t_max=T_MAX))
    return jcfg, params, qtree


def _port(tree, arch):
    cfg = configs.get_smoke_config(arch)
    return from_jax_params(jax.tree.map(np.asarray, tree), cfg,
                           device="cpu"), cfg


def test_registry_configs_equal_the_references():
    for arch in ARCHS + ("qwen2-1.5b",):
        for get in ("get_config", "get_smoke_config"):
            ours = dataclasses.asdict(getattr(configs, get)(arch))
            theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
            assert ours == theirs, (arch, get)
    assert set(configs.ARCH_IDS) == set(ARCHS) | {
        "qwen2-1.5b", "recurrentgemma-2b", "rwkv6-3b"}
    assert configs.get_config("gemma3-27b").head_dim == 168


# ------------------------------------------------------------- quantize
def _quant_buffers(model):
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("t1p", "t2p", "alpha")}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_planes_equal_reference(arch):
    """The port quantizes the reference's fp weights into the planes the
    reference's ``quantize_tree`` makes (the same leaves quantized, expert
    stacks one expert at a time), α within rtol 1e-5."""
    _, params, qtree = _ref(arch)
    model, cfg = _port(params, arch)
    model, report = quantize_tree(model, PTQTPConfig(group_size=G,
                                                     t_max=T_MAX))
    want, _ = _port(qtree, arch)
    got_b, want_b = _quant_buffers(model), _quant_buffers(want)
    assert sorted(got_b) == sorted(want_b)
    for name, buf in want_b.items():
        if name.endswith("alpha"):
            np.testing.assert_allclose(got_b[name].numpy(), buf.numpy(),
                                       rtol=1e-5, atol=0, err_msg=name)
        else:
            assert torch.equal(got_b[name], buf), name
    assert report["__total__"]["n_quantized"] == len(want_b) // 3
    if cfg.moe is not None:
        path = next(p for p in report if ".experts.wi." in p)
        e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
        assert report[path]["shape"] == (e, d, f)
        assert report[path]["before_bytes"] == e * d * f * 2


# ------------------------------------------------------------- logits
# (kind, tokens (B, L) or (B,), lengths or active); L = 12 > gemma3's
# smoke window of 8: chunks longer than its local rings
STEPS = [("prefill", [[5, 9, 17, 2, 33, 8, 1, 90, 4, 4, 7, 11],
                      [7, 7, 300, 2, 4, 0, 0, 0, 0, 0, 0, 0],
                      [0] * 12], [12, 5, 0]),
         ("prefill", [[11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22],
                      [0] * 12,
                      [3, 4, 5, 6, 7, 8, 9, 10, 0, 0, 0, 0]], [12, 0, 8]),
         ("decode", [42, 43, 44], [True, True, False]),
         ("decode", [1, 2, 3], [True, True, True]),
         ("prefill", [[100, 101, 102, 103], [0] * 4, [5, 6, 7, 8]],
          [4, 0, 4])]
B, CAP = 3, 32


def _caches(jstate, state, cfg):
    """(name, reference leaf, port leaf) of every layer's ring cache."""
    jlayers = [jstate["prefix"][f"p{i}"]
               for i in range(len(cfg.prefix_pattern))]
    for i in range(cfg.n_periods):
        for pidx in range(cfg.period):
            jlayers.append(jax.tree.map(lambda a: a[i],
                                        jstate["blocks"][f"b{pidx}"]))
    jlayers += [jstate["suffix"][f"s{i}"]
                for i in range(len(cfg.remainder_pattern))]
    for i, (jl, layer) in enumerate(zip(jlayers, state["layers"])):
        for name, leaf in layer.items():
            yield f"layer{i}/{name}", np.asarray(jl[name]), leaf.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_caches_match_reference(arch):
    """``forward`` over 24 tokens, ``prefill`` of 20, then the chunked
    serving steps (prefill chunks with padding and no-op rows, decode with
    a frozen row): logits within 1e-4, ring positions exact, k/v within
    1e-4 (for gemma3 the local rings of 8 slots under chunks of 12)."""
    jcfg, _, qtree = _ref(arch)
    model, cfg = _port(qtree, arch)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(
        np.int32)
    want = np.asarray(jforward(qtree, jcfg, {"tokens": jnp.asarray(tokens)}))
    got = forward(model, cfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    jl, _ = jprefill(qtree, jcfg, {"tokens": jnp.asarray(tokens[:, :20])},
                     CAP)
    pl, _ = prefill(model, cfg, torch.from_numpy(tokens[:, :20]), CAP)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)

    jstate = jinit_decode_state(jcfg, B, CAP)
    state = init_decode_state(cfg, B, CAP, device="cpu")
    for step, (kind, toks, arg) in enumerate(STEPS):
        tok = np.asarray(toks, np.int32)
        if kind == "prefill":
            lens = np.asarray(arg, np.int32)
            jl, jstate = jprefill_chunk(qtree, jcfg, jstate,
                                        {"tokens": jnp.asarray(tok)},
                                        jnp.asarray(lens))
            logits, state = prefill_chunk(model, cfg, state,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(lens))
            rows = lens > 0
        else:
            act = np.asarray(arg)
            jl, jstate = jdecode_step(qtree, jcfg, jstate, jnp.asarray(tok),
                                      jnp.asarray(act))
            logits, state = decode_step(model, cfg, state,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(act))
            rows = act
        np.testing.assert_allclose(logits.numpy()[rows], np.asarray(jl)[rows],
                                   **TOL, err_msg=f"step {step} logits")
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        for name, want_c, got_c in _caches(jstate, state, cfg):
            msg = f"step {step} {name}"
            if name.endswith("/pos"):
                np.testing.assert_array_equal(got_c, want_c, err_msg=msg)
            else:
                np.testing.assert_allclose(got_c, want_c, **TOL, err_msg=msg)


def test_gemma3_local_rings_hold_the_window():
    """A sliding-window layer's ring has ``window`` slots and, after a
    prompt longer than the window fed in chunks longer than the ring, holds
    exactly the last ``window`` positions; the global layer's ring holds
    the whole prompt."""
    arch = "gemma3-27b"
    _, _, qtree = _ref(arch)
    model, cfg = _port(qtree, arch)
    state = init_decode_state(cfg, 1, CAP, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (1, 16)).astype(np.int32))
    for _ in range(2):
        prefill_chunk(model, cfg, state, toks,
                      torch.tensor([16], dtype=torch.int32))
    for kind, layer in zip(cfg.layer_kinds, state["layers"]):
        pos = sorted(layer["pos"][0].tolist())
        if kind.startswith("local"):
            assert pos == list(range(32 - cfg.window, 32))
        else:
            assert pos == list(range(32))


def test_paged_layout_refuses_sliding_windows_as_the_reference():
    """gemma3's local layers (window 8 < capacity 64) cannot be paged: both
    engines raise the same ``ValueError``."""
    arch = "gemma3-27b"
    jcfg, _, qtree = _ref(arch)
    model, cfg = _port(qtree, arch)
    kw = dict(max_slots=2, capacity=64, prefill_chunk=16, kv_layout="paged",
              page_size=8)
    with pytest.raises(ValueError) as theirs:
        JServingEngine(qtree, jcfg, JEngineConfig(**kw))
    with pytest.raises(ValueError) as ours:
        ServingEngine(model, cfg, EngineConfig(**kw))
    assert str(ours.value) == str(theirs.value)
    assert "paged KV layout requires full-capacity attention layers" in \
        str(ours.value)


# ------------------------------------------------------------- artifacts
def _raw(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), pfmt.dtype_name(a), pfmt.byte_view(a).tobytes())
    a = np.asarray(a)
    return (tuple(a.shape), str(a.dtype),
            np.ascontiguousarray(a).view(np.uint8).tobytes())


def _leaves(tree):
    """{path: {buffer: (shape, dtype, bytes)}} in the tree's order."""
    out = {}
    for path, leaf in jart.format.iter_tree_leaves(tree):
        if hasattr(leaf, "t1p"):
            out[path] = {f: _raw(getattr(leaf, f)) for f in pfmt.QK_BUFFERS}
            out[path]["meta"] = (leaf.d_in, leaf.d_out, leaf.group_size)
        else:
            out[path] = {"data": _raw(leaf)}
    return out


def _write_port(out, arch, model, cfg):
    w = part.ArtifactWriter(
        out, arch=arch, model_config=pfmt.model_config_to_json(cfg),
        ptqtp_config=pfmt.ptqtp_config_to_json(PTQTPConfig(group_size=G,
                                                           t_max=T_MAX)))
    for path, leaf in pfmt.iter_tree_leaves(to_reference_tree(model, cfg)):
        if isinstance(leaf, QuantizedKernel):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=cfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    return w.finalize()


def _write_ref(out, arch, qtree, jcfg):
    w = jart.ArtifactWriter(
        out, arch=arch, model_config=jart.format.model_config_to_json(jcfg),
        ptqtp_config=jart.format.ptqtp_config_to_json(
            JPTQTPConfig(group_size=G, t_max=T_MAX)))
    for path, leaf in jart.format.iter_tree_leaves(qtree):
        if hasattr(leaf, "t1p"):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=jcfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    return w.finalize()


@pytest.mark.parametrize("arch", ARCHS)
def test_artifacts_cross_both_ways(arch, tmp_path):
    """The quantized model written by the port's ``ArtifactWriter`` (over
    ``to_reference_tree``) and the reference's tree by the reference's:
    equal manifests (timing aside) and shard bytes; each package reads the
    other's with every checksum and the same bytes, and the port's model
    from either is byte for byte the one it wrote."""
    jcfg, _, qtree = _ref(arch)
    model, cfg = _port(qtree, arch)
    ours = _write_port(tmp_path / "port", arch, model, cfg)
    theirs = _write_ref(tmp_path / "ref", arch, qtree, jcfg)
    m_ours = json.loads((ours / "manifest.json").read_text())
    m_theirs = json.loads((theirs / "manifest.json").read_text())
    strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                       if k not in TIMING}
    assert strip(m_ours) == strip(m_theirs)
    for shard in m_theirs["shards"]:
        assert (ours / shard["file"]).read_bytes() == \
            (theirs / shard["file"]).read_bytes()
    back, _ = jart.load_artifact(ours, verify="full")
    assert _leaves(back) == _leaves(qtree)
    tree, _ = part.load_artifact(theirs, verify="full")
    assert _leaves(tree) == _leaves(qtree)
    again, _, _ = part.load_model(theirs, device="cpu")
    a, b = model.state_dict(), again.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["quantized", "fp"])
@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-moe-16b"])
def test_to_reference_tree_round_trips(arch, kind):
    """The tree of ``to_reference_tree`` has the reference's paths, key
    order (insertion order in the prefix and suffix blocks, sorted in the
    stacked blocks), shapes, dtypes and bytes; ``from_jax_params`` of it
    gives back the same tensors."""
    _, params, qtree = _ref(arch)
    ref_tree = qtree if kind == "quantized" else params
    model, cfg = _port(ref_tree, arch)
    tree = to_reference_tree(model, cfg)
    assert _leaves(tree) == _leaves(ref_tree)
    again = from_jax_params(tree, cfg, device="cpu")
    a, b = model.state_dict(), again.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- fixtures
def _serve(eng, reqs):
    hs = [eng.submit(p, SamplingParams(max_new_tokens=n)) for p, n in reqs]
    eng.run()
    return [list(h.output) for h in hs]


@pytest.mark.parametrize("name,layout", [("gemma3", "ring"),
                                         ("deepseek", "ring"),
                                         ("deepseek", "paged")])
def test_committed_fixture_serves_the_reference_streams(name, layout):
    """The JAX-written fixtures of ``make_artifact_fixture.py``: both
    packages read the same bytes, and the port serves the JAX engine's
    streams on the layout (the fleet, and on the ring the bucket-1 request
    alone)."""
    art = FIXTURES / f"{name}_smoke_artifact"
    spec = json.loads((FIXTURES / f"{name}_smoke_streams.json").read_text())
    tree, _ = part.load_artifact(art, verify="full")
    assert _leaves(tree) == _leaves(jart.load_artifact(art)[0])
    model, cfg, _ = part.load_model(art, device="cpu")
    reqs = [(r["prompt"], r["max_new_tokens"]) for r in spec["requests"]]
    kw = dict(spec["engine"])
    want = spec["streams"]
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=spec["paged"]["page_size"])
        want = spec["paged"]["streams"]
    assert _serve(ServingEngine(model, cfg, EngineConfig(**kw)), reqs) == want
    if layout == "ring":
        solo = spec["solo"]
        alone = _serve(ServingEngine(model, cfg, EngineConfig(**kw)),
                       [reqs[solo["index"]]])
        assert alone == [solo["tokens"]]


@pytest.mark.parametrize("arch", ["gemma3-27b", "deepseek-moe-16b"])
def test_quantize_and_serve_launchers_take_the_new_archs(arch, tmp_path,
                                                         capsys):
    """``launch.quantize --arch`` writes the smoke model's artifact and
    ``launch.serve --artifact`` serves it on the CPU; ``launch.serve``
    refuses an artifact whose model has a stub frontend, with the
    reference's message."""
    from repro_torch.launch import quantize, serve

    out = quantize.main(["--arch", arch, "--device", "cpu", "--out",
                         str(tmp_path / "a"), "--t-max", "2"])
    serve.main(["--artifact", str(out), "--device", "cpu", "--requests", "2",
                "--max-new", "3"])
    assert "[serve]" in capsys.readouterr().out
    man = json.loads((out / "manifest.json").read_text())
    man["model_config"]["embed_inputs"] = False
    (out / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(SystemExit):
        serve.main(["--artifact", str(out), "--device", "cpu"])
    assert "has a stub modality frontend" in capsys.readouterr().err
