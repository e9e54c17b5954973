"""The reference registry's stub-frontend archs in the port, at smoke size:
musicgen-large (MHA, a GELU MLP, a 2048-entry codebook vocabulary at full
size) and phi-3-vision-4.2b (phi3-mini's MHA and SwiGLU at hd 96). Their
frontends (EnCodec, CLIP) are out of scope, as in the reference: the
decoder takes (B, S, D) embeddings, and ``decode_step`` (B, D).

Each arch is initialised by the reference from ``PRNGKey(0)``; the port
loads the same bytes (``from_jax_params``; the tree has no ``embed``
leaf). The same seeded embeddings go through both packages. Exact: the
planes of the port's ``quantize_tree`` (G = 64, t_max = 5), ring
positions, the artifacts either package writes (shard bytes and
manifests, timing fields aside) and reads, the tree of
``to_reference_tree``, and the launchers' refusals. Within rtol = atol =
1e-4 (f32 sums in another order; logits ~ 4): logits of ``forward``,
``prefill``, ``prefill_chunk`` and ``decode_step`` on embeddings, the
caches' k and v; α within rtol 1e-5 (the ridge sums run in another order).
"""

import dataclasses
import functools
import json
import re
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
from repro_torch import artifacts as part
from repro_torch import configs
from repro_torch.artifacts import format as pfmt
from repro_torch.convert import from_jax_params, to_reference_tree
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import quantize_tree
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill, prefill_chunk)
from repro_torch.serving import EngineConfig, ServingEngine

torch.set_num_threads(1)

ARCHS = ("musicgen-large", "phi-3-vision-4.2b")
G, T_MAX = 64, 5
TOL = dict(rtol=1e-4, atol=1e-4)
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


def _embeddings(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_registry_holds_the_stub_archs():
    """Both configs (full and smoke) equal the reference's; the full
    widths are the published ones."""
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            ours = dataclasses.asdict(getattr(configs, get)(arch))
            theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
            assert ours == theirs, (arch, get)
            assert not ours["embed_inputs"]
    mg, phi = (configs.get_config(a) for a in ARCHS)
    assert (mg.n_layers, mg.d_model, mg.head_dim, mg.n_kv_heads,
            mg.mlp_type, mg.vocab_size) == (48, 2048, 64, 32, "gelu", 2048)
    assert (phi.n_layers, phi.d_model, phi.head_dim, phi.n_kv_heads,
            phi.vocab_size) == (32, 3072, 96, 32, 32064)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_has_no_embedding_and_takes_floats(arch):
    """No ``embed`` parameter or leaf; token ids are refused with a
    TypeError, embeddings of the wrong width too."""
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.embed is None
    assert not any(k.startswith("embed") for k in model.state_dict())
    assert "embed" not in to_reference_tree(model, cfg)
    state = init_decode_state(cfg, 2, 16, device="cpu")
    with pytest.raises(TypeError, match="stub frontend"):
        decode_step(model, cfg, state, torch.tensor([1, 2]))
    with pytest.raises(TypeError, match="stub frontend"):
        forward(model, cfg, torch.zeros((2, 3, cfg.d_model + 1)))


# (kind, lengths or active); a prefill chunk is (B, 12, D) or (B, 4, D) of
# seeded embeddings, right-padded with zeros past each row's length
STEPS = [("prefill", 12, [12, 5, 0]), ("prefill", 12, [12, 0, 8]),
         ("decode", None, [True, True, False]),
         ("decode", None, [True, True, True]),
         ("prefill", 4, [4, 0, 4])]
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
def test_logits_and_caches_from_embeddings_match_the_reference(arch):
    """``forward`` over 24 embeddings, ``prefill`` of 20, then chunked
    serving steps on embeddings (padding, no-op rows, decode on (B, D) with
    a frozen row): logits within 1e-4, ring positions exact, k/v within
    1e-4."""
    jcfg, _, qtree = _ref(arch)
    model, cfg = _port(qtree, arch)
    rng = np.random.default_rng(0)
    emb = _embeddings(rng, 2, 24, cfg.d_model)
    want = np.asarray(jforward(qtree, jcfg, {"embeddings": jnp.asarray(emb)}))
    got = forward(model, cfg, torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    jl, _ = jprefill(qtree, jcfg, {"embeddings": jnp.asarray(emb[:, :20])},
                     CAP)
    pl, _ = prefill(model, cfg, torch.from_numpy(emb[:, :20]), CAP)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)

    jstate = jinit_decode_state(jcfg, B, CAP)
    state = init_decode_state(cfg, B, CAP, device="cpu")
    for step, (kind, width, arg) in enumerate(STEPS):
        if kind == "prefill":
            lens = np.asarray(arg, np.int32)
            x = _embeddings(rng, B, width, cfg.d_model)
            x[np.arange(width)[None, :] >= lens[:, None]] = 0.0
            jl, jstate = jprefill_chunk(qtree, jcfg, jstate,
                                        {"embeddings": jnp.asarray(x)},
                                        jnp.asarray(lens))
            logits, state = prefill_chunk(model, cfg, state,
                                          torch.from_numpy(x),
                                          torch.from_numpy(lens))
            rows = lens > 0
        else:
            act = np.asarray(arg)
            x = _embeddings(rng, B, cfg.d_model)
            jl, jstate = jdecode_step(qtree, jcfg, jstate, jnp.asarray(x),
                                      jnp.asarray(act))
            logits, state = decode_step(model, cfg, state,
                                        torch.from_numpy(x),
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


def _quant_buffers(model):
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("t1p", "t2p", "alpha")}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_leaves_equal_the_reference(arch):
    """The port quantizes the reference's fp weights into the reference's
    planes (the same leaves quantized), α within rtol 1e-5."""
    _, params, qtree = _ref(arch)
    model, _ = _port(params, arch)
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


@pytest.mark.parametrize("kind", ["quantized", "fp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_tree_round_trips(arch, kind):
    """The tree of ``to_reference_tree`` has the reference's paths (no
    ``embed``), key order, shapes, dtypes and bytes; ``from_jax_params``
    of it gives back the same tensors."""
    _, params, qtree = _ref(arch)
    ref_tree = qtree if kind == "quantized" else params
    model, cfg = _port(ref_tree, arch)
    tree = to_reference_tree(model, cfg)
    assert list(tree) == list(ref_tree)
    assert _leaves(tree) == _leaves(ref_tree)
    again = from_jax_params(tree, cfg, device="cpu")
    a, b = model.state_dict(), again.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _write(writer_cls, fmt, out, arch, tree, model_cfg, param_dtype):
    w = writer_cls(
        out, arch=arch, model_config=fmt.model_config_to_json(model_cfg),
        ptqtp_config=fmt.ptqtp_config_to_json(
            JPTQTPConfig(group_size=G, t_max=T_MAX)))
    for path, leaf in fmt.iter_tree_leaves(tree):
        if hasattr(leaf, "t1p"):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=param_dtype)
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
    ours = _write(part.ArtifactWriter, pfmt, tmp_path / "port", arch,
                  to_reference_tree(model, cfg), cfg, cfg.param_dtype)
    theirs = _write(jart.ArtifactWriter, jart.format, tmp_path / "ref", arch,
                    qtree, jcfg, jcfg.param_dtype)
    m_ours = json.loads((ours / "manifest.json").read_text())
    m_theirs = json.loads((theirs / "manifest.json").read_text())
    strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                       if k not in TIMING}
    assert strip(m_ours) == strip(m_theirs)
    assert not m_ours["model_config"]["embed_inputs"]
    for shard in m_theirs["shards"]:
        assert (ours / shard["file"]).read_bytes() == \
            (theirs / shard["file"]).read_bytes()
    back, _ = jart.load_artifact(ours, verify="full")
    assert _leaves(back) == _leaves(qtree)
    tree, _ = part.load_artifact(theirs, verify="full")
    assert _leaves(tree) == _leaves(qtree)
    again, again_cfg, _ = part.load_model(theirs, device="cpu")
    assert again.embed is None and not again_cfg.embed_inputs
    a, b = model.state_dict(), again.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- launchers
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_quantize_and_refuse_token_serving(arch, tmp_path, capsys):
    """``launch.quantize --arch`` writes the smoke model's artifact (no
    ``embed`` leaf); ``launch.serve`` refuses the arch and the artifact
    with the reference's messages; the engine refuses the model."""
    from repro_torch.launch import quantize, serve

    out = quantize.main(["--arch", arch, "--device", "cpu", "--out",
                         str(tmp_path / "a"), "--t-max", "2"])
    man = json.loads((out / "manifest.json").read_text())
    assert man["arch"] == arch and not man["model_config"]["embed_inputs"]
    assert man["tensors"] and not any("embed" in p for p in man["tensors"])
    assert man["stats"]["n_quantized"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--artifact", str(out), "--device", "cpu"])
    assert "has a stub modality frontend" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--device", "cpu"])
    assert (f"{arch} has a stub modality frontend; token serving applies "
            "to LM archs") in capsys.readouterr().err
    model, cfg, _ = part.load_model(out, device="cpu")
    with pytest.raises(ValueError, match="stub modality frontend"):
        ServingEngine(model, cfg, EngineConfig(max_slots=2, capacity=16))


def test_profile_decode_takes_the_token_archs():
    """``launch.profile_decode --arch`` offers every arch the engine
    serves: the registry's but the stub-frontend ones."""
    from repro_torch.launch import profile_decode

    assert set(profile_decode.ARCHS) == set(configs.ARCH_IDS) - set(ARCHS)
    assert {"recurrentgemma-2b", "rwkv6-3b"} <= set(profile_decode.ARCHS)
    with pytest.raises(SystemExit):
        profile_decode.main(["--arch", ARCHS[0]])


def test_profile_decode_columns_name_the_kernels():
    """Every column of ``profile_decode``'s table matches the name of a
    CUDA kernel in the sources (the norm's column once named ``rms_norm``,
    which no kernel is called since the norm's redesign, and read 0)."""
    from repro_torch.launch import profile_decode

    csrc = Path(profile_decode.__file__).resolve().parents[1] / "kernels"
    names = set()
    for path in csrc.glob("*/csrc/*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)"
            r"\s*\(", path.read_text()))
    assert "norm_kernel" in names
    for fragment, column in profile_decode.COLUMNS:
        assert any(fragment in n for n in names), (column, sorted(names))
