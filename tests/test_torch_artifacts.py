"""The port's artifact store against the reference's: the same bytes on disk
in both directions, the same integrity checks and messages, and the same
served tokens.

Exact: every buffer an artifact holds, read by either package; the shard
files and manifest (timing fields aside) of an already quantized model
written by either package's ``ArtifactWriter``; the planes of a streaming
write; the damage the fault helpers do for a seed; every error message of
the reader; greedy token streams served from an artifact. Within rtol 1e-5:
the group scales α of a streaming write (the ridge sums b1, b2 run in
another order, ROADMAP C) and its ``rel_fro_error`` statistic.
"""

import dataclasses
import json
import shutil
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
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving import faults as jfaults
from repro_torch import artifacts as part
from repro_torch import configs
from repro_torch.artifacts import format as pfmt
from repro_torch.convert import from_jax_params, to_reference_tree
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine
from repro_torch.serving import faults as pfaults

torch.set_num_threads(1)

ARCH = "qwen2-1.5b"
G, T_MAX = 32, 3
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
TIMING = ("created", "finalized")


@pytest.fixture(scope="module")
def fp():
    """The reference's smoke qwen2-1.5b params and config."""
    cfg = jconfigs.get_smoke_config(ARCH)
    return cfg, jinit_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ref_artifact(fp, tmp_path_factory):
    """An artifact written by ``repro.artifacts.write_artifact``."""
    cfg, params = fp
    out = tmp_path_factory.mktemp("ref") / "model"
    jart.write_artifact(out, arch=ARCH, model_cfg=cfg,
                        ptqtp_cfg=JPTQTPConfig(group_size=G, t_max=T_MAX),
                        params=params)
    return out


def _leaves(tree):
    """{path: {buffer: raw bytes}} of a loaded tree of either package."""
    out = {}
    for path, leaf in jart.format.iter_tree_leaves(tree):
        if hasattr(leaf, "t1p"):
            out[path] = {f: _raw(getattr(leaf, f)) for f in pfmt.QK_BUFFERS}
            out[path]["meta"] = (leaf.d_in, leaf.d_out, leaf.group_size)
        else:
            out[path] = {"data": _raw(leaf)}
    return out


def _raw(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), pfmt.dtype_name(a), pfmt.byte_view(a).tobytes())
    a = np.asarray(a)
    return (tuple(a.shape), str(a.dtype),
            np.ascontiguousarray(a).view(np.uint8).tobytes())


def _without(manifest, keys=TIMING):
    return {k: v for k, v in manifest.items() if k not in keys}


def write_quantized(out, model, cfg, ptqtp_cfg, **kw):
    """An already quantized port model through ``ArtifactWriter``
    (``add_quantized`` / ``add_fp`` over ``to_reference_tree``)."""
    w = part.ArtifactWriter(out, arch=ARCH,
                            model_config=pfmt.model_config_to_json(cfg),
                            ptqtp_config=pfmt.ptqtp_config_to_json(ptqtp_cfg),
                            **kw)
    for path, leaf in pfmt.iter_tree_leaves(to_reference_tree(model, cfg)):
        if isinstance(leaf, QuantizedKernel):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=cfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    return w.finalize()


def jwrite_quantized(out, qtree, cfg, ptqtp_cfg):
    """The reference's ``ArtifactWriter`` over its quantized tree."""
    w = jart.ArtifactWriter(
        out, arch=ARCH, model_config=jart.format.model_config_to_json(cfg),
        ptqtp_config=jart.format.ptqtp_config_to_json(ptqtp_cfg))
    for path, leaf in jart.format.iter_tree_leaves(qtree):
        if hasattr(leaf, "t1p"):
            lead = tuple(leaf.t1p.shape[:-2])
            w.add_quantized(path, leaf,
                            source_shape=lead + (leaf.d_in, leaf.d_out),
                            source_dtype=cfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    return w.finalize()


# ------------------------------------------------------------- format / read
def test_reference_artifact_loads_byte_identical(ref_artifact):
    jtree, jman = jart.load_artifact(ref_artifact, verify="full")
    tree, man = part.load_artifact(ref_artifact, verify="full")
    assert man == jman
    a, b = _leaves(jtree), _leaves(tree)
    assert list(a) == list(b)
    assert a == b
    assert dataclasses.asdict(part.load_model_config(man)) == \
        dataclasses.asdict(jart.load_model_config(jman))
    assert part.load_model_config(man) == configs.get_smoke_config(ARCH)


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    """bf16 leaves: written by either package as dtype "bfloat16", read by
    the other with equal bytes (the port through a uint16 view)."""
    rng = np.random.default_rng(5)
    tree = {"layer": {"kernel": jnp.asarray(rng.standard_normal((64, 32)),
                                            jnp.bfloat16)},
            "norm": {"scale": jnp.asarray(rng.standard_normal(32),
                                          jnp.bfloat16)}}
    cfg = jconfigs.get_smoke_config(ARCH)
    jart.write_artifact(tmp_path / "ref", arch=ARCH, model_cfg=cfg,
                        ptqtp_cfg=JPTQTPConfig(group_size=G, t_max=T_MAX),
                        params=tree)
    loaded, _ = part.load_artifact(tmp_path / "ref", verify="full")
    assert loaded["norm"]["scale"].dtype == torch.bfloat16
    assert _leaves(loaded) == _leaves(jart.load_artifact(tmp_path / "ref")[0])
    # the port writes a bf16 torch tensor; the reference reads it back
    scale = torch.from_numpy(np.array(tree["norm"]["scale"]).view(
        np.uint16)).view(torch.bfloat16)
    w = part.ArtifactWriter(tmp_path / "port", arch=ARCH,
                            model_config=pfmt.model_config_to_json(
                                configs.get_smoke_config(ARCH)),
                            ptqtp_config=pfmt.ptqtp_config_to_json(
                                PTQTPConfig(group_size=G, t_max=T_MAX)))
    w.add_fp("/norm/scale", scale)
    w.finalize()
    back, man = jart.load_artifact(tmp_path / "port", verify="full")
    assert man["tensors"]["/norm/scale"]["buffers"]["data"]["dtype"] == \
        "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(back["norm"]["scale"]).view(np.uint16),
        np.asarray(tree["norm"]["scale"]).view(np.uint16))


@pytest.mark.parametrize("mode", ["off", "sizes", "full", True, False])
def test_verify_modes_on_an_intact_artifact(ref_artifact, mode):
    tree, _ = part.load_artifact(ref_artifact, verify=mode)
    assert tree
    if mode in ("sizes", "full"):
        assert part.verify_artifact(ref_artifact, mode) == \
            jart.verify_artifact(ref_artifact, mode)
    elif mode == "off":
        with pytest.raises(ValueError):
            part.verify_artifact(ref_artifact, mode)


def test_cpu_leaves_view_the_shard_maps(ref_artifact):
    """Loaded without a device, every buffer views its shard's map: no
    second host copy is made."""
    tree, man = part.load_artifact(ref_artifact)
    maps = {}
    for path, rec in man["tensors"].items():
        leaf = tree
        for p in path.strip("/").split("/"):
            leaf = leaf[p]
        bufs = ({f: getattr(leaf, f) for f in pfmt.QK_BUFFERS}
                if isinstance(leaf, QuantizedKernel) else {"data": leaf})
        for name, buf in rec["buffers"].items():
            base = bufs[name].untyped_storage().data_ptr()
            maps.setdefault(buf["shard"], base - buf["offset"])
            assert base - buf["offset"] == maps[buf["shard"]], path


def _damage(kind, art):
    """Apply one kind of damage to an artifact directory."""
    man_p = art / "manifest.json"
    if kind == "corrupt_crc":
        return pfaults.corrupt_artifact_shard(art, seed=3)
    if kind == "truncated_shard":
        return pfaults.truncate_artifact_shard(art, seed=0, drop_bytes=7)
    if kind == "oversized_shard":
        with open(art / "shard_00000.bin", "ab") as f:
            f.write(b"\0" * 5)
    elif kind == "format_version":
        m = json.loads(man_p.read_text())
        man_p.write_text(json.dumps(dict(m, format_version=99)))
    elif kind == "incomplete":
        m = json.loads(man_p.read_text())
        man_p.write_text(json.dumps(dict(m, complete=False)))
    elif kind == "no_manifest":
        man_p.unlink()
    return None


# damage -> (the lowest verify mode that catches it, a word of the message)
DAMAGE = {"corrupt_crc": ("full", "checksum mismatch"),
          "truncated_shard": ("off", "truncated"),
          "oversized_shard": ("sizes", "oversized"),
          "format_version": ("off", "format_version"),
          "incomplete": ("off", "incomplete"),
          "no_manifest": ("off", "not an artifact directory")}


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_damaged_artifact_raises_as_the_reference(ref_artifact, tmp_path,
                                                  kind):
    """Each damage is caught by the same verify mode in both readers, with
    the same message; a weaker mode lets it pass in both. The fault
    helpers damage the same bytes for a seed."""
    lowest, word = DAMAGE[kind]
    art = tmp_path / "art"
    shutil.copytree(ref_artifact, art)
    twin = tmp_path / "twin"
    shutil.copytree(ref_artifact, twin)
    got = _damage(kind, art)
    if kind == "corrupt_crc":
        assert jfaults.corrupt_artifact_shard(twin, seed=3) == got
    elif kind == "truncated_shard":
        assert jfaults.truncate_artifact_shard(twin, seed=0,
                                               drop_bytes=7) == got
    if got is not None:
        for f in sorted(p.name for p in art.iterdir()):
            assert (art / f).read_bytes() == (twin / f).read_bytes(), f
    modes = ("off", "sizes", "full")
    for mode in modes:
        if modes.index(mode) < modes.index(lowest):
            part.load_artifact(art, verify=mode)
            jart.load_artifact(art, verify=mode)
            continue
        with pytest.raises(part.ArtifactError) as ours:
            part.load_artifact(art, verify=mode)
        with pytest.raises(jart.ArtifactError) as theirs:
            jart.load_artifact(art, verify=mode)
        assert str(ours.value) == str(theirs.value)
        assert word in str(ours.value)
    if got is not None and kind == "corrupt_crc":
        msg = str(ours.value)
        assert got["tensor"] in msg and f"{got['crc32']:#010x}" in msg


# ------------------------------------------------------------- write
@pytest.fixture(scope="module")
def quantized(fp):
    """The reference's quantized tree and the port model with its bytes."""
    cfg, params = fp
    qtree, _ = jquantize_tree(params, JPTQTPConfig(group_size=G, t_max=T_MAX))
    pcfg = configs.get_smoke_config(ARCH)
    model = from_jax_params(jax.tree.map(np.asarray, qtree), pcfg,
                            device="cpu")
    return qtree, model, pcfg


def test_port_written_artifact_equals_the_reference_writers(quantized, fp,
                                                            tmp_path):
    """An already quantized model written by the port's ArtifactWriter and
    the same tree by the reference's: equal shard files and manifests
    (timing fields aside); the reference reads the port's with every
    checksum intact and the same bytes."""
    qtree, model, pcfg = quantized
    ours = write_quantized(tmp_path / "port", model, pcfg,
                           PTQTPConfig(group_size=G, t_max=T_MAX))
    theirs = jwrite_quantized(tmp_path / "ref", qtree, fp[0],
                              JPTQTPConfig(group_size=G, t_max=T_MAX))
    m_ours = json.loads((ours / "manifest.json").read_text())
    m_theirs = json.loads((theirs / "manifest.json").read_text())
    assert _without(m_ours) == _without(m_theirs)
    for shard in m_theirs["shards"]:
        assert (ours / shard["file"]).read_bytes() == \
            (theirs / shard["file"]).read_bytes()
    back, _ = jart.load_artifact(ours, verify="full")
    assert _leaves(back) == _leaves(qtree)


def test_streaming_write_matches_the_reference(fp, tmp_path):
    """``write_artifact`` of the port's FP model (quantizing leaf by leaf)
    against the reference's of the same weights: planes and FP leaves
    exact, α and the error statistic within rtol 1e-5, the manifests equal
    but for those; the reference reads the port's artifact."""
    cfg, params = fp
    pcfg = configs.get_smoke_config(ARCH)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg,
                            device="cpu")
    events = []
    ours = part.write_artifact(tmp_path / "port", arch=ARCH, model_cfg=pcfg,
                               ptqtp_cfg=PTQTPConfig(group_size=G,
                                                     t_max=T_MAX),
                               params=to_reference_tree(model, pcfg),
                               progress=events.append)
    theirs = jart.write_artifact(tmp_path / "ref", arch=ARCH, model_cfg=cfg,
                                 ptqtp_cfg=JPTQTPConfig(group_size=G,
                                                        t_max=T_MAX),
                                 params=params)
    assert [e["action"] for e in events].count("quantize") == 8
    a, _ = jart.load_artifact(theirs, verify="full")
    b, _ = jart.load_artifact(ours, verify="full")
    la, lb = _leaves(a), _leaves(b)
    assert list(la) == list(lb)
    for path in la:
        for name in la[path]:
            if name == "alpha":
                x = np.frombuffer(la[path][name][2], np.float32)
                y = np.frombuffer(lb[path][name][2], np.float32)
                assert la[path][name][:2] == lb[path][name][:2]
                np.testing.assert_allclose(y, x, rtol=1e-5, err_msg=path)
            else:
                assert la[path][name] == lb[path][name], (path, name)
    ma = json.loads((theirs / "manifest.json").read_text())
    mb = json.loads((ours / "manifest.json").read_text())
    for path, rec in ma["tensors"].items():
        other = mb["tensors"][path]
        if rec["kind"] == "ptqtp":
            assert other["error"]["rel_fro_error"] == pytest.approx(
                rec["error"]["rel_fro_error"], rel=1e-5)
            for m in (rec, other):
                m["error"] = None
                m["buffers"]["alpha"]["crc32"] = None
    assert _without(mb) == _without(ma)


def test_resume_after_interrupted_write(fp, tmp_path):
    """Killed mid-write (group commit of 4, killed at the 6th tensor): the
    re-run skips the committed group, truncates the torn tail, and the
    result is the same artifact as one write in one go."""
    cfg, params = fp
    pcfg = configs.get_smoke_config(ARCH)
    tree = to_reference_tree(from_jax_params(
        jax.tree.map(np.asarray, params), pcfg, device="cpu"), pcfg)
    kw = dict(arch=ARCH, model_cfg=pcfg,
              ptqtp_cfg=PTQTPConfig(group_size=G, t_max=T_MAX), params=tree,
              commit_every=4)

    class Interrupt(Exception):
        pass

    def interrupter(ev):
        if ev["index"] + 1 == 6:
            raise Interrupt

    out = tmp_path / "art"
    with pytest.raises(Interrupt):
        part.write_artifact(out, progress=interrupter, **kw)
    assert not out.exists()
    staging = out.with_name(out.name + ".staging")
    partial = json.loads((staging / "manifest.json").read_text())
    assert len(partial["tensors"]) == 4 and not partial["complete"]
    shard = partial["shards"][-1]
    with open(staging / shard["file"], "ab") as f:
        f.write(b"\xde\xad\xbe\xef")
    assert (staging / shard["file"]).stat().st_size > shard["nbytes"]
    events = []
    part.write_artifact(out, progress=events.append, **kw)
    assert [e["action"] for e in events].count("skip") == 4
    assert not staging.exists()
    once = part.write_artifact(tmp_path / "once", **kw)
    for f in ("shard_00000.bin",):
        assert (out / f).read_bytes() == (once / f).read_bytes()
    assert _without(json.loads((out / "manifest.json").read_text())) == \
        _without(json.loads((once / "manifest.json").read_text()))
    with pytest.raises(part.ArtifactError, match="already exists"):
        part.write_artifact(out, **kw)


@pytest.mark.parametrize("kind", ["quantized", "fp"])
def test_to_reference_tree_round_trips(quantized, fp, kind):
    """``from_jax_params(to_reference_tree(m))`` holds byte-identical
    tensors, and the tree has the reference's paths, order, shapes and
    dtypes."""
    qtree, model, pcfg = quantized
    ref_tree = qtree
    if kind == "fp":
        ref_tree = fp[1]
        model = from_jax_params(jax.tree.map(np.asarray, ref_tree), pcfg,
                                device="cpu")
    tree = to_reference_tree(model, pcfg)
    assert _leaves(tree) == _leaves(ref_tree)
    again = from_jax_params(tree, pcfg, device="cpu")
    a, b = model.state_dict(), again.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- serve
def _serve(eng, reqs, sp):
    hs = [eng.submit(p, sp(max_new_tokens=n)) for p, n in reqs]
    eng.run()
    return [list(h.output) for h in hs]


ENGINE = dict(max_slots=3, capacity=64, prefill_chunk=16, decode_chunk=4)
REQS = [(np.random.default_rng(i).integers(0, 512, n).tolist(), b)
        for i, (n, b) in enumerate(((5, 6), (23, 9), (40, 12), (9, 3)))]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_served_from_artifact_equals_reference_engine(ref_artifact, fp,
                                                      layout):
    kw = dict(ENGINE, kv_layout=layout, page_size=8)
    jtree, _ = jart.load_artifact(ref_artifact)
    want = _serve(JServingEngine(jtree, fp[0], JEngineConfig(**kw)), REQS,
                  JSamplingParams)
    model, cfg, _ = part.load_model(ref_artifact, verify="sizes",
                                    device="cpu")
    got = _serve(ServingEngine(model, cfg, EngineConfig(**kw)), REQS,
                 SamplingParams)
    assert got == want


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_committed_fixture_serves_the_reference_streams(layout):
    """The fixture written by ``make_artifact_fixture.py``: both packages
    read the same bytes, and the port serves the JAX engine's streams (the
    fleet, and the bucket-1 request alone)."""
    art = FIXTURES / "qwen2_smoke_artifact"
    spec = json.loads((FIXTURES / "qwen2_smoke_streams.json").read_text())
    tree, _ = part.load_artifact(art, verify="full")
    assert _leaves(tree) == _leaves(jart.load_artifact(art)[0])
    model, cfg, _ = part.load_model(art, device="cpu")
    kw = dict(spec["engine"], kv_layout=layout, page_size=8)
    reqs = [(r["prompt"], r["max_new_tokens"]) for r in spec["requests"]]
    got = _serve(ServingEngine(model, cfg, EngineConfig(**kw)), reqs,
                 SamplingParams)
    assert got == spec["streams"]
    solo = spec["solo"]
    alone = _serve(ServingEngine(model, cfg, EngineConfig(**kw)),
                   [reqs[solo["index"]]], SamplingParams)
    assert alone == [solo["tokens"]]


def test_quantize_and_serve_launchers_on_cpu(tmp_path, capsys):
    from repro_torch.launch import quantize, serve

    out = quantize.main(["--device", "cpu", "--out", str(tmp_path / "a"),
                         "--t-max", "2", "--verify", "--commit-every", "3"])
    log = capsys.readouterr().out
    assert "8 kernels quantized, 7 FP leaves" in log
    assert "verify: all checksums OK" in log
    assert jart.read_manifest(out)["complete"]
    # --from-checkpoint is ported (tests/test_torch_training.py); a
    # directory with no checkpoint raises as the reference's does
    with pytest.raises(FileNotFoundError, match="no LATEST"):
        quantize.main(["--device", "cpu", "--out", str(tmp_path / "b"),
                       "--from-checkpoint", str(tmp_path)])
    results = serve.main(["--device", "cpu", "--artifact", str(out),
                          "--verify-artifact", "sizes", "--requests", "2",
                          "--max-new", "3"])
    assert [len(r.tokens) for r in results] == [3, 3]
    log = capsys.readouterr().out
    assert "boot by phase: manifest_read" in log and "model_build" in log
    assert "2 requests, 6 tokens" in log


def test_model_config_json_equals_the_references():
    for get in ("get_config", "get_smoke_config"):
        ours = getattr(configs, get)(ARCH)
        theirs = getattr(jconfigs, get)(ARCH)
        assert pfmt.model_config_to_json(ours) == \
            jart.format.model_config_to_json(theirs)
        assert pfmt.model_config_from_json(
            jart.format.model_config_to_json(theirs)) == ours
    p = PTQTPConfig(group_size=64, t_max=7)
    assert pfmt.ptqtp_config_to_json(p) == jart.format.ptqtp_config_to_json(
        JPTQTPConfig(group_size=64, t_max=7))
    assert pfmt.ptqtp_config_from_json(pfmt.ptqtp_config_to_json(p)) == p
