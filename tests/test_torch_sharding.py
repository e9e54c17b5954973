"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding.partition``), on the production meshes as
jax ``AbstractMesh``es (no devices) and as ``{axis: size}`` maps.

Leaves line up through ``convert.reference_tree_of``: each parameter (and
each quantized buffer) of a meta-device port model is replaced by a one-
element tensor holding its index, and the reference's tree of those
tensors says which port leaf sits at each reference path (a layer of a
scan-stacked ``blocks`` leaf is one entry of its leading dim). A port
dense weight is (d_out, d_in), the reference's kernel (d_in, d_out): its
two dims swap; a stacked leaf's spec has the reference's leading None.

Also: the reference's own properties (every sharded dim divides; llama3-
405b replicates no tensor of 16 M elements or more), decode-state,
batch and activation specs, ``placements`` on a fake (2, 2, 2) process
group (local shapes and offsets, pod-major) and ``constrain``.
"""

from __future__ import annotations

import functools

import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.sharding import partition as jpart
from repro_torch import configs
from repro_torch.convert import reference_tree_of
from repro_torch.launch import specs
from repro_torch.models.common import Dense
from repro_torch.models.moe import ExpertDense
from repro_torch.sharding import api, partition as part

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
POLICIES = ("tp", "fsdp_all")
QUANT_BUFFERS = ("t1p", "t2p", "alpha")


def jmesh(kind):
    return AbstractMesh(*MESHES[kind])


def tmesh(kind):
    shape, axes = MESHES[kind]
    return dict(zip(axes, shape))


@functools.lru_cache(maxsize=None)
def ref_params(arch, quantized):
    cfg = jconfigs.get_config(arch)
    return (jspecs.quantized_params_specs(cfg) if quantized
            else jspecs.params_specs(cfg))


def port_model(arch, quantized):
    cfg = configs.get_config(arch)
    return (specs.quantized_params_specs(cfg) if quantized
            else specs.params_specs(cfg))


def index_tree(model, cfg):
    """(the reference-layout tree of each leaf's index, [leaf names]): a
    parameter or quantized buffer i becomes a one-element tensor holding
    i."""
    names = list(part.param_leaves(model))
    index = {n: i for i, n in enumerate(names)}
    one = lambda n, t: torch.full((1,) * t.dim(), float(index[n]),  # noqa
                                  dtype=torch.float64)
    for mname, module in model.named_modules():
        for b in QUANT_BUFFERS:
            if getattr(module, b, None) is not None:
                setattr(module, b, one(f"{mname}.{b}", getattr(module, b)))
    values = [one(n, p) for n, p in model.named_parameters()]
    return reference_tree_of(model, cfg, values), names


def ref_leaves(spec_tree, idx_tree, path=()):
    """(path, reference spec, index tensor) of every leaf, walking both
    trees together (a ``QuantizedKernel`` node by its three buffers)."""
    if isinstance(spec_tree, P):
        yield path, spec_tree, idx_tree
        return
    if hasattr(spec_tree, "t1p"):
        for b in QUANT_BUFFERS:
            yield from ref_leaves(getattr(spec_tree, b), getattr(idx_tree, b),
                                  path + (b,))
        return
    assert set(spec_tree) == set(idx_tree), (path, set(spec_tree),
                                             set(idx_tree))
    for k in spec_tree:
        yield from ref_leaves(spec_tree[k], idx_tree[k], path + (k,))


def check_param_specs(arch, mesh_kind, policy, quantized):
    cfg = configs.get_config(arch)
    model = port_model(arch, quantized)
    shapes = {n: tuple(t.shape) for n, t in part.param_leaves(model).items()}
    dense = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, (Dense, ExpertDense))}
    with jpart.parallelism_policy(policy), part.parallelism_policy(policy):
        want = jpart.param_pspecs(ref_params(arch, quantized),
                                  jmesh(mesh_kind))
        got = part.param_specs(model, tmesh(mesh_kind))
    assert set(got) == set(shapes)
    tree, names = index_tree(model, cfg)
    seen = set()
    for path, ref, idx in ref_leaves(want, tree):
        stacked = path[0] == "blocks"
        for i in idx.flatten().tolist():
            name = names[int(i)]
            mine = got[name]
            if name in dense:
                mine = mine[:-2] + (mine[-1], mine[-2])
            if stacked:
                mine = (None,) + mine
            assert mine == tuple(ref), (arch, path, name, mine, ref)
            seen.add(name)
    assert seen == set(got)
    return got, shapes


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_kind, policy):
    got, shapes = check_param_specs(arch, mesh_kind, policy, False)
    sizes = tmesh(mesh_kind)
    for name, s in got.items():
        assert len(s) == len(shapes[name])
        for dim, ax in zip(shapes[name], s):
            if ax is not None:
                assert dim % part._axis_size(sizes, ax) == 0, (name, s)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "grok-1-314b"])
def test_quantized_specs_equal_the_reference(arch, mesh_kind, policy):
    got, shapes = check_param_specs(arch, mesh_kind, policy, True)
    assert any(n.endswith(".t1p") for n in got)
    if arch != "qwen2-1.5b":
        experts = [n for n in got if ".experts." in n and n.endswith("t1p")]
        assert experts and all(len(got[n]) == 3 for n in experts)
    sizes = tmesh(mesh_kind)
    for name, s in got.items():
        for dim, ax in zip(shapes[name], s):
            if ax is not None:
                assert dim % part._axis_size(sizes, ax) == 0, (name, s)


def test_large_params_are_actually_sharded():
    """llama3-405b replicates no tensor of 16 M elements or more: FSDP/TP
    split every big matrix, or it cannot fit 256 chips."""
    model = specs.params_specs(configs.get_config("llama3-405b"))
    got = part.param_specs(model, tmesh("single"))
    big = 0
    for name, p in part.param_leaves(model).items():
        if p.numel() >= 16 * 1024 * 1024:
            big += 1
            assert any(ax is not None for ax in got[name]), (name, got[name])
    assert big >= 126 * 7


def _state_layers(tree, cfg):
    """The reference's per-layer caches in layer order: (cache, stacked,
    index into the stack)."""
    out = [(tree["prefix"][f"p{i}"], False, None)
           for i in range(len(cfg.prefix_pattern))]
    for i in range(cfg.n_periods):
        for pidx in range(cfg.period):
            out.append((tree["blocks"][f"b{pidx}"], True, i))
    out += [(tree["suffix"][f"s{i}"], False, None)
            for i in range(len(cfg.remainder_pattern))]
    return out


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_state_specs_equal_the_reference(arch, shape, seq):
    cfg = configs.get_config(arch)
    jstate, _ = jspecs.decode_state_specs(jconfigs.get_config(arch), shape)
    state, tokens = specs.decode_state_specs(cfg, shape)
    assert tokens.shape[0] == jconfigs.SHAPES[shape]["global_batch"]
    for mesh_kind in MESHES:
        for policy in POLICIES:
            with jpart.parallelism_policy(policy), \
                    part.parallelism_policy(policy):
                want = jpart.state_pspecs(jstate, jmesh(mesh_kind),
                                          sequence_sharded=seq)
                got = part.state_specs(state, tmesh(mesh_kind),
                                       sequence_sharded=seq)
            assert got["pos"] == tuple(want["pos"])
            ref = _state_layers(want, cfg)
            assert len(ref) == len(got["layers"]) == cfg.n_layers
            for mine, (theirs, stacked, _) in zip(got["layers"], ref):
                assert set(mine) == set(theirs)
                for name, s in mine.items():
                    assert ((None,) + s if stacked else s) == \
                        tuple(theirs[name]), (arch, name, s, theirs[name])


def test_paged_state_specs():
    """The paged layout: each pool leaf's spec is its per-layer view's with
    a leading None (the stacked attention layers), and the table's batch
    dim goes over the data-parallel axes."""
    from repro_torch.models.transformer import init_decode_state

    cfg = configs.get_config("qwen2-1.5b")
    state = init_decode_state(cfg, 128, 32768, device="meta",
                              kv_spec={"page_size": 16, "max_pages": 4094})
    got = part.state_specs(state, tmesh("single"), sequence_sharded=False)
    assert got["table"] == ("data", None)
    for name, s in got["pool"].items():
        assert s[0] is None and s[1:] == got["layers"][0][name], name
    assert got["pool"]["pages_k"] == (None, "data", None, None, None)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_kind", MESHES)
def test_batch_and_activation_specs_equal_the_reference(mesh_kind, policy):
    with jpart.parallelism_policy(policy), part.parallelism_policy(policy):
        for arch in configs.ARCH_IDS:
            for shape in ("train_4k", "prefill_32k"):
                jb = jspecs.batch_specs(jconfigs.get_config(arch), shape)
                want = jpart.batch_pspecs(jb, jmesh(mesh_kind))
                got = part.batch_specs(specs.batch_specs(
                    configs.get_config(arch), shape), tmesh(mesh_kind))
                assert got == {k: tuple(v) for k, v in want.items()}, arch
        for mode in ("train", "prefill", "decode", "decode_long"):
            want = jpart.activation_rules(jmesh(mesh_kind), mode=mode)
            got = part.activation_rules(tmesh(mesh_kind), mode=mode)
            assert got == {k: None if v is None else tuple(v)
                           for k, v in want.items()}, mode
    with pytest.raises(ValueError):
        part.activation_rules(tmesh(mesh_kind), mode="serve")


# ------------------------------------------------- a fake process group
@pytest.fixture
def fake_group(request):
    """A fake 8-rank process group, this process as rank ``request.param``
    (default 0), destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    rank = getattr(request, "param", 0)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    try:
        yield rank
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fake_group", range(8), indirect=True)
def test_placements_split_pod_major(fake_group):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    pod, data, model = mesh.get_coordinate()
    assert fake_group == pod * 4 + data * 2 + model
    s = (("pod", "data"), None, "model")
    shape = (16, 3, 10)
    local, offset = compute_local_shape_and_global_offset(
        shape, mesh, part.placements(s, mesh))
    assert tuple(local) == part.local_shape(shape, s, mesh) == (4, 3, 5)
    # jax's order: a dim over (pod, data) is split pod first
    assert tuple(offset) == ((pod * 2 + data) * 4, 0, model * 5)
    with pytest.raises(ValueError):
        part.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError):
        part.placements(("data", "data"), mesh)


def test_constrain(fake_group):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    plain = torch.ones(8, 4, 6)
    assert api.constrain(plain, "hidden") is plain
    x = DTensor.from_local(torch.ones(8, 4, 3), mesh,
                           [Replicate(), Replicate(), Shard(2)],
                           run_check=False)
    assert api.current_rules() is None
    assert api.constrain(x, "hidden") is x
    rules = part.activation_rules(mesh, mode="train")
    with api.activation_sharding(rules):
        assert api.current_rules() is rules
        assert api.constrain(plain, "hidden") is plain
        assert api.constrain(x, "unnamed") is x
        with api.activation_sharding(part.activation_rules(mesh,
                                                           mode="decode")):
            assert api.constrain(x, "hidden") is x   # the rule is None
        comm = CommDebugMode()
        with comm:
            y = api.constrain(x, "hidden")
    assert api.current_rules() is None
    assert y.placements == (Shard(0), Shard(0), Replicate())
    assert tuple(y.shape) == (8, 4, 6)
    assert tuple(y.to_local().shape) == (2, 4, 6)
    assert comm.get_total_counts() == 1
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert sum(v for k, v in counts.items() if "all_gather" in k) == 1


def test_param_counts_match_the_shapes():
    """``param_counts`` is analytic; on the dense archs it counts exactly
    the meta model's dense weights and embeddings."""
    for arch in ("qwen2-1.5b", "llama3-405b"):
        cfg = configs.get_config(arch)
        model = specs.params_specs(cfg)
        n = sum(p.numel() for name, p in model.named_parameters()
                if name.endswith("weight") or name == "embed")
        assert cfg.param_counts()[0] == n
