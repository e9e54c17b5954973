"""The port's dry run (``repro_torch.launch.dryrun`` / ``.sweep``), roofline
(``repro_torch.roofline.analysis``) and config bookkeeping (``SHAPES``,
``param_counts``, ``runnable_cells``) against the reference's on the same
inputs, and the meta-device FLOP count against closed forms.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
devices) when first imported; the fixture below puts the variable back
before any jax backend could read it, so nothing leaks into other tests.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jconfigs
from repro.roofline import analysis as jroofline
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun, sweep
from repro_torch.roofline import analysis as roofline

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": False, "multi": True}

HLO = """HloModule collectives

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p0: bf16[16,128], p1: f32[8]) -> bf16[256,128] {
  %p0 = bf16[16,128]{1,0} parameter(0)
  %p1 = f32[8]{0} parameter(1)
  %ag = bf16[256,128]{1,0} all-gather(bf16[16,128]{1,0} %p0), dimensions={0}
  %ags = (bf16[16,128]{1,0}, bf16[256,128]{1,0}) all-gather-start(bf16[16,128]{1,0} %p0), dimensions={0}
  %agd = bf16[256,128]{1,0} all-gather-done((bf16[16,128]{1,0}, bf16[256,128]{1,0}) %ags)
  %ar = (f32[8]{0}, bf16[16,128]{1,0}) all-reduce(f32[8]{0} %p1, bf16[16,128]{1,0} %p0), to_apply=%add
  %ar.1 = f32[8]{0} all-reduce.1(f32[8]{0} %p1), to_apply=%add
  %rs = bf16[1,128]{1,0} reduce-scatter(bf16[16,128]{1,0} %p0), dimensions={0}, to_apply=%add
  %a2a = bf16[16,128]{1,0} all-to-all(bf16[16,128]{1,0} %p0), dimensions={0}
  %cp = f32[8]{0} collective-permute(f32[8]{0} %p1), source_target_pairs={{0,1}}
  %cps = (f32[8]{0}, f32[8]{0}, u32[], u32[]) collective-permute-start(f32[8]{0} %p1), source_target_pairs={{0,1}}
  ROOT %out = bf16[256,128]{1,0} copy(bf16[256,128]{1,0} %ag)
}
"""


@pytest.fixture(scope="module")
def jdryrun():
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jd


def test_shape_bytes_and_collectives_equal_the_reference():
    for s in ("bf16[2,3]{1,0}", "(bf16[2,3]{1,0}, u8[4])", "f32[]",
              "(f32[8]{0}, f32[8]{0}, u32[], u32[])", "weird[4]",
              "pred[7] s4[2,2] f8e4m3fn[3]"):
        assert roofline.shape_bytes(s) == jroofline.shape_bytes(s), s
    got = roofline.parse_collectives(HLO).to_dict()
    assert got == jroofline.parse_collectives(HLO).to_dict()
    assert all(got["counts"][op] for op in roofline.COLLECTIVE_OPS), got
    # two all-gathers of the (16, 128) bf16 operand, one a -start
    assert got["counts"]["all-gather"] == 2
    assert got["by_op"]["all-gather"] == 2 * 16 * 128 * 2
    # the tuple-operand all-reduce and the numbered one
    assert got["by_op"]["all-reduce"] == (8 * 4 + 16 * 128 * 2) + 8 * 4


def test_roofline_terms_on_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (
        989e12, 3.35e12, 450e9)
    assert (roofline.BF16_FLOPS, roofline.HBM_BYTES_PER_S) == (989e12,
                                                               3.35e12)
    for f, b, c in ((1e15, 1e9, 1e9), (1e12, 1e13, 1e9), (0, 1e6, 1e12)):
        t = roofline.roofline_terms(f, b, c)
        want = {"compute": f / 989e12, "memory": b / 3.35e12,
                "collective": c / 450e9}
        assert t["compute_s"] == want["compute"]
        assert t["memory_s"] == want["memory"]
        assert t["collective_s"] == want["collective"]
        dom = max(want, key=want.get)
        assert t["dominant"] == dom
        assert t["step_lower_bound_s"] == want[dom]
        assert t["roofline_fraction"] == want["compute"] / want[dom]


def test_param_counts_equal_the_reference():
    for arch in configs.ARCH_IDS:
        assert configs.get_config(arch).param_counts() == \
            jconfigs.get_config(arch).param_counts(), arch
    assert SHAPES == jconfigs.SHAPES


def test_cells_model_flops_and_policy_equal_the_reference(jdryrun):
    from repro.launch import sweep as jsweep

    assert sorted(configs.runnable_cells()) == \
        sorted(jconfigs.runnable_cells())
    assert len(configs.runnable_cells()) == len(set(configs.runnable_cells()))
    for q in (False, True):
        assert sorted(sweep.cells(q)) == sorted(jsweep.cells(q))
    for arch, shape in configs.runnable_cells():
        info = SHAPES[shape]
        train = info["kind"] == "train"
        assert roofline.model_flops(configs.get_config(arch), info,
                                    train=train) == \
            jroofline.model_flops(jconfigs.get_config(arch), info,
                                  train=train), (arch, shape)
        for mesh, multi in MESHES.items():
            assert dryrun.choose_policy(arch, shape, multi_pod=multi) == \
                jdryrun.choose_policy(arch, shape, multi_pod=multi), \
                (arch, shape, mesh)
            for dp in (16, 32, 256, 512):
                assert dryrun._effective_microbatches(
                    configs.get_config(arch), info["global_batch"], dp) == \
                    jdryrun._effective_microbatches(
                        jconfigs.get_config(arch), info["global_batch"], dp)
    assert "fsdp_all" in {dryrun.choose_policy(a, s) for a, s in
                          configs.runnable_cells()}


def _dense_layer_flops(cfg, m):
    d, hd = cfg.d_model, cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return 2 * m * (d * q + 2 * d * kv + q * d + 3 * d * cfg.d_ff)


def test_prefill_flops_of_a_dense_smoke_config():
    """llama3-405b's smoke config (2 layers, d 64, 8/2 heads of 8, d_ff
    128, vocab 512) at prefill_32k: the counted trunk equals the closed
    form (every linear over B·S rows, both attention products over S²),
    one row scaled by the batch equals two rows counted, and the step adds
    the head over the batch's last positions (32 rows in one 128-row
    block)."""
    cfg = configs.get_smoke_config("llama3-405b")
    s = SHAPES["prefill_32k"]["seq_len"]

    def closed(rows):
        attn = 2 * 2 * rows * s * s * cfg.n_heads * cfg.head_dim
        return cfg.n_layers * (_dense_layer_flops(cfg, rows * s) + attn)

    one = dryrun.count_flops(cfg, "prefill_32k", quantized=False, rows=1)
    two = dryrun.count_flops(cfg, "prefill_32k", quantized=False, rows=2)
    assert one["flops"] == closed(1)
    assert two["flops"] == 2 * one["flops"] == closed(2)
    assert set(one["by_op"]) == {"aten.mm", "aten.bmm"}
    step = dryrun.step_flops(cfg, "prefill_32k", quantized=False)
    head = 2 * 128 * cfg.d_model * cfg.vocab_size
    assert step["flops"] == 32 * closed(1) + head
    assert step["head"]["flops"] == head
    # depth: one and two periods extrapolate to the full count
    deep = cfg.scaled(n_layers=5)
    got = dryrun.step_flops(deep, "prefill_32k", quantized=False)["flops"]
    assert got == 32 * 5 * closed(1) // cfg.n_layers + head


def test_train_flops_scale_with_rows():
    cfg = configs.get_smoke_config("qwen2-1.5b")
    one = dryrun.count_flops(cfg, "train_4k", quantized=False, rows=1)
    two = dryrun.count_flops(cfg, "train_4k", quantized=False, rows=2)
    assert one["flops"] > 0 and two["flops"] == 2 * one["flops"]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_shape_only_scans_count_the_same(arch, monkeypatch):
    """The recurrences' stand-ins leave the count as the plain scans give
    it (the counter counts no elementwise work), forward and backward."""
    cfg = configs.get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        name = f"tiny_{kind}"
        monkeypatch.setitem(SHAPES, name, {"seq_len": 40, "global_batch": 2,
                                           "kind": kind})
        got = [dryrun.count_flops(cfg, name, quantized=False, rows=2,
                                  shape_only_scans=stand_in)
               for stand_in in (True, False)]
        assert got[0] == got[1] and got[0]["flops"] > 0, (arch, kind)


def test_sweep_reads_its_cache(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sweep, "RESULTS_DIR", tmp_path)
    todo = [c for c in sweep.cells(True) if c[0] == "qwen2-1.5b"]
    for cell in todo:
        (tmp_path / f"{sweep.tag_of(*cell)}.json").write_text("{}")
    sweep.main(["--quantized", "--only-arch", "qwen2-1.5b"])
    assert f"ok=0 cached={len(todo)} failed=0 of {len(todo)}" in \
        capsys.readouterr().out
    assert len(todo) == 3 * 2 + 2


def _listing(path: Path):
    return sorted(str(p) for p in path.rglob("*")) if path.exists() else []


def test_one_cell_in_a_subprocess(tmp_path):
    results = ROOT / "benchmarks" / "results"
    before = _listing(results)
    assert results not in dryrun.RESULTS_DIR.parents
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(
        (tmp_path / "qwen2-1.5b__train_4k__single.json").read_text())
    assert out["n_chips"] == 256 and out["mesh"] == [16, 16]
    assert out["axes"] == ["data", "model"]
    assert out["flops_per_chip"] > 0
    assert out["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    for key in ("arch", "shape", "policy", "quantized", "kind",
                "traffic_bytes_per_chip", "collective_bytes_per_chip",
                "model_flops_global", "model_flops_per_chip",
                "useful_flops_ratio"):
        assert key in out, key
    for key in ("cost_analysis", "memory_analysis", "hlo_bytes"):
        assert key not in out, key
    assert out["counted"]["flops"] == out["flops_per_chip"] * 256
    assert 0 < out["useful_flops_ratio"] < 1
    assert _listing(results) == before
