"""A run as a whole, on the CPU at smoke size: no card means no result;
the run's process and the reference's hold nothing of JAX or the JAX
package; the check fails the control and every fault a serving cell can
have, the draw's included."""

import json
import os
import subprocess
import sys

import bench_smoke
import pytest
import torch

ENV = dict(os.environ, PYTHONPATH=str(bench_smoke.ROOT / "src"))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run(
        [sys.executable, str(bench_smoke.BENCH / "run.py"), "--workload",
         "qwen2-1.5b.chat", "--seed", str(bench_smoke.SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=bench_smoke.ROOT, env=ENV)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


ISOLATION = """
import json, sys
sys.path.insert(0, {tests!r})
import bench_smoke
{body}
from harness.isolation import loaded
print(json.dumps({{"forbidden": loaded(),
                  "program": loaded(("repro_torch",))}}))
"""
RUN = "r = bench_smoke.run('qwen2-smoke', trace=True, seconds=0.5)"
REFERENCE = """
import torch
from harness import weights
from reference import qwen2, rwkv6
for name, ref in (("qwen2-smoke", qwen2), ("rwkv6-smoke", rwkv6)):
    c = bench_smoke.load(name)["config"]
    w = weights.make(ref.param_spec(c), 3, "cpu", torch.float32, 32)
    ref.logits(w, c, [[1, 2, 3]], [0])
"""


@pytest.mark.parametrize("body,program", [(RUN, True), (REFERENCE, False)],
                         ids=["run", "reference"])
def test_nothing_of_jax_is_loaded(body, program):
    code = ISOLATION.format(tests=str(bench_smoke.BENCH / "tests"),
                            body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=ENV)
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert bool(got["program"]) == program


def test_the_program_passes_and_the_control_fails():
    """At smoke size the program runs f32 on the CPU, as the reference does:
    its gaps and excesses are rounding; the fp8 control's are far wider,
    and against the cell's limits it comes out as not correct, as do the
    two faults of the draw put in the program's place."""
    from harness import check
    r = bench_smoke.run("rwkv6-smoke", control=True)
    checks = r["checks"]
    assert r["correct"], checks
    assert check.passed(checks)
    for n in check.NUMBERS:
        assert checks[n]["value"] <= 1e-3
    for n in ("logit_gap", "mean_logit_gap"):
        assert checks[f"control_{n}"]["value"] > 10 * max(
            checks[n]["value"], 1e-3)
    # the control fails by its gaps; its draws often all fall inside the
    # float32 nucleus, so its excess may read 0
    assert not check.passed(checks, "control")
    for fault in ("no_top_p", "temperature_1"):
        assert checks[f"{fault}_nucleus_excess"]["value"] > 10 * max(
            checks["nucleus_excess"]["value"], 1e-3)
        assert not check.passed(checks, fault)


def test_nucleus_excess_arithmetic():
    """A token's excess is the mass above it less top-p, 0 inside."""
    from harness import check
    p = torch.tensor([[0.5, 0.3, 0.15, 0.05]])
    lg = torch.log(p) * 0.5    # at temperature 0.5, p again
    got = check.excess(lg.repeat(4, 1), [0, 1, 2, 3], 0.5, 0.9)
    assert got.tolist() == pytest.approx([-0.9, -0.4, -0.1, 0.05], abs=1e-6)
    keep = check.nucleus_mask(lg / 0.5, 0.9)
    assert keep.tolist() == [[True, True, True, False]]
    assert check.nucleus_mask(lg / 0.5, 1.0).all()
    gen = torch.Generator().manual_seed(5)
    drawn = check.draw(lg.repeat(400, 1), 0.5, 0.9, gen)
    assert set(drawn) == {0, 1, 2}
    assert abs(drawn.count(0) / 400 - 0.5 / 0.95) < 0.08


def _alter_tokens(monkeypatch):
    """A token altered where it is produced: every sampled token + 1."""
    from repro_torch.serving import engine
    orig = engine.sample_tokens_per_request

    def altered(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_tokens_per_request", altered)


def _keep_kv(monkeypatch):
    """A step that returns its state unchanged: attention writes no KV."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write", lambda *a, **k: None)


def _keep_wkv(monkeypatch):
    """A step that returns its state unchanged: the WKV state is left as
    it was (the recurrence reads a copy)."""
    from repro_torch.models import rwkv6
    orig = rwkv6.wkv6

    def frozen(r, k, v, w, u, state, *a, **kw):
        return orig(r, k, v, w, u, state.clone(), *a, **kw)
    monkeypatch.setattr(rwkv6, "wkv6", frozen)


def _ignore_top_p(monkeypatch):
    """The draw leaves out top-p: every token from the whole vocabulary."""
    from repro_torch.serving import engine
    orig = engine.sample_tokens_per_request

    def whole(logits, *a, top_p=None, **k):
        return orig(logits, *a, top_p=None, **k)
    monkeypatch.setattr(engine, "sample_tokens_per_request", whole)


def _temperature_one(monkeypatch):
    """The draw ignores the request's temperature and samples at 1."""
    from repro_torch.serving import engine
    orig = engine.sample_tokens_per_request

    def at_one(logits, seeds, indices, temperatures, **k):
        return orig(logits, seeds, indices,
                    torch.where(temperatures > 0, 1.0, temperatures), **k)
    monkeypatch.setattr(engine, "sample_tokens_per_request", at_one)


@pytest.mark.parametrize("config,fault,number", [
    ("qwen2-smoke", _alter_tokens, "logit_gap"),
    ("qwen2-smoke", _keep_kv, "logit_gap"),
    ("rwkv6-smoke", _alter_tokens, "logit_gap"),
    ("rwkv6-smoke", _keep_wkv, "logit_gap"),
    ("qwen2-smoke", _ignore_top_p, "nucleus_excess"),
    ("qwen2-smoke", _temperature_one, "nucleus_excess"),
    ("rwkv6-smoke", _ignore_top_p, "nucleus_excess"),
    ("rwkv6-smoke", _temperature_one, "nucleus_excess")],
    ids=["qwen2-token", "qwen2-state", "rwkv6-token", "rwkv6-state",
         "qwen2-top-p", "qwen2-temperature", "rwkv6-top-p",
         "rwkv6-temperature"])
def test_a_fault_in_the_timed_path_is_not_correct(config, fault, number,
                                                  monkeypatch):
    fault(monkeypatch)
    r = bench_smoke.run(config)
    assert not r["correct"]
    checks = r["checks"]
    assert checks["checked_tokens"]["value"] >= 64    # caught by a number
    assert checks["checked_sampled_tokens"]["value"] >= 64
    assert checks[number]["value"] > checks[number]["limit"]
