"""The plain references against the program's plain route (its full-
sequence forward on the CPU, f32) on the same seeded planes, at smoke
sizes; the chunked WKV against the step-by-step recurrence; the weights
from a seed."""

import bench_smoke
import pytest
import torch

from harness import program, spec, weights
from reference import common, rwkv6

SEED = bench_smoke.SEED


def _model_and_weights(name):
    config = bench_smoke.load(name)
    c = config["config"]
    ref = spec.reference(config)
    sp = ref.param_spec(c)
    group = c["quantization"]["group_size"]
    w = weights.make(sp, SEED, "cpu", torch.float32, group)
    cfg = program.model_config(config)
    return config, ref, w, program.build_model(cfg, sp, w, group, "cpu"), cfg


@pytest.mark.parametrize("name", ["qwen2-smoke", "rwkv6-smoke"])
def test_reference_matches_the_program(name):
    from repro_torch.models.transformer import forward
    config, ref, w, model, cfg = _model_and_weights(name)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen)
    got = forward(model, cfg, toks).float()
    # the second sequence shorter: right padding never reaches it
    seqs = [toks[0].tolist(), toks[1, :40].tolist()]
    want = ref.logits(w, config["config"], seqs, [0, 7])
    scale = float(want[0].abs().max())
    # f32 on both sides, other summation orders: a few ulps of the logits
    assert float((got[0] - want[0]).abs().max()) < 1e-5 * scale
    assert float((got[1, 7:40] - want[1]).abs().max()) < 1e-5 * scale
    # the control's rounding moves the logits by far more than that
    ctl = ref.logits(w, config["config"], seqs, [0, 7], rounding="fp8")
    assert float((ctl[0] - want[0]).abs().max()) > 1e-2 * scale


def test_chunked_wkv_equals_the_recurrence():
    gen = torch.Generator().manual_seed(1)
    b, s, h, hd = 2, 70, 3, 8
    r, k, v = (torch.randn(b, s, h, hd, generator=gen) for _ in range(3))
    w = torch.exp(-torch.exp(torch.empty(b, s, h, hd).uniform_(
        -6, -0.5, generator=gen)))
    u = torch.randn(h, hd, generator=gen) * 0.1
    st = torch.zeros(b, h, hd, hd)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append((r[:, t, :, :, None] * (st + u[None, :, :, None] * kv))
                  .sum(-2))
        st = w[:, t, :, :, None] * st + kv
    want = torch.stack(ys, 1)
    got = rwkv6.wkv(r, k, v, w, u)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_weights_from_the_seed():
    config = bench_smoke.load("qwen2-smoke")
    c = config["config"]
    sp = spec.reference(config).param_spec(c)
    a = weights.make(sp, SEED, "cpu", torch.float32, 32)
    b = weights.make(sp, SEED, "cpu", torch.float32, 32)
    other = weights.make(sp, SEED + 1, "cpu", torch.float32, 32)
    t1, t2, alpha = a["lm_head"]
    assert torch.equal(t1, b["lm_head"][0]) and torch.equal(alpha,
                                                            b["lm_head"][2])
    assert not torch.equal(t1, other["lm_head"][0])
    trits = common.unpack(torch.cat([t1, t2]))
    shares = [float((trits == v).float().mean()) for v in (-1, 0, 1)]
    assert all(abs(x - 1 / 3) < 0.02 for x in shares)
    assert float(alpha.min()) > 0
    # the tied embedding is the head's weight; weights of var 1 / d_in
    head = common.dequant(a["lm_head"], 32)
    assert torch.equal(a["embed"], head)
    assert float(head.var()) == pytest.approx(1 / 64, rel=0.1)
