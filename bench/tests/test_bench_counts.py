"""The yardstick's counts at smoke shapes: model FLOPs, the ternary calls'
bytes and operations, their split between B1 and B3, the dispatches read
from the program's trace, and the readers of mfu and the rooflines."""

import bench_smoke
import pytest

from harness import counts, spec, work
from harness.cell import Context
from harness.trace import DeviceTrace
from harness.window import Step, Window
from repro_torch.serving.observability import TraceEvent

CONFIG = bench_smoke.load("qwen2-smoke")
C = CONFIG["config"]
REF = spec.reference(CONFIG)
SPEC = REF.param_spec(C)
SHAPES = counts.Shapes.of(SPEC, 32, 2)
PEAKS = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}
D, FF, V, HD = 64, 128, 512, 16


def test_shapes_and_token_flops():
    # per layer: q 64x64, k and v 32x64 each, o 64x64, three 128x64
    per_layer = 64 * 64 + 2 * 32 * 64 + 64 * 64 + 3 * 128 * 64
    assert SHAPES.head == (V, D)
    assert len(SHAPES.linears) == 2 * 7
    assert SHAPES.token_flops() == 2.0 * 2 * per_layer
    assert SHAPES.head_flops() == 2.0 * V * D
    # attention: 2 layers x 4 heads x 16 x (q k^T and p v, 2 FLOPs each)
    assert REF.mixer_flops(C, 10) == 2 * 4.0 * 4 * HD * 10


def test_model_flops_of_dispatches():
    pre = work.Dispatch("prefill", 0.0, 8, tokens=8, context=36.0,
                        head_rows=1)
    dec = work.Dispatch("decode", 1.0, 4, tokens=6, context=60.0, head_rows=6)
    mixer = lambda ctx: REF.mixer_flops(C, ctx)  # noqa: E731
    total, prefill = counts.model_flops(SHAPES, mixer, [pre, dec])
    want_pre = 8 * SHAPES.token_flops() + mixer(36) + SHAPES.head_flops()
    want_dec = 6 * SHAPES.token_flops() + mixer(60) + 6 * SHAPES.head_flops()
    assert prefill == pytest.approx(want_pre)
    assert total == pytest.approx(want_pre + want_dec)


def test_call_cost_counts_each_byte_once():
    nbytes, flops = counts.call_cost(128, 64, 3, SHAPES)
    planes = 2 * 128 * 64 / 4
    scales = 128 * (64 // 32) * 2 * 4
    acts = 2 * 3 * (64 + 128)
    assert nbytes == planes + scales + acts
    assert flops == 2 * 3 * 128 * 64


def test_calls_split_by_rows_as_the_program_routes_them():
    dec = work.Dispatch("decode", 0.0, 2, tokens=6, context=0.0, head_rows=6)
    pre = work.Dispatch("prefill", 1.0, 8, tokens=20, context=0.0,
                        head_rows=2)
    calls = counts.ternary_calls(SHAPES, [dec, pre], slots=4)
    n_lin = len(SHAPES.linears)
    assert len(calls) == 2 * (n_lin + 1) + n_lin + 1
    # decode and the prefill's head on 4 rows; the prefill's layers on 32
    small, large = counts.routed(calls, 16)
    assert len(small) == 2 * (n_lin + 1) + 1 and len(large) == n_lin
    assert all(c[0] == 4 for c in small) and all(c[0] == 32 for c in large)
    assert sum(c[3] for c in large) == 20 * n_lin
    # the split is the program's: fewer padded rows than its threshold
    assert counts.routed(calls, 32) == (small, large)
    assert counts.routed(calls, 33) == (calls, [])
    assert counts.routed([], 16) == ([], [])
    least, which = counts.bound_s(small, SHAPES, PEAKS)
    assert which == "bytes"
    assert least == pytest.approx(sum(
        max(b / 1e9, f / 1e12) for b, f in
        (counts.call_cost(n, d, m, SHAPES) for _, n, d, m in small)))


def _ev(name, ts, dur=0.0, track=("engine", 0), **args):
    return TraceEvent(name, "phase", "X", track, ts, dur, args)


def _window():
    """Two engine steps: a prefill of two requests (uid 0 finishes its
    5-token prompt, uid 1 takes 8 of its 20) then decode of uid 0."""
    steps = [Step(10.0, 10.5, [(5, 0, 3, True)]),
             Step(11.0, 11.5, [(5, 3, 7, False)])]
    return Window(9.0, 12.0, [], steps, 7, {}, {})


def test_dispatches_from_the_program_trace():
    events = [
        _ev("prefill_dispatch", 10.1, 0.1, bucket=8, rows=2),
        _ev("prefill_chunk", 10.05, 0.2, track=("requests", 0), tokens=5,
            cursor=5),
        _ev("prefill_chunk", 10.05, 0.2, track=("requests", 1), tokens=8,
            cursor=8),
        _ev("decode_dispatch", 10.3, 0.1, n_steps=2, rows=1),
        _ev("decode_dispatch", 11.1, 0.1, n_steps=4, rows=1),
        _ev("decode_dispatch", 13.0, 0.1, n_steps=4, rows=1),  # after close
    ]
    ds = work.dispatches(events, _window(), {0: 5, 1: 20})
    assert [d.kind for d in ds] == ["prefill", "decode", "decode"]
    pre, d1, d2 = ds
    assert (pre.length, pre.tokens, pre.head_rows) == (8, 13, 1)
    assert pre.context == sum(range(1, 6)) + sum(range(1, 9))
    # tokens 1 and 2 of uid 0 come from decode, at contexts 6 and 7
    assert (d1.length, d1.tokens, d1.context) == (2, 2, 6 + 7)
    assert (d2.tokens, d2.context) == (4, 8 + 9 + 10 + 11)
    assert work.between(ds, 10.2, 11.0) == [d1]


def test_mfu_and_roofline_readers():
    w = _window()
    ds = [work.Dispatch("decode", 10.3, 2, tokens=8, context=80.0,
                        head_rows=8)]
    calls = counts.ternary_calls(SHAPES, ds, slots=4)
    n = len(calls)
    dev = DeviceTrace(10.0, 11.0, [("void ternary_matvec_mma_kernel<1>", 10.0,
                                    10.0 + 1e-3 / n)] * n
                      + [("other", 10.5, 10.75)])
    ctx = Context(1.0, w, dev, ds, SHAPES, PEAKS,
                  lambda c: REF.mixer_flops(C, c), 4, 128)
    total, _ = counts.model_flops(SHAPES, ctx.mixer_flops, ds)
    assert spec.reader("mfu")(ctx) == pytest.approx(
        100 * total / (3.0 * 1e12))
    assert spec.reader("mfu.prefill")(ctx) == 0.0
    least, _ = counts.bound_s(calls, SHAPES, PEAKS)
    assert spec.reader("ternary_matvec_roofline")(ctx) == pytest.approx(
        100 * least / 1e-3)
    assert spec.reader("ternary_matmul_roofline")(ctx) is None
    assert spec.reader("idle_share")(ctx) == pytest.approx(
        100 * (1 - (0.25 + 1e-3 / n)))


def test_roofline_scales_for_missed_kernel_events():
    ds = [work.Dispatch("decode", 10.3, 2, tokens=8, context=80.0,
                        head_rows=8)]
    calls = counts.ternary_calls(SHAPES, ds, slots=4)
    n = len(calls)
    seen = n - 5
    dev = DeviceTrace(10.0, 11.0, [("ternary_matvec_mma_kernel", 10.0,
                                    10.0 + 1e-3 / seen)] * seen)
    ctx = Context(1.0, _window(), dev, ds, SHAPES, PEAKS,
                  lambda c: REF.mixer_flops(C, c), 4, 128)
    least, _ = counts.bound_s(calls, SHAPES, PEAKS)
    got = spec.reader("ternary_matvec_roofline")(ctx)
    assert got == pytest.approx(100 * least / (1e-3 * n / seen))
    assert ctx.notes
