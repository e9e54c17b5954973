"""The traffic generator and the end-to-end arithmetic of a window."""

import collections

import bench_smoke  # noqa: F401  (the harness's paths)
import numpy as np
import pytest

from harness import traffic
from harness.window import (Record, Window, failed, output_tok_s, p95,
                            tpots, ttfts)


def _real_mix(name):
    import json
    with open(bench_smoke.BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("mix", ["chat", "long-prompt"])
def test_pool_is_a_function_of_the_seed(mix):
    m = dict(_real_mix(mix), pool=250)  # a whole number of blocks
    a = traffic.pool(m, 1000, bench_smoke.SEED)
    b = traffic.pool(m, 1000, bench_smoke.SEED)
    c = traffic.pool(m, 1000, bench_smoke.SEED + 1)
    assert a == b
    assert a != c


@pytest.mark.parametrize("mix", ["chat", "long-prompt"])
def test_every_seed_serves_the_same_sizes_in_the_same_order(mix):
    m = dict(_real_mix(mix), pool=500)
    pools = [traffic.pool(m, 1000, s) for s in (1, 2, 2 ** 31 + 5)]
    for key in (lambda r: len(r.prompt), lambda r: r.max_new_tokens,
                lambda r: r.greedy):
        orders = [list(map(key, p)) for p in pools]
        assert orders[0] == orders[1] == orders[2]
    other = traffic.pool(dict(m, order_seed=m["order_seed"] + 1), 1000, 1)
    assert [len(r.prompt) for r in other] != [len(r.prompt) for r in
                                              pools[0]]
    assert collections.Counter(len(r.prompt) for r in other) == \
        collections.Counter(len(r.prompt) for r in pools[0])


def test_sizes_follow_the_mix():
    m = _real_mix("chat")
    p = traffic.pool(m, 151936, 7)
    lens = np.asarray([len(r.prompt) for r in p])
    outs = np.asarray([r.max_new_tokens for r in p])
    assert lens.min() >= 32 and lens.max() <= 1536
    assert outs.min() >= 16 and outs.max() <= 512
    assert abs(np.median(lens) - 384) <= 2
    assert abs(np.median(outs) - 160) <= 2
    assert sum(r.greedy for r in p) == len(p) // 10
    ids = np.concatenate([r.prompt for r in p[:64]])
    assert ids.min() >= 0 and ids.max() < 151936
    assert all(0.0 < r.temperature for r in p if not r.greedy)
    u = _real_mix("long-prompt")
    q = traffic.pool(u, 151936, 7)
    assert all(r.greedy for r in q)
    lens = [len(r.prompt) for r in q]
    assert 1024 <= min(lens) and max(lens) <= 3584


@pytest.mark.parametrize("mix", ["chat", "long-prompt"])
def test_every_block_holds_the_same_sizes(mix):
    m = _real_mix(mix)
    b = m["block"]
    p = traffic.pool(m, 1000, 3)
    want = sorted(traffic.sizes(m["prompt_tokens"], b))
    for i in range(0, len(p), b):
        assert sorted(len(r.prompt) for r in p[i:i + b]) == want
        assert sum(r.greedy for r in p[i:i + b]) == -(-b // m["greedy_every"])


def test_clients_take_the_pool_in_turn():
    reqs = list(range(10))
    seq = traffic.client_requests(reqs, 4, 1)
    assert [next(seq) for _ in range(5)] == [1, 5, 9, 3, 7]


class _Req:
    def __init__(self, greedy=True):
        self.greedy = greedy
        self.prompt = (1, 2, 3)


def _window():
    """A window of [10, 20] s: requests submitted before, inside and at its
    end, one still waiting at the close."""
    recs = [
        # submitted before the window, finished inside
        Record(_Req(), 0, 0, 8.0, t_first=9.0, t_done=12.0,
               tokens=(1,) * 31, reason="length"),
        # submitted inside, first token and done inside
        Record(_Req(), 1, 1, 11.0, t_first=11.5, t_done=13.5,
               tokens=(1,) * 5, reason="length"),
        # submitted inside, first token inside, not done
        Record(_Req(), 2, 2, 12.0, t_first=14.0, tokens=(1,) * 3),
        # submitted inside, still waiting at the close
        Record(_Req(), 3, 3, 17.0),
        # submitted inside, failed
        Record(_Req(), 0, 4, 13.0, t_first=13.2, t_done=13.6,
               tokens=(1, 2), reason="error"),
    ]
    return Window(10.0, 20.0, recs, [], 400, {"c": 1.0}, {"c": 4.0})


def test_rate_is_over_the_whole_window():
    w = _window()
    assert w.seconds == 10.0
    assert output_tok_s(w) == 40.0
    assert w.counter("c") == 3.0


def test_ttft_counts_every_request_submitted_inside_and_the_waiting():
    w = _window()
    assert sorted(ttfts(w)) == pytest.approx([0.2, 0.5, 2.0, 3.0])
    assert p95(ttfts(w)) == pytest.approx(np.percentile([0.2, 0.5, 2.0, 3.0],
                                                        95))


def test_tpot_is_over_the_requests_finished_inside():
    w = _window()
    assert sorted(tpots(w)) == pytest.approx([0.1, 0.4, 0.5])
    assert failed(w) == 1
    assert p95([]) is None
