"""The port's fault containment, deadlines and admission caps against the
reference engine's (``tests/test_faults.py``, class by class).

Both engines serve the same PTQTP-quantized smoke qwen2-1.5b (the
reference quantizes, the port loads the same bytes) under the same
``EngineConfig`` fields, prompts, ``SamplingParams`` and ``FaultPlan``,
each on its own package's ``VirtualClock``. Every scenario runs on both and
must give equal scheduler decisions: finish reasons, token lists, error
texts, the quarantine map (slot → step it may return), the dispatch counts
per kind and the engine counters. The reference test's own assertions are
then checked on the port's result. On the paged layout, the allocator's
counters must agree too, and a prompt whose logits are not finite
publishes no page.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serving as jserving
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.serving import (EngineConfig, SamplingParams, ServingEngine,
                                 faults)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    """(reference namespace, port namespace): the engine classes, the
    package's fault harness and a factory on the shared quantized bytes."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                               JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    ref = SimpleNamespace(
        name="reference", params=params, cfg=jcfg, Engine=jserving.ServingEngine,
        EngineConfig=jserving.EngineConfig, SP=jserving.SamplingParams,
        FaultPlan=jserving.FaultPlan, FaultInjector=jserving.FaultInjector,
        VirtualClock=jserving.VirtualClock)
    port = SimpleNamespace(
        name="port", params=model, cfg=cfg, Engine=ServingEngine,
        EngineConfig=EngineConfig, SP=SamplingParams,
        FaultPlan=faults.FaultPlan, FaultInjector=faults.FaultInjector,
        VirtualClock=faults.VirtualClock)
    return ref, port


def engine(ns, plan=None, clock=None, inject=True, **ecfg):
    """An engine of package ``ns``; with ``inject`` it carries a
    ``FaultInjector`` of ``plan`` (built by ``plan(ns.FaultPlan())``) on
    ``clock``."""
    kw = dict(dict(max_slots=2, capacity=32), **ecfg)
    inj = None
    if inject:
        p = plan(ns.FaultPlan()) if plan else ns.FaultPlan()
        inj = ns.FaultInjector(p, clock=clock)
    return ns.Engine(ns.params, ns.cfg, ns.EngineConfig(**kw), injector=inj)


def record(eng, handles):
    """Every scheduler decision the two engines must agree on."""
    out = dict(
        requests=[(h.uid, list(h.output), h.finish_reason, h.error,
                   h.truncated) for h in handles],
        quarantined=dict(eng.quarantined),
        dispatches=dict(eng._dispatch_counts),
        counters=[eng.completed, eng.cancelled, eng.sheds, eng.timeouts,
                  eng.errors, eng.admits, eng.engine_steps, eng.steps,
                  eng.prefill_steps, eng.resident_tokens(),
                  eng.free_admissible_slots()])
    if eng.paged:
        a = eng.alloc
        out["pages"] = [a.hits, a.misses, a.forks, a.evictions,
                        a.cached_pages(), a.used_pages()]
    return out


def run_both(both, scenario):
    """``scenario(ns)`` -> (engine, handles, extra) on each package; the
    records must be equal. Returns the port's (record, handles, extra)."""
    got = {}
    for ns in both:
        eng, handles, extra = scenario(ns)
        got[ns.name] = (record(eng, handles), handles, extra)
    assert got["port"][0] == got["reference"][0]
    assert got["port"][2] == got["reference"][2]
    return got["port"]


def solo(ns, prompt, sp):
    eng = ns.Engine(ns.params, ns.cfg, ns.EngineConfig(max_slots=1,
                                                       capacity=32))
    return list(eng.submit(prompt, sp).result().tokens)


class TestDeadlines:
    def test_deadline_expires_mid_decode(self, both):
        def scenario(ns):
            sp = ns.SP(max_new_tokens=8, temperature=0.9, seed=41)
            clock = ns.VirtualClock()
            eng = engine(ns, clock=clock, decode_chunk=2)
            keeper = eng.submit([5, 9, 17, 2], sp)
            victim = eng.submit([1, 2], ns.SP(max_new_tokens=64,
                                              deadline_s=10.0))
            eng.step()
            eng.step()
            mid = (bool(victim.output), victim.done, len(victim.output))
            clock.advance(11.0)
            eng.step()
            kept = len(victim.output)
            keeper.result()
            return eng, [keeper, victim], dict(
                mid=mid, kept=kept, t_done=victim.t_done == clock(),
                solo=solo(ns, [5, 9, 17, 2], sp))

        rec, (keeper, victim), extra = run_both(both, scenario)
        assert extra["mid"][0] and not extra["mid"][1]
        assert victim.finish_reason == "timeout"
        assert extra["kept"] == extra["mid"][2] and extra["t_done"]
        assert keeper.output == extra["solo"]
        assert rec["counters"][3] == 1

    def test_ttft_deadline_expires_queued_request(self, both):
        def scenario(ns):
            clock = ns.VirtualClock()
            eng = engine(ns, clock=clock)
            fast = eng.submit([1, 2, 3], ns.SP(max_new_tokens=6,
                                               ttft_deadline_s=5.0))
            other = eng.submit([4, 5], ns.SP(max_new_tokens=6))
            late = eng.submit([6, 7], ns.SP(max_new_tokens=2,
                                            ttft_deadline_s=5.0))
            eng.step()
            first = bool(fast.output)
            clock.advance(6.0)
            done = eng.run()
            return eng, [fast, other, late], dict(first=first,
                                                  late_done=late in done)

        _, (fast, _, late), extra = run_both(both, scenario)
        assert extra["first"] and extra["late_done"]
        assert late.finish_reason == "timeout" and late.output == []
        assert fast.finish_reason == "length" and len(fast.output) == 6

    def test_deadline_frees_slot_for_next_admission(self, both):
        def scenario(ns):
            clock = ns.VirtualClock()
            eng = engine(ns, clock=clock, max_slots=1)
            stuck = eng.submit([1, 2], ns.SP(max_new_tokens=64,
                                             deadline_s=1.0))
            nxt = eng.submit([3, 4], ns.SP(max_new_tokens=3))
            eng.step()
            clock.advance(2.0)
            eng.step()
            admits = eng.admits
            nxt.result()
            return eng, [stuck, nxt], dict(admits=admits)

        _, (stuck, nxt), extra = run_both(both, scenario)
        assert stuck.finish_reason == "timeout"
        assert extra["admits"] == 2 and len(nxt.output) == 3

    def test_stall_clock_fault_is_deterministic(self, both):
        def scenario(ns):
            reasons = []
            for _ in range(2):
                inj = ns.FaultInjector(
                    ns.FaultPlan().stall_clock(at_step=2, advance_s=60.0),
                    clock=ns.VirtualClock())
                eng = ns.Engine(ns.params, ns.cfg, ns.EngineConfig(
                    max_slots=2, capacity=32), injector=inj)
                h = eng.submit([1, 2, 3], ns.SP(max_new_tokens=32,
                                                deadline_s=30.0))
                eng.run()
                reasons.append((h.finish_reason, len(h.output),
                                inj.log[0][0]))
            return eng, [h], dict(reasons=reasons)

        _, _, extra = run_both(both, scenario)
        r = extra["reasons"]
        assert r[0] == r[1] and r[0][0] == "timeout" and r[0][2] == "stall"


class TestAdmissionControl:
    def test_reject_policy_sheds_past_queue_cap(self, both):
        def scenario(ns):
            eng = engine(ns, inject=False, max_slots=1, max_queue=1,
                         admission_policy="reject")
            a = eng.submit([1, 2], ns.SP(max_new_tokens=2))
            eng.step()
            b = eng.submit([3, 4], ns.SP(max_new_tokens=2))
            shed = eng.submit([5, 6], ns.SP(max_new_tokens=2))
            at_submit = (shed.done, shed.result().error == shed.error)
            eng.run()
            return eng, [a, b, shed], dict(at_submit=at_submit)

        rec, (a, b, shed), extra = run_both(both, scenario)
        assert extra["at_submit"] == (True, True)
        assert shed.finish_reason == "rejected" and "queue full" in shed.error
        assert a.finish_reason == b.finish_reason == "length"
        assert rec["counters"][2] == 1

    def test_resident_token_cap_sheds(self, both):
        def scenario(ns):
            eng = engine(ns, inject=False, max_resident_tokens=20)
            a = eng.submit([1, 2, 3], ns.SP(max_new_tokens=8))
            shed = eng.submit([4, 5], ns.SP(max_new_tokens=16))
            ok = eng.submit([4, 5], ns.SP(max_new_tokens=4))
            eng.run()
            return eng, [a, shed, ok], {}

        _, (_, shed, ok), _ = run_both(both, scenario)
        assert shed.finish_reason == "rejected"
        assert "resident-token" in shed.error
        assert ok.finish_reason == "length"

    def test_block_policy_waits_for_drain(self, both):
        def scenario(ns):
            eng = engine(ns, inject=False, max_slots=1,
                         max_resident_tokens=6, admission_policy="block")
            a = eng.submit([1, 2], ns.SP(max_new_tokens=2))
            b = eng.submit([3, 4], ns.SP(max_new_tokens=2))
            waited = (a.done, b.done)
            eng.run()
            return eng, [a, b], dict(waited=waited)

        rec, (_, b), extra = run_both(both, scenario)
        assert extra["waited"] == (True, False)
        assert b.finish_reason == "length" and rec["counters"][2] == 0

    def test_never_fits_rejected_even_under_block(self, both):
        def scenario(ns):
            eng = engine(ns, inject=False, max_slots=1,
                         max_resident_tokens=8, admission_policy="block")
            h = eng.submit([1, 2, 3, 4], ns.SP(max_new_tokens=16))
            return eng, [h], {}

        _, (h,), _ = run_both(both, scenario)
        assert h.finish_reason == "rejected"
        assert "resident-token cap" in h.error

    def test_resident_tokens_accounting(self, both):
        def scenario(ns):
            eng = engine(ns, inject=False, max_slots=1)
            a = eng.submit([1, 2, 3], ns.SP(max_new_tokens=5))
            b = eng.submit([4, 5], ns.SP(max_new_tokens=4))
            before = eng.resident_tokens()
            eng.run()
            return eng, [a, b], dict(before=before,
                                     after=eng.resident_tokens())

        _, _, extra = run_both(both, scenario)
        assert extra == dict(before=14, after=0)


class TestFaultContainment:
    @pytest.mark.parametrize("layout", ["ring", "paged"])
    def test_nan_logits_mid_decode_contained(self, both, layout):
        """NaN poison at generated token 3 (inside a K-step dispatch): the
        victim retires "error" after 3 tokens, the slot is quarantined, the
        neighbour equals its solo run."""
        def scenario(ns):
            sp = ns.SP(max_new_tokens=8, temperature=0.9, seed=41)
            eng = engine(ns, lambda p: p.nan_logits(uid=1, gen_index=3),
                         quarantine_steps=None, kv_layout=layout,
                         page_size=8)
            keeper = eng.submit([5, 9, 17, 2], sp)
            victim = eng.submit([1, 2], ns.SP(max_new_tokens=8))
            eng.run()
            return eng, [keeper, victim], dict(
                solo=solo(ns, [5, 9, 17, 2], sp))

        rec, (keeper, victim), extra = run_both(both, scenario)
        assert victim.finish_reason == "error" and len(victim.output) == 3
        assert victim.error == "non-finite logits at generated token 3"
        assert keeper.output == extra["solo"]
        assert rec["quarantined"] == {1: -1}

    @pytest.mark.parametrize("layout", ["ring", "paged"])
    def test_nan_at_prefill_finisher_contained(self, both, layout):
        """gen_index 0 poisons the token sampled as prefill completes; on
        the paged layout the victim's prompt (two full pages) publishes no
        page, so a later request with that prompt finds none cached."""
        prompt = list(range(1, 20))

        def scenario(ns):
            eng = engine(ns, lambda p: p.nan_logits(uid=0, gen_index=0),
                         kv_layout=layout, page_size=8)
            victim = eng.submit(prompt, ns.SP(max_new_tokens=4))
            other = eng.submit([4, 5], ns.SP(max_new_tokens=4))
            eng.run()
            cached = eng.alloc.cached_pages() if eng.paged else 0
            again = eng.submit(prompt, ns.SP(max_new_tokens=4))
            eng.run()
            return eng, [victim, other, again], dict(cached=cached)

        rec, (victim, other, again), extra = run_both(both, scenario)
        assert victim.finish_reason == "error" and victim.output == []
        assert victim.error == "non-finite logits at prefill completion"
        assert other.finish_reason == "length" and len(other.output) == 4
        assert again.finish_reason == "length"
        assert extra["cached"] == 0
        if layout == "paged":
            assert rec["pages"][0] == 0  # the retry hit nothing

    @pytest.mark.parametrize("layout", ["ring", "paged"])
    def test_nan_embedding_row_contained_without_injector(self, both,
                                                          layout):
        """A production engine (no injector) on weights with one NaN
        embedding row: the prompt holding that token retires "error" at
        prefill completion, publishes no page, and its neighbours' streams
        equal those on the clean weights."""
        prompts = [list(range(20, 40)), [3, 7, 11] + list(range(40, 57)),
                   [9, 8, 6]]

        def poisoned(ns):
            if ns.name == "port":
                m = from_jax_params(jax.tree.map(np.asarray, both[0].params),
                                    ns.cfg, device="cpu")
                m.embed[7] = float("nan")
                return m
            emb = ns.params["embed"]["embedding"]
            return dict(ns.params, embed={"embedding": emb.at[7].set(
                float("nan"))})

        def scenario(ns):
            streams = []
            for params in (ns.params, poisoned(ns)):
                eng = ns.Engine(params, ns.cfg, ns.EngineConfig(
                    max_slots=3, capacity=32, kv_layout=layout,
                    page_size=8))
                hs = [eng.submit(p, ns.SP(max_new_tokens=5))
                      for p in prompts]
                eng.run()
                streams.append([(h.output, h.finish_reason) for h in hs])
            return eng, hs, dict(clean=streams[0],
                                 cached=eng.alloc.cached_pages()
                                 if eng.paged else None)

        rec, hs, extra = run_both(both, scenario)
        assert hs[1].finish_reason == "error" and hs[1].output == []
        assert "prefill" in hs[1].error
        for i in (0, 2):
            assert (hs[i].output, hs[i].finish_reason) == extra["clean"][i]
        assert 1 in rec["quarantined"]
        if layout == "paged":
            # only the clean 20-token prompt published its two full pages
            assert extra["cached"] == 2

    def test_attributed_dispatch_fault_retires_one_row(self, both):
        def scenario(ns):
            sp = ns.SP(max_new_tokens=6, temperature=0.9, seed=41)
            eng = engine(ns, lambda p: p.dispatch_error("decode", 1, uid=1),
                         decode_chunk=2)
            keeper = eng.submit([5, 9, 17, 2], sp)
            victim = eng.submit([1, 2], ns.SP(max_new_tokens=6))
            eng.run()
            return eng, [keeper, victim], dict(
                solo=solo(ns, [5, 9, 17, 2], sp))

        rec, (keeper, victim), extra = run_both(both, scenario)
        assert victim.finish_reason == "error"
        assert "dispatch failed" in victim.error
        assert keeper.finish_reason == "length"
        assert keeper.output == extra["solo"]
        assert rec["counters"][4] == 1

    def test_unattributed_dispatch_fault_contains_whole_dispatch(self, both):
        def scenario(ns):
            eng = engine(ns, lambda p: p.dispatch_error("decode", 0),
                         quarantine_steps=None)
            a = eng.submit([1, 2, 3], ns.SP(max_new_tokens=4))
            b = eng.submit([4, 5], ns.SP(max_new_tokens=4))
            eng.run()
            held = sorted(eng.quarantined)
            back = sorted(eng.rehabilitate())
            c = eng.submit([6, 7], ns.SP(max_new_tokens=3))
            eng.run()
            return eng, [a, b, c], dict(held=held, back=back)

        rec, (a, b, c), extra = run_both(both, scenario)
        assert a.finish_reason == b.finish_reason == "error"
        assert extra == dict(held=[0, 1], back=[0, 1])
        assert rec["quarantined"] == {}
        assert c.finish_reason == "length"

    def test_prefill_dispatch_fault_contained(self, both):
        def scenario(ns):
            eng = engine(ns, lambda p: p.dispatch_error("prefill", 0))
            a = eng.submit([1, 2, 3], ns.SP(max_new_tokens=3))
            b = eng.submit([4, 5], ns.SP(max_new_tokens=3))
            eng.run()
            return eng, [a, b], {}

        rec, (a, b), _ = run_both(both, scenario)
        assert a.finish_reason == b.finish_reason == "error"
        assert rec["counters"][4] == 2

    def test_quarantine_cooldown_auto_rehabilitates(self, both):
        def scenario(ns):
            eng = engine(ns, lambda p: p.dispatch_error("decode", 0),
                         max_slots=1, quarantine_steps=2)
            bad = eng.submit([1, 2], ns.SP(max_new_tokens=4))
            queued = eng.submit([3, 4], ns.SP(max_new_tokens=3))
            done = eng.run()
            return eng, [bad, queued], dict(queued_done=queued in done)

        rec, (bad, queued), extra = run_both(both, scenario)
        assert bad.finish_reason == "error"
        assert queued.finish_reason == "length" and extra["queued_done"]
        assert rec["quarantined"] == {}

    def test_engine_crash_escapes_with_suspects(self, both):
        """``engine_crash`` is not contained: it escapes ``step()`` with
        the blamed uid as the sole suspect."""
        def scenario(ns):
            eng = engine(ns, lambda p: p.engine_crash("decode", 0, uid=1))
            hs = [eng.submit([1, 2, 3], ns.SP(max_new_tokens=4)),
                  eng.submit([4, 5], ns.SP(max_new_tokens=4))]
            with pytest.raises(RuntimeError) as ei:
                eng.run()
            return eng, hs, dict(kind=type(ei.value).__name__,
                                 suspects=ei.value.suspects,
                                 msg=str(ei.value))

        _, _, extra = run_both(both, scenario)
        assert extra["kind"] == "EngineCrash" and extra["suspects"] == (1,)

    def test_stall_step_blocks_until_released(self, both):
        """``stall_step`` advances the clock and blocks the stepping
        thread until ``release_stalls()``."""
        import threading

        def scenario(ns):
            clock = ns.VirtualClock()
            inj = ns.FaultInjector(ns.FaultPlan().stall_step(2, 5.0),
                                   clock=clock)
            eng = ns.Engine(ns.params, ns.cfg, ns.EngineConfig(
                max_slots=1, capacity=32), injector=inj)
            h = eng.submit([1, 2], ns.SP(max_new_tokens=12))
            t = threading.Thread(target=eng.run, daemon=True)
            try:
                t.start()
                assert inj.stall_engaged.wait(60)
                hung = (t.is_alive(), clock())
            finally:
                inj.release_stalls()
            t.join(60)
            return eng, [h], dict(hung=hung, alive=t.is_alive())

        _, (h,), extra = run_both(both, scenario)
        assert extra == dict(hung=(True, 5.0), alive=False)
        assert h.finish_reason == "length"

    def test_production_engine_has_no_injection_residue(self, both):
        """Without an injector the decode loop runs no poison operation
        (no ``torch.where`` with a NaN operand); with an (empty) injector
        it runs one a step; the tokens are the same."""
        import math

        from torch.overrides import TorchFunctionMode

        class Wheres(TorchFunctionMode):
            n = 0

            def __torch_function__(self, func, types, args=(), kwargs=None):
                if func is torch.where and any(
                        isinstance(a, float) and math.isnan(a) for a in args):
                    Wheres.n += 1
                return func(*args, **(kwargs or {}))

        _, port = both
        out = {}
        for inject in (False, True):
            eng = engine(port, inject=inject, max_slots=1, decode_chunk=4)
            inner = eng._decode_loop
            calls = []

            def counted(n_steps, poison=None, inner=inner, calls=calls):
                Wheres.n = 0
                with Wheres():
                    res = inner(n_steps, poison)
                calls.append((n_steps, poison is None, Wheres.n))
                return res

            eng._decode_loop = counted
            h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=5))
            eng.run()
            out[inject] = (h.output, calls)
        assert out[False][0] == out[True][0]
        assert out[False][1] == [(4, True, 0)]
        assert out[True][1] == [(4, False, 4)]
        ref, _ = both
        eng = engine(ref, inject=False, max_slots=1)
        eng.submit([1, 2, 3], ref.SP(max_new_tokens=4))
        eng.run()
        assert all(k[3] is False for k in eng._loop_cache)


class TestChaosScenario:
    def test_survivors_bit_identical_under_combined_faults(self, both):
        prompts = [[5, 9, 17, 2], [1, 2], [3, 4, 5], [7, 8], [9, 10, 11],
                   [12, 13], [14, 15, 16], [6, 7]]

        def sps(ns, faulty):
            out = [ns.SP(max_new_tokens=4 + (i % 3),
                         temperature=0.0 if i % 2 else 0.9, seed=100 + i)
                   for i in range(len(prompts))]
            if faulty:
                out[5] = ns.SP(max_new_tokens=4 + (5 % 3), temperature=0.9,
                               seed=105, deadline_s=30.0)
            return out

        def scenario(ns):
            base = dict(max_slots=2, capacity=32, decode_chunk=2)
            clean = engine(ns, clock=ns.VirtualClock(), **base)
            ch = [clean.submit(p, sp) for p, sp in zip(prompts,
                                                        sps(ns, False))]
            clean.run()
            inj = ns.FaultInjector(
                ns.FaultPlan().nan_logits(uid=1, gen_index=1)
                .dispatch_error("decode", 3, uid=3)
                .stall_clock(at_step=4, advance_s=60.0),
                clock=ns.VirtualClock())
            eng = ns.Engine(ns.params, ns.cfg, ns.EngineConfig(
                **base, max_queue=6, admission_policy="reject"),
                injector=inj)
            fh = [eng.submit(p, sp) for p, sp in zip(prompts,
                                                      sps(ns, True))]
            eng.run()
            return eng, fh, dict(
                clean=[(h.output, h.finish_reason) for h in ch],
                kinds=sorted({k for k, _ in inj.log}))

        _, faulty, extra = run_both(both, scenario)
        assert all(r == "length" for _, r in extra["clean"])
        touched = {h.uid for h in faulty
                   if h.finish_reason in ("error", "timeout", "rejected")}
        survivors = [h for h in faulty if h.uid not in touched]
        assert survivors
        for h in survivors:
            assert h.finish_reason == "length"
            assert h.output == extra["clean"][h.uid][0], f"uid {h.uid}"
        assert faulty[1].finish_reason == "error"
        assert faulty[5].finish_reason == "timeout"
        assert any("dispatch failed" in (h.error or "") for h in faulty)
        assert sum(h.finish_reason == "rejected" for h in faulty) == 2
        assert {"dispatch", "nan", "stall"} <= set(extra["kinds"])


def test_ported_engine_fields_are_validated():
    """The fields this slice ports are accepted at every legal value and
    rejected at an illegal one, where the reference asserts."""
    for kw in (dict(max_queue=4), dict(max_resident_tokens=64),
               dict(admission_policy="block"), dict(quarantine_steps=None),
               dict(quarantine_steps=0)):
        EngineConfig(**kw)
    for kw in (dict(max_queue=0), dict(max_resident_tokens=0),
               dict(admission_policy="drop"), dict(quarantine_steps=-1)):
        with pytest.raises(ValueError):
            EngineConfig(**kw)
