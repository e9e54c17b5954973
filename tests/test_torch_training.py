"""The port's training (``repro_torch.models.loss_fn``, ``optim``,
``training``, ``launch/train.py``, ``launch/quantize.py
--from-checkpoint``) against the reference's, at smoke size, with params
the reference initialises (``PRNGKey(0)``) carried across by
``convert.from_jax_params`` and the same numpy-seeded batches.

Tolerances, each with its reason (f32 throughout, sums in another order
than XLA's):
  * ``loss_fn``: rtol 1e-5; every leaf of its gradient within 2e-5 of
    the leaf's largest |value| (seen: 5e-6);
  * the norm's plain backward written out: against PyTorch's autograd of
    the plain forward and ``jax.grad`` of the reference's ``rms_norm``,
    f32 within 1e-5 of the tensor's largest |value|, bf16 within one bf16
    step (2^-7) of it;
  * ``AdamW.update``: rtol 1e-6, atol 1e-8 (one f32 rounding apart where
    XLA fuses an expression); ``cosine_schedule`` within 1e-6 of the
    peak (another libm's cosine); ``compress_decompress`` against the jitted reference
    (as its train step runs it): see its test;
  * one ``microbatches=2`` step: loss rtol 1e-5; the moments (which hold
    the f32 mean of the microbatches' gradients) within 2e-5 of each
    leaf's largest; the parameters rtol 1e-5 where the gradient is above
    1e-3 of its leaf's largest (Adam's first step is lr·g/(|g| + eps): a
    gradient that is rounding noise, as the k bias's is (the softmax does
    not see it), moves its element by ±lr in either package);
  * the trainer's loss history against the JAX trainer's (from the same
    weights, or resumed from either's checkpoint): rtol 2e-5 (seen 2e-6 at
    losses ~5 after 6 steps; Adam's normalised steps carry the gradients'
    1e-7-relative differences into the weights);
  * ``--from-checkpoint`` of a JAX-written checkpoint: the reference's
    planes exactly, α rtol 1e-5, FP leaves byte for byte.
Exact: a run preempted and resumed from its checkpoint equals the
uninterrupted run bit for bit (losses and parameters), data addressing,
step counts, and the state read back from either package's checkpoint.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.launch import quantize as jquantize_launch
from repro.models import init_params as jinit_params
from repro.models.common import rms_norm as jrms_norm
from repro.models.transformer import loss_fn as jloss_fn
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as jcosine_schedule
from repro.optim.compress import compress_decompress as jcompress
from repro.runtime import checkpoint as jckpt
from repro.training.train_step import init_train_state as jinit_train_state
from repro.training.train_step import make_train_step as jmake_train_step
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.artifacts import load_artifact
from repro_torch.artifacts.format import iter_tree_leaves
from repro_torch.convert import (from_jax_params, reference_tree_of,
                                 to_reference_tree, values_from_tree)
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.rms_norm import ops as norm_ops
from repro_torch.kernels.rms_norm import ref as norm_ref
from repro_torch.launch import quantize as quantize_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import loss_fn
from repro_torch.optim import (AdamW, compress_decompress, cosine_schedule,
                               init_error_feedback)
from repro_torch.runtime import latest_step, load_checkpoint
from repro_torch.runtime.preempt import PreemptionGuard
from repro_torch.training import (Trainer, TrainerConfig, init_train_state,
                                  make_train_step, state_from_tree,
                                  state_tree)

torch.set_num_threads(1)

DATA = dict(seq_len=32, global_batch=4)
LR = 3e-3


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jinit_params(jconfigs.get_smoke_config(arch), jax.random.PRNGKey(0))


def _port_model(arch, cfg=None):
    cfg = cfg or configs.get_smoke_config(arch)
    return from_jax_params(jax.tree.map(np.asarray, _jax_params(arch)), cfg,
                           device="cpu")


def _flat(tree):
    return {k: np.asarray(v) for k, v in iter_tree_leaves(tree)}


def _batches(cfg, rng, b=2, s=16):
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.embed_inputs:
        x = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        key = "tokens"
    else:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        key = "embeddings"
    return ({key: jnp.asarray(x), "labels": jnp.asarray(labels)},
            {key: torch.from_numpy(x), "labels": torch.from_numpy(labels)})


def _trainer(tmp=None, steps=20, grad_compress=False, arch="qwen2-1.5b",
             log_fn=lambda msg: None, **tkw):
    tcfg = TrainerConfig(total_steps=steps, log_interval=1000,
                         ckpt_dir=str(tmp) if tmp else None,
                         grad_compress=grad_compress, **tkw)
    return Trainer(configs.get_smoke_config(arch), AdamW(lr=LR),
                   DataConfig(**DATA), tcfg, log_fn=log_fn, device="cpu")


def _jtrainer(tmp=None, steps=20, grad_compress=False, arch="qwen2-1.5b",
              **tkw):
    tcfg = JTrainerConfig(total_steps=steps, log_interval=1000,
                          ckpt_dir=str(tmp) if tmp else None,
                          grad_compress=grad_compress, **tkw)
    return JTrainer(jconfigs.get_smoke_config(arch), JAdamW(lr=LR),
                    JDataConfig(**DATA), tcfg, log_fn=lambda msg: None)


def _losses(t):
    return np.array([h["loss"] for h in t.history])


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch,remat", [
    ("qwen2-1.5b", "none"), ("qwen2-1.5b", "full"), ("gemma3-27b", "none"),
    ("deepseek-moe-16b", "none"), ("musicgen-large", "none"),
    ("recurrentgemma-2b", "none"), ("recurrentgemma-2b", "full"),
    ("rwkv6-3b", "none"), ("rwkv6-3b", "full")])
def test_loss_and_every_gradient_match_the_reference(arch, remat):
    """``loss_fn`` and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's; with ``remat="full"`` both
    recompute each layer (``jax.checkpoint``, ``torch.utils.checkpoint``),
    the recurrent ones included. rwkv6's leaves are held at the recurrent
    tests' 2e-4 (seen 1e-4, on u): the WKV readout sums in another order
    than XLA's einsum, and the group norm divides each head's 16 values by
    their spread, which scales those roundings up."""
    jcfg = jconfigs.get_smoke_config(arch).scaled(remat=remat)
    cfg = configs.get_smoke_config(arch).scaled(remat=remat)
    jb, pb = _batches(cfg, np.random.default_rng(1))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, jcfg, jb)))(_jax_params(arch))
    model = _port_model(arch, cfg)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    loss = loss_fn(model, cfg, pb)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = _flat(reference_tree_of(model, cfg, grads))
    want = _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = np.max(np.abs(got[k] - w)) / max(np.max(np.abs(w)), 1e-30)
        assert err <= (2e-4 if arch == "rwkv6-3b" else 2e-5), (k, err)


@pytest.mark.parametrize("stacked", [False, True])
def test_fixed_rows_weight_gradient_is_rounded_once(stacked):
    """``linear_fixed_rows``/``bmm_fixed_rows`` in bf16 at 1000 rows (8
    blocks): the forward and dx are the 128-row blocks', but dw is one
    product over all rows, f32-accumulated and rounded once to bf16, so
    each element lies within one bf16 rounding (2^-8 relative, plus 1e-5
    of the largest for the f32 sums' order) of the f32 product of the same
    inputs; dx within the same of the f32 product."""
    from repro_torch.models.common import bmm_fixed_rows, linear_fixed_rows

    rng = np.random.default_rng(3)
    lead = (2,) if stacked else ()
    x, w, dy = (torch.from_numpy(rng.standard_normal(lead + s, np.float32))
                .to(torch.bfloat16) for s in ((1000, 96), (80, 96), (1000, 80)))
    fn = bmm_fixed_rows if stacked else linear_fixed_rows
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    with torch.no_grad():
        assert torch.equal(y, fn(x, w))
    xf, wf, dyf = x.float(), w.float(), dy.float()
    for got, want in ((dw, dyf.transpose(-1, -2) @ xf), (dx, dyf @ wf)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want).abs()
        bound = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
        assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_backward_matches_autograd_and_jax_grad(dtype):
    """The norm's plain backward written out (what the CPU wrappers run
    and the backward kernels are held against on the card) against
    autograd of the plain forward and ``jax.grad`` of the reference's
    ``rms_norm`` (alone, and after the residual add), at qwen2's and
    llama3-405b's smoke widths and 1536."""
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(2)

    def close(got, want, what):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
        assert err <= tol, (what, err)

    def f32(t):
        return t.float().numpy()

    for d in (64, 128, 1536):
        x, delta, dy, dres = (torch.from_numpy(rng.standard_normal(
            (3, 5, d)).astype(np.float32)).to(dtype) for _ in range(4))
        scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(d))
                                 .astype(np.float32)).to(dtype)
        # rms_norm alone
        dx, dscale = norm_ref.rms_norm_backward_plain(scale, x, dy)
        xa, sa = x.clone().requires_grad_(), scale.clone().requires_grad_()
        ga = torch.autograd.grad(norm_ref.rms_norm_plain(sa, xa), (xa, sa), dy)
        close(f32(dx), f32(ga[0]), f"autograd dx d={d}")
        close(f32(dscale), f32(ga[1]), f"autograd dscale d={d}")
        gs, gx = jax.grad(lambda s, v: jnp.vdot(
            jrms_norm({"scale": s}, v).astype(jnp.float32),
            jnp.asarray(f32(dy)).astype(jdt).astype(jnp.float32)),
            argnums=(0, 1))(jnp.asarray(f32(scale)).astype(jdt),
                            jnp.asarray(f32(x)).astype(jdt))
        close(f32(dx), gx, f"jax dx d={d}")
        close(f32(dscale), gs, f"jax dscale d={d}")
        # add_rms_norm: both outputs' gradients into one dsum
        s = x + delta
        dsum, dscale = norm_ref.rms_norm_backward_plain(scale, s, dy, dres=dres)
        xa, da = x.clone().requires_grad_(), delta.clone().requires_grad_()
        sa = scale.clone().requires_grad_()
        outs = norm_ref.add_rms_norm_plain(sa, xa, da)
        ga = torch.autograd.grad(outs, (xa, da, sa), (dres, dy))
        close(f32(dsum), f32(ga[0]), f"autograd dsum d={d}")
        close(f32(dsum), f32(ga[1]), f"autograd ddelta d={d}")
        close(f32(dscale), f32(ga[2]), f"autograd add dscale d={d}")
        # the wrappers' Functions on CPU tensors run exactly these
        xa, da = x.clone().requires_grad_(), delta.clone().requires_grad_()
        sa = scale.clone().requires_grad_()
        ga = torch.autograd.grad(norm_ops.add_rms_norm(sa, xa, da),
                                 (xa, da, sa), (dres, dy))
        assert torch.equal(ga[0], dsum) and torch.equal(ga[1], dsum)
        assert torch.equal(ga[2], dscale)
        ga = torch.autograd.grad(norm_ops.add_rms_norm(sa, xa, da)[0],
                                 (xa, da, sa), dres, allow_unused=True)
        assert torch.equal(ga[0], dres) and ga[2] is None


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference(moment_dtype):
    """Five updates with clipping, decay of matrices only and a schedule
    on the same arrays; params, moments and count."""
    rng = np.random.default_rng(3)
    shapes = [(64, 32), (32,), (8, 16, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jopt = JAdamW(lr=jcosine_schedule(LR, 2, 6), clip_norm=0.5,
                  moment_dtype=getattr(jnp, moment_dtype))
    opt = AdamW(lr=cosine_schedule(LR, 2, 6), clip_norm=0.5,
                moment_dtype=getattr(torch, moment_dtype))
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    pp = [torch.from_numpy(p.copy()) for p in params]
    ps = opt.init(pp)
    update = jax.jit(jopt.update)
    for _ in range(5):
        g = [(rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 0, s))
             .astype(np.float32) for s in shapes]
        jp, js = update([jnp.asarray(x) for x in g], js, jp)
        opt.update([torch.from_numpy(x) for x in g], ps, pp)
        for a, b in zip(jp, pp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-8)
        for k in ("m", "v"):
            for a, b in zip(js[k], ps[k]):
                assert str(b.dtype).endswith(moment_dtype)
                np.testing.assert_allclose(
                    b.float().numpy(), np.asarray(a, np.float32),
                    rtol=1e-6 if moment_dtype == "float32" else 2.0 ** -7,
                    atol=1e-8)
        assert int(ps["count"]) == int(js["count"])


def test_cosine_schedule_matches_the_reference():
    """Within 1e-6 of the peak rate: the cosine runs in another libm, and
    1 + cos cancels near the end of the decay (seen: 3e-12 at a peak of
    1e-4)."""
    for peak, warm, total, floor in ((3e-3, 2, 6, 0.1), (1e-4, 10, 100, 0.0),
                                     (1.0, 0, 5, 0.5)):
        jlr, lr = (jcosine_schedule(peak, warm, total, floor),
                   cosine_schedule(peak, warm, total, floor))
        got = [float(lr(torch.tensor(c, dtype=torch.int32)))
               for c in range(0, total + 3)]
        want = [float(jlr(jnp.int32(c))) for c in range(0, total + 3)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)


def test_compress_decompress_matches_the_reference():
    """Four steps carrying the error state, against the reference jitted
    (as its train step runs it). XLA fuses the error gf − q·scale into one
    FMA where the port rounds twice: the first step's gradients are equal
    and its errors within one f32 rounding of the gradient's scale; the
    next step's q can carry that across an int8 boundary, so from then on
    every element is within one int8 step (its leaf's scale) and at least
    99 % of the gradients are equal."""
    rng = np.random.default_rng(4)
    shapes = [(64, 32), (7,), (3, 5, 8)]
    jerr = [jnp.zeros(s, jnp.float32) for s in shapes]
    err = init_error_feedback([torch.zeros(s) for s in shapes])
    step = jax.jit(jcompress)
    for i in range(4):
        g = [(rng.standard_normal(s) * 10.0 ** (i - 3)).astype(np.float32)
             for s in shapes]
        jd, jerr = step([jnp.asarray(x) for x in g], jerr)
        d, err = compress_decompress([torch.from_numpy(x) for x in g], err)
        for ja, je, pa, pe in zip(jd, jerr, d, err):
            ja, je, pa, pe = (np.asarray(t) for t in (ja, je, pa, pe))
            q_step = np.max(np.abs(ja)) / 127
            if i == 0:
                np.testing.assert_array_equal(pa, ja)
                np.testing.assert_allclose(pe, je, rtol=0,
                                           atol=2.0 ** -23 * 127 * q_step)
                continue
            np.testing.assert_allclose(pa, ja, rtol=0, atol=1.01 * q_step)
            np.testing.assert_allclose(pe, je, rtol=0, atol=1.01 * q_step)
            assert np.mean(pa == ja) >= 0.99


# --------------------------------------------------------------- train step
def test_microbatched_step_matches_the_reference():
    """One ``microbatches=2`` step (gradients accumulated in f32 over two
    halves of the batch) against the reference's jitted step."""
    arch = "qwen2-1.5b"
    jcfg = jconfigs.get_smoke_config(arch).scaled(microbatches=2)
    cfg = configs.get_smoke_config(arch).scaled(microbatches=2)
    jb, pb = _batches(cfg, np.random.default_rng(5), b=4)
    jopt, opt = JAdamW(lr=LR), AdamW(lr=LR)
    jstate, jm = jax.jit(jmake_train_step(jcfg, jopt))(
        jinit_train_state(jcfg, _jax_params(arch), jopt), jb)
    state = init_train_state(cfg, _port_model(arch, cfg), opt)
    state, m = make_train_step(cfg, opt)(state, pb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got, want = _flat(state_tree(state, cfg)), \
        _flat(jax.tree.map(np.asarray, jstate))
    assert sorted(got) == sorted(want)
    assert got["/step"] == want["/step"] == 1
    for k, w in want.items():
        if k.startswith(("/opt/m/", "/opt/v/")):
            err = np.max(np.abs(got[k] - w)) / max(np.max(np.abs(w)), 1e-30)
            assert err <= 2e-5, (k, err)
        elif k.startswith("/params/"):
            g = np.abs(want["/opt/m/" + k[len("/params/"):]])
            live = g > 1e-3 * g.max()
            np.testing.assert_allclose(got[k][live], w[live], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def _check_history(arch, steps):
    """``steps`` steps of the port's trainer from the JAX trainer's initial
    params, on the same batches, against the JAX trainer's history."""
    jt = _jtrainer(steps=steps, arch=arch)
    jstate = jt.init_state()
    p0 = jax.tree.map(np.asarray, jstate["params"])
    jt.fit(state=jstate)
    t = _trainer(steps=steps, arch=arch)
    t.fit(state=t.init_state(params=from_jax_params(
        p0, configs.get_smoke_config(arch), device="cpu")))
    assert [h["step"] for h in t.history] == list(range(1, steps + 1))
    np.testing.assert_allclose(_losses(t), _losses(jt), rtol=2e-5)


def test_trainer_loss_history_matches_the_jax_trainer():
    """Six steps of qwen2's trainer against the JAX trainer's history."""
    _check_history("qwen2-1.5b", 6)


RECURRENT = ("recurrentgemma-2b", "rwkv6-3b")


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_trainer_loss_history_matches_the_jax_trainer(arch):
    """Four steps of a recurrent arch's trainer (the RG-LRU's and the
    WKV's backwards written out on the CPU) against the JAX trainer's
    history, at the trainers' rtol 2e-5 (seen 4.6e-6 and 6.7e-6)."""
    _check_history(arch, 4)


# --------------------------------------- the reference's trainer cases, port
class TestTraining:
    def test_loss_decreases(self):
        t = _trainer(steps=25)
        t.fit()
        assert np.mean(_losses(t)[-5:]) < np.mean(_losses(t)[:5])

    def test_grad_compression_still_learns(self):
        t = _trainer(steps=25, grad_compress=True)
        state = t.fit()
        assert np.mean(_losses(t)[-5:]) < np.mean(_losses(t)[:5])
        assert len(state["err"]) == len(list(state["params"].parameters()))

    def test_stub_frontend_arch_trains(self):
        t = _trainer(steps=6, arch="musicgen-large")
        t.fit()
        assert all(np.isfinite(_losses(t)))

    def test_heartbeats_are_written(self, tmp_path):
        """``run_dir`` gets the host's heartbeat with the last step and
        loss (the reference's ``HeartbeatMonitor`` feed)."""
        t = _trainer(steps=3, run_dir=str(tmp_path))
        t.fit()
        beats = [json.loads(p.read_text()) for p in tmp_path.rglob("*")
                 if p.is_file()]
        assert [b["step"] for b in beats] == [3]
        assert beats[0]["loss"] == t.history[-1]["loss"]


class TestFaultTolerance:
    def test_checkpoint_resume_continues_step_count(self, tmp_path):
        _trainer(tmp_path, steps=10, ckpt_interval=5).fit()
        t2 = _trainer(tmp_path, steps=15, ckpt_interval=5)
        t2.fit()
        assert t2.history[0]["step"] == 11
        assert t2.history[-1]["step"] == 15

    def test_resume_deterministic_data(self):
        b_direct = _trainer(steps=1).loader.batch_at(12)
        t2 = _trainer(steps=1)
        b_stream = next(t2.loader.iterate(start_step=12))
        t2.loader.close()
        np.testing.assert_array_equal(b_direct["tokens"], b_stream["tokens"])

    def test_preemption_checkpoints_and_exits(self, tmp_path):
        guard = PreemptionGuard(signals=())

        def log_hook(msg):
            if "step 5 " in msg:
                guard.request()

        cfg = configs.get_smoke_config("qwen2-1.5b")
        t = Trainer(cfg, AdamW(lr=LR), DataConfig(**DATA),
                    TrainerConfig(total_steps=500, log_interval=1,
                                  ckpt_dir=str(tmp_path), ckpt_interval=1000),
                    log_fn=log_hook, device="cpu")
        t.fit(guard=guard)
        assert len(t.history) <= 8
        assert latest_step(tmp_path) == 5

    @pytest.mark.parametrize("grad_compress", [False, True])
    def test_preempted_and_resumed_equals_uninterrupted(self, tmp_path,
                                                        grad_compress):
        """Preempted after step 3, resumed from its checkpoint to step 6:
        the losses and every tensor of the state equal those of an
        uninterrupted 6-step run bit for bit."""
        _check_resume(tmp_path, "qwen2-1.5b", 3, 6, grad_compress)


def _check_resume(tmp_path, arch, at, steps, grad_compress=False):
    """Preempted after step ``at`` and resumed from its checkpoint to
    ``steps``: the losses and every tensor of the state equal an
    uninterrupted run's bit for bit."""
    kw = dict(steps=steps, arch=arch, grad_compress=grad_compress)
    whole = _trainer(**kw)
    s_whole = whole.fit()
    guard = PreemptionGuard(signals=())
    first = _trainer(tmp_path, **kw,
                     log_fn=lambda m: f"step {at} " in m and guard.request())
    first.tcfg.log_interval = 1
    first.fit(guard=guard)
    assert latest_step(tmp_path) == at
    second = _trainer(tmp_path, **kw)
    s_resumed = second.fit()
    np.testing.assert_array_equal(
        np.concatenate([_losses(first), _losses(second)]), _losses(whole))
    cfg = configs.get_smoke_config(arch)
    a, b = _flat(state_tree(s_whole, cfg)), _flat(state_tree(s_resumed, cfg))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_preempted_and_resumed_equals_uninterrupted(tmp_path,
                                                              arch):
    """A recurrent arch preempted after step 2 and resumed to step 4, bit
    for bit: the RG-LRU's (L, R) Λ and block-diagonal gates, the WKV's u
    and LoRAs, and their AdamW moments included."""
    _check_resume(tmp_path, arch, 2, 4)


# ----------------------------------------------------- checkpoints crossing
def _check_port_resumes_jax(tmp_path, arch, at, steps, grad_compress):
    """The JAX trainer checkpoints at step ``at``; the port's state read
    back holds the checkpoint's bytes and dtypes, and the port resumes to
    ``steps`` with the JAX trainer's own continuation (the trainers'
    tolerance)."""
    import shutil

    kw = dict(arch=arch, grad_compress=grad_compress)
    _jtrainer(tmp_path / "a", steps=at, **kw).fit()
    _, tree, _ = jckpt.load_checkpoint(tmp_path / "a")
    cfg = configs.get_smoke_config(arch)
    state = state_from_tree(
        load_checkpoint(tmp_path / "a")[1], cfg, device="cpu")
    got, want = _flat(state_tree(state, cfg)), _flat(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].tobytes() == want[k].tobytes(), k
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    jt = _jtrainer(tmp_path / "a", steps=steps, **kw)
    jt.fit()
    t = _trainer(tmp_path / "b", steps=steps, **kw)
    t.fit()
    assert [h["step"] for h in t.history] == list(range(at + 1, steps + 1))
    np.testing.assert_allclose(_losses(t), _losses(jt), rtol=2e-5)


def _check_jax_resumes_port(tmp_path, arch, at, steps):
    """The port's trainer checkpoints at step ``at``; the reference reads
    the checkpoint's params with the port's bytes, and its trainer resumes
    to ``steps`` with the port's own continuation (the trainers'
    tolerance)."""
    import shutil

    s_at = _trainer(tmp_path / "a", steps=at, arch=arch).fit()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    _, tree, _ = jckpt.load_checkpoint(tmp_path / "a")
    cfg = configs.get_smoke_config(arch)
    for k, v in _flat(to_reference_tree(s_at["params"], cfg)).items():
        assert v.tobytes() == _flat(tree["params"])[k].tobytes(), k
    jt = _jtrainer(tmp_path / "a", steps=steps, arch=arch)
    jt.fit()
    t = _trainer(tmp_path / "b", steps=steps, arch=arch)
    t.fit()
    assert [h["step"] for h in jt.history] == list(range(at + 1, steps + 1))
    np.testing.assert_allclose(_losses(t), _losses(jt), rtol=2e-5)


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """qwen2 with gradient compression, checkpointed at step 3 by the JAX
    trainer and resumed by the port to step 6."""
    _check_port_resumes_jax(tmp_path, "qwen2-1.5b", 3, 6, True)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    """qwen2, checkpointed at step 3 by the port and resumed by the
    reference to step 6."""
    _check_jax_resumes_port(tmp_path, "qwen2-1.5b", 3, 6)


@pytest.mark.parametrize("way", ["port-resumes-jax", "jax-resumes-port"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_checkpoint_crosses(tmp_path, arch, way):
    """A recurrent arch's checkpoint at step 2 resumed to step 4 by the
    other package: the bytes of the (L, R) Λ, the stacked block-diagonal
    gates and the moments of every recurrent leaf cross unchanged."""
    if way == "port-resumes-jax":
        _check_port_resumes_jax(tmp_path, arch, 2, 4, False)
    else:
        _check_jax_resumes_port(tmp_path, arch, 2, 4)


def test_values_from_tree_inverts_reference_tree_of():
    cfg = configs.get_smoke_config("deepseek-moe-16b")
    model = _port_model("deepseek-moe-16b", cfg)
    vals = [torch.randn(p.shape) for p in model.parameters()]
    back = values_from_tree(reference_tree_of(model, cfg, vals), cfg,
                            torch.float32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(vals, back))


# ------------------------------------------------ quantize from a checkpoint
def _planes(art):
    tree, manifest = load_artifact(art)
    return dict(iter_tree_leaves(tree)), manifest


def test_from_checkpoint_gives_the_reference_planes(tmp_path):
    """``launch/quantize.py --from-checkpoint`` of a JAX-written checkpoint
    in both packages: the same tensors, planes exactly, α within rtol
    1e-5, FP leaves byte for byte."""
    _jtrainer(tmp_path / "ck", steps=2).fit()
    args = ["--from-checkpoint", str(tmp_path / "ck"), "--t-max", "3",
            "--no-error-stats"]
    jquantize_launch.main(args + ["--out", str(tmp_path / "ref")])
    quantize_launch.main(args + ["--out", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got, gm = _planes(tmp_path / "port")
    want, wm = _planes(tmp_path / "ref")
    assert list(gm["tensors"]) == list(wm["tensors"])
    assert gm["model_config"] == wm["model_config"]
    assert sum(r["kind"] == "ptqtp" for r in gm["tensors"].values()) == 8
    for path, rec in gm["tensors"].items():
        if rec["kind"] == "ptqtp":
            g, w = got[path], want[path]
            assert torch.equal(g.t1p, w.t1p) and torch.equal(g.t2p, w.t2p)
            np.testing.assert_allclose(g.alpha.numpy(), w.alpha.numpy(),
                                       rtol=1e-5)
        else:
            assert got[path].numpy().tobytes() == \
                want[path].numpy().tobytes(), path


def test_bf16_checkpoint_quantizes_as_its_model(tmp_path):
    """A bf16 run of the port's trainer (its leaves stored as ``|V2``,
    its config in the manifest's ``extra``): ``--from-checkpoint`` reads
    the leaves by the manifest's dtype and writes the planes that
    quantizing the trained model's own tree gives, under the run's config."""
    cfg = configs.get_smoke_config("qwen2-1.5b").scaled(
        param_dtype="bfloat16", activation_dtype="bfloat16")
    t = Trainer(cfg, AdamW(lr=LR), DataConfig(**DATA),
                TrainerConfig(total_steps=2, ckpt_dir=str(tmp_path / "ck")),
                log_fn=lambda m: None, device="cpu")
    state = t.fit()
    manifest = json.loads((tmp_path / "ck" / "step_00000002"
                           / "manifest.json").read_text())
    assert manifest["leaves"]["params//lm_head//kernel"]["dtype"] == "bfloat16"
    args = ["--t-max", "5", "--no-error-stats", "--device", "cpu"]
    quantize_launch.main(args + ["--from-checkpoint", str(tmp_path / "ck"),
                                 "--out", str(tmp_path / "a")])
    from repro_torch.artifacts import write_artifact
    from repro_torch.core.ptqtp import PTQTPConfig
    write_artifact(tmp_path / "b", arch="qwen2-1.5b", model_cfg=cfg,
                   ptqtp_cfg=PTQTPConfig(group_size=64, t_max=5),
                   params=to_reference_tree(state["params"], cfg),
                   compute_error=False)
    got, gm = _planes(tmp_path / "a")
    want, wm = _planes(tmp_path / "b")
    assert gm["model_config"] == wm["model_config"]
    assert gm["model_config"]["param_dtype"] == "bfloat16"
    for path, rec in wm["tensors"].items():
        g, w = got[path], want[path]
        if rec["kind"] == "ptqtp":
            assert torch.equal(g.t1p, w.t1p) and torch.equal(g.alpha, w.alpha)
        else:
            assert torch.equal(g, w), path


def test_from_checkpoint_labels_the_artifact_with_the_runs_arch(tmp_path):
    """A checkpoint that records its model config labels the artifact with
    that model, whatever ``--arch`` defaults to; an ``--arch`` naming
    another model raises."""
    from repro_torch.artifacts import read_manifest
    from repro_torch.artifacts.format import model_config_to_json
    from repro_torch.models import init_params
    from repro_torch.runtime import save_checkpoint

    cfg = configs.get_smoke_config("gemma3-27b")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(tmp_path / "ck", 1,
                    {"params": to_reference_tree(model, cfg)},
                    extra={"model_config": model_config_to_json(cfg)})
    args = ["--from-checkpoint", str(tmp_path / "ck"), "--t-max", "1",
            "--no-error-stats", "--device", "cpu"]
    out = quantize_launch.main(args + ["--out", str(tmp_path / "a")])
    assert read_manifest(out)["arch"] == "gemma3-27b"
    with pytest.raises(ValueError, match="gemma3-27b run"):
        quantize_launch.main(args + ["--out", str(tmp_path / "b"),
                                     "--arch", "qwen2-1.5b"])


def _check_launchers(tmp_path, arch_args, at, steps):
    """``launch/train.py --device cpu`` trains to ``at`` and resumes to
    ``steps``; its checkpoint quantizes with ``--from-checkpoint`` and
    serves. Returns the artifact's directory."""
    from repro_torch.launch import serve as serve_launch

    common = arch_args + ["--device", "cpu", "--seq-len", "32", "--batch",
                          "4", "--ckpt-dir", str(tmp_path / "ck")]
    state, trainer = train_launch.main(["--steps", str(at)] + common)
    assert int(state["step"]) == at
    state, trainer = train_launch.main(["--steps", str(steps)] + common)
    assert [h["step"] for h in trainer.history] == list(range(at + 1,
                                                              steps + 1))
    assert all(np.isfinite(_losses(trainer)))
    out = quantize_launch.main(["--device", "cpu", "--from-checkpoint",
                                str(tmp_path / "ck"), "--out",
                                str(tmp_path / "a"), "--t-max", "5"])
    results = serve_launch.main(["--device", "cpu", "--artifact",
                                 str(tmp_path / "a"), "--requests", "2",
                                 "--max-new", "4"])
    assert len(results) == 2
    return out


def test_launchers_train_quantize_and_serve_on_cpu(tmp_path, capsys):
    """The default arch through the launchers, 3 steps resumed to 5."""
    _check_launchers(tmp_path, [], 3, 5)
    assert "[train] done: step 5" in capsys.readouterr().out


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_launchers_train_quantize_and_serve_on_cpu(tmp_path, arch):
    """``--arch`` of a recurrent arch through the launchers, 2 steps
    resumed to 3; the artifact is labelled with the arch from the
    checkpoint's manifest."""
    from repro_torch.artifacts import read_manifest

    out = _check_launchers(tmp_path, ["--arch", arch], 2, 3)
    assert read_manifest(out)["arch"] == arch


def test_cuda_is_never_swapped_for_the_cpu():
    """Asking for the card without one raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(configs.get_smoke_config("qwen2-1.5b"), AdamW(),
                DataConfig(**DATA), TrainerConfig())
