"""Plain float32 reference of RWKV-6 "Finch" (arXiv:2404.05892), as the
serving program builds it, PTQTP-quantized: the r, k, v, g, o projections
of the time mix and the k, v, r projections of the channel mix, and the
head, are W = a1*T1 + a2*T2 by groups of ``group_size`` along d_in.

Per layer, on the residual stream x, with shift(h)_t = h_{t-1} (0 before
the first token) and H heads of hd = head_size:

  time mix      h  = RMSNorm(x) * time_norm;  s = shift(h) - h
                xx = h + s * mu_x
                m_j = h + s * (mu_j + tanh(xx A)_j B_j),  j in w, k, v, r, g
                r, k, v = m_r Wr^T, m_k Wk^T, m_v Wv^T;  g = silu(m_g Wg^T)
                w_t = exp(-exp(w0 + tanh(m_w Da) Db))
                S_t = diag(w_t) S_{t-1} + k_t v_t^T        (per head, hd x hd)
                y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
                y  = GroupNorm_heads(y, eps 1e-5) * ln_x;  x = x + (y * g) Wo^T
  channel mix   h  = RMSNorm(x) * chan_norm;  s = shift(h) - h
                k = relu((h + s mu_k) Wk^T)^2
                x = x + sigmoid((h + s mu_r) Wr^T) * (k Wv^T)
  logits        (RMSNorm(x) * final_norm) Wh^T

Departures from the published model, all of them the serving program's,
which the reference follows so that it judges the program as built: the
pre-norms and the final norm are RMSNorm with a scale, where RWKV-6 has
LayerNorm with a bias, and there is no LayerNorm after the embedding; the
head group norm has a scale and no bias, with eps 1e-5 where RWKV-6 uses
1e-5 * head_size_divisor^2. The recurrence runs in chunks of ``CHUNK``
steps (the same sums in closed form over each chunk, with the decays as
differences of cumulative log decays, which are never positive), not
step by step: the same function in another summation order.
"""

from __future__ import annotations

import torch

from reference.common import F32, Rounding, dequant, rms_norm

MIX = ("w", "k", "v", "r", "g")
CHUNK = 32
GROUP_NORM_EPS = 1e-5


def sizes(c):
    d = c["hidden_size"]
    hd = c["head_size"]
    return dict(d=d, hd=hd, h=d // hd, ff=c["intermediate_size"],
                v=c["vocab_size"], n=c["num_hidden_layers"],
                mix_r=c["time_mix_extra_dim"], decay_r=c["time_decay_extra_dim"])


def param_spec(c):
    """[(name, shape, init)] of every weight, in the order they are made.
    ``("planes",)`` is a quantized linear layer (d_out, d_in); ``matmul``
    marks a float matrix that multiplies activations (the LoRAs)."""
    s = sizes(c)
    d, ff, n_mix = s["d"], s["ff"], len(MIX)
    norm = ("normal", 1.0, 0.1)
    mix = ("uniform", 0.0, 1.0)
    lora = ("normal", 0.0, 0.01, "matmul")
    out = [("embed", (s["v"], d),
            ("tied", "lm_head") if c["tie_word_embeddings"]
            else ("normal", 0.0, 0.02))]
    for i in range(s["n"]):
        p = f"layers.{i}"
        t = f"{p}.time"
        out += [(f"{p}.time_norm.scale", (d,), norm),
                (f"{t}.mu_x", (d,), mix),
                (f"{t}.mu", (n_mix, d), mix),
                (f"{t}.mix_lora_a", (d, n_mix * s["mix_r"]), lora),
                (f"{t}.mix_lora_b", (n_mix, s["mix_r"], d), lora),
                (f"{t}.decay_base", (d,), ("uniform", -6.0, -1.0)),
                (f"{t}.decay_lora_a", (d, s["decay_r"]), lora),
                (f"{t}.decay_lora_b", (s["decay_r"], d), lora),
                (f"{t}.u", (s["h"], s["hd"]), ("normal", 0.0, 0.1))]
        out += [(f"{t}.{w}", (d, d), ("planes",))
                for w in ("wr", "wk", "wv", "wg", "wo")]
        out += [(f"{t}.ln_x.scale", (d,), norm),
                (f"{p}.chan_norm.scale", (d,), norm),
                (f"{p}.chan.mu_k", (d,), mix),
                (f"{p}.chan.mu_r", (d,), mix),
                (f"{p}.chan.wk", (ff, d), ("planes",)),
                (f"{p}.chan.wv", (d, ff), ("planes",)),
                (f"{p}.chan.wr", (d, d), ("planes",))]
    out += [("final_norm.scale", (d,), norm),
            ("lm_head", (s["v"], d), ("planes",))]
    return out


def mixer_flops(c, context: int) -> float:
    """FLOPs of the WKV recurrence for one token, over all layers: the
    state's update by k v^T and the readout r^T S, hd^2 multiply-adds each
    a head, 2 per multiply-add. It does not grow with the context."""
    del context
    s = sizes(c)
    return s["n"] * 4.0 * s["h"] * s["hd"] ** 2


def _shift(h):
    """h_{t-1} at every step, zeros before the first."""
    return torch.nn.functional.pad(h, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, w, u):
    """The recurrence from a zero state: r, k, v, w (B, S, H, hd) float32,
    u (H, hd). Returns y (B, S, H, hd).

    Over a chunk with state S0 before it and L_t = sum_{s<=t} log w_s:
      y_t = (r_t e^{L_{t-1}})^T S0
            + sum_{s<t} (sum_i r_ti k_si e^{L_{t-1,i} - L_{s,i}}) v_s
            + (r_t . (u k_t)) v_t
      S_C = e^{L_{C-1}} S0 + sum_s (k_s e^{L_{C-1} - L_s}) v_s^T"""
    b, length, h, hd = r.shape
    state = r.new_zeros((b, h, hd, hd))
    uf = u.to(F32)
    out = []
    for c0 in range(0, length, CHUNK):
        rc, kc, vc = (t[:, c0:c0 + CHUNK] for t in (r, k, v))
        lw = torch.log(w[:, c0:c0 + CHUNK])
        cum = torch.cumsum(lw, dim=1)
        prev = cum - lw
        n = rc.shape[1]
        y = torch.einsum("bthi,bhij->bthj", rc * torch.exp(prev), state)
        dist = prev[:, :, None] - cum[:, None, :]           # (B, t, s, H, hd)
        before = torch.ones((n, n), dtype=torch.bool, device=r.device).tril(-1)
        dist = dist.masked_fill(~before[None, :, :, None, None], float("-inf"))
        att = torch.einsum("bthi,btshi,bshi->btsh", rc, torch.exp(dist), kc)
        y = y + torch.einsum("btsh,bshj->bthj", att, vc)
        y = y + (rc * uf * kc).sum(-1, keepdim=True) * vc
        last = cum[:, -1]
        state = torch.exp(last)[..., None] * state + torch.einsum(
            "bshi,bshj->bhij", kc * torch.exp(last[:, None] - cum), vc)
        out.append(y)
    return torch.cat(out, dim=1)


@torch.no_grad()
def logits(weights, c, seqs, starts, rounding=None):
    """Float32 logits of every sequence of ``seqs`` (lists of token ids)
    from position ``starts[i]`` on: a list of (len(seq) - start, V). The
    sequences run right-padded in one batch, each from a zero state (the
    recurrence is causal: padding at the end never reaches a real
    position), layer by layer."""
    s = sizes(c)
    rnd = Rounding(rounding)
    gs = c["quantization"]["group_size"]
    eps = c["layer_norm_epsilon"]
    dev = weights["final_norm.scale"].device
    b, length = len(seqs), max(map(len, seqs))
    d, h, hd = s["d"], s["h"], s["hd"]
    toks = torch.zeros((b, length), dtype=torch.int64, device=dev)
    for i, sq in enumerate(seqs):
        toks[i, :len(sq)] = torch.as_tensor(sq, device=dev)
    x = weights["embed"][toks].to(F32)

    def f(name):
        return weights[name].to(F32)

    def lin(name, hh):
        return rnd.linear(hh, dequant(weights[name], gs))

    for i in range(s["n"]):
        p, t = f"layers.{i}", f"layers.{i}.time"
        hh = rms_norm(x, weights[f"{p}.time_norm.scale"], eps)
        sx = _shift(hh) - hh
        xx = hh + sx * f(f"{t}.mu_x")
        a = torch.tanh(rnd.linear(xx, f(f"{t}.mix_lora_a").T))
        a = a.reshape(b, length, len(MIX), s["mix_r"])
        lb = f(f"{t}.mix_lora_b")
        mu = f(f"{t}.mu")
        m = {j: hh + sx * (mu[n] + rnd.linear(a[:, :, n], lb[n].T))
             for n, j in enumerate(MIX)}
        r = lin(f"{t}.wr", m["r"]).reshape(b, length, h, hd)
        k = lin(f"{t}.wk", m["k"]).reshape(b, length, h, hd)
        v = lin(f"{t}.wv", m["v"]).reshape(b, length, h, hd)
        g = torch.nn.functional.silu(lin(f"{t}.wg", m["g"]))
        lo = torch.tanh(rnd.linear(m["w"], f(f"{t}.decay_lora_a").T))
        lo = rnd.linear(lo, f(f"{t}.decay_lora_b").T)
        w = torch.exp(-torch.exp(f(f"{t}.decay_base") + lo))
        y = wkv(r, rnd(k), rnd(v), w.reshape(b, length, h, hd),
                weights[f"{t}.u"])
        mean = y.mean(-1, keepdim=True)
        var = ((y - mean) ** 2).mean(-1, keepdim=True)
        y = ((y - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(
            b, length, d) * f(f"{t}.ln_x.scale")
        x = x + lin(f"{t}.wo", y * g)
        hh = rms_norm(x, weights[f"{p}.chan_norm.scale"], eps)
        sx = _shift(hh) - hh
        kk = torch.relu(lin(f"{p}.chan.wk", hh + sx * f(f"{p}.chan.mu_k")))
        rr = torch.sigmoid(lin(f"{p}.chan.wr", hh + sx * f(f"{p}.chan.mu_r")))
        x = x + rr * lin(f"{p}.chan.wv", kk * kk)
    hh = rms_norm(x, weights["final_norm.scale"], eps)
    head = dequant(weights["lm_head"], gs)
    return [rnd.linear(hh[i, st:len(sq)], head)
            for i, (sq, st) in enumerate(zip(seqs, starts))]
