"""Plain float32 reference of Qwen2 (arXiv:2407.10671; the Hugging Face
``Qwen2ForCausalLM`` equations), PTQTP-quantized: every linear layer and the
head are W = a1*T1 + a2*T2 by groups of ``group_size`` along d_in.

Per layer, on the residual stream x:

    h  = RMSNorm(x) * attn_norm                 (eps = rms_norm_eps)
    q, k, v = h Wq^T + bq, h Wk^T + bk, h Wv^T + bv
    q, k  <- RoPE(theta = rope_theta), rotate-half layout
    a  = softmax(q k^T / sqrt(hd), causal) v, query head i on kv head
         i // (heads / kv_heads)
    x  = x + a Wo^T
    h  = RMSNorm(x) * mlp_norm
    x  = x + (silu(h Wg^T) * (h Wi^T)) Wo2^T
    logits = (RMSNorm(x) * final_norm) Wh^T

With ``tie_word_embeddings`` the embedding table is the head's weight, as
the model was published; the benchmark makes it by dequantizing the head's
planes (rounded to the served dtype). Departures: none in the equations;
the weights are random from the seed, and the computation runs in float32
(no TF32) where the program serves bfloat16.

The names of ``param_spec`` are the keys the benchmark hands weights
under; they are the serving program's module paths, which the benchmark
fills by name.
"""

from __future__ import annotations

import torch

from reference.common import F32, Rounding, dequant, rms_norm

#: query rows of one attention block (bounds the score matrix)
Q_BLOCK = 256


def sizes(c):
    d = c["hidden_size"]
    h = c["num_attention_heads"]
    return dict(d=d, h=h, kv=c["num_key_value_heads"], hd=d // h,
                ff=c["intermediate_size"], v=c["vocab_size"],
                n=c["num_hidden_layers"])


def param_spec(c):
    """[(name, shape, init)] of every weight, in the order they are made.
    ``("planes",)`` is a quantized linear layer (d_out, d_in)."""
    s = sizes(c)
    d, hd = s["d"], s["hd"]
    norm = ("normal", 1.0, 0.1)
    bias = ("normal", 0.0, 0.1)
    out = [("embed", (s["v"], d),
            ("tied", "lm_head") if c["tie_word_embeddings"]
            else ("normal", 0.0, 0.02))]
    for i in range(s["n"]):
        p = f"layers.{i}"
        out += [(f"{p}.attn_norm.scale", (d,), norm),
                (f"{p}.attn.wq", (s["h"] * hd, d), ("planes",)),
                (f"{p}.attn.wq.bias", (s["h"] * hd,), bias),
                (f"{p}.attn.wk", (s["kv"] * hd, d), ("planes",)),
                (f"{p}.attn.wk.bias", (s["kv"] * hd,), bias),
                (f"{p}.attn.wv", (s["kv"] * hd, d), ("planes",)),
                (f"{p}.attn.wv.bias", (s["kv"] * hd,), bias),
                (f"{p}.attn.wo", (d, s["h"] * hd), ("planes",)),
                (f"{p}.mlp_norm.scale", (d,), norm),
                (f"{p}.mlp.wg", (s["ff"], d), ("planes",)),
                (f"{p}.mlp.wi", (s["ff"], d), ("planes",)),
                (f"{p}.mlp.wo", (d, s["ff"]), ("planes",))]
    out += [("final_norm.scale", (d,), norm),
            ("lm_head", (s["v"], d), ("planes",))]
    return out


def mixer_flops(c, context: int) -> float:
    """FLOPs of attention for one token that sees ``context`` positions
    (itself included), over all layers: q k^T and p v, 2 per multiply-add."""
    s = sizes(c)
    return s["n"] * 4.0 * s["h"] * s["hd"] * context


def _rope(x, positions, theta):
    """x (B, S, H, hd) rotated by positions (S,), rotate-half layout."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, device=x.device,
                                         dtype=F32) / half)
    ang = positions.to(F32)[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, g):
    """Causal GQA: q (B, S, H, hd), k and v (B, S, KV, hd) -> (B, S, H*hd)."""
    b, s, h, hd = q.shape
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    out = []
    for q0 in range(0, s, Q_BLOCK):
        qb = q[:, q0:q0 + Q_BLOCK]
        sc = torch.einsum("bqhd,bshd->bhqs", qb, k) * hd ** -0.5
        rows = torch.arange(q0, q0 + qb.shape[1], device=q.device)
        mask = rows[:, None] >= torch.arange(s, device=q.device)[None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out.append(torch.einsum("bhqs,bshd->bqhd", torch.softmax(sc, -1), v))
    return torch.cat(out, dim=1).reshape(b, s, h * hd)


@torch.no_grad()
def logits(weights, c, seqs, starts, rounding=None):
    """Float32 logits of every sequence of ``seqs`` (lists of token ids)
    from position ``starts[i]`` on: a list of (len(seq) - start, V).

    The sequences run right-padded in one batch (every product is causal,
    so padding at the end never reaches a real position), layer by layer:
    each layer's weights are dequantized when it runs and freed after."""
    s = sizes(c)
    rnd = Rounding(rounding)
    g_size = c["quantization"]["group_size"]
    eps = c["rms_norm_eps"]
    dev = weights["final_norm.scale"].device
    b, length = len(seqs), max(map(len, seqs))
    toks = torch.zeros((b, length), dtype=torch.int64, device=dev)
    for i, sq in enumerate(seqs):
        toks[i, :len(sq)] = torch.as_tensor(sq, device=dev)
    x = weights["embed"][toks].to(F32)
    pos = torch.arange(length, device=dev)
    hd, g = s["hd"], s["h"] // s["kv"]

    def lin(name, h):
        bias = weights.get(f"{name}.bias")
        return rnd.linear(h, dequant(weights[name], g_size), bias)

    for i in range(s["n"]):
        p = f"layers.{i}"
        h = rms_norm(x, weights[f"{p}.attn_norm.scale"], eps)
        q = _rope(lin(f"{p}.attn.wq", h).reshape(b, length, s["h"], hd),
                  pos, c["rope_theta"])
        k = _rope(lin(f"{p}.attn.wk", h).reshape(b, length, s["kv"], hd),
                  pos, c["rope_theta"])
        v = lin(f"{p}.attn.wv", h).reshape(b, length, s["kv"], hd)
        x = x + lin(f"{p}.attn.wo", _attention(q, rnd(k), rnd(v), g))
        h = rms_norm(x, weights[f"{p}.mlp_norm.scale"], eps)
        x = x + lin(f"{p}.mlp.wo", torch.nn.functional.silu(
            lin(f"{p}.mlp.wg", h)) * lin(f"{p}.mlp.wi", h))
    h = rms_norm(x, weights["final_norm.scale"], eps)
    head = dequant(weights["lm_head"], g_size)
    return [rnd.linear(h[i, st:len(sq)], head)
            for i, (sq, st) in enumerate(zip(seqs, starts))]
