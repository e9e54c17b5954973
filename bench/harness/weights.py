"""The served weights, made on the device from the seed.

A model's weights are listed by its reference's ``param_spec``: (name,
shape, init) in a fixed order. ``make`` draws all of them from one
``torch.Generator`` seeded with the run's seed, in four large calls: the
trit codes of every plane, the group scales of every quantized layer, and
the normal and the uniform draws of every floating-point leaf. The same
seed on the same device gives the same weights, so the reference can make
them again once the program is gone instead of reading anything the
program holds.

A quantized layer (d_out, d_in) gets two trit-planes in the storage format
the program serves (four trits a byte, trit j in bits 2(j % 4) and
2(j % 4) + 1 of byte j // 4, field 0b01 = +1, 0b10 = -1, 0b00 = 0), each
trit uniform over {-1, 0, +1}, and float32 group scales a = sigma * (0.5 +
U[0, 1)) with sigma = sqrt(9 / (13 d_in)), so that a1*T1 + a2*T2 has the
variance 1 / d_in of a trained layer's initialisation. A ``tied`` leaf is
the dequantized planes of the layer it names, in the float dtype.
"""

from __future__ import annotations

import math

import torch

from reference.common import dequant

#: bytes of trit codes turned into packed bytes at a time (bounds the
#: temporaries)
_PACK_BLOCK = 1 << 27


def _packed(codes: torch.Tensor) -> torch.Tensor:
    """Codes uniform over [0, 81) (four base-3 digits, digit 0 = 0, 1 =
    +1, 2 = -1) -> packed bytes, in place and in blocks."""
    for i in range(0, codes.numel(), _PACK_BLOCK):
        c = codes[i:i + _PACK_BLOCK]
        out = torch.zeros_like(c)
        for j in range(4):
            out |= (c % 3) << (2 * j)
            c = torch.div(c, 3, rounding_mode="floor")
        codes[i:i + _PACK_BLOCK] = out
    return codes


def scale_sigma(d_in: int) -> float:
    return math.sqrt(9.0 / (13.0 * d_in))


@torch.no_grad()
def make(spec, seed: int, device, float_dtype, group: int):
    """Every weight of ``spec`` from ``seed`` on ``device``: a dict name ->
    tensor (float leaves in ``float_dtype``) or, for a quantized layer,
    (t1p (n, d/4) uint8, t2p, alpha (n, d/group, 2) float32)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    planes = [(n, s) for n, s, init in spec if init[0] == "planes"]
    normal = [(n, s, init) for n, s, init in spec if init[0] == "normal"]
    uniform = [(n, s, init) for n, s, init in spec if init[0] == "uniform"]
    for name, (d_out, d_in) in planes:
        if d_in % group or d_in % 4:
            raise ValueError(f"{name}: d_in {d_in} is not a whole number of "
                             f"groups of {group}")
    plane_bytes = sum(d_out * d_in // 4 for _, (d_out, d_in) in planes)
    n_alpha = sum(d_out * (d_in // group) * 2 for _, (d_out, d_in) in planes)
    codes = _packed(torch.randint(0, 81, (2 * plane_bytes,), generator=gen,
                                  device=device, dtype=torch.uint8))
    alphas = torch.rand((n_alpha,), generator=gen, device=device)
    zs = torch.randn((sum(math.prod(s) for _, s, _ in normal),),
                     generator=gen, device=device)
    us = torch.rand((sum(math.prod(s) for _, s, _ in uniform),),
                    generator=gen, device=device)
    out = {}
    cb = ca = 0
    for name, (d_out, d_in) in planes:
        nb = d_out * d_in // 4
        t1 = codes[cb:cb + nb].reshape(d_out, d_in // 4).clone()
        t2 = codes[cb + nb:cb + 2 * nb].reshape(d_out, d_in // 4).clone()
        na = d_out * (d_in // group) * 2
        alpha = (alphas[ca:ca + na] + 0.5) * scale_sigma(d_in)
        out[name] = (t1, t2, alpha.reshape(d_out, d_in // group, 2).clone())
        cb += 2 * nb
        ca += na
    del codes, alphas
    off = 0
    for name, shape, (_, mean, std, *_) in normal:
        n = math.prod(shape)
        out[name] = (zs[off:off + n] * std + mean).reshape(shape).to(
            float_dtype)
        off += n
    off = 0
    for name, shape, (_, lo, hi, *_) in uniform:
        n = math.prod(shape)
        out[name] = (us[off:off + n] * (hi - lo) + lo).reshape(shape).to(
            float_dtype)
        off += n
    for name, shape, init in spec:
        if init[0] == "tied":
            out[name] = dequant(out[init[1]], group).to(float_dtype)
        elif name not in out:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


def matmul_weights(spec) -> int:
    """Multiply-adds a token spends on the floating-point matrices that
    multiply activations (entries marked ``matmul``)."""
    return sum(math.prod(s) for _, s, init in spec if init[-1] == "matmul")
