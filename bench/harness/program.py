"""The system under test: the serving program built from a configuration
file and the benchmark's weights. The only module of the harness that
reaches into the program, through its public names: the model config
registry, the model's module tree (filled by the names of the reference's
``param_spec``), ``QuantizedKernel`` and ``set_quantized``,
``ServingEngine`` and ``EngineConfig``, and the row count that splits the
ternary calls between its two kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import configs
from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.device import dtype_of
from repro_torch.kernels.ternary_matmul import SMALL_M_THRESHOLD
from repro_torch.models.transformer import Transformer
from repro_torch.serving import EngineConfig, ServingEngine


def model_config(config):
    """The program's ModelConfig for a configuration file: the registry's
    entry with ``program.set`` applied, checked against ``program.expect``
    (a value, or "@key" for the published config's key)."""
    prog = config["program"]
    cfg = dataclasses.replace(configs.get_config(prog["arch"]),
                              **prog.get("set", {}))
    for field, want in prog["expect"].items():
        if isinstance(want, str) and want.startswith("@"):
            want = config["config"][want[1:]]
        have = getattr(cfg, field)
        if isinstance(have, tuple):
            have = list(have)
        if have != want:
            raise ValueError(f"{config['name']}: the program's {field} is "
                             f"{have!r}, the configuration states {want!r}")
    return cfg


def float_dtype(cfg) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


@torch.no_grad()
def build_model(cfg, spec, weights, group: int, device):
    """The program's model with every weight of ``spec`` loaded from
    ``weights``. Raises if the model has a weight the spec does not fill,
    or one of another shape."""
    model = Transformer(cfg, dtype=float_dtype(cfg), device=device)
    filled = set()
    for name, shape, init in spec:
        if init[0] == "planes":
            layer = model.get_submodule(name)
            t1p, t2p, alpha = weights[name]
            d_out, d_in = shape
            layer.set_quantized(QuantizedKernel(t1p, t2p, alpha, d_in, d_out,
                                                group))
        else:
            path, _, attr = name.rpartition(".")
            leaf = getattr(model.get_submodule(path) if path else model, attr)
            if tuple(leaf.shape) != tuple(shape):
                raise ValueError(f"{name}: the program's shape "
                                 f"{tuple(leaf.shape)}, the spec's {shape}")
            leaf.copy_(weights[name])
        filled.add(name)
    left = [n for n, _ in model.named_parameters() if n not in filled]
    left += [n for n, m in model.named_modules()
             if hasattr(m, "set_quantized") and getattr(m, "t1p", 1) is None]
    if left:
        raise ValueError(f"weights the benchmark does not make: {left[:8]}")
    return model


def engine(model, cfg, mix):
    """A ServingEngine with the mix's engine settings, its dispatches
    captured (``warmup``)."""
    eng = ServingEngine(model, cfg, EngineConfig(**mix["engine"]))
    eng.warmup()
    return eng


def counters(eng):
    """The program's counters (its registry's), read now."""
    return dict(eng.obs.registry.counters())


def activation_dtype(cfg) -> torch.dtype:
    return dtype_of(cfg.activation_dtype)


def small_m_threshold() -> int:
    """Padded rows from which a ternary call goes to the tiled kernel (B3)
    rather than the small-m one (B1)."""
    return int(SMALL_M_THRESHOLD)


def build_kernels() -> None:
    """Build every kernel source of the program at once (one nvcc each, in
    parallel) into its build directory inside the checkout; a no-op once
    the libraries are there."""
    from repro_torch.kernels import _build
    _build.build(_build.kernel_sources())
