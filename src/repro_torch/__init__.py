"""PTQTP in PyTorch for NVIDIA Hopper.

A port of the JAX reference package ``repro``: the same configs, quantizer,
dense GQA decoder and continuous-batching serving engine, with every TPU
kernel on the serving path replaced by a CUDA kernel written for ``sm_90a``
(``repro_torch.kernels``). The package imports neither JAX nor ``repro``.
Entry points take an explicit ``device`` (default ``"cuda"``).
"""
