"""The train step: microbatched gradient accumulation + AdamW update (the
reference's ``repro.training.train_step``).

The state is ``{"params": the model (its float parameters require grad),
"opt": {"m", "v", "count"}, "step"}`` (and ``"err"`` under gradient
compression): the moments and the error are lists of tensors in
``model.parameters()`` order, ``count`` and ``step`` int32 scalars. A step
updates it in place; the optimizer decays the leaves the reference's
decays (``convert.reference_ndims``). ``cfg.microbatches`` = M > 1 splits
the batch into M chunks along its first axis, accumulates their gradients
in f32 and hands the optimizer their f32 mean, as the reference's
``lax.scan`` does; with M = 1 the gradients keep the parameters' dtype, as
the reference's do.

``state_tree`` lays the state out as the reference's state tree (the
params tree of ``convert.to_reference_tree``, the moments and the error
as trees of the same paths; every dict's keys sorted, as the reference's
jitted step returns them), which is what a checkpoint holds;
``state_from_tree`` reads one back onto a device. A checkpoint of either
package resumes in the other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.convert import (from_jax_params, reference_ndims,
                                 reference_tree_of, to_reference_tree,
                                 values_from_tree)
from repro_torch.models.transformer import loss_fn
from repro_torch.optim.adamw import AdamW


def grads_of(model, cfg, batch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(the batch's loss, detached; the gradient of every parameter of
    ``model`` in ``parameters()`` order, zeros for an unused one)."""
    params = list(model.parameters())
    loss = loss_fn(model, cfg, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for g, p in zip(grads, params)]


def _split(batch: Dict[str, torch.Tensor], m: int):
    b = next(iter(batch.values())).shape[0]
    if b % m:
        raise ValueError(f"batch {b} is not a multiple of microbatches {m}")
    return [{k: v[i * (b // m):(i + 1) * (b // m)] for k, v in batch.items()}
            for i in range(m)]


def make_train_step(cfg, opt: AdamW):

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        model = state["params"]
        ndims = reference_ndims(model, cfg)
        m = cfg.microbatches
        if m > 1:
            loss_sum = None
            g_sum = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in model.parameters()]
            for mb in _split(batch, m):
                loss, g = grads_of(model, cfg, mb)
                for acc, gi in zip(g_sum, g):
                    acc.add_(gi)
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / m
            grads = [g / m for g in g_sum]
        else:
            loss, grads = grads_of(model, cfg, batch)
        opt.update(grads, state["opt"], list(model.parameters()), ndims)
        state["step"].add_(1)
        return state, {"loss": loss}

    return train_step


def init_train_state(cfg, model, opt: AdamW) -> Dict[str, Any]:
    """The state of a fresh run on ``model``'s device; its parameters start
    requiring grad here."""
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    return {"params": model, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params[0].device)}


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def state_tree(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The reference's state tree of ``state``: the tensors themselves
    (kernels transposed, layers stacked), keys sorted."""
    model = state["params"]
    opt = state["opt"]
    tree = {"params": to_reference_tree(model, cfg),
            "opt": {"m": reference_tree_of(model, cfg, opt["m"]),
                    "v": reference_tree_of(model, cfg, opt["v"]),
                    "count": opt["count"]},
            "step": state["step"]}
    if "err" in state:
        tree["err"] = reference_tree_of(model, cfg, state["err"])
    return _sorted(tree)


def state_from_tree(tree: Dict[str, Any], cfg, device="cuda"
                    ) -> Dict[str, Any]:
    """A train state on ``device`` from the reference's state tree (a
    checkpoint of either package). The moments and the error keep the
    dtype they were stored in."""
    model = from_jax_params(tree["params"], cfg, device=device)
    for p in model.parameters():
        p.requires_grad_(True)

    def values(sub):
        dt = next(iter(_leaves(sub))).dtype
        return values_from_tree(sub, cfg, dt, device)

    opt = tree["opt"]
    state = {"params": model,
             "opt": {"m": values(opt["m"]), "v": values(opt["v"]),
                     "count": torch.as_tensor(opt["count"]).to(
                         device=device, dtype=torch.int32)},
             "step": torch.as_tensor(tree["step"]).to(device=device,
                                                      dtype=torch.int32)}
    if "err" in tree:
        state["err"] = values_from_tree(tree["err"], cfg, torch.float32,
                                        device)
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
