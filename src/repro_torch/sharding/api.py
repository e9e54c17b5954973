"""Activation-sharding hook: the models call ``constrain(x, name)``; a
launcher installs a rule set mapping names to specs
(``partition.activation_rules``) with ``activation_sharding``.

``constrain`` returns x itself when no rules are installed, when the name
has no rule or its rule is None, and when x is a plain tensor: a model that
runs on one device sees no launch and no change of a bit. A
``torch.distributed.tensor.DTensor`` is redistributed to the rule's
placements on its own mesh (the counterpart of the reference's
``with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

import torch

from repro_torch.sharding.partition import Spec, placements

_state = threading.local()


def current_rules() -> Optional[Dict[str, Optional[Spec]]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def activation_sharding(rules: Dict[str, Optional[Spec]]):
    """Install ``rules`` for this thread for the duration of the block."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    rules = current_rules()
    if not rules or rules.get(name) is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(rules[name],
                                                    x.device_mesh))
