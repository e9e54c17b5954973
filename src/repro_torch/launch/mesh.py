"""Production meshes. Functions, not module constants: importing this module
sets up no process group and touches no device.

``make_production_mesh`` is the reference's (16, 16) ("data", "model")
mesh, or (2, 16, 16) ("pod", "data", "model") with ``multi_pod``, as a
``torch.distributed`` ``DeviceMesh`` over the process group's ranks. The
dry run (``launch/dryrun.py``) builds it on ``torch.distributed``'s fake
backend with the world size set to the mesh size; one H100 holds only a
1 x 1 mesh (``make_mesh((1, 1), ("data", "model"))``).
"""

from __future__ import annotations

import math


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """Elastic helper: a mesh of ``shape`` named ``axes`` over the first
    ``prod(shape)`` ranks of the initialised process group."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    n, world = math.prod(shape), _world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the process group has {world}: "
            "run under torch.distributed's fake backend "
            "(torch.testing._internal.distributed.fake_pg.FakeStore, "
            f"world_size={n}; launch/dryrun.py sets it up)")
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    import torch

    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)
