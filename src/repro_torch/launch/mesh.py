"""Mesh construction over the initialised ``torch.distributed`` world.

Counterpart of ``repro/launch/mesh.py``.  Functions, not module-level
constants: importing this module touches no process group.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch import sharding


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the reference's production mesh: 16 x 16
    (256 ranks) or 2 x 16 x 16 (512 ranks, two pods)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, dry: bool = False,
                         rank: int = 0) -> sharding.Mesh:
    """The production mesh over the world: ``pod`` spans pods, ``data`` is
    the intra-pod data / FSDP axis, ``model`` the tensor-parallel axis
    (innermost).  Its 256 or 512 ranks must all be there: a smaller world
    raises.  ``dry``: rank ``rank`` of it without a world
    (``sharding.dry_mesh``, the dry-run's)."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    if dry:
        return sharding.dry_mesh(shape, axes, rank)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = 1
    for s in shape:
        n *= s
    if world != n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {n} ranks; the world has {world}")
    return sharding.init_mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1, pods: int = 1
                   ) -> Optional[sharding.Mesh]:
    """A mesh over the ranks there are: ``(data, model)``, or with
    ``pods > 1`` ``(pod, data, model)`` (the compressed cross-pod step).
    None for a world of 1 with no process group: the single-device path."""
    if not dist.is_initialized():
        if model_parallel * pods != 1:
            raise ValueError(f"--model-parallel {model_parallel} x --pods "
                             f"{pods} needs a distributed world (torchrun)")
        return None
    n = dist.get_world_size()
    if n % (model_parallel * pods):
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"{model_parallel} x pods {pods}")
    if pods > 1:
        return sharding.init_mesh((pods, n // (model_parallel * pods),
                                   model_parallel), ("pod", "data", "model"))
    return sharding.init_mesh((n // model_parallel, model_parallel),
                              ("data", "model"))
