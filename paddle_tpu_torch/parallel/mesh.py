"""Mesh construction and axis conventions (counterpart of
``paddle_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
("dp", "pp", "tp") and runs per-device code under ``shard_map``.  The port
runs one process per rank: each JAX device of the mesh becomes one rank of
a ``torch.distributed`` world, laid out with the reference's axis order (tp
innermost, dp outermost), and each axis of size above one gets a process
group: the ranks that share the other two coordinates.  ``groups[WORLD]``
is the whole world's group, for what every rank must take part in (the
broadcast of replicated parameters).  ``with mesh:`` makes the mesh active,
as ``shard_map`` binds its axes; the collective wrappers
(``collectives.py``) look their axis up in the active mesh and are no-ops
outside one.  ``local_shard_map`` has no counterpart: each rank's process
is the body.
"""

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..kernels._common import resolve_device

__all__ = ["DP", "PP", "TP", "WORLD", "MeshSpec", "Mesh", "make_mesh",
           "axis_size", "active_mesh", "axis_groups", "batch_spec",
           "backend_for", "init_world"]

# Canonical axis names.  dp = data parallel (batch), pp = pipeline stages,
# tp = tensor parallel.
DP, PP, TP = "dp", "pp", "tp"
AXES = (DP, PP, TP)
WORLD = "world"        # the key of the whole world's group in Mesh.groups
_ACTIVE = []           # the meshes entered with ``with mesh:``, innermost last


@dataclasses.dataclass
class MeshSpec:
    """Declarative mesh shape (the BuildStrategy analogue for topology —
    details/build_strategy.h:125-139 num_trainers / hierarchical knobs)."""

    dp: int = 1
    pp: int = 1
    tp: int = 1
    # ZeRO/kReduce: shard optimizer state over dp (parallel/zero.py)
    zero: bool = False

    @property
    def size(self):
        return self.dp * self.pp * self.tp

    def build(self, device=None):
        return make_mesh(self.dp, self.pp, self.tp, device=device)


class Mesh:
    """This rank's view of the world laid out as (dp, pp, tp): the axis
    sizes (``shape``), this rank's coordinate on each axis (``coords``),
    the process group of each axis above size one and of the whole world
    above one rank (``groups``, the world's under ``WORLD``) and the rank's
    ``device``."""

    def __init__(self, shape, coords, groups, device):
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.device = device

    @property
    def size(self):
        n = 1
        for a in AXES:
            n *= self.shape[a]
        return n

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    def __repr__(self):
        return "Mesh(%s, device=%s)" % (
            ", ".join("%s=%d" % (a, self.shape[a]) for a in AXES), self.device)


def make_mesh(dp=1, pp=1, tp=1, device=None):
    """The mesh of the current ``torch.distributed`` world, ranks laid out
    dp-major as the reference orders its devices (``mesh.py:46-67``: rank =
    (d * pp + p) * tp + t).  A one-rank mesh needs no world (a process
    outside one, or one rank of a larger world running alone); a larger one
    needs a world of exactly ``dp * pp * tp`` ranks, every one of which
    calls this with the same sizes: each makes the process group of every
    axis above size one, for every value of the other two coordinates, in
    one fixed order (``dist.new_group`` is collective), and keeps its own.
    ``device``: this rank's device (``cuda`` unless named)."""
    device = resolve_device(device)
    need = dp * pp * tp
    shape = {DP: dp, PP: pp, TP: tp}
    if need == 1:
        return Mesh(shape, {a: 0 for a in AXES}, {}, device)
    if not dist.is_initialized():
        raise ValueError(
            "mesh %dx%dx%d needs %d ranks and no process group is "
            "initialised (fleet.init() or torch.distributed."
            "init_process_group)" % (dp, pp, tp, need))
    world = dist.get_world_size()
    if world != need:
        raise ValueError("mesh %dx%dx%d needs %d ranks, the world has %d"
                         % (dp, pp, tp, need, world))
    rank = dist.get_rank()
    coords = {DP: rank // (pp * tp), PP: (rank // tp) % pp, TP: rank % tp}
    groups = {WORLD: dist.group.WORLD}
    for axis in AXES:
        for ranks in axis_groups(shape, axis):
            # an axis spanning the world uses the world's group
            group = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = group
    return Mesh(shape, coords, groups, device)


def axis_groups(shape, axis):
    """The global ranks of each group of ``axis`` (none at size one): the
    ranks whose other two coordinates are equal, in the order every rank
    makes them."""
    if shape[axis] == 1:
        return []
    others = [a for a in AXES if a != axis]
    out = []
    for i in range(shape[others[0]]):
        for j in range(shape[others[1]]):
            c = {others[0]: i, others[1]: j}
            out.append([(c2[DP] * shape[PP] + c2[PP]) * shape[TP] + c2[TP]
                        for c2 in ({**c, axis: k}
                                   for k in range(shape[axis]))])
    return out


def axis_size(mesh, name):
    return mesh.shape.get(name, 1)


def active_mesh():
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def batch_spec():
    """PartitionSpec of a [batch, ...] array fed to the step: the batch
    split over dp (delegated to ``rules.batch_spec``)."""
    from . import rules as shard_rules

    return shard_rules.batch_spec(DP)


# -- the world ----------------------------------------------------------------

def backend_for(device):
    """The process-group backend for ranks on ``device``: NCCL for a card,
    gloo for the CPU.  ``PADDLE_DISTRI_BACKEND`` (``nccl`` or ``gloo``)
    names it instead: two ranks that share one card run gloo over CUDA
    tensors, since NCCL refuses two ranks on one device."""
    chosen = os.environ.get("PADDLE_DISTRI_BACKEND", "")
    if chosen:
        if chosen not in ("nccl", "gloo"):
            raise ValueError("PADDLE_DISTRI_BACKEND=%r: nccl or gloo" % chosen)
        return chosen
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_world(rank, world_size, endpoint, device, timeout_s=300):
    """``torch.distributed.init_process_group`` for one rank of a world
    whose rank 0 listens on ``endpoint`` ("host:port"), with the backend
    ``backend_for(device)`` picks.  On a card, the rank's device is set
    first.  A failed bootstrap raises; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend_for(device), init_method="tcp://%s" % endpoint,
        rank=int(rank), world_size=int(world_size),
        timeout=datetime.timedelta(seconds=timeout_s))
