"""Worker layouts (port of ``repro.launch.mesh``).

The reference lays its workers out on a device mesh with named axes. The
port's workers are the processes of one ``torch.distributed`` group, one
device each, so a layout is a set of process groups over those ranks.

A ``(pod, data)`` layout of ``n_pods * n_data`` ranks numbers them
``rank = pod * n_data + data``: the reference's order over ("pod",
"data"), and the order ``data.ShardedBatcher`` slices the global batch
in. Each pod has a DATA group (its n_data ranks, by data index: the
intra-pod gather) and each data index a POD group (its n_pods ranks, by
pod: the cross-pod gather). ``torch.distributed.new_group`` must be
called by every rank for every group, in the same order, so
``make_layout`` creates them all and keeps this rank's two.

The groups take the default group's backend, which the caller chose by
name when it initialised it (the train CLI: NCCL on the card, gloo on the
CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a (pod, data) layout and its two groups."""

    n_pods: int
    n_data: int
    rank: int
    data_group: object  # this rank's pod: its n_data ranks
    pod_group: object  # this rank's data index: its n_pods ranks

    @property
    def pod(self) -> int:
        return self.rank // self.n_data

    @property
    def data(self) -> int:
        return self.rank % self.n_data

    @property
    def world(self) -> int:
        return self.n_pods * self.n_data


def split_pods(world: int, pods: int) -> Tuple[int, int]:
    """The ``--pods N`` split: (pods, world // pods), raising unless the
    pods divide the workers."""
    if pods < 1 or world % pods:
        raise ValueError(f"--pods {pods} does not divide {world} workers")
    return pods, world // pods


def make_layout(n_pods: int, n_data: Optional[int] = None) -> Layout:
    """The (n_pods, n_data) layout over the initialised default group
    (n_data: the world over the pods). Every rank must call it."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        raise RuntimeError("a worker layout needs an initialised "
                           "torch.distributed group")
    world = torch.distributed.get_world_size()
    if n_data is None:
        n_pods, n_data = split_pods(world, n_pods)
    if n_pods * n_data != world:
        raise ValueError(f"a ({n_pods}, {n_data}) layout needs "
                         f"{n_pods * n_data} workers, the group has {world}")
    rank = torch.distributed.get_rank()
    data_groups = [torch.distributed.new_group(
        [p * n_data + d for d in range(n_data)]) for p in range(n_pods)]
    pod_groups = [torch.distributed.new_group(
        [p * n_data + d for p in range(n_pods)]) for d in range(n_data)]
    return Layout(n_pods=n_pods, n_data=n_data, rank=rank,
                  data_group=data_groups[rank // n_data],
                  pod_group=pod_groups[rank % n_data])


def mesh_from_config(mc) -> Layout:
    """Materialise a ``repro_torch.configs.MeshConfig`` over the
    initialised group, whose size must be its n_pods * n_data."""
    if mc.n_model != 1:
        raise NotImplementedError(
            f"mesh {mc.name!r} has a model axis of {mc.n_model}: the "
            "tensor-parallel model axis is not ported to the PyTorch port")
    return make_layout(mc.n_pods, mc.n_data)


def pod_axis_of(layout: Optional[Layout]) -> Optional[str]:
    """"pod" on a layout of more than one pod (the two-level sync runs
    there), else None."""
    return "pod" if layout is not None and layout.n_pods > 1 else None


def n_chips(layout: Optional[Layout]) -> int:
    if layout is None:
        return (torch.distributed.get_world_size()
                if torch.distributed.is_initialized() else 1)
    return layout.world
