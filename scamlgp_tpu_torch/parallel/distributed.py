"""Multi-process execution: the study axis across processes
(``scamlgp_tpu/parallel/distributed.py``).

The JAX package lays the study axis across processes and the task axis
inside one.  Studies never communicate, so the only traffic between
processes is host data: process 0's draw of the unseeded target tasks,
pinned on every process before the campaign (``broadcast_from_host0``),
and the results gathered after it (``allgather``, ``local_study_rows``).

So here a ``torch.distributed`` process group carries host (CPU) tensors
only, over gloo, on GPUs as on CPUs: no collective runs on a card.  NCCL
would need one card a process, and the card's machine holds one; gloo
lets several processes share it, each with its own CUDA context.  Each
process runs ``run_campaign`` over the global mesh (``global_mesh``),
which runs the rows of its own slots.

Without a card the same path runs with ``cpu`` slots: see
``python -m scamlgp_tpu_torch.distributed_worker`` and
``tests/test_torch_distributed.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from scamlgp_tpu_torch.parallel.mesh import Mesh, cuda_devices, device_grid


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group of a multi-process campaign.

    Arguments default from the environment (``SCAMLGP_COORDINATOR`` /
    ``SCAMLGP_NUM_PROCESSES`` / ``SCAMLGP_PROCESS_ID``); nothing is
    detected otherwise.

    Args:
        coordinator_address: ``host:port`` where process 0 listens (a free
            port on ``127.0.0.1`` for processes of one machine).
        num_processes: total process count.
        process_id: this process's rank in ``[0, num_processes)``.
    """
    coordinator_address = (coordinator_address
                           or os.environ.get("SCAMLGP_COORDINATOR"))
    if num_processes is None and "SCAMLGP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["SCAMLGP_NUM_PROCESSES"])
    if process_id is None and "SCAMLGP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["SCAMLGP_PROCESS_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "process count and this process's id (arguments "
                         "or SCAMLGP_* variables)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _rank_world():
    """(this process's rank, the process count); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mesh(task: Optional[int] = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """(study, task) mesh over the slots of every process of the group.

    Rows are process-major: the ``study`` axis spans processes and the
    ``task`` axis stays inside one, the layout the JAX package prescribes
    (studies never communicate, so only the cheap axis crosses processes).
    Without a process group the mesh is this process's.

    Args:
        task: slots per task group inside a process; must divide the local
            slot count.  Default 1 (every slot one study row).
        devices: this process's slots; every CUDA device by default (a
            ``RuntimeError`` where there is none).
    """
    local = [torch.device(d) for d in (devices if devices is not None
                                       else cuda_devices())]
    rank, world = _rank_world()
    everyone = [None] * world
    if world > 1:
        dist.all_gather_object(everyone, [str(d) for d in local])
    else:
        everyone = [[str(d) for d in local]]
    if len({len(slots) for slots in everyone}) != 1:
        raise ValueError(f"uneven slots per process: "
                         f"{[len(s) for s in everyone]}")
    task = 1 if task is None else int(task)
    if len(local) % task != 0:
        raise ValueError(f"task={task} does not divide the per-process "
                         f"slot count {len(local)}")
    rows = len(local) // task
    flat = [d for slots in everyone for d in slots]
    return Mesh(device_grid(flat, (world * rows, task)),
                ranks=np.repeat(np.arange(world), rows), rank=rank,
                group=dist.group.WORLD if dist.is_initialized() else None)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(sub, it) for sub in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, it) for sub in tree)
    return next(it)


def broadcast_from_host0(tree):
    """Replicate process 0's tree (dicts, lists, tuples, NamedTuples) of
    tensors on every process, each leaf on its own device and dtype.

    Campaign inputs built from host RNGs (unseeded target tasks, reference
    ``base.py:119-133`` semantics) differ per process; every process must
    hold the same values.  Every process passes a tree of the same
    structure and shapes; the leaves travel as CPU tensors."""
    _, world = _rank_world()
    if world == 1:
        return tree
    out = []
    for leaf in _leaves(tree):
        host = leaf.detach().to("cpu", copy=True).contiguous()
        dist.broadcast(host, src=0)
        out.append(host.to(leaf.device))
    return _rebuild(tree, iter(out))


def local_study_rows(arr, mesh: Mesh) -> tuple:
    """(global indices, rows as numpy): this process's studies of a tensor
    whose leading axis is the study axis of ``mesh`` (a ``run_campaign``
    result on that mesh), in order.

    The multi-process analogue of the reference's per-worker result JSONs
    (``local_runner.py:188-201``): each process persists only the studies
    it holds; merging happens at analysis time."""
    idx = mesh.local_studies(arr.shape[0])
    rows = arr[torch.as_tensor(idx, dtype=torch.long, device=arr.device)]
    return np.asarray(idx, np.int64), rows.detach().cpu().numpy()


def allgather(tree):
    """Every process's tree (of tensors or arrays, the same structure on
    each), the leaves concatenated along their leading axis in rank order,
    as numpy on every process: for small results only."""
    leaves = [np.asarray(leaf.detach().cpu() if torch.is_tensor(leaf)
                         else leaf) for leaf in _leaves(tree)]
    _, world = _rank_world()
    if world == 1:
        return _rebuild(tree, iter(leaves))
    everyone = [None] * world
    dist.all_gather_object(everyone, leaves)
    joined = [np.concatenate([parts[j] for parts in everyone])
              for j in range(len(leaves))]
    return _rebuild(tree, iter(joined))
