"""The (study, task) mesh of the port (``scamlgp_tpu/parallel/mesh.py``).

The JAX package lays two array axes over a ``jax.sharding.Mesh``:

- ``task``: meta-tasks, whose independent source-GP fits are split over the
  slots of one process;
- ``study``: lock-step BO studies, which never communicate and may span
  processes.

Here a mesh is a (study, task) grid of ``torch.device`` slots, each study
row owned by one process (``ranks``), with the process group that carries
the study axis's host data (``parallel/distributed.py``), or none in one
process.  A slot list may repeat a device: ``["cuda:0"] * 4`` lays four
slots over one card and ``["cpu"] * 8`` is the counterpart of the JAX
tests' eight virtual CPU devices.  Slots on one device run one after
another.

A process runs the work of its own slots only.  ``split_rows`` hands each
slot its share of a leading axis on its device, ``cat_rows`` joins the
shares again.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import fit as fit_lib

AXIS_NAMES = ("study", "task")


class Mesh:
    """A (study, task) grid of device slots.

    Args:
        devices: (study, task) array of ``torch.device``: every slot of the
            mesh, those of other processes included.
        ranks: (study,) the process that owns each study row; all 0 in one
            process.
        rank: this process's rank.
        group: the ``torch.distributed`` process group of the study axis, or
            None in one process.
    """

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray, ranks: Optional[Sequence] = None,
                 rank: int = 0, group=None):
        self.devices = devices
        self.ranks = (np.zeros(devices.shape[0], np.int64) if ranks is None
                      else np.asarray(ranks, np.int64))
        self.rank = rank
        self.group = group

    @property
    def shape(self) -> dict:
        return dict(zip(AXIS_NAMES, self.devices.shape))

    @property
    def num_processes(self) -> int:
        return int(self.ranks.max()) + 1

    def local_rows(self) -> list:
        """The study rows that this process owns, in order."""
        return [int(r) for r in np.flatnonzero(self.ranks == self.rank)]

    def task_devices(self, row: Optional[int] = None) -> list:
        """The task slots of a study row: this process's first by default."""
        return list(self.devices[self.local_rows()[0] if row is None
                                 else row])

    def study_slices(self, n: int) -> list:
        """(row, start, stop) of each study row over ``n`` studies padded to
        a multiple of the study axis (``pad_to_multiple``): row r holds
        studies r*k to (r+1)*k - 1, k = the padded n / the study extent."""
        k = pad_to_multiple(n, self.shape["study"]) // self.shape["study"]
        return [(r, r * k, (r + 1) * k) for r in range(self.shape["study"])]

    def local_studies(self, n: int) -> list:
        """The studies, out of ``n``, that this process's rows hold (the
        padding left out)."""
        mine = set(self.local_rows())
        return [s for r, a, b in self.study_slices(n) if r in mine
                for s in range(a, min(b, n))]


def device_grid(devices: Sequence, shape) -> np.ndarray:
    """``devices`` as an object array of ``torch.device`` of ``shape``."""
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return arr.reshape(shape)


def cuda_devices() -> list:
    """Every CUDA device; raises where there is none (``resolve_device``)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_slots(device, n: int, rank: int = 0) -> list:
    """``n`` slots of one process: for ``cuda`` without an index and several
    cards, cards ``rank * n`` onwards in turn; otherwise ``device`` (``cuda``
    when left out) repeated."""
    device = resolve_device(device)
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda" and device.index is None and count > 1:
        return [torch.device("cuda", (rank * n + j) % count)
                for j in range(n)]
    return [device] * n


def make_mesh(study: int = 1, task: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a one-process (study, task) mesh.

    Args:
        study: slots along the study axis.
        task: slots along the task axis; defaults to n_slots // study.
        devices: the slots, row-major; every CUDA device by default (a
            ``RuntimeError`` where there is none: the CPU is taken only when
            named).
    """
    devices = list(devices if devices is not None else cuda_devices())
    n = len(devices)
    if task is None:
        if n % study != 0:
            raise ValueError(f"{n} devices not divisible by study={study}")
        task = n // study
    if study * task != n:
        raise ValueError(f"mesh {study}x{task} != {n} devices")
    return Mesh(device_grid(devices, (study, task)))


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def split_rows(tree, devices: Sequence) -> list:
    """Split the leading axis of every leaf of a NamedTuple tree (or of one
    tensor) into ``len(devices)`` equal parts, part j on ``devices[j]``."""
    n = len(devices)
    size = fit_lib.tree_leaves(tree)[0].shape[0]
    if size % n:
        raise ValueError(f"leading axis {size} does not split over {n} slots")
    k = size // n
    return [fit_lib.tree_map(lambda leaf: leaf[j * k:(j + 1) * k].to(dev),
                             tree) for j, dev in enumerate(devices)]


def cat_rows(parts: Sequence, device) -> object:
    """Join ``split_rows``' parts on ``device``, in slot order."""
    return fit_lib.tree_map(
        lambda *leaves: torch.cat([leaf.to(device) for leaf in leaves]),
        *parts)
