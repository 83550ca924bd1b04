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
tests' eight virtual CPU devices.

A process runs the work of its own slots only (``run_slots``): one after
another in the caller's thread by default, or, on a mesh made with
``at_once=True``, all at once, each slot a host thread and, on a card, a
CUDA stream of its own, also where slots share a device.  Both orders give
the same bits.  On H100s the slots at once took about three times as long
as in turn (PERF.md, section 6): the threads hand the interpreter lock
over at every operator.  ``split_rows`` hands each slot its share of a
leading axis on its device, ``cat_rows`` joins the shares again.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

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
        at_once: run this process's slots at once (``run_slots``); one
            after another by default.
    """

    axis_names = AXIS_NAMES

    def __init__(self, devices: np.ndarray, ranks: Optional[Sequence] = None,
                 rank: int = 0, group=None, at_once: bool = False):
        self.devices = devices
        self.ranks = (np.zeros(devices.shape[0], np.int64) if ranks is None
                      else np.asarray(ranks, np.int64))
        self.rank = rank
        self.group = group
        self.at_once = at_once

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
              devices: Optional[Sequence] = None,
              at_once: bool = False) -> Mesh:
    """Build a one-process (study, task) mesh.

    Args:
        study: slots along the study axis.
        task: slots along the task axis; defaults to n_slots // study.
        devices: the slots, row-major; every CUDA device by default (a
            ``RuntimeError`` where there is none: the CPU is taken only when
            named).
        at_once: run the slots at once (``Mesh``).
    """
    devices = list(devices if devices is not None else cuda_devices())
    n = len(devices)
    if task is None:
        if n % study != 0:
            raise ValueError(f"{n} devices not divisible by study={study}")
        task = n // study
    if study * task != n:
        raise ValueError(f"mesh {study}x{task} != {n} devices")
    return Mesh(device_grid(devices, (study, task)), at_once=at_once)


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


#: (device, slot) -> the slot's CUDA stream, kept from call to call: the
#: caching allocator pools blocks by stream, so a slot reuses what it freed
_STREAMS: dict = {}
#: whether this process has loaded PyTorch's CUDA linear algebra
_LINALG_LOADED = False
_LOCK = threading.Lock()


def _load_cuda_linalg(device: torch.device) -> None:
    """Load PyTorch's CUDA linear algebra in the caller's thread.  PyTorch
    loads it at the first CUDA linear algebra call, and two threads making
    that call at once fail ("lazy wrapper should be called at most once";
    slots on four H100s met it)."""
    global _LINALG_LOADED
    with _LOCK:
        if not _LINALG_LOADED:
            torch.linalg.cholesky_ex(torch.ones(1, 1, device=device))
            _LINALG_LOADED = True


def _slot_stream(device: torch.device, j: int) -> "torch.cuda.Stream":
    with _LOCK:
        key = (device.index if device.index is not None
               else torch.cuda.current_device(), j)
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(torch.device("cuda", key[0]))
        return _STREAMS[key]



def run_slots(fn: Callable, devices: Sequence, at_once: bool = True) -> list:
    """``fn(j)`` for every slot j of ``devices``; returns the results in slot
    order.

    In turn (``at_once=False``, or one slot): in the caller's thread, each
    slot under ``torch.cuda.device`` of its card, on the caller's streams.
    At once: one host thread a slot.  On a CUDA slot the thread runs under
    ``torch.cuda.device`` on the slot's own stream, which first waits on
    the caller's current stream of that device (where the caller made the
    inputs); before this returns the caller's stream waits on every slot's
    stream, and every tensor of a result is recorded as used by the
    caller's stream (``record_stream``), so the caching allocator does not
    hand its memory to the slot's next work before the caller's work on it
    is done.  A slot returns tensors on its own device; the caller keeps
    its inputs alive until this returns.  Each thread takes the caller's
    grad mode.  An exception in a slot is raised here, once every thread
    has ended; the first slot's in slot order.

    Overlap: PyTorch releases the interpreter lock inside each operator and
    while a host read waits on the device, so the threads overlap the
    device's work and the operators' C++ dispatch, not Python.  Where the
    work is mostly Python dispatch of small operators, as in the
    campaign's L-BFGS fits, the threads hand the lock over at every
    operator and take longer than the slots in turn (PERF.md, section 6).
    """
    devices = [torch.device(d) for d in devices]
    if not at_once or len(devices) == 1:
        out = []
        for j, dev in enumerate(devices):
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                out.append(fn(j))
        return out
    streams = [_slot_stream(dev, j) if dev.type == "cuda" else None
               for j, dev in enumerate(devices)]
    cuda = [dev for dev in devices if dev.type == "cuda"]
    if cuda:
        _load_cuda_linalg(cuda[0])
    for dev, stream in zip(devices, streams):
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
    grad = torch.is_grad_enabled()
    results = [None] * len(devices)
    errors = [None] * len(devices)

    def slot(j):
        try:
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(torch.set_grad_enabled(grad))
                if streams[j] is not None:
                    ctx.enter_context(torch.cuda.device(devices[j]))
                    ctx.enter_context(torch.cuda.stream(streams[j]))
                results[j] = fn(j)
        except BaseException as err:  # handed to the caller below
            errors[j] = err

    threads = [threading.Thread(target=slot, args=(j,),
                                name=f"slot-{j}-{dev}")
               for j, dev in enumerate(devices)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for dev, stream in zip(devices, streams):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    for err in errors:
        if err is not None:
            raise err
    for t in fit_lib.tree_leaves(results):
        if torch.is_tensor(t) and t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
    return results
