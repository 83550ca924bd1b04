"""Checkpoint / resume for campaigns and the sequential driver
(``scamlgp_tpu/utils/checkpoint.py``).

A tree of tensors (NamedTuples, dicts, tuples and lists of them, ``None``
where a field is empty) serializes to ONE ``<path>.npz``: its leaves, saved
on the host as ``leaf_<i>``, and its structure, as JSON under
``structure``.  Leaves and structure thus always come from the same write.
A load checks the saved structure, and every leaf's shape and dtype,
against a template, and puts each leaf on its template leaf's device.

Writes are atomic and durable: the data goes to a temp file with a unique
name in the target's directory, is flushed and ``fsync``-ed, and only then
renamed over the target (and the directory is synced), so neither a killed
process, a crash of the machine nor a second writer of the same path leaves
a truncated or mixed file behind.

``save_optimizer_state`` / ``load_optimizer_state`` persist a
``ScaMLGPBO``: its observations, counters and generator state, its source
stack and its target parameters.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Callable, List

import numpy as np
import torch

from scamlgp_tpu_torch.models import fit as fit_lib

STRUCTURE = "structure"


def _flatten(tree, leaves: list):
    """The JSON-able structure of ``tree``; appends its leaves to ``leaves``
    in order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "tensor"
    if tree is None:
        return None
    if fit_lib._is_node(tree):
        return {"namedtuple": type(tree).__name__,
                "fields": list(tree._fields),
                "children": [_flatten(c, leaves) for c in tree]}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"dict": keys,
                "children": [_flatten(tree[k], leaves) for k in keys]}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_flatten(c, leaves) for c in tree]}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}: leaves "
                    "must be tensors")


def _unflatten(template, leaves: Callable):
    """``template``'s structure with each tensor leaf replaced by
    ``leaves(template_leaf)``."""
    if isinstance(template, torch.Tensor):
        return leaves(template)
    if template is None:
        return None
    if fit_lib._is_node(template):
        return type(template)(*[_unflatten(c, leaves) for c in template])
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return type(template)(_unflatten(c, leaves) for c in template)


def write_atomic(final, write: Callable) -> None:
    """Call ``write(file)`` on a temp file beside ``final``, make it durable,
    then rename it to ``final``."""
    final = Path(final)
    final.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=final.parent, prefix=final.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, final)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise
    dfd = os.open(final.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def exists(path) -> bool:
    """Whether a checkpoint was written at ``path``."""
    return os.path.exists(str(path) + ".npz")


def save_pytree(path, tree: Any) -> None:
    """Write ``tree`` to ``<path>.npz``, atomically."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    arrays[STRUCTURE] = np.asarray(json.dumps(structure))
    write_atomic(str(path) + ".npz", lambda fh: np.savez(fh, **arrays))


def _load(path):
    with np.load(str(path) + ".npz", allow_pickle=False) as data:
        n = len(data.files) - 1
        return (json.loads(str(data[STRUCTURE])),
                [data[f"leaf_{i}"] for i in range(n)])


def load_leaves(path) -> List[np.ndarray]:
    """The flat leaves of the checkpoint at ``path``, in save order."""
    return _load(path)[1]


def load_pytree_like(path, template: Any) -> Any:
    """Restore a tree saved with ``template``'s structure.  Every leaf must
    have its template leaf's shape and dtype (a mismatch means the
    checkpoint was written with other settings: studies, evaluations,
    tasks or dtype) and lands on that leaf's device."""
    structure, leaves = _load(path)
    t_leaves: list = []
    if _flatten(template, t_leaves) != structure:
        raise ValueError(f"Checkpoint at {path} holds another structure than "
                         "the template")
    for i, (a, t) in enumerate(zip(leaves, t_leaves)):
        dtype = torch.from_numpy(a.reshape(-1)[:0]).dtype
        if tuple(a.shape) != tuple(t.shape) or dtype != t.dtype:
            raise ValueError(
                f"Checkpoint at {path} was saved with different settings: "
                f"leaf {i} has shape {a.shape} dtype {dtype}, expected shape "
                f"{tuple(t.shape)} dtype {t.dtype} (check studies, "
                "evaluations, tasks and dtype)")
    it = iter(leaves)
    return _unflatten(template,
                      lambda t: torch.as_tensor(next(it)).to(t.device))


def save_optimizer_state(path, optimizer) -> None:
    """Persist a ``ScaMLGPBO``'s resumable state into directory ``path``:
    ``driver.json`` (observations, counters, generator state) beside
    ``source_stack.npz`` and ``target_params.npz``."""
    path = Path(path)
    meta = {
        "X": [np.asarray(x).tolist() for x in optimizer.X],
        "losses": [None if not np.isfinite(v) else float(v)
                   for v in optimizer.losses],
        "num_generated": optimizer._num_generated,
        "pending": optimizer._pending,
        "generator": optimizer._generator.get_state().tolist(),
    }
    save_pytree(path / "source_stack", optimizer.source_gps)
    save_pytree(path / "target_params", optimizer.model.params)
    write_atomic(path / "driver.json",
                 lambda fh: fh.write(json.dumps(meta).encode()))


def load_optimizer_state(path, optimizer) -> None:
    """Restore the state saved by ``save_optimizer_state`` into a freshly
    constructed optimizer (same search space and meta-data shapes).  The
    model is rebuilt on the data in ``report``'s canonical order, so the
    resumed driver proposes what the saved one would have."""
    path = Path(path)
    with open(path / "driver.json") as fh:
        meta = json.load(fh)
    optimizer.X = [np.asarray(x, dtype=np.float64) for x in meta["X"]]
    optimizer.losses = [np.nan if v is None else float(v)
                        for v in meta["losses"]]
    optimizer._num_generated = meta["num_generated"]
    optimizer._pending = meta["pending"]
    optimizer._generator.set_state(
        torch.tensor(meta["generator"], dtype=torch.uint8))
    optimizer.source_gps = load_pytree_like(path / "source_stack",
                                            optimizer.source_gps)
    params = load_pytree_like(path / "target_params", optimizer.model.params)
    order = sorted(range(len(optimizer.X)),
                   key=lambda i: (optimizer.X[i].tobytes(),
                                  optimizer.losses[i]))
    X = (np.stack([optimizer.X[i] for i in order]) if optimizer.X
         else np.zeros((0, optimizer._n_features)))
    y = np.asarray([optimizer.losses[i] for i in order])
    keep = np.isfinite(y)
    optimizer.model = optimizer._build_model(X[keep], y[keep], params=params)
