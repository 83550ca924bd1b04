"""Carry parameters and state across between the JAX package and the port.

The JAX package's structures (``GPParams``, ``TargetParams``, ``TaskData``,
``SourceStack``, ``ScaMLGP``) arrive as dicts of numpy arrays keyed by their NamedTuple
field names, nested for nested structures; the functions here build the
port's structures of the same names from them, so that both packages
compute the same thing.  ``to_numpy_dict`` goes the other way for any
NamedTuple of arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.models import scamlgp as m


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def gp_params(d: dict, dtype=torch.float64, device=None) -> gp.GPParams:
    device = resolve_device(device)
    return gp.GPParams(*[_t(d[f], dtype, device) for f in gp.GPParams._fields])


def target_params(d: dict, dtype=torch.float64, device=None) -> m.TargetParams:
    return m.TargetParams(
        raw_weights=_t(d["raw_weights"], dtype, resolve_device(device)),
        gp=gp_params(d["gp"], dtype, device))


def task_data(d: dict, dtype=torch.float64, device=None) -> m.TaskData:
    device = resolve_device(device)
    return m.TaskData(*[_t(d[f], dtype, device) for f in m.TaskData._fields])


def source_stack(d: dict, dtype=torch.float64, device=None) -> m.SourceStack:
    dev = resolve_device(device)
    return m.SourceStack(data=task_data(d["data"], dtype, dev),
                         params=gp_params(d["params"], dtype, dev),
                         chol=_t(d["chol"], dtype, dev),
                         alpha=_t(d["alpha"], dtype, dev))


def scamlgp_model(d: dict, dtype=torch.float64, device=None) -> m.ScaMLGP:
    """A target model (``models.scamlgp.ScaMLGP``) from its fields."""
    dev = resolve_device(device)
    arrays = {f: _t(d[f], dtype, dev) for f in m.ScaMLGP._fields
              if f not in ("source", "params")}
    return m.ScaMLGP(source=source_stack(d["source"], dtype, dev),
                     params=target_params(d["params"], dtype, dev), **arrays)


def to_numpy_dict(tree) -> dict:
    """A NamedTuple of arrays or tensors (nested) as nested dicts of numpy
    arrays keyed by field name."""
    out = {}
    for name, value in zip(tree._fields, tree):
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            out[name] = to_numpy_dict(value)
        elif isinstance(value, torch.Tensor):
            out[name] = value.detach().cpu().numpy()
        else:
            out[name] = np.asarray(value)
    return out
