"""Experiment configuration dataclass and its SHA-256 fingerprint
(``scamlgp_tpu/benchmarking/experiment_config_utils.py``, the reference's
``experiment_config_utils.py:13-115``).

The hash keys the results directory, so a changed configuration starts a
new one; the ``compute`` field and machine-specific data paths are left out
of the fingerprint.

Hashes equal the JAX package's.  ``parse_experiment_config`` writes a class
or an object as its dotted ``module.Class`` name, and the port's modules
mirror the JAX package's module for module: a name under
``scamlgp_tpu_torch.`` is written under ``scamlgp_tpu.`` (``REFERENCE_PACKAGE``),
so the same experiment has the same parsed configuration, the same hash and
the same results directory in both packages.  A configuration never carries
a device: the device is an argument of the runner (``local_runner.main``),
so it cannot move a hash.
"""

from __future__ import annotations

import hashlib
import importlib
import json
from copy import deepcopy
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Type, Union

#: the package whose dotted names the parsed configurations use
REFERENCE_PACKAGE = "scamlgp_tpu"
PORT_PACKAGE = "scamlgp_tpu_torch"


@dataclass
class Experiment:
    optimizer: Union[dict, Type]
    benchmark: Union[dict, Type]
    n_evaluations: int
    n_studies: int
    compute: str

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Experiment):
            return False
        return hash_experiment_config(self) == hash_experiment_config(other)


def qualified_name(module: str, name: str) -> str:
    """``module.name`` with the port's package written as the reference
    package's."""
    if module == PORT_PACKAGE or module.startswith(PORT_PACKAGE + "."):
        module = REFERENCE_PACKAGE + module[len(PORT_PACKAGE):]
    return f"{module}.{name}"


def _parse_simple_type(value: Any) -> Union[str, int, float]:
    """Closest simple-type representation: numbers cast, classes and objects
    as dotted ``module.Class`` names (reference ``:28-46``)."""
    try:
        return int(value)
    except (ValueError, TypeError):
        try:
            return float(value)
        except (ValueError, TypeError):
            if str(value).startswith("<class"):
                return qualified_name(value.__module__, value.__name__)
            elif "object at" in str(value):
                return qualified_name(value.__class__.__module__,
                                      value.__class__.__name__)
            else:
                return str(value)


def parse_experiment_config(config):
    """Recursively normalize a config to simple types only."""
    if isinstance(config, dict):
        return {k: parse_experiment_config(v) for k, v in config.items()}
    elif isinstance(config, list):
        return [parse_experiment_config(v) for v in config]
    else:
        return _parse_simple_type(config)


def hash_experiment_config(config: Experiment, short: bool = False) -> str:
    """SHA-256 of the simple-type-normalized config, excluding ``compute`` and
    machine-specific data paths (reference ``:63-100``)."""
    config_dict = deepcopy(config.__dict__)
    config_dict.pop("compute")

    if (isinstance(config_dict["benchmark"], dict)
            and "kwargs" in config_dict["benchmark"]):
        config_dict["benchmark"]["kwargs"].pop("data_dir", None)
        if "target_task_file" in config_dict["benchmark"]["kwargs"]:
            config_dict["benchmark"]["kwargs"]["target_task_file"] = Path(
                config_dict["benchmark"]["kwargs"]["target_task_file"]).name
        if "meta_task_files" in config_dict["benchmark"]["kwargs"]:
            config_dict["benchmark"]["kwargs"]["meta_task_files"] = [
                Path(mtf).name
                for mtf in config_dict["benchmark"]["kwargs"]["meta_task_files"]
            ]

    parsed = parse_experiment_config(config_dict)
    config_hash = hashlib.sha256(json.dumps(parsed).encode()).hexdigest()
    return config_hash[:7] if short else config_hash


def get_experiments_config_from_module(module: str) -> Dict[str, Experiment]:
    """Load the global ``EXPERIMENTS`` dict from a module (reference
    ``:103-115``)."""
    _module = importlib.import_module(module)
    if not hasattr(_module, "EXPERIMENTS"):
        raise ValueError(
            f"Module {module} is missing the global variable EXPERIMENTS that "
            "contains all experiment configurations.")
    return _module.EXPERIMENTS
