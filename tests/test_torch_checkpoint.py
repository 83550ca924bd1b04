"""The port's checkpoints (``scamlgp_tpu_torch/utils/checkpoint.py``), on
the CPU: trees of tensors round-trip through one ``.npz`` with their
structure, writes are atomic (a unique temp name, ``fsync`` before the
rename), loads refuse a checkpoint of other settings, and a resumed
``ScaMLGPBO`` proposes the same next configuration as the one that was
saved (the contract of ``tests/test_aux.py``'s driver test).
"""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from scamlgp_tpu_torch import testing as conformance
from scamlgp_tpu_torch.bo import ScaMLGPBO
from scamlgp_tpu_torch.bo.core import Objective
from scamlgp_tpu_torch.bo.space import ContinuousParameter, ParameterSpace
from scamlgp_tpu_torch.utils import checkpoint as ckpt
from tests.torch_threads import one_thread  # noqa: F401

FAST = dict(num_restarts_log_likelihood=1, num_fit_steps=20,
            af_optimizer_kwargs={"raw_samples": 64, "num_restarts": 2,
                                 "num_steps": 10},
            device="cpu")


class Inner(NamedTuple):
    a: torch.Tensor
    b: object


class Outer(NamedTuple):
    inner: Inner
    table: dict
    items: tuple


def tree(scale=1.0):
    return Outer(
        inner=Inner(a=torch.arange(6, dtype=torch.float64).reshape(2, 3)
                    * scale, b=None),
        table={"z": torch.full((4,), 2.5 * scale, dtype=torch.float32),
               "k": torch.tensor(7, dtype=torch.int64)},
        items=(torch.tensor([1, 2, 255], dtype=torch.uint8),
               [torch.tensor(scale, dtype=torch.float64)]))


def assert_trees_equal(a, b):
    la, lb = [], []
    assert ckpt._flatten(a, la) == ckpt._flatten(b, lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_round_trip_in_one_file(tmp_path):
    ckpt.save_pytree(tmp_path / "ck", tree())
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert ckpt.exists(tmp_path / "ck") and not ckpt.exists(tmp_path / "x")
    out = ckpt.load_pytree_like(tmp_path / "ck", tree(0.0))
    assert isinstance(out, Outer) and isinstance(out.inner, Inner)
    assert out.inner.b is None and isinstance(out.items[1], list)
    assert_trees_equal(out, tree())
    # leaves in save order: NamedTuple fields, then dict keys sorted
    leaves = ckpt.load_leaves(tmp_path / "ck")
    assert [leaf.dtype for leaf in leaves] == [
        np.float64, np.int64, np.float32, np.uint8, np.float64]


def test_overwrite_in_place(tmp_path):
    ckpt.save_pytree(tmp_path / "ck", tree())
    ckpt.save_pytree(tmp_path / "ck", tree(2.0))
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert_trees_equal(ckpt.load_pytree_like(tmp_path / "ck", tree()),
                       tree(2.0))


def test_stale_temp_files_do_not_matter(tmp_path):
    """Temp files of an earlier writer that died (any name, truncated
    contents) neither block a save nor reach the loaded checkpoint."""
    stale = ["ck.npz.tmp", "ck.tmp.npz", "ck.npz.1234.tmp"]
    for name in stale:
        (tmp_path / name).write_bytes(b"PK\x03\x04 truncated")
    ckpt.save_pytree(tmp_path / "ck", tree(3.0))
    assert_trees_equal(ckpt.load_pytree_like(tmp_path / "ck", tree()),
                       tree(3.0))
    assert sorted(os.listdir(tmp_path)) == sorted(stale + ["ck.npz"])


def test_a_failed_write_leaves_the_checkpoint_as_it_was(tmp_path):
    ckpt.save_pytree(tmp_path / "ck", tree())

    def broken(fh):
        fh.write(b"partial")
        raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        ckpt.write_atomic(tmp_path / "ck.npz", broken)
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert_trees_equal(ckpt.load_pytree_like(tmp_path / "ck", tree()),
                       tree())


@pytest.mark.parametrize("template,match", [
    (tree()._replace(items=(torch.zeros(4, dtype=torch.uint8),
                            [torch.tensor(1.0, dtype=torch.float64)])),
     "different settings"),
    (tree()._replace(table={"z": torch.zeros(4),
                            "k": torch.tensor(7.0)}), "different settings"),
    (tree()._replace(table={"z": torch.zeros(4)}), "another structure"),
    (Inner(a=torch.zeros(2, 3, dtype=torch.float64), b=None),
     "another structure"),
])
def test_load_refuses_other_settings(tmp_path, template, match):
    ckpt.save_pytree(tmp_path / "ck", tree())
    with pytest.raises(ValueError, match=match):
        ckpt.load_pytree_like(tmp_path / "ck", template)


def test_resumed_driver_proposes_the_same_configuration(tmp_path, seed):
    def space():
        s = ParameterSpace()
        s.add(ContinuousParameter("x0", (0.5, 3)))
        s.seed(seed)
        return s

    meta = conformance.META_DATA_1D
    opt = ScaMLGPBO(space(), Objective("loss", False), meta, seed=seed,
                    **FAST)
    for _ in range(3):
        es = opt.generate_evaluation_specification()
        opt.report(es.create_evaluation(objectives={
            "loss": conformance._run_experiment_1d_deterministic(
                es.configuration["x0"])}))
    ckpt.save_optimizer_state(tmp_path / "opt", opt)
    assert sorted(os.listdir(tmp_path / "opt")) == [
        "driver.json", "source_stack.npz", "target_params.npz"]

    opt2 = ScaMLGPBO(space(), Objective("loss", False), meta, seed=seed + 1,
                     **FAST)
    ckpt.load_optimizer_state(tmp_path / "opt", opt2)
    assert len(opt2.X) == 3 and opt2._num_generated == 3
    np.testing.assert_array_equal(np.stack(opt2.X), np.stack(opt.X))
    np.testing.assert_array_equal(opt2.losses, opt.losses)
    assert torch.equal(opt2._generator.get_state(), opt._generator.get_state())
    es_a = opt.generate_evaluation_specification()
    es_b = opt2.generate_evaluation_specification()
    assert es_a.configuration == es_b.configuration
