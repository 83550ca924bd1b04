"""The port's mesh (``parallel/mesh.py``) and ``pad_task_data`` against the
JAX package: the shapes and errors of ``tests/test_parallel.py``'s mesh
test on eight ``cpu`` slots, the refusal to take the CPU unasked, and the
padding of the task axis, equal to the JAX function's on the same numpy
inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scamlgp_tpu.models import scamlgp as jm
from scamlgp_tpu.parallel import scamlgp_sharded as jsh
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.parallel import mesh as tmesh
from scamlgp_tpu_torch.parallel import scamlgp_sharded as tsh
from tests.torch_threads import one_thread  # noqa: F401

CPU8 = ["cpu"] * 8


def test_mesh_construction():
    mesh = tmesh.make_mesh(study=2, task=4, devices=CPU8)
    assert mesh.shape == {"study": 2, "task": 4}
    assert mesh.axis_names == ("study", "task")
    assert mesh.local_rows() == [0, 1] and mesh.num_processes == 1
    assert all(d == torch.device("cpu") for d in mesh.task_devices(1))
    mesh1 = tmesh.make_mesh(study=1, devices=CPU8)
    assert mesh1.shape["task"] == 8
    with pytest.raises(ValueError):
        tmesh.make_mesh(study=3, devices=CPU8)
    with pytest.raises(ValueError):
        tmesh.make_mesh(study=3, task=2, devices=CPU8)


def test_mesh_takes_no_cpu_unasked():
    """Without a CUDA device a mesh over every CUDA device is refused, and
    a slot list of ``cuda`` is not turned into the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.local_slots(None, 2)
    assert tmesh.local_slots("cpu", 3) == [torch.device("cpu")] * 3


@pytest.mark.parametrize("n,k,padded", [(6, 4, 8), (8, 4, 8), (1, 3, 3),
                                        (0, 2, 0)])
def test_pad_to_multiple(n, k, padded):
    assert tmesh.pad_to_multiple(n, k) == padded


def test_study_slices_pad_the_last_rows():
    """Six studies over four study rows: two a row, padded to eight; the
    last row holds padding only."""
    mesh = tmesh.make_mesh(study=4, devices=["cpu"] * 4)
    assert mesh.study_slices(6) == [(0, 0, 2), (1, 2, 4), (2, 4, 6),
                                    (3, 6, 8)]
    assert mesh.local_studies(6) == list(range(6))
    other = tmesh.Mesh(mesh.devices, ranks=[0, 0, 1, 1], rank=1)
    assert other.local_rows() == [2, 3] and other.local_studies(6) == [4, 5]


@pytest.mark.parametrize("multiple", [4, 3])
def test_pad_task_data_matches_jax(multiple):
    """Padded dummy tasks (X, y, mask, mean 0, std 1) exactly as the JAX
    function pads them; a task count that divides is left as it is."""
    rng = np.random.default_rng(4)
    xs = [rng.uniform(size=(n, 2)) for n in (5, 7, 3, 6, 4, 7)]
    ys = [rng.normal(size=len(x)) for x in xs]
    jdata = jm.pack_task_data(xs, ys, dtype=jnp.float64)
    tdata = tm.TaskData(*[torch.as_tensor(np.array(leaf))
                          for leaf in jdata])
    jpad = jsh.pad_task_data(jdata, multiple)
    tpad = tsh.pad_task_data(tdata, multiple)
    assert tpad.X.shape[0] == tmesh.pad_to_multiple(6, multiple)
    for a, b in zip(tpad, jpad):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_split_and_cat_rows_round_trip():
    data = tm.TaskData(*[torch.arange(8.0 * k).reshape((8,) + (k,) * (k > 1))
                         for k in (1, 2, 3, 1, 1)])
    parts = tmesh.split_rows(data, ["cpu"] * 4)
    assert len(parts) == 4 and parts[1].y.shape == (2, 2)
    back = tmesh.cat_rows(parts, "cpu")
    for a, b in zip(back, data):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tmesh.split_rows(data, ["cpu"] * 3)


def test_local_runner_meshes_several_cards(monkeypatch):
    """``local_runner``'s campaign route lays no study mesh, also where
    there are several cards: a mesh's rows run one after another, slower
    than one batched campaign, so every study stays in one batch on one
    device (the card count patched; the campaign is stopped before it
    touches a card)."""
    from scamlgp_tpu_torch.benchmarking import local_runner as lr

    class Stop(Exception):
        pass

    seen = {}

    def run_campaign(*args, **kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(lr, "campaign_inputs_from_benchmark",
                        lambda *args, **kwargs: (None, {}, None, None))
    monkeypatch.setattr(lr, "run_campaign", run_campaign)
    for device in (None, "cuda"):
        seen.clear()
        with pytest.raises(Stop):
            lr._submit_via_campaign({"device": device}, object,
                                    {"n_data_per_task": [4, 4]}, None, 2, 3,
                                    print)
        assert seen["device"] == device and seen.get("mesh") is None
