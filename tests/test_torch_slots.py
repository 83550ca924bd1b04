"""Slots that run at once (``parallel.mesh.run_slots``) on the CPU, in
float64.

A mesh made with ``at_once`` runs each slot on a host thread of its own
(by default they run in turn in the caller's thread): held here are that
they overlap (each slot waits on a shared barrier, which times out if they
run in turn), that a slot's exception reaches the caller, that the kernel
wrappers' launch counters and first-use caches stay exact under threads,
and that slots at once give the bits of slots in turn: the task-sharded
meta-fit equals each slot's fit alone, and a (2, 1) and a (4, 1) mesh
campaign, host and device loop, equal the ``study_chunk`` run of the same
batch sizes.
"""

import contextlib
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import scamlgp as tm
from scamlgp_tpu_torch.ops import blocked_chol, cuda_build, gram, sweep
from scamlgp_tpu_torch.parallel import campaign as tc
from scamlgp_tpu_torch.parallel import scamlgp_sharded as tsh
from scamlgp_tpu_torch.parallel.mesh import make_mesh, run_slots, split_rows
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64
#: seconds a slot waits at a barrier for the others
BARRIER_S = 20
S = 4
CFG = dict(n_evaluations=2, fit_steps=12, acq_raw_samples=32, acq_topk=3,
           acq_steps=8)
KW = dict(seed=5, meta_fit_restarts=1, meta_fit_steps=8, device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_slots_run_at_once(n):
    """Every slot waits at one barrier of n: run in turn, the first would
    wait alone and break it.  Each slot has a thread of its own and the
    caller's grad mode."""
    barrier = threading.Barrier(n, timeout=BARRIER_S)

    def slot(j):
        barrier.wait()
        return j, threading.get_ident(), torch.is_grad_enabled()

    with torch.no_grad():
        out = run_slots(slot, ["cpu"] * n)
    assert [o[0] for o in out] == list(range(n))
    assert len({o[1] for o in out}) == n
    assert not any(o[2] for o in out)
    assert run_slots(lambda j: threading.get_ident(), ["cpu"]) == [
        threading.get_ident()]


def test_slots_in_turn_run_in_the_callers_thread():
    """``at_once=False``, a mesh's default: the slots one after another, in
    slot order, in the caller's thread."""
    order = []

    def slot(j):
        order.append(j)
        return threading.get_ident()

    out = run_slots(slot, ["cpu"] * 3, at_once=False)
    assert order == [0, 1, 2]
    assert out == [threading.get_ident()] * 3
    assert not make_mesh(study=2, devices=["cpu"] * 2).at_once
    assert make_mesh(study=2, devices=["cpu"] * 2, at_once=True).at_once


def test_a_slot_error_reaches_the_caller():
    """A slot's exception is raised in the caller once every slot has
    ended; the other slots run to their end."""
    done = []

    def slot(j):
        if j == 1:
            raise ValueError("slot 1 failed")
        time.sleep(0.05)
        done.append(j)

    with pytest.raises(ValueError, match="slot 1 failed"):
        run_slots(slot, ["cpu"] * 3)
    assert sorted(done) == [0, 2]


def _cuda_stand_in(n, itemsize=4):
    """What the wrappers read of a CUDA batch of (1, n, n) matrices, for
    their launch paths with the launch itself patched out."""
    return types.SimpleNamespace(
        ndim=3, shape=(1, n, n), device=torch.device("cuda"),
        dtype=torch.float32, is_contiguous=lambda: True,
        element_size=lambda: itemsize)


def test_launch_counters_stay_exact_under_threads(monkeypatch):
    """Twice as many slots as cores tick ``sweep_inverse``'s,
    ``blocked_chol_inverse``'s and ``rbf_gram``'s counters through the
    wrappers' own launch paths (the launches patched out), with the
    interpreter switching threads every microsecond: no tick is lost."""
    monkeypatch.setattr(sweep, "_launch", lambda A, variant: (A, A))
    monkeypatch.setattr(blocked_chol, "_launch", lambda A, variant: (A, A))
    monkeypatch.setattr(gram, "_kernel_fn",
                        lambda dtype, extra=(): (lambda *a: 0, None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    x = types.SimpleNamespace(dtype=torch.float32, device="cuda",
                              data_ptr=lambda: 0, shape=(4, 2))
    out = types.SimpleNamespace(data_ptr=lambda: 0, shape=(4, 4))
    n, reps = 2 * (os.cpu_count() or 1), 300
    counters = (sweep.sweep_inverse.launches,
                blocked_chol.blocked_chol_inverse.launches)
    before = [dict(c) for c in counters] + [gram.rbf_gram.launches]

    def slot(j):
        for _ in range(reps):
            sweep.sweep_inverse(_cuda_stand_in(32))
            blocked_chol.blocked_chol_inverse(_cuda_stand_in(256), "smem")
            gram.run(x, x, x, x, out)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run_slots(slot, ["cpu"] * n)
    finally:
        sys.setswitchinterval(interval)
        after = [dict(c) for c in counters] + [gram.rbf_gram.launches]
        for c, b in zip(counters, before):
            c.update(b)
        gram.rbf_gram.launches = before[-1]
    assert after[0]["select"] - before[0]["select"] == n * reps
    assert after[1]["smem"] - before[1]["smem"] == n * reps
    assert after[2] - before[2] == n * reps


def test_first_use_runs_once_per_key():
    """Eight slots ask at once for two entries of a ``once_per_key`` cache
    whose first use is slow: each entry is made once, and every slot gets
    that one."""
    made = []
    barrier = threading.Barrier(8, timeout=BARRIER_S)

    @cuda_build.once_per_key
    def build(key):
        made.append(key)
        time.sleep(0.05)
        return object()

    def slot(j):
        barrier.wait()
        return build(j % 2)

    out = run_slots(slot, ["cpu"] * 8)
    assert sorted(made) == [0, 1]
    assert all(o is out[j % 2] for j, o in enumerate(out))


@pytest.mark.parametrize("at_once", [True, False])
@pytest.mark.parametrize("mll_method", ["chol", "sweep"])
def test_meta_fit_sharded_equals_each_slot_alone(mll_method, at_once):
    """Eight tasks over four ``cpu`` slots fitted at once or in turn: each
    slot's rows equal ``meta_fit_task_stack`` on that slot's tasks and
    restarts alone, bit for bit."""
    rng = np.random.default_rng(7)
    xs = [rng.uniform(size=(6, 2)) for _ in range(8)]
    ys = [np.sin(3 * x[:, 0]) + 0.1 * rng.normal(size=6) for x in xs]
    data = tm.pack_task_data(xs, ys, dtype=F64)
    cfg = tgp.source_gp_config()
    devices = ["cpu"] * 4
    warm = tgp.init_params(cfg, 2, F64, batch_shape=(8,))
    draws = tgp.sample_params(cfg, torch.Generator().manual_seed(1), 2, F64,
                              batch_shape=(8, 2))
    init = tfit.stack_restarts(warm, draws, batch_ndim=1)
    sharded = tsh.meta_fit_sharded(data, cfg, None, make_mesh(
        study=1, devices=devices, at_once=at_once), num_steps=10,
        mll_method=mll_method, init_stack=init)
    for j, (local, init_j) in enumerate(zip(split_rows(data, devices),
                                            split_rows(init, devices))):
        alone = tm.meta_fit_task_stack(local, cfg, num_steps=10,
                                       mll_method=mll_method,
                                       init_stack=init_j)
        for x, y in zip(tfit.tree_leaves(alone),
                        tfit.tree_leaves(sharded)):
            assert torch.equal(x, y[2 * j:2 * j + 2])


@pytest.fixture(scope="module")
def campaign_inputs():
    return ta.campaign_inputs_from_benchmark(
        Branin, [6] * 2, range(S), noise_std=1.0, dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def chunked(campaign_inputs):
    """The host loop over study chunks of 2 and of 1: the batch sizes of a
    (2, 1) and a (4, 1) mesh's rows."""
    fn, tp, md, _ = campaign_inputs
    cfg = tc.CampaignConfig(mll_method="sweep", **CFG)
    return {rows: tc.run_campaign(fn, tp, md, cfg=cfg, study_chunk=S // rows,
                                  **KW) for rows in (2, 4)}


@pytest.mark.parametrize("loop", ["host", "device"])
@pytest.mark.parametrize("rows", [2, 4])
def test_mesh_rows_at_once_equal_chunks(campaign_inputs, chunked, rows, loop):
    """S=4 Branin studies (MAP, ``sweep``) over a (rows, 1) mesh of ``cpu``
    slots, the rows at once, equal the study-chunked run of the same batch
    sizes bit for bit, in the host and the device loop."""
    fn, tp, md, _ = campaign_inputs
    cfg = tc.CampaignConfig(mll_method="sweep", **CFG)
    res = tc.run_campaign(fn, tp, md, cfg=cfg, loop=loop, mesh=make_mesh(
        study=rows, devices=["cpu"] * rows, at_once=True), **KW)
    for f in ("X", "y", "y_clean", "mask"):
        assert torch.equal(getattr(res, f), getattr(chunked[rows], f)), f
    assert (res.mask == 1).all() and res.studies.tolist() == list(range(S))


def test_many_tasks_rows_on_the_cpu():
    """``many_tasks`` at a CPU size: its meta-data is the JAX script's
    ``build_meta`` (``scripts/run_many_tasks.py``) on the same seed (the
    points equal; the standardized outcomes to float32 rounding, the two
    packings standardizing in another order), and each row's four slots at
    once give the one-batch fit's objectives and each slot its tasks' fit
    alone."""
    import importlib.util
    from pathlib import Path

    import jax.numpy as jnp

    from scamlgp_tpu_torch import many_tasks

    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "run_many_tasks.py"
    spec = importlib.util.spec_from_file_location("run_many_tasks", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    ref = script.build_meta(6, 5)
    port = many_tasks.build_meta(6, 5, "cpu")
    assert port.X.dtype == torch.float32
    np.testing.assert_array_equal(port.X.numpy(), np.asarray(ref.X))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, jnp.float32),
                                   rtol=1e-6, atol=1e-6)
    out = many_tasks.main(["--tasks", "4", "6", "--points", "5",
                           "--restarts", "1", "--steps", "4", "--repeats",
                           "1", "--slots-at-once", "--device", "cpu"])
    assert out["ok"] and [r["M"] for r in out["rows"]] == [4, 6]
    assert all(r["slots"] == 4 and all(r["slots_equal_alone"])
               for r in out["rows"])
