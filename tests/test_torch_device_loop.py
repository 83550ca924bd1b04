"""The device loop of the port's lock-step campaign
(``run_campaign(loop="device")``, ``parallel/campaign.py``) on the CPU, in
float64.

The device loop's body reads nothing of a tensor on the host: its target
fit runs every L-BFGS line search to its cap of trips and every NUTS
transition to its cap of steps (``fixed_trips``), with the finished lanes
frozen by the same masks as the early-exit forms, so both forms give the
same bits.  Held here: the fixed-trip ``lbfgs_minimize`` and ``nuts``
against their early-exit forms on batches whose lanes finish at different
trips; the device loop against the host loop, bit for bit, for every
``fit_method`` on both MLL routes, and on a 2-row mesh; the options that
stay with the host loop; and a guard that makes every host read of a
tensor raise while the body runs.  The body against the JAX package is
held by the ``fixed_trips`` cases of ``tests/test_torch_fit.py`` and
``tests/test_torch_campaign.py``.
"""

import collections
import contextlib
import dataclasses
import math

import pytest
import torch

from scamlgp_tpu_torch.benchmarking import torch_adapters as ta
from scamlgp_tpu_torch.benchmarking.benchmarks import Branin
from scamlgp_tpu_torch.models import fit as tfit
from scamlgp_tpu_torch.models import gp as tgp
from scamlgp_tpu_torch.models import hmc as thmc
from scamlgp_tpu_torch.parallel import campaign as tc
from scamlgp_tpu_torch.parallel.mesh import make_mesh
from scamlgp_tpu_torch.utils import cuda_graph
from scamlgp_tpu_torch.utils.profiling import GLOBAL_TIMER, capturing
from tests.torch_threads import one_thread  # noqa: F401

F64 = torch.float64
S, E = 3, 3
#: fits cut to 12 L-BFGS steps; samplers of 2 chains x (6 warmup + 4
#: samples), 3 leapfrog steps or depth 3; ADVI 10 steps x 4 draws
CFG = dict(n_evaluations=E, fit_steps=12, acq_raw_samples=32, acq_topk=3,
           acq_steps=8, hmc_chains=2, hmc_warmup=6, hmc_samples=4,
           hmc_leapfrog=3, hmc_max_depth=3, mixture_samples=4, vi_steps=10,
           vi_mc=4)
KW = dict(seed=3, meta_fit_restarts=1, meta_fit_steps=8, device="cpu")
FIELDS = ("X", "y", "y_clean", "mask")


@pytest.fixture(scope="module")
def inputs():
    return ta.campaign_inputs_from_benchmark(
        Branin, [6] * 2, range(S), noise_std=1.0, dtype=F64, device="cpu")


def _counted(fn):
    """``fn`` with a count of its calls in ``.calls``."""
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)

    wrapped.calls = 0
    return wrapped


# ---------------------------------------------------------------------------
# (a) the fixed-trip forms against the early-exit forms
# ---------------------------------------------------------------------------

def test_fixed_trip_lbfgs_equals_early_exit():
    """A source GP's MAP objective from 6 restarts, 15 steps: the line
    searches end at different trips (fewer evaluations in all than the
    fixed form's 1 + 15 x 20 + 1, more than one a step), and both forms
    give the same iterates and values, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    X = torch.rand((10, 2), generator=gen, dtype=F64)
    y = torch.sin(3 * X[:, 0]) + X[:, 1] ** 2
    y = (y - y.mean()) / y.std()
    cfg = tgp.source_gp_config()
    stack = tfit.stack_restarts(
        tgp.init_params(cfg, 2, F64, "cpu"),
        tgp.sample_params(cfg, gen, 2, F64, batch_shape=(5,)))
    x0 = tfit.flatten(stack, 1)
    out, calls = {}, {}
    for fixed in (False, True):
        obj = _counted(lambda x: tgp.map_objective(
            cfg, tfit.unflatten(x, stack, 1), X, y))
        out[fixed] = tfit.lbfgs_minimize(obj, x0, 15, fixed_trips=fixed)
        calls[fixed] = obj.calls
    assert calls[True] == 1 + 15 * 20 + 1
    assert 15 + 2 < calls[False] < calls[True]
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_fixed_trip_nuts_equals_early_exit():
    """NUTS on Gaussians of scales 0.05 to 3 (one chain each, depth 5):
    the chains' trajectories end at different steps, and both forms give
    the same samples, acceptance and step sizes, bit for bit."""
    scales = torch.tensor([0.05, 0.3, 1.0, 3.0], dtype=F64)
    B, D, T, depth = 4, 3, 12, 5
    gen = torch.Generator().manual_seed(1)
    draws = thmc.nuts_draws(gen, (B,), T, D, depth, F64, "cpu")
    init = tgp.GPParams(*[torch.randn((B, k), generator=gen, dtype=F64)
                          for k in (1, 1, 1)])

    def log_prob(p):
        q = tfit.flatten(p, 1)
        return -0.5 * torch.sum((q / scales[:, None]) ** 2, dim=-1)

    out, calls = {}, {}
    for fixed in (False, True):
        lp = _counted(log_prob)
        out[fixed] = thmc.nuts(lp, init, draws, num_warmup=8, num_samples=4,
                               max_depth=depth, batch_ndim=1,
                               fixed_trips=fixed)
        calls[fixed] = lp.calls
    # each transition: its steps and the gradient at the chosen state
    assert calls[True] == 1 + T * (2 ** depth - 1 + 1)
    assert calls[False] < calls[True]
    (sa, ia), (sb, ib) = out[False], out[True]
    for a, b in zip(tfit.tree_leaves(sa), tfit.tree_leaves(sb)):
        assert torch.equal(a, b)
    for k in ia:
        assert torch.equal(ia[k], ib[k])


# ---------------------------------------------------------------------------
# (b), (c) the device loop against the host loop
# ---------------------------------------------------------------------------

def _equal_runs(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (b.mask == 1).all() and len(b.iteration_seconds) == E
    assert b.launches == a.launches and b.graph is None
    if a.samples is None:
        assert b.samples is None
    else:
        for x, y in zip(tfit.tree_leaves(a.samples),
                        tfit.tree_leaves(b.samples)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("method", ["chol", "sweep"])
@pytest.mark.parametrize("fit_method", ["map", "hmc", "nuts", "vi"])
def test_device_loop_equals_host_loop(inputs, fit_method, method):
    """Branin, S=3 x E=3: the device loop's proposals, losses, mask and
    last mixture draws equal the host loop's bit for bit."""
    fn, tp, md, _ = inputs
    cfg = tc.CampaignConfig(fit_method=fit_method, mll_method=method, **CFG)
    a = tc.run_campaign(fn, tp, md, cfg=cfg, **KW)
    b = tc.run_campaign(fn, tp, md, cfg=cfg, loop="device", **KW)
    _equal_runs(a, b)


@pytest.mark.parametrize("fit_method", ["map", "nuts"])
def test_device_loop_on_a_mesh_equals_host_loop(inputs, fit_method):
    """The same on a mesh of 2 study rows (S=3 padded to 4), each row its
    own body on its ``cpu`` slot."""
    fn, tp, md, _ = inputs
    cfg = tc.CampaignConfig(fit_method=fit_method, mll_method="sweep", **CFG)
    kw = dict(KW, cfg=cfg, mesh=make_mesh(study=2, devices=["cpu"] * 2))
    a = tc.run_campaign(fn, tp, md, **kw)
    b = tc.run_campaign(fn, tp, md, loop="device", **kw)
    _equal_runs(a, b)
    assert b.studies.tolist() == list(range(S))


def test_device_loop_times_its_stages_on_the_cpu(inputs):
    """Off a capture the body's stages are timed as the host loop's are:
    once an iteration each on the CPU."""
    fn, tp, md, _ = inputs
    cfg = tc.CampaignConfig(mll_method="sweep", **CFG)
    GLOBAL_TIMER.reset()
    tc.run_campaign(fn, tp, md, cfg=cfg, loop="device", **KW)
    stages = GLOBAL_TIMER.report()
    for name in ("iteration_fit_target", "iteration_acq_state",
                 "iteration_propose", "iteration_benchmark"):
        assert stages[name]["count"] == E, (name, stages)
    assert not capturing("cpu") and not capturing(None)


class _FakeDriver:
    """libcuda's graph calls over a table: graph -> [(node, type,
    function or child graph)]; counts the name lookups."""

    def __init__(self, graphs):
        self.graphs, self.lookups = graphs, 0
        self.nodes = {node: (kind, what) for table in graphs.values()
                      for node, kind, what in table}

    def cuGraphGetNodes(self, graph, nodes, n):
        table = self.graphs[graph]
        n._obj.value = len(table)
        if nodes is not None:
            for i, (node, _, _) in enumerate(table):
                nodes[i] = node
        return 0

    def cuGraphNodeGetType(self, node, kind):
        kind._obj.value = self.nodes[node][0]
        return 0

    def cuGraphChildGraphNodeGetGraph(self, node, child):
        child._obj.value = self.nodes[node][1]
        return 0

    def get_params(self, node, params):
        params._obj.func = self.nodes[node][1]
        return 0

    def cuFuncGetName(self, name, func):
        self.lookups += 1
        name._obj.value = f"fn{func}".encode()
        return 0


def test_kernel_nodes_counts_kernels_of_child_graphs():
    """The walk counts kernel nodes by name, in child graphs too, and
    skips every other node type."""
    cu = _FakeDriver({1: [(10, 0, 7), (11, 0, 7), (12, 1, None),
                          (13, 4, 2), (14, 0, 8)],
                      2: [(20, 0, 7), (21, 5, None)]})
    out = collections.Counter()
    cuda_graph._count(cu, cu.get_params, 1, out, {})
    assert dict(out) == {"fn7": 3, "fn8": 1} and cu.lookups == 2


# ---------------------------------------------------------------------------
# (d) the host loop's options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [dict(checkpoint_path="unused"),
                                    dict(stop_after=1),
                                    dict(study_chunk=1),
                                    dict(loop="fused")])
def test_device_loop_refuses_host_options(inputs, kwargs):
    """Checkpoints, ``stop_after`` and study chunks are the host loop's;
    a loop that is neither is refused."""
    fn, tp, md, _ = inputs
    kwargs = {"loop": "device", **kwargs}
    with pytest.raises(ValueError, match="loop"):
        tc.run_campaign(fn, tp, md, cfg=tc.CampaignConfig(**CFG), **KW,
                        **kwargs)


# ---------------------------------------------------------------------------
# (e) no host read in the body
# ---------------------------------------------------------------------------

HOST_READS = ("__bool__", "item", "tolist", "__int__", "__float__",
              "__index__")


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def _no_host_reads():
    """Every host read of a tensor raises ``HostRead``."""
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def raise_(self, *args, **kwargs):
            raise HostRead(f"Tensor.{name} in the device loop's body")
        return raise_

    for name in HOST_READS:
        setattr(torch.Tensor, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("fit_method", ["map", "hmc", "nuts", "vi"])
def test_device_body_reads_nothing_on_the_host(inputs, monkeypatch,
                                               fit_method):
    """While ``device_iteration`` runs, a tensor's ``bool``, ``item``,
    ``tolist``, ``int``, ``float`` and ``index`` raise: the campaign still
    runs, on ``sweep`` (its kernel wrapper's route) for every fit method;
    the host loop's iteration, whose fit ends on a host test, raises under
    the same guard."""
    fn, tp, md, _ = inputs
    cfg = tc.CampaignConfig(fit_method=fit_method, mll_method="sweep", **CFG)
    body = tc.device_iteration
    ran = []

    def guarded(*args, **kwargs):
        with _no_host_reads():
            out = body(*args, **kwargs)
        ran.append(1)
        return out

    monkeypatch.setattr(tc, "device_iteration", guarded)
    res = tc.run_campaign(fn, tp, md, cfg=cfg, loop="device", **KW)
    assert len(ran) == E and torch.isfinite(res.X).all()
    if fit_method in ("map", "nuts"):
        host = tc.run_iteration
        monkeypatch.setattr(tc, "run_iteration", lambda *a, **k: (
            _guarded_call(host, *a, **k)))
        with pytest.raises(HostRead):
            tc.run_campaign(fn, tp, md, cfg=dataclasses.replace(
                cfg, n_evaluations=1), **KW)


def _guarded_call(fn, *args, **kwargs):
    with _no_host_reads():
        return fn(*args, **kwargs)


def test_guard_restores_tensor_methods():
    with pytest.raises(HostRead):
        with _no_host_reads():
            bool(torch.ones(1))
    t = torch.tensor([2.5])
    assert bool(t) and t.item() == 2.5 and t.tolist() == [2.5]
    assert math.isclose(float(t), 2.5) and int(t) == 2
