"""Where the two sequential drivers' ``predict`` gap comes from, on the
Branin case of ``test_torch_optimizer.py::test_driver_matches_the_jax_driver``
(not a test; run it by hand, on the CPU):

    python tests/torch_driver_parity_gap.py --seeds 0 1 2 3 --detail 9

For each target seed it prints, as JSON lines:

- ``free``: the largest proposal gap and relative ``predict`` gap after the
  test's 4 free-running steps;
- with ``--detail``, for that seed, ``shared``: each step with the JAX
  driver's proposal reported to both drivers, the relative ``predict`` gap,
  the port's posterior at the JAX driver's fitted parameters against the
  JAX ``predict``, both MAP objectives (the port's function at both
  parameter sets) and the largest parameter difference; and
  ``perturbed``: the port alone, its step-by-step ``predict`` moved by a
  relative change of the observations.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from _pytest.monkeypatch import MonkeyPatch  # noqa: E402

import test_torch_optimizer as T  # noqa: E402
from scamlgp_tpu.bo import optimizer as jopt  # noqa: E402
from scamlgp_tpu_torch import convert  # noqa: E402
from scamlgp_tpu_torch.bo import ScaMLGPBO  # noqa: E402
from scamlgp_tpu_torch.bo.core import Evaluation  # noqa: E402
from scamlgp_tpu_torch.models import scamlgp as tm  # noqa: E402

SEED = 11
STEPS = 4


def _drivers(target_seed, mp):
    (jspace, jobj, jmeta), (tspace, tobj, tmeta), evaluate = T.make_case(
        "branin_t3_p6", target_seed)
    kwargs = {k: v for k, v in T.FAST_KWARGS.items() if k != "device"}
    jdrv = jopt.ScaMLGPBO(jspace, jobj, jmeta, seed=SEED, **kwargs)
    T.JaxDraws(SEED, mp)
    tdrv = ScaMLGPBO(tspace, tobj, tmeta, seed=SEED, device="cpu", **kwargs)
    return jdrv, tdrv, evaluate, (tspace, tobj, tmeta, kwargs)


def _probe(drv):
    return [drv.search_space.from_numerical(v)
            for v in np.random.default_rng(0).uniform(size=(5, 2))]


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def free(target_seed):
    mp = MonkeyPatch()
    try:
        jdrv, tdrv, evaluate, _ = _drivers(target_seed, mp)
        jx = T._drive(jdrv, jdrv.search_space, evaluate, STEPS)
        tx = T._drive(tdrv, tdrv.search_space, evaluate, STEPS)
        probe = _probe(tdrv)
        (jm, js), (tmn, ts) = jdrv.predict(probe), tdrv.predict(probe)
        return {"x_gap": float(np.abs(tx - jx).max()),
                "predict_rel": max(_rel(tmn, jm), _rel(ts, js))}
    finally:
        mp.undo()


def _flat(d):
    out = []
    for k in sorted(d):
        out += _flat(d[k]) if isinstance(d[k], dict) else [np.ravel(d[k])]
    return out


def shared(target_seed):
    """Both drivers fed the JAX driver's proposals; returns one row a step
    and the observations, for ``perturbed``."""
    mp = MonkeyPatch()
    rows, observed = [], []
    try:
        jdrv, tdrv, evaluate, _ = _drivers(target_seed, mp)
        probe = _probe(tdrv)
        Xq = torch.as_tensor(np.stack([tdrv.search_space.to_numerical(c)
                                       for c in probe]))
        for step in range(STEPS):
            ej = jdrv.generate_evaluation_specification()
            tdrv.generate_evaluation_specification()
            y = evaluate(ej.configuration)
            observed.append((dict(ej.configuration), y))
            jdrv.report(ej.create_evaluation(objectives={"loss": y}))
            tdrv.report(Evaluation(configuration=dict(ej.configuration),
                                   objectives={"loss": y}))
            jm, _ = jdrv.predict(probe)
            tmn, _ = tdrv.predict(probe)
            jmodel = convert.scamlgp_model(
                convert.to_numpy_dict(jdrv.model), torch.float64, "cpu")
            at_jax, _ = tm.scamlgp_posterior_diag(
                jmodel, tdrv.source_cfg, tdrv.target_cfg, Xq)
            pt = np.concatenate(_flat(convert.to_numpy_dict(
                tdrv.model.params)))
            pj = np.concatenate(_flat(convert.to_numpy_dict(
                jdrv.model.params)))
            rows.append({
                "step": step + 1, "predict_rel": _rel(tmn, jm),
                "port_posterior_at_jax_params_rel": _rel(at_jax.numpy(), jm),
                "objective_at_port_params": float(tm.scamlgp_map_objective(
                    tdrv.model, tdrv.target_cfg, tdrv.model.params)),
                "objective_at_jax_params": float(tm.scamlgp_map_objective(
                    tdrv.model, tdrv.target_cfg, jmodel.params)),
                "param_max_abs_diff": float(np.max(np.abs(pt - pj)))})
        return rows, observed
    finally:
        mp.undo()


def perturbed(target_seed, observed, eps):
    """The port alone on ``observed`` and on y (1 + eps): the relative
    change of its ``predict`` at each step."""
    runs = []
    for e in (0.0, eps):
        mp = MonkeyPatch()
        try:
            _, tdrv, _, _ = _drivers(target_seed, mp)
            probe, preds = _probe(tdrv), []
            for config, y in observed:
                tdrv.generate_evaluation_specification()
                tdrv.report(Evaluation(configuration=config,
                                       objectives={"loss": y * (1 + e)}))
                preds.append(tdrv.predict(probe)[0])
            runs.append(preds)
        finally:
            mp.undo()
    return [_rel(b, a) for a, b in zip(*runs)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=list(range(12)))
    ap.add_argument("--detail", type=int, nargs="*", default=[9])
    ap.add_argument("--eps", type=float, nargs="*", default=[1e-13, 1e-11])
    args = ap.parse_args(argv)
    for s in args.seeds:
        print(json.dumps({"target_seed": s, "free": free(s)}), flush=True)
    for s in args.detail:
        rows, observed = shared(s)
        print(json.dumps({"target_seed": s, "shared": rows}), flush=True)
        for e in args.eps:
            print(json.dumps({"target_seed": s, "eps": e,
                              "perturbed": perturbed(s, observed, e)}),
                  flush=True)


if __name__ == "__main__":
    main()
