"""The headline bench's step split into its stages (port of
``scripts/bench_profile_headline.py``).

The step is the value and gradient of the source-GP MAP objective at
B = 4096, N = 128, D = 6 in float32, prior-drawn hyperparameters.  Each
stage is timed alone, chained through a data dependency: every round adds
``0 * carry`` to its input and returns ``mean(value) * 1e-20`` as the next
carry, and the carry is fetched to the host before and after the timed
rounds (``chain_time``), so the clock covers every queued launch.

- ``gram_vg``:          value and gradient of sum(gram(X)), the Gram
                        assembly and its backward pass;
- ``inverse_fwd``:      the sweep inverse alone (``select``) on a fixed,
                        well-conditioned SPD batch;
- ``mll_vg_sweep``:     the MAP objective's value and gradient, ``sweep``;
- ``mll_vg_chol``:      the same, ``chol`` (library Cholesky);
- ``mll_fwd_sweep``:    the MLL forward only, ``sweep``;
- ``assemble_fwd``:     the Gram and ``mask_system``, forward only;
- ``mll_via_inv_preA``: ``mll_via_inverse`` on the prebuilt SPD batch.

``inverse_fwd``, ``mll_vg_sweep``, ``mll_fwd_sweep`` and ``mll_via_inv_preA``
launch the ``select`` kernel once a round; ``launches`` holds each stage's
count (``ops.inverse_mll.kernel_launches``) over its warm-up and rounds.

The ``_vg`` stages compute the gradient: the JAX step returns only the
value, so its compiled step need not.  The forward stages run without
autograd.  Prints one JSON line: the shape, each stage's evaluations per
second, ``ns_per_eval``, ``launches``, and the device and card.  The JAX
script's ``--cpu`` (a virtual CPU topology) becomes ``--device``; its
``backend`` key becomes ``device`` and ``card``.

    python -m scamlgp_tpu_torch.profile_headline [--B 4096] [--N 128]
        [--D 6] [--rounds 30] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import inverse_mll, linalg, sweep
from scamlgp_tpu_torch.ops import kernels as K_ops

def inputs(B: int, N: int, D: int, dtype=torch.float32, device=None) -> dict:
    """The script's inputs: X, y and the SPD batch A0 from
    ``default_rng(0)`` in its order, and ``B`` prior-drawn parameter sets
    (a torch generator seeded with 0: JAX's keys have no torch stream)."""
    device = resolve_device(device)
    cfg = gp.source_gp_config()
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(size=(B, N, D)), dtype=dtype,
                        device=device)
    y = torch.as_tensor(rng.normal(size=(B, N)), dtype=dtype, device=device)
    params = gp.sample_params(cfg, torch.Generator().manual_seed(0), D, dtype,
                              batch_shape=(B,))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    A0 = np.asarray(rng.normal(size=(B, N, N)), np_dtype)
    A0 = (A0 @ A0.transpose(0, 2, 1)) / N + 2.0 * np.eye(N, dtype=np_dtype)
    return dict(cfg=cfg, X=X, y=y, A0=torch.as_tensor(A0, device=device),
                params=gp.GPParams(*[leaf.to(device) for leaf in params]))


def _value_and_grad(f, params: gp.GPParams):
    """f's (B,) values and, per element, their gradients in ``params``
    (zeros for a parameter that f does not read, as JAX gives)."""
    p = gp.GPParams(*[leaf.detach().requires_grad_(True) for leaf in params])
    with torch.enable_grad():
        v = f(p)
        g = torch.autograd.grad(v.sum(), tuple(p), allow_unused=True,
                                materialize_grads=True)
    return v.detach(), gp.GPParams(*g)


def gram_vg(ins: dict, carry):
    """sum(gram(X)) per element and its gradient."""
    cfg, X = ins["cfg"], ins["X"] + carry * 0.0

    def one(p):
        c = gp.constrain(cfg, p)
        K = K_ops.gram(cfg.kernel, X, X, c.lengthscale, c.outputscale)
        return torch.sum(K, dim=(-2, -1))

    return _value_and_grad(one, ins["params"])


def inverse_fwd(ins: dict, carry):
    """(A0^{-1}, log|A0|) through the ``select`` sweep."""
    return sweep.sweep_inverse(ins["A0"] + carry * 0.0)


def _mll_vg(method: str):
    def stage(ins: dict, carry):
        cfg, X, y = ins["cfg"], ins["X"] + carry * 0.0, ins["y"]
        return _value_and_grad(
            lambda p: gp.map_objective(cfg, p, X, y, method=method),
            ins["params"])

    stage.__doc__ = f"MAP objective and gradient, ``{method}``."
    return stage


def mll_fwd_sweep(ins: dict, carry):
    """The MLL, ``sweep``, forward only."""
    return gp.mll(ins["cfg"], ins["params"], ins["X"] + carry * 0.0,
                  ins["y"], method="sweep")


def assemble_fwd(ins: dict, carry):
    """sum(mask_system(gram(X))) per element: the glue before the kernel."""
    cfg = ins["cfg"]
    X = ins["X"] + carry * 0.0
    c = gp.constrain(cfg, ins["params"])
    K = K_ops.gram(cfg.kernel, X, X, c.lengthscale, c.outputscale)
    return torch.sum(linalg.mask_system(K, c.noise, None), dim=(-2, -1))


def mll_via_inv_preA(ins: dict, carry):
    """``mll_via_inverse`` on the prebuilt A0 with n_active = N."""
    A = ins["A0"] + carry * 0.0
    n = torch.full(A.shape[:1], float(A.shape[-1]), dtype=A.dtype,
                   device=A.device)
    return inverse_mll.mll_via_inverse(A, ins["y"], n)


#: stage -> its function ``(inputs, carry) -> (value, grads)`` (the ``_vg``
#: stages), ``(A^{-1}, log|A|)`` (``inverse_fwd``) or the value
STAGE_FNS = {
    "gram_vg": gram_vg,
    "inverse_fwd": inverse_fwd,
    "mll_vg_sweep": _mll_vg("sweep"),
    "mll_vg_chol": _mll_vg("chol"),
    "mll_fwd_sweep": mll_fwd_sweep,
    "assemble_fwd": assemble_fwd,
    "mll_via_inv_preA": mll_via_inv_preA,
}
STAGES = tuple(STAGE_FNS)


def _carry(name: str, out) -> torch.Tensor:
    """The next carry from a stage's output: mean(value) * 1e-20 (for
    ``inverse_fwd`` the log-determinants)."""
    value = out[1] if name == "inverse_fwd" else (
        out[0] if isinstance(out, tuple) else out)
    return torch.mean(value) * 1e-20


def chain_time(step, carry, rounds: int) -> float:
    """Seconds of ``rounds`` chained calls of ``step(carry) -> carry``,
    after one untimed call; the carried scalar is fetched to the host before
    the clock starts and after the last round."""
    carry = step(carry)
    float(carry)
    t0 = time.perf_counter()
    for _ in range(rounds):
        carry = step(carry)
    float(carry)
    return time.perf_counter() - t0


def run(B: int = 4096, N: int = 128, D: int = 6, rounds: int = 30,
        device=None) -> dict:
    """Each stage's evaluations per second (B evaluations a round), ns
    per evaluation and kernel launches."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    ins = inputs(B, N, D, torch.float32, device)
    results = {"B": B, "N": N, "D": D, "rounds": rounds,
               "device": str(device), "card": _card(device)}
    launches = {}
    for name in STAGES:
        def step(carry, fn=STAGE_FNS[name], name=name):
            with torch.no_grad():   # the _vg stages enable it themselves
                return _carry(name, fn(ins, carry))

        before = inverse_mll.kernel_launches()
        dt = chain_time(step, torch.zeros((), dtype=torch.float32,
                                          device=device), rounds)
        after = inverse_mll.kernel_launches()
        launches[name] = {k: after[k] - before.get(k, 0) for k in after
                          if after[k] > before.get(k, 0)}
        results[name] = B * rounds / dt
    results["ns_per_eval"] = {k: 1e9 / results[k] for k in STAGES}
    results["launches"] = launches
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--D", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    results = run(args.B, args.N, args.D, args.rounds, args.device)
    print(json.dumps(results), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
    return results


if __name__ == "__main__":
    main()
