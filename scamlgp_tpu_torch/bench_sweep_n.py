"""Kernel N-scaling bench: the sweep's step schemes against the blocked
Cholesky and the library Cholesky (port of ``scripts/bench_sweep_n.py``).

Measures the value and gradient of the MAP objective (D = 6 source-GP
objective, float32, prior-drawn hyperparameters) per shape, in MLL
evaluations per second, along each forward route:

- ``xla``          library Cholesky MLL with autograd (``method="chol"``)
- ``elementary``   the sweep kernel, ``select`` scheme, forced at every N
- ``fused``        the sweep kernel, ``fused`` scheme, forced at every N
- ``pair``         the sweep kernel, ``pair`` scheme (N even)
- ``blocked``      the sweep kernel, ``blocked`` scheme (N % 32 == 0)
- ``blockedchol``  the blocked-Cholesky kernel forced at every N, with the
                   analytic MLL gradient
- ``xlainv``       library Cholesky-inverse forward with the analytic MLL
                   gradient
- ``auto``         the port's routing (``method="sweep"``, defaults)

Each variant is reached by the arguments ``sweep_variant`` and
``inverse_route`` of ``models.gp.map_objective``, where the reference
patches module constants.  A variant that cannot take a shape (the sweep
schemes hold one matrix in one CTA's shared memory, N <= 128) is recorded
as ``FAILED: <error>``, as the reference records a VMEM overflow.  The card
is synchronized before every clock read.

    python -m scamlgp_tpu_torch.bench_sweep_n [--variants ...]
        [--shapes 128 256] [--pin-noise] [--out bench.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.models import gp
from scamlgp_tpu_torch.ops import inverse_mll, sweep
from scamlgp_tpu_torch.utils.profiling import synchronize

SHAPES = [  # (B, N), as the reference: B scaled down as N grows
    (4096, 128),
    (1024, 256),
    (256, 512),
    (64, 1024),
    (16, 2048),
]

#: variant -> (gp.mll method, sweep_variant, inverse_route)
VARIANTS = {
    "xla": ("chol", "select", "auto"),
    "elementary": ("sweep", "select", "sweep"),
    "fused": ("sweep", "fused", "sweep"),
    "pair": ("sweep", "pair", "sweep"),
    "blocked": ("sweep", "blocked", "sweep"),
    "blockedchol": ("sweep", "select", "blocked_chol"),
    "xlainv": ("sweep", "select", "chol_inverse"),
    "auto": ("sweep", "select", "auto"),
}
DEFAULT_VARIANTS = ["elementary", "blockedchol", "xla", "auto"]


def _inputs(B, N, pin_noise, device):
    D = 6
    dtype = torch.float32
    cfg = gp.source_gp_config()
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(size=(B, N, D)), dtype=dtype,
                        device=device)
    y = torch.as_tensor(rng.normal(size=(B, N)), dtype=dtype, device=device)
    params = gp.sample_params(cfg, torch.Generator().manual_seed(0), D, dtype,
                              batch_shape=(B,))
    # --pin-noise: observation noise at 9e-3, near the constraint's ceiling
    # (the reference's round-2 comparison mode)
    if pin_noise:
        raw = cfg.noise_constraint.inverse(torch.tensor(9e-3, dtype=dtype))
        params = params._replace(raw_noise=raw.expand(B).clone())
    params = gp.GPParams(*[leaf.to(device) for leaf in params])
    return cfg, params, X, y


def bench_variant(B, N, variant, rounds=10, pin_noise=False, device="cuda"):
    """MLL evaluations (value and gradient) per second of ``variant`` at
    (B, N), and the launches of each kernel in the timed rounds; or None and
    the error."""
    method, sweep_variant, route = VARIANTS[variant]
    if sweep.resolve_variant(N, sweep_variant) != sweep_variant:
        return None, (f"ValueError: the {sweep_variant} scheme does not take "
                      f"N={N}"), {}
    cfg, params, X, y = _inputs(B, N, pin_noise, device)

    def step():
        p = gp.GPParams(*[leaf.detach().requires_grad_(True)
                          for leaf in params])
        v = gp.map_objective(cfg, p, X, y, method=method,
                             sweep_variant=sweep_variant,
                             inverse_route=route)
        return v, torch.autograd.grad(v.sum(), tuple(p))

    try:
        v, _ = step()
        if not bool(torch.isfinite(v).all()):
            return None, "non-finite", {}
        before = inverse_mll.kernel_launches()
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            step()
        synchronize(device)
        dt = time.perf_counter() - t0
        after = inverse_mll.kernel_launches()
        return B * rounds / dt, None, {k: after[k] - before[k]
                                       for k in after if after[k] > before[k]}
    except Exception as e:  # a shape the kernel does not take, etc.
        return None, type(e).__name__ + ": " + str(e)[:200], {}


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def run(shapes=SHAPES, variants=DEFAULT_VARIANTS, pin_noise=False,
        device=None, rounds=10) -> dict:
    """The bench's table: one row per (B, N), one entry per variant
    (evaluations per second, or ``FAILED: <error>``)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": str(device), "card": _card(device), "results": []}
    for B, N in shapes:
        row = {"B": B, "N": N, "launches": {}}
        for variant in variants:
            evals_s, err, launches = bench_variant(
                B, N, variant, rounds=rounds, pin_noise=pin_noise,
                device=device)
            row[variant] = evals_s if err is None else f"FAILED: {err}"
            row["launches"][variant] = launches
            print(f"N={N:5d} B={B:5d} {variant:11s} -> {row[variant]}",
                  flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        out["results"].append(row)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=DEFAULT_VARIANTS,
                    choices=list(VARIANTS))
    ap.add_argument("--shapes", nargs="*", type=int, default=None,
                    help="restrict to these N values")
    ap.add_argument("--pin-noise", action="store_true",
                    help="pin observation noise at 9e-3")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    shapes = [(B, N) for B, N in SHAPES
              if not args.shapes or N in args.shapes]
    out = run(shapes, args.variants, args.pin_noise, args.device)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    return out


if __name__ == "__main__":
    main()
