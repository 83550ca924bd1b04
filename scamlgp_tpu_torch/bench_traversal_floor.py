"""The traversal floor of the sweep's loop shape, measured on the card
(port of ``scripts/bench_vpu_ceiling.py``, which measured it on the TPU's
vector unit).

The sweep inverse is N serial rank-1 updates over an N x N block held on
chip.  The floor kernel (``ops/probes.py::traversal_floor``,
``csrc/probe_kernels.cu``) runs N steps of one multiply-add (an FMA) over
every element of the block, and nothing else: no value crosses threads,
so it has no barrier, and each thread carries 32 independent chains of
the flat batch.  That is the least that any N-step kernel touching every
element once a step takes on the card.  Beside it, the ``select`` sweep
kernel on the same batch: how many floor steps one sweep step costs.

Outputs:

- ``floor_ms_per_batch``, ``ceiling_evals_per_s`` (matrices a second at
  the floor) and ``floor_elem_fma_per_s`` (element multiply-adds a second,
  in T: N^3 a matrix);
- ``sweep_ms_per_batch``, ``sweep_evals_per_s``;
- ``sweep_traversal_equiv``: sweep time over floor time;
  ``sweep_pct_of_ceiling``: floor time over sweep time, in percent.

The batch is the rank-1 Cholesky probe's (``bench_chol_fused_probe.
probe_batch``).  Each timing chains its launches as the JAX script does
(each launch's input is the last output times 1.0000001), over ``--reps``
launches after one warm-up, with CUDA events on the card; beside them
the floor and ``select`` alone (``floor_ms_alone``, ``sweep_ms_alone``,
``sweep_pct_of_ceiling_alone``: bare launches behind a device spin) and
each chained window's allocator counts (``bench_chol_fused_probe``).

    python -m scamlgp_tpu_torch.bench_traversal_floor [--B 4096] [--N 128]
        [--reps 30] [--out floor.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from scamlgp_tpu_torch.bench_chol_fused_probe import (
    alone_ms,
    counted_ms,
    probe_batch,
)
from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.ops import probes, sweep


def chained_ms(fn, x, reps: int, counts: dict, key: str) -> float:
    """ms a launch of ``fn`` over ``reps`` launches, each on the last output
    times 1.0000001 (the JAX script's chain), after one warm-up launch;
    the window's allocator counts in ``counts[key]``."""
    fn(x)

    def body():
        carry = x
        for _ in range(reps):
            carry = fn(carry * 1.0000001)

    return counted_ms(x.device, body, reps, counts, key)


def run(B: int = 4096, N: int = 128, reps: int = 30, device=None) -> dict:
    """The probe's line: the floor and ``select`` timed chained and
    alone."""
    device = resolve_device(device)
    A = probe_batch(B, N, device)
    counts = {}
    t_floor = chained_ms(probes.traversal_floor, A, reps, counts, "floor")
    t_sweep = chained_ms(lambda a: sweep.sweep_inverse(a)[0], A, reps,
                         counts, "sweep")
    t_scale = chained_ms(lambda a: a, A, reps, counts, "chain")
    a_floor = alone_ms(probes.traversal_floor, A, reps)
    a_sweep = alone_ms(sweep.sweep_inverse, A, reps)
    geometry = probes.launch_geometry("traversal_floor", B, N)
    return {
        "device": str(device), "card": _card(device),
        "B": B, "N": N, "reps": reps, "geometry": geometry,
        "floor_ms_per_batch": t_floor,
        "ceiling_evals_per_s": B / t_floor * 1e3,
        "floor_elem_fma_per_s": B * N ** 3 / t_floor * 1e3 / 1e12,
        "floor_unit": (f"TFMA/s over (N, N) float32 blocks, one FMA an "
                       f"element a step, {geometry['capacity']} independent "
                       f"chains a thread of the flat batch, no barrier"),
        "sweep_ms_per_batch": t_sweep,
        "sweep_evals_per_s": B / t_sweep * 1e3,
        "sweep_traversal_equiv": t_sweep / t_floor,
        "sweep_pct_of_ceiling": 100.0 * t_floor / t_sweep,
        # the chain's scaling alone, included in both times above
        "chain_ms_per_batch": t_scale,
        # the two alone, without the chain or the host's issue
        "floor_ms_alone": a_floor,
        "sweep_ms_alone": a_sweep,
        "sweep_pct_of_ceiling_alone": 100.0 * a_floor / a_sweep,
        "allocator_counts": counts,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--N", type=int, default=128)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.B, args.N, args.reps, args.device)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
