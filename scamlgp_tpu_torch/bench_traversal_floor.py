"""The traversal floor of the sweep's loop shape, measured on the card
(port of ``scripts/bench_vpu_ceiling.py``, which measured it on the TPU's
vector unit).

The sweep inverse is N serial rank-1 updates over an N x N block held on
chip.  The floor kernel (``ops/probes.py::traversal_floor``,
``csrc/probe_kernels.cu``) runs N steps of one multiply pass and one add
pass over the block, in the ``select`` sweep kernel's layout and with its
barrier a step, and nothing else: the least that any N-step kernel of
that layout touching every element once a step takes.  Beside it, the
``select`` sweep kernel on the same batch: how many floor steps one sweep
step costs.

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
launches after one warm-up, with CUDA events on the card.

    python -m scamlgp_tpu_torch.bench_traversal_floor [--B 4096] [--N 128]
        [--reps 30] [--out floor.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from scamlgp_tpu_torch.bench_chol_fused_probe import elapsed_ms, probe_batch
from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.ops import probes, sweep


def chained_ms(fn, x, reps: int) -> float:
    """ms a launch of ``fn`` over ``reps`` launches, each on the last output
    times 1.0000001 (the JAX script's chain), after one warm-up launch."""
    fn(x)

    def body():
        carry = x
        for _ in range(reps):
            carry = fn(carry * 1.0000001)

    return elapsed_ms(x.device, body) / reps


def run(B: int = 4096, N: int = 128, reps: int = 30, device=None) -> dict:
    """The probe's line: the floor and ``select`` timed chained."""
    device = resolve_device(device)
    A = probe_batch(B, N, device)
    t_floor = chained_ms(probes.traversal_floor, A, reps)
    t_sweep = chained_ms(lambda a: sweep.sweep_inverse(a)[0], A, reps)
    t_scale = chained_ms(lambda a: a, A, reps)
    path = sweep.launch_geometry(N)
    block = ("a warp's lanes, one column a lane" if path["path"] == "warp"
             else "a CTA of 16 x 16 threads, a register tile each")
    return {
        "device": str(device), "card": _card(device),
        "B": B, "N": N, "reps": reps, "geometry": path,
        "floor_ms_per_batch": t_floor,
        "ceiling_evals_per_s": B / t_floor * 1e3,
        "floor_elem_fma_per_s": B * N ** 3 / t_floor * 1e3 / 1e12,
        "floor_unit": (f"TFMA/s over (N, N) float32 blocks held in the "
                       f"registers of {block}, one barrier a step"),
        "sweep_ms_per_batch": t_sweep,
        "sweep_evals_per_s": B / t_sweep * 1e3,
        "sweep_traversal_equiv": t_sweep / t_floor,
        "sweep_pct_of_ceiling": 100.0 * t_floor / t_sweep,
        # the chain's scaling alone, included in both times above
        "chain_ms_per_batch": t_scale,
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
