"""Whether a fused Cholesky -> inverse could beat the sweep: the rank-1
Cholesky probe (port of ``scripts/bench_chol_fused_probe.py``).

The sweep inverse does 2 N^3 nominal operations where inverse-via-Cholesky
needs about N^3, but a factor-then-invert scheme runs two serial N-step
loops (factor, then invert L) where the sweep runs one.  This probe times
the first loop alone: the hand-written Cholesky kernel
(``ops/probes.py::rank1_cholesky``, ``csrc/probe_kernels.cu``: a warp a
matrix at N <= 32; above, a CTA a matrix in shared memory, by panels of 32
columns, only the trailing block's lower triangle updated), beside
``select`` on the same batch.  If the factor alone costs about half the
sweep or more, two such loops cannot beat the sweep's one.  The factor is
first held against ``torch.linalg.cholesky`` on the first 8 matrices (rel
< 1e-4).

The batch is X X^T + 10 I, X (B, N, 8) standard normal from a seeded
``torch.Generator`` on the device, made exactly symmetric.  Each timing
chains its launches as the JAX script does (the next input depends on a
scalar of the last output: x (1 + 1e-9 out[0, 0, 0])), over ``--reps`` + 1
launches, with CUDA events on the card; ``chain_ms_per_batch`` is the
chaining alone, included in every chained time.
``library_chol_ms`` is ``torch.linalg.cholesky`` chained the same way, a
yardstick only.  Beside the chained times, the factor and ``select``
alone (``chol_ms_alone``, ``sweep_ms_alone``, ``chol_over_sweep_alone``:
bare launches behind a device spin, no chain and no host issue in them),
and, for each chained window, what the caching allocator did in it
(``allocator_counts``: retries, cudaMalloc and cudaFree calls, each of
which waits for the device) with the device's free bytes before them.
The verdict is the JAX script's, on the chained times.

    python -m scamlgp_tpu_torch.bench_chol_fused_probe [--B 4096] [--N 128]
        [--reps 30] [--out probe.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from scamlgp_tpu_torch.bench_sweep_n import _card
from scamlgp_tpu_torch.config import resolve_device
from scamlgp_tpu_torch.ops import probes, sweep
from scamlgp_tpu_torch.profile_kernels import device_ms


def probe_batch(B: int, N: int, device, seed: int = 0) -> torch.Tensor:
    """X X^T + 10 I for X (B, N, 8) standard normal, float32, made on
    ``device`` from ``seed`` and symmetrized (A + A^T) / 2, so that it is
    symmetric bit for bit."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((B, N, 8), generator=g, device=device,
                    dtype=torch.float32)
    A = torch.matmul(X, X.transpose(1, 2))
    A = 0.5 * (A + A.transpose(1, 2))
    return (A + 10.0 * torch.eye(N, device=device,
                                 dtype=torch.float32)).contiguous()


def elapsed_ms(device, body) -> float:
    """ms that ``body()`` takes: CUDA events around it on the card (the
    device synchronized before and after), the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        body()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    body()
    return (time.perf_counter() - t0) * 1e3


#: the caching allocator's counters read around each timed window: a
#: retry frees the cache and waits for the device, a device alloc or free
#: is a cudaMalloc or cudaFree
ALLOC_COUNTERS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def allocator_counts(device) -> dict | None:
    """The caching allocator's ``ALLOC_COUNTERS`` on the card; None on the
    CPU."""
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ALLOC_COUNTERS}


def counted_ms(device, body, per: int, counts: dict, key: str) -> float:
    """``elapsed_ms`` of ``body`` over ``per``, with the allocator's counts
    that the window added kept in ``counts[key]`` (None on the CPU)."""
    before = allocator_counts(device)
    ms = elapsed_ms(device, body) / per
    after = allocator_counts(device)
    counts[key] = (None if before is None
                   else {k: after[k] - before[k] for k in ALLOC_COUNTERS})
    return ms


def chained_ms(fn, x, reps: int, counts: dict, key: str) -> float:
    """ms a launch of ``fn`` over ``reps`` + 1 launches, each input scaled by
    a scalar of the last output (the JAX script's chain), after one
    warm-up launch; the window's allocator counts in ``counts[key]``."""
    fn(x)

    def body():
        carry = x
        for _ in range(reps):
            carry = x * (1.0 + 1e-9 * fn(carry)[0, 0, 0])
        fn(carry)

    return counted_ms(x.device, body, reps + 1, counts, key)


def alone_ms(fn, x, reps: int) -> float:
    """ms a launch of ``fn`` on x alone: on the card bare launches queued
    behind a device spin (``profile_kernels.device_ms``), so that neither
    the host's issue nor a chain is in the time; the host clock on the
    CPU."""
    if x.device.type == "cuda":
        return device_ms(lambda i: fn(x), reps)
    return elapsed_ms(x.device, lambda: [fn(x) for _ in range(reps)]) / reps


def run(B: int = 4096, N: int = 128, reps: int = 30, device=None) -> dict:
    """The probe's line: the factor checked, then the factor, ``select`` and
    the library Cholesky timed chained, and the factor and ``select``
    alone."""
    device = resolve_device(device)
    A = probe_batch(B, N, device)
    L = probes.rank1_cholesky(A)
    ref = torch.linalg.cholesky(A[:8])
    err = (L[:8] - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    print(f"rank-1 Cholesky vs torch.linalg.cholesky: max abs err {err:.2e} "
          f"(rel {rel:.2e})", flush=True)
    if not rel < 1e-4:
        raise AssertionError(f"rank1_cholesky incorrect: rel {rel}")

    free_bytes = (torch.cuda.mem_get_info(device)[0]
                  if device.type == "cuda" else None)
    counts = {}
    t_chol = chained_ms(probes.rank1_cholesky, A, reps, counts, "chol")
    t_sweep = chained_ms(lambda a: sweep.sweep_inverse(a)[0], A, reps,
                         counts, "sweep")
    t_lib = chained_ms(torch.linalg.cholesky, A, reps, counts, "library")
    t_chain = chained_ms(lambda a: a, A, reps, counts, "chain")
    a_chol = alone_ms(probes.rank1_cholesky, A, reps)
    a_sweep = alone_ms(sweep.sweep_inverse, A, reps)
    fused = 2.0 * t_chol   # factor + invert L, the same loop cost each
    return {
        "device": str(device), "card": _card(device),
        "B": B, "N": N, "reps": reps,
        "geometry": probes.launch_geometry("rank1_cholesky", B, N),
        "chol_ms_per_batch": t_chol,
        "sweep_ms_per_batch": t_sweep,
        "chol_over_sweep": t_chol / t_sweep,
        # the two alone, without the chain or the host's issue
        "chol_ms_alone": a_chol,
        "sweep_ms_alone": a_sweep,
        "chol_over_sweep_alone": a_chol / a_sweep,
        # the device's free bytes before the chained windows, and what the
        # caching allocator did in each window (None on the CPU)
        "free_bytes_at_start": free_bytes,
        "allocator_counts": counts,
        "fused_chol_inverse_lower_bound_ms": fused,
        "fused_over_sweep_lower_bound": fused / t_sweep,
        "verdict": ("fused chol->inverse LOSES: two serial N-step loops "
                    "cost >= 2x the chol loop, which alone is "
                    f"{t_chol / t_sweep:.2f}x the whole sweep"
                    if fused > t_sweep else
                    "fused chol->inverse could win - implement it"),
        # the JAX script's name; the factor is held to torch.linalg.cholesky
        "max_abs_err_vs_xla_cholesky": err,
        "library_chol_ms": t_lib,
        "chain_ms_per_batch": t_chain,
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
