"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` of ``SOURCES`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout (a
directory git ignores), then loaded with ``ctypes``.  The hash covers the
source, the headers of ``csrc/`` and the flags, so an edited source or
header is rebuilt.  Nothing is built or
loaded when this module is imported: ``load`` builds at first use, and
``build_all`` starts one ``nvcc`` per missing library, all at once.
Slots on host threads (``parallel.mesh.run_slots``) reach these at once:
``once_per_key`` lets one thread build and set up an entry while the others
wait, and ``count_launch`` ticks the kernels' launch counters under one
lock.

A source is built with ``NVCC_FLAGS``, its own ``SOURCE_FLAGS`` and the
caller's ``extra`` flags (a profiling build's ``-D`` macro, ``-Xptxas -v``);
each set of flags is a library of its own.  ``BUILD_LOGS`` keeps what
``nvcc`` printed for each library built in this process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: the kernel sources, one library each; ``baseline_kernels`` holds the
#: first versions of the redesigned kernels, timed beside them and on no path
SOURCES = ("sweep_inverse", "sweep_variants", "blocked_chol_inverse", "gram",
           "baseline_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
#: each source's flags beyond NVCC_FLAGS.  The sweep kernels are built
#: without FMA contraction: with it, their MLL on the campaign's nearly
#: singular float32 systems lay 5x farther from float64 than their plain
#: versions'; without it, it equals theirs (PERF.md, section 6).
SOURCE_FLAGS = {"sweep_inverse": ("-fmad=false",),
                "sweep_variants": ("-fmad=false",)}
#: library path -> nvcc's output, for each library built in this process
BUILD_LOGS: dict = {}
#: guards every kernel wrapper's launch counter (``count_launch``)
LAUNCH_LOCK = threading.Lock()


def count_launch(counts: dict, key) -> None:
    """One more launch of ``key`` in a wrapper's ``counts`` (its dict of
    counts by scheme, or ``vars(wrapper)`` and ``"launches"`` for a single
    count), under LAUNCH_LOCK: a read-modify-write that threads would
    otherwise lose."""
    with LAUNCH_LOCK:
        counts[key] += 1


def once_per_key(fn):
    """``functools.lru_cache(maxsize=None)`` whose calls run one at a time:
    threads that ask at first use wait for the one that builds and sets up
    the entry, so no source is built twice and no caller sees an entry
    half set up (a ctypes function without its argument types)."""
    cached = functools.lru_cache(maxsize=None)(fn)
    lock = threading.Lock()

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with lock:
            return cached(*args, **kwargs)

    call.cache_clear = cached.cache_clear
    return call


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def _flags(name: str, extra: tuple = ()) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()) + tuple(extra)


def library_path(name: str, extra: tuple = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.h")))
    digest = hashlib.sha256(
        src + " ".join(_flags(name, extra)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES, extra: tuple = ()) -> list:
    """Compile each source of ``names`` whose library is not built yet, one
    ``nvcc`` each, all started together, with ``extra`` flags.  Returns the
    libraries' paths in the order of ``names``."""
    outs = [library_path(n, extra) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *_flags(name, extra), "-o", tmp,
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOGS[str(out)] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for csrc/{name}.cu (exit "
                          f"{proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


@once_per_key
def load(name: str, extra: tuple = ()) -> ctypes.CDLL:
    """The kernel library of ``csrc/<name>.cu`` built with ``extra`` flags,
    built at first use."""
    return ctypes.CDLL(str(build_all([name], extra)[0]))
