"""Dtype, jitter and device policy of the port (``scamlgp_tpu/config.py:25-35``).

Everything takes its dtype from its inputs and passes it explicitly to every
tensor it creates: the global default dtype is never read.  Parity tests run
in float64 on the CPU; campaigns on the card run in float32, as the JAX
package ran its committed campaigns.
"""

from __future__ import annotations

import torch

#: Extra diagonal jitter added to every Gram matrix before factorization,
#: scaled by the mean of the diagonal.
JITTER_F64 = 1e-10
JITTER_F32 = 1e-6


def jitter_for(dtype: torch.dtype) -> float:
    return JITTER_F64 if dtype.itemsize == 8 else JITTER_F32


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch paths on the CPU")
        return torch.device("cuda")
    return torch.device(device)
