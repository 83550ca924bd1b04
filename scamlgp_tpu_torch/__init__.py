"""scamlgp_tpu_torch — ScaML-GP on PyTorch and CUDA for NVIDIA Hopper.

A port of the JAX package ``scamlgp_tpu``, module for module.  The JAX
package stays the reference: every module here is held against its JAX
counterpart on the same numpy inputs (``tests/test_torch_*.py``).  This
package imports torch, numpy and scipy only.

Entry points take ``device=``; left out, they run on ``cuda`` and raise when
no CUDA device is present.
"""

__version__ = "0.1.0"
