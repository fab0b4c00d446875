"""snag_tpu_torch — the PyTorch + CUDA port of ``snag_tpu`` for NVIDIA Hopper.

Module paths mirror ``snag_tpu`` so each counterpart is easy to find.  The
package imports torch, numpy and the standard library only; the JAX
package is the reference it is tested against (``tests/test_torch_*.py``).
"""
