"""uvaia_tpu_torch: the uvaia-tpu scan on PyTorch and hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

A port of the JAX package ``uvaia_tpu`` that sits beside it: the JAX
package is the reference each part is held against, byte for byte.
This package imports torch and never jax; from ``uvaia_tpu`` it imports
only jax-free host modules (encoding, IO, stores, checkpoints, query
QC, the argparse builders).
"""

__version__ = "0.1.0"
