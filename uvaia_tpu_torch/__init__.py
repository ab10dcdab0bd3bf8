"""uvaia_tpu_torch: the uvaia-tpu scan on PyTorch and hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).

A port of the JAX package ``uvaia_tpu`` that sits beside it: the JAX
package is the reference each part is held against, byte for byte.
This package imports torch and never jax, and nothing of ``uvaia_tpu``:
it keeps its own copies of the host modules it needs (encoding, IO and
the native reader and encoder, store reading, checkpoints, query QC,
the argument parsers), under the JAX package's module names.
"""

__version__ = "0.1.0"
