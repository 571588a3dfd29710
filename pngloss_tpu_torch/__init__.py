"""pngloss-tpu on PyTorch and CUDA.

Everything ``pngloss_tpu`` does, ported to PyTorch: the compress pipeline
(decode, colorspace reduce, ragged bucketing, the 5-filter row optimizer,
encode) in CLI mode and in embedding mode, the ``pngloss`` command line
(``python -m pngloss_tpu_torch``), the batched suite runner, the website
with its FastCGI transport, data parallelism over several devices
(``parallel``) and device traces (``tracing``). The TPU kernels of the
optimizer are rewritten as hand-written CUDA kernels for Hopper
(``csrc/``). CPU tensors run the plain PyTorch versions of the kernels;
CUDA tensors run the kernels. Importing the package pulls in neither JAX
nor CUDA.
"""

from pngloss_tpu.version import __version__

__all__ = ["__version__"]
