"""PyTorch + CUDA port of dorado_tpu for NVIDIA Hopper GPUs.

The package mirrors the layout of ``dorado_tpu`` (the JAX reference) and
imports nothing from it. Plain tensor code is PyTorch; the kernels the JAX
package wrote in Pallas are hand-written CUDA C++ for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``.
"""
