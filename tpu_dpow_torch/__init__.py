"""tpu_dpow_torch: the Nano proof-of-work engine on PyTorch and CUDA.

The port of ``tpu_dpow`` (JAX/Pallas on a TPU) to an NVIDIA H100. Its
layout and names follow ``tpu_dpow`` module for module; it imports
``torch`` and never ``jax``, and nothing of ``tpu_dpow``. The Blake2b
nonce search that ``tpu_dpow`` runs as a Pallas kernel runs here as a
hand-written CUDA kernel (``ops/csrc/blake2b_search.cu``); on the CPU the
same entry points take their plain PyTorch versions.
"""
