"""PyTorch and CUDA port of ``federated_multi_modal_tpu`` for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package that
the port has reached is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` for ``sm_90a`` on first use (``ops/kernels/_build.py``). The
package imports nothing of JAX or of the JAX package.
"""
