"""megatronapp_tpu_torch: the PyTorch + CUDA port of megatronapp_tpu.

The JAX package beside it is the reference. This package imports torch,
never jax, and nothing of megatronapp_tpu. Its kernels are written by
hand for Hopper (sm_90a) under ``csrc/`` and build at first use; each
has a plain PyTorch version that CPU tensors run.
"""
