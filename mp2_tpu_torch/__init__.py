"""mp2_tpu_torch: the TP2 prover in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `mp2_tpu` (JAX + Pallas on a TPU), which stays beside it as the
reference: the same inputs give bit-identical outputs in both packages.
This package imports `torch` and never `jax`.

Field elements are `torch.int64` tensors holding the bit pattern of the
canonical u64 value (see `field/goldilocks.py`).  Every function that makes
tensors takes an explicit `device`; nothing guesses one.
"""
