"""mp2_tpu_torch: the TP2 prover in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of `mp2_tpu` (JAX + Pallas on a TPU), which stays beside it as the
reference: the same inputs give bit-identical outputs in both packages.
This package imports `torch` and never `jax`.

Field elements are `torch.int64` tensors holding the bit pattern of the
canonical u64 value (see `field/goldilocks.py`).  Every function that makes
tensors takes an explicit `device`; nothing guesses one.

Layers, from the entry points down (each a copy of `mp2_tpu`'s namesake):

  api                 PublicParameters, build_circuits_params, generate_proof
                      over serialized CircuitInput dicts, verify_envelope
  models              the circuit-driven indexers (CircuitTableIndexer,
                      MergedTableIndexer), table configs, fixture chains
  parallel.workqueue  the coordinator / worker protocol over JSON lines on TCP
  parallel.scheduler  UpdateTree workplans -> batched proving
  parsil, vdb, extraction, recursion, circuit
                      SQL front end, verifiable DB and query circuits,
                      Ethereum extraction circuits, fixed-VK recursion, the
                      circuit builder and gadgets
  prover              NTT/LDE, Merkle caps, FRI, prove_batch, verify
  ops                 the CUDA kernels (csrc/) and their plain twins
  field, hash, ryhope, utils
"""
