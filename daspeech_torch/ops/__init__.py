"""Ops: each kernel-holding module pairs a plain PyTorch version (taken for
CPU tensors) with a hand-written CUDA kernel (launched for CUDA tensors);
``links_utils``, ``dag_banded`` and ``fused_vocab`` (the DAG loss's memory
variants) are plain tensor ops on any device, as their JAX counterparts
are ``lax.scan``s and einsums, not Pallas."""
