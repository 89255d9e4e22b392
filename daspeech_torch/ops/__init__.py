"""Kernel-holding ops: each module pairs a plain PyTorch version (taken for
CPU tensors) with a hand-written CUDA kernel (launched for CUDA tensors)."""
