"""Data parallelism over processes (``torch.distributed``); see
:mod:`daspeech_torch.parallel.multihost`. The JAX package's GSPMD
partitioning (``daspeech_tpu/parallel/partition.py``) is not ported:
``--fsdp`` is refused (ROADMAP Queue 1 #4c)."""
