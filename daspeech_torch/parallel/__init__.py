"""Parallelism over processes (``torch.distributed``): data parallelism
(:mod:`daspeech_torch.parallel.multihost`), ``--fsdp`` and the data x seq x
model mesh of the JAX package's ``partition.py``
(:mod:`daspeech_torch.parallel.partition`, the modules' part in
:mod:`daspeech_torch.parallel.shard`) and its ``dryrun_multichip``
(:mod:`daspeech_torch.parallel.dryrun`)."""
