"""``daspeech_torch.parallel.dryrun.dryrun_multichip`` on the CPU (gloo):
one joint step of JAX's ``_tiny_cfg`` over 8 ranks, a (data 2, seq 2,
model 2) mesh with FSDP over ``data``, and over 4 ranks, data alone, as
``__graft_entry__.py``'s dryrun; each runs to its end with a finite loss
and gradient norm. Asked for cards where there are none, it raises
(it never falls back to the CPU)."""

import math

import pytest
import torch

from daspeech_torch.parallel.dryrun import dryrun_multichip


@pytest.mark.parametrize("n,mesh", [(8, {"data": 2, "seq": 2, "model": 2}),
                                    (4, {"data": 4})])
def test_dryrun_multichip_on_the_cpu(n, mesh):
    out = dryrun_multichip(n, device="cpu")
    assert out["mesh"] == mesh
    assert math.isfinite(out["loss"]) and math.isfinite(out["gnorm"])


def test_dryrun_multichip_refuses_missing_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="cards"):
        dryrun_multichip(have + 1)
