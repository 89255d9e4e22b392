"""The train CLI's memory variants (``--banded-dp``, ``--fused-vocab-chunk``)
against JAX's ``make_train_step`` with the same options, at the bars of
``tests/test_torch_train_cli.py`` (whose helpers and fixtures run them),
in a file of its own so that the tier-1 run's workers can run it beside
that one."""

import numpy as np
import pytest

from test_torch_train_cli import (_assert_loop_matches_jax,  # noqa: F401
                                  interpret_pallas, one_thread)
from torch_cli_corpus import write_corpus


@pytest.fixture(scope="module")
def band_corpus(tmp_path_factory):
    """The corpus with a transition band of 4 in both DAG models' YAMLs
    (the graphs hold up to 12 vertices: the band engages)."""
    import yaml

    root = tmp_path_factory.mktemp("train_cli_band")
    write_corpus(root)
    for crit in ("nat_dag_loss", "s2s_dag_fastspeech2_loss"):
        path = root / f"{crit}.yaml"
        tree = yaml.safe_load(path.read_text())
        dec = (tree["dag"] if "dag" in tree else tree)["decoder"]
        dec["max_transition_length"] = BAND
        path.write_text(yaml.safe_dump(tree))
    return root


BAND = 4


@pytest.mark.parametrize("crit,flags", [
    ("nat_dag_loss", ["--banded-dp"]),
    ("nat_dag_loss", ["--fused-vocab-chunk", "64"]),
    ("nat_dag_loss", ["--banded-dp", "--fused-vocab-chunk", "7"]),
    ("s2s_dag_fastspeech2_loss", ["--banded-dp", "--fused-vocab-chunk",
                                  "8"]),
], ids=["banded", "fused", "both", "joint-both"])
def test_memory_variants_match_jax_cli(crit, flags, band_corpus,
                                       monkeypatch):
    """``--banded-dp`` and ``--fused-vocab-chunk`` reach the criterion
    (the banded DP or the streamed projection runs, the full-matrix DP or
    the [B, L, V] logits do not) and the loop matches JAX's
    ``make_train_step`` with the same options, at the bars of
    ``test_loop_matches_jax_make_train_step``."""
    from daspeech_torch.losses import dag_loss as tloss
    from daspeech_torch.losses import s2s_loss as ts2s

    banded = "--banded-dp" in flags
    chunk = (int(flags[flags.index("--fused-vocab-chunk") + 1])
             if "--fused-vocab-chunk" in flags else None)
    seen = set()
    for mod, name in ((tloss, "dag_loss_banded"),
                      (tloss, "dag_loss_banded_with_alpha_beta"),
                      (tloss, "dag_loss"), (tloss, "dag_loss_with_alpha_beta"),
                      (tloss, "fused_logsoftmax_gather"),
                      (ts2s, "fused_logsoftmax_gather")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn: (
            seen.add(_n), _f(*a))[1])
    losses = _assert_loop_matches_jax(
        crit, band_corpus, flags,
        dict(max_transition_length=BAND, banded_dp=banded,
             fused_vocab_chunk=chunk))
    assert np.isfinite(losses).all()
    assert any(n.startswith("dag_loss_banded") for n in seen) == banded
    assert any(not n.startswith("dag_loss_banded") and n != (
        "fused_logsoftmax_gather") for n in seen) == (not banded)
    assert ("fused_logsoftmax_gather" in seen) == (chunk is not None)
