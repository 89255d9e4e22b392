"""The cluster plan of the DAG dynamic-program kernels
(``daspeech_torch.ops.dag_kernels.cluster_plan``), and the plain loop's
fp32 error against float64 where the kernels' arithmetic parts from it.

The alpha/beta kernel (#8) and the Viterbi kernel (#9) run each sample's
recursion (and sweep) on a thread-block cluster of ``cs`` blocks that split
the vertex axis in interleaved groups of 32 columns. The plan is pure
Python: these tests hold it to its rules (``cs`` a power of two, at most
the portable 8 and the number of groups, the grid within the card's SMs
unless ``cs`` is 1), to the cluster sizes of the main path's shapes on a
card of 132 SMs, and the column groups to a cover of [0, L) without
overlap.

The plain loop of ``ops/dag_ref.py`` (like JAX's scan) sums exp(x - c), c
the previous row's maximum; the kernel takes each log-sum-exp online,
shifted by its own running maximum (``csrc/dag_common.cuh``), and is held
to float64 on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``). Here the plain loop's own fp32 loss is held: on a
graph whose row maximum sits on a dead end (a vertex with no links out, or
none in for beta) a term 120 nats below c underflows, and at J-long's
[14, 128, 700] (the inputs of ``chip_smoke.py``'s float64 check, seeds
0-3) entries within 20 nats of their row's maximum come out up to 1.27
nats off where the previous row's maximum sits on the graph's last
vertex, while logprob and beta stay within 2 sqrt(T) ulp.
"""

import math

import pytest
import torch

from daspeech_torch.ops import dag_kernels as dk
from daspeech_torch.ops import dag_ref as dr

H100_SMS = 132


@pytest.mark.parametrize("L", [1, 5, 31, 33, 240, 600, 700, 1024])
def test_plan_rules(L):
    groups = math.ceil(L / dk.GROUP)
    for B in (1, 2, 4, 14, 40, 80, 200):
        for sweeps in (1, 2):
            for n_sm in (16, 78, 132):
                cs = dk.cluster_plan(B, sweeps, L, n_sm)
                assert cs & (cs - 1) == 0 and 1 <= cs <= dk.MAX_CLUSTER
                assert cs <= groups
                assert cs == 1 or B * sweeps * cs <= n_sm
                # the largest such: doubling it breaks a rule
                assert (2 * cs > min(dk.MAX_CLUSTER, groups)
                        or B * sweeps * 2 * cs > n_sm)


@pytest.mark.parametrize("B,L,fb,vit", [(80, 240, 1, 1),     # S2TT (T)
                                        (40, 240, 1, 2),     # joint J
                                        (14, 700, 4, 8),     # joint J-long
                                        (4, 1024, 8, 8)])    # the L cap
def test_main_path_cluster_sizes(B, L, fb, vit):
    assert dk.cluster_plan(B, 2, L, H100_SMS) == fb
    assert dk.cluster_plan(B, 1, L, H100_SMS) == vit


def test_plan_at_j_long():
    """J-long: 14 clusters of 8 blocks for the Viterbi (at most 3 groups
    of 32 columns each), 28 of 4 for alpha/beta (at most 6)."""
    for sweeps, cs, most in ((1, 8, 3), (2, 4, 6)):
        assert dk.cluster_plan(14, sweeps, 700, H100_SMS) == cs
        assert 14 * sweeps * cs <= H100_SMS
        owned = [len(dk.block_columns(700, cs, r)) for r in range(cs)]
        assert max(owned) == most * dk.GROUP and sum(owned) == 700


# the plan never gives more blocks than column groups
@pytest.mark.parametrize("L,cs", [(L, cs) for L in (1, 5, 33, 240, 700, 1024)
                                  for cs in (1, 2, 4, 8)
                                  if cs <= math.ceil(L / 32)])
def test_column_groups_cover_once(L, cs):
    owned = [dk.block_columns(L, cs, r) for r in range(cs)]
    flat = sorted(j for cols in owned for j in cols)
    assert flat == list(range(L))
    most = dk.GROUP * math.ceil(math.ceil(L / dk.GROUP) / cs)
    assert all(0 < len(cols) <= most for cols in owned)
    # interleaved: group g belongs to block g % cs
    for r, cols in enumerate(owned):
        assert all((j // dk.GROUP) % cs == r for j in cols)


def dead_end_inputs():
    """Two samples (T = 3, L = 4, match 0): in the first, alpha's row 1 has
    its maximum (0) on the last vertex, which has no links out, and its
    other entry at -120; in the second, beta's row 1 has its maximum on
    vertex 0, which no vertex links to, and its other entry at -120. The
    exact alpha[0, 2, 2] and logprob[1] are -120."""
    links = torch.full((2, 4, 4), -math.inf)
    links[0, 0, 1], links[0, 0, 3], links[0, 1, 2] = -120.0, 0.0, 0.0
    links[1, 0, 1], links[1, 0, 3], links[1, 1, 3] = 0.0, 0.0, -120.0
    match = torch.zeros(2, 3, 4)
    n = torch.tensor([4, 4]), torch.tensor([3, 3])
    return match, links, *n


def test_plain_loop_loses_mass_behind_a_dead_end():
    match, links, ol, tl = dead_end_inputs()
    logprob, alpha, _ = dr.dag_loss_forward_plain(match, links, ol, tl)
    exact = dr.dag_loss_forward_plain(match.double(), links.double(), ol, tl)
    assert exact[1][0, 2, 2] == -120.0 and exact[0][1] == -120.0
    # the reference's shift loses both in fp32 (exp(-120) underflows)
    assert alpha[0, 2, 2] == -math.inf and logprob[1] == -math.inf


def j_long_inputs(seed, B=14, T=128, L=700):
    """``chip_smoke.train_dp_inputs`` on the CPU: match [B, T, L] and
    log-softmax links over the valid transitions of graphs of >= L/2
    vertices, targets of >= T/2 tokens, sample 0 at full length."""
    g = torch.Generator().manual_seed(seed)
    ol = torch.randint(L // 2, L + 1, (B,), generator=g)
    tl = torch.randint(T // 2, T + 1, (B,), generator=g)
    ol[0], tl[0] = L, T
    i = torch.arange(L)
    valid = ((i[None, None, :] > i[None, :, None])
             & (i[None, None, :] < ol[:, None, None])
             & (i[None, :, None] < ol[:, None, None]))
    x = torch.where(valid, torch.randn(B, L, L, generator=g), -math.inf)
    links = torch.where(valid, torch.log_softmax(x, dim=-1), -math.inf)
    match = torch.randn(B, T, L, generator=g) - 2.0
    match = torch.where(i[None, None, :] < ol[:, None, None], match,
                        -math.inf)
    return match, links, ol, tl


def _near_max_err(got, exact, window=20.0):
    """|got - exact| over the entries within ``window`` nats of their row's
    maximum in ``exact`` (inf where ``got`` is -inf there), 0 elsewhere."""
    got = got.double()
    fin = torch.isfinite(exact)
    if exact.dim() == 1:                                # logprob [B]
        rowmax = torch.where(fin, exact, 0.0)
    else:
        rowmax = torch.where(fin, exact, -math.inf).amax(dim=-1,
                                                         keepdim=True)
        rowmax = torch.where(torch.isfinite(rowmax), rowmax, 0.0)
    near = fin & (rowmax - exact <= window)
    d = torch.where(torch.isfinite(got), (got - exact).abs(), math.inf)
    return torch.where(near, d, 0.0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_loop_against_float64_at_j_long(seed):
    T = 128
    match, links, ol, tl = j_long_inputs(seed)
    plain = dr.dag_loss_forward_plain(match, links, ol, tl)
    exact = dr.dag_loss_forward_plain(match.double(), links.double(), ol, tl)
    for got, want in zip(plain, exact):      # no NaN, no mass from nowhere
        assert not torch.isnan(got).any()
        assert not (torch.isfinite(got) & ~torch.isfinite(want)).any()
    big = max(float(torch.where(torch.isfinite(y), y, 0.0).abs().max())
              for y in exact)
    tol = 2.0 * math.sqrt(T) * 2.0 ** (math.floor(math.log2(big)) - 23)
    # logprob and beta: within the kernel's own bound
    for got, want in ((plain[0], exact[0]), (plain[2], exact[2])):
        assert _near_max_err(got, want).max() <= tol
    # alpha: the known loss, nats off within 20 nats of a row's maximum
    d = _near_max_err(plain[1], exact[1])
    worst = float(d.max())
    assert tol < worst <= 1.5, (worst, tol)
    # where the previous row's maximum sits on the graph's last vertex
    b, t, _ = (int(x) for x in torch.nonzero(d == d.max())[0])
    assert t >= 1 and int(exact[1][b, t - 1].argmax()) == int(ol[b]) - 1
