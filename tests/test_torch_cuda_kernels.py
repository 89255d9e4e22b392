"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving and training paths can reach (ragged tiles, a
single key, Tq != Tk, long mels, graphs of one vertex and of the 1024-vertex
maximum, fully padded rows, the transition band, one target token, targets
and graphs shorter than their padding, dropout on, Viterbi ties, MRF
levels whose length is not a multiple of the tile or just above the
vocoder's route threshold, and each conv's halo at both sequence ends).
``chip_smoke.py`` covers the serving and training shapes. The tensor-core
attention kernels (packed and head-major) are also held at one query, one
key and a query tile one row over 64 against 130 keys, their backward
gradients to the bit over two runs, and the head-major kernel to the packed
one, dropout mask included; the full-bias kernel to the head-major one on
a column bias; the chunked-score tensor-core kernels of the rel-pos (#5)
and full-bias (#3) attention at T' = 1, 63, 65, 120 and 300, with a fully
padded row and dropout, their backward to the bit over two runs, and #5
with a = 0 to the head-major kernel within 1e-6; the FMA training forward
of #1, #2 and #5 at T' = 1 .. 1040 with a fully padded row and dropout,
also where its launcher splits the keys over several blocks and merges
them, bit-identical over two runs, its statistics through the tensor-core
backward, packed equal to head-major and #5 with a = 0 equal to #2 within
1e-6; the fused FFN at one row, ragged row tiles and F chunks, with its
weight gradients bit-identical over two runs, and on thread-block clusters
(F split over 2, 4 and 8 blocks) with ragged row tiles; the tensor-core
MRF kernel at C = 32, 64 and 128, every tile, T = 1, 65 and 513, the same
bits at every tile and in a window as in the whole sequence; the link
extraction on live
tiles at lengths around the 64-wide tile (63, 65, 129) and the 1024 cap,
with and without the transition band, and at J-long's [14, 700] H = 8
(the -inf pattern, a finite lse_h, the tensor-core backward bit-identical
over two runs); the full-bias attention's training forward (the FMA
kernel's full-bias mode) with dropout and a fully masked row, its
statistics through the tensor-core backward; a library that holds no
SIMT attention forward; the bf16 tensor-core kernels of #5 and #4
(relpos_bf16.cuh, links_bf16.cuh) at T' = 1, 63, 65, 120, 350 with a
fully padded row and at L = 63, 65, 129, 1024 with and without the band,
their backward bit-identical over two runs, and each dtype's kernels of
#5 and #4 by name under the profiler; the bf16 kernels of #3
(attention_bf16.cuh's full-bias mode) at Tq = Tk = 1, 63, 65, 120, Tq !=
Tk both ways and chip_smoke.py's ALiBi shape with a fully masked row,
their fp32 output and statistics, the backward bit-identical over two
runs, and each dtype's kernels of #3 by name; and the int8 vocoder
rungs' int32 sums and one short utterance at 16 rows or fewer
(``torch._int_mm``'s floor on CUDA).

Tolerances: 1e-4 absolute for outputs and gradients of O(1) (fp32 sums in
another order); the DP's log-probabilities grow with T: they are held
against the plain loop run in float64, to 2 sqrt(T) ulp of the largest
magnitude near each row's maximum (about one ulp of rounding per step,
adding up as a random walk) and to the fp32 plain loop's own error farther
below it (see ``_dp_close``); Viterbi paths must be equal. The DP and the
Viterbi also run at shapes that split each sample over a thread-block
cluster (of 2, 4 and 8 blocks, ragged column groups, ties across the
groups), at the main path's shapes with the cluster sizes asserted, with a
plan the kernel cannot take (it must raise), and on a graph whose row
maximum sits on a dead end, where the plain loop's fp32 shift loses mass
that the kernel's online log-sum-exp keeps.

Marked ``cuda``: every test skips without a CUDA device. On a machine with
one (the JAX package need not be installed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import math

import pytest
import torch

from daspeech_torch.ops import dag_kernels as dk
from daspeech_torch.ops import dag_ref as dr
from daspeech_torch.ops import fused_attention as fa
from daspeech_torch.ops import fused_links as fl
from daspeech_torch.ops import fused_mrf as fm
from daspeech_torch.ops import fused_relpos as fr
from test_torch_dag_cluster import dead_end_inputs, j_long_inputs

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _randn(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).cuda()


def _bias(g, B, Tk, all_padded_row=False):
    keep = torch.randint(1, Tk + 1, (B,), generator=g)
    pad = torch.arange(Tk)[None, :] >= keep[:, None]
    if all_padded_row:
        pad[-1] = True
    return torch.where(pad, fa.NEG, 0.0).float().cuda()


@pytest.mark.parametrize("B,Tq,Tk,H", [(2, 1, 1, 1), (2, 37, 5, 2),
                                       (3, 70, 130, 8), (1, 240, 240, 8),
                                       (2, 600, 300, 8), (2, 1040, 1040, 4)])
def test_attention(gen, B, Tq, Tk, H):
    q = _randn(gen, B, Tq, H * 64, scale=0.125)
    k, v = _randn(gen, B, Tk, H * 64), _randn(gen, B, Tk, H * 64)
    bias = _bias(gen, B, Tk, all_padded_row=B > 1)
    got = fa.fused_attention_packed(q, k, v, bias, H)
    torch.cuda.synchronize()
    want = fa.attention_plain(q, k, v, bias, H)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("B,L,H,mtl", [(2, 1, 8, None), (2, 2, 8, None),
                                       (3, 129, 2, None), (2, 300, 8, 5),
                                       (1, 1024, 8, None)])
def test_links(gen, B, L, H, mtl):
    q, k = _randn(gen, B, L, H * 64), _randn(gen, B, L, H * 64)
    gates = torch.log_softmax(_randn(gen, B, L, H), dim=-1)
    ol = torch.randint(1, L + 1, (B,), generator=gen).cuda()
    sc = 1.0 / 8.0
    got = fl.fused_extract_links(q, k, gates, ol, H, sc, mtl)
    torch.cuda.synchronize()
    want = fl.links_plain(q, k, gates, ol, H, sc, mtl)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool((got[~finite] == -math.inf).all())
    if finite.any():
        assert (got[finite] - want[finite]).abs().max().item() <= TOL


@pytest.mark.parametrize("B,T,H", [(2, 1, 4), (2, 17, 4), (3, 129, 4)])
def test_relpos(gen, B, T, H):
    C = 256
    q, k, v = (_randn(gen, B, T, H * 64) for _ in range(3))
    a = _randn(gen, B, T, H * C, scale=0.3)
    e = fr.relpos_basis(T, C, device="cuda")[2].contiguous()
    bias = _bias(gen, B, T)
    got = fr.fused_attention_relpos(q, k, v, a, e, bias, H, 0.125)
    torch.cuda.synchronize()
    want = fr.relpos_plain(q, k, v, a, e, bias, H, 0.125)
    assert (got - want).abs().max().item() <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x = _randn(gen, 1, 4, 2 * 32)                   # head depth 32
    bias = torch.zeros((1, 4), device="cuda")
    with pytest.raises(ValueError, match="head depth"):
        fa.fused_attention_packed(x, x, x, bias, 2)
    y = _randn(gen, 1, 64, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_packed(y, y, y, torch.zeros((1, 64),
                                                       device="cuda"), 1)
    big = _randn(gen, 1, 1025, 64)
    with pytest.raises(ValueError, match="L <= 1024"):
        fl.fused_extract_links(big, big, torch.zeros((1, 1025, 1),
                                                     device="cuda"),
                               torch.tensor([1025], device="cuda"), 1, 0.1,
                               None)


def _max_err(got, want):
    return (got - want).abs().max().item()


def _seeds(gen, B):
    return torch.randint(-2 ** 31, 2 ** 31, (B,), generator=gen,
                         dtype=torch.int32).cuda()


# edge shapes of the tensor-core tiles: one query, one key, and a query
# tile one row over 64 against two key tiles, the second ragged
EDGE_SHAPES = [(2, 1, 130, 2, 0.1), (2, 65, 1, 2, 0.1), (2, 65, 130, 4, 0.1)]


@pytest.mark.parametrize("B,Tq,Tk,H,p", [(2, 1, 1, 1, 0.0), (2, 37, 5, 2, 0.1),
                                         (3, 70, 130, 8, 0.1),
                                         (2, 240, 120, 8, 0.0),
                                         (1, 240, 240, 8, 0.3),
                                         *EDGE_SHAPES])
def test_attention_dropout_and_backward(gen, B, Tq, Tk, H, p):
    q = _randn(gen, B, Tq, H * 64, scale=0.125)
    k, v = _randn(gen, B, Tk, H * 64), _randn(gen, B, Tk, H * 64)
    bias = _bias(gen, B, Tk, all_padded_row=B > 1)
    seeds = _seeds(gen, B) if p else None
    out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                      with_stats=True)
    assert _max_err(out, fa.attention_plain(q, k, v, bias, H, 1.0, p,
                                            seeds)) <= TOL
    do = _randn(gen, B, Tq, H * 64)
    got = fa.attention_bwd_kernel(q, k, v, bias, out, st, do, H, 1.0, p,
                                  seeds)
    torch.cuda.synchronize()
    want = fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p, seeds)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


@pytest.mark.parametrize("B,T,H,p", [(2, 1, 4, 0.0), (2, 17, 4, 0.1),
                                     (3, 129, 4, 0.1), (2, 300, 4, 0.0)])
def test_relpos_dropout_and_backward(gen, B, T, H, p):
    C = 256
    q, k, v = (_randn(gen, B, T, H * 64, scale=0.5) for _ in range(3))
    a = _randn(gen, B, T, H * C, scale=0.1)
    e = fr.relpos_basis(T, C, device="cuda")[2].contiguous()
    bias = _bias(gen, B, T, all_padded_row=B > 2)
    seeds = _seeds(gen, B) if p else None
    out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, 0.125, p, seeds,
                                   with_stats=True)
    assert _max_err(out, fr.relpos_plain(q, k, v, a, e, bias, H, 0.125, p,
                                         seeds)) <= TOL
    do = _randn(gen, B, T, H * 64)
    got = fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, 0.125,
                               p, seeds)
    torch.cuda.synchronize()
    want = fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, 0.125, p, seeds)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


@pytest.mark.parametrize("B,L,H,mtl", [(2, 1, 8, None), (2, 2, 8, None),
                                       (3, 129, 2, None), (2, 300, 8, 5),
                                       (1, 1024, 8, None)])
def test_links_backward(gen, B, L, H, mtl):
    q, k = _randn(gen, B, L, H * 64, scale=0.5), _randn(gen, B, L, H * 64)
    gates = torch.log_softmax(_randn(gen, B, L, H), dim=-1)
    ol = torch.randint(1, L + 1, (B,), generator=gen)
    ol[0] = L
    ol = ol.cuda()
    links, lse = fl.links_fwd_kernel(q, k, gates, ol, H, 0.125, mtl,
                                     with_lse=True)
    dlinks = _randn(gen, B, L, L)
    got = fl.links_bwd_kernel(q, k, gates, ol, links, lse, dlinks, H, 0.125,
                              mtl)
    torch.cuda.synchronize()
    want = fl.links_bwd_plain(q, k, gates, ol, dlinks, H, 0.125, mtl)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


def _dag_inputs(gen, B, T, L, ties=False):
    """Random links with row-normalized valid transitions; ragged graphs
    (ol < L) and targets (tl < T); one infeasible sample (tl > ol)."""
    ol = torch.randint(max(1, min(L, T)), L + 1, (B,), generator=gen)
    tl = torch.randint(1, T + 1, (B,), generator=gen)
    ol[0], tl[0] = L, T
    if B > 2:
        ol[-1], tl[-1] = 2, min(T, 3)
    scale = 0.0 if ties else 1.0
    x = torch.randn(B, L, L, generator=gen) * (1 + 2 * scale)
    i = torch.arange(L)
    valid = ((i[None, None, :] > i[None, :, None])
             & (i[None, None, :] < ol[:, None, None])
             & (i[None, :, None] < ol[:, None, None]))
    x = torch.where(valid, x, -math.inf)
    links = torch.where(valid, torch.log_softmax(x, dim=-1), -math.inf)
    match = torch.randn(B, T, L, generator=gen) - 2.0
    if ties:
        links = torch.where(valid, torch.round(links), links)
        match = torch.round(match)
    match = torch.where(i[None, None, :] < ol[:, None, None], match,
                        -math.inf)
    return (match.cuda().contiguous(), links.cuda().contiguous(), ol.cuda(),
            tl.cuda())


DP_BANDS = (0, 20, 40, 60, 70, 80)   # nats below the row's maximum


def _band_errs(got, exact):
    """Max |got - exact| in each band of DP_BANDS (distance of the entry
    below its row's maximum in ``exact``); inf where ``got`` is -inf (all
    the entry's terms underflowed). ``got`` may have no mass where
    ``exact`` has none."""
    got = got.double()
    fin_w, fin_g = torch.isfinite(exact), torch.isfinite(got)
    assert not (fin_g & ~fin_w).any()
    if got.dim() == 1:                                  # logprob [B]
        rowmax = torch.where(fin_w, exact, 0.0)
    else:
        rowmax = torch.where(fin_w, exact, -math.inf).amax(dim=-1,
                                                           keepdim=True)
        rowmax = torch.where(torch.isfinite(rowmax), rowmax, 0.0)
    gap = torch.where(fin_w, rowmax - exact, math.inf)
    d = torch.where(fin_g, (got - exact).abs(), math.inf)
    return [torch.where((gap >= lo) & (gap < hi), d, 0.0).max().item()
            for lo, hi in zip(DP_BANDS[:-1], DP_BANDS[1:])]


def _dp_close(got, plain, exact, T):
    """The kernel (``got``) and the fp32 plain loop against the loop in
    float64. The plain loop shifts each step by the previous row's maximum,
    so in fp32 a term more than ~87 nats below the shift underflows and the
    entries fed by it come out too small; the kernel takes each log-sum-exp
    online and loses less. Within 20 nats of the row's maximum the kernel
    is held to 2 sqrt(T) ulp of the largest magnitude, and in every band to
    the fp32 loop's error plus that."""
    big = max(float(torch.where(torch.isfinite(exact), exact,
                                0.0).abs().max()), 1.0)
    tol = 2.0 * math.sqrt(T) * 2.0 ** (math.floor(math.log2(big)) - 23)
    k, p = _band_errs(got, exact), _band_errs(plain, exact)
    assert k[0] <= tol, (k, tol)
    assert all(a <= b + tol for a, b in zip(k, p)), (k, p, tol)


# the last four split each sample over a cluster of 8, 2, 4 and 8 blocks
@pytest.mark.parametrize("B,T,L", [(2, 1, 5), (3, 7, 33), (3, 64, 240),
                                   (2, 16, 1024), (1, 16, 700), (2, 9, 33),
                                   (14, 32, 700), (4, 16, 1024)])
def test_dag_alpha_beta(gen, B, T, L):
    match, links, ol, tl = _dag_inputs(gen, B, T, L)
    got = dk.dag_loss_forward_kernel(match, links, ol, tl)
    torch.cuda.synchronize()
    plain = dr.dag_loss_forward_plain(match, links, ol, tl)
    exact = dr.dag_loss_forward_plain(match.double(), links.double(), ol, tl)
    for g, p, x in zip(got, plain, exact):
        _dp_close(g, p, x, T)
    if B > 2:
        assert got[0][-1].item() == -math.inf      # infeasible: -inf, no NaN


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dag_alpha_beta_at_j_long(gen, seed):
    """J-long's [14, 128, 700] on the inputs of
    ``test_torch_dag_cluster.py::test_plain_loop_against_float64_at_j_long``,
    where the fp32 plain loop is nats off float64 near a row's maximum: the
    kernel (clusters of 4) stays within its bound there."""
    match, links, ol, tl = (x.cuda().contiguous()
                            for x in j_long_inputs(seed))
    got = dk.dag_loss_forward_kernel(match, links, ol, tl)
    torch.cuda.synchronize()
    plain = dr.dag_loss_forward_plain(match, links, ol, tl)
    exact = dr.dag_loss_forward_plain(match.double(), links.double(), ol, tl)
    for g, p, x in zip(got, plain, exact):
        _dp_close(g, p, x, 128)
    assert dk.plan_for("dag_loss_forward", match) > 1


def test_dag_alpha_beta_behind_a_dead_end(gen):
    """alpha's row 1 peaks on the last vertex (no links out), beta's on
    vertex 0 (no links in), each with one other entry 120 nats below: the
    kernel's online log-sum-exp keeps the mass that the plain loop's shift
    by the previous row's maximum loses in fp32 (exp(-120) underflows)."""
    match, links, ol, tl = dead_end_inputs()
    got = dk.dag_loss_forward_kernel(match.cuda(), links.cuda(), ol.cuda(),
                                     tl.cuda())
    torch.cuda.synchronize()
    exact = dr.dag_loss_forward_plain(match.double(), links.double(), ol, tl)
    plain = dr.dag_loss_forward_plain(match, links, ol, tl)
    assert plain[1][0, 2, 2] == -math.inf and plain[0][1] == -math.inf
    for g, x in zip(got, exact):
        g = g.cpu().double()
        assert torch.equal(torch.isfinite(g), torch.isfinite(x))
        fin = torch.isfinite(x)
        assert (g[fin] - x[fin]).abs().max() <= 1e-5
    assert got[1][0, 2, 2].item() == -120.0 and got[0][1].item() == -120.0


# ties="all": every valid transition and match 0, so that every column's
# maximum ties over all its rows, across the 32-column groups that the
# blocks of a cluster own; the first argmax must win everywhere
@pytest.mark.parametrize("B,T,L,ties", [(2, 1, 5, False), (3, 7, 33, False),
                                        (3, 9, 33, True), (3, 64, 240, True),
                                        (2, 16, 1024, False),
                                        (1, 16, 700, False), (2, 9, 33, True),
                                        (14, 32, 700, False),
                                        (4, 16, 1024, True), (2, 8, 64, "all"),
                                        (1, 16, 700, "all")])
def test_dag_viterbi(gen, B, T, L, ties):
    match, links, ol, tl = _dag_inputs(gen, B, T, L, ties)
    if ties == "all":
        match = torch.where(torch.isfinite(match), 0.0, match)
        links = torch.where(torch.isfinite(links), 0.0, links)
    got = dk.dag_best_alignment_kernel(match, links, ol, tl)
    torch.cuda.synchronize()
    want = dr.dag_best_alignment_plain(match, links, ol, tl)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,T,L,cs_fb,cs_vit", [(80, 64, 240, 1, 1),
                                                (40, 64, 240, 1, 2),
                                                (14, 128, 700, 4, 8),
                                                (4, 64, 1024, 8, 8)])
def test_dag_cluster_sizes(gen, B, T, L, cs_fb, cs_vit):
    """The main path's shapes launch on the cluster sizes that the plan
    gives on a card of 132 SMs (the H100 SXM), counted by the wrappers."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the cluster sizes are those of a card of 132 SMs")
    match, links, ol, tl = _dag_inputs(gen, B, T, L)
    dk.dag_loss_forward_kernel.cluster_launches.clear()
    dk.dag_best_alignment_kernel.cluster_launches.clear()
    dk.dag_loss_forward_kernel(match, links, ol, tl)
    dk.dag_best_alignment_kernel(match, links, ol, tl)
    torch.cuda.synchronize()
    assert dk.dag_loss_forward_kernel.cluster_launches == {cs_fb: 1}
    assert dk.dag_best_alignment_kernel.cluster_launches == {cs_vit: 1}
    for name in ("dag_loss_forward", "dag_best_alignment"):
        assert dk.max_active_clusters(name, match) >= 1


def test_dag_refuses_a_plan_it_cannot_take(gen, monkeypatch):
    """A cluster size the kernel's layout does not take (not a power of
    two, more blocks than the 2 column groups of L = 64, over the portable
    8) is refused and raises; nothing falls back to the plain loop."""
    match, links, ol, tl = _dag_inputs(gen, 2, 4, 64)
    for fn in (dk.dag_loss_forward_kernel, dk.dag_best_alignment_kernel):
        for cs in (3, 4, 16):
            monkeypatch.setattr(dk, "plan_for", lambda *a: cs)
            with pytest.raises(RuntimeError, match="cudaError_t"):
                fn(match, links, ol, tl)
            monkeypatch.undo()


def test_training_wrappers_refuse_what_the_kernels_do_not_take(gen):
    big = _randn(gen, 1, 3, 1025)
    n = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="L <= 1024"):
        dk.dag_loss_forward_kernel(big, _randn(gen, 1, 1025, 1025), n, n)
    with pytest.raises(ValueError, match="bad shapes"):
        dk.dag_best_alignment_kernel(_randn(gen, 1, 3, 4),
                                     _randn(gen, 1, 5, 5), n, n)
    x = _randn(gen, 1, 4, 64)
    bias = torch.zeros((1, 4), device="cuda")
    with pytest.raises(ValueError, match="CUDA"):      # seeds on the CPU
        fa.attention_fwd_kernel(x, x, x, bias, 1, 1.0, 0.1,
                                torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="bad shapes"):
        fa.attention_bwd_kernel(x, x, x, bias, x, torch.zeros((1, 1, 3, 2),
                                                              device="cuda"),
                                x, 1, 1.0)


def _heads(x, H):
    """[B, T, H*64] -> contiguous head-major [B, H, T, 64]."""
    B, T, _ = x.shape
    return x.reshape(B, T, H, 64).transpose(1, 2).contiguous()


@pytest.mark.parametrize("B,Tq,Tk,H,p", [(2, 1, 1, 1, 0.0),
                                         (2, 37, 5, 2, 0.1),
                                         (3, 70, 130, 4, 0.1),
                                         (2, 800, 300, 4, 0.0),
                                         (1, 1040, 1040, 4, 0.0),
                                         (2, 700, 700, 8, 0.1),
                                         *EDGE_SHAPES])
def test_head_major_attention_forward_and_backward(gen, B, Tq, Tk, H, p):
    """Tq != Tk, a fully padded row (B > 1), dropout on."""
    q = _randn(gen, B, H, Tq, 64, scale=0.125)
    k, v = _randn(gen, B, H, Tk, 64), _randn(gen, B, H, Tk, 64)
    bias = _bias(gen, B, Tk, all_padded_row=B > 1)
    seeds = _seeds(gen, B) if p else None
    out, st = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds,
                                         with_stats=True)
    assert _max_err(out, fa.attention_hm_plain(q, k, v, bias, 1.0, p,
                                               seeds)) <= TOL
    do = _randn(gen, B, H, Tq, 64)
    got = fa.attention_hm_bwd_kernel(q, k, v, bias, out, st, do, 1.0, p,
                                     seeds)
    torch.cuda.synchronize()
    want = fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p, seeds)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_head_major_kernel_drops_what_the_packed_kernel_drops(gen, p):
    """Both kernels key dropout by (row seed, j / 4, i, h): at a shape both
    routes take they agree to rounding, forward and backward."""
    B, Tq, Tk, H = 3, 70, 130, 4
    q = _randn(gen, B, Tq, H * 64, scale=0.125)
    k, v = _randn(gen, B, Tk, H * 64), _randn(gen, B, Tk, H * 64)
    bias = _bias(gen, B, Tk, all_padded_row=True)
    seeds = _seeds(gen, B) if p else None
    out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                      with_stats=True)
    out_h, st_h = fa.attention_hm_fwd_kernel(
        _heads(q, H), _heads(k, H), _heads(v, H), bias, 1.0, p, seeds,
        with_stats=True)
    assert _max_err(_heads(out, H), out_h) <= 1e-6
    do = _randn(gen, B, Tq, H * 64)
    got = fa.attention_bwd_kernel(q, k, v, bias, out, st, do, H, 1.0, p,
                                  seeds)
    got_h = fa.attention_hm_bwd_kernel(
        _heads(q, H), _heads(k, H), _heads(v, H), bias, out_h, st_h,
        _heads(do, H), 1.0, p, seeds)
    torch.cuda.synchronize()
    for a, b in zip(got, got_h):
        assert _max_err(_heads(a, H), b) <= 1e-6


@pytest.mark.parametrize("head_major", [False, True])
def test_attention_backward_is_bit_identical_over_two_runs(gen, head_major):
    """Two kernels and no atomics: the same inputs give the same bits."""
    B, Tq, Tk, H, p = 3, 130, 200, 4, 0.1
    q = _randn(gen, B, Tq, H * 64, scale=0.125)
    k, v = _randn(gen, B, Tk, H * 64), _randn(gen, B, Tk, H * 64)
    do = _randn(gen, B, Tq, H * 64)
    bias = _bias(gen, B, Tk, all_padded_row=True)
    seeds = _seeds(gen, B)
    if head_major:
        q, k, v, do = (_heads(x, H) for x in (q, k, v, do))
        out, st = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds,
                                             with_stats=True)
        runs = [fa.attention_hm_bwd_kernel(q, k, v, bias, out, st, do, 1.0, p,
                                           seeds) for _ in range(2)]
    else:
        out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                          with_stats=True)
        runs = [fa.attention_bwd_kernel(q, k, v, bias, out, st, do, H, 1.0, p,
                                        seeds) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_attention_wrappers_refuse_misaligned_tensors(gen):
    """cp.async copies 16-byte chunks: a tensor that starts 4 bytes off a
    16-byte boundary is refused, not launched."""
    B, T, H = 1, 8, 2
    flat = torch.zeros(B * T * H * 64 + 1, device="cuda")
    off = flat[1:].view(B, T, H * 64)
    x = _randn(gen, B, T, H * 64)
    bias = torch.zeros((B, T), device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        fa.fused_attention_packed(off, x, x, bias, H)
    with pytest.raises(ValueError, match="16-byte"):
        fa.fused_attention(off.view(B, H, T, 64), _heads(x, H), _heads(x, H),
                           bias)
    out, st = fa.attention_fwd_kernel(x, x, x, bias, H, 1.0, with_stats=True)
    with pytest.raises(ValueError, match="16-byte"):
        fa.attention_bwd_kernel(x, x, x, bias, out, st, off, H, 1.0)


def test_head_major_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x = _randn(gen, 1, 2, 4, 32)                   # head depth 32
    bias = torch.zeros((1, 4), device="cuda")
    with pytest.raises(ValueError, match="head depth"):
        fa.fused_attention(x, x, x, bias)
    y = _randn(gen, 1, 4, 2, 64).transpose(1, 2)   # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention(y, y, y, bias)
    z = _randn(gen, 1, 4, 64)                      # packed, not [B, H, T, d]
    with pytest.raises(ValueError, match="B, H, T, d"):
        fa.fused_attention(z, z, z, bias)


V1_KERNELS, V1_DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3


def _mrf_inputs(gen, B, C, T, kernel_sizes, dilations, bias_scale=0.1):
    """x [B, C, T] ~ N(0, 1), each conv's taps N(0, 1 / (k C)) (the level's
    output stays of order 1) and biases N(0, bias_scale)."""
    n_dil = len(dilations[0])
    W = torch.cat([torch.randn(k, C, C, generator=gen) / math.sqrt(k * C)
                   for k in kernel_sizes for _ in range(2 * n_dil)])
    biases = torch.randn(2 * n_dil * len(kernel_sizes), C,
                         generator=gen) * bias_scale
    return _randn(gen, B, C, T), W.cuda(), biases.cuda()


@pytest.mark.parametrize("B,C,T,tile", [
    (2, 128, 200, 64),      # T not a multiple of the tile
    (1, 128, 128, 64),      # the route's threshold (128 // f frames)
    (2, 64, 257, 64),       # just above it at f = 2
    (1, 32, 513, 128),      # just above it at f = 4, the larger tile
    (3, 32, 1000, 64),
    (2, 128, 333, 128),
    (1, 8, 2100, 64),       # a block of 128 threads
    (1, 128, 6016, None)])  # a chunk window, the tile the wrapper picks
def test_mrf_level(gen, B, C, T, tile):
    x, W, biases = _mrf_inputs(gen, B, C, T, V1_KERNELS, V1_DILATIONS)
    got = fm.mrf_level(x, W, biases, V1_KERNELS, V1_DILATIONS, tile)
    torch.cuda.synchronize()
    want = fm.mrf_level_ref(x, W, biases, V1_KERNELS, V1_DILATIONS)
    assert torch.isfinite(got).all()
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("T", [40, 150])
def test_mrf_level_halo_at_both_ends(gen, k, T):
    """One block of kernel k, large biases: a chained conv that leaves
    bias-made values at frames outside [0, T) (the second conv's SAME
    padding) is wrong within the halo of both ends."""
    halo = sum((k - 1) // 2 * (d + 1) for d in (1, 3, 5))
    x, W, biases = _mrf_inputs(gen, 2, 64, T, (k,), ((1, 3, 5),),
                               bias_scale=1.0)
    got = fm.mrf_level(x, W, biases, (k,), ((1, 3, 5),))
    torch.cuda.synchronize()
    want = fm.mrf_level_ref(x, W, biases, (k,), ((1, 3, 5),))
    for ends in (slice(0, halo), slice(max(0, T - halo), T), slice(0, T)):
        assert _max_err(got[..., ends], want[..., ends]) <= TOL


def test_mrf_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x, W, biases = _mrf_inputs(gen, 1, 48, 256, V1_KERNELS, V1_DILATIONS)
    with pytest.raises(ValueError, match="power of two"):
        fm.mrf_level(x, W, biases, V1_KERNELS, V1_DILATIONS)
    x, W, biases = _mrf_inputs(gen, 1, 32, 256, V1_KERNELS, V1_DILATIONS)
    with pytest.raises(ValueError, match="tile"):
        fm.mrf_level(x, W, biases, V1_KERNELS, V1_DILATIONS, 96)
    with pytest.raises(ValueError, match="contiguous"):
        fm.mrf_level(x.transpose(1, 2).contiguous().transpose(1, 2), W,
                     biases, V1_KERNELS, V1_DILATIONS)
    with pytest.raises(ValueError, match="bad shapes"):
        fm.mrf_level(x, W[:-1], biases, V1_KERNELS, V1_DILATIONS)
    x4, W4, b4 = _mrf_inputs(gen, 1, 32, 256, (4,), ((1,),))
    with pytest.raises(ValueError, match="odd sizes"):
        fm.mrf_level(x4, W4, b4, (4,), ((1,),))
    with pytest.raises(RuntimeError, match="inference only"):
        fm.mrf_level(x, W.requires_grad_(), biases, V1_KERNELS,
                     V1_DILATIONS)


def _ffn_params(gen, C, Fd):
    """LayerNorm's scale 1 + N(0, 0.1) and shift, w1 [F, C] and w2 [C, F]
    N(0, 1 / fan_in), biases N(0, 0.1): the output stays of order 1."""
    return (1.0 + _randn(gen, C, scale=0.1), _randn(gen, C, scale=0.1),
            _randn(gen, Fd, C, scale=C ** -0.5), _randn(gen, Fd, scale=0.1),
            _randn(gen, C, Fd, scale=Fd ** -0.5), _randn(gen, C, scale=0.1))


@pytest.mark.parametrize("B,T,Fd,p", [(1, 1, 2048, 0.0),      # one row
                                      (2, 37, 2048, 0.1),     # 74 % 64 != 0
                                      (3, 50, 100, 0.1),      # F % 64 != 0
                                      (2, 120, 2048, 0.3),
                                      (1, 5, 1, 0.1)])
def test_fused_ffn_forward_and_backward(gen, B, T, Fd, p):
    """dout scaled by 1 / sqrt(B T): the weight gradients, sums over the
    B·T rows, stay of order 1 as a mean loss's would."""
    from daspeech_torch.ops import fused_ffn as ff

    x = _randn(gen, B, T, 256)
    params = _ffn_params(gen, 256, Fd)
    seeds = _seeds(gen, B) if p else None
    got = ff.ffn_fwd_kernel(x, *params, seeds, p, p)
    assert _max_err(got, ff.ffn_plain(x, *params, seeds, p, p)) <= TOL
    do = _randn(gen, B, T, 256, scale=(B * T) ** -0.5)
    got = ff.ffn_bwd_kernel(x, *params, do, seeds, p, p)
    torch.cuda.synchronize()
    want = ff.ffn_bwd_plain(x, *params, do, seeds, p, p)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


def test_fused_ffn_weight_gradients_are_bit_identical(gen):
    from daspeech_torch.ops import fused_ffn as ff

    B, T = 4, 300
    x, do = _randn(gen, B, T, 256), _randn(gen, B, T, 256, scale=0.03)
    params = _ffn_params(gen, 256, 2048)
    seeds = _seeds(gen, B)
    a = ff.ffn_bwd_kernel(x, *params, do, seeds, 0.1, 0.1)
    b = ff.ffn_bwd_kernel(x, *params, do, seeds, 0.1, 0.1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# the tensor-core MRF kernel (implicit GEMM, 3xTF32): each width of
# config_v1's fused levels at every tile it takes, ragged lengths, and its
# sum order: the same bits at every tile, and in a window that holds a
# frame's receptive field the bits of the whole sequence
@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("T", [1, 65, 513])
def test_mrf_level_tensor_cores_every_tile(gen, C, T):
    x, W, biases = _mrf_inputs(gen, 2, C, T, V1_KERNELS, V1_DILATIONS)
    outs = [fm.mrf_level(x, W, biases, V1_KERNELS, V1_DILATIONS, t)
            for t in fm.TILES]
    torch.cuda.synchronize()
    want = fm.mrf_level_ref(x, W, biases, V1_KERNELS, V1_DILATIONS)
    for o in outs:
        assert _max_err(o, want) <= TOL
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_level_window_reproduces_the_whole_sequence(gen, dtype):
    halo = sum((k - 1) // 2 * (d + 1) for k in V1_KERNELS for d in (1, 3, 5))
    x, W, biases = _mrf_inputs(gen, 2, 128, 3000, V1_KERNELS, V1_DILATIONS)
    W = W.to(dtype)
    whole = fm.mrf_level(x, W, biases, V1_KERNELS, V1_DILATIONS)
    a, n = 1237, 300
    win = x[1:, :, a - halo:a + n + halo].contiguous()
    part = fm.mrf_level(win, W, biases, V1_KERNELS, V1_DILATIONS)
    torch.cuda.synchronize()
    assert torch.equal(part[:, :, halo:halo + n], whole[1:, :, a:a + n])


# the fused FFN on thread-block clusters (F split over 2 to 8 blocks, two
# slices a block at F = 4000; at 3, 5, 6 and 7 blocks the 32 rows of a tile
# split into unequal shares), ragged row tiles, dropout off and on; forward
# and backward the same bits over two runs
@pytest.mark.parametrize("B,T,Fd,p", [(3, 29, 300, 0.0), (3, 29, 300, 0.1),
                                      (2, 77, 1000, 0.1), (1, 50, 4000, 0.0),
                                      (5, 31, 2048, 0.1), (1, 33, 2048, 0.0),
                                      (2, 45, 600, 0.1), (1, 90, 1100, 0.0),
                                      (2, 47, 1536, 0.1), (1, 95, 1700, 0.0)])
def test_fused_ffn_on_clusters(gen, B, T, Fd, p):
    from daspeech_torch.ops import fused_ffn as ff

    x = _randn(gen, B, T, 256)
    params = _ffn_params(gen, 256, Fd)
    seeds = _seeds(gen, B) if p else None
    do = _randn(gen, B, T, 256, scale=(B * T) ** -0.5)
    out = ff.ffn_fwd_kernel(x, *params, seeds, p, p)
    got = ff.ffn_bwd_kernel(x, *params, do, seeds, p, p)
    again = (ff.ffn_fwd_kernel(x, *params, seeds, p, p),
             ff.ffn_bwd_kernel(x, *params, do, seeds, p, p))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _max_err(out, ff.ffn_plain(x, *params, seeds, p, p)) <= TOL
    for g, w in zip(got, ff.ffn_bwd_plain(x, *params, do, seeds, p, p)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL
    assert torch.equal(out, again[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again[1]))


def _full_bias(gen, B, H, Tq, Tk, masked_row):
    """Random scores with -1e30 on each batch row's last keys and, with
    ``masked_row``, one fully masked query row."""
    bias = _randn(gen, B, H, Tq, Tk)
    pad = _bias(gen, B, Tk)[:, None, None, :]
    bias = torch.where(pad < 0, fa.NEG, bias)
    if masked_row:
        bias[-1, 0, Tq // 2] = fa.NEG
    return bias.contiguous()


@pytest.mark.parametrize("B,H,Tq,Tk,p", [(2, 1, 1, 1, 0.0),
                                         (2, 2, 37, 5, 0.1),
                                         (3, 4, 70, 130, 0.1),
                                         (2, 4, 120, 120, 0.1),
                                         (1, 8, 300, 240, 0.0)])
def test_full_bias_attention_forward_and_backward(gen, B, H, Tq, Tk, p):
    """Tq != Tk, ragged tiles, a fully masked row (B > 1), dropout on."""
    q = _randn(gen, B, H, Tq, 64, scale=0.125)
    k, v = _randn(gen, B, H, Tk, 64), _randn(gen, B, H, Tk, 64)
    bias = _full_bias(gen, B, H, Tq, Tk, masked_row=B > 1)
    seed = _seeds(gen, 1) if p else None
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias, 0.7, p, seed,
                                         with_stats=True)
    assert _max_err(out, fa.attention_full_bias_plain(q, k, v, bias, 0.7, p,
                                                      seed)) <= TOL
    do = _randn(gen, B, H, Tq, 64)
    got = fa.attention_fb_bwd_kernel(q, k, v, bias, out, st, do, 0.7, p,
                                     seed)
    torch.cuda.synchronize()
    want = fa.attention_full_bias_bwd_plain(q, k, v, bias, do, 0.7, p, seed)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


def test_full_bias_kernel_equals_head_major_on_a_column_bias(gen):
    """bias4 = #2's column bias broadcast over heads and queries, p = 0:
    the same scores, so the same results to rounding. #3's backward takes
    dk and dv from the stored dS and P∘Z where #2 recomputes Sᵀ, so they sum
    in another order: each is held to TOL, as against its plain version."""
    B, H, Tq, Tk = 3, 4, 70, 130
    q = _randn(gen, B, H, Tq, 64, scale=0.125)
    k, v, do = (_randn(gen, B, H, T, 64) for T in (Tk, Tk, Tq))
    bias = _bias(gen, B, Tk, all_padded_row=True)
    bias4 = bias[:, None, None, :].expand(B, H, Tq, Tk).contiguous()
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0,
                                         with_stats=True)
    out_h, st_h = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0,
                                             with_stats=True)
    assert _max_err(out, out_h) <= TOL
    got = fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do, 1.0)
    want = fa.attention_hm_bwd_kernel(q, k, v, bias, out_h, st_h, do, 1.0)
    torch.cuda.synchronize()
    for g, w in zip(got[:3], want):
        assert _max_err(g, w) <= TOL


def test_new_wrappers_refuse_what_the_kernels_do_not_take(gen):
    from daspeech_torch.ops import fused_ffn as ff

    x = _randn(gen, 1, 2, 4, 32)                   # head depth 32
    b4 = torch.zeros((1, 2, 4, 4), device="cuda")
    with pytest.raises(ValueError, match="head depth"):
        fa.fused_attention_full_bias(x, x, x, b4, 0, 1.0, 0.0, False)
    y = _randn(gen, 1, 4, 2, 64).transpose(1, 2)   # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_attention_full_bias(y, y, y, b4, 0, 1.0, 0.0, False)
    z = _randn(gen, 1, 2, 4, 64)
    with pytest.raises(TypeError, match="float32"):
        fa.fused_attention_full_bias(z, z, z, b4.double(), 0, 1.0, 0.0,
                                     False)
    with pytest.raises(ValueError, match="bad shapes"):
        fa.fused_attention_full_bias(z, z, z, b4[:, :, :3].contiguous(), 0,
                                     1.0, 0.0, False)
    params = _ffn_params(gen, 256, 64)
    with pytest.raises(ValueError, match="width"):
        ff.fused_ffn(_randn(gen, 1, 3, 128), *_ffn_params(gen, 128, 64), 0,
                     0.0, 0.0, False)
    xt = _randn(gen, 1, 256, 3).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ff.fused_ffn(xt, *params, 0, 0.0, 0.0, False)
    with pytest.raises(TypeError, match="float32"):
        ff.fused_ffn(_randn(gen, 1, 3, 256).double(), *params, 0, 0.0, 0.0,
                     False)
    with pytest.raises(ValueError, match="bad shapes"):
        ff.ffn_fwd_kernel(_randn(gen, 1, 3, 256), *params[:2],
                          params[2][:, :128].contiguous(), *params[3:])


# ragged lengths of the chunked-score tensor-core kernels (#5, #3): one
# row, a tile one short of and one over 64, and serving's T' = 120 and 300
RAGGED_T = (1, 63, 65, 120, 300)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("T", RAGGED_T)
def test_relpos_tensor_core_forward_and_backward(gen, T, p):
    """#5's inference forward and backward (tensor cores) and its training
    forward (FMA) against the plain versions, a fully padded batch row
    included, dropout on the same bits; the backward bit-identical over two
    runs."""
    B, H, C, sc = 3, 4, fr.POS_DIM, 0.125
    q, k, v, do = (_randn(gen, B, T, H * 64, scale=0.5) for _ in range(4))
    a = _randn(gen, B, T, H * C, scale=0.1)
    e = fr.relpos_basis(T, C, device="cuda")[2].contiguous()
    bias = _bias(gen, B, T, all_padded_row=True)
    seeds = _seeds(gen, B) if p else None
    want = fr.relpos_plain(q, k, v, a, e, bias, H, sc, p, seeds)
    out, _ = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p, seeds)
    assert _max_err(out, want) <= TOL
    out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p, seeds,
                                   with_stats=True)
    assert _max_err(out, want) <= TOL
    runs = [fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, sc, p,
                                 seeds) for _ in range(2)]
    torch.cuda.synchronize()
    want = fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, sc, p, seeds)
    for g, again, w in zip(*runs, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL
        assert torch.equal(g, again)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("Tq,Tk", [(T, T) for T in RAGGED_T] + [(65, 130)])
def test_full_bias_tensor_core_forward_and_backward(gen, Tq, Tk, p):
    """#3's inference forward and backward (tensor cores) and its training
    forward (FMA) against the plain versions, one fully masked row, dropout
    on; dbias and the other gradients bit-identical over two runs."""
    B, H, sc = 2, 4, 0.125
    q = _randn(gen, B, H, Tq, 64)
    k, v, do = (_randn(gen, B, H, T, 64) for T in (Tk, Tk, Tq))
    bias = _full_bias(gen, B, H, Tq, Tk, masked_row=True)
    seed = _seeds(gen, 1) if p else None
    want = fa.attention_full_bias_plain(q, k, v, bias, sc, p, seed)
    out, _ = fa.attention_fb_fwd_kernel(q, k, v, bias, sc, p, seed)
    assert _max_err(out, want) <= TOL
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias, sc, p, seed,
                                         with_stats=True)
    assert _max_err(out, want) <= TOL
    runs = [fa.attention_fb_bwd_kernel(q, k, v, bias, out, st, do, sc, p,
                                       seed) for _ in range(2)]
    torch.cuda.synchronize()
    want = fa.attention_full_bias_bwd_plain(q, k, v, bias, do, sc, p, seed)
    for g, again, w in zip(*runs, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL
        assert torch.equal(g, again)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_relpos_kernel_with_a_zero_equals_head_major(gen, p):
    """With a = 0 the rel-pos score is q·kᵀ: #5 computes #2's function, and
    drops what #2 drops (both key by the row seed, j / 4, i, h). Held
    within 1e-6, forward (inference and training) and backward."""
    B, T, H, sc = 3, 130, 4, 0.125
    q, k, v, do = (_randn(gen, B, T, H * 64, scale=0.5) for _ in range(4))
    a = torch.zeros((B, T, H * fr.POS_DIM), device="cuda")
    e = fr.relpos_basis(T, fr.POS_DIM, device="cuda")[2].contiguous()
    bias = _bias(gen, B, T, all_padded_row=True)
    seeds = _seeds(gen, B) if p else None
    qh, kh, vh, dh = (_heads(x, H) for x in (q, k, v, do))
    for stats_on in (False, True):
        out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p, seeds,
                                       with_stats=stats_on)
        out_h, st_h = fa.attention_hm_fwd_kernel(qh, kh, vh, bias, sc, p,
                                                 seeds, with_stats=stats_on)
        assert _max_err(_heads(out, H), out_h) <= 1e-6
    got = fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, sc, p,
                               seeds)
    got_h = fa.attention_hm_bwd_kernel(qh, kh, vh, bias, out_h, st_h, dh, sc,
                                       p, seeds)
    torch.cuda.synchronize()
    for x, y in zip(got[:3], got_h):
        assert _max_err(_heads(x, H), y) <= 1e-6


def test_chunked_wrappers_refuse_what_the_kernels_do_not_take(gen):
    """#5 and #3 copy operand rows by 16-byte cp.async: a tensor 4 bytes
    off a 16-byte boundary is refused, as are a position depth other than
    256 and a bias of the wrong shape."""
    B, T, H = 1, 8, 2
    x = _randn(gen, B, T, H * 64)
    a = _randn(gen, B, T, H * fr.POS_DIM)
    e = fr.relpos_basis(T, fr.POS_DIM, device="cuda")[2].contiguous()
    bias = torch.zeros((B, T), device="cuda")
    flat = torch.zeros(a.numel() + 1, device="cuda")
    a_off = flat[1:].view(a.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fr.fused_attention_relpos(x, x, x, a_off, e, bias, H, 0.125)
    with pytest.raises(ValueError, match="unsupported"):
        fr.fused_attention_relpos(x, x, x, a[..., :H * 128].contiguous(),
                                  e[:, :128].contiguous(), bias, H, 0.125)
    out, st = fr.relpos_fwd_kernel(x, x, x, a, e, bias, H, 0.125,
                                   with_stats=True)
    x_off = torch.zeros(x.numel() + 1, device="cuda")[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fr.relpos_bwd_kernel(x, x, x, a, e, bias, out, st, x_off, H, 0.125)
    qh = _heads(x, H)
    b4 = torch.zeros(B * H * T * T + 1, device="cuda")[1:].view(B, H, T, T)
    with pytest.raises(ValueError, match="16-byte"):
        fa.fused_attention_full_bias(qh, qh, qh, b4, 0, 0.125, 0.0, False)
    with pytest.raises(ValueError, match="bad shapes"):
        fa.fused_attention_full_bias(qh, qh, qh, b4[..., :4].contiguous(), 0,
                                     0.125, 0.0, False)


# lengths of the register-tiled FMA training forward (#1, #2, #5): one row,
# a tile one short of and one over 64, the Conformer's T' = 120 and 300,
# the decoder's 240, J-long's encoder (350) and FastSpeech 2's 1040 frames
FMA_T = (1, 63, 65, 120, 240, 300, 350, 1040)


def _fma_case(gen, kind, T, p, B=2):
    """Inputs of one training forward of ``kind`` ("packed", "head_major"
    or "relpos") at T' = T over B rows, a fully padded last row, and its
    three calls: (forward, plain forward, backward kernel, plain
    backward)."""
    H, sc = 4, 0.125
    q, k, v, do = (_randn(gen, B, T, H * 64, scale=0.5) for _ in range(4))
    bias = _bias(gen, B, T, all_padded_row=True)
    seeds = _seeds(gen, B) if p else None
    if kind == "relpos":
        a = _randn(gen, B, T, H * fr.POS_DIM, scale=0.1)
        e = fr.relpos_basis(T, fr.POS_DIM, device="cuda")[2].contiguous()
        x = (q, k, v, a, e, bias)
        return (lambda: fr.relpos_fwd_kernel(*x, H, sc, p, seeds,
                                             with_stats=True),
                lambda: fr.relpos_plain(*x, H, sc, p, seeds),
                lambda o, st: fr.relpos_bwd_kernel(*x, o, st, do, H, sc, p,
                                                   seeds),
                lambda: fr.relpos_bwd_plain(*x, do, H, sc, p, seeds))
    if kind == "head_major":
        q, k, v, do = (_heads(t, H) for t in (q, k, v, do))
        return (lambda: fa.attention_hm_fwd_kernel(q, k, v, bias, sc, p,
                                                   seeds, with_stats=True),
                lambda: fa.attention_hm_plain(q, k, v, bias, sc, p, seeds),
                lambda o, st: fa.attention_hm_bwd_kernel(
                    q, k, v, bias, o, st, do, sc, p, seeds),
                lambda: fa.attention_hm_bwd_plain(q, k, v, bias, do, sc, p,
                                                  seeds))
    return (lambda: fa.attention_fwd_kernel(q, k, v, bias, H, sc, p, seeds,
                                            with_stats=True),
            lambda: fa.attention_plain(q, k, v, bias, H, sc, p, seeds),
            lambda o, st: fa.attention_bwd_kernel(q, k, v, bias, o, st, do, H,
                                                  sc, p, seeds),
            lambda: fa.attention_bwd_plain(q, k, v, bias, do, H, sc, p,
                                           seeds))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("T", FMA_T)
@pytest.mark.parametrize("kind", ["packed", "head_major", "relpos"])
def test_fma_training_forward(gen, kind, T, p):
    """The FMA training forward against the plain version (a fully padded
    row, dropout on the same bits), bit-identical over two runs, and its
    statistics fed into the tensor-core backward, whose gradients must
    match the plain backward."""
    _check_fma_case(*_fma_case(gen, kind, T, p))


# grids a little over one wave of blocks, whose keys the launcher splits:
# 17 query tiles x 4 heads x 4 rows (272 blocks), 6 x 4 x 14 (336)
FMA_SPLIT = ((4, 1040), (14, 350))


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T", FMA_SPLIT)
@pytest.mark.parametrize("kind", ["packed", "head_major", "relpos"])
def test_fma_training_forward_key_split(gen, kind, B, T, p):
    """As :func:`test_fma_training_forward` where the keys of a query tile
    are split over several blocks and merged."""
    _check_fma_case(*_fma_case(gen, kind, T, p, B))


@pytest.mark.parametrize("B,split", [(2, False), (4, True)])
def test_fma_key_split_merges_in_a_second_kernel(gen, B, split):
    """At 1040 keys over B = 4 rows (272 blocks) the training forward runs
    the merge kernel after its own; over B = 2 (136 blocks, one wave) it
    does not."""
    fwd = _fma_case(gen, "head_major", 1040, 0.1, B)[0]
    fwd()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("attn_fma_fwd_kernel" in n for n in names)
    assert any("attn_fma_combine_kernel" in n for n in names) == split


def _check_fma_case(fwd, plain, bwd, bwd_plain):
    """The calls of :func:`_fma_case`: the forward bit-identical over two
    runs and within TOL of plain, its statistics through the backward."""
    out, st = fwd()
    again = fwd()
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(st, again[1])
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert _max_err(out, plain()) <= TOL
    got = bwd(out, st)
    torch.cuda.synchronize()
    for g, w in zip(got, bwd_plain()):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T", [(2, 63), (2, 240), (2, 1040), (4, 1040)])
def test_fma_training_forward_packed_equals_head_major(gen, B, T, p):
    """One kernel serves both layouts by strides: their training forwards
    agree within 1e-6, output and statistics (B = 4: the keys split)."""
    H = 4
    q, k, v = (_randn(gen, B, T, H * 64, scale=0.5) for _ in range(3))
    bias = _bias(gen, B, T, all_padded_row=True)
    seeds = _seeds(gen, B) if p else None
    out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 0.125, p, seeds,
                                      with_stats=True)
    out_h, st_h = fa.attention_hm_fwd_kernel(
        _heads(q, H), _heads(k, H), _heads(v, H), bias, 0.125, p, seeds,
        with_stats=True)
    torch.cuda.synchronize()
    assert _max_err(_heads(out, H), out_h) <= 1e-6
    assert _max_err(st, st_h) <= 1e-6


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,T", [(2, 1), (2, 65), (2, 350), (14, 350)])
def test_fma_relpos_with_a_zero_equals_head_major(gen, B, T, p):
    """With a = 0 the rel-pos training forward sums the (q, k) chunk first
    and then zeros: #2's training forward within 1e-6, statistics too
    (B = 14: the keys split alike)."""
    H, sc = 4, 0.125
    q, k, v = (_randn(gen, B, T, H * 64, scale=0.5) for _ in range(3))
    a = torch.zeros((B, T, H * fr.POS_DIM), device="cuda")
    e = fr.relpos_basis(T, fr.POS_DIM, device="cuda")[2].contiguous()
    bias = _bias(gen, B, T, all_padded_row=True)
    seeds = _seeds(gen, B) if p else None
    out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p, seeds,
                                   with_stats=True)
    out_h, st_h = fa.attention_hm_fwd_kernel(
        _heads(q, H), _heads(k, H), _heads(v, H), bias, sc, p, seeds,
        with_stats=True)
    torch.cuda.synchronize()
    assert _max_err(_heads(out, H), out_h) <= 1e-6
    assert _max_err(st, st_h) <= 1e-6


# link extraction on live tiles: lengths one short of and one over a tile,
# two tiles and one row over, and the 1024-vertex cap, with and without the
# transition band; then J-long's [14, 700] at H = 8
LINK_EDGES = [(B, L, 8, mtl) for B, L in ((3, 63), (3, 65), (2, 129),
                                          (1, 1024))
              for mtl in (None, 5)] + [(14, 700, 8, None)]


@pytest.mark.parametrize("B,L,H,mtl", LINK_EDGES)
def test_links_live_tiles_forward_and_backward(gen, B, L, H, mtl):
    """The forward (lse kernel and fold over the live tiles) and the
    tensor-core backward against the plain versions, ragged out_len down
    to 1 (a graph with no valid transition): the same -inf pattern, no NaN,
    a finite lse_h on every row, the gradients within TOL and bit-identical
    over two runs."""
    q, k = _randn(gen, B, L, H * 64, scale=0.5), _randn(gen, B, L, H * 64)
    gates = torch.log_softmax(_randn(gen, B, L, H), dim=-1)
    ol = torch.randint(1, L + 1, (B,), generator=gen)
    ol[0] = L
    ol[-1] = 1 if B > 1 else L
    ol = ol.cuda()
    sc = 0.125
    links, lse = fl.links_fwd_kernel(q, k, gates, ol, H, sc, mtl,
                                     with_lse=True)
    torch.cuda.synchronize()
    want = fl.links_plain(q, k, gates, ol, H, sc, mtl)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(links), finite)
    assert bool((links[~finite] == -math.inf).all())
    assert torch.isfinite(lse).all()
    if finite.any():
        assert (links[finite] - want[finite]).abs().max().item() <= TOL
    dlinks = _randn(gen, B, L, L)
    runs = [fl.links_bwd_kernel(q, k, gates, ol, links, lse, dlinks, H, sc,
                                mtl) for _ in range(2)]
    torch.cuda.synchronize()
    want = fl.links_bwd_plain(q, k, gates, ol, dlinks, H, sc, mtl)
    for g, again, w in zip(*runs, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL
        assert torch.equal(g, again)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("B,H,T", [(2, 4, 1), (2, 4, 65), (80, 4, 120),
                                   (4, 4, 1040)])
def test_full_bias_fma_training_forward(gen, B, H, T, p):
    """#3's training forward (attention_fma.cuh, full-bias mode; [4, 4,
    1040] splits the keys) against the plain version with dropout and a
    fully masked row, bit-identical over two runs, its statistics through
    the tensor-core backward, which replays the forward's mask."""
    sc = 0.125
    q, k, v, do = (_randn(gen, B, H, T, 64) for _ in range(4))
    bias = _full_bias(gen, B, H, T, T, masked_row=True)
    seed = _seeds(gen, 1) if p else None
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias, sc, p, seed,
                                         with_stats=True)
    again = fa.attention_fb_fwd_kernel(q, k, v, bias, sc, p, seed,
                                       with_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(st, again[1])
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert _max_err(out, fa.attention_full_bias_plain(q, k, v, bias, sc, p,
                                                      seed)) <= TOL
    got = fa.attention_fb_bwd_kernel(q, k, v, bias, out, st, do, sc, p, seed)
    torch.cuda.synchronize()
    want = fa.attention_full_bias_bwd_plain(q, k, v, bias, do, sc, p, seed)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g, w) <= TOL


def test_no_simt_attention_forward_is_built(gen):
    """The built library holds the FMA training forward's full-bias
    instance and no SIMT attention forward (``attn_fwd_kernel``)."""
    from daspeech_torch.ops import _build

    image = _build.build().path.read_bytes()
    assert b"15attn_fwd_kernel" not in image
    assert b"19attn_fma_fwd_kernelILi1ELb1E" in image


# ------------------------------------------------------------------ bf16

BF16_TOL = 2.0 ** -7     # of the output's largest magnitude
BF16_FLOOR = 1e-5        # absolute, for an output that is 0 exactly


def _bf16_close(got, want):
    """A bf16 kernel output against its plain bf16 version: the same
    dtype, within 2^-7 (one bf16 ulp at 1) of the output's largest
    magnitude, or 1e-5 where that is smaller (dq at a single key is 0 in
    the plain version and fp32 rounding in the kernel)."""
    assert got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    scale = want.float().abs().max().item()
    assert _max_err(got.float(), want.float()) <= max(BF16_TOL * scale,
                                                      BF16_FLOOR)


def _bf16(gen, *shape, scale=1.0):
    return _randn(gen, *shape, scale=scale).to(torch.bfloat16)


def _plain_stats(q, k, bias, H, head_major):
    """The [B, H, Tq, 2] row (max, sum of exp(s - max)) of the fp32 scores
    of bf16 q, k (scale 1) and the column bias."""
    if head_major:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    else:
        B, Tq, C = q.shape
        s = torch.einsum("bqhd,bkhd->bhqk", q.float().reshape(B, Tq, H, 64),
                         k.float().reshape(B, k.shape[1], H, 64))
    s = s + bias[:, None, None, :]
    m = s.amax(-1)
    return torch.stack([m, torch.exp(s - m[..., None]).sum(-1)], -1)


# (80, 240, 240, 8, 0.1): cell T's decoder self-attention, the exact shape;
# (2, 100, 37, 4, 0.1): a key count that is not a multiple of 16 (a ragged
# k-step of the bf16 kernels' P·V) against a ragged query tile
@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("B,Tq,Tk,H,p", [(2, 1, 1, 1, 0.0),
                                         (2, 65, 130, 4, 0.1),
                                         (3, 240, 120, 8, 0.1),
                                         (2, 100, 37, 4, 0.1),
                                         (80, 240, 240, 8, 0.1),
                                         (2, 1040, 1040, 4, 0.0)])
def test_bf16_attention(gen, head_major, B, Tq, Tk, H, p):
    """#1 and #2 on bf16 q, k, v (attention_bf16.cuh's kernels): the
    inference and the training forward and the backward against the plain
    bf16 versions (dropout, a fully padded row), bf16 out and gradients;
    the training forward's fp32 statistics against the plain scores' and
    its fp32 output; the backward bit-identical over two runs."""
    shape = (lambda T: (B, H, T, 64)) if head_major else (
        lambda T: (B, T, H * 64))
    q = _bf16(gen, *shape(Tq), scale=0.125)
    k, v, = _bf16(gen, *shape(Tk)), _bf16(gen, *shape(Tk))
    do = _bf16(gen, *shape(Tq))
    bias = _bias(gen, B, Tk, all_padded_row=B > 1)
    seeds = _seeds(gen, B) if p else None
    if head_major:
        fwd = lambda st: fa.attention_hm_fwd_kernel(  # noqa: E731
            q, k, v, bias, 1.0, p, seeds, with_stats=st)
        want = fa.attention_hm_plain(q, k, v, bias, 1.0, p, seeds)
        want_g = fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p, seeds)
    else:
        fwd = lambda st: fa.attention_fwd_kernel(  # noqa: E731
            q, k, v, bias, H, 1.0, p, seeds, with_stats=st)
        want = fa.attention_plain(q, k, v, bias, H, 1.0, p, seeds)
        want_g = fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p, seeds)
    infer, _ = fwd(False)
    out, st = fwd(True)
    torch.cuda.synchronize()
    # the statistics and the output in fp32, for the backward's delta
    assert [x.dtype for x in st] == [torch.float32] * 2
    _bf16_close(st[1].to(torch.bfloat16), out)
    _bf16_close(st[1], want.float())
    stats = _plain_stats(q, k, bias, H, head_major)
    assert ((st[0] - stats).abs()
            <= BF16_TOL * stats.abs().clamp_min(1.0)).all()
    _bf16_close(infer, want)
    _bf16_close(out, want)
    bwd = fa.attention_hm_bwd_kernel if head_major else (
        lambda *a: fa.attention_bwd_kernel(*a[:7], H, *a[7:]))
    got = bwd(q, k, v, bias, out, st, do, 1.0, p, seeds)
    again = bwd(q, k, v, bias, out, st, do, 1.0, p, seeds)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want_g, again):
        _bf16_close(g, w)
        assert torch.equal(g, a)


# (3, .., 4, ..): batch row 2 fully padded; (80, 120, 4, 0.1): cell T's
# encoder, the exact shape; (1, 350, 4, 0.1): J-long's encoder length
@pytest.mark.parametrize("B,T,H,p", [(2, 1, 4, 0.0), (2, 65, 4, 0.1),
                                     (3, 120, 4, 0.1), (2, 300, 4, 0.0),
                                     (3, 1, 4, 0.1), (3, 63, 4, 0.1),
                                     (3, 65, 4, 0.0), (3, 350, 4, 0.1),
                                     (1, 350, 4, 0.1), (80, 120, 4, 0.1)])
def test_bf16_relpos(gen, B, T, H, p):
    """#5 on bf16 q, k, v, a and e (relpos_bf16.cuh's kernels), forward
    (inference and training) and backward, against the plain bf16
    versions; the training forward's fp32 output and statistics; the
    backward bit-identical over two runs."""
    C = 256
    q, k, v = (_bf16(gen, B, T, H * 64, scale=0.5) for _ in range(3))
    a = _bf16(gen, B, T, H * C, scale=0.1)
    e = fr.relpos_basis(T, C, device="cuda")[2].to(torch.bfloat16)
    bias = _bias(gen, B, T, all_padded_row=B > 2)
    seeds = _seeds(gen, B) if p else None
    do = _bf16(gen, B, T, H * 64)
    want = fr.relpos_plain(q, k, v, a, e, bias, H, 0.125, p, seeds)
    infer, _ = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, 0.125, p, seeds)
    out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, 0.125, p, seeds,
                                   with_stats=True)
    torch.cuda.synchronize()
    _bf16_close(infer, want)
    _bf16_close(out, want)
    # the statistics and the output in fp32, for the backward's delta
    assert [x.dtype for x in st] == [torch.float32] * 2
    _bf16_close(st[1].to(torch.bfloat16), out)
    _bf16_close(st[1], want.float())
    s = (torch.einsum("bqhd,bkhd->bhqk", *(x.float().reshape(B, T, H, -1)
                                           for x in (q, k)))
         + torch.einsum("bqhc,kc->bhqk", a.float().reshape(B, T, H, C),
                        e.float())) * 0.125 + bias[:, None, None, :]
    m = s.amax(-1)
    assert ((st[0][..., 0] - m).abs() <= BF16_TOL * m.abs().clamp_min(1.0)).all()
    got = fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, 0.125, p,
                               seeds)
    again = fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, 0.125,
                                 p, seeds)
    torch.cuda.synchronize()
    want_g = fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, 0.125, p, seeds)
    for g, w, x in zip(got, want_g, again):
        _bf16_close(g, w)
        assert torch.equal(g, x)


# L = 63, 65, 129 around the 64-wide tile, 1024 the cap, mtl = 5 the band
@pytest.mark.parametrize("B,L,H,mtl", [(2, 1, 8, None), (3, 65, 8, 5),
                                       (2, 240, 8, None), (1, 1024, 8, None),
                                       (3, 63, 8, None), (3, 65, 8, None),
                                       (3, 129, 8, None), (3, 129, 8, 5),
                                       (3, 1024, 8, 5)])
def test_bf16_links(gen, B, L, H, mtl):
    """#4 on bf16 q and k (links_bf16.cuh's kernels): fp32 links (the -inf
    pattern of the plain version, 1e-4 on the finite ones) and lse; bf16
    dq, dk and fp32 dgates against the plain bf16 versions, bit-identical
    over two runs."""
    q, k = _bf16(gen, B, L, H * 64, scale=0.5), _bf16(gen, B, L, H * 64)
    gates = torch.log_softmax(_randn(gen, B, L, H), dim=-1)
    ol = torch.randint(1, L + 1, (B,), generator=gen)
    ol[0] = L
    ol = ol.cuda()
    links, lse = fl.links_fwd_kernel(q, k, gates, ol, H, 0.125, mtl,
                                     with_lse=True)
    torch.cuda.synchronize()
    want = fl.links_plain(q, k, gates, ol, H, 0.125, mtl)
    assert links.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.isfinite(lse).all()
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(links), finite)
    if finite.any():
        assert (links[finite] - want[finite]).abs().max().item() <= TOL
    dlinks = _randn(gen, B, L, L)
    dq, dk_, dg = fl.links_bwd_kernel(q, k, gates, ol, links, lse, dlinks, H,
                                      0.125, mtl)
    again = fl.links_bwd_kernel(q, k, gates, ol, links, lse, dlinks, H,
                                0.125, mtl)
    torch.cuda.synchronize()
    wq, wk, wg = fl.links_bwd_plain(q, k, gates, ol, dlinks, H, 0.125, mtl)
    _bf16_close(dq, wq)
    _bf16_close(dk_, wk)
    assert dg.dtype == torch.float32
    assert _max_err(dg, wg) <= TOL
    for x, y in zip((dq, dk_, dg), again):
        assert torch.equal(x, y)


# the kernels of #5 and #4 by dtype: the bf16 ones (relpos_bf16.cuh,
# links_bf16.cuh) and the fp32 ones (the FMA training forward and
# attention_tc.cuh's chunked-score backward; fused_links.cu's)
RELPOS_LINKS_KERNELS = {
    torch.bfloat16: {"relpos_bf16_fwd_kernel": 1, "relpos_bf16_ds_kernel": 1,
                     "relpos_bf16_grad_kernel": 1, "links_bf16_lse_kernel": 1,
                     "links_bf16_fold_kernel": 1, "links_bf16_dq_kernel": 1,
                     "links_bf16_dk_kernel": 1},
    torch.float32: {"attn_fma_fwd_kernel": 1, "attn_tc_chunk_ds_kernel": 1,
                    "attn_tc_grad_kernel": 1, "links_lse_kernel": 1,
                    "links_fold_kernel": 1, "links_bwd_dq_kernel": 1,
                    "links_bwd_dk_kernel": 1}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relpos_and_links_launch_their_own_kernels(gen, dtype):
    """A bf16 call of #5 (training forward and backward) and #4 (forward
    and backward) launches the bf16 kernels and none of the fp32 ones; an
    fp32 call the fp32 kernels and none of the bf16 ones (by name, under
    the profiler)."""
    B, T, H = 2, 37, 4
    q, k, v, do = (_randn(gen, B, T, H * 64, scale=0.5).to(dtype)
                   for _ in range(4))
    a = _randn(gen, B, T, H * 256, scale=0.1).to(dtype)
    e = fr.relpos_basis(T, 256, device="cuda")[2].to(dtype).contiguous()
    bias = _bias(gen, B, T)
    seeds = _seeds(gen, B)
    gates = torch.log_softmax(_randn(gen, B, T, H), dim=-1)
    ol = torch.tensor([T, T - 5], dtype=torch.int32).cuda()
    dl = _randn(gen, B, T, T)

    def run():
        out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, 0.125, 0.1,
                                       seeds, with_stats=True)
        fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, 0.125, 0.1,
                             seeds)
        links, lse = fl.links_fwd_kernel(q, k, gates, ol, H, 0.125, None,
                                         with_lse=True)
        fl.links_bwd_kernel(q, k, gates, ol, links, lse, dl, H, 0.125, None)

    names = _launched(run)
    assert names, "the profiler saw no kernels"
    want = RELPOS_LINKS_KERNELS[dtype]
    other = RELPOS_LINKS_KERNELS[torch.float32 if dtype == torch.bfloat16
                                 else torch.bfloat16]
    has = lambda t: sum(t in n for n in names)  # noqa: E731
    assert {t: has(t) for t in want} == want, names
    assert not any(has(t) for t in other), names
    ours = [n for n in names if any(t in n for t in (*want, *other))]
    assert len(ours) == sum(want.values()), names


def test_bf16_wrappers_refuse_mixed_dtypes(gen):
    """The bf16 entry points take one operand dtype and an fp32 bias."""
    q = _bf16(gen, 1, 4, 128)
    bias = torch.zeros((1, 4), device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        fa.fused_attention_packed(q, q.float(), q, bias, 2)
    with pytest.raises(TypeError, match="float32"):
        fa.fused_attention_packed(q, q, q, bias.to(torch.bfloat16), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.fused_attention_packed(q.half(), q.half(), q.half(), bias, 2)


# (8, 128, 26624): serving A's level 1, the exact shape
@pytest.mark.parametrize("B,C,T,tile", [(3, 128, 200, 64), (3, 64, 257, 128),
                                        (1, 32, 513, None), (3, 8, 100, 64),
                                        (2, 128, 1, 64),
                                        (8, 128, 26624, None)])
def test_bf16_mrf_level(gen, B, C, T, tile):
    """#7 with bf16 weights (each conv's input rounded to bf16, bf16
    products, fp32 sums) against its plain bf16 version: fp32 out within
    2^-7 of its largest magnitude, the same bits at every tile, and further
    from the fp32 level than the two are from each other."""
    x, W, biases = _mrf_inputs(gen, B, C, T, V1_KERNELS, V1_DILATIONS)
    Wb = W.to(torch.bfloat16)
    got = fm.mrf_level(x, Wb, biases, V1_KERNELS, V1_DILATIONS, tile)
    torch.cuda.synchronize()
    want = fm.mrf_level_ref(x, Wb, biases, V1_KERNELS, V1_DILATIONS)
    assert got.dtype == torch.float32
    _bf16_close(got, want)
    for t in fm.TILES:
        assert torch.equal(
            fm.mrf_level(x, Wb, biases, V1_KERNELS, V1_DILATIONS, t), got)
    f32 = fm.mrf_level_ref(x, Wb.float(), biases, V1_KERNELS, V1_DILATIONS)
    assert _max_err(got, want) < _max_err(f32, want)


# (80, 120, 2048, 0.1): cell T's FFN, the exact shape; F = 300 and 1100
# are not multiples of 8 (W2's rows take no 16-byte copies, the scratch's
# rows are padded)
@pytest.mark.parametrize("B,T,Fd,p", [(3, 37, 2048, 0.1), (1, 1, 300, 0.0),
                                      (5, 29, 1100, 0.1),
                                      (80, 120, 2048, 0.1)])
def test_bf16_fused_ffn(gen, B, T, Fd, p):
    """#6 on bf16 x, weights and biases (fp32 LayerNorm parameters): the
    forward and the backward against the plain bf16 versions (bf16 out and
    dx, fp32 parameter gradients within 2^-7 of each one's largest
    magnitude), the same bits over two runs."""
    from daspeech_torch.ops import fused_ffn as ff

    x = _bf16(gen, B, T, 256)
    g, b, w1, b1, w2, b2 = _ffn_params(gen, 256, Fd)
    params = (g, b, *(t.to(torch.bfloat16) for t in (w1, b1, w2, b2)))
    seeds = _seeds(gen, B) if p else None
    got = ff.ffn_fwd_kernel(x, *params, seeds, p, p)
    torch.cuda.synchronize()
    _bf16_close(got, ff.ffn_plain(x, *params, seeds, p, p))
    assert torch.equal(got, ff.ffn_fwd_kernel(x, *params, seeds, p, p))
    do = _bf16(gen, B, T, 256, scale=(B * T) ** -0.5)
    got = ff.ffn_bwd_kernel(x, *params, do, seeds, p, p)
    torch.cuda.synchronize()
    want = ff.ffn_bwd_plain(x, *params, do, seeds, p, p)
    assert got[0].dtype == torch.bfloat16
    for u, w in zip(got, want):
        assert u.shape == w.shape
        _bf16_close(u, w)
    for u, v in zip(got, ff.ffn_bwd_kernel(x, *params, do, seeds, p, p)):
        assert torch.equal(u, v)


def _launched(fn):
    """The names of the kernels that one ``fn()`` launched, under
    ``torch.profiler`` (after a warm call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# the fp32 kernels of #6 and #7 (3xTF32) and the casts the bf16 entry
# points ran before they had kernels of their own
FP32_GEMM_KERNELS = ("ffn_fwd_kernel", "ffn_bwd_rows_kernel",
                     "ffn_wgrad_kernel", "mrf_conv_kernel")
CASTS = ("widen_kernel", "narrow_kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_and_mrf_launch_their_own_kernels(gen, dtype):
    """A bf16 call of #6 (forward and backward) and #7 launches the bf16
    kernels (ffn_bf16.cuh's, mrf_bf16.cuh's) and none of the fp32
    kernels or casts; an fp32 call the fp32 kernels and none of the bf16
    ones."""
    from daspeech_torch.ops import fused_ffn as ff

    x = _randn(gen, 2, 37, 256).to(dtype)
    params = list(_ffn_params(gen, 256, 600))
    params[2:] = [t.to(dtype) for t in params[2:]]
    seeds = _seeds(gen, 2)
    do = _randn(gen, 2, 37, 256, scale=0.1).to(dtype)
    xm, W, biases = _mrf_inputs(gen, 2, 64, 300, V1_KERNELS, V1_DILATIONS)
    W = W.to(dtype)

    def run():
        ff.ffn_fwd_kernel(x, *params, seeds, 0.1, 0.1)
        ff.ffn_bwd_kernel(x, *params, do, seeds, 0.1, 0.1)
        fm.mrf_level(xm, W, biases, V1_KERNELS, V1_DILATIONS)

    names = _launched(run)
    assert names, "the profiler saw no kernels"
    has = lambda t: sum(t in n for n in names)  # noqa: E731
    if dtype == torch.bfloat16:
        want = {"ffn_bf16_fwd_kernel": 1, "ffn_bf16_rows_kernel": 1,
                "ffn_bf16_wgrad_kernel": 1, "ffn_reduce_kernel": 1,
                "mrf_bf16_act_kernel": 1, "mrf_bf16_conv_kernel": 18}
        assert not any(has(t) for t in (*FP32_GEMM_KERNELS, *CASTS)), names
    else:
        want = {"ffn_fwd_kernel": 1, "ffn_bwd_rows_kernel": 1,
                "ffn_wgrad_kernel": 1, "ffn_reduce_kernel": 1,
                "mrf_conv_kernel": 18}
        assert not any("_bf16_" in n for n in names), names
    assert {t: has(t) for t in want} == want, names
    assert len(names) == sum(want.values()), names


def _alibi(B, H, T):
    """``chip_smoke.alibi_bias``: -m_h |i - j|, m_h = 2^(-8 (h + 1) / H)."""
    m = 2.0 ** (-8.0 * torch.arange(1, H + 1) / H)
    i = torch.arange(T)
    dist = (i[None, :] - i[:, None]).abs().float()
    return (-m[:, None, None] * dist).expand(B, H, T, T).contiguous().cuda()


# (8, 8, 240, 240, 0.1, "alibi"): chip_smoke.py's ALiBi shape and bias
@pytest.mark.parametrize("B,H,Tq,Tk,p,kind", [
    (3, 2, 65, 130, 0.1, "random"), (1, 4, 1, 1, 0.0, "random"),
    (3, 8, 120, 120, 0.1, "random"), (2, 2, 1, 1, 0.1, "random"),
    (2, 2, 63, 63, 0.1, "random"), (2, 3, 65, 65, 0.0, "random"),
    (2, 2, 130, 65, 0.1, "random"), (2, 2, 37, 100, 0.0, "random"),
    (8, 8, 240, 240, 0.1, "alibi")])
def test_bf16_full_bias(gen, B, H, Tq, Tk, p, kind):
    """#3 on bf16 q, k, v with an fp32 bias4 (attention_bf16.cuh's kernels
    in their full-bias mode; a random bias with a fully masked row, or the
    ALiBi bias): the inference and training forward and the backward
    against the plain bf16 versions; dbias fp32; the training forward's
    fp32 output and statistics against the plain scores'; the backward
    bit-identical over two runs."""
    q = _bf16(gen, B, H, Tq, 64, scale=0.125)
    k, v = _bf16(gen, B, H, Tk, 64), _bf16(gen, B, H, Tk, 64)
    do = _bf16(gen, B, H, Tq, 64)
    if kind == "alibi":
        bias4 = _alibi(B, H, Tq)
    else:
        bias4 = _randn(gen, B, H, Tq, Tk)
        bias4[-1, 0, 0] = -1e30
    seed = torch.tensor([7], dtype=torch.int32, device="cuda") if p else None
    want = fa.attention_full_bias_plain(q, k, v, bias4, 1.0, p, seed)
    infer, _ = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0, p, seed)
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0, p, seed,
                                         with_stats=True)
    torch.cuda.synchronize()
    _bf16_close(infer, want)
    _bf16_close(out, want)
    # the statistics and the output in fp32, for the backward's delta
    assert [x.dtype for x in st] == [torch.float32] * 2
    _bf16_close(st[1].to(torch.bfloat16), out)
    _bf16_close(st[1], want.float())
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) + bias4
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    assert ((st[0][..., 0] - m).abs()
            <= BF16_TOL * m.abs().clamp_min(1.0)).all()
    assert ((st[0][..., 1] - l).abs() <= BF16_TOL * l).all()
    got = fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do, 1.0, p,
                                     seed)
    again = fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do, 1.0, p,
                                       seed)
    torch.cuda.synchronize()
    wants = fa.attention_full_bias_bwd_plain(q, k, v, bias4, do, 1.0, p, seed)
    assert got[3].dtype == torch.float32
    for u, w, a in zip(got, wants, again):
        _bf16_close(u, w)
        assert torch.equal(u, a)


# the kernels of one training forward and backward of #3 in each dtype:
# bf16 attention_bf16.cuh's full-bias mode; fp32 the FMA forward's
# full-bias mode and the chunked-score dS and gradient kernels
FULL_BIAS_KERNELS = {
    torch.bfloat16: {"attn_bf16_fb_fwd_kernel": 1, "attn_bf16_fb_dq_kernel": 1,
                     "attn_bf16_fb_dkdv_kernel": 1},
    torch.float32: {"attn_fma_fwd_kernel": 1, "attn_tc_chunk_ds_kernel": 1,
                    "attn_tc_grad_kernel": 1}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_bias_launches_its_own_kernels(gen, dtype):
    """A bf16 call of #3 (training forward and backward) launches the
    full-bias mode of attention_bf16.cuh's kernels and none of the fp32
    ones or of the column-bias bf16 ones; an fp32 call the fp32 kernels and
    no bf16 one (by name, under the profiler)."""
    B, H, T = 2, 4, 37
    q, k, v, do = (_randn(gen, B, H, T, 64, scale=0.5).to(dtype)
                   for _ in range(4))
    bias4 = _randn(gen, B, H, T, T)
    seed = _seeds(gen, 1)

    def run():
        out, st = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0, 0.1, seed,
                                             with_stats=True)
        fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do, 1.0, 0.1,
                                   seed)

    names = _launched(run)
    assert names, "the profiler saw no kernels"
    want = FULL_BIAS_KERNELS[dtype]
    has = lambda t: sum(t in n for n in names)  # noqa: E731
    assert {t: has(t) for t in want} == want, names
    if dtype == torch.bfloat16:
        assert not any("attn_tc_" in n or "attn_fma_" in n for n in names)
        assert not any(has(t) for t in ("attn_bf16_fwd_kernel",
                                        "attn_bf16_dq_kernel",
                                        "attn_bf16_dkdv_kernel")), names
    else:
        assert not any("_bf16_" in n for n in names), names
    assert len(names) == sum(want.values()), names


@pytest.mark.parametrize("T", [1, 9, 16])
def test_int8_sums_at_few_rows(gen, T):
    """The int8 rungs' int32 sums at B T <= 16 rows (CUDA's ``_int_mm``
    floor, padded): the CPU's, bit for bit."""
    from daspeech_torch.models import hifigan as hg

    xq = torch.randint(-127, 128, (1, 32, T), generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 32, 24), generator=gen,
                       dtype=torch.int8)
    got = hg.int_taps_conv(xq.cuda(), wq.cuda(), [-3, 0, 3])
    assert torch.equal(got.cpu(), hg.int_taps_conv(xq, wq, [-3, 0, 3]))


@pytest.mark.parametrize("quant", ["int8", "int8-skip1"])
def test_int8_vocoder_serves_a_short_utterance(gen, quant):
    """config_v1 at B = 1 and 8 mel frames (level 0's sites see 8 rows),
    calibrated on a 40-frame mel: finite, of its length, and within one
    int8 error of the CPU's same rung with the card's frozen scales."""
    from daspeech_torch.config import HiFiGANConfig
    from daspeech_torch.decode import make_vocode_fn
    from daspeech_torch.decode.speech_generator import quant_fields
    from daspeech_torch.models import HiFiGANGenerator

    torch.manual_seed(0)
    cpu32 = HiFiGANGenerator(HiFiGANConfig()).eval()
    cpu = HiFiGANGenerator(HiFiGANConfig(), **quant_fields(quant)).eval()
    cpu.load_state_dict(cpu32.state_dict())
    card = HiFiGANGenerator(HiFiGANConfig(), **quant_fields(quant))
    card.load_state_dict(cpu32.state_dict())
    card = card.eval().cuda()
    calib = torch.randn(1, 40, 80, generator=gen)
    mel = torch.randn(1, 8, 80, generator=gen)
    with torch.inference_mode():
        fn = make_vocode_fn(card, calib_batches=1)
        fn(calib.cuda())
        got = fn(mel.cuda()).cpu()
        for buf, b_card in zip(cpu.buffers(), card.buffers()):
            buf.copy_(b_card.cpu())
        want, f32 = cpu(mel), cpu32(mel)
    assert got.shape == (1, 8 * 256) and torch.isfinite(got).all()
    assert (got - want).norm() <= (want - f32).norm()
