"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests import no JAX, so they also run on a machine with a card and
without JAX (the repository's conftest imports JAX, hence
``--noconftest``)::

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Elsewhere they skip. Tolerances: ``sorted_scatter`` and
``fused_place_scatter`` (both routes of each) and ``fused_scatter_dot``
atol 1e-4 / rtol 1e-5
(the kernel and ``index_add_`` sum the same f32 values in different
orders); ``sorted_gather`` and ``canonical_copy`` bit for bit (copies);
``compose_table`` and ``compose_grad_pass``'s ``d_packed`` the same atol
and rtol, its ``d_comp`` (a sum over the whole table) 1e-4 + 1e-5 of the
sum of its terms' absolute values (both 3xTF32 on the tensor cores:
about 21 bits of each product). The bf16 encoder kernels
(fused attention, fused MLP) against their plain versions: element by
element, ``|got - want| <= 2^-6 (|want| + scale) + 1e-6``, where ``scale`` is the element's product taken over
absolute values (``mrgcn_tpu_torch.ops.kernel_bounds``). Both sides sum
in f32 in different orders, so an intermediate that is rounded to bf16
(the probabilities, the hidden activations, the outputs) can land one
bf16 step (at most 2^-7 of its size) apart.
"""

import numpy as np
import pytest
import torch


def make_stream(seed, nslab=7, rb=16, eb=8, n_blocks=6, L=128):
    """A sorted stream: non-decreasing block ids drawn from the even blocks
    (so the odd ones are never visited), ~20% padding, and slabs that
    repeat a row."""
    rng = np.random.default_rng(seed)
    blk = np.sort(rng.choice(np.arange(0, n_blocks, 2), nslab))
    local = rng.integers(0, rb, (nslab, eb))
    local[rng.random((nslab, eb)) < 0.2] = rb
    local[:, :3] = local[:, :1]
    msgs = rng.standard_normal((nslab * eb, L)).astype(np.float32)
    return msgs, local.astype(np.int32), blk.astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("rb,eb,L", [(16, 8, 128), (512, 256, 128),
                                     (64, 40, 96)])
def test_sorted_scatter_kernel_matches_plain(cuda, rb, eb, L):
    from mrgcn_tpu_torch.ops.sorted_stream import (sorted_scatter,
                                                   sorted_scatter_reference)
    msgs, local, blk = make_stream(rb + eb, 9, rb, eb, 10, L)
    m, lo, bl = (torch.from_numpy(x).to(cuda) for x in (msgs, local, blk))
    out_rows = 10 * rb - 3
    before = sorted_scatter.launches
    got = sorted_scatter(m, lo, bl, out_rows, rb, eb)
    again = sorted_scatter(m, lo, bl, out_rows, rb, eb)
    want = sorted_scatter_reference(m, lo, bl, out_rows, rb, eb)
    torch.cuda.synchronize()
    assert sorted_scatter.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_sorted_scatter_kernel_rejects_bad_arguments(cuda):
    from mrgcn_tpu_torch.ops.sorted_stream import sorted_scatter
    msgs, local, blk = make_stream(1)
    m, lo, bl = (torch.from_numpy(x).to(cuda) for x in (msgs, local, blk))
    with pytest.raises(TypeError, match="local must be torch.int32"):
        sorted_scatter(m, lo.long(), bl, 96, 16, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        sorted_scatter(m[:, :100].contiguous(), lo, bl, 96, 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sorted_scatter(m[:, ::2], lo, bl, 96, 16, 8)
    with pytest.raises(ValueError, match="shapes disagree"):
        sorted_scatter(m, lo, bl, 96, 16, 4)


@pytest.mark.gpu
def test_featureless_aggregate_on_card_matches_cpu(cuda):
    from mrgcn_tpu_torch.ops import relational as rl
    rng = np.random.default_rng(0)
    n, R, E, d = 300, 5, 2000, 16
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    rel = rng.integers(0, R, E)
    norm = rng.random(E).astype(np.float32)
    plans = rl.build_layer_plans(src, dst, rel, norm, n, 8, 8,
                                 row_block=64, edge_block=32,
                                 kind="identity")
    table = rng.standard_normal((R * plans.n_in_rows, 128)).astype(
        np.float32)
    cot = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    results = []
    for device in (torch.device("cpu"), cuda):
        t = torch.tensor(table, device=device, requires_grad=True)
        out = rl.featureless_aggregate(t, plans.to(device), d)
        out.backward(cot.to(device))
        results.append((out.detach().cpu(), t.grad.cpu()))
    (o_cpu, g_cpu), (o_gpu, g_gpu) = results
    torch.testing.assert_close(o_gpu, o_cpu, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-5, atol=1e-4)


def stream_case(cuda, rb, eb, L, k, d, seed):
    """A sorted stream with an all-padding slab and a run of one slab,
    values ``d`` wide cut from wider rows, slots, norms and a table."""
    nslab, n_blocks = 9, 10
    msgs, local, blk = make_stream(seed, nslab, rb, eb, n_blocks, L)
    local[4] = rb
    blk[-1] = n_blocks
    rng = np.random.default_rng(seed)
    E, out_rows = nslab * eb, (n_blocks + 1) * rb - 3
    place = rng.integers(0, k, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    table = rng.standard_normal((out_rows, L)).astype(np.float32)
    m, lo, bl, pl, nm, tb = (torch.from_numpy(x).to(cuda) for x in (
        msgs, local, blk, place, norm, table))
    return m[:, 1:1 + d], lo, bl, pl, nm, tb, out_rows


@pytest.mark.gpu
@pytest.mark.parametrize("rb,eb,L,k,d", [(16, 8, 128, 8, 16),
                                         (512, 256, 256, 1, 200),
                                         (64, 40, 96, 4, 21),
                                         (512, 256, 128, 8, 11)])
def test_fused_place_scatter_kernel_matches_plain(cuda, rb, eb, L, k, d):
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    V, lo, bl, pl, nm, _, out_rows = stream_case(cuda, rb, eb, L, k, d,
                                                 rb + d)
    args = (V, pl, nm, lo, bl, out_rows, k, L, rb, eb)
    before = ss.fused_place_scatter.launches
    got, again = ss.fused_place_scatter(*args), ss.fused_place_scatter(*args)
    want = ss.fused_place_scatter_reference(*args)
    torch.cuda.synchronize()
    assert ss.fused_place_scatter.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)
    # no slabs at all: every block is zero-filled
    empty = ss.fused_place_scatter(V[:0], pl[:0], nm[:0], lo[:0], bl[:0],
                                   out_rows, k, L, rb, eb)
    assert empty.shape == (out_rows, L) and not empty.any()


@pytest.mark.gpu
@pytest.mark.parametrize("nslab,n_blocks", [(60, 4), (300, 2)])
def test_fused_place_split_walk_on_long_runs(cuda, nslab, n_blocks):
    """Runs of 30 to 300 slabs, which the split walk cuts into pieces of
    at most ``split_segment`` slabs summed by separate thread blocks and
    then added in segment order: the plain version's sums, the same bits
    twice, no row-segmented launch."""
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    rb, eb, L, k, d = 64, 32, 128, 8, 16
    msgs, local, blk = make_stream(nslab, nslab, rb, eb, 2 * n_blocks, L)
    rng = np.random.default_rng(nslab)
    E, out_rows = nslab * eb, 2 * n_blocks * rb - 5
    m, lo, bl = (torch.from_numpy(x).to(cuda) for x in (msgs, local, blk))
    pl = torch.from_numpy(rng.integers(0, k, E).astype(np.int32)).to(cuda)
    nm = torch.from_numpy(rng.random(E).astype(np.float32)).to(cuda)
    args = (m[:, 5:5 + d], pl, nm, lo, bl, out_rows, k, L, rb, eb)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert nslab / n_blocks > ss.split_segment(nslab, L, sms)
    before = (ss.fused_place_scatter.launches,
              ss.fused_place_scatter.launches_rows)
    got, again = ss.fused_place_scatter(*args), ss.fused_place_scatter(*args)
    want = ss.fused_place_scatter_reference(*args)
    torch.cuda.synchronize()
    assert (ss.fused_place_scatter.launches,
            ss.fused_place_scatter.launches_rows) == (before[0] + 2,
                                                      before[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)


def sorted_case(cuda, rb, eb, L, d, strided, seed):
    """A row-sorted stream (``chip_smoke.sorted_adversarial_stream``: a
    hub row longer than the row-segmented kernel's 128-edge chunk over
    many slabs, an all-padding slab inside its run, unvisited odd blocks,
    a tenth of the edges padding), ``dvn`` scaled as the layer's norm
    scales it, either cut from wider rows at an odd offset (4-byte loads)
    or contiguous (16-byte loads where ``d`` is a multiple of 4), ``w``,
    a table and a ragged row count."""
    from chip_smoke import sorted_adversarial_stream
    rng = np.random.default_rng(seed)
    n_blocks = 10
    n_edges, hub = {16: (200, 300), 64: (600, 400), 512: (3000, 1500)}[rb]
    local, blk, scale = sorted_adversarial_stream(rng, n_edges, rb, eb,
                                                  n_blocks, hub)
    E, out_rows = local.size, n_blocks * rb - 3
    wide = rng.standard_normal((E, d + 4)).astype(np.float32) \
        * scale[:, None]
    dvn = wide[:, 1:1 + d] if strided else np.ascontiguousarray(wide[:, :d])
    w = rng.random(E).astype(np.float32)
    table = rng.standard_normal((out_rows, L)).astype(np.float32)
    lo, bl, wt, tb = (torch.from_numpy(x).to(cuda)
                      for x in (local, blk, w, table))
    dv = torch.from_numpy(wide).to(cuda)[:, 1:1 + d] if strided \
        else torch.from_numpy(dvn).to(cuda)
    return dv, wt, lo, bl, tb, out_rows


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("rb,eb,L,d", [(16, 8, 128, 128),
                                       (512, 256, 256, 200),
                                       (64, 40, 96, 21)])
def test_fused_scatter_dot_rows_kernel_matches_plain(cuda, rb, eb, L, d,
                                                     strided):
    """The row-segmented kernel (``rows_sorted=True``) against the plain
    version, atol 1e-4 / rtol 1e-5; the same bits twice; zeros outside
    the visited rows and at lanes >= Lv; zero dots on padding."""
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    args = sorted_case(cuda, rb, eb, L, d, strided, seed=rb + d)
    before = (ss.fused_scatter_dot.launches,
              ss.fused_scatter_dot.launches_rows)
    got = ss.fused_scatter_dot(*args, rb, eb, rows_sorted=True)
    again = ss.fused_scatter_dot(*args, rb, eb, rows_sorted=True)
    want = ss.fused_scatter_dot_reference(*args, rb, eb)
    torch.cuda.synchronize()
    assert (ss.fused_scatter_dot.launches,
            ss.fused_scatter_dot.launches_rows) == (before[0] + 2,
                                                    before[1] + 2)
    for g, a, w_ in zip(got, again, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-4)
        assert torch.equal(g, a)
    lo, bl, out_rows = args[2], args[3], args[5]
    real = lo.reshape(-1) < rb
    assert not got[1][~real].any()
    visited = torch.zeros(out_rows, dtype=torch.bool, device=cuda)
    visited[(bl.long()[:, None] * rb + lo.long()).reshape(-1)[real]] = True
    assert not got[0][~visited].any() and not got[0][:, d:].any()


@pytest.mark.gpu
def test_fused_scatter_dot_rows_kernel_edge_cases(cuda):
    """No edges, and edges that are all padding: every row zero; rows
    wider than the kernel takes raise."""
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    dvn, w, lo, bl, table, out_rows = sorted_case(cuda, 16, 8, 128, 128,
                                                  False, seed=5)
    for n in (0, lo.shape[0]):
        pad = torch.full_like(lo[:n], 16)
        out, dots = ss.fused_scatter_dot(dvn[:n * 8], w[:n * 8], pad, bl[:n],
                                         table, out_rows, 16, 8,
                                         rows_sorted=True)
        torch.cuda.synchronize()
        assert out.shape == (out_rows, 128) and not out.any()
        assert dots.shape == (n * 8,) and not dots.any()
    wide = torch.zeros(dvn.shape[0], 520, device=cuda)
    with pytest.raises(ValueError, match="at most 512"):
        ss.fused_scatter_dot(wide, w, lo, bl, torch.zeros(out_rows, 544,
                                                          device=cuda),
                             out_rows, 16, 8, rows_sorted=True)


def row_scatter_case(cuda, rb, eb, L, k, d, strided, seed, hub=None):
    """A row-sorted stream (``sorted_adversarial_stream``) with slots
    drawn per edge (they interleave within a row), values ``d`` wide
    scaled by 1/degree, contiguous or cut from wider rows at an odd
    offset, full message lines, norms and a ragged row count. Returns
    the place-scatter's arguments and the scatter's messages."""
    from chip_smoke import sorted_adversarial_stream
    rng = np.random.default_rng(seed)
    n_blocks = 10
    n_edges, hub_edges = {16: (200, 300), 64: (600, 400),
                          512: (3000, 1500)}[rb]
    local, blk, scale = sorted_adversarial_stream(
        rng, n_edges, rb, eb, n_blocks, hub or hub_edges)
    E, out_rows = local.size, n_blocks * rb - 3
    wide = rng.standard_normal((E, d + 4)).astype(np.float32) \
        * scale[:, None]
    place = rng.integers(0, k, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    msgs = (rng.standard_normal((E, L)) * scale[:, None]).astype(np.float32)
    lo, bl, pl, nm, ms, wd = (torch.from_numpy(x).to(cuda) for x in (
        local, blk, place, norm, msgs, wide))
    V = wd[:, 1:1 + d] if strided else wd[:, :d].contiguous()
    return (V, pl, nm, lo, bl, out_rows, k, L, rb, eb), ms


def check_row_kernels(pargs, msgs):
    """``fused_place_scatter`` and ``sorted_scatter`` with ``rows_sorted``
    against their plain versions (atol 1e-4 / rtol 1e-5), the same bits
    twice, two row-segmented launches each, and zeros in every row no
    edge visits."""
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    V, pl, nm, lo, bl, out_rows, k, L, rb, eb = pargs
    sargs = (msgs, lo, bl, out_rows, rb, eb)
    for fn, args, plain in (
            (ss.fused_place_scatter, pargs, ss.fused_place_scatter_reference),
            (ss.sorted_scatter, sargs, ss.sorted_scatter_reference)):
        before = (fn.launches, fn.launches_rows)
        got = fn(*args, rows_sorted=True)
        again = fn(*args, rows_sorted=True)
        want = plain(*args)
        torch.cuda.synchronize()
        assert (fn.launches, fn.launches_rows) == (before[0] + 2,
                                                   before[1] + 2)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        assert torch.equal(got, again)
        rows = (bl.long()[:, None] * rb + lo.long()).reshape(-1)
        visited = torch.zeros(out_rows, dtype=torch.bool, device=got.device)
        visited[rows[(lo.reshape(-1) < rb) & (rows < out_rows)]] = True
        assert not got[~visited].any()


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("rb,eb,L,k,d", [(16, 8, 128, 8, 16),
                                         (64, 40, 96, 4, 21),
                                         (512, 256, 256, 1, 200),
                                         (64, 40, 640, 2, 320),
                                         (16, 8, 128, 8, 11)])
def test_row_scatter_kernels_match_plain(cuda, rb, eb, L, k, d, strided):
    """The row-segmented kernels of ``fused_place_scatter`` (k 8, 4, 1,
    2; odd widths; lines of 640 lanes, two column tiles) and
    ``sorted_scatter`` on row-sorted streams with a hub row over many
    chunks and an all-padding slab inside its run."""
    check_row_kernels(*row_scatter_case(cuda, rb, eb, L, k, d, strided,
                                        seed=rb + L + d))


@pytest.mark.gpu
def test_row_scatter_kernels_edge_cases(cuda):
    """No slabs, slabs of padding only (every row zero), a hub row of
    3,000 edges over 24 chunks, ``Lv = 1``, ``k = 2``, a row count that is
    no multiple of the row block."""
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    check_row_kernels(*row_scatter_case(cuda, 64, 40, 128, 2, 1, True,
                                        seed=9, hub=3000))
    (V, pl, nm, lo, bl, out_rows, k, L, rb, eb), msgs = row_scatter_case(
        cuda, 16, 8, 128, 8, 16, False, seed=10)
    for n in (0, lo.shape[0]):
        pad = torch.full_like(lo[:n], rb)
        e = n * eb
        for got in (ss.fused_place_scatter(V[:e], pl[:e], nm[:e], pad,
                                           bl[:n], out_rows, k, L, rb, eb,
                                           rows_sorted=True),
                    ss.sorted_scatter(msgs[:e], pad, bl[:n], out_rows, rb,
                                      eb, rows_sorted=True)):
            torch.cuda.synchronize()
            assert got.shape == (out_rows, L) and not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("rb,eb,L", [(16, 8, 128), (512, 256, 256),
                                     (64, 40, 96)])
def test_sorted_gather_kernel_is_exact_and_pairs_with_scatter(cuda, rb, eb,
                                                              L):
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    _, lo, bl, _, _, table, _ = stream_case(cuda, rb, eb, L, 1, 8, rb + L)
    before = ss.sorted_gather.launches
    got = ss.sorted_gather(table, lo, bl, rb, eb)
    want = ss.sorted_gather_reference(table, lo, bl, rb, eb)
    torch.cuda.synchronize()
    assert ss.sorted_gather.launches == before + 1
    assert torch.equal(got, want)
    # the gather's backward is a segment sum into the table; the
    # scatter's backward launches the gather kernel
    t = table.clone().requires_grad_()
    cot = torch.randn_like(got) * (lo.reshape(-1, 1) < rb)
    ss.sorted_gather(t, lo, bl, rb, eb).backward(cot)
    torch.testing.assert_close(
        t.grad, ss.sorted_scatter_reference(cot, lo, bl, table.shape[0], rb,
                                            eb), rtol=1e-5, atol=1e-4)
    m = cot.clone().requires_grad_()
    gathers = ss.sorted_gather.launches
    ss.sorted_scatter(m, lo, bl, table.shape[0], rb, eb).backward(table)
    assert ss.sorted_gather.launches == gathers + 1
    assert torch.equal(m.grad, want)


@pytest.mark.gpu
def test_stream_kernels_reject_bad_arguments(cuda):
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    V, lo, bl, pl, nm, table, out_rows = stream_case(cuda, 16, 8, 128, 8,
                                                     16, 3)
    with pytest.raises(TypeError, match="place_mod must be torch.int32"):
        ss.fused_place_scatter(V, pl.long(), nm, lo, bl, out_rows, 8, 128,
                               16, 8)
    with pytest.raises(ValueError, match="contiguous along its rows"):
        ss.fused_place_scatter(V.T.contiguous().T, pl, nm, lo, bl, out_rows,
                               8, 128, 16, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        ss.fused_scatter_dot(V, nm, lo, bl, table[:, :100].contiguous(),
                             out_rows, 16, 8, rows_sorted=True)
    # the kernel walks rows in order: a stream not marked row-sorted is
    # refused, and nothing launches
    before = ss.fused_scatter_dot.launches
    with pytest.raises(ValueError, match="rows_sorted=True"):
        ss.fused_scatter_dot(V, nm, lo, bl, table, out_rows, 16, 8)
    assert ss.fused_scatter_dot.launches == before
    with pytest.raises(ValueError, match="shapes disagree"):
        ss.sorted_gather(table, lo, bl[:-1], 16, 8)
    with pytest.raises(ValueError, match="table must be contiguous"):
        ss.sorted_gather(table[:, ::2], lo, bl, 16, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dim,B", [(16, 2), (200, 2)])
def test_featureless_basis_on_card_matches_cpu(cuda, out_dim, B):
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.ops.rspmm import packing_factor
    rng = np.random.default_rng(1)
    n, R, E = 300, 5, 2000
    src, dst, rel = (rng.integers(0, hi, E) for hi in (n, n, R))
    norm = rng.random(E).astype(np.float32)
    k = packing_factor(out_dim)
    plans = rl.build_layer_plans(src, dst, rel, norm, n, k, k,
                                 row_block=64, edge_block=32,
                                 kind="identity_basis")
    comp = rng.standard_normal((R, B)).astype(np.float32)
    packed = rng.standard_normal(
        (B, plans.n_in_rows, rl.line_width(k, out_dim))).astype(np.float32)
    cot = torch.from_numpy(
        rng.standard_normal((n, out_dim)).astype(np.float32))
    results = []
    for device in (torch.device("cpu"), cuda):
        c = torch.tensor(comp, device=device, requires_grad=True)
        p = torch.tensor(packed, device=device, requires_grad=True)
        out = rl.featureless_basis(c, p, plans.to(device), out_dim)
        out.backward(cot.to(device))
        results.append([t.detach().cpu() for t in (out, c.grad, p.grad)])
    for got, want in zip(results[1], results[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def assert_bf16_close(got, want, scale, what):
    from mrgcn_tpu_torch.ops.kernel_bounds import bf16_error
    assert bool(torch.isfinite(got).all()), what
    err, ratio = bf16_error(got, want, scale)
    assert ratio <= 1.0, f"{what}: max abs err {err}, {ratio} x the bound"


def attention_inputs(cuda, N, L, d, seed, strided=True, holes=False):
    """q, k, v (bf16, k and v as slices of one fused (N, L, 3d) tensor as
    the text encoder hands them over) and a key mask with ragged lengths,
    one sequence of length 1 and one that is all padding. ``holes``
    knocks out a third of the keys at random and, in every third
    sequence, the whole first key tile."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    qkv = torch.randn(N, L, 3 * d, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = torch.randint(1, L + 1, (N,), generator=gen)
    lengths[0] = 1
    if N > 1:
        lengths[1] = 0
    valid = torch.arange(L)[None, :] < lengths[:, None]
    if holes:
        keep = torch.rand(N, L, generator=gen) < 0.67
        keep[0, 0] = True
        keep[2::3, :64] = False
        valid = valid & keep
    valid = valid.to(cuda)
    do = torch.randn(N, L, d, generator=gen).to(cuda, torch.bfloat16)
    return q * (1.0 / d ** 0.5), k, v, valid, do


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,d,strided,holes", [
    (13, 37, 128, True, False), (16, 128, 128, True, False),
    (9, 1, 128, True, False), (5, 128, 64, True, False),
    (3, 16, 16, True, False), (6, 200, 128, True, False),
    (3, 512, 128, True, False), (4, 129, 64, True, False),
    (2, 300, 16, True, False),
    # past 128 tokens, narrow heads, fewer and more thread blocks than the
    # card runs at once, masks with holes, contiguous inputs
    (7, 129, 128, False, True), (5, 256, 64, True, True),
    (6, 512, 8, False, True), (900, 128, 128, True, True),
    (700, 256, 8, False, False), (40, 64, 128, False, True),
    (33, 65, 24, True, True)])
def test_attention_kernels_match_plain(cuda, N, L, d, strided, holes):
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops.kernel_bounds import attention_scales
    q, k, v, valid, do = attention_inputs(cuda, N, L, d, seed=N * L + d,
                                          strided=strided, holes=holes)
    if not strided:
        q = q.contiguous()
    scales = attention_scales(q, k, v, valid, do)
    f0, b0 = att.attention_fwd.launches, att.attention_bwd.launches
    out = att.attention_fwd(q, k, v, valid)
    again = att.attention_fwd(q, k, v, valid)
    grads = att.attention_bwd(q, k, v, valid, do)
    grads_again = att.attention_bwd(q, k, v, valid, do)
    torch.cuda.synchronize()
    assert att.attention_fwd.launches == f0 + 2
    assert att.attention_bwd.launches == b0 + 2
    assert_bf16_close(out, att.attention_fwd_reference(q, k, v, valid),
                      scales[0], "out")
    assert torch.equal(out, again)
    want = att.attention_bwd_reference(q, k, v, valid, do)
    for name, g, w, s, g2 in zip(("dq", "dk", "dv"), grads, want,
                                 scales[1:], grads_again):
        assert_bf16_close(g, w, s, name)
        assert torch.equal(g, g2), name
    if N > 1:   # the all-padding sequence: uniform softmax, no logit grad
        v1 = v[1].float()
        assert_bf16_close(out[1], v1.mean(0, keepdim=True).expand(L, d),
                          v1.abs().mean(0, keepdim=True).expand(L, d),
                          "uniform")
        assert not grads[0][1].any() and not grads[1][1].any()
    # key tiles the kernels skip get zero dk and dv rows
    walked = att.live_key_tiles(valid).repeat_interleave(
        att.KEY_TILE, dim=1)[:, :L]
    assert not grads[1][~walked].any() and not grads[2][~walked].any()


@pytest.mark.gpu
def test_fused_attention_autograd_on_card_matches_cpu(cuda):
    from mrgcn_tpu_torch.ops.attention import fused_attention
    from mrgcn_tpu_torch.ops.kernel_bounds import attention_scales
    q, k, v, valid, do = attention_inputs(cuda, 6, 40, 32, seed=3)
    # the leaves' q enters the core scaled by 1/sqrt(d) in bf16, so its
    # gradient's terms are the core's times that factor
    c = torch.tensor(32 ** -0.5, dtype=torch.bfloat16)
    s_out, s_dq, s_dk, s_dv = attention_scales(q * c, k, v, valid, do)
    scales = (s_out, s_dq * float(c), s_dk, s_dv)
    results = []
    for device in (torch.device("cpu"), cuda):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        out = fused_attention(*leaves, valid.to(device))
        out.backward(do.to(device))
        results.append([out.detach().cpu()]
                       + [t.grad.cpu() for t in leaves])
    for name, a, b, s in zip(("out", "dq", "dk", "dv"), *results, scales):
        assert_bf16_close(b, a, s.cpu(), name)


def head_inputs(cuda, N, L, H, d, seed, holes=False):
    """q, k, v (bf16, ``(N, L, H, d)`` views of the three ``(N, L, H d)``
    projections, as the multi-head text path hands them over), a key mask
    as :func:`attention_inputs` draws it, and a cotangent."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(N, L, H * d, generator=gen).to(
        cuda, torch.bfloat16).view(N, L, H, d) for _ in range(3))
    _, _, _, valid, _ = attention_inputs(cuda, N, L, 8, seed, holes=holes)
    do = torch.randn(N, L, H, d, generator=gen).to(cuda, torch.bfloat16)
    return q * (1.0 / d ** 0.5), k, v, valid, do


@pytest.mark.gpu
@pytest.mark.parametrize("N,L,H,d,holes", [
    (13, 37, 2, 64, False), (16, 128, 4, 32, False), (9, 1, 8, 16, False),
    (6, 200, 2, 64, True), (3, 512, 8, 16, True), (40, 129, 4, 32, True),
    (300, 128, 8, 16, False), (5, 64, 3, 40, True), (4, 77, 12, 64, False)])
def test_multi_head_attention_kernels_match_plain(cuda, N, L, H, d, holes):
    """Kernel #12: the heads read by strides in the ``(N, L, H, d)``
    layout, counted apart (``launches_heads``), each head's rows equal to
    the single-head kernel's on that head alone."""
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops.kernel_bounds import attention_scales
    q, k, v, valid, do = head_inputs(cuda, N, L, H, d, seed=N + L + H,
                                     holes=holes)
    scales = attention_scales(q, k, v, valid, do)
    counts = (att.attention_fwd.launches, att.attention_bwd.launches,
              att.attention_fwd.launches_heads,
              att.attention_bwd.launches_heads)
    out = att.attention_fwd(q, k, v, valid)
    grads = att.attention_bwd(q, k, v, valid, do)
    torch.cuda.synchronize()
    assert (att.attention_fwd.launches, att.attention_bwd.launches,
            att.attention_fwd.launches_heads,
            att.attention_bwd.launches_heads) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert out.shape == q.shape and out.is_contiguous()
    assert_bf16_close(out, att.attention_fwd_reference(q, k, v, valid),
                      scales[0], "out")
    want = att.attention_bwd_reference(q, k, v, valid, do)
    for name, g, w, sc in zip(("dq", "dk", "dv"), grads, want, scales[1:]):
        assert g.shape == q.shape
        assert_bf16_close(g, w, sc, name)
    assert torch.equal(out, att.attention_fwd(q, k, v, valid))
    h = H - 1
    one = [t[:, :, h].contiguous() for t in (q, k, v)]
    assert torch.equal(out[:, :, h], att.attention_fwd(*one, valid))
    for g, w in zip(grads, att.attention_bwd(*one, valid,
                                             do[:, :, h].contiguous())):
        assert torch.equal(g[:, :, h], w)


@pytest.mark.gpu
def test_multi_head_text_encoder_on_card_matches_cpu(cuda):
    """A ``TextEncoder`` with four heads (``xla``'s tree) on the card (#12
    forward and backward) against the same weights on the CPU: the bf16
    encoder's card-vs-CPU bounds of ``chip_smoke.py`` (outputs 1e-2 of the
    largest, gradients 1e-1 by norm). The key projection's bias is left
    out: it shifts every score of a row by the same amount, which the
    softmax does not see, so its gradient is 0 in exact arithmetic and
    rounding noise on both sides."""
    import copy

    from mrgcn_tpu_torch.models.encoders import TextEncoder
    from mrgcn_tpu_torch.ops import attention as att
    gen = torch.Generator().manual_seed(0)
    cpu = TextEncoder(8, gen, num_heads=4, attn_impl="xla", max_len=64)
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, 256, (50, 40), generator=gen)
    tokens[torch.arange(40)[None, :] >= torch.randint(
        1, 41, (50, 1), generator=gen)] = 256
    heads = att.attention_bwd.launches_heads
    outs = []
    for model, device in ((cpu, "cpu"), (card, cuda)):
        out = model(tokens.to(device))
        (out ** 2).sum().backward()
        outs.append(out.detach().cpu())
    assert att.attention_bwd.launches_heads == heads + 2
    assert float((outs[1] - outs[0]).abs().max()) \
        <= 1e-2 * float(outs[0].abs().max())
    for (name, a), b in zip(cpu.named_parameters(), card.parameters()):
        if name.endswith(".key.bias"):
            continue
        err = float((b.grad.cpu() - a.grad).norm())
        assert err <= 1e-1 * float(a.grad.norm()) + 1e-6, name


@pytest.mark.gpu
@pytest.mark.parametrize("M,d,hd", [(1000, 128, 512), (37, 16, 64),
                                    (4101, 64, 256), (128, 128, 512),
                                    (1, 128, 512), (129, 128, 512),
                                    (193, 128, 512), (1921, 128, 512),
                                    (1000, 128, 64), (1000, 48, 192),
                                    (262144, 128, 512)])
def test_mlp_kernels_match_plain(cuda, M, d, hd):
    """Also at one row; one past a 128-row dx tile and a 64-row
    weight-gradient segment (129); one past a 192-row forward tile (193);
    one past 15 segments of 128 rows (1921 on 132 SMs: the last segment
    holds one row); a single hidden chunk; d = 48, which the tensor maps
    fill to 128 with zeros; and the rows of a multimodal mini-batch of 512
    labels."""
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    from mrgcn_tpu_torch.ops.kernel_bounds import mlp_scales
    gen = torch.Generator(device="cpu").manual_seed(M + d + hd)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            cuda, torch.bfloat16)

    x, do = rnd(M, d), rnd(M, d)
    w1, b1 = rnd(d, hd, scale=d ** -0.5), rnd(hd, scale=0.5)
    w2, b2 = rnd(hd, d, scale=hd ** -0.5), rnd(d, scale=0.5)
    scales = mlp_scales(x, w1, b1, w2, b2, do)
    f0, b0 = fm.mlp_fwd.launches, fm.mlp_bwd.launches
    out = fm.mlp_fwd(x, w1, b1, w2, b2)
    again = fm.mlp_fwd(x, w1, b1, w2, b2)
    grads = fm.mlp_bwd(x, w1, b1, w2, do)
    grads_again = fm.mlp_bwd(x, w1, b1, w2, do)
    torch.cuda.synchronize()
    assert (fm.mlp_fwd.launches, fm.mlp_bwd.launches) == (f0 + 2, b0 + 2)
    assert_bf16_close(out, fm.mlp_fwd_reference(x, w1, b1, w2, b2),
                      scales[0], "out")
    assert torch.equal(out, again)
    want = fm.mlp_bwd_reference(x, w1, b1, w2, do)
    for name, g, w, s, g2 in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                                 want, scales[1:], grads_again):
        assert_bf16_close(g, w, s, name)
        assert torch.equal(g, g2), name


@pytest.mark.gpu
def test_mlp_kernels_take_unaligned_views(cuda):
    """Operands whose start is not 16-byte aligned (the tensor maps need
    it) are copied, not refused: the result equals the aligned call's."""
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator(device="cpu").manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            cuda, torch.bfloat16)

    M, d, hd = 300, 64, 128
    big, dbig = rnd(M * d + 1), rnd(M * d + 1)
    x, do = big[1:].view(M, d), dbig[1:].view(M, d)
    assert x.data_ptr() % 16
    w1, b1 = rnd(d, hd, scale=d ** -0.5), rnd(hd, scale=0.5)
    w2, b2 = rnd(hd, d, scale=hd ** -0.5), rnd(d, scale=0.5)
    out = fm.mlp_fwd(x, w1, b1, w2, b2)
    grads = fm.mlp_bwd(x, w1, b1, w2, do)
    torch.cuda.synchronize()
    assert torch.equal(out, fm.mlp_fwd(x.clone(), w1, b1, w2, b2))
    for g, w in zip(grads, fm.mlp_bwd(x.clone(), w1, b1, w2, do.clone())):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_encoder_kernels_reject_bad_arguments(cuda):
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    q, k, v, valid, do = attention_inputs(cuda, 2, 8, 16, seed=0)
    with pytest.raises(TypeError, match="bf16"):
        att.attention_fwd(q.float(), k, v, valid)
    with pytest.raises(NotImplementedError, match="tokenizer limit"):
        long = torch.zeros(1, 513, 16, dtype=torch.bfloat16, device=cuda)
        att.attention_fwd(long, long, long,
                          torch.ones(1, 513, dtype=torch.bool, device=cuda))
    x = torch.zeros(4, 24, dtype=torch.bfloat16, device=cuda)
    w1 = torch.zeros(24, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        fm.mlp_fwd(x, w1, w1[0], w1.t(), x[0])


@pytest.mark.gpu
def test_multi_head_kernels_reject_bad_arguments(cuda):
    """#12's wrapper: heads of another shape than q's, a head width that is
    no multiple of 8, a head stride that is no multiple of 8, and a
    cotangent of another shape raise before any launch."""
    from mrgcn_tpu_torch.ops import attention as att
    q, k, v, valid, do = head_inputs(cuda, 3, 20, 4, 16, seed=1)
    before = att.attention_fwd.launches_heads
    with pytest.raises(ValueError, match="like q"):
        att.attention_fwd(q, k[:, :, :2], v, valid)
    with pytest.raises(ValueError, match="multiple of 8"):
        odd = torch.zeros(3, 20, 4, 12, dtype=torch.bfloat16, device=cuda)
        att.attention_fwd(odd, odd, odd, valid)
    with pytest.raises(ValueError, match="multiples of 8"):
        wide = torch.zeros(3, 20, 4, 20, dtype=torch.bfloat16, device=cuda)
        att.attention_fwd(q, wide[..., :16], v, valid)
    with pytest.raises(ValueError, match="shaped as q"):
        att.attention_bwd(q, k, v, valid, do[:, :, :2])
    assert att.attention_fwd.launches_heads == before


# --------------------------------------------------------------------------
# the compose kernels (csrc/compose.cu)
# --------------------------------------------------------------------------

def compose_case(R, B, rows, L, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(device)
                 for shape in ((R * rows, L), (B * rows, L), (R, B)))


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,rows,L", [(5, 3, 8, 128), (121, 40, 64, 128),
                                        (475, 2, 40, 256), (33, 17, 72, 36),
                                        (7, 4, 24, 4), (4, 3, 12, 128),
                                        (9, 5, 7, 20), (3, 2, 1, 4)])
def test_compose_grad_pass_kernel_matches_plain(cuda, R, B, rows, L):
    """Ragged R and B (masked, never padded), chunk widths 128 and 64
    (R = 475 fits only the narrower one), a last chunk that is not full,
    ``rows`` that are no multiple of 8 (12, 7, 1): the kernel takes any.
    ``d_comp`` sums ``rows * L`` products per entry: it is held to
    1e-4 + 1e-5 of the sum of their absolute values, ``d_packed`` to the
    stream kernels' atol 1e-4 / rtol 1e-5; two launches give the same
    bits (per-block partials summed in a fixed order, no atomics)."""
    from mrgcn_tpu_torch.ops.sorted_stream import (
        compose_grad_pass, compose_grad_pass_reference)
    d_t, packed, comp = compose_case(R, B, rows, L, cuda, seed=R)
    before = compose_grad_pass.launches
    got = compose_grad_pass(d_t, packed, comp, R, B)
    again = compose_grad_pass(d_t, packed, comp, R, B)
    want = compose_grad_pass_reference(d_t, packed, comp, R, B)
    torch.cuda.synchronize()
    assert compose_grad_pass.launches == before + 2
    scale = d_t.reshape(R, -1).abs() @ packed.reshape(B, -1).abs().T
    assert bool(((got[0] - want[0]).abs() <= 1e-4 + 1e-5 * scale).all())
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,cols", [(5, 3, 1024), (121, 40, 8192),
                                      (475, 2, 10240), (33, 17, 2592),
                                      (1, 1, 4)])
def test_compose_table_kernel_matches_plain(cuda, R, B, cols):
    from mrgcn_tpu_torch.ops.compose_kernels import (compose_table,
                                                     compose_table_reference)
    rng = np.random.default_rng(cols)
    comp, pk = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(cuda) for s in ((R, B), (B, cols)))
    before = compose_table.launches
    got, again = compose_table(comp, pk), compose_table(comp, pk)
    torch.cuda.synchronize()
    assert compose_table.launches == before + 2
    torch.testing.assert_close(got, compose_table_reference(comp, pk),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(41, 3), (1548, 128), (7,), (0, 128),
                                   (2049, 1031)])
def test_canonical_copy_kernel_is_exact(cuda, shape):
    from mrgcn_tpu_torch.ops.compose_kernels import canonical_copy
    x = torch.randn(shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(0))
    before = canonical_copy.launches
    got = canonical_copy(x)
    torch.cuda.synchronize()
    assert canonical_copy.launches == before + (1 if x.numel() else 0)
    assert got.data_ptr() != x.data_ptr() or not x.numel()
    assert torch.equal(got, x)


@pytest.mark.gpu
def test_compose_kernels_reject_bad_arguments(cuda):
    from mrgcn_tpu_torch.ops.compose_kernels import (canonical_copy,
                                                     compose_table)
    from mrgcn_tpu_torch.ops.sorted_stream import compose_grad_pass
    d_t, packed, comp = compose_case(5, 3, 8, 128, cuda)
    with pytest.raises(TypeError, match="torch.float32"):
        compose_grad_pass(d_t.double(), packed, comp, 5, 3)
    with pytest.raises(ValueError, match="contiguous"):
        compose_grad_pass(d_t, packed, comp.T.contiguous().T, 5, 3)
    with pytest.raises(ValueError, match="is on cpu"):
        compose_grad_pass(d_t, packed.cpu(), comp, 5, 3)
    with pytest.raises(ValueError, match="multiple of 4"):
        compose_table(comp, torch.zeros(3, 6, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        canonical_copy(d_t[:, ::2])
    # compose_table holds B x 64 columns of packed twice over in shared
    # memory (its split fragments and the ring), whatever R is
    with pytest.raises(ValueError, match="shared memory"):
        compose_table(torch.zeros(40, 3000, device=cuda),
                      torch.zeros(3000, 128, device=cuda))


def hold_compose_grad(got, again, want, d_t, packed, R, B):
    """``d_comp`` within 1e-4 + 1e-5 of the sum of its terms' absolute
    values, ``d_packed`` atol 1e-4 / rtol 1e-5, two launches bit equal."""
    p_rows = packed.reshape(B, -1) if packed.dim() == 2 \
        else packed.contiguous().reshape(B, -1)
    scale = d_t.reshape(R, -1).abs() @ p_rows.abs().T
    assert bool(((got[0] - want[0]).abs() <= 1e-4 + 1e-5 * scale).all())
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,param_rows", [(12800, 12800), (3000, 3584),
                                             (7, 12)])
def test_compose_kernels_at_dmg_width_and_on_a_row_slice(cuda, rows,
                                                          param_rows):
    """#4 and #10 at DMG's R=121, B=40, L=128: the whole 12,800-row table,
    and ``packed`` cut from a longer parameter as ``_fit_rows`` cuts it
    (rows ``param_rows * L`` floats apart, taken without a copy)."""
    from mrgcn_tpu_torch.ops.compose_kernels import (compose_table,
                                                     compose_table_reference)
    from mrgcn_tpu_torch.ops.sorted_stream import (
        compose_grad_pass, compose_grad_pass_reference)
    R, B, L = 121, 40, 128
    gen = torch.Generator(device=cuda).manual_seed(rows)
    comp = torch.randn(R, B, device=cuda, generator=gen)
    param = torch.randn(B, param_rows, L, device=cuda, generator=gen)
    d_t = torch.randn(R * rows, L, device=cuda, generator=gen)
    packed = param[:, :rows]
    got = compose_grad_pass(d_t, packed, comp, R, B)
    again = compose_grad_pass(d_t, packed, comp, R, B)
    want = compose_grad_pass_reference(d_t, packed.contiguous(), comp, R, B)
    torch.cuda.synchronize()
    hold_compose_grad(got, again, want, d_t, packed, R, B)
    pk = packed.reshape(B, -1) if rows == param_rows \
        else packed.as_strided((B, rows * L), (param_rows * L, 1))
    table, table_again = compose_table(comp, pk), compose_table(comp, pk)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        table, compose_table_reference(comp, pk.contiguous()), rtol=1e-5,
        atol=1e-4)
    assert torch.equal(table, table_again)


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,rows,L", [(121, 40, 64, 128), (5, 3, 8, 128),
                                        (33, 17, 72, 36)])
def test_compose_packed_on_card_matches_cpu(cuda, R, B, rows, L):
    """``rspmm.compose_packed`` on the card (forward #10, backward #4, on a
    row slice of the parameter) against the CPU's plain products: output
    and both gradients within 1e-5 of the largest value."""
    from mrgcn_tpu_torch.ops import rspmm
    from mrgcn_tpu_torch.ops.compose_kernels import compose_table
    from mrgcn_tpu_torch.ops.sorted_stream import compose_grad_pass
    rng = np.random.default_rng(R)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    param = rng.standard_normal((B, rows + 8, L)).astype(np.float32)
    cot = rng.standard_normal((R, rows, L)).astype(np.float32)
    found = []
    for device in (cuda, torch.device("cpu")):
        c = torch.from_numpy(comp).to(device).requires_grad_()
        p = torch.from_numpy(param).to(device).requires_grad_()
        before = (compose_table.launches, compose_grad_pass.launches)
        out = rspmm.compose_packed(c, p[:, :rows])
        out.backward(torch.from_numpy(cot).to(device))
        on_card = int(device.type == "cuda")
        assert (compose_table.launches, compose_grad_pass.launches) \
            == (before[0] + on_card, before[1] + on_card)
        found.append([t.detach().cpu() for t in (out, c.grad, p.grad)])
    for got, want in zip(*found):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
