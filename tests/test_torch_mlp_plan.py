"""The fused MLP kernels' launch plan and their decomposition, on the CPU.

``mlp_plan`` is what the wrappers hand the CUDA kernels: the forward and
dx kernels' persistent blocks over 192- and 128-row tiles, and the
weight-gradient kernel's (hidden chunk, row segment) grid, one f32
partial per segment. The tests sweep M, d, hd and the SM count: every
row falls in exactly one tile and one segment, no segment is empty, and
the workspace is the size the C side indexes (segments x (2 d hd + hd +
d)).

``emulate_fwd`` / ``emulate_bwd`` compute what the kernels compute in the
order they compute it: the hidden width in 64-column chunks (each chunk's
``hb`` and ``dh_pre`` formed alone), the output and ``dx`` summed over the
chunks in order, the weight gradients summed over each segment's 64-row
tiles in order and then over the segments in order. Tolerances: in f32
(every cast an identity) they differ from the JAX package's Pallas
kernels (interpret mode, through ``jax.vjp``) only in summation order:
forward 2e-5, gradients 2e-4, ``tests/test_torch_encoders.py``'s bounds;
in bf16 they are held to the plain version by the kernels' own
element-wise bound (``ops/kernel_bounds.py``: bf16 intermediates rounded
from sums taken in other orders land a bf16 step apart). The emulation
takes ``tanh`` at full precision, where the kernels take ``tanh.approx``;
the card's tests hold that difference to the same bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.ops.fused_mlp import fused_mlp as jax_mlp
from mrgcn_tpu_torch.ops import fused_mlp as fm
from mrgcn_tpu_torch.ops.kernel_bounds import bf16_error, mlp_scales


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------

def covered_rows(tiles, blocks, tile, M):
    """Rows the persistent blocks' tiles cover, as the kernels walk them."""
    walked = [t for b in range(blocks) for t in range(b, tiles, blocks)]
    return sorted(r for t in walked
                  for r in range(t * tile, min(M, (t + 1) * tile)))


@pytest.mark.parametrize("M", [1, 63, 64, 65, 128, 129, 193, 4097, 32001,
                               1_024_000])
@pytest.mark.parametrize("d,hd,sms", [(128, 512, 132), (48, 64, 132),
                                      (16, 1024, 7)])
def test_plan_covers_every_row_once(M, d, hd, sms):
    plan = fm.mlp_plan(M, d, hd, sms)
    assert covered_rows(plan.fwd_tiles, plan.fwd_blocks, fm.FWD_ROW_TILE,
                        M) == list(range(M))
    assert covered_rows(plan.bwd_tiles, plan.bwd_blocks, fm.BWD_ROW_TILE,
                        M) == list(range(M))
    assert 1 <= plan.fwd_blocks <= min(plan.fwd_tiles, sms)
    assert 1 <= plan.bwd_blocks <= min(plan.bwd_tiles, sms)
    assert plan.chunks * fm.HIDDEN_CHUNK == hd
    assert plan.seg_rows % fm.SEGMENT_ROWS == 0
    segments = [range(s * plan.seg_rows, min(M, (s + 1) * plan.seg_rows))
                for s in range(plan.segments)]
    assert all(len(s) > 0 for s in segments)
    assert [r for s in segments for r in s] == list(range(M))
    # the C side's own check of the segments
    assert plan.segments * plan.seg_rows >= M
    assert (plan.segments - 1) * plan.seg_rows < M
    assert plan.grad_floats == 2 * d * hd + hd + d
    assert plan.part_floats == plan.segments * plan.grad_floats
    # the weight-gradient blocks fit one wave, within the workspace cap
    blocks = plan.chunks * plan.segments
    assert blocks <= max(sms, plan.chunks)
    assert blocks <= max(fm.MAX_DW_BLOCKS, plan.chunks)


@pytest.mark.parametrize("sms", [1, 66, 132, 1000])
def test_plan_fills_the_card_within_the_workspace(sms):
    """At the text encoder's shape the weight-gradient grid (8 hidden
    chunks a segment) leaves fewer SMs idle than one segment's worth, in
    one wave, and never holds more than 32 weight-sized partials."""
    plan = fm.mlp_plan(1_024_000, 128, 512, sms)
    assert plan.segments == max(1, min(sms // 8, 32))
    assert plan.fwd_blocks == min(sms, plan.fwd_tiles)
    assert plan.bwd_blocks == min(sms, plan.bwd_tiles)


@pytest.mark.parametrize("M,sms", [(0, 132), (5, 0)])
def test_plan_rejects_no_rows_or_no_card(M, sms):
    with pytest.raises(ValueError, match="mlp_plan"):
        fm.mlp_plan(M, 128, 512, sms)


# --------------------------------------------------------------------------
# the decomposition
# --------------------------------------------------------------------------

def emulate_fwd(x, w1, b1, w2, b2):
    """The forward kernel's order: the output summed over 64-column
    hidden chunks in order, the bias added at the end."""
    xf, acc = x.float(), torch.zeros(x.shape, dtype=torch.float32)
    for c in range(0, w1.shape[1], fm.HIDDEN_CHUNK):
        cols = slice(c, c + fm.HIDDEN_CHUNK)
        h = fm.gelu_tanh(xf @ w1[:, cols].float() + b1[cols].float())
        acc = acc + h.to(x.dtype).float() @ w2[cols].float()
    return (acc + b2.float()).to(x.dtype)


def emulate_bwd(x, w1, b1, w2, d_out, plan):
    """The backward kernels' order: dx summed over the chunks in order; per
    (chunk, segment) the weight partials summed over the segment's 64-row
    tiles in order; the partials summed over the segments in order."""
    M, d = x.shape
    hd = w1.shape[1]
    xf, do = x.float(), d_out.to(x.dtype).float()
    dx = torch.zeros((M, d), dtype=torch.float32)
    parts = []
    for s in range(plan.segments):
        parts.append([torch.zeros(d, hd), torch.zeros(hd, d),
                      torch.zeros(hd), torch.zeros(d)])
    for c in range(0, hd, fm.HIDDEN_CHUNK):
        cols = slice(c, c + fm.HIDDEN_CHUNK)
        w1c, w2c = w1[:, cols].float(), w2[cols].float()
        h_pre = xf @ w1c + b1[cols].float()
        hb = fm.gelu_tanh(h_pre).to(x.dtype).float()
        dh_pre = fm._gelu_tanh_grad(h_pre) * (do @ w2c.t())
        dh_b = dh_pre.to(x.dtype).float()
        dx = dx + dh_b @ w1c.t()
        for s, (dw1, dw2, db1, db2) in enumerate(parts):
            for r in range(s * plan.seg_rows,
                           min(M, (s + 1) * plan.seg_rows),
                           fm.SEGMENT_ROWS):
                rows = slice(r, r + fm.SEGMENT_ROWS)
                dw1[:, cols] += xf[rows].t() @ dh_b[rows]
                dw2[cols] += hb[rows].t() @ do[rows]
                db1[cols] += dh_pre[rows].sum(0)
                if c == 0:
                    db2 += do[rows].sum(0)
    grads = []
    for i in range(4):
        total = parts[0][i]
        for p in parts[1:]:
            total = total + p[i]
        grads.append(total)
    dw1, dw2, db1, db2 = grads
    return dx.to(x.dtype), dw1, db1, dw2, db2


def mlp_inputs(M, d, hd, seed, dtype):
    rng = np.random.default_rng(seed)
    shapes_scales = (((M, d), 1.0), ((d, hd), d ** -0.5), ((hd,), 0.5),
                     ((hd, d), hd ** -0.5), ((d,), 0.5), ((M, d), 1.0))
    return [torch.from_numpy((rng.standard_normal(s) * k)
                             .astype(np.float32)).to(dtype)
            for s, k in shapes_scales]


@pytest.mark.parametrize("M,d,hd,sms", [(300, 48, 128, 4), (129, 16, 64, 2),
                                        (700, 64, 192, 6)])
def test_decomposition_matches_plain_version(M, d, hd, sms):
    """bf16, as the kernels run: within the kernels' element-wise bound of
    the plain version, forward and every gradient."""
    x, w1, b1, w2, b2, do = mlp_inputs(M, d, hd, M + hd, torch.bfloat16)
    plan = fm.mlp_plan(M, d, hd, sms)
    assert plan.segments > 1
    scales = mlp_scales(x, w1, b1, w2, b2, do)
    got = (emulate_fwd(x, w1, b1, w2, b2),) + emulate_bwd(x, w1, b1, w2, do,
                                                          plan)
    want = (fm.mlp_fwd_reference(x, w1, b1, w2, b2),) \
        + fm.mlp_bwd_reference(x, w1, b1, w2, do)
    for name, g, w, s in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got,
                             want, scales):
        _, ratio = bf16_error(g, w, s)
        assert ratio <= 1.0, (name, ratio)


@pytest.mark.parametrize("M,d,hd,sms", [(300, 48, 128, 4), (37, 16, 64, 1)])
def test_decomposition_matches_jax_kernel(M, d, hd, sms):
    """f32: the JAX package's Pallas kernels (interpret mode) and their
    VJP, 2e-5 forward and 2e-4 on the gradients."""
    x, w1, b1, w2, b2, do = mlp_inputs(M, d, hd, 7 * M + d, torch.float32)
    plan = fm.mlp_plan(M, d, hd, sms)
    want, vjp = jax.vjp(lambda *a: jax_mlp(*a, interpret=True),
                        *(jnp.asarray(t.numpy()) for t in (x, w1, b1, w2,
                                                            b2)))
    want_dx, want_dw1, want_db1, want_dw2, want_db2 = vjp(
        jnp.asarray(do.numpy()))
    out = emulate_fwd(x, w1, b1, w2, b2)
    dx, dw1, db1, dw2, db2 = emulate_bwd(x, w1, b1, w2, do, plan)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for g, w in ((dx, want_dx), (dw1, want_dw1), (db1, want_db1),
                 (dw2, want_dw2), (db2, want_db2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
