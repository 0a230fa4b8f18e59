"""The port's planned dense layer op against the JAX package's.

``dense_aggregate`` (``out[s] = sum_e norm_e H[dst_e] W[rel_e]``) and its
hand-written backward, on small graphs made with numpy from a seed
(row_block 16, edge_block 8): both ``rel_const`` layouts of the ``fwd``
and ``bwd_h`` streams, input packing factors 1, 2 and 4, and a
rectangular (frontier-restricted) plan. Forward values agree to 2e-5 and
the H and W gradients to 2e-4 (f32 sums in different orders, as in
tests/test_torch_layers.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.ops import relational as jrl
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm

from tests.test_torch_layers import assert_plans_equal

RB, EB = 16, 8


def dense_case(seed, n, R, E, in_dim, out_dim, n_out=None):
    """Plans of both packages for one dense layer shape, and H, W and the
    output cotangent."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_out or n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    rel = rng.integers(0, R, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    k_in, k_out = rspmm.packing_factor(in_dim), rspmm.packing_factor(out_dim)
    kw = {"num_out_nodes": n_out} if n_out else {}
    mine = rl.build_layer_plans(src, dst, rel, norm, n, k_in, k_out,
                                row_block=RB, edge_block=EB, **kw)
    theirs = jrl.build_layer_plans(src, dst, rel, norm, n, k_in, k_out,
                                   row_block=RB, edge_block=EB, **kw)
    assert_plans_equal(mine, theirs)
    H = rng.standard_normal((n, in_dim)).astype(np.float32)
    W = rng.standard_normal((R, in_dim, out_dim)).astype(np.float32)
    cot = rng.standard_normal((n_out or n, out_dim)).astype(np.float32)
    return mine, theirs, H, W, cot


# (seed, n, R, E, in_dim, out_dim, n_out, rel_const of fwd and bwd_h):
# few relations over many edges keep relation-constant slabs cheap, many
# relations over few edges do not
CASES = {
    "rel_const_k4": (1, 60, 2, 400, 21, 16, None, (True, True)),
    "per_edge_k4": (2, 57, 40, 311, 21, 16, None, (False, False)),
    "rel_const_k2": (3, 60, 2, 400, 40, 14, None, (True, True)),
    "per_edge_k1": (4, 57, 40, 311, 72, 16, None, (False, False)),
    "rel_const_k1": (5, 50, 3, 500, 72, 8, None, (True, True)),
    "rectangular": (6, 70, 2, 450, 21, 16, 23, (True, True)),
    "rectangular_per_edge": (7, 200, 60, 300, 16, 14, 23, (False, False)),
    "rectangular_mixed": (7, 400, 60, 1500, 16, 14, 23, (True, False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_aggregate_fwd_and_grads_match_jax(case):
    seed, n, R, E, in_dim, out_dim, n_out, rel_const = CASES[case]
    mine, theirs, H, W, cot = dense_case(seed, n, R, E, in_dim, out_dim,
                                         n_out)
    assert (mine.fwd.rel_const, mine.bwd_h.rel_const) == rel_const

    want, vjp = jax.vjp(
        lambda h, w: jrl.dense_aggregate(h, w, theirs, in_dim, out_dim),
        jnp.asarray(H), jnp.asarray(W))
    want_dH, want_dW = vjp(jnp.asarray(cot))

    h = torch.tensor(H, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    got = rl.dense_aggregate(h, w, mine, in_dim, out_dim)
    got.backward(torch.from_numpy(cot))

    assert got.shape == want.shape == (n_out or n, out_dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_dH),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dW),
                               rtol=2e-4, atol=2e-4)


def test_dense_aggregate_runs_one_scatter_each_way(monkeypatch):
    mine, _, H, W, cot = dense_case(*CASES["rel_const_k4"][:7])
    calls = []
    real = rl.sorted_scatter

    def spy(msgs, local, blk, out_rows, row_block, edge_block):
        calls.append((local.data_ptr(), out_rows))
        return real(msgs, local, blk, out_rows, row_block, edge_block)

    monkeypatch.setattr(rl, "sorted_scatter", spy)
    h = torch.tensor(H, requires_grad=True)
    w = torch.tensor(W, requires_grad=True)
    rl.dense_aggregate(h, w, mine, 21, 16).backward(torch.from_numpy(cot))
    assert calls == [(mine.fwd.scatter_local.data_ptr(), mine.n_out_rows),
                     (mine.bwd_h.scatter_local.data_ptr(), mine.n_in_rows)]
