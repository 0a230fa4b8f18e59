"""The port's unplanned aggregation paths against the JAX package's.

``transform_aggregate``, ``gather_aggregate`` and
``gather_aggregate_packed`` are what a layer takes when its edges carry no
sorted-stream plan (every mini-batch block). Each branch (the direct
``(R * n, out)`` table, the fused-basis gather in one piece, and the
fused-basis gather in edge chunks that gather again in the backward) is
forced by a small ``budget_elems`` and held against the JAX function with
the same budgets, forward and every gradient, on one random graph made with
numpy from a seed, padding edges included (``norm`` 0, ``src`` out of
range). Tolerance: 1e-5 of the largest value (f32 sums in other orders).
The budgets and the padded-size rule are the JAX package's, so both take
the same branch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.ops import rspmm as jr
from mrgcn_tpu_torch.ops import rspmm as tr

from tests.test_torch_basis import assert_close

N_OUT, N_COLS, R, E = 23, 41, 5, 300
BIG = 2 ** 27
# direct table; fused basis in one piece; fused basis in chunks of 8 edges
BRANCHES = {"direct": (BIG, BIG), "fused": (1, BIG), "chunked": (1, 1)}


def edges(seed=0, pad=12):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_OUT, E).astype(np.int32)
    dst = rng.integers(0, N_COLS, E).astype(np.int32)
    rel = rng.integers(0, R, E).astype(np.int32)
    norm = rng.random(E).astype(np.float32)
    # padding edges: dropped by the segment sum, zero weight
    src[-pad:], dst[-pad:], rel[-pad:], norm[-pad:] = N_OUT, 0, 0, 0.0
    return src, dst, rel, norm


def both(jfn, tfn, arrays, static, kwargs, cot):
    """Outputs and gradients with respect to ``arrays`` (dict name ->
    float array; None entries are passed as None) of the JAX and the torch
    function called as ``fn(*arrays, *static, **kwargs)``."""
    names = [k for k, v in arrays.items() if v is not None]

    def jcall(*leaves):
        full = dict(arrays, **dict(zip(names, leaves)))
        return jfn(*full.values(), *static["jax"], **kwargs)

    want, vjp = jax.vjp(jcall, *(jnp.asarray(arrays[k]) for k in names))
    want_grads = vjp(jnp.asarray(cot))

    leaves = {k: torch.from_numpy(arrays[k]).requires_grad_() for k in names}
    got = tfn(*dict(arrays, **leaves).values(), *static["torch"], **kwargs)
    got.backward(torch.from_numpy(cot))
    assert_close(got.detach().numpy(), want)
    for k, w in zip(names, want_grads):
        assert_close(leaves[k].grad.numpy(), w)
    return got.detach().numpy()


def static_args(src, dst, rel, norm, *rest):
    return {"jax": (*map(jnp.asarray, (src, dst, rel, norm)), *rest),
            "torch": (*map(torch.from_numpy, (src, dst, rel, norm)), *rest)}


def test_budgets_and_padded_size_are_the_jax_package_s():
    assert tr.DIRECT_BUDGET_ELEMS == jr.DIRECT_BUDGET_ELEMS
    assert tr.MESSAGE_BUDGET_ELEMS == jr.MESSAGE_BUDGET_ELEMS
    for rows, minor in ((1, 1), (8, 128), (9, 129), (1000, 16), (7, 300)):
        assert tr._padded_elems(rows, minor) == jr._padded_elems(rows, minor)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("bases,out_dim", [(0, 6), (3, 6), (3, 200)])
def test_gather_aggregate_matches_jax(branch, bases, out_dim):
    budget, message_budget = BRANCHES[branch]
    rng = np.random.default_rng(1)
    S = bases or R
    arrays = {"node_weights": rng.standard_normal(
        (S, N_COLS, out_dim)).astype(np.float32)}
    comp = rng.standard_normal((R, S)).astype(np.float32) if bases else None
    cot = rng.standard_normal((N_OUT, out_dim)).astype(np.float32)
    static = static_args(*edges(), N_OUT)

    # comp is differentiated too where there is one
    if bases:
        arrays["comp"] = comp

        def jfn(w, c, *rest, **kw):
            return jr.gather_aggregate(w, *rest, comp=c, **kw)

        def tfn(w, c, *rest, **kw):
            return tr.gather_aggregate(w, *rest, comp=c, **kw)
    else:
        jfn, tfn = jr.gather_aggregate, tr.gather_aggregate
    out = both(jfn, tfn, arrays, static,
               dict(budget_elems=budget, message_budget_elems=message_budget),
               cot)
    # the dense oracle
    src, dst, rel, norm = edges()
    W = arrays["node_weights"] if not bases else np.einsum(
        "rb,bno->rno", comp, arrays["node_weights"])
    want = np.zeros((N_OUT + 1, out_dim))
    np.add.at(want, src, W[rel, dst] * norm[:, None])
    assert_close(out, want[:N_OUT])


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("bases", [0, 3])
def test_transform_aggregate_matches_jax(branch, bases):
    budget, message_budget = BRANCHES[branch]
    in_dim, out_dim = 9, 7
    rng = np.random.default_rng(2)
    S = bases or R
    arrays = {"H": rng.standard_normal((N_COLS, in_dim)).astype(np.float32),
              "basis": rng.standard_normal(
                  (S, in_dim, out_dim)).astype(np.float32),
              "comp": rng.standard_normal((R, S)).astype(np.float32)
              if bases else None}
    cot = rng.standard_normal((N_OUT, out_dim)).astype(np.float32)
    src, dst, rel, norm = edges(seed=3)

    def order(fn, conv):
        def call(H, basis, comp=None, **kw):
            return fn(H, *map(conv, (src, dst, rel, norm)), N_OUT, basis,
                      comp=comp, **kw)
        return call

    out = both(order(jr.transform_aggregate, jnp.asarray),
               order(tr.transform_aggregate, torch.from_numpy), arrays,
               {"jax": (), "torch": ()},
               dict(budget_elems=budget, message_budget_elems=message_budget),
               cot)
    W = arrays["basis"] if not bases else np.einsum(
        "rb,bio->rio", arrays["comp"], arrays["basis"])
    want = np.zeros((N_OUT + 1, out_dim))
    np.add.at(want, src, np.einsum("ei,eio->eo", arrays["H"][dst], W[rel])
              * norm[:, None])
    assert_close(out, want[:N_OUT])


@pytest.mark.parametrize("bases", [0, 3])
@pytest.mark.parametrize("out_dim", [16, 14, 5, 64])
def test_gather_aggregate_packed_matches_jax(bases, out_dim):
    rng = np.random.default_rng(4)
    S = bases or R
    shape, k = tr.packed_identity_shape(S, N_COLS, out_dim, row_multiple=8)
    assert (shape, k) == jr.packed_identity_shape(S, N_COLS, out_dim,
                                                  row_multiple=8)
    assert k > 1
    arrays = {"packed": rng.standard_normal(shape).astype(np.float32),
              "comp": rng.standard_normal((R, S)).astype(np.float32)
              if bases else None}
    cot = rng.standard_normal((N_OUT, out_dim)).astype(np.float32)
    src, dst, rel, norm = edges(seed=5)

    def order(fn, conv):
        def call(packed, comp=None):
            return fn(packed, *map(conv, (src, dst, rel, norm)), N_OUT,
                      out_dim, k, comp=comp)
        return call

    both(order(jr.gather_aggregate_packed, jnp.asarray),
         order(tr.gather_aggregate_packed, torch.from_numpy), arrays,
         {"jax": (), "torch": ()}, {}, cot)


def test_chunked_backward_gathers_again_and_keeps_no_messages():
    """Over the message budget the edges go in chunks whose backward
    gathers ``flat`` again: the result and the gradients equal the
    one-piece path's to 1e-6, and 300 edges at 8 a chunk make 38 chunks."""
    rng = np.random.default_rng(6)
    src, dst, rel, norm = map(torch.from_numpy, edges(seed=7))
    B, out_dim = 3, 6
    calls = []
    kept = tr._ChunkMessages.apply

    def counting(*args):
        calls.append(args[2].shape[0])
        return kept(*args)

    results = []
    for budget in (BIG, 1):
        flat = torch.from_numpy(rng.standard_normal(
            (N_COLS, B * out_dim)).astype(np.float32)).requires_grad_()
        comp = torch.from_numpy(rng.standard_normal(
            (R, B)).astype(np.float32)).requires_grad_()
        rng = np.random.default_rng(6)                  # same draws again
        tr._ChunkMessages.apply = counting
        try:
            out = tr._fused_basis_aggregate(flat, src, dst, rel, norm, comp,
                                            N_OUT, out_dim, budget)
        finally:
            tr._ChunkMessages.apply = kept
        out.sum().backward()
        results.append((out.detach(), flat.grad, comp.grad))
    assert calls == [8] * 37 + [4]
    for a, b in zip(*results):
        assert_close(b.numpy(), a.numpy(), 1e-6)
