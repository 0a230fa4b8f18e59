"""The port's compose kernels' wrappers against the JAX package's.

``compose_grad_pass``'s plain version against
``mrgcn_tpu.ops.pallas_gather.compose_grad_pass`` (its XLA branch and the
Pallas kernel in interpret mode) on ragged R, B and rows, ``rows % 8 != 0``
included (the JAX function takes its plain contractions there). Inputs
come from numpy generators with fixed seeds. Tolerance: 1e-5 of the
largest value (f32 sums taken in other orders). The two compose
micro-kernels' plain versions are held against numpy. The layer route
through them is tests/test_torch_compose_route.py's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrgcn_tpu.ops import pallas_gather as jpg
from mrgcn_tpu_torch.ops import compose_kernels as ck
from mrgcn_tpu_torch.ops import rspmm
from mrgcn_tpu_torch.ops import sorted_stream as ss

from tests.test_torch_basis import assert_close


def grad_case(R, B, rows, L, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R * rows, L)).astype(np.float32),
            rng.standard_normal((B * rows, L)).astype(np.float32),
            rng.standard_normal((R, B)).astype(np.float32))


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("R,B,rows,L", [(5, 3, 8, 128), (7, 4, 24, 128),
                                        (3, 2, 16, 256), (4, 3, 12, 128),
                                        (6, 1, 40, 128)])
def test_compose_grad_pass_matches_jax(R, B, rows, L, interpret):
    """rows 12 is no multiple of 8: the JAX function takes its plain
    contractions there, whatever ``interpret`` says."""
    d_t, packed, comp = grad_case(R, B, rows, L, seed=R + rows)
    want = jpg.compose_grad_pass(jnp.asarray(d_t), jnp.asarray(packed),
                                 jnp.asarray(comp), R, B,
                                 interpret=interpret)
    args = (torch.from_numpy(d_t), torch.from_numpy(packed),
            torch.from_numpy(comp), R, B)
    for got in (ss.compose_grad_pass(*args),
                ss.compose_grad_pass_reference(*args)):
        assert got[0].shape == (R, B) and got[1].shape == (B * rows, L)
        for g, w in zip(got, want):
            assert_close(g.numpy(), w)
    # the einsums of the docstring, in f64
    d3, p3 = (a.astype(np.float64).reshape(-1, rows, L)
              for a in (d_t, packed))
    assert_close(got[0].numpy(), np.einsum("rql,bql->rb", d3, p3))
    assert_close(got[1].numpy().reshape(B, rows, L),
                 np.einsum("rb,rql->bql", comp.astype(np.float64), d3))


def test_compose_grad_pass_counts_no_launch_on_the_cpu():
    before = ss.compose_grad_pass.launches
    d_t, packed, comp = (torch.from_numpy(a) for a in grad_case(3, 2, 8, 128))
    ss.compose_grad_pass(d_t, packed, comp, 3, 2)
    assert ss.compose_grad_pass.launches == before


@pytest.mark.parametrize("bad", ["comp", "packed", "rows", "R"])
def test_compose_grad_pass_rejects_shapes_that_do_not_fit(bad):
    d_t, packed, comp = (torch.from_numpy(a) for a in grad_case(3, 2, 8, 128))
    R = 3
    if bad == "comp":
        comp = comp.T.contiguous()
    elif bad == "packed":
        packed = packed[:-1]
    elif bad == "rows":
        d_t = d_t[:-1]
    else:
        R = 0
    with pytest.raises(ValueError, match="do not fit"):
        ss.compose_grad_pass(d_t, packed, comp, R, 2)


@pytest.mark.parametrize("R,B,cols", [(5, 3, 1024), (121, 40, 256),
                                      (475, 2, 36), (1, 1, 4)])
def test_compose_table_plain_version_matches_numpy(R, B, cols):
    rng = np.random.default_rng(R + cols)
    comp = rng.standard_normal((R, B)).astype(np.float32)
    pk = rng.standard_normal((B, cols)).astype(np.float32)
    want = comp.astype(np.float64) @ pk.astype(np.float64)
    before = ck.compose_table.launches
    for fn in (ck.compose_table, ck.compose_table_reference):
        got = fn(torch.from_numpy(comp), torch.from_numpy(pk))
        assert got.shape == (R, cols) and got.dtype == torch.float32
        assert_close(got.numpy(), want)
    assert ck.compose_table.launches == before
    # relation-major: the reshape to the (R * rows, L) table is free
    packed = pk.reshape(B, -1, 4)
    table = rspmm.compose_packed(torch.from_numpy(comp),
                                 torch.from_numpy(packed))
    assert_close(got.numpy().reshape(table.shape), table.numpy())


def test_compose_table_rejects_shapes_that_do_not_multiply():
    with pytest.raises(ValueError, match="do not multiply"):
        ck.compose_table(torch.zeros(3, 2), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="do not multiply"):
        ck.compose_table(torch.zeros(0, 2), torch.zeros(2, 8))


@pytest.mark.parametrize("shape", [(41, 3), (16, 128), (0, 128), (7,)])
def test_canonical_copy_plain_version_matches_numpy(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    before = ck.canonical_copy.launches
    for fn in (ck.canonical_copy, ck.canonical_copy_reference):
        t = torch.from_numpy(x)
        got = fn(t)
        assert got.data_ptr() != t.data_ptr() or x.size == 0
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), x)
    assert ck.canonical_copy.launches == before
