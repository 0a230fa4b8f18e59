"""The port's DistMult ranking against the JAX package's and against the
brute-force oracle of tests/test_ops.py.

Facts and embeddings are made with numpy from a seed. Ranks are integers
and must be equal exactly: to ``mrgcn_tpu.ops.distmult.compute_ranks`` and
to the oracle, raw and filtered. Cases: random facts with repeated (p, o)
and (s, p) groups (so the filter has work to do), planted ties with
integer-valued embeddings (half-tie rounding to even), ``num_valid``
padding, an explicit filter set, and chunk sizes that do not divide the
fact count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrgcn_tpu.ops import distmult as jdm
from mrgcn_tpu_torch.ops import distmult

from tests.test_ops import _brute_force_ranks


def lp_case(seed=7, num_nodes=12, num_edges=4, h=8, num_facts=20,
            integer=False):
    rng = np.random.default_rng(seed)
    if integer:   # products and sums exact in f32: ties are real ties
        E_nodes = rng.integers(-1, 2, (num_nodes, h)).astype(np.float32)
        E_edges = rng.integers(-1, 2, (num_edges, h)).astype(np.float32)
    else:
        E_nodes = rng.standard_normal((num_nodes, h)).astype(np.float32)
        E_edges = rng.standard_normal((num_edges, h)).astype(np.float32)
    data = np.stack([rng.integers(0, num_nodes, num_facts),
                     rng.integers(0, num_edges, num_facts),
                     rng.integers(0, num_nodes, num_facts)],
                    axis=1).astype(np.int32)
    return data, E_nodes, E_edges


def torch_ranks(data, E_nodes, E_edges, **kw):
    return distmult.compute_ranks(data, torch.from_numpy(E_nodes),
                                  torch.from_numpy(E_edges), **kw)


def jax_ranks(data, E_nodes, E_edges, **kw):
    return jdm.compute_ranks(data, jnp.asarray(E_nodes),
                             jnp.asarray(E_edges), **kw)


@pytest.mark.parametrize("seed,integer", [(7, False), (8, False), (9, True),
                                          (10, True)])
def test_ranks_equal_jax_and_bruteforce(seed, integer):
    data, E_nodes, E_edges = lp_case(seed, integer=integer)
    raw, flt = torch_ranks(data, E_nodes, E_edges)
    jraw, jflt = jax_ranks(data, E_nodes, E_edges)
    np.testing.assert_array_equal(raw, jraw)
    np.testing.assert_array_equal(flt, jflt)
    np.testing.assert_array_equal(
        raw, _brute_force_ranks(data, E_nodes, E_edges, filtered=False))
    np.testing.assert_array_equal(
        flt, _brute_force_ranks(data, E_nodes, E_edges, filtered=True))
    assert raw.dtype == np.int64 and (flt <= raw).all() and flt.min() >= 1
    if integer:
        assert (flt < raw).any()       # the filter did move some ranks


@pytest.mark.parametrize("num_nodes,want", [(5, 3), (4, 3), (6, 3), (7, 4),
                                            (2, 1), (3, 2)])
def test_half_tie_rounds_to_even(num_nodes, want):
    """All candidates tie: rank = round((ties - 1) / 2) + 1 with
    round-half-to-even, so 4 ties give round(1.5) = 2 and 6 ties give
    round(2.5) = 2 (reference: link_prediction.py:632-638)."""
    E_nodes = np.ones((num_nodes, 4), dtype=np.float32)
    E_edges = np.ones((1, 4), dtype=np.float32)
    data = np.array([[0, 0, 1]], dtype=np.int32)
    raw, flt = torch_ranks(data, E_nodes, E_edges)
    jraw, _ = jax_ranks(data, E_nodes, E_edges)
    np.testing.assert_array_equal(raw, [want, want])
    np.testing.assert_array_equal(raw, jraw)
    np.testing.assert_array_equal(flt, raw)


@pytest.mark.parametrize("chunk_size", [1, 3, 7, 20, 64])
def test_chunk_sizes_that_do_not_divide(chunk_size):
    data, E_nodes, E_edges = lp_case(11, integer=True)
    whole = torch_ranks(data, E_nodes, E_edges)
    En, Ee = torch.from_numpy(E_nodes), torch.from_numpy(E_edges)
    # budget_elems=1 keeps the chunk size from growing to the budget
    pending = distmult.launch_ranks(data, En, Ee, chunk_size=chunk_size,
                                    budget_elems=1)
    chunks = -(-len(data) // min(chunk_size, len(data)))
    assert [raw.shape[0] for _, raw, _ in pending.parts] == [chunks] * 2
    got = distmult.collect_many([pending])[0]
    np.testing.assert_array_equal(got[0], whole[0])
    np.testing.assert_array_equal(got[1], whole[1])
    want = jdm.collect_many([jdm.launch_ranks(
        data, jnp.asarray(E_nodes), jnp.asarray(E_edges),
        chunk_size=chunk_size, budget_elems=1)])[0]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("num_valid", [12, 9, 6])
def test_num_valid_masks_padding_candidates(num_valid):
    """Rows at or beyond ``num_valid`` are never candidates (they score
    -inf), as in mini-batch ranking."""
    data, E_nodes, E_edges = lp_case(12, integer=True)
    data[:, [0, 2]] %= num_valid
    got = torch_ranks(data, E_nodes, E_edges, num_valid=num_valid)
    want = jax_ranks(data, E_nodes, E_edges, num_valid=num_valid)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    cut = (data, E_nodes[:num_valid], E_edges)
    np.testing.assert_array_equal(
        got[0], _brute_force_ranks(*cut, filtered=False))
    np.testing.assert_array_equal(
        got[1], _brute_force_ranks(*cut, filtered=True))


def test_filtered_keeps_the_target_and_takes_an_explicit_fact_set():
    data, E_nodes, E_edges = lp_case(13, integer=True)
    more = np.concatenate([data, lp_case(14, integer=True)[0]])
    got = torch_ranks(data, E_nodes, E_edges, true_facts=more)
    want = jax_ranks(data, E_nodes, E_edges, true_facts=more)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # a fact listed twice is its own known-true candidate: the target
    # itself must stay unfiltered (rank >= 1 and finite)
    twice = np.concatenate([data[:3], data[:3]])
    raw, flt = torch_ranks(twice, E_nodes, E_edges)
    np.testing.assert_array_equal(
        flt, _brute_force_ranks(twice, E_nodes, E_edges, filtered=True))


def test_many_subsets_share_one_plan_and_one_fetch():
    """Chunks never span subsets, each subset is filtered against its own
    facts, and the plan is reusable with other embeddings."""
    data, E_nodes, E_edges = lp_case(15, num_facts=23, integer=True)
    subsets = [data[:5], data[5:8], data[8:]]
    plan, bounds = distmult.prepare_rank_chunks_many(
        subsets, E_nodes.shape[0], chunk_size=4, budget_elems=1)
    jplan, jbounds = jdm.prepare_rank_chunks_many(
        subsets, E_nodes.shape[0], chunk_size=4, budget_elems=1)
    assert bounds == jbounds and plan.chunk_meta == jplan.chunk_meta
    np.testing.assert_array_equal(plan.ff_dev.numpy(),
                                  np.asarray(jplan.ff_dev))
    np.testing.assert_array_equal(plan.fc_dev.numpy(),
                                  np.asarray(jplan.fc_dev))
    rng = np.random.default_rng(16)
    for _ in range(2):
        En = rng.integers(-1, 2, E_nodes.shape).astype(np.float32)
        Ee = rng.integers(-1, 2, E_edges.shape).astype(np.float32)
        raw, flt = distmult.collect_many([distmult.launch_ranks_plan(
            plan, torch.from_numpy(En), torch.from_numpy(Ee))])[0]
        T = len(data)
        for sub, (s, n) in zip(subsets, bounds):
            for got, filtered in ((raw, False), (flt, True)):
                np.testing.assert_array_equal(
                    np.concatenate([got[s:s + n], got[T + s:T + s + n]]),
                    _brute_force_ranks(sub, En, Ee, filtered=filtered))


def test_score_and_mrr_hits_match_jax():
    data, E_nodes, E_edges = lp_case(17)
    got = distmult.score(*(torch.from_numpy(data[:, i]).long()
                           for i in range(3)),
                         torch.from_numpy(E_nodes), torch.from_numpy(E_edges))
    want = jdm.score(data[:, 0], data[:, 1], data[:, 2],
                     jnp.asarray(E_nodes), jnp.asarray(E_edges))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ranks = np.array([1, 2, 3, 10, 11, 400])
    assert distmult.mrr_hits(ranks) == jdm.mrr_hits(ranks)
