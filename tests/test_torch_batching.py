"""The port's mini-batch sampler against the JAX package's.

Both samplers run on the host with numpy, on the same random graph made
from a seed, and where a hop is sampled with ``np.random.Generator``s of
the same seed: every array must be **equal**, element for element and
dtype for dtype (no tolerance). The native C++ hop and the numpy hop give
the same ids; a fan-out without an ``rng`` raises in the port (the JAX
function falls back to a fixed seed there); ``device_put_batches`` keeps
structure and values.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mrgcn_tpu.data import batching as jb
from mrgcn_tpu_torch.data import batching as tb
from mrgcn_tpu_torch.data import native
from mrgcn_tpu_torch.models.rgcn import EdgeBlock

BLOCK_ARRAYS = ("src", "dst", "rel", "norm", "dst_global", "grp_src",
                "grp_dst", "grp_norm", "group_rel")


def random_structure(seed=0, n=90, R=5, E=700):
    rng = np.random.default_rng(seed)
    # a few heavy sources, so a fan-out cap has edges to drop
    src = np.where(rng.random(E) < 0.3, rng.integers(0, 4, E),
                   rng.integers(0, n, E)).astype(np.int32)
    return SimpleNamespace(
        src=src, dst=rng.integers(0, n, E).astype(np.int32),
        rel=rng.integers(0, R, E).astype(np.int32),
        norm=rng.random(E).astype(np.float32), num_nodes=n,
        num_relations=R)


def same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_blocks_equal(mine, theirs):
    assert len(mine) == len(theirs)
    for layer, (a, b) in enumerate(zip(mine, theirs)):
        assert (a.num_out, a.num_in, a.group_size) \
            == (b.num_out, b.num_in, b.group_size), layer
        for name in BLOCK_ARRAYS:
            same(getattr(a, name), getattr(b, name), f"layer {layer} {name}")


@pytest.mark.parametrize("n,minimum", [(0, 64), (64, 64), (65, 64),
                                       (1000, 256), (3, 4)])
def test_bucket_matches_jax(n, minimum):
    assert tb.bucket(n, minimum) == jb.bucket(n, minimum)


@pytest.mark.parametrize("fanout", [None, -1, 3, [2, 0], [None, 5],
                                    [0, -1]])
def test_normalize_fanout_matches_jax(fanout):
    assert tb.normalize_fanout(fanout, 2) == jb.normalize_fanout(fanout, 2)


def test_normalize_fanout_rejects_wrong_length():
    with pytest.raises(ValueError, match="3 entries for 2 layers"):
        tb.normalize_fanout([1, 2, 3], 2)


def test_edge_index_and_out_edges_equal_jax():
    s = random_structure(seed=1)
    mine, theirs = tb.EdgeIndex(s), jb.EdgeIndex(s)
    for name in ("src", "dst", "rel", "norm", "indptr"):
        same(getattr(mine, name), getattr(theirs, name), name)
    nodes = np.array([0, 3, 17, 17, 89])
    same(mine.out_edges(nodes), theirs.out_edges(nodes))
    same(mine.out_edges(np.array([], dtype=np.int64)),
         theirs.out_edges(np.array([], dtype=np.int64)))


@pytest.mark.parametrize("use_native", [True, False])
def test_hop_equals_jax_and_numpy_path(monkeypatch, use_native):
    """The port's hop (its own native library, or numpy) against the JAX
    package's numpy hop."""
    s = random_structure(seed=2)
    mine, theirs = tb.EdgeIndex(s), jb.EdgeIndex(s)
    if use_native:
        lib = native.get_sampler_lib()
        if lib is None:
            pytest.skip("no C++ compiler: the native sampler did not build")
        assert "_build" in native._SAMPLER_SO
        assert "mrgcn_tpu_torch" in native._SAMPLER_SRC
    else:
        monkeypatch.setattr(tb, "get_sampler_lib", lambda: None)
    import mrgcn_tpu.data.native as jnative
    monkeypatch.setattr(jnative, "get_sampler_lib", lambda: None)
    for nodes in (np.array([5, 0, 33], dtype=np.int32),
                  np.arange(s.num_nodes, dtype=np.int32),
                  np.array([], dtype=np.int32)):
        eids, neigh = mine.hop(nodes)
        want_eids, want_neigh = theirs.hop(nodes)
        same(eids, want_eids)
        same(neigh, want_neigh)
    if use_native:
        with pytest.raises(ValueError, match="out of range"):
            mine.hop(np.array([s.num_nodes], dtype=np.int32))
        # the scratch marks are clean again after the failed call
        same(mine.hop(np.array([1], dtype=np.int32))[1],
             theirs.hop(np.array([1], dtype=np.int32))[1])


@pytest.mark.parametrize("fanout", [1, 3, 1000])
def test_hop_sampled_equals_jax_with_the_same_generator(fanout):
    s = random_structure(seed=3)
    mine, theirs = tb.EdgeIndex(s), jb.EdgeIndex(s)
    nodes = np.array([0, 1, 2, 3, 40, 41], dtype=np.int32)
    got = mine.hop_sampled(nodes, fanout, np.random.default_rng(7))
    want = theirs.hop_sampled(nodes, fanout, np.random.default_rng(7))
    for g, w, what in zip(got, want, ("eids", "neighbours", "scale")):
        same(g, w, what)
    if fanout == 1:
        assert len(got[0]) <= len(nodes) and got[2].max() > 1.0
    empty = mine.hop_sampled(np.array([], dtype=np.int32), 2,
                             np.random.default_rng(0))
    assert [len(a) for a in empty] == [0, 0, 0]


@pytest.mark.parametrize("fanout", [None, 3, [2, None], [None, 1]])
@pytest.mark.parametrize("seed,num_layers", [(4, 2), (5, 3)])
def test_sample_minibatch_arrays_equal_jax(fanout, seed, num_layers):
    if isinstance(fanout, list):
        fanout = (fanout + [None] * num_layers)[:num_layers]
    s = random_structure(seed=seed)
    batch_nodes = np.random.default_rng(seed).choice(s.num_nodes, 9,
                                                     replace=False)
    batch_nodes = np.sort(batch_nodes).astype(np.int32)
    kw = dict(num_layers=num_layers, edge_bucket=32, node_bucket=8,
              fanout=fanout)
    got = tb.sample_minibatch(tb.EdgeIndex(s), batch_nodes,
                              rng=np.random.default_rng(11), **kw)
    want = jb.sample_minibatch(jb.EdgeIndex(s), batch_nodes,
                               rng=np.random.default_rng(11), **kw)
    assert_blocks_equal(got.layer_edges, want.layer_edges)
    same(got.batch_nodes, want.batch_nodes)
    same(got.outer_nodes, want.outer_nodes)
    assert got.num_batch == want.num_batch == 9
    # a mini-batch block has no plan, whatever the layer shape
    assert all(e.plan_for(16, 16, identity=True) is None
               for e in got.layer_edges)


def test_sample_minibatch_default_buckets_equal_jax():
    s = random_structure(seed=6, n=300, E=4000)
    nodes = np.arange(0, 300, 7, dtype=np.int32)
    got = tb.sample_minibatch(tb.EdgeIndex(s), nodes, 2)
    want = jb.sample_minibatch(jb.EdgeIndex(s), nodes, 2)
    assert_blocks_equal(got.layer_edges, want.layer_edges)
    assert got.layer_edges[0].src.shape[0] >= 256


def test_fanout_without_rng_raises():
    s = random_structure(seed=7)
    with pytest.raises(ValueError, match="rng"):
        tb.sample_minibatch(tb.EdgeIndex(s), np.array([1, 2]), 2, fanout=2)
    # without a cap no generator is needed
    tb.sample_minibatch(tb.EdgeIndex(s), np.array([1, 2]), 2, fanout=-1)


@pytest.mark.parametrize("num_rows", [None, 64])
def test_subset_features_equal_jax(num_rows):
    rng = np.random.default_rng(8)
    features = {
        "xsd_numeric_0": (rng.standard_normal((30, 4)).astype(np.float32),
                          np.sort(rng.choice(90, 30, replace=False))
                          .astype(np.int32)),
        "xsd_string_0": (rng.integers(0, 250, (12, 16)).astype(np.int32),
                         np.sort(rng.choice(90, 12, replace=False))
                         .astype(np.int32)),
        "xsd_gYear_0": (rng.standard_normal((3, 6)).astype(np.float32),
                        np.array([85, 86, 87], dtype=np.int32))}
    outer = np.arange(0, 80, 2, dtype=np.int32)      # misses every gYear
    got = tb.subset_features(features, outer, row_bucket=8,
                             num_rows=num_rows)
    want = jb.subset_features(features, outer, row_bucket=8,
                              num_rows=num_rows)
    assert sorted(got) == sorted(want) and "xsd_gYear_0" not in got
    for name in got:
        assert len(got[name]) == len(want[name]) == (2 if num_rows is None
                                                     else 3)
        for g, w in zip(got[name], want[name]):
            same(g, w, name)
    # tensors are taken as well as arrays
    as_tensors = {k: tuple(torch.from_numpy(a) for a in v)
                  for k, v in features.items()}
    again = tb.subset_features(as_tensors, outer, row_bucket=8,
                               num_rows=num_rows)
    for name in got:
        for g, w in zip(again[name], got[name]):
            same(g, w, name)


def test_make_label_batches_equal_jax():
    rows = np.arange(46).reshape(23, 2)
    for batchsize in (-1, 5, 23, 100):
        got = tb.make_label_batches(rows, batchsize)
        want = jb.make_label_batches(rows, batchsize)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w)


@pytest.mark.parametrize("case", ["sorted", "unordered", "repeats", "empty"])
def test_local_ids_equal_jax(case):
    """The lookup table gives the positions the JAX package's stable
    argsort and binary search give, the first where an id repeats."""
    rng = np.random.default_rng(5)
    universe = {"sorted": np.arange(3, 90, 3),
                "unordered": rng.permutation(60)[:25],
                "repeats": np.array([7, 2, 7, 9, 2, 2, 40]),
                "empty": np.zeros(0, np.int64)}[case].astype(np.int32)
    ids = rng.choice(universe, 200) if universe.size \
        else np.zeros(0, np.int32)
    got = tb._local_ids(ids, universe)
    assert got.dtype == np.int32
    same(got, jb._local_ids(ids, universe), case)


def test_device_put_batches_keeps_structure_and_values():
    s = random_structure(seed=9)
    mb = tb.sample_minibatch(tb.EdgeIndex(s), np.array([3, 4, 5]), 2,
                             edge_bucket=32, node_bucket=8)
    feats = {"xsd_numeric_0": (np.ones((8, 2), np.float32),
                               np.arange(8, dtype=np.int32))}
    payload = [(feats, mb.layer_edges, np.arange(4), "kept", None, 7)]
    (f, edges, idx, word, none, seven), = tb.device_put_batches(
        payload, torch.device("cpu"))
    assert (word, none, seven) == ("kept", None, 7)
    assert isinstance(edges, tuple) and len(edges) == 2
    for got, want in zip(edges, mb.layer_edges):
        assert isinstance(got, EdgeBlock)
        for field in dataclasses.fields(EdgeBlock):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if isinstance(b, np.ndarray):
                assert isinstance(a, torch.Tensor)
                same(a.numpy(), b, field.name)
            else:
                assert a == b
    same(f["xsd_numeric_0"][0].numpy(), feats["xsd_numeric_0"][0])
    same(idx.numpy(), np.arange(4))
