"""The key-tile skipping rule of the tiled attention kernels, and the
assumption it rests on, on the CPU.

``csrc/fused_attention.cu`` walks the keys of a sequence in tiles of
``KEY_TILE`` and skips the tiles that hold no valid key. Held here:

* :func:`live_key_tiles` (the rule for which tiles are walked, which the
  card tests hold the kernels to) against a numpy model;
* the assumption the skipping rests on: the plain versions on keys cut to
  the walked tiles equal the full call (1e-6 relative, f32) for every
  sequence with a valid key, with zeros at the dropped keys' ``dk`` and
  ``dv``, while the all-padding sequence is not cut.
"""

import numpy as np
import pytest
import torch

from mrgcn_tpu_torch.ops import attention as att

TILE = att.KEY_TILE


def make_mask(kind, N, L, seed):
    """(N, L) bool numpy mask. Sequence 0 has one valid key (key 0),
    sequence 1 none."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, L + 1, N)
    valid = np.arange(L)[None, :] < lengths[:, None]
    if kind == "holes":
        valid &= rng.random((N, L)) < 0.6
        valid[2::3, :TILE] = False      # a dead first tile inside a sequence
    elif kind == "all":
        valid[:] = True
    elif kind == "last_key":
        valid[:] = False
        valid[:, L - 1] = True
    if kind != "all":
        valid[0] = False
        valid[0, 0] = True
        if N > 1:
            valid[1] = False
    return valid


def numpy_live_tiles(valid):
    N, L = valid.shape
    tiles = -(-L // TILE)
    live = np.zeros((N, tiles), dtype=bool)
    for n in range(N):
        for t in range(tiles):
            live[n, t] = valid[n, t * TILE:(t + 1) * TILE].any()
        if not live[n].any():
            live[n] = True
    return live


MASKS = ("prefix", "holes", "all", "last_key")
LENGTHS = (1, 37, 64, 65, 128, 300, 512)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("L", LENGTHS)
def test_live_key_tiles_match_numpy_model(kind, L):
    valid = make_mask(kind, 9, L, seed=L)
    got = att.live_key_tiles(torch.from_numpy(valid))
    want = numpy_live_tiles(valid)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "all":
        # one valid key: its tile alone; no valid key: every tile
        assert got[0].tolist() == [True] + [False] * (want.shape[1] - 1)
        assert bool(got[1].all())


def test_live_key_tiles_skip_by_content_not_by_length():
    """A hole that spans a whole tile is skipped although later keys are
    valid; a lone valid key keeps its tile."""
    valid = torch.zeros(2, 4 * TILE, dtype=torch.bool)
    valid[0, :TILE] = True
    valid[0, 2 * TILE + 5] = True
    valid[1, 4 * TILE - 1] = True
    assert att.live_key_tiles(valid).tolist() == [
        [True, False, True, False], [False, False, False, True]]


def inputs(N, L, d, kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((N, L, d)).astype(np.float32)) for _ in range(4))
    valid = torch.from_numpy(make_mask(kind, N, L, seed + 1))
    return q * d ** -0.5, k, v, valid, do


CASES = [(6, 37, 16, "prefix"), (7, 130, 8, "holes"), (6, 200, 16, "holes"),
         (5, 128, 32, "prefix"), (5, 256, 8, "last_key"),
         (4, 512, 8, "holes")]


@pytest.mark.parametrize("N,L,d,kind", CASES)
def test_plain_versions_on_walked_keys_equal_the_full_call(N, L, d, kind):
    q, k, v, valid, do = inputs(N, L, d, kind, seed=L + d)
    out = att.attention_fwd_reference(q, k, v, valid)
    dq, dk, dv = att.attention_bwd_reference(q, k, v, valid, do)
    walked = att.live_key_tiles(valid).repeat_interleave(TILE, dim=1)[:, :L]
    for n in range(N):
        keep = walked[n]
        if not bool(valid[n].any()):
            assert bool(keep.all())     # the all-padding sequence is not cut
            continue
        one = slice(n, n + 1)
        args = (q[one], k[one][:, keep], v[one][:, keep], valid[one][:, keep])
        torch.testing.assert_close(att.attention_fwd_reference(*args),
                                   out[one], rtol=1e-6, atol=1e-6)
        cdq, cdk, cdv = att.attention_bwd_reference(*args, do[one])
        torch.testing.assert_close(cdq, dq[one], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(cdk, dk[one][:, keep], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(cdv, dv[one][:, keep], rtol=1e-6,
                                   atol=1e-6)
        assert not dk[n][~keep].any() and not dv[n][~keep].any()


def test_cutting_the_all_padding_sequence_would_change_it():
    q, k, v, valid, _ = inputs(2, 3 * TILE, 8, "prefix", seed=5)
    full = att.attention_fwd_reference(q[1:], k[1:], v[1:], valid[1:])
    cut = att.attention_fwd_reference(q[1:], k[1:, :TILE], v[1:, :TILE],
                                      valid[1:, :TILE])
    assert not bool(valid[1].any())
    torch.testing.assert_close(full, v[1:].mean(1, keepdim=True).expand(
        1, 3 * TILE, 8), rtol=1e-5, atol=1e-6)
    assert float((full - cut).abs().max()) > 1e-3
