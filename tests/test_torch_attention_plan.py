"""The multi-head attention kernels' launch plan (#12), on the CPU.

``head_plan`` is what the wrappers hand ``csrc/fused_attention_heads.cu``
(which checks it against ``(H, d)`` and refuses a plan that disagrees):
each head in a shared-memory slab of ``dpad`` columns, the next power of
two >= max(d, 16), in the swizzle of one slab row, and the heads in
groups of ``fwd_heads`` (a forward block) and ``bwd_heads`` (a backward
block). The tests take every ``(H, d)`` that the card's tests and
``chip_smoke.py`` run: every head lies in exactly one group, in order,
and a group's slabs fit one 128-column tile. Shapes outside the kernels'
limits raise with the wrapper's messages, and a CPU call with several
heads takes the plain version and counts no launch.
"""

import numpy as np
import pytest
import torch

from mrgcn_tpu_torch.ops import attention as att

# (H, d): tests/test_torch_kernels_gpu.py's multi-head cases, the smoke's
# kernel cases (D = 128 in 2, 4, 8 heads; 3 x 40, 16 x 8) and its
# encoders' heads
PLANNED = sorted({(2, 64), (4, 32), (8, 16), (3, 40), (12, 64), (4, 8),
                  (5, 24), (2, 128), (16, 8), (10, 8), (6, 16), (3, 16)})


@pytest.mark.parametrize("H,d", PLANNED)
@pytest.mark.parametrize("backward", [False, True])
def test_groups_hold_every_head_once_in_order(H, d, backward):
    plan = att.head_plan(H, d, 128)
    groups = plan.groups(H, backward)
    size = plan.bwd_heads if backward else plan.fwd_heads
    assert [h for g in groups for h in g] == list(range(H))
    assert all(len(g) == size for g in groups[:-1])
    assert 1 <= len(groups[-1]) <= size
    assert 1 <= size <= H and size * plan.dpad <= att.MAX_DIM


@pytest.mark.parametrize("H,d", PLANNED)
def test_slab_width_and_swizzle(H, d):
    plan = att.head_plan(H, d, 512)
    width = max(d, 16)
    assert plan.dpad & (plan.dpad - 1) == 0
    assert width <= plan.dpad < 2 * width
    assert plan.swizzle == min(128, 2 * plan.dpad)


@pytest.mark.parametrize("H,d,L,error,message", [
    (4, 12, 128, ValueError, "multiple of 8"),
    (2, 136, 128, ValueError, "multiple of 8 up to 128"),
    (2, 0, 128, ValueError, "multiple of 8"),
    (8, 16, 513, NotImplementedError, "tokenizer limit"),
    (8, 16, 0, NotImplementedError, "1 <= L <= 512"),
    (1, 64, 128, ValueError, "H >= 2")])
def test_shapes_outside_the_limits_raise(H, d, L, error, message):
    with pytest.raises(error, match=message):
        att.head_plan(H, d, L)


@pytest.mark.parametrize("H,d", [(3, 40), (16, 8)])
def test_cpu_call_takes_the_plain_version(H, d):
    rng = np.random.default_rng(H * d)
    N, L = 4, 70
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (N, L, H, d)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    valid = torch.from_numpy(np.arange(L)[None, :]
                             < rng.integers(0, L + 1, (N, 1)))
    counts = (att.attention_fwd.launches, att.attention_fwd.launches_heads,
              att.attention_bwd.launches, att.attention_bwd.launches_heads)
    out = att.attention_fwd(q, k, v, valid)
    grads = att.attention_bwd(q, k, v, valid, do)
    assert (att.attention_fwd.launches, att.attention_fwd.launches_heads,
            att.attention_bwd.launches,
            att.attention_bwd.launches_heads) == counts
    assert torch.equal(out, att.attention_fwd_reference(q, k, v, valid))
    for g, w in zip(grads,
                    att.attention_bwd_reference(q, k, v, valid, do)):
        assert g.shape == q.shape and torch.equal(g, w)
