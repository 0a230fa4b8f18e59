"""Every text-attention path of the port's ``TextEncoder`` against the JAX
package's, and ``reconcile_text_attn`` against the JAX package's.

Inputs are drawn with numpy from a seed; the JAX module's ``init`` goes
into the port through the weight bridge, which also checks that the
parameter trees (``qkv``; ``query`` / ``key`` / ``value``; flax's
``MultiHeadDotProductAttention_0`` with its 3-d kernels) match name for
name and shape for shape. On the CPU the JAX encoder runs its plain
chains, and the port its kernels' plain versions. Tolerances are those of
``tests/test_torch_encoders.py``:

* float32: the output within 1e-5 and every gradient within 2e-4 (rtol
  and atol);
* the bf16 body: 2e-2 x max(1, max |JAX|) on the output and on every
  gradient (bf16 values rounded from f32 sums taken in other orders land a
  bf16 step apart; flax's multi-head path also rounds its scores to bf16
  before the softmax, where the port's core keeps them in f32).

``flash`` runs on the TPU alone in the JAX package (Pallas TPU lowering),
so the port's ``flash`` is held against the JAX ``xla`` path on the same
flax multi-head tree: ``mrgcn_tpu/models/encoders.py`` states they are the
same math on valid rows (flash's segment ids differ from the key mask at
padding query rows only, which reach no output).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.models import encoders as jenc
from mrgcn_tpu.tasks import utils as jutils
from mrgcn_tpu_torch.models import encoders as enc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              params_to_state_dict)
from tests.test_torch_encoders import (assert_grads_match, jax_grads_by_name,
                                       text_tokens)

GEN = torch.Generator().manual_seed(0)
KW = dict(output_dim=4, model_dim=16, num_layers=2, max_len=12)


def both(impl, heads, dtype="float32", jax_impl=None, **extra):
    """The JAX encoder (``jax_impl``, default ``impl``) initialised on the
    test tokens, and the port's (``impl``) with its parameters."""
    tokens = text_tokens()
    jmod = jenc.TextEncoder(dtype=getattr(jnp, dtype), num_heads=heads,
                            attn_impl=jax_impl or impl, **KW, **extra)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    mod = enc.TextEncoder(generator=GEN, dtype=getattr(torch, dtype),
                          num_heads=heads, attn_impl=impl, **KW, **extra)
    load_jax_params(mod, variables["params"])
    return tokens, jmod, variables, mod


def assert_match(tokens, jmod, variables, mod, dtype):
    want = np.asarray(jmod.apply(variables, tokens), dtype=np.float32)
    out = mod(torch.from_numpy(tokens))
    want_grads = jax_grads_by_name(jmod, variables, tokens)
    (out ** 2).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        assert_grads_match(mod, want_grads, rtol=2e-4, atol=2e-4)
    else:
        err = float(np.abs(out.detach().numpy() - want).max())
        assert err <= 2e-2 * max(1.0, float(np.abs(want).max()))
        assert_grads_match(mod, want_grads, 0, 0, scaled=True)


@pytest.mark.parametrize("heads", [1, 2, 4])
@pytest.mark.parametrize("impl", ["plain", "plain_fused", "fused_core",
                                  "xla"])
def test_attention_path_matches_jax(impl, heads):
    """Each path at 1, 2 and 4 heads. The single-head paths refuse more
    heads in both packages (the JAX block asserts one head)."""
    if impl != "xla" and heads > 1:
        jmod = jenc.TextEncoder(num_heads=heads, attn_impl=impl, **KW)
        with pytest.raises(AssertionError, match="single-head"):
            jmod.init(jax.random.PRNGKey(0), jnp.asarray(text_tokens()))
        with pytest.raises(ValueError, match="single-head"):
            enc.TextEncoder(generator=GEN, num_heads=heads, attn_impl=impl,
                            **KW)
        return
    args = both(impl, heads)
    marker = {"plain": "query", "plain_fused": "qkv", "fused_core": "qkv",
              "xla": "MultiHeadDotProductAttention_0"}[impl]
    assert any(k.startswith(f"_TextBlock_0.{marker}")
               for k in args[3].state_dict())
    assert_match(*args, "float32")


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_flash_matches_jax_xla_on_the_same_tree(heads):
    args = both("flash", heads, jax_impl="xla")
    assert args[3].attn_impl == "flash"
    assert_match(*args, "float32")


@pytest.mark.parametrize("impl,heads", [("xla", 2), ("xla", 4),
                                        ("flash", 2)])
def test_bf16_paths_match_jax(impl, heads):
    """The multi-head paths in the bf16 body (``flash`` against ``xla``).
    The single-head paths share one core, which
    ``tests/test_torch_encoders.py`` holds in bf16 against the JAX kernels
    (``fused_core``); ``plain`` adds only its three projections, held in
    float32 above. (On these tokens the JAX ``plain`` chain in bf16 moves
    one of the head's ReLU inputs from -4.1e-4, its float32 value, to
    +6.6e-4, which turns a row of the head's gradient on: its gradients
    then stand 0.33 of their largest entry from its own float32 run, the
    port's 0.048.)"""
    args = both(impl, heads, dtype="bfloat16",
                jax_impl="xla" if impl == "flash" else None)
    assert_match(*args, "bfloat16")


def test_multi_head_tree_is_flax_mha():
    _, _, variables, mod = both("xla", 4)
    want = {k: tuple(v.shape) for k, v in
            params_to_state_dict(variables["params"]).items()}
    got = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    assert got == want
    mha = "_TextBlock_1.MultiHeadDotProductAttention_0"
    assert got[f"{mha}.query.kernel"] == (16, 4, 4)
    assert got[f"{mha}.query.bias"] == (4, 4)
    assert got[f"{mha}.out.kernel"] == (4, 4, 16)


@pytest.mark.parametrize("heads", [1, 2])
def test_auto_and_full_mask_resolve_as_jax(heads):
    """``auto`` is ``fused_core`` with one head and the key-only mask and
    ``xla`` otherwise; the full query x key mask (``key_only_mask=False``)
    gives the same valid rows, so the port's key-only core matches it."""
    assert enc.TextEncoder(generator=GEN, num_heads=heads,
                           **KW).attn_impl \
        == ("fused_core" if heads == 1 else "xla")
    args = both("auto", heads, key_only_mask=False)
    assert args[3].attn_impl == "xla"
    assert_match(*args, "float32")


def test_text_mlp_switch_shares_the_tree(monkeypatch):
    """``MRGCN_TEXT_MLP=0`` gives the JAX blocks two Dense layers with the
    fused MLP's names and shapes; the port runs its fused MLP on that tree
    and matches."""
    monkeypatch.setenv("MRGCN_TEXT_MLP", "0")
    args = both("fused_core", 1)
    assert "_TextBlock_0.Dense_1.kernel" in args[3].state_dict()
    assert_match(*args, "float32")


def test_unknown_impl_raises_in_both():
    with pytest.raises(ValueError, match="Unknown attn_impl"):
        jenc.TextEncoder(attn_impl="flsh", **KW).init(
            jax.random.PRNGKey(0), jnp.asarray(text_tokens()))
    with pytest.raises(ValueError, match="Unknown attn_impl"):
        enc.TextEncoder(generator=GEN, attn_impl="flsh", **KW)


TREES = {"flax-MHA": {"MultiHeadDotProductAttention_0": {}},
         "fused-QKV": {"qkv": {}},
         "split-QKV": {"query": {}},
         "none": None}


def _reconcile(fn, tree):
    params = {"xsd_string_0": {"_TextBlock_0": tree}} if tree is not None \
        else {"xsd_numeric_0": {"Dense_0": {}}}
    try:
        return ("ok", fn(params))
    except RuntimeError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("env", [None, "auto", "xla", "flash", "plain",
                                 "plain_fused", "fused_core"])
@pytest.mark.parametrize("flavour", sorted(TREES))
def test_reconcile_text_attn_matches_jax(flavour, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("MRGCN_TEXT_ATTN", raising=False)
    else:
        monkeypatch.setenv("MRGCN_TEXT_ATTN", env)
    got = _reconcile(tutils.reconcile_text_attn, TREES[flavour])
    assert got == _reconcile(jutils.reconcile_text_attn, TREES[flavour])
    # the answer is returned, never written to the environment
    assert os.environ.get("MRGCN_TEXT_ATTN") == env
