"""The port's encoder ops and modules against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages; module
parameters are the JAX module's ``init``, carried into the port by the
weight bridge (``tasks/jax_import``), which also checks that every name
and shape matches. Tolerances:

* the fused attention core and fused MLP against the JAX ops run as
  ``tests/test_attention.py`` runs them (Pallas interpret mode), in f32:
  forward 2e-5, gradients 2e-4, that file's bounds;
* placement: exact (row gathers);
* initializers: mean and standard deviation of 200,000 draws within 2 %
  of the flax initializer's (sampling error at that size is about 0.3 %),
  and the same bounds where the distribution is bounded;
* ``MLP`` and ``TextEncoder`` in f32: forward 1e-5, gradients 2e-4
  (``tests/test_attention.py``'s encoder-level bounds);
* ``TextEncoder`` in its bf16 body: 2e-2 x max(1, max |JAX|) on the
  output and on every gradient. Both sides compute what the fused kernels
  compute (the JAX side with its Pallas kernels in interpret mode), but
  bf16 values rounded from f32 sums taken in different orders can land
  one bf16 step (2^-8 relative) apart, and two blocks compound a few such
  steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mrgcn_tpu.models import encoders as jenc
from mrgcn_tpu.ops import placement as jplace
from mrgcn_tpu.ops.attention import fused_attention as jax_attention
from mrgcn_tpu.ops.fused_mlp import fused_mlp as jax_mlp
from mrgcn_tpu_torch.models import encoders as enc
from mrgcn_tpu_torch.models import init as tinit
from mrgcn_tpu_torch.ops import placement
from mrgcn_tpu_torch.ops.attention import fused_attention
from mrgcn_tpu_torch.ops.fused_mlp import fused_mlp
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              params_to_state_dict)

GEN = torch.Generator().manual_seed(0)


@pytest.mark.parametrize("N,L,d", [(16, 128, 128), (11, 12, 16)])
def test_attention_plain_matches_jax_kernel(N, L, d):
    rng = np.random.default_rng(N + L)
    q, k, v = (rng.standard_normal((N, L, d)).astype(np.float32)
               for _ in range(3))
    keys_valid = np.arange(L)[None, :] < rng.integers(1, L + 1, N)[:, None]
    cot = rng.standard_normal((N, L, d)).astype(np.float32)

    want, vjp = jax.vjp(
        lambda q, k, v: jax_attention(q, k, v, jnp.asarray(keys_valid),
                                      interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(cot))

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = fused_attention(*leaves, torch.from_numpy(keys_valid))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)


def test_mlp_plain_matches_jax_kernel():
    rng = np.random.default_rng(3)
    M, d, hd = 37, 16, 64
    args = [rng.standard_normal(s).astype(np.float32)
            for s in ((M, d), (d, hd), (hd,), (hd, d), (d,))]
    cot = rng.standard_normal((M, d)).astype(np.float32)

    want, vjp = jax.vjp(lambda *a: jax_mlp(*a, interpret=True),
                        *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(cot))

    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    got = fused_mlp(*leaves)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pre", [True, False])
def test_place_rows_matches_jax(pre):
    rng = np.random.default_rng(5)
    num_rows, m, dim = 40, 12, 3
    node_idx = rng.choice(num_rows, m, replace=False).astype(np.int32)
    node_idx[[2, 7]] = [num_rows + 3, -1]           # padding rows
    out = rng.standard_normal((m, dim)).astype(np.float32)
    cot = rng.standard_normal((num_rows, dim)).astype(np.float32)
    rows = jplace.build_rows(node_idx, num_rows)
    np.testing.assert_array_equal(placement.build_rows(node_idx, num_rows),
                                  rows)

    if pre:
        want, vjp = jax.vjp(lambda o: jplace.place_rows_pre(
            o, jnp.asarray(node_idx), jnp.asarray(rows)), jnp.asarray(out))
    else:
        want, vjp = jax.vjp(lambda o: jplace.place_rows(
            o, jnp.asarray(node_idx), num_rows), jnp.asarray(out))
    (want_grad,) = vjp(jnp.asarray(cot))

    o = torch.tensor(out, requires_grad=True)
    idx = torch.from_numpy(node_idx)
    got = placement.place_rows_pre(o, idx, torch.from_numpy(rows)) if pre \
        else placement.place_rows(o, idx, num_rows)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(o.grad.numpy(), np.asarray(want_grad))


def jax_grads_by_name(module, variables, x):
    grads = jax.grad(lambda v: jnp.sum(module.apply(v, x) ** 2))(variables)
    return params_to_state_dict(grads["params"])


def assert_grads_match(torch_module, want, rtol, atol, scaled=False):
    got = {n: p.grad for n, p in torch_module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].float().numpy()
        if scaled:
            bound = 2e-2 * max(1.0, float(np.abs(w).max()))
            err = float(np.abs(g.float().numpy() - w).max())
            assert err <= bound, f"{name}: {err} > {bound}"
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.mark.parametrize("in_dim,out_dim,layers", [(1, 4, 1), (6, 1, 2),
                                                   (9, 3, 2)])
def test_mlp_encoder_matches_jax(in_dim, out_dim, layers):
    rng = np.random.default_rng(in_dim)
    x = rng.standard_normal((23, in_dim)).astype(np.float32)
    jmod = jenc.MLP(output_dim=out_dim, num_layers=layers)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mod = enc.MLP(in_dim, out_dim, GEN, num_layers=layers)
    load_jax_params(mod, variables["params"])

    out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jmod.apply(variables, x)),
                               rtol=1e-5, atol=1e-5)
    (out ** 2).sum().backward()
    assert_grads_match(mod, jax_grads_by_name(jmod, variables, x),
                       rtol=2e-4, atol=2e-4)


def text_tokens(seed=11, N=5, L=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 250, (N, L)).astype(np.int32)
    for i, keep in enumerate([L, 7, 3, 9, 1]):
        tokens[i, keep:] = 256
    return tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_encoder_matches_jax(dtype, monkeypatch):
    # the JAX encoder's Pallas kernels, in interpret mode on the CPU
    monkeypatch.setenv("MRGCN_FORCE_PALLAS_GATHER", "1")
    tokens = text_tokens()
    kw = dict(output_dim=4, model_dim=16, num_heads=1, num_layers=2,
              max_len=12)
    jmod = jenc.TextEncoder(dtype=getattr(jnp, dtype),
                            attn_impl="fused_core", **kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    mod = enc.TextEncoder(generator=GEN, dtype=getattr(torch, dtype), **kw)
    load_jax_params(mod, variables["params"])

    want = np.asarray(jmod.apply(variables, tokens), dtype=np.float32)
    out = mod(torch.from_numpy(tokens))
    assert out.dtype == torch.float32
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


def test_text_encoder_param_names_are_the_jax_tree():
    tokens = text_tokens()
    jmod = jenc.TextEncoder(output_dim=4, model_dim=16, max_len=12,
                            attn_impl="fused_core")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    mod = enc.TextEncoder(4, GEN, model_dim=16, max_len=12)
    want = {k: tuple(v.shape) for k, v in params_to_state_dict(params).items()}
    got = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    assert got == want
    assert "_TextBlock_1.qkv.kernel" in got and "LayerNorm_0.scale" in got


@pytest.mark.parametrize("kw", [{"num_heads": 2}, {"attn_impl": "xla"},
                                {"attn_impl": "flash"}])
def test_unported_text_paths_raise(kw):
    """The paths that raised before they were ported (ROADMAP item 3c: two
    heads, ``xla``, ``flash``) now build and match the JAX encoder in f32
    (``flash`` against the JAX ``xla`` path on the same tree, the JAX
    ``flash`` being TPU-only; ``tests/test_torch_text_attn_paths.py``
    holds every path)."""
    tokens = text_tokens()
    kw = dict(output_dim=4, model_dim=16, max_len=12, **kw)
    jkw = dict(kw, attn_impl="xla") if kw.get("attn_impl") == "flash" \
        else kw
    jmod = jenc.TextEncoder(dtype=jnp.float32, **jkw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    mod = enc.TextEncoder(generator=GEN, dtype=torch.float32, **kw)
    load_jax_params(mod, variables["params"])
    np.testing.assert_allclose(
        mod(torch.from_numpy(tokens)).detach().numpy(),
        np.asarray(jmod.apply(variables, tokens)), rtol=1e-5, atol=1e-5)


def test_initializers_match_flax_distributions():
    import flax.linen as fnn

    from mrgcn_tpu.models import init as jinit
    shape = (400, 500)
    vs = fnn.initializers.variance_scaling(1.0, "fan_in", "normal",
                                           out_axis=0)
    cases = {   # name: (port, flax, bounded)
        "unit_uniform": (tinit.unit_uniform, jinit.unit_uniform(), True),
        "torch_linear_kernel": (tinit.torch_linear_kernel,
                                jinit.torch_linear_kernel(), True),
        "torch_linear_bias": (tinit.torch_linear_bias(300),
                              jinit.torch_linear_bias(300), True),
        "lecun_normal": (tinit.lecun_normal,
                         fnn.initializers.lecun_normal(), True),
        "embedding": (tinit.embedding_normal, vs, False),
        "normal_0.02": (tinit.normal(0.02), fnn.initializers.normal(0.02),
                        False),
    }
    for name, (mine, theirs, bounded) in cases.items():
        a = mine(shape, torch.Generator().manual_seed(0)).numpy()
        b = np.asarray(theirs(jax.random.PRNGKey(0), shape, jnp.float32))
        assert a.shape == b.shape and a.dtype == np.float32, name
        assert abs(a.mean() - b.mean()) <= 2e-2 * b.std(), name
        assert abs(a.std() / b.std() - 1.0) <= 2e-2, name
        if bounded:
            np.testing.assert_allclose([a.min(), a.max()],
                                       [b.min(), b.max()], rtol=1e-2,
                                       atol=1e-4, err_msg=name)
