"""The BLOOM text backbone in the port against transformers' Flax and
PyTorch models and the JAX package.

Every backbone is tiny (vocabulary 300, width 32 or 36, 2 layers, 2, 4 or
6 heads, feed-forward 4 x width), its parameters drawn from a seed by
``FlaxBloomModel`` or by the port's writer
(``tasks/synthetic.bloom_params``). Inputs are ragged rows of ids in [4,
300) from a numpy seed, right-padded with ``<pad>`` (3).

* (a) ``models/bloom.Bloom`` against ``FlaxBloomModel`` under
  ``attention_mask = ids != 3``, at 2 and 4 heads, with and without
  ``apply_residual_connection_post_layernorm``: the last hidden state at
  the real positions within 1e-5 of its largest entry; the legacy
  ``n_embed`` spelling read as ``BloomConfig`` reads it; any chunking
  the same numbers; at 6 heads, where flax's slopes raise, against
  transformers' PyTorch ``BloomModel`` with the same weights.
* (b) The port's ``load_text_backbone`` + ``PretrainedTextEncoder``
  against the JAX package's (which masks ``tokens > 0``: at BLOOM's real
  tokens the same), output and head gradients within 1e-5; the pooled
  row is the first token's alone in both packages.
* (c) An NC model with a BLOOM backbone through both packages' task
  code: the first step's loss and the head gradients within 1e-4.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
# transformers' PyTorch BLOOM would import TensorFlow (8 s) for its
# image transforms otherwise
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mrgcn_tpu_torch.models import distilbert  # noqa: E402
from mrgcn_tpu_torch.models.bloom import (Bloom, alibi_slopes,  # noqa: E402
                                          bloom_sizes)
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402
from tests.test_torch_albert import both_encoders  # noqa: E402
from tests.test_torch_bert import backbone_nc_sides  # noqa: E402
from tests.test_torch_pretrained import (  # noqa: E402,F401
    assert_encoder_matches, max_rel, offline_hub)

pytest.importorskip("transformers")

PAD = 3
TINY_BLOOM = dict(synthetic.BLOOM_560M, n_embed=32, n_layer=2,
                  num_attention_heads=4, vocab_size=300)


def ragged_ids(N=6, L=12, seed=4, vocab=300):
    """Rows of 1 to ``L`` ids in [4, vocab), the first row full, padded
    on the right with 3."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(PAD + 1, vocab, (N, L)).astype(np.int32)
    for i, keep in enumerate(rng.integers(1, L + 1, N)):
        ids[i, (L if i == 0 else keep):] = PAD
    return ids


def flax_bloom(heads=4, post=False, seed=0, width=32):
    import transformers as tf
    cfg = tf.BloomConfig(vocab_size=300, hidden_size=width, n_layer=2,
                         n_head=heads, pad_token_id=PAD,
                         apply_residual_connection_post_layernorm=post)
    return tf.FlaxBloomModel(cfg, seed=seed)


def real_err(got, want, ids):
    real = ids != PAD
    return max_rel(np.asarray(got)[real], np.asarray(want)[real])


# --------------------------------------------------------------------------
# (a) the backbone against Flax and PyTorch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [2, 4])
@pytest.mark.parametrize("post", [False, True], ids=["pre_residual",
                                                     "post_residual"])
def test_bloom_matches_flax(heads, post):
    model = flax_bloom(heads, post)
    ids = ragged_ids()
    want = np.asarray(model(ids, attention_mask=(ids != PAD).astype("i4"))[0])
    params = jax.tree_util.tree_map(np.array, model.params)
    backbone = Bloom(model.config.to_dict(), params)
    assert (backbone.model_type, backbone.pad_id, backbone.n_heads) == (
        "bloom", PAD, heads)
    t = torch.from_numpy(ids)
    got = backbone(t, attention_mask=t != PAD)
    assert got.shape == (6, 12, 32)
    assert real_err(got.numpy(), want, ids) <= 1e-5
    # under a head model's name, and the port's writer gives flax's tree
    same = Bloom(model.config.to_dict(), {"transformer": params})
    assert torch.equal(same(t, attention_mask=t != PAD), got)
    assert jax.tree_util.tree_structure(synthetic.bloom_params(
        model.config.to_dict())) == jax.tree_util.tree_structure(params)


def test_n_embed_spelling_and_the_published_config():
    """bloom-560m's ``n_embed`` / ``num_attention_heads`` / ``n_layer``
    read as ``BloomConfig`` reads them, the model built from either
    spelling the same; the published widths; BloomGELU's constant is
    ``F.gelu``'s in float32; a width the heads do not divide raises."""
    import transformers as tf
    for config in (synthetic.BLOOM_560M, TINY_BLOOM,
                   {"model_type": "bloom"},
                   {"hidden_size": 48, "n_embed": 32, "n_head": 2,
                    "num_attention_heads": 4, "n_layer": 3,
                    "num_hidden_layers": 1}):
        theirs = tf.BloomConfig(**config)
        assert bloom_sizes(config) == (theirs.hidden_size, theirs.n_layer,
                                       theirs.n_head), config
    assert bloom_sizes(synthetic.BLOOM_560M) == (1024, 24, 16)
    params = synthetic.bloom_params(TINY_BLOOM, seed=1)
    canonical = {k: v for k, v in TINY_BLOOM.items()
                 if k not in ("n_embed", "num_attention_heads")}
    canonical.update(hidden_size=32, n_head=4)
    t = torch.from_numpy(ragged_ids())
    assert torch.equal(Bloom(TINY_BLOOM, params)(t, t != PAD),
                       Bloom(canonical, params)(t, t != PAD))
    assert np.float32(0.79788456) == np.float32(np.sqrt(2 / np.pi))
    with pytest.raises(ValueError, match="32 is not a multiple of the 3"):
        Bloom(dict(TINY_BLOOM, num_attention_heads=3), params)
    with pytest.raises(ValueError, match="word embeddings of shape"):
        Bloom(dict(TINY_BLOOM, vocab_size=301), params)


def test_chunks_give_the_same_numbers(monkeypatch):
    """A chunk is sized by the larger of the scores and their bias (``2
    heads L^2`` floats a row) and the feed-forward activations (``4
    width L``); any chunking gives the same numbers."""
    backbone = Bloom(TINY_BLOOM, synthetic.bloom_params(TINY_BLOOM, seed=2))
    t = torch.from_numpy(ragged_ids(N=7, L=20, seed=5))
    whole = backbone(t, attention_mask=t != PAD)
    assert backbone.chunk_rows(20) == distilbert.BUDGET_BYTES // (
        4 * 20 * 2 * 4 * 20)
    assert backbone.chunk_rows(8) == distilbert.BUDGET_BYTES // (
        4 * 8 * 4 * 32)
    monkeypatch.setattr(distilbert, "BUDGET_BYTES", 3 * 4 * 20 * 2 * 4 * 20)
    assert backbone.chunk_rows(20) == 3
    assert torch.equal(backbone(t, attention_mask=t != PAD), whole)


def test_six_heads_match_pytorch_where_flax_raises():
    """At a head count that is not a power of two flax's slopes call
    ``jnp.cat`` (an ``AttributeError``, which the JAX package's loader
    turns into its from-scratch encoder); the port takes the published
    slopes and matches transformers' PyTorch ``BloomModel`` with the
    same weights."""
    import transformers as tf
    cfg = tf.BloomConfig(vocab_size=300, hidden_size=36, n_layer=2,
                         n_head=6, pad_token_id=PAD)
    ids = ragged_ids(seed=6)
    with pytest.raises(AttributeError, match="cat"):
        tf.FlaxBloomModel(cfg, seed=0)
    params = synthetic.bloom_params(cfg.to_dict(), seed=3)
    state = {"word_embeddings.weight":
             params["word_embeddings"]["embedding"]}

    def add(prefix, tree):
        if "kernel" in tree:
            state[prefix + ".weight"] = tree["kernel"].T
        else:
            state[prefix + ".weight"] = tree["scale"]
        state[prefix + ".bias"] = tree["bias"]

    add("word_embeddings_layernorm", params["word_embeddings_layernorm"])
    add("ln_f", params["ln_f"])
    for i, layer in params["h"].items():
        for part in ("input_layernorm", "post_attention_layernorm"):
            add(f"h.{i}.{part}", layer[part])
        for group in ("self_attention", "mlp"):
            for name, tree in layer[group].items():
                add(f"h.{i}.{group}.{name}", tree)
    model = tf.BloomModel(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in state.items()})
    t = torch.from_numpy(ids)
    with torch.no_grad():
        want = model(input_ids=t.long(),
                     attention_mask=(t != PAD).long()).last_hidden_state
        assert torch.equal(alibi_slopes(6), tf.models.bloom.modeling_bloom
                           .build_alibi_tensor(torch.ones(1, 2), 6,
                                               torch.float32)[:, 0, 1])
    got = Bloom(cfg.to_dict(), params)(t, attention_mask=t != PAD)
    assert real_err(got.numpy(), want.numpy(), ids) <= 1e-5


# --------------------------------------------------------------------------
# (b) the whole pretrained encoder against the JAX package
# --------------------------------------------------------------------------

def test_bloom_encoder_matches_jax(offline_hub, tmp_path):
    flax_bloom(heads=2, seed=1).save_pretrained(str(tmp_path / "bloom"))
    ids = ragged_ids()
    jmod, variables, mod = both_encoders(tmp_path / "bloom", ids, PAD,
                                         Bloom)
    assert_encoder_matches(jmod, variables, jnp.asarray(ids), mod,
                           torch.from_numpy(ids))


def test_pooled_row_is_the_first_token_alone(offline_hub, tmp_path):
    """The causal mask lets position 0 see itself alone: in both packages
    the encoder's output does not move when every token after the first
    changes, padding included, and moves when the first does."""
    flax_bloom(heads=4, seed=2).save_pretrained(str(tmp_path / "bloom"))
    ids = ragged_ids(seed=7)
    jmod, variables, mod = both_encoders(tmp_path / "bloom", ids, PAD,
                                         Bloom)
    other = ragged_ids(seed=8)
    other[:, 0] = ids[:, 0]
    assert (other[:, 1:] != ids[:, 1:]).any(axis=1).all()
    first = ids.copy()
    first[:, 0] = np.where(ids[:, 0] == 299, PAD + 1, ids[:, 0] + 1)
    outs = []
    for x in (ids, other, first):
        with torch.no_grad():
            port = mod(torch.from_numpy(x)).numpy()
        outs.append((port, np.asarray(jmod.apply(variables,
                                                 jnp.asarray(x)))))
    (port, theirs), (port_other, theirs_other), (port_first, _) = outs
    assert np.array_equal(port, port_other)
    assert np.array_equal(theirs, theirs_other)
    assert max_rel(port, theirs) <= 1e-5
    assert (np.abs(port_first - port).max(axis=1) > 1e-4).all()


# --------------------------------------------------------------------------
# (c) an NC model with a BLOOM backbone through both packages
# --------------------------------------------------------------------------

def test_nc_model_with_a_bloom_backbone_matches_jax(offline_hub, tmp_path):
    from mrgcn_tpu.tasks import node_classification as jnc
    from mrgcn_tpu.tasks import utils as jutils
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks.jax_import import params_to_state_dict
    rng = np.random.default_rng(9)
    lengths = rng.integers(1, 9, 30)
    strings = np.empty(30, dtype=object)
    for i, n in enumerate(lengths):
        strings[i] = rng.integers(PAD + 1, 300, n).astype(np.int32)
    config, sides = backbone_nc_sides(offline_hub, tmp_path, TINY_BLOOM,
                                      token_strings=(strings, lengths))
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    assert tin.text_pad_id == jin.text_pad_id == PAD
    assert isinstance(tmodel.xsd_string_0.backbone, Bloom)
    l2 = config["model"]["l2_lambda"]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jbatch.features, jbatch.edges,
                           train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnc._loss_and_metrics(out, jbatch.idx, jbatch.targets,
                                     jbatch.weights)[0] \
            + jutils.regularization(p, 0.0, l2)

    want, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    got = nc.loss_and_grads(tmodel, tbatch, 0.0, l2)[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    want_grads = params_to_state_dict(want_grads)
    named = dict(tmodel.named_parameters())
    assert sorted(named) == sorted(want_grads)
    heads = [n for n in named if n.startswith("xsd_string_0.")]
    assert len(heads) == 4
    for name in heads:
        assert max_rel(named[name].grad.numpy(),
                       want_grads[name].numpy()) <= 1e-4, name
