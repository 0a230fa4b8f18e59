"""The ALBERT and RoBERTa-PreLayerNorm text backbones in the port against
transformers' Flax models and the JAX package.

Every backbone is tiny (vocabulary 100 or 1,200, width 32, embeddings 16
for ALBERT, 2-4 layers, 4 heads, feed-forward 64), built with random
parameters from a seed by ``FlaxAlbertModel`` /
``FlaxRobertaPreLayerNormModel`` and written by ``save_pretrained``, or by
the port's own writer (``tasks/synthetic.save_text_backbone_snapshot``,
with its Unigram ``tokenizer.json`` for ALBERT) into an offline hub cache.
Inputs are ragged rows from a numpy seed: ALBERT's padded with 0,
RoBERTa-PreLayerNorm's starting with ``<s>`` (0), ending with ``</s>``
(2) and padded with 1.

* (a) ``models/albert.Albert`` against ``FlaxAlbertModel`` under
  ``attention_mask = ids != 0``, with ``num_hidden_groups`` and
  ``inner_group_num`` of 1 and 2 (three layers over two groups take
  flax's own float division), and ``models/bert.Bert`` of type
  ``roberta-prelayernorm`` against ``FlaxRobertaPreLayerNormModel`` under
  ``ids != 1``: the last hidden state within 1e-5 of its largest entry;
  ALBERT's chunks sized by its feed-forward width.
* (b) The port's ``load_text_backbone`` + ``PretrainedTextEncoder``
  against the JAX package's, heads carried across by
  ``tasks/jax_import``: for ALBERT the output and the head gradients
  within 1e-5; for RoBERTa-PreLayerNorm the port equals the Flax model
  under ``ids != pad``, and the JAX package's encoder differs (it masks
  ``tokens > 0`` and numbers positions ``0 .. L-1``).
* (c) An NC model with an ALBERT backbone through both packages' task
  code: the first step's loss and the head gradients within 1e-4.
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mrgcn_tpu_torch.models import pretrained  # noqa: E402
from mrgcn_tpu_torch.models.albert import Albert  # noqa: E402
from mrgcn_tpu_torch.models.bert import Bert  # noqa: E402
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params  # noqa: E402
from tests.test_torch_bert import (backbone_nc_sides,  # noqa: E402
                                   flax_hidden, ragged_ids)
from tests.test_torch_pretrained import (  # noqa: E402,F401
    assert_encoder_matches, max_rel, offline_hub)

pytest.importorskip("transformers")

GEN = torch.Generator().manual_seed(0)
TINY_ALBERT = dict(synthetic.ALBERT_XXLARGE, embedding_size=16,
                   hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   vocab_size=1200, max_position_embeddings=64)


def flax_albert(directory, layers=2, groups=1, inner=1, seed=0,
                hidden_act="gelu_new"):
    import transformers as tf
    cfg = tf.AlbertConfig(vocab_size=100, embedding_size=16, hidden_size=32,
                          num_hidden_layers=layers, num_hidden_groups=groups,
                          inner_group_num=inner, num_attention_heads=4,
                          intermediate_size=64, max_position_embeddings=64,
                          hidden_act=hidden_act)
    model = tf.FlaxAlbertModel(cfg, seed=seed)
    model.save_pretrained(str(directory))
    return model


def flax_preln(directory, hidden_act="gelu", seed=0):
    import transformers as tf
    cfg = tf.RobertaPreLayerNormConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=66, hidden_act=hidden_act,
        pad_token_id=1, bos_token_id=0, eos_token_id=2)
    model = tf.FlaxRobertaPreLayerNormModel(cfg, seed=seed)
    model.save_pretrained(str(directory))
    return model


# --------------------------------------------------------------------------
# (a) the backbones against Flax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layers, groups, inner", [
    (2, 1, 1), (4, 2, 1), (2, 1, 2), (3, 2, 2)])
def test_albert_matches_flax(layers, groups, inner, tmp_path):
    model = flax_albert(tmp_path / "albert", layers, groups, inner)
    ids = ragged_ids("bert")
    want = flax_hidden(model, ids, 0)
    backbone = Albert.from_pretrained(tmp_path / "albert")
    assert backbone.group_of_layer == [int(i / (layers / groups))
                                       for i in range(layers)]
    t = torch.from_numpy(ids)
    got = backbone(t, attention_mask=t != 0)
    assert got.shape == (6, 12, 32)
    assert max_rel(got.numpy(), want) <= 1e-5
    # the tree by numpy arrays, as the weight bridge passes it, and under
    # a head model's name
    params = jax.tree_util.tree_map(np.array, model.params)
    same = Albert(model.config.to_dict(), {"albert": params})
    assert torch.equal(same(t, attention_mask=t != 0), got)


@pytest.mark.parametrize("hidden_act", ["gelu", "gelu_new", "relu"])
def test_roberta_prelayernorm_matches_flax(hidden_act, tmp_path):
    model = flax_preln(tmp_path / "preln", hidden_act)
    ids = ragged_ids("roberta")
    want = flax_hidden(model, ids, 1)
    backbone = Bert.from_pretrained(tmp_path / "preln")
    assert (backbone.model_type, backbone.pad_id) == ("roberta-prelayernorm",
                                                      1)
    t = torch.from_numpy(ids)
    got = backbone(t, attention_mask=t != 1)
    assert max_rel(got.numpy(), want) <= 1e-5
    # the parameter tree the port writes is flax's
    tree = synthetic.bert_params(model.config.to_dict())
    flat = jax.tree_util.tree_structure(model.params)
    assert jax.tree_util.tree_structure(tree) == flat


def test_albert_writer_and_chunks(monkeypatch):
    """The port's ALBERT writer gives flax's tree; a chunk is sized by the
    widest of the scores and the ``(chunk, L, intermediate_size)``
    feed-forward activations, and any chunking gives the same numbers."""
    import transformers as tf
    from mrgcn_tpu_torch.models import distilbert
    cfg = dict(TINY_ALBERT, num_hidden_groups=2, inner_group_num=2,
               num_hidden_layers=3)
    params = synthetic.albert_params(cfg, seed=3)
    flax_tree = tf.FlaxAlbertModel(tf.AlbertConfig(**{
        k: v for k, v in cfg.items() if k != "architectures"})).params
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(flax_tree)
    backbone = Albert(cfg, params)
    t = torch.from_numpy(ragged_ids("bert", vocab=1200))
    whole = backbone(t, attention_mask=t != 0)
    assert backbone.chunk_rows(12) == distilbert.BUDGET_BYTES // (4 * 12 * 64)
    monkeypatch.setattr(distilbert, "BUDGET_BYTES", 2 * 4 * 12 * 64)
    assert backbone.chunk_rows(12) == 2
    assert torch.equal(backbone(t, attention_mask=t != 0), whole)


def test_published_configs_build_in_transformers():
    """The three configs are transformers' own defaults / xlm-roberta-base's
    published file, at their widths."""
    import transformers as tf
    for config, cls in ((synthetic.ALBERT_XXLARGE, tf.AlbertConfig),
                        (synthetic.ROBERTA_PRELAYERNORM,
                         tf.RobertaPreLayerNormConfig),
                        (synthetic.XLM_ROBERTA_BASE, tf.XLMRobertaConfig)):
        ours = {k: v for k, v in config.items() if k != "architectures"}
        theirs = cls(**ours).to_dict()
        assert all(theirs[k] == v for k, v in ours.items()), cls
    default = tf.AlbertConfig().to_dict()
    assert all(default[k] == v for k, v in synthetic.ALBERT_XXLARGE.items()
               if k != "architectures")
    default = tf.RobertaPreLayerNormConfig().to_dict()
    assert all(default[k] == v
               for k, v in synthetic.ROBERTA_PRELAYERNORM.items()
               if k != "architectures")


# --------------------------------------------------------------------------
# (b) the whole pretrained encoder against the JAX package
# --------------------------------------------------------------------------

def both_encoders(directory, ids, pad, cls):
    from mrgcn_tpu.models.pretrained import PretrainedTextEncoder as JText
    from mrgcn_tpu.models.pretrained import \
        load_text_backbone as jax_load_text_backbone
    module, frozen = jax_load_text_backbone([str(directory)])
    jmod = JText(backbone=module, backbone_params=frozen, output_dim=5,
                 p_dropout=0.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    backbone = pretrained.load_text_backbone([str(directory)])
    assert isinstance(backbone, cls)
    mod = pretrained.PretrainedTextEncoder(backbone, 5, GEN, p_dropout=0.0,
                                           pad_id=pad)
    load_jax_params(mod, variables["params"])
    return jmod, variables, mod


def test_albert_encoder_matches_jax(offline_hub, tmp_path):
    flax_albert(tmp_path / "albert", layers=3, groups=2, inner=2, seed=1)
    ids = ragged_ids("bert")
    jmod, variables, mod = both_encoders(tmp_path / "albert", ids, 0, Albert)
    assert_encoder_matches(jmod, variables, jnp.asarray(ids), mod,
                           torch.from_numpy(ids))


def test_preln_encoder_masks_the_real_pad_where_jax_does_not(offline_hub,
                                                             tmp_path):
    """The port pools CLS from the Flax model under ``ids != 1``; the JAX
    package's encoder masks ``tokens > 0`` (hiding ``<s>``, attending to
    every pad) and numbers positions ``0 .. L-1``, as it does RoBERTa's,
    and its output differs."""
    model = flax_preln(tmp_path / "preln", seed=2)
    ids = ragged_ids("roberta")
    jmod, variables, mod = both_encoders(tmp_path / "preln", ids, 1, Bert)
    t = torch.from_numpy(ids)
    want = flax_hidden(model, ids, 1)[:, 0]
    assert max_rel(mod.features(t).numpy(), want) <= 1e-5
    L = ids.shape[1]
    theirs = np.asarray(model(ids, attention_mask=(ids > 0).astype("i4"),
                              position_ids=np.broadcast_to(
                                  np.arange(L), ids.shape))[0])[:, 0]
    jax_out = np.asarray(jmod.apply(variables, jnp.asarray(ids)))
    with torch.no_grad():
        assert max_rel(mod.head(torch.from_numpy(theirs), False).numpy(),
                       jax_out) <= 1e-5
        port_out = mod(t).numpy()
    assert max_rel(port_out, jax_out) > 1e-3


# --------------------------------------------------------------------------
# (c) an NC model with an ALBERT backbone through both packages
# --------------------------------------------------------------------------

def test_nc_model_with_an_albert_backbone_matches_jax(offline_hub,
                                                      tmp_path):
    from mrgcn_tpu.tasks import node_classification as jnc
    from mrgcn_tpu.tasks import utils as jutils
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks.jax_import import params_to_state_dict
    config, sides = backbone_nc_sides(offline_hub, tmp_path, TINY_ALBERT,
                                      wordpiece_vocab=1200)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    assert tin.text_pad_id == jin.text_pad_id == 0
    assert isinstance(tmodel.xsd_string_0.backbone, Albert)
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
