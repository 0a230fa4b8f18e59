"""The BERT, RoBERTa and XLM-R text backbones in the port against
transformers' Flax models and the JAX package.

Every backbone is tiny (vocabulary 100 or 1,200, width 32, 2 layers, 4
heads, feed-forward 64), built with random parameters from a seed by
``FlaxBertModel`` / ``FlaxRobertaModel`` / ``FlaxXLMRobertaModel`` and
written by ``save_pretrained``, or by the port's own writer
(``tasks/synthetic.save_text_backbone_snapshot``) into an offline hub
cache. Inputs are ragged rows from a numpy seed: BERT's padded with 0,
RoBERTa's and XLM-R's starting with ``<s>`` (0), ending with ``</s>``
(2) and padded with 1.

* (a) ``models/bert.Bert`` against the Flax model run with ``attention_mask
  = ids != pad`` (the model numbers RoBERTa's positions from the pad id
  itself), each ``hidden_act`` of flax's ``ACT2FN`` (the three of every
  kind, the other five on BERT), ``is_decoder`` (the causal mask combined
  with the padding mask) and ``add_cross_attention`` (a ``crossattention``
  subtree in each layer, not run) on BERT and RoBERTa, the last hidden
  state within 1e-5 of its largest entry; RoBERTa at 512 tokens, and past
  it a raise; a causal model's first position is the first token's
  alone. The port's activation table is flax's ``ACT2FN``, and the JAX
  package's encoder runs a ``relative_key`` config as an absolute one
  (the port refuses it).
* (b) The port's ``load_text_backbone`` + ``PretrainedTextEncoder`` against
  the JAX package's, heads carried across by ``tasks/jax_import``: for
  BERT output and head gradients within 1e-5 of the largest entry; for
  RoBERTa the port equals the Flax model under ``ids != pad``, and the
  JAX package's own encoder differs (it masks ``tokens > 0`` and numbers
  positions ``0 .. L-1``: the reference fault of ROADMAP Queue 3).
* (c) An NC model with a BERT backbone through both packages' task code:
  the first step's loss and the head gradients within 1e-4.
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
from mrgcn_tpu_torch.models.bert import Bert  # noqa: E402
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402
from mrgcn_tpu_torch.tasks.jax_import import load_jax_params  # noqa: E402
from tests.test_torch_pretrained import (  # noqa: E402,F401
    assert_encoder_matches, max_rel, offline_hub)

pytest.importorskip("transformers")

GEN = torch.Generator().manual_seed(0)
KINDS = ("bert", "roberta", "xlm-roberta")
PAD = {"bert": 0, "roberta": 1, "xlm-roberta": 1}
TINY_BERT = dict(synthetic.BERT_MULTILINGUAL, hidden_size=32,
                 num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, vocab_size=1200,
                 max_position_embeddings=64)


def flax_model(kind, directory, hidden_act="gelu", positions=64, seed=0,
               **options):
    """A tiny Flax model of ``kind`` from ``seed``, saved to
    ``directory``; ``options``: more config fields."""
    import transformers as tf
    common = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  hidden_act=hidden_act, **options)
    if kind == "bert":
        cfg = tf.BertConfig(max_position_embeddings=positions,
                            type_vocab_size=2, pad_token_id=0, **common)
        cls = tf.FlaxBertModel
    else:
        config_cls, cls = {
            "roberta": (tf.RobertaConfig, tf.FlaxRobertaModel),
            "xlm-roberta": (tf.XLMRobertaConfig,
                            tf.FlaxXLMRobertaModel)}[kind]
        cfg = config_cls(max_position_embeddings=positions + 2,
                         type_vocab_size=1, pad_token_id=1, bos_token_id=0,
                         eos_token_id=2, layer_norm_eps=1e-5, **common)
    model = cls(cfg, seed=seed)
    model.save_pretrained(str(directory))
    return model


def ragged_ids(kind, N=6, L=12, seed=4, vocab=100):
    """Rows of 1 to ``L`` real tokens; RoBERTa's framed by ``<s>`` and
    ``</s>``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (N, L)).astype(np.int32)
    for i, keep in enumerate(rng.integers(1, L + 1, N)):
        if i == 0:
            keep = L
        if kind != "bert":
            ids[i, 0], ids[i, max(keep - 1, 1)] = 0, 2
            keep = max(keep, 2)
        ids[i, keep:] = PAD[kind]
    return ids


def flax_hidden(model, ids, pad, **kw):
    return np.asarray(model(ids, attention_mask=(ids != pad).astype("i4"),
                            **kw)[0])


# --------------------------------------------------------------------------
# (a) the backbones against Flax
# --------------------------------------------------------------------------

# every kind with the three activations of the published configs; the
# other five of flax's ACT2FN on BERT alone (the function is the same in
# every kind)
OTHER_ACTS = ("silu", "swish", "tanh", "quick_gelu", "gelu_pytorch_tanh")
KIND_ACTS = [(kind, act) for kind in KINDS
             for act in ("gelu", "gelu_new", "relu")] \
    + [("bert", act) for act in OTHER_ACTS]


@pytest.mark.parametrize("kind, hidden_act", KIND_ACTS,
                         ids=[f"{k}-{a}" for k, a in KIND_ACTS])
def test_backbone_matches_flax(kind, hidden_act, tmp_path):
    model = flax_model(kind, tmp_path / kind, hidden_act)
    ids = ragged_ids(kind)
    want = flax_hidden(model, ids, PAD[kind])
    backbone = Bert.from_pretrained(tmp_path / kind)
    assert (backbone.model_type, backbone.pad_id) == (kind, PAD[kind])
    t = torch.from_numpy(ids)
    got = backbone(t, attention_mask=t != PAD[kind])
    assert got.shape == (6, 12, 32)
    assert max_rel(got.numpy(), want) <= 1e-5
    # the tree by numpy arrays, as the weight bridge passes it
    same = Bert(model.config.to_dict(),
                jax.tree_util.tree_map(np.array, model.params))
    assert torch.equal(same(t, attention_mask=t != PAD[kind]), got)


def test_roberta_at_512_tokens_and_past_them(tmp_path):
    model = flax_model("roberta", tmp_path / "long", positions=512)
    ids = ragged_ids("roberta", N=2, L=512, seed=5)
    backbone = Bert.from_pretrained(tmp_path / "long")
    assert backbone.position_embeddings.shape[0] == 514
    t = torch.from_numpy(ids)
    got = backbone(t, attention_mask=t != 1)
    assert max_rel(got.numpy(), flax_hidden(model, ids, 1)) <= 1e-5
    longer = torch.cat([t, torch.full((2, 1), 1, dtype=t.dtype)], dim=1)
    with pytest.raises(ValueError, match="513 tokens.*514 positions from 2"):
        backbone(longer)


def test_activation_table_is_flax_act2fn():
    """The port's table has ``ACT2FN``'s names (a transformers release
    that adds one shows here), each the same function within f32
    rounding."""
    from transformers.modeling_flax_utils import ACT2FN as FLAX
    from mrgcn_tpu_torch.models.distilbert import ACT2FN
    assert sorted(ACT2FN) == sorted(FLAX)
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    for name, fn in ACT2FN.items():
        want = np.asarray(FLAX[name](jnp.asarray(x)))
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-6, atol=1e-6, err_msg=name)


DECODER_FLAGS = [(kind, flag) for kind in ("bert", "roberta")
                 for flag in ("is_decoder", "add_cross_attention")]


@pytest.mark.parametrize("kind, flag", DECODER_FLAGS,
                         ids=[f"{k}-{f}" for k, f in DECODER_FLAGS])
def test_decoder_flags_match_flax(kind, flag, tmp_path):
    """``is_decoder``: flax's causal attention, its mask combined with the
    padding mask; ``add_cross_attention``: each layer's
    ``crossattention`` subtree is loaded and not run (the encoder gives
    flax no encoder states). The port's writer draws flax's tree."""
    model = flax_model(kind, tmp_path / kind, **{flag: True})
    assert "crossattention" in model.params["encoder"]["layer"]["0"] \
        or flag == "is_decoder"
    ids = ragged_ids(kind)
    want = flax_hidden(model, ids, PAD[kind])
    backbone = Bert.from_pretrained(tmp_path / kind)
    assert backbone.causal == (flag == "is_decoder")
    t = torch.from_numpy(ids)
    got = backbone(t, attention_mask=t != PAD[kind])
    assert max_rel(got.numpy(), want) <= 1e-5
    config = model.config.to_dict()
    assert jax.tree_util.tree_structure(synthetic.bert_params(config)) \
        == jax.tree_util.tree_structure(model.params)


def test_causal_first_position_is_the_first_token_alone(monkeypatch):
    """With ``is_decoder`` the first position sees itself alone: later
    tokens, padding among them, leave it as it is, so a padded row pools
    as it does alone; chunks sized with the ``(L, L)`` mask give the same
    numbers."""
    from mrgcn_tpu_torch.models import distilbert
    config = dict(TINY_BERT, is_decoder=True)
    backbone = Bert(config, synthetic.bert_params(config, seed=3))
    encoder = pretrained.PretrainedTextEncoder(backbone, 5, GEN, pad_id=0)
    t = torch.from_numpy(ragged_ids("bert", L=20, vocab=1200))
    pooled = encoder.features(t)
    other = t.clone()
    other[:, 1:] = torch.flip(other[:, 1:], dims=[0])
    assert torch.equal(encoder.features(other), pooled)
    lengths = (t != 0).sum(dim=1)
    assert int(lengths.min()) < t.shape[1]
    for row, n, want in zip(t, lengths, pooled):
        alone = encoder.features(row[None, :int(n)])[0]
        assert max_rel(alone.numpy(), want.numpy()) <= 1e-5
    # 4 heads of 20 x 20 scores, and the mask: 4 rows a chunk, 5 without
    whole = backbone(t, attention_mask=t != 0)
    monkeypatch.setattr(distilbert, "BUDGET_BYTES", 4 * 4 * 20 * 5 * 20)
    assert backbone.chunk_rows(20) == 4
    assert Bert(TINY_BERT, synthetic.bert_params(TINY_BERT)) \
        .chunk_rows(20) == 5
    assert torch.equal(backbone(t, attention_mask=t != 0), whole)


@pytest.mark.parametrize("bad, match", [
    ({"hidden_act": "mish"}, "hidden_act 'mish'.*ACT2FN: gelu, relu, silu"),
    ({"position_embedding_type": "relative_key"},
     "position_embedding_type 'relative_key'"),
    ({"model_type": "distilbert"}, "'distilbert': this module reads bert"),
    ({"model_type": "electra"},
     "'electra'.*FlaxAutoModel loads it and its encoder fails at the first "
     "step with a TypeError")])
def test_unsupported_configs_raise_naming_the_field(bad, match):
    params = synthetic.bert_params(TINY_BERT)
    Bert(TINY_BERT, params)
    with pytest.raises(NotImplementedError, match=match):
        Bert(dict(TINY_BERT, **bad), params)


def test_chunks_give_the_same_numbers(monkeypatch):
    from mrgcn_tpu_torch.models import distilbert
    backbone = Bert(dict(TINY_BERT, model_type="roberta", pad_token_id=1),
                    synthetic.bert_params(TINY_BERT, seed=2))
    t = torch.from_numpy(ragged_ids("roberta", vocab=1200))
    whole = backbone(t, attention_mask=t != 1)
    monkeypatch.setattr(distilbert, "BUDGET_BYTES", 2 * 4 * 12 * 64)
    assert backbone.chunk_rows(12) == 2
    assert torch.equal(backbone(t, attention_mask=t != 1), whole)


# --------------------------------------------------------------------------
# (b) the whole pretrained encoder against the JAX package
# --------------------------------------------------------------------------

def both_encoders(directory, ids, pad):
    from mrgcn_tpu.models.pretrained import PretrainedTextEncoder as JText
    from mrgcn_tpu.models.pretrained import \
        load_text_backbone as jax_load_text_backbone
    module, frozen = jax_load_text_backbone([str(directory)])
    jmod = JText(backbone=module, backbone_params=frozen, output_dim=5,
                 p_dropout=0.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    backbone = pretrained.load_text_backbone([str(directory)])
    assert isinstance(backbone, Bert)
    mod = pretrained.PretrainedTextEncoder(backbone, 5, GEN, p_dropout=0.0,
                                           pad_id=pad)
    load_jax_params(mod, variables["params"])
    return jmod, variables, mod


def test_bert_encoder_matches_jax(offline_hub, tmp_path):
    flax_model("bert", tmp_path / "bert", seed=1)
    ids = ragged_ids("bert")
    jmod, variables, mod = both_encoders(tmp_path / "bert", ids, 0)
    assert_encoder_matches(jmod, variables, jnp.asarray(ids), mod,
                           torch.from_numpy(ids))


def test_roberta_encoder_masks_the_real_pad_where_jax_does_not(offline_hub,
                                                               tmp_path):
    """The port pools CLS from the Flax model under ``ids != 1``; the JAX
    package's encoder masks ``tokens > 0`` (hiding ``<s>``, attending to
    every pad) and numbers positions ``0 .. L-1`` (the module's default,
    not RoBERTa's), and its output differs."""
    model = flax_model("roberta", tmp_path / "roberta", seed=2)
    ids = ragged_ids("roberta")
    jmod, variables, mod = both_encoders(tmp_path / "roberta", ids, 1)
    t = torch.from_numpy(ids)
    want = flax_hidden(model, ids, 1)[:, 0]
    assert max_rel(mod.features(t).numpy(), want) <= 1e-5
    # the JAX package's encoder: its head over the CLS of tokens > 0 at
    # positions 0 .. L-1
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
    # each of the two faults alone moves the pooled output
    for mask, positions in (((ids > 0), None),
                            ((ids != 1), np.broadcast_to(np.arange(L),
                                                         ids.shape))):
        kw = {} if positions is None else {"position_ids": positions}
        other = np.asarray(model(ids, attention_mask=mask.astype("i4"),
                                 **kw)[0])[:, 0]
        assert max_rel(other, want) > 1e-3


def test_jax_encoder_runs_relative_key_as_absolute(offline_hub, tmp_path):
    """flax's BERT family reads no ``position_embedding_type``: the JAX
    package's encoder gives a ``relative_key`` config the output of the
    same files with absolute positions, distance embeddings dropped (the
    reference fault of ROADMAP Queue 3); the port refuses the field."""
    import json
    import shutil
    from mrgcn_tpu.models.pretrained import PretrainedTextEncoder as JText
    from mrgcn_tpu.models.pretrained import \
        load_text_backbone as jax_load_text_backbone
    flax_model("bert", tmp_path / "absolute", seed=5)
    shutil.copytree(tmp_path / "absolute", tmp_path / "relative")
    path = tmp_path / "relative" / "config.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    position_embedding_type="relative_key")))
    ids = jnp.asarray(ragged_ids("bert"))
    outs = []
    for name in ("absolute", "relative"):
        module, frozen = jax_load_text_backbone([str(tmp_path / name)])
        assert module.config.position_embedding_type == (
            "relative_key" if name == "relative" else "absolute")
        jmod = JText(backbone=module, backbone_params=frozen, output_dim=5,
                     p_dropout=0.0)
        variables = jmod.init(jax.random.PRNGKey(0), ids)
        outs.append(np.asarray(jmod.apply(variables, ids)))
    np.testing.assert_array_equal(outs[1], outs[0])
    with pytest.raises(NotImplementedError, match="relative_key"):
        pretrained.load_text_backbone([str(tmp_path / "relative")])


# --------------------------------------------------------------------------
# (c) an NC model with a BERT backbone through both packages
# --------------------------------------------------------------------------

def backbone_nc_sides(offline_hub, tmp_path, config_json, **strings):
    """The small multimodal workload with numeric and string features on
    the text backbone ``config_json`` (written into the hub cache): both
    packages' inputs, batch and model, the JAX model's parameters loaded
    into the port."""
    from mrgcn_tpu.data import artifact as jax_artifact_io
    from tests.test_torch_multimodal_slice import both_sides, small_workload
    from tests.test_torch_pretrained import backbone_config
    name = "tiny-org/tiny-" + config_json["model_type"]
    synthetic.save_text_backbone_snapshot(offline_hub, name,
                                          config=config_json)
    w = small_workload()
    path = tmp_path / "bert_nc.npz"
    F = synthetic.multimodal_features(
        w["n"], seed=0, num_numeric=100, num_years=10, num_strings=30,
        max_len=8, **strings)
    del F["xsd.gYear"]
    synthetic.save_nc_artifact(
        str(path), w["n"], w["R"], w["src"], w["dst"], w["rel"], w["norm"],
        w["labels_idx"], w["labels_cls"], w["num_classes"], seed=0,
        num_eval=40, F=F)
    config = backbone_config("node classification")
    features = config["graph"]["features"][:2]
    features[1]["model"][-1] = features[1]["tokenizer"]["config"][-1] = name
    if config_json["model_type"] != "bert":
        features[1]["tokenizer"]["pad_token"] = "<pad>"
    config["graph"]["features"] = features
    art = jax_artifact_io.load(str(path))
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    return config, both_sides(art, config, Y_train, False)


def test_nc_model_with_a_bert_backbone_matches_jax(offline_hub, tmp_path):
    from mrgcn_tpu.tasks import node_classification as jnc
    from mrgcn_tpu.tasks import utils as jutils
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks.jax_import import params_to_state_dict
    config, sides = backbone_nc_sides(offline_hub, tmp_path, TINY_BERT,
                                      wordpiece_vocab=1200)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    assert tin.text_pad_id == jin.text_pad_id == 0
    assert isinstance(tmodel.xsd_string_0.backbone, Bert)
    assert tmodel.xsd_string_0.pad_id == 0
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


def test_roberta_nc_model_pads_and_masks_with_its_pad_id(offline_hub,
                                                         tmp_path):
    """Both packages pad RoBERTa's strings with ``<pad>`` (1, from the
    snapshot's byte-level BPE); the port's encoder masks that id, so a
    padded row's pooled output is the row's alone."""
    roberta = dict(synthetic.ROBERTA_BASE, hidden_size=32,
                   num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=64, vocab_size=1200,
                   max_position_embeddings=66)
    _, sides = backbone_nc_sides(offline_hub, tmp_path, roberta,
                                 bpe_vocab=1200)
    (jin, _, _, _), (tin, _, tmodel) = sides
    assert tin.text_pad_id == jin.text_pad_id == 1
    encoder = tmodel.xsd_string_0
    assert encoder.pad_id == 1 and isinstance(encoder.backbone, Bert)
    tokens = tin.features["xsd_string_0"][0]
    np.testing.assert_array_equal(tokens.numpy(),
                                  np.asarray(jin.features["xsd_string_0"][0]))
    rows = tokens[:8]
    lengths = (rows != 1).sum(dim=1)
    assert (rows[:, 0] == 0).all() and int(lengths.min()) < rows.shape[1]
    pooled = encoder.features(rows)
    for row, n, want in zip(rows, lengths, pooled):
        alone = encoder.features(row[None, :int(n)])[0]
        assert max_rel(alone.numpy(), want.numpy()) <= 1e-5
