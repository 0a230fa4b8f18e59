"""The v3.0 pretrained backbones (frozen DistilBERT text, frozen MobileNetV2
images) in the port against the JAX package's.

No file is fetched: the text backbone is a tiny DistilBERT (vocabulary 64
or 1,200, width 32, 2 layers, 2 heads) saved by transformers'
``FlaxDistilBertModel.save_pretrained`` or by the port's own writer
(``tasks/synthetic.save_text_backbone_snapshot``), as a directory or in
the hub cache's layout; the image backbone a random torchvision-format
MobileNetV2 ``.pth`` (``tasks/synthetic.save_mobilenet_checkpoint``, the
format ``tests/test_pretrained.py`` writes), over 32 x 32 images. The hub
stays offline in every case (the ``offline_hub`` fixture pins it so, and
points both packages at a temporary cache).

Tolerances: the backbones' outputs and each encoder's output and head
gradients within 1e-5 of the largest entry (both packages in float32);
the model level as ``tests/test_torch_multimodal_slice.py`` holds it
(logits 2e-4 x max(1, max |logit|), three steps' losses rtol 1e-4).
"""

import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mrgcn_tpu_torch.models import distilbert, mobilenet, pretrained  # noqa: E402
from mrgcn_tpu_torch.models.distilbert import DistilBert  # noqa: E402
from mrgcn_tpu_torch.tasks import synthetic  # noqa: E402
from mrgcn_tpu_torch.tasks.jax_import import (  # noqa: E402
    load_jax_params, params_to_state_dict)
from mrgcn_tpu_torch.utils import flax_msgpack  # noqa: E402

GEN = torch.Generator().manual_seed(0)
TINY = dict(synthetic.DISTILBERT_MULTILINGUAL, dim=32, n_layers=2, n_heads=2,
            hidden_dim=64, vocab_size=1200, max_position_embeddings=64)
SPEC = ["huggingface/pytorch-transformers", "model", "tiny-org/tiny-lm"]


@pytest.fixture
def offline_hub(tmp_path, monkeypatch):
    """A temporary hub cache, offline, for both packages (transformers
    fixes its cache directory and offline mode when it is imported)."""
    pytest.importorskip("transformers")
    import huggingface_hub.constants as hub_constants
    import transformers.utils.hub as transformers_hub
    cache = tmp_path / "hub"
    cache.mkdir()
    for name in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        monkeypatch.setenv(name, "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)
    monkeypatch.setattr(hub_constants, "HF_HUB_CACHE", str(cache))
    monkeypatch.setattr(transformers_hub, "_is_offline_mode", True)
    monkeypatch.setattr(transformers_hub, "TRANSFORMERS_CACHE", str(cache))
    return cache


def save_tiny_lm(directory, n_layers=2):
    from transformers import DistilBertConfig, FlaxDistilBertModel
    cfg = DistilBertConfig(vocab_size=64, dim=32, n_layers=n_layers,
                           n_heads=2, hidden_dim=64,
                           max_position_embeddings=64)
    FlaxDistilBertModel(cfg, seed=0).save_pretrained(str(directory))
    return directory


def tiny_tokens(seed=4, N=6, L=10, vocab=64):
    """A first token that is not padding, ids in [1, vocab), 0 pads."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (N, L)).astype(np.int32)
    for i, keep in enumerate([L, 1, 4, 7, 2, 9]):
        tokens[i, keep:] = 0
    return tokens


def max_rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------
# flax's msgpack
# --------------------------------------------------------------------------

def test_msgpack_decoder_and_writer_match_flax(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    from flax import serialization
    raw = (save_tiny_lm(tmp_path / "lm") / "flax_model.msgpack").read_bytes()
    want = serialization.msgpack_restore(raw)
    got = flax_msgpack.restore(raw)
    flat_want, flat_got = (params_to_state_dict(t) for t in (want, got))
    assert sorted(flat_got) == sorted(flat_want)
    assert all(torch.equal(flat_got[k], flat_want[k]) for k in flat_want)
    # the writer's bytes read back in flax, chunked arrays included
    back = serialization.msgpack_restore(flax_msgpack.serialize(got))
    assert all(torch.equal(v, flat_want[k]) for k, v in
               params_to_state_dict(back).items())
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_BYTES", 256)
    tree = {"w": np.arange(300, dtype=np.float32).reshape(3, 100),
            "meta": {"name": "x" * 40, "n": -3, "big": 70_000}}
    for data in (serialization.msgpack_serialize(tree),
                 flax_msgpack.serialize(tree)):
        for restore in (flax_msgpack.restore,
                        serialization.msgpack_restore):
            out = restore(data)
            np.testing.assert_array_equal(out["w"], tree["w"])
            assert out["meta"] == tree["meta"]
    with pytest.raises(flax_msgpack.FormatError, match="0xc1 at byte 0"):
        flax_msgpack.restore(b"\xc1")
    with pytest.raises(flax_msgpack.FormatError, match="truncated"):
        flax_msgpack.restore(raw[:-7])


# --------------------------------------------------------------------------
# where each package takes the backbone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["full", "config_only", "absent",
                                  "directory"])
def test_snapshot_resolution_matches_jax(case, offline_hub, tmp_path):
    """The port builds the text backbone exactly where the JAX package's
    ``load_text_backbone`` returns a module."""
    from mrgcn_tpu.models.pretrained import \
        load_text_backbone as jax_load_text_backbone
    spec = list(SPEC)
    if case in ("full", "config_only"):
        snapshot = synthetic.save_text_backbone_snapshot(
            offline_hub, "tiny-org/tiny-lm", config=TINY)
        if case == "config_only":
            (snapshot / "flax_model.msgpack").unlink()
    elif case == "directory":
        spec[-1] = str(save_tiny_lm(tmp_path / "lm-dir"))
    want = jax_load_text_backbone(spec) is not None
    assert want == (case in ("full", "directory"))
    assert (pretrained.load_text_backbone(spec) is not None) == want


def test_tokenizer_pad_id_matches_jax(offline_hub):
    from mrgcn_tpu.encodings.xsd import string as jstring
    from mrgcn_tpu_torch.encodings.xsd import string as tstring
    config = {"tokenizer": {"config": SPEC[:1] + ["tokenizer", SPEC[-1]],
                            "pad_token": "[PAD]"}}
    # nothing cached: both take the byte-level tokenizer's pad
    assert tstring.pad_symbol_for(config) == jstring.pad_symbol_for(config) \
        == 256
    synthetic.save_text_backbone_snapshot(offline_hub, "tiny-org/tiny-lm",
                                          config=TINY)
    assert tstring.pad_symbol_for(config) == jstring.pad_symbol_for(config) \
        == 0


def test_corrupt_files_raise_where_the_reference_trains_another_encoder(
        offline_hub, tmp_path, monkeypatch):
    """A cached backbone file that does not load: the JAX package's loaders
    catch every exception and train the from-scratch encoder instead (a
    reference fault); the port raises."""
    from mrgcn_tpu.models import mobilenet as jmobilenet
    from mrgcn_tpu.models.pretrained import \
        load_text_backbone as jax_load_text_backbone
    snapshot = synthetic.save_text_backbone_snapshot(
        offline_hub, "tiny-org/tiny-lm", config=TINY)
    raw = (snapshot / "flax_model.msgpack").read_bytes()
    (snapshot / "flax_model.msgpack").write_bytes(raw[:len(raw) // 2])
    assert jax_load_text_backbone(SPEC) is None
    with pytest.raises(flax_msgpack.FormatError, match="truncated"):
        pretrained.load_text_backbone(SPEC)
    weights = tmp_path / "mobilenet_v2-broken.pth"
    weights.write_bytes(b"not a checkpoint")
    monkeypatch.setenv("MRGCN_VISION_WEIGHTS", str(weights))
    assert jmobilenet.load_image_backbone(["pytorch/vision",
                                           "mobilenet_v2"]) is None
    with pytest.raises(Exception):
        mobilenet.load_image_backbone(mobilenet.find_local_checkpoint())


# --------------------------------------------------------------------------
# the encoders
# --------------------------------------------------------------------------

def head_grads(jmod, variables, x):
    grads = jax.grad(lambda p: jnp.sum(
        jmod.apply({"params": p}, x) ** 2))(variables["params"])
    return params_to_state_dict(grads)


def assert_encoder_matches(jmod, variables, jax_x, mod, x):
    want = np.asarray(jmod.apply(variables, jax_x))
    out = mod(x)
    assert max_rel(out.detach().numpy(), want) <= 1e-5
    (out ** 2).sum().backward()
    want_grads = head_grads(jmod, variables, jax_x)
    got = {n: p.grad for n, p in mod.named_parameters()}
    assert sorted(got) == sorted(want_grads) == [
        "Dense_0.bias", "Dense_0.kernel", "Dense_1.bias", "Dense_1.kernel"]
    for name, g in got.items():
        assert max_rel(g.numpy(), want_grads[name].numpy()) <= 1e-5, name


def test_text_backbone_and_encoder_match_jax(offline_hub, tmp_path,
                                             monkeypatch):
    from mrgcn_tpu.models.pretrained import PretrainedTextEncoder as JText
    from mrgcn_tpu.models.pretrained import \
        load_text_backbone as jax_load_text_backbone
    spec = [str(save_tiny_lm(tmp_path / "lm"))]
    module, frozen = jax_load_text_backbone(spec)
    tokens = tiny_tokens()
    want = np.asarray(module.apply({"params": frozen}, input_ids=tokens,
                                   attention_mask=(tokens > 0)
                                   .astype("i4"))[0])
    backbone = pretrained.load_text_backbone(spec)
    ids = torch.from_numpy(tokens)
    hidden = backbone(ids, attention_mask=ids > 0)
    assert max_rel(hidden.numpy(), want) <= 1e-5
    # in chunks of two sequences: the same numbers
    monkeypatch.setattr(distilbert, "BUDGET_BYTES", 2 * 4 * 10 * 64)
    assert backbone.chunk_rows(10) == 2
    assert torch.equal(backbone(ids, attention_mask=ids > 0), hidden)

    jmod = JText(backbone=module, backbone_params=frozen, output_dim=5,
                 p_dropout=0.0)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    mod = pretrained.PretrainedTextEncoder(backbone, 5, GEN, p_dropout=0.0,
                                           pad_id=0)
    load_jax_params(mod, variables["params"])
    assert_encoder_matches(jmod, variables, jnp.asarray(tokens), mod, ids)


def test_image_backbone_and_encoder_match_jax(tmp_path, monkeypatch):
    from mrgcn_tpu.models import mobilenet as jmobilenet
    from mrgcn_tpu.models.pretrained import PretrainedImageEncoder as JImage
    path = tmp_path / "mobilenet_v2-test.pth"
    synthetic.save_mobilenet_checkpoint(path, seed=0)
    monkeypatch.setenv("MRGCN_VISION_WEIGHTS", str(path))
    assert mobilenet.find_local_checkpoint() == str(path)
    module, variables_bb = jmobilenet.load_image_backbone(["x",
                                                           "mobilenet_v2"])
    backbone = mobilenet.load_image_backbone(str(path))
    x = np.random.default_rng(2).standard_normal(
        (3, 3, 32, 32)).astype(np.float32)
    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    want = np.transpose(np.asarray(module.apply(variables_bb, x_nhwc)),
                        (0, 3, 1, 2))
    feats = backbone(torch.from_numpy(x))
    assert feats.shape == (3, 1280, 1, 1)
    assert max_rel(feats.numpy(), want) <= 1e-5

    jmod = JImage(backbone=module, backbone_variables=variables_bb,
                  output_dim=6, p_dropout=0.0)
    variables = jmod.init(jax.random.PRNGKey(0), x_nhwc)
    mod = pretrained.PretrainedImageEncoder(backbone, 6, GEN, p_dropout=0.0)
    load_jax_params(mod, variables["params"])
    assert_encoder_matches(jmod, variables, x_nhwc, mod, torch.from_numpy(x))
    # BatchNorm stays in inference mode whatever mode the module is in
    mod.train()
    assert torch.equal(backbone(torch.from_numpy(x)), feats)


def test_backbone_is_frozen_and_off_the_tree(tmp_path):
    path = tmp_path / "mobilenet_v2-test.pth"
    synthetic.save_mobilenet_checkpoint(path, seed=1)
    backbone = mobilenet.load_image_backbone(str(path))
    mod = pretrained.PretrainedImageEncoder(backbone, 4, GEN)
    assert sorted(mod.state_dict()) == sorted(
        n for n, _ in mod.named_parameters()) == [
        "Dense_0.bias", "Dense_0.kernel", "Dense_1.bias", "Dense_1.kernel"]
    assert not any(p.requires_grad for p in backbone.parameters())
    # the backbone moves with the module (.to, .double, ...)
    mod.double()
    assert backbone.features[0][0].weight.dtype == torch.float64
    assert mod.Dense_0.kernel.dtype == torch.float64
    mod.float()
    before = {k: v.clone() for k, v in backbone.state_dict().items()}
    x = torch.randn(2, 3, 32, 32, generator=GEN)
    mod(x, train=True).sum().backward()
    assert all(torch.equal(v, before[k])
               for k, v in backbone.state_dict().items())
    # a strict load: a checkpoint that lacks a feature entry raises
    sd = torch.load(path, weights_only=True)
    del sd["features.3.conv.1.1.running_var"]
    with pytest.raises(RuntimeError, match="running_var"):
        mobilenet.load_state_dict(mobilenet.MobileNetV2Features(), sd)


@pytest.mark.parametrize("bad, match", [
    ({"activation": "mish"}, "activation 'mish'.*ACT2FN: gelu, relu"),
    ({"model_type": "electra"},
     "'electra'.*FlaxAutoModel loads it and its encoder fails at the first "
     "step with a TypeError: its module's token types or positions"),
    ({"model_type": "t5"}, "'t5'.*an AttributeError: it is given no "
                           "decoder inputs"),
    ({"model_type": "llama"}, "'llama'.*a broadcast error in its rotary "
                              "tables"),
    ({"model_type": "bart"}, "'bart'.*a TypeError: its decoder inputs are "
                             "required"),
    ({"model_type": "vit"}, "'vit'.*an error: it is no text encoder"),
    ({"model_type": "bloom"}, "'bloom': this module reads distilbert"),
    ({"model_type": "deberta"}, "'deberta'.*FlaxAutoModel does not map "
                                "it"),
    ({"model_type": "albert"}, "'albert': this module reads distilbert")],
    ids=["activation", "positional", "decoder_inputs_t5", "rotary",
         "decoder_inputs", "not_text", "queued", "unmapped", "other_module"])
def test_unsupported_text_backbones_raise(bad, match):
    """Each kind of refusal names the type and what the JAX package does
    with it: a family its encoder cannot call fails at its first step
    there, a type FlaxAutoModel does not map trains the JAX package's
    from-scratch encoder; a type the port runs elsewhere (ALBERT, BLOOM:
    the case once named for BLOOM's queue) names the loader that picks
    its module."""
    params = synthetic.distilbert_params(TINY)
    DistilBert(TINY, params)
    with pytest.raises(NotImplementedError, match=match):
        DistilBert(dict(TINY, **bad), params)


DISTILBERT_ACTS = ("gelu_new", "gelu_pytorch_tanh", "quick_gelu", "silu",
                   "swish", "tanh")


@pytest.mark.parametrize("options", [
    {"sinusoidal_pos_embds": True}, {"activation": "relu"},
    {"sinusoidal_pos_embds": True, "activation": "relu"}]
    + [{"activation": act} for act in DISTILBERT_ACTS],
    ids=["sinusoidal", "relu", "both", *DISTILBERT_ACTS])
def test_distilbert_config_options_match_flax(offline_hub, options):
    """DistilBERT's fixed sinusoidal position embeddings and each
    feed-forward activation of flax's ``ACT2FN`` (exact GELU, the
    default, in the sinusoidal case): the port against
    ``FlaxDistilBertModel`` built from the same config with random
    parameters (nothing fetched), within 1e-5 of the largest entry."""
    from transformers import DistilBertConfig, FlaxDistilBertModel
    cfg = DistilBertConfig(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                           hidden_dim=64, max_position_embeddings=64,
                           **options)
    flax_model = FlaxDistilBertModel(cfg, seed=3)
    emb = flax_model.params["embeddings"]
    assert ("position_embeddings" in emb) \
        != options.get("sinusoidal_pos_embds", False)
    tokens = tiny_tokens()
    want = np.asarray(flax_model(tokens, attention_mask=(tokens > 0)
                                 .astype("i4"))[0])
    model = DistilBert(cfg.to_dict(), flax_model.params)
    ids = torch.from_numpy(tokens)
    assert max_rel(model(ids, attention_mask=ids > 0).numpy(), want) \
        <= 1e-5
    if options.get("sinusoidal_pos_embds"):
        from transformers.models.distilbert.modeling_flax_distilbert \
            import positional_encoding
        np.testing.assert_array_equal(model.position_embeddings.numpy(),
                                      np.asarray(positional_encoding(64,
                                                                     32))[0])


# --------------------------------------------------------------------------
# the model, both drivers, checkpoints and reference imports
# --------------------------------------------------------------------------

TRANSFORM = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
BACKBONE_FEATURES = [
    {"datatype": "xsd.numeric", "include": True, "embedding_dim": 4},
    {"datatype": "xsd.string", "include": True, "embedding_dim": 8,
     "model": SPEC, "tokenizer": {"config": [SPEC[0], "tokenizer", SPEC[2]],
                                  "pad_token": "[PAD]"}},
    {"datatype": "blob.image", "include": True, "embedding_dim": 8,
     "transform": TRANSFORM,
     "model": ["pytorch/vision:v0.10.0", "mobilenet_v2"]},
]


def backbone_features(n):
    return synthetic.multimodal_features(
        n, seed=0, num_numeric=100, num_years=10, num_strings=30, max_len=8,
        num_images=12, image_size=32, wordpiece_vocab=TINY["vocab_size"])


def backbone_config(task, epochs=3, num_bases=3):
    from mrgcn_tpu.config import apply_defaults
    layers = [{"hidden_nodes": 16}, {"type": "mrgcn"}]
    if task == "link prediction":
        layers.insert(0, {"hidden_nodes": 16})
    return apply_defaults({
        "name": "BB", "graph": {"features": [
            json.loads(json.dumps(f)) for f in BACKBONE_FEATURES]},
        "task": {"type": task, "seed": 0},
        "model": {"epoch": epochs, "num_bases": num_bases, "gates_lr": 0.01,
                  "l2_lambda": 5e-4, "layers": layers}})


@pytest.fixture
def backbone_files(offline_hub, tmp_path, monkeypatch):
    synthetic.save_text_backbone_snapshot(offline_hub, SPEC[-1], config=TINY)
    path = tmp_path / "mobilenet_v2-test.pth"
    synthetic.save_mobilenet_checkpoint(path, seed=0)
    monkeypatch.setenv("MRGCN_VISION_WEIGHTS", str(path))
    return tmp_path


def backbone_nc_sides(directory, num_bases=3):
    """The small NC workload with both backbones: its artifact, config and
    both packages' inputs, batch and model (``both_sides``)."""
    from mrgcn_tpu.data import artifact as jax_artifact_io
    from tests.test_torch_multimodal_slice import both_sides, small_workload
    w = small_workload()
    path = directory / "bb.npz"
    synthetic.save_nc_artifact(
        str(path), w["n"], w["R"], w["src"], w["dst"], w["rel"], w["norm"],
        w["labels_idx"], w["labels_cls"], w["num_classes"], seed=0,
        num_eval=40, F=backbone_features(w["n"]))
    art = jax_artifact_io.load(str(path))
    config = backbone_config("node classification", num_bases=num_bases)
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    return path, config, both_sides(art, config, Y_train, False)


@pytest.fixture
def nc_sides(backbone_files):
    return backbone_nc_sides(backbone_files)


def test_nc_model_with_both_backbones_matches_jax(nc_sides):
    assert_nc_with_both_backbones_matches_jax(*nc_sides[1:])


def test_nc_model_with_both_backbones_without_bases_matches_jax(
        backbone_files):
    """The same at ``num_bases = 0``, as ``configs/synth.toml`` runs both
    backbones: one weight per relation in both halves of layer 0."""
    config, sides = backbone_nc_sides(backbone_files, num_bases=0)[1:]
    layer0 = dict(sides[1][2].rgcn.layer_0.named_parameters())
    assert "comp_i" not in layer0 and "comp_f" not in layer0
    assert_nc_with_both_backbones_matches_jax(config, sides)


def assert_nc_with_both_backbones_matches_jax(config, sides):
    """Logits from the JAX model's parameters, then three training steps'
    losses, the port against the JAX package."""
    from tests.test_torch_multimodal_slice import (assert_logits_close,
                                                   train_both)
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    assert tin.text_pad_id == jin.text_pad_id == 0
    assert isinstance(tmodel.xsd_string_0, pretrained.PretrainedTextEncoder)
    assert isinstance(tmodel.blob_image_0, pretrained.PretrainedImageEncoder)
    # the heads are the whole encoder tree in both packages
    assert sorted(params["xsd_string_0"]) == sorted(params["blob_image_0"]) \
        == ["Dense_0", "Dense_1"]
    want = jmodel.apply({"params": params}, jbatch.features, jbatch.edges)
    assert_logits_close(tmodel(tbatch.edges, tbatch.features), want)
    got, want_losses = train_both(sides, config)
    np.testing.assert_allclose(got, want_losses, rtol=1e-4)


def test_lp_model_with_both_backbones_matches_jax(backbone_files):
    import optax

    from mrgcn_tpu.data import artifact as jax_artifact_io
    from mrgcn_tpu.ops import distmult as jdm
    from mrgcn_tpu.tasks import link_prediction as jlp
    from mrgcn_tpu.tasks.common import prepare_inputs as jax_prepare_inputs
    from mrgcn_tpu_torch.data import artifact as artifact_io
    from mrgcn_tpu_torch.tasks import link_prediction as lp
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    path = str(backbone_files / "lp.npz")
    sizes = dict(num_nodes=100, num_props=4, num_train=400, num_valid=40,
                 num_test=40)
    synthetic.save_lp_artifact(path, seed=0, features=backbone_features(100),
                               **sizes)
    config = backbone_config("link prediction")
    art, jart = artifact_io.load(path), jax_artifact_io.load(path)
    train = np.asarray(art.data["train"])
    jin = jax_prepare_inputs(jart, config, False)
    jmodel = jlp.build_model(jin, config)
    variables = jmodel.init(jax.random.PRNGKey(0), jin.features, jin.edges)
    tin = prepare_inputs(art, config, False, torch.device("cpu"))
    tbatch = lp.make_lp_batches(tin, train, -1, -1, 2)[0]
    tmodel = lp.build_model(tin, config, torch.Generator().manual_seed(1))
    assert isinstance(tmodel.xsd_string_0, pretrained.PretrainedTextEncoder)
    load_jax_params(tmodel, variables["params"])
    triples, labels, weights = lp.make_corruptor(0.2)(
        torch.from_numpy(tbatch.data), tbatch.num_triples,
        torch.from_numpy(tbatch.corrupt_pool), tbatch.num_pool,
        torch.Generator().manual_seed(0))

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jin.features, jin.edges)
        t = jnp.asarray(triples.numpy())
        y_hat = jdm.score(t[:, 0], t[:, 1], t[:, 2], out,
                          p["rgcn"]["relations"])
        bce = optax.sigmoid_binary_cross_entropy(
            y_hat, jnp.asarray(labels.numpy()))
        w = jnp.asarray(weights.numpy())
        return jnp.sum(bce * w) / jnp.maximum(jnp.sum(w), 1.0)

    want, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    got = lp.loss_and_grads(tmodel, tbatch, triples, labels, weights)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    want_grads = params_to_state_dict(want_grads)
    named = dict(tmodel.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for name in ("xsd_string_0.Dense_0.kernel", "blob_image_0.Dense_1.kernel",
                 "gate_weights"):
        assert max_rel(named[name].grad.numpy(),
                       want_grads[name].numpy()) <= 1e-4, name


def test_checkpoint_with_backbones_holds_the_heads_both_ways(nc_sides,
                                                             tmp_path):
    """The port's checkpoint of a model with both backbones holds the
    heads and no backbone tensor; it loads into the JAX package's model
    (equal logits), and the JAX package's file loads back into the
    port."""
    from mrgcn_tpu.tasks import utils as jutils
    from mrgcn_tpu_torch.tasks import utils as tutils
    from tests.test_torch_multimodal_slice import assert_logits_close
    _, config, sides = nc_sides
    (jin, jbatch, jmodel, params), (tin, tbatch, tmodel) = sides
    optimizer = tutils.build_optimizer(tmodel, config, tin.optimizer_config,
                                       False)
    path = str(tmp_path / "bb_state.npz")
    tutils.save_checkpoint(path, 2, tmodel, optimizer, 0.5)
    keys = [k for k in np.load(path).files if k.startswith("params/")]
    assert sorted(k for k in keys if "xsd_string_0" in k) == [
        f"params/xsd_string_0/Dense_{j}/{leaf}" for j in (0, 1)
        for leaf in ("bias", "kernel")]
    assert len(keys) == len(list(tmodel.parameters()))
    state = jutils.load_checkpoint(path)
    assert jax.tree_util.tree_structure(state["params"]) \
        == jax.tree_util.tree_structure(params)
    want = jmodel.apply({"params": state["params"]}, jbatch.features,
                        jbatch.edges)
    assert_logits_close(tmodel(tbatch.edges, tbatch.features), want)
    back = str(tmp_path / "jax_state.npz")
    jutils.save_checkpoint(back, 3, state["params"], state["opt_state"], {},
                           0.25)
    restored = sides[1][2]
    before = {k: v.clone() for k, v in restored.state_dict().items()}
    with torch.no_grad():
        for p in restored.parameters():
            p.add_(1.0)
    assert tutils.restore_checkpoint(restored, optimizer,
                                     tutils.load_checkpoint(back)) == 3
    assert all(torch.equal(v, before[k])
               for k, v in restored.state_dict().items())


def test_reference_checkpoint_lands_on_the_heads(nc_sides, tmp_path):
    """A reference ``torch.save`` state dict with ``pre_fc`` / ``fc`` and
    the frozen ``base_model.*`` entries: the heads take ``pre_fc`` /
    ``fc``, ``base_model.*`` is skipped, as the JAX package's import
    does."""
    from mrgcn_tpu.tasks import torch_import as jtorch_import
    from mrgcn_tpu_torch.tasks import torch_import
    _, _, sides = nc_sides
    (_, _, jmodel, params), (_, _, tmodel) = sides
    ref = synthetic.reference_state_dict(tmodel)
    assert any(".base_model." in k for k in ref)
    with torch.no_grad():
        for name in ("xsd_string_0", "blob_image_0"):
            getattr(tmodel, name).Dense_0.kernel.mul_(-2.0)
    moved = synthetic.reference_state_dict(tmodel)
    mapped, _, unmapped = torch_import.map_state_dict(
        {k: v.numpy() for k, v in moved.items()}, tmodel)
    j_mapped, _, j_unmapped = jtorch_import.map_state_dict(
        {k: v.numpy() for k, v in moved.items()}, jmodel, params, {})
    assert sorted(unmapped) == sorted(j_unmapped)
    assert unmapped and all(".base_model." in k for k in unmapped)
    for name in ("xsd_string_0", "blob_image_0"):
        for j in (0, 1):
            for leaf in ("kernel", "bias"):
                got = mapped[name][f"Dense_{j}"][leaf]
                np.testing.assert_array_equal(
                    got, np.asarray(j_mapped[name][f"Dense_{j}"][leaf]))
                np.testing.assert_array_equal(
                    got, getattr(tmodel, name).state_dict()[
                        f"Dense_{j}.{leaf}"].numpy())
