"""Synthetic node-classification and link-prediction datasets written as
artifacts.

Stands in for a real dataset at its full width: the graph arrays come from
the caller (e.g. ``benchmarks/torch_baseline.build_workload``, the
DMG-scale bench graph), the training labels are the caller's, and
validation and test labels are drawn from the remaining nodes with a
seeded generator. :func:`multimodal_features` draws literal features in
the artifact's encoding-set layout (``[encodings, node_idx,
seq_lengths]`` per set): numbers, years at the temporal encoder's width,
byte-token strings and, when asked for, WKT geometries as ``(9, n)``
point sets and uint8 images. :func:`save_lp_artifact` draws a link-prediction
graph at FB15k-237's published sizes, with literal features when given.

The reference's own formats are written here too, for tests and the card's
smoke run (the repository holds no reference-produced file):
:func:`save_reference_tar` writes a dataset in the upstream ``mkdataset``
tarball layout, and :func:`save_reference_checkpoint` a ``torch.save``
checkpoint with the reference's names for a port model's state.

So are the pretrained backbones' files, with random weights from a seed
(the published weights are not in the repository and nothing is
fetched): :func:`save_distilbert_snapshot` writes a DistilBERT model in
the HuggingFace hub cache's layout (``config.json``, a WordPiece-layout
``vocab.txt`` and flax's ``flax_model.msgpack``) at
``distilbert-base-multilingual-cased``'s published widths by default, and
:func:`save_mobilenet_checkpoint` a torchvision-format MobileNetV2
``.pth``. :func:`multimodal_features` draws WordPiece-like token strings
for them with ``wordpiece_vocab``.
"""

from __future__ import annotations

import io
import json
import pickle
import tarfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.encodings.structure import GraphStructure, compute_norm
from mrgcn_tpu_torch.encodings.xsd.string import ByteTokenizer
from mrgcn_tpu_torch.models.encoders import MLP, TCNN
from mrgcn_tpu_torch.models.pretrained import (PretrainedImageEncoder,
                                               PretrainedTextEncoder)
from mrgcn_tpu_torch.ops.rspmm import packing_factor
from mrgcn_tpu_torch.tasks.torch_import import _tcnn_sequential_map

# feature width of an encoded xsd:gYear
# (mrgcn_tpu/encodings/xsd/temporal.py: sign, century, decade and year
# on the unit circle)
GYEAR_WIDTH = 6
# rows of an encoded WKT point (mrgcn_tpu/encodings/ogc/wkt.py: the
# geometry's mean x / y, then x, y, is_point, is_exterior_ring,
# is_interior_ring, sub_stop, full_stop) and the reference's cap on points
# (reference: wktLiteral.py:20)
WKT_ROWS, WKT_MAX_POINTS = 9, 64
# distilbert-base-multilingual-cased's published config.json
DISTILBERT_MULTILINGUAL = {
    "activation": "gelu", "architectures": ["DistilBertForMaskedLM"],
    "attention_dropout": 0.1, "dim": 768, "dropout": 0.1,
    "hidden_dim": 3072, "initializer_range": 0.02,
    "max_position_embeddings": 512, "model_type": "distilbert",
    "n_heads": 12, "n_layers": 6, "output_past": True, "pad_token_id": 0,
    "qa_dropout": 0.1, "seq_classif_dropout": 0.2,
    "sinusoidal_pos_embds": False, "tie_weights_": True,
    "vocab_size": 119547}
# a BERT WordPiece vocabulary's special ids, and the first id of its
# word pieces
WORDPIECE_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
                      "[MASK]": 103}
FIRST_WORDPIECE = 1000


def multimodal_features(num_nodes: int, seed: int = 0,
                        num_numeric: int = 20_000, num_years: int = 10_000,
                        num_strings: int = 8_000,
                        max_len: int = 128, num_geometries: int = 0,
                        num_images: int = 0, image_size: int = 224,
                        geometry_points=(4, WKT_MAX_POINTS),
                        wordpiece_vocab: int = 0) -> dict:
    """``F`` with one encoding set each of ``xsd.numeric`` (one standard
    normal per node), ``xsd.gYear`` (``GYEAR_WIDTH`` values in [-1, 1])
    and ``xsd.string`` (byte tokens, lengths uniform in [1, max_len]), on
    distinct random nodes per set, from ``seed``. The default counts are
    ``benchmarks/bench_suite.multimodal_workload``'s.

    With ``num_geometries`` > 0, an ``ogc.wktLiteral`` set of polygons
    laid out as the vectorizer writes them: ``(WKT_ROWS, n)`` float32
    arrays of ``n`` points, uniform in ``geometry_points`` (a random walk
    in x / y, the mean rows, the exterior-ring flag, the full stop on the
    last point), lengths beside them; with ``num_images`` > 0, a
    ``blob.image`` set of ``(3, image_size, image_size)`` uint8 images.
    Both counts default to 0 and are drawn after the other sets, so those
    stay as they were. With ``wordpiece_vocab`` > 0 the strings are
    WordPiece-like token ids for a pretrained text backbone instead:
    ``[CLS]`` (101), 1 to ``max_len`` ids uniform in ``[1000,
    wordpiece_vocab)``, ``[SEP]`` (102); the tokenizer's pad is 0."""
    rng = np.random.default_rng(seed)

    def nodes(k):
        return np.sort(rng.choice(num_nodes, k, replace=False)).astype(
            np.int32)

    numeric = rng.standard_normal((num_numeric, 1)).astype(np.float32)
    years = rng.uniform(-1.0, 1.0, (num_years, GYEAR_WIDTH)).astype(
        np.float32)
    lengths = rng.integers(1, max_len + 1, num_strings)
    if wordpiece_vocab > 0:
        tokens = rng.integers(FIRST_WORDPIECE, wordpiece_vocab,
                              int(lengths.sum())).astype(np.int32)
    else:
        tokens = rng.integers(0, ByteTokenizer.PAD,
                              int(lengths.sum())).astype(np.int32)
    strings = np.empty(num_strings, dtype=object)
    for i, part in enumerate(np.split(tokens, np.cumsum(lengths)[:-1])):
        if wordpiece_vocab > 0:
            part = np.concatenate([[WORDPIECE_SPECIALS["[CLS]"]], part,
                                   [WORDPIECE_SPECIALS["[SEP]"]]]
                                  ).astype(np.int32)
        strings[i] = part
    if wordpiece_vocab > 0:
        lengths = lengths + 2
    F = {
        "xsd.numeric": [[numeric, nodes(num_numeric),
                         np.ones(num_numeric, np.int32)]],
        "xsd.gYear": [[years, nodes(num_years),
                       np.full(num_years, GYEAR_WIDTH, np.int32)]],
        "xsd.string": [[strings, nodes(num_strings),
                        lengths.astype(np.int32)]],
    }
    if num_geometries > 0:
        lo, hi = geometry_points
        points = rng.integers(lo, hi + 1, num_geometries)
        geometries = np.empty(num_geometries, dtype=object)
        for i, n in enumerate(points):
            g = np.zeros((WKT_ROWS, n), np.float32)
            g[2:4] = np.cumsum(rng.standard_normal((2, n)), axis=1) * 0.1
            g[0:2] = g[2:4].mean(axis=1, keepdims=True)
            g[5] = 1.0                          # exterior ring
            g[8, -1] = 1.0                      # full stop
            geometries[i] = g
        F["ogc.wktLiteral"] = [[geometries, nodes(num_geometries),
                                points.astype(np.int32)]]
    if num_images > 0:
        images = rng.integers(0, 256, (num_images, 3, image_size,
                                       image_size), dtype=np.uint8)
        F["blob.image"] = [[images, nodes(num_images),
                            -np.ones(num_images, np.float32)]]
    return F


def save_nc_artifact(path: str, num_nodes: int, num_relations: int,
                     src, dst, rel, norm, train_nodes, train_classes,
                     num_classes: int, seed: int = 0,
                     num_eval: int = 1000, F=None) -> None:
    """Write an NC artifact with ``train`` = the given labels and
    ``valid``/``test`` = ``num_eval`` unlabelled nodes each, classes
    uniform over ``num_classes``. ``F``: the literal features
    (e.g. :func:`multimodal_features`); none by default."""
    rng = np.random.default_rng(seed)
    train_nodes = np.asarray(train_nodes, dtype=np.int64)
    rest = np.setdiff1d(np.arange(num_nodes), train_nodes)
    picked = rng.choice(rest, 2 * num_eval, replace=False)
    classes = rng.integers(0, num_classes, 2 * num_eval)

    def rows(nodes, cls):
        return np.stack([nodes, cls], axis=1).astype(np.int32)

    Y = {"train": rows(train_nodes, np.asarray(train_classes)),
         "valid": rows(picked[:num_eval], classes[:num_eval]),
         "test": rows(picked[num_eval:], classes[num_eval:])}
    structure = GraphStructure(
        num_nodes=int(num_nodes), num_relations=int(num_relations),
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        rel=np.asarray(rel, np.int32), norm=np.asarray(norm, np.float32))
    sample_map = {split: [f"node{int(i)}" for i in y[:, 0]]
                  for split, y in Y.items()}
    artifact_io.save(path, structure, F or {}, Y=Y, sample_map=sample_map,
                     class_map=[f"class{c}" for c in range(num_classes)])


# FB15k-237's published sizes (Toutanova and Chen 2015): entities,
# properties, and train / valid / test triples
FB15K237 = {"num_nodes": 14_541, "num_props": 237, "train": 272_115,
            "valid": 17_535, "test": 20_466}


def save_lp_artifact(path: str, num_nodes: int = FB15K237["num_nodes"],
                     num_props: int = FB15K237["num_props"],
                     num_train: int = FB15K237["train"],
                     num_valid: int = FB15K237["valid"],
                     num_test: int = FB15K237["test"],
                     seed: int = 0, features: Optional[Dict] = None) -> None:
    """Write a link-prediction artifact of uniformly random triples at
    FB15k-237's sizes (the defaults) from a seeded numpy generator, with
    the literal features ``features`` (e.g. :func:`multimodal_features`;
    none by default).

    The graph is built from the train triples as the ETL builds it: one
    relation per property, then the inverses, then the self-loop, so
    ``num_relations = 2 * num_props + 1`` (475), with the per-relation
    row normalisation. Valid and test triples are drawn the same way and
    stay out of the graph."""
    rng = np.random.default_rng(seed)

    def triples(count):
        return np.stack([rng.integers(0, num_nodes, count),
                         rng.integers(0, num_props, count),
                         rng.integers(0, num_nodes, count)],
                        axis=1).astype(np.int32)

    data = {"train": triples(num_train), "valid": triples(num_valid),
            "test": triples(num_test)}
    s, p, o = data["train"].T
    loops = np.arange(num_nodes, dtype=np.int32)
    num_relations = 2 * num_props + 1
    src = np.concatenate([s, o, loops]).astype(np.int32)
    dst = np.concatenate([o, s, loops]).astype(np.int32)
    rel = np.concatenate([p, p + num_props,
                          np.full(num_nodes, 2 * num_props)]
                         ).astype(np.int32)
    structure = GraphStructure(
        num_nodes=int(num_nodes), num_relations=num_relations, src=src,
        dst=dst, rel=rel,
        norm=compute_norm(src, rel, num_nodes, num_relations))
    artifact_io.save(path, structure, features or {}, data=data)


def _tar_member(tar: tarfile.TarFile, name: str, raw: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(raw)
    tar.addfile(info, io.BytesIO(raw))


def _pickled(obj) -> bytes:
    # protocol 4: numpy arrays pickle through _reconstruct, as the
    # reference's members do (protocol 5 takes another global)
    return pickle.dumps(obj, protocol=4)


def _csr_npz(matrix) -> bytes:
    import scipy.sparse as sp
    buf = io.BytesIO()
    sp.save_npz(buf, matrix.tocsr(), compressed=False)
    return buf.getvalue()


def save_reference_tar(path: str, structure: GraphStructure, F: Dict,
                       Y: Optional[Dict] = None, data: Optional[Dict] = None,
                       sample_map: Optional[Dict] = None,
                       class_map=None) -> None:
    """Write a dataset in the upstream ``mkdataset`` tarball layout that
    ``data/reference_tar.read_reference_tar`` reads (reference:
    mrgcn/data/io/tarball.py): ``A.npz``, the ``(n, R*n)`` CSR of the
    normalised adjacency; ``dict/F/<datatype>.pkl``, each datatype's
    encoding sets with ragged encodings as lists of arrays;
    ``dict/Y/<split>.npz``, one-hot ``(n, classes)`` CSR labels;
    ``dict/data/<split>.npy``, triples; ``sample_map.pkl``; and the class
    map as a list, ``list/class_map/<i>.pkl``, read back in numeric
    order. The arguments are :func:`..data.artifact.save`'s."""
    import scipy.sparse as sp
    n = structure.num_nodes
    num_classes = len(class_map or [])
    with tarfile.open(path, "w") as tar:
        _tar_member(tar, "A.npz", _csr_npz(structure.to_scipy_hstack()))
        for datatype, sets in F.items():
            out = [[list(enc) if enc.dtype == object else enc,
                    np.asarray(idx), np.asarray(lengths)]
                   for enc, idx, lengths in sets]
            _tar_member(tar, f"dict/F/{datatype}.pkl", _pickled(out))
        for split, rows in (Y or {}).items():
            rows = np.asarray(rows).reshape(-1, 2)
            onehot = sp.csr_matrix(
                (np.ones(len(rows), np.float32), (rows[:, 0], rows[:, 1])),
                shape=(n, num_classes))
            _tar_member(tar, f"dict/Y/{split}.npz", _csr_npz(onehot))
        for split, triples in (data or {}).items():
            buf = io.BytesIO()
            np.save(buf, np.asarray(triples), allow_pickle=False)
            _tar_member(tar, f"dict/data/{split}.npy", buf.getvalue())
        _tar_member(tar, "sample_map.pkl", _pickled(sample_map or {}))
        for i, name in enumerate(class_map or []):
            _tar_member(tar, f"list/class_map/{i}.pkl", _pickled(name))


def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The reference's ``model_state_dict`` names for a port model's state
    (the inverse of ``tasks/torch_import.map_state_dict``), as CPU
    tensors: the R-GCN's weights with the identity weight unpacked to
    ``(S*n, out)``, the relation vectors, the gates, and the MLP and TCNN
    encoders (their running statistics too), and the pretrained encoders'
    heads (``pre_fc`` / ``fc``) beside their frozen backbones'
    ``base_model.*`` entries. Other encoders have no reference counterpart
    and are left out."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    names = {"weight_f": "weight_F", "comp_i": "weight_I_comp",
             "comp_f": "weight_F_comp", "bias": "b"}
    for i, out_dim in enumerate(model.hidden_dims):
        layer = f"rgcn.layer_{i}"
        for leaf, ref in names.items():
            if f"{layer}.{leaf}" in sd:
                out[f"rgcn.layers.layer_{i}.{ref}"] = sd[f"{layer}.{leaf}"]
        for leaf in ("weight_i_packed", "weight_i"):
            packed = sd.get(f"{layer}.{leaf}")
            if packed is None:
                continue
            S, rows, lanes = packed.shape
            k = packing_factor(out_dim)
            node = torch.arange(model.num_nodes)
            cols = (node % k)[:, None] * (lanes // k) + torch.arange(out_dim)
            logical = packed[:, (node // k)[:, None], cols]
            out[f"rgcn.layers.layer_{i}.weight_I"] = logical.reshape(
                S * model.num_nodes, out_dim)
    for key in ("rgcn.relations", "gate_weights"):
        if key in sd:
            out[key] = sd[key]
    for name in model.names:
        encoder = getattr(model, name)
        prefix = f"module_dict.{name}"
        if isinstance(encoder, MLP):
            j = 0
            while f"{name}.Dense_{j}.kernel" in sd:
                out[f"{prefix}.mlp.{3 * j}.weight"] = \
                    sd[f"{name}.Dense_{j}.kernel"].T.contiguous()
                out[f"{prefix}.mlp.{3 * j}.bias"] = \
                    sd[f"{name}.Dense_{j}.bias"]
                j += 1
        elif isinstance(encoder, (PretrainedTextEncoder,
                                  PretrainedImageEncoder)):
            for j, ref in ((0, "pre_fc"), (1, "fc")):
                out[f"{prefix}.{ref}.weight"] = \
                    sd[f"{name}.Dense_{j}.kernel"].T.contiguous()
                out[f"{prefix}.{ref}.bias"] = sd[f"{name}.Dense_{j}.bias"]
            for key, t in encoder.backbone.state_dict().items():
                out[f"{prefix}.base_model.{key}"] = t.detach().cpu()
        elif isinstance(encoder, TCNN):
            blocks = sorted({k.split(".")[1] for k in sd
                             if k.startswith(f"{name}._ConvBNRelu_")},
                            key=lambda b: int(b.split("_")[-1]))
            seq = {pos: idx for idx, pos in _tcnn_sequential_map(
                len(blocks)).items()}
            for b, block in enumerate(blocks):
                conv = f"{prefix}.conv.{seq[b, 'conv']}"
                bn = f"{prefix}.conv.{seq[b, 'bn']}"
                here = f"{name}.{block}"
                out[f"{conv}.weight"] = sd[f"{here}.Conv_0.kernel"].permute(
                    2, 1, 0).contiguous()
                out[f"{conv}.bias"] = sd[f"{here}.Conv_0.bias"]
                out[f"{bn}.weight"] = sd[f"{here}.BatchNorm_0.scale"]
                out[f"{bn}.bias"] = sd[f"{here}.BatchNorm_0.bias"]
                out[f"{bn}.running_mean"] = sd[f"{here}.BatchNorm_0.mean"]
                out[f"{bn}.running_var"] = sd[f"{here}.BatchNorm_0.var"]
                out[f"{bn}.num_batches_tracked"] = torch.tensor(0)
            for j, idx in ((0, 0), (1, 3)):
                out[f"{prefix}.fc.{idx}.weight"] = \
                    sd[f"{name}.Dense_{j}.kernel"].T.contiguous()
                out[f"{prefix}.fc.{idx}.bias"] = sd[f"{name}.Dense_{j}.bias"]
    return out


def save_reference_checkpoint(path: str, model: nn.Module, epoch: int,
                              loss: float) -> None:
    """Write a reference-format checkpoint (reference: mrgcn/run.py:
    230-236): ``{epoch, model_state_dict, optimizer_state_dict, loss}``
    through ``torch.save``, the loss a numpy scalar as the reference
    stores it."""
    torch.save({"epoch": epoch,
                "model_state_dict": reference_state_dict(model),
                "optimizer_state_dict": {"state": {}, "param_groups": []},
                "loss": np.float64(loss)}, path)


# --------------------------------------------------------------------------
# pretrained backbones' files, random weights
# --------------------------------------------------------------------------

def distilbert_params(config: Dict, seed: int = 0) -> Dict:
    """A DistilBERT parameter tree in flax's layout
    (``FlaxDistilBertModel.params``) at ``config``'s widths: embeddings
    and kernels normal with the config's ``initializer_range``, biases 0,
    LayerNorm scales 1, float32."""
    rng = np.random.default_rng(seed)
    std = float(config.get("initializer_range", 0.02))
    dim, hidden = int(config["dim"]), int(config["hidden_dim"])

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm():
        return {"scale": np.ones(dim, np.float32),
                "bias": np.zeros(dim, np.float32)}

    layers = {}
    for i in range(int(config["n_layers"])):
        layers[str(i)] = {
            "attention": {name: dense(dim, dim) for name in
                          ("q_lin", "k_lin", "v_lin", "out_lin")},
            "sa_layer_norm": norm(),
            "ffn": {"lin1": dense(dim, hidden), "lin2": dense(hidden, dim)},
            "output_layer_norm": norm()}
    return {"embeddings": {
                "word_embeddings": {"embedding": normal(
                    int(config["vocab_size"]), dim)},
                "position_embeddings": {"embedding": normal(
                    int(config["max_position_embeddings"]), dim)},
                "LayerNorm": norm()},
            "transformer": {"layer": layers}}


def wordpiece_vocab_lines(vocab_size: int):
    """A ``vocab.txt`` of ``vocab_size`` lines in BERT's layout: the
    special tokens at their ids, unused slots, then word pieces."""
    by_id = {i: t for t, i in WORDPIECE_SPECIALS.items()}
    return [by_id.get(i, f"[unused{i}]" if i < FIRST_WORDPIECE
                      else f"piece{i}") for i in range(vocab_size)]


def save_distilbert_snapshot(cache_dir, name: str =
                             "distilbert-base-multilingual-cased",
                             config: Optional[Dict] = None, seed: int = 0,
                             revision: str = "0" * 40) -> Path:
    """Write a random DistilBERT (``config``: a ``config.json``,
    ``DISTILBERT_MULTILINGUAL`` by default) into the hub cache
    ``cache_dir`` as the hub lays out ``name`` (``models--<name>/refs/main``
    naming ``snapshots/<revision>/``), with ``config.json``,
    ``tokenizer_config.json``, a WordPiece ``vocab.txt`` and
    ``flax_model.msgpack``. Returns the snapshot directory."""
    from mrgcn_tpu_torch.utils import flax_msgpack
    config = dict(config or DISTILBERT_MULTILINGUAL)
    repo = Path(cache_dir) / ("models--" + name.replace("/", "--"))
    snapshot = repo / "snapshots" / revision
    snapshot.mkdir(parents=True, exist_ok=True)
    (repo / "refs").mkdir(exist_ok=True)
    (repo / "refs" / "main").write_text(revision)
    (snapshot / "config.json").write_text(json.dumps(config, indent=2))
    (snapshot / "tokenizer_config.json").write_text(json.dumps(
        {"do_lower_case": False, "model_max_length": 512}))
    (snapshot / "vocab.txt").write_text(
        "\n".join(wordpiece_vocab_lines(int(config["vocab_size"]))) + "\n",
        encoding="utf-8")
    flax_msgpack.save(snapshot / "flax_model.msgpack",
                      distilbert_params(config, seed))
    return snapshot


def save_mobilenet_checkpoint(path, seed: int = 0) -> None:
    """Write a random MobileNetV2 state dict in torchvision's format
    (``features.<i>...`` with BatchNorm running statistics, and the
    ``classifier.1`` Linear the backbone drops) with ``torch.save``:
    convolutions normal with variance 2 / fan-in, BatchNorm scales and
    running variances in [0.5, 1.5], BatchNorm biases and running means
    normal (0.1)."""
    from mrgcn_tpu_torch.models.mobilenet import (HEAD_CHANNELS,
                                                  MobileNetV2Features)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, t in MobileNetV2Features().state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("num_batches_tracked"):
            value = torch.tensor(0)
        elif t.dim() == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            value = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
        elif key.endswith((".weight", ".running_var")):
            value = 0.5 + torch.rand(shape, generator=gen)
        else:
            value = 0.1 * torch.randn(shape, generator=gen)
        sd[key] = value
    sd["classifier.1.weight"] = 0.01 * torch.randn((1000, HEAD_CHANNELS),
                                                   generator=gen)
    sd["classifier.1.bias"] = torch.zeros(1000)
    torch.save(sd, str(path))
