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
fetched): :func:`save_text_backbone_snapshot` writes a DistilBERT, BERT,
RoBERTa, XLM-R, RoBERTa-PreLayerNorm or ALBERT model in the HuggingFace
hub cache's layout (``config.json``, the tokenizer's files and flax's
``flax_model.msgpack``) at ``distilbert-base-multilingual-cased``'s
published widths by default (``BERT_MULTILINGUAL``, ``ROBERTA_BASE``,
``XLM_ROBERTA_BASE``, ``ROBERTA_PRELAYERNORM`` and ``ALBERT_XXLARGE`` are
the other published configs here), and :func:`save_mobilenet_checkpoint`
a torchvision-format MobileNetV2 ``.pth``. :func:`multimodal_features`
draws WordPiece-like token strings for them with ``wordpiece_vocab``,
RoBERTa-like ones with ``bpe_vocab``, or takes the ids a tokenizer gave
generated strings (:func:`text_literals`, :func:`tokenized_strings`);
:func:`save_unigram_tokenizer` writes a SentencePiece Unigram
``tokenizer.json`` with a precompiled charsmap (:func:`charsmap_bytes`).
"""

from __future__ import annotations

import base64
import io
import json
import pickle
import struct
import tarfile
import unicodedata
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
# feature width of an encoded xsd:date (the gYear columns, then month and
# day on the unit circle)
DATE_WIDTH = 10
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
# bert-base-multilingual-cased's published config.json (the model
# DistilBERT's was distilled from)
BERT_MULTILINGUAL = {
    "architectures": ["BertForMaskedLM"],
    "attention_probs_dropout_prob": 0.1, "directionality": "bidi",
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1, "hidden_size": 768,
    "initializer_range": 0.02, "intermediate_size": 3072,
    "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
    "model_type": "bert", "num_attention_heads": 12,
    "num_hidden_layers": 12, "pad_token_id": 0, "pooler_fc_size": 768,
    "pooler_num_attention_heads": 12, "pooler_num_fc_layers": 3,
    "pooler_size_per_head": 128, "pooler_type": "first_token_transform",
    "type_vocab_size": 2, "vocab_size": 119547}
# roberta-base's published config.json
ROBERTA_BASE = {
    "architectures": ["RobertaForMaskedLM"],
    "attention_probs_dropout_prob": 0.1, "bos_token_id": 0,
    "eos_token_id": 2, "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "hidden_size": 768, "initializer_range": 0.02,
    "intermediate_size": 3072, "layer_norm_eps": 1e-05,
    "max_position_embeddings": 514, "model_type": "roberta",
    "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 1,
    "type_vocab_size": 1, "vocab_size": 50265}
# xlm-roberta-base's published config.json
XLM_ROBERTA_BASE = {
    "architectures": ["XLMRobertaForMaskedLM"],
    "attention_probs_dropout_prob": 0.1, "bos_token_id": 0,
    "eos_token_id": 2, "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "hidden_size": 768, "initializer_range": 0.02,
    "intermediate_size": 3072, "layer_norm_eps": 1e-05,
    "max_position_embeddings": 514, "model_type": "xlm-roberta",
    "num_attention_heads": 12, "num_hidden_layers": 12,
    "output_past": True, "pad_token_id": 1, "type_vocab_size": 1,
    "vocab_size": 250002}
# transformers' RobertaPreLayerNormConfig() defaults, which its docstring
# likens to andreasmadsen/efficient_mlm_m0.40
ROBERTA_PRELAYERNORM = {
    "architectures": ["RobertaPreLayerNormForMaskedLM"],
    "attention_probs_dropout_prob": 0.1, "bos_token_id": 0,
    "eos_token_id": 2, "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
    "hidden_size": 768, "initializer_range": 0.02,
    "intermediate_size": 3072, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512, "model_type": "roberta-prelayernorm",
    "num_attention_heads": 12, "num_hidden_layers": 12, "pad_token_id": 1,
    "position_embedding_type": "absolute", "type_vocab_size": 2,
    "vocab_size": 50265}
# transformers' AlbertConfig() defaults, which its docstring gives as
# albert-xxlarge-v2
ALBERT_XXLARGE = {
    "architectures": ["AlbertForMaskedLM"],
    "attention_probs_dropout_prob": 0, "bos_token_id": 2,
    "classifier_dropout_prob": 0.1, "embedding_size": 128,
    "eos_token_id": 3, "hidden_act": "gelu_new", "hidden_dropout_prob": 0,
    "hidden_size": 4096, "initializer_range": 0.02, "inner_group_num": 1,
    "intermediate_size": 16384, "layer_norm_eps": 1e-12,
    "max_position_embeddings": 512, "model_type": "albert",
    "num_attention_heads": 64, "num_hidden_groups": 1,
    "num_hidden_layers": 12, "pad_token_id": 0,
    "position_embedding_type": "absolute", "type_vocab_size": 2,
    "vocab_size": 30000}
# bigscience/bloom-560m's published config.json, with its legacy names
# (``n_embed``, ``num_attention_heads``) as transformers' BloomConfig
# reads them: 24 layers, 1,024 wide, 16 heads, feed-forward 4,096
BLOOM_560M = {
    "apply_residual_connection_post_layernorm": False,
    "architectures": ["BloomForCausalLM"], "attention_dropout": 0.0,
    "attention_softmax_in_fp32": True, "bias_dropout_fusion": True,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_dropout": 0.0,
    "initializer_range": 0.02, "layer_norm_epsilon": 1e-05,
    "masked_softmax_fusion": True, "model_type": "bloom", "n_embed": 1024,
    "n_inner": None, "n_layer": 24, "num_attention_heads": 16,
    "offset_alibi": 100, "pad_token_id": 3, "pretraining_tp": 1,
    "seq_length": 2048, "skip_bias_add": True, "skip_bias_add_qkv": False,
    "slow_but_exact": False, "unk_token_id": 0, "use_cache": True,
    "vocab_size": 250880}
# a BERT WordPiece vocabulary's special ids, and the first id of its
# word pieces
WORDPIECE_SPECIALS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102,
                      "[MASK]": 103}
FIRST_WORDPIECE = 1000
# a RoBERTa byte-level BPE vocabulary's special ids (``<mask>`` is its
# last id), and the first id of its other tokens
BPE_SPECIALS = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
FIRST_BPE = 4
# the special pieces of a SentencePiece Unigram vocabulary, first in it
# (XLM-R's ``<mask>`` is its last piece), its unknown piece, and its
# tokenizer class (``tokenizer_config.json``)
UNIGRAM_SPECIALS = {
    "xlm-roberta": (("<s>", "<pad>", "</s>", "<unk>"), "<unk>",
                    "XLMRobertaTokenizer"),
    "albert": (("<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"), "<unk>",
               "AlbertTokenizer")}
# BLOOM's byte-level BPE's special ids, first in its vocabulary
BLOOM_BPE_SPECIALS = {"<unk>": 0, "<s>": 1, "</s>": 2, "<pad>": 3}
# the merges of the small byte-level BPE that save_byte_bpe writes
BYTE_BPE_MERGES = ("Ġ t", "h e", "i n", "e r", "a n", "Ġt he", "o n",
                   "r e", "Ġ a", "e n", "Ġ s", "a t", "Ġ c", "o r")


def _drawn_strings(rng, num_strings: int, max_len: int,
                   wordpiece_vocab: int, bpe_vocab: int):
    """``multimodal_features``' string ids and lengths, drawn."""
    lengths = rng.integers(1, max_len + 1, num_strings)
    # (first id, end of the ids, the ids around each string)
    if wordpiece_vocab > 0:
        ids = (FIRST_WORDPIECE, wordpiece_vocab,
               (WORDPIECE_SPECIALS["[CLS]"], WORDPIECE_SPECIALS["[SEP]"]))
    elif bpe_vocab > 0:
        ids = (FIRST_BPE, bpe_vocab - 1,
               (BPE_SPECIALS["<s>"], BPE_SPECIALS["</s>"]))
    else:
        ids = (0, ByteTokenizer.PAD, None)
    tokens = rng.integers(ids[0], ids[1], int(lengths.sum())).astype(
        np.int32)
    strings = np.empty(num_strings, dtype=object)
    for i, part in enumerate(np.split(tokens, np.cumsum(lengths)[:-1])):
        if ids[2]:
            part = np.concatenate([ids[2][:1], part, ids[2][1:]]
                                  ).astype(np.int32)
        strings[i] = part
    if ids[2]:
        lengths = lengths + 2
    return strings, lengths


def multimodal_features(num_nodes: int, seed: int = 0,
                        num_numeric: int = 20_000, num_years: int = 10_000,
                        num_strings: int = 8_000,
                        max_len: int = 128, num_geometries: int = 0,
                        num_images: int = 0, image_size: int = 224,
                        geometry_points=(4, WKT_MAX_POINTS),
                        wordpiece_vocab: int = 0, bpe_vocab: int = 0,
                        token_strings=None, num_dates: int = 0,
                        num_booleans: int = 0) -> dict:
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
    stay as they were. So are, after them, ``num_dates`` ``xsd.date``
    values (``DATE_WIDTH`` columns: day 1-28 of a month of a year
    1000-2024 through the port's own date vectorizer, its century column
    min/max scaled over the set) and ``num_booleans`` ``xsd.boolean``
    values (+1 or -1, as the boolean vectorizer maps ``true`` and
    ``false``). With ``wordpiece_vocab`` > 0 the strings are
    WordPiece-like token ids for a pretrained text backbone instead:
    ``[CLS]`` (101), 1 to ``max_len`` ids uniform in ``[1000,
    wordpiece_vocab)``, ``[SEP]`` (102); the tokenizer's pad is 0. With
    ``bpe_vocab`` > 0 they are RoBERTa-like ids: ``<s>`` (0), ids uniform
    in ``[4, bpe_vocab - 1)`` (the last id is ``<mask>``), ``</s>`` (2);
    the tokenizer's pad is 1. ``token_strings``: the string set's ids and
    lengths as a tokenizer gave them (:func:`tokenized_strings`), taken
    as they are (``num_strings`` and ``max_len`` unused)."""
    rng = np.random.default_rng(seed)

    def nodes(k):
        return np.sort(rng.choice(num_nodes, k, replace=False)).astype(
            np.int32)

    numeric = rng.standard_normal((num_numeric, 1)).astype(np.float32)
    years = rng.uniform(-1.0, 1.0, (num_years, GYEAR_WIDTH)).astype(
        np.float32)
    if token_strings is not None:
        strings, lengths = token_strings
        num_strings = len(strings)
    else:
        strings, lengths = _drawn_strings(rng, num_strings, max_len,
                                          wordpiece_vocab, bpe_vocab)
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
    if num_dates > 0:
        F["xsd.date"] = [[_drawn_dates(rng, num_dates), nodes(num_dates),
                          np.full(num_dates, DATE_WIDTH, np.int32)]]
    if num_booleans > 0:
        booleans = rng.choice(np.array([-1.0, 1.0], np.float32),
                              (num_booleans, 1))
        F["xsd.boolean"] = [[booleans, nodes(num_booleans),
                             np.ones(num_booleans, np.int32)]]
    return F


def _drawn_dates(rng, num_dates: int) -> np.ndarray:
    """``multimodal_features``' dates: ``(num_dates, DATE_WIDTH)`` rows
    as the date vectorizer encodes ``YYYY-MM-DD`` literals of drawn days,
    the century column scaled over the set as the vectorizer scales it
    per predicate."""
    from mrgcn_tpu_torch.encodings.xsd.temporal import _encode_date
    days = np.stack([rng.integers(1000, 2025, num_dates),
                     rng.integers(1, 13, num_dates),
                     rng.integers(1, 29, num_dates)], axis=1)
    rows = np.array([_encode_date(f"{y:04d}-{m:02d}-{d:02d}")
                     for y, m, d in days], np.float32)
    century = rows[:, 1]
    lo, hi = float(century.min()), float(century.max())
    rows[:, 1] = 0.0 if hi == lo else 2 * (century - lo) / (hi - lo) - 1.0
    return rows


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

def _normal_params(config: Dict, seed: int):
    """Draws for a parameter tree: ``normal(*shape)`` with the config's
    ``initializer_range``, ``dense(n_in, n_out)`` (zero bias) and
    ``norm(n)`` (scale 1, bias 0), float32. The normals are torch's
    (twice numpy's rate on the CPU: a published-width tree holds hundreds
    of millions)."""
    gen = torch.Generator().manual_seed(seed)
    std = float(config.get("initializer_range", 0.02))

    def normal(*shape):
        return (torch.randn(shape, generator=gen) * std).numpy()

    def dense(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros(n_out, np.float32)}

    def norm(n):
        return {"scale": np.ones(n, np.float32),
                "bias": np.zeros(n, np.float32)}

    return normal, dense, norm


def distilbert_params(config: Dict, seed: int = 0) -> Dict:
    """A DistilBERT parameter tree in flax's layout
    (``FlaxDistilBertModel.params``) at ``config``'s widths: embeddings
    and kernels normal with the config's ``initializer_range``, biases 0,
    LayerNorm scales 1, float32."""
    normal, dense, norm = _normal_params(config, seed)
    dim, hidden = int(config["dim"]), int(config["hidden_dim"])
    layers = {}
    for i in range(int(config["n_layers"])):
        layers[str(i)] = {
            "attention": {name: dense(dim, dim) for name in
                          ("q_lin", "k_lin", "v_lin", "out_lin")},
            "sa_layer_norm": norm(dim),
            "ffn": {"lin1": dense(dim, hidden), "lin2": dense(hidden, dim)},
            "output_layer_norm": norm(dim)}
    return {"embeddings": {
                "word_embeddings": {"embedding": normal(
                    int(config["vocab_size"]), dim)},
                "position_embeddings": {"embedding": normal(
                    int(config["max_position_embeddings"]), dim)},
                "LayerNorm": norm(dim)},
            "transformer": {"layer": layers}}


def bert_params(config: Dict, seed: int = 0) -> Dict:
    """A BERT / RoBERTa / XLM-R parameter tree in flax's layout
    (``FlaxBertModel.params``: ``embeddings``, ``encoder/layer/<i>``,
    ``pooler``) at ``config``'s widths, drawn as :func:`distilbert_params`
    draws; with ``add_cross_attention`` each layer also holds a
    ``crossattention`` in its attention's layout, drawn after the rest."""
    normal, dense, norm = _normal_params(config, seed)
    dim = int(config["hidden_size"])
    hidden = int(config["intermediate_size"])

    def attention():
        return {"self": {name: dense(dim, dim)
                         for name in ("query", "key", "value")},
                "output": {"dense": dense(dim, dim), "LayerNorm": norm(dim)}}

    layers = {}
    for i in range(int(config["num_hidden_layers"])):
        layers[str(i)] = {
            "attention": attention(),
            "intermediate": {"dense": dense(dim, hidden)},
            "output": {"dense": dense(hidden, dim), "LayerNorm": norm(dim)}}
    embeddings = {
        name: {"embedding": normal(int(config[size]), dim)}
        for name, size in (("word_embeddings", "vocab_size"),
                           ("position_embeddings", "max_position_embeddings"),
                           ("token_type_embeddings", "type_vocab_size"))}
    tree = {"embeddings": {**embeddings, "LayerNorm": norm(dim)},
            "encoder": {"layer": layers},
            "pooler": {"dense": dense(dim, dim)}}
    preln = config.get("model_type") == "roberta-prelayernorm"
    if preln:
        # the norms before the sublayers, and one after the last layer
        for layer in layers.values():
            layer["attention"]["LayerNorm"] = \
                layer["attention"]["output"].pop("LayerNorm")
            layer["intermediate"]["LayerNorm"] = \
                layer["output"].pop("LayerNorm")
        tree["LayerNorm"] = norm(dim)
    if config.get("add_cross_attention"):
        for layer in layers.values():
            cross = layer["crossattention"] = attention()
            if preln:
                cross["LayerNorm"] = cross["output"].pop("LayerNorm")
    return tree


def albert_params(config: Dict, seed: int = 0) -> Dict:
    """An ALBERT parameter tree in flax's layout (``FlaxAlbertModel.params``:
    ``embeddings`` at ``embedding_size``,
    ``encoder/embedding_hidden_mapping_in``,
    ``encoder/albert_layer_groups/<g>/albert_layers/<j>``, ``pooler``) at
    ``config``'s widths, drawn as :func:`distilbert_params` draws."""
    normal, dense, norm = _normal_params(config, seed)
    emb = int(config.get("embedding_size", 128))
    dim = int(config["hidden_size"])
    hidden = int(config["intermediate_size"])
    groups = {}
    for g in range(int(config.get("num_hidden_groups", 1))):
        layers = {}
        for j in range(int(config.get("inner_group_num", 1))):
            layers[str(j)] = {
                "attention": {**{name: dense(dim, dim) for name in
                                 ("query", "key", "value", "dense")},
                              "LayerNorm": norm(dim)},
                "ffn": dense(dim, hidden), "ffn_output": dense(hidden, dim),
                "full_layer_layer_norm": norm(dim)}
        groups[str(g)] = {"albert_layers": layers}
    embeddings = {
        name: {"embedding": normal(int(config[size]), emb)}
        for name, size in (("word_embeddings", "vocab_size"),
                           ("position_embeddings", "max_position_embeddings"),
                           ("token_type_embeddings", "type_vocab_size"))}
    return {"embeddings": {**embeddings, "LayerNorm": norm(emb)},
            "encoder": {"embedding_hidden_mapping_in": dense(emb, dim),
                        "albert_layer_groups": groups},
            "pooler": dense(dim, dim)}


def bloom_params(config: Dict, seed: int = 0) -> Dict:
    """A BLOOM parameter tree in flax's layout (``FlaxBloomModel.params``:
    ``word_embeddings``, ``word_embeddings_layernorm``, ``h/<i>`` with
    ``input_layernorm``, ``self_attention/{query_key_value,dense}``,
    ``post_attention_layernorm``, ``mlp/{dense_h_to_4h,dense_4h_to_h}``,
    then ``ln_f``) at ``config``'s widths (``models.bloom.bloom_sizes``),
    drawn as :func:`distilbert_params` draws."""
    from mrgcn_tpu_torch.models.bloom import BLOOM_DEFAULTS, bloom_sizes
    normal, dense, norm = _normal_params(config, seed)
    dim, n_layers, _ = bloom_sizes(config)
    layers = {}
    for i in range(n_layers):
        layers[str(i)] = {
            "input_layernorm": norm(dim),
            "self_attention": {"query_key_value": dense(dim, 3 * dim),
                               "dense": dense(dim, dim)},
            "post_attention_layernorm": norm(dim),
            "mlp": {"dense_h_to_4h": dense(dim, 4 * dim),
                    "dense_4h_to_h": dense(4 * dim, dim)}}
    vocab = int(config.get("vocab_size", BLOOM_DEFAULTS["vocab_size"]))
    return {"word_embeddings": {"embedding": normal(vocab, dim)},
            "word_embeddings_layernorm": norm(dim), "h": layers,
            "ln_f": norm(dim)}


# --------------------------------------------------------------------------
# SentencePiece Unigram tokenizers and the strings they read
# --------------------------------------------------------------------------

def charsmap_bytes(mapping: Dict[bytes, str]) -> bytes:
    """A precompiled charsmap (what ``tokenizer.json``'s ``Precompiled``
    normalizer holds, base64) of ``mapping``, key bytes to replacement:
    a little-endian u32 trie size, the darts-clone double array of the
    keys (units placed first-fit: a node's children at ``base ^ label``,
    its leaf at ``base``, each base used once), then the NUL-terminated
    replacements."""
    blob = bytearray()
    value_at = {}
    for key in sorted(mapping):
        if not key or 0 in key:
            raise ValueError(f"charsmap key {key!r}: empty or holding NUL")
        value_at[key] = len(blob)
        blob += mapping[key].encode("utf-8") + b"\0"
    root: Dict = {}                      # label -> child; None -> its key
    for key in mapping:
        node = root
        for b in key:
            node = node.setdefault(b, {})
        node[None] = key
    units, used, bases = [0], bytearray(b"\1"), set()

    def place(node, pos):
        labels = sorted(0 if b is None else b for b in node)
        q = used.find(0, 1)
        q = len(used) if q < 0 else q
        while True:
            base = q ^ labels[0]
            if base | 0xFF >= len(used):
                grow = (base | 0xFF) + 1 - len(used)
                used.extend(bytes(grow))
                units.extend([0] * grow)
            if base and base not in bases and (pos ^ base) < (1 << 21) \
                    and not any(used[base ^ b] for b in labels):
                break
            q = used.find(0, q + 1)
            q = len(used) if q < 0 else q
        bases.add(base)
        for b in labels:
            used[base ^ b] = 1
        units[pos] |= (pos ^ base) << 10
        if None in node:
            units[pos] |= 1 << 8
            units[base] = value_at[node[None]] | (1 << 31)
        children = sorted((b, c) for b, c in node.items() if b is not None)
        for b, _ in children:
            units[base ^ b] = b
        for b, child in children:
            place(child, base ^ b)

    place(root, 0)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


def nfkc_charsmap() -> bytes:
    """A charsmap in the manner of SentencePiece's ``nmt_nfkc``: each code
    point of the BMP to Python's NFKC of it where that differs, controls
    dropped, tab, LF and CR to a space; and keys of several code points:
    CR LF to a space, and the Latin letters followed by one of eight
    combining accents to their precomposed letter."""
    mapping: Dict[bytes, str] = {}
    for cp in range(1, 0x10000):
        c = chr(cp)
        if 0xD800 <= cp <= 0xDFFF:
            continue
        if c in "\t\n\r":
            mapping[c.encode()] = " "
        elif unicodedata.category(c) == "Cc":
            mapping[c.encode()] = ""
        elif unicodedata.normalize("NFKC", c) != c:
            mapping[c.encode()] = unicodedata.normalize("NFKC", c)
    mapping[b"\r\n"] = " "
    for base in "aeiouncyAEIOUNCY":
        for mark in "\u0300\u0301\u0302\u0303\u0308\u030a\u0327\u030c":
            composed = unicodedata.normalize("NFC", base + mark)
            if len(composed) == 1:
                mapping[(base + mark).encode()] = composed
    return charsmap_bytes(mapping)


# the pools that text_literals draws words from
_SYLLABLES = [c + v for c in "bdfgklmnprstvz" for v in "aeiou"]
_WORDS = ["café", "cafe\u0301", "naïve", "Über", "straße", "ﬁnal", "Ａｂｃ",
          "１２３", "東京", "大学", "😀", "👍🏽", "👩\u200d💻", "don't", "2024",
          "3.14", "Ελληνικά", "русский", "한국어", "\r\n", "\t", "  ", "   ",
          "!!", "…", "–", "<mask>", "<s>", "</s>", "[MASK]", "[CLS]",
          "``quoted''", "x\u0301\u0302\u0303", "\u00a0", "ℌ", "㍿", "ǅ"]


def text_literals(num: int, seed: int = 0, max_words: int = 40) -> list:
    """``num`` distinct strings of 1 to ``max_words`` words, from ``seed``:
    syllable words (some capitalised) and, one word in five, one of
    ``_WORDS`` (accents precomposed and not, ligatures, fullwidth forms,
    CJK, Hangul, emoji with modifiers and ZWJ, CR LF, tabs, runs of spaces,
    no-break spaces, special tokens of XLM-R and ALBERT but their pad,
    which an encoder masks wherever it stands), joined by spaces; each
    ends with its index, so that no two are equal."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        words = []
        for _ in range(int(rng.integers(1, max_words + 1))):
            if rng.random() < 0.2:
                words.append(_WORDS[rng.integers(len(_WORDS))])
            else:
                word = "".join(rng.choice(_SYLLABLES, rng.integers(1, 4)))
                words.append(word.capitalize() if rng.random() < 0.2
                             else word)
        out.append(" ".join(words) + f" {i}")
    return out


def unigram_pieces(num: int, seed: int = 0, lowercase: bool = False) -> list:
    """``num`` distinct ``(piece, score)`` pairs for a Unigram vocabulary
    over :func:`text_literals`' strings: every character of their words
    and ``▁``, the syllables and digits alone and after ``▁``, then words
    of two or three syllables, after ``▁`` or not; scores uniform in [-14,
    -1], rounded to 0.1 so that paths tie. ``lowercase``: no capitals
    (ALBERT's normalizer lowercases)."""
    rng = np.random.default_rng(seed)
    chars = sorted({c for w in _WORDS + _SYLLABLES
                    for c in unicodedata.normalize("NFKC", w)
                    if not c.isspace()} | set("0123456789▁ABCDEFGHIJKLMNOP"
                                              "QRSTUVWXYZ.,"))
    if lowercase:
        chars = sorted({c.lower() for c in chars})
    pieces = dict.fromkeys(chars)
    units = _SYLLABLES + [str(d) for d in range(10)]
    if not lowercase:
        units += [u.capitalize() for u in _SYLLABLES]
    for unit in units:
        pieces.setdefault(unit)
        pieces.setdefault("▁" + unit)
    while len(pieces) < num:
        size = 1 << 16
        counts = rng.integers(2, 4, size)
        draws = rng.integers(0, len(_SYLLABLES), (size, 3))
        marks = rng.random(size) < 0.5
        for k, row, mark in zip(counts, draws, marks):
            pieces.setdefault(("▁" if mark else "")
                              + "".join(_SYLLABLES[j] for j in row[:k]))
    scores = np.round(rng.uniform(-14.0, -1.0, len(pieces)), 1)
    return [(p, float(x)) for p, x in zip(list(pieces)[:num], scores)]


def _template(specials, vocab):
    ids = {t: i for i, (t, _) in enumerate(vocab)}

    def seq(*parts):
        return [{"SpecialToken": {"id": p, "type_id": 0}} if p != "$A"
                else {"Sequence": {"id": "A", "type_id": 0}}
                for p in parts]

    first, last = specials
    return {"type": "TemplateProcessing", "single": seq(first, "$A", last),
            "pair": seq(first, "$A", last, last) + [
                {"Sequence": {"id": "B", "type_id": 0}},
                {"SpecialToken": {"id": last, "type_id": 0}}],
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                               for t in specials}}


def save_unigram_tokenizer(directory, model_type: str = "xlm-roberta",
                           num_pieces: int = 4000, seed: int = 0) -> Path:
    """Write a SentencePiece Unigram tokenizer as transformers saves
    XLM-R's or ALBERT's (``model_type``) into ``directory``:
    ``tokenizer.json`` (the special pieces of ``UNIGRAM_SPECIALS`` at
    their ids, :func:`unigram_pieces` to ``num_pieces`` pieces in all,
    XLM-R's ``<mask>`` last; the normalizer, XLM-R's ``Precompiled`` of
    :func:`nfkc_charsmap` then runs of spaces to one, ALBERT's quote
    replacements, NFKD, accents stripped, lowercase and the same; a
    ``Metaspace`` pre-tokenizer; ``<s> $A </s>`` or ``[CLS] $A [SEP]``)
    and ``tokenizer_config.json`` naming the tokenizer class."""
    specials, unk, cls = UNIGRAM_SPECIALS[model_type]
    albert = model_type == "albert"
    extra = () if albert else ("<mask>",)
    vocab = [(t, 0.0) for t in specials] + unigram_pieces(
        num_pieces - len(specials) - len(extra), seed, lowercase=albert) \
        + [(t, 0.0) for t in extra]
    charsmap = {"type": "Precompiled", "precompiled_charsmap":
                base64.b64encode(nfkc_charsmap()).decode("ascii")}
    spaces = {"type": "Replace", "pattern": {"Regex": " {2,}"},
              "content": " "}
    if albert:
        normalizers = [
            {"type": "Replace", "pattern": {"String": "``"},
             "content": '"'},
            {"type": "Replace", "pattern": {"String": "''"},
             "content": '"'},
            {"type": "NFKD"}, {"type": "StripAccents"},
            {"type": "Lowercase"}, charsmap, spaces]
        template = ("[CLS]", "[SEP]")
    else:
        normalizers = [charsmap, spaces]
        template = ("<s>", "</s>")
    masks = {"<mask>", "[MASK]"}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False,
             "lstrip": t in masks, "rstrip": False, "normalized": False,
             "special": True}
            for i, (t, _) in enumerate(vocab)
            if t in specials or t in extra],
        "normalizer": {"type": "Sequence", "normalizers": normalizers},
        "pre_tokenizer": {"type": "Metaspace", "replacement": "▁",
                          "prepend_scheme": "always", "split": True},
        "post_processor": _template(template, vocab),
        "decoder": {"type": "Metaspace", "replacement": "▁",
                    "prepend_scheme": "always", "split": True},
        "model": {"type": "Unigram", "unk_id": [t for t, _ in vocab]
                  .index(unk), "vocab": [list(v) for v in vocab],
                  "byte_fallback": False}}
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": cls, "model_max_length": 512,
         **({"do_lower_case": True, "keep_accents": False} if albert
            else {})}))
    return directory


def tokenized_strings(feature_config: Dict, strings) -> list:
    """The string vectorizer's arrays for ``strings`` as literals of one
    predicate (``encodings/xsd/string.generate_features`` under
    ``feature_config``'s tokenizer): ``[ragged ids, node_idx,
    seq_lengths]``, rows in ``strings``' order."""
    from mrgcn_tpu_torch.data.rdf import Literal, xsd
    from mrgcn_tpu_torch.encodings.common import IndexedNodesMap
    from mrgcn_tpu_torch.encodings.xsd import string
    nodes = [Literal(t, datatype=xsd("string")) for t in strings]
    nodes_map = IndexedNodesMap.build({n: i for i, n in enumerate(nodes)})
    out = string.generate_features(
        nodes_map, {n: {"http://example.org/text"} for n in nodes},
        feature_config)
    if out is None or len(out) != 1 or len(out[0][1]) != len(strings):
        raise ValueError("the tokenizer encoded "
                         f"{0 if out is None else len(out[0][1])} of "
                         f"{len(strings)} strings")
    return out[0]


def wordpiece_vocab_lines(vocab_size: int):
    """A ``vocab.txt`` of ``vocab_size`` lines in BERT's layout: the
    special tokens at their ids, unused slots, then word pieces."""
    by_id = {i: t for t, i in WORDPIECE_SPECIALS.items()}
    return [by_id.get(i, f"[unused{i}]" if i < FIRST_WORDPIECE
                      else f"piece{i}") for i in range(vocab_size)]


def save_byte_bpe(directory) -> None:
    """Write a small RoBERTa byte-level BPE as ``vocab.json`` and
    ``merges.txt`` (what transformers' ``RobertaTokenizer`` reads, without
    the ``tokenizers`` library): ``BPE_SPECIALS`` at their ids, the 256
    byte symbols, each product of ``BYTE_BPE_MERGES``, ``<mask>`` last;
    the merges as ``"left right"`` lines after a ``#version`` header."""
    from mrgcn_tpu_torch.encodings.xsd.bpe import byte_symbols
    vocab = dict(BPE_SPECIALS)
    for token in [*byte_symbols(),
                  *(m.replace(" ", "") for m in BYTE_BPE_MERGES), "<mask>"]:
        vocab.setdefault(token, len(vocab))
    directory = Path(directory)
    (directory / "vocab.json").write_text(json.dumps(vocab),
                                          encoding="utf-8")
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(m + "\n" for m in BYTE_BPE_MERGES),
        encoding="utf-8")


def save_bloom_bpe(directory, vocab_size: int) -> Path:
    """Write a byte-level BPE in BLOOM's layout into ``directory``:
    ``tokenizer.json`` (no normalizer; the pre-tokenizer a ``Sequence`` of
    BLOOM's ``Split`` on ``encodings.xsd.bpe.BLOOM_SPLIT``, ``Isolated``,
    and ``ByteLevel`` without a prefix space or its regex; a ``ByteLevel``
    post-processor, which adds no ids; ``BLOOM_BPE_SPECIALS`` first, the
    256 byte symbols, then the products of :func:`bloom_merges` while they
    fit in ``vocab_size``) and ``tokenizer_config.json`` naming
    ``BloomTokenizerFast`` with its specials, as bigscience/bloom's. The
    merges, in rank order, cover :func:`text_literals`' words: each
    syllable from its two letters, capitalised too, each after the
    space's symbol ``Ġ``, the digits after ``Ġ``, two-digit runs, then
    words of two syllables after ``Ġ`` and alone."""
    from mrgcn_tpu_torch.encodings.xsd.bpe import BLOOM_SPLIT, byte_symbols
    vocab = dict(BLOOM_BPE_SPECIALS)
    for symbol in byte_symbols():
        vocab.setdefault(symbol, len(vocab))
    words = _SYLLABLES + [w.capitalize() for w in _SYLLABLES]
    digits = "0123456789"
    candidates = [f"{w[0]} {w[1]}" for w in words] \
        + [f"Ġ {w}" for w in words] + [f"Ġ {d}" for d in digits] \
        + [f"{a} {b}" for a in digits for b in digits] \
        + [f"Ġ{a} {b}" for a in words for b in _SYLLABLES] \
        + [f"{a} {b}" for a in words for b in _SYLLABLES]
    merges = []
    for merge in candidates:
        if len(vocab) >= vocab_size:
            break
        vocab.setdefault(merge.replace(" ", ""), len(vocab))
        merges.append(merge)
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": True, "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t, i in BLOOM_BPE_SPECIALS.items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": BLOOM_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": dict(byte_level, add_prefix_space=True,
                               trim_offsets=False),
        "decoder": dict(byte_level, add_prefix_space=True),
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "vocab": vocab, "merges": merges}}
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (directory / "tokenizer_config.json").write_text(json.dumps(
        {"unk_token": "<unk>", "eos_token": "</s>", "bos_token": "<s>",
         "pad_token": "<pad>", "tokenizer_class": "BloomTokenizerFast",
         "padding_side": "left"}))
    return directory


def save_text_backbone_snapshot(cache_dir, name: str =
                                "distilbert-base-multilingual-cased",
                                config: Optional[Dict] = None,
                                seed: int = 0,
                                revision: str = "0" * 40) -> Path:
    """Write a random text backbone (``config``: a ``config.json``,
    ``DISTILBERT_MULTILINGUAL`` by default, or ``BERT_MULTILINGUAL``,
    ``ROBERTA_BASE``, ``XLM_ROBERTA_BASE``, ``ROBERTA_PRELAYERNORM``,
    ``ALBERT_XXLARGE``, ``BLOOM_560M`` or another of their types) into the
    hub cache ``cache_dir`` as the hub lays out ``name``
    (``models--<name>/refs/main`` naming ``snapshots/<revision>/``), with
    ``config.json``,
    ``tokenizer_config.json``, the tokenizer's files and
    ``flax_model.msgpack`` (:func:`distilbert_params`,
    :func:`bert_params`, :func:`albert_params` or :func:`bloom_params`).
    The tokenizer is a WordPiece ``vocab.txt`` of the model's vocabulary
    for DistilBERT and BERT, the small byte-level BPE of
    :func:`save_byte_bpe` for RoBERTa and RoBERTa-PreLayerNorm, a Unigram
    ``tokenizer.json`` (:func:`save_unigram_tokenizer`, as many pieces as
    the model's vocabulary) for XLM-R and ALBERT, BLOOM's layout
    (:func:`save_bloom_bpe`, within the model's vocabulary) for BLOOM.
    Returns the snapshot directory."""
    from mrgcn_tpu_torch.utils import flax_msgpack
    config = dict(config or DISTILBERT_MULTILINGUAL)
    model_type = config.get("model_type", "distilbert")
    repo = Path(cache_dir) / ("models--" + name.replace("/", "--"))
    snapshot = repo / "snapshots" / revision
    snapshot.mkdir(parents=True, exist_ok=True)
    (repo / "refs").mkdir(exist_ok=True)
    (repo / "refs" / "main").write_text(revision)
    (snapshot / "config.json").write_text(json.dumps(config, indent=2))
    if model_type in ("distilbert", "bert"):
        (snapshot / "tokenizer_config.json").write_text(json.dumps(
            {"do_lower_case": False, "model_max_length": 512}))
        (snapshot / "vocab.txt").write_text(
            "\n".join(wordpiece_vocab_lines(int(config["vocab_size"])))
            + "\n", encoding="utf-8")
    elif model_type in ("roberta", "roberta-prelayernorm"):
        (snapshot / "tokenizer_config.json").write_text(json.dumps(
            {"model_max_length": 512}))
        save_byte_bpe(snapshot)
    elif model_type in UNIGRAM_SPECIALS:
        save_unigram_tokenizer(snapshot, model_type,
                               int(config["vocab_size"]), seed)
    elif model_type == "bloom":
        save_bloom_bpe(snapshot, int(config["vocab_size"]))
    params = {"distilbert": distilbert_params, "albert": albert_params,
              "bloom": bloom_params}.get(model_type, bert_params)
    flax_msgpack.save(snapshot / "flax_model.msgpack",
                      params(config, seed))
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
