"""Feature dispatch, assembly and preprocessing.

The port's copy of :mod:`mrgcn_tpu.encodings.features` (reference:
mrgcn/encodings/graph_features.py). It covers

  * the ETL's dispatch: the 33 concrete XSD/OGC/kgbench datatypes map onto
    the 9 encoder families via the XSD hierarchy walk
    (:func:`feature_module`), whose per-datatype vectorizers
    :func:`construct_features` runs;
  * weight-sharing merges of per-predicate encoding sets, with the
    reference's duplicate-node rules (continuous: mean; discrete tokens:
    column-wise majority vote; geometries and images: mean of padded);
  * Bernoulli noise injection and IQR outlier trim/removal;
  * ``modules_config``, which tells the model which encoders to build;
  * :func:`densify`: ragged sets are padded once per run, not per batch.
"""

from __future__ import annotations

import logging
from importlib import import_module
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from mrgcn_tpu_torch.data.utils import getConfParam
from mrgcn_tpu_torch.encodings.xsd_hierarchy import XSDHierarchy

logger = logging.getLogger(__name__)

AVAILABLE_FEATURES = {"xsd.boolean", "xsd.numeric", "xsd.string",
                      "xsd.anyURI", "blob.image", "ogc.wktLiteral",
                      "xsd.date", "xsd.dateTime", "xsd.gYear"}

# encoder family -> vectorizer module
_MODULES = {
    "xsd.numeric": "mrgcn_tpu_torch.encodings.xsd.numeric",
    "xsd.boolean": "mrgcn_tpu_torch.encodings.xsd.boolean",
    "xsd.date": "mrgcn_tpu_torch.encodings.xsd.temporal",
    "xsd.dateTime": "mrgcn_tpu_torch.encodings.xsd.temporal",
    "xsd.gYear": "mrgcn_tpu_torch.encodings.xsd.temporal",
    "xsd.string": "mrgcn_tpu_torch.encodings.xsd.string",
    "xsd.anyURI": "mrgcn_tpu_torch.encodings.xsd.string",
    "ogc.wktLiteral": "mrgcn_tpu_torch.encodings.ogc.wkt",
    "blob.image": "mrgcn_tpu_torch.encodings.blob.image",
}

# TCNN size thresholds (reference: mrgcn/models/temporal_cnn.py:7-9)
TCNN_LENGTH_S = 20
TCNN_LENGTH_M = 100
TCNN_LENGTH_L = 300


def feature_module(hierarchy: XSDHierarchy, feature_name: str
                   ) -> Optional[str]:
    """Resolve a configured datatype to its encoder family
    (reference: graph_features.py:98-114)."""
    if feature_name in AVAILABLE_FEATURES:
        return feature_name
    if not feature_name.startswith("xsd"):
        return None

    local = feature_name[4:]
    if local not in hierarchy:
        return None
    for feature in AVAILABLE_FEATURES:
        if not feature.startswith("xsd"):
            continue
        if hierarchy.subtypeof(feature[4:], local):
            return feature
    return None


def construct_features(nodes_map: Dict, kg, feature_configs: Sequence[Dict],
                       separate_literals: bool) -> Dict[str, List]:
    """Run vectorizers for all included datatypes
    (reference: graph_features.py:22-61)."""
    hierarchy = XSDHierarchy()

    # literal objects only — that is all the vectorizers look up — over
    # the columnar scan (the full-object map cost ~0.15 s per 160k
    # triples; literals are typically a small fraction)
    from mrgcn_tpu_torch.data.rdf import Literal, UniqueLiteral
    node_predicate_map: Dict[object, set] = {}
    s_col, p_col, o_col = kg.columns()
    if separate_literals:
        for s, p, o in zip(s_col, p_col, o_col):
            if isinstance(o, Literal):
                node_predicate_map.setdefault(
                    UniqueLiteral(s, p, o), set()).add(p)
    else:
        for p, o in zip(p_col, o_col):
            if isinstance(o, Literal):
                node_predicate_map.setdefault(o, set()).add(p)

    # one literal-index pass instead of a full nodes_map scan per
    # vectorizer (encodings/common.IndexedNodesMap)
    from mrgcn_tpu_torch.encodings.common import IndexedNodesMap
    nodes_map = IndexedNodesMap.build(nodes_map)

    features: Dict[str, List] = {}
    for feature_config in feature_configs:
        if not feature_config["include"]:
            continue

        feature_name = feature_config["datatype"]
        family = feature_module(hierarchy, feature_name)
        if family is None:
            logger.debug("Specified feature not available: %s", feature_name)
            continue

        module = import_module(_MODULES[family])
        encoding = module.generate_features(nodes_map, node_predicate_map,
                                            feature_config)
        if encoding is not None:
            features[feature_name] = encoding

    return features


def features_included(config: Dict) -> Set[str]:
    features = set()
    for feature_config in config.get("graph", {}).get("features", []):
        if feature_config["include"]:
            features.add(feature_config["datatype"])
    return features


def isDatatypeIncluded(config: Dict, datatype: str) -> bool:
    for feature in config.get("graph", {}).get("features", []):
        if feature["datatype"] == datatype:
            return feature["include"]
    return False


def getDatatypeConfig(config: Dict, datatype: str) -> Optional[Dict]:
    for feature in config.get("graph", {}).get("features", []):
        if feature["datatype"] == datatype:
            return feature
    return None


# ---------------------------------------------------------------------------
# setup (run-time assembly)
# ---------------------------------------------------------------------------

def setup_features(F: Dict[str, List], num_nodes: int, featureless: bool,
                   config: Dict):
    """Assemble encoding sets into model inputs + module/optimizer configs
    (reference: graph_features.py:63-96).

    Returns ``(X, X_width, modules_config, optimizer_config)`` where
    ``X = [structural_dummy, [datatype, encoding_sets], ...]``.
    """
    X_width = 0
    X: List = [np.empty((num_nodes, 0), dtype=np.float32)]

    modules_config: List[Tuple] = []
    optimizer_config: Dict = {}
    if not featureless:
        features_enabled = features_included(config)
        logger.debug("Features included: %s", ", ".join(features_enabled))
        for datatype in features_enabled:
            if datatype in F:
                logger.debug("Found %d encoding set(s) for datatype %s",
                             len(F[datatype]), datatype)

        feature_configs = config["graph"]["features"]
        features, modules_config, optimizer_config, feat_width = \
            construct_feature_matrix(F, features_enabled, feature_configs)
        X_width += feat_width
        X.extend(features)

        # optimizer config for the encoder gates
        # (reference: graph_features.py:86-94)
        gates_config = {}
        for k, v in config.get("model", {}).items():
            parts = k.split("_")
            if parts[0] == "gates":
                gates_config["_".join(parts[1:])] = v
        optimizer_config["gate_weights"] = gates_config

    return X, X_width, modules_config, optimizer_config


def construct_feature_matrix(F: Dict[str, List], features_enabled: Set[str],
                             feature_configs: Sequence[Dict]):
    """Per-datatype merge/noise/outlier pipeline + module configs
    (reference: graph_features.py:116-266)."""
    embeddings_width = 0
    modules_config: List[Tuple] = []
    embeddings: List = []
    optimizer_config: Dict = {}

    datatypes = sorted(set(features_enabled) & set(F.keys())
                       & AVAILABLE_FEATURES)
    for datatype in datatypes:
        feature_config = next((c for c in feature_configs
                               if c["datatype"] == datatype), {})
        embedding_dim = feature_config.get("embedding_dim", 16)
        dropout = feature_config.get("p_dropout", 0.0)

        optim_params = {k[len("optim_"):]: v
                        for k, v in feature_config.items()
                        if k.startswith("optim_")}
        optimizer_config[datatype] = optim_params

        # do NOT pop: the caller's F belongs to the loaded artifact, which
        # may drive several runs in one process (reference pops —
        # graph_features.py:127 — but reloads the tarball per process)
        encoding_sets = F.get(datatype, [])

        weight_sharing = getConfParam(feature_config, "share_weights", False)
        if weight_sharing:
            logger.debug("weight sharing enabled for %s", datatype)
            if datatype == "blob.image":
                encoding_sets = merge_image_sets(encoding_sets)
            elif datatype == "ogc.wktLiteral":
                encoding_sets = merge_geometry_sets(encoding_sets)
            elif datatype in ("xsd.string", "xsd.anyURI"):
                encoding_sets = merge_discrete_sets(encoding_sets)
            else:
                encoding_sets = merge_continuous_sets(encoding_sets)

        p_noise = getConfParam(feature_config, "p_noise", -1)
        noise_mp = getConfParam(feature_config, "noise_multiplier", -1)
        if p_noise > 0:
            logger.debug("adding noise to %s", datatype)
            if datatype in ("xsd.string", "xsd.anyURI"):
                logger.warning("Noise unsupported for datatype %s", datatype)
            else:
                # copy before the in-place noise so the artifact's arrays
                # survive for reuse within the process
                encoding_sets = [[np.copy(s[0]), *s[1:]]
                                 for s in encoding_sets]
                add_noise_(encoding_sets, p_noise, noise_mp)

        num_encoding_sets = len(encoding_sets)
        for encodings, _, seq_lengths in encoding_sets:
            if datatype in ("xsd.boolean", "xsd.numeric", "xsd.date",
                            "xsd.dateTime", "xsd.gYear"):
                feature_size = encodings.shape[1]
                modules_config.append(
                    (datatype, (feature_size, embedding_dim, dropout)))
            elif datatype in ("xsd.string", "xsd.anyURI"):
                model_config = feature_config.get("model")
                modules_config.append(
                    (datatype, (model_config, embedding_dim, dropout)))
            elif datatype == "ogc.wktLiteral":
                # average feature rows (always 9 here); model size chosen by
                # the q25 of sequence lengths (reference:
                # graph_features.py:205-227)
                feature_size = int(
                    sum(enc.shape[0] for enc in encodings) / len(encodings))
                model_size = "M"
                if not weight_sharing or num_encoding_sets <= 1:
                    q25 = np.quantile(seq_lengths, 0.25)
                    if q25 < TCNN_LENGTH_M:
                        model_size = "S"
                    elif q25 < TCNN_LENGTH_L:
                        model_size = "M"
                    else:
                        model_size = "L"
                modules_config.append(
                    (datatype, (feature_size, embedding_dim, model_size,
                                dropout)))
            elif datatype == "blob.image":
                model_config = feature_config.get("model")
                transform_config = feature_config.get("transform", {})
                modules_config.append(
                    (datatype, (model_config, transform_config,
                                embedding_dim, dropout)))
            embeddings_width += embedding_dim

        if getConfParam(feature_config, "remove_outliers", False):
            if datatype in ("ogc.wktLiteral", "xsd.string", "xsd.anyURI"):
                encoding_sets = [remove_outliers(*s) for s in encoding_sets]
            else:
                logger.warning("Outlier removal unsupported for %s", datatype)

        if getConfParam(feature_config, "trim_outliers", False):
            if datatype == "ogc.wktLiteral":
                encoding_sets = [trim_outliers(*s, time_axis=1)
                                 for s in encoding_sets]
            elif datatype in ("xsd.string", "xsd.anyURI"):
                encoding_sets = [trim_outliers(*s, time_axis=0)
                                 for s in encoding_sets]
            else:
                logger.warning("Outlier trimming unsupported for %s", datatype)

        embeddings.append([datatype, encoding_sets])

    return embeddings, modules_config, optimizer_config, embeddings_width


# ---------------------------------------------------------------------------
# weight-sharing merges (reference: graph_features.py:293-525)
# ---------------------------------------------------------------------------

def _unique_nodes(encoding_sets):
    node_idx = np.concatenate([idx for _, idx, _ in encoding_sets])
    uniq, counts = np.unique(node_idx, return_counts=True)
    return uniq, counts


def merge_continuous_sets(encoding_sets: List) -> List:
    """Dense ``(M, C)`` sets → one set; duplicate nodes averaged
    (reference: graph_features.py:420-474)."""
    if len(encoding_sets) <= 1:
        return encoding_sets

    uniq, counts = _unique_nodes(encoding_sets)
    N = uniq.shape[0]
    M = max(enc.shape[1] for enc, _, _ in encoding_sets)

    merged = np.zeros((N, M), dtype=np.float32)
    totals = np.zeros(N, dtype=np.int32)
    lengths = np.zeros(N, dtype=np.float32)

    for enc, node_index, seq_length in encoding_sets:
        j = np.searchsorted(uniq, np.asarray(node_index))
        np.add.at(merged[:, :enc.shape[1]], j, np.asarray(enc))
        np.add.at(totals, j, 1)
        np.maximum.at(lengths, j, np.asarray(seq_length, np.float32))

    merged /= np.maximum(totals, 1)[:, None]
    return [[merged, uniq.astype(np.int32), lengths]]


def merge_discrete_sets(encoding_sets: List) -> List:
    """Ragged token sets → one set; duplicate nodes merged by column-wise
    majority vote over the padded matrix (reference:
    graph_features.py:353-418). Ties pick the smallest token, matching
    ``np.unique`` + ``argmax`` order."""
    if len(encoding_sets) <= 1:
        return encoding_sets

    uniq, counts = _unique_nodes(encoding_sets)
    N = uniq.shape[0]

    values: List[List[np.ndarray]] = [[] for _ in range(N)]
    lengths = np.zeros(N, dtype=np.int32)
    for enc, node_index, seq_length in encoding_sets:
        js = np.searchsorted(uniq, np.asarray(node_index))
        np.maximum.at(lengths, js, np.asarray(seq_length, np.int32))
        for i, j in enumerate(js):
            values[j].append(enc[i])

    merged = np.empty(N, dtype=object)
    singles = np.flatnonzero(counts == 1)
    for j in singles:
        merged[j] = values[j][0]
    for j in np.flatnonzero(counts > 1):
        encs = values[j]
        longest = max(len(e) for e in encs)
        a = -np.ones((len(encs), longest), dtype=np.int64)
        for k, e in enumerate(encs):
            a[k, :len(e)] = e
        voted = []
        for col in range(longest):
            vals, cnts = np.unique(a[a[:, col] >= 0, col],
                                   return_counts=True)
            voted.append(vals[np.argmax(cnts)])
        merged[j] = np.asarray(voted, dtype=np.int32)
        lengths[j] = longest

    return [[merged, uniq.astype(np.int32), lengths]]


def merge_geometry_sets(encoding_sets: List) -> List:
    """Ragged ``(9, L)`` geometry sets → one set; duplicates averaged after
    padding to the maximum shape (reference: graph_features.py:293-351)."""
    if len(encoding_sets) <= 1:
        return encoding_sets

    uniq, counts = _unique_nodes(encoding_sets)
    N = uniq.shape[0]

    values: List[List[np.ndarray]] = [[] for _ in range(N)]
    for enc, node_index, _ in encoding_sets:
        js = np.searchsorted(uniq, np.asarray(node_index))
        for i, j in enumerate(js):
            values[j].append(enc[i])

    merged = np.empty(N, dtype=object)
    lengths = np.zeros(N, dtype=np.int32)
    for j in np.flatnonzero(counts == 1):
        merged[j] = values[j][0]
        lengths[j] = values[j][0].shape[1]
    for j in np.flatnonzero(counts > 1):
        encs = values[j]
        shape = tuple(map(max, zip(*(e.shape for e in encs))))
        a = np.zeros(shape, dtype=np.float32)
        for e in encs:
            a[:e.shape[0], :e.shape[1]] += e
        a /= len(encs)
        merged[j] = a
        lengths[j] = shape[-1]

    return [[merged, uniq.astype(np.int32), lengths]]


def merge_image_sets(encoding_sets: List) -> List:
    """Dense ``(M, C, H, W)`` image sets → one set; duplicates averaged
    (reference: graph_features.py:476-525)."""
    if len(encoding_sets) <= 1:
        return encoding_sets

    uniq, counts = _unique_nodes(encoding_sets)
    N = uniq.shape[0]
    pos = {v: i for i, v in enumerate(uniq)}
    c, H, W = encoding_sets[0][0].shape[1:]

    merged = np.zeros((N, c, H, W), dtype=np.float32)
    totals = np.zeros(N, dtype=np.int32)
    for enc, node_index, _ in encoding_sets:
        j = np.searchsorted(uniq, np.asarray(node_index))
        np.add.at(merged, j, np.asarray(enc, dtype=np.float32))
        np.add.at(totals, j, 1)
    merged /= np.maximum(totals, 1)[:, None, None, None]

    return [[merged.astype(np.uint8), uniq.astype(np.int32),
             -np.ones(N, dtype=np.float32)]]


# ---------------------------------------------------------------------------
# noise & outliers (reference: graph_features.py:560-668)
# ---------------------------------------------------------------------------

def add_noise_(encoding_sets: List, p_noise: float,
               multiplier: float = 0.01) -> None:
    """In-place Bernoulli(p) * U(-1, 1) * multiplier noise."""
    if multiplier is None or multiplier < 0:
        multiplier = 0.01
    for mset in encoding_sets:
        encodings = mset[0]
        if encodings.dtype == np.dtype("O"):  # ragged
            for i in range(len(encodings)):
                shape = encodings[i].shape
                b = np.random.binomial(1, p_noise, size=shape)
                noise = b * (2 * np.random.random(shape) - 1)
                encodings[i] = encodings[i] + multiplier * noise
        else:
            shape = encodings.shape
            b = np.random.binomial(1, p_noise, size=shape)
            noise = b * (2 * np.random.random(shape) - 1)
            mset[0] = (encodings.astype(np.float32)
                       + (multiplier * noise).astype(np.float32))


def _iqr_threshold(seq_lengths) -> Tuple[float, float, float]:
    q25 = np.quantile(seq_lengths, 0.25)
    q75 = np.quantile(seq_lengths, 0.75)
    iqr = q75 - q25
    return q25, q75, iqr


def trim_outliers(sequences, node_idx, seq_lengths, time_axis: int = 0):
    """Trim sequences longer than ``q75 + 1.5 IQR``
    (reference: graph_features.py:579-636). ``time_axis`` is the axis holding
    time: 0 for token arrays, 1 for ``(9, L)`` geometries. Geometry trimming
    keeps the first ``threshold`` points; token trimming keeps
    ``threshold - 1`` plus the final token (the reference keeps the last
    token — typically [SEP])."""
    q25, q75, iqr = _iqr_threshold(seq_lengths)
    if iqr <= 0.0:
        return [sequences, node_idx, seq_lengths]
    threshold = int(q75 + iqr * 1.5)

    n = len(sequences)
    trimmed = np.empty(n, dtype=object)
    new_lengths = np.zeros(n, dtype=np.int32)
    for i in range(n):
        seq = sequences[i]
        if seq.shape[time_axis] > threshold:
            if time_axis == 0:
                seq = np.concatenate([seq[:threshold - 1], seq[-1:]])
            else:
                seq = seq[:, :threshold]
        trimmed[i] = seq
        new_lengths[i] = seq.shape[time_axis]

    return [trimmed, node_idx, new_lengths]


def remove_outliers(sequences, node_idx, seq_lengths):
    """Drop sequences outside ``[q25 - 1.5 IQR, q75 + 1.5 IQR]``
    (reference: graph_features.py:638-668)."""
    q25, q75, iqr = _iqr_threshold(seq_lengths)
    if iqr <= 0.0:
        return [sequences, node_idx, seq_lengths]
    cut_off = iqr * 1.5

    keep = [i for i, length in enumerate(seq_lengths)
            if q25 - cut_off <= length <= q75 + cut_off]
    dropped = len(sequences) - len(keep)
    if dropped > 0:
        logger.debug("Filtered %d outliers (%d remain)", dropped, len(keep))

    kept_seq = np.empty(len(keep), dtype=object)
    for j, i in enumerate(keep):
        kept_seq[j] = sequences[i]
    return [kept_seq,
            np.asarray([node_idx[i] for i in keep], dtype=np.int32),
            np.asarray([seq_lengths[i] for i in keep], dtype=np.int32)]


# ---------------------------------------------------------------------------
# densification: pad ragged sets once per run
# ---------------------------------------------------------------------------

def densify(X: List, pad_symbols: Optional[Dict[str, int]] = None,
            min_lengths: Optional[Dict[str, int]] = None) -> List:
    """Pad every ragged encoding set to dense arrays with static shapes.

    Replaces the reference's per-batch ``Batch.pad_``/``to_dense_``
    (reference: mrgcn/data/batch.py:25-70): padding happens once per run,
    as in the JAX package, so both packages feed their encoders the same
    arrays.

    ``pad_symbols`` maps datatype -> token pad id (tokens); ``min_lengths``
    maps datatype -> minimum padded length (e.g. TCNN minimal input length).
    """
    pad_symbols = pad_symbols or {}
    min_lengths = min_lengths or {}

    out = [X[0]]
    for datatype, encoding_sets in X[1:]:
        dense_sets = []
        for encodings, node_idx, seq_lengths in encoding_sets:
            if len(encodings) == 0:
                dense_sets.append([encodings, node_idx, seq_lengths])
                continue
            # one feature row per node per encoding set — the gather-only
            # placement (ops/placement.place_rows) relies on it; duplicate
            # assignment would be a silent data bug under torch semantics
            # too (last-write-wins, nondeterministic)
            idx_arr = np.asarray(node_idx)
            valid = idx_arr[idx_arr >= 0]
            if len(np.unique(valid)) != len(valid):
                raise ValueError(
                    f"{datatype}: duplicate node indices within one "
                    "encoding set — merge features upstream")
            if encodings.dtype != np.dtype("O"):
                dense_sets.append([encodings, node_idx,
                                   np.asarray(seq_lengths)])
                continue

            sample = encodings[0]
            max_len = max(int(e.shape[-1] if e.ndim > 1 else e.shape[0])
                          for e in encodings)
            max_len = max(max_len, min_lengths.get(datatype, 0))
            n = len(encodings)
            if sample.ndim == 1:  # token sequences
                pad = pad_symbols.get(datatype, 0)
                dense = np.full((n, max_len), pad, dtype=np.int32)
                for i, e in enumerate(encodings):
                    dense[i, :len(e)] = e
            else:  # (C, L) geometries
                C = sample.shape[0]
                dense = np.zeros((n, C, max_len), dtype=np.float32)
                for i, e in enumerate(encodings):
                    dense[i, :, :e.shape[1]] = e
            dense_sets.append([dense, node_idx, np.asarray(seq_lengths)])
        out.append([datatype, dense_sets])
    return out
