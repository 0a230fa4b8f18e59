"""Host-side dataset construction for both tasks (the mkdataset stage).

The port's copy of :mod:`mrgcn_tpu.tasks.build`. It imports no torch: the
ETL CLI (:mod:`mrgcn_tpu_torch.mkdataset`) is host code and never touches
the training machinery (as the reference's mkdataset;
reference: mrgcn/mkdataset.py:18-60).
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from mrgcn_tpu_torch.encodings.features import construct_features

logger = logging.getLogger(__name__)


def build_dataset_nc(kg, nodes_map, target_triples: Dict, config: Dict,
                     featureless: bool):
    """Returns ``(F, Y, sample_map, class_map)`` where ``Y[split]`` is an
    ``(m, 2)`` int32 array of (node index, class index) rows
    (reference: node_classification.py:312-327)."""
    Y, sample_map, class_map = mk_target_matrices(target_triples, nodes_map)
    if featureless:
        F = {}
    else:
        separate_literals = config["graph"]["structural"]["separate_literals"]
        F = construct_features(nodes_map, kg, config["graph"]["features"],
                               separate_literals)
    return F, Y, sample_map, class_map


def mk_target_matrices(target_triples: Dict, nodes_map: Dict):
    """Class labels from target triples; classes sorted for run-to-run
    stability (reference: node_classification.py:353-383)."""
    classes = {str(o) for split in target_triples.values()
               for _, _, o in split}
    class_map = sorted(classes)
    class_idx = {label: i for i, label in enumerate(class_map)}

    Y: Dict[str, np.ndarray] = {}
    sample_map: Dict[str, List[str]] = {}
    for split, triples in target_triples.items():
        try:
            # IRI/BNode are str subclasses: direct tuple sort is the same
            # lexicographic order as the keyed sort, without building 3
            # key strings per triple
            ordered = sorted(triples)
        except TypeError:  # literal objects in targets
            ordered = sorted(triples, key=lambda t: (str(t[0]), str(t[1]),
                                                     str(t[2])))
        rows = [(nodes_map[s], class_idx[str(o)]) for s, _, o in ordered]
        Y[split] = np.asarray(rows, dtype=np.int32).reshape(-1, 2)
        sample_map[split] = [str(s) for s, _, _ in ordered]
        logger.debug("Found %d instances (%s)", len(rows), split)
    return Y, sample_map, class_map


def build_dataset_lp(kg, nodes_map, config: Dict, featureless: bool):
    """Feature construction over the merged graph
    (reference: link_prediction.py:424-438)."""
    if featureless:
        return {}
    separate_literals = config["graph"]["structural"]["separate_literals"]
    return construct_features(nodes_map, kg, config["graph"]["features"],
                              separate_literals)
