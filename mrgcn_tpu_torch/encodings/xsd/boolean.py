"""XSD boolean literal vectorizer.

The port's copy of :mod:`mrgcn_tpu.encodings.xsd.boolean`.

Parity with reference: mrgcn/encodings/xsd/boolean.py — ``true``/``1`` map to
+1.0 and ``false``/``0`` to -1.0 for maximum separation in the value space
(reference: boolean.py:50-64); no normalisation.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from mrgcn_tpu_torch.data.rdf import xsd
from mrgcn_tpu_torch.encodings.common import RelationwiseCollector, literal_nodes

logger = logging.getLogger(__name__)


def _parse(value: str) -> float:
    if value.isalpha():
        return 1.0 if value.lower() == "true" else -1.0
    if value.isdigit():
        return 1.0 if int(value) == 1 else -1.0
    return 1.0 if int(float(value)) == 1 else -1.0


def generate_features(nodes_map: Dict, node_predicate_map: Dict,
                      config: Dict) -> Optional[List]:
    collector = RelationwiseCollector()
    failed = 0
    for node, i in literal_nodes(nodes_map, xsd("boolean")):
        try:
            value = _parse(str(node))
        except (TypeError, ValueError):
            failed += 1
            continue
        collector.add(node_predicate_map.get(node, ()), [value], i)

    logger.debug("Generated %d unique boolean encodings (%d failed)",
                 len(collector), failed)
    return collector.finalize(seq_length_value=1)
