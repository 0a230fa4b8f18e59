"""XSD numeric literal vectorizer.

The port's copy of :mod:`mrgcn_tpu.encodings.xsd.numeric`.

Parity with reference: mrgcn/encodings/xsd/numeric.py — each numeric literal
becomes a single float (C=1), grouped per linking predicate and min/max
scaled to ``[-1, 1]`` per predicate (reference: numeric.py:149-157); parse
failures are counted and skipped (reference: numeric.py:114-119).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from mrgcn_tpu_torch.data.rdf import xsd
from mrgcn_tpu_torch.encodings.common import RelationwiseCollector, literal_nodes

logger = logging.getLogger(__name__)

# The 16 concrete numeric types sharing this encoder
# (reference: numeric.py:13-29).
XSD_NUMERICAL = {xsd(t) for t in (
    "double", "decimal", "float", "integer", "long", "int", "short", "byte",
    "nonNegativeInteger", "nonPositiveInteger", "unsignedLong", "unsignedInt",
    "unsignedShort", "unsignedByte", "negativeInteger", "positiveInteger")}


def generate_features(nodes_map: Dict, node_predicate_map: Dict,
                      config: Dict) -> Optional[List]:
    name = config["datatype"]
    if name == "xsd.numeric":
        datatypes = XSD_NUMERICAL
    else:
        local = name.split(".", 1)[1]
        datatypes = {xsd(local)}

    collector = RelationwiseCollector()
    failed = 0
    for node, i in literal_nodes(nodes_map, datatypes):
        try:
            value = float(str(node))
        except (TypeError, ValueError):
            failed += 1
            continue
        collector.add(node_predicate_map.get(node, ()), [value], i)

    logger.debug("Generated %d unique %s encodings (%d failed)",
                 len(collector), name, failed)
    return collector.finalize(normalize_col=0, seq_length_value=1)
