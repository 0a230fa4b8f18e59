"""XSD datatype hierarchy with the synthetic ``numeric`` supertype.

The port's copy of :mod:`mrgcn_tpu.encodings.xsd_hierarchy`.

Functional re-design of reference: mrgcn/encodings/xsd/xsd_hierarchy.py —
a flat parent table instead of a node-object tree (also avoids the
shared-mutable-default defect at xsd_hierarchy.py:200-203). The synthetic
``numeric`` type covers decimal/double/float and, transitively, all
integer types (reference: xsd_hierarchy.py:166-175), which is what lets 16
concrete numeric XSD types share one encoder.
"""

from __future__ import annotations

from typing import Dict, Optional

# child -> parent. Root is "anyType" (parent None).
_PARENT: Dict[str, Optional[str]] = {
    "anyType": None,
    "anySimpleType": "anyType",
    "ENTITIES": "anyType",
    "IDREFS": "anyType",
    "NMTOKENS": "anyType",
    "anyAtomicType": "anySimpleType",

    "anyURI": "anyAtomicType",
    "base64Binary": "anyAtomicType",
    "boolean": "anyAtomicType",
    "date": "anyAtomicType",
    "dateTime": "anyAtomicType",
    "duration": "anyAtomicType",
    "gDay": "anyAtomicType",
    "gMonth": "anyAtomicType",
    "gMonthDay": "anyAtomicType",
    "gYear": "anyAtomicType",
    "gYearMonth": "anyAtomicType",
    "hexBinary": "anyAtomicType",
    "QName": "anyAtomicType",
    "time": "anyAtomicType",
    "numeric": "anyAtomicType",  # synthetic supertype

    "dateTimeStamp": "dateTime",

    # numerics — decimal/double/float hang off the synthetic supertype
    # (reference: xsd_hierarchy.py:173-175 reassigns their parent)
    "decimal": "numeric",
    "double": "numeric",
    "float": "numeric",
    "integer": "decimal",
    "long": "integer",
    "int": "long",
    "short": "int",
    "byte": "short",
    "nonNegativeInteger": "integer",
    "positiveInteger": "nonNegativeInteger",
    "unsignedLong": "nonNegativeInteger",
    "unsignedInt": "unsignedLong",
    "unsignedShort": "unsignedInt",
    "unsignedByte": "unsignedShort",
    "nonPositiveInteger": "integer",
    "negativeInteger": "nonPositiveInteger",

    "dayTimeDuration": "duration",
    "yearMonthDuration": "duration",

    # strings
    "string": "anyAtomicType",
    "normalizedString": "string",
    "token": "normalizedString",
    "language": "token",
    "Name": "token",
    "NMTOKEN": "token",
    "NCName": "Name",
    "ENTITY": "NCName",
    "ID": "NCName",
    "IDREF": "NCName",
}


class XSDHierarchy:
    """Subtype queries over the XSD datatype tree."""

    def __init__(self):
        self._parent = dict(_PARENT)

    def __contains__(self, name: str) -> bool:
        return name in self._parent

    def subtypeof(self, a: str, b: str) -> bool:
        """True iff ``b`` lies in the tree rooted at ``a`` (i.e. ``b`` is a
        subtype of ``a``), or ``a`` is ``b`` or the root
        (reference: xsd_hierarchy.py:181-193)."""
        if a not in self._parent or b not in self._parent:
            raise KeyError(f"unknown XSD type: {a if a not in self._parent else b}")
        if a == b or self._parent[a] is None:
            return True
        node: Optional[str] = b
        while node is not None:
            node = self._parent[node]
            if node == a:
                return True
        return False
