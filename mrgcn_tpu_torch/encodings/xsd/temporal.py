"""Temporal literal vectorizers: xsd:date, xsd:dateTime, xsd:gYear.

The port's copy of :mod:`mrgcn_tpu.encodings.xsd.temporal`.

Trigonometric circular encodings with per-predicate century normalisation,
exactly matching the reference layouts:

  * date     → C=10: [sign, century, decade sin/cos, year sin/cos,
                      month sin/cos, day sin/cos]
                (reference: mrgcn/encodings/xsd/date.py:33-43, 118)
  * dateTime → C=14: date-10 + hour sin/cos + minute sin/cos
                (reference: mrgcn/encodings/xsd/dateTime.py:44-56, 138-139)
  * gYear    → C=6:  [sign, century, decade sin/cos, year sin/cos]
                (reference: mrgcn/encodings/xsd/gYear.py:62, 118 — the
                docstring there claims C=4 but the code uses 6; code wins)

Column 1 (century, raw count of leading year digits) is min/max scaled to
[-1, 1] per predicate (reference: date.py:129-138).
"""

from __future__ import annotations

import logging
import re
from math import cos, pi, sin
from typing import Dict, List, Optional, Tuple

from mrgcn_tpu_torch.data.rdf import xsd
from mrgcn_tpu_torch.encodings.common import RelationwiseCollector, literal_nodes

logger = logging.getLogger(__name__)

# regex fragments (reference: date.py:12-19, dateTime.py:14-25, gYear.py:13-20)
_YEAR_FRAG = r"(?P<sign>-?)(?P<year>\d{1,4})"  # years -9999..9999
_MONTH_FRAG = r"(?P<month>\d{1,2})"
_DAY_FRAG = r"(?P<day>\d{1,2})"
_TZ_FRAG = r"(?P<timezone>Z|(?:\+|-)(?:(?:0\d|1[0-3]):[0-5]\d|14:00))?"
_TIME_FRAG = r"(?P<hour>\d{2}):(?P<minute>\d{2}):(?P<second>\d{2}(?:\.\d+)?)"

_RE_DATE = re.compile(f"{_YEAR_FRAG}-{_MONTH_FRAG}-{_DAY_FRAG}(?:{_TZ_FRAG})?")
_RE_DATETIME = re.compile(
    f"{_YEAR_FRAG}-{_MONTH_FRAG}-{_DAY_FRAG}T{_TIME_FRAG}{_TZ_FRAG}")
_RE_GYEAR = re.compile(f"{_YEAR_FRAG}{_TZ_FRAG}")
_RE_SEPARATE = re.compile(r"^(?P<century>\d{0,2}?)(?P<decade>\d?)(?P<year>\d)$")

_MINUTE_RAD = 2 * pi / 60
_HOUR_RAD = 2 * pi / 24
_DAY_RAD = 2 * pi / 31
_MONTH_RAD = 2 * pi / 12
_DECADE_RAD = 2 * pi / 10


def point(m: int, rad: float) -> Tuple[float, float]:
    """Place a cyclic quantity on the unit circle
    (reference: date.py:142-144)."""
    return sin(m * rad), cos(m * rad)


def _year_parts(m: "re.Match[str]") -> Tuple[float, int, Tuple[float, float],
                                             Tuple[float, float]]:
    sign = 1.0 if m.group("sign") == "" else -1.0
    sep = _RE_SEPARATE.match(m.group("year"))
    if sep is None:
        raise ValueError("unparseable year")
    # int('') raises for 1-2 digit years — the reference drops those too
    # (reference: gYear.py:92 int of an empty century group).
    century = int(sep.group("century"))
    decade = int(sep.group("decade"))
    year = int(sep.group("year"))
    return (sign, century, point(decade, _DECADE_RAD),
            point(year, _DECADE_RAD))


def _encode_date(value: str) -> List[float]:
    m = _RE_DATE.match(value)
    sign, c, (d1, d2), (y1, y2) = _year_parts(m)
    m1, m2 = point(int(m.group("month")), _MONTH_RAD)
    day1, day2 = point(int(m.group("day")), _DAY_RAD)
    return [sign, c, d1, d2, y1, y2, m1, m2, day1, day2]


def _encode_datetime(value: str) -> List[float]:
    m = _RE_DATETIME.match(value)
    sign, c, (d1, d2), (y1, y2) = _year_parts(m)
    m1, m2 = point(int(m.group("month")), _MONTH_RAD)
    day1, day2 = point(int(m.group("day")), _DAY_RAD)
    h1, h2 = point(int(m.group("hour")), _HOUR_RAD)
    min1, min2 = point(int(m.group("minute")), _MINUTE_RAD)
    return [sign, c, d1, d2, y1, y2, m1, m2, day1, day2, h1, h2, min1, min2]


def _encode_gyear(value: str) -> List[float]:
    m = _RE_GYEAR.match(value)
    sign, c, (d1, d2), (y1, y2) = _year_parts(m)
    return [sign, c, d1, d2, y1, y2]


_FAMILIES = {
    "xsd.date": (xsd("date"), 10, _encode_date),
    "xsd.dateTime": (xsd("dateTime"), 14, _encode_datetime),
    "xsd.gYear": (xsd("gYear"), 6, _encode_gyear),
}


def generate_features(nodes_map: Dict, node_predicate_map: Dict,
                      config: Dict) -> Optional[List]:
    name = config["datatype"]
    datatype_iri, C, encode = _FAMILIES[name]

    collector = RelationwiseCollector()
    failed = 0
    for node, i in literal_nodes(nodes_map, datatype_iri):
        try:
            vec = encode(str(node))
        except (AttributeError, TypeError, ValueError):
            failed += 1
            continue
        collector.add(node_predicate_map.get(node, ()), vec, i)

    logger.debug("Generated %d unique %s encodings (%d failed)",
                 len(collector), name, failed)
    return collector.finalize(normalize_col=1, seq_length_value=C)
