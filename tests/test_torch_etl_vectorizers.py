"""The port's structure build and per-datatype vectorizers against the JAX
package's.

One graph holds every datatype the vectorizers read (``tests/prestage``'s
literals for the nine configurable datatypes, drawn from a seed) plus the
edge cases of each family: numbers of other XSD numeric types and one that
does not parse, language-tagged untyped strings (they count as
``xsd:string``), a gYear and an integer whose lexical forms tie, years of
one and two digits (dropped), dates with time zones, a polygon with a hole,
points, a CRS prefix and an unparseable geometry (the point is its
predicate's only geometry: ``GeomScaler`` divides by a zero spread, NaN
in both packages, compared bit for bit), a grayscale and a non-square
image and a broken one. Both packages build the structure
(``structure.generate``) and the features (``features.construct_features``)
from the same knowledge graph, with ``separate_literals`` false and true,
and every array must be equal: integers exactly, floats bit for bit (the
same float32 and float64 operations run in the same order on both sides,
so no tolerance is needed).
"""

import base64
import io
import random

import numpy as np
import pytest

from mrgcn_tpu.data.kg import KnowledgeGraph as JKG
from mrgcn_tpu.encodings import features as jfeatures
from mrgcn_tpu.encodings import structure as jstructure
from mrgcn_tpu_torch.data.kg import KnowledgeGraph as TKG
from mrgcn_tpu_torch.encodings import features as tfeatures
from mrgcn_tpu_torch.encodings import structure as tstructure
from mrgcn_tpu_torch.encodings.xsd_hierarchy import _PARENT

from tests import prestage
from tests.synth import _lit

EX = prestage.EX
DATATYPES = ("xsd.numeric", "xsd.boolean", "xsd.string", "xsd.anyURI",
             "xsd.date", "xsd.dateTime", "xsd.gYear", "ogc.wktLiteral",
             "blob.image")
WKT = prestage.OGC + "wktLiteral"


def _image(mode, size, seed):
    from PIL import Image
    rng = np.random.default_rng(seed)
    shape = size[::-1] + ((3,) if mode == "RGB" else ())
    img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def edge_case_lines():
    ent = f"<{EX}edge>"
    extra = [
        _lit(7, "int"), _lit(-3, "nonPositiveInteger"), _lit("1e3", "float"),
        _lit("not a number", "double"), _lit("2000", "gYear"),
        _lit("2000", "integer"), _lit("7", "gYear"), _lit("-0044", "gYear"),
        _lit("1999-12-31Z", "date"), _lit("2001-02-03+01:00", "date"),
        _lit("1850-07-04T23:59:30.5Z", "dateTime"), _lit("0", "boolean"),
        _lit("1", "boolean"), _lit("TRUE", "boolean"),
        _lit("een tekst", lang="nl"), _lit("untyped, no language"),
        _lit("ook een tekst", "string"), _lit("http://x/y", "anyURI"),
        f'"POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0), (1 1, 2 1, 2 2, 1 1))"'
        f'^^<{WKT}>',
        f'"MULTIPOINT ((1 2), (3 4), (5 6))"^^<{WKT}>',
        f'"<http://www.opengis.net/def/crs/OGC/1.3/CRS84> POINT(4.9 52.3)"'
        f'^^<{WKT}>',
        f'"CIRCLE (1 2)"^^<{WKT}>',
        f'"{_image("L", (12, 9), 1)}"^^<{prestage.KGB}base64Image>',
        f'"{_image("RGB", (7, 15), 2)}"^^<{prestage.KGB}base64Image>',
        f'"bm90IGFuIGltYWdl"^^<{prestage.KGB}base64Image>',
    ]
    return [f"{ent} <{EX}hasEdge{i % 3}> {o} ." for i, o in enumerate(extra)]


@pytest.fixture(scope="module")
def graph_path(tmp_path_factory):
    rng = random.Random(11)
    lines = []
    for i in range(24):
        e = f"<{EX}e{i}>"
        for dt in DATATYPES:
            lines.append(f"{e} <{EX}has{dt.replace('.', '_')}> "
                         f"{prestage._literal_for(dt, i % 2, rng)} .")
            if i % 3 == 0:   # a second predicate per datatype
                lines.append(f"{e} <{EX}also{dt.replace('.', '_')}> "
                             f"{prestage._literal_for(dt, 1, rng)} .")
        lines.append(f"{e} <{EX}linksTo> <{EX}e{rng.randrange(24)}> .")
    lines += edge_case_lines()
    path = tmp_path_factory.mktemp("vec") / "graph.nt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def feature_configs():
    out = []
    for dt in DATATYPES:
        cfg = {"datatype": dt, "include": True}
        if dt == "blob.image":
            cfg["transform"] = {"mode": "RGB", "interpolationMode":
                                "BILINEAR", "resizeSize": 10,
                                "centerCrop": 8}
        out.append(cfg)
    # a concrete XSD type resolves to its family through the hierarchy
    out.append({"datatype": "xsd.int", "include": True})
    return out


def config(separate_literals):
    return {"graph": {"structural": {
        "separate_literals": separate_literals,
        "include_inverse_properties": True, "exclude_properties": [],
        "multiprocessing": False}}}


@pytest.fixture(scope="module", params=[False, True],
                ids=["shared_literals", "separate_literals"])
def built(request, graph_path):
    out = {}
    for name, KG, structure, features in (
            ("jax", JKG, jstructure, jfeatures),
            ("port", TKG, tstructure, tfeatures)):
        kg = KG(graph_path)
        A, nodes_map, props = structure.generate(kg,
                                                 config(request.param))
        F = features.construct_features(nodes_map, kg, feature_configs(),
                                        request.param)
        out[name] = (A, list(map(str, nodes_map)), list(map(str, props)), F)
    return out


def assert_same(got, want, where):
    assert type(got) is type(want) or (
        isinstance(got, np.ndarray) and isinstance(want, np.ndarray)), where
    if isinstance(want, np.ndarray) and want.dtype == object:
        assert got.dtype == object and got.shape == want.shape, where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def test_structure_matches_the_jax_package(built):
    (jA, jnodes, jprops, _), (tA, tnodes, tprops, _) = built["jax"], \
        built["port"]
    assert tnodes == jnodes and tprops == jprops
    assert (tA.num_nodes, tA.num_relations) == (jA.num_nodes,
                                                jA.num_relations)
    for name in ("src", "dst", "rel", "norm"):
        assert_same(getattr(tA, name), getattr(jA, name), name)


@pytest.mark.parametrize("datatype", DATATYPES + ("xsd.int",))
def test_vectorizer_matches_the_jax_package(built, datatype):
    jF, tF = built["jax"][3], built["port"][3]
    assert sorted(tF) == sorted(jF)
    assert datatype in jF
    assert_same(tF[datatype], jF[datatype], datatype)


def test_feature_module_resolves_as_the_jax_package():
    from mrgcn_tpu.encodings.xsd_hierarchy import XSDHierarchy as JH
    from mrgcn_tpu_torch.encodings.xsd_hierarchy import XSDHierarchy as TH
    names = [f"xsd.{t}" for t in _PARENT] + list(DATATYPES) + \
        ["ogc.other", "xsd.unknown", "blob.audio"]
    got = [tfeatures.feature_module(TH(), n) for n in names]
    assert got == [jfeatures.feature_module(JH(), n) for n in names]
    assert got.count("xsd.numeric") == 18 and None in got
