"""The port imports neither JAX, the JAX package nor transformers.

Every ``.py`` of ``mrgcn_tpu_torch/`` and ``chip_smoke.py`` is parsed with
``ast`` and must hold no ``import jax``, ``import mrgcn_tpu``, ``import
transformers``, ``import tokenizers`` or ``from mrgcn_tpu... import`` (at
any depth: inside functions too; the machine with the card has neither JAX
nor transformers); and the CLI module imports, a link-prediction run trains,
a mini-batch NC run trains one epoch (the host batch sampler and its
native library included), a full-batch NC run over all five modalities
(the convolutional encoders) trains one epoch, and so does one over
strings and images on the pretrained backbones (a tiny DistilBERT in a
hub cache and a MobileNetV2 checkpoint, written by the port), and one
over strings on a tiny RoBERTa (its byte-level BPE gives the pad id), in a
subprocess in which these names are blocked (``sys.modules[name] =
None``); and one over strings on a tiny ALBERT whose ids the port's
Unigram tokenizer gives from generated strings (its ``tokenizer.json``
written by the port). In another such subprocess the port's ``mkdataset`` CLI builds an
artifact from N-Quads and gzipped N-Triples, its strings tokenized by the
port's WordPiece from a ``vocab.txt`` snapshot, and ``run`` trains it.
The ranks of a mesh world (``parallel.mesh.launch``, spawned processes)
train link prediction and report that none of these names is among their
modules.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
             "tokenizers", "msgpack")
SOURCES = sorted((REPO / "mrgcn_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_the_walk_finds_the_port():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"mrgcn_tpu_torch/run.py", "mrgcn_tpu_torch/config.py",
            "mrgcn_tpu_torch/data/artifact.py",
            "mrgcn_tpu_torch/encodings/xsd/string.py",
            "mrgcn_tpu_torch/tasks/link_prediction.py",
            "mrgcn_tpu_torch/data/batching.py",
            "mrgcn_tpu_torch/data/native.py",
            "mrgcn_tpu_torch/ops/compose_kernels.py",
            "mrgcn_tpu_torch/models/distilbert.py",
            "mrgcn_tpu_torch/models/bert.py",
            "mrgcn_tpu_torch/encodings/xsd/bpe.py",
            "mrgcn_tpu_torch/encodings/xsd/unigram.py",
            "mrgcn_tpu_torch/encodings/xsd/charsmap.py",
            "mrgcn_tpu_torch/encodings/xsd/graphemes.py",
            "mrgcn_tpu_torch/models/albert.py",
            "mrgcn_tpu_torch/models/bloom.py",
            "mrgcn_tpu_torch/models/mobilenet.py",
            "mrgcn_tpu_torch/models/pretrained.py",
            "mrgcn_tpu_torch/utils/flax_msgpack.py",
            "mrgcn_tpu_torch/utils/hf.py",
            "mrgcn_tpu_torch/mkdataset.py",
            "mrgcn_tpu_torch/data/kg.py",
            "mrgcn_tpu_torch/encodings/xsd/wordpiece.py",
            "mrgcn_tpu_torch/encodings/ogc/wkt.py",
            "mrgcn_tpu_torch/encodings/blob/image.py",
            "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_source_imports_no_jax_and_no_jax_package(path):
    bad = [(line, module) for line, module in imported_modules(path)
           if module.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
             "tokenizers", "msgpack"):
    sys.modules[name] = None
import os, tempfile
os.environ["MRGCN_PLATFORM"] = "cpu"
import chip_smoke                       # importable without a card
import mrgcn_tpu_torch
from mrgcn_tpu_torch import run
from mrgcn_tpu_torch.tasks.synthetic import save_lp_artifact
assert mrgcn_tpu_torch.__version__[0].isdigit()
with tempfile.TemporaryDirectory() as tmp:
    art = os.path.join(tmp, "lp.npz")
    save_lp_artifact(art, num_nodes=60, num_props=3, num_train=200,
                     num_valid=30, num_test=30)
    cfg = os.path.join(tmp, "lp.toml")
    with open(cfg, "w") as f:
        f.write('name = "LP"\\n[task]\\ntype = "link prediction"\\n'
                'seed = 0\\n[model]\\nepoch = 1\\nnum_bases = 2\\n'
                '[[model.layers]]\\nhidden_nodes = 8\\n'
                '[[model.layers]]\\ntype = "mrgcn"\\n')
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    assert len(res.ranks["raw"]) == 60

    # one mini-batch NC epoch: 40 labels in batches of 16
    import numpy as np
    from mrgcn_tpu_torch.data import batching, native
    from mrgcn_tpu_torch.ops import compose_kernels
    from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
    rng = np.random.default_rng(0)
    n, R, E = 80, 5, 400
    art = os.path.join(tmp, "nc.npz")
    save_nc_artifact(art, n, R, rng.integers(0, n, E), rng.integers(0, n, E),
                     rng.integers(0, R, E), rng.random(E).astype("float32"),
                     rng.choice(n, 40, replace=False),
                     rng.integers(0, 3, 40), 3, num_eval=10)
    cfg = os.path.join(tmp, "nc.toml")
    with open(cfg, "w") as f:
        f.write('name = "NC"\\n[task]\\ntype = "node classification"\\n'
                'seed = 0\\nbatchsize = 16\\nneighbor_fanout = 4\\n'
                '[model]\\nepoch = 1\\nnum_bases = 2\\n'
                '[[model.layers]]\\nhidden_nodes = 8\\n'
                '[[model.layers]]\\ntype = "mrgcn"\\n')
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    assert res.batches["train"] == 3 and len(res.history) == 1
    lib = native.get_sampler_lib()
    assert lib is None or "mrgcn_tpu_torch" in native._SAMPLER_SO

    # one full-batch NC epoch over all five modalities (TCNN, ImageCNN)
    from pathlib import Path
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    art = os.path.join(tmp, "am.npz")
    save_nc_artifact(art, n, R, rng.integers(0, n, E), rng.integers(0, n, E),
                     rng.integers(0, R, E), rng.random(E).astype("float32"),
                     rng.choice(n, 40, replace=False),
                     rng.integers(0, 3, 40), 3, num_eval=10,
                     F=multimodal_features(n, num_numeric=20, num_years=10,
                                           num_strings=10, max_len=8,
                                           num_geometries=10, num_images=6,
                                           image_size=32))
    cfg = os.path.join(tmp, "am.toml")
    chip_smoke.write_config(Path(cfg), 1, 2, 8,
                            features=chip_smoke.ALLMODAL)
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    assert res.model.modality_dim == 165 and len(res.history) == 1

    # one epoch on the pretrained backbones: strings and images
    from mrgcn_tpu_torch.models.pretrained import (PretrainedImageEncoder,
                                                   PretrainedTextEncoder)
    from mrgcn_tpu_torch.tasks import synthetic
    tiny = dict(synthetic.DISTILBERT_MULTILINGUAL, dim=16, n_layers=1,
                n_heads=2, hidden_dim=32, vocab_size=1100,
                max_position_embeddings=16)
    os.environ["HF_HUB_CACHE"] = os.path.join(tmp, "hub")
    synthetic.save_text_backbone_snapshot(os.environ["HF_HUB_CACHE"],
                                          config=tiny)
    os.environ["MRGCN_VISION_WEIGHTS"] = os.path.join(tmp, "mnv2.pth")
    synthetic.save_mobilenet_checkpoint(os.environ["MRGCN_VISION_WEIGHTS"])
    art = os.path.join(tmp, "bb.npz")
    save_nc_artifact(art, n, R, rng.integers(0, n, E), rng.integers(0, n, E),
                     rng.integers(0, R, E), rng.random(E).astype("float32"),
                     rng.choice(n, 40, replace=False),
                     rng.integers(0, 3, 40), 3, num_eval=10,
                     F=multimodal_features(n, num_numeric=20, num_years=10,
                                           num_strings=10, max_len=8,
                                           num_images=6, image_size=32,
                                           wordpiece_vocab=1100))
    cfg = os.path.join(tmp, "bb.toml")
    chip_smoke.write_config(Path(cfg), 1, 2, 8,
                            features=("xsd.numeric", "xsd.gYear",
                                      "xsd.string", "blob.image"),
                            backbones=True)
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    assert isinstance(res.model.xsd_string_0, PretrainedTextEncoder)
    assert isinstance(res.model.blob_image_0, PretrainedImageEncoder)
    assert len(res.history) == 1

    # and over strings on a tiny RoBERTa, its byte-level BPE giving the
    # pad id 1
    from mrgcn_tpu_torch.models.bert import Bert
    tiny = dict(synthetic.ROBERTA_BASE, hidden_size=16,
                num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, vocab_size=1100)
    synthetic.save_text_backbone_snapshot(os.environ["HF_HUB_CACHE"],
                                          "roberta-base", config=tiny)
    art = os.path.join(tmp, "rb.npz")
    save_nc_artifact(art, n, R, rng.integers(0, n, E), rng.integers(0, n, E),
                     rng.integers(0, R, E), rng.random(E).astype("float32"),
                     rng.choice(n, 40, replace=False),
                     rng.integers(0, 3, 40), 3, num_eval=10,
                     F=multimodal_features(n, num_numeric=20, num_years=10,
                                           num_strings=10, max_len=8,
                                           bpe_vocab=1100))
    cfg = os.path.join(tmp, "rb.toml")
    chip_smoke.write_config(Path(cfg), 1, 2, 8, features=chip_smoke.MULTIMODAL,
                            backbones=True,
                            text_model=("roberta-base", "<pad>"))
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    text = res.model.xsd_string_0
    assert isinstance(text.backbone, Bert) and text.pad_id == 1
    assert len(res.history) == 1

    # and on a tiny ALBERT, its strings tokenized by the port's Unigram
    from mrgcn_tpu_torch.encodings.xsd.unigram import UnigramTokenizer
    from mrgcn_tpu_torch.encodings.xsd.string import load_tokenizer
    from mrgcn_tpu_torch.models.albert import Albert
    tiny = dict(synthetic.ALBERT_XXLARGE, embedding_size=8, hidden_size=16,
                num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, vocab_size=600)
    synthetic.save_text_backbone_snapshot(os.environ["HF_HUB_CACHE"],
                                          "albert-base-v2", config=tiny)
    feature = {"datatype": "xsd.string", "tokenizer": {
        "config": ["hf", "tokenizer", "albert-base-v2"],
        "pad_token": "<pad>"}}
    assert isinstance(load_tokenizer(feature), UnigramTokenizer)
    ids, _, lengths = synthetic.tokenized_strings(
        feature, synthetic.text_literals(10, max_words=6))
    art = os.path.join(tmp, "al.npz")
    save_nc_artifact(art, n, R, rng.integers(0, n, E), rng.integers(0, n, E),
                     rng.integers(0, R, E), rng.random(E).astype("float32"),
                     rng.choice(n, 40, replace=False),
                     rng.integers(0, 3, 40), 3, num_eval=10,
                     F=multimodal_features(n, num_numeric=20, num_years=10,
                                           token_strings=(ids, lengths)))
    cfg = os.path.join(tmp, "al.toml")
    chip_smoke.write_config(Path(cfg), 1, 2, 8, features=chip_smoke.MULTIMODAL,
                            backbones=True,
                            text_model=("albert-base-v2", "<pad>"))
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    text = res.model.xsd_string_0
    assert isinstance(text.backbone, Albert) and text.pad_id == 0
    assert len(res.history) == 1

    # and on a tiny BLOOM, its strings tokenized by the port's BLOOM BPE
    from mrgcn_tpu_torch.models.bloom import Bloom
    tiny = dict(synthetic.BLOOM_560M, n_embed=16, n_layer=1,
                num_attention_heads=2, vocab_size=600)
    synthetic.save_text_backbone_snapshot(os.environ["HF_HUB_CACHE"],
                                          "bigscience/bloom-560m",
                                          config=tiny)
    feature = {"datatype": "xsd.string", "tokenizer": {
        "config": ["hf", "tokenizer", "bigscience/bloom-560m"],
        "pad_token": "<pad>"}}
    ids, _, lengths = synthetic.tokenized_strings(
        feature, synthetic.text_literals(10, max_words=6))
    art = os.path.join(tmp, "bl.npz")
    save_nc_artifact(art, n, R, rng.integers(0, n, E), rng.integers(0, n, E),
                     rng.integers(0, R, E), rng.random(E).astype("float32"),
                     rng.choice(n, 40, replace=False),
                     rng.integers(0, 3, 40), 3, num_eval=10,
                     F=multimodal_features(n, num_numeric=20, num_years=10,
                                           token_strings=(ids, lengths)))
    cfg = os.path.join(tmp, "bl.toml")
    chip_smoke.write_config(Path(cfg), 1, 2, 8, features=chip_smoke.MULTIMODAL,
                            backbones=True,
                            text_model=("bigscience/bloom-560m", "<pad>"))
    res = run.run_cli(["-c", cfg, "-i", art, "-o", tmp, "--dry_run"])
    text = res.model.xsd_string_0
    assert isinstance(text.backbone, Bloom) and text.pad_id == 3
    assert len(res.history) == 1
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
           "tokenizers", "msgpack")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("ok-no-jax")
"""


def test_mesh_ranks_import_no_jax(tmp_path, monkeypatch):
    """A world's ranks (spawned processes of the port's own worker) train
    link prediction under a mesh without importing any of these names."""
    from mrgcn_tpu_torch.config import apply_defaults
    from mrgcn_tpu_torch.parallel import mesh as pmesh
    from mrgcn_tpu_torch.parallel import parity
    from mrgcn_tpu_torch.tasks.synthetic import save_lp_artifact
    monkeypatch.setenv("MRGCN_PLATFORM", "cpu")
    monkeypatch.delenv("MRGCN_MESH", raising=False)
    art = str(tmp_path / "lp.npz")
    save_lp_artifact(art, num_nodes=60, num_props=3, num_train=200,
                     num_valid=30, num_test=30)
    config = apply_defaults({
        "name": "LP", "graph": {},
        "task": {"type": "link prediction", "seed": 0, "mesh": "2"},
        "model": {"epoch": 1, "num_bases": 2,
                  "layers": [{"hidden_nodes": 8}, {"type": "mrgcn"}]}})
    jobs = [{"work": "train", "task": "lp", "artifact": art,
             "config": config},
            {"work": "loaded", "mesh": "2", "names": FORBIDDEN}]
    for rank in pmesh.launch(parity.rank_worker, 2, "gloo", ["cpu"] * 2,
                             args=(jobs,)):
        assert len(rank[0]["history"]) == 1
        assert rank[1] == []


def test_port_runs_with_jax_and_the_jax_package_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok-no-jax")


BLOCKED_ETL = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
             "tokenizers", "msgpack"):
    sys.modules[name] = None
import gzip, json, os, tempfile
from pathlib import Path
os.environ["MRGCN_PLATFORM"] = "cpu"
from tests import synth
from mrgcn_tpu_torch import mkdataset, run
with tempfile.TemporaryDirectory() as tmp:
    paths = synth.make_nc_dataset(os.path.join(tmp, "data"),
                                  num_entities=30, with_strings=True)
    quads = os.path.join(tmp, "data", "context.nq")
    with gzip.open(paths["context"], "rt") as f, open(quads, "w") as g:
        for line in f:
            g.write(line.rstrip().rstrip(".") + " <http://example.org/g> .\\n")
    paths["context"] = quads
    vocab = os.path.join(tmp, "wordpiece")
    os.mkdir(vocab)
    Path(vocab, "vocab.txt").write_text("\\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "alpha", "beta",
         "common", "text", "##a"]) + "\\n")
    Path(vocab, "config.json").write_text(json.dumps(
        {"model_type": "distilbert"}))
    config = synth.nc_config(paths, with_strings=True, epochs=1)
    cfg = os.path.join(tmp, "etl.toml")
    lines = [f'name = "{config["name"]}"', "[graph]"]
    lines += [f'{k} = "{paths[k]}"' for k in ("context", "train", "valid",
                                             "test")]
    lines += ["[graph.structural]", "include_inverse_properties = true",
              "exclude_properties = []", "separate_literals = false",
              "multiprocessing = false"]
    for feat in config["graph"]["features"]:
        lines += ["[[graph.features]]"] + [
            f"{k} = {json.dumps(v)}" for k, v in feat.items()]
        if feat["datatype"] == "xsd.string":
            lines += [f"tokenizer.config = {json.dumps(['hf', 'tokenizer', vocab])}",
                      'tokenizer.pad_token = "[PAD]"']
    lines += ["[task]", 'type = "node classification"',
              'target_property = "http://example.org/hasClass"',
              'target_property_inv = ""', "seed = 1",
              "[model]", "epoch = 1", "num_bases = 2",
              "[[model.layers]]", "hidden_nodes = 8",
              "[[model.layers]]", 'type = "mrgcn"']
    Path(cfg).write_text("\\n".join(lines) + "\\n")
    assert mkdataset.main(["-c", cfg, "-o", tmp]) == 0
    art = next(p for p in os.listdir(tmp) if p.endswith(".npz"))
    from mrgcn_tpu_torch.data import artifact
    F = artifact.load(os.path.join(tmp, art)).F
    ids = {int(i) for enc, _, _ in F["xsd.string"] for s in enc for i in s}
    assert ids <= set(range(10)) and {2, 3, 5, 7, 8} <= ids, ids
    res = run.run_cli(["-c", cfg, "-i", os.path.join(tmp, art), "-o", tmp,
                       "--dry_run"])
    assert len(res.history) == 1
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
           "tokenizers", "msgpack")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("ok-etl-no-jax")
"""


def test_port_mkdataset_runs_with_jax_and_transformers_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_ETL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok-etl-no-jax")
