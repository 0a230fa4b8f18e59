"""The port imports neither JAX, the JAX package nor transformers.

Every ``.py`` of ``mrgcn_tpu_torch/`` and ``chip_smoke.py`` is parsed with
``ast`` and must hold no ``import jax``, ``import mrgcn_tpu``, ``import
transformers`` or ``from mrgcn_tpu... import`` (at any depth: inside
functions too; the machine with the card has neither JAX nor
transformers); and the CLI module imports, a link-prediction run trains,
a mini-batch NC run trains one epoch (the host batch sampler and its
native library included), a full-batch NC run over all five modalities
(the convolutional encoders) trains one epoch, and so does one over
strings and images on the pretrained backbones (a tiny DistilBERT in a
hub cache and a MobileNetV2 checkpoint, written by the port), in a
subprocess in which these names are blocked (``sys.modules[name] =
None``).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
             "msgpack")
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
            "mrgcn_tpu_torch/models/mobilenet.py",
            "mrgcn_tpu_torch/models/pretrained.py",
            "mrgcn_tpu_torch/utils/flax_msgpack.py",
            "mrgcn_tpu_torch/utils/hf.py",
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
             "msgpack"):
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
    synthetic.save_distilbert_snapshot(os.environ["HF_HUB_CACHE"],
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
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "mrgcn_tpu", "transformers",
           "msgpack")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("ok-no-jax")
"""


def test_port_runs_with_jax_and_the_jax_package_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok-no-jax")
