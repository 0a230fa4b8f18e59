"""``mkdataset`` CLI of the PyTorch port: offline ETL — RDF graphs ->
dataset artifact (.npz).

The port's copy of :mod:`mrgcn_tpu.mkdataset`, with the same flags
(``-c/-o/-v/--dry_run``) and the same artifact: node classification reads
three target-triple splits plus a context graph (stripping inverse-target
edges); link prediction merges the three splits into one graph for
structure and features and stores each split as an ``(n, 3)`` index array
(reference: mrgcn/mkdataset.py:18-126). The graphs are N-Triples or
N-Quads, plain or gzipped. Host code: it imports no torch and touches no
device. Example::

    python -m mrgcn_tpu_torch.mkdataset -c cfg.toml -o out/ -v
    python -m mrgcn_tpu_torch.run -c cfg.toml -i out/<name><time>.npz
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
from time import perf_counter, time
from typing import Dict, Optional, Tuple

from mrgcn_tpu_torch.config import load_config
from mrgcn_tpu_torch.data import artifact
from mrgcn_tpu_torch.data.kg import KnowledgeGraph
from mrgcn_tpu_torch.data.utils import (is_readable, is_writable, strip_graph,
                                        triples_to_indices)
from mrgcn_tpu_torch.encodings import structure
from mrgcn_tpu_torch.tasks import build as dataset_build
from mrgcn_tpu_torch.utils.logging import init_logger

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _stage(timings: Optional[Dict[str, float]], name: str):
    """Add the seconds the block takes to ``timings[name]``."""
    t0 = perf_counter()
    try:
        yield
    finally:
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + perf_counter() - t0


def build(config: dict, timings: Optional[Dict[str, float]] = None):
    """``(A, F, Y, data, sample_map, class_map)`` of the config's graphs.
    ``timings``, where given, receives the host seconds of each stage:
    ``parse`` (reading the RDF files), ``structure`` (stripping and the
    graph structure) and ``features`` (labels, vectorizers and the
    link-prediction index arrays)."""
    task = config["task"]["type"]
    logging.info("Task set to %s", task)
    logging.info("Generating data structures")

    features_cfg = config["graph"].get("features", [])
    featureless = not any(f["include"] for f in features_cfg)

    data = None
    sample_map = None
    class_map = None
    if task == "node classification":
        triples = {}
        for split in ("train", "valid", "test"):
            with _stage(timings, "parse"), \
                    KnowledgeGraph(config["graph"][split]) as kg_split:
                triples[split] = frozenset(
                    kg_split.triples(separate_literals=False))

        with _stage(timings, "parse"):
            kg = KnowledgeGraph(config["graph"]["context"])
        with kg:
            with _stage(timings, "structure"):
                strip_graph(kg, config)
                A, nodes_map, _ = structure.generate(kg, config)
            with _stage(timings, "features"):
                F, Y, sample_map, class_map = \
                    dataset_build.build_dataset_nc(kg, nodes_map, triples,
                                                   config, featureless)
    elif task == "link prediction":
        with _stage(timings, "parse"):
            kg = KnowledgeGraph([config["graph"]["train"],
                                 config["graph"]["valid"],
                                 config["graph"]["test"]])
        with kg:
            with _stage(timings, "structure"):
                A, nodes_map, edges_map = structure.generate(kg, config)
            with _stage(timings, "features"):
                F = dataset_build.build_dataset_lp(kg, nodes_map, config,
                                                   featureless)
            Y = {}

            separate_literals = \
                config["graph"]["structural"]["separate_literals"]
            data = {}
            for split in ("train", "valid", "test"):
                with _stage(timings, "parse"):
                    kg_split = KnowledgeGraph(config["graph"][split])
                with kg_split, _stage(timings, "features"):
                    data[split] = triples_to_indices(
                        kg_split, nodes_map, edges_map, separate_literals)
    else:
        raise ValueError(f"unknown task type: {task}")

    return A, F, Y, data, sample_map, class_map


def build_cli(argv=None) -> Tuple[Optional[str], Dict[str, float]]:
    """Everything ``main`` does, returning the artifact's path (None with
    ``--dry_run``) and the host seconds of each stage (``build``'s and
    ``save``)."""
    timestamp = int(time())

    parser = argparse.ArgumentParser(prog="mrgcn-mkdataset (PyTorch)")
    parser.add_argument("-c", "--config", required=True,
                        help="Configuration file (toml)")
    parser.add_argument("-o", "--output", default="/tmp/",
                        help="Output directory")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Increase output verbosity")
    parser.add_argument("--dry_run", action="store_true",
                        help="Suppress writing output files to disk")
    args = parser.parse_args(argv)

    assert is_readable(args.config)
    config = load_config(args.config)

    sep = "" if args.output.endswith(os.sep) else os.sep
    base = f"{args.output}{sep}{config['name']}{timestamp}"
    assert is_writable(base)

    init_logger(base + ".log", args.dry_run, args.verbose)
    logging.debug("Arguments:\n%s", "\n".join(
        f"\t{k}: {getattr(args, k)}" for k in vars(args)))

    timings: Dict[str, float] = {}
    A, F, Y, data, sample_map, class_map = build(config, timings)

    path = None
    if not args.dry_run:
        path = base + ".npz"
        with _stage(timings, "save"):
            artifact.save(path, A, F, Y=Y, data=data,
                          sample_map=sample_map, class_map=class_map)
        logging.info("Dataset saved as %s", path)
        print(path)
    logging.info("Host seconds by stage: %s", ", ".join(
        f"{k} {v:.2f}" for k, v in timings.items()))
    return path, timings


def main(argv=None) -> int:
    build_cli(argv)
    logging.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
