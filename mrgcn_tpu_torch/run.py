"""``run`` CLI of the PyTorch port: train + evaluate on a dataset artifact.

Same flags as ``python -m mrgcn_tpu.run``
(``-c/-i/-o/-v/--dry_run/--load_checkpoint/--save_output/--save_checkpoint/
--test/--version``). Node classification on the featureless full-batch
path is supported; link prediction, reference ``.tar`` input and
checkpoints raise a "not yet ported" error.

The device comes from ``MRGCN_PLATFORM`` (``cpu``, else CUDA; see
:mod:`mrgcn_tpu_torch.utils.device`). Example::

    MRGCN_PLATFORM=cpu python -m mrgcn_tpu_torch.run -c cfg.toml \\
        -i dataset.npz --dry_run --test -v
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from time import time

from mrgcn_tpu.config import load_config
from mrgcn_tpu.data import artifact as artifact_io
from mrgcn_tpu.data.tsv import TSV
from mrgcn_tpu.data.utils import is_readable, is_writable, set_seed
from mrgcn_tpu.utils.logging import init_logger
from mrgcn_tpu_torch import __version__
from mrgcn_tpu_torch.tasks import node_classification
from mrgcn_tpu_torch.utils.device import select_device

logger = logging.getLogger(__name__)

NOT_PORTED = "not yet ported to mrgcn_tpu_torch ({}); use mrgcn_tpu.run"


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="MR-GCN (PyTorch)")
    parser.add_argument("-c", "--config", required=True,
                        help="Configuration file (toml)")
    parser.add_argument("-i", "--input", required=True,
                        help="Prepared input file (npz artifact)")
    parser.add_argument("-o", "--output", default="/tmp/",
                        help="Output directory")
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="Increase output verbosity")
    parser.add_argument("--dry_run", action="store_true",
                        help="Suppress writing output files to disk")
    parser.add_argument("--load_checkpoint", default=None,
                        help="Load model state from disk")
    parser.add_argument("--save_output", action="store_true",
                        help="Write final output to disk")
    parser.add_argument("--save_checkpoint", action="store_true",
                        help="Save model to disk")
    parser.add_argument("--test", action="store_true",
                        help="Report accuracy on the test set rather than "
                             "on the validation set")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    return parser


def run_cli(argv=None) -> node_classification.NCResult:
    """Everything ``main`` does, returning the task's result."""
    timestamp = int(time())
    args = _parser().parse_args(argv)
    if args.load_checkpoint or args.save_checkpoint:
        raise NotImplementedError(NOT_PORTED.format(
            "checkpoints: ROADMAP Queue 1, item 5"))
    if args.input.endswith(".tar"):
        raise NotImplementedError(NOT_PORTED.format(
            "reference .tar datasets: ROADMAP Queue 1, item 5"))

    if not is_readable(args.config):
        raise OSError(f"config not readable: {args.config}")
    config = load_config(args.config)
    task = config["task"]["type"]
    if task == "link prediction":
        raise NotImplementedError(NOT_PORTED.format(
            "link prediction: ROADMAP Queue 1, item 4"))
    if task != "node classification":
        raise ValueError(f"unknown task type: {task}")

    sep = "" if args.output.endswith(os.sep) else os.sep
    base = f"{args.output}{sep}{config['name']}{timestamp}_{os.getpid()}"
    if not is_writable(base):
        raise OSError(f"output not writable: {base}")

    init_logger(base + ".log", args.dry_run, args.verbose)
    acc_writer = TSV(base + "_acc.tsv", "w", args.dry_run)
    logging.debug("Arguments:\n%s", "\n".join(
        f"\t{k}: {getattr(args, k)}" for k in vars(args)))

    device = select_device()
    seed = set_seed(config["task"]["seed"])
    test_split = "test" if args.test else "valid"
    features_cfg = config["graph"].get("features", [])
    featureless = not any(f["include"] for f in features_cfg)

    if not is_readable(args.input):
        raise OSError(f"input not readable: {args.input}")
    artifact = artifact_io.load(args.input)

    logging.info("Starting %s task", task)
    result = node_classification.run(artifact, config, acc_writer,
                                     featureless, test_split, seed, device)
    print(f"loss {result.loss:.4f} / accuracy {result.acc:.4f}")

    if args.save_output:
        out_writer = TSV(base + "_out.tsv", "w")
        out_writer.writerow(["X", "Y_hat", "Y"])
        sample_map = artifact.sample_map
        class_map = artifact.class_map
        for i in range(len(result.labels)):
            out_writer.writerow([sample_map[test_split][i],
                                 class_map[int(result.labels[i])],
                                 class_map[int(result.targets[i])]])
        out_writer.close()
    acc_writer.close()
    return result


def main(argv=None) -> int:
    run_cli(argv)
    logging.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
