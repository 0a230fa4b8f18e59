"""``run`` CLI of the PyTorch port: train + evaluate on a dataset artifact.

Same flags as ``python -m mrgcn_tpu.run``
(``-c/-i/-o/-v/--dry_run/--load_checkpoint/--save_output/--save_checkpoint/
--test/--version``). Full-batch node classification and full-graph link
prediction are supported, featureless or over numeric, boolean, temporal
and string features (the from-scratch text encoder); image and WKT
features, mini-batches and node-sliced link-prediction batches, reference
``.tar`` input and checkpoints raise a "not yet ported" error naming
their ROADMAP item.

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

from mrgcn_tpu_torch import __version__
from mrgcn_tpu_torch.config import load_config
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data.tsv import TSV
from mrgcn_tpu_torch.data.utils import is_readable, is_writable, set_seed
from mrgcn_tpu_torch.utils.logging import init_logger
from mrgcn_tpu_torch.tasks import link_prediction, node_classification
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


def _save_predictions(base: str, artifact, test_split: str, result) -> None:
    out_writer = TSV(base + "_out.tsv", "w")
    out_writer.writerow(["X", "Y_hat", "Y"])
    sample_map = artifact.sample_map
    class_map = artifact.class_map
    for i in range(len(result.labels)):
        out_writer.writerow([sample_map[test_split][i],
                             class_map[int(result.labels[i])],
                             class_map[int(result.targets[i])]])
    out_writer.close()


def _save_ranks(base: str, filter_ranks: bool, ranks) -> None:
    rank_writer = TSV(base + "_ranks.tsv", "w")
    if filter_ranks:
        rank_writer.writerow(["raw", "filtered"])
        rank_writer.writerows(zip(ranks["raw"], ranks["flt"]))
    else:
        rank_writer.writerow(["raw"])
        rank_writer.writerows([r] for r in ranks["raw"])
    rank_writer.close()


def _lp_summary(test_split: str, filter_ranks: bool, mrr, hits) -> str:
    text = (f"Performance on {test_split} set: "
            f"MRR (raw) {mrr['raw']:.4f} - H@1 {hits['raw'][0]:.4f} / "
            f"H@3 {hits['raw'][1]:.4f} / H@10 {hits['raw'][2]:.4f}")
    if filter_ranks:
        text += (f" | MRR (filtered) {mrr['flt']:.4f} - "
                 f"H@1 {hits['flt'][0]:.4f} / H@3 {hits['flt'][1]:.4f} / "
                 f"H@10 {hits['flt'][2]:.4f}")
    return text


def run_cli(argv=None):
    """Everything ``main`` does, returning the task's result
    (``NCResult`` or ``LPResult``)."""
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
    if task not in ("node classification", "link prediction"):
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
    if task == "node classification":
        result = node_classification.run(artifact, config, acc_writer,
                                         featureless, test_split, seed,
                                         device)
        print(f"loss {result.loss:.4f} / accuracy {result.acc:.4f}")
        if args.save_output:
            _save_predictions(base, artifact, test_split, result)
    else:
        filter_ranks = config["task"]["filter_ranks"]
        result = link_prediction.run(artifact, config, acc_writer,
                                     featureless, test_split, seed, device)
        print(_lp_summary(test_split, filter_ranks, result.mrr,
                          result.hits))
        if args.save_output:
            _save_ranks(base, filter_ranks, result.ranks)
    acc_writer.close()
    return result


def main(argv=None) -> int:
    run_cli(argv)
    logging.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
