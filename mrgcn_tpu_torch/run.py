"""``run`` CLI of the PyTorch port: train + evaluate on a dataset artifact.

Same flags as ``python -m mrgcn_tpu.run``
(``-c/-i/-o/-v/--dry_run/--load_checkpoint/--save_output/--save_checkpoint/
--test/--version``). Node classification, full batch or in mini-batches
(``[task] batchsize``), and link prediction, on the full graph or in
node-sliced batches (``gcn_batchsize``, ``test_batchsize``), both with
neighbour sampling (``neighbor_fanout``, ``neighbor_fanout_rounds``),
featureless or over every literal modality. The input is the ``.npz``
artifact or a reference-produced ``.tar`` dataset. ``--save_checkpoint``
writes ``<base>_model_state_<epoch>.npz``, the checkpoint both packages
read; ``--load_checkpoint`` resumes from one, or from a reference
``torch.save`` checkpoint. ``MRGCN_PROFILE_DIR`` records a
``torch.profiler`` trace of the task.

The device comes from ``MRGCN_PLATFORM`` (``cpu``, else CUDA; see
:mod:`mrgcn_tpu_torch.utils.device`). Example::

    MRGCN_PLATFORM=cpu python -m mrgcn_tpu_torch.run -c cfg.toml \\
        -i dataset.npz --dry_run --test -v

A device mesh (``MRGCN_MESH`` or ``[task] mesh``: ``N``, ``DxM``, ``auto``;
:mod:`mrgcn_tpu_torch.parallel.mesh`) runs the task in one process per
device, started here: NCCL with one card a rank on CUDA (a spec asking
for more ranks than there are cards raises), gloo over as many CPU
processes as the spec names with ``MRGCN_PLATFORM=cpu`` (where ``auto``
runs one process, as the JAX package's ``auto`` takes the one device of
its default CPU backend). Rank 0 writes the TSV, the log, ``--save_output`` and the
checkpoint; every rank trains the same numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys
from time import time

import torch

from mrgcn_tpu_torch import __version__
from mrgcn_tpu_torch.config import load_config
from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data.tsv import TSV
from mrgcn_tpu_torch.data.reference_tar import artifact_from_reference_tar
from mrgcn_tpu_torch.data.utils import is_readable, is_writable, set_seed
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.tasks import link_prediction, node_classification
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.utils.logging import init_logger
from mrgcn_tpu_torch.utils.device import select_device
from mrgcn_tpu_torch.utils.profiling import profile_session

logger = logging.getLogger(__name__)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="MR-GCN (PyTorch)")
    parser.add_argument("-c", "--config", required=True,
                        help="Configuration file (toml)")
    parser.add_argument("-i", "--input", required=True,
                        help="Prepared input file (npz artifact, or a "
                             "reference-produced .tar dataset)")
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
    (``NCResult`` or ``LPResult``; from a mesh, rank 0's, without the
    model and the optimizer, which stay in the ranks)."""
    timestamp = int(time())
    args = _parser().parse_args(argv)

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

    device = select_device()
    spec = pmesh.mesh_spec(config)
    if spec in pmesh.NO_MESH:
        return _run(args, config, base, device)
    cards = None if device.type == "cpu" else torch.cuda.device_count()
    shape = pmesh.mesh_shape(spec, cards)
    if shape is None:          # "auto" on the CPU: one process
        return _run(args, config, base, device)
    data, model = shape
    world = data * model
    if device.type == "cpu":
        backend, devices = "gloo", ["cpu"] * world
    else:
        backend, devices = "nccl", [f"cuda:{i}" for i in range(world)]
    argv = sys.argv[1:] if argv is None else list(argv)
    # no limit on the run's wall time: a hung rank fails in its
    # collective after ``pmesh.TIMEOUT`` seconds of waiting there
    results = pmesh.launch(_rank_run, world, backend, devices,
                           args=(argv, base), timeout=None)
    return results[0]


def _rank_run(rank: int, argv, base: str):
    """One rank of a mesh run: the task in this rank's world; rank 0
    writes the files and the standard output."""
    args = _parser().parse_args(argv)
    config = load_config(args.config)
    if rank == 0:
        result = _run(args, config, base, select_device())
    else:
        args.dry_run, args.verbose, args.save_output = True, 0, False
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            result = _run(args, config, base, select_device())
    return dataclasses.replace(result, model=None, optimizer=None)


def _run(args, config, base: str, device):
    init_logger(base + ".log", args.dry_run, args.verbose)
    acc_writer = TSV(base + "_acc.tsv", "w", args.dry_run)
    logging.debug("Arguments:\n%s", "\n".join(
        f"\t{k}: {getattr(args, k)}" for k in vars(args)))

    task = config["task"]["type"]
    seed = set_seed(config["task"]["seed"])
    test_split = "test" if args.test else "valid"
    features_cfg = config["graph"].get("features", [])
    featureless = not any(f["include"] for f in features_cfg)

    if not is_readable(args.input):
        raise OSError(f"input not readable: {args.input}")
    if args.input.endswith(".tar"):
        # a dataset written by the reference's mkdataset
        artifact = artifact_from_reference_tar(args.input)
    else:
        artifact = artifact_io.load(args.input)

    logging.info("Starting %s task", task)
    if task == "node classification":
        with profile_session(device=device):
            result = node_classification.run(
                artifact, config, acc_writer, featureless, test_split, seed,
                device, args.load_checkpoint)
        print(f"loss {result.loss:.4f} / accuracy {result.acc:.4f}")
        if args.save_output:
            _save_predictions(base, artifact, test_split, result)
    else:
        filter_ranks = config["task"]["filter_ranks"]
        with profile_session(device=device):
            result = link_prediction.run(
                artifact, config, acc_writer, featureless, test_split, seed,
                device, args.load_checkpoint)
        print(_lp_summary(test_split, filter_ranks, result.mrr,
                          result.hits))
        if args.save_output:
            _save_ranks(base, filter_ranks, result.ranks)
    acc_writer.close()

    # under a mesh every rank gathers its basis slices; rank 0 writes
    if args.save_checkpoint:
        f_state = base + f"_model_state_{result.epoch}.npz"
        tutils.save_checkpoint(f_state, result.epoch, result.model,
                               result.optimizer, result.loss)
        print(f"[SAVE] Writing model state to {f_state}")
    return result


def main(argv=None) -> int:
    run_cli(argv)
    logging.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
