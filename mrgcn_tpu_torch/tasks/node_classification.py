"""Node classification: training and evaluation (PyTorch).

Counterpart of :mod:`mrgcn_tpu.tasks.node_classification`, featureless or
over encoded node features. Full batch (``[task] batchsize`` <= 0):
frontier-restricted layer edges, or the full edge set when the labels
cover every node. Mini-batches (``batchsize`` > 0): L-hop BFS
neighbourhoods built once on the host (:mod:`..data.batching`), moved to
the device a split at a time and run in dataset order, one
optimizer step each; ``neighbor_fanout`` caps each hop's expansion for
the training batches and ``neighbor_fanout_rounds`` cycles independent
samples across epochs, while evaluation batches always expand fully.
CE loss with L1/L2 penalties, global-norm clip and Adam, early stopping
on validation loss, and the reference's evaluation semantics (train and
validation labels merge in test mode; loss and accuracy are per-batch
means). Losses stay on the device and are read once per epoch. A
checkpoint (:func:`..tasks.utils.load_checkpoint`) resumes the run: the
epochs count on from the file's, and dropout and sampling restart at the
seed, as in the JAX package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mrgcn_tpu_torch.data import batching
from mrgcn_tpu_torch.data.artifact import Artifact
from mrgcn_tpu_torch.models.mrgcn import MRGCN
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import (RunInputs, hidden_dims_from_config,
                                          prepare_inputs, reject_mesh,
                                          restricted_layer_edges)

logger = logging.getLogger(__name__)


def build_model(inputs: RunInputs, config: Dict, num_classes: int,
                generator: torch.Generator,
                text_attn: Optional[str] = None) -> MRGCN:
    """The model with parameters drawn from ``generator`` (a CPU generator,
    so the draw does not depend on the device), moved to the inputs'
    device; ``text_attn`` is the text encoder's attention path (None:
    ``MRGCN_TEXT_ATTN``)."""
    model = MRGCN(hidden_dims=hidden_dims_from_config(config, num_classes),
                  modules_config=inputs.modules_config,
                  num_relations=inputs.num_relations,
                  num_nodes=inputs.num_nodes, generator=generator,
                  num_bases=config["model"]["num_bases"],
                  p_dropout=config["model"]["p_dropout"],
                  featureless=inputs.featureless,
                  use_bias=config["model"]["bias"],
                  text_vocab_size=inputs.text_vocab_size,
                  text_pad_id=inputs.text_pad_id, text_attn_impl=text_attn)
    return model.to(inputs.device)


def _loss_and_metrics(logits, idx, targets, weights):
    """Weighted CE/accuracy; padded label rows carry weight 0."""
    picked = logits[idx]
    ce = F.cross_entropy(picked, targets.long(), reduction="none")
    total = torch.clamp(weights.sum(), min=1.0)
    loss = (ce * weights).sum() / total
    labels = picked.argmax(dim=1)
    acc = ((labels == targets).to(weights.dtype) * weights).sum() / total
    return loss, acc, labels, targets


@dataclass
class NCBatch:
    """One batch: graph slice + features + padded labels."""

    features: Dict               # encoder name -> (data, node_idx, rows)
    edges: object                # EdgeBlock or tuple of per-layer blocks
    idx: torch.Tensor            # (m,) output-row index per labelled node
    targets: torch.Tensor        # (m,) class per labelled node
    weights: torch.Tensor        # (m,) 1.0 real / 0.0 padding
    num_real: int = 0


def _pad_labels(idx, targets, bucket_min: int = 64):
    """Label rows padded to a power-of-two bucket, as host arrays."""
    m = len(idx)
    pad = batching.bucket(m, bucket_min) - m
    idx = np.concatenate([idx, np.zeros(pad, dtype=np.int32)])
    targets = np.concatenate([targets, np.zeros(pad, dtype=np.int32)])
    weights = np.concatenate([np.ones(m, dtype=np.float32),
                              np.zeros(pad, dtype=np.float32)])
    return idx.astype(np.int64), targets.astype(np.int64), weights


def make_batches(inputs: RunInputs, label_rows: np.ndarray, batchsize: int,
                 num_layers: int, fanout=None,
                 rng: Optional[np.random.Generator] = None) -> List[NCBatch]:
    """Full batch when ``batchsize <= 0`` or everything fits one slice;
    otherwise L-hop BFS mini-batches built once and reused every epoch
    (reference: node_classification.py:127-143, 329-351).

    The full batch runs on frontier-restricted layer edges, where every
    layer aggregates only at the rows the loss (transitively) reads; when
    the labels cover every node, on the full edge set and its planned
    layers. ``fanout`` (``[task] neighbor_fanout``) caps each hop's
    per-node expansion of a mini-batch with importance-rescaled norms
    (:meth:`..data.batching.EdgeIndex.hop_sampled`), drawing from ``rng``.
    """
    num_samples = label_rows.shape[0]
    if batchsize <= 0 or batchsize >= num_samples:
        uniq, inverse = np.unique(label_rows[:, 0], return_inverse=True)
        if len(uniq) < inputs.num_nodes:
            edges = restricted_layer_edges(
                inputs.structure, uniq, num_layers, inputs.edges,
                first_dim=inputs.hidden_dims[0], X_width=inputs.X_width,
                featureless=inputs.featureless,
                identity_basis=inputs.identity_basis, device=inputs.device)
            idx = inverse.astype(np.int32)
        else:
            edges = inputs.edges
            idx = label_rows[:, 0]
        idx, targets, weights = (
            torch.as_tensor(a, device=inputs.device)
            for a in _pad_labels(idx, label_rows[:, 1]))
        return [NCBatch(features=inputs.features, edges=edges, idx=idx,
                        targets=targets, weights=weights,
                        num_real=num_samples)]

    index = batching.EdgeIndex(inputs.structure)
    payloads, num_real = [], []
    for begin in range(0, num_samples, batchsize):
        rows = label_rows[begin:begin + batchsize]
        # a node may carry several labels (multi-label target triples);
        # sample its neighbourhood once and point every label row at the
        # same local output row
        uniq_nodes, inverse = np.unique(rows[:, 0], return_inverse=True)
        mb = batching.sample_minibatch(index, uniq_nodes, num_layers,
                                       fanout=fanout, rng=rng)
        feats = batching.subset_features(inputs.features_host,
                                         mb.outer_nodes,
                                         num_rows=mb.layer_edges[0].num_in)
        payloads.append((feats, mb.layer_edges,
                         *_pad_labels(inverse.astype(np.int32), rows[:, 1])))
        num_real.append(len(rows))
    # the whole split moves at once, after the host has built it
    put = batching.device_put_batches(payloads, inputs.device)
    return [NCBatch(features=f, edges=e, idx=i, targets=t, weights=w,
                    num_real=n)
            for (f, e, i, t, w), n in zip(put, num_real)]


def train_step(model: MRGCN, optimizer: tutils.ClippedAdam, batch: NCBatch,
               l1: float, l2: float,
               generator: Optional[torch.Generator] = None):
    """One optimizer step; returns (loss incl. penalties, accuracy) as
    0-dim tensors."""
    model.train()
    optimizer.zero_grad()
    out = model(batch.edges, batch.features, train=True,
                generator=generator)
    loss, acc, _, _ = _loss_and_metrics(out, batch.idx, batch.targets,
                                        batch.weights)
    loss = loss + tutils.regularization(model, l1, l2)
    loss.backward()
    optimizer.step()
    return loss.detach(), acc.detach()


@torch.no_grad()
def eval_step(model: MRGCN, batch: NCBatch):
    model.eval()
    out = model(batch.edges, batch.features, train=False)
    return _loss_and_metrics(out, batch.idx, batch.targets, batch.weights)


def _epoch_means(losses, accs):
    """Means of per-batch 0-dim tensors, read with one copy to the host."""
    loss, acc = torch.stack([torch.stack(losses).mean(),
                             torch.stack(accs).mean()]).tolist()
    return loss, acc


def eval_batches(model: MRGCN, batches: List[NCBatch]):
    """Per-batch means averaged over batches
    (reference: node_classification.py:229-310). Every batch is launched
    before the first value is read."""
    losses, accs, labels_all, targets_all = [], [], [], []
    for b in batches:
        loss, acc, labels, targets = eval_step(model, b)
        losses.append(loss)
        accs.append(acc)
        labels_all.append(labels[:b.num_real])
        targets_all.append(targets[:b.num_real])
    return (*_epoch_means(losses, accs),
            torch.cat(labels_all).cpu().numpy(),
            torch.cat(targets_all).cpu().numpy())


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class NCResult:
    model: MRGCN
    optimizer: tutils.ClippedAdam
    epoch: int
    loss: float
    acc: float
    labels: np.ndarray
    targets: np.ndarray
    # per epoch: epoch, train/val loss and accuracy, seconds (synchronised)
    history: List[Dict] = field(default_factory=list)
    # how the batches were made: counts per split, the sampled rounds and
    # the host seconds spent building and moving them
    batches: Dict = field(default_factory=dict)


def run(artifact: Artifact, config: Dict, tsv_writer, featureless: bool,
        test_split: str, seed: int, device: torch.device,
        checkpoint: Optional[str] = None) -> NCResult:
    """Full training + final evaluation on ``device``, from the state in
    ``checkpoint`` when one is given (its epochs count on). A device mesh
    (``MRGCN_MESH``, ``[task] mesh``) raises ``NotImplementedError``."""
    reject_mesh(config)
    tsv_writer.writerow(["epoch", "training_loss", "training_accurary",
                         "validation_loss", "validation_accuracy",
                         "test_loss", "test_accuracy"])

    inputs = prepare_inputs(artifact, config, featureless, device)
    featureless = inputs.featureless

    Y = {k: np.asarray(v).reshape(-1, 2) for k, v in artifact.Y.items()}
    num_classes = len(artifact.class_map)
    Y_train, Y_valid = Y["train"], Y.get("valid")
    if test_split == "test" and Y_valid is not None:
        # train and validation labels merge when testing
        Y_train = np.concatenate([Y_train, Y_valid], axis=0)
        Y_valid = None

    # the file is read before the model is built: its text-attention tree
    # picks the path the model is built with
    state = tutils.load_checkpoint(checkpoint) if checkpoint else None
    text_attn = tutils.reconcile_text_attn(state["params"]) \
        if state is not None and state["format"] != "torch" else None
    model = build_model(inputs, config, num_classes,
                        torch.Generator().manual_seed(seed),
                        text_attn=text_attn)
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config, featureless)
    epoch = 0
    if state is not None:
        print("[LOAD] Loading model state", end="")
        epoch = tutils.restore_checkpoint(model, optimizer, state)
        print(f" - {epoch} epoch")
    # an encoder whose gate is exactly zero runs nothing (reference:
    # node_classification.py:401, tasks/utils.with_gate_skip); the gates
    # may come from the checkpoint
    model.skip_encoders = tutils.dead_encoders(model)
    if model.skip_encoders:
        logger.info("Skipping zero-gated encoder(s): %s",
                    ", ".join(model.skip_encoders))
    dropout_rng = torch.Generator(device=device).manual_seed(seed)

    nepoch = config["model"]["epoch"]
    batchsize = config["task"].get("batchsize", -1)
    num_layers = len(model.hidden_dims)
    l1 = config["model"]["l1_lambda"]
    l2 = config["model"]["l2_lambda"]
    patience = config["task"]["early_stopping"]["patience"]
    tolerance = config["task"]["early_stopping"]["tolerance"]
    early_stop = tutils.EarlyStop(patience, tolerance) \
        if patience > 0 else None

    # neighbour-sampled training: [task] neighbor_fanout caps each hop's
    # per-node expansion with importance-rescaled norms;
    # neighbor_fanout_rounds R > 1 builds R independent samples and cycles
    # them across epochs (GraphSAGE-style variance reduction)
    fanout_cfg = config["task"].get("neighbor_fanout")
    fanout = None
    if batchsize > 0 and Y_train.shape[0] > batchsize:
        fanout = batching.normalize_fanout(fanout_cfg, num_layers)
    elif fanout_cfg not in (None, -1):
        logger.warning("neighbor_fanout is ignored in full-batch mode "
                       "(set [task] batchsize > 0 to enable sampling)")
    rounds = max(1, int(config["task"].get("neighbor_fanout_rounds", 1))) \
        if fanout is not None else 1
    sample_rng = np.random.default_rng(seed)

    # batches are built once and reused every epoch
    # (reference: node_classification.py:127-143); evaluation batches
    # always expand fully: metrics stay exact, sampling is a training
    # estimator
    t_build = perf_counter()
    train_rounds = [make_batches(inputs, Y_train, batchsize, num_layers,
                                 fanout=fanout, rng=sample_rng)
                    for _ in range(rounds)]
    train_batches = train_rounds[0]
    valid_batches = make_batches(inputs, Y_valid, batchsize, num_layers) \
        if Y_valid is not None else []
    _synchronize(device)
    batch_info = {"train": len(train_batches), "valid": len(valid_batches),
                  "rounds": rounds,
                  "build_seconds": perf_counter() - t_build}

    logger.info("Training for %d epoch (%d batch(es)) on %s", nepoch,
                len(train_batches), device)
    history: List[Dict] = []
    t0 = perf_counter()
    final_epoch = epoch
    for ep in range(epoch + 1, nepoch + epoch + 1):
        if early_stop is not None and early_stop.stop:
            logger.info("Stopping early after %d epoch", ep - 1)
            if early_stop.best_state is not None:
                model_state, opt_state = early_stop.best_state
                model.load_state_dict(model_state)
                optimizer.adam.load_state_dict(opt_state)
            break
        final_epoch = ep
        t_ep = perf_counter()
        if rounds > 1:
            train_batches = train_rounds[(ep - 1) % rounds]
        progress = tutils.BatchProgress(len(train_batches), label="TRAIN")
        losses, accs = [], []
        for bi, b in enumerate(train_batches, 1):
            progress.update(bi)
            loss, acc = train_step(model, optimizer, b, l1, l2, dropout_rng)
            losses.append(loss)
            accs.append(acc)
        progress.done()
        # the batches' 0-dim tensors are read here, once per epoch
        train_loss, train_acc = _epoch_means(losses, accs)

        val_loss, val_acc = -1.0, -1.0
        if valid_batches:
            val_loss, val_acc, _, _ = eval_batches(model, valid_batches)
            if early_stop is not None:
                early_stop.record(val_loss, (model.state_dict(),
                                             optimizer.state_dict()))
        _synchronize(device)
        seconds = perf_counter() - t_ep
        history.append({"epoch": ep, "train_loss": train_loss,
                        "train_acc": train_acc, "val_loss": val_loss,
                        "val_acc": val_acc, "seconds": seconds})
        logger.info("%04d | train loss %.4f / acc %.4f | val loss %.4f / "
                    "acc %.4f | %.4fs", ep, train_loss, train_acc,
                    val_loss, val_acc, seconds)
        tsv_writer.writerow([str(ep), str(train_loss), str(train_acc),
                             str(val_loss), str(val_acc), "-1", "-1"])

    logger.info("Training time: %.2fs", perf_counter() - t0)

    test_batches = make_batches(inputs, Y[test_split], batchsize,
                                num_layers)
    loss, acc, labels, targets = eval_batches(model, test_batches)
    logger.info("Performance on %s set: loss %.4f / accuracy %.4f",
                test_split, loss, acc)
    tsv_writer.writerow(["-1", "-1", "-1", "-1", "-1", str(loss), str(acc)])
    return NCResult(model=model, optimizer=optimizer, epoch=final_epoch,
                    loss=loss, acc=acc, labels=labels, targets=targets,
                    history=history, batches=batch_info)
