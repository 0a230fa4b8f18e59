"""Link prediction: DistMult training + full-entity ranking (PyTorch).

Counterpart of :mod:`mrgcn_tpu.tasks.link_prediction` (reference:
mrgcn/tasks/link_prediction.py). A training step
corrupts the batch's triples (:func:`make_corruptor`), scores positives and
corruptions with DistMult over the R-GCN's node embeddings, and takes one
clipped Adam step on the weighted BCE plus penalties; evaluation embeds
once per graph slice and ranks every (fact, candidate) pair with batched
matmuls (:mod:`mrgcn_tpu_torch.ops.distmult`).

Semantics kept from the reference and the JAX package:
  * ``test_batchsize`` sub-splits the triples into subsets; ranking
    candidates are the whole graph, corruption draws from the subset's own
    nodes; per-subset MRR/hits are averaged over subsets;
  * ``gcn_batchsize`` below the split's node count slices the split's
    nodes: each slice's triples, sub-split by ``test_batchsize``, become a
    batch on the L-hop neighbourhood of their own nodes
    (:mod:`..data.batching`), with batch-local triple ids, and both the
    ranking candidates and the corruption pool are the batch's nodes;
    ``neighbor_fanout`` caps each hop's expansion for the training batches
    only and ``neighbor_fanout_rounds`` cycles independent samples across
    epochs; the batches run in order, one optimizer step each;
  * negative sampling corrupts ``negative_sampling_ratio`` (default 1/5) of
    each subset's triples, half heads / half tails;
    ``negative_adversarial_temperature`` reweights the negatives;
  * in test mode the train and valid splits merge;
  * early stopping on ``1 - valid raw MRR`` at eval-interval cadence.

Corruption and the update are separate functions (:func:`make_corruptor`'s
``corrupt`` and :func:`loss_and_grads`), so the same corrupted triples can
be fed to both packages. A checkpoint resumes the run: the epochs (and
with them the ranking cadence) count on from the file's, and the
corruption and sampling generators restart at the seed, as in the JAX
package. Under a device mesh (:mod:`..parallel.mesh`) the full graph runs
on this rank's share of the edges and feature rows, node-sliced batches
run whole on every rank, and every rank corrupts and ranks on the same
(replicated) embeddings.
"""

from __future__ import annotations

import logging
import zlib
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mrgcn_tpu_torch.data import batching
from mrgcn_tpu_torch.data.artifact import Artifact
from mrgcn_tpu_torch.models.mrgcn import MRGCN
from mrgcn_tpu_torch.ops import distmult
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import (RunInputs, hidden_dims_from_config,
                                          prepare_inputs)

logger = logging.getLogger(__name__)

K = (1, 3, 10)


def build_model(inputs: RunInputs, config: Dict,
                generator: torch.Generator,
                text_attn: Optional[str] = None) -> MRGCN:
    """The LP model (ReLU on every layer, DistMult relation vectors) with
    parameters drawn from ``generator`` (a CPU generator, so the draw does
    not depend on the device), moved to the inputs' device; ``text_attn``
    is the text encoder's attention path (None: ``MRGCN_TEXT_ATTN``)."""
    model = MRGCN(hidden_dims=hidden_dims_from_config(config, None),
                  modules_config=inputs.modules_config,
                  num_relations=inputs.num_relations,
                  num_nodes=inputs.num_nodes, generator=generator,
                  num_bases=config["model"]["num_bases"],
                  p_dropout=config["model"]["p_dropout"],
                  featureless=inputs.featureless,
                  use_bias=config["model"]["bias"],
                  text_vocab_size=inputs.text_vocab_size,
                  text_pad_id=inputs.text_pad_id, link_prediction=True,
                  text_attn_impl=text_attn)
    return model.to(inputs.device)


@dataclass
class LPBatch:
    """One (graph slice, triple subset) pair."""

    features: Dict
    edges: object            # EdgeBlock or tuple of per-layer EdgeBlocks
    data: np.ndarray         # (M, 3) triple ids, bucket-padded (batch-local
    #                          in node-sliced mode); rows >= num_triples are
    #                          zero padding with weight 0
    corrupt_pool: np.ndarray  # node ids to draw corruptions from (padded)
    num_valid: int           # ranking candidate count (graph or batch local)
    num_triples: int = 0     # real triple count (== len(data) if unpadded)
    num_pool: int = 0        # real corrupt_pool length (rest is padding)
    # cached (RankPlan, boundaries, fingerprint): the batch's facts are
    # static, so the host filter walk and the upload happen once, not per
    # evaluation; keyed on a content fingerprint (see _plan_fingerprint),
    # so mutating a batch's facts rebuilds the plan
    rank_plan: object = None

    @property
    def real_data(self) -> np.ndarray:
        return self.data[:self.num_triples]


def node_slices(data: np.ndarray, gcn_batchsize: int, test_batchsize: int):
    """The node-sliced branch's triple subsets, in order: the split's nodes
    in slices of ``gcn_batchsize``, each slice's triples (a head or a tail
    in it) sub-split by ``test_batchsize``. Yields ``(triples, nodes)``:
    ``nodes`` the subset's own sorted node ids, ``triples`` with head and
    tail as positions in ``nodes`` (reference: lp.py:528-532)."""
    sample_nodes = np.union1d(data[:, 0], data[:, 2])
    for begin in range(0, len(sample_nodes), gcn_batchsize):
        batch_node_idx = sample_nodes[begin:begin + gcn_batchsize]
        mask = (np.isin(data[:, 0], batch_node_idx)
                | np.isin(data[:, 2], batch_node_idx))
        batch_data = data[mask]
        num_samples = batch_data.shape[0]
        if num_samples == 0:
            continue
        for subset in np.array_split(np.arange(num_samples),
                                     max(num_samples // test_batchsize, 1)):
            data_subset = np.copy(batch_data[subset])
            subset_nodes = np.union1d(data_subset[:, 0],
                                      data_subset[:, 2]).astype(np.int32)
            data_subset[:, 0] = np.searchsorted(subset_nodes,
                                                data_subset[:, 0])
            data_subset[:, 2] = np.searchsorted(subset_nodes,
                                                data_subset[:, 2])
            yield data_subset.astype(np.int32), subset_nodes


def sliced_batch(inputs: RunInputs, index, data_subset: np.ndarray,
                 subset_nodes: np.ndarray, num_layers: int, fanout=None,
                 rng: Optional[np.random.Generator] = None) -> "LPBatch":
    """One node-sliced batch, its arrays on the host: the L-hop
    neighbourhood of ``subset_nodes``, whose positions are both the ranking
    candidates and the corruption pool."""
    mb = batching.sample_minibatch(index, subset_nodes, num_layers,
                                   fanout=fanout, rng=rng)
    feats = batching.subset_features(inputs.features_host, mb.outer_nodes,
                                     num_rows=mb.layer_edges[0].num_in)
    data_pad, pool_pad = _pad_lp_arrays(
        data_subset, np.arange(len(subset_nodes), dtype=np.int32))
    return LPBatch(features=feats, edges=mb.layer_edges, data=data_pad,
                   corrupt_pool=pool_pad, num_valid=len(subset_nodes),
                   num_triples=len(data_subset), num_pool=len(subset_nodes))


def make_lp_batches(inputs: RunInputs, data: np.ndarray,
                    gcn_batchsize: int, test_batchsize: int,
                    num_layers: int, fanout=None,
                    rng: Optional[np.random.Generator] = None
                    ) -> List[LPBatch]:
    """Reference batching (reference: lp.py:477-548).

    ``fanout`` (``[task] neighbor_fanout``, normalized or raw, see
    :func:`..data.batching.normalize_fanout`) caps each hop's per-node
    expansion with importance-rescaled norms in the node-sliced branch,
    drawing from ``rng``. Pass it for training batches only: ranking must
    ride exact full-expansion embeddings."""
    sample_nodes = np.union1d(data[:, 0], data[:, 2])
    num_nodes = len(sample_nodes)
    if gcn_batchsize <= 0:
        gcn_batchsize = num_nodes
    if test_batchsize <= 0:
        test_batchsize = data.shape[0]

    batches: List[LPBatch] = []
    if gcn_batchsize < num_nodes:
        index = batching.EdgeIndex(inputs.structure)
        for data_subset, subset_nodes in node_slices(data, gcn_batchsize,
                                                     test_batchsize):
            batches.append(sliced_batch(inputs, index, data_subset,
                                        subset_nodes, num_layers, fanout,
                                        rng))
        # the whole split moves at once, after the host has built it
        put = batching.device_put_batches(
            [(b.features, b.edges) for b in batches], inputs.device)
        for b, (features, edges) in zip(batches, put):
            b.features, b.edges = features, edges
        return batches

    if fanout is not None:
        logger.warning("neighbor_fanout is ignored in full-graph LP mode "
                       "(set [task] gcn_batchsize below the split's node "
                       "count to enable sampling)")
    num_samples = data.shape[0]
    for subset in np.array_split(np.arange(num_samples),
                                 max(num_samples // test_batchsize, 1)):
        data_subset = np.copy(data[subset]).astype(np.int32)
        subset_nodes = np.union1d(data_subset[:, 0],
                                  data_subset[:, 2]).astype(np.int32)
        data_pad, pool_pad = _pad_lp_arrays(data_subset, subset_nodes)
        # ranking candidates are the whole graph, but corruption draws
        # only from the subset's own nodes (reference: lp.py:256-259)
        batches.append(LPBatch(
            features=inputs.features, edges=inputs.edges, data=data_pad,
            corrupt_pool=pool_pad, num_valid=inputs.num_nodes,
            num_triples=len(data_subset), num_pool=len(subset_nodes)))
    return batches


def _pad_lp_arrays(data: np.ndarray, pool: np.ndarray):
    """Bucket-pad triples and the corruption pool (power-of-two buckets, as
    the JAX package pads them, so corruption counts agree). Padding triples
    are (0, 0, 0) rows with weight 0 in the loss; padding pool entries are
    never drawn (draws index < num_pool)."""
    data_pad = np.zeros((batching.bucket(len(data), 64), 3), dtype=np.int32)
    data_pad[:len(data)] = data
    pool_pad = np.zeros(batching.bucket(len(pool), 64), dtype=np.int32)
    pool_pad[:len(pool)] = pool
    return data_pad, pool_pad


def sample_negatives(rng: np.random.Generator,
                     batch: LPBatch) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side within-batch corruption (reference: lp.py:246-268).
    Returns (triples, labels): positives followed by corrupted copies. The
    oracle for :func:`make_corruptor` and for tests."""
    data = batch.real_data
    num_samples = data.shape[0]
    ncorrupt = num_samples // 5
    if ncorrupt == 0:
        return data, np.ones(num_samples, dtype=np.float32)

    nc_head = ncorrupt // 2
    nc_tail = ncorrupt - nc_head
    pool = batch.corrupt_pool[:batch.num_pool] if batch.num_pool \
        else batch.corrupt_pool
    pick = rng.choice(num_samples, ncorrupt, replace=False)
    corrupted = np.copy(data[pick])
    corrupted[:nc_head, 0] = rng.choice(pool, nc_head)
    corrupted[nc_head:, 2] = rng.choice(pool, nc_tail)

    triples = np.concatenate([data, corrupted], axis=0)
    labels = np.concatenate([np.ones(num_samples, dtype=np.float32),
                             np.zeros(ncorrupt, dtype=np.float32)])
    return triples, labels


def make_corruptor(neg_ratio: float = 0.2):
    """The on-device corruption function for a negative-sampling ratio
    (``[task] negative_sampling_ratio``; the reference hardcodes 1/5
    uniform, lp.py:246-268). The ratio is quantized to 1/1000 so corrupted
    counts are exact integer math (``floor(n * 200 / 1000) == n // 5`` at
    the default)."""
    if neg_ratio < 0:
        raise ValueError("negative_sampling_ratio must be >= 0")
    neg_num = int(round(neg_ratio * 1000))

    def corrupt(data: torch.Tensor, num_triples: int, pool: torch.Tensor,
                num_pool: int, generator: torch.Generator):
        """Within-batch corruption over bucket-padded tensors, with the
        semantics of :func:`sample_negatives` at the default ratio 0.2:
        ``floor(ratio * num_triples)`` of the real triples (distinct rows
        while ratio <= 1, uniform with replacement above), half heads /
        half tails, replacements drawn uniformly from the real pool
        entries. Corruption-slot counts derive from the padded ``M``, as
        in the JAX package; slots past the real count carry weight 0.
        Returns ``(triples (M + ncp, 3), labels, weights)``."""
        M = data.shape[0]
        device = data.device
        ncp = (M * neg_num) // 1000        # padded corruption slots
        nc_head = ncp // 2

        def arange(n):
            return torch.arange(n, device=device)

        if ncp <= M:
            # distinct real rows first: random key, padding pushed back
            key = torch.rand(M, generator=generator, device=device) \
                + (arange(M) >= num_triples) * 10.0
            pick = torch.argsort(key)[:ncp]
        else:
            # more negatives than rows: real rows, with replacement
            pick = torch.randint(0, max(num_triples, 1), (ncp,),
                                 generator=generator, device=device)

        n_real = min((num_triples * neg_num) // 1000, ncp)
        n_real_head = n_real // 2
        n_real_tail = n_real - n_real_head
        # Route the real picks into the weighted slots of both segments.
        # ``pick`` packs real source rows first, but the head/tail
        # segments are fixed halves of the padded count: without routing,
        # the weighted tail slots [nc_head, nc_head + n_real_tail) would
        # read picks [nc_head, ...), which are padding rows whenever
        # num_triples < nc_head + n_real_tail, and the model would train
        # on (0, 0, tail) negatives at full weight. Weighted head slots
        # take picks [0, n_real_head), weighted tail slots picks
        # [n_real_head, n_real); the zero-weight remainder slots take the
        # leftover picks (possibly padding, harmless at weight 0).
        t = arange(ncp)
        src = torch.where(
            t < n_real_head, t,
            torch.where(
                t < nc_head, n_real + (t - n_real_head),
                torch.where(t < nc_head + n_real_tail,
                            n_real_head + (t - nc_head),
                            n_real + (nc_head - n_real_head)
                            + (t - nc_head - n_real_tail))))
        corrupted = data[pick[src]].clone()
        draw = max(num_pool, 1)
        corrupted[:nc_head, 0] = pool[torch.randint(
            0, draw, (nc_head,), generator=generator, device=device)]
        corrupted[nc_head:, 2] = pool[torch.randint(
            0, draw, (ncp - nc_head,), generator=generator, device=device)]
        triples = torch.cat([data, corrupted], dim=0)

        labels = torch.cat([torch.ones(M, device=device),
                            torch.zeros(ncp, device=device)])
        weights = torch.cat([arange(M) < num_triples,
                             arange(nc_head) < n_real_head,
                             arange(ncp - nc_head) < n_real_tail]
                            ).to(torch.float32)
        return triples, labels, weights

    return corrupt


def lp_loss(model: MRGCN, batch: LPBatch, triples: torch.Tensor,
            labels: torch.Tensor, weights: torch.Tensor,
            adv_alpha: float = 0.0, l1: float = 0.0, l2: float = 0.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Weighted BCE of the DistMult scores of ``triples`` under the
    training-mode embeddings, plus the L1/L2 penalties."""
    out = model(batch.edges, batch.features, train=True,
                generator=generator)
    triples = triples.long()
    y_hat = distmult.score(triples[:, 0], triples[:, 1], triples[:, 2],
                           out, model.rgcn.relations)
    bce = F.binary_cross_entropy_with_logits(y_hat, labels,
                                             reduction="none")
    if adv_alpha > 0.0:
        # self-adversarial negative weighting (RotatE, Sun et al. 2019; no
        # reference analogue): negatives reweighted by softmax(alpha *
        # score) without gradient, their mass renormalised to the real
        # negative count, so the loss scale matches the uniform default
        neg = labels == 0.0
        logits = torch.where(neg & (weights > 0),
                             adv_alpha * y_hat.detach(),
                             torch.full_like(y_hat, -torch.inf))
        n_neg = (weights * neg).sum()
        p_adv = torch.where(n_neg > 0, torch.softmax(logits, dim=0),
                            torch.zeros_like(logits))
        w_eff = torch.where(neg, p_adv * n_neg, weights)
    else:
        w_eff = weights
    loss = (bce * w_eff).sum() / torch.clamp(weights.sum(), min=1.0)
    return loss + tutils.regularization(model, l1, l2)


def loss_and_grads(model: MRGCN, batch: LPBatch, triples: torch.Tensor,
                   labels: torch.Tensor, weights: torch.Tensor,
                   adv_alpha: float = 0.0, l1: float = 0.0, l2: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   mesh=None) -> torch.Tensor:
    """The loss of :func:`lp_loss` for given corrupted triples, with its
    gradients left in the parameters' ``.grad``: under ``mesh`` this
    rank's share of them (1 / world of the loss), which the optimizer's
    step sums."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss = lp_loss(model, batch, triples, labels, weights, adv_alpha, l1,
                   l2, generator)
    (loss if mesh is None else loss / mesh.world).backward()
    return loss.detach()


@dataclass
class DeviceBatch:
    """A batch with its static triple and pool arrays on the device."""

    batch: LPBatch
    data: torch.Tensor
    pool: torch.Tensor


def to_device(batches: List[LPBatch], device) -> List[DeviceBatch]:
    return [DeviceBatch(b, torch.as_tensor(b.data, device=device),
                        torch.as_tensor(b.corrupt_pool, device=device))
            for b in batches]


def train_step(model: MRGCN, optimizer: tutils.ClippedAdam,
               dev_batch: DeviceBatch, corrupt, adv_alpha: float,
               l1: float, l2: float,
               generator: torch.Generator) -> torch.Tensor:
    """Corrupt, then one clipped Adam step; returns the loss (0-dim)."""
    b = dev_batch.batch
    triples, labels, weights = corrupt(dev_batch.data, b.num_triples,
                                       dev_batch.pool, b.num_pool,
                                       generator)
    loss = loss_and_grads(model, b, triples, labels, weights, adv_alpha,
                          l1, l2, generator, optimizer.mesh)
    optimizer.step()
    return loss


@torch.no_grad()
def embed(model: MRGCN, batch: LPBatch) -> torch.Tensor:
    """Evaluation-mode node embeddings of a batch's graph slice."""
    model.eval()
    return model(batch.edges, batch.features, train=False)


def _plan_fingerprint(datas: List[np.ndarray], num_valid: int,
                      mrr_batchsize: int) -> tuple:
    """Content hash of the inputs a cached RankPlan was built from."""
    return (int(num_valid), int(mrr_batchsize),
            tuple((d.shape, zlib.crc32(np.ascontiguousarray(d).tobytes()))
                  for d in datas))


def evaluate(batches: List[LPBatch], model: MRGCN, mrr_batchsize: int,
             filter_ranks: bool):
    """Per-subset ranking, averaged over subsets
    (reference: link_prediction.py:375-422).

    Triple subsets that share a graph slice (always, in full-graph mode,
    where every subset carries the same edges object) get one embedding
    pass and one stacked RankPlan; chunks never span subsets, so each
    subset keeps the reference's filter-against-its-own-facts and
    per-subset-mean semantics. All groups' ranking chunks are launched
    first, then fetched with one device-to-host copy. Plans are static
    across evaluations: they cache on the group's first batch."""
    relations = model.rgcn.relations.detach()
    mrr = {"raw": [], "flt": []}
    hits = {"raw": [[] for _ in K], "flt": [[] for _ in K]}
    rankings = {"raw": [], "flt": []}

    group_idx: dict = {}
    groups: list = []            # [(key, [batch index, ...])]
    for bi, b in enumerate(batches):
        key = (id(b.edges), b.num_valid)
        if key not in group_idx:
            group_idx[key] = len(groups)
            groups.append((key, []))
        groups[group_idx[key]][1].append(bi)

    pendings = []
    group_bounds = []
    for _, members in groups:
        b0 = batches[members[0]]
        emb = embed(model, b0)
        datas = [batches[bi].real_data
                 if batches[bi].num_triples else batches[bi].data
                 for bi in members]
        # any change to a member's facts, the candidate count or the
        # chunking rebuilds the plan
        fp = _plan_fingerprint(datas, b0.num_valid, mrr_batchsize)
        cached = b0.rank_plan
        if not (isinstance(cached, tuple) and len(cached) == 3
                and cached[2] == fp):
            plan, bounds = distmult.prepare_rank_chunks_many(
                datas, int(emb.shape[0]), chunk_size=mrr_batchsize,
                num_valid=b0.num_valid, device=emb.device)
            b0.rank_plan = cached = (plan, bounds, fp)
        plan, bounds, _ = cached
        group_bounds.append(bounds)
        pendings.append(distmult.launch_ranks_plan(plan, emb, relations))

    per_batch: list = [None] * len(batches)
    for (_, members), bounds, (raw_g, flt_g) in zip(
            groups, group_bounds, distmult.collect_many(pendings)):
        T = sum(n for _, n in bounds)
        for bi, (s, n) in zip(members, bounds):
            per_batch[bi] = (
                np.concatenate([raw_g[s:s + n], raw_g[T + s:T + s + n]]),
                np.concatenate([flt_g[s:s + n], flt_g[T + s:T + s + n]]))

    for raw, flt in per_batch:
        for rank_type, ranks in (("raw", raw), ("flt", flt)):
            if rank_type == "flt" and not filter_ranks:
                mrr[rank_type].append(-1)
                for i in range(len(K)):
                    hits[rank_type][i].append(-1)
                rankings[rank_type].append([-1])
                continue
            m, h = distmult.mrr_hits(ranks, K)
            mrr[rank_type].append(m)
            for i in range(len(K)):
                hits[rank_type][i].append(h[i])
            rankings[rank_type].append(list(ranks))

    out_mrr = {t: float(np.mean(v)) for t, v in mrr.items()}
    out_hits = {t: [float(np.mean(k)) for k in hits[t]] for t in hits}
    out_ranks = {t: [r for group in rankings[t] for r in group]
                 for t in rankings}
    return out_mrr, out_hits, out_ranks


def _metric_columns(mrr_d, hits_d) -> List:
    """The eight TSV columns of one split (-1 where it was not ranked)."""
    if mrr_d is None:
        return [-1] * 8
    return [str(mrr_d["raw"]), *(str(h) for h in hits_d["raw"]),
            str(mrr_d["flt"]), *(str(h) for h in hits_d["flt"])]


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class LPResult:
    model: MRGCN
    optimizer: tutils.ClippedAdam
    epoch: int
    loss: float
    mrr: Dict
    hits: Dict
    ranks: Dict
    # per epoch: epoch, loss, train/valid MRR (None when not ranked) and
    # the synchronised seconds of training and of evaluation
    history: List[Dict] = field(default_factory=list)
    test_seconds: float = 0.0
    # batch counts per split, fan-out rounds, and the seconds spent
    # building and moving the training (and validation) batches and the
    # test batches
    batches: Dict = field(default_factory=dict)


def run(artifact: Artifact, config: Dict, tsv_writer, featureless: bool,
        test_split: str, seed: int, device: torch.device,
        checkpoint: Optional[str] = None) -> LPResult:
    """Full training, periodic ranking and the final ranking of
    ``test_split`` on ``device``, from the state in ``checkpoint`` when
    one is given; writes the 26-column TSV."""
    header = ["epoch", "loss"]
    for split in ("train", "valid", "test"):
        header.extend([f"{split}_mrr_raw", f"{split}_H@1_raw",
                       f"{split}_H@3_raw", f"{split}_H@10_raw",
                       f"{split}_mrr_flt", f"{split}_H@1_flt",
                       f"{split}_H@3_flt", f"{split}_H@10_flt"])
    tsv_writer.writerow(header)

    task = config["task"]
    mesh = pmesh.mesh_from_config(config, device)

    inputs = prepare_inputs(artifact, config, featureless, device, mesh)
    featureless = inputs.featureless
    if mesh is not None:
        logger.info("Training under device mesh data=%d model=%d (rank %d)",
                    mesh.data, mesh.model, mesh.rank)

    data = {k: np.asarray(v) for k, v in artifact.data.items()}
    if test_split == "test":
        # merge train and valid for training (reference: lp.py:102-108)
        data["train"] = np.concatenate([data["train"], data["valid"]],
                                       axis=0)
        data["valid"] = None

    # the file is read before the model is built: its text-attention tree
    # picks the path the model is built with
    state = tutils.load_checkpoint(checkpoint) if checkpoint else None
    text_attn = tutils.reconcile_text_attn(state["params"]) \
        if state is not None and state["format"] != "torch" else None
    model = build_model(inputs, config, torch.Generator().manual_seed(seed),
                        text_attn=text_attn)
    if mesh is not None:
        pmesh.shard_params(mesh, model)
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config, featureless,
                                       mesh)
    epoch = 0
    if state is not None:
        print("[LOAD] Loading model state", end="")
        epoch = tutils.restore_checkpoint(model, optimizer, state)
        print(f" - {epoch} epoch")
    rng = torch.Generator(device=device).manual_seed(seed)

    nepoch = config["model"]["epoch"]
    eval_interval = task["eval_interval"]
    filter_ranks = task["filter_ranks"]
    gcn_batchsize = int(task.get("gcn_batchsize", -1))
    test_batchsize = int(task.get("test_batchsize", -1))
    mrr_batchsize = int(task.get("mrr_batchsize", -1))
    num_layers = len(model.hidden_dims)
    l1 = config["model"]["l1_lambda"]
    l2 = config["model"]["l2_lambda"]
    corrupt = make_corruptor(float(task.get("negative_sampling_ratio", 0.2)))
    adv_alpha = float(task.get("negative_adversarial_temperature", 0.0))
    patience = task["early_stopping"]["patience"]
    tolerance = task["early_stopping"]["tolerance"]
    early_stop = tutils.EarlyStop(patience, tolerance) \
        if patience > 0 else None

    # neighbour-sampled training batches: [task] neighbor_fanout caps each
    # hop's per-node expansion with importance-rescaled norms;
    # neighbor_fanout_rounds builds R independent samples cycled across
    # epochs. Only the train split samples: valid and test batches and the
    # final ranking always expand fully, so reported metrics stay exact.
    # Train MRR is computed on the sampled train batches (a training
    # estimator)
    fanout_cfg = task.get("neighbor_fanout")
    fanout = None
    if fanout_cfg not in (None, -1):
        num_train_nodes = len(np.union1d(data["train"][:, 0],
                                         data["train"][:, 2]))
        if 0 < gcn_batchsize < num_train_nodes:
            fanout = batching.normalize_fanout(fanout_cfg, num_layers)
        else:
            logger.warning("neighbor_fanout is ignored in full-graph LP "
                           "mode (set [task] gcn_batchsize below the "
                           "split's node count to enable sampling)")
    rounds = max(1, int(task.get("neighbor_fanout_rounds", 1))) \
        if fanout is not None else 1
    sample_rng = np.random.default_rng(seed)

    t_build = perf_counter()
    train_rounds = [make_lp_batches(inputs, data["train"], gcn_batchsize,
                                    test_batchsize, num_layers, fanout,
                                    sample_rng)
                    for _ in range(rounds)]
    train_batches = train_rounds[0]
    valid_batches = make_lp_batches(inputs, data["valid"], gcn_batchsize,
                                    test_batchsize, num_layers) \
        if data["valid"] is not None else []
    model.skip_encoders = tutils.dead_encoders(model)
    train_dev_rounds = [to_device(b, device) for b in train_rounds]
    train_dev = train_dev_rounds[0]
    _synchronize(device)
    batch_info = {"train": len(train_batches), "valid": len(valid_batches),
                  "rounds": rounds,
                  "build_seconds": perf_counter() - t_build}

    logger.info("Training for %d epoch (%d batch(es)) on %s", nepoch,
                len(train_batches), device)
    history: List[Dict] = []
    t0 = perf_counter()
    loss = 0.0
    final_epoch = epoch
    last = nepoch + epoch
    for ep in range(epoch + 1, last + 1):
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
            train_dev = train_dev_rounds[(ep - 1) % rounds]
        progress = tutils.BatchProgress(len(train_dev), label="TRAIN")
        losses = []
        for bi, dev_batch in enumerate(train_dev, 1):
            progress.update(bi)
            losses.append(train_step(model, optimizer, dev_batch, corrupt,
                                     adv_alpha, l1, l2, rng))
        progress.done()
        loss = float(torch.stack(losses).mean())
        _synchronize(device)
        train_seconds = perf_counter() - t_ep
        results_str = f"{ep:04d} | loss {loss:.4f}"

        t_eval = perf_counter()
        train_mrr = train_hits = valid_mrr = valid_hits = None
        if ep % eval_interval == 0 or ep == last:
            train_mrr, train_hits, _ = evaluate(
                train_batches, model, mrr_batchsize, filter_ranks)
            results_str += f" | train MRR {train_mrr['raw']:.4f} (raw)"
            if filter_ranks:
                results_str += f" / {train_mrr['flt']:.4f} (filtered)"

            if valid_batches and ep < last:
                valid_mrr, valid_hits, _ = evaluate(
                    valid_batches, model, mrr_batchsize, filter_ranks)
                results_str += f" | valid MRR {valid_mrr['raw']:.4f} (raw)"
                if filter_ranks:
                    results_str += f" / {valid_mrr['flt']:.4f} (filtered)"
                if early_stop is not None:
                    early_stop.record(1.0 - valid_mrr["raw"],
                                      (model.state_dict(),
                                       optimizer.state_dict()))
        logger.info(results_str)
        history.append({
            "epoch": ep, "loss": loss, "seconds": train_seconds,
            "eval_seconds": perf_counter() - t_eval,
            "train_mrr": None if train_mrr is None else train_mrr["raw"],
            "valid_mrr": None if valid_mrr is None else valid_mrr["raw"]})

        tsv_writer.writerow([str(ep), str(loss),
                             *_metric_columns(train_mrr, train_hits),
                             *_metric_columns(valid_mrr, valid_hits),
                             *[-1] * 8])   # test placeholder

    logger.info("Training time: %.2fs", perf_counter() - t0)

    # final test evaluation
    t0 = perf_counter()
    test_batches = make_lp_batches(inputs, data[test_split], gcn_batchsize,
                                   test_batchsize, num_layers)
    _synchronize(device)
    batch_info.update(test=len(test_batches),
                      test_build_seconds=perf_counter() - t0)
    test_mrr, test_hits, test_ranks = evaluate(
        test_batches, model, mrr_batchsize, filter_ranks)
    test_seconds = perf_counter() - t0
    logger.info("Testing time: %.2fs", test_seconds)
    tsv_writer.writerow([*[-1] * 18, *_metric_columns(test_mrr, test_hits)])

    return LPResult(model=model, optimizer=optimizer, epoch=final_epoch,
                    loss=loss, mrr=test_mrr, hits=test_hits,
                    ranks=test_ranks, history=history,
                    test_seconds=test_seconds, batches=batch_info)
