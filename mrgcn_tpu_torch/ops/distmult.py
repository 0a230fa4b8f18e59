"""DistMult scoring and full-entity ranking (PyTorch).

Counterpart of :mod:`mrgcn_tpu.ops.distmult` (reference:
mrgcn/tasks/link_prediction.py:557-665). The full-entity scores of a chunk
of facts are one matrix product:

    head prediction: scores[f, n] = <E[n], R[p_f] * E[o_f]>  = (R_p*E_o) @ E^T
    tail prediction: scores[f, n] = <E[s_f] * R[p_f], E[n]>  = (E_s*R_p) @ E^T

Evaluation semantics are the reference's, bit for bit:

  * optimistic rank + half-tie correction
    ``rank = #(scores > true) + round((ties - 1) / 2) + 1`` with
    round-half-to-even (``torch.round``);
  * filtered ranking sets known-true candidates (except the target) to
    ``-inf`` before ranking;
  * raw and filtered ranks come from the same score matrix, so a
    raw+filtered evaluation costs one scoring pass.

The score product is a plain f32 ``torch.matmul`` with TF32 off
(:mod:`mrgcn_tpu_torch.utils.device` pins it): a shorter mantissa turns
near-equal scores into exact ties and moves the tie-corrected ranks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def score(s_idx, p_idx, o_idx, node_embeddings, edge_embeddings):
    """Per-triple DistMult score ``sum_h E[s] R[p] E[o]``
    (reference: link_prediction.py:645-665).

    The rows are taken with ``index_select``, whose backward is an
    ``index_add_``: the backward of ``E[s]`` indexing sorts and walks
    duplicate indices one by one, and a batch names each of a few hundred
    relations thousands of times."""
    s = node_embeddings.index_select(0, s_idx)
    p = edge_embeddings.index_select(0, p_idx)
    o = node_embeddings.index_select(0, o_idx)
    return torch.sum(s * p * o, dim=-1)


def _chunk_ranks(data, node_embeddings, edge_embeddings, filter_fact,
                 filter_cand, num_valid: int, head: bool):
    """Ranks for one chunk of facts, raw and filtered, as int32 tensors.

    ``data``: (F, 3) int tensor (padded rows allowed, the caller slices the
    results). ``filter_fact``/``filter_cand``: (K,) known-true (fact,
    candidate) pairs to mask in filtered mode; pad entries hold the
    out-of-range fact row ``F`` and land in a dump row.
    """
    s_idx, p_idx, o_idx = (data[:, i].long() for i in range(3))
    F, N = data.shape[0], node_embeddings.shape[0]

    if head:
        part = edge_embeddings[p_idx] * node_embeddings[o_idx]   # (F, h)
        targets = s_idx
    else:
        part = node_embeddings[s_idx] * edge_embeddings[p_idx]
        targets = o_idx

    # one dump row past the chunk takes the filter pads
    buf = torch.empty(F + 1, N, dtype=torch.float32,
                      device=node_embeddings.device)
    scores = torch.matmul(part.float(), node_embeddings.float().T,
                          out=buf[:F])
    # mini-batch ranking: rows beyond the batch's real node count are
    # padding, never candidates
    if num_valid < N:
        scores[:, num_valid:] = -torch.inf
    true_scores = scores.gather(1, targets[:, None])

    def ranks_of(sc):
        greater = (sc > true_scores).sum(dim=1)
        ties = (sc == true_scores).sum(dim=1)
        # optimistic rank + half-tie correction, round half to even
        # (reference: link_prediction.py:632-638)
        half = torch.round((ties - 1).to(torch.float32) / 2.0)
        return (greater + half.to(greater.dtype) + 1).to(torch.int32)

    raw = ranks_of(scores)
    buf[F] = 0.0
    buf[filter_fact.long(), filter_cand.long()] = -torch.inf
    flt = ranks_of(scores)
    return raw, flt


def truedicts(facts: np.ndarray) -> Tuple[Dict, Dict]:
    """(p, o) -> true heads and (s, p) -> true tails
    (reference: link_prediction.py:576-591)."""
    heads: Dict[Tuple[int, int], List[int]] = {}
    tails: Dict[Tuple[int, int], List[int]] = {}
    for s, p, o in np.asarray(facts).tolist():
        heads.setdefault((p, o), []).append(s)
        tails.setdefault((s, p), []).append(o)
    return heads, tails


def _filter_pairs(data: np.ndarray, heads: Dict, tails: Dict,
                  head: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Known-true (fact_row, candidate) pairs excluding the target itself
    (reference: link_prediction.py:557-573)."""
    fact_rows: List[int] = []
    cands: List[int] = []
    for i, (s, p, o) in enumerate(np.asarray(data).tolist()):
        if head:
            for si in heads.get((p, o), ()):
                if si != s:
                    fact_rows.append(i)
                    cands.append(si)
        else:
            for oi in tails.get((s, p), ()):
                if oi != o:
                    fact_rows.append(i)
                    cands.append(oi)
    return (np.asarray(fact_rows, dtype=np.int32),
            np.asarray(cands, dtype=np.int32))


class PendingRanks:
    """Ranking chunks that were launched and not yet fetched.

    ``parts``: ``(meta, raw_stack, flt_stack)`` per direction, the stacks
    ``(C, chunk_size)`` int32 tensors on the device, ``meta`` rows
    ``(out_begin, valid_len, row)`` (padding past ``valid_len`` is dropped
    at collection). ``num_facts`` is the per-direction fact count; outputs
    are laid out ``[tail ranks, head ranks]`` (the reference iterates head
    in [False, True]).
    """

    def __init__(self, parts, num_facts: int):
        self.parts = parts
        self.num_facts = num_facts


class RankPlan:
    """Host-prepared, device-resident ranking chunks for a static fact
    set: built once, reused across evaluation epochs. It saves, per
    evaluation, the Python ``truedicts``/``_filter_pairs`` walk over all
    facts and the per-chunk copies to the device: the plan uploads three
    stacked arrays and chunks index them on the device."""

    def __init__(self, chunk_meta, chunk_dev, ff_dev, fc_dev,
                 num_facts: int, num_valid: int):
        self.chunk_meta = chunk_meta   # [(out_begin, valid, idx, head)]
        self.chunk_dev = chunk_dev     # (C, chunk_size, 3) int32
        self.ff_dev = ff_dev           # (C, Bk) int32
        self.fc_dev = fc_dev           # (C, Bk) int32
        self.num_facts = num_facts
        self.num_valid = num_valid


def _chunk_size(hint: int, longest: int, num_nodes: int,
                budget_elems: int) -> int:
    """Chunking only bounds the (chunk, N) score matrix and results do not
    depend on it, so the caller's hint (the reference's ``mrr_batchsize``
    memory knob) grows until the score matrix fills ``budget_elems``
    (default 256 MiB of f32 scores): fewer, larger launches."""
    if hint <= 0:
        hint = longest
    return min(max(longest, 1), max(hint, budget_elems // max(num_nodes, 1)))


def _stack_plan(chunk_meta, chunk_np, filt, chunk_size: int,
                num_facts: int, num_valid: int, device) -> RankPlan:
    """One common filter-pair bucket across chunks (a rectangular stack);
    pads point at the out-of-range fact row ``chunk_size``."""
    bucket = max(64, 1 << int(np.ceil(np.log2(
        max(max((len(ff) for ff, _ in filt), default=1), 1)))))
    ff_np = np.full((len(filt), bucket), chunk_size, dtype=np.int32)
    fc_np = np.zeros((len(filt), bucket), dtype=np.int32)
    for i, (ff, fc) in enumerate(filt):
        ff_np[i, :len(ff)] = ff
        fc_np[i, :len(fc)] = fc
    chunks = np.stack(chunk_np) if chunk_np else \
        np.zeros((0, max(chunk_size, 1), 3), np.int32)
    return RankPlan(chunk_meta, torch.as_tensor(chunks, device=device),
                    torch.as_tensor(ff_np, device=device),
                    torch.as_tensor(fc_np, device=device), num_facts,
                    int(num_valid))


def _chunks_of(d: np.ndarray, heads: Dict, tails: Dict, head: bool,
               chunk_size: int, out_begin: int, chunk_meta, chunk_np,
               filt) -> None:
    """Append ``d``'s chunks for one direction, each padded to the common
    chunk size, with their filter pairs."""
    num_facts = d.shape[0]
    for begin in range(0, num_facts, chunk_size):
        end = min(begin + chunk_size, num_facts)
        chunk = d[begin:end]
        pad = chunk_size - (end - begin)
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad, 3), dtype=chunk.dtype)])
        chunk_meta.append((out_begin + begin, end - begin, len(chunk_np),
                           head))
        chunk_np.append(chunk.astype(np.int32))
        filt.append(_filter_pairs(d[begin:end], heads, tails, head))


def prepare_rank_chunks_many(datas: List[np.ndarray], num_nodes: int,
                             chunk_size: int = 0,
                             num_valid: Optional[int] = None,
                             budget_elems: int = 2 ** 26, device=None
                             ) -> Tuple[RankPlan, List[Tuple[int, int]]]:
    """Host side of ranking for many fact subsets that share one embedding
    space: per-subset chunking and filter pairs (chunks never span subsets,
    so each subset keeps the reference's filter-against-its-own-facts
    semantics), stacked into one :class:`RankPlan`.

    Returns ``(plan, boundaries)``; ``boundaries[i] = (start, n)`` is
    subset ``i``'s fact range within each direction of the plan's output
    layout ``[all tails | all heads]``.
    """
    datas = [np.asarray(d) for d in datas]
    total = sum(d.shape[0] for d in datas)
    longest = max((d.shape[0] for d in datas), default=0)
    chunk_size = _chunk_size(chunk_size, longest, num_nodes, budget_elems)
    per_subset = [truedicts(d) for d in datas]

    boundaries: List[Tuple[int, int]] = []
    start = 0
    for d in datas:
        boundaries.append((start, d.shape[0]))
        start += d.shape[0]

    chunk_meta: list = []
    chunk_np: list = []
    filt: list = []
    for head in (False, True):
        for d, (heads, tails), (sub_start, _) in zip(datas, per_subset,
                                                     boundaries):
            _chunks_of(d, heads, tails, head, chunk_size,
                       head * total + sub_start, chunk_meta, chunk_np, filt)
    nv = num_nodes if num_valid is None else num_valid
    return _stack_plan(chunk_meta, chunk_np, filt, chunk_size, total, nv,
                       device), boundaries


def prepare_rank_chunks(data: np.ndarray, num_nodes: int,
                        chunk_size: int = 0,
                        true_facts: Optional[np.ndarray] = None,
                        num_valid: Optional[int] = None,
                        budget_elems: int = 2 ** 26,
                        device=None) -> RankPlan:
    """Host side of :func:`launch_ranks`: chunking, filter pairs, padding
    and one batched upload. ``true_facts`` overrides the fact set the
    filter pairs come from (defaults to ``data``)."""
    if true_facts is None:
        return prepare_rank_chunks_many(
            [data], num_nodes, chunk_size=chunk_size, num_valid=num_valid,
            budget_elems=budget_elems, device=device)[0]
    data = np.asarray(data)
    num_facts = data.shape[0]
    chunk_size = _chunk_size(chunk_size, num_facts, num_nodes, budget_elems)
    heads, tails = truedicts(true_facts)
    chunk_meta: list = []
    chunk_np: list = []
    filt: list = []
    for head in (False, True):
        _chunks_of(data, heads, tails, head, chunk_size, head * num_facts,
                   chunk_meta, chunk_np, filt)
    nv = num_nodes if num_valid is None else num_valid
    return _stack_plan(chunk_meta, chunk_np, filt, chunk_size, num_facts,
                       nv, device)


@torch.no_grad()
def launch_ranks_plan(plan: RankPlan, node_embeddings,
                      edge_embeddings) -> PendingRanks:
    """Rank every chunk of a prepared :class:`RankPlan`, tail direction
    then head direction, without fetching anything to the host (on a card
    the launches are asynchronous)."""
    C = int(plan.chunk_dev.shape[0])
    if C == 0:
        return PendingRanks([], plan.num_facts)
    C2 = C // 2   # prepare emits all tail-direction chunks, then head
    parts = []
    for head, sl in ((False, range(0, C2)), (True, range(C2, C))):
        meta = [(ob, v, i - sl.start)
                for ob, v, i, h in plan.chunk_meta if h == head]
        ranks = [_chunk_ranks(plan.chunk_dev[c], node_embeddings,
                              edge_embeddings, plan.ff_dev[c],
                              plan.fc_dev[c], plan.num_valid, head)
                 for c in sl]
        parts.append((meta, torch.stack([r for r, _ in ranks]),
                      torch.stack([f for _, f in ranks])))
    return PendingRanks(parts, plan.num_facts)


def launch_ranks(data: np.ndarray, node_embeddings, edge_embeddings,
                 chunk_size: int = 0,
                 true_facts: Optional[np.ndarray] = None,
                 num_valid: Optional[int] = None,
                 budget_elems: int = 2 ** 26) -> PendingRanks:
    """:func:`prepare_rank_chunks` + :func:`launch_ranks_plan` for one fact
    set (``compute_ranks_fast``, reference: link_prediction.py:593-643):
    output layout ``[tail ranks, head ranks]``, ranks 1-based.
    ``chunk_size <= 0`` scores all facts in one chunk (within the budget).
    Repeat callers over the same facts prepare once and launch per
    evaluation."""
    plan = prepare_rank_chunks(
        data, int(node_embeddings.shape[0]), chunk_size=chunk_size,
        true_facts=true_facts, num_valid=num_valid,
        budget_elems=budget_elems, device=node_embeddings.device)
    return launch_ranks_plan(plan, node_embeddings, edge_embeddings)


def collect_many(pendings: List[PendingRanks]
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Materialise many :class:`PendingRanks` with one device-to-host
    copy: every chunk's (raw, flt) pair is concatenated on the device and
    fetched at once."""
    all_dev = [t.reshape(-1) for p in pendings for _, raw, flt in p.parts
               for t in (raw, flt)]
    if not all_dev:
        return [(np.zeros(0, np.int64), np.zeros(0, np.int64))
                for _ in pendings]
    flat = torch.cat(all_dev).cpu().numpy()

    results = []
    pos = 0
    for p in pendings:
        raw_out = np.empty(p.num_facts * 2, dtype=np.int64)
        flt_out = np.empty(p.num_facts * 2, dtype=np.int64)
        for meta, raw, flt in p.parts:
            C, csize = raw.shape
            raw_np = flat[pos:pos + C * csize].reshape(C, csize)
            pos += C * csize
            flt_np = flat[pos:pos + C * csize].reshape(C, csize)
            pos += C * csize
            for out_begin, valid, row in meta:
                raw_out[out_begin:out_begin + valid] = raw_np[row, :valid]
                flt_out[out_begin:out_begin + valid] = flt_np[row, :valid]
        results.append((raw_out, flt_out))
    return results


def compute_ranks(data: np.ndarray, node_embeddings, edge_embeddings,
                  chunk_size: int = 0,
                  true_facts: Optional[np.ndarray] = None,
                  num_valid: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Raw + filtered ranks for head and tail prediction over all facts:
    :func:`launch_ranks` and a blocking collect."""
    return collect_many([launch_ranks(
        data, node_embeddings, edge_embeddings, chunk_size=chunk_size,
        true_facts=true_facts, num_valid=num_valid)])[0]


def mrr_hits(ranks: np.ndarray, K=(1, 3, 10)) -> Tuple[float, List[float]]:
    """Mean reciprocal rank and hits@K for a rank vector."""
    ranks = np.asarray(ranks, dtype=np.float64)
    mrr = float(np.mean(1.0 / ranks))
    hits = [float(np.mean(ranks <= k)) for k in K]
    return mrr, hits
