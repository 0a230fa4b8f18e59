"""Multi-device training: one process per device over ``torch.distributed``.

Counterpart of :mod:`mrgcn_tpu.parallel.mesh`. The JAX package runs one
program over a ``(data, model)`` device mesh from a single process; here
every device has its own process (a rank), started by :func:`launch`, and
the collectives are explicit (:mod:`.collectives`). Rank ``r`` sits at
``(r // model, r % model)`` of the mesh, as the JAX package lays its
devices out. The layout follows the JAX package's shardings:

* **edge arrays** (``src``/``dst``/``rel``/``norm``) are padded to a
  multiple of ``data`` (:func:`pad_edges_for_mesh`) and split in
  contiguous blocks over ``data``, the grouped layout by whole groups
  (padded likewise, so its count divides, as in the JAX package once it
  pads); the sorted-stream
  plans are built for the rank's round-robin share of the edges alone
  (:func:`..ops.relational.shard_layer_plans`). Each layer runs the
  single-device engine on its share and sums the partial aggregates over
  ``data`` (:func:`..models.rgcn.RGCNLayer`);
* **feature rows** are split over ``data`` where their count divides
  (:func:`shard_features`): each rank encodes its rows, and the outputs are
  all-gathered before placement, so the node matrix is the same on every
  rank (:class:`..models.mrgcn.MRGCN`);
* **parameters** are replicated, except the basis axis of the R-GCN
  weights (``weight_i``, ``weight_i_packed``, ``weight_f``), which is
  split over ``model`` where it divides (:func:`shard_params`); a layer
  all-gathers the slices before use;
* **node embeddings, logits, losses** are replicated.

Gradients: each rank's loss is scaled by 1 / world, so each rank holds a
share of every gradient; :func:`reduce_gradients` sums a replicated
parameter's shares over the world and a basis slice's over its ``data``
group. Mini-batches and node-sliced LP batches are replicated on every
rank, as the JAX package replicates its bucketed mini-batch programs.

The spec is the JAX package's (:func:`mesh_spec`): ``MRGCN_MESH`` first,
then ``[task] mesh``; ``""``, ``"0"``, ``"1"``, ``"none"``, ``"off"`` ask
for one device, ``"N"`` for ``data = N``, ``"DxM"`` for ``data = D, model
= M``, ``"auto"`` for every visible card (on the CPU: one process).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mrgcn_tpu_torch.models.rgcn import EdgeBlock
from mrgcn_tpu_torch.parallel import collectives as coll

# specs that ask for no mesh (one device)
NO_MESH = ("", "0", "1", "none", "off")
# R-GCN weights whose leading (basis) axis is split over ``model``
BASIS_WEIGHTS = ("weight_i", "weight_i_packed", "weight_f")
# seconds a collective or the rendezvous may wait, and the default limit
# on a whole world's wall time
TIMEOUT = 600


def mesh_spec(config: Dict) -> str:
    """The mesh spec as the JAX package reads it: ``MRGCN_MESH`` first,
    then ``[task] mesh``, stripped and lower-cased."""
    spec = os.environ.get("MRGCN_MESH") \
        or config.get("task", {}).get("mesh", "")
    return str(spec).strip().lower()


def mesh_shape(spec: str, cards: Optional[int] = None
               ) -> Optional[Tuple[int, int]]:
    """``(data, model)`` of a spec, or None for one device. ``cards`` is
    the number of visible cards (None on the CPU): ``"auto"`` takes them
    all, and on the CPU one process, as the JAX package's ``"auto"`` takes
    the one device of its default CPU backend; a spec asking for more
    ranks than there are cards raises."""
    if spec in NO_MESH:
        return None
    if spec == "auto":
        if cards is None:
            return None
        data, model = cards, 1
    else:
        try:
            parts = [int(p) for p in spec.split("x", 1)]
        except ValueError:
            raise ValueError(f"mesh {spec!r} is not 'auto', 'N' or "
                             "'DxM'") from None
        data, model = parts if len(parts) == 2 else (parts[0], 1)
    if data < 1 or model < 1:
        raise ValueError(f"mesh {spec!r}: data {data} and model {model} "
                         "must be at least 1")
    if cards is not None and data * model > cards:
        raise ValueError(f"mesh {spec!r} asks for {data * model} ranks, "
                         f"one a card; {cards} card(s) are visible")
    return data, model


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``(data, model)`` mesh: the process groups
    of the ranks that share its model index (``data_group``, over which
    shards sum) and its data index (``model_group``, over which basis
    slices gather), its device and the backend."""

    data: int
    model: int
    rank: int
    data_group: object
    model_group: object
    device: torch.device
    backend: str

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


# this process's data and model groups by mesh shape: a world creates its
# groups once, since ``new_group`` is a collective that every rank must
# call in the same order and each group holds a communicator
_GROUPS: Dict[Tuple[int, int], Tuple[object, object]] = {}


def _groups(data: int, model: int, rank: int) -> Tuple[object, object]:
    """The data and model groups holding ``rank``; every rank creates
    every group, in the same order, once per world."""
    if (data, model) not in _GROUPS:
        mine = {}
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                mine["data"] = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                mine["model"] = g
        _GROUPS[(data, model)] = (mine["data"], mine["model"])
    return _GROUPS[(data, model)]


def mesh_from_config(config: Dict, device: torch.device) -> Optional[Mesh]:
    """The mesh the config asks for, in the world this process is a rank
    of, or None for one device. A spec with no world around it (a task's
    ``run`` called directly, not through ``python -m mrgcn_tpu_torch.run``
    or :func:`launch`) or with another number of ranks raises."""
    spec = mesh_spec(config)
    if spec in NO_MESH or (spec == "auto" and device.type == "cpu"):
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {spec!r} trains one process per device; this process "
            "is in no torch.distributed world (python -m "
            "mrgcn_tpu_torch.run starts one, parallel.mesh.launch in a "
            "program)")
    world = dist.get_world_size()
    data, model = mesh_shape(spec, cards=world if spec == "auto" else None)
    if data * model != world:
        raise ValueError(f"mesh {spec!r} asks for {data * model} ranks; "
                         f"the world has {world}")
    rank = dist.get_rank()
    data_group, model_group = _groups(data, model, rank)
    return Mesh(data=data, model=model, rank=rank, data_group=data_group,
                model_group=model_group, device=device,
                backend=str(dist.get_backend()))


# --------------------------------------------------------------------------
# the world: one process per device
# --------------------------------------------------------------------------

def _rank_main(rank: int, world: int, backend: str, device: str,
               port: int, work, results) -> None:
    try:
        fn, args = work.get()
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        wait = timedelta(seconds=TIMEOUT)
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=wait)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=wait)
        # every rank is up before the work starts (on NCCL, a collective
        # on the card)
        dist.barrier(**({"device_ids": [dev.index or 0]}
                        if backend == "nccl" else {}))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def launch(fn: Callable, world: int, backend: str,
           devices: Sequence, args: tuple = (),
           timeout: Optional[float] = TIMEOUT) -> List:
    """Run ``fn(rank, *args)`` in ``world`` new processes (``spawn``), one
    a device, joined in one ``torch.distributed`` world over ``backend``
    (``"nccl"``: one card a rank; ``"gloo"``: CPU processes, or CUDA ranks
    sharing a card). ``devices[rank]`` is rank ``rank``'s device. The
    caller names both: nothing here picks a backend, a device or a rank
    count. The rendezvous store listens on a free port of 127.0.0.1 in
    this process. Returns the ranks' return values in rank order. A rank
    that raises, exits without a result or outlasts ``timeout`` seconds
    stops every rank, and this raises with that rank's error;
    ``timeout=None`` sets no limit on the world (a training run), and a
    rank that hangs in a collective or the rendezvous then fails after
    ``TIMEOUT`` seconds of waiting there."""
    import torch.multiprocessing as mp
    if len(devices) != world:
        raise ValueError(f"{len(devices)} device(s) for {world} rank(s)")
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=TIMEOUT))
    ctx = mp.get_context("spawn")
    results, work = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, backend, str(devices[rank]),
                               store.port, work, results))
             for rank in range(world)]
    # the work goes through a queue: a start whose arguments fill the
    # pipe would wait for that rank to import its way to reading them
    for p in procs:
        p.start()
        work.put((fn, args))
    out: Dict[int, object] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                for rank, p in enumerate(procs):
                    if rank not in out and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {rank} of {world} exited "
                                           f"with code {p.exitcode}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world} rank(s) "
                                       f"outlasted {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(TIMEOUT)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        _stop(procs)
    return [out[r] for r in range(world)]


# --------------------------------------------------------------------------
# parameters: basis slices over ``model``
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class BasisSlice:
    """Marks a parameter that holds slice ``index`` of ``count`` of its
    basis axis; the full tensor gathers over ``group``."""

    group: object
    index: int
    count: int


def basis_slice(p: torch.Tensor) -> Optional[BasisSlice]:
    return getattr(p, "basis_slice", None)


def full_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole parameter ``p`` is a slice of (or its own)."""
    s = basis_slice(p)
    shape = tuple(p.shape)
    return shape if s is None else (shape[0] * s.count,) + shape[1:]


def share_of(p: torch.Tensor, full):
    """This rank's slice of ``full`` (a tensor or an array of the whole
    parameter's shape) where ``p`` is a basis slice, else ``full``."""
    s = basis_slice(p)
    if s is None:
        return full
    per = full.shape[0] // s.count
    return full[s.index * per:(s.index + 1) * per]


@torch.no_grad()
def whole(p: torch.Tensor, value: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``value`` (default: ``p`` itself), a tensor shaped like the basis
    slice ``p``, gathered to the whole parameter's shape; unchanged for
    any other parameter. Every rank of the model group must call it."""
    value = p.detach() if value is None else value
    s = basis_slice(p)
    return value if s is None else coll.gather_rows(value, s.group)


def sliced_on(mesh: Mesh, name: str, shape) -> bool:
    """Whether a parameter ``name`` of ``shape`` is split over ``model``:
    an R-GCN basis weight whose basis count divides."""
    return (name.rsplit(".", 1)[-1] in BASIS_WEIGHTS and mesh.model > 1
            and shape[0] % mesh.model == 0)


def shard_params(mesh: Mesh, model: nn.Module) -> None:
    """Replace each R-GCN basis weight that :func:`sliced_on` splits by
    this rank's slice of it (tagged with :class:`BasisSlice`), and give
    the model its mesh. Call before the optimizer is built."""
    for name, p in list(model.named_parameters()):
        if not sliced_on(mesh, name, p.shape):
            continue
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        per = p.shape[0] // mesh.model
        part = nn.Parameter(
            p.detach()[mesh.model_rank * per:
                       (mesh.model_rank + 1) * per].clone())
        part.basis_slice = BasisSlice(mesh.model_group, mesh.model_rank,
                                      mesh.model)
        setattr(owner, leaf, part)
    model.mesh = mesh


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every basis slice gathered to its whole
    weight, as a single-device model holds it. Collective over ``model``."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        if basis_slice(p) is not None:
            sd[name] = whole(p)
    return sd


def reduce_gradients(mesh: Mesh, params: Sequence[torch.Tensor]) -> None:
    """Sum the ranks' gradient shares in place: a replicated parameter's
    over the world, a basis slice's over its ``data`` group, one flat
    all-reduce each. Parameters without a gradient (a skipped encoder,
    the same on every rank) stay without."""
    for sliced, group in ((False, dist.group.WORLD),
                          (True, mesh.data_group)):
        grads = [p.grad for p in params if p.grad is not None
                 and (basis_slice(p) is not None) == sliced]
        if not grads:
            continue
        flat = coll.all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                                group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def grad_norm(mesh: Mesh, params: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global 2-norm of the summed gradients, the same on every rank:
    ``torch.nn.utils.get_total_norm`` of the replicated parameters' and,
    where basis slices exist, their squares summed over ``model`` (each
    slice counted once). Without slices it is what ``clip_grad_norm_``
    takes, to the bit."""
    def norm(sliced):
        grads = [p.grad for p in params if p.grad is not None
                 and (basis_slice(p) is not None) == sliced]
        return nn.utils.get_total_norm(grads) if grads \
            else torch.zeros((), device=mesh.device)

    total = norm(False)
    if mesh.model == 1:
        return total
    return (total.square()
            + coll.all_reduce_(norm(True).square(), mesh.model_group)).sqrt()


# --------------------------------------------------------------------------
# inputs: edges, plans and feature rows over ``data``
# --------------------------------------------------------------------------

def rows_split(mesh: Mesh, n: int) -> bool:
    """Whether ``n`` feature rows split over ``data``: the JAX package
    shards them when the count divides, else replicates them. Over one
    data rank they split (into one block) only where the collectives of
    a group of one go through the backend (``coll.ONE_RANK_PASSES``)."""
    return (mesh.data > 1 or not coll.ONE_RANK_PASSES) and n > 0 \
        and n % mesh.data == 0


def _share(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    per = x.shape[0] // mesh.data
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def _pad_1d(x: torch.Tensor, target: int, value) -> torch.Tensor:
    pad = target - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full((pad,), value)])


def pad_edges_for_mesh(edges: EdgeBlock, data_size: int) -> EdgeBlock:
    """Pad the edge arrays (and whole relation groups) so each divides over
    ``data``; padding carries ``norm == 0`` and ``src == num_out``, which
    the segment sums drop. The plans are left out, as in the JAX
    package."""
    E = edges.src.shape[0]
    target = -(-E // data_size) * data_size
    kw = dict(src=_pad_1d(edges.src, target, edges.num_out),
              dst=_pad_1d(edges.dst, target, 0),
              rel=_pad_1d(edges.rel, target, 0),
              norm=_pad_1d(edges.norm, target, 0.0),
              num_out=edges.num_out, num_in=edges.num_in,
              dst_global=(None if edges.dst_global is None else
                          _pad_1d(edges.dst_global, target, 0)),
              group_size=edges.group_size, plans=None)
    if edges.grouped:
        G = edges.group_rel.shape[0]
        Gt = -(-G // data_size) * data_size
        gs = edges.group_size
        kw.update(grp_src=_pad_1d(edges.grp_src, Gt * gs, edges.num_out),
                  grp_dst=_pad_1d(edges.grp_dst, Gt * gs, 0),
                  grp_norm=_pad_1d(edges.grp_norm, Gt * gs, 0.0),
                  group_rel=_pad_1d(edges.group_rel, Gt, 0))
    return EdgeBlock(**kw)


def shard_edges(mesh: Mesh, edges: EdgeBlock,
                plans: Optional[dict] = None) -> EdgeBlock:
    """This rank's block of the edge arrays and of the relation groups
    (their counts must divide over ``data``: :func:`pad_edges_for_mesh`
    pads both), with ``plans`` (this rank's sorted streams). The block
    carries the mesh: its layers sum over ``data``."""
    groups = edges.group_rel.shape[0] if edges.grouped else 0
    if edges.src.shape[0] % mesh.data or groups % mesh.data:
        raise ValueError(f"{edges.src.shape[0]} edges or {groups} groups "
                         f"do not divide over data = {mesh.data}; pad "
                         "them first")
    grp = {name: _share(mesh, getattr(edges, name))
           for name in ("grp_src", "grp_dst", "grp_norm", "group_rel")
           if edges.grouped}
    return dataclasses.replace(
        edges, src=_share(mesh, edges.src), dst=_share(mesh, edges.dst),
        rel=_share(mesh, edges.rel), norm=_share(mesh, edges.norm),
        dst_global=(None if edges.dst_global is None
                    else _share(mesh, edges.dst_global)),
        plans=plans, mesh=mesh, **grp)


def shard_restricted_block(mesh: Mesh, block: EdgeBlock) -> EdgeBlock:
    """A frontier-restricted block (:func:`..tasks.common.
    restricted_layer_edges`) on the mesh: padded and split over ``data``,
    keeping its plans, which were built for this rank's share."""
    return shard_edges(mesh, pad_edges_for_mesh(block, mesh.data),
                       plans=block.plans)


def shard_features(mesh: Mesh, features: Dict) -> Dict:
    """Each encoder's ``(data, node_idx, rows)`` with ``data`` cut to this
    rank's block of rows where the row count divides over ``data``
    (:func:`rows_split`), else whole. ``node_idx`` and the placement map
    stay whole: the encoder outputs are all-gathered before placement, so
    an entry whose ``data`` holds fewer rows than ``node_idx`` is a
    share."""
    return {name: ((_share(mesh, data) if rows_split(mesh, data.shape[0])
                    else data), *rest)
            for name, (data, *rest) in features.items()}


def shard_inputs(mesh: Mesh, inputs):
    """A :class:`..tasks.common.RunInputs` on the mesh: the full-graph edge
    block padded and split over ``data`` with its plans (built for this
    rank's share by ``prepare_inputs``), and the feature rows split over
    ``data``. The host copies stay whole: mini-batches cut from them run
    replicated on every rank."""
    edges = shard_edges(mesh, pad_edges_for_mesh(inputs.edges, mesh.data),
                        plans=inputs.edges.plans)
    return dataclasses.replace(inputs, edges=edges,
                               features=shard_features(mesh,
                                                       inputs.features))
