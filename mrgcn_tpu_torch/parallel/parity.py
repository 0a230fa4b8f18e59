"""Mesh runs held against single-device runs: the work one rank does.

The tests (on CPU processes over gloo) and ``chip_smoke.py`` (ranks on
the card) start worlds with :func:`..parallel.mesh.launch` and hand each
rank one of the workers below; the same functions with no mesh give the
single-device run to compare with. A worker lives here, in the port, so a
rank imports neither ``jax`` nor the JAX package. Arrays travel as numpy.

* :func:`first_step`: the task's own assembly (inputs, model, optimizer,
  the first batch), optionally from given parameters (the JAX package's
  tree, through the weight bridge) or a checkpoint, then one loss and its
  gradients summed over the ranks, each whole (basis slices gathered),
  the running statistics after it, and the eval-mode output;
* :func:`train`: the task's own ``run``, with the epochs' losses
  and times, the launches of every kernel wrapper, the bytes handed to
  the collectives per step, the card's peak memory, and a digest of the
  whole trained state;
* :func:`layers`: an R-GCN on a small graph, forward and gradients.

A world's job names its mesh spec in its config (``[task] mesh``); a
single-device job has none. A job with ``one_rank_collectives`` sends the
collectives of groups of one rank through the backend
(``collectives.ONE_RANK_PASSES``), so that a world of one rank runs
every collective its training runs.
"""

from __future__ import annotations

import copy
import hashlib
from contextlib import contextmanager
from time import perf_counter
from typing import Dict, Optional

import numpy as np
import torch

from mrgcn_tpu_torch.data import artifact as artifact_io
from mrgcn_tpu_torch.data.tsv import TSV
from mrgcn_tpu_torch.models.rgcn import RGCN, EdgeBlock
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.parallel import collectives as coll
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.tasks import link_prediction as lp
from mrgcn_tpu_torch.tasks import node_classification as nc
from mrgcn_tpu_torch.tasks import utils as tutils
from mrgcn_tpu_torch.tasks.common import prepare_inputs
from mrgcn_tpu_torch.tasks.jax_import import is_batch_stat, load_jax_params
from mrgcn_tpu_torch.utils.device import select_device


# a wrapper's counts beside ``launches``: launches on the scatters'
# row-segmented kernels, the attention kernels' launches with several heads
SUB_COUNTS = {"launches_rows": "rows", "launches_heads": "heads"}


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches (and
    the ``SUB_COUNTS`` beside it where it has them)."""
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops import compose_kernels as ck
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    return {"sorted_scatter": ss.sorted_scatter,
            "sorted_gather": ss.sorted_gather,
            "fused_place_scatter": ss.fused_place_scatter,
            "fused_scatter_dot": ss.fused_scatter_dot,
            "compose_grad_pass": ss.compose_grad_pass,
            "compose_table": ck.compose_table,
            "canonical_copy": ck.canonical_copy,
            "attention_fwd": att.attention_fwd,
            "attention_bwd": att.attention_bwd,
            "mlp_fwd": fm.mlp_fwd, "mlp_bwd": fm.mlp_bwd}


def reset_launches(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        for attr in SUB_COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_launches(counters: dict) -> dict:
    """``{name: launches}``, and ``{name}.rows`` / ``{name}.heads`` for
    the wrappers with those counts."""
    out = {}
    for name, fn in counters.items():
        out[name] = fn.launches
        for attr, suffix in SUB_COUNTS.items():
            if hasattr(fn, attr):
                out[f"{name}.{suffix}"] = getattr(fn, attr)
    return out


def with_mesh(config: Dict, spec: Optional[str]) -> Dict:
    """A copy of ``config`` whose ``[task] mesh`` is ``spec`` (None: no
    mesh)."""
    config = copy.deepcopy(config)
    config["task"].pop("mesh", None)
    if spec is not None:
        config["task"]["mesh"] = spec
    return config


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def whole_grads(model) -> Dict[str, np.ndarray]:
    """Each parameter's (summed) gradient with basis slices gathered."""
    return {name: _numpy(pmesh.whole(p, p.grad))
            for name, p in model.named_parameters() if p.grad is not None}


def state_digest(model) -> str:
    """sha256 of the whole trained state (parameters and running
    statistics, basis slices gathered), in name order."""
    h = hashlib.sha256()
    for name, t in sorted(pmesh.full_state_dict(model).items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(_numpy(t)).tobytes())
    return h.hexdigest()


def batch_stats(model) -> Dict[str, np.ndarray]:
    return {name: _numpy(t) for name, t in model.state_dict().items()
            if is_batch_stat(name)}


@contextmanager
def _image_body(job: Dict):
    """With ``job['image_f64']``, models built inside take the image CNN
    in f64, parameters and body: its twin in which the ranks' other order
    of sums leaves no ReLU input on the other side of zero (in f32 one
    such input can move a gradient by percents; in bf16 batch statistics
    drift by bf16 steps)."""
    if not job.get("image_f64"):
        yield
        return
    from mrgcn_tpu_torch.models import encoders, mrgcn

    def f64_cnn(*args, **kwargs):
        return encoders.ImageCNN(*args, **{**kwargs,
                                           "dtype": torch.float64}).double()

    mrgcn.ImageCNN = f64_cnn
    try:
        yield
    finally:
        mrgcn.ImageCNN = encoders.ImageCNN


def _setup(job: Dict, device, mesh):
    """The assembly of ``job`` as its task's ``run`` makes it: inputs,
    model (on the mesh), optimizer, and its parameters from
    ``job['params']`` (with ``job['batch_stats']``) or
    ``job['checkpoint']``."""
    config, task = job["config"], job["task"]
    seed = job.get("seed", 0)
    art = artifact_io.load(job["artifact"])
    featureless = job.get("featureless", True)
    inputs = prepare_inputs(art, config, featureless, device, mesh)
    gen = torch.Generator().manual_seed(seed)
    with _image_body(job):
        if task == "nc":
            model = nc.build_model(inputs, config, len(art.class_map), gen)
        else:
            model = lp.build_model(inputs, config, gen)
    if mesh is not None:
        pmesh.shard_params(mesh, model)
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config,
                                       inputs.featureless, mesh)
    if job.get("params") is not None:
        load_jax_params(model, job["params"], job.get("batch_stats"))
    elif job.get("checkpoint"):
        tutils.restore_checkpoint(model, optimizer,
                                  tutils.load_checkpoint(job["checkpoint"]))
    model.skip_encoders = tutils.dead_encoders(model)
    return art, inputs, model, optimizer


def first_step(job: Dict, device=None, mesh=None) -> Dict:
    """One training step's loss and whole gradients (before the clip and
    the update), the running statistics after it, and the eval-mode output
    of the first batch (NC logits, LP embeddings) before it, and
    ``traffic``: the bytes the step handed to each collective. For LP also
    the corrupted triples the step drew (every rank draws the same). With
    ``job['relu']``, ``relu_inputs``: what each R-GCN layer hands its ReLU
    (or the logits) in the training forward."""
    device = select_device() if device is None else device
    config, task = job["config"], job["task"]
    seed = job.get("seed", 0)
    art, inputs, model, optimizer = _setup(job, device, mesh)
    coll.reset_traffic()
    relu_inputs: Dict[int, np.ndarray] = {}
    if job.get("relu"):
        for i, layer in enumerate(model.rgcn.layers()):
            layer.register_forward_hook(
                lambda _m, _a, y, i=i: relu_inputs.__setitem__(
                    i, _numpy(y)) if y.requires_grad else None)
    torch.manual_seed(seed)
    rng = torch.Generator(device=device).manual_seed(seed)
    l1, l2 = config["model"]["l1_lambda"], config["model"]["l2_lambda"]
    out: Dict = {}
    if task == "nc":
        Y = np.asarray(art.Y["train"]).reshape(-1, 2)
        batch = nc.make_batches(inputs, Y, config["task"].get(
            "batchsize", -1), len(model.hidden_dims))[0]
        with torch.no_grad():
            model.eval()
            out["eval"] = _numpy(model(batch.edges, batch.features))
        out["loss"] = float(nc.loss_and_grads(model, batch, l1, l2, rng,
                                              mesh)[0])
    else:
        task_cfg = config["task"]
        batches = lp.make_lp_batches(
            inputs, np.asarray(art.data["train"]),
            int(task_cfg.get("gcn_batchsize", -1)),
            int(task_cfg.get("test_batchsize", -1)),
            len(model.hidden_dims))
        dev = lp.to_device(batches, device)[0]
        b = dev.batch
        out["eval"] = _numpy(lp.embed(model, b))
        corrupt = lp.make_corruptor(
            float(task_cfg.get("negative_sampling_ratio", 0.2)))
        triples, labels, weights = corrupt(dev.data, b.num_triples,
                                           dev.pool, b.num_pool, rng)
        out["triples"] = (_numpy(triples), _numpy(labels), _numpy(weights))
        out["loss"] = float(lp.loss_and_grads(model, b, triples, labels,
                                              weights, 0.0, l1, l2, rng,
                                              mesh))
    if mesh is not None:
        pmesh.reduce_gradients(mesh, optimizer.params)
    out["grads"] = whole_grads(model)
    out["batch_stats"] = batch_stats(model)
    out["traffic"] = dict(coll.TRAFFIC)
    if relu_inputs:
        out["relu_inputs"] = relu_inputs
    return out


def train(job: Dict, device=None, mesh=None) -> Dict:
    """The task's own ``run`` (test split, TSV discarded) with what the
    card reports of it: ``history``, the final ``loss`` (and NC
    ``acc`` / ``labels``, LP ``mrr``), ``launches`` by kernel wrapper,
    ``bytes_per_step`` handed to the collectives, ``peak_bytes`` of the
    card, ``digest`` of the whole state, ``batch_stats`` and ``seconds``.
    With ``job['save']`` the trained state is written there as a
    checkpoint (rank 0 writes).
    """
    device = select_device() if device is None else device
    config = job["config"]
    art = artifact_io.load(job["artifact"])
    counters = kernel_counters()
    reset_launches(counters)
    coll.reset_traffic()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    seed = job.get("seed", 0)
    torch.manual_seed(seed)
    task = nc if job["task"] == "nc" else lp
    t0 = perf_counter()
    with _image_body(job):
        res = task.run(art, config, TSV("", "w", dry_run=True),
                         job.get("featureless", True), "test", seed,
                         device, job.get("checkpoint"))
    seconds = perf_counter() - t0
    steps = sum(res.batches["train"] for _ in res.history)
    out = {"history": res.history, "loss": res.loss,
           "launches": read_launches(counters),
           "bytes_per_step": sum(coll.TRAFFIC.values()) / max(steps, 1),
           "traffic": dict(coll.TRAFFIC),
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else None),
           "digest": state_digest(res.model),
           "batch_stats": batch_stats(res.model), "seconds": seconds,
           "rank": None if mesh is None else mesh.rank}
    if job["task"] == "nc":
        out.update(acc=res.acc, labels=res.labels)
    else:
        out.update(mrr=res.mrr)
    if job.get("save"):
        tutils.save_checkpoint(job["save"], res.epoch, res.model,
                               res.optimizer, res.loss)
    return out


def layers(job: Dict, device=None, mesh=None) -> Dict:
    """An R-GCN (``job['model']``: the constructor's keywords) on the
    graph ``job['graph']`` = (src, dst, rel, norm, n) with plans of
    ``job['plans']`` (the planner's keywords and ``shapes``), from
    ``job['params']``: its output on ``job['X']`` (None: featureless) and
    the whole gradients of ``sum(output * job['cot'])``. ``table_max``
    stands in for the composed-table budget, as the tests of the basis
    route set it."""
    device = select_device() if device is None else device
    budget = rl.COMPOSED_TABLE_MAX_ELEMS
    rl.COMPOSED_TABLE_MAX_ELEMS = job.get("table_max") or budget
    try:
        src, dst, rel, norm, n = job["graph"]
        plan_kw = dict(job["plans"])
        shapes = plan_kw.pop("shapes")
        shard = {} if mesh is None else {"num_shards": mesh.data,
                                         "shard": mesh.data_rank}
        plans = rl.plans_for_layers(src, dst, rel, norm, n, shapes,
                                    device=device, **plan_kw, **shard)

        def t(a):
            return torch.as_tensor(np.asarray(a), device=device)

        edges = EdgeBlock(src=t(src), dst=t(dst), rel=t(rel), norm=t(norm),
                          num_out=n, plans=plans)
        if mesh is not None:
            edges = pmesh.shard_edges(
                mesh, pmesh.pad_edges_for_mesh(edges, mesh.data),
                plans=plans)
        model = RGCN(generator=torch.Generator(), **job["model"]).to(device)
        if mesh is not None:
            pmesh.shard_params(mesh, model)
        load_jax_params(model, job["params"])
        X = None if job.get("X") is None else t(job["X"])
        got = model(X, edges)
        loss = (got * t(job["cot"])).sum()
        (loss if mesh is None else loss / mesh.world).backward()
        if mesh is not None:
            pmesh.reduce_gradients(mesh, list(model.parameters()))
        return {"out": _numpy(got), "grads": whole_grads(model)}
    finally:
        rl.COMPOSED_TABLE_MAX_ELEMS = budget


def loaded(job: Dict, device=None, mesh=None) -> list:
    """The modules of ``sys.modules`` whose top-level name is in
    ``job['names']``: what a rank has imported."""
    import sys
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in job["names"])


WORKERS = {"first_step": first_step, "train": train, "layers": layers,
           "loaded": loaded}


def rank_worker(rank: int, jobs) -> list:
    """A rank's share of a world: each job of ``jobs`` through the worker
    its ``work`` names, on the mesh its config (or its ``mesh`` spec)
    asks for; a worker's dict gets the job's host seconds as
    ``wall_s``."""
    out = []
    for job in jobs:
        t0 = perf_counter()
        device = select_device()
        config = job.get("config") or {"task": {"mesh": job["mesh"]}}
        mesh = pmesh.mesh_from_config(config, device)
        coll.ONE_RANK_PASSES = not job.get("one_rank_collectives")
        try:
            result = WORKERS[job["work"]](job, device, mesh)
        finally:
            coll.ONE_RANK_PASSES = True
        if isinstance(result, dict):
            result["wall_s"] = perf_counter() - t0
        out.append(result)
    return out
