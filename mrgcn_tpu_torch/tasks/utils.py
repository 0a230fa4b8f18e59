"""Training utilities: optimizer parameter groups, regularisation, early
stopping, checkpoints, progress display (counterpart of
:mod:`mrgcn_tpu.tasks.utils`).

A checkpoint is the JAX package's file, so either package resumes from
the other's: a pickle-free ``.npz`` of flat keys ``params/<path>``,
``batch_stats/<path>``, ``opt_state/<path>``, ``meta/epoch`` (int64) and
``meta/loss`` (float64), with an ``__empty__`` marker (an int8 array of
length 0) wherever the JAX tree holds an empty node. The optimizer part
is optax's state of ``clip_by_global_norm`` chained with
``multi_transform``: one Adam state per parameter group (label) over the
whole parameter tree, the other labels' parameters masked
(:func:`optax_opt_state`, :func:`restore_opt_state`).

Under a device mesh (:mod:`..parallel.mesh`) the optimizer sums the
ranks' gradient shares before it clips, the clip's norm counts each basis
slice once, and the penalties count each slice once too. A checkpoint
holds the whole weights: saving gathers the slices and rank 0 writes a
file laid out as a single-device run's; restoring loads the whole tree and
keeps each rank's slice, so a file saved under one spec resumes under
another, or under none.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from mrgcn_tpu_torch.parallel import collectives as coll
from mrgcn_tpu_torch.parallel import mesh as pmesh
from mrgcn_tpu_torch.tasks import torch_import
from mrgcn_tpu_torch.tasks.jax_import import (load_jax_params,
                                              state_dict_to_batch_stats,
                                              state_dict_to_params)

logger = logging.getLogger(__name__)


# Parameters included in L1/L2 penalties: the reference penalises every
# parameter whose torch name contains 'weight' (R-GCN weights, basis
# coefficients, gates, encoder kernels); biases are excluded. Names are
# the JAX package's leaf names, which the port keeps.
_WEIGHT_LEAVES = {"kernel", "scale", "embedding", "pos_embedding",
                  "weight_i", "weight_i_packed", "weight_f", "comp_i",
                  "comp_f", "gate_weights"}


def weight_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether it is 'weight'-like."""
    return {name: name.rsplit(".", 1)[-1] in _WEIGHT_LEAVES
            for name, _ in model.named_parameters()}


def regularization(model: nn.Module, l1_lambda: float,
                   l2_lambda: float) -> torch.Tensor:
    """L1/L2 penalty over weight-like parameters; a basis slice's penalty
    is summed over its ``model`` group, so the penalty is the whole
    weight's on every rank."""
    first = next(model.parameters())
    total = torch.zeros((), dtype=torch.float32, device=first.device)
    if l1_lambda <= 0 and l2_lambda <= 0:
        return total
    mask = weight_mask(model)
    for name, p in model.named_parameters():
        if not mask[name]:
            continue
        terms = []
        if l1_lambda > 0:
            terms.append(l1_lambda * p.abs().sum())
        if l2_lambda > 0:
            terms.append(l2_lambda * (p ** 2).sum())
        s = pmesh.basis_slice(p)
        for term in terms:
            total = total + (term if s is None
                             else coll.all_reduce(term, s.group))
    return total


def _param_labels(model: nn.Module, optimizer_config: Dict,
                  featureless: bool) -> Dict[str, str]:
    """Group label per parameter: 'gates' for the gate vector, the datatype
    for encoder instances (``xsd_numeric_0`` -> ``xsd.numeric``), else
    'default'."""
    datatype_labels = {k for k in optimizer_config if k != "gate_weights"}
    labels = {}
    for name, _ in model.named_parameters():
        top = name.split(".", 1)[0]
        datatype = ".".join(top.split("_")[:2])
        if top == "gate_weights" and not featureless:
            labels[name] = "gates"
        elif datatype in datatype_labels:
            labels[name] = datatype
        else:
            labels[name] = "default"
    return labels


# per-group optimizer kwargs forwarded into the Adam parameter groups
_ADAM_KWARGS = {"lr", "weight_decay", "betas", "eps", "amsgrad"}


def _group_kwargs(cfg: Dict, base_lr: float, base_wd: float,
                  label: str) -> Dict:
    unknown = set(cfg) - _ADAM_KWARGS
    if unknown:
        logger.warning("Ignoring unsupported optim params for %s: %s "
                       "(supported: %s)", label, sorted(unknown),
                       sorted(_ADAM_KWARGS))
    return {"lr": cfg.get("lr", base_lr),
            "weight_decay": cfg.get("weight_decay", base_wd),
            "betas": tuple(cfg.get("betas", (0.9, 0.999))),
            "eps": cfg.get("eps", 1e-8),
            "amsgrad": bool(cfg.get("amsgrad", False))}


class ClippedAdam:
    """Global-norm gradient clip (1.0) followed by per-group
    ``torch.optim.Adam``.

    The JAX package's clip scales by ``max_norm / norm``;
    ``clip_grad_norm_`` by ``max_norm / (norm + 1e-6)``, a relative
    difference of about 1e-6 once the clip engages.

    Under ``mesh`` a step first sums the ranks' gradient shares
    (:func:`..parallel.mesh.reduce_gradients`), then clips by the global
    norm with each basis slice counted once (:func:`..parallel.mesh.
    grad_norm`, then ``clip_grads_with_norm_``, as ``clip_grad_norm_``
    clips): every rank then steps the same numbers.
    """

    def __init__(self, groups, max_norm: float = 1.0, mesh=None):
        self.adam = torch.optim.Adam(groups)
        self.params = [p for g in groups for p in g["params"]]
        self.max_norm = max_norm
        self.mesh = mesh

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.mesh is None:
            nn.utils.clip_grad_norm_(self.params, self.max_norm)
        else:
            pmesh.reduce_gradients(self.mesh, self.params)
            nn.utils.clip_grads_with_norm_(
                self.params, self.max_norm,
                pmesh.grad_norm(self.mesh, self.params))
        self.adam.step()

    def state_dict(self) -> Dict:
        return self.adam.state_dict()


def build_optimizer(model: nn.Module, config: Dict, optimizer_config: Dict,
                    featureless: bool, mesh=None) -> ClippedAdam:
    """Clip + Adam with the reference's parameter groups (over this rank's
    basis slices under ``mesh``)."""
    base_lr = config["model"]["learning_rate"]
    base_wd = config["model"].get("weight_decay", 0.0)
    optimizer_config = optimizer_config or {}
    labels = _param_labels(model, optimizer_config, featureless)

    groups: Dict[str, Dict] = {}
    for name, p in model.named_parameters():
        lbl = labels[name]
        if lbl not in groups:
            if lbl == "gates":
                cfg = optimizer_config.get("gate_weights", {})
            else:
                cfg = optimizer_config.get(lbl, {})
            # the label names the group's optax state in a checkpoint;
            # Adam ignores the extra key
            groups[lbl] = {"params": [], "label": lbl,
                           **_group_kwargs(cfg, base_lr, base_wd, lbl)}
        groups[lbl]["params"].append(p)
    return ClippedAdam(list(groups.values()), mesh=mesh)


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def dead_encoders(model: nn.Module) -> Tuple[str, ...]:
    """Encoder instances whose gate is exactly zero: the reference skips
    their forward at run time (reference: mrgcn.py:263-268); here they go
    into ``MRGCN.skip_encoders``."""
    gates = getattr(model, "gate_weights", None)
    if gates is None:
        return ()
    return tuple(name for name, g in zip(model.names, gates.tolist())
                 if abs(g) < 1e-12)


class EarlyStop:
    """Patience/tolerance early stopping with a warm-up delay, keeping the
    best state in host memory."""

    def __init__(self, patience: int = 7, tolerance: float = 0.01,
                 delay: int = 10):
        self.tolerance = tolerance
        self.delay = delay
        self._patience_default = patience
        self.patience = patience
        self.stop = False
        self.best_score = -1.0
        self.best_state: Optional[Tuple] = None

    def record(self, score: float, state) -> None:
        if self.delay > 0:
            self.delay -= 1
            return

        if self.best_score < 0:
            self._update(score, state)
            return

        self.patience -= 1
        if (score + self.tolerance) < self.best_score:
            self._update(score, state)
            self.patience = self._patience_default
            self.stop = False

        if self.patience <= 0:
            self.stop = True

    def _update(self, score: float, state) -> None:
        self.best_score = score
        self.best_state = _to_host(state)


def _flatten_state(tree, prefix: str, out: Dict) -> None:
    """Nested dict of arrays -> flat ``prefix/a/b`` keys in ``out``; an
    empty dict (an empty optax state, a masked parameter) leaves an
    ``__empty__`` marker, so the JAX package's tree survives the trip."""

    def walk(node, key):
        if isinstance(node, dict):
            if not node:
                out[f"{key}/__empty__"] = np.zeros(0, dtype=np.int8)
            for k, v in node.items():
                walk(v, f"{key}/{k}")
        else:
            out[key] = np.asarray(node)

    walk(tree, prefix)


def _unflatten_state(npz, prefix: str) -> Dict:
    """The nested dict under ``prefix``; a marker becomes an empty dict."""
    root: Dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != "__empty__":
            node[parts[-1]] = npz[key]
    return root


# optax's moments and torch Adam's state keys
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq"}
_AMSGRAD_MOMENTS = {**_MOMENTS, "nu_max": "max_exp_avg_sq"}


def _adam_index(group: Dict) -> Tuple[str, Optional[str]]:
    """Where a group's Adam state sits in its label's optax chain: after
    ``add_decayed_weights``'s empty state when the group decays, then
    inside ``optax.adam``'s own chain (index ``0``) unless the group takes
    the JAX package's torch-exact AMSGrad, whose state is the chain's
    element itself."""
    outer = str(int(group["weight_decay"] > 0))
    return outer, (None if group["amsgrad"] else "0")


def optax_opt_state(model: nn.Module, optimizer: ClippedAdam) -> Dict:
    """torch Adam's state as the JAX package's optax state (a nested dict
    of numpy arrays, each tensor copied to the host once).

    Each label holds ``mu`` / ``nu`` (``nu_max`` under AMSGrad) for every
    parameter, the other labels' parameters masked (``{}``), and an int32
    ``count``. torch keeps a step per parameter, and state only for
    parameters that had a gradient; optax counts each label's steps,
    every label on every step, so ``count`` is the optimizer's step count
    and a parameter without torch state (a zero-gated encoder's) holds
    zeros, as optax does. A basis slice's moments are gathered to the
    whole weight's (collective over ``model``)."""
    adam = optimizer.adam
    names = {p: n for n, p in model.named_parameters()}
    steps = [float(st["step"]) for st in adam.state.values() if "step" in st]
    count = np.asarray(int(max(steps, default=0.0)), dtype=np.int32)
    inner = {}
    for group in adam.param_groups:
        own = {names[p]: adam.state.get(p, {}) for p in group["params"]}
        moments = _AMSGRAD_MOMENTS if group["amsgrad"] else _MOMENTS
        state: Dict = {"count": count}
        for jkey, tkey in moments.items():
            tree: Dict = {}
            for name, p in model.named_parameters():
                *parents, leaf = name.split(".")
                node = tree
                for part in parents:
                    node = node.setdefault(part, {})
                if name not in own:
                    node[leaf] = {}
                elif tkey in own[name]:
                    node[leaf] = pmesh.whole(p, own[name][tkey]) \
                        .detach().cpu().numpy()
                else:
                    node[leaf] = np.zeros(pmesh.full_shape(p),
                                          dtype=np.float32)
            state[jkey] = tree
        outer, adam_at = _adam_index(group)
        chain = {} if outer == "0" else {"0": {}}
        if adam_at is None:
            # the torch-exact AMSGrad, then optax.scale
            chain.update({outer: state, str(int(outer) + 1): {}})
        else:
            # optax.adam: scale_by_adam, then the learning rate's scale
            chain[outer] = {adam_at: state, "1": {}}
        inner[group["label"]] = {"inner_state": chain}
    return {"0": {}, "1": {"inner_states": inner}}


def _leaf(tree: Dict, name: str) -> np.ndarray:
    node = tree
    for part in name.split("."):
        node = node[part]
    if not isinstance(node, np.ndarray):
        raise ValueError(f"checkpoint optimizer state has no array for "
                         f"{name}")
    return node


def restore_opt_state(model: nn.Module, optimizer: ClippedAdam,
                      stored: Dict) -> None:
    """Load a checkpoint's optax state (a nested dict, as
    :func:`load_checkpoint` reads it) into ``optimizer``: every parameter
    of a group takes its label's ``count`` as its step and its moments
    (a basis slice its slice of them). A file whose labels, layout or
    shapes do not fit the optimizer raises."""
    adam = optimizer.adam
    inner = stored["1"]["inner_states"]
    labels = {g["label"] for g in adam.param_groups}
    if set(inner) != labels:
        raise ValueError(f"checkpoint optimizer groups {sorted(inner)} do "
                         f"not match the model's {sorted(labels)}")
    names = {p: n for n, p in model.named_parameters()}
    sd = adam.state_dict()
    state: Dict = {}
    for group, saved in zip(adam.param_groups, sd["param_groups"]):
        outer, adam_at = _adam_index(group)
        try:
            found = inner[group["label"]]["inner_state"][outer]
            found = found if adam_at is None else found[adam_at]
            count = float(found["count"])
        except KeyError as e:
            raise ValueError(f"checkpoint optimizer state of group "
                             f"{group['label']!r} does not match its "
                             f"options (missing {e})") from None
        moments = _AMSGRAD_MOMENTS if group["amsgrad"] else _MOMENTS
        for p, index in zip(group["params"], saved["params"]):
            entry = {"step": torch.tensor(count, dtype=torch.float32)}
            for jkey, tkey in moments.items():
                value = _leaf(found[jkey], names[p])
                if value.shape != pmesh.full_shape(p):
                    raise ValueError(f"checkpoint {jkey} of {names[p]} is "
                                     f"{value.shape}, the parameter "
                                     f"{pmesh.full_shape(p)}")
                value = pmesh.share_of(p, value)
                entry[tkey] = torch.from_numpy(np.array(value))
            state[index] = entry
    sd["state"] = state
    adam.load_state_dict(sd)


def save_checkpoint(path: str, epoch: int, model: nn.Module,
                    optimizer: ClippedAdam, loss: float) -> None:
    """Write ``{epoch, parameters, optimizer state, running statistics,
    loss}`` as the JAX package's pickle-free ``.npz``; every tensor goes
    to the host once and from there into the file. Under a mesh every rank
    calls it: the basis slices are gathered, and rank 0 writes."""
    sd = pmesh.full_state_dict(model)
    opt_state = optax_opt_state(model, optimizer)
    if optimizer.mesh is not None and optimizer.mesh.rank != 0:
        return
    flat: Dict = {}
    _flatten_state(state_dict_to_params(sd), "params", flat)
    _flatten_state(opt_state, "opt_state", flat)
    _flatten_state(state_dict_to_batch_stats(sd), "batch_stats", flat)
    flat["meta/epoch"] = np.asarray(epoch, dtype=np.int64)
    flat["meta/loss"] = np.asarray(float(loss), dtype=np.float64)
    with open(path, "wb") as f:
        np.savez(f, **flat)


# text-attention parameter trees a checkpoint can carry, each known by a
# key that only its _TextBlock subtree has, with the attn_impl values that
# build it and the one 'auto' is moved to (the JAX package's
# tasks/utils._ATTN_TREE_FLAVOURS)
_ATTN_TREE_FLAVOURS = (
    ("MultiHeadDotProductAttention", "flax-MHA", ("xla", "flash"), "xla"),
    ("qkv", "fused-QKV", ("plain_fused", "fused_core", "auto"), None),
    ("query", "split-QKV", ("plain",), "plain"),
)


def _find_text_blocks(params, out: List) -> None:
    if not isinstance(params, dict):
        return
    for key, val in params.items():
        if key.startswith("_TextBlock_") and isinstance(val, dict):
            out.append(val)
        else:
            _find_text_blocks(val, out)


def reconcile_text_attn(params: Dict) -> Optional[str]:
    """The text-attention impl a model restored from ``params`` (a
    checkpoint's parameter tree) must be built with, before it is built:
    None where the checkpoint has no from-scratch text encoder or
    ``MRGCN_TEXT_ATTN`` (default ``auto``) already builds its tree; the
    tree's impl where ``MRGCN_TEXT_ATTN`` is unset or ``auto``; else a
    ``RuntimeError`` naming the setting that loads it. It writes nothing
    to ``os.environ``: the answer holds for the model being restored
    alone (``mrgcn_tpu.tasks.utils.reconcile_text_attn``)."""
    blocks: List = []
    _find_text_blocks(params, blocks)
    if not blocks:
        return None
    flavour = None
    for marker, name, compatible, fix in _ATTN_TREE_FLAVOURS:
        if any(k.startswith(marker) for k in blocks[0]):
            flavour = (name, compatible, fix)
            break
    if flavour is None:
        return None
    name, compatible, fix = flavour
    current = os.environ.get("MRGCN_TEXT_ATTN", "auto")
    if current in compatible:
        return None
    if current == "auto" and fix is not None:
        logger.warning(
            "Checkpoint carries a %s text-attention param tree; selecting "
            "attn_impl=%s for this restore", name, fix)
        return fix
    raise RuntimeError(
        f"Checkpoint text-attention param tree is {name}, incompatible "
        f"with MRGCN_TEXT_ATTN={current}; set MRGCN_TEXT_ATTN="
        f"{fix or compatible[0]} to load it")


def load_checkpoint(path: str) -> Dict:
    """Read a checkpoint: the ``.npz`` either package writes
    (``params`` / ``batch_stats`` / ``opt_state`` as nested dicts of numpy
    arrays, ``format`` ``"npz"``) or a reference ``torch.save`` file
    (:mod:`.torch_import`, ``format`` ``"torch"``: the optimizer starts
    afresh). A legacy pickle checkpoint of the JAX package raises:
    unpickling it runs code and needs JAX."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(
            f"{path} is a legacy pickle checkpoint, which the port does not "
            "read (unpickling runs code and needs jax); convert it with "
            "mrgcn_tpu: tasks.utils.load_checkpoint, then save_checkpoint, "
            "writes it as the .npz both packages read")
    if torch_import.is_torch_checkpoint(path):
        logger.info("%s is a reference torch checkpoint; importing it "
                    "(the optimizer starts afresh)", path)
        return torch_import.load_torch_checkpoint(path)
    npz = np.load(path, allow_pickle=False)
    state = {"epoch": int(npz["meta/epoch"]),
             "loss": float(npz["meta/loss"]),
             "params": _unflatten_state(npz, "params"),
             "opt_state": _unflatten_state(npz, "opt_state"),
             "batch_stats": _unflatten_state(npz, "batch_stats"),
             "format": "npz"}
    return state


def restore_checkpoint(model: nn.Module, optimizer: ClippedAdam,
                       state: Dict) -> int:
    """Load what :func:`load_checkpoint` read into ``model`` (on its
    device) and ``optimizer``; returns the checkpoint's epoch. Parameters
    and running statistics load strictly (names and shapes must match); a
    reference ``torch.save`` state dict is mapped onto the model's own
    tree first and leaves the optimizer fresh. Under a mesh each rank
    keeps its slices of the whole weights the file holds."""
    if state["format"] == "torch":
        params, batch_stats, _ = torch_import.map_state_dict(
            state["model_state_dict"], model)
        load_jax_params(model, params, batch_stats)
    else:
        load_jax_params(model, state["params"], state["batch_stats"])
        restore_opt_state(model, optimizer, state["opt_state"])
    return state["epoch"]


class BatchProgress:
    """In-place terminal batch counter (`` [TRAIN] - batch  i / N``),
    enabled only when the stream is a TTY."""

    def __init__(self, total: int, stream=None, enabled: bool = None,
                 label: str = "TRAIN"):
        self.total = int(total)
        self.stream = stream if stream is not None else sys.stdout
        if enabled is None:
            enabled = self.total > 1 and getattr(
                self.stream, "isatty", lambda: False)()
        self.enabled = enabled
        self.label = label

    def update(self, batch_id: int) -> None:
        if not self.enabled:
            return
        s = " [%s] - batch %2.d / %d" % (self.label, batch_id, self.total)
        self.stream.write(s + "\b" * len(s))
        self.stream.flush()

    def done(self) -> None:
        if not self.enabled:
            return
        s = " [%s] - batch %2.d / %d" % (self.label, self.total,
                                         self.total)
        self.stream.write(" " * len(s) + "\b" * len(s))
        self.stream.flush()
