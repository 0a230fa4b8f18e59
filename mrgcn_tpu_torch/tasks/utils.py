"""Training utilities: optimizer parameter groups, regularisation, early
stopping, progress display (counterpart of :mod:`mrgcn_tpu.tasks.utils`).
"""

from __future__ import annotations

import logging
import sys
from typing import Dict, Optional, Tuple

import torch
from torch import nn

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
    """L1/L2 penalty over weight-like parameters."""
    first = next(model.parameters())
    total = torch.zeros((), dtype=torch.float32, device=first.device)
    if l1_lambda <= 0 and l2_lambda <= 0:
        return total
    mask = weight_mask(model)
    for name, p in model.named_parameters():
        if not mask[name]:
            continue
        if l1_lambda > 0:
            total = total + l1_lambda * p.abs().sum()
        if l2_lambda > 0:
            total = total + l2_lambda * (p ** 2).sum()
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
    """

    def __init__(self, groups, max_norm: float = 1.0):
        self.adam = torch.optim.Adam(groups)
        self.params = [p for g in groups for p in g["params"]]
        self.max_norm = max_norm

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        nn.utils.clip_grad_norm_(self.params, self.max_norm)
        self.adam.step()

    def state_dict(self) -> Dict:
        return self.adam.state_dict()


def build_optimizer(model: nn.Module, config: Dict, optimizer_config: Dict,
                    featureless: bool) -> ClippedAdam:
    """Clip + Adam with the reference's parameter groups."""
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
            groups[lbl] = {"params": [],
                           **_group_kwargs(cfg, base_lr, base_wd, lbl)}
        groups[lbl]["params"].append(p)
    return ClippedAdam(list(groups.values()))


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
