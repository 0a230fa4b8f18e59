"""MR-GCN model: modality encoders fused with the R-GCN.

Counterpart of :mod:`mrgcn_tpu.models.mrgcn`. The port carries the
featureless model only, which is the R-GCN under the ``rgcn`` name the
JAX package uses; encoders and their gates are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mrgcn_tpu_torch.models.rgcn import RGCN, TODO_ENCODERS


class MRGCN(nn.Module):
    """Featureless MR-GCN: delegates to :class:`RGCN` (``self.rgcn``)."""

    def __init__(self, hidden_dims: Sequence[int], modules_config,
                 num_relations: int, num_nodes: int,
                 generator: torch.Generator, num_bases: int = 0,
                 p_dropout: float = 0.0, featureless: bool = True,
                 use_bias: bool = False):
        super().__init__()
        if modules_config or not featureless:
            raise NotImplementedError(
                f"modality encoders: {TODO_ENCODERS}")
        self.hidden_dims = tuple(hidden_dims)
        self.rgcn = RGCN(hidden_dims=hidden_dims,
                         num_relations=num_relations, num_nodes=num_nodes,
                         generator=generator, num_bases=num_bases,
                         p_dropout=p_dropout, featureless=True,
                         use_bias=use_bias)

    def forward(self, edges, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.rgcn(None, edges, train=train, generator=generator)
