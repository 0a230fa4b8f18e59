"""Relational Graph Convolutional Network (R-GCN) in PyTorch.

Counterpart of :mod:`mrgcn_tpu.models.rgcn`. The
layer math is the reference's ``A [I F] W = A I W_I + A F W_F`` with basis
decomposition, over the relation-partitioned COO edge list: the identity
half of the input layer runs on the sorted-stream engine
(:func:`..ops.relational.featureless_aggregate`, or
:func:`..ops.relational.featureless_basis` where the composed table is over
budget); a layer over features
runs :func:`..ops.relational.dense_aggregate` where the edges carry a plan
for its shape, else the relation-grouped path
(:func:`..ops.rspmm.transform_aggregate_grouped`); where that plan has no
relation-constant slabs and the layer is wide, a layer of a few bases
runs the wide-line basis engine instead
(:func:`..ops.relational.dense_basis`: link prediction's 200 x 200
layer). Mini-batch blocks carry
no plans (their ``dst_global`` is set): their identity half runs
:func:`..ops.rspmm.gather_aggregate_packed` or
:func:`..ops.rspmm.gather_aggregate` on the global node ids, an ungrouped
feature layer :func:`..ops.rspmm.transform_aggregate`. The composed
identity layer has one route, :func:`..ops.rspmm.compose_packed`, whose
backward reads the cotangent table once for both gradients (the JAX
package's fused-backward switch gives the same numbers either way).

Parameter names match the JAX package's (``layer_0.comp_i``,
``layer_0.weight_i_packed``, ``layer_1.weight_f``, ...), so
:mod:`..tasks.jax_import` maps one onto the other by path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from mrgcn_tpu_torch.models import init as tinit
from mrgcn_tpu_torch.ops import relational as rl
from mrgcn_tpu_torch.ops import rspmm
from mrgcn_tpu_torch.parallel import collectives as coll


@dataclass
class EdgeBlock:
    """Edge arrays for one propagation step.

    ``src`` indexes output rows, ``dst`` input rows, ``rel`` the relation,
    ``norm`` the D^-1 weight (0 on padding). ``dst_global`` indexes the
    global node space for the identity-weight gather of a mini-batch block
    (None in full-batch mode, where ``dst`` does). The ``grp_*`` arrays are the relation-grouped layout
    (``structure.group_by_relation``); ``plans`` the sorted-stream
    :class:`..ops.relational.LayerPlans` keyed ``"kin:kout[:id]"``.

    Under a device mesh (:mod:`..parallel.mesh`) ``mesh`` is set and the
    edge arrays, groups and plans are this rank's share of the edges: a
    layer sums its partial aggregates over the mesh's ``data`` group.
    """

    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    norm: torch.Tensor
    num_out: int
    num_in: Optional[int] = None
    dst_global: Optional[torch.Tensor] = None
    grp_src: Optional[torch.Tensor] = None
    grp_dst: Optional[torch.Tensor] = None
    grp_norm: Optional[torch.Tensor] = None
    group_rel: Optional[torch.Tensor] = None
    group_size: Optional[int] = None
    plans: Optional[dict] = None
    mesh: Optional[object] = None

    def plan_for(self, in_width: int, out_width: int,
                 identity: bool = False):
        """LayerPlans matching a layer shape, or None. Plans are built for
        full-batch edges only: a block with ``dst_global`` has none."""
        if not self.plans or self.dst_global is not None:
            return None
        k_in = rspmm.packing_factor(in_width)
        k_out = rspmm.packing_factor(out_width)
        if identity:
            return self.plans.get(f"{k_in}:{k_out}:id") \
                or self.plans.get(f"{k_in}:{k_out}:idb") \
                or self.plans.get(f"{k_in}:{k_out}")
        return self.plans.get(f"{k_in}:{k_out}")

    @property
    def identity_dst(self) -> torch.Tensor:
        return self.dst if self.dst_global is None else self.dst_global

    @property
    def grouped(self) -> bool:
        return self.group_rel is not None


def _fit_rows(packed: torch.Tensor, plan) -> torch.Tensor:
    """Slice or pad a (S, rows, lanes) packed weight to the plan's padded
    row count (only plans with a smaller row block than the parameter's
    differ; the rows cut away are zero and never addressed)."""
    n_rows = packed.shape[1]
    if n_rows > plan.n_in_rows:
        return packed[:, :plan.n_in_rows, :]
    if n_rows < plan.n_in_rows:
        return nn.functional.pad(packed,
                                 (0, 0, 0, plan.n_in_rows - n_rows))
    return packed


def _identity_planned(packed: torch.Tensor, comp: Optional[torch.Tensor],
                      plan, out_dim: int) -> torch.Tensor:
    """Featureless input layer on the sorted-stream engine: compose the
    relation-major packed table (one matmul) and aggregate it."""
    lw = packed.shape[2]
    pk = _fit_rows(packed, plan)
    flat = rspmm.compose_packed(comp, pk) if comp is not None else pk
    return rl.featureless_aggregate(flat.reshape(-1, lw), plan, out_dim)


def _basis_planned(packed: torch.Tensor, comp: torch.Tensor, plan,
                   out_dim: int) -> torch.Tensor:
    """Featureless basis-stream layer: the composed table would be over
    budget, so the compose happens per edge
    (:func:`..ops.relational.featureless_basis`)."""
    return rl.featureless_basis(comp, _fit_rows(packed, plan), plan,
                                out_dim)


class RGCNLayer(nn.Module):
    """One graph convolution. The input layer holds the identity weight
    ``W_I`` in the packed ``(S, rows, lanes)`` layout; a feature layer holds
    ``W_F (S, in, out)``; with ``num_bases > 0`` the coefficients
    ``comp (R, B)`` compose the per-relation weights."""

    def __init__(self, out_dim: int, num_relations: int, num_nodes: int,
                 generator: torch.Generator, num_bases: int = 0,
                 input_layer: bool = False, featureless: bool = False,
                 use_bias: bool = False, in_dim: Optional[int] = None):
        super().__init__()
        self.out_dim = out_dim
        self.num_relations = num_relations
        self.num_nodes = num_nodes
        self.num_bases = num_bases
        self.input_layer = input_layer
        self.featureless = featureless
        S = num_bases if num_bases > 0 else num_relations
        bases = num_bases > 0

        self.comp_i = self.comp_f = None
        if bases and input_layer:
            self.comp_i = nn.Parameter(tinit.xavier_uniform(
                (num_relations, num_bases), generator))
        if bases and not featureless:
            self.comp_f = nn.Parameter(tinit.xavier_uniform(
                (num_relations, num_bases), generator))
        self.weight_i_name = None
        if input_layer:
            shape, k = rspmm.packed_identity_shape(S, num_nodes, out_dim)
            self.weight_i_name = "weight_i_packed" if k > 1 else "weight_i"
            setattr(self, self.weight_i_name, nn.Parameter(
                tinit.packed_xavier_uniform(shape, (S * num_nodes, out_dim),
                                            num_nodes, out_dim, k,
                                            generator)))
        self.weight_f = None
        if not featureless:
            if in_dim is None:
                raise ValueError("a feature layer needs its input width")
            self.weight_f = nn.Parameter(tinit.xavier_uniform(
                (S, in_dim, out_dim), generator))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, H: Optional[torch.Tensor],
                edges: EdgeBlock) -> torch.Tensor:
        # under a mesh the aggregate over this rank's edges is partial: it
        # sums over data at the end
        out = 0.0
        if self.input_layer:
            plan_i = edges.plan_for(self.out_dim, self.out_dim,
                                    identity=True)
            weight_i = coll.gather_basis(getattr(self, self.weight_i_name))
            # the planned op gathers from the composed (R * rows, lanes)
            # table; where that table is over budget (link prediction:
            # hundreds of relations, wide rows) the basis-stream op
            # composes per edge instead, on plans that carry its
            # dst-sorted bwd_h stream; without such plans the layer falls
            # back to the unplanned gather
            use_basis = False
            if plan_i is not None and self.comp_i is not None \
                    and rl.composed_table_elems(
                        self.num_relations, self.num_nodes, self.out_dim,
                        n_in_rows=plan_i.n_in_rows) \
                    > rl.COMPOSED_TABLE_MAX_ELEMS:
                if plan_i.kind == "identity_basis" \
                        and 0 < self.num_bases <= rl.MAX_BASIS_STREAMS:
                    use_basis = True
                else:
                    plan_i = None
            k = rspmm.packing_factor(self.out_dim)
            if use_basis:
                out = _basis_planned(weight_i, self.comp_i, plan_i,
                                     self.out_dim)
            elif plan_i is not None:
                out = _identity_planned(weight_i, self.comp_i, plan_i,
                                        self.out_dim)
            elif k > 1:
                out = rspmm.gather_aggregate_packed(
                    weight_i, edges.src, edges.identity_dst, edges.rel,
                    edges.norm, edges.num_out, self.out_dim, k,
                    comp=self.comp_i)
            else:
                # the unplanned wide path takes logical (S, n, out) rows
                out = rspmm.gather_aggregate(
                    weight_i[:, :self.num_nodes, :self.out_dim], edges.src,
                    edges.identity_dst, edges.rel, edges.norm,
                    edges.num_out, comp=self.comp_i)

        if not self.featureless:
            in_dim = H.shape[-1]
            weight_f = coll.gather_basis(self.weight_f)
            plan_f = edges.plan_for(in_dim, self.out_dim)
            # a plan without relation-constant slabs would apply the
            # weights through a per-edge (E, in, out) gather: a wide layer
            # (link prediction's 200 x 200) of a few bases takes the stream
            # engine through the per-basis projections instead
            # (dense_basis: the grouped path's sums on wide lines), any
            # other the relation-grouped path
            dense_basis_plan = None
            if plan_f is not None and not plan_f.fwd.rel_const \
                    and in_dim * self.out_dim > 4096:
                if (self.comp_f is not None and plan_f.k_in == 1
                        and plan_f.kind == "dense"
                        and 0 < self.num_bases <= rl.MAX_BASIS_STREAMS):
                    dense_basis_plan = plan_f
                plan_f = None
            if dense_basis_plan is not None:
                agg = rl.dense_basis(H, weight_f, self.comp_f,
                                     dense_basis_plan, in_dim, self.out_dim)
            elif plan_f is not None:
                W = rspmm._compose_weights(weight_f, self.comp_f)
                agg = rl.dense_aggregate(H, W, plan_f, in_dim, self.out_dim)
            elif edges.grouped:
                agg = rspmm.transform_aggregate_grouped(
                    H, edges.grp_src, edges.grp_dst, edges.grp_norm,
                    edges.group_rel, edges.group_size, edges.num_out,
                    weight_f, comp=self.comp_f)
            else:
                agg = rspmm.transform_aggregate(
                    H, edges.src, edges.dst, edges.rel, edges.norm,
                    edges.num_out, weight_f, comp=self.comp_f)
            out = out + agg
        if edges.mesh is not None:
            out = coll.all_reduce(out, edges.mesh.data_group)
        return out if self.bias is None else out + self.bias


class RGCN(nn.Module):
    """Stack of graph convolutions with node dropout. For node
    classification the output layer is linear (logits) and every other
    layer is followed by ReLU; with ``link_prediction`` every layer is
    followed by ReLU and the model holds the DistMult relation vectors
    ``relations (R, hidden_dims[-1])``."""

    def __init__(self, hidden_dims: Sequence[int], num_relations: int,
                 num_nodes: int, generator: torch.Generator,
                 num_bases: int = 0, p_dropout: float = 0.0,
                 featureless: bool = False, use_bias: bool = False,
                 in_dim: Optional[int] = None,
                 link_prediction: bool = False):
        """``in_dim``: the width of the node features the input layer
        takes (``X_width``); unused when ``featureless``."""
        super().__init__()
        if not featureless and not in_dim:
            raise ValueError("an R-GCN over features needs their width")
        self.hidden_dims = tuple(hidden_dims)
        self.p_dropout = p_dropout
        self.link_prediction = link_prediction
        self.num_layers = len(self.hidden_dims)
        for i, out_dim in enumerate(self.hidden_dims):
            self.add_module(f"layer_{i}", RGCNLayer(
                out_dim=out_dim, num_relations=num_relations,
                num_nodes=num_nodes, generator=generator,
                num_bases=num_bases, input_layer=(i == 0),
                featureless=featureless and i == 0, use_bias=use_bias,
                in_dim=in_dim if i == 0 else self.hidden_dims[i - 1]))
        # drawn after the layers' weights, as the JAX module declares it
        self.relations = nn.Parameter(tinit.xavier_uniform(
            (num_relations, self.hidden_dims[-1]), generator)) \
            if link_prediction else None

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def _node_dropout(self, X: torch.Tensor, train: bool,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """Row-wise dropout through a dropped, rescaled ones vector."""
        if self.p_dropout <= 0.0 or not train:
            return X
        u = torch.rand(X.shape[0], generator=generator, device=X.device)
        scale = (u < 1.0 - self.p_dropout).to(X.dtype) \
            / (1.0 - self.p_dropout)
        return X * scale[:, None]

    def forward(self, X: Optional[torch.Tensor], edges, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``edges``: one EdgeBlock (full batch) or one per layer (the
        frontier-restricted chain, or a mini-batch, whose layer ``l``
        takes the edges of hop ``L - 1 - l``)."""
        per_layer = isinstance(edges, (tuple, list))
        for i, layer in enumerate(self.layers()):
            X = layer(X, edges[i] if per_layer else edges)
            X = self._node_dropout(X, train, generator)
            if i < self.num_layers - 1 or self.link_prediction:
                X = torch.relu(X)
        return X
