"""Block-sorted stream kernels: scatter, gather and their fused forms.

Counterpart of :mod:`mrgcn_tpu.ops.pallas_gather` for the sorted-stream
engine: ``ROW_BLOCK``, ``EDGE_BLOCK``, :func:`sorted_scatter`,
:func:`sorted_gather`, :func:`fused_place_scatter` and
:func:`fused_scatter_dot`.

An edge stream is cut into slabs of ``edge_block`` edges; slab ``s``
addresses one ``row_block``-row block ``blk[s]`` of a table, and
``local[s, j]`` is the edge's row inside that block (``row_block`` on
padding). For the scatters the block ids never decrease along the stream.
Where the real edges' scatter rows never decrease too (the planner's
``Stream.rows_sorted``: every stream a path makes but the
relation-constant ones), the scatters take a row-segmented kernel
(``csrc/row_walk.cuh``): each warp sums a chunk of edges row by row in
registers, rows that cross chunks are summed in chunk order by a second
pass. Otherwise :func:`sorted_scatter` gives each run of equal block ids
to one thread block that accumulates it in shared memory, and
:func:`fused_place_scatter` cuts long runs into pieces summed by separate
thread blocks, then adds the pieces in a fixed order;
:func:`fused_scatter_dot` takes only row-sorted streams. All sums are
deterministic and need no atomics. The gather (``csrc/sorted_gather.cu``)
copies rows.

Each wrapper takes its plain PyTorch version (``*_reference``) for CPU
tensors, whatever ``rows_sorted`` says, and launches its kernel for CUDA
tensors, or raises: there is no fallback. ``<wrapper>.launches`` counts
its launches; the scatters' ``launches_rows`` counts those on the
row-segmented kernel.

:func:`compose_grad_pass` (``csrc/compose.cu``) is the backward of the
relation-major compose in one read of the cotangent table.
"""

from __future__ import annotations

import ctypes

import torch

from mrgcn_tpu_torch.ops import _build

ROW_BLOCK = 512    # table rows per block
EDGE_BLOCK = 256   # edges per slab

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ERR = {"mrgcn_cuda_error_string": ([_I], ctypes.c_char_p)}
_SIGNATURES = {
    "sorted_scatter": {
        "mrgcn_sorted_scatter_f32": (
            [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _P], _I),
        "mrgcn_sorted_scatter_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "mrgcn_sorted_scatter_lane_tile": ([], _I),
        "mrgcn_sorted_scatter_max_edge_block": ([], _I),
        "mrgcn_sorted_scatter_rows_f32": (
            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        "mrgcn_sorted_scatter_rows_chunk": ([], _I), **_ERR},
    "sorted_gather": {
        "mrgcn_sorted_gather_f32": (
            [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _P], _I),
        "mrgcn_sorted_gather_max_edge_block": ([], _I), **_ERR},
    "fused_place_scatter": {
        "mrgcn_fused_place_split_f32": (
            [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I,
             _I, _I, _P], _I),
        "mrgcn_fused_place_scatter_smem_bytes": ([_I, _I], ctypes.c_size_t),
        "mrgcn_fused_place_scatter_lane_tile": ([], _I),
        "mrgcn_fused_place_scatter_max_edge_block": ([], _I),
        "mrgcn_fused_place_rows_f32": (
            [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _P], _I),
        "mrgcn_fused_place_rows_chunk": ([], _I), **_ERR},
    "scatter_dot": {
        "mrgcn_scatter_dot_rows_f32": (
            [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _I, _I, _P], _I),
        "mrgcn_scatter_dot_rows_chunk": ([], _I),
        "mrgcn_scatter_dot_rows_max_width": ([], _I), **_ERR},
    "compose": {
        "mrgcn_compose_grad_f32": (
            [_P, _P, _LL, _P, _P, _P, _P, _I, _I, _LL, _P], _I),
        "mrgcn_compose_grad_chunk": ([_I, _I], _I),
        "mrgcn_compose_grad_ctas": ([_I, _I, _LL], _I),
        "mrgcn_compose_grad_smem": ([_I, _I], ctypes.c_size_t),
        "mrgcn_compose_table_smem": ([_I, _I], ctypes.c_size_t),
        "mrgcn_compose_table_f32": (
            [_P, _P, _LL, _P, _I, _I, _LL, _P], _I),
        "mrgcn_compose_table_chunk": ([_I, _I], _I),
        "mrgcn_canonical_copy_f32": ([_P, _P, _LL, _P], _I), **_ERR},
}


def _library(name: str):
    return _build.bind(name, _SIGNATURES[name])


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def _edge_rows(local: torch.Tensor, blk: torch.Tensor, row_block: int,
               num_rows: int):
    """Global table row per padded edge, and which edges are real: the
    local index lies inside the block and the row inside the table."""
    rows = (blk.long()[:, None] * row_block + local.long()).reshape(-1)
    valid = ((local >= 0) & (local < row_block)).reshape(-1) \
        & (rows >= 0) & (rows < num_rows)
    return rows, valid


def sorted_scatter_reference(msgs: torch.Tensor, local: torch.Tensor,
                             out_blk: torch.Tensor, out_rows: int,
                             row_block: int, edge_block: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_scatter` (``index_add_`` over
    the valid edges): the counterpart of ``pallas_gather._xla_scatter``.
    Rows outside ``[0, out_rows)`` are dropped, as ``segment_sum`` does."""
    del edge_block
    rows, valid = _edge_rows(local, out_blk, row_block, out_rows)
    out = torch.zeros(out_rows, msgs.shape[1], dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, rows[valid], msgs[valid])


def sorted_gather_reference(table: torch.Tensor, local: torch.Tensor,
                            tbl_idx: torch.Tensor, row_block: int,
                            edge_block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_gather` (a row gather with
    zero rows on padding): the counterpart of
    ``pallas_gather._xla_gather``."""
    del edge_block
    rows, valid = _edge_rows(local, tbl_idx, row_block, table.shape[0])
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    return table[safe].float() * valid[:, None]


def expand_sub(v: torch.Tensor, mod: torch.Tensor, k: int,
               L: int) -> torch.Tensor:
    """Per-edge sub-row placement ``(E, d) -> (E, L)``: ``v`` lands in lane
    slot ``mod`` (of width ``L // k``), every other lane is zero."""
    E, d = v.shape
    sub = L // k
    out = v.new_zeros(E, k, sub)
    rows = torch.arange(E, device=v.device)
    out[rows, mod.long() if k > 1 else 0, :d] = v
    return out.reshape(E, k * sub)


def fused_place_scatter_reference(V: torch.Tensor, place_mod: torch.Tensor,
                                  norm: torch.Tensor, local: torch.Tensor,
                                  out_blk: torch.Tensor, out_rows: int,
                                  k: int, L: int, row_block: int,
                                  edge_block: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_place_scatter`: scale, expand
    every edge to its ``L``-lane line, then ``index_add_``."""
    msgs = expand_sub(V * norm[:, None], place_mod, k, L)
    return sorted_scatter_reference(msgs, local, out_blk, out_rows,
                                    row_block, edge_block)


def fused_scatter_dot_reference(dvn: torch.Tensor, w: torch.Tensor,
                                local: torch.Tensor, out_blk: torch.Tensor,
                                table: torch.Tensor, out_rows: int,
                                row_block: int, edge_block: int):
    """Plain PyTorch version of :func:`fused_scatter_dot`: a scatter pass
    and a row-gather pass (the XLA branch of
    ``pallas_gather.fused_scatter_dot``)."""
    L, Lv = table.shape[1], dvn.shape[1]
    msgs = torch.nn.functional.pad(dvn * w[:, None], (0, L - Lv))
    out = sorted_scatter_reference(msgs, local, out_blk, out_rows,
                                   row_block, edge_block)
    rows, valid = _edge_rows(local, out_blk, row_block, out_rows)
    safe = torch.where(valid, rows, torch.zeros_like(rows))
    dots = (table[safe][:, :Lv] * dvn).sum(dim=1) * valid
    return out, dots


# --------------------------------------------------------------------------
# argument checks shared by the CUDA launches
# --------------------------------------------------------------------------

def _check_tensors(fn: str, tensors) -> None:
    """Dtype and contiguity of ``(name, tensor, dtype, contiguous)``
    entries against the kernel's contract (the devices agree already)."""
    for name, t, dtype, contiguous in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_stream(fn: str, num_edges: int, local: torch.Tensor,
                  blk: torch.Tensor, row_block: int, edge_block: int,
                  max_edge_block: int) -> int:
    """Shape agreement of a slab stream; returns the slab count."""
    if local.dim() != 2 or blk.dim() != 1:
        raise ValueError(f"{fn}: expected local (nslab, EB) and block ids "
                         "(nslab,)")
    nslab, eb = local.shape
    if eb != edge_block or blk.shape[0] != nslab \
            or num_edges != nslab * edge_block:
        raise ValueError(
            f"{fn}: shapes disagree: {num_edges} edges, local "
            f"{tuple(local.shape)}, block ids {tuple(blk.shape)}, "
            f"edge_block {edge_block}")
    if not 0 < edge_block <= max_edge_block:
        raise ValueError(f"{fn}: edge_block {edge_block} out of the "
                         "kernel's range")
    if row_block <= 0:
        raise ValueError(f"{fn}: row_block must be positive")
    return nslab


def _check_lanes(fn: str, L: int, lanes: int) -> None:
    if L <= 0 or L % lanes:
        raise ValueError(f"{fn}: the kernel takes L a positive multiple of "
                         f"{lanes}, got {L}")


def _check_smem(fn: str, needed: int, row_block: int) -> None:
    if needed > _build.SMEM_LIMIT:
        raise ValueError(f"{fn}: row_block {row_block} needs more shared "
                         "memory than a thread block has")


def _device_of(fn: str, first: torch.Tensor, others) -> str:
    """The device type all tensors share (``cpu`` or ``cuda``)."""
    for name, t in others:
        if t.device != first.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected "
                             f"{first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no kernel for device {first.device}")
    return first.device.type


def _raise_on(fn: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed: "
                           + lib.mrgcn_cuda_error_string(rc).decode())


def _cuda_stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------
# the row-segmented kernels' scratch and limits (csrc/row_walk.cuh)
# --------------------------------------------------------------------------

# the row-segmented kernels stage no slab: any edge block will do
_ROWS_MAX_EDGE_BLOCK = 2 ** 30


def _check_row_indices(fn: str, num_edges: int, out_rows: int,
                       chunk: int) -> None:
    """The row-segmented kernels index edges and rows in 32 bits."""
    if num_edges >= 2 ** 31 - chunk or out_rows >= 2 ** 31:
        raise ValueError(f"{fn}: {num_edges} edges or {out_rows} rows "
                         "exceed the row-segmented kernel's 32-bit indices")


def _row_scratch(num_edges: int, width: int, chunk: int, device):
    """Scratch of the row-segmented kernels' carry pass, in one
    allocation: a ``width``-float line per chunk of edges for the rows
    that cross a chunk boundary (``head``: the row continues from an
    earlier chunk; ``tail``: it starts here), and a 3-int record per chunk.
    Returns the buffer (keep it alive until the launch) and the three
    addresses."""
    nchunks = max(1, -(-num_edges // chunk))
    line = nchunks * max(width, 1)
    buf = torch.empty(2 * line + 3 * nchunks, dtype=torch.float32,
                      device=device)
    head = buf.data_ptr()
    return buf, head, head + 4 * line, head + 8 * line


def split_segment(nslab: int, L: int, sms: int) -> int:
    """Slabs a thread block of :func:`fused_place_scatter`'s split walk
    sums at most (``S``): the slab-tiles of the stream (a tile is 32
    lanes) over two blocks for each of the card's ``sms`` SMs, since two
    fit on an SM; at least 4, so that a piece's partial (64 KB a tile)
    stays small beside the slabs it sums. Runs of up to ``S`` slabs stay
    whole, longer ones are cut into pieces that separate blocks sum."""
    return max(4, -(-nslab * (L // 32) // (2 * sms)))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------
# sorted_scatter / sorted_gather: each the transpose of the other
# --------------------------------------------------------------------------

def _scatter(msgs, local, out_blk, out_rows, row_block, edge_block,
             rows_sorted):
    fn = "sorted_scatter"
    if _device_of(fn, msgs, (("local", local), ("out_blk", out_blk))) \
            == "cpu":
        return sorted_scatter_reference(msgs, local, out_blk, out_rows,
                                        row_block, edge_block)
    lib = _library("sorted_scatter")
    _check_tensors(fn, (("msgs", msgs, torch.float32, True),
                        ("local", local, torch.int32, True),
                        ("out_blk", out_blk, torch.int32, True)))
    if msgs.dim() != 2:
        raise ValueError(f"{fn}: expected msgs (E, L)")
    nslab = _check_stream(fn, msgs.shape[0], local, out_blk, row_block,
                          edge_block,
                          _ROWS_MAX_EDGE_BLOCK if rows_sorted
                          else lib.mrgcn_sorted_scatter_max_edge_block())
    L = msgs.shape[1]
    _check_lanes(fn, L, lib.mrgcn_sorted_scatter_lane_tile())
    if msgs.data_ptr() % 16:
        raise ValueError(f"{fn}: msgs must be 16-byte aligned")
    if out_rows < 0:
        raise ValueError(f"{fn}: out_rows must be >= 0")
    if rows_sorted:
        _check_row_indices(fn, msgs.shape[0], out_rows,
                           lib.mrgcn_sorted_scatter_rows_chunk())
        out = torch.empty(out_rows, L, dtype=torch.float32,
                          device=msgs.device)
        if out_rows == 0:
            return out
        _buf, head, tail, meta = _row_scratch(
            msgs.shape[0], L, lib.mrgcn_sorted_scatter_rows_chunk(),
            msgs.device)
        with torch.cuda.device(msgs.device):
            rc = lib.mrgcn_sorted_scatter_rows_f32(
                msgs.data_ptr(), local.data_ptr(), out_blk.data_ptr(),
                out.data_ptr(), head, tail, meta, nslab, edge_block,
                row_block, out_rows, L, _cuda_stream(msgs))
        _raise_on(fn, lib, rc)
        sorted_scatter.launches += 1
        sorted_scatter.launches_rows += 1
        return out
    _check_smem(fn, lib.mrgcn_sorted_scatter_smem_bytes(row_block,
                                                        edge_block),
                row_block)
    # the block walk writes only the blocks some slab visits
    out = torch.zeros(out_rows, L, dtype=torch.float32, device=msgs.device)
    if nslab == 0 or out_rows == 0:
        return out
    with torch.cuda.device(msgs.device):
        rc = lib.mrgcn_sorted_scatter_f32(
            msgs.data_ptr(), local.data_ptr(), out_blk.data_ptr(),
            out.data_ptr(), nslab, edge_block, row_block, out_rows, L,
            _cuda_stream(msgs))
    _raise_on(fn, lib, rc)
    sorted_scatter.launches += 1
    return out


def _gather(table, local, tbl_idx, row_block, edge_block):
    fn = "sorted_gather"
    if _device_of(fn, table, (("local", local), ("tbl_idx", tbl_idx))) \
            == "cpu":
        return sorted_gather_reference(table, local, tbl_idx, row_block,
                                       edge_block)
    lib = _library("sorted_gather")
    _check_tensors(fn, (("table", table, torch.float32, True),
                        ("local", local, torch.int32, True),
                        ("tbl_idx", tbl_idx, torch.int32, True)))
    if table.dim() != 2:
        raise ValueError(f"{fn}: expected table (T, L)")
    nslab = _check_stream(fn, local.numel(), local, tbl_idx, row_block,
                          edge_block,
                          lib.mrgcn_sorted_gather_max_edge_block())
    L = table.shape[1]
    _check_lanes(fn, L, 4)
    if table.data_ptr() % 16:
        raise ValueError(f"{fn}: table must be 16-byte aligned")
    out = torch.empty(nslab * edge_block, L, dtype=torch.float32,
                      device=table.device)
    if nslab == 0:
        return out
    with torch.cuda.device(table.device):
        rc = lib.mrgcn_sorted_gather_f32(
            table.data_ptr(), local.data_ptr(), tbl_idx.data_ptr(),
            out.data_ptr(), nslab, edge_block, row_block, table.shape[0],
            L, _cuda_stream(table))
    _raise_on(fn, lib, rc)
    sorted_gather.launches += 1
    return out


class _SortedScatter(torch.autograd.Function):
    """The transpose of the scatter-add is the gather on the same stream
    (``pallas_gather._sorted_scatter_bwd``)."""

    @staticmethod
    def forward(ctx, msgs, local, out_blk, out_rows, row_block, edge_block,
                rows_sorted):
        ctx.save_for_backward(local, out_blk)
        ctx.blocks = (row_block, edge_block)
        return _scatter(msgs, local, out_blk, out_rows, row_block,
                        edge_block, rows_sorted)

    @staticmethod
    def backward(ctx, g):
        local, out_blk = ctx.saved_tensors
        return (_gather(g.contiguous(), local, out_blk, *ctx.blocks),
                None, None, None, None, None, None)


class _SortedGather(torch.autograd.Function):
    """The transpose of the gather is a scatter-add into the table: a
    segment sum (``index_add_``), as ``pallas_gather._sorted_gather_bwd``
    has it, because the gather's block ids need not be sorted."""

    @staticmethod
    def forward(ctx, table, local, tbl_idx, row_block, edge_block):
        ctx.save_for_backward(local, tbl_idx)
        ctx.args = (table.shape[0], row_block, edge_block)
        return _gather(table, local, tbl_idx, row_block, edge_block)

    @staticmethod
    def backward(ctx, g):
        local, tbl_idx = ctx.saved_tensors
        return (sorted_scatter_reference(g, local, tbl_idx, *ctx.args),
                None, None, None, None)


def sorted_scatter(msgs: torch.Tensor, local: torch.Tensor,
                   out_blk: torch.Tensor, out_rows: int, row_block: int,
                   edge_block: int, rows_sorted: bool = False
                   ) -> torch.Tensor:
    """``out[out_blk[e // EB] * RB + local[e]] += msgs[e]`` over a stream
    whose per-slab block ids never decrease; ``local == row_block`` marks
    padding. Returns ``(out_rows, L)`` f32, zero in rows no edge visits.

    CPU tensors take :func:`sorted_scatter_reference`, whatever
    ``rows_sorted`` says. CUDA tensors launch a hand-written kernel on the
    current stream (no synchronisation) or raise; there is no fallback:
    with ``rows_sorted`` (the real edges' scatter rows never decrease, as
    the planner's ``Stream.rows_sorted`` records) the row-segmented kernel,
    else the block walk. ``sorted_scatter.launches`` counts the launches,
    ``sorted_scatter.launches_rows`` those on the row-segmented kernel.

    Differentiable in ``msgs``: the backward is :func:`sorted_gather` on
    the same stream. (The layer ops that call it under their own backward
    call it again on a differently sorted stream instead.)
    """
    return _SortedScatter.apply(msgs, local, out_blk, out_rows, row_block,
                                edge_block, bool(rows_sorted))


def sorted_gather(table: torch.Tensor, local: torch.Tensor,
                  tbl_idx: torch.Tensor, row_block: int,
                  edge_block: int) -> torch.Tensor:
    """``G[e] = table[tbl_idx[e // EB] * RB + local[e]]`` with zero rows
    where ``local == row_block`` (padding). Exact in f32 (a copy).

    ``table``: ``(T, L)`` f32; returns ``(nslab * EB, L)`` f32. CPU tensors
    take :func:`sorted_gather_reference`; CUDA tensors launch the kernel or
    raise. ``sorted_gather.launches`` counts the kernel launches.

    Differentiable in ``table``: the backward scatter-adds into it with
    ``index_add_`` (the block ids may come in any order).
    """
    return _SortedGather.apply(table, local, tbl_idx, row_block, edge_block)


# --------------------------------------------------------------------------
# fused forms
# --------------------------------------------------------------------------

def fused_place_scatter(V: torch.Tensor, place_mod: torch.Tensor,
                        norm: torch.Tensor, local: torch.Tensor,
                        out_blk: torch.Tensor, out_rows: int, k: int,
                        L: int, row_block: int, edge_block: int,
                        rows_sorted: bool = False) -> torch.Tensor:
    """``out[out_blk * RB + local] += place(norm * V, place_mod)`` in one
    pass: edge ``e``'s ``Lv`` values land in lanes ``[place_mod[e] * L/k,
    ... + Lv)`` of its row of the packed ``(out_rows, L)`` result, without
    an ``(E, L)`` temporary. Rows no edge visits are zero.

    ``V``: ``(E_pad, Lv)`` f32 with ``Lv <= L // k`` (rows may be strided);
    ``place_mod`` int32 and ``norm`` f32: ``(E_pad,)``. Not differentiable:
    the layer ops carry their own backward. CPU tensors take
    :func:`fused_place_scatter_reference`, whatever ``rows_sorted`` says;
    CUDA tensors launch a kernel or raise: with ``rows_sorted`` (the real
    edges' scatter rows never decrease) the row-segmented kernel, else the
    split walk. ``fused_place_scatter.launches`` counts the launches,
    ``fused_place_scatter.launches_rows`` those on the row-segmented
    kernel.
    """
    fn = "fused_place_scatter"
    if V.dim() != 2 or k <= 0 or L % k or V.shape[1] > L // k:
        raise ValueError(f"{fn}: V {tuple(V.shape)} does not fit slots of "
                         f"{L}/{k} lanes")
    if _device_of(fn, V, (("place_mod", place_mod), ("norm", norm),
                          ("local", local), ("out_blk", out_blk))) == "cpu":
        return fused_place_scatter_reference(
            V, place_mod, norm, local, out_blk, out_rows, k, L, row_block,
            edge_block)
    lib = _library("fused_place_scatter")
    _check_tensors(fn, (("V", V, torch.float32, False),
                        ("place_mod", place_mod, torch.int32, True),
                        ("norm", norm, torch.float32, True),
                        ("local", local, torch.int32, True),
                        ("out_blk", out_blk, torch.int32, True)))
    E, Lv = V.shape
    if Lv > 1 and V.stride(1) != 1:
        raise ValueError(f"{fn}: V must be contiguous along its rows")
    nslab = _check_stream(fn, E, local, out_blk, row_block, edge_block,
                          _ROWS_MAX_EDGE_BLOCK if rows_sorted else
                          lib.mrgcn_fused_place_scatter_max_edge_block())
    if place_mod.shape != (E,) or norm.shape != (E,):
        raise ValueError(f"{fn}: place_mod and norm must be ({E},)")
    _check_lanes(fn, L, lib.mrgcn_fused_place_scatter_lane_tile())
    if out_rows < 0:
        raise ValueError(f"{fn}: out_rows must be >= 0")
    if rows_sorted:
        _check_row_indices(fn, E, out_rows,
                           lib.mrgcn_fused_place_rows_chunk())
    else:
        _check_smem(fn, lib.mrgcn_fused_place_scatter_smem_bytes(
            row_block, edge_block), row_block)
    out = torch.empty(out_rows, L, dtype=torch.float32, device=V.device)
    if out_rows == 0:
        return out
    ldv = V.stride(0) if E > 1 else Lv
    with torch.cuda.device(V.device):
        if rows_sorted:
            # 16-byte loads where V's pointer, row stride, width and slot
            # width allow them
            vec = 4 if (V.data_ptr() % 16 == 0 and ldv % 4 == 0
                        and Lv % 4 == 0 and (L // k) % 4 == 0) else 1
            _buf, head, tail, meta = _row_scratch(
                E, L, lib.mrgcn_fused_place_rows_chunk(), V.device)
            rc = lib.mrgcn_fused_place_rows_f32(
                V.data_ptr(), ldv, Lv, place_mod.data_ptr(),
                norm.data_ptr(), local.data_ptr(), out_blk.data_ptr(),
                out.data_ptr(), head, tail, meta, nslab, edge_block,
                row_block, out_rows, L, k, vec, _cuda_stream(V))
        else:
            sms = _sm_count(V.device)
            seg = split_segment(nslab, L, sms)
            out_blocks = -(-out_rows // row_block)
            # two (RB, L) partials a segment: a run continuing from before
            # it, and one going on past it
            partial = torch.empty(2 * max(1, -(-nslab // seg)) * row_block
                                  * L, dtype=torch.float32, device=V.device)
            rc = lib.mrgcn_fused_place_split_f32(
                V.data_ptr(), ldv, Lv, place_mod.data_ptr(),
                norm.data_ptr(), local.data_ptr(), out_blk.data_ptr(),
                out.data_ptr(), partial.data_ptr(), nslab, edge_block,
                row_block, out_rows, L, k, seg,
                max(1, min(16, -(-4 * sms // out_blocks))), _cuda_stream(V))
    _raise_on(fn, lib, rc)
    fused_place_scatter.launches += 1
    if rows_sorted:
        fused_place_scatter.launches_rows += 1
    return out


def fused_scatter_dot(dvn: torch.Tensor, w: torch.Tensor,
                      local: torch.Tensor, out_blk: torch.Tensor,
                      table: torch.Tensor, out_rows: int, row_block: int,
                      edge_block: int, rows_sorted: bool = False):
    """``out[blk * RB + local_e] += w_e * dvn_e`` and
    ``dots_e = <table[blk * RB + local_e], dvn_e>`` in one pass over a
    block-sorted stream: the scatter and the gather visit the same rows.
    Padding edges (``local == row_block``) add nothing and read zero.

    ``dvn``: ``(E_pad, Lv)`` f32 at its real width ``Lv <= L`` (rows may be
    strided); ``w``: ``(E_pad,)`` f32; ``table``: ``(out_rows, L)`` f32.
    Returns ``(out (out_rows, L), dots (E_pad,))``, lanes ``>= Lv`` of
    ``out`` zero. Not differentiable.

    CPU tensors take :func:`fused_scatter_dot_reference`, whatever
    ``rows_sorted`` says. CUDA tensors launch the row-segmented kernel
    (``Lv <= 512``) or raise; the kernel needs ``rows_sorted`` (the
    stream's real scatter rows never decrease, as the planner's
    ``Stream.rows_sorted`` records for every stream this function meets)
    and raises ``ValueError`` without it. ``fused_scatter_dot.launches``
    counts the launches, and so does ``.launches_rows``.
    """
    fn = "fused_scatter_dot"
    if dvn.dim() != 2 or table.dim() != 2 or table.shape[0] != out_rows \
            or dvn.shape[1] > table.shape[1]:
        raise ValueError(f"{fn}: dvn {tuple(dvn.shape)} and table "
                         f"{tuple(table.shape)} do not fit {out_rows} rows")
    if _device_of(fn, dvn, (("w", w), ("local", local),
                            ("out_blk", out_blk), ("table", table))) \
            == "cpu":
        return fused_scatter_dot_reference(dvn, w, local, out_blk, table,
                                           out_rows, row_block, edge_block)
    if not rows_sorted:
        raise ValueError(f"{fn}: the kernel takes a stream whose real "
                         "scatter rows never decrease; pass rows_sorted=True "
                         "for one (Stream.rows_sorted)")
    lib = _library("scatter_dot")
    _check_tensors(fn, (("dvn", dvn, torch.float32, False),
                        ("w", w, torch.float32, True),
                        ("local", local, torch.int32, True),
                        ("out_blk", out_blk, torch.int32, True),
                        ("table", table, torch.float32, True)))
    E, Lv = dvn.shape
    L = table.shape[1]
    if Lv > 1 and dvn.stride(1) != 1:
        raise ValueError(f"{fn}: dvn must be contiguous along its rows")
    nslab = _check_stream(fn, E, local, out_blk, row_block, edge_block,
                          _ROWS_MAX_EDGE_BLOCK)
    if w.shape != (E,):
        raise ValueError(f"{fn}: w must be ({E},)")
    _check_lanes(fn, L, 32)
    if table.data_ptr() % 16:
        raise ValueError(f"{fn}: table must be 16-byte aligned")
    if Lv > lib.mrgcn_scatter_dot_rows_max_width():
        raise ValueError(f"{fn}: the row-segmented kernel takes dvn rows of "
                         f"at most {lib.mrgcn_scatter_dot_rows_max_width()} "
                         f"values, got {Lv}")
    chunk = lib.mrgcn_scatter_dot_rows_chunk()
    _check_row_indices(fn, E, out_rows, chunk)
    # 16-byte loads where dvn's pointer, row stride and width allow them
    vec = 4 if (dvn.data_ptr() % 16 == 0 and dvn.stride(0) % 4 == 0
                and Lv % 4 == 0) else 1
    out = torch.empty(out_rows, L, dtype=torch.float32, device=dvn.device)
    dots = torch.empty(E, dtype=torch.float32, device=dvn.device)
    _buf, head, tail, meta = _row_scratch(E, Lv, chunk, dvn.device)
    with torch.cuda.device(dvn.device):
        rc = lib.mrgcn_scatter_dot_rows_f32(
            dvn.data_ptr(), dvn.stride(0), Lv, w.data_ptr(),
            local.data_ptr(), out_blk.data_ptr(), table.data_ptr(),
            out.data_ptr(), dots.data_ptr(), head, tail, meta, nslab,
            edge_block, row_block, out_rows, L, vec, _cuda_stream(dvn))
    _raise_on(fn, lib, rc)
    fused_scatter_dot.launches += 1
    fused_scatter_dot.launches_rows += 1
    return out, dots


# --------------------------------------------------------------------------
# single-pass compose gradient: d_comp and d_packed from one read of d_t
# --------------------------------------------------------------------------

def _packed_rows(packed: torch.Tensor, B: int) -> torch.Tensor:
    """``packed`` as ``(B, rows * L)``: a view where the rows of one basis
    are contiguous, whatever lies between two bases (a row slice of a
    larger ``(B, rows', L)`` parameter); otherwise a reshape."""
    if packed.dim() == 3 and packed.stride(2) == 1 \
            and packed.stride(1) == packed.shape[2]:
        return packed.as_strided((B, packed.shape[1] * packed.shape[2]),
                                 (packed.stride(0), 1))
    return packed.reshape(B, -1)


def _check_row_strided(fn: str, name: str, x: torch.Tensor) -> int:
    """A ``(n, cols)`` f32 operand whose rows may lie apart (the kernels
    take a leading dimension): unit column stride, a row stride that is a
    multiple of 4 floats and no less than ``cols``, 16-byte alignment.
    Returns the row stride."""
    if x.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be torch.float32, got {x.dtype}")
    ld = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    if x.stride(1) != 1 or ld < x.shape[1] or ld % 4:
        raise ValueError(f"{fn}: {name} must be contiguous, or rows of "
                         "contiguous columns a multiple of 4 floats apart")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be 16-byte aligned")
    return ld


def compose_grad_pass_reference(d_t: torch.Tensor, packed: torch.Tensor,
                                comp: torch.Tensor, R: int, B: int):
    """Plain PyTorch version of :func:`compose_grad_pass`: the two
    contractions of ``pallas_gather.compose_grad_pass``'s XLA branch."""
    L = d_t.shape[1]
    d_flat = d_t.reshape(R, -1)
    d_comp = d_flat @ _packed_rows(packed, B).T          # rql,bql->rb
    d_packed = comp.T @ d_flat                          # rb,rql->bql
    return d_comp, d_packed.reshape(-1, L)


def compose_grad_pass(d_t: torch.Tensor, packed: torch.Tensor,
                      comp: torch.Tensor, R: int, B: int):
    """Backward of the relation-major compose in one pass over ``d_t``:
    ``d_comp = einsum('rql,bql->rb', d_t, packed)`` and
    ``d_packed = einsum('rb,rql->bql', comp, d_t)``, reading the
    ``(R * rows, L)`` cotangent table once.

    ``d_t``: ``(R * rows, L)``; ``packed``: ``(B * rows, L)``, or
    ``(B, rows, L)`` whose bases may lie apart (a row slice of a larger
    parameter: no copy is made); ``comp``: ``(R, B)``, all f32. Returns
    ``(d_comp (R, B), d_packed (B * rows, L))``.
    CPU tensors take :func:`compose_grad_pass_reference`. CUDA tensors
    launch the kernel (3xTF32 on the tensor cores; ``d_comp`` from
    per-block partials summed in a fixed order: no atomics, the same bits
    every time) or raise; the kernel masks R, B and the last chunk, and
    needs only ``L`` a multiple of 4.
    ``compose_grad_pass.launches`` counts the launches.
    """
    fn = "compose_grad_pass"
    rows = d_t.shape[0] // R if d_t.dim() == 2 and R > 0 else 0
    L = d_t.shape[-1]
    fits = (B * rows, L) if packed.dim() == 2 else (B, rows, L)
    if d_t.dim() != 2 or R <= 0 or B <= 0 or comp.shape != (R, B) \
            or d_t.shape[0] % R or tuple(packed.shape) != fits:
        raise ValueError(f"{fn}: d_t {tuple(d_t.shape)}, packed "
                         f"{tuple(packed.shape)} and comp "
                         f"{tuple(comp.shape)} do not fit R={R}, B={B}")
    if _device_of(fn, d_t, (("packed", packed), ("comp", comp))) == "cpu":
        return compose_grad_pass_reference(d_t, packed, comp, R, B)
    lib = _library("compose")
    _check_tensors(fn, (("d_t", d_t, torch.float32, True),
                        ("comp", comp, torch.float32, True)))
    _check_lanes(fn, L, 4)
    if packed.dim() == 2 or packed.stride(2) != 1 \
            or packed.stride(1) != L:
        _check_tensors(fn, (("packed", packed, torch.float32, True),))
    p_rows = _packed_rows(packed, B)
    ldp = _check_row_strided(fn, "packed", p_rows)
    if d_t.data_ptr() % 16:
        raise ValueError(f"{fn}: d_t must be 16-byte aligned")
    if lib.mrgcn_compose_grad_chunk(R, B) == 0:
        raise ValueError(f"{fn}: R={R}, B={B} need more shared memory than "
                         "a thread block has")
    K = rows * L
    d_comp = torch.empty(R, B, dtype=torch.float32, device=d_t.device)
    d_packed = torch.empty(B * rows, L, dtype=torch.float32,
                           device=d_t.device)
    with torch.cuda.device(d_t.device):
        # one (R, B) partial per thread block, summed in block order
        partial = torch.empty(
            lib.mrgcn_compose_grad_ctas(R, B, K) * R * B,
            dtype=torch.float32, device=d_t.device)
        rc = lib.mrgcn_compose_grad_f32(
            d_t.data_ptr(), p_rows.data_ptr(), ldp, comp.data_ptr(),
            d_packed.data_ptr(), d_comp.data_ptr(), partial.data_ptr(), R,
            B, K, _cuda_stream(d_t))
    _raise_on(fn, lib, rc)
    compose_grad_pass.launches += 1
    return d_comp, d_packed


for _wrapper in (sorted_scatter, sorted_gather, fused_place_scatter,
                 fused_scatter_dot, compose_grad_pass):
    _wrapper.launches = 0
for _wrapper in (sorted_scatter, fused_place_scatter, fused_scatter_dot):
    _wrapper.launches_rows = 0
del _wrapper
