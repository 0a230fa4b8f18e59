"""Block-sorted scatter-add: the CUDA kernel and its plain version.

Counterpart of :mod:`mrgcn_tpu.ops.pallas_gather` for the part the
featureless full-batch path runs: ``ROW_BLOCK``, ``EDGE_BLOCK`` and
:func:`sorted_scatter`.

An edge stream is cut into slabs of ``edge_block`` edges; slab ``s``
addresses one ``row_block``-row block ``blk[s]`` of the output, block ids
never decrease along the stream, and ``local[s, j]`` is the edge's row
inside that block (``row_block`` on padding). The CUDA kernel
(``csrc/sorted_scatter.cu``) gives each run of equal block ids to one
thread block that accumulates it in shared memory, so the sum is
deterministic and needs no atomics.
"""

from __future__ import annotations

import ctypes

import torch

from mrgcn_tpu_torch.ops import _build

ROW_BLOCK = 512    # output rows per block
EDGE_BLOCK = 256   # edges per slab

# shared memory one thread block may use on Hopper (232,448 bytes)
_SMEM_LIMIT = 227 * 1024


def sorted_scatter_reference(msgs: torch.Tensor, local: torch.Tensor,
                             out_blk: torch.Tensor, out_rows: int,
                             row_block: int, edge_block: int
                             ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sorted_scatter` (``index_add_`` over
    the valid edges): the counterpart of ``pallas_gather._xla_scatter``.
    Rows outside ``[0, out_rows)`` are dropped, as ``segment_sum`` does."""
    del edge_block
    rows = (out_blk.long()[:, None] * row_block + local.long()).reshape(-1)
    valid = ((local >= 0) & (local < row_block)).reshape(-1) \
        & (rows >= 0) & (rows < out_rows)
    out = torch.zeros(out_rows, msgs.shape[1], dtype=msgs.dtype,
                      device=msgs.device)
    return out.index_add_(0, rows[valid], msgs[valid])


def _library():
    kl = _build.load("sorted_scatter")
    lib = kl.lib
    if not getattr(lib, "_mrgcn_typed", False):
        lib.mrgcn_sorted_scatter_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.mrgcn_sorted_scatter_f32.restype = ctypes.c_int
        lib.mrgcn_sorted_scatter_smem_bytes.argtypes = [ctypes.c_int,
                                                        ctypes.c_int]
        lib.mrgcn_sorted_scatter_smem_bytes.restype = ctypes.c_size_t
        lib.mrgcn_sorted_scatter_lane_tile.argtypes = []
        lib.mrgcn_sorted_scatter_lane_tile.restype = ctypes.c_int
        lib.mrgcn_sorted_scatter_max_edge_block.argtypes = []
        lib.mrgcn_sorted_scatter_max_edge_block.restype = ctypes.c_int
        lib.mrgcn_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mrgcn_cuda_error_string.restype = ctypes.c_char_p
        lib._mrgcn_typed = True
    return lib


def _check_cuda_args(msgs, local, out_blk, out_rows, row_block,
                     edge_block, lib) -> None:
    for name, t, dtype in (("msgs", msgs, torch.float32),
                           ("local", local, torch.int32),
                           ("out_blk", out_blk, torch.int32)):
        if t.device != msgs.device:
            raise ValueError(f"sorted_scatter: {name} is on {t.device}, "
                             f"msgs on {msgs.device}")
        if t.dtype != dtype:
            raise TypeError(f"sorted_scatter: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sorted_scatter: {name} must be contiguous")
    if msgs.dim() != 2 or local.dim() != 2 or out_blk.dim() != 1:
        raise ValueError("sorted_scatter: expected msgs (E, L), local "
                         "(nslab, EB) and out_blk (nslab,)")
    nslab, eb = local.shape
    L = msgs.shape[1]
    if eb != edge_block or out_blk.shape[0] != nslab \
            or msgs.shape[0] != nslab * edge_block:
        raise ValueError(
            f"sorted_scatter: shapes disagree: msgs {tuple(msgs.shape)}, "
            f"local {tuple(local.shape)}, out_blk {tuple(out_blk.shape)}, "
            f"edge_block {edge_block}")
    lanes = lib.mrgcn_sorted_scatter_lane_tile()
    if L == 0 or L % lanes:
        raise ValueError(f"sorted_scatter: the kernel takes L a positive "
                         f"multiple of {lanes}, got {L}")
    if not 0 < edge_block <= lib.mrgcn_sorted_scatter_max_edge_block():
        raise ValueError(f"sorted_scatter: edge_block {edge_block} out of "
                         "the kernel's range")
    if row_block <= 0 or lib.mrgcn_sorted_scatter_smem_bytes(
            row_block, edge_block) > _SMEM_LIMIT:
        raise ValueError(f"sorted_scatter: row_block {row_block} needs "
                         "more shared memory than a thread block has")
    if msgs.data_ptr() % 16:
        raise ValueError("sorted_scatter: msgs must be 16-byte aligned")
    if out_rows < 0:
        raise ValueError("sorted_scatter: out_rows must be >= 0")


def sorted_scatter(msgs: torch.Tensor, local: torch.Tensor,
                   out_blk: torch.Tensor, out_rows: int, row_block: int,
                   edge_block: int) -> torch.Tensor:
    """``out[out_blk[e // EB] * RB + local[e]] += msgs[e]`` over a stream
    whose per-slab block ids never decrease; ``local == row_block`` marks
    padding. Returns ``(out_rows, L)`` f32, zero in blocks no slab visits.

    CPU tensors take :func:`sorted_scatter_reference`. CUDA tensors launch
    the hand-written kernel on the current stream (no synchronisation) or
    raise; there is no fallback. ``sorted_scatter.launches`` counts the
    kernel launches.

    Not differentiable: the layer ops that call it carry their own
    backward, which calls it again on a differently sorted stream.
    """
    for name, t in (("local", local), ("out_blk", out_blk)):
        if t.device != msgs.device:
            raise ValueError(f"sorted_scatter: {name} is on {t.device}, "
                             f"msgs on {msgs.device}")
    if msgs.device.type == "cpu":
        return sorted_scatter_reference(msgs, local, out_blk, out_rows,
                                        row_block, edge_block)
    if msgs.device.type != "cuda":
        raise ValueError(f"sorted_scatter: no kernel for device "
                         f"{msgs.device}")
    lib = _library()
    _check_cuda_args(msgs, local, out_blk, out_rows, row_block,
                     edge_block, lib)
    out = torch.zeros(out_rows, msgs.shape[1], dtype=torch.float32,
                      device=msgs.device)
    nslab = local.shape[0]
    if nslab == 0 or out_rows == 0:
        return out
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        rc = lib.mrgcn_sorted_scatter_f32(
            msgs.data_ptr(), local.data_ptr(), out_blk.data_ptr(),
            out.data_ptr(), nslab, edge_block, row_block, out_rows,
            msgs.shape[1], stream)
    if rc != 0:
        raise RuntimeError("sorted_scatter: kernel launch failed: "
                           + lib.mrgcn_cuda_error_string(rc).decode())
    sorted_scatter.launches += 1
    return out


sorted_scatter.launches = 0
