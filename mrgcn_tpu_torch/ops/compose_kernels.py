"""The compose micro-kernels: the forward compose and a table copy.

Counterparts of ``benchmarks/micro_compose_kernel.py::compose_table`` and
``benchmarks/micro_compose_fusion.py::canonical``: two layout experiments
over the composed identity table. :func:`compose_table` is the forward of
:func:`..rspmm.compose_packed` on the card (the JAX package leaves that
product to XLA); :func:`canonical_copy` is called only by
``chip_smoke.py``'s compose phase.

Each wrapper takes its plain PyTorch version (``*_reference``) for CPU
tensors and launches its kernel (``csrc/compose.cu``) for CUDA tensors, or
raises: there is no fallback. ``<wrapper>.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from mrgcn_tpu_torch.ops.sorted_stream import (_check_lanes,
                                               _check_row_strided,
                                               _check_tensors, _cuda_stream,
                                               _device_of, _library,
                                               _raise_on)


def compose_table_reference(comp: torch.Tensor,
                            pk_flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`compose_table`."""
    return comp @ pk_flat


def compose_table(comp: torch.Tensor, pk_flat: torch.Tensor) -> torch.Tensor:
    """``(R, B) @ (B, cols) -> (R, cols)`` in f32, written relation-major:
    with ``cols = rows * L`` the reshape to the ``(R * rows, L)`` table the
    featureless layer gathers from is free. ``pk_flat``'s rows may lie
    apart (a row slice of a larger packed parameter, viewed ``(B, cols)``):
    the kernel takes their stride, so no copy is made.

    CPU tensors take :func:`compose_table_reference`; CUDA tensors launch
    the kernel (3xTF32 on the tensor cores) or raise.
    ``compose_table.launches`` counts the launches.
    """
    fn = "compose_table"
    if comp.dim() != 2 or pk_flat.dim() != 2 \
            or comp.shape[1] != pk_flat.shape[0] or 0 in comp.shape:
        raise ValueError(f"{fn}: comp {tuple(comp.shape)} and pk_flat "
                         f"{tuple(pk_flat.shape)} do not multiply")
    if _device_of(fn, comp, (("pk_flat", pk_flat),)) == "cpu":
        return compose_table_reference(comp, pk_flat)
    lib = _library("compose")
    _check_tensors(fn, (("comp", comp, torch.float32, True),))
    R, B = comp.shape
    cols = pk_flat.shape[1]
    _check_lanes(fn, cols, 4)
    ldp = _check_row_strided(fn, "pk_flat", pk_flat)
    if lib.mrgcn_compose_table_chunk(R, B) == 0:
        raise ValueError(f"{fn}: R={R}, B={B} need more shared memory than "
                         "a thread block has")
    out = torch.empty(R, cols, dtype=torch.float32, device=comp.device)
    with torch.cuda.device(comp.device):
        rc = lib.mrgcn_compose_table_f32(
            comp.data_ptr(), pk_flat.data_ptr(), ldp, out.data_ptr(), R, B,
            cols, _cuda_stream(comp))
    _raise_on(fn, lib, rc)
    compose_table.launches += 1
    return out


def canonical_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`canonical_copy`."""
    return x.clone()


def canonical_copy(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of the f32 table ``x``.

    CPU tensors take :func:`canonical_copy_reference`; CUDA tensors launch
    the kernel or raise. ``canonical_copy.launches`` counts the launches.
    """
    fn = "canonical_copy"
    if _device_of(fn, x, ()) == "cpu":
        return canonical_copy_reference(x)
    lib = _library("compose")
    _check_tensors(fn, (("x", x, torch.float32, True),))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be 16-byte aligned")
    with torch.cuda.device(x.device):
        rc = lib.mrgcn_canonical_copy_f32(x.data_ptr(), out.data_ptr(),
                                          x.numel(), _cuda_stream(x))
    _raise_on(fn, lib, rc)
    canonical_copy.launches += 1
    return out


compose_table.launches = 0
canonical_copy.launches = 0
