#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mrgcn_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, the CUDA toolkit (``nvcc``) and no network, and it fails (exit code
other than 0, no result line) where CUDA is absent or the repository is not
beside it. ``--only a,b`` runs some phases alone (``stream``, ``nc``,
``lp``, ``encoders``, ``agree``, and ``profile``: a ``torch.profiler``
breakdown of the link-prediction step, never part of the whole run) and
then prints no result line. Phases, each printing its own lines:

1. the card, as ``nvidia-smi`` and torch see it;
2. the kernels, built from ``mrgcn_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together; with ptxas' report);
3. the stream kernels against their plain PyTorch versions on the card
   (f32 sums in other orders: atol 1e-4 / rtol 1e-5; ``sorted_gather`` bit
   for bit):
   ``sorted_scatter`` and ``fused_place_scatter`` on the four layer-0
   streams one multimodal training step scatters on the DMG-scale bench
   graph (``benchmarks/torch_baseline.build_workload``): the identity
   half's ``fwd`` and ``bwd_table``, the dense feature half's ``fwd`` and
   ``bwd_h``; ``fused_place_scatter``, ``fused_scatter_dot`` and
   ``sorted_gather`` on the link-prediction graph's streams (FB15k-237's
   sizes, hidden 200: ``fwd`` and the dst-sorted ``bwd_h``); and all four
   on small adversarial streams (padding, a run of one slab, all-padding
   slabs, repeated and unvisited blocks, ragged output rows, ``k`` 1 and
   8, values narrower than their slot);
4. the featureless NC path: ``mrgcn_tpu_torch.run`` trains the featureless
   full-batch NC model (``configs/dmg.toml``'s ``[model]``: 2 layers,
   hidden 16, 40 bases) for 5 epochs on the DMG-scale graph with random
   weights from seed 0, then evaluates on the test split;
5. the multimodal NC path: the same CLI and model over DMG's numeric (4),
   gYear (1) and string (16, the from-scratch text encoder: d=128, one
   head, two blocks, bf16 body) features, drawn from seed 0 at
   ``benchmarks/bench_suite.multimodal_workload``'s counts (20,000
   numbers, 10,000 years, 8,000 byte strings of length 1-128), 5 epochs;
6. the link-prediction path, this slice's main path: the same CLI with
   ``[task] type = 'link prediction'`` on a synthetic graph at FB15k-237's
   sizes (14,541 entities, 475 relations, 272,115 / 17,535 / 20,466
   triples from seed 0), ``configs/fb15k-237.toml``'s ``[model]`` with the
   two 200-wide R-GCN layers ``benchmarks/bench_suite.bench_lp`` times, 2
   bases, full graph (``gcn_batchsize = -1``, ``test_batchsize = -1``: one
   batch of all train triples per epoch; the only cut). It trains 30
   epochs, ten more than the config's 20, ranking the train and valid
   triples every 10 (``eval_interval = 10``, the config's), then makes
   the final filtered ranking of the test split. The losses must be
   finite, never rise above the first, and end at least 0.01 below it (at
   this width the f32 loss stays at ln 2 until about epoch 20, then
   falls fast).
   Each path's kernel launch counts are set to 0 just before it and read
   just after: every kernel it runs must have launched. The paths run
   before phase 7: run after it, the featureless epoch measured about
   15 % slower than in a fresh process (H100 80GB HBM3, 700 W).
   Then, counted apart from every path, the gradient of
   ``featureless_basis`` from its own backward (``fused_scatter_dot``)
   against autograd through the same forward written with differentiable
   gathers and the differentiable ``sorted_scatter`` (whose backward
   launches ``sorted_gather``), at full width: within 1e-4 of the largest
   value. No entry point differentiates ``sorted_scatter`` through
   autograd, so ``sorted_gather`` reads 0 launches on every path; this
   check's launches stand under ``gradient_check_launches``;
7. the fused attention and fused MLP kernels, forward and backward,
   against their plain versions at the multimodal slice's shapes
   (attention N=8,000, L=128, d=128; MLP 1,024,000 rows, 128 -> 512 ->
   128, bf16) and on adversarial ones (N not a multiple of 8, L=37, a
   sequence that is all padding, one of length 1, L=300 and 512 on the
   long-sequence kernels, rows not a multiple of the row block), and
   the long-sequence kernels timed at N=2,000, L=512. Each element is
   held to ``|got - want| <= 2^-6 (|want| + scale) + 1e-6``, ``scale``
   being its product over absolute values
   (``mrgcn_tpu_torch.ops.kernel_bounds``: bf16 intermediates rounded
   from f32 sums taken in other orders land a bf16 step apart);
8. small graphs on the card and on the CPU (plain versions). NC through
   the CLI, featureless and multimodal: the per-epoch losses must agree
   (rtol 1e-4 featureless; 1e-3 multimodal, whose text encoder rounds to
   bf16); and each encoder, with the same weights on both sides, gives
   the same outputs before its gate (max error relative to the largest
   value) and the same parameter gradients (error norm relative to the
   gradient's norm): 1e-4 for the f32 MLP encoders; 1e-2 for the outputs
   and 1e-1 for the gradients of the bf16 text encoder. LP on the
   basis-stream path, both sides fed the same corrupted triples: every
   step's loss agrees within 1e-4 relative and every parameter's gradient
   within 1e-4 of its largest entry, on a small graph for three steps
   (the losses fall; test ranks equal except where near-equal scores
   change order: at most 2 % of them, the count is printed) and on the
   FB15k-237-size graph at full width for one step.

Every kernel comparison checks bit identity across two runs, and the
slice-shape ones time the kernel, the plain version and, where one PyTorch
call computes the same function, that call (median of 20 CUDA-event timed
calls, in the order plain, kernel, kernel, plain). Each timed row carries
its bound: the larger of the bytes the function must move over the card's
3.35 TB/s and its operations over the card's peak for their type (67
TFLOP/s f32, 989 TFLOP/s bf16 tensor cores), with both counts. Then one
JSON line with every kernel's numbers, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tomllib
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
EPOCHS = 5
ATOL, RTOL = 1e-4, 1e-5
TIMED_CALLS = 20
# encoder (outputs, parameter gradients), card vs CPU (see
# encoder_agreement). Sound kernels: the f32 MLP encoders agree to 3e-6,
# the bf16 text encoder to 1.1e-3 and 2.8e-2 over five cotangents. One key
# tile of 16 dropped from the attention forward's P V read 0.29 (output);
# its dk/dv zeroed in the backward, 0.26 (gradients); the losses stayed
# within 2e-4 either way (H100 80GB HBM3, 700 W). The gradients are read
# by norm: their largest-element error moved 2.6e-2 to 8.0e-2 between
# runs, with the weights the CPU side's training ends at
ENCODER_RTOL = {"mlp": (1e-4, 1e-4), "text": (1e-2, 1e-1)}
KERNEL_SOURCES = ("sorted_scatter", "sorted_gather", "fused_place_scatter",
                  "scatter_dot", "fused_attention", "fused_mlp")
# configs/fb15k-237.toml trains 20 epochs and ranks every 10. The f32 loss
# sits at ln 2 until epoch 20 (the scores start near 1e-5 and the mean
# BCE's gradient entries below Adam's eps, so the parameters creep) and
# then falls fast: ten more epochs show it (0.6931 -> 0.5052 on an H100 80GB
# HBM3 at 700 W)
LP_EPOCHS, LP_EVAL_INTERVAL = 30, 10
LP_HIDDEN = 200
# published peaks of one H100 SXM: HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense bf16 tensor-core FLOP/s
HBM_BYTES_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
MULTIMODAL = ("xsd.numeric", "xsd.gYear", "xsd.string")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return line


def build_kernels() -> None:
    from mrgcn_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.load_all(KERNEL_SOURCES, rebuild=True)
    print(f"[build] {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s (built in parallel)")
    for name, kl in libs.items():
        print(f"[build] {name}: {kl.build_seconds:.1f} s -> "
              f"{kl.path.relative_to(ROOT)}")
        for line in kl.ptxas_log.splitlines():
            if any(w in line for w in ("Compiling", "registers", "spill",
                                       "smem")):
                print(f"[build]   {line.strip()}")


def time_ms(fn) -> float:
    """Median per-call milliseconds over TIMED_CALLS CUDA-event-timed
    calls, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMED_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_pair(kernel, plain, library=None) -> dict:
    """Median ms of kernel and plain, in the order plain, kernel, kernel,
    plain; each keeps the faster of its two runs. ``library``, where
    given, is timed last."""
    plain_a = time_ms(plain)
    kern_a = time_ms(kernel)
    kern_b = time_ms(kernel)
    plain_b = time_ms(plain)
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b],
            "library_ms": time_ms(library) if library else None}


def bound(moved: float, flops: float, flops_peak: float) -> dict:
    """The least time the card could take: the bytes the function must
    move (each input read once, each output written once) over the card's
    memory rate, or its operations over the card's peak rate for their
    type, whichever is larger."""
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_flops = flops / flops_peak * 1e3
    return {"bound_ms": max(by_bytes, by_flops),
            "bound_by": "bytes" if by_bytes >= by_flops else "operations",
            "bytes": int(moved), "flops": int(flops)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_stream(name, label, kernel, plain, library=None, work=None,
                   exact=False, shape=None) -> dict:
    """One stream kernel against its plain version: shapes, finiteness,
    tolerance (or bit equality with ``exact``), two bit-identical runs;
    with ``work`` (bytes, f32 operations) also the timings and the
    bound."""
    import torch
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    err = 0.0
    for i, (g, a, w) in enumerate(zip(*map(as_tuple, (got, again, want)))):
        what = f"{name} {label} output {i}"
        check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
        e = float((g - w).abs().max()) if g.numel() else 0.0
        err = max(err, e)
        ok = torch.equal(g, w) if exact \
            else torch.allclose(g, w, atol=ATOL, rtol=RTOL)
        check(ok, f"{what}: kernel disagrees with plain (max abs err {e})")
        check(torch.equal(g, a), f"{what}: two runs differ")
    row = {"label": label, **(shape or {}), "max_abs_err": err}
    if work is not None:
        row.update(timed_pair(kernel, plain, library))
        row.update(bound(work[0], work[1], F32_FLOPS))
    print(f"[kernel] {name} {json.dumps(row)}")
    return row


def adversarial_stream(rng, nslab, rb, eb, n_blocks, L, device):
    import numpy as np
    import torch
    blk = np.sort(rng.choice(np.arange(0, n_blocks, 2), nslab))  # repeats,
    # and the odd blocks are never visited
    local = rng.integers(0, rb, (nslab, eb))
    local[rng.random((nslab, eb)) < 0.15] = rb                  # padding
    local[:, :3] = local[:, :1]                                 # same row
    local[nslab // 2] = rb                        # a slab of padding only
    blk[-1] = n_blocks                            # a run of one slab
    msgs = rng.standard_normal((nslab * eb, L)).astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return t(msgs, torch.float32), t(local, torch.int32), t(blk, torch.int32)


def multimodal_width() -> int:
    """``X_width`` of the multimodal path: the summed embedding widths of
    ``configs/dmg.toml``'s ``MULTIMODAL`` features (4 + 1 + 16)."""
    with open(ROOT / "configs" / "dmg.toml", "rb") as f:
        dmg = tomllib.load(f)
    return sum(f["embedding_dim"] for f in dmg["graph"]["features"]
               if f["datatype"] in MULTIMODAL)


def stream_shape(stream, out_rows, L) -> dict:
    import torch
    return {"E_pad": stream.num_padded_edges, "slabs": stream.num_slabs,
            "runs": int(torch.unique_consecutive(stream.scatter_blk).numel()),
            "out_rows": out_rows, "L": L}


def edge_rows(local, blk, rb, num_rows):
    """Per-edge table rows with padding sent to a dump row ``num_rows``:
    what a library call (``index_add_``, a row gather) is given."""
    import torch
    rows = (blk.long()[:, None] * rb + local.long()).reshape(-1)
    valid = (local.reshape(-1) < rb) & (rows < num_rows)
    return torch.where(valid, rows, torch.full_like(rows, num_rows))


def scatter_cases(names, label, stream, place, out_rows, L, k, d, gen,
                  device) -> dict:
    """``sorted_scatter`` (on random full lines) and
    ``fused_place_scatter`` (on random ``d``-wide values placed at the
    slots ``place``, the stream's ``out_mod`` or ``in_mod``) on one
    stream, each against its plain version and against ``index_add_`` on
    lines expanded beforehand."""
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    local, blk = stream.scatter_local, stream.scatter_blk
    rb, eb, E = stream.row_block, stream.edge_block, stream.num_padded_edges
    shape = stream_shape(stream, out_rows, L)
    rows = edge_rows(local, blk, rb, out_rows)
    real = int((rows < out_rows).sum())
    out = {}

    def index_add(msgs):
        return lambda: torch.zeros(out_rows + 1, L, device=device) \
            .index_add_(0, rows, msgs)

    if "sorted_scatter" in names:
        msgs = torch.randn(E, L, generator=gen, device=device)
        args = (msgs, local, blk, out_rows, rb, eb)
        out["sorted_scatter"] = compare_stream(
            "sorted_scatter", label, lambda: ss.sorted_scatter(*args),
            lambda: ss.sorted_scatter_reference(*args), index_add(msgs),
            (nbytes(msgs, local, blk) + out_rows * L * 4, real * L),
            shape=shape)
        del msgs
    if "fused_place_scatter" in names:
        V = torch.randn(E, d, generator=gen, device=device)
        args = (V, place, stream.norm, local, blk, out_rows, k, L, rb, eb)
        lines = ss.expand_sub(V * stream.norm[:, None], place, k, L)
        out["fused_place_scatter"] = compare_stream(
            "fused_place_scatter", label,
            lambda: ss.fused_place_scatter(*args),
            lambda: ss.fused_place_scatter_reference(*args),
            index_add(lines),
            (nbytes(V, place, stream.norm, local, blk) + out_rows * L * 4,
             2 * real * d),
            shape={**shape, "Lv": d, "k": k})
        del V, lines
    return out


def nc_stream_phase(work, device, rows) -> None:
    """``sorted_scatter`` and ``fused_place_scatter`` on every stream the
    NC paths' layer 0 scatters (the identity half's ``fwd`` and
    ``bwd_table``; with features, the dense half's ``fwd`` and
    ``bwd_h``)."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.models.rgcn import EdgeBlock
    from mrgcn_tpu_torch.ops.relational import line_width
    from mrgcn_tpu_torch.tasks.common import restricted_layer_edges

    n = work["n"]
    structure = SimpleNamespace(src=work["src"], dst=work["dst"],
                                rel=work["rel"], norm=work["norm"],
                                num_nodes=n)
    full = EdgeBlock(src=torch.as_tensor(work["src"]),
                     dst=torch.as_tensor(work["dst"]),
                     rel=torch.as_tensor(work["rel"]),
                     norm=torch.as_tensor(work["norm"]), num_out=n)
    t0 = time.perf_counter()
    x_width, hidden = multimodal_width(), work["hidden"]
    chain = restricted_layer_edges(structure, np.unique(work["labels_idx"]),
                                   2, full, first_dim=hidden,
                                   X_width=x_width, featureless=False,
                                   device=device)
    ident, dense = chain[0].plans["8:8:id"], chain[0].plans["4:8"]
    print(f"[kernel] NC layer-0 plans built in "
          f"{time.perf_counter() - t0:.1f} s: {ident.out_nodes} output nodes")

    gen = torch.Generator(device=device).manual_seed(0)
    # one training step's four scatters, in the order the step makes them:
    # (stream, slot array, out rows, k, value width)
    for label, stream, mod, out_rows, k, d in (
            ("fwd", ident.fwd, ident.fwd.out_mod, ident.n_out_rows,
             ident.k_out, hidden),
            ("dense_fwd", dense.fwd, dense.fwd.out_mod, dense.n_out_rows,
             dense.k_out, hidden),
            ("dense_bwd_h", dense.bwd_h, dense.bwd_h.in_mod,
             dense.n_in_rows, dense.k_in, x_width),
            ("bwd_table", ident.bwd_table, ident.bwd_table.in_mod,
             work["R"] * ident.n_in_rows, ident.k_in, hidden)):
        L = line_width(k, d)
        print(f"[kernel] stream {label}: E_pad {stream.num_padded_edges}, "
              f"relation-constant {stream.rel_const}, {out_rows} out rows")
        got = scatter_cases(("sorted_scatter", "fused_place_scatter"),
                            label, stream, mod, out_rows, L, k, d, gen,
                            device)
        for name, row in got.items():
            rows[name].append(row)
    torch.cuda.empty_cache()


def lp_plans(artifact_path: Path, device):
    """The link-prediction graph's basis-stream plans (``1:1:idb``)."""
    from mrgcn_tpu_torch.data import artifact as artifact_io
    from mrgcn_tpu_torch.ops import relational as rl
    st = artifact_io.load(str(artifact_path)).structure
    t0 = time.perf_counter()
    plans = rl.plans_for_layers(st.src, st.dst, st.rel, st.norm,
                                st.num_nodes, [(None, LP_HIDDEN)],
                                identity_basis=True, device=device)
    print(f"[kernel] LP plans built in {time.perf_counter() - t0:.1f} s")
    return plans["1:1:idb"], st.num_relations


def lp_stream_phase(plan, device, rows) -> None:
    """``fused_place_scatter`` on the LP ``fwd`` stream,
    ``fused_scatter_dot`` on its dst-sorted ``bwd_h`` stream and
    ``sorted_gather`` on the ``fwd`` stream (the backward of the
    differentiable ``sorted_scatter``), at hidden 200 in 256-lane rows."""
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    from mrgcn_tpu_torch.ops.relational import line_width
    gen = torch.Generator(device=device).manual_seed(1)
    d, L = LP_HIDDEN, line_width(1, LP_HIDDEN)

    f = plan.fwd
    got = scatter_cases(("fused_place_scatter",), "lp_fwd", f, f.out_mod,
                        plan.n_out_rows, L, 1, d, gen, device)
    rows["fused_place_scatter"].append(got["fused_place_scatter"])

    h = plan.bwd_h
    local, blk, rb, eb = h.scatter_local, h.scatter_blk, h.row_block, \
        h.edge_block
    E, T = h.num_padded_edges, plan.n_in_rows
    dvn = torch.randn(E, d, generator=gen, device=device) * h.norm[:, None]
    w = torch.randn(E, generator=gen, device=device)
    table = torch.randn(T, L, generator=gen, device=device)
    hrows = edge_rows(local, blk, rb, T)
    real = int((hrows < T).sum())
    msgs = torch.nn.functional.pad(dvn * w[:, None], (0, L - d))
    args = (dvn, w, local, blk, table, T, rb, eb)
    rows["fused_scatter_dot"].append(compare_stream(
        "fused_scatter_dot", "lp_bwd_h",
        lambda: ss.fused_scatter_dot(*args),
        lambda: ss.fused_scatter_dot_reference(*args),
        lambda: torch.zeros(T + 1, L, device=device)
        .index_add_(0, hrows, msgs),     # the scatter half alone
        (nbytes(dvn, w, local, blk, table) + T * L * 4 + E * 4,
         4 * real * d), shape={**stream_shape(h, T, L), "Lv": d}))
    del dvn, w, msgs

    local, blk = f.scatter_local, f.scatter_blk
    frows = edge_rows(local, blk, rb, T)
    padded = torch.cat([table, table.new_zeros(1, L)])
    gargs = (table, local, blk, rb, eb)
    rows["sorted_gather"].append(compare_stream(
        "sorted_gather", "lp_fwd", lambda: ss.sorted_gather(*gargs),
        lambda: ss.sorted_gather_reference(*gargs), lambda: padded[frows],
        (nbytes(table, local, blk) + f.num_padded_edges * L * 4, 0),
        exact=True, shape=stream_shape(f, T, L)))
    del table, padded
    torch.cuda.empty_cache()


def adversarial_phase(device, rows) -> None:
    """All four stream kernels on small hostile streams."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    rng = np.random.default_rng(0)
    # (slabs, row block, edge block, blocks, L, out rows, k, value width)
    for label, (nslab, rb, eb, n_blocks, L, out_rows, k, d) in {
            "adversarial_512x256_k8": (40, 512, 256, 14, 128,
                                       15 * 512 - 37, 8, 16),
            "adversarial_512x256_k1": (24, 512, 256, 8, 256, 9 * 512, 1,
                                       200),
            "adversarial_64x40_k4": (33, 64, 40, 20, 96, 21 * 64, 4,
                                     21)}.items():
        msgs, local, blk = adversarial_stream(rng, nslab, rb, eb, n_blocks,
                                              L, device)
        E = nslab * eb
        sargs = (msgs, local, blk, out_rows, rb, eb)
        rows["sorted_scatter"].append(compare_stream(
            "sorted_scatter", label, lambda: ss.sorted_scatter(*sargs),
            lambda: ss.sorted_scatter_reference(*sargs)))
        # values cut from a wider array: strided rows
        V = msgs[:, 3:3 + d]
        place = torch.as_tensor(rng.integers(0, k, E), dtype=torch.int32,
                                device=device)
        norm = torch.as_tensor(rng.random(E), dtype=torch.float32,
                               device=device)
        pargs = (V, place, norm, local, blk, out_rows, k, L, rb, eb)
        rows["fused_place_scatter"].append(compare_stream(
            "fused_place_scatter", label,
            lambda: ss.fused_place_scatter(*pargs),
            lambda: ss.fused_place_scatter_reference(*pargs)))
        table = torch.as_tensor(
            rng.standard_normal((out_rows, L)), dtype=torch.float32,
            device=device)
        dargs = (V, norm, local, blk, table, out_rows, rb, eb)
        rows["fused_scatter_dot"].append(compare_stream(
            "fused_scatter_dot", label,
            lambda: ss.fused_scatter_dot(*dargs),
            lambda: ss.fused_scatter_dot_reference(*dargs)))
        # the gather takes block ids in any order
        shuffled = blk[torch.randperm(nslab, device=device)]
        gargs = (table, local, shuffled, rb, eb)
        rows["sorted_gather"].append(compare_stream(
            "sorted_gather", label, lambda: ss.sorted_gather(*gargs),
            lambda: ss.sorted_gather_reference(*gargs), exact=True))


def check_bf16(got, want, scale, label: str):
    """``(max abs error, max error / bound)`` of a bf16 kernel output
    against its plain version; the bound is element-wise
    (``mrgcn_tpu_torch.ops.kernel_bounds``) and the ratio must be <= 1."""
    import torch
    from mrgcn_tpu_torch.ops.kernel_bounds import bf16_error
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err, ratio = bf16_error(got, want, scale)
    check(ratio <= 1.0, f"{label}: kernel disagrees with plain (max abs err "
          f"{err}, {ratio:.3g} x the bound)")
    return err, ratio


def attention_case(gen, N, L, d, device):
    """q (scaled), k, v as the text encoder hands them over (k and v
    slices of one fused (N, L, 3d) bf16 tensor), ragged key masks with a
    length-1 sequence and an all-padding one, and a cotangent."""
    import torch
    qkv = torch.randn(N, L, 3 * d, generator=gen, device=device,
                      dtype=torch.bfloat16)
    q = qkv[..., :d] * torch.tensor(d ** -0.5, dtype=torch.bfloat16)
    lengths = torch.randint(1, L + 1, (N,), generator=gen, device=device)
    lengths[0] = 1
    lengths[1] = 0
    valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
    do = torch.randn(N, L, d, generator=gen, device=device,
                     dtype=torch.bfloat16)
    return q, qkv[..., d:2 * d], qkv[..., 2 * d:], valid, do


def mlp_case(gen, M, d, hd, device):
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    return (rnd(M, d), rnd(d, hd, scale=d ** -0.5), rnd(hd, scale=0.5),
            rnd(hd, d, scale=hd ** -0.5), rnd(d, scale=0.5), rnd(M, d))


def encoder_kernel_phase(device) -> dict:
    """Kernels #6-#9 against their plain versions at the slice's shapes
    (timed) and on adversarial shapes. Returns per-kernel rows."""
    import torch
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    from mrgcn_tpu_torch.ops.kernel_bounds import (attention_scales,
                                                   mlp_scales)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {k: [] for k in ("attention_fwd", "attention_bwd", "mlp_fwd",
                            "mlp_bwd")}

    def compare(name, label, kernel, plain, scales, timed, library=None,
                work=None):
        got, again = kernel(), kernel()
        want = plain()
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        agains = again if isinstance(again, tuple) else (again,)
        wants = want if isinstance(want, tuple) else (want,)
        errs = [check_bf16(g, w, s, f"{name} {label} output {i}")
                for i, (g, w, s) in enumerate(zip(outs, wants, scales))]
        check(all(torch.equal(g, a) for g, a in zip(outs, agains)),
              f"{name} {label}: two runs differ")
        row = {"label": label, "max_abs_err": max(e for e, _ in errs),
               "max_err_over_bound": max(r for _, r in errs)}
        if timed:
            row.update(timed_pair(kernel, plain, library))
            row.update(bound(work[0], work[1], BF16_FLOPS))
        print(f"[kernel] {name} {json.dumps(row)}")
        rows[name].append(row)

    def sdpa(q, k, v, valid, do=None):
        """``F.scaled_dot_product_attention`` on the same inputs (q comes
        scaled, so its scale is 1): the forward alone, or with ``do`` the
        forward and its autograd backward. Timed only, used nowhere in the
        port."""
        mask = valid[:, None, None, :]
        heads = [t[:, None] for t in (q, k, v)]
        if do is None:
            return lambda: torch.nn.functional.scaled_dot_product_attention(
                *heads, attn_mask=mask, scale=1.0)
        leaves = [t.detach().clone().requires_grad_() for t in heads]

        def both():
            out = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, scale=1.0)
            return torch.autograd.grad(out, leaves, do[:, None])
        return both

    for label, (N, L, d), timed in (("slice", (8000, 128, 128), True),
                                    ("adversarial_13x37", (13, 37, 128),
                                     False),
                                    ("adversarial_9x1", (9, 1, 128), False),
                                    ("adversarial_5x128x64", (5, 128, 64),
                                     False),
                                    ("adversarial_7x300", (7, 300, 128),
                                     False),
                                    ("adversarial_3x512", (3, 512, 128),
                                     False),
                                    ("long_2000x512", (2000, 512, 128),
                                     True)):
        q, k, v, valid, do = attention_case(gen, N, L, d, device)
        scales = attention_scales(q, k, v, valid, do)
        # operations on the real keys only: each of the L query rows meets
        # sum(len) keys; forward 2 products, backward 5
        pairs = float(valid.sum()) * L * d
        qkv_bytes = 3 * N * L * d * 2 + valid.numel()
        compare("attention_fwd", label,
                lambda: att.attention_fwd(q, k, v, valid),
                lambda: att.attention_fwd_reference(q, k, v, valid),
                scales[:1], timed, sdpa(q, k, v, valid) if timed else None,
                (qkv_bytes + N * L * d * 2, 4 * pairs))
        compare("attention_bwd", label,
                lambda: att.attention_bwd(q, k, v, valid, do),
                lambda: att.attention_bwd_reference(q, k, v, valid, do),
                scales[1:], timed,
                sdpa(q, k, v, valid, do) if timed else None,
                (qkv_bytes + 4 * N * L * d * 2, 10 * pairs))
        if timed:
            # the library's backward alone: both passes less the forward
            fwd, bwd = rows["attention_fwd"][-1], rows["attention_bwd"][-1]
            bwd["library_fwd_bwd_ms"] = bwd["library_ms"]
            bwd["library_ms"] = bwd["library_ms"] - fwd["library_ms"]
            print(f"[kernel] attention_bwd {label}: library backward alone "
                  f"{bwd['library_ms']:.3f} ms")
        out = att.attention_fwd(q, k, v, valid)
        v1 = v[1].float()
        check_bf16(out[1], v1.mean(0, keepdim=True).expand(L, d),
                   v1.abs().mean(0, keepdim=True).expand(L, d),
                   f"attention {label}: the all-padding sequence (a uniform"
                   " average of v)")
        del q, k, v, valid, do, out, scales
    for label, (M, d, hd), timed in (("slice", (1_024_000, 128, 512), True),
                                     ("adversarial_1000", (1000, 128, 512),
                                      False),
                                     ("adversarial_37x16x64", (37, 16, 64),
                                      False)):
        x, w1, b1, w2, b2, do = mlp_case(gen, M, d, hd, device)
        scales = mlp_scales(x, w1, b1, w2, b2, do)
        # two products forward; five backward (the hidden activations
        # again, dh, dx, dW1, dW2); no single PyTorch call computes either
        weights = nbytes(w1, b1, w2, b2)
        compare("mlp_fwd", label, lambda: fm.mlp_fwd(x, w1, b1, w2, b2),
                lambda: fm.mlp_fwd_reference(x, w1, b1, w2, b2),
                scales[:1], timed, None,
                (2 * nbytes(x) + weights, 4.0 * M * d * hd))
        compare("mlp_bwd", label, lambda: fm.mlp_bwd(x, w1, b1, w2, do),
                lambda: fm.mlp_bwd_reference(x, w1, b1, w2, do),
                scales[1:], timed, None,
                (3 * nbytes(x) + 2 * weights, 10.0 * M * d * hd))
        del x, w1, b1, w2, b2, do, scales
    torch.cuda.empty_cache()
    return rows


def write_config(path: Path, epochs: int, num_bases: int, hidden: int,
                 features=()) -> None:
    """``configs/dmg.toml``'s model section; of its features, the
    datatypes in ``features`` are included as DMG configures them (the
    string feature without its pretrained ``model`` and ``tokenizer``
    keys: the from-scratch text encoder), all others excluded."""
    with open(ROOT / "configs" / "dmg.toml", "rb") as f:
        dmg = tomllib.load(f)
    model = dict(dmg["model"], epoch=epochs, num_bases=num_bases)
    layers = model.pop("layers")
    lines = ['name = "DMG_SYNTH"', "", "[task]",
             'type = "node classification"', "seed = 0", "batchsize = -1",
             "", "[model]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in model.items()]
    for layer in layers:
        lines += ["", "[[model.layers]]"]
        lines += [f"{k} = {json.dumps(hidden if k == 'hidden_nodes' else v)}"
                  for k, v in layer.items()]
    for feature in dmg["graph"]["features"]:
        lines += ["", "[[graph.features]]"]
        if feature["datatype"] in features:
            lines += [f"{k} = {json.dumps(v)}" for k, v in feature.items()
                      if k not in ("model", "tokenizer")]
        else:
            lines += [f"datatype = {json.dumps(feature['datatype'])}",
                      "include = false"]
    path.write_text("\n".join(lines) + "\n")


def train_via_cli(tmp: Path, tag: str, work, epochs, num_bases,
                  platform=None, F=None):
    """``run.run_cli`` on ``work``'s graph; with ``F`` (literal features)
    the config includes the ``MULTIMODAL`` datatypes."""
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
    art = tmp / f"{tag}.npz"
    cfg = tmp / f"{tag}.toml"
    if not art.exists():
        save_nc_artifact(str(art), work["n"], work["R"], work["src"],
                         work["dst"], work["rel"], work["norm"],
                         work["labels_idx"], work["labels_cls"],
                         work["num_classes"], seed=0,
                         num_eval=min(1000, work["n"] // 20), F=F)
        write_config(cfg, epochs, num_bases, work["hidden"],
                     features=MULTIMODAL if F else ())
    if platform is None:
        os.environ.pop("MRGCN_PLATFORM", None)
    else:
        os.environ["MRGCN_PLATFORM"] = platform
    try:
        return run.run_cli(["-c", str(cfg), "-i", str(art), "-o",
                            str(tmp) + os.sep, "--dry_run", "--test"])
    finally:
        os.environ.pop("MRGCN_PLATFORM", None)


def kernel_counters() -> dict:
    """Each kernel wrapper, whose ``launches`` counts its launches."""
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops import fused_mlp as fm
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    return {"sorted_scatter": ss.sorted_scatter,
            "sorted_gather": ss.sorted_gather,
            "fused_place_scatter": ss.fused_place_scatter,
            "fused_scatter_dot": ss.fused_scatter_dot,
            "attention_fwd": att.attention_fwd,
            "attention_bwd": att.attention_bwd,
            "mlp_fwd": fm.mlp_fwd, "mlp_bwd": fm.mlp_bwd}


def slice_phase(work, tmp: Path, tag: str, kernels, F=None) -> dict:
    """Train ``EPOCHS`` NC epochs through the CLI with every launch count
    set to 0 just before and read just after; ``kernels`` names each
    kernel the path runs with its least launch count per epoch."""
    import torch
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_via_cli(tmp, tag, work, EPOCHS, work["num_bases"], F=F)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    losses = [h["train_loss"] for h in res.history]
    check(len(losses) == EPOCHS, f"{tag}: trained {len(losses)} epochs")
    check(all(math.isfinite(x) for x in losses + [res.loss]),
          f"{tag}: non-finite loss: {losses}, test {res.loss}")
    devices = {p.device.type for p in res.model.parameters()}
    check(devices == {"cuda"}, f"{tag}: parameters on {devices}")
    check(res.model.featureless == (F is None),
          f"{tag}: featureless is {res.model.featureless}")
    for name, per_epoch in kernels.items():
        check(launches[name] >= per_epoch * EPOCHS,
              f"{tag}: {name} launched {launches[name]} times in "
              f"{EPOCHS} epochs")
    secs = [h["seconds"] for h in res.history]
    summary = {"path": tag, "epochs": EPOCHS, "train_loss": losses,
               "test_loss": res.loss, "test_acc": res.acc,
               "first_epoch_s": secs[0], "epoch_s_after_first": secs[1:],
               "epoch_s_median_after_first": statistics.median(secs[1:]),
               "peak_mem_bytes": peak, "cli_wall_s": wall,
               "launches": launches}
    print(f"[slice] {json.dumps(summary)}")
    return summary


def write_lp_config(path: Path, epochs: int, hidden: int, eval_interval: int,
                    name: str = "FB15K237_SYNTH") -> None:
    """``configs/fb15k-237.toml``'s model section (2 bases, lr 0.01) with
    two ``hidden``-wide R-GCN layers (the link-prediction task reads all
    but the last ``[[model.layers]]`` entry, so the file gets three), on
    the full graph: ``gcn_batchsize`` and ``test_batchsize`` -1."""
    with open(ROOT / "configs" / "fb15k-237.toml", "rb") as f:
        fb = tomllib.load(f)
    model = dict(fb["model"], epoch=epochs)
    layer = dict(model.pop("layers")[0], hidden_nodes=hidden)
    task = dict(fb["task"], seed=0, eval_interval=eval_interval,
                gcn_batchsize=-1, test_batchsize=-1)
    stop = task.pop("early_stopping")
    lines = [f"name = {json.dumps(name)}", "", "[task]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in task.items()]
    lines += [f"early_stopping.{k} = {json.dumps(v)}"
              for k, v in stop.items()]
    lines += ["", "[model]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in model.items()]
    for entry in (layer, layer, {"type": layer["type"]}):
        lines += ["", "[[model.layers]]"]
        lines += [f"{k} = {json.dumps(v)}" for k, v in entry.items()]
    path.write_text("\n".join(lines) + "\n")


def basis_gradient_check(plan, num_relations: int, device) -> dict:
    """``featureless_basis`` at the LP graph's full width: the gradients
    from its own backward (``fused_scatter_dot``) against autograd through
    the same forward written with differentiable row gathers and the
    differentiable ``sorted_scatter`` (backward: ``sorted_gather``).
    Bound: max abs error within 1e-4 of the largest value."""
    import torch
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.ops.sorted_stream import sorted_scatter
    gen = torch.Generator(device=device).manual_seed(2)
    d, B = LP_HIDDEN, 2
    L = rl.line_width(1, d)

    def leaf(*shape):
        return torch.randn(*shape, generator=gen, device=device) \
            .requires_grad_()

    comp = leaf(num_relations, B)
    packed = leaf(B, plan.n_in_rows, L)
    cot = torch.randn(plan.out_nodes, d, generator=gen, device=device)

    out = rl.featureless_basis(comp, packed, plan, d)
    got = torch.autograd.grad(out, (comp, packed), cot)

    f = plan.fwd
    w = comp[f.rel.long()]
    v = sum(w[:, b:b + 1] * packed[b][f.gather_row.long()][:, :d]
            for b in range(B))
    msgs = torch.nn.functional.pad(v * f.norm[:, None], (0, L - d))
    lines = sorted_scatter(msgs, f.scatter_local, f.scatter_blk,
                           plan.n_out_rows, f.row_block, f.edge_block)
    plain = rl.unpack_rows(lines, plan.k_out, plan.out_nodes, d)
    want = torch.autograd.grad(plain, (comp, packed), cot)
    torch.cuda.synchronize()

    errs = {"forward": float((out - plain).detach().abs().max()
                             / plain.detach().abs().max())}
    for name, g, w_ in zip(("d_comp", "d_packed"), got, want):
        check(bool(torch.isfinite(g).all()), f"basis check: {name} "
              "is not finite")
        errs[name] = float((g - w_).abs().max() / w_.abs().max())
    print(f"[lp] featureless_basis own backward vs autograd, relative to "
          f"the largest value: {json.dumps(errs)} (bound 1e-4)")
    check(max(errs.values()) <= 1e-4, f"basis check: gradients differ "
          f"({errs})")
    return errs


def lp_slice_phase(tmp: Path, plan, num_relations: int, device) -> dict:
    """The link-prediction path through the CLI, with every launch count
    set to 0 just before and read just after; then, counted apart, the
    basis gradient check."""
    import torch
    from mrgcn_tpu_torch import run
    cfg = tmp / "lp.toml"
    write_lp_config(cfg, LP_EPOCHS, LP_HIDDEN, LP_EVAL_INTERVAL)
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = run.run_cli(["-c", str(cfg), "-i", str(tmp / "lp.npz"), "-o",
                       str(tmp) + os.sep, "--dry_run", "--test"])
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    # no entry point differentiates sorted_scatter through autograd, so
    # only this check launches sorted_gather: its launches are no path's
    for fn in counters.values():
        fn.launches = 0
    errs = basis_gradient_check(plan, num_relations, device)
    check_launches = {name: fn.launches for name, fn in counters.items()
                      if fn.launches}
    check(check_launches.get("sorted_gather", 0) >= 1
          and check_launches.get("sorted_scatter", 0) >= 1
          and check_launches.get("fused_scatter_dot", 0) >= 2,
          f"lp: the gradient check launched {check_launches}")

    losses = [h["loss"] for h in res.history]
    check(len(losses) == LP_EPOCHS, f"lp: trained {len(losses)} epochs")
    check(all(math.isfinite(x) for x in losses), f"lp: losses {losses}")
    check(max(losses) <= losses[0] + 1e-6 and losses[-1] < losses[0] - 0.01,
          f"lp: the loss did not fall: {losses}")
    devices = {p.device.type for p in res.model.parameters()}
    check(devices == {"cuda"}, f"lp: parameters on {devices}")
    n_test = 2 * 20_466
    for kind in ("raw", "flt"):
        ranks = res.ranks[kind]
        check(len(ranks) == n_test and min(ranks) >= 1
              and max(ranks) <= 14_541, f"lp: {kind} ranks out of range")
        check(0.0 < res.mrr[kind] <= 1.0, f"lp: {kind} MRR {res.mrr[kind]}")
    # per training step: one fused_place_scatter forward, one
    # fused_scatter_dot per basis backward; the evaluations add forwards
    check(launches["fused_place_scatter"] >= LP_EPOCHS
          and launches["fused_scatter_dot"] == 2 * LP_EPOCHS,
          f"lp: launches {launches}")
    secs = [h["seconds"] for h in res.history]
    summary = {"path": "lp_fb15k237_synth", "epochs": LP_EPOCHS,
               "cuts": "full graph (gcn_batchsize and test_batchsize -1, "
                       "not 32 and 500); trains 10 epochs beyond the "
                       "config's 20",
               "loss": losses, "first_epoch_s": secs[0],
               "epoch_s_after_first": secs[1:],
               "epoch_s_median_after_first": statistics.median(secs[1:]),
               "eval_s": [h["eval_seconds"] for h in res.history],
               "train_mrr_raw": [h["train_mrr"] for h in res.history],
               "valid_mrr_raw": [h["valid_mrr"] for h in res.history],
               "test_s": res.test_seconds, "test_mrr": res.mrr,
               "test_hits_at_1_3_10": res.hits, "peak_mem_bytes": peak,
               "cli_wall_s": wall, "launches": launches,
               "gradient_check_launches": check_launches,
               "basis_gradient_rel_err": errs}
    print(f"[slice] {json.dumps(summary)}")
    return summary


def profile_phase(tmp: Path, device, steps: int = 3) -> None:
    """Where a link-prediction training step's time goes
    (``--only profile``, not part of the default run): ``torch.profiler``
    over ``steps`` full-graph steps after three warm-up steps, device time
    by kernel name, and the card's busy share of the synchronised host
    time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks import link_prediction as lp
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    cfg = tmp / "lp.toml"
    write_lp_config(cfg, LP_EPOCHS, LP_HIDDEN, LP_EVAL_INTERVAL)
    config = run.load_config(str(cfg))
    artifact = run.artifact_io.load(str(tmp / "lp.npz"))
    t0 = time.perf_counter()
    inputs = prepare_inputs(artifact, config, True, device)
    print(f"[profile] prepare_inputs {time.perf_counter() - t0:.2f} s")
    model = lp.build_model(inputs, config, torch.Generator().manual_seed(0))
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config, True)
    t0 = time.perf_counter()
    batch = lp.to_device(lp.make_lp_batches(
        inputs, np.asarray(artifact.data["train"]), -1, -1, 2), device)[0]
    print(f"[profile] make_lp_batches {time.perf_counter() - t0:.2f} s")
    corrupt = lp.make_corruptor(0.2)
    gen = torch.Generator(device=device).manual_seed(0)

    def step():
        lp.train_step(model, optimizer, batch, corrupt, 0.0, 0.0, 0.0, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))

    # kernels only: an operator's device time repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3 / steps
    check(busy_ms > 0, "profile: the trace shows no device time")
    print(f"[profile] LP step {wall_ms:.3f} ms by host clock, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in events if device_us(e) > 0) // steps} "
          "kernels per step")
    for e in events[:25]:
        if device_us(e) > 0:
            print(f"[profile] {device_us(e) / 1e3 / steps:9.3f} ms/step  "
                  f"x{e.count / steps:5.1f}  {e.key[:90]}")


def lp_agreement(tmp: Path, tag: str, steps: int, budget=None,
                 ranks: bool = False) -> None:
    """Link prediction on the graph ``<tag>.npz``, card (kernels) against
    CPU (plain versions), on the basis-stream path: ``steps`` training
    steps with the same corrupted triples on both sides (drawn on the
    CPU); every step's loss within 1e-4 relative and every parameter's
    gradient within 1e-4 of its largest entry. With ``ranks`` the losses
    must also fall and the test split's ranks be equal except where
    near-equal scores change order. ``budget`` lowers the composed-table
    budget so that a small graph takes the basis-stream path."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.tasks import link_prediction as lp
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    cfg = tmp / f"{tag}_agree.toml"
    write_lp_config(cfg, steps, LP_HIDDEN, eval_interval=steps,
                    name=tag.upper())
    config = run.load_config(str(cfg))
    artifact = run.artifact_io.load(str(tmp / f"{tag}.npz"))
    kept = rl.COMPOSED_TABLE_MAX_ELEMS
    if budget is not None:
        rl.COMPOSED_TABLE_MAX_ELEMS = budget
    try:
        t0 = time.perf_counter()
        sides = []
        for device in (torch.device("cuda", 0), torch.device("cpu")):
            inputs = prepare_inputs(artifact, config, True, device)
            check(inputs.identity_basis, f"{tag}: no basis-stream plans")
            model = lp.build_model(inputs, config,
                                   torch.Generator().manual_seed(0))
            sides.append((inputs, model, tutils.build_optimizer(
                model, config, inputs.optimizer_config, True)))
        train = [lp.make_lp_batches(inputs, np.asarray(
            artifact.data["train"]), -1, -1, 2)[0] for inputs, _, _ in sides]
        corrupt = lp.make_corruptor(0.2)
        gen = torch.Generator().manual_seed(0)
        losses = ([], [])
        grad_err = {}
        for _ in range(steps):
            drawn = corrupt(torch.as_tensor(train[1].data),
                            train[1].num_triples,
                            torch.as_tensor(train[1].corrupt_pool),
                            train[1].num_pool, gen)
            for side, (inputs, model, _) in enumerate(sides):
                losses[side].append(float(lp.loss_and_grads(
                    model, train[side],
                    *(t.to(inputs.device) for t in drawn))))
            for (name, p), q in zip(sides[0][1].named_parameters(),
                                    sides[1][1].parameters()):
                check(float(q.grad.abs().max()) > 0,
                      f"{tag}: {name} got no gradient")
                err = float((p.grad.cpu() - q.grad).abs().max()
                            / q.grad.abs().max())
                grad_err[name] = max(grad_err.get(name, 0.0), err)
            for _, _, optimizer in sides:
                optimizer.step()
        err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(*losses))
        print(f"[agree] {tag} losses cuda {losses[0]} cpu {losses[1]} "
              f"(max rel err {err:.3g}, bound 1e-4); gradients, error over "
              f"the largest entry: {json.dumps(grad_err)} (bound 1e-4); "
              f"{time.perf_counter() - t0:.1f} s")
        check(err <= 1e-4, f"{tag}: cuda and cpu losses differ ({err})")
        check(max(grad_err.values()) <= 1e-4,
              f"{tag}: cuda and cpu gradients differ ({grad_err})")
        if not ranks:
            return
        check(losses[0][-1] < losses[0][0],
              f"{tag}: the loss did not fall: {losses[0]}")
        found = []
        for inputs, model, _ in sides:
            test = lp.make_lp_batches(inputs, np.asarray(
                artifact.data["test"]), -1, -1, 2)
            found.append(lp.evaluate(test, model, -1, True)[2])
    finally:
        rl.COMPOSED_TABLE_MAX_ELEMS = kept
    for kind in ("raw", "flt"):
        a, b = (np.asarray(r[kind]) for r in found)
        differ = int((a != b).sum())
        print(f"[agree] {tag} {kind} ranks: {differ} of {a.size} differ "
              f"between card and CPU (largest gap "
              f"{int(np.abs(a - b).max())}; bound 2 %)")
        check(differ <= 0.02 * a.size,
              f"{tag}: {differ} of {a.size} {kind} ranks differ")


def encoder_agreement(tmp: Path, tag: str, gpu_model, cpu_model) -> None:
    """Every encoder of the multimodal model on the small graph's feature
    rows, with the CPU run's weights on both sides: outputs before the
    gates, and the encoder's parameter gradients for a seeded cotangent,
    card (kernels) against CPU (plain versions). Bounds
    (``ENCODER_RTOL[kind]``): the outputs' max abs error relative to
    max |CPU output|; each gradient's error norm relative to its norm."""
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    config = run.load_config(str(tmp / f"{tag}.toml"))
    artifact = run.artifact_io.load(str(tmp / f"{tag}.npz"))
    gpu_model.load_state_dict(cpu_model.state_dict())
    sides = [(m, prepare_inputs(artifact, config, False, device).features)
             for m in (gpu_model, cpu_model)
             for device in [next(m.parameters()).device]]
    for name, (datatype, _) in zip(cpu_model.names,
                                   cpu_model.modules_config):
        results = []
        for model, features in sides:
            encoder = getattr(model, name)
            encoder.zero_grad()
            out = encoder(model._prepare(datatype, features[name][0]))
            cot = torch.randn(out.shape, generator=torch.Generator()
                              .manual_seed(0)).to(out.device)
            out.backward(cot)
            results.append({"output": out.detach().cpu()} | {
                n: p.grad.detach().cpu()
                for n, p in encoder.named_parameters() if p.grad is not None})
        kind = "text" if datatype in ("xsd.string", "xsd.anyURI") \
            else "mlp"
        gpu_res, cpu_res = results
        want = cpu_res.pop("output").float()
        out_err = float((gpu_res.pop("output").float() - want).abs().max()) \
            / max(float(want.abs().max()), 1e-30)
        errs = {n: float(torch.linalg.vector_norm(gpu_res[n].float()
                                                  - b.float()))
                / max(float(torch.linalg.vector_norm(b.float())), 1e-30)
                for n, b in cpu_res.items()}
        worst = max(errs, key=errs.get)
        out_bound, grad_bound = ENCODER_RTOL[kind]
        print(f"[agree] {tag} encoder {name}: output rel err {out_err:.3g}"
              f" (bound {out_bound}), parameter gradients max rel norm err "
              f"{errs[worst]:.3g} at {worst} (bound {grad_bound})")
        check(out_err <= out_bound and errs[worst] <= grad_bound,
              f"{tag}: encoder {name} differs on the card and the CPU")


def agreement_phase(tmp: Path) -> None:
    """The CLI on a small graph: CUDA kernels vs the CPU's plain path,
    featureless (rtol 1e-4) and multimodal (rtol 1e-3: the text encoder's
    body is bf16 and the two sides round it at the same places but from
    f32 sums taken in other orders); for the multimodal model also each
    encoder on its own (``encoder_agreement``)."""
    from benchmarks.torch_baseline import build_workload
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    small = build_workload(n=3000, num_props=6, num_edges=20_000,
                           num_labeled=300, seed=0)
    F = multimodal_features(small["n"], seed=0, num_numeric=600,
                            num_years=300, num_strings=240, max_len=128)
    for tag, feats, rtol in (("small", None, 1e-4),
                             ("small_mm", F, 1e-3)):
        gpu = train_via_cli(tmp, tag, small, 3, 4, F=feats)
        cpu = train_via_cli(tmp, tag, small, 3, 4, platform="cpu", F=feats)
        a = [h["train_loss"] for h in gpu.history] + [gpu.loss]
        b = [h["train_loss"] for h in cpu.history] + [cpu.loss]
        err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
        print(f"[agree] {tag} losses cuda {a} cpu {b} "
              f"(max rel err {err:.3g}, bound {rtol})")
        check(err <= rtol, f"{tag}: cuda and cpu losses differ (rel {err})")
        if feats is not None:
            encoder_agreement(tmp, tag, gpu.model, cpu.model)


# kernel -> (source, the TPU kernel it replaces, the timed row that goes
# into the kernels line: the call its main path makes)
SOURCES = {
    "sorted_scatter": ("mrgcn_tpu_torch/csrc/sorted_scatter.cu",
                       "mrgcn_tpu/ops/pallas_gather.py:247", "dense_bwd_h"),
    "sorted_gather": ("mrgcn_tpu_torch/csrc/sorted_gather.cu",
                      "mrgcn_tpu/ops/pallas_gather.py:99", "lp_fwd"),
    "fused_scatter_dot": ("mrgcn_tpu_torch/csrc/scatter_dot.cu",
                          "mrgcn_tpu/ops/pallas_gather.py:379", "lp_bwd_h"),
    "fused_place_scatter": ("mrgcn_tpu_torch/csrc/fused_place_scatter.cu",
                            "mrgcn_tpu/ops/pallas_gather.py:712", "lp_fwd"),
    "attention_fwd": ("mrgcn_tpu_torch/csrc/fused_attention.cu",
                      "mrgcn_tpu/ops/attention.py:44", "slice"),
    "attention_bwd": ("mrgcn_tpu_torch/csrc/fused_attention.cu",
                      "mrgcn_tpu/ops/attention.py:59", "slice"),
    "mlp_fwd": ("mrgcn_tpu_torch/csrc/fused_mlp.cu",
                "mrgcn_tpu/ops/fused_mlp.py:38", "slice"),
    "mlp_bwd": ("mrgcn_tpu_torch/csrc/fused_mlp.cu",
                "mrgcn_tpu/ops/fused_mlp.py:48", "slice"),
}
STREAM_KERNELS = ("sorted_scatter", "sorted_gather", "fused_scatter_dot",
                  "fused_place_scatter")
ENCODER_KERNELS = ("attention_fwd", "attention_bwd", "mlp_fwd", "mlp_bwd")
PHASES = ("stream", "nc", "lp", "encoders", "agree")
EXTRA_PHASES = ("profile",)     # only with --only


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="", help="comma-separated phases "
                        f"to run alone ({', '.join(PHASES)}); no result "
                        "line is printed then")
    only = [p for p in parser.parse_args(argv).only.split(",") if p]
    check(set(only) <= set(PHASES + EXTRA_PHASES),
          f"unknown phase in {only}")
    phases = only or PHASES

    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from benchmarks.torch_baseline import build_workload
    from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                                 save_lp_artifact)
    from mrgcn_tpu_torch.utils.device import pin_float32_precision

    pin_float32_precision()
    smi = card()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_kernels()

    rows = {name: [] for name in SOURCES}
    paths = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        work = build_workload(seed=0)
        save_lp_artifact(str(tmp / "lp.npz"), seed=0)
        plan, num_relations = lp_plans(tmp / "lp.npz", device)
        if "stream" in phases:
            nc_stream_phase(work, device, rows)
            lp_stream_phase(plan, device, rows)
            adversarial_phase(device, rows)
        if "nc" in phases:
            # per step: layer 0's forward and backward place-scatters
            # (with features, twice: identity and relation-constant dense
            # half); the dense half's per-edge bwd_h stream still takes
            # sorted_scatter; two text blocks, forward and backward
            paths["nc_featureless"] = slice_phase(
                work, tmp, "dmg_synth", {"fused_place_scatter": 2})
            paths["nc_multimodal"] = slice_phase(
                work, tmp, "dmg_synth_multimodal",
                {"sorted_scatter": 1, "fused_place_scatter": 3,
                 **dict.fromkeys(ENCODER_KERNELS, 2)},
                F=multimodal_features(work["n"], seed=0))
        if "lp" in phases:
            paths["lp"] = lp_slice_phase(tmp, plan, num_relations, device)
        del plan
        torch.cuda.empty_cache()
        if "profile" in phases:
            profile_phase(tmp, device)
        if "encoders" in phases:
            rows.update(encoder_kernel_phase(device))
        if "agree" in phases:
            agreement_phase(tmp)
            save_lp_artifact(str(tmp / "lp_small.npz"), num_nodes=3000,
                             num_props=12, num_train=20_000, num_valid=1000,
                             num_test=1500, seed=0)
            lp_agreement(tmp, "lp_small", 3, budget=2 ** 20, ranks=True)
            lp_agreement(tmp, "lp", 1)     # full width: one step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[card] {smi}")
    if only:
        print(f"phases {only} passed; the whole run prints the result line")
        return

    kernels = []
    for name, (source, replaces, record) in SOURCES.items():
        timed = next(r for r in rows[name] if r["label"] == record)
        by_path = {p: summary["launches"][name]
                   for p, summary in paths.items()}
        # sorted_gather is the autograd backward of sorted_scatter, which
        # no entry point of the port differentiates (the layer ops carry
        # their own backward): it reads 0 on every path and is launched by
        # the basis gradient check, whose count stands beside
        check(sum(by_path.values()) > 0 or name == "sorted_gather",
              f"{name} launched on no path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "gradient_check_launches":
                paths["lp"]["gradient_check_launches"].get(name, 0),
            "shape": record,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            **{key: timed[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bytes", "flops")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
