#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mrgcn_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, the CUDA toolkit (``nvcc``) and no network, and it fails (exit code
other than 0, no result line) where CUDA is absent or the repository is not
beside it. Phases, each printing its own lines:

1. the card, as ``nvidia-smi`` and torch see it;
2. the kernels, built from ``mrgcn_tpu_torch/csrc`` (with ptxas' report);
3. each kernel against its plain PyTorch version on the card, on the
   layer-0 streams of the DMG-scale bench graph
   (``benchmarks/torch_baseline.build_workload``) and on small adversarial
   streams (padding, repeated and unvisited blocks, ragged output rows):
   max abs error (atol 1e-4, rtol 1e-5), bit-identity across two runs, and
   the median time of each over 20 CUDA-event-timed calls;
4. the main path: ``mrgcn_tpu_torch.run`` trains the featureless
   full-batch NC model (``configs/dmg.toml``'s ``[model]``: 2 layers,
   hidden 16, 40 bases) for 5 epochs on that graph with random weights
   from seed 0, then evaluates on the test split. The kernels' launch
   counts are read across exactly this run;
5. the same CLI on a small graph on the card and on the CPU (plain
   versions): the per-epoch losses must agree (rtol 1e-4).

Then one JSON line with every kernel's numbers, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time
import tomllib
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
EPOCHS = 5
ATOL, RTOL = 1e-4, 1e-5
TIMED_CALLS = 20


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
    kl = _build.load("sorted_scatter", rebuild=True)
    print(f"[build] sorted_scatter: {kl.build_seconds:.1f} s -> "
          f"{kl.path.relative_to(ROOT)}")
    for line in kl.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
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


def compare_scatter(label, msgs, local, blk, out_rows, rb, eb,
                    timed: bool) -> dict:
    import torch
    from mrgcn_tpu_torch.ops.sorted_stream import (sorted_scatter,
                                                   sorted_scatter_reference)
    got = sorted_scatter(msgs, local, blk, out_rows, rb, eb)
    again = sorted_scatter(msgs, local, blk, out_rows, rb, eb)
    want = sorted_scatter_reference(msgs, local, blk, out_rows, rb, eb)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(torch.allclose(got, want, atol=ATOL, rtol=RTOL),
          f"{label}: kernel disagrees with plain (max abs err {err})")
    check(torch.equal(got, again), f"{label}: two runs differ")
    row = {"label": label, "E_pad": msgs.shape[0], "slabs": local.shape[0],
           "runs": int(torch.unique_consecutive(blk).numel()),
           "out_rows": out_rows, "L": msgs.shape[1], "max_abs_err": err}
    if timed:
        plain_a = time_ms(lambda: sorted_scatter_reference(
            msgs, local, blk, out_rows, rb, eb))
        kern_a = time_ms(lambda: sorted_scatter(
            msgs, local, blk, out_rows, rb, eb))
        kern_b = time_ms(lambda: sorted_scatter(
            msgs, local, blk, out_rows, rb, eb))
        plain_b = time_ms(lambda: sorted_scatter_reference(
            msgs, local, blk, out_rows, rb, eb))
        row["ms"] = min(kern_a, kern_b)
        row["plain_ms"] = min(plain_a, plain_b)
        row["ms_runs"] = [kern_a, kern_b]
        row["plain_ms_runs"] = [plain_a, plain_b]
    print(f"[kernel] sorted_scatter {json.dumps(row)}")
    return row


def adversarial_stream(rng, nslab, rb, eb, n_blocks, L, device):
    import numpy as np
    import torch
    blk = np.sort(rng.choice(np.arange(0, n_blocks, 2), nslab))  # repeats,
    # and the odd blocks are never visited
    local = rng.integers(0, rb, (nslab, eb))
    local[rng.random((nslab, eb)) < 0.15] = rb                  # padding
    local[:, :3] = local[:, :1]                                 # same row
    msgs = rng.standard_normal((nslab * eb, L)).astype(np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return t(msgs, torch.float32), t(local, torch.int32), t(blk, torch.int32)


def kernel_phase(work, device) -> list:
    """Kernel vs plain on the main path's layer-0 streams and on
    adversarial streams."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.models.rgcn import EdgeBlock
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
    chain = restricted_layer_edges(structure, np.unique(work["labels_idx"]),
                                   2, full, first_dim=work["hidden"],
                                   device=device)
    plan = chain[0].plans["8:8:id"]
    print(f"[kernel] layer-0 plan built in {time.perf_counter() - t0:.1f} s:"
          f" {plan.out_nodes} output nodes, fwd E_pad "
          f"{plan.fwd.num_padded_edges}, bwd_table E_pad "
          f"{plan.bwd_table.num_padded_edges}")

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for label, stream, out_rows in (
            ("fwd", plan.fwd, plan.n_out_rows),
            ("bwd_table", plan.bwd_table, work["R"] * plan.n_in_rows)):
        msgs = torch.randn(stream.num_padded_edges, 128, generator=gen,
                           device=device)
        rows.append(compare_scatter(label, msgs, stream.scatter_local,
                                    stream.scatter_blk, out_rows,
                                    stream.row_block, stream.edge_block,
                                    timed=True))
        del msgs
    rng = np.random.default_rng(0)
    for label, (nslab, rb, eb, n_blocks, L, out_rows) in {
            "adversarial_512x256": (40, 512, 256, 14, 128, 12 * 512 - 37),
            "adversarial_64x40": (33, 64, 40, 20, 96, 21 * 64)}.items():
        msgs, local, blk = adversarial_stream(rng, nslab, rb, eb, n_blocks,
                                              L, device)
        rows.append(compare_scatter(label, msgs, local, blk, out_rows, rb,
                                    eb, timed=False))
    return rows


def write_config(path: Path, epochs: int, num_bases: int,
                 hidden: int) -> None:
    """``configs/dmg.toml``'s model section with every feature excluded."""
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
        lines += ["", "[[graph.features]]",
                  f"datatype = {json.dumps(feature['datatype'])}",
                  "include = false"]
    path.write_text("\n".join(lines) + "\n")


def train_via_cli(tmp: Path, tag: str, work, epochs, num_bases,
                  platform=None):
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
    art = tmp / f"{tag}.npz"
    cfg = tmp / f"{tag}.toml"
    if not art.exists():
        save_nc_artifact(str(art), work["n"], work["R"], work["src"],
                         work["dst"], work["rel"], work["norm"],
                         work["labels_idx"], work["labels_cls"],
                         work["num_classes"], seed=0,
                         num_eval=min(1000, work["n"] // 20))
        write_config(cfg, epochs, num_bases, work["hidden"])
    if platform is None:
        os.environ.pop("MRGCN_PLATFORM", None)
    else:
        os.environ["MRGCN_PLATFORM"] = platform
    try:
        return run.run_cli(["-c", str(cfg), "-i", str(art), "-o",
                            str(tmp) + os.sep, "--dry_run", "--test"])
    finally:
        os.environ.pop("MRGCN_PLATFORM", None)


def slice_phase(work, tmp: Path) -> dict:
    import torch
    from mrgcn_tpu_torch.ops.sorted_stream import sorted_scatter
    torch.cuda.reset_peak_memory_stats()
    sorted_scatter.launches = 0
    t0 = time.perf_counter()
    res = train_via_cli(tmp, "dmg_synth", work, EPOCHS, work["num_bases"])
    wall = time.perf_counter() - t0
    launches = sorted_scatter.launches
    peak = torch.cuda.max_memory_allocated()

    losses = [h["train_loss"] for h in res.history]
    check(len(losses) == EPOCHS, f"trained {len(losses)} epochs")
    check(all(math.isfinite(x) for x in losses + [res.loss]),
          f"non-finite loss: {losses}, test {res.loss}")
    devices = {p.device.type for p in res.model.parameters()}
    check(devices == {"cuda"}, f"parameters on {devices}")
    check(launches >= 2 * EPOCHS,
          f"sorted_scatter launched {launches} times in {EPOCHS} epochs")
    secs = [h["seconds"] for h in res.history]
    summary = {"epochs": EPOCHS, "train_loss": losses,
               "test_loss": res.loss, "test_acc": res.acc,
               "first_epoch_s": secs[0], "epoch_s_after_first": secs[1:],
               "epoch_s_median_after_first": statistics.median(secs[1:]),
               "peak_mem_bytes": peak, "cli_wall_s": wall,
               "sorted_scatter_launches": launches}
    print(f"[slice] {json.dumps(summary)}")
    return summary


def agreement_phase(tmp: Path) -> None:
    """The CLI on a small graph: CUDA kernels vs the CPU's plain path."""
    from benchmarks.torch_baseline import build_workload
    small = build_workload(n=3000, num_props=6, num_edges=20_000,
                           num_labeled=300, seed=0)
    gpu = train_via_cli(tmp, "small", small, 3, 4)
    cpu = train_via_cli(tmp, "small", small, 3, 4, platform="cpu")
    a = [h["train_loss"] for h in gpu.history] + [gpu.loss]
    b = [h["train_loss"] for h in cpu.history] + [cpu.loss]
    err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
    print(f"[agree] small graph losses cuda {a} cpu {b} "
          f"(max rel err {err:.3g})")
    check(err <= 1e-4, f"cuda and cpu losses differ (rel {err})")


def main() -> None:
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from benchmarks.torch_baseline import build_workload
    from mrgcn_tpu_torch.utils.device import pin_float32_precision

    pin_float32_precision()
    smi = card()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_kernels()

    work = build_workload(seed=0)
    rows = kernel_phase(work, device)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        summary = slice_phase(work, tmp)
        agreement_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    timed = [r for r in rows if "ms" in r]
    kernels = [{"name": "sorted_scatter", "route": "cuda",
                "source": "mrgcn_tpu_torch/csrc/sorted_scatter.cu",
                "replaces": "mrgcn_tpu/ops/pallas_gather.py:247",
                "launches": summary["sorted_scatter_launches"],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                # one training step's two calls: fwd + bwd_table streams
                "ms": sum(r["ms"] for r in timed),
                "plain_ms": sum(r["plain_ms"] for r in timed)}]
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
