#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mrgcn_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, the CUDA toolkit (``nvcc``) and no network, and it fails (exit code
other than 0, no result line) where CUDA is absent or the repository is not
beside it. Phases, each printing its own lines:

1. the card, as ``nvidia-smi`` and torch see it;
2. the kernels, built from ``mrgcn_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together; with ptxas' report);
3. ``sorted_scatter`` against its plain PyTorch version on the card, on
   the four layer-0 streams one multimodal training step scatters on the
   DMG-scale bench graph (``benchmarks/torch_baseline.build_workload``):
   the identity half's ``fwd`` and ``bwd_table``, the dense feature
   half's ``fwd`` and ``bwd_h``; and on small adversarial streams
   (padding, repeated and unvisited blocks, ragged output rows): atol
   1e-4 / rtol 1e-5;
4. the featureless path: ``mrgcn_tpu_torch.run`` trains the featureless
   full-batch NC model (``configs/dmg.toml``'s ``[model]``: 2 layers,
   hidden 16, 40 bases) for 5 epochs on that graph with random weights
   from seed 0, then evaluates on the test split;
5. the multimodal path, this slice's main path: the same CLI and model
   over DMG's numeric (4), gYear (1) and string (16, the from-scratch
   text encoder: d=128, one head, two blocks, bf16 body) features, drawn
   from seed 0 at ``benchmarks/bench_suite.multimodal_workload``'s counts
   (20,000 numbers, 10,000 years, 8,000 byte strings of length 1-128),
   5 epochs. Each path's kernel launch counts are set to 0 just before it
   and read just after: every kernel it runs must have launched at least
   2 x 5 times. The two paths run before phase 6: run after it, the
   featureless epoch measured about 15 % slower than in a fresh process
   (H100 80GB HBM3, 700 W);
6. the fused attention and fused MLP kernels, forward and backward,
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
7. the CLI on a small graph on the card and on the CPU (plain versions),
   featureless and multimodal: the per-epoch losses must agree (rtol 1e-4
   featureless; 1e-3 multimodal, whose text encoder rounds to bf16); and
   each encoder, with the same weights on both sides, gives the same
   outputs before its gate (max error relative to the largest value) and
   the same parameter gradients (error norm relative to the gradient's
   norm): 1e-4 for the f32 MLP encoders; 1e-2 for the outputs and 1e-1
   for the gradients of the bf16 text encoder.

Every kernel comparison checks bit identity across two runs, and the
slice-shape ones time the kernel and the plain version (median of 20
CUDA-event timed calls, in the order plain, kernel, kernel, plain).
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
# encoder (outputs, parameter gradients), card vs CPU (see
# encoder_agreement). Sound kernels: the f32 MLP encoders agree to 3e-6,
# the bf16 text encoder to 1.1e-3 and 2.8e-2 over five cotangents. One key
# tile of 16 dropped from the attention forward's P V read 0.29 (output);
# its dk/dv zeroed in the backward, 0.26 (gradients); the losses stayed
# within 2e-4 either way (H100 80GB HBM3, 700 W). The gradients are read
# by norm: their largest-element error moved 2.6e-2 to 8.0e-2 between
# runs, with the weights the CPU side's training ends at
ENCODER_RTOL = {"mlp": (1e-4, 1e-4), "text": (1e-2, 1e-1)}
KERNEL_SOURCES = ("sorted_scatter", "fused_attention", "fused_mlp")
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


def multimodal_width() -> int:
    """``X_width`` of the multimodal path: the summed embedding widths of
    ``configs/dmg.toml``'s ``MULTIMODAL`` features (4 + 1 + 16)."""
    with open(ROOT / "configs" / "dmg.toml", "rb") as f:
        dmg = tomllib.load(f)
    return sum(f["embedding_dim"] for f in dmg["graph"]["features"]
               if f["datatype"] in MULTIMODAL)


def kernel_phase(work, device) -> list:
    """Kernel vs plain on every stream the main paths' layer 0 scatters
    (the identity half's ``fwd`` and ``bwd_table``; with features, the
    dense half's ``fwd`` and ``bwd_h``) and on adversarial streams."""
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
    print(f"[kernel] layer-0 plans built in {time.perf_counter() - t0:.1f}"
          f" s: {ident.out_nodes} output nodes")

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    # one training step's four calls, in the order the step makes them
    for label, stream, out_rows, width in (
            ("fwd", ident.fwd, ident.n_out_rows, 128),
            ("dense_fwd", dense.fwd, dense.n_out_rows,
             line_width(dense.k_out, hidden)),
            ("dense_bwd_h", dense.bwd_h, dense.n_in_rows,
             line_width(dense.k_in, x_width)),
            ("bwd_table", ident.bwd_table, work["R"] * ident.n_in_rows,
             128)):
        print(f"[kernel] stream {label}: E_pad {stream.num_padded_edges}, "
              f"relation-constant {stream.rel_const}, {out_rows} out rows")
        msgs = torch.randn(stream.num_padded_edges, width, generator=gen,
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


def timed_pair(kernel, plain) -> dict:
    """Median ms of kernel and plain, in the order plain, kernel, kernel,
    plain; each keeps the faster of its two runs."""
    plain_a = time_ms(plain)
    kern_a = time_ms(kernel)
    kern_b = time_ms(kernel)
    plain_b = time_ms(plain)
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "ms_runs": [kern_a, kern_b], "plain_ms_runs": [plain_a, plain_b]}


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

    def compare(name, label, kernel, plain, scales, timed):
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
            row.update(timed_pair(kernel, plain))
        print(f"[kernel] {name} {json.dumps(row)}")
        rows[name].append(row)

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
        compare("attention_fwd", label,
                lambda: att.attention_fwd(q, k, v, valid),
                lambda: att.attention_fwd_reference(q, k, v, valid),
                scales[:1], timed)
        compare("attention_bwd", label,
                lambda: att.attention_bwd(q, k, v, valid, do),
                lambda: att.attention_bwd_reference(q, k, v, valid, do),
                scales[1:], timed)
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
        compare("mlp_fwd", label, lambda: fm.mlp_fwd(x, w1, b1, w2, b2),
                lambda: fm.mlp_fwd_reference(x, w1, b1, w2, b2),
                scales[:1], timed)
        compare("mlp_bwd", label, lambda: fm.mlp_bwd(x, w1, b1, w2, do),
                lambda: fm.mlp_bwd_reference(x, w1, b1, w2, do),
                scales[1:], timed)
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
    from mrgcn_tpu_torch.ops.sorted_stream import sorted_scatter
    return {"sorted_scatter": sorted_scatter,
            "attention_fwd": att.attention_fwd,
            "attention_bwd": att.attention_bwd,
            "mlp_fwd": fm.mlp_fwd, "mlp_bwd": fm.mlp_bwd}


def slice_phase(work, tmp: Path, tag: str, kernels, F=None) -> dict:
    """Train ``EPOCHS`` epochs through the CLI with every launch count set
    to 0 just before and read just after; each of ``kernels`` must have
    launched at least 2 x EPOCHS times."""
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
    for name in kernels:
        check(launches[name] >= 2 * EPOCHS,
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


SOURCES = {
    "sorted_scatter": ("mrgcn_tpu_torch/csrc/sorted_scatter.cu",
                       "mrgcn_tpu/ops/pallas_gather.py:247"),
    "attention_fwd": ("mrgcn_tpu_torch/csrc/fused_attention.cu",
                      "mrgcn_tpu/ops/attention.py:44"),
    "attention_bwd": ("mrgcn_tpu_torch/csrc/fused_attention.cu",
                      "mrgcn_tpu/ops/attention.py:59"),
    "mlp_fwd": ("mrgcn_tpu_torch/csrc/fused_mlp.cu",
                "mrgcn_tpu/ops/fused_mlp.py:38"),
    "mlp_bwd": ("mrgcn_tpu_torch/csrc/fused_mlp.cu",
                "mrgcn_tpu/ops/fused_mlp.py:48"),
}


def main() -> None:
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    from benchmarks.torch_baseline import build_workload
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    from mrgcn_tpu_torch.utils.device import pin_float32_precision

    pin_float32_precision()
    smi = card()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_kernels()

    work = build_workload(seed=0)
    rows = {"sorted_scatter": kernel_phase(work, device)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        slice_phase(work, tmp, "dmg_synth", ["sorted_scatter"])
        main_path = slice_phase(work, tmp, "dmg_synth_multimodal",
                                list(SOURCES),
                                F=multimodal_features(work["n"], seed=0))
        rows.update(encoder_kernel_phase(device))
        agreement_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        # sorted_scatter: one multimodal training step's four calls; the
        # others at the slice's shapes (the long-sequence timing is
        # printed, not summed)
        timed = [r for r in rows[name]
                 if "ms" in r and not r["label"].startswith("long")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed)})
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
