#!/usr/bin/env python3
"""Smoke test of the PyTorch port (mrgcn_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, the CUDA toolkit (``nvcc``) and no network, and it fails (exit code
other than 0, no result line) where CUDA is absent or the repository is not
beside it. ``--only a,b`` runs some phases alone (``stream``, ``compose``,
``nc``, ``backbones``, ``backbones_bert``, ``minibatch``, ``lp``,
``wide_basis``,
``checkpoint``, ``etl``, ``encoders``, ``text_attn``, ``agree``,
``mesh``; ``scatter_dot``,
the ``fused_scatter_dot`` cases of ``stream``; ``profile_stream``, the
scatters' device time by kernel on every main-path stream; and
``profile`` /
``profile_mb`` / ``profile_att`` / ``profile_mm``: ``torch.profiler``
breakdowns of the link-prediction step, of a mini-batch NC step, of the
attention kernels and of a multimodal NC step (with the fused MLP's and
the fused attention's share); ``profile_allmodal``, the same over all
five modalities with the convolutional encoders' share (cuDNN
convolutions, BatchNorm, pooling); ``profile_backbones``, the same on the
pretrained backbones (with the f32 products', softmax's and LayerNorm's
shares); ``conv_algorithms``, TCNN S under
cuDNN's heuristic and measured algorithm choice, never part of the whole
run; ``profile``
also compares routes
by device time per step in alternated windows: the basis layer's
backward through ``fused_scatter_dot`` or through ``fused_place_scatter``
and a gathered dot, and the featureless NC step with the identity
compose on its kernels (``compose_table``, ``compose_grad_pass``) or on
the library products, with the kernels' share of the step) and then
prints no result line. Phases, each printing its own lines:

1. the card, as ``nvidia-smi`` and torch see it;
2. the kernels, built from ``mrgcn_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together; with ptxas' report);
3. the stream kernels against their plain PyTorch versions on the card
   (f32 sums in other orders: atol 1e-4 / rtol 1e-5; ``sorted_gather`` bit
   for bit):
   ``fused_scatter_dot`` through its row-segmented kernel, as the layer
   calls it, on the link-prediction graph's dst-sorted ``bwd_h`` stream
   (FB15k-237's sizes, hidden 200) and on row-sorted adversarial streams
   (strided and contiguous values, a hub row of more than 20,000 edges
   split by an all-padding slab, timed), each case with a digest of its
   outputs' bits (``--only scatter_dot`` runs these alone and calls
   nothing a tree without the row-segmented ``sorted_scatter`` and
   ``fused_place_scatter`` lacks: this script run over such a tree sets
   their digests side by side); ``sorted_scatter`` and
   ``fused_place_scatter`` on the four layer-0 streams one multimodal
   training step scatters on the DMG-scale bench graph
   (``benchmarks/torch_baseline.build_workload``): the identity half's
   ``fwd`` and ``bwd_table``, the dense feature half's ``fwd`` and
   ``bwd_h``, each on the route the layer takes (the row-segmented kernel
   on the streams the planner marks ``rows_sorted``; on the dense
   half's relation-constant ``fwd`` the split walk of
   ``fused_place_scatter`` and the block walk of ``sorted_scatter``);
   ``fused_place_scatter`` and ``sorted_gather`` on the link-prediction
   graph's ``fwd`` stream, and the basis layer's other route for the
   ``bwd_h`` gradients (``fused_place_scatter`` and a gathered dot)
   timed beside ``fused_scatter_dot``; the block walk of
   ``sorted_scatter``, the split walk of ``fused_place_scatter`` and
   ``sorted_gather`` on small adversarial streams that are not sorted by
   row (padding, a run of one slab, all-padding slabs, repeated and
   unvisited blocks, ragged output rows, ``k`` 1, 4 and 8, values
   narrower than their slot, runs of some 300 slabs that the split walk
   cuts), where ``fused_scatter_dot`` must raise; then the row-segmented
   kernels of ``sorted_scatter`` and ``fused_place_scatter`` on
   row-sorted adversarial streams (slots drawn per edge, so they
   interleave within a row; ``k`` 8, 4, 1 and 2; contiguous and strided
   values, an odd width, lines of 640 lanes, wider than one warp holds;
   a hub row of more than 20,000 edges split by an all-padding slab,
   timed, each case's longest row held to a float64 sum within 1e-3 of
   its magnitude). Then the compose kernels
   (``compose_grad_pass``, ``compose_table``, ``canonical_copy``) at DMG
   width (R=121, B=40, 12,800 packed rows of 128 lanes; the cotangent
   table taken from a real ``bwd_table`` scatter), on ``packed`` cut from
   a longer parameter (rows strided, as ``models/rgcn._fit_rows`` cuts
   it) and at ragged shapes (R=5, B=3, rows=8; R=475, B=2; rows no
   multiple of 32 or of 8; lines 20, 36 and 256 wide). ``d_comp`` sums
   1,638,400 products per entry, so it is held to 1e-4 + 1e-5 of the sum
   of their absolute values and both sides are printed against an f64
   contraction; the copy is exact. The two compose products run 3xTF32
   on the tensor cores, so their bound counts three TF32 passes at 495
   TFLOP/s (the f32-FMA figure is printed beside it), and their
   registers, spills and shared memory are printed from ``ptxas``. Then
   the featureless layer's forward with each compose variant (the
   model's ``compose_table``, the library matmul, the table given, a
   ``canonical_copy`` of the table), whose launches are
   ``canonical_copy``'s path;
4. the featureless NC path: ``mrgcn_tpu_torch.run`` trains the
   featureless full-batch NC model (``configs/dmg.toml``'s ``[model]``: 2
   layers, hidden 16, 40 bases) for 5 epochs on the DMG-scale graph with
   random weights from seed 0, then evaluates on the test split; the
   composed identity layer launches ``compose_table`` once a forward and
   ``compose_grad_pass`` once a backward (6 and 5 launches: checked);
5. the multimodal NC path: the same CLI and model over DMG's numeric (4),
   gYear (1) and string (16, the from-scratch text encoder: d=128, one
   head, two blocks, bf16 body) features, drawn from seed 0 at
   ``benchmarks/bench_suite.multimodal_workload``'s counts (20,000
   numbers, 10,000 years, 8,000 byte strings of length 1-128), 5 epochs;
   then over all five of DMG's modalities (``dmg_synth_allmodal``): the
   same plus 10,000 WKT geometries of 4-64 points (16, ``TCNN`` size S,
   f32) and 2,000 images of 224 x 224 (128, ``ImageCNN``, bf16 body),
   ``X_width`` 165, so layer 0's dense half packs one row a 256-lane line
   (k = 1), 5 epochs; every BatchNorm's running statistics must be finite
   and moved from their 0 / 1 init. Then the same all-modality graph on
   the v3.0 pretrained backbones (``backbones``): a random DistilBERT at
   ``distilbert-base-multilingual-cased``'s published widths (768 wide, 6
   layers, 12 heads, hidden 3,072, vocabulary 119,547) written into a hub
   cache that ``HF_HUB_CACHE`` names, and a random torchvision-format
   MobileNetV2 ``.pth`` that ``MRGCN_VISION_WEIGHTS`` names, both from
   seed 0; the strings are 8,000 WordPiece-like id sequences of 3-130
   ids; 5 epochs through the CLI with the kernels by route as above and
   the text kernels (#6-#9) never launched; the backbones bit-equal to
   their files after training and the heads moved; on a small graph
   (60 strings, 40 images) the first epoch's loss card against CPU within
   1e-4 and each encoder (backbone outputs, head gradients) within 1e-4;
   and a checkpoint that holds the heads and no backbone tensor, from
   which a restored run gives the same eval-mode logits (1e-5). Then
   (``backbones_bert``) the multimodal graph, no images, on random
   ``bert-base-multilingual-cased``, ``roberta-base``,
   ``xlm-roberta-base``, RoBERTa-PreLayerNorm (transformers' defaults)
   ALBERT-xxlarge (transformers' defaults) and ``bigscience/bloom-560m``
   at their published widths (12 layers, 768 wide, 12 heads, hidden
   3,072, vocabularies 119,547, 50,265, 250,002 and 50,265; ALBERT 4,096
   wide in one shared group, embeddings 128, 64 heads, hidden 16,384,
   vocabulary 30,000; BLOOM 24 layers, 1,024 wide, 16 heads, hidden
   4,096, vocabulary 250,880, ALiBi and a causal mask; the tokenizer's
   files beside them: WordPiece, a small byte-level BPE whose pad is 1,
   a Unigram ``tokenizer.json`` with a precompiled charsmap, BLOOM's
   byte-level BPE layout whose pad is 3), 2,000 strings (500 for
   ALBERT): 3-130 drawn ids, or for XLM-R, ALBERT and
   BLOOM the ids the port's tokenizer gives generated strings (host
   seconds printed), 2 epochs each through the CLI: the same checks of
   launches and backbone, each step's time, device time (CUDA events)
   and peak printed beside the card; on a small graph the first loss and
   the backbone's output card against CPU (1e-4), and for the models
   whose pad is not 0 the pad mask on the card (pads changed under the
   mask move no real token's output; a padded row pools as it does
   alone);
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
   falls fast). Before it, mini-batch training through the same CLI at
   DMG width: featureless NC with ``batchsize = 32``
   (``configs/dmg_reference.toml``), 2 epochs; the same with
   ``neighbor_fanout = 10`` and ``neighbor_fanout_rounds = 2``; the
   multimodal model with ``batchsize = 512``, 1 epoch (the encoder kernels
   run on each batch's outer-hop rows); the losses must be finite and
   fall. And node-sliced link prediction at FB15k-237's width, again
   through the CLI with ``configs/fb15k-237.toml``'s own ``gcn_batchsize
   = 32``, ``test_batchsize = 500``: one whole epoch of some 900 batches
   (the cut: 1 epoch), the ranking of the training batches and the sliced
   ranking of the test split; build, epoch and ranking seconds are
   printed.
   Each path's kernel launch counts are set to 0 just before it and read
   just after: every kernel it runs must have launched. The paths run
   before phase 7: run after it, the featureless epoch measured about
   15 % slower than in a fresh process (H100 80GB HBM3, 700 W).
   The scatters' launches are checked by route: on the featureless NC
   path the place-scatter's row-segmented kernel twice a step (a forward
   more for the test split), its split walk never; on the paths over
   features besides the dense half's streams on the routes the planner
   gives them (``dense_routes``: the split walk once a training forward,
   ``sorted_scatter``'s row-segmented kernel once a step and once for the
   test forward, at both widths), each count exact; on the
   link-prediction path every
   ``fused_place_scatter`` launch on the row-segmented kernel (two a step
   and two an evaluation: layer 0, and layer 1 on ``dense_basis``),
   ``fused_scatter_dot`` two a step and ``sorted_scatter`` one a step
   (layer 1's backward, 512-lane lines), as the planner gives them
   (``lp_planned_launches``); the
   mini-batch and node-sliced paths run the unplanned layers, and any
   scatter they launch must be on its row-segmented kernel. Then,
   counted apart from every
   path, the gradient of ``featureless_basis`` from its own backward
   (``fused_scatter_dot``)
   against autograd through the same forward written with differentiable
   gathers and the differentiable ``sorted_scatter`` (whose backward
   launches ``sorted_gather``), at full width: within 1e-4 of the largest
   value. No entry point differentiates ``sorted_scatter`` through
   autograd, so ``sorted_gather`` reads 0 launches on every path; this
   check's launches stand under ``gradient_check_launches``. Then the
   wide-line basis engine (``wide_basis``) on the same graph as the task
   builds it: layer 1's ``dense_basis`` against the relation-grouped
   layer it replaced, forward and backward at full width on the same
   inputs, output and every gradient within 1e-4 of the largest entry,
   each timed with its peak bytes; and the kernels on the engine's
   streams against their plain versions, timed: ``sorted_scatter`` on
   the ``bwd_h`` stream with 512- and 1,024-lane lines (2 and 4 bases),
   ``fused_place_scatter`` on the ``1:1`` dense ``fwd`` stream, each
   longest row held to a float64 sum;
7. the fused attention and fused MLP kernels, forward and backward,
   against their plain versions at the multimodal slice's shapes
   (attention N=8,000, L=128, d=128; MLP 1,024,000 rows, 128 -> 512 ->
   128, bf16) and on adversarial ones (N not a multiple of 8, L=37, a
   sequence that is all padding, one of length 1, L=300 and 512, d=64
   and 8; MLP rows 1, one past a tile or a weight-gradient segment, one
   hidden chunk, d=48); attention also timed at N=2,000, L=512 and at
   the slice's shape with every key valid (no key tile to skip), and held
   on masks with holes (whole key tiles of padding inside a sequence);
   the MLP also timed at a multimodal mini-batch's 262,144 rows, beside
   the bf16 cuBLAS chain (``F.linear``, ``F.gelu``, ``F.linear``, and its
   autograd backward; timed only), with each launch's device time. Each
   case prints a digest of its outputs' bits, to set beside another
   tree's run. Each kernel's registers, spills and static shared memory
   are printed from the ``ptxas`` log, and a timer that needs no stream
   to finish ends the run if the attention or the MLP cases hang. Each
   element is
   held to ``|got - want| <= 2^-6 (|want| + scale) + 1e-6``, ``scale``
   being its product over absolute values
   (``mrgcn_tpu_torch.ops.kernel_bounds``: bf16 intermediates rounded
   from f32 sums taken in other orders land a bf16 step apart). Then the
   convolutional encoders (``conv_encoder_phase``; cuDNN's, no
   hand-written kernel): ``TCNN`` S / M / L and ``ImageCNN`` ``sep`` /
   ``dense`` on 256 rows, card against CPU with the same weights and
   running statistics, timed, TF32 checked off. Then ``text_attn``: #12,
   the attention kernels with H = 2, 4, 8 heads of width 128 / H read by
   strides in flax's ``(N, L, H, d)`` layout, against their plain version
   at N = 8,000, L = 128 and N = 2,000, L = 512 with ragged, all-valid
   and holed masks (held as above; one head of a case bit-equal to the
   single-head kernel on it), timed beside SDPA with their bound; a
   ``TextEncoder`` with 2, 4 and 8 heads trained 3 steps on the
   multimodal path's strings (only #12 launches: 2 a step each way) and
   at 4 heads card against CPU; and the CLI on the small multimodal graph
   under ``MRGCN_TEXT_ATTN`` = ``xla``, ``flash``, ``plain`` and
   ``plain_fused``, card against CPU as in phase 8;
8. small graphs on the card and on the CPU (plain versions). NC through
   the CLI, featureless and multimodal: the per-epoch losses must agree
   (rtol 1e-4 featureless; 1e-3 multimodal, whose text encoder rounds to
   bf16); and each encoder, with the same weights on both sides, gives
   the same outputs before its gate (max error relative to the largest
   value) and the same parameter gradients (error norm relative to the
   gradient's norm): 1e-4 for the f32 MLP encoders; 1e-2 for the outputs
   and 1e-1 for the gradients of the bf16 text encoder. The same over
   all five modalities (120 images of 224 x 224, 300 geometries): the
   first epoch's loss within 1e-4, the trajectory within
   ``AGREE_ALLMODAL_RTOL``, each encoder as above (``TCNN`` as the MLP
   encoders, ``ImageCNN`` as the text encoder). LP on the
   basis-stream path, both sides fed the same corrupted triples: every
   step's loss agrees within 1e-4 relative and every parameter's gradient
   within 1e-4 of its largest entry, on a small graph for three steps
   (the losses fall; test ranks equal except where near-equal scores
   change order: at most 2 % of them, the count is printed), on the same
   small graph in node-sliced batches (the unplanned layers; each step
   from the CPU side's parameters, and a step where a ReLU input within
   rounding of zero changes side, which is counted and printed, holds the
   gradients by norm, 1e-2), and on the FB15k-237-size graph at full
   width for one step. Mini-batch NC
   (``batchsize = 32``) on the small graph: losses within 1e-4 relative
   over 3 epochs. The composed identity layer's output and gradients on
   the card (``compose_table``, ``fused_place_scatter``,
   ``compose_grad_pass``, on a row slice of the parameter) within 1e-4 of
   their largest entry of the CPU's;
9. the ETL (``etl``, run after the checkpoint phase): phase 4's graph
   written as gzipped N-Triples (its 600,000 edges over 120 properties,
   its 10,000 labels as target triples in 60 / 20 / 20 splits, and
   phase 5's literal counts without the images, which need PIL: 20,000
   doubles, 10,000 gYears, 8,000 strings of 1-128 bytes, 10,000 WKT
   linestrings of 4-64 points, from seed 0, on four of the 120
   properties, so that R stays 121 without inverse relations); the
   port's ``mkdataset`` CLI builds it twice (host seconds by stage, the
   artifact's bytes and the parser printed; equal arrays), the native
   parser's triples held to the Python parser's on the context file;
   the artifact trains ``EPOCHS`` epochs through ``run.run_cli`` at
   ``configs/dmg.toml``'s model and feature widths (numeric, gYear,
   string, WKT), the losses finite and falling and the launches by
   kernel and route as in phase 5; then ``mkdataset`` on
   ``benchmarks/parity/big/lp`` and 3 LP epochs at
   ``configs/fb15k-237.toml``'s widths, the launches by kernel and route
   those of the plans the planner builds for that artifact; then the
   same graph written by this script as gzipped Turtle, RDF/XML and
   JSON-LD (in the N-Triples file's triple order), each built by the
   CLI (host seconds by stage and the files' bytes printed) with arrays
   equal to the N-Triples build, the parity NC graph as TriG and under
   ``.n3``, ``.owl`` and ``.json`` names likewise (these writes and
   builds in worker processes, beside each other and the steps before
   them), and the Turtle build trained as above;
10. multi-device training (``mesh``, ``mrgcn_tpu_torch.parallel``):
   (a) a world of one rank over NCCL through ``parallel.mesh.launch``
   trains phase 4's featureless model at DMG width, its losses and
   state the single-device run's to the bit (where the single-device run
   repeats itself to the bit); (b) worlds ``"2"`` and ``"2x2"`` on the
   one card over gloo with CUDA tensors (NCCL refuses two ranks on one
   GPU): featureless NC at DMG width and full-graph LP at FB15k-237's
   width (3 epochs), multimodal and all-modality NC on the small graph (2
   epochs; the image CNN's body in f32, its twin) and node-sliced LP on a
   small LP graph (1 epoch, its ReLU inputs that change side against the
   single-device run counted), each held to the single-device run on the
   card: the first step's loss within 1e-5 relative, every gradient
   within 1e-4 of its largest entry (the text and image encoders', each
   as one vector, by norm within ``MESH_NORM_RTOL``), the running
   statistics within 1e-5;
   later losses within 1e-3, test accuracy within one node, the trained
   state bit-equal on every rank, each rank's launches by kernel and
   route the single-device run's; epoch times, bytes handed to the
   collectives a step and each rank's peak memory printed (ranks sharing
   one card: not a scaling figure); (c) the same over NCCL, one card a
   rank, where the machine has two cards or more, else ``mesh nccl
   multi-card: not run`` is printed. The worlds run side by side.

Every kernel comparison checks bit identity across two runs, and the
slice-shape ones time the kernel, the plain version and, where one PyTorch
call computes the same function, that call (median of 20 CUDA-event timed
calls, in the order plain, kernel, kernel, plain). Each timed row carries
its bound: the larger of the bytes the function must move over the card's
3.35 TB/s and its operations over the card's peak for their type (67
TFLOP/s f32, 989 TFLOP/s bf16 and 495 TFLOP/s TF32 tensor cores), with
both counts. Then one
JSON line with every kernel's numbers, and last the result line
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tomllib
from pathlib import Path
from types import SimpleNamespace

from mrgcn_tpu_torch.parallel.parity import (kernel_counters, read_launches,
                                             reset_launches)

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
# the convolutional encoders, card (cuDNN) vs CPU, same bounds by kind:
# TCNN is f32 throughout (no TF32: checked), as the MLP encoders; the
# image CNN's body is bf16, as the text encoder's. In train mode the
# running statistics are held with the gradients
ENCODER_RTOL.update({"tcnn": ENCODER_RTOL["mlp"],
                     "image": ENCODER_RTOL["text"]})
# the pretrained encoders, card vs CPU: f32 throughout (TF32 off), the
# frozen backbone's outputs and the trainable head alike
ENCODER_RTOL["backbone"] = (1e-4, 1e-4)
# rows of the encoders phase's card-vs-CPU cases; the image side there,
# and the dmg_synth_allmodal path's counts and shapes
CONV_ROWS, CONV_IMAGE_SIDE = 256, 64
ALLMODAL_GEOMETRIES, ALLMODAL_IMAGES, IMAGE_SIDE = 10_000, 2_000, 224
# card vs CPU losses over three epochs of the all-modality small graph: the
# image CNN's bf16 body under batch statistics drifts by bf16 steps
# between any two implementations, its gradients with it, and two Adam
# steps carry that into the losses: 1.8e-3 to 2.0e-3 in three runs where
# the multimodal graph's stayed within 2.3e-5 (H100 80GB HBM3, 700 W);
# the first epoch's loss, from equal parameters, is held to 1e-4
AGREE_ALLMODAL_RTOL = 5e-3
# the compose kernels' launches a full-batch NC training step makes on the
# port's route (rspmm.compose_packed): the identity layer's forward
# (compose_table) and its backward (compose_grad_pass)
COMPOSE_PER_STEP = {"compose_table": 1, "compose_grad_pass": 1}
KERNEL_SOURCES = ("sorted_scatter", "sorted_gather", "fused_place_scatter",
                  "scatter_dot", "compose", "fused_attention",
                  "fused_attention_heads", "fused_mlp")
# configs/fb15k-237.toml trains 20 epochs and ranks every 10. The f32 loss
# sits at ln 2 until epoch 20 (the scores start near 1e-5 and the mean
# BCE's gradient entries below Adam's eps, so the parameters creep) and
# then falls fast: ten more epochs show it (0.6931 -> 0.5052 on an H100 80GB
# HBM3 at 700 W)
LP_EPOCHS, LP_EVAL_INTERVAL = 30, 10
LP_HIDDEN = 200
LP_SLICED_LAYERS = 1
# published peaks of one H100 SXM: HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense bf16 and TF32 tensor-core FLOP/s
HBM_BYTES_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
TF32_FLOPS = 495e12      # dense TF32 tensor-core FLOP/s
MULTIMODAL = ("xsd.numeric", "xsd.gYear", "xsd.string")
# all five of DMG's modalities: the multimodal ones, WKT geometries (TCNN)
# and images (ImageCNN)
ALLMODAL = MULTIMODAL + ("ogc.wktLiteral", "blob.image")
# rows (sequences x 128 tokens) the text MLP takes in most batches of the
# multimodal mini-batch run (batchsize = 512: 2,048 string rows after
# bucketing; the minibatch phase checks it is the largest it sees)
MINIBATCH_TEXT_ROWS = 2048 * 128


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


@contextlib.contextmanager
def timed_part(label: str):
    """Print the wall seconds of the body, a part of a phase, as
    ``[time]   <label>``: where a phase's time goes."""
    t0 = time.perf_counter()
    yield
    print(f"[time]   {label}: {time.perf_counter() - t0:.1f} s")


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
                                       "smem", "Performance Loss")):
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


def digest(outputs) -> str:
    """The outputs' bits, to set beside another tree's run."""
    import torch
    h = hashlib.sha256()
    for t in outputs:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()[:16]


def compare_stream(name, label, kernel, plain, library=None, work=None,
                   exact=False, shape=None, scales=None,
                   flops_peak=None) -> dict:
    """One stream kernel against its plain version: shapes, finiteness,
    tolerance (or bit equality with ``exact``), two bit-identical runs;
    with ``work`` (bytes, f32 operations) also the timings and the
    bound (operations at ``flops_peak``, f32 FMA's by default). An output
    is held to ``ATOL + RTOL |want|`` element by element;
    where ``scales`` gives it a tensor (a long reduction: the sum of its
    terms' absolute values), to ``ATOL + RTOL scale``, since an entry near
    zero of such a sum carries the rounding of its large terms."""
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
        scale = scales[i] if scales and scales[i] is not None else w.abs()
        ok = torch.equal(g, w) if exact \
            else bool(((g - w).abs() <= ATOL + RTOL * scale).all())
        check(ok, f"{what}: kernel disagrees with plain (max abs err {e})")
        check(torch.equal(g, a), f"{what}: two runs differ")
    row = {"label": label, **(shape or {}), "max_abs_err": err,
           "digest": digest(as_tuple(got))}
    if work is not None:
        row.update(timed_pair(kernel, plain, library))
        row.update(bound(work[0], work[1], flops_peak or F32_FLOPS))
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


def sorted_adversarial_stream(rng, n_edges, rb, eb, n_blocks, hub):
    """A row-sorted stream (``Stream.rows_sorted``), laid out as the
    planner lays out ``bwd_h`` (``relational._segment_layout``): rows
    drawn from the even blocks (the odd ones are never visited), one hub
    row with ``hub`` more edges over many slabs, each block's run padded
    to whole slabs; then a tenth of the real edges turned into padding and
    one all-padding slab put inside the hub's run. Returns numpy ``local``
    ``(nslab, eb)``, ``blk`` ``(nslab,)`` and a per-edge scale, 1 over the
    degree of the edge's row (the layer's norm): a row's sum then stays
    near 1 in size however long the row."""
    import numpy as np
    from mrgcn_tpu_torch.ops.relational import _segment_layout
    rows = (rng.choice(np.arange(0, n_blocks, 2), n_edges) * rb
            + rng.integers(0, rb, n_edges))
    rows = np.concatenate([rows, np.full(hub, rows[n_edges // 2])])
    order, slots, E_pad, slab_blk = _segment_layout(rows, rows, rows // rb,
                                                    eb)
    local = np.full(E_pad, rb, np.int64)
    local[slots] = rows[order] % rb
    local[rng.random(E_pad) < 0.1] = rb
    # the all-padding slab goes where the middle of the hub's edges lies
    mid = int(slots[np.searchsorted(rows[order], rows[n_edges // 2])
                    + hub // 2]) // eb
    local = np.insert(local.reshape(-1, eb), mid, rb, axis=0)
    blk = np.insert(slab_blk, mid, slab_blk[mid])
    row = blk[:, None] * rb + np.minimum(local, rb - 1)
    real = local < rb
    deg = np.bincount(row[real], minlength=int(row.max()) + 1)
    scale = np.where(real, 1.0 / np.maximum(deg[row], 1), 1.0)
    return (local.astype(np.int32), blk.astype(np.int32),
            scale.reshape(-1).astype(np.float32))


def allmodal_features(num_nodes: int, wordpiece_vocab: int = 0) -> dict:
    """The ``dmg_synth_allmodal`` path's features, drawn from seed 0: the
    multimodal path's (the same draws) and ``ALLMODAL_GEOMETRIES`` WKT
    geometries of 4-64 points and ``ALLMODAL_IMAGES`` uint8 images of
    ``IMAGE_SIDE`` x ``IMAGE_SIDE`` (DMG's ``centerCrop``); with
    ``wordpiece_vocab`` the strings are WordPiece-like ids for the
    pretrained text backbone (``[CLS]``, 1-128 ids, ``[SEP]``)."""
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    return multimodal_features(num_nodes, seed=0,
                               num_geometries=ALLMODAL_GEOMETRIES,
                               num_images=ALLMODAL_IMAGES,
                               image_size=IMAGE_SIDE,
                               wordpiece_vocab=wordpiece_vocab)


def multimodal_width(features=MULTIMODAL) -> int:
    """``X_width`` of a path over ``features``: the summed embedding widths
    of those of ``configs/dmg.toml``'s features (``MULTIMODAL``: 4 + 1 +
    16; ``ALLMODAL``: 4 + 1 + 16 + 128 + 16)."""
    with open(ROOT / "configs" / "dmg.toml", "rb") as f:
        dmg = tomllib.load(f)
    return sum(f["embedding_dim"] for f in dmg["graph"]["features"]
               if f["datatype"] in features)


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


def scatter_work(real, per_edge, flops_per_edge, local, blk, out_rows,
                 L) -> tuple:
    """(bytes, f32 operations) a scatter must move and do: its ``per_edge``
    floats (a line for #1; the values, slot and norm for #5) at the real
    edges only, since the function reads no padding edge; local and blk
    whole (the walk reads every slot) and the output whole (every row is
    written), as ``scatter_dot_cases`` counts #3's."""
    return (real * per_edge * 4 + nbytes(local, blk) + out_rows * L * 4,
            real * flops_per_edge)


def scatter_cases(names, label, stream, place, out_rows, L, k, d, gen,
                  device) -> dict:
    """``sorted_scatter`` (on random full lines) and
    ``fused_place_scatter`` (on random ``d``-wide values placed at the
    slots ``place``, the stream's ``out_mod`` or ``in_mod``) on one
    stream, each on the route the layer takes there (the row-segmented
    kernel where the planner marks the stream ``rows_sorted``), against
    its plain version and against ``index_add_`` on lines expanded
    beforehand."""
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

    shape["rows_sorted"] = flag = stream.rows_sorted
    shape["real_edges"] = real
    if "sorted_scatter" in names:
        msgs = torch.randn(E, L, generator=gen, device=device)
        args = (msgs, local, blk, out_rows, rb, eb)
        out["sorted_scatter"] = compare_stream(
            "sorted_scatter", label,
            lambda: ss.sorted_scatter(*args, rows_sorted=flag),
            lambda: ss.sorted_scatter_reference(*args), index_add(msgs),
            scatter_work(real, L, L, local, blk, out_rows, L), shape=shape)
        del msgs
    if "fused_place_scatter" in names:
        V = torch.randn(E, d, generator=gen, device=device)
        args = (V, place, stream.norm, local, blk, out_rows, k, L, rb, eb)
        lines = ss.expand_sub(V * stream.norm[:, None], place, k, L)
        out["fused_place_scatter"] = compare_stream(
            "fused_place_scatter", label,
            lambda: ss.fused_place_scatter(*args, rows_sorted=flag),
            lambda: ss.fused_place_scatter_reference(*args),
            index_add(lines),
            scatter_work(real, d + 2, 2 * d, local, blk, out_rows, L),
            shape={**shape, "Lv": d, "k": k})
        del V, lines
    return out


def nc_layer0_plans(work, device, labels=None, x_width=None):
    """The identity (``8:8:id``) and dense (``4:8``; ``k:8`` at another
    ``x_width``) plans of the NC paths' frontier-restricted layer 0 on the
    DMG-scale graph, for the training labels or the nodes ``labels``."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.models.rgcn import EdgeBlock
    from mrgcn_tpu_torch.ops.rspmm import packing_factor
    from mrgcn_tpu_torch.tasks.common import restricted_layer_edges

    n = work["n"]
    structure = SimpleNamespace(src=work["src"], dst=work["dst"],
                                rel=work["rel"], norm=work["norm"],
                                num_nodes=n)
    full = EdgeBlock(src=torch.as_tensor(work["src"]),
                     dst=torch.as_tensor(work["dst"]),
                     rel=torch.as_tensor(work["rel"]),
                     norm=torch.as_tensor(work["norm"]), num_out=n)
    x_width = x_width or multimodal_width()
    labels = work["labels_idx"] if labels is None else labels
    t0 = time.perf_counter()
    chain = restricted_layer_edges(structure, np.unique(labels),
                                   2, full, first_dim=work["hidden"],
                                   X_width=x_width,
                                   featureless=False, device=device)
    ident = chain[0].plans["8:8:id"]
    dense = chain[0].plans[f"{packing_factor(x_width)}:"
                           f"{packing_factor(work['hidden'])}"]
    print(f"[kernel] NC layer-0 plans built in "
          f"{time.perf_counter() - t0:.1f} s: {ident.out_nodes} output nodes")
    return ident, dense


def nc_stream_phase(work, device, rows) -> None:
    """``sorted_scatter`` and ``fused_place_scatter`` on every stream the
    NC paths' layer 0 scatters (the identity half's ``fwd`` and
    ``bwd_table``; with features, the dense half's ``fwd`` and
    ``bwd_h``)."""
    import torch
    from mrgcn_tpu_torch.ops.relational import line_width

    x_width, hidden = multimodal_width(), work["hidden"]
    ident, dense = nc_layer0_plans(work, device)
    # the routes the NC paths' launch counts expect (main): every stream
    # row-sorted but the dense half's relation-constant fwd
    for what, stream, sorted_ in (
            ("identity fwd", ident.fwd, True),
            ("identity bwd_table", ident.bwd_table, True),
            ("dense fwd", dense.fwd, False),
            ("dense bwd_h", dense.bwd_h, True)):
        check(stream.rows_sorted == sorted_
              and stream.rel_const == (not sorted_),
              f"NC layer 0's {what} stream: rows_sorted "
              f"{stream.rows_sorted}, relation-constant {stream.rel_const}")

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
    # over all five modalities (X_width 165) the dense half packs one row
    # a line: its bwd_h carries 256-lane lines into sorted_scatter (k = 1)
    x_all = multimodal_width(ALLMODAL)
    _, dense1 = nc_layer0_plans(work, device, x_width=x_all)
    h = dense1.bwd_h
    check(dense1.k_in == 1 and h.rows_sorted and not h.rel_const,
          f"all-modality layer 0's bwd_h: k {dense1.k_in}, rows_sorted "
          f"{h.rows_sorted}, relation-constant {h.rel_const}")
    L = line_width(1, x_all)
    print(f"[kernel] stream dense_bwd_h_k1: E_pad {h.num_padded_edges}, "
          f"{dense1.n_in_rows} out rows of {L} lanes")
    got = scatter_cases(("sorted_scatter",), "dense_bwd_h_k1", h, h.in_mod,
                        dense1.n_in_rows, L, 1, x_all, gen, device)
    rows["sorted_scatter"].append(got["sorted_scatter"])
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
    """``fused_place_scatter`` on the LP ``fwd`` stream and
    ``sorted_gather`` on it (the backward of the differentiable
    ``sorted_scatter``), at hidden 200 in 256-lane rows; then the basis
    layer's other route for the ``bwd_h`` gradients
    (``fused_place_scatter``, then a dot with the gathered table rows),
    held to ``fused_scatter_dot``'s plain version and timed beside its
    kernel (``scatter_dot_phase``), as ``place_dot_ms``."""
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    from mrgcn_tpu_torch.ops.relational import line_width
    gen = torch.Generator(device=device).manual_seed(1)
    d, L = LP_HIDDEN, line_width(1, LP_HIDDEN)

    f = plan.fwd
    check(f.rows_sorted, "the planner did not mark LP's fwd rows_sorted")
    got = scatter_cases(("fused_place_scatter",), "lp_fwd", f, f.out_mod,
                        plan.n_out_rows, L, 1, d, gen, device)
    rows["fused_place_scatter"].append(got["fused_place_scatter"])

    h = plan.bwd_h
    dvn, w, table = lp_bwd_h_inputs(plan, device)
    T, gathered = plan.n_in_rows, h.gather_row.long()
    args = (dvn, w, h.scatter_local, h.scatter_blk, table, T, h.row_block,
            h.edge_block)

    def placed():
        return (ss.fused_place_scatter(dvn, h.in_mod, w, h.scatter_local,
                                       h.scatter_blk, T, 1, L, h.row_block,
                                       h.edge_block,
                                       rows_sorted=h.rows_sorted),
                (dvn * table[gathered][:, :d]).sum(dim=1))

    got, want = placed(), ss.fused_scatter_dot_reference(*args)
    for g, w_ in zip(got, want):
        check(bool(((g - w_).abs() <= ATOL + RTOL * w_.abs()).all()),
              "fused_scatter_dot lp_bwd_h: the place-scatter route "
              "disagrees with plain")
    ms = time_ms(placed)
    row = next(r for r in rows["fused_scatter_dot"]
               if r["label"] == "lp_bwd_h")
    row["place_dot_ms"] = ms
    print(f"[kernel] fused_scatter_dot lp_bwd_h: the layer's other route, "
          f"fused_place_scatter + gathered dot, {ms:.3f} ms against "
          f"{row['ms']:.3f} ms")
    del dvn, w, got, want

    local, blk, rb, eb = f.scatter_local, f.scatter_blk, f.row_block, \
        f.edge_block
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


def lp_bwd_h_inputs(plan, device):
    """``dvn`` (scaled by the stream's norm, as the layer scales it),
    ``w`` and the table of the basis layer's backward on LP's ``bwd_h``
    stream, from a generator of their own."""
    import torch
    from mrgcn_tpu_torch.ops.relational import line_width
    gen = torch.Generator(device=device).manual_seed(4)
    h, d = plan.bwd_h, LP_HIDDEN
    E, T = h.num_padded_edges, plan.n_in_rows
    dvn = torch.randn(E, d, generator=gen, device=device) * h.norm[:, None]
    w = torch.randn(E, generator=gen, device=device)
    table = torch.randn(T, line_width(1, d), generator=gen, device=device)
    return dvn, w, table


def scatter_dot_phase(plan, device, rows) -> None:
    """``fused_scatter_dot`` (its row-segmented kernel, the layer's route)
    on LP's dst-sorted ``bwd_h`` stream, timed, and on row-sorted
    adversarial streams: ``dvn`` cut from wider rows at an odd offset
    (4-byte loads) or contiguous (16-byte loads); the last with a hub row
    of more than 20,000 edges over some 80 slabs, split by an all-padding
    slab, timed too. Every case prints its outputs' digest. This phase
    calls nothing of the API that a tree before the row-segmented
    ``sorted_scatter`` and ``fused_place_scatter`` lacks, so this script
    run with ``--only scatter_dot`` over such a tree gives its bits."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    h = plan.bwd_h
    check(h.rows_sorted, "the planner did not mark LP's bwd_h rows_sorted")
    dvn, w, table = lp_bwd_h_inputs(plan, device)
    T = plan.n_in_rows
    rows["fused_scatter_dot"].append(scatter_dot_cases(
        "lp_bwd_h", (dvn, w, h.scatter_local, h.scatter_blk, table, T,
                     h.row_block, h.edge_block),
        stream_shape(h, T, table.shape[1])))
    del dvn, w, table

    rng = np.random.default_rng(3)
    for label, (n_edges, rb, eb, n_blocks, L, d, hub, strided) in {
            "sorted_16x8": (200, 16, 8, 10, 128, 128, 300, False),
            "sorted_64x40_strided": (600, 64, 40, 20, 96, 21, 400, True),
            "sorted_512x256_strided": (3000, 512, 256, 14, 256, 200, 1500,
                                       True),
            "sorted_hub": (30_000, 512, 256, 14, 256, 200, 23_000,
                           False)}.items():
        local, blk, scale = sorted_adversarial_stream(rng, n_edges, rb, eb,
                                                      n_blocks, hub)
        E, out_rows = local.size, (n_blocks + 1) * rb - 37
        wide = torch.as_tensor(rng.standard_normal((E, d + 4))
                               * scale[:, None], dtype=torch.float32,
                               device=device)
        dvn = wide[:, 1:1 + d] if strided else wide[:, :d].contiguous()
        args = (dvn, torch.as_tensor(rng.random(E), dtype=torch.float32,
                                     device=device),
                torch.as_tensor(local, device=device),
                torch.as_tensor(blk, device=device),
                torch.as_tensor(rng.standard_normal((out_rows, L)),
                                dtype=torch.float32, device=device),
                out_rows, rb, eb)
        shape = {"E_pad": E, "slabs": local.shape[0], "out_rows": out_rows,
                 "L": L, "strided": strided}
        if label == "sorted_hub":
            rows["fused_scatter_dot"].append(scatter_dot_cases(
                label, args, shape))
            check(rows["fused_scatter_dot"][-1]["longest_row"] >= 20_000,
                  "sorted_hub: the hub row is shorter than 20,000 edges")
            continue
        rows["fused_scatter_dot"].append(compare_stream(
            "fused_scatter_dot", label,
            lambda: ss.fused_scatter_dot(*args, rows_sorted=True),
            lambda: ss.fused_scatter_dot_reference(*args), shape=shape))


def scatter_dot_cases(label, args, shape) -> dict:
    """``fused_scatter_dot`` on a row-sorted stream through its
    row-segmented kernel, timed against the plain version and the
    ``index_add_`` of the scatter half alone; its longest row held to a
    float64 sum."""
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    dvn, w, local, blk, table, T, rb, eb = args
    E, d = dvn.shape
    L = table.shape[1]
    hrows = edge_rows(local, blk, rb, T)
    visited = hrows < T
    real = int(visited.sum())
    degree = torch.bincount(hrows[visited], minlength=T)
    msgs = torch.nn.functional.pad(dvn * w[:, None], (0, L - d))
    # bytes the function must move: dvn and w at the real edges, the table
    # at the visited rows' first Lv lanes, local and blk whole (the walk
    # reads every slot), out whole (every row is written) and every dot
    work = (real * (d + 1) * 4 + nbytes(local, blk)
            + int((degree > 0).sum()) * d * 4 + T * L * 4 + E * 4,
            4 * real * d)
    shape = {**shape, "Lv": d, "real_edges": real,
             "longest_row": int(degree.max()) if real else 0}
    row = compare_stream(
        "fused_scatter_dot", label,
        lambda: ss.fused_scatter_dot(*args, rows_sorted=True),
        lambda: ss.fused_scatter_dot_reference(*args),
        lambda: torch.zeros(T + 1, L, device=dvn.device)
        .index_add_(0, hrows, msgs),     # the scatter half alone
        work, shape=shape)
    if real:
        row["longest_row_rel_err"] = longest_row_check(
            "fused_scatter_dot", label,
            lambda: ss.fused_scatter_dot(*args, rows_sorted=True), hrows,
            degree, (dvn * w[:, None], dvn, table[:, :d]))
    print(f"[kernel] fused_scatter_dot {label}: row-segmented "
          f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, index_add_ "
          f"(scatter half) {row['library_ms']:.3f} ms; bound "
          f"{row['bound_ms']:.3f} ms"
          + (f"; longest row ({row['longest_row']} edges) off a float64 "
             f"sum by {row['longest_row_rel_err']:.3g} of its magnitude"
             if real else ""))
    del msgs
    return row


def longest_row_check(name, label, kernel, hrows, degree, terms) -> float:
    """A row-segmented kernel's longest row against a float64 sum, held to
    1e-3 of the row's largest magnitude: values scaled by 1/degree leave a
    hub row's entries far below ``ATOL``, where a dropped or doubled piece
    would still pass the element-wise check. ``terms`` is ``(msgs,)`` for
    a scatter whose edge ``e`` adds ``msgs[e]`` to its row's first lanes,
    or ``(msgs, dvn, table_cols)`` for ``fused_scatter_dot``, whose edges'
    dots with the row's table columns are held too. Returns the larger
    relative error."""
    hub = int(degree.argmax())
    on_hub = hrows == hub
    got = kernel()
    out, dots = got if isinstance(got, tuple) else (got, None)
    msgs = terms[0][on_hub].double()
    checks = [("row", out[hub, :msgs.shape[1]], msgs.sum(0))]
    if dots is not None:
        dvn, table_cols = terms[1], terms[2]
        checks.append(("dots", dots.reshape(-1)[on_hub],
                       dvn[on_hub].double() @ table_cols[hub].double()))
    worst = 0.0
    for what, g, want in checks:
        rel = float((g.double() - want).abs().max() / want.abs().max())
        check(rel <= 1e-3, f"{name} {label}: the longest row's {what} "
              f"({int(degree[hub])} edges) is {rel:.3g} of its magnitude "
              "off a float64 sum (bound 1e-3)")
        worst = max(worst, rel)
    return worst


def compose_phase(work, device, rows) -> dict:
    """Kernels ``compose_grad_pass``, ``compose_table`` and
    ``canonical_copy`` against their plain versions at DMG width (the
    cotangent table taken from a real ``bwd_table`` scatter) and at ragged
    shapes; then the stage split of the featureless layer's forward with
    each compose variant, whose launches are counted as the two
    micro-kernels' path."""
    import torch
    from mrgcn_tpu_torch.models.rgcn import _identity_planned
    from mrgcn_tpu_torch.ops import compose_kernels as ck
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    gen = torch.Generator(device=device).manual_seed(3)
    ident, _ = nc_layer0_plans(work, device)
    R, B, hidden = work["R"], work["num_bases"], work["hidden"]
    n_rows, L = ident.n_in_rows, rl.line_width(ident.k_in, hidden)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def grad_case(label, d_t, packed, comp, timed):
        R_, B_ = comp.shape
        K = d_t.numel() // R_
        args = (d_t, packed, comp, R_, B_)
        d_flat = d_t.reshape(R_, -1)
        p_flat = packed.reshape(B_, -1) if packed.is_contiguous() \
            else packed.contiguous().reshape(B_, -1)
        # d_comp sums K products: its entries are held to the sum of their
        # terms' absolute values, and both sides are shown against an f64
        # contraction
        exact = d_flat.double() @ p_flat.double().T
        scale = d_flat.abs() @ p_flat.abs().T
        f64 = {side: float((fn()[0].double() - exact).abs().max())
               for side, fn in (
                   ("kernel", lambda: ss.compose_grad_pass(*args)),
                   ("plain", lambda: ss.compose_grad_pass_reference(*args)))}
        print(f"[kernel] compose_grad_pass {label} d_comp: largest entry "
              f"{float(exact.abs().max()):.6g}, max abs err against f64 "
              f"{json.dumps(f64)}, smallest tolerance "
              f"{ATOL + RTOL * float(scale.min()):.3g}")
        del exact
        row = compare_stream(
            "compose_grad_pass", label, lambda: ss.compose_grad_pass(*args),
            lambda: ss.compose_grad_pass_reference(*args),
            # the two library contractions of the compose backward
            (lambda: (d_flat @ p_flat.T, comp.T @ d_flat)) if timed else None,
            # three TF32 passes on the tensor cores
            (nbytes(d_t, packed, comp) + nbytes(packed) + R_ * B_ * 4,
             3 * 4.0 * R_ * B_ * K) if timed else None,
            shape={"R": R_, "B": B_, "rows": d_t.shape[0] // R_,
                   "L": d_t.shape[1]}, scales=(scale, None),
            flops_peak=TF32_FLOPS)
        if timed:
            # the yardstick of PR 4's f32-FMA design, kept beside it
            row["bound_f32_fma_ms"] = 4.0 * R_ * B_ * K / F32_FLOPS * 1e3
        rows["compose_grad_pass"].append(row)

    def table_case(label, comp, pk_flat, timed):
        R_, B_ = comp.shape
        rows["compose_table"].append(compare_stream(
            "compose_table", label, lambda: ck.compose_table(comp, pk_flat),
            lambda: ck.compose_table_reference(comp, pk_flat),
            (lambda: torch.matmul(comp, pk_flat)) if timed else None,
            (nbytes(comp) + B_ * pk_flat.shape[1] * 4
             + R_ * pk_flat.shape[1] * 4,
             3 * 2.0 * R_ * B_ * pk_flat.shape[1]) if timed else None,
            shape={"R": R_, "B": B_, "cols": pk_flat.shape[1],
                   "row_stride": pk_flat.stride(0)},
            flops_peak=TF32_FLOPS))

    def copy_case(label, x, timed):
        rows["canonical_copy"].append(compare_stream(
            "canonical_copy", label, lambda: ck.canonical_copy(x),
            lambda: ck.canonical_copy_reference(x),
            (lambda: x.clone()) if timed else None,
            (2 * nbytes(x), 0) if timed else None, exact=True,
            shape={"rows": x.shape[0], "L": x.shape[1]}))

    comp, packed = rnd(R, B), rnd(B, n_rows, L)
    b = ident.bwd_table
    d_t = rl._place_scatter(rnd(b.num_padded_edges, hidden), b.in_mod, b,
                            R * n_rows, ident.k_in, hidden, L)
    print(f"[kernel] compose at DMG width: R {R}, B {B}, rows {n_rows}, "
          f"L {L}; {int((d_t != 0).any(dim=1).sum())} of {d_t.shape[0]} "
          "cotangent rows are not zero")
    grad_case("dmg", d_t, packed.reshape(-1, L), comp, True)
    table_case("dmg", comp, packed.reshape(B, -1), True)
    copy_case("dmg", d_t, True)
    # packed cut from a longer parameter, as models/rgcn._fit_rows cuts it
    # where a plan's row block is smaller than the parameter's: rows of one
    # basis contiguous, bases (n_rows + 512) * L floats apart
    param = rnd(B, n_rows + 512, L)
    sliced = param[:, :n_rows]
    grad_case("dmg_row_slice", d_t, sliced, comp, False)
    table_case("dmg_row_slice", comp,
               sliced.as_strided((B, n_rows * L), (param.stride(0), 1)),
               False)
    del d_t, param, sliced
    # ragged: tiny, many relations with two bases, rows no multiple of 32
    # or of 8, lines of other widths; dense random cotangents
    for label, (R_, B_, rows_, L_) in {"ragged_5x3x8": (5, 3, 8, 128),
                                       "ragged_475x2x40": (475, 2, 40, 256),
                                       "ragged_7x4x24": (7, 4, 24, 128),
                                       "ragged_33x17x72": (33, 17, 72, 36),
                                       "ragged_4x3x12": (4, 3, 12, 128),
                                       "ragged_9x5x7": (9, 5, 7, 20)
                                       }.items():
        c_, p_ = rnd(R_, B_), rnd(B_ * rows_, L_)
        grad_case(label, rnd(R_ * rows_, L_), p_, c_, False)
        table_case(label, c_, p_.reshape(B_, -1), False)
        copy_case(label, rnd(R_ * rows_ + 1, 3), False)

    lib = ss._library("compose")
    for kernel_name, used in ptxas_report("compose").items():
        print(f"[kernel] compose.cu {kernel_name}: {json.dumps(used)}")
        check(used.get("spill_store_bytes", 0) == 0,
              f"compose.cu {kernel_name} spills registers")
    print(f"[kernel] compose at DMG width, dynamic shared memory a block: "
          f"compose_grad {lib.mrgcn_compose_grad_smem(R, B)} B, "
          f"compose_table {lib.mrgcn_compose_table_smem(R, B)} B")

    # the stage split of the featureless layer's forward: the model's
    # compose (compose_table on the card), the library matmul in its
    # place, the table given, and a canonical_copy of the table feeding
    # the same aggregate
    counters = kernel_counters()
    reset_launches(counters)
    pk_flat = packed.reshape(B, -1)
    with torch.no_grad():
        table = torch.matmul(comp, pk_flat).reshape(-1, L)
        stages = {
            "whole_ms": time_ms(lambda: _identity_planned(
                packed, comp, ident, hidden)),
            "precomposed_ms": time_ms(lambda: rl.featureless_aggregate(
                table, ident, hidden)),
            "library_whole_ms": time_ms(lambda: rl.featureless_aggregate(
                torch.matmul(comp, pk_flat).reshape(-1, L), ident,
                hidden)),
            "copy_whole_ms": time_ms(lambda: rl.featureless_aggregate(
                ck.canonical_copy(torch.matmul(comp, pk_flat)
                                  .reshape(-1, L)), ident, hidden))}
    launches = read_launches(counters)
    check(launches["compose_table"] > 0 and launches["canonical_copy"] > 0,
          f"compose stages: launches {launches}")
    summary = {"path": "compose_stages", **stages, "launches": launches}
    print(f"[compose] {json.dumps(summary)}")
    torch.cuda.empty_cache()
    return summary


def adversarial_phase(device, rows) -> None:
    """The stream kernels on small hostile streams that are not sorted by
    row (``sorted_scatter``'s block walk, ``fused_place_scatter``'s split
    walk, ``sorted_gather``; ``fused_scatter_dot`` must refuse them); then
    the row-segmented kernels of ``sorted_scatter`` and
    ``fused_place_scatter`` on row-sorted ones."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    rng = np.random.default_rng(0)
    # (slabs, row block, edge block, blocks, L, out rows, k, value width);
    # the last has runs of some 300 slabs, which the split walk cuts
    for label, (nslab, rb, eb, n_blocks, L, out_rows, k, d) in {
            "adversarial_512x256_k8": (40, 512, 256, 14, 128,
                                       15 * 512 - 37, 8, 16),
            "adversarial_512x256_k1": (24, 512, 256, 8, 256, 9 * 512, 1,
                                       200),
            "adversarial_64x40_k4": (33, 64, 40, 20, 96, 21 * 64, 4, 21),
            "adversarial_long_runs_k8": (600, 512, 256, 4, 128,
                                         5 * 512 - 37, 8, 16)}.items():
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
            lambda: ss.fused_place_scatter_reference(*pargs),
            shape={"slabs": nslab, "segment": ss.split_segment(
                nslab, L, torch.cuda.get_device_properties(device)
                .multi_processor_count)}))
        table = torch.as_tensor(
            rng.standard_normal((out_rows, L)), dtype=torch.float32,
            device=device)
        try:
            ss.fused_scatter_dot(V, norm, local, blk, table, out_rows, rb,
                                 eb)
            check(False, f"fused_scatter_dot {label}: took a stream not "
                  "marked rows_sorted")
        except ValueError as err:
            check("rows_sorted" in str(err), f"fused_scatter_dot {label}: "
                  f"raised {err!r}")
        # the gather takes block ids in any order
        shuffled = blk[torch.randperm(nslab, device=device)]
        gargs = (table, local, shuffled, rb, eb)
        rows["sorted_gather"].append(compare_stream(
            "sorted_gather", label, lambda: ss.sorted_gather(*gargs),
            lambda: ss.sorted_gather_reference(*gargs), exact=True))
    row_sorted_scatter_cases(device, rows)


def row_sorted_scatter_cases(device, rows) -> None:
    """``sorted_scatter`` and ``fused_place_scatter`` through their
    row-segmented kernels on row-sorted streams
    (``sorted_adversarial_stream``: unvisited blocks, a tenth of the edges
    padding, an all-padding slab inside the hub row's run, values scaled
    by 1/degree), slots drawn per edge, so they interleave within a row:
    k 8, 4, 1 and 2, values contiguous (16-byte loads) or cut from wider
    rows at an odd offset (4-byte loads), an odd width, lines wider than
    one warp's 512 columns; the last has a hub row of more than 20,000
    edges, is timed, and its longest row is held to a float64 sum."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    rng = np.random.default_rng(5)
    # (edges, row block, edge block, blocks, hub, L, k, value width,
    # strided)
    for label, (n_edges, rb, eb, n_blocks, hub, L, k, d, strided) in {
            "rows_16x8_k8": (200, 16, 8, 10, 300, 128, 8, 16, False),
            "rows_64x40_k4_strided": (600, 64, 40, 20, 400, 96, 4, 21,
                                      True),
            "rows_512x256_k1_strided": (3000, 512, 256, 14, 1500, 256, 1,
                                        200, True),
            "rows_64x40_k2_wide": (900, 64, 40, 12, 500, 640, 2, 320,
                                   False),
            "rows_hub_k8": (30_000, 512, 256, 14, 23_000, 128, 8, 16,
                            False)}.items():
        local_np, blk_np, scale = sorted_adversarial_stream(
            rng, n_edges, rb, eb, n_blocks, hub)
        E, out_rows = local_np.size, (n_blocks + 1) * rb - 37
        local = torch.as_tensor(local_np, device=device)
        blk = torch.as_tensor(blk_np, device=device)
        sc = torch.as_tensor(scale, device=device)[:, None]
        wide = torch.as_tensor(rng.standard_normal((E, d + 4)),
                               dtype=torch.float32, device=device) * sc
        V = wide[:, 1:1 + d] if strided else wide[:, :d].contiguous()
        place = torch.as_tensor(rng.integers(0, k, E), dtype=torch.int32,
                                device=device)
        norm = torch.as_tensor(rng.random(E), dtype=torch.float32,
                               device=device)
        msgs = torch.as_tensor(rng.standard_normal((E, L)),
                               dtype=torch.float32, device=device) * sc
        hrows = edge_rows(local, blk, rb, out_rows)
        real = int((hrows < out_rows).sum())
        degree = torch.bincount(hrows[hrows < out_rows], minlength=out_rows)
        timed = label == "rows_hub_k8"
        shape = {"E_pad": E, "slabs": local_np.shape[0],
                 "out_rows": out_rows, "L": L, "k": k, "Lv": d,
                 "strided": strided, "real_edges": real,
                 "longest_row": int(degree.max())}
        if timed:
            check(shape["longest_row"] >= 20_000,
                  f"{label}: the hub row is shorter than 20,000 edges")

        def index_add(lines):
            return lambda: torch.zeros(out_rows + 1, L, device=device) \
                .index_add_(0, hrows, lines)

        lines = ss.expand_sub(V * norm[:, None], place, k, L)
        for name, kernel, plain, terms, work in (
                ("sorted_scatter",
                 lambda: ss.sorted_scatter(msgs, local, blk, out_rows, rb,
                                           eb, rows_sorted=True),
                 lambda: ss.sorted_scatter_reference(msgs, local, blk,
                                                     out_rows, rb, eb),
                 msgs, scatter_work(real, L, L, local, blk, out_rows, L)),
                ("fused_place_scatter",
                 lambda: ss.fused_place_scatter(
                     V, place, norm, local, blk, out_rows, k, L, rb, eb,
                     rows_sorted=True),
                 lambda: ss.fused_place_scatter_reference(
                     V, place, norm, local, blk, out_rows, k, L, rb, eb),
                 lines, scatter_work(real, d + 2, 2 * d, local, blk,
                                     out_rows, L))):
            row = compare_stream(name, label, kernel, plain,
                                 index_add(terms) if timed else None,
                                 work if timed else None, shape=shape)
            row["longest_row_rel_err"] = longest_row_check(
                name, label, kernel, hrows, degree, (terms,))
            rows[name].append(row)
        del lines, msgs, wide


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


def attention_case(gen, N, L, d, device, mask="ragged"):
    """q (scaled), k, v as the text encoder hands them over (k and v
    slices of one fused (N, L, 3d) bf16 tensor), a key mask and a
    cotangent. ``mask``: ``ragged`` (a random length per sequence, with a
    length-1 sequence and an all-padding one), ``holes`` (the same with
    about a third of each sequence's keys knocked out at random, so whole
    key tiles inside a sequence may be padding) or ``all`` (every key
    valid)."""
    import torch
    qkv = torch.randn(N, L, 3 * d, generator=gen, device=device,
                      dtype=torch.bfloat16)
    q = qkv[..., :d] * torch.tensor(d ** -0.5, dtype=torch.bfloat16)
    if mask == "all":
        valid = torch.ones(N, L, dtype=torch.bool, device=device)
    else:
        lengths = torch.randint(1, L + 1, (N,), generator=gen, device=device)
        lengths[0] = 1
        lengths[1] = 0
        valid = torch.arange(L, device=device)[None, :] < lengths[:, None]
        if mask == "holes":
            keep = torch.rand(N, L, generator=gen, device=device) < 0.67
            keep[0, 0] = True
            # a few sequences whose first key tile is all padding
            keep[2::7, :min(L, 64)] = False
            valid = valid & keep
    do = torch.randn(N, L, d, generator=gen, device=device,
                     dtype=torch.bfloat16)
    return q, qkv[..., d:2 * d], qkv[..., 2 * d:], valid, do


def ptxas_report(name: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel of
    ``csrc/<name>.cu``, from the ``ptxas -v`` log its build kept."""
    import re
    from mrgcn_tpu_torch.ops import _build
    report, entry = {}, None
    for line in _build.load(name).ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            plain = re.search(r"([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                              m.group(1))
            args = re.findall(r"L[ib](\d+)E", plain.group(2) or "") \
                if plain else []
            entry = m.group(1) if plain is None else plain.group(1) + (
                f"<{', '.join(args)}>" if args else "")
            report[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[entry].update(stack_bytes=int(m.group(1)),
                                 spill_store_bytes=int(m.group(2)),
                                 spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            report[entry].update(registers=int(m.group(1)),
                                 static_smem_bytes=int(smem.group(1))
                                 if smem else 0)
    return report


def mlp_case(gen, M, d, hd, device):
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    return (rnd(M, d), rnd(d, hd, scale=d ** -0.5), rnd(hd, scale=0.5),
            rnd(hd, d, scale=hd ** -0.5), rnd(d, scale=0.5), rnd(M, d))


def cublas_chain(x, w1, b1, w2, b2, do=None):
    """The unfused bf16 chain on the same inputs: ``F.linear`` (cuBLAS),
    ``F.gelu(approximate="tanh")``, ``F.linear``; with ``do`` also its
    autograd backward. Timed only, used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    def chain(x, w1, b1, w2, b2):
        return F.linear(F.gelu(F.linear(x, w1.t(), b1), approximate="tanh"),
                        w2.t(), b2)
    if do is None:
        return lambda: chain(x, w1, b1, w2, b2)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, w1, b1, w2, b2)]

    def both():
        return torch.autograd.grad(chain(*leaves), leaves, do)
    return both


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
               "max_err_over_bound": max(r for _, r in errs),
               "digest": digest(outs)}
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

    for source in ("fused_attention", "fused_mlp"):
        for kernel_name, used in ptxas_report(source).items():
            print(f"[kernel] {source}.cu {kernel_name}: {json.dumps(used)}")
    # a hung kernel shows no launch error and never lets a synchronize
    # return: a timer that does not wait for the stream ends the process
    # (with every thread's traceback) if the attention cases take 400 s
    faulthandler.dump_traceback_later(400, exit=True)
    # the new cases draw from a generator of their own, so the cases before
    # them and the MLP cases after keep their numbers
    gen_masks = torch.Generator(device=device).manual_seed(1)
    for label, (N, L, d), timed, mask in (
            ("slice", (8000, 128, 128), True, "ragged"),
            ("adversarial_13x37", (13, 37, 128), False, "ragged"),
            ("adversarial_9x1", (9, 1, 128), False, "ragged"),
            ("adversarial_5x128x64", (5, 128, 64), False, "ragged"),
            ("adversarial_7x300", (7, 300, 128), False, "ragged"),
            ("adversarial_3x512", (3, 512, 128), False, "ragged"),
            ("long_2000x512", (2000, 512, 128), True, "ragged"),
            ("slice_all_valid", (8000, 128, 128), True, "all"),
            ("slice_holes", (8000, 128, 128), False, "holes"),
            ("adversarial_holes_300x512x8", (300, 512, 8), False, "holes")):
        q, k, v, valid, do = attention_case(
            gen if mask == "ragged" else gen_masks, N, L, d, device, mask)
        scales = attention_scales(q, k, v, valid, do)
        # operations on the real keys only: each of the L query rows meets
        # sum(len) keys; forward 2 products, backward 5. Bytes likewise: k
        # and v rows at the real keys only (a sequence without one needs
        # all L: its softmax is uniform), every q and do row, every row of
        # every output (zeros at padding keys' dk and dv are written too)
        real = valid.sum(dim=1)
        pairs = float(real.sum()) * L * d
        kv_rows = int(torch.where(real > 0, real, torch.full_like(real, L))
                      .sum())
        qkv_bytes = (N * L + 2 * kv_rows) * d * 2 + valid.numel()
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
        if mask != "all":
            out = att.attention_fwd(q, k, v, valid)
            v1 = v[1].float()
            check_bf16(out[1], v1.mean(0, keepdim=True).expand(L, d),
                       v1.abs().mean(0, keepdim=True).expand(L, d),
                       f"attention {label}: the all-padding sequence (a "
                       "uniform average of v)")
            del out
        torch.cuda.synchronize()
        del q, k, v, valid, do, scales
    faulthandler.cancel_dump_traceback_later()
    # the same for the MLP cases, 300 s
    faulthandler.dump_traceback_later(300, exit=True)
    # new cases come after the old ones, so these keep their inputs: one
    # row; one past a 128-row dx tile and a 64-row weight-gradient segment
    # (129: three segments); one past a 192-row forward tile (193); one
    # past 15 segments of 128 rows and past a forward and a dx tile (1921,
    # on 132 SMs); a single hidden chunk; d = 48 (TMA fills columns 48..127
    # with zeros); and the rows a multimodal mini-batch of 512 labels gives
    # the text MLP (MINIBATCH_TEXT_ROWS, checked in the minibatch phase)
    for label, (M, d, hd), timed in (
            ("slice", (1_024_000, 128, 512), True),
            ("adversarial_1000", (1000, 128, 512), False),
            ("adversarial_37x16x64", (37, 16, 64), False),
            ("adversarial_1", (1, 128, 512), False),
            ("adversarial_129", (129, 128, 512), False),
            ("adversarial_193", (193, 128, 512), False),
            ("adversarial_1921", (1921, 128, 512), False),
            ("adversarial_1000x128x64", (1000, 128, 64), False),
            ("adversarial_1000x48x192", (1000, 48, 192), False),
            ("minibatch", (MINIBATCH_TEXT_ROWS, 128, 512), True)):
        x, w1, b1, w2, b2, do = mlp_case(gen, M, d, hd, device)
        scales = mlp_scales(x, w1, b1, w2, b2, do)
        # two products forward; five backward (the hidden activations
        # again, dh, dx, dW1, dW2); no single PyTorch call computes
        # either: the yardstick is the bf16 cuBLAS chain, three calls
        weights = nbytes(w1, b1, w2, b2)
        compare("mlp_fwd", label, lambda: fm.mlp_fwd(x, w1, b1, w2, b2),
                lambda: fm.mlp_fwd_reference(x, w1, b1, w2, b2),
                scales[:1], timed,
                cublas_chain(x, w1, b1, w2, b2) if timed else None,
                (2 * nbytes(x) + weights, 4.0 * M * d * hd))
        compare("mlp_bwd", label, lambda: fm.mlp_bwd(x, w1, b1, w2, do),
                lambda: fm.mlp_bwd_reference(x, w1, b1, w2, do),
                scales[1:], timed,
                cublas_chain(x, w1, b1, w2, b2, do) if timed else None,
                (3 * nbytes(x) + 2 * weights, 10.0 * M * d * hd))
        if timed:
            fwd, bwd = rows["mlp_fwd"][-1], rows["mlp_bwd"][-1]
            bwd["library_fwd_bwd_ms"] = bwd["library_ms"]
            bwd["library_ms"] = bwd["library_ms"] - fwd["library_ms"]
            print(f"[kernel] mlp_bwd {label}: cuBLAS chain's backward alone "
                  f"{bwd['library_ms']:.3f} ms")
            # each launch of the two wrappers by device time
            profile_steps(f"mlp_fwd {label}, launches",
                          lambda: fm.mlp_fwd(x, w1, b1, w2, b2), 5, top=5)
            profile_steps(f"mlp_bwd {label}, launches",
                          lambda: fm.mlp_bwd(x, w1, b1, w2, do), 5, top=5)
        del x, w1, b1, w2, b2, do, scales
    faulthandler.cancel_dump_traceback_later()
    torch.cuda.empty_cache()
    return rows


def toml_value(v) -> str:
    """``v`` as a TOML value: a dict as an inline table, anything else as
    JSON (a string, number, bool or list of them reads the same)."""
    if isinstance(v, dict):
        return "{ " + ", ".join(f"{k} = {toml_value(x)}"
                                for k, x in v.items()) + " }"
    return json.dumps(v)


def conv_inputs(gen, rows: int, kind: str, shape):
    """Inputs of a convolutional encoder: geometries as standard normals,
    images as standard normals of their own contrast and brightness each
    (as photographs differ; identical statistics would leave the deep
    BatchNorms nearly constant inputs)."""
    import torch
    x = torch.randn((rows, *shape), generator=gen)
    if kind == "image":
        x = x * (0.2 + 2.8 * torch.rand((rows, 1, 1, 1), generator=gen)) \
            + torch.randn((rows, shape[0], 1, 1), generator=gen)
    return x


def conv_encoder_phase(device) -> None:
    """The convolutional encoders (no hand-written kernel: cuDNN's and
    PyTorch's convolutions, f32 without TF32 for ``TCNN``, checked; bf16
    for ``ImageCNN``'s body): ``TCNN`` S / M / L, each at its minimal
    length, and ``ImageCNN`` (``sep``, ``dense``) on ``CONV_IMAGE_SIDE``
    images, ``CONV_ROWS`` rows each, on the card against the same weights
    and running statistics on the CPU. In train mode (batch statistics),
    ``TCNN`` and ``ImageCNN`` with an f32 body (its ``dtype``): outputs
    (max error over the CPU's largest), the parameter gradients (error
    norm over the norm, all of them as one vector) and each updated
    running statistic (error norm over its norm; a mean's over the larger
    of its norm and its standard deviations') within
    ``ENCODER_RTOL["tcnn"]``; where a ReLU input within rounding of zero
    falls on the other side (the pre-ReLU signs that differ are counted
    and printed), the gradients within 1e-2. The bf16 body
    in eval mode, running statistics drawn away from 0 / 1: within
    ``ENCODER_RTOL["image"]`` (under batch statistics a bf16 body drifts
    by bf16 steps between any two implementations,
    ``tests/test_torch_conv_encoders.py``). Each timed on the card as the
    model runs it (train mode, bf16 image body), forward and backward, by
    CUDA events; ``TCNN`` S and the ``sep`` ``ImageCNN`` also at the
    ``dmg_synth_allmodal`` path's shapes (10,000 geometries of 64 points;
    2,000 images of 224 x 224), with the bytes their forward keeps for
    the backward and the peak of one forward and backward."""
    import copy
    import torch
    from mrgcn_tpu_torch.models import encoders as enc
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for f32 convolutions or matmuls")
    gen = torch.Generator().manual_seed(0)
    side = CONV_IMAGE_SIDE
    cases = [(f"tcnn_{size}", "tcnn", (9, enc.TCNN_MINIMAL_LENGTH[size]),
              lambda size=size, dtype=None: enc.TCNN(9, 16, gen, size=size),
              (9, 64) if size == "S" else None) for size in "SML"]
    cases += [(f"image_{impl}", "image", (3, side, side),
               lambda impl=impl, dtype=torch.bfloat16: enc.ImageCNN(
                   128, gen, p_dropout=0.0, block_impl=impl, dtype=dtype),
               (3, IMAGE_SIDE, IMAGE_SIDE) if impl == "sep" else None)
              for impl in ("sep", "dense")]

    def compare(cpu, x, cot, train):
        """Card against CPU: output error, the error norms by name and
        the pre-ReLU signs that differ."""
        gpu = copy.deepcopy(cpu).to(device)
        found = []
        for model in (gpu, cpu):
            dev = next(model.parameters()).device
            signs = []
            hooks = [m.register_forward_hook(
                lambda _m, _i, o: signs.append((o > 0).cpu()))
                for m in model.modules() if isinstance(m, enc.BatchNorm)]
            model.zero_grad()
            out = model(x.to(dev), train=train)
            out.backward(cot.to(dev))
            for h in hooks:
                h.remove()
            found.append(({"output": out.detach().float().cpu(),
                           **{n: p.grad.float().cpu()
                              for n, p in model.named_parameters()},
                           **{n: b.float().cpu()
                              for n, b in model.named_buffers()}}, signs))
        (got, got_signs), (want, want_signs) = found
        flips = sum(int((a != b).sum())
                    for a, b in zip(got_signs, want_signs))
        out = want.pop("output")
        out_err = float((got.pop("output") - out).abs().max()) \
            / max(float(out.abs().max()), 1e-30)
        check(bool(torch.isfinite(torch.cat(
            [t.reshape(-1) for t in got.values()])).all()),
            "non-finite gradients or statistics on the card")

        def scale(name, w):
            norm = float(torch.linalg.vector_norm(w))
            if name.endswith(".mean"):
                var = want[name[:-len("mean")] + "var"]
                norm = max(norm, float(torch.linalg.vector_norm(var.sqrt())))
            return max(norm, 1e-30)

        buffers = {n for n, _ in cpu.named_buffers()}
        stats = {n: float(torch.linalg.vector_norm(got[n] - w)) / scale(n, w)
                 for n, w in want.items() if n in buffers}
        grads = [n for n in want if n not in buffers]
        # the gradients as one vector: a convolution's bias ahead of
        # BatchNorm has gradient 0 in exact arithmetic (the batch mean
        # subtracts it), so alone its error would be all noise
        grad_err = math.sqrt(sum(float(torch.linalg.vector_norm(
            got[n] - want[n])) ** 2 for n in grads) / max(sum(
                float(torch.linalg.vector_norm(want[n])) ** 2
                for n in grads), 1e-60))
        return gpu, out_err, grad_err, stats, flips

    for label, kind, shape, make, path_shape in cases:
        x = conv_inputs(gen, CONV_ROWS, kind, shape)
        cpu = make() if kind == "tcnn" else make(dtype=torch.float32)
        out_dim = cpu.Dense_1.kernel.shape[1]
        cot = torch.randn((CONV_ROWS, out_dim), generator=gen)
        row = {"label": label, "rows": CONV_ROWS, "shape": list(shape)}
        checks = [("train_f32", cpu, True, ENCODER_RTOL["tcnn"])]
        if kind == "image":
            bf16 = make()
            with torch.no_grad():
                for m in bf16.modules():
                    if isinstance(m, enc.BatchNorm):
                        m.mean.normal_(0.0, 0.1, generator=gen)
                        m.var.uniform_(0.5, 2.0, generator=gen)
            checks.append(("eval_bf16", bf16, False, ENCODER_RTOL["image"]))
        for mode, model, train, (out_bound, bound) in checks:
            gpu, out_err, grad_err, stats, flips = compare(model, x, cot,
                                                           train)
            worst = max(stats, key=stats.get)
            grad_bound = max(bound, 1e-2) if flips else bound
            row[mode] = {"output_rel_err": out_err,
                         "gradient_rel_norm_err": grad_err,
                         "statistics_worst": worst,
                         "statistics_rel_norm_err": stats[worst],
                         "relu_sign_flips": flips,
                         "bounds": [out_bound, grad_bound, bound]}
            check(out_err <= out_bound and grad_err <= grad_bound
                  and stats[worst] <= bound,
                  f"encoder {label} {mode}: card and CPU differ "
                  f"{json.dumps(row[mode])}")
        del gpu
        gpu = (make() if kind == "tcnn" else bf16).to(device)

        def step(model=gpu, x=x.to(device), cot=cot.to(device)):
            model(x, train=True).backward(cot)

        row["fwd_bwd_ms"] = time_ms(step)
        if path_shape is not None:
            rows = ALLMODAL_GEOMETRIES if kind == "tcnn" else ALLMODAL_IMAGES
            xp = conv_inputs(torch.Generator().manual_seed(1), rows, kind,
                             path_shape).to(device)
            cp = torch.randn((rows, out_dim), device=device)
            row["path_shape"] = [rows, *path_shape]
            row["path_fwd_bwd_ms"] = time_ms(lambda: step(gpu, xp, cp))
            # what the forward keeps for the backward, and the peak of one
            # forward and backward, beyond the inputs and weights
            gpu.zero_grad(set_to_none=False)
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = gpu(xp, train=True)
            row["path_saved_bytes"] = torch.cuda.memory_allocated() - base
            out.backward(cp)
            del out
            row["path_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            del xp, cp
        print(f"[encoder] {json.dumps(row)}")
        del gpu
        torch.cuda.empty_cache()


def conv_algorithm_probe(measured: bool) -> None:
    """``TCNN`` S's forward and backward at the ``dmg_synth_allmodal``
    path's shape (10,000 geometries of 64 points, f32) with cuDNN's
    heuristic choice of algorithms (``measured`` false) or its measured
    one (``cudnn.benchmark``, which the port sets): the first call (the
    measuring included) and the median of the timed calls after it, in
    milliseconds by CUDA events, and the peak beyond inputs and weights
    of the first call and of the calls after it. Run in a process of its
    own: cuDNN keeps a chosen algorithm for the process."""
    import torch
    from mrgcn_tpu_torch.models import encoders as enc
    from mrgcn_tpu_torch.utils.device import pin_float32_precision
    pin_float32_precision()
    torch.backends.cudnn.benchmark = measured
    device = torch.device("cuda", 0)
    x = conv_inputs(torch.Generator().manual_seed(1), ALLMODAL_GEOMETRIES,
                    "tcnn", (9, 64)).to(device)
    cot = torch.randn((ALLMODAL_GEOMETRIES, 16), device=device)
    model = enc.TCNN(9, 16, torch.Generator().manual_seed(0),
                     size="S").to(device)

    def step():
        model(x, train=True).backward(cot)

    base = torch.cuda.memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    step()
    end.record()
    end.synchronize()
    first_ms = start.elapsed_time(end)
    first_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(step)
    print(json.dumps({"cudnn.benchmark": measured,
                      "shape": list(x.shape), "first_call_ms": first_ms,
                      "first_call_peak_bytes": first_peak, "ms": ms,
                      "peak_bytes": torch.cuda.max_memory_allocated()
                      - base}))


def conv_algorithm_phase() -> None:
    """``conv_algorithm_probe`` with cuDNN's heuristic choice and with its
    measured one, each in a fresh process (``--only conv_algorithms``,
    not part of the default run)."""
    for measured in (False, True):
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.conv_algorithm_probe({measured})"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0,
              f"conv_algorithm_probe({measured}): {proc.stderr[-2000:]}")
        print(f"[encoder] tcnn_S algorithms {proc.stdout.strip()}")


def graph_lines(graph) -> list:
    """A ``[graph]`` section's lines: ``graph``'s file paths, then its
    ``structural`` entries under ``[graph.structural]`` (what ``mkdataset``
    reads)."""
    graph = dict(graph)
    structural = graph.pop("structural", {})
    lines = ["", "[graph]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in graph.items()]
    lines += ["", "[graph.structural]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in structural.items()]
    return lines


def write_config(path: Path, epochs: int, num_bases: int, hidden: int,
                 features=(), task=None, backbones: bool = False,
                 graph=None, text_model=None) -> None:
    """``configs/dmg.toml``'s model section; of its features, the
    datatypes in ``features`` are included as DMG configures them (the
    string and image features without their pretrained ``model`` key and
    the string's ``tokenizer``: the from-scratch text and image encoders,
    whatever backbone a machine caches; with ``backbones`` with them, so
    the pretrained backbones run where their files are found), all others
    excluded. ``task`` adds ``[task]`` entries to the full-batch default
    (``batchsize``, ``neighbor_fanout``, ``neighbor_fanout_rounds``);
    ``graph`` adds a ``[graph]`` section (``graph_lines``); ``text_model``
    ``(name, pad token)`` names another model and tokenizer in the string
    feature's specs, and its pad token."""
    with open(ROOT / "configs" / "dmg.toml", "rb") as f:
        dmg = tomllib.load(f)
    model = dict(dmg["model"], epoch=epochs, num_bases=num_bases)
    layers = model.pop("layers")
    task = {"type": "node classification", "seed": 0, "batchsize": -1,
            **(task or {})}
    lines = ['name = "DMG_SYNTH"', "", "[task]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in task.items()]
    lines += ["", "[model]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in model.items()]
    for layer in layers:
        lines += ["", "[[model.layers]]"]
        lines += [f"{k} = {json.dumps(hidden if k == 'hidden_nodes' else v)}"
                  for k, v in layer.items()]
    if graph:
        lines += graph_lines(graph)
    for feature in dmg["graph"]["features"]:
        if text_model and "tokenizer" in feature:
            name, pad_token = text_model
            feature = dict(feature, model=[*feature["model"][:-1], name],
                           tokenizer={"config": [
                               *feature["tokenizer"]["config"][:-1], name],
                               "pad_token": pad_token})
        lines += ["", "[[graph.features]]"]
        if feature["datatype"] in features:
            lines += [f"{k} = {toml_value(v)}" for k, v in feature.items()
                      if backbones or k not in ("model", "tokenizer")]
        else:
            lines += [f"datatype = {json.dumps(feature['datatype'])}",
                      "include = false"]
    path.write_text("\n".join(lines) + "\n")


def train_via_cli(tmp: Path, tag: str, work, epochs, num_bases,
                  platform=None, F=None, task=None, graph=None,
                  features=MULTIMODAL, extra=(), backbones=False,
                  text_model=None):
    """``run.run_cli`` on ``work``'s graph; with ``F`` (literal features,
    or a function that draws them, called only where the artifact is not
    yet written) the config includes the ``features`` datatypes. The
    config is ``<tag>.toml`` (``task``: extra ``[task]`` entries), the
    artifact ``<graph or tag>.npz``, so runs on one graph share its file;
    ``platform`` sets ``MRGCN_PLATFORM`` for the run alone; ``extra``
    adds CLI arguments (the checkpoint flags); ``backbones`` keeps the
    features' pretrained ``model`` specs, ``text_model`` renames the
    string feature's (``write_config``)."""
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
    art = tmp / f"{graph or tag}.npz"
    cfg = tmp / f"{tag}.toml"
    if not art.exists():
        save_nc_artifact(str(art), work["n"], work["R"], work["src"],
                         work["dst"], work["rel"], work["norm"],
                         work["labels_idx"], work["labels_cls"],
                         work["num_classes"], seed=0,
                         num_eval=min(1000, work["n"] // 20),
                         F=F() if callable(F) else F)
    if not cfg.exists():
        write_config(cfg, epochs, num_bases, work["hidden"],
                     features=features if F else (), task=task,
                     backbones=backbones, text_model=text_model)
    os.environ.pop("MRGCN_PLATFORM", None)
    if platform is not None:
        os.environ["MRGCN_PLATFORM"] = platform
    try:
        return run.run_cli(["-c", str(cfg), "-i", str(art), "-o",
                            str(tmp) + os.sep, "--dry_run", "--test",
                            *extra])
    finally:
        os.environ.pop("MRGCN_PLATFORM", None)


def by_route(launches: dict, name: str) -> dict:
    """A scatter's launches by kernel: its row-segmented one and the
    other route (#1's block walk, #5's split walk; #3 has none)."""
    rows = launches[f"{name}.rows"]
    return {ROW_KERNELS[name][0]: rows,
            **({ROW_KERNELS[name][1]: launches[name] - rows}
               if ROW_KERNELS[name][1] else {})}


def start_path() -> dict:
    """The kernel counters with every launch count set to 0, and the
    card's peak-memory reading started afresh, what an earlier path left
    in reference cycles collected first (a mini-batch run's model: 262 MB
    that showed in the next path's peak)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    reset_launches(counters)
    return counters


def dense_routes(work, art: Path, x_width: int, epochs: int = EPOCHS
                 ) -> dict:
    """``{(scatter, kernel): launches}`` of the dense half of layer 0 in
    ``epochs`` training steps (its ``fwd`` and ``bwd_h`` streams) and the
    test split's forward, read from the planner: layer 0 restricted to the
    frontier of the NC run's own labels (train and valid merged, as
    ``--test`` merges them; then the test split's), at ``x_width``. A
    relation-constant stream goes through ``fused_place_scatter``, any
    other through ``sorted_scatter``, each on its row-segmented kernel
    where the planner marks the stream ``rows_sorted``."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.data import artifact as artifact_io
    Y = {k: np.asarray(v).reshape(-1, 2)
         for k, v in artifact_io.load(str(art)).Y.items()}
    counts = {}
    for labels, streams, times in (
            (np.concatenate([Y["train"], Y["valid"]])[:, 0],
             ("fwd", "bwd_h"), epochs),
            (Y["test"][:, 0], ("fwd",), 1)):
        _, dense = nc_layer0_plans(work, torch.device("cpu"), labels,
                                   x_width)
        for name in streams:
            key = stream_route(getattr(dense, name), False)
            counts[key] = counts.get(key, 0) + times
    return counts


def slice_phase(work, tmp: Path, tag: str, kernels, F=None,
                features=MULTIMODAL, backbones=False, absent=(),
                inspect=None, epochs: int = EPOCHS, text_model=None) -> dict:
    """Train ``epochs`` NC epochs through the CLI with every launch count
    set to 0 just before and read just after; ``kernels`` names each
    kernel the path runs with its least launch count per epoch. With
    ``F``, the config includes ``features``. The identity layer's compose
    launches exactly ``COMPOSE_PER_STEP`` of each compose kernel a
    training step, and ``compose_table`` once more for the test split's
    evaluation. The scatters' launches by route, each count exact: the
    identity half's row-sorted ``fwd`` (each forward, the test split's
    too) and ``bwd_table`` (each step) on ``fused_place_scatter``'s
    row-segmented kernel; with features, the dense half's streams on the
    routes the planner gives them (``dense_routes``). Over the image and
    WKT features, every BatchNorm's running statistics must be finite and
    moved from their 0 / 1 init. With ``backbones`` the string and image
    features keep their pretrained ``model`` specs (``text_model``: see
    ``write_config``); each kernel named in ``absent`` must launch no
    time; ``inspect(res)`` adds checks of the trained model and returns
    entries for the summary."""
    import torch
    counters = start_path()
    t0 = time.perf_counter()
    res = train_via_cli(tmp, tag, work, epochs, work["num_bases"], F=F,
                        features=features, backbones=backbones,
                        text_model=text_model)
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    for name, per_step in COMPOSE_PER_STEP.items():
        want = per_step * (epochs + (name == "compose_table"))
        check(launches[name] == want,
              f"{tag}: {name} launched {launches[name]} times, not {want}")
    scatters = ("fused_place_scatter", "sorted_scatter")
    want = {(name, kernel): 0 for name in scatters
            for kernel in ROW_KERNELS[name]}
    want["fused_place_scatter", ROW_KERNELS["fused_place_scatter"][0]] = \
        2 * epochs + 1
    if F is not None:
        for key, n in dense_routes(work, tmp / f"{tag}.npz",
                                   multimodal_width(features),
                                   epochs).items():
            want[key] += n
    got = {(name, kernel): n for name in scatters
           for kernel, n in by_route(launches, name).items()}
    check(got == want, f"{tag}: scatters launched {got}; want {want}")

    losses = [h["train_loss"] for h in res.history]
    check(len(losses) == epochs, f"{tag}: trained {len(losses)} epochs")
    check(all(math.isfinite(x) for x in losses + [res.loss]),
          f"{tag}: non-finite loss: {losses}, test {res.loss}")
    devices = {t.device.type for t in res.model.state_dict().values()}
    check(devices == {"cuda"}, f"{tag}: parameters and buffers on {devices}")
    check(all(bool(torch.isfinite(t).all())
              for t in res.model.state_dict().values()),
          f"{tag}: non-finite parameters or buffers")
    check(res.model.featureless == (F is None),
          f"{tag}: featureless is {res.model.featureless}")
    stats = {k: t for k, t in res.model.state_dict().items()
             if ".BatchNorm_" in k and k.endswith((".mean", ".var"))}
    check(bool(stats) == (F is not None and bool(
        {"blob.image", "ogc.wktLiteral"} & set(features))),
          f"{tag}: {len(stats)} BatchNorm statistics")
    for k, t in stats.items():
        init = 0.0 if k.endswith(".mean") else 1.0
        check(bool((t != init).any()), f"{tag}: {k} never moved")
    for name, per_epoch in kernels.items():
        check(launches[name] >= per_epoch * epochs,
              f"{tag}: {name} launched {launches[name]} times in "
              f"{epochs} epochs")
    for name in absent:
        check(launches[name] == 0, f"{tag}: {name} launched "
              f"{launches[name]} times")
    extra = inspect(res) if inspect else {}
    secs = [h["seconds"] for h in res.history]
    summary = {"path": tag, "epochs": epochs, "train_loss": losses,
               "test_loss": res.loss, "test_acc": res.acc,
               "first_epoch_s": secs[0], "epoch_s_after_first": secs[1:],
               "epoch_s_median_after_first": statistics.median(secs[1:]),
               "peak_mem_bytes": peak, "cli_wall_s": wall,
               "launches": launches,
               "scatter_routes": {f"{n}.{k}": c for (n, k), c in got.items()},
               **({"batchnorm_statistics": len(stats)} if stats else {}),
               **extra}
    print(f"[slice] {json.dumps(summary)}")
    return summary


def minibatch_phase(work, tmp: Path, F) -> dict:
    """Mini-batch training through the CLI at DMG width, each run with the
    launch counts set to 0 just before and read just after: featureless NC
    with ``batchsize = 32`` (``configs/dmg_reference.toml``), 2 epochs; the
    same with ``neighbor_fanout = 10`` and two sampled rounds; the
    multimodal model with ``batchsize = 512``, 1 epoch (the encoder kernels
    run on each batch's outer-hop rows). Then node-sliced link prediction
    at FB15k-237's width with ``configs/fb15k-237.toml``'s own
    ``gcn_batchsize = 32``, ``test_batchsize = 500``: one whole epoch
    (every batch's 2-hop neighbourhood is the whole graph), the ranking of
    the training batches and the sliced ranking of the test split."""
    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.models.encoders import TextBlock
    out = {}
    for tag, graph, task, epochs, feats in (
            ("mb_nc", "dmg_synth", {"batchsize": 32}, 2, None),
            ("mb_nc_fanout", "dmg_synth",
             {"batchsize": 32, "neighbor_fanout": 10,
              "neighbor_fanout_rounds": 2}, 2, None),
            ("mb_nc_multimodal", "dmg_synth_multimodal",
             {"batchsize": 512}, 1, F)):
        # the rows each text block takes (sequences x tokens), recorded
        # before its forward
        text_rows = []

        def record(module, args):
            if isinstance(module, TextBlock):
                text_rows.append(args[0].shape[0] * args[0].shape[1])
        hook = register_module_forward_pre_hook(record) \
            if feats is not None else None
        counters = start_path()
        t0 = time.perf_counter()
        res = train_via_cli(tmp, tag, work, epochs, work["num_bases"],
                            F=feats, task=task, graph=graph)
        wall = time.perf_counter() - t0
        if hook is not None:
            hook.remove()
            check(max(text_rows) == MINIBATCH_TEXT_ROWS,
                  f"{tag}: the text MLP took at most {max(text_rows)} rows, "
                  f"not MINIBATCH_TEXT_ROWS = {MINIBATCH_TEXT_ROWS}")
            print(f"[minibatch] {tag}: text MLP rows a call "
                  f"{json.dumps(sorted(set(text_rows)))}, "
                  f"{len(text_rows)} calls")
        launches = read_launches(counters)
        losses = [h["train_loss"] for h in res.history]
        check(len(losses) == epochs, f"{tag}: trained {len(losses)} epochs")
        check(all(math.isfinite(x) for x in losses + [res.loss]),
              f"{tag}: non-finite loss: {losses}, test {res.loss}")
        check(epochs == 1 or losses[-1] < losses[0],
              f"{tag}: the loss did not fall: {losses}")
        # --test merges the validation labels into the training split
        check(res.batches["train"] >= -(-len(work["labels_idx"])
                                        // task["batchsize"]),
              f"{tag}: {res.batches} batches")
        check({p.device.type for p in res.model.parameters()} == {"cuda"},
              f"{tag}: parameters not on the card")
        # no planned stream of a batch is relation-constant or unsorted
        check(launches["fused_place_scatter"]
              == launches["fused_place_scatter.rows"]
              and launches["sorted_scatter"]
              == launches["sorted_scatter.rows"],
              f"{tag}: a scatter took its other route: {launches}")
        # every batch composes the identity table and differentiates it
        for name in (*COMPOSE_PER_STEP, *(ENCODER_KERNELS if feats
                                          is not None else ())):
            check(launches[name] >= res.batches["train"] * epochs,
                  f"{tag}: {name} launched {launches[name]} times")
        out[tag] = {
            "path": tag, "task": task, "epochs": epochs,
            "train_loss": losses, "test_loss": res.loss,
            "test_acc": res.acc, "batches": res.batches,
            "epoch_s": [h["seconds"] for h in res.history],
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "cli_wall_s": wall, "launches": launches}
        print(f"[minibatch] {json.dumps(out[tag])}")
        del res
        torch.cuda.empty_cache()

    # node-sliced link prediction: the toml's own batches, one epoch with
    # the train ranking, then the sliced test ranking. Depth cut to one
    # R-GCN layer: a slice's two-hop neighbourhood is most of the graph,
    # whose host build took 79-108 s of the run; the agreement phase runs
    # the two-layer node-sliced path card against CPU
    cfg = tmp / "lp_sliced.toml"
    write_lp_config(cfg, 1, LP_HIDDEN, 1, full_graph=False,
                    layers=LP_SLICED_LAYERS)
    sizes = run.load_config(str(cfg))["task"]
    counters = start_path()
    t0 = time.perf_counter()
    res = run.run_cli(["-c", str(cfg), "-i", str(tmp / "lp.npz"), "-o",
                       str(tmp) + os.sep, "--dry_run", "--test"])
    wall = time.perf_counter() - t0
    h, = res.history
    check(math.isfinite(h["loss"]) and 0.0 < h["loss"] < 2.0,
          f"lp_sliced: loss {h['loss']}")
    check({p.device.type for p in res.model.parameters()} == {"cuda"},
          "lp_sliced: parameters not on the card")
    check(all(bool(torch.isfinite(p).all())
              for p in res.model.parameters()),
          "lp_sliced: a parameter is not finite")
    # a slice of 32 nodes, its triples in subsets of about 500
    check(res.batches["train"] >= 14_541 // 32
          and res.batches["test"] >= 14_541 // 64,
          f"lp_sliced: {res.batches} batches")
    for kind in ("raw", "flt"):
        ranks = res.ranks[kind]
        # a triple is ranked in its head's slice and in its tail's;
        # candidates are a batch's own nodes, far fewer than the graph's
        check(len(ranks) >= 2 * 20_466 and min(ranks) >= 1
              and max(ranks) <= 2048, f"lp_sliced: {kind} ranks out of "
              f"range ({min(ranks)} to {max(ranks)})")
        check(0.0 < res.mrr[kind] <= 1.0,
              f"lp_sliced: {kind} MRR {res.mrr[kind]}")
    launches = read_launches(counters)
    # a node slice's layers take the unplanned paths: any scatter launched
    # there is on its row-segmented kernel
    check(launches["fused_place_scatter"]
          == launches["fused_place_scatter.rows"]
          and launches["sorted_scatter"] == launches["sorted_scatter.rows"],
          f"lp_sliced: a scatter took its other route: {launches}")
    out["lp_sliced"] = {
        "path": "lp_sliced", "epochs": 1, "layers": LP_SLICED_LAYERS,
        "gcn_batchsize": sizes["gcn_batchsize"],
        "test_batchsize": sizes["test_batchsize"], "batches": res.batches,
        "loss": h["loss"], "epoch_s": h["seconds"],
        "ms_per_batch": h["seconds"] / res.batches["train"] * 1e3,
        "train_eval_s": h["eval_seconds"], "train_mrr_raw": h["train_mrr"],
        "test_s": res.test_seconds, "test_mrr": res.mrr,
        "test_hits_at_1_3_10": res.hits,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "cli_wall_s": wall, "launches": launches}
    print(f"[minibatch] {json.dumps(out['lp_sliced'])}")
    del res
    torch.cuda.empty_cache()
    return out


def write_lp_config(path: Path, epochs: int, hidden: int, eval_interval: int,
                    name: str = "FB15K237_SYNTH", full_graph: bool = True,
                    layers: int = 2, graph=None) -> None:
    """``configs/fb15k-237.toml``'s model section (2 bases, lr 0.01) with
    ``layers`` ``hidden``-wide R-GCN layers, the config's two unless the
    depth is cut (the link-prediction task reads all but the last
    ``[[model.layers]]`` entry, so the file gets one more), on the full
    graph (``gcn_batchsize`` and ``test_batchsize`` -1) or, with
    ``full_graph`` off, in the file's own node-sliced batches (32, 500);
    ``graph`` adds a ``[graph]`` section (``graph_lines``)."""
    with open(ROOT / "configs" / "fb15k-237.toml", "rb") as f:
        fb = tomllib.load(f)
    model = dict(fb["model"], epoch=epochs)
    layer = dict(model.pop("layers")[0], hidden_nodes=hidden)
    task = dict(fb["task"], seed=0, eval_interval=eval_interval)
    if full_graph:
        task.update(gcn_batchsize=-1, test_batchsize=-1)
    stop = task.pop("early_stopping")
    lines = [f"name = {json.dumps(name)}", "", "[task]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in task.items()]
    lines += [f"early_stopping.{k} = {json.dumps(v)}"
              for k, v in stop.items()]
    lines += ["", "[model]"]
    lines += [f"{k} = {json.dumps(v)}" for k, v in model.items()]
    for entry in [layer] * layers + [{"type": layer["type"]}]:
        lines += ["", "[[model.layers]]"]
        lines += [f"{k} = {json.dumps(v)}" for k, v in entry.items()]
    if graph:
        lines += graph_lines(graph)
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
                           plan.n_out_rows, f.row_block, f.edge_block,
                           rows_sorted=f.rows_sorted)
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
    counters = start_path()
    t0 = time.perf_counter()
    res = run.run_cli(["-c", str(cfg), "-i", str(tmp / "lp.npz"), "-o",
                       str(tmp) + os.sep, "--dry_run", "--test"])
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()

    # no entry point differentiates sorted_scatter through autograd, so
    # only this check launches sorted_gather: its launches are no path's
    reset_launches(counters)
    errs = basis_gradient_check(plan, num_relations, device)
    check_launches = {name: n for name, n in read_launches(counters).items()
                      if n}
    check(check_launches.get("sorted_gather", 0) >= 1
          and check_launches.get("sorted_scatter.rows", 0) >= 1
          and check_launches.get("fused_scatter_dot.rows", 0) >= 2,
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
    # per training step: layer 0's fused_place_scatter forward and one
    # fused_scatter_dot per basis backward, layer 1's (dense_basis)
    # fused_place_scatter forward and one sorted_scatter of 512-lane lines
    # backward, every one the row-segmented kernel (the planner marks
    # the streams rows_sorted); each evaluation (train, valid, the final
    # test: one graph slice each) adds the two forwards
    evals = 1 + sum((h["train_mrr"] is not None)
                    + (h["valid_mrr"] is not None) for h in res.history)
    want = lp_planned_launches(tmp / "lp.npz", cfg, LP_EPOCHS, evals)
    rows_of = {name: ROW_KERNELS[name][0] for name in ROW_KERNELS}
    check(routed(launches) == want
          and want == {
              ("fused_place_scatter", rows_of["fused_place_scatter"]):
              2 * (LP_EPOCHS + evals),
              ("fused_scatter_dot", rows_of["fused_scatter_dot"]):
              2 * LP_EPOCHS,
              ("sorted_scatter", rows_of["sorted_scatter"]): LP_EPOCHS},
          f"lp: launches {routed(launches)}; the planner's {want} "
          f"({evals} evaluations)")
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


def routed(launches: dict) -> dict:
    """``{(name, kernel): n}`` of the launches that are not 0: the compose
    kernels by name, the scatters by route (``by_route``)."""
    got = {}
    for name in ("compose_table", "compose_grad_pass"):
        if launches[name]:
            got[name, None] = launches[name]
    for name in ("fused_place_scatter", "sorted_scatter",
                 "fused_scatter_dot"):
        for kernel, n in by_route(launches, name).items():
            if n:
                got[name, kernel] = n
    return got


def wide_kernel_cases(plan, dense_plan, device, rows) -> None:
    """The kernels on the wide-line engine's streams, each against its
    plain version, timed beside the library call with its bound, its
    longest row held to a float64 sum: ``sorted_scatter`` on LP's
    dst-sorted ``bwd_h`` stream with the engine's wide messages (2 planes
    of 256 lanes, the layers' B = 2; 4 planes, ``MAX_BASIS_STREAMS``),
    norm-scaled as the engine scales them, against ``index_add_``; and
    ``fused_place_scatter`` on the ``1:1`` dense plan's ``fwd`` stream
    (layer 1 on ``dense_basis``: out 200 in 256 lanes) against expand +
    ``index_add_``. A sum over many edges is held to ``ATOL + RTOL``
    times the sum of its terms' absolute values (``compare_stream``)."""
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    from mrgcn_tpu_torch.ops.relational import line_width
    gen = torch.Generator(device=device).manual_seed(6)
    d, L1 = LP_HIDDEN, line_width(1, LP_HIDDEN)
    for name, stream, out_rows in (
            ("sorted_scatter", plan.bwd_h, plan.n_in_rows),
            ("fused_place_scatter", dense_plan.fwd, dense_plan.n_out_rows)):
        check(stream.rows_sorted and not stream.rel_const,
              f"wide_basis: the planner did not mark the {name} stream "
              "rows_sorted")
        local, blk, rb, eb = stream.scatter_local, stream.scatter_blk, \
            stream.row_block, stream.edge_block
        hrows = edge_rows(local, blk, rb, out_rows)
        real = int((hrows < out_rows).sum())
        degree = torch.bincount(hrows[hrows < out_rows],
                                minlength=out_rows)
        for B in ((2, 4) if name == "sorted_scatter" else (1,)):
            L = B * L1
            label = (f"lp_bwd_h_wide_{L}" if name == "sorted_scatter"
                     else "lp_dense_fwd")
            shape = {**stream_shape(stream, out_rows, L), "rows_sorted":
                     True, "real_edges": real,
                     "longest_row": int(degree.max())}
            E = stream.num_padded_edges
            if name == "sorted_scatter":
                terms = torch.randn(E, L, generator=gen, device=device) \
                    * stream.norm[:, None]
                args = (terms, local, blk, out_rows, rb, eb)

                def kernel(args=args):
                    return ss.sorted_scatter(*args, rows_sorted=True)

                def plain(args=args):
                    return ss.sorted_scatter_reference(*args)

                work = scatter_work(real, L, L, local, blk, out_rows, L)
            else:
                V = torch.randn(E, d, generator=gen, device=device)
                args = (V, stream.out_mod, stream.norm, local, blk,
                        out_rows, 1, L, rb, eb)
                terms = ss.expand_sub(V * stream.norm[:, None],
                                      stream.out_mod, 1, L)
                shape.update(Lv=d, k=1)

                def kernel(args=args):
                    return ss.fused_place_scatter(*args, rows_sorted=True)

                def plain(args=args):
                    return ss.fused_place_scatter_reference(*args)

                work = scatter_work(real, d + 2, 2 * d, local, blk,
                                    out_rows, L)
            sums = torch.zeros(out_rows + 1, L, device=device).index_add_(
                0, hrows, terms.abs())[:out_rows]
            row = compare_stream(
                name, label, kernel, plain,
                lambda t=terms: torch.zeros(out_rows + 1, L, device=device)
                .index_add_(0, hrows, t), work, shape=shape, scales=[sums])
            row["longest_row_rel_err"] = longest_row_check(
                name, label, kernel, hrows, degree, (terms,))
            rows[name].append(row)
            print(f"[kernel] {name} {label}: {row['ms']:.3f} ms, plain "
                  f"{row['plain_ms']:.3f} ms, index_add_ "
                  f"{row['library_ms']:.3f} ms; bound {row['bound_ms']:.3f}"
                  f" ms ({row['bound_by']})")
            del terms, sums, args
            torch.cuda.empty_cache()


def dense_vs_grouped(edges, num_relations: int, device, smi: str) -> dict:
    """LP's layer 1 at full width on the card: ``dense_basis``, the route
    the layer takes, against the relation-grouped layer it replaces
    (``rspmm.transform_aggregate_grouped``) on the same inputs: a
    ReLU-like ``H`` (nodes x 200), 2 bases, the graph's coefficients
    drawn at random, a random cotangent. The output and the gradients of
    ``H``, the bases and the coefficients within 1e-4 of their largest
    entry; forward and backward of each timed by CUDA events (grouped,
    dense, dense, grouped), with the peak bytes each allocates above its
    inputs."""
    import torch
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.ops import rspmm
    d, B = LP_HIDDEN, 2
    plan = edges.plan_for(d, d)
    check(plan is not None and plan.kind == "dense" and plan.k_in == 1
          and not plan.fwd.rel_const and edges.grouped,
          "wide_basis: LP's layer 1 has no dense plan without "
          "relation-constant slabs, or no relation groups")
    gen = torch.Generator(device=device).manual_seed(7)
    n = edges.num_out
    H = torch.relu(torch.randn(n, d, generator=gen, device=device)) \
        .requires_grad_()
    basis = (torch.randn(B, d, d, generator=gen, device=device)
             * d ** -0.5).requires_grad_()
    comp = torch.randn(num_relations, B, generator=gen, device=device) \
        .requires_grad_()
    cot = torch.randn(n, d, generator=gen, device=device)
    routes = {
        "dense_basis": lambda: rl.dense_basis(H, basis, comp, plan, d, d),
        "grouped": lambda: rspmm.transform_aggregate_grouped(
            H, edges.grp_src, edges.grp_dst, edges.grp_norm,
            edges.group_rel, edges.group_size, edges.num_out, basis,
            comp=comp)}

    def step(fn):
        out = fn()
        return [out.detach()] + list(torch.autograd.grad(
            out, (H, basis, comp), cot))

    got, want = step(routes["dense_basis"]), step(routes["grouped"])
    errs = {}
    for label, g, w in zip(("out", "d_H", "d_basis", "d_comp"), got, want):
        check(bool(torch.isfinite(g).all()),
              f"wide_basis: dense_basis' {label} is not finite")
        errs[label] = float((g - w).abs().max() / w.abs().max())
    del got, want
    peaks = {}
    for name, fn in routes.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(fn)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    times = timed_pair(lambda: step(routes["dense_basis"]),
                       lambda: step(routes["grouped"]))
    summary = {"shape": {"nodes": n, "edges": int(edges.src.shape[0]),
                         "relations": num_relations, "in": d, "out": d,
                         "bases": B, "group_size": edges.group_size},
               "rel_err": errs, "dense_basis_ms": times["ms_runs"],
               "grouped_ms": times["plain_ms_runs"],
               "peak_bytes_above_inputs": peaks, "card": smi}
    print(f"[wide_basis] LP layer 1, dense_basis against the grouped "
          f"layer it replaces, forward and backward: "
          f"{json.dumps(summary)}")
    print(f"[wide_basis] dense_basis {times['ms']:.3f} ms, grouped "
          f"{times['plain_ms']:.3f} ms; peaks "
          f"{peaks['dense_basis'] / 2 ** 30:.2f} / "
          f"{peaks['grouped'] / 2 ** 30:.2f} GiB; error over the largest "
          f"entry {json.dumps(errs)} (bound 1e-4) ({smi})")
    check(max(errs.values()) <= 1e-4, "wide_basis: dense_basis differs "
          f"from the grouped layer ({errs})")
    return summary


def wide_basis_phase(tmp: Path, plan, device, smi: str, rows) -> dict:
    """The wide-line basis engine that LP's layer 1 runs (the ``lp`` phase
    drives it through the CLI and counts its launches), on LP's full
    graph as the task builds it: (a) ``dense_vs_grouped``; (b)
    ``wide_kernel_cases`` on layer 0's ``bwd_h`` stream (``plan``) and
    layer 1's dense ``fwd``."""
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    cfg = tmp / "lp_wide.toml"
    write_lp_config(cfg, 1, LP_HIDDEN, 1)
    inputs = prepare_inputs(run.artifact_io.load(str(tmp / "lp.npz")),
                            run.load_config(str(cfg)), True, device)
    out = dense_vs_grouped(inputs.edges, inputs.num_relations, device, smi)
    wide_kernel_cases(plan, inputs.edges.plan_for(LP_HIDDEN, LP_HIDDEN),
                      device, rows)
    del inputs
    torch.cuda.empty_cache()
    return out


def profile_phase(work, tmp: Path, device, steps: int = 3) -> None:
    """Where a link-prediction training step's time goes
    (``--only profile``, not part of the default run): ``torch.profiler``
    over ``steps`` full-graph steps after three warm-up steps, device time
    by kernel name, and the card's busy share of the synchronised host
    time. Then the two route forks by device time per step, each in
    alternated windows (``route_fork_basis``); the featureless NC step's
    compose on its kernels and on the library (``compose_route_profile``)."""
    import numpy as np
    import torch
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

    profile_steps("LP step", step, steps)
    route_fork_basis(step, steps)
    del model, optimizer, batch, inputs
    torch.cuda.empty_cache()
    compose_route_profile(work, tmp, device, steps)


def route_fork_basis(step, steps: int) -> dict:
    """Fork (a): the basis layer's backward at ``k == 1`` through
    ``fused_scatter_dot`` (its row-segmented kernel, the layer's route)
    against ``fused_place_scatter`` plus a dot with the gathered table
    rows (the route of packed rows, ``_basis_grads_placed``), one LP step
    per call of ``step``. Device time per step in four windows, order A,
    B, B, A; each window's launches are checked to be its route's."""
    from mrgcn_tpu_torch.ops import relational as rl
    fused = rl._basis_grads_fused

    def placed(d_vh, w_h, h, packed, n_rows):
        return rl._basis_grads_placed(d_vh, w_h, h, packed, 1, n_rows,
                                      d_vh.shape[1])

    routes = {"fused_scatter_dot": fused, "place_scatter_dot": placed}
    order = ["fused_scatter_dot", "place_scatter_dot", "place_scatter_dot",
             "fused_scatter_dot"]
    busy = {name: [] for name in routes}
    try:
        for name in order:
            rl._basis_grads_fused = routes[name]
            counters = kernel_counters()
            reset_launches(counters)
            busy[name].append(profile_steps(
                f"LP step, basis backward via {name}", step, steps,
                top=6)[0])
            calls = 3 + 2 * steps     # profile_steps' warm-ups too
            rows_launched = counters["fused_scatter_dot"].launches_rows
            check(rows_launched == (2 * calls if name == "fused_scatter_dot"
                                    else 0),
                  f"fork (a) {name}: row-segmented kernel launched "
                  f"{rows_launched} times in {calls} steps")
    finally:
        rl._basis_grads_fused = fused
    result = {name: {"device_ms_per_step": v,
                     "median": statistics.median(v)}
              for name, v in busy.items()}
    print(f"[fork] basis backward (k == 1), device ms per LP step "
          f"(order {order}): {json.dumps(result)}")
    return result


def compose_route_profile(work, tmp: Path, device, steps: int) -> dict:
    """The featureless full-batch NC step (DMG width, the
    frontier-restricted layers), device time per step in alternated
    windows, each half of ``rspmm.compose_packed`` on its kernel
    (forward ``compose_table``, backward ``compose_grad_pass``) or on the
    library products the parent tree ran (``torch.tensordot``; two
    matmuls): both kernels, both library, and each kernel alone, in the
    order kernels, library, table, grads, grads, table, library, kernels.
    Each window's launches of the two kernels are checked to be its
    route's, and the kernels' device time a step and share of the step
    are printed."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.ops import rspmm
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
    art, cfg = tmp / "dmg_synth.npz", tmp / "profile_nc.toml"
    if not art.exists():
        save_nc_artifact(str(art), work["n"], work["R"], work["src"],
                         work["dst"], work["rel"], work["norm"],
                         work["labels_idx"], work["labels_cls"],
                         work["num_classes"], seed=0,
                         num_eval=min(1000, work["n"] // 20))
    write_config(cfg, 1, work["num_bases"], work["hidden"])
    config = run.load_config(str(cfg))
    artifact = run.artifact_io.load(str(art))
    inputs = prepare_inputs(artifact, config, True, device)
    model = nc.build_model(inputs, config, work["num_classes"],
                           torch.Generator().manual_seed(0))
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config, True)
    batch, = nc.make_batches(inputs, np.asarray(artifact.Y["train"])
                             .reshape(-1, 2), -1, 2)

    def step():
        nc.train_step(model, optimizer, batch, 0.0, 0.0)

    def library_table(comp, packed):
        return torch.tensordot(comp, packed, dims=([1], [0]))

    def library_grads(d_t, comp, packed):
        R, B = comp.shape
        d_flat = d_t.reshape(R, -1)
        return (d_flat @ packed.reshape(B, -1).T,
                (comp.T @ d_flat).reshape(packed.shape))

    table, grads = rspmm._table, rspmm._grads
    routes = {"kernels": (table, grads),
              "library": (library_table, library_grads),
              "table": (table, library_grads),
              "grads": (library_table, grads)}
    order = ["kernels", "library", "table", "grads", "grads", "table",
             "library", "kernels"]
    busy = {name: [] for name in routes}
    own = {name: [] for name in routes}
    try:
        for name in order:
            rspmm._table, rspmm._grads = routes[name]
            counters = kernel_counters()
            reset_launches(counters)
            ms, _, by_name = profile_steps(
                f"featureless NC step, compose route {name}", step, steps,
                top=8)
            check(by_name, f"compose route {name}: no split by kernel")
            busy[name].append(ms)
            calls = 3 + 2 * steps     # profile_steps' warm-ups too
            for kernel, on in (("compose_table", name in ("kernels",
                                                           "table")),
                               ("compose_grad_pass", name in ("kernels",
                                                              "grads"))):
                launched = counters[kernel].launches
                check(launched == (calls if on else 0),
                      f"compose route {name}: {kernel} launched "
                      f"{launched} times in {calls} steps")
            kernels_ms = sum(v for k, v in by_name.items()
                             if "compose_" in k or "sum_partials" in k)
            own[name].append({"kernels_ms": kernels_ms,
                              "share": kernels_ms / ms})
    finally:
        rspmm._table, rspmm._grads = table, grads
    result = {name: {"device_ms_per_step": v,
                     "median": statistics.median(v),
                     "compose_kernels": own[name]}
              for name, v in busy.items()}
    print(f"[route] compose, device ms per featureless NC step "
          f"(order {order}): {json.dumps(result)}")
    lib = result["library"]["median"]
    print(f"[route] each half against the library route's "
          f"{lib:.3f} ms a step: forward compose_table "
          f"{lib - result['table']['median']:+.3f} ms, backward "
          f"compose_grad_pass {lib - result['grads']['median']:+.3f} ms, "
          f"both {lib - result['kernels']['median']:+.3f} ms saved; the "
          f"two kernels take {result['kernels']['compose_kernels'][0]['share']:.1%}"
          " of the kernels route's step")
    return result


def profile_steps(label: str, step, steps: int, top: int = 25):
    """``torch.profiler`` over ``steps`` calls of ``step`` after three
    warm-up calls: host time per call, device time by kernel name (the
    ``top`` largest), and the card's busy share of the synchronised host
    time. Returns (device busy ms, host ms, device ms by kernel name) per
    call. The trace loses kernels at its start (one of five launches of a
    short kernel, or all of them), so the profiler's own warm-up cycle
    traces ``steps`` calls and drops them before the ``steps`` calls that
    are read. Where the trace still shows no device time, the device time
    a call is taken by CUDA events instead (it then includes the card's
    idle gaps) and the split by kernel is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):          # the warm-up cycle, then the one read
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            prof.step()

    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))

    # kernels only: an operator's device time repeats its kernels', and so
    # does a user annotation's device-side range (``Optimizer.step#...``)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.key.startswith("Optimizer.")),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3 / steps
    if busy_ms <= 0:
        busy_ms = time_ms(step)
        print(f"[profile] {label} {wall_ms:.3f} ms by host clock; the trace "
              f"shows no device time: {busy_ms:.3f} ms a call by CUDA "
              "events, no split by kernel")
        return busy_ms, wall_ms, {}
    by_name = {e.key: device_us(e) / 1e3 / steps for e in events
               if device_us(e) > 0}
    print(f"[profile] {label} {wall_ms:.3f} ms by host clock, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in events if device_us(e) > 0) // steps} "
          "kernels per step")
    for e in events[:top]:
        if device_us(e) > 0:
            print(f"[profile] {device_us(e) / 1e3 / steps:9.3f} ms/step  "
                  f"x{e.count / steps:5.1f}  {e.key[:90]}")
    return busy_ms, wall_ms, by_name


def profile_stream_phase(work, plan, device, steps: int = 20) -> None:
    """The scatters on every main-path stream, each on the route its layer
    takes (``--only profile_stream``, not part of the default run): device
    time a call by kernel (``torch.profiler``), without the host's work
    around the launches that the CUDA-event times of the stream phase
    include when the card waits for it."""
    import torch
    from mrgcn_tpu_torch.ops import sorted_stream as ss
    from mrgcn_tpu_torch.ops.relational import line_width
    ident, dense = nc_layer0_plans(work, device)
    gen = torch.Generator(device=device).manual_seed(0)
    for label, st, mod, out_rows, k, d in (
            ("fwd", ident.fwd, ident.fwd.out_mod, ident.n_out_rows,
             ident.k_out, work["hidden"]),
            ("dense_fwd", dense.fwd, dense.fwd.out_mod, dense.n_out_rows,
             dense.k_out, work["hidden"]),
            ("bwd_table", ident.bwd_table, ident.bwd_table.in_mod,
             work["R"] * ident.n_in_rows, ident.k_in, work["hidden"]),
            ("lp_fwd", plan.fwd, plan.fwd.out_mod, plan.n_out_rows, 1,
             LP_HIDDEN)):
        V = torch.randn(st.num_padded_edges, d, generator=gen, device=device)
        args = (V, mod, st.norm, st.scatter_local, st.scatter_blk, out_rows,
                k, line_width(k, d), st.row_block, st.edge_block)
        profile_steps(f"fused_place_scatter {label}",
                      lambda: ss.fused_place_scatter(
                          *args, rows_sorted=st.rows_sorted), steps, top=3)
        del V, args
    h = dense.bwd_h
    msgs = torch.randn(h.num_padded_edges, line_width(dense.k_in,
                                                      multimodal_width()),
                       generator=gen, device=device)
    profile_steps("sorted_scatter dense_bwd_h",
                  lambda: ss.sorted_scatter(
                      msgs, h.scatter_local, h.scatter_blk, dense.n_in_rows,
                      h.row_block, h.edge_block, rows_sorted=h.rows_sorted),
                  steps, top=3)
    del msgs
    dvn, w, table = lp_bwd_h_inputs(plan, device)
    h = plan.bwd_h
    profile_steps("fused_scatter_dot lp_bwd_h",
                  lambda: ss.fused_scatter_dot(
                      dvn, w, h.scatter_local, h.scatter_blk, table,
                      plan.n_in_rows, h.row_block, h.edge_block,
                      rows_sorted=True), steps, top=3)
    torch.cuda.empty_cache()


def profile_attention_phase(device, steps: int = 10) -> None:
    """Where the attention kernels' time goes (``--only profile_att``, not
    part of the default run): device time by kernel of one forward and
    one backward at the slice's shape (ragged masks and every key valid)
    and at N=2,000, L=512."""
    import torch
    from mrgcn_tpu_torch.ops import attention as att
    gen = torch.Generator(device=device).manual_seed(0)
    for label, (N, L, d), mask in (("slice", (8000, 128, 128), "ragged"),
                                   ("slice_all_valid", (8000, 128, 128),
                                    "all"),
                                   ("long_2000x512", (2000, 512, 128),
                                    "ragged")):
        q, k, v, valid, do = attention_case(gen, N, L, d, device, mask)
        walked = att.live_key_tiles(valid)
        print(f"[profile] attention {label}: {int(valid.sum())} of "
              f"{valid.numel()} keys valid, {int(walked.sum())} of "
              f"{walked.numel()} key tiles walked")

        def step():
            att.attention_fwd(q, k, v, valid)
            att.attention_bwd(q, k, v, valid, do)

        profile_steps(f"attention {label} forward + backward", step, steps)
        del q, k, v, valid, do


# device-time groups of an NC step, by kernel name: the hand-written
# kernels, then what cuDNN and PyTorch run for the convolutional encoders;
# each group takes the kernels whose names hold one of its words and none
# of its exceptions (third entry, where given)
PROFILE_GROUPS = (
    ("fused_mlp", ("mlp_", "sum_segments_kernel")),
    ("fused_attention", ("attention_",)),
    ("stream and compose kernels", ("place_rows_kernel", "fused_place_",
                                    "sorted_scatter_kernel", "compose_",
                                    "canonical_")),
    ("BatchNorm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
    ("pooling", ("pool", "adaptive_max")),
    ("convolution (cuDNN)", ("convolve", "conv_depthwise", "conv1d",
                             "conv2d", "fprop", "dgrad", "wgrad",
                             "implicit_gemm", "cudnn", "ToNhwc", "ToNchw",
                             "winograd")),
    # the f32 products of the text backbone and the heads (cuBLAS), and the
    # rest of the backbone's passes
    ("matrix products (cuBLAS)", ("gemm", "Gemm", "xmma"), ("implicit",)),
    ("softmax", ("softmax",)),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
)


def profile_multimodal_phase(work, tmp: Path, device, steps: int = 5,
                             features=MULTIMODAL,
                             backbones: bool = False) -> None:
    """Where a multimodal NC step's time goes (``--only profile_mm``;
    ``--only profile_allmodal``: the ``dmg_synth_allmodal`` features;
    ``--only profile_backbones``: the same on both pretrained backbones,
    whose files ``backbone_files`` wrote; none part of the default run):
    the DMG-width model full batch, ``torch.profiler`` over ``steps``
    training steps, and each ``PROFILE_GROUPS`` group's share of the
    device time (a kernel in the first group whose names it matches)."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                                 save_nc_artifact)
    from mrgcn_tpu_torch.tasks.synthetic import DISTILBERT_MULTILINGUAL
    tag = "profile_backbones" if backbones else "profile_allmodal" \
        if features == ALLMODAL else "profile_mm"
    art, cfg = tmp / f"{tag}.npz", tmp / f"{tag}.toml"
    vocab = DISTILBERT_MULTILINGUAL["vocab_size"] if backbones else 0
    save_nc_artifact(str(art), work["n"], work["R"], work["src"],
                     work["dst"], work["rel"], work["norm"],
                     work["labels_idx"], work["labels_cls"],
                     work["num_classes"], seed=0,
                     num_eval=min(1000, work["n"] // 20),
                     F=allmodal_features(work["n"], wordpiece_vocab=vocab)
                     if features == ALLMODAL
                     else multimodal_features(work["n"], seed=0))
    write_config(cfg, 1, work["num_bases"], work["hidden"],
                 features=features, backbones=backbones)
    config = run.load_config(str(cfg))
    artifact = run.artifact_io.load(str(art))
    inputs = prepare_inputs(artifact, config, False, device)
    model = nc.build_model(inputs, config, work["num_classes"],
                           torch.Generator().manual_seed(0))
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config, False)
    model.skip_encoders = tutils.dead_encoders(model)
    Y = np.concatenate([np.asarray(artifact.Y[k]).reshape(-1, 2)
                        for k in ("train", "valid") if k in artifact.Y])
    batch, = nc.make_batches(inputs, Y, -1, len(model.hidden_dims))

    def step():
        nc.train_step(model, optimizer, batch, 0.0, 0.0)

    # the peak of training steps after the first (whose convolutions
    # cuDNN measures, trying algorithms with large workspaces)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    print(f"[profile] {tag} peak of a training step after the first: "
          f"{torch.cuda.max_memory_allocated()} bytes")
    busy, wall, by_name = profile_steps(
        f"{tag} NC step (X_width {inputs.X_width})", step, steps, top=40)
    check(by_name, f"{tag}: no split by kernel")
    rest = dict(by_name)
    for what, names, *unless in PROFILE_GROUPS:
        mine = [k for k in rest if any(n in k for n in names)
                and not any(n in k for n in (unless[0] if unless else ()))]
        ms = sum(rest.pop(k) for k in mine)
        print(f"[profile] {what}: {ms:.3f} ms a step, {ms / busy:.1%} of "
              f"the device time, {len(mine)} kernel names")
    print(f"[profile] the rest (elementwise, copies, reductions, GEMMs): "
          f"{sum(rest.values()):.3f} ms a step, "
          f"{sum(rest.values()) / busy:.1%}")


def profile_minibatch_phase(work, tmp: Path, device, steps: int = 40) -> None:
    """Where a mini-batch NC epoch's time goes (``--only profile_mb``, not
    part of the default run): the DMG-width featureless model at
    ``batchsize = 32``; the host seconds to build and move ``steps``
    batches, then ``torch.profiler`` over one training step on each."""
    import itertools
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    from mrgcn_tpu_torch.tasks.synthetic import save_nc_artifact
    art, cfg = tmp / "dmg_synth.npz", tmp / "profile_mb.toml"
    if not art.exists():
        save_nc_artifact(str(art), work["n"], work["R"], work["src"],
                         work["dst"], work["rel"], work["norm"],
                         work["labels_idx"], work["labels_cls"],
                         work["num_classes"], seed=0, num_eval=1000)
    write_config(cfg, 1, work["num_bases"], work["hidden"],
                 task={"batchsize": 32})
    config = run.load_config(str(cfg))
    artifact = run.artifact_io.load(str(art))
    inputs = prepare_inputs(artifact, config, True, device)
    model = nc.build_model(inputs, config, work["num_classes"],
                           torch.Generator().manual_seed(0))
    optimizer = tutils.build_optimizer(model, config,
                                       inputs.optimizer_config, True)
    Y = np.asarray(artifact.Y["train"]).reshape(-1, 2)[:32 * steps]
    t0 = time.perf_counter()
    batches = nc.make_batches(inputs, Y, 32, 2)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    moved = sum(t.numel() * t.element_size() for b in batches
                for e in b.edges for t in vars(e).values()
                if isinstance(t, torch.Tensor))
    print(f"[profile] {len(batches)} mini-batches built and moved in "
          f"{build_s:.3f} s ({build_s / len(batches) * 1e3:.2f} ms each, "
          f"{moved / len(batches) / 1e3:.1f} kB of edge arrays each)")
    # the move alone, for a whole training split's edge arrays
    from mrgcn_tpu_torch.data import batching
    index = batching.EdgeIndex(inputs.structure)
    labelled = np.asarray(artifact.Y["train"]).reshape(-1, 2)[:, 0]
    t0 = time.perf_counter()
    payloads = [batching.sample_minibatch(
        index, np.unique(labelled[b:b + 32]), 2).layer_edges
        for b in range(0, len(labelled), 32)]
    sample_s = time.perf_counter() - t0
    moves = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        put = batching.device_put_batches(payloads, device)
        torch.cuda.synchronize()
        moves.append(time.perf_counter() - t0)
        del put
    print(f"[profile] {len(payloads)} mini-batches' edge arrays: sampled "
          f"on the host in {sample_s:.3f} s; moved to the card "
          f"(device_put_batches) in {json.dumps(moves)} s")
    del payloads

    cycle = itertools.cycle(batches)
    profile_steps("mini-batch NC step",
                  lambda: nc.train_step(model, optimizer, next(cycle), 0.0,
                                        0.0), steps)


def lp_agreement(tmp: Path, tag: str, steps: int, budget=None,
                 ranks: bool = False, sliced=None) -> None:
    """Link prediction on the graph ``<tag>.npz``, card (kernels) against
    CPU (plain versions), on the basis-stream path: ``steps`` training
    steps with the same corrupted triples on both sides (drawn on the
    CPU); every step's loss within 1e-4 relative and every parameter's
    gradient within 1e-4 of its largest entry. With ``ranks`` the losses
    must also fall and the test split's ranks be equal except where
    near-equal scores change order. ``budget`` lowers the composed-table
    budget so that a small graph takes the basis-stream path. ``sliced``
    (``gcn_batchsize``, ``test_batchsize``) takes node-sliced batches
    instead (the unplanned layers): step ``i`` trains on batch ``i``, and
    the ranking is over the sliced test batches. There, after both
    optimizers have stepped, the parameters' drift is printed and the
    card's take the CPU side's values again, so every step compares
    gradients from equal parameters, entry by entry. One exception is
    measured, not assumed: forward hooks keep what each layer hands its
    ReLU, and a step in which some such value lies on the other side of
    zero on the card than on the CPU (sums taken in another order, a value
    within rounding of zero) is printed with the count and the largest
    such value, must have all of them below 1e-5 of the layer's largest,
    and holds the gradients by norm (1e-2) instead."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.tasks import link_prediction as lp
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    sizes = sliced or (-1, -1)
    what = f"{tag} sliced {sliced}" if sliced else tag
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
            check(sliced or inputs.identity_basis,
                  f"{tag}: no basis-stream plans")
            model = lp.build_model(inputs, config,
                                   torch.Generator().manual_seed(0))
            sides.append((inputs, model, tutils.build_optimizer(
                model, config, inputs.optimizer_config, True)))
        batches = [lp.make_lp_batches(inputs, np.asarray(
            artifact.data["train"]), *sizes, 2) for inputs, _, _ in sides]
        check(len(batches[0]) >= (steps if sliced else 1),
              f"{what}: {len(batches[0])} train batches")
        corrupt = lp.make_corruptor(0.2)
        gen = torch.Generator().manual_seed(0)
        losses = ([], [])
        grad_err, norm_err = {}, {}
        relu_in = [{}, {}]
        if sliced:
            for seen, (_, model, _) in zip(relu_in, sides):
                for i, layer in enumerate(model.rgcn.layers()):
                    layer.register_forward_hook(
                        lambda _m, _a, out, seen=seen, i=i:
                        seen.__setitem__(i, out.detach().cpu()))
        for step in range(steps):
            train = [b[step if sliced else 0] for b in batches]
            drawn = corrupt(torch.as_tensor(train[1].data),
                            train[1].num_triples,
                            torch.as_tensor(train[1].corrupt_pool),
                            train[1].num_pool, gen)
            for side, (inputs, model, _) in enumerate(sides):
                losses[side].append(float(lp.loss_and_grads(
                    model, train[side],
                    *(t.to(inputs.device) for t in drawn))))
            # values on the other side of a ReLU's zero on the card
            crossed = 0
            for i, cpu_out in relu_in[1].items():
                other = (relu_in[0][i] > 0) != (cpu_out > 0)
                if bool(other.any()):
                    worst = float(cpu_out[other].abs().max()
                                  / cpu_out.abs().max())
                    crossed += int(other.sum())
                    print(f"[agree] {what} step {step}: {int(other.sum())} "
                          f"of {other.numel()} values entering layer {i}'s "
                          f"ReLU lie on the other side of zero on the card, "
                          f"the largest {worst:.3g} of the layer's largest")
                    check(worst <= 1e-5, f"{what}: a ReLU input of "
                          f"relative size {worst} changed side")
            for (name, p), q in zip(sides[0][1].named_parameters(),
                                    sides[1][1].parameters()):
                check(float(q.grad.abs().max()) > 0,
                      f"{tag}: {name} got no gradient")
                diff = p.grad.cpu() - q.grad
                if crossed:
                    err = float(torch.linalg.vector_norm(diff)
                                / torch.linalg.vector_norm(q.grad))
                    norm_err[name] = max(norm_err.get(name, 0.0), err)
                else:
                    err = float(diff.abs().max() / q.grad.abs().max())
                    grad_err[name] = max(grad_err.get(name, 0.0), err)
            for _, _, optimizer in sides:
                optimizer.step()
            if sliced:
                with torch.no_grad():
                    drift = 0.0
                    for p, q in zip(sides[0][1].parameters(),
                                    sides[1][1].parameters()):
                        drift = max(drift, float((p.cpu() - q).abs().max()
                                                 / q.abs().max()))
                        p.copy_(q)
                print(f"[agree] {what} step {step}: parameters after the "
                      f"optimizer step differ by at most {drift:.3g} of "
                      "their largest entry; the card takes the CPU's")
        err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(*losses))
        print(f"[agree] {what} losses cuda {losses[0]} cpu {losses[1]} "
              f"(max rel err {err:.3g}, bound 1e-4); gradients, error over "
              f"the largest entry: {json.dumps(grad_err)} (bound 1e-4)"
              + (f"; in steps where a ReLU input changed side, error "
                 f"norm over the gradient's norm: {json.dumps(norm_err)} "
                 "(bound 1e-2)" if norm_err else "")
              + f"; {time.perf_counter() - t0:.1f} s")
        check(err <= 1e-4, f"{tag}: cuda and cpu losses differ ({err})")
        check(max(grad_err.values(), default=0.0) <= 1e-4
              and max(norm_err.values(), default=0.0) <= 1e-2,
              f"{tag}: cuda and cpu gradients differ ({grad_err}, "
              f"{norm_err})")
        if not ranks:
            return
        # sliced steps train on different batches: their losses are not
        # one falling sequence
        check(sliced or losses[0][-1] < losses[0][0],
              f"{tag}: the loss did not fall: {losses[0]}")
        found = []
        for inputs, model, _ in sides:
            test = lp.make_lp_batches(inputs, np.asarray(
                artifact.data["test"]), *sizes, 2)
            found.append(lp.evaluate(test, model, -1, True)[2])
    finally:
        rl.COMPOSED_TABLE_MAX_ELEMS = kept
    for kind in ("raw", "flt"):
        a, b = (np.asarray(r[kind]) for r in found)
        differ = int((a != b).sum())
        print(f"[agree] {what} {kind} ranks: {differ} of {a.size} differ "
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
    max |CPU output|; each gradient's error norm relative to its norm.
    The key projection's bias of the text paths that have one (``plain``,
    ``xla``, ``flash``) is left out: it shifts every score of a row alike,
    which the softmax does not see, so its gradient is 0 in exact
    arithmetic and rounding noise on both sides."""
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.models.pretrained import (PretrainedImageEncoder,
                                                   PretrainedTextEncoder)
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    config = run.load_config(str(tmp / f"{tag}.toml"))
    artifact = run.artifact_io.load(str(tmp / f"{tag}.npz"))
    gpu_model.load_state_dict(cpu_model.state_dict())
    sides = [(m, prepare_inputs(artifact, config, False, device).features)
             for m in (gpu_model, cpu_model)
             for device in [next(m.parameters()).device]]
    for name, (datatype, args) in zip(cpu_model.names,
                                      cpu_model.modules_config):
        results = []
        for model, features in sides:
            encoder = getattr(model, name)
            encoder.zero_grad()
            out = encoder(model._prepare(datatype, args, features[name][0]))
            cot = torch.randn(out.shape, generator=torch.Generator()
                              .manual_seed(0)).to(out.device)
            out.backward(cot)
            results.append({"output": out.detach().cpu()} | {
                n: p.grad.detach().cpu()
                for n, p in encoder.named_parameters()
                if p.grad is not None and not n.endswith(".key.bias")})
        kind = {"xsd.string": "text", "xsd.anyURI": "text",
                "ogc.wktLiteral": "tcnn", "blob.image": "image"}.get(
                    datatype, "mlp")
        if isinstance(getattr(cpu_model, name), (PretrainedTextEncoder,
                                                 PretrainedImageEncoder)):
            kind = "backbone"
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
    featureless (rtol 1e-4), multimodal (rtol 1e-3: the text encoder's
    body is bf16 and the two sides round it at the same places but from
    f32 sums taken in other orders) and over all five modalities (rtol
    ``AGREE_ALLMODAL_RTOL``), every path's first epoch within 1e-4; for
    the models over features also each encoder on its own
    (``encoder_agreement``, the convolutional encoders in eval mode, with
    the CPU run's running statistics on both sides)."""
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    small = small_graph()
    F = multimodal_features(small["n"], seed=0, num_numeric=600,
                            num_years=300, num_strings=240, max_len=128)
    # and with geometries and images: all five modalities, the
    # convolutional encoders and their running statistics on both sides
    F_all = multimodal_features(small["n"], seed=0, num_numeric=600,
                                num_years=300, num_strings=240, max_len=128,
                                num_geometries=300, num_images=120,
                                image_size=IMAGE_SIDE)
    # small_mb: the featureless graph again in mini-batches of 32 labels
    # (10 a training epoch), whose layers take the unplanned paths
    for tag, graph, feats, rtol, task, features in (
            ("small", "small", None, 1e-4, None, ()),
            ("small_mb", "small", None, 1e-4, {"batchsize": 32}, ()),
            ("small_mm", "small_mm", F, 1e-3, None, MULTIMODAL),
            ("small_am", "small_am", F_all, AGREE_ALLMODAL_RTOL, None,
             ALLMODAL)):
        gpu = train_via_cli(tmp, tag, small, 3, 4, F=feats, task=task,
                            graph=graph, features=features)
        cpu = train_via_cli(tmp, tag, small, 3, 4, platform="cpu", F=feats,
                            task=task, graph=graph, features=features)
        a = [h["train_loss"] for h in gpu.history] + [gpu.loss]
        b = [h["train_loss"] for h in cpu.history] + [cpu.loss]
        err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
        print(f"[agree] {tag} losses cuda {a} cpu {b} "
              f"(max rel err {err:.3g}, bound {rtol})")
        check(err <= rtol, f"{tag}: cuda and cpu losses differ (rel {err})")
        # the first epoch's loss: one forward from equal parameters
        first = abs(a[0] - b[0]) / max(abs(b[0]), 1e-12)
        check(first <= 1e-4, f"{tag}: first losses differ (rel {first})")
        if feats is not None:
            encoder_agreement(tmp, tag, gpu.model, cpu.model)
    compose_agreement(small)


def compose_agreement(work) -> None:
    """The composed identity layer (``rspmm.compose_packed`` on a row slice
    of the parameter, then ``featureless_aggregate``) on the small graph's
    layer-0 plan, card (``compose_table``, ``fused_place_scatter``,
    ``compose_grad_pass``) against CPU (their plain versions), same inputs
    and cotangent: the output and both gradients within 1e-4 of their
    largest entry."""
    import torch
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.ops import rspmm
    gen = torch.Generator().manual_seed(4)
    R, B, hidden = work["R"], 4, work["hidden"]
    found = []
    for device in (torch.device("cuda", 0), torch.device("cpu")):
        ident, _ = nc_layer0_plans(work, device)
        if not found:
            L = rl.line_width(ident.k_in, hidden)
            comp = torch.randn(R, B, generator=gen)
            packed = torch.randn(B, ident.n_in_rows + 16, L, generator=gen)
            cot = torch.randn(ident.out_nodes, hidden, generator=gen)
        c = comp.to(device).requires_grad_()
        p = packed.to(device).requires_grad_()
        table = rspmm.compose_packed(c, p[:, :ident.n_in_rows])
        out = rl.featureless_aggregate(table.reshape(-1, L), ident, hidden)
        out.backward(cot.to(device))
        found.append([t.detach().cpu() for t in (out, c.grad, p.grad)])
    errs = {name: float((g - w).abs().max() / w.abs().max())
            for name, g, w in zip(("out", "d_comp", "d_packed"), *found)}
    print(f"[agree] composed identity layer card vs CPU, error over the "
          f"largest entry: {json.dumps(errs)} (bound 1e-4)")
    check(max(errs.values()) <= 1e-4,
          f"the composed identity layer differs on the card and the CPU "
          f"({errs})")


# ---------------------------------------------------------------------------
# the checkpoint phase: resumed runs, card <-> CPU files, the reference's
# formats, and the profiler
# ---------------------------------------------------------------------------

# image side of the small all-modality graph whose checkpoints go between
# the card and the CPU: the CPU side trains its f32 image body
CK_IMAGE_SIDE = 64
# the features of the reference-interop graph: an MLP and the TCNN, whose
# running statistics the reference's names carry
CK_REFERENCE_FEATURES = ("xsd.numeric", "ogc.wktLiteral")


def sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def restored_matches(model, optimizer, state) -> dict:
    """``model``'s parameters and running statistics and ``optimizer``'s
    Adam moments and steps against ``state`` (a checkpoint as
    ``load_checkpoint`` reads it), bit for bit, every tensor on the
    model's device."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch.tasks import utils as tutils
    from mrgcn_tpu_torch.tasks.jax_import import params_to_state_dict
    device = next(model.parameters()).device
    sd = model.state_dict()
    want = {**params_to_state_dict(state["params"]),
            **params_to_state_dict(state["batch_stats"])}
    check(sorted(want) == sorted(sd), "restore: the model's names are not "
          "the file's")
    for k, w in want.items():
        check(sd[k].device == device and torch.equal(sd[k].cpu(), w),
              f"restore: {k} is not the file's")
    adam = optimizer.adam
    check({t.device for st in adam.state.values() for k, t in st.items()
           if k != "step"} == {device}, "restore: Adam's moments are not on "
          "the model's device")
    arrays = 0

    def walk(got, stored, path):
        nonlocal arrays
        if isinstance(stored, dict):
            check(isinstance(got, dict) and sorted(got) == sorted(stored),
                  f"restore: the optimizer state differs at {path}")
            for k in stored:
                walk(got[k], stored[k], f"{path}/{k}")
            return
        check(got.dtype == stored.dtype and np.array_equal(got, stored),
              f"restore: {path} is not the file's")
        arrays += 1

    # the optimizer's state as it would be written: every exp_avg,
    # exp_avg_sq (max_exp_avg_sq) and the step count of each group
    walk(tutils.optax_opt_state(model, optimizer), state["opt_state"],
         "opt_state")
    steps = {float(st["step"]) for st in adam.state.values()}
    check(len(steps) == 1 and len(adam.state) == len(sd) - sum(
        1 for k in sd if ".BatchNorm_" in k and k.endswith((".mean", ".var"))),
        f"restore: steps {steps} over {len(adam.state)} parameters")
    return {"tensors": len(want), "optimizer_arrays": arrays,
            "step": steps.pop()}


@contextlib.contextmanager
def watch_run(counters, task):
    """Instrument one CLI run: the seconds of ``tasks/utils``'
    ``save_checkpoint`` (and the file's bytes), ``load_checkpoint`` and
    ``restore_checkpoint``; right after a restore, the model and optimizer
    against the file (``restored_matches``, its own seconds apart); and at
    each of ``task``'s training steps, the time and the launch counts so
    far. Yields the record."""
    from mrgcn_tpu_torch.tasks import utils as tutils
    rec = {"start": time.perf_counter(), "steps": [], "check_s": 0.0}
    save, load = tutils.save_checkpoint, tutils.load_checkpoint
    restore, step = tutils.restore_checkpoint, task.train_step

    def timed_save(path, *args):
        sync()
        t0 = time.perf_counter()
        save(path, *args)
        rec.update(save_s=time.perf_counter() - t0, file=path,
                   file_bytes=os.path.getsize(path))

    def timed_load(path):
        t0 = time.perf_counter()
        state = load(path)
        rec["read_s"] = time.perf_counter() - t0
        return state

    def checked_restore(model, optimizer, state):
        t0 = time.perf_counter()
        epoch = restore(model, optimizer, state)
        sync()
        rec["restore_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["restored"] = restored_matches(model, optimizer, state)
        rec["check_s"] = time.perf_counter() - t0
        return epoch

    def watched_step(*args, **kwargs):
        rec["steps"].append((time.perf_counter(), read_launches(counters)))
        return step(*args, **kwargs)

    tutils.save_checkpoint, tutils.load_checkpoint = timed_save, timed_load
    tutils.restore_checkpoint, task.train_step = checked_restore, \
        watched_step
    try:
        yield rec
    finally:
        tutils.save_checkpoint, tutils.load_checkpoint = save, load
        tutils.restore_checkpoint, task.train_step = restore, step


def launches_since(rec, launches: dict, step: int) -> dict:
    """The launches from the start of training step ``step`` (0-based) to
    the end of the run."""
    before = rec["steps"][step][1]
    return {k: n - before[k] for k, n in launches.items()}


def setup_seconds(rec) -> float:
    """From the run's start to its first training step, less the
    restore check's own time."""
    return rec["steps"][0][0] - rec["start"] - rec["check_s"]


def checkpoint_cost(rec) -> dict:
    return {k: rec[k] for k in ("file_bytes", "save_s", "read_s",
                                "restore_s", "restored") if k in rec}


def resume_allmodal(work, tmp: Path) -> dict:
    """(a) ``dmg_synth_allmodal`` at full width through the CLI: 2 epochs
    with ``--save_checkpoint``, 2 more with ``--load_checkpoint``, and 4
    unbroken. Right after the load the state is the file's, bit for bit;
    the resumed epochs 3-4 train within ``AGREE_ALLMODAL_RTOL`` of the
    unbroken run's and launch exactly its epochs 3-4's kernels."""
    from mrgcn_tpu_torch.tasks import node_classification as nc
    F = functools.partial(allmodal_features, work["n"])
    runs = {}
    for tag, epochs in (("save", 2), ("resume", 2), ("whole", 4)):
        extra = {"save": ["--save_checkpoint"],
                 "resume": ["--load_checkpoint",
                            runs.get("save", {}).get("file", "")],
                 "whole": []}[tag]
        counters = start_path()
        with watch_run(counters, nc) as rec:
            res = train_via_cli(tmp, f"ck_allmodal_{epochs}", work, epochs,
                                work["num_bases"], F=F,
                                graph="dmg_synth_allmodal",
                                features=ALLMODAL, extra=extra)
        rec["launches"] = read_launches(counters)
        rec["history"] = res.history
        rec["epoch"] = res.epoch
        check({p.device.type for p in res.model.parameters()} == {"cuda"},
              f"ck_allmodal_{tag}: parameters not on the card")
        runs[tag] = rec
        del res
    save, resume, whole = runs["save"], runs["resume"], runs["whole"]
    check("restored" in resume, "ck_allmodal: the resumed run did not load")
    check([h["epoch"] for h in resume["history"]] == [3, 4]
          and resume["epoch"] == 4, f"ck_allmodal: resumed epochs "
          f"{[h['epoch'] for h in resume['history']]}")
    got = [h["train_loss"] for h in resume["history"]]
    want = [h["train_loss"] for h in whole["history"][2:]]
    err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    print(f"[checkpoint] all-modality resumed epochs 3-4 losses {got}, "
          f"unbroken {want}: max rel err {err:.3g} "
          f"(bound {AGREE_ALLMODAL_RTOL})")
    check(err <= AGREE_ALLMODAL_RTOL, f"ck_allmodal: resumed losses differ "
          f"(rel {err})")
    resumed = launches_since(resume, resume["launches"], 0)
    unbroken = launches_since(whole, whole["launches"], 2)
    check(resumed == unbroken and any(resumed.values()),
          f"ck_allmodal: resumed launches {resumed}, the unbroken run's "
          f"epochs 3-4 {unbroken}")
    summary = {"path": "ck_allmodal", "resumed_losses": got,
               "unbroken_losses": want, "max_rel_err": err,
               "launches_epochs_3_4": resumed,
               "save": checkpoint_cost(save),
               "load": checkpoint_cost(resume),
               "setup_s": {tag: setup_seconds(r) for tag, r in runs.items()},
               "epoch_s": {tag: [h["seconds"] for h in r["history"]]
                           for tag, r in runs.items()}}
    print(f"[checkpoint] {json.dumps(summary)}")
    return {f"ck_allmodal_{tag}": {"launches": r["launches"]}
            for tag, r in runs.items()}


def resume_lp(tmp: Path) -> dict:
    """(b) Link prediction at FB15k-237 width, full graph: 20 epochs with
    ``--save_checkpoint``; the file loaded into a fresh model (0 epochs)
    ranks the test split as the saving run did (at most 2 % of the ranks
    different); a resumed run's TSV starts at epoch 21."""
    import numpy as np
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks import link_prediction as lpd
    args = ["-i", str(tmp / "lp.npz"), "-o", str(tmp) + os.sep, "--test"]
    runs, results = {}, {}
    for tag, epochs in (("save", 20), ("load", 0), ("resume", 1)):
        cfg = tmp / f"ck_lp_{epochs}.toml"
        write_lp_config(cfg, epochs, LP_HIDDEN, LP_EVAL_INTERVAL,
                        name=f"CK_LP_{tag.upper()}")
        extra = ["--dry_run", "--save_checkpoint"] if tag == "save" else \
            ["--load_checkpoint", runs["save"]["file"]] \
            + (["--dry_run"] if tag == "load" else [])
        counters = start_path()
        with watch_run(counters, lpd) as rec:
            results[tag] = run.run_cli(["-c", str(cfg), *args, *extra])
        rec["launches"] = read_launches(counters)
        runs[tag] = rec
    save, load, resume = (results[t] for t in ("save", "load", "resume"))
    check(load.epoch == 20 and not load.history,
          f"ck_lp: the loaded run trained {load.history}")
    same = {}
    for kind in ("raw", "flt"):
        a, b = np.asarray(save.ranks[kind]), np.asarray(load.ranks[kind])
        check(a.shape == b.shape and a.size, f"ck_lp: {kind} ranks")
        same[kind] = float(np.mean(a == b))
        check(same[kind] >= 0.98, f"ck_lp: {kind} ranks equal at "
              f"{same[kind]:.4f} only")
    tsv, = tmp.glob("CK_LP_RESUME*_acc.tsv")
    rows = [r.split("\t") for r in tsv.read_text().splitlines()]
    check(rows[1][0] == "21" and resume.history[0]["epoch"] == 21,
          f"ck_lp: the resumed TSV starts at epoch {rows[1][0]}")
    summary = {"path": "ck_lp", "ranks_equal": same,
               "test_mrr": {"saving run": save.mrr, "loaded": load.mrr},
               "save": checkpoint_cost(runs["save"]),
               "load": checkpoint_cost(runs["load"]),
               "setup_s": {t: setup_seconds(runs[t])
                           for t in ("save", "resume")},
               "loaded_test_ranking_s": load.test_seconds}
    print(f"[checkpoint] {json.dumps(summary)}")
    return {f"ck_lp_{tag}": {"launches": r["launches"]}
            for tag, r in runs.items()}


def small_graph():
    from benchmarks.torch_baseline import build_workload
    return build_workload(n=3000, num_props=6, num_edges=20_000,
                          num_labeled=300, seed=0)


def card_cpu_checkpoints(tmp: Path) -> None:
    """(c) The small all-modality graph with the image CNN's body in f32:
    a checkpoint the card writes resumes on the CPU and on the card, and
    one the CPU writes resumes on both; each pair's next epoch's loss
    within 1e-3 relative (the multimodal card-vs-CPU bound: the text
    encoder's body is bf16)."""
    import torch
    from mrgcn_tpu_torch.models import encoders as enc
    from mrgcn_tpu_torch.models import mrgcn as tmrgcn
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    small = small_graph()
    F = functools.partial(multimodal_features, small["n"], seed=0,
                          num_numeric=600, num_years=300, num_strings=240,
                          max_len=128, num_geometries=300, num_images=60,
                          image_size=CK_IMAGE_SIDE)
    image_cnn = tmrgcn.ImageCNN
    tmrgcn.ImageCNN = functools.partial(enc.ImageCNN, dtype=torch.float32)

    def one_epoch(platform, extra):
        counters = kernel_counters()
        with watch_run(counters, nc) as rec:
            res = train_via_cli(tmp, "ck_small_am", small, 1, 4, F=F,
                                platform=platform, features=ALLMODAL,
                                extra=extra)
        device = {p.device.type for p in res.model.parameters()}
        check(device == {platform or "cuda"},
              f"ck_small_am: parameters on {device} ({platform})")
        return rec, res

    try:
        out = {}
        for writer in (None, "cpu"):
            saved, _ = one_epoch(writer, ["--save_checkpoint"])
            losses = {}
            for reader in (None, "cpu"):
                rec, res = one_epoch(reader, ["--load_checkpoint",
                                              saved["file"]])
                check("restored" in rec and res.history[0]["epoch"] == 2,
                      f"ck_small_am: {reader} did not resume")
                losses[reader or "cuda"] = res.history[0]["train_loss"]
            err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
            out[writer or "cuda"] = {"next_epoch_losses": losses,
                                     "rel_err": err,
                                     "file": checkpoint_cost(saved)}
            check(err <= 1e-3, f"ck_small_am: written on {writer or 'cuda'}"
                  f", the next losses differ (rel {err})")
    finally:
        tmrgcn.ImageCNN = image_cnn
    print(f"[checkpoint] card <-> CPU, small all-modality graph (f32 image "
          f"body), written on each: {json.dumps(out)} (bound 1e-3)")


def reference_interop(tmp: Path) -> None:
    """(d) The reference's formats on a small graph with an MLP and the
    TCNN: a ``save_reference_tar`` dataset trains 2 epochs on the card
    with losses within 1e-4 relative of its ``.npz`` twin's; a
    reference-named ``torch.save`` state dict built on the CPU from the
    port's own parameters (running statistics moved) loads through
    ``--load_checkpoint`` with a fresh optimizer and the file's epoch, and
    the eval-mode logits of the test labels on the card equal the CPU
    model's within 1e-4 of their largest."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.data import artifact as artifact_io
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                                 save_nc_artifact,
                                                 save_reference_checkpoint,
                                                 save_reference_tar)
    small = small_graph()
    npz, tar = tmp / "ck_ref.npz", tmp / "ck_ref.tar"
    save_nc_artifact(str(npz), small["n"], small["R"], small["src"],
                     small["dst"], small["rel"], small["norm"],
                     small["labels_idx"], small["labels_cls"],
                     small["num_classes"], seed=0, num_eval=150,
                     F=multimodal_features(small["n"], seed=0,
                                           num_numeric=600, num_years=300,
                                           num_strings=240,
                                           num_geometries=300))
    art = artifact_io.load(str(npz))
    save_reference_tar(str(tar), art.structure, art.F, Y=art.Y,
                       sample_map=art.sample_map, class_map=art.class_map)
    losses = {}
    for epochs in (2, 0):
        write_config(tmp / f"ck_ref_{epochs}.toml", epochs, 4,
                     small["hidden"], features=CK_REFERENCE_FEATURES)
    args = ["-o", str(tmp) + os.sep, "--dry_run", "--test"]
    for path in (npz, tar):
        res = run.run_cli(["-c", str(tmp / "ck_ref_2.toml"), "-i", str(path),
                           *args])
        losses[path.suffix] = [h["train_loss"] for h in res.history] \
            + [res.loss]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[".tar"],
                                                  losses[".npz"]))
    print(f"[checkpoint] reference .tar vs its .npz twin, 2 epochs on the "
          f"card: losses {json.dumps(losses)}, max rel err {err:.3g} "
          f"(bound 1e-4)")
    check(err <= 1e-4, f"ck_ref: the .tar trains apart from its twin "
          f"(rel {err})")

    config = run.load_config(str(tmp / "ck_ref_0.toml"))
    Y_train = np.asarray(art.Y["train"]).reshape(-1, 2)
    Y_test = np.asarray(art.Y["test"]).reshape(-1, 2)
    C = len(art.class_map)
    cpu = torch.device("cpu")
    tin = prepare_inputs(art, config, False, cpu)
    model = nc.build_model(tin, config, C, torch.Generator().manual_seed(3))
    with torch.no_grad():       # the running statistics move off 0 / 1
        b = nc.make_batches(tin, Y_train, -1, 2)[0]
        model(b.edges, b.features, train=True)
    pt = tmp / "ck_reference.pt"
    save_reference_checkpoint(str(pt), model, epoch=7, loss=0.5)
    res = run.run_cli(["-c", str(tmp / "ck_ref_0.toml"), "-i", str(npz),
                       *args, "--load_checkpoint", str(pt)])
    check(res.epoch == 7 and not res.history
          and not res.optimizer.adam.state,
          f"ck_ref: epoch {res.epoch}, {len(res.optimizer.adam.state)} "
          f"Adam states after loading a reference checkpoint")
    logits = []
    for m in (model, res.model):
        device = next(m.parameters()).device
        b = nc.make_batches(prepare_inputs(art, config, False, device),
                            Y_test, -1, 2)[0]
        with torch.no_grad():
            logits.append(m(b.edges, b.features)[b.idx].cpu())
    got, want = logits[1], logits[0]
    err = float((got - want).abs().max() / want.abs().max())
    print(f"[checkpoint] reference torch.save checkpoint, eval-mode test "
          f"logits card vs CPU: err over the largest {err:.3g} (bound 1e-4)")
    check(err <= 1e-4, f"ck_ref: the loaded model's logits differ ({err})")


def profiled_run(work, tmp: Path) -> dict:
    """(e) Featureless NC at DMG width, 2 epochs through the CLI with
    ``MRGCN_PROFILE_DIR`` set, beside a run without it: a Chrome trace is
    written, and its CUDA kernel events name the path's hand-written
    kernels (#5's row walk, #4, #10) as often as their wrappers counted
    launches."""
    trace_dir = tmp / "trace"
    epochs = {}
    for profiled in (False, True):
        if profiled:
            os.environ["MRGCN_PROFILE_DIR"] = str(trace_dir)
        counters = start_path()
        try:
            res = train_via_cli(tmp, "ck_profile_2", work, 2,
                                work["num_bases"], graph="dmg_synth")
        finally:
            os.environ.pop("MRGCN_PROFILE_DIR", None)
        launches = read_launches(counters)
        epochs["profiled" if profiled else "plain"] = \
            [h["seconds"] for h in res.history]
        del res
    trace, = trace_dir.glob("trace_*.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events
               if str(e.get("cat", "")).lower() == "kernel"]
    traced = {name: sum(name in k for k in kernels) for name in (
        "place_rows_kernel", "compose_grad_kernel", "compose_table_kernel")}
    counted = {"place_rows_kernel": launches["fused_place_scatter.rows"]
               + launches["sorted_scatter.rows"],
               "compose_grad_kernel": launches["compose_grad_pass"],
               "compose_table_kernel": launches["compose_table"]}
    summary = {"path": "ck_profile", "trace_bytes": trace.stat().st_size,
               "trace_events": len(events), "kernel_events": len(kernels),
               "traced": traced, "counted": counted, "epoch_s": epochs}
    print(f"[checkpoint] {json.dumps(summary)}")
    check(traced == counted and all(counted.values()),
          f"ck_profile: the trace holds {traced}, the wrappers counted "
          f"{counted}")
    return {"ck_profile": {"launches": launches}}


def checkpoint_phase(work, tmp: Path) -> dict:
    """Checkpoints, the reference's formats and the profiler on the card:
    (a) to (e) above. Returns the full-width runs' launch counts, each
    counted from 0 just before its run."""
    with timed_part("checkpoint all-modality resume"):
        paths = resume_allmodal(work, tmp)
    with timed_part("checkpoint LP resume"):
        paths.update(resume_lp(tmp))
    with timed_part("checkpoint card <-> CPU"):
        card_cpu_checkpoints(tmp)
    with timed_part("checkpoint reference formats"):
        reference_interop(tmp)
    with timed_part("checkpoint profiler"):
        paths.update(profiled_run(work, tmp))
    return paths


# ---------------------------------------------------------------------------
# the text attention paths and #12 (multi-head attention)
# ---------------------------------------------------------------------------

# the from-scratch text encoder's attention paths other than its default
# (fused_core), each trained card against CPU: the two trees besides the
# default's (``flash`` runs ``xla``'s code and ``plain_fused`` the default's,
# which the CPU tests hold)
TEXT_ATTN_IMPLS = ("xla", "plain")
HEAD_COUNTS = (2, 4, 8)
# an encoder entry over its card-vs-CPU bound passes where the card lies
# no farther than this many times the bf16 CPU run's distance from a
# float64 witness (``heads_card_vs_cpu``): the two sides round in
# different places, a kernel fault moves the card far beyond it
WITNESS_MARGIN = 1.5
# #12's cases (sequences, tokens): the multimodal path's strings, and the
# tokenizer's longest sequences
HEAD_SHAPES = ((8000, 128), (2000, 512))
# the byte strings the multi-head encoder trains on: the multimodal path's
HEAD_PATH_STRINGS = 8000
# the plain versions' (N, H, L, L) f32 intermediates per chunk of sequences
PLAIN_CHUNK_BYTES = 2 << 30
# training steps of each multi-head TextEncoder on the card
HEAD_STEPS = 3


def heads_case(gen, N, L, H, device, mask="ragged", D=128):
    """q (scaled by 1 / sqrt(D / H)), k and v as the multi-head text path
    hands them over, ``(N, L, H, D / H)`` views (k and v of one fused
    ``(N, L, 3D)`` bf16 tensor, so their rows are strided), a key mask as
    ``attention_case`` draws it, and a cotangent."""
    import torch
    d = D // H
    q, k, v, valid, do = attention_case(gen, N, L, D, device, mask)
    scale = torch.tensor(D ** 0.5 / d ** 0.5, dtype=torch.bfloat16)
    return ((q * scale).view(N, L, H, d), k.view(N, L, H, d),
            v.view(N, L, H, d), valid, do.view(N, L, H, d))


def chunked(fn, *args, rows: int):
    """``fn`` over slices of ``rows`` sequences of its arguments (all with
    the sequence axis first), its outputs joined: the plain versions at
    shapes whose (N, H, L, L) intermediates would not fit the card."""
    import torch
    outs = [fn(*(a[i:i + rows] for a in args))
            for i in range(0, args[0].shape[0], rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def sdpa_heads(q, k, v, valid, do=None):
    """``F.scaled_dot_product_attention`` on the heads (q comes scaled, so
    its scale is 1): the forward alone, or with ``do`` the forward and its
    autograd backward. Timed only, used nowhere in the port."""
    import torch
    mask = valid[:, None, None, :]
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    if do is None:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            *heads, attn_mask=mask, scale=1.0)
    leaves = [t.detach().clone().requires_grad_() for t in heads]

    def both():
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask, scale=1.0)
        return torch.autograd.grad(out, leaves, do.transpose(1, 2))
    return both


def ex2_rate() -> float:
    """ex2 a second of the card: 16 a clock an SM (the special-function
    units of Hopper's four SM partitions) at the SMs' highest clock."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16.0 * sms * mhz * 1e6


def heads_kernel_phase(device) -> dict:
    """#12 (the attention kernels with H = 2, 4, 8 heads of width 128 / H,
    ``csrc/fused_attention_heads.cu``) against their plain versions:
    N = 8,000, L = 128 and N = 2,000, L = 512, ragged, all-valid and
    holed masks, and two small cases of groups whose last one is short
    (3 heads of 40, 16 of 8), every output element held by
    ``check_bf16``; two runs bit-identical; every head of the ragged
    8,000 x 128 and small cases equal bit for bit to the single-head
    kernel (#6 / #7) on that head alone, and the digest of the single-head
    outputs, heads side by side, the multi-head digest. Each case prints
    its ``head_plan``; every instantiation of the library builds with no
    spilled register (``ptxas -v``). The ragged 8,000 x 128 cases are
    timed beside the plain version and SDPA (the library's forward, and
    its forward + backward less the forward), the ragged 2,000 x 512 ones
    beside SDPA (their plain backward's intermediates are 17 GB a tensor
    at H = 8). The bound is the largest of three times: the bytes of q,
    every row, and k and v at real keys (all L keys of a sequence without
    one), of the output (and in the backward of do, dq, dk and dv) over
    the card's memory rate; 4 (forward) or 10 (backward) x (real keys x
    L x 128) FLOP over the bf16 tensor-core peak; and H x (real keys x
    L) ex2, once forward and once backward (the least any design
    recomputes), over ``ex2_rate``. Returns the rows by kernel."""
    import torch
    from mrgcn_tpu_torch.ops import attention as att
    from mrgcn_tpu_torch.ops.kernel_bounds import attention_scales
    gen = torch.Generator(device=device).manual_seed(12)
    rows = {"attention_heads_fwd": [], "attention_heads_bwd": []}
    report = ptxas_report("fused_attention_heads")
    for kernel_name, used in report.items():
        print(f"[kernel] fused_attention_heads.cu {kernel_name}: "
              f"{json.dumps(used)}")
    check(len(report) == 12 and all(
        u["spill_store_bytes"] == u["spill_load_bytes"] == 0
        for u in report.values()),
        f"fused_attention_heads: spilled registers or missing "
        f"instantiations: {report}")
    ex2_per_s = ex2_rate()
    print(f"[kernel] ex2 rate {ex2_per_s:.4g} /s")
    faulthandler.dump_traceback_later(500, exit=True)
    short, long = HEAD_SHAPES
    for (N, L), H, mask, D in (
            [(short, H, "ragged", 128) for H in HEAD_COUNTS]
            + [(long, H, "ragged", 128) for H in HEAD_COUNTS]
            + [(short, H, "all", 128) for H in HEAD_COUNTS]
            + [(long, H, "holes", 128) for H in HEAD_COUNTS]
            + [((300, 200), 3, "holes", 120), ((300, 128), 16, "ragged",
                                                128)]):
        d = D // H
        label = f"h{H}_{N}x{L}" + ("" if mask == "ragged" else f"_{mask}") \
            + ("" if d == 128 // H else f"_d{d}")
        plan = att.head_plan(H, d, L)
        print(f"[kernel] #12 {label}: {plan} (forward groups "
              f"{len(plan.groups(H))}, backward {len(plan.groups(H, True))})")
        q, k, v, valid, do = heads_case(gen, N, L, H, device, mask, D)
        per_chunk = max(1, PLAIN_CHUNK_BYTES // (6 * H * L * L * 4))
        scales = chunked(attention_scales, q, k, v, valid, do,
                         rows=per_chunk)
        fwd = lambda: att.attention_fwd(q, k, v, valid)  # noqa: E731
        bwd = lambda: att.attention_bwd(q, k, v, valid, do)  # noqa: E731
        plain_fwd = lambda: chunked(  # noqa: E731
            att.attention_fwd_reference, q, k, v, valid, rows=per_chunk)
        plain_bwd = lambda: chunked(  # noqa: E731
            att.attention_bwd_reference, q, k, v, valid, do,
            rows=per_chunk)
        real = valid.sum(dim=1)
        pairs = float(real.sum()) * L * D
        kv_rows = int(torch.where(real > 0, real, torch.full_like(real, L))
                      .sum())
        qkv_bytes = (N * L + 2 * kv_rows) * D * 2 + valid.numel()
        ex2 = float(H) * kv_rows * L
        for name, kernel, plain, sc, work, library in (
                ("attention_heads_fwd", fwd, plain_fwd, scales[:1],
                 (qkv_bytes + N * L * D * 2, 4 * pairs),
                 sdpa_heads(q, k, v, valid)),
                ("attention_heads_bwd", bwd, plain_bwd, scales[1:],
                 (qkv_bytes + 4 * N * L * D * 2, 10 * pairs),
                 sdpa_heads(q, k, v, valid, do))):
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            outs = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            agains = again if isinstance(again, tuple) else (again,)
            errs = [check_bf16(g, w, s_, f"{name} {label} output {i}")
                    for i, (g, w, s_) in enumerate(zip(outs, wants, sc))]
            check(all(torch.equal(g, a) for g, a in zip(outs, agains)),
                  f"{name} {label}: two runs differ")
            row = {"label": label, "heads": H, "max_abs_err":
                   max(e for e, _ in errs),
                   "max_err_over_bound": max(r for _, r in errs),
                   "digest": digest(outs)}
            del got, again, want, outs, wants, agains
            if mask == "ragged" and (N, L) in HEAD_SHAPES:
                if (N, L) == short:
                    row.update(timed_pair(kernel, plain, library))
                else:
                    row.update(ms=time_ms(kernel), plain_ms=None,
                               library_ms=time_ms(library))
                row.update(bound(work[0], work[1], BF16_FLOPS))
                terms = {"bytes": work[0] / HBM_BYTES_S * 1e3,
                         "tensor": work[1] / BF16_FLOPS * 1e3,
                         "ex2": ex2 / ex2_per_s * 1e3}
                row.update(ex2=int(ex2), bound_terms_ms=terms,
                           bound_ms=max(terms.values()),
                           bound_term=max(terms, key=terms.get))
                row["bound_by"] = "bytes" if row["bound_term"] == "bytes" \
                    else "operations"
                row["fraction_of_bound"] = row["bound_ms"] / row["ms"]
            rows[name].append(row)
        if "library_ms" in rows["attention_heads_bwd"][-1]:
            f_row, b_row = (rows[n][-1] for n in rows)
            b_row["library_fwd_bwd_ms"] = b_row["library_ms"]
            b_row["library_ms"] = b_row["library_ms"] - f_row["library_ms"]
        if (N, L) not in HEAD_SHAPES or (mask == "ragged"
                                         and (N, L) == short):
            # each head alone through the single-head kernel: the same bits
            out = att.attention_fwd(q, k, v, valid)
            dq, dk, dv = att.attention_bwd(q, k, v, valid, do)
            single = [[], [], [], []]
            for h in range(H):
                one = [t[:, :, h].contiguous() for t in (q, k, v)]
                got = (att.attention_fwd(*one, valid), *att.attention_bwd(
                    *one, valid, do[:, :, h].contiguous()))
                for i, (g, w) in enumerate(zip((out, dq, dk, dv), got)):
                    check(torch.equal(g[:, :, h], w),
                          f"{label}: head {h}'s output {i} differs from "
                          "the single-head kernel's")
                    single[i].append(w)
            one_digests = [digest([torch.stack(single[0], dim=2)]),
                           digest([torch.stack(t, dim=2)
                                   for t in single[1:]])]
            for name, one_digest in zip(rows, one_digests):
                rows[name][-1]["digest_single_head"] = one_digest
                check(one_digest == rows[name][-1]["digest"],
                      f"{name} {label}: the single-head digest differs")
            del out, dq, dk, dv, one, got, single
        for name in rows:
            print(f"[kernel] {name} {json.dumps(rows[name][-1])}")
        del q, k, v, valid, do, scales
        torch.cuda.empty_cache()
    faulthandler.cancel_dump_traceback_later()
    return rows


def padded_tokens(strings, pad: int):
    """The byte-token strings of an encoding set as one ``(N, longest)``
    int64 array, ``pad`` past each string's end."""
    import numpy as np
    longest = max(len(t) for t in strings)
    out = np.full((len(strings), longest), pad, dtype=np.int64)
    for i, t in enumerate(strings):
        out[i, :len(t)] = t
    return out


def relative_errors(got: dict, want: dict) -> dict:
    """Each entry's error norm relative to the norm of ``want``'s."""
    return {n: float((got[n].double() - w.double()).norm()
                     / max(float(w.double().norm()), 1e-30))
            for n, w in want.items()}


def heads_card_vs_cpu(tokens, cot, H: int, device) -> None:
    """A fresh ``TextEncoder`` with ``H`` heads (the ``xla`` tree) on the
    card and the CPU with the same weights, and a float64 witness of it on
    the CPU (``dtype=torch.float64``: no bf16 rounding anywhere). Each
    parameter's gradient for the cotangent ``cot`` (the key bias left out:
    0 in exact arithmetic, ``encoder_agreement``) and the output are held
    card against CPU by the text bounds of ``ENCODER_RTOL`` (1e-1 by norm,
    1e-2 of the largest output). At these fresh weights the bf16 CPU run
    itself lies about that far from the witness (printed as ``cpu_f64``),
    so an entry over its bound passes
    only where the card is no farther from the witness than
    ``WITNESS_MARGIN`` times the CPU's distance from it; every such entry
    is printed with the three distances."""
    import copy
    import torch
    from mrgcn_tpu_torch.models.encoders import TextEncoder
    cpu = TextEncoder(16, torch.Generator().manual_seed(0), num_heads=H,
                      attn_impl="xla")
    card = copy.deepcopy(cpu).to(device)
    exact = TextEncoder(16, torch.Generator().manual_seed(0), num_heads=H,
                        attn_impl="xla", dtype=torch.float64)
    exact.load_state_dict(cpu.state_dict())
    exact.double()
    results = []
    for model, dev in ((cpu, "cpu"), (card, device), (exact, "cpu")):
        out = model(tokens.to(dev))
        out.backward(cot.to(dev, out.dtype))
        results.append({"output": out.detach().cpu()} | {
            n: p.grad.cpu() for n, p in model.named_parameters()
            if not n.endswith(".key.bias")})
    want, got, witness = results
    out_err = float((got["output"].double() - want["output"].double())
                    .abs().max() / want["output"].double().abs().max())
    card_cpu = relative_errors(got, want)
    card_cpu["output"] = out_err
    card_exact = relative_errors(got, witness)
    cpu_exact = relative_errors(want, witness)
    for side in (card_exact, cpu_exact):
        side["output"] = float(
            ((got if side is card_exact else want)["output"].double()
             - witness["output"]).abs().max()
            / witness["output"].abs().max())
    out_bound, grad_bound = ENCODER_RTOL["text"]
    over = {n: {"card_cpu": e, "card_f64": card_exact[n],
                "cpu_f64": cpu_exact[n]}
            for n, e in card_cpu.items()
            if e > (out_bound if n == "output" else grad_bound)}
    worst = max((n for n in card_cpu if n != "output"), key=card_cpu.get)
    print(f"[agree] text encoder, {H} head(s), card vs CPU: output rel err "
          f"{out_err:.3g} (bound {out_bound}; CPU vs float64 "
          f"{cpu_exact['output']:.3g}, card vs float64 "
          f"{card_exact['output']:.3g}), parameter gradients max rel norm "
          f"err {card_cpu[worst]:.3g} at {worst} (bound {grad_bound}); "
          f"over the bound, against the float64 witness (card no farther "
          f"than {WITNESS_MARGIN} x the CPU's distance): {json.dumps(over)}")
    check(all(v["card_f64"] <= WITNESS_MARGIN * v["cpu_f64"]
              for v in over.values()),
          f"the {H}-head text encoder differs on the card and the CPU")


def heads_paths(work, device) -> dict:
    """The multi-head text encoder, which ``MRGCN`` never builds (it
    passes no head count) and a caller builds directly: a ``TextEncoder``
    with ``num_heads`` = 2, 4, 8 (the ``xla`` tree) trains
    ``HEAD_STEPS`` Adam steps on the multimodal path's 8,000 byte strings
    (padded to 128) towards a seeded target, each with the launch counts
    set to 0 just before and read just after: two blocks, so 2 launches
    of #12 forward and backward a step and none of #6 / #7. The losses
    must be finite and fall. Then 300 of the strings at one head and at
    four on the card and the CPU (``heads_card_vs_cpu``)."""
    import torch
    from mrgcn_tpu_torch.encodings.xsd.string import ByteTokenizer
    from mrgcn_tpu_torch.models.encoders import TextEncoder
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    strings = multimodal_features(work["n"], seed=0,
                                  num_strings=HEAD_PATH_STRINGS)[
        "xsd.string"][0][0]
    tokens = torch.from_numpy(padded_tokens(strings, ByteTokenizer.PAD))
    target = torch.randn(len(strings), 16,
                         generator=torch.Generator().manual_seed(5))
    paths = {}
    for H in HEAD_COUNTS:
        model = TextEncoder(16, torch.Generator().manual_seed(0),
                            num_heads=H, attn_impl="xla").to(device)
        optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
        x, y = tokens.to(device), target.to(device)
        counters = start_path()
        losses, seconds = [], []
        for _ in range(HEAD_STEPS):
            t0 = time.perf_counter()
            loss = ((model(x, train=True) - y) ** 2).mean()
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
            seconds.append(time.perf_counter() - t0)
        launches = read_launches(counters)
        tag = f"text_heads_h{H}"
        want = 2 * HEAD_STEPS
        check(launches["attention_fwd.heads"] == want
              and launches["attention_bwd.heads"] == want
              and launches["attention_fwd"] == launches["attention_bwd"] == 0,
              f"{tag}: attention launches {launches}")
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
              f"{tag}: losses {losses}")
        summary = {"path": tag, "steps": HEAD_STEPS, "losses": losses,
                   "step_s": seconds,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "launches": launches}
        print(f"[slice] {json.dumps(summary)}")
        paths[tag] = summary
        del model, optimizer, x, y
    for H in (1, 4):
        heads_card_vs_cpu(tokens[:300], target[:300], H, device)
    return paths


def text_attn_agreement(tmp: Path) -> dict:
    """The CLI on the agreement phase's small multimodal graph under
    ``MRGCN_TEXT_ATTN`` = each of ``TEXT_ATTN_IMPLS``, 3 epochs on the card
    (counts set to 0 just before, read just after: #6 / #7 launch, #12
    does not: ``MRGCN`` builds one head) and on the CPU: the losses within
    1e-3 (the multimodal bound), the first within 1e-4, and each encoder
    card against CPU (``encoder_agreement``: the text bounds 1e-2 /
    1e-1)."""
    from mrgcn_tpu_torch.tasks.synthetic import multimodal_features
    small = small_graph()
    F = multimodal_features(small["n"], seed=0, num_numeric=600,
                            num_years=300, num_strings=240, max_len=128)
    paths = {}
    try:
        for impl in TEXT_ATTN_IMPLS:
            os.environ["MRGCN_TEXT_ATTN"] = impl
            tag = f"small_mm_{impl}"
            counters = start_path()
            gpu = train_via_cli(tmp, tag, small, 3, 4, F=F)
            launches = read_launches(counters)
            cpu = train_via_cli(tmp, tag, small, 3, 4, platform="cpu", F=F)
            check(gpu.model.xsd_string_0.attn_impl == impl,
                  f"{tag}: built {gpu.model.xsd_string_0.attn_impl}")
            check(launches["attention_fwd"] > 0
                  and launches["attention_bwd"] > 0
                  and launches["attention_fwd.heads"] == 0,
                  f"{tag}: attention launches {launches}")
            a = [h["train_loss"] for h in gpu.history] + [gpu.loss]
            b = [h["train_loss"] for h in cpu.history] + [cpu.loss]
            err = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
            first = abs(a[0] - b[0]) / max(abs(b[0]), 1e-12)
            print(f"[agree] {tag} losses cuda {a} cpu {b} (max rel err "
                  f"{err:.3g}, bound 1e-3; first {first:.3g}, bound 1e-4)")
            check(err <= 1e-3 and first <= 1e-4,
                  f"{tag}: cuda and cpu losses differ")
            encoder_agreement(tmp, tag, gpu.model, cpu.model)
            paths[tag] = {"path": tag, "launches": launches,
                          "train_loss": a[:-1], "test_loss": a[-1]}
    finally:
        os.environ.pop("MRGCN_TEXT_ATTN", None)
    return paths


def text_attn_phase(work, tmp: Path, device, rows) -> dict:
    """#12 against its plain version (``heads_kernel_phase``), the
    multi-head encoder's training paths (``heads_paths``) and every other
    text attention path card against CPU (``text_attn_agreement``).
    Returns the paths' summaries."""
    with timed_part("text_attn #12 cases"):
        rows.update(heads_kernel_phase(device))
    with timed_part("text_attn head paths"):
        paths = heads_paths(work, device)
    with timed_part("text_attn card vs CPU"):
        paths.update(text_attn_agreement(tmp))
    return paths


# ---------------------------------------------------------------------------
# the pretrained backbones (DistilBERT text, MobileNetV2 images)
# ---------------------------------------------------------------------------

# the small graph's feature counts on the backbones (its CPU side runs
# DistilBERT at the published widths)
BB_SMALL_STRINGS, BB_SMALL_IMAGES = 60, 40


def backbone_files(tmp: Path) -> dict:
    """The backbones' files with random weights from seed 0: a DistilBERT
    at ``distilbert-base-multilingual-cased``'s published widths (dim 768,
    6 layers, 12 heads, hidden 3,072, vocabulary 119,547, 512 positions)
    in a hub cache that ``HF_HUB_CACHE`` names, and a torchvision-format
    MobileNetV2 ``.pth`` that ``MRGCN_VISION_WEIGHTS`` names."""
    from mrgcn_tpu_torch.tasks.synthetic import (
        save_mobilenet_checkpoint, save_text_backbone_snapshot)
    t0 = time.perf_counter()
    hub = tmp / "hub"
    snapshot = save_text_backbone_snapshot(hub, seed=0)
    pth = tmp / "mobilenet_v2-random.pth"
    save_mobilenet_checkpoint(pth, seed=0)
    os.environ["HF_HUB_CACHE"] = str(hub)
    os.environ["MRGCN_VISION_WEIGHTS"] = str(pth)
    files = {"snapshot": snapshot, "pth": pth,
             "msgpack_bytes": (snapshot / "flax_model.msgpack")
             .stat().st_size, "pth_bytes": pth.stat().st_size,
             "write_s": time.perf_counter() - t0}
    print(f"[backbones] files: {json.dumps(files, default=str)}")
    return files


def backbones_unchanged(label: str, pairs) -> dict:
    """Each trained encoder's frozen backbone, on the card, against
    ``fresh``, the module loaded anew from its file (``pairs`` of
    ``(encoder, fresh)``): bit-equal; and the encoder's head moved off its
    zero biases."""
    import torch
    for encoder, fresh in pairs:
        mine = encoder.backbone.state_dict()
        check(all(t.device.type == "cuda" for t in mine.values()),
              f"{label}: a backbone tensor is off the card")
        check(all(torch.equal(t.cpu(), fresh.state_dict()[k])
                  for k, t in mine.items()),
              f"{label}: {type(encoder).__name__}'s backbone changed")
        for j in (0, 1):
            check(bool(getattr(encoder, f"Dense_{j}").bias.ne(0).any()),
                  f"{label}: {type(encoder).__name__}'s head never moved")
    return {"backbone_tensors": sum(len(e.backbone.state_dict())
                                    for e, _ in pairs)}


def both_backbones_unchanged(model, files) -> dict:
    """The DistilBERT and MobileNetV2 of the ``backbones`` phase's trained
    model (``backbones_unchanged``)."""
    from mrgcn_tpu_torch.models.distilbert import DistilBert
    from mrgcn_tpu_torch.models.mobilenet import load_image_backbone
    from mrgcn_tpu_torch.models.pretrained import (PretrainedImageEncoder,
                                                   PretrainedTextEncoder)
    text, image = model.xsd_string_0, model.blob_image_0
    check(isinstance(text, PretrainedTextEncoder)
          and isinstance(image, PretrainedImageEncoder),
          f"backbones: built {type(text).__name__}, {type(image).__name__}")
    return backbones_unchanged("backbones", (
        (text, DistilBert.from_pretrained(files["snapshot"])),
        (image, load_image_backbone(str(files["pth"])))))


def backbone_agreement(tmp: Path, files) -> dict:
    """The small graph with both backbones (``BB_SMALL_STRINGS`` strings,
    ``BB_SMALL_IMAGES`` images of 224 x 224), 2 epochs through the CLI on
    the card and the CPU: the first epoch's loss within 1e-4, each
    encoder card against CPU (``encoder_agreement``: the pretrained ones,
    backbone output and head gradients, within 1e-4). Then a checkpoint
    round trip on the card: the file holds the heads and no backbone
    tensor, and a run restored from it (which loads the backbones from
    disk again) gives the saving model's eval-mode test logits within
    1e-5 of their largest."""
    import numpy as np
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    from mrgcn_tpu_torch.tasks.synthetic import (DISTILBERT_MULTILINGUAL,
                                                 multimodal_features)
    small = small_graph()
    F = functools.partial(
        multimodal_features, small["n"], seed=0, num_numeric=600,
        num_years=300, num_strings=BB_SMALL_STRINGS, max_len=128,
        num_geometries=300, num_images=BB_SMALL_IMAGES,
        image_size=IMAGE_SIDE,
        wordpiece_vocab=DISTILBERT_MULTILINGUAL["vocab_size"])
    tag = "small_bb"
    gpu = train_via_cli(tmp, tag, small, 2, 4, F=F, features=ALLMODAL,
                        backbones=True)
    cpu = train_via_cli(tmp, tag, small, 2, 4, platform="cpu", F=F,
                        features=ALLMODAL, backbones=True)
    a = [h["train_loss"] for h in gpu.history]
    b = [h["train_loss"] for h in cpu.history]
    first = abs(a[0] - b[0]) / abs(b[0])
    print(f"[backbones] {tag} losses cuda {a} cpu {b}: first epoch rel err "
          f"{first:.3g} (bound 1e-4)")
    check(first <= 1e-4, f"{tag}: the first losses differ (rel {first})")
    encoder_agreement(tmp, tag, gpu.model, cpu.model)

    counters = kernel_counters()
    with watch_run(counters, nc) as rec:
        saved = train_via_cli(tmp, tag, small, 2, 4, F=F, features=ALLMODAL,
                              backbones=True, extra=["--save_checkpoint"])
    keys = list(np.load(rec["file"]).files)
    encoders = {k.split("/")[1] for k in keys if k.startswith("params/")}
    heads = sorted(k for k in keys
                   if k.startswith(("params/xsd_string_0/",
                                    "params/blob_image_0/")))
    want = sorted(f"params/{e}/Dense_{j}/{leaf}"
                  for e in ("xsd_string_0", "blob_image_0") for j in (0, 1)
                  for leaf in ("bias", "kernel"))
    check(heads == want and len([k for k in keys if k.startswith("params/")])
          == len(list(saved.model.parameters())),
          f"{tag}: the checkpoint holds {heads} of the pretrained encoders")
    # the restored run trains no epoch: its model is the file's
    write_config(tmp / f"{tag}_0.toml", 0, 4, small["hidden"],
                 features=ALLMODAL, backbones=True)
    with watch_run(counters, nc) as loaded:
        restored = run.run_cli(["-c", str(tmp / f"{tag}_0.toml"), "-i",
                                str(tmp / f"{tag}.npz"), "-o",
                                str(tmp) + os.sep, "--dry_run", "--test",
                                "--load_checkpoint", rec["file"]])
    check("restored" in loaded and not restored.history,
          f"{tag}: nothing restored, or the restored run trained")
    config = run.load_config(str(tmp / f"{tag}.toml"))
    art = run.artifact_io.load(str(tmp / f"{tag}.npz"))
    Y_test = np.asarray(art.Y["test"]).reshape(-1, 2)
    device = next(saved.model.parameters()).device
    batch = nc.make_batches(prepare_inputs(art, config, False, device),
                            Y_test, -1, 2)[0]
    logits = []
    for m in (saved.model, restored.model):
        with torch.no_grad():
            logits.append(m(batch.edges, batch.features)[batch.idx].cpu())
    err = float((logits[1] - logits[0]).abs().max() / logits[0].abs().max())
    print(f"[backbones] checkpoint: {len(keys)} entries, encoders "
          f"{sorted(encoders)}, {rec['file_bytes']} bytes; restored eval "
          f"logits err over the largest {err:.3g} (bound 1e-5)")
    check(err <= 1e-5, f"{tag}: the restored model's logits differ ({err})")
    return {"small_losses": {"cuda": a, "cpu": b},
            "checkpoint_bytes": rec["file_bytes"],
            "restored_logits_err": err}


def backbones_phase(work, tmp: Path) -> dict:
    """``dmg_synth_allmodal`` with both pretrained backbones at the
    published widths through the CLI (``slice_phase``, ``EPOCHS`` epochs):
    8,000 strings of 3-130 WordPiece-like ids, 2,000 images of 224 x 224,
    the WKT, numeric and gYear features as before, X_width 165. The
    kernels by route as the all-modality path (#5, #1, #4, #10), #6-#9
    none (the text encoder is the backbone); the backbones bit-equal to
    their files after training, on the card, and the heads moved
    (``backbones_unchanged``); then the small graph card against CPU and
    a checkpoint round trip (``backbone_agreement``)."""
    from mrgcn_tpu_torch.tasks.synthetic import DISTILBERT_MULTILINGUAL
    files = backbone_files(tmp)
    try:
        paths = {"nc_backbones": slice_phase(
            work, tmp, "dmg_synth_allmodal_bb",
            {"sorted_scatter": 1, "fused_place_scatter": 3},
            F=allmodal_features(
                work["n"],
                wordpiece_vocab=DISTILBERT_MULTILINGUAL["vocab_size"]),
            features=ALLMODAL, backbones=True, absent=ENCODER_KERNELS,
            inspect=lambda res: both_backbones_unchanged(res.model,
                                                         files))}
        with timed_part("backbones small graph and checkpoint"):
            paths["nc_backbones"].update(backbone_agreement(tmp, files))
    finally:
        os.environ.pop("HF_HUB_CACHE", None)
        os.environ.pop("MRGCN_VISION_WEIGHTS", None)
    return paths


# the text backbones of the backbones_bert phase: (the model's hub name,
# its published config.json in tasks/synthetic, the tokenizer's pad token,
# where its string ids come from: the multimodal_features argument that
# draws them, or "tokenizer" for the snapshot's own tokenizer (Unigram,
# BLOOM's byte-level BPE) over generated strings (text_literals through
# string.generate_features), the pad id, the strings of the graph)
TEXT_BACKBONES = {
    # 2,000 strings (cut from 8,000 to keep the whole run well inside its
    # time limit): a step near 1.3 s
    "bert": ("bert-base-multilingual-cased", "BERT_MULTILINGUAL", "[PAD]",
             "wordpiece_vocab", 0, 2_000),
    "roberta": ("roberta-base", "ROBERTA_BASE", "<pad>", "bpe_vocab", 1,
                2_000),
    "xlm-roberta": ("xlm-roberta-base", "XLM_ROBERTA_BASE", "<pad>",
                    "tokenizer", 1, 2_000),
    "roberta-prelayernorm": ("andreasmadsen/efficient_mlm_m0.40",
                             "ROBERTA_PRELAYERNORM", "<pad>", "bpe_vocab", 1,
                             2_000),
    # about 4.8 GFLOP a token: 500 strings (cut from 8,000) keep a step
    # near 5 s
    "albert": ("albert-xxlarge-v2", "ALBERT_XXLARGE", "<pad>", "tokenizer",
               0, 500),
    # about 0.6 GFLOP a token: 2,000 strings of up to about 140 ids keep a
    # step near 4 s
    "bloom": ("bigscience/bloom-560m", "BLOOM_560M", "<pad>", "tokenizer", 3,
              2_000)}
TEXT_BACKBONE_EPOCHS = 2
# the most words of a generated string (text_literals); the strings of
# the small graph the text backbones run on card and CPU, and their most
# words (few and short: the CPU side runs the published widths)
TEXT_WORDS = 40
TEXT_BACKBONE_SMALL = (6, 8)


def text_strings(kind: str, num_nodes: int, num_strings: int, tag: str,
                 max_words: int = TEXT_WORDS):
    """``kind``'s string features for ``multimodal_features`` on a graph of
    ``num_nodes``: a function that draws them, and the host seconds that
    tokenizing took (0 for drawn ids). The other kinds tokenize
    ``num_strings`` generated strings through the port's tokenizer of the
    snapshot in the hub cache (``synthetic.tokenized_strings``)."""
    from mrgcn_tpu_torch.encodings.xsd.string import load_tokenizer
    from mrgcn_tpu_torch.tasks import synthetic
    name, config_name, pad_token, strings, _, _ = TEXT_BACKBONES[kind]
    if strings != "tokenizer":
        return functools.partial(
            synthetic.multimodal_features, num_nodes, seed=0,
            num_strings=num_strings,
            **{strings: getattr(synthetic, config_name)["vocab_size"]}), 0.0
    t0 = time.perf_counter()
    feature = {"datatype": "xsd.string", "tokenizer": {
        "config": ["huggingface/pytorch-transformers", "tokenizer", name],
        "pad_token": pad_token}}
    ids, _, lengths = synthetic.tokenized_strings(
        feature, synthetic.text_literals(num_strings, seed=0,
                                         max_words=max_words))
    seconds = time.perf_counter() - t0
    print(f"[backbones_bert] {tag}: {num_strings} strings tokenized by the "
          f"port's {type(load_tokenizer(feature)).__name__} in "
          f"{seconds:.2f} s of host, {int(lengths.sum())} ids, "
          f"{int(lengths.min())}-{int(lengths.max())} a string")
    return functools.partial(synthetic.multimodal_features, num_nodes,
                             seed=0, token_strings=(ids, lengths)), seconds


@contextlib.contextmanager
def step_events(task):
    """CUDA events around each of ``task``'s training steps in a run:
    yields the list of ``(start, end)`` pairs."""
    import torch
    events, step = [], task.train_step

    def timed(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = step(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    task.train_step = timed
    try:
        yield events
    finally:
        task.train_step = step


def text_backbone_agreement(tmp: Path, kind: str) -> dict:
    """The small graph (``TEXT_BACKBONE_SMALL`` strings: 3-130
    drawn ids, or the snapshot tokenizer's ids of generated strings) on
    ``kind``'s backbone, one epoch through the CLI on the card and the
    CPU: the loss within 1e-4 relative, and the backbone's last hidden
    state over the graph's token rows within 1e-4 of its largest entry.
    Where the pad is not 0 (the RoBERTa family's 1, after ``<s>`` 0;
    BLOOM's 3) also, on the card: the ids under a zero mask changed from
    the pad to another id leave every real token's output as it was, and
    each padded row's pooled output is the row's own, run alone at its
    length (1e-4 of the largest entry)."""
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks import synthetic
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    name, _, pad_token, _, pad, _ = TEXT_BACKBONES[kind]
    small = small_graph()
    tag = f"small_{kind}"
    num_strings, max_words = TEXT_BACKBONE_SMALL
    draw, _ = text_strings(kind, small["n"], num_strings, tag, max_words)
    F = functools.partial(draw, num_numeric=600, num_years=300, max_len=128)
    runs = [train_via_cli(tmp, tag, small, 1, 4, platform=platform, F=F,
                          backbones=True, text_model=(name, pad_token))
            for platform in (None, "cpu")]
    a, b = (r.history[0]["train_loss"] for r in runs)
    loss_err = abs(a - b) / abs(b)
    cfg = run.load_config(str(tmp / f"{tag}.toml"))
    art = run.artifact_io.load(str(tmp / f"{tag}.npz"))
    tokens = prepare_inputs(art, cfg, False, torch.device("cpu")) \
        .features["xsd_string_0"][0]
    encoders = [r.model.xsd_string_0 for r in runs]
    check(all(e.pad_id == pad for e in encoders),
          f"{tag}: the encoders mask {[e.pad_id for e in encoders]}")
    devices = [next(r.model.parameters()).device for r in runs]
    hidden = []
    for encoder, device in zip(encoders, devices):
        ids = tokens.to(device)
        hidden.append(encoder.backbone(ids, attention_mask=ids != pad)
                      .cpu())
    hidden_err = float((hidden[0] - hidden[1]).abs().max()
                       / hidden[1].abs().max())
    print(f"[backbones_bert] {tag} ({tuple(tokens.shape)} tokens): first "
          f"epoch loss cuda {a} cpu {b}, rel err {loss_err:.3g} (bound "
          f"1e-4); backbone output err over the largest {hidden_err:.3g} "
          "(bound 1e-4)")
    check(loss_err <= 1e-4, f"{tag}: the first losses differ ({loss_err})")
    check(hidden_err <= 1e-4,
          f"{tag}: the backbone's outputs differ ({hidden_err})")
    out = {"small_loss": {"cuda": a, "cpu": b}, "small_loss_err": loss_err,
           "small_backbone_err": hidden_err}
    if pad == 0:
        return out
    encoder, ids = encoders[0], tokens.to(devices[0])
    real = ids != pad
    check(not bool(real.all()) and (pad != 1 or bool((ids[:, 0] == 0).all())),
          f"{tag}: no padding, or rows without <s> first")
    with torch.no_grad():
        want = encoder.backbone(ids, attention_mask=real)
        moved = encoder.backbone(torch.where(real, ids, 5),
                                 attention_mask=real)
        pad_err = float((moved - want)[real].abs().max()
                        / want[real].abs().max())
        pooled = encoder.features(ids)
        alone = max(
            float((encoder.features(ids[i:i + 1, :int(n)])[0] - pooled[i])
                  .abs().max() / pooled.abs().max())
            for i, n in enumerate(real.sum(dim=1).tolist())
            if n < ids.shape[1])
    print(f"[backbones_bert] {tag}: pads changed to id 5 under the mask, "
          f"real tokens' outputs moved {pad_err:.3g} of the largest (bound "
          f"1e-6); padded rows pooled alone against in the batch "
          f"{alone:.3g} (bound 1e-4)")
    check(pad_err <= 1e-6, f"{tag}: a masked pad's id moved the outputs")
    check(alone <= 1e-4, f"{tag}: a pad moved a row's pooled output")
    return {**out, "masked_pad_err": pad_err, "row_alone_err": alone}


def text_backbone_phase(work, tmp: Path, smi: str) -> dict:
    """``backbones_bert``: the multimodal graph (numeric, gYear and
    string features; no images, so the step is the text backbone's)
    through the CLI for ``TEXT_BACKBONE_EPOCHS`` epochs on each of
    ``TEXT_BACKBONES`` at its published widths, random weights from seed
    0 written into a hub cache that ``HF_HUB_CACHE`` names (the
    tokenizer's files with them: WordPiece, a small byte-level BPE whose
    pad is 1, a Unigram ``tokenizer.json`` with a precompiled charsmap
    as large as the model's vocabulary, or BLOOM's byte-level BPE
    layout); 2,000 strings (500 for ALBERT-xxlarge): 3-130 drawn ids (the RoBERTa family's framed by ``<s>``
    0 and ``</s>`` 2, padded with 1), or for XLM-R, ALBERT and BLOOM the
    ids the port's tokenizer (Unigram, byte-level BPE) gives generated
    strings, timed on the host. Each run: finite losses, the multimodal path's launches by route
    with #6-#9 at 0 (``slice_phase``), the backbone bit-equal to its file
    after training and the heads moved (``backbones_unchanged``), the
    step's time by the CLI, its device time by CUDA events and the peak,
    beside the card; then the small graph card against CPU
    (``text_backbone_agreement``)."""
    import torch
    from mrgcn_tpu_torch.models.albert import Albert
    from mrgcn_tpu_torch.models.bert import Bert
    from mrgcn_tpu_torch.models.bloom import Bloom
    from mrgcn_tpu_torch.models.pretrained import PretrainedTextEncoder
    from mrgcn_tpu_torch.tasks import node_classification as nc
    from mrgcn_tpu_torch.tasks import synthetic
    hub = tmp / "hub_text"
    os.environ["HF_HUB_CACHE"] = str(hub)
    paths = {}
    try:
        for kind, (name, config_name, pad_token, _, pad, num_strings) in \
                TEXT_BACKBONES.items():
            config = getattr(synthetic, config_name)
            cls = {"albert": Albert, "bloom": Bloom}.get(kind, Bert)
            t0 = time.perf_counter()
            snapshot = synthetic.save_text_backbone_snapshot(
                hub, name, config=config, seed=0)
            write_s = time.perf_counter() - t0
            tag = f"dmg_synth_{kind}"
            draw, tokenize_s = text_strings(kind, work["n"], num_strings,
                                            tag)

            def unchanged(res, snapshot=snapshot, kind=kind, pad=pad,
                          cls=cls):
                text = res.model.xsd_string_0
                check(isinstance(text, PretrainedTextEncoder)
                      and isinstance(text.backbone, cls)
                      and text.backbone.model_type == kind
                      and text.pad_id == pad,
                      f"{kind}: built {type(text).__name__} on "
                      f"{type(getattr(text, 'backbone', None)).__name__}")
                return backbones_unchanged(kind, ((
                    text, cls.from_pretrained(snapshot)),))

            with step_events(nc) as events, timed_part(
                    f"backbones_bert {kind} run"):
                summary = slice_phase(
                    work, tmp, tag,
                    {"sorted_scatter": 1, "fused_place_scatter": 3},
                    F=draw, backbones=True, absent=ENCODER_KERNELS,
                    epochs=TEXT_BACKBONE_EPOCHS,
                    text_model=(name, pad_token), inspect=unchanged)
            torch.cuda.synchronize()
            device_ms = [a.elapsed_time(b) for a, b in events]
            summary.update(snapshot_write_s=write_s,
                           tokenize_host_s=tokenize_s,
                           strings=num_strings, step_device_ms=device_ms)
            print(f"[backbones_bert] {kind} ({name}, {smi}): epoch "
                  f"{summary['epoch_s_median_after_first']:.4f} s "
                  f"(median after the first; all {summary['epoch_s_after_first']}"
                  f"), a training step's device time by CUDA events "
                  f"{statistics.median(device_ms[1:]):.2f} ms (all "
                  f"{[round(x, 2) for x in device_ms]}), peak "
                  f"{summary['peak_mem_bytes']} B; {num_strings} strings, "
                  f"tokenized on the host in {tokenize_s:.2f} s; files "
                  f"written in {write_s:.1f} s")
            with timed_part(f"backbones_bert {kind} small graph"):
                summary.update(text_backbone_agreement(tmp, kind))
            paths[f"nc_{kind}"] = summary
            shutil.rmtree(hub, ignore_errors=True)
    finally:
        os.environ.pop("HF_HUB_CACHE", None)
    return paths


EX = "http://example.org/"
XSD = "http://www.w3.org/2001/XMLSchema#"
# the etl phase's literals: the all-modality path's counts, without the
# images (PIL decodes them; the card's machine need not have it, and the
# CPU tests hold the image vectorizer against the JAX package's)
ETL_LITERALS = {"xsd.numeric": 20_000, "xsd.gYear": 10_000,
                "xsd.string": 8_000, "ogc.wktLiteral": 10_000}
ETL_FEATURES = tuple(ETL_LITERALS)
ETL_LP_EPOCHS = 3
# worker processes that write and build the etl phase's step (e)
ETL_WORKERS = 4


def write_etl_graph(work, directory: Path, seed: int = 0) -> dict:
    """``work``'s graph as gzipped N-Triples under ``directory``: each of
    its property edges (the self-loops are the model's own) as
    ``<e{src}> <p{rel}> <e{dst}>``, its labels as ``<e{i}> <hasClass>
    <class{c}>`` in 60 / 20 / 20 train / valid / test splits, and the
    literals of ``ETL_LITERALS`` drawn from ``seed``: doubles, gYears of
    1000-2024, strings of 1-128 ASCII bytes and WKT linestrings of 4-64
    points, each on an entity drawn at random (every entity that no edge
    touches takes a number first, so every label's node is in the graph)
    through the properties ``p0`` to ``p3``, so that the properties stay
    ``work``'s 120 and R its 121 without inverse relations. Returns the
    ``[graph]`` paths."""
    import gzip
    import numpy as np
    rng = np.random.default_rng(seed)
    n = work["n"]
    loops = work["rel"] == work["R"] - 1
    src, dst, rel = (work[k][~loops].tolist() for k in ("src", "dst", "rel"))
    lines = [f"<{EX}e{s}> <{EX}p{r}> <{EX}e{d}> .\n"
             for s, r, d in zip(src, rel, dst)]
    touched = np.zeros(n, dtype=bool)
    touched[work["src"][~loops]] = touched[work["dst"][~loops]] = True
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz"
                             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 "))
    for k, (datatype, count) in enumerate(ETL_LITERALS.items()):
        subjects = rng.integers(0, n, count)
        if k == 0:
            untouched = np.flatnonzero(~touched)
            subjects[:len(untouched)] = untouched
        if datatype == "xsd.numeric":
            objects = [f'"{v!r}"^^<{XSD}double>'
                       for v in rng.normal(0.0, 100.0, count).tolist()]
        elif datatype == "xsd.gYear":
            objects = [f'"{y}"^^<{XSD}gYear>'
                       for y in rng.integers(1000, 2025, count).tolist()]
        elif datatype == "xsd.string":
            objects = ['"' + "".join(rng.choice(alphabet, size)) +
                       f'"^^<{XSD}string>'
                       for size in rng.integers(1, 129, count).tolist()]
        else:
            objects = []
            for size in rng.integers(4, 65, count).tolist():
                xy = rng.uniform(-90.0, 90.0, (size, 2))
                objects.append('"LINESTRING (' + ", ".join(
                    f"{x:.6f} {y:.6f}" for x, y in xy.tolist()) +
                    f')"^^<http://www.opengis.net/ont/geosparql#wktLiteral>')
        lines += [f"<{EX}e{s}> <{EX}p{k}> {o} .\n"
                  for s, o in zip(subjects.tolist(), objects)]
    paths = {"context": directory / "context.nt.gz"}
    labels = list(zip(work["labels_idx"].tolist(),
                      work["labels_cls"].tolist()))
    cut = (int(0.6 * len(labels)), int(0.8 * len(labels)))
    splits = {"train": labels[:cut[0]], "valid": labels[cut[0]:cut[1]],
              "test": labels[cut[1]:]}
    for split, rows in splits.items():
        paths[split] = directory / f"{split}.nt.gz"
    with gzip.open(paths["context"], "wt", compresslevel=1) as f:
        f.writelines(lines)
    for split, rows in splits.items():
        with gzip.open(paths[split], "wt", compresslevel=1) as f:
            f.writelines(f"<{EX}e{i}> <{EX}hasClass> <{EX}class{c}> .\n"
                         for i, c in rows)
    return {k: str(v) for k, v in paths.items()}


def term_keys(triples) -> list:
    """Each term of each triple as (class, text, language, datatype)."""
    return [tuple((type(t).__name__, str(t), getattr(t, "language", None),
                   getattr(t, "datatype", None)) for t in triple)
            for triple in triples]


def same_artifacts(a, b) -> bool:
    """Two loaded artifacts with equal arrays, bit for bit."""
    import numpy as np

    def flat(art):
        out = [np.asarray([art.structure.num_nodes,
                           art.structure.num_relations])]
        out += [getattr(art.structure, k) for k in ("src", "dst", "rel",
                                                    "norm")]
        for datatype in sorted(art.F):
            for enc, idx, lengths in art.F[datatype]:
                out += list(enc) if enc.dtype == object else [enc]
                out += [idx, lengths]
        out += [art.Y[k] for k in sorted(art.Y)]
        out += [art.data[k] for k in sorted(art.data)]
        return out

    fa, fb = flat(a), flat(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(fa, fb)) \
        and a.sample_map == b.sample_map and a.class_map == b.class_map


def etl_build(cfg: Path, out: Path) -> tuple:
    """``mrgcn_tpu_torch.mkdataset``'s CLI (``build_cli``) into ``out``:
    the artifact's path and the host seconds by stage."""
    from mrgcn_tpu_torch import mkdataset
    out.mkdir()
    t0 = time.perf_counter()
    path, stages = mkdataset.build_cli(["-c", str(cfg), "-o",
                                        str(out) + os.sep])
    stages["total"] = time.perf_counter() - t0
    return Path(path), stages


# the N-Triples lines chip_smoke and the parity graphs write: subject,
# predicate, object as written (a literal with its escapes, language tag or
# datatype), one statement a line
NT_LINE = re.compile(r"(<[^>]*>|_:\S+) (<[^>]*>) (.+) \.\s*$")
NT_ESCAPES = re.compile(r"\\(?:u([0-9A-Fa-f]{4})|U([0-9A-Fa-f]{8})|(.))")
NT_CHARS = {"t": "\t", "b": "\b", "n": "\n", "r": "\r", "f": "\f",
            '"': '"', "'": "'", "\\": "\\"}
# serialisation -> the extension its files take in the etl phase's step (e)
SERIALISATIONS = {"turtle": ".ttl", "rdfxml": ".rdf", "jsonld": ".jsonld"}
RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
PN_LOCAL = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]*")   # a safe Turtle local


def open_text(path: Path, mode: str):
    """``path`` as UTF-8 text, through gzip (level 1) where it ends in
    ``.gz``."""
    import gzip
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t", encoding="utf-8", compresslevel=1)
    return open(path, mode, encoding="utf-8")


def read_nt(path: Path) -> list:
    """The statements of an N-Triples file as written: ``(subject,
    predicate, object)`` term texts; comments and blank lines skipped,
    anything else raises."""
    triples = []
    with open_text(path, "r") as f:
        for line in f:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            m = NT_LINE.match(line)
            check(m is not None, f"{path}: not a statement: {line!r}")
            triples.append(m.groups())
    return triples


def nt_literal(term: str) -> tuple:
    """An N-Triples literal's ``(lexical form, language, datatype)``, its
    escapes undone."""
    end = term.rindex('"')
    suffix = term[end + 1:]

    def unescape(m):
        u4, u8, c = m.groups()
        return chr(int(u4 or u8, 16)) if c is None else NT_CHARS[c]

    lexical = NT_ESCAPES.sub(unescape, term[1:end])
    language = suffix[1:] if suffix.startswith("@") else None
    datatype = suffix[3:-1] if suffix.startswith("^^") else None
    return lexical, language, datatype


def turtle_term(term: str, prefixes: dict) -> str:
    """A term text in Turtle: an IRI under a prefix as a prefixed name,
    anything else as N-Triples writes it (Turtle reads that too)."""
    if term.startswith("<"):
        for name, ns in prefixes.items():
            local = term[1 + len(ns):-1]
            if term.startswith("<" + ns) and PN_LOCAL.fullmatch(local):
                return f"{name}:{local}"
    return term


def write_turtle(triples, path: Path, prefixes: dict,
                 graph: str = None) -> None:
    """``triples`` as Turtle in their order: ``@prefix`` lines, prefixed
    names, ``;`` over consecutive statements of one subject, literals as
    N-Triples writes them (``"..."^^<dt>``). With ``graph``, TriG: every
    statement in the block ``GRAPH <graph> { ... }``."""
    with open_text(path, "w") as f:
        f.writelines(f"@prefix {k}: <{v}> .\n" for k, v in prefixes.items())
        if graph:
            f.write(f"GRAPH <{graph}> {{\n")
        last = None
        for s, p, o in triples:
            p, o = turtle_term(p, prefixes), turtle_term(o, prefixes)
            if s == last:
                f.write(f" ;\n    {p} {o}")
            else:
                f.write(f"{' .' if last else ''}\n{turtle_term(s, prefixes)} "
                        f"{p} {o}")
            last = s
        f.write(" .\n}\n" if graph else " .\n")


def write_rdfxml(triples, path: Path) -> None:
    """``triples`` as RDF/XML in their order: one ``rdf:Description`` a
    run of statements on one subject, each predicate a property element in
    a namespace declared on ``rdf:RDF``, ``rdf:resource`` / ``rdf:nodeID``
    objects, literals as XML-escaped text with ``rdf:datatype`` or
    ``xml:lang``."""
    from xml.sax.saxutils import escape, quoteattr
    spaces = {}
    for _, p, _ in triples:
        if p not in spaces:
            m = re.fullmatch(r"<(.*[/#])([A-Za-z_][A-Za-z0-9_.-]*)>", p)
            check(m is not None, f"no XML name for the predicate {p}")
            spaces[p] = m.groups()
    names = {ns: f"ns{i}" for i, ns in
             enumerate(dict.fromkeys(ns for ns, _ in spaces.values()))}
    qname = {p: f"{names[ns]}:{local}" for p, (ns, local) in spaces.items()}

    def node(term: str, attr: str) -> str:
        if term.startswith("_:"):
            return f"rdf:nodeID={quoteattr(term[2:])}"
        return f"rdf:{attr}={quoteattr(term[1:-1])}"

    with open_text(path, "w") as f:
        f.write('<?xml version="1.0" encoding="utf-8"?>\n'
                f'<rdf:RDF xmlns:rdf="{RDF_NS}"' + "".join(
                    f" xmlns:{n}={quoteattr(ns)}" for ns, n in names.items())
                + ">\n")
        last = None
        for s, p, o in triples:
            if s != last:
                if last is not None:
                    f.write("</rdf:Description>\n")
                f.write(f"<rdf:Description {node(s, 'about')}>\n")
                last = s
            if not o.startswith('"'):
                f.write(f"  <{qname[p]} {node(o, 'resource')}/>\n")
                continue
            lexical, language, datatype = nt_literal(o)
            attr = f" xml:lang={quoteattr(language)}" if language else \
                f" rdf:datatype={quoteattr(datatype)}" if datatype else ""
            f.write(f"  <{qname[p]}{attr}>"
                    f"{escape(lexical, {chr(13): '&#13;'})}</{qname[p]}>\n")
        if last is not None:
            f.write("</rdf:Description>\n")
        f.write("</rdf:RDF>\n")


def write_jsonld(triples, path: Path) -> None:
    """``triples`` as JSON-LD in their order: an ``@graph`` array of node
    objects, a new one where the subject changes or a predicate would
    come back after another, objects as ``{"@id"}`` references and
    literals as value objects whose ``@value`` is the lexical form (with
    ``@type`` or ``@language``)."""
    nodes, node, last = [], None, None
    for s, p, o in triples:
        sid = s[1:-1] if s.startswith("<") else s
        key = p[1:-1]
        if node is None or node["@id"] != sid or (key in node
                                                  and key != last):
            node = {"@id": sid}
            nodes.append(node)
        if o.startswith('"'):
            lexical, language, datatype = nt_literal(o)
            value = {"@value": lexical}
            if language:
                value["@language"] = language
            elif datatype:
                value["@type"] = datatype
        else:
            value = {"@id": o[1:-1] if o.startswith("<") else o}
        node.setdefault(key, []).append(value)
        last = key
    with open_text(path, "w") as f:
        f.write(json.dumps({"@graph": nodes}))


def write_serialised(triples, path: Path, serialisation: str) -> None:
    """``triples`` (``read_nt``'s) in ``path`` as ``serialisation``:
    ``turtle``, ``trig``, ``rdfxml`` or ``jsonld``."""
    if serialisation in ("turtle", "trig"):
        write_turtle(triples, path, {"ex": EX},
                     graph=f"{EX}graph" if serialisation == "trig" else None)
    elif serialisation == "rdfxml":
        write_rdfxml(triples, path)
    else:
        check(serialisation == "jsonld", f"unknown {serialisation}")
        write_jsonld(triples, path)


def serialise_graph(graph: dict, directory: Path, serialisation: str,
                    ext: str) -> dict:
    """Each N-Triples file of a ``[graph]`` section written again under
    ``directory`` as ``serialisation`` with extension ``ext`` (gzipped
    where the source is); returns the new section's paths."""
    directory.mkdir(exist_ok=True)
    out = {}
    for split, src in graph.items():
        name = Path(src).name.split(".")[0] + ext + \
            (".gz" if src.endswith(".gz") else "")
        out[split] = str(directory / name)
        write_serialised(read_nt(Path(src)), Path(out[split]), serialisation)
    return out


def stream_route(stream, place: bool) -> tuple:
    """``(scatter, kernel)`` a planned stream launches: a placement or a
    relation-constant stream ``fused_place_scatter``, any other
    ``sorted_scatter``, each on its row-segmented kernel where the
    planner marks the stream ``rows_sorted``."""
    scatter = "fused_place_scatter" if place or stream.rel_const \
        else "sorted_scatter"
    return scatter, ROW_KERNELS[scatter][0 if stream.rows_sorted else 1]


def lp_planned_launches(art: Path, cfg: Path, steps: int,
                        forwards: int) -> dict:
    """The kernel launches of ``steps`` full-graph LP training steps and
    ``forwards`` evaluation forwards, by kernel and route, as the planner
    builds this artifact's plans (``tasks/common.prepare_inputs``, on the
    CPU) and the layers choose among them (``models/rgcn.RGCNLayer``):
    the input layer on the composed table (``compose_table``,
    ``compose_grad_pass``, its ``fwd`` and ``bwd_table`` placed) or, over
    the table's budget, on the basis streams (``fused_place_scatter``
    forward, ``fused_scatter_dot`` once a basis backward); the second
    layer on its ``fwd`` and ``bwd_h`` streams where it has a plan it
    takes, or, where that plan has no relation-constant slabs, is wide
    and the weights are a few bases, ``dense_basis``'s
    ``fused_place_scatter`` forward on ``fwd`` and its ``sorted_scatter``
    backward on ``bwd_h``."""
    import torch
    from mrgcn_tpu_torch.config import load_config
    from mrgcn_tpu_torch.data import artifact as artifact_io
    from mrgcn_tpu_torch.ops import relational as rl
    from mrgcn_tpu_torch.tasks.common import prepare_inputs
    config = load_config(str(cfg))
    inputs = prepare_inputs(artifact_io.load(str(art)), config, True,
                            torch.device("cpu"))
    d0, d1 = inputs.hidden_dims[:2]
    bases = int(config["model"]["num_bases"])
    plan_i = inputs.edges.plan_for(d0, d0, identity=True)
    plan_f = inputs.edges.plan_for(d0, d1)
    check(plan_i is not None, "etl lp: no input-layer plan")
    want = {}

    def add(key, n):
        want[key] = want.get(key, 0) + n

    over = rl.composed_table_elems(inputs.num_relations, inputs.num_nodes,
                                   d0, n_in_rows=plan_i.n_in_rows) \
        > rl.COMPOSED_TABLE_MAX_ELEMS
    check(not over or (plan_i.kind == "identity_basis"
                       and 0 < bases <= rl.MAX_BASIS_STREAMS),
          "etl lp: the input layer takes the unplanned path")
    add(stream_route(plan_i.fwd, True), steps + forwards)
    if over:
        add(("fused_scatter_dot", ROW_KERNELS["fused_scatter_dot"][0]),
            bases * steps)
    else:
        add(("compose_table", None), steps + forwards)
        add(("compose_grad_pass", None), steps)
        add(stream_route(plan_i.bwd_table, True), steps)
    if plan_f is not None and (plan_f.fwd.rel_const or d0 * d1 <= 4096):
        add(stream_route(plan_f.fwd, False), steps + forwards)
        add(stream_route(plan_f.bwd_h, False), steps)
    elif plan_f is not None and plan_f.k_in == 1 \
            and plan_f.kind == "dense" \
            and 0 < bases <= rl.MAX_BASIS_STREAMS:
        add(stream_route(plan_f.fwd, True), steps + forwards)
        add(stream_route(plan_f.bwd_h, False), steps)
    return want


def etl_phase(work, tmp: Path) -> dict:
    """The port's ETL on the card's host, then its artifacts trained on the
    card: (a) ``work``'s graph written as N-Triples (``write_etl_graph``);
    (b) ``mkdataset``'s CLI over it, timed by stage, twice (equal arrays),
    with the native parser's triples held to the Python parser's on the
    context file; (c) ``EPOCHS`` NC epochs through ``run.run_cli`` at
    ``configs/dmg.toml``'s model and feature widths (``slice_phase``: the
    launches by kernel and route against the planner), the losses finite
    and falling; (d) ``mkdataset`` on ``benchmarks/parity/big/lp`` and
    ``ETL_LP_EPOCHS`` LP epochs at ``configs/fb15k-237.toml``'s widths,
    the launches against ``lp_planned_launches``; (e) (a)'s graph as
    Turtle, RDF/XML and JSON-LD and the parity graph as TriG, ``.n3``,
    ``.owl`` and ``.json``, each build equal to its N-Triples build
    (``serialisation_builds``; written and built in ``ETL_WORKERS``
    worker processes beside (b) to (d)), and the Turtle build trained
    as (c)."""
    import concurrent.futures
    import multiprocessing
    from mrgcn_tpu_torch.data import native
    print("[etl] images left out of the graph: PIL decodes them and the "
          "card's machine need not have it; tests/test_torch_etl_*.py hold "
          "the image vectorizer against the JAX package's on the CPU")
    t0 = time.perf_counter()
    data = tmp / "etl_data"
    data.mkdir()
    graph = write_etl_graph(work, data)
    graph["structural"] = {"include_inverse_properties": False,
                           "exclude_properties": [],
                           "separate_literals": False,
                           "multiprocessing": False}
    write_s = time.perf_counter() - t0
    cfg = tmp / "etl_nc.toml"
    write_config(cfg, EPOCHS, work["num_bases"], work["hidden"],
                 features=ETL_FEATURES,
                 task={"target_property": f"{EX}hasClass",
                       "target_property_inv": ""}, graph=graph)
    native.get_lib()     # built once here, not in each worker
    with concurrent.futures.ProcessPoolExecutor(
            ETL_WORKERS, mp_context=multiprocessing.get_context("spawn")) \
            as pool:
        pending = start_serialisations(pool, cfg, graph, data, tmp)
        return etl_steps(work, tmp, cfg, graph, write_s, pending)


def etl_steps(work, tmp: Path, cfg: Path, graph: dict, write_s: float,
              pending: dict) -> dict:
    """The etl phase's steps (b) to (e) (``etl_phase``), step (e)'s
    builds ``pending`` in worker processes."""
    import torch
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.data import artifact as artifact_io
    from mrgcn_tpu_torch.data import native, ntriples
    t0 = time.perf_counter()
    art, stages = etl_build(cfg, tmp / "etl_out1")
    art2, stages2 = etl_build(cfg, tmp / "etl_out2")
    first, second = artifact_io.load(str(art)), artifact_io.load(str(art2))
    check(same_artifacts(first, second), "etl: two builds differ")
    parser = "native" if native.get_lib() is not None else "python"
    if parser == "native":
        t1 = time.perf_counter()
        check(term_keys(native.parse_file_native(graph["context"]))
              == term_keys(ntriples.parse_file(graph["context"])),
              "etl: the native and the Python parser differ")
        print(f"[etl] native triples equal the Python parser's on the "
              f"context file ({time.perf_counter() - t1:.1f} s)")
    A = first.structure
    check(A.num_relations == work["R"],
          f"etl: R = {A.num_relations}, not {work['R']}")
    check(sum(len(v) for v in first.Y.values()) == len(work["labels_idx"]),
          "etl: labels lost")
    report = {"write_s": write_s, "stages_s": stages,
              "second_build_stages_s": stages2, "parser": parser,
              "artifact_bytes": art.stat().st_size,
              "file_bytes": sum(Path(p).stat().st_size for k, p in
                                graph.items() if k != "structural"),
              "num_nodes": A.num_nodes, "num_relations": A.num_relations,
              "num_edges": A.num_edges,
              "encoding_sets": {k: len(v) for k, v in first.F.items()}}
    print(f"[etl] {json.dumps(report)}")

    print(f"[time]   etl (b): {time.perf_counter() - t0:.1f} s")
    # (c) train it: the slice phase on the artifact and config above
    shutil.copy(art, tmp / "etl_nc.npz")
    etl_work = dict(work, n=A.num_nodes, src=A.src, dst=A.dst, rel=A.rel,
                    norm=A.norm)
    nc = slice_phase(etl_work, tmp, "etl_nc",
                     {"sorted_scatter": 1, "fused_place_scatter": 2,
                      **dict.fromkeys(ENCODER_KERNELS, 2)},
                     F=first.F, features=ETL_FEATURES)
    check(nc["train_loss"][-1] < nc["train_loss"][0],
          f"etl: the NC loss did not fall: {nc['train_loss']}")
    del first, second

    # (d) link prediction on the parity graph's own artifact
    big = ROOT / "benchmarks" / "parity" / "big"
    with open(big / "lp_config.toml", "rb") as f:
        structural = tomllib.load(f)["graph"]["structural"]
    lp_cfg = tmp / "etl_lp.toml"
    write_lp_config(lp_cfg, ETL_LP_EPOCHS, LP_HIDDEN, LP_EVAL_INTERVAL,
                    name="ETL_LP", graph={
                        **{s: str(big / "lp" / f"{s}.nt.gz")
                           for s in ("train", "valid", "test")},
                        "structural": structural})
    lp_art, lp_stages = etl_build(lp_cfg, tmp / "etl_lp_out")
    counters = start_path()
    t0 = time.perf_counter()
    res = run.run_cli(["-c", str(lp_cfg), "-i", str(lp_art), "-o",
                       str(tmp) + os.sep, "--dry_run", "--test"])
    wall = time.perf_counter() - t0
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in res.history]
    check(len(losses) == ETL_LP_EPOCHS
          and all(math.isfinite(x) for x in losses),
          f"etl lp: losses {losses}")
    forwards = 1 + sum((h["train_mrr"] is not None)
                       + (h["valid_mrr"] is not None) for h in res.history)
    want = lp_planned_launches(lp_art, lp_cfg, ETL_LP_EPOCHS, forwards)
    got = routed(launches)
    check(got == want, f"etl lp: launches {got}; the planner's {want}")
    secs = [h["seconds"] for h in res.history]
    lp = {"path": "etl_lp", "epochs": ETL_LP_EPOCHS, "loss": losses,
          "etl_stages_s": lp_stages, "first_epoch_s": secs[0],
          "epoch_s_after_first": secs[1:],
          "epoch_s_median_after_first": statistics.median(secs[1:]),
          "test_mrr": res.mrr, "peak_mem_bytes": peak, "cli_wall_s": wall,
          "launches": launches,
          "routes": {f"{n}.{k}": c for (n, k), c in got.items()}}
    print(f"[slice] {json.dumps(lp)}")

    # (e) the same graph in the other serialisations, built and trained
    with timed_part("etl (e) waiting for the workers"):
        serialised = serialisation_builds(pending, art, tmp)
    ttl = artifact_io.load(str(tmp / "etl_nc_turtle.npz"))
    nc_ttl = slice_phase(etl_work, tmp, "etl_nc_turtle",
                         {"sorted_scatter": 1, "fused_place_scatter": 2,
                          **dict.fromkeys(ENCODER_KERNELS, 2)},
                         F=ttl.F, features=ETL_FEATURES)
    check(nc_ttl["train_loss"][-1] < nc_ttl["train_loss"][0],
          f"etl turtle: the NC loss did not fall: {nc_ttl['train_loss']}")
    return {"etl_nc": dict(nc, etl=report), "etl_lp": lp,
            "etl_nc_turtle": dict(nc_ttl, serialisations=serialised)}


def build_with_files(cfg: Path, paths: dict, tmp: Path, tag: str) -> tuple:
    """``etl_build`` of a copy of ``cfg`` (``<tag>.toml``) whose ``[graph]``
    files are ``paths``, into ``<tag>_out``."""
    body = cfg.read_text()
    for split, path in paths.items():
        body = re.sub(rf"^{split} = .*$", f"{split} = {json.dumps(path)}",
                      body, count=1, flags=re.M)
    (tmp / f"{tag}.toml").write_text(body)
    return etl_build(tmp / f"{tag}.toml", tmp / f"{tag}_out")


def serialised_build(cfg: Path, files: dict, directory: Path,
                     serialisation: str, ext: str, tmp: Path,
                     tag: str) -> tuple:
    """``files`` written as ``serialisation`` under ``directory``
    (``serialise_graph``, skipped where ``serialisation`` is None) and
    built with ``cfg`` (``build_with_files``): the artifact's path, the
    host seconds by stage, the seconds the writing took and the files'
    bytes. A worker process's job in step (e) of the etl phase."""
    t0 = time.perf_counter()
    paths = files if serialisation is None else serialise_graph(
        files, directory, serialisation, ext)
    write_s = time.perf_counter() - t0
    built, stages = build_with_files(cfg, paths, tmp, tag)
    return built, stages, write_s, sum(Path(p).stat().st_size
                                       for p in paths.values())


def start_serialisations(pool, cfg: Path, graph: dict, data: Path,
                         tmp: Path) -> dict:
    """The etl phase's step (e), handed to ``pool``'s worker processes so
    that it runs beside steps (b) to (d): ``graph``'s N-Triples files
    (step (a)) written again as gzipped Turtle, RDF/XML and JSON-LD by
    ``serialise_graph``, each built by ``mkdataset``'s CLI with ``cfg``;
    ``benchmarks/parity/big``'s NC graph built from its N-Triples and
    from TriG and from Turtle, RDF/XML and JSON-LD under ``.n3``,
    ``.owl`` and ``.json`` names. Returns the futures by key
    (``serialisation_builds`` reads them)."""
    files = {k: v for k, v in graph.items() if k != "structural"}
    jobs = {serialisation: (cfg, files, data / serialisation,
                            serialisation, ext, tmp, f"etl_{serialisation}")
            for serialisation, ext in SERIALISATIONS.items()}
    big = ROOT / "benchmarks" / "parity" / "big"
    nt = {split: str(big / "nc" / f"{split}.nt.gz")
          for split in ("context", "train", "valid", "test")}
    jobs["parity.nt"] = (big / "nc_config.toml", nt, None, None, None, tmp,
                         "parity_nt")
    for serialisation, ext in (("trig", ".trig"), ("turtle", ".n3"),
                               ("rdfxml", ".owl"), ("jsonld", ".json")):
        jobs[f"parity{ext}"] = (big / "nc_config.toml", nt,
                                data / f"parity{ext}", serialisation, ext,
                                tmp, f"parity_{ext[1:]}")
    return {key: pool.submit(serialised_build, *args)
            for key, args in jobs.items()}


def serialisation_builds(pending: dict, art: Path, tmp: Path) -> dict:
    """Step (e)'s builds (``start_serialisations``) held array for array
    to their N-Triples builds: the DMG-scale graph's to ``art`` (step
    (b)'s), the Turtle build kept as ``etl_nc_turtle.npz`` for training;
    the parity graph's to its own. Returns the seconds and bytes of
    each, taken in worker processes that ran beside each other and
    beside steps (b) to (d)."""
    from mrgcn_tpu_torch.data import artifact as artifact_io
    want = artifact_io.load(str(art))
    out = {}
    for serialisation in SERIALISATIONS:
        built, stages, write_s, size = pending[serialisation].result()
        check(same_artifacts(artifact_io.load(str(built)), want),
              f"etl: the {serialisation} build differs from N-Triples'")
        if serialisation == "turtle":
            shutil.copy(built, tmp / "etl_nc_turtle.npz")
        out[serialisation] = {"write_s": write_s, "stages_s": stages,
                              "file_bytes": size}
        print(f"[etl] {serialisation}: {json.dumps(out[serialisation])}")
    reference = pending.pop("parity.nt").result()[0]
    want = artifact_io.load(str(reference))
    for key, future in pending.items():
        if key.startswith("parity"):
            built, stages, _, _ = future.result()
            check(same_artifacts(artifact_io.load(str(built)), want),
                  f"etl: the parity graph's {key[6:]} build differs from "
                  "N-Triples'")
            out[key] = {"stages_s": stages}
    print("[etl] the parity graph as .trig, .n3, .owl and .json: each "
          "build equals the N-Triples build")
    return out


# kernel -> (source, the TPU kernel it replaces, the timed row that goes
# into the kernels line: the call its main path makes)
# the mesh phase: epochs of the full-width worlds (DMG-width featureless
# NC, FB15k-237-width LP), of the small parity graph's, of node-sliced LP
MESH_EPOCHS, MESH_SMALL_EPOCHS, MESH_SLICED_EPOCHS = 3, 2, 1
# the worlds that share the one card over gloo (or take a card a rank
# over NCCL), and the jobs of ``mesh_jobs`` each runs: the small graphs'
# only in "2x2", where rows split over data and basis weights over model
MESH_WORLDS = {"2": ("dmg", "lp"),
               "2x2": ("dmg", "lp", "mm", "am", "lp_sliced")}


def mesh_jobs(work, tmp: Path) -> dict:
    """The mesh phase's workloads as ``parallel.parity`` jobs (configs
    without a mesh; each world adds its spec): featureless NC at DMG
    width, full-graph LP at FB15k-237 width (the artifact ``main`` wrote),
    multimodal and all-modality NC on the small parity graph (the image
    CNN in f64, its twin: the bf16 body drifts by bf16 steps under batch
    statistics between any two sums, and in f32 one ReLU input on the
    other side of zero in a rank's order of sums moves gradients by
    percents) and node-sliced LP on a small LP graph (its ReLU inputs
    kept)."""
    from mrgcn_tpu_torch import run
    from mrgcn_tpu_torch.tasks.synthetic import (multimodal_features,
                                                 save_lp_artifact,
                                                 save_nc_artifact)
    small = small_graph()
    feats = dict(seed=0, num_numeric=600, num_years=300, num_strings=240,
                 max_len=128)
    specs = {
        "dmg": (work, None, (), MESH_EPOCHS),
        "mm": (small, multimodal_features(small["n"], **feats), MULTIMODAL,
               MESH_SMALL_EPOCHS),
        "am": (small, multimodal_features(
            small["n"], num_geometries=300, num_images=120,
            image_size=IMAGE_SIDE, **feats), ALLMODAL, MESH_SMALL_EPOCHS)}
    jobs = {}
    for tag, (graph, F, features, epochs) in specs.items():
        art, cfg = tmp / f"mesh_{tag}.npz", tmp / f"mesh_{tag}.toml"
        save_nc_artifact(str(art), graph["n"], graph["R"], graph["src"],
                         graph["dst"], graph["rel"], graph["norm"],
                         graph["labels_idx"], graph["labels_cls"],
                         graph["num_classes"], seed=0,
                         num_eval=min(1000, graph["n"] // 20), F=F)
        write_config(cfg, epochs, graph["num_bases"], graph["hidden"],
                     features=features)
        jobs[tag] = {"task": "nc", "artifact": str(art),
                     "config": run.load_config(str(cfg)),
                     "featureless": F is None, "image_f64": tag == "am"}
    cfg = tmp / "mesh_lp.toml"
    write_lp_config(cfg, MESH_EPOCHS, LP_HIDDEN, eval_interval=MESH_EPOCHS)
    jobs["lp"] = {"task": "lp", "artifact": str(tmp / "lp.npz"),
                  "config": run.load_config(str(cfg))}
    art, cfg = tmp / "mesh_lp_small.npz", tmp / "mesh_lp_sliced.toml"
    save_lp_artifact(str(art), num_nodes=3000, num_props=12,
                     num_train=20_000, num_valid=1000, num_test=1500, seed=0)
    write_lp_config(cfg, MESH_SLICED_EPOCHS, LP_HIDDEN,
                    eval_interval=MESH_SLICED_EPOCHS, full_graph=False)
    jobs["lp_sliced"] = {"task": "lp", "artifact": str(art), "relu": True,
                         "config": run.load_config(str(cfg))}
    return jobs


# encoders held by norm, each as one vector of all its gradients: the
# from-scratch text encoder's body is bf16 (a rank sums its rows'
# gradients in bf16, the embedding's backward among them, and the ranks'
# sums meet in f32: they differ from one device's by bf16 steps)
MESH_NORM_ENCODERS = ("xsd_string_", "xsd_anyURI_")
MESH_NORM_RTOL = 1e-2


def relative_max(got: dict, want: dict) -> dict:
    """Each gradient's largest difference over the largest entry of
    ``want``; an encoder of ``MESH_NORM_ENCODERS`` as one entry (``name.*``),
    the norm of its gradients' difference over the norm of its gradients.
    A convolution's bias ahead of BatchNorm has gradient 0 in exact
    arithmetic: its difference is taken over its encoder's largest
    gradient entry."""
    import numpy as np
    out, groups = {}, {}
    for name, w in want.items():
        d = got[name] - w
        top = name.split(".")[0]
        if name.startswith(MESH_NORM_ENCODERS):
            e, n = groups.get(top, (0.0, 0.0))
            groups[top] = (e + float(np.square(d).sum()),
                           n + float(np.square(w).sum()))
            continue
        scale = float(np.abs(w).max())
        if re.search(r"\.Conv_\d+\.bias$", name):
            scale = max(float(np.abs(v).max()) for k, v in want.items()
                        if k.startswith(top + "."))
        out[name] = float(np.abs(d).max() / max(scale, 1e-30))
    for top, (e, n) in groups.items():
        out[f"{top}.*"] = (e / max(n, 1e-60)) ** 0.5
    return out


def launch_world(spec: str, backend: str, devices, jobs: dict) -> tuple:
    """One world's ranks on ``devices`` over ``backend`` through
    ``parallel.mesh.launch``, each running the first step and the task's
    own ``run`` of each of ``jobs`` under mesh ``spec``: the ranks'
    results in rank order and the seconds from the first spawn to the
    last join."""
    from mrgcn_tpu_torch.parallel import mesh as pmesh
    from mrgcn_tpu_torch.parallel import parity
    mine = []
    for tag, job in jobs.items():
        config = parity.with_mesh(job["config"], spec)
        mine += [{**job, "work": "first_step", "config": config},
                 {**job, "work": "train", "config": config}]
    t0 = time.perf_counter()
    ranks = pmesh.launch(parity.rank_worker, len(devices), backend, devices,
                         args=(mine,))
    return ranks, time.perf_counter() - t0


def mesh_world(label: str, spec: str, backend: str, devices, jobs: dict,
               launched: tuple, refs: dict, smi: str) -> dict:
    """One world's ranks (``launch_world``'s ``launched``): the first step
    and the tasks' own ``run`` of each job, held against the
    single-device run on this card (``refs``): the first step's loss
    within 1e-5 relative and every gradient within 1e-4 of its largest
    entry; later epochs' losses within 1e-3 relative, NC test accuracy
    within one test node; the trained state bit-equal on every rank;
    each rank's launches by kernel and route equal to the single-device
    run's. Prints the epoch times, the bytes handed to the collectives per
    step and each rank's peak memory, all of ranks sharing one card where
    the devices repeat."""
    ranks, wall = launched
    print(f"[mesh] {label}: {len(devices)} ranks, {len(jobs)} jobs, "
          f"{wall:.1f} s from the first spawn to the last join (beside the "
          "other worlds)")
    shared = len(set(map(str, devices))) < len(devices)
    summary = {"world": label, "spec": spec, "backend": backend,
               "ranks": len(devices), "wall_s": wall, "jobs": {}}
    for j, tag in enumerate(jobs):
        first = [r[2 * j] for r in ranks]
        runs = [r[2 * j + 1] for r in ranks]
        ref_first, ref_run = refs[tag]["first"], refs[tag]["train"]
        what = f"mesh {label} {tag}"
        loss_err = abs(first[0]["loss"] - ref_first["loss"]) \
            / abs(ref_first["loss"])
        grad_err = relative_max(first[0]["grads"], ref_first["grads"])
        stat_err = relative_max(first[0]["batch_stats"],
                                ref_first["batch_stats"])
        key = "train_loss" if ref_run["history"] and \
            "train_loss" in ref_run["history"][0] else "loss"
        got_l = [h[key] for h in runs[0]["history"]]
        want_l = [h[key] for h in ref_run["history"]]
        later = max(abs(a - b) / abs(b) for a, b in zip(got_l, want_l))
        flips = None
        if "relu_inputs" in ref_first:
            flips = {i: int(((first[0]["relu_inputs"][i] > 0)
                             != (y > 0)).sum())
                     for i, y in ref_first["relu_inputs"].items()}
        report = {
            "first_loss_rel_err": loss_err,
            "grad_err_max": max(grad_err.values()),
            "grad_err_worst": max(grad_err, key=grad_err.get),
            "grad_err_by_module": {
                top: max(e for k, e in grad_err.items()
                         if k.split(".")[0] == top)
                for top in {k.split(".")[0] for k in grad_err}},
            "batch_stats_rel_err_max": max(stat_err.values(), default=0.0),
            "losses": got_l, "single_device_losses": want_l,
            "later_loss_rel_err": later,
            "epoch_s_by_rank": [[h["seconds"] for h in r["history"]]
                                for r in runs],
            "single_device_epoch_s": [h["seconds"]
                                      for h in ref_run["history"]],
            "bytes_per_step_by_rank": [r["bytes_per_step"] for r in runs],
            "first_step_wall_s": first[0]["wall_s"],
            "run_wall_s": runs[0]["wall_s"],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in runs],
            "single_device_peak_bytes": ref_run["peak_bytes"],
            "launches_rank0": runs[0]["launches"],
            **({"relu_flips_first_step": flips} if flips is not None
               else {})}
        if "acc" in ref_run:
            n_test = len(ref_run["labels"])
            report["test_acc"] = [runs[0]["acc"], ref_run["acc"]]
        summary["jobs"][tag] = report
        print(f"[mesh] {label} {tag} ({smi}; ranks sharing one card, not a "
              f"scaling figure)" if shared else
              f"[mesh] {label} {tag} ({smi})", json.dumps(report))
        check(loss_err <= 1e-5, f"{what}: first loss rel err {loss_err}")
        check(all(err <= (MESH_NORM_RTOL if name.endswith(".*") else 1e-4)
                  for name, err in grad_err.items()),
              f"{what}: gradients {grad_err}")
        check(max(stat_err.values(), default=0.0) <= 1e-5,
              f"{what}: running statistics {stat_err}")
        check(later <= 1e-3, f"{what}: losses {got_l} vs {want_l}")
        check(len({r["digest"] for r in runs}) == 1,
              f"{what}: the ranks' trained states differ")
        if "acc" in ref_run:
            check(abs(runs[0]["acc"] - ref_run["acc"]) * n_test <= 1 + 1e-6,
                  f"{what}: test accuracy {runs[0]['acc']} vs "
                  f"{ref_run['acc']}")
        for r in runs:
            check(r["launches"] == ref_run["launches"],
                  f"{what}: rank {r['rank']} launched {r['launches']}, the "
                  f"single-device run {ref_run['launches']}")
    return summary


def mesh_phase(work, tmp: Path, smi: str) -> dict:
    """Multi-device training on the card: (a) a world of one rank over
    NCCL through ``parallel.mesh.launch``, its collectives sent through
    NCCL although the groups hold one rank (``one_rank_collectives``):
    featureless DMG-width NC trained, its losses the single-device run's
    to the bit (else within 1e-5, where a second single-device run does
    not repeat the first to the bit: layer 1's ``index_add_`` sums in
    another order each run),
    and the multimodal first step (the encoders' all-gathers and their
    reduce-scatters) held as (b) holds it; (b) worlds ``"2"`` and
    ``"2x2"`` on this one card over gloo (NCCL refuses two ranks on one
    GPU), each holding its jobs of ``MESH_WORLDS`` against the
    single-device run (``mesh_world``); (c) the same over NCCL, one card a
    rank, where there are two cards or more. The worlds run side by side
    (their times are not scaling figures). Returns each world's launch
    counts by path for the kernels line."""
    import concurrent.futures
    import torch
    from mrgcn_tpu_torch.parallel import mesh as pmesh
    from mrgcn_tpu_torch.parallel import parity
    t_phase = time.perf_counter()
    jobs = mesh_jobs(work, tmp)
    refs = {}
    for tag, job in jobs.items():
        start_path()
        refs[tag] = {"first": parity.first_step(job),
                     "train": parity.train(job)}
    # (b) gloo worlds sharing this card; (c) NCCL over cards
    worlds = [(f"gloo {spec}", spec, "gloo") for spec in MESH_WORLDS]
    cards = torch.cuda.device_count()
    if cards >= 2:
        worlds += [(f"nccl {spec}", spec, "nccl") for spec in MESH_WORLDS
                   if math.prod(pmesh.mesh_shape(spec)) <= cards]
    else:
        print(f"mesh nccl multi-card: not run ({cards} card)")
    devices = {}
    for label, spec, backend in worlds:
        data, model = pmesh.mesh_shape(spec)
        devices[label] = ["cuda:0"] * (data * model) if backend == "gloo" \
            else [f"cuda:{i}" for i in range(data * model)]
    paths = {}
    # (a) NCCL on the card, one rank, every collective through NCCL
    one_rank = {"one_rank_collectives": True}
    with concurrent.futures.ThreadPoolExecutor(len(worlds) + 1) as pool:
        launched_one = pool.submit(
            pmesh.launch, parity.rank_worker, 1, "nccl", ["cuda:0"], args=([
                {**jobs["dmg"], **one_rank, "work": "train",
                 "config": parity.with_mesh(jobs["dmg"]["config"], "1x1")},
                {**jobs["mm"], **one_rank, "work": "first_step",
                 "config": parity.with_mesh(jobs["mm"]["config"],
                                            "1x1")}],))
        launched = {label: pool.submit(
            launch_world, spec, backend, devices[label],
            {tag: jobs[tag] for tag in MESH_WORLDS[spec]})
            for label, spec, backend in worlds}
        paths["mesh_nccl_1_dmg"] = one_rank_world(
            launched_one.result()[0], jobs, refs)
        for label, spec, backend in worlds:
            summary = mesh_world(
                label, spec, backend, devices[label],
                {tag: jobs[tag] for tag in MESH_WORLDS[spec]},
                launched[label].result(), refs, smi)
            for tag, report in summary["jobs"].items():
                paths[f"mesh_{backend}_{spec}_{tag}"] = {
                    "launches": report["launches_rank0"]}
    print(f"[mesh] the phase took {time.perf_counter() - t_phase:.1f} s")
    return paths


def one_rank_world(one, jobs: dict, refs: dict) -> dict:
    """The mesh phase's (a): the one NCCL rank's trained DMG run and
    multimodal first step (``one``) against the single-device runs
    (``refs``). Returns the run's launch counts."""
    from mrgcn_tpu_torch.parallel import parity
    run, first = one
    got = [h["train_loss"] for h in run["history"]]
    want = [h["train_loss"] for h in refs["dmg"]["train"]["history"]]
    bits = run["digest"] == refs["dmg"]["train"]["digest"]
    # a second single-device run only where the losses differ: does that
    # run repeat itself to the bit?
    repeats = got == want or parity.train(jobs["dmg"])["digest"] \
        == refs["dmg"]["train"]["digest"]
    traffic = {k: run["traffic"][k] + first["traffic"][k]
               for k in run["traffic"]}
    grad_err = relative_max(first["grads"], refs["mm"]["first"]["grads"])
    loss_err = abs(first["loss"] - refs["mm"]["first"]["loss"]) \
        / abs(refs["mm"]["first"]["loss"])
    print(f"[mesh] nccl 1 rank dmg losses {got}, single device {want}; "
          f"the state equal to the bit: {bits}; the losses equal, or the "
          f"single-device run repeats itself to the bit: {repeats}; bytes "
          f"through NCCL "
          f"{traffic}; mm first step: loss rel err {loss_err}, worst "
          f"gradient {max(grad_err.values())} "
          f"({max(grad_err, key=grad_err.get)})")
    if repeats:
        check(got == want, "mesh nccl 1 rank: losses differ from the "
              "single-device run, which repeats itself to the bit")
    else:
        check(max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-5,
              f"mesh nccl 1 rank: losses {got} vs {want}")
    check(all(v > 0 for v in traffic.values()),
          f"mesh nccl 1 rank: a collective did not run: {traffic}")
    check(loss_err <= 1e-5 and all(
        err <= (MESH_NORM_RTOL if name.endswith(".*") else 1e-4)
        for name, err in grad_err.items()),
        f"mesh nccl 1 rank mm: loss {loss_err}, gradients {grad_err}")
    return {"launches": run["launches"]}


SOURCES = {
    "sorted_scatter": ("mrgcn_tpu_torch/csrc/sorted_scatter.cu",
                       "mrgcn_tpu/ops/pallas_gather.py:247", "dense_bwd_h"),
    "sorted_gather": ("mrgcn_tpu_torch/csrc/sorted_gather.cu",
                      "mrgcn_tpu/ops/pallas_gather.py:99", "lp_fwd"),
    "fused_scatter_dot": ("mrgcn_tpu_torch/csrc/scatter_dot.cu",
                          "mrgcn_tpu/ops/pallas_gather.py:379", "lp_bwd_h"),
    "fused_place_scatter": ("mrgcn_tpu_torch/csrc/fused_place_scatter.cu",
                            "mrgcn_tpu/ops/pallas_gather.py:712", "lp_fwd"),
    "compose_grad_pass": ("mrgcn_tpu_torch/csrc/compose.cu",
                          "mrgcn_tpu/ops/pallas_gather.py:621", "dmg"),
    "compose_table": ("mrgcn_tpu_torch/csrc/compose.cu",
                      "benchmarks/micro_compose_kernel.py:43", "dmg"),
    "canonical_copy": ("mrgcn_tpu_torch/csrc/compose.cu",
                       "benchmarks/micro_compose_fusion.py:94", "dmg"),
    "attention_fwd": ("mrgcn_tpu_torch/csrc/fused_attention.cu",
                      "mrgcn_tpu/ops/attention.py:44", "slice"),
    "attention_bwd": ("mrgcn_tpu_torch/csrc/fused_attention.cu",
                      "mrgcn_tpu/ops/attention.py:59", "slice"),
    "mlp_fwd": ("mrgcn_tpu_torch/csrc/fused_mlp.cu",
                "mrgcn_tpu/ops/fused_mlp.py:38", "slice"),
    "mlp_bwd": ("mrgcn_tpu_torch/csrc/fused_mlp.cu",
                "mrgcn_tpu/ops/fused_mlp.py:48", "slice"),
    # #12: the multi-head path (the Pallas TPU FlashAttention forward, dq
    # and dkv kernels behind _flash_attention_fn); the grouped-head
    # kernels, counted apart in the wrappers' launches_heads
    "attention_heads_fwd": ("mrgcn_tpu_torch/csrc/fused_attention_heads.cu",
                            "mrgcn_tpu/models/encoders.py:150",
                            "h4_8000x128"),
    "attention_heads_bwd": ("mrgcn_tpu_torch/csrc/fused_attention_heads.cu",
                            "mrgcn_tpu/models/encoders.py:150",
                            "h4_8000x128"),
}
# a kernel whose launches stand under another key of read_launches
COUNTED_AS = {"attention_heads_fwd": "attention_fwd.heads",
              "attention_heads_bwd": "attention_bwd.heads"}
# the scatters' kernels: (the row-segmented one, counted in the wrapper's
# launches_rows; the other route's, counted in the rest of its launches)
ROW_KERNELS = {
    "sorted_scatter": ("place_rows_kernel", "sorted_scatter_kernel"),
    "fused_place_scatter": ("place_rows_kernel",
                            "fused_place_split_kernel"),
    "fused_scatter_dot": ("scatter_dot_rows_kernel", None)}
STREAM_KERNELS = ("sorted_scatter", "sorted_gather", "fused_scatter_dot",
                  "fused_place_scatter")
ENCODER_KERNELS = ("attention_fwd", "attention_bwd", "mlp_fwd", "mlp_bwd")
PHASES = ("stream", "compose", "nc", "backbones", "backbones_bert",
          "minibatch", "lp", "wide_basis", "checkpoint", "etl", "encoders",
          "text_attn", "agree", "mesh")
EXTRA_PHASES = ("profile", "profile_mb", "profile_att",   # only with
                "profile_mm", "profile_stream",            # --only
                "profile_allmodal", "profile_backbones",
                "conv_algorithms", "scatter_dot")


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
    from mrgcn_tpu_torch.utils.device import (measure_conv_algorithms,
                                              pin_float32_precision)

    pin_float32_precision()
    measure_conv_algorithms()
    smi = card()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build_kernels()
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        """Print the seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        print(f"[time] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    rows = {name: [] for name in SOURCES}
    paths = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        work = build_workload(seed=0)
        save_lp_artifact(str(tmp / "lp.npz"), seed=0)
        plan, num_relations = lp_plans(tmp / "lp.npz", device)
        lap("workloads")
        if "stream" in phases or "scatter_dot" in phases:
            scatter_dot_phase(plan, device, rows)
        if "stream" in phases:
            nc_stream_phase(work, device, rows)
            lp_stream_phase(plan, device, rows)
            adversarial_phase(device, rows)
            lap("stream")
        if "compose" in phases:
            paths["compose_stages"] = compose_phase(work, device, rows)
            lap("compose")
        F = multimodal_features(work["n"], seed=0) \
            if {"nc", "minibatch"} & set(phases) else None
        if "nc" in phases:
            # per step, forward and backward: layer 0's identity half
            # place-scatters on its row-sorted fwd and bwd_table streams;
            # with features the dense half adds the split walk on its
            # relation-constant fwd and sorted_scatter on its row-sorted
            # bwd_h; two text blocks, forward and backward
            paths["nc_featureless"] = slice_phase(
                work, tmp, "dmg_synth", {"fused_place_scatter": 2})
            paths["nc_multimodal"] = slice_phase(
                work, tmp, "dmg_synth_multimodal",
                {"sorted_scatter": 1, "fused_place_scatter": 3,
                 **dict.fromkeys(ENCODER_KERNELS, 2)}, F=F)
            # all five modalities: X_width 165, so the dense half packs
            # one row a line (k = 1, 256 lanes); the same kernels a step
            paths["nc_allmodal"] = slice_phase(
                work, tmp, "dmg_synth_allmodal",
                {"sorted_scatter": 1, "fused_place_scatter": 3,
                 **dict.fromkeys(ENCODER_KERNELS, 2)},
                F=allmodal_features(work["n"]), features=ALLMODAL)
            lap("nc")
        if "backbones" in phases:
            paths.update(backbones_phase(work, tmp))
            lap("backbones")
        if "backbones_bert" in phases:
            paths.update(text_backbone_phase(work, tmp, smi))
            lap("backbones_bert")
        if "minibatch" in phases:
            paths.update(minibatch_phase(work, tmp, F))
            lap("minibatch")
        if "lp" in phases:
            paths["lp"] = lp_slice_phase(tmp, plan, num_relations, device)
            lap("lp")
        if "wide_basis" in phases:
            wide_basis_phase(tmp, plan, device, smi, rows)
            lap("wide_basis")
        if "checkpoint" in phases:
            paths.update(checkpoint_phase(work, tmp))
            lap("checkpoint")
        if "etl" in phases:
            paths.update(etl_phase(work, tmp))
            lap("etl")
        if "profile_stream" in phases:
            profile_stream_phase(work, plan, device)
        del plan
        torch.cuda.empty_cache()
        if "profile" in phases:
            profile_phase(work, tmp, device)
        if "profile_mb" in phases:
            profile_minibatch_phase(work, tmp, device)
        if "profile_att" in phases:
            profile_attention_phase(device)
        if "profile_mm" in phases:
            profile_multimodal_phase(work, tmp, device)
        if "profile_allmodal" in phases:
            profile_multimodal_phase(work, tmp, device, features=ALLMODAL)
        if "profile_backbones" in phases:
            files = backbone_files(tmp)
            try:
                profile_multimodal_phase(work, tmp, device,
                                         features=ALLMODAL, backbones=True)
            finally:
                os.environ.pop("HF_HUB_CACHE", None)
                os.environ.pop("MRGCN_VISION_WEIGHTS", None)
            del files
        if "encoders" in phases:
            with timed_part("encoders kernel cases"):
                rows.update(encoder_kernel_phase(device))
            with timed_part("encoders conv card vs CPU"):
                conv_encoder_phase(device)
            lap("encoders")
        if "text_attn" in phases:
            paths.update(text_attn_phase(work, tmp, device, rows))
            lap("text_attn")
        if "conv_algorithms" in phases:
            conv_algorithm_phase()
        if "agree" in phases:
            with timed_part("agree NC"):
                agreement_phase(tmp)
            save_lp_artifact(str(tmp / "lp_small.npz"), num_nodes=3000,
                             num_props=12, num_train=20_000, num_valid=1000,
                             num_test=1500, seed=0)
            with timed_part("agree LP"):
                lp_agreement(tmp, "lp_small", 3, budget=2 ** 20, ranks=True)
                lp_agreement(tmp, "lp_small", 3, ranks=True,
                             sliced=(256, 500))
                lp_agreement(tmp, "lp", 1)     # full width: one step
            lap("agree")
        if "mesh" in phases:
            paths.update(mesh_phase(work, tmp, smi))
            lap("mesh")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[card] {smi}")
    if only:
        print(f"phases {only} passed; the whole run prints the result line")
        return

    kernels = []
    for name, (source, replaces, record) in SOURCES.items():
        timed = next(r for r in rows[name] if r["label"] == record)
        by_path = {p: summary["launches"][COUNTED_AS.get(name, name)]
                   for p, summary in paths.items()}
        # sorted_gather is the autograd backward of sorted_scatter, which
        # no entry point of the port differentiates (the layer ops carry
        # their own backward): it reads 0 on every path and is launched by
        # the basis gradient check, whose count stands beside
        check(sum(by_path.values()) > 0 or name == "sorted_gather",
              f"{name} launched on no path")
        routes = {}
        if name in ROW_KERNELS:
            for summary in paths.values():
                for kernel, n in by_route(summary["launches"],
                                          name).items():
                    routes[kernel] = routes.get(kernel, 0) + n
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **({"launches_by_kernel": routes} if len(routes) > 1 else {}),
            "gradient_check_launches":
                paths["lp"]["gradient_check_launches"].get(name, 0),
            "shape": record,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            **{key: timed[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bytes", "flops", "bound_f32_fma_ms", "place_dot_ms",
                "ex2", "bound_terms_ms", "fraction_of_bound")
               if key in timed},
            "ms_by_case": {r["label"]: r["ms"] for r in rows[name]
                           if "ms" in r}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
