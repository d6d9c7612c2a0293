#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py            # the full run, on one CUDA card
    python3 chip_smoke.py --small    # a short first run after a kernel edit
                                     # (every phase, the apps included, small)
    python3 chip_smoke.py --profile  # only the out-of-core path, traced and
                                     # profiled: where its wall time goes,
                                     # and each tile's host enqueue and
                                     # compute-stream window by its graph
                                     # mode (heat, and CloverLeaf 2D at
                                     # 4096^2 in 24 tiles)
    python3 chip_smoke.py --disk     # only phase 8 and the CloverLeaf 2D runs
                                     # of phase 7 it is held against
    python3 chip_smoke.py --mesh     # only phase 9 and the same two runs
    python3 chip_smoke.py --serve    # only phase 10 and the same two runs
    python3 chip_smoke.py --model    # only phase 11, model decode
    python3 chip_smoke.py --moe      # only phase 12, moe decode
    python3 chip_smoke.py --ssm      # only phase 13, ssm, hybrid and encdec decode
    python3 chip_smoke.py --train    # only phase 14, training
    python3 chip_smoke.py --lm-mesh  # only phase 15, the LM mesh paths
    python3 chip_smoke.py --analysis # only phase 16, the step analysis (with
                                     # its own dry run of phase 15's cells)
    python3 chip_smoke.py --examples # only phase 17, the port's examples

Phases, each of which asserts (any failure exits non-zero):

1. device — the card's name and power limit;
2. build — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``;
3. kernels — each hand-written kernel at the main path's shapes, at the
   reference test shapes and at the edges of its tiling, in fp32 and bf16,
   held against its plain PyTorch version on the card (``torch.equal`` in
   both types, ``chain2d`` in fp32; its bf16 atol 2e-2) and timed with
   CUDA events beside its bound, the plain version and a cuDNN convolution
   computing the same sweep (``stencil3d`` in bf16 too, though no path
   launches it): the median of launches timed one at a time (``ms``, the
   host's time to launch included) and the mean of launches queued back to
   back (``queued_ms``), beside a contiguous device copy moving the same
   bytes (``contig_copy_ms``); ``stencil2d`` and ``stencil3d`` also at the edges
   of the tilings that ``ops.stencil2d_tiling`` and
   ``ops.stencil3d_tiling`` report (widths and heights around one tile or
   strip, depths around one z segment, every row alignment, one-plane,
   one-row and one-column interiors, inputs at storage offsets of 1 to 7
   elements), and ``stencil2d`` at 16384^2 beside a device-to-device copy
   of its interior; ``chain2d`` also at the reference's chain shapes,
   ragged ones and every K up to one launch's limit, its fp32 result
   ``torch.equal`` to K launches of ``stencil2d``;
4. kernel path — the quickstart heat program on ``Session("cuda")`` (2-D,
   16384^2 interior, 4 steps) and a 3-D heat program (512^3, 2 steps),
   checked against ``Session("reference")`` (rtol 1e-4, atol 1e-5); kernel
   launch counts are zeroed just before and read just after;
5. chain2d path — ``repro_torch.kernels.chain2d`` at a 16384^2 interior for
   K in 1, 2, 4, 8, 16 and 24 (one launch runs at most 12 sweeps, so 16
   and 24 run in two passes) in fp32 and K = 8 in bf16, its launch count
   zeroed just before and read just after; then each result held against
   the plain version (and, in fp32, ``torch.equal`` to K launches of
   ``stencil2d``), and the kernel, the plain version, K x ``stencil2d``,
   K x ``F.conv2d`` (no single PyTorch call computes K sweeps) and the
   bound timed (with ``queued_ms`` and ``contig_copy_ms`` as in phase 3),
   beside the fused-against-unfused traffic model of
   ``benchmarks/kernel_bench.py`` for the kernel's actual tiling;
6. out-of-core path — the 2-D heat program plus a sum/min summary loop at a
   24576^2 interior (u and tmp homes: 4.83 GB, pinned) on
   ``Session("ooc")`` with a device capacity of a third of the homes, then on
   ``"ooc-async"`` (bit-identical to ``ooc``), then on ``"cuda"`` (fields
   atol 1e-5, reductions rtol 1e-3).  ``ooc`` and ``ooc-async`` run under a
   hard cap on the process's device memory at their capacity
   (``memory_cap``), and their peak must stay within the capacity (and below
   the homes' size); each prints the workspace its plans charged
   (``core/workspace.py``) beside its tiles.  Each run's tile graphs (``core/tile_graph.py``: the tile
   function as CUDA graphs) are printed: warm-ups, captures, replays,
   capture seconds, pool bytes, beside the peak over the capacity.  Then
   one- and two-slot pools, whose slots are reused at once, at a quarter of
   the size, against ``"cuda"``;
7. apps path — the paper's applications from ``repro_torch.apps`` at a third
   of their homes: CloverLeaf 2D at an 8192^2 interior (25 homes, 6.72 GB,
   pinned; capacity 2.24 GB; 4 steps, a field summary every 2) on ``ooc``,
   ``ooc-async`` (bit-identical to ``ooc``), ``resident`` (the in-core
   baseline) and ``reference``, all on the card, with one record per
   Session chain (tiles, splits, wall, plan seconds, cache hits, its tile
   graphs' warm-ups, captures, replays, capture seconds and pool bytes), the
   lanes' bytes and rates, the workspace each chain's plan charged, peak
   device memory (within the capacity under a hard cap at it on ``ooc`` and
   ``ooc-async``, ``memory_cap``; below the homes; the peak reserved beside
   it) and the paper's resident-over-out-of-core ratio of
   wall per step.  Every timestep chain of ``ooc`` and ``ooc-async`` must
   replay at least one tile graph, and one more step of ``ooc``, run after
   its records, fields and digests are taken, holds every replay of its
   timestep chain against the eager tile function on cloned slots
   (``torch.equal``, ``TileGraphs.check_replays``); then CloverLeaf 3D and
   OpenSBLI (two timesteps a chain) at 256^3, 2 steps on ``ooc`` (no hard
   cap; the peak over the capacity printed) against ``reference``.
   Fields rtol 1e-4 / atol 1e-5, summaries rtol 1e-3;
8. disk tier — CloverLeaf 2D at phase 7's size with its homes on disk,
   under ``build/spill/`` (deleted at the end; the phase first checks the
   free space and fails if it is short): ``mmap`` homes on ``ooc`` with the
   host budget at a third of the homes, so the plans carry FetchHome and
   SpillHome for the disk lane, and ``debug=True``, so every plan is
   verified before it runs; checkpointed at step 2 and resumed in a new app
   and Session; then ``chunked`` homes (lossless ``shuffle-rle``; in the
   whole run in a child process started before the ``mmap`` runs, which
   overlaps them and phase 9 on other cores and is joined before phase
   10).  Fields bit-identical to phase 7's RAM-home ``ooc`` run (every home's digest,
   where the tile counts match; else rtol 1e-4 / atol 1e-5 of
   ``reference``), the resume bit-identical to the uninterrupted run.
   Records: wall per step (planning, verify, the rest), disk bytes, home
   fetches and spills, the disk lane's busy seconds, H2D/D2H GB/s beside
   phase 7's pinned RAM homes, peak device memory, checkpoint and restore
   seconds, the spill directory's free bytes;
9. sharded execution — CloverLeaf 2D at phase 7's size on four shards:
   ``mesh="sim:4"`` along dim 1 (the skirt sized automatically), each
   shard out of core at a quarter of phase 7's capacity, traced for the
   mesh spans, on ``ooc-sharded`` and then ``ooc-async`` (bit-identical to
   it), 2 steps (``CUT_STEPS``; phase 7 records its ``ooc`` and
   ``reference`` runs after step 2 as well, for this and phase 10).  Fields
   rtol 1e-4 / atol 1e-5 and summaries rtol 1e-3 of phase 7's
   ``reference`` run at step 2, the difference to phase 7's ``ooc`` run printed, the
   plans' halo messages and bytes equal to the achieved ones, peak device
   memory below the homes.  Records per step: wall, planning seconds summed
   over the shards, scatter / gather / exchange seconds from the mesh
   spans, halo traffic; the lanes' GB/s, peak device memory, pinned host
   bytes.  Then ``distributed.exchange_halos`` on the card (four buffers
   at these widths and depth on ``cuda:0``, non-periodic and periodic),
   ``torch.equal`` to the CPU, timed beside its bound; and a ``cuda:N``
   mesh bit for bit against ``sim:N`` where the machine has two or more
   cards (else a ``mesh_cuda`` record says it did not run).  Every phase 9
   record carries the card's ``nvidia-smi`` name and power limit;
10. serving — four CloverLeaf 2D tenants at phase 7's size (4 x 6.72 GB of
   pinned homes), 2 steps each, each run from its own thread through one
   ``repro_torch.serve.StencilServer("sim:2")``: two lanes on the card,
   each computing on its own stream, ``sjf``, priorities 0, 1, 0, 1,
   phase 7's ``hw``, capacity and prefetch, traced, the plans shared
   through the server's cache; tenant ``t0`` is preempted after its second
   chain (a checkpoint under ``build/spill/serve``, deleted at the end,
   then a restore, possibly on the other lane); auto-preemption is off.
   Every tenant's homes and summaries bit-identical to phase 7's ``ooc``
   run at step 2, at least one preemption, no rejection, peak device memory below
   the four tenants' homes, every span a lane's, a tenant's or a lease
   (the admission oracle untraced), no hand-written kernel launched.
   Records: the served wall beside four phase 7 ``ooc`` walls, planning
   seconds over the lanes and the oracle, the plan cache's counters, per
   tenant its queue wait, predicted and achieved modelled seconds and
   lanes, per lane its lease seconds and compute device seconds (CUDA
   event spans), checkpoint and restore seconds, pinned host bytes, each
   tenant's last ``dt`` in hex, and the drift audit of lane 0's largest
   chain.  With two or more cards the four tenants also run at 512^2 on
   ``cuda:2``, bit for bit against ``sim:2`` (else a ``serve_cuda``
   record says it did not run);
11. model decode — Llama 3.2 1B at its published config (16 layers, d
   2048, 32 heads over 8 KV heads, ff 8192, vocabulary 128256, tied
   embeddings, bf16; 1.236 B parameters, 2.47 GB), seeded random weights
   made on the card, through ``repro_torch.models``: the launcher's decode
   (batch 4, a 32-token teacher-forced prefill, 32 greedy tokens) on the
   resident model (prefill seconds, median decode ms per token by CUDA
   events, tokens/s, beside the weights' byte bound; peak device memory);
   an fp32 copy of the same weights (TF32 off), 4 teacher-forced steps on
   the card against the same 4 on the CPU (rtol 1e-3 / atol 1e-5, the
   largest difference printed); then the same bf16 weights through a
   ``StreamedDecoder`` of 3 slots from pinned host memory: every step's
   logits ``torch.equal`` to the resident run's and the tokens equal, the
   device bytes the slots hold measured by ``memory_allocated`` after every
   step (at most 3 layer slices), uploaded bytes, H2D GB/s over copy-stream
   events and ms per step beside its link bound, the resident ms per token
   and the modelled step (the default ``hw``, ``H100``); then ``python -m
   repro_torch.launch.serve --arch llama3_2_1b --reduced`` on the card as
   a subprocess, and the launcher's ``main`` with ``--offload`` in this
   process, both exiting 0.  No hand-written kernel launches (counts
   zeroed at the phase's start, read at its end);
12. moe decode — Qwen3-MoE 30B-A3B (48 layers, d 2048, 32 heads over 4 KV
   heads, 128 experts top-8 of ff 768, vocabulary 151936, untied; 61.09 GB)
   and then DeepSeek-V2-Lite (27 layers, MLA with r 512, dn 128, dr 64, dv
   128, 64 experts top-6 of ff 1408 plus 2 shared, layer 0 dense of ff
   10944; 31.42 GB) at their published configs, bf16 with fp32 routers,
   seeded weights made on the card after the free device memory is checked
   against the model's bytes: each through the launcher's decode (batch 4,
   a 32-token teacher-forced prefill, 32 greedy tokens) resident, twice
   from a fresh cache with every step's logits ``torch.equal`` across the
   runs (the combine has no atomics), beside the byte bound of every weight
   but the embedding table (at batch 4 the capacity is C = T, so every
   expert runs); peak device memory; 4 more steps under ``torch.profiler``
   for the card's busy share; then the same widths at 2 layers in fp32
   (TF32 off), 4 teacher-forced steps on the card against the CPU, every
   layer's routing equal first (the smallest top-k gap printed), the
   logits at rtol 1e-3 / atol 1e-5; then the launcher's ``main(["--arch",
   <arch>, "--reduced"])`` in this process on the card for both archs
   (exit 0) and with ``--offload`` (exit 2).  No hand-written kernel
   launches;
13. ssm, hybrid and encdec decode — Mamba2 1.3B (48 Mamba-2 layers, d
   2048, state 128, head dim 64, expand 2, conv 4, vocabulary 50280,
   untied; 2.89 GB), Zamba2 1.2B (38 Mamba-2 layers of state 64 and one
   shared attention+MLP block, 32 heads, ff 8192, after every 6th layer;
   2.34 GB) and Whisper medium (24 encoder and 24 decoder layers, d 1024,
   16 heads, ff 4096, vocabulary 51865; 2.02 GB) at their published
   configs, seeded bf16 weights made on the card (``dt_bias``, ``a_log``,
   ``d_skip`` fp32): each through the launcher's decode resident (batch 4,
   a 32-token teacher-forced prefill, 32 greedy tokens; Whisper's encoder
   K/V stubbed at 0.01 as the launcher stubs them), median ms a token
   beside the byte bound of a step (the weights it reads, the hybrid's
   shared block at each site, and the ssm and conv state read and
   written), peak device memory, 4 steps under ``torch.profiler``; then an
   fp32 copy at full depth (TF32 off): 4 teacher-forced steps on the card,
   on the CPU and on the CPU in fp64, the card no farther from the fp64
   run than twice the CPU's fp32 run (the card against the CPU at rtol
   1e-3 / atol 1e-5 recorded), for Mamba2 and Zamba2 ``forward`` over the
   prompt against 32 decode steps on the card (rtol 2e-2 / atol 2e-3, the
   JAX package's test), for Whisper ``forward`` with seeded encoder inputs
   (4, 32, 1024) held the same way as the steps; then the launcher's
   ``main`` in this process on the three reduced archs (exit 0) and with
   ``--offload`` (exit 2).  No hand-written kernel launches.

14. training — Llama 3.2 1B at its published config (bf16, 1.236 B
   parameters, seeded weights made on the card) through
   ``repro_torch.launch.train``'s ``main`` in this process: 6 steps of batch
   2 at 4,096 tokens in 2 microbatches (8,192 tokens a step), remat on;
   every loss and grad norm finite, and step 0's batch's loss lower after
   the 6 steps than before them.  Records ms a step (CUDA events, the median
   of steps 2-6), tokens/s, the model FLOPs of a step (6·N·T) against the
   dense bf16 peak, optimizer ms and peak device memory; then 2 more steps
   under ``torch.profiler`` for the card's busy share, and one microbatch's
   gradients twice by default and once in ``torch``'s deterministic mode
   (bits and ms compared).  Then an fp32 copy at 2 layers (TF32 off): one
   step's loss and gradients on the card against the CPU (loss rtol 1e-4,
   gradients rtol 1e-3 / atol 1e-5), ``adamw_update`` fed the same
   gradients on both (parameters and moments atol 1e-6), and the card's
   gradients with remat off ``torch.equal`` to remat on.  Then the launcher
   on the reduced arch: an uninterrupted 6-step run against one stopped by
   a SIGTERM after step 3 and resumed, their last checkpoints (under
   ``build/train_ckpt``, deleted at the end) equal array for array; and
   the launcher on every trainable family's reduced arch (2 steps, exit 0;
   Whisper exits 2).  No hand-written kernel launches.

15. LM mesh — the sharded paths of ``repro_torch.distributed`` on four
   ranks on the one card: processes spawned by ``torch.multiprocessing``,
   one gloo group (NCCL refuses two ranks on one card), CUDA tensors,
   joined through the package's ``launch/mesh.py::init_ranks``, which
   routes the functional all-gather through the c10d one on such a group
   (PyTorch 2.11's crashes on gloo CUDA tensors).  First, one rank with no
   mesh, on the card: the launcher's Llama 3.2 1B (published config,
   bf16) for 3 steps of 4 x 512 tokens at lr 3e-5, the fp32 2-layer
   copy's loss and gradients, and Qwen3-MoE 30B-A3B's teacher-forced decode (batch 4, 8 steps) at 2
   layers in fp32 and 8 in bf16, every routing logged.  Then the four
   ranks: the fp32 2-layer Llama's loss and gradients on (data=2,
   model=2) against one rank (loss rtol 1e-4, gradients rtol 1e-3 / atol
   1e-5, TF32 off); the Qwen3-MoE decodes expert parallel on (data=1,
   model=4), 32 experts a rank (the fp32 copy's routing equal and logits
   rtol 1e-4 / atol 1e-5; the bf16 one's steps before the first call
   whose chosen experts differ within atol 2e-2, and every routing
   difference up to it a near-tie at bf16 resolution, ``routing_flip``);
   the int8 pod all-reduce of a 16 MB gradient a rank on (pod=4) with
   CUDA tensors against the same inputs as CPU tensors (phase 1 payloads
   equal, phase 2 within one step, the mean within one
   quantisation step), timed beside a plain all-reduce; and
   ``launch/train.py``'s ``main`` with ``--model-parallel 2 --backend
   gloo`` on the bf16 Llama (losses finite, falling and equal on every
   rank; ms a step against one rank; the second step's collectives under
   ``CommDebugMode``, bytes by op and group size).  Beside them, in two
   child processes, ``repro_torch.launch.dryrun`` on Llama 3.2 1B x
   ``train_4k`` and Qwen3-MoE x ``decode_32k`` on the 256- and 512-rank
   production meshes (host only, fake tensors), each record printed.  No
   hand-written kernel launches (counted in the parent and on every rank).
   The dry-run records stay for phase 16.

16. step analysis — ``repro_torch.analysis`` and ``core/cachesim.py`` on
   the card: (a) the card's own constants beside the data sheet's
   (CUDA-event medians of 10: a 4 GiB device-to-device ``copy_``, an
   8192^3 ``torch.matmul`` in bf16 and in fp32 with TF32 off, pinned 1 GiB
   H2D and D2H copies; by the host clock, a 1 GiB copy between two pinned
   host buffers), then each field of the port's default ``hw``, ``H100``,
   beside the rate it was taken from (gate: each ratio in [0.5, 2]); (b)
   ``OpCostLog`` over one training step of Llama 3.2 1B at its published
   config (phase 14's 2 x 4,096 tokens in two microbatches, remat on) and
   one decode step (phase 11's batch 4 after 32 prompt tokens), each from
   the same state as a step without it
   (results ``torch.equal``), printed with ``roofline_terms`` on the data
   sheet's constants and on (a)'s and the step's ms timed without the
   mode; gates: dot FLOPs equal to ``FlopCounterMode``'s and to the same
   count under ``FakeTensorMode`` on the host, the training step's at least
   6·N·T, the decode step's HBM bytes at least the weights'; (c) the
   roofline table (``analyze_report_dir``) of phase 15's dry-run records,
   every row with HBM bytes and a finite bound, then the records deleted;
   (d) ``simulate_chain`` on phase 7's CloverLeaf 2D timestep chain at
   8192^2 at phase 7's capacity and tile count, every mode untiled and
   tiled on the port's default ``hw`` (``flat_fast`` must raise
   MemoryError at 3x), its modelled seconds labelled a model of that
   ``hw``, not card times.  No hand-written kernel launches.

17. examples — the port's examples on the card, each through its
   ``main`` in this interpreter, its output captured:
   ``examples/quickstart_torch.py`` (heat at 512 x 256 on ``reference`` and
   on ``ooc`` at a quarter of the problem), ``examples/serve_lm_torch.py``
   (8-layer reduced Llama, resident through a ``DecodeGraph`` and streamed
   through 3 slots), ``examples/train_lm_torch.py --preset 100m`` for 2
   steps into a fresh checkpoint directory under ``build/examples``
   (deleted at the end), then to step 10 on that directory.  Each must
   return 0 and print its own check (``[OK]``, ``greedy outputs identical:
   True``, ``improved``; the second training run also ``resumed from step
   2``).  One record a run: its wall seconds, the card's ``nvidia-smi`` name
   and power limit, what it printed and its hand-written kernel launches,
   zeroed just before it (none: its paths run torch ops).

Every line but the last two is a JSON record.  The line before the last
JSON ``ok`` line lists every ported kernel (phases 7 to 17 launch none of
them: the apps' loops and the models' layers are torch ops); the card's ``nvidia-smi`` name and power
limit are printed on their own line before it.  The script
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import importlib.util
import io
import json
import os
import shutil
import signal
import tempfile
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import ReductionSpec, Session, datasets_from_numpy  # noqa: E402
from repro_torch.core import Block  # noqa: E402
from repro_torch.core.executor import GRAPH_FIELDS  # noqa: E402
from repro_torch.core.tile_graph import TileGraphs  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import star2d_kernel, star3d_kernel  # noqa: E402
from repro_torch.obs import compare as drift_compare  # noqa: E402
from repro_torch.analysis.roofline import FP32_PEAK, H100_SXM  # noqa: E402

# Published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bandwidth and
# float32 arithmetic outside the tensor cores.  The sweeps accumulate in fp32.
PEAK_BYTES_S = H100_SXM.hbm_bw
PEAK_FP32_S = FP32_PEAK
FLOPS_PER_POINT = {"stencil2d": 7, "stencil3d": 10}
C2 = (0.5, 0.125, 0.125)
C3 = (0.4, 0.1, 0.1, 0.1)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SHAPES_2D = [(8, 8), (33, 47), (128, 128), (65, 130), (7, 256)]
# The reference's shapes, then the z-marching kernel's edges: a single plane,
# more planes than one z-segment (64), and H and W ragged against its
# 16 x 64 tile.
SHAPES_3D = [(4, 8, 8), (9, 17, 21), (16, 32, 32), (1, 8, 64), (1, 9, 70),
             (130, 20, 67), (65, 9, 129), (3, 100, 5)]
# chain2d checks: (interior, steps); the reference's chain test shapes, then
# ragged tiles, a 1x1 interior, and chains deeper than one launch.
CHAIN_SHAPES = ([((40, 56), k) for k in (1, 2, 4, 6)]
                + [((24, 32), 3), ((4, 4), 1), ((17, 9), 2), ((40, 23), 4),
                   ((33, 47), 3), ((7, 256), 6), ((4, 4), 4), ((1, 1), 16),
                   ((130, 260), 16), ((33, 47), 20), ((65, 300), 40)])
# Input columns a warp of csrc/chain2d.cu's wavefront (K >= 2) reads and
# sweeps (its kStrip).
CHAIN_STRIP = 128
CHAIN_PATH = ([(k, torch.float32) for k in (1, 2, 4, 8, 16, 24)]
              + [(8, torch.bfloat16)])
SOURCES = {
    "stencil2d": ("src/repro_torch/kernels/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d.py:36"),
    "stencil3d": ("src/repro_torch/kernels/csrc/stencil3d.cu",
                  "src/repro/kernels/stencil3d.py:38"),
    "chain2d": ("src/repro_torch/kernels/csrc/chain2d.cu",
                "src/repro/kernels/chain2d.py:45"),
}


def stencil2d_edge_cases(dtype):
    """stencil2d checks at the edges of the kernel's tiling for ``dtype``,
    as (interior, storage offset of the input): widths just below, at and
    just above one strip and a multiple of it plus one, heights just below
    and above one segment and past three, W + 2 at every residue mod 8 (so
    rows start at every alignment), one-row, one-column and 1x1 interiors,
    and a ragged input at storage offsets 1 to 7.  Builds the kernel."""
    t = ops.stencil2d_tiling(dtype)
    rows, cols = t["rows"], t["cols"]
    shapes = [(13, w) for w in (cols - 1, cols, cols + 1, 4 * cols + 1)]
    shapes += [(h, 37) for h in (rows - 1, rows + 1, 3 * rows + 1)]
    shapes += [(5, w) for w in range(6, 14)]
    shapes += [(1, 300), (300, 1), (1, 1)]
    return ([(s, 0) for s in shapes]
            + [((rows + 1, cols + 3), off) for off in range(1, 8)])


def stencil3d_edge_cases(dtype):
    """stencil3d checks at the edges of the kernel's tiling for ``dtype``,
    as (interior, storage offset of the input): widths just below, at and
    just above a tile's columns and a multiple of them plus one, heights
    just below, at and above a tile's rows and past three tiles, depths
    just below, at and above one z segment, W + 2 at every residue mod 8
    (so rows start at every alignment), one-plane, one-row, one-column and
    1x1x1 interiors, and a ragged input at storage offsets 1 to 7.  Builds
    the kernel."""
    t = ops.stencil3d_tiling(dtype)
    rows, cols, planes = t["rows"], t["cols"], t["planes"]
    shapes = [(3, 5, w) for w in (cols - 1, cols, cols + 1, 4 * cols + 1)]
    shapes += [(3, h, 37) for h in (rows - 1, rows, rows + 1, 3 * rows + 1)]
    shapes += [(d, 5, 37) for d in (planes - 1, planes, planes + 1)]
    shapes += [(3, 4, w) for w in range(6, 14)]
    shapes += [(1, 9, 70), (5, 1, 70), (5, 9, 1), (1, 1, 1)]
    return ([(s, 0) for s in shapes]
            + [((planes + 1, rows + 1, cols + 3), off) for off in range(1, 8)])


def chain_edge_shapes(limit: int):
    """chain2d checks at the edges of the kernel's tiling, (interior, steps):
    widths just below, at and just above one strip's output width and a
    multiple of it plus one, interiors of one row and of a segment's rows
    less and plus one (K = 3, not a multiple of a lane's 4 columns, and
    K = 8); then every K from 1 to the per-launch ``limit`` at one ragged
    shape.  Builds the kernel."""
    shapes = []
    for k in (3, 8):
        t = ops.chain2d_tiling(k)
        s = t["cols"]
        shapes += [((13, w), k) for w in (s - 1, s, s + 1, 4 * s + 1)]
        shapes += [((1, 200), k), ((t["rows"] - 1, 61), k), ((t["rows"] + 1, 61), k)]
    return shapes + [((37, 300), k) for k in range(1, limit + 1)]


def emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn``, a host-side call, by the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def queued_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` over ``reps`` calls queued back to
    back between two CUDA events, behind one more call that keeps the
    device busy while the host queues them: the device's time without the
    host's between launches, where a call takes longer on the device than
    on the host."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# -- phase 1 and 2 ------------------------------------------------------------------


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    meminfo = dict(ln.split(":", 1) for ln in Path("/proc/meminfo").read_text().splitlines())
    emit(phase="device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         host_mem_available=meminfo["MemAvailable"].strip())
    return smi


def build_phase() -> None:
    t0 = time.perf_counter()
    info = build.build()
    check(sorted(info) == sorted(SOURCES), f"built {sorted(info)}")
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": v["seconds"], "built": v["built"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, v in info.items()})


# -- phase 3: the kernels against their plain versions ------------------------------


def _cross_weight(coeffs, ndim: int, dtype) -> torch.Tensor:
    """The sweep as a convolution weight (a cross of 2*ndim+1 taps)."""
    w = torch.zeros((1, 1) + (3,) * ndim, dtype=dtype, device="cuda")
    centre = (0, 0) + (1,) * ndim
    w[centre] = coeffs[0]
    for d in range(ndim):
        for k in (0, 2):
            idx = list(centre)
            idx[2 + d] = k
            w[tuple(idx)] = coeffs[1 + d]
    return w


def padded_input(shape, dtype, seed: int, offset: int = 0) -> torch.Tensor:
    """A seeded padded input for the interior ``shape`` on the card,
    ``offset`` elements into its storage."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    padded = tuple(s + 2 for s in shape)
    return torch.rand(offset + int(np.prod(padded)), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)[offset:].view(padded)


def kernel_case(name: str, shape, dtype, reps: int, seed: int,
                offset: int = 0) -> dict:
    """One kernel at one interior shape, its input ``offset`` elements into
    its storage: error against the plain version and, with ``reps``, the
    timings."""
    fn = ops.stencil2d if name == "stencil2d" else ops.stencil3d
    plain = ref.stencil2d_ref if name == "stencil2d" else ref.stencil3d_ref
    coeffs = C2 if name == "stencil2d" else C3
    x = padded_input(shape, dtype, seed, offset)
    got = fn(x, coeffs)
    want = plain(x, coeffs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # Both kernels round once from the plain version's fp32 sums, so they
    # are exact in bf16 too.
    check(got.shape == want.shape and err <= TOL[dtype] and torch.equal(got, want),
          f"{name} {shape} {dtype} offset {offset}: max_abs_err {err}")
    rec = {"name": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err}
    if offset:
        rec["offset"] = offset
    if not reps:
        return rec
    ndim = len(shape)
    conv = F.conv2d if ndim == 2 else F.conv3d
    weight = _cross_weight(coeffs, ndim, dtype)
    xb = x.reshape((1, 1) + tuple(x.shape))
    lib = conv(xb, weight)
    lib_err = (lib.reshape(got.shape).float() - want.float()).abs().max().item()
    check(lib_err <= 10 * TOL[dtype], f"{name} library yardstick err {lib_err}")
    del got, want, lib
    nbytes = (x.numel() + int(np.prod(shape))) * x.element_size()
    flops = FLOPS_PER_POINT[name] * int(np.prod(shape))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_S * 1e3
    rec.update(
        ms=time_ms(lambda: fn(x, coeffs), reps),
        queued_ms=queued_ms(lambda: fn(x, coeffs), reps),
        plain_ms=time_ms(lambda: plain(x, coeffs), max(3, reps // 4)),
        library_ms=time_ms(lambda: conv(xb, weight), reps),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, flops=flops)
    if ndim == 2:
        # The rate this card reaches on a plain copy of about the same bytes.
        out = torch.empty(shape, dtype=dtype, device="cuda")
        rec["copy_ms"] = time_ms(lambda: out.copy_(x[1:-1, 1:-1]), reps)
    rec["contig_copy_ms"] = contig_copy_ms(nbytes, dtype, reps)
    return rec


def contig_copy_ms(nbytes: int, dtype, reps: int) -> float:
    """Milliseconds of a contiguous device-to-device copy that moves
    ``nbytes``, half of them read and half written: what the card reaches on
    the bytes a kernel must move."""
    src = torch.empty(nbytes // (2 * torch.empty((), dtype=dtype).element_size()),
                      dtype=dtype, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), reps)


def unfused(x: torch.Tensor, steps: int) -> torch.Tensor:
    """K launches of the port's stencil2d on the shrinking input."""
    for _ in range(steps):
        x = ops.stencil2d(x, C2)
    return x


def chain_input(shape, steps: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(tuple(s + 2 * steps for s in shape), generator=gen,
                      device="cuda", dtype=torch.float32).to(dtype)


def chain_check(x: torch.Tensor, got: torch.Tensor, steps: int) -> dict:
    """The kernel's result against the plain version and, in fp32, against K
    launches of stencil2d (bit for bit)."""
    want = ref.chain2d_ref(x, C2, steps)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(got.shape == want.shape and got.dtype == x.dtype and err <= TOL[x.dtype],
          f"chain2d {tuple(got.shape)} K={steps} {x.dtype}: max_abs_err {err}")
    rec = {"name": "chain2d", "shape": list(got.shape), "steps": steps,
           "dtype": str(x.dtype).split(".")[-1], "max_abs_err": err}
    if x.dtype == torch.float32:
        rec["equals_plain"] = torch.equal(got, want)
        check(rec["equals_plain"], f"chain2d {tuple(got.shape)} K={steps}: "
              "fused differs from the plain version")
        rec["equals_unfused"] = torch.equal(got, unfused(x, steps))
        check(rec["equals_unfused"], f"chain2d {tuple(got.shape)} K={steps}: "
              "fused differs from K launches of stencil2d")
    return rec


def kernels_phase(n2d: int, n3d: int, reps: int) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, s in enumerate(SHAPES_2D):
        for dtype in (torch.float32, torch.bfloat16):
            emit(phase="kernel_check", **kernel_case("stencil2d", s, dtype, 0, i))
    for dtype in (torch.float32, torch.bfloat16):
        for i, (s, off) in enumerate(stencil2d_edge_cases(dtype)):
            emit(phase="kernel_check",
                 **kernel_case("stencil2d", s, dtype, 0, 50 + i, offset=off))
    for i, s in enumerate(SHAPES_3D):
        for dtype in (torch.float32, torch.bfloat16):
            emit(phase="kernel_check", **kernel_case("stencil3d", s, dtype, 0, i))
    for dtype in (torch.float32, torch.bfloat16):
        for i, (s, off) in enumerate(stencil3d_edge_cases(dtype)):
            emit(phase="kernel_check",
                 **kernel_case("stencil3d", s, dtype, 0, 70 + i, offset=off))
    for i, (s, k) in enumerate(CHAIN_SHAPES
                               + chain_edge_shapes(ops.chain2d_max_steps())):
        for dtype in (torch.float32, torch.bfloat16):
            x = chain_input(s, k, dtype, seed=i)
            emit(phase="kernel_check", **chain_check(x, ops.chain2d(x, C2, k), k))
    path = {}
    for name, shape, dtype in (("stencil2d", (n2d, n2d), torch.float32),
                               ("stencil2d", (n2d, n2d), torch.bfloat16),
                               ("stencil3d", (n3d,) * 3, torch.float32),
                               ("stencil3d", (n3d,) * 3, torch.bfloat16)):
        rec = kernel_case(name, shape, dtype, reps, seed=100)
        emit(phase="kernel_time", **rec)
        if dtype == torch.float32:
            path[name] = rec
        torch.cuda.empty_cache()
    return path


# -- the heat programs ----------------------------------------------------------


def heat_inputs(shape, seed: int):
    """Padded u/tmp homes for an interior ``shape`` (ring included), from a seed."""
    rng = np.random.default_rng(seed)
    u = np.zeros(tuple(s + 2 for s in shape), np.float32)
    u[(slice(1, -1),) * len(shape)] = rng.random(shape, dtype=np.float32)
    return {"u": u, "tmp": np.zeros_like(u)}


def heat(sess: Session, homes, steps: int, summary: bool = False,
         rounds: int = 1, prof=None):
    """The quickstart heat program (a star sweep into tmp, then a commit
    back into u) over the interior minus its outer ring, plus an optional
    sum/min summary loop, recorded and flushed ``rounds`` times on the same
    datasets: every round after the first replays the cached plan.  Returns
    (u, {reduction: value} of the last round, [wall seconds of each flush]);
    ``prof`` (a torch profiler) records the last flush only."""
    blk = Block("grid", tuple(s - 2 for s in homes["u"].shape))
    dats = datasets_from_numpy(blk, homes, halo=1)
    if sess.config.backend != "reference" and sess.config.device == "cuda":
        for d in dats.values():
            d.pin()                      # set-up, outside the timed flushes
    u, tmp = dats["u"], dats["tmp"]
    box = tuple((1, s - 1) for s in blk.size)
    diffuse = (star2d_kernel("u", "tmp", (0.0, 0.25, 0.25)) if blk.ndim == 2
               else star3d_kernel("u", "tmp", (0.4, 0.1, 0.1, 0.1)))
    walls = []
    for r in range(rounds):
        for s in range(steps):
            sess.par_loop(f"diffuse{s}", blk, box, [u, tmp], diffuse)
            sess.par_loop(f"commit{s}", blk, box, [tmp, u],
                          lambda acc: {"u": acc("tmp")})
        if summary:
            sess.par_loop("summary", blk, box, [u],
                          lambda acc: {"usum": acc("u").sum(), "umin": acc("u").min()},
                          reductions=[ReductionSpec("usum"), ReductionSpec("umin", "min")])
        profiled = prof is not None and r == rounds - 1
        torch.cuda.synchronize()
        if profiled:
            prof.start()
        t0 = time.perf_counter()
        sess.flush()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if profiled:
            prof.stop()
    reds = ({n: float(sess.reduction(n)) for n in ("usum", "umin")}
            if summary else {})
    out = sess.fetch(u)
    sess.close()
    return out, reds, walls


def compare(a, b, rtol, atol) -> float:
    err = float(np.abs(a - b).max())
    check(a.shape == b.shape and np.isfinite(a).all(), "finite fields of one shape")
    check(np.allclose(a, b, rtol=rtol, atol=atol), f"fields differ (max {err})")
    return err


# -- phase 4: the kernel path -----------------------------------------------------


def kernel_path_phase(n2d: int, n3d: int) -> dict:
    ops.stencil2d.launches = 0
    ops.stencil3d.launches = 0
    runs = {}
    for label, shape, steps in (("2d", (n2d + 2, n2d + 2), 4),
                                ("3d", (n3d + 2,) * 3, 2)):
        homes = heat_inputs(shape, seed=1)
        sess = Session("cuda")
        got, _, (wall,) = heat(sess, homes, steps)
        runs[label] = (sess.backend, got, wall, homes, steps)
    launches = {"stencil2d": ops.stencil2d.launches,
                "stencil3d": ops.stencil3d.launches}
    for label, (backend, got, wall, homes, steps) in runs.items():
        want, _, (ref_wall,) = heat(Session("reference"), homes, steps)
        err = compare(got, want, rtol=1e-4, atol=1e-5)
        check(backend.pallas_loops == steps and backend.fallback_loops == steps,
              f"{label}: {backend.pallas_loops} kernel loops")
        emit(phase="kernel_path", program=f"heat{label}",
             interior=list(got.shape), steps=steps,
             kernel_loops=backend.pallas_loops, wall_s=wall,
             reference_wall_s=ref_wall, max_abs_err_vs_reference=err)
    check(launches == {"stencil2d": 4, "stencil3d": 2}, f"launches {launches}")
    emit(phase="kernel_path_launches", **launches)
    return launches


# -- phase 5: the chain2d path ------------------------------------------------------


def chain_traffic_model(H: int, W: int, K: int, tile_rows: int, tile_cols: int,
                        dtype_bytes: int = 4, window_cols: int = 0) -> dict:
    """Device-memory bytes for K sweeps of one launch: unfused (a read and a
    write of the interior per sweep) against the fused kernel (each tile's
    (TM+2K) x (TN+2K) window read once and its TM x TN output written), and
    the fused kernel's redundant compute: the points it sweeps per useful
    point, less one.  By default the tile is a window swept over its
    shrinking valid regions.  With ``window_cols`` it is a wavefront strip
    of that many input columns, every sweep run over the whole window (the
    rows that fill the pipeline and the columns gone invalid at its edges
    included), so a strip sweeps K (TM+2K) window_cols points.  The port of
    ``benchmarks/kernel_bench.py::chain_traffic_model`` with 2-D tiles;
    ``tile_cols = W`` gives that model's full-width row slabs and its
    bytes."""
    unfused_bytes = K * 2 * H * W * dtype_bytes
    n_tiles = -(-H // tile_rows) * -(-W // tile_cols)
    window = (tile_rows + 2 * K) * (window_cols or tile_cols + 2 * K)
    fused_read = n_tiles * window * dtype_bytes
    fused = fused_read + H * W * dtype_bytes
    swept = n_tiles * (K * window if window_cols else
                       sum((tile_rows + 2 * (K - s)) * (tile_cols + 2 * (K - s))
                           for s in range(1, K + 1)))
    return {
        "unfused_bytes": unfused_bytes,
        "fused_bytes": fused,
        "traffic_reduction": unfused_bytes / fused,
        "redundant_compute_frac": swept / (K * H * W) - 1,
    }


def chain_model(H: int, W: int, K: int, dtype_bytes: int) -> dict:
    """The traffic model summed over the passes ``ops.chain2d`` runs, each at
    its own tiling (intermediates are fp32, as the input of every multi-pass
    case timed here)."""
    h, w = H + 2 * K, W + 2 * K
    fused = swept = useful = 0.0
    passes = []
    for k in ops.split_steps(K, ops.chain2d_max_steps()):
        t = ops.chain2d_tiling(k)
        h, w = h - 2 * k, w - 2 * k
        # One sweep runs the row march of stencil2d, more a wavefront of strips.
        m = chain_traffic_model(h, w, k, t["rows"], t["cols"], dtype_bytes,
                                window_cols=CHAIN_STRIP if k > 1 else 0)
        fused += m["fused_bytes"]
        swept += (1 + m["redundant_compute_frac"]) * k * h * w
        useful += k * h * w
        passes.append(dict(t, steps=k))
    unfused_bytes = 2 * K * H * W * dtype_bytes
    return {"passes": passes, "unfused_bytes": unfused_bytes, "fused_bytes": fused,
            "traffic_reduction": unfused_bytes / fused,
            "redundant_compute_frac": swept / useful - 1}


def chain2d_phase(n: int, reps: int):
    """Drive ``chain2d`` at an n^2 interior for every case of CHAIN_PATH,
    with its launch count zeroed just before and read just after; then check
    and time each case.  Returns ({"chain2d": the K = 8 fp32 record},
    {"chain2d": the launch count})."""
    inputs = {case: chain_input((n, n), case[0], case[1], seed=200 + i)
              for i, case in enumerate(CHAIN_PATH)}
    torch.cuda.synchronize()
    ops.chain2d.launches = 0
    outs = {case: ops.chain2d(x, C2, case[0]) for case, x in inputs.items()}
    torch.cuda.synchronize()
    launches = ops.chain2d.launches
    limit = ops.chain2d_max_steps()
    want = sum(len(ops.split_steps(k, limit)) for k, _ in CHAIN_PATH)
    check(launches == want, f"chain2d launches {launches}, expected {want}")
    emit(phase="chain2d_path_launches", chain2d=launches)
    path = None
    for K, dtype in CHAIN_PATH:
        x = inputs.pop((K, dtype))
        rec = chain_check(x, outs.pop((K, dtype)), K)
        w = _cross_weight(C2, 2, dtype)

        def convs(x=x, K=K, w=w):
            u = x.reshape((1, 1) + tuple(x.shape))
            for _ in range(K):
                u = F.conv2d(u, w)
            return u

        lib_err = (convs().reshape(n, n).float()
                   - ref.chain2d_ref(x, C2, K).float()).abs().max().item()
        check(lib_err <= 10 * TOL[dtype], f"chain2d K={K} library yardstick err {lib_err}")
        nbytes = (x.numel() + n * n) * x.element_size()
        flops = FLOPS_PER_POINT["stencil2d"] * sum((n + 2 * (K - s)) ** 2
                                                   for s in range(1, K + 1))
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_S * 1e3
        rec.update(
            ms=time_ms(lambda: ops.chain2d(x, C2, K), reps),
            queued_ms=queued_ms(lambda: ops.chain2d(x, C2, K), reps),
            plain_ms=time_ms(lambda: ref.chain2d_ref(x, C2, K), max(3, reps // 4)),
            unfused_ms=time_ms(lambda: unfused(x, K), reps),
            library_ms=time_ms(convs, reps),
            library=f"{K} x F.conv2d (cuDNN, TF32 off)",
            library_max_abs_err=lib_err,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            contig_copy_ms=contig_copy_ms(nbytes, dtype, reps),
            bytes=nbytes, flops=flops,
            model=chain_model(n, n, K, x.element_size()))
        emit(phase="chain2d_time", **rec)
        if (K, dtype) == (8, torch.float32):
            path = rec
        del x
        torch.cuda.empty_cache()
    return {"chain2d": path}, {"chain2d": launches}


# -- phase 6: the out-of-core path ------------------------------------------------


@contextlib.contextmanager
def memory_cap(capacity: float):
    """A hard cap on this process's device memory for the ``with`` body:
    what the caching allocator holds once its cache is emptied, plus
    ``capacity``.  An allocation past it raises; the cap is lifted at the
    end.  Only this script sets it: the package never changes a
    process-wide memory setting."""
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info()[1]
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_reserved() + capacity) / total)
    try:
        yield
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)


def ooc_phase(n: int, steps: int, rounds: int = 2) -> None:
    """Two rounds of the program per session: the first plans the chain
    (cold), the second replays the cached plan (a steady-state step).  Both
    lane modes run under a hard cap at their capacity (``memory_cap``)."""
    homes = heat_inputs((n, n), seed=2)
    home_bytes = sum(a.nbytes for a in homes.values())
    cap = home_bytes / 3
    results = {}
    for backend in ("ooc", "ooc-async"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        sess = Session(backend, capacity_bytes=cap, cyclic=True, prefetch=True)
        with memory_cap(cap):
            got, reds, walls = heat(sess, homes, steps, summary=True, rounds=rounds)
        peak = torch.cuda.max_memory_allocated() - base
        peak_reserved = torch.cuda.max_memory_reserved() - base_reserved
        st = sess.transfer_stats()
        hist = sess.history
        busy = {lane: st["lanes"].get(lane, {}).get("service", {}).get("sum", 0.0)
                for lane in ("up", "down")}
        emit(phase="ooc", backend=backend, interior=[n, n], steps=steps,
             rounds=rounds, chains=len(hist), tiles=[h.num_tiles for h in hist],
             bytes_up=st["bytes_up_raw"], bytes_down=st["bytes_down_raw"],
             wall_s=walls, plan_time_s=sess.plan_stats()["plan_time_s"],
             h2d_GBps_busy=st["bytes_up_raw"] / busy["up"] / 1e9,
             d2h_GBps_busy=st["bytes_down_raw"] / busy["down"] / 1e9,
             h2d_GBps_copy=st["bytes_up_raw"] / st["copy_s"]["up"] / 1e9,
             d2h_GBps_copy=st["bytes_down_raw"] / st["copy_s"]["down"] / 1e9,
             lane_busy_s=busy, lane_copy_s=st["copy_s"],
             modelled_s=[h.modelled_s for h in hist],
             graph=graph_record(st),
             graph_per_chain=[{f: getattr(h, f) for f in GRAPH_FIELDS}
                              for h in hist],
             peak_device_bytes=peak, peak_over_capacity=peak / cap,
             peak_reserved_bytes=peak_reserved, capacity_bytes=cap, hard_cap=True,
             workspace_bytes=[h.workspace_bytes for h in hist],
             home_bytes=home_bytes, reductions=reds)
        check(all(h.num_tiles > 1 for h in hist), "ran out of core")
        check(peak < home_bytes, f"peak {peak} B not below the homes {home_bytes} B")
        check(peak <= cap, f"peak {peak} B within the capacity {cap} B")
        results[backend] = (got, reds)
    a, b = results["ooc"], results["ooc-async"]
    check(torch.equal(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
          and a[1] == b[1], "ooc-async is bit-identical to ooc")
    want, want_reds, walls = heat(Session("cuda"), homes, steps, summary=True,
                                  rounds=rounds)
    err = compare(a[0], want, rtol=0.0, atol=1e-5)
    for k in want_reds:
        check(np.isclose(a[1][k], want_reds[k], rtol=1e-3),
              f"reduction {k}: {a[1][k]} vs {want_reds[k]}")
    emit(phase="ooc_check", ooc_async_bit_identical=True,
         max_abs_err_vs_cuda=err, cuda_wall_s=walls, reductions_cuda=want_reds)


def slot_pool_phase(n: int, steps: int) -> None:
    """The data plane's reuse hazards on the card: with one slot every edge
    carry overlaps its own slot, with two every upload reuses the slot whose
    download was just submitted.  Both lane modes must match ``cuda``."""
    homes = heat_inputs((n, n), seed=3)
    want, want_reds, _ = heat(Session("cuda"), homes, steps, summary=True)
    for slots in (1, 2):
        for backend in ("ooc", "ooc-async"):
            sess = Session(backend, num_slots=slots, num_tiles=8,
                           capacity_bytes=float("inf"))
            got, reds, walls = heat(sess, homes, steps, summary=True)
            err = compare(got, want, rtol=0.0, atol=1e-5)
            check(all(np.isclose(reds[k], want_reds[k], rtol=1e-3) for k in reds),
                  f"{backend} {slots} slots: reductions {reds} vs {want_reds}")
            emit(phase="slot_pool", backend=backend, num_slots=slots, tiles=8,
                 interior=[n, n], max_abs_err_vs_cuda=err, wall_s=walls)


# -- phase 7: the apps path -----------------------------------------------------


APP_FIELDS = {"cloverleaf2d": ("density0", "energy0", "xvel0", "yvel0"),
              "cloverleaf3d": ("density0", "energy0", "xvel0", "yvel0", "zvel0"),
              "opensbli": ("rho", "rhou", "rhov", "rhow", "rhoE")}


def run_app(name: str, make_app, backend: str, steps: int, drive=None,
            digests: bool = False, check_after=None, cap: float = None,
            **kw) -> dict:
    """One app run on the card: fresh homes (RAM homes pinned before the
    run, as in phase 6; disk-backed homes are never pinned), peak device
    memory from a reset, and one record per chain the Session flushed — its
    loops, the executor chains it became (more than one where it split), its
    wall to a synchronise, its plan and ``debug`` verify seconds and cache
    hits, and its tile graphs' warm-ups, captures, replays, capture seconds
    and pool bytes.  ``drive(app, sess) -> summary`` replaces ``app.run(sess,
    steps)``.  ``check_after(app, sess)`` runs once the run's records,
    fields and digests are taken (none of them counts it), with every
    tile-graph replay held against the eager tile function on cloned slots
    (``TileGraphs.check_replays``); its chains' records are
    ``checked_chains``.  ``cap`` runs the drive (not ``check_after``) under
    a hard cap at that capacity (``memory_cap``).  The Session is closed and
    the homes are dropped
    before this returns, so
    their pins are released; the fields come back as copies, and with
    ``digests`` every dataset's whole padded home as a SHA-1 digest."""
    app = make_app()
    for d in app.dats.values():
        d.pin()
    sess = Session(backend, **kw)
    chains = []
    windows = []
    run_chain = sess._run

    def timed(chain):
        before = len(sess.history)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_chain(chain)
        torch.cuda.synchronize()
        windows.append((t0, time.perf_counter()))
        hist = sess.history[before:]
        chains.append({
            "graph": {f: sum(getattr(h, f) for h in hist) for f in GRAPH_FIELDS},
            "loops": len(chain), "first": chain[0].name, "last": chain[-1].name,
            "wall_s": time.perf_counter() - t0,
            "tiles": [h.num_tiles for h in hist],
            "workspace_bytes": [h.workspace_bytes for h in hist],
            "plan_s": sum(h.plan_s for h in hist),
            "verify_s": sum(h.verify_s for h in hist),
            "cache_hits": sum(h.plan_cache_hit for h in hist),
            "loop_bytes": sum(h.loop_bytes for h in hist),
            "halo_messages": sum(h.halo_messages for h in hist),
            "halo_bytes": sum(h.halo_bytes for h in hist)})

    sess._run = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    with memory_cap(cap) if cap is not None else contextlib.nullcontext():
        summary = (drive(app, sess) if drive is not None
                   else app.run(sess, steps=steps))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    peak_reserved = torch.cuda.max_memory_reserved() - base_reserved
    tracer = sess.trace()
    if tracer is not None:
        # The sharded executor's scatter / gather / halo-exchange spans (its
        # ``mesh`` track), each chain's by the wall window it ran in.
        spans = [sp for sp in tracer.spans() if sp.cat == "mesh"]
        for c, (a, b) in zip(chains, windows):
            c["mesh_s"] = {k: sum(sp.t_end - sp.t_start for sp in spans
                                  if sp.name == k and a <= sp.t_start < b)
                           for k in MESH_SPANS}
    out = {"backend": backend, "summary": summary, "wall_s": wall,
           "chains": list(chains), "peak_device_bytes": peak,
           "peak_reserved_bytes": peak_reserved,
           "home_bytes": app.total_bytes(),
           "stores": sorted({d.store.kind for d in app.dats.values()}),
           "transfer": sess.transfer_stats(),
           "fields": {n: app.d(n).interior().copy() for n in APP_FIELDS[name]}}
    if digests:
        out["digests"] = home_digests(app)
    if check_after is not None:
        TileGraphs.check_replays = True
        try:
            check_after(app, sess)
        finally:
            TileGraphs.check_replays = False
        out["checked_chains"] = chains[len(out["chains"]):]
    sess.close()
    del app, sess
    gc.collect()
    torch.cuda.empty_cache()
    return out


MESH_SPANS = ("scatter", "gather", "halo-exchange")

# Phases 9 and 10 take CloverLeaf 2D to this step, not to phase 7's 4 (the
# script's time limit; see their docstrings): phase 7 records its ``ooc``
# and ``reference`` runs there as well, the baselines of their depth.
CUT_STEPS = 2


def home_digests(app) -> dict:
    """Every home's SHA-1 by name, the homes hashed in parallel threads
    (``hashlib`` releases the interpreter's lock on large buffers)."""
    def digest(d):
        return hashlib.sha1(memoryview(np.ascontiguousarray(d.materialize()))).hexdigest()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(app.dats, pool.map(digest, app.dats.values())))


def recording_at(step: int, steps: int, at: dict, digests: bool = False):
    """A ``drive`` for ``run_app``: ``app.run`` to ``step``, where the fields,
    the summary, the wall since the drive began (and with ``digests`` every
    home's SHA-1) go into ``at``, then on to ``steps`` exactly as an
    uninterrupted ``app.run`` (the chain before ``step`` ends in the summary's
    flush, so the chains are the same)."""
    def drive(app, sess):
        t0 = time.perf_counter()
        out = app.run(sess, steps=step)
        at["summary"] = dict(out)
        at["fields"] = {n: sess.fetch(app.d(n)) for n in APP_FIELDS["cloverleaf2d"]}
        torch.cuda.synchronize()
        at["wall_s"] = time.perf_counter() - t0
        if digests:
            at["digests"] = home_digests(app)
        out.update(app.run_steps(sess, step, steps))
        return out
    return drive


def app_check(name: str, got: dict, want: dict, what: str) -> float:
    """Fields rtol 1e-4 / atol 1e-5 and summaries rtol 1e-3, the reference
    package's own tolerances (tests/test_apps.py)."""
    err = 0.0
    for n in APP_FIELDS[name]:
        err = max(err, compare(got["fields"][n], want["fields"][n], rtol=1e-4, atol=1e-5))
    for k, v in want["summary"].items():
        check(np.isfinite(got["summary"][k]) and np.isclose(got["summary"][k], v, rtol=1e-3),
              f"{name} {what}: summary {k} {got['summary'][k]} vs {v}")
    return err


def chain_groups(chains) -> dict:
    """Chains by their loop names at both ends and their length (what a
    plan signature shares, less the kernels' captured constants): every
    flush's wall, plan seconds and whether its plan came from the cache."""
    groups = {}
    for c in chains:
        key = f"{c['first']}..{c['last']} ({c['loops']} loops)"
        g = groups.setdefault(key, {"wall_s": [], "plan_s": [], "cache_hits": [],
                                    "tiles": []})
        for k in g:
            g[k].append(c[k])
    return groups


def lane_record(run: dict) -> dict:
    st = run["transfer"]
    busy = {lane: st["lanes"].get(lane, {}).get("service", {}).get("sum", 0.0)
            for lane in ("up", "down")}
    copy_s = st["copy_s"]
    return {
        "bytes_up": st["bytes_up_raw"], "bytes_down": st["bytes_down_raw"],
        "lane_busy_s": busy, "lane_copy_s": copy_s,
        "h2d_GBps_copy": st["bytes_up_raw"] / copy_s["up"] / 1e9 if copy_s["up"] else None,
        "d2h_GBps_copy": st["bytes_down_raw"] / copy_s["down"] / 1e9 if copy_s["down"] else None,
        "h2d_GBps_busy": st["bytes_up_raw"] / busy["up"] / 1e9 if busy["up"] else None,
        "d2h_GBps_busy": st["bytes_down_raw"] / busy["down"] / 1e9 if busy["down"] else None,
    }


def graph_record(stats: dict) -> dict:
    """A run's tile graphs (``transfer_stats()``'s ``graph_*``, its chains'
    ``ChainStats`` summed): keys seen (each first tile a warm-up, eager),
    captures, replays, the captures' host seconds, the device bytes they
    reserved for the runs' pools, replays held against the eager tile
    function."""
    return {f: stats[f] for f in GRAPH_FIELDS}


# Loops in CloverLeaf 2D's timestep chains (51, then the next step's dt
# breaker or the field summary); the init and dt chains are shorter.
TIMESTEP_LOOPS = 51


def step_walls(run: dict, skip: int = 1) -> dict:
    """Wall of the steps (every chain after the first ``skip``: 1 passes
    over ``app.run``'s init chain, 0 takes a resumed run whole), with and
    without the host planner's seconds, and the paper's achieved bandwidth
    (useful loop bytes over wall) where the backend reports loop bytes."""
    chains = run["chains"][skip:]
    wall = sum(c["wall_s"] for c in chains)
    plan = sum(c["plan_s"] for c in chains)
    loop_bytes = sum(c["loop_bytes"] for c in chains)
    return {"wall_s": wall, "plan_s": plan,
            "verify_s": sum(c["verify_s"] for c in chains),
            "useful_GBps": loop_bytes / wall / 1e9 if loop_bytes else None,
            "useful_GBps_without_plan": (loop_bytes / (wall - plan) / 1e9
                                         if loop_bytes else None)}


def kernel_ops_per_timestep(n: int = 64) -> dict:
    """The device operations CloverLeaf 2D's loop kernels issue in one
    timestep (51 loops), each kernel called once over its whole range on
    the card: eager torch runs each non-view operation as at least one
    launch, so an out-of-core chain of T tiles issues about T times this.
    The count does not depend on the grid's size."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.apps import CloverLeaf2D
    from repro_torch.core.reference import _TensorAccessor

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += not func.is_view
            return func(*args, **(kwargs or {}))

    app = CloverLeaf2D(n, n, summary_every=0)
    sess = Session("reference")
    app.record_init(sess)
    sess.flush()
    app.record_timestep(sess)
    device = sess.backend.device
    arrays = {name: torch.from_numpy(d.to_numpy()).to(device)
              for name, d in app.dats.items()}
    with Count() as c:
        for lp in sess.queue:
            lp.kernel(_TensorAccessor(lp, arrays, device))
    return {"loops": len(sess.queue), "kernel_ops": c.ops}


def apps_phase(n2d: int, n3d: int, steps2d: int = 4, steps3d: int = 2) -> dict:
    """The paper's three applications on the port, out of core at a third
    of their homes.  CloverLeaf 2D at an n2d^2 interior runs ``steps2d``
    steps (a field summary every 2) on ``ooc``, ``ooc-async``, ``resident``
    (the in-core baseline) and ``reference``, all on the card; CloverLeaf 3D
    and OpenSBLI (two timesteps a chain) at n3d^3 run ``steps3d`` steps on
    ``ooc`` against ``reference``.  Returns CloverLeaf 2D's ``ooc`` run (with
    its homes' digests) and ``reference`` run, phase 8's baselines, and under
    ``at2`` both as they stood after step CUT_STEPS (fields, summary, wall;
    ``ooc``'s digests), phases 9 and 10's."""
    from repro_torch.apps import CloverLeaf2D, CloverLeaf3D, OpenSBLI

    def cl2d():
        return CloverLeaf2D(n2d, n2d, summary_every=2)

    homes = 25 * (n2d + 4) ** 2 * 4
    cap = homes / 3
    runs = {}
    at = {"ooc": {}, "reference": {}}
    for backend, kw in (("ooc", dict(capacity_bytes=cap, prefetch=True, cap=cap,
                                     digests=True, drive=recording_at(
                                         CUT_STEPS, steps2d, at["ooc"], digests=True),
                                     check_after=lambda app, sess: app.run_steps(
                                         sess, steps2d, steps2d + 1))),
                        ("ooc-async", dict(capacity_bytes=cap, prefetch=True, cap=cap)),
                        ("resident", dict()),
                        ("reference", dict(drive=recording_at(CUT_STEPS, steps2d,
                                                              at["reference"])))):
        run = runs[backend] = run_app("cloverleaf2d", cl2d, backend, steps2d, **kw)
        check(run["home_bytes"] == homes, f"homes {run['home_bytes']} B")
        rec = {"phase": "apps", "app": "cloverleaf2d", "backend": backend,
               "interior": [n2d, n2d], "steps": steps2d, "home_bytes": homes,
               "wall_s": run["wall_s"], "peak_device_bytes": run["peak_device_bytes"],
               "summary": run["summary"]}
        if backend != "reference":
            chains = run["chains"]
            rec.update(
                capacity_bytes=cap if backend.startswith("ooc") else None,
                peak_over_capacity=(run["peak_device_bytes"] / cap
                                    if backend.startswith("ooc") else None),
                chains=len(chains),
                executor_chains=sum(len(c["tiles"]) for c in chains),
                chains_split=sum(len(c["tiles"]) > 1 for c in chains),
                tiles_per_chain=[c["tiles"] for c in chains],
                workspace_per_chain=[c["workspace_bytes"] for c in chains],
                hard_cap=backend.startswith("ooc"),
                graph=graph_record(run["transfer"]),
                graph_per_chain=[c["graph"] for c in chains],
                peak_reserved_bytes=run["peak_reserved_bytes"],
                plan_s=sum(c["plan_s"] for c in chains),
                by_signature=chain_groups(chains),
                steps_after_init=step_walls(run),
                **lane_record(run))
        emit(**rec)
    ooc, asy, res, ref_ = (runs[b] for b in ("ooc", "ooc-async", "resident", "reference"))
    for run in (ooc, asy):
        check(all(t > 1 for c in run["chains"] for t in c["tiles"]), "ran out of core")
        check(run["peak_device_bytes"] < homes,
              f"peak {run['peak_device_bytes']} B not below the homes {homes} B")
        check(run["peak_device_bytes"] <= cap,
              f"peak {run['peak_device_bytes']} B within the capacity {cap} B")
        steps = [c for c in run["chains"] if c["loops"] >= TIMESTEP_LOOPS]
        check(len(steps) >= steps2d and all(c["graph"]["graph_replays"] >= 1 for c in steps),
              f"{run['backend']}: a tile-graph replay in every timestep chain: "
              f"{[c['graph'] for c in steps]}")
    # One more step of the ooc run, after its records, held every replay
    # against the eager tile function on cloned slots (torch.equal; a
    # difference raises there).
    checked = [c for c in ooc["checked_chains"] if c["loops"] >= TIMESTEP_LOOPS]
    check(len(checked) == 1 and all(c["graph"]["graph_checked"] == c["graph"]["graph_replays"]
                                    for c in ooc["checked_chains"])
          and checked[0]["graph"]["graph_replays"] > 0,
          f"a timestep chain's replays all checked: "
          f"{[c['graph'] for c in ooc['checked_chains']]}")
    emit(phase="apps_graph_check", app="cloverleaf2d", backend="ooc", step=steps2d + 1,
         loops=checked[0]["loops"], tiles=checked[0]["tiles"],
         replays_equal_to_eager=True, wall_s=checked[0]["wall_s"], **checked[0]["graph"])
    check(all(torch.equal(torch.from_numpy(ooc["fields"][n]),
                          torch.from_numpy(asy["fields"][n]))
              for n in APP_FIELDS["cloverleaf2d"]) and ooc["summary"] == asy["summary"],
          "cloverleaf2d: ooc-async is bit-identical to ooc")
    err = app_check("cloverleaf2d", ooc, ref_, "ooc vs reference")
    err_res = app_check("cloverleaf2d", res, ref_, "resident vs reference")
    per_step = {b: step_walls(runs[b])["wall_s"] / steps2d
                for b in ("ooc", "ooc-async", "resident")}
    no_plan = {b: (step_walls(runs[b])["wall_s"] - step_walls(runs[b])["plan_s"]) / steps2d
               for b in ("ooc", "ooc-async", "resident")}
    emit(phase="apps_check", app="cloverleaf2d", ooc_async_bit_identical=True,
         max_abs_err_ooc_vs_reference=err, max_abs_err_resident_vs_reference=err_res,
         wall_per_step_s=per_step, wall_per_step_without_plan_s=no_plan,
         resident_over_ooc=per_step["resident"] / per_step["ooc"],
         resident_over_ooc_async=per_step["resident"] / per_step["ooc-async"],
         resident_over_ooc_without_plan=no_plan["resident"] / no_plan["ooc"],
         resident_over_ooc_async_without_plan=no_plan["resident"] / no_plan["ooc-async"])
    baseline = {"ooc": ooc, "reference": ref_, f"at{CUT_STEPS}": at}
    del runs, ooc, asy, res, ref_
    emit(phase="apps_ops", app="cloverleaf2d", **kernel_ops_per_timestep())
    for name, make in (("cloverleaf3d",
                        lambda: CloverLeaf3D(n3d, n3d, n3d, summary_every=steps3d)),
                       ("opensbli", lambda: OpenSBLI(n3d, chain_steps=2))):
        homes3 = len(make().dats) * (n3d + 4) ** 3 * 4
        # No hard cap here: under one at its capacity, CloverLeaf 3D's first
        # dt chain ran out of memory in a warm-up; its blocks under 10 MiB
        # share segments whose slack the charge does not bound (ROADMAP C10).
        got = run_app(name, make, "ooc", steps3d, capacity_bytes=homes3 / 3,
                      prefetch=True)
        want = run_app(name, make, "reference", steps3d)
        err = app_check(name, got, want, "ooc vs reference")
        check(got["peak_device_bytes"] < homes3,
              f"{name}: peak {got['peak_device_bytes']} B not below the homes {homes3} B")
        emit(phase="apps", app=name, backend="ooc", interior=[n3d] * 3, steps=steps3d,
             home_bytes=homes3, capacity_bytes=homes3 / 3, wall_s=got["wall_s"],
             reference_wall_s=want["wall_s"], max_abs_err_vs_reference=err,
             peak_device_bytes=got["peak_device_bytes"],
             peak_over_capacity=got["peak_device_bytes"] / (homes3 / 3),
             peak_reserved_bytes=got["peak_reserved_bytes"], hard_cap=False,
             tiles_per_chain=[c["tiles"] for c in got["chains"]],
             workspace_per_chain=[c["workspace_bytes"] for c in got["chains"]],
             graph=graph_record(got["transfer"]),
             plan_s=sum(c["plan_s"] for c in got["chains"]),
             by_signature=chain_groups(got["chains"]), summary=got["summary"],
             **lane_record(got))
    return baseline


# -- phase 8: the disk tier -------------------------------------------------------

# Where phase 8's disk-backed homes and its checkpoint go: a directory of the
# checkout that git ignores, made afresh under it and deleted at the end.
SPILL_ROOT = Path(__file__).resolve().parent / "build" / "spill"


def cl2d_baselines(n: int, steps: int = 4) -> dict:
    """Phase 7's CloverLeaf 2D ``ooc`` (RAM homes, with digests) and
    ``reference`` runs, with their state after step CUT_STEPS under ``at2``,
    for running phase 8, 9 or 10 alone."""
    from repro_torch.apps import CloverLeaf2D

    homes = 25 * (n + 4) ** 2 * 4
    make = lambda: CloverLeaf2D(n, n, summary_every=2)  # noqa: E731
    at = {"ooc": {}, "reference": {}}
    out = {"ooc": run_app("cloverleaf2d", make, "ooc", steps, digests=True,
                          drive=recording_at(CUT_STEPS, steps, at["ooc"], digests=True),
                          capacity_bytes=homes / 3, prefetch=True),
           "reference": run_app("cloverleaf2d", make, "reference", steps,
                                drive=recording_at(CUT_STEPS, steps, at["reference"])),
           f"at{CUT_STEPS}": at}
    emit(phase="cl2d_baseline", interior=[n, n], steps=steps,
         ooc_wall_s=out["ooc"]["wall_s"], reference_wall_s=out["reference"]["wall_s"])
    return out


def disk_record(run: dict, skip: int = 1) -> dict:
    """Phase 8's per-run record: wall of the steps (``step_walls``'s
    ``skip``) split into planning, ``debug`` verification and the rest;
    the disk tier's traffic and lane; the upload/download lanes; peak
    device memory."""
    st = run["transfer"]
    walls = step_walls(run, skip)
    disk = st["lanes"].get("disk", {}).get("service", {})
    return {"wall_s": run["wall_s"], "steps_after_init": walls,
            "rest_s": walls["wall_s"] - walls["plan_s"] - walls["verify_s"],
            "tiles_per_chain": [c["tiles"] for c in run["chains"]],
            "disk_bytes_read": st["bytes_disk_read"],
            "disk_bytes_written": st["bytes_disk_written"],
            "home_fetches": st["home_fetches"], "home_spills": st["home_spills"],
            "disk_lane_busy_s": disk.get("sum", 0.0),
            "disk_lane_tasks": disk.get("count", 0),
            "peak_device_bytes": run["peak_device_bytes"],
            "summary": run["summary"], **lane_record(run)}


def disk_phase(n: int, baseline: dict, steps: int = 4, chunked_apart: bool = False):
    """CloverLeaf 2D at an n^2 interior with its homes on disk: ``mmap``
    homes at phase 7's capacity with the host budget at a third of the
    homes (so plans carry FetchHome/SpillHome) and ``debug`` verification
    of every plan, checkpointed at step 2 and resumed in a new app and
    Session; then ``chunked`` homes (the lossless default codec).  Each is
    held against phase 7's RAM-home ``ooc`` run (``baseline``; bit for bit
    where the tile counts match) and the resume against the uninterrupted
    run, bit for bit.

    With ``chunked_apart`` the ``chunked`` run goes to a child process
    (``ChunkedRun``) started before the ``mmap`` runs, and is returned for
    the caller to join: its one-core codec and planner then overlap the
    ``mmap`` runs and what the caller runs next, on other cores, with the
    same run and the same checks."""
    from repro_torch.apps import CloverLeaf2D
    from repro_torch.core import StoreConfig

    t_phase = time.perf_counter()
    homes = 25 * (n + 4) ** 2 * 4
    SPILL_ROOT.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(SPILL_ROOT).free
    # The mmap homes, the checkpoint, the resumed mmap homes and the chunked
    # files (at most the homes' size with the lossless codec on smooth
    # fields) may all exist at once.
    need = 4 * homes
    emit(phase="disk_space", spill_root=str(SPILL_ROOT), free_bytes=free,
         needed_bytes=need)
    check(free >= need, f"the spill directory {SPILL_ROOT} has {free} bytes free; "
          f"phase 8 needs {need} for the homes, the checkpoint and the chunked files")
    ooc = baseline["ooc"]
    want = {"tiles": [c["tiles"] for c in ooc["chains"]], "digests": ooc["digests"],
            "summary": ooc["summary"]}
    child = ChunkedRun(n, want, steps) if chunked_apart else None
    spill = Path(tempfile.mkdtemp(prefix="phase8-", dir=SPILL_ROOT))
    kw = dict(capacity_bytes=homes / 3, prefetch=True, host_capacity=homes / 3,
              debug=True)
    try:
        ckpt = str(spill / "step2.npz")
        state = {}

        def with_checkpoint(app, sess):
            out = app.run(sess, steps=2)
            t0 = time.perf_counter()
            state["manifest"] = sess.checkpoint(ckpt)
            state["checkpoint_s"] = time.perf_counter() - t0
            state["scalars"] = (app.dt, app.step_count)
            out.update(app.run_steps(sess, 2, steps))
            return out

        def resumed(app, sess):
            t0 = time.perf_counter()
            sess.restore(ckpt, datasets=app.dats.values())
            state["restore_s"] = time.perf_counter() - t0
            app.dt, app.step_count = state["scalars"]
            sess.cyclic = True
            return app.run_steps(sess, 2, steps)

        def cl2d(kind, tag):
            return lambda: CloverLeaf2D(n, n, summary_every=2, store=StoreConfig(
                kind=kind, directory=str(spill / tag)))

        mm = run_app("cloverleaf2d", cl2d("mmap", "mmap"), "ooc", steps,
                     drive=with_checkpoint, digests=True, **kw)
        shutil.rmtree(spill / "mmap")
        check(mm["home_bytes"] == homes, f"homes {mm['home_bytes']} B")
        check(mm["stores"] == ["mmap"], f"the mmap run's homes were {mm['stores']}")
        check(mm["transfer"]["home_fetches"] > 0 and mm["transfer"]["home_spills"] > 0,
              "the mmap run's plans carry FetchHome and SpillHome")
        check(mm["peak_device_bytes"] < homes,
              f"mmap: peak {mm['peak_device_bytes']} B not below the homes {homes} B")
        tiles_match = ([c["tiles"] for c in mm["chains"]]
                       == [c["tiles"] for c in ooc["chains"]])
        if tiles_match:
            check(all(np.array_equal(mm["fields"][f], ooc["fields"][f])
                      for f in APP_FIELDS["cloverleaf2d"])
                  and mm["digests"] == ooc["digests"],
                  "mmap homes: fields bit-identical to phase 7's RAM-home ooc run")
            err = 0.0
        else:
            err = app_check("cloverleaf2d", mm, baseline["reference"], "mmap vs reference")
        for k, v in ooc["summary"].items():
            check(np.isclose(mm["summary"][k], v, rtol=1e-3),
                  f"mmap summary {k} {mm['summary'][k]} vs {v}")
        emit(phase="disk", store="mmap", interior=[n, n], steps=steps,
             home_bytes=homes, capacity_bytes=homes / 3, host_capacity=homes / 3,
             debug=True, tiles_match_phase7=tiles_match,
             bit_identical_to_phase7=tiles_match, max_abs_err_vs_reference=err,
             checkpoint_s=state["checkpoint_s"],
             checkpoint_bytes=os.path.getsize(ckpt),
             phase7_ram_lanes=lane_record(ooc), **disk_record(mm))

        res = run_app("cloverleaf2d", cl2d("mmap", "resumed"), "ooc", steps,
                      drive=resumed, digests=True, **kw)
        check(res["digests"] == mm["digests"] and res["summary"] == mm["summary"],
              "the resumed mmap run is bit-identical to the uninterrupted one")
        emit(phase="disk_resume", store="mmap", interior=[n, n], resumed_at_step=2,
             restore_s=state["restore_s"], bit_identical=True,
             datasets_compared=len(res["digests"]), **disk_record(res, skip=0))
        shutil.rmtree(spill / "resumed")
        os.remove(ckpt)

        if child is None:
            chunked_run(n, want, steps, spill)
        emit(phase="disk_done", seconds=time.perf_counter() - t_phase,
             chunked_apart=chunked_apart)
    except BaseException:
        if child is not None:
            child.stop()
        raise
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    return child


def chunked_run(n: int, want: dict, steps: int, spill: Path) -> None:
    """Phase 8's ``chunked`` run: CloverLeaf 2D at an n^2 interior from
    ``chunked`` homes (lossless ``shuffle-rle``) under ``spill``, as the
    ``mmap`` run (phase 7's capacity, a host budget of a third of the homes,
    ``debug``), held bit for bit against phase 7's RAM-home ``ooc`` run
    (``want``: its chains' tile counts, every home's digest, its summary)."""
    from repro_torch.apps import CloverLeaf2D
    from repro_torch.core import StoreConfig

    t0 = time.perf_counter()
    homes = 25 * (n + 4) ** 2 * 4
    ch = run_app("cloverleaf2d", lambda: CloverLeaf2D(n, n, summary_every=2, store=StoreConfig(
                     kind="chunked", directory=str(spill / "chunked"))),
                 "ooc", steps, digests=True, capacity_bytes=homes / 3,
                 prefetch=True, host_capacity=homes / 3, debug=True)
    check(ch["stores"] == ["chunked"], f"the chunked run's homes were {ch['stores']}")
    on_disk = sum(f.stat().st_size for f in (spill / "chunked").rglob("*") if f.is_file())
    check([c["tiles"] for c in ch["chains"]] == want["tiles"]
          and ch["digests"] == want["digests"] and ch["summary"] == want["summary"],
          "chunked homes: bit-identical to phase 7's RAM-home ooc run")
    emit(phase="disk", store="chunked", codec="shuffle-rle",
         interior=[n, n], steps=steps, home_bytes=homes,
         capacity_bytes=homes / 3, host_capacity=homes / 3, debug=True,
         bit_identical_to_ram_ooc=True, chunk_files_bytes=on_disk,
         seconds=time.perf_counter() - t0, **disk_record(ch))
    shutil.rmtree(spill / "chunked")


class ChunkedRun:
    """``chunked_run`` in a child process (``chip_smoke.py --chunked DIR``)
    under its own spill directory, which holds the baseline it is held
    against and its output.  ``join`` waits for it, prints its records and
    fails where it failed; ``stop`` ends it if it still runs.  Either way
    its directory is deleted."""

    def __init__(self, n: int, want: dict, steps: int):
        self.dir = Path(tempfile.mkdtemp(prefix="phase8-chunked-", dir=SPILL_ROOT))
        (self.dir / "want.json").write_text(json.dumps({"n": n, "steps": steps, **want}))
        self.t0 = time.perf_counter()
        with open(self.dir / "out", "wb") as out, open(self.dir / "err", "wb") as err:
            self.proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                          "--chunked", str(self.dir)],
                                         stdout=out, stderr=err)

    def join(self, timeout: float = 900) -> None:
        t0 = time.perf_counter()
        try:
            rc = self.proc.wait(timeout)
            waited = time.perf_counter() - t0
            sys.stdout.write((self.dir / "out").read_text())
            err = (self.dir / "err").read_text().strip().splitlines()
            emit(phase="disk_chunked_joined", rc=rc, child_wall_s=time.perf_counter() - self.t0,
                 waited_s=waited)
            check(rc == 0, f"phase 8's chunked run exited {rc}: {err[-5:]}")
        finally:
            self.stop()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def chunked_child(directory: str) -> int:
    """The child's side of ``ChunkedRun``: its records go to stdout."""
    spill = Path(directory)
    want = json.loads((spill / "want.json").read_text())
    n, steps = want.pop("n"), want.pop("steps")
    chunked_run(n, want, steps, spill)
    return 0


# -- phase 9: sharded execution ---------------------------------------------------


def exchange_bench(rows: int, width: int, depth: int, reps: int, smi: str) -> None:
    """``distributed.exchange_halos`` on the card: four shard buffers of
    ``rows`` x ``width`` (phase 9's widths and exchange depth), all on
    ``cuda:0``, non-periodic and periodic; the result ``torch.equal`` to the
    same call on CPU tensors, timed with CUDA events beside its bound (the
    bands' bytes moved twice, read and written, over the HBM rate)."""
    from repro_torch.core.distributed import exchange_halos

    rng = np.random.default_rng(9)
    host = [torch.from_numpy(rng.random((rows, width), dtype=np.float32))
            for _ in range(4)]
    for periodic in (False, True):
        want = exchange_halos([{"u": h.clone()} for h in host], depth, 1, periodic)
        dev = [{"u": h.to("cuda")} for h in host]
        exchange_halos(dev, depth, 1, periodic)
        torch.cuda.synchronize()
        equal = all(torch.equal(w["u"], d["u"].cpu()) for w, d in zip(want, dev))
        check(equal, f"exchange_halos on the card (periodic={periodic}) equals the CPU's")
        messages = 2 * (4 if periodic else 3)
        nbytes = messages * rows * depth * 4
        emit(phase="mesh_exchange", periodic=periodic, shards=4, shape=[rows, width],
             depth=depth, messages=messages, bytes=nbytes, equal_to_cpu=equal,
             ms=time_ms(lambda: exchange_halos(dev, depth, 1, periodic), reps),
             bound_ms=2 * nbytes / PEAK_BYTES_S * 1e3, bound_by="bytes", card=smi)
        del dev
    torch.cuda.empty_cache()


def mesh_record(run: dict, steps: int) -> dict:
    """Phase 9's per-run record: the init chain, then the steps' totals and
    their mean per step — wall, planning seconds summed over the shards,
    the mesh spans' scatter, gather and exchange seconds, halo messages and
    bytes — and every chain; the lanes' rates and peak device memory."""
    def totals(chains):
        out = {"wall_s": sum(c["wall_s"] for c in chains),
               "plan_s": sum(c["plan_s"] for c in chains),
               "halo_messages": sum(c["halo_messages"] for c in chains),
               "halo_bytes": sum(c["halo_bytes"] for c in chains)}
        for k in MESH_SPANS:
            out[f"{k}_s"] = sum(c["mesh_s"][k] for c in chains)
        return out

    after = totals(run["chains"][1:])
    return {"wall_s": run["wall_s"], "init": totals(run["chains"][:1]),
            "steps_after_init": after,
            "per_step": {k: v / steps for k, v in after.items()},
            "chains": [{k: c[k] for k in ("loops", "first", "last", "tiles", "wall_s",
                                          "plan_s", "halo_messages", "halo_bytes",
                                          "mesh_s")} for c in run["chains"]],
            "peak_device_bytes": run["peak_device_bytes"],
            "summary": run["summary"], **lane_record(run)}


def mesh_phase(n: int, baseline: dict, smi: str, steps: int = CUT_STEPS,
               reps: int = 20) -> None:
    """CloverLeaf 2D at an n^2 interior on four shards: ``sim:4`` along
    dim 1 with the skirt sized automatically, each shard out of core at a
    quarter of phase 7's capacity (so the four together hold what phase 7's
    one device did), traced for the mesh spans; on ``ooc-sharded``, then on
    ``ooc-async`` with the same mesh (bit-identical to it).  Held against
    phase 7's ``reference`` run at the same step (``baseline``, phase 7's
    ``at2``), its difference to phase 7's ``ooc`` run there printed; the
    plans' halo counts against the achieved ones.  Then ``exchange_halos``
    on the card at these widths, and a ``cuda:N`` mesh where the machine has
    two or more cards.

    The sharded runs take ``steps`` = CUT_STEPS timesteps, not phase 7's 4:
    at 83-87% planning a ``sim:4`` step took 25-27 s (NVIDIA H100 80GB HBM3,
    700 W), and two steps fewer for each of the two runs make room under
    the script's time limit for phase 14.  Every check stays, against a
    baseline of the same depth."""
    from repro_torch.apps import CloverLeaf2D
    from repro_torch.core import ShardedOutOfCoreExecutor

    t_phase = time.perf_counter()
    homes = 25 * (n + 4) ** 2 * 4
    cap = homes / 3 / 4
    make = lambda: CloverLeaf2D(n, n, summary_every=2)  # noqa: E731
    kw = dict(capacity_bytes=cap, prefetch=True, trace=True)

    def sharded(info):
        def drive(app, sess):
            out = app.run(sess, steps=steps)
            be = sess.backend
            check(isinstance(be, ShardedOutOfCoreExecutor), f"backend {type(be).__name__}")
            (state,) = be._states.values()
            st = sess.transfer_stats()
            info.update(
                exchange_path=be.exchange_path, skirt=state.skirt,
                shard_widths=[g.width for g in state.geos],
                ledger_halo_messages=st["halo_messages"],
                ledger_halo_bytes=st["halo_bytes"],
                achieved_halo_messages=be.halo_stats.messages,
                achieved_halo_bytes=be.halo_stats.bytes,
                pinned_host_bytes={
                    "global_homes": sum(d.nbytes for d in app.dats.values()
                                        if d.store.tensor().is_pinned()),
                    "shard_homes": sum(d.nbytes for ls in state.locals.values()
                                       for d in ls if d.store.tensor().is_pinned())},
                inner_chains=[len(ex.history) for ex in be.inner])
            return out
        return drive

    runs, infos = {}, {}
    for backend in ("ooc-sharded", "ooc-async"):
        info = infos[backend] = {}
        run = runs[backend] = run_app("cloverleaf2d", make, backend, steps,
                                      drive=sharded(info), mesh="sim:4", **kw)
        check(info["ledger_halo_messages"] == info["achieved_halo_messages"] > 0
              and info["ledger_halo_bytes"] == info["achieved_halo_bytes"] > 0,
              f"{backend}: ledger halo counts equal the achieved ones ({info})")
        check(all(t > 1 for c in run["chains"] for t in c["tiles"]),
              f"{backend}: every shard ran out of core")
        check(run["peak_device_bytes"] < homes,
              f"{backend}: peak {run['peak_device_bytes']} B not below the homes {homes} B")
        err = app_check("cloverleaf2d", run, baseline["reference"], f"{backend} vs reference")
        ooc = baseline["ooc"]
        diff_ooc = max(float(np.abs(run["fields"][f] - ooc["fields"][f]).max())
                       for f in APP_FIELDS["cloverleaf2d"])
        emit(phase="mesh", app="cloverleaf2d", backend=backend, mesh="sim:4",
             shard_dim=1, interior=[n, n], steps=steps, home_bytes=homes,
             capacity_bytes_per_device=cap, capacity_bytes_all_devices=4 * cap,
             peak_over_four_capacities=run["peak_device_bytes"] / (4 * cap),
             max_abs_err_vs_reference=err, max_abs_diff_vs_phase7_ooc=diff_ooc,
             bit_identical_to_phase7_ooc=diff_ooc == 0.0, card=smi,
             **info, **mesh_record(run, steps))
    a, b = runs["ooc-sharded"], runs["ooc-async"]
    check(all(np.array_equal(a["fields"][f], b["fields"][f])
              for f in APP_FIELDS["cloverleaf2d"]) and a["summary"] == b["summary"],
          "sim:4: ooc-async is bit-identical to ooc-sharded")
    emit(phase="mesh_check", ooc_async_bit_identical=True, card=smi)

    skirt = infos["ooc-sharded"]["skirt"]
    exchange_bench(n + 4, n // 4 + 2 * (skirt + 2), skirt + 2, reps, smi)

    count = torch.cuda.device_count()
    if count < 2:
        emit(phase="mesh_cuda", ran=False, devices=count, card=smi)
    else:
        k = min(4, count)
        want = a
        if k != 4:
            want = run_app("cloverleaf2d", make, "ooc-sharded", steps, mesh=f"sim:{k}", **kw)
        info = {}
        for i in range(k):
            torch.cuda.reset_peak_memory_stats(i)
        got = run_app("cloverleaf2d", make, "ooc-sharded", steps, drive=sharded(info),
                      mesh=f"cuda:{k}", **kw)
        info["peak_device_bytes_by_card"] = [torch.cuda.max_memory_allocated(i)
                                             for i in range(k)]
        check(info["exchange_path"] == "peer", f"cuda:{k} exchanged on {info['exchange_path']}")
        check(all(np.array_equal(got["fields"][f], want["fields"][f])
                  for f in APP_FIELDS["cloverleaf2d"]) and got["summary"] == want["summary"],
              f"cuda:{k} is bit-identical to sim:{k}")
        emit(phase="mesh_cuda", ran=True, devices=count, mesh=f"cuda:{k}",
             bit_identical_to_sim=True, card=smi, **info, **mesh_record(got, steps))
    emit(phase="mesh_done", seconds=time.perf_counter() - t_phase, card=smi)


# -- phase 10: serving --------------------------------------------------------------


def mem_available() -> int:
    """The host's available memory in bytes (/proc/meminfo)."""
    for ln in Path("/proc/meminfo").read_text().splitlines():
        if ln.startswith("MemAvailable:"):
            return int(ln.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def release_pinned_cache() -> None:
    """Hand the free blocks of PyTorch's caching host allocator back to the
    OS.  It rounds each page-locked allocation up to a power of two (a
    268.7 MB home takes 512 MiB) and keeps freed blocks for reuse, so the
    blocks of earlier phases' sizes would stay locked beside phase 10's
    four tenants (the whole script ran out of the host's 96 GiB without
    this)."""
    gc.collect()
    torch.cuda.empty_cache()
    empty = getattr(getattr(torch, "accelerator", None), "empty_host_cache", None)
    (empty or torch._C._host_emptyCache)()


SERVE_SPILL = SPILL_ROOT / "serve"
SERVE_PRIORITIES = (0, 1, 0, 1)


def serve_tenants(n: int, mesh: str, cap: float, steps: int, spill: Path,
                  preempt: bool) -> dict:
    """Four CloverLeaf 2D tenants at an n^2 interior, each run from its own
    thread through one ``StencilServer`` on ``mesh`` (lanes on the card,
    ``sjf``, phase 7's ``hw``, capacity and prefetch; traced), with
    priorities 0, 1, 0, 1.  With ``preempt``, tenant ``t0`` is preempted
    after its second chain (it checkpoints under ``spill``, re-queues and
    restores).  The server is closed and the homes dropped before this
    returns; their digests, summaries and the server's records come back."""
    from repro_torch.apps import CloverLeaf2D
    from repro_torch.serve import StencilServer

    release_pinned_cache()
    host = {"before": mem_available()}
    apps = [CloverLeaf2D(n, n, summary_every=2) for _ in SERVE_PRIORITIES]
    for app in apps:
        for d in app.dats.values():
            d.pin()
    pinned = sum(d.nbytes for app in apps for d in app.dats.values()
                 if d.store.tensor().is_pinned())
    host["pinned"] = mem_available()
    summaries, errors = {}, []
    # Auto-preemption is off: with these priorities on two lanes it flags a
    # running priority-0 tenant whenever a priority-1 one waits (7 times in
    # a rehearsal on the CPU), each a checkpoint of all of its homes.
    server = StencilServer(mesh, device="cuda", policy="sjf", capacity_bytes=cap,
                           prefetch=True, trace=True,
                           spill_dir=str(spill), auto_preempt=False)
    try:
        sessions = [server.session(f"t{i}", priority=p)
                    for i, p in enumerate(SERVE_PRIORITIES)]

        def tenant(i: int) -> None:
            try:
                rt = sessions[i]
                if preempt and i == 0:
                    run_chain, done = rt._run, []

                    def counted(chain):
                        run_chain(chain)
                        done.append(1)
                        if len(done) == 2:
                            server.preempt("t0")
                    rt._run = counted
                summaries[i] = apps[i].run(rt, steps=steps)
                rt.close()
            except Exception as e:  # checked after the join
                errors.append((i, repr(e)))

        for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
            ops_fn.launches = 0
        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(len(apps))]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host["served"] = mem_available()
        check(not any(t.is_alive() for t in threads), "every tenant thread finished")
        check(not errors, f"tenant failures: {errors}")
        launches = {"stencil2d": ops.stencil2d.launches,
                    "stencil3d": ops.stencil3d.launches,
                    "chain2d": ops.chain2d.launches}
        peak = torch.cuda.max_memory_allocated() - base
        stats = server.stats()
        tracer = server.tracer
        spans = tracer.spans()
        lanes = server.lanes
        out = {"wall_s": wall, "peak_device_bytes": peak, "pinned_host_bytes": pinned,
               "host_mem_available": host,
               "stats": stats, "spans": spans, "launches": launches,
               "dropped_spans": tracer.dropped,
               "plan_s": {"lanes": [lane.plan_time_s for lane in lanes],
                          "oracle": server.oracle.plan_time_s},
               "lane_chains": [len(lane.history) for lane in lanes],
               "summaries": [summaries[i] for i in range(len(apps))],
               "dt": [app.dt.hex() for app in apps],
               "digests": [home_digests(app) for app in apps]}
        # The drift audit of lane 0's largest chain (a timestep chain).
        ledgers = lanes[0].ledgers
        if ledgers:
            k = max(range(len(lanes[0].history)),
                    key=lambda j: lanes[0].history[j].loop_bytes)
            rep = drift_compare(ledgers[k], tracer, chain=k, tag="lane0/")
            out["drift_lane0"] = {
                "chain": k, "tiles": lanes[0].history[k].num_tiles,
                "streams": {sd.name: {"ratio": sd.ratio, "matched": sd.matched,
                                      "events": sd.events,
                                      "achieved_s": sd.achieved_s,
                                      "modelled_s": sd.modelled_s}
                            for sd in rep.streams.values()}}
    finally:
        server.close()
        del apps
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_record(run: dict, smi: str) -> dict:
    """Phase 10's records from one served run: per tenant its admission
    seconds (the oracle plans there, under its lock), queue wait, predicted
    and achieved modelled seconds and the lanes its chains ran on; per lane its lease seconds and compute device seconds (the CUDA
    event spans); the preemption's checkpoint and restore seconds."""
    spans, stats = run["spans"], run["stats"]
    n_lanes = stats.lanes
    lease = [s for s in spans if s.cat == "lease"]
    tenants = {}
    for name, t in sorted(stats.tenants.items()):
        tenants[name] = {
            "priority": t.priority, "chains": t.chains,
            "queue_wait_s": t.queue_wait_s, "predicted_s": t.predicted_s,
            "achieved_modelled_s": t.achieved_modelled_s,
            "predicted_vs_achieved": t.predicted_vs_achieved,
            "preemptions": t.preemptions, "plan_hits": t.plan_hits,
            "admit_s": sum(s.t_end - s.t_start for s in spans
                           if s.name == "admit" and s.track == f"tenant/{name}"),
            "lanes": [s.args["lane"] for s in sorted(lease, key=lambda s: s.t_start)
                      if s.name == name]}
    serve_s = {k: [s.t_end - s.t_start for s in spans if s.name == k]
               for k in ("preempt-checkpoint", "preempt-restore")}
    return {
        "wall_s": run["wall_s"], "peak_device_bytes": run["peak_device_bytes"],
        "pinned_host_bytes": run["pinned_host_bytes"],
        "host_mem_available": run["host_mem_available"],
        "plan_s": run["plan_s"],
        "plan_s_total": sum(run["plan_s"]["lanes"]) + run["plan_s"]["oracle"],
        "plan_cache": stats.plan_cache, "jobs_completed": stats.jobs_completed,
        "jobs_rejected": stats.jobs_rejected, "preemptions": stats.preemptions,
        "lane_chains": run["lane_chains"], "tenants": tenants,
        "lease_s": [sum(s.t_end - s.t_start for s in lease if s.track == f"lane{i}")
                    for i in range(n_lanes)],
        "compute_device_s": [sum(s.args["device_s"] for s in spans
                                 if s.track == f"lane{i}/compute"
                                 and "device_s" in (s.args or {}))
                             for i in range(n_lanes)],
        "checkpoint_s": serve_s["preempt-checkpoint"],
        "restore_s": serve_s["preempt-restore"],
        "dt_hex": run["dt"], "dropped_spans": run["dropped_spans"],
        "drift_lane0": run.get("drift_lane0"), "launches": run["launches"],
        "card": smi}


def serve_phase(n: int, baseline: dict, smi: str, steps: int = CUT_STEPS,
                n_cuda: int = 512) -> None:
    """Four CloverLeaf 2D tenants at an n^2 interior served on ``sim:2``
    (two lanes sharing the card) at phase 7's capacity, ``t0`` preempted
    after its second chain.  Every tenant's homes and summaries are held
    against phase 7's ``ooc`` run at the same step (``baseline``, phase 7's
    ``at2``), bit for bit.  With two or more cards the same four tenants run
    at ``n_cuda``^2 on ``cuda:2``, bit for bit against ``sim:2`` at that
    size.

    The tenants take ``steps`` = CUT_STEPS timesteps, not phase 7's 4, for
    the script's time limit (as phase 9): the preemption still falls
    mid-run, and every check stays, against a baseline of the same depth."""
    t_phase = time.perf_counter()
    homes = 25 * (n + 4) ** 2 * 4
    cap = homes / 3
    SERVE_SPILL.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(SERVE_SPILL).free
    check(free >= homes, f"{SERVE_SPILL} has {free} bytes free; the preemption "
          f"checkpoint needs {homes}")
    try:
        run = serve_tenants(n, "sim:2", cap, steps, SERVE_SPILL, preempt=True)
        rec = serve_record(run, smi)
        ooc = baseline["ooc"]
        for i, (digests, summary) in enumerate(zip(run["digests"], run["summaries"])):
            check(digests == ooc["digests"] and summary == ooc["summary"],
                  f"tenant t{i} is bit-identical to phase 7's ooc run")
        check(rec["preemptions"] >= 1, f"preemptions {rec['preemptions']}")
        check(rec["jobs_rejected"] == 0, f"jobs rejected {rec['jobs_rejected']}")
        check(run["peak_device_bytes"] < 4 * homes,
              f"peak {run['peak_device_bytes']} B not below the four tenants' homes")
        check(all(s.track.startswith(("lane", "tenant/")) or s.cat == "lease"
                  for s in run["spans"]), "every span is a lane's, a tenant's or a lease")
        check(rec["dropped_spans"] == 0, "the tracer kept every span")
        check(all(v == 0 for v in rec["launches"].values()),
              f"the serve path launches no hand-written kernel: {rec['launches']}")
        emit(phase="serve", app="cloverleaf2d", mesh="sim:2",
             policy="sjf", interior=[n, n], steps=steps, home_bytes_per_tenant=homes,
             capacity_bytes=cap, bit_identical_to_phase7_ooc=True,
             sum_of_alone_ooc_wall_s=4 * ooc["wall_s"],
             served_over_alone=rec["wall_s"] / (4 * ooc["wall_s"]), **rec)
        del run
        count = torch.cuda.device_count()
        if count < 2:
            emit(phase="serve_cuda", ran=False, devices=count, card=smi)
        else:
            cap_s = 25 * (n_cuda + 4) ** 2 * 4 / 3
            want = serve_tenants(n_cuda, "sim:2", cap_s, steps, SERVE_SPILL, preempt=False)
            got = serve_tenants(n_cuda, "cuda:2", cap_s, steps, SERVE_SPILL, preempt=False)
            check(got["digests"] == want["digests"] and got["summaries"] == want["summaries"],
                  "cuda:2 lanes are bit-identical to sim:2")
            emit(phase="serve_cuda", ran=True, devices=count, mesh="cuda:2",
                 interior=[n_cuda, n_cuda], bit_identical_to_sim=True,
                 **serve_record(got, smi))
        emit(phase="serve_done", seconds=time.perf_counter() - t_phase, card=smi)
    finally:
        shutil.rmtree(SERVE_SPILL, ignore_errors=True)


# -- phase 11: model decode ---------------------------------------------------------

MODEL_ARCH = "llama3_2_1b"
MODEL_SEED = 0
MODEL_WINDOW = 3
FP32_STEPS = 4
FP32_TOL = dict(rtol=1e-3, atol=1e-5)


def _kernel_launches() -> dict:
    return {"stencil2d": ops.stencil2d.launches, "stencil3d": ops.stencil3d.launches,
            "chain2d": ops.chain2d.launches}


def _decode_tokens(prompts: torch.Tensor, gen_tokens: int):
    """The launcher's schedule: teacher-forced prompt tokens, then the greedy
    token of the step before (``None`` where it is not known yet)."""
    return [prompts[:, i] for i in range(prompts.shape[1])] + [None] * (gen_tokens - 1)


def resident_decode(model, cache, prompts: torch.Tensor, gen_tokens: int, step=None) -> dict:
    """The launcher's loop on the resident model: a teacher-forced prefill,
    then greedy decode; every step's logits and token kept, each decode step
    timed by CUDA events on the current stream, the prefill by the host clock
    ending in a synchronise.  ``step`` (``decode_step``'s signature without
    the model) is the eager ``decode_step`` unless given."""
    from repro_torch.models import decode_step

    if step is None:
        def step(c, t):
            return decode_step(model, c, t)
    P = prompts.shape[1]
    logits_all, events = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, tok_in in enumerate(_decode_tokens(prompts, gen_tokens)):
        if i == P:
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        if tok_in is None:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            logits, cache = step(cache, tok)
            tok = torch.argmax(logits, -1)
            b.record()
            events.append((a, b))
        else:
            logits, cache = step(cache, tok_in)
            tok = torch.argmax(logits, -1)
        logits_all.append(logits)
    torch.cuda.synchronize()
    decode_wall = time.perf_counter() - t0
    return {"prefill_s": prefill_s, "decode_wall_s": decode_wall,
            "ms": [a.elapsed_time(b) for a, b in events], "logits": logits_all,
            "tokens": torch.stack([torch.argmax(lg, -1) for lg in logits_all[P - 1:]], 1)}


def streamed_decode(streamer, cache, prompts: torch.Tensor, gen_tokens: int,
                    want: dict) -> dict:
    """The same loop through ``streamer``, each step's logits and token held
    against the resident run's on the card (no synchronise in the loop), and
    the device bytes the allocator holds beyond ``base`` sampled after every
    step (``memory_allocated``, host-side), with only the step's token alive."""
    P = prompts.shape[1]
    logits_diff = torch.zeros((), dtype=torch.bool, device="cuda")
    token_diff = torch.zeros((), dtype=torch.bool, device="cuda")
    tok = torch.empty(prompts.shape[0], dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    held, events = [], []
    t0 = time.perf_counter()
    for i, tok_in in enumerate(_decode_tokens(prompts, gen_tokens)):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, cache = streamer.decode(cache, tok if tok_in is None else tok_in)
        tok = torch.argmax(logits, -1)
        b.record()
        events.append((a, b))
        logits_diff |= torch.ne(logits, want["logits"][i]).any()
        if i >= P - 1:
            token_diff |= torch.ne(tok, want["tokens"][:, i - P + 1]).any()
        del logits
        held.append(torch.cuda.memory_allocated() - base)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    return {"wall_s": wall, "ms": ms, "held": held,
            "peak": torch.cuda.max_memory_allocated() - base,
            "logits_equal": not bool(logits_diff), "tokens_equal": not bool(token_diff)}


# Device activities a replayed step runs outside its graph: the token copy,
# the position fill and the logits copy.  More in a profiled replay means the
# profiler sees the graph's own kernels.
GRAPH_OUTSIDE_ACTIVITIES = 3


def card_decoder(model, cache, device):
    """The step phases 11-13 hold against the eager one: a ``DecodeGraph``
    on ``cache`` on the card; on the CPU, where the tests rehearse these
    phases, the eager ``decode_step`` (a graph needs a card)."""
    from repro_torch.models import DecodeGraph, decode_step

    if torch.device(device).type == "cuda":
        return DecodeGraph(model, cache)
    return lambda c, t: decode_step(model, c, t)


def _max_len(cfg, cache) -> int:
    """The slots of ``cache``'s attention caches (``cache_position``'s limit)."""
    key = "sk" if cfg.family == "hybrid" else ("ckv" if cfg.mla else "k")
    return cache[key].shape[2]


def cache_full_check(cfg, cache, step, tok: torch.Tensor) -> dict:
    """``step`` driven greedily from ``tok`` to ``cache``'s last slot, then
    one token more: it must raise ``CacheFullError`` and leave every cache
    tensor and ``len`` as they were (held against clones).  A pure ssm cache
    has no length and decodes on: not checked."""
    from repro_torch.models import CacheFullError

    if cfg.family == "ssm":
        return {"checked": False, "why": "a pure ssm cache has no length: it decodes on"}
    max_len = _max_len(cfg, cache)
    steps = 0
    while cache["len"] < max_len:
        logits, cache = step(cache, tok)
        tok = torch.argmax(logits, -1)
        steps += 1
    before = {k: v.clone() for k, v in cache.items() if k != "len"}
    raised = None
    try:
        step(cache, tok)
    except CacheFullError as e:
        raised = str(e)
    check(raised is not None, f"no CacheFullError past the cache's {max_len} slots")
    unchanged = cache["len"] == max_len and all(torch.equal(v, cache[k])
                                                for k, v in before.items())
    check(unchanged, "a step past the cache's last slot changed the cache")
    return {"checked": True, "max_len": max_len, "steps_to_full": steps, "raised": raised,
            "cache_unchanged": unchanged}


def graphed_decode(phase: str, arch: str, model, fresh, prompts: torch.Tensor,
                   gen_tokens: int, want: dict, bound_ms: float, smi: str,
                   device: str = "cuda") -> dict:
    """The launcher's loop again, from ``fresh()`` (a new cache) on the same
    prompts, through ``card_decoder``'s step: every step's logits
    ``torch.equal`` to the eager run ``want``'s; ms a token replayed (CUDA
    events) beside eager and the step's byte bound; the graph's warm-up
    steps, capture seconds and pool bytes; peak device memory with the eager
    run's logits and both caches present; then ``cache_full_check`` on this
    cache.  Emits a ``phase`` record and returns the run."""
    from repro_torch.models import DecodeGraph

    t_part = time.perf_counter()
    cache = fresh()
    torch.cuda.reset_peak_memory_stats()
    step = card_decoder(model, cache, device)
    got = resident_decode(model, cache, prompts, gen_tokens, step=step)
    peak = torch.cuda.max_memory_allocated()
    same = [torch.equal(a, b) for a, b in zip(want["logits"], got["logits"])]
    check(len(same) == len(want["logits"]) and all(same),
          f"{arch}: replayed steps {[i for i, s in enumerate(same) if not s]} differ "
          f"from the eager run's")
    full = cache_full_check(model.cfg, cache, step, got["tokens"][:, -1])
    graphed = isinstance(step, DecodeGraph)
    ms, eager_ms = statistics.median(got["ms"]), statistics.median(want["ms"])
    rec = dict(phase=phase, arch=arch, graphed=graphed, steps_equal=len(same),
               prefill_s=got["prefill_s"], decode_wall_s=got["decode_wall_s"],
               eager_ms_per_token_median=eager_ms, replay_ms_per_token_median=ms,
               replay_ms_per_token=got["ms"], tokens_per_s=prompts.shape[0] * 1e3 / ms,
               bytes_bound_ms=bound_ms, eager_over_bound=eager_ms / bound_ms,
               replay_over_bound=ms / bound_ms, eager_over_replay=eager_ms / ms,
               peak_device_bytes=peak, reserved_bytes=torch.cuda.memory_reserved(),
               cache_full=full, seconds=time.perf_counter() - t_part, card=smi)
    if graphed:
        rec.update(warmup_steps=step.WARMUP_STEPS, warmup_sync_debug=step.SYNC_DEBUG,
                   capture_s=step.capture_s, pool_bytes=step.pool_bytes,
                   replays=step.replays)
    emit(**rec)
    return got


def fp32_check(model, prompts: torch.Tensor) -> dict:
    """The same weights cast to fp32 (TF32 off): FP32_STEPS teacher-forced
    decode steps on the card through a ``DecodeGraph`` (one warm-up step,
    the rest replayed) and the same steps on the CPU through
    ``decode_step``; the logits held at FP32_TOL."""
    import copy

    from repro_torch.models import decode_step, init_cache

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m32 = copy.deepcopy(model).float()
        m32.cfg = model.cfg.with_(dtype="float32")
        out = {}
        for dev in ("cuda", "cpu"):
            if dev == "cpu":
                m32 = m32.to("cpu")
            cache = init_cache(m32.cfg, prompts.shape[0], FP32_STEPS, device=dev)
            step = (card_decoder(m32, cache, dev) if dev == "cuda"
                    else (lambda c, t: decode_step(m32, c, t)))
            t0 = time.perf_counter()
            steps = []
            for i in range(FP32_STEPS):
                logits, cache = step(cache, prompts[:, i].to(dev))
                steps.append(logits.cpu())
            out[dev] = (steps, time.perf_counter() - t0, getattr(step, "replays", 0))
            del step
        del m32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs, ok = [], True
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        errs.append(float((got - want).abs().max()))
        ok = ok and torch.allclose(got, want, **FP32_TOL)
    return {"steps": FP32_STEPS, "card_replays": out["cuda"][2], "max_abs_diff": max(errs),
            "max_abs_diff_per_step": errs,
            "max_abs_logit": float(max(w.abs().max() for w in out["cpu"][0])),
            "within_tolerance": ok, "cuda_s": out["cuda"][1], "cpu_s": out["cpu"][1],
            "tolerance": FP32_TOL}


def launcher_subprocess(smi: str, arch: str, extra, rc: int) -> None:
    """``python -m repro_torch.launch.serve --arch <arch> --reduced`` plus
    ``extra`` on the card (its default device) as a subprocess, which must
    exit ``rc``; its last line recorded."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
           "--reduced"] + list(extra)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(root))
    check(out.returncode == rc, f"{' '.join(cmd[1:])} exited {out.returncode}, "
          f"not {rc}: {out.stderr[-2000:]}")
    lines = (out.stdout if rc == 0 else out.stderr).strip().splitlines()
    check(rc != 0 or "--offload" in extra or "graph_capture=" in lines[-1],
          f"{' '.join(cmd[1:])} served through the graph: {lines[-1]!r}")
    emit(phase="model_launcher", args=cmd[3:], how="subprocess", rc=out.returncode,
         seconds=time.perf_counter() - t0, line=lines[-1] if lines else "", card=smi)


def launcher_runs(smi: str, arch: str, modes) -> None:
    """The launcher's ``main(["--arch", arch, "--reduced"] + extra)`` in this
    process, on the card (its default device), once for each of ``modes``
    (extra arguments, the exit code it must give): resident runs must end
    with the decode line naming the arch, refused ones (2) with the
    launcher's reason; each last line recorded.  In-process, a call costs
    no interpreter start-up (about 10 s a subprocess)."""
    import contextlib
    import io

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as launch_serve

    name = get_reduced_config(arch).name
    for extra, rc in modes:
        argv = ["--arch", arch, "--reduced"] + list(extra)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            got = launch_serve.main(argv)
        lines = (out if rc == 0 else err).getvalue().strip().splitlines()
        line = lines[-1] if lines else ""
        check(got == rc, f"launch.serve.main({argv}) returned {got}, not {rc}: "
              f"{err.getvalue()[-2000:]}")
        check(line.startswith(f"arch={name} ") if rc == 0
              else "--offload supports dense/vlm families" in line,
              f"launch.serve.main({argv}) ended with {line!r}")
        check(rc != 0 or ("graph_capture=" in line) != ("--offload" in extra),
              f"launch.serve.main({argv}) served resident through the graph, streamed "
              f"eagerly: {line!r}")
        emit(phase="model_launcher", args=argv, how="in-process", rc=got,
             seconds=time.perf_counter() - t0, line=line, card=smi)


def model_phase(smi: str, batch: int = 4, prompt_len: int = 32, gen_tokens: int = 32) -> None:
    """Llama 3.2 1B at its published config, seeded random weights made on the
    card: the launcher's decode resident, eager, then through the graph
    (``graphed_decode``: every step equal to the eager run, the cache-full
    check), 4 profiled steps of each, an fp32 check of the graphed card
    against the CPU, then the same weights through a ``StreamedDecoder`` of
    MODEL_WINDOW slots (every step's logits and tokens equal to the graphed
    resident run's, the device bytes of the slots measured), and the
    launcher resident as a subprocess and streamed in-process.  No
    hand-written kernel may launch."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.offload import StreamedDecoder

    t_phase = time.perf_counter()
    release_pinned_cache()
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    cfg = get_config(MODEL_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.d_ff,
           cfg.vocab_size, cfg.dtype, cfg.tie_embeddings)
          == (16, 2048, 32, 8, 8192, 128256, "bfloat16", True),
          f"{MODEL_ARCH} is at its published config")
    max_len = prompt_len + gen_tokens
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(MODEL_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init_params(cfg, generator=gen, device="cuda")
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        slice_bytes = sum(p.numel() * p.element_size() for p in model.blocks[0].parameters())
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == cfg.param_count() + cfg.d_model,  # its count leaves out the final norm
              f"{n_params} parameters against the config's count")

        torch.cuda.reset_peak_memory_stats()
        cache = init_cache(cfg, batch, max_len, device="cuda")
        want = resident_decode(model, cache, prompts, gen_tokens)
        res_peak = torch.cuda.max_memory_allocated()
        check(all(bool(torch.isfinite(lg).all()) for lg in want["logits"]),
              "resident logits are finite")
        check(want["logits"][0].dtype == torch.bfloat16, "bf16 logits")
        res_ms = statistics.median(want["ms"])
        bound_ms = weight_bytes / PEAK_BYTES_S * 1e3
        emit(phase="model_resident", arch=MODEL_ARCH, params=n_params,
             weight_bytes=weight_bytes, batch=batch, prompt_len=prompt_len,
             gen_tokens=gen_tokens, init_s=init_s, prefill_s=want["prefill_s"],
             decode_ms_per_token_median=res_ms, decode_ms_per_token=want["ms"],
             tokens_per_s=batch * 1e3 / res_ms, decode_wall_s=want["decode_wall_s"],
             weights_bytes_bound_ms=bound_ms, over_bound=res_ms / bound_ms,
             peak_device_bytes=res_peak, sample=want["tokens"][0, :8].tolist(), card=smi)
        graphed = graphed_decode("model_graph", MODEL_ARCH, model,
                                 lambda: init_cache(cfg, batch, max_len, device="cuda"),
                                 prompts, gen_tokens, want, bound_ms, smi)
        del want
        for graph in (False, True):
            decode_profile("model_graph_profile" if graph else "model_profile", MODEL_ARCH,
                           model, init_cache(cfg, batch, MOE_PROFILED_STEPS + 3, device="cuda"),
                           prompts, smi, graphed=graph)

        fp32 = fp32_check(model, prompts)
        emit(phase="model_fp32", arch=MODEL_ARCH, **fp32, card=smi)
        check(fp32["within_tolerance"],
              f"fp32 logits on the card against the CPU: max diff {fp32['max_abs_diff']}")

        t0 = time.perf_counter()
        streamer = StreamedDecoder(model, window=MODEL_WINDOW)
        pin_s = time.perf_counter() - t0
        check(all(h.is_pinned() for h in streamer.host), "host slices are pinned")
        del model.blocks                      # the layers now live in host memory only
        gc.collect()
        torch.cuda.empty_cache()
        cache = init_cache(cfg, batch, max_len, device="cuda")
        run = streamed_decode(streamer, cache, prompts, gen_tokens, graphed)
        upload_s = streamer.upload_seconds()
        check(run["logits_equal"],
              "every streamed step's logits equal the graphed resident run's")
        check(run["tokens_equal"], "the streamed tokens equal the graphed resident run's")
        held = max(run["held"])
        check(held <= MODEL_WINDOW * slice_bytes,
              f"device weight bytes {held} within {MODEL_WINDOW} slices of {slice_bytes}")
        st = streamer.stats
        steps = len(run["ms"])
        stream_ms = statistics.median(run["ms"])
        h2d = st.uploaded_bytes / upload_s
        per_step = cfg.num_layers * slice_bytes
        emit(phase="model_streamed", arch=MODEL_ARCH, window=MODEL_WINDOW,
             steps=steps, slice_bytes=slice_bytes, device_weight_bytes_held=held,
             device_weight_bytes_held_first=run["held"][0],
             peak_device_bytes_over_base=run["peak"],
             pinned_host_bytes=sum(h.numel() * h.element_size() for h in streamer.host),
             pin_s=pin_s, uploaded_bytes=st.uploaded_bytes,
             uploads_timed=st.uploads_timed, upload_device_s=upload_s, h2d_gb_s=h2d / 1e9,
             ms_per_step_median=stream_ms, ms_per_step=run["ms"],
             link_bound_ms=per_step / h2d * 1e3, bytes_per_step=per_step,
             resident_ms_per_token=res_ms, modelled_step_ms=st.modelled_step_s * 1e3,
             modelled_hw=f"modelled, {streamer.hw.name}", wall_s=run["wall_s"],
             logits_equal=True, tokens_equal=True, card=smi)
        del streamer, graphed, model, cache
        gc.collect()
        torch.cuda.empty_cache()
    release_pinned_cache()
    launcher_subprocess(smi, MODEL_ARCH, [], 0)
    launcher_runs(smi, MODEL_ARCH, ((["--offload"], 0),))
    launches = _kernel_launches()
    check(all(v == 0 for v in launches.values()),
          f"model decode launches no hand-written kernel: {launches}")
    emit(phase="model_done", seconds=time.perf_counter() - t_phase, launches=launches,
         card=smi)


# -- phase 12: moe decode -----------------------------------------------------------

# Each moe arch's published widths: layers, d, heads, KV heads, experts,
# top-k, expert ff, shared experts, dense layers (and their ff), vocabulary,
# MLA (r, dn, dr, dv), untied embeddings.
MOE_PUBLISHED = {
    "qwen3_moe_30b_a3b": (48, 2048, 32, 4, 128, 8, 768, 0, 0, 0, 151936,
                          (False, 0, 0, 0, 0), False),
    "deepseek_v2_lite_16b": (27, 2048, 16, 16, 64, 6, 1408, 2, 1, 10944, 102400,
                             (True, 512, 128, 64, 128), False),
}
MOE_SEED = 0
MOE_FP32_LAYERS = 2
MOE_PROFILED_STEPS = 4
MOE_HEADROOM = 4e9          # init's fp32 draws (the embedding's: 1.24 GB) and the caches


def _published(cfg) -> tuple:
    return (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.num_experts,
            cfg.experts_per_token, cfg.moe_d_ff, cfg.num_shared_experts,
            cfg.first_dense_layers, cfg.dense_d_ff, cfg.vocab_size,
            (cfg.mla, cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim),
            cfg.tie_embeddings)


def moe_weight_bytes(cfg) -> int:
    """The bytes of ``cfg``'s weights in the port's layout: its parameter
    count (one FFN a layer), the final norm it leaves out, fp32 routers."""
    es = torch.empty((), dtype=cfg.torch_dtype).element_size()
    routers = (cfg.num_layers - cfg.first_dense_layers) * cfg.d_model * cfg.num_experts
    return (cfg.param_count() + cfg.d_model) * es + routers * (4 - es)


class routing_log:
    """Within the block, every routing decision of the port's ``moe_ffn``
    (``models.moe.route``, called by name) appends its ``topk_idx`` and
    ``probs`` to ``calls``, on the CPU; with ``inputs``, the router's input
    tokens (fp32) to ``inputs``."""

    def __init__(self, inputs: bool = False):
        self.calls = []
        self.inputs = [] if inputs else None

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self._mod, self._route = moe_mod, moe_mod.route

        def logged(router, tokens, cfg):
            r = self._route(router, tokens, cfg)
            self.calls.append((r.topk_idx.cpu(), r.probs.cpu()))
            if self.inputs is not None:
                self.inputs.append(tokens.float().cpu())
            return r
        moe_mod.route = logged
        return self

    def __exit__(self, *exc):
        self._mod.route = self._route


def moe_fp32_check(cfg, prompts: torch.Tensor, device: str = "cuda") -> dict:
    """``cfg``'s published widths at MOE_FP32_LAYERS layers in fp32 (TF32
    off): FP32_STEPS teacher-forced decode steps on ``device`` and on the
    CPU, every layer's routing compared first, then the logits at FP32_TOL.
    The card runs twice: eagerly, which logs its routing (a replay calls no
    Python), and through a ``DecodeGraph`` (one warm-up step, the rest
    replayed), whose logits are the ones held at FP32_TOL and must equal the
    eager run's.  ``min_gap`` is the smallest gap between a token's k-th and
    (k+1)-th router probability on the CPU: how near a routing decision came
    to a tie."""
    from repro_torch.models import decode_step, init_cache, init_params

    cfg = cfg.with_(num_layers=MOE_FP32_LAYERS, dtype="float32")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gen = torch.Generator(device=device).manual_seed(MOE_SEED + 1)
        model = init_params(cfg, generator=gen, device=device)
        out = {}
        for role, dev in (("card", device), ("graph", device), ("cpu", "cpu")):
            model = model.to(dev)
            cache = init_cache(cfg, prompts.shape[0], FP32_STEPS, device=dev)
            step = (card_decoder(model, cache, dev) if role == "graph"
                    else (lambda c, t: decode_step(model, c, t)))
            log = routing_log()
            t0 = time.perf_counter()
            steps = []
            # the log copies each routing to the host: not inside a graph
            with log if role != "graph" else contextlib.nullcontext():
                for i in range(FP32_STEPS):
                    logits, cache = step(cache, prompts[:, i].to(dev))
                    steps.append(logits.cpu())
            out[role] = (steps, log.calls, time.perf_counter() - t0,
                         getattr(step, "replays", 0))
            del step
        del model, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    k = cfg.experts_per_token
    calls = list(zip(out["card"][1], out["cpu"][1]))
    flips = [i for i, ((a, _), (b, _)) in enumerate(calls) if not torch.equal(a, b)]
    gaps = []
    for _, (_, probs) in calls:
        top = probs.sort(-1, descending=True).values
        gaps.append(float((top[:, k - 1] - top[:, k]).min()))
    errs, ok = [], True
    for got, want in zip(out["graph"][0], out["cpu"][0]):
        errs.append(float((got - want).abs().max()))
        ok = ok and torch.allclose(got, want, **FP32_TOL)
    return {"layers": MOE_FP32_LAYERS, "steps": FP32_STEPS,
            "routing_calls": len(calls), "routing_equal": not flips and bool(calls),
            "routing_flips": flips, "min_gap": min(gaps), "min_gap_per_call": gaps,
            "graph_replays": out["graph"][3],
            "graph_equals_eager": all(torch.equal(a, b)
                                      for a, b in zip(out["graph"][0], out["card"][0])),
            "max_abs_diff": max(errs), "max_abs_diff_per_step": errs,
            "max_abs_logit": float(max(w.abs().max() for w in out["cpu"][0])),
            "within_tolerance": ok, "card_s": out["card"][2], "graph_s": out["graph"][2],
            "cpu_s": out["cpu"][2], "tolerance": FP32_TOL}


def decode_profile(phase: str, arch: str, model, cache, prompts: torch.Tensor, smi: str,
                   steps: int = MOE_PROFILED_STEPS, graphed: bool = False) -> None:
    """``steps`` teacher-forced decode steps on ``cache``, a fresh one of at
    least ``steps + 3`` positions, under ``torch.profiler`` (device activity
    only; after two unprofiled steps, or with ``graphed`` through a
    ``DecodeGraph``, after its warm-up step and the capture, so every
    profiled step is a replay): the card's busy and idle share of the
    host's wall, and the kernels that took its time, as a ``phase`` record.
    The profiler slows the host, so the wall here is above the unprofiled
    runs'.  A graphed record says whether the profiler saw the graph's own
    kernels (more than GRAPH_OUTSIDE_ACTIVITIES activities a step)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import DecodeGraph, decode_step

    t_part = time.perf_counter()
    if graphed:
        step = DecodeGraph(model, cache)
        lead = step.WARMUP_STEPS + 1
    else:
        def step(c, t):
            return decode_step(model, c, t)
        lead = 2
    for i in range(lead):
        step(cache, prompts[:, i])
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(lead, lead + steps):
            step(cache, prompts[:, i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_stop = time.perf_counter()
    t_events = time.perf_counter()
    busy_s, work_s, count, top = device_activity(prof)
    rec = dict(phase=phase, arch=arch, steps=steps, graphed=graphed, wall_s=wall,
               seconds=time.perf_counter() - t_part, profiler_start_s=t0 - t_start,
               profiler_stop_s=t_events - t_stop,
               events_s=time.perf_counter() - t_events,
               ms_per_step=wall / steps * 1e3, device_busy_ms_per_step=busy_s / steps * 1e3,
               device_idle_share=1 - busy_s / wall, device_work_s=work_s,
               device_activities_per_step=count / steps, top_device_ms=top, card=smi)
    if graphed:
        rec.update(replays=step.replays,
                   profiler_sees_graph_kernels=count / steps > GRAPH_OUTSIDE_ACTIVITIES)
    emit(**rec)


def moe_decode(arch: str, smi: str, batch: int, prompt_len: int, gen_tokens: int,
               device: str = "cuda") -> None:
    """One moe arch at its published config, seeded bf16 weights made on the
    card: the launcher's decode resident, eager, then from a fresh cache
    through the graph (``graphed_decode``: every step's logits
    ``torch.equal`` to the eager run's, the cache-full check), both
    profiled; then the fp32 check.  (``device`` is the card; the CPU test of
    this phase passes ``"cpu"``.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.moe import capacity

    cfg = get_config(arch)
    check(_published(cfg) == MOE_PUBLISHED[arch] and cfg.dtype == "bfloat16",
          f"{arch} is at its published config")
    weight_bytes = moe_weight_bytes(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    check(free >= weight_bytes + MOE_HEADROOM,
          f"{arch}: {free} B free on the card, the model needs {weight_bytes} B "
          f"and {MOE_HEADROOM:.0f} B of headroom (of {total})")
    max_len = prompt_len + gen_tokens
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(MOE_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init_params(cfg, generator=gen, device=device)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        held = sum(p.numel() * p.element_size() for p in model.parameters())
        check(n_params == cfg.param_count() + cfg.d_model,  # its count leaves out the final norm
              f"{n_params} parameters against the config's count")
        check(held == weight_bytes, f"{held} weight bytes, {weight_bytes} expected")
        cache = init_cache(cfg, batch, max_len, device=device)
        per_token_layer = sum(cache[key][0, 0, 0].numel() * cache[key].element_size()
                              for key in cache if key != "len")
        want = resident_decode(model, cache, prompts, gen_tokens)
        check(all(bool(torch.isfinite(lg).all()) for lg in want["logits"]),
              "resident logits are finite")
        check(want["logits"][0].dtype == torch.bfloat16, "bf16 logits")
        peak = torch.cuda.max_memory_allocated()
        # a step reads every weight but the embedding table, of which it
        # gathers one row a sequence: C = T at this batch, so every expert runs
        embed = model.embed.numel() * model.embed.element_size()
        bound_bytes = weight_bytes - embed + batch * cfg.d_model * model.embed.element_size()
        bound_ms = bound_bytes / PEAK_BYTES_S * 1e3
        graphed = graphed_decode("moe_graph", arch, model,
                                 lambda: init_cache(cfg, batch, max_len, device=device),
                                 prompts, gen_tokens, want, bound_ms, smi, device)
        ms = statistics.median(want["ms"])
        emit(phase="moe_resident", arch=arch, params=n_params, weight_bytes=weight_bytes,
             active_params=cfg.active_param_count(), free_before=free,
             batch=batch, prompt_len=prompt_len, gen_tokens=gen_tokens,
             capacity=capacity(cfg, batch), experts=cfg.num_experts, init_s=init_s,
             prefill_s=want["prefill_s"], decode_ms_per_token_median=ms,
             decode_ms_per_token=want["ms"], tokens_per_s=batch * 1e3 / ms,
             decode_wall_s=want["decode_wall_s"],
             steps_equal=len(graphed["logits"]), bytes_bound=bound_bytes,
             bytes_bound_ms=bound_ms,
             over_bound=ms / bound_ms, peak_device_bytes=peak,
             cache_bytes_per_token_layer=per_token_layer,
             sample=want["tokens"][0, :8].tolist(), card=smi)
        if device == "cuda":
            for graph in (False, True):
                decode_profile("moe_graph_profile" if graph else "moe_profile", arch, model,
                               init_cache(cfg, batch, MOE_PROFILED_STEPS + 3, device=device),
                               prompts, smi, graphed=graph)
        del model, cache, want, graphed
        gc.collect()
        torch.cuda.empty_cache()
        fp32 = moe_fp32_check(cfg, prompts, device)
        emit(phase="moe_fp32", arch=arch, **fp32, card=smi)
        check(fp32["routing_equal"],
              f"{arch}: routing on the card differs from the CPU at calls "
              f"{fp32['routing_flips']} (smallest top-k gap {fp32['min_gap']})")
        check(fp32["graph_equals_eager"],
              f"{arch}: fp32 replayed logits differ from the eager run's on the card")
        check(fp32["within_tolerance"],
              f"{arch}: fp32 logits on the card against the CPU: max diff "
              f"{fp32['max_abs_diff']}")
        gc.collect()
        torch.cuda.empty_cache()


def moe_phase(smi: str, batch: int = 4, prompt_len: int = 32, gen_tokens: int = 32) -> None:
    """Qwen3-MoE 30B-A3B and DeepSeek-V2-Lite at their published configs, one
    after the other (``moe_decode``), then the launcher on both reduced
    archs (resident exits 0, ``--offload`` 2).  No hand-written kernel may
    launch."""
    t_phase = time.perf_counter()
    release_pinned_cache()
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    emit(phase="moe_start", allocated=torch.cuda.memory_allocated(),
         reserved=torch.cuda.memory_reserved(), card=smi)
    for arch in MOE_PUBLISHED:
        moe_decode(arch, smi, batch, prompt_len, gen_tokens)
    for arch in MOE_PUBLISHED:
        launcher_runs(smi, arch, (([], 0), (["--offload"], 2)))
    launches = _kernel_launches()
    check(all(v == 0 for v in launches.values()),
          f"moe decode launches no hand-written kernel: {launches}")
    emit(phase="moe_done", seconds=time.perf_counter() - t_phase, launches=launches,
         card=smi)


# -- phase 13: ssm, hybrid and encdec decode ------------------------------------------

# Each arch's published widths: family, layers, encoder layers, d, heads, KV
# heads, ff, vocabulary, tied embeddings, ssm state, head dim, expand, conv,
# shared-block cadence.
SSM_PUBLISHED = {
    "mamba2_1_3b": ("ssm", 48, 0, 2048, 1, 1, 0, 50280, False, 128, 64, 2, 4, 0),
    "zamba2_1_2b": ("hybrid", 38, 0, 2048, 32, 32, 8192, 32000, False, 64, 64, 2, 4, 6),
    "whisper_medium": ("encdec", 24, 24, 1024, 16, 16, 4096, 51865, False, 0, 64, 2, 4, 0),
}
SSM_SEED = 0
INC_TOL = dict(rtol=2e-2, atol=2e-3)      # tests/test_models.py's incremental-vs-full
# At full depth the ssm stacks' fp32 rounding grows past FP32_TOL on the CPU
# itself (Mamba2's 48 layers: the CPU's fp32 logits 1.7e-4 from an fp64 run,
# the card's 1.1e-4), so the card is held against an fp64 run instead: no
# farther from it than this many times the CPU's fp32 run.
FP64_RATIO = 2.0


def _ssm_published(cfg) -> tuple:
    return (cfg.family, cfg.num_layers, cfg.enc_layers, cfg.d_model, cfg.num_heads,
            cfg.kv_heads, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings, cfg.ssm_state,
            cfg.ssm_headdim, cfg.ssm_expand, cfg.ssm_conv, cfg.shared_attn_every)


def fresh_cache(cfg, batch: int, max_len: int, device, enc_len: int):
    """The launcher's cache: for encdec, ``enc_len`` encoder positions of
    K/V stubbed at 0.01, as ``launch/serve.py`` (and the reference's) fill them."""
    from repro_torch.models import init_cache

    cache = init_cache(cfg, batch, max_len, enc_len=enc_len, device=device)
    if cfg.encdec:
        cache["enc_k"].fill_(0.01)
        cache["enc_v"].fill_(0.01)
    return cache


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ssm_step_bytes(model, batch: int) -> dict:
    """The bytes one decode step of ``model`` must move: each weight it reads
    once (the embedding table's ``batch`` rows; the hybrid's shared block at
    each of its sites; for encdec the decoder without its cross-attention's
    ``wk``/``wv``, whose products the cached ``enc_k``/``enc_v`` hold, and no
    encoder weight), and the ssm and conv states, read and written.  The
    attention caches' reads (under 1.3% here) are left out."""
    cfg = model.cfg
    weights = (_nbytes(model.parameters()) - _nbytes([model.embed])
               + batch * cfg.d_model * model.embed.element_size())
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.shared_attn_every
        weights += (sites - 1) * _nbytes(model.shared_block.parameters())
    if cfg.family == "encdec":
        weights -= (_nbytes(model.enc_blocks.parameters()) + _nbytes([model.enc_norm])
                    + _nbytes(t for b in model.blocks for t in (b.xattn.wk, b.xattn.wv)))
    state = 0
    if cfg.family in ("ssm", "hybrid"):
        es = model.embed.element_size()
        state = 2 * cfg.num_layers * batch * (
            cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
            + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * es)
    return {"weights": weights, "state": state, "total": weights + state}


def family_fp32_check(model, prompts: torch.Tensor, enc_inputs=None,
                      device: str = "cuda") -> dict:
    """An fp32 copy of ``model`` at full depth (TF32 off), run three ways:
    on ``device`` (through a ``DecodeGraph``, one warm-up step, the rest
    replayed), on the CPU, and on the CPU with fp64 weights and
    activations (the port keeps fp32 inside its norms, rope, attention and
    scan, so this run is more precise, not exact).  Each runs the
    launcher's teacher-forced decode (on ``device``, ssm and hybrid: over
    the whole prompt, and ``forward`` over the prompt held against those
    steps at INC_TOL, the chunked scan against the recurrence; otherwise
    FP32_STEPS steps), and encdec its ``forward`` with ``enc_inputs``.

    The card's first FP32_STEPS steps (and encdec's forward) are held
    against the fp64 run: at most FP64_RATIO times as far from it as the
    CPU's fp32 run is (``as_accurate_as_cpu``).  The card against the CPU
    at FP32_TOL is recorded as ``within_tolerance``."""
    import copy

    from repro_torch.models import decode_step, forward

    B, P = prompts.shape
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    cfg = model.cfg.with_(dtype="float32")
    scan = cfg.family in ("ssm", "hybrid")
    try:
        m = None
        for role, dev, dtype in (("card", device, torch.float32),
                                 ("cpu", "cpu", torch.float32),
                                 ("fp64", "cpu", torch.float64)):
            t0 = time.perf_counter()
            if role == "fp64":
                m = m.double()
            else:       # the bf16 weights copied to ``dev``, then cast there
                m = None    # the card's copy goes first
                m = copy.deepcopy(model).to(dev).float()
                m.cfg = cfg
            copy_s = time.perf_counter() - t0
            n = P if scan and role == "card" else FP32_STEPS
            cache = fresh_cache(cfg, B, n, dev, enc_len=P)
            step = (card_decoder(m, cache, dev) if role == "card"
                    else (lambda c, t: decode_step(m, c, t)))
            t0 = time.perf_counter()
            steps = [step(cache, prompts[:, i].to(dev))[0] for i in range(n)]
            rec = {"steps": torch.stack(steps, 1).cpu().double(),
                   "replays": getattr(step, "replays", 0)}
            if scan and role == "card":
                rec["forward"] = forward(m, prompts).cpu().double()
            if cfg.encdec:
                rec["forward"] = forward(m, prompts.to(dev),
                                         enc_inputs=enc_inputs.to(dev, dtype)).cpu().double()
            rec["s"] = time.perf_counter() - t0
            rec["copy_s"] = copy_s
            out[role] = rec
            del cache, steps, step
        del m
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def maxdiff(a, b) -> float:
        return float((a - b).abs().max())

    card, cpu, ref = (out[r]["steps"][:, :FP32_STEPS] for r in ("card", "cpu", "fp64"))
    res = {"steps": FP32_STEPS,
           "max_abs_diff": maxdiff(card, cpu),
           "max_abs_diff_per_step": [maxdiff(card[:, i], cpu[:, i]) for i in range(FP32_STEPS)],
           "max_abs_logit": float(ref.abs().max()),
           "within_tolerance": bool(torch.allclose(card, cpu, **FP32_TOL)),
           "tolerance": FP32_TOL,
           "card_replays": out["card"]["replays"],
           "card_vs_fp64": maxdiff(card, ref), "cpu_vs_fp64": maxdiff(cpu, ref),
           "as_accurate_as_cpu": maxdiff(card, ref) <= FP64_RATIO * maxdiff(cpu, ref),
           "fp64_ratio": FP64_RATIO,
           "card_s": out["card"]["s"], "cpu_s": out["cpu"]["s"], "fp64_s": out["fp64"]["s"],
           "copy_s": {r: out[r]["copy_s"] for r in out}}
    if scan:
        full, inc = out["card"]["forward"], out["card"]["steps"]
        res.update(forward_vs_decode_steps=P,
                   forward_vs_decode_max_abs_diff=maxdiff(full, inc),
                   forward_vs_decode_ok=bool(torch.allclose(full, inc, **INC_TOL)),
                   forward_vs_decode_tolerance=INC_TOL)
    if cfg.encdec:
        a, b, r = (out[k]["forward"] for k in ("card", "cpu", "fp64"))
        res.update(forward_shape=list(a.shape), enc_inputs_shape=list(enc_inputs.shape),
                   forward_max_abs_diff=maxdiff(a, b), forward_max_abs_logit=float(r.abs().max()),
                   forward_within_tolerance=bool(torch.allclose(a, b, **FP32_TOL)),
                   forward_card_vs_fp64=maxdiff(a, r), forward_cpu_vs_fp64=maxdiff(b, r),
                   forward_ok=maxdiff(a, r) <= FP64_RATIO * maxdiff(b, r))
    return res


def ssm_decode(arch: str, smi: str, batch: int, prompt_len: int, gen_tokens: int,
               device: str = "cuda") -> None:
    """One ssm, hybrid or encdec arch at its published config, seeded bf16
    weights made on the card: the launcher's decode resident (encdec's
    encoder K/V stubbed as the launcher stubs them), eager, then from a
    fresh cache through the graph (``graphed_decode``: every step
    ``torch.equal`` to the eager run, the cache-full check), their ms a
    token beside the byte bound of a step, 4 profiled steps of each, then
    the fp32 checks.  (``device`` is the card; the CPU test of this phase
    passes ``"cpu"``.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(arch)
    check(_ssm_published(cfg) == SSM_PUBLISHED[arch] and cfg.dtype == "bfloat16",
          f"{arch} is at its published config")
    max_len = prompt_len + gen_tokens
    gc.collect()
    torch.cuda.empty_cache()
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(SSM_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init_params(cfg, generator=gen, device=device)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                device=device)
        enc_inputs = (torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                                  device=device) if cfg.encdec else None)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        fp32_params = sum(p.numel() for p in model.parameters() if p.dtype == torch.float32)
        step = ssm_step_bytes(model, batch)
        cache = fresh_cache(cfg, batch, max_len, device, enc_len=prompt_len)
        cache_bytes = {k: _nbytes([v]) for k, v in cache.items() if k != "len"}
        want = resident_decode(model, cache, prompts, gen_tokens)
        check(all(bool(torch.isfinite(lg).all()) for lg in want["logits"]),
              f"{arch}: resident logits are finite")
        check(want["logits"][0].dtype == torch.bfloat16, "bf16 logits")
        check(cache["len"] == max_len - 1, f"{arch}: cache len {cache['len']}")
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(want["ms"])
        bound_ms = step["total"] / PEAK_BYTES_S * 1e3
        emit(phase="ssm_resident", arch=arch, family=cfg.family, params=n_params,
             params_config=cfg.param_count(), fp32_params=fp32_params,
             weight_bytes=_nbytes(model.parameters()), batch=batch,
             prompt_len=prompt_len, gen_tokens=gen_tokens, init_s=init_s,
             prefill_s=want["prefill_s"], decode_ms_per_token_median=ms,
             decode_ms_per_token=want["ms"], tokens_per_s=batch * 1e3 / ms,
             decode_wall_s=want["decode_wall_s"], bytes_bound=step,
             bytes_bound_ms=bound_ms, over_bound=ms / bound_ms, cache_bytes=cache_bytes,
             peak_device_bytes=peak, sample=want["tokens"][0, :8].tolist(), card=smi)
        graphed = graphed_decode("ssm_graph", arch, model,
                                 lambda: fresh_cache(cfg, batch, max_len, device, prompt_len),
                                 prompts, gen_tokens, want, bound_ms, smi, device)
        if device == "cuda":
            for graph in (False, True):
                decode_profile("ssm_graph_profile" if graph else "ssm_profile", arch, model,
                               fresh_cache(cfg, batch, MOE_PROFILED_STEPS + 3, device,
                                           enc_len=prompt_len), prompts, smi, graphed=graph)
        del cache, want, graphed
        t0 = time.perf_counter()
        fp32 = family_fp32_check(model, prompts, enc_inputs, device)
        emit(phase="ssm_fp32", arch=arch, **fp32, seconds=time.perf_counter() - t0, card=smi)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    check(fp32["as_accurate_as_cpu"], f"{arch}: fp32 logits on the card "
          f"{fp32['card_vs_fp64']} from the fp64 run, the CPU's {fp32['cpu_vs_fp64']}")
    if "forward_vs_decode_ok" in fp32:
        check(fp32["forward_vs_decode_ok"], f"{arch}: fp32 forward against decode on the "
              f"card: max diff {fp32['forward_vs_decode_max_abs_diff']}")
    if "forward_ok" in fp32:
        check(fp32["forward_ok"], f"{arch}: fp32 forward on the card "
              f"{fp32['forward_card_vs_fp64']} from the fp64 run, the CPU's "
              f"{fp32['forward_cpu_vs_fp64']}")


def ssm_phase(smi: str, batch: int = 4, prompt_len: int = 32, gen_tokens: int = 32) -> None:
    """Mamba2 1.3B, Zamba2 1.2B and Whisper medium at their published
    configs, one after the other (``ssm_decode``), then the launcher in
    process on each reduced arch (resident exits 0, ``--offload`` 2).  No
    hand-written kernel may launch."""
    t_phase = time.perf_counter()
    release_pinned_cache()
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    emit(phase="ssm_start", allocated=torch.cuda.memory_allocated(),
         reserved=torch.cuda.memory_reserved(), card=smi)
    for arch in SSM_PUBLISHED:
        ssm_decode(arch, smi, batch, prompt_len, gen_tokens)
    for arch in SSM_PUBLISHED:
        launcher_runs(smi, arch, (([], 0), (["--offload"], 2)))
    launches = _kernel_launches()
    check(all(v == 0 for v in launches.values()),
          f"ssm, hybrid and encdec decode launch no hand-written kernel: {launches}")
    emit(phase="ssm_done", seconds=time.perf_counter() - t_phase, launches=launches,
         card=smi)


# -- phase 14: training -------------------------------------------------------------

TRAIN_ARCH = "llama3_2_1b"
# Llama 3.2 1B's published widths: layers, d, heads, KV heads, ff,
# vocabulary, dtype, tied embeddings.
TRAIN_PUBLISHED = (16, 2048, 32, 8, 8192, 128256, "bfloat16", True)
# The launcher at full width: 8,192 tokens a step at the reference's
# train_4k sequence length, in two microbatches of one sequence.
TRAIN_ARGV = ("--steps", "6", "--batch", "2", "--seq", "4096", "--microbatches", "2")
TRAIN_PROFILED_STEPS = 2
TRAIN_FAMILIES = ("qwen3_moe_30b_a3b", "deepseek_v2_lite_16b", "mamba2_1_3b",
                  "zamba2_1_2b", "internvl2_76b")
TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "train_ckpt"
TRAIN_SEED = 14
# NVIDIA's H100 SXM data sheet: dense bf16 on the tensor cores, at 700 W.
PEAK_BF16_S = H100_SXM.peak_flops
TRAIN_TOL = {"loss": dict(rtol=1e-4, atol=0.0), "grads": dict(rtol=1e-3, atol=1e-5),
             "adamw": dict(rtol=0.0, atol=1e-6)}


def _event():
    return torch.cuda.Event(enable_timing=True)


class train_probe:
    """While open, ``repro_torch.train.make_train_step`` (the launcher looks
    it up in ``main``) makes steps that are timed by CUDA events on the
    current stream and keep their model, optimizer state and metrics, and
    ``train.step.adamw_update`` is timed the same way.  ``before_first(model)``
    runs once before the first step; with ``stop_after`` a SIGTERM is raised
    after that many steps, so the launcher checkpoints and exits 0.
    ``around(i)``, a context manager, is entered around step ``i``."""

    def __init__(self, before_first=None, stop_after=None, around=None):
        self.before_first, self.stop_after, self.around = before_first, stop_after, around
        self.steps, self.adamw, self.metrics = [], [], []
        self.model = self.opt_state = self.train_step = None

    def __enter__(self):
        import repro_torch.train as train_pkg
        import repro_torch.train.step as step_mod

        self._saved = (train_pkg, train_pkg.make_train_step, step_mod, step_mod.adamw_update)
        make_step, update = self._saved[1], self._saved[3]

        def timed_update(*args, **kw):
            a, b = _event(), _event()
            a.record()
            out = update(*args, **kw)
            b.record()
            self.adamw.append((a, b))
            return out

        def make(*args, **kw):
            step = self.train_step = make_step(*args, **kw)

            def timed(model, opt_state, batch):
                if not self.steps and self.before_first is not None:
                    self.before_first(model)
                a, b = _event(), _event()
                a.record()
                if self.around is not None:
                    with self.around(len(self.steps)):
                        out = step(model, opt_state, batch)
                else:
                    out = step(model, opt_state, batch)
                b.record()
                self.steps.append((a, b))
                self.model, self.opt_state, metrics = out
                self.metrics.append(metrics)
                if self.stop_after == len(self.steps):
                    signal.raise_signal(signal.SIGTERM)
                return out
            return timed
        train_pkg.make_train_step = make
        step_mod.adamw_update = timed_update
        return self

    def __exit__(self, *exc):
        train_pkg, make_step, step_mod, update = self._saved
        train_pkg.make_train_step, step_mod.adamw_update = make_step, update

    @staticmethod
    def ms(events) -> list:
        return [a.elapsed_time(b) for a, b in events]


def launch_train(argv) -> tuple:
    """The training launcher's ``main(argv)`` in this process, its output
    captured: (exit code, stdout lines, stderr lines)."""
    import contextlib
    import io

    from repro_torch.launch import train as launch_train_mod

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = launch_train_mod.main(list(argv))
    return rc, out.getvalue().strip().splitlines(), err.getvalue().strip().splitlines()


def train_full(smi: str, device: str = "cuda", argv=TRAIN_ARGV) -> dict:
    """Llama 3.2 1B at its published config through the launcher's ``main``
    in this process (seeded bf16 weights made on the device, remat on):
    every loss and grad norm finite, and step 0's batch's loss after the
    run below its loss before it (both microbatch by microbatch, as the step
    computes it).  Records ms a step (CUDA events, the median of every step
    after the first), tokens/s, the model FLOPs of a step (6·N·T) and their
    share of the dense bf16 peak, the fp32 attention FLOPs, optimizer ms and
    peak device memory.  Returns what the profile and determinism parts
    continue from."""
    from repro_torch.configs import get_config
    from repro_torch.models import loss_fn
    from repro_torch.train.data import DataConfig, TokenStream

    cfg = get_config(TRAIN_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.d_ff,
           cfg.vocab_size, cfg.dtype, cfg.tie_embeddings) == TRAIN_PUBLISHED,
          f"{TRAIN_ARCH} is at its published config")
    opts = dict(zip(argv[::2], argv[1::2]))
    steps, batch, seq, mb = (int(opts[k]) for k in ("--steps", "--batch", "--seq",
                                                    "--microbatches"))
    stream = TokenStream(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    b0 = {k: torch.from_numpy(v).to(device) for k, v in stream.batch_at(0).items()}
    bs = batch // mb

    def batch0_loss(model) -> float:
        with torch.no_grad():
            return sum(float(loss_fn(model, b0["tokens"][i * bs:(i + 1) * bs],
                                     b0["labels"][i * bs:(i + 1) * bs], remat=False))
                       for i in range(mb)) / mb

    t_part = time.perf_counter()
    before = []
    probe = train_probe(before_first=lambda model: before.append(batch0_loss(model)))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with probe:
        rc, out, err = launch_train(["--arch", TRAIN_ARCH, "--device", device, *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"launch.train.main exited {rc}: {err[-5:]}")
    losses = [float(m["loss"]) for m in probe.metrics]
    gnorms = [float(m["grad_norm"]) for m in probe.metrics]
    check(len(losses) == steps and all(np.isfinite(losses + gnorms)),
          f"{len(losses)} steps, losses {losses}, grad norms {gnorms}")
    after = batch0_loss(probe.model)
    check(after < before[0], f"step 0's batch: loss {after} after {steps} steps, "
          f"{before[0]} before")
    ms = probe.ms(probe.steps)
    step_ms = statistics.median(ms[1:])
    n_params = sum(p.numel() for p in probe.model.parameters())
    check(n_params == cfg.param_count() + cfg.d_model,
          f"{n_params} parameters against the config's count")
    tokens = batch * seq
    model_flops = 6 * n_params * tokens
    # Chunked attention computes every (query, key) pair of each sequence in
    # fp32 (the mask comes after): 4·S²·Hq·Dh a layer forward, run twice
    # (remat) and twice more backward.
    attn_flops = 4 * (4 * seq * seq * cfg.num_heads * cfg.hdim) * cfg.num_layers * batch
    emit(phase="train_full", arch=TRAIN_ARCH, params=n_params, args=list(argv),
         tokens_per_step=tokens, remat=True, steps=steps, wall_s=wall,
         ms_per_step=ms, ms_per_step_median=step_ms,
         tokens_per_s=tokens / step_ms * 1e3,
         model_flops_per_step=model_flops,
         model_flops_share_of_bf16_peak=model_flops / (step_ms / 1e3) / PEAK_BF16_S,
         bf16_peak_flops=PEAK_BF16_S, attention_fp32_flops_per_step=attn_flops,
         attention_fp32_floor_ms=attn_flops / PEAK_FP32_S * 1e3,
         optimizer_ms=probe.ms(probe.adamw),
         optimizer_ms_median=statistics.median(probe.ms(probe.adamw)),
         losses=losses, grad_norms=gnorms, batch0_loss_before=before[0],
         batch0_loss_after=after, peak_device_bytes=peak,
         launcher_last_line=(out or [""])[-1],
         seconds=time.perf_counter() - t_part, card=smi)
    return {"probe": probe, "stream": stream, "b0": b0, "bs": bs, "steps": steps}


def train_profile(smi: str, run: dict, device: str = "cuda",
                  steps: int = TRAIN_PROFILED_STEPS) -> None:
    """``steps`` more steps of the same model (the stream's next batches)
    under ``torch.profiler`` (device activity only): the card's busy and
    idle share of the host's wall, and the kernels that took its time."""
    from torch.profiler import ProfilerActivity, profile

    t_part = time.perf_counter()
    probe = run["probe"]
    model, opt = probe.model, probe.opt_state
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in run["stream"].batch_at(run["steps"] + i).items()}
               for i in range(steps)]
    torch.cuda.synchronize()
    activity = ProfilerActivity.CUDA if device == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            model, opt, metrics = probe.train_step(model, opt, b)
            float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, work_s, count, top = device_activity(prof)
    emit(phase="train_profile", arch=TRAIN_ARCH, steps=steps, wall_s=wall,
         ms_per_step=wall / steps * 1e3, device_busy_ms_per_step=busy_s / steps * 1e3,
         device_idle_share=1 - busy_s / wall if wall else None, device_work_s=work_s,
         device_activities_per_step=count / steps, top_device_ms=top,
         seconds=time.perf_counter() - t_part, card=smi)


def train_determinism(smi: str, run: dict) -> None:
    """One microbatch's gradients (step 0's first sequence, remat on) at full
    width, twice by default and once under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, each timed
    by CUDA events: whether the default is already bit for bit the same
    (the embedding's gradient is an accumulating ``index_put_``) and what the
    deterministic mode costs."""
    from repro_torch.train.step import loss_and_grads

    t_part = time.perf_counter()
    model, bs = run["probe"].model, run["bs"]
    mbatch = {k: v[:bs] for k, v in run["b0"].items()}

    def timed():
        a, b = _event(), _event()
        a.record()
        _, grads = loss_and_grads(model, mbatch)
        b.record()
        torch.cuda.synchronize()
        return grads, a.elapsed_time(b)

    g1, ms1 = timed()
    g2, ms2 = timed()
    same = all(torch.equal(g1[k], g2[k]) for k in g1)
    del g2
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g3, ms3 = timed()
    finally:
        torch.use_deterministic_algorithms(False)
    same_det = all(torch.equal(g1[k], g3[k]) for k in g1)
    emit(phase="train_determinism", arch=TRAIN_ARCH, tokens=int(mbatch["tokens"].numel()),
         default_ms=[ms1, ms2], default_bit_identical=same,
         deterministic_mode_ms=ms3, deterministic_mode_equal_to_default=same_det,
         seconds=time.perf_counter() - t_part, card=smi)
    check(same and same_det, "one microbatch's gradients at full width: bit for bit the "
          "same twice by default and under the deterministic mode")


def train_parity(smi: str, device: str = "cuda", layers: int = 2, seq: int = 64) -> None:
    """An fp32 copy of the published widths at ``layers`` layers (TF32 off):
    one step's loss and gradients (batch 1, ``seq`` tokens, remat on) on the
    card and on the CPU from the same weights, the loss at rtol 1e-4 and
    every gradient at rtol 1e-3 / atol 1e-5; then ``adamw_update`` fed the
    CPU's gradients on both, the parameters and both moments at atol 1e-6;
    and the card's gradients with remat off ``torch.equal`` to remat on."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.step import loss_and_grads

    t_part = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = get_config(TRAIN_ARCH).with_(num_layers=layers, dtype="float32")
        gen = torch.Generator(device=device).manual_seed(TRAIN_SEED)
        card = init_params(cfg, generator=gen, device=device).requires_grad_(True)
        host = copy.deepcopy(card).to("cpu")
        chunk = np.random.default_rng(TRAIN_SEED).integers(0, cfg.vocab_size, (1, seq + 1))
        batch = {"tokens": torch.from_numpy(chunk[:, :-1]),
                 "labels": torch.from_numpy(chunk[:, 1:])}
        out = {}
        for name, model, dev in (("card", card, device), ("cpu", host, "cpu")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(model, {k: v.to(dev) for k, v in batch.items()})
            torch.cuda.synchronize()
            out[name] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                         time.perf_counter() - t0)
        (loss_c, g_c, card_s), (loss_h, g_h, cpu_s) = out["card"], out["cpu"]
        loss_ok = bool(torch.allclose(loss_c, loss_h, **TRAIN_TOL["loss"]))
        grad_err = {k: float((g_c[k] - g_h[k]).abs().max()) for k in g_h}
        grads_ok = all(torch.allclose(g_c[k], g_h[k], **TRAIN_TOL["grads"]) for k in g_h)
        _, off = loss_and_grads(card, {k: v.to(device) for k, v in batch.items()},
                                remat=False)
        remat_equal = all(torch.equal(off[k].cpu(), g_c[k]) for k in g_c)
        del off
        opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1)
        states = {}
        for name, model, dev in (("card", card, device), ("cpu", host, "cpu")):
            params = dict(model.named_parameters())
            state = adamw_init(params)
            adamw_update(params, {k: g.to(dev) for k, g in g_h.items()}, state, opt_cfg)
            states[name] = ({k: p.detach().cpu() for k, p in params.items()},
                            {m: {k: t.cpu() for k, t in state[m].items()}
                             for m in ("mu", "nu")})
        (p_c, s_c), (p_h, s_h) = states["card"], states["cpu"]
        adam_err = max(max(float((p_c[k] - p_h[k]).abs().max()) for k in p_h),
                       *(float((s_c[m][k] - s_h[m][k]).abs().max())
                         for m in ("mu", "nu") for k in p_h))
        adam_ok = adam_err <= TRAIN_TOL["adamw"]["atol"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    worst = max(grad_err, key=grad_err.get)
    emit(phase="train_parity", arch=TRAIN_ARCH, layers=layers, seq=seq,
         loss_card=float(loss_c), loss_cpu=float(loss_h), loss_ok=loss_ok,
         grads_ok=grads_ok, max_abs_grad_diff=grad_err[worst], worst_grad=worst,
         max_abs_grad=float(g_h[worst].abs().max()), adamw_max_abs_diff=adam_err,
         adamw_ok=adam_ok, remat_bit_identical=remat_equal, card_s=card_s, cpu_s=cpu_s,
         tolerance=TRAIN_TOL, seconds=time.perf_counter() - t_part, card=smi)
    check(loss_ok, f"fp32 loss on the card {float(loss_c)} against the CPU {float(loss_h)}")
    check(grads_ok, f"fp32 gradients on the card against the CPU: {worst} off by "
          f"{grad_err[worst]}")
    check(adam_ok, f"adamw_update on the card against the CPU: off by {adam_err}")
    check(remat_equal, "gradients with remat on and off are torch.equal on the card")


def train_resume(smi: str, device: str = "cuda") -> None:
    """The launcher in this process on the reduced arch with ``--ckpt-dir``
    under ``build/`` (deleted at the end): an uninterrupted 6-step run, and
    a 6-step run stopped by a SIGTERM after its third step (it checkpoints
    and exits 0) then resumed to the end; every array of the two last
    checkpoints equal."""
    from repro_torch.train.checkpoint import latest_checkpoint

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    full, part = str(TRAIN_CKPT / "full"), str(TRAIN_CKPT / "part")
    base = ["--arch", TRAIN_ARCH, "--reduced", "--device", device, "--steps", "6",
            "--ckpt-every", "2", "--quiet"]
    try:
        t0 = time.perf_counter()
        rc, _, err = launch_train(base + ["--ckpt-dir", full])
        check(rc == 0, f"the uninterrupted run exited {rc}: {err[-5:]}")
        with train_probe(stop_after=3):
            rc, _, err = launch_train(base + ["--ckpt-dir", part])
        check(rc == 0 and latest_checkpoint(part) == 3,
              f"the run stopped at step 3 exited {rc} at {latest_checkpoint(part)}")
        rc, _, err = launch_train(base + ["--ckpt-dir", part])
        check(rc == 0, f"the resumed run exited {rc}: {err[-5:]}")
        with np.load(os.path.join(full, "step_00000006", "arrays.npz")) as a, \
                np.load(os.path.join(part, "step_00000006", "arrays.npz")) as b:
            names = sorted(a.files)
            equal = names == sorted(b.files) and all(np.array_equal(a[k], b[k])
                                                     for k in names)
        emit(phase="train_resume", arch=TRAIN_ARCH, reduced=True, stopped_at=3,
             arrays=len(names), bit_identical=equal,
             seconds=time.perf_counter() - t0, card=smi)
        check(equal, "the resumed run's last checkpoint equals the uninterrupted run's")
    finally:
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)


def train_families(smi: str, device: str = "cuda") -> None:
    """The launcher in this process on every trainable family's reduced
    arch, 2 steps each (exit 0), and on Whisper (exit 2: its audio frontend
    is stubbed)."""
    for arch, rc_want in [(a, 0) for a in TRAIN_FAMILIES] + [("whisper_medium", 2)]:
        t0 = time.perf_counter()
        rc, out, err = launch_train(["--arch", arch, "--reduced", "--device", device,
                                     "--steps", "2"])
        line = ((out if rc_want == 0 else err) or [""])[-1]
        emit(phase="train_family", arch=arch, rc=rc, seconds=time.perf_counter() - t0,
             line=line, card=smi)
        check(rc == rc_want and (line.startswith("done at step 2") if rc_want == 0
                                 else "stubbed" in line),
              f"launch.train.main(--arch {arch} --reduced) exited {rc}: {line!r}")


def train_phase(smi: str, device: str = "cuda", argv=TRAIN_ARGV) -> None:
    """Phase 14: training through ``repro_torch.launch.train`` (the parts
    above, in order), no hand-written kernel launched."""
    t_phase = time.perf_counter()
    release_pinned_cache()
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    run = train_full(smi, device, argv)
    train_profile(smi, run, device)
    train_determinism(smi, run)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    train_parity(smi, device)
    train_resume(smi, device)
    train_families(smi, device)
    launches = _kernel_launches()
    check(all(v == 0 for v in launches.values()),
          f"training launches no hand-written kernel: {launches}")
    emit(phase="train_done", seconds=time.perf_counter() - t_phase, launches=launches,
         card=smi)


# -- phase 15: the LM mesh paths ---------------------------------------------------
LM_MESH_RANKS = 4
# Llama 3.2 1B at its published width and depth through the launcher on
# (data=2, model=2): 3 steps of 4 x 512 tokens, remat on, bf16, at a tenth of
# the launcher's learning rate (3e-4 overshoots on the third step at this batch).
LM_MESH_ARGV = ("--steps", "3", "--batch", "4", "--seq", "512", "--lr", "3e-5")
LM_MESH_FP32 = dict(layers=2, batch=4, seq=64, seed=15)
# Qwen3-MoE 30B-A3B at its published width on (data=1, model=4): 32 experts a
# rank; depth cut to 8 layers (four ranks' full copies before sharding on one
# card); 8 teacher-forced decode steps of batch 4.
LM_MESH_MOE = dict(arch="qwen3_moe_30b_a3b", layers=8, fp32_layers=2, batch=4, steps=8,
                   seed=15)
# The fp32 copy at 2 layers: routing equal, logits rtol 1e-4 / atol 1e-5.
# The bf16 run at 8 layers: the tensor-parallel attention sums bf16 partials
# over model where one rank accumulates in fp32, so a near-tie in the routing
# can flip and the logits part from there; its gate is every step before the
# first call whose chosen experts differ within atol 2e-2, every rank's first
# difference at the same call, and every difference up to that call a
# near-tie (``routing_flip``: each swapped pair's logit gap within what one
# bf16 step of the router input can move it).
LM_MESH_MOE_TOL = {"bfloat16": dict(rtol=0.0, atol=2e-2), "float32": dict(rtol=1e-4, atol=1e-5)}
LM_MESH_POD_ELEMS = 1 << 22            # one rank's gradient in the int8 all-reduce (16 MB)
LM_MESH_DRYRUN = (("llama3_2_1b", "train_4k"), ("qwen3_moe_30b_a3b", "decode_32k"))
LM_MESH_DIR = Path(__file__).resolve().parent / "build" / "lm_mesh"
LM_MESH_BACKEND = "gloo"               # NCCL refuses two ranks on one card


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _lm_fp32_batch(cfg) -> dict:
    o = LM_MESH_FP32
    chunk = np.random.default_rng(o["seed"]).integers(0, cfg.vocab_size,
                                                      (o["batch"], o["seq"] + 1))
    return {"tokens": torch.from_numpy(chunk[:, :-1]), "labels": torch.from_numpy(chunk[:, 1:])}


def _lm_fp32_model(device):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(TRAIN_ARCH).with_(num_layers=LM_MESH_FP32["layers"], dtype="float32")
    gen = torch.Generator(device=device).manual_seed(LM_MESH_FP32["seed"])
    return init_params(cfg, generator=gen, device=device).requires_grad_(True)


def _moe_model(dtype: str, layers: int, device):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(LM_MESH_MOE["arch"]).with_(num_layers=layers, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(LM_MESH_MOE["seed"])
    return init_params(cfg, generator=gen, device=device)


def _moe_tokens(cfg) -> torch.Tensor:
    o = LM_MESH_MOE
    return torch.from_numpy(np.random.default_rng(o["seed"]).integers(
        0, cfg.vocab_size, (o["batch"], o["steps"])))


def _moe_decode(model, device, mesh=None) -> dict:
    """LM_MESH_MOE's teacher-forced decode steps: every step's logits,
    every routing call's ``topk_idx``, ``probs`` and router input on the
    CPU, each layer's router (fp32), and the ms of each step (CUDA
    events)."""
    from repro_torch.distributed.sharding import distribute, shard_cache
    from repro_torch.distributed.spmd import bspec
    from repro_torch.models import decode_step, init_cache

    cfg = model.cfg
    tokens = _moe_tokens(cfg).to(device)
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], device=device)
    if mesh is not None:
        cache = shard_cache(cache, cfg, mesh)
    logits, ms = [], []
    with routing_log(inputs=True) as log, torch.inference_mode():
        for t in range(tokens.shape[1]):
            tok = tokens[:, t]
            if mesh is not None:
                tok = distribute(tok, (bspec(mesh, tok.shape[0]),), mesh)
            a, b = _event(), _event()
            a.record()
            out, cache = decode_step(model, cache, tok, mesh=mesh)
            b.record()
            out = out.full_tensor() if mesh is not None else out
            logits.append(out.float().cpu())
            ms.append(a.elapsed_time(b))
    routers = [b.moe.router for b in model.blocks]
    routers = [(r.full_tensor() if mesh is not None else r).float().cpu() for r in routers]
    return {"logits": torch.stack(logits), "routing": [c[0] for c in log.calls],
            "probs": [c[1] for c in log.calls], "inputs": log.inputs, "routers": routers,
            "ms": ms}


def routing_flip(run: dict, want: dict) -> dict | None:
    """``run``'s routing (``_moe_decode``) against ``want``'s, up to the
    first call whose chosen experts (the top-k sets) differ: ``call``,
    ``step`` and ``layer`` of that call (None where the sets agree
    throughout), and ``tokens``, every token row that differs at that call
    or before it (an order within the top-k changes no output).  For each,
    at the first position where the rows differ: ``want``'s expert ``i``
    and ``run``'s ``j``, ``want``'s probability margin there (that
    position's probability minus the next), the gap ``z_i - z_j`` of
    ``want``'s router logits, ``one_step``, the most one bf16 step of every
    router input element can move that gap (sum over d of ``|W[d, i] -
    W[d, j]|`` times the bf16 spacing at ``x_d``), the shift the two runs'
    inputs made, and how far apart the inputs are in bf16 steps.
    ``near_tie``: every gap within its ``one_step``.  None when the routing
    is equal throughout."""
    layers = len(want["routers"])
    tokens, first = [], None
    for c, (ia, ib) in enumerate(zip(run["routing"], want["routing"])):
        if torch.equal(ia, ib):
            continue
        w = want["routers"][c % layers].double()
        xa, xb = run["inputs"][c].double(), want["inputs"][c].double()
        _, exp = torch.frexp(xb.abs())
        spacing = torch.ldexp(torch.ones_like(xb), exp - 8)   # bf16: 8 significant bits
        for t in range(ib.shape[0]):
            if torch.equal(ia[t], ib[t]):
                continue
            pos = int((ia[t] != ib[t]).nonzero()[0])
            i, j = int(ib[t, pos]), int(ia[t, pos])
            z = xb[t] @ w
            p = torch.sort(want["probs"][c][t].double(), descending=True).values
            dw = w[:, i] - w[:, j]
            tokens.append(dict(
                call=c, token=t, position=pos, want_expert=i, run_expert=j,
                prob_margin=float(p[pos] - p[pos + 1]), logit_gap=float(z[i] - z[j]),
                one_step=float((dw.abs() * spacing[t]).sum()),
                input_shift=float(dw @ (xb[t] - xa[t])),
                input_max_steps=float(((xa[t] - xb[t]).abs() / spacing[t]).max())))
        if not torch.equal(ia.sort(dim=1).values, ib.sort(dim=1).values):
            first = c
            break
    if not tokens:
        return None
    return dict(call=first, step=None if first is None else first // layers,
                layer=None if first is None else first % layers, tokens=tokens,
                near_tie=all(t["logit_gap"] <= t["one_step"] for t in tokens))


def lm_mesh_baselines(smi: str, work: Path) -> dict:
    """The one-rank runs phase 15's mesh runs are held against, on the card
    without a mesh: the launcher's bf16 Llama steps (ms a step), the fp32
    2-layer Llama's loss and gradients, and the Qwen3-MoE decodes."""
    from repro_torch.train.step import loss_and_grads

    t_part = time.perf_counter()
    out = {}
    probe = train_probe()
    with probe:
        rc, _, err = launch_train(["--arch", TRAIN_ARCH, "--device", "cuda", *LM_MESH_ARGV])
    check(rc == 0, f"one-rank launcher exited {rc}: {err[-5:]}")
    out["train_ms"] = probe.ms(probe.steps)
    out["train_losses"] = [float(m["loss"]) for m in probe.metrics]
    del probe
    _no_tf32()
    model = _lm_fp32_model("cuda")
    loss, grads = loss_and_grads(model, {k: v.cuda() for k, v in _lm_fp32_batch(model.cfg).items()})
    out["fp32_loss"], out["fp32_grads"] = loss.cpu(), {k: g.cpu() for k, g in grads.items()}
    del model, grads
    for dtype, layers in (("float32", LM_MESH_MOE["fp32_layers"]), ("bfloat16", LM_MESH_MOE["layers"])):
        model = _moe_model(dtype, layers, "cuda")
        out[f"moe_{dtype}"] = _moe_decode(model, "cuda")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="lm_mesh_one_rank", arch=TRAIN_ARCH, args=list(LM_MESH_ARGV),
         ms_per_step=out["train_ms"], losses=out["train_losses"],
         moe_ms_per_step={k: out[f"moe_{k}"]["ms"] for k in ("float32", "bfloat16")},
         seconds=time.perf_counter() - t_part, card=smi)
    return out


def _rank_save(work: Path, rank: int, name: str, obj) -> None:
    torch.save(obj, work / f"rank{rank}_{name}.pt")


def lm_mesh_rank(rank: int, world: int, port: int, work: str) -> None:
    """One of phase 15's ranks (a spawned process on the one card), in a
    gloo group: the fp32 2-layer Llama's loss and gradients on (2, 2), the
    expert-parallel Qwen3-MoE decodes on (1, 4), the int8 all-reduce on
    (pod=4) on the card and on the CPU, then the launcher's bf16 Llama on
    (2, 2), its second step under ``CommDebugMode`` (the launcher ends the
    group).  Each result goes to ``work`` for the parent to check."""
    import faulthandler

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.compression import compressed_allreduce_mean
    from repro_torch.distributed.sharding import (
        batch_specs, distribute, param_specs, shard_params)
    from repro_torch.distributed.spmd import all_reduce
    from repro_torch.analysis.op_analysis import CollectiveLog
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.train.step import loss_and_grads

    faulthandler.enable()
    work = Path(work)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.cuda.set_device(0)
    init_ranks(LM_MESH_BACKEND, "cuda")
    _no_tf32()
    t0 = time.perf_counter()
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    model = _lm_fp32_model("cuda")
    shard_params(model, param_specs(model, model.cfg, mesh), mesh)
    specs = batch_specs(model.cfg, mesh, LM_MESH_FP32["batch"])
    batch = {k: distribute(v.cuda(), specs[k], mesh) for k, v in _lm_fp32_batch(model.cfg).items()}
    loss, grads = loss_and_grads(model, batch, mesh=mesh)
    full = {k: g.full_tensor().cpu() for k, g in grads.items()}
    if rank == 0:
        _rank_save(work, rank, "fp32", {"loss": loss.cpu(), "grads": full})
    del model, grads, full
    times = {"fp32_s": time.perf_counter() - t0}

    ep = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
    for dtype, layers in (("float32", LM_MESH_MOE["fp32_layers"]), ("bfloat16", LM_MESH_MOE["layers"])):
        t0 = time.perf_counter()
        model = _moe_model(dtype, layers, "cuda")
        shard_params(model, param_specs(model, model.cfg, ep), ep)
        gc.collect()
        torch.cuda.empty_cache()
        local = sum(p.to_local().numel() * p.element_size() for p in model.parameters())
        run = _moe_decode(model, "cuda", ep)
        run["local_weight_bytes"] = local
        _rank_save(work, rank, f"moe_{dtype}", run)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        times[f"moe_{dtype}_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pod = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    cpu_group = dist.new_group(backend="gloo")
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        LM_MESH_POD_ELEMS).astype(np.float32))
    res = {}
    for where, group in (("cuda", pod.get_group("pod")), ("cpu", cpu_group)):
        trace = {}
        xd = x.to(where)
        mean = compressed_allreduce_mean(xd, group, trace=trace)
        if where == "cuda":
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(3):
                compressed_allreduce_mean(xd, group)
            torch.cuda.synchronize()
            res["int8_ms"] = (time.perf_counter() - t1) / 3 * 1e3
            t1 = time.perf_counter()
            for _ in range(3):
                all_reduce(xd, "sum", group)
            torch.cuda.synchronize()
            res["fp32_allreduce_ms"] = (time.perf_counter() - t1) / 3 * 1e3
        res[where] = {"mean": mean.cpu(), **{k: v.cpu() for k, v in trace.items()}}
    _rank_save(work, rank, "pod", res)
    times["pod_s"] = time.perf_counter() - t0

    comm = {}

    def around(i):
        import contextlib

        if i != 1:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        comm["mode"] = stack.enter_context(CommDebugMode())
        comm["log"] = stack.enter_context(CollectiveLog())
        return stack
    t0 = time.perf_counter()
    probe = train_probe(around=around)
    with probe:
        rc, out, err = launch_train(["--arch", TRAIN_ARCH, "--device", "cuda",
                                     "--backend", LM_MESH_BACKEND,
                                     "--model-parallel", "2", *LM_MESH_ARGV])
    torch.cuda.synchronize()
    times["launcher_s"] = time.perf_counter() - t0
    _rank_save(work, rank, "train", {
        "rc": rc, "out": out, "err": err[-20:], "ms": probe.ms(probe.steps),
        "losses": [float(m["loss"]) for m in probe.metrics],
        "grad_norms": [float(m["grad_norm"]) for m in probe.metrics],
        "comm_counts": {str(k): int(v) for k, v in comm["mode"].get_comm_counts().items()},
        "comm_bytes_by_op": dict(comm["log"].bytes_by_op),
        "comm_count_by_op": dict(comm["log"].count_by_op),
        "comm_bytes_by_group": {str(k): v for k, v in comm["log"].bytes_by_group.items()},
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "times": times, "launches": _kernel_launches()})


def lm_mesh_dryrun_start(work: Path) -> list:
    """The dry run of LM_MESH_DRYRUN's cells on both production meshes, one
    child process each (the fake group is process-wide), started at once."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent / "src")}
    procs = []
    for arch, shape in LM_MESH_DRYRUN:
        log = open(work / f"dryrun_{arch}_{shape}.log", "w")
        procs.append((arch, shape, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--multi-pod", "both", "--out", str(work / "dryrun")],
            stdout=log, stderr=subprocess.STDOUT, env=env)))
    return procs


def lm_mesh_dryrun_join(procs, work: Path, smi: str) -> None:
    for arch, shape, log, proc in procs:
        try:
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
        text = (work / f"dryrun_{arch}_{shape}.log").read_text()
        check(rc == 0, f"dry run {arch} x {shape} exited {rc}: {text[-2000:]}")
        for pod in ("pod1", "pod2"):
            rec = json.loads((work / "dryrun" / f"{arch}_{shape}_{pod}.json").read_text())
            check(rec["device"].startswith("none") and rec["cost_analysis"]["flops"] > 0
                  and rec["memory"]["argument_bytes_per_device"] > 0,
                  f"dry-run record {arch} x {shape} x {pod}: {rec}")
            emit(phase="lm_mesh_dryrun", record=rec, host=smi)


def lm_mesh_phase(smi: str, keep_dryrun: bool = False) -> None:
    """Phase 15: the LM mesh paths (module docstring), no hand-written
    kernel launched.  With ``keep_dryrun`` the dry-run records of a phase
    that passed stay in ``LM_MESH_DIR / "dryrun"`` for phase 16, which
    deletes them."""
    t_phase = time.perf_counter()
    release_pinned_cache()
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    LM_MESH_DIR.mkdir(parents=True)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    procs = lm_mesh_dryrun_start(LM_MESH_DIR)
    passed = False
    try:
        base = lm_mesh_baselines(smi, LM_MESH_DIR)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(lm_mesh_rank, args=(LM_MESH_RANKS, _free_port(),
                                                        str(LM_MESH_DIR)),
                                    nprocs=LM_MESH_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        lm_mesh_check(smi, base, spawn_s)
        lm_mesh_dryrun_join(procs, LM_MESH_DIR, smi)
        passed = True
    finally:
        for *_, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        if not (keep_dryrun and passed):
            shutil.rmtree(LM_MESH_DIR / "dryrun", ignore_errors=True)
    launches = _kernel_launches()
    check(all(v == 0 for v in launches.values()),
          f"the LM mesh paths launch no hand-written kernel: {launches}")
    emit(phase="lm_mesh_done", seconds=time.perf_counter() - t_phase, launches=launches,
         card=smi)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def lm_mesh_check(smi: str, base: dict, spawn_s: float) -> None:
    """Phase 15's gates on what the ranks wrote, and its records."""
    w = LM_MESH_DIR
    load = lambda r, n: torch.load(w / f"rank{r}_{n}.pt", weights_only=False)  # noqa: E731
    ranks = range(LM_MESH_RANKS)
    train = [load(r, "train") for r in ranks]
    check(all(t["rc"] == 0 for t in train), f"launcher ranks exited {[t['rc'] for t in train]}: "
          f"{train[0]['err']}")
    losses = train[0]["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] and
          all(t["losses"] == losses for t in train),
          f"four-rank losses finite, falling and equal on every rank: "
          f"{[t['losses'] for t in train]}")
    launches = {k: sum(t["launches"][k] for t in train) for k in train[0]["launches"]}
    check(all(v == 0 for v in launches.values()), f"ranks launched kernels: {launches}")
    ms4 = statistics.median(train[0]["ms"][1:])
    ms1 = statistics.median(base["train_ms"][1:])
    emit(phase="lm_mesh_train", arch=TRAIN_ARCH, mesh="data=2xmodel=2", ranks=LM_MESH_RANKS,
         backend=LM_MESH_BACKEND, args=list(LM_MESH_ARGV), losses=losses,
         grad_norms=train[0]["grad_norms"], ms_per_step=[t["ms"] for t in train],
         ms_per_step_median=ms4, one_rank_ms_per_step=base["train_ms"],
         one_rank_ms_per_step_median=ms1, one_rank_losses=base["train_losses"],
         four_over_one=ms4 / ms1, step_collectives=train[0]["comm_counts"],
         step_collective_count_by_op=train[0]["comm_count_by_op"],
         step_collective_bytes_by_op=train[0]["comm_bytes_by_op"],
         step_collective_bytes_by_group_size=train[0]["comm_bytes_by_group"],
         peak_device_bytes_per_rank=[t["peak_device_bytes"] for t in train],
         rank_seconds=train[0]["times"], spawn_s=spawn_s, launches=launches, card=smi)

    fp32 = load(0, "fp32")
    loss_ok = bool(torch.allclose(fp32["loss"], base["fp32_loss"], **TRAIN_TOL["loss"]))
    err = {k: float((fp32["grads"][k] - g).abs().max()) for k, g in base["fp32_grads"].items()}
    grads_ok = all(torch.allclose(fp32["grads"][k], g, **TRAIN_TOL["grads"])
                   for k, g in base["fp32_grads"].items())
    worst = max(err, key=err.get)
    emit(phase="lm_mesh_train_parity", arch=TRAIN_ARCH, layers=LM_MESH_FP32["layers"],
         mesh="data=2xmodel=2", loss_mesh=float(fp32["loss"]), loss_one_rank=float(base["fp32_loss"]),
         loss_ok=loss_ok, grads_ok=grads_ok, worst_grad=worst, max_abs_grad_diff=err[worst],
         tolerance=TRAIN_TOL, card=smi)
    check(loss_ok and grads_ok, f"fp32 four-rank step against one rank: loss "
          f"{float(fp32['loss'])} / {float(base['fp32_loss'])}, {worst} off by {err[worst]}")

    for dtype in ("float32", "bfloat16"):
        want = base[f"moe_{dtype}"]
        runs = [load(r, f"moe_{dtype}") for r in ranks]
        routing_equal = all(len(r["routing"]) == len(want["routing"]) and all(
            torch.equal(a, b) for a, b in zip(r["routing"], want["routing"])) for r in runs)
        # the routing calls equal to one rank's before the first that is not
        same = [next((i for i, (a, b) in enumerate(zip(r["routing"], want["routing"]))
                      if not torch.equal(a, b)), len(want["routing"])) for r in runs]
        diff = float((runs[0]["logits"] - want["logits"]).abs().max())
        step_diff = [float(d) for d in (runs[0]["logits"] - want["logits"]).abs().amax(dim=(1, 2))]
        ok = routing_equal and torch.allclose(runs[0]["logits"], want["logits"],
                                              **LM_MESH_MOE_TOL[dtype])
        # bf16: the steps before the first call whose chosen experts differ
        # within tolerance, and every routing difference up to it a near-tie
        flip = routing_flip(runs[0], want)
        before = len(step_diff) if flip is None or flip["step"] is None else flip["step"]
        pre_ok = torch.allclose(runs[0]["logits"][:before], want["logits"][:before],
                                **LM_MESH_MOE_TOL[dtype])
        bf16_ok = pre_ok and (flip is None or flip["near_tie"]) and len(set(same)) == 1
        emit(phase="lm_mesh_moe_ep", arch=LM_MESH_MOE["arch"], dtype=dtype,
             layers=LM_MESH_MOE["layers"] if dtype == "bfloat16" else LM_MESH_MOE["fp32_layers"],
             mesh=f"data=1xmodel={LM_MESH_RANKS}", steps=LM_MESH_MOE["steps"],
             batch=LM_MESH_MOE["batch"], routing_calls=len(want["routing"]),
             routing_equal=routing_equal, routing_calls_equal_before_first_diff=same,
             max_abs_logit_diff=diff, max_abs_logit_diff_by_step=step_diff,
             first_flip=flip, steps_before_first_flip=before,
             steps_before_first_flip_within_tolerance=bool(pre_ok),
             max_abs_logit=float(want["logits"].abs().max()), tolerance=LM_MESH_MOE_TOL[dtype],
             within_tolerance=ok, ms_per_step_ep=runs[0]["ms"], ms_per_step_one_rank=want["ms"],
             local_weight_bytes_per_rank=[r["local_weight_bytes"] for r in runs], card=smi)
        if dtype == "float32":
            check(ok, f"expert-parallel fp32 decode against one rank: routing equal "
                  f"{routing_equal}, logits off by {diff}")
        else:
            check(bf16_ok, f"expert-parallel bf16 decode against one rank: every rank's "
                  f"first routing difference at call {same}, {before} steps before it within "
                  f"tolerance {bool(pre_ok)}, the difference a near-tie: {flip}")
        check(all(bool(torch.isfinite(r["logits"]).all()) and r["logits"].shape
                  == want["logits"].shape for r in runs),
              f"expert-parallel {dtype} logits finite, of their shape")

    pods = [load(r, "pod") for r in ranks]
    q_equal = all(torch.equal(p["cuda"]["q"], p["cpu"]["q"])
                  and torch.equal(p["cuda"]["scales"], p["cpu"]["scales"]) for p in pods)
    step = max(float(p["cpu"]["scales2"].max()) for p in pods) / LM_MESH_RANKS
    mean_diff = max(float((p["cuda"]["mean"] - p["cpu"]["mean"]).abs().max()) for p in pods)
    q2_diff = max(int((p["cuda"]["q2"].int() - p["cpu"]["q2"].int()).abs().max()) for p in pods)
    emit(phase="lm_mesh_pod_allreduce", mesh=f"pod={LM_MESH_RANKS}", elems=LM_MESH_POD_ELEMS,
         phase1_payloads_equal=q_equal, phase2_max_q_diff=q2_diff, max_abs_mean_diff=mean_diff,
         quant_step=step, int8_ms=[p["int8_ms"] for p in pods],
         fp32_allreduce_ms=[p["fp32_allreduce_ms"] for p in pods],
         wire_bytes_int8_per_rank=2 * LM_MESH_POD_ELEMS + 8 * LM_MESH_RANKS,
         wire_bytes_fp32_per_rank=4 * LM_MESH_POD_ELEMS, card=smi)
    # one phase-2 step where the card's fp32 sum and the CPU's round to
    # neighbouring int8 values, and the rounding of the step itself
    check(q_equal and q2_diff <= 1 and mean_diff <= step * (1 + 1e-5),
          f"int8 pod all-reduce on the card against the CPU: phase 1 equal {q_equal}, "
          f"phase 2 off by {q2_diff}, mean off by {mean_diff} (step {step})")


# -- phase 16: step analysis -------------------------------------------------------
ANALYSIS_REPS = 10
ANALYSIS_COPY_ELEMS = 1 << 30          # a 4 GiB fp32 device-to-device copy_
ANALYSIS_MATMUL = 8192                 # n^3 torch.matmul in bf16 and in fp32
ANALYSIS_LINK_BYTES = 1 << 30          # pinned H2D and D2H copies
# Llama 3.2 1B's parameters (phase 14's count), the N of 6·N·T.
ANALYSIS_PARAMS = 1_235_814_400
# Phase 14's step: 2 microbatches of one 4,096-token sequence, remat on.
ANALYSIS_TRAIN = dict(seq=4096, batch=2, microbatches=2)
# Phase 11's decode step: batch 4 after 32 teacher-forced prompt tokens.
ANALYSIS_DECODE = dict(batch=4, prompt_len=32)
ANALYSIS_SEED = 16


def card_constants(smi: str):
    """(a) The card's own constants beside the data sheet's, CUDA-event
    medians of ANALYSIS_REPS: HBM bytes/s of a device-to-device ``copy_``
    (read and write counted), the FLOP/s of ``torch.matmul`` in bf16 and in
    fp32 (TF32 off; the card measured, not the port), and pinned H2D and D2H
    bytes/s; and, by the host clock, a ``copy_`` between two pinned host
    buffers (read and write counted).  Then each field of the port's default
    ``hw``, ``H100``, beside the rate it was taken from, measured here:
    every ratio lies in [0.5, 2] (a slip of units, GiB for GB or a missing
    read-plus-write factor, not drift).  Returns the measured ``Hardware``
    (the collective links stay the data sheet's: one card measures none)."""
    from repro_torch.analysis.roofline import PCIE_BW, Hardware
    from repro_torch.core import H100

    src = torch.empty(ANALYSIS_COPY_ELEMS, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), ANALYSIS_REPS)
    hbm = 2 * src.numel() * src.element_size() / (copy_ms / 1e3)
    del src, dst
    n = ANALYSIS_MATMUL
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _no_tf32()
    try:
        matmul = {}
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(ANALYSIS_SEED)
            a = torch.randn(n, n, device="cuda", dtype=dtype, generator=gen)
            b = torch.randn(n, n, device="cuda", dtype=dtype, generator=gen)
            matmul[dtype] = time_ms(lambda: torch.matmul(a, b), ANALYSIS_REPS)
            del a, b
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    flops = 2 * n ** 3
    host = torch.empty(ANALYSIS_LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(ANALYSIS_LINK_BYTES, dtype=torch.uint8, device="cuda")
    h2d_ms = time_ms(lambda: dev.copy_(host, non_blocking=True), ANALYSIS_REPS)
    d2h_ms = time_ms(lambda: host.copy_(dev, non_blocking=True), ANALYSIS_REPS)
    del dev
    other = torch.empty(ANALYSIS_LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    h2h_ms = host_ms(lambda: other.copy_(host), ANALYSIS_REPS)
    del host, other
    release_pinned_cache()
    measured = {
        "hbm_copy": (copy_ms, hbm, H100_SXM.hbm_bw),
        "matmul_bf16": (matmul[torch.bfloat16], flops / (matmul[torch.bfloat16] / 1e3),
                        H100_SXM.peak_flops),
        "matmul_fp32": (matmul[torch.float32], flops / (matmul[torch.float32] / 1e3),
                        FP32_PEAK),
        "h2d_pinned": (h2d_ms, ANALYSIS_LINK_BYTES / (h2d_ms / 1e3), PCIE_BW),
        "d2h_pinned": (d2h_ms, ANALYSIS_LINK_BYTES / (d2h_ms / 1e3), PCIE_BW)}
    emit(phase="analysis_constants", reps=ANALYSIS_REPS,
         copy_bytes=ANALYSIS_COPY_ELEMS * 4, matmul_n=n, link_bytes=ANALYSIS_LINK_BYTES,
         **{k: {"ms": ms, "rate": rate, "data_sheet": sheet, "share": rate / sheet}
            for k, (ms, rate, sheet) in measured.items()},
         units="rate: bytes/s (copies, read and write for hbm_copy) or FLOP/s (matmul)",
         card=smi)
    h2h = 2 * ANALYSIS_LINK_BYTES / (h2h_ms / 1e3)
    taken = {"fast_capacity": ("mem_get_info total", torch.cuda.mem_get_info()[1]),
             "fast_bw": ("hbm_copy", hbm), "dd_bw": ("hbm_copy", hbm),
             "slow_bw": ("h2h_pinned", h2h),
             "up_bw": ("h2d_pinned", measured["h2d_pinned"][1]),
             "down_bw": ("d2h_pinned", measured["d2h_pinned"][1]),
             "flops": ("matmul_bf16", measured["matmul_bf16"][1])}
    fields = {f: {"preset": getattr(H100, f), "measured_by": what, "measured": got,
                  "ratio": getattr(H100, f) / got}
              for f, (what, got) in taken.items()}
    emit(phase="analysis_preset", preset=H100.name, h2h_pinned={"ms": h2h_ms, "rate": h2h},
         fields=fields, units="bytes, bytes/s or FLOP/s; ratio: preset over measured; "
         "h2h_pinned by the host clock, read and write counted", card=smi)
    check(all(0.5 <= r["ratio"] <= 2 for r in fields.values()),
          f"every field of {H100.name} within a factor of 2 of this card's rate: {fields}")
    return Hardware(name="h100 (measured here)", peak_flops=measured["matmul_bf16"][1],
                    hbm_bw=hbm, ici_bw=H100_SXM.ici_bw, dcn_bw=H100_SXM.dcn_bw)


def _step_ms(fn, device: str) -> float:
    """One call of ``fn`` in ms: CUDA events on the card, the host clock
    elsewhere (a CPU rehearsal's number is not a card time)."""
    if device != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    a, b = _event(), _event()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _watched(fn):
    """``fn()`` under ``OpCostLog``: its result and the log's summary."""
    from repro_torch.analysis.op_analysis import OpCostLog

    log = OpCostLog(1, breakdown=True)
    with log:
        out = fn()
    return out, log.summary()


def _flop_counter(fn) -> int:
    """The dot FLOPs ``FlopCounterMode`` counts in ``fn()`` (a run of its
    own: the mode decomposes ``silu_backward``, which then rounds
    otherwise)."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    with flops:
        fn()
    return flops.get_total_flops()


def _roofline_record(analysis: dict, cfg, shape, hws, step_ms: float) -> dict:
    """``roofline_terms`` of one device on each of ``hws``, with the share of
    its bound the measured step reaches."""
    from repro_torch.analysis import roofline_terms

    out = {}
    for hw in hws:
        t = roofline_terms(analysis, 1, cfg, shape, hw)
        out[hw.name] = {k: t[k] for k in ("compute_s", "memory_s", "collective_s",
                                          "dominant", "bound_s", "useful_ratio",
                                          "roofline_fraction")}
        out[hw.name]["bound_over_step"] = t["bound_s"] * 1e3 / step_ms
    return out


def analysis_train(smi: str, hws, device: str = "cuda", cfg=None,
                   train=ANALYSIS_TRAIN) -> None:
    """(b) One training step of Llama 3.2 1B (phase 14's shape) watched by
    ``OpCostLog``, from the same state as a step without it (outputs,
    parameters and AdamW state ``torch.equal``); the step timed without the
    mode, then counted by ``FlopCounterMode`` and again under
    ``FakeTensorMode`` on the host.  Gates: the dot FLOPs equal the flop
    counter's and the fake run's, and are at least 6·N·T."""
    import copy

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import analyze_step
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import init_params
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.data import DataConfig, TokenStream

    t_part = time.perf_counter()
    published, cfg = cfg is None, cfg or get_config(TRAIN_ARCH)
    shape = ShapeConfig("phase14_step", train["seq"], train["batch"], "train")
    gen = torch.Generator(device=device).manual_seed(ANALYSIS_SEED)
    model = init_params(cfg, generator=gen, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    check(not published or n_params == ANALYSIS_PARAMS, f"{n_params} parameters")
    opt = adamw_init(dict(model.named_parameters()))
    stream = TokenStream(DataConfig(cfg.vocab_size, shape.seq_len, shape.global_batch, seed=0))
    batch = {k: torch.from_numpy(v).to(device) for k, v in stream.batch_at(0).items()}
    step = make_train_step(cfg, AdamWConfig(), microbatches=train["microbatches"], remat=True)
    twin, twin_opt = copy.deepcopy(model), _clone_tree(opt)
    _, _, plain = step(twin, twin_opt, batch)             # without the mode (and warm-up)
    (_, _, metrics), a = _watched(lambda: step(model, opt, batch))
    equal = (_trees_equal(plain, metrics) and _trees_equal(twin_opt, opt)
             and all(torch.equal(p, q) for p, q in zip(twin.parameters(), model.parameters())))
    del model, opt, metrics, plain
    gc.collect()
    ms = [_step_ms(lambda: step(twin, twin_opt, batch), device) for _ in range(2)]
    counted = _flop_counter(lambda: step(twin, twin_opt, batch))
    del twin, twin_opt
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_fake = time.perf_counter()
    with FakeTensorMode():
        specs = input_specs(cfg, shape)
        fake = analyze_step(lambda: step(specs["params"], specs["opt_state"], specs["batch"]), 1)
        del specs
    fake_s = time.perf_counter() - t_fake
    tokens = shape.global_batch * shape.seq_len
    step_ms = statistics.median(ms)
    emit(phase="analysis_train", arch=cfg.name, params=n_params, tokens_per_step=tokens,
         microbatches=train["microbatches"], remat=True, dot_flops=a["dot_flops"],
         flop_counter_flops=counted, fake_dot_flops=fake["dot_flops"],
         six_n_t=6 * n_params * tokens, conv_flops=a["conv_flops"],
         hbm_bytes=a["hbm_bytes"], fake_hbm_bytes=fake["hbm_bytes"], num_ops=a["num_ops"],
         top_hbm=a["top_hbm"][:8], step_ms=ms, step_ms_median=step_ms,
         roofline=_roofline_record(a, cfg, shape, hws, step_ms),
         outputs_equal=equal, fake_s=fake_s, seconds=time.perf_counter() - t_part,
         device=device, card=smi)
    check(equal, "the step under the mode equals the step without it")
    check(a["dot_flops"] == counted, f"dot FLOPs {a['dot_flops']} against "
          f"FlopCounterMode's {counted}")
    check(fake["dot_flops"] == a["dot_flops"], f"dot FLOPs under FakeTensorMode "
          f"{fake['dot_flops']} against {a['dot_flops']} on {device}")
    check(a["dot_flops"] >= 6 * n_params * tokens, f"dot FLOPs {a['dot_flops']} below "
          f"6·N·T = {6 * n_params * tokens}")


def analysis_decode(smi: str, hws, device: str = "cuda", cfg=None,
                    decode=ANALYSIS_DECODE) -> None:
    """(b) One decode step of Llama 3.2 1B (phase 11's shape: batch 4 after
    32 teacher-forced prompt tokens) watched as ``analysis_train``'s, from
    a copy of the same cache as a step without the mode (logits and caches
    ``torch.equal``), counted again under ``FakeTensorMode`` on the host,
    and timed without the mode (CUDA-event median of ANALYSIS_REPS, each
    from a copy of the cache).  Gates: the dot FLOPs equal the flop
    counter's and the fake run's; the HBM bytes are at least the weights'
    (phase 11's byte bound)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import analyze_step
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, decode_step, init_cache, init_params
    from repro_torch.models.config import ShapeConfig

    t_part = time.perf_counter()
    cfg = cfg or get_config(MODEL_ARCH)
    batch, prompt_len = decode["batch"], decode["prompt_len"]
    shape = ShapeConfig("phase11_step", 2 * prompt_len, batch, "decode")
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(ANALYSIS_SEED)
        model = init_params(cfg, generator=gen, device=device)
        weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        n_params = sum(p.numel() for p in model.parameters())
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                                device=device)
        cache = init_cache(cfg, batch, shape.seq_len, device=device)
        for i in range(prompt_len):
            logits, cache = decode_step(model, cache, prompts[:, i])
        tok = torch.argmax(logits, -1)
        want, want_cache = decode_step(model, _clone_tree(cache), tok)
        c = _clone_tree(cache)
        (got, got_cache), a = _watched(lambda: decode_step(model, c, tok))
        c = _clone_tree(cache)
        counted = _flop_counter(lambda: decode_step(model, c, tok))
        equal = torch.equal(want, got) and _trees_equal(want_cache, got_cache)
        ms = []
        for _ in range(ANALYSIS_REPS):
            c = _clone_tree(cache)
            ms.append(_step_ms(lambda: decode_step(model, c, tok), device))
        del model, cache, want_cache, got_cache
    with FakeTensorMode(), torch.inference_mode():
        fm = Transformer(cfg, device="cpu")
        fc = init_cache(cfg, batch, shape.seq_len, device="cpu")
        fc["len"] = prompt_len
        ftok = torch.empty(batch, dtype=tok.dtype)
        fake = analyze_step(lambda: decode_step(fm, fc, ftok), 1)
    step_ms = statistics.median(ms)
    emit(phase="analysis_decode", arch=cfg.name, batch=batch, prompt_len=prompt_len,
         dot_flops=a["dot_flops"], flop_counter_flops=counted,
         fake_dot_flops=fake["dot_flops"], params=n_params, two_n_b=2 * n_params * batch,
         hbm_bytes=a["hbm_bytes"], fake_hbm_bytes=fake["hbm_bytes"],
         weight_bytes=weight_bytes, num_ops=a["num_ops"], top_hbm=a["top_hbm"][:8],
         step_ms=ms, step_ms_median=step_ms,
         roofline=_roofline_record(a, cfg, shape, hws, step_ms), outputs_equal=equal,
         seconds=time.perf_counter() - t_part, device=device, card=smi)
    check(equal, "the decode step under the mode equals the step without it")
    check(a["dot_flops"] == counted and fake["dot_flops"] == counted,
          f"decode dot FLOPs {a['dot_flops']}, FlopCounterMode {counted}, "
          f"FakeTensorMode {fake['dot_flops']}")
    check(a["hbm_bytes"] >= weight_bytes, f"decode HBM bytes {a['hbm_bytes']} below "
          f"the weights' {weight_bytes}")


def analysis_dryrun(smi: str, directory: Path, hws, records: int = 4) -> None:
    """(c) The roofline table of the dry-run records in ``directory``
    (``analysis/roofline.py::analyze_report_dir``) on each of ``hws``, every
    row printed with its dominant term.  Gate: ``records`` rows, each with
    HBM bytes and a finite bound."""
    from repro_torch.analysis.roofline import _to_markdown, analyze_report_dir

    for hw in hws:
        rows = analyze_report_dir(str(directory), hw=hw)
        check(len(rows) == records, f"{len(rows)} dry-run rows in {directory}, "
              f"not {records}")
        for r in rows:
            check(r["hbm_bytes_per_device"] > 0 and np.isfinite(r["bound_s"]),
                  f"dry-run row {r['file']}: {r['hbm_bytes_per_device']} B, "
                  f"bound {r['bound_s']}")
            emit(phase="analysis_dryrun", hw=hw.name, file=r["file"], arch=r["arch"],
                 shape=r["shape"], mesh=r["mesh"], devices=r["devices"],
                 **{k: r[k] for k in ("compute_s", "memory_s", "collective_s", "dominant",
                                      "bound_s", "useful_ratio", "roofline_fraction",
                                      "dot_flops_per_device", "hbm_bytes_per_device",
                                      "ici_bytes", "dcn_bytes", "collectives")},
                 host=smi)
        print(_to_markdown(rows), file=sys.stderr, flush=True)


def analysis_cachesim(smi: str, n: int, device: str = "cuda") -> None:
    """(d) ``core/cachesim.py::simulate_chain`` on phase 7's CloverLeaf 2D
    timestep chain at an n^2 interior (its 51 loops, recorded on a
    ``reference`` Session that never flushes), at phase 7's capacity (a
    third of the homes) and tile count (``choose_num_tiles`` at that
    capacity with 3 slots, as the ``ooc`` executor chooses): every mode,
    untiled and tiled, on the port's default ``hw`` (``H100``) with
    ``fast_capacity`` set to the capacity.  The modelled seconds are a model
    of that ``hw``'s figures, not card times.  Gate: ``flat_fast`` raises
    MemoryError (the homes are 3x the capacity), every other mode runs."""
    from repro_torch.apps import CloverLeaf2D
    from repro_torch.core import H100, Session, analyze_chain
    from repro_torch.core.cachesim import simulate_chain
    from repro_torch.core.tiling import choose_num_tiles

    t_part = time.perf_counter()
    app = CloverLeaf2D(n, n, summary_every=0)
    sess = Session("reference", device=device)
    app.dt = 1e-4
    app.record_timestep(sess)
    loops = list(sess.queue)
    sess.queue.clear()
    sess.close()
    homes = app.total_bytes()
    check(homes == 25 * (n + 4) ** 2 * 4, f"homes {homes} B")
    cap = homes / 3
    t0 = time.perf_counter()
    tiles = choose_num_tiles(analyze_chain(loops), cap, num_slots=3)
    choose_s = time.perf_counter() - t0
    hw = H100.with_(fast_capacity=cap)
    results = {}
    for mode in ("flat_fast", "flat_slow", "cache", "um", "um_prefetch"):
        for tiled in (False, True):
            t0 = time.perf_counter()
            try:
                st = simulate_chain(loops, hw, mode=mode, tiled=tiled, num_tiles=tiles)
                rec = {"modelled_s": st.time_s, "useful_bytes": st.useful_bytes,
                       "hit_rate": st.hit_rate, "miss_bytes": st.miss_bytes,
                       "writeback_bytes": st.writeback_bytes, "faults": st.faults,
                       "modelled_bytes_per_s": st.achieved_bw}
            except MemoryError as e:
                rec = {"raised": f"MemoryError: {e}"}
            rec["host_s"] = time.perf_counter() - t0
            results[f"{mode}{'_tiled' if tiled else ''}"] = rec
    emit(phase="analysis_cachesim", app="cloverleaf2d", interior=[n, n], loops=len(loops),
         home_bytes=homes, capacity_bytes=cap, tiles=tiles, choose_tiles_s=choose_s,
         hw=hw.name, page_bytes=hw.page_bytes,
         model=f"modelled on {hw.name}'s figures with fast_capacity {cap:.0f} B; "
               "not card times", results=results,
         seconds=time.perf_counter() - t_part, host=smi)
    check(all("raised" in results[k] for k in ("flat_fast", "flat_fast_tiled")),
          f"flat_fast at 3x its capacity: {results['flat_fast']}")
    check(all("raised" not in r and r["useful_bytes"] > 0 and r["modelled_s"] > 0
              for k, r in results.items() if not k.startswith("flat_fast")),
          f"every other mode runs: {results}")


def analysis_phase(smi: str, dryrun: Path = None, n: int = 8192) -> None:
    """Phase 16: the step analysis (module docstring), no hand-written
    kernel launched.  ``dryrun`` holds phase 15's records (deleted here at
    the end); without it, the phase runs the same dry run itself, in two
    child processes beside (a) and (b)."""
    t_phase = time.perf_counter()
    release_pinned_cache()
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    procs = []
    if dryrun is None:
        shutil.rmtree(LM_MESH_DIR / "dryrun", ignore_errors=True)
        LM_MESH_DIR.mkdir(parents=True, exist_ok=True)
        procs = lm_mesh_dryrun_start(LM_MESH_DIR)
        dryrun = LM_MESH_DIR / "dryrun"
    try:
        hws = (H100_SXM, card_constants(smi))
        analysis_train(smi, hws)
        gc.collect()
        torch.cuda.empty_cache()
        analysis_decode(smi, hws)
        gc.collect()
        torch.cuda.empty_cache()
        analysis_cachesim(smi, n)
        if procs:
            lm_mesh_dryrun_join(procs, LM_MESH_DIR, smi)
        analysis_dryrun(smi, dryrun, hws)
    finally:
        for *_, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(dryrun, ignore_errors=True)
    launches = _kernel_launches()
    check(all(v == 0 for v in launches.values()),
          f"the step analysis launches no hand-written kernel: {launches}")
    emit(phase="analysis_done", seconds=time.perf_counter() - t_phase, launches=launches,
         card=smi)


# -- phase 17: the examples ----------------------------------------------------------

EXAMPLES_DIR = Path(__file__).resolve().parent / "examples"
EXAMPLES_BUILD = Path(__file__).resolve().parent / "build" / "examples"
# train_lm_torch.py --preset 100m: a run, then its resume.  The resumed run
# must show a falling loss from its own first step (the JAX example's check):
# the 100m model reaches the synthetic stream's floor by step 5, so it resumes
# at step 2 (resumed at 10 to 20, its loss did not fall on the card).
EXAMPLE_TRAIN_STEPS = (2, 10)


def _load_example(script: str):
    spec = importlib.util.spec_from_file_location(f"example_{Path(script).stem}",
                                                  EXAMPLES_DIR / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_run(smi: str, script: str, args, expect) -> dict:
    """``main(args)`` of ``examples/<script>`` on the card (its default
    device) in this interpreter, its standard output captured: it must
    return 0, print every line of ``expect`` and launch no hand-written
    kernel (the counts zeroed just before).  Returns its record: wall
    seconds, kernel launches, what it printed."""
    main = _load_example(script).main
    what = " ".join([script] + list(args))
    for ops_fn in (ops.stencil2d, ops.stencil3d, ops.chain2d):
        ops_fn.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(list(args))
        torch.cuda.synchronize()
    except BaseException:
        print(f"{what} failed; it printed:\n{out.getvalue()}", file=sys.stderr, flush=True)
        raise
    wall = time.perf_counter() - t0
    launches = _kernel_launches()
    text = out.getvalue()
    check(rc == 0, f"{what} returned {rc}: {text[-2000:]}")
    for want in expect:
        check(want in text, f"{what} printed no {want!r}: {text[-2000:]}")
    check(all(v == 0 for v in launches.values()),
          f"{what} launches no hand-written kernel: {launches}")
    return dict(phase="examples", script=script, args=list(args), wall_s=wall, smi=smi,
                launches=launches, stdout=text.strip().splitlines())


def examples_phase(smi: str) -> None:
    """The port's examples on the card, each through its ``main`` in this
    interpreter: the quickstart, serve_lm, and train_lm's ``--preset 100m``
    into a fresh checkpoint directory, then train_lm further on that
    directory, which must resume."""
    t_phase = time.perf_counter()
    first, total = EXAMPLE_TRAIN_STEPS
    EXAMPLES_BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=EXAMPLES_BUILD) as ckpt:
        train = ("--preset", "100m", "--ckpt-dir", ckpt, "--steps")
        for run in (("quickstart_torch.py", (), ("out-of-core result == reference  [OK]",)),
                    ("serve_lm_torch.py", (), ("greedy outputs identical: True",)),
                    ("train_lm_torch.py", train + (str(first),), ("(improved)",)),
                    ("train_lm_torch.py", train + (str(total),),
                     (f"resumed from step {first}", "(improved)"))):
            emit(**example_run(smi, *run))
            gc.collect()
            torch.cuda.empty_cache()
    emit(phase="examples_done", seconds=time.perf_counter() - t_phase, card=smi)


def device_activity(prof, top: int = 12):
    """Of a ``torch.profiler`` run: the seconds the card was busy (the union
    of its kernels' and copies' intervals), the seconds of work they did
    (their sum: streams overlap), their count, and the ``top`` names by
    device ms, each with its ms and count."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_kernel[e.name[:80]][0] += e.time_range.elapsed_us() / 1e3
        by_kernel[e.name[:80]][1] += 1
    ranked = sorted(by_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    return (busy_us / 1e6, sum(v[0] for v in by_kernel.values()) / 1e3, len(device),
            [[k, v[0], v[1]] for k, v in ranked[:top]])


def tiles_by_graph_mode(spans, chain=None) -> dict:
    """Per tile of ``chain`` (of every chain: None), by its tile-graph mode
    (``warmup``: the key's first tile, eager; ``capture``: the capture and
    its first replay; ``replay``): the host seconds its compute op took to enqueue (the
    dispatch span's ``enqueue_s``) and its compute-stream window (the
    device span's CUDA-event ``device_s``), each tile's and the median."""
    from collections import defaultdict

    out = defaultdict(lambda: {"enqueue_s": [], "window_s": []})
    for sp in spans:
        a = sp.args or {}
        if (chain is not None and a.get("chain") != chain) or sp.name != "compute" \
                or "graph" not in a:
            continue
        rec = out[a["graph"]]
        if "device_s" in a:
            rec["window_s"].append(a["device_s"])
        else:
            rec["enqueue_s"].append(a["enqueue_s"])
    for rec in out.values():
        rec["tiles"] = len(rec["enqueue_s"])
        for k in ("enqueue_s", "window_s"):
            rec[f"median_{k}"] = statistics.median(rec[k]) if rec[k] else None
    return dict(out)


def profile_phase(n: int, steps: int, n_app: int) -> None:
    """The out-of-core path once more per backend, with the span tracer on
    and torch.profiler around the replayed round's flush: host time by plan
    op (the tracer's dispatch spans), lane spans, device time by kernel
    (CUPTI), and per tile of that flush its host enqueue seconds and
    compute-stream window, warm-up (eager), capture and replayed tiles
    apart.  Then the same per tile for CloverLeaf 2D at an n_app^2 interior
    on ``ooc``, 2 steps, at a third of its homes, its tile count set to 24
    so that graph keys repeat often (at phase 7's own count a key replays
    once, at its capture)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    homes = heat_inputs((n, n), seed=2)
    cap = sum(a.nbytes for a in homes.values()) / 3
    # Round 0 plans the chain; round 1 replays it and is the one profiled.
    for backend in ("ooc", "ooc-async"):
        sess = Session(backend, capacity_bytes=cap, cyclic=True, prefetch=True,
                       trace=True)
        tracer = sess.trace()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        _, _, (_, wall) = heat(sess, homes, steps, summary=True, rounds=2,
                               prof=prof)
        host = defaultdict(float)
        for sp in tracer.spans():
            if (sp.args or {}).get("chain") != 1:
                continue
            if sp.cat == "op":
                host[sp.name] += sp.t_end - sp.t_start
            elif sp.cat in ("lane", "chain"):
                host[f"{sp.track}:{sp.cat}"] += sp.t_end - sp.t_start
        busy_s, work_s, _, top = device_activity(prof)
        top_cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                         reverse=True)
        emit(phase="profile", backend=backend, interior=[n, n], steps=steps,
             wall_s=wall, host_s_by_span=dict(host),
             device_busy_s=busy_s, device_idle_share=1 - busy_s / wall,
             device_work_s=work_s, plan_time_s=sess.plan_stats()["plan_time_s"],
             tiles_by_graph_mode=tiles_by_graph_mode(tracer.spans(), chain=1),
             graph_per_chain=[{f: getattr(h, f) for f in GRAPH_FIELDS}
                              for h in sess.history],
             top_device_ms=top,
             top_host_ms=[[e.key, e.self_cpu_time_total / 1e3, e.count]
                          for e in top_cpu[:12]])
    from repro_torch.apps import CloverLeaf2D

    app = CloverLeaf2D(n_app, n_app, summary_every=2)
    for d in app.dats.values():
        d.pin()
    sess = Session("ooc", capacity_bytes=app.total_bytes() / 3,
                   num_tiles=24, prefetch=True, trace=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app.run(sess, steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    emit(phase="profile_tiles", app="cloverleaf2d", backend="ooc", interior=[n_app, n_app],
         steps=2, num_tiles=24, wall_s=wall, plan_time_s=sess.plan_stats()["plan_time_s"],
         tiles_by_graph_mode=tiles_by_graph_mode(sess.trace().spans()),
         graph_per_chain=[{f: getattr(h, f) for f in GRAPH_FIELDS} for h in sess.history])
    sess.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="cut every size (a short first run after a kernel edit)")
    ap.add_argument("--profile", action="store_true",
                    help="only profile the out-of-core path (no result line)")
    ap.add_argument("--disk", action="store_true",
                    help="only phase 8 and its phase 7 baselines (no result line)")
    ap.add_argument("--mesh", action="store_true",
                    help="only phase 9 and its phase 7 baselines (no result line)")
    ap.add_argument("--serve", action="store_true",
                    help="only phase 10 and its phase 7 baselines (no result line)")
    ap.add_argument("--model", action="store_true",
                    help="only phase 11, model decode (no result line)")
    ap.add_argument("--moe", action="store_true",
                    help="only phase 12, moe decode (no result line)")
    ap.add_argument("--ssm", action="store_true",
                    help="only phase 13, ssm, hybrid and encdec decode (no result line)")
    ap.add_argument("--train", action="store_true",
                    help="only phase 14, training (no result line)")
    ap.add_argument("--lm-mesh", action="store_true",
                    help="only phase 15, the LM mesh paths (no result line)")
    ap.add_argument("--analysis", action="store_true",
                    help="only phase 16, the step analysis, with its own dry run "
                         "(no result line)")
    ap.add_argument("--examples", action="store_true",
                    help="only phase 17, the port's examples (no result line)")
    ap.add_argument("--chunked", metavar="DIR",
                    help="only phase 8's chunked run, held against DIR/want.json "
                         "(the whole run starts this in a child process)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if args.chunked:
        return chunked_child(args.chunked)
    n2d, n3d, nooc, reps, napp2, napp3 = (16384, 512, 24576, 20, 8192, 256)
    if args.small:
        n2d, n3d, nooc, reps, napp2, napp3 = (1024, 64, 2048, 5, 512, 32)
        emit(cut="--small", kernel_2d=n2d, kernel_3d=n3d, ooc=nooc, reps=reps,
             app_2d=napp2, app_3d=napp3)
    smi = device_phase()
    if args.profile:
        profile_phase(nooc, steps=4, n_app=napp2 // 2)
        return 0
    if args.disk:
        disk_phase(napp2, cl2d_baselines(napp2))
        return 0
    if args.mesh:
        mesh_phase(napp2, cl2d_baselines(napp2)[f"at{CUT_STEPS}"], smi, reps=reps)
        return 0
    if args.serve:
        serve_phase(napp2, cl2d_baselines(napp2)[f"at{CUT_STEPS}"], smi)
        return 0
    if args.model:
        model_phase(smi)
        return 0
    if args.moe:
        moe_phase(smi)
        return 0
    if args.ssm:
        ssm_phase(smi)
        return 0
    if args.train:
        train_phase(smi)
        return 0
    if args.lm_mesh:
        lm_mesh_phase(smi)
        return 0
    if args.analysis:
        analysis_phase(smi, n=napp2)
        return 0
    if args.examples:
        examples_phase(smi)
        return 0
    build_phase()
    path = kernels_phase(n2d, n3d, reps)
    launches = kernel_path_phase(n2d, n3d)
    torch.cuda.empty_cache()
    chain_path, chain_launches = chain2d_phase(n2d, reps)
    path.update(chain_path)
    launches.update(chain_launches)
    torch.cuda.empty_cache()
    ooc_phase(nooc, steps=4)
    slot_pool_phase(nooc // 4, steps=4)
    torch.cuda.empty_cache()
    baseline = apps_phase(napp2, napp3)
    chunked = disk_phase(napp2, baseline, chunked_apart=True)
    try:
        at = baseline.pop(f"at{CUT_STEPS}")
        del baseline
        gc.collect()
        mesh_phase(napp2, at, smi, reps=reps)
        chunked.join()
    finally:
        chunked.stop()
    gc.collect()
    serve_phase(napp2, at, smi)
    del at
    gc.collect()
    model_phase(smi)
    moe_phase(smi)
    ssm_phase(smi)
    train_phase(smi)
    lm_mesh_phase(smi, keep_dryrun=True)
    analysis_phase(smi, dryrun=LM_MESH_DIR / "dryrun", n=napp2)
    examples_phase(smi)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
         **({"steps": rec["steps"], "library": rec["library"]}
            if "steps" in rec else {})}
        for name, rec in path.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
