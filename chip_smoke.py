#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (cgcnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each fatal on failure (exit code != 0):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build of the hand-written kernels from ``cgcnet_tpu_torch/csrc`` (nvcc),
   with the compiler's registers and spills of every instantiation of the
   bf16 tensor-core kernels, of the heads' f32 product and of the gathers
   (B7, B8's SIMT kernel) (``TC_KERNELS``);
3. kernels: B1 (block build, for A and for the binary transpose blocks),
   B2 (block-sparse matmul, at every width one training step gives it, on
   the forward and on the transpose blocks, walking the live slots the
   model counted beside B1), B3 (BN statistics of the assign
   tail), B4 (fused assign head) and B5 (assign-tail backward) on the inputs
   that one canonical SAGE training step gives them, B6 (fused assign
   softmax) on those of one canonical GIN step, and B7 (block-sparse
   gather-sum, blocks built on the fly) at the B2 widths on the canonical
   batch's ELL and its transpose tables (captured), in f32 and bf16, each
   held against its plain PyTorch version on the same CUDA tensors (B7 also
   against B1 -> B2), with CUDA-event timings of kernel, plain version and
   (B2, B7) one PyTorch library call;
4. serving slice: a synthetic dataset whose sampled graphs fill the
   canonical capacity (B=4, N=5760, C=1140), a seeded canonical CGCNet saved
   in the port's checkpoint format, ``cli.predict.main`` on the card with
   ``--reps 2`` while the launch counters are read (B1 = 1, B2 = 4, B4 = 1
   per batch), one batch recomputed on the CPU through the plain versions,
   and the per-batch forward latency;
5. training slice: two epochs of optimizer steps through ``train.loop`` on
   the same data (B1 = 2, B2 = 7, B3 = 1, B4 = 1, B5 = 1 launches per step,
   finite loss, parameters and running statistics changed), the median
   train-step time, one ``cli.train.main`` epoch with mid-epoch and
   end-of-epoch validation and checkpoints, and one step's loss and
   gradients on the card against the CPU plain path;
6. GIN slice: phases 4 and 5 with ``model.gcn_name=GIN`` (B1/B2/B6 = 1/4/1
   per serving batch and 2/7/1 per step, no B3/B4/B5), its step's gradients
   also held against the plain versions on the card (see ``GRAD_REL``);
7. the rest of the slice: ``EllAdjFactored`` without block values (one B7
   launch forward, one backward, against the gather branch); SAGE with
   ``fused_assign_norm=never`` (B6) against the default (B4) on the same
   weights and batch; one forward and one train step each of GAT and
   SAGE+elu (B6 once each); the batch with its block metadata stripped,
   forward and backward with no kernel launched;
8. slide serving: ``cli.slide.main`` on a synthetic 100k-nuclei slide,
   ``--shards 1``, bf16, the phase-4 patch checkpoint, ``--slides 3``, with
   the counters read (B1 = 2 per slide build; B2 = 3, B8 = 1, B4 = 1 per
   forward); the forward's CUDA-event time; its logits against the plain
   versions on the card;
9. slide training: 12 steps of ``make_slide_train_step`` at 100k, bf16
   (B2 = 5, B3 = 1, B4 = 1 with S lane-padded to 1152, B8 = 2 — one with
   the row accumulator and split outputs —, B5 = 1 per step), finite
   loss, parameters and running statistics changed, one step's loss and
   gradients against the plain versions on the card (``step_hold``: the
   plain side keeps the kernels of ``assign_head.STATS_HELD``, B3 and B9b,
   so both sides read the same BN statistics, which the statistics hold
   below judges on their own; the gradients are held on the plain steps
   replayed with the kernel step's max-readout routing, so a near-tied
   readout that swaps nodes on the last bits does not move them, and a
   node moved further than ``READOUT_STEPS`` bf16 steps, or more than
   ``READOUT_SHARE`` of a readout's columns moved, fails the hold); one
   ``cli.slide --train-epochs 2 --out`` round trip, the written file served
   again;
10. capacity path: 6 steps with ``model.assign_tail_chunk=65536
   mesh.remat_stage1=true`` (chunks of 65536 and 34816 rows; B9b = 1, B9a
   = 5, B5 = 2, B8 = 2, B2 = 8 per step), the step hold as in phase 9;
   then an f32 forward and step of an 8192-nuclei
   slide on the card against the CPU (block tables built by hand for both);
   then the statistics hold: B3's and B9b's column sums and sums of squares
   on the slide's own bf16 inputs against the exact (f64) statistics of the
   plain version's h, within ``assign_head.STATS_TOL``, printed beside the plain
   versions' and two witnesses' distances (a right computation by another
   route, which must pass, and one a rounding step off, which must fail);
   then B8 (the A @ S legs, the transpose legs with and without the
   accumulator, halo windows from shard 0 of a 4-shard stripe-sorted
   partition — its launches are phase 11's —, the ``epilogue_sw``
   option), B9a, B9b, B3, B4 (serving, and
   training's lane-padded ``c_out``), B5 (the training call and each
   capacity chunk) and the int8 B1/B2 legs against their plain versions on
   the card, in f32 and bf16, on inputs captured from phases 8-10, timed as
   in phase 3. B4, B6 and B9a also carry ``product_library_ms``, their
   product [rows x (F12+C)] @ [(F12+C) x C] alone as one cuBLAS call (a
   yardstick), and one B4 and one B9a call at the slide's shapes the device
   time of each of the head's launches (``split_ms``: row norm, product,
   softmax, and the padded weight copies as ``other``) from a
   torch.profiler trace;
11. the slide at 4 shards: 4 spawned ranks sharing the one card over
   gloo (``parallel/mesh.py``'s backend rule; the collectives staged
   through pinned host memory), each through the normal entry points:
   ``cli.slide.main`` at ``--shards 4``, bf16, the phase-4 checkpoint (B1 =
   2 per build, B2 = 3, B8 = 1, B4 = 1 per forward on every rank, B8 on
   the halo windows wherever a rank's tables carry them), logits the same
   bits on every rank and held, on rank 0, against the plain versions on
   the same four shards at phase 8's bf16 rule; the 4-shard f32 forward
   against the one-shard f32 forward of the same slide and weights at
   ``LOGIT_ATOL``/``LOGIT_RTOL``; two bf16 ``make_slide_train_step``
   steps (finite loss, every parameter and running statistic moved, and
   after each step every rank's parameters, Adam state and running
   statistics equal to rank 0's); CUDA-event times of the forward and the
   steps beside the card's name and power limit — a correctness run of
   one card, not a multi-card figure. A rank's failure fails the run;
12. the remaining entry points, on phase 4's data and checkpoints: (a)
   ``cli.export`` on the card — the kernel artifact, reloaded, forwards the
   canonical batch through ``torch.ops.cgcnet_tpu_torch.*`` (B1/B2/B4 =
   1/4/1, logits within B4's f32 ``TOL`` of the eager model's), the same
   for a ``--symbolic-batch`` artifact at batch 2 and 4 and for GIN's (B6),
   the reloaded and the eager forward's CUDA-event times, and the portable
   (``--cpu``) artifact on the CPU against the card at
   ``LOGIT_ATOL``/``LOGIT_RTOL``; (b) ``evaluate(visualize_dir=)``: one
   GEXF per patch up to ``VIS_MAX``, each parsed back (nodes, edges, the
   composed argmax of the forward's S1 and S2); (c) one epoch of
   ``train.loop`` with ``data.dynamic_buckets=true`` on patches spanning at
   least two buckets (``TRAIN_PER_STEP`` at each, finite loss, one step's
   loss and gradients against the CPU by ``grad_hold``); (d)
   ``cli.preprocess fixed``, then the ``use_fixed`` batches equal to the
   online ones bit for bit, and one train step with
   ``graph_sampler=random`` (ELL width 2K+1) held as in (c); (e)
   ``cli.crossval`` (three one-epoch folds, finite, their mean), one
   ``cli.train`` epoch with ``train.profile=true`` whose trace holds B1-B5's
   kernels (``PROFILE_KERNELS``), and a ``train.debug_nans`` step that
   passes on clean input and raises on a planted NaN; (f) ``cli.preprocess
   features`` on numpy tiles, on scipy's branch (the module's ``cv2`` set
   to None) and on OpenCV's where it is installed, the scipy protos loaded
   by ``NucleiGraphDataset``, with the seconds per tile. Its launch counts
   are the paths ``ENTRY_PATHS``;
13. the patch training step over a data axis: 2 spawned ranks sharing the
   one card over gloo (``dp_worker`` / ``dp_rank``), phase 4's data,
   weights and config with ``DP_OVER`` (no dropout, SGD), each rank loading
   its 2 of every 4-graph batch through the process-sharded ``GraphLoader``
   and stepping through ``train.loop.make_train_step(data_axis=)`` (every
   BN's and B3's statistics over both ranks, DDP's gradient average) for
   ``DP_STEPS`` steps: B1/B2/B3/B4/B5 = 2/7/1/1/1 per rank per step, the
   ranks bit-identical after each step, and held against the one-process
   step on the same global batches on this card (losses and running
   statistics at ``LOGIT_ATOL``/``LOGIT_RTOL``, step 1's gradients at
   ``GRAD_REL``/``GRAD_FLOOR``, its parameters at that rule times lr plus
   one f32 step); a sharded checkpoint of the training state written by
   both ranks after step 1 (``train/checkpoint_sharded.py``), loaded in
   this process, whose next step holds against the unbroken run's; then
   ``parallel.dryrun.run_dryrun(DP_DRYRUN)`` (the data-parallel, 4-shard
   slide and capacity steps); each rank's step wall, the host ms of one
   step in DDP's bucket all-reduces, the statistics' sums and the
   metrics' sum, and its peak memory, beside the card's name and power
   limit — a correctness run of one card, not a multi-card figure. Its
   launch counts are the paths ``data_parallel``, ``dryrun_dp`` and
   ``dryrun_slide``;
14. the capacity ladder: the capacity recipe (``SLIDE_CAPACITY``, bf16,
   phase 4's weights) on synthetic slides of ``LADDER_NUCLEI`` (500k, 750k
   and 1M nuclei: 500224, 750080 and 1000448 rows, 8, 12 and 16 chunks),
   each through ``make_slide_train_step``: ``LADDER_STEPS`` steps (B9b =
   1, B9a = 1 + 2 x chunks, B5 = chunks, B2 = 10 per step: the rungs'
   tables carry no band windows, so B2 takes the A @ S leg and its
   transpose, B8's at 100k — ``capacity_per_step``, ``unbanded``,
   ``BANDED_NUCLEI``), finite losses, every parameter and running
   statistic moved, the median step time of the three by CUDA events and
   the peak memory after ``reset_peak_memory_stats``, the host build's
   graph and partition seconds; at each rung the eval logits held against
   the plain versions at phase 8's rule and the train-mode loss of one
   forward at the step holds' loss rule (``loss_hold``), and at each rung
   of ``LADDER_GRAD_HOLD`` (every rung) phase 10's full step hold, with
   the holds' peak memory; the default (no-chunk) step at
   ``LADDER_DEFAULT`` (3 steps, its time and peak); at ``LADDER_KERNELS``
   B2's wide legs of the capacity step against the plain version, timed
   like phase 3 (``ladder_kernels``); at the top rung the first step under
   the caching allocator's history (``memory_account``: the
   ``ACCOUNT_BLOCKS`` largest blocks alive at the peak, each with the
   port's file:line that allocated it), B9a (its call over every row),
   B9b (with the statistics hold against the exact sums and its two
   witnesses) and B5 (each capacity chunk) against their plain versions
   on the rung's own captured inputs, timed like phase 3
   (``ladder_top_kernels``), then ``cli.slide.main`` at 1M nuclei with
   the recipe and ``--train-epochs 1`` (finite losses and post-fine-tune
   logits, its launches and peak);
   a least-squares fit of the capacity step's peak over the rungs and the
   100k slide's steps run again here (phase 10 holds them; its own peak is
   read while phases 8-10 keep the kernel inputs they captured) of each
   rung's own peak (its peak less what the card held before the rung) —
   bytes a row and fixed GiB; every number beside the card's name and
   power limit.
   Its launch counts are the paths ``slide_ladder``,
   ``slide_ladder_default`` and ``slide_ladder_cli``;
15. the slide CLI's defaults: ``Config()`` (f32), ``SLIDE_NUCLEI`` (the
   CLI's default ``--nuclei``), one shard, phase 4's checkpoint. In f32 B8
   takes no leg, so each of its legs runs on f32 B2 at F = 1140
   (``F32_FORWARD``, ``F32_TRAIN_PER_STEP``, ``F32_CAP_PER_STEP``):
   ``cli.slide.main --slides 2`` with no dtype override (B1 = 2 per
   build, B2 = 4 and B4 = 1 per forward, B8 = 0), the forward's CUDA-event
   time and its logits against the plain versions on the card at
   ``LOGIT_ATOL``/``LOGIT_RTOL``; the default (no-chunk) step and the
   capacity recipe (``SLIDE_CAPACITY`` without ``SLIDE_DTYPE``: B9a and
   B9b on their f32 legs), each held first — one step's loss at the f32
   logit rule and its gradients at ``GRAD_REL``/``GRAD_FLOOR``, nothing
   widened, on the plain step replayed with the kernel step's readout
   routing within ``READOUT_STEPS``/``READOUT_SHARE``
   (``f32_step_hold``) — then a few steps (launches per step, finite
   losses, every parameter and running statistic moved, the median step
   time by CUDA events, the peak memory); then one ``cli.slide
   --train-epochs 1 --out`` round trip, the written file served again.
   Its launch counts are the paths ``slide_f32_serve``,
   ``slide_f32_train`` and ``slide_f32_capacity``;
16. ``assign_tail_train_chunked`` (the chunked tail over a stored p, which
   no model path calls): one forward and backward, in f32 and bf16, at the
   canonical patch's pool-1 shape (B=4, N=5760, C=1140, chunks of
   ``TAIL_PATCH_CHUNK``) and at the 100k slide's rows (chunks of
   ``CAP_CHUNK``), seeded operands: its launches (``tail_per_call``: B3 =
   1, B4 = 1 + 2 x chunks, B5 = chunks), S, the statistics and the seven
   gradients held against the plain versions on the card at the ``TOL``
   of the kernel each comes from (``TAIL_RULE``), the call timed with the
   kernels and plain like phase 3. Its launch counts are the paths
   ``chunked_tail_patch`` and ``chunked_tail_slide``.

The statistics hold runs after the step holds of phases 9 and 10 that
rest on it (it reads inputs those phases capture): a run whose statistics
fail it fails all the same, whatever the step holds said before.

The second-to-last lines are one JSON object of per-kernel numbers and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12,   # f32 outside the tensor cores
                  "bfloat16": 989e12}  # dense bf16 tensor cores
# stated tolerances on max|kernel - plain| over the same CUDA tensors, as a
# fraction of max|plain|: B1 sums the same f32 weights in the same slot
# order (exact); the others sum in another order — f32: B2 and B7 1e-4 (the
# JAX suite's), B3 1e-5 (column sums of 23040 rows), B4 and B6 1e-5
# (1180-term f32 dots, then exp), B5 1e-4 (1140-term row dot feeding a
# difference); bf16: the two roundings of a stored value may land one bf16
# step apart, and a step is up to 2^-7 of the value, so 2^-6
TOL = {
    ("B1", "float32"): 0.0, ("B1", "bfloat16"): 0.0,
    ("B2", "float32"): 1e-4, ("B2", "bfloat16"): 2.0 ** -6,
    ("B3", "float32"): 1e-5, ("B3", "bfloat16"): 2.0 ** -6,
    ("B4", "float32"): 1e-5, ("B4", "bfloat16"): 2.0 ** -6,
    ("B5", "float32"): 1e-4, ("B5", "bfloat16"): 2.0 ** -6,
    ("B6", "float32"): 1e-5, ("B6", "bfloat16"): 2.0 ** -6,
    ("B7", "float32"): 1e-4, ("B7", "bfloat16"): 2.0 ** -6,
}
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-3   # whole model, card vs CPU, f32
# one train step, card vs CPU plain path (f32, same weights and batch): the
# loss as the logits; each gradient tensor within 1e-3 of its own max|grad|
# (sums over 23040 rows and 1140 clusters in another order, through BN
# batch statistics and a softmax, then ~20 chained backward products), plus
# 1e-5 of the largest gradient entry of the model (a gradient that is zero
# in theory, as the JK attention bias's — one bias on every layer's score —
# is rounding noise on both sides)
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-5
# GIN's step amplifies f32 rounding past that rule (a near one-hot assign
# softmax, max S 0.9987 on the canonical batch, feeding stages 2-3, whose
# BN runs over 4 x 114 rows): the same plain PyTorch step on the card and on
# the CPU parts by about twice it. So GIN holds its kernels against their
# plain versions on the same card at the rule, and the card against the CPU
# at the rule widened by that plain-vs-plain distance; the CPU's change
# under x moved by one rounding step (NUDGE_SEEDS) is logged beside it
NUDGE_SEEDS = (3, 4, 5)
# synthetic patches of 9000..11404 nuclei, sampled at ratio 0.5, fill the
# canonical capacity: batches of B=4 graphs padded to N=5760, C=1140 clusters
DATA_NODES = (9000, 11404)
CANONICAL = {"B": 4, "N": 5760, "C": 1140}
TRAIN_EPOCHS = 2        # of 6 batches each (24 training patches, drop_last)
KERNELS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8", "B9a", "B9b")
# launches per train step and per serving batch, SAGE (canonical) and GIN;
# a kernel not named launches 0 times
TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B3": 1, "B4": 1, "B5": 1}
SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B4": 1}
GIN_TRAIN_PER_STEP = {"B1": 2, "B2": 7, "B6": 1}
GIN_SERVE_PER_BATCH = {"B1": 1, "B2": 4, "B6": 1}
# the whole-slide path: a synthetic slide of SLIDE_NUCLEI nuclei (100352
# rows, 784 row tiles), one shard, bf16 activations, the canonical widths
SLIDE_NUCLEI = 100_000
SLIDE_CAP = -(-SLIDE_NUCLEI // 512) * 512   # 100352 rows, 784 row tiles
SLIDE_DTYPE = ["model.compute_dtype=bfloat16"]
CAP_CHUNK = 65536       # model.assign_tail_chunk of the capacity path
SLIDE_CAPACITY = [f"model.assign_tail_chunk={CAP_CHUNK}",
                  "mesh.remat_stage1=true"]
SLIDE_STREAM = 3        # slides of the cli.slide --slides stream
SLIDE_TRAIN_STEPS = 12
SLIDE_CAP_STEPS = 6
SMALL_SLIDE_NUCLEI = 8192   # the f32 card-vs-CPU slide
# B8's halo-window variant: shard 0 of the slide stripe-sorted for 4 shards
# (a partition whose halo outgrows the resident tail), at the A@S width
HALO_SHARDS, HALO_NUCLEI, HALO_F = 4, 100_000, 1152
SLIDE_BUILD = {"B1": 2}                              # per slide build
SLIDE_FORWARD = {"B2": 3, "B8": 1, "B4": 1}          # per forward
SLIDE_TRAIN_PER_STEP = {"B2": 5, "B3": 1, "B4": 1, "B5": 1, "B8": 2}
SLIDE_CAP_PER_STEP = {"B2": 8, "B5": 2, "B8": 2, "B9a": 5, "B9b": 1}
# the slide holds run in bf16 (the slide path's activations): kernels
# against their plain versions on the same card, at the f32 rules (logits
# LOGIT_ATOL/RTOL, gradients GRAD_REL/GRAD_FLOOR) widened by BF16_WIDEN x
# the distance between the plain bf16 computation and the plain f32 one on
# the same card — what bf16 rounding alone moves: the kernels and the plain
# versions round at other points, two such bf16 computations part by up to
# the sum of their distances from the f32 one, and either may lie up to
# about twice as far from it as the other (on an H100 80GB HBM3 the JK
# attention bias, whose gradient is zero in theory and rounding noise in
# bf16, parted by 2.34x that distance)
BF16_WIDEN = 4.0
# a gradient that is zero in theory (the JK attention biases: a shared
# score offset, ``zero_in_theory``) comes out as rounding noise; in bf16
# its floor is half a bf16 step of the model's largest gradient (on an
# H100 80GB HBM3 jk2.att.bias parted by 1e-4 of the model's largest
# gradient on the capacity path, where its plain bf16 and f32 values
# happened to agree to 2.4e-7). Every other tensor keeps GRAD_FLOOR
BF16_FLOOR = 2.0 ** -9
# the step holds' replay of the kernel step's max readouts on the plain
# steps (``step_hold``): a readout column whose own maximum lies elsewhere
# than the kernel step's node is a near-tie only when the plain step's value
# at that node lies within READOUT_STEPS bf16 steps of its own maximum, and
# at most READOUT_SHARE of a readout's columns may move. On an H100 80GB
# HBM3 right computations (every kernel; the held statistics nudged by
# 1e-7) moved nodes up to 9 steps on the stage-3 readout against the plain
# bf16 step and 7.5 against the f32 one, and 4 of the stage-1 readout's 20
# columns against the f32 step
READOUT_STEPS = 16.0
READOUT_SHARE = 0.5
# B8, B9a, B9b as B2, B4 and B3: f32 B8 1e-4 (sums over 128*M block
# columns in another order), B9a and B9b 1e-5 (the F3-term dot forming p
# is rounded alike, then B4's and B3's sums); bf16 2^-6
TOL.update({
    ("B8", "float32"): 1e-4, ("B8", "bfloat16"): 2.0 ** -6,
    ("B9a", "float32"): 1e-5, ("B9a", "bfloat16"): 2.0 ** -6,
    ("B9b", "float32"): 1e-5, ("B9b", "bfloat16"): 2.0 ** -6,
})
# phase 12's paths (the remaining entry points), on the patch kernels
ENTRY_PATHS = ("export", "gin_export", "visualize", "buckets", "random",
               "crossval", "profile")
PATCH_PATHS = ("serve", "train", "gin_serve", "gin_train", "rest",
               *ENTRY_PATHS, "data_parallel", "dryrun_dp",
               "chunked_tail_patch")
SLIDE_PATHS = ("slide_serve", "slide_train", "slide_capacity",
               "slide_shards", "dryrun_slide", "slide_ladder",
               "slide_ladder_default", "slide_ladder_cli", "slide_f32_serve",
               "slide_f32_train", "slide_f32_capacity", "chunked_tail_slide")
# phase 11: the slide over SHARDS ranks sharing the one card over gloo
# (parallel/mesh.py's backend rule), SHARD_STEPS training steps; a rank that
# waits on the others longer than SHARD_TIMEOUT_S fails, and so the run
SHARDS = 4
SHARD_STEPS = 2
SHARD_TIMEOUT_S = 600
# phase 12: synthetic patches of 1500..6000 nuclei sampled at 0.5 (750..3000
# rows) spread over the dynamic buckets of 1024, 2048 and 4096 rows; GEXF
# files of the first VIS_MAX patches; TILE_COUNT preprocess tiles of
# TILE_PIXELS^2 px with a nucleus every TILE_STEP px; the kernels of B1-B5
# whose names the profiler's trace must hold (f32)
# phase 13: the canonical patch step over DP_RANKS ranks sharing the one
# card over gloo (DP_STEPS steps, phase 4's config with DP_OVER), then
# run_dryrun(DP_DRYRUN); a rank that waits on the others longer than
# DP_TIMEOUT_S fails, and so the run
DP_RANKS = 2
DP_STEPS = 3
DP_DRYRUN = 4
DP_TIMEOUT_S = 600
DP_OVER = ["model.drop_out=0.0", "train.optim=sgd", "train.lr=1e-3",
           "train.momentum=0.9", "train.weight_decay=1e-4"]
BUCKET_NODES = (1500, 6000)
VIS_MAX = 6
TILE_COUNT, TILE_PIXELS, TILE_STEP = 6, 1024, 24
PROFILE_KERNELS = {"B1": ("build_blocks_kernel",),
                   "B2": ("bsr_matmul_f32_kernel",),
                   "B3": ("stats_kernel",),
                   "B4": ("gemm_kernel", "rnorm_kernel"),
                   "B5": ("tail_bwd_kernel", "tail_bwd_staged_kernel")}
# phase 14: the capacity recipe (SLIDE_CAPACITY, bf16, phase 4's weights)
# on synthetic slides at the JAX package's ladder rungs above phase 10's
# 100k (BASELINE.md, benchmarks/slide_scale_r5.json), LADDER_STEPS steps a
# rung; the default (no-chunk) step at LADDER_DEFAULT nuclei, the largest
# rung where the JAX package's default fit; phase 10's full step hold at
# each rung of LADDER_GRAD_HOLD; the memory account (ACCOUNT_BLOCKS
# blocks), B9a, B9b (with the statistics hold) and B5 against their plain
# versions, and one cli.slide --train-epochs 1 run at the top rung
LADDER_NUCLEI = (500_000, 750_000, 1_000_000)
LADDER_STEPS = 3        # the step time is their median, the first included
LADDER_DEFAULT = 750_000
LADDER_GRAD_HOLD = LADDER_NUCLEI
LADDER_TOP = LADDER_NUCLEI[-1]
ACCOUNT_BLOCKS = 10
# the slides whose one-shard tables carry B8's band windows: a super tile's
# columns fit W_BAND (16) tiles on the synthetic slide at 100k nuclei, not
# at the rungs (a band's population grows as sqrt(nuclei); the JAX
# package's bsr_kernel.W_BAND puts the edge at ~150-200k), where B2 takes
# B8's legs (``unbanded``), as in the JAX package
BANDED_NUCLEI = (SLIDE_NUCLEI,)
# the rung whose capacity step's wide B2 legs (A @ S and its transpose,
# F = 1140, B8's legs on the 100k slide) are held and timed like phase 3
LADDER_KERNELS = 500_000
# phase 15: the slide CLI's defaults — Config() (f32), SLIDE_NUCLEI, one
# shard. In f32 B8 takes no leg (``ops/ell.py: _banded_on`` and the
# ``PoolAggregate`` branch of ``parallel/mega_model.py`` take it for 2-byte
# activations only, as the JAX package's ``ops/ell.py:259``), so each B8
# leg of the bf16 paths runs on f32 B2 at F = 1140 (``unbanded``)
F32_STREAM = 2          # slides of its cli.slide --slides stream
F32_TRAIN_STEPS = 4
F32_CAP_STEPS = 3
F32_FORWARD = {"B2": 4, "B4": 1}
F32_TRAIN_PER_STEP = {"B2": 7, "B3": 1, "B4": 1, "B5": 1}
F32_CAP_PER_STEP = {"B2": 10, "B5": 2, "B9a": 5, "B9b": 1}
# phase 16: assign_tail_train_chunked (no model path calls it) at the
# canonical patch's pool-1 shape in chunks of TAIL_PATCH_CHUNK (5760 rows:
# two chunks and a 1664-row remainder, each slicing all four graphs) and
# at the 100k slide's rows in chunks of CAP_CHUNK (one chunk and a
# 34816-row remainder); F12 is layers 1-2 at the canonical widths
TAIL_PATCH_CHUNK = 2048
TAIL_F12 = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after warmup)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wrappers() -> dict:
    """Kernel id -> wrapper (each has a ``launches`` count)."""
    from cgcnet_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def zero_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in wrappers().items()}


def expected(per: dict, times: int = 1) -> dict:
    """Launch counts of every kernel for ``times`` units of ``per``."""
    return {k: per.get(k, 0) * times for k in KERNELS}


def grads_of(model, graph) -> tuple[float, dict]:
    """(loss, {name: grad}) of one training-mode forward + backward."""
    from cgcnet_tpu_torch.nn.model import cross_entropy_loss

    model.train()
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(graph), graph.y)
    loss.backward()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def kernel_sites() -> list:
    """(module, name, kernel id, plain version) of every site where the
    model calls a kernel wrapper through a module's global name."""
    from cgcnet_tpu_torch.nn import model as model_mod
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr, ell
    from cgcnet_tpu_torch.parallel import mega_model

    return [
        (model_mod, "bsr_build_blocks", "B1", bsr.bsr_build_blocks_plain),
        (mega_model, "bsr_build_blocks", "B1", bsr.bsr_build_blocks_plain),
        (ell, "bsr_matmul", "B2", bsr.bsr_matmul_plain),
        (ah, "l2relu_stats", "B3", ah.l2relu_stats_plain),
        (ah, "assign_head_softmax_pre", "B4", ah.assign_head_softmax_pre_plain),
        (ah, "assign_tail_bwd", "B5", ah.assign_tail_bwd_plain),
        (ah, "assign_head_softmax", "B6", ah.assign_head_softmax_plain),
        (ell, "bsr_gather_sum", "B7", bsr.bsr_gather_sum_plain),
        (ell, "bsr_matmul_banded", "B8", bsr.bsr_matmul_banded_plain),
        (mega_model, "bsr_matmul_banded", "B8", bsr.bsr_matmul_banded_plain),
        (ah, "assign_head_softmax_pre_lin", "B9a",
         ah.assign_head_softmax_pre_lin_plain),
        (ah, "l2relu_stats_lin", "B9b", ah.l2relu_stats_lin_plain),
    ]


@contextlib.contextmanager
def sites_replaced(replacement):
    """For the duration, each site where the model calls a kernel wrapper
    calls ``replacement(kernel id, wrapper, plain version)`` instead."""
    sites = kernel_sites()
    originals = [getattr(mod, name) for mod, name, _, _ in sites]
    for (mod, name, key, plain), orig in zip(sites, originals):
        setattr(mod, name, replacement(key, orig, plain))
    try:
        yield
    finally:
        for (mod, name, _, _), orig in zip(sites, originals):
            setattr(mod, name, orig)


def all_plain(key, wrapper, plain):
    """Every site its plain version."""
    return plain


def stats_shared(key, wrapper, plain):
    """The step holds' plain bf16 side: the kernels whose statistics the
    statistics hold judges (``assign_head.STATS_HELD``: B3, B9b) stay the
    kernel, every other site its plain version."""
    from cgcnet_tpu_torch.ops import assign_head as ah

    return wrapper if key in ah.STATS_HELD else plain


def bf16_steps(gap, scale):
    """``gap`` in bf16 steps at ``scale`` (elementwise): a step is 2^-7 of
    the power of two at or below |scale|."""
    import torch

    exp = torch.frexp(scale.abs().float()).exponent
    return gap.float() / torch.ldexp(torch.ones_like(gap.float()), exp - 8)


def readout_routing():
    """A torch function mode over the model's max readouts (``torch.amax``
    over the nodes of a [nodes, F] tensor). Entered as it is, it records,
    per readout in call order, where each column's maximum lies (``masks``);
    inside ``replay()`` each readout instead takes the mean of x at the
    recorded positions — the maximum, on the recording side — whose gradient
    goes to those positions, split evenly among ties, as amax's does. So a
    step replayed this way routes its readouts' gradients to the nodes the
    recorded step chose, whatever its own last bits would have chosen.
    Each replay appends to ``moves`` one (columns, columns moved, worst gap)
    per readout: a column moved when its own maximum lies elsewhere than
    the recorded one, and its gap is its own maximum less its least value
    at the recorded nodes, in bf16 steps (``bf16_steps``) of the larger of
    the two."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Routing(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.masks, self.moves, self.replaying, self.i = [], [], False, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if not (func is torch.amax and dim in (0, (0,), [0])
                    and not kwargs.get("keepdim") and len(args) <= 2
                    and args[0].dim() == 2 and args[0].shape[0] > 1):
                return func(*args, **kwargs)
            x = args[0]
            if not self.replaying:
                out = func(*args, **kwargs)
                self.masks.append(x.detach() == out.detach()[None])
                return out
            if self.i >= len(self.masks):
                raise SystemExit("readout routing: more readouts replayed "
                                 "than recorded")
            mask = self.masks[self.i]
            self.i += 1
            xd = x.detach()
            top = torch.amax(xd, 0)
            moved = ((xd == top[None]) != mask).any(0)
            low = torch.where(mask, xd, torch.full_like(xd, float("inf")))
            low = torch.amin(low, 0)
            gap = bf16_steps(top - low, torch.maximum(top.abs(), low.abs()))
            self.moves[-1].append((
                mask.shape[1], int(moved.sum()),
                float(gap[moved].max()) if moved.any() else 0.0))
            w = mask.float()
            return (x.float() * (w / w.sum(0))).sum(0).to(x.dtype)

        @contextlib.contextmanager
        def replay(self):
            self.replaying, self.i = True, 0
            self.moves.append([])
            try:
                with self:
                    yield
            finally:
                self.replaying = False
            if self.i != len(self.masks):
                raise SystemExit(f"readout routing: {self.i} readouts "
                                 f"replayed, {len(self.masks)} recorded")

    return Routing()


def capture_inputs(model, graph) -> dict:
    """Run one training step's forward and backward with shims in front of
    the kernel wrappers and keep (clones of) the arguments each one is
    given, in call order."""
    import torch

    seen: dict[str, list] = {key: [] for key in KERNELS}

    def shim_for(key, wrapper, plain):
        def shim(*args):
            if key in ("B8", "B9a", "B9b"):  # not on the patch path
                return wrapper(*args)
            seen[key].append(
                [a.detach().clone() if isinstance(a, torch.Tensor) else a
                 for a in args]
            )
            return wrapper(*args)
        # a wrapper counts its launches through its module's global name,
        # which is the shim for the duration of the capture
        shim.launches = 0
        return shim

    with sites_replaced(shim_for):
        grads_of(model, graph)
    model.zero_grad(set_to_none=True)
    return seen


def record_kernel(results, name, key, dt, out, ref, kernel_fn, plain_fn,
                  bytes_, ops, library=None, source="", replaces="",
                  ops_dt=None, paths=None, reps=15, plain_reps=15,
                  extra=None) -> None:
    """Hold a kernel's output (a tensor or a tuple) against its plain
    version's at TOL, time kernel, plain version and library call (CUDA
    events), and append the kernel-line entry to ``results``; ``paths``
    names the main paths whose launches it counts (default the patch
    paths; () for a variant that no path of this run takes); ``extra``
    adds fields to the entry (the head's yardstick and split); ``ops`` may
    be a {dtype: count} split, each part at its type's peak rate."""
    import torch

    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max((o.float() - r.float()).abs().max().item()
              for o, r in zip(outs, refs))
    scale = max(r.float().abs().max().item() for r in refs)
    tol = TOL[(key, dt)] * scale
    ok = err <= tol
    ms = time_ms(kernel_fn, reps=reps)
    plain_ms = time_ms(plain_fn, reps=plain_reps, warmup=min(2, plain_reps))
    lib_ms = None
    if library is not None:
        # the yardstick only: a library without this call is recorded as
        # null, it does not fail the run
        try:
            lib_ms = time_ms(library(), reps=reps)
        except (RuntimeError, NotImplementedError) as e:
            log(f"  library call unavailable for {name}: {e}")
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    # ops: a count at the rate of ops_dt (default the leg's type), or
    # {type: count} for work split between the tensor cores and the CUDA
    # cores (B9b in bf16), each part at its own rate
    parts = ops if isinstance(ops, dict) else {ops_dt or dt: ops}
    t_ops = sum(n / PEAK_OPS_PER_S[d] for d, n in parts.items()) * 1e3
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms, "key": key,
        "paths": PATCH_PATHS if paths is None else paths,
        **(extra or {}),
    }
    log(f"  {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e}, tol "
        f"{tol:.3e}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
        f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})"
        + "".join(f"; {k} {v}" for k, v in (extra or {}).items()))
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version")
    results.append(entry)


def product_library_ms(rows: int, k: int, c: int, dt, device) -> float:
    """The head's product alone as one cuBLAS call, [rows x k] @ [k x c] in
    ``dt`` (f32 without TF32), on random operands of those shapes: a
    yardstick for B4 / B6 / B9a; the port never calls it."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    a = torch.randn((rows, k), generator=gen, device=device).to(dt)
    w = torch.randn((k, c), generator=gen, device=device).to(dt)
    ms = time_ms(lambda: a @ w, reps=10)
    del a, w
    return ms


# the head's launches by kernel name: row norm (B4, B9a), product, softmax
HEAD_PARTS = {"row_norm": ("rnorm_kernel", "rnorm_lin_tc_kernel"),
              "product": ("gemm_tc_kernel", "gemm_kernel"),
              "softmax": ("softmax_kernel", "softmax_rows_kernel")}


def head_split(fn, calls: int = 3) -> dict:
    """Device ms per call of each of the head's launches (HEAD_PARTS) and
    of the wrapper's other kernels (``other``: the padded weight copies),
    from the kernel events of a torch.profiler trace of ``calls`` calls;
    "not measured" where the trace holds no device time. A call launches
    each part once, so a part's ms is the mean of the events the trace
    caught (the profiler drops one now and then: a sum over ``calls``
    would read a dropped launch as a faster one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {part: 0.0 for part in (*HEAD_PARTS, "other")}
    seen = dict.fromkeys(us, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        part = next((p for p, names in HEAD_PARTS.items()
                     if any(n in e.name for n in names)), "other")
        us[part] += e.time_range.elapsed_us()
        seen[part] += 1
    if not any(us.values()):
        return {part: "not measured" for part in us}
    return {part: v / (seen[part] if part in HEAD_PARTS and seen[part]
                       else calls) / 1e3 for part, v in us.items()}


def kernel_phase(seen: dict, gin_seen: dict, graph) -> list[dict]:
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    t = bsr.TILE
    results = []
    rows_real = int(seen["B4"][0][5].sum().item())

    def record(*args, **kwargs):
        record_kernel(results, *args, **kwargs)

    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        isz = torch.empty((), dtype=dt).element_size()
        tag = "f32" if dt == torch.float32 else "bf16"
        # ---- B1, for A (weighted) and for B_off^T (binary) ----
        blocks = []
        for which, (nbr, w, blk_cols, blk_mask, _) in zip(("A", "A^T"), seen["B1"]):
            b, n, k = nbr.shape
            r, m = blk_cols.shape[1:]
            args = (nbr, w, blk_cols, blk_mask, dt)
            out = bsr.bsr_build_blocks(*args)
            ref = bsr.bsr_build_blocks_plain(*args)
            record(
                f"B1 bsr_build_blocks {which} {tag} B={b} N={n} K={k} M={m}",
                "B1", dt_name, out, ref,
                lambda args=args: bsr.bsr_build_blocks(*args),
                lambda args=args: bsr.bsr_build_blocks_plain(*args),
                bytes_=b * n * k * 8 + b * r * m * 8 + b * r * m * t * t * isz,
                # the function scatters K weights per row: one add each
                ops=b * n * k, ops_dt="float32",
                library=lambda nbr=nbr, w=w: _bsr_build_library_call(
                    nbr, w, dt),
                source="cgcnet_tpu_torch/csrc/bsr_build.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:275",
            )
            blocks.append((which, out, blk_cols, blk_mask))
        # ---- B2, at every width a training step gives it, on the forward
        # blocks (the first 4 calls) and the transpose blocks (the rest) ----
        done = set()
        for i, (_, _, x_, slots) in enumerate(seen["B2"]):
            which, vals, blk_cols, blk_mask = blocks[
                0 if i < SERVE_PER_BATCH["B2"] else 1]
            if (which, x_.shape[-1]) in done:
                continue
            done.add((which, x_.shape[-1]))
            if not torch.equal(slots, bsr.live_slot_counts(blk_mask)):
                raise SystemExit(f"B2 {which}: the model's live slot counts "
                                 "are not its blocks'")
            b, r, m = blk_cols.shape
            nnzb = int(blk_mask.sum().item())
            walked = int(slots.sum().item())
            x = x_.to(dt)
            nc, f = x.shape[1], x.shape[2]
            out = bsr.bsr_matmul(vals, blk_cols, x, slots)
            ref = bsr.bsr_matmul_plain(vals, blk_cols, x, slots)
            record(
                f"B2 bsr_matmul {which} {tag} B={b} N={nc} M={m} live "
                f"slots {walked} of {b * r * m} F={f}", "B2",
                dt_name, out, ref,
                lambda x=x, v=vals, c=blk_cols, s_=slots:
                    bsr.bsr_matmul(v, c, x, s_),
                lambda x=x, v=vals, c=blk_cols: bsr.bsr_matmul_plain(v, c, x),
                bytes_=nnzb * t * t * isz + b * r * m * 4
                + b * nc * f * isz + b * r * t * f * isz,
                ops=2 * nnzb * t * t * f,
                library=lambda x=x, v=vals, c=blk_cols, bm=blk_mask:
                    _bsr_library_call(v, c, bm, x),
                source="cgcnet_tpu_torch/csrc/bsr_matmul.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:400",
            )
        # ---- B3 ----
        p, n_nodes = seen["B3"][0]
        p = p.to(dt)
        b, n, c = p.shape
        out = torch.stack(ah.l2relu_stats(p, n_nodes))
        ref = torch.stack(ah.l2relu_stats_plain(p, n_nodes))
        record(
            f"B3 l2relu_stats {tag} B={b} N={n} C={c}", "B3", dt_name, out, ref,
            lambda p=p: ah.l2relu_stats(p, n_nodes),
            lambda p=p: ah.l2relu_stats_plain(p, n_nodes),
            # rows past n_nodes are skipped: only real rows are read
            bytes_=rows_real * c * isz + b * 4 + 2 * c * 4,
            ops=6 * rows_real * c, ops_dt="float32",
            source="cgcnet_tpu_torch/csrc/assign_tail.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:180",
        )
        # ---- B4 ----
        x12, p, k12, k3f, const, n_nodes = seen["B4"][0]
        hargs = (x12.to(dt), p.to(dt), k12, k3f, const, n_nodes)
        c, f12 = p.shape[-1], x12.shape[-1]
        out, out_t = ah.assign_head_softmax_pre(*hargs)
        if not (out_t.data_ptr() == out.data_ptr() and out_t.shape == (b, c, n)):
            raise SystemExit("B4: S^T is not a transposed view of S")
        ref, _ = ah.assign_head_softmax_pre_plain(*hargs)
        record(
            f"B4 assign_head_softmax_pre {tag} B={b} N={n} F12={f12} C={c}",
            "B4", dt_name, out, ref,
            lambda: ah.assign_head_softmax_pre(*hargs),
            lambda: ah.assign_head_softmax_pre_plain(*hargs),
            bytes_=rows_real * (f12 + c) * isz + (f12 + c) * c * isz + c * 4
            + b * n * c * isz,
            ops=2 * rows_real * (f12 + c) * c,
            source="cgcnet_tpu_torch/csrc/assign_head.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:286",
            extra={"product_library_ms": product_library_ms(
                b * n, f12 + c, c, dt, p.device)},
        )
        # ---- B5 ----
        p, dh, u, w, n_nodes = seen["B5"][0]
        bargs = (p.to(dt), dh.to(dt), u, w, n_nodes)
        out = ah.assign_tail_bwd(*bargs)
        ref = ah.assign_tail_bwd_plain(*bargs)
        pad = torch.arange(n, device=p.device)[None, :] >= n_nodes.long()[:, None]
        if out[pad].any():
            raise SystemExit("B5: rows past n_nodes are not exactly 0")
        record(
            f"B5 assign_tail_bwd {tag} B={b} N={n} C={c}", "B5", dt_name,
            out, ref,
            lambda: ah.assign_tail_bwd(*bargs),
            lambda: ah.assign_tail_bwd_plain(*bargs),
            # dp is 0 on rows past n_nodes whatever p and dh hold: p and dh
            # are needed on real rows only, dp is written on every row
            bytes_=(2 * rows_real + b * n) * c * isz + 2 * c * 4 + b * 4,
            ops=10 * rows_real * c, ops_dt="float32",
            source="cgcnet_tpu_torch/csrc/assign_tail.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:423",
        )
        # ---- B6, on the inputs of one GIN training step ----
        x12, h3a, k12, k3f, const, n_nodes = gin_seen["B6"][0]
        hargs = (x12.to(dt), h3a.to(dt), k12, k3f, const, n_nodes)
        c, f12 = h3a.shape[-1], x12.shape[-1]
        out = ah.assign_head_softmax(*hargs)
        pad = torch.arange(n, device=h3a.device)[None, :] >= n_nodes.long()[:, None]
        if out[pad].any():
            raise SystemExit("B6: rows past n_nodes are not exactly 0")
        record(
            f"B6 assign_head_softmax {tag} B={b} N={n} F12={f12} C={c}", "B6",
            dt_name, out, ah.assign_head_softmax_plain(*hargs),
            lambda: ah.assign_head_softmax(*hargs),
            lambda: ah.assign_head_softmax_plain(*hargs),
            bytes_=rows_real * (f12 + c) * isz + (f12 + c) * c * isz + c * 4
            + b * n * c * isz,
            ops=2 * rows_real * (f12 + c) * c,
            source="cgcnet_tpu_torch/csrc/assign_head.cu",
            replaces="cgcnet_tpu/ops/pallas/assign_head.py:85",
            extra={"product_library_ms": product_library_ms(
                b * n, f12 + c, c, dt, h3a.device)},
        )
        # ---- B7, on the batch's binary off-diagonal ELL (the operator of
        # bsr_spmm_factored) and its transpose tables, at the B2 widths ----
        row = torch.arange(n, device=graph.nbr.device)[None, :, None]
        ells = {
            "A": (graph.nbr, graph.nbr_mask * (graph.nbr != row),
                  graph.blk_cols, graph.blk_mask),
            "A^T": (graph.nbr_t, graph.nbr_t_mask * (graph.nbr_t != row),
                    graph.blk_cols_t, graph.blk_mask_t),
        }
        done = set()
        for i, (_, _, x_, _) in enumerate(seen["B2"]):
            which = "A" if i < SERVE_PER_BATCH["B2"] else "A^T"
            if (which, x_.shape[-1]) in done:
                continue
            done.add((which, x_.shape[-1]))
            nbr, w, blk_cols, blk_mask = ells[which]
            b, _, k = nbr.shape
            r, m = blk_cols.shape[1:]
            nnz = int((w != 0).sum().item())
            x = x_.to(dt)
            f = x.shape[2]
            args = (nbr, w, blk_cols, blk_mask, x)
            out = bsr.bsr_gather_sum(*args)
            # the same operator through B1 -> B2: the same f32 block sums,
            # rounded alike, multiplied in another kernel
            via = bsr.bsr_matmul(
                bsr.bsr_build_blocks(nbr, w, blk_cols, blk_mask, dt), blk_cols,
                x, bsr.live_slot_counts(blk_mask))
            err12 = (out.float() - via.float()).abs().max().item()
            tol12 = TOL[("B7", dt_name)] * via.float().abs().max().item()
            log(f"  B7 {which} {tag} F={f} vs B1 -> B2: max_abs_err "
                f"{err12:.3e} (tol {tol12:.3e})")
            if not err12 <= tol12:
                raise SystemExit(f"B7 {which} F={f} disagrees with B1 -> B2")
            bytes_ = b * n * k * 8 + b * r * m * 8 + 2 * b * n * f * isz
            nnzb = int((blk_mask != 0).sum().item())
            record(
                f"B7 bsr_gather_sum {which} {tag} B={b} N={n} K={k} M={m} F={f}",
                "B7", dt_name, out, bsr.bsr_gather_sum_plain(*args),
                lambda args=args: bsr.bsr_gather_sum(*args),
                lambda args=args: bsr.bsr_gather_sum_plain(*args),
                # the ELL (nbr, w), the block slots, x read once, out
                # written once; no block values move through memory
                bytes_=bytes_,
                # the function is out = sum_k w * x[nbr]: one multiply-add
                # per real off-diagonal entry and column (the dense block
                # products of the blocks built on the fly are an algorithm,
                # not the function: their bound is kept beside it)
                ops=2 * nnz * f, ops_dt="float32",
                library=lambda args=args: _csr_library_call(*args),
                source="cgcnet_tpu_torch/csrc/bsr_gather.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:201 "
                         "(and :1204 bsr_gather_sum)",
                extra={"nnz": nnz, "dense_bound_ms": bound_ms(
                    bytes_, 2 * nnzb * t * t * f, "float32")},
            )
    return results


def _csr_of(nbr, w, dtype):
    """The block-diagonal ``torch.sparse_csr_tensor`` [B*N, B*N] of the
    batch's ELL (nbr, w), values in ``dtype`` (duplicate columns summed)."""
    import torch

    b, n, k = nbr.shape
    dev = nbr.device
    rows = torch.arange(b * n, device=dev).repeat_interleave(k)
    cols = (nbr.long() + torch.arange(b, device=dev).reshape(b, 1, 1) * n)
    vals = w.reshape(-1)
    keep = vals != 0
    a = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols.reshape(-1)[keep]]),
        vals[keep].to(dtype), size=(b * n, b * n)).coalesce()
    return a.to_sparse_csr()


def _csr_library_call(nbr, w, blk_cols, blk_mask, x):
    """One PyTorch call computing B7's function: a block-diagonal
    ``torch.sparse_csr_tensor`` over the batch, built once from the same ELL
    (not timed), times x. A yardstick; the port never calls it."""
    b, n, _ = nbr.shape
    a = _csr_of(nbr, w, x.dtype)
    xs = x.reshape(b * n, x.shape[-1])
    return lambda: a @ xs


def _bsr_build_library_call(nbr, w, dtype):
    """The nearest one PyTorch call to B1's function: the same adjacency as
    a block-diagonal CSR tensor (built once, not timed) converted to
    128x128 blocks, ``Tensor.to_sparse_bsr`` (its own block layout, over
    the blocks that hold an entry). A yardstick; the port never calls it."""
    a = _csr_of(nbr, w, dtype)
    return lambda: a.to_sparse_bsr((128, 128))


def _bsr_library_call(vals, blk_cols, blk_mask, x):
    """One PyTorch call computing B2's function on the same blocks: a
    block-diagonal ``torch.sparse_bsr_tensor`` (real block slots only) times
    x stacked over the batch. A yardstick; the port never calls it."""
    import torch

    b, r, m = blk_cols.shape
    nc, f = x.shape[1], x.shape[2]
    t = vals.shape[-1]
    keep = blk_mask.reshape(-1) > 0
    cols = (blk_cols + torch.arange(b, device=x.device).reshape(b, 1, 1)
            * (nc // t)).reshape(-1)[keep].to(torch.int64)
    counts = (blk_mask.reshape(b * r, m) > 0).sum(-1)
    crow = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int64)
    a = torch.sparse_bsr_tensor(
        crow, cols, vals.reshape(b * r * m, t, t)[keep],
        size=(b * r * t, b * nc),
    )
    xs = x.reshape(b * nc, f)
    return lambda: a @ xs


def make_data(tmp: Path):
    """The synthetic canonical dataset, its overrides and config."""
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset

    root = tmp / "data"
    generate_dataset(str(root), patches_per_image=2, images_per_grade=2,
                     n_nodes=DATA_NODES, seed=0)
    overrides = [f"data.root={root}", "data.num_workers=4",
                 f"data.max_num_nodes={DATA_NODES[1]}"]
    return overrides, predict.serving_config(overrides)


def serve_phase(tmp: Path, device, overrides, cfg, graph, n_patches: int,
                per_batch: dict) -> tuple[dict, float, float]:
    """cli.predict on the card with the launch counters read (``per_batch``
    launches per batch), one batch on the card against the CPU, and the
    forward latency."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.nn.model import CGCNet
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    ckpt = save_checkpoint(
        tmp / f"model_{cfg.model.gcn_name}.pt",
        CGCNet(cfg.model, torch.Generator().manual_seed(1234)).state_dict(),
        cfg, {"origin": "chip_smoke random init, seed 1234"},
    )
    state_dict = load_checkpoint(ckpt)[0]
    model = predict.build_model(cfg, state_dict, device)
    out_path = tmp / "pred.jsonl"
    zero_counts()
    t0 = time.time()
    cpu_flag = ["--cpu"] if device.type == "cpu" else []
    result = predict.main([*cpu_flag, "--ckpt", str(ckpt), "--reps", "2",
                           "--out", str(out_path), *overrides])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    n_batches = 2 * -(-n_patches // cfg.data.batch_size)
    log(f"  predict ({cfg.model.gcn_name}): {wall:.2f} s wall, {n_batches} "
        f"batches, result {result}, launches {counts}")
    if counts != expected(per_batch, n_batches):
        raise SystemExit(f"launch counts {counts} != {per_batch} x {n_batches} "
                         "batches")
    if not {"img_acc", "binary_acc", "patch_acc"} <= set(result):
        raise SystemExit(f"summary keys missing: {result}")
    recs = [json.loads(line) for line in out_path.read_text().splitlines()]
    patches = [r for r in recs if "patch" in r]
    if len(patches) != n_patches or not all(
        len(r["logits"]) == 3 and np.isfinite(r["logits"]).all() for r in patches
    ):
        raise SystemExit("predictions are missing or not finite")

    # one batch on the card and on the CPU (plain versions), same weights
    with torch.inference_mode():
        gpu_logits = model(graph).cpu().numpy()
        cpu_model = predict.build_model(cfg, state_dict, torch.device("cpu"))
        t0 = time.time()
        cpu_logits = cpu_model(graph.to("cpu")).numpy()
        cpu_s = time.time() - t0
        err = float(np.abs(gpu_logits - cpu_logits).max())
        log(f"  card vs CPU logits: max abs diff {err:.3e} (atol {LOGIT_ATOL}, "
            f"rtol {LOGIT_RTOL}); CPU forward {cpu_s:.1f} s")
        if not np.isfinite(gpu_logits).all() or not np.allclose(
            gpu_logits, cpu_logits, atol=LOGIT_ATOL, rtol=LOGIT_RTOL
        ):
            raise SystemExit(f"card logits {gpu_logits} != CPU {cpu_logits}")
        fwd_ms = time_ms(lambda: model(graph), reps=10, warmup=2)
    log(f"  forward latency per batch ({cfg.model.gcn_name}, x "
        f"{tuple(graph.x.shape)}, {cfg.model.compute_dtype}): {fwd_ms:.3f} ms "
        "(median of 10, CUDA events)")
    return counts, fwd_ms, wall


def nudged(graph, seed: int):
    """``graph`` with x moved by one f32 rounding step (relative 2^-23) with
    random signs from ``seed``."""
    import dataclasses

    import torch

    sign = torch.randint(0, 2, graph.x.shape,
                         generator=torch.Generator().manual_seed(seed))
    return dataclasses.replace(graph, x=graph.x * (
        1.0 + (2.0 * sign.to(graph.x) - 1.0) * 2.0 ** -23))


def grad_hold(cfg, device, graph, witnessed: bool) -> None:
    """One train step's loss and gradients on the card against the CPU plain
    path (same weights and batch, dropout off: CPU and CUDA generators
    differ). ``witnessed`` (GIN): the kernels against their plain versions
    on the same card at the rule, and the card against the CPU at the rule
    widened by the distance between the plain step on the card and on the
    CPU."""
    import numpy as np
    from cgcnet_tpu_torch.train.state import create_train_state

    cfg0 = cfg.apply_overrides(["model.drop_out=0.0"])
    gpu = create_train_state(cfg0, device, seed=7).model
    cpu = create_train_state(cfg0, "cpu", seed=7).model
    loss_gpu, g_gpu = grads_of(gpu, graph)
    cpu_graph = graph.to("cpu")
    t0 = time.time()
    loss_cpu, g_cpu = grads_of(cpu, cpu_graph)
    cpu_s = time.time() - t0
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in g_cpu.values())
    tol = {n: GRAD_REL * g.abs().max().item() + floor for n, g in g_cpu.items()}

    def ratios(a, b, widen=None):
        """max|a - b| per tensor over its tolerance (plus ``widen``)."""
        return {n: (a[n].cpu() - b[n].cpu()).abs().max().item()
                / (tol[n] + (widen[n] if widen else 0.0)) for n in tol}

    def worst(r):
        return max(r, key=r.get)

    card = ratios(g_gpu, g_cpu)
    w = worst(card)
    log(f"  card vs CPU train step: loss {loss_gpu:.7f} vs {loss_cpu:.7f}; "
        f"worst gradient {w} at {card[w]:.3f} of {GRAD_REL} x max|grad| + "
        f"{floor:.3e}; CPU step {cpu_s:.1f} s")
    if not np.isclose(loss_gpu, loss_cpu, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise SystemExit(f"card loss {loss_gpu} != CPU {loss_cpu}")
    if witnessed:
        with sites_replaced(all_plain):
            g_plain = grads_of(gpu, graph)[1]
        kernels = ratios(g_gpu, g_plain)
        wk = worst(kernels)
        spread = {n: r * tol[n] for n, r in ratios(g_plain, g_cpu).items()}
        card = ratios(g_gpu, g_cpu, widen=spread)
        nudge = [ratios(grads_of(cpu, nudged(cpu_graph, s))[1], g_cpu)[w]
                 for s in NUDGE_SEEDS]
        log(f"  kernels vs plain versions on the card: worst {wk} at "
            f"{kernels[wk]:.3f} of the rule; at {w}: plain card vs CPU "
            f"{spread[w] / tol[w]:.3f}, CPU vs itself with x moved by one "
            f"rounding step (seeds {NUDGE_SEEDS}) "
            f"{[round(r, 3) for r in nudge]}; card vs CPU against the rule "
            f"plus the plain card-vs-CPU distance: worst {worst(card)} at "
            f"{card[worst(card)]:.3f}")
        if not kernels[wk] <= 1.0:
            raise SystemExit(f"gradient {wk}: kernels vs plain versions on "
                             "the card out of tolerance")
        w = worst(card)
    if not card[w] <= 1.0:
        raise SystemExit(f"gradient {w} card vs CPU out of tolerance")


def train_phase(tmp: Path, device, overrides, cfg, graph, per_step: dict,
                per_batch: dict, witnessed: bool = False) -> dict:
    """Optimizer steps through train.loop with the launch counters read per
    step (``per_step``), one cli.train.main epoch (its validation batches
    at ``per_batch``), and :func:`grad_hold`."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import train as train_cli
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device)
    loader = GraphLoader(
        NucleiGraphDataset(cfg.data, "train"), cfg.data.batch_size,
        device=device, shuffle=True, num_workers=4, seed=cfg.data.seed,
        drop_last=True,
    )
    step_fn = make_train_step()
    params0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    stats0 = {n: b.clone() for n, b in state.model.named_buffers()}
    step_ms, losses, totals = [], [], expected({})
    for epoch in range(TRAIN_EPOCHS):
        for g in loader.epoch(epoch):
            if tuple(g.x.shape[:2]) != (CANONICAL["B"], CANONICAL["N"]):
                raise SystemExit(f"train batch is not canonical: {g.x.shape}")
            zero_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step_fn(state, g)
            end.record()
            end.synchronize()
            counts = read_counts()
            if counts != expected(per_step):
                raise SystemExit(
                    f"step {state.step}: launches {counts} != {per_step}")
            for k, v in counts.items():
                totals[k] += v
            step_ms.append(start.elapsed_time(end))
            losses.append(float(metrics["loss"]))
        state.scheduler.step()
    if state.step < 5 or not np.isfinite(losses).all():
        raise SystemExit(f"{state.step} steps, losses {losses}")
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p.detach(), params0[n])]
    stats_moved = [n for n, b in state.model.named_buffers()
                   if not torch.equal(b, stats0[n])]
    if len(moved) != len(params0) or len(stats_moved) != len(stats0):
        raise SystemExit(
            f"parameters changed {len(moved)}/{len(params0)}, running "
            f"statistics {len(stats_moved)}/{len(stats0)}")
    # the first step pays one-time set-up (cuBLAS handles, allocator)
    median_ms = statistics.median(step_ms[1:])
    log(f"  {state.step} train steps ({cfg.model.gcn_name}, x "
        f"{tuple(graph.x.shape)}, {cfg.model.compute_dtype}): launches per "
        f"step {per_step}, "
        f"losses {[round(v, 4) for v in losses]}, step {median_ms:.3f} ms "
        f"(median of {len(step_ms) - 1} after the first, CUDA events; all "
        f"{[round(v, 2) for v in step_ms]})")

    # cli.train: one epoch end to end, mid-epoch and end-of-epoch validation
    zero_counts()
    t0 = time.time()
    cpu_flag = ["--cpu"] if device.type == "cpu" else []
    result = train_cli.main([
        *cpu_flag, *overrides, "train.num_epochs=1", "train.log_every=2",
        "train.eval_every_batches=3", "train.test_epoch=2",
        f"train.ckpt_dir={tmp / 'runs'}",
    ])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    counts = read_counts()
    run_dir = Path(result["run_dir"])
    kinds = [json.loads(line)["kind"]
             for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    steps = loader.batches_per_epoch()
    log(f"  cli.train: {cli_s:.1f} s wall, result {result}, records {kinds}, "
        f"launches {counts}")
    # steps x per_step plus E validation batches x per_batch, E > 0
    head = "B4" if per_batch.get("B4") else "B6"
    evals = counts[head] - steps * per_step[head]
    if evals <= 0 or counts != {
        k: steps * per_step.get(k, 0) + evals * per_batch.get(k, 0)
        for k in KERNELS
    }:
        raise SystemExit(f"cli.train launches {counts} are not {steps} steps "
                         f"x {per_step} + validation batches x {per_batch}")
    if (kinds.count("train") != steps // 2 or kinds.count("epoch") != 1
            or kinds.count("val") != steps // 3 + 1):
        raise SystemExit(f"metrics.jsonl records {kinds}")
    for name in ("weight.pt", "model_best.pt"):
        if not (run_dir / name).is_file():
            raise SystemExit(f"cli.train wrote no {name}")
    if not {"img_acc", "binary_acc", "patch_acc"} <= set(result):
        raise SystemExit(f"summary keys missing: {result}")

    grad_hold(cfg, device, graph, witnessed)
    return {"counts": totals, "step_ms": median_ms, "steps": state.step,
            "cli_wall_s": cli_s}


def rest_phase(cfg, graph) -> dict:
    """Phase 7: the paths of the slice besides GIN's, each with its launch
    counts. Returns the counts of the whole phase."""
    import dataclasses

    import numpy as np
    import torch
    from cgcnet_tpu_torch.nn.model import CGCNet, cross_entropy_loss, make_stage1_adj
    from cgcnet_tpu_torch.train.loop import make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state

    device = graph.device
    totals = expected({})

    def counted(want: dict, what: str) -> None:
        counts = read_counts()
        if counts != expected(want):
            raise SystemExit(f"{what}: launches {counts} != {want}")
        for k, v in counts.items():
            totals[k] += v

    def close(got, ref, tol, what):
        err = (got.float() - ref.float()).abs().max().item()
        lim = tol * ref.float().abs().max().item()
        log(f"  {what}: max abs diff {err:.3e} (tol {lim:.3e})")
        if not err <= lim:
            raise SystemExit(f"{what}: out of tolerance")

    # EllAdjFactored without block values: B7 forward and on the transpose
    # tables backward, against the factored gather branch
    adj = make_stage1_adj(graph, cfg.model, torch.float32)
    g = torch.randn(graph.x.shape, device=device,
                    generator=torch.Generator(device=device).manual_seed(0))

    def matvec_and_grad(a):
        x = graph.x.clone().requires_grad_(True)
        out = a.matvec(x)
        torch.sum(out * g).backward()
        return out.detach(), x.grad

    zero_counts()
    fly = matvec_and_grad(dataclasses.replace(adj, vals=None, vals_t=None))
    counted({"B7": 2}, "EllAdjFactored without vals, forward + backward")
    ref = matvec_and_grad(dataclasses.replace(adj, impl="gather"))
    for got, want, what in zip(fly, ref, ("A @ x", "A^T g")):
        close(got, want, TOL[("B7", "float32")], f"B7 {what} vs the gather branch")

    # SAGE: the deeper fold (B4) and fused_assign_norm=never (B6), one model
    sd = CGCNet(cfg.model, torch.Generator().manual_seed(1234)).state_dict()
    logits = {}
    for head, over, per in (
        ("B4", [], SERVE_PER_BATCH),
        ("B6", ["model.fused_assign_norm=never"], {"B1": 1, "B2": 4, "B6": 1}),
    ):
        model = CGCNet(cfg.apply_overrides(over).model)
        model.load_state_dict(sd)
        model = model.to(device).eval()
        zero_counts()
        with torch.inference_mode():
            logits[head] = model(graph)
        counted(per, f"SAGE forward through {head}")
    close(logits["B6"], logits["B4"], 1e-4,
          "SAGE logits, fused_assign_norm=never (B6) vs default (B4)")

    # GAT and SAGE+elu: one forward and one train step each, B6 once each
    # (GAT aggregates by attention: its only stage-1 matvec is A @ S)
    step_fn = make_train_step()
    for over, serve, train in (
        (["model.gcn_name=GAT"], {"B1": 1, "B2": 1, "B6": 1},
         {"B1": 2, "B2": 2, "B6": 1}),
        (["model.activation=elu"], GIN_SERVE_PER_BATCH, GIN_TRAIN_PER_STEP),
    ):
        state = create_train_state(cfg.apply_overrides(over), device, seed=5)
        zero_counts()
        with torch.inference_mode():
            out = state.model.eval()(graph)
        counted(serve, f"{over[0]} forward")
        zero_counts()
        loss = float(step_fn(state, graph)["loss"])
        counted(train, f"{over[0]} train step")
        log(f"  {over[0]}: logits finite {bool(torch.isfinite(out).all())}, "
            f"train-step loss {loss:.6f}")
        if not (torch.isfinite(out).all() and np.isfinite(loss)):
            raise SystemExit(f"{over[0]}: not finite")

    # the batch with its block metadata stripped: ELL gathers, no kernel
    bare = dataclasses.replace(graph, blk_cols=None, blk_mask=None,
                               blk_cols_t=None, blk_mask_t=None)
    model = CGCNet(cfg.model)
    model.load_state_dict(sd)
    model = model.to(device).eval()
    zero_counts()
    with torch.inference_mode():
        out = model(bare)
    close(out, logits["B4"], 1e-4, "logits without metadata vs with")
    model.train()
    loss = cross_entropy_loss(model(bare), bare.y)
    loss.backward()
    counted({}, "forward + backward of a batch without metadata")
    if not (torch.isfinite(loss) and all(
            torch.isfinite(q.grad).all() for q in model.parameters())):
        raise SystemExit("batch without metadata: loss or gradients not finite")
    log(f"  batch without metadata: train-mode loss {loss.item():.6f}, no "
        "kernel launched")
    return totals


# ---------------------------------------------------------------------------
# phases 8-10: the whole-slide path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def slide_capture(seen: dict):
    """For the duration, keep clones of the (args, kwargs) of the first call
    each kernel wrapper gets at each distinct (kernel, tensor shapes and
    other arguments) on the slide path, then call the wrapper."""
    import torch

    def clone(a):
        return a.detach().clone() if isinstance(a, torch.Tensor) else a

    def shim_for(key, wrapper, plain):
        def shim(*args, **kwargs):
            sig = (key, tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                              else a for a in args),
                   tuple(sorted(k for k, v in kwargs.items()
                                if v is not None)))
            if sig not in seen:
                seen[sig] = ([clone(a) for a in args],
                             {k: clone(v) for k, v in kwargs.items()})
            before = shim.launches
            out = wrapper(*args, **kwargs)
            # a wrapper counts through its module's global name, which may
            # be this shim: hand the count on to the wrapper
            wrapper.launches += shim.launches - before
            shim.launches = before
            return out
        shim.launches = 0
        return shim

    with sites_replaced(shim_for):
        yield


def slide_grads(model, cfg, inputs, step_remat: bool):
    """(loss, {name: grad}) of one training-mode slide forward + backward
    (dropout off: no generator), the running statistics left alone."""
    import torch
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward

    model.zero_grad(set_to_none=True)
    logits = mega_forward(model, cfg.model, inputs, train=True,
                          remat_stage1=step_remat and cfg.mesh.remat_stage1,
                          remat=step_remat and cfg.mesh.remat)
    loss = -torch.log_softmax(logits, -1)[1]
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def zero_in_theory(name: str) -> bool:
    """The JK attention biases: one offset shared by every layer's score,
    which the attention softmax cancels."""
    return name.startswith("jk") and name.endswith(".att.bias")


def grads_close(what, g_ker, g_ref, rel, widen=None, zero_floor=None,
                strict=True) -> tuple[str, float]:
    """Each gradient tensor within ``rel`` of its own max|grad| plus
    GRAD_FLOOR of the model's largest gradient (GRAD_REL's rule), plus
    ``widen[name]`` where given; a ``zero_in_theory`` tensor's floor is
    ``zero_floor`` of the model's largest where given. Returns the worst
    tensor and its difference as a fraction of its tolerance; fails when
    that is above 1 or a gradient is not finite, unless not ``strict``."""
    if set(g_ker) != set(g_ref):
        raise SystemExit(f"{what}: gradients of different parameters")
    top = max(g.abs().max().item() for g in g_ref.values())
    floor = {n: (zero_floor if zero_floor and zero_in_theory(n)
                 else GRAD_FLOOR) * top for n in g_ref}
    base = {n: rel * g_ref[n].abs().max().item() + floor[n] for n in g_ref}
    tol = {n: base[n] + (widen[n] if widen else 0.0) for n in g_ref}
    diff = {n: (g_ker[n] - g_ref[n]).abs().max().item() for n in g_ref}
    ratio = {n: diff[n] / tol[n] for n in g_ref}
    w = max(ratio, key=ratio.get)
    bare = max(diff[n] / base[n] for n in g_ref)
    # tensors whose tolerance the floor sets (it outweighs the rest)
    by_floor = sorted(n for n in g_ref if floor[n] > tol[n] - floor[n])
    log(f"  {what}: worst gradient {w} at {ratio[w]:.3f} of {rel:.3g} x "
        f"max|grad| + {floor[w]:.3e}"
        + (f" + {BF16_WIDEN:g}x the plain bf16 vs f32 distance "
           f"({widen[w]:.3e} there; {bare:.3f} of the rule alone)"
           if widen else "")
        + f" ({len(ratio)} tensors; {len(by_floor)} with the tolerance set "
        "by the floor: "
        + ", ".join(f"{n} (diff {diff[n]:.3e}, floor {floor[n]:.3e})"
                    for n in by_floor[:6])
        + (", ..." if len(by_floor) > 6 else "") + ")")
    if strict and not ratio[w] <= 1.0:
        raise SystemExit(f"{what}: gradient {w} out of tolerance")
    bad = [n for n, g in g_ker.items() if not torch_isfinite(g)]
    if strict and bad:
        raise SystemExit(f"{what}: gradients not finite: {bad}")
    return w, ratio[w]


def every_kernel(key, wrapper, plain):
    """Every site its kernel."""
    return wrapper


def step_hold(model, cfg_, inputs, remat, what, kernel=every_kernel,
              plain=stats_shared) -> dict:
    """One slide step's loss and gradients, kernels (``kernel`` routes the
    sites) against the plain versions on the card (``plain`` routes the
    plain bf16 side: by default it keeps the STATS_HELD kernels, so both
    sides read the same BN statistics, which the statistics hold judges;
    the f32 side is all plain), at GRAD_REL's rule with the bf16 floor,
    widened by BF16_WIDEN x the distance between the plain bf16 step and
    the plain f32 step (two right computations of the step; the GIN
    precedent of phase 6); the bf16 floor for the zero-in-theory gradients
    only. The loss is held so. The gradients are held on the two plain
    steps replayed with the kernel step's readout routing
    (``readout_routing``): a max readout whose near-tied nodes swap on the
    last bits moves its gradient to another node, a jump no rounding rule
    can hold (on the H100 one or two of the stage-3 readout's 20 columns
    swap between right computations); the distance between the replayed
    plain bf16 and f32 steps widens the rule. The replay is bounded: on each
    replayed side a moved column's gap must be within READOUT_STEPS bf16
    steps and a readout may move at most READOUT_SHARE of its columns, so a
    kernel that moves a readout's node further than rounding does fails.
    The gradients as each side routes its own readouts are logged beside.
    Returns the loss difference, the routed and unrouted worst gradients
    as fractions of their tolerances, the worst readout gap and moved
    share, and whether the kernel step's gradients are finite;
    ``require_step`` fails on them."""
    from cgcnet_tpu_torch.ops.assign_head import STATS_HELD

    def grads(replace, c, mode=None):
        with sites_replaced(replace), (mode if mode is not None
                                       else contextlib.nullcontext()):
            return slide_grads(model, c, inputs, remat)

    cfg_32 = cfg_.apply_overrides(["model.compute_dtype=float32"])
    routing = readout_routing()
    g_ker = grads(kernel, cfg_, routing)
    g_plain, g_32 = grads(plain, cfg_), grads(all_plain, cfg_32)
    lim, loss_frac = loss_rule(g_ker[0], g_plain[0], g_32[0])
    how = (f"sharing the statistics of {', '.join(STATS_HELD)} with the "
           "kernel side" if plain is stats_shared
           else f"sites routed by {plain.__name__}")
    log(f"  {what} one step: loss {g_ker[0]:.6f} (kernels) vs "
        f"{g_plain[0]:.6f} (plain versions on the card, {how}), f32 plain "
        f"{g_32[0]:.6f}; tol {lim:.3e} ({loss_frac:.3f} of it)")
    spread = {n: BF16_WIDEN * (g_plain[1][n] - g_32[1][n]).abs().max()
              .item() for n in g_plain[1]}
    unrouted = grads_close(
        f"{what} step gradients, readouts as each side routes them (logged, "
        "not held)", g_ker[1], g_plain[1], GRAD_REL, widen=spread,
        zero_floor=BF16_FLOOR, strict=False)
    g_plain = grads(plain, cfg_, routing.replay())
    g_32 = grads(all_plain, cfg_32, routing.replay())
    steps = share = 0.0
    for side, moves in zip(("bf16", "f32"), routing.moves):
        log(f"  {what}: the plain {side} step's readouts routed as the "
            "kernel step's: " + "; ".join(
                f"readout {i}: {n} of {cols} columns moved, worst gap "
                f"{gap:.2f} bf16 steps" for i, (cols, n, gap)
                in enumerate(moves))
            + f" (limits {READOUT_STEPS:g} steps, {READOUT_SHARE:g} of the "
            "columns)")
        steps = max([steps] + [gap for _, _, gap in moves])
        share = max([share] + [n / cols for cols, n, _ in moves])
    log(f"  {what}: replayed losses {g_plain[0]:.6f} (bf16), "
        f"{g_32[0]:.6f} (f32)")
    spread = {n: BF16_WIDEN * (g_plain[1][n] - g_32[1][n]).abs().max()
              .item() for n in g_plain[1]}
    worst = grads_close(
        f"{what} step gradients, kernels vs plain versions on the card "
        "(readouts routed as the kernel step's)", g_ker[1], g_plain[1],
        GRAD_REL, widen=spread, zero_floor=BF16_FLOOR, strict=False)
    return {"loss": loss_frac, "worst": worst[0], "grad": worst[1],
            "unrouted": unrouted[1], "steps": steps, "share": share,
            "finite": all(torch_isfinite(g) for g in g_ker[1].values()),
            "g_ker": g_ker[1], "spread": spread}


def step_verdict(r: dict) -> list:
    """What fails in a ``step_hold`` result: each entry names a broken
    limit; empty when it passes."""
    bad = []
    if not r["loss"] <= 1.0:
        bad.append(f"loss at {r['loss']:.3f} of its tolerance")
    if not r["grad"] <= 1.0:
        bad.append(f"gradient {r['worst']} at {r['grad']:.3f} of its "
                   "tolerance")
    if not r["steps"] <= READOUT_STEPS:
        bad.append(f"a readout column moved {r['steps']:.2f} bf16 steps")
    if not r["share"] <= READOUT_SHARE:
        bad.append(f"a readout moved {r['share']:.3f} of its columns")
    if not r["finite"]:
        bad.append("gradients not finite")
    return bad


def require_step(r: dict, what: str) -> None:
    bad = step_verdict(r)
    if bad:
        raise SystemExit(f"{what} step hold: " + "; ".join(bad))


def torch_isfinite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def slide_model(cfg, ckpt, device):
    """A CGCNet of ``cfg`` with the checkpoint's tensors (cli.slide's
    load_partial), on ``device``."""
    from cgcnet_tpu_torch.cli.slide import load_partial
    from cgcnet_tpu_torch.nn.model import CGCNet

    model = CGCNet(cfg.model)
    copied, skipped = load_partial(model, ckpt)
    if skipped or len(copied) != len(model.state_dict()):
        raise SystemExit(f"checkpoint load: copied {len(copied)}, skipped "
                         f"{skipped}")
    return model.to(device).eval()


def logits_hold(model, cfg, inputs, what):
    """The eval forward's logits, kernels against the plain versions on the
    card (under no_grad), at the f32 rule, in bf16 widened by BF16_WIDEN x
    the plain bf16 vs f32 distance (phase 8's rule); fails outside it or
    when not finite. Returns the kernels' logits."""
    import torch
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward

    f32 = cfg.model.compute_dtype == "float32"
    cfg32 = cfg.apply_overrides(["model.compute_dtype=float32"])
    with torch.no_grad():
        logits = mega_forward(model, cfg.model, inputs)
        with sites_replaced(all_plain):
            plain_logits = mega_forward(model, cfg.model, inputs)
            plain32 = (plain_logits if f32
                       else mega_forward(model, cfg32.model, inputs))
    err = (logits - plain_logits).abs().max().item()
    spread = BF16_WIDEN * (plain_logits - plain32).abs().max().item()
    lim = LOGIT_ATOL + LOGIT_RTOL * plain_logits.abs().max().item() + spread
    log(f"  {what} logits {logits.tolist()} vs plain versions on the card "
        f"{plain_logits.tolist()}"
        + (f": max abs diff {err:.3e} (tol {lim:.3e}: the f32 rule)" if f32
           else f" (f32 plain {plain32.tolist()}): max abs diff {err:.3e} "
           f"(tol {lim:.3e}: the f32 rule plus {BF16_WIDEN:g}x the plain "
           f"bf16 vs f32 distance, {spread:.3e})"))
    if not err <= lim or not torch_isfinite(logits):
        raise SystemExit(f"{what} logits: kernels vs plain versions")
    return logits


def loss_rule(ker: float, plain: float, f32: float) -> tuple[float, float]:
    """(tolerance, |ker - plain| as a fraction of it) of a bf16 slide loss:
    the f32 rule widened by BF16_WIDEN x the plain bf16 vs f32 distance."""
    lim = LOGIT_ATOL + LOGIT_RTOL * abs(plain) + BF16_WIDEN * abs(plain - f32)
    return lim, abs(ker - plain) / lim


def slide_train_steps(cfg_, ckpt, inputs, n_steps, per_step, remat_stage1,
                      what, first=None, warm: int = 1):
    """``n_steps`` steps of ``make_slide_train_step`` on a fresh model of
    the checkpoint: each step's launches must be ``per_step``; finite
    losses, every parameter and running statistic moved. ``first`` (a
    context manager) wraps the first step. Returns (launch totals, median
    CUDA-event step ms of the steps after the first ``warm``, {"times",
    "losses"})."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.parallel.mega_train import (
        make_optimizer,
        make_slide_train_step,
    )

    device = inputs.device
    m = slide_model(cfg_, ckpt, device).train()
    params0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    stats0 = {n: b.clone() for n, b in m.named_buffers()}
    step = make_slide_train_step(m, cfg_.model, make_optimizer(m, 1e-3),
                                 remat_stage1=remat_stage1)
    totals, times, losses = expected({}), [], []
    for i in range(n_steps):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        zero_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        ctx = first if (i == 0 and first is not None) \
            else contextlib.nullcontext()
        with ctx:
            start.record()
            loss = step(inputs, 1, gen)
            end.record()
            end.synchronize()
        counts = read_counts()
        if counts != expected(per_step):
            raise SystemExit(f"{what} step {i}: launches {counts} != "
                             f"{per_step}")
        for k, v in counts.items():
            totals[k] += v
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    moved = [n for n, p in m.named_parameters()
             if not torch.equal(p.detach(), params0[n])]
    stats_moved = [n for n, b in m.named_buffers()
                   if not torch.equal(b, stats0[n])]
    if (not np.isfinite(losses).all() or len(moved) != len(params0)
            or len(stats_moved) != len(stats0)):
        raise SystemExit(
            f"{what}: losses {losses}, parameters changed "
            f"{len(moved)}/{len(params0)}, running statistics "
            f"{len(stats_moved)}/{len(stats0)}")
    med = statistics.median(times[warm:])
    log(f"  {n_steps} {what} steps: launches per step {per_step}, losses "
        f"{[round(v, 4) for v in losses]}, step {med:.3f} ms (median of "
        f"{n_steps - warm}"
        + {0: "", 1: " after the first"}.get(warm, f" after the first {warm}")
        + ", CUDA events; all "
        f"{[round(v, 2) for v in times]}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return totals, med, {"times": times, "losses": losses}


def slide_phases(tmp: Path, device, ckpt: Path, seen: dict) -> dict:
    """Phases 8-10 (see the module docstring); captures the slide kernels'
    inputs into ``seen``. Returns the launch counts per path and the
    numbers of the slide path."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import slide as slide_cli
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.ops.assign_head import chunk_plan, pick_chunk
    from cgcnet_tpu_torch.parallel.mega_graph import build_bsr_tables
    from cgcnet_tpu_torch.parallel.mega_model import (
        mega_forward,
        prepare_mega_inputs,
    )
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    out: dict = {}
    base = ["--synthetic", "--nuclei", str(SLIDE_NUCLEI), "--shards", "1",
            *(["--cpu"] if device.type == "cpu" else [])]

    # ---- phase 8: serving ----
    log("phase 8: slide serving (cli.slide, 100k nuclei, bf16, --slides 3)")
    zero_counts()
    t0 = time.time()
    res = slide_cli.main([*base, "--ckpt", str(ckpt), "--slides",
                          str(SLIDE_STREAM), *SLIDE_DTYPE])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    builds, forwards = 1 + SLIDE_STREAM, 2 + SLIDE_STREAM
    want = {k: SLIDE_BUILD.get(k, 0) * builds
            + SLIDE_FORWARD.get(k, 0) * forwards for k in KERNELS}
    log(f"  cli.slide: {wall:.1f} s wall; graph {res['t_graph_s'] * 1e3:.1f} "
        f"ms, partition {res['t_part_s'] * 1e3:.1f} ms, forward "
        f"{res['t_fwd_s'] * 1e3:.1f} ms (host clock); logits "
        f"{res['logits'].tolist()}, grade {res['pred'] + 1}; stream "
        f"{res['slides_per_s']:.3f} slides/s, preds {res['stream_preds']}, "
        f"table shape sets {res['shape_sets']}; launches {counts} "
        f"({builds} builds x {SLIDE_BUILD} + {forwards} forwards x "
        f"{SLIDE_FORWARD})")
    if counts != want:
        raise SystemExit(f"cli.slide launches {counts} != {want}")
    if (not res["bsr"] or res["cap"] != SLIDE_CAP or res["shape_sets"] != 1
            or not np.isfinite(res["logits"]).all()
            or res["logits"].shape != (3,)):
        raise SystemExit(f"cli.slide result {res}")
    out.update(slide_forward_host_ms=res["t_fwd_s"] * 1e3,
               slide_graph_ms=res["t_graph_s"] * 1e3,
               slide_partition_ms=res["t_part_s"] * 1e3,
               slides_per_s=res["slides_per_s"], slide_cli_wall_s=wall,
               slide_logits=res["logits"].tolist())
    paths = {"slide_serve": counts}

    cfg = Config().apply_overrides(SLIDE_DTYPE)
    feats, coords = synthetic_slide(SLIDE_NUCLEI)
    with slide_capture(seen):
        build = build_slide_inputs(cfg, feats, coords, 1, device)
    inputs = build.inputs
    model = slide_model(cfg, ckpt, device)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: mega_forward(model, cfg.model, inputs),
                         reps=5, warmup=1)
    log(f"  forward {fwd_ms:.3f} ms (median of 5, CUDA events)")
    with slide_capture(seen):
        logits = logits_hold(model, cfg, inputs, "slide")
    log(f"  same grade as cli.slide: {int(logits.argmax()) == res['pred']}")
    if int(logits.argmax()) != res["pred"]:
        raise SystemExit("slide logits: kernels vs plain versions")
    out["slide_forward_ms"] = fwd_ms

    # ---- phase 9: training ----
    log("phase 9: slide training (100k nuclei, bf16, no chunking)")
    require_step(step_hold(model, cfg, inputs, False, "slide"), "slide")

    torch.cuda.reset_peak_memory_stats()
    paths["slide_train"], out["slide_step_ms"], _ = slide_train_steps(
        cfg, ckpt, inputs, SLIDE_TRAIN_STEPS, SLIDE_TRAIN_PER_STEP, False,
        "slide train", slide_capture(seen))
    out["slide_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # cli.slide --train-epochs 2 --out, then the written file served again
    zero_counts()
    t0 = time.time()
    ft = tmp / "slide_finetuned.pt"
    res_ft = slide_cli.main([*base, "--ckpt", str(ckpt), "--train-epochs",
                             "2", "--out", str(ft), *SLIDE_DTYPE])
    res_back = slide_cli.main([*base, "--ckpt", str(ft), *SLIDE_DTYPE])
    torch.cuda.synchronize()
    counts = read_counts()
    for k, v in counts.items():
        paths["slide_train"][k] += v
    log(f"  cli.slide --train-epochs 2 --out: losses {res_ft['losses']}, "
        f"fine-tuned logits {res_ft['logits_finetuned'].tolist()}; served "
        f"from the written file {res_back['logits'].tolist()}; "
        f"{time.time() - t0:.1f} s wall, launches {counts}")
    if not (np.isfinite(res_ft["losses"]).all()
            and np.array_equal(res_ft["logits_finetuned"], res_back["logits"])):
        raise SystemExit("cli.slide fine-tune round trip")

    # ---- phase 10: the capacity path ----
    log("phase 10: capacity path (assign_tail_chunk=65536, remat_stage1)")
    cap_cfg = cfg.apply_overrides(SLIDE_CAPACITY)
    ch = pick_chunk(build.cap, cap_cfg.model.assign_tail_chunk)
    plan = chunk_plan(build.cap, ch)
    log(f"  chunk plan over {build.cap} rows: {plan}")
    if plan != (CAP_CHUNK, SLIDE_CAP // CAP_CHUNK, SLIDE_CAP % CAP_CHUNK) \
            or plan[1] != 1 or not plan[2]:
        raise SystemExit(f"chunk plan {plan}: not one full chunk and a "
                         "remainder")
    require_step(step_hold(model, cap_cfg, inputs, True, "capacity"),
                 "capacity")
    torch.cuda.reset_peak_memory_stats()
    paths["slide_capacity"], out["capacity_step_ms"], _ = slide_train_steps(
        cap_cfg, ckpt, inputs, SLIDE_CAP_STEPS, SLIDE_CAP_PER_STEP, True,
        "capacity", slide_capture(seen))
    out["capacity_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, inputs, build
    torch.cuda.empty_cache()

    # ---- card against CPU: a small f32 slide, tables built by hand ----
    log("  card vs CPU: f32 slide of 8192 nuclei, the same tables on both")
    cfg32 = Config()
    f, c = synthetic_slide(SMALL_SLIDE_NUCLEI, seed=7)
    b = build_slide_inputs(cfg32, f, c, 1, device)
    tables = build_bsr_tables(b.part)
    cpu_in = prepare_mega_inputs(b.inputs.x.cpu().numpy(), b.part, "cpu",
                                 n_real=b.n, bsr=tables)
    m_gpu = slide_model(cfg32, ckpt, device)
    m_cpu = slide_model(cfg32, ckpt, "cpu")
    zero_counts()
    with torch.no_grad():
        lg = mega_forward(m_gpu, cfg32.model, b.inputs).cpu().numpy()
        lc = mega_forward(m_cpu, cfg32.model, cpu_in).numpy()
    loss_g, grads_g = slide_grads(m_gpu, cfg32, b.inputs, False)
    loss_c, grads_c = slide_grads(m_cpu, cfg32, cpu_in, False)
    counts = read_counts()
    log(f"  logits card {lg.tolist()} vs CPU {lc.tolist()} (atol "
        f"{LOGIT_ATOL}, rtol {LOGIT_RTOL}); loss {loss_g:.7f} vs "
        f"{loss_c:.7f}; card launches {counts}")
    if not (np.allclose(lg, lc, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
            and np.isclose(loss_g, loss_c, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)):
        raise SystemExit("small slide: card vs CPU")
    if counts["B8"] or not counts["B2"] or not counts["B4"]:
        raise SystemExit(f"small f32 slide: launches {counts}")
    grads_close("small slide step gradients, card vs CPU (GRAD_REL rule)",
                {n: g.cpu() for n, g in grads_g.items()}, grads_c, GRAD_REL)
    out["paths"] = paths
    return out


def stats_hold(p3, n3, lin9, n9) -> dict:
    """B3 (on ``p3``; None: B9b alone) and B9b (on ``lin9`` = (x3, kc3, b3))
    against the exact statistics, beside the plain versions' f32 sums and
    the two witnesses; fails unless the kernels and witness (i) are within
    ``ah.STATS_TOL`` and witness (ii) is not. Returns the distances."""
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah

    x3, kc3, b3 = lin9
    tol = ah.STATS_TOL
    cases = {
        "B3": None if p3 is None else (ah.l2relu_stats_reference(p3, n3), {
            "kernel": lambda: ah.l2relu_stats(p3, n3),
            "plain": lambda: ah.l2relu_stats_plain(p3, n3),
            "witness (i): row norm as two half-row sums": lambda:
                ah.l2relu_stats_reference(p3, n3,
                                          rnorm=ah.rnorm_two_halves(p3)),
            "witness (ii): h summed without its rounding": lambda:
                ah.l2relu_stats_reference(p3, n3, round_h=False),
        }),
        "B9b": (ah.l2relu_stats_lin_reference(x3, kc3, b3, n9), {
            "kernel": lambda: ah.l2relu_stats_lin(x3, kc3, b3, n9),
            "plain": lambda: ah.l2relu_stats_lin_plain(x3, kc3, b3, n9),
            "witness (i): the dot summed in reverse order": lambda:
                ah.l2relu_stats_reference(ah.lin_p_reversed(x3, kc3, b3),
                                          n9),
            "witness (ii): p rounded once": lambda:
                ah.l2relu_stats_reference(
                    ah.lin_p_rounded_once(x3, kc3, b3), n9),
        }),
    }
    out = {}
    for key, case in cases.items():
        if case is None:
            continue
        ref, runs = case
        dist = {}
        for what, fn in runs.items():
            dist[what] = ah.stats_distance(fn(), ref)
            torch.cuda.empty_cache()
        kern, w1, w2 = (dist[k] for k in dist if k != "plain")
        ok = kern <= tol and w1 <= tol and w2 > tol
        log(f"  statistics hold {key} (bf16, {x3.shape[1]} rows): max over "
            f"columns of |stat - exact| / |exact|, tol {tol:.3e}: "
            + "; ".join(f"{k} {v:.3e}" for k, v in dist.items())
            + f" -> {'ok' if ok else 'FAIL'}")
        if not (w1 <= tol and w2 > tol):
            raise SystemExit(f"statistics hold {key}: the tolerance does not "
                             "separate the witnesses")
        if not kern <= tol:
            raise SystemExit(f"statistics hold {key}: the kernel's "
                             "statistics are off the exact ones")
        out[key] = dist
    return out


def _dtype_tag(dt) -> tuple:
    """(TOL's name of ``dt``, its short tag, its bytes an element)."""
    import torch

    return (str(dt).replace("torch.", ""),
            "f32" if dt == torch.float32 else "bf16",
            torch.empty((), dtype=dt).element_size())


def record_b5(record, args, dt, what: str) -> None:
    """B5 on a captured call's ``args`` cast to ``dt``, through ``record``
    (``record_kernel`` with its results list bound); rows past n_nodes
    must come out exactly 0."""
    from cgcnet_tpu_torch.ops import assign_head as ah

    dt_name, tag, isz = _dtype_tag(dt)
    p, dh, u, w, nn5 = args
    a5 = (p.to(dt), dh.to(dt), u, w, nn5)
    b, n, c = p.shape
    rr = int(nn5.sum().item())
    out = ah.assign_tail_bwd(*a5)
    if out[:, rr:].any():
        raise SystemExit("B5: rows past n_nodes are not exactly 0")
    record(
        f"B5 assign_tail_bwd {what} {tag} N={n} C={c}", "B5", dt_name,
        out, ah.assign_tail_bwd_plain(*a5),
        lambda: ah.assign_tail_bwd(*a5),
        lambda: ah.assign_tail_bwd_plain(*a5),
        bytes_=(2 * rr + b * n) * c * isz + 2 * c * 4 + b * 4,
        ops=10 * rr * c, ops_dt="float32",
        source="cgcnet_tpu_torch/csrc/assign_tail.cu",
        replaces="cgcnet_tpu/ops/pallas/assign_head.py:423",
    )


def record_b9a(record, args, dt, what: str, split: bool = False) -> None:
    """B9a on a captured call's ``args`` (x12 and x3 cast to ``dt``)
    through ``record``, with its product alone in cuBLAS and, with
    ``split``, the device ms of each of its launches."""
    from cgcnet_tpu_torch.ops import assign_head as ah

    dt_name, tag, isz = _dtype_tag(dt)
    x12, x3, kc3, b3, k12, k3f, const, n_nodes = args
    n, f3, c = x3.shape[1], x3.shape[2], kc3.shape[1]
    f12 = x12.shape[-1]
    rows_real = int(n_nodes.sum().item())
    a9 = (x12.to(dt), x3.to(dt), kc3, b3, k12, k3f, const, n_nodes)
    extra = {"product_library_ms": product_library_ms(
        n, f12 + c, c, dt, x3.device)}
    if split:
        extra["split_ms"] = head_split(
            lambda: ah.assign_head_softmax_pre_lin(*a9))
    record(
        f"B9a assign_head_softmax_pre_lin {what}{tag} N={n} F12={f12} "
        f"F3={f3} C={c}", "B9a", dt_name,
        ah.assign_head_softmax_pre_lin(*a9),
        ah.assign_head_softmax_pre_lin_plain(*a9),
        lambda: ah.assign_head_softmax_pre_lin(*a9),
        lambda: ah.assign_head_softmax_pre_lin_plain(*a9),
        bytes_=rows_real * (f12 + f3) * isz
        + (f3 + 1 + f12 + c) * c * isz + c * 4 + n * c * isz,
        ops=2 * rows_real * c * (f3 + f12 + c),
        source="cgcnet_tpu_torch/csrc/assign_head.cu",
        replaces="cgcnet_tpu/ops/pallas/assign_head.py:882",
        extra=extra,
    )


def record_b9b(record, args, dt, what: str) -> None:
    """B9b on a captured call's ``args`` (x3 cast to ``dt``) through
    ``record``."""
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah

    dt_name, tag, isz = _dtype_tag(dt)
    x3, kc3, b3, n_nodes = args
    n, f3, c = x3.shape[1], x3.shape[2], kc3.shape[1]
    rows_real = int(n_nodes.sum().item())
    a9b = (x3.to(dt), kc3, b3, n_nodes)
    record(
        f"B9b l2relu_stats_lin {what}{tag} N={n} F3={f3} C={c}", "B9b",
        dt_name, torch.stack(ah.l2relu_stats_lin(*a9b)),
        torch.stack(ah.l2relu_stats_lin_plain(*a9b)),
        lambda: ah.l2relu_stats_lin(*a9b),
        lambda: ah.l2relu_stats_lin_plain(*a9b),
        bytes_=rows_real * f3 * isz + (f3 + 1) * c * isz + 2 * c * 4,
        # p formed per element (the F3-term dot, on the tensor cores in
        # bf16), then the row norm and the sums (6 operations an element)
        # on the f32 CUDA cores
        ops={dt_name: 2 * rows_real * c * f3, "float32": 6 * rows_real * c},
        source="cgcnet_tpu_torch/csrc/assign_tail.cu",
        replaces="cgcnet_tpu/ops/pallas/assign_head.py:943",
    )


def slide_kernel_phase(seen: dict, device) -> tuple[list[dict], dict]:
    """B8, B9a, B9b, B3, B4 (with ``c_out``), B5 and the int8 B1/B2 legs
    against their plain versions on the card, in f32 and bf16, on the inputs
    captured from phases 8-10 (one per distinct call shape), timed like
    phase 3."""
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah
    from cgcnet_tpu_torch.ops import bsr

    t = bsr.TILE
    results = []

    def record(*args, **kwargs):
        # the slide's plain versions take 15-17 ms at 100k: fewer repeats
        kwargs.setdefault("paths", SLIDE_PATHS)
        record_kernel(results, *args, reps=10, plain_reps=3, **kwargs)

    def calls(key):
        return [v for (k, _, _), v in seen.items() if k == key]

    # ---- the statistics hold: B3 and B9b on the slide's own inputs ----
    (p3, n3), _ = calls("B3")[0]
    (x3h, kc3h, b3h, n9h), _ = calls("B9b")[0]
    if p3.dtype != torch.bfloat16 or x3h.dtype != torch.bfloat16:
        raise SystemExit("statistics hold: the slide's inputs are not bf16")
    stats = stats_hold(p3, n3, (x3h, kc3h, b3h), n9h)

    b8_calls = calls("B8")
    names = []
    for args, kw in b8_calls:
        x = args[3]
        if kw.get("acc") is not None:
            names.append(f"A^T g + acc (split outputs) F={x.shape[-1]}")
        elif kw.get("halo") is not None:
            names.append(f"A@S F={x.shape[-1]}")
        else:
            names.append(f"A^T g F={x.shape[-1]}")
    log(f"  captured B8 calls: {names}")
    if not any("acc" in n for n in names) or len(b8_calls) < 3:
        raise SystemExit(f"B8 calls captured: {names}")

    gen = torch.Generator(device=device).manual_seed(11)
    b8_cases = [(n, a, k) for n, (a, k) in zip(names, b8_calls)]
    b8_cases.append(halo_window_case(device, gen))
    # the epilogue option, on the training A@S leg's inputs
    base_args, base_kw = next((a, k) for n, (a, k) in zip(names, b8_calls)
                              if n.startswith("A@S F=1152"))
    r_rows = base_args[1].shape[1] * t
    sw = torch.zeros((1, r_rows, 128), device=device)
    sw[0, :, 0] = torch.rand(r_rows, generator=gen, device=device)
    sw[0, :, 1] = 0.4
    b8_cases.append(("A@S + epilogue_sw F=1152", base_args,
                     {**base_kw, "epilogue_sw": sw}))

    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        isz = torch.empty((), dtype=dt).element_size()
        tag = "f32" if dt == torch.float32 else "bf16"
        # ---- B8 ----
        for name, args, kw in b8_cases:
            vals, blk_cols, win, x = args
            x = x.to(dt)
            kw = {k: (v.to(dt) if k in ("halo", "acc", "epilogue_sw")
                      and v is not None else v) for k, v in kw.items()}
            a = (vals, blk_cols, win, x)
            out = bsr.bsr_matmul_banded(*a, **kw)
            ref = bsr.bsr_matmul_banded_plain(*a, **kw)
            _, r, m = blk_cols.shape
            work = banded_work(vals, blk_cols, x, kw)
            record(
                f"B8 bsr_matmul_banded {name} {tag} R={r} M={m}", "B8",
                dt_name, out, ref,
                lambda a=a, kw=kw: bsr.bsr_matmul_banded(*a, **kw),
                lambda a=a, kw=kw: bsr.bsr_matmul_banded_plain(*a, **kw),
                # the function's work: 2 F per nonzero entry of the live
                # blocks (``banded_work``); the dense block product's bound
                # is kept beside it
                bytes_=work["bytes"], ops=work["ops"],
                library=lambda a=a, kw=kw, live=work["live"]:
                    _banded_library_call(*a, kw.get("halo"), live),
                source="cgcnet_tpu_torch/csrc/bsr_banded.cu",
                replaces=("cgcnet_tpu/ops/pallas/bsr_kernel.py:966 (:1097 "
                          "_banded_halo_kernel)" if "halo windows" in name
                          else "cgcnet_tpu/ops/pallas/bsr_kernel.py:966 "
                          "(:1181 _banded_kernel)"),
                # the halo-window kernel (:1097) runs at more than one
                # shard: phase 11's ranks launch it
                paths=(("slide_shards_halo",) if "halo windows" in name
                       else SLIDE_PATHS),
                extra={"nnz": work["nnz"], "dense_bound_ms": bound_ms(
                    work["bytes"], work["dense_ops"], dt_name)},
            )
        # ---- B3, B4 (serving, and training's lane-padded c_out) and B5
        # (the training call and the capacity path's chunks) at the slide's
        # shapes ----
        for (p, nn3), _ in calls("B3"):
            p = p.to(dt)
            b, n, c = p.shape
            rr = int(nn3.sum().item())
            record(
                f"B3 l2relu_stats slide {tag} N={n} C={c}", "B3", dt_name,
                torch.stack(ah.l2relu_stats(p, nn3)),
                torch.stack(ah.l2relu_stats_plain(p, nn3)),
                lambda p=p, nn3=nn3: ah.l2relu_stats(p, nn3),
                lambda p=p, nn3=nn3: ah.l2relu_stats_plain(p, nn3),
                bytes_=rr * c * isz + b * 4 + 2 * c * 4,
                ops=6 * rr * c, ops_dt="float32",
                source="cgcnet_tpu_torch/csrc/assign_tail.cu",
                replaces="cgcnet_tpu/ops/pallas/assign_head.py:180",
            )
        for i4, (args, _) in enumerate(calls("B4")):
            x12, p, k12, k3f, const, nn4 = args[:6]
            c_out = args[6] if len(args) > 6 else None
            h4 = (x12.to(dt), p.to(dt), k12, k3f, const, nn4, c_out)
            b, n, c = p.shape
            f12 = x12.shape[-1]
            co = c_out or c
            rr = int(nn4.sum().item())
            out, _ = ah.assign_head_softmax_pre(*h4)
            if out.shape[-1] != co or out[..., c:].any():
                raise SystemExit(f"B4 c_out={c_out}: pad columns are not "
                                 "exact zeros")
            extra = {"product_library_ms": product_library_ms(
                b * n, f12 + c, c, dt, device)}
            if i4 == 0:  # the split of one call (the first: serving)
                extra["split_ms"] = head_split(
                    lambda h4=h4: ah.assign_head_softmax_pre(*h4))
            record(
                f"B4 assign_head_softmax_pre slide {tag} N={n} F12={f12} "
                f"C={c} c_out={co}", "B4", dt_name, out,
                ah.assign_head_softmax_pre_plain(*h4)[0],
                lambda h4=h4: ah.assign_head_softmax_pre(*h4),
                lambda h4=h4: ah.assign_head_softmax_pre_plain(*h4),
                bytes_=rr * (f12 + c) * isz + (f12 + c) * c * isz + c * 4
                + b * n * co * isz,
                ops=2 * rr * (f12 + c) * c,
                source="cgcnet_tpu_torch/csrc/assign_head.cu",
                replaces="cgcnet_tpu/ops/pallas/assign_head.py:286",
                extra=extra,
            )
        for args, _ in calls("B5"):
            record_b5(record, args, dt, "slide")
        # ---- B9a, B9b: the capacity forward's full-slide calls ----
        a9 = max(calls("B9a"), key=lambda v: v[0][1].shape[1])[0]
        record_b9a(record, a9, dt, "", split=True)
        record_b9b(record, calls("B9b")[0][0], dt, "")
        # ---- int8 B1: the forward and transpose blocks of the slide ----
        for (nbr_, w_, bc_, bm_, _dt), _ in calls("B1"):
            bb, nn_, k = nbr_.shape
            r, m = bc_.shape[1:]
            a1 = (nbr_, w_, bc_, bm_, torch.int8)
            which = "A" if nn_ == SLIDE_CAP else "A^T"
            record(
                f"B1 bsr_build_blocks int8 {which} (x {tag} slide) N={nn_} "
                f"K={k} M={m}", "B1", dt_name,
                bsr.bsr_build_blocks(*a1), bsr.bsr_build_blocks_plain(*a1),
                lambda a1=a1: bsr.bsr_build_blocks(*a1),
                lambda a1=a1: bsr.bsr_build_blocks_plain(*a1),
                bytes_=nn_ * k * 8 + r * m * 8 + r * m * t * t,
                ops=nn_ * k, ops_dt="float32",
                source="cgcnet_tpu_torch/csrc/bsr_build.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:275",
            )
        # ---- int8 B2: every width and direction of the slide's legs ----
        for (vals, bc_, x_, slots), _ in calls("B2"):
            x = x_.to(dt)
            _, r, m = bc_.shape
            nc, f = x.shape[1], x.shape[2]
            live = vals.reshape(*vals.shape[:3], -1).ne(0).any(-1)
            nnzb = int(live.sum().item())
            walked = int(slots.sum().item())
            which = "A" if r * t == SLIDE_CAP else "A^T"
            record(
                f"B2 bsr_matmul int8 {which} {tag} N={nc} M={m} live slots "
                f"{walked} of {r * m} F={f}", "B2",
                dt_name, bsr.bsr_matmul(vals, bc_, x, slots),
                bsr.bsr_matmul_plain(vals, bc_, x, slots),
                lambda x=x, v=vals, c_=bc_, s_=slots:
                    bsr.bsr_matmul(v, c_, x, s_),
                lambda x=x, v=vals, c_=bc_: bsr.bsr_matmul_plain(v, c_, x),
                bytes_=nnzb * t * t + r * m * 4 + nc * f * isz
                + r * t * f * isz,
                ops=2 * nnzb * t * t * f,
                library=lambda x=x, v=vals, c_=bc_, live=live:
                    _bsr_library_call(v.to(x.dtype), c_, live.float(), x),
                source="cgcnet_tpu_torch/csrc/bsr_matmul.cu",
                replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:400",
            )
    return results, stats


def halo_window_case(device, gen) -> tuple:
    """(name, args, kwargs) of B8's halo-window variant: shard 0 of the
    slide stripe-sorted for HALO_SHARDS shards (a partition whose halo
    outgrows the resident tail), its int8 blocks built by B1, x and the
    halo drawn from ``gen`` at HALO_F columns. The window contract is held
    once here, as the slide path holds it once per slide
    (mega_model.check_windows); the call then skips the per-call check."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.dataflow import native
    from cgcnet_tpu_torch.ops import bsr
    from cgcnet_tpu_torch.parallel.mega_graph import (
        build_bsr_tables,
        partition_graph,
    )
    from cgcnet_tpu_torch.parallel.slide_setup import (
        spatial_sort_order,
        synthetic_slide,
    )

    t = bsr.TILE
    cfg = Config()
    shards = HALO_SHARDS
    f0, c0 = synthetic_slide(HALO_NUCLEI)
    q = t * bsr.G_BAND * shards
    cap = -(-HALO_NUCLEI // q) * q
    order = spatial_sort_order(c0, cfg.data.max_edge_distance, stripes=shards,
                               shard_rows=cap // shards)
    nbr, mask = native.radius_knn(c0[order], cfg.data.max_edge_distance,
                                  cfg.data.max_neighbours)
    nbrp = np.tile(np.arange(cap, dtype=np.int32)[:, None], (1, nbr.shape[1]))
    maskp = np.zeros((cap, nbr.shape[1]), np.float32)
    nbrp[:len(nbr)], maskp[:len(nbr)] = nbr, mask
    part = partition_graph(nbrp, maskp, shards)
    tab = build_bsr_tables(part)
    if tab is None or tab.win_halo is None:
        raise SystemExit("the 4-shard partition built no halo-window table")
    ns = cap // shards
    nb0 = torch.as_tensor(part.nbr_remap[0], device=device)
    off0 = torch.as_tensor(part.nbr_mask[0], device=device) * (
        nb0 != torch.arange(ns, device=device)[:, None])
    bc0 = torch.as_tensor(tab.blk_cols[0], device=device)
    bm0 = torch.as_tensor(tab.blk_mask[0], device=device)
    vals0 = bsr.bsr_build_blocks(nb0[None], off0[None], bc0[None], bm0[None],
                                 torch.int8)
    f_s = HALO_F
    x_h = torch.randn((1, ns, f_s), generator=gen, device=device)
    halo_h = torch.randn((1, tab.nc - ns, f_s), generator=gen, device=device)
    log(f"  halo windows: shard 0 of {shards}, {ns} rows, halo "
        f"{tab.nc - ns} rows, M {tab.blk_cols.shape[-1]}")
    win0 = torch.as_tensor(tab.win_base[0:1], device=device)
    hwin0 = torch.as_tensor(tab.win_halo[0:1], device=device)
    bsr.check_band_windows(bc0[None], bm0[None] > 0, win0, ns,
                           (tab.nc - ns) // t, hwin0)
    return (f"A@S halo windows (shard 0 of {shards}) F={f_s}",
            [vals0, bc0[None], win0, x_h],
            {"ns_rows": ns, "halo": halo_h, "halo_win": hwin0,
             "check_windows": False, "blk_mask": bm0[None],
             "live_slots": bsr.live_slot_counts(bm0[None])})


def banded_work(vals, blk_cols, x, kw) -> dict:
    """What one B8 call must move and compute: ``bytes`` — the live block
    slots' values, their column ids, x and the halo read once, the output
    written once, acc / epilogue_sw read once; ``ops`` — 2 * F per nonzero
    entry of the live blocks (the function's multiply-adds: the blocks are
    binary and ~1% full on the slide); ``dense_ops`` — 2 * 128 * 128 * F
    per live slot (the dense block product's). Live slots from
    ``kw["blk_mask"]`` where given, else the blocks holding an entry."""
    t = vals.shape[-1]
    b, r, m = blk_cols.shape
    flat = vals.reshape(b, r, m, -1)
    bm = kw.get("blk_mask")
    live = (bm.reshape(b, r, m) > 0) if bm is not None else flat.ne(0).any(-1)
    nnzb = int(live.sum().item())
    nnz = int(flat[live].ne(0).sum().item())
    f, isz = x.shape[-1], x.element_size()
    nh = kw["halo"].shape[1] if kw.get("halo") is not None else 0
    extra = sum(kw[k].numel() * isz for k in ("acc", "epilogue_sw")
                if kw.get(k) is not None)
    return {"live": live, "nnz": nnz,
            "bytes": nnzb * t * t * vals.element_size() + b * r * m * 4
            + (x.shape[1] + nh) * f * isz + b * r * t * f * isz + extra,
            "ops": 2 * nnz * f, "dense_ops": 2 * nnzb * t * t * f}


def bound_ms(bytes_, ops, dt_name) -> float:
    """The least time the card could take: the larger of bytes at the HBM
    rate and operations at the type's peak, in ms."""
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt_name]) * 1e3


def _banded_library_call(vals, blk_cols, win, x, halo, live):
    """One PyTorch call computing B8's function: ``torch.sparse_bsr_tensor``
    over the live block slots (values converted to x's type once, not
    timed) times [x ++ halo] (concatenated once, not timed). A yardstick;
    the port never calls it."""
    import torch

    xx = x[0] if halo is None else torch.cat([x[0], halo[0]], dim=0)
    keep = live.reshape(-1)
    _, r, m = blk_cols.shape
    t = vals.shape[-1]
    counts = live.reshape(r, m).sum(-1)
    crow = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(
        torch.int64)
    a = torch.sparse_bsr_tensor(
        crow, blk_cols.reshape(-1)[keep].to(torch.int64),
        vals.reshape(r * m, t, t)[keep].to(x.dtype),
        size=(r * t, xx.shape[0]),
    )
    return lambda: a @ xx


# ---------------------------------------------------------------------------
# phase 11: the multi-shard slide, SHARDS ranks on the one card
# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def shard_worker(rank: int, world: int, work: str, ckpt: str,
                 cpu: bool) -> None:
    """Rank ``rank`` of phase 11 (a spawned process): join the group of
    ``world`` ranks (gloo, every rank on the one card), run
    :func:`shard_rank`, save its results under ``work``."""
    import datetime

    import torch
    import torch.distributed as dist
    from cgcnet_tpu_torch.parallel.mesh import init_graph_axis

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    axis = init_graph_axis(
        rank, world, cpu=cpu, init_method=f"file://{work}/init",
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        torch.save(shard_rank(axis, Path(work), Path(ckpt)),
                   Path(work) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def shard_rank(axis, work: Path, ckpt: Path) -> dict:
    """One rank's part of phase 11: ``cli.slide.main`` at ``--shards``
    SHARDS (bf16) with the counters read, the rank's own build of the same
    inputs, its bf16 and f32 forwards and the plain versions' on the same
    shards, then SHARD_STEPS bf16 training steps with the counters read and
    the parameters, Adam state and running statistics saved after each."""
    import torch
    from cgcnet_tpu_torch.cli import slide as slide_cli
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.ops import bsr
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward
    from cgcnet_tpu_torch.parallel.mega_train import (
        make_optimizer,
        make_slide_train_step,
    )
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    device = axis.device
    b8 = bsr.bsr_matmul_banded

    def zero():
        zero_counts()
        b8.halo_window_launches = 0

    def counts():
        return {**read_counts(), "B8 halo": b8.halo_window_launches}

    out = {"backend": axis.backend, "staged": axis.staged}
    zero()
    t0 = time.time()
    res = slide_cli.main(
        ["--synthetic", "--nuclei", str(SLIDE_NUCLEI), "--shards",
         str(axis.size), "--ckpt", str(ckpt), *SLIDE_DTYPE,
         *(["--cpu"] if device.type == "cpu" else [])])
    torch.cuda.synchronize()
    out.update(serve=counts(), cli_wall_s=time.time() - t0,
               cli_logits=res["logits"], cli_bsr=res["bsr"], cap=res["cap"])

    cfg, cfg32 = Config().apply_overrides(SLIDE_DTYPE), Config()
    feats, coords = synthetic_slide(SLIDE_NUCLEI)
    inputs = build_slide_inputs(cfg, feats, coords, axis.size, device,
                                axis=axis).inputs
    out.update(win_halo=inputs.win_halo is not None,
               hybrid=inputs.blk_cols_t.shape[0] * bsr.TILE
               < inputs.nbr_t.shape[0])
    model = slide_model(cfg, ckpt, device)
    with torch.no_grad():
        out["logits"] = mega_forward(model, cfg.model, inputs).cpu()
        out["forward_ms"] = time_ms(
            lambda: mega_forward(model, cfg.model, inputs), reps=5, warmup=1)
        out["split"] = collective_split(
            lambda: mega_forward(model, cfg.model, inputs))
        out["logits32"] = mega_forward(model, cfg32.model, inputs).cpu()
        with sites_replaced(all_plain):
            out["plain16"] = mega_forward(model, cfg.model, inputs).cpu()
            out["plain32"] = mega_forward(model, cfg32.model, inputs).cpu()
    del model

    m = slide_model(cfg, ckpt, device).train()
    params0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    stats0 = {n: b.clone() for n, b in m.named_buffers()}
    opt = make_optimizer(m, 1e-3)
    step = make_slide_train_step(m, cfg.model, opt)
    zero()
    losses, times = [], []
    for i in range(SHARD_STEPS):
        gen = torch.Generator(device=device).manual_seed(100 + i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(inputs, 1, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
        state = {f"param.{n}": p.detach().cpu()
                 for n, p in m.named_parameters()}
        state.update({f"buffer.{n}": b.cpu() for n, b in m.named_buffers()})
        for n, p in m.named_parameters():
            state.update({f"adam.{n}.{k}": v.cpu()
                          for k, v in opt.state[p].items()})
        torch.save(state, work / f"state{axis.rank}_{i}.pt")
    out.update(
        train=counts(), losses=losses, step_ms=times,
        moved=sum(not torch.equal(p.detach(), params0[n])
                  for n, p in m.named_parameters()),
        stats_moved=sum(not torch.equal(b, stats0[n])
                        for n, b in m.named_buffers()),
        n_params=len(params0), n_stats=len(stats0))
    return out


def collective_split(fn) -> dict:
    """One call of ``fn`` on the host clock (from a device sync to a device
    sync) and the part of it spent inside the graph axis's collectives
    (each from a device sync to its return: staging through host memory,
    the transfer, and waiting on the other ranks), with their count."""
    import torch
    from cgcnet_tpu_torch.parallel import mega_graph

    spent = {"ms": 0.0, "calls": 0}
    originals = (mega_graph._gather_raw, mega_graph._all_to_all_raw)

    def timed(raw):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = raw(*args)
            torch.cuda.synchronize()
            spent["ms"] += (time.perf_counter() - t0) * 1e3
            spent["calls"] += 1
            return res
        return call

    mega_graph._gather_raw, mega_graph._all_to_all_raw = map(timed, originals)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        mega_graph._gather_raw, mega_graph._all_to_all_raw = originals
    return {"forward_ms": total, "collective_ms": spent["ms"],
            "collectives": spent["calls"]}


def shards_phase(tmp: Path, device, ckpt: Path) -> dict:
    """Phase 11 (see the module docstring). Returns the launch counts of
    its main path (``slide_shards``: the CLI's build and forwards and the
    training steps, summed over the ranks; ``slide_shards_halo``: B8's
    halo-window launches) and its numbers."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    log(f"phase 11: the slide at {SHARDS} shards ({SHARDS} ranks on one "
        f"card over gloo; cli.slide, bf16 and f32 forwards, "
        f"{SHARD_STEPS} bf16 steps)")
    # the one-shard f32 forward of the same slide and weights on this card
    cfg32 = Config()
    feats, coords = synthetic_slide(SLIDE_NUCLEI)
    one = build_slide_inputs(cfg32, feats, coords, 1, device).inputs
    with torch.no_grad():
        one32 = mega_forward(slide_model(cfg32, ckpt, device), cfg32.model,
                             one).cpu()
    del one
    torch.cuda.empty_cache()

    work = tmp / "shards"
    work.mkdir()
    t0 = time.time()
    ctx = mp.start_processes(
        shard_worker, args=(SHARDS, str(work), str(ckpt),
                            device.type == "cpu"),
        nprocs=SHARDS, join=False, start_method="spawn")
    deadline = t0 + 2 * SHARD_TIMEOUT_S
    try:
        # a rank's failure raises here (its traceback) and ends the others
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise SystemExit(f"phase 11: the ranks ran past "
                                 f"{2 * SHARD_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    wall = time.time() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(SHARDS)]
    r0 = ranks[0]

    want_serve = {k: SLIDE_BUILD.get(k, 0) + 2 * SLIDE_FORWARD.get(k, 0)
                  for k in KERNELS}
    want_train = expected(SLIDE_TRAIN_PER_STEP, SHARD_STEPS)
    halo = []
    for r, rk in enumerate(ranks):
        serve = {k: rk["serve"][k] for k in KERNELS}
        train = {k: rk["train"][k] for k in KERNELS}
        halo.append(rk["serve"]["B8 halo"] + rk["train"]["B8 halo"])
        log(f"  rank {r} ({rk['backend']}, staged through host memory: "
            f"{rk['staged']}): halo windows {rk['win_halo']}, hybrid "
            f"transpose {rk['hybrid']}; cli.slide launches {serve}, "
            f"{SHARD_STEPS} steps {train}; B8 halo-window launches "
            f"{rk['serve']['B8 halo']} + {rk['train']['B8 halo']}")
        if serve != want_serve or train != want_train:
            raise SystemExit(f"phase 11 rank {r}: launches {serve} / {train} "
                             f"!= {want_serve} / {want_train}")
        if rk["win_halo"] and not (rk["serve"]["B8 halo"]
                                   and rk["train"]["B8 halo"]):
            raise SystemExit(f"phase 11 rank {r}: tables with halo windows, "
                             f"B8's halo-window kernel not launched")
        same = (np.array_equal(rk["cli_logits"], r0["cli_logits"])
                and all(torch.equal(rk[k], r0[k]) for k in
                        ("logits", "logits32", "plain16", "plain32"))
                and rk["losses"] == r0["losses"])
        if not same:
            raise SystemExit(f"phase 11 rank {r}: logits or losses differ "
                             f"from rank 0's")
        if (rk["moved"] != rk["n_params"] or rk["stats_moved"] != rk["n_stats"]
                or not np.isfinite(rk["losses"]).all()):
            raise SystemExit(
                f"phase 11 rank {r}: losses {rk['losses']}, parameters "
                f"changed {rk['moved']}/{rk['n_params']}, running statistics "
                f"{rk['stats_moved']}/{rk['n_stats']}")
    if not any(rk["win_halo"] for rk in ranks) or not sum(halo):
        raise SystemExit("phase 11: no rank launched B8's halo-window kernel")
    log(f"  B8 halo-window launches per rank: {halo}")
    for i in range(SHARD_STEPS):
        s0 = torch.load(work / f"state0_{i}.pt", weights_only=False)
        for r in range(1, SHARDS):
            sr = torch.load(work / f"state{r}_{i}.pt", weights_only=False)
            diff = [n for n, t in s0.items()
                    if n not in sr or not torch.equal(sr[n], t)]
            if diff or set(sr) != set(s0):
                raise SystemExit(f"phase 11 step {i}: rank {r}'s state "
                                 f"differs from rank 0's: {diff[:5]}")
    log(f"  after each of {SHARD_STEPS} steps every rank's parameters, Adam "
        f"state and running statistics equal rank 0's "
        f"({len(s0)} tensors); losses {r0['losses']}")

    logits, plain16, plain32 = r0["logits"], r0["plain16"], r0["plain32"]
    err = (logits - plain16).abs().max().item()
    spread = BF16_WIDEN * (plain16 - plain32).abs().max().item()
    lim = LOGIT_ATOL + LOGIT_RTOL * plain16.abs().max().item() + spread
    log(f"  bf16 logits {logits.tolist()} vs plain versions on the same "
        f"shards {plain16.tolist()} (f32 plain {plain32.tolist()}): max abs "
        f"diff {err:.3e} (tol {lim:.3e}: the f32 rule plus {BF16_WIDEN:g}x "
        f"{spread / BF16_WIDEN:.3e}); cli.slide {r0['cli_logits'].tolist()}")
    if not err <= lim or int(logits.argmax()) != int(plain16.argmax()):
        raise SystemExit("phase 11: bf16 logits, kernels vs plain versions")
    ok32 = np.allclose(r0["logits32"].numpy(), one32.numpy(),
                       atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    log(f"  f32 logits at {SHARDS} shards {r0['logits32'].tolist()} vs one "
        f"shard {one32.tolist()} (atol {LOGIT_ATOL}, rtol {LOGIT_RTOL}): "
        f"{'ok' if ok32 else 'FAIL'}")
    if not ok32:
        raise SystemExit("phase 11: f32 logits differ with the shard count")
    fwd = [rk["forward_ms"] for rk in ranks]
    steps = [rk["step_ms"] for rk in ranks]
    log(f"  one bf16 forward per rank on the host clock: "
        + "; ".join(f"rank {r} {rk['split']['forward_ms']:.3f} ms, "
                    f"{rk['split']['collectives']} collectives "
                    f"{rk['split']['collective_ms']:.3f} ms"
                    for r, rk in enumerate(ranks)))
    log(f"  timing ({card_line()}; one card, {SHARDS} ranks over gloo, the "
        f"collectives staged through host memory: a correctness run, not a "
        f"multi-card figure): bf16 forward {fwd[0]:.3f} ms on rank 0 "
        f"(median of 5, CUDA events; every rank {[round(v, 3) for v in fwd]})"
        f", steps {[round(v, 3) for v in steps[0]]} ms on rank 0 (CUDA "
        f"events; first step included); phase wall {wall:.1f} s")
    total = {k: sum(rk["serve"][k] + rk["train"][k] for rk in ranks)
             for k in KERNELS}
    return {"paths": {"slide_shards": total,
                      "slide_shards_halo": {"B8": sum(halo)}},
            "shards_forward_ms": fwd[0], "shards_step_ms": steps[0],
            "shards_wall_s": wall, "shards_halo_launches": halo,
            "shards_forward_split": r0["split"]}


def slice_phase(tmp: Path, device) -> dict:
    import torch
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.train.state import create_train_state

    t0 = time.time()
    overrides, cfg = make_data(tmp)
    gin_overrides = [*overrides, "model.gcn_name=GIN"]
    gin_cfg = cfg.apply_overrides(["model.gcn_name=GIN"])
    log(f"  dataset: {time.time() - t0:.1f} s")
    # one canonical batch and the kernel inputs one training step gives them
    valid = NucleiGraphDataset(cfg.data, "valid")
    loader = GraphLoader(valid, cfg.data.batch_size, device=device,
                         shuffle=False, num_workers=4)
    graph = next(iter(loader.epoch(0)))
    log(f"  batch: x {tuple(graph.x.shape)}, n_nodes {graph.n_nodes.tolist()}, "
        f"blk_cols {tuple(graph.blk_cols.shape)}, blk_cols_t "
        f"{tuple(graph.blk_cols_t.shape)}")
    if tuple(graph.x.shape[:2]) != (CANONICAL["B"], CANONICAL["N"]):
        raise SystemExit(f"batch is not the canonical {CANONICAL}: {graph.x.shape}")
    seen = capture_inputs(create_train_state(cfg, device, seed=1234).model, graph)
    gin_seen = capture_inputs(
        create_train_state(gin_cfg, device, seed=1234).model, graph)
    for name, got, per, head in (("SAGE", seen, TRAIN_PER_STEP, "B4"),
                                 ("GIN", gin_seen, GIN_TRAIN_PER_STEP, "B6")):
        c = got[head][0][1].shape[-1]
        calls = {k: len(v) for k, v in got.items()}
        if c != CANONICAL["C"] or calls != expected(per):
            raise SystemExit(f"unexpected {name} kernel calls: C={c}, {calls}")

    log("phase 3: kernels vs plain versions (canonical shapes)")
    kernels = kernel_phase(seen, gin_seen, graph)
    del seen, gin_seen
    torch.cuda.empty_cache()

    log("phase 4: serving slice (cli.predict on the card, --reps 2)")
    serve_counts, fwd_ms, wall = serve_phase(
        tmp, device, overrides, cfg, graph, len(valid), SERVE_PER_BATCH)

    log("phase 5: training slice (train.loop, cli.train, card vs CPU)")
    train = train_phase(tmp, device, overrides, cfg, graph, TRAIN_PER_STEP,
                        SERVE_PER_BATCH)

    log("phase 6: GIN slice (cli.predict, train.loop, cli.train, card vs CPU)")
    gin_serve_counts, gin_fwd_ms, gin_wall = serve_phase(
        tmp, device, gin_overrides, gin_cfg, graph, len(valid),
        GIN_SERVE_PER_BATCH)
    gin_train = train_phase(tmp, device, gin_overrides, gin_cfg, graph,
                            GIN_TRAIN_PER_STEP, GIN_SERVE_PER_BATCH,
                            witnessed=True)

    log("phase 7: B7 without block values, B6 vs B4, GAT, SAGE+elu, the "
        "gather path")
    rest_counts = rest_phase(cfg, graph)
    paths = {"serve": serve_counts, "train": train["counts"],
             "gin_serve": gin_serve_counts, "gin_train": gin_train["counts"],
             "rest": rest_counts}
    del graph
    torch.cuda.empty_cache()

    slide_seen: dict = {}
    slide = slide_phases(tmp, device, tmp / "model_SAGE.pt", slide_seen)
    paths.update(slide.pop("paths"))
    log("  slide kernels vs plain versions (inputs of phases 8-10)")
    slide_kernels, stats = slide_kernel_phase(slide_seen, device)
    kernels += slide_kernels
    # slide_capture's shims hold ``slide_seen`` in a reference cycle
    del slide_seen
    gc.collect()
    torch.cuda.empty_cache()
    shards = shards_phase(tmp, device, tmp / "model_SAGE.pt")
    paths.update(shards.pop("paths"))
    entry_points = entry_phase(tmp, device, overrides, cfg)
    paths.update(entry_points.pop("paths"))
    data_parallel = dp_phase(tmp, device, cfg)
    paths.update(data_parallel.pop("paths"))
    ladder = ladder_phase(tmp, device, tmp / "model_SAGE.pt")
    paths.update(ladder.pop("paths"))
    kernels += ladder.pop("kernels")
    slide_f32 = f32_phase(tmp, device, tmp / "model_SAGE.pt")
    paths.update(slide_f32.pop("paths"))
    tail_kernels, tail_paths = tail_phase(device)
    kernels += tail_kernels
    paths.update(tail_paths)
    for entry in kernels:
        key = entry.pop("key")
        by_path = {name: paths[name][key] for name in entry.pop("paths")}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if by_path and entry["launches"] == 0:
            raise SystemExit(f"{entry['name']}: no launch on any path")
    return {**slide, **shards, **entry_points, **data_parallel, **ladder,
            **slide_f32, "kernels": kernels,
            "stats_hold": stats,
            "forward_ms_per_batch": fwd_ms,
            "predict_wall_s": wall, "train_step_ms": train["step_ms"],
            "train_steps": train["steps"], "train_cli_wall_s": train["cli_wall_s"],
            "gin_forward_ms_per_batch": gin_fwd_ms, "gin_predict_wall_s": gin_wall,
            "gin_train_step_ms": gin_train["step_ms"],
            "gin_train_steps": gin_train["steps"],
            "gin_train_cli_wall_s": gin_train["cli_wall_s"]}


# ---------------------------------------------------------------------------
# phase 12: the remaining entry points and host code
# ---------------------------------------------------------------------------

def _sub_batch(graph, b: int):
    """The first ``b`` graphs of a batch."""
    import dataclasses

    return dataclasses.replace(graph, **{
        f.name: getattr(graph, f.name)[:b] for f in dataclasses.fields(graph)
        if getattr(graph, f.name) is not None})


def _add(into: dict, counts: dict) -> None:
    for k, v in counts.items():
        into[k] += v


def _numpy_batch(graph) -> dict:
    import dataclasses

    return {f.name: getattr(graph, f.name).cpu().numpy()
            for f in dataclasses.fields(graph)
            if getattr(graph, f.name) is not None}


def check_gexf(path: Path, graph, i: int, s1, s2) -> None:
    """Parse one patch's GEXF back with xml.etree: its nodes are the
    patch's n_nodes, its edges the graph's undirected edges without self
    loops, and each node's cluster ids the argmax of the composed S that the
    forward returned (``s1`` [N, C1], ``s2`` [C1, C2])."""
    import xml.etree.ElementTree as ET

    import numpy as np

    ns = {"g": "http://www.gexf.net/1.2draft"}
    root = ET.parse(path).getroot()
    titles = {a.get("id"): a.get("title")
              for a in root.findall(".//g:attributes/g:attribute", ns)}
    n = int(graph.n_nodes[i])
    nbr = graph.nbr[i, :n].cpu().numpy()
    mask = graph.nbr_mask[i, :n].cpu().numpy()
    rows = np.repeat(np.arange(n), nbr.shape[1]).reshape(nbr.shape)
    keep = (mask > 0) & (nbr != rows)
    want = {(min(a, b), max(a, b)) for a, b in zip(rows[keep], nbr[keep])}
    got = {(min(int(e.get("source")), int(e.get("target"))),
            max(int(e.get("source")), int(e.get("target"))))
           for e in root.findall(".//g:edges/g:edge", ns)}
    edges = root.findall(".//g:edges/g:edge", ns)
    a1 = s1[:n].float().cpu().numpy().argmax(1)
    a2 = s2.float().cpu().numpy().argmax(1)[a1]
    ids = {"assign_1": a1, "assign_2": a2}
    nodes = root.findall(".//g:nodes/g:node", ns)
    bad = [path.name for cond in (
        len(nodes) == n, len(edges) == len(got) == len(want), got == want)
        if not cond]
    for node in nodes:
        k = int(node.get("id"))
        for v in node.findall(".//g:attvalue", ns):
            t = titles[v.get("for")]
            if t in ids and int(v.get("value")) != int(ids[t][k]):
                bad.append(f"node {k} {t}")
    if bad:
        raise SystemExit(f"phase 12: GEXF {path.name} disagrees: {bad[:5]} "
                         f"({len(nodes)} nodes for {n}, {len(edges)} edges "
                         f"for {len(want)})")


def make_tiles(root: Path, size: int = TILE_PIXELS) -> int:
    """Instance masks and .npy grayscale images of TILE_COUNT tiles in the
    reference layout (<fold>/<grade_dir>/<name>.npy), nuclei on a jittered
    grid; returns the tile count."""
    import numpy as np

    rng = np.random.default_rng(12)
    y, x = np.ogrid[:size, :size]
    count = 0
    for fold in ("fold_1", "fold_2", "fold_3"):
        for gdir in ("1_normal", "3_high_grade")[:TILE_COUNT // 3]:
            mask = np.zeros((size, size), np.int32)
            gray = rng.integers(90, 140, (size, size)).astype(np.uint8)
            lab = 1
            for cy in range(12, size - 12, TILE_STEP):
                for cx in range(12, size - 12, TILE_STEP):
                    jy, jx = rng.integers(-4, 5, 2)
                    ry, rx = rng.uniform(4, 8, 2)
                    disk = (((y - cy - jy) / ry) ** 2
                            + ((x - cx - jx) / rx) ** 2) <= 1
                    mask[disk] = lab
                    gray[disk] = rng.integers(20, 80, int(disk.sum()))
                    lab += 1
            for kind, arr in (("masks", mask), ("images", gray)):
                d = root / kind / fold / gdir
                d.mkdir(parents=True, exist_ok=True)
                np.save(d / "tile0_grade_1_0.npy", arr)
            count += 1
    return count


def entry_phase(tmp: Path, device, overrides, cfg) -> dict:
    """Phase 12 (see the module docstring). Returns the launch counts of its
    paths and its numbers."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import crossval
    from cgcnet_tpu_torch.cli import export as export_cli
    from cgcnet_tpu_torch.cli import predict
    from cgcnet_tpu_torch.cli import preprocess
    from cgcnet_tpu_torch.cli import train as train_cli
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.dataflow.synthetic import generate_dataset
    from cgcnet_tpu_torch.preprocess import features
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint
    from cgcnet_tpu_torch.train.loop import evaluate, make_train_step
    from cgcnet_tpu_torch.train.state import create_train_state
    from cgcnet_tpu_torch.utils.export_model import load_exported
    from cgcnet_tpu_torch.utils.profiling import TRACE_NAME, enable_debug_checks

    log("phase 12: the remaining entry points (export, visualize, dynamic "
        "buckets, random sampler, fixed epochs, crossval, profile, "
        "debug_nans, preprocess)")
    import importlib.util

    t_phase = time.time()
    log("  optional packages here: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) else 'no'}"
        for m in ("networkx", "cv2", "tensorboard")))
    paths = {p: expected({}) for p in ENTRY_PATHS}
    cpu_flag = ["--cpu"] if device.type == "cpu" else []
    valid = NucleiGraphDataset(cfg.data, "valid")
    loader = GraphLoader(valid, cfg.data.batch_size, device=device,
                         shuffle=False, num_workers=4)
    graph = next(iter(loader.epoch(0)))

    # ---- (a) the kernel artifacts and the portable one ----
    def artifact(name, ckpt, over, extra=()):
        out = tmp / f"{name}.cgexp"
        t0 = time.time()
        res = export_cli.main([*cpu_flag, "--ckpt", str(ckpt), "-o", str(out),
                               *extra, *over])
        t1 = time.time()
        fwd, header = load_exported(out)
        log(f"  artifact {name}: export {t1 - t0:.1f} s, load "
            f"{time.time() - t1:.1f} s, {res['bytes']} bytes, device "
            f"{header['device']}, ops {header['custom_ops']}")
        return fwd

    def held(fwd, g, model, per, path, what):
        with torch.no_grad():
            want = model(g)
        zero_counts()
        got = fwd(g)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected(per):
            raise SystemExit(f"phase 12 {what}: launches {counts} != {per}")
        _add(paths[path], counts)
        err = (got - want).abs().max().item()
        tol = TOL[("B4", "float32")] * want.abs().max().item()
        log(f"  {what}, batch {g.x.shape[0]}: launches {per}, max abs diff "
            f"to the eager model {err:.3e} (tol {tol:.3e})")
        if not (torch.isfinite(got).all() and err <= tol):
            raise SystemExit(f"phase 12 {what}: logits out of tolerance")
        return got

    sd = load_checkpoint(tmp / "model_SAGE.pt")[0]
    model = predict.build_model(cfg, sd, device)
    fwd = artifact("sage", tmp / "model_SAGE.pt", overrides,
                   ["--batch", str(CANONICAL["B"])])
    card = held(fwd, graph, model, SERVE_PER_BATCH, "export",
                "kernel artifact (SAGE)")
    export_ms = time_ms(lambda: fwd(graph), reps=10)
    with torch.no_grad():
        eager_ms = time_ms(lambda: model(graph), reps=10)
    log(f"  forward per batch: reloaded kernel artifact {export_ms:.3f} ms, "
        f"eager {eager_ms:.3f} ms (median of 10, CUDA events)")
    sym = artifact("sage_symbolic", tmp / "model_SAGE.pt", overrides,
                   ["--symbolic-batch"])
    for b in (2, CANONICAL["B"]):
        held(sym, _sub_batch(graph, b), model, SERVE_PER_BATCH, "export",
             "symbolic-batch kernel artifact (SAGE)")
    gin_over = [*overrides, "model.gcn_name=GIN"]
    gin_cfg = cfg.apply_overrides(["model.gcn_name=GIN"])
    gin_model = predict.build_model(
        gin_cfg, load_checkpoint(tmp / "model_GIN.pt")[0], device)
    held(artifact("gin", tmp / "model_GIN.pt", gin_over), graph, gin_model,
         GIN_SERVE_PER_BATCH, "gin_export", "kernel artifact (GIN)")
    del gin_model
    out = tmp / "portable.cgexp"
    export_cli.main(["--cpu", "--ckpt", str(tmp / "model_SAGE.pt"), "-o",
                     str(out), *overrides])
    portable, header = load_exported(out)
    t0 = time.time()
    cpu_logits = portable(graph.to("cpu")).numpy()
    card_logits = card.cpu().numpy()
    err = float(np.abs(card_logits - cpu_logits).max())
    log(f"  portable artifact on the CPU ({header['fields']}, ops "
        f"{header['custom_ops']}): {time.time() - t0:.1f} s, max abs diff to "
        f"the card's kernel artifact {err:.3e} (atol {LOGIT_ATOL}, rtol "
        f"{LOGIT_RTOL})")
    if header["custom_ops"] or not np.allclose(
            cpu_logits, card_logits, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise SystemExit("phase 12: portable artifact out of tolerance")

    # ---- (b) visualize ----
    state = create_train_state(cfg, device, seed=1234)
    state.model.load_state_dict(sd)
    viz = tmp / "viz"
    zero_counts()
    result = evaluate(state, loader, visualize_dir=viz, visualize_max=VIS_MAX)
    torch.cuda.synchronize()
    counts = read_counts()
    n_batches = loader.batches_per_epoch()
    if counts != expected(SERVE_PER_BATCH, n_batches):
        raise SystemExit(f"phase 12 visualize: launches {counts} != "
                         f"{SERVE_PER_BATCH} x {n_batches}")
    _add(paths["visualize"], counts)
    files = sorted(viz.glob("*.gexf"))
    if len(files) != min(VIS_MAX, len(valid)):
        raise SystemExit(f"phase 12 visualize: {len(files)} GEXF files")
    checked = 0
    for g in loader.epoch(0):
        with torch.no_grad():
            _, (s1, s2) = state.model.eval()(g, collect_assign=True)
        for i in range(g.x.shape[0]):
            if checked < VIS_MAX:
                name = valid.names[int(g.patch_idx[i])]
                check_gexf(viz / (name.replace("/", "_") + ".gexf"), g, i,
                           s1[i], s2[i])
                checked += 1
    log(f"  evaluate(visualize_dir=): {result}; {len(files)} GEXF files, "
        f"each parsed back: nodes, edges and composed cluster ids as the "
        f"forward's S; launches {counts}")
    del state

    # ---- (c) dynamic buckets ----
    broot = tmp / "bucket_data"
    generate_dataset(str(broot), patches_per_image=2, images_per_grade=2,
                     n_nodes=BUCKET_NODES, seed=1)
    bover = [f"data.root={broot}", "data.num_workers=4",
             f"data.max_num_nodes={DATA_NODES[1]}"]
    bcfg = predict.serving_config([*bover, "data.dynamic_buckets=true"])
    state = create_train_state(bcfg, device)
    bloader = GraphLoader(
        NucleiGraphDataset(bcfg.data, "train"), bcfg.data.batch_size,
        device=device, shuffle=True, num_workers=4, seed=bcfg.data.seed,
        drop_last=True, dynamic_buckets=True)
    step_fn = make_train_step()
    caps, losses, small = [], [], None
    for g in bloader.epoch(0):
        zero_counts()
        metrics = step_fn(state, g)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != expected(TRAIN_PER_STEP):
            raise SystemExit(f"phase 12 buckets: launches {counts} != "
                             f"{TRAIN_PER_STEP} at capacity {g.capacity}")
        _add(paths["buckets"], counts)
        caps.append(g.capacity)
        losses.append(float(metrics["loss"]))
        if small is None or g.capacity < small.capacity:
            small = g
    log(f"  dynamic buckets: {len(caps)} steps at capacities {caps}, "
        f"launches per step {TRAIN_PER_STEP}, losses "
        f"{[round(v, 4) for v in losses]}")
    if len(set(caps)) < 2 or not np.isfinite(losses).all():
        raise SystemExit("phase 12 buckets: fewer than two capacities or a "
                         "loss not finite")
    grad_hold(bcfg, device, small, witnessed=False)
    del state

    # ---- (d) the fixed-epoch replay and the random sampler ----
    if preprocess.main(["fixed", "--root", str(broot), "--epochs", "1",
                        "--processes", "1", *bover[1:]]) != 0:
        raise SystemExit("phase 12: cli.preprocess fixed failed")
    fcfg = predict.serving_config(
        [*bover, "data.use_fixed=true", "data.num_fixed_epochs=1"])
    ocfg = predict.serving_config(bover)
    # one worker each: the grow-only BSR slot caps then see the batches in
    # the same order, so the block metadata's widths agree too
    replay, online = (
        GraphLoader(NucleiGraphDataset(c.data, "train"), c.data.batch_size,
                    device="cpu", shuffle=True, seed=c.data.seed,
                    num_workers=1, drop_last=True).epoch(0)
        for c in (fcfg, ocfg))
    for a, b in zip(replay, online):
        a, b = _numpy_batch(a), _numpy_batch(b)
        differ = [k for k in a.keys() | b.keys() if k not in a or k not in b
                  or a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
        if differ:
            raise SystemExit("phase 12: the use_fixed batch differs from the "
                             f"online batch in {sorted(differ)}")
    log("  cli.preprocess fixed, then data.use_fixed=true: every training "
        "batch of epoch 0 equals the online batch bit for bit")
    rcfg = predict.serving_config([*bover, "data.graph_sampler=random"])
    t0 = time.time()
    rg = next(iter(GraphLoader(
        NucleiGraphDataset(rcfg.data, "train"), rcfg.data.batch_size,
        device=device, shuffle=False, num_workers=4).epoch(0)))
    build_s = time.time() - t0
    state = create_train_state(rcfg, device)
    zero_counts()
    loss = float(make_train_step()(state, rg)["loss"])
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  graph_sampler=random: ELL width {rg.nbr.shape[-1]}, batch "
        f"{tuple(rg.x.shape)} built in {build_s:.1f} s, train-step loss "
        f"{loss:.6f}, launches {counts}")
    if counts != expected(TRAIN_PER_STEP) or not np.isfinite(loss) or \
            rg.nbr.shape[-1] != 2 * rcfg.data.max_neighbours + 1:
        raise SystemExit("phase 12 random sampler: launches, loss or width")
    _add(paths["random"], counts)
    grad_hold(rcfg, device, rg, witnessed=False)
    del state, rg

    # ---- (e) crossval, the profiler, debug_nans ----
    zero_counts()
    t0 = time.time()
    cv = crossval.main([*cpu_flag, *bover, "train.num_epochs=1",
                        "train.test_epoch=1", "train.eval_every_batches=0",
                        f"train.ckpt_dir={tmp / 'cv_runs'}"])
    torch.cuda.synchronize()
    cv_s = time.time() - t0
    counts = read_counts()
    _add(paths["crossval"], counts)
    folds = [cv["folds"][f] for f in (1, 2, 3)]
    log(f"  crossval: {cv_s:.1f} s, mean {cv['mean']}, launches {counts}")
    for key, mean in cv["mean"].items():
        vals = [f[key] for f in folds]
        if not (np.isfinite(vals).all()
                and abs(mean - float(np.mean(vals))) <= 1e-12):
            raise SystemExit(f"phase 12 crossval: {key} {vals} -> {mean}")
    if any(counts[k] == 0 for k in TRAIN_PER_STEP):
        raise SystemExit(f"phase 12 crossval: a kernel of {TRAIN_PER_STEP} "
                         f"never launched: {counts}")
    zero_counts()
    result = train_cli.main([*cpu_flag, *bover, "train.num_epochs=1",
                             "train.profile=true", "train.test_epoch=1",
                             f"train.ckpt_dir={tmp / 'profile_runs'}"])
    torch.cuda.synchronize()
    counts = read_counts()
    _add(paths["profile"], counts)
    trace = (Path(result["run_dir"]) / "profile" / TRACE_NAME).read_text()
    missing = {k: names for k, names in PROFILE_KERNELS.items()
               if not any(n in trace for n in names)}
    log(f"  train.profile: {len(trace) / 1e6:.1f} MB Chrome trace; kernels "
        f"of B1-B5 in it: {sorted(set(PROFILE_KERNELS) - set(missing))}; "
        f"launches {counts}")
    if missing:
        raise SystemExit(f"phase 12 profile: no kernel of {missing} in the trace")
    state = create_train_state(bcfg, device)
    step_fn = make_train_step(debug_nans=True)
    with enable_debug_checks(True):
        zero_counts()
        loss = float(step_fn(state, small)["loss"])
        torch.cuda.synchronize()
        counts = read_counts()
        import dataclasses

        bad = small.x.clone()
        bad[0, 1, 3] = float("nan")
        try:
            step_fn(state, dataclasses.replace(small, x=bad))
            raised = None
        except (FloatingPointError, RuntimeError) as e:
            raised = str(e).splitlines()[0]
    log(f"  train.debug_nans: clean step loss {loss:.6f} (launches {counts}); "
        f"planted NaN: {raised}")
    if counts != expected(TRAIN_PER_STEP) or not np.isfinite(loss) or not raised:
        raise SystemExit("phase 12 debug_nans: the clean step failed or the "
                         "planted NaN passed")
    _add(paths["profile"], counts)
    del state

    # ---- (f) preprocess: scipy's branch, and OpenCV's where installed ----
    tiles = make_tiles(tmp / "tiles")
    cv2, per_tile = features.cv2, {}
    for branch in ("scipy", "OpenCV")[:2 if cv2 else 1]:
        features.cv2 = cv2 if branch == "OpenCV" else None
        t0 = time.time()
        try:
            rc = preprocess.main([
                "features", "--masks", str(tmp / "tiles" / "masks"),
                "--images", str(tmp / "tiles" / "images"),
                "--out", str(tmp / f"tiles_{branch}"), "--processes", "1"])
        finally:
            features.cv2 = cv2
        per_tile[branch] = (time.time() - t0) / tiles
        if rc != 0:
            raise SystemExit(f"phase 12: cli.preprocess features ({branch}) "
                             "failed")
    # the published normalization tables: scipy's geometry branch gives
    # constant columns, whose own standard deviation is 0
    tds = NucleiGraphDataset(predict.serving_config([
        f"data.root={tmp / 'tiles_scipy'}", "data.max_num_nodes=2048"]).data,
        "train", use_reference_stats=True)
    sample = tds.get(0)
    log(f"  cli.preprocess features: {tiles} tiles of {TILE_PIXELS}^2 px, "
        f"seconds per tile {per_tile} (one process); {len(tds)} training "
        f"protos of scipy's branch load, the first {sample.n_nodes} nodes")
    if not (sample.n_nodes > 0 and np.isfinite(sample.x).all()):
        raise SystemExit("phase 12: the preprocessed protos do not load")
    wall = time.time() - t_phase
    log(f"  phase 12 wall {wall:.1f} s; launches by path {paths}")
    return {"paths": paths, "export_forward_ms": export_ms,
            "eager_forward_ms": eager_ms,
            "preprocess_s_per_tile": per_tile, "entry_wall_s": wall}


# ---------------------------------------------------------------------------
# phase 13: the patch training step over a data axis of ranks
# ---------------------------------------------------------------------------

def dp_config(cfg):
    """Phase 13's configuration: phase 4's, without dropout (JAX's sharded
    step draws one global mask, each rank its own) and with SGD, whose
    update is linear in the gradient, so the parameters hold at the
    gradients' rule."""
    return cfg.apply_overrides(DP_OVER)


def dp_state(cfg, device, ckpt: Path):
    """A training state of ``cfg`` on ``device`` with the checkpoint's
    weights."""
    from cgcnet_tpu_torch.train.checkpoint import load_checkpoint
    from cgcnet_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, device)
    state.model.load_state_dict(load_checkpoint(ckpt)[0], strict=True)
    return state


def step_record(state) -> dict:
    """Copies of the parameters, gradients and running statistics after a
    step, on the CPU."""
    model = state.model
    copy = lambda t: t.detach().to("cpu", copy=True)
    return {"params": {n: copy(p) for n, p in model.named_parameters()},
            "grads": {n: copy(p.grad) for n, p in model.named_parameters()
                      if p.grad is not None},
            "buffers": {n: copy(b) for n, b in model.named_buffers()}}


def params_close(what, p_got, ref: dict, lr: float) -> None:
    """Parameters after a first SGD step (update lr x the gradient, plus
    weight decay, the same on both sides) against ``ref``'s: PR 2's
    gradient rule (GRAD_REL of the tensor's max|grad| plus GRAD_FLOOR of
    the model's largest gradient) times lr, plus one f32 rounding step of
    the tensor's largest value (2^-23 of it: each side rounds its stored
    parameter once)."""
    g_ref, p_ref = ref["grads"], ref["params"]
    top = max(g.abs().max().item() for g in g_ref.values())
    ratio = {}
    for n, p in p_ref.items():
        tol = (lr * (GRAD_REL * g_ref[n].abs().max().item() + GRAD_FLOOR * top)
               + 2.0 ** -23 * p.abs().max().item())
        ratio[n] = (p_got[n] - p).abs().max().item() / tol
    w = max(ratio, key=ratio.get)
    log(f"  {what}: worst {w} at {ratio[w]:.3f} of lr x (the gradient rule) "
        f"+ 2^-23 x max|p| ({len(ratio)} tensors)")
    if not ratio[w] <= 1.0:
        raise SystemExit(f"{what}: parameter {w} out of tolerance")


def dp_worker(rank: int, world: int, work: str, cfg_json: str,
              ckpt: str, cpu: bool) -> None:
    """Rank ``rank`` of phase 13 (a spawned process): join the group of
    ``world`` ranks (gloo, every rank on the one card), run
    :func:`dp_rank`, save its results under ``work``."""
    import datetime

    import torch
    import torch.distributed as dist
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.parallel.mesh import init_graph_axis

    axis = init_graph_axis(
        rank, world, cpu=cpu, init_method=f"file://{work}/init",
        timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        torch.save(dp_rank(axis, Path(work), Config.from_json(cfg_json),
                           Path(ckpt)),
                   Path(work) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_rank(axis, work: Path, cfg, ckpt: Path) -> dict:
    """One rank's part of phase 13: DP_STEPS data-parallel steps on its rows
    of the process-sharded loader's global batches, with the counters, the
    host clock and the peak memory read per step, a sharded checkpoint of
    the training state after the first; then one more step with the
    collectives timed (DDP's bucket all-reduces through a comm hook that
    waits on each, the statistics' and the metrics' sums through the
    collectives' raw all-gather)."""
    import torch
    from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import (
        allreduce_hook,
    )
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.parallel import mega_graph
    from cgcnet_tpu_torch.train import checkpoint_sharded, loop

    timed = {"on": False, "ddp_ms": 0.0, "ddp_calls": 0,
             "statistics_ms": 0.0, "statistics_calls": 0,
             "metrics_ms": 0.0, "metrics_calls": 0}

    def hook(group, bucket):
        if not timed["on"]:
            return allreduce_hook(group, bucket)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fut = allreduce_hook(group, bucket)
        fut.wait()
        torch.cuda.synchronize()
        timed["ddp_ms"] += (time.perf_counter() - t0) * 1e3
        timed["ddp_calls"] += 1
        return fut

    class TimedDDP(loop.DistributedDataParallel):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.register_comm_hook(self.process_group, hook)

    raw, plain_ddp = mega_graph._gather_raw, loop.DistributedDataParallel

    def gather(x, ax):
        if not timed["on"]:
            return raw(x, ax)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = raw(x, ax)
        torch.cuda.synchronize()
        kind = "metrics" if ax.group is axis.group else "statistics"
        timed[f"{kind}_ms"] += (time.perf_counter() - t0) * 1e3
        timed[f"{kind}_calls"] += 1
        return out

    loop.DistributedDataParallel, mega_graph._gather_raw = TimedDDP, gather
    try:
        device = axis.device
        state = dp_state(cfg, device, ckpt)
        loader = GraphLoader(
            NucleiGraphDataset(cfg.data, "train"), cfg.data.batch_size,
            device=device, shuffle=True, num_workers=1, seed=cfg.data.seed,
            drop_last=True, rank=axis.rank, world=axis.size)
        step = loop.make_train_step(data_axis=axis)
        torch.cuda.reset_peak_memory_stats(device)
        out = {"backend": axis.backend, "staged": axis.staged, "steps": []}
        for i, graph in enumerate(loader.epoch(0)):
            if i == DP_STEPS:
                timed["on"] = True
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            m = step(state, graph)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            if i == DP_STEPS:
                out["timed_step_ms"] = wall
                break
            out["steps"].append({
                "loss": float(m["loss"]), "acc": float(m["acc"]),
                "wall_ms": wall, "launches": counts,
                "n_nodes": graph.n_nodes.tolist(),
                "rows": tuple(graph.x.shape[:2]), **step_record(state)})
            if i == 0:
                checkpoint_sharded.save_sharded(
                    work / "ckpt", checkpoint_sharded.train_state(
                        state.model, state.optimizer))
        out.update(collectives={k: v for k, v in timed.items() if k != "on"},
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
        return out
    finally:
        loop.DistributedDataParallel, mega_graph._gather_raw = plain_ddp, raw


def dp_phase(tmp: Path, device, cfg) -> dict:
    """Phase 13 (see the module docstring). Returns the launch counts of its
    paths (``data_parallel``: the ranks' DP_STEPS steps; ``dryrun_dp`` and
    ``dryrun_slide``: the dry run's steps, every rank) and its numbers."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from cgcnet_tpu_torch.dataflow.dataset import NucleiGraphDataset
    from cgcnet_tpu_torch.dataflow.loader import GraphLoader
    from cgcnet_tpu_torch.parallel.dryrun import run_dryrun
    from cgcnet_tpu_torch.train import checkpoint_sharded
    from cgcnet_tpu_torch.train.loop import make_train_step

    log(f"phase 13: the patch step over a data axis of {DP_RANKS} ranks on "
        f"one card over gloo ({DP_STEPS} steps, process-sharded loader), a "
        f"sharded checkpoint, run_dryrun({DP_DRYRUN})")
    t_phase = time.time()
    dcfg = dp_config(cfg)
    ckpt = tmp / "model_SAGE.pt"

    # the one-process step on the same global batches, on this card
    state = dp_state(dcfg, device, ckpt)
    loader = GraphLoader(
        NucleiGraphDataset(dcfg.data, "train"), dcfg.data.batch_size,
        device=device, shuffle=True, num_workers=1, seed=dcfg.data.seed,
        drop_last=True)
    step = make_train_step()
    ref, batches = [], []
    for graph in loader.epoch(0):
        zero_counts()
        m = step(state, graph)
        ref.append({"loss": float(m["loss"]), "acc": float(m["acc"]),
                    "launches": read_counts(), **step_record(state)})
        batches.append(graph)
        if len(ref) == DP_STEPS:
            break
    del state
    torch.cuda.empty_cache()

    work = tmp / "dp"
    work.mkdir()
    t0 = time.time()
    ctx = mp.start_processes(
        dp_worker, args=(DP_RANKS, str(work), dcfg.to_json(), str(ckpt),
                         device.type == "cpu"),
        nprocs=DP_RANKS, join=False, start_method="spawn")
    deadline = t0 + 2 * DP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise SystemExit(f"phase 13: the ranks ran past "
                                 f"{2 * DP_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    wall = time.time() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]
    r0 = ranks[0]

    want = expected(TRAIN_PER_STEP)
    per = dcfg.data.batch_size // DP_RANKS
    for r, rk in enumerate(ranks):
        for i, (s, s0) in enumerate(zip(rk["steps"], r0["steps"])):
            if s["launches"] != want or ref[i]["launches"] != want:
                raise SystemExit(f"phase 13 rank {r} step {i}: launches "
                                 f"{s['launches']} (one process "
                                 f"{ref[i]['launches']}) != {want}")
            if s["rows"] != (per, CANONICAL["N"]):
                raise SystemExit(f"phase 13 rank {r}: rows {s['rows']}")
            same = s["loss"] == s0["loss"] and all(
                torch.equal(s[part][n], t) for part in
                ("params", "grads", "buffers") for n, t in s0[part].items())
            if not same:
                raise SystemExit(f"phase 13 step {i}: rank {r}'s state "
                                 f"differs from rank 0's")
        if len(rk["steps"]) != DP_STEPS:
            raise SystemExit(f"phase 13 rank {r}: {len(rk['steps'])} steps")
    log(f"  every rank: launches per step {want} (the one-process step's), "
        f"{per} graphs of {CANONICAL['N']} rows; parameters, gradients and "
        f"running statistics equal rank 0's after each of {DP_STEPS} steps "
        f"({r0['backend']}, staged through host memory: {r0['staged']})")

    def stats_close(what, got, want_) -> None:
        bad = [n for n, t in want_.items() if "running" in n and not
               np.allclose(got[n].numpy(), t.numpy(), atol=LOGIT_ATOL,
                           rtol=LOGIT_RTOL)]
        if bad:
            raise SystemExit(f"phase 13 {what}: running statistics {bad[:5]}")

    losses = [s["loss"] for s in r0["steps"]]
    ref_losses = [s["loss"] for s in ref]
    log(f"  losses {losses} vs the one-process step {ref_losses} (atol "
        f"{LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    if not np.allclose(losses, ref_losses, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
        raise SystemExit("phase 13: losses differ from the one-process step")
    grads_close("phase 13 step 1 gradients, 2 ranks vs one process",
                r0["steps"][0]["grads"], ref[0]["grads"], GRAD_REL)
    params_close("phase 13 step 1 parameters, 2 ranks vs one process",
                 r0["steps"][0]["params"], ref[0], dcfg.train.lr)
    for i, (s, s_ref) in enumerate(zip(r0["steps"], ref)):
        stats_close(f"step {i}", s["buffers"], s_ref["buffers"])
    log(f"  running statistics after each step within atol {LOGIT_ATOL}, "
        f"rtol {LOGIT_RTOL} of the one-process step's")

    # the sharded checkpoint: saved by both ranks after step 1, loaded in
    # this process, step 2 against the unbroken run's
    state = dp_state(dcfg, device, ckpt)
    checkpoint_sharded.load_train_state(work / "ckpt", state.model,
                                        state.optimizer)
    loaded = step_record(state)
    if not all(torch.equal(loaded["params"][n], t)
               for n, t in r0["steps"][0]["params"].items()):
        raise SystemExit("phase 13: the loaded parameters differ from the "
                         "saved ones")
    m = make_train_step()(state, batches[1])
    nxt = step_record(state)
    unbroken = r0["steps"][1]
    log(f"  sharded checkpoint (2 ranks -> one process): next step loss "
        f"{float(m['loss'])} vs the unbroken run's {unbroken['loss']}")
    if not np.isclose(float(m["loss"]), unbroken["loss"], atol=LOGIT_ATOL,
                      rtol=LOGIT_RTOL):
        raise SystemExit("phase 13: the resumed step's loss")
    grads_close("phase 13 resumed step gradients vs the unbroken run",
                nxt["grads"], unbroken["grads"], GRAD_REL)
    stats_close("resumed step", nxt["buffers"], unbroken["buffers"])
    del state, batches
    torch.cuda.empty_cache()

    t0 = time.time()
    dry = run_dryrun(DP_DRYRUN, cpu=device.type == "cpu")
    dry_s = time.time() - t0
    for r, res in enumerate(dry):
        got = {k: res["dp"]["launches"].get(k, 0) for k in KERNELS}
        if got != expected(TRAIN_PER_STEP):
            raise SystemExit(f"dry run rank {r}: launches {res['dp']}")
        for name in ("slide", "slide-capacity"):
            if not (res[name]["loss"] == dry[0][name]["loss"]
                    and np.isfinite(res[name]["loss"])):
                raise SystemExit(f"dry run rank {r} {name}: {res[name]}")
        if not (res["slide-capacity"]["launches"]["B9a"]
                and res["slide-capacity"]["launches"]["B9b"]):
            raise SystemExit(f"dry run rank {r}: the capacity step launched "
                             f"no B9a/B9b: {res['slide-capacity']}")
    log(f"  run_dryrun({DP_DRYRUN}): {dry_s:.1f} s; rank 0 "
        + "; ".join(f"{k} loss {v['loss']:.6f}, launches {v['launches']}"
                    for k, v in dry[0].items() if isinstance(v, dict)))

    for r, rk in enumerate(ranks):
        c = rk["collectives"]
        log(f"  rank {r} ({card_line()}; one card, {DP_RANKS} ranks over gloo:"
            f" a correctness run, not a multi-card figure): step wall "
            f"{[round(s['wall_ms'], 3) for s in rk['steps']]} ms (host clock,"
            f" the first with DDP's set-up); a step with the collectives "
            f"timed {rk['timed_step_ms']:.3f} ms, of it DDP "
            f"{c['ddp_ms']:.3f} ms in {c['ddp_calls']} bucket all-reduces, "
            f"statistics {c['statistics_ms']:.3f} ms in "
            f"{c['statistics_calls']} sums, metrics {c['metrics_ms']:.3f} ms "
            f"in {c['metrics_calls']}; peak memory {rk['peak_gib']:.3f} GiB")
    wall_phase = time.time() - t_phase
    log(f"  phase 13 wall {wall_phase:.1f} s (ranks {wall:.1f} s)")
    dp_counts = {k: sum(s["launches"][k] for rk in ranks for s in rk["steps"])
                 for k in KERNELS}
    dry_dp = {k: sum(res["dp"]["launches"].get(k, 0) for res in dry)
              for k in KERNELS}
    dry_slide = {k: sum(res[n]["launches"].get(k, 0) for res in dry
                        for n in ("slide", "slide-capacity"))
                 for k in KERNELS}
    return {"paths": {"data_parallel": dp_counts, "dryrun_dp": dry_dp,
                      "dryrun_slide": dry_slide},
            "dp_step_wall_ms": [[s["wall_ms"] for s in rk["steps"]]
                                for rk in ranks],
            "dp_timed_step_ms": [rk["timed_step_ms"] for rk in ranks],
            "dp_collectives": [rk["collectives"] for rk in ranks],
            "dp_peak_gib": [rk["peak_gib"] for rk in ranks],
            "dryrun_s": dry_s, "dp_wall_s": wall_phase}


# ---------------------------------------------------------------------------
# phase 14: the capacity ladder — the recipe at the JAX package's rungs
# ---------------------------------------------------------------------------

def slide_rows(nuclei: int) -> int:
    """Rows of a one-shard slide of ``nuclei`` nuclei: padded to 512
    (``build_slide_inputs``: TILE x G_BAND row tiles a shard)."""
    return -(-nuclei // 512) * 512


def capacity_per_step(rows: int) -> dict:
    """Launches of one capacity step over ``rows`` rows, chunks of
    CAP_CHUNK (``chunk_plan``: the last one the remainder): B9b and B9a
    once in the forward, B9a twice a chunk in the backward (its two
    sweeps recompute S) and B5 once a chunk; B8 the A @ S leg and its
    transpose; B2 the stage-1 legs, forward, recompute and backward."""
    chunks = -(-rows // min(CAP_CHUNK, rows))
    return {"B2": 8, "B5": chunks, "B8": 2, "B9a": 1 + 2 * chunks, "B9b": 1}


def unbanded(per: dict) -> dict:
    """``per`` on tables without band windows: B2 takes B8's legs."""
    return {**per, "B2": per.get("B2", 0) + per.get("B8", 0), "B8": 0}


def account_of(before: dict, snap: dict, device: int, top: int) -> dict:
    """The memory account of a recorded window: ``before`` is a
    ``torch.cuda.memory._snapshot()`` taken as recording began (the blocks
    alive then), ``snap`` one taken at its end (its ``device_traces`` hold
    every alloc and free in between). Replays the events from the blocks
    alive before and returns the peak of the live bytes, the bytes alive
    before, and the ``top`` largest blocks alive at the peak, each with
    the innermost frame of the port that allocated it (``where``) and the
    next one out in another function (``via``)."""
    live = {}
    for seg in before["segments"]:
        if seg.get("device", device) != device:
            continue
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"].startswith("active"):
                live[blk.get("address", addr)] = (blk["size"], None)
            addr += blk["size"]
    base = sum(size for size, _ in live.values())
    events = snap["device_traces"][device]

    def replay(upto):
        cur, total, peak, at = dict(live), base, base, -1
        for i, e in enumerate(events[:upto]):
            if e["action"] == "alloc":
                cur[e["addr"]] = (e["size"], e.get("frames") or [])
                total += e["size"]
            elif e["action"] == "free_completed" and e["addr"] in cur:
                total -= cur.pop(e["addr"])[0]
            if total > peak:
                peak, at = total, i
        return cur, peak, at

    _, peak, at = replay(len(events))
    cur, _, _ = replay(at + 1)

    def name(f):
        path = f["filename"]
        return (f"{path[path.rindex('cgcnet_tpu_torch'):]}:{f['line']} "
                f"({f['name']})")

    def where(frames):
        if frames is None:
            return "alive before the window", ""
        own = [f for f in frames if "cgcnet_tpu_torch" in f["filename"]]
        if not own:
            return ("no frame of the port (the autograd engine: a built-in "
                    "backward or a gradient sum)"), ""
        outer = next((f for f in own[1:] if f["name"] != own[0]["name"]),
                     None)
        return name(own[0]), name(outer) if outer else ""

    blocks = []
    for size, frames in sorted(cur.values(), key=lambda v: -v[0])[:top]:
        w, via = where(frames)
        blocks.append({"gib": size / 2**30, "where": w, "via": via})
    return {"peak_gib": peak / 2**30, "before_gib": base / 2**30,
            "events": len(events), "blocks": blocks}


@contextlib.contextmanager
def memory_account(out: dict, top: int = ACCOUNT_BLOCKS):
    """For the duration, record the caching allocator's history (Python
    stacks of each allocation); after it — an error included, such as an
    out-of-memory one — fill ``out`` with :func:`account_of` the window."""
    import torch

    dev = torch.cuda.current_device()
    torch.cuda.synchronize()
    before = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(
        "all", context="alloc", stacks="python", max_entries=1_000_000)
    try:
        yield
    finally:
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(None)
        out.update(account_of(before, snap, dev, top))


def peak_fit(points: list) -> dict:
    """Least-squares line through (rows, peak GiB): the bytes a row and the
    fixed GiB of a step's peak."""
    import numpy as np

    rows = np.array([r for r, _ in points], np.float64)
    gib = np.array([g for _, g in points], np.float64)
    slope, fixed = np.polyfit(rows, gib, 1)
    resid = gib - (slope * rows + fixed)
    return {"bytes_per_row": slope * 2**30, "fixed_gib": fixed,
            "max_residual_gib": float(np.abs(resid).max())}


def loss_hold(model, cfg_, inputs, what) -> float:
    """The train-mode loss of one forward under no_grad (no dropout, the
    running statistics left alone), kernels against the plain versions on
    the card sharing the STATS_HELD kernels' statistics, at step_hold's
    loss rule (``loss_rule``), unrouted; fails outside it. Returns the
    kernels' loss."""
    import math

    import torch
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward

    cfg_32 = cfg_.apply_overrides(["model.compute_dtype=float32"])

    def loss(route, c):
        with torch.no_grad(), sites_replaced(route):
            logits = mega_forward(model, c.model, inputs, train=True)
            return -torch.log_softmax(logits, -1)[1].item()

    ker, plain, f32 = (loss(every_kernel, cfg_), loss(stats_shared, cfg_),
                       loss(all_plain, cfg_32))
    lim, frac = loss_rule(ker, plain, f32)
    log(f"  {what} train-mode loss {ker:.6f} (kernels) vs {plain:.6f} (plain "
        f"versions on the card, sharing the statistics of the STATS_HELD "
        f"kernels), f32 plain {f32:.6f}; tol {lim:.3e} ({frac:.3f} of it)")
    if not (frac <= 1.0 and math.isfinite(ker)):
        raise SystemExit(f"{what}: train-mode loss, kernels vs plain versions")
    return ker


def ladder_rung(n: int, cfg, ckpt: Path, device, grad_hold: bool = False,
                default: bool = False, account: bool = False,
                holds: bool = True, seen: dict | None = None) -> dict:
    """One rung of phase 14: a synthetic slide of ``n`` nuclei built for
    the card, its band windows as BANDED_NUCLEI says; LADDER_STEPS
    capacity steps (``capacity_per_step`` launches each, ``unbanded``
    without windows; with ``account`` the first under ``memory_account``),
    their median time and peak memory; with ``default`` LADDER_STEPS steps
    of the default (no-chunk) step on the same slide; then, with
    ``holds``, the eval logits and the train-mode loss held against the
    plain versions (with ``grad_hold`` the full ``step_hold`` of phase
    10); with ``seen``, one more forward and backward of the capacity step
    whose kernel inputs ``slide_capture`` keeps there. Returns the rung's
    numbers and launch counts."""
    import torch
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    what = f"{n} nuclei"
    rows = slide_rows(n)
    cap_cfg = cfg.apply_overrides(SLIDE_CAPACITY)
    feats, coords = synthetic_slide(n)
    gc.collect()
    torch.cuda.empty_cache()
    # what earlier phases left allocated: a rung's own peak is above it
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.time()
    build = build_slide_inputs(cap_cfg, feats, coords, 1, device)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    inputs = build.inputs
    banded = inputs.win_base is not None and inputs.win_base_t is not None
    if build.cap != rows or not build.bsr or banded != (n in BANDED_NUCLEI):
        raise SystemExit(f"{what}: {build.cap} rows (want {rows}), block "
                         f"tables {build.bsr}, band windows {banded}")
    inputs_gib = torch.cuda.memory_allocated() / 2**30 - before
    log(f"  {what}: {rows} rows, {build.edges} edges, blocks per row tile "
        f"{inputs.blk_cols.shape[1]} / transpose {inputs.blk_cols_t.shape[1]}"
        f", band windows {banded}; host build graph {build.t_graph_s:.3f} s, "
        f"partition and tables {build.t_part_s:.3f} s, all with the upload "
        f"and B1 {build_s:.3f} s; its inputs {inputs_gib:.3f} GiB on the "
        f"card, which held {before:.3f} GiB before")
    acct: dict = {}
    per = capacity_per_step(rows)
    per = per if banded else unbanded(per)
    torch.cuda.reset_peak_memory_stats()
    counts, ms, rec = slide_train_steps(
        cap_cfg, ckpt, inputs, LADDER_STEPS, per, True, f"capacity {what}",
        memory_account(acct) if account else None, warm=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {what}: the capacity steps' own peak {peak - before:.3f} GiB "
        "(inputs included)")
    out = {"nuclei": n, "rows": rows, "chunks": per["B5"],
           "per_step": per, "edges": build.edges,
           "graph_s": build.t_graph_s, "partition_s": build.t_part_s,
           "build_s": build_s, "before_gib": before,
           "inputs_gib": inputs_gib, "step_ms": ms, "times_ms": rec["times"],
           "losses": rec["losses"], "peak_gib": peak,
           "own_peak_gib": peak - before,
           "counts": counts, "default_counts": expected({})}
    if acct:
        out["account"] = acct
        log(f"  memory account of the first {what} step (caching allocator "
            f"history): peak {acct['peak_gib']:.3f} GiB of live blocks "
            f"({acct['before_gib']:.3f} GiB alive before the step; "
            f"max_memory_allocated {peak:.3f} GiB); {acct['events']} events;"
            " the largest blocks alive at the peak:")
        for b in acct["blocks"]:
            log(f"    {b['gib']:.3f} GiB  {b['where']}"
                + (f"  via {b['via']}" if b["via"] else ""))
    if default:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dcounts, dms, drec = slide_train_steps(
            cfg, ckpt, inputs, LADDER_STEPS, SLIDE_TRAIN_PER_STEP if banded
            else unbanded(SLIDE_TRAIN_PER_STEP), False,
            f"default (no-chunk) {what}", warm=0)
        dpeak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {what}: the default steps' own peak {dpeak - before:.3f} GiB")
        out.update(default_step_ms=dms, default_times_ms=drec["times"],
                   default_peak_gib=dpeak,
                   default_own_peak_gib=dpeak - before,
                   default_counts=dcounts)
    torch.cuda.empty_cache()
    if holds:
        torch.cuda.reset_peak_memory_stats()
        model = slide_model(cap_cfg, ckpt, device)
        logits_hold(model, cap_cfg, inputs, what)
        out["train_loss"] = loss_hold(model, cap_cfg, inputs, what)
        if grad_hold:
            require_step(step_hold(model, cap_cfg, inputs, True,
                                   f"capacity {what}"), f"capacity {what}")
        del model
        out["holds_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {what}: the holds peaked at {out['holds_peak_gib']:.3f} GiB "
            f"({out['holds_peak_gib'] - before:.3f} GiB their own)")
    if seen is not None:
        model = slide_model(cap_cfg, ckpt, device).train()
        with slide_capture(seen):
            slide_grads(model, cap_cfg, inputs, True)
        del model
    del inputs, build
    torch.cuda.empty_cache()
    return out


def ladder_cli(ckpt: Path, device) -> dict:
    """cli.slide at LADDER_TOP nuclei with the capacity recipe and
    ``--train-epochs 1`` (one build, two forwards, one capacity step, one
    forward after it), with its launches, losses, post-fine-tune logits and
    peak memory."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import slide as slide_cli

    rows = slide_rows(LADDER_TOP)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = slide_cli.main([
        "--synthetic", "--nuclei", str(LADDER_TOP), "--shards", "1",
        "--train-epochs", "1", "--ckpt", str(ckpt),
        *(["--cpu"] if device.type == "cpu" else []),
        *SLIDE_DTYPE, *SLIDE_CAPACITY])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    banded = LADDER_TOP in BANDED_NUCLEI
    fwd, per = SLIDE_FORWARD, capacity_per_step(rows)
    fwd, per = (fwd, per) if banded else (unbanded(fwd), unbanded(per))
    want = {k: SLIDE_BUILD.get(k, 0) + 3 * fwd.get(k, 0) + per.get(k, 0)
            for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  cli.slide --nuclei {LADDER_TOP} --train-epochs 1 (the capacity "
        f"recipe): {wall:.1f} s wall; graph {res['t_graph_s']:.3f} s, "
        f"partition {res['t_part_s']:.3f} s (host clock); losses "
        f"{res['losses']}, post-fine-tune logits "
        f"{res['logits_finetuned'].tolist()}; peak memory {peak:.3f} GiB; "
        f"launches {counts}")
    if counts != want:
        raise SystemExit(f"cli.slide at {LADDER_TOP}: launches {counts} != "
                         f"{want}")
    if (res["cap"] != rows or not res["bsr"]
            or not np.isfinite(res["losses"]).all()
            or not np.isfinite(res["logits_finetuned"]).all()
            or res["logits_finetuned"].shape != (3,)):
        raise SystemExit(f"cli.slide at {LADDER_TOP}: {res}")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "graph_s": res["t_graph_s"],
            "partition_s": res["t_part_s"], "losses": res["losses"],
            "logits_finetuned": res["logits_finetuned"].tolist(),
            "peak_gib": peak, "counts": counts}


def ladder_kernels(seen: dict, n: int) -> list[dict]:
    """B2's wide legs (F >= BAND_MIN_F: A @ S, and its transpose where its
    shapes differ, B8's legs on the banded 100k slide) as the capacity step
    of the ``n``-nuclei rung gave them (``seen``), held against the plain
    version and timed like phase 3, in bf16 (the path's type)."""
    import torch
    from cgcnet_tpu_torch.ops import bsr

    t = bsr.TILE
    results = []
    for (key, _, _), (args, _) in seen.items():
        if key != "B2" or args[2].shape[-1] < bsr.BAND_MIN_F:
            continue
        vals, bc_, x, slots = args
        _, r, m = bc_.shape
        nc, f = x.shape[1], x.shape[2]
        live = vals.reshape(*vals.shape[:3], -1).ne(0).any(-1)
        nnzb = int(live.sum().item())
        walked = int(slots.sum().item())
        leg = "A^T" if results else "A@S"  # the forward's leg comes first
        record_kernel(
            results, f"B2 bsr_matmul int8 {leg} bf16 {n} nuclei N={nc} M={m} "
            f"live slots {walked} of {r * m} F={f}", "B2", "bfloat16",
            bsr.bsr_matmul(vals, bc_, x, slots),
            bsr.bsr_matmul_plain(vals, bc_, x, slots),
            lambda: bsr.bsr_matmul(vals, bc_, x, slots),
            lambda: bsr.bsr_matmul_plain(vals, bc_, x),
            bytes_=nnzb * t * t + r * m * 4 + (nc + r * t) * f * x.element_size(),
            ops=2 * nnzb * t * t * f,
            library=lambda: _bsr_library_call(vals.to(x.dtype), bc_,
                                              live.float(), x),
            source="cgcnet_tpu_torch/csrc/bsr_matmul.cu",
            replaces="cgcnet_tpu/ops/pallas/bsr_kernel.py:400",
            paths=SLIDE_PATHS, reps=10, plain_reps=3)
        torch.cuda.empty_cache()
    if not results:
        raise SystemExit(f"{n} nuclei: no wide B2 leg captured")
    return results


def ladder_top_kernels(seen: dict, n: int) -> tuple[list[dict], dict]:
    """B9a (the capacity forward's call over every row), B9b (and its
    statistics hold: the sums against the exact f64 sums, between the two
    witnesses) and B5 (each capacity chunk's call) as the capacity step of
    the ``n``-nuclei rung gave them (``seen``), held against their plain
    versions and timed like phase 3, in bf16 (the path's type)."""
    import torch

    results = []

    def record(*args, **kwargs):
        record_kernel(results, *args, paths=SLIDE_PATHS, reps=5,
                      plain_reps=2, **kwargs)

    def calls(key):
        return [v for (k, _, _), v in seen.items() if k == key]

    what = f"{n} nuclei "
    b9a, b9b, b5 = calls("B9a"), calls("B9b"), calls("B5")
    if not (b9a and b9b and b5):
        raise SystemExit(f"{what}: captured B9a {len(b9a)}, B9b {len(b9b)}, "
                         f"B5 {len(b5)} calls")
    record_b9a(record, max(b9a, key=lambda v: v[0][1].shape[1])[0],
               torch.bfloat16, what)
    torch.cuda.empty_cache()
    record_b9b(record, b9b[0][0], torch.bfloat16, what)
    x3, kc3, b3, nn9 = b9b[0][0]
    stats = stats_hold(None, None, (x3, kc3, b3), nn9)
    torch.cuda.empty_cache()
    for args, _ in b5:
        record_b5(record, args, torch.bfloat16, f"{what}chunk")
    return results, stats


def ladder_phase(tmp: Path, device, ckpt: Path) -> dict:
    """Phase 14 (see the module docstring). Returns the ladder's numbers
    and its launch counts per path."""
    import torch
    from cgcnet_tpu_torch.config import Config

    log(f"phase 14: the capacity ladder ({', '.join(map(str, LADDER_NUCLEI))}"
        f" nuclei, bf16, {' '.join(SLIDE_CAPACITY)}; {card_line()})")
    t_phase = time.time()
    cfg = Config().apply_overrides(SLIDE_DTYPE)
    torch.cuda.empty_cache()
    paths = {"slide_ladder": expected({}), "slide_ladder_default": expected({})}
    rungs, kernels, stats = [], [], None
    for n in (SLIDE_NUCLEI, *LADDER_NUCLEI):
        # phase 10 holds the 100k slide: here its steps alone, for the fit
        seen = {} if n in (LADDER_KERNELS, LADDER_TOP) else None
        r = ladder_rung(n, cfg, ckpt, device, grad_hold=n in LADDER_GRAD_HOLD,
                        default=n == LADDER_DEFAULT, account=n == LADDER_TOP,
                        holds=n in LADDER_NUCLEI, seen=seen)
        if seen is not None:
            if n == LADDER_KERNELS:
                kernels += ladder_kernels(seen, n)
            if n == LADDER_TOP:
                top, stats = ladder_top_kernels(seen, n)
                kernels += top
            # slide_capture's shims hold ``seen`` in a reference cycle
            del seen
            gc.collect()
            torch.cuda.empty_cache()
        _add(paths["slide_ladder"], r.pop("counts"))
        _add(paths["slide_ladder_default"], r.pop("default_counts"))
        rungs.append(r)
    cli = ladder_cli(ckpt, device)
    paths["slide_ladder_cli"] = cli.pop("counts")
    fit = peak_fit([(r["rows"], r["own_peak_gib"]) for r in rungs])
    wall = time.time() - t_phase
    log(f"  capacity step's own peak = {fit['fixed_gib']:.3f} GiB + "
        f"{fit['bytes_per_row']:.1f} bytes a row (least squares over "
        f"{len(rungs)} rungs, worst residual {fit['max_residual_gib']:.3f} "
        f"GiB); phase 14 wall {wall:.1f} s")
    summary = {"card": card_line(), "fit": fit, "cli": cli, "rungs": [
        {k: v for k, v in r.items() if k not in ("account", "per_step")}
        for r in rungs]}
    log("  ladder " + json.dumps(summary))
    return {"ladder": {**summary, "account": next(
        (r["account"] for r in rungs if "account" in r), None),
        "stats_hold_top": stats, "wall_s": wall}, "paths": paths,
        "kernels": kernels}


# ---------------------------------------------------------------------------
# phase 15: the slide CLI's defaults — f32, 100k nuclei, one shard
# ---------------------------------------------------------------------------

def f32_step_hold(model, cfg_, inputs, remat, what) -> dict:
    """One f32 slide step's loss and gradients, every kernel against every
    plain version on the card, at the f32 rules — the loss as the logits
    (LOGIT_ATOL/LOGIT_RTOL), each gradient at GRAD_REL/GRAD_FLOOR, nothing
    widened. The gradients are held on the plain step replayed with the
    kernel step's max-readout routing (``readout_routing``), whose moves
    are bounded by READOUT_STEPS and READOUT_SHARE as in ``step_hold``; the
    gradients as each side routes its own readouts are logged beside.
    Returns what ``step_verdict`` reads."""

    def grads(replace, mode=None):
        with sites_replaced(replace), (mode if mode is not None
                                       else contextlib.nullcontext()):
            return slide_grads(model, cfg_, inputs, remat)

    routing = readout_routing()
    g_ker = grads(every_kernel, routing)
    g_plain = grads(all_plain)
    lim = LOGIT_ATOL + LOGIT_RTOL * abs(g_plain[0])
    log(f"  {what} one step: loss {g_ker[0]:.7f} (kernels) vs "
        f"{g_plain[0]:.7f} (plain versions on the card); tol {lim:.3e} "
        f"({abs(g_ker[0] - g_plain[0]) / lim:.3f} of it)")
    unrouted = grads_close(
        f"{what} step gradients, readouts as each side routes them (logged, "
        "not held)", g_ker[1], g_plain[1], GRAD_REL, strict=False)
    replayed = grads(all_plain, routing.replay())
    moves = routing.moves[0]
    log(f"  {what}: the plain step's readouts routed as the kernel step's: "
        + "; ".join(f"readout {i}: {n} of {cols} columns moved, worst gap "
                    f"{gap:.2f} bf16 steps"
                    for i, (cols, n, gap) in enumerate(moves))
        + f" (limits {READOUT_STEPS:g} steps, {READOUT_SHARE:g} of the "
        f"columns); replayed loss {replayed[0]:.7f}")
    worst = grads_close(
        f"{what} step gradients, kernels vs plain versions on the card "
        "(readouts routed as the kernel step's)", g_ker[1], replayed[1],
        GRAD_REL, strict=False)
    return {"loss": abs(g_ker[0] - g_plain[0]) / lim, "worst": worst[0],
            "grad": worst[1], "unrouted": unrouted[1],
            "steps": max([0.0] + [gap for _, _, gap in moves]),
            "share": max([0.0] + [n / cols for cols, n, _ in moves]),
            "finite": all(torch_isfinite(g) for g in g_ker[1].values())}


def f32_phase(tmp: Path, device, ckpt: Path) -> dict:
    """Phase 15 (see the module docstring). Returns its numbers and the
    launch counts of its paths."""
    import numpy as np
    import torch
    from cgcnet_tpu_torch.cli import slide as slide_cli
    from cgcnet_tpu_torch.config import Config
    from cgcnet_tpu_torch.parallel.mega_model import mega_forward
    from cgcnet_tpu_torch.parallel.slide_setup import (
        build_slide_inputs,
        synthetic_slide,
    )

    cfg = Config()
    log(f"phase 15: the slide CLI's defaults (Config(): "
        f"{cfg.model.compute_dtype}, {SLIDE_NUCLEI} nuclei, one shard, "
        f"phase 4's checkpoint; {card_line()})")
    if cfg.model.compute_dtype != "float32":
        raise SystemExit(f"the default compute dtype is "
                         f"{cfg.model.compute_dtype}, not float32")
    t_phase = time.time()
    # SLIDE_NUCLEI is the CLI's default --nuclei; no dtype override
    base = ["--synthetic", "--nuclei", str(SLIDE_NUCLEI), "--shards", "1",
            "--ckpt", str(ckpt), *(["--cpu"] if device.type == "cpu" else [])]
    out: dict = {"card": card_line()}

    def cli(argv, want, what):
        zero_counts()
        t0 = time.time()
        res = slide_cli.main([*base, *argv])
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: want.get(k, 0) for k in KERNELS}
        log(f"  cli.slide {' '.join(argv)}: {time.time() - t0:.1f} s wall; "
            f"logits {res['logits'].tolist()}; launches {counts}")
        if counts != want:
            raise SystemExit(f"phase 15 {what}: launches {counts} != {want}")
        if (res["cap"] != SLIDE_CAP or not res["bsr"]
                or not np.isfinite(res["logits"]).all()
                or res["logits"].shape != (3,)):
            raise SystemExit(f"phase 15 {what}: {res}")
        return res, counts

    # ---- serving: cli.slide at its defaults, a stream ----
    builds, forwards = 1 + F32_STREAM, 2 + F32_STREAM
    res, serve = cli(["--slides", str(F32_STREAM)], {
        k: SLIDE_BUILD.get(k, 0) * builds + F32_FORWARD.get(k, 0) * forwards
        for k in KERNELS}, "serving")
    log(f"  {builds} builds x {SLIDE_BUILD} + {forwards} forwards x "
        f"{F32_FORWARD} (B8 = 0: f32 takes no B8 leg); forward "
        f"{res['t_fwd_s'] * 1e3:.1f} ms (host clock), stream "
        f"{res['slides_per_s']:.3f} slides/s")
    paths = {"slide_f32_serve": serve}
    feats, coords = synthetic_slide(SLIDE_NUCLEI)
    build = build_slide_inputs(cfg, feats, coords, 1, device)
    inputs = build.inputs
    model = slide_model(cfg, ckpt, device)
    with torch.no_grad():
        out["forward_ms"] = time_ms(
            lambda: mega_forward(model, cfg.model, inputs), reps=5, warmup=1)
    log(f"  f32 forward {out['forward_ms']:.3f} ms (median of 5, CUDA "
        "events)")
    logits = logits_hold(model, cfg, inputs, "f32 slide")
    if int(logits.argmax()) != res["pred"]:
        raise SystemExit("phase 15: the held logits' grade is not cli.slide's")

    # ---- the default (no-chunk) step and the capacity recipe, in f32 ----
    cap_cfg = cfg.apply_overrides(SLIDE_CAPACITY)
    for name, c, remat, n_steps, per in (
            ("train", cfg, False, F32_TRAIN_STEPS, F32_TRAIN_PER_STEP),
            ("capacity", cap_cfg, True, F32_CAP_STEPS, F32_CAP_PER_STEP)):
        what = f"f32 {'no-chunk' if name == 'train' else 'capacity'}"
        r = f32_step_hold(model, c, inputs, remat, what)
        require_step(r, what)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        paths[f"slide_f32_{name}"], ms, rec = slide_train_steps(
            c, ckpt, inputs, n_steps, per, remat, what)
        out[f"{name}_step_ms"] = ms
        out[f"{name}_times_ms"] = rec["times"]
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"{name}_hold"] = {k: v for k, v in r.items() if k != "finite"}
    del model, inputs, build
    torch.cuda.empty_cache()

    # ---- cli.slide --train-epochs 1 --out, the written file served ----
    ft = tmp / "slide_f32_finetuned.pt"
    res_ft, counts = cli(["--train-epochs", "1", "--out", str(ft)], {
        k: SLIDE_BUILD.get(k, 0) + 3 * F32_FORWARD.get(k, 0)
        + F32_TRAIN_PER_STEP.get(k, 0) for k in KERNELS}, "fine-tune")
    _add(paths["slide_f32_train"], counts)
    res_back, counts = cli(["--ckpt", str(ft)], {
        k: SLIDE_BUILD.get(k, 0) + 2 * F32_FORWARD.get(k, 0)
        for k in KERNELS}, "serving the fine-tuned file")
    _add(paths["slide_f32_serve"], counts)
    log(f"  fine-tune losses {res_ft['losses']}, fine-tuned logits "
        f"{res_ft['logits_finetuned'].tolist()}; served from the written "
        f"file {res_back['logits'].tolist()}")
    if not (np.isfinite(res_ft["losses"]).all()
            and np.array_equal(res_ft["logits_finetuned"], res_back["logits"])):
        raise SystemExit("phase 15: cli.slide fine-tune round trip")
    out["wall_s"] = time.time() - t_phase
    log(f"  phase 15 ({card_line()}): f32 forward {out['forward_ms']:.3f} "
        f"ms; no-chunk step {out['train_step_ms']:.3f} ms, peak "
        f"{out['train_peak_gib']:.3f} GiB; capacity step "
        f"{out['capacity_step_ms']:.3f} ms, peak "
        f"{out['capacity_peak_gib']:.3f} GiB; phase wall "
        f"{out['wall_s']:.1f} s")
    return {"slide_f32": out, "paths": paths}


def tail_per_call(rows: int, chunk: int) -> dict:
    """B3/B4/B5 launches of one forward and backward of
    ``assign_tail_train_chunked`` over ``rows`` rows in chunks of
    ``chunk`` (``chunk_plan``: k chunks): B3 and B4 once in the forward,
    then on each chunk B4 twice (phases A and B recompute S) and B5 once."""
    from cgcnet_tpu_torch.ops.assign_head import chunk_plan

    _, nfull, rem = chunk_plan(rows, chunk)
    k = nfull + (1 if rem else 0)
    return {"B3": 1, "B4": 1 + 2 * k, "B5": k}


def tail_inputs(b: int, n: int, n_nodes: list, dt, device, seed: int = 11):
    """Seeded operands of the chunked tail at [b, n] rows, C =
    CANONICAL["C"], F12 = TAIL_F12: (x12, p, k12, k3, lin_bias, bn_scale,
    bn_bias, n_nodes, n, dS), rows past n_nodes zero as the convs leave
    them; x12, p and dS in ``dt``. The assign lin's kernel and bias at its
    initialisation's scale (1 / sqrt(fan-in)), so the logits are of order
    one, as a model's are: with unit-scale weights they reach ~10 and f32
    S parts by 2e-5 between right computations."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    c = CANONICAL["C"]
    lin = (TAIL_F12 + c) ** -0.5

    def g(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=device) * sc

    nn_ = torch.tensor(n_nodes, dtype=torch.int32, device=device)
    rows = (torch.arange(n, device=device)[None] < nn_[:, None]).float()
    return ((g(b, n, TAIL_F12) * rows[..., None]).to(dt),
            (g(b, n, c) * rows[..., None]).to(dt), g(TAIL_F12, c, sc=lin),
            g(c, c, sc=lin), g(c, sc=lin), 1.0 + g(c, sc=0.1),
            g(c, sc=0.1), nn_, nn_.sum().float(), g(b, n, c).to(dt))


def tail_call(args, chunk: int) -> tuple:
    """One forward and backward of ``assign_tail_train_chunked``: (S,
    mean, var, and the gradients of sum(S * dS) in x12, p, k12, k3,
    lin_bias, bn_scale, bn_bias)."""
    import torch
    from cgcnet_tpu_torch.ops import assign_head as ah

    *ops, n_nodes, n, ds = args
    v = [t.detach().requires_grad_(True) for t in ops]
    s, mean, var = ah.assign_tail_train_chunked(*v, n_nodes, n, 1e-5,
                                                chunk_rows=chunk)
    return (s.detach(), mean, var, *torch.autograd.grad(s, v, ds))


# each output of the chunked tail at the rule of the kernel it comes from:
# S B4's, the statistics B3's, every gradient B5's (the widest of the three)
TAIL_RULE = ("B4", "B3", "B3", "B5", "B5", "B5", "B5", "B5", "B5", "B5")
TAIL_OUTPUTS = ("S", "mean", "var", "dx12", "dp", "dk12", "dk3",
                "dlin_bias", "dbn_scale", "dbn_bias")


def tail_phase(device) -> tuple[list[dict], dict]:
    """Phase 16 (see the module docstring). Returns its kernel-line
    entries and the launch counts of its paths."""
    import torch

    log(f"phase 16: assign_tail_train_chunked vs its plain version "
        f"({card_line()})")
    b, n, c = CANONICAL["B"], CANONICAL["N"], CANONICAL["C"]
    shapes = (("chunked_tail_patch", b, n, [n - 37 * i for i in range(b)],
               TAIL_PATCH_CHUNK),
              ("chunked_tail_slide", 1, SLIDE_CAP, [SLIDE_NUCLEI], CAP_CHUNK))
    entries, paths = [], {}
    for path, bb, rows, n_nodes, chunk in shapes:
        paths[path] = dict.fromkeys([*KERNELS, "tail"], 0)
        want = tail_per_call(rows, chunk)
        for dt in (torch.float32, torch.bfloat16):
            dt_name, tag, isz = _dtype_tag(dt)
            args = tail_inputs(bb, rows, n_nodes, dt, device)
            zero_counts()
            got = tail_call(args, chunk)
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != {k: want.get(k, 0) for k in KERNELS}:
                raise SystemExit(f"phase 16 {path} {tag}: launches {counts} "
                                 f"!= {want}")
            _add(paths[path], counts)
            paths[path]["tail"] += sum(counts.values())
            with sites_replaced(all_plain):
                ref = tail_call(args, chunk)
            errs = {}
            for name, key, o, r in zip(TAIL_OUTPUTS, TAIL_RULE, got, ref):
                err = (o.float() - r.float()).abs().max().item()
                tol = TOL[(key, dt_name)] * r.float().abs().max().item()
                errs[name] = err
                if not err <= tol:
                    raise SystemExit(f"phase 16 {path} {tag}: {name} "
                                     f"{err:.3e} > {tol:.3e}")
            ms = time_ms(lambda: tail_call(args, chunk), reps=10)
            with sites_replaced(all_plain):
                plain_ms = time_ms(lambda: tail_call(args, chunk), reps=3,
                                   warmup=1)
            rr = sum(n_nodes)
            f12 = TAIL_F12
            # each input read once (x12, p, dS on real rows; the [C]-sized
            # operands), each output written once (S, dx12, dp; the [C]-sized
            # gradients); the products the function needs once: the
            # forward's logits, and the backward's dx12, dk12, dh, dk3f
            bytes_ = (rr * (f12 + 2 * c) + bb * rows * (f12 + 2 * c)) * isz \
                + 2 * (f12 * c + c * c + 3 * c) * 4
            ops = 2 * rr * c * (3 * f12 + 3 * c)
            t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[dt_name] * 1e3
            entries.append({
                "name": f"assign_tail_train_chunked (B3, B4, B5) {tag} "
                        f"B={bb} N={rows} C={c} chunk={chunk}",
                "route": "cuda",
                "source": "cgcnet_tpu_torch/ops/assign_head.py",
                "replaces": "cgcnet_tpu/ops/pallas/assign_head.py:687",
                "launches": None, "max_abs_err": max(errs.values()),
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "key": "tail", "paths": (path,),
                "launches_per_call": want, "max_abs_err_by_output": errs,
            })
            log(f"  {entries[-1]['name']}: launches {want} a call; "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; {ms:.3f} ms with the kernels, plain {plain_ms:.3f} ms, "
                f"bound {entries[-1]['bound_ms']:.4f} ms "
                f"({entries[-1]['bound_by']})")
            del args, got, ref
            torch.cuda.empty_cache()
    return entries, paths


# the kernels whose compiler report phase 2 must hold: the bf16
# tensor-core kernels, the heads' f32 product on the CUDA cores, and the
# gathers over the nonzeros (B7, B8's SIMT kernel)
TC_KERNELS = ("banded_tc_kernel", "gemm_tc_kernel", "bsr_matmul_tc_kernel",
              "gemm_kernel", "banded_kernel", "bsr_gather_kernel")


def tc_report(build_log: str) -> None:
    """Registers and spills of every instantiation of TC_KERNELS from the
    compiler's ``-Xptxas -v`` report; fails when one has no entry."""
    lines = build_log.splitlines()
    for name in TC_KERNELS:
        found = []
        for i, line in enumerate(lines):
            if "Compiling entry" not in line or name not in line:
                continue
            spill = regs = "?"
            for nxt in lines[i + 1:i + 5]:
                if "spill" in nxt:  # "... N bytes spill stores, M bytes ..."
                    w = nxt.replace(",", " ").split()
                    spill = "/".join(w[j - 2] for j, t in enumerate(w)
                                     if t == "spill")
                if "Used" in nxt and "registers" in nxt:
                    regs = nxt.split("Used")[1].split("registers")[0].strip()
            found.append(f"{regs} regs, spill bytes {spill}")
        if not found:
            raise SystemExit(f"phase 2: no compiler report for {name}")
        log(f"  {name}: {len(found)} instantiations: " + "; ".join(found))
    # ptxas's note when it has to wait for each product before the next
    serial = [ln for ln in lines if "C7515" in ln]
    log(f"  products serialized by the compiler: {len(serial)} functions"
        + "".join(f"\n    {ln.strip()[:200]}" for ln in serial[:4]))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "cgcnet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no cgcnet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: device")
    smi = card_line()
    log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    log("phase 2: build kernels (nvcc, sm_90a)")
    from cgcnet_tpu_torch.ops import _cuda

    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.library()
    log(f"  built {lib_path.name} in {time.time() - t0:.1f} s")
    build_log = (_cuda.BUILD_DIR / "build.log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())
    tc_report(build_log)

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        numbers = slice_phase(Path(tmp), device)
    print(json.dumps(numbers))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
