#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain PyTorch version on the card (the gossip kernels also
timed on the device alone, from a CUDA graph), then drives the main
path — `repro_torch.core.multiscale_gossip`, the paper's Algorithm 1 in
its fixed-iterations large-n configuration, each chunk drawn by the
`sample_chunk` kernel and walked by `pair_apply` — at n=10^5 and n=10^6
nodes, fig5's priced failure-scenario matrix (`run_scenario_matrix`) at
n=10^5 with `sample_chunk` in its scenario and cost mode, the matmul
backend at n=20000 (also under churn and Byzantine scenarios),
`synchronous_multiscale` at n=2000, and the baselines (`standard_gossip`
at n=500 on the card, fig5's path averaging on the host), and checks the
results against the repository's recorded message counts and errors
and against the plain backend on the card (the sample_chunk op's device
time held to 2.0x its bound in plain mode and 3.0x with the stragglers
scenario and the cost model).  Then the rwkv6-3b serving path at full
width and depth, with parameters drawn on the card from a seed:
`forward` on 4 prompts of 4096 tokens (one rwkv6 kernel launch per
layer, finite logits, a traced run), `Generator` answering 8 requests
through decode alone (no rwkv6 launch), and forward against
token-by-token decode in bf16 (reported) and in a float32 copy of the
model (checked).  Then the flash-attention
kernels against their plain version at 18 shapes and the prefill's
again in f32 (bf16 on the wgmma kernel, f32 on the FMA kernel; both
timed at the prefill's shape, the f32 one held to 1.6x its bound), and
the llama3.2-3b serving path at full width and depth: `forward` on 4
prompts of 4096 tokens (one launch of the bf16 flash kernel per layer,
finite logits, a traced run), `Generator` on 8 requests (no flash
launch), and each block's attention
on the kernel route against `decode_attention` fed token by token, in
bf16 (reported) and in a float32 copy (checked).  The serving fleet:
the legacy per-tick schedule at n=10^5 (one cell_mixing launch a chunk
on backend "cuda"), `ControlPlane` rounds at R=16 and 1024 (sample_chunk
and pair_apply once a chunk, bitwise to the plain backend, R=1024 held
to the reference's counts), `run_fleet` at R=16 against the recorded
`BENCH_serve.json` entry for each router and at R=256, and for
llama3.2-3b and rwkv6-3b at full size the paged decode step (bitwise to
the dense one for llama3.2-3b) and the continuous-batching engine on a
stream that retires and refills slots (replays bitwise, no kernel
launch).  Then the zoo's other block kinds: the flash kernels at the
prefill shapes of recurrentgemma-9b's local layers (window 2048, head
256, one KV head), gemma2-27b's local and global layers (softcap 50)
and grok-1-314b's (softcap 30) against the plain version, timed beside
their bound and SDPA where one call computes the same function, each
again in f32 on the FMA kernel (recurrentgemma's held to 2.0x its
bound);
recurrentgemma-9b at full width and depth (`forward` 4x4096 with one
flash launch a local layer, `Generator`, the paged step bitwise to the
dense one, the paged engine, and every rglru and local block of an f32
copy on its forward route against decode, one local block past its
window), gemma2-27b at full width and 8 layers (`forward` 1x8192, so the
window bites) and grok-1-314b at full width and 4 layers (`forward`
2x4096 through the MoE feed-forward), each with `Generator` and the
per-block agreement of an f32 copy.  Training also takes one
`make_train_step` step of llama3.2-3b at full size over 1 x 4096 tokens
(T1L), past `chunk_threshold`, where every layer trains through
`chunked_attention` (no kernel).  Last, `chunked_attention` against
`full_attention` on the card in f32, outputs and gradients (X1:
llama3.2-3b causal self-attention and whisper-tiny's cross-attention
over 4096 frames), whisper-tiny at full size (W1: `forward` on 4 x 4096
decoder tokens over 1500 frames each, one bf16 flash launch a decoder
layer; `Generator` with frames; an f32 copy's per-block agreement with
each block cross-attending to the encoder's output), and qwen2-vl-72b
at full width and 4 layers (Q1: prefill 1 x 4096 at M-RoPE positions
through `chunked_attention`, no kernel launch, and one f32 block's
attention there against `full_attention`).  The sharded executors run
right after the per-tick phase, as processes of one gloo group sharing
the card (NCCL takes one rank a card; started with `spawn`, meeting
through a file store, each group under a timeout; they load the kernels
the script built): M1 the n=10^5 FI configuration's 6 trials on a
4-rank trial mesh and M2 3 of them on a 2 x 2 ("trials", "nodes")
mesh, bitwise to the unsharded run with 33 launches of `sample_chunk`
and `pair_apply` in each rank; M4 `make_decentralized_step` on a
4-rank replica mesh at llama3.2-3b width against the dense step at
R=4 (in the same group); M3 `execute_sync_sharded` on 8 ranks in eight
sync modes against `execute_sync` on the card.  Then model sharding over
a (data, model) mesh, in one more 4-rank group: S1 llama3.2-3b's sharded
prefill at full width (2 layers, 4 x 4096 on 2 x 2, one bf16 flash
launch a layer in each rank on its heads; an f32 copy's blocks against
the unsharded model), S2 one sharded AdamW step (2 layers, f32) against
the unsharded step, S3 its state saved and restored onto a 4 x 1 mesh,
bitwise, and on the same mesh S4 recurrentgemma-9b (3 layers: its one
KV head does not divide "model", so each rank's local layer attends
over its share of the (row, query head) units in one bf16 flash launch)
and S5 rwkv6-3b (4 layers, 20 heads a rank, one wkv launch a layer),
each prefilling 4 x 4096 at full width, then an f32 copy's blocks and 8
decode steps from a sharded cache against the unsharded model; S2A one
sharded Adafactor step (S2's model) against the unsharded one; S6
grok-1-314b (2 layers, 4 x 4096 on 2 x 2, its 8 experts split by d_ff),
S7 llama4-maverick (1 layer with all 128 experts, 2 x 4096 on 1 x 4, 32
experts a rank) and S8 whisper-tiny uncut (4 x 4096 over 1500 frames on
2 x 2), each with its bf16 flash launches counted and an f32 copy's
blocks and 8 decode steps against the unsharded model, which the
parent runs and frees first.  None of them times a collective.  Then
D1, the dry run (`repro_torch.launch.dryrun`, host-only, its traces in a
process of its own): S1's cell traced on a fake process group of 4,
held against S1's rank 0 (the flash launches a rank and the collective
account equal, the predicted peak within 25% of the measured one);
`run_cell` at full size on the 16 x 16 mesh for llama3.2-3b's
prefill_32k and train_4k, each ending "ok", train_4k predicting at most
9.0 GiB a device (the hidden state between blocks split over "model",
so remat keeps 1/16 of each block's input); and S2's cell (the f32
sharded train step) traced on a fake group of 4, held against S2's rank
0 as S1's is.  Last, E1: the six example
scripts (`examples/torch_*.py`) in-process on the card at tools/ci.sh's
smoke sizes, each with its own checks, train_lm resuming from its saved
step, every figure finite.  Any failed check raises,
and the script exits non-zero.

Output: progress lines, the card's name and power limit, one JSON line
``{"kernels": [...]}`` (per kernel: its launches on each path that runs
it, each path counted on its own, error against its plain version, its
time, the plain version's, the least time the card could take, and a
PyTorch library call's where one exists), and
last ``{"ok": true, "device": {...}}``.  The measurements also go to
``chiprun_out/chip_smoke.json``.  Without CUDA, or without the rest of
the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the large-n fixed-iterations configuration (benchmarks/large_n.py):
# weighted, fixed_ticks_scale=0.2, eps=1e-3, graph_seed=1000+n, seed=0,
# x0 = default_rng(n).normal(0, 1, n); recorded messages and errors
LARGE_N = {
    20_000: (1_008_706, 0.0017078202335822647),
    100_000: (4_230_486, 0.000994252358016139),
    1_000_000: (79_785_918, 0.0003279788359757681),
}
FI = dict(eps=1e-3, seed=0, weighted=True, fixed_ticks_scale=0.2)
# pair_apply launches of one FI trial: at n=10^5, 1 chunk on each of the
# four finest levels, 3 on level 4, 26 on the top level; sample_chunk
# launches once a chunk as well
MAIN_PATH_LAUNCHES = {100_000: 33, 1_000_000: 120}
# device launches in the traced n=10^5 FI trial, all kinds together: at
# most this many (26112 while each chunk's draw ran as eager torch ops);
# the traced churn + cost scenario run is held to the same
MAIN_TRACE_LAUNCHES = 3000
# the failure-scenario configuration: benchmarks/fig5_failures.py:121-128
# prices the scenario matrix with CostModel(retransmit_p=0.9,
# congestion_alpha=0.01) over scenario_matrix()'s defaults; here on the
# n=10^5 large-n plan at the FI settings above, 2 trials
SCENARIO_COST = dict(retransmit_p=0.9, congestion_alpha=0.01)
SCENARIO_TRIALS = 2
# fig5 (benchmarks/fig5_failures.py: n=2000, graph seed 21, x0 =
# default_rng(3).normal(0, 1, n), eps 1e-4, seeds 0-2): the reliable
# path-averaging and multiscale messages recorded in
# benchmarks/artifacts/fig5_failures.json
FIG5_PATH_AVERAGING = [180806, 170008, 182362]
FIG5_MULTISCALE = [126892, 127012, 127188]
# pair_apply's device time at the n=10^5 finest level, at most this
# multiple of its bound
PAIR_APPLY_BOUND_LIMIT = 2.0
# sample_chunk's device time at the same level (T=50, R=1, B=43250, C=9),
# at most this multiple of its bound: plain mode, and the op with the
# stragglers scenario and SCENARIO_COST (the kernel, the concurrency
# pairs' kernel and the zeroing of the attempts a tick)
SAMPLE_CHUNK_BOUND_LIMIT = 2.0
SAMPLE_CHUNK_SCENARIO_BOUND_LIMIT = 3.0
SYNC_CHUNK = 8  # synchronous_multiscale's rounds per cell_mixing launch
# rwkv6-3b serving (src/repro/configs/rwkv6_3b.py, full width and depth):
# prefill on 4 prompts of 4096 tokens (a cut from prefill_32k's 32 x
# 32768: the f32 logits alone are 4.3 GB at 4 x 4096), Generator on 8
# requests of 64 prompt tokens and 32 greedy steps, forward vs decode on
# 2 x 64 tokens
MODEL_SEED = 0
PREFILL = (4, 4096)
SERVE = (8, 64, 32)
AGREE = (2, 64)
# wkv kernel vs plain version, allclose in the working type: f32 sums in
# another order; bf16 output rounds to 2^-8 of its value
RWKV6_TOL = {"bfloat16": 2e-2, "float32": 3e-4}
# the wkv kernel at the prefill's shape (160, 4096, 64) takes at most this
# many ms: under half of the first design's 2.05 ms
RWKV6_LIMIT_MS = 1.0
# forward vs decode_step in a float32 copy of the config: each block
# through its kernel (rwkv6's wkv; flash attention, forced onto its route
# with chunk_threshold=0) against decode (the wkv recurrence; the KV
# cache and decode_attention).  Each block alone, fed the same input on
# both paths, agrees to f32 rounding: rtol and atol 1e-4.  Through the
# whole stack the randomly drawn model amplifies any difference layer by
# layer (the agreement phase prints the hidden-state gap after every
# block and its growth a layer), so the logits are held only to a max
# abs difference of 0.25 (0.090 on an H100 for rwkv6-3b at 32 layers).
# In bf16 both are reported only: the two paths round at other places.
AGREE_F32_TOL = {"block": 1e-4, "logits": 0.25}
# llama3.2-3b serving (src/repro/configs/llama3_2_3b.py, full width and
# depth): the same prefill, serving and agreement sizes as rwkv6-3b.  The
# prefill is a cut from prefill_32k's 32 x 32768: its f32 logits alone
# would be 538 GB there and are 8.4 GB at 4 x 4096.
# flash kernel vs plain version, allclose at the reference kernel tests'
# tolerances (tests/test_kernels.py): f32 2e-5, bf16 3e-2.  The bf16 limit
# is as large as a typical output at the prefill's shape, so that shape
# is also checked in f32, on the same inputs, at 2e-5.
FLASH_TOL = {"bfloat16": 3e-2, "float32": 2e-5}
# the bf16 kernel rounds P to bf16 before the P V product, which adds
# about the output's own bf16 rounding: at the prefill shape its mean
# abs error against the f32 plain version is held to 2.5x that of the
# plain version's output rounded to bf16
FLASH_BUDGET = 2.5
# the bf16 kernel at the prefill shape takes at most 3x SDPA's time in
# the same run
FLASH_SDPA_LIMIT = 3.0
# the f32 kernel takes at most this many times its bound (the kept
# pairs' 4 D operations at the f32 FMA rate) at the llama3.2-3b prefill
# shape and at recurrentgemma-9b's local shape (Z0)
FLASH_F32_LIMIT = {"llama3.2-3b": 1.6, "recurrentgemma-9b local": 2.0}
# training (src/repro/configs/llama3_2_3b.py; the port has no JAX
# backward kernel to hold, so no kernel runs here).  T1 at full width
# (d 3072, vocab 128256, bf16, remat on), its depth cut to TRAIN["layers"]
# of 28 layers: AdamW (weight decay 0.01) on a cosine schedule,
# SyntheticLM sequences of 1024 tokens, global batch 2, the Trainer run
# for 3 steps with a checkpoint every 2 and killed at the start of step
# 4, then a second Trainer that resumes at step 2 and takes step 3 again,
# killed there too.  Each kill comes before the final save: the chip
# machine lets a call write 45 GiB to its disk.  One checkpoint of this
# state is 9.6 GB; at all 28 layers it is 38.5 GB, and its save and
# restore take ~100 s of the script's time limit on a slow host, so the
# depth is cut (T1L trains the full size)
TRAIN = dict(layers=4, seq=1024, batch=2, steps=3, save_every=2)
TRAIN_LR = (3e-5, 1, 10)  # cosine_schedule(base_lr, warmup, total)
# the resumed step 3's loss against the uninterrupted run's, relative: not
# bitwise in general, since the gradient sums on the card (the embedding
# gather's backward, the GEMMs' split reductions) may take another order
# from run to run, though the resumed state is bitwise the saved one
TRAIN_RESUME_RTOL = 1e-3
# T1b: llama3.2-3b width at 2 layers, f32, TF32 off, batch 1 x 64 tokens:
# one sgdm step on the card and on the CPU from the same weights
TRAIN_CPU = dict(layers=2, seq=64, batch=1)
TRAIN_CPU_TOL = {"loss": 1e-5, "grad_norm": 1e-4}
# T2 / T3: R=8 replicas at llama3.2-3b width, the depth cut to 1 layer
# (8 x 494.7 M parameters; a 28-layer replica set would not fit), per-
# replica batch 1 x 256 tokens, AdamW, 3 steps a sync mode or scenario;
# multiscale on suggest_levels(8) = (2, 4), rotation period 4, top-k 1%
DEC = dict(R=8, layers=1, seq=256, steps=3, topk=0.01, rotation=4)
DEC_BF16_RTOL = 2.0**-8  # a bf16 rounding, relative
# M1-M4, the sharded executors on the one card: the ranks are processes
# of one gloo group (NCCL takes one rank a card), all on cuda:0, started
# with `spawn` and meeting through a file store (dist.ranks.run_ranks),
# so none of these phases times the collectives.  M1: the large-n FI
# configuration at n=10^5 (FI above), 6 trials (seeds 0-5) on a 4-rank
# trial mesh (padded to 8); M2: its first 3 trials on the 2 x 2
# ("trials", "nodes") mesh; each rank launches sample_chunk and
# pair_apply once a chunk, 33 times.  M3: execute_sync_sharded at R=8,
# each rank one f32 leaf of llama3.2-3b's wq shape (3072 x 3072), row r
# drawn from MESH_SEED + r, 8 cases at steps 0 and 2 against the dense
# execute_sync on the card, bitwise where no pmean enters, else at 2e-6.
# M4: T2's model (llama3.2-3b width, 1 layer, bf16) with sgdm, 2 steps
# on a 4-rank replica mesh against the dense make_decentralized_step at
# R=4: step-0 losses bitwise, later losses and the parameters (norm of
# the difference over the norm, a leaf) within 1e-5 relative.  Each
# group of ranks has MESH["timeout"] seconds.
MESH = dict(ranks=4, trials=6, node_trials=3, sync_ranks=8, timeout=600)
MESH_SEED = 0
MESH_SYNC_SHAPE = (3072, 3072)
MESH_SYNC_TOL = 2e-6
MESH_TRAIN = dict(R=4, steps=2, rtol=1e-5)
# S1-S3, model sharding over a (data, model) mesh (models.sharded), as
# ranks of one gloo group sharing the card like M1-M4 (so nothing here
# times a collective across cards).  S1: llama3.2-3b at full width and
# SHARD["prefill_layers"] layers in bf16, forward on PREFILL (4 x 4096) on
# a 2 x 2 mesh: each rank 2 rows, 12 query and 4 KV heads and half the
# vocabulary, one launch of the bf16 flash kernel a layer and nothing
# else; then an f32 copy at SHARD["agree_layers"] layers, each rank's
# hidden state and logits block against the unsharded model on its rows
# on the card, allclose at SHARD["prefill_tol"] (rtol and atol; the
# sharded run sums the row-parallel products in another order).  S2: one
# AdamW step (lr SHARD["lr"]) of llama3.2-3b width at
# SHARD["train_layers"] layers in f32 on SHARD["train"] (4 x 512)
# SyntheticLM tokens on the 2 x 2 mesh against the unsharded step on the
# card: the loss, every block of the first moment ((1 - b1) g) and every
# block of the parameters drawn from the seed within SHARD["train_tol"]
# of the leaf's largest element; no kernel launch.  The zero-initialised
# norm scales are held through their first moments and their own error
# is reported: their first step is lr * g / (|g| + eps), the leaf's
# largest element is lr itself, and where this random model's gradient
# is far below eps (its loss is ~35.8: the tied logits peak on the input
# token) the step carries the gradient's f32 rounding amplified by up to
# lr / eps.  S3: S2's state saved with its shardings and restored onto a
# 4 x 1 mesh, every block bitwise.  S4 / S5 (SHARD_KINDS): the block
# kinds and the head counts that "model" does not divide, on the same
# mesh, in bf16 at full width with their depth cut: prefill on PREFILL,
# each rank's logits block finite, exactly the listed launches of the
# kernels (recurrentgemma-9b's local layer past its window runs the bf16
# flash kernel once, on the rank's 16 of the 2 x 16 (row, query head)
# units, each with the one KV head; rwkv6-3b runs the wkv kernel once a
# layer on its 2 x 20 (row, head) rows) and 0 of every other kernel;
# then an f32 copy at the listed depth, each rank's hidden state and
# logits block allclose at SHARD["prefill_tol"] to the unsharded model's
# on its rows, and SHARD["decode_steps"] decode steps from a sharded
# init_cache (recurrentgemma-9b's local cache split over its positions,
# flash-decode) against the unsharded decode, each step's logits block
# at the same tolerance.  The group has MESH["timeout"].
SHARD = dict(ranks=4, mesh=(2, 2), restore_mesh=(4, 1), prefill_layers=2,
             agree_layers=2, prefill_tol=1e-4, train_layers=2,
             train=(4, 512), lr=1e-5, train_tol=1e-5, decode_steps=8,
             logits_chunk=1024)
# phase: (arch, bf16 layers, f32 layers, {kernel: launches a rank})
SHARD_KINDS = {
    "S4": ("recurrentgemma-9b", 3, 3, {"flash_attention": 1}),
    "S5": ("rwkv6-3b", 4, 2, {"rwkv6": 4}),
}
# S2A: one sharded Adafactor step on S2's model and batch against the
# unsharded Adafactor step on the card: every vr and vc block and every
# parameter block of a matrix within SHARD["train_tol"] of its leaf's
# largest element; the 1-D leaves (the norm scales, zero-initialised,
# and their v) are reported only: Adafactor's first step moves each by
# about 1.3 lr times the sign of its gradient (the update's RMS clip
# scales a leaf of equal magnitudes to 1), so where this random model's
# gradient of such a scale is at rounding level its sign, and so the
# step, flips.  No kernel launch.  S6-S8 (SHARD_WIDE): the mixtures of
# experts and whisper-tiny at full width, their depth cut, on the
# listed mesh: prefill in bf16, each rank's logits block f32 and finite,
# exactly the listed bf16 flash launches a rank (grok-1-314b's 24 query
# and 4 KV heads with softcap 30, llama4-maverick's 10 and 2, whisper-
# tiny's 3 a decoder layer; its encoder and cross-attentions at 1500
# keys stay under the flash route's threshold) and 0 of the f32 one and
# of every other kernel; then an f32 copy at the listed depth, shape and
# config cut: each rank's hidden state and logits blocks allclose at
# SHARD["prefill_tol"] to the unsharded model's on its rows, and
# SHARD["decode_steps"] decode steps from a sharded init_cache (whisper:
# through the memory encoded on the rank's rows).  The unsharded f32
# model is drawn, run and freed by the parent before the rank group
# starts (grok-1-314b's f32 layer is ~26 GB): its hidden state, logits
# and decode logits go to a temp dir.  The weights of these phases are
# drawn block by block, each block of each parameter from its own seed
# (`_draw_block`), so a rank draws only its blocks and the parent
# assembles the same model whole; bf16 routing flips on near ties, so
# the MoE agreement is gated in f32 only.
# phase: arch, mesh, bf16 layers (None: all), prefill (B, S), bf16 flash
# launches a rank, f32 layers, f32 shape, f32 config changes
SHARD_WIDE = {
    "S6": dict(arch="grok-1-314b", mesh=(2, 2), layers=2, prefill=PREFILL,
               flash=2, agree_layers=1, agree=(4, 512), agree_changes={}),
    "S7": dict(arch="llama4-maverick-400b-a17b", mesh=(1, 4), layers=1,
               prefill=(2, 4096), flash=1, agree_layers=1, agree=(2, 512),
               agree_changes={"num_experts": 16}),
    "S8": dict(arch="whisper-tiny", mesh=(2, 2), layers=None,
               prefill=PREFILL, flash=4, agree_layers=None, agree=(4, 512),
               agree_changes={}),
}
# the serving fleet.  P1: the legacy per-tick schedule on the n=10^5 FI
# plan, backend "ref" (the plain tick scan) and "cuda" (each chunk's
# mixing matrix built tick by tick from the identity's rows, one
# cell_mixing launch a chunk); "cuda" values held to the matmul phase's
# tolerance.  P2: ControlPlane(R, full_view=True, seed=0, eps=1e-4) at R
# = 16 and 1024 (src/repro/serve/control_plane.py), its second round
# (round_idx 1) against the reference's counts for that round.  P3:
# run_fleet at FleetConfig(replicas=16, ticks=120, seed=0) and each
# router against BENCH_serve.json's recorded entry (throughput,
# completed, control messages, control bytes, admission latency mean),
# then R=256 reported.  P4 / P5: llama3.2-3b and rwkv6-3b at full width
# and depth through the paged engine.
PER_TICK_TOL = dict(rtol=1e-4, atol=2e-4)
CONTROL_R = (16, 1024)
CONTROL_1024 = dict(messages=249826,
                    level_messages=[195840, 36096, 10310, 4182, 2374],
                    level_ticks=[320, 128, 128, 128, 384])
FLEET = dict(replicas=16, ticks=120, seed=0)
FLEET_RECORDED = {
    "p2c_gossip": (63.88333333333333, 255, 64440, 5155200,
                   3.2901960784313724),
    "oracle": (67.16666666666667, 267, 0, 0, 1.599250936329588),
    "random": (57.34166666666667, 222, 0, 0, 5.572072072072072),
}
FLEET_P2C_OVER_ORACLE = 0.9
FLEET_LARGE_R = 256
# P4(a): paged_decode_step with an identity page map against the dense
# decode_step, 8 slots of 6 pages of 16 (96 = 64 + 32 positions), every
# step's logits bitwise.  P4(b) / P5: BatchingEngine over ModelBackend,
# 8 slots, pages of 16, 6 pages a slot, a pool of 48; prompts of 8-64
# tokens and budgets of 8-32 new tokens from default_rng(0), greedy,
# eos_id -1, so slots retire and refill mid-stream; REPLAYS of the
# refilled requests (the shortest first) again alone in a fresh engine.
# Each engine step is one paged_decode_step of the whole model (~55-105
# ms, bound by the host's launches) and a prefill runs one a prompt
# position, so each model takes 12 requests, the fewest that give 4
# refills with 8 slots.
PAGED = dict(slots=8, page_size=16, pages_per_slot=6, pool=48,
             prompt=(8, 65), budget=(8, 33))
PAGED_REQUESTS = {"llama3.2-3b": 12, "rwkv6-3b": 12, "recurrentgemma-9b": 12}
REPLAYS = 4
# the zoo's other block kinds.  Z0: the flash kernels at the prefill
# shapes the three models below give them, (B, Hq, Hkv, S, D), causal,
# with the layer's window and softcap and the model's query scale:
# recurrentgemma-9b's local layers (MQA, head 256, window 2048), gemma2-
# 27b's local and global layers (window 4096, softcap 50) and grok-1-
# 314b's (softcap 30).  Each against the plain version under FLASH_TOL
# and FLASH_BUDGET, and again in f32 at 2e-5 (FLASH_F32_LIMIT).  The
# windowed kernel at recurrentgemma's shape takes at most
# ZOO_WINDOW_RATIO of its own time without the window: it keeps 6.29 M of
# the 8.39 M causal (query, key) pairs a head (0.75), and a kernel that
# did not skip the key tiles before the window would take about 1.0.
ZOO_FLASH = (
    ("recurrentgemma-9b local", (4, 16, 1, 4096, 256),
     dict(window=2048, softcap=None, scale=256 ** -0.5)),
    ("gemma2-27b local", (1, 32, 16, 8192, 128),
     dict(window=4096, softcap=50.0, scale=(4608 / 32) ** -0.5)),
    ("gemma2-27b global", (1, 32, 16, 8192, 128),
     dict(window=None, softcap=50.0, scale=(4608 / 32) ** -0.5)),
    ("grok-1-314b", (2, 48, 8, 4096, 128),
     dict(window=None, softcap=30.0, scale=128 ** -0.5)),
)
ZOO_WINDOW_RATIO = 0.9
# Z1 / Z2: recurrentgemma-9b (src/repro/configs/recurrentgemma_9b.py) at
# full width and depth (26 rglru and 12 local layers, 9.40 B parameters,
# 18.8 GB in bf16): PREFILL, SERVE, AGREE and PAGED as llama3.2-3b; one
# local block of the f32 copy also over 1 x (window + ZOO_WRAP) tokens
# against decode_attention, whose rotating cache of the window wraps.
# Z3: gemma2-27b (src/repro/configs/gemma2_27b.py) at full width, its
# depth cut to 8 layers (4 local, 4 global; 5.71 B parameters): the full
# 46 layers (54.5 GB) and the 1 x 8192 logits with the softcap's
# temporaries would pass 80 GB.  Its prefill is 1 x 8192 tokens, so the
# local layers' window of 4096 bites.  Z4: grok-1-314b
# (src/repro/configs/grok_1.py) at full width, its depth cut to 4 layers
# (21.3 B parameters, 42.6 GB; 64 layers are 633 GB), prefill 2 x 4096;
# its f32 copy for the agreement has 1 layer (26 GB).  At AGREE's 2 x 64
# tokens every expert's capacity is 256 slots, more than the 128 tokens,
# so no token is dropped on either path.
ZOO_WRAP = 256
ZOO_DEPTH = {"gemma2-27b": 8, "grok-1-314b": 4, "qwen2-vl-72b": 4}
ZOO_PREFILL = {"recurrentgemma-9b": PREFILL, "gemma2-27b": (1, 8192),
               "grok-1-314b": (2, 4096)}
ZOO_AGREE_DEPTH = {"gemma2-27b": 8, "grok-1-314b": 1}
# the encoder-decoder and chunked_attention.  W1: whisper-tiny
# (src/repro/configs/whisper_tiny.py) at full size (4 encoder and 4
# decoder layers, d 384, 36.4 M parameters), frames (B, 1500, 384) from
# default_rng(WHISPER_FRAMES_SEED) in place of the stubbed audio
# frontend: prefill PREFILL decoder tokens (one bf16 flash launch a
# decoder layer; the encoder's 1500 frames and the cross-attention over
# them stay under chunk_threshold, on full_attention), Generator SERVE,
# and an f32 copy's forward vs decode at AGREE held to AGREE_F32_TOL.
WHISPER_FRAMES_SEED = 16
# X1: chunked_attention against full_attention on the card, one
# attention block at full width in f32 (TF32 off): llama3.2-3b causal
# self-attention over 1 x 4096, and whisper-tiny's cross-attention of 1 x
# 4096 queries over a memory of 4096 frames (past chunk_threshold, so
# attention() takes chunked_attention).  Outputs at 2e-5; the gradients
# of q, k and v within 1e-4 of their largest element.
CHUNKED_CASES = (("llama3.2-3b self", "llama3.2-3b", (1, 4096), None),
                 ("whisper-tiny cross", "whisper-tiny", (1, 4096), 4096))
CHUNKED_TOL = {"out": 2e-5, "grad": 1e-4}
# Q1: qwen2-vl-72b (src/repro/configs/qwen2_vl_72b.py) at full width, 4
# of its 80 layers (ZOO_DEPTH; 12 GB of bf16 weights), prefill 1 x 4096
# at M-RoPE positions: a text prefix of QWEN_LAYOUT["text"] tokens at t =
# h = w = i, a grid x grid patch block at t = text, h = text + row, w =
# text + col, then text again from the grid's largest id + 1.  Every
# layer takes chunked_attention (the flash kernel masks by index), so no
# kernel launches; block 0's attention in f32 at those positions is held
# against full_attention at CHUNKED_TOL["out"].
QWEN_PREFILL = (1, 4096)
QWEN_LAYOUT = dict(text=256, grid=32)
# T1L: one make_train_step step of llama3.2-3b at full size (AdamW as
# T1) on train_4k's sequence of 4096 tokens, its global batch cut from
# 256 to 1: every layer trains through chunked_attention
TRAIN_LONG = dict(seq=4096, batch=1)
# D1: the dry run (`repro_torch.launch.dryrun`), host-only, in a process
# of its own: (a) S1's cell traced on a fake group of S1's world size and
# held against S1's rank 0 (its predicted peak within `peak_tol` of the
# measured one), (b) `run_cell` at full size on the 16 x 16 mesh, each
# cell of `max_gib` predicting at most that many GiB a device, (c) S2's
# cell (the f32 sharded train step) held against S2's rank 0 as (a)
# holds S1's
DRYRUN = dict(peak_tol=0.25, arch="llama3.2-3b",
              cells=("prefill_32k", "train_4k"), max_gib={"train_4k": 9.0})
# E1: the six example scripts on the card, in-process through their
# `main`, at tools/ci.sh's smoke sizes; train_lm runs twice into one
# checkpoint directory, the second auto-resuming at the first's last
# step (30 keeps its own loss-decrease check on the resumed steps)
EXAMPLE_RUNS = (
    ("decentralized_consensus", ["--strategy", "multiscale", "--compress",
                                 "topk", "--rotate", "4", "--replicas", "8",
                                 "--steps", "2"]),
    ("decentralized_consensus", ["--strategy", "multiscale", "--overlap",
                                 "--replicas", "8", "--steps", "3"]),
    ("serve_fleet", ["--replicas", "16", "--ticks", "120"]),
    ("robust_training", ["--replicas", "8", "--steps", "8", "--churn",
                         "0.25", "--byzantine", "0.125", "--aggregation",
                         "trimmed_mean", "--compress", "topk"]),
    ("train_lm", ["--preset", "smoke", "--steps", "20"]),
    ("train_lm", ["--preset", "smoke", "--steps", "30"]),
    ("serve_decode", []),
    ("quickstart", ["--n", "1000"]),
)
# published H100 peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores; the
# PCIe part is slower.  The int32 rate is the card's SMs x 64 int32
# lanes x its maximum SM clock, read from the card.
PEAKS = {"sxm": (3.35e12, 67e12, 989e12), "pcie": (2.0e12, 51e12, 756e12)}
INT32_LANES_PER_SM = 64
# threefry-2x32's own operations a hash (csrc/sample_chunk.cu): 20 rounds
# of add, rotate (one funnel shift) and xor, 5 key injections of 2 adds,
# 2 adds of the key at the start
HASH_OPS = 20 * 3 + 5 * 2 + 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def fingerprint(torch, tree) -> dict:
    """Each tensor leaf of a state as (dtype, shape, two int64 sums: of
    its bit patterns as integers and of their squares), every other
    leaf as it is.  Two states with equal fingerprints hold the same
    bits unless a change cancels in both sums, and no second copy of
    a 38 GB state is needed to tell."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
            return
        if not torch.is_tensor(t):
            out[prefix] = t
            return
        words = t.detach().contiguous().view(-1).view(
            ints[t.element_size()])
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for piece in words.split(1 << 26):
            w = piece.long()
            s1 = s1 + w.sum()
            s2 = s2 + (w * w).sum()
        out[prefix] = (str(t.dtype), tuple(t.shape), int(s1), int(s2))
    walk(tree, "")
    return out


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.name = torch.cuda.get_device_name(0)
        part = "pcie" if "PCIE" in self.name.upper() else "sxm"
        self.hbm, self.f32, self.bf16 = PEAKS[part]
        self.report: dict = {"device": self.name}
        self.kernels: dict = {}
        self.int32 = None  # int32 operations/s, set by build
        self.main_x: dict = {}  # x_final of each large-n main path run

    # ---------------------------------------------------------- helpers
    def time_ms(self, fn, reps: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(self, fn, reps: int) -> float:
        """Device time per call of `fn`: `reps` calls captured in one CUDA
        graph, its replay timed with CUDA events, so the host's time to
        issue each call is not in it."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / reps

    def bound_ms(self, nbytes: float, flops: float, peak=None):
        """The larger of the bytes over HBM and the operations over `peak`
        (the f32 CUDA-core rate unless given)."""
        t_bytes, t_ops = nbytes / self.hbm, flops / (peak or self.f32)
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")

    def instance_ms(self, fn, kernel: int) -> float:
        """Device ms a call of `fn` with sample_chunk launched on template
        instance `kernel` of csrc/sample_chunk.cu (2: every mode, with the
        shape `launch_shape` gives it) in place of the one the op picks:
        the instances compared at one shape."""
        from repro_torch.kernels.sample_chunk import ops

        chosen = ops.launch_shape

        def forced(T, R, B, C, nflat, sms, mode):
            return chosen(T, R, B, C, nflat, sms, 2)._replace(kernel=kernel)

        ops.launch_shape = forced
        try:
            return self.device_ms(fn, 50)
        finally:
            ops.launch_shape = chosen

    def chunk_bound(self, lp, T: int, R: int):
        """The least time of one plain-mode sample_chunk draw of `T` ticks
        for `R` trials over level `lp`, and what bounds it: each input
        read once (keys; start and degrees (B, C); nbr and hops; n_nodes;
        done), usage and msgs read and written once, the (T, R*B) pairs
        and bits written once; the hashes: 5 for each tick's keys of a
        trial, 2 for each counter pair of a tick (i and j words).
        Returns (bound ms, "bytes" or "operations", bytes, hashes)."""
        B, C = lp.num_graphs, lp.degrees.shape[1]
        nflat = lp.nbr_flat.shape[0]
        nbytes = (16 * R + 2 * B * C * 4 + 2 * nflat * 4 + B * 4 + R * B
                  + 2 * R * (nflat * 4 + B * 4) + T * R * B * (4 + 4 + 1 + 1))
        hashes = R * (5 * T + 2 * T * ((B + 1) // 2))
        bound, by = self.bound_ms(nbytes, hashes * HASH_OPS, peak=self.int32)
        return bound, by, nbytes, hashes

    def gen(self, seed: int):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    @staticmethod
    def ops():
        """Each kernel's op (its wrapper holds the launch count)."""
        from repro_torch.kernels.cell_mixing import cell_mixing
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.pair_apply import pair_apply
        from repro_torch.kernels.rwkv6 import rwkv6_wkv
        from repro_torch.kernels.sample_chunk import sample_chunk

        return {"pair_apply": pair_apply, "sample_chunk": sample_chunk,
                "cell_mixing": cell_mixing, "rwkv6": rwkv6_wkv,
                "flash_attention": flash_attention}

    def zero_counts(self):
        for op in self.ops().values():
            op.launches = 0
        counts = self.flash_kernels()
        for name in counts:
            counts[name] = 0

    def read_counts(self) -> dict:
        """Each kernel's launches since zero_counts."""
        return {name: op.launches for name, op in self.ops().items()}

    def flash_kernels(self) -> dict:
        """The flash op's launches of each CUDA kernel, by source name
        (bf16: flash_attention_sm90, f32: flash_attention)."""
        return self.ops()["flash_attention"].kernel_launches

    @staticmethod
    def check_idle(counts: dict, runs, label: str):
        """Every kernel but `runs` (a name, a tuple of names, or None)
        launched no time."""
        runs = (runs,) if runs is None or isinstance(runs, str) else runs
        others = {k: n for k, n in counts.items() if k not in runs and n}
        check(not others, f"{label} launched {others}")

    # ----------------------------------------------------------- phases
    def build(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(out)
        self.report["nvidia_smi"] = out
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0]
        sms = self.torch.cuda.get_device_properties(0).multi_processor_count
        self.int32 = sms * INT32_LANES_PER_SM * float(mhz) * 1e6
        self.report["int32_ops_per_s"] = self.int32
        from repro_torch.kernels._build import build_all

        t0 = time.perf_counter()
        logs = build_all()
        dt = time.perf_counter() - t0
        log(f"[build] {len(logs)} kernels built in {dt:.2f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
        self.report["build_s"] = dt

    def prng(self, lp, T):
        """Threefry on the card against threefry on the CPU, bitwise."""
        torch = self.torch
        from repro_torch.core import prng, sample_schedule

        B = lp.num_graphs
        triples = ((0, 0, 0), (0, 5, 1663), (7, 2, 100), (123, 1, 49),
                   (2**31 + 5, 3, 7), (1, 0, 63), (2, 4, 4095), (99, 1, 1),
                   (2**32 - 1, 2, 31), (31337, 5, 2**20))
        for seed, level, t in triples:
            draws = []
            for dev in ("cpu", self.dev):
                key = prng.fold_in(prng.PRNGKey(seed, dev), level)
                ks = prng.split(prng.fold_in(key, t), 4)
                draws.append(prng.uniform(ks, (B,)).view(torch.int32).cpu())
            check(torch.equal(*draws),
                  f"prng draws differ at {(seed, level, t)}")
        from repro_torch.core import CsrGraphs

        fields = {}
        for loss_p in (None, 0.9):
            s = []
            for dev in ("cpu", self.dev):
                adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat,
                                lp.degrees, lp.n_nodes).to_device(dev)
                key = prng.fold_in(prng.PRNGKey(0, dev), 0)[None]
                s.append(sample_schedule(torch.arange(T), key, adj, loss_p))
            flips = {f: int((a.cpu() != b.cpu()).sum())
                     for f, a, b in zip(s[0]._fields, s[0], s[1])}
            fields[str(loss_p)] = flips
            # loss_p goes through floor(log u / log p): a one-ulp log
            # difference between devices may not flip any outcome
            check(not any(flips.values()),
                  f"schedule differs card vs CPU at loss_p={loss_p}: {flips}")
        log(f"[prng] card == CPU bitwise for {len(triples)} (seed, level, t) "
            f"draws and every field of the n=1e5 finest-level schedule, "
            f"without loss and at loss_p=0.9")
        self.report["prng_loss_mismatch"] = fields["0.9"]
        return s[1]

    def sample_chunk(self, plan):
        """The sample_chunk kernel against its plain version on the card,
        bitwise in every output (the pairs, the update bits, and the
        counts it adds into usage and msgs): at the finest level (B=43250,
        T=50), at level 1 (B=12539, odd) and at the top level (B=1,
        C=49, T=64), each for R in (1, 4), without loss and at
        loss_p=0.9, with a random `done` freeze.  Times it at the finest
        level, held to SAMPLE_CHUNK_BOUND_LIMIT times its bound, and at
        the top level beside its bound.  Returns the top level's slots and
        its draw for one trial."""
        torch = self.torch
        from repro_torch.core import CsrGraphs, fi_ticks, prng
        from repro_torch.kernels.sample_chunk import (
            sample_chunk, sample_chunk_ref)

        names = ("i", "j", "upd_i", "upd_j", "usage", "msgs")
        cases = 0

        def chunk_T(lp):
            fixed = fi_ticks(int(lp.n_nodes.max()), FI["eps"],
                             FI["fixed_ticks_scale"],
                             quadratic=(lp.kind == "overlay"))
            return min(64, fixed)

        def inputs(li, R, seed):
            lp = plan.levels[li]
            adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat,
                            lp.degrees, lp.n_nodes).to_device(self.dev)
            B, nflat = lp.num_graphs, lp.nbr_flat.shape[0]
            g = self.gen(seed)
            keys = prng.fold_in(torch.stack(
                [prng.PRNGKey(seed + r, self.dev) for r in range(R)]), li)
            done = torch.rand((R, B), generator=g, device=self.dev) < 0.3
            usage = torch.randint(0, 1000, (R * nflat,), generator=g,
                                  device=self.dev, dtype=torch.int32)
            msgs = torch.randint(0, 1000, (R, B), generator=g,
                                 device=self.dev, dtype=torch.int32)
            return adj, keys, done, usage, msgs

        levels = (0, 1, len(plan.levels) - 1)
        for li in levels:
            T = chunk_T(plan.levels[li])
            for R in (1, 4):
                for loss_p in (None, 0.9):
                    adj, keys, done, usage, msgs = inputs(li, R, 100 + li)
                    t0 = 2 * T
                    got_u, got_m = usage.clone(), msgs.clone()
                    before = sample_chunk.launches
                    got = sample_chunk(t0, T, keys, adj, loss_p, done, got_u,
                                       got_m)
                    torch.cuda.synchronize()
                    check(sample_chunk.launches == before + 1,
                          "sample_chunk did not launch its kernel once")
                    want = sample_chunk_ref(t0, T, keys, adj, loss_p, done,
                                            usage, msgs)
                    diff = {n: int((a != b).sum()) for n, a, b in zip(
                        names, (*got, got_u, got_m), (*want, usage, msgs))}
                    check(not any(diff.values()),
                          f"sample_chunk kernel != plain version at level "
                          f"{li} (B={plan.levels[li].num_graphs}, T={T}, "
                          f"R={R}, loss_p={loss_p}): {diff}")
                    cases += 1
        # the finest level's chunk, one trial, no loss: the main path's
        # largest draw
        lp = plan.levels[0]
        T, B, C = chunk_T(lp), lp.num_graphs, lp.degrees.shape[1]
        adj, keys, done, usage, msgs = inputs(0, 1, 7)
        done.zero_()

        def kernel():
            return sample_chunk(0, T, keys, adj, None, done, usage, msgs)

        def plain():
            return sample_chunk_ref(0, T, keys, adj, None, done, usage, msgs)

        ms = self.time_ms(kernel, reps=50)
        dev_ms = self.device_ms(kernel, 50)
        plain_ms = self.time_ms(plain, reps=3, warmup=1)
        bound, by, nbytes, hashes = self.chunk_bound(lp, T, 1)
        nflat = lp.nbr_flat.shape[0]
        log(f"[sample_chunk] bitwise == plain version in all six outputs at "
            f"{cases} cases (levels {levels}: B = "
            f"{[plan.levels[i].num_graphs for i in levels]}; R 1, 4; loss "
            f"none, 0.9; done random); at (T={T}, B={B}, C={C}): kernel "
            f"{ms:.4f} ms a call, {dev_ms:.4f} ms on the device (CUDA "
            f"graph, {dev_ms / bound:.2f}x the bound), plain {plain_ms:.4f} "
            f"ms, bound {bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, "
            f"{hashes} hashes, {hashes * HASH_OPS / 1e6:.1f} M int32 "
            f"operations at {self.int32 / 1e12:.2f} T/s)")
        check(dev_ms <= SAMPLE_CHUNK_BOUND_LIMIT * bound,
              f"sample_chunk {dev_ms:.4f} ms on the device at (T={T}, B={B}, "
              f"C={C}), above {SAMPLE_CHUNK_BOUND_LIMIT}x its "
              f"{bound:.4f} ms bound")
        # the same draw on the every-mode instance of the kernel's template
        every_ms = self.instance_ms(kernel, 2)
        log(f"[sample_chunk] the same draw on the every-mode instance: "
            f"{every_ms:.4f} ms on the device (the main path's instance: "
            f"{dev_ms:.4f})")
        # the top level's draw: one graph of 49 slots, 64 ticks; also
        # pair_apply's top-level shape
        top = plan.levels[-1]
        T_top = chunk_T(top)
        adj, keys, done, usage, msgs = inputs(len(plan.levels) - 1, 1, 9)
        done.zero_()

        def kernel_top():
            return sample_chunk(0, T_top, keys, adj, None, done, usage, msgs)

        top_dev_ms = self.device_ms(kernel_top, 50)
        top_bound, top_by, _, _ = self.chunk_bound(top, T_top, 1)
        log(f"[sample_chunk] top level (T={T_top}, R=1, B=1, "
            f"C={top.degrees.shape[1]}): {top_dev_ms:.4f} ms on the device, "
            f"bound {top_bound:.7f} ms ({top_by})")
        self.kernels["sample_chunk"] = dict(
            name="sample_chunk", route="cuda",
            source="src/repro_torch/csrc/sample_chunk.cu",
            replaces="src/repro/core/schedule.py:204 (sample_schedule) and "
                     "src/repro/core/gossip.py:275-313 (chunk accounting): "
                     "XLA, no Pallas kernel",
            launches=None, max_abs_err=0.0, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
            bound_limit=SAMPLE_CHUNK_BOUND_LIMIT,
            top_device_ms=top_dev_ms, top_bound_ms=top_bound,
            top_bound_by=top_by, every_mode_instance_device_ms=every_ms,
            shape=dict(T=T, R=1, B=B, C=C, nflat=nflat))
        return top.degrees.shape[1], kernel_top()

    @staticmethod
    def fi_levels(plan, check_every: int = 64):
        """Each level's FI (tick budget, chunk) as `execute_plan` sets
        them."""
        from repro_torch.core import fi_ticks

        out = []
        for lp in plan.levels:
            fixed = fi_ticks(int(lp.n_nodes.max()), FI["eps"],
                             FI["fixed_ticks_scale"],
                             quadratic=(lp.kind == "overlay"))
            chk = min(check_every, fixed)
            out.append((-(-fixed // chk) * chk, chk))
        return out

    def sample_chunk_scenario(self, plan):
        """The sample_chunk kernel in its scenario and cost mode against
        its plain version on the card, bitwise in every output (pairs,
        update bits, and the counts it adds into usage, msgs, retx and
        the congestion pairs): at the finest level (B=43250, T=50), level
        1 (B=12539, odd) and the top level (the largest hop_cap), for R in
        (1, 2), each scenario of scenario_matrix() with its level flags
        as `execute_plan` builds them, without loss and at loss_p=0.9,
        under SCENARIO_COST, a random `done` freeze.  Times the op at the
        finest level with the stragglers scenario and the cost on, held to
        SAMPLE_CHUNK_SCENARIO_BOUND_LIMIT times its bound, and splits its
        device time by kernel."""
        torch = self.torch
        from repro_torch.core import (CostModel, CsrGraphs, prng,
                                      scenario_matrix)
        from repro_torch.core.engine import _failure_consts
        from repro_torch.kernels.sample_chunk import (
            sample_chunk, sample_chunk_ref)

        cost = CostModel(**SCENARIO_COST)
        fi = self.fi_levels(plan)
        n = plan.graph.n
        ctxs = {sc.name: (None if sc.failures is None else _failure_consts(
            plan, sc.failures, [m for m, _ in fi], n, self.dev)[0])
            for sc in scenario_matrix()}
        names = ("i", "j", "upd_i", "upd_j", "usage", "msgs", "retx",
                 "congp")

        def inputs(li, R, seed, frozen=0.1):
            lp = plan.levels[li]
            adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat,
                            lp.degrees, lp.n_nodes).to_device(self.dev)
            B, nflat = lp.num_graphs, lp.nbr_flat.shape[0]
            g = self.gen(seed)
            keys = prng.fold_in(torch.stack(
                [prng.PRNGKey(seed + r, self.dev) for r in range(R)]), li)
            done = torch.rand((R, B), generator=g, device=self.dev) < frozen
            counts = [torch.randint(0, 1000, shape, generator=g,
                                    device=self.dev, dtype=torch.int32)
                      for shape in ((R * nflat,), (R, B), (R, B))]
            counts.append(counts[-1].to(torch.float32))  # congp
            return adj, keys, done, counts

        levels = (0, 1, len(plan.levels) - 1)
        cases = 0
        for li in levels:
            lp = plan.levels[li]
            T, hop_cap = fi[li][1], max(1, int(lp.max_hops))
            t0 = 0 if li == 0 else T  # the finest level is one chunk
            for R in (1, 2):
                for name, ctx in ctxs.items():
                    ctx = None if ctx is None else ctx[li]
                    for loss_p in (None, 0.9):
                        adj, keys, done, counts = inputs(li, R, 300 + li)
                        got_c = [c.clone() for c in counts]
                        kw = dict(failure_ctx=ctx, cost=cost,
                                  hop_cap=hop_cap)
                        before = sample_chunk.launches
                        got = sample_chunk(t0, T, keys, adj, loss_p, done,
                                           got_c[0], got_c[1], retx=got_c[2],
                                           congp=got_c[3], **kw)
                        torch.cuda.synchronize()
                        check(sample_chunk.launches == before + 1,
                              "sample_chunk did not launch its kernel once")
                        want = sample_chunk_ref(
                            t0, T, keys, adj, loss_p, done, counts[0],
                            counts[1], retx=counts[2], congp=counts[3], **kw)
                        diff = {k: int((a != b).sum()) for k, a, b in zip(
                            names, (*got, *got_c), (*want, *counts))}
                        check(not any(diff.values()),
                              f"sample_chunk kernel != plain version under "
                              f"scenario {name} at level {li} (B="
                              f"{lp.num_graphs}, T={T}, hop_cap={hop_cap}, "
                              f"R={R}, loss_p={loss_p}): {diff}")
                        cases += 1
        # the finest level's chunk, one trial, no loss, the stragglers
        # scenario and the cost on
        lp = plan.levels[0]
        T, B, C = fi[0][1], lp.num_graphs, lp.degrees.shape[1]
        ctx = ctxs["stragglers"][0]
        adj, keys, done, counts = inputs(0, 1, 11, frozen=0.0)
        kw = dict(failure_ctx=ctx, cost=cost, hop_cap=1, retx=counts[2],
                  congp=counts[3])
        before = counts[1].sum()
        i, j, _, _ = sample_chunk(0, T, keys, adj, None, done, counts[0],
                                  counts[1], **kw)
        # the draws this chunk needs: a retransmission word a hop sent, a
        # straggler word an exchange touching a straggler
        retx_words = int(counts[1].sum() - before)
        bidx = torch.arange(B, device=self.dev)
        bits = ctx.bits[bidx, i.long()] | ctx.bits[bidx, j.long()]
        valid = adj.degrees[bidx, i.long()] > 0
        strag_words = int((valid & ((bits & 2) != 0)).sum())

        def kernel():
            return sample_chunk(0, T, keys, adj, None, done, counts[0],
                                counts[1], **kw)

        def plain():
            return sample_chunk_ref(0, T, keys, adj, None, done, counts[0],
                                    counts[1], **kw)

        ms = self.time_ms(kernel, reps=50)
        dev_ms = self.device_ms(kernel, 50)
        plain_ms = self.time_ms(plain, reps=3, warmup=1)
        # bytes: the plain mode's, the (B, C) flags, retx and congp read
        # and written; operations: the hashes of all three streams, each
        # of the tagged ones at two words a hash
        nflat = lp.nbr_flat.shape[0]
        nbytes = (16 + 2 * B * C * 4 + 2 * nflat * 4 + B * 4 + B + B * C
                  + 2 * (nflat * 4 + B * 4) + 4 * B * 4
                  + T * B * (4 + 4 + 1 + 1))
        hashes = (5 * T + 2 * T * ((B + 1) // 2) + -(-strag_words // 2)
                  + -(-retx_words // 2))
        bound, by = self.bound_ms(nbytes, hashes * HASH_OPS, peak=self.int32)
        # the op's device time split by kernel: the draw, the congestion
        # pairs, and the zeroing of the attempts a tick
        for _ in range(3):
            kernel()
        rows_t, _ = self.trace(lambda: [kernel() for _ in range(20)])

        def part(match):
            return sum(r[0] for r in rows_t if match(r[2])) / 1e3 / 20

        split = {
            "kernel": part(lambda k: "sample_chunk" in k
                           and "congestion" not in k),
            "congestion": part(lambda k: "sample_chunk_congestion" in k),
            "fill": part(lambda k: "FillFunctor" in k)}
        split["other"] = part(lambda k: True) - sum(split.values())
        log(f"[sample_chunk scenario] the op's device ms a call by kernel "
            f"(torch.profiler, 20 calls): " + ", ".join(
                f"{k} {v:.4f}" for k, v in split.items()))
        log(f"[sample_chunk scenario] bitwise == plain version in all eight "
            f"outputs at {cases} cases (levels {levels}, B = "
            f"{[plan.levels[i].num_graphs for i in levels]}, hop_cap "
            f"{[max(1, int(plan.levels[i].max_hops)) for i in levels]}; R "
            f"1, 2; the {len(ctxs)} scenarios of scenario_matrix(); loss "
            f"none, 0.9; {SCENARIO_COST}); stragglers + cost at (T={T}, "
            f"B={B}, C={C}): op {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
            f"device (CUDA graph), plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {hashes} hashes "
            f"of which {-(-strag_words // 2)} straggler and "
            f"{-(-retx_words // 2)} retransmission; the op "
            f"{dev_ms / bound:.2f}x the bound)")
        # the same op on the instance that also draws loss
        loss_ms = self.instance_ms(kernel, 2)
        log(f"[sample_chunk scenario] the same op on the every-mode "
            f"instance (with loss's code): {loss_ms:.4f} ms on the device "
            f"(the instance without it: {dev_ms:.4f})")
        check(dev_ms <= SAMPLE_CHUNK_SCENARIO_BOUND_LIMIT * bound,
              f"sample_chunk with stragglers and cost {dev_ms:.4f} ms on the "
              f"device at (T={T}, B={B}, C={C}), above "
              f"{SAMPLE_CHUNK_SCENARIO_BOUND_LIMIT}x its {bound:.4f} ms bound")
        self.kernels["sample_chunk"].update(
            scenario_cases=cases, scenario_ms=ms, scenario_device_ms=dev_ms,
            scenario_plain_ms=plain_ms, scenario_bound_ms=bound,
            scenario_bound_by=by,
            scenario_bound_limit=SAMPLE_CHUNK_SCENARIO_BOUND_LIMIT,
            scenario_kernel_ms=split["kernel"],
            scenario_congestion_ms=split["congestion"],
            scenario_fill_ms=split["fill"],
            scenario_every_mode_instance_device_ms=loss_ms,
            scenario_shape=dict(
                T=T, R=1, B=B, C=C, scenario="stragglers", **SCENARIO_COST),
            scenario_hashes=hashes)

    def pair_apply(self, lp, sched, T, top):
        torch = self.torch
        from repro_torch.kernels.pair_apply import pair_apply, pair_apply_ref

        worst = 0.0

        def compare(x, i, j, ui, uj, label, **kw):
            nonlocal worst
            got = pair_apply(x, i, j, ui, uj, **kw)
            want = pair_apply_ref(x, i, j, ui, uj)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) if got.numel() else 0.0
            worst = max(worst, err)
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"pair_apply kernel != plain version at {label} "
                  f"(max abs err {err})")

        B, C, V = lp.num_graphs, lp.node_mask.shape[1], 2
        x = torch.randn((B, C, V), generator=self.gen(1), device=self.dev)
        i = sched.i.reshape(T, B).contiguous()
        j = sched.j.reshape(T, B).contiguous()
        act = sched.valid.reshape(T, B).contiguous()
        compare(x, i, j, act, act, f"n=1e5 finest level {(B, C, V, T)}")
        for C2 in (4, 9, 16, 49, 130):
            for V2, B2, T2 in ((2, 4099, 64), (1, 777, 50)):
                g = self.gen(C2 * 1000 + V2)
                xr = torch.randn((B2, C2, V2), generator=g, device=self.dev)
                ir = torch.randint(0, C2, (T2, B2), generator=g,
                                   device=self.dev, dtype=torch.int32)
                jr = torch.randint(0, C2, (T2, B2), generator=g,
                                   device=self.dev, dtype=torch.int32)
                same = torch.rand((T2, B2), generator=g, device=self.dev) < 0.1
                jr = torch.where(same, ir, jr)  # i == j ticks
                ui = torch.rand((T2, B2), generator=g, device=self.dev) < 0.7
                uj = torch.rand((T2, B2), generator=g, device=self.dev) < 0.8
                compare(xr, ir, jr, ui, uj, f"random {(B2, C2, V2, T2)}")
                if C2 == 49:
                    compare(xr, ir, jr, ui, uj,
                            f"device-memory state {(B2, C2, V2, T2)}",
                            smem_cap=0)
        # the top level's chunk: one cell of 49 slots, 64 ticks
        Ct, (ti, tj, tui, tuj) = top
        Tt = ti.shape[0]
        check(ti.shape == (Tt, 1), f"top-level draw {tuple(ti.shape)} is "
              f"not one cell")
        xt = torch.randn((1, Ct, V), generator=self.gen(2), device=self.dev)
        compare(xt, ti, tj, tui, tuj, f"top level {(1, Ct, V, Tt)}")
        compare(xt, ti, tj, tui, tuj, f"top level {(1, Ct, V, Tt)}, "
                f"device-memory state", smem_cap=0)
        ms = self.time_ms(lambda: pair_apply(x, i, j, act, act), reps=50)
        dev_ms = self.device_ms(lambda: pair_apply(x, i, j, act, act), 50)
        plain = self.time_ms(lambda: pair_apply_ref(x, i, j, act, act),
                             reps=3, warmup=1)
        nbytes = 2 * B * C * V * 4 + T * B * (4 + 4 + 1 + 1)
        bound, by = self.bound_ms(nbytes, 2 * T * B * V)
        top_ms = self.time_ms(lambda: pair_apply(xt, ti, tj, tui, tuj),
                              reps=50)
        top_dev = self.device_ms(lambda: pair_apply(xt, ti, tj, tui, tuj), 50)
        top_bound, top_by = self.bound_ms(
            2 * Ct * V * 4 + Tt * (4 + 4 + 1 + 1), 2 * Tt * V)
        log(f"[pair_apply] bitwise == plain version at n=1e5 finest and top "
            f"levels and C in (4, 9, 16, 49, 130); at {(B, C, V, T)}: kernel "
            f"{ms:.4f} ms a call, {dev_ms:.4f} ms on the device (CUDA "
            f"graph, {dev_ms / bound:.2f}x its bound), plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); at {(1, Ct, V, Tt)}: "
            f"{top_ms:.4f} ms a call, {top_dev:.4f} ms on the device, bound "
            f"{top_bound:.6f} ms ({top_by})")
        check(dev_ms <= PAIR_APPLY_BOUND_LIMIT * bound,
              f"pair_apply {dev_ms} ms on the device at {(B, C, V, T)}, "
              f"beyond {PAIR_APPLY_BOUND_LIMIT}x its {bound} ms bound")
        self.kernels["pair_apply"] = dict(
            name="pair_apply", route="cuda",
            source="src/repro_torch/csrc/pair_apply.cu",
            replaces="src/repro/kernels/pair_apply/kernel.py:40",
            launches=None, max_abs_err=worst, ms=ms, device_ms=dev_ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None,
            top_ms=top_ms, top_device_ms=top_dev, top_bound_ms=top_bound,
            shape=dict(B=B, C=C, V=V, T=T),
            top_shape=dict(B=1, C=Ct, V=V, T=Tt))

    def cell_mixing(self, plan20k):
        torch = self.torch
        from repro_torch.core import CsrGraphs, compose_schedule, prng
        from repro_torch.core import sample_schedule
        from repro_torch.kernels.cell_mixing import (
            cell_mixing, cell_mixing_ref, mixing_matrix)
        from repro_torch._tf32 import no_tf32

        lp = plan20k.levels[0]
        B, C = lp.node_mask.shape
        w = torch.as_tensor(mixing_matrix(lp.neighbors, lp.degrees,
                                          lp.n_nodes), device=self.dev)
        worst = 0.0
        for d in (2, 33):
            x = torch.randn((B, C, d), generator=self.gen(d), device=self.dev)
            for rounds in (1, 8):
                got = cell_mixing(w, x, rounds=rounds)
                want = cell_mixing_ref(w, x, rounds=rounds)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                      f"cell_mixing != plain version at {(B, C, d, rounds)} "
                      f"(max abs err {err})")
                check(torch.allclose(got.sum(1), x.sum(1), rtol=1e-4,
                                     atol=1e-4),
                      f"cell_mixing lost mass at {(B, C, d, rounds)}")
        # the matmul backend's input: one composed chunk at n=20000
        T = 50
        adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                        lp.n_nodes).to_device(self.dev)
        s = sample_schedule(torch.arange(T), prng.PRNGKey(0, self.dev)[None],
                            adj, None)
        act = s.valid.reshape(T, B)
        m = compose_schedule(C, s.i.reshape(T, B), s.j.reshape(T, B), act, act)
        x = torch.randn((B, C, 2), generator=self.gen(5), device=self.dev)
        got, want = cell_mixing(m, x), cell_mixing_ref(m, x)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"cell_mixing != plain version on a composed chunk ({err})")
        # per call: events around 100 back-to-back calls, the host's issue
        # included, as the matmul backend's chunk loop pays it; five such
        # means taken in turns with torch.bmm's, the least of each side
        # compared (the host's clock varies more than the device's) and
        # all ten kept, so a failure reads as noise or as a regression.
        # On the device: the same calls replayed from a CUDA graph.
        with no_tf32():
            turns = [(self.time_ms(lambda: cell_mixing(m, x), reps=100),
                      self.time_ms(lambda: torch.bmm(m, x), reps=100))
                     for _ in range(5)]
            plain = self.time_ms(lambda: cell_mixing_ref(m, x), reps=100)
            dev_ms = self.device_ms(lambda: cell_mixing(m, x), 100)
            dev_library = self.device_ms(lambda: torch.bmm(m, x), 100)
        ours, bmms = [t[0] for t in turns], [t[1] for t in turns]
        ms, library = min(ours), min(bmms)
        lost = sum(a > b for a, b in turns)  # turns in which bmm was faster
        bound, by = self.bound_ms((B * C * C + 2 * B * C * 2) * 4,
                                  2 * B * C * C * 2)
        log(f"[cell_mixing] allclose 1e-5 and mass kept at rounds 1, 8; at "
            f"{(B, C, 2)}: kernel {ms:.4f} ms a call, {dev_ms:.4f} ms on "
            f"the device (CUDA graph); torch.bmm {library:.4f} ms a call, "
            f"{dev_library:.4f} ms on the device; plain {plain:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")
        log(f"[cell_mixing] a call, five turns: kernel "
            f"{', '.join(f'{t:.4f}' for t in ours)} ms; torch.bmm "
            f"{', '.join(f'{t:.4f}' for t in bmms)} ms; the kernel slower "
            f"in {lost} of 5 turns")
        check(dev_ms <= dev_library, f"cell_mixing {dev_ms} ms on the "
              f"device, slower than torch.bmm's {dev_library} ms")
        check(ms <= library, f"cell_mixing {ms} ms a call, slower than "
              f"torch.bmm's {library} ms in the same run")
        self.kernels["cell_mixing"] = dict(
            name="cell_mixing", route="cuda",
            source="src/repro_torch/csrc/cell_mixing.cu",
            replaces="src/repro/kernels/cell_mixing/kernel.py:27",
            launches=None, max_abs_err=worst, ms=ms, device_ms=dev_ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=library,
            library_device_ms=dev_library, turns_ms=ours,
            library_turns_ms=bmms, turns_lost=lost,
            shape=dict(B=B, m=C, d=2, rounds=1))

    def setup(self, n):
        import numpy as np
        from repro_torch.core import build_plan, random_geometric_graph

        t0 = time.perf_counter()
        g = random_geometric_graph(n, seed=1000 + n)
        t1 = time.perf_counter()
        plan = build_plan(g, seed=0)
        t2 = time.perf_counter()
        x0 = np.random.default_rng(n).normal(0, 1, n)
        return g, plan, x0, t1 - t0, t2 - t1

    def run(self, g, plan, x0, backend, schedule="presampled"):
        import repro_torch.core as P

        opts = P.ExecOptions(backend=backend, schedule=schedule)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = P.multiscale_gossip(g, x0, plan=plan, options=opts, **FI)
        self.torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    @staticmethod
    def fi_chunks(plan, check_every: int = 64) -> int:
        """Value-pass launches of one FI trial as the plan gives them: each
        level runs its fixed tick budget in whole chunks."""
        return sum(maxt // chk for maxt, chk in
                   Smoke.fi_levels(plan, check_every))

    def large_n(self, n, g, plan, x0, graph_s, plan_s):
        """The main path: FI multiscale gossip through the pair_apply
        kernel, against the recorded count/error and the plain backend."""
        import numpy as np

        want_msgs, want_err = LARGE_N[n]
        self.zero_counts()
        res, exec_s = self.run(g, plan, x0, "cuda")
        counts = self.read_counts()
        launches = counts["pair_apply"]
        err = res.error(x0)
        self.main_x[n] = res.x_final
        log(f"[main n={n}] cuda backend: messages {res.messages}, error "
            f"{err:.9f}, pair_apply launches {launches}, sample_chunk "
            f"launches {counts['sample_chunk']}; graph {graph_s:.2f} s, plan "
            f"{plan_s:.2f} s, execute {exec_s:.3f} s")
        want_launches = self.fi_chunks(plan)
        check(launches == want_launches == MAIN_PATH_LAUNCHES[n],
              f"n={n}: pair_apply launched {launches} times; the plan gives "
              f"{want_launches}, recorded {MAIN_PATH_LAUNCHES[n]}")
        check(counts["sample_chunk"] == launches,
              f"n={n}: sample_chunk launched {counts['sample_chunk']} times, "
              f"the value pass {launches}")
        self.check_idle(counts, ("pair_apply", "sample_chunk"),
                        f"n={n} cuda backend")
        check(res.messages == want_msgs,
              f"n={n}: messages {res.messages} != recorded {want_msgs}")
        check(abs(err - want_err) <= 1e-6,
              f"n={n}: error {err} not within 1e-6 of {want_err}")
        check(np.isfinite(res.x_final).all() and res.x_final.shape == (n,),
              "x_final is not n finite values")
        row = dict(n=n, levels=len(plan.levels), messages=res.messages,
                   error=err, pair_apply_launches=launches,
                   sample_chunk_launches=counts["sample_chunk"],
                   graph_s=graph_s, plan_s=plan_s, execute_s=exec_s)
        ref, ref_s = self.run(g, plan, x0, "ref")
        check(np.array_equal(ref.x_final.view(np.int32),
                             res.x_final.view(np.int32)),
              f"n={n}: cuda x_final != ref backend x_final")
        check(ref.messages == res.messages
              and np.array_equal(ref.node_sends, res.node_sends),
              f"n={n}: accounting differs between backends")
        log(f"[main n={n}] ref backend bitwise equal; execute {ref_s:.3f} s")
        row["execute_ref_s"] = ref_s
        # a second, warm run of the kernel path, then a traced one
        _, row["execute_warm_s"] = self.run(g, plan, x0, "cuda")
        row.update(self.profile(n, g, plan, x0, row["execute_warm_s"]))
        self.report[f"large_n_{n}"] = row
        if n == 100_000:
            traced = row.get("device_launches")
            check(traced is not None and traced <= MAIN_TRACE_LAUNCHES,
                  f"n={n}: the traced trial made {traced} device launches, "
                  f"beyond {MAIN_TRACE_LAUNCHES}")
        return launches

    def scenarios(self, g, plan, x0):
        """The failure-scenario path at full size: `run_scenario_matrix`
        on the n=10^5 plan, each scenario of scenario_matrix() priced
        with SCENARIO_COST, SCENARIO_TRIALS trials, through the
        sample_chunk and pair_apply kernels.  Each scenario again through
        `execute_plan` on backend "cuda" and "ref", bitwise equal; the
        baseline keeps the recorded count and the unpriced run's x_final;
        the churn + cost run traced.  Returns the launches of one matrix
        pass."""
        import numpy as np
        import repro_torch.core as P

        cost = P.CostModel(**SCENARIO_COST)
        matrix = P.scenario_matrix()
        kw = dict(eps=FI["eps"], weighted=FI["weighted"],
                  fixed_ticks_scale=FI["fixed_ticks_scale"])
        seeds = tuple(FI["seed"] + t for t in range(SCENARIO_TRIALS))
        chunks = self.fi_chunks(plan)
        rows, results = {}, {}
        for rep in ("execute_s", "execute_warm_s"):
            self.zero_counts()
            for sc in matrix:
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                (res,) = P.run_scenario_matrix(
                    g, x0, [sc], trials=SCENARIO_TRIALS, seed=FI["seed"],
                    plan=plan, cost=cost, **kw)
                self.torch.cuda.synchronize()
                rows.setdefault(sc.name, {})[rep] = time.perf_counter() - t0
                results[sc.name] = res
            counts = self.read_counts()
            for name in ("sample_chunk", "pair_apply"):
                check(counts[name] == len(matrix) * chunks,
                      f"scenario matrix: {name} launched {counts[name]} "
                      f"times, {len(matrix)} scenarios of {chunks} chunks "
                      f"give {len(matrix) * chunks}")
            self.check_idle(counts, ("sample_chunk", "pair_apply"),
                            "the scenario matrix")
        launches = counts["pair_apply"]
        for sc in matrix:
            runs = {backend: P.execute_plan(
                plan, x0, seeds=seeds, failures=sc.failures, cost=cost,
                options=P.ExecOptions(backend=backend), **kw)
                for backend in ("cuda", "ref")}
            cu, ref = runs["cuda"], runs["ref"]
            check(np.array_equal(cu.x_final.view(np.int32),
                                 ref.x_final.view(np.int32)),
                  f"scenario {sc.name}: cuda x_final != ref backend x_final")
            for f in ("messages", "node_sends", "level_messages"):
                check(np.array_equal(getattr(cu, f), getattr(ref, f)),
                      f"scenario {sc.name}: {f} differs between backends")
            for f in ("retransmissions", "congestion"):
                check(np.array_equal(getattr(cu.cost, f),
                                     getattr(ref.cost, f)),
                      f"scenario {sc.name}: cost {f} differs between "
                      f"backends")
            res = results[sc.name]
            check(np.array_equal(res.messages, cu.messages)
                  and np.array_equal(res.errors,
                                     P.trials_error(cu.x_final, x0)),
                  f"scenario {sc.name}: run_scenario_matrix differs from "
                  f"execute_plan")
            check(np.isfinite(cu.x_final).all()
                  and cu.x_final.shape == (SCENARIO_TRIALS, plan.graph.n),
                  f"scenario {sc.name}: x_final is not finite of shape "
                  f"(trials, n)")
            rows[sc.name].update(
                error=res.err_mean, survivor_error=float(
                    res.survivor_errors.mean()),
                messages=float(res.messages.mean()),
                energy=res.energy_mean,
                retransmissions=float(res.cost.retransmissions.mean()),
                congestion=float(res.cost.congestion.mean()))
            if sc.name == "baseline":
                check(int(cu.messages[0]) == LARGE_N[plan.graph.n][0],
                      f"priced baseline: trial-0 messages {cu.messages[0]} "
                      f"!= recorded {LARGE_N[plan.graph.n][0]}")
                check(np.array_equal(
                    cu.x_final[0].view(np.int32),
                    self.main_x[plan.graph.n].view(np.int32)),
                    "priced baseline: trial-0 x_final != the unpriced run's")
        for name, row in rows.items():
            log(f"[scenarios n={plan.graph.n}] {name}: error "
                f"{row['error']:.6f}, survivor error "
                f"{row['survivor_error']:.6f}, messages {row['messages']:.1f}, "
                f"energy {row['energy']:.1f} (retransmissions "
                f"{row['retransmissions']:.1f}, congestion "
                f"{row['congestion']:.2f}); execute {row['execute_s']:.3f} s, "
                f"warm {row['execute_warm_s']:.3f} s")
        log(f"[scenarios n={plan.graph.n}] cuda == ref backend bitwise in "
            f"x_final, messages, node_sends, level_messages, retransmissions "
            f"and congestion for all {len(matrix)} scenarios; baseline "
            f"messages {LARGE_N[plan.graph.n][0]} and x_final as unpriced; "
            f"{chunks} launches of sample_chunk and pair_apply a scenario "
            f"({SCENARIO_TRIALS} trials a launch)")
        # the churn + cost run traced, its launches counted
        churn = {sc.name: sc for sc in matrix}["churn"].failures

        def run_churn():
            return P.execute_plan(plan, x0, seeds=seeds, failures=churn,
                                  cost=cost, **kw)

        self.zero_counts()
        rows_t, traced_s = self.trace(run_churn)
        counts = self.read_counts()
        check(counts["sample_chunk"] == counts["pair_apply"] == chunks,
              f"traced churn + cost run: launches {counts}, want {chunks} "
              f"of sample_chunk and pair_apply")
        self.check_idle(counts, ("sample_chunk", "pair_apply"),
                        "the traced churn + cost run")
        prof = self.busy(f"scenario churn + cost n={plan.graph.n}", rows_t,
                         traced_s, rows["churn"]["execute_warm_s"],
                         "pair_apply")
        traced = prof.get("device_launches")
        check(traced is not None and traced <= MAIN_TRACE_LAUNCHES,
              f"the traced churn + cost run made {traced} device launches, "
              f"beyond {MAIN_TRACE_LAUNCHES}")
        if "device_busy_ms" in prof:
            prof["sample_chunk_device_ms"] = sum(
                r[0] for r in rows_t if "sample_chunk" in r[2]) / 1e3
        self.report[f"scenarios_{plan.graph.n}"] = dict(
            trials=SCENARIO_TRIALS, cost=SCENARIO_COST, scenarios=rows,
            launches_per_scenario=chunks, churn_profile=prof)
        return launches

    def trace(self, fn):
        """Run `fn` once under torch.profiler.  Returns the device-side
        kernel rows (device us, launches, name), largest first, and the
        traced wall seconds.  Device-side events only: the CPU-side op
        that launched a kernel carries the same device time again."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        rows = [(float(ev.self_device_time_total), int(ev.count), ev.key)
                for ev in prof.key_averages()
                if ev.device_type == cuda and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        return rows, traced_s

    def busy(self, label, rows, traced_s, warm_s, kernel):
        """Device busy time, idle share against the untraced warm wall
        clock, and `kernel`'s device time, from `trace` rows."""
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            log(f"[profile {label}] the trace holds no device time: not "
                f"measured")
            return {"profile": "not measured"}
        kernel_ms = sum(r[0] for r in rows if kernel in r[2]) / 1e3
        out = {
            "device_busy_ms": busy_ms,
            "device_launches": sum(r[1] for r in rows),
            "traced_wall_s": traced_s,
            "idle_share": 1.0 - busy_ms / (warm_s * 1e3),
            f"{kernel}_device_ms": kernel_ms,
            "top_kernels": [dict(name=k[:160], device_ms=us / 1e3, count=c)
                            for us, c, k in rows[:10]],
        }
        log(f"[profile {label}] device busy {busy_ms:.2f} ms in "
            f"{out['device_launches']} launches over a {warm_s * 1e3:.1f} ms "
            f"warm run (idle share {out['idle_share']:.3f}); {kernel} "
            f"{kernel_ms:.3f} ms")
        for row in out["top_kernels"][:5]:
            log(f"[profile {label}]   {row['device_ms']:.3f} ms "
                f"x{row['count']} {row['name'][:100]}")
        return out

    def profile(self, n, g, plan, x0, warm_s):
        """Device time by kernel over one traced execute, and that of the
        sample_chunk kernel beside pair_apply's."""
        rows, traced_s = self.trace(lambda: self.run(g, plan, x0, "cuda"))
        out = self.busy(f"n={n}", rows, traced_s, warm_s, "pair_apply")
        if "device_busy_ms" in out:
            out["sample_chunk_device_ms"] = sum(
                r[0] for r in rows if "sample_chunk" in r[2]) / 1e3
            log(f"[profile n={n}] sample_chunk "
                f"{out['sample_chunk_device_ms']:.3f} ms")
        return out

    def matmul(self, g, plan, x0):
        """FI multiscale gossip at n=20000 through compose_schedule and the
        cell_mixing kernel, against the recorded count and the cuda
        backend."""
        import numpy as np

        self.zero_counts()
        mm, mm_s = self.run(g, plan, x0, "matmul")
        counts = self.read_counts()
        launches = counts["cell_mixing"]
        want_launches = self.fi_chunks(plan)
        check(launches == want_launches,
              f"n=20000 matmul: cell_mixing launched {launches} times, the "
              f"plan gives {want_launches}")
        check(counts["sample_chunk"] == launches,
              f"n=20000 matmul: sample_chunk launched "
              f"{counts['sample_chunk']} times, the value pass {launches}")
        self.check_idle(counts, ("cell_mixing", "sample_chunk"),
                        "the matmul backend")
        cu, _ = self.run(g, plan, x0, "cuda")
        check(mm.messages == LARGE_N[20_000][0] == cu.messages,
              f"n=20000 matmul messages {mm.messages} != "
              f"{LARGE_N[20_000][0]}")
        check(np.allclose(mm.x_final, cu.x_final, rtol=1e-4, atol=2e-4),
              "n=20000 matmul x_final not allclose to the cuda backend")
        log(f"[matmul n=20000] messages {mm.messages}, max |matmul - cuda| "
            f"{float(np.abs(mm.x_final - cu.x_final).max()):.3e}, execute "
            f"{mm_s:.3f} s, cell_mixing launches {launches}")
        self.report["matmul_20000"] = dict(
            messages=mm.messages, execute_s=mm_s,
            cell_mixing_launches=launches,
            sample_chunk_launches=counts["sample_chunk"])
        return launches

    def matmul_scenario(self, g, plan, x0):
        """FI at n=20000 on the matmul backend under the churn and
        Byzantine scenarios, priced: integer accounting bitwise equal to
        backend "cuda"'s, values within the matmul phase's tolerance."""
        import numpy as np
        import repro_torch.core as P

        cost = P.CostModel(**SCENARIO_COST)
        matrix = {sc.name: sc for sc in P.scenario_matrix()}
        kw = dict(eps=FI["eps"], weighted=FI["weighted"], seeds=(FI["seed"],),
                  fixed_ticks_scale=FI["fixed_ticks_scale"], cost=cost)
        chunks = self.fi_chunks(plan)
        out = {}
        for name in ("churn", "byzantine"):
            fm = matrix[name].failures
            self.zero_counts()
            mm = P.execute_plan(plan, x0, failures=fm,
                                options=P.ExecOptions(backend="matmul"), **kw)
            counts = self.read_counts()
            check(counts["cell_mixing"] == counts["sample_chunk"] == chunks,
                  f"matmul {name}: launches {counts}, want {chunks} of "
                  f"cell_mixing and sample_chunk")
            self.check_idle(counts, ("cell_mixing", "sample_chunk"),
                            f"the matmul backend under {name}")
            cu = P.execute_plan(plan, x0, failures=fm,
                                options=P.ExecOptions(backend="cuda"), **kw)
            for f in ("messages", "node_sends", "level_messages"):
                check(np.array_equal(getattr(mm, f), getattr(cu, f)),
                      f"matmul {name}: {f} differs from backend cuda")
            for f in ("retransmissions", "congestion"):
                check(np.array_equal(getattr(mm.cost, f),
                                     getattr(cu.cost, f)),
                      f"matmul {name}: cost {f} differs from backend cuda")
            gap = float(np.abs(mm.x_final - cu.x_final).max())
            check(np.allclose(mm.x_final, cu.x_final, rtol=1e-4, atol=2e-4),
                  f"matmul {name}: x_final not allclose to backend cuda "
                  f"({gap})")
            out[name] = dict(messages=int(mm.messages[0]), max_gap=gap)
            log(f"[matmul n=20000 {name}] messages {mm.messages[0]}, "
                f"retransmissions {mm.cost.retransmissions[0]:.0f}, integer "
                f"accounting == backend cuda, max |matmul - cuda| "
                f"{gap:.3e}, cell_mixing launches {counts['cell_mixing']}")
        self.report["matmul_20000_scenarios"] = out
        return chunks

    def synchronous(self):
        """synchronous_multiscale at n=2000 through the cell_mixing kernel,
        against its plain version on the CPU."""
        import numpy as np
        import repro_torch.core as P

        n = 2000
        g = P.random_geometric_graph(n, seed=1000 + n)
        x0 = np.random.default_rng(n).normal(0, 1, n)
        self.zero_counts()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        sy = P.synchronous_multiscale(g, x0, eps=1e-4, chunk=SYNC_CHUNK)
        sy_s = time.perf_counter() - t0
        counts = self.read_counts()
        launches = counts["cell_mixing"]
        host = P.synchronous_multiscale(g, x0, eps=1e-4, chunk=SYNC_CHUNK,
                                        device="cpu")
        check(sy.messages == host.messages
              and sy.rounds_per_level == host.rounds_per_level,
              f"synchronous messages {sy.messages} != plain {host.messages}")
        check(np.allclose(sy.x_final, host.x_final, rtol=1e-4, atol=1e-5),
              "synchronous x_final not allclose to the plain version")
        check(sy.error(x0[:, None]) < 1e-2, "synchronous run did not average")
        want_launches = sum(r for _, r in sy.rounds_per_level) // SYNC_CHUNK
        check(launches == want_launches > 0,
              f"synchronous: cell_mixing launched {launches} times, its "
              f"rounds per level {sy.rounds_per_level} give {want_launches}")
        self.check_idle(counts, "cell_mixing", "synchronous_multiscale")
        log(f"[synchronous n=2000] messages {sy.messages}, rounds per level "
            f"{sy.rounds_per_level}, error {sy.error(x0[:, None]):.3e}, "
            f"{sy_s:.3f} s, cell_mixing launches {launches}")
        self.report["synchronous_2000"] = dict(
            messages=sy.messages, seconds=sy_s, cell_mixing_launches=launches)
        return launches

    def baselines(self):
        """standard_gossip at n=500 on the card against its plain backend
        on the card, bitwise; fig5's reliable path averaging (host numpy)
        against its recorded counts, beside the card's multiscale run on
        the same graph."""
        import numpy as np
        import repro_torch.core as P

        g = P.random_geometric_graph(500, seed=1500)
        x0 = np.random.default_rng(500).normal(0, 1, 500)
        self.zero_counts()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        sg = P.standard_gossip(g, x0, eps=1e-2, seed=0)
        sg_s = time.perf_counter() - t0
        counts = self.read_counts()
        ref = P.standard_gossip(g, x0, eps=1e-2, seed=0, backend="ref")
        check(np.array_equal(sg.x.view(np.int32), ref.x.view(np.int32))
              and sg.messages == ref.messages
              and sg.iterations == ref.iterations
              and np.array_equal(sg.node_sends, ref.node_sends),
              "standard_gossip: backend cuda differs from ref")
        check(sg.converged, "standard_gossip did not converge")
        chunks = sg.iterations // 64
        check(counts["pair_apply"] == counts["sample_chunk"] == chunks,
              f"standard_gossip: launches {counts}, want {chunks} chunks of "
              f"sample_chunk and pair_apply")
        self.check_idle(counts, ("sample_chunk", "pair_apply"),
                        "standard_gossip")
        log(f"[baselines] standard_gossip n=500 eps 1e-2: messages "
            f"{sg.messages}, ticks {sg.iterations}, error "
            f"{sg.error(x0):.3e}, {sg_s:.3f} s, cuda == ref bitwise, "
            f"{chunks} launches of pair_apply and sample_chunk")
        n = 2000
        g2 = P.random_geometric_graph(n, seed=21)
        x2 = np.random.default_rng(3).normal(0, 1, n)
        t0 = time.perf_counter()
        pa = [P.path_averaging(g2, x2, eps=1e-4, seed=s) for s in range(3)]
        pa_s = time.perf_counter() - t0
        pa_msgs = [r.messages for r in pa]
        check(pa_msgs == FIG5_PATH_AVERAGING,
              f"fig5 path averaging messages {pa_msgs} != recorded "
              f"{FIG5_PATH_AVERAGING}")
        self.zero_counts()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = P.multiscale_gossip(g2, x2, eps=1e-4, seed=0, weighted=True,
                                 trials=3)
        self.torch.cuda.synchronize()
        ms_s = time.perf_counter() - t0
        ms_counts = self.read_counts()
        self.check_idle(ms_counts, ("sample_chunk", "pair_apply"),
                        "fig5 multiscale")
        ms_msgs = [int(m) for m in ms.messages]
        log(f"[baselines] fig5 n=2000 eps 1e-4, 3 trials: path averaging "
            f"(host numpy) messages {pa_msgs} == recorded, {pa_s:.3f} s; "
            f"multiscale on the card (eps oracle) messages {ms_msgs} "
            f"(recorded {FIG5_MULTISCALE}), {ms_s:.3f} s, "
            f"{ms_counts['pair_apply']} pair_apply launches")
        self.report["baselines"] = dict(
            standard_gossip=dict(messages=sg.messages, ticks=sg.iterations,
                                 seconds=sg_s, launches=chunks),
            fig5_path_averaging=dict(messages=pa_msgs, seconds=pa_s),
            fig5_multiscale=dict(messages=ms_msgs, seconds=ms_s,
                                 recorded=FIG5_MULTISCALE,
                                 launches=ms_counts["pair_apply"]))
        return chunks, ms_counts["pair_apply"]

    # ------------------------------------------------------ rwkv6-3b
    def rwkv6(self):
        """The wkv kernel against its plain version on the card: at the
        prefill's shape (bf16 r/k/v/u, f32 w, as the model passes them)
        and at odd ones (T not a multiple of 32, N=16, all f32)."""
        torch = self.torch
        from repro_torch.kernels.rwkv6 import rwkv6_ref, rwkv6_wkv
        from repro_torch.kernels._build import load

        bf16, f32 = torch.bfloat16, torch.float32
        g = self.gen(12)

        def inputs(BH, T, N, dt, wdt):
            def normal(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device=self.dev)
                        * scale).to(dt)
            w = 0.85 + 0.149 * torch.rand((BH, T, N), generator=g,
                                          device=self.dev)
            return (normal(BH, T, N), normal(BH, T, N, scale=0.3),
                    normal(BH, T, N), w.to(wdt), normal(BH, N, scale=0.2))

        worst = 0.0
        main = None
        for BH, T, N, dt, wdt in ((160, 4096, 64, bf16, f32),
                                  (3, 1000, 64, bf16, f32),
                                  (7, 77, 16, bf16, bf16),
                                  (4, 333, 64, f32, f32),
                                  (2, 130, 32, f32, f32),
                                  (5, 200, 16, f32, f32)):
            args = inputs(BH, T, N, dt, wdt)
            got = rwkv6_wkv(*args)
            torch.cuda.synchronize()
            want = rwkv6_ref(*args)
            tol = RWKV6_TOL["bfloat16" if dt == bf16 else "float32"]
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            check(got.dtype == dt and got.shape == (BH, T, N),
                  f"rwkv6 kernel output {got.dtype} {tuple(got.shape)}")
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"rwkv6 kernel != plain version at {(BH, T, N, dt, wdt)} "
                  f"(max abs err {err})")
            if main is None:
                main = args
        BH, T, N = main[0].shape
        ms = self.time_ms(lambda: rwkv6_wkv(*main), reps=20)
        plain = self.time_ms(lambda: rwkv6_ref(*main), reps=1, warmup=1)
        # each input read once (r, k, v, u bf16; w f32), y written once;
        # the operations the function needs a step: S^T r (N^2 FMAs) and
        # diag(w) S + k v^T (N^2 products, N^2 FMAs), 5 N^2; the bonus
        # adds v (sum_n u_n k_n r_n) to y, 5 N
        elems = BH * T * N
        nbytes = elems * (3 * 2 + 4 + 2) + BH * N * 2
        bound, by = self.bound_ms(nbytes, (5 * N * N + 5 * N) * T * BH)
        split = (ctypes.c_int * 3)()
        check(load("rwkv6").rwkv6_split(N, split) == 0,
              f"rwkv6 kernel compiled for no head size {N}")
        vc, ks, cpt = split
        log(f"[rwkv6] allclose to the plain version ({RWKV6_TOL}) at 6 "
            f"shapes, max abs err {worst:.3e}; at {(BH, T, N)} bf16 (f32 "
            f"w): kernel {ms:.4f} ms with VC={vc} columns a block, KS={ks} "
            f"lanes a column, CPT={cpt} columns a lane ({ms / bound:.2f}x "
            f"its bound, {bound / ms:.3f} of it), plain {plain:.2f} ms, "
            f"bound {bound:.4f} ms ({by})")
        check(ms <= RWKV6_LIMIT_MS, f"rwkv6 kernel {ms} ms at {(BH, T, N)}, "
              f"beyond {RWKV6_LIMIT_MS} ms")
        self.kernels["rwkv6"] = dict(
            name="rwkv6", route="cuda", source="src/repro_torch/csrc/rwkv6.cu",
            replaces="src/repro/kernels/rwkv6/kernel.py:33",
            launches=None, max_abs_err=worst, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None,
            split=dict(VC=vc, KS=ks, CPT=cpt),
            shape=dict(BH=BH, T=T, N=N, dtype="bfloat16", w="float32"))

    def model(self, cfg):
        torch = self.torch
        from repro_torch.models import Transformer

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = Transformer(cfg).init(seed=MODEL_SEED, device=self.dev)
        torch.cuda.synchronize()
        log(f"[{cfg.name} {cfg.dtype}] {model.num_params} parameters drawn "
            f"on the card in {time.perf_counter() - t0:.2f} s")
        return model

    def prefill(self, model, cfg, kernel: str, want: int, symbol: str,
                by_kernel=None, shape=PREFILL, extra=None):
        """`forward` on `shape` (4 prompts of 4096 tokens unless given;
        `extra` adds the batch's frames or M-RoPE positions): `want`
        launches of `kernel` (one a layer that runs it) and none of the
        others (for flash, exactly `by_kernel` of each of its CUDA
        kernels), finite logits, execute seconds, and one traced forward
        (`symbol` names the kernel in the trace)."""
        torch = self.torch
        from repro_torch.models import forward

        B, S = shape
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=self.gen(13),
                               device=self.dev)
        batch = {"tokens": tokens, **(extra or {})}
        torch.cuda.reset_peak_memory_stats()
        self.zero_counts()
        logits = forward(model, cfg, batch)
        torch.cuda.synchronize()
        counts = self.read_counts()
        launches = counts[kernel]
        check(launches == want,
              f"{cfg.name} forward launched the {kernel} kernel {launches} "
              f"times, not once per layer that runs it ({want})")
        self.check_idle(counts, kernel, f"{cfg.name} forward")
        if by_kernel is not None:
            check(self.flash_kernels() == by_kernel,
                  f"{cfg.name} forward launched {self.flash_kernels()}, not "
                  f"{by_kernel}")
        check(tuple(logits.shape) == (B, S, cfg.vocab_size)
              and logits.dtype == torch.float32, "forward logits shape/dtype")
        check(bool(torch.isfinite(logits).all()), "forward logits not finite")
        del logits
        warm = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(model, cfg, batch)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[prefill {cfg.name} {B}x{S}] {kernel} launches {launches}"
            + (f" {by_kernel}" if by_kernel is not None else "") + ", "
            f"logits finite; "
            f"warm execute {warm[0]:.4f} s, {warm[1]:.4f} s "
            f"({B * S / min(warm):.0f} tokens/s), peak memory {peak:.2f} GiB")
        row = dict(batch=B, seq=S, launches=launches, by_kernel=by_kernel,
                   execute_s=warm,
                   tokens_per_s=B * S / min(warm), peak_gib=peak)
        label = f"prefill {cfg.name} {B}x{S}"
        rows, traced_s = self.trace(lambda: forward(model, cfg, batch))
        row.update(self.busy(label, rows, traced_s, min(warm), symbol))
        if "device_busy_ms" in row:
            row["kernel_share"] = (row[f"{symbol}_device_ms"]
                                   / row["device_busy_ms"])
            log(f"[profile {label}] {symbol} share of device time "
                f"{row['kernel_share']:.4f}")
        self.report[f"prefill_{cfg.name}"] = row
        return launches

    def serve(self, model, cfg, symbol: str, frames=None):
        """`Generator` answers 8 requests (64-token prompts, 32 greedy
        steps; with `frames`, an encoder-decoder's 8 requests' frames)
        through decode_step alone: no kernel launch."""
        import numpy as np
        from repro_torch.models import decode_step, init_cache
        from repro_torch.serve import Generator

        torch = self.torch
        B, P, steps = SERVE
        prompts = np.random.default_rng(14).integers(
            0, cfg.vocab_size, (B, P)).astype(np.int32)
        gen = Generator(cfg, model, max_len=P + steps, device=self.dev)
        self.zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(prompts, steps, frames=frames)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        counts = self.read_counts()
        self.check_idle(counts, None, f"{cfg.name} Generator (its prefill is "
                        f"teacher-forced decode)")
        stats = dict(gen.last_stats)
        check(out.shape == (B, stats["decode_steps"]) and 0 < out.shape[1]
              <= steps and out.min() >= 0 and out.max() < cfg.vocab_size,
              f"Generator output {out.shape} out of range")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = gen.generate(prompts, steps, frames=frames)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        check(np.array_equal(out, again), "greedy generate is not repeatable")
        # every token, prompt or generated, is one decode_step row
        step_tokens = B * (P + stats["decode_steps"])
        log(f"[serve {cfg.name} {B}x({P}+{steps})] launches "
            f"{counts}; "
            f"{stats}; cold {cold_s:.3f} s, warm {warm_s:.3f} s: "
            f"{step_tokens / warm_s:.1f} decode tokens/s, "
            f"{stats['live_tokens'] / warm_s:.1f} generated tokens/s")
        row = dict(
            requests=B, prompt=P, steps=steps, launches=counts,
            cold_s=cold_s, warm_s=warm_s, last_stats=stats,
            decode_tokens_per_s=step_tokens / warm_s,
            generated_tokens_per_s=stats["live_tokens"] / warm_s)
        # one decode step traced, against the warm run's mean step
        cache = init_cache(model, cfg, B, P + steps, frames=frames)
        rows, traced_s = self.trace(
            lambda: decode_step(model, cfg, cache, prompts[:, 0]))
        row.update(self.busy(f"decode step {cfg.name} {B}", rows, traced_s,
                             warm_s / (P + stats["decode_steps"]), symbol))
        self.report[f"serve_{cfg.name}"] = row
        return sum(counts.values())

    def agreement(self, model, cfg, checked: bool, frames=None):
        """forward against decode_step fed token by token: the logits at
        every position, and every block alone on the same input, the
        sequence through the block's kernel (the wkv kernel, or the flash
        kernel forced onto its route with chunk_threshold=0; an rglru
        block runs none) against the same tokens one by one through
        decode (the wkv recurrence, decode_attention over the KV cache,
        the rglru state update).  An encoder-decoder's blocks
        cross-attend to the encoder's output over `frames` on both paths
        (with chunk_threshold=0 the forward's takes chunked_attention).
        Held to AGREE_F32_TOL when `checked`, else reported only."""
        torch = self.torch
        from repro_torch._tf32 import no_tf32
        from repro_torch.models import decode_step, forward, init_cache
        from repro_torch.models.model import (
            _block_decode, _block_forward, _embed, layer_state)

        B, S = AGREE
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=self.gen(15),
                               device=self.dev)
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        full = forward(model, cfg, batch)
        cache = init_cache(model, cfg, B, S, frames=frames)
        memory = cache["memory"]
        steps = []
        for t in range(S):
            logits, cache = decode_step(model, cfg, cache, tokens[:, t])
            steps.append(logits)
        dec = torch.stack(steps, 1)
        diff = float((dec - full).abs().max())
        scale = float(full.abs().max())
        check(bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
              f"{cfg.name} {cfg.dtype} agreement: logits not finite")
        # each block on the forward path's input to it, with no
        # amplification by the blocks before it; and the decode path's own
        # hidden states beside the forward path's, layer by layer, which
        # shows how the stack amplifies their gap
        def decode_seq(p, kind, x):
            state = layer_state(cfg, kind, B, S, self.dev)
            outs = []
            for t in range(S):
                out, state = _block_decode(p, cfg, kind, x[:, t:t + 1],
                                           state, t, memory)
                outs.append(out)
            return torch.cat(outs, 1)

        from repro_torch.kernels.flash_attention.ops import KERNELS

        flash = KERNELS[getattr(torch, cfg.dtype)]  # this dtype's kernel
        block_diff, chain_diff = [], []
        tol = AGREE_F32_TOL["block"]
        with no_tf32(), torch.no_grad():
            x = xd = _embed(model, cfg, tokens)
            for p, kind in zip(model.blocks, cfg.layer_kinds()):
                name = {"rwkv": "rwkv6", "rglru": None}.get(
                    kind, "flash_attention")
                want = self.read_counts()
                if name is not None:
                    want[name] += 1
                by_kernel = dict(self.flash_kernels())
                y = _block_forward(p, cfg, kind, x, None, memory=memory,
                                   chunk_threshold=0).float()
                check(self.read_counts() == want,
                      f"{cfg.name} block {len(block_diff)} ({kind}) "
                      f"launched {self.read_counts()}, not {want}")
                if kind in ("attn", "local"):
                    by_kernel[flash] += 1
                check(self.flash_kernels() == by_kernel,
                      f"{cfg.name} {cfg.dtype} block {len(block_diff)}: "
                      f"flash launches {self.flash_kernels()}, not "
                      f"{by_kernel}")
                yd = decode_seq(p, kind, x).float()
                xd = decode_seq(p, kind, xd)
                block_diff.append(float((yd - y).abs().max()))
                chain_diff.append(float((xd.float() - y).abs().max()))
                check(not checked or torch.allclose(yd, y, rtol=tol, atol=tol),
                      f"{cfg.name} {cfg.dtype} block {len(block_diff) - 1}: "
                      f"forward vs decode max abs diff {block_diff[-1]} "
                      f"beyond {tol}")
                x = y.to(xd.dtype)
        # the gap's mean growth a layer, from the first block to the last
        growth = ((chain_diff[-1] / chain_diff[0]) ** (1 / (len(chain_diff) - 1))
                  if chain_diff[0] > 0 and len(chain_diff) > 1 else None)
        if checked:
            tol = AGREE_F32_TOL["logits"]
            check(diff <= tol, f"{cfg.name} {cfg.dtype} forward vs decode: "
                  f"max abs logit diff {diff} (max |logit| {scale}) beyond "
                  f"{tol}")
        log(f"[agree {cfg.name} {cfg.dtype} {B}x{S}] max |forward - decode| "
            f"{diff:.3e} over logits up to {scale:.3f}; per block up to "
            f"{max(block_diff):.3e}; hidden-state gap {chain_diff[0]:.3e} "
            f"after block 0, {chain_diff[-1]:.3e} after block "
            f"{len(chain_diff) - 1} (growth a layer: "
            f"{'none' if growth is None else f'{growth:.3f}x'})"
            + (f", within {AGREE_F32_TOL}" if checked else " (reported only)"))
        self.report[f"agreement_{cfg.name}_{cfg.dtype}"] = dict(
            batch=B, seq=S, max_abs_diff=diff, max_abs_logit=scale,
            block_max_abs_diff=block_diff, hidden_gap=chain_diff,
            gap_growth_per_layer=growth,
            tol=AGREE_F32_TOL if checked else None)

    # ------------------------------------------------------ llama3.2-3b
    def flash(self):
        """The flash kernels against their plain version on the card: bf16
        on the wgmma kernel, f32 on the FMA kernel, each case checked to
        launch its dtype's kernel once and the other not at all.  At the
        llama3.2-3b prefill's per-layer shape (bf16, causal), then at the
        reference kernel tests' shapes and options in both dtypes; the
        prefill shape again in f32 on the same inputs, and the bf16
        kernel's mean error there against the plain version's own bf16
        rounding.  Times both kernels at the prefill shape."""
        import math

        torch = self.torch
        import torch.nn.functional as F
        from repro_torch._tf32 import no_tf32
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention)
        from repro_torch.kernels.flash_attention.ops import KERNELS

        bf16, f32 = torch.bfloat16, torch.float32
        g = self.gen(16)
        cases = (((4, 24, 8, 4096, 128), bf16, {}),
                 ((2, 4, 2, 256, 64), bf16, {}),
                 ((1, 8, 1, 128, 128), f32, {}),
                 ((1, 2, 2, 200, 64), f32, {}),
                 ((1, 2, 2, 384, 64), f32, {"window": 64}),
                 ((1, 2, 2, 384, 64), f32, {"window": 128}),
                 ((1, 2, 2, 256, 64), f32, {"softcap": 30.0}),
                 ((1, 2, 2, 256, 64), f32, {"causal": False}),
                 ((1, 4, 4, 300, 256), bf16, {}),
                 ((1, 8, 1, 128, 128), bf16, {}),
                 ((1, 2, 2, 200, 64), bf16, {}),
                 ((1, 2, 2, 384, 64), bf16, {"window": 64}),
                 ((1, 2, 2, 384, 64), bf16, {"window": 128}),
                 ((1, 2, 2, 256, 64), bf16, {"softcap": 30.0}),
                 ((1, 2, 2, 256, 64), bf16, {"causal": False}),
                 ((1, 4, 4, 300, 64), bf16, {}),
                 ((1, 24, 8, 1000, 128), bf16, {}),
                 ((2, 6, 2, 130, 128), bf16, {}))
        worst, main = 0.0, None
        for (B, Hq, Hkv, S, D), dt, opts in cases:
            q, k, v = (torch.randn((B, h, S, D), generator=g, device=self.dev)
                       .to(dt) for h in (Hq, Hkv, Hkv))
            before = dict(self.flash_kernels())
            got = flash_attention(q, k, v, **opts)
            torch.cuda.synchronize()
            before[KERNELS[dt]] += 1
            check(self.flash_kernels() == before,
                  f"flash at {(B, Hq, Hkv, S, D)} {dt} launched "
                  f"{self.flash_kernels()}, not {before}")
            want = attention_ref(q, k, v, **opts)
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            tol = FLASH_TOL["bfloat16" if dt == bf16 else "float32"]
            check(got.dtype == dt and got.shape == q.shape,
                  f"flash kernel output {got.dtype} {tuple(got.shape)}")
            check(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"flash kernel != plain version at {(B, Hq, Hkv, S, D)} "
                  f"{dt} {opts} (max abs err {err})")
            if main is None:
                main, main_err, main_out, main_ref = (q, k, v), err, got, want
            del want
        # the prefill's shape in f32, on the same inputs, on the f32 kernel:
        # every key tile of every row held at the f32 tolerance
        q32, k32, v32 = (t.float() for t in main)
        before = dict(self.flash_kernels())
        got = flash_attention(q32, k32, v32)
        torch.cuda.synchronize()
        before[KERNELS[f32]] += 1
        check(self.flash_kernels() == before,
              f"flash in f32 launched {self.flash_kernels()}")
        want = attention_ref(q32, k32, v32)
        err32 = float((got - want).abs().max())
        worst = max(worst, err32)
        check(torch.allclose(got, want, rtol=FLASH_TOL["float32"],
                             atol=FLASH_TOL["float32"]),
              f"flash kernel != plain version at {tuple(q32.shape)} f32 "
              f"(max abs err {err32})")
        # the bf16 kernel's error budget against the f32 plain version: P
        # in bf16 adds about the output's own rounding, so its mean error
        # is held to FLASH_BUDGET times that of the plain version rounded
        # to bf16
        mean_err = float((main_out.float() - want).abs().mean())
        mean_round = float((main_ref.float() - want).abs().mean())
        check(mean_err <= FLASH_BUDGET * mean_round,
              f"flash bf16 mean abs err {mean_err} beyond {FLASH_BUDGET}x "
              f"the bf16 rounding's {mean_round}")
        q, k, v = main
        B, Hq, S, D = q.shape
        Hkv = k.shape[1]
        f32_ms = self.time_ms(lambda: flash_attention(q32, k32, v32), reps=3,
                              warmup=1)
        scale = 1.0 / math.sqrt(D)
        del got, want, main_out, main_ref
        # the same f32 function by one PyTorch call (TF32 off) and by the
        # plain version
        with no_tf32():
            f32_library = self.time_ms(
                lambda: F.scaled_dot_product_attention(
                    q32, k32, v32, is_causal=True, scale=scale,
                    enable_gqa=True), reps=3, warmup=1)
        f32_plain = self.time_ms(lambda: attention_ref(q32, k32, v32),
                                 reps=2, warmup=1)
        del q32, k32, v32
        ms = self.time_ms(lambda: flash_attention(q, k, v), reps=20)
        plain = self.time_ms(lambda: attention_ref(q, k, v), reps=2, warmup=1)
        library = self.time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), reps=20)
        # q, k, v read once and o written once; the operations the causal
        # function needs: two products of length D for each of the
        # S(S+1)/2 (query, key) pairs a head keeps, on bf16 inputs with
        # f32 sums, so the tensor cores' bf16 rate bounds them
        nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
        flops = 4 * D * B * Hq * S * (S + 1) // 2
        bound, by = self.bound_ms(nbytes, flops, peak=self.bf16)
        # in f32: twice the bytes; the FMA kernel's f32 rate bounds it
        bound32, by32 = self.bound_ms(2 * nbytes, flops)
        log(f"[flash] allclose to the plain version ({FLASH_TOL}) at "
            f"{len(cases)} shapes and the first again in f32, max abs err "
            f"{worst:.3e}; at the first, max abs err bf16 {main_err:.3e} "
            f"(mean {mean_err:.3e}, {mean_err / mean_round:.3f}x the bf16 "
            f"rounding's {mean_round:.3e}), f32 {err32:.3e}; at "
            f"{(B, Hq, Hkv, S, D)} causal: bf16 kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of its "
            f"bound), f32 kernel {f32_ms:.4f} ms "
            f"({flops / f32_ms / 1e9:.1f} TFLOP/s, bound {bound32:.4f} ms "
            f"{by32}; f32 SDPA {f32_library:.4f} ms, f32 plain "
            f"{f32_plain:.2f} ms), plain {plain:.2f} ms, SDPA {library:.4f} ms "
            f"({ms / library:.3f}x), bound {bound:.4f} ms ({by}, "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        check(ms <= FLASH_SDPA_LIMIT * library,
              f"flash bf16 kernel {ms} ms beyond {FLASH_SDPA_LIMIT}x SDPA's "
              f"{library} ms")
        limit32 = FLASH_F32_LIMIT["llama3.2-3b"]
        check(f32_ms <= limit32 * bound32,
              f"flash f32 kernel {f32_ms} ms beyond {limit32}x its bound "
              f"{bound32} ms")
        self.kernels["flash_attention"] = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention_sm90.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:40",
            launches=None, max_abs_err=worst, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=library,
            f32_source="src/repro_torch/csrc/flash_attention.cu",
            f32_ms=f32_ms, f32_bound_ms=bound32, f32_plain_ms=f32_plain,
            f32_library_ms=f32_library,
            shape=dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D, dtype="bfloat16",
                       causal=True))
        self.report["flash_main_shape_err"] = {
            "bfloat16": main_err, "float32": err32,
            "bfloat16_mean": mean_err, "bfloat16_rounding_mean": mean_round}

    # ----------------------------------------------------------- the zoo
    @staticmethod
    def kept_pairs(S: int, window) -> int:
        """The (query, key) pairs a causal head of S rows keeps, with the
        window where one is given."""
        W = S if window is None else min(window, S)
        return W * (W + 1) // 2 + (S - W) * W

    def flash_zoo(self):
        """Z0: the flash kernels at ZOO_FLASH's shapes.  Each bf16 case
        on the wgmma kernel against the plain version (FLASH_TOL, and its
        mean error within FLASH_BUDGET of the plain version's own bf16
        rounding), timed beside its bound (the kept pairs only), the
        plain version and, where one call computes the same function (no
        softcap), SDPA with the window as a boolean mask; each shape again
        in f32 on the FMA kernel at 2e-5, timed beside its f32 bound
        (recurrentgemma's held to FLASH_F32_LIMIT), and the windowed bf16
        kernel's time at recurrentgemma's shape against its own without
        the window."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import (
            attention_ref, flash_attention)
        from repro_torch.kernels.flash_attention.ops import KERNELS

        bf16, f32 = torch.bfloat16, torch.float32
        g = self.gen(17)
        rows = []
        for label, (B, Hq, Hkv, S, D), opts in ZOO_FLASH:
            main = label.startswith("recurrentgemma")
            q, k, v = (torch.randn((B, h, S, D), generator=g, device=self.dev)
                       .to(bf16) for h in (Hq, Hkv, Hkv))
            before = dict(self.flash_kernels())
            got = flash_attention(q, k, v, **opts)
            torch.cuda.synchronize()
            before[KERNELS[bf16]] += 1
            check(self.flash_kernels() == before,
                  f"flash {label} launched {self.flash_kernels()}")
            # the plain version on bf16 inputs is the f32 computation on
            # their f32 values, rounded to bf16 at the end
            want = attention_ref(q.float(), k.float(), v.float(), **opts)
            plain = want.to(bf16)
            err = float((got.float() - want).abs().max())
            mean_err = float((got.float() - want).abs().mean())
            mean_round = float((plain.float() - want).abs().mean())
            tol = FLASH_TOL["bfloat16"]
            check(got.dtype == bf16 and got.shape == q.shape,
                  f"flash {label}: output {got.dtype} {tuple(got.shape)}")
            check(torch.allclose(got.float(), plain.float(), rtol=tol,
                                 atol=tol),
                  f"flash kernel != plain version at {label} "
                  f"{(B, Hq, Hkv, S, D)} {opts} (max abs err {err})")
            check(mean_err <= FLASH_BUDGET * mean_round,
                  f"flash {label}: bf16 mean abs err {mean_err} beyond "
                  f"{FLASH_BUDGET}x the bf16 rounding's {mean_round}")
            row = dict(label=label, shape=[B, Hq, Hkv, S, D], **opts,
                       max_abs_err=err, mean_abs_err=mean_err,
                       bf16_rounding_mean=mean_round)
            del got, plain
            pairs = B * Hq * self.kept_pairs(S, opts["window"])
            nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
            # the f32 FMA kernel on the same inputs, every row at 2e-5
            q32, k32, v32 = q.float(), k.float(), v.float()
            before = dict(self.flash_kernels())
            got32 = flash_attention(q32, k32, v32, **opts)
            torch.cuda.synchronize()
            before[KERNELS[f32]] += 1
            check(self.flash_kernels() == before,
                  f"flash {label} f32 launched {self.flash_kernels()}")
            err32 = float((got32 - want).abs().max())
            check(torch.allclose(got32, want, rtol=FLASH_TOL["float32"],
                                 atol=FLASH_TOL["float32"]),
                  f"flash kernel != plain version at {label} f32 (max abs "
                  f"err {err32})")
            del got32, want
            f32_ms = self.time_ms(
                lambda: flash_attention(q32, k32, v32, **opts), reps=3,
                warmup=1)
            del q32, k32, v32
            bound32, _ = self.bound_ms(2 * nbytes, 4 * D * pairs)
            row.update(f32_max_abs_err=err32, f32_ms=f32_ms,
                       f32_bound_ms=bound32)
            if label in FLASH_F32_LIMIT:
                limit32 = FLASH_F32_LIMIT[label]
                check(f32_ms <= limit32 * bound32,
                      f"flash {label}: f32 kernel {f32_ms} ms beyond "
                      f"{limit32}x its bound {bound32} ms")
            ms = self.time_ms(lambda: flash_attention(q, k, v, **opts),
                              reps=10)
            plain_ms = self.time_ms(lambda: attention_ref(q, k, v, **opts),
                                    reps=1, warmup=1)
            bound, by = self.bound_ms(nbytes, 4 * D * pairs, peak=self.bf16)
            library = None
            if opts["softcap"] is None:
                i = torch.arange(S, device=self.dev)
                mask = i[None, :] <= i[:, None]
                if opts["window"] is not None:
                    mask &= i[None, :] > i[:, None] - opts["window"]
                library = self.time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=opts["scale"],
                        enable_gqa=True), reps=10)
                del mask
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                       library_ms=library, kept_pairs=pairs)
            if main:
                causal_ms = self.time_ms(
                    lambda: flash_attention(q, k, v, **{**opts,
                                                        "window": None}),
                    reps=10)
                row["causal_ms"] = causal_ms
                row["window_ratio"] = ms / causal_ms
                check(ms <= ZOO_WINDOW_RATIO * causal_ms,
                      f"flash {label}: windowed {ms} ms beyond "
                      f"{ZOO_WINDOW_RATIO}x its causal-only {causal_ms} ms")
            log(f"[flash zoo] {label} {(B, Hq, Hkv, S, D)} window "
                f"{opts['window']} softcap {opts['softcap']}: max abs err "
                f"{err:.3e} (mean {mean_err:.3e}, "
                f"{mean_err / mean_round:.3f}x the bf16 rounding's)"
                + f", f32 {err32:.3e} in {f32_ms:.4f} ms "
                f"({f32_ms / bound32:.3f}x its bound {bound32:.4f} ms)"
                + f"; bf16 kernel {ms:.4f} ms ({bound / ms:.3f} of its bound "
                f"{bound:.4f} ms, {by}; {pairs / 1e6:.2f} M kept pairs), "
                f"plain {plain_ms:.2f} ms, SDPA "
                + ("none" if library is None else f"{library:.4f} ms")
                + (f"; without the window {row['causal_ms']:.4f} ms "
                   f"(ratio {row['window_ratio']:.3f})"
                   if "causal_ms" in row else ""))
            rows.append(row)
            del q, k, v
            torch.cuda.empty_cache()
        self.report["flash_zoo"] = rows
        return rows

    def zoo_config(self, arch: str, dtype: str = "bfloat16", layers=None):
        """The zoo config `arch` in `dtype`, its depth cut to `layers` (or
        ZOO_DEPTH's) where one is given."""
        from repro_torch.configs import get_config

        cfg = get_config(arch)
        depth = layers or ZOO_DEPTH.get(arch, cfg.num_layers)
        return dataclasses.replace(cfg, dtype=dtype, num_layers=depth)

    def zoo_serve(self, arch: str):
        """Z1, Z3, Z4: the bf16 model's prefill (one bf16 flash launch a
        local or global layer, none of any other kernel), Generator (no
        launch) and forward-vs-decode reported; returns the model, the
        config and the launches of each path."""
        cfg = self.zoo_config(arch)
        model = self.model(cfg)
        attn = sum(k in ("attn", "local") for k in cfg.layer_kinds())
        shape = ZOO_PREFILL[arch]
        depth = f", {cfg.num_layers} layers" if arch in ZOO_DEPTH else ""
        launches = {
            f"forward {arch} {shape[0]}x{shape[1]}{depth}":
            self.prefill(model, cfg, "flash_attention", attn,
                         "flash_kernel_sm90",
                         {"flash_attention_sm90": attn, "flash_attention": 0},
                         shape=shape),
            f"Generator {arch} {SERVE[0]}x({SERVE[1]}+{SERVE[2]})":
            self.serve(model, cfg, "flash_kernel_sm90")}
        self.agreement(model, cfg, checked=False)
        return model, cfg, launches

    def zoo_agree(self, arch: str):
        """The f32 copy of the model (depth ZOO_AGREE_DEPTH) held to
        AGREE_F32_TOL, forward against decode, every block on the kernel
        route; for recurrentgemma also the past-the-window local block."""
        torch = self.torch
        cfg32 = self.zoo_config(arch, "float32", ZOO_AGREE_DEPTH.get(arch))
        model32 = self.model(cfg32)
        self.agreement(model32, cfg32, checked=True)
        if arch == "recurrentgemma-9b":
            self.local_wrap(model32, cfg32)
        del model32
        torch.cuda.empty_cache()

    def local_wrap(self, model, cfg):
        """The first local block of the f32 model over 1 x (window +
        ZOO_WRAP) tokens: the kernel route (the f32 flash kernel with the
        window) against decode_attention fed token by token through the
        rotating cache of the window, which wraps ZOO_WRAP positions
        later; each row at AGREE_F32_TOL["block"]."""
        torch = self.torch
        from repro_torch._tf32 import no_tf32
        from repro_torch.kernels.flash_attention.ops import KERNELS
        from repro_torch.models.model import (
            _block_decode, _block_forward, _embed, layer_state)

        layer = cfg.layer_kinds().index("local")
        p = model.blocks[layer]
        S = cfg.window + ZOO_WRAP
        tokens = torch.randint(0, cfg.vocab_size, (1, S),
                               generator=self.gen(18), device=self.dev)
        t0 = time.perf_counter()
        with no_tf32(), torch.no_grad():
            x = _embed(model, cfg, tokens)
            want = dict(self.flash_kernels())
            want[KERNELS[torch.float32]] += 1
            y = _block_forward(p, cfg, "local", x, None)
            check(self.flash_kernels() == want,
                  f"{cfg.name} local block over {S} tokens launched "
                  f"{self.flash_kernels()}, not {want}")
            state = layer_state(cfg, "local", 1, S, self.dev)
            check(state["k"].shape[2] == cfg.window,
                  f"local cache of {state['k'].shape[2]} positions")
            outs = []
            for t in range(S):
                out, state = _block_decode(p, cfg, "local", x[:, t:t + 1],
                                           state, t)
                outs.append(out)
            yd = torch.cat(outs, 1)
        diff = float((yd - y).abs().max())
        tol = AGREE_F32_TOL["block"]
        check(torch.allclose(yd, y, rtol=tol, atol=tol),
              f"{cfg.name} local block {layer} over {S} tokens: forward vs "
              f"decode max abs diff {diff} beyond {tol}")
        secs = time.perf_counter() - t0
        log(f"[agree {cfg.name} local block {layer} 1x{S}] flash (window "
            f"{cfg.window}) vs decode_attention through a cache of "
            f"{cfg.window} that wraps: max abs diff {diff:.3e}, within {tol} "
            f"({secs:.1f} s)")
        self.report[f"local_wrap_{cfg.name}"] = dict(
            layer=layer, seq=S, window=cfg.window, max_abs_diff=diff,
            tol=tol, seconds=secs)

    # ------------------------------ whisper-tiny, chunked_attention, qwen
    def frames(self, cfg, B: int, rng):
        """B requests' frame embeddings (B, encoder_seq, d_model), drawn
        from `rng` on the host in f32 (the stubbed audio frontend)."""
        import numpy as np

        return self.torch.as_tensor(
            rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32), device=self.dev)

    def whisper(self):
        """W1: whisper-tiny at full size.  Prefill PREFILL (one bf16 flash
        launch a decoder layer, none of any other kernel), Generator on
        SERVE's requests with their frames (no launch), and an f32
        copy's forward against decode, every decoder block's
        self-attention on the kernel route, checked.  Returns the
        launches of each path."""
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config

        cfg = get_config("whisper-tiny")
        rng = np.random.default_rng(WHISPER_FRAMES_SEED)
        model = self.model(cfg)
        L = cfg.num_layers
        B, S = PREFILL
        launches = {
            f"forward whisper-tiny {B}x{S}, {cfg.encoder_seq} frames":
            self.prefill(model, cfg, "flash_attention", L,
                         "flash_kernel_sm90",
                         {"flash_attention_sm90": L, "flash_attention": 0},
                         shape=(B, S), extra={"frames": self.frames(cfg, B, rng)}),
            f"Generator whisper-tiny {SERVE[0]}x({SERVE[1]}+{SERVE[2]}), "
            f"{cfg.encoder_seq} frames":
            self.serve(model, cfg, "flash_kernel_sm90",
                       frames=self.frames(cfg, SERVE[0], rng))}
        del model
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = self.model(cfg32)
        self.agreement(model32, cfg32, checked=True,
                       frames=self.frames(cfg, AGREE[0], rng))
        del model32
        torch.cuda.empty_cache()
        return launches

    def chunked(self):
        """X1: `attention()` past chunk_threshold at explicit positions
        (chunked_attention) against the same call forced onto
        full_attention, one block of each CHUNKED_CASES in f32 with
        parameters drawn on the card; then chunked_attention against
        full_attention on that block's q, k and v, the gradients of both
        against one cotangent.  No kernel launches.  Each route timed
        (CUDA events), forward and forward + backward, with its peak
        memory."""
        torch = self.torch
        from repro_torch._tf32 import no_tf32
        from repro_torch.configs import get_config
        from repro_torch.models.attention import (
            _apply_rope, _heads, _mask_bias, _scale, attention, attn_params,
            chunked_attention, full_attention)
        from repro_torch.models.layers import dense

        rows = []
        for label, arch, (B, S), Sm in CHUNKED_CASES:
            cfg = dataclasses.replace(get_config(arch), dtype="float32")
            gen = self.gen(19)
            params = {}
            for name, d in attn_params(cfg, cross=Sm is not None).items():
                params[name] = d.initialize_(
                    torch.empty(d.shape, device=self.dev), gen)
            x = torch.randn((B, S, cfg.d_model), generator=gen,
                            device=self.dev)
            memory = (None if Sm is None else
                      torch.randn((B, Sm, cfg.d_model), generator=gen,
                                  device=self.dev))
            Sk = S if Sm is None else Sm
            pos = torch.arange(S, device=self.dev)[None].expand(B, S)
            k_pos = torch.arange(Sk, device=self.dev)[None].expand(B, Sk)
            causal = memory is None
            self.zero_counts()
            with no_tf32(), torch.no_grad():
                got = attention(params, cfg, x, pos, memory=memory)
                want = attention(params, cfg, x, pos, memory=memory,
                                 chunk_threshold=Sk)
                src = x if memory is None else memory
                H, Hkv, dh = cfg.num_heads, cfg.kv_heads, cfg.head_width
                q = _heads(dense(x, params["wq"]), H, dh)
                k = _heads(dense(src, params["wk"]), Hkv, dh)
                v = _heads(dense(src, params["wv"]), Hkv, dh)
                if memory is None:
                    q, k = (_apply_rope(cfg, a, pos) for a in (q, k))
            out_err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=CHUNKED_TOL["out"],
                                 atol=CHUNKED_TOL["out"]),
                  f"X1 {label}: chunked vs full attention max abs diff "
                  f"{out_err} beyond {CHUNKED_TOL['out']}")
            cot = torch.randn(q.shape, generator=gen, device=self.dev)
            kw = dict(softcap=cfg.attn_logit_softcap, scale=_scale(cfg))
            bias = _mask_bias(pos, k_pos, causal=causal, window=None)

            def core(chunked, leaves):
                if chunked:
                    return chunked_attention(*leaves, pos, k_pos,
                                             causal=causal, window=None,
                                             chunk=min(1024, Sk), **kw)
                return full_attention(*leaves, bias, **kw)

            def grads(chunked):
                leaves = [a.clone().requires_grad_() for a in (q, k, v)]
                o = core(chunked, leaves)
                return torch.autograd.grad((o * cot).sum(), leaves)

            times = {}
            with no_tf32():
                got_g, want_g = grads(True), grads(False)
                for route, chunked in (("chunked", True), ("full", False)):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    with torch.no_grad():
                        fwd = self.time_ms(lambda: core(chunked, (q, k, v)),
                                           3, warmup=1)
                    both = self.time_ms(lambda: grads(chunked), 3, warmup=1)
                    times[route] = dict(
                        forward_ms=fwd, forward_backward_ms=both,
                        peak_gib=(torch.cuda.max_memory_allocated() - base)
                        / 2**30)
            grad_err = [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(got_g, want_g)]
            check(max(grad_err) <= CHUNKED_TOL["grad"],
                  f"X1 {label}: gradient of q, k, v off by {grad_err} of "
                  f"their largest element, beyond {CHUNKED_TOL['grad']}")
            counts = self.read_counts()
            self.check_idle(counts, None, f"X1 {label}")
            check(not any(self.flash_kernels().values()),
                  f"X1 {label} launched {self.flash_kernels()}")
            log(f"[chunked X1 {label} {B}x{S} over {Sk} keys, f32] "
                f"attention() chunked vs full max abs diff {out_err:.3e}; "
                f"gradients q, k, v off by "
                f"{', '.join(f'{e:.3e}' for e in grad_err)} of their "
                f"largest element; chunked {times['chunked']}, full "
                f"{times['full']}")
            rows.append(dict(label=label, batch=B, seq=S, keys=Sk,
                             max_abs_err=out_err, grad_rel_err=grad_err,
                             tol=CHUNKED_TOL, **{f"{r}_{k}": v
                                                 for r, t in times.items()
                                                 for k, v in t.items()}))
            del params, x, memory, q, k, v, cot, bias, got_g, want_g
            torch.cuda.empty_cache()
        self.report["chunked_attention"] = rows

    def mrope_positions(self, B: int, S: int):
        """Q1's (B, S, 3) M-RoPE ids: QWEN_LAYOUT's text prefix, patch
        grid and text after it."""
        torch = self.torch
        text, grid = QWEN_LAYOUT["text"], QWEN_LAYOUT["grid"]
        patches = grid * grid
        pos = torch.empty((S, 3), dtype=torch.int64)
        pos[:text] = torch.arange(text)[:, None]
        row, col = torch.arange(patches) // grid, torch.arange(patches) % grid
        pos[text:text + patches] = torch.stack(
            [torch.full_like(row, text), text + row, text + col], -1)
        rest = S - text - patches
        pos[text + patches:] = (text + grid + torch.arange(rest))[:, None]
        return pos[None].expand(B, S, 3).to(self.dev)

    def qwen(self):
        """Q1: qwen2-vl-72b at full width and ZOO_DEPTH's layers, prefill
        at M-RoPE positions (no kernel launch: chunked_attention), then
        block 0's attention in f32 at the same positions, chunked against
        full_attention.  Returns the prefill's launches."""
        torch = self.torch
        from repro_torch._tf32 import no_tf32
        from repro_torch.models.attention import attention
        from repro_torch.models.model import _apply_norm, _embed

        cfg = self.zoo_config("qwen2-vl-72b")
        model = self.model(cfg)
        B, S = QWEN_PREFILL
        pos = self.mrope_positions(B, S)
        launches = self.prefill(
            model, cfg, "flash_attention", 0, "gemm",
            {"flash_attention_sm90": 0, "flash_attention": 0},
            shape=QWEN_PREFILL, extra={"positions": pos})
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p = model.blocks[0]
        params32 = {k: v.float() for k, v in p["attn"].items()}
        tokens = torch.randint(0, cfg.vocab_size, (B, S),
                               generator=self.gen(20), device=self.dev)
        self.zero_counts()
        with no_tf32(), torch.no_grad():
            x = _apply_norm(p["ln1"], cfg32,
                            _embed(model, cfg, tokens).float())
            got = attention(params32, cfg32, x, pos)
            want = attention(params32, cfg32, x, pos, chunk_threshold=S)
        torch.cuda.synchronize()
        self.check_idle(self.read_counts(), None, "Q1 block 0 in f32")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=CHUNKED_TOL["out"],
                             atol=CHUNKED_TOL["out"]),
              f"Q1 block 0 attention at M-RoPE positions: chunked vs full "
              f"max abs diff {err} beyond {CHUNKED_TOL['out']}")
        log(f"[qwen Q1 block 0 f32 {B}x{S}, M-RoPE] chunked vs full "
            f"attention max abs diff {err:.3e}, within "
            f"{CHUNKED_TOL['out']}")
        self.report[f"prefill_{cfg.name}"]["block0_f32_max_abs_err"] = err
        del model, params32, x, got, want
        torch.cuda.empty_cache()
        return {f"forward qwen2-vl-72b {B}x{S}, {cfg.num_layers} layers, "
                f"M-RoPE positions": launches}

    # ---------------------------------------------------------- training
    # ---------------------------------------------------- serving fleet
    def per_tick(self, g, plan, x0):
        """P1: the legacy per-tick schedule on the n=10^5 FI plan.
        Backend "ref" (the plain tick scan, no kernel) is bitwise the
        presampled "cuda" run of the main path; backend "cuda" makes one
        cell_mixing launch a chunk and no other, its integer accounting
        bitwise and its values within PER_TICK_TOL.  Returns the
        cell_mixing launches of the "cuda" run."""
        import numpy as np

        n = plan.graph.n
        want_msgs = LARGE_N[n][0]
        chunks = self.fi_chunks(plan)
        runs, row = {}, {}
        for backend in ("ref", "cuda"):
            self.zero_counts()
            res, secs = self.run(g, plan, x0, backend, schedule="per_tick")
            counts = self.read_counts()
            runs[backend] = res
            row[f"execute_{backend}_s"] = secs
            row[f"{backend}_launches"] = counts
            check(res.messages == want_msgs,
                  f"per-tick {backend}: messages {res.messages} != recorded "
                  f"{want_msgs}")
            check(np.isfinite(res.x_final).all()
                  and res.x_final.shape == (n,),
                  f"per-tick {backend}: x_final is not n finite values")
            if backend == "ref":
                self.check_idle(counts, None, "per-tick backend ref")
            else:
                check(counts["cell_mixing"] == chunks,
                      f"per-tick cuda: cell_mixing launched "
                      f"{counts['cell_mixing']} times, the plan gives "
                      f"{chunks} chunks")
                self.check_idle(counts, "cell_mixing", "per-tick cuda")
        ref, cu = runs["ref"], runs["cuda"]
        check(np.array_equal(ref.x_final.view(np.int32),
                             self.main_x[n].view(np.int32)),
              "per-tick ref x_final != the presampled cuda run's")
        check(np.array_equal(ref.node_sends, cu.node_sends)
              and ref.messages == cu.messages,
              "per-tick: accounting differs between backends")
        gap = float(np.abs(cu.x_final - ref.x_final).max())
        check(np.allclose(cu.x_final, ref.x_final, **PER_TICK_TOL),
              f"per-tick cuda x_final not within {PER_TICK_TOL} of ref "
              f"({gap})")
        row.update(n=n, messages=ref.messages, chunks=chunks,
                   max_abs_gap=gap, error=cu.error(x0))
        log(f"[per-tick n={n}] messages {ref.messages} (both backends), ref "
            f"bitwise to presampled cuda, max |cuda - ref| {gap:.3e}; "
            f"cell_mixing launches {chunks}; execute ref "
            f"{row['execute_ref_s']:.2f} s, cuda {row['execute_cuda_s']:.2f} s")
        self.report[f"per_tick_{n}"] = row
        return chunks

    @staticmethod
    def round_chunks(rr) -> int:
        """A control round's chunks, from its levels' tick budgets (each
        level runs whole chunks of 64 ticks, or one shorter chunk)."""
        return int(sum(t // 64 if t >= 64 else 1 for t in rr.level_ticks))

    def control_plane(self):
        """P2: ControlPlane rounds at CONTROL_R, full view, on backend
        "cuda" against "ref" on the card, bitwise; sample_chunk and
        pair_apply once a chunk; R=1024 held to the reference's counts.
        Returns {R: launches a round}."""
        import numpy as np
        import repro_torch.core as P
        from repro_torch.serve import LOAD_FIELDS, ControlPlane

        torch = self.torch
        out, launches = {}, {}
        for R in CONTROL_R:
            rng = np.random.default_rng(R)
            loads = rng.uniform(0.0, 10.0, (R, len(LOAD_FIELDS)))
            scores = rng.uniform(0.0, 2.0, R)
            t0 = time.perf_counter()
            cp = ControlPlane(R, full_view=True, seed=0, eps=1e-4)
            setup_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp.round(loads, scores, round_idx=0)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            self.zero_counts()
            t0 = time.perf_counter()
            rr = cp.round(loads, scores, round_idx=1)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            counts = self.read_counts()
            chunks = self.round_chunks(rr)
            check(counts["sample_chunk"] == counts["pair_apply"] == chunks,
                  f"control plane R={R}: launches {counts}, want {chunks} "
                  f"of sample_chunk and pair_apply")
            self.check_idle(counts, ("sample_chunk", "pair_apply"),
                            f"control plane R={R}")
            ref = ControlPlane(R, full_view=True, seed=0, eps=1e-4,
                               options=P.ExecOptions(backend="ref"))
            want = ref.round(loads, scores, round_idx=1)
            for f in ("summary", "table", "level_messages", "level_ticks"):
                a, b = getattr(rr, f), getattr(want, f)
                check(a.shape == b.shape and np.array_equal(
                    a.view(np.int32) if a.dtype == np.float32 else a,
                    b.view(np.int32) if b.dtype == np.float32 else b),
                      f"control plane R={R}: {f} differs between cuda and "
                      f"ref")
            check(rr.messages == want.messages,
                  f"control plane R={R}: messages differ between backends")
            check(np.isfinite(rr.table).all()
                  and float(np.abs(rr.table - scores[None]).max()) < 1e-2,
                  f"control plane R={R}: the load table did not average")
            if R == 1024:
                got = dict(messages=rr.messages,
                           level_messages=rr.level_messages.tolist(),
                           level_ticks=rr.level_ticks.tolist())
                check(got == CONTROL_1024,
                      f"control plane R=1024: {got} != {CONTROL_1024}")
            rows, traced_s = self.trace(
                lambda: cp.round(loads, scores, round_idx=1))
            row = dict(levels=list(cp.levels), messages=rr.messages,
                       level_messages=rr.level_messages.tolist(),
                       level_ticks=rr.level_ticks.tolist(),
                       control_bytes=rr.control_bytes,
                       payload_values=rr.payload_values, chunks=chunks,
                       setup_s=setup_s, cold_s=cold_s, warm_s=warm_s,
                       table_max_err=float(np.abs(rr.table
                                                  - scores[None]).max()))
            row.update(self.busy(f"control plane R={R}", rows, traced_s,
                                 warm_s, "pair_apply"))
            if "device_busy_ms" in row:
                row["sample_chunk_device_ms"] = sum(
                    r[0] for r in rows if "sample_chunk" in r[2]) / 1e3
                log(f"[control R={R}] sample_chunk "
                    f"{row['sample_chunk_device_ms']:.3f} ms on the device a "
                    f"round (PR 19: 2.55 ms at R=1024)")
            if R == 1024:
                row.update(self.control_chunk(cp))
            log(f"[control R={R}] levels {cp.levels}, messages {rr.messages} "
                f"{rr.level_messages.tolist()}, ticks "
                f"{rr.level_ticks.tolist()}, {rr.control_bytes} bytes a "
                f"round; cuda == ref bitwise; {chunks} launches of "
                f"sample_chunk and pair_apply; setup {setup_s:.2f} s, cold "
                f"{cold_s:.3f} s, warm {warm_s:.4f} s a round")
            out[R] = row
            launches[R] = chunks
        self.report["control_plane"] = out
        return launches

    def control_chunk(self, cp):
        """One chunk of a ControlPlane round's finest level, timed on the
        device beside its bound: every payload field is a trial (4 + R)
        and, as the round draws them, all trials share one key."""
        torch = self.torch
        from repro_torch.core import CsrGraphs, prng
        from repro_torch.kernels.sample_chunk import sample_chunk

        lp = cp.plan.levels[0]
        R, B, T = 4 + cp.R, lp.num_graphs, 64
        adj = CsrGraphs(lp.nbr_start, lp.nbr_flat, lp.hop_flat, lp.degrees,
                        lp.n_nodes).to_device(self.dev)
        keys = prng.fold_in(prng.PRNGKey(0, self.dev)[None], 0).expand(
            R, 2).contiguous()
        done = torch.zeros((R, B), dtype=torch.bool, device=self.dev)
        usage = torch.zeros(R * lp.nbr_flat.shape[0], dtype=torch.int32,
                            device=self.dev)
        msgs = torch.zeros((R, B), dtype=torch.int32, device=self.dev)
        dev_ms = self.device_ms(
            lambda: sample_chunk(0, T, keys, adj, None, done, usage, msgs), 5)
        bound, by, _, _ = self.chunk_bound(lp, T, R)
        log(f"[control R={cp.R}] the finest level's chunk (T={T}, R={R}, "
            f"B={B}, C={lp.degrees.shape[1]}): sample_chunk {dev_ms:.4f} ms "
            f"on the device, bound {bound:.4f} ms ({by})")
        self.kernels["sample_chunk"].update(
            control_device_ms=dev_ms, control_bound_ms=bound,
            control_bound_by=by,
            control_shape=dict(T=T, R=R, B=B, C=lp.degrees.shape[1]))
        return dict(chunk_device_ms=dev_ms, chunk_bound_ms=bound)

    def fleet(self):
        """P3: run_fleet at FLEET for each router on the card against the
        recorded entry, p2c at least FLEET_P2C_OVER_ORACLE of the oracle;
        then FLEET_LARGE_R replicas, reported.  Returns the kernel
        launches of the p2c runs at both sizes."""
        from repro_torch.serve import ROUTERS, FleetConfig, run_fleet

        torch = self.torch
        out, launches = {}, {}
        for R in (FLEET["replicas"], FLEET_LARGE_R):
            rows = {}
            for router in ROUTERS:
                self.zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run_fleet(FleetConfig(replicas=R, ticks=FLEET["ticks"],
                                            router=router,
                                            seed=FLEET["seed"]))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = self.read_counts()
                got = (res.throughput, res.completed, res.control_messages,
                       res.control_bytes, res.admission_latency_mean)
                if router == "p2c_gossip":
                    check(counts["sample_chunk"] == counts["pair_apply"] > 0,
                          f"fleet R={R}: launches {counts}")
                    self.check_idle(counts, ("sample_chunk", "pair_apply"),
                                    f"fleet R={R} p2c_gossip")
                    launches[R] = counts["pair_apply"]
                else:
                    self.check_idle(counts, None, f"fleet R={R} {router}")
                if R == FLEET["replicas"]:
                    check(got == FLEET_RECORDED[router],
                          f"fleet R={R} {router}: {got} != recorded "
                          f"{FLEET_RECORDED[router]}")
                rows[router] = dict(
                    throughput=res.throughput, completed=res.completed,
                    submitted=res.submitted,
                    admission_latency_mean=res.admission_latency_mean,
                    admission_latency_p95=res.admission_latency_p95,
                    control_rounds=res.control_rounds,
                    control_messages=res.control_messages,
                    control_bytes=res.control_bytes,
                    bytes_per_round=res.bytes_per_round, seconds=secs,
                    launches=counts["pair_apply"])
            ratio = (rows["p2c_gossip"]["throughput"]
                     / rows["oracle"]["throughput"])
            if R == FLEET["replicas"]:
                check(ratio >= FLEET_P2C_OVER_ORACLE,
                      f"fleet R={R}: p2c / oracle {ratio} below "
                      f"{FLEET_P2C_OVER_ORACLE}")
            log(f"[fleet R={R} {FLEET['ticks']} ticks] throughput " + ", ".join(
                f"{k} {v['throughput']:.3f}" for k, v in rows.items())
                + f" (p2c / oracle {ratio:.4f}); p2c "
                f"{rows['p2c_gossip']['control_rounds']} rounds, "
                f"{rows['p2c_gossip']['bytes_per_round']:.0f} bytes a round, "
                f"{rows['p2c_gossip']['seconds']:.2f} s, "
                f"{launches[R]} launches of sample_chunk and pair_apply"
                + (", recorded entry reproduced" if R == FLEET["replicas"]
                   else ""))
            out[R] = dict(routers=rows, p2c_over_oracle=ratio)
        self.report["fleet"] = out
        return launches

    def paged_vs_dense(self, model, cfg):
        """P4(a): paged_decode_step through an identity page map against
        the dense decode_step, teacher-forced, every step's logits
        bitwise."""
        import numpy as np
        from repro_torch.models import (
            decode_step, init_cache, init_paged_cache, paged_decode_step)

        torch = self.torch
        B, ps, P = PAGED["slots"], PAGED["page_size"], PAGED["pages_per_slot"]
        L = P * ps
        toks = np.random.default_rng(16).integers(
            0, cfg.vocab_size, (B, L)).astype(np.int32)
        dense = init_cache(model, cfg, B, L)
        paged = init_paged_cache(model, cfg, B, B * P, ps)
        page_map = torch.arange(B * P, dtype=torch.int32,
                                device=self.dev).reshape(B, P)
        live = torch.ones(B, dtype=torch.bool, device=self.dev)
        t0 = time.perf_counter()
        for t in range(L):
            want, dense = decode_step(model, cfg, dense, toks[:, t])
            steps = torch.full((B,), t, dtype=torch.int32, device=self.dev)
            got, paged = paged_decode_step(model, cfg, paged, toks[:, t],
                                           page_map, steps, live)
            check(torch.equal(got, want),
                  f"{cfg.name} paged vs dense decode: logits differ at step "
                  f"{t} (max {float((got - want).abs().max())})")
        check(bool(torch.isfinite(got).all()), f"{cfg.name}: paged logits not "
              f"finite")
        secs = time.perf_counter() - t0
        log(f"[paged {cfg.name} {B}x{L}] paged_decode_step bitwise to "
            f"decode_step at all {L} steps ({secs:.2f} s for both)")
        return dict(slots=B, positions=L, bitwise=True, seconds=secs)

    def paged_requests(self, cfg):
        """The stream's (prompt, budget) pairs, from default_rng(0)."""
        import numpy as np

        rng = np.random.default_rng(0)
        n = PAGED_REQUESTS[cfg.name]
        plens = rng.integers(*PAGED["prompt"], n)
        budgets = rng.integers(*PAGED["budget"], n)
        return [(rng.integers(0, cfg.vocab_size, int(p)).astype(np.int32),
                 int(b)) for p, b in zip(plens, budgets)]

    def paged_engine(self, model, cfg):
        """A BatchingEngine over a fresh ModelBackend of PAGED's shape,
        and a one-element list counting its paged steps."""
        from repro_torch.serve import BatchingEngine, ModelBackend, PageTable

        steps = [0]

        # counts in a subclass: a wrapper stored on the instance would
        # close over the backend, a reference cycle that keeps the model
        # and its pools on the card until the garbage collector runs
        class Counted(ModelBackend):
            def _step(self, *args):
                steps[0] += 1
                return super()._step(*args)

        table = PageTable(num_pages=PAGED["pool"],
                          page_size=PAGED["page_size"],
                          num_slots=PAGED["slots"],
                          pages_per_slot=PAGED["pages_per_slot"])
        backend = Counted(cfg, model, num_slots=PAGED["slots"],
                          num_pages=PAGED["pool"],
                          page_size=PAGED["page_size"],
                          max_prompt_len=PAGED["prompt"][1] - 1,
                          device=self.dev)
        return BatchingEngine(backend, table, eos_id=-1), steps

    def serve_paged(self, model, cfg):
        """P4(b) / P5: the paged engine on a stream that retires and
        refills slots: every request completes with its budget, the pool
        is whole again, and REPLAYS refilled requests give the same tokens
        alone in a fresh engine (a row never depends on its neighbours,
        and no recurrent state leaks into a reused slot).  Reports
        generated tokens/s, paged steps a second, launches a step and the
        idle share of one traced decode step."""
        import numpy as np

        torch = self.torch
        requests = self.paged_requests(cfg)
        eng, steps = self.paged_engine(model, cfg)
        warm = eng.backend.warmup(eng.table)
        steps[0] = 0
        for prompt, budget in requests:
            eng.submit(prompt, budget)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        check(len(done) == len(requests)
              and all(len(r.tokens) == r.max_new_tokens for r in done),
              f"{cfg.name} paged engine: {len(done)} of {len(requests)} "
              f"requests completed with their budgets")
        check(eng.table.free_pages == eng.table.num_pages,
              f"{cfg.name} paged engine: {eng.table.free_pages} of "
              f"{eng.table.num_pages} pages free at the end")
        check(all(0 <= t < cfg.vocab_size for r in done for t in r.tokens),
              f"{cfg.name} paged engine: a token out of the vocabulary")
        refills = sorted((r for r in done if r.admitted > 0),
                         key=lambda r: (len(r.prompt) + r.max_new_tokens,
                                        r.rid))
        check(len(refills) >= REPLAYS,
              f"{cfg.name} paged engine: {len(refills)} refilled requests")
        replayed = []
        for r in refills[:REPLAYS]:
            # the slot this request reused held an earlier request that
            # retired at or before its admission
            prev = [q.rid for q in done if q.slot == r.slot
                    and q.finished <= r.admitted and q.rid != r.rid]
            check(bool(prev), f"{cfg.name}: request {r.rid} did not reuse a "
                  f"slot")
            solo, _ = self.paged_engine(model, cfg)
            solo.submit(r.prompt, r.max_new_tokens)
            (alone,) = solo.run()
            check(alone.tokens == r.tokens,
                  f"{cfg.name} paged engine: request {r.rid} (slot {r.slot}, "
                  f"after request {prev[-1]}) alone gives other tokens")
            replayed.append(dict(rid=r.rid, slot=r.slot, after=prev[-1],
                                 tokens=len(r.tokens)))
            del solo
        generated = sum(len(r.tokens) for r in done)
        # one decode step of a full batch, traced, against the run's mean
        # time a paged step
        B = PAGED["slots"]
        tab = eng.table
        for s in range(B):
            tab.alloc(s, 1)
        live = np.ones(B, bool)
        rows, traced_s = self.trace(lambda: eng.backend.decode(
            np.zeros(B, np.int32), np.zeros(B, np.int32), tab.page_map, live,
            0))
        for s in range(B):
            tab.free(s)
        per_step = run_s / steps[0]
        row = dict(requests=len(requests), slots=B,
                   prompt_tokens=int(sum(len(p) for p, _ in requests)),
                   generated_tokens=generated, engine_steps=eng.t,
                   paged_steps=steps[0], warmup_s=warm, run_s=run_s,
                   generated_tokens_per_s=generated / run_s,
                   paged_steps_per_s=steps[0] / run_s,
                   step_rows_per_s=steps[0] * B / run_s,
                   replays=replayed)
        row.update(self.busy(f"paged decode step {cfg.name} {B}", rows,
                             traced_s, per_step, "gemm"))
        log(f"[paged engine {cfg.name}] {len(requests)} requests through "
            f"{B} slots in {eng.t} engine steps ({steps[0]} paged steps, "
            f"{run_s:.2f} s): {generated / run_s:.1f} generated tokens/s, "
            f"{steps[0] * B / run_s:.1f} slot rows/s, {per_step * 1e3:.1f} "
            f"ms a paged step; pool whole; {len(replayed)} refilled requests "
            f"replayed alone bitwise")
        return row

    def fingerprint(self, tree) -> dict:
        return fingerprint(self.torch, tree)

    def train(self):
        """T1: llama3.2-3b at full width and TRAIN["layers"] layers through
        the port's Trainer: 3 AdamW steps with a checkpoint at step 2,
        killed at the start of step 4 (before its final save); a second
        Trainer resumes at step 2 (the state bitwise the saved one), takes
        step 3 again (traced) and is killed as the first, and its loss is
        held to the first run's."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticLM
        from repro_torch.models import Transformer
        from repro_torch.optim import adamw, cosine_schedule
        from repro_torch.train import (
            Trainer, init_train_state, latest_step, make_train_step,
        )

        cfg = dataclasses.replace(get_config("llama3.2-3b"),
                                  num_layers=TRAIN["layers"])
        check(cfg.remat and cfg.dtype == "bfloat16",
              f"{cfg.name}: remat {cfg.remat}, dtype {cfg.dtype}")
        B, S = TRAIN["batch"], TRAIN["seq"]
        opt = adamw(weight_decay=0.01)
        step = make_train_step(cfg, opt, cosine_schedule(*TRAIN_LR),
                               device=self.dev)
        data = SyntheticLM(cfg.vocab_size, S, B, seed=MODEL_SEED)
        events = []     # (trainer, step taken, start, end)
        saved_fp = {}
        traced = {}
        killed = f"injected failure at step {TRAIN['steps']}"

        def run_until_killed(trainer):
            failure = None
            try:
                trainer.run(TRAIN["steps"] + 1)
            except RuntimeError as e:  # the injected kill, checked here
                failure = str(e)
            check(failure == killed, f"the Trainer ended with {failure!r}")
            return trainer.metrics_history

        def timed(label, fingerprint_at=None, trace=False):
            def fn(state, batch):
                s = state["step"]
                if s == fingerprint_at:   # the state checkpoint 2 holds
                    saved_fp.update(self.fingerprint(state))
                if trace:
                    box = []
                    rows, traced_s = self.trace(
                        lambda: box.append(step(state, batch)))
                    traced.update(rows=rows, traced_s=traced_s)
                    return box[0]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(state, batch)
                end.record()
                events.append((label, s + 1, start, end))
                return out
            return fn

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
            model = Transformer(cfg).init(seed=MODEL_SEED, device=self.dev)
            state = init_train_state(model, opt)
            del model
            first = Trainer(timed("first", TRAIN["save_every"]), state, data,
                            ckpt_dir=ckpt, save_every=TRAIN["save_every"],
                            fail_at_step=TRAIN["steps"], device=self.dev)
            del state
            hist = run_until_killed(first)
            check(latest_step(ckpt) == TRAIN["save_every"],
                  f"checkpoints {latest_step(ckpt)}")
            peak_first = torch.cuda.max_memory_allocated() / 2**30
            del first
            torch.cuda.empty_cache()
            ckpt_gb = sum(p.stat().st_size for p in Path(ckpt).rglob("*")
                          if p.is_file()) / 1e9
            # the second Trainer's state is allocated, not drawn: the
            # restore writes every tensor
            shell = Transformer(cfg).to_empty(device=self.dev)
            torch.cuda.synchronize()
            r0 = time.perf_counter()
            second = Trainer(timed("second", trace=True),
                             init_train_state(shell, opt), data,
                             ckpt_dir=ckpt, save_every=TRAIN["save_every"],
                             fail_at_step=TRAIN["steps"], device=self.dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - r0
            del shell
            check(second.step == TRAIN["save_every"],
                  f"the second Trainer resumed at {second.step}")
            restored_bitwise = self.fingerprint(second.state) == saved_fp
            check(restored_bitwise, "the restored state differs from the "
                  "saved one")
            resumed = run_until_killed(second)
            check(latest_step(ckpt) == TRAIN["save_every"],
                  f"checkpoints {latest_step(ckpt)}")
            del second
            torch.cuda.empty_cache()
        total_s = time.perf_counter() - t0
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(x) for x in losses) and len(losses) == 3,
              f"T1 losses {losses}")
        again = resumed[-1]["loss"]
        gap = abs(again - losses[-1]) / abs(losses[-1])
        check(gap <= TRAIN_RESUME_RTOL,
              f"resumed step 3 loss {again} vs {losses[-1]} ({gap:.2e})")
        ms = [a.elapsed_time(b) for _, _, a, b in events]
        warm_ms = min(ms[1:])
        peak = torch.cuda.max_memory_allocated() / 2**30
        save_s = hist[TRAIN["save_every"] - 1]["sec_per_step"] - \
            ms[TRAIN["save_every"] - 1] / 1e3
        log(f"[train T1 llama3.2-3b {cfg.num_layers} layers {B}x{S}] losses "
            f"{losses}, resumed step "
            f"3 {again} (relative gap {gap:.3e}, bitwise "
            f"{again == losses[-1]}); step ms {[round(x, 2) for x in ms]}, "
            f"{B * S / warm_ms * 1e3:.0f} tokens/s; peak "
            f"{peak_first:.2f} GiB; checkpoint {ckpt_gb:.2f} GB saved in "
            f"about {save_s:.1f} s, restored bitwise in {restore_s:.1f} s; "
            f"phase {total_s:.1f} s")
        row = dict(layers=cfg.num_layers, batch=B, seq=S, losses=losses,
                   resumed_loss=again,
                   resume_gap=gap, restored_bitwise=restored_bitwise,
                   step_ms=ms, tokens_per_s=B * S / warm_ms * 1e3,
                   peak_gib=peak, peak_first_gib=peak_first,
                   checkpoint_gb=ckpt_gb, save_s=save_s,
                   restore_s=restore_s, phase_s=total_s)
        row.update(self.busy("train step llama3.2-3b", traced["rows"],
                             traced["traced_s"], warm_ms / 1e3, "gemm"))
        self.report["train_llama3.2-3b"] = row

    def train_long(self):
        """T1L: one make_train_step step of llama3.2-3b at full size
        (AdamW, T1's schedule) on TRAIN_LONG's 1 x 4096 tokens, past
        chunk_threshold: finite loss, step ms (CUDA events) and peak
        memory."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticLM
        from repro_torch.models import Transformer
        from repro_torch.optim import adamw, cosine_schedule
        from repro_torch.train import init_train_state, make_train_step

        cfg = get_config("llama3.2-3b")
        B, S = TRAIN_LONG["batch"], TRAIN_LONG["seq"]
        opt = adamw(weight_decay=0.01)
        step = make_train_step(cfg, opt, cosine_schedule(*TRAIN_LR),
                               device=self.dev)
        batch = SyntheticLM(cfg.vocab_size, S, B,
                            seed=MODEL_SEED).batch_at(0)
        state = init_train_state(
            Transformer(cfg).init(seed=MODEL_SEED, device=self.dev), opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        loss = float(metrics["loss"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(math.isfinite(loss), f"T1L loss {loss}")
        log(f"[train T1L llama3.2-3b {B}x{S}] loss {loss}, grad norm "
            f"{float(metrics['grad_norm']):.4f}; step {ms:.2f} ms "
            f"({B * S / ms * 1e3:.0f} tokens/s); peak {peak:.2f} GiB")
        self.report["train_long_llama3.2-3b"] = dict(
            batch=B, seq=S, loss=loss, step_ms=ms,
            tokens_per_s=B * S / ms * 1e3, peak_gib=peak)
        del state
        torch.cuda.empty_cache()

    def train_cpu(self):
        """T1b: one sgdm step of llama3.2-3b width at 2 layers in f32 (no
        TF32) on the card and on the CPU from the same weights."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticLM
        from repro_torch.models import Transformer, param_dict
        from repro_torch.optim import sgdm
        from repro_torch.train import init_train_state, make_train_step

        cfg = dataclasses.replace(get_config("llama3.2-3b"),
                                  num_layers=TRAIN_CPU["layers"],
                                  dtype="float32")
        model = Transformer(cfg).init(seed=MODEL_SEED, device=self.dev)
        card = param_dict(model)
        host = {k: v.to("cpu", copy=True) for k, v in card.items()}
        del model
        batch = SyntheticLM(cfg.vocab_size, TRAIN_CPU["seq"],
                            TRAIN_CPU["batch"], seed=MODEL_SEED).batch_at(0)
        out = {}
        for where, params in (("cuda", card), ("cpu", host)):
            state = init_train_state(params, sgdm())
            step = make_train_step(cfg, sgdm(), lambda s: 1e-2,
                                   device=self.dev if where == "cuda"
                                   else "cpu")
            t0 = time.perf_counter()
            state, m = step(state, batch)
            if where == "cuda":
                torch.cuda.synchronize()
            out[where] = (state["params"], float(m["loss"]),
                          float(m["grad_norm"]), time.perf_counter() - t0)
        (pc, lc, gc, tc), (ph, lh, gh, th) = out["cuda"], out["cpu"]
        loss_gap, norm_gap = abs(lc - lh) / abs(lh), abs(gc - gh) / abs(gh)
        worst = max(float((pc[k].cpu() - ph[k]).abs().max()) for k in ph)
        log(f"[train T1b card vs CPU] loss {lc} vs {lh} (relative "
            f"{loss_gap:.2e}), grad norm {gc} vs {gh} ({norm_gap:.2e}), "
            f"largest parameter difference after the step {worst:.3e}; "
            f"{tc:.2f} s on the card (first step), {th:.2f} s on the CPU")
        check(loss_gap <= TRAIN_CPU_TOL["loss"],
              f"T1b loss card {lc} vs CPU {lh}")
        check(norm_gap <= TRAIN_CPU_TOL["grad_norm"],
              f"T1b grad norm card {gc} vs CPU {gh}")
        self.report["train_card_vs_cpu"] = dict(
            loss=(lc, lh), grad_norm=(gc, gh), loss_gap=loss_gap,
            grad_norm_gap=norm_gap, max_param_diff=worst,
            card_s=tc, cpu_s=th)

    def dec_setup(self):
        """T2's model (llama3.2-3b width, 1 layer, bf16) drawn on the
        card, its data stream and its optimizer."""
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticLM
        from repro_torch.models import Transformer, param_dict
        from repro_torch.optim import adamw, cosine_schedule

        cfg = dataclasses.replace(get_config("llama3.2-3b"),
                                  num_layers=DEC["layers"])
        base = param_dict(Transformer(cfg).init(seed=MODEL_SEED,
                                                device=self.dev))
        data = SyntheticLM(cfg.vocab_size, DEC["seq"], DEC["R"],
                           seed=MODEL_SEED)
        return cfg, base, data, adamw(weight_decay=0.01), \
            cosine_schedule(*TRAIN_LR)

    def decentralized(self, cfg, base, data, opt, lr):
        """T2: make_decentralized_step at R=8 in four sync modes, 3 steps
        each, with a gate a mode (module docstring of the constants)."""
        torch = self.torch
        from repro_torch.dist import (
            CompressionConfig, SyncConfig, build_sync_plan, suggest_levels,
        )
        from repro_torch.train import (
            init_decentralized_state, make_decentralized_step, replicate,
        )

        R = DEC["R"]
        levels = suggest_levels(R)
        check(levels == (2, 4), f"suggest_levels({R}) = {levels}")
        wq = "blocks.0.attn.wq"
        modes = {
            "allreduce": SyncConfig("allreduce"),
            "multiscale": SyncConfig("multiscale", levels=levels,
                                     rotation_period=DEC["rotation"]),
            "multiscale_topk": SyncConfig(
                "multiscale", levels=levels, rotation_period=DEC["rotation"],
                compression=CompressionConfig("topk", DEC["topk"])),
            "multiscale_overlap": SyncConfig(
                "multiscale", levels=levels, rotation_period=DEC["rotation"],
                overlap="one_step"),
        }
        rows = {}
        for name, sync in modes.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state = init_decentralized_state(replicate(base, R), opt,
                                             sync=sync)
            step = make_decentralized_step(cfg, opt, lr, sync, R,
                                           device=self.dev)
            ms, consensus, wire, losses, notes = [], [], [], [], {}
            for s in range(DEC["steps"]):
                b = data.batch_at(s)
                batch = {k: v.reshape(R, -1, *v.shape[1:])
                         for k, v in b.items()}
                if name == "multiscale" and s == DEC["steps"] - 1:
                    notes.update(self.dec_mix_check(
                        cfg, state, batch, build_sync_plan(sync, R), wq, s))
                if name == "multiscale_topk" and s == DEC["steps"] - 1:
                    notes.update(self.dec_topk_check(cfg, state, batch,
                                                     sync.compression))
                before = (self.fingerprint({"params": state["params"],
                                            "opt": state["opt"]})
                          if name == "multiscale_overlap" and s == 0 else None)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = step(state, batch)
                end.record()
                m = {k: float(v) for k, v in m.items()}
                ms.append(start.elapsed_time(end))
                consensus.append(m["consensus_distance"])
                wire.append(m["wire_bytes"])
                losses.append(m["loss"])
                check(math.isfinite(m["loss"]), f"T2 {name} loss {m['loss']}")
                if name == "allreduce":
                    same = all(torch.equal(p, p[:1].expand_as(p))
                               for p in state["params"].values())
                    check(same, f"allreduce step {s}: replicas differ")
                if before is not None:
                    after = self.fingerprint({"params": state["params"],
                                              "opt": state["opt"]})
                    check(after == before, "overlap step 0 changed the "
                          "parameters or the optimizer state")
                    check(m["sync_overlap_fraction"] == 0.0,
                          "overlap step 0 reports an overlapped sync")
                    notes["warmup_bitwise_unchanged"] = True
            if "residuals" in state:
                res = float(sum(r.float().norm() ** 2 for r in
                                state["residuals"].values()) ** 0.5)
                check(math.isfinite(res) and res > 0,
                      f"T2 {name} residual norm {res}")
                notes["residual_norm"] = res
            peak = torch.cuda.max_memory_allocated() / 2**30
            del state, step
            torch.cuda.empty_cache()
            log(f"[train T2 {name} R={R}] step ms "
                f"{[round(x, 1) for x in ms]}, losses "
                f"{[round(x, 4) for x in losses]}, consensus distance "
                f"{consensus}, plan_wire_bytes {wire[-1]:.4g}, peak "
                f"{peak:.2f} GiB, {notes}")
            rows[name] = dict(step_ms=ms, losses=losses,
                              consensus_distance=consensus,
                              wire_bytes=wire[-1], peak_gib=peak, **notes)
        self.report["train_decentralized"] = rows

    def dec_grads(self, cfg, state, batch):
        """The clipped per-replica gradients a decentralized step at this
        state and batch mixes."""
        torch = self.torch
        from repro_torch.train import clip_replicas_, replica_grads

        _, grads = replica_grads(cfg, state["params"], {
            k: torch.as_tensor(v, device=self.dev) for k, v in batch.items()})
        with torch.no_grad():
            clip_replicas_(grads, 1.0)
        return grads

    def dec_mix_check(self, cfg, state, batch, plan, leaf, s):
        """The step's mix of one leaf on the card against the port's own
        execute_sync of the same gradient on the CPU."""
        torch = self.torch
        from repro_torch.dist import execute_sync

        grads = self.dec_grads(cfg, state, batch)
        with torch.no_grad():
            g = grads[leaf].clone()
            del grads
            card = execute_sync(plan, {leaf: g}, None, s)[0][leaf]
            host = execute_sync(plan, {leaf: g.cpu()}, None, s)[0][leaf]
        diff = (card.cpu().float() - host.float()).abs()
        bound = DEC_BF16_RTOL * host.float().abs()
        bitwise = torch.equal(card.cpu(), host)
        check(bool((diff <= bound).all()),
              f"multiscale mix of {leaf} on the card vs the CPU: largest "
              f"difference {float(diff.max())}")
        return {"mix_vs_cpu_max_diff": float(diff.max()),
                "mix_vs_cpu_bitwise": bitwise}

    def dec_topk_check(self, cfg, state, batch, comp):
        """Error feedback on the card: every replica's top-k payload plus
        its new residual gives its gradient plus its old residual, in
        every leaf."""
        torch = self.torch
        from repro_torch.dist import compress

        worst, exact = 0.0, True
        grads = self.dec_grads(cfg, state, batch)
        with torch.no_grad():
            for k, g in grads.items():
                old = state["residuals"][k]
                for r in range(g.shape[0]):
                    gr, orr = g[r:r + 1], old[r:r + 1]
                    p, nr = compress({k: gr}, {k: orr}, comp)
                    got = p[k] + nr[k]
                    exact &= torch.equal(got, gr + orr)
                    want = gr.float() + orr.float()
                    worst = max(worst, float(((got.float() - want).abs()
                                              / want.abs().clamp_min(1e-30))
                                             .max()))
                    del p, nr, got, want
            del grads
        check(worst <= DEC_BF16_RTOL, f"top-k payload + residual vs "
              f"gradient + residual: relative {worst}")
        return {"ef_conservation_rel": worst,
                "ef_conservation_bitwise_bf16": exact}

    def train_scenarios(self, cfg, base, data, opt, lr):
        """T3: run_train_scenarios at T2's shape over the default matrix,
        3 steps a scenario; the fault masks drawn on the card equal the
        plain permutation's on the CPU."""
        torch = self.torch
        from repro_torch.dist import SyncConfig, replica_fault_masks
        from repro_torch.train import (
            run_train_scenarios, train_scenario_matrix,
        )

        R = DEC["R"]
        rows = {}
        for sc in train_scenario_matrix():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (res,) = run_train_scenarios(
                cfg, opt, lr, SyncConfig("multiscale"), R, base, data,
                scenarios=[sc], num_steps=DEC["steps"], device=self.dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            check(all(math.isfinite(x) for x in res.losses),
                  f"T3 {sc.name} losses {res.losses}")
            if sc.failures is not None:
                for s in range(DEC["steps"]):
                    a = replica_fault_masks(sc.failures, R, s, self.dev)
                    b = replica_fault_masks(sc.failures, R, s, "cpu")
                    check(all(torch.equal(x.cpu(), y) for x, y in zip(a, b)),
                          f"T3 {sc.name} step {s}: fault masks differ")
            log(f"[train T3 {sc.name} ({sc.aggregation}) R={R}] losses "
                f"{[round(float(x), 4) for x in res.losses]}, final "
                f"{res.final_loss:.4f}, survivor consensus distance "
                f"{res.survivor_error_final:.4g}, live fraction "
                f"{res.effective_replica_fraction_mean}, rejected "
                f"{res.rejected_gradients_total}; {wall / DEC['steps'] * 1e3:.0f}"
                f" ms a step (wall, state set-up included), peak "
                f"{peak:.2f} GiB")
            rows[sc.name] = dict(
                aggregation=sc.aggregation,
                losses=[float(x) for x in res.losses],
                final_loss=res.final_loss,
                survivor_consensus_error=res.survivor_error_final,
                effective_replica_fraction=(
                    res.effective_replica_fraction_mean),
                rejected_gradients=res.rejected_gradients_total,
                ms_per_step_wall=wall / DEC["steps"] * 1e3, peak_gib=peak)
        self.report["train_scenarios"] = rows

    # ------------------------------------------------------ M1-M4 meshes
    def meshes(self, plan, x0) -> dict:
        """M1-M4 (module docstring of the constants): the parent's
        references first (the unsharded 6-trial run, the dense R=4
        training run), then one group of 4 ranks for M1, M2 and M4 and
        one of 8 for M3.  Returns each path's launches of each kernel in
        one rank."""
        torch = self.torch
        from repro_torch.dist.ranks import run_ranks

        t_all = time.perf_counter()
        row = {}
        want, row["m1_reference_s"] = self.mesh_reference(plan, x0)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_m4_") as ref_dir:
            dense, row["m4_reference_s"] = self.mesh_train_reference(ref_dir)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = run_ranks(_mesh_rank, MESH["ranks"], plan, x0, ref_dir,
                              backend="gloo", timeout=MESH["timeout"],
                              threads=_rank_threads(MESH["ranks"]))
            row["group_4_s"] = time.perf_counter() - t0
        paths = self.mesh_check_engine(want, ranks, row)
        paths["m4"] = self.mesh_check_train(dense, ranks, row)
        self.mesh_sync(row)
        row["total_s"] = time.perf_counter() - t_all
        log(f"[mesh] M1-M4 took {row['total_s']:.1f} s: parent references "
            f"{row['m1_reference_s']:.1f} + {row['m4_reference_s']:.1f} s, "
            f"the 4-rank group {row['group_4_s']:.1f} s, the 8-rank group "
            f"{row['group_8_s']:.1f} s")
        self.report["mesh"] = row
        return paths

    def mesh_reference(self, plan, x0):
        """M1's reference: the 6 trials unsharded on the card."""
        torch = self.torch
        import repro_torch.core as P

        fi = {k: v for k, v in FI.items() if k != "seed"}
        self.zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = P.execute_plan(plan, x0, seeds=tuple(range(MESH["trials"])),
                             options=P.ExecOptions(backend="cuda"), **fi)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = self.read_counts()
        check(counts["pair_apply"] == counts["sample_chunk"]
              == MAIN_PATH_LAUNCHES[100_000],
              f"M1 reference launched {counts}")
        check(int(res.messages[0]) == LARGE_N[100_000][0],
              f"M1 reference trial 0: {res.messages[0]} messages, recorded "
              f"{LARGE_N[100_000][0]}")
        log(f"[mesh M1] unsharded {MESH['trials']} trials on the card: "
            f"{dt:.2f} s, messages {res.messages.tolist()}")
        return _mesh_fields(res), dt

    def mesh_check_engine(self, want, ranks, row) -> dict:
        """M1 and M2 in every rank: bitwise to the unsharded run, 33
        launches of sample_chunk and pair_apply, no other kernel."""
        import numpy as np

        paths = {}
        for name, T in (("M1", MESH["trials"]), ("M2", MESH["node_trials"])):
            launches = set()
            for rank, out in enumerate(ranks):
                got = out[name]
                for k, a in want.items():
                    b = got["result"][k]
                    a = a[:T]
                    if a.dtype.kind == "f":
                        a, b = a.view(np.int32), b.view(np.int32)
                    check(a.shape == b.shape and np.array_equal(a, b),
                          f"{name} rank {rank}: {k} differs from the "
                          f"unsharded run")
                counts = got["counts"]
                self.check_idle(counts, ("pair_apply", "sample_chunk"),
                                f"{name} rank {rank}")
                check(counts["pair_apply"] == counts["sample_chunk"]
                      == MAIN_PATH_LAUNCHES[100_000],
                      f"{name} rank {rank} launched {counts}")
                check(not any(got["flash"].values()),
                      f"{name} rank {rank} launched {got['flash']}")
                launches.add(counts["pair_apply"])
            acct = ranks[0][name]["account"]
            secs = [out[name]["seconds"] for out in ranks]
            row[name] = dict(seconds=secs, account=acct,
                             launches_per_rank=launches.pop())
            log(f"[mesh {name}] {len(ranks)} ranks bitwise to the unsharded "
                f"run, {row[name]['launches_per_rank']} launches of "
                f"sample_chunk and pair_apply a rank; execute_plan "
                f"{max(secs):.2f} s; rank 0's collectives {acct}")
            paths[name.lower()] = row[name]["launches_per_rank"]
        row["M2"]["halo_bytes"] = row["M2"]["account"]["psum"]["bytes"]
        return paths

    def mesh_train_reference(self, ref_dir):
        """M4's reference: the dense step at R=4 on the card, 2 steps in
        each mode; each replica's loss before each step, and each
        replica's final parameters written to `ref_dir` for its rank."""
        torch = self.torch
        from repro_torch.optim import cosine_schedule, sgdm
        from repro_torch.train import (
            init_decentralized_state, make_decentralized_step, replica_grads,
            replicate,
        )

        R = MESH_TRAIN["R"]
        t0 = time.perf_counter()
        cfg, base, data = _mesh_train_setup(torch, self.dev)
        opt, lr = sgdm(), cosine_schedule(*TRAIN_LR)
        out = {}
        for mode, sync in _mesh_train_modes().items():
            state = init_decentralized_state(replicate(base, R), opt,
                                             sync=sync)
            step = make_decentralized_step(cfg, opt, lr, sync, R,
                                           device=self.dev)
            losses = []
            for s in range(MESH_TRAIN["steps"]):
                batch = _mesh_batch(data, s, R)
                losses.append(replica_grads(cfg, state["params"], {
                    k: torch.as_tensor(v, device=self.dev)
                    for k, v in batch.items()})[0].tolist())
                state, _ = step(state, batch)
            for r in range(R):
                torch.save({k: p[r].cpu() for k, p in state["params"].items()},
                           Path(ref_dir) / f"{mode}_{r}.pt")
            out[mode] = losses
            del state, step
        del base
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[mesh M4] dense R={R} reference: {dt:.1f} s, losses {out}")
        return out, dt

    def mesh_check_train(self, dense, ranks, row) -> dict:
        """M4 in every rank against the dense step; returns the kernels'
        launches in rank 0 (0 each)."""
        R, rtol = MESH_TRAIN["R"], MESH_TRAIN["rtol"]
        m4 = {}
        for mode, losses in dense.items():
            worst_loss = worst_param = 0.0
            for rank, out in enumerate(ranks):
                got = out["M4"][mode]
                check(got["losses"][0] == losses[0][rank],
                      f"M4 {mode} rank {rank}: step-0 loss "
                      f"{got['losses'][0]!r} != dense {losses[0][rank]!r}")
                for s in range(1, MESH_TRAIN["steps"]):
                    err = abs(got["losses"][s] - losses[s][rank]) / abs(
                        losses[s][rank])
                    worst_loss = max(worst_loss, err)
                    check(err <= rtol, f"M4 {mode} rank {rank} step {s}: "
                          f"loss {got['losses'][s]} vs {losses[s][rank]}")
                for k, err in got["rel"].items():
                    worst_param = max(worst_param, err)
                    check(err <= rtol, f"M4 {mode} rank {rank}: {k} "
                          f"differs by {err} relative")
                self.check_idle(got["counts"], None, f"M4 {mode} rank {rank}")
                check(not any(got["flash"].values()),
                      f"M4 {mode} rank {rank} launched {got['flash']}")
            if mode == "allreduce":
                prints = [out["M4"][mode]["fingerprint"] for out in ranks]
                check(all(p == prints[0] for p in prints),
                      "M4 allreduce: the ranks' parameters differ")
            secs = [out["M4"][mode]["seconds"] for out in ranks]
            m4[mode] = dict(worst_loss_rel=worst_loss,
                            worst_param_rel=worst_param, seconds=secs,
                            account=ranks[0]["M4"][mode]["account"])
            log(f"[mesh M4 {mode}] {R} ranks: step-0 losses bitwise, later "
                f"losses within {worst_loss:.3g}, parameters within "
                f"{worst_param:.3g} relative; {max(secs):.1f} s; rank 0's "
                f"collectives {m4[mode]['account']}")
        row["M4"] = m4
        return ranks[0]["M4"]["allreduce"]["counts"]

    def mesh_sync(self, row):
        """M3: 8 ranks; the parent draws the same rows, and each rank's
        dense row must carry the parent's fingerprint."""
        torch = self.torch
        from repro_torch.dist import build_sync_plan, execute_sync, init_residual
        from repro_torch.dist.ranks import run_ranks

        R = MESH["sync_ranks"]
        full = {"wq": torch.cat(_mesh_sync_rows(torch, self.dev, R))}
        want = {}
        for name, (sync, _) in _mesh_sync_cases().items():
            plan = build_sync_plan(sync, R)
            res = (init_residual(full)
                   if plan.compression.scheme != "none" else None)
            for step in (0, 2):
                mixed = execute_sync(plan, full, res, step)[0]["wq"]
                want[name, step] = [fingerprint(torch, {"wq": mixed[r:r + 1]})
                                    for r in range(R)]
                del mixed
        del full
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(_mesh_sync_rank, R, backend="gloo",
                          timeout=MESH["timeout"], threads=_rank_threads(R))
        row["group_8_s"] = time.perf_counter() - t0
        m3 = {}
        for name, (sync, bitwise) in _mesh_sync_cases().items():
            case = dict(bitwise_gate=bitwise, bytes=0, calls=0, seconds=[])
            for step in (0, 2):
                for rank, out in enumerate(ranks):
                    got = out[name, step]
                    check(got["dense_fingerprint"] == want[name, step][rank],
                          f"M3 {name} step {step} rank {rank}: its dense "
                          f"row differs from the parent's")
                    for part in ("mixed", "residual"):
                        if f"{part}_bitwise" not in got:
                            continue
                        if bitwise:
                            check(got[f"{part}_bitwise"],
                                  f"M3 {name} step {step} rank {rank}: "
                                  f"{part} not bitwise to the dense executor "
                                  f"({got[f'{part}_max_abs_err']})")
                        check(got[f"{part}_over_tol"] == 0,
                              f"M3 {name} step {step} rank {rank}: {part} "
                              f"{got[f'{part}_over_tol']} entries beyond "
                              f"{MESH_SYNC_TOL}")
                    check(got["dropped_zero"] is not False,
                          f"M3 {name} step {step} rank {rank}: a dropped "
                          f"row is not 0")
                    calls = sum(v["calls"] for v in got["account"].values())
                    check(calls > 0, f"M3 {name} step {step} rank {rank}: "
                          f"no collective")
                r0 = ranks[0][name, step]
                case["calls"] += sum(v["calls"] for v in
                                     r0["account"].values())
                case["bytes"] += sum(v["bytes"] for k, v in
                                     r0["account"].items()
                                     if k != "host_copy")
                case["seconds"].append(max(out[name, step]["seconds"]
                                           for out in ranks))
                case[f"step{step}"] = dict(
                    account=r0["account"],
                    max_abs_err=max(out[name, step]["mixed_max_abs_err"]
                                    for out in ranks),
                    all_bitwise=all(out[name, step]["mixed_bitwise"]
                                    for out in ranks))
            m3[name] = case
            log(f"[mesh M3 {name}] {R} ranks x steps 0 and 2: bitwise "
                f"{[case[f'step{s}']['all_bitwise'] for s in (0, 2)]}, "
                f"largest error "
                f"{max(case[f'step{s}']['max_abs_err'] for s in (0, 2)):.3g}"
                f"; rank 0: {case['calls']} collective calls, "
                f"{case['bytes']} bytes; {sum(case['seconds']):.2f} s")
        row["M3"] = m3


# ------------------------------------------------ M1-M4: the rank bodies
# Module-level, so that the ranks (spawned, importing this file without
# running main) can unpickle them.

    def sharded_model(self) -> dict:
        """S1-S5, S2A and S6-S8 (SHARD, SHARD_KINDS, SHARD_WIDE): the
        parent's unsharded AdamW and Adafactor steps and S6-S8's
        unsharded f32 runs first (written to a temp dir), then one group
        of 4 ranks.  Returns each phase's launches of each kernel
        in rank 0."""
        torch = self.torch
        from repro_torch.dist.ranks import run_ranks
        from repro_torch.optim import adamw
        from repro_torch.train import init_train_state, make_train_step

        row = {}
        t_all = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_s_") as tmp:
            t0 = time.perf_counter()
            cfg, model, batch = _shard_train_setup(torch, self.dev)
            opt = adamw()
            state = init_train_state(model, opt)
            step = make_train_step(cfg, opt, _shard_lr(), device=self.dev)
            state, m = step(state, batch)
            want_loss = float(m["loss"])
            torch.save({f"{part}/{k}": p.cpu() for part, tree in (
                ("params", state["params"]), ("m", state["opt"]["m"]))
                for k, p in tree.items()}, Path(tmp) / "s2_state.pt")
            del state, step, model, m
            torch.cuda.empty_cache()
            row["s2_reference_s"] = time.perf_counter() - t0
            log(f"[shard S2] unsharded AdamW step on the card: loss "
                f"{want_loss!r}, {row['s2_reference_s']:.1f} s")
            t0 = time.perf_counter()
            want_s2a = _shard_adafactor_reference(torch, self.dev, tmp)
            row["s2a_reference_s"] = time.perf_counter() - t0
            row["wide_reference_s"] = {
                phase: _shard_wide_reference(torch, phase, self.dev, tmp)
                for phase in SHARD_WIDE}
            log(f"[shard S2A] unsharded Adafactor step on the card: loss "
                f"{want_s2a!r}, {row['s2a_reference_s']:.1f} s; S6-S8's "
                f"unsharded f32 runs {row['wide_reference_s']} s")
            t0 = time.perf_counter()
            ranks = run_ranks(_shard_rank, SHARD["ranks"], tmp,
                              backend="gloo", timeout=MESH["timeout"],
                              threads=_rank_threads(SHARD["ranks"]))
            row["group_s"] = time.perf_counter() - t0
        paths = {}
        for name in ("S1", "S2", "S3"):
            for rank, out in enumerate(ranks):
                got = out[name]
                log(f"[shard {name}] rank {rank}: {got['seconds']:.2f} s, "
                    f"collectives {got['account']}")
        s1 = [out["S1"] for out in ranks]
        for rank, got in enumerate(s1):
            check(got["counts"]["flash_attention"] == SHARD["prefill_layers"]
                  and got["flash"] == {"flash_attention_sm90":
                                       SHARD["prefill_layers"],
                                       "flash_attention": 0},
                  f"S1 rank {rank}: the sharded prefill launched "
                  f"{got['counts']} {got['flash']}, not one bf16 flash "
                  f"launch a layer")
            self.check_idle(got["counts"], "flash_attention",
                            f"S1 rank {rank}")
            check(got["finite"] and got["shape"] == got["want_shape"],
                  f"S1 rank {rank}: logits block {got['shape']} (want "
                  f"{got['want_shape']}), finite {got['finite']}")
            for what in ("hidden", "logits"):
                check(got[f"{what}_close"],
                      f"S1 rank {rank}: the f32 {what} differ from the "
                      f"unsharded model's by {got[f'{what}_err']} (max abs)")
        row["S1"] = {k: [g[k] for g in s1] for k in (
            "seconds", "hidden_err", "logits_err", "agree_s", "peak_bytes",
            "held_bytes")}
        # what D1's dry run of S1's cell is held against
        self.s1_rank0 = {k: s1[0][k] for k in ("account", "flash",
                                               "peak_bytes", "held_bytes")}
        log(f"[shard S1] llama3.2-3b {SHARD['prefill_layers']} layers bf16 "
            f"prefill {PREFILL[0]}x{PREFILL[1]} on {SHARD['mesh']}: each rank "
            f"{s1[0]['want_shape']} logits, {SHARD['prefill_layers']} bf16 "
            f"flash launches; f32 at {SHARD['agree_layers']} layers: hidden "
            f"within {max(row['S1']['hidden_err']):.3g}, logits within "
            f"{max(row['S1']['logits_err']):.3g} (max abs)")
        paths["S1"] = s1[0]["counts"]
        worst = {"params": 0.0, "m": 0.0, "zero_init": 0.0}
        for rank, out in enumerate(ranks):
            got = out["S2"]
            err = abs(got["loss"] - want_loss) / abs(want_loss)
            check(err <= SHARD["train_tol"],
                  f"S2 rank {rank}: loss {got['loss']!r} vs {want_loss!r}")
            for key, e in got["rel"].items():
                part, k = key.split("/", 1)
                if part == "params" and k in got["zero_init"]:
                    part = "zero_init"   # held through "m" (SHARD)
                else:
                    check(e <= SHARD["train_tol"],
                          f"S2 rank {rank}: {key} differs by {e} of its "
                          f"largest element")
                worst[part] = max(worst[part], e)
            self.check_idle(got["counts"], None, f"S2 rank {rank}")
            check(not any(got["flash"].values()),
                  f"S2 rank {rank} launched {got['flash']}")
            check(out["S3"]["bitwise"] and out["S3"]["step"] == 1,
                  f"S3 rank {rank}: the restore on {SHARD['restore_mesh']} "
                  f"differs: {out['S3']}")
        row["S2"] = dict(loss=[o["S2"]["loss"] for o in ranks],
                         want_loss=want_loss, worst_rel=worst,
                         seconds=[o["S2"]["seconds"] for o in ranks],
                         peak_bytes=[o["S2"]["peak_bytes"] for o in ranks],
                         held_bytes=[o["S2"]["held_bytes"] for o in ranks])
        # what D1(c)'s dry run of S2's cell is held against
        self.s2_rank0 = {k: ranks[0]["S2"][k] for k in (
            "account", "flash", "peak_bytes", "held_bytes")}
        row["S3"] = {k: [o["S3"][k] for o in ranks] for k in (
            "seconds", "save_s", "restore_s", "check_s")}
        row["S3"]["leaves"] = ranks[0]["S3"]["leaves"]
        log(f"[shard S2] AdamW step {SHARD['train'][0]}x{SHARD['train'][1]} "
            f"on {SHARD['mesh']}: losses {row['S2']['loss']} vs "
            f"{want_loss!r}; of each leaf's largest element, the first "
            f"moments within {worst['m']:.3g}, the parameters within "
            f"{worst['params']:.3g}, the zero-initialised norm scales "
            f"within {worst['zero_init']:.3g}; no kernel launch; rank 0's "
            f"peak {row['S2']['peak_bytes'][0] / 2**30:.3f} GiB "
            f"(max_memory_allocated), "
            f"{row['S2']['held_bytes'][0] / 2**30:.3f} GiB held before")
        log(f"[shard S3] state saved from {SHARD['mesh']} and restored on "
            f"{SHARD['restore_mesh']}: {row['S3']['leaves']} leaves bitwise; "
            f"save {max(row['S3']['save_s']):.1f} s, restore "
            f"{max(row['S3']['restore_s']):.1f} s, the check's gathers "
            f"{max(row['S3']['check_s']):.1f} s")
        paths["S2"] = ranks[0]["S2"]["counts"]
        row["S2A"] = self._check_adafactor([out["S2A"] for out in ranks],
                                           want_s2a)
        paths["S2A"] = ranks[0]["S2A"]["counts"]
        for phase in SHARD_WIDE:
            row[phase] = self._check_shard_wide(phase, [out[phase]
                                                        for out in ranks])
            paths[phase] = ranks[0][phase]["counts"]
        for phase in SHARD_KINDS:
            paths[phase] = self._check_shard_kind(
                phase, [out[phase] for out in ranks])
            row[phase] = {k: [out[phase][k] for out in ranks]
                          for k in ("seconds", "err", "agree_s",
                                    "agree_split", "cache_shapes")}
        row["account_rank0"] = {n: ranks[0][n]["account"] for n in (
            "S1", "S2", "S3", "S2A", *SHARD_KINDS, *SHARD_WIDE)}
        row["account_rank0"].update({f"{n} f32": ranks[0][n]["agree_account"]
                                     for n in (*SHARD_KINDS, *SHARD_WIDE)})
        for name, acc in row["account_rank0"].items():
            log(f"[shard {name}] rank 0's reduce-scatters / all-gathers "
                f"(calls, bytes in, result bytes): "
                f"{_calls(acc, 'reduce_scatter')} / "
                f"{_calls(acc, 'all_gather')}")
        row["total_s"] = time.perf_counter() - t_all
        log(f"[shard] S1-S8 took {row['total_s']:.1f} s: the unsharded "
            f"steps {row['s2_reference_s']:.1f} + "
            f"{row['s2a_reference_s']:.1f} s, S6-S8's unsharded f32 runs "
            f"{sum(row['wide_reference_s'].values()):.1f} s, the 4-rank "
            f"group {row['group_s']:.1f} s")
        self.report["shard"] = row
        return paths

    def dryrun(self) -> dict:
        """D1 (DRYRUN): (a) S1's cell traced by the dry run against what
        S1's rank 0 measured, (b) full-size cells on the 16 x 16 mesh,
        (c) S2's cell against S2's rank 0, (d) the dry run's device
        memory against the card's.  Every trace runs in the dry run's own
        process."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun as D

        row = {}
        t_all = time.perf_counter()
        sizes = dict(zip(("data", "model"), SHARD["mesh"]))
        cfg = dataclasses.replace(get_config("llama3.2-3b"),
                                  num_layers=SHARD["prefill_layers"])
        B, S = PREFILL
        row["s1"] = self._hold_trace("D1(a)", "S1", self.s1_rank0, cfg,
                                     (S, B, "prefill"), sizes)
        out_dir = str(ROOT / "chiprun_out" / "dryrun_torch")
        row["cells"] = {}
        for shape in DRYRUN["cells"]:
            rec = D.run_cell(DRYRUN["arch"], shape, False, out_dir=out_dir)
            check(rec["status"] == "ok",
                  f"D1(b): {DRYRUN['arch']} x {shape} on pod16x16 ended "
                  f"{rec['status']}: {rec.get('error')}\n"
                  f"{rec.get('traceback')}")
            r, mem = rec["roofline"], rec["memory"]
            row["cells"][shape] = dict(
                peak_gib=mem["peak_bytes"] / 2**30, fits=mem["fits"],
                dominant=r["dominant"], trace_seconds=rec["trace_seconds"],
                compute_s=r["compute_s"], memory_s=r["memory_s"],
                collective_s=r["collective_s"], kernels=rec["kernels"],
                collectives_by_kind=r["collectives_by_kind"])
            log(f"[dryrun D1] {DRYRUN['arch']} x {shape} on pod16x16: "
                f"{mem['peak_bytes'] / 2**30:.2f} GiB a device, fits "
                f"{mem['fits']}, dominant {r['dominant']} (compute "
                f"{r['compute_s'] * 1e3:.1f} ms, memory "
                f"{r['memory_s'] * 1e3:.1f} ms, collective "
                f"{r['collective_s'] * 1e3:.2f} ms), traced in "
                f"{rec['trace_seconds']:.1f} s; fake launches "
                f"{ {k: v['launches'] for k, v in rec['kernels'].items()} }")
            limit = DRYRUN["max_gib"].get(shape)
            check(limit is None or mem["peak_bytes"] <= limit * 2**30,
                  f"D1(b): {DRYRUN['arch']} x {shape} predicts "
                  f"{mem['peak_bytes'] / 2**30:.2f} GiB a device, above "
                  f"{limit} GiB")
        cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype="float32",
                                  num_layers=SHARD["train_layers"])
        B, S = SHARD["train"]
        row["s2"] = self._hold_trace("D1(c)", "S2", self.s2_rank0, cfg,
                                     (S, B, "train"), sizes)
        D.close()
        total = torch.cuda.get_device_properties(0).total_memory
        check(D.DEVICE_BYTES == total,
              f"D1(d): the dry run's DEVICE_BYTES {D.DEVICE_BYTES} is not "
              f"the card's {total}")
        row["device_bytes"] = total
        row["total_s"] = time.perf_counter() - t_all
        log(f"[dryrun D1] DEVICE_BYTES = the card's {total} B; D1 took "
            f"{row['total_s']:.1f} s")
        self.report["dryrun"] = row
        return row

    def _hold_trace(self, label: str, phase: str, real: dict, cfg, shape,
                    sizes: dict) -> dict:
        """The dry run's trace of a sharded phase's cell (`cfg` at
        `shape`, an (S, B, mode) tuple, on a fake group of `sizes`)
        against what the phase's rank 0 measured (`real`): the fake
        launches a rank, the account without host copies call for call
        and byte for byte, the predicted peak within DRYRUN["peak_tol"]
        of `max_memory_allocated`."""
        from repro_torch.launch import dryrun as D

        t0 = time.perf_counter()
        tr = D.trace_cell(cfg, shape, sizes, device="cuda")
        seconds = time.perf_counter() - t0
        launches = {k: v["launches"] for k, v in tr["kernels"].items()}
        measured = {k: n for k, n in real["flash"].items() if n}
        check(launches == measured,
              f"{label}: the dry run predicts {launches} launches a rank, "
              f"{phase}'s rank 0 made {measured}")
        want = {k: v for k, v in real["account"].items() if k != "host_copy"}
        check(tr["account"] == want,
              f"{label}: the traced account {tr['account']} differs from "
              f"{phase}'s rank 0's {want}")
        peak, got = tr["memory"]["peak_bytes"], real["peak_bytes"]
        check(abs(peak / got - 1.0) <= DRYRUN["peak_tol"],
              f"{label}: predicted peak {peak} B against {phase}'s measured "
              f"{got} B, beyond {DRYRUN['peak_tol']:.0%}")
        log(f"[dryrun {label}] {phase}'s cell traced in {seconds:.1f} s: "
            f"peak {peak / 2**30:.3f} GiB predicted, {got / 2**30:.3f} GiB "
            f"measured in {phase}'s rank 0 ({peak / got - 1:+.1%}); "
            f"arguments {tr['memory']['argument_bytes'] / 2**30:.3f} GiB "
            f"predicted, {real['held_bytes'] / 2**30:.3f} GiB held; "
            f"{launches} launches and the account equal {phase}'s: "
            f"{tr['account']}")
        return dict(trace_s=seconds, predicted_peak_bytes=peak,
                    measured_peak_bytes=got,
                    argument_bytes=tr["memory"]["argument_bytes"],
                    held_bytes=real["held_bytes"], launches=launches,
                    account=tr["account"], flops=tr["flops"],
                    bytes=tr["bytes"])

    def examples(self) -> dict:
        """E1 (EXAMPLE_RUNS): the example scripts in-process on the card,
        each run's kernel launches counted on their own.  Returns
        {run label: counts}."""
        import importlib.util

        def load(name):
            spec = importlib.util.spec_from_file_location(
                f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod

        def finite(x) -> bool:
            if isinstance(x, dict):
                return all(finite(v) for v in x.values())
            if isinstance(x, (list, tuple)):
                return all(finite(v) for v in x)
            if isinstance(x, float):
                return math.isfinite(x)
            if hasattr(x, "__dataclass_fields__"):
                return finite(dataclasses.asdict(x))
            return True

        row, paths = {}, {}
        t_all = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_e1_") as tmp:
            for name, argv in EXAMPLE_RUNS:
                label = " ".join([f"examples/torch_{name}.py", *argv])
                if name == "train_lm":
                    argv = [*argv, "--ckpt-dir", tmp]
                self.zero_counts()
                t0 = time.perf_counter()
                out = load(name).main(argv)
                self.torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                paths[label] = self.read_counts()
                check(finite(out), f"E1 {label}: a figure is not finite")
                row[label] = dict(seconds=secs, launches=paths[label])
                if name == "quickstart":
                    check(out["messages"] < out["pa_messages"],
                          f"E1 {label}: multiscale's {out['messages']} "
                          f"messages not below path averaging's "
                          f"{out['pa_messages']}")
                    row[label].update(messages=out["messages"],
                                      pa_messages=out["pa_messages"],
                                      error=out["error"])
                if name == "train_lm":
                    row[label]["start_step"] = out["start_step"]
                    row[label]["last_step"] = out["history"][-1]["step"]
                log(f"[examples E1] {label}: {secs:.1f} s, launches "
                    f"{ {k: n for k, n in paths[label].items() if n} }")
        runs = [row[k] for k in row if "torch_train_lm.py" in k]
        check(runs[1]["start_step"] == runs[0]["last_step"] > 0,
              f"E1: train_lm's second run started at step "
              f"{runs[1]['start_step']}, not at the first's saved step "
              f"{runs[0]['last_step']}")
        total = time.perf_counter() - t_all
        log(f"[examples E1] six scripts, {len(EXAMPLE_RUNS)} runs in "
            f"{total:.1f} s (host clock, not gated)")
        self.report["examples"] = dict(runs=row, total_s=total)
        return paths

    def _check_adafactor(self, got: list, want_loss: float) -> dict:
        """S2A's gates over every rank's result (SHARD_WIDE's comment)."""
        worst = {"matrix": 0.0, "one_d": 0.0}
        for rank, g in enumerate(got):
            err = abs(g["loss"] - want_loss) / abs(want_loss)
            check(err <= SHARD["train_tol"],
                  f"S2A rank {rank}: loss {g['loss']!r} vs {want_loss!r}")
            for key, e in g["rel"].items():
                if key.split("/", 1)[1] in g["one_d"]:
                    worst["one_d"] = max(worst["one_d"], e)  # reported
                    continue
                check(e <= SHARD["train_tol"],
                      f"S2A rank {rank}: {key} differs by {e} of its "
                      f"largest element")
                worst["matrix"] = max(worst["matrix"], e)
            self.check_idle(g["counts"], None, f"S2A rank {rank}")
            check(not any(g["flash"].values()),
                  f"S2A rank {rank} launched {g['flash']}")
        log(f"[shard S2A] Adafactor step {SHARD['train'][0]}x"
            f"{SHARD['train'][1]} on {SHARD['mesh']}: losses "
            f"{[g['loss'] for g in got]} vs {want_loss!r}; every vr, vc and "
            f"matrix parameter block within {worst['matrix']:.3g} of its "
            f"leaf's largest element; the 1-D leaves (reported only) within "
            f"{worst['one_d']:.3g}; {got[0]['seconds']:.2f} s a rank, "
            f"collectives {got[0]['account']}; no kernel launch")
        return dict(loss=[g["loss"] for g in got], want_loss=want_loss,
                    worst_rel=worst, seconds=[g["seconds"] for g in got])

    def _check_shard_wide(self, phase: str, got: list) -> dict:
        """S6-S8's gates over every rank's result (SHARD_WIDE)."""
        spec = SHARD_WIDE[phase]
        for rank, g in enumerate(got):
            check(g["counts"]["flash_attention"] == spec["flash"]
                  and g["flash"] == {"flash_attention_sm90": spec["flash"],
                                     "flash_attention": 0},
                  f"{phase} rank {rank}: the sharded prefill launched "
                  f"{g['counts']} {g['flash']}, not {spec['flash']} bf16 "
                  f"flash launches")
            self.check_idle(g["counts"], "flash_attention",
                            f"{phase} rank {rank}")
            check(g["finite"] and g["shape"] == g["want_shape"]
                  and g["dtype"] == "torch.float32",
                  f"{phase} rank {rank}: logits block {g['shape']} "
                  f"{g['dtype']} (want {g['want_shape']} f32), finite "
                  f"{g['finite']}")
            for what, ok in g["close"].items():
                check(ok, f"{phase} rank {rank}: the f32 {what} differ from "
                          f"the unsharded model's by {g['err'][what]} (max "
                          f"abs)")
            log(f"[shard {phase}] rank {rank}: {g['seconds']:.2f} s, f32 "
                f"copy {g['agree_s']:.2f} s, expert buffers {g['buffers']} "
                f"(global {g['global_rows']} rows), collectives "
                f"{g['account']}, the f32 copy's {g['agree_account']}")
        worst = {k: max(g["err"][k] for g in got) for k in got[0]["err"]}
        log(f"[shard {phase}] {spec['arch']} "
            f"{spec['layers'] or 'all'} layers bf16 prefill "
            f"{spec['prefill'][0]}x{spec['prefill'][1]} on {spec['mesh']}: "
            f"each rank {got[0]['want_shape']} logits, {spec['flash']} bf16 "
            f"flash launches; f32 at {spec['agree']} "
            f"{spec['agree_changes'] or ''}: hidden within "
            f"{worst['hidden']:.3g}, logits within {worst['logits']:.3g}, "
            f"{SHARD['decode_steps']} decode steps within "
            f"{worst['decode']:.3g} (max abs)")
        return {"seconds": [g["seconds"] for g in got],
                "agree_s": [g["agree_s"] for g in got], "err": worst,
                "buffers": [g["buffers"] for g in got],
                "global_rows": got[0]["global_rows"],
                "cache_memory": got[0]["cache_memory"],
                "all_gather_bytes": [g["account"].get("all_gather", {}).get(
                    "bytes", 0) for g in got]}

    def _check_shard_kind(self, phase: str, got: list) -> dict:
        """S4 / S5's gates over every rank's result; rank 0's launches."""
        arch, layers, agree, runs = SHARD_KINDS[phase]
        flash = runs.get("flash_attention", 0)
        for rank, g in enumerate(got):
            check(all(g["counts"][k] == n for k, n in runs.items())
                  and g["flash"] == {"flash_attention_sm90": flash,
                                     "flash_attention": 0},
                  f"{phase} rank {rank}: the sharded prefill launched "
                  f"{g['counts']} {g['flash']}, not {runs} (bf16)")
            self.check_idle(g["counts"], tuple(runs), f"{phase} rank {rank}")
            check(g["finite"] and g["shape"] == g["want_shape"],
                  f"{phase} rank {rank}: logits block {g['shape']} (want "
                  f"{g['want_shape']}), finite {g['finite']}")
            for what, ok in g["close"].items():
                check(ok, f"{phase} rank {rank}: the f32 {what} differ from "
                          f"the unsharded model's by {g['err'][what]} (max "
                          f"abs)")
            log(f"[shard {phase}] rank {rank}: {g['seconds']:.2f} s, f32 "
                f"copy {g['agree_s']:.2f} s ({g['agree_split']}), "
                f"collectives {g['account']}, the f32 copy's sharded runs' "
                f"{g['agree_account']}")
        worst = {k: max(g["err"][k] for g in got) for k in got[0]["err"]}
        log(f"[shard {phase}] {arch} {layers} layers bf16 prefill "
            f"{PREFILL[0]}x{PREFILL[1]} on {SHARD['mesh']}: each rank "
            f"{got[0]['want_shape']} logits, {runs} launches; f32 at {agree} "
            f"layers: hidden within {worst['hidden']:.3g}, logits within "
            f"{worst['logits']:.3g}, {SHARD['decode_steps']} decode steps "
            f"within {worst['decode']:.3g} (max abs); rank 0's cache blocks "
            f"{got[0]['cache_shapes']}")
        return got[0]["counts"]


def _calls(account: dict, kind: str) -> tuple:
    """(calls, bytes in, result bytes) of one kind of a collective
    account (zeros where it made none)."""
    e = account.get(kind, {})
    return tuple(e.get(k, 0) for k in ("calls", "bytes", "result_bytes"))


def _rank_threads(ranks: int) -> int:
    """CPU threads a rank: the host's cores shared out (more threads
    than cores make torch's CPU ops spin against each other)."""
    import os

    return max(1, (os.cpu_count() or 1) // ranks)


def _mesh_fields(res) -> dict:
    return {k: getattr(res, k) for k in (
        "x_final", "messages", "node_sends", "level_messages", "level_ticks",
        "level_converged")}


def _mesh_rank(rank, world, plan, x0, ref_dir):
    """M1, M2 and M4 in one rank of the 4-rank group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    import repro_torch.core as P
    from repro_torch.dist import collectives as C

    torch.cuda.set_device(0)
    smoke = Smoke(torch)
    ranks = torch.arange(world)
    meshes = {
        "M1": (DeviceMesh("cuda", ranks, mesh_dim_names=("trials",)),
               MESH["trials"]),
        "M2": (DeviceMesh("cuda", ranks.reshape(2, 2),
                          mesh_dim_names=("trials", "nodes")),
               MESH["node_trials"]),
    }
    fi = {k: v for k, v in FI.items() if k != "seed"}
    out = {}
    for name, (mesh, T) in meshes.items():
        smoke.zero_counts()
        C.reset_account()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = P.execute_plan(plan, x0, seeds=tuple(range(T)),
                             options=P.ExecOptions(backend="cuda", mesh=mesh),
                             **fi)
        torch.cuda.synchronize()
        out[name] = dict(result=_mesh_fields(res), counts=smoke.read_counts(),
                         flash=dict(smoke.flash_kernels()),
                         account=C.account(),
                         seconds=time.perf_counter() - t0)
    out["M4"] = _mesh_train(torch, smoke, rank, world, ref_dir)
    return out


def _mesh_train_modes() -> dict:
    from repro_torch.dist import SyncConfig

    return {"allreduce": SyncConfig("allreduce"),
            "hierarchical_overlap": SyncConfig(
                "hierarchical", levels=(2, 2), overlap="one_step")}


def _mesh_train_setup(torch, dev):
    """T2's model (llama3.2-3b width, 1 layer, bf16) drawn on the card
    from MODEL_SEED, and a stream of one row of T2's length a replica."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Transformer, param_dict

    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=DEC["layers"])
    base = param_dict(Transformer(cfg).init(seed=MODEL_SEED, device=dev))
    data = SyntheticLM(cfg.vocab_size, DEC["seq"], MESH_TRAIN["R"],
                       seed=MODEL_SEED)
    return cfg, base, data


def _mesh_batch(data, s: int, R: int) -> dict:
    return {k: v.reshape(R, -1, *v.shape[1:])
            for k, v in data.batch_at(s).items()}


def _mesh_train(torch, smoke, rank, world, ref_dir) -> dict:
    """M4 in one rank: its replica's rows, 2 steps in each mode, against
    the dense run's final rows of this replica."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data import shard_batch
    from repro_torch.dist import collectives as C
    from repro_torch.optim import cosine_schedule, sgdm
    from repro_torch.train import (
        init_decentralized_state, make_decentralized_step,
    )

    dev = torch.device("cuda", 0)
    R = MESH_TRAIN["R"]
    cfg, base, data = _mesh_train_setup(torch, dev)
    mesh = DeviceMesh("cuda", torch.arange(world),
                      mesh_dim_names=("replica",))
    opt, lr = sgdm(), cosine_schedule(*TRAIN_LR)
    out = {}
    for mode, sync in _mesh_train_modes().items():
        smoke.zero_counts()
        C.reset_account()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the R rows as a view: the state copies only this rank's
        rows = {k: p.unsqueeze(0).expand((R,) + p.shape)
                for k, p in base.items()}
        state = init_decentralized_state(rows, opt, sync=sync, mesh=mesh)
        step = make_decentralized_step(cfg, opt, lr, sync, R, mesh=mesh,
                                       device=dev)
        losses = []
        for s in range(MESH_TRAIN["steps"]):
            batch = shard_batch(_mesh_batch(data, s, R), mesh, ("replica",))
            state, m = step(state, batch)
            losses.append(float(m["replica_loss"]))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = torch.load(Path(ref_dir) / f"{mode}_{rank}.pt",
                         map_location=dev)
        rel = {}
        for k, p in state["params"].items():
            want = ref[k].float()
            rel[k] = float((p[0].float() - want).norm()
                           / want.norm().clamp_min(1e-30))
        out[mode] = dict(losses=losses, rel=rel, seconds=dt,
                         fingerprint=fingerprint(torch, state["params"]),
                         counts=smoke.read_counts(),
                         flash=dict(smoke.flash_kernels()),
                         account=C.account())
        del state, step, ref, rows
        torch.cuda.empty_cache()
    return out


def _mesh_sync_cases() -> dict:
    """M3's cases: name -> (config, bitwise to the dense executor)."""
    from repro_torch.dist import (
        CompressionConfig, SyncConfig, SyncFailureModel,
    )

    faults = SyncFailureModel(churn_fraction=0.25, byzantine_fraction=0.125,
                              seed=11)
    ms = dict(levels=(2, 4))
    return {
        "allreduce": (SyncConfig("allreduce"), False),
        "hierarchical": (SyncConfig("hierarchical", **ms), False),
        "ring": (SyncConfig("ring"), True),
        "multiscale": (SyncConfig("multiscale", **ms), True),
        "multiscale_exact": (SyncConfig("multiscale", exact_fusion=True,
                                        **ms), False),
        "multiscale_rotated": (SyncConfig("multiscale", rotation_period=3,
                                          rotation_seed=5, **ms), True),
        "multiscale_topk": (SyncConfig(
            "multiscale", compression=CompressionConfig("topk", 0.25), **ms),
            False),
        "allreduce_trimmed": (SyncConfig(
            "allreduce", aggregation="trimmed_mean", failures=faults), True),
    }


def _mesh_sync_rows(torch, dev, R: int) -> list:
    """Row r of M3, (1, 3072, 3072) f32, drawn on the card from
    MESH_SEED + r."""
    return [torch.randn((1, *MESH_SYNC_SHAPE), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            MESH_SEED + r)) for r in range(R)]


def _mesh_compare(torch, got, want, label: str) -> dict:
    diff = (got - want).abs()
    over = diff > MESH_SYNC_TOL + MESH_SYNC_TOL * want.abs()
    return {f"{label}_bitwise": torch.equal(got.view(torch.int32),
                                            want.view(torch.int32)),
            f"{label}_max_abs_err": float(diff.max()),
            f"{label}_over_tol": int(over.sum())}


def _mesh_sync_rank(rank, world) -> dict:
    """M3 in one rank: its row through execute_sync_sharded, against its
    row of the dense execute_sync over all 8 rows, drawn here too."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import (
        build_sync_plan, execute_sync, execute_sync_sharded, init_residual,
        replica_fault_masks,
    )
    from repro_torch.dist import collectives as C

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = DeviceMesh("cuda", torch.arange(world),
                      mesh_dim_names=("replica",))
    rows = _mesh_sync_rows(torch, dev, world)
    full = {"wq": torch.cat(rows)}
    mine = {"wq": rows[rank]}
    out = {}
    for name, (sync, _) in _mesh_sync_cases().items():
        plan = build_sync_plan(sync, world)
        compressed = plan.compression.scheme != "none"
        for step in (0, 2):
            dense, dres = execute_sync(
                plan, full, init_residual(full) if compressed else None, step)
            want = dense["wq"][rank:rank + 1]
            C.reset_account()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, gres = execute_sync_sharded(
                plan, mine, init_residual(mine) if compressed else None, step,
                mesh=mesh)
            torch.cuda.synchronize()
            row = dict(seconds=time.perf_counter() - t0, account=C.account(),
                       dense_fingerprint=fingerprint(torch, {"wq": want}),
                       dropped_zero=None)
            row.update(_mesh_compare(torch, got["wq"], want, "mixed"))
            if compressed:
                row.update(_mesh_compare(torch, gres["wq"],
                                         dres["wq"][rank:rank + 1],
                                         "residual"))
            if plan.faulty and bool(replica_fault_masks(
                    plan.failures, world, step, dev).dropped[rank]):
                row["dropped_zero"] = bool((got["wq"] == 0).all())
            out[name, step] = row
            del dense, dres, got, gres
    return out


def _shard_lr():
    from repro_torch.optim import cosine_schedule

    return cosine_schedule(SHARD["lr"], 0, 10)


def _shard_train_setup(torch, dev):
    """S2's model (llama3.2-3b width, SHARD["train_layers"] layers, f32)
    drawn on the card from MODEL_SEED, and its SyntheticLM batch."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import Transformer

    cfg = dataclasses.replace(get_config("llama3.2-3b"), dtype="float32",
                              num_layers=SHARD["train_layers"])
    B, S = SHARD["train"]
    batch = SyntheticLM(cfg.vocab_size, S, B, seed=MODEL_SEED).batch_at(0)
    return cfg, Transformer(cfg).init(seed=MODEL_SEED, device=dev), batch


def _shard_prefill(torch, smoke, mesh) -> dict:
    """S1 in one rank."""
    import numpy as np

    from repro_torch._tf32 import no_tf32
    from repro_torch.configs import get_config
    from repro_torch.data import shard_batch
    from repro_torch.dist import collectives as C
    from repro_torch.launch import batch_axes, set_mesh
    from repro_torch.models import Transformer, forward
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import _hidden, _tree, param_specs

    dev = torch.device("cuda", 0)
    dp = batch_axes(mesh)
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=SHARD["prefill_layers"])
    B, S = PREFILL
    tokens = np.random.default_rng(MODEL_SEED).integers(
        0, cfg.vocab_size, (B, S))
    rows = shard_batch({"tokens": tokens}, mesh, dp)
    local = SH.shard_params(Transformer(cfg).init(seed=MODEL_SEED,
                                                  device=dev),
                            mesh, param_specs(cfg, mesh))
    torch.cuda.empty_cache()
    smoke.zero_counts()
    C.reset_account()
    torch.cuda.synchronize()
    # the peak from here holds the rank's blocks, as the dry run's does
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with set_mesh(mesh):
        logits = forward(local, cfg, rows, dp=dp)
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, counts=smoke.read_counts(),
               peak_bytes=torch.cuda.max_memory_allocated(),
               held_bytes=held,
               flash=dict(smoke.flash_kernels()), account=C.account(),
               shape=tuple(logits.shape),
               want_shape=(B // 2, S, cfg.vocab_size // 2),
               finite=bool(torch.isfinite(logits).all()))
    del logits, local
    torch.cuda.empty_cache()
    # the f32 copy: this rank's blocks against the unsharded model on its
    # rows, on the card
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=SHARD["agree_layers"])
    full = Transformer(cfg32).init(seed=MODEL_SEED, device=dev)
    local = SH.shard_params(full, mesh, param_specs(cfg32, mesh))
    tol = SHARD["prefill_tol"]
    with set_mesh(mesh), no_tf32(), torch.no_grad():
        got = _hidden(_tree(local), cfg32, rows, lay=SH.layout(cfg32, dp))
    with no_tf32(), torch.no_grad():
        want = _hidden(full, cfg32, rows)
    out["hidden_err"] = float((got - want).abs().max())
    out["hidden_close"] = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    del got, want
    with set_mesh(mesh):
        got = forward(local, cfg32, rows, dp=dp)
    want = SH.local_block(forward(full, cfg32, rows), mesh,
                          (None, None, "model"))
    out["logits_err"] = float((got - want).abs().max())
    out["logits_close"] = bool(torch.allclose(got, want, rtol=tol, atol=tol))
    del got, want, full, local
    torch.cuda.empty_cache()
    out["agree_s"] = time.perf_counter() - t0
    return out


def _shard_train(torch, smoke, mesh, tmp) -> dict:
    """S2 and S3 in one rank."""
    from repro_torch.data import shard_batch
    from repro_torch.dist import collectives as C
    from repro_torch.launch import batch_axes, make_host_mesh, set_mesh
    from repro_torch.launch.specs import state_shardings
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import flat_tree, model_params, param_specs
    from repro_torch.optim import adamw
    from repro_torch.train import (
        init_train_state, make_train_step, restore_checkpoint,
        save_checkpoint,
    )

    dev = torch.device("cuda", 0)
    dp = batch_axes(mesh)
    cfg, model, batch = _shard_train_setup(torch, dev)
    p_abs, specs = model.abstract(), model.specs()
    local = SH.shard_params(model, mesh, param_specs(cfg, mesh))
    del model
    torch.cuda.empty_cache()
    opt = adamw()
    state = init_train_state(local, opt)
    step = make_train_step(cfg, opt, _shard_lr(), device=dev, dp=dp)
    rows = shard_batch(batch, mesh, dp)
    smoke.zero_counts()
    C.reset_account()
    torch.cuda.synchronize()
    # the peak from here holds the rank's state, as the dry run's does
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with set_mesh(mesh):
        state, m = step(state, rows)
    torch.cuda.synchronize()
    s2 = dict(seconds=time.perf_counter() - t0, loss=float(m["loss"]),
              counts=smoke.read_counts(), flash=dict(smoke.flash_kernels()),
              account=C.account(),
              peak_bytes=torch.cuda.max_memory_allocated(), held_bytes=held)
    want = torch.load(Path(tmp) / "s2_state.pt", mmap=True)
    ps = param_specs(cfg, mesh)
    rel = {}
    for part, tree in (("params", state["params"]), ("m", state["opt"]["m"])):
        for k, p in tree.items():
            w = SH.local_block(want[f"{part}/{k}"], mesh, ps[k]).to(dev)
            rel[f"{part}/{k}"] = float((p - w).abs().max()
                                       / w.abs().max().clamp_min(1e-30))
    s2["rel"] = rel
    s2["zero_init"] = sorted(k for k, d in flat_tree(model_params(cfg))
                             if d.init == "zeros")
    del want
    # S3: save with this mesh's shardings, restore onto the 4 x 1 mesh
    C.reset_account()
    t0 = time.perf_counter()
    opt_abs = opt.init(p_abs)
    ckpt = str(Path(tmp) / "s3")
    save_checkpoint(ckpt, state, 1, shardings=state_shardings(
        mesh, p_abs, specs, opt_abs), mesh=mesh)
    t_save = time.perf_counter()
    new = make_host_mesh(*SHARD["restore_mesh"], device_type="cuda")
    new_sh = state_shardings(new, p_abs, specs, opt_abs)
    like = {"params": {}, "opt": {"m": {}, "v": {}, "count": torch.zeros(
        (), dtype=torch.int32, device=dev)}, "step": 0}
    for k, a in p_abs.items():
        for tree, spec in ((like["params"], new_sh["params"][k]),
                           (like["opt"]["m"], new_sh["opt"]["m"][k]),
                           (like["opt"]["v"], new_sh["opt"]["v"][k])):
            shape = SH.local_block(a, new, spec).shape
            tree[k] = torch.zeros(shape, dtype=(a.dtype if tree is
                                                like["params"]
                                                else torch.float32),
                                  device=dev)
    got, step_no = restore_checkpoint(ckpt, like, shardings=new_sh, mesh=new)
    torch.cuda.synchronize()
    t_restore = time.perf_counter()
    old_sh = state_shardings(mesh, p_abs, specs, opt_abs)
    same, leaves = got["step"] == state["step"], 0
    for part, path in (("params", ("params",)), ("m", ("opt", "m")),
                       ("v", ("opt", "v"))):
        src, dst = state, got
        sh_old, sh_new = old_sh, new_sh
        for key in path:
            src, dst = src[key], dst[key]
            sh_old, sh_new = sh_old[key], sh_new[key]
        for k in src:
            whole = SH.gather_act(src[k], mesh, sh_old[k])
            same &= torch.equal(SH.local_block(whole, new, sh_new[k]),
                                dst[k])
            leaves += 1
            del whole
    same &= torch.equal(got["opt"]["count"], state["opt"]["count"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s3 = dict(seconds=t1 - t0, save_s=t_save - t0,
              restore_s=t_restore - t_save, check_s=t1 - t_restore,
              bitwise=bool(same), step=step_no, leaves=leaves,
              account=C.account())
    return s2, s3


def _shard_kind(torch, smoke, mesh, phase: str) -> dict:
    """S4 or S5 (SHARD_KINDS) in one rank."""
    import numpy as np

    from repro_torch._tf32 import no_tf32
    from repro_torch.configs import get_config
    from repro_torch.data import shard_batch
    from repro_torch.dist import collectives as C
    from repro_torch.launch import batch_axes, set_mesh
    from repro_torch.models import (
        Transformer, decode_step, forward, init_cache,
    )
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import (
        _head, _hidden, _tree, _unembed, param_specs,
    )

    arch, layers, agree_layers, _ = SHARD_KINDS[phase]
    dev = torch.device("cuda", 0)
    dp = batch_axes(mesh)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    B, S = PREFILL
    rng = np.random.default_rng(MODEL_SEED)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    steps = rng.integers(0, cfg.vocab_size, (SHARD["decode_steps"], B))
    rows = shard_batch({"tokens": tokens, "steps": steps.T}, mesh, dp)
    local = SH.shard_params(Transformer(cfg).init(seed=MODEL_SEED,
                                                  device=dev),
                            mesh, param_specs(cfg, mesh))
    torch.cuda.empty_cache()
    smoke.zero_counts()
    C.reset_account()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with set_mesh(mesh):
        logits = forward(local, cfg, {"tokens": rows["tokens"]}, dp=dp)
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, counts=smoke.read_counts(),
               flash=dict(smoke.flash_kernels()), account=C.account(),
               shape=tuple(logits.shape),
               want_shape=(B // 2, S, cfg.vocab_size // 2),
               finite=bool(torch.isfinite(logits).all()))
    del logits, local
    torch.cuda.empty_cache()
    # the f32 copy: the unsharded model on this rank's rows first, then
    # the rank's blocks; the logits blocks compared a chunk of positions
    # at a time (a rank's whole block is 3.9 GB at recurrentgemma-9b's
    # vocabulary, and four ranks share the card)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=agree_layers)
    full = Transformer(cfg32).init(seed=MODEL_SEED, device=dev)
    local = SH.shard_params(full, mesh, param_specs(cfg32, mesh))
    batch = {"tokens": rows["tokens"]}
    # the unembedding's vocabulary block: the rank's columns of the logits
    name, spec = (("embed", ("model", None)) if cfg32.tie_embeddings
                  else ("unembed", (None, "model")))
    head = {name: SH.local_block(full[name].detach(), mesh, spec).clone()}
    with no_tf32(), torch.no_grad():
        want = {"hidden": _hidden(full, cfg32, batch)}
    cache = init_cache(full, cfg32, B // 2, SHARD["decode_steps"])
    want["decode"] = []
    for tok in rows["steps"].T:
        lg, cache = decode_step(full, cfg32, cache, tok)
        want["decode"].append(SH.local_block(lg, mesh, (None, "model")))
    del full, cache
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    split = {"unsharded": time.perf_counter() - t0}
    C.reset_account()
    tol = SHARD["prefill_tol"]
    with set_mesh(mesh), no_tf32(), torch.no_grad():
        lay = SH.layout(cfg32, dp)
        got = _hidden(_tree(local), cfg32, batch, lay=lay)
        w, _ = _head(_tree(local), cfg32, lay)
    err = {"hidden": float((got - want["hidden"]).abs().max())}
    close = {"hidden": bool(torch.allclose(got, want["hidden"], rtol=tol,
                                           atol=tol))}
    err["logits"], close["logits"] = 0.0, True
    with no_tf32(), torch.no_grad():
        for t in range(0, S, SHARD["logits_chunk"]):
            part = slice(t, t + SHARD["logits_chunk"])
            a = _unembed(w, cfg32, got[:, part])      # `_logits` under lay
            b = _unembed(head, cfg32, want["hidden"][:, part])
            err["logits"] = max(err["logits"], float((a - b).abs().max()))
            close["logits"] &= bool(torch.allclose(a, b, rtol=tol, atol=tol))
            del a, b
    del got, w, head, want["hidden"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    split["prefill"] = time.perf_counter() - t0 - split["unsharded"]
    with set_mesh(mesh):
        cache = init_cache(local, cfg32, B // 2, SHARD["decode_steps"],
                           dp=dp)
        out["cache_shapes"] = [{k: tuple(a.shape) for k, a in layer.items()}
                               for layer in cache["layers"]]
        errs = []
        for tok, w in zip(rows["steps"].T, want["decode"]):
            lg, cache = decode_step(local, cfg32, cache, tok, dp=dp)
            errs.append(float((lg - w).abs().max()))
            close.setdefault("decode", True)
            close["decode"] &= bool(torch.allclose(lg, w, rtol=tol, atol=tol))
    err["decode"] = max(errs)
    del local, cache, want
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    agree_s = time.perf_counter() - t0
    split["decode"] = agree_s - split["unsharded"] - split["prefill"]
    out.update(err=err, close=close, agree_s=agree_s, agree_split=split,
               agree_account=C.account())
    return out


def _shard_adafactor_reference(torch, dev, tmp) -> float:
    """S2A's unsharded Adafactor step on the card, its state written to
    `tmp`; returns its loss."""
    from repro_torch.optim import adafactor
    from repro_torch.train import init_train_state, make_train_step

    cfg, model, batch = _shard_train_setup(torch, dev)
    opt = adafactor()
    state = init_train_state(model, opt)
    state, m = make_train_step(cfg, opt, _shard_lr(), device=dev)(state,
                                                                   batch)
    out = {f"params/{k}": p.cpu() for k, p in state["params"].items()}
    out.update({f"{part}/{k}": a.cpu() for k, v in state["opt"]["v"].items()
                for part, a in v.items()})
    torch.save(out, Path(tmp) / "s2a_state.pt")
    return float(m["loss"])


def _shard_adafactor(torch, smoke, mesh, tmp) -> dict:
    """S2A in one rank: the sharded Adafactor step, each block's error
    relative to its leaf's largest element."""
    from repro_torch.data import shard_batch
    from repro_torch.dist import collectives as C
    from repro_torch.launch import batch_axes, set_mesh
    from repro_torch.launch.specs import state_shardings
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import param_specs
    from repro_torch.optim import adafactor
    from repro_torch.train import init_train_state, make_train_step

    dev = torch.device("cuda", 0)
    dp = batch_axes(mesh)
    cfg, model, batch = _shard_train_setup(torch, dev)
    p_abs, specs = model.abstract(), model.specs()
    local = SH.shard_params(model, mesh, param_specs(cfg, mesh))
    del model
    torch.cuda.empty_cache()
    opt = adafactor()
    state = init_train_state(local, opt)
    step = make_train_step(cfg, opt, _shard_lr(), device=dev, dp=dp)
    smoke.zero_counts()
    C.reset_account()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with set_mesh(mesh):
        state, m = step(state, shard_batch(batch, mesh, dp))
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, loss=float(m["loss"]),
               counts=smoke.read_counts(), flash=dict(smoke.flash_kernels()),
               account=C.account())
    want = torch.load(Path(tmp) / "s2a_state.pt", mmap=True)
    sh = state_shardings(mesh, p_abs, specs, opt.init(p_abs))
    rel = {}
    trees = [("params", k, p, sh["params"][k])
             for k, p in state["params"].items()]
    trees += [(part, k, a, sh["opt"]["v"][k][part])
              for k, v in state["opt"]["v"].items() for part, a in v.items()]
    for part, k, got, spec in trees:
        w = SH.local_block(want[f"{part}/{k}"], mesh, spec).to(dev)
        rel[f"{part}/{k}"] = float((got - w).abs().max()
                                   / w.abs().max().clamp_min(1e-30))
    out["rel"] = rel
    out["one_d"] = sorted(k for k, a in p_abs.items() if a.dim() == 1)
    del want, state, local
    torch.cuda.empty_cache()
    return out


def _wide_cfg(phase: str, f32: bool = False):
    """S6-S8's config (SHARD_WIDE): bf16 at its depth, or its f32 copy."""
    from repro_torch.configs import get_config

    spec = SHARD_WIDE[phase]
    cfg = get_config(spec["arch"])
    if not f32:
        return (cfg if spec["layers"] is None else
                dataclasses.replace(cfg, num_layers=spec["layers"]))
    changes = dict(spec["agree_changes"], dtype="float32")
    if spec["agree_layers"] is not None:
        changes["num_layers"] = spec["agree_layers"]
    return dataclasses.replace(cfg, **changes)


def _wide_batch(cfg, phase: str, B: int, S: int, steps: int) -> dict:
    """Host tokens (B, S), `steps` decode tokens a row (B, steps) and,
    for whisper, frames (B, encoder_seq, D) in f32, from MODEL_SEED."""
    import numpy as np

    rng = np.random.default_rng([MODEL_SEED, int(phase[1:])])
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "steps": rng.integers(0, cfg.vocab_size, (B, steps))}
    if cfg.encoder_layers:
        out["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                   ).astype(np.float32)
    return out


def _leaves(cfg, sizes: dict):
    """(index, name, descriptor, sanitized spec) of every parameter."""
    from repro_torch.models.model import flat_tree, model_params
    from repro_torch.models.sharded import sanitize_spec

    for i, (name, d) in enumerate(flat_tree(model_params(cfg))):
        yield i, name, d, sanitize_spec(d.spec, d.shape, sizes)


def _draw_block(torch, cfg, i: int, d, spec: tuple, sizes: dict,
                coord: dict, dev):
    """(block, its offset in each dim) of parameter `i` at the mesh
    coordinate `coord`: zeros or ones, or f32 normals times the
    descriptor's std drawn from a seed of the parameter, the block and
    (for a 3-D leaf) each slice along dim 0, cast to the parameter's
    dtype.  Ranks holding the same block draw the same values."""
    from repro_torch.models.layers import DTYPES
    from repro_torch.models.sharded import _axes

    shape, idx = [], []
    for dim, n in enumerate(d.shape):
        k, j = 1, 0
        for a in _axes(spec[dim] if dim < len(spec) else None):
            k, j = k * sizes[a], j * sizes[a] + coord[a]
        shape.append(n // k)
        idx.append(j)
    offsets = [j * n for j, n in zip(idx, shape)]
    dtype = d.resolve_dtype(DTYPES[cfg.dtype])
    if d.init in ("zeros", "ones"):
        return torch.full(shape, float(d.init == "ones"), dtype=dtype,
                          device=dev), offsets
    out = torch.empty(shape, dtype=dtype, device=dev)
    rows = out if len(shape) == 3 else out[None]
    for e in range(rows.shape[0]):
        seed = hash((MODEL_SEED, i, *idx, e)) & (2**63 - 1)
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows[e].copy_(torch.randn(rows.shape[1:], generator=gen, device=dev)
                      * d.std())
    return out, offsets


def _block_params(torch, cfg, mesh, dev) -> dict:
    """This rank's block of every parameter (`_draw_block`)."""
    from repro_torch.dist import collectives as C
    from repro_torch.launch import mesh_shape

    sizes = mesh_shape(mesh)
    coord = {n: C.axis_index(mesh, n) for n in sizes}
    return {name: _draw_block(torch, cfg, i, d, spec, sizes, coord, dev)[0]
            for i, name, d, spec in _leaves(cfg, sizes)}


def _whole_params(torch, cfg, sizes: dict, dev) -> dict:
    """Every parameter whole, its blocks at every mesh coordinate drawn
    as the ranks draw them (`_draw_block`)."""
    import itertools

    from repro_torch.models.layers import DTYPES

    coords = [dict(zip(sizes, c)) for c in
              itertools.product(*(range(n) for n in sizes.values()))]
    out = {}
    for i, name, d, spec in _leaves(cfg, sizes):
        full = torch.empty(d.shape, dtype=d.resolve_dtype(DTYPES[cfg.dtype]),
                           device=dev)
        for coord in coords:
            block, offsets = _draw_block(torch, cfg, i, d, spec, sizes,
                                         coord, dev)
            full[tuple(slice(o, o + n) for o, n in
                       zip(offsets, block.shape))] = block
            del block
        out[name] = full
    return out


def _shard_wide_reference(torch, phase: str, dev, tmp) -> float:
    """S6-S8's unsharded f32 model on its whole batch, run on the card and
    freed: its hidden state, logits and decode logits written to `tmp`.
    Returns the seconds."""
    from repro_torch._tf32 import no_tf32
    from repro_torch.models import decode_step, forward, init_cache
    from repro_torch.models.model import _hidden, _tree

    t0 = time.perf_counter()
    spec = SHARD_WIDE[phase]
    cfg = _wide_cfg(phase, f32=True)
    full = _whole_params(torch, cfg, dict(zip(("data", "model"),
                                              spec["mesh"])), dev)
    B, S = spec["agree"]
    batch = _wide_batch(cfg, phase, B, S, SHARD["decode_steps"])
    frames = batch.get("frames")
    data = {"tokens": batch["tokens"]}
    if frames is not None:
        data["frames"] = frames
    with no_tf32(), torch.no_grad():
        hidden = _hidden(_tree(full), cfg, data).cpu()
    logits = forward(full, cfg, data).cpu()
    cache = init_cache(full, cfg, B, SHARD["decode_steps"], frames=frames)
    dec = []
    for tok in batch["steps"].T:
        lg, cache = decode_step(full, cfg, cache, tok)
        dec.append(lg.cpu())
    torch.save({"hidden": hidden, "logits": logits,
                "decode": torch.stack(dec)}, Path(tmp) / f"{phase}.pt")
    del full, cache
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _shard_wide(torch, smoke, phase: str, tmp) -> dict:
    """S6-S8 (SHARD_WIDE) in one rank."""
    from repro_torch._tf32 import no_tf32
    from repro_torch.data import shard_batch
    from repro_torch.dist import collectives as C
    from repro_torch.launch import batch_axes, make_host_mesh, set_mesh
    from repro_torch.models import decode_step, forward, init_cache, moe
    from repro_torch.models import sharded as SH
    from repro_torch.models.model import _hidden, _tree

    spec = SHARD_WIDE[phase]
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(*spec["mesh"], device_type="cuda")
    dp = batch_axes(mesh)
    n_dp, m = spec["mesh"]
    cfg = _wide_cfg(phase)
    B, S = spec["prefill"]
    rows = shard_batch(_wide_batch(cfg, phase, B, S, 0), mesh, dp)
    data = {k: v for k, v in rows.items() if k != "steps"}
    local = _block_params(torch, cfg, mesh, dev)
    torch.cuda.empty_cache()
    # the expert buffer of each MoE layer: (experts, rows) on this rank
    buffers, experts = [], moe._experts

    def spy(params, descr, h, lay):
        buffers.append(tuple(h.shape[:2]))
        return experts(params, descr, h, lay)

    moe._experts = spy
    smoke.zero_counts()
    C.reset_account()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with set_mesh(mesh):
            logits = forward(local, cfg, data, dp=dp)
        torch.cuda.synchronize()
    finally:
        moe._experts = experts
    V = cfg.vocab_size
    out = dict(seconds=time.perf_counter() - t0, counts=smoke.read_counts(),
               flash=dict(smoke.flash_kernels()), account=C.account(),
               shape=tuple(logits.shape), dtype=str(logits.dtype),
               want_shape=(B // n_dp, S, V // m if V % m == 0 else V),
               finite=bool(torch.isfinite(logits).all()), buffers=buffers,
               global_rows=(cfg.num_experts * moe.capacity(
                   cfg, min(B * S, 131_072)) if cfg.num_experts else 0))
    del logits, local
    torch.cuda.empty_cache()
    # the f32 copy against the parent's unsharded run (SHARD_WIDE)
    t0 = time.perf_counter()
    cfg32 = _wide_cfg(phase, f32=True)
    B, S = spec["agree"]
    steps = SHARD["decode_steps"]
    rows = shard_batch(_wide_batch(cfg32, phase, B, S, steps), mesh, dp)
    data = {k: v for k, v in rows.items() if k != "steps"}
    local = _block_params(torch, cfg32, mesh, dev)
    want = torch.load(Path(tmp) / f"{phase}.pt", mmap=True)
    tol = SHARD["prefill_tol"]
    err, close = {}, {}

    def hold(name, got, full, spec_):
        w = SH.local_block(full, mesh, SH.sanitize_spec(
            spec_, tuple(full.shape), mesh)).to(dev)
        e = float((got - w).abs().max())
        err[name] = max(err.get(name, 0.0), e)
        close[name] = close.get(name, True) and bool(
            torch.allclose(got, w, rtol=tol, atol=tol))

    C.reset_account()
    with set_mesh(mesh), no_tf32(), torch.no_grad():
        hidden = _hidden(_tree(local), cfg32, data,
                         lay=SH.layout(cfg32, dp))
    hold("hidden", hidden, want["hidden"], (dp, None, None))
    del hidden
    with set_mesh(mesh):
        logits = forward(local, cfg32, data, dp=dp)
    hold("logits", logits, want["logits"], (dp, None, "model"))
    del logits
    with set_mesh(mesh):
        cache = init_cache(local, cfg32, B // n_dp, steps,
                           frames=data.get("frames"), dp=dp)
        out["cache_memory"] = (None if cache["memory"] is None
                               else tuple(cache["memory"].shape))
        for t, tok in enumerate(rows["steps"].T):
            lg, cache = decode_step(local, cfg32, cache, tok, dp=dp)
            hold("decode", lg, want["decode"][t], (dp, "model"))
    del local, cache, want
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    out.update(err=err, close=close, agree_s=time.perf_counter() - t0,
               agree_account=C.account())
    return out


def _shard_rank(rank, world, tmp):
    """S1-S5, S2A and S6-S8 in one rank of the 4-rank group."""
    import torch

    from repro_torch.launch import make_host_mesh

    torch.cuda.set_device(0)
    smoke = Smoke(torch)
    mesh = make_host_mesh(*SHARD["mesh"], device_type="cuda")
    out = {"S1": _shard_prefill(torch, smoke, mesh)}
    out["S2"], out["S3"] = _shard_train(torch, smoke, mesh, tmp)
    out["S2A"] = _shard_adafactor(torch, smoke, mesh, tmp)
    for phase in SHARD_KINDS:
        out[phase] = _shard_kind(torch, smoke, mesh, phase)
    for phase in SHARD_WIDE:
        out[phase] = _shard_wide(torch, smoke, phase, tmp)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    smoke = Smoke(torch)
    timeline = smoke.report["timeline"] = {}

    def stamp(label):
        # seconds since the start at the end of each group of phases
        timeline[label] = time.perf_counter() - t_start
        log(f"[time] {label} done at {timeline[label]:.1f} s")

    smoke.build()
    stamp("build")

    g5, plan5, x05, graph5, pl5 = smoke.setup(100_000)
    lp0 = plan5.levels[0]
    T0 = 50  # the finest level's FI chunk at n=1e5
    sched = smoke.prng(lp0, T0)
    top = smoke.sample_chunk(plan5)
    smoke.sample_chunk_scenario(plan5)
    smoke.pair_apply(lp0, sched, T0, top)
    del top
    g2, plan2, x02, _, _ = smoke.setup(20_000)
    smoke.cell_mixing(plan2)

    # each path runs with the counts set to 0 just before it and read just
    # after; `launches` is the count of the kernel's own first path
    main5 = smoke.large_n(100_000, g5, plan5, x05, graph5, pl5)
    scen = smoke.scenarios(g5, plan5, x05)
    per_tick = smoke.per_tick(g5, plan5, x05)
    stamp("gossip n=1e5 and n=20000 kernels, main path, scenarios, per-tick")
    # M1-M4: the sharded executors, ranks of one gloo group on this card
    mesh = smoke.meshes(plan5, x05)
    stamp("M1-M4")
    mesh_paths = {
        f"execute_plan FI n=100000, {MESH['trials']} trials on a "
        f"{MESH['ranks']}-rank trial mesh (gloo, one card), backend cuda, "
        f"each rank": mesh["m1"],
        f"execute_plan FI n=100000, {MESH['node_trials']} trials on a 2 x 2 "
        f"(trials, nodes) mesh (gloo, one card), backend cuda, each rank":
            mesh["m2"]}
    del g5, plan5
    # S1-S8: model sharding over a (data, model) mesh, ranks on this card
    torch.cuda.empty_cache()
    shard = smoke.sharded_model()
    stamp("S1-S8")
    # D1: the dry run of S1's and S2's cells and of two full-size cells
    smoke.dryrun()
    stamp("D1")
    g6, plan6, x06, graph6, pl6 = smoke.setup(1_000_000)
    main6 = smoke.large_n(1_000_000, g6, plan6, x06, graph6, pl6)
    del g6, plan6
    scen_path = (f"run_scenario_matrix FI n=100000, 5 scenarios x "
                 f"{SCENARIO_TRIALS} trials, priced, backend cuda")
    main_paths = {"multiscale_gossip FI n=100000, backend cuda": main5,
                  "multiscale_gossip FI n=1000000, backend cuda": main6,
                  scen_path: scen}
    mm = smoke.matmul(g2, plan2, x02)
    mm_scen = smoke.matmul_scenario(g2, plan2, x02)
    sy = smoke.synchronous()
    sg, fig5 = smoke.baselines()
    baseline_paths = {"standard_gossip n=500 eps=1e-2, backend cuda": sg,
                      "multiscale_gossip fig5 n=2000 eps=1e-4, 3 trials, "
                      "backend cuda": fig5}
    control = smoke.control_plane()
    fleet = smoke.fleet()
    stamp("n=1e6, matmul, synchronous, baselines, control plane, fleet")
    fleet_paths = {
        **{f"ControlPlane R={R} full view, one round, backend cuda": n
           for R, n in control.items()},
        **{f"run_fleet R={R} {FLEET['ticks']} ticks p2c_gossip, backend "
           f"cuda": n for R, n in fleet.items()}}
    smoke.kernels["pair_apply"].update(
        launches=main5, path="multiscale_gossip FI n=100000, backend cuda",
        launches_by_path={**main_paths, **mesh_paths, **baseline_paths,
                          **fleet_paths})
    smoke.kernels["sample_chunk"].update(
        launches=main5, path="multiscale_gossip FI n=100000, backend cuda",
        launches_by_path={
            **main_paths, **mesh_paths,
            "multiscale_gossip FI n=20000, backend matmul": mm,
            "execute_plan FI n=20000 churn / byzantine, priced, backend "
            "matmul (each)": mm_scen, **baseline_paths, **fleet_paths})
    smoke.kernels["cell_mixing"].update(
        launches=mm, path="multiscale_gossip FI n=20000, backend matmul",
        launches_by_path={
            "multiscale_gossip FI n=20000, backend matmul": mm,
            "execute_plan FI n=20000 churn / byzantine, priced, backend "
            "matmul (each)": mm_scen,
            "synchronous_multiscale n=2000": sy,
            "multiscale_gossip FI n=100000, schedule per_tick, backend "
            "cuda": per_tick})

    # the rwkv6-3b serving path; the gossip phases' plans are freed first
    del g2, plan2, x02, lp0, sched
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config

    smoke.rwkv6()
    cfg = get_config("rwkv6-3b")
    model = smoke.model(cfg)
    forward_path = f"forward rwkv6-3b {PREFILL[0]}x{PREFILL[1]}"
    serve_path = f"Generator rwkv6-3b {SERVE[0]}x({SERVE[1]}+{SERVE[2]})"
    wkv = smoke.prefill(model, cfg, "rwkv6", 32, "rwkv6")
    served = smoke.serve(model, cfg, "rwkv6")
    smoke.agreement(model, cfg, checked=False)
    # P5: the paged engine, which launches no kernel
    smoke.zero_counts()
    smoke.report["paged_rwkv6-3b"] = dict(engine=smoke.serve_paged(model, cfg))
    paged_counts = smoke.read_counts()
    smoke.check_idle(paged_counts, None, "the rwkv6-3b paged engine")
    paged_path = (f"BatchingEngine rwkv6-3b, {PAGED_REQUESTS[cfg.name]} "
                  f"requests through {PAGED['slots']} paged slots")
    smoke.kernels["rwkv6"].update(
        launches=wkv, path=forward_path,
        launches_by_path={forward_path: wkv, serve_path: served,
                          paged_path: paged_counts["rwkv6"]})
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = smoke.model(cfg32)
    smoke.agreement(model32, cfg32, checked=True)
    del model32
    torch.cuda.empty_cache()
    stamp("rwkv6-3b serving")

    # the llama3.2-3b serving path; the rwkv6-3b models are freed first
    smoke.flash()
    torch.cuda.empty_cache()
    cfg = get_config("llama3.2-3b")
    model = smoke.model(cfg)
    forward_path = f"forward llama3.2-3b {PREFILL[0]}x{PREFILL[1]}"
    serve_path = f"Generator llama3.2-3b {SERVE[0]}x({SERVE[1]}+{SERVE[2]})"
    flash = smoke.prefill(model, cfg, "flash_attention", 28,
                          "flash_kernel_sm90",
                          {"flash_attention_sm90": 28, "flash_attention": 0})
    served = smoke.serve(model, cfg, "flash_kernel_sm90")
    smoke.agreement(model, cfg, checked=False)
    # P4: paged against dense decode, then the paged engine; no kernel
    smoke.zero_counts()
    smoke.report["paged_llama3.2-3b"] = dict(
        vs_dense=smoke.paged_vs_dense(model, cfg),
        engine=smoke.serve_paged(model, cfg))
    paged_counts = smoke.read_counts()
    smoke.check_idle(paged_counts, None, "the llama3.2-3b paged paths")
    check(not any(smoke.flash_kernels().values()),
          f"the llama3.2-3b paged paths launched {smoke.flash_kernels()}")
    paged_path = (f"paged_decode_step and BatchingEngine llama3.2-3b, "
                  f"{PAGED_REQUESTS[cfg.name]} requests through "
                  f"{PAGED['slots']} paged slots")
    smoke.kernels["flash_attention"].update(
        launches=flash, path=forward_path,
        launches_by_path={forward_path: flash, serve_path: served,
                          paged_path: paged_counts["flash_attention"]})
    del model
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = smoke.model(cfg32)
    smoke.agreement(model32, cfg32, checked=True)
    del model32
    torch.cuda.empty_cache()
    stamp("flash kernels, llama3.2-3b serving")

    # training, after the serving models are freed: T1 (llama3.2-3b at
    # full width through the Trainer, checkpoint and resume), T1b (card vs
    # CPU), T2 (R=8 replicas, four sync modes) and T3 (the failure
    # matrix).  The training route launches none of the kernels: each
    # kernel's count over the four phases together must stay 0.
    smoke.zero_counts()
    smoke.train()
    smoke.train_cpu()
    dec = smoke.dec_setup()
    smoke.decentralized(*dec)
    smoke.train_scenarios(*dec)
    del dec
    torch.cuda.empty_cache()
    counts = smoke.read_counts()
    smoke.check_idle(counts, None, "training (T1-T3)")
    check(not any(smoke.flash_kernels().values()),
          f"training launched {smoke.flash_kernels()}")
    for name, row in smoke.kernels.items():
        row["train_launches"] = counts[name]
    log(f"[train] kernel launches over T1-T3: {counts}")
    # T1L: one step at train_4k's sequence, through chunked_attention
    smoke.zero_counts()
    smoke.train_long()
    train_long = smoke.read_counts()
    smoke.check_idle(train_long, None, "T1L")
    check(not any(smoke.flash_kernels().values()),
          f"T1L launched {smoke.flash_kernels()}")
    stamp("T1-T3, T1L")

    # the zoo's other block kinds, after training's state is freed: Z0 the
    # flash kernels at their prefill shapes; Z1 recurrentgemma-9b at full
    # width and depth, Z2 its paged paths, then its f32 copy; Z3 gemma2-
    # 27b and Z4 grok-1-314b at full width, their depth cut
    smoke.flash_zoo()
    torch.cuda.empty_cache()
    model, cfg, zoo_paths = smoke.zoo_serve("recurrentgemma-9b")
    smoke.zero_counts()
    smoke.report["paged_recurrentgemma-9b"] = dict(
        vs_dense=smoke.paged_vs_dense(model, cfg),
        engine=smoke.serve_paged(model, cfg))
    paged_counts = smoke.read_counts()
    smoke.check_idle(paged_counts, None, "the recurrentgemma-9b paged paths")
    check(not any(smoke.flash_kernels().values()),
          f"the recurrentgemma-9b paged paths launched "
          f"{smoke.flash_kernels()}")
    zoo_paths[f"paged_decode_step and BatchingEngine recurrentgemma-9b, "
              f"{PAGED_REQUESTS[cfg.name]} requests through "
              f"{PAGED['slots']} paged slots"] = paged_counts["flash_attention"]
    del model
    torch.cuda.empty_cache()
    smoke.zoo_agree("recurrentgemma-9b")
    for arch in ("gemma2-27b", "grok-1-314b"):
        model, cfg, paths = smoke.zoo_serve(arch)
        zoo_paths.update(paths)
        del model
        torch.cuda.empty_cache()
        smoke.zoo_agree(arch)
    smoke.kernels["flash_attention"]["launches_by_path"].update(zoo_paths)
    stamp("Z0-Z4")

    # chunked_attention (X1), whisper-tiny at full size (W1) and
    # qwen2-vl-72b at M-RoPE positions (Q1)
    smoke.chunked()
    smoke.kernels["flash_attention"]["launches_by_path"].update(
        {**smoke.whisper(), **smoke.qwen(),
         f"make_train_step llama3.2-3b {TRAIN_LONG['batch']}x"
         f"{TRAIN_LONG['seq']}, one step": train_long["flash_attention"]})
    smoke.kernels["flash_attention"]["zoo_shapes"] = [
        {k: row[k] for k in ("label", "shape", "window", "softcap", "ms",
                             "bound_ms", "bound_by", "plain_ms", "library_ms",
                             "max_abs_err")}
        for row in smoke.report["flash_zoo"]]
    stamp("X1, W1, Q1")

    m4_path = (f"make_decentralized_step llama3.2-3b width, 1 layer, sgdm, "
               f"{MESH_TRAIN['R']}-rank replica mesh (gloo, one card), each "
               f"rank")
    s1_path = (f"forward llama3.2-3b {SHARD['prefill_layers']} layers "
               f"{PREFILL[0]}x{PREFILL[1]} on a 2 x 2 (data, model) mesh "
               f"(gloo, one card), each rank")
    s2_path = (f"make_train_step llama3.2-3b width, {SHARD['train_layers']} "
               f"layers, f32, AdamW, {SHARD['train'][0]}x{SHARD['train'][1]} "
               f"on a 2 x 2 (data, model) mesh, each rank")
    kind_paths = {
        phase: (f"forward {arch} {layers} layers {PREFILL[0]}x{PREFILL[1]} "
                f"on a 2 x 2 (data, model) mesh (gloo, one card), each rank")
        for phase, (arch, layers, _, _) in SHARD_KINDS.items()}
    kind_paths["S2A"] = (f"make_train_step llama3.2-3b width, "
                         f"{SHARD['train_layers']} layers, f32, Adafactor, "
                         f"{SHARD['train'][0]}x{SHARD['train'][1]} on a 2 x 2 "
                         f"(data, model) mesh, each rank")
    kind_paths.update({
        phase: (f"forward {w['arch']} {w['layers'] or 'all'} layers "
                f"{w['prefill'][0]}x{w['prefill'][1]} on a "
                f"{w['mesh'][0]} x {w['mesh'][1]} (data, model) mesh (gloo, "
                f"one card), each rank")
        for phase, w in SHARD_WIDE.items()})
    for name, row in smoke.kernels.items():
        row["launches_by_path"][m4_path] = mesh["m4"][name]
        row["launches_by_path"][s1_path] = shard["S1"][name]
        row["launches_by_path"][s2_path] = shard["S2"][name]
        for phase, path in kind_paths.items():
            row["launches_by_path"][path] = shard[phase][name]

    # E1: the example scripts on the card
    torch.cuda.empty_cache()
    example_paths = smoke.examples()
    stamp("E1")
    for name, row in smoke.kernels.items():
        for path, counts in example_paths.items():
            row["launches_by_path"][path] = counts[name]

    total = time.perf_counter() - t_start
    smoke.report["total_s"] = total
    smoke.report["kernels"] = list(smoke.kernels.values())
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(smoke.report, indent=1, default=float))
    log(f"[done] all phases passed in {total:.1f} s")
    kernels = [{k: v for k, v in row.items() if k != "shape"}
               for row in smoke.kernels.values()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
