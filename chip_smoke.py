#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of the Elim-ABtree.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's seven hand-written CUDA kernels from ``src/repro_torch/
csrc`` (one ``nvcc`` per source, in parallel, into ``build/``), then:

1. prints the card's name and power limit, and counts the kernels one
   decode-attention call (B7) runs on the card at the serve phase's shapes,
   and one elimination-combine call (K3), frontier-compaction call (K2) and
   range-scan call (K4) at the tree path's shapes (``torch.profiler``, one
   session), each of which must be 1;
2. drives the port's tree path, ``ABTree.apply_round`` in elim mode on one
   tree at the paper's b = 11 with int64 keys and values: prefill of half
   the key range in insert rounds (a first one of 4,096 lanes into the empty
   tree, then rounds of 65,536 lanes), then warm-up and measured
   mixed rounds of 16,384 lanes (Zipf(1.0) keys; 45% insert, 45% delete,
   5% find, 5% range with span uniform in [1, 64]; scan cap 128).  Every
   round is checked lane for lane against ``DictOracle.apply_mixed_round``
   and the tree against ``check_invariants`` at the end.  The launch count
   of every kernel is zeroed before this path and read after it.  Then one
   ``scan_round`` at cap 10,000 over an interval of more than 10,000 live
   keys (the frontier grows to fit, and stays grown, so it runs after the
   timed rounds) must equal ``DictOracle.range``: keys, values, count and
   truncated; then the core's bare-state forms on the tree's state:
   ``frontier_expand`` of 1,024 intervals of span U[1,64] at cap 8 on the
   card (K2 once a level) equal to the same call on a CPU copy, all five
   outputs, and ``descend`` + ``probe`` of the same lanes' keys equal to
   K1's answers; and ``data.workloads.prefill_tree`` of a fresh
   ``ABTree(PAPER)`` over a key range of 20,000 (10,000 keys in ten
   1,024-lane rounds), each round checked against ``DictOracle``;
   then occ mode: the tree's final state and a copy of its oracle in
   ``ABTree(mode="occ")``, one warm-up and three measured Zipf(1.0) rounds
   and three uniform rounds of the same width and mix (each a run of
   duplicate-rank sub-rounds), every round checked lane for lane and the
   tree's invariants at the end, with the launch counts zeroed before and
   read after; and three uniform rounds through an elim tree holding a
   copy of the same state, beside them;
   then the forest, ``ABForest(n_shards=4, ...)`` at the same b = 11 over
   the same key range and mix, twice: with ``auto_repartition=True`` and
   fewer keys (a cut listed in PERF.md; the hot head of the Zipf keys makes
   it retire cold shards, each action timed with its sweep and its
   re-insertion by the forest's tracer spans), then with the static
   partition at 10^6 keys; each with three warm-up and ten measured
   16,384-lane rounds checked against the oracle and
   ``check_forest_invariants``, the second with one
   ``scan_stream`` (cap 128) across its first split point against
   ``DictOracle.range``; then the serving
   indexes sharded four ways (``PrefixIndex`` / ``SessionIndex`` as
   ``ServeEngine(index_shards=4)`` builds them) through a few hundred
   publish / lookup / evict calls, each checked against a ``DictOracle``;
   then durability (``run_durable_path``): ``DurableABTree`` at the tree
   path's configuration and mix with its journal on a disk-backed
   filesystem (its type and device printed), prefilled with the tree
   path's keys, warm-up and measured rounds each checked against the oracle
   after its commit returned; a ``mid_manifest`` crash two commits ahead,
   ``recover`` on the card (timed by phase) equal to the committed prefix
   and to ``recover(device="cpu")`` of a copy; groups of 8 rounds
   committed on the background thread; a seeded ``FaultPlan`` (two
   ``eio`` fsyncs retried, a torn segment truncated and quarantined at
   recovery); occ (the paper's p-OCC) on a tree of 2.5·10^5 keys, Zipf
   and uniform rounds beside uniform elim rounds; the sharded indexes
   journaled, closed and warm-restarted against their oracles;
   then the obs phase (``run_obs_path``), over histories the paths above
   recorded: the port's linearizability witness replays the tree path's
   flight recorder from the empty tree (its rounds, lanes, eliminated ops
   and final contents equal to what the path issued and the tree counted),
   ``python -m repro_torch.obs.witness`` accepts the exported JSONL, and a
   swapped eliminated insert / delete pair and a dropped delete lane are
   rejected; a ``DurableABTree`` from empty with its recorder on, crashed
   ``mid_manifest`` and recovered on the card, whose forensics sidecar
   replays to the recovered contents, one of its prefix states; the tree
   path's traced rounds written as a Chrome trace, valid, with report
   totals equal to the traced breakdown and a ``Tracer.counter`` track
   of each traced round's retry passes, and two traced rounds of the
   static forest (valid, per-shard tracks, ``report --json`` 0); and the
   ``torch.profiler`` op audit of the search and scan phases on the tree
   path's tree (no sort in the scan phases; K1 and K3 once a search, K2
   and K4 in the scans, each counted by its wrapper and seen by the
   profiler);
3. drives the serving path: ``ServeEngine`` on qwen2-0.5b at its full
   width and depth (24 layers, bf16 compute over fp32 weights made from the
   seed), max_batch 8, s_max 1024, 32 KV pages; 3 requests of 264-token
   prompts (one full prefix block), each the hot prompt at 70% (two of
   the three), 32 new tokens each; run serial, then pipelined, with the
   launch counts zeroed before the serial run and read after the
   pipelined one.  Both runs must
   give every request 32 tokens and the same tokens; both indexes must pass
   ``check_invariants`` and hold what a ``DictOracle`` fed the same
   publish / evict / sweep calls holds (every lookup and sweep is checked
   against it as it happens); the prefix cache must be hit.  A third, short
   run with the phase tracer on gives the per-tick breakdown;
4. drives the training path: the ``Trainer`` that ``python -m
   repro_torch.launch.train --arch qwen2-0.5b`` builds (full width and
   depth, the launcher's warmup-cosine schedule), batch 8 x 1,024 tokens of
   the synthetic Zipf stream, 20 steps, checkpoint in a temporary directory,
   launch counts zeroed before it and read after it (flash attention: 24 a
   forward, none in the backward), then one step under ``torch.profiler``
   for the device's busy time; 8 steps at a constant 1e-3 on one fixed
   batch, whose loss must fall; and a crash at step 6, a restart and a
   resume from step 4 to 12 on the reduced 2-layer config;
5. drives the LM family and the rest of the training stack, the launch
   counts zeroed before and read after, and the card's peak memory printed
   for each part: (a) ``ServeEngine`` on granite-moe-3b-a800m at its
   published width and depth (32 layers, 40 experts top-8, bf16 compute
   over fp32 weights from the seed), max_batch 8, s_max 512, 32 pages; 2
   requests of one hot 264-token prompt (the second hits its first
   256-token block), 8 new tokens each, serial; every request gets
   its tokens, the indexes pass ``check_invariants`` and equal their
   ``DictOracle``, B7 runs once a layer a model step, one decode step run
   twice from the same cache and tokens gives bit-equal logits (the MoE
   scatter back is deterministic), and the step's wall time is set against
   its CUDA-graph replay; (b) the ``Trainer`` that ``python -m
   repro_torch.launch.train --arch granite-moe-3b-a800m --batch 2 --seq
   1024`` builds, its train step driven directly: 2 warm-up and 5 timed
   steps (B6 once a layer a forward, none in the backward), a profiled
   step, then 6 steps at a constant 1e-3 on one fixed batch, whose loss
   must fall; (c) deepseek-v3-671b reduced (a dense and an MoE layer, the
   shared expert, MLA, remat "dots"): one train step's loss and grads
   finite, 8 decode steps over the latent cache with finite logits; (d)
   ``embed_elim_update`` against ``embed_occ_update`` on qwen2-0.5b's
   embedding table with 8 x 1,024 ids of the training stream: both within
   each touched row's summation-order bound of a float64 sum, every other
   row unchanged, the write statistics exact; (e) ``DedupIndex`` in elim
   mode: 48 batches of 4,096 documents (the first 512), 30% repeating an
   earlier batch's (Zipf(1.1) over the history) and 5% one of the same
   batch, every keep list equal to a Python set's and the tree sound at
   the end; (f) ``quantize_int8`` on 2^26 values bit-equal to the CPU's,
   its round trip within max|x|/127, and 50 steps of ``_ef_quantize``
   within max|g| of 50·g;
6. drives the ssm, hybrid and audio families, the launch counts zeroed
   before and read after: xlstm-350m, zamba2-1.2b and whisper-tiny at their
   published widths and depths (fp32 weights from the seed, bf16 compute)
   each served by ``ServeEngine(max_batch=8, s_max=512)`` (whisper: s_max
   448, its decoder context), 2 requests of 64-token prompts, 8 new tokens
   each, serially (zamba2 also pipelined, its tokens equal to the serial
   run's), checked as step 5 checks granite's run (indexes against their
   oracle, B7 a fixed count a model step, a decode step repeated from
   copies of one cache bit-equal, the step's wall time against its
   CUDA-graph replay); zamba2 trained by the launcher's ``Trainer`` at batch
   2 x 1,024 and whisper at 8 x 448 tokens over 1,500 frames, as step 5
   trains granite (timed steps, a profiled step, the loss falling on a
   fixed batch); xlstm one loss and gradient step at 1 x 256, all finite,
   and its chunked mLSTM against the step-by-step form on the card within
   1e-5; and for each family a 2-layer model at full width in f32 on the
   card and on the CPU with the same params, ``forward_train`` and three
   decode steps with their caches within 1e-4, each decode step repeated on
   the card bit-equal;
7. drives the parallel layer (``run_parallel_path``), the launch counts
   zeroed before and read after: on ``make_host_mesh()``'s 1-rank
   ``(data, model)`` NCCL mesh, qwen2-0.5b at full width trained 2 steps
   (8 x 1,024 tokens) by the Trainer ``launch/train.py --mesh host`` builds
   (DTensor params and AdamW state) against the mesh-free Trainer's 2 steps
   from the same weights and batches, losses bit-equal and B6 24 a step on
   each; the mesh-free run's checkpoint restored onto the mesh (``--mesh
   host`` resuming it) and a third step on each, losses equal; 4 decode
   steps of ``make_serve_step`` (the cache placed by ``cache_shardings``)
   against ``forward_decode``, logits and cache bit-equal, B7 24 a step on
   each; ``compressed_grad_reduce`` of qwen2's gradients over a (pod=1,
   data=1, model=1) mesh equal to ``dequantize_int8(_ef_quantize(...))`` on
   the card and on the CPU, bit for bit; a one-stage ``pipeline_apply``
   equal to its stage, and its gradients of ``sum(out * g)`` for the
   weights and the microbatches within 1e-5 of the stage's own; granite's
   MoE layer (``moe_groups=32``, 2 x 1,024
   tokens) under the mesh equal to the mesh-free path; the process group
   destroyed; beside it, in subprocesses started first, the dry-run CLI on
   deepseek-v3-671b ``decode_32k`` over the fake 512-rank multi-pod mesh
   with ``--suite opt`` and its depth-probe correction (``correct_cell``:
   the same cell at 1-3 layers, full width), whose predicted FLOPs, bytes
   and collective bytes must equal the full-depth record's (both on
   qwen2-0.5b's cell instead past their time), the record's per-device
   bytes and FLOPs and its row of the report's roofline table printed;
   and, beside the phase too, the examples: ``examples/quickstart_torch.py``,
   ``durable_store_torch.py``, ``serve_engine_torch.py`` and
   ``train_lm_torch.py`` on the card, each in a subprocess that counts its
   kernel launches: the tree's elimination (no slot write for 64 ops on
   one key), the recovered items, the durable commits, fsyncs and flush
   bytes of p-Elim and p-OCC and the serve engine's index counters must be
   the integers the JAX examples print on the CPU, and the trainer crashed
   at step 6 must resume from its step-5 checkpoint to the final loss of
   an uninterrupted run; K1, K3, B6 and B7 must each have launched;
8. replays one main-path call of each kernel: kernel and plain PyTorch
   version on the same CUDA tensors must agree (the tree kernels and the
   leaf probe bit for bit; the two attention kernels within 2 ulps of
   their dtype at the output's largest magnitude, on the path's tensors and
   on seeded random ones of the same shapes; flash attention also windowed,
   ragged and non-causal, and its gradients equal to the plain version's
   autograd); the descent (K1) and the combine (K3) also on the static
   forest's first measured search call, at S = 4; the leaf probe, which no path calls, runs
   over the leaf rows the tree path's search reached and must give K1's
   own answers; all are
   timed, beside the least time the card needs for the call (its bytes at
   3.35 TB/s or its operations at the peak for their type, whichever is
   longer) and, where one PyTorch call computes a comparable function, that
   call's time; the descent (K1) also with the levels its longest walk
   visits (the dependent loads of its chain), K2, K3 and K4 with step 1's
   counts; the range scan (K4) also on two seeded replays past the cap
   the card's first kernel held (cap 8,193 over rows of 9,000 candidates,
   cap 20,000 over rows of 24,000, EMPTY holes and duplicate keys), each
   bit-equal to the plain version and timed; flash attention also with
   the count of HGMMA (wgmma) instructions in its built library, which
   must not be 0, and decode attention with step 1's count and the
   clusters of each size the card holds at once; flash attention (B6) and
   decode attention (B7) also on step 5's granite calls (group 3) and on
   step 6's zamba2 and whisper calls (group 1: zamba2's shared block,
   whisper's encoder over 1,500 frames without causality, its
   cross-attention decode over them), rows of their own in the ``kernels``
   line;
9. prints the seconds of the parity checks (the bare-state forms,
   ``prefill_tree``, the counter track, the pipeline's backward) and
   ``{"ok": true, "device": {...}}`` as its last line.

Any failed check raises, so the script exits non-zero.  Without a CUDA card,
or without the repository's ``src/repro_torch`` beside it, it exits 2 and
prints no result.
"""
from __future__ import annotations

import collections
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PREFILL_BATCH = 65_536  # lanes per prefill insert round
# the first prefill round goes into an empty tree, where the retry passes
# grow with the round's width (about one pass per 6 lanes: 65,536 lanes took
# ~11,000 passes and ~275 s); a narrow first round seeds the leaves, and the
# wide rounds after it spread over them
PREFILL_FIRST_BATCH = 4_096
BATCH = 16_384  # lanes per mixed round
WARMUP, ROUNDS, TRACED_ROUNDS, RECORDER_OFF_ROUNDS = 3, 20, 3, 5
# keys are drawn from [0, KEY_RANGE) and half of it is prefilled; if the run
# outgrows its time limit this is the scale to halve, and the cut goes into
# PERF.md.
KEY_RANGE = 2_000_000
SEED = 0
# the end-to-end check of a cap above 8,192: one scan_round over
# [LARGE_SCAN_LO, LARGE_SCAN_LO + LARGE_SCAN_SPAN), about 15,000 live keys
LARGE_SCAN_CAP, LARGE_SCAN_LO, LARGE_SCAN_SPAN = 10_000, KEY_RANGE // 4, 30_000
# K4 replays past that cap: (rows, candidates a row, cap)
K4_LARGE = ((2, 9_000, 8_193), (2, 24_000, 20_000))
# occ phase: the tree path's final tree copied into ABTree(mode="occ"), at
# the tree path's width and mix; then uniform rounds through both modes
OCC_WARMUP, OCC_ROUNDS, UNIFORM_ROUNDS = 1, 3, 3
# forest phase: ABForest(n_shards=4, PAPER, key_space=(0, KEY_RANGE)) at the
# tree path's mix, once with auto_repartition=True and FOREST_PREFILL keys,
# once with the static partition and the tree path's 10^6.  The first holds
# fewer keys: Zipf(1.0) traffic makes that forest retire its cold shards,
# and each retirement re-inserts the moved keys densely into an emptied
# range at about one retry pass per 6 keys, so its time grows with the
# prefill (at 500,000 keys the warm-up ran past 690 s on an H100 80GB HBM3,
# at 50,000 its three retirements took 141 s, at 20,000 up to 120 s on a
# slow host; PERF.md section 4)
FOREST_SHARDS, FOREST_PREFILL = 4, 10_000
FOREST_WARMUP, FOREST_ROUNDS = 3, 10
FOREST_STREAM_CAP, FOREST_STREAM_HALF = 128, 20_000  # scan_stream around splits[0]
# sharded indexes without a model: steps of (publish, lookup, evict) calls
INDEX_SHARDS, INDEX_STEPS = 4, 100
# durable phase: DurableABTree at the tree path's configuration and mix, its
# journal in a fresh directory on a disk-backed filesystem (journal_dir)
DURABLE_WARMUP, DURABLE_ROUNDS, SIDECAR_ROUNDS = 3, 20, 3
DURABLE_GROUP, DURABLE_GROUP_ROUNDS = 8, 10
# the group's age bound: the default 0.05 s would close a group of these
# ~0.1 s rounds after two of them
DURABLE_GROUP_MAX_WAIT_S = 10.0
DURABLE_FAULT_ROUNDS = 7  # eio at the 2nd and 4th commit, a torn segment at the 6th
DURABLE_OCC_PREFILL = KEY_RANGE // 8  # cut from KEY_RANGE // 2 to keep the script's time in bounds
DURABLE_OCC_ZIPF, DURABLE_UNIFORM = 1, 3
DURABLE_INDEX_GROUP = 4
# obs phase: OBS_CRASH_FIRST lanes into an empty DurableABTree, then
# OBS_CRASH_ROUNDS rounds of BATCH, before its crash; OBS_FOREST_ROUNDS
# traced rounds of the static forest
OBS_CRASH_FIRST, OBS_CRASH_ROUNDS, OBS_FOREST_ROUNDS = 4_096, 7, 2
COMMIT_HISTS = ("commit_capture_s", "journal_flush_s", "commit_sidecar_s", "manifest_commit_s",
                "commit_latency_s", "journal_gc_s")
TREE_KERNELS = ("descend_probe", "frontier_compact", "elim_combine", "range_scan")
SERVE_KERNELS = TREE_KERNELS + ("decode_attention",)
# serve phase: qwen2-0.5b at full width and depth
SERVE_ARCH = "qwen2-0.5b"
SERVE_ENGINE = dict(max_batch=8, s_max=1024, n_pages=32)
# prompts of one full prefix block and 8 tokens (cut from 512 tokens, and
# from 4 requests to 3, to keep the script's time in bounds: the engine
# prefills token by token)
SERVE_REQUESTS, SERVE_PROMPT, SERVE_MAX_NEW, SERVE_HOT_FRAC = 3, 264, 32, 0.7  # 2 of them hot
TRACED_REQUESTS, TRACED_MAX_NEW = 2, 8
STEP_TIMING_STEPS = 20
# train phase: the Trainer on qwen2-0.5b at full width and depth, as
# ``python -m repro_torch.launch.train --arch qwen2-0.5b`` builds it
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 20
LOSS_FALL_STEPS, LOSS_FALL_LR = 8, 1e-3  # constant_lr on one fixed batch
RESUME_LAYERS, RESUME_FAIL_AT, RESUME_CKPT_EVERY, RESUME_STEPS = 2, 6, 4, 12
RESUME_BATCH, RESUME_SEQ = 4, 64
FLASH_WINDOW, FLASH_RAGGED_S = 256, 1000  # extra B6 replays: windowed, ragged non-causal
# B6's limit against its plain version: as B7's (f32: a fixed 1e-5)
FLASH_ULPS, FLASH_F32_TOL = 2, 1e-5
# B7's limit against its plain version, in ulps of the output's dtype at the
# output's largest magnitude: both accumulate in f32 and round once, so they
# differ by summation order and that one rounding
DECODE_ULPS = 2
# H100 SXM peak for the operands' type (dense): bf16 on the tensor cores,
# f32 outside them
OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# LM-family and training-stack phase: granite-moe-3b-a800m at its published
# width and depth, served (LM_HOT: 2 requests of one hot prompt, whose
# first 256-token block the second hits; cut from 4 requests, then from 3
# (a cold one), for the script's time on slow hosts)
# and trained by the launcher's Trainer
LM_ARCH = "granite-moe-3b-a800m"
LM_SERVE_ENGINE = dict(max_batch=8, s_max=512, n_pages=32)
LM_PROMPT, LM_MAX_NEW, LM_HOT = 264, 8, (True, True)
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 2, 1024
LM_WARMUP_STEPS, LM_TIMED_STEPS = 2, 5
LM_FALL_STEPS, LM_FALL_LR = 6, 1e-3  # constant_lr on one fixed batch
# deepseek-v3-671b reduced (its 671 B parameters need the parallel layer)
MLA_ARCH, MLA_BATCH, MLA_SEQ, MLA_DECODE_STEPS = "deepseek-v3-671b", 2, 64, 8
# EmbedElim on qwen2-0.5b's embedding table, ids from the training stream
EMBED_ARCH, EMBED_BATCH, EMBED_SEQ, EMBED_LR = "qwen2-0.5b", 8, 1024, 1e-2
# DedupIndex: batches of documents from the seeded stream; the first batch
# goes into an empty tree, where the retry passes grow with the round's
# width (about one a 6 lanes), so it is narrow, as the tree path's prefill
DEDUP_BATCHES, DEDUP_WIDTH, DEDUP_FIRST_WIDTH, DEDUP_CAPACITY = 48, 4096, 512, 1 << 16
DEDUP_HISTORY_FRAC, DEDUP_INBATCH_FRAC, DEDUP_ZIPF = 0.30, 0.05, 1.1
DEDUP_MIN_TOKENS, DEDUP_MAX_TOKENS = 64, 512
QUANT_N, EF_N, EF_STEPS = 1 << 26, 1 << 20, 50
# ssm / hybrid / audio phase: xlstm-350m, zamba2-1.2b and whisper-tiny at
# their published widths and depths, fp32 weights from the seed, bf16
# compute.  Served: FAMILY_REQUESTS requests of FAMILY_PROMPT tokens (a cut:
# the engine prefills token by token), FAMILY_MAX_NEW new each, serially
# (zamba2 also pipelined); trained by the launcher's Trainer at
# FAMILY_TRAIN's (batch, seq); xlstm one loss and gradient step at
# XLSTM_GRAD_SHAPE (its step-by-step mLSTM keeps every step's (B, 4, 256,
# 256) f32 memory for the backward pass)
FAMILY_ARCHS = ("xlstm-350m", "zamba2-1.2b", "whisper-tiny")
FAMILY_ENGINE = dict(max_batch=8, s_max=512, n_pages=32)
FAMILY_S_MAX = {"whisper-tiny": 448}  # whisper's decoder context
FAMILY_REQUESTS, FAMILY_PROMPT, FAMILY_MAX_NEW = 2, 64, 8  # cut from 4 for the script's time
FAMILY_PIPELINED = ("zamba2-1.2b",)
FAMILY_TRAIN = {"zamba2-1.2b": (2, 1024), "whisper-tiny": (8, 448)}
XLSTM_GRAD_SHAPE, XLSTM_CHUNK = (1, 256), 64
CHUNKED_TOL = 1e-5  # atol and rtol of the chunked mLSTM against the step-by-step form
# card against CPU: a 2-layer model at full width in f32 (TF32 off), the
# same params on both, forward_train and FAMILY_CHECK_STEPS decode steps;
# xlstm with an sLSTM every 2 blocks and zamba2 with its shared block after
# 2 mamba layers, so that the 2 layers hold every kind of block
FAMILY_CHECK = dict(layers=2, batch=2, seq=256, steps=3)
FAMILY_CHECK_OVERRIDES = {"xlstm-350m": dict(slstm_every=2),
                          "zamba2-1.2b": dict(shared_attn_every=2),
                          "whisper-tiny": dict(enc_layers=2)}
CARD_CPU_TOL = 1e-4  # atol and rtol: f32 sums in another order (the CPU tests' logit limit)
PARALLEL_ARCH = "qwen2-0.5b"
PARALLEL_BATCH, PARALLEL_SEQ, PARALLEL_STEPS = 8, 1024, 2
PARALLEL_DECODE_STEPS = 4  # serve steps at positions 0..3, each held to forward_decode's
PARALLEL_PIPE = dict(m=4, b=8)  # one-stage pipeline: microbatches of qwen2's width
PARALLEL_MOE_ARCH, PARALLEL_MOE_TOKENS = "granite-moe-3b-a800m", (2, 1024)
DRYRUN_CELL = ("deepseek-v3-671b", "decode_32k", "multi", "opt")
DRYRUN_FALLBACK = ("qwen2-0.5b", "decode_32k", "multi", "baseline")
DRYRUN_TIMEOUT_S = 60
CORRECTION_TIMEOUT_S = 90  # three probes at 1-3 layers, each traced from cold caches
CORRECTION_TOL = 0  # the counts are bit-equal across processes (PERF.md §6): exact
# the examples (examples/*_torch.py) on the card and what each must print: the
# JAX examples' integers on the CPU (tests/test_torch_examples.py holds them equal)
EXAMPLE_LINES = {
    "quickstart": ["find(42) → 4200", "64 ops on one key → physical slot writes: 0, eliminated: 64",
                   "recovered contents: {1: 10, 2: 20, 3: 30}"],
    "durable_store": ["recovered (crashed round absent): {1: 10, 2: 20, 3: 30, 4: 40}",
                      "p-elim: commits=5 fsyncs=15 flush_bytes=169801",
                      "p-occ: commits=51 fsyncs=143 flush_bytes=175885"],
}
EXAMPLE_SERVE = {"/slot_writes": 8, "/searches": 128, "/rounds": 16, "/eliminated": 0,
                 "/cache_hit_blocks": 8, "/metrics/counters/admitted": 12,
                 "/metrics/counters/decode_tokens": 48, "/session_scans": 3}
EXAMPLE_TRAIN = ["--steps", "10"]
EXAMPLE_FAIL_AT = 6  # checkpoints every 5 steps: the resume starts at step 5
EXAMPLE_KERNELS = ("descend_probe", "elim_combine", "flash_attention", "decode_attention")
EXAMPLE_TIMEOUT_S = 240
# the bare-state forms on the tree path's tree after its timed rounds:
# frontier_expand of FRONTIER_CHECK[0] intervals [lo, lo + U[1, FRONTIER_CHECK[1]])
# at cap FRONTIER_CHECK[2] on the card and on a CPU copy, and descend + probe
# of the same lanes' keys against K1
FRONTIER_CHECK = (1_024, 64, 8)
# prefill_tree of an ABTree(PAPER): half of this key range in 1,024-lane rounds
PREFILL_TREE_RANGE = 20_000
# the one-stage pipeline's gradients against the stage's own: f32 products
# summed a microbatch at a time against one batched product
PIPE_GRAD_TOL = 1e-5


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


# ----------------------------------------------------------------------------
# main path
# ----------------------------------------------------------------------------


def mixed_round(rng, batch: int, key_range: int, zipf_keys, ops_mod, uniform: bool = False):
    """One round of the skewed update-heavy mix (ycsb_e_stream's encoding
    for range lanes: key = lo, val = span); ``uniform`` draws the keys
    uniformly instead of from Zipf(1.0)."""
    keys = (rng.integers(0, key_range, batch).astype(np.int64) if uniform
            else zipf_keys(rng, batch, key_range, 1.0))
    u = rng.random(batch)
    ops = np.select(
        [u < 0.45, u < 0.90, u < 0.95],
        [ops_mod.OP_INSERT, ops_mod.OP_DELETE, ops_mod.OP_FIND],
        ops_mod.OP_RANGE,
    ).astype(np.int32)
    spans = rng.integers(1, 65, batch).astype(np.int64)
    vals = np.where(ops == ops_mod.OP_RANGE, spans, rng.integers(0, 1 << 40, batch)).astype(np.int64)
    return ops, keys, vals


def check_round(out, want, ops, range_code, round_name: str) -> None:
    """Lane-for-lane comparison of one round with the oracle's answer."""
    res, fnd, scans = want
    got_res = out.results.numpy()
    got_fnd = out.found.numpy()
    if not np.array_equal(got_res, np.asarray(res, np.int64)):
        bad = int(np.nonzero(got_res != np.asarray(res, np.int64))[0][0])
        raise AssertionError(f"{round_name}: lane {bad} result {got_res[bad]} != oracle {res[bad]}")
    if not np.array_equal(got_fnd, np.asarray(fnd, bool)):
        raise AssertionError(f"{round_name}: found flags differ from the oracle")
    rl = np.nonzero(ops == range_code)[0]
    if rl.size:
        cnt = out.scan.count.numpy()
        sk = out.scan.keys.numpy()
        sv = out.scan.vals.numpy()
        for i in rl.tolist():
            n = int(cnt[i])
            got = list(zip(sk[i, :n].tolist(), sv[i, :n].tolist()))
            if got != scans[i]:
                raise AssertionError(f"{round_name}: range lane {i} rows differ from the oracle")


def prefill_starts(n_keys: int) -> list:
    """The first lane of each prefill round."""
    return [0] + list(range(PREFILL_FIRST_BATCH, n_keys, PREFILL_BATCH))


def prefill(tree, oracle, core, rng, n_keys: int, key_range: int, name: str) -> float:
    """Insert ``n_keys`` distinct keys of [0, key_range) in oracle-checked
    rounds: a first one of PREFILL_FIRST_BATCH lanes into the empty tree,
    then rounds of PREFILL_BATCH.  Returns the seconds it took."""
    keys = rng.choice(key_range, size=n_keys, replace=False).astype(np.int64)
    t0 = time.perf_counter()
    starts = prefill_starts(n_keys)
    for i, j in zip(starts, starts[1:] + [n_keys]):
        chunk = keys[i:j]
        ops = np.full(chunk.size, core.OP_INSERT, np.int32)
        vals = rng.integers(0, 1 << 40, chunk.size).astype(np.int64)
        out = tree.apply_round(ops, chunk, vals)
        check_round(out, oracle.apply_mixed_round(ops, chunk, vals), ops, core.OP_RANGE,
                    f"{name} prefill {i}")
        log(f"{name} prefill {i + chunk.size}/{n_keys}: {time.perf_counter() - t0:.1f}s, "
            f"{int(getattr(tree, 'tree', tree).stacked.alloc.sum())} nodes")
    return time.perf_counter() - t0


def run_main_path(torch, core, lib, zipf_keys):
    """Prefill + mixed rounds on the card, oracle-checked.  Returns the
    run's summary, the launch arguments each kernel got in the last round,
    the tree and its oracle (the occ phase starts from them), and the
    history the obs phase replays: the flight recorder of every round from
    the empty tree up to the recorder-off rounds, what those rounds issued
    (rounds, non-NOP lanes), the tree's eliminated count over them, the
    oracle's contents after them, and the first traced rounds' tracer."""
    from repro_torch.configs.abtree import PAPER
    from repro_torch.core.oracle import check_invariants
    from repro_torch.obs.recorder import Recorder
    from repro_torch.obs.tracer import NULL_TRACER, Tracer

    dev = torch.device("cuda")
    cfg = PAPER
    rng = np.random.default_rng(SEED)
    tree = core.ABTree(cfg, mode="elim")
    oracle = core.DictOracle()
    torch.cuda.reset_peak_memory_stats(dev)
    lib.reset_counts()

    n_prefill = KEY_RANGE // 2
    eliminated0 = tree.stats()["eliminated"]
    prefill_s = prefill(tree, oracle, core, rng, n_prefill, KEY_RANGE, "tree")
    issued = {"rounds": len(prefill_starts(n_prefill)), "lanes": n_prefill}

    m = tree.metrics
    counters = {n: lib.COUNTERS[n] for n in TREE_KERNELS}
    recorded = {}

    def drive(n_rounds, name, record_last=False):
        """``n_rounds`` oracle-checked mixed rounds; per-round wall ms and
        structural work."""
        ms, work = [], []
        for r in range(n_rounds):
            ops, keys, vals = mixed_round(rng, BATCH, KEY_RANGE, zipf_keys, core)
            last = record_last and r == n_rounds - 1
            if last:  # record the launch arguments for the replay
                for c in counters.values():
                    c.calls = []
            before = (m.value("retry_passes"), m.value("split_waves"), m.value("underfull_waves"))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = tree.apply_round(ops, keys, vals, scan_cap=128)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            issued["rounds"] += 1
            issued["lanes"] += int((ops != core.OP_NOP).sum())
            if last:
                for cname, c in counters.items():
                    recorded[cname], c.calls = c.calls, None
            after = (m.value("retry_passes"), m.value("split_waves"), m.value("underfull_waves"))
            work.append([x - y for x, y in zip(after, before)])
            tree.tracer.counter("retry_passes", work[-1][0])  # a counter track when traced
            want = oracle.apply_mixed_round(ops, keys, vals, cap=128)
            check_round(out, want, ops, core.OP_RANGE, f"{name} round {r}")
        return ms, np.asarray(work, np.float64)

    def traced_breakdown(name):
        """Per-round span totals over TRACED_ROUNDS rounds with the phase
        tracer on (it fences every span, so these rounds are not timed),
        the tracer, and each round's retry passes (its counter track)."""
        tracer = tree.tracer = Tracer()
        _, work = drive(TRACED_ROUNDS, name)
        phase = {}
        for ev in tracer.events:
            if ev["ph"] == "X":
                phase[ev["name"]] = phase.get(ev["name"], 0.0) + ev["dur"] / 1e3 / TRACED_ROUNDS
        tree.tracer = NULL_TRACER
        return phase, tracer, work[:, 0].tolist()

    drive(WARMUP, "warm-up")
    round_ms, work = drive(ROUNDS, "measured", record_last=True)
    traced_on, tracer, traced_retries = traced_breakdown("traced")
    history = {"recorder": tree.recorder, **issued,
               "eliminated": tree.stats()["eliminated"] - eliminated0, "state": oracle.items(),
               "tracer": tracer, "traced_ms_per_round": traced_on,
               "traced_retry_passes": traced_retries, "scan_frontier": tree._scan_frontier}
    # the flight recorder is on by default (as in the JAX engine); the same
    # traffic with it off shows what it costs per round.
    tree.recorder = Recorder(enabled=False)
    round_ms_off, _ = drive(RECORDER_OFF_ROUNDS, "recorder-off")
    traced_off, _, _ = traced_breakdown("traced recorder-off")
    launches = {n: c.launches for n, c in counters.items()}
    large_scan, recorded["large_cap_scan"] = large_cap_scan(torch, tree, oracle, counters)
    log(f"scan_round cap {LARGE_SCAN_CAP}: {large_scan['wall_ms']:.1f} ms, "
        f"{large_scan['count']} keys, launches {large_scan['launches']}")
    bare_forms = bare_state_forms(torch, lib, tree)
    prefilled = prefill_tree_check(torch, core, lib)

    st = tree.state
    check_invariants(st, tree.cfg)
    if tree.items() != oracle.items():
        raise AssertionError("tree contents differ from the oracle after the run")
    stats = tree.stats()
    summary = {
        "config": {"b": cfg.b, "a": cfg.a, "max_height": cfg.max_height,
                   "key_range": KEY_RANGE, "prefill_keys": n_prefill,
                   "prefill_batch": PREFILL_BATCH, "prefill_first_batch": PREFILL_FIRST_BATCH,
                   "batch": BATCH,
                   "warmup": WARMUP, "rounds": ROUNDS, "scan_cap": 128,
                   "mix": "45% insert, 45% delete, 5% find, 5% range span U[1,64], Zipf(1.0)"},
        "prefill_s": prefill_s,
        "ops_per_s": BATCH * len(round_ms) / (sum(round_ms) / 1e3),
        "round_ms_p50": float(np.percentile(round_ms, 50)),
        "round_ms_p99": float(np.percentile(round_ms, 99)),
        "round_ms": round_ms,
        "retry_passes_per_round": float(work[:, 0].mean()),
        "split_waves_per_round": float(work[:, 1].mean()),
        "underfull_waves_per_round": float(work[:, 2].mean()),
        "round_ms_p50_recorder_off": float(np.percentile(round_ms_off, 50)),
        "round_ms_recorder_off": round_ms_off,
        "height": int(st.height),
        "live_nodes": int(st.alloc.sum()),
        "pool_rows": int(st.alloc.shape[0]),
        "live_keys": len(oracle.d),
        "eliminated": stats["eliminated"],
        "max_memory_allocated": int(torch.cuda.max_memory_allocated(dev)),
        "launches": launches,
        "traced_rounds": TRACED_ROUNDS,
        "traced_ms_per_round": traced_on,
        "traced_ms_per_round_recorder_off": traced_off,
        "large_cap_scan": large_scan,
        "bare_state_forms": bare_forms,
        "prefill_tree": prefilled,
    }
    return summary, recorded, tree, oracle, history


def bare_state_forms(torch, lib, tree) -> dict:
    """``core.abtree.frontier_expand`` over the tree's bare state on the card
    (K2 once a level: it must launch) against the same call on a CPU copy of
    the state, all five outputs equal; ``descend`` + ``probe`` of the same
    lanes' keys on the card equal to K1's leaf, found, slot and value."""
    from repro_torch.core import abtree
    from repro_torch.kernels.tree_descend.ops import descend_probe

    t0 = time.perf_counter()
    n, span, cap = FRONTIER_CHECK
    rng = np.random.default_rng(SEED + 11)
    lo = rng.integers(0, KEY_RANGE, n).astype(np.int64)
    hi = lo + rng.integers(1, span + 1, n)
    st, cfg = tree.state, tree.cfg
    k1, k2 = lib.counter("descend_probe"), lib.counter("frontier_compact")
    lo_d, hi_d = (torch.as_tensor(a, device=st.keys.device) for a in (lo, hi))
    k2_0 = k2.launches
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = abtree.frontier_expand(st, cfg, lo_d, hi_d, cap)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t1) * 1e3
    k2_launches = k2.launches - k2_0
    if k2_launches != cfg.max_height:
        raise AssertionError(f"frontier_expand on the card launched K2 {k2_launches} times, "
                             f"not once a level ({cfg.max_height})")
    cpu = abtree.TreeState(*(x.cpu() for x in st[:-1]),
                           stats=abtree.TreeStats(*(x.cpu() for x in st.stats)))
    want = abtree.frontier_expand(cpu, cfg, torch.as_tensor(lo), torch.as_tensor(hi), cap)
    names = ("leaves", "cand_keys", "cand_vals", "touched", "overflow")
    bad = [nm for g, w, nm in zip(got, want, names) if not torch.equal(g.cpu(), w)]
    if bad:
        raise AssertionError(f"frontier_expand on the card differs from the CPU's in {bad}")
    leaf = abtree.descend(st, lo_d, cfg)
    found, slot, val = abtree.probe(st, leaf, lo_d)
    s = tree.stacked
    k1_0 = k1.launches
    fused = descend_probe(s.keys, s.vals, s.children, s.is_leaf, s.root, lo_d[None],
                          max_height=cfg.max_height, notfound=int(abtree.NOTFOUND))
    bad = [nm for g, w, nm in zip((leaf, found, slot, val), fused, ("leaf", "found", "slot", "val"))
           if not torch.equal(g, w[0])]
    if bad or k1.launches - k1_0 != 1:
        raise AssertionError(f"descend + probe differ from K1 in {bad} "
                             f"(K1 launched {k1.launches - k1_0} times)")
    out = {"queries": n, "span": f"U[1,{span}]", "cap": cap, "card_ms": card_ms,
           "k2_launches": k2_launches, "overflow_lanes": int(want[4].sum()),
           "valid_leaves": int((want[0] != st.keys.shape[0] - 1).sum()),
           "found": int(found.sum()), "equal": True}
    out["seconds"] = time.perf_counter() - t0
    log(f"bare-state forms: {out}")
    return out


def prefill_tree_check(torch, core, lib) -> dict:
    """``data.workloads.prefill_tree`` of a fresh ``ABTree(PAPER)`` at
    ``WorkloadConfig(key_range=PREFILL_TREE_RANGE)``: every round checked
    lane for lane against ``DictOracle`` as it runs, the items equal to the
    oracle's and the tree sound at the end."""
    from repro_torch.configs.abtree import PAPER
    from repro_torch.core.oracle import check_invariants
    from repro_torch.data.workloads import WorkloadConfig, prefill_tree

    tree, oracle = core.ABTree(PAPER), core.DictOracle()
    rounds = []

    class Checked:
        def apply_round(self, ops, keys, vals):
            out = tree.apply_round(ops, keys, vals)
            check_round(out, oracle.apply_mixed_round(ops, keys, vals), ops, core.OP_RANGE,
                        f"prefill_tree round {len(rounds)}")
            rounds.append(int(keys.size))
            return out

    before = launch_counts(lib)
    t0 = time.perf_counter()
    prefill_tree(Checked(), WorkloadConfig(key_range=PREFILL_TREE_RANGE))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_invariants(tree.state, tree.cfg)
    items = tree.items()
    if items != oracle.items() or len(items) != PREFILL_TREE_RANGE // 2:
        raise AssertionError(f"prefill_tree: {len(items)} items, the oracle's differ or are not "
                             f"{PREFILL_TREE_RANGE // 2}")
    out = {"key_range": PREFILL_TREE_RANGE, "keys": len(items), "rounds": rounds,
           "seconds": seconds, "retry_passes": tree.metrics.value("retry_passes"),
           "height": int(tree.state.height),
           "launches": {k: v - before[k] for k, v in launch_counts(lib).items()}}
    log(f"prefill_tree: {out}")
    return out


def large_cap_scan(torch, tree, oracle, counters):
    """One ``scan_round`` on the card at ``LARGE_SCAN_CAP`` over an interval
    holding more of the tree's live keys than that, checked against
    ``DictOracle.range``; its wall time and the launches it made, and the
    launch arguments of its K2 and K4 calls (for ``kernel_report``)."""
    lo, hi = LARGE_SCAN_LO, LARGE_SCAN_LO + LARGE_SCAN_SPAN
    want = oracle.range(lo, hi)
    if len(want) <= LARGE_SCAN_CAP:
        raise AssertionError(f"[{lo}, {hi}) holds {len(want)} keys, not more than {LARGE_SCAN_CAP}")
    scan_kernels = ("frontier_compact", "range_scan")
    before = {n: c.launches for n, c in counters.items()}
    for k in scan_kernels:
        counters[k].calls = []
    frontier = tree._scan_frontier
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tree.scan_round([lo], [hi], cap=LARGE_SCAN_CAP)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    calls = {}
    for k in scan_kernels:
        calls[k], counters[k].calls = counters[k].calls, None
    n = int(out.count[0])
    got = list(zip(out.keys[0, :n].tolist(), out.vals[0, :n].tolist()))
    if n != LARGE_SCAN_CAP or not bool(out.truncated[0]) or got != want[:LARGE_SCAN_CAP]:
        raise AssertionError(f"scan_round cap {LARGE_SCAN_CAP} over [{lo}, {hi}): count {n}, "
                             f"truncated {bool(out.truncated[0])}, rows differ from the oracle's "
                             f"{len(want)}")
    return {"lo": lo, "hi": hi, "cap": LARGE_SCAN_CAP, "live_keys": len(want), "count": n,
            "truncated": True, "wall_ms": wall_ms, "frontier_before": frontier,
            "frontier_after": tree._scan_frontier,
            "calls": {k: len(calls[k]) for k in scan_kernels},
            "launches": {k: counters[k].launches - before[k] for k in scan_kernels}}, calls


# ----------------------------------------------------------------------------
# occ phase, forest phase, sharded indexes
# ----------------------------------------------------------------------------


def launch_counts(lib) -> dict:
    return {n: lib.counter(n).launches for n in TREE_KERNELS}


def timed_rounds(torch, lib, tree, oracle, core, zipf_keys, rng, n_rounds, name, *,
                 uniform=False, each=None):
    """``n_rounds`` oracle-checked mixed rounds of BATCH lanes on ``tree``
    (an ABTree or ABForest, either mode): per round its wall ms, the
    sub-rounds it ran (occ) and the K1 / K3 launches it made.  ``each(r)``
    runs before round r."""
    k1, k3 = lib.counter("descend_probe"), lib.counter("elim_combine")
    rows = []
    for r in range(n_rounds):
        if each is not None:
            each(r)
        ops, keys, vals = mixed_round(rng, BATCH, KEY_RANGE, zipf_keys, core, uniform=uniform)
        sub0, k1_0, k3_0 = tree.stats()["subrounds"], k1.launches, k3.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tree.apply_round(ops, keys, vals, scan_cap=128)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_round(out, oracle.apply_mixed_round(ops, keys, vals, cap=128), ops, core.OP_RANGE,
                    f"{name} round {r}")
        rows.append({"ms": ms, "subrounds": tree.stats()["subrounds"] - sub0,
                     "k1": k1.launches - k1_0, "k3": k3.launches - k3_0,
                     "shards": tree.n_shards})
    return rows


class FirstCall(list):
    """A launch counter's ``calls`` that keeps only the first launch (a long
    list would hold every launch's pool tensors alive)."""

    def append(self, args):
        if not self:
            super().append(args)


def round_summary(rows) -> dict:
    ms = [r["ms"] for r in rows]
    sub = [r["subrounds"] for r in rows]
    return {"rounds": len(rows), "ops_per_s": BATCH * len(ms) / (sum(ms) / 1e3),
            "round_ms_p50": float(np.percentile(ms, 50)), "round_ms": ms,
            "subrounds_per_round": float(np.mean(sub)), "subrounds": sub,
            "ms_per_subround": sum(ms) / max(1, sum(sub)),
            "k1_per_round": float(np.mean([r["k1"] for r in rows])),
            "k3_per_round": float(np.mean([r["k3"] for r in rows]))}


def copy_tree(core, tree, oracle, mode: str):
    """A new ``ABTree(mode=mode)`` holding a copy of ``tree``'s state, and a
    copy of its oracle."""
    st = tree.stacked
    out = core.ABTree(tree.cfg, mode=mode)
    out.stacked = core.TreeState(*(x.clone() for x in st[:-1]),
                                 stats=type(st.stats)(*(x.clone() for x in st.stats)))
    out_oracle = core.DictOracle()
    out_oracle.d = dict(oracle.d)
    return out, out_oracle


def run_occ_path(torch, core, lib, zipf_keys, tree, oracle):
    """occ mode at full width: the tree path's final tree and a copy of its
    oracle in ``ABTree(mode="occ")``, OCC_WARMUP + OCC_ROUNDS Zipf(1.0)
    rounds, then UNIFORM_ROUNDS uniform rounds, every round checked lane
    for lane; ``check_invariants`` at the end.  The launch counts are zeroed
    before the occ rounds and read after them.  Then UNIFORM_ROUNDS uniform
    rounds through the elim tree, for the two modes side by side."""
    from repro_torch.core.oracle import check_invariants

    occ, occ_oracle = copy_tree(core, tree, oracle, "occ")
    rng = np.random.default_rng(SEED + 1)
    lib.reset_counts()
    t0 = time.perf_counter()
    warm = timed_rounds(torch, lib, occ, occ_oracle, core, zipf_keys, rng, OCC_WARMUP,
                        "occ warm-up")
    zipf = timed_rounds(torch, lib, occ, occ_oracle, core, zipf_keys, rng, OCC_ROUNDS, "occ zipf")
    uni = timed_rounds(torch, lib, occ, occ_oracle, core, zipf_keys, rng, UNIFORM_ROUNDS,
                       "occ uniform", uniform=True)
    launches = launch_counts(lib)
    occ_s = time.perf_counter() - t0
    log(f"occ phase: {occ_s:.1f}s, sub-rounds {[r['subrounds'] for r in warm + zipf + uni]}")
    check_invariants(occ.state, occ.cfg)
    if occ.items() != occ_oracle.items():
        raise AssertionError("occ tree contents differ from the oracle")
    # the elim tree on uniform traffic (its Zipf rounds are the tree path's),
    # from the same state as the occ tree, in a fresh ABTree as the occ one is
    elim, elim_oracle = copy_tree(core, tree, oracle, "elim")
    elim_uni = timed_rounds(torch, lib, elim, elim_oracle, core, zipf_keys,
                            np.random.default_rng(SEED + 2), UNIFORM_ROUNDS, "elim uniform",
                            uniform=True)
    check_invariants(elim.state, elim.cfg)
    if elim.items() != elim_oracle.items():
        raise AssertionError("elim tree contents differ from the oracle after the uniform rounds")
    return {"config": {"from": "the tree path's final tree", "batch": BATCH,
                       "warmup": OCC_WARMUP, "zipf_rounds": OCC_ROUNDS,
                       "uniform_rounds": UNIFORM_ROUNDS},
            "seconds": occ_s, "warmup": round_summary(warm), "occ_zipf": round_summary(zipf),
            "occ_uniform": round_summary(uni), "elim_uniform": round_summary(elim_uni),
            "stats": occ.stats(), "launches": launches}


class ActionTracer:
    """A forest tracer that records only the forest's own ``repartition``,
    ``shard_sweep`` and ``shard_reinsert`` spans; every other span, mark and
    instant is the no-op tracer's, so the rounds around them run unfenced
    and are timed as usual."""

    NAMES = ("repartition", "shard_sweep", "shard_reinsert")

    def __init__(self):
        from repro_torch.obs.tracer import NULL_TRACER, Tracer

        self._null, self._tracer = NULL_TRACER, Tracer()

    def span(self, name: str, **kw):
        return (self._tracer if name in self.NAMES else self._null).span(name, **kw)

    def __getattr__(self, name):
        return getattr(self._null, name)

    def actions(self):
        """(actions, sweeps, re-inserts): each span's notes and seconds."""
        out = {n: [] for n in self.NAMES}
        for ev in self._tracer.events:
            out[ev["name"]].append({**ev["args"], "seconds": ev["dur"] / 1e6})
        return tuple(out[n] for n in self.NAMES)


def forest_run(torch, core, lib, zipf_keys, *, auto: bool, n_prefill: int, record=None):
    """One forest at the tree path's configuration and traffic on the one
    card: ``ABForest(n_shards=FOREST_SHARDS, PAPER, key_space=(0,
    KEY_RANGE), auto_repartition=auto)``, ``n_prefill`` keys prefilled as
    the tree path prefills, then FOREST_WARMUP + FOREST_ROUNDS mixed
    rounds, each checked against the oracle, and ``check_forest_invariants``
    and the contents at the end.  Each repartition action is timed, with
    its sweeps and re-insertions, from the forest's own tracer spans.  With
    ``record`` (a dict), the first K1 and K3 launch of the first measured
    round go into it."""
    from repro_torch.configs.abtree import PAPER
    from repro_torch.core import ABForest, check_forest_invariants

    forest = ABForest(n_shards=FOREST_SHARDS, cfg=PAPER,
                      key_space=(0, KEY_RANGE), auto_repartition=auto)
    oracle = core.DictOracle()
    rng = np.random.default_rng(SEED + 3)
    name = "forest" if auto else "static forest"
    forest.tracer = ActionTracer()
    prefill_s = prefill(forest, oracle, core, rng, n_prefill, KEY_RANGE, name)
    counters = {n: lib.counter(n) for n in ("descend_probe", "elim_combine")}

    def record_first(r):
        """Keep the first K1 and K3 launch of round 0 (its search phase)."""
        if r == 0:
            for c in counters.values():
                c.calls = FirstCall()
        elif r == 1:
            for n, c in counters.items():
                record[n], c.calls = c.calls[0], None

    t0 = time.perf_counter()
    warm = timed_rounds(torch, lib, forest, oracle, core, zipf_keys, rng, FOREST_WARMUP,
                        f"{name} warm-up")
    rounds = timed_rounds(torch, lib, forest, oracle, core, zipf_keys, rng, FOREST_ROUNDS,
                          f"{name} measured", each=None if record is None else record_first)
    rounds_s = time.perf_counter() - t0
    actions, sweeps, reinserts = forest.tracer.actions()
    for a in actions:
        log(f"{name} repartition: {a}")
    check_forest_invariants(forest)
    if forest.items() != oracle.items():
        raise AssertionError(f"{name}: contents differ from the oracle")
    log(f"{name}: prefill {prefill_s:.1f}s, rounds {rounds_s:.1f}s, "
        f"{len(actions)} repartition actions, S = {forest.n_shards}")
    summary = {"config": {"n_shards": FOREST_SHARDS, **PAPER._asdict(), "key_space": [0, KEY_RANGE],
                          "auto_repartition": auto, "prefill_keys": n_prefill, "batch": BATCH,
                          "warmup": FOREST_WARMUP, "rounds": FOREST_ROUNDS},
               "prefill_s": prefill_s, "rounds_s": rounds_s, "warmup": round_summary(warm),
               "measured": round_summary(rounds), "actions": actions, "sweeps": sweeps,
               "reinserts": reinserts, "sweep_s": sum(x["seconds"] for x in sweeps),
               "reinsert_s": sum(x["seconds"] for x in reinserts),
               "n_shards": forest.n_shards, "splits": forest.splits.tolist(),
               "stats_per_shard": forest.stats_per_shard(), "stats": forest.stats(),
               "counters": {n: forest.metrics.value(n) for n in (
                   "hot_shard_events", "repartitions", "boundary_moves", "shard_merges",
                   "shard_splits")},
               "live_keys": len(oracle.d)}
    return summary, forest, oracle


def run_forest_path(torch, core, lib, zipf_keys):
    """The forest phase: ``forest_run`` with ``auto_repartition=True`` at
    FOREST_PREFILL keys (the load-aware repartitioner at work on the card),
    then with the static partition at the tree path's 10^6 keys, whose
    shards all stay (FOREST_SHARDS of them through every round): its first
    measured K1 and K3 calls are recorded for the replays, and one
    ``scan_stream`` of cap FOREST_STREAM_CAP over FOREST_STREAM_HALF keys
    either side of its first split point, which chains shard cursors, must
    equal ``DictOracle.range``.  The launch counts are zeroed before the
    first run and read after the scan.  Returns the summary, the recorded
    calls, and the static forest and its oracle (the obs phase traces two
    more of its rounds)."""
    lib.reset_counts()
    auto, _, _ = forest_run(torch, core, lib, zipf_keys, auto=True, n_prefill=FOREST_PREFILL)
    recorded = {}
    static, forest, oracle = forest_run(torch, core, lib, zipf_keys, auto=False,
                                        n_prefill=KEY_RANGE // 2, record=recorded)
    if forest.n_shards != FOREST_SHARDS or recorded["descend_probe"][5].shape[0] != FOREST_SHARDS:
        raise AssertionError(f"static forest: S = {forest.n_shards} at the end")
    mid = int(forest.splits[0])
    lo, hi = mid - FOREST_STREAM_HALF, mid + FOREST_STREAM_HALF
    pages, t0 = forest.stats()["scans"], time.perf_counter()
    got = list(forest.scan_stream(lo, hi, cap=FOREST_STREAM_CAP))
    static["scan_stream"] = {"lo": lo, "hi": hi, "cap": FOREST_STREAM_CAP, "pairs": len(got),
                             "pages": forest.stats()["scans"] - pages,
                             "wall_ms": (time.perf_counter() - t0) * 1e3}
    if got != oracle.range(lo, hi):
        raise AssertionError(f"forest scan_stream over [{lo}, {hi}) differs from the oracle")
    return ({"auto_repartition": auto, "static": static, "launches": launch_counts(lib)}, recorded,
            forest, oracle)


def index_knobs(durable_dir=None) -> dict:
    """The two indexes' constructor knobs, as ``ServeEngine(index_shards=
    INDEX_SHARDS)`` builds them; with ``durable_dir``, journaled below it
    in groups of DURABLE_INDEX_GROUP rounds committed on the background
    thread."""
    n_pages = SERVE_ENGINE["n_pages"]
    knobs = {"index": dict(shards=INDEX_SHARDS),
             "sessions": dict(shards=INDEX_SHARDS, key_space=(0, 1 << 31),
                              max_keys_per_shard=max(64, n_pages // INDEX_SHARDS))}
    if durable_dir is not None:
        for name, kw in knobs.items():
            kw.update(durable_dir=str(Path(durable_dir) / name),
                      group_commit_every=DURABLE_INDEX_GROUP, commit_async=True)
    return knobs


def run_index_path(torch, core, lib, durable_dir=None):
    """The serving indexes sharded four ways, driven without a model:
    ``PrefixIndex(shards=INDEX_SHARDS)`` and ``SessionIndex(shards=
    INDEX_SHARDS)`` as ``ServeEngine(index_shards=INDEX_SHARDS)`` builds
    them (journaled under ``durable_dir`` when it is given), through
    INDEX_STEPS steps of publish / lookup / evict calls (hot prefixes
    re-published and evicted, session ids allocated in order and swept in
    ranges), every call checked against a ``DictOracle`` (``IndexAudit``)
    and both indexes against the oracles at the end.  The launch counts are
    zeroed before the steps of volatile indexes only (the durable phase
    counts its own).  Returns the summary, the indexes and the audit."""
    from types import SimpleNamespace

    from repro_torch.serve.pages import PrefixIndex, SessionIndex, _hash_chain

    n_pages = SERVE_ENGINE["n_pages"]
    knobs = index_knobs(durable_dir)
    idx = SimpleNamespace(index=PrefixIndex(**knobs["index"]),
                          sessions=SessionIndex(**knobs["sessions"]))
    audit = IndexAudit(idx, core)
    rng = np.random.default_rng(SEED + 4)
    hashes = [_hash_chain(i, (i,)) for i in range(256)]
    if durable_dir is None:
        lib.reset_counts()
    t0 = time.perf_counter()
    rid, floor = 0, 0
    for step in range(INDEX_STEPS):
        pick = (rng.zipf(1.3, 8) % 256).tolist()
        idx.index.publish_batch([hashes[i] for i in pick], [step * 8 + j for j in range(8)])
        idx.index.lookup_batch([hashes[i] for i in (rng.zipf(1.3, 8) % 256).tolist()])
        idx.index.evict_batch([hashes[i] for i in pick[:3]])
        idx.sessions.publish_batch(list(range(rid, rid + 4)), [10 * r for r in range(rid, rid + 4)])
        idx.sessions.lookup_batch(rng.integers(max(0, rid - 16), rid + 4, 4).tolist())
        rid += 4
        if step % 10 == 9:  # sweep all but the newest sessions
            idx.sessions.evict_range(floor, rid - 8)
            floor = rid - 8
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    audit.check(idx)
    return {"config": {"shards": INDEX_SHARDS, "steps": INDEX_STEPS,
                       "session_max_keys_per_shard": max(64, n_pages // INDEX_SHARDS)},
            "wall_s": wall, "calls": dict(audit.calls), "index_s_by_call": dict(audit.seconds_by),
            "prefix_shards": idx.index.tree.n_shards, "session_shards": idx.sessions.tree.n_shards,
            "session_splits": _forest(idx.sessions.tree).splits.tolist(),
            "launches": launch_counts(lib)}, idx, audit


# ----------------------------------------------------------------------------
# durable phase
# ----------------------------------------------------------------------------


def mount_of(path) -> dict:
    """The filesystem that holds ``path``: its type, device and mount point
    (the longest mount point of ``/proc/self/mounts`` above it)."""
    real = str(Path(path).resolve())
    best = {"fstype": "unknown", "device": "unknown", "mount": ""}
    with open("/proc/self/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best["mount"]):
                best = {"fstype": fstype, "device": dev, "mount": mnt}
    return best


def journal_dir():
    """A fresh directory for the durable phase's journals on a disk-backed
    filesystem: under the checkout's ``build/``, else the temporary
    directory, whichever is not tmpfs first (if both are, the checkout's,
    marked so: fsync is then free)."""
    import tempfile

    candidates = [ROOT / "build", Path(tempfile.gettempdir())]
    for parent in candidates:
        parent.mkdir(parents=True, exist_ok=True)
        if mount_of(parent)["fstype"] not in ("tmpfs", "ramfs"):
            break
    else:
        parent = candidates[0]
    base = Path(tempfile.mkdtemp(prefix="durable-", dir=parent))
    return base, {**mount_of(base), "path": str(base),
                  "tmpfs": mount_of(base)["fstype"] in ("tmpfs", "ramfs")}


def percentiles_ms(vals) -> dict:
    if not vals:
        return {"n": 0}
    ms = np.asarray(vals, np.float64) * 1e3
    return {"n": int(ms.size), "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "mean": float(ms.mean())}


def durable_rounds(torch, t, oracle, core, zipf_keys, rng, n_rounds, name, *, uniform=False,
                   faults=False):
    """``n_rounds`` mixed rounds of BATCH lanes through a durable tree, each
    checked against the oracle after its commit returned: per round its
    wall ms, sub-rounds, and the journal's commits, flush bytes, fsyncs and
    flushed node rows.  Unless the caller injected ``faults``, a failed
    commit attempt or an open circuit breaker is an error (the durable
    layer would absorb it and serve on)."""
    rows = []
    for r in range(n_rounds):
        ops, keys, vals = mixed_round(rng, BATCH, KEY_RANGE, zipf_keys, core, uniform=uniform)
        before, sub0 = dict(vars(t.dstats)), t.stats()["subrounds"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = t.apply_round(ops, keys, vals, scan_cap=128)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_round(out, oracle.apply_mixed_round(ops, keys, vals, cap=128), ops, core.OP_RANGE,
                    f"{name} round {r}")
        after = vars(t.dstats)
        if not faults and (after["commit_retries"] != before["commit_retries"] or t.degraded):
            raise AssertionError(f"{name} round {r}: a commit failed with no injected fault "
                                 f"({t.durability_status()})")
        rows.append({"ms": ms, "subrounds": t.stats()["subrounds"] - sub0,
                     **{k: after[k] - before[k] for k in
                        ("commits", "flush_bytes", "fsyncs", "nodes_flushed", "commit_retries")}})
    return rows


def hist_marks(t) -> dict:
    return {h: len(t.metrics.histogram_values(h)) for h in COMMIT_HISTS}


def stage_summary(rows, t, marks, directory) -> dict:
    """A durable stage's rounds: wall ms, ops/s and the journal's work a
    round, the commit histograms (capture = the device gather and host
    copy, journal_flush = the npz files written and fsynced, sidecar = the
    recorder's ring encoded, written and fsynced (none with the recorder
    off), manifest = the manifest write, rename and directory fsync,
    latency = the whole commit, gc = the collection of unreferenced files
    after it) over the stage's commits, and the journal's bytes on disk."""
    ms = [r["ms"] for r in rows]
    n = len(rows)
    return {
        "rounds": n, "round_ms_p50": float(np.percentile(ms, 50)),
        "round_ms_p99": float(np.percentile(ms, 99)), "round_ms": ms,
        "ops_per_s": BATCH * n / (sum(ms) / 1e3),
        **{f"{k}_per_round": sum(r[k] for r in rows) / n
           for k in ("subrounds", "commits", "flush_bytes", "fsyncs", "nodes_flushed",
                     "commit_retries")},
        "commit_ms": {h[:-2]: percentiles_ms(t.metrics.histogram_values(h)[marks[h]:])
                      for h in COMMIT_HISTS},
        "bytes_on_disk": dir_bytes(Path(directory)),
    }


def state_arrays_equal(a, b) -> list:
    """Names of the fields where two stacked port states differ."""
    from repro_torch.interop import state_to_numpy

    x, y = state_to_numpy(a), state_to_numpy(b)
    bad = [f"stats.{k}" for k in x["stats"] if not np.array_equal(x["stats"][k], y["stats"][k])]
    return bad + [k for k in x if k != "stats" and not np.array_equal(x[k], y[k])]


def run_durable_path(torch, core, lib, zipf_keys, volatile) -> dict:
    """The durable phase at the tree path's configuration and traffic, its
    journals in ``journal_dir()`` (removed at the end): (1) elim, group
    commit 1: ``DurableABTree(PAPER)`` prefilled as the tree path is, then
    warm-up and measured rounds, each checked against the oracle after its
    commit returned, and a few with the flight recorder on (its forensics
    sidecar is written at every commit); (2) a ``mid_manifest`` crash two
    commits ahead, which must fire there, then ``recover`` on the card
    (timed by phase), equal to the oracle's committed prefix, and
    ``recover(device="cpu")`` of a copy, equal array for array; (3) groups
    of DURABLE_GROUP rounds committed on the background thread, on the
    recovered tree, then drain, close and recover; (4) a seeded fault plan
    on a recovered tree: two ``eio`` fsyncs retried to success and one torn
    segment, which recovery truncates and quarantines; (5) occ, the paper's
    p-OCC, on a tree prefilled with the same keys: Zipf(1.0) and uniform
    rounds, beside uniform rounds on the elim tree; (6) the sharded indexes
    journaled, closed and warm-restarted.  The launch counts are zeroed
    before and read after the whole phase; the volatile tree path's rounds
    of this run (``volatile``) stand beside the durable ones."""
    from repro_torch.configs.abtree import PAPER
    from repro_torch.core.oracle import check_invariants
    from repro_torch.obs.recorder import Recorder
    from repro_torch.serve.pages import PrefixIndex, SessionIndex

    cfg = PAPER
    base, mount = journal_dir()
    log(f"durable phase: journals under {mount}")
    lib.reset_counts()
    t_phase = time.perf_counter()
    seconds = {}
    out = {"config": {**PAPER._asdict(), "key_range": KEY_RANGE, "prefill_keys": KEY_RANGE // 2,
                      "occ_prefill_keys": DURABLE_OCC_PREFILL, "batch": BATCH,
                      "warmup": DURABLE_WARMUP, "rounds": DURABLE_ROUNDS,
                      "group_commit_every": DURABLE_GROUP, "group_rounds": DURABLE_GROUP_ROUNDS,
                      "group_commit_max_wait_s": DURABLE_GROUP_MAX_WAIT_S,
                      "snapshot_every": 64, "recorder": "off but in the sidecar rounds"},
           "journal_fs": mount,
           "volatile": {k: volatile[k] for k in ("round_ms_p50", "round_ms_p50_recorder_off",
                                                 "ops_per_s")}}
    try:
        # 1. elim, group commit 1
        t0 = time.perf_counter()
        d1 = base / "elim"
        t = core.DurableABTree(str(d1), cfg, mode="elim")
        t.recorder = Recorder(enabled=False)
        oracle = core.DictOracle()
        prefill_s = prefill(t, oracle, core, np.random.default_rng(SEED), KEY_RANGE // 2,
                            KEY_RANGE, "durable")
        out["prefill"] = {"seconds": prefill_s, **vars(t.dstats),
                          "full_snapshots": t.metrics.value("full_snapshots"),
                          "pool_rows": int(t.tree.stacked.keys.shape[1])}
        rng = np.random.default_rng(SEED + 5)
        durable_rounds(torch, t, oracle, core, zipf_keys, rng, DURABLE_WARMUP, "durable warm-up")
        marks = hist_marks(t)
        rows = durable_rounds(torch, t, oracle, core, zipf_keys, rng, DURABLE_ROUNDS,
                              "durable measured")
        out["elim_group1"] = stage_summary(rows, t, marks, d1)
        t.recorder = Recorder()
        marks = hist_marks(t)
        rows = durable_rounds(torch, t, oracle, core, zipf_keys, rng, SIDECAR_ROUNDS,
                              "durable recorder on")
        out["elim_group1_recorder_on"] = stage_summary(rows, t, marks, d1)
        t.recorder = Recorder(enabled=False)
        seconds["elim_group1"] = time.perf_counter() - t0
        log(f"durable elim: round p50 {out['elim_group1']['round_ms_p50']:.1f} ms, commit "
            f"{out['elim_group1']['commit_ms']['commit_latency']}")

        # 2. crash two commits ahead, then recover on the card and on the CPU
        t0 = time.perf_counter()
        at = t._commit_idx + 2
        t.crash = core.CrashPoint("mid_manifest", at_commit=at)
        crashed = None
        for r in range(4):
            ops, keys, vals = mixed_round(rng, BATCH, KEY_RANGE, zipf_keys, core)
            try:
                res = t.apply_round(ops, keys, vals, scan_cap=128)
            except core.SimulatedCrash:
                if r != 2 or t._commit_idx != at:
                    raise AssertionError(f"crash at round {r}, commit {t._commit_idx}; set for {at}")
                crashed = r
                break
            check_round(res, oracle.apply_mixed_round(ops, keys, vals, cap=128), ops,
                        core.OP_RANGE, f"durable pre-crash round {r}")
        if crashed is None:
            raise AssertionError(f"the mid_manifest crash at commit {at} did not fire")
        t.close()
        del t
        copy = base / "elim-copy"
        shutil.copytree(d1, copy)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rt = core.recover(str(d1), group_commit_every=DURABLE_GROUP, commit_async=True,
                          group_commit_max_wait_s=DURABLE_GROUP_MAX_WAIT_S)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t1
        rt.recorder = Recorder(enabled=False)
        check_invariants(rt.tree.state, rt.tree.cfg)
        if rt.tree.items() != oracle.items():
            raise AssertionError("the recovered tree is not the committed prefix")
        t1 = time.perf_counter()
        on_cpu = core.recover(str(copy), device="cpu")
        cpu_s = time.perf_counter() - t1
        bad = state_arrays_equal(rt.tree.stacked, on_cpu.tree.stacked)
        if bad:
            raise AssertionError(f"recover on the card and on the CPU differ in {bad}")
        del on_cpu
        shutil.rmtree(copy)
        out["recovery"] = {"crash": {"step": "mid_manifest", "at_commit": at, "round": crashed},
                           "seconds": recover_s, **rt.recovery_timings,
                           "cpu_seconds": cpu_s, "live_keys": len(oracle.d),
                           "pool_rows": int(rt.tree.stacked.keys.shape[1]),
                           "journal_bytes": dir_bytes(d1), "equal_on_cpu": True}
        seconds["crash_recover"] = time.perf_counter() - t0
        log(f"durable recovery: {out['recovery']}")

        # 3. group commit 8, async, on the recovered tree
        t0 = time.perf_counter()
        marks, before = hist_marks(rt), dict(vars(rt.dstats))
        rows = durable_rounds(torch, rt, oracle, core, zipf_keys, rng, DURABLE_GROUP_ROUNDS,
                              "durable group")
        rt.drain()
        rt.close()
        out["elim_group8_async"] = stage_summary(rows, rt, marks, d1)
        # the rows count what had landed when each round returned; the
        # drain's commit lands after them
        out["elim_group8_async"]["journal_after_drain"] = {
            k: v - before[k] for k, v in vars(rt.dstats).items()}
        del rt
        r2 = core.recover(str(d1))
        if r2.tree.items() != oracle.items():
            raise AssertionError("the drained group journal does not recover the oracle")
        seconds["group8"] = time.perf_counter() - t0

        # 4. faults on a recovered tree
        t0 = time.perf_counter()
        r2.recorder = Recorder(enabled=False)
        c = r2._commit_idx
        torn_at = c + 5 if (c + 5) % r2.snapshot_every else c + 6
        r2.crash = core.FaultPlan(seed=SEED, specs=[
            core.FaultSpec(site="segment_fsync", kind="eio", commits=(c + 1, c + 2), times=1),
            core.FaultSpec(site="segment_fsync", kind="eio", commits=(c + 3, c + 4), times=1),
            core.FaultSpec(site="segment_write", kind="torn", commits=(torn_at, torn_at + 1),
                           times=1),
        ])
        before_torn = None
        for r in range(DURABLE_FAULT_ROUNDS):
            if r2._commit_idx == torn_at:
                before_torn = dict(oracle.d)
            durable_rounds(torch, r2, oracle, core, zipf_keys, rng, 1, f"durable faults {r}",
                           faults=True)
        status = r2.durability_status()
        if (r2.dstats.commit_retries != 2 or status["degraded"] or before_torn is None
                or r2.metrics.value("fault_injected") != 3):
            raise AssertionError(f"faults: retries {r2.dstats.commit_retries}, {status}")
        r2.close()
        del r2
        r3 = core.recover(str(d1))
        r3.recorder = Recorder(enabled=False)
        quarantined = list(r3._quarantined)
        if r3.tree.items() != before_torn:
            raise AssertionError("recovery past a torn segment is not the commit before it")
        if not quarantined or r3.metrics.value("segments_quarantined") < 1:
            raise AssertionError("the torn segment was not quarantined")
        oracle.d = before_torn
        # a recovery that truncated commits a full snapshot first
        full = durable_rounds(torch, r3, oracle, core, zipf_keys, rng, 1, "durable post-recovery")
        out["faults"] = {"eio_commits": [c + 1, c + 3], "torn_commit": torn_at,
                         "commit_retries": status["commit_retries"],
                         "faults_injected": status["faults_injected"],
                         "quarantined": quarantined, "lands_on_commit": torn_at - 1,
                         "post_recovery_round": full[0]}
        seconds["faults"] = time.perf_counter() - t0

        # 5. occ against elim, the paper's flush accounting
        t0 = time.perf_counter()
        marks = hist_marks(r3)
        rows = durable_rounds(torch, r3, oracle, core, zipf_keys, np.random.default_rng(SEED + 6),
                              DURABLE_UNIFORM,
                              "durable elim uniform", uniform=True)
        out["elim_uniform"] = stage_summary(rows, r3, marks, d1)
        r3.close()
        del r3, oracle
        d2 = base / "occ"
        t2 = core.DurableABTree(str(d2), cfg, mode="occ")
        t2.recorder = Recorder(enabled=False)
        oracle2 = core.DictOracle()
        occ_prefill_s = prefill(t2, oracle2, core, np.random.default_rng(SEED),
                                DURABLE_OCC_PREFILL, KEY_RANGE, "durable occ")
        out["occ_prefill"] = {"seconds": occ_prefill_s, **vars(t2.dstats)}
        rng_o = np.random.default_rng(SEED + 7)
        if DURABLE_OCC_ZIPF:
            marks = hist_marks(t2)
            rows = durable_rounds(torch, t2, oracle2, core, zipf_keys, rng_o, DURABLE_OCC_ZIPF,
                                  "durable occ zipf")
            out["occ_zipf"] = stage_summary(rows, t2, marks, d2)
        marks = hist_marks(t2)
        rows = durable_rounds(torch, t2, oracle2, core, zipf_keys,
                              np.random.default_rng(SEED + 6), DURABLE_UNIFORM,
                              "durable occ uniform", uniform=True)
        out["occ_uniform"] = stage_summary(rows, t2, marks, d2)
        check_invariants(t2.tree.state, t2.tree.cfg)
        if t2.tree.items() != oracle2.items():
            raise AssertionError("the durable occ tree differs from the oracle")
        t2.close()
        del t2, oracle2
        seconds["occ"] = time.perf_counter() - t0

        # 6. the sharded indexes, journaled, closed and warm-restarted
        t0 = time.perf_counter()
        d3 = base / "indexes"
        idx_summary, idx, audit = run_index_path(torch, core, lib, durable_dir=d3)
        idx.index.close()
        idx.sessions.close()
        knobs = index_knobs(d3)
        warm = {"index": PrefixIndex(**knobs["index"]),
                "sessions": SessionIndex(**knobs["sessions"])}
        for name, oname in (("index", "prefix"), ("sessions", "sessions")):
            if warm[name].tree.items() != audit.oracles[oname].items():
                raise AssertionError(f"the warm-restarted {oname} index differs from the oracle")
            warm[name].close()
        idx_summary["warm_restart"] = {name: {"n_shards": w.tree.n_shards,
                                              "live_keys": len(w.tree.items())}
                                       for name, w in warm.items()}
        idx_summary["journal_bytes"] = dir_bytes(d3)
        idx_summary.pop("launches")
        out["indexes"] = idx_summary
        seconds["indexes"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = {**seconds, "phase": time.perf_counter() - t_phase}
    out["launches"] = launch_counts(lib)
    log(f"durable phase: {out['seconds']}")
    return out


# ----------------------------------------------------------------------------
# obs phase
# ----------------------------------------------------------------------------


def swap_eliminated_pair(records, core):
    """A copy of ``records`` (shared but for one record) in which the first
    mixed round with an elimination segment has the results of one of its
    insert / delete pairs swapped, where the two differ.  Segment lanes are
    packed slots: shard s's point lanes in arrival order."""
    for idx, rec in enumerate(records):
        if rec.get("kind") != "round" or core.OP_RANGE not in rec["ops"]:
            continue
        point = [i for i, op in enumerate(rec["ops"])
                 if op in (core.OP_FIND, core.OP_INSERT, core.OP_DELETE)]
        for note in rec.get("elim") or []:
            for seg in note["segments"]:
                lanes = [point[x] for x in seg["lanes"]] if rec["n_shards"] == 1 else []
                if any(rec["keys"][i] != seg["key"] for i in lanes):
                    raise AssertionError(f"record {idx}: segment lanes {seg['lanes']} are not "
                                         f"key {seg['key']}'s")
                ins = [i for i in lanes if rec["ops"][i] == core.OP_INSERT]
                dels = [i for i in lanes if rec["ops"][i] == core.OP_DELETE]
                for i in ins:
                    for j in dels:
                        if (rec["results"][i], rec["found"][i]) != (rec["results"][j],
                                                                    rec["found"][j]):
                            bad = dict(rec, results=list(rec["results"]),
                                       found=list(rec["found"]))
                            for f in ("results", "found"):
                                bad[f][i], bad[f][j] = bad[f][j], bad[f][i]
                            return records[:idx] + [bad] + records[idx + 1:], {
                                "record": idx, "round": rec["round"], "key": seg["key"],
                                "lanes": [i, j]}
    raise AssertionError("no mixed round with an eliminated insert / delete pair to swap")


def drop_delete_lane(records, core):
    """A copy of ``records`` (shared but for one record) without the first
    delete lane of a mixed round that found its key when a later point lane
    of the history reads or writes that key (so the history without it
    cannot be legal).  Range lanes after it move down one index."""
    later = collections.Counter()
    for rec in records:
        if rec.get("kind") == "round":
            later.update(k for op, k in zip(rec["ops"], rec["keys"])
                         if op not in (core.OP_NOP, core.OP_RANGE))
    for idx, rec in enumerate(records):
        if rec.get("kind") != "round":
            continue
        mixed = core.OP_RANGE in rec["ops"]
        for i, (op, k) in enumerate(zip(rec["ops"], rec["keys"])):
            if op not in (core.OP_NOP, core.OP_RANGE):
                later[k] -= 1
            if mixed and op == core.OP_DELETE and rec["found"][i] and later[k] > 0:
                bad = dict(rec)
                for f in ("ops", "keys", "vals", "results", "found"):
                    bad[f] = rec[f][:i] + rec[f][i + 1:]
                if rec.get("scans"):
                    bad["scans"] = {str(int(x) - (int(x) > i)): rows
                                    for x, rows in rec["scans"].items()}
                return records[:idx] + [bad] + records[idx + 1:], {
                    "record": idx, "round": rec["round"], "key": k, "lane": i}
    raise AssertionError("no found delete of a key the history touches again")


def run_obs_path(torch, core, lib, zipf_keys, tree, history, forest, forest_oracle) -> dict:
    """The obs phase on the card, over histories the paths above recorded:
    (a) the port's witness replays the tree path's flight recorder from the
    empty tree (rounds, lanes, eliminated ops and final contents equal to
    what the path issued and the tree counted), and ``python -m
    repro_torch.obs.witness`` accepts its exported JSONL; (b) a swapped
    eliminated insert / delete pair and a dropped delete lane are rejected;
    (c) a fresh ``DurableABTree(PAPER)`` with its recorder on, OBS_CRASH_FIRST
    lanes then OBS_CRASH_ROUNDS rounds of the mix, crashed ``mid_manifest``
    two commits ahead and recovered on the card: its forensics sidecar
    replays to the recovered contents, which are one of its prefix states;
    (d) the tree path's traced rounds written as a Chrome trace: schema
    valid, ``report_summary``'s phase totals equal to the tree path's traced
    breakdown and a counter track of each traced round's retry passes
    (``Tracer.counter``), and OBS_FOREST_ROUNDS traced rounds of the static forest:
    valid, per-shard instants on every shard's track, ``router_pack`` spans,
    ``report.main --json`` 0; (e) the op audit of the search and scan phases
    on the tree path's tree over one mixed round.  The launch counts are
    zeroed before the phase and read after it: each tree kernel must have
    run.  Every check raises."""
    import contextlib
    import io
    import math
    import os
    import tempfile

    from repro_torch.configs.abtree import PAPER
    from repro_torch.obs import report
    from repro_torch.obs.op_audit import (AUDIT_REPEAT, audit_search_phases, count_ops,
                                          kernel_launches, wrapper_launches)
    from repro_torch.obs.recorder import Recorder
    from repro_torch.obs.trace_export import load_trace, validate_trace, write_chrome_trace
    from repro_torch.obs.tracer import NULL_TRACER, Tracer
    from repro_torch.obs.witness import WitnessError, check_history

    lib.reset_counts()
    t_phase = time.perf_counter()
    seconds, out = {}, {}
    records = history["recorder"].records()
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="obs-", dir=build))
    try:
        # (a) the tree path's history through the witness, in process and by its CLI
        t0 = time.perf_counter()
        rep = check_history(records)
        seconds["witness"] = time.perf_counter() - t0
        got = {"rounds": rep.rounds, "lanes": rep.lanes, "eliminated": rep.eliminated}
        want = {k: history[k] for k in got}
        if got != want:
            raise AssertionError(f"witness of the tree path's history: {got}, issued {want}")
        if rep.state != history["state"]:
            raise AssertionError("the witness's final state differs from the oracle's")
        t0 = time.perf_counter()
        path = history["recorder"].export(str(base / "tree_audit.jsonl"))
        seconds["export"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        cli = subprocess.run([sys.executable, "-m", "repro_torch.obs.witness", path], env=env,
                             capture_output=True, text=True, timeout=300)
        seconds["witness_cli"] = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"python -m repro_torch.obs.witness exited {cli.returncode}: "
                                 f"{cli.stderr[-2000:]}")
        out["tree_history"] = {
            **got, "live_keys": len(rep.state), "records": len(records),
            "ring_capacity": history["recorder"].capacity, "b": PAPER.b,
            "lanes_per_s": rep.lanes / seconds["witness"],
            "jsonl_bytes": Path(path).stat().st_size,
            "bytes_per_lane": Path(path).stat().st_size / rep.lanes,
            "cli": {"rc": cli.returncode, "stdout": cli.stdout.strip()[-300:]}}
        log(f"obs witness: {out['tree_history']}, {seconds}")

        # (b) two corrupted copies
        t0 = time.perf_counter()
        corrupt = {}
        for name, make in (("swapped_pair", swap_eliminated_pair),
                           ("dropped_delete", drop_delete_lane)):
            bad, where = make(records, core)
            try:
                check_history(bad)
            except WitnessError as e:
                corrupt[name] = {**where, "rejected": True, "error": str(e)[:200]}
            else:
                raise AssertionError(f"the witness accepted the history with a {name}: {where}")
        del bad
        seconds["corruptions"] = time.perf_counter() - t0
        out["corruptions"] = corrupt

        # (c) crash forensics: a durable tree from empty, recorder on
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED + 7)
        t = core.DurableABTree(str(base / "durable"), PAPER, mode="elim")
        t.recorder = Recorder()
        oracle = core.DictOracle()
        ok = 0
        for r, width in enumerate([OBS_CRASH_FIRST] + [BATCH] * OBS_CRASH_ROUNDS):
            ops, keys, vals = mixed_round(rng, width, KEY_RANGE, zipf_keys, core)
            res = t.apply_round(ops, keys, vals, scan_cap=128)
            check_round(res, oracle.apply_mixed_round(ops, keys, vals, cap=128), ops,
                        core.OP_RANGE, f"obs durable round {r}")
            ok += 1
        seconds["durable_rounds"] = time.perf_counter() - t0
        at = t._commit_idx + 2
        t.crash = core.CrashPoint("mid_manifest", at_commit=at)
        crashed = None
        for r in range(4):
            ops, keys, vals = mixed_round(rng, BATCH, KEY_RANGE, zipf_keys, core)
            try:
                res = t.apply_round(ops, keys, vals, scan_cap=128)
            except core.SimulatedCrash:
                if r != 2 or t._commit_idx != at:
                    raise AssertionError(f"crash at round {r}, commit {t._commit_idx}; set for {at}")
                crashed = r
                break
            check_round(res, oracle.apply_mixed_round(ops, keys, vals, cap=128), ops,
                        core.OP_RANGE, f"obs durable pre-crash round {r}")
            ok += 1
        if crashed is None:
            raise AssertionError(f"the mid_manifest crash at commit {at} did not fire")
        t.close()
        del t
        t1 = time.perf_counter()
        rt = core.recover(str(base / "durable"))
        torch.cuda.synchronize()
        seconds["recover"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        recs = rt.forensics_records()
        srep = check_history(recs, collect_prefixes=True)
        seconds["sidecar_witness"] = time.perf_counter() - t1
        items = rt.tree.items()
        if items != oracle.items():
            raise AssertionError("the recovered durable tree is not the committed prefix")
        if not recs or recs[0].get("kind") != "sidecar" or srep.rounds != ok:
            raise AssertionError(f"forensics sidecar: {recs[:1]}, {srep.rounds} rounds witnessed, "
                                 f"{ok} committed")
        if srep.state != items:
            raise AssertionError("the sidecar's replay differs from the recovered contents")
        if items not in srep.prefix_states:
            raise AssertionError("the recovered contents are none of the sidecar's prefix states")
        rt.close()
        seconds["forensics"] = time.perf_counter() - t0
        out["forensics"] = {"rounds": srep.rounds, "lanes": srep.lanes,
                            "eliminated": srep.eliminated, "live_keys": len(items),
                            "crash": {"step": "mid_manifest", "at_commit": at, "round": crashed},
                            "sidecar": {k: recs[0].get(k) for k in ("commit_idx", "rounds",
                                                                     "backend")},
                            "prefix_index": srep.prefix_states.index(items),
                            "report": report.forensics_summary(recs)}
        del rt, recs, srep

        # (d) the tree path's traced rounds and two traced rounds of the static forest
        t0 = time.perf_counter()
        tpath = write_chrome_trace(str(base / "tree_trace.json"), history["tracer"])
        doc = load_trace(tpath)
        errs = validate_trace(doc)
        if errs:
            raise AssertionError(f"tree trace: {errs[:5]}")
        summ = report.report_summary(doc)
        totals = {n: p["total_ms"] for n, p in summ["phases"].items()}
        traced = {n: ms * TRACED_ROUNDS for n, ms in history["traced_ms_per_round"].items()}
        if totals.keys() != traced.keys() or not all(
                math.isclose(totals[n], traced[n], rel_tol=1e-9, abs_tol=1e-9) for n in totals):
            raise AssertionError(f"report totals {totals} != the traced breakdown {traced}")
        missing = {"round", "search_combine", "apply", "retry", "rebalance", "scan"} - totals.keys()
        if missing:
            raise AssertionError(f"tree trace lacks the phases {sorted(missing)}")
        # the counter track: the retry passes of each traced round, on the engine's track
        t1 = time.perf_counter()
        samples = [e for e in doc["traceEvents"] if e["ph"] == "C"]
        track = [e["args"]["value"] for e in samples if e["name"] == "retry_passes"]
        want_track = [float(v) for v in history["traced_retry_passes"]]
        if track != want_track or len(track) != len(samples) or {e["tid"] for e in samples} != {0}:
            raise AssertionError(f"tree trace's counter track {track} != the traced rounds' "
                                 f"retry passes {want_track}")
        seconds["counter_track"] = time.perf_counter() - t1
        forest.tracer = Tracer()
        rows = timed_rounds(torch, lib, forest, forest_oracle, core, zipf_keys,
                            np.random.default_rng(SEED + 8), OBS_FOREST_ROUNDS, "obs forest")
        fpath = forest.tracer.export(str(base / "forest_trace.json"))
        forest.tracer = NULL_TRACER
        fdoc = load_trace(fpath)
        errs = validate_trace(fdoc)
        if errs:
            raise AssertionError(f"forest trace: {errs[:5]}")
        tids = {e["tid"] for e in fdoc["traceEvents"] if e["ph"] == "i"}
        packs = sum(1 for e in fdoc["traceEvents"] if e["ph"] == "X" and e["name"] == "router_pack")
        if not set(range(1, FOREST_SHARDS + 1)) <= tids or not packs:
            raise AssertionError(f"forest trace: instants on tids {sorted(tids)}, "
                                 f"{packs} router_pack spans")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = report.main([fpath, "--json"])
        fsumm = json.loads(buf.getvalue())
        if rc != 0 or fsumm["router_pack"] is None:
            raise AssertionError(f"report --json on the forest trace: rc {rc}, {fsumm}")
        seconds["traces"] = time.perf_counter() - t0
        out["traces"] = {
            "tree": {"events": summ["events"], "traced_rounds": TRACED_ROUNDS,
                     "total_ms": totals, "bytes": Path(tpath).stat().st_size,
                     "counter_track": {"name": "retry_passes", "values": track}},
            "forest": {"events": fsumm["events"], "rounds": len(rows),
                       "round_ms": [x["ms"] for x in rows], "shard_tids": sorted(tids),
                       "router_pack": fsumm["router_pack"],
                       "per_shard_lanes": fsumm["per_shard_lanes"],
                       "bytes": Path(fpath).stat().st_size}}
    finally:
        shutil.rmtree(base, ignore_errors=True)

    # (e) the op audit on the tree path's tree, over one mixed round
    t0 = time.perf_counter()
    batch = mixed_round(np.random.default_rng(SEED + 9), BATCH, KEY_RANGE, zipf_keys, core)
    # at the frontier width the tree path's rounds scanned with (the large-cap
    # scan grew it since)
    tree._scan_frontier = history["scan_frontier"]
    # on the card the audit raises on a sort in the scan phases and on a
    # phase that did not launch its kernels
    audit = audit_search_phases(holder=tree, batch=batch)
    seconds["op_audit"] = time.perf_counter() - t0
    out["op_audit"] = {p: {"ops": count_ops(c), "launched": wrapper_launches(c, p),
                           "seen": kernel_launches(c, p)} for p, c in audit.items()}
    out["op_audit"].update(scan_frontier=tree._scan_frontier, calls_per_phase=AUDIT_REPEAT)
    out["seconds"] = {**seconds, "phase": time.perf_counter() - t_phase}
    out["launches"] = launch_counts(lib)
    if not all(out["launches"].values()):
        raise AssertionError(f"obs phase: a tree kernel never ran: {out['launches']}")
    log(f"obs phase: {out['seconds']}")
    return out


# ----------------------------------------------------------------------------
# serve path
# ----------------------------------------------------------------------------


def serve_requests(vocab: int):
    """(rid, prompt, is_hot) from the seed: ``SERVE_HOT_FRAC`` of them share
    one hot prompt (the JAX launcher's ``--hot-frac``)."""
    rng = np.random.default_rng(SEED)
    hot = rng.integers(0, vocab, SERVE_PROMPT).tolist()
    out = []
    for rid in range(SERVE_REQUESTS):
        if rng.random() < SERVE_HOT_FRAC:
            out.append((rid, list(hot), True))
        else:
            out.append((rid, rng.integers(0, vocab, SERVE_PROMPT).tolist(), False))
    return out


def _forest(holder):
    """The round-engine holder under a durable index (its ``ABForest``)."""
    return getattr(holder, "forest", holder)


class IndexAudit:
    """Mirrors every call an engine makes on its two indexes into a
    ``DictOracle`` each, checks every lookup and sweep against it as it
    happens, and times the index calls (each ends in a host copy of its
    results, so its wall time covers its device work)."""

    def __init__(self, eng, core):
        self.core = core
        self.seconds = 0.0
        self.calls = collections.Counter()
        self.seconds_by = collections.Counter()
        self.oracles = {"prefix": core.DictOracle(), "sessions": core.DictOracle()}
        for name, index in (("prefix", eng.index), ("sessions", eng.sessions)):
            self._wrap(name, index)

    def _timed(self, kind, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        self.seconds += dt
        self.seconds_by[kind] += dt
        self.calls[kind] += 1
        return out

    def _wrap(self, name, index):
        core, oracle = self.core, self.oracles[name]
        lookup, publish, evict = index.lookup_batch, index.publish_batch, index.evict_batch

        def lookup_batch(hashes):
            got = self._timed(f"{name}.lookup", lookup, hashes)
            res, fnd, _ = oracle.apply_mixed_round([core.OP_FIND] * len(hashes), hashes, [0] * len(hashes))
            want = [r if f else None for r, f in zip(res, fnd)]
            if got != want:
                raise AssertionError(f"{name} lookup {got} != oracle {want}")
            return got

        def publish_batch(keys, vals):
            self._timed(f"{name}.publish", publish, keys, vals)
            if keys:
                oracle.apply_mixed_round([core.OP_INSERT] * len(keys), keys, vals)

        def evict_batch(keys):
            self._timed(f"{name}.evict", evict, keys)
            if keys:
                oracle.apply_mixed_round([core.OP_DELETE] * len(keys), keys, [0] * len(keys))

        index.lookup_batch, index.publish_batch, index.evict_batch = lookup_batch, publish_batch, evict_batch
        if hasattr(index, "evict_range"):
            sweep = index.evict_range

            def evict_range(lo, hi, cap=256):
                got = self._timed(f"{name}.sweep", sweep, lo, hi, cap)
                gone = sorted(k for k in oracle.d if lo <= k < hi)
                want = [oracle.d.pop(k) for k in gone]
                if got != want:
                    raise AssertionError(f"sweep [{lo}, {hi}) {got} != oracle {want}")
                return got

            index.evict_range = evict_range

    def check(self, eng):
        for name, index in (("prefix", eng.index), ("sessions", eng.sessions)):
            tree = _forest(index.tree)
            if tree.n_shards > 1:
                self.core.check_forest_invariants(tree)
            else:
                self.core.check_invariants(tree.state, tree.cfg)
            if index.tree.items() != self.oracles[name].items():
                raise AssertionError(f"{name} index contents differ from the oracle")


def serve_run(torch, core, serve, cfg, params, device, *, pipelined: bool, n_requests: int,
              max_new: int, tracer=None, on_stream_sync: bool = False, reqs=None,
              engine=SERVE_ENGINE):
    """One engine run over the first ``n_requests`` requests (of
    ``serve_requests``, or of ``reqs``: (rid, prompt, is_hot) triples) on
    an engine built with ``engine``.  With ``on_stream_sync`` the serial run
    also waits for the model stream at the end of each admission, so the
    tick splits into admission (index rounds and prefill) and decode times;
    the tick's total is unchanged, since the decode fence waits for the same
    work."""
    eng = serve.ServeEngine(cfg, pipelined=pipelined, params=params, seed=SEED, device=device,
                            **engine)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    audit = IndexAudit(eng, core)
    timing = {"admit_s": 0.0, "retire_s": 0.0}
    if on_stream_sync:
        admit, retire = eng._admit, eng._retire

        def timed_admit():
            t0 = time.perf_counter()
            admit()
            if eng._stream is not None:
                eng._stream.synchronize()
            timing["admit_s"] += time.perf_counter() - t0

        def timed_retire(slot):
            t0 = time.perf_counter()
            retire(slot)
            timing["retire_s"] += time.perf_counter() - t0

        eng._admit, eng._retire = timed_admit, timed_retire
    if tracer is not None:
        eng.tracer = tracer
    reqs = (serve_requests(cfg.vocab) if reqs is None else reqs)[:n_requests]
    for rid, prompt, _ in reqs:
        eng.submit(serve.Request(rid=rid, prompt=prompt, max_new=max_new))
    sync()
    t0 = time.perf_counter()
    done = eng.run_until_done(max_ticks=100_000)
    sync()
    wall = time.perf_counter() - t0
    if sorted(r.rid for r in done) != [rid for rid, _, _ in reqs]:
        raise AssertionError("serve: not every request completed")
    for r in done:
        if len(r.out) != max_new:
            raise AssertionError(f"serve: request {r.rid} produced {len(r.out)} tokens")
    audit.check(eng)
    st = eng.stats()
    tick = st["tick_latency"]
    prefill_tokens = sum(len(p) - 1 for _, p, _ in reqs)
    decode_tokens = eng.metrics.value("decode_tokens")
    out = {
        "pipelined": pipelined,
        "requests": len(reqs),
        "hot_requests": sum(hot for _, _, hot in reqs),
        "wall_s": wall,
        "ticks": st["ticks"],
        "tick_ms_p50": tick["p50"] * 1e3,
        "tick_ms_p99": tick["p99"] * 1e3,
        "tick_ms_sum": tick["sum"] * 1e3,
        "prefill_tokens": prefill_tokens,
        "decode_tokens": decode_tokens,
        "tokens_per_s": (prefill_tokens + decode_tokens) / wall,
        "cache_hit_blocks": st["cache_hit_blocks"],
        "admitted": eng.metrics.value("admitted"),
        "retired": eng.metrics.value("retired"),
        "index_calls": dict(audit.calls),
        "index_s_by_call": dict(audit.seconds_by),
        "index_rounds": int(eng.index.tree._rounds + eng.sessions.tree._rounds),
        "index_s": audit.seconds,
        "index_share_of_ticks": audit.seconds / tick["sum"] if tick["sum"] else 0.0,
        "eliminated": int(st["eliminated"]),
        "session_scans": st["session_scans"],
    }
    if pipelined:
        frac = eng.metrics.histogram_summary("tick_overlap_frac")
        out["tick_overlap_frac_mean"] = frac["sum"] / frac["count"] if frac["count"] else 0.0
        out["tick_overlap_frac_max"] = frac["max"]
    if on_stream_sync:
        # admission = its index calls (lookups, publishes) + the prefill
        # steps; decode = the rest of the ticks outside retirement
        admit_index_s = sum(v for k, v in audit.seconds_by.items()
                            if k.endswith((".lookup", ".publish")))
        prefill_s = timing["admit_s"] - admit_index_s
        decode_s = tick["sum"] - timing["admit_s"] - timing["retire_s"]
        out.update(admit_s=timing["admit_s"], retire_s=timing["retire_s"],
                   admit_index_s=admit_index_s, prefill_s=prefill_s, decode_s=decode_s,
                   prefill_tokens_per_s=prefill_tokens / prefill_s,
                   decode_tokens_per_s=decode_tokens / decode_s)
    return eng, out, {r.rid: list(r.out) for r in done}


def decode_step_timing(torch, backbone, eng):
    """One fused decode step of the engine's model at full batch: wall time
    per step as the engine issues them (host loop, one synchronize at the
    end), and device time per step from a CUDA graph of the same steps
    (host launch cost removed).  Their gap is the card's idle share while
    the host issues a step.  Writes one cache column; run after serving."""
    cfg, dev = eng.cfg, eng.device
    tokens = torch.zeros(eng.max_batch, dtype=torch.int32, device=dev)
    pos = eng.s_max - 2

    def step():
        backbone.forward_decode(eng.params, eng.cache, tokens, pos, cfg)

    for _ in range(3):
        step()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(STEP_TIMING_STEPS):
        step()
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEP_TIMING_STEPS
    device_ms = graph_ms(torch, step, iters=STEP_TIMING_STEPS, reps=3)
    return {"steps": STEP_TIMING_STEPS, "kv_len": pos + 1, "wall_ms": wall_ms,
            "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall_ms}


def run_serve_path(torch, core, lib, device, cfg):
    """The serving path at full qwen2-0.5b: serial run, pipelined run (the
    launch counts cover both), then a short traced run.  Returns the
    summary and the arguments of the pipelined run's last decode-attention
    launch."""
    import repro_torch.serve as serve
    from repro_torch.models import backbone
    from repro_torch.models.params import count_params, init_params
    from repro_torch.obs.tracer import Tracer

    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    params = init_params(backbone.model_spec(cfg), device, SEED)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    init_s = time.perf_counter() - t0
    counters = {n: lib.counter(n) for n in SERVE_KERNELS}
    attn = counters["decode_attention"]

    lib.reset_counts()
    t0 = time.perf_counter()
    eng, serial, tokens_serial = serve_run(
        torch, core, serve, cfg, params, device, pipelined=False, n_requests=SERVE_REQUESTS,
        max_new=SERVE_MAX_NEW, on_stream_sync=True,
    )
    log(f"serve serial: {time.perf_counter() - t0:.1f}s, {serial['ticks']} ticks")
    serial_launches = {n: c.launches for n, c in counters.items()}
    del eng
    attn.calls = collections.deque(maxlen=1)
    t0 = time.perf_counter()
    eng, piped, tokens_piped = serve_run(
        torch, core, serve, cfg, params, device, pipelined=True, n_requests=SERVE_REQUESTS,
        max_new=SERVE_MAX_NEW,
    )
    log(f"serve pipelined: {time.perf_counter() - t0:.1f}s, {piped['ticks']} ticks")
    recorded = attn.calls[-1] if attn.calls else None
    attn.calls = None
    launches = {n: c.launches for n, c in counters.items()}
    step = decode_step_timing(torch, backbone, eng) if on_card else None
    del eng
    piped_launches = {n: launches[n] - serial_launches[n] for n in launches}
    for run, counts in (("serial", serial_launches), ("pipelined", piped_launches)):
        missing = [n for n, c in counts.items() if c <= 0]
        if missing:
            raise AssertionError(f"serve {run}: kernels {missing} never launched")
    if tokens_serial != tokens_piped:
        raise AssertionError("serve: serial and pipelined runs gave different tokens")
    for run in (serial, piped):
        if run["cache_hit_blocks"] <= 0:
            raise AssertionError("serve: the prefix cache was never hit")
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else None

    # a short traced run: per-tick span totals (the tracer fences every span)
    tracer = Tracer()
    eng, traced, _ = serve_run(
        torch, core, serve, cfg, params, device, pipelined=False, n_requests=TRACED_REQUESTS,
        max_new=TRACED_MAX_NEW, tracer=tracer,
    )
    del eng
    spans = collections.defaultdict(float)
    counts = collections.Counter()
    for ev in tracer.events:
        if ev["ph"] == "X":
            spans[ev["name"]] += ev["dur"] / 1e3
            counts[ev["name"]] += 1
    summary = {
        "config": {"arch": SERVE_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
                   "heads": cfg.n_heads, "kv_heads": cfg.n_kv, "d_head": cfg.d_head,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
                   "params": count_params(backbone.model_spec(cfg)), **SERVE_ENGINE,
                   "requests": SERVE_REQUESTS, "prompt": SERVE_PROMPT, "max_new": SERVE_MAX_NEW,
                   "hot_frac": SERVE_HOT_FRAC, "seed": SEED},
        "param_init_s": init_s,
        "serial": serial,
        "pipelined": piped,
        "launches": launches,
        "launches_serial": serial_launches,
        "launches_pipelined": piped_launches,
        "max_memory_allocated": peak,
        "decode_step": step,
        "traced": {"requests": TRACED_REQUESTS, "max_new": TRACED_MAX_NEW,
                   "ticks": traced["ticks"], "ms_total": dict(spans), "count": dict(counts)},
    }
    return summary, recorded


# ----------------------------------------------------------------------------
# train path
# ----------------------------------------------------------------------------


def device_busy_ms(torch, prof, top: int = 12):
    """Device time inside a profiled window: the union of the intervals of
    every device-side event (kernels, copies, fills) the profiler saw, their
    count, and the ``top`` event names by summed device ms."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    by_name = collections.Counter()
    for e in events:
        by_name[e.name[:80]] += (e.time_range.end - e.time_range.start) / 1e3
    return busy / 1e3, len(spans), dict(by_name.most_common(top))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_train_path(torch, lib, device):
    """The training path at full qwen2-0.5b: (a) the launcher's Trainer,
    timed, with a profiled step after it; (b) the loss falling on one
    fixed batch; (c) crash, restart and resume on the reduced config.
    Returns the summary and the arguments of the timed run's last
    flash-attention launch."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import make_data_iter
    from repro_torch.launch import train as launch
    from repro_torch.models import backbone, reduced
    from repro_torch.models.params import init_params
    from repro_torch.optim import adamw_init, constant_lr
    from repro_torch.train import SimulatedFailure, Trainer, TrainerConfig, make_train_step

    flash = lib.counter("flash_attention")
    cfg = get_config(TRAIN_ARCH)
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    to_dev = lambda batch: {k: torch.from_numpy(x).to(device) for k, x in batch.items()}

    # (a) the Trainer as the launcher builds it, on the launcher's schedule
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--ckpt", ckpt]
        t0 = time.perf_counter()
        trainer = launch.build_trainer(launch.parse_args(argv), device)
        sync()
        init_s = time.perf_counter() - t0
        if trainer.resumed_from is not None:
            raise AssertionError("train: a fresh checkpoint directory resumed")
        trainer.tcfg.log_every = 1  # every step's loss into the history
        saves = []
        save = trainer.ckpt.save

        def timed_save(step, state, extra=None):
            t1 = time.perf_counter()
            save(step, state, extra)
            saves.append({"step": step, "s": time.perf_counter() - t1,
                          "bytes": dir_bytes(Path(ckpt) / f"step_{step:08d}")})

        trainer.ckpt.save = timed_save
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        flash.calls = collections.deque(maxlen=1)
        lib.reset_counts()
        t0 = time.perf_counter()
        out = trainer.run()
        run_s = time.perf_counter() - t0
        launches = {n: lib.counter(n).launches for n in lib.SOURCES}
        recorded = detached(flash.calls[-1])
        flash.calls = None
        peak = int(torch.cuda.max_memory_allocated(device)) if on_card else None
        log(f"train: {TRAIN_STEPS} steps in {run_s:.1f}s")
        losses = [h["loss"] for h in out["history"]]
        if out["final_step"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
            raise AssertionError(f"train: ended at step {out['final_step']} with {len(losses)} losses")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train: a loss is not finite: {losses}")
        if launches["flash_attention"] != cfg.n_layers * TRAIN_STEPS:
            raise AssertionError(
                f"train: flash_attention launched {launches['flash_attention']} times in "
                f"{TRAIN_STEPS} steps, not {cfg.n_layers} a forward (the backward launches none)")
        steps = np.asarray([h["sec_per_step"] for h in out["history"]][1:])  # step 1 warms up

        # one more step under the profiler: device time against its wall time
        batch = to_dev(next(make_data_iter(cfg, TRAIN_BATCH, TRAIN_SEQ, start_step=TRAIN_STEPS)))
        before = flash.launches
        sync()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            step_out = trainer.step_fn(trainer.params, trainer.opt, batch, TRAIN_STEPS)
            float(step_out.metrics["loss"])
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3
        if flash.launches - before != cfg.n_layers:
            raise AssertionError(f"train: the profiled step launched flash_attention "
                                 f"{flash.launches - before} times, not {cfg.n_layers}")
        busy_ms, n_events, top_events = device_busy_ms(torch, prof)
        del trainer, step_out, prof
    p50_ms = float(np.percentile(steps, 50)) * 1e3
    timed = {
        "config": {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
                   "heads": cfg.n_heads, "kv_heads": cfg.n_kv, "d_head": cfg.d_head,
                   "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype, "remat": cfg.remat,
                   "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
                   "schedule": "warmup_cosine, peak 3e-4 (the launcher's)", "seed": SEED},
        "init_s": init_s,
        "run_s": run_s,
        "losses": losses,
        "sec_per_step": steps.tolist(),
        "sec_per_step_p50": float(np.percentile(steps, 50)),
        "sec_per_step_p99": float(np.percentile(steps, 99)),
        "tokens_per_s": tokens_per_step * len(steps) / float(steps.sum()),
        "max_memory_allocated": peak,
        "checkpoints": saves,
        "launches": launches,
        "profiled_step": {"wall_ms": profiled_wall_ms, "device_busy_ms": busy_ms,
                          "device_events": n_events, "top_device_ms": top_events,
                          "idle_share_of_profiled_step": 1.0 - busy_ms / profiled_wall_ms,
                          "idle_share_vs_p50_step": 1.0 - busy_ms / p50_ms},
    }
    log(f"train timed: p50 {p50_ms:.1f} ms/step, device busy {busy_ms:.1f} ms")

    # (b) the loss falls: constant_lr on one fixed batch
    params = init_params(backbone.model_spec(cfg), device, SEED)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr_peak=LOSS_FALL_LR, schedule=constant_lr)
    batch = to_dev(next(make_data_iter(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)))
    fall = []
    for i in range(LOSS_FALL_STEPS):
        o = step_fn(params, opt, batch, i)
        params, opt = o.params, o.opt_state
        fall.append(float(o.metrics["loss"]))
    del params, opt, o
    if not all(np.isfinite(fall)) or not fall[-1] < fall[0]:
        raise AssertionError(f"train: the loss did not fall on a fixed batch: {fall}")
    log(f"train loss on a fixed batch: {fall[0]:.4f} -> {fall[-1]:.4f}")

    # (c) crash, restart, resume on the reduced config, on the card
    rcfg = reduced(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    mk_iter = lambda step: make_data_iter(rcfg, RESUME_BATCH, RESUME_SEQ, start_step=step)
    with tempfile.TemporaryDirectory() as d:
        tc = dict(ckpt_dir=d, max_steps=RESUME_STEPS, ckpt_every=RESUME_CKPT_EVERY)
        try:
            Trainer(rcfg, TrainerConfig(fail_at_step=RESUME_FAIL_AT, **tc), mk_iter, device).run()
        except SimulatedFailure:
            pass
        else:
            raise AssertionError("train: the injected failure did not fire")
        t2 = Trainer(rcfg, TrainerConfig(**tc), mk_iter, device)
        resumed = t2.run()
    want_from = (RESUME_FAIL_AT - 1) // RESUME_CKPT_EVERY * RESUME_CKPT_EVERY
    if t2.resumed_from != want_from or resumed["final_step"] != RESUME_STEPS \
            or not np.isfinite(resumed["final_loss"]):
        raise AssertionError(f"train: resume from {t2.resumed_from} ended {resumed}")
    summary = {
        "timed": timed,
        "loss_fall": {"steps": LOSS_FALL_STEPS, "lr": LOSS_FALL_LR, "losses": fall},
        "resume": {"layers": RESUME_LAYERS, "fail_at": RESUME_FAIL_AT,
                   "resumed_from": t2.resumed_from, "final_step": resumed["final_step"],
                   "final_loss": resumed["final_loss"]},
        "launches": launches,
    }
    return summary, recorded


# ----------------------------------------------------------------------------
# LM-family and training-stack phase
# ----------------------------------------------------------------------------


def lm_requests(vocab: int):
    """(rid, prompt, is_hot) from the seed: LM_PROMPT-token prompts, those
    flagged in LM_HOT one hot prompt (its first PAGE block is hit)."""
    rng = np.random.default_rng(SEED)
    hot = rng.integers(0, vocab, LM_PROMPT).tolist()
    return [(rid, list(hot) if is_hot else rng.integers(0, vocab, LM_PROMPT).tolist(), is_hot)
            for rid, is_hot in enumerate(LM_HOT)]


def detached(call):
    """A recorded attention call with its tensors cut from the autograd
    graph: the graph's leaves share the params' storage, which would
    otherwise outlive the trainer."""
    return tuple(x.detach() if hasattr(x, "detach") else x for x in call)


def launch_snapshot(lib) -> dict:
    return {n: lib.counter(n).launches for n in lib.SOURCES}


def launch_delta(lib, before: dict) -> dict:
    return {n: lib.counter(n).launches - before[n] for n in lib.SOURCES}


def peak_bytes(torch, device):
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None


def reset_peak(torch, device) -> None:
    """Free what the previous part left (its engine's admission hooks make a
    reference cycle that only the collector breaks), then restart the peak."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def clone_cache(cache):
    """A copy of a decode cache (a dict of cache NamedTuples and tensors)."""
    return {k: v.clone() if hasattr(v, "clone") else
            type(v)(*(None if x is None else x.clone() for x in v)) for k, v in cache.items()}


def cache_tensors(cache):
    return [x for v in cache.values() for x in ((v,) if hasattr(v, "clone") else v)
            if x is not None]


def serve_arch(torch, core, lib, device, cfg, reqs, engine, max_new, b7_per_step, *,
               pipelined=False):
    """One arch served at its published width: a serial run of ``reqs``
    (checked as the serve phase checks its runs); B7 launched
    ``b7_per_step`` times a model step; one decode step run twice from
    copies of the same cache with the same tokens gives bit-equal logits
    and caches; the step's wall time against its CUDA-graph replay; with
    ``pipelined``, a pipelined run too, whose tokens must equal the serial
    run's.  Returns the summary and the serial run's last model step's B7
    calls."""
    import repro_torch.serve as serve
    from repro_torch.models import backbone
    from repro_torch.models.params import count_params, init_params

    on_card = device.type == "cuda"
    attn = lib.counter("decode_attention")
    reset_peak(torch, device)
    t0 = time.perf_counter()
    params = init_params(backbone.model_spec(cfg), device, SEED)
    if on_card:
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    steps = [0]
    forward_decode = backbone.forward_decode

    def counted(*args, **kw):
        steps[0] += 1
        return forward_decode(*args, **kw)

    before = launch_snapshot(lib)
    attn.calls = collections.deque(maxlen=max(1, b7_per_step))
    backbone.forward_decode = counted
    try:
        eng, run, tokens = serve_run(torch, core, serve, cfg, params, device, pipelined=False,
                                     n_requests=len(reqs), max_new=max_new, on_stream_sync=True,
                                     reqs=reqs, engine=engine)
    finally:
        backbone.forward_decode = forward_decode
    launches = launch_delta(lib, before)
    recorded = list(attn.calls)
    attn.calls = None
    log(f"{cfg.name} serve: {run['wall_s']:.1f}s, {steps[0]} model steps")
    if launches["decode_attention"] != b7_per_step * steps[0]:
        raise AssertionError(f"{cfg.name} serve: decode_attention launched "
                             f"{launches['decode_attention']} times in {steps[0]} model steps, "
                             f"not {b7_per_step} a step")

    # the same decode step twice, from copies of the same cache
    tok = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, eng.max_batch),
                          dtype=torch.int32, device=device)
    pos = len(reqs[0][1]) + max_new
    b7 = attn.launches
    first, c1 = backbone.forward_decode(eng.params, clone_cache(eng.cache), tok, pos, cfg)
    per_step = attn.launches - b7
    second, c2 = backbone.forward_decode(eng.params, clone_cache(eng.cache), tok, pos, cfg)
    if per_step != b7_per_step:
        raise AssertionError(f"{cfg.name} serve: one decode step launched decode_attention "
                             f"{per_step} times, not {b7_per_step}")
    if not bool(torch.isfinite(first).all()):
        raise AssertionError(f"{cfg.name} serve: a decode step gave non-finite logits")
    if not (torch.equal(first, second)
            and all(torch.equal(a, b) for a, b in zip(cache_tensors(c1), cache_tensors(c2)))):
        raise AssertionError(f"{cfg.name} serve: the same decode step gave other logits or "
                             f"caches (max |diff| {float((first - second).abs().max())})")
    del first, second, c1, c2
    step = decode_step_timing(torch, backbone, eng) if on_card else None
    peak = peak_bytes(torch, device)
    del eng
    summary = {
        "params": count_params(backbone.model_spec(cfg)),
        "param_init_s": init_s,
        "serial": run,
        "model_steps": steps[0],
        "decode_attention_per_step": per_step,
        "decode_step_repeat_bit_equal": True,
        "decode_step": step,
        "launches": launches,
        "max_memory_allocated": peak,
    }
    if pipelined:
        before = launch_snapshot(lib)
        eng, piped, piped_tokens = serve_run(torch, core, serve, cfg, params, device,
                                             pipelined=True, n_requests=len(reqs),
                                             max_new=max_new, reqs=reqs, engine=engine)
        del eng
        log(f"{cfg.name} serve pipelined: {piped['wall_s']:.1f}s")
        if piped_tokens != tokens:
            raise AssertionError(f"{cfg.name} serve: serial and pipelined runs gave other tokens")
        summary["pipelined"] = piped
        summary["launches_pipelined"] = launch_delta(lib, before)
        summary["pipelined_tokens_equal_serial"] = True
    return summary, recorded


def run_lm_serve(torch, core, lib, device, cfg):
    """granite-moe-3b-a800m served at its published width and depth: one
    serial run of the LM_HOT requests (``serve_arch``; B7 once a layer a
    model step), whose prefix cache must be hit.  Returns the summary and
    the run's last B7 call."""
    reqs = lm_requests(cfg.vocab)
    summary, recorded = serve_arch(torch, core, lib, device, cfg, reqs, LM_SERVE_ENGINE,
                                   LM_MAX_NEW, cfg.n_layers)
    if summary["serial"]["cache_hit_blocks"] <= 0:
        raise AssertionError("lm serve: the prefix cache was never hit")
    summary["config"] = {"arch": LM_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
                         "heads": cfg.n_heads, "kv_heads": cfg.n_kv, "experts": cfg.n_experts,
                         "top_k": cfg.top_k, "d_ff_expert": cfg.d_ff_expert, "vocab": cfg.vocab,
                         "dtype": cfg.dtype, **LM_SERVE_ENGINE, "requests": len(reqs), "prompt": LM_PROMPT,
                         "hot": list(LM_HOT), "max_new": LM_MAX_NEW, "seed": SEED}
    return summary, recorded[-1]


def train_arch(torch, lib, device, arch, batch_size, seq, b6_per_forward):
    """One arch trained at its published width and depth: the Trainer that
    ``python -m repro_torch.launch.train --arch <arch> --batch <batch_size>
    --seq <seq>`` builds, its train step driven directly (``Trainer.run``
    would end by saving the fp32 params and AdamW state):
    LM_WARMUP_STEPS + LM_TIMED_STEPS steps, B6 ``b6_per_forward`` times a
    step (none in the backward), one profiled step, then LM_FALL_STEPS
    steps at a constant LM_FALL_LR on one fixed batch, whose loss must
    fall.  Returns the summary and the last timed step's B6 calls."""
    import tempfile

    from repro_torch.data import make_data_iter
    from repro_torch.launch import train as launch
    from repro_torch.optim import constant_lr
    from repro_torch.train import make_train_step

    flash = lib.counter("flash_attention")
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    to_dev = lambda batch: {k: torch.from_numpy(x).to(device) for k, x in batch.items()}
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", arch, "--batch", str(batch_size), "--seq", str(seq), "--ckpt", ckpt]
        reset_peak(torch, device)
        t0 = time.perf_counter()
        trainer = launch.build_trainer(launch.parse_args(argv), device)
        sync()
        init_s = time.perf_counter() - t0
        cfg = trainer.cfg
        after_init = peak_bytes(torch, device)
        it = make_data_iter(cfg, batch_size, seq)
        before = launch_snapshot(lib)
        flash.calls = collections.deque(maxlen=max(1, b6_per_forward))
        times, losses = [], []
        for i in range(LM_WARMUP_STEPS + LM_TIMED_STEPS):
            batch = to_dev(next(it))
            sync()
            b6 = flash.launches
            t0 = time.perf_counter()
            out = trainer.step_fn(trainer.params, trainer.opt, batch, i)
            loss = float(out.metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            trainer.params, trainer.opt = out.params, out.opt_state
            if flash.launches - b6 != b6_per_forward:
                raise AssertionError(f"{arch} train: step {i} launched flash_attention "
                                     f"{flash.launches - b6} times, not {b6_per_forward} a forward")
            if not (np.isfinite(loss) and np.isfinite(float(out.metrics["grad_norm"]))):
                raise AssertionError(f"{arch} train: step {i}: loss {loss}, grad norm "
                                     f"{float(out.metrics['grad_norm'])}")
            losses.append(loss)
            if i >= LM_WARMUP_STEPS:
                times.append(dt)
        launches = launch_delta(lib, before)
        recorded = [detached(c) for c in flash.calls]
        flash.calls = None
        peak = peak_bytes(torch, device)
        log(f"{arch} train: p50 {np.percentile(times, 50) * 1e3:.1f} ms/step, peak "
            f"{(peak or 0) / 1e9:.1f} GB")

        batch = to_dev(next(it))
        sync()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = trainer.step_fn(trainer.params, trainer.opt, batch, len(losses))
            float(out.metrics["loss"])
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_events, top_events = device_busy_ms(torch, prof)
        del prof

        fall_step = make_train_step(cfg, lr_peak=LM_FALL_LR, schedule=constant_lr, donate=True)
        fixed = to_dev(next(make_data_iter(cfg, batch_size, seq, seed=SEED + 1)))
        fall = []
        for i in range(LM_FALL_STEPS):
            out = fall_step(trainer.params, trainer.opt, fixed, i)
            fall.append(float(out.metrics["loss"]))
        del trainer, out, batch, fixed
    if on_card:
        torch.cuda.empty_cache()
    if not all(np.isfinite(fall)) or not fall[-1] < fall[0]:
        raise AssertionError(f"{arch} train: the loss did not fall on a fixed batch: {fall}")
    p50 = float(np.percentile(times, 50))
    summary = {
        "config": {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
                   "remat": cfg.remat, "batch": batch_size, "seq": seq,
                   "schedule": "warmup_cosine, peak 3e-4 (the launcher's)", "seed": SEED},
        "init_s": init_s,
        "max_memory_after_init": after_init,
        "losses": losses,
        "sec_per_step": times,
        "sec_per_step_p50": p50,
        "tokens_per_s": batch_size * seq * len(times) / float(np.sum(times)),
        "max_memory_allocated": peak,
        "launches": launches,
        "profiled_step": {"wall_ms": profiled_wall_ms, "device_busy_ms": busy_ms,
                          "device_events": n_events, "top_device_ms": top_events,
                          "busy_share_of_profiled_step": busy_ms / profiled_wall_ms,
                          "idle_share_of_profiled_step": 1.0 - busy_ms / profiled_wall_ms,
                          "idle_share_vs_p50_step": 1.0 - busy_ms / (p50 * 1e3)},
        "loss_fall": {"steps": LM_FALL_STEPS, "lr": LM_FALL_LR, "losses": fall},
    }
    return summary, recorded


def run_lm_train(torch, lib, device):
    """granite-moe-3b-a800m trained at its published width and depth
    (``train_arch`` at batch LM_TRAIN_BATCH x LM_TRAIN_SEQ; B6 once a layer
    a step).  Returns the summary and the last timed B6 call."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    summary, recorded = train_arch(torch, lib, device, LM_ARCH, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                   cfg.n_layers)
    summary["config"].update(experts=cfg.n_experts, top_k=cfg.top_k)
    return summary, recorded[-1]


def run_mla_path(torch, device):
    """reduced deepseek-v3-671b on the card (2 layers, a dense one first,
    the shared expert, MLA, remat="dots", bf16 compute): one train step's
    loss and every grad finite, then MLA_DECODE_STEPS decode steps over the
    latent cache with finite logits."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_data_iter
    from repro_torch.models import backbone, reduced
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg = reduced(get_config(MLA_ARCH), dtype="bfloat16")
    params = init_params(backbone.model_spec(cfg), device, SEED)
    batch = {k: torch.from_numpy(x).to(device)
             for k, x in next(make_data_iter(cfg, MLA_BATCH, MLA_SEQ, seed=SEED)).items()}
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = backbone.loss_fn(live, batch, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    if not bool(torch.isfinite(loss)) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"mla: loss {float(loss)} or a grad is not finite")
    cache = backbone.init_cache(cfg, MLA_BATCH, MLA_SEQ, device)
    if cache["layers"].v is not None or cache["dense_layers"].v is not None:
        raise AssertionError("mla: the latent cache holds a v")
    cp = backbone.compute_params(params, cfg)
    tok = batch["tokens"][:, 0]
    finite = []
    for pos in range(MLA_DECODE_STEPS):
        logits, cache = backbone.forward_decode(cp, cache, tok, pos, cfg)
        finite.append(bool(torch.isfinite(logits).all()))
        tok = torch.argmax(logits, -1)
    if not all(finite):
        raise AssertionError(f"mla: decode logits not finite: {finite}")
    return {"config": {"arch": MLA_ARCH, "reduced": True, "layers": cfg.n_layers,
                       "first_k_dense": cfg.first_k_dense, "n_shared": cfg.n_shared,
                       "attn": cfg.attn, "remat": cfg.remat, "dtype": cfg.dtype,
                       "batch": MLA_BATCH, "seq": MLA_SEQ},
            "loss": float(loss.detach()), "grad_leaves": len(grads),
            "decode_steps": MLA_DECODE_STEPS,
            "latent_cache": list(cache["layers"].k.shape)}


def run_embed_path(torch, device):
    """``embed_elim_update`` against ``embed_occ_update`` on qwen2-0.5b's
    embedding table with a Zipf(1.3) batch of the training stream: both
    tables within each touched row's summation-order bound of a float64 sum
    of the same updates, every other row unchanged, the statistics exact."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_data_iter
    from repro_torch.optim.sparse import embed_elim_update, embed_occ_update

    cfg = get_config(EMBED_ARCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    table = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=device) * cfg.d_model ** -0.5
    ids_np = next(make_data_iter(cfg, EMBED_BATCH, EMBED_SEQ, seed=SEED))["tokens"].reshape(-1)
    ids = torch.from_numpy(ids_np).to(device)
    grads = torch.randn((ids.numel(), cfg.d_model), generator=gen, device=device)
    new, stats = embed_elim_update(table, ids, grads, EMBED_LR)
    occ = embed_occ_update(table, ids, grads, EMBED_LR)
    uniq, inv, count = np.unique(ids_np, return_inverse=True, return_counts=True)
    rows = torch.from_numpy(uniq).to(device).long()
    t64 = table[rows].double().cpu().numpy()
    # the rate as the f32 products see it
    g64 = float(np.float32(EMBED_LR)) * grads.double().cpu().numpy()
    want = t64.copy()
    np.add.at(want, inv, -g64)
    mag = np.zeros_like(t64)
    np.add.at(mag, inv, np.abs(g64))
    bound = (count[:, None] + 1) * 2.0**-24 * (mag + np.abs(t64))
    untouched = torch.ones(cfg.vocab, dtype=torch.bool, device=device)
    untouched[rows] = False
    worst = {}
    for name, got in (("elim", new), ("occ", occ)):
        err = np.abs(got[rows].double().cpu().numpy() - want)
        if not np.all(err <= bound):
            raise AssertionError(f"embed {name}: a row is off its float64 sum by more than its "
                                 f"bound (max err / bound {float(np.max(err / bound))})")
        if not torch.equal(got[untouched], table[untouched]):
            raise AssertionError(f"embed {name}: a row no id names changed")
        worst[name] = float(np.max(err / bound))
    n_unique, t = int(uniq.size), int(ids_np.size)
    if (int(stats.writes_occ), int(stats.writes_elim), int(stats.eliminated)) != \
            (t, n_unique, t - n_unique):
        raise AssertionError(f"embed: stats {stats} for {t} ids, {n_unique} unique")
    elim_ms = time_ms(torch, lambda: embed_elim_update(table, ids, grads, EMBED_LR), 20)
    occ_ms = time_ms(torch, lambda: embed_occ_update(table, ids, grads, EMBED_LR), 20)
    return {"table": [cfg.vocab, cfg.d_model], "ids": t, "unique": n_unique,
            "hottest_id_count": int(count.max()), "lr": EMBED_LR,
            "writes_occ": t, "writes_elim": n_unique, "eliminated": t - n_unique,
            "write_reduction": t / n_unique, "max_err_over_bound": worst,
            "elim_ms": elim_ms, "occ_ms": occ_ms}


def dedup_batch(rng, width: int, history: list, vocab: int, zipf_keys) -> list:
    """``width`` documents: DEDUP_HISTORY_FRAC repeat an earlier batch's
    (Zipf(DEDUP_ZIPF) over the history, the first documents hottest),
    DEDUP_INBATCH_FRAC an earlier one of this batch, the rest new ones of
    DEDUP_MIN_TOKENS to DEDUP_MAX_TOKENS Zipf(1.3) tokens."""
    u = rng.random(width)
    kind = np.where(u < DEDUP_HISTORY_FRAC, 0, np.where(u < DEDUP_HISTORY_FRAC + DEDUP_INBATCH_FRAC,
                                                        1, 2))
    if not history:
        kind[kind == 0] = 2
    kind[0] = 2 if kind[0] == 1 else kind[0]
    lengths = rng.integers(DEDUP_MIN_TOKENS, DEDUP_MAX_TOKENS + 1, int((kind == 2).sum()))
    toks = (np.minimum(rng.zipf(1.3, int(lengths.sum())), vocab) - 1).astype(np.int32)
    fresh = iter(np.split(toks, np.cumsum(lengths)[:-1]))
    old = iter(zipf_keys(rng, int((kind == 0).sum()), max(len(history), 1), DEDUP_ZIPF))
    docs = []
    for k in kind:
        if k == 0:
            docs.append(history[int(next(old))])
        elif k == 1:
            docs.append(docs[int(rng.integers(len(docs)))])
        else:
            docs.append(next(fresh))
    return docs


def run_dedup_path(torch, core, lib, device, zipf_keys):
    """``DedupIndex`` in elim mode on the card: DEDUP_BATCHES batches, the
    first DEDUP_FIRST_WIDTH documents wide (it goes into an empty tree,
    where the retry passes grow with the round's width), the rest
    DEDUP_WIDTH; every keep list equal to a Python set fed the same stream,
    the tree sound and holding exactly the hashes seen."""
    from repro_torch.configs import get_config
    from repro_torch.data import DedupIndex, content_hash

    vocab = get_config(EMBED_ARCH).vocab
    rng = np.random.default_rng(SEED)
    idx = DedupIndex(capacity=DEDUP_CAPACITY, device=device)
    seen, history = set(), []
    before = launch_snapshot(lib)
    filter_s, n_docs, gen_s = 0.0, 0, 0.0
    for i in range(DEDUP_BATCHES):
        t0 = time.perf_counter()
        docs = dedup_batch(rng, DEDUP_FIRST_WIDTH if i == 0 else DEDUP_WIDTH, history, vocab,
                           zipf_keys)
        gen_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        keep, stats = idx.filter_batch(docs)
        filter_s += time.perf_counter() - t0
        want = []
        for n, d in enumerate(docs):
            h = content_hash(d)
            if h not in seen:
                seen.add(h)
                want.append(n)
        if keep != want:
            raise AssertionError(f"dedup batch {i}: keep list differs from the set's")
        history.extend(docs)
        n_docs += len(docs)
    launches = launch_delta(lib, before)
    core.check_invariants(idx.tree.state, idx.tree.cfg)
    if set(idx.tree.items()) != seen:
        raise AssertionError("dedup: the index does not hold exactly the hashes seen")
    for name in ("descend_probe", "elim_combine"):
        if launches[name] <= 0:
            raise AssertionError(f"dedup: {name} never launched")
    log(f"dedup: {n_docs} docs in {filter_s:.1f}s")
    return {"batches": DEDUP_BATCHES, "width": DEDUP_WIDTH, "first_width": DEDUP_FIRST_WIDTH,
            "history_frac": DEDUP_HISTORY_FRAC, "in_batch_frac": DEDUP_INBATCH_FRAC,
            "docs": n_docs, "unique": len(seen), "duplicates": stats["duplicates"],
            "rounds": stats["rounds"], "retry_passes": idx.tree.metrics.value("retry_passes"),
            "eliminated": stats["eliminated"], "filter_s": filter_s, "docs_per_s": n_docs / filter_s,
            "generate_s": gen_s, "launches": launches}


def run_quant_path(torch, device):
    """``quantize_int8`` on QUANT_N seeded f32 values: q and the scales
    bit-equal to the port's CPU result on the same input, the round trip
    within max|x|/127; then EF_STEPS of ``_ef_quantize`` whose applied sum
    is within max|g| of EF_STEPS·g."""
    from repro_torch.parallel import compress

    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(QUANT_N, generator=gen, device=device)
    q, scale = compress.quantize_int8(x)
    q_cpu, scale_cpu = compress.quantize_int8(x.cpu())
    if not (torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)):
        raise AssertionError("quantize_int8: the card's payload or scales differ from the CPU's")
    err = float((compress.dequantize_int8(q, scale, x.shape, torch.float32) - x).abs().max())
    limit = float(x.abs().max()) / 127.0
    if err > limit:
        raise AssertionError(f"quantize_int8: round trip off by {err} > max|x|/127 = {limit}")
    quant_ms = time_ms(torch, lambda: compress.quantize_int8(x), 10)
    g = torch.randn(EF_N, generator=gen, device=device) * 1e-3
    residual, applied = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(EF_STEPS):
        q, scale, residual = compress._ef_quantize(g, residual)
        applied += compress.dequantize_int8(q, scale, g.shape, g.dtype)
    drift = float((applied - EF_STEPS * g).abs().max())
    if drift > float(g.abs().max()):
        raise AssertionError(f"_ef_quantize: applied sum off by {drift} > max|g|")
    return {"n": QUANT_N, "max_abs_err": err, "limit": limit, "bit_equal_to_cpu": True,
            "quantize_ms": quant_ms, "ef_n": EF_N, "ef_steps": EF_STEPS, "ef_drift": drift,
            "ef_limit": float(g.abs().max())}


def run_lm_family_path(torch, core, lib, device, zipf_keys):
    """The LM-family and training-stack phase; its launch counts are zeroed
    before it and read after it.  Returns the summary and the granite B6
    and B7 calls recorded on it."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    lib.reset_counts()
    out, peaks, held = {}, {}, {}
    on_card = device.type == "cuda"
    reset_peak(torch, device)
    held["serve"] = int(torch.cuda.memory_allocated(device)) if on_card else None
    out["serve"], b7_call = run_lm_serve(torch, core, lib, device, get_config(LM_ARCH))
    peaks["serve"] = out["serve"]["max_memory_allocated"]
    reset_peak(torch, device)
    held["train"] = int(torch.cuda.memory_allocated(device)) if on_card else None
    out["train"], b6_call = run_lm_train(torch, lib, device)
    peaks["train"] = out["train"]["max_memory_allocated"]
    for name, fn in (("mla", lambda: run_mla_path(torch, device)),
                     ("embed", lambda: run_embed_path(torch, device)),
                     ("dedup", lambda: run_dedup_path(torch, core, lib, device, zipf_keys)),
                     ("quant", lambda: run_quant_path(torch, device))):
        reset_peak(torch, device)
        held[name] = int(torch.cuda.memory_allocated(device)) if on_card else None
        t1 = time.perf_counter()
        out[name] = fn()
        out[name]["seconds"] = time.perf_counter() - t1
        peaks[name] = peak_bytes(torch, device)
        log(f"lm phase {name}: {out[name]['seconds']:.1f}s")
    out["launches"] = launch_snapshot(lib)
    out["max_memory_allocated"] = peaks
    out["memory_allocated_at_start"] = held  # what earlier phases still hold
    out["seconds"] = time.perf_counter() - t0
    log(f"lm phase: {out['seconds']:.1f}s, peaks {peaks}")
    return out, {"flash_attention": b6_call, "decode_attention": b7_call}


# ----------------------------------------------------------------------------
# ssm, hybrid and audio phase
# ----------------------------------------------------------------------------


def family_requests(vocab: int):
    """(rid, prompt, is_hot) from the seed: FAMILY_REQUESTS distinct
    FAMILY_PROMPT-token prompts (shorter than a PAGE block: no prefix hit)."""
    rng = np.random.default_rng(SEED)
    return [(rid, rng.integers(0, vocab, FAMILY_PROMPT).tolist(), False)
            for rid in range(FAMILY_REQUESTS)]


def b6_per_forward(cfg) -> int:
    """B6 launches in one forward of a family arch: zamba2's shared block
    invocations, whisper's encoder and decoder self-attention layers."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "audio":
        return cfg.enc_layers + cfg.n_layers
    return 0  # xLSTM attends nowhere


def b7_per_step(cfg) -> int:
    """B7 launches in one decode step (whisper: self and cross a layer)."""
    return 2 * cfg.n_layers if cfg.family == "audio" else b6_per_forward(cfg)


def run_xlstm_grad(torch, device, cfg):
    """xlstm-350m at full width: one loss and gradient at XLSTM_GRAD_SHAPE
    (all of them finite), then ``mlstm_train_chunked`` (chunk XLSTM_CHUNK)
    against ``mlstm_train`` on block 0's cell and a seeded f32 input, within
    CHUNKED_TOL."""
    from repro_torch.data import make_data_iter
    from repro_torch.models import backbone, xlstm
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import tree_leaves, tree_map

    b, t = XLSTM_GRAD_SHAPE
    reset_peak(torch, device)
    params = init_params(backbone.model_spec(cfg), device, SEED)
    batch = {k: torch.from_numpy(x).to(device)
             for k, x in next(make_data_iter(cfg, b, t, seed=SEED)).items()}
    t0 = time.perf_counter()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = backbone.loss_fn(live, batch, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    grad_s = time.perf_counter() - t0  # the checks above wait for the step
    if not finite:
        raise AssertionError(f"xlstm: loss {float(loss)} or a grad is not finite")
    peak = peak_bytes(torch, device)
    del live, grads
    f32 = cfg.replace(dtype="float32")
    cell = {k: v[0] for k, v in params["mblocks"]["cell"].items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((b, t, cfg.d_model), generator=gen, device=device)
    with torch.no_grad():
        seq = xlstm.mlstm_train(cell, x, f32)
        chunked = xlstm.mlstm_train_chunked(cell, x, f32, chunk=XLSTM_CHUNK)
        err = (chunked - seq).abs()
        if not bool((err <= CHUNKED_TOL + CHUNKED_TOL * seq.abs()).all()):
            raise AssertionError(f"xlstm: the chunked mLSTM differs from the step-by-step "
                                 f"form by {float(err.max())}")
        seq_ms = time_ms(torch, lambda: xlstm.mlstm_train(cell, x, f32), 3, warmup=1)
        chunked_ms = time_ms(torch, lambda: xlstm.mlstm_train_chunked(cell, x, f32,
                                                                      chunk=XLSTM_CHUNK), 3, warmup=1)
    loss = float(loss.detach())
    log(f"xlstm grad: {grad_s:.1f}s, loss {loss:.4f}, peak {(peak or 0) / 1e9:.1f} GB")
    return {"batch": b, "seq": t, "loss": loss, "grad_leaves": len(tree_leaves(params)),
            "loss_and_grad_s": grad_s, "max_memory_allocated": peak,
            "chunked": {"chunk": XLSTM_CHUNK, "dtype": "float32", "max_abs_err": float(err.max()),
                        "max_abs_want": float(seq.abs().max()), "tolerance": CHUNKED_TOL,
                        "step_by_step_ms": seq_ms, "chunked_ms": chunked_ms}}


def run_card_vs_cpu(torch, device, arch):
    """A FAMILY_CHECK["layers"]-layer model of ``arch`` at full width in f32
    with the same params on the card and on the CPU: ``forward_train`` and
    FAMILY_CHECK["steps"] decode steps (every cache entry too) within
    CARD_CPU_TOL; each decode step, repeated on the card from a copy of the
    same cache, is bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_data_iter
    from repro_torch.models import backbone
    from repro_torch.models.params import init_params

    cfg = get_config(arch).replace(n_layers=FAMILY_CHECK["layers"], dtype="float32",
                                   **FAMILY_CHECK_OVERRIDES[arch])
    cpu = torch.device("cpu")
    params = init_params(backbone.model_spec(cfg), cpu, SEED)
    batch = next(make_data_iter(cfg, FAMILY_CHECK["batch"], FAMILY_CHECK["seq"], seed=SEED))
    outs = []
    for dev in (cpu, device):
        p = tree_to(params, dev)
        b = {k: torch.from_numpy(x).to(dev) for k, x in batch.items()}
        extra = {k: v for k, v in b.items() if k != "tokens"} or None
        t0 = time.perf_counter()
        with torch.no_grad():
            got = [backbone.forward_train(p, b["tokens"], cfg, extra)]
            cache = backbone.init_cache(cfg, FAMILY_CHECK["batch"], FAMILY_CHECK["seq"], dev)
            for pos in range(FAMILY_CHECK["steps"]):
                tok = b["tokens"][:, pos]
                again = (backbone.forward_decode(p, clone_cache(cache), tok, pos, cfg)
                         if dev is device else None)
                lg, cache = backbone.forward_decode(p, cache, tok, pos, cfg)
                got.append(lg)
                if again is not None and not (torch.equal(again[0], lg) and all(
                        torch.equal(x, y)
                        for x, y in zip(cache_tensors(again[1]), cache_tensors(cache)))):
                    raise AssertionError(f"{arch}: decode step {pos} repeated on the card differs")
        outs.append((got, cache_tensors(cache), time.perf_counter() - t0))
    (want, want_c, cpu_s), (got, got_c, card_s) = outs
    worst = {}
    for name, xs, ys in (("logits", got, want), ("cache", got_c, want_c)):
        for i, (x, y) in enumerate(zip(xs, ys)):
            x = x.cpu().float()
            y = y.float()
            err = (x - y).abs()
            if not bool((err <= CARD_CPU_TOL + CARD_CPU_TOL * y.abs()).all()):
                raise AssertionError(f"{arch}: card and CPU differ in {name}[{i}] by "
                                     f"{float(err.max())} (max |cpu| {float(y.abs().max())})")
            worst[name] = max(worst.get(name, 0.0), float(err.max()))
    return {"config": {"layers": cfg.n_layers, **FAMILY_CHECK_OVERRIDES[arch],
                       "dtype": cfg.dtype, "batch": FAMILY_CHECK["batch"],
                       "seq": FAMILY_CHECK["seq"], "decode_steps": FAMILY_CHECK["steps"]},
            "tolerance": CARD_CPU_TOL, "max_abs_err": worst,
            "max_abs_logit": float(max(float(y.abs().max()) for y in want)),
            "decode_repeat_bit_equal": True, "cpu_s": cpu_s, "card_s": card_s}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def run_family_path(torch, core, lib, device):
    """The ssm, hybrid and audio phase; its launch counts are zeroed before
    it and read after it.  Each arch is served (``serve_arch``); zamba2 and
    whisper are trained (``train_arch``), xlstm takes one loss and gradient
    step (``run_xlstm_grad``); each runs a 2-layer full-width model on the
    card against the CPU (``run_card_vs_cpu``).  Returns the summary and the
    B6 and B7 calls recorded for the kernel rows: zamba2's and whisper's
    last B6 calls (whisper's encoder one, not causal over its 1,500
    frames), zamba2's B7 call (group 1) and whisper's two (self and cross,
    ``kv_len`` = 1,500)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    lib.reset_counts()
    out, recorded = {}, {}
    for arch in FAMILY_ARCHS:
        t1 = time.perf_counter()
        cfg = get_config(arch)
        engine = dict(FAMILY_ENGINE, s_max=FAMILY_S_MAX.get(arch, FAMILY_ENGINE["s_max"]))
        part = {"config": {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
                           "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv,
                           "vocab": cfg.vocab, "dtype": cfg.dtype, **engine,
                           "requests": FAMILY_REQUESTS, "prompt": FAMILY_PROMPT,
                           "max_new": FAMILY_MAX_NEW, "seed": SEED}}
        part["serve"], b7 = serve_arch(torch, core, lib, device, cfg, family_requests(cfg.vocab),
                                       engine, FAMILY_MAX_NEW, b7_per_step(cfg),
                                       pipelined=arch in FAMILY_PIPELINED)
        if arch in FAMILY_TRAIN:
            part["train"], b6 = train_arch(torch, lib, device, arch, *FAMILY_TRAIN[arch],
                                           b6_per_forward(cfg))
            if cfg.family == "audio":  # the encoder's call; B7 over the frames and the self one
                b6 = [c for c in b6 if not c[3]["causal"]]
                cross = [c for c in b7 if c[1].shape[2] == cfg.enc_frames]
                recorded[f"decode_attention@{arch} self"] = \
                    [c for c in b7 if c[1].shape[2] != cfg.enc_frames][-1]
                b7 = cross
            recorded[f"flash_attention@{arch}"] = b6[-1]
            recorded[f"decode_attention@{arch}"] = b7[-1]
        else:
            part["grad"] = run_xlstm_grad(torch, device, cfg)
        part["card_vs_cpu"] = run_card_vs_cpu(torch, device, arch)
        part["seconds"] = time.perf_counter() - t1
        out[arch] = part
        log(f"family phase {arch}: {part['seconds']:.1f}s, card vs CPU "
            f"{part['card_vs_cpu']['max_abs_err']}")
    out["launches"] = launch_snapshot(lib)
    for name in ("decode_attention", "flash_attention", "descend_probe", "elim_combine"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"family phase: {name} never launched")
    out["seconds"] = time.perf_counter() - t0
    log(f"family phase: {out['seconds']:.1f}s")
    return out, recorded


# ----------------------------------------------------------------------------
# the parallel layer on a 1-rank mesh
# ----------------------------------------------------------------------------


def _spawn(tag, cell, cmd, env=None):
    """Start ``cmd`` (a list; ``{out}`` in it names the JSON file it writes)
    from the checkout in a subprocess, to run beside the phases; killed at
    exit if still running."""
    import os
    import tempfile
    import weakref

    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name) / "out.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})}
    logs = (open(Path(tmp.name) / "stdout", "w"), open(Path(tmp.name) / "stderr", "w"))
    proc = subprocess.Popen([str(out) if c == "{out}" else c for c in cmd], stdout=logs[0],
                            stderr=logs[1], env=env, cwd=ROOT)
    weakref.finalize(proc, proc.kill)
    return tag, cell, proc, tmp, out, logs, time.perf_counter()


def _finish(run, timeout_s):
    """``(output file's JSON, standard output, seconds from the start)``,
    or None past ``timeout_s`` from its start (the subprocess is then
    killed)."""
    tag, cell, proc, tmp, out, logs, t0 = run
    try:
        try:
            proc.wait(timeout=max(0.0, timeout_s - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            return None
        for f in logs:
            f.close()
        stdout, stderr = ((Path(tmp.name) / n).read_text() for n in ("stdout", "stderr"))
        if proc.returncode != 0:
            raise AssertionError(f"{tag} {cell} failed:\n{stdout[-2000:]}\n{stderr[-3000:]}")
        data = json.loads(out.read_text()) if out.exists() else None
        return data, stdout, time.perf_counter() - t0
    finally:
        for f in logs:
            f.close()
        tmp.cleanup()


def start_dryrun(cell):
    """Start one dry-run cell by the CLI in a subprocess (its own fake world
    of 256 / 512 ranks, meta tensors, the host's CPU alone)."""
    arch, shape, mesh, suite = cell
    return _spawn("dry-run", cell, [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
        "--mesh", mesh, "--suite", suite, "--out", "{out}", "--force"])


def finish_dryrun(run, timeout_s):
    """The started cell's record, or None past ``timeout_s``."""
    done = _finish(run, timeout_s)
    if done is None:
        return None
    arch, shape, mesh, _ = run[1]
    rec = done[0][f"{arch}|{shape}|{mesh}"]
    rec["wall_s"] = done[2]
    if not rec.get("ok") or rec["status"] != "run" or rec["cost"]["flops"] <= 0:
        raise AssertionError(f"dry-run {run[1]}: {rec}")
    return rec


_CORRECT = """
import json, sys
from repro_torch.analysis.scan_correction import correct_cell
from repro_torch.configs.optimized import overrides_for
arch, shape, mesh, suite, out = sys.argv[1:]
ov = overrides_for(arch, shape) if suite == "opt" else None
with open(out, "w") as f:
    json.dump(correct_cell(arch, shape, mesh, overrides=ov), f)
"""


def start_correction(cell):
    """Start the depth-probe correction of one dry-run cell
    (``analysis.scan_correction.correct_cell``: the cell at the probe depths,
    full width) in a subprocess, one process for all its probes."""
    return _spawn("correction", cell, [sys.executable, "-c", _CORRECT, *cell, "{out}"])


def finish_correction(run, timeout_s):
    done = _finish(run, timeout_s)
    if done is None:
        return None
    corr = dict(done[0], wall_s=done[2])
    if not corr.get("corrected"):
        raise AssertionError(f"correction {run[1]}: {corr}")
    return corr


def run_parallel_path(torch, lib, device):
    """The parallel phase on the 1-rank ``("data", "model")`` NCCL mesh of
    ``make_host_mesh()``; its launch counts are zeroed before it and read
    after it.  qwen2-0.5b at full width: PARALLEL_STEPS train steps of the
    Trainer ``launch/train.py --mesh host`` builds against the mesh-free
    Trainer's from the same weights and batches (losses bit-equal, B6 24 a
    step on each); the mesh-free run's checkpoint restored onto the mesh
    (``--mesh host`` resuming it) and a third step on each, equal; the
    serve step (``make_serve_step``, its cache placed by
    ``cache_shardings``) against ``forward_decode``, logits and cache
    bit-equal, B7 24 a step on each; ``compressed_grad_reduce`` of qwen2's
    gradients over a (pod=1, data=1, model=1) mesh equal to
    ``dequantize_int8(_ef_quantize(...))`` on the card and on the CPU;
    ``pipeline_apply`` with one stage equal to the stage, its backward
    within PIPE_GRAD_TOL of the stage's gradients; granite's MoE
    layer (grouped, ``moe_groups=32``) under the mesh equal to the
    mesh-free path.  The process group is destroyed at the end.  Beside it
    all, in two subprocesses started first, the dry-run of DRYRUN_CELL and
    its depth-probe correction: returned in flight with the summary, for
    ``finish_dryruns``."""
    import tempfile

    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch._shardmap_compat import place
    from repro_torch.configs import get_config
    from repro_torch.configs.optimized import overrides_for
    from repro_torch.data import make_data_iter
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, shutdown
    from repro_torch.models import backbone, init_params, moe
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.parallel import compress
    from repro_torch.parallel.ctx import use_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import cache_shardings
    from repro_torch.train import make_serve_step

    t0 = time.perf_counter()
    pending = (start_dryrun(DRYRUN_CELL), start_correction(DRYRUN_CELL))
    lib.reset_counts()
    flash, decode = lib.counter("flash_attention"), lib.counter("decode_attention")
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    cfg = get_config(PARALLEL_ARCH)
    to_dev = lambda batch: {k: torch.from_numpy(x).to(device) for k, x in batch.items()}
    it = make_data_iter(cfg, PARALLEL_BATCH, PARALLEL_SEQ)
    batches = [to_dev(next(it)) for _ in range(PARALLEL_STEPS + 1)]
    out = {"config": {"arch": PARALLEL_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
                      "batch": PARALLEL_BATCH, "seq": PARALLEL_SEQ, "steps": PARALLEL_STEPS,
                      "mesh": "make_host_mesh(): 1 rank, (data=1, model=1), nccl"}}
    reset_peak(torch, device)
    mesh = make_host_mesh()
    try:
        def step(trainer, i):
            b6 = flash.launches
            sync()
            t1 = time.perf_counter()
            res = trainer.step_fn(trainer.params, trainer.opt, batches[i], i)
            loss = float(res.metrics["loss"])  # waits for the step
            walls.append(time.perf_counter() - t1)
            trainer.params, trainer.opt = res.params, res.opt_state
            trainer.step = i + 1
            return loss, flash.launches - b6

        walls = []

        with tempfile.TemporaryDirectory() as plain_dir, tempfile.TemporaryDirectory() as mesh_dir:
            argv = ["--arch", PARALLEL_ARCH, "--batch", str(PARALLEL_BATCH), "--seq",
                    str(PARALLEL_SEQ), "--steps", str(PARALLEL_STEPS + 1), "--ckpt"]
            plain = launch.build_trainer(launch.parse_args(argv + [plain_dir]), device)
            meshed = launch.build_trainer(launch.parse_args(argv + [mesh_dir, "--mesh", "host"]),
                                          device)
            if not all(isinstance(p, DTensor) for p in tree_leaves(meshed.params)):
                raise AssertionError("parallel: --mesh host left a param off the mesh")
            rows = []
            for i in range(PARALLEL_STEPS):
                lp, bp = step(plain, i)
                lm, bm = step(meshed, i)
                rows.append({"step": i, "loss_plain": lp, "loss_mesh": lm,
                             "b6_plain": bp, "b6_mesh": bm, "s_plain": walls[-2],
                             "s_mesh": walls[-1]})
                if lm != lp or bm != bp or bp != cfg.n_layers:
                    raise AssertionError(f"parallel train step {i}: {rows[-1]}")
            del meshed
            t1 = time.perf_counter()
            plain._save()
            save_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            restored = launch.build_trainer(launch.parse_args(argv + [plain_dir, "--mesh", "host"]),
                                            device)
            sync()
            restore_s = time.perf_counter() - t1
            if restored.resumed_from != PARALLEL_STEPS:
                raise AssertionError(f"parallel: resumed from {restored.resumed_from}")
            lp, bp = step(plain, PARALLEL_STEPS)
            lm, bm = step(restored, PARALLEL_STEPS)
            rows.append({"step": PARALLEL_STEPS, "loss_plain": lp, "loss_restored_on_mesh": lm,
                         "b6_plain": bp, "b6_mesh": bm, "s_plain": walls[-2],
                         "s_mesh": walls[-1]})
            if lm != lp or bm != bp:
                raise AssertionError(f"parallel: the restored step differs: {rows[-1]}")
            del restored
        out["train"] = {"steps": rows, "checkpoint_save_s": save_s,
                        "restore_onto_mesh_s": restore_s}
        log(f"parallel train: losses equal over {len(rows)} steps, save {save_s:.1f}s, "
            f"restore onto the mesh {restore_s:.1f}s")

        # the serve step, its cache placed by cache_shardings, against forward_decode
        params = plain.params
        with torch.no_grad():
            want_cache = backbone.init_cache(cfg, PARALLEL_BATCH, PARALLEL_SEQ, device)
            cache = place(backbone.init_cache(cfg, PARALLEL_BATCH, PARALLEL_SEQ, device),
                          cache_shardings(cfg, PARALLEL_BATCH, PARALLEL_SEQ, mesh))
            serve = make_serve_step(cfg, mesh, PARALLEL_BATCH, PARALLEL_SEQ)
            drows = []
            for pos in range(PARALLEL_DECODE_STEPS):
                tok = batches[0]["tokens"][:, pos]
                b7 = decode.launches
                sync()
                t1 = time.perf_counter()
                want, _ = backbone.forward_decode(params, want_cache, tok, pos, cfg)
                sync()
                t2 = time.perf_counter()
                b7_plain = decode.launches - b7
                b7 = decode.launches
                got, _ = serve(params, cache, tok, pos)
                got = got.full_tensor()
                sync()
                t3 = time.perf_counter()
                b7_mesh = decode.launches - b7
                equal = bool(torch.equal(got, want))
                drows.append({"pos": pos, "logits_equal": equal, "b7_plain": b7_plain,
                              "b7_mesh": b7_mesh, "ms_plain": (t2 - t1) * 1e3,
                              "ms_mesh": (t3 - t2) * 1e3})
                if not equal or b7_mesh != b7_plain or b7_plain != cfg.n_layers:
                    raise AssertionError(f"parallel serve step: {drows[-1]}")
            cache_equal = bool(torch.equal(cache["layers"].k.full_tensor(), want_cache["layers"].k))
            if not cache_equal:
                raise AssertionError("parallel serve: the placed cache differs from forward_decode's")
        out["serve"] = {"steps": drows, "cache_equal": cache_equal}
        del want_cache, cache

        # compressed_grad_reduce of qwen2's gradients over (pod=1, data=1, model=1)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = backbone.loss_fn(live, batches[0], cfg)
        grads = {str(i): g for i, g in enumerate(torch.autograd.grad(loss, tree_leaves(live)))}
        del live, loss, plain
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), device.type)
        err = compress.init_error_feedback(grads)
        t1 = time.perf_counter()
        mean, err2 = compress.compressed_grad_reduce(grads, err, mesh3)
        sync()
        reduce_ms = (time.perf_counter() - t1) * 1e3
        n_values, card_ok, cpu_ok = 0, True, True
        for k, g in grads.items():
            q, sc, e_new = compress._ef_quantize(g, err[k])
            card_ok &= torch.equal(mean[k], compress.dequantize_int8(q, sc, g.shape, g.dtype))
            card_ok &= torch.equal(err2[k], e_new)
            gc_, ec_ = g.cpu(), err[k].cpu()
            q, sc, _ = compress._ef_quantize(gc_, ec_)
            cpu_ok &= torch.equal(mean[k].cpu(), compress.dequantize_int8(q, sc, gc_.shape, gc_.dtype))
            n_values += g.numel()
        if not (card_ok and cpu_ok):
            raise AssertionError(f"compressed_grad_reduce: card {card_ok}, CPU {cpu_ok}")
        out["compressed_reduce"] = {"values": n_values, "leaves": len(grads), "ms": reduce_ms,
                                    "equal_on_card": card_ok, "equal_to_cpu": cpu_ok}
        del grads, err, mean, err2

        # a one-stage pipeline (the ring hand-off to itself) against the stage
        pmesh = make_mesh((1,), ("pod",), device.type)
        gen = torch.Generator(device=device).manual_seed(SEED)
        w = torch.randn((1, cfg.d_model, cfg.d_model), generator=gen, device=device) * 0.03
        xs = torch.randn((PARALLEL_PIPE["m"], PARALLEL_PIPE["b"], cfg.d_model), generator=gen,
                         device=device)
        body = lambda p, h: torch.tanh(h @ p["w"])
        piped = pipeline_apply({"w": w}, xs, body, pmesh)
        pipe_equal = bool(torch.equal(piped, torch.tanh(xs @ w[0])))
        if not pipe_equal:
            raise AssertionError("pipeline_apply with one stage differs from the stage")
        # its backward of sum(piped * g) against the stage's own gradients
        t1 = time.perf_counter()
        g = torch.randn(xs.shape, generator=gen, device=device)
        wg, xg = w.clone().requires_grad_(), xs.clone().requires_grad_()
        sync()
        t2 = time.perf_counter()
        grads = torch.autograd.grad((pipeline_apply({"w": wg}, xg, body, pmesh) * g).sum(),
                                    [wg, xg])
        sync()
        backward_ms = (time.perf_counter() - t2) * 1e3
        wr, xr = w.clone().requires_grad_(), xs.clone().requires_grad_()
        want_g = torch.autograd.grad((torch.tanh(xr @ wr[0]) * g).sum(), [wr, xr])
        grad_err = {n: float((a - b).abs().max()) for n, a, b in zip(("w", "xs"), grads, want_g)}
        grad_equal = {n: bool(torch.equal(a, b)) for n, a, b in zip(("w", "xs"), grads, want_g)}
        if max(grad_err.values()) > PIPE_GRAD_TOL:
            raise AssertionError(f"the one-stage pipeline's gradients differ from the stage's: "
                                 f"{grad_err} > {PIPE_GRAD_TOL}")
        out["pipeline"] = {"stages": 1, **PARALLEL_PIPE, "d": cfg.d_model, "equal": pipe_equal,
                           "grad_max_abs_err": grad_err, "grad_equal": grad_equal,
                           "grad_tolerance": PIPE_GRAD_TOL,
                           "forward_backward_ms": backward_ms,
                           "backward_check_s": time.perf_counter() - t1}
        del g, wg, xg, wr, xr, grads, want_g

        # granite's MoE layer, grouped, under the mesh against the mesh-free path
        mcfg = get_config(PARALLEL_MOE_ARCH).replace(
            **overrides_for(PARALLEL_MOE_ARCH, "train_4k"))
        mp = init_params(moe.moe_spec(mcfg), device, seed=SEED)
        xm = (torch.randn(PARALLEL_MOE_TOKENS + (mcfg.d_model,), generator=gen, device=device)
              .to(getattr(torch, mcfg.dtype)))
        with torch.no_grad():
            want = moe.moe_apply(mp, xm, mcfg)
            with use_mesh(mesh):
                got = moe.moe_apply(mp, distribute_tensor(xm, mesh, [Shard(0), Replicate()]), mcfg)
            moe_equal = bool(torch.equal(got.full_tensor(), want))
        if not moe_equal:
            raise AssertionError("parallel: the grouped MoE under the mesh differs")
        out["moe"] = {"arch": PARALLEL_MOE_ARCH, "moe_groups": mcfg.moe_groups,
                      "experts": mcfg.n_experts, "top_k": mcfg.top_k, "d_model": mcfg.d_model,
                      "tokens": list(PARALLEL_MOE_TOKENS), "equal": moe_equal}
        del mp, xm, want, got
        out["max_memory_allocated"] = peak_bytes(torch, device)
    finally:
        shutdown()
    out["launches"] = launch_snapshot(lib)
    for name in ("flash_attention", "decode_attention"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"parallel phase: {name} never launched")
    if on_card:
        torch.cuda.empty_cache()

    out["card_seconds"] = time.perf_counter() - t0
    out["t0"] = t0
    return out, pending


def finish_dryruns(out, pending):
    """Wait for the parallel phase's dry-run and correction subprocesses;
    both fall back to DRYRUN_FALLBACK if either is past its time.  The
    correction's predicted FLOPs, bytes and collective bytes must equal the
    full-depth record's (within CORRECTION_TOL); the record's row of the
    roofline table, the correction overlaid, is printed."""
    from repro_torch.analysis import report

    t1 = time.perf_counter()
    cell = DRYRUN_CELL
    dry, cor = pending
    rec = finish_dryrun(dry, DRYRUN_TIMEOUT_S)
    t_dry = time.perf_counter()
    corr = finish_correction(cor, CORRECTION_TIMEOUT_S if rec is not None else 0)
    if rec is None or corr is None:
        late = "dry-run" if rec is None else "correction"
        log(f"{late} of {DRYRUN_CELL} past its time: {DRYRUN_FALLBACK} instead")
        cell = DRYRUN_FALLBACK
        dry, cor = start_dryrun(cell), start_correction(cell)
        rec, corr = finish_dryrun(dry, DRYRUN_TIMEOUT_S), finish_correction(cor, CORRECTION_TIMEOUT_S)
        if rec is None or corr is None:
            raise AssertionError(f"dry-run or correction of {DRYRUN_FALLBACK} past its time")
        t_dry = time.perf_counter()
    t_corr = time.perf_counter()
    out["dryrun"] = {"cell": list(cell), "wall_s": rec["wall_s"], "trace_s": rec["lower_compile_s"],
                     "n_devices": rec["n_devices"], "n_params": rec["n_params"],
                     "memory_per_device": rec["memory"], "cost_per_device": rec["cost"],
                     "collectives_per_device": rec["collectives"], "fits_80gb": rec["fits"],
                     "counted_on": "meta tensors over a fake world: counts, not times"}
    log(f"dry-run {cell}: {rec['memory']['argument_size_in_bytes'] / 1e9:.2f} GB of arguments, "
        f"{rec['memory']['temp_size_in_bytes'] / 1e9:.2f} GB of temp (fits 80 GB: {rec['fits']}) "
        f"and {rec['cost']['flops']:.3e} FLOPs a device, {rec['wall_s']:.1f}s from its start, "
        f"waited {t_dry - t1:.1f}s")
    pairs = {"flops": (corr["flops"], rec["cost"]["flops"]),
             "bytes_accessed": (corr["bytes_accessed"], rec["cost"]["bytes_accessed"]),
             "collective_bytes": (corr["collective_bytes"], rec["collectives"]["total_bytes"])}
    diffs = {k: got - want for k, (got, want) in pairs.items()}
    if any(abs(d) > CORRECTION_TOL + 0.5 for d in diffs.values()):  # counts: integers
        raise AssertionError(f"correction of {cell} differs from its full-depth record: {diffs}")
    cid = "|".join(cell[:3])
    row = report.roofline_table({cid: rec}, cell[2], corrections={cid: corr}).splitlines()[2]
    out["correction"] = {"cell": list(cell), "wall_s": corr["wall_s"], "probe_s": corr["probe_s"],
                         "full_counts": corr["full_counts"],
                         "predicted": {k: got for k, (got, _) in pairs.items()},
                         "minus_full_depth": diffs, "tolerance": CORRECTION_TOL,
                         "roofline_row": row, "waited_s": t_corr - t_dry}
    log(f"correction of {cell} in {corr['wall_s']:.1f}s (probes {corr['probe_s']}) equals the "
        f"full-depth record; waited {t_corr - t_dry:.1f}s more\n{row}")
    out["seconds"] = time.perf_counter() - out.pop("t0")
    log(f"parallel phase: {out['seconds']:.1f}s")
    return t_dry, t_corr


# ----------------------------------------------------------------------------
# the examples, the port's user entry points, on the card
# ----------------------------------------------------------------------------

# runs an example as ``python examples/<name>_torch.py ARGS`` would, then
# prints the process's kernel launch counts (they start at 0 in a new process)
# and its seconds
_EXAMPLE = """
import time
t0 = time.perf_counter()
import json, runpy, sys
from repro_torch.kernels import _lib
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    print("LAUNCHES=" + json.dumps({"launches": {n: _lib.counter(n).launches for n in _lib.SOURCES},
                                    "seconds": time.perf_counter() - t0}), flush=True)
"""


def _start_example(name, *args):
    path = str(ROOT / "examples" / f"{name}_torch.py")
    return _spawn("example", (name,) + args, [sys.executable, "-c", _EXAMPLE, path, *args],
                  env={"OMP_NUM_THREADS": "1"})


def start_examples():
    """Start the four examples on the card, each in a subprocess at its
    defaults (the card; 12 requests; the tiny trainer at 8 x 128): the
    quickstart, the durable store, the serve engine, the trainer for
    EXAMPLE_TRAIN steps, and beside it the trainer in a second checkpoint
    directory crashing at EXAMPLE_FAIL_AT (``finish_examples`` resumes it)."""
    import tempfile

    ckpt = tempfile.TemporaryDirectory()
    runs = {name: _start_example(name) for name in ("quickstart", "durable_store", "serve_engine")}
    runs["train_lm"] = _start_example("train_lm", *EXAMPLE_TRAIN, "--ckpt", f"{ckpt.name}/full")
    runs["train_crash"] = _start_example("train_lm", *EXAMPLE_TRAIN, "--ckpt", f"{ckpt.name}/crash",
                                         "--fail-at", str(EXAMPLE_FAIL_AT))
    return runs, ckpt, time.perf_counter()


def _example_out(run):
    done = _finish(run, EXAMPLE_TIMEOUT_S)
    if done is None:
        raise AssertionError(f"example {run[1]} past {EXAMPLE_TIMEOUT_S}s")
    tagged = [x for x in done[1].splitlines() if x.startswith("LAUNCHES=")]
    lines = [x for x in done[1].splitlines() if not x.startswith("LAUNCHES=")]
    tail = json.loads(tagged[-1][len("LAUNCHES="):])
    return "\n".join(lines), lines, tail["launches"], tail["seconds"]


def _json_after(text, first_line):
    body = text[text.index(first_line) + len(first_line):]
    return json.loads(body[body.index("{"):body.rindex("}") + 1])


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{path}/{key}").items()}
    return {path: tree}


def finish_examples(started):
    """Wait for the examples and check them: the quickstart's and the durable
    store's lines (EXAMPLE_LINES), the serve engine's 12 requests and index
    counters (EXAMPLE_SERVE), the trainer's crash at EXAMPLE_FAIL_AT, its
    resume from step 5 and the resumed run's final loss and history equal to
    the uninterrupted run's.  The kernel launches of every run are summed:
    K1, K3, B6 and B7 must each have run."""
    import math

    runs, ckpt, t0 = started
    out, launches = {}, collections.Counter()
    try:
        for name in ("train_crash", "quickstart", "durable_store", "serve_engine", "train_lm"):
            text, lines, counts, seconds = _example_out(runs[name])
            launches.update(counts)
            out[name] = {"seconds": seconds, "launches": counts}
            if name == "train_crash":
                want = f"[crash] injected failure at step {EXAMPLE_FAIL_AT}"
                if not any(x.startswith(want) for x in lines):
                    raise AssertionError(f"example train_lm --fail-at: {text[-2000:]}")
                runs["train_resume"] = _start_example("train_lm", *EXAMPLE_TRAIN, "--ckpt",
                                                      f"{ckpt.name}/crash")
            elif name in EXAMPLE_LINES:
                missing = [x for x in EXAMPLE_LINES[name] if x not in lines]
                if missing:
                    raise AssertionError(f"example {name}: no line {missing}:\n{text[-3000:]}")
                out[name]["lines"] = EXAMPLE_LINES[name]
                if name == "quickstart":
                    loss = float(next(x for x in lines if "initial loss" in x).split(":")[1].split()[0])
                    if not math.isfinite(loss):
                        raise AssertionError(f"example quickstart: loss {loss}")
                    out[name]["initial_loss"] = loss
            elif name == "serve_engine":
                stats = _leaves(_json_after(text, "served 12 requests"))
                got = {k: stats.get(k) for k in EXAMPLE_SERVE}
                if got != EXAMPLE_SERVE:
                    raise AssertionError(f"example serve_engine: {got} != {EXAMPLE_SERVE}")
                out[name]["counters"] = got
            else:
                out[name]["result"] = _json_after(text, "")
        text, lines, counts, seconds = _example_out(runs["train_resume"])
        launches.update(counts)
        resumed = _json_after(text, "[resume] from durable checkpoint @ step 5")
        full = out["train_lm"]["result"]
        same = (resumed["resumed_from"] == 5 and resumed["final_step"] == full["final_step"]
                and resumed["final_loss"] == full["final_loss"]
                and resumed["history"][-1]["loss"] == full["history"][-1]["loss"])
        if not same or not math.isfinite(full["final_loss"]):
            raise AssertionError(f"example train_lm: resumed {resumed} against {full}")
        out["train_resume"] = {"seconds": seconds, "launches": counts, "resumed_from": 5,
                               "final_loss": resumed["final_loss"],
                               "equal_to_uninterrupted": True}
    finally:
        ckpt.cleanup()
    out["launches"] = dict(launches)
    for kernel in EXAMPLE_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"examples: {kernel} never launched")
    out["seconds"] = time.perf_counter() - t0
    log(f"examples phase: {out['seconds']:.1f}s, launches {dict(launches)}")
    return out


# ----------------------------------------------------------------------------
# kernels against their plain versions
# ----------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Per-call time of back-to-back calls issued from Python (CUDA events):
    what a caller pays, host launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed ``reps`` times, so host launch cost drops out.  The warm-up
    calls run on the capture stream, so a kernel's per-stream scratch exists
    before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def sass_count(lib_path, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS (``cuobjdump``)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def kernels_per_call(torch, calls) -> dict:
    """Kernels the card runs for one call of each of ``calls`` (name ->
    (a substring of its kernel's name, fn)), in one ``torch.profiler``
    session (host and device activity, as the train phase profiles).  Each
    fn runs once before the session, then once inside it between
    synchronizes, so the device events come in call order: a call's events
    run from its kernel up to the next call's kernel, and an event before
    the first one fails.  Returns the counts and the device events' names
    in order."""
    from torch.profiler import ProfilerActivity, profile

    for _, fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in calls.values():
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = list(calls)
    counts = dict.fromkeys(names, 0)
    at = -1
    for e in events:
        if at + 1 < len(names) and calls[names[at + 1]][0] in e.name:
            at += 1
        if at < 0:
            raise AssertionError(f"device event {e.name!r} before the first counted kernel")
        counts[names[at]] += 1
    return counts, [e.name for e in events]


def one_kernel_calls(torch, da_kernel, ec_kernel, td_kernel, rs_kernel, zipf_keys, cfg) -> dict:
    """Kernels one call of B7, K3, K2 and K4 runs on the card, on seeded
    inputs at the paths' shapes: B7 at the serve phase's (its batch, heads
    and cache, the kv_len of its last decode step), K3 at the tree path's
    round (1 x BATCH key-sorted Zipf ops, warmed up first, which sizes its
    look-back scratch), K2 at a scan level's (1,024 rows of 96 candidates
    into f = 8) and K4 at the scan's gather (1,024 rows of 88 candidates,
    cap 128).  Each must be 1: B7 merges its partials in the cluster, K3
    clears its own scratch (no memset), K2 writes the finished frontier,
    valid plane and overflow, K4 its four outputs.  Counted before any path
    runs, in the process's first profiler session: after the train phase's
    profiled step, a session this short came back with no device events at
    all."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s_max = SERVE_ENGINE["max_batch"], SERVE_ENGINE["s_max"]
    q = torch.randn((b, cfg.n_heads, cfg.d_head), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, cfg.n_kv, s_max, cfg.d_head), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    kv_len = SERVE_PROMPT + SERVE_MAX_NEW - 1
    scale = cfg.d_head ** -0.5
    rng = np.random.default_rng(SEED)
    keys = np.sort(zipf_keys(rng, BATCH, KEY_RANGE, 1.0))
    head = np.r_[True, keys[1:] != keys[:-1]]
    seg = np.cumsum(head) - 1
    combine = tuple(torch.as_tensor(x, device="cuda")[None] for x in (
        rng.integers(0, 4, BATCH).astype(np.int32), rng.integers(0, 1 << 40, BATCH), head,
        (rng.random(BATCH) < 0.5)[seg], rng.integers(0, 1 << 40, BATCH)[seg]))
    cand = torch.as_tensor(rng.integers(0, 1 << 16, (1024, 96)).astype(np.int32), device="cuda")
    cvalid = torch.as_tensor(rng.random((1024, 96)) < 0.1, device="cuda")
    ck = torch.as_tensor(rng.integers(0, KEY_RANGE, (1024, 88)), device="cuda")
    lo = torch.as_tensor(rng.integers(0, KEY_RANGE, 1024), device="cuda")
    hi = lo + 64
    counts, events = kernels_per_call(torch, {
        "decode_attention": ("decode_cluster_kernel",
                             lambda: da_kernel.decode_attention_cuda(q, k, v, kv_len, scale)),
        "elim_combine": ("elim_combine_kernel", lambda: ec_kernel.elim_combine_cuda(*combine)),
        "frontier_compact": ("compact_warp_rows",
                             lambda: td_kernel.frontier_compact_cuda(cand, cvalid, 8, scratch=7)),
        "range_scan": ("range_scan_warp_rows",
                       lambda: rs_kernel.range_scan_cuda(ck, ck, lo, hi, cap=128)),
    })
    if any(n != 1 for n in counts.values()):
        raise AssertionError(f"one call each ran {counts} kernels, not 1; the device events "
                             f"in call order: {events}")
    return counts


def max_abs_err(torch, got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            diff = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            err = max(err, float(diff))
    return err


def ulps_at_max(torch, want, n: int) -> float:
    """``n`` ulps of ``want``'s dtype at ``max |want|``."""
    top = float(want.abs().max())
    if top == 0.0:
        return 0.0
    _, exp = np.frexp(top)  # top = m * 2**exp, 0.5 <= m < 1
    return n * torch.finfo(want.dtype).eps * 2.0 ** (int(exp) - 1)


def descend_bytes(torch, pool_keys, children, is_leaf, root, queries, max_height):
    """Bytes a descent + probe must move for these queries, each read once:
    per distinct internal row visited, its leaf flag and b-1 routers; one
    child id per distinct (row, taken index); per distinct leaf reached, its
    flag and the keys up to the last slot any of its queries must compare
    (the hit, or all b on a miss); one value per distinct (leaf, slot) hit;
    the root ids, the queries and the outputs.  Also returns the levels the
    longest walk visits, its leaf included: the dependent loads of K1's
    chain (one a level)."""
    s, n, b = pool_keys.shape
    keys_f = pool_keys.reshape(s * n, b)
    ch_f = children.reshape(s * n, b)
    leaf_f = is_leaf.reshape(-1)
    base = (torch.arange(s, device=queries.device) * n)[:, None]
    node = root.to(torch.int64)[:, None].expand(queries.shape).clone()
    internal, taken = set(), set()
    levels = 1
    for _ in range(max_height):
        g = node + base
        lf = leaf_f[g]
        if bool(lf.all()):
            break
        levels += 1
        idx = (keys_f[g][..., : b - 1] <= queries[..., None]).sum(-1)
        internal.update(torch.unique(g[~lf]).tolist())
        taken.update(torch.unique((g * b + idx)[~lf]).tolist())
        child = ch_f[g, idx].to(torch.int64)
        child = torch.where(child < 0, n - 1, child)
        node = torch.where(lf, node, child)
    g = (node + base).reshape(-1)
    hit = keys_f[g] == queries.reshape(-1, 1)
    found = hit.any(-1)
    slot = hit.to(torch.uint8).argmax(-1)
    leaves, inv = torch.unique(g, return_inverse=True)
    compared = torch.zeros(leaves.numel(), dtype=torch.int64, device=g.device)
    compared.scatter_reduce_(0, inv, torch.where(found, slot + 1, b), "amax")
    hits = torch.unique((g * b + slot)[found]).numel()
    pool = (len(internal) * ((b - 1) * 8 + 1) + len(taken) * 4
            + leaves.numel() + int(compared.sum()) * 8 + hits * 8)
    return pool + queries.numel() * (8 + 4 + 1 + 4 + 8) + s * 4, levels


def range_scan_bytes(cand_keys, cap: int, emitted: int) -> int:
    """Bytes a range scan must move: every candidate key, lo and hi, the
    values of the emitted keys, and the outputs (cap keys and values, the
    count and the flag a row)."""
    return cand_keys.numel() * 8 + cand_keys.shape[0] * (16 + cap * 16 + 5) + emitted * 8


def range_scan_large_caps(torch, rs_kernel, rs_ref) -> list:
    """K4 at caps past 8,192 (``K4_LARGE``): seeded rows of duplicate keys
    (a key space a third of the row) with 30% EMPTY holes, each bit-equal to
    the plain version and timed as CUDA-graph replays beside its bound."""
    rng = np.random.default_rng(SEED)
    empty = torch.iinfo(torch.int64).max
    out = []
    for rows, n, cap in K4_LARGE:
        keys = rng.integers(0, n // 3, (rows, n))
        keys[rng.random((rows, n)) < 0.3] = empty
        lo = rng.integers(0, n // 6, rows)
        args = tuple(torch.as_tensor(x, dtype=torch.int64, device="cuda") for x in (
            keys, rng.integers(0, 1 << 40, (rows, n)), lo, lo + rng.integers(n // 6, n // 3, rows)))
        out.append({"rows": rows, "n": n, **range_scan_replay(torch, rs_kernel, rs_ref, args, cap)})
    return out


def side_replay(torch, name, k_fn, p_fn, nbytes) -> dict:
    """A kernel's call held bit-equal to its plain version on the same
    inputs, both timed as CUDA-graph replays, beside the call's bytes bound."""
    err = max_abs_err(torch, k_fn(), p_fn())
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
    return {"max_abs_err": err, "ms": graph_ms(torch, k_fn), "plain_ms": graph_ms(torch, p_fn),
            "bytes": int(nbytes), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def frontier_compact_bytes(cand, valid, f: int) -> int:
    """Bytes a compaction must move: the valid plane, the ids of the
    candidates that land in a slot, and the frontier, its valid plane and
    the overflow flag."""
    landed = int(valid.sum(1).clamp(max=f).sum())
    return valid.numel() + landed * 4 + cand.shape[0] * (f * 5 + 1)


def range_scan_replay(torch, rs_kernel, rs_ref, args, cap: int) -> dict:
    """``side_replay`` of one K4 call, with its count of emitted keys."""
    want = rs_ref.range_scan_ref(*args, cap)
    emitted = int(want[2].sum())
    return {"cap": cap, "emitted": emitted, "truncated": int(want[3].sum()),
            **side_replay(torch, f"range_scan at cap {cap}, n {args[0].shape[1]}",
                          lambda: rs_kernel.range_scan_cuda(*args, cap=cap),
                          lambda: rs_ref.range_scan_ref(*args, cap),
                          range_scan_bytes(args[0], cap, emitted))}


def large_cap_scan_replays(torch, td_kernel, td_ref, rs_kernel, rs_ref, calls) -> dict:
    """The widest K2 and K4 calls of ``large_cap_scan`` (block mode, on the
    inputs the main path gave them) against their plain versions."""
    cand, valid, kw = max(calls["frontier_compact"],
                          key=lambda c: (c[0].shape[1], int(c[1].sum())))
    f, scratch = kw["f"], kw["scratch"]
    k2 = {"cand": list(cand.shape), "f": f, "valid": int(valid.sum()),
          **side_replay(torch, f"frontier_compact at {list(cand.shape)} -> {f}",
                        lambda: td_kernel.frontier_compact_cuda(cand, valid, f, scratch=scratch),
                        lambda: td_ref.frontier_compact_plain(cand, valid, f, scratch=scratch),
                        frontier_compact_bytes(cand, valid, f))}
    ck, cv, lo, hi, kw = max(calls["range_scan"], key=lambda c: c[0].numel())
    k4 = {"cand": list(ck.shape), **range_scan_replay(torch, rs_kernel, rs_ref, (ck, cv, lo, hi),
                                                      kw["cap"])}
    return {"frontier_compact": k2, "range_scan": k4}


def flash_tol(torch, want) -> float:
    """B6's limit against its plain version for an output like ``want``."""
    if want.dtype == torch.float32:
        return FLASH_F32_TOL
    return ulps_at_max(torch, want, FLASH_ULPS)


def flash_replays(torch, fa_kernel, fa_ops, fa_ref, recorded):
    """B6 against its plain version on seeded random q/k/v at the shapes of
    the recorded call (as recorded, with a window of FLASH_WINDOW, and
    ragged at FLASH_RAGGED_S rows without causality), and the Function's
    gradients against autograd through the plain version on the recorded
    tensors and a seeded cotangent (bit for bit: the backward is that
    autograd).  Returns the cases and the gradients' max |err|."""
    q, k, v, kw = recorded
    q, k, v = (x.detach() for x in (q, k, v))  # recorded inside the autograd Function
    b, h, sq, d = q.shape
    kh = k.shape[1]
    gen = torch.Generator(device=q.device).manual_seed(SEED)

    def rand_like(shape, dtype):
        return torch.randn(shape, generator=gen, device=q.device).to(dtype)

    cases = {}
    for case, (s_len, causal, window) in {
        "random": (sq, kw["causal"], kw["window"]),
        "window": (sq, kw["causal"], FLASH_WINDOW),
        "ragged": (FLASH_RAGGED_S, False, 0),
    }.items():
        rq, rk, rv = (rand_like((b, n, s_len, d), q.dtype) for n in (h, kh, kh))
        opts = dict(causal=causal, window=window, sm_scale=kw["sm_scale"])
        r_got = fa_kernel.flash_attention_cuda(rq, rk, rv, **opts)
        r_want = fa_ref.attention_ref(rq, rk, rv, **opts)
        r_err, r_tol = max_abs_err(torch, (r_got,), (r_want,)), flash_tol(torch, r_want)
        if r_err > r_tol:
            raise AssertionError(
                f"flash_attention: kernel differs from its plain version ({case}: max |err| "
                f"{r_err} > {r_tol}, max |want| {float(r_want.abs().max())})")
        cases[case] = {"s": s_len, "causal": causal, "window": window, "max_abs_err": r_err,
                       "tolerance": r_tol, "max_abs_want": float(r_want.abs().max())}
    cot = rand_like(q.shape, q.dtype)
    grads = []
    for fn in (fa_ops.flash_attention, lambda *a: fa_ref.attention_ref(*a[:3], **kw)):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs, kw["causal"], kw["window"], kw["sm_scale"])
        grads.append(torch.autograd.grad(out, xs, cot))
    grad_err = max_abs_err(torch, grads[0], grads[1])
    if grad_err != 0.0:
        raise AssertionError(f"flash_attention: the Function's gradients differ from the plain "
                             f"version's autograd (max |err| {grad_err})")
    return cases, grad_err


def leaf_rows(torch, descend_call):
    """The leaf rows that K1 reached in a recorded search call, each row's
    query, and K1's own answers (found, slot, value), flattened over the
    shards: B5's input at the path's shapes."""
    from types import SimpleNamespace

    from repro_torch.core.abtree import _leaf_rows
    from repro_torch.kernels.tree_descend import kernel as td_kernel

    pk, pv, ch, lf, root, q, kw = descend_call
    leaf, found, slot, val = td_kernel.descend_probe_cuda(pk, pv, ch, lf, root, q, **kw)
    nb = pk.shape[2]
    # leaf -1 (a NULL child) names the scratch row N-1; _leaf_rows reads the
    # pool's rows from ``keys`` and its shard count from ``size``'s shape
    rows_g = _leaf_rows(SimpleNamespace(keys=pk, size=lf), leaf).reshape(-1)
    lk = pk.reshape(-1, nb)[rows_g].contiguous()
    lv = pv.reshape(-1, nb)[rows_g].contiguous()
    return lk, lv, q.reshape(-1).contiguous(), found.reshape(-1), slot.reshape(-1), val.reshape(-1)


def leaf_probe_replay(torch, lp_kernel, lp_ops, descend_call):
    """B5 standalone (no path of the system calls it): the public wrapper
    over the leaf rows that K1 reached in the tree path's recorded search
    call, counted as its own run, then the kernel held lane for lane against
    K1's own probe (where K1 found the key, the same slot and value; else
    slot -1 and value 0).  Returns the rows, queries, the kernel's output and
    the wrapper's launch count."""
    lk, lv, lq, found, slot, val = leaf_rows(torch, descend_call)
    probe = lp_kernel.LEAF_PROBE
    probe.launches = 0
    lp_ops.leaf_probe(lk, lv, lq)
    launches = probe.launches
    got = lp_kernel.leaf_probe_cuda(lk, lv, lq)
    want_slot = torch.where(found, slot, torch.full_like(slot, -1))
    want_val = torch.where(found, val, torch.zeros_like(val))
    if not (torch.equal(got[0], want_slot) and torch.equal(got[1], want_val)):
        bad = int(((got[0] != want_slot) | (got[1] != want_val)).nonzero()[0])
        raise AssertionError(
            f"leaf_probe: lane {bad} gives ({int(got[0][bad])}, {int(got[1][bad])}), "
            f"K1 ({int(want_slot[bad])}, {int(want_val[bad])})")
    return lk, lv, lq, got, launches


def kernel_report(torch, mods, libs, summary, recorded, serve_summary, serve_recorded,
                  per_call, train_summary, train_recorded, paths, forest_recorded,
                  lm_summary, lm_recorded, family_summary, family_recorded):
    """Replay one main-path call per kernel against its plain version, and
    B6 and B7 also on the LM phase's granite-moe-3b-a800m calls
    (``lm_recorded``; their rows' ``launches`` are that phase's) and on the
    family phase's zamba2-1.2b and whisper-tiny calls (``family_recorded``:
    group 1; whisper's encoder B6 call, not causal over 1,500 frames, and
    its cross-attention B7 call over them, with its self-attention call
    replayed beside it; their rows' ``launches`` are the arch's serve or
    train run's).
    ``libs``: kernel name -> built library; ``per_call``: the kernels one
    call of B7, K3, K2 and K4 ran (``one_kernel_calls``); ``paths``: the
    occ, forest, sharded-index, durable and LM phases' summaries (their
    launch counts join each row); ``forest_recorded``: the forest's first K1 and K3
    calls, at S = FOREST_SHARDS, replayed beside the K1 and K3 rows."""
    (td_kernel, td_ref, ec_kernel, ec_ref, rs_kernel, rs_ref, da_kernel, da_ref,
     fa_kernel, fa_ops, fa_ref, lp_kernel, lp_ops, lp_ref) = mods
    rows = []

    def entry(name, source, replaces, got, want, k_fn, p_fn, nbytes, shapes, lib_ms=None,
              tol=0.0, launches=None, ops=0.0, ops_per_s=1.0, extra=None):
        err = max_abs_err(torch, got, want)
        if err > tol:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err} > {tol})")
        k_ms = graph_ms(torch, k_fn)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        kernel = name.split("@")[0]  # a row at another model's shapes: its kernel's counts
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": summary["launches"][name] if launches is None else launches,
            "serve_launches": serve_summary["launches"].get(kernel, 0),
            "train_launches": train_summary["launches"].get(kernel, 0),
            **{f"{path}_launches": s["launches"].get(kernel, 0) for path, s in paths.items()},
            "max_abs_err": err, "tolerance": tol, "equal": err == 0.0,
            "ms": k_ms, "kernel_ms": k_ms, "call_ms": time_ms(torch, k_fn, 200),
            "plain_ms": graph_ms(torch, p_fn), "plain_call_ms": time_ms(torch, p_fn, 20),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": int(nbytes), "ops": int(ops), "library_ms": lib_ms, "shapes": shapes,
            **(extra or {}),
        })

    # K1 descend_probe: the search phase's call (first of the round), and
    # the forest's first search call at S = FOREST_SHARDS
    fk = forest_recorded["descend_probe"]
    f_bytes, f_height = descend_bytes(torch, fk[0], *fk[2:6], fk[6]["max_height"])
    forest_k1 = {"pool": list(fk[0].shape), "queries": list(fk[5].shape), "height": f_height,
                 **side_replay(torch, f"descend_probe at S = {fk[0].shape[0]}",
                               lambda: td_kernel.descend_probe_cuda(*fk[:6], **fk[6]),
                               lambda: td_ref.descend_probe_ref(*fk[:6], **fk[6]), f_bytes)}
    pk, pv, ch, lf, root, q, kw = recorded["descend_probe"][0]
    nbytes, height = descend_bytes(torch, pk, ch, lf, root, q, kw["max_height"])
    entry(
        "descend_probe", "src/repro_torch/csrc/descend_probe.cu",
        "src/repro/kernels/tree_descend/kernel.py:95",
        td_kernel.descend_probe_cuda(pk, pv, ch, lf, root, q, **kw),
        td_ref.descend_probe_ref(pk, pv, ch, lf, root, q, **kw),
        lambda: td_kernel.descend_probe_cuda(pk, pv, ch, lf, root, q, **kw),
        lambda: td_ref.descend_probe_ref(pk, pv, ch, lf, root, q, **kw),
        nbytes, {"pool": list(pk.shape), "queries": list(q.shape)},
        extra={"height": height, "forest": forest_k1},
    )

    # K2 frontier_compact: the call with the most valid candidates; one
    # launch writes the finished triple.  K2's and K4's widest calls of the
    # large-cap scan (block mode) are replayed beside their rows.
    calls = recorded["frontier_compact"]
    cand, valid, kw = max(calls, key=lambda c: int(c[1].sum()))
    f, scratch = kw["f"], kw["scratch"]
    landed = int(valid.sum(1).clamp(max=f).sum())
    large = large_cap_scan_replays(torch, td_kernel, td_ref, rs_kernel, rs_ref,
                                   recorded["large_cap_scan"])
    entry(
        "frontier_compact", "src/repro_torch/csrc/frontier_compact.cu",
        "src/repro/kernels/tree_descend/kernel.py:187",
        td_kernel.frontier_compact_cuda(cand, valid, f, scratch=scratch),
        td_ref.frontier_compact_plain(cand, valid, f, scratch=scratch),
        lambda: td_kernel.frontier_compact_cuda(cand, valid, f, scratch=scratch),
        lambda: td_ref.frontier_compact_plain(cand, valid, f, scratch=scratch),
        frontier_compact_bytes(cand, valid, f),
        {"cand": list(cand.shape), "f": f},
        extra={"kernels_per_call": per_call["frontier_compact"], "landed": landed,
               "large_cap_scan": large["frontier_compact"]},
    )

    # K3 elim_combine: the round's combine, and the forest's first combine
    # at S = FOREST_SHARDS
    def combine_bytes(ops):
        return ops.numel() * (4 + 8 + 1 + 1 + 8 + 1 + 8 + 1 + 8)

    fc = forest_recorded["elim_combine"][:5]
    forest_k3 = {"ops": list(fc[0].shape),
                 **side_replay(torch, f"elim_combine at S = {fc[0].shape[0]}",
                               lambda: ec_kernel.elim_combine_cuda(*fc),
                               lambda: ec_ref.elim_combine_ref(*fc), combine_bytes(fc[0]))}
    ops, vals, head, p0, v0, _ = recorded["elim_combine"][0]
    entry(
        "elim_combine", "src/repro_torch/csrc/elim_combine.cu",
        "src/repro/kernels/elim_combine/kernel.py:150",
        ec_kernel.elim_combine_cuda(ops, vals, head, p0, v0),
        ec_ref.elim_combine_ref(ops, vals, head, p0, v0),
        lambda: ec_kernel.elim_combine_cuda(ops, vals, head, p0, v0),
        lambda: ec_ref.elim_combine_ref(ops, vals, head, p0, v0),
        combine_bytes(ops),
        {"ops": list(ops.shape)},
        extra={"kernels_per_call": per_call["elim_combine"], "forest": forest_k3},
    )

    # K4 range_scan: the round's accepted gather (the last call)
    ck, cv, lo, hi, kw = recorded["range_scan"][-1]
    cap = kw["cap"]
    want = rs_ref.range_scan_ref(ck, cv, lo, hi, cap)
    emitted = int(want[2].sum())
    empty = torch.iinfo(torch.int64).max
    key_m = torch.where((ck >= lo[:, None]) & (ck < hi[:, None]) & (ck != empty), ck, empty)
    k = min(cap, ck.shape[1])
    lib_ms = graph_ms(torch, lambda: torch.topk(key_m, k, dim=1, largest=False, sorted=True))
    entry(
        "range_scan", "src/repro_torch/csrc/range_scan.cu",
        "src/repro/kernels/range_scan/kernel.py:138",
        rs_kernel.range_scan_cuda(ck, cv, lo, hi, cap=cap),
        want,
        lambda: rs_kernel.range_scan_cuda(ck, cv, lo, hi, cap=cap),
        lambda: rs_ref.range_scan_ref(ck, cv, lo, hi, cap),
        range_scan_bytes(ck, cap, emitted),
        {"cand": list(ck.shape), "cap": cap},
        lib_ms=lib_ms,
        extra={"kernels_per_call": per_call["range_scan"],
               "large_cap": range_scan_large_caps(torch, rs_kernel, rs_ref),
               "large_cap_scan": large["range_scan"]},
    )
    def decode_row(name, recorded, launches, extra):
        """B7 on a recorded decode call, then seeded random q/k/v at the same
        shapes, where every live column's weight shows in every row of the
        output."""
        q, k, v, kw = recorded
        kv_len, scale = kw["kv_len"], kw["sm_scale"]
        b, h, d = q.shape
        kh = k.shape[1]
        gen = torch.Generator(device=q.device).manual_seed(SEED)
        rq, rk, rv = (torch.randn(x.shape, generator=gen, device=q.device).to(x.dtype)
                      for x in (q, k, v))
        r_got = da_kernel.decode_attention_cuda(rq, rk, rv, kv_len, scale)
        r_want = da_ref.decode_attention_ref(rq, rk, rv, kv_len, sm_scale=scale)
        r_err = max_abs_err(torch, (r_got,), (r_want,))
        r_tol = ulps_at_max(torch, r_want, DECODE_ULPS)
        if r_err > r_tol:
            raise AssertionError(
                f"{name}: kernel differs from its plain version on random inputs "
                f"(max |err| {r_err} > {r_tol}, max |want| {float(r_want.abs().max())})"
            )
        want = da_ref.decode_attention_ref(q, k, v, kv_len, sm_scale=scale)
        capacity = da_kernel.cluster_capacity(q.dtype, d, h // kh)  # clusters of n blocks at once
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kv, vv = k[:, :, :kv_len], v[:, :, :kv_len]
        lib_ms = graph_ms(torch, lambda: sdpa(q[:, :, None], kv, vv, enable_gqa=True))
        entry(
            name, "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:72",
            (da_kernel.decode_attention_cuda(q, k, v, kv_len, scale),), (want,),
            lambda: da_kernel.decode_attention_cuda(q, k, v, kv_len, scale),
            lambda: da_ref.decode_attention_ref(q, k, v, kv_len, sm_scale=scale),
            2 * b * kh * kv_len * d * k.element_size() + 2 * q.numel() * q.element_size(),
            {"q": list(q.shape), "cache": list(k.shape), "kv_len": kv_len, "dtype": str(q.dtype)},
            lib_ms=lib_ms, tol=ulps_at_max(torch, want, DECODE_ULPS), launches=launches,
            ops=4.0 * b * h * kv_len * d, ops_per_s=OPS_PER_S[str(q.dtype)],
            extra={"max_abs_want": float(want.abs().max()), "random_max_abs_err": r_err,
                   "random_tolerance": r_tol, "random_max_abs_want": float(r_want.abs().max()),
                   "group": h // kh,
                   "cluster_plan": list(da_kernel.cluster_plan(b, kh, kv_len, capacity)),
                   "cluster_capacity": [capacity(n) for n in range(1, da_kernel.MAX_CLUSTER + 1)],
                   **extra},
        )

    def flash_row(name, recorded, launches):
        """B6 on a recorded forward call (and, in flash_replays, seeded
        random, windowed and ragged cases and the gradients)."""
        q, k, v, kw = recorded
        q, k, v = (x.detach() for x in (q, k, v))  # recorded inside the autograd Function
        b, h, sq, d = q.shape
        cases, grad_err = flash_replays(torch, fa_kernel, fa_ops, fa_ref, recorded)
        want = fa_ref.attention_ref(q, k, v, **kw)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        causal = kw["causal"]
        lib_ms = graph_ms(torch, lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
        ops = 4.0 * b * h * sq * sq * d * (0.5 if causal else 1.0)  # causal: half of 4·B·H·S²·D
        hgmma = sass_count(libs["flash_attention"], "HGMMA")
        if q.dtype == torch.bfloat16 and hgmma == 0:
            raise AssertionError("flash_attention: no HGMMA in the built library: "
                                 "bf16 does not run on the tensor cores")
        entry(
            name, "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:94",
            (fa_kernel.flash_attention_cuda(q, k, v, **kw),), (want,),
            lambda: fa_kernel.flash_attention_cuda(q, k, v, **kw),
            lambda: fa_ref.attention_ref(q, k, v, **kw),
            (2 * q.numel() + 2 * k.numel()) * q.element_size(),
            {"q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype), **kw},
            lib_ms=lib_ms, tol=flash_tol(torch, want), launches=launches,
            ops=ops, ops_per_s=OPS_PER_S[str(q.dtype)],
            extra={"max_abs_want": float(want.abs().max()), "replays": cases,
                   "grad_max_abs_err": grad_err, "group": h // k.shape[1],
                   "library": f"scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)",
                   "sass_hgmma": hgmma},
        )

    # B7 decode_attention: the serve path's last decode call, and the LM
    # phase's last one at granite-moe-3b-a800m's shapes (group 3)
    decode_row("decode_attention", serve_recorded, serve_summary["launches"]["decode_attention"],
               {"kernels_per_call": per_call["decode_attention"]})
    decode_row(f"decode_attention@{LM_ARCH}", lm_recorded["decode_attention"],
               lm_summary["serve"]["launches"]["decode_attention"], {})

    # B6 flash_attention: the train phase's last forward call, and the LM
    # phase's last one at granite-moe-3b-a800m's shapes (group 3)
    flash_row("flash_attention", train_recorded, train_summary["launches"]["flash_attention"])
    flash_row(f"flash_attention@{LM_ARCH}", lm_recorded["flash_attention"],
              lm_summary["train"]["launches"]["flash_attention"])

    # B6 and B7 at the family phase's shapes (group 1): zamba2-1.2b's shared
    # block; whisper-tiny's encoder (not causal, 1,500 frames) and its
    # cross-attention over them, its self-attention call beside it
    def decode_side(call):
        q, k, v, kw = call
        got = da_kernel.decode_attention_cuda(q, k, v, kw["kv_len"], kw["sm_scale"])
        want = da_ref.decode_attention_ref(q, k, v, kw["kv_len"], sm_scale=kw["sm_scale"])
        err, tol = max_abs_err(torch, (got,), (want,)), ulps_at_max(torch, want, DECODE_ULPS)
        if err > tol:
            raise AssertionError(f"decode_attention self call: kernel differs from its plain "
                                 f"version (max |err| {err} > {tol})")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kv, vv = k[:, :, :kw["kv_len"]], v[:, :, :kw["kv_len"]]
        return {"q": list(q.shape), "cache": list(k.shape), "kv_len": kw["kv_len"],
                "max_abs_err": err, "tolerance": tol,
                "ms": graph_ms(torch, lambda: da_kernel.decode_attention_cuda(
                    q, k, v, kw["kv_len"], kw["sm_scale"])),
                "library_ms": graph_ms(torch, lambda: sdpa(q[:, :, None], kv, vv,
                                                           enable_gqa=True))}

    for arch in FAMILY_TRAIN:
        part = family_summary[arch]
        flash_row(f"flash_attention@{arch}", family_recorded[f"flash_attention@{arch}"],
                  part["train"]["launches"]["flash_attention"])
        side = ({"self_call": decode_side(family_recorded[f"decode_attention@{arch} self"])}
                if f"decode_attention@{arch} self" in family_recorded else {})
        decode_row(f"decode_attention@{arch}", family_recorded[f"decode_attention@{arch}"],
                   part["serve"]["launches"]["decode_attention"], side)

    # B5 leaf_probe, standalone over the tree path's leaf rows
    lk, lv, lq, (p_slot, p_val), probe_launches = leaf_probe_replay(
        torch, lp_kernel, lp_ops, recorded["descend_probe"][0])
    nb = lk.shape[1]
    hit = p_slot >= 0
    compared = torch.where(hit, p_slot + 1, nb).sum()
    entry(
        "leaf_probe", "src/repro_torch/csrc/leaf_probe.cu",
        "src/repro/kernels/leaf_probe/kernel.py:46",
        (p_slot, p_val), lp_ref.leaf_probe_ref(lk, lv, lq),
        lambda: lp_kernel.leaf_probe_cuda(lk, lv, lq),
        lambda: lp_ref.leaf_probe_ref(lk, lv, lq),
        int(compared) * lk.element_size() + int(hit.sum()) * lv.element_size()
        + lq.numel() * (lq.element_size() + 4 + lv.element_size()),
        {"rows": list(lk.shape), "dtype": str(lk.dtype)},
        launches=probe_launches,
        extra={"launched_by": "standalone: ops.leaf_probe over the tree path's leaf rows "
                              "(no path of the system calls it)",
               "hits": int(hit.sum()), "equal_to_descend_probe": True},
    )
    for row in rows:
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']}: never launched on the main path")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as core
    from repro_torch.data.workloads import zipf_keys
    from repro_torch.kernels import _lib as lib
    from repro_torch.kernels.decode_attention import kernel as da_kernel, ref as da_ref
    from repro_torch.kernels.elim_combine import kernel as ec_kernel, ref as ec_ref
    from repro_torch.kernels.flash_attention import kernel as fa_kernel, ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.leaf_probe import kernel as lp_kernel, ops as lp_ops, ref as lp_ref
    from repro_torch.kernels.range_scan import kernel as rs_kernel, ref as rs_ref
    from repro_torch.kernels.tree_descend import kernel as td_kernel, ref as td_ref

    # 1. set-up: build every kernel, name the card
    t0 = time.perf_counter()
    libs = lib.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"{smi} | torch.cuda.get_device_name(0) = {kind}", flush=True)
    from repro_torch.configs import get_config

    per_call = one_kernel_calls(torch, da_kernel, ec_kernel, td_kernel, rs_kernel, zipf_keys,
                                get_config(SERVE_ARCH))

    # 2. the main path at full width, then occ mode on its tree, the forest
    # and the sharded indexes
    summary, recorded, tree, oracle, history = run_main_path(torch, core, lib, zipf_keys)
    print(json.dumps({"main_path": summary, "card": smi}), flush=True)
    occ_summary = run_occ_path(torch, core, lib, zipf_keys, tree, oracle)
    print(json.dumps({"occ_path": occ_summary, "card": smi}), flush=True)
    del oracle
    forest_summary, forest_recorded, forest, forest_oracle = run_forest_path(
        torch, core, lib, zipf_keys)
    print(json.dumps({"forest_path": forest_summary, "card": smi}), flush=True)
    index_summary, _, _ = run_index_path(torch, core, lib)
    print(json.dumps({"sharded_indexes": index_summary, "card": smi}), flush=True)
    durable_summary = run_durable_path(torch, core, lib, zipf_keys, summary)
    print(json.dumps({"durable_path": durable_summary, "card": smi}), flush=True)
    # the obs phase: the witness over the tree path's history, trace export
    # and report, crash forensics, the op audit
    obs_summary = run_obs_path(torch, core, lib, zipf_keys, tree, history, forest, forest_oracle)
    print(json.dumps({"obs_path": obs_summary, "card": smi}), flush=True)
    del tree, history, forest, forest_oracle
    gc.collect()

    # 3. the serving path at full width
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    serve_summary, serve_recorded = run_serve_path(
        torch, core, lib, torch.device("cuda"), get_config(SERVE_ARCH)
    )
    print(json.dumps({"serve_path": serve_summary, "card": smi}), flush=True)

    # 4. the training path at full width
    train_summary, train_recorded = run_train_path(torch, lib, torch.device("cuda"))
    print(json.dumps({"train_path": train_summary, "card": smi}), flush=True)
    torch.cuda.empty_cache()  # the qwen2 trainer is gone: its blocks go back to the card

    # 5. the LM family and the training stack: granite-moe-3b-a800m served
    # and trained, deepseek-v3 reduced, EmbedElim, DedupIndex, quantizers
    lm_summary, lm_recorded = run_lm_family_path(torch, core, lib, torch.device("cuda"),
                                                 zipf_keys)
    print(json.dumps({"lm_family_path": lm_summary, "card": smi}), flush=True)

    # 6. the ssm, hybrid and audio families: xlstm-350m, zamba2-1.2b and
    # whisper-tiny served, zamba2 and whisper trained, xlstm's gradient, each
    # family's card against the CPU
    family_summary, family_recorded = run_family_path(torch, core, lib, torch.device("cuda"))
    print(json.dumps({"family_path": family_summary, "card": smi}), flush=True)

    # the parallel layer: qwen2 trained, restored and served on a 1-rank NCCL
    # mesh against the mesh-free runs, the compressed reduce, the pipeline,
    # the grouped MoE; the dry-run of a 512-rank cell
    # the examples on the card, each in a subprocess, beside the parallel
    # phase and its dry-run and correction, which trace on the host's CPU
    examples = start_examples()
    parallel_summary, pending = run_parallel_path(torch, lib, torch.device("cuda"))
    t_card = time.perf_counter()
    t_dry, t_corr = finish_dryruns(parallel_summary, pending)
    print(json.dumps({"parallel_path": parallel_summary, "card": smi}), flush=True)
    examples_summary = finish_examples(examples)
    t_end = time.perf_counter()
    # what the correction and the examples add to the script: the wait past
    # the dry-run's end (where the parallel phase ended before them)
    examples_summary["added_wall_s"] = {
        "correction": t_corr - t_dry, "examples": max(0.0, t_end - t_corr),
        "total": t_end - t_dry, "dryrun_wait": t_dry - t_card}
    log(f"correction and examples added {t_end - t_dry:.1f}s")
    print(json.dumps({"examples_path": examples_summary, "card": smi}), flush=True)

    # the seconds of the parity checks inside the phases above
    parity = {"bare_state_forms": summary["bare_state_forms"]["seconds"],
              "prefill_tree": summary["prefill_tree"]["seconds"],
              "counter_track": obs_summary["seconds"]["counter_track"],
              "pipeline_backward": parallel_summary["pipeline"]["backward_check_s"]}
    parity["total_s"] = sum(parity.values())
    log(f"parity checks took {parity['total_s']:.1f}s: {parity}")
    print(json.dumps({"parity_checks_s": parity, "card": smi}), flush=True)

    # 7. every kernel against its plain version at main-path shapes
    rows = kernel_report(
        torch, (td_kernel, td_ref, ec_kernel, ec_ref, rs_kernel, rs_ref, da_kernel, da_ref,
                fa_kernel, fa_ops, fa_ref, lp_kernel, lp_ops, lp_ref),
        libs, summary, recorded, serve_summary, serve_recorded, per_call, train_summary,
        train_recorded, {"occ": occ_summary, "forest": forest_summary, "index": index_summary,
                         "durable": durable_summary, "obs": obs_summary, "lm": lm_summary,
                         "family": family_summary, "parallel": parallel_summary,
                         "examples": examples_summary},
        forest_recorded, lm_summary, lm_recorded, family_summary, family_recorded,
    )
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
