#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`nv_wavenet_tpu_torch`) on one card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from `nv_wavenet_tpu_torch/csrc/` with
nvcc, holds each kernel against its plain PyTorch version on the card, then
drives the port's paths at full width, the flagship geometry (20 layers,
R=64, S=256, A=256, max_dilation 512, fp32, batch 16, random weights from
seed 1): the main path serving 3 requests of 8192 samples through
`WaveNetInfer.set_inputs` + `run_chunks`; the streaming serving path, 16
slots fed tick by tick through `begin_stream` / `feed(lengths=...)` /
`reset_utterances` / `export_state` + `import_state`; the scoring path,
`WaveNetInfer.score` and `scoring.*` over the first request's audio; a
request in mode "prng"; and the weight-streaming path, the same requests
through `WaveNetInfer(implementation=Impl.MANYBLOCK)` with fp32, bf16 and
int8 weight stacks (kernel K4), then K4 at the JAX repo's largest
configuration (config 4); the geometries the staged kernels cannot hold
(the generic K1/K5 and the first K4); the latency tier, the same requests through
`WaveNetInfer(priority="latency")` (the collapsed-chain kernel K6 with
fast_math); and the two precision knobs, the same requests through
`WaveNetInfer(compute_dtype=torch.bfloat16)` and `WaveNetInfer(
fast_math=True)` (the fast and bf16 instances of K1-K6), with the latency
tier's slot handover; the two probes (P1, the FMA contraction; P5, the
per-stage latency floor); speculative exact decode through
`WaveNetInfer.run_speculative` with its H100 cost fit; and training at
configs/config.json's width through the training CLI, with the trained
model's teacher-forced p on the card and `tools/inference.py` on its
checkpoint; batch-sharded generation over a device mesh; the user's
tools (`NVWaveNet`, `torch_import`, `nvw-torch-verify`,
`eval_checkpoint`); and tensor and sequence parallel training.  Phases,
in order; any failure exits non-zero:

  1. device: card name and power limit (nvidia-smi), torch.version.cuda, nvcc
  2. build: every csrc/*.cu, timed; beside it (nvcc runs in its own
     processes) the plain CPU run of phase 5's horizon case
  3. K0a (elementwise exact exp/tanh/sigmoid) vs plain: 0 bit mismatches on
     the dense sweep of tests/test_exact_math.py; its device time (100
     launches in a CUDA graph) at 450,020 floats and at the scorer's
     embedding [131072, 64], beside torch.exp / tanh / sigmoid
  4. K0b (canonical sampler) vs plain: 0 mismatches at za [4096, 256],
     [4096, 1024] and speculative decode's [256, 256] (the warp instance)
     and [4096, 250] (the block instance), rows at sel 1.0 among them, timed
     by events and device time, and the block instance (the earlier
     design) against the warp instance in turns at [4096, 256]; K0c
     (canonical softmax) vs plain at za [4096, 256] and [131072, 256] (the
     warp instance) and [4096, 250] (the block instance): 0 bit
     mismatches, timed beside torch.softmax; K7 (the scorer's fixed-order
     products) vs plain at the scorer's flagship shapes with 131072 rows
     (the 16 x 8192 window) and 4096 (a verify), and a ragged case, in its
     three entries (the product, the gate, res/skip): 0 bit mismatches,
     timed beside torch.matmul, with the bound and the no-FMA floor (the
     operations over 33.5 TFLOP/s)
  5. K1 (persistent generation) vs plain, TEST_CONFIG_MED, B=4, T=32, sample
     and argmax modes with the dump: exact y, activations within the
     reference ladder; 7+7+...+1 chunked run_partial calls equal one call;
     then the 65,536-draw horizon case of tests/test_torch_generate.py (4
     layers, R=32, B=16, T=4096), K1 on the card in chunks of 256 against
     the plain version on the CPU in one call (run in phase 2): 0 integer
     mismatches (the CPU test holds that plain version to the golden model
     with 0 too).  K2
     (forced) vs plain on the same config, forcing K1's samples, with and
     without the dump: y echoes the symbols, p_seq within 1e-6, the ring
     within the xt ladder (the plain version uses cuBLAS: not bitwise);
     K3 (prng) through run(mode="prng") vs the plain version fed
     prng_uniform_sel's selectors: 0 mismatches; 7+7+...+1 run_partial
     calls equal one call; another seed gives another stream
  6. K5 (ragged generation, per-row clocks and lengths) vs plain,
     TEST_CONFIG_MED, B=4: 6 seeded ticks of lengths in [0, 16] (one tick
     with every length 0, one with one row at 0) through an engine on the
     card and through the plain ragged generator on the card: 0 integer
     mismatches, equal y_state and clocks, the ring within the xt ladder
  7. main path: kernel launch counts set to 0 just before and read just
     after; K1 must have launched; the first 16 samples of request 1 must
     equal the plain version's on the card (0 integer mismatches); the
     lockstep K1's time per step
  8. serving: counts set to 0 just before and read just after; 192 ticks of
     at most 160 samples over 16 slots, per-row lengths from {0} and
     [40, 160], utterances of [2048, 8192] samples (conditioning and
     injected selectors drawn on the card from a seeded generator), a slot
     reset when its utterance ends; once every slot reset in one tick, 4
     lockstep ticks, then a partial reset (the R3 sequence); once, mid-run
     and desynced, the stream moves to a second engine by export_state ->
     import_state (the R7 sequence).  K1 and K5 must both have launched.
     Prints per-feed wall time p50/p99, samples served per second over the
     live rows, the dead row-step share and the launches
  9. correctness at full width: the first 16 utterances completed, replayed
     as one lockstep batch (set_inputs + run) on a fresh engine, equal what
     they were served (0 mismatches), among them one that crossed the
     migration and one that began at the full reset and ran through the
     partial reset; then K5 on one 160-step ragged tick of the scenario,
     timed, and on a 16-step tick against the plain version (0 mismatches);
     then K5's launch (`k5_card_check`) over 64 ragged ticks of at most 8
     steps (rows of length 0, desynced clocks, rows past 2^31 and 2^32,
     slot resets, a weight changed in place): y, ring bits and y_state
     against K1 row by row bit for bit, y and y_state against the plain
     K5, y's steps past each row's length 0 in a block that held a
     sentinel, 2 binds; and K5 over 260 rows (two launches of its by-value
     rows: the staged K5 at the flagship, the generic one at R=9 in bf16)
     against the same rows fed as two batches, bit for bit
 10. K2 and K3 at the flagship (the staged step: the staged K4 on K1's own
     stream, ops/persistent.py::generation_route): vs plain over 16 steps
     of request 1 (K2 forcing its samples), each timed over a 256-step
     launch; then in each precision against the first K4's forced and
     prng (csrc/stream_generate.cu in K1's storage, launched directly: the
     route takes it only where the staged plan raises) over 2048 steps, bit
     for bit in y, p_seq, ring and y_state, each launching its kernel
     alone, both timed
 11. scoring at full width: counts set to 0 just before and read just
     after; request 1's window (16 x 8192 samples) scored from silence by
     `WaveNetInfer.score` (the time-parallel scorer: K7's gate, res/skip
     and product entries, K0a, K0c) and by K2 on the same state and
     symbols: p_seq, the final ring and y_state bit-equal; both timed;
     `scoring.score_teacher_forced_kernel` (K2) and
     `score_teacher_forced_parallel` on the same audio, bits per sample
     within 1e-5; K2 must launch on the staged step, the first K4 and the
     generic kernel not; then one scorer pass on counts of its own (L gate, L
     res/skip, 2 product, 1 K0a, 1 K0c launches); it is traced in phase 33
 12. handoff: request 1 fed in two halves equals its run; then the first
     half scored and the second fed: 0 mismatches, and the half-window
     p_seq equals the full window's first half bit for bit
 13. prng at full width: counts set to 0 just before and read just after;
     one request of 16 x 8192 samples through run_chunks(256, mode="prng"),
     its time per step beside K1's; K3 on the staged step must launch, the
     first K4 and the generic kernel not
 14. K4 (weight streaming; the staged K4 of csrc/staged_generate.cu
     wherever its plan holds) vs plain, TEST_CONFIG_MED, B=4, T=19, in each
     storage (fp32, bf16, int8) and mode (sample, argmax with the dump,
     forced, prng): 0 integer mismatches, ring, p_seq and dumps within the
     ladder; a 7-of-8 n_valid call and an 11 + 8 split, with and without
     prefetch: 0 mismatches in y, ring bits and y_state
 15. K4 at the flagship (the staged K4's route checked): the six schedules
     (stream_group_size 1, 3, 8 x stream_prefetch) identical in each
     storage; K4 against K1 fed the storage's values over 2048 steps, bit
     for bit in y, ring and y_state; K4-forced against K2 (p_seq bits) and
     K4-prng against K3 in each storage, K2/K3 fed its values; each
     storage timed over a 256-step launch; then in each storage K4
     against the plain version on the storage's values over 16 steps
     (timed): y and y_state exact, the ring within the ladder, and
     K4-forced fed the plain samples gives p_seq within the ladder
 16. the MANYBLOCK main path: counts set to 0 just before and read just
     after; the main path's 3 requests through
     WaveNetInfer(implementation=Impl.MANYBLOCK).run_chunks(256) in each
     storage (fp32: every sample equal to the main path's; bf16/int8:
     request 1's first 256 equal to K1 on the storage's values); kHz per
     utterance, K4's and K1's us per step; the staged K4 must have
     launched, K1 and the first K4 not
 17. config 4 (40 layers, R=128, S=256, A=256, max_dilation 128, B=64):
     K4 in each storage against K1 on the storage's values over 1024 steps,
     and with bf16 and int8 stacks in fast and bf16 over 256, bit for bit;
     K4 in each storage and K1 timed over a 256-step launch; one MANYBLOCK
     request of 256 on counts of its own (the staged K4 alone)
 17b. the geometries the staged plan rejects (fault F2): A=2048 and R=512
     (2 layers) in each precision, R=9 in bf16: K1 (sample; argmax with
     the dump), K5 (one ragged tick), K2 and K3 (forced and prng: their
     route is the first K4 in K1's storage) against their plain versions,
     each on counts of its own (the route's kernel launched once, the
     staged one not; 0 mismatches in y and y_state in the case's own
     precision, forced p_seq within 1e-6, the others as phase 23); at each
     of them (fault F3 at R=512 and R=9: the first K4's general instance)
     the first K4 in each storage and precision the case runs, mode sample
     against the generic K1 and modes forced and prng against the generic
     kernel's K2 and K3, all on the storage's values, bit for bit (y, ring,
     y_state, p_seq), each launching alone; a MANYBLOCK request per storage
     at A=2048 and R=512 (the first K4 launched, the staged K4 not); each
     kernel timed at A=2048; then at GENERIC_ONLY_CFG, where the first K4's
     plan raises too, K2 and K3 on the generic kernel (their route) against
     their plain versions in the exact precision
 18. score -> feed under MANYBLOCK int8 (fault R9 of the JAX engine): score
     the first half of a 2048-step flagship window, feed the second: equal
     to one int8 generation, and the scored ring equal to the generated one
     bit for bit
 19. K6 (the collapsed chain) vs plain, TEST_CONFIG_MED, B=4, T=16, on the
     same prepared weights: every mode x {fp32, fast_math} unpacked, and
     pack_gates in sample/fp32 and forced/fast_math: forced p_seq within
     1e-5, sampled symbols >= 99% equal (mismatches printed), the ring
     within the xt ladder and y_state equal on the rows whose samples
     agree; a 7 + 9 split equal to one call (y, ring bits, y_state);
     pack_gates on and off equal in y.  K6 is the cluster K6
     (csrc/fused_chain.cu) wherever ops/fused_chain.py::fused_route names
     it: here and in phases 20-22, 26, 27 and 31-32
 20. the TV contract on the card: the hot case of
     tests/test_low_precision.py (6L, R=32, S=128, A=256, B=8, T=256), K6
     forced on K1's samples against K2: fp32 max TV and max |dp| < 5e-4;
     fast_math mean < 0.025, p99 < 0.10, max < 0.20 and TV > 0 against fp32
     K6; bf16 weights mean < 0.02, max < 0.15; K2-fast, K2-bf16 and
     K6-bf16 forced on the same symbols: mean < 0.025, p99 < 0.10, max <
     0.20, TV > 0
 21. K6 at the flagship, B=16: forced on request 1's first 256 samples
     against K2 (max TV < 5e-4); timed over a 256-step launch in fp32 and
     fast_math, pack_gates on and off, beside K1 and beside the first K6
     (named by route=); fast_math against the plain version over 16 steps
     (timed)
 21b. the cluster K6's one-row groups (plan.rows = 1): B=3 at
     TEST_CONFIG_MED and the speculative draft's b=1 at the flagship, T=16,
     each mode in each precision against its plain version (forced p_seq
     within 1e-5, sampled >= 99%), each call launching its cluster K6
     instance alone; then the kernel against fused_chain.cluster_model, the
     plain model of its sums that the CPU tests hold, at TEST_CONFIG_MED,
     B=4 (two-row groups) and B=3, T=8, every mode and precision: y, ring
     bits, y_state and p_seq bits equal
 22. the latency-tier main path: counts set to 0 just before and read just
     after; the main path's 3 requests through
     WaveNetInfer(priority="latency").run_chunks(256), kHz per utterance
     beside K1's and K4's; the cluster K6 must have launched, K1 and the
     first K6 not; a dump run on the
     same engine equal to a default engine's bit for bit (y, p); 16
     lockstep feeds of 160 samples through it, per-feed wall time p50/p99,
     equal to request 1's samples
 22b. the first K6 (csrc/fused_chain_first.cu) at a geometry only it runs
     (6 layers, R=40: the cluster plan needs R a multiple of 16), B=4,
     T=16: the route names it with the cluster plan's error; each mode in
     each precision against its plain version (forced p_seq within 1e-5,
     sampled >= 99%), each call launching the first K6 alone; timed
 23. the fast and bf16 instances vs plain, TEST_CONFIG_MED, B=4, T=8: K1
     (sample; argmax with the dump), K2 (forced), K3 (prng), K5 (a ragged
     call), K4 in each storage and mode, K6-bf16 in each mode: sampled
     symbols agree on >= 99% (mismatches printed), forced p_seq within a
     mean TV of 1e-3 and a max of 0.05, the ring within the xt ladder,
     y_state equal where the symbols agree, the dumps within 1e-2
 24. bit for bit in fast and bf16: K4 against K1 in each storage over 2048
     flagship steps (y, ring bits, y_state), K4-forced against K2 and
     K4-prng against K3; the bf16 scorer (WaveNetInfer(compute_dtype=
     torch.bfloat16).score_device) against K2-bf16 on request 1's window
     (p_seq, ring bits, y_state); a bf16 score -> feed handoff over 1024
 25. the main path in bf16 and in fast: counts set to 0 just before and
     read just after; the main path's 3 requests, a prng and a forced
     request of 1024 (K1 of that precision must launch, exact K1 not; the
     prng and the forced request on the staged step of that precision, on
     counts of their own, the first K4 and the generic kernel not), kHz
     per utterance
     beside K1-exact's; request 1's first 8 samples
     against the plain version (>= 99% equal); one MANYBLOCK request of
     each precision on its own counts (K4 of that precision must launch)
     equal to that precision's request 1
 26. the latency tier's slot handover: SERVE's scenario cut to 48 ticks
     through WaveNetInfer(priority="latency"), fast and with
     compute_dtype=torch.bfloat16; counts set to 0 just before and read
     just after: K5 of that precision and K6 must launch, exact K5 and the
     first K6 not;
     per-feed p50/p99; the utterances begun at the partial reset or later,
     replayed lockstep without fuse_chain: 0 mismatches
 27. every fast and bf16 instance timed over a 256-step flagship launch (K5:
     a 160-step ragged tick) beside its exact instance (exact, fast, bf16,
     exact; K4 with fp32 stacks beside the exact turns), and its plain
     version over 8 steps; then the staged K1/K5 against their floors in
     this call (K1 exact no slower than K4 fp32, the tick within 11.5 ms,
     fast and bf16 within 1.05x exact), logged
 28. P1 (the FMA-contraction probe, csrc/probes.cu built with -fmad=false
     and with -fmad=true; 16-byte vectors) on the JAX probe's 131,072
     inputs: the guarded form and the -fmad=false plain form 0 bit
     mismatches against numpy's separate a*b+c; the -fmad=true plain form's
     mismatches against separate and against the fp64 FMA printed (the
     contraction); an offset view (the scalar path) and 2^24 elements 0 bits
     against the plain version; each timed beside the plain version and
     torch.addcmul, by events over back-to-back calls and by device time
     (100 launches in a CUDA graph), at both shapes; the wrapper's host path
     per call (checks, allocation, stream lookup, the ctypes call)
 29. P5 (the stage-chain probe) against its plain version on a 4-step chain
     of 3 stages at R=64, B=1 and 16, each precision x W layout (L2, shared
     memory, the TMA stream, the cluster of 8 CTAs) x gate, one row and the
     whole batch a CTA or cluster; each compiled instance of the stream and
     the cluster (rows a thread 1, 2, 4; R=64 and R=32; two groups) on the
     same chain; and one step at the timed shapes (B=16, D=43): exact bit
     for bit, fast within 1e-5; each call on counts set to 0 just before
     it, its layout's kernel launching alone
 30. P5 timed: the JAX probe's variants and the card's own (rows per CTA,
     the four W layouts) with T cut to 1024, ns per
     stage, and the clusters the card holds at once; the least exact
     stage at B=16, D=43 over the layouts is utils/profiling.STAGE_NS,
     logged with latency_floor_khz() beside K1's kHz per utterance of phase 7
 31. speculative decode at the flagship: request 1's first 2048 samples at
     b=1 and b=16 through WaveNetInfer.run_speculative, fixed and
     adaptive (window 256), each on counts set to 0 just before it and
     read just after (K6-fast, K7's three entries, K0a, K0c, K0b must
     launch): 0 integer
     mismatches against run() of the same engine; rounds, branch and kHz
     per utterance beside run()'s; the same for bf16 weights and
     MANYBLOCK int8 over 512 samples at window 128
 32. the speculative cost fit at b=1: a round's time at windows 64, 128 and
     256 (the mean of 3 runs after a warm-up), least squares V0 + V1 K, E0 run()'s time per step (K1), the
     adaptive branch over every probe result (speculative.DEFAULT_COST)
 32b. the training path at configs/config.json's full width (16 layers,
     R=64, S=256, A=256, max_dilation 128, batch 4 of 16,000 samples,
     synthetic clips): 20 steps through the training CLI in "highest" (every
     loss finite, the mean of the last 5 below the first 5's), the
     checkpoint loaded back bit for bit, the trained model exported to a
     WaveNetInfer on the card and the first batch's first 4096 samples
     scored teacher forced by score_device (the scorer, on counts set to 0
     just before it: K7 and K0c must launch) and by K2: p within 1e-3 of
     the softmax of the training logits, and the two equal bit for bit;
     tools/inference.py on the checkpoint for one mel of 1 s (a wav of the
     mel's length, not silent, K1 launching on counts set to 0 just before
     it); 5 steps timed in "highest" and in "default" (TF32): ms a step
     split into forward, backward and optimizer, audio samples a second,
     peak memory above what earlier phases hold; the TF32 flags as before
     the phase
 32c. the mesh at full width (`parallel/mesh.py`, `WaveNetInfer(mesh=)`):
     the flagship at B=16 split over two shards of one card
     (`data_mesh(2, [cuda:0, cuda:0])`), default selectors: 4096 samples
     through run_chunks(256) equal to the unsharded engine bit for bit (y,
     y_state, ring), K1 launching twice as often (each shard its own launch
     on its own stream); over 1024 samples the same for MANYBLOCK int8 (the
     staged K4), priority="latency" (the cluster K6) and a forced dump,
     mode prng with each shard's rows equal to an 8-row engine seeded with
     `mesh.shard_key(seed, k)` (the shards' draws differing), a score ->
     feed handoff and export -> a fresh mesh engine -> import; two
     processes of this script (`--mesh-worker`) sharing the card, joined by
     `initialize_multihost` on gloo at 127.0.0.1, each generating its 8
     rows through set_inputs with its own inputs, equal to the
     single-process run given their selectors; every card where there
     are several; kHz per utterance of the mesh beside the unsharded
     engine's, in turns
 32d. the user's tools on phase 32b's trained model: `NVWaveNet.infer`
     from its export_weights equal to the engine's run bit for bit,
     `torch_import` of its state_dict (exports equal, conditioning within
     1e-5 of get_cond_input), `nvw-torch-verify` (exit 0) and
     `eval_checkpoint` on its checkpoint (finite bits per sample below
     log2(256) = 8, the scorer and K1 launching)
 32e. tensor and sequence parallel training at configs/config.json's
     width (batch 4 x 16,000, "highest"): the one-process step on the card
     and its gradient in float64; 8 processes of this script
     (`--train-worker`) sharing the card on gloo take one step each on the
     meshes data 1 x model 2 (through the training CLI), data 1 x seq 2
     and data 2 x model 2 x seq 2 from the same seed and batch: the loss
     within 1e-5 of the one-process step's, every gathered gradient within
     rtol 1e-4 and atol 1e-5 of the one-process step's and of the float64
     gradient (the one-process fp32 step within the same of float64, a
     "default" TF32 step not), the parameters after Adam within 2.1 lr, each
     collective checkpoint loaded into a one-process model bit for bit;
     5 steps of each mesh timed (the one-process step before and after),
     the bytes and host time of each collective; a data 1 x model 2 step
     and a one-process step traced inside a worker, split into forward,
     backward and Adam by kernel group
 33. the scorer pass of phase 11 traced with torch.profiler: its device
     time by kernel group (K7's gate, res/skip and product entries, K0a,
     K0c, torch's own kernels) and their shares; its Chrome trace under
     build/traces/.  It comes last: once the profiler has started, CUPTI
     stays attached and slows every later launch
 34. the `kernels` JSON line: per kernel its launches on its path (K5: the
     serving phase; K0a, K0c, K7, K2 (the staged step): the scoring phase;
     K3 (the staged step): the prng request; K4: the MANYBLOCK main path;
     K6: the latency-tier main path; each fast and bf16 instance: its
     phase 25 or 26 path; the generic K1/K5, the first K4 and
     the generic K2/K3: phase 17b; the first K6: phase 22b; P1,
     P5: the probe phases), its
     time, the
     plain version's, the least time the card could take for the same work
     (bound_ms) and, where one PyTorch call computes the same function, that
     call's time

A line "[time] <seconds>: <phase>" marks the start of each phase.  The last
three lines of standard output are the kernels line, the card's
name and power limit, and {"ok": true, "device": {...}}.  Imports nothing of
jax or of the JAX package.  Exits non-zero, printing no result, when
torch.cuda.is_available() is false or the port is not beside this file.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores and HBM3 bandwidth; the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the fp32 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# K7's contract rounds every product and sum (FMUL + FADD, no FFMA): half
# the fp32 rate is the most its operations can issue at
PEAK_NOFMA_FLOPS = PEAK_FP32_FLOPS / 2

# fp32 operations of one element of the canonical exact math
# (ops/exact_math.py, one op per line of the normative lowering)
EXP_OPS = 25            # clamp 2, k 3, r 4, r2 r4 2, pA 4, pB 2, pC 1, p 4, 2^k 2, scale 1
RECIP_OPS = 21          # e2 e4 e8 3, q0..q4 10, h0 h1 4, y 4
TANH_SMALL_OPS = 17     # |x| and branch 2, u u2 2, a b c 6, q 4, x + (x u) q 3
TANH_LARGE_OPS = 53     # |x| and branch 2, -2|x| 1, exp, e2+e2 1, recip, 1 - . 2, sign 1
SIGMOID_OPS = 50        # -|x| 2, exp, recip, branch and e r 2
PHILOX_OPS = 103        # 10 rounds of 2 mul-hi, 2 mul-lo, 4 xor, 2 key adds; 3 to map

MAIN_B, MAIN_T, MAIN_CHUNK, MAIN_REQUESTS, CHECK_T = 16, 8192, 256, 3, 256
HORIZON_B, HORIZON_T, HORIZON_CHUNK = 16, 4096, 256
# K5 against its plain version: TEST_CONFIG_MED, 4 rows, 6 ticks of <= 16
K5_SMALL_B, K5_SMALL_TICKS, K5_SMALL_T = 4, 6, 16
# the serving phase: 16 slots, 192 ticks of at most 160 samples (10 ms of
# 16 kHz audio); a row's tick takes 0 samples (a stalled frontend) with
# probability 1/8, else [40, 160]; utterances of [2048, 8192] samples
SERVE = dict(B=16, ticks=192, tick_t=160, len_min=40, p_stall=1 / 8,
             utt_min=2048, utt_max=8192,
             full_reset_tick=8, lockstep_ticks=4,      # the R3 sequence:
             partial_tick=16, partial_rows=(0, 1, 2, 3),  # full, then partial
             migrate_tick=40)                          # the R7 sequence
SERVE_REPLAY = 16   # the first utterances completed, replayed lockstep
# steps of the exact kernels' checks against their plain versions at the
# flagship (K1, K2, K3, K4, K5, K6): the plain step costs ~32 ms there
FLAG_PLAIN_T = 16
# K5's launch at the flagship (`k5_card_check`): K5_CARD_B rows over
# K5_CARD_TICKS ragged ticks of at most K5_CARD_T steps
K5_CARD_B, K5_CARD_TICKS, K5_CARD_T = 16, 64, 8
# a batch past K5's rows a launch (csrc/staged_generate.cu kRaggedRows, 256)
# runs in groups: K5_GROUP_B rows over K5_GROUP_TICKS ticks of at most
# K5_GROUP_T steps, held against the same rows fed as two batches
K5_GROUP_B, K5_GROUP_SPLIT, K5_GROUP_TICKS, K5_GROUP_T = 260, 256, 3, 4
# K7 at the scorer's flagship products, (entry, M, K, N): "gate" is the
# dilated layer (x_{t-d} Wprev + x_t Wcur + zb, then tanh * sigmoid; N = R,
# its halves K x 2R), "res_skip" the res/skip product with the residual and
# skip adds (N = R + S = 320, R = K), "matmul" the output stack (256 x 256,
# out and end); at the window (16 x 8192 rows) and a 4096-row verify, and a
# ragged case (the gate at R = 36 of tests/test_torch_fused.py, res/skip
# with S = 37, a product with K = 37, N = 50).  tools/scorer_ab.py times
# the product entry against another tree's in turns.
K7_WINDOW_M = 16 * 8192
K7_SHAPES = tuple((e, M, K, N) for M in (K7_WINDOW_M, 4096)
                  for e, K, N in (("gate", 64, 64), ("res_skip", 64, 320),
                                  ("matmul", 256, 256))
                  ) + (("gate", 1000, 36, 36), ("res_skip", 1000, 36, 73),
                       ("matmul", 1000, 37, 50))
# K0a's device times: the JAX probe's 450,020 floats and the scorer's
# embedding tanh over [B T, R] at the window
K0A_SHAPES = ((450020,), (16 * 8192, 64))
# K0c: za [rows, A] at the verify and window shapes (the warp instance) and
# at A = 250 (the block instance)
K0C_SHAPES = ((4096, 256), (K7_WINDOW_M, 256), (4096, 250))
# K0b: za [rows, A] at the timed shape (the warp instance), A = 250 (the
# block instance), A = 1024 (the widest warp instance) and speculative
# decode's select_window at b=1, [SPEC_WINDOW, 256]; each with rows at sel
# 1.0 (the silence fallback), sel 0, tied logits and -inf logits
K0B_SHAPES = ((4096, 256), (4096, 250), (4096, 1024), (256, 256))
K0B_TURNS = 2   # rounds of (old, new, new, old) at the first shape
# the training path (phase 32b): configs/config.json's model (the reference's
# pytorch/config.json), TRAIN_STEPS steps through the training CLI, the
# train <-> infer hold over TRAIN_SCORE_T teacher-forced steps within the
# contract's p tolerance (tests/test_engine.py:57-64), TRAIN_TIMED steps
# timed in each precision
TRAIN_CONFIG = os.path.join("configs", "config.json")
TRAIN_STEPS, TRAIN_SCORE_T, TRAIN_TIMED = 20, 4096, 5
TRAIN_P_TOL = 1e-3
PRNG_SEED = 3   # the sampling_seed of the prng request
# K4 (weight streaming): its storages, the schedules held to one another,
# the flagship window held to K1/K2/K3, config 4 of the JAX repo's
# baseline sweep (its MANYBLOCK row, tools/baseline_sweep.py:180-181) and
# the int8 score -> feed window
STORAGES = ("fp32", "bf16", "int8")
SCHEDULES = tuple((g, pf) for g in (1, 3, 8) for pf in (False, True))
SCHED_T, SCHED_SPLIT = 512, 300
K4_FLAG_T = 2048
CONFIG4 = dict(num_layers=40, R=128, S=256, A=256, max_dilation=128)
C4_B, C4_T, C4_TIME_T = 64, 1024, 256
R9_T = 2048
# the geometries the staged plan rejects (fault F2): (label, config, the
# precision whose plain version it is held to with 0 mismatches); K1 and
# K5 there run the generic kernel, and at A = 2048 MANYBLOCK the first K4;
# B=F2_B rows over F2_T steps, timed over F2_TIME_T
F2_CASES = (("A=2048", dict(num_layers=2, R=64, S=256, A=2048,
                            max_dilation=2), "exact"),
            ("R=512", dict(num_layers=2, R=512, S=256, A=256,
                           max_dilation=2), "exact"),
            ("R=9", dict(num_layers=2, R=9, S=16, A=32, max_dilation=2,
                         silence_bin=16), "bf16"))
F2_PRECISIONS = ("exact", "fast", "bf16")
# K2 and K3 on the staged step (generation_route) against the first K4's at
# the flagship, bit for bit, over K2K3_T steps in each precision
K2K3_T = 2048
# the first K6 alone: a geometry the cluster plan rejects (R not a multiple
# of 16) and the first K6 runs, B=FIRST_K6_B over FIRST_K6_T steps
FIRST_K6_CFG = dict(num_layers=6, R=40, S=128, A=256, max_dilation=8)
FIRST_K6_B, FIRST_K6_T = 4, 16
F2_B, F2_T, F2_TIME_T = 4, 16, 64
# a geometry where the staged plan and the first K4's raise (its rows of
# rs_w, 16385 wide, leave no room for two stages): K2/K3 on the generic kernel
GENERIC_ONLY_CFG = dict(num_layers=2, R=1, S=16384, A=2560, max_dilation=2)
# K1 card-wide (phase 17c): the wide vocoder's published widths
# (kan-bayashi's WaveNet, ESPnet's wavenet.py: 30 layers, R = 512, S = A =
# 256, no embedding tanh), B=WIDE_B over WIDE_T steps in two chunks (the
# second from WIDE_SPLIT) against the generic K1 and the plain version; the
# wide kernel launched at the flagship's widths against the staged K1 and at
# WIDE_SMALL (uneven slices, 12 CTAs: clusters of 4) against its plain
# model; at WIDE_PRIME (131 CTAs, a prime grid: clusters of 1) against the
# generic K1; WIDE_SOAK back-to-back launches of WIDE_T steps at the
# published widths, each against the generic K1; the step timed over
# WIDE_TIME_T steps (the generic K1's over WIDE_GENERIC_T), in turns
WIDE_CFG = dict(num_layers=30, R=512, S=256, A=256, max_dilation=512,
                tanh_embed=False)
WIDE_B, WIDE_T, WIDE_SPLIT = 16, 256, 128
WIDE_TIME_T, WIDE_GENERIC_T = 256, 8
WIDE_SMALL = dict(num_layers=3, R=12, S=20, A=32, max_dilation=2,
                  silence_bin=16, tanh_embed=False)
WIDE_PRIME = dict(num_layers=3, R=524, S=256, A=256, max_dilation=4,
                  tanh_embed=False)
WIDE_PRIME_T, WIDE_SOAK = 32, 50
K4_SMALL_T = 19   # K4 vs plain at TEST_CONFIG_MED: holds the 11 + 8 split
# K6 (the collapsed chain): against its plain version at TEST_CONFIG_MED,
# B=4, over 16 steps (the plain version costs ~1 s per 32 steps), in every
# mode x {fp32, fast_math} unpacked and two packed variants (mode, fast_math,
# pack_gates); a 7 + 9 split
K6_SMALL_B, K6_SMALL_T, K6_SPLIT = 4, 16, 7
# the cluster K6's one-row groups: an odd B at TEST_CONFIG_MED and the
# speculative draft's b=1 at the flagship, against the plain version over
# K6_ODD_T steps; and the kernel against fused_chain.cluster_model bit for
# bit at TEST_CONFIG_MED, B = K6_SMALL_B (two-row groups) and K6_ODD_B (one
# row), over K6_MODEL_T steps (the model sums term by term on the CPU,
# ~0.15-0.2 s a step there)
K6_ODD_B, K6_ODD_T, K6_MODEL_T = 3, 16, 8
K6_VARIANTS = tuple((m, f, False) for m in ("sample", "argmax", "prng", "forced")
                    for f in (False, True)) + (("sample", False, True),
                                               ("forced", True, True))
# the TV contract's hot case (tests/test_low_precision.py:40-54, 109-118)
TV_CFG = dict(num_layers=6, R=32, S=128, A=256, max_dilation=8)
TV_B, TV_T, TV_SEED = 8, 256, 7
# the latency tier's lockstep feeds: 16 feeds of 160 samples (10 ms of audio)
LAT_FEEDS, LAT_FEED_T = 16, 160
# the fast and bf16 instances against their plain versions (lowp_compare):
# each run's sampled symbols agree on >= 99%; forced p_seq within a mean TV
# per step of 2e-8, the dumps within 1e-2 relative.  The limit lies between
# the sound instances' largest readings (4.7e-10 at TEST_CONFIG_MED, B=4, 8
# steps; 1.2e-9 at the flagship, B=16, 8 steps) and the control, the exact
# instance against the precision's plain version on the same symbols
# (2.0e-7 and 2.4e-7): the script fails if a control reads under it, since
# the check could then not tell a kernel that skips its roundings.  The max
# TV is no such test: one rounding of x that flips in a sound instance
# moves that step's p about as far as the control moves every step (max
# 1.4e-7 against 2.9e-7 at the flagship).  (The hot case's fp32-vs-bf16 TV
# is 5.5e-3; at these random weights p is sharper and every TV smaller.)
LOWP_AGREE, LOWP_TV, LOWP_DUMP_TOL = 0.99, 2e-8, 1e-2
LOWP_SMALL_T = 8   # steps of the small-config check (~50 ms a plain step)
LOWP_SHORT_T = 1024   # the forced and prng requests and the bf16 handoff
LOWP_SERVE_TICKS = 48   # the latency tier's slot handover: SERVE, cut
# steps of the fast and bf16 instances' checks against their plain versions
# at the flagship (also their plain_ms)
LOWP_PLAIN_T = 8
PEAK_BF16_FLOPS = 989e12   # the tensor cores, dense (fast_math's products)
# P1 by device time: launches captured in one CUDA graph (phase 28); the
# wrapper's host path per call over P1_HOST_CALLS calls
P1_GRAPH_LAUNCHES = 100
P1_HOST_CALLS = 1000
# probe P5: held against its plain version on a short chain at the
# flagship's widths (exact bit for bit, fast within P5_FAST_TOL of the
# output's largest magnitude), then at the timed shapes (B=16; D=43 with W
# in L2, SMEM_D with W in shared memory) over P5_TIMED_HELD_T steps on the
# timed launches' inputs, and timed over the JAX probe's variants with its
# T=16384 cut to P5_TIME_T.  The gated chain shrinks x about 3x a stage
# (to ~5e-20 after 43 stages, under fp32's normal range after 86), so the
# fast hold is relative and the timed shapes take one step.  P5_FAST_TOL:
# sound fast readings are ~1e-6 (PERF.md); products rounded to bf16 would
# read ~1e-3
P5_HELD_T, P5_HELD_D, P5_HELD_B, P5_FAST_TOL = 4, 3, (1, 16), 1e-5
P5_TIMED_HELD_T = 1
P5_TIME_T = 1024
# the P5 instances of the kernels line: (precision, weights, the sweep's
# label of its timed shape)
P5_INSTANCES = (("exact", "l2", "exact + gate (K1's stage)"),
                ("exact", "smem", "exact + gate, W in shared memory (D=6)"),
                ("fast", "l2", "fast + gate (the TPU probe's DEFAULT)"),
                ("fast", "smem", "fast + gate, W in shared memory (D=6)"),
                ("exact", "stream", "stream: exact + gate"),
                ("fast", "stream", "stream: fast + gate"),
                ("exact", "cluster", "cluster: exact + gate, 2 rows a cluster"),
                ("fast", "cluster", "cluster: fast + gate, 2 rows a cluster"))
# the W locations phase 29 holds at the short chain: (weights, rows a CTA
# or cluster: 1 or "B", the whole batch), the first design's and the
# Hopper layouts'; then the Hopper layouts' every instance at
# probe_stage.instance_shapes()
P5_HELD_LAYOUTS = (("l2", 1), ("smem", 1), ("l2", "B"), ("stream", 1),
                   ("stream", "B"), ("cluster", 1), ("cluster", "B"))
# speculative decode at the flagship: request 1's first SPEC_T samples at
# b=1 and b=16, fixed and adaptive at SPEC_WINDOW; bf16 weights and
# MANYBLOCK int8 over SPEC_STORE_T at SPEC_STORE_WINDOW (so the adaptive
# tier probes: 4 x 64 + 128 < 512); the cost fit's windows at b=1
SPEC_T, SPEC_WINDOW = 2048, 256
SPEC_STORE_T, SPEC_STORE_WINDOW = 512, 128
SPEC_FIT_WINDOWS = (64, 128, 256)
# runs a window of the fit, after a warm-up: one run's line moved V0 by
# ~300 us between calls on one tree (PERF.md)
SPEC_FIT_REPS = 3
# the same with a draft made wrong on purpose (rs_w + SPEC_PERT_OFFSET in its
# fold, as tests/test_torch_speculative.py's garbage draft): b=1 and b=16,
# SPEC_PERT_T samples, not a multiple of SPEC_PERT_WINDOW, so rounds commit
# part of a window and the last one is short; fixed, and adaptive with the
# costs of SPEC_PERT_COSTS forcing each branch (4 x 16 + 16 < 100 probes).
# At these weights p is sharp: this draft misses once in 100 steps at b=1,
# on ~40 steps at b=16 (a negated rs_w missed none at b=1)
SPEC_PERT_T, SPEC_PERT_WINDOW, SPEC_PERT_OFFSET = 100, 16, 0.5
SPEC_PERT_COSTS = {0: (1.0, 0.0, 1e9), 1: (-1.0, 1.0, 1e9), 2: None}
# the mesh at full width (phase 32c): the flagship's batch split over two
# shards of one card, default selectors from MESH_SEED's conditioning;
# MESH_T samples through run_chunks(MAIN_CHUNK) for K1 and the speed turns,
# MESH_TIER_T for the other tiers (the handoff and migration at
# MESH_SPLIT), MESH_MP_T in each of the two processes
MESH_T, MESH_TIER_T, MESH_MP_T, MESH_SPLIT, MESH_SEED = 4096, 1024, 1024, \
    640, 7
MESH_WORKER_TIMEOUT = 300
# tensor and sequence parallel training (phase 32e): configs/config.json's
# model and batch over TP_WORKERS processes of this script sharing the
# card on gloo; the meshes (data, model, seq), each held for one step with
# the JAX package's tolerances (tests/test_train.py:140-153) but the
# gradients' atol: the loss within TP_LOSS_TOL and the parameters after
# Adam within 2.1 x lr of the one-process step's; every gradient within
# TP_GRAD_RTOL and TP_GRAD_ATOL of the one-process step's and of the
# float64 gradient.  At this width the fp32 step lies 2.9-3.4e-6 (|g -
# g64| - rtol |g64|) from float64 and from itself run again (cuDNN's
# default weight-gradient kernel sums with atomics), the meshes up to
# 4.4e-6 (PERF.md, Findings), so the tests' 1e-6 cannot hold; TP_GRAD_ATOL is
# fixed above those readings.  The one-process fp32 step is held to
# float64 at the same atol, and a "default" (TF32) step must miss it: the
# limit sees a lower precision.  TP_TIMED steps timed
TP_1X2, TP_1X1X2, TP_2X2X2 = (1, 2, 1), (1, 1, 2), (2, 2, 2)
TP_MESHES = (TP_1X2, TP_1X1X2, TP_2X2X2)
TP_WORKERS, TP_TIMED, TP_WORKER_TIMEOUT = 8, 5, 300
TP_LOSS_TOL, TP_GRAD_RTOL, TP_GRAD_ATOL = 1e-5, 1e-4, 1e-5
# the user's tools (phase 32d) on phase 32b's trained model: TOOLS_B clips
# of TOOLS_CLIP samples; eval_checkpoint over TOOLS_SECONDS of a clip;
# torch_import's conditioning within TOOLS_COND_TOL of get_cond_input's
TOOLS_B, TOOLS_CLIP, TOOLS_SECONDS, TOOLS_COND_TOL = 2, 4000, 0.5, 1e-5
START = time.perf_counter()


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def mark(phase: str):
    """Log the seconds since the script started, at a phase's start."""
    log(f"[time] {time.perf_counter() - START:.1f} s: {phase}")


def rel_close(a, b, tol, atol=None) -> bool:
    """The reference ladder's two-sided relative check with an absolute
    floor (tests/test_golden_vs_scan.py::rel_close)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = tol * 1e-2 if atol is None else atol
    return bool(np.all(np.abs(b - a) <= tol * np.abs(a) + atol))


def dense_sweep():
    """The dense input sweep of tests/test_exact_math.py, from its seed."""
    import numpy as np
    rng = np.random.RandomState(0)
    return np.concatenate([
        rng.uniform(-95, 95, 200000),
        rng.uniform(-8, 8, 100000),
        rng.uniform(-0.6, 0.6, 100000),
        rng.uniform(-0.01, 0.01, 50000),
        np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, np.nextafter(0.5, 0.0),
                  np.nextafter(0.5, 1.0), 87.9, -86.9, -87.0, 88.0, 200.0,
                  -200.0, 50.0, -50.0, 1e-20, -1e-20, 2e-38, -2e-38]),
    ]).astype(np.float32)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_ops_per_row_step(cfg) -> int:
    """Operations of one sample of one batch row: the matrix products (2 per
    multiply-add) plus the elementwise work of the canonical step."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    macs = L * (2 * R * 2 * R + R * (R + S)) + S * A + A * A
    gate = TANH_LARGE_OPS + SIGMOID_OPS + 1            # per gate channel
    elementwise = (R * (1 + TANH_LARGE_OPS)            # embedding + tanh
                   + L * (R * (4 + gate) + 2 * (R + S))  # z, gate, biases
                   + S + A                             # relu skip, relu zs
                   + A * (2 + EXP_OPS + A.bit_length() - 1 + 2))  # sampler
    return 2 * macs + elementwise


def k1_bytes(cfg, B: int, T: int, live: int | None = None) -> int:
    """Each input read once, each output written once: weights, cond_pre
    and selectors of the row-steps that run (`live`, default all T * B),
    the FIFO ring and y_state in and out, y."""
    L, R = cfg.num_layers, cfg.R
    live = T * B if live is None else live
    return 4 * (cfg.param_count() + live * L * 2 * R + live
                + 2 * cfg.ring_size * B * R + 2 * 2 * B + T * B)


def k5_bytes(cfg, B: int, T: int, live: int) -> int:
    """K1's count over the live row-steps, plus the per-row clocks (int64)
    and lengths (int32)."""
    return k1_bytes(cfg, B, T, live) + 12 * B


def serve_scenario(torch, np, make_engine, cfg, dev, rng, gen, B, ticks,
                   tick_t, len_min, p_stall, utt_min, utt_max,
                   full_reset_tick, lockstep_ticks, partial_tick,
                   partial_rows, migrate_tick):
    """Serve utterances in B slots of one streaming engine, tick by tick.

    Each utterance has a length from [utt_min, utt_max] and its own
    conditioning and injected selectors, drawn on `dev` from `gen`.  A
    ragged tick gives each row 0 samples (probability p_stall) or
    [len_min, tick_t], at most what its utterance has left, through
    `feed(lengths=...)`.  A row whose utterance ended is handed to the next
    one by `reset_utterances`.  Before tick `full_reset_tick` every slot is
    reset (its utterance abandoned) and the next `lockstep_ticks` ticks feed
    tick_t samples to every row without lengths (the lockstep path, K1);
    before `partial_tick` the rows `partial_rows` are reset (the R3
    sequence).  Before `migrate_tick` the stream moves to a second engine
    through `export_state` -> `import_state` (the R7 sequence).  The
    schedule depends on `rng` alone, never on the samples.

    Returns (utterances in order of completion, stats)."""
    L, C = cfg.num_layers, 2 * cfg.R
    utts, live = [], [None] * B

    def start(row, tick):
        n = int(rng.randint(utt_min, utt_max + 1))
        u = {"n": n, "row": row, "start": tick, "pos": 0, "out": [],
             "end": None, "migrated": False,
             "cond": torch.rand((n, L, C), generator=gen, device=dev) - 0.5,
             "sel": torch.rand((n,), generator=gen, device=dev)}
        utts.append(u)
        live[row] = u

    eng = make_engine()
    eng.begin_stream(B)
    for b in range(B):
        start(b, 0)
    feed_ms, served, steps, dead, lock_ticks = [], 0, 0, 0, 0
    tick_of_160 = None
    for tick in range(ticks):
        done = [b for b, u in enumerate(live) if u["pos"] == u["n"]]
        forced = (range(B) if tick == full_reset_tick
                  else partial_rows if tick == partial_tick else ())
        rows = sorted(set(done) | set(forced))
        if rows:
            eng.reset_utterances(rows)
            for b in rows:
                if live[b]["pos"] == live[b]["n"]:
                    live[b]["end"] = tick
                start(b, tick)
        if tick == migrate_tick:
            snap = eng.export_state()
            if len(set(snap["stream_t_row"].tolist())) < 2:
                raise RuntimeError("migration: the rows are not desynced")
            eng = make_engine()
            eng.import_state(snap)
            for u in live:
                u["migrated"] = True
        lockstep = full_reset_tick <= tick < full_reset_tick + lockstep_ticks
        if lockstep:
            lens = np.full(B, tick_t)
            if any(u["n"] - u["pos"] < tick_t for u in live):
                raise RuntimeError("lockstep tick past an utterance's end")
        else:
            draw = np.where(rng.rand(B) < p_stall, 0,
                            rng.randint(len_min, tick_t + 1, size=B))
            lens = np.minimum(draw, [u["n"] - u["pos"] for u in live])
        tm = int(lens.max())
        cond = torch.zeros((tm, L, B, C), device=dev)
        sel = torch.zeros((tm, B), device=dev)
        for b, u in enumerate(live):
            n, p = int(lens[b]), u["pos"]
            cond[:n, :, b] = u["cond"][p:p + n]
            sel[:n, b] = u["sel"][p:p + n]
        if tm == tick_t and not lockstep and tick_of_160 is None:
            tick_of_160 = (lens.copy(),
                           eng.export_state()["stream_t_row"].copy())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        y = (eng.feed(cond, sel) if lockstep
             else eng.feed(cond, sel, lengths=lens))
        dt = time.perf_counter() - t
        if y.shape != (B, tm) or (tm and (y.min() < 0 or y.max() >= cfg.A)):
            raise RuntimeError(f"tick {tick}: malformed y {y.shape}")
        if tm:
            feed_ms.append(dt * 1e3)
        lock_ticks += lockstep
        served += int(lens.sum())
        steps += tm * B
        dead += int(tm * B - lens.sum())
        for b, u in enumerate(live):
            u["out"].append(y[b, :lens[b]])
            u["pos"] += int(lens[b])
    for u in live:
        if u["pos"] == u["n"]:
            u["end"] = ticks
    completed = sorted((u for u in utts if u["end"] is not None),
                       key=lambda u: (u["end"], u["row"]))
    stats = {"ticks": ticks, "lockstep_ticks": lock_ticks,
             "feed_ms": feed_ms, "samples_served": served,
             "row_steps": steps, "dead_row_steps": dead,
             "utterances_started": len(utts),
             "utterances_completed": len(completed),
             "tick_of_160": tick_of_160, "live": live}
    return completed, stats


def served_prefix(u) -> dict:
    """An utterance cut to the samples it has been served so far."""
    return {**u, "n": u["pos"], "cond": u["cond"][:u["pos"]],
            "sel": u["sel"][:u["pos"]]}


def replay_lockstep(torch, np, make_engine, cfg, dev, utts):
    """Replay utterances as one lockstep batch (`set_inputs` + `run`, each
    conditioning padded to the longest) on a fresh engine; returns the
    integer mismatches of each against the samples it was served."""
    B, T = len(utts), max(u["n"] for u in utts)
    cond = torch.zeros((T, cfg.num_layers, B, 2 * cfg.R), device=dev)
    sel = torch.zeros((T, B), device=dev)
    for b, u in enumerate(utts):
        cond[:u["n"], :, b] = u["cond"]
        sel[:u["n"], b] = u["sel"]
    eng = make_engine()
    eng.set_inputs(cond, sel)
    y = eng.run(T, B)
    return [int((y[b, :u["n"]] != np.concatenate(u["out"])).sum())
            for b, u in enumerate(utts)]


def k5_card_check(torch, np, persistent, tracing, cfg, params, dev) -> dict:
    """K5 at `cfg`'s widths, K5_CARD_B rows, over K5_CARD_TICKS ragged ticks
    of at most K5_CARD_T steps: rows of length 0 (one tick all of them),
    desynced clocks, a row that passes 2^31 samples and one past 2^32,
    slot resets, and at the half a weight changed in place (K5 binds anew
    and rebuilds its stream).  Held bit for bit against K1 run row by row
    on its own state (y, ring bits, y_state; the lockstep instance, K5's
    step), and against the plain K5 (`generate_plain`: y and y_state
    exactly, the ring in the reference ladder, since its products go to
    cuBLAS).  Before each launch a block of y's size is filled with a
    sentinel and freed, so that K5's y, which is not zeroed, is mostly that
    block: its steps past each row's length must read 0."""
    B, T = K5_CARD_B, K5_CARD_T
    p = {k: v.clone() for k, v in params.items()}
    rng = np.random.RandomState(2027)
    gen_cd = torch.Generator(device=dev)
    gen_cd.manual_seed(2027)
    gen5 = persistent.make_persistent_generator(cfg, B, ragged=True)
    gen1 = persistent.make_persistent_generator(cfg, 1)
    state = {k: fresh_state(torch, persistent, cfg, B, dev)
             for k in ("k5", "k1", "plain")}
    clocks = rng.randint(0, 1 << 20, size=B).astype(np.int64)
    clocks[1], clocks[2] = (1 << 31) - 3, (1 << 32) + 5
    binds0 = tracing.counters().get("k5.binds", 0)
    launches0 = persistent.RAGGED_KERNELS["exact"].launches
    out = {"ticks": K5_CARD_TICKS, "y_mismatches_k1": 0,
           "y_mismatches_plain": 0, "tail_nonzero": 0, "sentinel_reused": 0}
    for tick in range(K5_CARD_TICKS):
        n = int(rng.randint(1, T + 1))
        lens = np.where(rng.rand(B) < 0.25, 0, rng.randint(1, n + 1, B))
        if tick == 5:
            lens[:] = 0
        if tick in (9, 30, 47):
            rows = sorted(rng.choice(np.arange(3, B), 3, replace=False)
                          .tolist())   # rows 1 and 2 keep their far clocks
            for ring, ys in state.values():
                ring[:, rows] = 0
                ys[:, rows] = cfg.silence_bin
            clocks[rows] = 0
        if tick == K5_CARD_TICKS // 2:
            p["end_w"].mul_(1.25)
        cond = torch.rand((n, cfg.num_layers, B, 2 * cfg.R), generator=gen_cd,
                          device=dev) - 0.5
        cond_pre = (cond + p["dil_b"][None, :, None, :]).contiguous()
        sel = torch.rand((n, B), generator=gen_cd, device=dev)
        t0_row = torch.from_numpy(clocks.copy())
        nv_row = torch.from_numpy(lens.astype(np.int32))
        sentinel = torch.full((n, B), -7, dtype=torch.int32, device=dev)
        ptr = sentinel.data_ptr()
        del sentinel
        y5 = gen5(p, t0_row, cond_pre, sel, *state["k5"], nv_row)[0]
        out["sentinel_reused"] += int(y5.data_ptr() == ptr)
        yp = persistent.generate_plain(cfg, p, t0_row, cond_pre, sel,
                                       *state["plain"], nv_row)[0]
        y1 = torch.zeros((n, B), dtype=torch.int32, device=dev)
        ring1, ys1 = state["k1"]
        for b in range(B):
            if not lens[b]:
                continue
            r, ys = ring1[:, b:b + 1].contiguous(), ys1[:, b:b + 1].contiguous()
            y1[:, b:b + 1] = gen1(p, int(clocks[b]),
                                  cond_pre[:, :, b:b + 1].contiguous(),
                                  sel[:, b:b + 1].contiguous(), r, ys,
                                  int(lens[b]))[0]
            ring1[:, b] = r[:, 0]
            ys1[:, b] = ys[:, 0]
        past = torch.arange(n, device=dev)[:, None] >= torch.from_numpy(
            lens).to(dev)[None, :]
        out["tail_nonzero"] += int((y5[past] != 0).sum())
        out["y_mismatches_k1"] += int((y5 != y1).sum())
        out["y_mismatches_plain"] += int((y5 != yp).sum())
        clocks += lens
    torch.cuda.synchronize()
    (r5, s5), (r1, s1), (rp, sp) = (state[k] for k in ("k5", "k1", "plain"))
    out.update(
        ring_bit_mismatches_k1=bit_mismatches(torch, r5, r1),
        y_state_equal_k1=bool(torch.equal(s5, s1)),
        y_state_equal_plain=bool(torch.equal(s5, sp)),
        ring_in_ladder_plain=rel_close(rp.cpu(), r5.cpu(), 1e-2, 3e-4),
        ring_max_abs_err_plain=float((r5 - rp).abs().max()),
        launches=persistent.RAGGED_KERNELS["exact"].launches - launches0,
        binds=tracing.counters().get("k5.binds", 0) - binds0,
        clocks_past_2_31=int((clocks >= 1 << 31).sum()))
    return out


def k5_group_check(torch, np, persistent, cfg, params, dev,
                   compute_dtype=None) -> dict:
    """K5 at K5_GROUP_B rows (launched in groups of 256 rows, each from its
    first row's pointers) against the same rows fed as two batches,
    [0, K5_GROUP_SPLIT) and the rest, each on its own state: y, ring bits
    and y_state bit for bit over K5_GROUP_TICKS ticks of desynced clocks
    and lengths (some 0).  `compute_dtype` selects the precision (bf16
    keeps a bf16 ring)."""
    from nv_wavenet_tpu_torch.ops import scan_generate as tsg
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    prec = tsg.precision(compute_dtype or torch.float32)
    B, S = K5_GROUP_B, K5_GROUP_SPLIT
    parts = ((0, S), (S, B))
    gens = {n: persistent.make_persistent_generator(cfg, n, ragged=True,
                                                    **kw)
            for n in {B, S, B - S}}

    def fresh(n):
        return (persistent.init_ring(cfg, n, dev, tsg.ring_dtype(prec)),
                torch.full((2, n), cfg.silence_bin, dtype=torch.int32,
                           device=dev))
    whole = fresh(B)
    split = [fresh(b - a) for a, b in parts]
    rng = np.random.RandomState(2029)
    gen_cd = torch.Generator(device=dev)
    gen_cd.manual_seed(2029)
    clocks = rng.randint(0, 1 << 20, size=B).astype(np.int64)
    out = {"rows": B, "route": gens[B].route.kernel, "y_mismatches": 0}
    for _ in range(K5_GROUP_TICKS):
        n = K5_GROUP_T
        lens = np.where(rng.rand(B) < 0.25, 0, rng.randint(1, n + 1, B))
        lens[[0, S - 1, S, B - 1]] = n
        cond_pre = (torch.rand((n, cfg.num_layers, B, 2 * cfg.R),
                               generator=gen_cd, device=dev) - 0.5
                    + params["dil_b"][None, :, None, :]).contiguous()
        sel = torch.rand((n, B), generator=gen_cd, device=dev)
        y = gens[B](params, torch.from_numpy(clocks.copy()), cond_pre, sel,
                    *whole, torch.from_numpy(lens.astype(np.int32)))[0]
        for (a, b), (ring, ys) in zip(parts, split):
            yp = gens[b - a](params, torch.from_numpy(clocks[a:b].copy()),
                             cond_pre[:, :, a:b].contiguous(),
                             sel[:, a:b].contiguous(), ring, ys,
                             torch.from_numpy(lens[a:b].astype(np.int32)))[0]
            out["y_mismatches"] += int((y[:, a:b] != yp).sum())
        clocks += lens
    torch.cuda.synchronize()
    ring_w, ys_w = whole
    out["ring_bit_mismatches"] = sum(
        int((ring_w[:, a:b].contiguous().view(torch.int16 if prec == "bf16"
                                              else torch.int32)
             != ring.view(torch.int16 if prec == "bf16" else torch.int32))
            .sum()) for (a, b), (ring, _) in zip(parts, split))
    out["y_state_equal"] = all(torch.equal(ys_w[:, a:b], ys)
                               for (a, b), (_, ys) in zip(parts, split))
    return out


def bit_mismatches(torch, a, b) -> int:
    """Elements of two float32 tensors (or arrays) whose bits differ."""
    a, b = (torch.as_tensor(x).contiguous() for x in (a, b))
    return int((a.view(torch.int32) != b.view(torch.int32).to(a.device))
               .sum())


def fresh_state(torch, persistent, cfg, B, dev):
    """Silence: a zero FIFO ring and y_state at the silence bin."""
    return (persistent.init_ring(cfg, B, dev),
            torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                       device=dev))


def time_launch_ms(torch, np, launch, make_state, reps: int = 4) -> float:
    """Mean device time of launch(ring, y_state) by CUDA events, each from a
    fresh state, after one warm-up launch."""
    times = []
    for _ in range(reps + 1):
        ring, ys = make_state()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(ring, ys)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times[1:]))


def k0c_bound(rows: int, A: int):
    """za read and p written once; max, subtract, exp, the fixed-tree prefix
    sum (one add a round) and the division an element."""
    return bound_ms(8 * rows * A,
                    rows * A * (3 + EXP_OPS + (A - 1).bit_length()))


def check_k0c(torch, em, dev, gen) -> dict:
    """K0c's instances against the plain version at K0C_SHAPES (bit
    mismatches on the card; on the CPU too at the smaller shapes), timed
    beside the plain version and torch.softmax; "per_shape" rows, and the
    first shape's numbers at the top.  za is drawn on the card from `gen`."""
    out = {"mismatches": 0, "cpu_plain_mismatches": 0, "max_abs_err": 0.0,
           "per_shape": []}
    for rows, A in K0C_SHAPES:
        t_shape = time.perf_counter()
        za = torch.rand((rows, A), generator=gen, device=dev) * 16 - 8
        inst = em.softmax_kernel(A)
        pk = em.softmax_canonical(za)
        pp = em.softmax_canonical_plain(za)
        torch.cuda.synchronize()
        row = {"shape": [rows, A], "instance": inst.symbol,
               "mismatches": bit_mismatches(torch, pk, pp),
               "max_abs_err": float((pk - pp).abs().max()),
               "ms": time_ms(torch, lambda: em.softmax_canonical(za), 50),
               "plain_ms": time_ms(torch, lambda: em.softmax_canonical_plain(
                   za), 5),
               "library_ms": time_ms(torch, lambda: torch.softmax(za, -1), 50)}
        if rows <= 4096:
            row["cpu_plain_mismatches"] = bit_mismatches(
                torch, pk.cpu(), em.softmax_canonical_plain(za.cpu()))
            out["cpu_plain_mismatches"] += row["cpu_plain_mismatches"]
        row["bound_ms"], row["bound_by"] = k0c_bound(rows, A)
        row["check_s"] = time.perf_counter() - t_shape
        out["mismatches"] += row["mismatches"]
        out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
        out["per_shape"].append(row)
    first = out["per_shape"][0]
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        out[k] = first[k]
    return out


def k7_inputs(torch, dev, gen, entry: str, M: int, K: int, N: int):
    """Seeded (args, kwargs) of one K7 shape on the card.  The gate's zb is
    `cond[:, l]` of a [T, L, B, 2R] conditioning (B = 16, or 8 where 16
    does not divide M; L = 20), read in place; the ragged gate also adds a
    bias (the scorer's dil_b when it does not prefold)."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev) - 0.5
    if entry == "matmul":
        return (u(M, K), u(K, N)), {}
    if entry == "res_skip":
        return (u(M, K), u(K, N), u(N), u(M, K), u(M, N - K)), {}
    B = 16 if M % 16 == 0 else 8
    cond = u(M // B, 20, B, 2 * N)
    return ((u(M, K), u(M, K), u(K, 2 * N), u(K, 2 * N), cond[:, 1]),
            {"bias": u(2 * N) if M % 16 else None})


def k7_work(entry: str, M: int, K: int, N: int, z=None):
    """(product operations, other operations, bytes) of one K7 call: each
    input read once, each output written once.  The gate's tanh costs what
    its branch on this run's z takes (z [M, 2R] from the plain version)."""
    if entry == "matmul":
        return 2 * M * K * N, 0, 4 * (M * K + K * N + M * N)
    if entry == "res_skip":   # two adds an output; x and skip in and out
        return 2 * M * K * N, 2 * M * N, 4 * (M * K + K * N + N + 2 * M * N)
    R = N
    small = int((z[:, :R].abs() < 0.5).sum())
    # a + b, + zb (and + bias), tanh, sigmoid, the product: per h element
    other = (2 * M * 2 * R + small * TANH_SMALL_OPS
             + (M * R - small) * TANH_LARGE_OPS + M * R * (SIGMOID_OPS + 1))
    return (2 * 2 * M * K * 2 * R, other,
            4 * (2 * M * K + 2 * K * 2 * R + M * 2 * R + 2 * R + M * R))


K7_ENTRIES = {"matmul": ("ordered_matmul", "ordered_matmul_plain"),
              "gate": ("ordered_gate", "ordered_gate_plain"),
              "res_skip": ("ordered_res_skip", "ordered_res_skip_plain")}


def k7_outputs(f, entry: str, args, kw) -> tuple:
    """The outputs of f(*args, **kw) to compare: the res/skip entry runs on
    a copy of its skip, which it updates in place, and gives (x_out,
    skip)."""
    if entry != "res_skip":
        return (f(*args, **kw),)
    a = (*args[:4], args[4].clone())
    return f(*a, **kw), a[4]


def k0b_bound(rows: int, A: int):
    """za and sel read and y written once; max, subtract, exp, the
    fixed-tree prefix sum (one add a round), the threshold's multiply and
    the compare and count an element."""
    return bound_ms(rows * (4 * A + 4 + 4),
                    rows * A * (2 + EXP_OPS + (A - 1).bit_length() + 2))


def k0b_inputs(np, rows: int, A: int, seed: int):
    """za [rows, A] uniform in [-8, 8) and sel [rows, 1] uniform in [0, 1),
    from a seed, with 8 rows each at sel 1.0, at sel 0, of tied logits and
    with every other logit -inf."""
    rng = np.random.RandomState(seed)
    za = rng.uniform(-8, 8, (rows, A)).astype(np.float32)
    sel = rng.uniform(0, 1, (rows, 1)).astype(np.float32)
    sel[:8] = 1.0
    sel[8:16] = 0.0
    za[16:24] = 0.5
    za[24:32, ::2] = -np.inf
    return za, sel


def check_k0b(torch, np, em, scorer_ab, build, dev) -> dict:
    """K0b's instances against the plain version at K0B_SHAPES (mismatches
    on the card, and on the CPU), timed by events and by device time (a
    CUDA graph) beside the plain version; the sel = 1.0 rows' mismatches
    and how many took the silence bin (all of them unless the fixed tree
    rounds a partial sum above cum[A-1]) are kept apart.  Then the block instance (the kernel before the warp per
    row) and the warp instance in turns at the first shape, old / new /
    new / old, K0B_TURNS times.  "per_shape" rows, and the first shape's
    numbers at the top."""
    out = {"mismatches": 0, "cpu_plain_mismatches": 0, "per_shape": []}
    for i, (rows, A) in enumerate(K0B_SHAPES):
        t_shape = time.perf_counter()
        za_np, sel_np = k0b_inputs(np, rows, A, 40 + i)
        za, sel = torch.from_numpy(za_np).to(dev), torch.from_numpy(
            sel_np).to(dev)
        inst = em.sample_kernel(A)
        before = inst.launches
        yk = em.sample_from_logits(za, sel, 128)
        yp = em.sample_from_logits_plain(za, sel, 128)
        torch.cuda.synchronize()
        y_cpu = em.sample_from_logits_plain(za.cpu(), sel.cpu(), 128)
        row = {"shape": [rows, A], "instance": inst.symbol,
               "launched": inst.launches - before,
               "mismatches": int((yk != yp).sum()),
               "cpu_plain_mismatches": int((yk.cpu() != y_cpu).sum()),
               "sel1_rows_mismatches": int((yk[:8] != yp[:8]).sum()),
               "sel1_rows_silent": int((yk[:8] == 128).sum()),
               "ms": time_ms(torch, lambda: em.sample_from_logits(
                   za, sel, 128), 50),
               "device_ms": scorer_ab.graph_ms(
                   torch, lambda: em.sample_from_logits(za, sel, 128)),
               "plain_ms": time_ms(torch, lambda: em.sample_from_logits_plain(
                   za, sel, 128), 5)}
        row["bound_ms"], row["bound_by"] = k0b_bound(rows, A)
        row["check_s"] = time.perf_counter() - t_shape
        out["mismatches"] += row["mismatches"]
        out["cpu_plain_mismatches"] += row["cpu_plain_mismatches"]
        if row["launched"] != 1:
            fail(f"K0b at {row['shape']}: {row['launched']} launches of "
                 f"{inst.symbol}")
        out["per_shape"].append(row)
        if i == 0:
            turn_in = (za, sel, torch.empty(rows, dtype=torch.int32,
                                            device=dev), rows, A)
    first = out["per_shape"][0]
    for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
              "instance"):
        out[k] = first[k]
    za, sel, y, rows, A = turn_in

    def launch(kernel):
        return lambda: kernel(za.data_ptr(), sel.data_ptr(), y.data_ptr(),
                              rows, A, 128, build.current_stream(dev))
    turns = {"old (block)": {"device_ms": [], "ms": []},
             "new (warp)": {"device_ms": [], "ms": []}}
    for _ in range(K0B_TURNS):
        for label, kernel in (("old (block)", em.SAMPLE_BLOCK_KERNEL),
                              ("new (warp)", em.SAMPLE_KERNEL),
                              ("new (warp)", em.SAMPLE_KERNEL),
                              ("old (block)", em.SAMPLE_BLOCK_KERNEL)):
            turns[label]["device_ms"].append(scorer_ab.graph_ms(
                torch, launch(kernel)))
            turns[label]["ms"].append(time_ms(torch, launch(kernel), 50))
    out["turns"] = {"shape": [rows, A], **turns}
    return out


def train_timed_steps(torch, trainer, precision_scope, state, mel, audio,
                      n: int) -> dict:
    """n steps of trainer.train_step's body on one batch after a warm-up
    step, each cut by CUDA events into forward (with the loss), backward
    and optimizer; ms a step (their sum) and audio samples a second over
    the batch, the losses, and the peak memory over the n steps above what
    was allocated before them (earlier phases keep tensors alive)."""
    trainer.train_step(state, mel, audio)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    parts, losses = [], []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with precision_scope(state.module.precision):
            ev[0].record()
            state.optimizer.zero_grad(set_to_none=True)
            loss = trainer.cross_entropy_loss(state.model(mel, audio), audio)
            ev[1].record()
            loss.backward()
            ev[2].record()
            state.optimizer.step()
            ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(float(loss.detach()))
    fwd, bwd, opt = (sum(p[i] for p in parts) / n for i in range(3))
    step_ms = fwd + bwd + opt
    return {"steps": n, "ms_per_step": step_ms, "forward_ms": fwd,
            "backward_ms": bwd, "optimizer_ms": opt,
            "audio_samples_per_s": audio.numel() / (step_ms / 1e3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated() - base,
            "losses": losses}


def check_training(torch, np, all_kernels, persistent, params_lib, om, em,
                   dev, card) -> dict:
    """The training path at configs/config.json's full width (phase 32b):
    TRAIN_STEPS steps through the training CLI in "highest", a checkpoint
    saved and loaded, the trained model's teacher-forced p on the card
    (the scorer through score_device, and K2) against the softmax of its
    training logits, tools/inference.py on the checkpoint, and steps timed
    in "highest" and "default" (TF32)."""
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.models import wavenet as wavenet_lib
    from nv_wavenet_tpu_torch.tools import inference
    from nv_wavenet_tpu_torch.train import cli, trainer
    from nv_wavenet_tpu_torch.train.data import (Mel2Samp,
                                                 data_config_from_json,
                                                 mel_spectrogram,
                                                 synthetic_clips)

    out = {"card": card}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    work = os.path.join(HERE, "build", "train_smoke")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(HERE, TRAIN_CONFIG)) as f:
        cfg_json = json.load(f)
    train_c = cfg_json["train_config"]
    cfg_json["train_config"] = dict(
        train_c, output_directory=os.path.join(work, "ckpt"),
        num_iters=TRAIN_STEPS, iters_per_checkpoint=TRAIN_STEPS,
        checkpoint_path="", with_tensorboard=True)
    config = os.path.join(work, "config.json")
    with open(config, "w") as f:
        json.dump(cfg_json, f)
    out["config"] = {k: cfg_json[k] for k in ("wavenet_config",
                                              "train_config")}

    # 1. the CLI: TRAIN_STEPS steps in "highest", a checkpoint at the end
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    state, losses = cli.main(["-c", config])
    torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t
    out["cli_peak_memory_bytes"] = torch.cuda.max_memory_allocated() - base
    out["losses"] = losses
    # seconds from the loop's start to each step's loss (metrics.jsonl): the
    # first step carries the start-up (cuDNN's first calls)
    with open(os.path.join(work, "ckpt", "metrics.jsonl")) as f:
        out["cli_elapsed_s"] = [json.loads(l)["elapsed_s"] for l in f]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    out["loss_first5_mean"], out["loss_last5_mean"] = first, last
    if (len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses))
            or not last < first):
        fail(f"training: {len(losses)} losses, finite "
             f"{bool(np.all(np.isfinite(losses)))}, mean of the first 5 "
             f"{first} and of the last 5 {last}: {losses}")
    model = state.module
    if next(model.parameters()).device.type != "cuda":
        fail("training: the CLI did not train on the card")

    # 2. the checkpoint loads into a fresh state, bit for bit
    ckpt_dir = os.path.join(work, "ckpt")
    fresh = trainer.create_train_state(
        trainer.create_model(cfg_json["wavenet_config"]),
        trainer.TrainConfig(seed=train_c.get("seed", 1234) + 1), dev)
    fresh, it = trainer.load_checkpoint(ckpt_dir, None, fresh)
    want, got = model.state_dict(), fresh.module.state_dict()
    out["checkpoint"] = {"iteration": it, "tensors": len(want),
                         "equal": all(torch.equal(want[k], got[k])
                                      for k in want)}
    if it != TRAIN_STEPS or not out["checkpoint"]["equal"]:
        fail(f"training: the checkpoint did not round-trip: "
             f"{out['checkpoint']}")
    del fresh

    # 3. train <-> infer on the card: the first batch the CLI trained on,
    # teacher forced over TRAIN_SCORE_T steps from y_cur = audio[:, 0]
    data_cfg = data_config_from_json(cfg_json["data_config"])
    ds = Mel2Samp(synthetic_clips(n_clips=4,
                                  length=4 * data_cfg.segment_length),
                  data_cfg, seed=train_c.get("seed", 1234))
    mel_np, audio_np = next(ds.batches(train_c["batch_size"]))
    mel = torch.from_numpy(mel_np).to(dev)
    audio = torch.from_numpy(audio_np).to(dev)
    B, Ts = audio.shape[0], TRAIN_SCORE_T
    with torch.no_grad():
        logits = model(mel, audio)                         # [B, T, A]
        cond = model._cond_acts(mel, Ts).permute(1, 2, 0, 3).contiguous()
        p_train = torch.softmax(logits[:, 1:Ts + 1], -1).permute(1, 0, 2)
    cfg = wavenet_lib.config_of(model)
    canon = wavenet_lib.export_canonical(model)
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, tanh_embed=cfg.tanh_embed,
                       chunk_size=MAIN_CHUNK, device=dev)
    eng.set_canonical_params(canon)
    eng.begin_stream(B)
    y_state = np.stack([np.full(B, cfg.silence_bin, np.int32),
                        audio_np[:, 0].astype(np.int32)])
    eng.import_state({"ring": np.zeros((cfg.ring_size, B, cfg.R), np.float32),
                      "y_state": y_state, "stream_t_row": np.zeros(B, np.int64),
                      "stream_t": np.asarray(0), "stream_batch": np.asarray(B)})
    symbols = audio[:, 1:Ts + 1].T.contiguous()            # [Ts, B]
    for k in all_kernels:
        k.launches = 0
    p_score = eng.score_device(cond, symbols)              # [Ts, B, A]
    torch.cuda.synchronize()
    score_launches = {k.symbol: k.launches for k in all_kernels if k.launches}
    params = params_lib.canonical_to_torch(canon, dev)
    gen = persistent.make_persistent_generator(cfg, B, mode="forced")
    k2 = gen.route.cuda_kernel("exact")
    ring = persistent.init_ring(cfg, B, dev)
    ys = torch.from_numpy(y_state).to(dev)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    k2.launches = 0
    p_k2 = gen(params, 0, cond_pre, symbols.to(torch.float32), ring, ys)[-1]
    torch.cuda.synchronize()
    out["train_infer"] = {
        "steps": Ts, "batch": B, "k2": k2.symbol, "k2_launches": k2.launches,
        "score_launches": score_launches,
        "score_max_abs_err": float((p_score - p_train).abs().max()),
        "k2_max_abs_err": float((p_k2 - p_train).abs().max()),
        "score_vs_k2_bit_mismatches": bit_mismatches(torch, p_score, p_k2),
        "p_tolerance": TRAIN_P_TOL}
    ti = out["train_infer"]
    if (ti["score_max_abs_err"] > TRAIN_P_TOL
            or ti["k2_max_abs_err"] > TRAIN_P_TOL or not ti["k2_launches"]
            or ti["score_vs_k2_bit_mismatches"]
            or not score_launches.get(om.ORDERED_GATE_KERNEL.symbol)
            or not score_launches.get(em.SOFTMAX_KERNEL.symbol)):
        fail(f"training: train <-> infer on the card: {ti}")
    del logits, p_train, p_score, p_k2, cond, cond_pre

    # 4. tools/inference.py on the checkpoint: one mel of 1 s, K1 on the card
    clip = synthetic_clips(n_clips=1, length=data_cfg.sampling_rate,
                           sr=data_cfg.sampling_rate, seed=9)[0]
    mel_1s = mel_spectrogram(clip, data_cfg)
    np.save(os.path.join(work, "mel_0.npy"), mel_1s)
    with open(os.path.join(work, "mels.txt"), "w") as f:
        f.write(os.path.join(work, "mel_0.npy") + "\n")
    for k in all_kernels:
        k.launches = 0
    t = time.perf_counter()
    written = inference.main(["-c", ckpt_dir, "-f",
                              os.path.join(work, "mels.txt"), "-o",
                              os.path.join(work, "wav"), "--config", config])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t
    from scipy.io import wavfile
    sr, wav = wavfile.read(written[0])
    k1 = persistent.PERSISTENT_KERNELS["exact"]
    out["inference_cli"] = {
        "wav": os.path.relpath(written[0], HERE), "sr": int(sr),
        "samples": int(wav.shape[0]),
        "expected_samples": mel_1s.shape[0] * cfg_json["wavenet_config"][
            "upsamp_stride"],
        "nonzero_samples": int(np.count_nonzero(wav)),
        "distinct_values": int(len(np.unique(wav))),
        "k1_launches": k1.launches,
        "launches": {k.symbol: k.launches for k in all_kernels if k.launches},
        "s": infer_s}
    ic = out["inference_cli"]
    if (ic["samples"] != ic["expected_samples"] or ic["distinct_values"] < 2
            or not ic["k1_launches"] or sr != data_cfg.sampling_rate):
        fail(f"training: tools/inference.py on the checkpoint: {ic}")

    # 5. steps timed in "highest" (the trained state, the same batch) and in
    # "default" (TF32; a fresh model)
    out["highest"] = train_timed_steps(
        torch, trainer, wavenet_lib.precision_scope, state, mel, audio,
        TRAIN_TIMED)
    del state, model
    torch.cuda.empty_cache()
    default = trainer.create_train_state(
        trainer.create_model(dict(cfg_json["wavenet_config"],
                                  precision="default")),
        trainer.TrainConfig(seed=train_c.get("seed", 1234)), dev)
    out["default"] = train_timed_steps(
        torch, trainer, wavenet_lib.precision_scope, default, mel, audio,
        TRAIN_TIMED)
    if not all(np.isfinite(out[p]["losses"]).all()
               for p in ("highest", "default")):
        fail(f"training: a timed step's loss is not finite: "
             f"{out['highest']['losses']} {out['default']['losses']}")
    after = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    out["tf32_flags_before_after"] = (flags, after)
    if after != flags:
        fail(f"training: the TF32 flags were {flags} before the phase and "
             f"{after} after it")
    return out


def check_k7(torch, om, dev, gen) -> dict:
    """K7's three entries against their plain versions at K7_SHAPES (bit
    mismatches of every output), timed beside the plain version and
    torch.matmul (the fused entries: no single torch call), with the bound
    and the no-FMA floor (operations over PEAK_NOFMA_FLOPS).  Returns
    {"per_shape": rows, "mismatches": total, "max_abs_err": max}."""
    out = {"mismatches": 0, "max_abs_err": 0.0, "per_shape": []}
    for entry, M, K, N in K7_SHAPES:
        t_shape = time.perf_counter()
        args, kw = k7_inputs(torch, dev, gen, entry, M, K, N)
        fn, plain = (getattr(om, n) for n in K7_ENTRIES[entry])
        z = None
        if entry == "gate":
            zb = args[4] if kw["bias"] is None else kw["bias"] + args[4]
            z = (om.ordered_matmul_plain(args[0], args[2])
                 + om.ordered_matmul_plain(args[1], args[3])) + zb.reshape(
                     M, 2 * N)
        yk = k7_outputs(fn, entry, args, kw)
        yp = k7_outputs(plain, entry, args, kw)
        torch.cuda.synchronize()
        reps = 10 if M >= K7_WINDOW_M else 50
        row = {"entry": entry, "shape": [M, K, N],
               "mismatches": sum(bit_mismatches(torch, a, b)
                                 for a, b in zip(yk, yp)),
               "max_abs_err": max(float((a - b).abs().max())
                                  for a, b in zip(yk, yp)),
               "ms": time_ms(torch, lambda: fn(*args, **kw), reps),
               "plain_ms": time_ms(torch, lambda: plain(*args, **kw), 1),
               "library_ms": None}
        if entry == "matmul":
            row["cublas_max_abs_diff"] = float(
                (yk[0] - args[0] @ args[1]).abs().max())
            row["library_ms"] = time_ms(
                torch, lambda: torch.matmul(args[0], args[1]), reps)
        prod_ops, other_ops, n_bytes = k7_work(entry, M, K, N, z)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes,
                                                    prod_ops + other_ops)
        row["nofma_floor_ms"] = (prod_ops + other_ops) / PEAK_NOFMA_FLOPS * 1e3
        row["product_tflops"] = prod_ops / row["ms"] / 1e9
        out["mismatches"] += row["mismatches"]
        out["max_abs_err"] = max(out["max_abs_err"], row["max_abs_err"])
        row["check_s"] = time.perf_counter() - t_shape
        out["per_shape"].append(row)
        del args, kw, yk, yp, z
    return out


def horizon_plain(torch, np, cfg_lib, params_lib, persistent):
    """The horizon case of tests/test_torch_generate.py, from its seeds: the
    plain version's HORIZON_B x HORIZON_T draws on the CPU.  Returns (cfg,
    canonical weights, cond, sel, y)."""
    hcfg = cfg_lib.WaveNetConfig(num_layers=4, R=32, S=128, A=256,
                                 max_dilation=4)
    rng = np.random.RandomState(123)
    h_ref = params_lib.to_canonical(
        params_lib.random_reference_weights(hcfg, seed=321), hcfg)
    h_cond = rng.uniform(-0.5, 0.5, (HORIZON_T, hcfg.num_layers, HORIZON_B,
                                     2 * hcfg.R)).astype(np.float32)
    h_sel = rng.uniform(0, 1, (HORIZON_T, HORIZON_B)).astype(np.float32)
    h_params = params_lib.canonical_to_torch(h_ref, torch.device("cpu"))
    cond_pre = (torch.from_numpy(h_cond)
                + h_params["dil_b"][None, :, None, :]).contiguous()
    ring = persistent.init_ring(hcfg, HORIZON_B, "cpu")
    y_state = torch.full((2, HORIZON_B), hcfg.silence_bin, dtype=torch.int32)
    y = persistent.generate_plain(hcfg, h_params, 0, cond_pre,
                                  torch.from_numpy(h_sel), ring, y_state,
                                  HORIZON_T)[0]
    return hcfg, h_ref, h_cond, h_sel, y


def storage_kw(torch, name: str, engine: bool = False) -> dict:
    """The keywords of a K4 storage for make_persistent_generator, or with
    engine=True for WaveNetInfer."""
    if name == "int8":
        return {"stream_quant": "int8" if engine else True}
    return {"weight_dtype": torch.bfloat16 if name == "bf16"
            else torch.float32}


def storage_view(persistent, params, kw: dict):
    """The fp32 values K4 computes with under the storage `kw`."""
    import torch
    return persistent.value_view(params, kw.get("weight_dtype", torch.float32),
                                 bool(kw.get("stream_quant", False)))


def plan_dict(torch, persistent, cfg, B: int, name: str) -> dict:
    """The plan of the K4 a storage runs (`generation_route`: the staged
    K4's, or the first K4's), as JSON."""
    storage = {"fp32": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}[name]
    route = persistent.generation_route(cfg, B, stream_weights=True,
                                        storage=storage)
    plan = {k: (str(v) if isinstance(v, torch.dtype) else v)
            for k, v in route.plan._asdict().items()}
    if "matrices" in plan:
        plan["matrices"] = [m._asdict() for m in route.plan.matrices]
    return {**plan, "kernel": route.kernel, "storage": name}


def k4_bytes(cfg, B: int, T: int, name: str) -> int:
    """K1's count with the two stacks in their storage (and the int8
    scales): each input read once, each output written once."""
    L, R, S = cfg.num_layers, cfg.R, cfg.S
    stack = L * (2 * R * 2 * R + R * (R + S))
    eb = {"fp32": 4, "bf16": 2, "int8": 1}[name]
    return (k1_bytes(cfg, B, T) - 4 * stack + eb * stack
            + (4 * L * (2 * R + R + S) if name == "int8" else 0))


def k4_ops(cfg, B: int, T: int, name: str) -> int:
    """K1's operations over B x T row-steps, plus under int8 one rounded
    multiply per weight (the dequantisation, whose value is the same at
    every row-step: the function needs it once per call)."""
    L, R, S = cfg.num_layers, cfg.R, cfg.S
    return k1_ops_per_row_step(cfg) * B * T + (
        L * (2 * R * 2 * R + R * (R + S)) if name == "int8" else 0)


def check_k4_small(torch, np, persistent, cfg, params, cond, sel, dev) -> dict:
    """K4 against its plain version at a small config, in every storage:
    modes sample, argmax with the dump, forced (K4's sample output as the
    symbols) and prng; then a 7-of-8 n_valid call against a 7-step call and
    an 11 + 8 split against one 19-step call, with and without prefetch."""
    T, B = sel.shape
    ladder = (("xt", 1e-2, 3e-4), ("skip", 1e-2, 3e-4), ("zs", 1e-4, 2e-5),
              ("za", 1e-4, 2e-5), ("p", 1e-3, None))
    res = {"mismatches": 0, "p_err": 0.0, "ring_err": 0.0, "ok": True,
           "runs": 0}

    def fresh():
        return fresh_state(torch, persistent, cfg, B, dev)
    for name in STORAGES:
        kw = storage_kw(torch, name)
        view = storage_view(persistent, params, kw)
        cp = (cond + view["dil_b"][None, :, None, :]).contiguous()
        sym = None
        for mode, dump in (("sample", False), ("argmax", True),
                           ("forced", False), ("prng", False)):
            s_in = sym if mode == "forced" else sel
            gen = persistent.make_persistent_generator(
                cfg, B, mode=mode, dump=dump, stream_weights=True, **kw)
            out_k = gen(params, 0, cp, s_in, *fresh(), seed=PRNG_SEED)
            out_p = persistent.generate_plain(cfg, view, 0, cp, s_in, *fresh(),
                                              T, mode=mode, dump=dump,
                                              seed=PRNG_SEED)
            torch.cuda.synchronize()
            mism = (int((out_k[0] != out_p[0]).sum())
                    + int(not torch.equal(out_k[2], out_p[2])))
            ring_err = float((out_k[1] - out_p[1]).abs().max())
            ok = rel_close(out_p[1].cpu(), out_k[1].cpu(), 1e-2, 3e-4)
            if dump:
                ok &= all(rel_close(p.cpu(), k.cpu(), tol, atol)
                          for (_, tol, atol), k, p
                          in zip(ladder, out_k[3:8], out_p[3:8]))
            p_err = (float((out_k[-1] - out_p[-1]).abs().max())
                     if mode == "forced" else 0.0)
            ok &= p_err <= 1e-6
            if mode == "sample":
                sym = out_k[0].to(torch.float32)
            log(f"[K4 small] {name} {mode}{' + dump' if dump else ''}: y and "
                f"y_state {mism} mismatches vs plain; ring max abs err "
                f"{ring_err:.3g}, in ladder {ok}; p_seq err {p_err:.3g}")
            res["mismatches"] += mism
            res["ring_err"] = max(res["ring_err"], ring_err)
            res["p_err"] = max(res["p_err"], p_err)
            res["ok"] &= ok
            res["runs"] += 1
        for prefetch in (False, True):
            gen = persistent.make_persistent_generator(
                cfg, B, stream_weights=True, stream_prefetch=prefetch, **kw)
            r7, r8 = fresh(), fresh()
            y7 = gen(params, 0, cp[:7].contiguous(), sel[:7].contiguous(),
                     *r7)[0]
            y8 = gen(params, 0, cp[:8].contiguous(), sel[:8].contiguous(),
                     *r8, n_valid=7)[0]
            ra, rb = fresh(), fresh()
            y19 = gen(params, 0, cp[:19].contiguous(), sel[:19].contiguous(),
                      *ra)[0]
            ys = [gen(params, 0, cp[:11].contiguous(),
                      sel[:11].contiguous(), *rb)[0],
                  gen(params, 11, cp[11:19].contiguous(),
                      sel[11:19].contiguous(), *rb)[0]]
            torch.cuda.synchronize()
            m7 = (int((y8[:7] != y7).sum()) + int(y8[7].abs().sum())
                  + bit_mismatches(torch, r7[0], r8[0])
                  + int(not torch.equal(r7[1], r8[1])))
            m19 = (int((torch.cat(ys) != y19).sum())
                   + bit_mismatches(torch, ra[0], rb[0])
                   + int(not torch.equal(ra[1], rb[1])))
            log(f"[K4 small] {name} prefetch={prefetch}: 7-of-8 call vs 7 "
                f"steps {m7} mismatches (y, ring bits, y_state); 11 + 8 vs "
                f"19 steps {m19}")
            res["mismatches"] += m7 + m19
    return res


def check_k4_flagship(torch, np, persistent, cfg, params, cond, sel,
                      dev) -> dict:
    """At the flagship, B=16: the six schedules (stream_group_size x
    stream_prefetch, each as a 300 + 212 split) identical in every storage;
    K4 against K1 fed the storage's values over K4_FLAG_T steps, bit for
    bit in y, the ring and y_state; K4-forced p_seq against K2's and
    K4-prng against K3's, K2/K3 fed the storage's values, in every
    storage; each timed over a 256-step launch."""
    T, B = K4_FLAG_T, MAIN_B
    cp_raw, sel = cond[:T], sel[:T].contiguous()
    res = {"schedule_mismatches": 0, "k1_mismatches": 0, "k4_ms": {},
           "bound": {}, "schedule_ms": {}}

    def fresh():
        return fresh_state(torch, persistent, cfg, B, dev)
    k1 = persistent.make_persistent_generator(cfg, B)
    for name in STORAGES:
        kw = storage_kw(torch, name)
        view = storage_view(persistent, params, kw)
        cp = (cp_raw + view["dil_b"][None, :, None, :]).contiguous()
        base = None
        for g, pf in SCHEDULES:
            gen = persistent.make_persistent_generator(
                cfg, B, stream_weights=True, stream_group_size=g,
                stream_prefetch=pf, **kw)
            ring, ys = fresh()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y = torch.cat([
                gen(params, 0, cp[:SCHED_SPLIT], sel[:SCHED_SPLIT], ring,
                    ys)[0],
                gen(params, SCHED_SPLIT, cp[SCHED_SPLIT:SCHED_T],
                    sel[SCHED_SPLIT:SCHED_T], ring, ys)[0]])
            end.record()
            torch.cuda.synchronize()
            res["schedule_ms"][f"{name} G={g} prefetch={pf}"] = (
                start.elapsed_time(end))
            if base is None:
                base = (y, ring, ys)
                continue
            res["schedule_mismatches"] += (
                int((y != base[0]).sum()) + bit_mismatches(torch, ring, base[1])
                + int(not torch.equal(ys, base[2])))
        gen = persistent.make_persistent_generator(cfg, B, stream_weights=True,
                                                   **kw)
        if gen.route.kernel != "staged_stream":
            fail(f"K4 {name} at the flagship routed to {gen.route.kernel}")
        out4 = gen(params, 0, cp, sel, *fresh())
        out1 = k1(view, 0, cp, sel, *fresh())
        torch.cuda.synchronize()
        mism = (int((out4[0] != out1[0]).sum())
                + bit_mismatches(torch, out4[1], out1[1])
                + int(not torch.equal(out4[2], out1[2])))
        res["k1_mismatches"] += mism
        res["k4_ms"][name] = time_launch_ms(torch, np, lambda r, ys: gen(
            params, 0, cp[:CHECK_T], sel[:CHECK_T], r, ys), fresh)
        res["bound"][name] = bound_ms(k4_bytes(cfg, B, CHECK_T, name),
                                      k4_ops(cfg, B, CHECK_T, name))
        log(f"[K4 flagship] {name}: K4 vs K1 on the storage's values over "
            f"{T} steps: {mism} mismatches (y, ring bits, y_state); "
            f"{res['k4_ms'][name]:.3f} ms per {CHECK_T}-step launch = "
            f"{res['k4_ms'][name] / CHECK_T * 1e3:.2f} us per step; "
            f"schedules (ms per {SCHED_T} steps): " + ", ".join(
                f"G={g} pf={int(pf)} {res['schedule_ms'][f'{name} G={g} prefetch={pf}']:.2f}"
                for g, pf in SCHEDULES))
        # K4-forced against K2 and K4-prng against K3, K2/K3 fed the
        # storage's values, K4-forced K1's samples
        sym = out1[0].to(torch.float32)
        k2 = persistent.make_persistent_generator(cfg, B, mode="forced")
        k3 = persistent.make_persistent_generator(cfg, B, mode="prng")
        f4 = persistent.make_persistent_generator(cfg, B, mode="forced",
                                                  stream_weights=True, **kw)
        p4 = persistent.make_persistent_generator(cfg, B, mode="prng",
                                                  stream_weights=True, **kw)
        del out1, out4
        o2, o4 = k2(view, 0, cp, sym, *fresh()), f4(params, 0, cp, sym,
                                                      *fresh())
        torch.cuda.synchronize()
        fm = (bit_mismatches(torch, o4[-1], o2[-1])
              + bit_mismatches(torch, o4[1], o2[1])
              + int((o4[0] != o2[0]).sum())
              + int(not torch.equal(o4[2], o2[2])))
        del o2, o4
        o3, o5 = (k3(view, 0, cp, sel, *fresh(), seed=PRNG_SEED),
                  p4(params, 0, cp, sel, *fresh(), seed=PRNG_SEED))
        torch.cuda.synchronize()
        pm = (int((o5[0] != o3[0]).sum())
              + bit_mismatches(torch, o5[1], o3[1])
              + int(not torch.equal(o5[2], o3[2])))
        res["forced_mismatches"] = res.get("forced_mismatches", 0) + fm
        res["prng_mismatches"] = res.get("prng_mismatches", 0) + pm
        log(f"[K4 flagship] {name}: K4-forced vs K2 over {T} steps: {fm} "
            f"mismatches (p_seq, ring bits, y, y_state); K4-prng vs K3: {pm}")
    log(f"[K4 flagship] schedules G x prefetch in {SCHEDULES}: "
        f"{res['schedule_mismatches']} mismatches against the first")
    return res


def check_k4_plain_flagship(torch, persistent, tsg, em, cfg, params, cond,
                            sel, dev) -> dict:
    """At the flagship, B=16, in every storage: K4 against the plain version
    on the storage's values over FLAG_PLAIN_T steps (the plain version's
    time is taken on the way).  y and y_state exact, the ring within the
    ladder; K4-forced fed the plain version's samples gives p_seq within
    the ladder of the plain distributions."""
    T, B = FLAG_PLAIN_T, MAIN_B
    s_in = sel[:T].contiguous()
    res = {"mismatches": 0, "ring_err": 0.0, "p_err": 0.0, "ok": True,
           "plain_ms": {}}

    def fresh():
        return fresh_state(torch, persistent, cfg, B, dev)
    for name in STORAGES:
        kw = storage_kw(torch, name)
        view = storage_view(persistent, params, kw)
        cp = (cond[:T] + view["dil_b"][None, :, None, :]).contiguous()
        ring_p, ys_p = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        y_p, _, za_p = tsg.run_steps(view, cfg, 0, cp, s_in, ring_p, ys_p, T,
                                     record="za")
        torch.cuda.synchronize()
        res["plain_ms"][name] = (time.perf_counter() - t) * 1e3
        p_p = em.softmax_canonical_plain(za_p)
        out4 = persistent.make_persistent_generator(
            cfg, B, stream_weights=True, **kw)(params, 0, cp, s_in, *fresh())
        f4 = persistent.make_persistent_generator(
            cfg, B, mode="forced", stream_weights=True, **kw)(
                params, 0, cp, y_p.to(torch.float32), *fresh())
        torch.cuda.synchronize()
        mism = (int((out4[0] != y_p).sum()) + int(not torch.equal(out4[2], ys_p))
                + int((f4[0] != y_p).sum()) + int(not torch.equal(f4[2], ys_p)))
        ring_err = max(float((o[1] - ring_p).abs().max()) for o in (out4, f4))
        p_err = float((f4[-1] - p_p).abs().max())
        ok = (rel_close(ring_p.cpu(), out4[1].cpu(), 1e-2, 3e-4)
              and rel_close(ring_p.cpu(), f4[1].cpu(), 1e-2, 3e-4)
              and rel_close(p_p.cpu(), f4[-1].cpu(), 1e-3))
        log(f"[K4 flagship] {name}: K4 vs plain over {T} steps: y and y_state "
            f"{mism} mismatches (sample and forced); ring max abs err "
            f"{ring_err:.3g}, p_seq {p_err:.3g}, in ladder {ok}; plain "
            f"{res['plain_ms'][name]:.1f} ms")
        res["mismatches"] += mism
        res["ring_err"] = max(res["ring_err"], ring_err)
        res["p_err"] = max(res["p_err"], p_err)
        res["ok"] &= ok
    return res


def check_config4(torch, np, persistent, tsg, cfg_lib, params_lib,
                  WaveNetInfer, Impl, dev, all_kernels) -> dict:
    """Config 4 (CONFIG4, B=C4_B): K4 in every storage against K1 fed the
    storage's values over C4_T steps, and with bf16 and int8 stacks in fast
    and bf16 against K1 of that precision over C4_TIME_T, bit for bit in y,
    the ring and y_state; K4 in every storage and K1 timed over a
    C4_TIME_T-step launch; one MANYBLOCK request of C4_TIME_T samples (the
    staged K4 must launch, K1 and the first K4 not)."""
    cfg = cfg_lib.WaveNetConfig(**CONFIG4)
    B, T = C4_B, C4_T
    ref_w = params_lib.random_reference_weights(cfg, seed=4)
    params = params_lib.canonical_to_torch(params_lib.to_canonical(ref_w,
                                                                   cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    cond = torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                      device=dev) - 0.5
    sel = torch.rand((T, B), generator=g, device=dev)
    n = C4_TIME_T
    res = {"mismatches": 0, "ms": {}, "bound": {}, "routes": {},
           "per_case": {}}

    def fresh(prec="exact"):
        return (persistent.init_ring(cfg, B, dev, tsg.ring_dtype(prec)),
                torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                           device=dev))
    k1 = persistent.make_persistent_generator(cfg, B)
    for prec in ("exact", "fast", "bf16"):
        kw = prec_kw(torch, prec)
        k1p = persistent.make_persistent_generator(cfg, B, **kw)
        steps = T if prec == "exact" else n
        for name in STORAGES if prec == "exact" else ("bf16", "int8"):
            skw = storage_kw(torch, name)
            view = storage_view(persistent, params, skw)
            cpv = (cond[:steps] + view["dil_b"][None, :, None, :]
                   ).contiguous()
            gen = persistent.make_persistent_generator(
                cfg, B, stream_weights=True, **skw, **kw)
            res["routes"][f"{name} {prec}"] = gen.route.kernel
            out4 = gen(params, 0, cpv, sel[:steps], *fresh(prec))
            out1 = k1p(view, 0, cpv, sel[:steps], *fresh(prec))
            torch.cuda.synchronize()
            mism = (int((out4[0] != out1[0]).sum())
                    + bit_mismatches(torch, out4[1].float(), out1[1].float())
                    + int(not torch.equal(out4[2], out1[2])))
            del out1, out4
            res["per_case"][f"{name} {prec}"] = mism
            res["mismatches"] += mism + (gen.route.kernel != "staged_stream")
            if prec == "exact":
                cpn = cpv[:n].contiguous()
                res["ms"][name] = time_launch_ms(torch, np, lambda r, ys: gen(
                    params, 0, cpn, sel[:n], r, ys), fresh, reps=2)
                res["bound"][name] = bound_ms(k4_bytes(cfg, B, n, name),
                                              k4_ops(cfg, B, n, name))
    cp = (cond[:n] + params["dil_b"][None, :, None, :]).contiguous()
    res["ms"]["K1"] = time_launch_ms(torch, np, lambda r, ys: k1(
        params, 0, cp, sel[:n], r, ys), fresh, reps=2)
    res["bound"]["K1"] = bound_ms(k1_bytes(cfg, B, n),
                                  k1_ops_per_row_step(cfg) * B * n)
    # one MANYBLOCK request at config 4 (fp32 stacks), on counts of its own
    eng = WaveNetInfer(**CONFIG4, max_batch=B, chunk_size=n, device="cuda",
                       implementation=Impl.MANYBLOCK)
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond[:n], sel[:n])
    for k in all_kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.run(n, B)
    torch.cuda.synchronize()
    res["manyblock_khz_per_utt"] = n / (time.perf_counter() - t) / 1e3
    res["manyblock_launches"] = {k.symbol: k.launches for k in all_kernels
                                 if k.launches}
    want = persistent.PERSISTENT_KERNELS["exact"].symbol
    if set(res["manyblock_launches"]) != {want}:
        fail(f"the config 4 MANYBLOCK request did not run on the staged K4 "
             f"alone: {res['manyblock_launches']}")
    res["plan"] = {name: plan_dict(torch, persistent, cfg, B, name)
                   for name in STORAGES}
    log(f"[config 4] 40L R128 S256 A256 maxD128, B={B}: K4 vs K1 on the "
        f"storage's values (y, ring bits, y_state; exact over {T} steps, "
        f"fast/bf16 over {n}): {res['per_case']}; routes {res['routes']}; "
        f"us per step over {n}-step launches: " + ", ".join(
            f"{k} {v / n * 1e3:.1f}" for k, v in res["ms"].items())
        + f"; a MANYBLOCK request {res['manyblock_khz_per_utt']:.3f} kHz per "
        f"utterance, launches {res['manyblock_launches']}")
    return res


def check_fallbacks(torch, np, persistent, tsg, cfg_lib, params_lib,
                    WaveNetInfer, Impl, dev, all_kernels) -> dict:
    """The geometries the staged plan rejects (fault F2 of ROADMAP.md):
    at each of F2_CASES, in each of its precisions, K1 (sample; argmax with
    the dump), K5 (one ragged tick), K2 and K3 (forced and prng, routed to
    the first K4) against their plain versions on the card, each on counts
    of its own: the route's kernel must launch once and the staged one
    not; y and y_state exact in the case's own precision (the ring within
    the ladder, forced p_seq within 1e-6; the other precisions as
    lowp_compare).  Then at each case, where the staged K4's plan raises
    too: the first K4 in every storage and precision against the generic
    kernel (K1, K2, K3) fed the storage's values, bit for bit in y, ring,
    y_state and p_seq, and one MANYBLOCK request per storage (the first K4
    must launch, the staged K4 not).  Each kernel timed at its case
    (F2_TIME_T steps, B=F2_B).  Last, K2 and K3 on the generic kernel at
    GENERIC_ONLY_CFG (`check_generic_only`)."""
    res = {"mismatches": 0, "ring_err": 0.0, "ok": True, "launches": {},
           "ms": {}, "plain_ms": {}, "bound": {}, "runs": []}
    B, T = F2_B, F2_T
    counts = lambda: {k.symbol: k.launches for k in all_kernels}  # noqa: E731

    def zero():
        for k in all_kernels:
            k.launches = 0
    for label, ckw, own in F2_CASES:
        cfg = cfg_lib.WaveNetConfig(**ckw)
        params = params_lib.canonical_to_torch(params_lib.to_canonical(
            params_lib.random_reference_weights(cfg, seed=21), cfg), dev)
        g = torch.Generator(device=dev)
        g.manual_seed(21)
        cond = torch.rand((F2_TIME_T, cfg.num_layers, B, 2 * cfg.R),
                          generator=g, device=dev) - 0.5
        sel = torch.rand((F2_TIME_T, B), generator=g, device=dev)
        cp = (cond + params["dil_b"][None, :, None, :]).contiguous()
        cpn, seln = cp[:T].contiguous(), sel[:T].contiguous()
        t0_row = torch.tensor([0, 5, 2, 9], dtype=torch.int64)
        nv_row = torch.tensor([T, 0, 7, 3], dtype=torch.int32)
        symn = torch.randint(0, cfg.A, (T, B), device=dev, generator=torch.
                             Generator(device=dev).manual_seed(22)).float()
        for prec in F2_PRECISIONS if label != "R=9" else (own,):
            kw = prec_kw(torch, prec)
            view = tsg.product_view(params, prec)

            def fresh():
                return (persistent.init_ring(cfg, B, dev, tsg.ring_dtype(prec)),
                        torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                                   device=dev))
            for mode, dump, ragged in (("sample", False, False),
                                       ("argmax", True, False),
                                       ("sample", False, True),
                                       ("forced", False, False),
                                       ("prng", False, False)):
                gen = persistent.make_persistent_generator(
                    cfg, B, mode=mode, dump=dump, ragged=ragged, **kw)
                route = gen.route
                # lockstep exact generation without a dump at R = 512 runs
                # K1 card-wide (phase 17c), K2 and K3 the first K4 in K1's
                # storage, the rest the generic kernel
                scored = mode in ("forced", "prng")
                want = ("stream" if scored else "wide" if label == "R=512"
                        and prec == "exact" and not (dump or ragged)
                        else "generic")
                if route.kernel != want or scored and (
                        route.plan.storage != persistent.staged_storage(prec)):
                    fail(f"F2 {label} {prec} {mode}: routed to "
                         f"{route.kernel}, not {want}")
                s_in = symn if mode == "forced" else seln
                zero()
                if ragged:
                    out_k = gen(params, t0_row, cpn, seln, *fresh(), nv_row)
                else:
                    out_k = gen(params, 0, cpn, s_in, *fresh(),
                                seed=PRNG_SEED)
                torch.cuda.synchronize()
                n_l = counts()
                sym = route.cuda_kernel(prec).symbol
                staged = (persistent.RAGGED_KERNELS if ragged
                          else persistent.PERSISTENT_KERNELS)[prec].symbol
                if n_l[sym] != 1 or n_l[staged] or sum(n_l.values()) != 1:
                    fail(f"F2 {label} {prec}: the route's {sym} did not "
                         f"launch alone: {n_l}")
                key = {"generic": f"{'K5' if ragged else 'K1'} {prec}",
                       "wide": "K1 wide",
                       "stream": f"K4 first {prec}"}[want]
                res["launches"][key] = res["launches"].get(key, 0) + 1
                out_p = persistent.generate_plain(
                    cfg, view, t0_row if ragged else 0, cpn, s_in, *fresh(),
                    nv_row if ragged else T, mode=mode, dump=dump,
                    seed=PRNG_SEED, prec=prec)
                torch.cuda.synchronize()
                if prec == own:
                    mism = (int((out_k[0] != out_p[0]).sum())
                            + int(not torch.equal(out_k[2], out_p[2])))
                    ring_err = float((out_k[1].float() - out_p[1].float())
                                     .abs().max())
                    ok = rel_close(out_p[1].float().cpu(),
                                   out_k[1].float().cpu(), 1e-2, 3e-4)
                    if mode == "forced":
                        ok &= float((out_k[3] - out_p[3]).abs().max()) <= 1e-6
                else:
                    r = lowp_compare(torch, np, out_k, out_p, mode, dump)
                    mism, ring_err, ok = 0, r["ring_err"], r["ok"]
                res["mismatches"] += mism
                res["ring_err"] = max(res["ring_err"], ring_err)
                res["ok"] &= bool(ok)
                res["runs"].append(f"{label} {prec} {mode}"
                                   f"{' + dump' if dump else ''}"
                                   f"{' ragged' if ragged else ''}: {mism}")
                log(f"[F2] {label} {prec} {'K5 tick' if ragged else mode}"
                    f"{' + dump' if dump else ''}: route {route.kernel} "
                    f"({sym} launched once); {mism} mismatches vs plain "
                    f"(y, y_state), ring max abs err {ring_err:.3g}, ok {ok}")
                if label == F2_CASES[0][0] and mode == "sample":
                    # timed at this case, F2_TIME_T steps (K5: the tick)
                    res["ms"][key] = time_launch_ms(
                        torch, np, (lambda r_, y_: gen(
                            params, t0_row, cpn, seln, r_, y_, nv_row))
                        if ragged else (lambda r_, y_: gen(
                            params, 0, cp, sel, r_, y_)), fresh, reps=2)
                    st = fresh()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    persistent.generate_plain(
                        cfg, view, t0_row if ragged else 0, cpn, seln, *st,
                        nv_row if ragged else T, prec=prec)
                    torch.cuda.synchronize()
                    res["plain_ms"][key] = (time.perf_counter() - t) * 1e3
                    live = int(nv_row.sum()) if ragged else None
                    steps = T if ragged else F2_TIME_T
                    res["bound"][key] = (
                        bound_ms(k1_bytes(cfg, B, steps, live)
                                 + (12 * B if ragged else 0),
                                 k1_ops_per_row_step(cfg)
                                 * (live or B * steps))
                        if prec == "exact" else
                        lowp_bound(cfg, B, steps, prec, live=live))
        # the first K4 (the staged K4's plan raises at every F2 geometry; at
        # R = 512 and R = 9 in bf16 its general instance, fault F3) in every
        # storage and precision the case runs: mode sample against the
        # route's K1 (generic or card-wide), forced and prng against the
        # generic kernel's K2 and K3, all fed the storage's values, bit for
        # bit
        precs = F2_PRECISIONS if label != "R=9" else (own,)
        for prec in precs:
            kw = prec_kw(torch, prec)

            def fresh():
                return (persistent.init_ring(cfg, B, dev, tsg.ring_dtype(prec)),
                        torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                                   device=dev))
            for name in STORAGES if prec == "exact" else ("bf16", "int8"):
                skw = storage_kw(torch, name)
                sview = storage_view(persistent, params, skw)
                scp = (cond + sview["dil_b"][None, :, None, :]).contiguous()
                sym_in = torch.randint(0, cfg.A, (F2_TIME_T, B), generator=g,
                                       device=dev).to(torch.float32)
                for mode in ("sample", "forced", "prng"):
                    s_in = sym_in if mode == "forced" else sel
                    g4 = persistent.make_persistent_generator(
                        cfg, B, mode=mode, stream_weights=True, **skw, **kw)
                    if g4.route.kernel != "stream" or (
                            label != "A=2048") != g4.route.plan.general:
                        fail(f"{label} MANYBLOCK {name} {prec} {mode}: routed "
                             f"to {g4.route.kernel}")
                    if mode == "sample":
                        g1 = persistent.make_persistent_generator(
                            cfg, B, mode=mode, **kw)
                        want1 = ("wide" if label == "R=512"
                                 and prec == "exact" else "generic")
                        if g1.route.kernel != want1:
                            fail(f"{label} {prec} {mode}: routed to "
                                 f"{g1.route.kernel}, not {want1}")
                        sym1 = g1.route.cuda_kernel(prec).symbol

                        def run1(r_, y_):
                            return g1(sview, 0, scp, s_in, r_, y_)
                    else:
                        want1 = "generic"
                        gk = generic_k1(torch, persistent, cfg,
                                        tsg.product_view(sview, prec), dev,
                                        prec)
                        sym1 = persistent.GENERIC_KERNELS[prec].symbol

                        def run1(r_, y_):
                            return gk(0, scp, s_in, r_, y_, F2_TIME_T, mode,
                                      PRNG_SEED)
                    zero()
                    o4 = g4(params, 0, scp, s_in, *fresh(), seed=PRNG_SEED)
                    torch.cuda.synchronize()
                    n_l = counts()
                    zero()
                    o1 = run1(*fresh())
                    torch.cuda.synchronize()
                    n_1 = counts()
                    sym = persistent.STREAM_KERNELS[prec].symbol
                    if (n_l[sym] != 1 or sum(n_l.values()) != 1
                            or n_1[sym1] != 1 or sum(n_1.values()) != 1):
                        fail(f"{label} MANYBLOCK {name} {prec} {mode}: {sym} "
                             f"and {sym1} did not each launch alone: {n_l}, "
                             f"{n_1}")
                    key = f"K4 first {prec}"
                    res["launches"][key] = res["launches"].get(key, 0) + 1
                    if mode != "sample":
                        k1 = (f"{'K2' if mode == 'forced' else 'K3'} generic "
                              f"{prec}")
                        res["launches"][k1] = res["launches"].get(k1, 0) + 1
                    mism = (int((o4[0] != o1[0]).sum())
                            + bit_mismatches(torch, o4[1].float(),
                                             o1[1].float())
                            + int(not torch.equal(o4[2], o1[2])))
                    if mode == "forced":
                        mism += bit_mismatches(torch, o4[3], o1[3])
                    res["mismatches"] += mism
                    res["runs"].append(f"first K4 {label} {name} {prec} "
                                       f"{mode} vs {want1}: {mism}")
                    log(f"[F2] {label} first K4 {name} {prec} {mode} vs "
                        f"{want1} on the storage's values over "
                        f"{F2_TIME_T} steps: {mism} mismatches (y, ring bits, "
                        f"y_state{', p_seq bits' if mode == 'forced' else ''})")
                    if (label == F2_CASES[0][0] and mode == "sample"
                            and name == ("fp32" if prec == "exact"
                                         else "bf16")):
                        res["ms"][key] = time_launch_ms(
                            torch, np, lambda r_, y_: g4(
                                params, 0, scp, sel, r_, y_), fresh, reps=2)
                        st = fresh()
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        persistent.generate_plain(
                            cfg, tsg.product_view(sview, prec), 0, cpn, seln,
                            *st, T, prec=prec)
                        torch.cuda.synchronize()
                        res["plain_ms"][key] = (time.perf_counter() - t) * 1e3
                        res["bound"][key] = (
                            bound_ms(k4_bytes(cfg, B, F2_TIME_T, name),
                                     k4_ops(cfg, B, F2_TIME_T, name))
                            if prec == "exact" else
                            lowp_bound(cfg, B, F2_TIME_T, prec, storage=name))
                    if (label == F2_CASES[0][0] and mode != "sample"
                            and name == ("fp32" if prec == "exact"
                                         else "bf16")):
                        # the generic kernel's K2 / K3 timed here (their
                        # route only where the first K4's plan raises too)
                        k1 = (f"{'K2' if mode == 'forced' else 'K3'} generic "
                              f"{prec}")
                        res["ms"][k1] = time_launch_ms(torch, np, run1, fresh,
                                                       reps=2)
                        st = fresh()
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        persistent.generate_plain(
                            cfg, tsg.product_view(sview, prec), 0, cpn,
                            s_in[:T].contiguous(), *st, T,
                            mode="forced" if mode == "forced" else "sample",
                            prec=prec)
                        torch.cuda.synchronize()
                        res["plain_ms"][k1] = (time.perf_counter() - t) * 1e3
                        ops = k1_ops_per_row_step(cfg) * B * F2_TIME_T
                        res["bound"][k1] = (
                            bound_ms(k1_bytes(cfg, B, F2_TIME_T), ops)
                            if prec == "exact" else
                            lowp_bound(cfg, B, F2_TIME_T, prec))
        # one MANYBLOCK request per storage through the engine (fault F3:
        # at R = 512 the engine raised at construction); R = 9's case has a
        # silence bin of its own, which the engine does not take
        if label == "R=9":
            continue
        ref_w = params_lib.random_reference_weights(cfg, seed=21)
        for name in STORAGES:
            eng = WaveNetInfer(**ckw, max_batch=B, device="cuda",
                               implementation=Impl.MANYBLOCK,
                               **storage_kw(torch, name, engine=True))
            eng.set_reference_weights(ref_w)
            eng.set_inputs(cond[:T], sel[:T])
            zero()
            y = eng.run(T, B)
            torch.cuda.synchronize()
            n_l = counts()
            eprec = "exact"
            sym = persistent.STREAM_KERNELS[eprec].symbol
            if (not n_l[sym] or n_l[persistent.PERSISTENT_KERNELS[
                    eprec].symbol] or y.shape != (B, T)):
                fail(f"the {label} MANYBLOCK request ({name}) did not run on "
                     f"the first K4 alone: {n_l}")
            res["launches"][f"K4 first {eprec}"] += n_l[sym]
            log(f"[F2] {label} MANYBLOCK {name} request of {B} x {T}: the "
                f"first K4 launched {n_l[sym]} time(s), the staged K4 none")
    # K2 and K3 where the first K4's plan raises too: the generic kernel
    # against the plain version, the weights drawn on the card.  Exact only:
    # there the plain version sums in the kernel's order; in fast and bf16
    # its cuBLAS order over S = 16384 terms flips bf16 roundings of zs, which
    # LOWP_TV is too tight to allow, and the generic K2/K3 of those
    # precisions are held bit for bit against the first K4's above
    cfg = cfg_lib.WaveNetConfig(**GENERIC_ONLY_CFG)
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    params = {k: (torch.rand(shape, generator=g, device=dev) - 0.5)
              / max(1, shape[-2] if len(shape) > 1 else 1) ** 0.5
              for k, shape in params_lib.canonical_shapes(
                  cfg.num_layers, cfg.R, cfg.S, cfg.A).items()}
    cond = torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                      device=dev) - 0.5
    cp = (cond + params["dil_b"][None, :, None, :]).contiguous()
    sel = torch.rand((T, B), generator=g, device=dev)
    sym_in = torch.randint(0, cfg.A, (T, B), generator=g,
                           device=dev).to(torch.float32)
    sym = persistent.GENERIC_KERNELS["exact"].symbol

    def fresh():
        return fresh_state(torch, persistent, cfg, B, dev)
    for mode in ("forced", "prng"):
        gen = persistent.make_persistent_generator(cfg, B, mode=mode)
        if gen.route.kernel != "generic":
            fail(f"generic-only {mode}: routed to {gen.route.kernel}")
        s_in = sym_in if mode == "forced" else sel
        zero()
        out_k = gen(params, 0, cp, s_in, *fresh(), seed=PRNG_SEED)
        torch.cuda.synchronize()
        n_l = counts()
        if n_l[sym] != 1 or sum(n_l.values()) != 1:
            fail(f"generic-only {mode}: {sym} did not launch alone: {n_l}")
        key = f"{'K2' if mode == 'forced' else 'K3'} generic exact"
        res["launches"][key] = res["launches"].get(key, 0) + 1
        out_p = persistent.generate_plain(cfg, params, 0, cp, s_in, *fresh(),
                                          T, mode=mode, seed=PRNG_SEED)
        torch.cuda.synchronize()
        mism = (int((out_k[0] != out_p[0]).sum())
                + int(not torch.equal(out_k[2], out_p[2])))
        ring_err = float((out_k[1] - out_p[1]).abs().max())
        ok = rel_close(out_p[1].cpu(), out_k[1].cpu(), 1e-2, 3e-4)
        if mode == "forced":
            ok &= float((out_k[3] - out_p[3]).abs().max()) <= 1e-6
        res["mismatches"] += mism
        res["ring_err"] = max(res["ring_err"], ring_err)
        res["ok"] &= bool(ok)
        res["runs"].append(f"generic-only exact {mode}: {mism}")
        log(f"[F2] generic-only ({GENERIC_ONLY_CFG}) exact {mode}: route "
            f"generic ({sym} launched once); {mism} mismatches vs plain (y, "
            f"y_state), ring max abs err {ring_err:.3g}, ok {ok}")
    return res


def wide_launcher(torch, persistent, cfg, B: int, params, dev):
    """launch(t0, cond_pre, sel, ring, y_state, n, mode) of K1 card-wide at
    any geometry its plan holds (the route takes it only where the staged
    plan raises; a check may launch it anywhere), on the current stream."""
    plan = persistent.wide_plan(cfg, B)
    arr = persistent._plan_array(plan)
    stream = persistent.wide_stream(params, cfg, plan)
    bufs = (torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    sched = persistent.fifo_schedule(cfg, dev)

    def launch(t0, cp, sel, ring, ys, n, mode="sample"):
        return persistent._launch_wide(
            cfg, arr, params, stream, *bufs, sched, t0, cp, sel, ring, ys, n,
            mode, persistent.build.current_stream(dev))
    launch.plan = plan
    return launch


def generic_k1(torch, persistent, cfg, params, dev, prec="exact"):
    """launch(t0, cond_pre, sel, ring, y_state, n, mode, seed) of the
    generic kernel (`csrc/generic_generate.cu`: K1, K2, K3) in precision
    `prec` on `params` (the precision's product view), whatever the
    route."""
    sched = persistent.fifo_schedule(cfg, dev)

    def launch(t0, cp, sel, ring, ys, n, mode="sample", seed=0):
        return persistent._launch_kernel(
            cfg, params, sched, t0, cp, sel, ring, ys, n, mode, False, seed,
            prec, persistent.build.current_stream(dev))
    return launch


def check_wide(torch, np, persistent, cfg_lib, params_lib, tracing, dev,
               all_kernels) -> dict:
    """K1 card-wide (`csrc/wide_generate.cu`): (1) at WIDE_SMALL, uneven
    slices over its grid, against its plain model (`wide_model`) and the
    generic K1 bit for bit; (1b) at WIDE_PRIME, a grid of 131 CTAs, against
    the generic K1 bit for bit; (2) at the flagship's widths against the
    staged K1 bit for bit; (3) at the wide vocoder's published widths
    through the route (`make_persistent_generator`: the wide kernel must
    launch, the generic one not), over WIDE_T steps in two chunks, against
    the generic K1 (y, ring bits, y_state) and `generate_plain` (y and
    y_state; the ring within the ladder), in modes sample and argmax; (3b)
    WIDE_SOAK back-to-back launches there, each against the generic K1's
    sample run bit for bit (a racy barrier can pass one launch); (4) the
    step's time against the generic K1's in turns, the stamps on against off
    in turns, and the shares of the step the chains wait in the grid
    barriers and for weight slices (`gen.wide.wait_cycles`,
    `gen.wide.stream_wait_cycles` over `gen.wide.cta_cycles`).  In (1),
    (1b), (3) and (3b) the counters must read 2L + 2 grid barriers a step
    (`gen.wide.barriers`) and the launches' clusters (`gen.wide.clusters`)
    of the size `cluster_of` allows the grid: 4 at WIDE_SMALL's 12 CTAs, 1
    at WIDE_PRIME's 131, and at the published widths' 128 the most the card
    holds (2 on an H100 SXM, which holds 15 clusters of 8 and 30 of 4 at one
    CTA an SM)."""
    res = {"mismatches": 0, "ring_err": 0.0, "runs": [], "launches": 0,
           "clusters": {}}
    counts = lambda: {k.symbol: k.launches for k in all_kernels}  # noqa: E731
    wide_sym = persistent.WIDE_KERNELS["exact"].symbol
    gen_sym = persistent.GENERIC_KERNELS["exact"].symbol

    def zero():
        for k in all_kernels:
            k.launches = 0

    def mism(a, b):
        return (int((a[0] != b[0]).sum()) + bit_mismatches(torch, a[1], b[1])
                + int(not torch.equal(a[2], b[2])))

    def inputs(cfg, B, T, seed, params):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        cond = torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                          device=dev) - 0.5
        sel = torch.rand((T, B), generator=g, device=dev)
        return ((cond + params["dil_b"][None, :, None, :]).contiguous(),
                sel)

    def chunks(launch, cfg, B, cp, sel, splits, mode="sample"):
        ring, ys = fresh_state(torch, persistent, cfg, B, dev)
        ys_out = []
        for t0, t1 in splits:
            ys_out.append(launch(t0, cp[t0:t1].contiguous(),
                                 sel[t0:t1].contiguous(), ring, ys, t1 - t0,
                                 mode)[0])
        torch.cuda.synchronize()
        return torch.cat(ys_out), ring, ys

    def clusters(before, cfg, G, steps, allowed, label):
        """The counters since `before`: 2L + 2 grid barriers over `steps`
        steps, and launches of G CTAs in clusters of a size in `allowed`."""
        after = tracing.counters()
        nb, nc, nl = (after.get(k, 0) - before.get(k, 0) for k in (
            "gen.wide.barriers", "gen.wide.clusters", "gen.wide.launches"))
        n = G * nl // nc if nc else 0
        ok = (nb == steps * (2 * cfg.num_layers + 2) and n in allowed
              and nc * n == G * nl)
        res["mismatches"] += int(not ok)
        res["clusters"][label] = n
        res["runs"].append(f"{label}: {nb} barriers over {steps} steps, "
                           f"{nl} launches of {G} CTAs in {nc} clusters: "
                           f"clusters of {n} (allowed {allowed}) ok {ok}")
        log(f"[wide] {res['runs'][-1]}")

    # (1) uneven slices against the plain model and the generic K1
    cfg = cfg_lib.WaveNetConfig(**WIDE_SMALL)
    B, T = 3, 24
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=5), cfg), dev)
    cp, sel = inputs(cfg, B, T, 5, params)
    w = wide_launcher(torch, persistent, cfg, B, params, dev)
    plan = w.plan
    splits = ((0, 13), (13, T))
    before = tracing.counters()
    for mode in ("sample", "argmax"):
        out_w = chunks(w, cfg, B, cp, sel, splits, mode)
        out_g = chunks(generic_k1(torch, persistent, cfg, params, dev), cfg,
                       B, cp, sel, splits, mode)
        ring, ys = persistent.init_ring(cfg, B, "cpu"), torch.full(
            (2, B), cfg.silence_bin, dtype=torch.int32)
        ym = torch.cat([persistent.wide_model(
            cfg, plan, persistent.wide_stream(
                {k: v.cpu() for k, v in params.items()}, cfg, plan),
            {k: v.cpu() for k, v in params.items()}, t0,
            cp[t0:t1].cpu(), sel[t0:t1].cpu(), ring, ys, t1 - t0, mode)[0]
            for t0, t1 in splits])
        m = (mism(out_w, out_g) + mism(tuple(t.cpu() for t in out_w),
                                       (ym, ring, ys)))
        res["mismatches"] += m
        res["runs"].append(f"small {mode} ({plan.ctas} CTAs, rs widths "
                           f"{sorted({b - a for a, b in zip(plan.rs, plan.rs[1:])})})"
                           f" vs generic and model: {m}")
        log(f"[wide] {res['runs'][-1]}")
    clusters(before, cfg, plan.ctas, 2 * T, (4,), "small")
    # (1b) a prime grid (clusters of one CTA: the flat barrier's arrivals)
    # against the generic K1
    cfg = cfg_lib.WaveNetConfig(**WIDE_PRIME)
    B, T = WIDE_B, WIDE_PRIME_T
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=11), cfg), dev)
    cp, sel = inputs(cfg, B, T, 11, params)
    w = wide_launcher(torch, persistent, cfg, B, params, dev)
    splits = ((0, 13), (13, T))
    before = tracing.counters()
    for mode in ("sample", "argmax"):
        m = mism(chunks(w, cfg, B, cp, sel, splits, mode),
                 chunks(generic_k1(torch, persistent, cfg, params, dev), cfg,
                        B, cp, sel, splits, mode))
        res["mismatches"] += m
        res["runs"].append(f"prime grid {mode} ({w.plan.ctas} CTAs, R="
                           f"{cfg.R}) vs generic K1 (y, ring bits, y_state): "
                           f"{m}")
        log(f"[wide] {res['runs'][-1]}")
    clusters(before, cfg, w.plan.ctas, 2 * T, (1,), "prime")
    # (2) the flagship's widths against the staged K1
    cfg = cfg_lib.FLAGSHIP_CONFIG
    B, T = 16, 64
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=7), cfg), dev)
    cp, sel = inputs(cfg, B, T, 7, params)
    gen = persistent.make_persistent_generator(cfg, B)
    out_s = chunks(lambda t0, c, s_, r, y, n, mode: gen(params, t0, c, s_, r, y),
                   cfg, B, cp, sel, ((0, 40), (40, T)))
    out_w = chunks(wide_launcher(torch, persistent, cfg, B, params, dev), cfg,
                   B, cp, sel, ((0, 40), (40, T)))
    m = mism(out_w, out_s)
    res["mismatches"] += m
    res["runs"].append(f"flagship widths vs staged K1: {m}")
    log(f"[wide] {res['runs'][-1]}")
    # (3) the published widths, through the route
    cfg = cfg_lib.WaveNetConfig(**WIDE_CFG)
    B, T = WIDE_B, WIDE_T
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=31), cfg), dev)
    cp, sel = inputs(cfg, B, T, 31, params)
    splits = ((0, WIDE_SPLIT), (WIDE_SPLIT, T))
    G = persistent.wide_plan(cfg, B).ctas
    before = tracing.counters()
    for mode in ("sample", "argmax"):
        gen = persistent.make_persistent_generator(cfg, B, mode=mode)
        if gen.route.kernel != "wide":
            fail(f"the wide vocoder routed to {gen.route.kernel}")
        zero()
        out_w = chunks(lambda t0, c, s_, r, y, n, md: gen(params, t0, c, s_,
                                                          r, y),
                       cfg, B, cp, sel, splits)
        n_w = counts()
        if (n_w[wide_sym] != 2 or n_w[gen_sym]
                or sum(n_w.values()) != 2):
            fail(f"the wide route did not launch K1 card-wide alone: {n_w}")
        res["launches"] += n_w[wide_sym]
        out_g = chunks(generic_k1(torch, persistent, cfg, params, dev), cfg,
                       B, cp, sel, splits, mode)
        if mode == "sample":
            soak_ref = out_g
        ring, ys = fresh_state(torch, persistent, cfg, B, dev)
        out_p = persistent.generate_plain(cfg, params, 0, cp, sel, ring, ys,
                                          T, mode)
        torch.cuda.synchronize()
        m_g = mism(out_w, out_g)
        m_p = (int((out_w[0] != out_p[0]).sum())
               + int(not torch.equal(out_w[2], out_p[2])))
        err = float((out_w[1] - out_p[1]).abs().max())
        ok = rel_close(out_p[1].cpu(), out_w[1].cpu(), 1e-2, 3e-4)
        res["mismatches"] += m_g + m_p + int(not ok)
        res["ring_err"] = max(res["ring_err"], err)
        res["runs"].append(f"published widths {mode}, {T} steps in chunks "
                           f"{splits}: vs generic K1 {m_g} (y, ring bits, "
                           f"y_state), vs plain {m_p} (y, y_state), ring max "
                           f"abs err {err:.3g} ok {ok}")
        log(f"[wide] {res['runs'][-1]}")
    clusters(before, cfg, G, 2 * T, (8, 4, 2), "published")
    # (3b) the soak: back-to-back launches from the silence state, each
    # compared on the card with the generic K1's sample run, one sync at the
    # end
    w = wide_launcher(torch, persistent, cfg, B, params, dev)
    ring0, ys0 = fresh_state(torch, persistent, cfg, B, dev)
    ring, ys = torch.empty_like(ring0), torch.empty_like(ys0)
    y_ref, ring_ref, ys_ref = soak_ref
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    before = tracing.counters()
    for _ in range(WIDE_SOAK):
        ring.copy_(ring0)
        ys.copy_(ys0)
        y = w(0, cp, sel, ring, ys, T)[0]
        bad += ((y != y_ref).sum() + (ys != ys_ref).sum()
                + (ring.view(torch.int32) != ring_ref.view(torch.int32)).sum())
    torch.cuda.synchronize()
    m = int(bad)
    res["mismatches"] += m
    res["runs"].append(f"soak: {WIDE_SOAK} back-to-back launches of {T} "
                       f"steps vs generic K1 (y, ring bits, y_state): {m}")
    log(f"[wide] {res['runs'][-1]}")
    clusters(before, cfg, G, WIDE_SOAK * T, (8, 4, 2), "soak")
    # (4) times in turns: the wide step against the generic K1's, the
    # stamps on against off, and the chains' wait share
    plan = persistent.wide_plan(cfg, B)
    w = wide_launcher(torch, persistent, cfg, B, params, dev)
    g = generic_k1(torch, persistent, cfg, params, dev)
    fresh = lambda: fresh_state(torch, persistent, cfg, B, dev)  # noqa: E731
    wide_ms, gen_ms, on_ms, off_ms = [], [], [], []
    for turn in range(2):
        for which in ((w, "w"), (g, "g")) if turn == 0 else ((g, "g"),
                                                             (w, "w")):
            f, name = which
            n = WIDE_TIME_T if name == "w" else WIDE_GENERIC_T
            ms = time_launch_ms(torch, np, lambda r, y: f(
                0, cp[:n], sel[:n], r, y, n), fresh, reps=2)
            (wide_ms if name == "w" else gen_ms).append(ms / n)
    before = tracing.counters()
    for turn in range(4):
        for stamps in ((True, False) if turn % 2 == 0 else (False, True)):
            persistent.WIDE_STAMPS = stamps
            ms = time_launch_ms(torch, np, lambda r, y: w(
                0, cp, sel, r, y, WIDE_TIME_T), fresh, reps=2)
            (on_ms if stamps else off_ms).append(ms / WIDE_TIME_T)
    persistent.WIDE_STAMPS = True
    after = tracing.counters()
    split = {k: after[k] - before.get(k, 0) for k in persistent.WIDE_STATS}
    wait, cyc, starved = (split[k] for k in (
        "gen.wide.wait_cycles", "gen.wide.cta_cycles",
        "gen.wide.stream_wait_cycles"))
    res.update(
        plan={"ctas": plan.ctas, "threads": plan.threads,
              "chain_slots": plan.chain_slots, "smem_bytes": plan.smem_bytes,
              "stream_bytes": plan.stream_bytes},
        step_us=float(np.mean(wide_ms)) * 1e3, step_us_turns=[
            x * 1e3 for x in wide_ms],
        generic_step_us=float(np.mean(gen_ms)) * 1e3,
        generic_step_us_turns=[x * 1e3 for x in gen_ms],
        speedup=float(np.mean(gen_ms) / np.mean(wide_ms)),
        stamps_on_us=[x * 1e3 for x in on_ms],
        stamps_off_us=[x * 1e3 for x in off_ms],
        stamps_cost_pct=float(100 * (np.mean(on_ms) / np.mean(off_ms) - 1)),
        wait_pct=100.0 * wait / cyc if cyc else None,
        stream_wait_pct=100.0 * starved / cyc if cyc else None,
        split_pct={k.split(".")[-1]: round(100.0 * v / cyc, 2)
                   for k, v in split.items()} if cyc else None,
        # the chains' cycles a step (one CTA; 4 turns of 3 stamped launches
        # of WIDE_TIME_T steps) over the timed step: the clock
        cycles_per_step=cyc / plan.ctas / (12 * WIDE_TIME_T),
        mhz=cyc / plan.ctas / (12 * WIDE_TIME_T) / (float(np.mean(on_ms))
                                                  * 1e3),
        floors_us={"weight_bytes": plan.stream_bytes / 3.35e12 * 1e6})
    log(f"[wide] step {res['step_us']:.1f} us at B={B} (turns "
        f"{[round(x, 1) for x in res['step_us_turns']]}); generic K1 "
        f"{res['generic_step_us']:.1f} us a step ({res['speedup']:.1f}x); "
        f"stamps on {[round(x, 2) for x in res['stamps_on_us']]} off "
        f"{[round(x, 2) for x in res['stamps_off_us']]} us "
        f"({res['stamps_cost_pct']:+.2f}%); the chains waited "
        f"{res['wait_pct']:.1f}% of their cycles in the grid barriers and "
        f"{res['stream_wait_pct']:.1f}% for weight slices; by part "
        f"{res['split_pct']}; {res['cycles_per_step']:.0f} cycles a step "
        f"({res['mhz']:.0f} MHz)")
    return res


def first_k4(torch, persistent, tsg, cfg, B: int, params, dev,
             prec="exact"):
    """launch(t0, cond_pre, sel, ring, y_state, mode, seed) of the first K4
    (`csrc/stream_generate.cu`) on K1's storage in precision `prec`
    (`staged_storage`), whatever the route: the route takes it for K2/K3
    only where the staged plan raises, and a check may launch it anywhere
    its plan holds."""
    plan = persistent.stream_plan(cfg, B, persistent.staged_storage(prec),
                                  prec=prec)
    view = tsg.product_view(params, prec)
    stacks = persistent._stream_stacks(view, plan)
    sched = persistent.fifo_schedule(cfg, dev)

    def launch(t0, cp, sel, ring, ys, mode="sample", seed=0):
        return persistent._launch_stream(
            cfg, plan, False, view, stacks, sched, t0, cp, sel, ring, ys,
            cp.shape[0], mode, False, seed, prec,
            persistent.build.current_stream(dev))
    launch.kernel = persistent.STREAM_KERNELS[prec]
    return launch


def check_k2k3_routes(torch, np, persistent, tsg, cfg, params, cond, sel,
                      sym, dev, all_kernels) -> dict:
    """K2 and K3 without stream_weights run the staged K4 on K1's own stream
    (`generation_route`): at the flagship, over K2K3_T steps in each
    precision, the routed K2 (forced on request 1's samples) and K3 (prng)
    against the first K4's (`first_k4`, their route where the staged plan
    raises), bit for bit in y, p_seq, ring and y_state, each launching its
    kernel alone; both timed over a CHECK_T-step launch."""
    B = sel.shape[1]
    res = {"mismatches": 0, "ms": {}, "first_ms": {}, "runs": []}
    cp = (cond[:K2K3_T] + params["dil_b"][None, :, None, :]).contiguous()
    counts = lambda: {k.symbol: k.launches for k in all_kernels}  # noqa: E731
    for prec in F2_PRECISIONS:
        kw = prec_kw(torch, prec)
        old = first_k4(torch, persistent, tsg, cfg, B, params, dev, prec)

        def fresh():
            return (persistent.init_ring(cfg, B, dev, tsg.ring_dtype(prec)),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        for mode, s_in in (("forced", sym[:K2K3_T].contiguous()),
                           ("prng", sel[:K2K3_T].contiguous())):
            new = persistent.make_persistent_generator(cfg, B, mode=mode,
                                                       **kw)
            if new.route.kernel != "staged_stream":
                fail(f"{mode} {prec} is routed to {new.route.kernel}")
            outs, launched = [], []
            for run in (lambda: new(params, 0, cp, s_in, *fresh(),
                                    seed=PRNG_SEED),
                        lambda: old(0, cp, s_in, *fresh(), mode, PRNG_SEED)):
                for k in all_kernels:
                    k.launches = 0
                outs.append(run())
                torch.cuda.synchronize()
                launched.append({k: v for k, v in counts().items() if v})
            want = [{new.route.cuda_kernel(prec).symbol: 1},
                    {old.kernel.symbol: 1}]
            if launched != want:
                fail(f"{mode} {prec}: launched {launched}, not {want}")
            a, b = outs
            mism = (int((a[0] != b[0]).sum())
                    + bit_mismatches(torch, a[1].float(), b[1].float())
                    + int(not torch.equal(a[2], b[2])))
            if mode == "forced":
                mism += bit_mismatches(torch, a[3], b[3])
            key = f"{'K2' if mode == 'forced' else 'K3'} {prec}"
            res["mismatches"] += mism
            res["ms"][key] = time_launch_ms(torch, np, lambda r, ys: new(
                params, 0, cp[:CHECK_T], s_in[:CHECK_T].contiguous(), r, ys,
                seed=PRNG_SEED), fresh)
            res["first_ms"][key] = time_launch_ms(torch, np, lambda r, ys: old(
                0, cp[:CHECK_T], s_in[:CHECK_T].contiguous(), r, ys, mode,
                PRNG_SEED), fresh)
            res["runs"].append(f"{key}: {mism}")
            log(f"[K2/K3 route] {key}: the staged step vs the first K4 over "
                f"{K2K3_T} flagship steps: {mism} mismatches (y, ring "
                f"bits, y_state{', p_seq bits' if mode == 'forced' else ''}); "
                f"{res['ms'][key]:.3f} vs {res['first_ms'][key]:.3f} ms per "
                f"{CHECK_T}-step launch")
    return res


def check_first_k6(torch, np, fc, persistent, tsg, cfg_lib, params_lib, dev,
                   all_kernels) -> dict:
    """The first K6 (csrc/fused_chain_first.cu) at FIRST_K6_CFG, a geometry
    the cluster plan rejects (R not a multiple of 16): the route names it
    with the cluster plan's error; in each mode and precision against its
    plain version (forced p_seq within 1e-5, sampled symbols >= 99% equal),
    each call on counts of its own (the first K6 launched once, the
    cluster K6 not); timed over a FIRST_K6_T-step launch in each
    precision."""
    cfg = cfg_lib.WaveNetConfig(**FIRST_K6_CFG)
    B, T = FIRST_K6_B, FIRST_K6_T
    params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(cfg, seed=23), cfg), dev)
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    cond = (torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=g,
                       device=dev) - 0.5)
    sel = torch.rand((T, B), generator=g, device=dev)
    res = {"ok": True, "mismatches": 0, "p_err": 0.0, "launches": {},
           "ms": {}, "plain_ms": {}, "bound": {}}
    for prec in F2_PRECISIONS:
        kw = prec_kw(torch, prec)
        fast = prec != "exact"
        w = fc.prepare_weights(params, cfg, False, **kw)

        def fresh():
            return (persistent.init_ring(cfg, B, dev, tsg.ring_dtype(prec)),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        sym = None
        for mode in ("sample", "argmax", "prng", "forced"):
            gen = fc.make_fused_generator(cfg, B, mode, **kw)
            if gen.route.kernel != "first" or "16" not in gen.route.note:
                fail(f"the first K6's geometry is routed to {gen.route}")
            s_in = sym if mode == "forced" else sel
            for k in all_kernels:
                k.launches = 0
            out_k = gen(w, 0, cond, s_in, *fresh(), seed=PRNG_SEED)
            torch.cuda.synchronize()
            n_l = {k.symbol: k.launches for k in all_kernels if k.launches}
            want = {gen.route.cuda_kernel(mode, prec).symbol: 1}
            if n_l != want:
                fail(f"the first K6 {mode} {prec} launched {n_l}, not {want}")
            res["launches"][prec] = res["launches"].get(prec, 0) + 1
            t = time.perf_counter()
            out_p = fc.generate_fused_plain(
                cfg, w, 0, cond, s_in, *fresh(), T, mode, PRNG_SEED,
                prec == "fast", False,
                torch.bfloat16 if prec == "bf16" else torch.float32)
            torch.cuda.synchronize()
            if mode == "sample":
                sym = out_p[0].to(torch.float32)
                res["plain_ms"][prec] = (time.perf_counter() - t) * 1e3
            mism = int((out_k[0] != out_p[0]).sum())
            p_err = (float((out_k[3] - out_p[3]).abs().max())
                     if mode == "forced" else 0.0)
            ok = (mism == 0 and p_err < 1e-5 if mode == "forced"
                  else mism <= 0.01 * T * B)
            res["mismatches"] += mism
            res["p_err"] = max(res["p_err"], p_err)
            res["ok"] &= ok
            log(f"[K6 first] {mode} {prec} at R={cfg.R}: {mism}/{T * B} y "
                f"mismatches vs plain, p_seq err {p_err:.3g}; ok {ok}")
        gen = fc.make_fused_generator(cfg, B, **kw)
        res["ms"][prec] = time_launch_ms(torch, np, lambda r, ys: gen(
            w, 0, cond, sel, r, ys), fresh, reps=2)
        res["bound"][prec] = k6_bound(cfg, B, T, fast,
                                      ring_bytes=2 if prec == "bf16" else 4)
    log(f"[K6 first] timed over {T}-step launches at B={B}: "
        + ", ".join(f"{p} {v:.3f} ms" for p, v in res["ms"].items()))
    return res


def k6_inputs(torch, np, cfg, B: int, T: int, seed: int, dev):
    """Raw cond [T, L, B, 2R] in [-0.5, 0.5) and sel [T, B], from `seed`."""
    rng = np.random.RandomState(seed)
    cond = rng.uniform(-0.5, 0.5, (T, cfg.num_layers, B, 2 * cfg.R))
    sel = rng.uniform(0, 1, (T, B))
    return (torch.from_numpy(cond.astype(np.float32)).to(dev),
            torch.from_numpy(sel.astype(np.float32)).to(dev))


def same_bits(torch, a, b) -> bool:
    """Two float tensors of one dtype (fp32 or bf16) equal bit for bit."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.cpu().contiguous().view(bits),
                       b.cpu().contiguous().view(bits))


def check_k6_one_row(torch, np, fc, persistent, tsg, cases, all_kernels
                     ) -> dict:
    """The cluster K6 where its plan forms one-row groups (plan.rows = 1):
    each (label, cfg, params, B) of `cases` over K6_ODD_T steps from fresh
    state, in every mode and precision, against its plain version on the
    same prepared weights (raw cond): forced p_seq within 1e-5 and its
    symbols equal, sampled symbols >= 99% equal; each call on counts of
    its own launching the cluster K6's instance alone."""
    T = K6_ODD_T
    res = {"ok": True, "mismatches": 0, "row_steps": 0, "p_err": 0.0,
           "runs": 0}
    for label, cfg, params, B in cases:
        dev = next(iter(params.values())).device
        cond, sel = k6_inputs(torch, np, cfg, B, T, 1021 + B, dev)
        for prec in F2_PRECISIONS:
            kw = prec_kw(torch, prec)
            w = fc.prepare_weights(params, cfg, False, **kw)
            sym = None
            for mode in ("sample", "argmax", "prng", "forced"):
                gen = fc.make_fused_generator(cfg, B, mode, **kw)
                if gen.route.kernel != "cluster" or gen.route.plan.rows != 1:
                    fail(f"K6 {label} B={B} is not on one-row cluster "
                         f"groups: {gen.route}")
                s_in = sym if mode == "forced" else sel

                def fresh():
                    return (persistent.init_ring(cfg, B, dev,
                                                 tsg.ring_dtype(prec)),
                            torch.full((2, B), cfg.silence_bin,
                                       dtype=torch.int32, device=dev))
                for k in all_kernels:
                    k.launches = 0
                out_k = gen(w, 0, cond, s_in, *fresh(), seed=PRNG_SEED)
                torch.cuda.synchronize()
                n_l = {k.symbol: k.launches for k in all_kernels
                       if k.launches}
                want = {gen.route.cuda_kernel(mode, prec).symbol: 1}
                if n_l != want:
                    fail(f"K6 {label} B={B} {mode} {prec} launched {n_l}, "
                         f"not {want}")
                out_p = fc.generate_fused_plain(
                    cfg, w, 0, cond, s_in, *fresh(), T, mode, PRNG_SEED,
                    prec == "fast", False,
                    torch.bfloat16 if prec == "bf16" else torch.float32)
                torch.cuda.synchronize()
                if mode == "sample":
                    sym = out_p[0].to(torch.float32)
                mism = int((out_k[0] != out_p[0]).sum())
                p_err = (float((out_k[3] - out_p[3]).abs().max())
                         if mode == "forced" else 0.0)
                ok = (mism == 0 and p_err < 1e-5 if mode == "forced"
                      else mism <= 0.01 * T * B)
                res["mismatches"] += mism
                res["row_steps"] += T * B
                res["p_err"] = max(res["p_err"], p_err)
                res["runs"] += 1
                res["ok"] &= ok
                log(f"[K6 one-row] {label} B={B} {mode} {prec}: {mism}/"
                    f"{T * B} y mismatches vs plain, p_seq err {p_err:.3g};"
                    f" ok {ok}")
    return res


def check_k6_model(torch, np, fc, persistent, tsg, cfg, params, batches,
                   all_kernels) -> dict:
    """The cluster K6 against `fused_chain.cluster_model`, the plain model
    of its sums that the CPU tests hold to the plain K6, the JAX kernel and
    the TV contract: at each B of `batches` (two-row and one-row groups),
    over K6_MODEL_T steps from fresh state, in every mode and precision,
    the kernel on the card and the model on the CPU from the same prepared
    weights, inputs and state; y, the ring's bits, y_state and p_seq's bits
    must be equal."""
    T = K6_MODEL_T
    dev = next(iter(params.values())).device
    cpu = torch.device("cpu")
    res = {"ok": True, "runs": 0, "unequal": [], "model_s": 0.0}
    for B in batches:
        cond, sel = k6_inputs(torch, np, cfg, B, T, 1031 + B, dev)
        for prec in F2_PRECISIONS:
            kw = prec_kw(torch, prec)
            w = fc.prepare_weights(params, cfg, False, **kw)
            w_cpu = tuple(x.cpu() for x in w)
            plan = fc.cluster_plan(cfg, B, prec)
            stream = fc.cluster_stream(w_cpu, cfg, plan)
            sym = None
            for mode in ("sample", "argmax", "prng", "forced"):
                gen = fc.make_fused_generator(cfg, B, mode, **kw)
                if gen.route.kernel != "cluster" or gen.route.plan != plan:
                    fail(f"K6 at B={B} {prec} is routed to {gen.route}")
                s_in = sym if mode == "forced" else sel

                def fresh(d):
                    return (persistent.init_ring(cfg, B, d,
                                                 tsg.ring_dtype(prec)),
                            torch.full((2, B), cfg.silence_bin,
                                       dtype=torch.int32, device=d))
                for k in all_kernels:
                    k.launches = 0
                out_k = gen(w, 0, cond, s_in, *fresh(dev), seed=PRNG_SEED)
                torch.cuda.synchronize()
                if not gen.route.cuda_kernel(mode, prec).launches:
                    fail(f"K6 at B={B} {mode} {prec} did not launch")
                t = time.perf_counter()
                out_m = fc.cluster_model(cfg, plan, stream, w_cpu, 0,
                                         cond.cpu(), s_in.cpu(),
                                         *fresh(cpu), T, mode, PRNG_SEED,
                                         prec)
                res["model_s"] += time.perf_counter() - t
                if mode == "sample":
                    sym = out_k[0].to(torch.float32)
                equal = {"y": torch.equal(out_k[0].cpu(), out_m[0]),
                         "ring": same_bits(torch, out_k[1], out_m[1]),
                         "y_state": torch.equal(out_k[2].cpu(), out_m[2])}
                if mode == "forced":
                    equal["p_seq"] = same_bits(torch, out_k[3], out_m[3])
                bad = [k for k, v in equal.items() if not v]
                if bad:
                    res["unequal"].append(f"B={B} {mode} {prec}: {bad}")
                res["ok"] &= not bad
                res["runs"] += 1
                log(f"[K6 model] B={B} (rows {plan.rows}) {mode} {prec}: "
                    f"kernel vs cluster_model over {T} steps, unequal: "
                    f"{bad or 'none'}")
    return res


def k6_macs(cfg) -> int:
    """Multiply-adds of one K6 row-step, the useful ones (the pad rows of
    g_pack and wskip_cat are skipped): Wprev, x0 wcur_cat, the G stack,
    wskip_cat, the residual products and the output stack."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    return (2 * L * R * 2 * R + R * 2 * R * L * (L - 1) // 2 + L * R * S
            + (L - 1) * R * R + S * A + A * A)


def k6_elementwise(cfg, fast: bool) -> int:
    """fp32 operations of one K6 row-step outside the products: embedding
    and tanh, u's three adds, the chain's adds, the gates, the residual
    stream, the biases and relus, the sampler as K1's; under fast_math one
    rounding per activation entering a product."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    gate = TANH_LARGE_OPS + SIGMOID_OPS + 1
    ops = (R * (1 + TANH_LARGE_OPS) + 3 * L * 2 * R + (L - 1) * 2 * R
           + L * R * gate + 2 * (L - 1) * R + 2 * S + 2 * A + A
           + A * (2 + EXP_OPS + A.bit_length() - 1 + 2))
    return ops + ((2 * L * R + R + S + A) if fast else 0)


def k6_bound(cfg, B: int, T: int, fast: bool, forced: bool = False,
             ring_bytes: int = 4):
    """(bound_ms, bound_by) of a K6 launch: the folded weights (the rows the
    fold needs, P = R), cond, sel, the ring (ring_bytes an element: 2 under
    bf16) and y_state in and out, y (and p_seq) against the products at the
    fp32 rate (fast_math and bf16: at the bf16 tensor-core rate, their
    operands being bf16 values) plus the elementwise work at the fp32
    rate."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    weights = (2 * A * R + 2 * L * R * 2 * R + L * R * R + L * R
               + R * L * (L - 1) // 2 * 2 * R + L * R * S + L * 2 * R + S
               + S * A + A + A * A + A)
    n_bytes = (4 * (weights + T * B * L * 2 * R + T * B + 2 * 2 * B + T * B
                    + (T * B * A if forced else 0))
               + ring_bytes * 2 * cfg.ring_size * B * R)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (2 * k6_macs(cfg) / (PEAK_BF16_FLOPS if fast else PEAK_FP32_FLOPS)
             + k6_elementwise(cfg, fast) / PEAK_FP32_FLOPS) * B * T * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lowp_bound(cfg, B: int, T: int, prec: str, live: int | None = None,
               mode: str = "sample", storage: str | None = None):
    """(bound_ms, bound_by) of a fast or bf16 instance of K1's step (K1,
    K2, K3, K5; K4 with `storage`) over B x T row-steps, `live` of them
    run: K1's bytes with the matrices that enter products as bf16 (2 bytes
    a weight; int8 stacks 1 byte and their scales) and under "bf16" the
    ring in and out as bf16; the products at the bf16 tensor-core rate,
    K1's elementwise work plus one rounding per activation entering a
    product (R + 3LR + S + A a row-step) and int8's dequantisation at the
    fp32 rate."""
    L, R, S, A = cfg.num_layers, cfg.R, cfg.S, cfg.A
    live = T * B if live is None else live
    stack = L * (2 * R * 2 * R + R * (R + S))
    macs = stack + S * A + A * A
    n_bytes = k1_bytes(cfg, B, T, live) - 2 * (2 * A * R + macs)
    if storage == "int8":
        n_bytes += -stack + 4 * L * (2 * R + R + S)
    if prec == "bf16":
        n_bytes -= 2 * 2 * cfg.ring_size * B * R
    if live != T * B:
        n_bytes += 12 * B
    elem = k1_ops_per_row_step(cfg) - 2 * macs + R + 3 * L * R + S + A
    if mode == "forced":
        n_bytes += 4 * T * B * A
        elem -= A
    elif mode == "prng":
        n_bytes -= 4 * T * B
        elem += PHILOX_OPS
    t_ops = (2 * macs * live / PEAK_BF16_FLOPS + elem * live / PEAK_FP32_FLOPS
             + (2 * stack if storage == "int8" else 0) / PEAK_FP32_FLOPS) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def forced_p64(np, p):
    """p_seq as float64, each row renormalised (the TV tests' form)."""
    p = p.cpu().numpy().astype(np.float64)
    return p / p.sum(-1, keepdims=True)


def tv(np, p, q):
    return 0.5 * np.abs(p - q).sum(-1)


def check_k6_small(torch, np, fc, persistent, cfg, params, cond, sel,
                   dev) -> dict:
    """K6 against its plain version on the card, on the same prepared
    weights (the engine's dil_b prefold), in every K6_VARIANTS entry:
    forced p_seq within 1e-5; sample/argmax/prng y agreement >= 99%; the
    ring within the xt ladder and y_state equal on the rows whose samples
    agree; then a K6_SPLIT + rest split against one call (fp32 and
    fast_math) and pack_gates on against off, exact."""
    T, B = sel.shape
    cp = (cond + params["dil_b"][None, :, None, :]).contiguous()
    res = {"y_mismatches": 0, "row_steps": 0, "p_err": 0.0, "ring_err": 0.0,
           "ok": True, "split_mismatches": 0, "pack_mismatches": 0}

    def fresh():
        return fresh_state(torch, persistent, cfg, B, dev)
    sym, ys = None, {}
    for mode, fast, pack in K6_VARIANTS:
        w = fc.prepare_weights(params, cfg, True, torch.float32, pack, fast)
        s_in = sym if mode == "forced" else sel
        gen = fc.make_fused_generator(cfg, B, mode, fast_math=fast,
                                      prefold_cond=True, pack_gates=pack)
        out_k = gen(w, 0, cp, s_in, *fresh(), seed=PRNG_SEED)
        out_p = fc.generate_fused_plain(cfg, w, 0, cp, s_in, *fresh(), T,
                                        mode, PRNG_SEED, fast, pack)
        torch.cuda.synchronize()
        same = out_k[0] == out_p[0]
        mism = int((~same).sum())
        rows = same.all(0)                        # rows whose samples agree
        tail = same[-2:].all(0)                   # rows whose y_state must
        ring_err = float((out_k[1] - out_p[1])[:, rows].abs().max()) \
            if bool(rows.any()) else 0.0
        ok = (rel_close(out_p[1][:, rows].cpu(), out_k[1][:, rows].cpu(),
                        1e-2, 3e-4)
              and torch.equal(out_k[2][:, tail], out_p[2][:, tail])
              and mism <= 0.01 * T * B)
        p_err = 0.0
        if mode == "forced":
            p_err = float((out_k[3] - out_p[3]).abs().max())
            ok &= mism == 0 and p_err < 1e-5
        if mode == "sample" and not fast:
            ys[pack] = out_k[0]
            sym = out_p[0].to(torch.float32) if sym is None else sym
        log(f"[K6 small] {mode} fast_math={fast} pack={pack}: y {mism}/"
            f"{T * B} mismatches vs plain; ring max abs err {ring_err:.3g} "
            f"over {int(rows.sum())} agreeing rows; p_seq err {p_err:.3g}; "
            f"ok {ok}")
        res["y_mismatches"] += mism
        res["row_steps"] += T * B
        res["p_err"] = max(res["p_err"], p_err)
        res["ring_err"] = max(res["ring_err"], ring_err)
        res["ok"] &= ok
    res["pack_mismatches"] = int((ys[True] != ys[False]).sum())
    for fast in (False, True):
        w = fc.prepare_weights(params, cfg, True, torch.float32, False, fast)
        gen = fc.make_fused_generator(cfg, B, fast_math=fast,
                                      prefold_cond=True)
        one, two = fresh(), fresh()
        y1 = gen(w, 0, cp, sel, *one)[0]
        y2 = torch.cat([gen(w, 0, cp[:K6_SPLIT].contiguous(),
                            sel[:K6_SPLIT].contiguous(), *two)[0],
                        gen(w, K6_SPLIT, cp[K6_SPLIT:].contiguous(),
                            sel[K6_SPLIT:].contiguous(), *two)[0]])
        torch.cuda.synchronize()
        res["split_mismatches"] += (int((y1 != y2).sum())
                                    + bit_mismatches(torch, one[0], two[0])
                                    + int(not torch.equal(one[1], two[1])))
    log(f"[K6 small] {K6_SPLIT} + {T - K6_SPLIT} split vs one call (fp32, "
        f"fast_math): {res['split_mismatches']} mismatches (y, ring bits, "
        f"y_state); pack_gates on vs off: {res['pack_mismatches']} y "
        f"mismatches")
    return res


def check_k6_tv(torch, np, fc, persistent, cfg_lib, params_lib, dev) -> dict:
    """The TV contract on the card: the hot case of
    tests/test_low_precision.py rebuilt with the port's weights; K1's free
    run gives the symbols, K2 forced on them the exact distributions; K6
    forced on the same symbols in fp32 (max TV and max |dp| < 5e-4),
    fast_math (mean TV < 0.025, p99 < 0.10, max < 0.20, and TV > 0 against
    fp32 K6) and bf16 weights (mean < 0.02, max < 0.15); K2-fast, K2-bf16
    and K6-bf16 forced on them too (mean < 0.025, p99 < 0.10, max < 0.20,
    TV > 0 against K2)."""
    cfg = cfg_lib.WaveNetConfig(**TV_CFG)
    B, T = TV_B, TV_T
    rng = np.random.RandomState(TV_SEED + 2000)
    ref_w = params_lib.random_reference_weights(cfg, seed=TV_SEED,
                                                scale=1.0 / np.sqrt(cfg.R))
    for k in ("Wzs", "Wza"):
        ref_w[k] = (ref_w[k] * 6.0).astype(np.float32)
    cond = torch.from_numpy(rng.uniform(
        -1, 1, (T, cfg.num_layers, B, 2 * cfg.R)).astype(np.float32)).to(dev)
    sel = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32)).to(dev)
    params = params_lib.canonical_to_torch(params_lib.to_canonical(ref_w, cfg),
                                           dev)
    cp = (cond + params["dil_b"][None, :, None, :]).contiguous()

    def fresh():
        return fresh_state(torch, persistent, cfg, B, dev)
    y1 = persistent.make_persistent_generator(cfg, B)(params, 0, cp, sel,
                                                      *fresh())[0]
    sym = y1.to(torch.float32)
    p2 = forced_p64(np, persistent.make_persistent_generator(
        cfg, B, mode="forced")(params, 0, cp, sym, *fresh())[3])
    ps = {}
    for name, kw in (("fp32", {}), ("fast_math", {"fast_math": True}),
                     ("bf16", {"weight_dtype": torch.bfloat16})):
        w = fc.prepare_weights(params, cfg, True, pack_gates=False, **kw)
        ps[name] = forced_p64(np, fc.make_fused_generator(
            cfg, B, "forced", prefold_cond=True, **kw)(w, 0, cp, sym,
                                                       *fresh())[3])
    bf_state = (persistent.init_ring(cfg, B, dev, torch.bfloat16),
                fresh()[1])
    for prec in ("fast", "bf16"):
        kw = prec_kw(torch, prec)
        st = bf_state if prec == "bf16" else fresh()
        ps[f"K2 {prec}"] = forced_p64(np, persistent.make_persistent_generator(
            cfg, B, mode="forced", **kw)(params, 0, cp, sym, *st)[3])
    kw = prec_kw(torch, "bf16")
    w = fc.prepare_weights(params, cfg, True, pack_gates=False, **kw)
    ps["K6 bf16"] = forced_p64(np, fc.make_fused_generator(
        cfg, B, "forced", prefold_cond=True, **kw)(
            w, 0, cp, sym, persistent.init_ring(cfg, B, dev, torch.bfloat16),
            fresh()[1])[3])
    res = {}
    for name, p in ps.items():
        t = tv(np, p2, p)
        res[name] = {"mean": float(t.mean()),
                     "p99": float(np.percentile(t, 99)),
                     "max": float(t.max()),
                     "max_abs_dp": float(np.abs(p - p2).max())}
    res["fast_vs_fp32_max"] = float(tv(np, ps["fp32"], ps["fast_math"]).max())
    f, m, bf = res["fp32"], res["fast_math"], res["bf16"]
    res["ok"] = (f["max"] < 5e-4 and f["max_abs_dp"] < 5e-4
                 and m["mean"] < 0.025 and m["p99"] < 0.10 and m["max"] < 0.20
                 and res["fast_vs_fp32_max"] > 0
                 and bf["mean"] < 0.02 and bf["max"] < 0.15)
    for name in ("K2 fast", "K2 bf16", "K6 bf16"):
        v = res[name]
        res["ok"] &= (v["mean"] < 0.025 and v["p99"] < 0.10
                      and v["max"] < 0.20 and v["max"] > 0)
    log(f"[K6 TV] hot case 6L R32 S128 A256, B={B}, T={T}, against K2 on "
        f"K1's samples: " + "; ".join(
            f"{n} mean {v['mean']:.3g} p99 {v['p99']:.3g} max {v['max']:.3g}"
            for n, v in res.items() if isinstance(v, dict))
        + f"; fast_math vs fp32 K6 max TV {res['fast_vs_fp32_max']:.3g} "
        f"(> 0); within the contract {res['ok']}")
    return res


def forced_tv(np, p_a, p_b) -> tuple:
    """(mean, max) over the steps and rows of the TV between two p_seq."""
    t = tv(np, forced_p64(np, p_a), forced_p64(np, p_b))
    return float(t.mean()), float(t.max())


def lowp_control(np, prec: str, where: str, p_exact, p_plain) -> dict:
    """The exact instance's p_seq against the plain version of `prec` on the
    same symbols: a kernel that skips its roundings would read this, so
    LOWP_TV must lie under its mean TV (else the check cannot tell such a
    kernel)."""
    tv_mean, tv_max = forced_tv(np, p_exact, p_plain)
    ok = tv_mean > LOWP_TV
    log(f"[lowp control] {where} {prec}: exact instance vs {prec} plain, "
        f"forced TV mean {tv_mean:.3g} (limit {LOWP_TV:.3g}; above it {ok}),"
        f" max {tv_max:.3g}")
    return {"tv_mean": tv_mean, "tv_max": tv_max, "ok": ok}


def prec_kw(torch, prec: str) -> dict:
    """The keywords of a precision for the generators and WaveNetInfer."""
    return {"compute_dtype": torch.bfloat16 if prec == "bf16"
            else torch.float32, "fast_math": prec == "fast"}


def lowp_compare(torch, np, out_k, out_p, mode: str, dump: bool) -> dict:
    """A low-precision instance against its plain version on the same
    inputs.  Both sum the same exact bf16 x bf16 products in fp32, in other
    orders (cuBLAS in the plain version), so a rounding of x to bf16 may
    flip now and then and the sampled symbols part: they agree on
    >= LOWP_AGREE of the run's row-steps; the ring within the xt ladder and
    y_state equal on the rows whose symbols agree; forced p_seq within
    LOWP_TV (the mean TV per step); the dumps within LOWP_DUMP_TOL (a bf16
    ulp is 3.9e-3)."""
    T, B = out_k[0].shape
    same = out_k[0] == out_p[0]
    mism = int((~same).sum())
    rows, tail = same.all(0), same[-2:].all(0)
    ring_k, ring_p = (o[1].to(torch.float32) for o in (out_k, out_p))
    ring_err = (float((ring_k - ring_p)[:, rows].abs().max())
                if bool(rows.any()) else 0.0)
    ok = (mism <= (1 - LOWP_AGREE) * T * B
          and rel_close(ring_p[:, rows].cpu(), ring_k[:, rows].cpu(), 1e-2,
                        3e-4)
          and torch.equal(out_k[2][:, tail], out_p[2][:, tail]))
    tv_mean = tv_max = 0.0
    if mode == "forced":
        tv_mean, tv_max = forced_tv(np, out_k[-1], out_p[-1])
        ok &= mism == 0 and tv_mean < LOWP_TV
    if dump:
        ok &= all(rel_close(p[b].cpu() if p.dim() == 2 else p[:, b].cpu(),
                            k[b].cpu() if k.dim() == 2 else k[:, b].cpu(),
                            LOWP_DUMP_TOL, 3e-4)
                  for k, p in zip(out_k[3:8], out_p[3:8])
                  for b in range(B) if bool(rows[b]))
    return {"mismatches": mism, "row_steps": T * B, "ring_err": ring_err,
            "tv_mean": tv_mean, "tv_max": tv_max, "ok": bool(ok)}


def check_lowp_small(torch, np, persistent, fc, tsg, cfg, params, cond, sel,
                     dev) -> dict:
    """Every fast and bf16 instance against its plain version at a small
    config, B=4: K1 (sample; argmax with the dump), K2 (forced on the plain
    version's samples), K3 (prng), K5 (a seeded ragged call), K4 in every
    storage and mode, and K6 in bf16 in every mode (`lowp_compare`); the
    controls of K2 and K6 (`lowp_control`) read above LOWP_TV."""
    T, B = sel.shape
    res = {"mismatches": 0, "row_steps": 0, "ring_err": 0.0, "tv_mean": 0.0,
           "tv_max": 0.0, "ok": True, "runs": 0, "per": {}, "controls": {}}

    def exact_state():
        return (persistent.init_ring(cfg, B, dev),
                torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                           device=dev))

    def control(name, prec, p_exact, p_plain):
        c = lowp_control(np, prec, f"small {name}", p_exact, p_plain)
        res["controls"][f"{name} {prec}"] = c
        res["ok"] &= c["ok"]
    lens = torch.from_numpy(np.random.RandomState(1023).randint(
        0, T + 1, size=B).astype(np.int32))
    t0_row = torch.from_numpy(np.array([0, 5, 11, 2][:B], np.int64))

    def record(kernel, prec, detail, out_k, out_p, mode, dump=False):
        """Compare, log, and sum into res and res["per"][kernel prec]."""
        r = lowp_compare(torch, np, out_k, out_p, mode, dump)
        log(f"[lowp small] {kernel} {prec} {detail}: y {r['mismatches']}/"
            f"{r['row_steps']} mismatches vs plain; ring max abs err "
            f"{r['ring_err']:.3g}; forced TV mean {r['tv_mean']:.3g} max "
            f"{r['tv_max']:.3g}; ok {r['ok']}")
        per = res["per"].setdefault(f"{kernel} {prec}", {
            "mismatches": 0, "row_steps": 0, "ring_err": 0.0,
            "tv_mean": 0.0, "tv_max": 0.0, "ok": True})
        for acc in (res, per):
            for k in ("mismatches", "row_steps"):
                acc[k] += r[k]
            for k in ("ring_err", "tv_mean", "tv_max"):
                acc[k] = max(acc[k], r[k])
            acc["ok"] &= r["ok"]
        res["runs"] += 1

    for prec in ("fast", "bf16"):
        kw = prec_kw(torch, prec)
        rdt = tsg.ring_dtype(prec)

        def fresh():
            return (persistent.init_ring(cfg, B, dev, rdt),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        for name in ("K1",) + STORAGES:
            skw = {} if name == "K1" else {"stream_weights": True,
                                           **storage_kw(torch, name)}
            view = storage_view(persistent, params, skw)
            cp = (cond + view["dil_b"][None, :, None, :]).contiguous()
            sym = None
            for mode, dump in (("sample", False), ("argmax", True),
                               ("forced", False), ("prng", False)):
                s_in = sym if mode == "forced" else sel
                gen = persistent.make_persistent_generator(
                    cfg, B, mode=mode, dump=dump, **skw, **kw)
                out_k = gen(params, 0, cp, s_in, *fresh(), seed=PRNG_SEED)
                out_p = persistent.generate_plain(
                    cfg, view, 0, cp, s_in, *fresh(), T, mode=mode,
                    dump=dump, seed=PRNG_SEED, prec=prec)
                torch.cuda.synchronize()
                if mode == "sample":
                    sym = out_p[0].to(torch.float32)
                kernel = ("K4" if skw else
                          {"forced": "K2", "prng": "K3"}.get(mode, "K1"))
                record(kernel, prec, f"{'' if kernel != 'K4' else name + ' '}"
                       f"{mode}{' + dump' if dump else ''}", out_k, out_p,
                       mode, dump)
                if kernel == "K2":
                    out_x = persistent.make_persistent_generator(
                        cfg, B, mode="forced")(params, 0, cp, sym,
                                               *exact_state())
                    control("K2", prec, out_x[-1], out_p[-1])
            if name == "K1":
                gen = persistent.make_persistent_generator(cfg, B,
                                                           ragged=True, **kw)
                out_k = gen(params, t0_row, cp, sel, *fresh(), lens)
                out_p = persistent.generate_plain(cfg, view, t0_row, cp, sel,
                                                  *fresh(), lens, prec=prec)
                torch.cuda.synchronize()
                record("K5", prec, f"lengths {lens.tolist()} clocks "
                       f"{t0_row.tolist()}", out_k, out_p, "sample")
    cp = (cond + params["dil_b"][None, :, None, :]).contiguous()
    sym = None
    kw = prec_kw(torch, "bf16")
    w = fc.prepare_weights(params, cfg, True, torch.float32, False, **kw)
    for mode in ("sample", "argmax", "forced", "prng"):
        s_in = sym if mode == "forced" else sel
        rings = [persistent.init_ring(cfg, B, dev, torch.bfloat16)
                 for _ in range(2)]
        states = [torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                             device=dev) for _ in range(2)]
        out_k = fc.make_fused_generator(cfg, B, mode, prefold_cond=True,
                                        **kw)(w, 0, cp, s_in, rings[0],
                                              states[0], seed=PRNG_SEED)
        out_p = fc.generate_fused_plain(cfg, w, 0, cp, s_in, rings[1],
                                        states[1], T, mode, PRNG_SEED,
                                        compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        if mode == "sample":
            sym = out_p[0].to(torch.float32)
        record("K6", "bf16", mode, out_k, out_p, mode)
        if mode == "forced":
            w_x = fc.prepare_weights(params, cfg, True)
            out_x = fc.make_fused_generator(cfg, B, mode, prefold_cond=True)(
                w_x, 0, cp, sym, *exact_state())
            control("K6", "bf16", out_x[-1], out_p[-1])
    return res


def check_lowp_k4_k1(torch, np, persistent, tsg, cfg, params, cond, sel,
                     dev) -> dict:
    """K4 against K1 of the same precision over K4_FLAG_T flagship steps,
    bit for bit in y, the ring and y_state, in each precision and storage,
    on the same stored values; then K4-forced against K2 and K4-prng
    against K3 over CHECK_T steps in each precision (fp32 storage)."""
    T, B = K4_FLAG_T, MAIN_B
    res = {"mismatches": 0, "runs": 0}

    def compare(a, b):
        return (int((a[0] != b[0]).sum()) + bit_mismatches(
            torch, a[1].to(torch.float32), b[1].to(torch.float32))
                + int(not torch.equal(a[2], b[2]))
                + (bit_mismatches(torch, a[-1], b[-1]) if len(a) > 3 else 0))
    for prec in ("fast", "bf16"):
        kw = prec_kw(torch, prec)

        def fresh():
            return (persistent.init_ring(cfg, B, dev, tsg.ring_dtype(prec)),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        for name in STORAGES:
            skw = storage_kw(torch, name)
            view = storage_view(persistent, params, skw)
            cp = (cond[:T] + view["dil_b"][None, :, None, :]).contiguous()
            k1 = persistent.make_persistent_generator(cfg, B, **kw)
            k4 = persistent.make_persistent_generator(
                cfg, B, stream_weights=True, **skw, **kw)
            mism = compare(k4(params, 0, cp, sel[:T], *fresh()),
                           k1(view, 0, cp, sel[:T], *fresh()))
            torch.cuda.synchronize()
            log(f"[lowp K4 vs K1] {prec} {name}: {T} flagship steps, {mism} "
                f"mismatches (y, ring bits, y_state)")
            res["mismatches"] += mism
            res["runs"] += 1
        cp = (cond[:CHECK_T] + params["dil_b"][None, :, None, :]).contiguous()
        y1 = persistent.make_persistent_generator(cfg, B, **kw)(
            params, 0, cp, sel[:CHECK_T], *fresh())[0]
        for mode, s_in in (("forced", y1.to(torch.float32)),
                           ("prng", sel[:CHECK_T])):
            ref = persistent.make_persistent_generator(cfg, B, mode=mode, **kw)
            k4 = persistent.make_persistent_generator(
                cfg, B, mode=mode, stream_weights=True, **kw)
            mism = compare(k4(params, 0, cp, s_in, *fresh(), seed=PRNG_SEED),
                           ref(params, 0, cp, s_in, *fresh(), seed=PRNG_SEED))
            torch.cuda.synchronize()
            log(f"[lowp K4 vs K1] {prec} {mode}: K4 vs "
                f"{'K2' if mode == 'forced' else 'K3'} over {CHECK_T} steps: "
                f"{mism} mismatches (y, ring bits, y_state, p_seq bits)")
            res["mismatches"] += mism
            res["runs"] += 1
    return res


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call of fn over reps back-to-back calls,
    after one warm-up call, by CUDA events."""
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


def check_p1(torch, pem, dev) -> dict:
    """P1 from both builds on the JAX probe's inputs: bit mismatches
    against numpy's separate a*b+c and the fp64 FMA (`fma_report`, its
    launches counted), each build's plain form against the plain version
    on the card, an offset view (the scalar path) against it, and the times
    of the plain forms, the plain version and torch.addcmul; then the plain
    form at pem.N_LARGE elements (held against the plain version, timed
    beside torch.addcmul) and the wrapper's host path per call."""
    a, b, c = pem.probe_inputs()[:3]
    for k in pem.FMA_PROBE_KERNELS.values():
        k.launches = 0
    rep = pem.fma_report(a, b, c, dev)
    launches = {f: k.launches for f, k in pem.FMA_PROBE_KERNELS.items()}
    ta, tb, tc = (torch.from_numpy(v).to(dev) for v in (a, b, c))
    plain = pem.fma_plain(ta, tb, tc)
    out = {"n": int(a.size), "launches": launches,
           "vs_separate_and_fma64": {f"{f} {form}": v
                                     for (f, form), v in rep.items()},
           "plain_ms": time_ms(torch, lambda: pem.fma_plain(ta, tb, tc), 50),
           "library_ms": time_ms(torch, lambda: torch.addcmul(tc, ta, tb),
                                 50)}
    for flags in pem.FMA_PROBE_KERNELS:
        o = pem.fma_probe(ta, tb, tc, "plain", flags)
        out[flags] = {
            "separate": rep[(flags, "plain")][0],
            "fma64": rep[(flags, "plain")][1],
            "guarded_separate": rep[(flags, "guarded")][0],
            "vs_plain_bits": bit_mismatches(torch, o, plain),
            "max_abs_err": float((o - plain).abs().max()),
            "ms": time_ms(torch, lambda f=flags: pem.fma_probe(
                ta, tb, tc, "plain", f), 50)}
    # an offset view: no 16-byte alignment, the scalar loop alone
    out["offset_view_bits"] = bit_mismatches(
        torch, pem.fma_probe(ta[1:], tb[1:], tc[1:]),
        pem.fma_plain(ta[1:], tb[1:], tc[1:]))
    # device time: P1_GRAPH_LAUNCHES back-to-back launches captured in a
    # CUDA graph and replayed, by events, so the host's launch path (ctypes
    # and the wrapper's checks) is out of the time
    out["device_ms"] = graph_ms(torch, lambda: pem.fma_probe(
        ta, tb, tc, "plain", "fmad=false"), P1_GRAPH_LAUNCHES)
    out["library_device_ms"] = graph_ms(
        torch, lambda: torch.addcmul(tc, ta, tb), P1_GRAPH_LAUNCHES)
    # three fp32 reads and a write; a multiply and an add per element
    out["bound_ms"], out["bound_by"] = bound_ms(16 * a.size, 2 * a.size)
    out["host_path_us"] = pem.host_path_us(ta, tb, tc, P1_HOST_CALLS)
    # where bytes decide: N_LARGE elements made on the card from a seed
    n = pem.N_LARGE
    gen = torch.Generator(device=dev).manual_seed(0)
    la, lb, lc = (torch.rand(n, generator=gen, device=dev) * 4 - 2
                  for _ in range(3))
    kern = pem.FMA_PROBE_KERNELS["fmad=false"]
    kern.launches = 0
    lo = pem.fma_probe(la, lb, lc)
    large = {"n": n, "launches": kern.launches}
    lplain = pem.fma_plain(la, lb, lc)
    large.update({
        "vs_plain_bits": bit_mismatches(torch, lo, lplain),
        "max_abs_err": float((lo - lplain).abs().max()),
        "plain_ms": time_ms(torch, lambda: pem.fma_plain(la, lb, lc), 10),
        "device_ms": graph_ms(torch, lambda: pem.fma_probe(la, lb, lc),
                              P1_GRAPH_LAUNCHES),
        "library_device_ms": graph_ms(
            torch, lambda: torch.addcmul(lc, la, lb), P1_GRAPH_LAUNCHES)})
    large["bound_ms"], large["bound_by"] = bound_ms(16 * n, 2 * n)
    large["of_bound"] = large["bound_ms"] / large["device_ms"]
    out["large"] = large
    return out


def graph_ms(torch, fn, n: int) -> float:
    """Device time of one call of fn: n calls captured in one CUDA graph
    (after a warm-up call), the graph replayed once untimed and once timed
    by CUDA events, over n."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def check_p5_held(torch, ps, dev) -> dict:
    """P5 against chain_plain on a P5_HELD_T-step chain of P5_HELD_D stages
    at R=64, B in P5_HELD_B: each precision x W layout (P5_HELD_LAYOUTS) x
    gate; the same chain at each shape of `ps.instance_shapes()`, so every
    compiled instance of the stream and the cluster is held; then over
    P5_TIMED_HELD_T steps at the timed shapes.  Exact bit for bit, fast within P5_FAST_TOL of max |plain|
    (`fast_max_rel_err`).  Every call runs on P5's counters set to 0 just
    before it and must launch its layout's own kernel once, and no other
    (`launch_faults`).  Also each precision's plain run timed at B=16 with
    the gate."""
    T, D = P5_HELD_T, P5_HELD_D
    res = {"cases": 0, "exact_bit_mismatches": 0, "exact_max_abs_err": 0.0,
           "fast_max_abs_err": 0.0, "fast_max_rel_err": 0.0, "plain_ms": {},
           "launch_faults": [], "by_layout": {}}
    counters = {(weights, prec): k for weights, ks in ps.LAYOUT_KERNELS.items()
                for prec, k in ks.items()}

    def held(prec, weights, make, ref, where):
        for k in counters.values():
            k.launches = 0
        out = make()
        launched = {k.symbol: k.launches for k in set(counters.values())
                    if k.launches}
        if launched != {counters[(weights, prec)].symbol: 1}:
            res["launch_faults"].append({where: launched})
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        bits = bit_mismatches(torch, out, ref)
        res["cases"] += 1
        res[f"{prec}_max_abs_err"] = max(res[f"{prec}_max_abs_err"], err)
        lay = res["by_layout"].setdefault(f"{weights} {prec}", {
            "cases": 0, "bit_mismatches": 0, "max_rel_err": 0.0})
        lay["cases"] += 1
        lay["bit_mismatches"] += bits
        lay["max_rel_err"] = max(lay["max_rel_err"], rel)
        if prec == "exact":
            res["exact_bit_mismatches"] += bits
        else:
            res["fast_max_rel_err"] = max(res["fast_max_rel_err"], rel)
        return {"max_abs_err": err, "rel_err": rel, "bit_mismatches": bits}

    for B in P5_HELD_B:
        w, x = ps.chain_inputs(B, ps.R_DEFAULT, D, 1, dev)
        for prec in ps.PRECISIONS:
            for gate in (True, False):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ref = ps.chain_plain(w, x, T, gate, prec)
                torch.cuda.synchronize()
                if B == 16 and gate:
                    res["plain_ms"][prec] = (time.perf_counter() - t) * 1e3
                for weights, rows in P5_HELD_LAYOUTS:
                    rows = B if rows == "B" else rows
                    held(prec, weights, lambda: ps.make_chain(
                        B, ps.R_DEFAULT, D, T, prec, gate, 1, rows,
                        weights)(w, x), ref,
                        f"B={B} {prec} gate={gate} {weights} rows={rows}")
    # every instance: rows a worker 1, 2, 4 at R=64 (unrolled) and R=32,
    # two groups, two CTAs or clusters
    res["instances"] = {}
    for (weights, np_, R), sh in ps.instance_shapes().items():
        w, x = ps.chain_inputs(sh["B"], R, D, sh["groups"], dev)
        for prec in ps.PRECISIONS:
            for gate in (True, False):
                ref = ps.chain_plain(w, x, T, gate, prec)
                key = (f"{weights} NP={np_} R={R} B={sh['B']} rows="
                       f"{sh['rows']} groups={sh['groups']} {prec} "
                       f"gate={gate}")
                res["instances"][key] = held(
                    prec, weights, lambda: ps.make_chain(
                        sh["B"], R, D, T, prec, gate, sh["groups"],
                        sh["rows"], weights)(w, x), ref, key)
    # the timed shapes, on the inputs `measure` times them on (B=16, gate
    # on): D=43 in L2, the stream and the cluster (one row a CTA or cluster
    # and the whole batch in one), W in shared memory at SMEM_D
    res["timed_shapes"] = {}
    for D, where in ((ps.D_DEFAULT, ("l2", "stream", "cluster")),
                     (ps.SMEM_D, ("smem",))):
        w, x = ps.chain_inputs(ps.B_DEFAULT, ps.R_DEFAULT, D, 1, dev)
        for prec in ps.PRECISIONS:
            ref = ps.chain_plain(w, x, P5_TIMED_HELD_T, True, prec)
            for rows in (1, 2, ps.B_DEFAULT):
                for weights in where:
                    key = f"{prec} D={D} {weights} rows={rows}"
                    res["timed_shapes"][key] = held(
                        prec, weights, lambda: ps.make_chain(
                            ps.B_DEFAULT, ps.R_DEFAULT, D, P5_TIMED_HELD_T,
                            prec, True, 1, rows, weights)(w, x), ref, key)
    return res


def p5_bound(ps, B: int, D: int, T: int, prec: str, groups: int = 1):
    """P5's least time: W read once, x read and written once; per row and
    stage the products (2 R 2R) and the gate (the exact one at its cheaper
    tanh branch, the fast one at its multiply), and the t-fold add per
    step.  A lower bound: the data decide tanh's branch."""
    R = ps.R_DEFAULT
    gate = TANH_SMALL_OPS + SIGMOID_OPS + 1 if prec == "exact" else 1
    ops = groups * B * T * (D * (2 * R * 2 * R + gate * R) + R)
    return bound_ms(4 * (D * R * 2 * R + 2 * groups * B * R), ops)


def spec_hold(torch, np, eng, B: int, T: int, window: int, kernels,
              all_kernels, label: str) -> dict:
    """`run()` of T samples at batch B, then `run_speculative` fixed and
    adaptive on the same engine, each on launch counts set to 0 just
    before it: 0 integer mismatches against run(), the speculative path's
    kernels launched; rounds, branch, kHz per utterance beside run()'s."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    y_run = eng.run(T, B)
    run_s = time.perf_counter() - t
    out = {"run_khz_per_utt": T / run_s / 1e3, "run_us_per_step":
           run_s / T * 1e6}
    for adaptive in (False, True):
        for k in all_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = eng.run_speculative(T, B, window=window, adaptive=adaptive)
        dt = time.perf_counter() - t
        launches = {k.symbol: k.launches for k in all_kernels if k.launches}
        r = {"mismatches": int((y != y_run).sum()),
             "rounds": eng.spec_rounds, "branch": eng.spec_branch,
             "khz_per_utt": T / dt / 1e3, "seconds": dt,
             "mean_committed_run": T / eng.spec_rounds,
             "launches": launches}
        key = "adaptive" if adaptive else "fixed"
        out[key] = r
        log(f"[spec] {label} b={B} T={T} window={window} {key}: "
            f"{r['mismatches']}/{B * T} mismatches vs run(); {r['rounds']} "
            f"rounds (mean committed run {r['mean_committed_run']:.1f}); "
            f"branch {r['branch']}; {r['khz_per_utt']:.3f} kHz per "
            f"utterance against run()'s {out['run_khz_per_utt']:.3f}")
        if r["mismatches"]:
            fail(f"run_speculative ({label}, b={B}, {key}) differs from "
                 f"run() in {r['mismatches']} samples")
        missing = [k.symbol for k in kernels if not launches.get(k.symbol)]
        if missing:
            fail(f"run_speculative ({label}, b={B}, {key}) did not launch "
                 f"{missing}")
    return out


def spec_perturbed_hold(torch, np, fc, eng, B: int, T: int, window: int,
                        offset: float, costs: dict, label: str) -> dict:
    """`run_speculative` with the engine's draft fold made from rs_w +
    offset, so drafts disagree with the exact samples and rounds commit
    part of a window: fixed, then adaptive with each of `costs`
    (branch -> spec_cost_model forcing it, None the default).  0 integer
    mismatches against run(), the branch asked for, and more rounds than
    whole windows (the state committer ran)."""
    y_run = eng.run(T, B)
    vals = eng._value_params()
    bad = fc.prepare_weights(dict(vals, rs_w=vals["rs_w"] + offset), eng.cfg,
                             False, fast_math=True)
    default_cost = eng.spec_cost_model
    out = {}
    for branch, cost in [(None, None)] + list(costs.items()):
        eng.spec_cost_model = cost or default_cost
        eng._spec_prep = bad
        y = eng.run_speculative(T, B, window=window,
                                adaptive=branch is not None)
        r = {"mismatches": int((y != y_run).sum()),
             "rounds": eng.spec_rounds, "branch": eng.spec_branch}
        key = "fixed" if branch is None else f"adaptive, forced {branch}"
        out[key] = r
        log(f"[spec] {label} b={B} T={T} window={window} {key}: "
            f"{r['mismatches']}/{B * T} mismatches vs run(); {r['rounds']} "
            f"rounds; branch {r['branch']}")
        if r["mismatches"] or r["branch"] != branch:
            fail(f"run_speculative ({label}, b={B}, {key}): {r}")
        if branch is None and r["rounds"] <= -(-T // window):
            fail(f"run_speculative ({label}, b={B}): the wrong draft "
                 f"committed whole windows only ({r['rounds']} rounds)")
    eng.spec_cost_model = default_cost
    eng._spec_prep = None
    return out


def mesh_cond(torch, cfg, T: int, B: int, seed: int, dev):
    """Conditioning [T, L, B, 2R] uniform in [-0.5, 0.5) drawn on the card
    from `seed`: the same tensor in every process on this card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.rand((T, cfg.num_layers, B, 2 * cfg.R), generator=gen,
                      device=dev) - 0.5


def state_mismatches(np, a: dict, b: dict) -> int:
    """Elements of two snapshots (`export_state`) whose bits differ: the
    ring, y_state and the row clocks."""
    def bits(x):
        x = np.ascontiguousarray(x)
        return x.view(f"i{x.dtype.itemsize}")
    return sum(int((bits(a[k]) != bits(b[k])).sum())
               for k in ("ring", "y_state", "stream_t_row"))


def check_mesh(torch, np, persistent, fc, om, mesh_lib, Impl, WaveNetInfer,
               cfg, ref_w, dev, card) -> dict:
    """The mesh at full width (phase 32c): the flagship at B=16 split over
    two shards of one card, each generating its 8 rows with its own launch
    on its own stream, against the unsharded engine bit for bit in K1 (and
    2x its launches), the staged K4 (int8), the cluster K6, prng with each
    shard's key, a forced dump, a score -> feed handoff and a migration;
    two processes on the card joined on gloo; every card where there are
    several; and kHz per utterance in turns."""
    out = {"card": card}
    B, half = MAIN_B, MAIN_B // 2
    two = mesh_lib.data_mesh(2, [dev, dev])
    out["mesh"] = repr(two)

    def make(mesh, rows=B, **kw):
        eng = WaveNetInfer(num_layers=cfg.num_layers,
                           max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                           A=cfg.A, max_batch=rows, chunk_size=MAIN_CHUNK,
                           mesh=mesh, device=None if mesh else dev, **kw)
        eng.set_reference_weights(ref_w)
        return eng

    def counted(counters, fn):
        """fn() on counts set to 0 just before it; (its result, the counts
        read just after)."""
        for k in counters:
            k.launches = 0
        res = fn()
        torch.cuda.synchronize()
        return res, [k.launches for k in counters]

    # (a) K1: two shards of one card against the unsharded engine, default
    # selectors, through run_chunks
    cond = mesh_cond(torch, cfg, MESH_T, B, MESH_SEED, dev)
    k1 = persistent.PERSISTENT_KERNELS["exact"]
    engines, runs = {}, {}
    for name, mesh in (("single", None), ("mesh", two)):
        eng = engines[name] = make(mesh)
        eng.set_inputs(cond)
        y, (n,) = counted([k1], lambda: eng.run_chunks(
            MAIN_CHUNK, lambda *a: None, MESH_T, B))
        runs[name] = (y, eng.export_state(), n)
    (y_s, st_s, n_s), (y_m, st_m, n_m) = runs["single"], runs["mesh"]
    a = {"y_mismatches": int((y_s != y_m).sum()),
         "state_bit_mismatches": state_mismatches(np, st_s, st_m),
         "k1_launches": {"single": n_s, "mesh": n_m}}
    out["k1"] = a
    log(f"[mesh] (a) K1, {two}: {a['y_mismatches']} mismatches in "
        f"{B} x {MESH_T} samples against the unsharded engine, "
        f"{a['state_bit_mismatches']} bits of ring and y_state; K1 "
        f"launches {n_m} against {n_s}")
    if a["y_mismatches"] or a["state_bit_mismatches"]:
        fail("the two-shard mesh disagrees with the unsharded engine")
    if n_s == 0 or n_m != 2 * n_s:
        fail(f"K1 launched {n_m} times on the mesh, {n_s} unsharded "
             f"(expected twice as many, each shard its own launch)")

    # (e) speed, in turns: unsharded, mesh, mesh, unsharded
    khz = {"single": [], "mesh": []}
    for name in ("single", "mesh", "mesh", "single"):
        eng = engines[name]
        eng.set_inputs(cond)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.run_chunks(MAIN_CHUNK, lambda *a: None, MESH_T, B)
        torch.cuda.synchronize()
        khz[name].append(MESH_T / (time.perf_counter() - t) / 1e3)
    out["khz_per_utt"] = khz
    log(f"[mesh] (e) kHz per utterance, B={B}, {MESH_T} samples through "
        f"run_chunks({MAIN_CHUNK}), in turns: unsharded "
        f"{khz['single'][0]:.3f} / {khz['single'][1]:.3f}, two shards on "
        f"one card {khz['mesh'][0]:.3f} / {khz['mesh'][1]:.3f}; {card}")
    del engines

    # (b) the other tiers over MESH_TIER_T samples
    T = MESH_TIER_T
    stag = persistent.PERSISTENT_KERNELS["exact"]

    def pair(kw, counter, mode="sample", sel=None, dump=False, seed=0):
        res = []
        for mesh in (None, two):
            eng = make(mesh, **kw)
            eng.sampling_seed = seed
            eng.set_inputs(cond[:T], sel)
            y, (n,) = counted([counter], lambda: eng.run(
                T, B, mode=mode, dump_activations=dump))
            dumps = ({k: eng._dump(k) for k in ("xt", "skip", "zs", "za",
                                                "p")} if dump else {})
            res.append((y, eng.export_state(), dumps, n))
        (y1, s1, d1, n1), (y2, s2, d2, n2) = res
        return {"y_mismatches": int((y1 != y2).sum()),
                "state_bit_mismatches": state_mismatches(np, s1, s2),
                "dump_bit_mismatches": sum(bit_mismatches(torch, d1[k], d2[k])
                                           for k in d1),
                "launches": {"single": n1, "mesh": n2}}, y1
    tiers = {}
    tiers["manyblock int8 (the staged K4)"], _ = pair(
        dict(implementation=Impl.MANYBLOCK, stream_quant="int8"), stag)
    tiers["priority=latency (the cluster K6)"], _ = pair(
        dict(priority="latency"), fc.FUSED_KERNELS[("injected", "fast")])
    forced = torch.from_numpy(y_s[:, :T].T.astype(np.float32).copy())
    tiers["forced dump (the staged K2)"], y_f = pair(
        {}, stag, mode="forced", sel=forced, dump=True)
    if not np.array_equal(y_f, y_s[:, :T]):
        fail("the forced run did not emit its symbols")

    # prng: shard k keyed on shard_key(seed, k); rows 8-15 repeat rows
    # 0-7's conditioning, so only the keys tell the shards apart
    cond_p = torch.cat([cond[:T, :, :half]] * 2, dim=2)
    eng = make(two)
    eng.sampling_seed = PRNG_SEED
    eng.set_inputs(cond_p)
    y_p, (n_p,) = counted([stag], lambda: eng.run(T, B, mode="prng"))
    prng = {"launches": n_p, "shard_keys": [], "y_mismatches": 0}
    for k in range(2):
        one = make(None, rows=half)
        one.sampling_seed = mesh_lib.shard_key(PRNG_SEED, k)
        one.set_inputs(cond_p[:, :, k * half:(k + 1) * half])
        prng["shard_keys"].append(one.sampling_seed)
        prng["y_mismatches"] += int((one.run(T, half, mode="prng")
                                     != y_p[k * half:(k + 1) * half]).sum())
    prng["shards_differ_in"] = int((y_p[:half] != y_p[half:]).sum())
    tiers["prng (each shard its key)"] = prng

    # score -> feed handoff and export -> import, at MESH_SPLIT
    S = MESH_SPLIT
    handoff = []
    for mesh in (None, two):
        eng = make(mesh)
        eng.begin_stream(B)
        (p, tail), n = counted([om.ORDERED_GATE_KERNEL, k1], lambda: (
            eng.score(cond[:S], y_s[:, :S]), eng.feed(cond[S:T])))
        handoff.append((p, tail, n))
    tiers["score -> feed"] = {
        "p_bit_mismatches": bit_mismatches(torch, handoff[0][0],
                                           handoff[1][0]),
        "tail_mismatches": int((handoff[0][1] != handoff[1][1]).sum()),
        "launches": {"single": handoff[0][2], "mesh": handoff[1][2]},
        "launches_are": "K7's gate entry, K1"}
    single = make(None)
    single.begin_stream(B)
    single.feed(cond[:S])
    tail_single = single.feed(cond[S:T])
    src = make(two)
    src.begin_stream(B)
    src.feed(cond[:S])
    dst = make(two)
    dst.import_state(src.export_state())
    tiers["export -> import"] = {"tail_mismatches": int(
        (dst.feed(cond[S:T]) != tail_single).sum())}
    out["tiers"] = tiers
    for name, r in tiers.items():
        log(f"[mesh] (b) {name}: {json.dumps(r)}")
    for name, r in tiers.items():
        bad = sum(v for k, v in r.items() if k.endswith("mismatches"))
        if bad:
            fail(f"the mesh disagrees with the unsharded engine: {name}")
        n = r.get("launches")
        # each shard launches its own kernels: the mesh twice as often
        if isinstance(n, dict) and not (
                np.all(np.asarray(n["single"]) > 0)
                and np.array_equal(np.asarray(n["mesh"]),
                                   2 * np.asarray(n["single"]))):
            fail(f"{name}: launches {n} (each shard's own expected)")
    if not prng["launches"] or not prng["shards_differ_in"]:
        fail("prng under the mesh: no launch, or the shards drew alike")

    # (c) two processes on this card, joined by initialize_multihost on
    # gloo; the libraries are built already (phase 2)
    out["two_processes"] = mesh_two_processes(np, torch, cfg, dev, make)

    # (d) every card, where there are several
    n_cards = torch.cuda.device_count()
    if n_cards > 1 and B % n_cards == 0:
        y_all = []
        for mesh in (None, mesh_lib.data_mesh()):
            eng = make(mesh)
            eng.set_inputs(cond[:T])
            y_all.append(eng.run(T, B))
        out["every_card"] = {"cards": n_cards, "y_mismatches": int(
            (y_all[0] != y_all[1]).sum())}
        log(f"[mesh] (d) {n_cards} cards: {out['every_card']}")
        if out["every_card"]["y_mismatches"]:
            fail("the mesh over every card disagrees with one card")
    else:
        out["every_card"] = f"{n_cards} card(s): not run"
    return out


def mesh_two_processes(np, torch, cfg, dev, make) -> dict:
    """Phase 32c(c): two processes of this script (`--mesh-worker`) each
    generate their 8 rows of the flagship batch through `set_inputs` with
    process-local inputs and default selectors; their rows against the
    single-process engine given those selectors explicitly."""
    import socket
    from nv_wavenet_tpu_torch.engine.wavenet_infer import _selector_stream
    B, half, T = MAIN_B, MAIN_B // 2, MESH_MP_T
    work = os.path.join(HERE, "build", "mesh_smoke")
    os.makedirs(work, exist_ok=True)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--mesh-worker", str(rank), str(port), work],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        outs = [p.communicate(timeout=MESH_WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"mesh worker {rank} exited {p.returncode}:\n"
                 f"{text[-3000:]}")
    reports = [json.loads(next(ln for ln in text.splitlines()
                               if ln.startswith("{\"mesh_worker\"")))[
        "mesh_worker"] for text in outs]
    y_mp = np.concatenate([np.load(os.path.join(work, f"y{r}.npy"))
                           for r in range(2)], axis=0)
    sel = np.concatenate([_selector_stream(0, 0, T, half, pidx)
                          for pidx in range(2)], axis=1)
    eng = make(None)
    eng.set_inputs(mesh_cond(torch, cfg, T, B, MESH_SEED + 1, dev), sel)
    y1 = eng.run_chunks(MAIN_CHUNK, lambda *a: None, T, B)
    res = {"seconds": time.perf_counter() - t, "workers": reports,
           "y_mismatches": int((y_mp != y1).sum())}
    log(f"[mesh] (c) two processes on one card (gloo): "
        f"{res['y_mismatches']} mismatches in {B} x {T} against the "
        f"single-process run given their selectors; {json.dumps(reports)}; "
        f"{res['seconds']:.1f} s")
    if res["y_mismatches"] or not all(r["default_selectors_ok"] and
                                      r["k1_launches"] for r in reports):
        fail("the two-process mesh disagrees with one process")
    return res


def mesh_worker(rank: int, port: int, work: str) -> int:
    """One process of phase 32c(c): the flagship's rows rank * 8 .. + 8
    through `initialize_multihost` (gloo) and `data_mesh()` (this process's
    card), default selectors, saved to work/y<rank>.npy."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.engine.wavenet_infer import (WaveNetInfer,
                                                           _selector_stream)
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import persistent
    from nv_wavenet_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_lib.initialize_multihost(f"127.0.0.1:{port}", 2, rank,
                                  device="cuda")
    try:
        cfg = cfg_lib.FLAGSHIP_CONFIG
        dev = torch.device("cuda", torch.cuda.current_device())
        mesh = mesh_lib.data_mesh()
        half, T = MAIN_B // 2, MESH_MP_T
        cond = mesh_cond(torch, cfg, T, MAIN_B, MESH_SEED + 1, dev)[
            :, :, rank * half:(rank + 1) * half]
        eng = WaveNetInfer(num_layers=cfg.num_layers,
                           max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                           A=cfg.A, max_batch=MAIN_B, chunk_size=MAIN_CHUNK,
                           mesh=mesh)
        eng.set_reference_weights(params_lib.random_reference_weights(
            cfg, seed=1))
        eng.set_inputs(cond)
        mine = np.concatenate([s.cpu().numpy() for s in eng._selectors], 1)
        k1 = persistent.PERSISTENT_KERNELS["exact"]
        k1.launches = 0
        y = eng.run_chunks(MAIN_CHUNK, lambda *a: None, T, MAIN_B)
        torch.cuda.synchronize()
        np.save(os.path.join(work, f"y{rank}.npy"), y)
        print(json.dumps({"mesh_worker": {
            "rank": rank, "mesh": repr(mesh), "rows": list(y.shape),
            "default_selectors_ok": bool(np.array_equal(
                mine, _selector_stream(0, 0, T, half, rank))),
            "k1_launches": k1.launches}}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def train_kernel_group(name: str) -> str:
    """A device event of a training step by what it does (phase 32e's
    traced split)."""
    n = name.lower()
    if n.startswith(("memcpy", "memset")):
        return "memcpy/memset"
    for group, keys in (
            ("optimizer", ("adam", "multi_tensor", "foreach")),
            ("loss", ("softmax", "nll", "cross_entropy")),
            ("convolution", ("conv", "xmma", "cudnn", "implicit", "wgrad",
                             "dgrad", "winograd", "fft")),
            ("gemm", ("gemm", "cutlass", "cublas", "sm90_", "ampere_")),
            ("reduce", ("reduce",)),
            ("elementwise/copy", ("elementwise", "vectorized", "unrolled",
                                  "cat", "copy", "index", "embedding",
                                  "pad"))):
        if any(k in n for k in keys):
            return group
    return "other"


def on_card(e) -> bool:
    """Whether a profiler event ran on the card."""
    return str(e.device_type).endswith("CUDA")


def launched_ops(events) -> list:
    """The card's ops of a trace, each with the host start of the runtime
    call that launched it (cudaLaunchKernel, cuLaunchKernelEx,
    cudaMemcpyAsync, ...; None where none was recorded), matched by the
    correlation id the two share.  The card's side of a host range
    (record_function's, gloo's own) spans ops already counted, and is left
    out."""
    launch = {e.id: e.time_range.start for e in events
              if not on_card(e) and e.name.startswith("cu")}
    return [(e, launch.get(e.id, launch.get(
        getattr(e, "linked_correlation_id", None)))) for e in events
        if on_card(e) and not (getattr(e, "is_user_annotation", False)
                               or e.name.startswith(("nvw:", "gloo:")))]


def traced_train_step(torch, tracing, trainer, precision_scope, state, mel,
                      audio, mesh, path: str) -> dict:
    """One training step (forward with the loss, backward, Adam; the card
    synchronised at the end of each) traced with `tracing.trace`: device
    time by part and kernel group (`train_kernel_group`), the heaviest
    kernels, and the host time inside collectives (torch.distributed's
    c10d and gloo events) by part.  Every event is placed on the host's
    clock: a host event by its start, a device event by the start of the
    runtime call that launched it (its correlation id), in the part
    (the main thread's record_function range) that holds it.  The
    backward's kernels launch from autograd's thread and gloo's copies
    from gloo's, while the main thread waits inside the backward's range.
    Raises where a device event falls in no part, or a part holds none."""
    parts = ("forward", "backward", "optimizer")
    rf = torch.profiler.record_function
    with tracing.trace(path) as prof:
        with precision_scope(state.module.precision):
            with rf("nvw:forward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss = trainer.cross_entropy_loss(
                    state.model(mel, audio, mesh=mesh), audio)
                torch.cuda.synchronize()
            with rf("nvw:backward"):
                loss.backward()
                torch.cuda.synchronize()
            with rf("nvw:optimizer"):
                state.optimizer.step()
                torch.cuda.synchronize()
    events = list(prof.events())
    host = {}
    for e in events:
        if e.name.startswith("nvw:") and not on_card(e):
            host[e.name[4:]] = (e.time_range.start, e.time_range.end)
    out = {"device_ms": {p: {} for p in parts}, "launches": {},
           "collective_host_ms": {p: {} for p in parts}}

    def part_of(t):
        return next((p for p in parts
                     if host[p][0] <= t <= host[p][1]), "other")

    kernels = {}
    ops = launched_ops(events)
    for e, t in ops:
        ms = e.time_range.elapsed_us() / 1e3
        g = train_kernel_group(e.name)
        d = out["device_ms"].setdefault(
            "other" if t is None else part_of(t), {})
        d[g] = d.get(g, 0.0) + ms
        out["launches"][g] = out["launches"].get(g, 0) + 1
        kernels[e.name] = kernels.get(e.name, 0.0) + ms
    for e in events:
        if not on_card(e) and e.name.startswith(("c10d::", "gloo:")):
            fam = e.name.split(":")[0]
            c = out["collective_host_ms"].setdefault(
                part_of(e.time_range.start), {})
            c[fam] = c.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    out["top_kernels_ms"] = dict(sorted(kernels.items(),
                                        key=lambda kv: -kv[1])[:10])
    out["part_ms"] = {p: sum(v.values()) for p, v in
                      out["device_ms"].items()}
    out["total_device_ms"] = sum(out["part_ms"].values())
    out["host_ms"] = {p: (host[p][1] - host[p][0]) / 1e3 for p in parts}
    empty = [p for p in parts if out["part_ms"][p] <= 0]
    if empty or out["part_ms"].get("other", 0.0) > 0:
        unplaced = [(e.name[:40], e.id) for e, t in ops if t is None]
        raise RuntimeError(
            f"the traced step's split: no device time in {empty}, "
            f"{out['part_ms'].get('other', 0.0):.3f} ms in no part "
            f"({out['device_ms'].get('other')}); {len(unplaced)} of "
            f"{len(ops)} device events without a runtime call: "
            f"{unplaced[:5]}")
    return out


def collective_counts(before: dict, after: dict, steps: int) -> dict:
    """Each kind of collective's calls and bytes a step, from two readings
    of `tracing.counters()` (`mesh.<kind>`, `mesh.<kind>.bytes`) taken
    `steps` steps apart; kinds not called between them left out."""
    out = {}
    for k, v in after.items():
        calls = v - before.get(k, 0)
        if k.startswith("mesh.") and not k.endswith(".bytes") and calls:
            out[k[5:]] = {"calls": calls / steps, "bytes": (
                after[k + ".bytes"] - before.get(k + ".bytes", 0)) / steps}
    return out


def traced_collectives(torch, tracing, step, state, mel, audio,
                       path: str) -> dict:
    """One step traced with `tracing.trace`: its host ms, and for each kind
    of collective the host ms of its `nvw:mesh.<kind>` spans and the device
    ms of the ops launched, on any thread, while one was open (gloo
    launches its copies from its own threads while the caller waits in the
    span), each op tied to its launching call by correlation id."""
    with tracing.trace(path) as prof:
        t0 = time.perf_counter()
        step(state, mel, audio)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    spans = [(e.name[len("nvw:mesh."):], e.time_range.start,
              e.time_range.end) for e in events
             if e.name.startswith("nvw:mesh.") and not on_card(e)]
    out = {k: {"host_ms": 0.0, "device_ms": 0.0} for k, _, _ in spans}
    for k, a, b in spans:
        out[k]["host_ms"] += (b - a) / 1e3
    for e, t in launched_ops(events):
        k = next((k for k, a, b in spans if t is not None and a <= t <= b),
                 None)
        if k is not None:
            out[k]["device_ms"] += e.time_range.elapsed_us() / 1e3
    return {"step_ms": step_ms, "collectives": out}


def tp_excess(torch, got, ref) -> dict:
    """Per tensor, the largest |got - ref| - TP_GRAD_RTOL |ref| (a
    gradient within rtol and atol of ref reads <= atol)."""
    return {k: float(((got[k].double() - r).abs()
                      - TP_GRAD_RTOL * r.abs()).max())
            for k, r in ref.items()}


def check_train_parallel(torch, np, dev, card) -> dict:
    """Phase 32e: tensor and sequence parallel training at configs/
    config.json's full width.  On the card in this process: the
    one-process step and its gradient in float64; then TP_WORKERS
    processes of this script (`--train-worker`) sharing the card, joined on
    gloo, take one held step on each mesh of TP_MESHES from the same seed
    and batch (data 1 x model 2 through the training CLI, the others
    through make_mesh / shard_train_state / make_sharded_train_step), save
    a collective checkpoint and time TP_TIMED steps; a data 1 x model 2
    step and a one-process step are traced inside a worker.  The holds:
    the one-process fp32 step's gradient within TP_GRAD_ATOL of float64
    (`tp_excess`), a "default" (TF32) step's not; the loss within
    TP_LOSS_TOL of the one-process step's; every gradient within
    TP_GRAD_ATOL of the one-process step's and of float64; the parameters
    after Adam within 2.1 lr of the one-process step's; the checkpoint
    loaded into a one-process model bit for bit.  The one-process step is timed before
    and after the workers."""
    import socket
    from nv_wavenet_tpu_torch.models.wavenet import precision_scope
    from nv_wavenet_tpu_torch.train import trainer
    from nv_wavenet_tpu_torch.train.data import (Mel2Samp,
                                                 data_config_from_json,
                                                 synthetic_clips)
    t_start = time.perf_counter()
    t_parts = {}

    def mark_t(what):
        t_parts[what] = time.perf_counter() - t_start

    work = os.path.join(HERE, "build", "train_parallel_smoke")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(HERE, TRAIN_CONFIG)) as f:
        cfg_json = json.load(f)
    wc, tc = cfg_json["wavenet_config"], cfg_json["train_config"]
    data_cfg = data_config_from_json(cfg_json["data_config"])
    ds = Mel2Samp(synthetic_clips(n_clips=4,
                                  length=4 * data_cfg.segment_length),
                  data_cfg, seed=tc["seed"])
    mel_np, audio_np = next(ds.batches(tc["batch_size"]))
    torch.save({"mel": torch.from_numpy(mel_np),
                "audio": torch.from_numpy(audio_np)},
               os.path.join(work, "batch.pt"))
    ports = []
    for _ in range(2):
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        ports.append(str(sock.getsockname()[1]))
        sock.close()
    # the training CLI at data 1 x model 2 in workers 0 and 1: one step
    # from the seed on its first batch (this batch), a checkpoint after it
    with open(os.path.join(work, "cli_config.json"), "w") as f:
        json.dump(dict(cfg_json, train_config=dict(
            tc, num_iters=1, iters_per_checkpoint=1,
            output_directory=os.path.join(work, "ckpt_" + mesh_tag(TP_1X2)),
            checkpoint_path="", log_every=1), dist_config={
                "data_parallel": 1, "model_parallel": 2, "seq_parallel": 1,
                "num_processes": 2,
                "coordinator_address": f"127.0.0.1:{ports[1]}"}), f)
    mel = torch.from_numpy(mel_np).to(dev)
    audio = torch.from_numpy(audio_np).to(dev)
    out = {"card": card, "batch": list(audio.shape), "mel": list(mel.shape),
           "meshes": [list(m) for m in TP_MESHES], "t": t_parts}
    mark_t("batch")

    # the one-process step: the reference of the loss and of Adam, timed;
    # the gradient in float64 (cuDNN's double convolutions)
    tcfg = trainer.TrainConfig(learning_rate=tc["learning_rate"],
                               seed=tc["seed"])
    one = trainer.create_train_state(trainer.create_model(wc), tcfg, dev)
    loss1 = float(trainer.train_step(one, mel, audio))
    grads1 = {k: p.grad.detach().cpu()
              for k, p in one.module.named_parameters()}
    after1 = {k: v.detach().cpu() for k, v in one.module.state_dict().items()}
    mark_t("one-process step")
    turns = [train_timed_steps(torch, trainer, precision_scope, one, mel,
                               audio, TP_TIMED)]
    mark_t("timed")
    t = time.perf_counter()
    net64 = trainer.create_model(wc)
    net64.reset_parameters(torch.Generator().manual_seed(tc["seed"]))
    net64.double().to(dev)
    loss64 = trainer.cross_entropy_loss(net64(mel.double(), audio), audio)
    loss64.backward()
    grads64 = {k: p.grad.detach().cpu()
               for k, p in net64.named_parameters()}
    out["fp64"] = {"loss": float(loss64.detach()),
                   "s": time.perf_counter() - t}
    del net64, loss64
    torch.cuda.empty_cache()
    # the one-process fp32 step within the atol of float64, and a
    # "default" (TF32) step outside it
    tf32 = trainer.create_train_state(
        trainer.create_model(dict(wc, precision="default")), tcfg, dev)
    trainer.train_step(tf32, mel, audio)
    e_tf32 = tp_excess(torch, {k: p.grad.detach().cpu() for k, p in
                               tf32.module.named_parameters()}, grads64)
    del tf32
    e_one = tp_excess(torch, grads1, grads64)
    out["one_process_vs_fp64"] = {
        "excess_max": max(e_one.values()), "worst": max(e_one, key=e_one.get),
        "tf32_excess_max": max(e_tf32.values()),
        "tf32_worst": max(e_tf32, key=e_tf32.get)}
    if not (max(e_one.values()) <= TP_GRAD_ATOL < max(e_tf32.values())):
        log(json.dumps({"train_parallel": out}))
        fail(f"the fp32 step against float64: {out['one_process_vs_fp64']}"
             f" (the fp32 step within {TP_GRAD_ATOL}, the TF32 step not)")
    mark_t("fp64")
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--train-worker", str(rank), ports[0], work],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(TP_WORKERS)]
    try:
        outs = [p.communicate(timeout=TP_WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out["workers_s"] = time.perf_counter() - t
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"train worker {rank} exited {p.returncode}:\n"
                 f"{text[-4000:]}")
    reports = [json.loads(next(ln for ln in text.splitlines()
                               if ln.startswith("{\"train_worker\"")))[
        "train_worker"] for text in outs]
    mark_t("workers")
    turns.append(train_timed_steps(torch, trainer, precision_scope, one,
                                   mel, audio, TP_TIMED))
    mark_t("timed again")
    out["one_process"] = {"loss": loss1, "turns": [
        {k: r[k] for k in ("ms_per_step", "forward_ms", "backward_ms",
                           "optimizer_ms")} for r in turns]}
    del one

    lr = tc["learning_rate"]
    holds = {}
    for axes in TP_MESHES:
        tag = mesh_tag(axes)
        res = torch.load(os.path.join(work, f"{tag}.pt"))
        e_mesh = tp_excess(torch, res["grads"], grads64)
        direct = tp_excess(torch, res["grads"], grads1)
        h = {"ranks_loss": [r["losses"][tag] for r in reports
                            if tag in r["losses"]]}
        h["loss_err"] = max(abs(l - loss1) for l in h["ranks_loss"])
        h["grad_vs_fp64_excess_max"] = max(e_mesh.values())
        h["grad_vs_fp64_worst"] = max(e_mesh, key=e_mesh.get)
        h["grad_vs_one_process_excess_max"] = max(direct.values())
        h["grad_vs_one_process_worst"] = max(direct, key=direct.get)
        h["grad_max_abs_err"] = max(float((res["grads"][k] - g).abs().max())
                                    for k, g in grads1.items())
        h["param_max_abs_err"] = max(float((res["params"][k] - v).abs()
                                           .max())
                                     for k, v in after1.items())
        # the collective checkpoint in a one-process model, bit for bit
        fresh = trainer.create_train_state(
            trainer.create_model(wc), trainer.TrainConfig(
                seed=tc["seed"] + 1), dev)
        fresh, it = trainer.load_checkpoint(
            os.path.join(work, f"ckpt_{tag}"), None, fresh)
        got = fresh.module.state_dict()
        h["checkpoint_iteration"] = it
        h["checkpoint_bit_mismatches"] = sum(
            bit_mismatches(torch, got[k], v) for k, v in
            res["params"].items())
        h["checkpoint_tensors"] = len(got)
        del fresh, res
        mark_t(f"held {tag}")
        h["ok"] = bool(h["loss_err"] <= TP_LOSS_TOL
                       and h["grad_vs_fp64_excess_max"] <= TP_GRAD_ATOL
                       and h["grad_vs_one_process_excess_max"]
                       <= TP_GRAD_ATOL
                       and h["param_max_abs_err"] <= 2.1 * lr
                       and it == 1 and not h["checkpoint_bit_mismatches"]
                       and len(got) == len(after1))
        holds[tag] = h
    out["holds"] = holds
    out["workers"] = reports
    bad = {tag: h for tag, h in holds.items() if not h["ok"]}
    if bad:
        log(json.dumps({"train_parallel": out}))
        fail(f"tensor/sequence parallel training: {bad}")
    return out


def mesh_tag(axes) -> str:
    return "x".join(str(a) for a in axes)


def log_train_parallel(r: dict, card: str) -> None:
    """Phase 32e's lines: each hold, ms a step in turns with the
    collectives' share, and the traced split."""
    rank0 = next(w for w in r["workers"] if w["rank"] == 0)
    o = r["one_process_vs_fp64"]
    log(f"[train-tp] against the fp64 gradient ({r['fp64']['s']:.2f} s on "
        f"the card), |g - g64| - {TP_GRAD_RTOL} |g64| up to: the one-process "
        f"fp32 step {o['excess_max']:.3g} ({o['worst']}), a \"default\" "
        f"(TF32) step {o['tf32_excess_max']:.3g} ({o['tf32_worst']}); the "
        f"gradients' atol {TP_GRAD_ATOL}")
    for tag, h in r["holds"].items():
        log(f"[train-tp] {tag}: loss err {h['loss_err']:.3g} (tol "
            f"{TP_LOSS_TOL}); gradients over rtol against fp64 up to "
            f"{h['grad_vs_fp64_excess_max']:.3g} "
            f"({h['grad_vs_fp64_worst']}), against the one-process step "
            f"{h['grad_vs_one_process_excess_max']:.3g} "
            f"({h['grad_vs_one_process_worst']}); params after "
            f"Adam max abs err {h['param_max_abs_err']:.3g} (2.1 lr); "
            f"checkpoint {h['checkpoint_bit_mismatches']} bit mismatches in "
            f"{h['checkpoint_tensors']} tensors")
    one = [t["ms_per_step"] for t in r["one_process"]["turns"]]
    log(f"[train-tp] one process: {one[0]:.2f} ms a step before the "
        f"workers, {one[-1]:.2f} after; {card}")
    for tag, m in rank0["meshes"].items():
        coll = m["collectives_traced_ms"]
        log(f"[train-tp] {tag} ({m['rows']} rows x {m['window']} samples a "
            f"rank): {m['ms_per_step']:.2f} ms a step; a traced step "
            f"{m['step_traced_ms']:.2f} ms, "
            f"{sum(v['host_ms'] for v in coll.values()):.2f} ms inside its "
            f"collectives (host / device ms: "
            + ", ".join(f"{k} {v['host_ms']:.2f} / {v['device_ms']:.2f}"
                        for k, v in sorted(coll.items()))
            + f"); processes sharing one card on gloo: what the collectives "
            f"cost, not a speed-up; {card}")
    for tag, t in rank0["traces"].items():
        log(f"[train-tp] traced {tag}: {t['total_device_ms']:.2f} ms of "
            f"device time; " + "; ".join(
                f"{p} {t['part_ms'][p]:.2f} ms (" + ", ".join(
                    f"{g} {v:.2f}" for g, v in sorted(d.items())) + ")"
                for p, d in t["device_ms"].items())
            + f"; host ms inside collectives {t['collective_host_ms']}")
    log(f"[train-tp] seconds from the phase's start: {r['t']}; worker 0's "
        f"from its own: {rank0['t']}")


def train_worker(rank: int, port: str, work: str) -> int:
    """One process of phase 32e.  All TP_WORKERS ranks: the data 2 x model
    2 x seq 2 mesh.  Ranks 0 and 1 then: the training CLI at data 1 x model
    2 (cli_config.json; it joins its own group), the data 1 x seq 2 mesh in
    that group, and a traced data 1 x model 2 step; rank 0 alone at the
    end, a traced one-process step.  Each mesh: one held step (rank 0 saves
    the gathered gradients and parameters), a collective checkpoint,
    TP_TIMED steps timed and one more traced (its collectives' host and
    device time)."""
    t_start = time.perf_counter()
    import torch
    import torch.distributed as dist
    # eight processes on the host's cores: one thread each; the CUDA
    # context made now, beside the other workers' imports
    torch.set_num_threads(1)
    torch.zeros(1, device="cuda")
    sys.path.insert(0, HERE)
    from nv_wavenet_tpu_torch.models.wavenet import precision_scope
    from nv_wavenet_tpu_torch.parallel import mesh as mesh_lib
    from nv_wavenet_tpu_torch.train import cli, trainer
    from nv_wavenet_tpu_torch.utils import tracing

    with open(os.path.join(HERE, TRAIN_CONFIG)) as f:
        cfg_json = json.load(f)
    wc, tc = cfg_json["wavenet_config"], cfg_json["train_config"]
    tcfg = trainer.TrainConfig(learning_rate=tc["learning_rate"],
                               seed=tc["seed"])
    batch = torch.load(os.path.join(work, "batch.pt"))
    report = {"rank": rank, "losses": {}, "meshes": {}, "traces": {},
              "t": {"imports": time.perf_counter() - t_start}}

    def mark_t(what):
        report["t"][what] = time.perf_counter() - t_start

    def rows_of(mesh):
        b = batch["audio"].shape[0] // mesh.data
        dev = torch.device("cuda", torch.cuda.current_device())
        return tuple(batch[k][mesh.data_rank * b:(mesh.data_rank + 1) * b]
                     .to(dev) for k in ("mel", "audio"))

    def hold(tag, state):
        """The held step's gathered gradients and parameters (every rank:
        collectives), saved by rank 0."""
        grads = trainer.full_state_dict(
            state, {k: p.grad for k, p in state.module.named_parameters()})
        params = trainer.full_state_dict(state)
        if rank == 0:
            torch.save({"grads": {k: v.cpu() for k, v in grads.items()},
                        "params": {k: v.cpu() for k, v in params.items()}},
                       os.path.join(work, f"{tag}.pt"))

    def timed(tag, state):
        """TP_TIMED steps timed, each kind of collective's calls and bytes
        a step counted, then one step traced (`traced_collectives`)."""
        mesh = state.mesh
        step = trainer.make_sharded_train_step(mesh)
        mel, audio = rows_of(mesh)
        before = tracing.counters()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        losses = [float(step(state, mel, audio)) for _ in range(TP_TIMED)]
        ms = (time.perf_counter() - t0) * 1e3 / TP_TIMED
        per_step = collective_counts(before, tracing.counters(), TP_TIMED)
        dist.barrier()
        traced = traced_collectives(
            torch, tracing, step, state, mel, audio,
            os.path.join(HERE, "build", "traces",
                         f"collectives_{tag}_rank{rank}.json"))
        report["meshes"][tag] = {
            "mesh": repr(mesh), "rows": audio.shape[0],
            "window": audio.shape[1] // mesh.seq, "ms_per_step": ms,
            "timed_losses": losses, "collectives_per_step": per_step,
            "collectives_traced_ms": traced["collectives"],
            "step_traced_ms": traced["step_ms"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        mark_t(tag)

    def run_mesh(axes):
        tag = mesh_tag(axes)
        net = trainer.create_model(wc)
        mesh = trainer.make_mesh(*axes, net=net,
                                 segment_length=batch["audio"].shape[1])
        state = trainer.shard_train_state(net, tcfg, mesh)
        mark_t(f"{tag} built")
        report["losses"][tag] = float(trainer.make_sharded_train_step(mesh)(
            state, *rows_of(mesh)))
        mark_t(f"{tag} held step")
        hold(tag, state)
        trainer.save_checkpoint(os.path.join(work, f"ckpt_{tag}"), state, 1)
        mark_t(f"{tag} saved")
        timed(tag, state)

    mesh_lib.initialize_multihost(f"127.0.0.1:{port}", TP_WORKERS, rank,
                                  device="cuda")
    mark_t("joined")
    run_mesh(TP_2X2X2)
    dist.destroy_process_group()
    if rank < 2:
        # data 1 x model 2 through the training CLI: its one step is the
        # held step, its checkpoint the collective save
        tag = mesh_tag(TP_1X2)
        state, losses = cli.main(["-c", os.path.join(work, "cli_config.json"),
                                  "--process_id", str(rank)])
        report["losses"][tag] = losses[0]
        mark_t("cli")
        hold(tag, state)
        run_mesh(TP_1X1X2)
        timed(tag, state)
        # the traced data 1 x model 2 step (both ranks trace: the same
        # collectives in the same order; rank 0's is reported)
        mel, audio = trainer.sharding.batch_partition(
            state.mesh, *rows_of(state.mesh))
        report["traces"][tag] = traced_train_step(
            torch, tracing, trainer, precision_scope, state, mel, audio,
            state.mesh, os.path.join(HERE, "build", "traces",
                                     f"train_{tag}_rank{rank}.json"))
        del state
        dist.destroy_process_group()
    if rank == 0:
        one = trainer.create_train_state(trainer.create_model(wc), tcfg)
        dev = torch.device("cuda", torch.cuda.current_device())
        mel, audio = batch["mel"].to(dev), batch["audio"].to(dev)
        trainer.train_step(one, mel, audio)
        report["traces"]["one_process"] = traced_train_step(
            torch, tracing, trainer, precision_scope, one, mel, audio,
            None, os.path.join(HERE, "build", "traces",
                               "train_one_process.json"))
    mark_t("end")
    print(json.dumps({"train_worker": report}), flush=True)
    return 0


def check_tools(torch, np, persistent, om, em, all_kernels, dev,
                card) -> dict:
    """The user's tools on the card (phase 32d), on phase 32b's trained
    model: `NVWaveNet.infer` from its `export_weights` against the engine's
    run bit for bit; `torch_import` of its state_dict (the exports equal,
    the conditioning within TOOLS_COND_TOL); `nvw-torch-verify`'s checks;
    `eval_checkpoint` on its checkpoint (finite bits per sample below
    log2(A))."""
    from nv_wavenet_tpu_torch.engine import torch_import
    from nv_wavenet_tpu_torch.engine.nv_wavenet import Impl, NVWaveNet
    from nv_wavenet_tpu_torch.engine.wavenet_infer import WaveNetInfer
    from nv_wavenet_tpu_torch.models import wavenet as wavenet_lib
    from nv_wavenet_tpu_torch.tools import eval_checkpoint, verify_drive
    from nv_wavenet_tpu_torch.train import trainer
    from nv_wavenet_tpu_torch.train.data import (data_config_from_json,
                                                 mel_spectrogram,
                                                 synthetic_clips)
    out = {"card": card}
    work = os.path.join(HERE, "build", "train_smoke")
    config, ckpt = os.path.join(work, "config.json"), os.path.join(work,
                                                                   "ckpt")
    with open(config) as f:
        cfg_json = json.load(f)
    model = trainer.create_model(cfg_json["wavenet_config"])
    state = trainer.create_train_state(model, trainer.TrainConfig(), dev)
    _, it = trainer.load_checkpoint(ckpt, None, state)
    model.eval()
    data_cfg = data_config_from_json(cfg_json["data_config"])
    clips = synthetic_clips(n_clips=TOOLS_B, length=TOOLS_CLIP,
                            sr=data_cfg.sampling_rate, seed=3)
    mel = torch.from_numpy(np.stack([mel_spectrogram(c, data_cfg)
                                     for c in clips]).astype(np.float32))
    with torch.no_grad():
        cond = model.get_cond_input(mel.to(dev))             # [T, L, B, 2R]
    T, _, B, _ = cond.shape
    cfg = wavenet_lib.config_of(model)

    # NVWaveNet.infer (the reference layout) against the engine's run
    k1 = persistent.PERSISTENT_KERNELS["exact"]
    net = NVWaveNet(**wavenet_lib.export_weights(model), chunk_size=MAIN_CHUNK)
    for k in all_kernels:
        k.launches = 0
    y_net = net.infer(cond.permute(3, 2, 1, 0), Impl.PERSISTENT, seed=0)
    n_net = k1.launches
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, tanh_embed=cfg.tanh_embed,
                       chunk_size=MAIN_CHUNK, device=dev)
    eng.set_canonical_params(wavenet_lib.export_canonical(model))
    eng.set_inputs(cond, seed=0)
    y_eng = eng.run(T, B)
    out["nv_wavenet"] = {"iteration": it, "samples": [B, T],
                         "mismatches": int((y_net != y_eng).sum()),
                         "k1_launches": n_net}

    # torch_import: the trained model's state_dict, natively on the card
    sd = model.state_dict()
    d = torch_import.export_weights_from_state_dict(sd, model.max_dilation)
    want = wavenet_lib.export_weights(model)
    diff = 0
    for k, v in want.items():
        got = d[k]
        pairs = zip(got, v) if isinstance(v, list) else [(got, v)]
        for a, b in pairs:
            if isinstance(b, np.ndarray):
                diff += int((a.cpu().numpy().reshape(b.shape) != b).sum())
            elif a != b:
                diff += 1
    cond_imp = torch_import.cond_input_from_state_dict(
        sd, mel.transpose(1, 2), model.upsamp_stride)
    cond_err = float((cond_imp - cond.permute(3, 2, 1, 0)).abs().max())
    out["torch_import"] = {"export_mismatches": diff,
                           "cond_max_abs_err": cond_err,
                           "device": str(d["embedding_curr"].device)}

    # nvw-torch-verify, in this process
    t = time.perf_counter()
    try:
        rc = verify_drive.main([])
    except SystemExit as err:
        rc = err.code
    out["verify"] = {"rc": rc, "seconds": time.perf_counter() - t}

    # eval_checkpoint on the checkpoint (synthetic clip)
    for k in all_kernels:
        k.launches = 0
    t = time.perf_counter()
    res = eval_checkpoint.evaluate([
        "-c", ckpt, "--config", config, "--seconds", str(TOOLS_SECONDS),
        "-o", os.path.join(work, "eval_gen.wav")])
    res["seconds"] = time.perf_counter() - t
    res["launches"] = {k.symbol: k.launches for k in all_kernels
                       if k.launches}
    out["eval_checkpoint"] = res
    log(f"[tools] NVWaveNet.infer vs the engine's run: "
        f"{out['nv_wavenet']['mismatches']} mismatches in {B} x {T} "
        f"(K1 launches {n_net}); torch_import: {diff} export mismatches, "
        f"cond max abs err {cond_err:.3g} (tol {TOOLS_COND_TOL}); "
        f"nvw-torch-verify rc {rc} in {out['verify']['seconds']:.1f} s; "
        f"eval_checkpoint: {res['bits_per_sample']:.4f} bits/sample over "
        f"{res['samples']} samples, dominant {res['source_hz']:.1f} -> "
        f"{res['generated_hz']:.1f} Hz, {res['seconds']:.1f} s; {card}")
    if out["nv_wavenet"]["mismatches"] or not n_net:
        fail("NVWaveNet.infer disagrees with the engine (or launched no K1)")
    if diff or not cond_err <= TOOLS_COND_TOL:
        fail("torch_import does not round-trip the trained model")
    if rc != 0:
        fail(f"nvw-torch-verify exited {rc}")
    bits = res["bits_per_sample"]
    if not (np.isfinite(bits) and bits < np.log2(cfg.A)):
        fail(f"eval_checkpoint: {bits} bits per sample")
    if not (res["launches"].get(om.ORDERED_GATE_KERNEL.symbol)
            and res["launches"].get(em.SOFTMAX_KERNEL.symbol)
            and res["launches"].get(k1.symbol)):
        fail(f"eval_checkpoint did not run the scorer and K1: "
             f"{res['launches']}")
    return out


def main() -> int:
    import numpy as np
    import torch

    # -- phase 1: device ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "nv_wavenet_tpu_torch")):
        fail("the nv_wavenet_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.engine.wavenet_infer import Impl, WaveNetInfer
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import exact_math as em
    from nv_wavenet_tpu_torch.ops import fused_chain as fc
    from nv_wavenet_tpu_torch.ops import ordered_matmul as om
    from nv_wavenet_tpu_torch.ops import persistent, scoring
    from nv_wavenet_tpu_torch.ops import scan_generate as tsg
    from nv_wavenet_tpu_torch.ops import speculative
    from nv_wavenet_tpu_torch.tools import probe_exact_math as pem
    from nv_wavenet_tpu_torch.tools import probe_stage as ps
    from nv_wavenet_tpu_torch.tools import scorer_ab
    from nv_wavenet_tpu_torch.utils import build, profiling, tracing

    # the plain versions' matrix products go to cuBLAS: full fp32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    nvcc = build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    log(f"[device] nvcc {nvcc}: {nvcc_ver.splitlines()[-1]}")

    # -- phase 2: build -------------------------------------------------------
    mark("phase 2: build")
    # nvcc runs in its own processes: the horizon case's plain CPU run (it
    # needs no kernel) goes on beside it, on one thread (its operations are
    # small, and more threads only contend with nvcc for the cores)
    def timed_build():
        t = time.perf_counter()
        return build.build_all(), time.perf_counter() - t
    threads = torch.get_num_threads()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(timed_build)
        torch.set_num_threads(1)
        t = time.perf_counter()
        horizon = horizon_plain(torch, np, cfg_lib, params_lib, persistent)
        horizon_s = time.perf_counter() - t
        torch.set_num_threads(threads)
        logs, build_s = job.result()
    log(f"[build] {len(logs)} libraries ({len(build.SOURCES)} sources, "
        f"{', '.join(build.PRECISION_SOURCES)} one library per precision) "
        f"in {build_s:.2f} s "
        f"({' '.join(build.NVCC_FLAGS)}) -> {build.build_dir()}; beside it "
        f"the horizon case's plain CPU run, {horizon_s:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or line.startswith("built in")):
                log(f"[build] {src}: {line.strip()}")

    # -- phase 3: K0a vs plain ------------------------------------------------
    mark("phase 3: K0a vs plain")
    x_np = dense_sweep()
    x = torch.from_numpy(x_np).to(dev)
    k0a = {"mismatches": 0, "max_abs_err": 0.0, "cpu_plain_mismatches": 0}
    for name in ("exp", "tanh", "sigmoid"):
        yk = em.exact_fn(name, x)
        yp = em.PLAIN_FNS[name](x)
        torch.cuda.synchronize()
        mism = int((yk.view(torch.int32) != yp.view(torch.int32)).sum())
        cpu = em.PLAIN_FNS[name](x.cpu())
        cpu_mism = int((yk.cpu().view(torch.int32)
                        != cpu.view(torch.int32)).sum())
        k0a["mismatches"] += mism
        k0a["cpu_plain_mismatches"] += cpu_mism
        k0a["max_abs_err"] = max(k0a["max_abs_err"],
                                 float((yk - yp).abs().max()))
        log(f"[K0a] {name}: {mism}/{x.numel()} bit mismatches vs plain on "
            f"the card, {cpu_mism} vs plain on the CPU")
    if k0a["mismatches"]:
        fail(f"K0a disagrees with its plain version: {k0a['mismatches']}")
    # device time (K0A_GRAPH launches captured in one CUDA graph) at the JAX
    # probe's 450,020 floats and at the scorer's embedding [131072, 64],
    # beside torch's call of the same function, before any profiler session
    k0a["device_ms"], k0a["torch_device_ms"] = {}, {}
    for shape in K0A_SHAPES:
        xs = torch.rand(shape, generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev) * 16 - 8
        label = "x".join(map(str, shape))
        for name in ("exp", "tanh", "sigmoid"):
            k0a["device_ms"][f"{name} {label}"] = scorer_ab.graph_ms(
                torch, lambda: em.exact_fn(name, xs))
            k0a["torch_device_ms"][f"{name} {label}"] = scorer_ab.graph_ms(
                torch, lambda: getattr(torch, name)(xs))
        del xs
    log("[K0a] device ms (a CUDA graph of 100 launches) kernel / torch: "
        + ", ".join(f"{k} {v:.5f} / {k0a['torch_device_ms'][k]:.5f}"
                    for k, v in k0a["device_ms"].items()))

    # -- phase 4: K0b vs plain ------------------------------------------------
    mark("phase 4: K0b vs plain")
    k0b = check_k0b(torch, np, em, scorer_ab, build, dev)
    for row in k0b["per_shape"]:
        log(f"[K0b] {row['instance']} za {row['shape']}: "
            f"{row['mismatches']} mismatches vs plain on the card, "
            f"{row['cpu_plain_mismatches']} vs plain on the CPU (sel 1.0 "
            f"rows: {row['sel1_rows_mismatches']} mismatches, "
            f"{row['sel1_rows_silent']} of 8 silent); {row['ms']:.5f} ms, "
            f"device {row['device_ms']:.5f} (bound {row['bound_ms']:.5f}, "
            f"plain {row['plain_ms']:.4f}); checked in {row['check_s']:.2f} s")
    log("[K0b] in turns at " + str(k0b["turns"]["shape"]) + ", old / new / "
        "new / old: " + "; ".join(
            f"{label} device " + ", ".join(f"{v:.5f}" for v in
                                           t["device_ms"])
            + " ms, events " + ", ".join(f"{v:.5f}" for v in t["ms"])
            for label, t in k0b["turns"].items() if label != "shape")
        + f"; {card}")
    log(json.dumps({"k0b": k0b, "card": card}))
    if k0b["mismatches"] or k0b["cpu_plain_mismatches"]:
        fail(f"K0b disagrees with its plain version: {k0b['mismatches']} on "
             f"the card, {k0b['cpu_plain_mismatches']} against the CPU")

    # K0c and K7 at the scorer's shapes
    mark("phase 4: K0c and K7 vs plain")
    gen_k0c = torch.Generator(device=dev)
    gen_k0c.manual_seed(40)
    k0c = check_k0c(torch, em, dev, gen_k0c)
    for row in k0c["per_shape"]:
        log(f"[K0c] {row['instance']} za {row['shape']}: "
            f"{row['mismatches']} bit mismatches vs plain on the card, "
            f"{row.get('cpu_plain_mismatches', 'not run')} vs plain on the "
            f"CPU; {row['ms']:.4f} ms (torch.softmax {row['library_ms']:.4f}, "
            f"bound {row['bound_ms']:.4f}); checked in {row['check_s']:.2f} s")
    if k0c["mismatches"]:
        fail(f"K0c disagrees with its plain version: {k0c['mismatches']}")
    mark("phase 4: K7 vs plain")
    gen_k7 = torch.Generator(device=dev)
    gen_k7.manual_seed(7)
    k7 = check_k7(torch, om, dev, gen_k7)
    for row in k7["per_shape"]:
        log(f"[K7] {row['entry']} {row['shape']}: {row['mismatches']} bit "
            f"mismatches vs plain; {row['ms']:.4f} ms "
            f"({row['product_tflops']:.2f} TFLOP/s of products; library "
            f"{row['library_ms']}, bound {row['bound_ms']:.4f}, no-FMA floor "
            f"{row['nofma_floor_ms']:.4f}); checked in {row['check_s']:.2f} s")
    log(json.dumps({"k7": k7, "k0c": k0c, "card": card}))
    if k7["mismatches"]:
        fail(f"K7 disagrees with its plain version: {k7['mismatches']}")

    # -- phase 5: K1 vs plain, small config -----------------------------------
    mark("phase 5: K1 vs plain, small config")
    cfg = cfg_lib.TEST_CONFIG_MED
    B, T = 4, 32
    ref_w = params_lib.random_reference_weights(cfg, seed=11)
    params = params_lib.canonical_to_torch(
        params_lib.to_canonical(ref_w, cfg), dev)
    rng = np.random.RandomState(1011)
    cond_np = (rng.uniform(-1, 1, (T, cfg.num_layers, B, 2 * cfg.R))
               .astype(np.float32) * 0.5)
    sel_np = rng.uniform(0, 1, (T, B)).astype(np.float32)
    cond = torch.from_numpy(cond_np).to(dev)
    sel = torch.from_numpy(sel_np).to(dev)
    cond_pre = (cond + params["dil_b"][None, :, None, :]).contiguous()
    ladder = (("xt", 1e-2, 3e-4), ("skip", 1e-2, 3e-4), ("zs", 1e-4, 2e-5),
              ("za", 1e-4, 2e-5), ("p", 1e-3, None))
    y_small = None
    for mode in ("sample", "argmax"):
        def fresh():
            return (persistent.init_ring(cfg, B, dev),
                    torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                               device=dev))
        gen = persistent.make_persistent_generator(cfg, B, mode=mode,
                                                   dump=True)
        out_k = gen(params, 0, cond_pre, sel, *fresh())
        out_p = persistent.generate_plain(cfg, params, 0, cond_pre, sel,
                                          *fresh(), T, mode=mode, dump=True)
        torch.cuda.synchronize()
        y_mism = int((out_k[0] != out_p[0]).sum())
        state_ok = torch.equal(out_k[2], out_p[2])
        ring_ok = rel_close(out_p[1].cpu(), out_k[1].cpu(), 1e-2, 3e-4)
        dumps_ok = all(rel_close(p.cpu(), k.cpu(), tol, atol)
                       for (_, tol, atol), k, p
                       in zip(ladder, out_k[3:], out_p[3:]))
        log(f"[K1 small] {mode}: y {y_mism}/{out_k[0].numel()} mismatches, "
            f"y_state equal {state_ok}, ring in ladder {ring_ok}, dumps in "
            f"ladder {dumps_ok}")
        if y_mism or not (state_ok and ring_ok and dumps_ok):
            fail(f"K1 disagrees with its plain version in mode {mode}")
        if mode == "sample":
            y_small = out_k[0].T.cpu().numpy()

    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=T, device="cuda")
    eng.set_reference_weights(ref_w)
    eng.set_inputs(cond, sel)
    y_one = eng.run(T, B)
    parts = [eng.run_partial(t0, min(7, T - t0), B) for t0 in range(0, T, 7)]
    y_parts = np.concatenate(parts, axis=1)
    log(f"[K1 small] run == kernel: {np.array_equal(y_one, y_small)}; "
        f"{len(parts)} chunked run_partial calls == one run: "
        f"{np.array_equal(y_one, y_parts)}")
    if not (np.array_equal(y_one, y_small) and np.array_equal(y_one, y_parts)):
        fail("chunked run_partial calls differ from one call")

    # K2 against the plain version, forcing K1's samples
    def fresh_med():
        return fresh_state(torch, persistent, cfg, B, dev)
    sym = torch.from_numpy(np.ascontiguousarray(y_small.T, np.float32)).to(dev)
    out_p = persistent.generate_plain(cfg, params, 0, cond_pre, sym,
                                      *fresh_med(), T, mode="forced",
                                      dump=True)
    k2_small = {"echo_mismatches": 0, "p_err": 0.0}
    for dump in (False, True):
        gen = persistent.make_persistent_generator(cfg, B, mode="forced",
                                                   dump=dump)
        out_k = gen(params, 0, cond_pre, sym, *fresh_med())
        torch.cuda.synchronize()
        echo = int((out_k[0] != sym.to(torch.int32)).sum())
        p_err = float((out_k[-1] - out_p[-1]).abs().max())
        state_ok = torch.equal(out_k[2], out_p[2])
        ring_ok = rel_close(out_p[1].cpu(), out_k[1].cpu(), 1e-2, 3e-4)
        dumps_ok = not dump or all(
            rel_close(p.cpu(), k.cpu(), tol, atol) for (_, tol, atol), k, p
            in zip(ladder, out_k[3:8], out_p[3:8]))
        k2_small["echo_mismatches"] += echo
        k2_small["p_err"] = max(k2_small["p_err"], p_err)
        log(f"[K2 small] dump={dump}: y echoes the symbols with {echo} "
            f"mismatches; p_seq max abs err {p_err:.3g} (limit 1e-6); "
            f"y_state equal {state_ok}, ring in ladder {ring_ok}, dumps in "
            f"ladder {dumps_ok}")
        if echo or p_err > 1e-6 or not (state_ok and ring_ok and dumps_ok):
            fail(f"K2 disagrees with its plain version (dump={dump})")

    # K3 through the engine against the plain version fed Philox selectors
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, chunk_size=T, device="cuda")
    eng.set_reference_weights(ref_w)
    eng.sampling_seed = PRNG_SEED
    eng.set_inputs(cond, sel)
    y3 = eng.run(T, B, mode="prng")
    sel3 = torch.from_numpy(tsg.prng_uniform_sel(PRNG_SEED, np.arange(T), B)
                            ).to(dev)
    y3p = persistent.generate_plain(cfg, params, 0, cond_pre, sel3,
                                    *fresh_med(), T)[0].T.cpu().numpy()
    parts = [eng.run_partial(t0, min(7, T - t0), B, mode="prng")
             for t0 in range(0, T, 7)]
    eng.sampling_seed = PRNG_SEED + 1
    y3_other = eng.run(T, B, mode="prng")
    k3_small = {"mismatches": int((y3 != y3p).sum()),
                "chunk_mismatches": int((np.concatenate(parts, 1) != y3).sum()),
                "seeds_differ": not np.array_equal(y3, y3_other)}
    log(f"[K3 small] run(mode='prng') vs plain fed prng_uniform_sel: "
        f"{k3_small['mismatches']}/{y3.size} mismatches; {len(parts)} chunked"
        f" run_partial calls vs one: {k3_small['chunk_mismatches']}; "
        f"another seed differs: {k3_small['seeds_differ']}")
    if (k3_small["mismatches"] or k3_small["chunk_mismatches"]
            or not k3_small["seeds_differ"]):
        fail("K3 disagrees with its plain version, or is not chunk "
             "invariant, or ignores its seed")

    # the horizon case: K1 on the card in chunks against the plain run on
    # the CPU made beside the build
    hcfg, h_ref, h_cond, h_sel, h_y_cpu = horizon
    h_params = params_lib.canonical_to_torch(h_ref, dev)
    cond_pre = (torch.from_numpy(h_cond).to(dev)
                + h_params["dil_b"][None, :, None, :]).contiguous()
    sel = torch.from_numpy(h_sel).to(dev)
    ring = persistent.init_ring(hcfg, HORIZON_B, dev)
    y_state = torch.full((2, HORIZON_B), hcfg.silence_bin, dtype=torch.int32,
                         device=dev)
    gen = persistent.make_persistent_generator(hcfg, HORIZON_B)
    ys = [gen(h_params, t0, cond_pre[t0:t0 + HORIZON_CHUNK],
              sel[t0:t0 + HORIZON_CHUNK], ring, y_state)[0]
          for t0 in range(0, HORIZON_T, HORIZON_CHUNK)]
    h_y = {"cuda": torch.cat(ys).cpu(), "cpu": h_y_cpu}
    h_mism = int((h_y["cuda"] != h_y["cpu"]).sum())
    log(f"[K1 horizon] {h_mism}/{HORIZON_B * HORIZON_T} mismatches, K1 on the "
        f"card in chunks of {HORIZON_CHUNK} vs plain on the CPU")
    if h_mism:
        fail(f"K1 disagrees with the plain version over the horizon: {h_mism}")

    # -- phase 6: K5 vs plain, small config -----------------------------------
    mark("phase 6: K5 vs plain, small config")
    # one seeded schedule of ragged ticks (one with every length 0, one with
    # one row at 0) through an engine on the card (K5) and through the plain
    # ragged generator on the card, carrying their own state
    B, T = K5_SMALL_B, K5_SMALL_T
    rng = np.random.RandomState(1013)
    sched = rng.randint(1, T + 1, size=(K5_SMALL_TICKS, B))
    sched[2] = 0
    sched[4, 1] = 0
    eng = WaveNetInfer(num_layers=cfg.num_layers,
                       max_dilation=cfg.max_dilation, R=cfg.R, S=cfg.S,
                       A=cfg.A, max_batch=B, device="cuda")
    eng.set_reference_weights(ref_w)
    eng.begin_stream(B)
    ring = persistent.init_ring(cfg, B, dev)
    y_state = torch.full((2, B), cfg.silence_bin, dtype=torch.int32,
                         device=dev)
    clocks = np.zeros(B, np.int64)
    k5_small_mism = 0
    k5_kernel = persistent.RAGGED_KERNELS["exact"]
    k5_launches = k5_kernel.launches
    for lens in sched:
        cond = torch.from_numpy(rng.uniform(
            -0.5, 0.5, (T, cfg.num_layers, B, 2 * cfg.R)).astype(np.float32)
            ).to(dev)
        sel = torch.from_numpy(rng.uniform(0, 1, (T, B)).astype(np.float32)
                               ).to(dev)
        y_eng = eng.feed(cond, sel, lengths=lens)
        y_pl = persistent.generate_plain(
            cfg, params, torch.from_numpy(clocks),
            (cond + params["dil_b"][None, :, None, :]).contiguous(), sel,
            ring, y_state, torch.from_numpy(lens.astype(np.int32)))[0]
        y_pl = y_pl.T.cpu().numpy()
        if lens.max():
            k5_small_mism += int((y_eng != y_pl).sum())
        elif y_eng.shape != (B, 0) or y_pl.any():
            fail("K5: a tick with every length 0 produced samples")
        clocks += lens
    snap = eng.export_state()
    k5_small_err = float(np.abs(snap["ring"] - ring.cpu().numpy()).max())
    k5_small_ok = (np.array_equal(snap["y_state"], y_state.cpu().numpy())
                   and rel_close(ring.cpu(), snap["ring"], 1e-2, 3e-4)
                   and np.array_equal(snap["stream_t_row"], clocks))
    log(f"[K5 small] {K5_SMALL_TICKS} ticks, lengths {sched.tolist()}: y "
        f"{k5_small_mism} mismatches, y_state and clocks equal and ring in "
        f"ladder {k5_small_ok} (max abs err {k5_small_err:.3g}); "
        f"{k5_kernel.launches - k5_launches} K5 launches")
    if k5_small_mism or not k5_small_ok:
        fail("K5 disagrees with its plain version")

    # timing of the standalone kernels at their check shapes (their launches
    # here are comparisons, not the main path: the counts are reset below)
    n_small = int((np.abs(x_np) < 0.5).sum())
    n = x.numel()
    fn_ops = {"exp": n * EXP_OPS,
              "tanh": n_small * TANH_SMALL_OPS + (n - n_small) * TANH_LARGE_OPS,
              "sigmoid": n * SIGMOID_OPS}
    lib_fn = {"exp": torch.exp, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
    k0a_ms = k0a_plain = k0a_lib = k0a_bound = 0.0
    k0a_by = set()
    for name in ("exp", "tanh", "sigmoid"):
        k0a_ms += time_ms(torch, lambda: em.exact_fn(name, x), 50)
        k0a_plain += time_ms(torch, lambda: em.PLAIN_FNS[name](x), 5)
        k0a_lib += time_ms(torch, lambda: lib_fn[name](x), 50)
        b_ms, b_by = bound_ms(8 * n, fn_ops[name])
        k0a_bound += b_ms
        k0a_by.add(b_by)

    # -- phase 7: the main path at full width ---------------------------------
    mark("phase 7: the main path at full width")
    cfg = cfg_lib.FLAGSHIP_CONFIG
    L, R = cfg.num_layers, cfg.R
    ref_w = params_lib.random_reference_weights(cfg, seed=1)
    eng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                       S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                       chunk_size=MAIN_CHUNK, device="cuda")
    eng.set_reference_weights(ref_w)
    gen_dev = torch.Generator(device=dev)
    gen_dev.manual_seed(0)
    # "K1" and "K4" count one entry point: the staged step's lockstep one
    # (K1, K2 and K3 on the staged route, K4); "K4 first" also counts K2
    # and K3 where the staged plan raises, "K1 generic" K1, K2 and K3 where
    # the first K4's plan raises too
    k1_tables = {"K1": persistent.PERSISTENT_KERNELS,
                 "K5": persistent.RAGGED_KERNELS,
                 "K4": persistent.PERSISTENT_KERNELS,
                 "K4 first": persistent.STREAM_KERNELS,
                 "K1 generic": persistent.GENERIC_KERNELS,
                 "K5 generic": persistent.GENERIC_RAGGED_KERNELS,
                 "K1 wide": persistent.WIDE_KERNELS}
    exact_sym = {k: t["exact"].symbol for k, t in k1_tables.items()}
    all_kernels = (em.EXACT_FN_KERNEL, em.SAMPLE_KERNEL,
                   em.SAMPLE_BLOCK_KERNEL, em.SOFTMAX_KERNEL,
                   em.SOFTMAX_BLOCK_KERNEL, om.ORDERED_MATMUL_KERNEL,
                   om.ORDERED_GATE_KERNEL, om.ORDERED_RES_SKIP_KERNEL,
                   *(k for t in k1_tables.values() for k in t.values()),
                   *fc.FUSED_KERNELS.values(), *fc.FIRST_FUSED_KERNELS.values())
    for k in all_kernels:
        k.launches = 0
    requests, main_ys = [], []
    for r in range(MAIN_REQUESTS):
        cond = (torch.rand((MAIN_T, L, MAIN_B, 2 * R), generator=gen_dev,
                           device=dev) - 0.5)
        sel = torch.rand((MAIN_T, MAIN_B), generator=gen_dev, device=dev)
        eng.set_inputs(cond, sel)
        seen = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = eng.run_chunks(MAIN_CHUNK, lambda yc, off, n: seen.append(n),
                           MAIN_T, MAIN_B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        ok = (y.shape == (MAIN_B, MAIN_T) and sum(seen) == MAIN_T
              and int(y.min()) >= 0 and int(y.max()) < cfg.A)
        log(f"[main] request {r + 1}: {MAIN_B} x {MAIN_T} samples in "
            f"{dt:.3f} s = {MAIN_T / dt / 1e3:.3f} kHz per utterance; "
            f"{len(seen)} chunks; output well-formed {ok}")
        if not ok:
            fail(f"request {r + 1}: malformed output")
        requests.append({"seconds": dt, "khz_per_utt": MAIN_T / dt / 1e3})
        main_ys.append(y)
        if r == 0:
            first = (cond, sel, y)
    launches = {k.symbol: k.launches for k in all_kernels}
    log(f"[main] launches on the main path: {launches}")
    if launches[exact_sym["K1"]] == 0:
        fail("the main path did not launch K1")

    # request 1's first FLAG_PLAIN_T samples: plain version vs the main path's
    # y, and K1 at the same shape (with the dump) vs the plain version
    cond, sel, y_main = first
    params = eng._device_params()
    cond_pre = (cond[:CHECK_T] + params["dil_b"][None, :, None, :]).contiguous()
    sel_c = sel[:CHECK_T].contiguous()
    n = FLAG_PLAIN_T

    def fresh():
        return (persistent.init_ring(cfg, MAIN_B, dev),
                torch.full((2, MAIN_B), cfg.silence_bin, dtype=torch.int32,
                           device=dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    out_p = persistent.generate_plain(cfg, params, 0, cond_pre[:n],
                                      sel_c[:n], *fresh(), n, dump=True)
    torch.cuda.synchronize()
    k1_plain = (time.perf_counter() - t) * 1e3
    plain_mism = int((out_p[0].T.cpu().numpy() != y_main[:, :n]).sum())
    gen = persistent.make_persistent_generator(cfg, MAIN_B, dump=True)
    out_k = gen(params, 0, cond_pre[:n].contiguous(), sel_c[:n].contiguous(),
                *fresh())
    torch.cuda.synchronize()
    k1_mism = int((out_k[0] != out_p[0]).sum())
    k1_err = max(float((k - p).abs().max())
                 for k, p in zip(out_k[1:2] + out_k[3:], out_p[1:2] + out_p[3:]))
    log(f"[main] first {n} samples of request 1: {plain_mism}/"
        f"{MAIN_B * n} mismatches main path vs plain on the card; "
        f"K1 (dump) vs plain {k1_mism}; max abs err of ring and dumps "
        f"{k1_err:.3g}")
    if plain_mism or k1_mism:
        fail("the main path disagrees with the plain version")

    gen = persistent.make_persistent_generator(cfg, MAIN_B)
    k1_ms = time_launch_ms(torch, np, lambda r, ys: gen(
        params, 0, cond_pre, sel_c, r, ys), fresh)
    k1_bound, k1_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T),
        k1_ops_per_row_step(cfg) * MAIN_B * CHECK_T)
    khz = float(np.mean([r["khz_per_utt"] for r in requests]))
    k1_us = k1_ms / CHECK_T * 1e3
    # K1/K5's plan at the flagship (ops/persistent.py::staged_plan)
    sp = persistent.staged_plan(cfg, MAIN_B)
    staged_plan_line = {
        "threads": [sp.chain_threads, sp.prev_threads, 32],
        "chain_slots": [sp.chain_slots, sp.slot_bytes],
        "prev_slots": [sp.prev_slots, sp.prev_slot_bytes],
        "copies_per_step": sum(m.chunks * (cfg.num_layers if m.name in (
            "prev", "cur", "rs") else 1) for m in sp.matrices),
        "stream_bytes": sp.stream_bytes, "smem_bytes": sp.smem_bytes,
        "geometry": sp.geometry}
    log(json.dumps({"k1_staged_plan": staged_plan_line}))
    log(json.dumps({"main_path": {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "samples_per_request": MAIN_T, "requests": requests,
        "khz_per_utt": khz, "k1_ms_per_256_steps": k1_ms,
        "k1_us_per_step": k1_us, "card": card}}))
    log(f"[main] lockstep K1: {k1_us:.2f} us per step (earlier runs: "
        f"PERF.md)")

    # -- phase 8: serving at full width ---------------------------------------
    mark("phase 8: serving at full width")
    def flagship_engine(**kw):
        e = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                         S=cfg.S, A=cfg.A, max_batch=SERVE["B"],
                         chunk_size=MAIN_CHUNK, device="cuda", **kw)
        e.set_reference_weights(ref_w)
        return e
    gen_serve = torch.Generator(device=dev)
    gen_serve.manual_seed(2)
    for k in all_kernels:
        k.launches = 0
    t = time.perf_counter()
    completed, st = serve_scenario(torch, np, flagship_engine, cfg, dev,
                                   np.random.RandomState(2024), gen_serve,
                                   **SERVE)
    serve_s = time.perf_counter() - t
    serve_launches = {k.symbol: k.launches for k in all_kernels}
    feed_ms = np.array(st["feed_ms"])
    p50, p99 = (float(v) for v in np.percentile(feed_ms, [50, 99]))
    serving = {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32",
        "slots": SERVE["B"], "ticks": st["ticks"],
        "lockstep_ticks": st["lockstep_ticks"], "seconds": serve_s,
        "feeds_timed": len(feed_ms), "feed_ms_p50": p50, "feed_ms_p99": p99,
        "feed_ms_max": float(feed_ms.max()),
        "samples_served": st["samples_served"],
        "samples_per_s_live_rows": st["samples_served"] / (feed_ms.sum() / 1e3),
        "dead_row_step_share": st["dead_row_steps"] / st["row_steps"],
        "utterances_started": st["utterances_started"],
        "utterances_completed": st["utterances_completed"],
        "launches": serve_launches, "card": card}
    log(json.dumps({"serving": serving}))
    if not (serve_launches[exact_sym["K5"]]
            and serve_launches[exact_sym["K1"]]):
        fail(f"the serving path did not launch both K1 and K5: "
             f"{serve_launches}")

    # -- phase 9: correctness at full width -----------------------------------
    mark("phase 9: correctness at full width")
    # the first utterances completed, replayed as one lockstep batch on a
    # fresh engine: each must equal what it was served, sample for sample
    chosen = completed[:SERVE_REPLAY]
    if len(chosen) < SERVE_REPLAY:
        fail(f"only {len(chosen)} utterances completed")
    replay_mism = replay_lockstep(torch, np, flagship_engine, cfg, dev, chosen)
    r3 = [u for u in chosen if u["start"] == SERVE["full_reset_tick"]
          and u["row"] not in SERVE["partial_rows"]
          and u["end"] > SERVE["partial_tick"]]
    migrated = [u for u in chosen if u["migrated"]]
    for u, m in zip(chosen, replay_mism):
        log(f"[replay] row {u['row']:2d}: {u['n']} samples, ticks "
            f"{u['start']}-{u['end']}, across the migration {u['migrated']}:"
            f" {m} mismatches")
    log(f"[replay] {len(chosen)} utterances, {sum(u['n'] for u in chosen)} "
        f"samples: {sum(replay_mism)} mismatches; {len(r3)} began at the "
        f"full reset and ran through the partial reset (R3), "
        f"{len(migrated)} crossed the migration (R7)")
    if sum(replay_mism) or not r3 or not migrated:
        fail("the served utterances do not replay exactly, or the replay "
             "misses the R3 or R7 sequence")

    # K5 at the flagship: one 160-step ragged tick of the scenario (its
    # lengths and row clocks), timed; the plain version over a
    # FLAG_PLAIN_T-step tick (the same rows scaled to FLAG_PLAIN_T steps),
    # and K5 on it against the plain
    if st["tick_of_160"] is None:
        fail("no ragged tick of 160 steps to time")
    lens, clocks = st["tick_of_160"]
    t0_row = torch.from_numpy(clocks)
    cond_pre = (cond[:SERVE["tick_t"]] + params["dil_b"][None, :, None, :]
                ).contiguous()
    sel_c = sel[:SERVE["tick_t"]].contiguous()
    gen5 = persistent.make_persistent_generator(cfg, MAIN_B, ragged=True)
    nvr = torch.from_numpy(lens.astype(np.int32))
    ring, ys = fresh()
    k5_ms = time_ms(torch, lambda: gen5(params, t0_row, cond_pre, sel_c,
                                        ring, ys, nvr), 5)
    live = int(lens.sum())
    k5_bound, k5_by = bound_ms(k5_bytes(cfg, MAIN_B, SERVE["tick_t"], live),
                               k1_ops_per_row_step(cfg) * live)
    lens32 = torch.from_numpy((lens * FLAG_PLAIN_T // SERVE["tick_t"]
                               ).astype(np.int32))
    cp32 = cond_pre[:FLAG_PLAIN_T].contiguous()
    sel32 = sel_c[:FLAG_PLAIN_T].contiguous()
    (ring_p, ys_p), (ring_k, ys_k) = fresh(), fresh()
    torch.cuda.synchronize()
    t = time.perf_counter()
    y_p = persistent.generate_plain(cfg, params, t0_row, cp32, sel32, ring_p,
                                    ys_p, lens32)[0]
    torch.cuda.synchronize()
    k5_plain = (time.perf_counter() - t) * 1e3
    y_k = gen5(params, t0_row, cp32, sel32, ring_k, ys_k, lens32)[0]
    torch.cuda.synchronize()
    k5_flag_mism = int((y_k != y_p).sum()) + int(not torch.equal(ys_k, ys_p))
    k5_err = max(k5_small_err, float((ring_k - ring_p).abs().max()))
    log(f"[K5 flagship] 160-step tick, lengths {lens.tolist()}: "
        f"{k5_ms:.3f} ms = {k5_ms / SERVE['tick_t'] * 1e3:.2f} us per step "
        f"of the longest row (lockstep K1 {k1_us:.2f}); bound {k5_bound:.4f}"
        f" ms ({k5_by}, {live} live row-steps); plain over a {FLAG_PLAIN_T}"
        f"-step tick {k5_plain:.1f} ms; K5 vs plain on it: {k5_flag_mism} "
        f"mismatches, ring max abs err {k5_err:.3g}")
    if k5_flag_mism:
        fail("K5 disagrees with its plain version at the flagship")
    k5_card = k5_card_check(torch, np, persistent, tracing, cfg, params, dev)
    log(json.dumps({"k5_card_check": k5_card}))
    if (k5_card["y_mismatches_k1"] or k5_card["y_mismatches_plain"]
            or k5_card["tail_nonzero"] or k5_card["ring_bit_mismatches_k1"]
            or not (k5_card["y_state_equal_k1"]
                    and k5_card["y_state_equal_plain"]
                    and k5_card["ring_in_ladder_plain"])
            or k5_card["sentinel_reused"] < K5_CARD_TICKS // 2
            or k5_card["binds"] != 2 or k5_card["clocks_past_2_31"] < 2):
        fail(f"K5's launch disagrees with K1 row by row or with its plain "
             f"version, or leaves y's tail unwritten: {k5_card}")
    # a batch past K5's rows a launch, on the staged K5 (the flagship) and
    # the generic one (an F2 geometry, R=9 in bf16)
    f2_cfg = cfg_lib.WaveNetConfig(num_layers=2, R=9, S=16, A=32,
                                   max_dilation=2, silence_bin=16)
    f2_params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(f2_cfg, seed=9), f2_cfg), dev)
    k5_groups = [k5_group_check(torch, np, persistent, cfg, params, dev),
                 k5_group_check(torch, np, persistent, f2_cfg, f2_params, dev,
                                torch.bfloat16)]
    log(json.dumps({"k5_group_check": k5_groups}))
    if ([g["route"] for g in k5_groups] != ["staged", "generic"]
            or any(g["y_mismatches"] or g["ring_bit_mismatches"]
                   or not g["y_state_equal"] for g in k5_groups)):
        fail(f"K5 over more rows than a launch takes disagrees with the same "
             f"rows fed apart: {k5_groups}")

    # -- phase 10: K2 and K3 at the flagship ----------------------------------
    mark("phase 10: K2 and K3 at the flagship")
    # request 1's samples are the symbols K2 forces; the plain versions run
    # FLAG_PLAIN_T steps, the kernels are timed over CHECK_T-step launches
    y_tb = torch.from_numpy(np.ascontiguousarray(y_main.T)).to(dev)  # [T, B]
    sym_main = y_tb.to(torch.float32)
    cp_chk = (cond[:CHECK_T] + params["dil_b"][None, :, None, :]).contiguous()
    sel_chk = sel[:CHECK_T].contiguous()
    n = FLAG_PLAIN_T
    gen2 = persistent.make_persistent_generator(cfg, MAIN_B, mode="forced")
    gen3 = persistent.make_persistent_generator(cfg, MAIN_B, mode="prng")
    sel3 = torch.from_numpy(tsg.prng_uniform_sel(PRNG_SEED, np.arange(n),
                                                 MAIN_B)).to(dev)
    plain = {}
    for name, mode, s_in in (("K2", "forced", sym_main[:n].contiguous()),
                             ("K3", "sample", sel3)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain[name] = persistent.generate_plain(
            cfg, params, 0, cp_chk[:n].contiguous(), s_in, *fresh(), n,
            mode=mode)
        torch.cuda.synchronize()
        plain[name] += ((time.perf_counter() - t) * 1e3,)
    out2 = gen2(params, 0, cp_chk[:n].contiguous(), sym_main[:n].contiguous(),
                *fresh())
    out3 = gen3(params, 0, cp_chk[:n].contiguous(), sel_chk[:n].contiguous(),
                *fresh(), seed=PRNG_SEED)
    torch.cuda.synchronize()
    k2_flag = {"echo_mismatches": int((out2[0] != y_tb[:n]).sum()),
               "p_err": float((out2[3] - plain["K2"][3]).abs().max()),
               "ring_err": float((out2[1] - plain["K2"][1]).abs().max()),
               "state_equal": torch.equal(out2[2], plain["K2"][2]),
               "plain_ms": plain["K2"][-1]}
    k3_flag = {"mismatches": int((out3[0] != plain["K3"][0]).sum())
               + int(not torch.equal(out3[2], plain["K3"][2])),
               "ring_err": float((out3[1] - plain["K3"][1]).abs().max()),
               "plain_ms": plain["K3"][-1]}
    k2_ms = time_launch_ms(torch, np, lambda r, ys: gen2(
        params, 0, cp_chk, sym_main[:CHECK_T].contiguous(), r, ys), fresh)
    k3_ms = time_launch_ms(torch, np, lambda r, ys: gen3(
        params, 0, cp_chk, sel_chk, r, ys, seed=PRNG_SEED), fresh)
    k2_bound, k2_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T) + 4 * CHECK_T * MAIN_B * cfg.A,
        (k1_ops_per_row_step(cfg) - cfg.A) * MAIN_B * CHECK_T)
    k3_bound, k3_by = bound_ms(
        k1_bytes(cfg, MAIN_B, CHECK_T) - 4 * CHECK_T * MAIN_B,
        (k1_ops_per_row_step(cfg) + PHILOX_OPS) * MAIN_B * CHECK_T)
    log(f"[K2 flagship] {n} steps vs plain: y echoes the symbols with "
        f"{k2_flag['echo_mismatches']} mismatches, p_seq max abs err "
        f"{k2_flag['p_err']:.3g}, ring {k2_flag['ring_err']:.3g}, y_state "
        f"equal {k2_flag['state_equal']}; {k2_ms:.3f} ms per {CHECK_T}-step "
        f"launch = {k2_ms / CHECK_T * 1e3:.2f} us per step (K1 {k1_us:.2f})")
    log(f"[K3 flagship] {n} steps vs plain fed prng_uniform_sel: "
        f"{k3_flag['mismatches']} mismatches, ring {k3_flag['ring_err']:.3g};"
        f" {k3_ms:.3f} ms per {CHECK_T}-step launch = "
        f"{k3_ms / CHECK_T * 1e3:.2f} us per step (K1 {k1_us:.2f})")
    if (k2_flag["echo_mismatches"] or k2_flag["p_err"] > 1e-6
            or not k2_flag["state_equal"] or k3_flag["mismatches"]):
        fail("K2 or K3 disagrees with its plain version at the flagship")
    # K2 and K3 run the staged step: bit for bit against the first K4's
    k2k3 = check_k2k3_routes(torch, np, persistent, tsg, cfg, params, cond,
                             sel, sym_main, dev, all_kernels)
    log(json.dumps({"k2k3_routes": {**k2k3, "steps": K2K3_T,
                                    "card": card}}))
    if k2k3["mismatches"]:
        fail(f"the staged K2/K3 differ from the first K4's: {k2k3}")

    # -- phase 11: scoring at full width --------------------------------------
    mark("phase 11: scoring at full width")
    # request 1's window scored from silence by the engine's time-parallel
    # scorer (K7, K0a, K0c) and by K2 on the same state and symbols
    for k in all_kernels:
        k.launches = 0
    seng = flagship_engine()
    seng.begin_stream(MAIN_B)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_eng = seng.score(cond, y_main)                          # [B, T, A]
    score_wall_ms = (time.perf_counter() - t) * 1e3
    snap = seng.export_state()
    cp_full = (cond + params["dil_b"][None, :, None, :]).contiguous()
    ring2, ys2 = fresh()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out_w = gen2(params, 0, cp_full, sym_main, ring2, ys2)
    end.record()
    torch.cuda.synchronize()
    k2_window_ms = start.elapsed_time(end)
    del cp_full
    score_cmp = {
        "p_bit_mismatches": bit_mismatches(
            torch, torch.from_numpy(p_eng), out_w[3].permute(1, 0, 2).cpu()),
        "ring_bit_mismatches": bit_mismatches(torch, snap["ring"],
                                              ring2.cpu()),
        "y_state_equal": bool(np.array_equal(snap["y_state"],
                                             ys2.cpu().numpy())),
        "echo_mismatches": int((out_w[0] != y_tb).sum())}
    scorer_times = []
    for _ in range(3):
        seng.begin_stream(MAIN_B)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        seng.score_device(cond, y_tb)
        end.record()
        torch.cuda.synchronize()
        scorer_times.append(start.elapsed_time(end))
    scorer_ms = float(np.mean(scorer_times))
    t = time.perf_counter()
    logp_k, bits_k = scoring.score_teacher_forced_kernel(params, cfg, cond,
                                                         y_main)
    kernel_score_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    t = time.perf_counter()
    logp_p, bits_p = scoring.score_teacher_forced_parallel(params, cfg, cond,
                                                           y_main)
    bits_p = bits_p.cpu().numpy()
    parallel_score_ms = (time.perf_counter() - t) * 1e3
    score_launches = {k.symbol: k.launches for k in all_kernels}
    # one pass on counts of its own: the launches of a scorer pass
    for k in all_kernels:
        k.launches = 0
    seng.begin_stream(MAIN_B)
    seng.score_device(cond, y_tb)
    torch.cuda.synchronize()
    per_pass = {k.symbol: k.launches for k in all_kernels if k.launches}
    want_pass = {om.ORDERED_GATE_KERNEL.symbol: L,
                 om.ORDERED_RES_SKIP_KERNEL.symbol: L,
                 om.ORDERED_MATMUL_KERNEL.symbol: 2,
                 em.EXACT_FN_KERNEL.symbol: 1, em.SOFTMAX_KERNEL.symbol: 1}
    log(f"[scoring] launches of one scorer pass: {per_pass}")
    if per_pass != want_pass:
        fail(f"a scorer pass launched {per_pass}, not {want_pass}")
    # its device time by kernel group is taken last (phase 33): once
    # torch.profiler has started, CUPTI stays attached and slows every
    # later launch
    traced_pass = (seng, cond, y_tb)
    bits_diff = float(np.abs(bits_k - bits_p).max())
    window_bound, window_by = bound_ms(
        k1_bytes(cfg, MAIN_B, MAIN_T) + 4 * MAIN_T * MAIN_B * cfg.A,
        (k1_ops_per_row_step(cfg) - cfg.A) * MAIN_B * MAIN_T)
    scoring_line = {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "window": MAIN_T, **score_cmp,
        "engine_score_wall_ms": score_wall_ms,
        "scorer_device_ms": scorer_ms, "k2_window_ms": k2_window_ms,
        "k2_over_scorer": k2_window_ms / scorer_ms,
        "window_bound_ms": window_bound, "window_bound_by": window_by,
        "score_teacher_forced_kernel_ms": kernel_score_ms,
        "score_teacher_forced_parallel_ms": parallel_score_ms,
        "bits_per_sample_kernel": float(bits_k.mean()),
        "bits_per_sample_parallel": float(bits_p.mean()),
        "bits_max_abs_diff": bits_diff, "launches": score_launches,
        "launches_per_pass": per_pass, "card": card}
    log(json.dumps({"scoring": scoring_line}))
    log(f"[scoring] scorer vs K2 over {MAIN_B} x {MAIN_T}: p_seq "
        f"{score_cmp['p_bit_mismatches']} bit mismatches, ring "
        f"{score_cmp['ring_bit_mismatches']}, y_state equal "
        f"{score_cmp['y_state_equal']}; scorer {scorer_ms:.2f} ms, K2 "
        f"{k2_window_ms:.1f} ms; bits per sample {bits_k.mean():.6f} (K2) "
        f"{bits_p.mean():.6f} (parallel), max diff {bits_diff:.3g}")
    if (score_cmp["p_bit_mismatches"] or score_cmp["ring_bit_mismatches"]
            or not score_cmp["y_state_equal"]
            or score_cmp["echo_mismatches"] or bits_diff > 1e-5):
        fail("the time-parallel scorer and K2 disagree, or the two scoring "
             "functions' bits per sample differ by more than 1e-5")
    scoring_kernels = (om.ORDERED_MATMUL_KERNEL, om.ORDERED_GATE_KERNEL,
                       om.ORDERED_RES_SKIP_KERNEL, em.EXACT_FN_KERNEL,
                       em.SOFTMAX_KERNEL,
                       persistent.PERSISTENT_KERNELS["exact"])
    if (not all(score_launches[k.symbol] for k in scoring_kernels)
            or score_launches[exact_sym["K4 first"]]
            or score_launches[exact_sym["K1 generic"]]):
        fail(f"the scoring path did not launch K7 (product, gate and "
             f"res/skip), K0a, K0c and K2 on the staged step (not the "
             f"first K4 or the generic kernel): {score_launches}")

    # -- phase 12: score -> feed handoff --------------------------------------
    mark("phase 12: score -> feed handoff")
    half = MAIN_T // 2
    heng = flagship_engine()
    heng.begin_stream(MAIN_B)
    yf1 = heng.feed(cond[:half], sel[:half])
    yf2 = heng.feed(cond[half:], sel[half:])
    feed_mism = int((np.concatenate([yf1, yf2], 1) != y_main).sum())
    heng.begin_stream(MAIN_B)
    p_half = heng.score(cond[:half], yf1)
    yf2b = heng.feed(cond[half:], sel[half:])
    handoff = {"feed_vs_run_mismatches": feed_mism,
               "handoff_mismatches": int((yf2b != yf2).sum()),
               "half_window_p_bit_mismatches": bit_mismatches(
                   torch, p_half, np.ascontiguousarray(p_eng[:, :half]))}
    log(f"[handoff] two feeds of {half} vs the run: {feed_mism} mismatches;"
        f" score the first half, feed the second: "
        f"{handoff['handoff_mismatches']} mismatches; half-window p_seq vs "
        f"the full window's: {handoff['half_window_p_bit_mismatches']} bit "
        f"mismatches")
    if any(handoff.values()):
        fail(f"the score -> feed handoff is not exact: {handoff}")
    del p_eng, p_half

    # -- phase 13: prng at full width -----------------------------------------
    mark("phase 13: prng at full width")
    for k in all_kernels:
        k.launches = 0
    peng = flagship_engine()
    peng.sampling_seed = PRNG_SEED
    peng.set_inputs(cond, sel)
    torch.cuda.synchronize()
    t = time.perf_counter()
    y_prng = peng.run_chunks(MAIN_CHUNK, lambda yc, off, n: None, MAIN_T,
                             MAIN_B, mode="prng")
    prng_s = time.perf_counter() - t
    prng_launches = {k.symbol: k.launches for k in all_kernels}
    prng_ok = (y_prng.shape == (MAIN_B, MAIN_T) and int(y_prng.min()) >= 0
               and int(y_prng.max()) < cfg.A)
    log(json.dumps({"prng": {
        "config": "flagship 20L R64 S256 A256 maxD512 fp32", "batch": MAIN_B,
        "samples": MAIN_T, "seconds": prng_s,
        "khz_per_utt": MAIN_T / prng_s / 1e3,
        "us_per_step_wall": prng_s / MAIN_T * 1e6,
        "k3_us_per_step": k3_ms / CHECK_T * 1e3, "k1_us_per_step": k1_us,
        "launches": prng_launches, "card": card}}))
    log(f"[prng] {MAIN_B} x {MAIN_T} samples in {prng_s:.3f} s = "
        f"{prng_s / MAIN_T * 1e6:.2f} us per step (main path "
        f"{requests[0]['seconds'] / MAIN_T * 1e6:.2f}); K3 "
        f"{k3_ms / CHECK_T * 1e3:.2f} us per step on the card, K1 "
        f"{k1_us:.2f}; output well-formed {prng_ok}")
    if (not prng_ok or not prng_launches[exact_sym["K4"]]
            or prng_launches[exact_sym["K4 first"]]
            or prng_launches[exact_sym["K1 generic"]]):
        fail(f"the prng request did not launch K3 on the staged step (and "
             f"not the first K4 or the generic kernel) or is malformed: "
             f"{prng_launches}")

    # -- phase 14: K4 vs plain, small config ----------------------------------
    mark("phase 14: K4 vs plain, small config")
    mcfg = cfg_lib.TEST_CONFIG_MED
    m_params = params_lib.canonical_to_torch(params_lib.to_canonical(
        params_lib.random_reference_weights(mcfg, seed=11), mcfg), dev)
    rng = np.random.RandomState(1011)
    m_cond = torch.from_numpy((rng.uniform(
        -1, 1, (K4_SMALL_T, mcfg.num_layers, 4, 2 * mcfg.R)) * 0.5).astype(np.float32)
                              ).to(dev)
    m_sel = torch.from_numpy(rng.uniform(0, 1, (K4_SMALL_T, 4)).astype(np.float32)
                             ).to(dev)
    k4_small = check_k4_small(torch, np, persistent, mcfg, m_params, m_cond,
                              m_sel, dev)
    if k4_small["mismatches"] or not k4_small["ok"]:
        fail(f"K4 disagrees with its plain version: {k4_small}")

    # -- phase 15: K4 at the flagship -----------------------------------------
    mark("phase 15: K4 at the flagship")
    k4_flag = check_k4_flagship(torch, np, persistent, cfg, params, cond, sel,
                                dev)
    if (k4_flag["schedule_mismatches"] or k4_flag["k1_mismatches"]
            or k4_flag["forced_mismatches"] or k4_flag["prng_mismatches"]):
        fail("K4 disagrees with K1/K2/K3, or its schedules disagree")
    k4_plainf = check_k4_plain_flagship(torch, persistent, tsg, em, cfg,
                                        params, cond, sel, dev)
    if k4_plainf["mismatches"] or not k4_plainf["ok"]:
        fail(f"K4 disagrees with its plain version at the flagship: "
             f"{k4_plainf}")
    k4_plain = k4_plainf["plain_ms"]["fp32"]

    # -- phase 16: the MANYBLOCK main path at full width ----------------------
    mark("phase 16: the MANYBLOCK main path at full width")
    # the main path's 3 requests again (the same generator seed), through
    # WaveNetInfer(implementation=Impl.MANYBLOCK) in every storage; fp32
    # must give the main path's samples, bf16 and int8 must equal K1 fed
    # their values over request 1's first CHECK_T samples (compared after
    # the counts are read)
    for k in all_kernels:
        k.launches = 0
    manyblock, heads = {}, {}
    for name in STORAGES:
        meng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                            S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                            chunk_size=MAIN_CHUNK, device="cuda",
                            implementation=Impl.MANYBLOCK,
                            **storage_kw(torch, name, engine=True))
        meng.set_reference_weights(ref_w)
        gen_dev.manual_seed(0)
        reqs, mism = [], 0
        for r in range(MAIN_REQUESTS):
            rc = (torch.rand((MAIN_T, L, MAIN_B, 2 * R), generator=gen_dev,
                             device=dev) - 0.5)
            rs = torch.rand((MAIN_T, MAIN_B), generator=gen_dev, device=dev)
            meng.set_inputs(rc, rs)
            del rc
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = meng.run_chunks(MAIN_CHUNK, lambda yc, off, n: None, MAIN_T,
                                MAIN_B)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if not (y.shape == (MAIN_B, MAIN_T) and int(y.min()) >= 0
                    and int(y.max()) < cfg.A):
                fail(f"MANYBLOCK {name} request {r + 1}: malformed output")
            if name == "fp32":
                mism += int((y != main_ys[r]).sum())
            elif r == 0:
                heads[name] = y[:, :CHECK_T]
            reqs.append({"seconds": dt, "khz_per_utt": MAIN_T / dt / 1e3})
        manyblock[name] = {
            "requests": reqs, "mismatches": mism,
            "khz_per_utt": float(np.mean([q["khz_per_utt"] for q in reqs])),
            "k4_us_per_step": k4_flag["k4_ms"][name] / CHECK_T * 1e3,
            "k1_us_per_step": k1_us,
            "plan": plan_dict(torch, persistent, cfg, MAIN_B, name)}
        del meng
    mb_launches = {k.symbol: k.launches for k in all_kernels}
    k1_gen = persistent.make_persistent_generator(cfg, MAIN_B)
    for name, head in heads.items():
        view = storage_view(persistent, params, storage_kw(torch, name))
        cpv = (first[0][:CHECK_T] + view["dil_b"][None, :, None, :]
               ).contiguous()
        y1 = k1_gen(view, 0, cpv, first[1][:CHECK_T].contiguous(), *fresh())
        manyblock[name]["mismatches"] += int(
            (head != y1[0].T.cpu().numpy()).sum())
    for name, mb in manyblock.items():
        log(f"[manyblock] {name}: {MAIN_REQUESTS} requests of {MAIN_B} x "
            f"{MAIN_T} at " + ", ".join(f"{q['khz_per_utt']:.3f}"
                                        for q in mb["requests"])
            + f" kHz per utterance; {mb['mismatches']} mismatches (fp32: "
            f"every sample vs the main path; bf16/int8: request 1's first "
            f"{CHECK_T} vs K1 on the storage's values); K4 "
            f"{mb['k4_us_per_step']:.2f} us per step, K1 {k1_us:.2f}")
        if mb["mismatches"]:
            fail(f"the MANYBLOCK main path ({name}) disagrees with K1")
    log(json.dumps({"manyblock": {
        "config": "flagship 20L R64 S256 A256 maxD512", "batch": MAIN_B,
        "samples_per_request": MAIN_T, "storages": manyblock,
        "launches": mb_launches, "card": card}}))
    stream_sym = exact_sym["K4"]
    if (not mb_launches[stream_sym]
            or mb_launches[exact_sym["K4 first"]]):
        fail(f"the MANYBLOCK path did not run on the staged step alone: "
             f"{mb_launches}")

    # -- phase 17: config 4 ---------------------------------------------------
    mark("phase 17: config 4")
    c4 = check_config4(torch, np, persistent, tsg, cfg_lib, params_lib,
                       WaveNetInfer, Impl, dev, all_kernels)
    if c4["mismatches"]:
        fail("K4 disagrees with K1 at config 4")

    # -- phase 17b: the geometries the staged plan rejects (F2) ---------------
    mark("phase 17b: the geometries the staged plan rejects (F2)")
    f2 = check_fallbacks(torch, np, persistent, tsg, cfg_lib, params_lib,
                         WaveNetInfer, Impl, dev, all_kernels)
    log(json.dumps({"f2": {k: f2[k] for k in ("mismatches", "ring_err", "ok",
                                              "launches", "ms", "plain_ms",
                                              "bound", "runs")},
                    "card": card}))
    if f2["mismatches"] or not f2["ok"]:
        fail(f"the generic K1/K5 or the first K4 disagree at the F2 "
             f"geometries: {f2['runs']}")

    # -- phase 17c: K1 card-wide --------------------------------------------
    mark("phase 17c: K1 card-wide")
    wide = check_wide(torch, np, persistent, cfg_lib, params_lib, tracing,
                      dev, all_kernels)
    log(json.dumps({"wide": wide, "card": card}))
    if wide["mismatches"]:
        fail(f"K1 card-wide disagrees: {wide['runs']}")

    # -- phase 18: score -> feed under MANYBLOCK int8 (fault R9) --------------
    mark("phase 18: score -> feed under MANYBLOCK int8 (fault R9)")
    half = R9_T // 2
    r9 = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                      S=cfg.S, A=cfg.A, max_batch=MAIN_B, device="cuda",
                      implementation=Impl.MANYBLOCK, stream_quant="int8")
    r9.set_reference_weights(ref_w)
    r9.begin_stream(MAIN_B)
    y_head = r9.feed(cond[:half], sel[:half])
    ring_gen = r9.export_state()["ring"]
    y_tail = r9.feed(cond[half:R9_T], sel[half:R9_T])
    r9.begin_stream(MAIN_B)
    r9.score(cond[:half], y_head)
    r9_ring = bit_mismatches(torch, r9.export_state()["ring"], ring_gen)
    r9_mism = int((r9.feed(cond[half:R9_T], sel[half:R9_T]) != y_tail).sum())
    log(f"[R9] MANYBLOCK int8, {MAIN_B} x {R9_T}: score the first half, feed "
        f"the second: {r9_mism} mismatches against one int8 generation; the "
        f"scored ring vs the generated: {r9_ring} bit mismatches")
    if r9_mism or r9_ring:
        fail("the int8 score -> feed handoff is not exact (R9)")

    # -- phase 19: K6 vs plain, small config ----------------------------------
    mark("phase 19: K6 vs plain, small config")
    rng = np.random.RandomState(1019)
    k6_cond = torch.from_numpy((rng.uniform(-1, 1, (
        K6_SMALL_T, mcfg.num_layers, K6_SMALL_B, 2 * mcfg.R)) * 0.5
    ).astype(np.float32)).to(dev)
    k6_sel = torch.from_numpy(rng.uniform(0, 1, (K6_SMALL_T, K6_SMALL_B))
                              .astype(np.float32)).to(dev)
    k6_small = check_k6_small(torch, np, fc, persistent, mcfg, m_params,
                              k6_cond, k6_sel, dev)
    if (not k6_small["ok"] or k6_small["split_mismatches"]
            or k6_small["pack_mismatches"]):
        fail(f"K6 disagrees with its plain version: {k6_small}")

    # -- phase 20: the TV contract on the card --------------------------------
    mark("phase 20: the TV contract on the card")
    k6_tv = check_k6_tv(torch, np, fc, persistent, cfg_lib, params_lib, dev)
    if not k6_tv["ok"]:
        fail(f"K6 breaks the TV contract: {k6_tv}")

    # -- phase 21: K6 at the flagship -----------------------------------------
    mark("phase 21: K6 at the flagship")
    # forced on request 1's first CHECK_T samples against K2 (fp32); each
    # (fast_math, pack_gates) timed over a CHECK_T-step launch beside K1;
    # the latency tier's variant against the plain version over FLAG_PLAIN_T
    k6w = {(f, p): fc.prepare_weights(params, cfg, True, torch.float32, p, f)
           for f in (False, True) for p in (False, True)}
    sym_chk = sym_main[:CHECK_T].contiguous()
    p_k2 = forced_p64(np, gen2(params, 0, cp_chk, sym_chk, *fresh())[3])
    p_k6 = forced_p64(np, fc.make_fused_generator(
        cfg, MAIN_B, "forced", prefold_cond=True)(k6w[False, False], 0, cp_chk,
                                                  sym_chk, *fresh())[3])
    k6_flag_tv = float(tv(np, p_k2, p_k6).max())
    del p_k2, p_k6
    k6_ms, k6_first_ms, k6_bounds = {}, {}, {}
    for (f, p), w in k6w.items():
        gen6 = fc.make_fused_generator(cfg, MAIN_B, fast_math=f,
                                       prefold_cond=True, pack_gates=p)
        if gen6.route.kernel != "cluster":
            fail(f"K6 at the flagship is routed to {gen6.route.kernel}")
        first6 = fc.make_fused_generator(
            cfg, MAIN_B, fast_math=f, prefold_cond=True, pack_gates=p,
            route=fc.FusedRoute("first", fc.fused_plan(cfg, p),
                                "timed beside the cluster K6"))
        name = f"{'fast_math' if f else 'fp32'} pack={p}"
        k6_ms[name] = time_launch_ms(torch, np, lambda r, ys: gen6(
            w, 0, cp_chk, sel_chk, r, ys), fresh)
        k6_first_ms[name] = time_launch_ms(torch, np, lambda r, ys: first6(
            w, 0, cp_chk, sel_chk, r, ys), fresh)
        k6_bounds[name] = k6_bound(cfg, MAIN_B, CHECK_T, f)
    n = FLAG_PLAIN_T
    gen6 = fc.make_fused_generator(cfg, MAIN_B, fast_math=True,
                                   prefold_cond=True)
    (ring_p, ys_p), (ring_k, ys_k) = fresh(), fresh()
    torch.cuda.synchronize()
    t = time.perf_counter()
    y_p = fc.generate_fused_plain(cfg, k6w[True, False], 0, cp_chk[:n],
                                  sel_chk[:n], ring_p, ys_p, n,
                                  fast_math=True)[0]
    torch.cuda.synchronize()
    k6_plain = (time.perf_counter() - t) * 1e3
    y_k = gen6(k6w[True, False], 0, cp_chk[:n].contiguous(),
               sel_chk[:n].contiguous(), ring_k, ys_k)[0]
    torch.cuda.synchronize()
    same = y_k == y_p
    k6_flag = {"forced_max_tv": k6_flag_tv,
               "plain_mismatches": int((~same).sum()),
               "ring_err": float((ring_k - ring_p)[:, same.all(0)].abs().max()),
               "plain_ms": k6_plain, "ms": k6_ms, "first_ms": k6_first_ms,
               "us_per_step": {k: v / CHECK_T * 1e3 for k, v in k6_ms.items()},
               "first_us_per_step": {k: v / CHECK_T * 1e3
                                     for k, v in k6_first_ms.items()},
               "bound": k6_bounds, "plan": {
                   k: str(v) if k == "storage" else v for k, v in
                   fc.cluster_plan(cfg, MAIN_B)._asdict().items()}}
    log(f"[K6 flagship] forced on request 1's first {CHECK_T} samples vs K2: "
        f"max TV {k6_flag_tv:.3g} (limit 5e-4); us per step of a {CHECK_T}"
        f"-step launch: " + ", ".join(
            f"{k} {v:.2f} (first K6 {k6_flag['first_us_per_step'][k]:.2f})"
            for k, v in k6_flag["us_per_step"].items())
        + f" (K1 {k1_us:.2f}); fast_math vs plain over {n} steps: "
        f"{k6_flag['plain_mismatches']}/{n * MAIN_B} mismatches, ring max "
        f"abs err {k6_flag['ring_err']:.3g}, plain {k6_plain:.1f} ms")
    if k6_flag_tv >= 5e-4 or k6_flag["plain_mismatches"] > 0.01 * n * MAIN_B:
        fail(f"K6 disagrees with K2 or its plain version at the flagship: "
             f"{k6_flag}")

    # -- phase 21b: the cluster K6's one-row groups and its model ------------
    mark("phase 21b: the cluster K6's one-row groups and its model")
    k6_one_row = check_k6_one_row(
        torch, np, fc, persistent, tsg,
        (("TEST_CONFIG_MED", mcfg, m_params, K6_ODD_B),
         ("flagship", cfg, params, 1)), all_kernels)
    if not k6_one_row["ok"]:
        fail(f"the cluster K6's one-row groups disagree with the plain "
             f"version: {k6_one_row}")
    k6_model = check_k6_model(torch, np, fc, persistent, tsg, mcfg, m_params,
                              (K6_SMALL_B, K6_ODD_B), all_kernels)
    log(f"[K6 model] {k6_model['runs']} runs, {len(k6_model['unequal'])} "
        f"unequal; the model took {k6_model['model_s']:.1f} s on the CPU")
    if not k6_model["ok"]:
        fail(f"the cluster K6 is not its model bit for bit: "
             f"{k6_model['unequal']}")

    # -- phase 22: the latency-tier main path ---------------------------------
    mark("phase 22: the latency-tier main path")
    # the main path's 3 requests again (the same generator seed) through
    # WaveNetInfer(priority="latency"): K6 with fast_math must carry them
    leng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                        S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                        chunk_size=MAIN_CHUNK, device="cuda",
                        priority="latency")
    leng.set_reference_weights(ref_w)
    gen_dev.manual_seed(0)
    for k in all_kernels:
        k.launches = 0
    lat_reqs, lat_y1 = [], None
    for r in range(MAIN_REQUESTS):
        rc = (torch.rand((MAIN_T, L, MAIN_B, 2 * R), generator=gen_dev,
                         device=dev) - 0.5)
        rs = torch.rand((MAIN_T, MAIN_B), generator=gen_dev, device=dev)
        leng.set_inputs(rc, rs)
        del rc
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = leng.run_chunks(MAIN_CHUNK, lambda yc, off, n: None, MAIN_T,
                            MAIN_B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not (y.shape == (MAIN_B, MAIN_T) and int(y.min()) >= 0
                and int(y.max()) < cfg.A):
            fail(f"latency tier request {r + 1}: malformed output")
        lat_reqs.append({"seconds": dt, "khz_per_utt": MAIN_T / dt / 1e3})
        lat_y1 = y if r == 0 else lat_y1
    lat_launches = {k.symbol: k.launches for k in all_kernels}
    k6_launches = sum(k.launches for k in fc.FUSED_KERNELS.values())
    if (not k6_launches or lat_launches[exact_sym["K1"]]
            or any(k.launches for k in fc.FIRST_FUSED_KERNELS.values())):
        fail(f"the latency tier did not run on the cluster K6 alone: "
             f"{lat_launches}")
    # a dump run on the same engine is the exact kernel's: bit-equal to a
    # default engine's dump run in y and p
    leng.set_inputs(cond, sel)
    ref_eng = flagship_engine()
    ref_eng.set_inputs(cond, sel)
    y_dl = leng.run(CHECK_T, MAIN_B, dump_activations=True)
    y_dr = ref_eng.run(CHECK_T, MAIN_B, dump_activations=True)
    dump_mism = (int((y_dl != y_dr).sum())
                 + bit_mismatches(torch, leng.get_p(), ref_eng.get_p()))
    # lockstep feeds through the same engine: equal to request 1's samples
    leng.begin_stream(MAIN_B)
    feed_ms, fed = [], []
    for i in range(LAT_FEEDS):
        sl = slice(i * LAT_FEED_T, (i + 1) * LAT_FEED_T)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fed.append(leng.feed(cond[sl], sel[sl]))
        feed_ms.append((time.perf_counter() - t) * 1e3)
    feed_mism = int((np.concatenate(fed, 1)
                     != lat_y1[:, :LAT_FEEDS * LAT_FEED_T]).sum())
    f50, f99 = (float(v) for v in np.percentile(feed_ms, [50, 99]))
    latency = {
        "config": "flagship 20L R64 S256 A256 maxD512, fast_math, fp32 "
                  "weights", "batch": MAIN_B, "samples_per_request": MAIN_T,
        "requests": lat_reqs,
        "khz_per_utt": float(np.mean([q["khz_per_utt"] for q in lat_reqs])),
        "khz_per_utt_k1": khz,
        "khz_per_utt_k4_fp32": manyblock["fp32"]["khz_per_utt"],
        "k6_us_per_step": k6_flag["us_per_step"]["fast_math pack=False"],
        "k1_us_per_step": k1_us, "dump_mismatches": dump_mism,
        "feeds": LAT_FEEDS, "feed_samples": LAT_FEED_T,
        "feed_ms_p50": f50, "feed_ms_p99": f99,
        "feed_vs_run_mismatches": feed_mism, "launches": lat_launches,
        "card": card}
    log(json.dumps({"latency_tier": latency}))
    log(f"[latency] {MAIN_REQUESTS} requests of {MAIN_B} x {MAIN_T} at "
        + ", ".join(f"{q['khz_per_utt']:.3f}" for q in lat_reqs)
        + f" kHz per utterance (K1 {khz:.3f}, K4 fp32 "
        f"{manyblock['fp32']['khz_per_utt']:.3f}); {k6_launches} K6 "
        f"launches; dump run vs a default engine's: {dump_mism} mismatches "
        f"(y, p bits); {LAT_FEEDS} feeds of {LAT_FEED_T}: p50 {f50:.2f} ms, "
        f"p99 {f99:.2f} ms, {feed_mism} mismatches against the run")
    if dump_mism or feed_mism:
        fail("the latency tier's dump run is not the exact kernel's, or its "
             "feeds differ from its run")


    # -- phase 22b: the first K6 alone -----------------------------------------
    mark("phase 22b: the first K6 where the cluster plan raises")
    first_k6 = check_first_k6(torch, np, fc, persistent, tsg, cfg_lib,
                              params_lib, dev, all_kernels)
    if not first_k6["ok"]:
        fail(f"the first K6 disagrees with its plain version: {first_k6}")

    # -- phase 23: fast and bf16 against their plain versions, small config --
    mark("phase 23: fast and bf16 vs plain, small config")
    lowp_small = check_lowp_small(
        torch, np, persistent, fc, tsg, mcfg, m_params,
        m_cond[:LOWP_SMALL_T].contiguous(), m_sel[:LOWP_SMALL_T].contiguous(),
        dev)
    log(f"[lowp small] {lowp_small['runs']} runs: {lowp_small['mismatches']}"
        f"/{lowp_small['row_steps']} symbol mismatches, forced TV mean <= "
        f"{lowp_small['tv_mean']:.3g} max <= {lowp_small['tv_max']:.3g}, ring"
        f" max abs err {lowp_small['ring_err']:.3g}; controls (mean, max) "
        + ", ".join(f"{k} ({c['tv_mean']:.3g}, {c['tv_max']:.3g})"
                    for k, c in lowp_small["controls"].items())
        + f"; ok {lowp_small['ok']}")
    if not lowp_small["ok"]:
        fail(f"a fast or bf16 instance disagrees with its plain version: "
             f"{lowp_small}")

    # -- phase 24: fast and bf16, bit for bit ---------------------------------
    mark("phase 24: fast and bf16, bit for bit")
    # K4 against K1, K2, K3 of the same precision; the bf16 scorer against
    # K2-bf16 on request 1's window; a bf16 score -> feed handoff
    lowp_k4 = check_lowp_k4_k1(torch, np, persistent, tsg, cfg, params, cond,
                               sel, dev)
    if lowp_k4["mismatches"]:
        fail(f"K4 disagrees with K1/K2/K3 in fast or bf16: {lowp_k4}")
    bf_kw = prec_kw(torch, "bf16")

    def fresh_bf16():
        return (persistent.init_ring(cfg, MAIN_B, dev, torch.bfloat16),
                fresh()[1])
    beng = flagship_engine(**bf_kw)
    beng.begin_stream(MAIN_B)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    p_bf = beng.score_device(cond, y_tb)
    ev[1].record()
    ring_b, ys_b = fresh_bf16()
    cp_full = (cond + params["dil_b"][None, :, None, :]).contiguous()
    ev[2].record()
    out_b = persistent.make_persistent_generator(
        cfg, MAIN_B, mode="forced", **bf_kw)(params, 0, cp_full, sym_main,
                                              ring_b, ys_b)
    ev[3].record()
    torch.cuda.synchronize()
    del cp_full
    snap = beng.export_state()
    bf_score = {
        "p_bit_mismatches": bit_mismatches(torch, p_bf, out_b[3]),
        "ring_bit_mismatches": bit_mismatches(
            torch, snap["ring"], ring_b.to(torch.float32).cpu()),
        "y_state_equal": bool(np.array_equal(snap["y_state"],
                                             ys_b.cpu().numpy())),
        "ring_dtype": str(beng._ring.dtype),
        "scorer_ms": ev[0].elapsed_time(ev[1]),
        "k2_window_ms": ev[2].elapsed_time(ev[3])}
    del p_bf, out_b
    half = LOWP_SHORT_T // 2
    beng.begin_stream(MAIN_B)
    y_head = beng.feed(cond[:half], sel[:half])
    y_tail = beng.feed(cond[half:LOWP_SHORT_T], sel[half:LOWP_SHORT_T])
    beng.begin_stream(MAIN_B)
    beng.score(cond[:half], y_head)
    bf_score["handoff_mismatches"] = int(
        (beng.feed(cond[half:LOWP_SHORT_T], sel[half:LOWP_SHORT_T])
         != y_tail).sum())
    log(f"[lowp scoring] bf16 scorer vs K2-bf16 over {MAIN_B} x {MAIN_T}: "
        f"p_seq {bf_score['p_bit_mismatches']} bit mismatches, ring "
        f"{bf_score['ring_bit_mismatches']} ({bf_score['ring_dtype']}), "
        f"y_state equal {bf_score['y_state_equal']}; scorer "
        f"{bf_score['scorer_ms']:.2f} ms, K2-bf16 "
        f"{bf_score['k2_window_ms']:.1f} ms; bf16 score -> feed over "
        f"{LOWP_SHORT_T}: {bf_score['handoff_mismatches']} mismatches")
    if (bf_score["p_bit_mismatches"] or bf_score["ring_bit_mismatches"]
            or not bf_score["y_state_equal"]
            or bf_score["handoff_mismatches"]
            or bf_score["ring_dtype"] != "torch.bfloat16"):
        fail(f"the bf16 scorer and K2-bf16 disagree, or the bf16 handoff is "
             f"not exact: {bf_score}")

    # -- phase 25: the main path in bf16 and in fast --------------------------
    mark("phase 25: the main path in bf16 and in fast")
    # the main path's 3 requests (the same generator seed) through
    # WaveNetInfer(compute_dtype=torch.bfloat16) and WaveNetInfer(
    # fast_math=True), then a prng and a forced request of LOWP_SHORT_T on
    # request 1's inputs; counts set to 0 just before, read just after;
    # then one MANYBLOCK request of each precision (its own counts), equal
    # to the main path's request 1 of that precision (K4 == K1)
    lowp_main = {}
    for prec in ("bf16", "fast"):
        kw = prec_kw(torch, prec)
        peng2 = flagship_engine(**kw)
        gen_dev.manual_seed(0)
        for k in all_kernels:
            k.launches = 0
        reqs = []
        for r in range(MAIN_REQUESTS):
            rc = (torch.rand((MAIN_T, L, MAIN_B, 2 * R), generator=gen_dev,
                             device=dev) - 0.5)
            rs = torch.rand((MAIN_T, MAIN_B), generator=gen_dev, device=dev)
            peng2.set_inputs(rc, rs)
            del rc
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = peng2.run_chunks(MAIN_CHUNK, lambda yc, off, n: None, MAIN_T,
                                 MAIN_B)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if not (y.shape == (MAIN_B, MAIN_T) and int(y.min()) >= 0
                    and int(y.max()) < cfg.A):
                fail(f"{prec} request {r + 1}: malformed output")
            reqs.append({"seconds": dt, "khz_per_utt": MAIN_T / dt / 1e3})
            y1 = y if r == 0 else y1
        lw = {k.symbol: k.launches for k in all_kernels}
        n = LOWP_SHORT_T
        peng2.sampling_seed = PRNG_SEED
        peng2.set_inputs(cond[:n], sel[:n])
        for k in all_kernels:
            k.launches = 0
        y_prng = peng2.run_chunks(MAIN_CHUNK, lambda yc, off, n_: None, n,
                                  MAIN_B, mode="prng")
        lw_prng = {k.symbol: k.launches for k in all_kernels}
        peng2.set_inputs(cond[:n], torch.from_numpy(np.ascontiguousarray(
            y1[:, :n].T, np.float32)).to(dev))
        for k in all_kernels:
            k.launches = 0
        y_forced = peng2.run_chunks(MAIN_CHUNK, lambda yc, off, n_: None, n,
                                    MAIN_B, mode="forced")
        lw_forced = {k.symbol: k.launches for k in all_kernels}
        staged = k1_tables["K4"][prec].symbol
        others = (k1_tables["K4 first"][prec].symbol,
                  k1_tables["K1 generic"][prec].symbol)
        if (not lw[k1_tables["K1"][prec].symbol] or lw[exact_sym["K1"]]
                or not lw_prng[staged] or not lw_forced[staged]
                or any(lw_prng[o] or lw_forced[o] for o in others)):
            fail(f"the {prec} main path did not run on K1-{prec} and its "
                 f"forced and prng requests on the staged step (not the "
                 f"first K4 or the generic kernel): {lw}, {lw_prng}, "
                 f"{lw_forced}")
        # request 1's first LOWP_PLAIN_T samples against the plain version
        # of this precision (timed: the plain_ms of K1-{prec})
        cpp = (first[0][:LOWP_PLAIN_T] + params["dil_b"][None, :, None, :]
               ).contiguous()
        st = ((persistent.init_ring(cfg, MAIN_B, dev, tsg.ring_dtype(prec)),
               fresh()[1]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        y_p = persistent.generate_plain(
            cfg, params, 0, cpp, first[1][:LOWP_PLAIN_T].contiguous(), *st,
            LOWP_PLAIN_T, prec=prec)[0]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        plain_mism = int((y_p.T.cpu().numpy() != y1[:, :LOWP_PLAIN_T]).sum())
        # one MANYBLOCK request (request 1's inputs)
        meng = flagship_engine(implementation=Impl.MANYBLOCK, **kw)
        meng.set_inputs(first[0], first[1])
        for k in all_kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        y_mb = meng.run_chunks(MAIN_CHUNK, lambda yc, off, n_: None, MAIN_T,
                               MAIN_B)
        torch.cuda.synchronize()
        mb_s = time.perf_counter() - t
        mbl = {k.symbol: k.launches for k in all_kernels}
        del meng
        if (not mbl[k1_tables["K4"][prec].symbol]
                or mbl[k1_tables["K4 first"][prec].symbol]):
            fail(f"the {prec} MANYBLOCK request did not run on the staged "
                 f"step-{prec} alone: {mbl}")
        lowp_main[prec] = {
            "requests": reqs,
            "khz_per_utt": float(np.mean([q["khz_per_utt"] for q in reqs])),
            "khz_per_utt_exact": khz, "launches": lw,
            "prng_launches": lw_prng, "forced_launches": lw_forced,
            "forced_echo_mismatches": int((y_forced != y1[:, :n]).sum()),
            "prng_well_formed": bool(y_prng.shape == (MAIN_B, n)
                                     and int(y_prng.min()) >= 0
                                     and int(y_prng.max()) < cfg.A),
            "plain_mismatches": plain_mism, "plain_ms": plain_ms,
            "manyblock_khz_per_utt": MAIN_T / mb_s / 1e3,
            "manyblock_vs_k1_mismatches": int((y_mb != y1).sum()),
            "manyblock_launches": mbl}
        m = lowp_main[prec]
        log(f"[lowp main] {prec}: {MAIN_REQUESTS} requests of {MAIN_B} x "
            f"{MAIN_T} at " + ", ".join(f"{q['khz_per_utt']:.3f}"
                                        for q in reqs)
            + f" kHz per utterance (exact K1 {khz:.3f}); forced request "
            f"echoes {m['forced_echo_mismatches']} mismatches, prng well-"
            f"formed {m['prng_well_formed']}; request 1's first "
            f"{LOWP_PLAIN_T} vs plain: {plain_mism}/{LOWP_PLAIN_T * MAIN_B} "
            f"mismatches; MANYBLOCK {m['manyblock_khz_per_utt']:.3f} kHz per "
            f"utterance, {m['manyblock_vs_k1_mismatches']} mismatches vs "
            f"K1-{prec}")
        if (m["forced_echo_mismatches"] or not m["prng_well_formed"]
                or plain_mism > (1 - LOWP_AGREE) * LOWP_PLAIN_T * MAIN_B
                or m["manyblock_vs_k1_mismatches"]):
            fail(f"the {prec} main path is malformed, or disagrees with its "
                 f"plain version or with MANYBLOCK: {m}")
    log(json.dumps({"lowp_main_path": {
        "config": "flagship 20L R64 S256 A256 maxD512", "batch": MAIN_B,
        "samples_per_request": MAIN_T, "precisions": lowp_main,
        "card": card}}))

    # -- phase 26: the latency tier's slot handover, fast and bf16 -----------
    mark("phase 26: the latency tier's slot handover")
    # SERVE's scenario cut to LOWP_SERVE_TICKS ticks through
    # WaveNetInfer(priority="latency") (fast) and with
    # compute_dtype=torch.bfloat16 (bf16): the lockstep ticks on K6, the
    # ragged ticks after slot resets on K5 in that precision; counts set to
    # 0 just before, read just after.  The utterances begun at the partial
    # reset or later (they never ran on K6; some crossed the migration),
    # as far as they were served, replayed lockstep on an engine without
    # fuse_chain in the same precision: 0 mismatches
    handover = {}
    for prec in ("fast", "bf16"):
        kw = {"priority": "latency",
              **({"compute_dtype": torch.bfloat16} if prec == "bf16" else {})}
        gen_h = torch.Generator(device=dev)
        gen_h.manual_seed(3)
        for k in all_kernels:
            k.launches = 0
        _, st_h = serve_scenario(
            torch, np, lambda: flagship_engine(**kw), cfg, dev,
            np.random.RandomState(2025), gen_h,
            **{**SERVE, "ticks": LOWP_SERVE_TICKS})
        hl = {k.symbol: k.launches for k in all_kernels}
        fed = np.array(st_h["feed_ms"])
        late = [served_prefix(u) for u in st_h["live"]
                if u["start"] >= SERVE["full_reset_tick"]
                + SERVE["lockstep_ticks"] and u["pos"] > 0]
        if not late:
            fail(f"the {prec} handover has no row that began after the "
                 f"lockstep ticks")
        mism = replay_lockstep(torch, np,
                               lambda: flagship_engine(**prec_kw(torch, prec)),
                               cfg, dev, late)
        handover[prec] = {
            "ticks": st_h["ticks"], "lockstep_ticks": st_h["lockstep_ticks"],
            "feed_ms_p50": float(np.percentile(fed, 50)),
            "feed_ms_p99": float(np.percentile(fed, 99)),
            "samples_served": st_h["samples_served"],
            "dead_row_step_share": st_h["dead_row_steps"] / st_h["row_steps"],
            "replayed_rows": len(late),
            "replayed_samples": int(sum(u["n"] for u in late)),
            "replay_mismatches": int(sum(mism)),
            "migrated_rows": sum(u["migrated"] for u in late),
            "launches": hl}
        h = handover[prec]
        log(f"[lowp handover] {prec}: {h['ticks']} ticks, feeds p50 "
            f"{h['feed_ms_p50']:.2f} ms p99 {h['feed_ms_p99']:.2f} ms; "
            f"{h['replayed_rows']} rows reset at tick "
            f"{SERVE['partial_tick']} or later ({h['replayed_samples']} "
            f"samples, {h['migrated_rows']} across the migration) replayed "
            f"lockstep: {h['replay_mismatches']} mismatches")
        if (not hl[k1_tables["K5"][prec].symbol]
                or not hl[fc.FUSED_KERNELS[("injected", prec)].symbol]
                or any(hl[k.symbol] for k in fc.FIRST_FUSED_KERNELS.values())
                or hl[exact_sym["K5"]]
                or h["replay_mismatches"] or not h["migrated_rows"]):
            fail(f"the {prec} slot handover did not run on K5-{prec} and K6, "
                 f"or does not replay: {h}")
    log(json.dumps({"latency_handover": {
        "config": "flagship 20L R64 S256 A256 maxD512, priority='latency'",
        "slots": SERVE["B"], "precisions": handover, "card": card}}))

    # -- phase 27: every instance timed at the flagship -----------------------
    mark("phase 27: every instance timed at the flagship")
    # each fast and bf16 instance over a CHECK_T-step flagship launch (K5: the
    # serving phase's 160-step ragged tick) beside its exact instance, in
    # turns, two launches after a warm-up each turn; then each held against
    # its plain version over LOWP_PLAIN_T steps
    sel3 = torch.from_numpy(tsg.prng_uniform_sel(
        PRNG_SEED, np.arange(LOWP_PLAIN_T), MAIN_B)).to(dev)
    lowp_time, lowp_flag = {}, {}
    for prec in ("exact", "fast", "bf16", "exact2"):
        pr = prec.rstrip("2")
        kw = prec_kw(torch, pr)

        def fresh_p():
            return (persistent.init_ring(cfg, MAIN_B, dev,
                                         tsg.ring_dtype(pr)), fresh()[1])
        row = lowp_time.setdefault(pr, {})
        g1, g2, g3 = (persistent.make_persistent_generator(
            cfg, MAIN_B, mode=m, **kw) for m in ("sample", "forced", "prng"))
        g5 = persistent.make_persistent_generator(cfg, MAIN_B, ragged=True,
                                                  **kw)
        tms = {"K1": time_launch_ms(torch, np, lambda r_, y_: g1(
                   params, 0, cp_chk, sel_chk, r_, y_), fresh_p, reps=2),
               "K2": time_launch_ms(torch, np, lambda r_, y_: g2(
                   params, 0, cp_chk, sym_chk, r_, y_), fresh_p, reps=2),
               "K3": time_launch_ms(torch, np, lambda r_, y_: g3(
                   params, 0, cp_chk, sel_chk, r_, y_, seed=PRNG_SEED),
                   fresh_p, reps=2),
               "K5": time_launch_ms(torch, np, lambda r_, y_: g5(
                   params, t0_row, cp_chk[:SERVE["tick_t"]].contiguous(),
                   sel_chk[:SERVE["tick_t"]].contiguous(), r_, y_, nvr),
                   fresh_p, reps=2)}
        for name in ("fp32", "bf16", "int8") if pr == "exact" else (
                "bf16", "int8"):
            g4 = persistent.make_persistent_generator(
                cfg, MAIN_B, stream_weights=True, **storage_kw(torch, name),
                **kw)
            tms[f"K4 {name}"] = time_launch_ms(torch, np, lambda r_, y_: g4(
                params, 0, cp_chk, sel_chk, r_, y_), fresh_p, reps=2)
        w6 = fc.prepare_weights(params, cfg, True, torch.float32, False, **kw)
        g6 = fc.make_fused_generator(cfg, MAIN_B, prefold_cond=True, **kw)
        tms["K6"] = time_launch_ms(torch, np, lambda r_, y_: g6(
            w6, 0, cp_chk, sel_chk, r_, y_), fresh_p, reps=2)
        for k, v in tms.items():
            row.setdefault(k, []).append(v)
        if pr == "exact" or prec == "exact2":
            continue
        # each instance against its plain version of this precision over
        # LOWP_PLAIN_T steps on the same inputs (lowp_compare; K3's plain
        # version fed prng_uniform_sel, K5's the tick's lengths cut to n),
        # the plain run timed (plain_ms); then the control, K2-exact
        # against the forced plain run
        n = LOWP_PLAIN_T
        cp_n, sel_n, sym_n = (t_[:n].contiguous()
                              for t_ in (cp_chk, sel_chk, sym_chk))
        nv_n = torch.from_numpy(np.minimum(lens, n).astype(np.int32))

        def plain_fn(p_, t0=0, s_=sel_n, n_valid=n, mode="sample"):
            return lambda st: persistent.generate_plain(
                cfg, p_, t0, cp_n, s_, *st, n_valid, mode=mode, prec=pr)
        checks = [
            ("K1", "sample", lambda st: g1(params, 0, cp_n, sel_n, *st),
             plain_fn(params)),
            ("K2", "forced", lambda st: g2(params, 0, cp_n, sym_n, *st),
             plain_fn(params, s_=sym_n, mode="forced")),
            ("K3", "prng", lambda st: g3(params, 0, cp_n, sel_n, *st,
                                         seed=PRNG_SEED),
             plain_fn(params, s_=sel3)),
            ("K5", "sample", lambda st: g5(params, t0_row, cp_n, sel_n, *st,
                                           nv_n),
             plain_fn(params, t0=t0_row, n_valid=nv_n))]
        for name in ("bf16", "int8"):
            g4 = persistent.make_persistent_generator(
                cfg, MAIN_B, stream_weights=True, **storage_kw(torch, name),
                **kw)
            checks.append((f"K4 {name}", "sample",
                           lambda st, g4=g4: g4(params, 0, cp_n, sel_n, *st),
                           plain_fn(storage_view(persistent, params,
                                                 storage_kw(torch, name)))))
        checks.append(("K6", "sample",
                       lambda st: g6(w6, 0, cp_n, sel_n, *st),
                       lambda st: fc.generate_fused_plain(
                           cfg, w6, 0, cp_n, sel_n, *st, n, **kw)))
        plain, flag = {}, lowp_flag.setdefault(pr, {})
        for k, mode, kernel, plain_call in checks:
            out_k = kernel(fresh_p())
            st = fresh_p()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out_p = plain_call(st)
            torch.cuda.synchronize()
            plain[k] = (time.perf_counter() - t) * 1e3
            flag[k] = r = lowp_compare(torch, np, out_k, out_p, mode, False)
            log(f"[lowp flagship] {k} {pr}: {n} steps vs plain: y "
                f"{r['mismatches']}/{r['row_steps']} mismatches; ring max "
                f"abs err {r['ring_err']:.3g}; forced TV mean "
                f"{r['tv_mean']:.3g} max {r['tv_max']:.3g}; ok {r['ok']}")
            if k == "K2":
                out_x = persistent.make_persistent_generator(
                    cfg, MAIN_B, mode="forced")(
                        params, 0, cp_n, sym_n,
                        persistent.init_ring(cfg, MAIN_B, dev), fresh()[1])
                flag["control"] = lowp_control(np, pr, "flagship K2",
                                               out_x[-1], out_p[-1])
            del out_k, out_p
        row["plain_ms"] = plain
    us = {pr: {k: float(np.mean(v)) / (SERVE["tick_t"] if k == "K5"
                                        else CHECK_T) * 1e3
               for k, v in row.items() if k != "plain_ms"}
          for pr, row in lowp_time.items()}
    log(json.dumps({"lowp_times_us_per_step": us, "card": card}))
    log(json.dumps({"lowp_flagship_vs_plain": lowp_flag, "card": card}))
    if not all(r["ok"] for f in lowp_flag.values() for r in f.values()):
        fail(f"a fast or bf16 instance disagrees with its plain version at "
             f"the flagship, or a control reads under LOWP_TV: {lowp_flag}")
    for k in us["exact"]:
        log(f"[lowp time] {k}: " + ", ".join(
            f"{pr} {us[pr][k]:.2f}" for pr in ("exact", "fast", "bf16")
            if k in us[pr])
            + " us per step (exact: the mean of the first and last turn)")
    # the staged K1/K5 against their floors in this call: K1 exact no slower
    # than K4 fp32, the 160-step tick within 11.5 ms, each fast and bf16
    # instance within 1.05x its exact one (logged, not held: speed)
    lt = {pr: {k: float(np.mean(v)) for k, v in row.items()
               if k != "plain_ms"} for pr, row in lowp_time.items()}
    floors = {
        "k1_exact_ms": lt["exact"]["K1"], "k4_fp32_ms": lt["exact"]["K4 fp32"],
        "k1_exact_le_k4_fp32": lt["exact"]["K1"] <= lt["exact"]["K4 fp32"],
        "k5_tick_ms": lt["exact"]["K5"],
        "k5_tick_le_11_5_ms": lt["exact"]["K5"] <= 11.5,
        "lowp_over_exact": {f"{k} {pr}": lt[pr][k] / lt["exact"][k]
                            for k in ("K1", "K5") for pr in ("fast", "bf16")}}
    floors["lowp_le_1_05"] = all(v <= 1.05
                                 for v in floors["lowp_over_exact"].values())
    log(json.dumps({"staged_floors": floors, "card": card}))

    # -- phase 28: P1, the FMA-contraction probe -----------------------------
    mark("phase 28: P1, the FMA-contraction probe")
    p1 = check_p1(torch, pem, dev)
    log(json.dumps({"p1": p1, "card": card}))
    for flags in pem.FMA_PROBE_KERNELS:
        r = p1[flags]
        log(f"[P1] plain a*b+c built with -{flags}: {r['separate']}/"
            f"{p1['n']} mismatches vs numpy separate, {r['fma64']} vs the "
            f"fp64 FMA; guarded {r['guarded_separate']} vs separate")
    if (p1["fmad=false"]["separate"] or p1["fmad=false"]["vs_plain_bits"]
            or any(p1[f]["guarded_separate"] for f in pem.FMA_PROBE_KERNELS)):
        fail(f"P1: a form that must not contract did: {p1}")
    if not all(p1["launches"].values()):
        fail(f"P1 did not launch from both builds: {p1['launches']}")
    large = p1["large"]
    if p1["offset_view_bits"] or large["vs_plain_bits"] or large["launches"] != 1:
        fail(f"P1 disagrees with its plain version on an offset view or at "
             f"{large['n']} elements: {p1['offset_view_bits']}, {large}")
    log(f"[P1] by device time ({P1_GRAPH_LAUNCHES} launches in a CUDA "
        f"graph): the plain form {p1['device_ms']:.5f} ms, torch.addcmul "
        f"{p1['library_device_ms']:.5f} ms; by events over back-to-back "
        f"calls {p1['fmad=false']['ms']:.4f} / {p1['library_ms']:.4f} ms; "
        f"at {large['n']} elements {large['device_ms']:.5f} ms against "
        f"torch.addcmul's {large['library_device_ms']:.5f} (bound "
        f"{large['bound_ms']:.5f}, {large['of_bound']:.1%} of it); {card}")
    log(f"[P1] host path per call (us, {P1_HOST_CALLS} calls): "
        + ", ".join(f"{k} {v:.2f}" for k, v in p1["host_path_us"].items()
                    if k != "calls"))

    # -- phase 29: P5 against its plain version -------------------------------
    mark("phase 29: P5 against its plain version")
    p5_held = check_p5_held(torch, ps, dev)
    log(json.dumps({"p5_held": p5_held, "card": card}))
    if (p5_held["exact_bit_mismatches"]
            or p5_held["fast_max_rel_err"] > P5_FAST_TOL):
        fail(f"P5 disagrees with its plain version: {p5_held}")
    if p5_held["launch_faults"]:
        fail(f"P5: a call did not launch its layout's kernel alone: "
             f"{p5_held['launch_faults']}")
    log("[P5] held against chain_plain: " + ", ".join(
        f"{k} {v['cases']} cases, {v['bit_mismatches']} bits, rel "
        f"{v['max_rel_err']:.2e}" for k, v in p5_held["by_layout"].items()))

    # -- phase 30: P5 timed, the per-stage floor ------------------------------
    mark("phase 30: P5 timed, the per-stage floor")
    p5_kernels = {(weights, prec): k for weights, ks in ps.LAYOUT_KERNELS.items()
                  for prec, k in ks.items()}
    for k in p5_kernels.values():
        k.launches = 0
    p5_ns = {label: ps.measure(label, T=P5_TIME_T, iters=2, **kw)
             for label, kw in ps.VARIANTS}
    # the first design's l2 and smem share a counter
    p5_launches = {f"{w} {p}": k.launches for (w, p), k in p5_kernels.items()}
    # clusters the card holds at once: B / rows beyond it run in waves
    p5_waves = {}
    for label, kw in ps.VARIANTS:
        if kw.get("weights") == "cluster":
            B_v, rows_v = kw.get("B", ps.B_DEFAULT), kw.get("rows", 1)
            fit = ps.max_active_clusters(
                B_v, ps.R_DEFAULT, kw.get("D", ps.D_DEFAULT), 1, rows_v,
                kw.get("precision", "exact"), kw.get("gate", True))
            p5_waves[label] = {"clusters": B_v // rows_v,
                               "max_active_clusters": fit}
    floor_label, floor_ns = ps.stage_floor(p5_ns)
    flagship = cfg_lib.FLAGSHIP_CONFIG
    cost = profiling.step_cost(flagship)
    # this run's numbers only (the kernels line): the floors from its stage
    p5_floor = {
        "stage_ns_layout": floor_label, "stage_ns": floor_ns,
        "latency_floor_khz": cost.latency_floor_khz(floor_ns),
        "fused_latency_floor_khz": cost.fused_latency_floor_khz(flagship,
                                                                floor_ns),
        "k1_khz_per_utt": khz, "k1_us_per_step": k1_us,
        "k1_us_per_critical_stage": k1_us / cost.critical_path_matmuls}
    # the committed STAGE_NS and the floor the cost model reads from it
    committed = {"stage_ns": profiling.STAGE_NS,
                 "latency_floor_khz": cost.latency_floor_khz()}
    log(json.dumps({"p5_ns_per_stage": p5_ns, "steps": P5_TIME_T,
                    "launches": p5_launches, "cluster_waves": p5_waves,
                    "floor": p5_floor, "committed": committed,
                    "card": card}))
    if not all(n for n in p5_launches.values()):
        fail(f"P5: a layout's kernel never launched in the sweep: "
             f"{p5_launches}")
    log(f"[P5] profiling.STAGE_NS, the least exact stage at B=16, D=43: "
        f"{floor_ns:.1f} ns ({floor_label}; committed {profiling.STAGE_NS}); "
        f"latency_floor_khz() {committed['latency_floor_khz']:.2f} kHz "
        f"(this run's stage: {p5_floor['latency_floor_khz']:.2f}) "
        f"against K1's {khz:.2f} kHz per utterance in phase 7 "
        f"({p5_floor['k1_us_per_critical_stage']:.3f} us a critical stage); "
        f"{card}")

    # -- phase 31: speculative decode at the flagship -------------------------
    mark("phase 31: speculative decode at the flagship")
    # request 1's inputs through fresh engines: fp32 at b=1 and b=16 over
    # SPEC_T, bf16 weights and MANYBLOCK int8 over SPEC_STORE_T
    cond1, sel1 = first[0][:SPEC_T], first[1][:SPEC_T]
    spec_kernels = (fc.FUSED_KERNELS[("injected", "fast")],
                    om.ORDERED_MATMUL_KERNEL, om.ORDERED_GATE_KERNEL,
                    om.ORDERED_RES_SKIP_KERNEL, em.EXACT_FN_KERNEL,
                    em.SOFTMAX_KERNEL, em.SAMPLE_KERNEL)
    spec_runs = {}
    for label, kw, T_s, window, batches in (
            ("fp32", {}, SPEC_T, SPEC_WINDOW, (1, MAIN_B)),
            ("bf16 weights", dict(weight_dtype=torch.bfloat16), SPEC_STORE_T,
             SPEC_STORE_WINDOW, (1, MAIN_B)),
            ("MANYBLOCK int8", dict(implementation=Impl.MANYBLOCK,
                                    stream_quant="int8"), SPEC_STORE_T,
             SPEC_STORE_WINDOW, (1, MAIN_B))):
        s_eng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation,
                             R=R, S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                             chunk_size=MAIN_CHUNK, device="cuda", **kw)
        s_eng.set_reference_weights(ref_w)
        s_eng.set_inputs(cond1, sel1)
        for B_s in batches:
            spec_runs[f"{label} b={B_s}"] = spec_hold(
                torch, np, s_eng, B_s, T_s, window, spec_kernels,
                all_kernels, label)
        if label == "fp32":
            fit_eng = s_eng
    p_eng = WaveNetInfer(num_layers=L, max_dilation=cfg.max_dilation, R=R,
                         S=cfg.S, A=cfg.A, max_batch=MAIN_B,
                         chunk_size=MAIN_CHUNK, device="cuda")
    p_eng.set_reference_weights(ref_w)
    p_eng.set_inputs(cond1[:SPEC_PERT_T], sel1[:SPEC_PERT_T])
    for B_s in (1, MAIN_B):
        spec_runs[f"wrong draft b={B_s}"] = spec_perturbed_hold(
            torch, np, fc, p_eng, B_s, SPEC_PERT_T, SPEC_PERT_WINDOW,
            SPEC_PERT_OFFSET, SPEC_PERT_COSTS, "wrong draft")
    log(json.dumps({"speculative": spec_runs, "card": card}))

    # -- phase 32: the speculative cost fit -----------------------------------
    mark("phase 32: the speculative cost fit")
    # b=1: a round's time against the window (the mean of SPEC_FIT_REPS
    # runs after a warm-up), least squares V0 + V1 K; E0
    # the exact kernel's time per step (run(), K1, at b=1)
    fit_rows = []
    for K in SPEC_FIT_WINDOWS:
        fit_eng.run_speculative(SPEC_T, 1, window=K, adaptive=False)
        runs = []
        for _ in range(SPEC_FIT_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fit_eng.run_speculative(SPEC_T, 1, window=K, adaptive=False)
            runs.append(time.perf_counter() - t)
        dt = float(np.mean(runs))
        fit_rows.append({"window": K, "rounds": fit_eng.spec_rounds,
                         "round_us": dt / fit_eng.spec_rounds * 1e6,
                         "runs_round_us": [x / fit_eng.spec_rounds * 1e6
                                           for x in runs],
                         "us_per_sample": dt / SPEC_T * 1e6})
    V1, V0 = np.polyfit([r["window"] for r in fit_rows],
                        [r["round_us"] for r in fit_rows], 1)
    E0 = spec_runs["fp32 b=1"]["run_us_per_step"]
    fit = (float(V0), float(V1), float(E0))
    branches = sorted({speculative.choose_branch(SPEC_WINDOW, 64, 256, n,
                                                 fit)
                       for n in range(1, 257)})
    log(json.dumps({"spec_cost_fit": {
        "rows": fit_rows, "V0_us": fit[0], "V1_us": fit[1], "E0_us": fit[2],
        "default_cost": speculative.DEFAULT_COST,
        "branches_over_every_probe_result": branches}, "card": card}))
    log(f"[spec] cost fit (V0_us, V1_us, E0_us) = ({fit[0]:.1f}, "
        f"{fit[1]:.2f}, {fit[2]:.2f}) at the flagship, b=1; the adaptive "
        f"tier's branches over every probe result: {branches}; {card}")

    # -- phase 32b: training at full width ----------------------------------
    mark("phase 32b: training at full width")
    training = check_training(torch, np, all_kernels, persistent, params_lib,
                              om, em, dev, card)
    log("[train] losses " + ", ".join(f"{l:.4f}" for l in training["losses"])
        + f" (first 5 mean {training['loss_first5_mean']:.4f}, last 5 "
        f"{training['loss_last5_mean']:.4f}); the CLI {training['cli_s']:.2f}"
        f" s, its loop's first step at {training['cli_elapsed_s'][0]:.2f} s, "
        f"its last at {training['cli_elapsed_s'][-1]:.2f} s, peak "
        f"{training['cli_peak_memory_bytes'] / 2**30:.2f} GiB")
    for prec in ("highest", "default"):
        r = training[prec]
        log(f"[train] {prec}: {r['ms_per_step']:.2f} ms a step (forward "
            f"{r['forward_ms']:.2f}, backward {r['backward_ms']:.2f}, "
            f"optimizer {r['optimizer_ms']:.2f}), "
            f"{r['audio_samples_per_s'] / 1e6:.3f} M audio samples/s, peak "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; {card}")
    ti = training["train_infer"]
    log(f"[train] train <-> infer over {ti['steps']} steps, B={ti['batch']}: "
        f"score_device max |p - softmax(train logits)| "
        f"{ti['score_max_abs_err']:.3g}, K2 {ti['k2_max_abs_err']:.3g} (tol "
        f"{TRAIN_P_TOL}); score vs K2 {ti['score_vs_k2_bit_mismatches']} bit "
        f"mismatches; tools/inference.py wrote "
        f"{training['inference_cli']['samples']} samples "
        f"({training['inference_cli']['k1_launches']} K1 launches)")
    log(json.dumps({"training": training}))

    # -- phase 32c: the mesh at full width -----------------------------------
    mark("phase 32c: the mesh at full width")
    from nv_wavenet_tpu_torch.parallel import mesh as mesh_lib
    flag = cfg_lib.FLAGSHIP_CONFIG
    mesh_report = check_mesh(
        torch, np, persistent, fc, om, mesh_lib, Impl, WaveNetInfer, flag,
        params_lib.random_reference_weights(flag, seed=1), dev, card)
    log(json.dumps({"mesh": mesh_report}))

    # -- phase 32d: the user's tools on the card -----------------------------
    mark("phase 32d: the user's tools on the card")
    tools_report = check_tools(torch, np, persistent, om, em, all_kernels,
                               dev, card)
    log(json.dumps({"tools": tools_report}, default=str))

    # -- phase 32e: tensor and sequence parallel training -------------------
    mark("phase 32e: tensor and sequence parallel training")
    tp_report = check_train_parallel(torch, np, dev, card)
    log(json.dumps({"train_parallel": tp_report}))
    log_train_parallel(tp_report, card)

    # -- phase 33: the scorer pass traced ------------------------------------
    mark("phase 33: the scorer pass traced")
    split = scorer_ab.scorer_split(
        torch, tracing.trace, *traced_pass, MAIN_B,
        os.path.join(HERE, "build", "traces", "scorer_trace.json"))
    del traced_pass
    log(json.dumps({"scorer_split": split, "card": card}))
    log(f"[scoring] a scorer pass, {split['total_ms']:.2f} ms of device time "
        f"({split['method']}): " + ", ".join(
            f"{g} {v:.2f} ms ({split['shares'][g]:.1%}, "
            f"{split['launches'].get(g, '-')} launches)"
            for g, v in sorted(split["groups_ms"].items())))

    # -- phase 34: the kernels line -------------------------------------------
    mark("phase 34: the kernels line")
    def entry(name, source, replaces, n_launches, mism, err, ms, plain, bnd,
              by, lib, shape, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "mismatches": mism, "max_abs_err": err, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain, "bound_ms": bnd,
                "bound_by": by, "library_ms": lib, "shape": shape, **extra}

    csrc = "nv_wavenet_tpu_torch/csrc/"
    # the speculative path's launches (phase 31: fp32, b=1, fixed): K0b's
    # only path, and a further one of K0a, K0c, K7 and K6-fast
    spec_l = spec_runs["fp32 b=1"]["fixed"]["launches"]

    def spec_n(kernel) -> int:
        return spec_l.get(kernel.symbol, 0)
    spec_on = (f"speculative decode (phase 31: fp32, b=1, {SPEC_T} samples, "
               f"window {SPEC_WINDOW}, fixed)")
    kernels = [
        entry("K0a exact_fn_kernel", csrc + "exact_math_kernels.cu",
              "tools/probe_exact_math_tpu.py:90",
              score_launches[em.EXACT_FN_KERNEL.symbol], k0a["mismatches"],
              k0a["max_abs_err"], k0a_ms, k0a_plain, k0a_bound,
              "+".join(sorted(k0a_by)), k0a_lib,
              f"exp+tanh+sigmoid over [{x.numel()}] f32",
              also_replaces="tools/probe_exact_math_tpu.py:135",
              device_ms=k0a["device_ms"],
              library_device_ms=k0a["torch_device_ms"],
              inlined_in="K1, K2, K3, K5", launches_on="the scoring phase",
              main_path_launches=launches[em.EXACT_FN_KERNEL.symbol],
              speculative_launches=spec_n(em.EXACT_FN_KERNEL)),
        entry("K0b sample_warp_kernel<A/32>", csrc + "exact_math_kernels.cu",
              "tools/probe_exact_math_tpu.py:107",
              spec_n(em.SAMPLE_KERNEL), k0b["mismatches"], 0.0, k0b["ms"],
              k0b["plain_ms"], k0b["bound_ms"], k0b["bound_by"], None,
              "za [%d,%d] f32, sel [%d,1] (every shape and the block "
              "instance: per_shape)" % (*k0b["per_shape"][0]["shape"],
                                        k0b["per_shape"][0]["shape"][0]),
              device_ms=k0b["device_ms"], instance=k0b["instance"],
              per_shape=k0b["per_shape"], turns=k0b["turns"],
              block_instance=em.SAMPLE_BLOCK_KERNEL.symbol,
              inlined_in="K1-K6", launches_on=spec_on,
              main_path_launches=launches[em.SAMPLE_KERNEL.symbol]),
        entry("K1 staged_generate_kernel<false, 2, kStorageF32, kPrecExact, "
              "kGeo>",
              csrc + "staged_generate.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              launches[exact_sym["K1"]],
              plain_mism + k1_mism + h_mism,
              k1_err, k1_ms, k1_plain, k1_bound, k1_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch; "
              f"plain_ms over {FLAG_PLAIN_T} steps",
              serving_launches=serve_launches[exact_sym["K1"]],
              plan=staged_plan_line,
              inference_cli_launches=training["inference_cli"][
                  "k1_launches"]),
        entry("K5 staged_generate_kernel<true, 2, kStorageF32, kPrecExact, "
              "kGeo>",
              csrc + "staged_generate.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              serve_launches[exact_sym["K5"]],
              k5_small_mism + k5_flag_mism + sum(replay_mism), k5_err, k5_ms,
              k5_plain, k5_bound, k5_by, None,
              f"flagship, B={MAIN_B}, one {SERVE['tick_t']}-step ragged tick "
              f"({live} live row-steps); plain_ms over a {FLAG_PLAIN_T}-step "
              f"ragged tick",
              variant="ragged=True (:109-118, 252-256, 302-311, 410-416) "
                      "and rotate_ring_phase (:785)",
              launches_on="the serving phase"),
        entry("K2 staged_generate_kernel<false, 4, kStorageF32, kPrecExact, "
              "1> (mode forced, on K1's stream)",
              csrc + "staged_generate.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              score_launches[exact_sym["K4"]],
              k2_small["echo_mismatches"] + k2_flag["echo_mismatches"]
              + score_cmp["p_bit_mismatches"]
              + score_cmp["ring_bit_mismatches"],
              max(k2_small["p_err"], k2_flag["p_err"]), k2_ms,
              k2_flag["plain_ms"], k2_bound, k2_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch; "
              f"plain_ms over {FLAG_PLAIN_T} steps",
              variant='mode="forced" (:139-146, 387-400, 692-694)',
              launches_on="the scoring phase",
              train_infer_launches=training["train_infer"]["k2_launches"],
              window_ms=k2_window_ms,
              first_ms=k2k3["first_ms"]["K2 exact"],
              vs_first_mismatches=k2k3["mismatches"],
              first="stream_generate_kernel<kStorageF32, kSelForced, "
                    "kPrecExact, false> (csrc/stream_generate.cu, the first "
                    "K4), where staged_plan raises"),
        entry("K3 staged_generate_kernel<false, 4, kStorageF32, kPrecExact, "
              "1> (mode prng, on K1's stream)",
              csrc + "staged_generate.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              prng_launches[exact_sym["K4"]],
              k3_small["mismatches"] + k3_small["chunk_mismatches"]
              + k3_flag["mismatches"], 0.0, k3_ms, k3_flag["plain_ms"],
              k3_bound, k3_by, None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch; "
              f"plain_ms over {FLAG_PLAIN_T} steps",
              variant='mode="prng", prng_uniform_sel (:74-83, 404-405)',
              launches_on="the prng request",
              first_ms=k2k3["first_ms"]["K3 exact"],
              first="stream_generate_kernel<kStorageF32, kSelPrng, "
                    "kPrecExact, false> (csrc/stream_generate.cu, the first "
                    "K4), where staged_plan raises"),
        entry("K4 staged_generate_kernel<false, 4, kStorage, kPrecExact, "
              "kGeo> (K1's instance in modes sample and argmax on fp32 "
              "stacks)",
              csrc + "staged_generate.cu",
              "nv_wavenet_tpu/ops/persistent.py:762",
              mb_launches[stream_sym],
              k4_small["mismatches"] + k4_flag["schedule_mismatches"]
              + k4_flag["k1_mismatches"] + k4_flag["forced_mismatches"]
              + k4_flag["prng_mismatches"] + c4["mismatches"] + r9_mism
              + r9_ring + sum(m["mismatches"] for m in manyblock.values())
              + k4_plainf["mismatches"],
              max(k4_small["ring_err"], k4_small["p_err"],
                  k4_plainf["ring_err"], k4_plainf["p_err"]),
              k4_flag["k4_ms"]["fp32"], k4_plain, *k4_flag["bound"]["fp32"],
              None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch, fp32 "
              f"stacks; plain_ms over {FLAG_PLAIN_T} steps",
              variant="stream_weights (:128-199, 353-361), stream_quant "
                      "(:105-108, 189-197, 434-465, 726-729), weight_dtype "
                      "(:723-725)",
              launches_on="the MANYBLOCK main path (3 storages x "
                          f"{MAIN_REQUESTS} requests)",
              instances=[f"staged_generate_kernel<false, 4, {st}, "
                         f"kPrecExact, {g}>"
                         for st in ("kStorageF32", "kStorageBF16",
                                    "kStorageI8") for g in (0, 1, 2)],
              storages={n: {"ms": k4_flag["k4_ms"][n],
                            "us_per_step": k4_flag["k4_ms"][n] / CHECK_T
                            * 1e3,
                            "bound_ms": k4_flag["bound"][n][0],
                            "bound_by": k4_flag["bound"][n][1],
                            "plain_ms": k4_plainf["plain_ms"][n],
                            "khz_per_utt": manyblock[n]["khz_per_utt"],
                            "plan": manyblock[n]["plan"]}
                        for n in STORAGES},
              schedule_ms=k4_flag["schedule_ms"],
              config4={"batch": C4_B, "steps": C4_TIME_T,
                       "ms": c4["ms"], "bound": c4["bound"],
                       "plan": c4["plan"], "vs_k1": c4["per_case"],
                       "manyblock_khz_per_utt": c4["manyblock_khz_per_utt"],
                       "manyblock_launches": c4["manyblock_launches"]}),
        entry("K6 cluster_chain_kernel<kSel, kPrecFast>", csrc + "fused_chain.cu",
              "nv_wavenet_tpu/ops/fused_chain.py:414", k6_launches,
              k6_small["y_mismatches"] + k6_small["split_mismatches"]
              + k6_small["pack_mismatches"] + dump_mism + feed_mism
              + lowp_flag["fast"]["K6"]["mismatches"],
              max(k6_small["p_err"], k6_small["ring_err"], k6_flag["ring_err"]),
              k6_ms["fast_math pack=False"], k6_flag["plain_ms"],
              *k6_bounds["fast_math pack=False"], None,
              f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch, "
              f"fast_math (the latency tier's variant); plain_ms over "
              f"{FLAG_PLAIN_T} steps",
              launches_on=f"the latency-tier main path ({MAIN_REQUESTS} "
                          f"requests through priority='latency')",
              library="none: no single torch call computes it",
              mismatches_are="sampled symbols against the plain version "
                             "(K6 is TV-governed: >= 99% agreement)",
              instances=[f"cluster_chain_kernel<{sl}, {pr}>"
                         for sl in ("kSelInjected", "kSelForced", "kSelPrng")
                         for pr in ("kPrecExact", "kPrecFast")],
              variants={k: {"ms": v, "us_per_step": v / CHECK_T * 1e3,
                            "first_ms": k6_first_ms[k],
                            "bound_ms": k6_bounds[k][0],
                            "bound_by": k6_bounds[k][1]}
                        for k, v in k6_ms.items()},
              first_ms=k6_first_ms["fast_math pack=False"],
              plan=k6_flag["plan"],
              k1_ms=k1_ms, tv={"flagship_forced_max": k6_flag_tv, **k6_tv},
              khz_per_utt=latency["khz_per_utt"],
              feed_ms_p50=f50, feed_ms_p99=f99,
              speculative_launches=spec_n(
                  fc.FUSED_KERNELS[("injected", "fast")])),
        entry("K0c softmax_p_warp_kernel<A/32>",
              csrc + "exact_math_kernels.cu",
              "none (XLA in nv_wavenet_tpu/ops/score_parallel.py:169; "
              "softmax_canonical, nv_wavenet_tpu/ops/persistent.py:64)",
              score_launches[em.SOFTMAX_KERNEL.symbol], k0c["mismatches"],
              k0c["max_abs_err"], k0c["ms"], k0c["plain_ms"],
              k0c["bound_ms"], k0c["bound_by"], k0c["library_ms"],
              "za [%d,%d] f32 (window and block instance: per_shape)"
              % tuple(K0C_SHAPES[0]), launches_on="the scoring phase",
              library="torch.softmax",
              per_shape=k0c["per_shape"],
              instances={"softmax_p_warp_kernel<NR>": {
                  "takes": "A a multiple of 32, at most 1024",
                  "launches": score_launches[em.SOFTMAX_KERNEL.symbol]},
                  "softmax_p_kernel (block per row)": {
                  "takes": "every other A",
                  "launches": score_launches[em.SOFTMAX_BLOCK_KERNEL.symbol],
                  "held": [r for r in k0c["per_shape"] if r["instance"]
                           == em.SOFTMAX_BLOCK_KERNEL.symbol]}},
              speculative_launches=spec_n(em.SOFTMAX_KERNEL)),
    ]
    # the first K6, where the cluster plan raises (phase 22b)
    f6 = ", ".join(f"{k}={v}" for k, v in FIRST_K6_CFG.items())
    for prec in F2_PRECISIONS:
        kp = {"exact": "kPrecExact", "fast": "kPrecFast",
              "bf16": "kPrecBF16"}[prec]
        kernels.append(entry(
            f"K6-first{'' if prec == 'exact' else '-' + prec} "
            f"fused_generate_kernel<kSel, {kp}>",
            csrc + "fused_chain_first.cu",
            "nv_wavenet_tpu/ops/fused_chain.py:414",
            first_k6["launches"][prec], first_k6["mismatches"],
            first_k6["p_err"], first_k6["ms"][prec],
            first_k6["plain_ms"][prec], *first_k6["bound"][prec], None,
            f"{f6}, B={FIRST_K6_B}, T={FIRST_K6_T} steps",
            launches_on="the geometries the cluster plan rejects (phase "
                        "22b: R not a multiple of 16)",
            library="none: no single torch call computes it",
            **({"flagship_ms": k6_first_ms} if prec == "exact" else {})))
    # K7's three entries: their top-level numbers are the sums over the
    # scorer's shapes at the window (16 x 8192 rows)
    for name, sym_k, ent, lib_name in (
            ("K7 ordered_kernel<..., kProduct> (product)",
             om.ORDERED_MATMUL_KERNEL, "matmul", "torch.matmul"),
            ("K7 ordered_kernel<..., kGate> (gate)", om.ORDERED_GATE_KERNEL,
             "gate", "none: no single torch call computes it"),
            ("K7 ordered_kernel<..., kResSkip> (res/skip)",
             om.ORDERED_RES_SKIP_KERNEL, "res_skip",
             "none: no single torch call computes it")):
        rows_e = [r for r in k7["per_shape"] if r["entry"] == ent]
        win = [r for r in rows_e if r["shape"][0] == K7_WINDOW_M]
        tot = {k: sum(r[k] for r in win) for k in (
            "ms", "plain_ms", "bound_ms", "nofma_floor_ms")}
        kernels.append(entry(
            name, csrc + "ordered_matmul.cu",
            "none (XLA in nv_wavenet_tpu/ops/score_parallel.py:135-139, "
            "150-151, 163-168)",
            score_launches[sym_k.symbol],
            sum(r["mismatches"] for r in rows_e),
            max(r["max_abs_err"] for r in rows_e), tot["ms"],
            tot["plain_ms"], tot["bound_ms"],
            "+".join(sorted({r["bound_by"] for r in win})),
            (sum(r["library_ms"] for r in win) if ent == "matmul" else None),
            "sum over " + ", ".join(
                f"[{r['shape'][0]},{r['shape'][1]}]x[{r['shape'][1]},"
                f"{r['shape'][2] * (2 if ent == 'gate' else 1)}]"
                for r in win) + " f32" + {
                    "gate": " (two halves, zb, tanh*sigmoid)",
                    "res_skip": " (the residual and skip adds)",
                    "matmul": " (out and end: the same shape)"}[ent],
            launches_on="the scoring phase", library=lib_name,
            nofma_floor_ms=tot["nofma_floor_ms"],
            per_shape=rows_e,
            speculative_launches=spec_n(sym_k)))
    # the fast and bf16 instances, each with its launches on its own path
    src_k1 = "nv_wavenet_tpu/ops/persistent.py:762"
    for prec, kp in (("fast", "kPrecFast"), ("bf16", "kPrecBF16")):
        per, tm = lowp_small["per"], lowp_time[prec]
        main_l = lowp_main[prec]["launches"]
        variant = ("fast_math=True (:553, 589-591)" if prec == "fast" else
                   "compute_dtype=jnp.bfloat16 (:550; casts :221-222, "
                   "268-280, 313-347, 367-369)")
        specs = [
            ("K1", "staged_generate.cu",
             f"staged_generate_kernel<false, 2, kStorageBF16, {kp}, kGeo>",
             main_l[k1_tables["K1"][prec].symbol],
             f"the {prec} main path ({MAIN_REQUESTS} requests)",
             lowp_bound(cfg, MAIN_B, CHECK_T, prec),
             f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch",
             lowp_main[prec]["plain_mismatches"]),
            ("K5", "staged_generate.cu",
             f"staged_generate_kernel<true, 2, kStorageBF16, {kp}, kGeo>",
             handover[prec]["launches"][k1_tables["K5"][prec].symbol],
             f"the latency tier's slot handover ({prec}, "
             f"{LOWP_SERVE_TICKS} ticks)",
             lowp_bound(cfg, MAIN_B, SERVE["tick_t"], prec, live=live),
             f"flagship, B={MAIN_B}, one {SERVE['tick_t']}-step ragged "
             f"tick ({live} live row-steps)",
             handover[prec]["replay_mismatches"]),
            ("K2", "staged_generate.cu",
             f"staged_generate_kernel<false, 4, kStorageBF16, {kp}, 1> (mode "
             f"forced, on K1's stream)",
             lowp_main[prec]["forced_launches"][k1_tables["K4"][prec].symbol],
             f"the {prec} forced request ({LOWP_SHORT_T} steps)",
             lowp_bound(cfg, MAIN_B, CHECK_T, prec, mode="forced"),
             f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch",
             lowp_main[prec]["forced_echo_mismatches"] + (
                 bf_score["p_bit_mismatches"]
                 + bf_score["ring_bit_mismatches"] if prec == "bf16" else 0)),
            ("K3", "staged_generate.cu",
             f"staged_generate_kernel<false, 4, kStorageBF16, {kp}, 1> (mode "
             f"prng, on K1's stream)",
             lowp_main[prec]["prng_launches"][k1_tables["K4"][prec].symbol],
             f"the {prec} prng request ({LOWP_SHORT_T} steps)",
             lowp_bound(cfg, MAIN_B, CHECK_T, prec, mode="prng"),
             f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch", 0),
            ("K4", "staged_generate.cu",
             f"staged_generate_kernel<false, 2|4, kStorageBF16|kStorageI8, "
             f"{kp}, kGeo>",
             lowp_main[prec]["manyblock_launches"][
                 k1_tables["K4"][prec].symbol],
             f"one {prec} MANYBLOCK request",
             lowp_bound(cfg, MAIN_B, CHECK_T, prec, storage="bf16"),
             f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch, bf16 "
             f"stacks (fp32 weights stream as bf16 stacks)",
             lowp_k4["mismatches"]
             + lowp_main[prec]["manyblock_vs_k1_mismatches"])]
        if prec == "bf16":
            specs.append((
                "K6", "fused_chain.cu", "cluster_chain_kernel<kSel, kPrecBF16>",
                handover[prec]["launches"][
                    fc.FUSED_KERNELS[("injected", prec)].symbol],
                "the latency tier's slot handover (bf16, lockstep ticks)",
                k6_bound(cfg, MAIN_B, CHECK_T, True, ring_bytes=2),
                f"flagship, B={MAIN_B}, T={CHECK_T} steps per launch", 0))
        for k, source, inst, n_l, on, (bnd, by), shape, more in specs:
            if not n_l:
                fail(f"{k}-{prec} did not launch on {on}")
            sm = per[f"{k} {prec}"]
            key = "K4 bf16" if k == "K4" else k
            # the flagship holds against the plain version (phase 27)
            fl = [lowp_flag[prec][f] for f in (("K4 bf16", "K4 int8")
                                                if k == "K4" else (k,))]
            mism = sm["mismatches"] + more + sum(f["mismatches"] for f in fl)
            kernels.append(entry(
                f"{k}-{prec} {inst}", csrc + source,
                src_k1 if k != "K6" else "nv_wavenet_tpu/ops/fused_chain.py:414",
                n_l, mism, max([sm["ring_err"]] + [f["ring_err"] for f in fl]),
                float(np.mean(tm[key])), tm["plain_ms"][key], bnd, by, None,
                f"{shape}; plain_ms over {LOWP_PLAIN_T} steps",
                variant=variant if k != "K6" else
                "compute_dtype=jnp.bfloat16 (:166-241)",
                launches_on=on, library="none: no single torch call "
                "computes it", exact_ms=float(np.mean(lowp_time["exact"][key])),
                small_config=sm, flagship_vs_plain=fl,
                **({"int8_ms": float(np.mean(tm["K4 int8"])),
                    "int8_plain_ms": tm["plain_ms"]["K4 int8"],
                    "int8_exact_ms": float(np.mean(lowp_time["exact"][
                        "K4 int8"])),
                    "int8_bound": lowp_bound(cfg, MAIN_B, CHECK_T, prec,
                                             storage="int8")}
                   if k == "K4" else {})))
    # the kernels of the geometries the staged plan rejects (phase 17b):
    # the generic K1/K5/K2/K3 and the first K4, each precision, launched
    # there (the generic K2/K3 timed at A=2048, routed at GENERIC_ONLY_CFG)
    a_cfg = ", ".join(f"{k}={v}" for k, v in F2_CASES[0][1].items())
    for prec in F2_PRECISIONS:
        kp = {"exact": "kPrecExact", "fast": "kPrecFast",
              "bf16": "kPrecBF16"}[prec]
        for k, name, inst, shape in (
                ("K1", "K1-generic",
                 f"generic_generate_kernel<false, kSelInjected, {kp}>",
                 f"{a_cfg}, B={F2_B}, T={F2_TIME_T} steps"),
                ("K5", "K5-generic",
                 f"generic_generate_kernel<true, kSelInjected, {kp}>",
                 f"{a_cfg}, B={F2_B}, a {F2_T}-step ragged tick"),
                ("K4 first", "K4-first", f"stream_generate_kernel<kStorage, "
                 f"kSel, {kp}, false>",
                 f"{a_cfg}, B={F2_B}, T={F2_TIME_T} steps, "
                 f"{'fp32' if prec == 'exact' else 'bf16'} stacks"),
                ("K2 generic", "K2-generic",
                 f"generic_generate_kernel<false, kSelForced, {kp}>",
                 f"{a_cfg}, B={F2_B}, T={F2_TIME_T} steps"),
                ("K3 generic", "K3-generic",
                 f"generic_generate_kernel<false, kSelPrng, {kp}>",
                 f"{a_cfg}, B={F2_B}, T={F2_TIME_T} steps")):
            key = f"{k} {prec}"
            n_l = f2["launches"].get(key, 0)
            if not n_l:
                fail(f"{key} did not launch on the F2 path")
            kernels.append(entry(
                f"{name}{'' if prec == 'exact' else '-' + prec} {inst}",
                csrc + ("stream_generate.cu" if k == "K4 first"
                        else "generic_generate.cu"),
                "nv_wavenet_tpu/ops/persistent.py:762", n_l,
                f2["mismatches"], f2["ring_err"], f2["ms"][key],
                f2["plain_ms"][key], *f2["bound"][key], None,
                f"{shape}; plain_ms over {F2_T} steps",
                launches_on="the geometries the staged plan rejects "
                            "(phase 17b: " + ", ".join(
                                c[0] for c in F2_CASES) + ", generic-only)",
                library="none: no single torch call computes it"))
    # the probes: P1 from both builds at the probe's shape and at N_LARGE,
    # P5 in each precision and W layout
    for flags in pem.FMA_PROBE_KERNELS:
        r = p1[flags]
        kernels.append(entry(
            f"P1 fma_probe_kernel (-{flags})", csrc + "probes.cu",
            "tools/probe_exact_math_tpu.py:69", p1["launches"][flags],
            r["guarded_separate"] + (r["separate"] if flags == "fmad=false"
                                     else 0),
            r["max_abs_err"], r["ms"], p1["plain_ms"], p1["bound_ms"],
            p1["bound_by"], p1["library_ms"],
            f"a*b+c over [{p1['n']}] f32 (the plain form timed)",
            launches_on="the probe (phase 28)", library="torch.addcmul",
            device_ms=p1["device_ms"] if flags == "fmad=false" else None,
            library_device_ms=p1["library_device_ms"],
            contracted_vs_separate=r["separate"], vs_fma64=r["fma64"],
            mismatches_are="the guarded form against numpy separate, and "
                           "under -fmad=false the plain form too",
            host_path_us=p1["host_path_us"] if flags == "fmad=false"
            else None))
    large = p1["large"]
    kernels.append(entry(
        f"P1 fma_probe_kernel (-fmad=false), {large['n']} elements",
        csrc + "probes.cu", "tools/probe_exact_math_tpu.py:69",
        large["launches"], large["vs_plain_bits"], large["max_abs_err"],
        large["device_ms"], large["plain_ms"], large["bound_ms"],
        large["bound_by"], large["library_device_ms"],
        f"a*b+c over [{large['n']}] f32, the plain form; ms and library_ms "
        f"by device time ({P1_GRAPH_LAUNCHES} launches in a CUDA graph)",
        launches_on="the probe (phase 28)", library="torch.addcmul",
        of_bound=large["of_bound"],
        mismatches_are="the plain form against the plain version"))
    for prec, weights, label in P5_INSTANCES:
        kw = dict(ps.VARIANTS)[label]
        D_t = kw.get("D", ps.D_DEFAULT)
        ms = p5_ns[label] * P5_TIME_T * D_t / 1e6
        lay = p5_held["by_layout"][f"{weights} {prec}"]
        where = {"l2": "W read from L2 inside the chain, one CTA per row",
                 "smem": "W in shared memory (plain loads), one CTA per row",
                 "stream": "W streamed by TMA through a ring, one CTA per "
                           "row",
                 "cluster": "W resident across a cluster of 8 CTAs per 2 "
                            "rows (one wave), x by st.async"}[weights]
        kernels.append(entry(
            f"P5 {'stage_chain_kernel' if weights in ('l2', 'smem') else 'stage_' + weights + '_kernel'}"
            f" {prec}, W {weights}",
            csrc + "probes.cu", "tools/probe_stage.py:65",
            p5_launches[f"{weights} {prec}"],
            lay["bit_mismatches"] if prec == "exact" else 0,
            p5_held[f"{prec}_max_abs_err"], ms, p5_held["plain_ms"][prec],
            *p5_bound(ps, ps.B_DEFAULT, D_t, P5_TIME_T, prec), None,
            f"B={ps.B_DEFAULT}, R={ps.R_DEFAULT}, D={D_t}, T={P5_TIME_T}, "
            f"gate on, {where}; plain_ms over T={P5_HELD_T}, D={P5_HELD_D} "
            f"at B=16",
            ns_per_stage=p5_ns[label], launches_on="the P5 sweep (phase 30; "
            "the first design's l2 and smem share a counter)",
            max_rel_err=lay["max_rel_err"],
            mismatches_are="exact: bits against the plain version; fast: "
                           "none beyond P5_FAST_TOL (bits_differing)",
            bits_differing=lay["bit_mismatches"],
            library="none: no single torch call computes it",
            waves=p5_waves.get(label),
            sweep_ns_per_stage=p5_ns if label == P5_INSTANCES[0][2] else None,
            floor=p5_floor if label == P5_INSTANCES[0][2] else None))
    print(json.dumps({"kernels": kernels}), flush=True)
    mark("done")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def wide_only() -> int:
    """Phase 17c alone (`python3 chip_smoke.py --wide`): the build, then K1
    card-wide's checks and times."""
    import numpy as np
    import torch
    sys.path.insert(0, HERE)
    from nv_wavenet_tpu_torch import config as cfg_lib
    from nv_wavenet_tpu_torch.models import params as params_lib
    from nv_wavenet_tpu_torch.ops import persistent
    from nv_wavenet_tpu_torch.utils import build, tracing
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    mark("phase 2: build")
    for src, text in build.build_all().items():
        for line in text.splitlines():
            if src.startswith("wide") and ("registers" in line
                                           or "spill" in line
                                           or line.startswith("built in")):
                log(f"[build] {src}: {line.strip()}")
    mark("phase 17c: K1 card-wide")
    kernels = [k for t in (persistent.PERSISTENT_KERNELS,
                           persistent.GENERIC_KERNELS,
                           persistent.WIDE_KERNELS) for k in t.values()]
    wide = check_wide(torch, np, persistent, cfg_lib, params_lib, tracing,
                      torch.device("cuda", 0), kernels)
    log(json.dumps({"wide": wide, "card": card}))
    if wide["mismatches"]:
        fail(f"K1 card-wide disagrees: {wide['runs']}")
    mark("done")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--wide"]:
        sys.exit(wide_only())
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    if sys.argv[1:2] == ["--train-worker"]:
        sys.exit(train_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
