#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stark_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, one or a few lines each (any failure raises and exits non-zero):

 1. the card's name and power limit, as nvidia-smi reports them;
 2. build the CUDA kernels from csrc/ (nvcc, into
    stark_tpu_torch/_build/) and, side by side, the composition kernel K11
    of every AIR driven below, generated from the AIR (ops/compose.py):
    each generated source's sha256 and its nvcc time; nvcc's version (K13
    carries its plan in up to 32 KB of launch parameters, which CUDA 12.1
    and later allow); the registers ptxas gives K12, K13, K9, K15, K10,
    K4-dyn and each AIR's K11; the instruction mix of the hash
    kernels as compiled, where cuobjdump is installed;
 3. every kernel against its plain PyTorch version on the card, bit-equal,
    at every shape the driven paths give it:
    - the NTT and iNTT (K1 -> K3 -> K2), strict and lazy, at n in {2^6,
      2^10, 2^16, 2^17, 2^18, 2^20, 2^22} with batch 1 and 3 (and batch 8,
      the wide path's, at 2^16 and 2^18), and each kernel alone at the
      shapes of the main path (batch 1: iNTT 2^20, NTT 2^22) and of the
      wide path (batch 8: iNTT 2^16, NTT 2^18), with a strict/lazy A/B of
      device time; K1 and K2 alone, strict and lazy, at every n from 2^2
      to 2^22 with batch 1, 3 and 8 and at n = 2^23, the longest transform
      the field has, with batch 1
      (every column length from 2 to 2^12, so every grouping of the
      stages into register rounds and every tile width the launch rule
      gives), each call made twice in a row; K3 alone at the (n1, n2) of
      every such n (its edge route up to n = 8, its vector route from n =
      16 on) and at shapes that are not square, not multiples of its
      tile, or not multiples of 4 on one side or both, each twice;
    - the LDE's zero pad and coset scale (K14) at every (B c, T, N) of the
      paths and pins ((1, 2^20, 2^22), (8, 2^16, 2^18), the batched cells'
      (8, 32 and 64 rows, 2^14, 2^16), ...; T of 1 and 2 on its edge route)
      and at T = N with the offset and its inverse, each call twice; timed
      at the three paths' shapes beside its bound (no library call);
    - the FRI fold (K4) at every half from 2^21 down to 128, and K4-dyn,
      one round of the device chain (each row's root absorbed into its
      sponge, the challenge drawn, the row folded: folded rows, alpha, the
      root copy and the sponge after it held equal, q in {0, 16}, two
      rounds) at (1, half) for the same halves, at (B, half) for B in {1,
      3, 8, 32}, half 2^15 .. 2^7, and at halves 1, 3 and 7; the pair it
      replaced (K9, then the fold with alpha in device memory, built here
      from tools/tune_kernels.py) against the plain version too, then the
      two in turn at (1, 2^21), (32, 2^15) and (8, 2^15) and over a
      Fibonacci T=2^20 prove's 15 rounds, device time and CUDA events;
    - the row hash (K5/K6) for c = 1 at every N from 2 to 2^22 and for c in
      {2, 3, 5, 8} at N in {2, 1024, 2^18, 2^20}, one tree level (K7) at W
      in {2, 2048, 2^17 .. 2^22}, the subtree kernel (K8) at every W from 2
      to 2^16 against its plain level stack and the host C engine, then
      for subtrees of 2^1, 2^4, 2^6, 2^8, 2^9 and 2^10 nodes at the widths
      just below, at and above a launch's two boundaries (one block; the
      widest top the last block takes), and a whole W = 2^22 tree's root
      and 16 opened paths against the host engine;
    - kernel, plain and (K3) library-call times: device time per call from
      torch.profiler, every call on another set of buffers out of at least
      128 MiB of them, so the operands come from device memory and not
      from the 50 MB L2 a repeated call would hit; each kernel's bound
      from its bytes and operations;
    - the SM clock under a hash load, and the instruction rate it gives;
    - the K7/K8 cutover sweep behind hash_batch.TAIL_CUTOVER and the
      subtree-size sweep behind hash_batch.tail_sub_lg;
    - K8 for forests at every per-tree width the batch paths give it, B in
      {8, 32}, and K8 at every W from 2 to 2^16, each at most 1, 4 and 8
      lanes a hash in the narrow levels (forests each call twice), and the
      batch paths' first and last FRI forests against their trees built on
      the host; both kernels' design before the redesign (one lane a hash
      at every level, built here from tools/tune_kernels.py) against the
      plain version too, then timed in turn with the kernel in use (before,
      after, after, before) at (32, 2^11), (8, 2^13) and W = 2^16, with the
      sweep of the most lanes a hash behind hash_batch.TAIL_LANES and the
      latency bound (an empty launch and the levels' hashes one after
      another, _tail_latency_ms);
    - the Fiat-Shamir sponge (K9) for B in {1, 8, 32} lanes at every
      pending length 0 .. 31, two roots absorbed and challenges drawn; its
      design before the redesign (built here from tools/tune_kernels.py)
      against the plain version, then the two timed in turn, and the
      latency bound (an empty launch and the 10 mixes of one thread);
    - the single-fetch prove's kernels: the constraint challenges (K15) at
      (B, challenges) in {(1, 6), (1, 32), (8, 6), (32, 6), (8, 32), (3,
      6), (5, 64)} (the sponge after them, the challenge bytes, K11's
      weight words, the root copy; B = 3 and 5 leave groups of a warp
      idle), the query indices (K10) at the main path's (1, 2^21, 128, 16
      tests, 64 candidates), the wide path's, batch8's and pipe32x2's, at a
      candidate pool too small (the count falls short) and at the largest
      seen-mask, from sponges of pending tails 0, 8, 16 and 24, each call
      twice; K11 fed K15's weights at the main, wide and batched shapes;
      K15 at (1, 6) and K10 at the main shape timed beside their bound,
      their latency bound (an empty launch and the chain of one 8-lane
      group's integer-pipe instructions, counted as K8's split hash is)
      and the one-lane latency bound of the design before; at the start
      of phase 8 (after the profiled paths, whose copies windows need
      the profiler whole), both kernels' designs before their redesign
      (K15's whole chain of raw draws in shared memory, at most 7,264
      challenges; K10 one lane a hash; built here from
      tools/tune_kernels.py) against the plain version at the same shapes
      (K15's up to 7,264), then K15 at (1, 6), (1, 32) and (8, 6) and K10
      at the main shape timed in turn with them (before, after, after,
      before); then K15 past one window of raw draws, at (1, 7266), (5,
      7266) and (3, 2054) against the plain version, each call twice, and
      alone at (1, 7266) beside its latency bound;
    - the composition codeword (K11) against the eager compose, bit-equal,
      each call twice, at every AIR and shape the paths and pins use:
      Fibonacci T=2^20 and MDS T=2^16 at B = 1, the batched cells' (8, .,
      2^16) and (32, ., 2^16), the example AIRs at T=1024 (and Fibonacci
      at 64 and 2^16, MDS at 4096), the 65-register AIR at T=64, and every
      AIR at T=1024 with B = 8 and 32; timed with its bound and the eager
      version's device time at the first three, each also in turn with
      the design before (every sum of the generated body eager; built here
      from tools/tune_kernels.py);
    - the device witnesses (K12): fib_expand at every length the paths and
      the pinned proofs use and at lengths that cut the last block,
      mds_expand at (T, block) up to (2^16, 64) and (2^16, 1) and at blocks
      longer than its staging chunk, each call twice, and the whole witness
      functions against the host traces; fib_expand at start pairs (0, 0),
      (p-1, p-1) and a drawn one besides (1, 1), and its time beside the
      designs it replaced (the host's seeds of each run; an element a
      thread; built here from tools/tune_kernels.py), in turn;
    - the query gather (K13) on a synthetic plan too large for one
      launch's parameters, which goes out in several;
 4. proofs whose sha256 must equal the JAX package's (stark_tpu on the CPU,
    pinned below): FibonacciAir at T=64, 1024 and 2^16, strict and lazy
    NTT; the example AIRs (two-register Fibonacci, square, cube at blowup 8,
    MDS) at T=1024, MDS also at T=4096; each proof verified, and the query
    gather (K13's rule slots) held against its plain version on each
    prove's plan, sources and device indices; then Fibonacci T=2^16 with
    one sampling candidate a proof, twice on one prover (the body eagerly,
    then the slot's graph): the count falls short, the host's indices go
    through the same gather (two K13 launches, two reads a prove), the
    pinned sha256 all the same;
 5. the main path, FibonacciAir at T=2^20, blowup 4, 16 tests (N = 2^22),
    proved from columns made on the card (fibonacci_trace_cols_device, as
    bench.py proves it) on the single-fetch path (the default: a prove
    copies the witness into its slot and replays the slot's CUDA graph,
    captured at the slot's second prove; StarkProver._dispatch): witness
    -> StarkProver.prove(trace_cols=...) -> StarkVerifier.verify with the
    launch counts set to 0 just before and read just after, once on the
    body launched eagerly (StarkProver._eager: K13 held against its plain
    version on that prove's rule plan, the eager compose never run) and
    once on the graph path (the capture and a replay: the same counts,
    every kernel of the path > 0, K14 never, the query gather, K1 of the
    LDE, K15, K10 and the composition kernel exactly once, K9 once and
    K4-dyn once a FRI round but the last), the reads from the card through
    ops.gather.to_host
    (one; three on the same prover with Fri.fused_round False, whose
    proof must be the same), the pinned sha256, which a prove from host
    rows must give too; the
    witness + prove and verify wall-time distributions, with Python's full
    garbage collections (gc.callbacks) that fell inside a prove; the
    synchronised per-phase times (median of 5 proves) and the
    device-to-host copies of one prove from the profiler's memcpy events
    (exactly one), on the graph path (a dispatch phase, which issues the
    copy) and on the eager body (a compose phase, the copy issued in
    fri_query); the single-fetch path and the three reads in turn
    (single-fetch, three, three, single-fetch; 10 synchronised proves a
    turn), their median walls and one profiled prove of each: busy share
    and idle gaps (a record, not a claim); the graph phase: the graph
    path and the eager body in turn (graph, eager, eager, graph; 10
    proves a turn, every proof the pin), one capture a slot, the
    launches inside the graph (counted at capture, equal to one eager
    body's), the capture's time, the replay's device time from CUDA
    events beside the eager body's, the memory the slots hold, and which
    of the graph's kernels torch.profiler shows; K13's rule form timed on
    the prove's plan; on the three-read path the host time of fri_query's
    parts (plan build, table encoding, launch, fetch wait, emission) and
    K13 timed on its plan; one profiled prove of the eager body
    (device time under every launched kernel's name > 0, device
    activities, busy share, the lde phase's device time split into K14
    and K1-K3), the bound of every K8 launch of a prove at
    its own width summed beside the time measured for them, a flipped
    byte and a changed element of the device witness rejected; then the
    same prove with the lazy NTT kernels (counts, sha256, profile), and
    with the device chain off (the host commit path: K4, the same sha256,
    its phases and copies);
 6. the wide path, MdsSquareAir (8 registers) at T=2^16, blowup 4, 16 tests
    (N = 2^18), from mds_square_trace_cols_device (as bench.py's mds_e2e):
    the same, with the sha256 pinned from stark_tpu;
 7. the batched prover at bench.py's three batched cells, T=2^14, blowup
    4, 16 tests: batch8 (prove_batch, B=8), pipe32x2 (prove_many of 64
    traces at B=32, depth 2) and mds_pipe8x2 (MdsSquareAir, prove_many of
    16 device-witness traces at B=8): every proof's sha256 equal to the
    single prove's, verify_batch accepting them and rejecting a flipped
    byte, the reads from the card a call (one a batch; three a batch on
    the three-read path, whose proofs must be the same), prove_many at
    depth 1 and 2 (the same bytes), proofs/s over 20 calls, the
    device-to-host copies of a call (one a batch), the launches of a call
    (K11, K14, K15, K10 and K9 once a batch, K4-dyn once a FRI round but
    the last; the call that captures each slot's graph and replays it), a
    profiled call of the eager body, the two paths in turn (5 calls a
    turn) with a profiled call of each, and the graph phase (5 calls a
    turn, every slot of the cell's ring);
 8. K15 and K10 beside their designs before and K15 past one window
    (phase 3 says what; run before the profiled paths, the long shapes
    and the 3,633-term prove below made the main path's copies window
    lose a memcpy record in every attempt); then the sharded prover (stark_tpu_torch.parallel, driven by
    stark_tpu_torch/tools/dist_prove.py), five worlds of ranks at once,
    each rank a spawned process on the one card (the parent builds every
    library first): an NCCL world of one rank (Fibonacci T=2^20 from the
    device witness, the pinned sha256); D=4 gloo ranks, their exchanges
    through the host (Fibonacci T=2^21, N=2^23, BASELINE config 5: every
    rank's sha256 equal to a single-device card prove of the same witness
    in this run, verified); D=2 gloo ranks (MDS T=2^16, the pinned
    sha256); D=2 gloo ranks at batch8's shape (T=2^14, then
    BatchStarkProver(mesh=) of 8, each proof the single prove's); D=2 gloo
    ranks at T=2^14 on the FRI commit's host path (K4 on exchanged
    halves); all but the last on the single-fetch prove; then the D=4
    world alone on each path in turn (single fetch, three reads with
    ``fused_round`` off, three reads, single fetch).  Per rank: the reads from the
    card of a counted prove (one on the single-fetch path, three on the
    three-read one), its launches (K1-K3, K14, K5-K8, K9, K4-dyn or on
    the host path K4, K11 and K13 each above 0; K15 and K10 once on the
    single-fetch path), the mesh's collectives (three all-to-alls of n/D
    words a transform; the query gather's combine, one all_reduce, and
    its words), the walls of three witness + proves.  Before it (after
    the profiled paths): K14 with a caller's table (the four-step's twiddle
    rows at n = 2^23, D = 4 and n = 2^22, D = 1; an LDE share that pads)
    and K11 on a share with its halo (Fibonacci T=2^21 on D=4, MDS T=2^16
    on D=2) against their plain versions, timed; K13's windowed form (a
    rank's share of the single-fetch plan, zeros where another rank
    serves a request) against its plain version at every world's plan on
    every rank, the ranks' own words summing to the plan's, timed at
    every rank of the Fibonacci T=2^21, D=4 plan;
 9. the API and the command line: a Polynomial product of two 2^15-
    coefficient polynomials on the card (K1-K3 twice each) equal to the
    same product on the CPU; then ``python -m stark_tpu_torch`` as
    subprocesses, four at a time: prove Fibonacci T=2^20 and MDS T=2^16
    (the pinned sha256 above), Fibonacci T=2^16 from the device witness
    and with --host-witness (both stark_tpu's pin), then verify (ACCEPT,
    exit 0), a tampered file (REJECT, exit 1) and inspect; then
    ``python -m stark_tpu_torch bench --quick`` alone (exit 0, a last line
    with bench.py's metric and a positive value, printed); last, an AIR of
    3,633 constraint terms (tests/test_torch_many_terms.py's: 7,266
    challenges, past the 7,264 K15 drew before its window) at T=64 on the
    single-fetch path, its K11 source generated and built in phase 2:
    stark_tpu's sha256, verified, one read, K15 and K11 once.

Then a JSON line of per-kernel results, and as the last line
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
CUDA device is visible.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# The timers that the port's benchmark uses too: CUDA events around
# back-to-back calls behind a sleep kernel, a call cycling through operand
# sets, the quantiles of a run.
from stark_tpu_torch.bench import cycled as _cycled
from stark_tpu_torch.bench import event_ms as _event_ms
from stark_tpu_torch.bench import quantiles as _quantiles

# sha256 of stark_tpu's proof bytes, 16 colinearity tests unless noted
# (derived on the CPU with stark_tpu.StarkProver; CHANGES.md has the
# commands).  Keys: (model, T, blowup, tests).
PINNED = {
    ("fib", 64, 4, 4): "0fbe172505bfeaaefa39b0fe788e0e84c845958ff92fdc1330338bfc4d31335c",
    ("fib", 1024, 4, 16): "db5758edd257e895c25f040e3952b6aaebc8e3c5d25ef1408713b3710d2d5559",
    ("fib", 1 << 16, 4, 16): "aca9d53cda7476d5a8156bd809cd09bd85416b0a96a6b5d15520a0f7b620a118",
    ("fib2", 1024, 4, 16): "8aa084f58d892fecc475421ff3a70b103680b3ba9d6ac8504c7deaf898367411",
    ("square", 1024, 4, 16): "f6ba13984ae58983cbdc11555d66a17c20136ea2a746bdd86221b254aca69084",
    ("cube", 1024, 8, 16): "50c33d4c401ba5bbf71b2139e08aea70001fc0d1254ec111490f150525b7758e",
    ("mds", 1024, 4, 16): "97cf6cf94a41c0df3c285c34e497c315a14e4083e3897632b1d76e39109f61a6",
    ("mds", 4096, 4, 16): "fa5fdeb1274b56feea0a8ddd897be2d02ec6db51eea9b9b692a2e3c445fb6c9a",
}
MAIN_T = 1 << 20
# sha256 of the port's T=2^20 proof (blowup 4, 16 tests).  Not from
# stark_tpu: that run is too large for a CPU.  When pinned it equalled the
# port's plain torch path run on a host CPU, so the card's kernels and the
# plain versions agree on the whole proof; it now guards against drift.
MAIN_SHA256 = "94c49ad8fc8cde1b9eaaadd0e2ad3171a8a62019553baa8dd866cc063b9ea264"
MAIN_RUNS = 40
MDS_T = 1 << 16
# sha256 of stark_tpu's MdsSquareAir proof at T=2^16, blowup 4, 16 tests.
MDS_SHA256 = "4b25adeb89d3400f7ca4e1599086fbf939e7d81e26478d3d06d653e1d08b5a3b"
MDS_RUNS = 20
MDS_BLOCK = 64  # mds_square_trace_cols_device's default, as bench.py proves it
# K12 against its plain version at these (T) and (T, block): the lengths the
# paths and the pinned proofs use, and lengths that cut the last block.
FIB_WITNESS_LENGTHS = (1, 2, 3, 64, 1000, 1024, 1 << 16, MAIN_T)
MDS_WITNESS_SHAPES = ((1, 64), (5, 1), (1000, 7), (1024, 64), (4096, 64),
                      (MDS_T, 1), (MDS_T, MDS_BLOCK), (1000, 130), (300, 300))
# K13 on a plan too large for one launch: requests of each of six kinds.
SPLIT_REQUESTS = 4000
NTT_SIZES = (1 << 6, 1 << 10, 1 << 16, 1 << 17, 1 << 18, 1 << 20, 1 << 22)
WIDE_BATCH = 8  # MdsSquareAir's registers
# (batch, n, inverse) of every transform the two full-width paths run.
PASS_SHAPES = ((1, MAIN_T, True), (1, 4 * MAIN_T, False),
               (WIDE_BATCH, MDS_T, True), (WIDE_BATCH, 4 * MDS_T, False))
FOLD_HALVES = tuple(1 << lg for lg in range(21, 6, -1))
# The batched paths (bench.py's batch8, pipe32x2 and mds_pipe8x2): T=2^14,
# blowup 4, 16 tests, so N = 2^16 and 10 FRI rounds (codewords 2^16 ..
# 2^7, folds to halves 2^15 .. 2^7).
BATCH_T = 1 << 14
BATCH_RUNS = 20
# (name, model, batch, traces a call (0: prove_batch of one batch), depth)
BATCH_CELLS = (("batch8", "fib", 8, 0, 2), ("pipe32x2", "fib", 32, 64, 2),
               ("mds_pipe8x2", "mds", 8, 16, 2))
BATCHES = (8, 32)
BATCH_HALVES = tuple(1 << lg for lg in range(15, 6, -1))
SPONGE_LANES = (1, 8, 32)
# The single-fetch prove's kernels at the paths' shapes.  K15: (B,
# challenges), 2 a constraint term: the main path's Fibonacci (3 terms) and
# the wide path's MdsSquareAir (16) at B = 1, the batched cells' B = 8 and
# 32; then the 3,633-term AIR (7,266) at B = 1 and 5 and two windows and
# three pairs of raw draws (2 x 1,024 + 6, hash_batch.CHALLENGE_WINDOW) at B
# = 3: past the 7,264 of the design before.  K10: (B, size, reduced, tests,
# candidates): the main path (N = 2^22:
# indices mod 2^21, a last codeword of 128), the wide path (N = 2^18), the
# batched cells (N = 2^16), 2 tests + 32 candidates each (fri._SAMPLE_SLACK);
# then candidates too few for 16 distinct indices mod 16 (the count falls
# short), and the largest seen-mask, 2^14 bits.
CHALLENGE_SHAPES = ((1, 6), (1, 32), (8, 6), (32, 6), (8, 32), (3, 6), (5, 64))
# Past one window (in phase 8: run before the profiled paths, these and the
# 3,633-term prove made the main path's copies window lose a memcpy record
# in every attempt).
CHALLENGE_LONG_SHAPES = ((1, 7266), (5, 7266), (3, 2 * 1024 + 6))
# K15 timed in turn with its design before: Fibonacci's, MDS's, batch8's;
# then alone at the 3,633-term AIR's count, beside its latency bound.
CHALLENGE_TIMED = ((1, 6), (1, 32), (8, 6))
CHALLENGE_MANY = (1, 7266)
# The AIR of tests/test_torch_many_terms.py: one register counting up by
# one from MANY_START, MANY_TRANSITIONS transition constraints (its step
# times 1, 2, .., MANY_TRANSITIONS: a distinct linear form each, K11 in
# its table form) and one boundary constraint: 3,633 terms, 7,266
# constraint challenges.  Its proof at T=64, blowup 4, 4 tests; the sha256
# is stark_tpu's (host-drawn challenges; CHANGES.md has the command).
MANY_TRANSITIONS = 3632
MANY_START = 5
MANY_CFG = dict(trace_length=64, blowup=4, num_colinearity_tests=4)
MANY_SHA256 = "2f632b074ddaa6339b87a83fb45ed7e0f9fa501aacedbb1cf1ba551188575e61"
SAMPLE_SHAPES = ((1, 1 << 21, 128, 16, 64), (1, 1 << 17, 128, 16, 64),
                 (8, 1 << 15, 128, 16, 64), (32, 1 << 15, 128, 16, 64),
                 (8, 1 << 15, 16, 16, 20), (4, 1 << 12, 1 << 14, 300, 632))
# Synchronised calls a turn of the single-fetch path against three reads.
TURN_RUNS = {"fib": 10, "mds": 10, "batch": 5}
# K8-forest timed at the batch paths' widest launch (n = 2^16 / B).
FOREST_TIMED = (32, 8)
# Integer-pipe instructions of one combine hash in K8's walk, as csrc/
# hash.cuh writes it (hash.cu's head comment: ~1,800): one lane a hash, 10
# mix rounds of 4.5 a state byte in the kOwed form (sbox shift and bit
# select 2, group XOR 1.5, the diffusion's add 1) and 64 absorbed bytes of
# 5; over L lanes, a lane's share: 32 / L bytes of each mix round, and
# each absorbed byte 5 times (the 5 waves of split_absorb).
INT_PIPE_HASH = 10 * 144 + 64 * 5
INT_PIPE_SPLIT_BYTE = 10 * 4.5 + 2 * 5 * 5
# The sponge chains of K15 and K10 over 8 lanes (csrc/hash.cuh's sponge over
# 8 lanes), counted the same way: a lane's integer-pipe instructions, 2
# clocks each, shuffles left out: a mix round 4.5 a state byte of its 4; a
# wave of a chunk's split absorb 5 a byte of its 4; a short absorb (a
# draw's 8 bytes, a candidate's 4) 5 a byte absorbed, every lane computing
# them all.
INT_PIPE_SPLIT_MIX = 4.5 * 4
INT_PIPE_SPLIT_WAVE = 5 * 4
INT_PIPE_SHORT_BYTE = 5
# K11 against its plain version at every (model, T, blowup, B) the driven
# paths and the pinned proofs give it (the segment AIR's: fib20.segments'
# batch of 4 at T=2^20, and the tests' T=64), each proof with a row of
# boundary values of its own; the first three also timed.
COMPOSE_CASES = (("fib", MAIN_T, 4, 1), ("mds", MDS_T, 4, 1), ("fib", BATCH_T, 4, 8),
                 ("fib", BATCH_T, 4, 32), ("mds", BATCH_T, 4, 8), ("fib", 64, 4, 1),
                 ("fib", 1024, 4, 1), ("fib", 1 << 16, 4, 1), ("fib2", 1024, 4, 1),
                 ("square", 1024, 4, 1), ("cube", 1024, 8, 1), ("mds", 1024, 4, 1),
                 ("mds", 4096, 4, 1), ("wide", 64, 4, 1)) + tuple(
    (model, 1024, 8 if model == "cube" else 4, b)
    for model in ("fib", "fib2", "square", "cube", "mds", "wide") for b in (8, 32)) + (
    ("fib_segment", MAIN_T, 4, 4), ("fib_segment", 64, 4, 1), ("fib_segment", 64, 4, 8))
COMPOSE_TIMED = 3
# K11's table form (an AIR past ops/compose.TABLE_LINES) at the shapes
# tools/tune_kernels.py times it, (model, T, B) at blowup 4: the paths' AIRs
# forced into it (Fibonacci T=2^20, MDS T=2^16, batch8's), then the
# distinct counter (tools/tune_kernels.distinct_air) at 1,024 and 3,632
# constraints, then the segment AIR at fib20.segments' batch; each in turn
# with the table form before its redesign.
TABLE_CASES = (("fib", MAIN_T, 1), ("mds", MDS_T, 1), ("fib", BATCH_T, 8),
               ("distinct1024", 1 << 16, 1), ("distinct3632", 1 << 16, 1),
               ("fib_segment", MAIN_T, 4))
# K14 against its plain version at every (rows, T, N) the driven paths and
# the pinned proofs give it (rows = B c: the main path, the wide path, the
# three batched cells; the pins; T of 1 and 2, its edge route), then at T = N
# (coset_eval's and coset_interp's case) with the offset and its inverse;
# timed at the first three, the JSON line keeping the main path's.
PAD_SCALE_SHAPES = ((1, MAIN_T, 4 * MAIN_T), (WIDE_BATCH, MDS_T, 4 * MDS_T),
                    (8, BATCH_T, 4 * BATCH_T), (32, BATCH_T, 4 * BATCH_T),
                    (8 * WIDE_BATCH, BATCH_T, 4 * BATCH_T), (1, 64, 256),
                    (1, 1024, 4096), (2, 1024, 4096), (1, 1024, 8192),
                    (WIDE_BATCH, 1024, 4096), (WIDE_BATCH, 4096, 4 * 4096),
                    (1, 1 << 16, 1 << 18), (3, 1, 4), (3, 2, 8))
PAD_SCALE_SQUARE = ((1, 4 * MAIN_T), (WIDE_BATCH, 4 * MDS_T), (3, 1 << 10))
PAD_SCALE_TIMED = 3
# K1 of an LDE (the pad and coset scale in pass 1's first round; the LDE of
# a prove or batch) against its plain version at every (B c, T, N) of
# PAD_SCALE_SHAPES, then at T < n2, blowups 1, 2 and 8-32, T of 1 and 2,
# and a batch entry of 2^22 coefficients; timed at the first three of
# PAD_SCALE_SHAPES, in turn with K14 then K1 (the design before).
LDE_ODD_SHAPES = ((3, 4, 64), (2, 16, 1024), (1, 1, 4), (3, 2, 8), (3, 1, 32),
                  (2, 1 << 10, 1 << 10), (3, 1 << 12, 1 << 13), (5, 1 << 11, 1 << 15),
                  (2, 1 << 9, 1 << 14), (1, 1 << 22, 1 << 22))
# The distributed phase (parallel/): BASELINE config 5, the largest provable
# instance (T=2^21, N=2^23, the field's 2-adicity cap) on D=4 gloo ranks
# that share the card; MDS T=2^16 and batch8's shape on D=2; Fibonacci
# T=2^20 in an NCCL world of one rank.
DIST_T = 1 << 21
DIST_D = 4
DIST_MDS_D = 2
DIST_RUNS = 3
#: Proves a turn of the NCCL world of one, graph and eager body in turn.
DIST_TURN_RUNS = 10
# K14 with the four-step's twiddle table at its (C/D, R) rows: (n, D).
SCALE_TABLE_CASES = ((1 << 23, DIST_D), (1 << 22, 1))
# K11 on the sharded paths' shares with their halos: (model, T, blowup, D);
# the segment AIR's last share holds its end pair's rows.
HALO_CASES = (("fib", DIST_T, 4, DIST_D), ("mds", MDS_T, 4, DIST_MDS_D),
              ("fib_segment", MAIN_T, 4, DIST_D))
# K13's windowed form (a rank's share of the single-fetch plan) at every
# distributed world's plan, (model, T, D): every rank held against the
# plain version, the first (Fibonacci T=2^21 on D=4: cut and whole rounds)
# timed at every rank.
WINDOW_CASES = (("fib", DIST_T, DIST_D), ("mds", MDS_T, DIST_MDS_D), ("fib", MAIN_T, 1),
                ("fib", BATCH_T, DIST_MDS_D))
# The Polynomial product driven on the card: two polynomials of this many
# coefficients (the NTT path above the 64-coefficient crossover, n = 2^16).
POLY_COEFFS = 1 << 15
# The command line driven as subprocesses: (name, prove arguments, pinned
# sha256); the last two prove the same proof from the device witness and
# from host rows.
CLI_T_SMALL = 1 << 16
WIDE_REGISTERS = 65  # tests/test_torch_wide.py's AIR
HASH_WIDTHS = (2, 3, 5, 8)
HASH_LANES = (2, 1024, 1 << 18, 1 << 20)
LEAF_LANES = tuple(1 << lg for lg in range(1, 23))
LEVEL_WIDTHS = (2, 2048) + tuple(1 << lg for lg in range(17, 23))
TAIL_WIDTHS = tuple(1 << lg for lg in range(1, 17))
# log2 of K8's subtree sizes that are held against the plain version, each
# at lg W = lg_sub - 1, lg_sub, lg_sub + 1 (one block or several) and
# lg_sub + 9, + 10, + 11 (the last block's top at its widest, and one
# launch more), as far as they lie in 1..TAIL_MAX_LG_W.
TAIL_SUBTREES = (1, 4, 6, 8, 9, 10)
TAIL_MAX_LG_W = 20
PASS_LGS = tuple(range(2, 23))  # K1/K2 alone: n = 2^lg, batch 1, 3, 8
PASS_LGS_LONG = (23,)  # and batch 1 only: columns of 2^12 rows, the field's longest
# K3 alone, (batch, rows, cols): both routes (16-byte accesses need rows and
# cols that are multiples of 4), around the vector route's 32 x 128 tile.
TRANSPOSE_SHAPES = (
    (1, 2, 2), (3, 2, 4), (8, 4, 2), (1, 4, 4), (3, 4, 4), (8, 4, 4),
    (3, 96, 40), (3, 97, 40), (3, 96, 41), (1, 33, 129), (2, 36, 132),
    (8, 32, 128), (1, 28, 124), (1, 4, 2048), (1, 2048, 4), (3, 8, 260),
    (8, 1, 7), (2, 100, 100), (1, 1024, 4096), (3, 4096, 512),
)
# A timed call takes the next of so many sets of buffers that this many
# bytes pass between two uses of one set: more than twice the card's 50 MB
# L2, so every timed call reads its operands from device memory.
CYCLE_BYTES = 128 << 20

# The card's published peaks (H100 SXM at its full 700 W limit): device
# memory 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores, which is
# one fused multiply-add per lane per clock on 128 lanes per SM.  Integer
# instructions go through those same lanes, at most one per lane per
# clock, so the peak for integer operations is half the float32 figure.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2

# Integer operations, as the kernels' sources write them: the fewest known
# for each function, so that no kernel can be faster than its bound.  A
# butterfly is add 3 + sub 3 + Shoup 5 (lazy 3 + 2 + 3), whether its stage
# runs out of shared memory or in a register round.  The hash as
# csrc/hash.cuh writes it since the masks went and the state stays scaled
# between mix rounds spends 6.5 per state byte and mix round (sbox:
# multiply-add, shift, bit select; group XOR 1.5; the diffusion's two
# multiply-adds) and 5 per absorbed byte (add, two shifts, bit select,
# XOR).  Until then the count was 9 per byte and round (sbox 5: multiply, mask, rotate 2, XOR;
# group XOR 1; sum 1; round constant 2), OPS_MIX_BEFORE: the bounds on
# that count are printed beside the new ones, so that times from before
# and after can be read on one yardstick.
OPS_BUTTERFLY = {False: 11, True: 8}
OPS_MONT = 8                          # the REDC of pass 1, per element
OPS_FOLD = 25                         # two Shoup, one REDC, sub, two adds
OPS_ABSORB_BYTE = 5                   # add, two shifts, bit select, xor
OPS_MIX = 208                         # 6.5 per state byte
OPS_MIX_BEFORE = 9 * 32
# K12.  A Montgomery product is 7 (multiply low, multiply high, multiply by
# -p^-1, multiply high, add, carry, add-and-minimum), a Shoup product 4, an
# addition mod p 2.  fib_expand: two products and an addition an element,
# and a row's seeds from the basis (four products and two additions) over
# a thread's 8 columns of the row.
# mds_expand per step as csrc/witness.cu now computes it: 64 wide
# multiply-adds (the lazy 64-bit row sums), and per row one reduction by
# the constant p (multiply by -p^-1, multiply high, carry, add, two
# add-and-minimums: 6), one Montgomery square and an addition mod p.  Until
# then it was 64 Shoup products, 64 additions and 8 squares of two
# Montgomery products, OPS_MDS_STEP_BEFORE: its bound is printed beside.
OPS_FIB_EXPAND = 2 * 7 + 2 + (4 * 7 + 2 * 2) / 8  # (3 * 7 + 2 before its redesign)
OPS_MDS_STEP = 64 + 8 * (6 + 7 + 2)
OPS_MDS_STEP_BEFORE = 64 * 4 + 64 * 2 + 8 * 2 * 7
# K4-dyn: K4's count, the Shoup product by alpha a Montgomery one (7).
OPS_FOLD_DYN = OPS_FOLD - 4 + 7
# K14: a Shoup product an element below T (multiply low, multiply high,
# multiply, subtract, add-and-minimum); the zeros above T take none.
OPS_SHOUP = 5


#: The designs before each redesign (tools/tune_kernels.py), built in the
#: build step: sponge, fib_expand, fib_expand_seeds, forest, fold_dyn (the K9 + fold pair),
#: challenges (K15), sample (K10), floor (an empty kernel) and compose by
#: (model, T).
BEFORE: dict = {}
#: ptxas -v of the port's kernels, {kernel: "N regs, ..."}, read in the
#: build step.
PTXAS: dict = {}


def _hash_ops(length: int, mix_ops: int = OPS_MIX) -> int:
    """Operations of one hash of ``length`` bytes: the absorbs, a mix per
    32-byte chunk and the 8 closing mixes."""
    return OPS_ABSORB_BYTE * length + mix_ops * (-(-length // 32) + 8)


def _tail_latency_ms(lg_w: int, lg_tree: int, lanes: int, clock_mhz: float,
                     launch_ms: float) -> float:
    """K8's latency bound for 2^lg_w nodes in trees of 2^lg_tree at most
    ``lanes`` lanes a hash: for each launch an empty launch, then its
    levels one after another (the subtrees' blocks side by side, then the
    top's block), each level a hash's integer-pipe instructions at its
    lanes (INT_PIPE_*), a warp's instruction every 2 clocks, times the
    warps each of the SM's 4 schedulers runs at that level.  Shuffle
    latency and the ticket are not in it."""
    from stark_tpu_torch.ops import hash_batch as HB

    clocks = 0.0
    launches = 0
    for threads, sub_l, top_l in HB.tail_plan(lg_w, None, lg_tree, lanes):
        launches += 1
        for levels in (sub_l, top_l):
            for k, ell in enumerate(levels, 1):
                count = 1 << (len(levels) - k)
                rounds = -(-count // threads) if ell == 1 else 1
                warps = -(-min(count * ell, threads) // 32)
                per = (INT_PIPE_HASH if ell == 1 else INT_PIPE_SPLIT_BYTE * 32 / ell)
                clocks += rounds * -(-warps // 4) * per * 2
    return launches * launch_ms + clocks / (clock_mhz * 1e3)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least time in ms, which of the two sets it)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _profile(fn, reps: int, skip: tuple = ()):
    """torch.profiler's kernel-level events of ``reps`` calls of ``fn``
    (after one warm-up call), without those whose name holds one of
    ``skip``.  The tracer can lose the first kernel launched in a window
    (seen here: one launch short in every window of the cutover sweep,
    exactly the first), so each window opens with a launch that is not
    counted: an erfinv, which nothing timed here uses."""
    fn()
    first = torch.zeros(8, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PAD_LAUNCHES):
            first.erfinv_()
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        for _ in range(PAD_LAUNCHES):
            first.erfinv_()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not any(k in e.key for k in ("erfinv",) + skip)]


def _device_us(event) -> float:
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total  # torch releases before the rename


PROFILE_ATTEMPTS = 8  # a window has come back short three times in a row
PAD_LAUNCHES = 4
_retaken = [0]  # profiles taken again, reported at the end of the run
_event_timed: list[str] = []  # what _device_ms timed with events instead


def _flushed_event_ms(flush, call, reps: int) -> float:
    """Device time per call of ``call`` from a pair of CUDA events around
    each of ``reps`` calls, each after a ``flush`` that the pair leaves
    out; all enqueued while a sleep kernel holds the stream, so that no
    host time lies inside a pair."""
    call()
    torch.cuda.synchronize()
    pairs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
             for _ in range(reps)]
    torch.cuda._sleep(40_000_000)  # ~20 ms at 1980 MHz
    for start, end in pairs:
        flush()
        start.record()
        call()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def _device_ms(fn, reps: int, skip: tuple = (), events=None) -> float:
    """Device time per call of ``fn``: every kernel and copy it runs but
    those named in ``skip`` (see _profile).  The
    tracer now and then drops a window, or part of one: a profile without
    device activity, or in which some activity does not occur once or more
    for each of the ``reps`` equal calls, is taken again,
    ``PROFILE_ATTEMPTS`` times at most; then the calls are timed with CUDA
    events (``events()`` where ``skip`` leaves a flush out)."""
    held = []
    for _ in range(PROFILE_ATTEMPTS):
        profiled = _profile(fn, reps, skip)
        total = sum(_device_us(e) for e in profiled)
        if total > 0 and all(e.count % reps == 0 for e in profiled):
            return total / 1e3 / reps
        _retaken[0] += 1
        seen = {e.key[:40]: e.count for e in profiled}
        print(f"profile of {reps} calls taken again; it held {seen}", flush=True)
        held.append(seen)
        if len(held) >= 3 and held[-1] == held[-2] == held[-3]:
            break  # the same window three times: no use in a fourth
    if skip and events is None:  # the flush's kernel would count
        raise AssertionError("torch.profiler recorded no complete window")
    seen = ", ".join(sorted({e.key[:40] for e in profiled})) or "nothing"
    _event_timed.append(seen)
    print(f"profile of {reps} calls: no complete window in {PROFILE_ATTEMPTS}; timed "
          f"with CUDA events instead ({seen})", flush=True)
    return _event_ms(fn, reps) if events is None else events()


def _copies(nbytes: float) -> int:
    """Sets of buffers of ``nbytes`` each that a timed loop walks through."""
    return -(-CYCLE_BYTES // int(nbytes)) + 1


def _clones(count: int, *tensors) -> list[tuple]:
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(count - 1)]


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.long() - want.long()).abs().max())


def _require_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: max |err| {_max_abs_err(got, want)}")


def _sass_mix(library_path: str) -> None:
    """Print the instruction count of each hash kernel as compiled (static:
    the closing mixes are a rolled loop), where cuobjdump is installed."""
    tool = shutil.which("cuobjdump") or shutil.which(
        "cuobjdump", path="/usr/local/cuda/bin")
    if tool is None:
        print("sass: cuobjdump not installed, instruction mix not read", flush=True)
        return
    sass = subprocess.run([tool, "-sass", library_path], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = found.group(1)
            continue
        found = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d\s+)?([A-Z][A-Z0-9_]*)", line)
        if found and current in ("stark_hash_rows_kernel",
                                 "stark_merkle_level_kernel",
                                 "stark_merkle_tail_kernel",
                                 "stark_constraint_challenges_kernel",
                                 "stark_sample_indices_kernel"):
            ops = counts.setdefault(current, {})
            ops[found.group(1)] = ops.get(found.group(1), 0) + 1
    for name, ops in counts.items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
        # A shuffle the compiler could not prove convergent gets a
        # warp-synchronous fallback (WARPSYNC): the split hashes have none.
        print(f"sass {name}: {sum(ops.values())} instructions, "
              + ", ".join(f"{k} {v}" for k, v in top)
              + f"; WARPSYNC {ops.get('WARPSYNC', 0)}, SHFL {ops.get('SHFL', 0)}", flush=True)


def _rand_field(rng, dev, shape) -> torch.Tensor:
    """Seeded field values in [0, p) as the port stores them (int32)."""
    vals = rng.integers(0, 998244353, size=shape, dtype=np.int64)
    return torch.from_numpy(vals).to(torch.int32).to(dev)


class _Results:
    """The per-kernel entries of the final JSON line."""

    def __init__(self):
        self.entries: list[dict] = []

    def add(self, kernel, shape, args_list, fn, plain_fn, reps, nbytes, ops,
            library_fn=None, flush=None, checked=None) -> dict:
        """Hold ``fn`` against ``plain_fn`` on the first set of
        ``args_list``, then time each over all the sets in turn.  ``flush``:
        a call made before each timed one, whose device time is not counted
        (_L2Flush), for operands that cannot be cycled.  ``checked``: the
        (kernel, plain) results of a comparison made by the caller, for a
        kernel that updates its operands in place."""
        got, want = checked or (fn(*args_list[0]), plain_fn(*args_list[0]))
        _require_equal(f"{kernel.name} at {shape}", got, want)
        # Read now: the timed calls below may write into ``got`` again.
        max_err = _max_abs_err(got, want)
        bound_ms, bound_by = _bound(nbytes, ops)

        def timed(f, reps):
            call = _cycled(f, args_list)
            if flush is None:
                return _device_ms(call, reps)
            return _device_ms(lambda: (flush(), call()), reps, skip=flush.skip,
                              events=lambda: _flushed_event_ms(flush, call, reps))

        ms = timed(fn, reps)
        for _ in range(2):
            if ms >= bound_ms:
                break
            # Under the least time the card could take: a profile that lost
            # part of its window and still held a multiple of the calls.
            print(f"{kernel.name} at {shape}: {ms:.4f} ms is under its bound "
                  f"{bound_ms:.4f}; timed again", flush=True)
            _retaken[0] += 1
            ms = timed(fn, reps)
        if ms < bound_ms:
            raise AssertionError(f"{kernel.name} at {shape}: {ms} ms under its bound")
        entry = {
            "name": kernel.name,
            "route": "cuda",
            "source": kernel.source,
            "replaces": kernel.replaces,
            "shape": shape,
            "launches": 0,
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": timed(plain_fn, max(reps // 10, 3)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if library_fn is None else timed(library_fn, reps),
            "buffer_sets": len(args_list),
        }
        self.entries.append(entry)
        return entry


def _line(entry: dict) -> str:
    lib = "" if entry["library_ms"] is None else f", library {entry['library_ms']:.4f}"
    return (f"{entry['name']} {entry['ms']:.4f} ms (plain {entry['plain_ms']:.4f}, "
            f"bound {entry['bound_ms']:.4f} by {entry['bound_by']}{lib})")


def _check_ntt(rng, dev, results: _Results) -> None:
    from stark_tpu_torch.ops import ntt_fused as NTF

    def rand(shape):
        return _rand_field(rng, dev, shape)

    whole = [(n, b) for n in NTT_SIZES for b in (1, 3)]
    whole += [(n, b) for b, n, _ in PASS_SHAPES if (n, b) not in whole]
    for n, batch in whole:
        for inverse in (False, True):
            x = rand((batch, n) if batch > 1 else (n,))
            want = NTF.ntt_plain(x, inverse)
            what = f"NTT n={n} batch={batch} inverse={inverse}"
            _require_equal(what, NTF.fused_ntt(x, inverse), want)
            _require_equal(what + " lazy", NTF.fused_ntt(x, inverse, lazy=True), want)
    print(f"ntt: strict kernels == lazy kernels == Stockham at n={list(NTT_SIZES)}, "
          f"batch 1 and 3, and at batch {WIDE_BATCH} for n=2^16 and 2^18, forward "
          "and inverse", flush=True)

    # K1, K3 and K2 alone at every column length from 2 to 2^12 rows, each
    # call twice in a row (a second call finds what the first one left).
    shapes = [(lg, batch) for lg in PASS_LGS for batch in (1, 3, WIDE_BATCH)]
    shapes += [(lg, 1) for lg in PASS_LGS_LONG]
    tiles = set()
    for lg, batch in shapes:
        plan = NTF.get_plan(1 << lg, lg % 2 == 1, dev)
        x3 = rand((batch, plan.n1, plan.n2))
        want1 = NTF.pass1_plain(x3, plan)
        yt = NTF.transpose_plain(want1)
        want2 = NTF.pass2_plain(yt, plan)
        tiles.add(NTF._launch_shape(plan.lg1, plan.n2, batch))
        tiles.add(NTF._launch_shape(plan.lg2, plan.n1, batch))
        for turn in (1, 2):
            what = f"n=2^{lg} batch={batch} call {turn}"
            _require_equal("ntt_transpose " + what, NTF.ntt_transpose(want1), yt)
            for lazy in (False, True):
                what = f"n=2^{lg} batch={batch} lazy={lazy} call {turn}"
                _require_equal("ntt_pass1 " + what, NTF.ntt_pass1(x3, plan, lazy), want1)
                _require_equal("ntt_pass2 " + what, NTF.ntt_pass2(yt, plan, lazy), want2)
    print("ntt: pass 1, the transpose and pass 2 alone == plain, strict and lazy, at "
          f"every n from 2^{PASS_LGS[0]} to 2^{PASS_LGS[-1]}, batch 1, 3 and "
          f"{WIDE_BATCH}, and at n=2^{PASS_LGS_LONG[0]}, batch 1 (columns of 2 to "
          f"2^12 rows: rounds {NTF.round_stages(1)} to {NTF.round_stages(12)}; tiles "
          "of (log2 columns, threads) "
          f"{sorted(tiles)}), each call twice", flush=True)

    # K3 on both sides of its shape rule and around its tile.
    routes = {"vector": [], "edge": []}
    for b, r, c in TRANSPOSE_SHAPES:
        y3 = rand((b, r, c))
        want = NTF.transpose_plain(y3)
        for turn in (1, 2):
            _require_equal(f"ntt_transpose ({b}, {r}, {c}) call {turn}",
                           NTF.ntt_transpose(y3), want)
        routes["vector" if NTF._transpose_vector(r, c) else "edge"].append((b, r, c))
    if not routes["vector"] or not routes["edge"]:
        raise AssertionError(f"ntt_transpose: a route was not driven: {routes}")
    print(f"ntt: transpose == plain, each call twice, on the vector route at "
          f"{routes['vector']} and on the edge route at {routes['edge']}", flush=True)

    # Each NTT kernel alone at the shapes the two paths give it.  The JSON
    # entries keep the main path's LDE shape; the others are printed.
    for batch, n, inverse in PASS_SHAPES:
        plan = NTF.get_plan(n, inverse, dev)
        shape = f"batch={batch}, n=2^{n.bit_length() - 1}"
        size = batch * n
        sets = _copies(8 * size)
        xs = _clones(sets, rand((batch, plan.n1, plan.n2)))
        ys = [(NTF.ntt_pass1(x3, plan),) for (x3,) in xs]
        yts = [(NTF.ntt_transpose(y3),) for (y3,) in ys]
        mark = len(results.entries)
        for lazy in (False, True):
            bf = OPS_BUTTERFLY[lazy]
            results.add(
                NTF.PASS1_LAZY if lazy else NTF.PASS1, shape, xs,
                lambda x3, lazy=lazy: NTF.ntt_pass1(x3, plan, lazy),
                lambda x3, lazy=lazy: NTF.pass1_plain(x3, plan, lazy), 50,
                nbytes=8 * size + 4 * n,
                ops=size // 2 * plan.lg1 * bf + size * OPS_MONT)
            results.add(
                NTF.PASS2_LAZY if lazy else NTF.PASS2, shape, yts,
                lambda yt, lazy=lazy: NTF.ntt_pass2(yt, plan, lazy),
                lambda yt, lazy=lazy: NTF.pass2_plain(yt, plan, lazy), 50,
                nbytes=8 * size,
                ops=size // 2 * plan.lg2 * bf + (2 * size if lazy else 0))
        results.add(
            NTF.TRANSPOSE, shape, ys, NTF.ntt_transpose, NTF.transpose_plain, 50,
            nbytes=8 * size, ops=0,
            library_fn=lambda y3: y3.transpose(1, 2).contiguous())
        flat = [(x3.reshape((batch, n) if batch > 1 else (n,)),) for (x3,) in xs]
        # Strict against lazy, in turns within this one call.
        ab = [_device_ms(_cycled(lambda x, lazy=lazy: NTF.fused_ntt(x, inverse, lazy),
                                 flat), 50)
              for lazy in (False, True, True, False)]
        stockham_ms = _device_ms(_cycled(lambda x: NTF.ntt_plain(x, inverse), flat), 5)
        print(f"ntt {shape} inverse={inverse} ({sets} buffer sets): "
              + "; ".join(_line(e) for e in results.entries[mark:])
              + f"; whole transform strict {ab[0]:.4f}, lazy {ab[1]:.4f}, lazy "
              f"{ab[2]:.4f}, strict {ab[3]:.4f} ms (Stockham {stockham_ms:.4f}); "
              "device time per call", flush=True)
        if (batch, n) != (1, 4 * MAIN_T):
            del results.entries[mark:]


def _check_pad_scale(rng, dev, results: _Results) -> None:
    """K14 against its plain version at every shape of PAD_SCALE_SHAPES
    (the offset) and PAD_SCALE_SQUARE (T = N, the offset and its inverse),
    each call twice; then timed at the three paths' shapes, operands cycled
    as the other kernels' are.  Its bound counts the bytes the function
    needs (4 (T + N) a row); the kernel also reads its (2, T) table of
    powers, whose bound is printed beside."""
    from stark_tpu_torch.ops import ntt as NTT
    from stark_tpu_torch.ops.fieldops import GENERATOR, host_inv

    inverse = host_inv(GENERATOR)
    cases = [(rows, t, n, GENERATOR) for rows, t, n in PAD_SCALE_SHAPES]
    cases += [(rows, n, n, s) for rows, n in PAD_SCALE_SQUARE for s in (GENERATOR, inverse)]
    for rows, t, n, s in cases:
        c = _rand_field(rng, dev, (rows, t))
        want = NTT.pad_scale_plain(c, n, s)
        for turn in (1, 2):
            _require_equal(f"lde_pad_scale ({rows}, {t} -> {n}) s={s} call {turn}",
                           NTT.pad_scale(c, n, s), want)
    print(f"lde_pad_scale == plain, each call twice, at (rows, T, N) "
          f"{[c[:3] for c in cases[:len(PAD_SCALE_SHAPES)]]} with s = {GENERATOR}, and at "
          f"T = N {list(PAD_SCALE_SQUARE)} with s = {GENERATOR} and its inverse {inverse}",
          flush=True)
    for i, (rows, t, n) in enumerate(PAD_SCALE_SHAPES[:PAD_SCALE_TIMED]):
        shape = f"rows={rows}, T=2^{t.bit_length() - 1} -> N=2^{n.bit_length() - 1}"
        nbytes = 4 * rows * (t + n)
        sets = _copies(nbytes)
        cs = _clones(sets, _rand_field(rng, dev, (rows, t)))
        entry = results.add(
            NTT.PAD_SCALE, shape, cs, lambda c, n=n: NTT.pad_scale(c, n, GENERATOR),
            lambda c, n=n: NTT.pad_scale_plain(c, n, GENERATOR), 50,
            nbytes=nbytes, ops=OPS_SHOUP * rows * t)
        with_table = _bound(nbytes + 8 * t, OPS_SHOUP * rows * t)[0]
        print(f"lde_pad_scale {shape} ({sets} buffer sets): {_line(entry)}, "
              f"{entry['bound_ms'] / entry['ms']:.1%} of its bound; bound with the "
              f"table's 8 T bytes {with_table:.4f} ms; device time per call", flush=True)
        if i:
            results.entries.remove(entry)


def _check_lde_pass1(rng, dev, results: _Results) -> None:
    """K1 of an LDE against its plain version, strict and lazy, each call
    twice, at PAD_SCALE_SHAPES and LDE_ODD_SHAPES; then timed at the
    paths' three shapes, operands cycled, with its bound (the coefficients
    read, its two scale tables, wm, the output written; or its butterflies,
    REDCs and two Shoup products a coefficient), and in turn with K14 then
    K1 (before, after, after, before)."""
    from stark_tpu_torch.ops import ntt as NTT
    from stark_tpu_torch.ops import ntt_fused as NTF
    from stark_tpu_torch.ops.fieldops import GENERATOR

    s = GENERATOR
    for rows, t, n in PAD_SCALE_SHAPES + LDE_ODD_SHAPES:
        plan = NTF.get_plan(n, False, dev)
        c = _rand_field(rng, dev, (rows, t))
        for lazy in (False, True):
            want = NTF.pass1_lde_plain(c, plan, s, lazy)
            for turn in (1, 2):
                _require_equal(f"ntt_pass1_lde ({rows}, {t} -> {n}) lazy={lazy} call {turn}",
                               NTF.ntt_pass1_lde(c, plan, s, lazy), want)
    print(f"ntt_pass1_lde == plain, strict and lazy, each call twice, at (rows, T, N) "
          f"{list(PAD_SCALE_SHAPES + LDE_ODD_SHAPES)} with s = {s}", flush=True)
    for i, (rows, t, n) in enumerate(PAD_SCALE_SHAPES[:PAD_SCALE_TIMED]):
        plan = NTF.get_plan(n, False, dev)
        shape = f"rows={rows}, T=2^{t.bit_length() - 1} -> N=2^{n.bit_length() - 1}"
        nbytes = 4 * rows * t + 8 * (plan.n1 + plan.n2) + 4 * n + 4 * rows * n
        cs = _clones(_copies(4 * rows * (t + n)), _rand_field(rng, dev, (rows, t)))
        mark = len(results.entries)
        for lazy in (False, True):
            entry = results.add(
                NTF.PASS1_LDE_LAZY if lazy else NTF.PASS1_LDE, shape, cs,
                lambda c, lazy=lazy: NTF.ntt_pass1_lde(c, plan, s, lazy),
                lambda c, lazy=lazy: NTF.pass1_lde_plain(c, plan, s, lazy), 50,
                nbytes=nbytes,
                ops=rows * n // 2 * plan.lg1 * OPS_BUTTERFLY[lazy] + rows * n * OPS_MONT
                + 2 * OPS_SHOUP * rows * t)

            def before(c, lazy=lazy):
                x3 = NTT.pad_scale(c, n, s).reshape(rows, plan.n1, plan.n2)
                return NTF.ntt_pass1(x3, plan, lazy)

            _require_equal(f"K14 + K1 {shape} lazy={lazy}", before(cs[0][0]),
                           NTF.pass1_lde_plain(cs[0][0], plan, s, lazy))
            calls = (_cycled(before, cs),
                     _cycled(lambda c, lazy=lazy: NTF.ntt_pass1_lde(c, plan, s, lazy), cs))
            entry["turns_ms"] = [_device_ms(calls[k], 50) for k in (0, 1, 1, 0)]
        print(f"ntt_pass1_lde {shape} ({len(cs)} buffer sets): " + "; ".join(
            f"{_line(e)}, {e['bound_ms'] / e['ms']:.1%} of its bound, in turn with K14 + K1 "
            f"(before, after, after, before) {json.dumps([round(x, 5) for x in e['turns_ms']])}"
            for e in results.entries[mark:]) + "; device time per call", flush=True)
        if i:
            del results.entries[mark:]


def _check_sharded_forms(rng, dev, _results: _Results) -> None:
    """K14 and K11 at the sharded prover's operands against their plain
    versions, each call twice, then timed (printed; the kernels line keeps
    the main path's entry of each): K14 with a caller's table (the
    four-step's twiddle w^(j2 k1) over a rank's (C/D, R) rows at
    SCALE_TABLE_CASES, and an LDE share's pad and scale with its offset
    table), and K11 on a share with its halo at HALO_CASES (the last rank's:
    its frame reads run into rank 0's head; random boundary values).  The table is an input here,
    so the bound counts its bytes."""
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.ops import compose as CO
    from stark_tpu_torch.ops import ntt as NTT
    from stark_tpu_torch.ops.fieldops import GENERATOR, host_powers
    from stark_tpu_torch.parallel import pntt

    lines, timed = [], _Results()
    for n, d in SCALE_TABLE_CASES:
        r_len, c_len = pntt._split(n)
        t = c_len // d * r_len
        table = pntt._twiddles(n, False, d, d - 1, 1, dev)[0]
        c = _rand_field(rng, dev, (1, t))
        want = NTT.pad_scale_by_plain(c, t, table)
        for turn in (1, 2):
            _require_equal(f"lde_pad_scale twiddle n=2^{n.bit_length() - 1} D={d} call "
                           f"{turn}", NTT.pad_scale_by(c, t, table), want)
        shape = (f"twiddle rows (C/D, R) = (2^{(c_len // d).bit_length() - 1}, "
                 f"2^{r_len.bit_length() - 1}), n=2^{n.bit_length() - 1}, D={d}")
        nbytes = 4 * t + 8 * t + 4 * t
        # The table cycles with the operand: a table read from L2 would beat
        # a bound that counts its bytes from device memory.
        sets = _clones(_copies(nbytes), c, table)
        entry = timed.add(
            NTT.PAD_SCALE, shape, sets, lambda x, tab, t=t: NTT.pad_scale_by(x, t, tab),
            lambda x, tab, t=t: NTT.pad_scale_by_plain(x, t, tab),
            50, nbytes=nbytes, ops=OPS_SHOUP * t)
        lines.append(f"lde_pad_scale {shape}: " + _line(entry)
                     + f", {entry['bound_ms'] / entry['ms']:.1%} of its bound")
    # An LDE share that pads: MDS T=2^16 on D=2, rank 0 (its 8 rows' 2^16
    # coefficients into a share of 2^17 points).
    t, share = MDS_T, 4 * MDS_T // DIST_MDS_D
    table = NTT.table_of(host_powers(GENERATOR, t), dev)
    c = _rand_field(rng, dev, (WIDE_BATCH, t))
    want = NTT.pad_scale_by_plain(c, share, table)
    for turn in (1, 2):
        _require_equal(f"lde_pad_scale LDE share call {turn}",
                       NTT.pad_scale_by(c, share, table), want)
    flush = _L2Flush(dev)
    for model, T, blowup, d in HALO_CASES:
        air = _air(model)
        prover = StarkProver(air, StarkConfig(trace_length=T, blowup=blowup))
        prog, n = prover.program, prover.dom.N
        m, reach = n // d, air.max_offset * blowup
        tables = prover._tables(m * (d - 1), m)
        lde = _rand_field(rng, dev, (air.num_registers, m + reach))
        al = rng.integers(0, 998244353, size=prog.terms)
        be = rng.integers(0, 998244353, size=prog.terms)
        values = _boundary_words(rng, dev, prog, 1)

        def kernel(x, a, w, prog=prog, tables=tables, blowup=blowup, m=m, values=values):
            return CO.compose(prog, x, tables, a, w, blowup, points=m, values=values)

        def plain(x, a, w, prog=prog, tables=tables, blowup=blowup, m=m, values=values):
            return CO.compose_plain(prog, x, tables, a, w, blowup, points=m, values=values)

        want = plain(lde, al, be)
        for turn in (1, 2):
            _require_equal(f"compose halo {model} T={T} D={d} call {turn}",
                           kernel(lde, al, be), want)
        shape = (f"{model} T=2^{T.bit_length() - 1}, D={d}: (c, share + halo) = "
                 f"({air.num_registers}, 2^{m.bit_length() - 1} + {reach})")
        entry = timed.add(
            CO.COMPOSE, shape, [(lde, al, be)], kernel, plain, 50,
            nbytes=4 * (prog.registers_read() * (m + reach) + m * (prog.table_loads() + 1)
                        + values.numel()),
            ops=m * prog.operations(), flush=flush)
        lines.append(f"compose {shape}: " + _line(entry) + ", L2 flushed before each call")
        del prover, lde, want, tables
    print("K14 and K11 at the sharded operands == plain, each call twice, device time per "
          "call: " + "; ".join(lines) + "; and K14 with a table at an LDE share that pads "
          f"({WIDE_BATCH}, 2^16 -> 2^17)", flush=True)
    _check_windowed_gather(rng, dev)


def _seat(rank: int, size: int, dev):
    """Rank ``rank`` of a mesh of ``size`` as its plans see it: a Mesh of
    this process with that rank and size and no process group (shapes
    only: nothing here calls a collective)."""
    from stark_tpu_torch.parallel.mesh import Mesh

    seat = Mesh(None, 0, 1, dev)
    seat.rank, seat.size = rank, size
    return seat


def _window_sources(plan, gen, dev) -> list:
    """Seeded tensors of a rule plan's declared shapes, bound as its run
    binds them (a split stack as its pair)."""
    from stark_tpu_torch.ops import gather as G

    def rand(i):
        shape, dtype = plan.specs[i]
        hi = 998244353 if dtype == torch.int32 else 256
        return torch.randint(0, hi, shape, dtype=dtype, device=dev, generator=gen)

    return [(rand(spec), rand(spec + 1)) if kind == G.PATHS and split else rand(spec)
            for kind, _, split, spec in plan._decl]


def _owned_words(plan, idx) -> int:
    """The words of ``plan`` that its rank serves (reads from a source)."""
    return sum(int(rule.owned(rule.point_rows(idx)[0]).sum()) * slot.width
               for _, rule, slot in plan.requests)


def _check_windowed_gather(rng, dev) -> None:
    """K13's windowed form (a rank's share of the sharded single-fetch
    plan, pmerkle.ShardedRulePlan without its combine) against its plain
    version at WINDOW_CASES, every rank, each call twice; timed at the
    first case on every rank, the L2 flushed before each call.  Its bound:
    every word written, the words the rank serves read once, the encoded
    table and the index buffer.  Printed with the launches each plan
    takes (the kernels line keeps the main path's K13 entry)."""
    from stark_tpu_torch import StarkConfig
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import gather as G
    from stark_tpu_torch.parallel import DistributedStarkProver

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    flush, lines = _L2Flush(dev), []
    for case, (model, T, d) in enumerate(WINDOW_CASES):
        air = get_model(model)[0]
        cfg = StarkConfig(trace_length=T, blowup=4, num_colinearity_tests=16)
        per_rank, owned = [], 0
        # The same indices on every rank, as K10 gives them.
        idx = torch.randint(0, 4 * T // 2, (1, cfg.num_colinearity_tests),
                            dtype=torch.int32, device=dev, generator=gen)
        for rank in range(d):
            prover = DistributedStarkProver(air, cfg, _seat(rank, d, dev))
            plan = prover._rule_plan(1)[0]
            sources = _window_sources(plan, gen, dev)
            out = torch.empty(plan.words, dtype=torch.int32, device=dev)
            owned += _owned_words(plan, idx)
            want = G.rules_plain(plan, sources, idx)
            for turn in (1, 2):
                out.fill_(-1)
                _require_equal(f"query_gather windowed {model} T={T} D={d} rank {rank} call "
                               f"{turn}", G.RulePlan.run(plan, sources, idx, out), want)
            params = plan.encode(sources, idx.data_ptr(), out.data_ptr())
            cut = sum(split for _, _, split, _ in plan._decl)
            note = (f"rank {rank}: {len(plan._decl)} sources ({cut} cut), "
                    f"{len(plan.requests)} rule slots, {plan.words} words, "
                    f"{_owned_words(plan, idx)} its own, {len(params)} launch(es) of "
                    f"{[p.nbytes for p in params]} parameter bytes")
            if case == 0:
                table = sum(4 * (8 + 4 * int(p[0]) + 4 * int(p[1]) + int(p[2]) + int(p[3]))
                            for p in params)
                entry = _Results().add(
                    G.QUERY_GATHER, f"windowed {model} T=2^{T.bit_length() - 1} D={d} "
                    f"rank {rank}", [(sources, idx, out)],
                    lambda s_, i, o, plan=plan: G.RulePlan.run(plan, s_, i, o),
                    lambda s_, i, o, plan=plan: G.rules_plain(plan, s_, i), 50,
                    nbytes=4 * (plan.words + _owned_words(plan, idx) + idx.numel()) + table,
                    ops=0, flush=flush)
                note += ", " + _line(entry)
            per_rank.append(note)
            del prover, sources, out, want
        if owned != plan.words:
            raise AssertionError(f"windowed {model} T={T} D={d}: the ranks serve {owned} "
                                 f"words of {plan.words}")
        lines.append(f"{model} T=2^{T.bit_length() - 1} D={d}: " + "; ".join(per_rank))
    print("query_gather windowed (K13's rule slots over a rank's share, zeros where "
          "another rank serves a request) == plain on every rank, each call twice; device "
          "time per call, L2 flushed before each: " + " | ".join(lines), flush=True)


def _drive_distributed(smi: str, launches: dict) -> None:
    """The distributed phase (stark_tpu_torch/tools/dist_prove.py): an NCCL
    world of one rank (Fibonacci T=2^20, the pinned sha256) alone on the
    card, its sharded single-fetch prove one CUDA graph (captured at the
    slot's second prove, its collectives inside) in turn with the eager
    body (graph, eager, eager, graph; DIST_TURN_RUNS proves a turn); then
    four worlds at once, each rank a spawned process on the one card, every
    library built first: D=4 gloo ranks (Fibonacci T=2^21, N=2^23, against
    a single-device card prove of the same witness made here, verified);
    D=2 gloo ranks (MDS T=2^16, the pinned sha256); D=2 gloo ranks at
    batch8's shape (T=2^14: the sharded prove, then BatchStarkProver(mesh=)
    of 8, every proof the single prove's); D=2 gloo ranks at T=2^14 on the
    FRI commit's host path (K4 on the exchanged halves).  All but the last
    on the single-fetch prove, every gloo world's sharded body eager
    (parallel/pstark.graphs_allowed); then the D=4 world alone on each path
    in turn (single fetch, three reads, three reads, single fetch).  Each
    rank: warm-ups, DIST_RUNS proves a turn, the last counted (every kernel
    of its World.kernels above 0, on the single-fetch path K15 and K10
    once, one read and one combine; three reads on the three-read path;
    three all-to-alls of n/D words a transform; a graph turn's launches and
    collectives those of the eager turn: DP.check)."""
    from stark_tpu_torch import StarkConfig, StarkVerifier
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.tools import dist_prove as DP

    t_start = time.perf_counter()
    sha = {T: hashlib.sha256(DP.single_proof("fib", T)).hexdigest() for T in (DIST_T, BATCH_T)}
    torch.cuda.empty_cache()
    nccl = DP.World(1, "nccl", "fib", MAIN_T, MAIN_SHA256, runs=DIST_TURN_RUNS,
                    forms=DP.IN_TURN)
    got = DP.run([nccl])
    ranks = got[nccl.name]
    DP.check(nccl, ranks)
    graph = ranks[0]["graph"]
    nccl_turns = [(t["form"], float(np.median(t["wall_s"])) * 1e3,
                   float(np.median(t["body_ms"]))) for t in ranks[0]["turns"]]
    print(f"distributed {nccl.name} ({smi}): the sharded single-fetch prove's body one CUDA "
          f"graph (NCCL's collectives inside), captured at prove {ranks[0]['captured_at']} "
          f"in {graph['capture_s']:.4f} s, holding {sum(graph['launches'].values())} launches "
          f"and collectives {json.dumps(graph['collectives'])} (words "
          f"{json.dumps([words for _, words in graph['log']])}); slot memory "
          f"{json.dumps(graph['slot_bytes'])} B; in turn with the eager body "
          f"({DIST_TURN_RUNS} proves a turn; form, median wall ms of witness + prove, median "
          "device ms of the replay or the eager body by CUDA events) "
          + json.dumps([[form, round(wall, 4), round(body, 4)]
                        for form, wall, body in nccl_turns])
          + "; every proof's sha256 == the pin; each turn's launches and collectives equal "
          "the eager turn's", flush=True)
    worlds = [DP.World(DIST_D, "gloo", "fib", DIST_T, sha[DIST_T], runs=DIST_RUNS),
              DP.World(DIST_MDS_D, "gloo", "mds", MDS_T, MDS_SHA256, runs=DIST_RUNS),
              DP.World(DIST_MDS_D, "gloo", "fib", BATCH_T, sha[BATCH_T], batch=8,
                       runs=DIST_RUNS),
              DP.World(DIST_MDS_D, "gloo", "fib", BATCH_T, sha[BATCH_T], runs=DIST_RUNS,
                       host_path=True)]
    got.update(DP.run(worlds))
    # The D=4 world alone on each path in turn: single fetch, three reads,
    # three reads, single fetch.
    paths = [DP.World(DIST_D, "gloo", "fib", DIST_T, sha[DIST_T], runs=DIST_RUNS,
                      three_reads=three) for three in (False, True)]
    turns = []
    for w in (paths[0], paths[1], paths[1], paths[0]):
        turns.append(DP.run([w])[w.name])
        DP.check(w, turns[-1])
    worlds = [nccl, *worlds, paths[1]]
    got[paths[1].name] = turns[1]
    print(f"distributed {paths[0].name} in turn with {paths[1].name} (single fetch, three "
          f"reads, three reads, single fetch), each world alone on the card ({smi}): wall "
          "s of witness + prove by rank "
          + " / ".join(json.dumps([[round(x, 4) for x in o["wall_s"]] for o in turn])
                       for turn in turns)
          + "; phases ms of rank 0's last prove by turn "
          + " / ".join(json.dumps({k: round(v, 3) for k, v in turn[0]["phases_ms"][-1].items()})
                       for turn in turns), flush=True)
    for w in worlds:
        ranks = got[w.name]
        DP.check(w, ranks)
        if w.backend == "gloo" and any(o["graph"] is not None or o["graphs_allowed"]
                                       for o in ranks):
            raise AssertionError(f"{w.name}: a gloo rank's sharded body was a graph")
        air = get_model(w.model)[0]
        verifier = StarkVerifier(air, StarkConfig(trace_length=w.trace_length, blowup=4,
                                                  num_colinearity_tests=16))
        proof = ranks[0]["proof"]
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        if not verifier.verify(proof) or verifier.verify(bytes(bad)):
            raise AssertionError(f"{w.name}: the verifier did not accept the proof and "
                                 "reject a flipped byte")
        c = air.num_registers
        print(f"distributed {w.name} ({smi}; every rank on "
              f"{', '.join(sorted({o['device'] for o in ranks}))}): every rank's proofs' "
              f"sha256 == {w.want[:16]}... ("
              + ("the pin" if w.want in (MAIN_SHA256, MDS_SHA256) else
                 "a single-device card prove of the same witness in this run")
              + "), verified, a flipped byte rejected; reads from the card of the last "
              f"prove by rank {json.dumps([o['reads'] for o in ranks])}; launches of it by rank "
              + json.dumps({k: [o["counts"][k] for o in ranks]
                            for k in w.kernels + DP.SINGLE_KERNELS})
              + f"; collectives of rank 0 {json.dumps(ranks[0]['collectives'])} (all-to-alls "
              f"of {c} T/D then {c} N/D words, three a transform); the sharded body "
              + ("a CUDA graph on every rank" if ranks[0]["graph"] else "eager on every rank")
              + "; wall s of witness + "
              f"prove by rank {json.dumps([[round(x, 4) for x in o['wall_s']] for o in ranks])}",
              flush=True)
        if w.batch:
            # The cut batch: each rank's share on the single-fetch path.
            single = ("constraint_challenges", "sample_indices")
            if any(o["batch"]["counts"][k] != 1 for o in ranks for k in single):
                raise AssertionError(f"{w.name}: a rank's batch share did not take the "
                                     "single-fetch path")
            print(f"distributed {w.name}: BatchStarkProver(mesh=) of {w.batch} (B/D = "
                  f"{w.batch // w.ranks} a rank, the batch cut, each share on the "
                  "single-fetch path): every proof == the single prove on every rank; "
                  "launches by rank "
                  + json.dumps({k: [o["batch"]["counts"][k] for o in ranks]
                                for k in ("merkle_forest", "compose", "query_gather") + single})
                  + "; wall s by rank "
                  + json.dumps([[round(x, 4) for x in o["batch"]["wall_s"]] for o in ranks]),
                  flush=True)
        launches[f"dist {w.name}"] = ranks[0]["counts"]
    print(f"distributed phase: {time.perf_counter() - t_start:.1f} s, the worlds' processes "
          "on the card at once (the walls above are no yardstick for the single-device "
          "prover: gloo's exchanges cross the host)", flush=True)


def _check_poly(rng, dev) -> None:
    """A Polynomial product above the crossover on the card (K1-K3: the two
    operands as one batch, then the inverse), equal to the same product
    with device="cpu"."""
    from stark_tpu_torch import Polynomial
    from stark_tpu_torch.ops import cuda

    ca, cb = (rng.integers(0, 998244353, size=POLY_COEFFS).tolist() for _ in range(2))
    cuda.reset_launches()
    t0 = time.perf_counter()
    got = Polynomial(ca, device=dev) * Polynomial(cb, device=dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in cuda.launch_counts().items() if v}
    want = Polynomial(ca, device="cpu") * Polynomial(cb, device="cpu")
    if got.coeffs != want.coeffs:
        raise AssertionError("Polynomial product on the card != on the CPU")
    if counts != {"ntt_pass1": 2, "ntt_transpose": 2, "ntt_pass2": 2}:
        raise AssertionError(f"Polynomial product: launches {counts}")
    print(f"Polynomial: product of two {POLY_COEFFS}-coefficient polynomials on the card "
          f"== on the CPU ({len(got.coeffs)} coefficients), launches {json.dumps(counts)}, "
          f"{wall * 1e3:.1f} ms host clock with the Python-int conversions", flush=True)


def _cli(argument_lists: list) -> list:
    """``python -m stark_tpu_torch`` once for each argument list, all at
    once, from the repository's root; returns (exit code, stdout, stderr)
    of each.  Every process is waited for or killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-m", "stark_tpu_torch", *args], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for args in argument_lists]
    try:
        done = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            done.append((p.returncode, out, err))
        return done
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _drive_cli() -> None:
    """The command line as a user runs it, on the card: proves of the main
    path (Fibonacci T=2^20) and the wide path (MDS T=2^16) to their pinned
    sha256, a Fibonacci T=2^16 prove from the device witness and with
    --host-witness (the same bytes, stark_tpu's pin), then verify (ACCEPT,
    exit 0), inspect, and a tampered file rejected (exit 1)."""
    cfg = ["--blowup", "4", "--queries", "16"]
    models = {"fib": (["--model", "fib", "--trace-length", str(MAIN_T), *cfg], MAIN_SHA256),
              "mds": (["--model", "mds", "--trace-length", str(MDS_T), *cfg], MDS_SHA256)}
    small = ["--model", "fib", "--trace-length", str(CLI_T_SMALL), *cfg]
    small_sha = PINNED[("fib", CLI_T_SMALL, 4, 16)]
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: os.path.join(tmp, f"{k}.bin")
                 for k in ("fib", "mds", "small", "small_host", "bad")}
        t0 = time.perf_counter()
        proves = _cli([["prove", *models["fib"][0], "--out", files["fib"]],
                       ["prove", *models["mds"][0], "--out", files["mds"]],
                       ["prove", *small, "--out", files["small"]],
                       ["prove", *small, "--host-witness", "--out", files["small_host"]]])
        t1 = time.perf_counter()
        for rc, out, err in proves:
            if rc != 0:
                raise AssertionError(f"cli prove exit {rc}: {out}{err}")
        shas = {}
        for k in ("fib", "mds", "small", "small_host"):
            with open(files[k], "rb") as f:
                shas[k] = hashlib.sha256(f.read()).hexdigest()
        want = {"fib": MAIN_SHA256, "mds": MDS_SHA256, "small": small_sha,
                "small_host": small_sha}
        if shas != want:
            raise AssertionError(f"cli proof sha256 {shas} != pinned {want}")
        with open(files["small"], "rb") as f:
            bad = bytearray(f.read())
        bad[100] ^= 1
        with open(files["bad"], "wb") as f:
            f.write(bytes(bad))
        checks = _cli([["verify", files["fib"], *models["fib"][0]],
                       ["verify", files["mds"], *models["mds"][0]],
                       ["verify", files["small_host"], *small],
                       ["verify", files["bad"], *small],
                       ["inspect", files["fib"]]])
        t2 = time.perf_counter()
    codes = [rc for rc, _, _ in checks]
    # The verdict line ends the output (a rejection's reason comes first).
    verdicts = [out.strip().splitlines()[-1].split()[1] if out.strip() else ""
                for _, out, _ in checks[:4]]
    if codes != [0, 0, 0, 1, 0] or verdicts != ["ACCEPT"] * 3 + ["REJECT"] or \
            "MerkleRoot" not in checks[4][1]:
        raise AssertionError(f"cli verify/inspect: exit codes {codes}, verdicts {verdicts}, "
                             f"{[err for _, _, err in checks]}")
    print("cli: python -m stark_tpu_torch prove (fib T=2^20, mds T=2^16, fib T=2^16 from "
          "the device witness and --host-witness, four processes at once) "
          f"{t1 - t0:.1f} s: sha256 == the pins, host witness == device witness; "
          f"verify ACCEPT x3 and a tampered file REJECT (exit 1), inspect, {t2 - t1:.1f} s; "
          "the proves said: " + " | ".join(out.strip() for _, out, _ in proves), flush=True)


def _check_fold(rng, dev, results: _Results) -> None:
    from stark_tpu_torch.ops import fold as FOLD

    def rand(shape):
        return _rand_field(rng, dev, shape)

    alpha = (1 << 64) - 12345  # a raw challenge above 2^63
    for half in FOLD_HALVES:
        cw = rand((2 * half,))
        inv_x = rand((half,))
        _require_equal(f"fold half={half}", FOLD.fold(cw, inv_x, alpha),
                       FOLD.fold_plain(cw, inv_x, alpha))
        if half == FOLD_HALVES[0]:
            entry = results.add(
                FOLD.FOLD, "half=2^21", _clones(_copies(16 * half), cw, inv_x),
                lambda cw, inv_x: FOLD.fold(cw, inv_x, alpha),
                lambda cw, inv_x: FOLD.fold_plain(cw, inv_x, alpha), 200,
                nbytes=16 * half, ops=OPS_FOLD * half)
    print("fold: kernel == plain at every half from 2^21 down to 2^7; half=2^21 "
          f"({entry['buffer_sets']} buffer sets) " + _line(entry)
          + ", device time per call", flush=True)

    _check_fold_dyn(rng, dev, results)


def _dyn_sponge(rng, dev, b: int, q: int):
    """A K9 sponge of ``b`` lanes on ``dev`` after a prefix of 64 + q
    bytes a lane, with a root, a root copy and an alpha buffer."""
    from stark_tpu_torch.ops import hash_batch as HB

    sp = HB.Sponge(b, dev)
    sp.absorb(torch.from_numpy(rng.integers(0, 256, (b, 64 + q), dtype=np.uint8)).to(dev))
    return (sp, torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev),
            torch.empty((b, 32), dtype=torch.uint8, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev))


def _fold_dyn_checked(FOLD, what, cws, inv_x, sp, roots, copy, alpha, fn=None):
    """One K4-dyn launch (or ``fn``, the same call of another design) held
    against the plain version on the same inputs: the folded rows, the
    challenges, the root copies and the sponge after the roots.  Returns
    (folded, plain folded)."""
    state, pending, want_alpha, want = FOLD.fold_dyn_round_plain(
        cws, inv_x, sp.state, sp.pending, sp.q, roots)
    got = (fn or FOLD.fold_dyn)(cws, inv_x, sp, roots, copy, alpha)
    for part, g, w in (("folded", got, want), ("alpha", alpha, want_alpha.to(torch.int32)),
                       ("copy", copy, roots), ("state", sp.state, state),
                       ("pending", sp.pending, pending)):
        _require_equal(f"{what} {part}", g, w)
    return got, want


def _check_fold_dyn(rng, dev, results: _Results) -> None:
    """K4-dyn, one round of the device chain (each row's root absorbed
    into its sponge, the challenge drawn, the row folded), against its
    plain version at every (B, half) the paths give it and at halves that
    are no multiple of 4, after a 0- and a 16-byte tail, two rounds each
    (the second reads the sponge the first wrote); the pair it replaced
    (K9, then the fold with alpha in device memory: BEFORE["fold_dyn"])
    against plain too; then timed at (1, 2^21), (32, 2^15) and (8, 2^15),
    in turn with the pair, and summed over a Fibonacci T=2^20 prove's 15
    rounds, in turn with the pair."""
    from stark_tpu_torch.ops import fold as FOLD

    def rand(shape):
        return _rand_field(rng, dev, shape)

    before = BEFORE["fold_dyn"]
    shapes = sorted({(1, h) for h in FOLD_HALVES}
                    | {(b, h) for b in (1, 3) + BATCHES for h in BATCH_HALVES}
                    | {(1, 1), (1, 3), (3, 7)})
    for b, half in shapes:
        cws, inv_x = rand((b, 2 * half)), rand((half,))
        for q in (0, 16):
            sp, _, copy, alpha = _dyn_sponge(rng, dev, b, q)
            for r in range(2):
                roots = torch.from_numpy(rng.integers(0, 256, (b, 32), dtype=np.uint8)).to(dev)
                _fold_dyn_checked(FOLD, f"fold_dyn ({b}, {half}) q={q} round {r}",
                                  cws, inv_x, sp, roots, copy, alpha)
            _fold_dyn_checked(FOLD, f"fold_dyn before ({b}, {half}) q={q}", cws, inv_x,
                              sp, roots, copy, alpha, fn=before)
    launch_ms, clock = _empty_launch_ms(dev), _max_clock()
    chain_ms = launch_ms + 10 * OPS_MIX * 2 / (clock * 1e3)
    timed = {}
    for b, half in ((1, FOLD_HALVES[0]), (32, BATCH_HALVES[0]), (8, BATCH_HALVES[0])):
        sp, roots, copy, alpha = _dyn_sponge(rng, dev, b, 16)
        cws, inv_x = rand((b, 2 * half)), rand((half,))
        # the bytes the function must move: a and b of every row and x^-1
        # once, the rows out; a row's sponge, root in, sponge, copy, alpha out
        nbytes = 12 * b * half + 4 * half + b * (3 * 32 + 3 * 32 + 4)
        sets = _clones(_copies(nbytes), cws, inv_x)
        checked = _fold_dyn_checked(FOLD, f"fold_dyn ({b}, {half})", cws, inv_x, sp, roots,
                                    copy, alpha)
        entry = (results if b == 1 else _Results()).add(
            FOLD.FOLD_DYN, f"({b}, half=2^{half.bit_length() - 1}), a root after a 16-byte tail",
            sets, lambda c, x: FOLD.fold_dyn(c, x, sp, roots, copy, alpha),
            lambda c, x: FOLD.fold_dyn_round_plain(c, x, sp.state, sp.pending, sp.q, roots)[3],
            200 if b == 1 else 50, nbytes=nbytes,
            ops=OPS_FOLD_DYN * b * half + b * (OPS_ABSORB_BYTE * (32 + 16) + OPS_MIX * 10),
            checked=checked)
        entry["latency_bound_ms"] = chain_ms
        calls = (_cycled(lambda c, x: before(c, x, sp, roots, copy, alpha), sets),
                 _cycled(lambda c, x: FOLD.fold_dyn(c, x, sp, roots, copy, alpha), sets))
        entry["turns_ms"] = [_device_ms(calls[i], 50) for i in (0, 1, 1, 0)]
        entry["turns_event_ms"] = [_event_ms(calls[i], 50) for i in (0, 1, 1, 0)]
        timed[(b, half)] = entry
    # A Fibonacci T=2^20 prove's 15 rounds (halves 2^21 .. 2^7), one after
    # another, on two sets of buffers in turn (64 MiB each).
    sp, roots, copy, alpha = _dyn_sponge(rng, dev, 1, 16)
    chain = [[(rand((1, 2 * h)), rand((h,))) for h in FOLD_HALVES] for _ in range(2)]

    def rounds(fn):
        return _cycled(lambda bufs: [fn(c, x, sp, roots, copy, alpha) for c, x in bufs],
                       [(bufs,) for bufs in chain])

    calls = (rounds(before), rounds(FOLD.fold_dyn))
    prove_turns = [_device_ms(calls[i], 20) for i in (0, 1, 1, 0)]
    prove_events = [_event_ms(calls[i], 20) for i in (0, 1, 1, 0)]
    prove_bound = sum(max(_bound(16 * h + 200, OPS_FOLD_DYN * h)[0], chain_ms)
                      for h in FOLD_HALVES)
    print(f"fold_dyn: kernel == plain (folded rows, alpha, root copy, sponge after the "
          f"root; q in 0, 16; two rounds) at (B, half) for {len(shapes)} shapes: (1, 2^21 .. "
          f"2^7), (B, 2^15 .. 2^7) for B in {[1, 3] + list(BATCHES)}, (1, 1), (1, 3), "
          "(3, 7); the pair before (K9, then the fold with alpha in device memory) == plain "
          "at each; " + "; ".join(
              f"(B={b}, half=2^{h.bit_length() - 1}) " + _line(e)
              + f", latency bound {e['latency_bound_ms']:.4f} (an empty launch + 10 mixes "
              f"at {clock} MHz); in turn before, after, after, before: device "
              f"{json.dumps([round(t * 1e3, 2) for t in e['turns_ms']])} us, events "
              f"{json.dumps([round(t * 1e3, 2) for t in e['turns_event_ms']])} us"
              for (b, h), e in timed.items())
          + f"; a Fibonacci T=2^20 prove's 15 rounds in turn before, after, after, before: "
          f"device {json.dumps([round(t * 1e3, 2) for t in prove_turns])} us, events "
          f"{json.dumps([round(t * 1e3, 2) for t in prove_events])} us, bound "
          f"{prove_bound * 1e3:.2f} us (each round the larger of its bytes and the chain)",
          flush=True)


def _sm_clock(dev, fn, calls: int = 2000) -> None:
    """Print the SM clock nvidia-smi reads while ``calls`` calls of ``fn``
    are queued on the card, and the integer instruction rate it gives."""
    done = torch.cuda.Event()
    for _ in range(calls):
        fn()
    done.record()
    samples = []
    while not done.query():
        samples.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # The last sample may have been read as the queue ran dry.
    under_load = samples[:-1] or samples
    if not under_load:
        print("clock: the load ended before nvidia-smi answered; not sampled", flush=True)
        return
    mhz = [float(line.split()[0]) for line in under_load]
    print(f"clock under a hash_rows load (clocks.sm, clocks.max.sm, power.draw; "
          f"{len(under_load)} samples): {under_load[0]} .. {under_load[-1]}; "
          f"{sms} SMs x 128 lanes x {min(mhz):.0f} MHz = "
          f"{sms * 128 * min(mhz) * 1e6:.4g} integer instructions/s at most; the "
          f"bounds use {INT_OPS_PER_S:.4g}", flush=True)


def _build_levels(HB, stack: torch.Tensor, cutover: int) -> None:
    """hash_batch.merkle_build with another cutover, for the sweep."""
    w, pos = (stack.shape[0] + 1) // 2, 0
    while w > cutover:
        HB.merkle_level(stack[pos : pos + w], stack[pos + w : pos + w + w // 2])
        pos += w
        w //= 2
    if w > 1:
        HB.merkle_tail(stack[pos : pos + w], stack[pos + w :])


def _check_hash(rng, dev, results: _Results) -> None:
    from stark_tpu_torch import native
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.ops import hash_batch as HB

    def rand(shape):
        return _rand_field(rng, dev, shape)

    def digests(w):
        return torch.from_numpy(
            rng.integers(0, 256, size=(w, 32), dtype=np.uint8)).to(dev)

    for c, n in [(1, n) for n in LEAF_LANES] + [
            (c, n) for c in HASH_WIDTHS for n in HASH_LANES]:
        v = rand((c, n))
        _require_equal(f"hash_rows c={c} N={n}", HB.hash_rows(v),
                       HB.hash_rows_plain(v))
    for w in LEVEL_WIDTHS:
        nodes = digests(w)
        _require_equal(f"merkle_level W={w}", HB.merkle_level(nodes),
                       HB.merkle_level_plain(nodes))
    assert HB.TAIL_CUTOVER in TAIL_WIDTHS
    for w in TAIL_WIDTHS:
        nodes = digests(w)
        got = HB.merkle_tail(nodes)
        want = HB.merkle_tail_plain(nodes)
        _require_equal(f"merkle_tail W={w}", got, want)
        host = np.concatenate(native.merkle_levels(nodes.cpu().numpy())[1:])
        if not np.array_equal(got.cpu().numpy(), host):
            raise AssertionError(f"merkle_tail W={w} != the host engine's levels")
        for lanes in HB.LANE_CHOICES:
            _require_equal(f"merkle_tail W={w} lanes {lanes}",
                           HB.merkle_tail(nodes, lanes=lanes), want)
        _require_equal(f"merkle_tail before W={w}", BEFORE["forest"](nodes), want)
    tail_shapes = []
    for lg_sub in TAIL_SUBTREES:
        for lg_w in sorted({lg_sub + d for d in (-1, 0, 1, 9, 10, 11)}):
            if not 1 <= lg_w <= TAIL_MAX_LG_W:
                continue
            nodes = digests(1 << lg_w)
            want = HB.merkle_tail_plain(nodes, lg_sub)
            cuda.reset_launches()
            for turn in (1, 2):  # the second finds the ticket as the first left it
                _require_equal(f"merkle_tail W=2^{lg_w} lg_sub={lg_sub} call {turn}",
                               HB.merkle_tail(nodes, lg_sub=lg_sub), want)
            launches = len(list(HB.tail_launches(lg_w, lg_sub)))
            if cuda.launch_counts()["merkle_tail"] != 2 * launches:
                raise AssertionError(f"merkle_tail W=2^{lg_w} lg_sub={lg_sub}: not "
                                     f"{launches} launch(es) per call")
            tail_shapes.append(f"{lg_sub}:{lg_w}x{launches}")

    # Whole trees against the host engine: the main path's width, and the
    # narrowest the pinned proofs build.
    for w in (4 * MAIN_T, 16):
        values = rand((w,))
        tree = MerkleTree.from_leaf_values(values)
        host_tree = MerkleTree.from_leaf_values(values.cpu().numpy().astype(np.uint32))
        if tree._stack.device.type != "cuda" or host_tree._stack.device.type != "cpu":
            raise AssertionError(f"W={w} tree: built on the wrong device")
        if tree.root != host_tree.root:
            raise AssertionError(f"W={w} tree: root != the host engine's")
        idx = [int(i) for i in rng.integers(0, w, size=16)]
        if tree.open_batch(idx) != host_tree.open_batch(idx):
            raise AssertionError(f"W={w} tree: opened paths != the host engine's")
    print("hash: hash_rows == plain for c=1 at every N from 2 to 2^22 and for "
          f"c={list(HASH_WIDTHS)} at N={list(HASH_LANES)}; merkle_level == plain at "
          f"W={list(LEVEL_WIDTHS)}; merkle_tail == plain == host engine at every W "
          "from 2 to 2^16, and == plain at lg_sub:lg_W x launches "
          f"{' '.join(tail_shapes)}; the roots and 16 paths of a W=2^22 and a W=16 "
          "tree == the host engine's; all byte-exact", flush=True)

    # Times at the main paths' shapes.
    w = 4 * MAIN_T
    values = rand((w,))
    stack = torch.empty((2 * w - 1, 32), dtype=torch.uint8, device=dev)
    leaves = HB.leaf_hash(values, stack[:w])
    leaf = results.add(
        HB.HASH_ROWS, "c=1, N=2^22", _clones(_copies(36 * w), values[None]),
        HB.hash_rows, HB.hash_rows_plain, 20,
        nbytes=(4 + 32) * w, ops=w * _hash_ops(8))
    n8 = 4 * MDS_T
    # The same kernel at the wide path's shape: printed, not a JSON entry.
    row = _Results().add(
        HB.HASH_ROWS, "c=8, N=2^18",
        _clones(_copies(64 * n8), rand((WIDE_BATCH, n8))),
        HB.hash_rows, HB.hash_rows_plain, 20,
        nbytes=(4 * WIDE_BATCH + 32) * n8, ops=n8 * _hash_ops(64))
    level = results.add(
        HB.MERKLE_LEVEL, "W=2^22", _clones(_copies(48 * w), leaves),
        HB.merkle_level, HB.merkle_level_plain, 20,
        nbytes=(32 + 16) * w, ops=w // 2 * _hash_ops(64))
    wt = HB.TAIL_CUTOVER
    tail = results.add(
        HB.MERKLE_TAIL, f"W=2^{wt.bit_length() - 1}",
        _clones(_copies(64 * wt), leaves[:wt]),
        HB.merkle_tail, HB.merkle_tail_plain, 20,
        nbytes=32 * (2 * wt - 1), ops=(wt - 1) * _hash_ops(64))
    # The design before (every level one lane a hash) and the kernel in
    # use in turn, by the most lanes a hash, and the latency bound.
    lg_wt = wt.bit_length() - 1
    clock, launch_ms = _max_clock(), _empty_launch_ms(dev)
    tail["latency_bound_ms"] = _tail_latency_ms(lg_wt, lg_wt, HB.TAIL_LANES, clock, launch_ms)
    tail["latency_bound_before_ms"] = _tail_latency_ms(lg_wt, lg_wt, 1, clock, launch_ms)
    sets = _clones(_copies(64 * wt), leaves[:wt])
    calls = (_cycled(BEFORE["forest"], sets), _cycled(HB.merkle_tail, sets))
    tail["turns_ms"] = [_device_ms(calls[i], 20) for i in (0, 1, 1, 0)]
    tail["lanes_sweep_ms"] = {ll: _device_ms(_cycled(
        lambda x, ll=ll: HB.merkle_tail(x, lanes=ll), sets), 20) for ll in HB.LANE_CHOICES}
    print(f"hash: merkle_tail == plain at every W from 2 to 2^16 at most "
          f"{list(HB.LANE_CHOICES)} lanes "
          f"a hash, the design before == plain; at W=2^{lg_wt}: latency bound "
          f"{tail['latency_bound_ms']:.4f} ms (one lane a hash: "
          f"{tail['latency_bound_before_ms']:.4f}; {clock} MHz, an empty launch "
          f"{launch_ms:.5f}); in turn before, after, after, before (ms) "
          f"{json.dumps([round(t, 5) for t in tail['turns_ms']])}; by most lanes a hash "
          f"{json.dumps({k: round(v, 5) for k, v in tail['lanes_sweep_ms'].items()})}",
          flush=True)
    print("hash: leaf " + _line(leaf) + "; row c=8 N=2^18 " + _line(row) + "; "
          + _line(level) + "; " + _line(tail) + "; device time per call, buffer sets "
          f"{[e['buffer_sets'] for e in (leaf, row, level, tail)]}", flush=True)
    before = [_bound(0, count * _hash_ops(length, OPS_MIX_BEFORE))[0]
              for count, length in ((w, 8), (n8, 64), (w // 2, 64), (wt - 1, 64))]
    print("hash: the same four bounds on the operation count in use until the hash "
          f"was rewritten ({OPS_MIX_BEFORE} per mix round, now {OPS_MIX}): "
          + ", ".join(f"{ms:.4f}" for ms in before) + " ms", flush=True)

    out = torch.empty_like(leaves)
    _sm_clock(dev, lambda: HB.leaf_hash(values, out))

    # The sweep behind TAIL_CUTOVER: device time to build all levels of a
    # tree from its leaf digests, K7 above the cutover and K8 from it down
    # (one stack rebuilt in place, so the narrow levels stay in L2 as they
    # do on a prove).
    for lg_w in (22, 18):
        sub = stack[: (2 << lg_w) - 1].clone() if lg_w < 22 else stack
        sweep = {
            f"2^{lg}": round(_device_ms(lambda lg=lg: _build_levels(HB, sub, 1 << lg), 5), 4)
            for lg in range(10, lg_w + 1, 2)
        }
        print(f"cutover sweep, tree of W=2^{lg_w} (ms per build, by cutover; in use "
              f"2^{HB.TAIL_CUTOVER.bit_length() - 1}): {json.dumps(sweep)}", flush=True)

    # The sweep behind tail_sub_lg: K8 alone, by the size of a block's
    # subtree, operands from device memory as for the entry above.
    for lg_w in (10, 12, 14, 16):
        sets = _clones(_copies(64 << lg_w), leaves[: 1 << lg_w])
        sweep = {
            f"2^{lg}": round(_device_ms(_cycled(
                lambda n, lg=lg: HB.merkle_tail(n, lg_sub=lg), sets), 10), 4)
            for lg in range(5, HB.TAIL_MAX_LG + 1)
        }
        print(f"subtree sweep, merkle_tail W=2^{lg_w} (ms per call, by nodes of a "
              f"block's subtree; in use 2^{HB.tail_sub_lg(lg_w)}): {json.dumps(sweep)}",
              flush=True)


def _max_clock() -> int:
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def _empty_launch_ms(dev) -> float:
    """Device time of an empty kernel's launch (tools/tune_kernels.py's
    floor kernel, built with the rest) at K8's block size."""
    fn = BEFORE["floor"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return _device_ms(lambda: fn(128, 256, 0, stream), 50)


def _check_forest(rng, dev, results: _Results) -> None:
    """K8-forest against its plain version at every per-tree width the
    batch paths' forests hand it (a forest is built with K7 while it is
    wider than TAIL_CUTOVER), at every most lanes a hash (LANE_CHOICES), each
    call twice (the tickets); whole FRI forests of the batch paths' first
    and last rounds against their trees built on the host; timed at the
    widest launch; the design before (every level one lane a hash, built
    from tools/tune_kernels.py) held against plain, then the two in turn,
    the sweep of the most lanes a hash, and the latency bound."""
    from stark_tpu_torch.merkle import Forest, MerkleTree
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.ops import hash_batch as HB

    def digests(w):
        return torch.from_numpy(
            rng.integers(0, 256, size=(w, 32), dtype=np.uint8)).to(dev)

    before = BEFORE["forest"]
    shapes = []
    for b in BATCHES:
        for lg in range(1, (HB.TAIL_CUTOVER // b).bit_length()):
            nodes = digests(b << lg)
            want = HB.forest_tail_plain(nodes, b)
            cuda.reset_launches()
            for lanes in HB.LANE_CHOICES:
                for turn in (1, 2):
                    _require_equal(f"merkle_forest B={b} n=2^{lg} lanes {lanes} call {turn}",
                                   HB.merkle_forest(nodes, b, lanes=lanes), want)
            _require_equal(f"merkle_forest before B={b} n=2^{lg}", before(nodes, b), want)
            calls = 2 * len(HB.LANE_CHOICES)
            shapes.append(f"{b}x2^{lg}:{cuda.launch_counts()['merkle_forest'] // calls}")
        for lg in (BATCH_T.bit_length() + 1, 7):  # the first and last FRI rounds
            values = _rand_field(rng, dev, (b, 1 << lg))
            forest = Forest.from_values(values)
            for t in (0, b - 1):
                host = MerkleTree.from_leaf_values(values[t].cpu().numpy().astype(np.uint32))
                if not np.array_equal(forest.tree(t)._stack.cpu().numpy(),
                                      host._stack.numpy()):
                    raise AssertionError(f"forest B={b} n=2^{lg}: tree {t} != host engine")
    clock, launch_ms = _max_clock(), _empty_launch_ms(dev)
    timed = {}
    w = HB.TAIL_CUTOVER
    for b in FOREST_TIMED:
        lg_n = (w // b).bit_length() - 1
        sets = _clones(_copies(64 * w), digests(w))
        timed[b] = (results if b == 32 else _Results()).add(
            HB.MERKLE_FOREST, f"B={b}, n=2^{lg_n}", sets,
            lambda x, b=b: HB.merkle_forest(x, b),
            lambda x, b=b: HB.forest_tail_plain(x, b), 20,
            nbytes=32 * (2 * w - b), ops=(w - b) * _hash_ops(64))
        lg_w = w.bit_length() - 1
        timed[b]["latency_bound_ms"] = _tail_latency_ms(lg_w, lg_n, HB.TAIL_LANES, clock,
                                                        launch_ms)
        timed[b]["latency_bound_before_ms"] = _tail_latency_ms(lg_w, lg_n, 1, clock, launch_ms)
        calls = (_cycled(lambda x, b=b: before(x, b), sets),
                 _cycled(lambda x, b=b: HB.merkle_forest(x, b), sets))
        timed[b]["turns_ms"] = [_device_ms(calls[i], 20) for i in (0, 1, 1, 0)]
        timed[b]["lanes_sweep_ms"] = {
            ll: _device_ms(_cycled(lambda x, b=b, ll=ll: HB.merkle_forest(x, b, lanes=ll),
                                   sets), 20) for ll in HB.LANE_CHOICES}
    print("forest: merkle_forest == plain at B x n : launches "
          + " ".join(shapes) + f", at most {list(HB.LANE_CHOICES)} lanes a hash, each call twice, and "
          "the design before == plain at each; the first and last FRI round's "
          f"forest at B={list(BATCHES)} == the host engine's trees; "
          + "; ".join(f"B={b} " + _line(e) + ", latency bound "
                      f"{e['latency_bound_ms']:.4f} (one lane a hash: "
                      f"{e['latency_bound_before_ms']:.4f}); in turn before, after, after, "
                      f"before {json.dumps([round(t, 5) for t in e['turns_ms']])}; by most "
                      f"lanes a hash {json.dumps({k: round(v, 5) for k, v in e['lanes_sweep_ms'].items()})}"
                      for b, e in timed.items())
          + f"; ms per call (device time), {clock} MHz, an empty launch {launch_ms:.5f} ms",
          flush=True)


def _check_sponge(rng, dev, results: _Results) -> None:
    """K9 against its plain version for B in SPONGE_LANES lanes at every
    pending length: a prefix of 64 + q bytes, then two roots absorbed with
    the challenge drawn (state, pending tail, copy and alpha held equal);
    timed on a root absorb with the Fibonacci prove's tail of 16 bytes."""
    from stark_tpu_torch.ops import hash_batch as HB

    def data(b, m):
        return torch.from_numpy(rng.integers(0, 256, size=(b, m), dtype=np.uint8))

    for b in SPONGE_LANES:
        for q in range(32):
            card, plain = HB.Sponge(b, dev), HB.Sponge(b, "cpu")
            prefix = data(b, 64 + q)
            card.absorb(prefix.to(dev))
            plain.absorb(prefix)
            for r in range(2):
                root = data(b, 32)
                alpha = torch.empty(b, dtype=torch.int32, device=dev)
                copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
                want = torch.empty(b, dtype=torch.int32)
                card.absorb(root.to(dev), copy, alpha)
                plain.absorb(root, alpha=want)
                for what, got, ref in (("alpha", alpha, want), ("copy", copy, root),
                                       ("state", card.state, plain.state),
                                       ("pending", card.pending[:, :q], plain.pending[:, :q])):
                    _require_equal(f"sponge B={b} q={q} root {r} {what}", got.cpu(), ref)
    timed = {}
    q = 16
    for b in SPONGE_LANES:
        sp = HB.Sponge(b, dev)
        sp.absorb(data(b, 64 + q).to(dev))
        root = data(b, 32).to(dev)
        copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
        alpha = torch.empty(b, dtype=torch.int32, device=dev)
        want = HB.sponge_absorb_plain(sp.state, sp.pending, sp.q, root)[2].to(torch.int32)
        sp.absorb(root, copy, alpha)
        timed[b] = (results if b == 1 else _Results()).add(
            HB.SPONGE, f"B={b}, a root after a {q}-byte tail", [(sp, root, copy, alpha)],
            lambda s, r, c, a: (s.absorb(r, c, a), a)[1],
            lambda s, r, c, a: HB.sponge_absorb_plain(s.state, s.pending, s.q, r)[2],
            50, nbytes=b * (2 * 32 + 2 * q + 2 * 32 + 4),
            ops=b * (OPS_ABSORB_BYTE * (32 + q) + OPS_MIX * 10), checked=(alpha, want))
    print(f"sponge: kernel == plain for B={list(SPONGE_LANES)} at every pending length "
          "0 .. 31 after two full chunks, two roots each; "
          + "; ".join(f"B={b} " + _line(e) for b, e in timed.items())
          + ", device time per call (a chain of ~10 mixes: latency)", flush=True)

    # The design before the redesign, built beside it (tools/tune_kernels.py),
    # held against the plain version, then the two in turn (before, after,
    # after, before) and the before's empty launch: the latency bound is
    # that launch plus the 10 mixes of one thread, a warp's integer-pipe
    # instruction every 2 clocks at the clock the card reports.
    before = BEFORE["sponge"]
    for b in SPONGE_LANES:
        for tail in (0, 1, 16, 31):
            old_sp, plain = HB.Sponge(b, dev), HB.Sponge(b, "cpu")
            prefix = data(b, 64 + tail)
            before(old_sp, prefix.to(dev))
            plain.absorb(prefix)
            root = data(b, 32)
            alpha = torch.empty(b, dtype=torch.int32, device=dev)
            want = torch.empty(b, dtype=torch.int32)
            before(old_sp, root.to(dev), None, alpha)
            plain.absorb(root, alpha=want)
            _require_equal(f"sponge before B={b} q={tail}", alpha.cpu(), want)
    clock = _max_clock()
    turns = {}
    for b in SPONGE_LANES:
        sp = HB.Sponge(b, dev)
        sp.absorb(data(b, 64 + q).to(dev))
        root = data(b, 32).to(dev)
        copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
        alpha = torch.empty(b, dtype=torch.int32, device=dev)
        calls = (lambda: before(sp, root, copy, alpha), lambda: sp.absorb(root, copy, alpha))
        turns[b] = [_device_ms(calls[i], 50) * 1e3 for i in (0, 1, 1, 0)]
        turns[b].append(_device_ms(lambda: before(sp, root, copy, alpha, 2), 50) * 1e3)
    latency = {b: t[4] + 10 * OPS_MIX * 2 / (clock * 1e6) * 1e6 for b, t in turns.items()}
    timed[1]["latency_bound_ms"] = latency[1] / 1e3
    print("sponge: the design before == plain (B in "
          f"{list(SPONGE_LANES)}, q in 0, 1, 16, 31); a root after a {q}-byte tail, us "
          "per call in turn (before, after, after, before; then the before's empty "
          f"launch): {json.dumps({b: [round(x, 3) for x in t] for b, t in turns.items()})}"
          f"; latency bound (that launch + 10 mixes of {OPS_MIX} integer-pipe "
          f"instructions at 2 clocks each, {clock} MHz) us "
          f"{json.dumps({b: round(x, 3) for b, x in latency.items()})}", flush=True)


def _challenge_mixes(challenges: int) -> int:
    """Mix rounds of one K15 chain, one after another: the root's chunk;
    per challenge its finalisation (the pending tail's mix where there is
    a tail, the 8 closing mixes); a mix a 32-byte chunk of challenge bytes
    absorbed."""
    return 1 + sum(8 + (1 if 8 * k % 32 else 0) for k in range(challenges)) \
        + 8 * challenges // 32


def _challenge_ops(challenges: int) -> int:
    """Integer operations of one K15 lane: its mixes and absorbed bytes (the
    root, the challenge bytes, each finalisation's tail again)."""
    tails = sum(8 * k % 32 for k in range(challenges))
    return OPS_MIX * _challenge_mixes(challenges) + OPS_ABSORB_BYTE * (
        32 + 8 * challenges + tails)


def _challenge_chain(challenges: int) -> float:
    """Integer-pipe instructions of one lane of K15's 8-lane chain: its
    mixes, the root's chunk absorbed in 5 waves, each draw's 8 bytes."""
    return (INT_PIPE_SPLIT_MIX * _challenge_mixes(challenges) + 5 * INT_PIPE_SPLIT_WAVE
            + INT_PIPE_SHORT_BYTE * 8 * challenges)


def _sample_pass(number: int, m: int) -> int:
    """Candidates a pass of K10, as csrc/hash.cu's stark_sample_indices
    sizes its block: the tests rounded up to 32, at most 128 and m, in
    whole warps of 8-lane groups."""
    want = min(-(-number // 32) * 32, 128, m)
    return max(-(-8 * want // 32) * 32, 32) // 8


def _sample_chain(q: int, passes: int) -> float:
    """Integer-pipe instructions of one lane of K10's 8-lane chain: the seed
    challenge (the q-byte tail's waves, its 8 or 9 mixes), the seed (8
    bytes, 9 mixes), the candidates' first chunk (5 waves, a mix), then a
    candidate's counter (4 bytes) and 9 mixes a pass (the walk left out)."""
    seed = (-(-q // 7) * INT_PIPE_SPLIT_WAVE + (9 if q else 8) * INT_PIPE_SPLIT_MIX
            + 8 * INT_PIPE_SHORT_BYTE + 9 * INT_PIPE_SPLIT_MIX
            + 5 * INT_PIPE_SPLIT_WAVE + INT_PIPE_SPLIT_MIX)
    return seed + passes * (4 * INT_PIPE_SHORT_BYTE + 9 * INT_PIPE_SPLIT_MIX)


def _candidates_needed(HB, sp, size, reduced, number, m) -> list[int]:
    """Per lane, the candidates K10 must hash for this run's data: up to the
    number-th accepted one (all m where the count falls short); found by
    bisection on the plain version's count."""
    need = []
    for b in range(sp.lanes):
        state, pending = sp.state[b : b + 1], sp.pending[b : b + 1]
        lo, hi = 0, m
        while lo < hi:
            mid = (lo + hi) // 2
            if int(HB.sample_indices_plain(state, pending, sp.q, size, reduced, number,
                                           mid)[1][0]) >= number:
                hi = mid
            else:
                lo = mid + 1
        need.append(lo)
    return need


def _turns(calls, reps: int) -> list[float]:
    """ms per call of (before, after), in turn: before, after, after,
    before; CUDA events around back-to-back calls (_event_ms: each call's
    device time and the card's step to the next), which spares the
    profiler windows that the copies windows after it need whole."""
    return [_event_ms(calls[i], reps) for i in (0, 1, 1, 0)]


def _chain_bounds(entry: dict, empty: float, clock: int, split_ops: float,
                  lane_mixes: int) -> str:
    """Add K15's or K10's latency bounds to ``entry`` (ms): the 8-lane
    chain's integer-pipe instructions (2 clocks each) after an empty launch,
    and the design before's, one lane's mixes of OPS_MIX instructions; and
    the roofline share (its bound over its time).  Returns their text."""
    entry["latency_bound_ms"] = empty + split_ops * 2 / (clock * 1e3)
    entry["latency_bound_before_ms"] = empty + lane_mixes * OPS_MIX * 2 / (clock * 1e3)
    entry["roofline_share"] = entry["bound_ms"] / entry["ms"]
    entry["latency_share"] = entry["latency_bound_ms"] / entry["ms"]
    return (f"latency bound {entry['latency_bound_ms']:.5f} ({split_ops:.0f} integer-pipe "
            f"instructions of an 8-lane group after an empty launch of {empty:.5f} ms, "
            f"{clock} MHz; share {entry['latency_share']:.3f}), one lane (before) "
            f"{entry['latency_bound_before_ms']:.5f} ({lane_mixes} mixes), roofline share "
            f"{entry['roofline_share']:.6f}")


def _challenge_inputs(rng, dev, b: int, ch: int) -> tuple:
    """K15's operands at (B, challenges): seeded roots, a sponge, copy,
    digests and weights buffers."""
    from stark_tpu_torch.ops import hash_batch as HB

    roots = torch.from_numpy(rng.integers(0, 256, size=(b, 32), dtype=np.uint8)).to(dev)
    return (roots, HB.Sponge(b, dev), torch.empty((b, 32), dtype=torch.uint8, device=dev),
            torch.empty((b, ch, 8), dtype=torch.uint8, device=dev),
            torch.empty((b, 2 * ch), dtype=torch.int32, device=dev))


def _sample_inputs(rng, dev, b: int, q: int, number: int) -> tuple:
    """K10's operands: a sponge of B lanes after 64 + q seeded bytes, out and
    count buffers."""
    from stark_tpu_torch.ops import hash_batch as HB

    sp = HB.Sponge(b, dev)
    sp.absorb(torch.from_numpy(rng.integers(0, 256, size=(b, 64 + q), dtype=np.uint8)).to(dev))
    return (sp, torch.empty((b, number), dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.int32, device=dev))


def _timed_challenges(results: _Results, b: int, ch: int, ops: tuple, what: str) -> dict:
    """K15 timed at (B, challenges) on ``ops`` beside its plain version and
    its bound (_Results.add)."""
    from stark_tpu_torch.ops import hash_batch as HB

    return results.add(
        HB.CHALLENGES, f"B={b}, {ch} challenges{what}", [ops],
        lambda r, s_, c, d, w: (HB.constraint_challenges(r, ch, s_, c, d, w), w)[1],
        lambda r, *rest: HB.constraint_challenges_plain(r, ch)[3], 50,
        nbytes=b * (32 + 64 + 32 + 16 * ch), ops=b * _challenge_ops(ch))


def _challenges_checked(fn, what: str, b: int, ch: int, ops: tuple, want=None) -> tuple:
    """``fn`` (constraint_challenges' signature) on zeroed outputs, held
    against the plain version (``want``, or computed here): state, pending,
    digests, weights, copy.  Returns the plain version's outputs."""
    from stark_tpu_torch.ops import hash_batch as HB

    roots, sp, copy, digests, weights = ops
    for t in (sp.state, sp.pending, copy, digests, weights):
        t.zero_()
    fn(roots, ch, sp, copy, digests, weights)
    if want is None:
        want = HB.constraint_challenges_plain(roots, ch)
    state, pending, digs, words = want
    for name, got, want in (("state", sp.state, state), ("digests", digests, digs),
                            ("pending", sp.pending[:, : sp.q], pending[:, : sp.q]),
                            ("weights", weights, words), ("copy", copy, roots)):
        _require_equal(f"constraint_challenges B={b} {ch} {name} {what}", got, want)
    return state, pending, digs, words


def _sample_checked(fn, what: str, shape: tuple, ops: tuple) -> torch.Tensor:
    """``fn`` (sample_indices' signature) on poisoned outputs, held against
    the plain version: indices and counts.  Returns the counts."""
    from stark_tpu_torch.ops import hash_batch as HB

    b, size, reduced, number, m = shape
    sp, out, count = ops
    out.fill_(-1)
    count.fill_(-1)
    fn(sp, size, reduced, number, m, out, count)
    want, want_count = HB.sample_indices_plain(sp.state, sp.pending, sp.q, size, reduced,
                                               number, m)
    _require_equal(f"sample_indices {shape} q={sp.q} {what}", out, want)
    _require_equal(f"sample_indices counts {shape} q={sp.q} {what}", count, want_count)
    return count


def _check_chained(rng, dev, results: _Results) -> None:
    """The single-fetch prove's kernels against their plain versions, at
    the paths' shapes: K15 (CHALLENGE_SHAPES: the sponge after it, the
    challenge bytes, K11's weight words, the root copy), K10 (SAMPLE_SHAPES,
    from sponges of every pending length the paths give: indices and
    counts), K11 fed K15's weights at the main, wide and batched shapes;
    the first of K15's and K10's shapes timed beside their bound and their
    latency bounds (_chain_bounds).  The designs before (and K15's other
    timed shapes) come later, in _check_chained_before: after the profiled
    paths, whose copies windows lost a memcpy record in every attempt when
    they ran here."""
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.ops import compose as CO
    from stark_tpu_torch.ops import hash_batch as HB

    clock, empty = _max_clock(), _empty_launch_ms(dev)
    lines = []
    for b, ch in CHALLENGE_SHAPES:
        ops = _challenge_inputs(rng, dev, b, ch)
        want = None
        for turn in (1, 2):
            want = _challenges_checked(HB.constraint_challenges, f"call {turn}", b, ch, ops,
                                       want)
        if (b, ch) != CHALLENGE_TIMED[0]:
            continue
        entry = _timed_challenges(results, b, ch, ops, " (Fibonacci's 3 terms)")
        entry["ptxas"] = PTXAS.get("stark_constraint_challenges_kernel")
        entry["turns_ms"] = []  # _check_chained_before
        lines.append(_line(entry) + ", " + _chain_bounds(
            entry, empty, clock, _challenge_chain(ch), _challenge_mixes(ch)))
    print(f"constraint_challenges: kernel == plain at (B, challenges) {list(CHALLENGE_SHAPES)}"
          ", each call twice; ptxas "
          f"{PTXAS.get('stark_constraint_challenges_kernel')}; " + "; ".join(lines), flush=True)

    lines = []
    for i, shape in enumerate(SAMPLE_SHAPES):
        b, size, reduced, number, m = shape
        for q in (0, 8, 16, 24):
            ops = _sample_inputs(rng, dev, b, q, number)
            for turn in (1, 2):
                count = _sample_checked(HB.sample_indices, f"call {turn}", shape, ops)
            if m < 2 * number and int(count.min()) >= number:
                raise AssertionError(f"sample_indices {b, reduced, number, m}: no shortfall")
        if i == 0:
            sp, out, count = ops
            need = _candidates_needed(HB, sp, size, reduced, number, m)
            per = _sample_pass(number, m)
            passes = max(max(-(-n // per) for n in need), 1)
            groups = max(-(-n // 32) for n in need)
            entry = results.add(
                HB.SAMPLE, f"B={b}, size 2^{size.bit_length() - 1}, reduced {reduced}, "
                f"{number} tests, {m} candidates", [ops],
                lambda s_, o, c: (HB.sample_indices(s_, size, reduced, number, m, o, c), o)[1],
                lambda s_, o, c: HB.sample_indices_plain(s_.state, s_.pending, s_.q, size,
                                                         reduced, number, m)[0], 50,
                nbytes=b * (64 + 4 * number + 4),
                ops=b * OPS_MIX * ((1 if sp.q else 0) + 17) + OPS_MIX * 10 * sum(need)
                + OPS_ABSORB_BYTE * (b * (sp.q + 8) + 36 * sum(need)))
            entry["candidates_hashed"] = need
            entry["ptxas"] = PTXAS.get("stark_sample_indices_kernel")
            entry["turns_ms"] = []  # _check_chained_before
            lines.append(_line(entry) + ", " + _chain_bounds(
                entry, empty, clock, _sample_chain(sp.q, passes),
                (1 if sp.q else 0) + 8 + 9 + 10 * groups)
                + f" (q={sp.q}; {passes} pass(es) of {per} candidates, before {groups} "
                f"group(s) of 32; candidates this run needs {need})")
    print(f"sample_indices: kernel == plain at (B, size, reduced, tests, candidates) "
          f"{list(SAMPLE_SHAPES)}, pending tails 0, 8, 16, 24, each call twice (the short "
          "candidate pool's counts below 16); ptxas "
          f"{PTXAS.get('stark_sample_indices_kernel')}; " + "; ".join(lines), flush=True)

    # K11 fed K15's weights (the single-fetch prove's form): the main,
    # wide and batched shapes.
    for model, T, b in (("fib", MAIN_T, 1), ("mds", MDS_T, 1), ("fib", BATCH_T, 8),
                        ("mds", BATCH_T, 8)):
        air = _air(model)
        prover = StarkProver(air, StarkConfig(trace_length=T, blowup=4))
        n, terms = prover.dom.N, prover.program.terms
        lde = _rand_field(rng, dev, (b, air.num_registers, n))
        roots = torch.from_numpy(rng.integers(0, 256, size=(b, 32), dtype=np.uint8)).to(dev)
        weights = torch.empty((b, 4 * terms), dtype=torch.int32, device=dev)
        HB.constraint_challenges(
            roots, 2 * terms, HB.Sponge(b, dev), torch.empty_like(roots),
            torch.empty((b, 2 * terms, 8), dtype=torch.uint8, device=dev), weights)
        alphas, betas = prover.program.challenges(weights)
        _require_equal(f"compose {model} T={T} B={b}, K15's weights",
                       prover._compose(lde if b > 1 else lde[0], weights=weights).reshape(b, n),
                       CO.compose_plain(prover.program, lde, prover.tables, alphas, betas, 4))
        del prover, lde
    print("compose: kernel fed K15's weights == plain at Fibonacci T=2^20 and MDS T=2^16 "
          "(B = 1) and the batched cells' (8, ., 2^16)", flush=True)


def _check_chained_before(rng, dev, results: _Results) -> None:
    """K15 and K10 beside their designs before (K15 with the whole chain's
    raw draws in shared memory, at most 7,264 challenges; K10 one lane a
    hash: tools/tune_kernels.py), after
    the profiled paths: the designs before against the plain versions at
    every CHALLENGE_SHAPES and SAMPLE_SHAPES shape (K10 at pending tails
    0, 8, 16, 24), K15 at CHALLENGE_TIMED beyond the first timed beside its
    bounds, then both designs in turn (before, after, after, before; CUDA
    events) at CHALLENGE_TIMED and K10's main shape; the turns go into the
    kernels line's entries.  Then K15 at CHALLENGE_LONG_SHAPES against the
    plain version, and at CHALLENGE_MANY timed beside its latency bound."""
    from stark_tpu_torch.ops import hash_batch as HB

    clock, empty = _max_clock(), _empty_launch_ms(dev)
    entries = {e["name"]: e for e in results.entries}
    before = BEFORE["challenges"]
    lines = []
    for b, ch in CHALLENGE_SHAPES:
        ops = _challenge_inputs(rng, dev, b, ch)
        _challenges_checked(before, "before", b, ch, ops)
        if (b, ch) not in CHALLENGE_TIMED:
            continue
        if (b, ch) == CHALLENGE_TIMED[0]:
            entry = entries["constraint_challenges"]
        else:
            entry = _timed_challenges(_Results(), b, ch, ops, "")
            _chain_bounds(entry, empty, clock, _challenge_chain(ch), _challenge_mixes(ch))
        entry["turns_ms"] = _turns(
            (lambda: before(*ops[:1], ch, *ops[1:]),
             lambda: HB.constraint_challenges(*ops[:1], ch, *ops[1:])), 50)
        lines.append(f"B={b}, {ch} challenges: {entry['ms']:.5f} ms (profiler), latency bound "
                     f"{entry['latency_bound_ms']:.5f} (one lane, before: "
                     f"{entry['latency_bound_before_ms']:.5f}), bound {entry['bound_ms']:.7f} "
                     f"(roofline share {entry['roofline_share']:.6f}); in turn before, after, "
                     f"after, before {json.dumps([round(t, 5) for t in entry['turns_ms']])}")
    print("constraint_challenges: the design before == plain at (B, challenges) "
          f"{list(CHALLENGE_SHAPES)}; " + "; ".join(lines)
          + " (ms a call; the turns from CUDA events around back-to-back calls)", flush=True)
    # Past one window and past the design before: the kernel against the
    # plain version (on the host: thousands of draws of small torch ops run
    # faster there), then the 3,633-term AIR's count timed alone.
    for b, ch in CHALLENGE_LONG_SHAPES:
        ops = _challenge_inputs(rng, dev, b, ch)
        want = tuple(t.to(dev) for t in HB.constraint_challenges_plain(ops[0].cpu(), ch))
        for turn in (1, 2):
            _challenges_checked(HB.constraint_challenges, f"call {turn}", b, ch, ops, want)
    print(f"constraint_challenges: kernel == plain at (B, challenges) "
          f"{list(CHALLENGE_LONG_SHAPES)}, each call twice", flush=True)
    b, ch = CHALLENGE_MANY
    ops = _challenge_inputs(rng, dev, b, ch)
    ms = _event_ms(lambda: HB.constraint_challenges(*ops[:1], ch, *ops[1:]), 20)
    bound, by = _bound(b * (32 + 64 + 32 + 16 * ch), b * _challenge_ops(ch))
    latency = empty + _challenge_chain(ch) * 2 / (clock * 1e3)
    many = {"shape": [b, ch], "ms": ms, "bound_ms": bound, "bound_by": by,
            "latency_bound_ms": latency, "latency_share": latency / ms,
            "windows": -(-ch // HB.CHALLENGE_WINDOW)}
    entries["constraint_challenges"]["many_terms"] = many
    print(f"constraint_challenges at B={b}, {ch} challenges (3,633 terms, "
          f"{many['windows']} windows of {HB.CHALLENGE_WINDOW} draws): {ms:.5f} ms (CUDA "
          f"events, 20 back-to-back calls), latency bound {latency:.5f} "
          f"({_challenge_chain(ch):.0f} integer-pipe instructions of an 8-lane group after "
          f"an empty launch of {empty:.5f} ms, {clock} MHz; share {latency / ms:.3f}), "
          f"bound {bound:.7f} by {by}", flush=True)

    before = BEFORE["sample"]
    for i, shape in enumerate(SAMPLE_SHAPES):
        for q in (0, 8, 16, 24):
            ops = _sample_inputs(rng, dev, shape[0], q, shape[3])
            _sample_checked(before, "before", shape, ops)
            if i == 0 and q == 24:
                _, size, reduced, number, m = shape
                entry = entries["sample_indices"]
                entry["turns_ms"] = _turns(
                    (lambda: before(*ops[:1], size, reduced, number, m, *ops[1:]),
                     lambda: HB.sample_indices(*ops[:1], size, reduced, number, m, *ops[1:])),
                    50)
    print(f"sample_indices: the design before == plain at {list(SAMPLE_SHAPES)}, pending "
          f"tails 0, 8, 16, 24; at {SAMPLE_SHAPES[0]} (q=24) {entry['ms']:.5f} ms (profiler), "
          f"latency bound {entry['latency_bound_ms']:.5f} (one lane, before: "
          f"{entry['latency_bound_before_ms']:.5f}); in turn before, after, after, before "
          f"{json.dumps([round(t, 5) for t in entry['turns_ms']])}", flush=True)


def _air(model: str):
    """An AIR by name: the registry's, or "wide", the 65-register AIR of
    tests/test_torch_wide.py (register i counts up by i + 1 a row from i)."""
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.models.air import Air, BoundaryConstraint

    if model == "many":
        return _many_terms_air()
    if model.startswith("distinct"):
        from stark_tpu_torch.tools.tune_kernels import distinct_air

        return distinct_air(int(model[len("distinct"):]))
    if model != "wide":
        return get_model(model)[0]

    class WideCounterAir(Air):
        num_registers = WIDE_REGISTERS
        frame_offsets = (0, 1)
        constraint_degree = 1

        def transition_constraints(self, frame, ops):
            return [ops.sub(ops.sub(frame[1][i], frame[0][i]), ops.const(i + 1, frame[0][i]))
                    for i in range(WIDE_REGISTERS)]

        def boundary_constraints(self, trace_length):
            return [BoundaryConstraint(row=0, register=i, value=i)
                    for i in range(WIDE_REGISTERS)]

    return WideCounterAir()


def _many_terms_air():
    """tests/test_torch_many_terms.py's AIR (MANY_TRANSITIONS above)."""
    from stark_tpu_torch.models.air import Air, BoundaryConstraint

    class ManyTermsAir(Air):
        num_registers = 1
        frame_offsets = (0, 1)
        constraint_degree = 1

        def transition_constraints(self, frame, ops):
            x0, x1 = frame[0][0], frame[1][0]
            step = ops.sub(ops.sub(x1, x0), ops.const(1, x0))
            return [ops.mul(ops.const(i + 1, x0), step) for i in range(MANY_TRANSITIONS)]

        def boundary_constraints(self, trace_length):
            return [BoundaryConstraint(row=0, register=0, value=MANY_START)]

    return ManyTermsAir()


def _drive_many_terms() -> dict:
    """The 3,633-term AIR on the single-fetch path: K15 draws 7,266
    challenges in windows, K11 (its own generated source, the table form)
    reads their weight words; first K11 against its plain version at the
    prove's shape and B = 2, each call twice; the proof's sha256 equal to
    stark_tpu's, verified, one read from the card, K15 and K11 launched
    once (the counts set to 0 just before the prove and read just after);
    returns the counts."""
    from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
    from stark_tpu_torch.ops import compose as CO
    from stark_tpu_torch.ops import cuda

    air = _many_terms_air()
    cfg = StarkConfig(**MANY_CFG)
    prover = StarkProver(air, cfg)
    prog = prover.program
    if not prog.table:
        raise AssertionError(f"3,633 terms: the straight-line form ({prog.lines} lines)")
    rng = np.random.default_rng(MANY_TRANSITIONS)
    lde = _rand_field(rng, prover.device, (2, 1, prover.dom.N))
    al, be = (rng.integers(0, 998244353, size=(2, prog.terms)) for _ in range(2))
    want = CO.compose_plain(prog, lde, prover.tables, al, be, cfg.blowup)
    for turn in (1, 2):
        _require_equal(f"compose (table form) many T=64 B=2 call {turn}",
                       prover._compose(lde, al, be), want)
    t = MANY_CFG["trace_length"]
    trace = ((MANY_START + np.arange(t, dtype=np.uint64)) % 998244353)[:, None]
    walls = []
    for _ in range(3):
        cuda.reset_launches()
        proofs = []
        t0 = time.perf_counter()
        reads = _reads(lambda: proofs.append(prover.prove(trace)))
        walls.append(time.perf_counter() - t0)
        counts = cuda.launch_counts()
    got = hashlib.sha256(proofs[0]).hexdigest()
    if got != MANY_SHA256 or reads != 1 or counts["constraint_challenges"] != 1 or \
            counts["compose"] != 1 or counts["sample_indices"] != 1:
        raise AssertionError(f"3,633 terms: sha256 {got}, reads {reads}, launches {counts}")
    if not StarkVerifier(air, cfg).verify(proofs[0]):
        raise AssertionError("3,633 terms: proof rejected")
    print(f"3,633 terms (7,266 constraint challenges), T={t}: K11 (table form) == plain "
          f"at B = 2, each call twice; sha256 == stark_tpu's, verified, 1 read, launches "
          f"{json.dumps(counts)}; K11 source {len(prog.source)} bytes, the table form of "
          f"{prog.lines} straight-line lines ({prog.sha256}; nvcc "
          f"{CO.BUILD_SECONDS[prog.sha256]:.1f} s in phase 2); prove walls s "
          f"{json.dumps([round(w, 4) for w in walls])} (the host's replay of 7,266 draws, "
          "each over the whole transcript, among them)", flush=True)
    return counts


def _drive_bench() -> None:
    """``python -m stark_tpu_torch bench --quick`` as a user runs it, alone
    on the card: exit 0 and a last line with bench.py's metric and a
    positive value, printed here."""
    (rc, out, err), = _cli([["bench", "--quick"]])
    lines = out.strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else {}
    if rc != 0 or line.get("metric") != "NTT points/s/chip at 2^22" or \
            not line.get("value", 0) > 0:
        raise AssertionError(f"bench --quick: exit {rc}, {out}{err}")
    print("bench --quick: " + lines[-1], flush=True)


def _compose_program(model: str, T: int, blowup: int, table: bool | None = None):
    from stark_tpu_torch.ops import compose as CO
    from stark_tpu_torch.stark import StarkConfig, _Domain

    air = _air(model)
    return CO.ComposeProgram(air, _Domain(StarkConfig(trace_length=T, blowup=blowup),
                                          air).boundary, table=table)


def _compose_programs() -> dict:
    """{model: ComposeProgram} of every AIR that COMPOSE_CASES drives."""
    programs = {}
    for model, T, blowup, _ in COMPOSE_CASES:
        prog = _compose_program(model, T, blowup)
        programs.setdefault(prog.sha256, (model, prog))
    return dict(programs.values())


def _boundary_words(rng, dev, prog, b: int) -> torch.Tensor:
    """A random row of boundary values for each of ``b`` proofs, as the
    (B, max(boundaries, 1)) words K11 reads (ComposeProgram.values)."""
    return torch.from_numpy(prog.values(
        rng.integers(0, 998244353, size=(b, len(prog.boundary))))).to(dev)


def _check_compose(rng, dev, results: _Results) -> None:
    """K11 against its plain version (the eager compose on the card) at
    every case of COMPOSE_CASES, each call twice, each proof with its own
    random boundary values; the first cases timed, with the L2 flushed
    before each call, against their bound: one read of the LDE rows the
    AIR reads, of each table and of the boundary values, one write, or
    the generated body's operations; each timed case also in turn with
    the design before (every sum of the generated body eager, the default
    statement's values compiled in)."""
    from stark_tpu_torch import StarkConfig, StarkProver
    from stark_tpu_torch.ops import compose as CO

    flush = _L2Flush(dev)
    timed = []
    for case, (model, T, blowup, b) in enumerate(COMPOSE_CASES):
        air = _air(model)
        prover = StarkProver(air, StarkConfig(trace_length=T, blowup=blowup))
        prog, tables, n = prover.program, prover.tables, prover.dom.N
        lde = _rand_field(rng, dev, (b, air.num_registers, n))
        al = rng.integers(0, 998244353, size=(b, prog.terms))
        be = rng.integers(0, 998244353, size=(b, prog.terms))
        args = (lde[0], al[0], be[0]) if b == 1 else (lde, al, be)
        values = _boundary_words(rng, dev, prog, b)

        def kernel(x, a, w, prover=prover, values=values):
            return prover._compose(x, a, w, values=values)

        def plain(x, a, w, prog=prog, tables=tables, blowup=blowup, values=values):
            return CO.compose_plain(prog, x, tables, a, w, blowup, values=values)

        want = plain(*args)
        for turn in (1, 2):
            _require_equal(f"compose {model} T={T} B={b} call {turn}", kernel(*args), want)
        if case < COMPOSE_TIMED:
            shape = f"{model} T=2^{T.bit_length() - 1}, (B, c, N) = ({b}, {air.num_registers}, 2^{n.bit_length() - 1})"
            entry = (results if case == 0 else _Results()).add(
                CO.COMPOSE, shape, [args], kernel, plain, 50,
                nbytes=4 * n * (b * prog.registers_read() + prog.table_loads() + b)
                + 4 * values.numel(),
                ops=b * n * prog.operations(), flush=flush)
            entry["operations_per_point"] = prog.operations()
            # The design before (eager sums; built from tools/tune_kernels.py,
            # the default statement's values compiled in) held against plain
            # at those values, then in turn.
            old = BEFORE["compose"][(model, T)]
            _require_equal(f"compose before {model} T={T} B={b}",
                           old(args[0], tables, args[1], args[2], blowup),
                           CO.compose_plain(prog, *args[:1], tables, *args[1:], blowup))
            calls = (lambda: (flush(), old(args[0], tables, args[1], args[2], blowup)),
                     lambda: (flush(), kernel(*args)))
            entry["turns_ms"] = [_device_ms(calls[i], 50, skip=flush.skip)
                                 for i in (0, 1, 1, 0)]
            timed.append(entry)
        del prover, lde, want
    # The table form at TABLE_CASES, in turn with the design before it.
    entry = next(e for e in results.entries if e["name"] == CO.COMPOSE.name)
    entry["table_form"] = {}
    for model, T, b in TABLE_CASES:
        air = _air(model)
        prover = StarkProver(air, StarkConfig(trace_length=T, blowup=4))
        prog, tables, n = _compose_program(model, T, 4, table=True), prover.tables, prover.dom.N
        lde = _rand_field(rng, dev, (b, air.num_registers, n))
        al, be = (rng.integers(0, 998244353, size=(b, prog.terms)) for _ in range(2))
        words = torch.from_numpy(prog.weights(al, be).view(np.int32)).to(dev)
        values = _boundary_words(rng, dev, prog, b)
        want = CO.compose_plain(prog, lde, tables, al, be, 4, values=values)

        def table_call(prog=prog, lde=lde, tables=tables, words=words, values=values):
            return CO.compose(prog, lde, tables, None, None, 4, weights=words, values=values)

        for turn in (1, 2):
            _require_equal(f"compose table form {model} T={T} B={b} call {turn}", table_call(),
                           want)
        # The form before compiles the default statement's values in.
        old = BEFORE["table"][(model, T)]
        _require_equal(f"compose table form before {model} T={T} B={b}",
                       old(lde, tables, words, 4), CO.compose_plain(prog, lde, tables, al, be, 4))
        calls = (lambda: (flush(), old(lde, tables, words, 4)), lambda: (flush(), table_call()))
        nbytes = 4 * n * (b * prog.registers_read() + prog.table_loads() + b) + 4 * values.numel()
        shape = f"{model} T=2^{T.bit_length() - 1}, (B, c, N) = ({b}, {air.num_registers}, " \
                f"2^{n.bit_length() - 1})"
        entry["table_form"][shape] = {
            "turns_ms": [_device_ms(calls[i], 20, skip=flush.skip) for i in (0, 1, 1, 0)],
            "bound_ms": _bound(nbytes, b * n * min(prog.operations(),
                                                   prover.program.operations()))[0],
            "steps": len(prog.form.steps) - CO.SPARE_STEPS, "slots": prog.form.slots,
            "threads": prog.form.threads}
        del prover, lde, want
    print("compose, the table form: kernel == plain, each call twice, each proof its own "
          "random boundary values, L2 flushed before each "
          "timed call, in turn with the table form before its redesign (before, after, after, "
          "before) ms: "
          + json.dumps({k: {**v, "turns_ms": [round(t, 5) for t in v["turns_ms"]]}
                        for k, v in entry["table_form"].items()}), flush=True)
    print(f"compose: kernel == plain (the eager compose on the card), each call twice, at "
          f"(model, T, blowup, B) {[c for c in COMPOSE_CASES]}, each proof its own random "
          "boundary values; L2 flushed before each "
          "timed call: " + "; ".join(
              f"{e['shape']}: " + _line(e) + ", in turn with the design before (before, "
              f"after, after, before) {json.dumps([round(t, 5) for t in e['turns_ms']])}"
              for e in timed) + ", device time per call", flush=True)


class _L2Flush:
    """Overwrites 128 MiB, more than twice the card's 50 MB L2, so that the
    call after it reads its operands from device memory; its kernel is left
    out of the timed device time by name."""

    skip = ("bitwise_not",)

    def __init__(self, dev):
        self.buf = torch.zeros(CYCLE_BYTES // 4, dtype=torch.int32, device=dev)

    def __call__(self):
        self.buf.bitwise_not_()


def _check_witness(rng, dev, results: _Results) -> None:
    """K12 against its plain version at every length the paths and pinned
    proofs use and at lengths that cut the last block; timed at the main
    path's and the wide path's shapes."""
    from stark_tpu_torch import native
    from stark_tpu_torch.models import examples as ex
    from stark_tpu_torch.models import fibonacci as FIB
    from stark_tpu_torch.models.fibonacci import (
        fibonacci_seeds,
        fibonacci_segment_cols_device,
        fibonacci_trace_cols_device,
        fibonacci_trace_mod_p,
    )
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.ops import witness as W

    def fib_seeds(T):
        seeds, nb = fibonacci_seeds(T)
        return torch.from_numpy(seeds.view(np.int32)).to(dev), nb

    fib_dev = cuda.device_or_raise(dev, "fib_expand")
    starts = [(1, 1), (0, 0), (998244352, 998244352),
              tuple(int(v) for v in rng.integers(0, 998244353, 2))]
    for T in FIB_WITNESS_LENGTHS:
        basis, _, nb = FIB._basis(T, fib_dev)
        for start in starts:
            for turn in (1, 2):
                _require_equal(f"fib_expand T={T} start {start} call {turn}",
                               W.fib_expand(basis, nb, T, start),
                               W.fib_expand_plain(basis, nb, T, start))
        if T <= 1 << 16:
            host = torch.from_numpy(fibonacci_trace_mod_p(T).T.astype(np.int32))
            _require_equal(f"fibonacci_trace_cols_device T={T}",
                           fibonacci_trace_cols_device(T).cpu(), host)
            host = torch.from_numpy(fibonacci_trace_mod_p(T, starts[3]).T.astype(np.int32))
            _require_equal(f"fibonacci_segment_cols_device T={T}",
                           fibonacci_segment_cols_device(T, starts[3])[0].cpu(), host)
    consts = _rand_field(rng, dev, (72,))
    for T, block in MDS_WITNESS_SHAPES:
        nb = -(-T // block)
        seeds = _rand_field(rng, dev, (nb, 8))
        for turn in (1, 2):
            _require_equal(f"mds_expand T={T} block={block} call {turn}",
                           W.mds_expand(consts, seeds, block, T),
                           W.mds_expand_plain(consts, seeds, block, T))
        if T <= 4096:
            host = torch.from_numpy(ex.mds_square_trace(T).T.astype(np.int32))
            _require_equal(f"mds_square_trace_cols_device T={T} block={block}",
                           ex.mds_square_trace_cols_device(T, block).cpu(), host)

    basis, _, nb = FIB._basis(MAIN_T, fib_dev)
    fib = results.add(
        W.FIB_EXPAND, "T=2^20", [(basis,)],
        lambda b: W.fib_expand(b, nb, MAIN_T, starts[3]),
        lambda b: W.fib_expand_plain(b, nb, MAIN_T, starts[3]),
        50, nbytes=4 * MAIN_T + 4 * basis.numel(), ops=OPS_FIB_EXPAND * MAIN_T)
    # The kernels before the basis (the seeds of one run, made on the host)
    # and before its redesign (an element a thread), built beside it, on the
    # default run: the three in turn (before, seeds, in use, in use, seeds,
    # before).
    before_fn, seeds_fn = BEFORE["fib_expand"], BEFORE["fib_expand_seeds"]
    for T in FIB_WITNESS_LENGTHS:
        s, n = fib_seeds(T)
        b, _, nb_t = FIB._basis(T, fib_dev)
        want = W.fib_expand_plain(b, nb_t, T, (1, 1))
        _require_equal(f"fib_expand before T={T}", before_fn(s, n, T), want)
        _require_equal(f"fib_expand seeds T={T}", seeds_fn(s, n, T), want)
    seeds, _ = fib_seeds(MAIN_T)
    calls = {"before": lambda: before_fn(seeds, nb, MAIN_T),
             "seeds": lambda: seeds_fn(seeds, nb, MAIN_T),
             "basis": lambda: W.fib_expand(basis, nb, MAIN_T, starts[3])}
    turns = [_device_ms(calls[key], 50)
             for key in ("before", "seeds", "basis", "basis", "seeds", "before")]
    print("witness: fib_expand at T=2^20, device time per call in turn (ms), the "
          "design before (one thread an element), the seeds design (the host's seeds "
          "of one run), the basis entry in use twice, the seeds design, the one "
          f"before: {json.dumps([round(t, 5) for t in turns])}", flush=True)
    m, rc = np.array(ex._MDS), np.array(ex._RC)
    nb = MDS_T // MDS_BLOCK
    walked = native.mds_seed_walk(m, rc, np.arange(1, 9), nb, MDS_BLOCK, 998244353)
    mds_consts = torch.from_numpy(
        np.concatenate([m.reshape(-1), rc]).astype(np.uint32).view(np.int32)).to(dev)
    mds_seeds = torch.from_numpy(walked.view(np.int32)).to(dev)
    mds = results.add(
        W.MDS_EXPAND, f"T=2^16, block {MDS_BLOCK}", [(mds_consts, mds_seeds)],
        lambda c, s: W.mds_expand(c, s, MDS_BLOCK, MDS_T),
        lambda c, s: W.mds_expand_plain(c, s, MDS_BLOCK, MDS_T), 50,
        nbytes=32 * MDS_T + 32 * nb + 4 * 72, ops=OPS_MDS_STEP * MDS_T)
    before = _bound(32 * MDS_T + 32 * nb + 4 * 72, OPS_MDS_STEP_BEFORE * MDS_T)
    print(f"witness: fib_expand == plain at T={list(FIB_WITNESS_LENGTHS)} and start pairs "
          f"{starts}, mds_expand "
          f"== plain at (T, block) {list(MDS_WITNESS_SHAPES)}, each call twice; the "
          "device columns == the host traces up to T=2^16 / 4096; "
          + _line(fib) + "; " + _line(mds) + "; device time per call; mds_expand's "
          f"bound on the operation count of the thread-per-block design "
          f"({OPS_MDS_STEP_BEFORE} a step, now {OPS_MDS_STEP}): {before[0]:.4f} ms by "
          f"{before[1]}", flush=True)


@contextlib.contextmanager
def _recording_gathers(plans: list):
    """Every GatherPlan that ops.gather.gather is handed meanwhile is
    appended to ``plans`` (the plan keeps its sources alive), and every
    RulePlan run (the single-fetch prove's) as (plan, its sources, a copy
    of its index buffer)."""
    from stark_tpu_torch.ops import gather as G

    launch, run = G.gather, G.RulePlan.run

    def recording(plan):
        plans.append(plan)
        return launch(plan)

    def recording_run(plan, sources, idx, out):
        got = run(plan, sources, idx, out)
        plans.append((plan, list(sources), idx.clone()))
        return got

    G.gather, G.RulePlan.run = recording, recording_run
    try:
        yield
    finally:
        G.gather, G.RulePlan.run = launch, run


def _check_plans(what: str, plans: list) -> str:
    """K13 against its plain version on every recorded plan (a rule plan
    on its sources and indices); a summary."""
    from stark_tpu_torch.ops import gather as G

    shapes = []
    for plan in plans:
        if isinstance(plan, tuple):
            rules, sources, idx = plan
            out = torch.empty(rules.words, dtype=torch.int32, device=idx.device)
            _require_equal(f"query_gather (rule slots) of {what}",
                           rules.run(sources, idx, out), G.rules_plain(rules, sources, idx))
            shapes.append(f"rule slots: {len(sources)} sources, "
                          f"{sum(r.k for _, r, _ in rules.requests)} requests, "
                          f"{rules.words} words")
            continue
        _require_equal(f"query_gather of {what}", G.gather(plan), G.gather_plain(plan))
        n_req = sum(idx.size for _, idx, _ in plan.requests)
        shapes.append(f"{len(plan.sources)} sources, {n_req} requests, {plan.words} words")
    return "; ".join(shapes)


def _table_bytes(plan) -> tuple[int, list[int]]:
    """(the bytes of ``plan``'s table as encoded: header, sources, slots,
    tasks and indices of every launch; the parameter struct of each)."""
    launches = plan.encode(0)
    used = sum(4 * (8 + 4 * int(p[0]) + 4 * int(p[1]) + int(p[2]) + int(p[3]))
               for p in launches)
    return used, [p.nbytes for p in launches]


def _check_split_gather(rng, dev, results: _Results) -> None:
    """K13 on a synthetic plan whose table does not fit one launch's
    parameters: value requests of 1, 3 and 40 words and paths of depth 1,
    4 and 10, SPLIT_REQUESTS of each, against the plain version; the plan
    must go out in several launches into the one output buffer."""
    from stark_tpu_torch.merkle import MerkleTree
    from stark_tpu_torch.ops import cuda
    from stark_tpu_torch.ops import gather as G

    n = 1 << 10
    plan = G.GatherPlan()
    for shape in (n, (3, n), (40, n)):
        plan.values(_rand_field(rng, dev, shape), rng.integers(0, n, size=SPLIT_REQUESTS))
    for depth in (1, 4, 10):
        stack = MerkleTree.from_leaf_values(_rand_field(rng, dev, (1 << depth,)))._stack
        plan.paths(stack, rng.integers(0, 1 << depth, size=SPLIT_REQUESTS))
    want = G.gather_plain(plan)
    cuda.reset_launches()
    for turn in (1, 2):
        _require_equal(f"query_gather, split plan, call {turn}", G.gather(plan), want)
    launches = cuda.launch_counts()["query_gather"] // 2
    if launches < 2:
        raise AssertionError(f"query_gather: the split plan took {launches} launch(es)")
    used, sizes = _table_bytes(plan)
    print(f"query_gather == plain on a split plan ({len(plan.sources)} sources, "
          f"{6 * SPLIT_REQUESTS} requests, {plan.words} words, table {used} bytes): "
          f"{launches} launches of {sizes} parameter bytes, each call twice", flush=True)


def _time_gather(name, plan, results: _Results | None, dev) -> dict:
    """K13 timed on a prove's own plan, with the L2 flushed before each
    call (its sources are a prove's trees and codewords: too large to
    cycle); also the kernel alone, without the host's encoding and the
    output's allocation."""
    from stark_tpu_torch.ops import gather as G

    words = plan.words
    table_bytes, sizes = _table_bytes(plan)
    flush = _L2Flush(dev)
    entry = (results or _Results()).add(
        G.QUERY_GATHER, name, [(plan,)], G.gather, G.gather_plain, 50,
        nbytes=8 * words + table_bytes, ops=0, flush=flush)
    events = _profile(lambda: (flush(), G.gather(plan)), 50, skip=flush.skip)
    kernel_us = sum(_device_us(e) for e in events if G.QUERY_GATHER.kernel_symbol in e.key)
    # What a launch costs before the plan's size counts: one request.
    one = G.GatherPlan()
    one.values(plan.sources[0], [0])
    one_ms = _device_ms(lambda: (flush(), G.gather(one)), 50, skip=flush.skip)
    n_req = sum(idx.size for _, idx, _ in plan.requests)
    print(f"query_gather, {name}: {n_req} requests, {words * 4} bytes gathered, table "
          f"{table_bytes} bytes as encoded, launched as {sizes} parameter bytes; "
          + _line(entry) + f"; the kernel alone {kernel_us / 50 / 1e3:.4f} ms; one "
          f"request alone {one_ms:.4f} ms; device time per call, L2 flushed before each",
          flush=True)
    return entry


def _time_rule_gather(name, record, results: _Results | None, dev) -> dict:
    """K13's rule form timed on a single-fetch prove's own plan, sources and
    device indices, the L2 flushed before each call; its bound the words
    gathered, read once and written once, and the encoded table."""
    from stark_tpu_torch.ops import gather as G

    plan, sources, idx = record
    out = torch.empty(plan.words, dtype=torch.int32, device=dev)
    params = plan.encode(sources, idx.data_ptr(), out.data_ptr())
    table_bytes = sum(4 * (8 + 4 * int(p[0]) + 4 * int(p[1]) + int(p[2]) + int(p[3]))
                      for p in params)
    flush = _L2Flush(dev)
    entry = (results or _Results()).add(
        G.QUERY_GATHER, f"{name} (rule slots)", [(sources, idx, out)],
        lambda s_, i, o: plan.run(s_, i, o), lambda s_, i, o: G.rules_plain(plan, s_, i), 50,
        nbytes=8 * plan.words + table_bytes + idx.numel() * 4, ops=0, flush=flush)
    print(f"query_gather, {name}, rule slots: {sum(r.k for _, r, _ in plan.requests)} "
          f"requests, {4 * plan.words} bytes gathered, table {table_bytes} bytes as encoded "
          f"(no index), launched as {[p.nbytes for p in params]} parameter bytes; "
          + _line(entry) + "; device time per call, L2 flushed before each", flush=True)
    return entry


def _reads(call) -> int:
    """Reads from the card (ops.gather.to_host calls) in one ``call()``."""
    from stark_tpu_torch.ops import gather as G

    count, to_host = [0], G.to_host

    def counted(t, **kw):
        count[0] += 1
        return to_host(t, **kw)

    G.to_host = counted
    try:
        call()
    finally:
        G.to_host = to_host
    return count[0]


def _three_reads(prover, call):
    """``call`` run on ``prover``'s three-read path (Fri.fused_round False on
    its FRI, for the call only)."""
    def run():
        prover.fri.fused_round = False
        try:
            return call()
        finally:
            del prover.fri.fused_round
    return run


def _idle_gaps(name, call, median_ms: float) -> dict:
    """One profiled call's device timeline (after a warm-up call): the
    device's busy time (the union of its activities' spans), its share of
    ``median_ms`` (the unprofiled calls' median wall), and the idle gaps
    between activities from the first's start to the last's end: how many
    exceed 10 us, their sum, the five largest with the activities on either
    side."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    call()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        dev = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if dev:
            break
        _retaken[0] += 1
    else:
        raise AssertionError(f"{name}: no device activity in a profiled call")
    busy, gaps, end, last = 0.0, [], None, None
    for e in dev:
        start, stop = e.time_range.start, e.time_range.end
        if end is not None and start > end:
            gaps.append((start - end, last, e.name))
        if end is None or stop > end:
            busy += stop - max(start, end if end is not None else start)
            end, last = stop, e.name
    gaps.sort(key=lambda g: -g[0])
    span = end - dev[0].time_range.start
    big = [g for g in gaps if g[0] > 10]
    out = {"busy_ms": busy / 1e3, "busy_share": busy / 1e3 / median_ms,
           "span_ms": span / 1e3, "gaps_over_10us": len(big),
           "idle_over_10us_ms": sum(g[0] for g in big) / 1e3,
           "idle_ms": sum(g[0] for g in gaps) / 1e3}
    print(f"{name}: one profiled call, {len(dev)} device activities over {span / 1e3:.4f} "
          f"ms; busy {busy / 1e3:.4f} ms, share {out['busy_share']:.4f} of the median wall "
          f"{median_ms:.4f} ms; idle {out['idle_ms']:.4f} ms in {len(gaps)} gaps, "
          f"{len(big)} over 10 us summing {out['idle_over_10us_ms']:.4f} ms; largest: "
          + "; ".join(f"{g / 1e3:.4f} ms after {a[:40]} before {b[:40]}"
                      for g, a, b in gaps[:5]), flush=True)
    return out


def _in_turn(name, single_call, three_call, runs: int) -> dict:
    """The single-fetch path and the three reads (fused_round False) on the
    same prover and inputs, in turn (single-fetch, three reads, three
    reads, single-fetch), ``runs`` synchronised calls a turn: each turn's
    median wall (ms); then one profiled call of each, its busy share and
    idle gaps (_idle_gaps).  A record of this run, not a claim."""
    calls = {"single-fetch": single_call, "three reads": three_call}
    turns = []
    for key in ("single-fetch", "three reads", "three reads", "single-fetch"):
        walls = []
        for _ in range(runs):
            t0 = time.perf_counter()
            calls[key]()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        turns.append((key, float(np.median(walls))))
    medians = {key: float(np.median([ms for k, ms in turns if k == key])) for key in calls}
    print(f"{name}, in turn ({runs} synchronised calls a turn): median wall ms "
          + json.dumps([[k, round(ms, 4)] for k, ms in turns]), flush=True)
    gaps = {key: _idle_gaps(f"{name}, {key}", fn, medians[key]) for key, fn in calls.items()}
    return {"turns_ms": turns, "gaps": gaps}


def _query_split(name, prover, witness, runs: int = 5) -> None:
    """Host time of the parts of the fri_query phase, the median of ``runs``
    synchronised proves: the plan build (the phase's start to the fetch),
    the table's encoding, the launch call, the fetch's wait (the rest of
    the fetch: output and pinned buffers, the copy, the event) and the
    emission (the fetch's return to the phase's end)."""
    from stark_tpu_torch.ops import gather as G
    from stark_tpu_torch.utils.profiling import PhaseTimer

    marks: dict[str, float] = {}

    def timed(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                marks[key] = marks.get(key, 0.0) + time.perf_counter() - t0
        return call

    class Marked(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, phase_name):
            if phase_name == "fri_query":
                marks["start"] = time.perf_counter()
            with super().phase(phase_name):
                yield
            if phase_name == "fri_query":
                marks["end"] = time.perf_counter()

    fetch, encode, launch = G.fetch, G.GatherPlan.encode, G.QUERY_GATHER.launch

    def marked_fetch(plan):
        marks["fetch_in"] = time.perf_counter()
        try:
            return fetch(plan)
        finally:
            marks["fetch_out"] = time.perf_counter()

    parts: dict[str, list[float]] = {}
    G.fetch, G.GatherPlan.encode = marked_fetch, timed("encode", encode)
    G.QUERY_GATHER.launch = timed("launch", launch)  # shadows the method meanwhile
    try:
        for _ in range(runs):
            marks.clear()
            prover.prove(trace_cols=witness(), timer=Marked(sync=torch.cuda.synchronize))
            inside = marks["fetch_out"] - marks["fetch_in"]
            for part, sec in (
                    ("phase", marks["end"] - marks["start"]),
                    ("plan build", marks["fetch_in"] - marks["start"]),
                    ("table encoding", marks["encode"]),
                    ("launch", marks["launch"]),
                    ("fetch wait", inside - marks["encode"] - marks["launch"]),
                    ("emission", marks["end"] - marks["fetch_out"])):
                parts.setdefault(part, []).append(sec * 1e3)
    finally:
        G.fetch, G.GatherPlan.encode = fetch, encode
        del G.QUERY_GATHER.launch
    print(f"{name} fri_query split (ms, host clock, median and max of {runs} proves): "
          + json.dumps({k: [round(float(np.median(v)), 4), round(max(v), 4)]
                        for k, v in parts.items()}), flush=True)


def _prove_checked(name, prover, verifier, witness, want_sha, expect, cuda):
    """One counted witness -> prove -> verify: counts set to 0 just before,
    read just after; the proof must verify, match ``want_sha``, have
    launched every kernel in ``expect`` and the query gather once.  K13 is
    then held against its plain version on the prove's plan.  Returns
    (proof, counts, plan)."""
    from stark_tpu_torch.ops import compose as CO

    plans: list = []
    eager: list = []
    plain = CO.compose_plain
    CO.compose_plain = lambda *a, **k: eager.append(1) or plain(*a, **k)
    try:
        cuda.reset_launches()
        with _recording_gathers(plans):
            proof = prover.prove(trace_cols=witness())
        accepted = verifier.verify(proof)
        counts = cuda.launch_counts()
    finally:
        CO.compose_plain = plain
    if eager or counts["compose"] != 1:
        raise AssertionError(f"{name}: {len(eager)} eager composes and {counts['compose']} "
                             "K11 launches in a prove, not 0 and 1")
    if not accepted:
        raise AssertionError(f"{name}: proof rejected")
    sha = hashlib.sha256(proof).hexdigest()
    if sha != want_sha:
        raise AssertionError(f"{name}: proof sha256 {sha} != pinned {want_sha}")
    missing = [k for k in expect if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    if counts["query_gather"] != 1 or len(plans) != 1:
        raise AssertionError(f"{name}: {counts['query_gather']} query gathers in a prove")
    lde = "ntt_pass1_lde_lazy" if prover.lazy_ntt else "ntt_pass1_lde"
    if counts["lde_pad_scale"] != 0 or counts[lde] != 1:
        raise AssertionError(f"{name}: {counts['lde_pad_scale']} K14 and {counts[lde]} "
                             f"{lde} launches in a prove, not 0 and 1")
    print(f"{name}: query_gather == plain on the prove's plan ("
          + _check_plans(name, plans) + ")", flush=True)
    return proof, counts, plans[0]


def _check_chain(name, counts, rounds: int, batches: int = 1, single: bool = True) -> None:
    """The FRI commit chain's launches: K4-dyn once a round but the last
    (its root's absorb, the challenge and the fold in one launch) and K9
    for the last round's roots; on the single-fetch path (``single``) K15
    (the constraint challenges, whose sponge the chain goes on from) and
    K10 (the query indices) once a batch, on the three-read path K9 for the
    transcript's prefix too."""
    want = {"sponge_absorb": (1 if single else 2) * batches,
            "fri_fold_dyn": (rounds - 1) * batches,
            "constraint_challenges": batches if single else 0,
            "sample_indices": batches if single else 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: chain launches {got}, not {want}")


def _profiled_prove(name, prover, witness, counts, median_wall, cuda) -> dict:
    """Profile one witness + prove; every kernel it launched must show
    device time under its own name.  Prints that prove's device view and,
    beside K8's time in it, the bound of each of its K8 launches at the
    launch's own width, summed.  Returns {kernel: ms}."""
    from stark_tpu_torch.ops import hash_batch as HB

    widths = []
    launch = HB.MERKLE_TAIL.launch

    def recording(device, nodes, out, width, *rest):
        widths.append(width)
        launch(device, nodes, out, width, *rest)

    def prove():
        widths.clear()  # keeps those of the last prove: the profiled one
        prover.prove(trace_cols=witness())

    HB.MERKLE_TAIL.launch = recording  # shadows the method meanwhile
    try:
        kernel_ms = _profiled(name, prove, counts, median_wall, cuda)
    finally:
        del HB.MERKLE_TAIL.launch
    bound_ms, bound_before = (
        sum(_bound(32 * (2 * w - 1), (w - 1) * _hash_ops(64, mix_ops))[0]
            for w in widths)
        for mix_ops in (OPS_MIX, OPS_MIX_BEFORE))
    lde = "ntt_pass1_lde_lazy" if prover.lazy_ntt else "ntt_pass1_lde"
    ntt_ms = sum(ms for k, ms in kernel_ms.items() if k.startswith("ntt_") and k != lde)
    print(f"{name}: the lde phase on the device in the profiled prove: {lde} (the pad, the "
          f"scale and pass 1) {kernel_ms[lde]:.4f} ms ({counts[lde]} launch), lde_pad_scale "
          f"{counts['lde_pad_scale']} launches, the other K1-K3 (the iNTT's, the LDE's K3 and "
          f"K2) {ntt_ms:.4f} ms", flush=True)
    by_width = {f"2^{w.bit_length() - 1}": widths.count(w) for w in sorted(set(widths))}
    print(f"{name}: merkle_tail {len(widths)} launches in the profiled prove, "
          f"{kernel_ms['merkle_tail']:.4f} ms measured, {bound_ms:.4f} ms the sum of "
          f"their bounds ({bound_before:.4f} on the earlier operation count); launches "
          f"by width {json.dumps(by_width)}", flush=True)
    return kernel_ms


def _profiled(name, prove, counts, median_wall, cuda) -> dict:
    for _ in range(PROFILE_ATTEMPTS):  # see _device_ms
        events = _profile(prove, 1)
        kernel_ms = {
            k.name: sum(_device_us(e) for e in events if k.kernel_symbol in e.key) / 1e3
            for k in cuda.KERNELS.values() if counts[k.name] > 0
        }
        if all(ms > 0 for ms in kernel_ms.values()):
            break
        _retaken[0] += 1
    else:
        raise AssertionError(f"{name}: a launched kernel shows no device time {kernel_ms}")
    device_ms = sum(_device_us(e) for e in events) / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:6]
    print(f"profiled prove, {name}: {sum(e.count for e in events)} device activities, "
          f"{device_ms:.3f} ms device time, busy share "
          f"{device_ms / 1e3 / median_wall:.3f} of the median wall; "
          f"hand kernels {sum(kernel_ms.values()):.4f} ms "
          f"{json.dumps({k: round(v, 4) for k, v in kernel_ms.items()})}; "
          "top: " + "; ".join(f"{_device_us(e) / 1e3:.3f} ms x{e.count} {e.key[:60]}"
                              for e in top), flush=True)
    return kernel_ms


def _d2h_copies(run, phased: bool = True, phase: str = "fri_query"):
    """The device-to-host copies of one ``run(timer)``, from the profiler's
    memcpy events, and each phase's: a phase is a record_function range on
    the host, and a copy counts as the phase's when the host operation
    that issued it (the profiler links each device activity to it) starts
    inside the range: both times are the host's clock.  (The device's
    timestamps can lie a millisecond or more from the host's: in one
    window every copy's middle fell in the phase before its own.)
    ``phased``: the run times its phases with the timer, and a window
    without them, or with a copy that no host operation inside a phase
    issued, is taken again.  So is a window the tracer kept only part of
    (seen once: 5 of a batched call's 6 copies): the window opens and
    closes with PAD_LAUNCHES uncounted erfinv launches (see _profile), and
    it is whole when the closing ones all come after its last copy and it
    holds a device memcpy for each memcpy the host issued.  Returns
    ({phase: copies}, [copy events])."""
    from stark_tpu_torch.utils.profiling import PhaseTimer

    class Marked(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, phase_name):
            with torch.profiler.record_function("phase:" + phase_name):
                yield

    def inside(t, ranges):
        return any(r.start <= t <= r.end for r in ranges)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    pad = torch.zeros(8, device="cuda")
    for _ in range(PROFILE_ATTEMPTS):
        run(Marked())
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PAD_LAUNCHES):
                pad.erfinv_()
            torch.cuda.synchronize()
            run(Marked())
            for _ in range(PAD_LAUNCHES):
                pad.erfinv_()
            torch.cuda.synchronize()
        events = prof.events()
        phases = {}
        for e in events:
            # The host's ranges: a range's device-side annotation spans its
            # kernels, which run behind the host and reach into later phases.
            if e.name.startswith("phase:") and \
                    e.device_type == torch.autograd.DeviceType.CPU:
                phases.setdefault(e.name[len("phase:"):], []).append(e.time_range)
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        copies = [e for e in device if "DtoH" in e.name]
        last = max((e.time_range.end for e in copies), default=0)
        closing = sum("erfinv" in e.name and e.time_range.start >= last for e in device)
        issued_memcpy = sum(e.device_type == torch.autograd.DeviceType.CPU
                            and e.name.startswith("cudaMemcpy") for e in events)
        whole = (closing == PAD_LAUNCHES
                 and sum(e.name.startswith("Memcpy") for e in device) >= issued_memcpy)
        issued = [(e.time_range.start, sum("DtoH" in k.name for k in e.kernels))
                  for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        by_phase = {k: sum(n for t, n in issued if n and inside(t, r))
                    for k, r in phases.items()}
        # A window with a copy that no host operation inside a phase issued
        # (or that the profiler did not link to one) is taken again; the
        # counts are checked by the caller.
        if copies and whole and (not phased or (
                phase in phases and sum(by_phase.values()) == len(copies))):
            break
        _retaken[0] += 1
        print(f"copies window taken again: {len(copies)} device-to-host copies, "
              f"{closing} of {PAD_LAUNCHES} closing launches after them, "
              f"{sum(e.name.startswith('Memcpy') for e in device)} device memcpys for "
              f"{issued_memcpy} issued", flush=True)
    else:
        raise AssertionError("no memcpy event or phase range recorded, or copies "
                             "outside every phase in every window")
    return by_phase, copies


def _query_copies(name, prover, witness, commit_copies: int | None = 1,
                  total: int | None = None, phase: str = "fri_query") -> None:
    """Device-to-host copies in one prove, by phase: the query phase (or
    ``phase``: ``dispatch`` on the graph path, where the copy is issued
    behind the replay) must make exactly one, and the FRI commit
    ``commit_copies`` (one on the device chain's three-read path, none on
    the single-fetch path, whose one copy the query phase issues; None: not
    held to a count); with ``total``, the prove that many in all."""
    by_phase, copies = _d2h_copies(
        lambda timer: prover.prove(trace_cols=witness(), timer=timer), phase=phase)
    print(f"{name}: device-to-host copies by phase {json.dumps(by_phase)} of "
          f"{len(copies)} in the prove", flush=True)
    if by_phase[phase] != 1:
        raise AssertionError(f"{name}: {by_phase[phase]} device-to-host copies in {phase}")
    if commit_copies is not None and by_phase.get("fri_commit", 0) != commit_copies:
        raise AssertionError(f"{name}: {by_phase.get('fri_commit', 0)} device-to-host "
                             f"copies in fri_commit, not {commit_copies}")
    if total is not None and len(copies) != total:
        raise AssertionError(f"{name}: {len(copies)} device-to-host copies, not {total}")


def _wall(name, prover, verifier, witness, proof, runs) -> float:
    """Witness + prove and verify wall-time distributions; returns the
    prove median (s).  Python's generation-2 (full) collections are
    recorded through gc.callbacks: which fell inside a prove, and for how
    long."""
    prove_s, verify_s, windows, collections = [], [], [], []

    def on_gc(phase, info):
        if info["generation"] == 2:
            collections.append((phase, time.perf_counter()))

    gc.callbacks.append(on_gc)
    try:
        for _ in range(runs):
            t0 = time.perf_counter()
            again = prover.prove(trace_cols=witness())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prove_s.append(t1 - t0)
            windows.append((t0, t1))
            if again != proof or not verifier.verify(again):
                raise AssertionError(f"{name}: proof not deterministic or rejected")
            verify_s.append(time.perf_counter() - t1)
    finally:
        gc.callbacks.remove(on_gc)
    starts = [t for ph, t in collections if ph == "start"]
    stops = [t for ph, t in collections if ph == "stop"]
    full = list(zip(starts, stops))
    per_prove = [[(b - a) * 1e3 for a, b in full if t0 <= a <= t1] for t0, t1 in windows]
    median = float(np.median(prove_s))
    slow = [i for i, s in enumerate(prove_s) if s > 2 * median]
    print(f"{name} wall over {runs} runs: witness + prove s " + json.dumps(_quantiles(prove_s))
          + ", verify s " + json.dumps(_quantiles(verify_s)), flush=True)
    print(f"{name} full collections (gc generation 2): {len(full)} in the runs, "
          f"{sum(map(len, per_prove))} inside a prove, ms "
          + json.dumps([round(ms, 3) for ms in sum(per_prove, [])])
          + f"; proves over twice the median: "
          + json.dumps([{"run": i, "ms": round(prove_s[i] * 1e3, 3),
                         "gen2_ms": [round(ms, 3) for ms in per_prove[i]]} for i in slow]),
          flush=True)
    return median


def _phases(name, prover, witness, runs: int = 5, want: str = "compose") -> None:
    """Synchronised per-phase times, the median of ``runs`` proves (a
    single prove may catch one of Python's full garbage collections); the
    witness is a phase of its own, before the prove's.  ``want``: a phase
    the prove must show (``dispatch`` on the graph path: the witness's copy
    in, the replay and the issued copy out)."""
    from stark_tpu_torch.utils.profiling import PhaseTimer

    samples: dict[str, list[float]] = {}
    for _ in range(runs):
        timer = PhaseTimer(sync=torch.cuda.synchronize)
        with timer.phase("witness"):
            cols = witness()
        prover.prove(trace_cols=cols, timer=timer)
        for phase, ms in timer.ms().items():
            samples.setdefault(phase, []).append(ms)
    if want not in samples:
        raise AssertionError(f"{name}: no {want} phase in {sorted(samples)}")
    print(f"{name} prove phases (ms, synchronised, median and max of {runs} proves): "
          + json.dumps({k: [round(float(np.median(v)), 3), round(max(v), 3)]
                        for k, v in samples.items()}), flush=True)


def _rejects(name, prover, verifier, witness, proof) -> None:
    bad = bytearray(proof)
    bad[100] ^= 1
    if verifier.verify(bytes(bad)):
        raise AssertionError(f"{name}: tampered proof accepted")
    cheat = witness().clone()
    col = cheat.shape[1] // 2
    cheat[0, col] = (int(cheat[0, col]) + 1) % 998244353
    if verifier.verify(prover.prove(trace_cols=cheat)):
        raise AssertionError(f"{name}: proof of a wrong witness accepted")
    print(f"{name}: flipped byte and changed device witness element rejected", flush=True)


#: Every CUDA graph the run captures (ops/cuda.Graph, counted by
#: _count_captures): the graph phase holds each (B, slot) to one capture.
_CAPTURES: list = []


def _count_captures(cuda) -> None:
    graph = cuda.Graph

    def counted(*args):
        _CAPTURES.append(graph(*args))
        return _CAPTURES[-1]

    cuda.Graph = counted


def _graph_counted(name, prover, witness, want_sha, eager_counts, cuda) -> dict:
    """One witness -> prove on the graph path (the slot warm: its capture,
    then its replay), the launch counts set to 0 just before and read just
    after: each replay adds the launches its graph holds, so they must
    equal the eager body's prove's, and the proof its sha256.  Returns the
    counts."""
    cuda.reset_launches()
    proof = prover.prove(trace_cols=witness())
    counts = cuda.launch_counts()
    if hashlib.sha256(proof).hexdigest() != want_sha or counts != eager_counts:
        raise AssertionError(f"{name}: the graph path's prove differs from the eager "
                             f"body's: launches {counts}, eager {eager_counts}")
    slot = prover._slots[1][0]
    print(f"{name}, graph path: proved from a captured graph's replay, sha256 == pinned; "
          f"launches equal to the eager body's prove; capture {slot.graph.seconds:.4f} s, "
          f"{sum(slot.graph.launches.values())} launches inside the graph", flush=True)
    return counts


def _graph_phase(name, single, call, want: list, runs: int, captured_before: int,
                 reps: int = 20) -> dict:
    """The graph path against its eager body (StarkProver._eager) on the
    same prover and inputs: ``call()`` gives the proofs (each sha256 as
    ``want``), in turn graph, eager, eager, graph, ``runs`` synchronised
    calls a turn; each turn's median wall.  Then each of ``single``'s slots
    (by B): one capture (none during the turns; the run's captures since
    the prover was made, ``captured_before``, one a slot), the launches its
    graph holds (counted at capture: one eager run of the body on the slot
    must count the same), the capture's host time, the replay's time from
    CUDA events around it beside the eager body's on the same slot (its
    launches from Python, the gaps between them inside), ``reps`` of each,
    medians; the memory the slots hold; and the kernels a profiled call on
    the graph path shows under their names.  A record of this run, not a
    claim."""
    from stark_tpu_torch.ops import cuda

    graphs = {id(s.graph) for slots in single._slots.values() for s in slots}
    before = len(_CAPTURES)
    turns = []
    for form in ("graph", "eager", "eager", "graph"):
        with single._eager() if form == "eager" else contextlib.nullcontext():
            walls = []
            for _ in range(runs):
                t0 = time.perf_counter()
                got = call()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                if [hashlib.sha256(p).hexdigest() for p in got] != want:
                    raise AssertionError(f"{name}: a {form} call's proof differs")
        turns.append((form, float(np.median(walls))))
    slots = [s for b in sorted(single._slots) for s in single._slots[b]]
    if len(_CAPTURES) != before or {id(s.graph) for s in slots} != graphs \
            or any(s.graph is None for s in slots) \
            or len(_CAPTURES) - captured_before != len(slots):
        raise AssertionError(f"{name}: {len(_CAPTURES) - captured_before} captures for "
                             f"{len(slots)} slots ({len(_CAPTURES) - before} in the turns)")
    per_slot = []
    for slot in slots:
        cuda.reset_launches()
        with single._eager():
            single._body(slot)
        eager = {k: n for k, n in cuda.launch_counts().items() if n}
        if eager != slot.graph.launches:
            raise AssertionError(f"{name}: the graph of B={slot.b} holds {slot.graph.launches}, "
                                 f"the eager body launches {eager}")
        ms = {}
        for form, run in (("replay", slot.graph.replay),
                          ("eager", lambda: single._body(slot))):
            with single._eager():
                run()
                pairs = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                         for _ in range(reps)]
                for start, end in pairs:
                    start.record()
                    run()
                    end.record()
                torch.cuda.synchronize()
            ms[form] = float(np.median([a.elapsed_time(b) for a, b in pairs]))
        per_slot.append({"B": slot.b, "launches": sum(slot.graph.launches.values()),
                         "capture_s": slot.graph.seconds, "replay_ms": ms["replay"],
                         "eager_body_ms": ms["eager"], **slot.nbytes()})
    held = {k: sum(p[k] for p in per_slot) for k in ("device", "pool", "host")}
    inside = {k for s in slots for k in s.graph.launches}
    symbols = {cuda.KERNELS[k].kernel_symbol: k for k in inside}
    seen = {symbols[sym] for e in _profile(call, 1) for sym in symbols if sym in e.key}
    medians = {f: float(np.median([ms for g, ms in turns if g == f])) for f in ("graph", "eager")}
    print(f"{name}, graph phase: in turn ({runs} synchronised calls a turn, each proof's "
          f"sha256 == pinned on both forms) median wall ms "
          + json.dumps([[f, round(ms, 4)] for f, ms in turns])
          + f"; one capture a slot ({len(slots)} slots, none in the turns); per slot "
          + json.dumps([{k: (round(v, 4) if isinstance(v, float) else v)
                         for k, v in p.items()} for p in per_slot])
          + f" (replay and eager body: CUDA events around {reps} runs each, medians; "
          f"launches inside the graph equal to one eager body's); memory held by the "
          f"slots: {held['device'] / 2**30:.4f} GiB of their own buffers, "
          f"{held['pool'] / 2**30:.4f} GiB reserved by the graphs' pools, "
          f"{held['host'] / 2**20:.3f} MiB pinned; torch.profiler shows {len(seen)} of the "
          f"{len(inside)} kernels inside the graph under their names"
          + (f" (not {sorted(inside - seen)})" if inside - seen else ""), flush=True)
    return {"turns_ms": turns, "medians_ms": medians, "slots": per_slot, "held": held,
            "profiler_sees": sorted(seen)}


def _drive(name, key, prover, verifier, witness, rows, want_sha, expect, runs, cuda,
           launches: dict, turn_runs: int) -> tuple:
    """A path on the single-fetch prove: warm-up, the counted prove on the
    eager body (StarkProver._eager: _prove_checked's records follow each
    launch from Python), then the counted prove on the graph path
    (launches[key], _graph_counted), its reads from the card (one), one
    prove from host rows that must give the same bytes, wall times, phases
    and the copies (one, issued in the dispatch phase) of the graph path
    and (in the query phase) of the eager body; then the three-read path
    (fused_round False) on the same prover: its reads (three) and bytes,
    and the two in turn (_in_turn).  Returns (proof, counts, rule plan
    record, median wall s)."""
    if not verifier.verify(prover.prove(trace_cols=witness())):  # warm-up
        raise AssertionError(f"{name}: warm-up proof rejected")
    torch.cuda.reset_peak_memory_stats()
    with prover._eager():
        proof, counts, plan = _prove_checked(name, prover, verifier, witness, want_sha,
                                             expect, cuda)
    counts = _graph_counted(name, prover, witness, want_sha, counts, cuda)
    launches[key] = counts
    _check_chain(name, counts, prover.fri.num_rounds())
    peak = torch.cuda.max_memory_allocated() / 2**30
    if hashlib.sha256(prover.prove(rows)).hexdigest() != want_sha:
        raise AssertionError(f"{name}: the proof from host rows differs")
    single = lambda: prover.prove(trace_cols=witness())  # noqa: E731
    three = _three_reads(prover, single)
    reads = {"single-fetch": _reads(single), "three reads": _reads(three)}
    if reads != {"single-fetch": 1, "three reads": 3}:
        raise AssertionError(f"{name}: reads from the card {reads}, not 1 and 3")
    if hashlib.sha256(three()).hexdigest() != want_sha:
        raise AssertionError(f"{name}: the three-read path's proof differs")
    print(f"{name}: proved from device columns and verified, {len(proof)} bytes, sha256 "
          f"== pinned, and == the proof from host rows and the three-read path's; reads "
          f"from the card a prove {json.dumps(reads)}; launches {counts}, peak device "
          f"memory {peak:.3f} GiB", flush=True)
    median = _wall(name, prover, verifier, witness, proof, runs)
    _phases(name + ", graph", prover, witness, want="dispatch")
    _query_copies(name + ", graph", prover, witness, commit_copies=0, total=1,
                  phase="dispatch")
    with prover._eager():
        _phases(name + ", eager body", prover, witness)
        _query_copies(name + ", eager body", prover, witness, commit_copies=0, total=1)
    _in_turn(name, single, three, turn_runs)
    return proof, counts, plan, median


def _drive_batch(cell, model, batch, count, depth, cuda, launches) -> dict:
    """One batched cell at T=BATCH_T: a call is prove_batch of one batch
    (count 0) or prove_many of ``count`` traces, every trace the same, as
    bench.py proves them (host rows for Fibonacci, device columns for
    MdsSquareAir).  The counted call (launches[cell]): each proof's sha256
    equal to the single prove's, verify_batch accepting them all and
    rejecting one with a flipped byte; then proofs/s over BATCH_RUNS calls,
    the device-to-host copies of a call (3 a batch), and a profiled call
    (device time by kernel, busy share).  Returns the cell's summary."""
    from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver, StarkVerifier
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.models.examples import mds_square_trace_cols_device

    air, trace_fn, _ = get_model(model)
    cfg = StarkConfig(trace_length=BATCH_T, blowup=4, num_colinearity_tests=16)
    if model == "mds":
        item = mds_square_trace_cols_device(BATCH_T)
        single = StarkProver(air, cfg).prove(trace_cols=item)
        key = "traces_cols"
    else:
        item = trace_fn(BATCH_T)
        single = StarkProver(air, cfg).prove(item)
        key = "traces"
    want = hashlib.sha256(single).hexdigest()
    captured_before = len(_CAPTURES)
    prover = BatchStarkProver(air, cfg, batch)
    verifier = StarkVerifier(air, cfg)
    proofs = count or batch
    batches = -(-proofs // batch)
    if count:
        def call():
            return prover.prove_many(**{key: [item] * count}, depth=depth)
    else:
        def call():
            return prover.prove_batch(**{key: [item] * batch})

    call()  # warm-up: the first call on each slot runs its body eagerly
    cuda.reset_launches()
    out = call()  # each slot's capture, then its replay
    counts = cuda.launch_counts()
    launches[cell] = counts
    if len(out) != proofs or any(hashlib.sha256(p).hexdigest() != want for p in out):
        raise AssertionError(f"{cell}: a batch proof differs from the single prove")
    bad = bytearray(out[-1])
    bad[100] ^= 1
    if verifier.verify_batch(out) != [True] * proofs or \
            verifier.verify_batch([out[0], bytes(bad)]) != [True, False]:
        raise AssertionError(f"{cell}: verify_batch did not accept the proofs and "
                             "reject the flipped byte")
    missing = [k for k in ("merkle_forest", "sponge_absorb", "fri_fold_dyn", "hash_rows",
                           "query_gather", "constraint_challenges", "sample_indices")
               if counts[k] == 0]
    # A batch's gather is one plan, one output and one copy; a plan larger
    # than one launch's parameters goes out in several launches.
    if missing or counts["fri_fold"] or counts["query_gather"] < batches or \
            counts["compose"] != batches or counts["lde_pad_scale"] or \
            counts["ntt_pass1_lde"] != batches:
        raise AssertionError(f"{cell}: launches {counts}")
    _check_chain(cell, counts, prover.fri.num_rounds(), batches)
    three = _three_reads(prover, call)
    reads = {"single-fetch": _reads(call), "three reads": _reads(three)}
    if reads != {"single-fetch": batches, "three reads": 3 * batches}:
        raise AssertionError(f"{cell}: reads from the card a call {reads}, not "
                             f"{batches} and {3 * batches}")
    if any(hashlib.sha256(p).hexdigest() != want for p in three()):
        raise AssertionError(f"{cell}: a three-read batch proof differs")
    if count:
        # prove_many at depth 1 and 2 in turn: the same bytes.
        for d in (1, 2):
            got = prover.prove_many(**{key: [item] * count}, depth=d)
            if [hashlib.sha256(p).hexdigest() for p in got] != [want] * count:
                raise AssertionError(f"{cell}: prove_many at depth {d} differs")

    walls = []
    for _ in range(BATCH_RUNS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rates = [proofs / w for w in walls]
    median = float(np.median(walls))
    _, copies = _d2h_copies(lambda timer: call(), phased=False)
    if len(copies) != batches:
        raise AssertionError(f"{cell}: {len(copies)} device-to-host copies in a call, "
                             f"not {batches}")
    with prover._single._eager():
        kernel_ms = _profiled(cell + ", eager body", call, counts, median, cuda)
    _in_turn(cell, call, three, TURN_RUNS["batch"])
    graph = _graph_phase(cell, prover._single, call, [want] * proofs, TURN_RUNS["batch"],
                         captured_before)
    per_call = {k: counts[k] for k in ("sponge_absorb", "fri_fold_dyn", "merkle_forest",
                                       "merkle_level", "hash_rows", "query_gather",
                                       "compose", "ntt_pass1_lde", "lde_pad_scale",
                                       "constraint_challenges",
                                       "sample_indices")}
    print(f"{cell} ({model}, T=2^{BATCH_T.bit_length() - 1}, B={batch}, "
          f"{'prove_many of %d, depth %d' % (count, depth) if count else 'prove_batch'}): "
          f"{proofs} proofs a call, each sha256 == the single prove's ({want[:16]}...), "
          f"verify_batch accepts them and rejects a flipped byte; proofs/s over "
          f"{BATCH_RUNS} calls {json.dumps(_quantiles(rates))}; wall s "
          f"{json.dumps(_quantiles(walls))}; device-to-host copies a call {len(copies)}; "
          f"reads from the card a call {json.dumps(reads)} (the three-read path's proofs "
          f"equal{', prove_many at depth 1 and 2 equal' if count else ''}); "
          f"launches a call {json.dumps(per_call)}", flush=True)
    return {"cell": cell, "proofs_per_s_median": float(np.median(rates)),
            "kernel_ms": kernel_ms, "graph": graph}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1

    from stark_tpu_torch import StarkConfig, StarkProver, StarkVerifier
    from stark_tpu_torch.models import get_model
    from stark_tpu_torch.ops import cuda

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    _count_captures(cuda)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    # 2. build: the port's library and every driven AIR's K11 library, one
    # nvcc each, all at once
    from stark_tpu_torch.ops import compose as CO

    t0 = time.perf_counter()
    programs = _compose_programs()
    programs["many"] = _compose_program("many", MANY_CFG["trace_length"], MANY_CFG["blowup"])
    from stark_tpu_torch.tools import tune_kernels as TK

    # The designs before each redesign, built beside the port (nvcc each,
    # all at once), into BEFORE: timed in turn with the kernels in use.
    befores = {"sponge": TK.sponge_before, "fib_expand": TK.fib_expand_before,
               "fib_expand_seeds": TK.fib_expand_seeds,
               "forest": TK.forest_before, "fold_dyn": TK.fold_dyn_before,
               "challenges": TK.challenges_before, "sample": TK.sample_before,
               "floor": TK.floor_kernel}
    timed_cases = {(model, T): blowup for model, T, blowup, _ in COMPOSE_CASES[:COMPOSE_TIMED]}
    with ThreadPoolExecutor(len(programs) + len(befores) + len(timed_cases) + 1
                            + 2 * len(TABLE_CASES)) as pool:
        built = [pool.submit(cuda.library)] + [
            pool.submit(CO.library, prog.source) for prog in programs.values()]
        jobs = {key: pool.submit(fn) for key, fn in befores.items()}
        composes = {case: pool.submit(lambda case=case: TK.compose_before(
            _compose_program(*case, timed_cases[case]))) for case in timed_cases}
        table_forms = [_compose_program(model, T, 4, table=True) for model, T, _ in TABLE_CASES]
        built += [pool.submit(CO.library, prog.source) for prog in table_forms]
        tables_before = {case[:2]: pool.submit(TK.table_before, prog)
                         for case, prog in zip(TABLE_CASES, table_forms)}
        lib = built[0].result()
        for job in built[1:]:
            job.result()
        BEFORE.update({key: job.result() for key, job in jobs.items()})
        BEFORE["compose"] = {case: job.result() for case, job in composes.items()}
        BEFORE["table"] = {case: job.result() for case, job in tables_before.items()}
    print(f"build: CUDA kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          "(the port's library, each AIR's compose library and the designs before the "
          "redesigns side by side); compose sources generated (sha256, nvcc s): "
          + json.dumps({m: [p.sha256, round(CO.BUILD_SECONDS[p.sha256], 2)]
                        for m, p in programs.items()}), flush=True)
    release = subprocess.run([cuda._nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-2:]
    print("nvcc: " + " / ".join(release), flush=True)
    ptxas = TK.ptxas

    paths = {CO._source_file(p.source): m for m, p in programs.items()}
    paths.update({CO._source_file(p.source): f"{case[0]} T={case[1]} table form"
                  for case, p in zip(TABLE_CASES, table_forms)})
    regs = ptxas(("witness.cu", "gather.cu", "hash.cu", "fold.cu", "ntt.cu", *paths),
                 by_source=True)
    print("ptxas, the column kernels (K1, K1 of an LDE, K2): " + json.dumps(
        {k: v for k, v in regs["ntt.cu"].items() if "_pass" in k}), flush=True)
    spills = [k for src in regs for k, v in regs[src].items() if "spill 0/0 B" not in v]
    if spills:
        raise AssertionError(f"ptxas: spills in {spills}")
    PTXAS.update(regs["hash.cu"])
    print("ptxas, K12, K13, K9, K15, K10 and K4-dyn: " + json.dumps(
        {k: v for src in ("witness.cu", "gather.cu", "hash.cu", "fold.cu")
         for k, v in regs[src].items()
         if any(w in k for w in ("sponge", "dyn", "challenges", "sample"))
         or src not in ("hash.cu", "fold.cu")}), flush=True)
    print("ptxas, K11 by AIR: " + json.dumps(
        {paths[src]: sorted(set(regs[src].values())) for src in paths}), flush=True)
    _sass_mix(lib._name)

    # 3. kernels against their plain versions
    results = _Results()
    marks = [time.perf_counter()]
    for check in (_check_ntt, _check_pad_scale, _check_lde_pass1, _check_fold, _check_forest,
                  _check_sponge, _check_chained, _check_compose, _check_hash, _check_witness,
                  _check_split_gather):
        check(rng, dev, results)
        marks.append(time.perf_counter())

    # 4. pinned proof bytes, K13 held against its plain version on each plan
    for (model, T, blowup, tests), want in PINNED.items():
        air, trace_fn, _ = get_model(model)
        cfg = StarkConfig(trace_length=T, blowup=blowup, num_colinearity_tests=tests)
        trace = trace_fn(T)
        plans: list = []
        for lazy in (False, True) if model == "fib" else (False,):
            with _recording_gathers(plans):
                proof = StarkProver(air, cfg, lazy_ntt=lazy).prove(trace)
            got = hashlib.sha256(proof).hexdigest()
            if got != want:
                raise AssertionError(f"{model} T={T} lazy={lazy}: sha256 {got} != pinned {want}")
            if not StarkVerifier(air, cfg).verify(proof):
                raise AssertionError(f"{model} T={T}: proof rejected")
        shapes = _check_plans(f"{model} T={T}", plans)
        print(f"proof {model} T={T} blowup={blowup} tests={tests}: {len(proof)} bytes, "
              "verified, sha256 == stark_tpu's"
              + (" (strict and lazy NTT)" if model == "fib" else "")
              + f"; query_gather == plain ({shapes})", flush=True)

    # The sampler's shortfall on the card: one candidate a proof, so every
    # count falls short and the host's indices go through the same gather
    # (a second K13 launch, a second read); the pinned bytes all the same.
    from stark_tpu_torch import fri as FRI

    air, trace_fn, _ = get_model("fib")
    cfg = StarkConfig(trace_length=1 << 16, blowup=4, num_colinearity_tests=16)
    short = StarkProver(air, cfg)
    slack, FRI._SAMPLE_SLACK = FRI._SAMPLE_SLACK, 1 - 2 * 16
    try:
        cuda.reset_launches()
        proofs = []
        # The first prove runs the body eagerly, the second replays the
        # slot's graph; each re-runs the gather eagerly after its read.
        reads = _reads(lambda: proofs.extend(short.prove(trace_fn(1 << 16))
                                             for _ in range(2)))
        gathers = cuda.launch_counts()["query_gather"]
    finally:
        FRI._SAMPLE_SLACK = slack
    want = PINNED[("fib", 1 << 16, 4, 16)]
    if [hashlib.sha256(p).hexdigest() for p in proofs] != [want] * 2 or reads != 4 or \
            short.fri.shortfalls != 2 or gathers != 4 or short._slots[1][0].graph is None:
        raise AssertionError(f"sampler shortfall: reads {reads}, shortfalls "
                             f"{short.fri.shortfalls}, K13 launches {gathers}")
    print(f"sampler shortfall (1 candidate a proof), fib T=2^16, eager body then graph "
          f"replay: sha256 == pinned, {reads} reads, {gathers} K13 launches, shortfalls "
          f"{short.fri.shortfalls}", flush=True)
    del short

    from stark_tpu_torch.models.examples import mds_square_trace_cols_device
    from stark_tpu_torch.models.fibonacci import fibonacci_trace_cols_device

    lazy_names = {"ntt_pass1_lazy", "ntt_pass2_lazy", "ntt_pass1_lde_lazy"}
    strict_names = {"ntt_pass1", "ntt_pass2", "ntt_pass1_lde"}
    # K4 runs on the host commit path (device_chain off), K8-forest only in
    # batches of more than one proof, K14 on the sharded path (and in
    # coset_eval / coset_interp): the LDE's pad and scale ride in its pass 1.
    elsewhere = {"fri_fold", "merkle_forest", "lde_pad_scale"}
    sharded = f"dist gloo fib T=2^{DIST_T.bit_length() - 1} D={DIST_D}"
    every = set(cuda.KERNELS)
    launches: dict[str, dict[str, int]] = {}

    # 5. the main path: FibonacciAir at T = 2^20, from device columns
    name = "main path fib T=2^20"
    air, trace_fn, _ = get_model("fib")
    cfg = StarkConfig(trace_length=MAIN_T, blowup=4, num_colinearity_tests=16)
    rows = trace_fn(MAIN_T)
    captured_before = len(_CAPTURES)
    prover = StarkProver(air, cfg)
    verifier = StarkVerifier(air, cfg)

    def fib_cols():
        return fibonacci_trace_cols_device(MAIN_T)

    proof, counts, plan, median = _drive(
        name, "fib_2^20", prover, verifier, fib_cols, rows, MAIN_SHA256,
        every - lazy_names - elsewhere - {"mds_expand"}, MAIN_RUNS, cuda, launches,
        TURN_RUNS["fib"])
    graphs = {"fib_2^20": _graph_phase(
        name, prover, lambda: [prover.prove(trace_cols=fib_cols())], [MAIN_SHA256],
        TURN_RUNS["fib"], captured_before)}
    _time_rule_gather("fib T=2^20 prove", plan, results, dev)
    del plan
    # The three-read path's query phase (host indices): its host split and
    # K13 on its plan, as a record beside the rule slots' time.
    three = StarkProver(air, cfg)
    three.fri.fused_round = False
    _query_split(name + ", three reads", three, fib_cols)
    host_plans: list = []
    with _recording_gathers(host_plans):
        three.prove(trace_cols=fib_cols())
    _time_gather("fib T=2^20 prove, three reads", host_plans[0], None, dev)
    del host_plans, three
    with prover._eager():
        _profiled_prove(name + ", eager body", prover, fib_cols, counts, median, cuda)
    _rejects(name, prover, verifier, fib_cols, proof)

    name = "main path fib T=2^20, lazy NTT"
    lazy_prover = StarkProver(air, cfg, lazy_ntt=True)
    lazy_prover.prove(trace_cols=fib_cols())  # warm-up
    with lazy_prover._eager():
        _, counts, _ = _prove_checked(name, lazy_prover, verifier, fib_cols, MAIN_SHA256,
                                      every - strict_names - elsewhere - {"mds_expand"},
                                      cuda)
    counts = _graph_counted(name, lazy_prover, fib_cols, MAIN_SHA256, counts, cuda)
    launches["fib_2^20_lazy"] = counts
    _check_chain(name, counts, lazy_prover.fri.num_rounds())
    print(f"{name}: proved and verified, sha256 == pinned, launches {counts}",
          flush=True)
    with lazy_prover._eager():
        _profiled_prove(name + ", eager body", lazy_prover, fib_cols, counts, median, cuda)

    # The host commit path (device_chain off): a root read and a host
    # challenge a round, the fold K4 with a host alpha; the same bytes.
    name = "main path fib T=2^20, device_chain off"
    host_prover = StarkProver(air, cfg)
    host_prover.fri.device_chain = False
    host_prover.prove(trace_cols=fib_cols())  # warm-up
    _, counts, _ = _prove_checked(
        name, host_prover, verifier, fib_cols, MAIN_SHA256,
        every - lazy_names - {"mds_expand", "merkle_forest", "lde_pad_scale", "sponge_absorb",
                              "fri_fold_dyn",
                              "constraint_challenges", "sample_indices"},
        cuda)
    if counts["sponge_absorb"] or counts["fri_fold_dyn"] or counts["constraint_challenges"]:
        raise AssertionError(f"{name}: the device chain ran: {counts}")
    launches["fib_2^20_host_alpha"] = counts
    print(f"{name}: proved and verified, sha256 == pinned, launches {counts}", flush=True)
    _phases(name, host_prover, fib_cols)
    _query_copies(name, host_prover, fib_cols, commit_copies=None)
    del host_prover

    # 6. the wide path: MdsSquareAir at T = 2^16, from device columns
    name = "wide path mds T=2^16"
    air, trace_fn, _ = get_model("mds")
    cfg = StarkConfig(trace_length=MDS_T, blowup=4, num_colinearity_tests=16)
    captured_before = len(_CAPTURES)
    prover = StarkProver(air, cfg)
    verifier = StarkVerifier(air, cfg)

    def mds_cols():
        return mds_square_trace_cols_device(MDS_T, MDS_BLOCK)

    proof, counts, plan, median = _drive(
        name, "mds_2^16", prover, verifier, mds_cols, trace_fn(MDS_T), MDS_SHA256,
        every - lazy_names - elsewhere - {"fib_expand"}, MDS_RUNS, cuda, launches,
        TURN_RUNS["mds"])
    graphs["mds_2^16"] = _graph_phase(
        name, prover, lambda: [prover.prove(trace_cols=mds_cols())], [MDS_SHA256],
        TURN_RUNS["mds"], captured_before)
    _time_rule_gather("mds T=2^16 prove", plan, None, dev)
    del plan
    with prover._eager():
        _profiled_prove(name + ", eager body", prover, mds_cols, counts, median, cuda)
    _rejects(name, prover, verifier, mds_cols, proof)

    # 7. the batched paths (bench.py's batch8, pipe32x2, mds_pipe8x2)
    cells = [_drive_batch(*cell, cuda=cuda, launches=launches) for cell in BATCH_CELLS]
    graphs.update({c["cell"]: c["graph"] for c in cells})
    print("batched cells, proofs/s medians: "
          + json.dumps({c["cell"]: round(c["proofs_per_s_median"], 2) for c in cells}),
          flush=True)
    print("graph phase, the five cells: median wall ms by form, replay and eager body ms "
          "(CUDA events) and launches inside the graph by slot, slot memory GiB: "
          + json.dumps({cell: {"wall_ms": {f: round(v, 4) for f, v in g["medians_ms"].items()},
                               "slots": [[p["B"], round(p["replay_ms"], 4),
                                          round(p["eager_body_ms"], 4), p["launches"]]
                                         for p in g["slots"]],
                               "held_gib": round((g["held"]["device"] + g["held"]["pool"])
                                                 / 2**30, 4)}
                        for cell, g in graphs.items()}), flush=True)
    marks.append(time.perf_counter())

    # 8. K15 and K10 beside their designs before, K15 past one window; the
    # sharded prover
    # (parallel/): its kernels' sharded forms against their plain versions
    # (here, after the profiled paths: K13's windowed form's plain version
    # runs thousands of torch ops under the profiler), then worlds of ranks
    # on the one card
    _check_chained_before(rng, dev, results)
    _check_sharded_forms(rng, dev, results)
    _drive_distributed(smi, launches)
    marks.append(time.perf_counter())

    # 9. the API and the command line: a Polynomial product on the card,
    # then python -m stark_tpu_torch as a user runs it, and its bench; last,
    # the 3,633-term AIR's prove (its K11's 14.5 KB stack a thread: nothing
    # profiled runs after it)
    _check_poly(rng, dev)
    _drive_cli()
    _drive_bench()
    launches["many_terms"] = _drive_many_terms()

    # Each kernel's launches are those of the path that runs it.
    for r in results.entries:
        if r["name"] in lazy_names:
            path = "fib_2^20_lazy"
        elif r["name"] == "mds_expand":
            path = "mds_2^16"
        elif r["name"] == "fri_fold":
            path = "fib_2^20_host_alpha"
        elif r["name"] == "merkle_forest":
            path = "batch8"
        elif r["name"] == "lde_pad_scale":
            path = sharded
        else:
            path = "fib_2^20"
        r["launches"] = launches[path][r["name"]]
        r["launches_by_path"] = {p: c[r["name"]] for p, c in launches.items()}
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']}: no launch on the path that runs it")
    listed = {r["name"] for r in results.entries}
    if listed != every:
        raise AssertionError(f"kernels without a result: {sorted(every - listed)}")

    marks.append(time.perf_counter())
    print(f"chip_smoke: all phases passed in {marks[-1] - t_start:.1f} s (kernel "
          "checks: ntt, pad_scale, lde pass 1, fold, forest, sponge, chained (K15, K10, K11 "
          "fed K15), compose, hash, witness, split gather, then the proofs and paths, then the "
          "sharded forms and the distributed phase, "
          "then the API and the command line: "
          f"{[round(b - a, 1) for a, b in zip(marks, marks[1:])]} s); "
          f"{_retaken[0]} profile(s) came back empty or short and were taken again; "
          f"timed with CUDA events instead: {_event_timed or 'none'}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": results.entries}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
