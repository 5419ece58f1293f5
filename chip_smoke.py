#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's aggregation round, quantized collectives,
FSDP and TP training and serving of every model family, multi-round
service, aggregation tree, continuous-round engine, flash attention and the
paper's algorithms on one CUDA card.

    python3 chip_smoke.py [--seed N]   # d = 277,845,504; 16 clients; 4 ranks

The port (``src/repro_torch``) is the only thing imported: no JAX and
nothing of the JAX package.  The script

1. prints the card's name and power limit, and builds every CUDA kernel
   from the sources in the checkout (one ``nvcc`` per source, all at once);
2. holds each kernel against its plain torch version at the shapes the
   main paths give it — the comparison on a leading slice of 2^24
   coordinates (the plain versions' temporaries are too large for the
   whole shape; the encode and the single decode on the last 2^24 too),
   the timing at the full shape — and prints its time (``ms``, one call;
   ``device_ms``, a run of back-to-back calls), bound, plain time and
   library-call time.  The FWHT is held bitwise also at every row length
   from 4 to 16384, in f32 and bf16, and on two views off a 16-byte
   boundary, and is timed in bf16 too; the ``sass`` line counts its LDS,
   STS and SHFL at d = 4096 and its registers, and fails if any instance
   of it (the cluster, fused and further-pass kernels among them)
   spilled, and fails unless the encode's and the single decode's
   main instances move their streams by 128-bit loads and stores and no
   instance of the four lattice libraries spilled, and unless every
   instance of the attention kernels (the wgmma kernel in bf16 and f16 at
   head dims 16, 32, 64, 128, 192 and 256; the wide wgmma kernel in bf16
   and f16 at 384 and 512; the f32 TF32 wgmma kernel at 64; the mma.sync
   kernel in f32 at 128, 192, 256, 384 and 512 and in each type past 512;
   the split kernel in bf16 and f16 at 16 to 256 and in f32 at 64 to 256)
   spilled nothing, every instance of the three wgmma kernels shows HGMMA
   and UTMALDG (the bf16/f16 one's with its registers a thread, consumer
   warpgroups a block and blocks resident on an SM, as information),
   every instance of the mma.sync kernel HMMA and UTMALDG,
   and every instance of the split kernel HMMA and LDGSTS (cp.async).  Then the shapes the reference's kernels
   do not take (``shape_kernel_checks``), each bitwise against its plain
   version at full width and timed: the encode, the single decode and the
   batched decode (16 senders) at q = 2 (1-bit colors), 3 and 12 (not
   powers of two), the encode and the single decode at n = 31, and the FWHT over
   (8,479, 32,768), (4,239, 65,536), (1,059, 262,144), (264, 1,048,576),
   (66, 4,194,304), (33, 8,388,608) and (138,922,752, 2), f32 and bf16
   (rows of 2^15 to 2^18 in one launch of the cluster kernel, rows of
   2^20 and 2^22 in one of the fused kernel, rows of 2^23 in two);
3. runs round A: an unrotated, unanchored round of 16 clients over a
   277,845,504-dimensional vector (the gradient of whisper-small, the
   smallest model the repo configures), q = 16, bucket = 4096, y0 = 0.25;
   the server's anchor is ``base ~ N(0,1)`` and client i sends
   ``base + 0.02 N(0,1)``, all made on the card from ``--seed``; frames
   cross as bytes; checks that every client is accepted at attempt 0 in
   exactly one batched decode launch and that the mean is within 0.51 s of
   the exact mean in every coordinate; times each phase, and the drain's
   parts (upload, decode, epilogue);
4. runs round B: the same clients, rotated (§6) and anchored at round A's
   mean; checks ||mean - exact||_2 <= 0.51 s sqrt(N);
5. runs the collectives: four ranks, one process each on the one card,
   over a gloo group; rank r holds client vector r of rounds A and B.
   The star, the butterfly and recursive halving (over the vector padded
   to 277,856,256 = ``pad_to_shardable(d, 4, 4096)``), unrotated and
   rotated, and recursive halving anchored at the star's mean.  Checks: no
   decode failures; every rank sends exactly the bytes the wire
   accounting gives; the star's and butterfly's outputs are the same on
   every rank; the error against the exact mean is within the reference's
   model, 0.51 s per quantization (per coordinate unrotated, in l2
   rotated); and a small world-4 star and butterfly (d = 2^18) give the
   same bits on the card as on the CPU.  Then the shape paths
   (``SHAPE_PATHS``, each its own path, card == CPU bitwise, the same
   failures): the star, butterfly and recursive halving at d = 2^18 and
   q = 2 with y = 1e-3 (the paper's §5 failure cases: every rank must
   detect failures), at q = 3, and at q = 12 rotated with bucket 32,768
   (FWHT rows past 16,384); the star and the butterfly rotated with
   buckets of 65,536 and of 1,048,576 (the FWHT rows that the kernel
   checks at those widths take); the butterfly over 31 coordinates with
   bucket 1 (n < 32) and rotated with bucket 2 (FWHT rows of 2); one FSDP
   gradient sync at q = 2 with a tiny y (the ``lq-fails`` case).  A rank
   that fails, or has not finished within ``RANK_TIMEOUT_S``, fails the
   run;
6. trains internvl2-1b at full width and depth (24 layers, d_model 896,
   vocab 151,655, 256 stub image tokens; 629.6 M parameters) with the
   port's ``Trainer`` running the step that the cell builder
   (``launch/steps.train_cell("internvl2-1b", "train_4k", (4, 1))``) gives,
   from a state and batch of the cell's local structs: four ranks, one
   process each on the one card, over
   gloo; one ``train_4k`` sequence of 4,096 tokens per rank (the batch cut
   from 256 to 4); ZeRO-3 with prefetched bf16 gathers and remat, the
   gradient of every one of the 219 leaves reduce-scattered by packed
   q = 16 recursive halving (bucket 4096, unrotated) through the encode
   and single-decode kernels; AdamW at lr 3e-4, 2 steps, no restart
   allowed, a checkpoint at the end.  Checks: a finite loss with the same
   bits on every rank; no restart; the bytes each rank sends per step ==
   ``wire_bytes_step``; one leaf-sync order on every rank; encode and
   single-decode launches == syncs x hops; layer 0's ``wq`` gradient
   shard within 0.51 s per quantization of the exact mean; a serial step
   equal bit for bit to the prefetching run's first; a packed and an
   unpacked step at 2 layers equal bit for bit; the FSDP backward at
   d = 2^18 on the card == on the CPU.  Prints each step's wall, gather,
   sync (and the embedding's and head's share), data and loss, each
   rank's peak device memory; the serial and the prefetching step run
   under ``torch.profiler`` (their times include its cost), and the
   ``train_trace`` line gives rank 0's device idle share over each and the
   share of its time in collective calls with no kernel of its own
   running.  Then it holds the encode and single decode against their
   plain versions at the path's largest hop (67,944,448 coordinates);
6a. while the card runs on, the dry run (``launch/dryrun.run_cell``)
   traces the same cell on the host, on ``meta`` tensors as rank 0 of a
   fake group of four, prefetching and serial; the ``dryrun_internvl2``
   line sets its prediction beside what phase 6 measured.  Checks: a
   rank's argument bytes, its encode and decode launches a step and its
   all-gather and ppermute bytes a step equal the measured ones; the
   static overlap audit reads the prefetching loop strictly below the
   serial one.  The predicted peak is printed beside
   ``max_memory_allocated``, the dot FLOPs beside the measured step time;
6b. trains internvl2-1b at full width and depth again, as a (dp 2, tp 2)
   mesh of the four ranks (``launch/mesh.mesh_axes``): sequence parallel
   (2,176 of the 4,352 tokens per TP rank), one 4,096-token sequence per
   DP rank shared by its two TP ranks (the global batch cut from 256 to
   2), the 97 replicated leaves' gradients (``wk``, ``wv``, the norms)
   psummed over TP through the quantized butterfly before the DP
   reduce-scatter, otherwise as phase 6.  Checks: a finite loss with the
   same bits on every rank; the replicated leaves bitwise equal on the two
   TP ranks of a DP group after every step; the bytes the DP syncs and the
   TP psums send == their wire accounting; encode and single-decode
   launches == DP syncs x hops + TP butterflies x rounds; layer 0's
   ``wk`` TP psum of step 0 again on the CPU over the same gloo group,
   bitwise; the checkpoint read back equal to the final parameters bit for
   bit; a serial step equal to the prefetching run's first.  Prints each
   step's wall, gather, DP sync, TP sync, SP activation, data, loss, peak
   memory and bytes per rank; then holds the encode and single decode
   against their plain versions at the phase's largest DP hop
   (33,972,224 coordinates) and at a butterfly's shapes (there also timed
   from a CUDA graph, and the wrappers' host microseconds per call);
6c. trains granite-moe-1b-a400m at full width, 12 of its 24 layers
   (d_model 1,024, 32 experts of d_ff 512, top-8, capacity factor 1.25,
   vocab 49,155) on the (dp 2, tp 2) mesh:
   sequence parallel (each TP rank routes 2,048 of its DP rank's 4,096
   tokens), 16 experts a TP rank behind two tiled all-to-alls a layer,
   the replicated leaves' gradients (the router's among them) psummed
   over TP through the quantized butterfly, otherwise as phase 6b, 2
   steps, no checkpoint.  Checks: a finite loss and ``aux`` on every rank
   at every step; the replicated leaves bitwise equal on the two TP ranks
   after every step; the bytes == the wire accounting; launches == DP
   syncs x hops + TP butterflies x rounds, counted from the metas; layer
   0's ``router`` TP psum of step 0 again on the CPU, bitwise; step 0's
   first all-to-all against the host's permutation of every TP rank's
   rows, bitwise.  Prints each step's wall, gather, DP sync, TP sync and
   SP-and-all-to-all times, loss, aux, peak memory, and the tokens each
   expert dropped at capacity in step 0;
6d. trains the other families at full width, each with the checks of
   6c's path (finite losses, bytes, launches == syncs x hops (+
   butterflies x rounds)): mamba2-1.3b (d_model 2,048, state 128, depth
   cut from 48 to 4 layers) for 2 steps and recurrentgemma-9b (d_model
   4,096, lru_width 4,096, window 2,048, vocab 256,000, depth cut from 38
   to 3 layers, one scanned unit; bf16 optimizer moments) for 1 step,
   both on the (2, 2) mesh with SP at 4,096 tokens; then whisper-small
   at full width and depth (12 + 12 layers, 1,500 stub frames, 448
   decoder tokens, one row a rank) over four DP ranks, 2 full steps of the
   cell builder's encoder-decoder train step (``make_encdec_loss_fn``,
   every leaf's quantized sync, AdamW, the ``y`` update), its losses and
   gnorms the same bits on every rank;
6e. serves (``models/serve.py``; no kernel runs there: the weights come
   through the FSDP gather's bf16 forward and attention is plain torch, as
   the reference's is plain jnp), four ranks on the card over gloo, each
   run's bf16 parameters drawn on the card from ``--seed``, a seeded
   prompt prefilled into a ``decode_32k`` cache of 32,768 positions (the
   prefill's K/V moved into the decode layout by ``_place_prefill``), then
   greedy decode steps, the first re-feeding the prompt's last token:
   ``serve_glm4_tp4``, glm4-9b at full width, 10 of its 40 layers, on
   (dp 1, tp 4) — g1 2 KV-head groups x g2 2 sequence shards, so the
   ``wq`` subgroup gather and the flash-decoding merge run — batch 16
   (cut from 128), a 256-token prompt and 8 steps, with the bf16 cache
   and then the int8 one (fed the bf16 run's tokens);
   ``serve_granite_moe_tp``, granite-moe-1b-a400m at full width, 12 of
   its 24 layers, on (2, 2) (the DP weight gathers and ``_moe_decode``),
   batch 16, 256 and 2, both caches; ``serve_families``, mamba2-1.3b (4
   layers),
   recurrentgemma-9b (3 layers) and whisper-small (full depth, its
   encoder over 1,500 stub frames) on (2, 2), batch 4, 64 and 2.  Checks: every
   TP rank returns the same tokens, ids below the vocab plus tp (its
   padding, the reference's own test's limit), every cache leaf of
   ``cache_struct``'s shape and dtype and finite, and the int8 cache
   within 2% of the bf16 cache's largest entry where both runs wrote the
   entry from the same values.  Prints prefill s, each step's wall and its
   parts (the FSDP gathers, the g2-subgroup and the TP collectives, the
   rest), tokens/s, peak GB a rank, a step's bytes (weights and cache,
   over the four ranks) against their HBM bound, the int8 cache's drift
   by layer, and the lattice kernels' launches (none);
7. runs the anchored multi-round service (``agg.service``) lockstep for
   three rounds at d = 277,845,504 (q = 16, bucket = 4096, y0 = 0.25),
   warm-started at ``base``; client i of round r sends
   ``base + 0.01 r drift + 0.02 N(0,1)``, made on the card from
   ``--seed``.  Each round's fleet of 8 is encoded in ONE launch over
   8 x 277,848,064 coordinates (past 2^31; the last client's frames must
   equal its own client's, byte for byte); checks that every client is
   accepted at attempt 0 in one batched decode launch, that the mean is
   within 0.51 s of the exact mean per coordinate (s of its bucket), and
   that round r+1's spec digest is the digest of round r's mean; prints
   each round's wall time, the time spent in anchor digests and max(y);
8. runs the sum-without-decode tree (``agg.tree``): 16 clients of round A
   over 4 edge tiers into the root, at full width, unanchored.  Checks
   that the tiers dispatch no decode, that the root makes one batched
   decode per color space it receives, and that the mean equals a flat
   server's drain of the same frames bit for bit; prints the q each tier
   forwarded at and the peak device memory; when a tier forwarded at
   q = 256, holds the batched decode at 8-bit colors against its plain
   version on the first 2^24 coordinates;
9. runs the continuous-round engine (``agg.engine``) through
   ``sim.run_open_loop`` at d = 2^22 (~80 Poisson clients, a flash crowd,
   churn, stragglers, 3% frame loss), every published round replayed
   bitwise through a lockstep server; then one trace at d = 2^18 through
   the engine and a 2-tier tree, once on the card and once on the CPU,
   bitwise equal;
10. runs a small round (d = 2^18, 8 clients) once on the card and once on
   the CPU (plain versions) and requires bitwise equal means, the same
   at q = 3 and at q = 2 (each drain its own path), and a chunked,
   windowed streaming round on the card that must equal the sealed drain
   bit for bit;
11. times the round's costs outside the kernels at full width (the threefry
   draws, the anchor digest, one CRC-32 pass over a frame);
12. runs attention through ``ops.flash_attention`` (``ATTENTION_CASES``)
   at four models' full widths: qwen3-32b prefill (64 query heads x
   head_dim 128, K/V expanded from its 8 KV heads, one sequence of
   ``prefill_32k``'s 32,768 tokens, the batch cut from 32 to 1; bf16,
   causal), nemotron-4-340b prefill (96 x 192 from 8 KV heads, one
   32,768-token sequence, the batch cut from 32; bf16, causal),
   recurrentgemma-9b prefill (16 x 256 from 1 KV head, one 32,768-token
   sequence, the batch cut from 32; bf16, causal) and training (8
   sequences of 4,096, the batch cut from 256; f32, causal and not), and
   granite-moe-1b-a400m training (16 heads x 64, K/V from 8 KV heads, 8
   sequences of ``train_4k``'s 4,096 tokens, the batch cut from 256 to 8;
   f32, causal and not, and f16, causal), and qwen3-32b's heads in f32
   (one sequence of 4,096, causal); then small head dims (16, every
   smoke config's, and 32 in bf16, both built; 48 in f32, padded to 64)
   and shapes the reference sends to its plain version (Sq = Sk = 1,000,
   causal, and 8 queries over 4,096 keys, at qwen3-32b's heads in bf16;
   8 causal queries over 4,096 keys, which stay on the long kernels, at
   qwen3-32b's heads in bf16 and granite-moe's in f32), few queries over
   many keys (qwen3-32b's heads, one query over a
   32,768-token cache, bf16; granite-moe's, 16 queries over 4,096 keys in
   f16 and f32: with the 8-query case, the split kernel's paths,
   ``csrc/flash_attention_split.cu``, one for each type), and head dims
   past 256 (16 heads, one sequence of 4,096, causal): 512 in bf16, f16
   and f32, and 320 in bf16 (padded to 384).  The bf16 and the f16 cases
   up to head dim 256 are the wgmma kernel's paths; the f32 ones up to 64
   the f32 wgmma kernel's (``csrc/flash_attention.cu``), at 128, 256 and
   512 the mma.sync kernel's (``csrc/flash_attention_wide.cu``), each width
   its own path, all three TF32 products on the tensor cores; past 256 the
   bf16 and f16 cases take the wide wgmma kernel
   (``csrc/flash_attention_wgmma_wide.cu``, one path for each case).  It times
   the kernel (one call; under 10 ms also ``device_ms``, events around
   R >= 20 back-to-back calls), holds its output on the first 2 of BH
   against the plain version (which holds a (BH, Sq, Sk) f32 score
   tensor, so it runs 2 of BH at a time), times the plain version over
   all of BH in chunks of 2, and times ``scaled_dot_product_attention`` on
   the same tensors as the library call (used nowhere in the port; the
   first of its backends that takes the shape, named; where the kernel has
   a ``device_ms``, SDPA's back to back too), printing SDPA's
   own share of the kernel's limit against the plain version as
   information.  The bound counts the unpadded head dim's operations, at
   the tensor cores' bf16 rate for bf16 and f16 (with, as information,
   the scores a second and ``exp_bound_ms``, one exponential a score at
   16 a clock an SM at the card's top SM clock), and for f32, whose kernel
   computes each product as three TF32 ones, three TF32 operations for
   each at the TF32 rate, the least time at f32 precision (the CUDA
   cores' f32 rate, a looser bound, as ``f32_rate_bound_ms``);
13. runs the paper's algorithms (``repro_torch.core``) on the card: at
   d = 277,845,504 with 4 machines (``base + 0.02 N(0,1)``, as the clients
   of round A), Algorithm 3 (star, q = 16), Algorithm 4 (tree, m = 4), the
   butterfly and variance reduction, each checked for ``decode_ok`` and
   against the exact mean within the lattice bound; at d = 2^24 a roundtrip
   of each of the ten compressors and Algorithm 5 with y0 ten times too
   small (it must escalate); at d = 2^18 with 8 machines the four DME
   functions give the same bits on the card as on the CPU.  This phase
   launches none of the kernels (the rotations there are the plain
   transform), and checks that;
14. prints the ``kernels`` line, then the ``ok`` line last.

Every count of kernel launches is set to 0 just before each main path
(rounds A and B; each rank's collectives, and each of their shape paths;
each rank's training runs, each family's among them; the service, the
tree and the engine phases; the drains at q = 3 and q = 2; each attention
kernel's path; the paper-algorithms phase) and read just after it; a
kernel of a path that was not launched there fails the run, and the
``kernels`` line sums the counts of the paths over all ranks.  Its
entries of the new shapes (``SHAPE_INSTANCES``) take their kernel's
launches on the paths that run them at that width: the FWHT's rows of
32,768 (q = 12), 65,536 and 1,048,576 on the rotated paths of those
buckets (``fwht_d1048576`` is the fused kernel's entry: its rows take one
launch of it).  Any failed check raises before the last line is printed.  Without a CUDA device, or without the port beside
it, the script exits with a nonzero code and prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import shutil
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 on the tensor cores, dense
TF32_OPS_PER_S = 495e12          # H100 SXM TF32 on the tensor cores, dense
SLICE = 1 << 24                  # coordinates compared against the plain version
FULL_D = 277_845_504             # whisper-small's parameter count
CLIENTS = 16                     # clients per full-width round
WORLD = 4                        # ranks of the collectives phase, one card
RANK_TIMEOUT_S = 600             # a rank that takes longer fails the run
SERVICE_ROUNDS = 3               # anchored rounds of the service phase
TRAIN_STEPS = 2                  # steps of the training phase (cut from 3)
TRAIN_SEQ = 4096                 # train_4k's sequence (one per rank)
TRAIN_HOP_N = 67_944_448         # the embedding's first RH hop (internvl2-1b)
TP_MESH = (2, 2)                 # (dp, tp) of the TP phase, one card
TRAIN_TP_STEPS = 2               # steps of the TP phase (cut from 3)
MOE_ARCH = "granite-moe-1b-a400m"  # the MoE phase's model (full width)
MOE_LAYERS = 12                  # its training depth (cut from 24)
MOE_STEPS = 2                    # steps of the MoE phase (cut from 3)
FAMILY_RUNS = (                  # (arch, layers, steps, optimizer state)
    ("mamba2-1.3b", 4, 2, "float32"),     # cut from 8 for the time limit
    ("recurrentgemma-9b", 3, 1, "bfloat16"),
)
WHISPER_DEC_SEQ = 448            # whisper-small's decoder tokens
WHISPER_STEPS = 2                # whisper-small's full training steps
SERVE_S_MAX = 32_768             # decode_32k's cache positions
# the serving phases' runs: batch cut from decode_32k's 128; for the time
# limit glm4 cut from 40 layers to 10, granite-moe from 24 to 12, mamba2
# from 48 to 4, the prompts of glm4 and granite from 512 tokens and the
# decode steps of glm4, granite and the families from 16, 8 and 8 (the
# same code runs fewer times)
SERVE_GLM4 = [dict(arch="glm4-9b", layers=10, mesh=(1, 4), batch=16,
                   prompt=256, new=8, kv_quant=(False, True))]
SERVE_GRANITE = [dict(arch=MOE_ARCH, layers=12, mesh=(2, 2), batch=16,
                      prompt=256, new=2, kv_quant=(False, True))]
SERVE_FAMILIES = [dict(arch=a, layers=n, mesh=(2, 2), batch=4, prompt=64,
                       new=2, kv_quant=(False,))
                  for a, n in (("mamba2-1.3b", 4), ("recurrentgemma-9b", 3),
                               ("whisper-small", None))]
TP_HOP_N = 33_972_224            # the TP phase's largest DP hop (embedding)
SERVICE_CLIENTS = 8              # clients per service round
TREE_FANOUT = 4                  # edge tiers of the tree phase
# the open-loop engine's traffic: 4096-coordinate buckets, ~80 clients
# (Poisson at 100/s over 0.5 s plus one flash crowd of 32)
ENGINE_TRAFFIC = dict(bucket=4096, rate=100.0)
KERNEL_SOURCES = {
    "lattice_encode": ("src/repro_torch/kernels/csrc/lattice_encode.cu",
                       "src/repro/kernels/lattice_encode.py:70"),
    "lattice_decode": ("src/repro_torch/kernels/csrc/lattice_decode.cu",
                       "src/repro/kernels/lattice_decode.py:93"),
    "lattice_decode_batched": ("src/repro_torch/kernels/csrc/lattice_decode.cu",
                               "src/repro/kernels/lattice_decode.py:180"),
    "fwht": ("src/repro_torch/kernels/csrc/fwht.cu",
             "src/repro/kernels/fwht.py:95"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wide_f32_d256": (
        "src/repro_torch/kernels/csrc/flash_attention_wide.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wide_f32_d128": (
        "src/repro_torch/kernels/csrc/flash_attention_wide.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wgmma": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wgmma_f16": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wgmma_wide": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma_wide.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wgmma_wide_f16": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma_wide.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wgmma_wide_d320": (
        "src/repro_torch/kernels/csrc/flash_attention_wgmma_wide.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_wide_f32": (
        "src/repro_torch/kernels/csrc/flash_attention_wide.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_split": (
        "src/repro_torch/kernels/csrc/flash_attention_split.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_split_f16": (
        "src/repro_torch/kernels/csrc/flash_attention_split.cu",
        "src/repro/kernels/flash_attention.py:62"),
    "flash_attention_split_f32": (
        "src/repro_torch/kernels/csrc/flash_attention_split.cu",
        "src/repro/kernels/flash_attention.py:62"),
}
# the instances of the shapes the reference's kernels do not take, each
# with its entry in the ``kernels`` line: (kernel, the color space q of a
# lattice instance (None for the FWHT), the paths whose launches of that
# kernel are its launches: the collectives' SHAPE_PATHS, ``drain_q<q>`` of
# small_rounds); each path runs the instance at the width of its check
SHAPE_INSTANCES = {
    "lattice_encode_q2": ("lattice_encode", 2,
                          ("q2_fails", "fsdp_lq_fails", "drain_q2")),
    "lattice_decode_q2": ("lattice_decode", 2, ("q2_fails", "fsdp_lq_fails")),
    "lattice_decode_batched_q2": ("lattice_decode_batched", 2,
                                  ("q2_fails", "drain_q2")),
    "lattice_encode_q3": ("lattice_encode", 3, ("q3", "drain_q3")),
    "lattice_decode_q3": ("lattice_decode", 3, ("q3",)),
    "lattice_decode_batched_q3": ("lattice_decode_batched", 3,
                                  ("q3", "drain_q3")),
    "lattice_encode_q12": ("lattice_encode", 12, ("q12_rot",)),
    "lattice_decode_q12": ("lattice_decode", 12, ("q12_rot",)),
    "lattice_decode_batched_q12": ("lattice_decode_batched", 12,
                                   ("q12_rot",)),
    "lattice_encode_n31": ("lattice_encode", 16, ("n31",)),
    "lattice_decode_n31": ("lattice_decode", 16, ("n31",)),
    "fwht_d2": ("fwht", None, ("n31_rot",)),
    "fwht_d32768": ("fwht", None, ("q12_rot",)),
    "fwht_d65536": ("fwht", None, ("d65536_rot",)),
    # the fused kernel (rows of 2^19 to 2^22)
    "fwht_d1048576": ("fwht", None, ("d1048576_rot",)),
}


def kernel_sources() -> "dict[str, tuple[str, str]]":
    """(source, replaced TPU kernel) of every entry of the ``kernels``
    line: ``KERNEL_SOURCES``, and for each of ``SHAPE_INSTANCES`` its
    kernel's, a lattice instance's from the library its q builds
    (``_build.lattice_library``)."""
    from repro_torch.kernels import _build

    out = dict(KERNEL_SOURCES)
    for name, (kernel, q, _) in SHAPE_INSTANCES.items():
        src, replaces = KERNEL_SOURCES[kernel]
        if q is not None:
            path = Path(src)
            src = str(path.with_stem(_build.lattice_library(
                path.stem, _build.pow2(q))))
        out[name] = (src, replaces)
    return out


# the kernels the rounds and the collectives launch
COLLECTIVE_KERNELS = ("lattice_encode", "lattice_decode",
                      "lattice_decode_batched", "fwht")
# (label, query heads, KV heads, head_dim, tokens (or (Sq, Sk)), sequences,
# dtype, causal); the first case of each dtype gives its kernel's entry in
# the ``kernels`` line
ATTENTION_CASES = (
    ("qwen3-32b prefill_32k", 64, 8, 128, 32_768, 1, "bfloat16", (True,)),
    ("granite-moe-1b-a400m train_4k", 16, 8, 64, 4_096, 8, "float32",
     (True, False)),
    ("nemotron-4-340b prefill_32k", 96, 8, 192, 32_768, 1, "bfloat16",
     (True,)),
    ("granite-moe-1b-a400m train_4k", 16, 8, 64, 4_096, 8, "float16",
     (True,)),
    ("recurrentgemma-9b prefill_32k", 16, 1, 256, 32_768, 1, "bfloat16",
     (True,)),
    ("recurrentgemma-9b train_4k", 16, 1, 256, 4_096, 8, "float32",
     (True, False)),
    # qwen3-32b's heads in f32 at S 4,096: the mma.sync kernel at D 128
    ("qwen3-32b heads, f32, S 4,096", 64, 8, 128, 4_096, 1, "float32",
     (True,)),
    # small head dims: every smoke config's width and 32, both built in
    # bf16, and one that no config has (f32, padded to 64 in the wrapper)
    ("smoke width (D 16)", 4, 2, 16, 4_096, 8, "bfloat16", (True,)),
    ("head dim 32", 8, 4, 32, 4_096, 8, "bfloat16", (True,)),
    ("padded D 48", 16, 8, 48, 4_096, 8, "float32", (True,)),
    # shapes the reference sends to its plain version, at qwen3-32b's heads
    ("qwen3-32b heads, Sq = Sk = 1,000", 64, 8, 128, 1_000, 1, "bfloat16",
     (True,)),
    ("qwen3-32b heads, Sq 8 over Sk 4,096", 64, 8, 128, (8, 4_096), 1,
     "bfloat16", (False,)),
    # few causal queries (each sees at most Sq keys) stay on the kernels
    # of long query tiles: the bf16 wgmma kernel and the f32 TF32 one
    ("qwen3-32b heads, causal Sq 8 over Sk 4,096", 64, 8, 128, (8, 4_096),
     1, "bfloat16", (True,)),
    ("granite-moe-1b-a400m heads, causal Sq 8 over Sk 4,096", 16, 8, 64,
     (8, 4_096), 8, "float32", (True,)),
    # few queries over many keys (the split kernel): one decode step over
    # a 32k cache, and 16 queries in f16 and f32
    ("qwen3-32b decode, Sq 1 over Sk 32,768", 64, 8, 128, (1, 32_768), 1,
     "bfloat16", (False,)),
    ("granite-moe-1b-a400m heads, Sq 16 over Sk 4,096", 16, 8, 64,
     (16, 4_096), 8, "float16", (False,)),
    ("granite-moe-1b-a400m heads, Sq 16 over Sk 4,096", 16, 8, 64,
     (16, 4_096), 8, "float32", (False,)),
    # past head dim 256 (no config of the repo's has it; the reference's
    # kernel takes any D): the wide kernels, D 320 padded to 384
    ("head dim 512, 16 heads", 16, 16, 512, 4_096, 1, "bfloat16", (True,)),
    ("head dim 512, 16 heads", 16, 16, 512, 4_096, 1, "float32", (True,)),
    ("head dim 512, 16 heads", 16, 16, 512, 4_096, 1, "float16", (True,)),
    ("head dim 320, 16 heads", 16, 16, 320, 4_096, 1, "bfloat16", (True,)),
)
# ops.flash_attention's kernel for each dtype up to head dim 256, f32 up
# to 64 (one launch count for all); bf16 and f16 are two instances of the
# wgmma kernel, with their own entries in the ``kernels`` line; f32 takes
# the TF32 wgmma kernel, whose entry keeps the name ``flash_attention``
ATTENTION_KERNEL = {"bfloat16": "flash_attention_wgmma",
                    "float32": "flash_attention",
                    "float16": "flash_attention_wgmma_f16"}
# past head dim 256 (f32: 64) the wide kernels, one entry for each (dtype,
# head dim) checked: bf16 and f16 take the wide wgmma kernel, f32 the
# mma.sync one (three TF32 passes on the tensor cores)
ATTENTION_WIDE = {("bfloat16", 512): "flash_attention_wgmma_wide",
                  ("float16", 512): "flash_attention_wgmma_wide_f16",
                  ("bfloat16", 320): "flash_attention_wgmma_wide_d320",
                  ("float32", 128): "flash_attention_wide_f32_d128",
                  ("float32", 256): "flash_attention_wide_f32_d256",
                  ("float32", 512): "flash_attention_wide_f32"}


# with at most 16 queries and no causal mask, up to head dim 256, the
# split kernel: one entry for each dtype
ATTENTION_SPLIT = {"bfloat16": "flash_attention_split",
                   "float16": "flash_attention_split_f16",
                   "float32": "flash_attention_split_f32"}


def attention_kernel(dt: str, hd: int, tokens, causals) -> str:
    """The ``kernels``-line entry of attention in ``dt`` at head dim hd
    over ``tokens`` (S, or (Sq, Sk)) with each of ``causals``, routed as
    ``kernel_of`` routes the calls (all of a case's to one kernel)."""
    import torch

    from repro_torch.kernels.flash_attention import SPLIT_LIB, kernel_of

    sq = tokens[0] if isinstance(tokens, tuple) else tokens
    libs = {kernel_of(getattr(torch, dt), hd, sq, c)[0] for c in causals}
    check(len(libs) == 1, f"the calls of one attention case take {libs}")
    if libs.pop() == SPLIT_LIB:
        return ATTENTION_SPLIT[dt]
    narrow = 64 if dt == "float32" else 256
    return ATTENTION_WIDE[(dt, hd)] if hd > narrow else ATTENTION_KERNEL[dt]
# the wgmma kernels' P.V takes two products (P split into hi and lo), so
# their tensor cores issue 1.5x the useful operations
BF16_ISSUED = 1.5
# the f32 kernel issues three TF32 products for each f32 one
TF32_ISSUED = 3
# exponentials a clock an SM (the special-function units; Shah et al.,
# FlashAttention-3, 2024: 3.9 TFLOP/s of them on an H100 SXM)
EXP_PER_CLOCK_SM = 16
# attention's cases under this many ms also get a ``device_ms``
DEVICE_MS_UNDER = 10.0
# (rtol, atol) of the kernel against its plain version.  Both compute in
# f32 and round once to the output type, so bf16 outputs differ by at most
# one bf16 step, 2^-7 of the value (rtol 1e-2 leaves a margin of 1.28),
# and f16 outputs by one f16 step, 2^-10 of the value (rtol 2e-3, a margin
# of 2.05); f32 outputs differ only by the order of the sums.
ATTENTION_TOL = {"bfloat16": (1e-2, 1e-5), "float32": (2e-4, 2e-4),
                 "float16": (2e-3, 1e-5)}


class SmokeError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(tag: str, **fields) -> None:
    print(f"{tag} {json.dumps(fields)}", flush=True)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
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


def device_ms(torch, fn, min_reps: int = 20, window_ms: float = 10.0,
              max_reps: int = 2000) -> "tuple[float, int]":
    """Milliseconds of one ``fn`` on the card: CUDA events around R
    back-to-back calls, over R, after a warm-up.  R is at least
    ``min_reps`` and large enough for a window of ``window_ms``.  Where the
    host's work per call outlasts the kernel (small shapes), this is the
    host's rate; ``graph_ms`` is then the device's.  Returns (ms, R)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    one = max(a.elapsed_time(b), 1e-3)
    reps = max(min_reps, min(max_reps, math.ceil(window_ms / one)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, reps


def graph_ms(torch, fn, reps: int) -> float:
    """Milliseconds of one ``fn`` on the card without the host's launch
    work: ``reps`` calls captured in one CUDA graph, replayed between two
    CUDA events, over ``reps``.  ``fn`` must launch on the current stream
    and copy nothing from the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def host_us_per_call(torch, fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn``: ``time.perf_counter`` over
    ``calls`` calls, then one synchronize, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> "tuple[float, str]":
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuobjdump(_build, name: str, what: str) -> str:
    """``cuobjdump <what>`` of a built kernel library (beside ``nvcc``)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), what, str(_build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_counts(sass: str, ops) -> dict:
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass)) for op in ops}


def ptxas_spills(report: str) -> dict:
    """Spill-store bytes of every function in a ptxas ``-v`` report."""
    return {fn: int(n) for fn, n in re.findall(
        r"Function properties for (\S+)\s*\n\s*\d+ bytes stack frame, "
        r"(\d+) bytes spill stores", report)}


def attention_sass(_build) -> dict:
    """Every instance of the attention kernels, one per (input type, head
    dim): the three wgmma kernels' (the f32 one in TF32) must show HGMMA
    (wgmma) and UTMALDG (TMA loads) in their SASS, the mma.sync kernel's
    HMMA and UTMALDG, the split kernel's HMMA and LDGSTS (cp.async), and
    none of the five libraries may have spilled (0 spill-store bytes in
    ptxas's report of this build, where this process built it, and no
    local memory in ``cuobjdump -res-usage``).  The bf16/f16 wgmma
    kernel's instances also report, as information, what its library
    states of them (``flash_attention.wgmma_residency``): blocks resident
    on an SM, consumer warpgroups a block, registers a thread."""
    import torch

    from repro_torch.kernels.flash_attention import (F32_HEAD_DIMS,
                                                     F32_WGMMA_HEAD_DIM,
                                                     GROUP, HEAD_DIMS,
                                                     WIDE_HEAD_DIMS,
                                                     wgmma_residency)

    halves = ("13__nv_bfloat16", "6__half")
    # by their mangled names: the f32 wgmma kernel (D 64 alone), the bf16
    # and f16 one at each (input type, head dim; up to 64 its small-D
    # kernel), the wide wgmma kernel at each (input type, half of the head
    # dim), the mma.sync kernel at each (input type, output columns of its
    # block: f32 at each of its head dims, every type at GROUP past them)
    wgmma = {f"flash_wgmma_{'small_' if d <= 64 else ''}kernelI{t}Li{d}E":
             (dt, d) for t, dt in zip(halves, (torch.bfloat16, torch.float16))
             for d in HEAD_DIMS}
    instances = {
        "flash_attention": ["flash_tf32_kernel"],
        "flash_attention_wgmma": list(wgmma),
        "flash_attention_wgmma_wide": [
            f"flash_wgmma_wide_kernelI{t}Li{d // 2}E"
            for t in halves for d in WIDE_HEAD_DIMS],
        "flash_attention_wide": [
            f"flash_wide_kernelIfLi{d}E" for d in F32_HEAD_DIMS
            if d > F32_WGMMA_HEAD_DIM] + [
            f"flash_wide_kernelI{t}Li{GROUP}E" for t in halves],
        "flash_attention_split": [
            f"flash_split_kernelI{t}Li{d}E" for t in halves
            for d in HEAD_DIMS] + [
            f"flash_split_kernelIfLi{d}E" for d in F32_HEAD_DIMS
            if d <= HEAD_DIMS[-1]]}
    out = {}
    for lib, names in instances.items():
        parts = re.split(r"Function : (\S+)", cuobjdump(_build, lib, "-sass"))
        bodies = dict(zip(parts[1::2], parts[2::2]))
        usage = res_usage(_build, lib)
        spills = ptxas_spills(_build.PTXAS_REPORT.get(lib, ""))
        for inst in names:
            found = [fn for fn in bodies if inst in fn]
            check(len(found) == 1, f"{lib}: {len(found)} functions named "
                  f"like {inst} in the SASS")
            fn = found[0]
            # the products and loads, then (information) what a score costs
            # beside them: exponentials, conversions, shuffles, barriers
            c = sass_counts(bodies[fn], ("HGMMA", "HMMA", "UTMALDG",
                                         "LDGSTS", "LDSM", "WARPGROUP.DEPBAR",
                                         "MUFU.EX2", "F2FP", "SHFL", "BAR"))
            c.update(usage.get(fn, {}), spill_store_bytes=spills.get(fn))
            mma = ("HMMA" if lib in ("flash_attention_wide",
                                     "flash_attention_split") else "HGMMA")
            load = "LDGSTS" if lib == "flash_attention_split" else "UTMALDG"
            check(c[mma] > 0 and c[load] > 0,
                  f"{fn}'s SASS has no {mma} or no {load}: {c}")
            check(c.get("local") == 0 and not c["spill_store_bytes"],
                  f"{lib} {fn} spilled: {c}")
            if inst in wgmma:
                (c["blocks_per_sm"], c["consumer_warpgroups"],
                 c["regs_per_thread"]) = wgmma_residency(
                     *wgmma[inst], torch.cuda.current_device())
            out[inst] = c
    return out


# the FWHT kernel at d = 4096, f32, 16-byte runs (its main paths' instance)
FWHT_MAIN = "fwht_kernelIfLi12ELb1E"


def fwht_sass(_build) -> dict:
    """The FWHT kernel's shared-memory and shuffle instructions at d = 4096
    in f32 (LDS, STS, SHFL in its SASS), its registers, static shared and
    local bytes (``cuobjdump -res-usage``); fails unless the transposes and
    the exchange are there and no instance of the library (the further
    launches of rows past 16,384 among them) uses local memory (ptxas
    spilled nothing)."""
    parts = re.split(r"Function : (\S+)", cuobjdump(_build, "fwht", "-sass"))
    bodies = [body for name, body in zip(parts[1::2], parts[2::2])
              if FWHT_MAIN in name]
    check(len(bodies) == 1, f"no single {FWHT_MAIN} in fwht's SASS")
    counts = sass_counts(bodies[0], ("LDS", "STS", "SHFL"))
    check(all(counts.values()), f"{FWHT_MAIN}'s SASS lacks LDS, STS or "
          f"SHFL: {counts}")
    usage = res_usage(_build, "fwht")
    main = [u for name, u in usage.items() if FWHT_MAIN in name]
    check(len(main) == 1, f"no single {FWHT_MAIN} in cuobjdump -res-usage")
    check(all(u["local"] == 0 for u in usage.values()),
          "an fwht kernel uses local memory (ptxas spilled)")
    # the cluster kernel of rows of 2^15 to 2^18 (one instance a row
    # length, type and alignment), the fused kernel of rows of 2^19 to 2^22
    # (the same, and at 2^22 the first launch of a longer row) and the
    # further launches of rows past 2^22 (one a bit count and output)
    found = {}
    for kind in ("fwht_cluster_kernel", "fwht_fused_kernel",
                 "fwht_high_kernel"):
        found[kind] = [u["registers"] for name, u in usage.items()
                       if kind in name]
        check(found[kind], f"no {kind} in cuobjdump -res-usage")
    cluster, fused, high = found.values()
    # the launcher's dynamic shared memory at d = 4096: one f32 tile
    return dict(function=FWHT_MAIN, counts=counts, **main[0],
                dynamic_shared_bytes=4 * 4096, instances=len(usage),
                cluster_instances=len(cluster),
                cluster_max_registers=max(cluster),
                fused_instances=len(fused), fused_max_registers=max(fused),
                high_instances=len(high), high_max_registers=max(high))


def res_usage(_build, name: str) -> dict:
    """Registers, stack, static shared and local bytes of every function in
    a built kernel library (``cuobjdump -res-usage``)."""
    return {fn: dict(zip(("registers", "stack", "shared", "local"),
                         map(int, vals)))
            for fn, *vals in re.findall(
                r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) "
                r"LOCAL:(\d+)", cuobjdump(_build, name, "-res-usage"))}


# the main instances of the encode and the single decode: 4-bit colors
# (q = 16), 16-byte accesses and q a power of two, template <BITS = 4,
# VEC = 4, ..., POW2 = true>; the encode's other template arguments are
# ANCHOR and COORDS, the decode's COORDS, REF and AVG
LATTICE_MAIN = {"lattice_encode": r"lattice_encode_kernelILi4ELi4E(Lb\dE){2}Lb1EE",
                "lattice_decode": r"lattice_decode_kernelILi4ELi4E(Lb\dE){3}Lb1EE"}
# the instances of the shapes the reference's kernels do not take, by
# library: 1-bit colors (BITS = 1) beside the main instances, and q not a
# power of two (POW2 = false, the last template argument) in the ``_any``
# libraries
LATTICE_NEW = {"lattice_encode": ("bits1", r"kernelILi1E"),
               "lattice_decode": ("bits1", r"kernelILi1E"),
               "lattice_encode_any": ("not_pow2", r"Lb0EEEv"),
               "lattice_decode_any": ("not_pow2", r"Lb0EEEv")}


def lattice_sass(_build) -> dict:
    """The encode's and the single decode's main instances must move their
    f32 and int32 streams with 128-bit global loads and stores
    (``LDG.E.128``, ``STG.E.128`` in the SASS; the encode without coords
    stores only its 16-bit units of words), and no instance of any kernel
    in the four lattice libraries may use local memory or a stack frame
    (ptxas spilled nothing): the instances of 1-bit colors and of q not a
    power of two among them, which are counted, with their registers."""
    out = {}
    for lib, (tag, pat) in LATTICE_NEW.items():
        usage = res_usage(_build, lib)
        check(usage and all(u["local"] == 0 and u["stack"] == 0
                            for u in usage.values()),
              f"a {lib} kernel uses local memory or a stack frame (ptxas "
              f"spilled): {usage}")
        regs = [u["registers"] for fn, u in usage.items()
                if re.search(pat, fn)]
        check(regs, f"{lib}: no instance of {tag} in the SASS")
        out[lib] = {"instances": len(usage), tag: dict(
            instances=len(regs), max_registers=max(regs))}
    for lib, main in LATTICE_MAIN.items():
        parts = re.split(r"Function : (\S+)", cuobjdump(_build, lib, "-sass"))
        bodies = {name: body for name, body in zip(parts[1::2], parts[2::2])
                  if re.search(main, name)}
        check(len(bodies) == (4 if lib == "lattice_encode" else 6),
              f"{lib}: {len(bodies)} main instances ({main}) in the SASS")
        usage = res_usage(_build, lib)
        inst = {}
        for name, body in bodies.items():
            ops = re.findall(r"\b((?:LDG|STG)(?:\.[A-Z0-9_]+)+)", body)
            c = {f"{op}_{w}": sum(o.startswith(op) and f".{w}" in o
                                  for o in ops)
                 for op in ("LDG", "STG") for w in (128, "U16")}
            c["registers"] = usage.get(name, {}).get("registers")
            stores_128 = (lib == "lattice_decode"
                          or re.search(r"kernelILi4ELi4ELb\dELb1E", name))
            check(c["LDG_128"] > 0 and (c["STG_128"] > 0 if stores_128
                                        else c["STG_U16"] > 0),
                  f"{lib} {name}: its streams do not move by 128-bit "
                  f"global loads and stores: {c}")
            inst[name] = c
        out[lib].update(main_instances=inst, max_registers=max(
            u["registers"] for u in usage.values()))
    return out


def max_abs_err(torch, got, want) -> float:
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def ends(n: int) -> "list[tuple[int, int]]":
    """The coordinate ranges held against the plain versions: the first
    and the last ``SLICE`` (one range when they overlap)."""
    if n <= SLICE:
        return [(0, n)]
    return [(0, SLICE), (n - SLICE, n)]


def kernel_checks(torch, n_pad: int, bucket: int, senders: int, seed: int):
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    q, bits = 16, 4
    nb = n_pad // bucket
    side = 2 * 0.25 / 15
    out = {}

    # --- encode: first attempt (words + coords), per-bucket sides drawn at
    # random around the round's side, so that a kernel reading another
    # bucket's side disagrees; once without an anchor (round A) and once
    # with one (round B)
    x = torch.randn(n_pad, generator=g, device=dev)
    u = torch.rand(n_pad, generator=g, device=dev) - 0.5
    sides = side * (0.5 + torch.rand(nb, generator=g, device=dev))
    a = x + 0.02 * torch.randn(n_pad, generator=g, device=dev)
    err = 0.0
    for anc in (None, a):
        words, k = ops.lattice_encode(x, u, sides, q=q, return_coords=True,
                                      anchor=anc, bucket=bucket)
        torch.cuda.synchronize()
        for c0, c1 in ends(n_pad):
            ww, wk = ref.lattice_encode_ref(
                x[c0:c1], u[c0:c1], sides[c0 // bucket:c1 // bucket], q=q,
                bits=bits, return_coords=True,
                anchor=None if anc is None else anc[c0:c1], bucket=bucket)
            check(torch.equal(words[c0 // 8:c1 // 8], ww)
                  and torch.equal(k[c0:c1], wk),
                  "lattice_encode disagrees with its plain version (anchor="
                  f"{anc is not None}, coordinates {c0}:{c1})")
            err = max(err, max_abs_err(torch, words[c0 // 8:c1 // 8], ww),
                      max_abs_err(torch, k[c0:c1], wk))
            del ww, wk
        del words, k
    ms = cuda_ms(torch, lambda: ops.lattice_encode(
        x, u, sides, q=q, return_coords=True, bucket=bucket))
    dms, reps = device_ms(torch, lambda: ops.lattice_encode(
        x, u, sides, q=q, return_coords=True, bucket=bucket))
    ms_anchored = cuda_ms(torch, lambda: ops.lattice_encode(
        x, u, sides, q=q, return_coords=True, anchor=a, bucket=bucket))
    dms_anchored, _ = device_ms(torch, lambda: ops.lattice_encode(
        x, u, sides, q=q, return_coords=True, anchor=a, bucket=bucket))
    del a

    def plain_encode():
        for c0 in range(0, n_pad, SLICE):
            c1 = min(n_pad, c0 + SLICE)
            ref.lattice_encode_ref(x[c0:c1], u[c0:c1],
                                   sides[c0 // bucket:c1 // bucket], q=q,
                                   bits=bits, return_coords=True,
                                   bucket=bucket)
    plain = cuda_ms(torch, plain_encode, reps=1)
    b, by = bound(n_pad * (4 + 4 + bits / 8 + 4) + nb * 4, n_pad * 4)
    b_anc, _ = bound(n_pad * (4 + 4 + 4 + bits / 8 + 4) + nb * 4, n_pad * 5)
    out["lattice_encode"] = dict(ms=ms, plain_ms=plain, bound_ms=b,
                                 bound_by=by, library_ms=None,
                                 max_abs_err=err,
                                 shape=f"N={n_pad}, q={q}, coords",
                                 device_ms=dms, reps=reps,
                                 share_of_bound=b / dms,
                                 anchored_ms=ms_anchored,
                                 anchored_device_ms=dms_anchored,
                                 anchored_bound_ms=b_anc,
                                 anchored_share_of_bound=b_anc / dms_anchored)

    # --- batched decode: coords mode, per-sender per-bucket sides, each
    # sender's drawn on its own around the round's side
    out["lattice_decode_batched"] = batched_decode_check(
        torch, x, u, q, senders, bucket, g)

    # --- single-payload decode, as the butterfly and recursive halving
    # launch it: coords mode with per-bucket sides drawn at random; also
    # coords with ref and points with the running-average epilogue, all
    # bitwise (the kernel rounds the same steps as the plain version)
    w1 = torch.randint(-(1 << 31), (1 << 31) - 1, (n_pad // 8,),
                       generator=g, device=dev, dtype=torch.int32)
    s1 = side * (0.5 + torch.rand(nb, generator=g, device=dev))
    r1 = 0.5 * x
    err = 0.0
    for mode, rr, avg in (("coords", None, None), ("coords", r1, None),
                          ("point", None, 3)):
        got = ops.lattice_decode(w1, x, u, s1, q=q, mode=mode, ref=rr,
                                 avg_cnt=avg, bucket=bucket)
        torch.cuda.synchronize()
        for c0, c1 in ends(n_pad):
            want = ref.lattice_decode_ref(
                w1[c0 // 8:c1 // 8], x[c0:c1], u[c0:c1],
                s1[c0 // bucket:c1 // bucket], q=q, bits=bits, n=c1 - c0,
                mode=mode, avg_cnt=avg, bucket=bucket,
                ref=None if rr is None else rr[c0:c1])
            check(torch.equal(got[c0:c1].view(torch.int32),
                              want.view(torch.int32)),
                  f"lattice_decode disagrees with its plain version ({mode}, "
                  f"ref={rr is not None}, avg_cnt={avg}, coordinates "
                  f"{c0}:{c1})")
            err = max(err, max_abs_err(torch, got[c0:c1], want))
            del want
        del got
    del r1
    ms = cuda_ms(torch, lambda: ops.lattice_decode(
        w1, x, u, s1, q=q, mode="coords", bucket=bucket))
    dms, reps = device_ms(torch, lambda: ops.lattice_decode(
        w1, x, u, s1, q=q, mode="coords", bucket=bucket))

    def plain_single():
        for c0 in range(0, n_pad, SLICE):
            c1 = min(n_pad, c0 + SLICE)
            ref.lattice_decode_ref(w1[c0 // 8:c1 // 8], x[c0:c1], u[c0:c1],
                                   s1[c0 // bucket:c1 // bucket], q=q,
                                   bits=bits, n=c1 - c0, mode="coords",
                                   bucket=bucket)
    plain = cuda_ms(torch, plain_single, reps=1)
    b, by = bound(n_pad * (bits / 8 + 4 + 4 + 4) + nb * 4, n_pad * 4)
    out["lattice_decode"] = dict(
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None,
        max_abs_err=err, shape=f"N={n_pad}, q={q}, coords, per-bucket sides",
        device_ms=dms, reps=reps, share_of_bound=b / dms)
    del w1, s1, u
    torch.cuda.empty_cache()

    out["fwht"] = fwht_check(torch, x, nb, bucket, g)
    del x
    torch.cuda.empty_cache()
    for name, r in out.items():
        say("kernel_check", name=name, **r)
    return out


def batched_decode_check(torch, x, u, q: int, senders: int, bucket: int,
                         g) -> dict:
    """The batched decode of ``senders`` random payloads at color space q
    against anchor x and dither u, in coords mode with per-sender
    per-bucket sides: bitwise against its plain version on the first 2^24
    coordinates, timed at the full shape."""
    from repro_torch.core import lattice as L
    from repro_torch.kernels import ops, ref

    dev = x.device
    n_pad = x.shape[0]
    bits = L.bits_for_q(q)
    nb = n_pad // bucket
    side = 2 * 0.25 / 15
    words = torch.randint(-(1 << 31), (1 << 31) - 1,
                          (senders, L.packed_len(n_pad, bits)), generator=g,
                          device=dev, dtype=torch.int32)
    s_s = side * (0.5 + torch.rand((senders, nb), generator=g, device=dev))
    L_ = min(SLICE, n_pad)
    per = 32 // bits
    kd = ops.lattice_decode_batched(words, x, u, s_s, q=q, mode="coords",
                                    bucket=bucket)
    torch.cuda.synchronize()
    want = ref.lattice_decode_batched_ref(
        words[:, :L_ // per], x[:L_], u[:L_], s_s[:, :L_ // bucket], q=q,
        bits=bits, n=L_, mode="coords", bucket=bucket)
    check(torch.equal(kd[:, :L_], want),
          f"lattice_decode_batched at q = {q} disagrees with its plain "
          "version")
    err = max_abs_err(torch, kd[:, :L_], want)
    del kd, want
    ms = cuda_ms(torch, lambda: ops.lattice_decode_batched(
        words, x, u, s_s, q=q, mode="coords", bucket=bucket))
    dms, reps = device_ms(torch, lambda: ops.lattice_decode_batched(
        words, x, u, s_s, q=q, mode="coords", bucket=bucket))
    step = max(bucket, (SLICE // senders) // bucket * bucket)

    def plain():
        for c0 in range(0, n_pad, step):
            c1 = min(n_pad, c0 + step)
            ref.lattice_decode_batched_ref(
                words[:, c0 // per:c1 // per], x[c0:c1], u[c0:c1],
                s_s[:, c0 // bucket:c1 // bucket], q=q, bits=bits,
                n=c1 - c0, mode="coords", bucket=bucket)
    plain_ms = cuda_ms(torch, plain, reps=1)
    b, by = bound(senders * n_pad * (bits / 8 + 4) + n_pad * 8
                  + senders * nb * 4, senders * n_pad * 4)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=None, max_abs_err=err,
                shape=f"S={senders}, N={n_pad}, q={q}, coords",
                device_ms=dms, reps=reps, share_of_bound=b / dms)


def fwht_check(torch, x, nb: int, bucket: int, g) -> dict:
    """The FWHT at the main paths' shape, (nb, bucket) f32, timed in f32
    and in bf16.  Bitwise against its plain version (the kernel runs the
    plain version's stage order): on the first 2^24 coordinates of that
    shape; at every row length it takes, f32 and bf16, on 301 rows (the
    last tile of rows shorter than a tile is ragged); and on two views off
    a 16-byte boundary, ``x[1:]`` of a (rows, 4) bf16 tensor and an f32
    view one element into a flat buffer."""
    from repro_torch.kernels import ops, ref

    dev = x.device

    def same(got, want, what):
        it = torch.int32 if got.dtype == torch.float32 else torch.int16
        check(got.dtype == want.dtype and torch.equal(got.view(it),
                                                      want.view(it)),
              f"fwht disagrees with its plain version ({what})")

    xb = x.reshape(nb, bucket)
    rows = max(1, min(nb, SLICE // bucket))
    y = ops.fwht(xb)
    torch.cuda.synchronize()
    want = ref.fwht_ref(xb[:rows])
    same(y[:rows], want, f"first {rows} rows of ({nb}, {bucket}) f32")
    err = max_abs_err(torch, y[:rows], want)
    del y, want
    cases = 1
    for k in range(2, 15):
        for dt in (torch.float32, torch.bfloat16):
            xs = torch.randn((301, 1 << k), generator=g, device=dev).to(dt)
            same(ops.fwht(xs), ref.fwht_ref(xs), f"(301, {1 << k}) {dt}")
            cases += 1
    views = (torch.randn((301, 4), generator=g, device=dev)
             .to(torch.bfloat16)[1:],
             torch.randn(301 * 64 + 1, generator=g, device=dev)[1:]
             .view(301, 64))
    for v in views:
        check(v.data_ptr() % 16 != 0, "the misaligned view is aligned")
        same(ops.fwht(v), ref.fwht_ref(v),
             f"view {tuple(v.shape)} {v.dtype} {v.data_ptr() % 16} bytes "
             "off a 16-byte boundary")
        cases += 1
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: ops.fwht(xb), reps=20)
    dms, reps = device_ms(torch, lambda: ops.fwht(xb))

    def plain_fwht():
        for r0 in range(0, nb, rows):
            ref.fwht_ref(xb[r0:r0 + rows])
    plain = cuda_ms(torch, plain_fwht, reps=1)
    # the yardstick: one dense product with the scaled Hadamard matrix
    # (full f32, TF32 off), timed here and used nowhere in the port
    torch.backends.cuda.matmul.allow_tf32 = False
    h = hadamard(torch, bucket, dev)
    lib = cuda_ms(torch, lambda: torch.matmul(xb, h), reps=3)
    del h
    xh = xb.to(torch.bfloat16)
    ms_bf16 = cuda_ms(torch, lambda: ops.fwht(xh), reps=20)
    # what the card's own copy takes for the same bytes (information)
    o = torch.empty_like(xb)
    copy_ms = cuda_ms(torch, lambda: o.copy_(xb), reps=20)
    o = torch.empty_like(xh)
    copy_bf16 = cuda_ms(torch, lambda: o.copy_(xh), reps=20)
    del xh, o
    n = nb * bucket
    logd = bucket.bit_length() - 1
    b, by = bound(n * 8, n * (logd + 1))
    b16, _ = bound(n * 4, n * (logd + 1))
    return dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                library_ms=lib, max_abs_err=err,
                shape=f"({nb}, {bucket}) f32", share_of_bound=b / ms,
                device_ms=dms, reps=reps, device_share_of_bound=b / dms,
                copy_ms=copy_ms, bf16_ms=ms_bf16, bf16_bound_ms=b16,
                bf16_share_of_bound=b16 / ms_bf16, bf16_copy_ms=copy_bf16,
                bitwise_cases=cases)


# the kernels at the shapes the reference's kernels do not take: color
# spaces (1-bit q = 2; q = 3 and 12, not powers of two), a payload of n < 32
# and FWHT rows of 2 and past 16,384: (rows, d) of each FWHT check
SHAPE_QS = (2, 3, 12)
SHAPE_N = 31
FWHT_SHAPES = ((8_479, 1 << 15), (4_239, 1 << 16), (1_059, 1 << 18),
               (264, 1 << 20), (66, 1 << 22), (33, 1 << 23),
               (FULL_D // 2, 2))


def encode_check(torch, x, u, sides, q: int, bucket: int) -> dict:
    """The encode (words and coords, per-bucket sides, no anchor) at color
    space q: bitwise against its plain version on ``ends(n)``, timed at the
    full shape."""
    from repro_torch.core import lattice as L
    from repro_torch.kernels import ops, ref

    n = x.shape[0]
    bits = L.bits_for_q(q)
    per = 32 // bits
    words, k = ops.lattice_encode(x, u, sides, q=q, return_coords=True,
                                  bucket=bucket)
    torch.cuda.synchronize()
    err = 0.0
    for c0, c1 in ends(n):
        ww, wk = ref.lattice_encode_ref(
            x[c0:c1], u[c0:c1], sides[c0 // bucket:-(-c1 // bucket)], q=q,
            bits=bits, return_coords=True, bucket=bucket)
        got_w = words[c0 // per:-(-c1 // per)]
        check(torch.equal(got_w, ww) and torch.equal(k[c0:c1], wk),
              f"lattice_encode at q = {q}, n = {n} disagrees with its plain "
              f"version (coordinates {c0}:{c1})")
        err = max(err, max_abs_err(torch, got_w, ww),
                  max_abs_err(torch, k[c0:c1], wk))
    del words, k

    def call():
        ops.lattice_encode(x, u, sides, q=q, return_coords=True,
                           bucket=bucket)
    ms = cuda_ms(torch, call)
    dms, reps = device_ms(torch, call)

    def plain():
        for c0 in range(0, n, SLICE):
            c1 = min(n, c0 + SLICE)
            ref.lattice_encode_ref(x[c0:c1], u[c0:c1],
                                   sides[c0 // bucket:-(-c1 // bucket)], q=q,
                                   bits=bits, return_coords=True,
                                   bucket=bucket)
    nb = sides.shape[0]
    b, by = bound(n * (4 + 4 + bits / 8 + 4) + nb * 4, n * 4)
    return dict(ms=ms, plain_ms=cuda_ms(torch, plain, reps=1), bound_ms=b,
                bound_by=by, library_ms=None, max_abs_err=err,
                shape=f"N={n}, q={q}, coords", device_ms=dms, reps=reps,
                share_of_bound=b / dms)


def single_decode_check(torch, x, u, sides, q: int, bucket: int, g) -> dict:
    """The single decode of one random payload at color space q against
    anchor x, coords mode with per-bucket sides, as the butterfly and
    recursive halving launch it: bitwise against its plain version on
    ``ends(n)``, timed at the full shape."""
    from repro_torch.core import lattice as L
    from repro_torch.kernels import ops, ref

    n = x.shape[0]
    bits = L.bits_for_q(q)
    per = 32 // bits
    words = torch.randint(-(1 << 31), (1 << 31) - 1, (L.packed_len(n, bits),),
                          generator=g, device=x.device, dtype=torch.int32)
    got = ops.lattice_decode(words, x, u, sides, q=q, mode="coords",
                             bucket=bucket)
    torch.cuda.synchronize()
    err = 0.0
    for c0, c1 in ends(n):
        want = ref.lattice_decode_ref(
            words[c0 // per:-(-c1 // per)], x[c0:c1], u[c0:c1],
            sides[c0 // bucket:-(-c1 // bucket)], q=q, bits=bits, n=c1 - c0,
            mode="coords", bucket=bucket)
        check(torch.equal(got[c0:c1], want),
              f"lattice_decode at q = {q}, n = {n} disagrees with its plain "
              f"version (coordinates {c0}:{c1})")
        err = max(err, max_abs_err(torch, got[c0:c1], want))
    del got

    def call():
        ops.lattice_decode(words, x, u, sides, q=q, mode="coords",
                           bucket=bucket)
    ms = cuda_ms(torch, call)
    dms, reps = device_ms(torch, call)

    def plain():
        for c0 in range(0, n, SLICE):
            c1 = min(n, c0 + SLICE)
            ref.lattice_decode_ref(
                words[c0 // per:-(-c1 // per)], x[c0:c1], u[c0:c1],
                sides[c0 // bucket:-(-c1 // bucket)], q=q, bits=bits,
                n=c1 - c0, mode="coords", bucket=bucket)
    nb = sides.shape[0]
    b, by = bound(n * (bits / 8 + 4 + 4 + 4) + nb * 4, n * 4)
    return dict(ms=ms, plain_ms=cuda_ms(torch, plain, reps=1), bound_ms=b,
                bound_by=by, library_ms=None, max_abs_err=err,
                shape=f"N={n}, q={q}, coords, per-bucket sides",
                device_ms=dms, reps=reps, share_of_bound=b / dms)


# the longest FWHT row timed against a product with the Hadamard matrix
# (17 GB of f32 at 2^16)
LIBRARY_FWHT_D = 1 << 16


def hadamard(torch, d: int, dev):
    """The scaled Hadamard matrix of order d (a power of two), f32, in
    natural order: the Kronecker power of [[1, 1], [1, -1]] times
    f32(1/sqrt(d)), the plain FWHT of the identity bit for bit (the plain
    version's temporaries of the identity would not fit at 2^16)."""
    import numpy as np

    h2 = torch.tensor([[1.0, 1.0], [1.0, -1.0]], device=dev)
    h = torch.ones((1, 1), device=dev)
    for _ in range(d.bit_length() - 1):
        h = torch.kron(h, h2)
    return h.mul_(float(np.float32(1.0 / np.sqrt(d))))


def fwht_shape_check(torch, rows: int, d: int, g) -> dict:
    """The FWHT over (rows, d) f32 and bf16: bitwise against its plain
    version on the leading rows that hold ``SLICE`` coordinates, launches
    counted, timed at the full shape.  The bound is one read and one write
    of the data; rows of up to 2^22 take one launch (past 16,384 the
    cluster kernel, past 2^18 the fused kernel), longer rows 1 +
    ``fwht_passes``, each a read and a write.  The yardstick (``library_ms``) is one f32 product with the
    scaled Hadamard matrix (TF32 off) up to ``LIBRARY_FWHT_D``, the matrix
    built in blocks of rows (``hadamard``); past it the matrix alone (d^2
    f32, 275 GB at 2^18) would not fit on the card: none.  The product's
    largest difference from the plain version on the compared rows is
    ``library_max_abs_err`` (information)."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.fwht import fwht_passes

    dev = torch.device("cuda")
    x = torch.randn((rows, d), generator=g, device=dev)
    cmp_rows = max(1, min(rows, SLICE // d))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(dt)
        before = _build.LAUNCHES["fwht"]
        y = ops.fwht(xt)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES["fwht"] - before
        want_launches = 1 + len(fwht_passes(d))
        check(launches == want_launches,
              f"fwht of ({rows}, {d}): {launches} launches, not "
              f"{want_launches}")
        it = torch.int32 if dt == torch.float32 else torch.int16
        want = ref.fwht_ref(xt[:cmp_rows])
        check(torch.equal(y[:cmp_rows].view(it), want.view(it)),
              f"fwht of ({rows}, {d}) {dt} disagrees with its plain version")
        err = max_abs_err(torch, y[:cmp_rows], want)
        del y, want
        ms = cuda_ms(torch, lambda: ops.fwht(xt), reps=20)
        dms, reps = device_ms(torch, lambda: ops.fwht(xt))

        def plain():
            for r0 in range(0, rows, cmp_rows):
                ref.fwht_ref(xt[r0:r0 + cmp_rows])
        plain_ms = cuda_ms(torch, plain, reps=1)
        n = rows * d
        elt = xt.element_size()
        # log2(d) stages and the scale a coordinate
        b, by = bound(n * 2 * elt, n * d.bit_length())
        tag = "" if dt == torch.float32 else "bf16_"
        out.update({f"{tag}ms": ms, f"{tag}plain_ms": plain_ms,
                    f"{tag}bound_ms": b, f"{tag}device_ms": dms,
                    f"{tag}reps": reps, f"{tag}share_of_bound": b / dms,
                    f"{tag}max_abs_err": err, f"{tag}launches_a_call": launches})
        if dt == torch.float32:
            out["bound_by"] = by
        del xt
    lib = None
    if d <= LIBRARY_FWHT_D:
        torch.backends.cuda.matmul.allow_tf32 = False
        h = hadamard(torch, d, dev)
        lib = cuda_ms(torch, lambda: torch.matmul(x, h), reps=1)
        out["library_max_abs_err"] = max_abs_err(
            torch, torch.matmul(x[:cmp_rows], h), ref.fwht_ref(x[:cmp_rows]))
        del h
    del x
    torch.cuda.empty_cache()
    out.update(library_ms=lib, shape=f"({rows}, {d}) f32 and bf16",
               max_abs_err=max(out["max_abs_err"], out["bf16_max_abs_err"]))
    return out


def shape_kernel_checks(torch, n_pad: int, bucket: int, senders: int,
                        seed: int) -> dict:
    """Each kernel instance of the shapes the reference's kernels do not
    take against its plain version at full width (n_pad coordinates,
    per-bucket sides of ``bucket``, ``senders`` payloads for the batched
    decode): the encode, the single decode and the batched decode at each
    of ``SHAPE_QS``; the encode and the single decode at n = 31; the FWHT
    at each of ``FWHT_SHAPES``.  One ``kernel_check`` line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    nb = n_pad // bucket
    x = torch.randn(n_pad, generator=g, device=dev)
    u = torch.rand(n_pad, generator=g, device=dev) - 0.5
    out = {}
    for q in SHAPE_QS:
        # sides about the round's (y0 = 0.25), drawn per bucket
        sides = 2 * 0.25 / (q - 1) * (0.5 + torch.rand(nb, generator=g,
                                                       device=dev))
        out[f"lattice_encode_q{q}"] = encode_check(torch, x, u, sides, q,
                                                   bucket)
        out[f"lattice_decode_q{q}"] = single_decode_check(torch, x, u, sides,
                                                          q, bucket, g)
        out[f"lattice_decode_batched_q{q}"] = batched_decode_check(
            torch, x, u, q, senders, bucket, g)
        torch.cuda.empty_cache()
    sides = 2 * 0.25 / 15 * (0.5 + torch.rand(1, generator=g, device=dev))
    xs, us = x[:SHAPE_N].clone(), u[:SHAPE_N].clone()
    out[f"lattice_encode_n{SHAPE_N}"] = encode_check(torch, xs, us, sides, 16,
                                                     bucket)
    out[f"lattice_decode_n{SHAPE_N}"] = single_decode_check(
        torch, xs, us, sides, 16, bucket, g)
    del x, u
    torch.cuda.empty_cache()
    for rows, d in FWHT_SHAPES:
        out[f"fwht_d{d}"] = fwht_shape_check(torch, rows, d, g)
    for name, r in out.items():
        say("kernel_check", name=name, **r)
    return out


# ---------------------------------------------------------------------------
# Phases 3-4: the round at full width
# ---------------------------------------------------------------------------

def client_vector(torch, base, seed: int, i: int):
    g = torch.Generator(device=base.device).manual_seed(seed * 1000 + 1 + i)
    return base + 0.02 * torch.randn(base.shape[0], generator=g,
                                     device=base.device)


@contextlib.contextmanager
def drain_timers(torch, acc):
    """While open, time (host clock, synchronized on both sides) every call
    of the server's drain math into ``acc["drain_math"]`` and every batched
    decode into ``acc["decode"]``; both functions are restored on exit."""
    from repro_torch.agg import server as server_mod
    from repro_torch.kernels import ops

    def timed(fn, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return r
        return call

    math, decode = server_mod._drain_math, ops.lattice_decode_batched
    server_mod._drain_math = timed(math, "drain_math")
    ops.lattice_decode_batched = timed(decode, "decode")
    try:
        yield
    finally:
        server_mod._drain_math, ops.lattice_decode_batched = math, decode


def run_round(torch, spec, base, anchor, n_clients: int, seed: int):
    """Encode every client one at a time, frame to bytes, receive, drain,
    finalize; returns (mean, stats, exact mean (f64), per-phase seconds,
    decode launches in the drain, responses)."""
    from repro_torch.agg.client import AggClient
    from repro_torch.agg.server import AggServer
    from repro_torch.kernels import _build

    t = dict(encode=0.0, frame=0.0, receive=0.0, drain=0.0, finalize=0.0)
    t0 = time.perf_counter()
    server = AggServer(spec, base if anchor is None else anchor)
    torch.cuda.synchronize()
    t["server_setup"] = time.perf_counter() - t0
    exact = torch.zeros(spec.d, dtype=torch.float64, device=base.device)
    for i in range(n_clients):
        x = client_vector(torch, base, seed, i)
        exact += x.to(torch.float64)
        t0 = time.perf_counter()
        c = AggClient(spec, i, x, anchor=anchor)
        c.encode()                      # ends in a device-to-host copy
        t1 = time.perf_counter()
        frames = c.frames()
        t2 = time.perf_counter()
        del c, x
        for f in frames:
            r = server.receive(f)
        t3 = time.perf_counter()
        t["encode"] += t1 - t0
        t["frame"] += t2 - t1
        t["receive"] += t3 - t2
        del frames, r
    exact /= n_clients
    before = _build.LAUNCHES["lattice_decode_batched"]
    split = dict(drain_math=0.0, decode=0.0)
    t0 = time.perf_counter()
    with drain_timers(torch, split):
        responses = server.drain()
    torch.cuda.synchronize()
    t["drain"] = time.perf_counter() - t0
    # the drain's parts: stacking the payloads and uploading them (with the
    # little host work after the math), the decode launch, the epilogue
    t["drain_upload_and_host"] = t["drain"] - split["drain_math"]
    t["drain_decode"] = split["decode"]
    t["drain_epilogue"] = split["drain_math"] - split["decode"]
    launches = _build.LAUNCHES["lattice_decode_batched"] - before
    t0 = time.perf_counter()
    mean, stats = server.finalize()
    torch.cuda.synchronize()
    t["finalize"] = time.perf_counter() - t0
    return mean, stats, exact, t, launches, responses


def check_responses(responses, n_clients: int, tag: str) -> None:
    from repro_torch.agg.transport import frame as wire
    rs = [wire.decode_response(b) for b in responses]
    acks = sorted(r.client_id for r in rs if r.status == wire.STATUS_ACK)
    check(acks == list(range(n_clients)),
          f"{tag}: not every client was ACKed at attempt 0: {acks}")


def rounds_ab(torch, d: int, n_clients: int, seed: int):
    from repro_torch.agg import rounds
    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(d, generator=g, device=dev)
    cfg = QSyncConfig(q=16, bucket=4096)
    spec_a = wire.RoundSpec(round_id=1, d=d, cfg=cfg, y0=0.25, seed=seed)
    s = 2 * spec_a.y0 / (cfg.q - 1)

    _build.reset_launch_counts()
    ops.reset_dispatch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mean_a, stats_a, exact, t_a, dec_a, resp_a = run_round(
        torch, spec_a, base, None, n_clients, seed)
    wall_a = time.perf_counter() - t0
    check_responses(resp_a, n_clients, "round A")
    check(dec_a == 1, f"round A drain made {dec_a} batched decode launches")
    check(stats_a.accepted == n_clients and stats_a.decode_failures == 0,
          f"round A accepted {stats_a.accepted} of {n_clients}")
    check(tuple(mean_a.shape) == (d,) and bool(torch.isfinite(mean_a).all()),
          "round A mean is not a finite (d,) vector")
    err_a = float((mean_a.to(torch.float64) - exact).abs().max())
    check(err_a <= 0.51 * s,
          f"round A: max |mean - exact| = {err_a} > 0.51 s = {0.51 * s}")
    enc_a = dict(_build.LAUNCHES)
    say("round_A", d=d, padded=spec_a.padded, clients=n_clients,
        accepted=stats_a.accepted, attempt0=True, decode_launches=dec_a,
        encode_launches=enc_a["lattice_encode"],
        fwht_launches=enc_a["fwht"], max_abs_err=err_a,
        bound=0.51 * s, seconds=t_a, wall_s=wall_a,
        payload_bytes=wire.payload_bytes(spec_a),
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    del exact

    anchor = mean_a
    spec_b = dataclasses.replace(
        spec_a, round_id=2, cfg=dataclasses.replace(cfg, rotate=True),
        anchor_digest=rounds.anchor_digest(anchor))
    t0 = time.perf_counter()
    mean_b, stats_b, exact, t_b, dec_b, resp_b = run_round(
        torch, spec_b, base, anchor, n_clients, seed)
    wall_b = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)     # read just after the main path
    check_responses(resp_b, n_clients, "round B")
    check(dec_b == 1, f"round B drain made {dec_b} batched decode launches")
    check(tuple(mean_b.shape) == (d,) and bool(torch.isfinite(mean_b).all()),
          "round B mean is not a finite (d,) vector")
    l2 = float(torch.linalg.vector_norm(mean_b.to(torch.float64) - exact))
    lim = 0.51 * s * spec_b.padded ** 0.5
    check(l2 <= lim, f"round B: ||mean - exact||_2 = {l2} > {lim}")
    say("round_B", d=d, clients=n_clients, accepted=stats_b.accepted,
        decode_launches=dec_b,
        encode_launches=counts["lattice_encode"] - enc_a["lattice_encode"],
        fwht_launches=counts["fwht"] - enc_a["fwht"], l2_err=l2, bound=lim,
        seconds=t_b, wall_s=wall_b)
    for name in ("lattice_encode", "lattice_decode_batched", "fwht"):
        check(counts[name] > 0,
              f"kernel {name} was not launched on the main path")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: card vs CPU, and the streaming drain
# ---------------------------------------------------------------------------

def small_rounds(torch, seed: int) -> dict:
    import numpy as np

    from repro_torch.agg.client import AggClient
    from repro_torch.agg.server import AggServer
    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig

    d, n = 1 << 18, 8
    rng = np.random.RandomState(seed)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(n, d).astype(np.float32)
    spec = wire.RoundSpec(round_id=5, d=d, cfg=QSyncConfig(q=16, bucket=4096),
                          y0=0.25, seed=seed)
    means = {}
    for dev in ("cuda", "cpu"):
        server = AggServer(spec, base, device=dev)
        for i in range(n):
            server.receive(AggClient(spec, i, xs[i], device=dev).payload())
        means[dev] = server.finalize()[0].cpu().numpy()
    check(np.array_equal(means["cuda"].view(np.uint32),
                         means["cpu"].view(np.uint32)),
          "small round: the card's mean differs from the CPU's")

    # drains at q = 3 (2-bit colors, q not a power of two) and q = 2 (1-bit
    # colors), each its own path on the card (the counts set to 0 just
    # before it and read just after), then on the CPU: the same clients
    # accepted, the same mean bit for bit
    from repro_torch.kernels import _build
    drains = {}
    for q in (3, 2):
        spec_q = dataclasses.replace(spec, round_id=7 + q,
                                     cfg=QSyncConfig(q=q, bucket=4096))
        got = {}
        for dev in ("cuda", "cpu"):
            if dev == "cuda":
                _build.reset_launch_counts()
            server = AggServer(spec_q, base, device=dev)
            for i in range(n):
                server.receive(AggClient(spec_q, i, xs[i],
                                         device=dev).payload())
            mean, stats = server.finalize()
            if dev == "cuda":
                torch.cuda.synchronize()
                drains[q] = dict(_build.LAUNCHES)    # read just after
            got[dev] = (mean.cpu().numpy(), stats.accepted)
        check(got["cuda"][1] == got["cpu"][1]
              and np.array_equal(got["cuda"][0].view(np.uint32),
                                 got["cpu"][0].view(np.uint32)),
              f"small round at q = {q}: the card's drain differs from the "
              f"CPU's (accepted {got['cuda'][1]} against {got['cpu'][1]})")
        check(drains[q]["lattice_encode"] > 0
              and drains[q]["lattice_decode_batched"] > 0,
              f"small round at q = {q}: a kernel was not launched: "
              f"{drains[q]}")

    spec_w = dataclasses.replace(spec, round_id=6, mtu=4096, window=4)
    sealed = AggServer(spec_w, base, streaming=False)
    clients = [AggClient(spec_w, i, xs[i]) for i in range(n)]
    for c in clients:
        for f in c.frames():
            sealed.receive(f)
    want = sealed.finalize()[0].cpu().numpy()
    stream = AggServer(spec_w, base)
    outbox = [(c, f) for c in clients for f in c.send_frames()]
    for _ in range(1000):
        nxt = []
        for c, f in outbox:
            for rb in stream.ingest_frame(f):
                nxt.extend((c, g) for g in c.handle_response(rb))
        for m in stream.tick():
            r = wire.decode_response(m)
            nxt.extend((c, g) for c in clients if c.client_id == r.client_id
                       for g in c.handle_response(m))
        outbox = nxt
        if all(c.acked for c in clients):
            break
    check(all(c.acked for c in clients), "streaming round did not finish")
    stream.seal()
    pub = stream.published()
    check(len(pub) == 1 and pub[0].accepted == frozenset(range(n)),
          "streaming round did not publish every client")
    got = pub[0].mean.cpu().numpy()
    check(np.array_equal(got.view(np.uint32), want.view(np.uint32)),
          "streaming round differs from the sealed drain")
    say("small_rounds", d=d, clients=n, card_equals_cpu=True,
        chunks_per_client=len(clients[0].frames()),
        streaming_equals_sealed=True, drain_launches=drains)
    return drains


# ---------------------------------------------------------------------------
# Phase 5: the collectives, four ranks on one card over a gloo group
# ---------------------------------------------------------------------------

def _gather_floats(torch, vals) -> "list[list[float]]":
    """Every rank's short list of floats, in rank order (a CPU gloo
    all-gather)."""
    import torch.distributed as dist
    t = torch.tensor(vals, dtype=torch.float64)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [o.tolist() for o in out]


def collective_rank_main(torch, rank: int, world: int, seed: int) -> dict:
    """One rank's share of the collectives phase; every check raises.

    The main path: star, butterfly and recursive halving, unrotated and
    then rotated, and recursive halving anchored at the star's mean, at
    full width (q = 16, bucket = 4096, y = 0.25).  Rank r holds client
    vector r of rounds A and B.  Then a small world-4 star and butterfly on
    the card and on the CPU, which must agree bit for bit."""
    import numpy as np

    from repro_torch import random as R
    from repro_torch.core import error_detect as ED
    from repro_torch.core.qstate import QState
    from repro_torch.dist import collectives as C
    from repro_torch.dist.fsdp import pad_to_shardable
    from repro_torch.kernels import _build

    bucket, y0, q, d, dev = 4096, 0.25, 16, FULL_D, torch.device("cuda")
    s = 2 * y0 / (q - 1)
    rounds = world.bit_length() - 1
    n_rh = pad_to_shardable(d, world, bucket)
    seg = n_rh // world
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(d, generator=g, device=dev)
    exact = torch.zeros(d, dtype=torch.float64, device=dev)
    for r in range(world):
        exact += client_vector(torch, base, seed, r).to(torch.float64)
    exact /= world
    x = client_vector(torch, base, seed, rank)
    del base
    lo, hi = rank * seg, min(d, (rank + 1) * seg)
    weights = ED.checksum_weights(R.PRNGKey(seed + 99), d, device=dev)

    # every tensor a rank sends, and the time the transport takes (host
    # clock, synchronized on both sides: with gloo it is the copy to pinned
    # host memory, the exchange and the copy back)
    sent, moved = [], [0.0]

    def counted(fn):
        def call(t, *args, **kwargs):
            sent.append(t.numel() * t.element_size())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(t, *args, **kwargs)
            torch.cuda.synchronize()
            moved[0] += time.perf_counter() - t0
            return r
        return call
    C._all_gather, C._ppermute = counted(C._all_gather), counted(C._ppermute)

    key = R.PRNGKey(seed)
    nb, nb_rh = C.flat_size_padded(d, bucket) // bucket, n_rh // bucket
    y = torch.full((nb,), y0, device=dev)
    y_rh = torch.full((nb_rh,), y0, device=dev)
    out = dict(rank=rank, seconds={}, transport_seconds={}, max_abs_err={},
               l2_sq={}, bytes_sent={}, digest={}, held_gb={}, added_gb={})

    def run(name, fn, xin, state, cfg, want_bytes):
        """One collective call, timed; its memory is read around the call
        alone: what the rank held when it called (its input included) and
        the most the call added on top (its output included)."""
        sent.clear()
        moved[0] = 0.0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        o, aux = fn(xin, state, key, cfg)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["held_gb"][name] = held / 1e9
        out["added_gb"][name] = (torch.cuda.max_memory_allocated()
                                 - held) / 1e9
        out["transport_seconds"][name] = moved[0]
        check(float(aux.fails) == 0,
              f"rank {rank} {name}: {float(aux.fails)} decode failures")
        check(sum(sent) == want_bytes,
              f"rank {rank} {name}: sent {sum(sent)} B, the wire "
              f"accounting says {want_bytes} B")
        out["bytes_sent"][name] = sum(sent)
        return o

    def errors(name, o, want):
        diff = o.to(torch.float64) - want
        out["max_abs_err"][name] = float(diff.abs().max())
        out["l2_sq"][name] = float((diff * diff).sum())

    def rh(name, state, cfg):
        """Recursive halving over the zero-padded vector; rank r's
        segment against the exact mean's (zero past d)."""
        o = run(name, C.rh_reduce_scatter_mean,
                torch.nn.functional.pad(x, (0, n_rh - d)), state, cfg,
                C.wire_bytes_rh(n_rh, world, cfg))
        check(tuple(o.shape) == (seg,), f"rank {rank} {name}: shape "
              f"{tuple(o.shape)}, expected ({seg},)")
        errors(name, o, torch.nn.functional.pad(exact[lo:hi],
                                                (0, seg - max(0, hi - lo))))

    _build.reset_launch_counts()
    t_path = time.perf_counter()
    for rotate in (False, True):
        cfg = C.QSyncConfig(q=q, bucket=bucket, rotate=rotate)
        tag = "_rot" if rotate else ""
        star_mean = None
        for name, fn, want in (
                ("star", C.allgather_allreduce_mean, C._payload_bytes(d, cfg)),
                ("butterfly", C.butterfly_allreduce_mean,
                 C.wire_bytes_butterfly(d, world, cfg))):
            o = run(name + tag, fn, x, y, cfg, want)
            check(tuple(o.shape) == (d,) and bool(torch.isfinite(o).all()),
                  f"rank {rank} {name}{tag}: not a finite (d,) vector")
            errors(name + tag, o, exact)
            out["digest"][name + tag] = int(ED.coord_checksum(
                o.view(torch.int32), weights))
            if name == "star" and not rotate:
                star_mean = o
            del o
        rh("rh" + tag, y_rh, cfg)
        if star_mean is not None:
            rh("rh_anchored", QState(y=y_rh, anchor=torch.nn.functional.pad(
                star_mean, (0, n_rh - d))), cfg)
            del star_mean
    out["path_seconds"] = time.perf_counter() - t_path
    out["launches"] = dict(_build.LAUNCHES)   # read just after the path
    del x, exact, weights

    # the error model of the reference (s/2 per quantization): the star
    # quantizes once, the butterfly and recursive halving once per round;
    # rotated runs are held in l2 over the whole vector
    names = sorted(out["l2_sq"])
    l2 = _gather_floats(torch, [out["l2_sq"][k] for k in names])
    digests = _gather_floats(torch, [float(out["digest"][k])
                                     for k in sorted(out["digest"])])
    check(all(dg == digests[0] for dg in digests),
          f"star / butterfly outputs differ across ranks: {digests}")
    out["bounds"] = {}
    for i, name in enumerate(names):
        per_round = 1 if name.startswith("star") else rounds
        if name.endswith("_rot"):
            n = n_rh if name.startswith("rh") else d
            total = (sum(r[i] for r in l2) if name.startswith("rh")
                     else l2[rank][i])
            lim = 0.51 * s * n ** 0.5 * per_round
            out["bounds"][name] = dict(l2=total ** 0.5, limit=lim)
            check(total ** 0.5 <= lim, f"{name}: ||out - exact||_2 = "
                  f"{total ** 0.5} > {lim}")
        else:
            err, lim = out["max_abs_err"][name], 0.51 * s * per_round
            out["bounds"][name] = dict(max_abs=err, limit=lim)
            check(err <= lim, f"rank {rank} {name}: max |out - exact| = "
                  f"{err} > {lim}")
    torch.cuda.empty_cache()

    # small parity: the card's star and butterfly equal the CPU's bitwise
    d2 = 1 << 18
    base2 = np.random.RandomState(seed).randn(d2).astype(np.float32)
    x2 = (base2 + 0.02 * np.random.RandomState(seed + 1 + rank)
          .randn(d2)).astype(np.float32)
    cfg2 = C.QSyncConfig(q=q, bucket=bucket)
    for name, fn in (("star", C.allgather_allreduce_mean),
                     ("butterfly", C.butterfly_allreduce_mean)):
        res = []
        for dv in (dev, torch.device("cpu")):
            o, aux = fn(torch.from_numpy(x2).to(dv),
                        torch.full((d2 // bucket,), y0, device=dv), key, cfg2)
            res.append((o.cpu().view(torch.int32),
                        aux.dist_b.cpu().view(torch.int32)))
        check(torch.equal(res[0][0], res[1][0])
              and torch.equal(res[0][1], res[1][1]),
              f"rank {rank} small {name}: the card differs from the CPU")
    out["small_card_equals_cpu"] = True
    out["shape_paths"] = shape_paths(torch, rank, seed, dev)
    return out


# the small paths of the shapes the reference's kernels do not take, each
# run on the card and on the CPU: (tag, collectives, q, bucket, rotate, d,
# y); the q = 2 runs with a tiny y are the paper's §5 failure cases
SHAPE_PATHS = (
    ("q2_fails", ("star", "butterfly", "rh"), 2, 4096, False, 1 << 18, 1e-3),
    ("q3", ("star", "butterfly", "rh"), 3, 4096, False, 1 << 18, 0.25),
    ("q12_rot", ("star", "butterfly", "rh"), 12, 32768, True, 1 << 18, 0.25),
    ("d65536_rot", ("star", "butterfly"), 16, 1 << 16, True, 1 << 18, 0.25),
    ("d1048576_rot", ("star", "butterfly"), 16, 1 << 20, True, 1 << 20,
     0.25),
    ("n31", ("butterfly",), 16, 1, False, 31, 0.25),
    ("n31_rot", ("butterfly",), 16, 2, True, 31, 0.25),
)


def shape_paths(torch, rank: int, seed: int, dev) -> dict:
    """The collectives at the shapes the reference's kernels do not take,
    at world 4, each tag of ``SHAPE_PATHS`` its own path (the counts set
    to 0 just before its card runs and read just after): the star,
    butterfly and recursive halving at q = 2 with a tiny y (decode
    failures, paper §5), at q = 3, and at q = 12 rotated with bucket
    32,768 (rows of the FWHT past 16,384); the star and the butterfly
    rotated with buckets of 65,536 and of 1,048,576 (the widths of the
    FWHT's checks); the butterfly over 31
    coordinates with bucket 1 (n < 32) and rotated with bucket 2 (FWHT
    rows of 2); one FSDP gradient sync at q = 2 with a tiny y (the
    ``lq-fails`` case).  Each runs on the card and then on the CPU: means
    and telemetry bitwise equal, and the same failures."""
    import numpy as np

    from repro_torch import random as R
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.kernels import _build

    cpu = torch.device("cpu")
    key = R.PRNGKey(seed)
    fns = {"star": C.allgather_allreduce_mean,
           "butterfly": C.butterfly_allreduce_mean,
           "rh": C.rh_reduce_scatter_mean}
    out = {}
    for tag, names, q, bucket, rotate, d, y0 in SHAPE_PATHS:
        cfg = C.QSyncConfig(q=q, bucket=bucket, rotate=rotate)
        base = np.random.RandomState(seed).randn(d).astype(np.float32)
        x = (base + 0.02 * np.random.RandomState(seed + 1 + rank)
             .randn(d)).astype(np.float32)
        runs = {}
        _build.reset_launch_counts()
        for on_card, dv in ((True, dev), (False, cpu)):
            for name in names:
                xin = torch.from_numpy(x).to(dv)
                n = C.flat_size_padded(d, bucket)
                if name == "rh":
                    n = F.pad_to_shardable(d, 4, bucket)
                    xin = torch.nn.functional.pad(xin, (0, n - d))
                o, aux = fns[name](xin, torch.full((n // bucket,), y0,
                                                   device=dv), key, cfg)
                runs[on_card, name] = (
                    o.cpu().view(torch.int32), float(aux.fails),
                    aux.fails_b.cpu(), aux.dist_b.cpu().view(torch.int32))
            if on_card:
                torch.cuda.synchronize()
                launches = dict(_build.LAUNCHES)   # read just after the path
        fails = {}
        for name in names:
            a, b = runs[True, name], runs[False, name]
            check(a[1] == b[1] and all(torch.equal(u, v) for u, v in
                                       zip(a[:1] + a[2:], b[:1] + b[2:])),
                  f"rank {rank} {tag} {name}: the card differs from the CPU "
                  f"(fails {a[1]} against {b[1]})")
            fails[name] = a[1]
        if tag == "q2_fails":
            check(all(f > 0 for f in fails.values()),
                  f"rank {rank} {tag}: a failure case detected nothing: "
                  f"{fails}")
        out[tag] = dict(launches=launches, fails=fails)

    # one FSDP gradient sync of the lq-fails case: the gather's forward and
    # backward (recursive halving at q = 2) of a 1,024-element shard
    shard, fb = 1024, 64
    nbk = 4 * shard // fb
    rng = np.random.RandomState(seed + 21)
    w_all = rng.randn(4, shard).astype(np.float32)
    ct = (rng.randn(4 * shard)[None] + 0.05 * rng.randn(4, 4 * shard)
          ).astype(np.float32)[rank]
    cfg = F.FSDPConfig(qcfg=C.QSyncConfig(q=2, bucket=fb))
    res = []
    _build.reset_launch_counts()
    for on_card, dv in ((True, dev), (False, cpu)):
        w = torch.from_numpy(w_all[rank]).to(dv).requires_grad_()
        tele = torch.zeros(F.tele_width(nbk), device=dv, requires_grad=True)
        o = F.make_fsdp_gather(cfg)({
            "w": w, "y": torch.full((nbk,), 1e-3, device=dv),
            "key": R.PRNGKey(3), "tele": tele})
        o.backward(torch.from_numpy(ct).to(dv).to(o.dtype))
        if on_card:
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)       # read just after the path
        res.append([t.detach().float().cpu().view(torch.int32)
                    for t in (o, w.grad, tele.grad)])
    check(all(torch.equal(a, b) for a, b in zip(*res)),
          f"rank {rank} fsdp lq-fails: the card differs from the CPU")
    fails_b = res[0][2][F.TELE_WIDTH + nbk:].view(torch.float32)
    check(float(fails_b.sum()) > 0,
          f"rank {rank} fsdp lq-fails: no decode failure detected")
    out["fsdp_lq_fails"] = dict(launches=launches,
                                fails=float(fails_b.sum()))
    return out


def _rank_entry(main, rank: int, world: int, port: int, args: tuple,
                queue) -> None:
    """Entry point of one spawned rank: joins the gloo group, runs
    ``main(torch, rank, world, *args)``, and puts ``(rank, "ok", result)``
    or ``(rank, "error", traceback)`` on the queue."""
    import datetime
    import traceback

    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        # cuBLAS is deterministic only with a fixed workspace (set before
        # the first CUDA call); the training phase's serial == prefetch
        # check needs it
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        # four ranks share the card: segments that grow in place leave
        # less of it reserved and unused (recurrentgemma's phase needs it)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            res = main(torch, rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", res))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        sys.exit(1)


def _spawn_ranks(main, args: tuple, what: str) -> list:
    """Spawn ``WORLD`` ranks, one process each, on the one card, each
    running ``main(torch, rank, WORLD, *args)``; fail when a rank fails, or
    when any has not finished within ``RANK_TIMEOUT_S``.  Returns the
    ranks' results in rank order."""
    import multiprocessing as mp
    import queue as queue_mod
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(main, r, WORLD, port, args, q), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(results) < WORLD:
            missing = [r for r in range(WORLD) if r not in results]
            check(time.monotonic() < deadline,
                  f"{what}: ranks {missing} did not finish within "
                  f"{RANK_TIMEOUT_S} s")
            try:
                rank, status, payload = q.get(timeout=5)
            except queue_mod.Empty:
                dead = [r for r in missing if not procs[r].is_alive()]
                check(not dead, f"{what}: ranks {dead} exited without "
                      f"a result")
                continue
            check(status == "ok", f"{what}: rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(WORLD)]


def adopt_orphans() -> None:
    """Make this process the parent of every orphan among its descendants
    (Linux ``PR_SET_CHILD_SUBREAPER``), so that ``stop_children`` also
    finds a process whose own parent, a rank, has exited."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0,
          f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")


def _children() -> "dict[int, str]":
    """``{pid: command line}`` of this process's children, from ``/proc``."""
    me, out = os.getpid(), {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:                 # it ended while we looked
            continue
        # the parent's pid is the second field after the command's ")"
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out[int(d.name)] = cmd.decode(errors="replace").strip()
    return out


def stop_children(grace_s: float = 10.0) -> "list[str]":
    """Stop every process this one started that still runs, and reap it:
    multiprocessing's resource tracker by closing its pipe (it ignores
    SIGTERM), every other child by SIGTERM, then SIGKILL after
    ``grace_s``.  Repeats until no child is left, since a stopped child's
    orphans come to this process.  Returns the command lines stopped."""
    import signal
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()
    stopped = []
    while kids := _children():
        stopped += kids.values()
        for pid in kids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + grace_s
        left = set(kids)
        while left and time.monotonic() < deadline:
            for pid in list(left):
                with contextlib.suppress(ChildProcessError):
                    if os.waitpid(pid, os.WNOHANG)[0] == 0:
                        continue
                left.discard(pid)
            time.sleep(0.05)
        for pid in left:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, 0)
    return stopped


def collectives(seed: int) -> dict:
    """Spawn ``WORLD`` ranks, one process each, on the one card, for the
    collectives phase; returns the kernels' launches summed over the
    ranks."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(collective_rank_main, (seed,), "collectives")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in COLLECTIVE_KERNELS}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the collectives")
    say("collectives", world=WORLD, d=FULL_D, wall_s=time.perf_counter() - t0,
        launches=launches,
        ranks=[{k: r[k] for k in ("rank", "seconds", "transport_seconds",
                                  "path_seconds", "held_gb", "added_gb",
                                  "bytes_sent", "bounds",
                                  "small_card_equals_cpu")} for r in ranks])
    # the shape paths: each path's launches summed over the ranks; every
    # kernel a path runs was launched there
    paths = {}
    for tag in ranks[0]["shape_paths"]:
        got = [r["shape_paths"][tag] for r in ranks]
        paths[tag] = {k: sum(g["launches"][k] for g in got)
                      for k in COLLECTIVE_KERNELS}
        names = next((p[1] for p in SHAPE_PATHS if p[0] == tag), ("rh",))
        rotate = next((p[4] for p in SHAPE_PATHS if p[0] == tag), False)
        need = (["lattice_encode"]
                + (["lattice_decode_batched"] if "star" in names else [])
                + (["lattice_decode"] if {"butterfly", "rh"} & set(names)
                   else []) + (["fwht"] if rotate else []))
        for k in need:
            check(paths[tag][k] > 0, f"kernel {k} was not launched on the "
                  f"{tag} path")
        say("collectives_shapes", path=tag, launches=paths[tag],
            fails=[g["fails"] for g in got], card_equals_cpu=True)
    return launches, paths


# ---------------------------------------------------------------------------
# Phase 6: FSDP training of internvl2-1b, four ranks on one card
# ---------------------------------------------------------------------------

def _bits_digest(torch, tree) -> "list[int]":
    """Two exact integer sums over the bits of every tensor of a nested
    dict (plain and index-weighted, leaves in sorted order): equal digests
    for equal bits, and a changed bit changes them."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _bits_digest(torch, v)
            continue
        b = v.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(b.shape[0], device=b.device, dtype=torch.int64) % 65521
        out += [int(b.sum()), int((b * (w + 1)).sum())]
    return out


def _same_structs(structs, actual) -> bool:
    """Whether ``actual`` has the tree, shapes and dtypes of a cell's local
    structs (``launch/steps.local_structs``; host values by type)."""
    if isinstance(structs, dict):
        return (isinstance(actual, dict) and sorted(structs) == sorted(actual)
                and all(_same_structs(structs[k], actual[k])
                        for k in structs))
    if hasattr(structs, "is_meta"):
        return (hasattr(actual, "shape") and actual.dtype == structs.dtype
                and tuple(actual.shape) == tuple(structs.shape))
    return type(structs) is type(actual)


def _tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


@contextlib.contextmanager
def _profiled(torch):
    """``torch.profiler`` over the block (CPU and CUDA activity, no stacks
    or shapes), the card synchronized on both sides."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def _union(spans) -> "list[tuple[float, float]]":
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(spans, by) -> float:
    """Length of the union ``spans`` that the union ``by`` covers."""
    tot, j = 0.0, 0
    for a, b in spans:
        while j < len(by) and by[j][1] <= a:
            j += 1
        k = j
        while k < len(by) and by[k][0] < b:
            tot += min(b, by[k][1]) - max(a, by[k][0])
            k += 1
    return tot


# profiler events of a collective call on the host
COLLECTIVE_EVENTS = ("c10d", "gloo", "nccl", "record_param_comms")


def _trace_shares(prof) -> dict:
    """From one profiled step: the device's idle share over the step's
    window (no kernel of this process running) and the share of the time
    inside collective calls during which no kernel of this process runs.
    Reads the profiler's raw events (building its event tree would take
    longer than the step).  Fails on a trace without kernels or
    collectives."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.end_ns() > e.start_ns()]
    kern = _union((e.start_ns(), e.end_ns()) for e in evs
                  if str(e.device_type()).endswith("CUDA"))
    coll = _union((e.start_ns(), e.end_ns()) for e in evs
                  if str(e.device_type()).endswith("CPU")
                  and any(k in e.name() for k in COLLECTIVE_EVENTS))
    check(kern and coll, f"the profiler saw {len(kern)} kernel spans and "
          f"{len(coll)} collective calls")
    t0 = min(e.start_ns() for e in evs)
    t1 = max(e.end_ns() for e in evs)
    busy = sum(b - a for a, b in kern)
    coll_t = sum(b - a for a, b in coll)
    res = dict(events=len(evs), window_ms=(t1 - t0) / 1e6,
               kernel_ms=busy / 1e6, collective_ms=coll_t / 1e6,
               device_idle_share=1.0 - busy / (t1 - t0),
               collective_idle_share=1.0 - _covered(coll, kern) / coll_t)
    for k in ("device_idle_share", "collective_idle_share"):
        check(0.0 <= res[k] <= 1.0, f"{k} = {res[k]}")
    return res


def train_rank_main(torch, rank: int, world: int, seed: int,
                    ckpt_dir: str) -> dict:
    """One rank's share of the training phase; every check raises.

    The main path: the port's ``Trainer`` (prefetching FSDP, remat, the
    quantized gradient reduce-scatter) for TRAIN_STEPS steps of
    internvl2-1b at full width and depth, from the seeded initial state,
    with a checkpoint at the end.  Then: layer 0's ``wq`` gradient sync
    of step 0 again on the CPU (bitwise), one serial and one
    uninstrumented prefetching step from the same initial state (each
    bitwise the main run's first step), one packed and one unpacked step
    at 2 layers (bitwise the same), and one FSDP backward at d = 2^18 on
    the card and on the CPU (bitwise)."""
    import dataclasses

    import numpy as np

    import torch.distributed as dist

    from repro_torch import random as R
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.train import data as D
    from repro_torch.train import optim as O
    from repro_torch.train import trainer as TR

    dev = torch.device("cuda")
    torch.use_deterministic_algorithms(True)
    opt = O.OptConfig(lr=3e-4, warmup=1, decay_steps=TRAIN_STEPS)
    # the cell builder's step and structs: prefetching ZeRO-3 over the
    # four DP ranks, q = 16, bucket 4096, the batch cut to one row a rank
    cell_step, structs, cfg, ctx = ST.train_cell(
        "internvl2-1b", "train_4k", (world, 1), prefetch=True, batch=world,
        seq=TRAIN_SEQ, opt_cfg=opt, device=dev)
    groups, qcfg = ctx.dp_axes, ctx.qcfg
    loc_state, loc_batch = ST.local_structs(structs, (world, 1))
    data = D.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                        global_batch=world, seed=seed)
    rows = (rank, rank + 1)

    def extra(step):
        return {"img": D.frames_at(data, step, cfg.img_tokens, cfg.d_model,
                                   rows=rows, device=dev)}

    tc = TR.TrainConfig(steps=TRAIN_STEPS, ckpt_every=10 ** 6,
                        ckpt_dir=ckpt_dir, log_every=1, max_restarts=0)

    # instrumentation: the forward gathers' and the gradient syncs' time
    # (host clock, synchronized on both sides), the bytes every sync sends,
    # and the order of the leaf syncs
    acc = dict(gather_s=0.0, sync_s=0.0, sync_top_s=0.0, sent=0,
               gathered=0, order=[], data_s=0.0)
    issue, value, sync, ppermute, all_gather = (
        F._issue, F._gather_value, F._sync_grad, C._ppermute, dist.all_gather)
    capture = {}

    def timed(fn, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            return r
        return call

    def sync_recorded(cfg_, g, y_entry, key, tele_like, anchor_full):
        acc["order"].append(tuple(key))
        before = acc["sync_s"]
        r = timed(sync, "sync_s")(cfg_, g, y_entry, key, tele_like,
                                  anchor_full)
        if g.numel() >= TRAIN_HOP_N:          # the embedding and the head
            acc["sync_top_s"] += acc["sync_s"] - before
        if key == capture.get("key"):
            capture.update(cfg=cfg_, g=g.reshape(-1).to(torch.float32).clone(),
                           g_shard=r[0].clone(), tele=r[1].clone(),
                           y=y_entry.clone(), anchor=anchor_full)
        return r

    def counted(t, *args, **kwargs):
        acc["sent"] += t.numel() * t.element_size()
        return ppermute(t, *args, **kwargs)

    def gathered(out, *args, **kwargs):      # gloo's all-gather: a list
        acc["gathered"] += sum(o.numel() * o.element_size() for o in out)
        return all_gather(out, *args, **kwargs)

    F._issue, F._gather_value = timed(issue, "gather_s"), \
        timed(value, "gather_s")
    F._sync_grad, C._ppermute = sync_recorded, counted
    dist.all_gather = gathered

    tr = TR.Trainer(cfg, ctx, opt, tc, data, extra_batch=extra, device=dev)
    tr.step_fn = cell_step
    tr._batch = timed(tr._batch, "data_s")
    state0 = tr._init()
    check(_same_structs(loc_state, state0),
          f"rank {rank}: the initial state differs from the cell's structs")
    # layer 0's wq at step 0: the key its sync is given
    k0 = R.fold_in(R.fold_in(state0["key"], 0), 1)
    capture["key"] = T._leaf_key(k0, "wq")
    digest0 = None
    steps = []
    inner = tr.step_fn

    def timed_step(state, batch):
        nonlocal digest0
        if state["step"] == 0:
            check(_same_structs(loc_batch, batch),
                  f"rank {rank}: the batch differs from the cell's structs")
            arg_bytes[0] = _tree_bytes(state) + _tree_bytes(batch)
        data_s = acc["data_s"]
        acc.update(gather_s=0.0, sync_s=0.0, sync_top_s=0.0, sent=0,
                   gathered=0, data_s=0.0)
        n_sync = len(acc["order"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = inner(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps.append(dict(step=int(state["step"]), wall_s=wall,
                          gather_s=acc["gather_s"], sync_s=acc["sync_s"],
                          sync_top_s=acc["sync_top_s"], data_s=data_s,
                          loss=float(metrics["loss"]),
                          gnorm=float(metrics["gnorm"]),
                          fails=float(metrics["fails"]),
                          sent_bytes=acc["sent"],
                          gathered_bytes=acc["gathered"],
                          wire_mib=acc["sent"] / 2 ** 20,
                          syncs=len(acc["order"]) - n_sync))
        if state["step"] == 0:
            digest0 = _bits_digest(torch, {"p": new["params"],
                                           "y": new["y"]})
        return new, metrics

    arg_bytes = [0]
    tr.step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    tr.train(state0)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = dict(_build.LAUNCHES)             # read just after the path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = dict(rank=rank, steps=steps, path_seconds=path_s,
               held_gb=held / 1e9, peak_gb=peak_gb, launches=launches,
               restarts=tr.restarts, argument_bytes=arg_bytes[0],
               wire_bytes_step=tr.wire_bytes_step)
    del state0

    # --- checks of the main path ---------------------------------------
    check(tr.restarts == 0, f"rank {rank}: {tr.restarts} restarts")
    check(len(steps) == TRAIN_STEPS, f"rank {rank}: {len(steps)} steps")
    for st in steps:
        check(math.isfinite(st["loss"]) and math.isfinite(st["gnorm"]),
              f"rank {rank} step {st['step']}: loss {st['loss']}")
        check(st["sent_bytes"] == tr.wire_bytes_step,
              f"rank {rank} step {st['step']}: sent {st['sent_bytes']} B, "
              f"wire_bytes_step is {tr.wire_bytes_step}")
    n_leaves = sum(len(v) for v in tr.metas.values())
    syncs = T.n_scan_steps(cfg) * len(tr.metas["layers"]) + \
        len(tr.metas["top"])
    hops = world.bit_length() - 1
    check(all(st["syncs"] == syncs for st in steps),
          f"rank {rank}: {[st['syncs'] for st in steps]} leaf syncs a step, "
          f"expected {syncs}")
    for k in ("lattice_encode", "lattice_decode"):
        check(launches[k] == TRAIN_STEPS * syncs * hops,
              f"rank {rank}: {launches[k]} {k} launches, expected "
              f"{TRAIN_STEPS} x {syncs} x {hops}")
    out["expected_launches"] = TRAIN_STEPS * syncs * hops
    out["leaves"] = n_leaves
    losses = _gather_floats(torch, [st["loss"] for st in steps])
    check(all(ls == losses[0] for ls in losses),
          f"the loss differs across ranks: {losses}")
    order = [float(hash(tuple(acc["order"])) % (1 << 52))]
    orders = _gather_floats(torch, order)
    check(all(o == orders[0] for o in orders),
          "the ranks issued their leaf syncs in different orders")

    F._issue, F._gather_value, F._sync_grad, C._ppermute = (
        issue, value, sync, ppermute)
    dist.all_gather = all_gather

    # layer 0's wq gradient sync at step 0, run again on the CPU over the
    # same gloo group from the same cotangent, y and key: the card's shard
    # and telemetry row bit for bit (the CPU port is held bitwise to the
    # JAX package by tests/test_torch_fsdp.py)
    def cpu(t):
        return None if t is None else t.cpu()
    g_cpu, tele_cpu = sync(capture["cfg"], cpu(capture["g"]),
                           cpu(capture["y"]), capture["key"],
                           torch.zeros_like(cpu(capture["tele"])),
                           cpu(capture["anchor"]))
    check(torch.equal(g_cpu.view(torch.int32),
                      cpu(capture["g_shard"]).view(torch.int32))
          and torch.equal(tele_cpu.view(torch.int32),
                          cpu(capture["tele"]).view(torch.int32)),
          f"rank {rank}: layer 0's wq gradient sync on the card differs "
          f"from the same sync on the CPU")
    out["wq_sync_card_equals_cpu"] = True

    # the same shard against the exact f32 mean of the four ranks'
    # gradients: 0.51 s per quantization per coordinate
    g_full, g_shard = capture["g"], capture["g_shard"]
    seg = g_shard.shape[0]
    parts = F._gather_tiled(g_full, [None]).reshape(world, -1)
    exact = parts.to(torch.float64).mean(dim=0)[rank * seg:(rank + 1) * seg]
    b_eff = F._effective_bucket(qcfg, g_full.shape[0], world)
    s_b = (2 * capture["y"] / (qcfg.q - 1))[rank * seg // b_eff:
                                           (rank + 1) * seg // b_eff]
    err = (g_shard.to(torch.float64) - exact).abs().reshape(-1, b_eff)
    lim = 0.51 * s_b.to(torch.float64)[:, None] * hops
    check(bool((err <= lim).all()),
          f"rank {rank}: layer 0 wq gradient off the exact mean by "
          f"{float(err.max())} (limit {float(lim.min())})")
    out["wq_grad"] = dict(max_abs_err=float(err.max()),
                          limit=float(lim.min()),
                          exact_max_abs=float(exact.abs().max()))
    del parts, exact, capture["g"]
    torch.cuda.empty_cache()

    # --- serial == prefetch: one serial step from the same initial state,
    # under the profiler (as the prefetching step below)
    ser = dataclasses.replace(ctx, prefetch=False)
    st_s = TR.init_state(cfg, ser, opt, tc, R.PRNGKey(0), dp_rank=rank,
                         device=dev)
    b0 = tr._batch(0)
    ser_step = TR.make_train_step(cfg, ser, opt, tc, dev)
    t_prof = time.perf_counter()
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        new_s, m_s = ser_step(st_s, b0)
        torch.cuda.synchronize()
        out["serial_step_s"] = time.perf_counter() - t0
    out["serial_trace"] = _trace_shares(prof)
    out["serial_trace"]["profiler_s"] = (time.perf_counter() - t_prof
                                         - out["serial_step_s"])
    dig_s = _bits_digest(torch, {"p": new_s["params"], "y": new_s["y"]})
    check(dig_s == digest0 and float(m_s["loss"]) == steps[0]["loss"],
          f"rank {rank}: the serial step differs from the prefetching one")
    out["serial_equals_prefetch"] = True
    del st_s, new_s
    torch.cuda.empty_cache()

    # --- one prefetching step without the instrumentation (which
    # synchronizes around every gather and sync), timed beside the serial
    # one: the pair that says how much prefetch overlaps
    st_p = TR.init_state(cfg, ctx, opt, tc, R.PRNGKey(0), dp_rank=rank,
                         device=dev)
    pre_step = TR.make_train_step(cfg, ctx, opt, tc, dev)
    t_prof = time.perf_counter()
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        new_p, m_p = pre_step(st_p, b0)
        torch.cuda.synchronize()
        out["prefetch_step_s"] = time.perf_counter() - t0
    out["prefetch_trace"] = _trace_shares(prof)
    out["prefetch_trace"]["profiler_s"] = (time.perf_counter() - t_prof
                                           - out["prefetch_step_s"])
    dig_p = _bits_digest(torch, {"p": new_p["params"], "y": new_p["y"]})
    check(dig_p == digest0 and float(m_p["loss"]) == steps[0]["loss"],
          f"rank {rank}: the uninstrumented prefetching step differs from "
          f"the instrumented one")
    del st_p, new_p, b0
    torch.cuda.empty_cache()

    # --- packed == unpacked telemetry, one step at 2 layers, full width
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    digs = []
    for packed in (True, False):
        c2 = dataclasses.replace(
            ctx, qcfg=dataclasses.replace(qcfg, packed=packed))
        st2 = TR.init_state(cfg2, c2, opt, tc, R.PRNGKey(0), dp_rank=rank,
                            device=dev)
        b2 = D.local_batch_at(data, 0, rank, world, device=dev)
        b2.update(extra(0))
        new2, m2 = TR.make_train_step(cfg2, c2, opt, tc, dev)(st2, b2)
        digs.append(_bits_digest(torch, {"p": new2["params"],
                                         "y": new2["y"]})
                    + [float(m2["loss"]), float(m2["fails"])])
        del st2, new2, b2
        torch.cuda.empty_cache()
    check(digs[0] == digs[1],
          f"rank {rank}: packed and unpacked telemetry steps differ")
    out["packed_equals_unpacked"] = True

    # --- card == CPU: the FSDP backward at d = 2^18, world 4, bitwise
    d2 = 1 << 18
    rng = np.random.RandomState(seed + 5 + rank)
    w2 = rng.randn(d2 // world).astype(np.float32)
    ct2 = rng.randn(d2).astype(np.float32)
    fcfg = F.FSDPConfig(axes=groups, qcfg=qcfg)
    nb2 = F.leaf_nb(d2, world, qcfg)
    res = []
    for dv in (dev, torch.device("cpu")):
        wt = torch.from_numpy(w2).to(dv).requires_grad_()
        tele = torch.zeros(F.tele_width(nb2), device=dv, requires_grad=True)
        full = F.make_fsdp_gather(fcfg)(
            {"w": wt, "y": torch.full((nb2,), 0.5, device=dv),
             "key": R.PRNGKey(seed + 3), "tele": tele})
        full.backward(torch.from_numpy(ct2).to(dv).to(full.dtype))
        res.append((wt.grad.cpu().view(torch.int32),
                    tele.grad.cpu().view(torch.int32)))
    check(torch.equal(res[0][0], res[1][0])
          and torch.equal(res[0][1], res[1][1]),
          f"rank {rank}: the FSDP backward on the card differs from the CPU")
    out["small_card_equals_cpu"] = True
    return out


def hop_kernel_check(torch, g, n: int, bucket: int,
                     small: bool = False) -> dict:
    """The encode and the single decode as a collective's hop launches them
    (q = 16, per-bucket sides, words alone, then coords mode) at ``n``
    coordinates: bitwise against their plain versions on the first and
    the last 2^24 coordinates, timed at the full shape by one call
    (``ms``) and by a run of back-to-back calls (``device_ms``), each
    beside its bound.  ``small`` adds ``graph_ms`` (the calls replayed
    from a CUDA graph, without the host's launch work) and the wrappers'
    ``host_us_per_call``."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    q, bits = 16, 4
    nb = n // bucket
    x = torch.randn(n, generator=g, device=dev) * 1e-3
    u = torch.rand(n, generator=g, device=dev) - 0.5
    sides = (2.0 / 15) * (0.5 + torch.rand(nb, generator=g, device=dev))
    y = x + 0.01 * torch.randn(n, generator=g, device=dev) * 1e-3

    def enc():
        return ops.lattice_encode(x, u, sides, q=q, bucket=bucket)
    words = enc()

    def dec():
        return ops.lattice_decode(words, y, u, sides, q=q, mode="coords",
                                  bucket=bucket)
    k = dec()
    torch.cuda.synchronize()
    for c0, c1 in ends(n):
        sl = sides[c0 // bucket:c1 // bucket]
        want = ref.lattice_encode_ref(x[c0:c1], u[c0:c1], sl, q=q, bits=bits,
                                      bucket=bucket)
        check(torch.equal(words[c0 // 8:c1 // 8], want),
              f"lattice_encode disagrees with its plain version at n = {n} "
              f"(coordinates {c0}:{c1})")
        want_k = ref.lattice_decode_ref(words[c0 // 8:c1 // 8], y[c0:c1],
                                        u[c0:c1], sl, q=q, bits=bits,
                                        n=c1 - c0, mode="coords",
                                        bucket=bucket)
        check(torch.equal(k[c0:c1], want_k),
              f"lattice_decode disagrees with its plain version at n = {n} "
              f"(coordinates {c0}:{c1})")
    del want, want_k, k
    res = dict(n=n, bucket=bucket)
    for name, fn, nbytes in (
            ("lattice_encode", enc, n * (4 + 4 + bits / 8) + nb * 4),
            ("lattice_decode", dec, n * (bits / 8 + 4 + 4 + 4) + nb * 4)):
        b, by = bound(nbytes, n * 4)
        dms, reps = device_ms(torch, fn)
        r = dict(ms=cuda_ms(torch, fn), device_ms=dms, reps=reps,
                 bound_ms=b, bound_by=by, share_of_bound=b / dms,
                 max_abs_err=0.0)
        if small:
            r["graph_ms"] = graph_ms(torch, fn, reps)
            r["host_us_per_call"] = host_us_per_call(torch, fn)
        res[name] = r
    del x, u, y, words, sides
    torch.cuda.empty_cache()
    return res


def train_kernel_checks(torch, seed: int) -> None:
    """The encode and the single decode at the training path's largest
    shape, the embedding's first recursive-halving hop (67,944,448
    coordinates, bucket 4096; ``hop_kernel_check``)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    r = hop_kernel_check(torch, g, TRAIN_HOP_N, 4096)
    say("kernel_check_train", shape=f"N={r['n']}, q=16, per-bucket sides",
        lattice_encode=r["lattice_encode"],
        lattice_decode=r["lattice_decode"])


def train_internvl2(seed: int) -> "tuple[dict, list]":
    """The training phase: four ranks on the one card over gloo, the port's
    Trainer at internvl2-1b's full width and depth; returns the encode and
    single-decode launches of the main path, summed over the ranks, and
    the ranks' results."""
    import tempfile

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_ranks(train_rank_main, (seed, ckpt_dir),
                             "train_internvl2")
        saved = sorted(p.name for p in Path(ckpt_dir).iterdir())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(saved == [f"step_{TRAIN_STEPS:08d}"],
          f"train_internvl2: the checkpoint directory holds {saved}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in COLLECTIVE_KERNELS}
    for name in ("lattice_encode", "lattice_decode"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the training phase")
    for st in range(TRAIN_STEPS):
        say("train_step", step=st,
            ranks=[{k: r["steps"][st][k] for k in
                    ("wall_s", "gather_s", "sync_s", "sync_top_s", "data_s",
                     "loss", "gnorm", "fails", "wire_mib")}
                   for r in ranks])
    say("train_internvl2", world=WORLD, arch="internvl2-1b", layers=24,
        seq=TRAIN_SEQ, image_tokens=256, global_batch=WORLD,
        steps=TRAIN_STEPS, wall_s=time.perf_counter() - t0,
        checkpoint=saved, launches=launches,
        ranks=[{k: r[k] for k in ("rank", "path_seconds", "held_gb",
                                  "peak_gb", "restarts", "wire_bytes_step",
                                  "expected_launches", "leaves", "wq_grad",
                                  "wq_sync_card_equals_cpu", "serial_step_s",
                                  "prefetch_step_s", "serial_equals_prefetch",
                                  "packed_equals_unpacked",
                                  "small_card_equals_cpu")} for r in ranks])
    r0 = ranks[0]
    say("train_trace", rank=0, profiled="one serial and one prefetching "
        "step, torch.profiler (CPU and CUDA activity)",
        serial_step_s=r0["serial_step_s"], serial=r0["serial_trace"],
        prefetch_step_s=r0["prefetch_step_s"],
        prefetch=r0["prefetch_trace"])
    return launches, ranks


def dryrun_internvl2() -> dict:
    """The dry run (``launch/dryrun.run_cell``) of the training phase's
    cell: internvl2-1b ``train_4k`` at full width on the phase's (4, 1)
    layout and batch, traced on ``meta`` tensors as rank 0 of a fake group
    of four, prefetching and serial.  Host only; no kernel runs."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.train import optim as O

    opt = O.OptConfig(lr=3e-4, warmup=1, decay_steps=TRAIN_STEPS)
    return {p: DR.run_cell("internvl2-1b", "train_4k", mesh=(WORLD, 1),
                           batch=WORLD, seq=TRAIN_SEQ, prefetch=p,
                           opt_cfg=opt)
            for p in (True, False)}


def dryrun_against_phase(pred: dict, ranks: list) -> None:
    """The dry run's prediction beside what the training phase measured:
    a rank's argument bytes, kernel launches a step and collective bytes a
    step by kind must be equal; the peak (against
    ``max_memory_allocated``) and the FLOP rate at the measured step time
    are printed; the static overlap audit must read the prefetching loop
    strictly below the serial one (the reference's ``fsdp_overlap``
    claim)."""
    rec, ser = pred[True], pred[False]
    r0 = ranks[0]
    step = r0["steps"][-1]
    coll = rec["collectives"]
    launches = {k: r0["launches"][k] // TRAIN_STEPS
                for k in ("lattice_encode", "lattice_decode")}
    for r in ranks:
        check(r["argument_bytes"] == rec["memory"]["argument_bytes"],
              f"rank {r['rank']}: {r['argument_bytes']} argument bytes, the "
              f"dry run predicts {rec['memory']['argument_bytes']}")
        for st in r["steps"]:
            check(st["sent_bytes"] == coll["ppermute"]
                  and st["gathered_bytes"] == coll["all-gather"],
                  f"rank {r['rank']} step {st['step']}: sent "
                  f"{st['sent_bytes']} B by ppermute and gathered "
                  f"{st['gathered_bytes']} B, the dry run predicts "
                  f"{coll['ppermute']} and {coll['all-gather']}")
    for k, v in launches.items():
        check(rec["kernel_launches"][k] == v,
              f"{k}: {v} launches a rank a step, the dry run predicts "
              f"{rec['kernel_launches'][k]}")
    check(ser["collective_exposed_fraction"]
          > rec["collective_exposed_fraction"],
          f"the overlap audit reads prefetching at "
          f"{rec['collective_exposed_fraction']}, serial at "
          f"{ser['collective_exposed_fraction']}")
    peak = rec["memory"]["peak_bytes"]
    say("dryrun_internvl2", mesh=rec["mesh"], batch=WORLD, seq=TRAIN_SEQ,
        trace_s={"prefetch": rec["trace_s"], "serial": ser["trace_s"]},
        argument_bytes=dict(predicted=rec["memory"]["argument_bytes"],
                            measured=r0["argument_bytes"]),
        launches_per_step=dict(predicted={k: rec["kernel_launches"][k]
                                          for k in launches},
                               measured=launches),
        collective_bytes_per_step=dict(
            predicted={k: coll[k] for k in ("all-gather", "ppermute")},
            measured={"all-gather": step["gathered_bytes"],
                      "ppermute": step["sent_bytes"]}),
        peak=dict(predicted_gb=peak / 1e9, measured_gb=r0["peak_gb"],
                  measured_over_predicted=r0["peak_gb"] * 1e9 / peak),
        flops=rec["flops"], step_wall_s=step["wall_s"],
        tflop_per_s=rec["flops"] / step["wall_s"] / 1e12,
        traffic_bytes=rec["traffic_bytes"],
        host_syncs=rec["host_syncs"],
        exposed_fraction=dict(prefetch=rec["collective_exposed_fraction"],
                              serial=ser["collective_exposed_fraction"]))


# ---------------------------------------------------------------------------
# Phase 6b: tensor and sequence parallelism, a (dp 2, tp 2) mesh on one card
# ---------------------------------------------------------------------------

class _Regions:
    """Host-clock timers of nested code regions: the outermost timed call
    owns the time (a TP psum's own pmax counts as the psum's), and the
    bytes each ``ppermute`` or ``all_gather`` sends are booked to the
    innermost open region."""

    def __init__(self, torch):
        self.torch = torch
        self.stack = []
        self.s, self.sent = {}, {}

    def reset(self):
        self.s, self.sent = {}, {}

    def timed(self, fn, key):
        def call(*args, **kwargs):
            outer = not self.stack
            if outer:
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
            self.stack.append(key)
            try:
                r = fn(*args, **kwargs)
            finally:
                self.stack.pop()
            if outer:
                self.torch.cuda.synchronize()
                self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
            return r
        return call

    def counted(self, fn):
        def call(t, *args, **kwargs):
            key = self.stack[-1] if self.stack else "other"
            self.sent[key] = self.sent.get(key, 0) + t.numel() * \
                t.element_size()
            return fn(t, *args, **kwargs)
        return call


def train_tp_rank_main(torch, rank: int, world: int, seed: int,
                       ckpt_dir: str) -> dict:
    """One rank's share of the TP phase; every check raises.

    The main path: the port's ``Trainer`` on a (dp 2, tp 2) mesh
    (``launch/mesh.mesh_axes``), sequence parallel, the replicated leaves'
    gradients psummed over TP through the quantized butterfly, prefetching
    FSDP with remat and the quantized DP reduce-scatter, for
    TRAIN_TP_STEPS steps of internvl2-1b at full width and depth, then a
    checkpoint.  Then: layer 0's ``wk`` TP psum of step 0 again on the CPU
    over the same gloo group (bitwise), one serial step from the same
    initial state (bitwise the main run's first), and the checkpoint read
    back (bitwise the final parameters)."""
    import numpy as np

    from repro_torch import random as R
    from repro_torch.configs import registry
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import layers as LY
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as CK
    from repro_torch.train import data as D
    from repro_torch.train import optim as O
    from repro_torch.train import trainer as TR

    dev = torch.device("cuda")
    torch.use_deterministic_algorithms(True)
    dp_axes, tp_axis = mesh_axes((TP_MESH[0], TP_MESH[1]))
    dp, tp = TP_MESH
    dp_idx, tp_idx = rank // tp, rank % tp
    cfg = registry.config("internvl2-1b")
    qcfg = C.QSyncConfig(q=16, bucket=4096)
    ctx = S.ShardCtx(tp=tp, dp=dp, dp_axes=dp_axes, tp_axis=tp_axis,
                     qcfg=qcfg, grad_sync="lq", seq_parallel=True,
                     quantize_tp_grads=True, prefetch=True)
    check(tp_idx == S.tp_index(ctx) and dp_idx == F._rank_linear(dp_axes),
          f"rank {rank}: mesh index ({dp_idx}, {tp_idx}) differs from the "
          f"groups' ({F._rank_linear(dp_axes)}, {S.tp_index(ctx)})")
    opt = O.OptConfig(lr=3e-4, warmup=1, decay_steps=TRAIN_TP_STEPS)
    data = D.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                        global_batch=dp, seed=seed)

    def extra(step):
        return {"img": D.frames_at(data, step, cfg.img_tokens, cfg.d_model,
                                   rows=(dp_idx, dp_idx + 1), device=dev)}

    tc = TR.TrainConfig(steps=TRAIN_TP_STEPS, ckpt_every=10 ** 6,
                        ckpt_dir=ckpt_dir, log_every=1, max_restarts=0)

    # instrumentation: the forward gathers, the DP syncs, the quantized TP
    # psums and the SP activation collectives (host clock, synchronized on
    # both sides), the bytes each of them sends, the replicated leaves' TP
    # psums of step 0
    reg = _Regions(torch)
    capture = {"tp": [], "on": True}
    n_kv = cfg.d_model * cfg.n_kv * cfg.head_dim
    sync, tpq = F._sync_grad, S._tp_quantized_psum

    def sync_recorded(cfg_, g, y_entry, key, tele_like, anchor_full):
        if key == capture.get("key"):
            capture["dp_in"] = g.reshape(-1).to(torch.float32).clone()
        return sync(cfg_, g, y_entry, key, tele_like, anchor_full)

    def tpq_recorded(g, ctx_):
        out = tpq(g, ctx_)
        if capture["on"] and g.numel() == n_kv:            # wk and wv
            capture["tp"].append((g.detach().clone(), out.detach().clone()))
        return out

    instruments = contextlib.ExitStack()
    instruments.enter_context(_patched(_tp_instruments(
        reg, F, C, S, LY, sync=sync_recorded, tpq=tpq_recorded)))

    tr = TR.Trainer(cfg, ctx, opt, tc, data, extra_batch=extra, device=dev)
    tr._batch = reg.timed(tr._batch, "data_s")
    state0 = tr._init()
    k0 = R.fold_in(R.fold_in(state0["key"], 0), 1)
    capture["key"] = T._leaf_key(k0, "wk")        # layer 0's wk, step 0
    repl = [(g, k) for g in ("layers", "top")
            for k, m in sorted(tr.metas[g].items()) if m.tp_replicated]
    tp_group = [tp_axis]
    digest0, steps, repl_equal = None, [], []
    inner = tr.step_fn

    def repl_digest(state):
        return torch.tensor(_bits_digest(torch, {
            f"{g}/{k}": {"p": state["params"][g][k], "y": state["y"][g][k],
                         **{m: state["opt"][m][g][k] for m in state["opt"]}}
            for g, k in repl}), dtype=torch.int64)

    def timed_step(state, batch):
        nonlocal digest0
        data_s = reg.s.get("data_s", 0.0)
        reg.reset()
        n0 = _build.LAUNCHES["lattice_encode"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = inner(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        capture["on"] = False
        steps.append(dict(
            step=int(state["step"]), wall_s=wall,
            gather_s=reg.s.get("gather_s", 0.0),
            sync_s=reg.s.get("sync_s", 0.0),
            tp_sync_s=reg.s.get("tp_sync_s", 0.0),
            tp_act_s=reg.s.get("tp_act_s", 0.0), data_s=data_s,
            loss=float(metrics["loss"]), gnorm=float(metrics["gnorm"]),
            fails=float(metrics["fails"]),
            sent_dp=reg.sent.get("sync_s", 0),
            sent_tp_sync=reg.sent.get("tp_sync_s", 0),
            sent_tp_act=reg.sent.get("tp_act_s", 0),
            encodes=_build.LAUNCHES["lattice_encode"] - n0,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        # replicated leaves: the same bits on the two TP ranks
        pair = F._gather_tiled(repl_digest(new), tp_group).reshape(tp, -1)
        repl_equal.append(bool(torch.equal(pair[0], pair[1])))
        if state["step"] == 0:
            digest0 = _bits_digest(torch, {"p": new["params"],
                                           "y": new["y"]})
        return new, metrics

    arg_bytes = [0]
    tr.step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    final = tr.train(state0)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = dict(_build.LAUNCHES)             # read just after the path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    instruments.close()
    del state0
    out = dict(rank=rank, mesh_index=[dp_idx, tp_idx], steps=steps,
               path_seconds=path_s, held_gb=held / 1e9, peak_gb=peak_gb,
               launches=launches, restarts=tr.restarts,
               wire_bytes_step=tr.wire_bytes_step,
               storage_gb=sum(v.numel() * 4 for g in final["params"].values()
                              for v in g.values()) / 1e9)

    # --- checks of the main path ---------------------------------------
    check(tr.restarts == 0, f"rank {rank}: {tr.restarts} restarts")
    check(len(steps) == TRAIN_TP_STEPS, f"rank {rank}: {len(steps)} steps")
    check(all(repl_equal), f"rank {rank}: the replicated leaves differ "
          f"across the TP ranks after steps {repl_equal}")
    acct = _tp_accounting(C, S, T, tr, ctx)
    syncs, hops = acct["dp_syncs"], acct["hops"]
    butterflies, rounds = acct["tp_butterflies"], acct["rounds"]
    per_step, tp_bytes = acct["per_step"], acct["tp_wire_bytes_step"]
    for st in steps:
        check(math.isfinite(st["loss"]) and math.isfinite(st["gnorm"]),
              f"rank {rank} step {st['step']}: loss {st['loss']}")
        check(st["sent_dp"] == tr.wire_bytes_step,
              f"rank {rank} step {st['step']}: the DP syncs sent "
              f"{st['sent_dp']} B, wire_bytes_step is {tr.wire_bytes_step}")
        check(st["sent_tp_sync"] == tp_bytes,
              f"rank {rank} step {st['step']}: the TP psums sent "
              f"{st['sent_tp_sync']} B, the wire accounting gives {tp_bytes}")
        check(st["encodes"] == per_step,
              f"rank {rank} step {st['step']}: {st['encodes']} encodes, "
              f"expected {syncs} x {hops} + {butterflies} x {rounds}")
    for k in ("lattice_encode", "lattice_decode"):
        check(launches[k] == TRAIN_TP_STEPS * per_step,
              f"rank {rank}: {launches[k]} {k} launches, expected "
              f"{TRAIN_TP_STEPS} x ({syncs} x {hops} + {butterflies} x "
              f"{rounds})")
    out.update(expected_launches=TRAIN_TP_STEPS * per_step, dp_syncs=syncs,
               tp_butterflies=butterflies, tp_wire_bytes_step=tp_bytes,
               replicated_equal_after_steps=repl_equal)
    losses = _gather_floats(torch, [st["loss"] for st in steps])
    check(all(ls == losses[0] for ls in losses),
          f"the loss differs across the ranks: {losses}")

    # layer 0's wk TP psum of step 0, again on the CPU over the same gloo
    # group from the same cotangent: the card's output bit for bit
    dp_in = capture["dp_in"]
    match = [(g, o) for g, o in capture["tp"]
             if torch.equal(o.reshape(-1).to(torch.float32).view(torch.int32),
                            dp_in.view(torch.int32))]
    check(len(match) == 1, f"rank {rank}: {len(match)} step-0 TP psums "
          f"match layer 0's wk DP sync input")
    g_card, o_card = match[0]
    o_cpu = S._tp_quantized_psum(g_card.cpu(), ctx)
    check(torch.equal(o_cpu.view(torch.int16), o_card.cpu().view(torch.int16)),
          f"rank {rank}: layer 0's wk quantized TP psum on the card differs "
          f"from the same psum on the CPU")
    out["wk_tp_psum_card_equals_cpu"] = True
    del capture["tp"], dp_in

    # the checkpoint, read back as logical tensors: this rank's slices of
    # the final parameters, bit for bit
    ck = Path(ckpt_dir) / f"step_{TRAIN_TP_STEPS:08d}" / "arrays.npz"
    with np.load(ck) as z:
        logical = {"layers": {}, "top": {}}
        for name in z.files:
            parts = name.split("/")
            if parts[0] == "params":
                logical[parts[1]][parts[2]] = z[name]
    back = CK.logical_to_params(logical, tr.metas, ctx, dp_idx, "cpu", tp_idx)
    for g in ("layers", "top"):
        for k, m in tr.metas[g].items():
            sl = S.shard_len(m, ctx)
            real = max(0, min(sl, m.numel() - dp_idx * sl))
            a = back[g][k][..., :real].contiguous()
            b = final["params"][g][k][..., :real].cpu().contiguous()
            check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                  f"rank {rank}: the checkpoint's {g}/{k} differs from the "
                  f"final parameters")
    out["checkpoint_equals_params"] = True
    del logical, back, final
    torch.cuda.empty_cache()

    # serial == prefetch: one serial step from the same initial state
    ser = dataclasses.replace(ctx, prefetch=False)
    st_s = TR.init_state(cfg, ser, opt, tc, R.PRNGKey(0), dp_rank=dp_idx,
                         tp_rank=tp_idx, device=dev)
    b0 = tr._batch(0)
    ser_step = TR.make_train_step(cfg, ser, opt, tc, dev)
    t_prof = time.perf_counter()
    with _profiled(torch) as prof:
        t0 = time.perf_counter()
        new_s, m_s = ser_step(st_s, b0)
        torch.cuda.synchronize()
        out["serial_step_s"] = time.perf_counter() - t0
    out["serial_trace"] = _trace_shares(prof)
    out["serial_trace"]["profiler_s"] = (time.perf_counter() - t_prof
                                         - out["serial_step_s"])
    dig_s = _bits_digest(torch, {"p": new_s["params"], "y": new_s["y"]})
    check(dig_s == digest0 and float(m_s["loss"]) == steps[0]["loss"],
          f"rank {rank}: the serial step differs from the prefetching one")
    out["serial_equals_prefetch"] = True
    del st_s, new_s, b0
    torch.cuda.empty_cache()
    return out


def tp_kernel_checks(torch, seed: int) -> None:
    """The encode and the single decode at the TP phase's shapes
    (``hop_kernel_check``): its largest DP hop (the embedding's half at
    dp = 2, 33,972,224 coordinates, bucket 4096) and a replicated leaf's
    butterfly (wk, 114,688 coordinates, bucket 4096; a norm, gathered to
    1,024 for the DP shards, one bucket of 1,024); the butterflies also
    from a CUDA graph and with the host's microseconds per call."""
    res = {}
    for label, n, bucket in (("dp_hop", TP_HOP_N, 4096),
                             ("tp_butterfly_wk", 896 * 128, 4096),
                             ("tp_butterfly_norm", 1024, 1024)):
        g = torch.Generator(device="cuda").manual_seed(seed + 23)
        res[label] = hop_kernel_check(torch, g, n, bucket,
                                      small=n < TP_HOP_N)
    say("kernel_check_tp", q=16, shapes=res)


def train_internvl2_tp(seed: int) -> dict:
    """The TP phase: four ranks on the one card over gloo as a (dp 2,
    tp 2) mesh, the port's Trainer at internvl2-1b's full width and depth;
    returns the encode and single-decode launches of the main path, summed
    over the ranks."""
    import tempfile

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_ckpt_")
    t0 = time.perf_counter()
    try:
        ranks = _spawn_ranks(train_tp_rank_main, (seed, ckpt_dir),
                             "train_internvl2_tp")
        saved = sorted(p.name for p in Path(ckpt_dir).iterdir())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(saved == [f"step_{TRAIN_TP_STEPS:08d}"],
          f"train_internvl2_tp: the checkpoint directory holds {saved}")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in COLLECTIVE_KERNELS}
    for name in ("lattice_encode", "lattice_decode"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the TP phase")
    for st in range(TRAIN_TP_STEPS):
        say("train_tp_step", step=st,
            ranks=[{k: r["steps"][st][k] for k in
                    ("wall_s", "gather_s", "sync_s", "tp_sync_s", "tp_act_s",
                     "data_s", "loss", "gnorm", "fails", "peak_gb",
                     "sent_dp", "sent_tp_sync", "sent_tp_act")}
                   | {"wire_bytes_step": r["wire_bytes_step"],
                      "tp_wire_bytes_step": r["tp_wire_bytes_step"]}
                   for r in ranks])
    say("train_internvl2_tp", mesh=dict(dp=TP_MESH[0], tp=TP_MESH[1]),
        arch="internvl2-1b", layers=24, seq=TRAIN_SEQ, image_tokens=256,
        tokens_per_tp_rank=(TRAIN_SEQ + 256) // TP_MESH[1],
        global_batch=TP_MESH[0], steps=TRAIN_TP_STEPS, seq_parallel=True,
        quantize_tp_grads=True, wall_s=time.perf_counter() - t0,
        checkpoint=saved, launches=launches,
        ranks=[{k: r[k] for k in (
            "rank", "mesh_index", "path_seconds", "held_gb", "peak_gb",
            "storage_gb", "restarts", "expected_launches", "dp_syncs",
            "tp_butterflies", "replicated_equal_after_steps",
            "wk_tp_psum_card_equals_cpu", "checkpoint_equals_params",
            "serial_step_s", "serial_equals_prefetch")} for r in ranks])
    return launches


# ---------------------------------------------------------------------------
# Phase 6c: the MoE family, granite-moe-1b-a400m on the (dp 2, tp 2) mesh
# ---------------------------------------------------------------------------

def _tp_instruments(reg, F, C, S, LY, **fns) -> list:
    """(module, name, replacement) of a TP training run's instruments: the
    forward gathers, the DP syncs, the quantized TP psums and the SP
    activation collectives (the all-to-alls among them) timed on the host
    clock, and the bytes every ``ppermute`` and ``all_gather`` sends.
    ``fns`` replaces the timed ``_sync_grad``, ``_tp_quantized_psum`` or
    ``_all_to_all`` with a recording wrapper of it."""
    return [(F, "_issue", reg.timed(F._issue, "gather_s")),
            (F, "_gather_value", reg.timed(F._gather_value, "gather_s")),
            (F, "_sync_grad", reg.timed(fns.get("sync", F._sync_grad),
                                        "sync_s")),
            (S, "_tp_quantized_psum", reg.timed(
                fns.get("tpq", S._tp_quantized_psum), "tp_sync_s")),
            (S, "_all_gather_cat", reg.timed(S._all_gather_cat, "tp_act_s")),
            (S, "_reduce_scatter", reg.timed(S._reduce_scatter, "tp_act_s")),
            (S, "_all_to_all", reg.timed(fns.get("a2a", S._all_to_all),
                                         "tp_act_s")),
            (S, "_psum", reg.timed(S._psum, "tp_act_s")),
            (LY, "_psum", reg.timed(LY._psum, "tp_act_s")),
            (S, "pmax_tp", reg.timed(S.pmax_tp, "tp_act_s")),
            (LY, "pmax_tp", reg.timed(LY.pmax_tp, "tp_act_s")),
            (C, "_ppermute", reg.counted(C._ppermute)),
            (C, "_all_gather", reg.counted(C._all_gather))]


@contextlib.contextmanager
def _patched(patches):
    """Set each (module, name, replacement) while open; restore on exit."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _tp_accounting(C, S, T, tr, ctx) -> dict:
    """What one step of a TP run must do, from the metas: the DP leaf
    syncs and their hops, the replicated leaves' TP butterflies and their
    rounds, the encode (and single-decode) launches, and the bytes the
    butterflies send (each on the leaf gathered for the DP shards)."""
    L = T.n_scan_steps(tr.cfg)
    repl = [(g, k) for g in ("layers", "top")
            for k, m in sorted(tr.metas[g].items()) if m.tp_replicated]
    syncs = L * len(tr.metas["layers"]) + len(tr.metas["top"])
    butterflies = sum(L if g == "layers" else 1 for g, _ in repl)
    hops, rounds = ctx.dp.bit_length() - 1, ctx.tp.bit_length() - 1
    tp_bytes = 0
    for g, k in repl:
        n = S.leaf_gathered_len(tr.metas[g][k], ctx)
        b = ctx.qcfg.bucket
        while b > 32 and n < b:
            b //= 2
        qb = dataclasses.replace(ctx.qcfg, bucket=b)
        tp_bytes += C.wire_bytes_butterfly(C.flat_size_padded(n, qb), ctx.tp,
                                           qb) * (L if g == "layers" else 1)
    return dict(repl=repl, dp_syncs=syncs, hops=hops,
                tp_butterflies=butterflies, rounds=rounds,
                per_step=syncs * hops + butterflies * rounds,
                tp_wire_bytes_step=tp_bytes)


def _tp_train_run(torch, tr, reg, n_steps: int, tp_axis, tp: int,
                  tag: str) -> dict:
    """Train ``tr`` (its ``_init`` state, no checkpoint) with every step
    timed by the region timers and every count of launches set to 0 just
    before; read the counts just after.  Checks, on every step: a finite
    loss and gnorm; the DP syncs' bytes == ``wire_bytes_step``, the TP
    butterflies' == their accounting, the encodes == syncs x hops +
    butterflies x rounds; the replicated leaves the same bits on every TP
    rank; no restart."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.kernels import _build
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as T

    acct = _tp_accounting(C, S, T, tr, tr.ctx)
    inner = tr.step_fn
    steps, repl_equal = [], []

    def repl_digest(state):
        return torch.tensor(_bits_digest(torch, {
            f"{g}/{k}": {"p": state["params"][g][k], "y": state["y"][g][k],
                         **{m: state["opt"][m][g][k] for m in state["opt"]}}
            for g, k in acct["repl"]}), dtype=torch.int64)

    def timed_step(state, batch):
        data_s = reg.s.get("data_s", 0.0)
        reg.reset()
        n0 = _build.LAUNCHES["lattice_encode"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = inner(state, batch)
        torch.cuda.synchronize()
        steps.append(dict(
            step=int(state["step"]), wall_s=time.perf_counter() - t0,
            gather_s=reg.s.get("gather_s", 0.0),
            sync_s=reg.s.get("sync_s", 0.0),
            tp_sync_s=reg.s.get("tp_sync_s", 0.0),
            tp_act_s=reg.s.get("tp_act_s", 0.0), data_s=data_s,
            loss=float(metrics["loss"]), gnorm=float(metrics["gnorm"]),
            fails=float(metrics["fails"]),
            sent_dp=reg.sent.get("sync_s", 0),
            sent_tp_sync=reg.sent.get("tp_sync_s", 0),
            sent_tp_act=reg.sent.get("tp_act_s", 0),
            encodes=_build.LAUNCHES["lattice_encode"] - n0,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        pair = F._gather_tiled(repl_digest(new), [tp_axis]).reshape(tp, -1)
        repl_equal.append(bool(torch.equal(pair[0], pair[1])))
        return new, metrics

    tr.step_fn = timed_step
    tr._batch = reg.timed(tr._batch, "data_s")
    tr.save = lambda state: None      # no checkpoint (train_internvl2_tp's)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t_path = time.perf_counter()
    tr.train()              # its initial state is held by the loop alone
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = dict(_build.LAUNCHES)             # read just after the path
    if tr.lead:
        shutil.rmtree(tr.tc.ckpt_dir, ignore_errors=True)
    # params and gradient in f32, the two moments in the optimizer's type
    moment = torch.tensor([], dtype=getattr(torch, tr.opt_cfg.state_dtype))
    elems = sum(S.shard_len(m, tr.ctx) * (T.n_scan_steps(tr.cfg)
                                          if g == "layers" else 1)
                for g in tr.metas for m in tr.metas[g].values())
    state_gb = elems * (8 + 2 * moment.element_size()) / 1e9
    rank = tr.rank * tp + tr.tp_rank
    check(tr.restarts == 0, f"{tag} rank {rank}: {tr.restarts} restarts")
    check(len(steps) == n_steps, f"{tag} rank {rank}: {len(steps)} steps")
    check(all(repl_equal), f"{tag} rank {rank}: the replicated leaves "
          f"differ across the TP ranks after steps {repl_equal}")
    for st in steps:
        check(math.isfinite(st["loss"]) and math.isfinite(st["gnorm"]),
              f"{tag} rank {rank} step {st['step']}: loss {st['loss']}")
        check(st["sent_dp"] == tr.wire_bytes_step,
              f"{tag} rank {rank} step {st['step']}: the DP syncs sent "
              f"{st['sent_dp']} B, wire_bytes_step is {tr.wire_bytes_step}")
        check(st["sent_tp_sync"] == acct["tp_wire_bytes_step"],
              f"{tag} rank {rank} step {st['step']}: the TP psums sent "
              f"{st['sent_tp_sync']} B, the wire accounting gives "
              f"{acct['tp_wire_bytes_step']}")
        check(st["encodes"] == acct["per_step"],
              f"{tag} rank {rank} step {st['step']}: {st['encodes']} "
              f"encodes, expected {acct['dp_syncs']} x {acct['hops']} + "
              f"{acct['tp_butterflies']} x {acct['rounds']}")
    for k in ("lattice_encode", "lattice_decode"):
        check(launches[k] == n_steps * acct["per_step"],
              f"{tag} rank {rank}: {launches[k]} {k} launches, expected "
              f"{n_steps} x {acct['per_step']}")
    acct.pop("repl")
    return dict(rank=rank, steps=steps, path_seconds=path_s,
                state_gb=state_gb,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                launches=launches, wire_bytes_step=tr.wire_bytes_step,
                expected_launches=n_steps * acct["per_step"],
                replicated_equal_after_steps=repl_equal, **acct)


def train_moe_rank_main(torch, rank: int, world: int, seed: int) -> dict:
    """One rank's share of the MoE phase; every check raises.

    The main path: the port's ``Trainer`` for MOE_STEPS steps of
    granite-moe-1b-a400m at full width, MOE_LAYERS deep, on the (dp 2,
    tp 2) mesh, sequence parallel (2,048 of a DP rank's 4,096 tokens routed by each TP
    rank), its 32 experts split 16 a TP rank behind two tiled all-to-alls
    a layer, the replicated leaves' gradients (the router among them)
    psummed over TP through the quantized butterfly, prefetching FSDP with
    remat and the quantized DP reduce-scatter, AdamW.  Then: layer 0's
    ``router`` TP psum of step 0 again on the CPU over the same gloo group
    (bitwise), and step 0's first all-to-all against the host's
    permutation of every TP rank's rows (bitwise)."""
    from repro_torch import random as R
    from repro_torch.configs import registry
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import layers as LY
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as T
    from repro_torch.train import data as D
    from repro_torch.train import optim as O
    from repro_torch.train import trainer as TR

    dev = torch.device("cuda")
    torch.use_deterministic_algorithms(True)
    dp_axes, tp_axis = mesh_axes(TP_MESH)
    dp, tp = TP_MESH
    cfg = dataclasses.replace(registry.config(MOE_ARCH),
                              n_layers=MOE_LAYERS)
    ctx = S.ShardCtx(tp=tp, dp=dp, dp_axes=dp_axes, tp_axis=tp_axis,
                     qcfg=C.QSyncConfig(q=16, bucket=4096), grad_sync="lq",
                     seq_parallel=True, quantize_tp_grads=True, prefetch=True)
    opt = O.OptConfig(lr=3e-4, warmup=1, decay_steps=MOE_STEPS)
    data = D.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=dp,
                        seed=seed)
    tc = TR.TrainConfig(steps=MOE_STEPS, ckpt_every=10 ** 6, log_every=1,
                        max_restarts=0)
    n_router = S.leaf_gathered_len(T.block_metas(cfg, ctx)["router"], ctx)

    # recorders: each step's aux, the forward's routings (the recompute's
    # come after them), step 0's first all-to-all and router TP psums, and
    # the DP sync input of layer 0's router
    rec = {"aux": [], "routes": [], "a2a": None, "tp": [], "on": True}
    make_loss, route, sync, tpq, a2a = (T.make_loss_fn, MOE.route,
                                        F._sync_grad, S._tp_quantized_psum,
                                        S._all_to_all)

    def make_recorded(cfg_, ctx_):
        fn = make_loss(cfg_, ctx_)

        def loss_fn(*args):
            loss, m = fn(*args)
            rec["aux"].append(m["aux"])
            return loss, m
        return loss_fn

    def route_recorded(x, router, cfg_, cap):
        out = route(x, router, cfg_, cap)
        if rec["on"] and len(rec["routes"]) < cfg.n_layers:
            rec["routes"].append((out[1].detach().clone(),
                                  out[3].detach().clone()))
        return out

    def sync_recorded(cfg_, g, y_entry, key, tele_like, anchor_full):
        if key == rec.get("key"):
            rec["dp_in"] = g.reshape(-1).to(torch.float32).clone()
        return sync(cfg_, g, y_entry, key, tele_like, anchor_full)

    def tpq_recorded(g, ctx_):
        out = tpq(g, ctx_)
        if rec["on"] and g.numel() == n_router:
            rec["tp"].append((g.detach().clone(), out.detach().clone()))
        return out

    def a2a_recorded(x, ctx_, split_axis, concat_axis):
        out = a2a(x, ctx_, split_axis, concat_axis)
        if rec["a2a"] is None and (split_axis, concat_axis) == (0, 1):
            rec["a2a"] = (x.detach().clone(), out.detach().clone())
        return out

    reg = _Regions(torch)
    patches = _tp_instruments(reg, F, C, S, LY, sync=sync_recorded,
                              tpq=tpq_recorded, a2a=a2a_recorded)
    patches += [(T, "make_loss_fn", make_recorded),
                (MOE, "route", route_recorded)]
    with _patched(patches):
        tr = TR.Trainer(cfg, ctx, opt, tc, data, device=dev)
        # layer 0's router, step 0 (the Trainer's initial key is PRNGKey(0))
        rec["key"] = T._leaf_key(R.fold_in(R.fold_in(R.PRNGKey(0), 0), 1),
                                 "router")
        inner = tr.step_fn

        def first_step_only(state, batch):
            out = inner(state, batch)
            rec["on"] = False
            return out

        tr.step_fn = first_step_only
        out = _tp_train_run(torch, tr, reg, MOE_STEPS, tp_axis, tp,
                            "train_granite_moe_tp")

    aux = [float(a) for a in rec["aux"]]
    check(len(aux) == MOE_STEPS and all(math.isfinite(a) for a in aux),
          f"rank {rank}: aux {aux}")
    for st, a in zip(out["steps"], aux):
        st["aux"] = a
    # the tokens each expert dropped at capacity in step 0's forward
    E = cfg.n_experts
    dropped = torch.zeros(E, dtype=torch.int64)
    for idx, keep in rec["routes"]:
        e = idx.reshape(-1)[~keep].cpu()
        dropped += torch.nn.functional.one_hot(e, E).sum(0)
    T_loc = TRAIN_SEQ // tp
    out.update(tokens_routed=T_loc, capacity=MOE.capacity(T_loc, cfg),
               dropped_per_expert=dropped.tolist(),
               dropped_share=float(dropped.sum()) /
               (cfg.n_layers * T_loc * cfg.top_k))

    # layer 0's router TP psum of step 0, again on the CPU over the same
    # gloo group from the same cotangent: the card's output bit for bit
    dp_in = rec["dp_in"]
    match = [(g, o) for g, o in rec["tp"]
             if torch.equal(o.reshape(-1).to(torch.float32).view(torch.int32),
                            dp_in.view(torch.int32))]
    check(len(match) == 1, f"rank {rank}: {len(match)} step-0 TP psums "
          f"match layer 0's router DP sync input")
    g_card, o_card = match[0]
    o_cpu = S._tp_quantized_psum(g_card.cpu(), ctx)
    check(torch.equal(o_cpu.view(torch.int16), o_card.cpu().view(torch.int16))
          if o_cpu.dtype == torch.bfloat16 else
          torch.equal(o_cpu.view(torch.int32), o_card.cpu().view(torch.int32)),
          f"rank {rank}: layer 0's router quantized TP psum on the card "
          f"differs from the same psum on the CPU")
    out["router_tp_psum_card_equals_cpu"] = True

    # step 0's first all-to-all (layer 0's dispatch): the host's tiled
    # permutation of every TP rank's rows, bit for bit
    x_in, x_out = rec["a2a"]
    rows = C._all_gather(x_in.cpu(), tp_axis)
    me = S.tp_index(ctx)
    want = torch.cat([rows[r].chunk(tp, 0)[me] for r in range(tp)], dim=1)
    check(torch.equal(want.view(torch.int16), x_out.cpu().view(torch.int16)),
          f"rank {rank}: the all-to-all's output differs from the host's "
          f"permutation of the same rows")
    out["all_to_all_equals_host"] = True
    out["all_to_all_shape"] = [list(x_in.shape), list(x_out.shape)]
    del rec
    torch.cuda.empty_cache()
    return out


def train_granite_moe_tp(seed: int) -> dict:
    """The MoE phase: four ranks on the one card over gloo as a (dp 2,
    tp 2) mesh, the port's Trainer at granite-moe-1b-a400m's full width,
    MOE_LAYERS deep; returns the encode and single-decode launches of the
    main path, summed over the ranks."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(train_moe_rank_main, (seed,),
                         "train_granite_moe_tp")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in COLLECTIVE_KERNELS}
    for name in ("lattice_encode", "lattice_decode"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the MoE phase")
    for st in range(MOE_STEPS):
        say("train_moe_step", step=st,
            ranks=[{k: r["steps"][st][k] for k in
                    ("wall_s", "gather_s", "sync_s", "tp_sync_s", "tp_act_s",
                     "data_s", "loss", "aux", "gnorm", "fails", "peak_gb",
                     "sent_dp", "sent_tp_sync", "sent_tp_act")}
                   for r in ranks])
    say("train_granite_moe_tp", mesh=dict(dp=TP_MESH[0], tp=TP_MESH[1]),
        arch=MOE_ARCH, layers=MOE_LAYERS, experts=32, experts_per_tp_rank=16,
        seq=TRAIN_SEQ, global_batch=TP_MESH[0], steps=MOE_STEPS,
        seq_parallel=True, quantize_tp_grads=True,
        wall_s=time.perf_counter() - t0, launches=launches,
        ranks=[{k: r[k] for k in (
            "rank", "path_seconds", "state_gb", "peak_gb", "wire_bytes_step",
            "tp_wire_bytes_step", "expected_launches", "dp_syncs", "hops",
            "tp_butterflies", "rounds", "replicated_equal_after_steps",
            "tokens_routed", "capacity", "dropped_per_expert",
            "dropped_share", "router_tp_psum_card_equals_cpu",
            "all_to_all_equals_host", "all_to_all_shape")} for r in ranks])
    return launches


# ---------------------------------------------------------------------------
# Phase 6d: the other families — Mamba-2, the RG-LRU hybrid, whisper
# ---------------------------------------------------------------------------

def _family_trainer_run(torch, rank: int, arch: str, layers: int,
                        steps: int, state_dtype: str, mesh, seed: int
                        ) -> dict:
    """One family on the (dp 2, tp 2) mesh through the port's Trainer at
    full width, ``layers`` deep, sequence parallel, with the quantized TP
    psum and the prefetching quantized DP sync (``_tp_train_run``'s
    checks)."""
    from repro_torch.configs import registry
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.models import layers as LY
    from repro_torch.models import sharding as S
    from repro_torch.train import data as D
    from repro_torch.train import optim as O
    from repro_torch.train import trainer as TR

    dp_axes, tp_axis = mesh
    dp, tp = TP_MESH
    cfg = dataclasses.replace(registry.config(arch), n_layers=layers)
    ctx = S.ShardCtx(tp=tp, dp=dp, dp_axes=dp_axes, tp_axis=tp_axis,
                     qcfg=C.QSyncConfig(q=16, bucket=4096), grad_sync="lq",
                     seq_parallel=True, quantize_tp_grads=True, prefetch=True)
    opt = O.OptConfig(lr=3e-4, warmup=1, decay_steps=steps,
                      state_dtype=state_dtype)
    data = D.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=dp,
                        seed=seed)
    tc = TR.TrainConfig(steps=steps, ckpt_every=10 ** 6, log_every=1,
                        max_restarts=0)
    reg = _Regions(torch)
    with _patched(_tp_instruments(reg, F, C, S, LY)):
        tr = TR.Trainer(cfg, ctx, opt, tc, data, device=torch.device("cuda"))
        out = _tp_train_run(torch, tr, reg, steps, tp_axis, tp, arch)
    out.update(arch=arch, layers=layers, state_dtype=state_dtype,
               params=cfg.param_count())
    return out


def _whisper_train(torch, rank: int, world: int, seed: int) -> dict:
    """whisper-small at full width and depth (12 + 12 layers, 1,500 stub
    frames, 448 decoder tokens) over ``world`` DP ranks: WHISPER_STEPS
    full steps of the cell builder's encoder-decoder train step
    (``launch/steps.train_cell``: the loss and backward through
    ``make_encdec_loss_fn`` with every leaf's gradient reduce-scattered by
    packed q = 16 recursive halving, prefetching, remat; the grad norm,
    AdamW, the ``y`` update), the batch cut to one row a rank and the
    decoder to 448 tokens.  Checks: the state and batch have the cell's
    local structs; finite losses and gnorms with the same bits on every
    rank; each step's DP sync bytes == the wire accounting; the encodes
    and single decodes == steps x syncs x hops."""
    from repro_torch import random as R
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.kernels import _build
    from repro_torch.launch import steps as ST
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as LY
    from repro_torch.models import sharding as S
    from repro_torch.train import data as D
    from repro_torch.train import optim as O

    dev = torch.device("cuda")
    opt = O.OptConfig(lr=3e-4, warmup=1, decay_steps=WHISPER_STEPS)
    step_fn, structs, cfg, ctx = ST.train_cell(
        "whisper-small", "train_4k", (world, 1), prefetch=True, batch=world,
        seq=WHISPER_DEC_SEQ, opt_cfg=opt, device=dev)
    loc_state, loc_batch = ST.local_structs(structs, (world, 1))
    metas = ED.encdec_metas(cfg, ctx)
    layers = {"enc": cfg.enc_layers, "dec": cfg.n_layers, "top": 0}
    params = ED.init_encdec_params(cfg, ctx, R.PRNGKey(seed), dp_rank=rank,
                                   device=dev)
    state = {"params": params, "opt": O.init_opt_state(params, opt),
             "y": ED.encdec_y_init(cfg, ctx, 1.0, device=dev), "step": 0,
             "key": R.PRNGKey(seed + 1)}
    data = D.DataConfig(vocab=cfg.vocab, seq_len=WHISPER_DEC_SEQ,
                        global_batch=world, seed=seed)

    def batch_at(step):
        b = D.local_batch_at(data, step, rank, world, device=dev)
        b["frames"] = D.frames_at(data, step, cfg.enc_seq, cfg.d_model,
                                  rows=(rank, rank + 1), device=dev)
        return b
    check(_same_structs(loc_state, state)
          and _same_structs(loc_batch, batch_at(0)),
          f"whisper rank {rank}: the state or batch differs from the cell's "
          f"structs")
    sizes = F._dp_sizes(ctx.dp_axes)
    fcfg = ctx.fsdp_config()
    want_bytes = sum(max(layers[g], 1) * F.wire_bytes_bwd(
        S.shard_len(m, ctx) * ctx.dp, sizes, fcfg)
        for g in metas for m in metas[g].values())
    syncs = sum(max(layers[g], 1) * len(metas[g]) for g in metas)
    hops = world.bit_length() - 1

    reg = _Regions(torch)
    steps = []
    with _patched(_tp_instruments(reg, F, C, S, LY)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t_path = time.perf_counter()
        for st in range(WHISPER_STEPS):
            batch = batch_at(st)
            reg.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(step=st, wall_s=time.perf_counter() - t0,
                              gather_s=reg.s.get("gather_s", 0.0),
                              sync_s=reg.s.get("sync_s", 0.0),
                              sent=reg.sent.get("sync_s", 0),
                              loss=float(m["loss"]),
                              gnorm=float(m["gnorm"])))
        path_s = time.perf_counter() - t_path
        launches = dict(_build.LAUNCHES)         # read just after the path
    for st in steps:
        check(math.isfinite(st["loss"]) and math.isfinite(st["gnorm"]),
              f"whisper rank {rank} step {st['step']}: loss {st['loss']}, "
              f"gnorm {st['gnorm']}")
        check(st["sent"] == want_bytes,
              f"whisper rank {rank} step {st['step']}: the DP syncs sent "
              f"{st['sent']} B, the accounting gives {want_bytes}")
    for k in ("lattice_encode", "lattice_decode"):
        check(launches[k] == WHISPER_STEPS * syncs * hops,
              f"whisper rank {rank}: {launches[k]} {k} launches, expected "
              f"{WHISPER_STEPS} x {syncs} x {hops}")
    vals = _gather_floats(torch, [v for st in steps
                                  for v in (st["loss"], st["gnorm"])])
    check(all(v == vals[0] for v in vals),
          f"whisper: the losses and gnorms differ across ranks: {vals}")
    return dict(rank=rank, arch="whisper-small", path_seconds=path_s,
                steps=steps, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches, dp_syncs=syncs, hops=hops,
                wire_bytes=want_bytes, params=cfg.param_count())


def train_families_rank_main(torch, rank: int, world: int, seed: int
                             ) -> dict:
    """One rank's share of the families phase: mamba2-1.3b and
    recurrentgemma-9b through the Trainer on the (dp 2, tp 2) mesh, then
    whisper-small's training steps over four DP ranks.  Each path's
    counts of launches are set to 0 just before it and read just after."""
    import gc

    from repro_torch.launch.mesh import mesh_axes

    torch.use_deterministic_algorithms(True)
    mesh = mesh_axes(TP_MESH)
    out = {}
    for arch, layers, steps, state_dtype in FAMILY_RUNS:
        held = torch.cuda.memory_allocated() / 1e9
        out[arch] = _family_trainer_run(torch, rank, arch, layers, steps,
                                        state_dtype, mesh, seed)
        out[arch]["held_before_gb"] = held
        gc.collect()
        torch.cuda.empty_cache()
    out["whisper-small"] = _whisper_train(torch, rank, world, seed)
    torch.cuda.empty_cache()
    return out


def train_families(seed: int) -> dict:
    """The families phase (see ``train_families_rank_main``); returns the
    encode and single-decode launches of its paths, summed over the ranks
    and the paths."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(train_families_rank_main, (seed,),
                         "train_families")
    total = {k: 0 for k in COLLECTIVE_KERNELS}
    for arch, layers, steps, state_dtype in FAMILY_RUNS:
        rs = [r[arch] for r in ranks]
        launches = {k: sum(r["launches"][k] for r in rs)
                    for k in COLLECTIVE_KERNELS}
        for k in COLLECTIVE_KERNELS:
            total[k] += launches[k]
        for k in ("lattice_encode", "lattice_decode"):
            check(launches[k] > 0, f"kernel {k} was not launched by {arch}")
        say("train_family", arch=arch, layers=layers, steps=steps,
            optimizer_state=state_dtype, params=rs[0]["params"],
            mesh=dict(dp=TP_MESH[0], tp=TP_MESH[1]), seq=TRAIN_SEQ,
            seq_parallel=True, launches=launches,
            ranks=[{k: r[k] for k in (
                "rank", "path_seconds", "state_gb", "held_before_gb",
                "peak_gb", "reserved_gb", "wire_bytes_step",
                "tp_wire_bytes_step", "expected_launches",
                "dp_syncs", "hops", "tp_butterflies", "rounds")}
                   | {"steps": [{k: st[k] for k in (
                       "wall_s", "gather_s", "sync_s", "tp_sync_s",
                       "tp_act_s", "loss", "gnorm", "fails", "peak_gb")}
                       for st in r["steps"]]} for r in rs])
    rs = [r["whisper-small"] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in rs)
                for k in COLLECTIVE_KERNELS}
    for k in COLLECTIVE_KERNELS:
        total[k] += launches[k]
    for k in ("lattice_encode", "lattice_decode"):
        check(launches[k] > 0, f"kernel {k} was not launched by whisper")
    say("train_family", arch="whisper-small", world=WORLD,
        enc_frames=1500, dec_tokens=WHISPER_DEC_SEQ, steps=WHISPER_STEPS,
        params=rs[0]["params"], launches=launches,
        ranks=[{k: r[k] for k in ("rank", "path_seconds", "steps", "peak_gb",
                                  "dp_syncs", "hops", "wire_bytes")}
               for r in rs])
    say("train_families", wall_s=time.perf_counter() - t0, launches=total)
    return total


# ---------------------------------------------------------------------------
# Phases 6e-6g: serving (prefill, then the sharded-KV greedy decode)
# ---------------------------------------------------------------------------

def _place_prefill(torch, SV, S, cache: dict, pcache: dict, P: int, cfg,
                   ctx) -> None:
    """Write a prefill's cache (the prompt's ``P`` positions, chunked over
    the g2 subgroup by the prompt's length) into a decode cache (chunked by
    S_max), in place: this rank gathers its KV group's prompt over its
    subgroup and keeps the positions its chunk owns, quantizing them where
    the cache is int8; the recurrent states, the window and the cross K/V
    are the prefill's own."""
    g1, g2 = SV.groups_of(cfg, ctx)
    j = S.tp_index(ctx) % g2
    for k, v in pcache.items():
        if k not in ("k", "v"):
            cache[k] = v
            continue
        full = S.all_gather_group(v, ctx, SV.seq_groups(cfg, ctx), axis=3)
        s_loc = cache[k].shape[3]
        lo, hi = j * s_loc, min(P, (j + 1) * s_loc)
        if lo >= hi:
            continue
        part = full[:, :, :, lo:hi]
        if cache[k].dtype == torch.int8:
            part, cache[f"{k}_scale"][:, :, :, :hi - lo] = \
                SV._quantize_kv(part)
        cache[k][:, :, :, :hi - lo] = part


def _serve_instruments(reg, F, S, SV) -> list:
    """The decode step's timers: the FSDP gathers, the g2-subgroup
    collectives (the ``wq`` gather, the softmax max and sum) and the TP
    collectives (psums, the greedy pick's maxes, the MoE's all-to-alls and
    gather)."""
    pmax = SV.pmax_tp

    def pmax_timed(x, ctx, groups=None):
        key = "tp_s" if groups is None else "group_s"
        return reg.timed(pmax, key)(x, ctx, groups)

    return [(F, "_issue", reg.timed(F._issue, "gather_s")),
            (F, "_gather_value", reg.timed(F._gather_value, "gather_s")),
            (SV, "all_gather_group", reg.timed(SV.all_gather_group,
                                               "group_s")),
            (SV, "_psum", reg.timed(SV._psum, "group_s")),
            (SV, "pmax_tp", pmax_timed),
            (S, "_psum", reg.timed(S._psum, "tp_s")),
            (S, "_all_gather_cat", reg.timed(S._all_gather_cat, "tp_s")),
            (S, "_all_to_all", reg.timed(S._all_to_all, "tp_s"))]


def _check_cache(torch, SV, cache: dict, struct: dict, kvq: bool,
                 tag: str) -> None:
    """Every leaf of ``cache_struct``'s shape, the K/V (and window) leaves
    of ``cache_dtype``'s dtype, and every value finite (a layer at a time:
    ``isfinite`` takes temporaries of the leaf's size)."""
    for k, v in cache.items():
        check(tuple(v.shape) == tuple(struct[k]) and
              (k not in SV._IN_PLACE or v.dtype == SV.cache_dtype(k, kvq)),
              f"{tag}: cache leaf {k} {tuple(v.shape)} {v.dtype} against "
              f"{struct[k]}")
        if v.is_floating_point():
            check(all(bool(torch.isfinite(x).all()) for x in v),
                  f"{tag}: cache leaf {k} holds non-finite values")


def _serve_run(torch, rank: int, seed: int, run: dict, axes) -> dict:
    """One model through the port's serving path on one mesh: its bf16
    parameters drawn on the card (this rank's slices), a seeded prompt
    prefilled into a ``SERVE_S_MAX``-position cache, then greedy decode
    steps, once for each cache type of ``run["kv_quant"]``; the int8 run is
    fed the bf16 run's tokens, so their caches hold the same positions.
    Every check raises."""
    import gc

    from repro_torch import random as R
    from repro_torch.configs import registry
    from repro_torch.dist import collectives as C
    from repro_torch.dist import fsdp as F
    from repro_torch.kernels import _build
    from repro_torch.models import encdec as ED
    from repro_torch.models import serve as SV
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    dp, tp = run["mesh"]
    cfg = registry.config(run["arch"])
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    ctx = S.ShardCtx(tp=tp, dp=dp, dp_axes=axes[0], tp_axis=axes[1])
    di, ti = rank // tp, rank % tp
    encdec = cfg.family == "encdec"
    B, P, new = run["batch"], run["prompt"], run["new"]
    b_loc = B // dp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init = ED.init_encdec_params if encdec else T.init_params
    params = init(cfg, ctx, R.PRNGKey(seed), dp_rank=di, tp_rank=ti,
                  device=dev)
    for g in params:                     # bf16 storage, one leaf at a time
        for k in params[g]:
            params[g][k] = params[g][k].to(torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    metas = ED.encdec_metas(cfg, ctx) if encdec else T.all_metas(cfg, ctx)
    n_layers = {"layers": T.n_scan_steps(cfg), "dec": cfg.n_layers,
                "top": 1}
    weight_bytes = 2 * sum(m.numel() * (n_layers[g] if m.scanned else 1)
                           for g in metas if g != "enc"
                           for m in metas[g].values())
    gen = torch.Generator().manual_seed(seed + 1)
    rows = slice(di * b_loc, (di + 1) * b_loc)
    prompt = torch.randint(cfg.vocab, (B, P), generator=gen)[rows].to(dev)
    frames = (torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen)
              [rows].to(dev) if encdec else None)
    key = R.PRNGKey(seed + 2)
    g1, g2 = SV.groups_of(cfg, ctx)
    j = ti % g2
    out = dict(rank=rank, arch=run["arch"], layers=cfg.n_layers,
               params=cfg.param_count(), init_s=init_s, g1=g1, g2=g2,
               h_loc=SV.LY.local_heads(cfg, ctx), hg=cfg.n_heads // g1,
               runs={})
    kept, fed = None, None
    reg = _Regions(torch)
    for kvq in run["kv_quant"]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = SV.cache_zeros(cfg, ctx, b_loc, SERVE_S_MAX, kv_quant=kvq,
                               device=dev)
        struct = SV.cache_struct(cfg, ctx, b_loc, SERVE_S_MAX,
                                 kv_quant=kvq)
        cache_bytes = sum(v.numel() * v.element_size()
                          for v in cache.values())
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if encdec:
            _, pcache = SV.make_encdec_prefill(cfg, ctx)(params, frames,
                                                         prompt, key)
        else:
            _, pcache = SV.make_prefill(cfg, ctx)(params, prompt, key)
        with torch.inference_mode():
            _place_prefill(torch, SV, S, cache, pcache, P, cfg, ctx)
        del pcache
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step = SV.make_serve_step(cfg, ctx, kv_quant=kvq)
        tok = prompt[:, -1:].to(torch.int32)
        steps, toks = [], []
        with _patched(_serve_instruments(reg, F, S, SV)):
            for s in range(new):
                reg.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                # the first step re-feeds the prompt's last token at its
                # position: its output is the token after the prompt
                nxt, cache = step(params, cache, tok, P - 1 + s, key)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                parts = {k: reg.s.get(k, 0.0)
                         for k in ("gather_s", "group_s", "tp_s")}
                steps.append(dict(wall_s=wall, **parts,
                                  rest_s=wall - sum(parts.values())))
                toks.append(nxt)
                tok = (fed[s] if fed is not None else nxt)[:, None]
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        toks = torch.stack(toks)                        # (new, b_loc)
        peers = C._all_gather(toks, ctx.tp_axis) if tp > 1 else toks[None]
        check(all(torch.equal(p, toks) for p in peers),
              f"{run['arch']} rank {rank}: the TP ranks' tokens differ")
        check(int(toks.min()) >= 0 and
              int(toks.max()) < cfg.vocab + ctx.tp,
              f"{run['arch']} rank {rank}: token ids past the vocab")
        _check_cache(torch, SV, cache, struct, kvq,
                     f"{run['arch']} rank {rank}")
        # the written positions of this rank's chunk, [0, P - 1 + new):
        # the int8 cache dequantized against the bf16 run's, over the
        # bf16 cache's largest entry, where both runs wrote the entry from
        # the same values (every layer at the prefill's positions, layer 0
        # everywhere: its K/V are the fed token's) within the reference's
        # 2%; elsewhere the entries' inputs have been through attention
        # over the int8 cache, and their drift is printed by layer
        s_loc = cache["k"].shape[3] if "k" in cache else 0
        lo, hi = j * s_loc, min(P - 1 + new, (j + 1) * s_loc)
        int8_err = int8_drift = None
        if "k" in cache and not encdec and lo < hi:
            if not kvq:
                kept = {k: cache[k][:, :, :, :hi - lo].clone()
                        for k in ("k", "v")}
            else:
                same, drift = 0.0, 0.0
                n_pre = max(0, min(P - 1, hi) - lo)
                for k in ("k", "v"):
                    deq = (cache[k][:, :, :, :hi - lo].to(torch.float32)
                           * (cache[f"{k}_scale"][:, :, :, :hi - lo]
                              / 127.0)[..., None])
                    ref = kept[k].to(torch.float32)
                    err = (deq - ref).abs() / max(float(ref.abs().max()),
                                                  1e-6)
                    same = max(same, float(err[0].max()),
                               float(err[:, :, :, :n_pre].max())
                               if n_pre else 0.0)
                    drift = torch.maximum(torch.as_tensor(drift),
                                          err.amax(dim=(1, 2, 3, 4)).cpu())
                int8_err, int8_drift = same, drift.tolist()
                check(int8_err < 0.02,
                      f"{run['arch']} rank {rank}: the int8 cache is "
                      f"{int8_err:.4f} of the bf16 cache's largest entry "
                      f"away from it where both runs wrote the same "
                      f"values (the limit is 0.02)")
        walls = sorted(st["wall_s"] for st in steps)
        med = statistics.median(walls)
        out["runs"][str(kvq)] = dict(
            kv_quant=kvq, prefill_s=prefill_s, steps=steps,
            step_median_s=med, step_min_s=walls[0], step_max_s=walls[-1],
            tokens_per_s=B / med, peak_gb=peak_gb, cache_bytes=cache_bytes,
            weight_bytes=weight_bytes, launches=launches,
            int8_rel_err=int8_err, int8_drift_by_layer=int8_drift,
            tokens=toks.cpu().tolist(),
            int8_tokens_equal_bf16=(None if fed is None else
                                    float((toks == fed).float().mean())))
        if fed is None:
            fed = toks
        del cache, step
    return out


def serve_rank_main(torch, rank: int, world: int, seed: int, runs) -> list:
    """One rank's share of a serving phase: each run of ``runs`` on its
    mesh (every rank makes every mesh's groups, in one order)."""
    import gc

    from repro_torch.launch.mesh import mesh_axes

    meshes = {}
    for run in runs:
        dp, tp = run["mesh"]
        if run["mesh"] not in meshes:
            dp_axes, tp_axis = mesh_axes((dp, tp))
            meshes[run["mesh"]] = (dp_axes, tp_axis)
    out = []
    for run in runs:
        out.append(_serve_run(torch, rank, seed, run, meshes[run["mesh"]]))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _serve_phase(name: str, runs, seed: int) -> None:
    """Spawn the ranks for one serving phase and print what they
    measured: per run and cache type, prefill s, each step's wall and its
    parts (gathers, subgroup collectives, TP collectives, the rest),
    tokens/s, peak GB a rank, the bytes a step must read over the four
    ranks (weights and cache) and their bound at ``HBM_BYTES_PER_S``, and
    the share of it the median step reaches."""
    t0 = time.perf_counter()
    ranks = _spawn_ranks(serve_rank_main, (seed, runs), name)
    for i, run in enumerate(runs):
        rs = [r[i] for r in ranks]
        for kvq in run["kv_quant"]:
            per = [r["runs"][str(kvq)] for r in rs]
            nbytes = sum(p["weight_bytes"] + p["cache_bytes"] for p in per)
            bound_s = nbytes / HBM_BYTES_PER_S
            med = max(p["step_median_s"] for p in per)
            lattice = {k: sum(p["launches"][k] for p in per)
                       for k in COLLECTIVE_KERNELS}
            say(name, arch=run["arch"], layers=rs[0]["layers"],
                params=rs[0]["params"], mesh=dict(dp=run["mesh"][0],
                                                  tp=run["mesh"][1]),
                g1=rs[0]["g1"], g2=rs[0]["g2"], h_loc=rs[0]["h_loc"],
                hg=rs[0]["hg"], batch=run["batch"], s_max=SERVE_S_MAX,
                prompt=run["prompt"], new_tokens=run["new"], kv_quant=kvq,
                init_s=max(r["init_s"] for r in rs),
                prefill_s=max(p["prefill_s"] for p in per),
                step_median_s=med,
                step_range_s=[min(p["step_min_s"] for p in per),
                              max(p["step_max_s"] for p in per)],
                tokens_per_s=run["batch"] / med,
                step_bytes=nbytes, bound_ms=bound_s * 1e3,
                share_of_bound=bound_s / med,
                lattice_launches=lattice,
                int8_rel_err=[p["int8_rel_err"] for p in per],
                int8_drift_by_layer=[p["int8_drift_by_layer"] for p in per],
                int8_tokens_equal_bf16=per[0]["int8_tokens_equal_bf16"],
                tokens=per[0]["tokens"],
                ranks=[dict(rank=r["rank"], peak_gb=p["peak_gb"],
                            cache_gb=p["cache_bytes"] / 1e9,
                            weight_gb=p["weight_bytes"] / 1e9,
                            steps=p["steps"]) for r, p in zip(rs, per)])
    say(name + "_phase", wall_s=time.perf_counter() - t0)


def serve_glm4_tp4(seed: int) -> None:
    _serve_phase("serve_glm4_tp4", SERVE_GLM4, seed)


def serve_granite_moe_tp(seed: int) -> None:
    _serve_phase("serve_granite_moe_tp", SERVE_GRANITE, seed)


def serve_families(seed: int) -> None:
    _serve_phase("serve_families", SERVE_FAMILIES, seed)


# ---------------------------------------------------------------------------
# Phases 7-9: the multi-round service, the tree and the engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def digest_timer(acc):
    """While open, time every anchor digest (host clock; it copies the
    anchor to the host) into ``acc["seconds"]`` and count them in
    ``acc["calls"]``; the function is restored on exit."""
    from repro_torch.agg import rounds

    digest = rounds.anchor_digest

    def timed(anchor):
        t0 = time.perf_counter()
        r = digest(anchor)
        acc["seconds"] += time.perf_counter() - t0
        acc["calls"] += 1
        return r

    rounds.anchor_digest = timed
    try:
        yield
    finally:
        rounds.anchor_digest = digest


def launched(_build, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}


def agg_service(torch, seed: int) -> dict:
    """Three lockstep rounds of the anchored service at full width: the
    whole fleet encoded in one launch over S x padded coordinates (past
    2^31), frames as bytes, one batched decode per drain, the mean fed
    back as the next round's anchor and its decode telemetry into y."""
    from repro_torch.agg import rounds, sim
    from repro_torch.agg.client import AggClient
    from repro_torch.agg.service import AggService, ServiceConfig
    from repro_torch.agg.transport import frame as wire
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    d, n = FULL_D, SERVICE_CLIENTS
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    base = torch.randn(d, generator=g, device=dev)
    drift = torch.randn(d, generator=g, device=dev)
    cfg = ServiceConfig(d=d, q=16, bucket=4096, y0=0.25, seed=seed)
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    # warm start: round 1 anchors at the previous model state
    svc = AggService(cfg, anchor0=base)
    prev_digest = None
    phase = {k: 0 for k in _build.LAUNCHES}
    for r in range(SERVICE_ROUNDS):
        xs = torch.empty((n, d), device=dev)
        exact = torch.zeros(d, dtype=torch.float64, device=dev)
        for i in range(n):
            torch.add(base, drift, alpha=0.01 * r, out=xs[i])
            xs[i] += 0.02 * torch.randn(d, generator=g, device=dev)
            exact += xs[i].to(torch.float64)
        exact /= n
        before = dict(_build.LAUNCHES)
        dig = dict(seconds=0.0, calls=0)
        t = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with digest_timer(dig):
            spec, anchor = svc.begin_round()
            server = svc.make_server()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            frames = sim.fleet_frames(spec, xs, anchor=anchor)
            t2 = time.perf_counter()
            for fs in frames:
                for f in fs:
                    server.receive(f)
            t3 = time.perf_counter()
            dec0 = _build.LAUNCHES["lattice_decode_batched"]
            responses = server.drain()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            dec = _build.LAUNCHES["lattice_decode_batched"] - dec0
            mean, stats = svc.end_round(server)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        t = dict(open_round=t1 - t0, encode_and_frame=t2 - t1,
                 receive=t3 - t2, drain=t4 - t3, publish=t5 - t4)
        wall = t5 - t0
        counts = launched(_build, before)
        phase = {k: phase[k] + counts[k] for k in phase}
        check_responses(responses, n, f"service round {r + 1}")
        check(dec == 1, f"service round {r + 1}: the drain made {dec} "
              "batched decode launches")
        check(counts["lattice_encode"] == 1,
              f"service round {r + 1}: {counts['lattice_encode']} encode "
              "launches for the fleet")
        check(stats.accepted == n and stats.decode_failures == 0
              and stats.nacks_sent == 0,
              f"service round {r + 1}: accepted {stats.accepted} of {n}")
        check(tuple(mean.shape) == (d,) and bool(torch.isfinite(mean).all()),
              f"service round {r + 1}: the mean is not a finite (d,) vector")
        if prev_digest is not None:
            check(spec.anchor_digest == prev_digest,
                  f"service round {r + 1}: the spec's digest "
                  f"{spec.anchor_digest:#x} is not that of round {r}'s mean "
                  f"({prev_digest:#x})")
        # per coordinate within 0.51 s of its bucket
        err = torch.nn.functional.pad(
            (mean.to(torch.float64) - exact).abs(), (0, spec.padded - d))
        err_b = err.reshape(spec.nb, spec.cfg.bucket).amax(dim=1)
        sides = torch.from_numpy(spec.sides_np()).to(dev, torch.float64)
        share = float((err_b / (0.51 * sides)).max())
        check(share <= 1.0, f"service round {r + 1}: |mean - exact| reaches "
              f"{share} of 0.51 s in some bucket")
        same_client = None
        if r == 0:
            # the last client's words lie past coordinate 2^31 of the
            # fleet's one encode: equal to its own client's, byte for byte
            c = AggClient(spec, n - 1, xs[n - 1], anchor=anchor)
            same_client = c.frames() == frames[n - 1]
            check(same_client, "service round 1: the fleet encode past "
                  "2^31 differs from the client's own encode")
            del c
        del xs, exact, err, frames, server
        t0 = time.perf_counter()
        prev_digest = rounds.anchor_digest(mean)
        check_digest_s = time.perf_counter() - t0
        say("agg_service_round", round=r + 1, d=d, clients=n,
            fleet_coordinates=n * spec.padded, anchored=spec.anchored,
            accepted=stats.accepted, attempt0=True, decode_launches=dec,
            encode_launches=counts["lattice_encode"], wall_s=wall,
            seconds=t, digest_s=dig["seconds"], digests=dig["calls"],
            check_digest_s=check_digest_s, max_y=float(svc.y.max()),
            mean_y=float(svc.y.mean()), max_err_share_of_bound=share,
            fleet_equals_client_past_2_31=same_client)
        del mean
    for name in ("lattice_encode", "lattice_decode_batched"):
        check(phase[name] > 0,
              f"kernel {name} was not launched by the service")
    say("agg_service", rounds=SERVICE_ROUNDS, clients=n, d=d,
        seconds=time.perf_counter() - t_phase, launches=phase,
        peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    del svc, base, drift
    torch.cuda.empty_cache()
    return phase


def agg_tree(torch, seed: int) -> dict:
    """16 clients over one layer of 4 edge tiers into the root, at full
    width, unanchored: the tiers fold integer residuals on the card and
    never decode; the root decodes once per color space it receives; the
    mean equals a flat server's drain of the same frames bit for bit."""
    from repro_torch.agg import sim
    from repro_torch.agg.server import AggServer
    from repro_torch.agg.transport import chunks as C
    from repro_torch.agg.transport import frame as wire
    from repro_torch.agg.tree import AggTree
    from repro_torch.dist.collectives import QSyncConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    d, n = FULL_D, CLIENTS
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(d, generator=g, device=dev)
    spec = wire.RoundSpec(round_id=1, d=d, cfg=QSyncConfig(q=16, bucket=4096),
                          y0=0.25, seed=seed)
    _build.reset_launch_counts()
    ops.reset_dispatch_counts()
    t_phase = time.perf_counter()
    # the clients: two fleet encodes of 8 (each past 2^31 coordinates)
    frames = []
    t0 = time.perf_counter()
    half = n // 2
    for c0 in (0, half):
        xs = torch.stack([client_vector(torch, base, seed, i)
                          for i in range(c0, c0 + half)])
        words, sides_np, checks = sim.fleet_encode(spec, xs)
        del xs
        frames.extend(C.encode_chunks(spec, c0 + i, 0, spec.cfg.q, words[i],
                                      sides_np, int(checks[i]))
                      for i in range(half))
        del words
    t_clients = time.perf_counter() - t0
    encodes = dict(_build.LAUNCHES)      # the clients' part of the path
    torch.cuda.empty_cache()

    # the flat server over the same frames (its drain is the comparison,
    # not the path: its launches are left out of the phase's counts)
    t0 = time.perf_counter()
    flat = AggServer(spec, base)
    for fs in frames:
        for f in fs:
            flat.receive(f)
    flat.drain()
    flat_mean, flat_stats = flat.finalize()
    torch.cuda.synchronize()
    t_flat = time.perf_counter() - t0
    check(flat_stats.accepted == n, f"tree phase: the flat server accepted "
          f"{flat_stats.accepted} of {n}")
    del flat
    torch.cuda.empty_cache()

    # the tree
    torch.cuda.reset_peak_memory_stats()
    before = dict(_build.LAUNCHES)
    ops.reset_dispatch_counts()
    t = {}
    t0 = time.perf_counter()
    tree = AggTree(spec, base, fanout=TREE_FANOUT, tiers=1)
    torch.cuda.synchronize()
    t["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for fs in frames:
        for f in fs:
            tree.ingest_frame(f)
    t["ingest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree.tick()                          # every tier folds its children
    torch.cuda.synchronize()
    t["tier_folds"] = time.perf_counter() - t0
    tier_decodes = ops.DISPATCH_COUNTS["lattice_decode_batched"] + \
        ops.DISPATCH_COUNTS["lattice_decode"]
    t0 = time.perf_counter()
    tree.seal()
    ticks = 0
    while not tree.published():
        check(ticks < 16, "tree phase: the tree did not publish")
        tree.tick()
        ticks += 1
    torch.cuda.synchronize()
    t["forward_and_root"] = time.perf_counter() - t0
    pub = tree.published()[0]
    wall = sum(t.values())
    counts = launched(_build, before)
    spaces = sorted({tr.forwarded_q for tr in tree.layers[0]})
    root_decodes = ops.DISPATCH_COUNTS["lattice_decode_batched"]
    check(tier_decodes == 0, f"tree phase: the tiers made {tier_decodes} "
          "decode dispatches")
    check(ops.DISPATCH_COUNTS["lattice_decode"] == 0,
          "tree phase: a single-payload decode was dispatched")
    check(root_decodes == len(spaces) == counts["lattice_decode_batched"],
          f"tree phase: the root made {root_decodes} batched decodes "
          f"({counts['lattice_decode_batched']} launches) for color spaces "
          f"{spaces}")
    check(pub.accepted == frozenset(range(n)),
          f"tree phase: the tree accepted {sorted(pub.accepted)}")
    check(torch.equal(pub.mean.view(torch.int32),
                      flat_mean.view(torch.int32)),
          "tree phase: the tree's mean differs from the flat drain's")
    stats = tree.tier_stats()
    peak = torch.cuda.max_memory_allocated() / 1e9
    say("agg_tree", d=d, clients=n, fanout=TREE_FANOUT, tiers=1,
        forwarded_q=[tr.forwarded_q for tr in tree.layers[0]],
        color_spaces=spaces, tier_decode_dispatches=tier_decodes,
        root_decode_dispatches=root_decodes,
        root_drains=tree.root.stats.drains,
        root_payloads=tree.root_ingress_payloads,
        tier_accepted=[s.accepted for s in stats],
        tier_bytes_out=[s.bytes_out for s in stats],
        equals_flat_drain=True, wall_s=wall, seconds=t,
        clients_encode_s=t_clients, flat_server_s=t_flat,
        launches=counts, peak_device_gb=peak)
    # the phase's path: the clients' encodes and the tree's own launches
    phase = {k: encodes.get(k, 0) + counts[k] for k in counts}
    del tree, pub, flat_mean, frames
    torch.cuda.empty_cache()
    if 256 in spaces:
        # the root's payloads at 8-bit colors: that shape of the batched
        # decode held against its plain version (not counted)
        g = torch.Generator(device=dev).manual_seed(seed + 13)
        x = torch.randn(spec.padded, generator=g, device=dev)
        u = torch.rand(spec.padded, generator=g, device=dev) - 0.5
        say("kernel_check", name="lattice_decode_batched_q256",
            **batched_decode_check(torch, x, u, 256, TREE_FANOUT,
                                   spec.cfg.bucket, g))
        del x, u
        torch.cuda.empty_cache()
    say("agg_tree_phase", seconds=time.perf_counter() - t_phase,
        launches=phase, q256_checked=256 in spaces)
    return phase


def agg_engine_small(torch, seed: int) -> dict:
    """The continuous-round engine on the card: ``run_open_loop`` at
    d = 2^22 with every published round replayed through a lockstep
    server; then one trace at d = 2^18 through the engine and a 2-tier
    tree once on the card and once on the CPU, bitwise equal."""
    import numpy as np

    from repro_torch.agg import sim
    from repro_torch.agg.transport import frame as wire
    from repro_torch.agg.tree import AggTree
    from repro_torch.dist.collectives import QSyncConfig
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    t_phase = time.perf_counter()
    cfg = sim.OpenLoopConfig(d=1 << 22, mtu=1 << 19, seed=seed,
                             **ENGINE_TRAFFIC)
    t0 = time.perf_counter()
    rep = sim.run_open_loop(cfg, check_parity=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)       # the engine's path alone
    check(rep.rounds >= 2 and rep.accepted_total > 0,
          f"engine: {rep.rounds} rounds published, {rep.accepted_total} "
          "clients accepted")
    check(all(pr.mean.device.type == "cuda" for pr in rep.published),
          "engine: a published mean is not on the card")
    for name in ("lattice_encode", "lattice_decode_batched"):
        check(counts[name] > 0,
              f"kernel {name} was not launched by the engine")
    # replay parity, outside the counts: every published round re-drained
    # lockstep over its accepted clients gives the same mean bit for bit
    t0 = time.perf_counter()
    trace = sim._make_trace(cfg)         # the same numpy draws again
    trace_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for pr in rep.published:
        sim.replay_published_round(trace, pr)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    del trace
    say("agg_engine", d=cfg.d, rounds=rep.rounds,
        clients_arrived=rep.clients_arrived,
        accepted_total=rep.accepted_total, expired_total=rep.expired_total,
        retried_total=rep.retried_total, resends_total=rep.resends_total,
        max_live_rounds=rep.max_live_rounds, replay_parity=True,
        p50_latency_virtual_s=rep.p50_latency,
        p99_latency_virtual_s=rep.p99_latency, wall_s=wall,
        trace_s=trace_s, replay_s=replay_s, launches=counts)

    # card == CPU on one small trace: the engine, then a 2-tier tree
    small = sim.OpenLoopConfig(d=1 << 18, mtu=1 << 15, seed=seed,
                               **ENGINE_TRAFFIC)
    pubs = {}
    for dev in ("cuda", "cpu"):
        pubs[dev] = sim.run_open_loop(small, check_parity=False,
                                      device=dev).published
    check([p.round_id for p in pubs["cuda"]]
          == [p.round_id for p in pubs["cpu"]]
          and all(a.accepted == b.accepted and torch.equal(
              a.mean.cpu().view(torch.int32), b.mean.view(torch.int32))
              for a, b in zip(pubs["cuda"], pubs["cpu"])),
          "engine: the card's published rounds differ from the CPU's")
    d2, n2 = 1 << 18, 24
    rng = np.random.RandomState(seed)
    base = rng.randn(d2).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(n2, d2).astype(np.float32)
    spec = wire.RoundSpec(round_id=3, d=d2, cfg=QSyncConfig(q=16, bucket=4096),
                          y0=0.25, seed=seed)
    frames = sim.fleet_frames(spec, xs)
    means = {}
    for dev in ("cuda", "cpu"):
        tree = AggTree(spec, base, fanout=4, tiers=2, device=dev)
        for fs in frames:
            for f in fs:
                tree.ingest_frame(f)
        tree.tick()
        tree.seal()
        for _ in range(16):
            tree.tick()
            if tree.published():
                break
        pr = tree.published()
        check(len(pr) == 1 and pr[0].accepted == frozenset(range(n2)),
              f"2-tier tree on {dev} did not publish every client")
        means[dev] = pr[0].mean.cpu()
    check(torch.equal(means["cuda"].view(torch.int32),
                      means["cpu"].view(torch.int32)),
          "2-tier tree: the card's mean differs from the CPU's")
    say("agg_engine_small", engine_rounds=len(pubs["cuda"]),
        engine_card_equals_cpu=True, tree_d=d2, tree_clients=n2,
        tree_card_equals_cpu=True, seconds=time.perf_counter() - t_phase)
    return counts


def host_costs(torch, d: int, seed: int) -> None:
    """Time the round's non-kernel costs at full width, one at a time:
    the two threefry draws a party makes (dither, checksum weights), the
    anchor digest, and one CRC-32 pass over a payload-sized frame."""
    import zlib

    from repro_torch.agg import rounds
    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig

    spec = wire.RoundSpec(round_id=1, d=d, cfg=QSyncConfig(q=16, bucket=4096),
                          y0=0.25, seed=seed)
    out = {}
    for name, fn in (("dither_draw", lambda: rounds.dither(spec, "cuda")),
                     ("weights_draw",
                      lambda: rounds.checksum_weights(spec, "cuda"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    v = torch.zeros(d, device="cuda")
    t0 = time.perf_counter()
    rounds.anchor_digest(v)
    out["anchor_digest"] = time.perf_counter() - t0
    frame = bytes(wire.payload_bytes(spec))
    t0 = time.perf_counter()
    zlib.crc32(frame)
    out["crc32_frame"] = time.perf_counter() - t0
    say("host_costs", seconds=out, frame_bytes=len(frame))


# ---------------------------------------------------------------------------
# Phase 12: attention at full width
# ---------------------------------------------------------------------------

def attention_inputs(torch, heads: int, kv_heads: int, hd: int, sq: int,
                     sk: int, batch: int, dtype, seed: int):
    """q (batch*heads, sq, hd) and k, v (batch*heads, sk, hd) drawn for
    ``kv_heads`` heads and expanded to ``heads`` (grouped-query
    attention), in ``dtype``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(batch * heads, sq, hd, generator=g, device=dev).to(dtype)

    def kv():
        t = torch.randn(batch, kv_heads, sk, hd, generator=g, device=dev)
        return (t.to(dtype).repeat_interleave(heads // kv_heads, dim=1)
                .reshape(batch * heads, sk, hd))
    k = kv()
    return q, k, kv()


def attention_path(torch, ops, _build, cases_in, seed: int):
    """One main path: every ``ops.flash_attention`` call of ``cases_in`` at
    the full shapes (one kept, then the timed ones: one call at a time, and
    under ``DEVICE_MS_UNDER`` ms also back to back), with the counts set to
    0 before it and read after it."""
    cases = []
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for label, heads, kvh, hd, tokens, batch, dt, causals in cases_in:
        sq, sk = tokens if isinstance(tokens, tuple) else (tokens, tokens)
        dtype = getattr(torch, dt)
        q, k, v = attention_inputs(torch, heads, kvh, hd, sq, sk, batch,
                                   dtype, seed)
        for causal in causals:
            o = ops.flash_attention(q, k, v, causal=causal)
            def call():
                return ops.flash_attention(q, k, v, causal=causal)
            ms = cuda_ms(torch, call)
            extra = {}
            if ms < DEVICE_MS_UNDER:
                extra["device_ms"], extra["device_reps"] = device_ms(torch,
                                                                     call)
            cases.append(dict(label=label, dtype=dt, causal=causal,
                              qkv=(q, k, v), out=o, ms=ms, **extra))
        del q, k, v
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = _build.LAUNCHES["flash_attention"]   # read just after the path
    return cases, launches, path_s


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs attention computes: all of them, or where
    causal those with key position <= query position (both from 0)."""
    if not causal:
        return sq * sk
    full = max(0, sq - sk)                     # rows that see every key
    part = sq - full                           # rows i < sk see i + 1 keys
    return full * sk + part * (part + 1) // 2


def sm_clock_hz() -> float:
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(out) * 1e6


def attention(torch, seed: int):
    """The attention phase: one main path for each kernel entry: the bf16
    and the f16 cases up to head dim 256 (two instances of the wgmma
    kernel), the f32 cases up to 64 (the f32 wgmma kernel), at 256 and at
    512 (the mma.sync kernel), and the bf16 and f16 cases past 256 (the
    wide wgmma kernel, D 512 and, in bf16, D 320), each driven with the
    counts set to 0 just before it and read just after.  The comparison
    with the plain version reuses the kept outputs and launches nothing.
    Returns {kernel: (kernels-line entry, launches)}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import _build, ops, ref

    torch.cuda.empty_cache()
    # exponentials a ms: the special-function units of every SM
    exp_per_ms = (EXP_PER_CLOCK_SM * sm_clock_hz() / 1e3
                  * torch.cuda.get_device_properties(0).multi_processor_count)
    out = {}
    groups = {}
    for c in ATTENTION_CASES:
        groups.setdefault(attention_kernel(c[6], c[3], c[4], c[7]),
                          []).append(c)
    for name, cases_in in groups.items():
        dt = cases_in[0][6]
        cases, launches, path_s = attention_path(torch, ops, _build,
                                                 cases_in, seed)
        check(launches > 0, f"kernel {name} was not launched on the "
              f"{dt} attention path")
        results = []
        for c in cases:
            q, k, v = c.pop("qkv")
            o = c.pop("out")
            bh, sq, hd = q.shape
            sk = k.shape[1]
            causal = c["causal"]
            check(tuple(o.shape) == tuple(q.shape) and o.dtype == q.dtype
                  and bool(torch.isfinite(o).all()),
                  f"attention {c['label']}: not a finite {tuple(q.shape)} "
                  f"{q.dtype} output")
            want = ref.flash_attention_ref(q[:2], k[:2], v[:2],
                                           causal=causal).float()
            rtol, atol = ATTENTION_TOL[dt]
            limit = atol + rtol * want.abs()
            err = max_abs_err(torch, o[:2], want)
            # the largest |diff| as a share of its limit atol + rtol |want|
            share = float(((o[:2].float() - want).abs() / limit).max())
            check(share <= 1.0,
                  f"{name} disagrees with its plain version on "
                  f"{c['label']} (causal={causal}): max |diff| = {err}, "
                  f"{share} of rtol={rtol}, atol={atol}")

            # the first of SDPA's backends that takes the shape, in its own
            # order of preference (flash, then memory-efficient: what the
            # two together pick), then cuDNN and the plain math one
            backend = None
            for be in (SDPBackend.FLASH_ATTENTION,
                       SDPBackend.EFFICIENT_ATTENTION,
                       SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
                try:
                    with sdpa_kernel([be]):
                        torch.nn.functional.scaled_dot_product_attention(
                            q[None, :1], k[None, :1], v[None, :1],
                            is_causal=causal)
                    backend = be
                    break
                except RuntimeError:
                    continue
            check(backend is not None, f"no SDPA backend takes "
                  f"{c['label']}")

            def library(n=bh):
                with sdpa_kernel([backend]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q[None, :n], k[None, :n], v[None, :n],
                        is_causal=causal)[0]
            # SDPA's own share of the same limit: information, not checked
            sdpa_share = float(((library(2).float() - want).abs()
                                / limit).max())
            del want, limit

            def plain():
                for h0 in range(0, bh, 2):
                    ref.flash_attention_ref(q[h0:h0 + 2], k[h0:h0 + 2],
                                            v[h0:h0 + 2], causal=causal)
            plain_ms = cuda_ms(torch, plain, reps=1)
            lib_ms = cuda_ms(torch, library)
            elt = q.element_size()
            # the unpadded head dim's operations, whatever width ran
            scores = bh * attention_pairs(sq, sk, causal)
            useful = 4 * hd * scores
            # Q read and O written, and the keys and values the mask
            # leaves (causal: the first Sq of them)
            keys = min(sq, sk) if causal else sk
            nbytes = 2 * bh * (sq + keys) * hd * elt
            extra = {}
            if dt != "float32":
                # f16 has bf16's dense tensor-core rate
                b, by = bound(nbytes, useful, BF16_OPS_PER_S)
                extra["issued_bound_ms"], _ = bound(
                    nbytes, BF16_ISSUED * useful, BF16_OPS_PER_S)
                # one exponential a score: what bounds a small head dim
                extra["exp_bound_ms"] = scores / exp_per_ms
                extra["scores_per_s"] = scores / c["ms"] * 1e3
            else:
                # the f32 kernel computes each f32 product as three TF32
                # ones on the tensor cores, within f32's tolerance: the
                # least time at f32 precision is the lower of that and the
                # CUDA cores' f32 rate (kept as information)
                f32_rate = bound(nbytes, useful)
                extra["f32_rate_bound_ms"] = f32_rate[0]
                b, by = min(bound(nbytes, TF32_ISSUED * useful,
                                  TF32_OPS_PER_S), f32_rate)
            if "device_ms" in c:
                extra["device_share_of_bound"] = b / c["device_ms"]
                # SDPA back to back too, as the kernel was
                extra["library_device_ms"], _ = device_ms(torch, library)
            c.update(kernel=name, shape=f"BH={bh}, Sq={sq}, Sk={sk}, "
                     f"D={hd}", plain_ms=plain_ms, bound_ms=b, bound_by=by,
                     share_of_bound=b / c["ms"], library_ms=lib_ms,
                     max_abs_err=err, rtol=rtol, atol=atol,
                     share_of_limit=share, sdpa_share_of_limit=sdpa_share,
                     sdpa_backend=backend.name,
                     useful_tflop=useful / 1e12,
                     tflop_per_s=useful / c["ms"] / 1e9, **extra)
            say("attention", **c)
            results.append(c)
            del q, k, v, o
            torch.cuda.empty_cache()
        say("attention_path", kernel=name, launches=launches,
            seconds=path_s)
        first = results[0]
        entry = {k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}
        entry["max_abs_err"] = max(r["max_abs_err"] for r in results)
        out[name] = (entry, launches)
    return out


# ---------------------------------------------------------------------------
# Phase 13: the paper's algorithms
# ---------------------------------------------------------------------------

def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def paper_algorithms(torch, seed: int) -> None:
    """Algorithms 3/4/5, the butterfly, variance reduction and the ten
    compressors of ``repro_torch.core`` on the card; every check raises."""
    import numpy as np

    from repro_torch import random as R
    from repro_torch.core import compressors as Cmp
    from repro_torch.core import dme as DME
    from repro_torch.core import error_detect as ED
    from repro_torch.core import rotation as Rot
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    t_phase = time.perf_counter()

    # --- the four DME functions at full width, 4 machines
    n, d, y = 4, FULL_D, 0.25
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(d, generator=g, device=dev)
    xs = torch.stack([client_vector(torch, base, seed, i) for i in range(n)])
    del base
    exact = xs[0].to(torch.float64)
    for i in range(1, n):
        exact += xs[i].to(torch.float64)
    exact /= n
    sigma, alpha = 0.02, 16.0          # the inputs' spread; y_vr = 0.32
    y_vr = 2 * sigma * (alpha * n) ** 0.5
    # error limits: stochastic rounding moves a coordinate by under one side
    # per quantization and the star and tree quantize twice on every path
    # (the tree's inner averages halve the child's error); the dithered
    # butterfly moves it by at most half a side per round
    runs = (
        ("star", lambda: DME.mean_estimation_star(
            xs, y, Cmp.LatticeQ(q=16), R.PRNGKey(seed + 1)), 2 * 2 * y / 15),
        ("tree_m4", lambda: DME.mean_estimation_tree(
            xs, y, m=4, key=R.PRNGKey(seed + 2)), 2 * 2 * y / 63),
        ("butterfly", lambda: DME.butterfly_mean(
            xs, y, Cmp.LatticeQ(q=16), R.PRNGKey(seed + 3)),
         0.51 * 2 * y / 15 * 2),
        ("variance_reduction", lambda: DME.variance_reduction(
            xs, sigma, Cmp.LatticeQ(q=16), R.PRNGKey(seed + 4), alpha=alpha),
         2 * 2 * y_vr / 15),
    )
    full = {}
    for name, fn, lim in runs:
        res, sec = _timed(torch, fn)
        check(tuple(res.est.shape) == (n, d)
              and bool(torch.isfinite(res.est).all()),
              f"{name}: not a finite ({n}, {d}) output")
        check(bool(res.decode_ok), f"{name}: outputs disagree across machines")
        err = max(float((res.est[r].to(torch.float64) - exact).abs().max())
                  for r in range(n))
        check(err <= lim + 1e-5, f"{name}: max |est - exact| = {err} > {lim}")
        full[name] = dict(seconds=sec, max_abs_err=err, limit=lim,
                          bits_per_machine=int(res.bits_per_machine[0]))
        del res
        torch.cuda.empty_cache()
    del xs, exact
    torch.cuda.empty_cache()

    # --- each compressor once at d = 2^24, anchored near its input
    d2 = 1 << 24
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    x = torch.randn(d2, generator=g, device=dev)
    a = x + 0.02 * torch.randn(d2, generator=g, device=dev)
    ctx = Cmp.CompressorCtx(y=y, diag=Rot.rotation_keypair(R.PRNGKey(seed),
                                                           d2, device=dev))
    comps = {}
    for name in Cmp.ALL_COMPRESSORS:
        comp = Cmp.make_compressor(name)
        z, sec = _timed(torch, lambda: comp.roundtrip(x, ctx, R.PRNGKey(seed),
                                                      anchor=a))
        check(tuple(z.shape) == (d2,) and bool(torch.isfinite(z).all()),
              f"compressor {name}: not a finite ({d2},) output")
        wb = comp.wire_bytes(d2)
        check(0 < wb and (name == "fp32" or wb < 4 * d2),
              f"compressor {name}: {wb} wire bytes")
        comps[name] = dict(seconds=sec, wire_bytes=wb,
                           max_abs_err=float((z - x).abs().max()))
        del z
    lq_lim = 2 * y / 15
    check(comps["lq"]["max_abs_err"] < lq_lim,
          f"lq: max |z - x| = {comps['lq']['max_abs_err']} >= s = {lq_lim}")

    # --- Algorithm 5 with y0 ten times too small: it must escalate
    y_true = float(2 * (x - a).abs().max())
    ra, sec = _timed(torch, lambda: ED.robust_agreement(
        x, a, y_true / 10, 16, R.PRNGKey(seed + 6)))
    ra_err = float((ra["z"] - x).abs().max())
    check(ra["ok"] and ra["iters"] >= 2,
          f"robust_agreement: ok={ra['ok']} after {ra['iters']} iterations")
    check(ra_err < y_true, f"robust_agreement: max |z - x_u| = {ra_err}")
    robust = dict(seconds=sec, iters=ra["iters"], bits=ra["bits"],
                  max_abs_err=ra_err, y_true=y_true)
    del x, a, ctx, ra
    torch.cuda.empty_cache()

    # --- card == CPU, bit for bit, at d = 2^18 with 8 machines
    rng = np.random.RandomState(seed)
    small = (rng.randn(1 << 18) * 100
             + 0.05 * rng.randn(8, 1 << 18)).astype(np.float32)
    ys = float(2 * np.abs(small - small.mean(0)).max())
    for name, fn in (
            ("star", lambda X: DME.mean_estimation_star(
                X, ys, Cmp.LatticeQ(q=16), R.PRNGKey(1))),
            ("tree", lambda X: DME.mean_estimation_tree(
                X, ys, m=8, key=R.PRNGKey(2))),
            ("butterfly", lambda X: DME.butterfly_mean(
                X, ys, Cmp.LatticeQ(q=16), R.PRNGKey(3))),
            ("variance_reduction", lambda X: DME.variance_reduction(
                X, 0.05, Cmp.LatticeQ(q=64), R.PRNGKey(4)))):
        on = [fn(torch.from_numpy(small).to(dv)) for dv in (dev, "cpu")]
        check(torch.equal(on[0].est.cpu().view(torch.int32),
                          on[1].est.view(torch.int32))
              and bool(on[0].decode_ok) and bool(on[1].decode_ok),
              f"small {name}: the card's outputs differ from the CPU's")
    phase_s = time.perf_counter() - t_phase
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(not launched, f"the paper-algorithms phase launched {launched}")
    say("paper_algorithms", d=FULL_D, machines=n, y=y, full_width=full,
        compressors_d=d2, compressors=comps, robust_agreement=robust,
        small_card_equals_cpu=True, kernel_launches=0,
        note="launches none of the kernels", seconds=phase_s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    adopt_orphans()
    try:
        return smoke(torch, args.seed)
    finally:
        stop_children()


def smoke(torch, seed: int) -> int:
    """Every phase, then the ``kernels`` line and the last line."""
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    from repro_torch.agg.transport import frame as wire
    from repro_torch.dist.collectives import QSyncConfig
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {}
    for name, report in _build.PTXAS_REPORT.items():
        regs = [int(v) for v in re.findall(r"Used (\d+) registers", report)]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                             report)]
        ptxas[name] = dict(max_registers=max(regs, default=None),
                           spill_store_bytes=sum(spills))
    say("build", seconds=time.perf_counter() - t0, built=built, ptxas=ptxas)
    say("sass", attention=attention_sass(_build), fwht=fwht_sass(_build),
        **lattice_sass(_build))

    spec = wire.RoundSpec(round_id=1, d=FULL_D,
                          cfg=QSyncConfig(q=16, bucket=4096))
    checks = kernel_checks(torch, spec.padded, spec.cfg.bucket, CLIENTS,
                           seed)
    checks.update(shape_kernel_checks(torch, spec.padded, spec.cfg.bucket,
                                      CLIENTS, seed))
    counts = rounds_ab(torch, FULL_D, CLIENTS, seed)
    torch.cuda.empty_cache()
    coll, paths = collectives(seed)
    counts = {k: counts[k] + coll[k] for k in COLLECTIVE_KERNELS}
    train, ranks = train_internvl2(seed)
    counts = {k: counts[k] + train[k] for k in COLLECTIVE_KERNELS}
    # the dry run of the phase's cell traces on the host while the card
    # runs the next phases; it is joined before any host timing
    pool = concurrent.futures.ThreadPoolExecutor(1)
    dry = pool.submit(dryrun_internvl2)
    train_kernel_checks(torch, seed)
    train = train_internvl2_tp(seed)
    counts = {k: counts[k] + train[k] for k in COLLECTIVE_KERNELS}
    dryrun_against_phase(dry.result(), ranks)
    pool.shutdown()
    tp_kernel_checks(torch, seed)
    for phase in (train_granite_moe_tp, train_families, serve_glm4_tp4,
                  serve_granite_moe_tp, serve_families):
        torch.cuda.empty_cache()        # four ranks share the card next
        say("parent_memory", before=phase.__name__,
            allocated_gb=torch.cuda.memory_allocated() / 1e9,
            reserved_gb=torch.cuda.memory_reserved() / 1e9,
            card_free_gb=torch.cuda.mem_get_info()[0] / 1e9)
        got = phase(seed)
        if got is not None:             # the serving phases launch none
            counts = {k: counts[k] + got[k] for k in COLLECTIVE_KERNELS}
    for phase in (agg_service, agg_tree, agg_engine_small):
        got = phase(torch, seed)
        counts = {k: counts[k] + got[k] for k in COLLECTIVE_KERNELS}
    drains = small_rounds(torch, seed)
    # each instance of the new shapes: its kernel's launches on the paths
    # that run that instance
    paths.update({f"drain_q{q}": got for q, got in drains.items()})
    for name, (k, _, tags) in SHAPE_INSTANCES.items():
        counts[name] = sum(paths[t][k] for t in tags)
        check(counts[name] > 0, f"{name} was not launched on its paths "
              f"{tags}")
    host_costs(torch, FULL_D, seed)
    for name, (entry, launches) in attention(torch, seed).items():
        checks[name], counts[name] = entry, launches
    paper_algorithms(torch, seed)

    kernels = []
    for name, (source, replaces) in kernel_sources().items():
        r = checks[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    say("done", seconds=time.perf_counter() - t_start,
        stopped_processes=stop_children())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
