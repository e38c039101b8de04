#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It drives the port's main path — the Explorer on the paper's Fig. 10
image suite (gaussian, harris, camera, laplacian), per-app PE1..PE4,
place-and-route on a 16x16 fabric at the default annealing budget
(16 chains x 32 sweeps), then modulo scheduling and the cycle-accurate
golden check (``simulate=True`` at the default 3 iterations x 2 input
rows) — and holds every kernel on that path against its plain PyTorch
version:

1. require a card; print its name and power limit (``nvidia-smi``);
2. build the kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc``
   (one process per source, all started together) and print each
   kernel's registers and shared memory (``-Xptxas -v``);
3. run the Explorer's front half (mine -> rank -> merge -> map) on the
   card's Explorer, lower every (variant, app) pair, group the pairs by
   bucket signature, and on every signature check the annealing kernel
   (K2: delta, full and telemetry) against its plain version on the card
   (in full depth on the signature with the most steps, on the first
   ``HIER_CHECK_STEPS`` steps on the others: phase 4 holds every
   signature's full-depth run card == CPU) —
   the starting per-net costs its prologue scores (K1's function, which
   has no launch of its own), slots, costs, accept counts and cost curves
   bit-equal — and time K2 and sum it over the signatures (one launch each
   on the main path); then place, route and schedule every
   pair on a copy of the front, group the programs by sim signature, and
   on every one check the cycle stepper (K3, state in shared and in global
   memory) against its plain version on the card, outputs bit-equal; also
   on normal float inputs a bucket of single-op ``mac`` and ``mul``
   programs (``mac`` rounded twice) and the ``mac`` program alone (one
   FMA): ``k3_mac_check``;
4. run the Explorer to the end on the card, traced by ``torch.profiler``
   (CUDA activity), with the launch counters set to 0 just before, read
   them just after, then rerun pnr, schedule and simulate on the CPU over
   the same mined and mapped front (one store, ``forget("pnr", "sched",
   "sim")``) and require identical records, sim buckets and failure rows,
   every simulated pair golden-verified, K2 launched, K3 launched once
   per sim bucket, the trace's launches of both equal to the counters,
   and no launch in the trace of K1 (a kernel whose name holds "hpwl") or
   of another kernel of this repository's sources;
5. time each kernel and its plain version with CUDA events at the main
   path's largest signature (camera on PE1), K2 also a step and with zero
   steps (staging, the prologue that computes K1's function, and writing
   the start out: the kernel alone from the profiler's trace, and with
   its wrapper); K3's launch
   alone (its wrapper's host work apart) also a cycle, with its state in
   global memory, at a larger input batch, and with empty cycles
   (barriers and event walks only: the floor of a cycle, printed beside
   its bytes bound);
6. the fused-PE path: run the Explorer's front half on the paper's
   Fig. 11 ML suite with the benchmark's settings (PE_ML, then per-app
   variants of up to 3 merged subgraphs), and, with the launch counters
   set to 0 just before and read just after, apply every configuration
   of every variant through ``kernel_from_config`` (K4, Triton generated
   per pattern) to float32 operands of shape (4096, 8192) — the MLP
   activation of the Llama 3.2 1B configuration the repository carries
   (d_ff 8192) at 4096 tokens — and run ``matmul_fused`` (K5, CUDA C++)
   at x (4096, 2048) @ w (2048, 8192) with four epilogues: none, the
   Conv tail (bias + ReLU), the Block tail (skip-add + ReLU), and the
   Conv tail stored as bfloat16; hold every result against its plain
   version on the card, K4 also in bfloat16 once per distinct pattern,
   both against the float64 oracles on small inputs, and time K4 at the
   largest and the median distinct pattern and K5 (3xTF32 on wgmma) on
   the first three epilogues and against ``torch.matmul``;
7. the attention and selective-scan boundary at the widths of three
   configurations the repository carries: with the launch counters set to
   0 just before and read just after, ``attention`` (K6) at Llama 3.2 1B
   (32 query heads, 8 kv heads, head dim 64, 4096 tokens, causal; (a) in
   float32, (c) in bfloat16), at a Gemma 2 27B local layer (32 / 16
   heads, head dim 128, 8192 tokens, causal, window 4096, softcap 50,
   scale 1/12; (b)) and non-causal at a ragged 4000 tokens (d), and
   ``selective_scan`` (K7) at falcon-mamba-7b (d_inner 8192, d_state 16,
   4096 tokens) and at a ragged S=100, D=50; hold each result against its
   plain version on the card (K6 in bfloat16 also by its relative error
   norm, over the output and over each row) and K6 in float32 against the
   float64 oracle ``ref_attention`` (on query heads 0-1 for (b)); time
   each kernel, its plain version and, for (a), (c) and (d),
   ``scaled_dot_product_attention`` (with the backend PyTorch picks), and
   print K6's share of its bound, its ratio to that call, and the floor
   its exponentials set;
8. hierarchical placement (``place_hierarchical``) on the locality-4
   synthetic netlists of ``benchmarks/pnr_bench.py`` (``HIER_SIZES``):
   at 64x64 with that bench's budget (2 chains x 2 sweeps) the card's
   ``HierPlacement`` equals the CPU's field by field and delta equals full
   on the card; at 128x128 (8x8 clusters of 16x16) at the default budget
   (16 chains x 32 sweeps), with the launch counter set to 0 just before
   and read just after, the wall of each span (partition, cluster, io,
   detail, deblock) and K2's launches and time per level (each call
   attributed to the ``pnr.hier.*`` span open around it), then K2 held
   to its plain version at every level: the cluster level's launch (full
   scoring in the kernel), the detail level's largest, and the deblock's
   on its first ``HIER_CHECK_STEPS`` steps; flat ``place`` at 64x64
   beside the hierarchical placer at the same budget; and a flat 128x128
   problem on the grouped path (``anneal_jax_batch``, padded to its
   bucket signature), whose chain state exceeds shared memory and lives
   in global memory: timed, and held to the plain version on its first
   ``HIER_CHECK_STEPS`` steps;
9. serving, the second entry point into K2 and K3, and the rest of
   observability: ``analyze_pnr`` of the largest scheduled pair from
   phase 4's card ``PnRResult`` equals the report from the CPU rerun's;
   ``buildprof`` records exactly one compile event and one
   ``kernel-compile`` span for one ``nvcc`` run (mamba_scan.cu into a
   fresh build directory), and (around phase 6) one Triton
   specialisation for each distinct (pattern, dtype) K4 launched; then
   the four overlapping clients of the JAX package's serve smoke (r1
   {camera}, r2 {camera, harris}, r3 {harris, gaussian}, r4 {camera,
   laplacian}) at phase 3's configuration, each solo on the card and
   then all at once through ``repro_torch.serve.ExploreService``, every
   run from a copy of phase 3's mined and mapped front (nothing mined):
   with the launch counters set to 0 just before the served batch and
   read just after, under ``torch.profiler``, every response ``ok``, not
   cached, byte-identical to its solo run and record for record equal
   to phase 4's card records, its failure rows only phase 4's schedule
   rows for its apps, no degraded batch, K2 and K3 launched (as many
   times as the trace shows) and fewer launches and dispatches than the
   solo runs summed; a repeat of r2 under a new id answered from cache
   without a launch in under 1000 ms; r2 and a malformed line over TCP;
   it prints the served wall, the solo walls summed, the launches, the
   cache hit's milliseconds and the device's busy share of the served
   wall, beside the card's name and power limit;
10. LM serving at full width, the LM substrate's entry into K6: Llama
   3.2 1B unreduced (``repro_torch.configs``: 16 layers, d_model 2048,
   32 / 8 heads, head dim 64, d_ff 8192, vocab 128256; random weights
   made on the card from seed 0) served by
   ``repro_torch.serve.lm_engine.ServeEngine`` (bfloat16 compute, 4
   slots, smax 1024) to 8 requests of 512-token prompts with 32 new
   tokens each (two waves of 4); first the model's prefill with K6
   against the same prefill with K6's plain version swapped in
   (``repro_torch.models.transformer.attention`` replaced here, not by a
   switch in the package), by relative error norm of the logits and the
   k/v cache: request 0 in float32 at full width, and every request's
   solo prefill in bfloat16, where a planted fault (the causal mask one
   key too far) must exceed the bound; then (``lm_served_report``, as in
   phases 11 to 13) with K6's and K7's launch counters set to 0 just
   before and read just after, under ``torch.profiler``: one K6 launch a
   self-attention layer a prefill (128), the trace's count equal to the
   counter (the profiler drops device records now and then, so no trace
   may count more launches than the counter, and a trace that counts
   fewer is served and traced again, up to 3 windows, until one holds
   them all), no other kernel of this repository's sources launched, 32
   tokens a request, all below the vocabulary; then an untraced, timed
   run in which every refill's spliced k/v must be bit-equal to that
   request's solo prefill and its first token the solo prefill's
   argmax; the served run's greedy tokens with the plain version; the
   attn-mixer architectures (MoE included) at ``.reduced()`` in float32,
   forward, prefill and 4 decode steps on the card == the port's CPU run
   (``card_vs_cpu`` of ``tests/test_torch_lm_gpu.py``);
   ``python -m repro_torch.launch.serve`` at its defaults; and K6 alone
   at the served shape (1, 32 / 8, 512, 64, bfloat16, causal) beside its
   bound and ``scaled_dot_product_attention``.
   It prints prefill ms a request, decode ms a step, tokens/s, the
   device's busy share of the traced served wall and the peak device
   memory, beside the card's name and power limit;
11. Mamba serving at full width, the LM substrate's entry into K7:
   falcon-mamba-7b unreduced (``repro_torch.configs``: 64 layers,
   d_model 4096, d_inner 8192, d_state 16, d_conv 4, dt_rank 256, vocab
   65024, tied embeddings; random weights made on the card from seed 0)
   served by ``ServeEngine`` (bfloat16 compute, 4 slots) to 8 requests
   with prompts of 512, 509, 384 and 257 tokens twice (the Mamba mixer
   reads no position, so mixed lengths are served right) and 32 new
   tokens each; first every request's solo prefill, K7 against the same
   prefill with K7's plain version swapped in
   (``repro_torch.models.ssm.mamba_scan`` replaced here, not by a switch
   in the package) by relative error norm of the logits, ``ssm_h`` and
   ``ssm_conv`` (a planted fault, each y_t read from h_(t-1), must exceed
   the bound), and request 0 in float32 at full width; then, with the
   launch counters set to 0 just before and read just after, under
   ``torch.profiler``: one K7 launch a mixer layer a prefill (512), the
   trace's count equal to the counter, no K6 and no other kernel of this
   repository's sources; then a timed run in which every refill's
   spliced ``ssm_h`` and ``ssm_conv`` must be bit-equal to that request's
   solo prefill and its first token the solo prefill's argmax; the two
   Mamba architectures (falcon-mamba-7b, hymba-1.5b) at ``.reduced()``
   card == CPU (``card_vs_cpu``, K7 and K6 counted); K7 alone at the
   served shape (1, 512, 8192, 16) float32 with its final state, beside
   its bound; and the perf flag ``ssm_impl="streamed"``: one 4096-token
   prefill with K7 on chunks of 256 steps, the state carried, against
   the materialized scan within the bfloat16 bound, K7 16 x 64 = 1024
   times, counted and in the trace, its peak device memory beside the
   materialized one's.  It prints the same serving numbers as phase 10;
12. MoE serving at full width, the MoE MLP (``repro_torch.models.moe``)
   on the serving path: qwen2-moe-a2.7b unreduced (24 layers, d_model
   2048, 16 / 16 heads of 128, 60 experts padded to 64, top-4, d_expert
   1408, 4 shared experts of 5632 in all, vocab 151936, untied head;
   random weights made in bfloat16 on the card from seed 0: a float32
   master and its bfloat16 copy would not fit) served by ``ServeEngine``
   as phase 10 serves (4 slots, 8 requests of 512-token prompts, 32 new
   tokens, smax 1024); every request's solo prefill with K6 against the
   same prefill with K6's plain version (and the planted fault) by
   relative error norm of the logits and the k/v cache, the (token,
   choice) entries the MoE layers drop counted (there must be some);
   every refill's spliced k/v bit-equal to the solo prefill and its first
   token the solo prefill's argmax; with the launch counters set to 0
   just before and read just after, under ``torch.profiler``: one K6
   launch a layer a prefill (192), the trace's count equal, no K7 and no
   other kernel of this repository's sources; one MoE layer at full
   width in float32, card against CPU (``moe_layer_card_vs_cpu`` of
   ``tests/test_torch_lm_gpu.py``: expert ids equal but at near ties,
   drops equal, relative error norm at most 1e-4); K6 alone at the served
   shape (1, 16 / 16, 512, 128) bfloat16 beside its bound and SDPA.  It
   prints the serving numbers of phase 10;
13. hybrid serving at full width: hymba-1.5b unreduced (32 layers,
   d_model 1600, 25 / 5 heads of 64, d_inner 3200, d_state 16, window
   1024, global layers 0, 15 and 31; random weights made on the card from
   seed 0) served by ``ServeEngine`` (4 slots, 8 requests of 1536-token
   prompts, longer than the window, so the window cuts keys in the 29
   local layers in K6's prefill and in decode; 32 new tokens, smax 2048);
   every request's solo prefill with K6 and with K7 each against the same
   prefill with its plain version swapped in (and its planted fault), by
   relative error norm of the logits and every cache leaf, in bfloat16,
   and request 0 in float32 at full width; every refill's spliced k, v,
   ``ssm_conv`` and ``ssm_h`` bit-equal to the solo prefill; one K6 and
   one K7 launch a layer a prefill (256 each), the trace's counts equal,
   no other kernel of this repository's sources; K6 alone at the served
   shape (1, 25 / 5, 1536, 64) bfloat16 with the window beside its bound
   and SDPA (with the window as a mask), and K7 alone at (1, 1536, 3200,
   16) float32 with its final state beside its bound;
14. the LM idiom graphs on K4: the four graphs of ``repro_torch.apps.lm``
   (dense, Gemma, MoE router, SSM update) traced with the port's
   ``trace_fn`` on tensors on the card, each equal to the CPU trace by
   ``canonical_label``; mined with ``tests/test_lm_idioms.py``'s settings
   and no time budget; with the launch counter set to 0 just before and
   read just after, the first five PE-compatible ranked patterns of each
   applied through ``fused_pe_apply`` (K4) to float32 operands of shape
   (4096, 8192), each mined constant valued as at the pattern's first
   occurrence in its graph, one launch each, every result finite
   everywhere and held to its plain version and, on (64, 128), to the
   float64 oracle; K4 timed at the largest;
15. training at full width: Llama 3.2 1B unreduced (1.236 B float32
   master parameters made on the card from seed 0, bfloat16 compute and
   moments, batches of 8 x 512 ``SyntheticLM`` tokens, the launcher's
   AdamW): (a) one train step with K6 against the same step with K6's
   plain version swapped in, the loss and every leaf's gradient by
   relative error norm within 2^-4 and no gradient zero where the plain
   one is not; a planted fault (K6 launched with no autograd Function)
   must fail that check; (b) the ten configurations at ``.reduced()`` in
   float32, one train step card against CPU (``train_card_vs_cpu`` of
   ``tests/test_torch_lm_gpu.py``: loss, gradient norm, every gradient,
   updated leaf and moment within 1e-4, each leaf's update and second
   moment by relative error norm, K6 and K7 counted); (c) the
   step's ms, tokens/s, peak device memory and the device's busy share
   over 3 steps under ``torch.profiler``, K6 16 a step in the counter,
   all of them in the forward, and in the trace (3 windows: the profiler
   loses device records now and then, so no window holds more K6 events
   than were counted and one holds them all; the busy share from the
   window with the most events); K6 at the training shape
   beside its bound, its plain version and SDPA, and the plain backward
   of K6 and of K7 (at falcon-mamba's served shape) timed; then the
   launcher's ``run`` (what ``python -m repro_torch.launch.train`` runs)
   for 10 steps at full width in the process, 160 K6 launches, and a
   checkpoint of its state (14.8 GB) written and restored, each timed,
   compared bit for bit on a few leaves, its size and the free disk
   printed; (d) the trainer's fault injection on the card at the JAX
   test's dims (1 restart, step 20, latest checkpoint 20); (e) the perf
   flags: the step with ``ce_impl="chunked"`` (4 chunks of 128) against
   the default step, loss and every gradient within 2^-4, K6 16 times,
   ms a step in turns and each step's peak memory, and a forward with
   ``norm_dtype="bf16"`` within 2^-4 of the default one;
16. the distribution layer (``repro_torch.sharding``,
   ``moe_mlp_shardmap``) over a one-rank NCCL group made from a
   ``FileStore`` and destroyed at the phase's end: (a) phase 15's
   unreduced Llama 3.2 1B step with ``grad_transform`` the int8
   all-reduce, every stacked leaf's gradient bit-equal to the plain
   quantize -> dequantize, the updated leaves bit-equal to the same step
   handed those gradients, K6 16 times; its ms against the step without
   it (in turns), the transform's ms and the bytes handed to its
   all-reduces (int32 sums: 4 bytes an element); (b) 4 processes sharing
   the card over gloo, each with one decoder layer's gradient tree from
   its own seed: the compressed all-reduce bit-equal on every rank and to
   a numpy emulation of the JAX arithmetic; (c) the error of (a) within
   half a step of its block's scale; (d) ``moe_mlp_shardmap`` at
   qwen2-moe-a2.7b's width (512 tokens as 4 rows of 128) on the one rank
   in float32 against the port's CPU run within 1e-4, on the 4 processes
   (16 experts each) against the one rank by relative error norm within
   1e-5, timed against ``moe_mlp`` in bfloat16, the entries each
   capacity rule drops; (e) ``gpipe`` with Llama 3.2 1B's 16 layers as
   one stage on 4 microbatches of (2, 512), bit-equal to the model's own
   layer loop, 64 K6 launches counted and in the trace; then over a new
   one-rank group and a (1, 1) ``DeviceMesh``: (f) ``moe_impl=
   "shard_map"`` makes the model's MLP call ``moe_mlp_shardmap``,
   bit-equal to (d)'s direct call, and (g) Llama 3.2 1B's forward with
   ``DTensor`` params and ``activation_shard_fn``'s callback is bit-equal
   to the plain forward, K6 16 times;
17. the roofline: phase 15's train step counted on meta tensors by
   ``repro_torch.launch.hlo_cost`` (FLOPs, bytes, 6·N·D, useful ratio),
   its compute, memory and bound terms at the H100's data-sheet peaks
   beside phase 15's measured ms a step and its MFU; one single-pod
   ``launch.dryrun.lower_cell`` (llama3.2-1b, train_4k), timed, and
   every single-pod cell of falcon-mamba-7b and hymba-1.5b but hymba's
   long_500k (their conv a shard a rank, ``kernels.sharded.conv_dtensor``),
   each required ok;
18. the JAX package's remaining kernel entry points, their counters set
   to 0 just before one traced call each and read just after:
   ``hpwl_pallas`` and ``hpwl_batched`` (pnr_bench's 256 harris
   placements) one zero-step K2 each, ``hpwl_delta_pallas`` one
   ``swap_delta_kernel``, ``alu_step_pallas`` one ``alu_step_kernel``
   (256 x 4,096 lanes, the whole op table), counters == trace, each
   result == its plain version (bit for bit; the transcendentals within
   2 ulp), the ALU step again under the table without ``mul`` (``mac``
   one FMA there, rounded twice under the whole table); each timed beside
   its plain version and bound, ``hpwl_batched``
   also the kernel alone and its wrapper's pin-table sort;
19. print every phase's wall, then one JSON line ``{"kernels": [...]}`` with launches, max |diff|,
   times and bounds of K1-K7 (K1's row: its launches counted in the
   main path's trace, its ``ms`` K2 with zero steps, the kernel alone,
   against the bound of that launch's bytes, its ``timed`` key says so;
   K3's ``ms`` its launch alone, its
   ``wrapper_ms`` with the wrapper's host work, as the main path pays
   it; K2's and K3's ``serve_launches`` their launches in the served
   batch; K6's ``lm_launches`` its launches in phase 10's served run,
   ``lm_ms`` / ``lm_library_ms`` its and SDPA's time a call at the served
   shape by CUDA events with the calls queued behind a sleep (the
   device's pace), ``lm_call_ms`` / ``lm_library_call_ms`` the same
   issued back to back (the host's pace), ``lm_served_ms`` its device
   time a launch in the served run's trace, ``lm_bound_ms`` the bound at
   that shape; K7's ``lm_*`` keys the same from phase 11, without a
   library call; K6's ``moe_*`` keys the same from phase 12, and K6's and
   K7's ``hymba_*`` keys from phase 13; K4's ``idiom_*`` keys from
   phase 14: launches on the LM idioms, time at the largest; K6's
   ``train_*`` keys from phase 15: launches in the launcher's 10 steps,
   time at the training shape (8, 32/8, 512, 64) with its plain version,
   bound and SDPA, its plain backward a layer, the step's ms; K7's
   ``train_*``: launches in the reduced Mamba steps, its plain backward;
   K6's ``dist_train_launches``, ``dist_gpipe_launches`` and
   ``dist_shard_launches`` its launches in phase 16 (a), (e) and (g),
   ``ce_chunked_launches`` in phase 15 (e)'s chunked step; K7's
   ``stream_launches`` in phase 11's streamed prefill; a row for each
   entry point of phase 18, its launches there, ``ms`` with its wrapper,
   ``hpwl_batched``'s ``kernel_ms`` and ``pin_table_ms``), then ``{"ok":
   true, "device": {...}}`` as the last line.

Any failure exits nonzero; no phase catches an error and carries on
(phase 6 counts the configurations the port refuses with the reference's
``ValueError`` and prints them).
Bounds: bytes over 3.35 TB/s and operations over 67 TFLOP/s (float32
outside the tensor cores), the H100 SXM's published peaks at 700 W; on
the tensor cores, the function's own operations at their rate for the
operands' type: K5 2MNK at 495 TFLOP/s (TF32), K6 4·D a pair inside the
masks at 495 TFLOP/s for float32 and 989 TFLOP/s for bfloat16 (the three
TF32 products 3xTF32 does for each are printed apart, as the share of the
kernel's time they would take at that rate).  The run fails if K5 is not
faster than ``torch.matmul`` or a kernel reads below its bound.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
#: special-function results (expf's ex2) a second: 16 a clock an SM (the
#: CUDA C++ Programming Guide's throughput table, compute capability 9.0)
#: on 132 SMs at the 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
CSRC = "src/repro_torch/kernels/csrc/"
#: the larger input batch K3 is also timed at (sim_batch x sim_iterations)
BIG_BATCH, BIG_ITERS = 256, 16
#: phase 6 widths: Llama 3.2 1B (src/repro/configs/llama3_2_1b.py) d_model
#: and d_ff, at 4096 tokens
TOKENS, D_MODEL, D_FF = 4096, 2048, 8192
K4_TOL, K4_BF16_TOL, K5_TOL = 1e-5, 5e-2, 1e-4
#: phase 7: (B, Hq, Hkv, D, S, options, dtype) of each K6 case —
#: (a) src/repro/configs/llama3_2_1b.py (32 heads, kv 8, head_dim 64) at
#: 4096 tokens, (b) a local layer of src/repro/configs/gemma2_27b.py
#: (32 heads, kv 16, head_dim 128, window 4096, softcap 50, scale 1/12)
#: at its max_seq_len 8192, (c) = (a) in bfloat16, (d) non-causal at a
#: sequence length that is not a multiple of the tile
K6_CASES = {
    "a": (1, 32, 8, 64, 4096, dict(causal=True), "float32"),
    "b": (1, 32, 16, 128, 8192, dict(causal=True, window=4096, softcap=50.0,
                                     scale=1.0 / 12), "float32"),
    "c": (1, 32, 8, 64, 4096, dict(causal=True), "bfloat16"),
    "d": (1, 8, 2, 64, 4000, dict(causal=False), "float32"),
}
#: K7 at src/repro/configs/falcon_mamba_7b.py (d_model 4096, expand 2,
#: d_state 16) at 4096 tokens, and a ragged (S, D)
K7_SHAPE, K7_RAGGED = (1, 4096, 8192, 16), (1, 100, 50, 16)
K6_TOL, K6_BF16_TOL, K7_TOL = 2e-5, 5e-2, 1e-4
#: K6 in bfloat16 (c) is also held, against its plain version, to
#: ||got - want|| / ||want|| over the whole output and over each row of
#: head_dim values.  Rounding P and the output to bfloat16 (2^-9 relative
#: each) gives a sound kernel about 2^-9 over the output and at most
#: 0.006 on a row (H100: case (c) and the gpu tests' bfloat16 cases); an
#: output 1% low fails the first limit, a kv tile's P V dropped or an
#: unrescaled accumulator both
K6_BF16_REL, K6_BF16_ROW = 2.0 ** -8, 2.0 ** -6
#: phase 8: benchmarks/pnr_bench.py HIER_SIZES, HIER_LOCALITY and the
#: seed of its hier_sweep (the netlist's; the placer's is seed + 1)
HIER_SIZES, HIER_LOCALITY, HIER_SEED = (64, 128), 4, 4
#: the steps of the 128x128 deblock's chains (of 65536) and of the grouped
#: flat 128x128 bucket's (of 524288) held to the plain version, which
#: takes about a millisecond a step
HIER_CHECK_STEPS = 4096
#: K2's per-step inputs (R, S) or (P, S), cut to a prefix of steps
STREAMS = ("a", "t", "log_u", "temps", "active")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


_T0 = time.perf_counter()
#: (name, start in seconds from _T0) of every phase begun so far
_PHASES = []


def phase(name: str) -> None:
    _PHASES.append((name, time.perf_counter() - _T0))
    print(f"== {name} (at {_PHASES[-1][1]:.1f} s)", flush=True)


def phase_walls() -> str:
    """Each phase's wall so far (to the next phase's start, the last one's
    to now), in seconds."""
    ends = [t for _, t in _PHASES[1:]] + [time.perf_counter() - _T0]
    return ", ".join(f"{name.split()[0]}: {end - start:.1f}"
                     for (name, start), end in zip(_PHASES, ends))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def queued_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds of ``fn()`` on the device: the calls are queued
    behind a sleep kernel (about 50 ms), so the events time the device
    running them back to back, not the host issuing them."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def free_device_memory() -> None:
    """Frees what the last phase's models held on the card: an engine
    whose refill is checked (``lm_splice_checked``) refers to itself, so
    only the garbage collector frees it and the weights it holds."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def same_bits(a, b) -> bool:
    """float32 tensors equal bit for bit (every NaN equal to every NaN)."""
    import torch
    eq = (a.view(torch.int32) == b.view(torch.int32)) \
        | (torch.isnan(a) & torch.isnan(b))
    return bool(eq.all())


def equal_bits(a, b) -> bool:
    """Two tensors of one dtype and shape equal bit for bit."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        width = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(width), b.view(width)
    return torch.equal(a, b)


#: empty kernels launched at the start of every traced window: the
#: profiler drops the first device records of a window, more the older
#: the process (tools/trace_loss.py: 7 at 127 s, 59 at 762 s; a whole
#: run lost phase 16 (e)'s first K6 launch, its 49th record, in 3 of 3
#: windows)
TRACE_PREAMBLE = 3000


def device_kernels(run):
    """``run()`` under ``torch.profiler`` (CUDA activity): its result, the
    device kernels it launched, ``{name: [milliseconds of each launch]}``
    (copies and memsets included under their own names), and the
    milliseconds in which the device ran at least one of them (the union
    of their intervals: its busy time).

    The window opens with ``TRACE_PREAMBLE`` empty spin kernels, left out
    of what is returned: the records the profiler drops at a window's
    start are theirs, not ``run()``'s.  A window that keeps none of them
    may have lost ``run()``'s, and fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PREAMBLE):
            torch.cuda._sleep(0)
        out = run()
        torch.cuda.synchronize()
    # the raw device events: building the profiler's FunctionEvent tree
    # takes minutes over a served run's 500,000 launches
    kern, spans, preamble = {}, [], 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if "spin_kernel" in ev.name():
                preamble += 1
                continue
            t0 = ev.start_ns()
            t1 = t0 + ev.duration_ns()
            kern.setdefault(ev.name(), []).append((t1 - t0) / 1e6)
            spans.append((t0, t1))
    if not preamble:
        fail(f"a traced window kept none of its {TRACE_PREAMBLE} preamble "
             f"records: the profiler may have dropped the run's own")
    busy_ns, end = 0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_ns += t1 - max(t0, end)
            end = t1
    return out, kern, busy_ns / 1e6


def launches_of(kern: dict, name: str) -> int:
    """Launches of the kernels in a :func:`device_kernels` trace whose
    name holds ``name`` as a word."""
    pat = re.compile(rf"\b{name}\b")
    return sum(len(v) for k, v in kern.items() if pat.search(k))


def source_kernels() -> list:
    """Names of the ``__global__`` functions in the port's CUDA sources."""
    names = set()
    for f in sorted(os.listdir(os.path.join(ROOT, CSRC))):
        if f.endswith(".cu"):
            with open(os.path.join(ROOT, CSRC, f)) as fh:
                names.update(re.findall(
                    r"__global__[^{;]*?\b(\w+_kernel)\s*\(", fh.read()))
    return sorted(names)


def record_k2_calls(run):
    """``run()`` with tracing on and every ``fabric.place.run_chains`` call
    (K2's one launch on the placement paths) recorded as ``(level,
    inputs, full, wall_s)``: ``level`` is the innermost open
    ``pnr.hier.*`` span without its prefix (cluster, detail, deblock), or
    "flat" outside them.  Returns (run's result, the calls, the
    tracer)."""
    import torch
    from repro_torch.obs import disable_tracing, enable_tracing
    place_mod = sys.modules["repro_torch.fabric.place"]
    orig = place_mod.run_chains
    calls = []
    tracer = enable_tracing()

    def run_chains(inputs, device, *, full=False, telemetry=False):
        level = next((n[len("pnr.hier."):]
                      for n in reversed(tracer.open_spans())
                      if n.startswith("pnr.hier.")), "flat")
        sync = torch.device(device).type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(inputs, device, full=full, telemetry=telemetry)
        if sync:
            torch.cuda.synchronize()
        calls.append((level, inputs, full, time.perf_counter() - t))
        return out

    place_mod.run_chains = run_chains
    try:
        out = run()
    finally:
        disable_tracing()
        place_mod.run_chains = orig
    return out, calls, tracer


def k2_per_level(calls, dev) -> dict:
    """Each recorded K2 call (:func:`record_k2_calls`) launched again on
    the card and timed alone (CUDA events), summed by level: launches,
    ms, the calls' walls with their inputs' copies, and each launch's
    shape and layout (:func:`pnr_cost.anneal_layout`)."""
    from repro_torch.fabric.place import KERNEL_INPUTS
    from repro_torch.kernels import pnr_cost
    per_level = {}
    for lv, inputs, full, call_wall in calls:
        d = {k: v.to(dev) for k, v in inputs.items()}
        args = [d[k] for k in KERNEL_INPUTS]
        fix = d.get("net_fix")
        ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args, fix, full=full),
                     1)
        row = per_level.setdefault(lv, {"launches": 0, "ms": 0.0,
                                        "call_wall_s": 0.0, "shapes": []})
        row["launches"] += 1
        row["ms"] += ms
        row["call_wall_s"] += call_wall
        r_, s_ = d["a"].shape
        p_, n_, d_ = d["net_pins"].shape
        e_, k_ = d["ent_nets"].shape[1:]
        _, stage, chain, smem = pnr_cost.anneal_layout(n_, d_, e_, k_,
                                                       fix is not None)
        row["shapes"].append(
            f"R={r_} S={s_} P={p_} N={n_} D={d_} E={e_} K={k_}"
            + (" boxes" if fix is not None else "")
            + (" full scoring" if full or 2 * k_ > pnr_cost._MAX_TOUCHED
               else "")
            + f" (tables {'staged' if stage else 'global'}, chain "
            f"{'shared' if chain else 'global'}, {smem} B shared a block; "
            f"{ms:.4f} ms)")
    return per_level


def k2_vs_plain(d: dict, what: str, steps=None) -> tuple:
    """K2 on the kernel inputs ``d`` (on the card) against its plain
    version in delta, full and telemetry mode: the starting costs its
    prologue writes (``pnc0_out``; the plain version's are
    ``net_hpwl_rows_plain``'s), slots, costs, accepts and curves
    bit-equal, or the run fails.  With ``steps``, both run the first
    ``steps`` steps of every chain only.  Returns the largest |difference|
    of the starting costs and of the other float outputs (0, 0)."""
    import torch
    from repro_torch.fabric.place import KERNEL_INPUTS
    from repro_torch.kernels import pnr_cost
    if steps is not None:
        d = {k: (v[:, :steps].contiguous() if k in STREAMS else v)
             for k, v in d.items()}
    args = [d[k] for k in KERNEL_INPUTS] + [d.get("net_fix")]
    err = {"pnc0": 0.0, "out": 0.0}
    for full, tele in ((False, False), (True, False), (False, True)):
        got0 = torch.full((d["a"].shape[0], d["net_pins"].shape[1]), -1.0,
                          device=d["a"].device)
        want0 = torch.full_like(got0, -2.0)
        got = pnr_cost.anneal_chains(*args, full=full, telemetry=tele,
                                     pnc0_out=got0)
        want = pnr_cost.anneal_chains_plain(*args, full=full, telemetry=tele,
                                            pnc0_out=want0)
        torch.cuda.synchronize()
        for name, g, w in zip(("pnc0", "best_slot", "best", "accepts",
                               "curve"), (got0,) + got, (want0,) + want):
            if (g is None) != (w is None) or (g is not None
                                              and not torch.equal(g, w)):
                fail(f"K2 (full={full}, telemetry={tele}) {name} differs "
                     f"from its plain version: {what}")
            if g is not None and g.dtype == torch.float32:
                key = "pnc0" if name == "pnc0" else "out"
                err[key] = max(err[key], float((g - w).abs().max()))
    return err["pnc0"], err["out"]


def rel_norms(got, want) -> tuple:
    """||got - want|| / ||want|| over the whole tensor, and its largest
    value over the rows of the last axis."""
    d, w = got.double() - want.double(), want.double()
    return (float(d.norm() / w.norm()),
            float((d.norm(dim=-1) / w.norm(dim=-1)).max()))


def k6_bf16_check(name: str, got, want) -> tuple:
    """Fails unless K6's bfloat16 output is within :data:`K6_BF16_REL`
    of ``want`` over the whole tensor and :data:`K6_BF16_ROW` on every
    row (both relative error norms); returns the two readings."""
    rel, row = rel_norms(got, want)
    if not (rel <= K6_BF16_REL and row <= K6_BF16_ROW):
        fail(f"{name}: relative error norm {rel} (limit {K6_BF16_REL}), "
             f"largest over the rows {row} (limit {K6_BF16_ROW})")
    return rel, row


def attention_scan_phase(dev, launches: dict) -> dict:
    """Phase 7: K6 and K7 at model widths through ``attention`` and
    ``selective_scan``, counted, checked and timed; sets ``launches["k6"]``
    and ``launches["k7"]`` and returns the numbers of the kernels line."""
    import torch
    from repro_torch.kernels import (attention, flash_attention, mamba_scan,
                                     selective_scan)
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    from repro_torch.kernels.ref import ref_attention, ref_mamba_scan

    phase("7 attention (K6) and selective scan (K7) at model widths")
    gen7 = torch.Generator(device=dev).manual_seed(16)
    k6_in = {}
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        if case == "c":                     # (a)'s inputs, rounded
            k6_in[case] = [t.to(torch.bfloat16) for t in k6_in["a"]]
            continue
        k6_in[case] = [torch.randn((b_, h, s_, hd), generator=gen7,
                                   device=dev) for h in (hq, hkv, hkv)]

    def scan_inputs(shape):
        # tests/test_kernels.py: a ~ U(0.6, 0.999), bx ~ N(0, 0.1^2),
        # c ~ N(0, 1)
        b_, s_, d_, n_ = shape
        a = torch.rand(shape, generator=gen7, device=dev) * 0.399 + 0.6
        bx = torch.randn(shape, generator=gen7, device=dev) * 0.1
        c = torch.randn((b_, s_, n_), generator=gen7, device=dev)
        return a, bx, c

    k7_in = scan_inputs(K7_SHAPE)
    k7r_in = scan_inputs(K7_RAGGED)
    torch.cuda.synchronize()
    flash_attention.launches = 0
    mamba_scan.launches = 0
    k6_out = {case: attention(*k6_in[case], **K6_CASES[case][5])
              for case in K6_CASES}
    k7_out = selective_scan(*k7_in)
    k7r_out = selective_scan(*k7r_in)
    torch.cuda.synchronize()
    launches["k6"] = flash_attention.launches
    launches["k7"] = mamba_scan.launches
    print(f"launches {{'k6': {launches['k6']}, 'k7': {launches['k7']}}}",
          flush=True)
    if launches["k6"] != len(K6_CASES) or launches["k7"] != 2:
        fail(f"K6 launched {launches['k6']} times for {len(K6_CASES)} "
             f"cases, K7 {launches['k7']} times for 2")

    def check(name, got, want, tol):
        """max |got - want|; fails unless |got - want| <= tol * (1 +
        |want|) everywhere and got is finite."""
        d = (got.double() - want.double()).abs()
        ok = bool((d <= tol * (1 + want.double().abs())).all()) \
            and bool(torch.isfinite(got).all())
        err = float(d.max())
        if not ok:
            fail(f"{name}: max |diff| {err} above {tol}")
        return err

    k6_err = 0.0
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        q, k, v = k6_in[case]
        got = k6_out[case]
        if got.shape != q.shape or got.dtype != getattr(torch, dt):
            fail(f"K6 ({case}) returned {got.dtype} {tuple(got.shape)}")
        tol = K6_BF16_TOL if dt == "bfloat16" else K6_TOL
        plain = attention_plain(q, k, v, **kw)
        err = check(f"K6 ({case}) vs its plain version", got, plain, tol)
        if dt == "float32":
            k6_err = max(k6_err, err)
        else:
            rel, row = k6_bf16_check(f"K6 ({case}) vs its plain version",
                                     got, plain)
            print(f"K6 ({case}): relative error norm {rel} (limit "
                  f"{K6_BF16_REL}), largest over the rows {row} (limit "
                  f"{K6_BF16_ROW})", flush=True)
        # the float64 oracle: every head, one kv head at a time; for (b)
        # (S x S in float64 at 8192 tokens) query heads 0-1 only
        group = hq // hkv
        kv_heads = range(1) if case == "b" else range(hkv)
        oracle_err = 0.0
        if dt == "float32":
            for g in kv_heads:
                hs = slice(g * group, (g + 1) * group)
                want = ref_attention(q[:, hs].double(),
                                     k[:, g:g + 1].double(),
                                     v[:, g:g + 1].double(), **kw)
                oracle_err = max(oracle_err, check(
                    f"K6 ({case}) vs the float64 oracle", got[:, hs], want,
                    K6_TOL))
        print(f"K6 ({case}) B={b_} Hq={hq} Hkv={hkv} D={hd} S={s_} {kw} "
              f"{dt}: == plain at {tol} (max |diff| {err}); float64 oracle "
              f"max |diff| {oracle_err if dt == 'float32' else 'n/a'} on "
              f"{len(kv_heads) * group if dt == 'float32' else 0} heads",
              flush=True)
    k7_err = check("K7 vs its plain version", k7_out,
                   mamba_scan_plain(*k7_in), K7_TOL)
    k7r_err = check("K7 (ragged) vs its plain version", k7r_out,
                    mamba_scan_plain(*k7r_in), K7_TOL)
    check("K7 (ragged) vs the float64 oracle", k7r_out,
          ref_mamba_scan(*[t.double() for t in k7r_in]), K7_TOL)
    if k7_out.shape != K7_SHAPE[:3] or k7_out.dtype != torch.float32:
        fail(f"K7 returned {k7_out.dtype} {tuple(k7_out.shape)}")
    print(f"K7 at {K7_SHAPE}: == plain at {K7_TOL} (max |diff| {k7_err}); "
          f"at {K7_RAGGED}: == plain (max |diff| {k7r_err}) and the float64 "
          f"oracle", flush=True)

    # times, bounds and the one-call yardstick
    def attn_pairs(s_, causal, window):
        """(q, k) pairs inside the masks: the work this run's data needs."""
        qp = torch.arange(s_, dtype=torch.int64)
        hi = qp if causal else torch.full_like(qp, s_ - 1)
        lo = (qp - window + 1).clamp(min=0) if window > 0 \
            else torch.zeros_like(qp)
        return int((hi - lo + 1).clamp(min=0).sum())

    from torch.nn.functional import scaled_dot_product_attention

    def sdpa_backend(q, k, v, **kw):
        """The backend PyTorch's dispatcher picks for these inputs."""
        if not hasattr(torch, "_fused_sdp_choice"):
            return "unknown (no torch._fused_sdp_choice)"
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name

    k6_rows, lib_err, lib_backend = {}, {}, {}
    for case, (b_, hq, hkv, hd, s_, kw, dt) in K6_CASES.items():
        q, k, v = k6_in[case]
        reps = 3 if case == "b" else 10
        ms = cuda_ms(lambda: attention(q, k, v, **kw), reps)
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, **kw), 2)
        lib_ms = None
        if case != "b":         # no one call computes (b)'s softcap
            sdpa = dict(is_causal=kw["causal"], enable_gqa=True)
            lib_ms = cuda_ms(lambda: scaled_dot_product_attention(
                q, k, v, **sdpa), reps)
            lib_err[case] = float((scaled_dot_product_attention(
                q, k, v, **sdpa).float() - k6_out[case].float()).abs().max())
            lib_backend[case] = sdpa_backend(q, k, v, **sdpa)
        pairs = b_ * hq * attn_pairs(s_, kw["causal"], kw.get("window", 0))
        ops = 4 * hd * pairs
        byts = nbytes(q, k, v, k6_out[case])
        peak = BF16_OPS_PER_S if dt == "bfloat16" else TF32_OPS_PER_S
        k6_rows[case] = (ms, plain_ms, lib_ms, byts, ops, peak, pairs)
        print(f"K6 ({case}): {ms:.4f} ms ({ops / ms / 1e9:.2f} TFLOP/s over "
              f"{pairs} unmasked pairs), plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
              f"{byts} bytes, {ops} operations", flush=True)
    for case in lib_err:
        print(f"scaled_dot_product_attention ({case}): backend "
              f"{lib_backend[case]}, max |diff| from K6 {lib_err[case]}")
    k7_ms = cuda_ms(lambda: selective_scan(*k7_in), 10)
    k7_plain = cuda_ms(lambda: mamba_scan_plain(*k7_in), 1)
    k7_bytes = nbytes(*k7_in, k7_out)
    k7_ops = 4 * k7_in[0].numel()       # a*h, + bx, * c, + into y per state
    print(f"K7 at {K7_SHAPE}: {k7_ms:.4f} ms "
          f"({k7_bytes / k7_ms / 1e9:.3f} TB/s), plain {k7_plain:.4f} ms, "
          f"library none; {k7_bytes} bytes, {k7_ops} operations", flush=True)
    return {"k6_rows": k6_rows, "k6_err": k6_err, "k7_ms": k7_ms,
            "k7_plain": k7_plain, "k7_bytes": k7_bytes, "k7_ops": k7_ops,
            "k7_err": k7_err, "sdpa_backend": lib_backend}



def hier_fields_differ(a, b) -> list:
    """The fields of two ``HierPlacement`` s that differ: every level's
    winning slots, the level costs, the final coordinates and cost."""
    import numpy as np
    bad = []
    if not np.array_equal(a.cluster_slots, b.cluster_slots):
        bad.append("cluster_slots")
    if a.detail_slots.keys() != b.detail_slots.keys() or not all(
            np.array_equal(a.detail_slots[k], b.detail_slots[k])
            for k in a.detail_slots):
        bad.append("detail_slots")
    if (a.deblock_slots is None) != (b.deblock_slots is None) or (
            a.deblock_slots is not None
            and not np.array_equal(a.deblock_slots, b.deblock_slots)):
        bad.append("deblock_slots")
    return bad + [f for f in ("level_costs", "coords", "cost")
                  if getattr(a, f) != getattr(b, f)]


def hier_phase(dev) -> dict:
    """Phase 8: ``place_hierarchical`` on the card at 64x64 (== the CPU,
    delta == full) and 128x128 (span walls, K2 per level, K2 with fixed
    boxes == plain at every level), flat ``place`` at 64x64 beside it, and
    a flat 128x128 problem on the grouped path (K2 with its chain's state
    in global memory, == plain)."""
    import torch
    from repro_torch.fabric import (FabricSpec, anneal_jax_batch,
                                    batch_signature, lower, place,
                                    place_hierarchical, synthetic_netlist)
    from repro_torch.fabric.place import KERNEL_INPUTS
    from repro_torch.kernels import pnr_cost

    phase("8 hierarchical placement at mega-fabric size")
    nets = {}
    for size in HIER_SIZES:
        spec = FabricSpec(rows=size, cols=size)
        nets[size] = (spec, synthetic_netlist(spec, seed=HIER_SEED,
                                              locality=HIER_LOCALITY))
    small, big = HIER_SIZES
    spec, nl = nets[small]
    kw = dict(chains=2, sweeps=2, seed=HIER_SEED + 1)
    t0 = time.perf_counter()
    card = {m: place_hierarchical(nl, spec, score_mode=m, device="cuda",
                                  **kw) for m in ("delta", "full")}
    t1 = time.perf_counter()
    cpu = place_hierarchical(nl, spec, score_mode="delta", device="cpu",
                             **kw)
    t2 = time.perf_counter()
    for what, a, b in (("card vs cpu", card["delta"], cpu),
                       ("delta vs full on the card", card["delta"],
                        card["full"])):
        bad = hier_fields_differ(a, b)
        if bad:
            fail(f"hierarchical {small}x{small} {what}: {bad} differ")
    h = card["delta"]
    print(f"hierarchical {small}x{small} (grid {h.cluster_grid}, "
          f"{len(nl.pe_cells)} PE + {len(nl.io_cells)} I/O cells, "
          f"{len(nl.nets)} nets, chains 2 x sweeps 2): card == cpu on "
          f"cluster_slots, detail_slots, deblock_slots, level_costs, "
          f"coords and cost, delta == full on the card; level costs "
          f"{h.level_costs}; card {t1 - t0:.2f} s for both modes, cpu "
          f"{t2 - t1:.2f} s", flush=True)

    # 128x128 at the default budget: every K2 call recorded under the
    # level span it ran in
    spec, nl = nets[big]
    torch.cuda.synchronize()
    pnr_cost.anneal_chains.launches = 0
    t0 = time.perf_counter()
    h, calls, tracer = record_k2_calls(lambda: place_hierarchical(
        nl, spec, chains=16, sweeps=32, seed=HIER_SEED + 1, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pnr_cost.anneal_chains.launches
    spans = {}
    for sp, _depth, _path in tracer.iter_spans():
        if sp.name.startswith("pnr.hier."):
            spans[sp.name[9:]] = spans.get(sp.name[9:], 0.0) + sp.dur
    cells = [c.name for c in nl.pe_cells] + [c.name for c in nl.io_cells]
    levels = [c[0] for c in calls]
    if launches != len(calls) or h.cluster_grid < 2 or sorted(h.coords) \
            != sorted(cells) or len(set(h.coords.values())) != len(cells) \
            or not 0 < h.cost < float("inf") or levels[0] != "cluster" \
            or levels[-1] != "deblock" or "detail" not in levels:
        fail(f"hierarchical {big}x{big}: {launches} launches for {len(calls)} "
             f"calls at levels {levels}, grid {h.cluster_grid}, "
             f"{len(h.coords)} cells placed on {len(set(h.coords.values()))} "
             f"tiles, cost {h.cost}")
    print(f"hierarchical {big}x{big} (grid {h.cluster_grid}, "
          f"{len(nl.pe_cells)} PE + {len(nl.io_cells)} I/O cells, "
          f"{len(nl.nets)} nets, chains 16 x sweeps 32, delta): "
          f"{wall:.3f} s wall; span walls (s) "
          f"{ {k: round(v, 4) for k, v in spans.items()} }; level costs "
          f"{h.level_costs}; K2 launched {launches} times", flush=True)
    per_level = k2_per_level(calls, dev)
    for lv, row in per_level.items():
        print(f"  K2 at the {lv} level: {row['launches']} launch(es), "
              f"{row['ms']:.4f} ms on the card (CUDA events), "
              f"{row['call_wall_s']:.3f} s with its inputs' copies; "
              f"{row['shapes']}", flush=True)

    # K2 against its plain version on every level: the cluster level's
    # launch (more than 32 nets an entity: the kernel scores in full,
    # the plain version in delta too) and the detail level's largest, every
    # step; the deblock (tables and boxes in global memory) on a prefix
    box_err = 0.0
    t0 = time.perf_counter()
    cluster = next(c for c in calls if c[0] == "cluster")
    detail = max((c for c in calls if c[0] == "detail"),
                 key=lambda c: c[1]["prob"].shape[0])
    deblock = next(c for c in calls if c[0] == "deblock")
    for (lv, inputs, _, _), steps in ((cluster, None), (detail, None),
                                      (deblock, HIER_CHECK_STEPS)):
        d = {k: v.to(dev) for k, v in inputs.items()}
        r_, s_ = d["a"].shape
        t1 = time.perf_counter()
        box_err = max(box_err, *k2_vs_plain(d, f"{big}x{big} {lv} level",
                                            steps))
        print(f"K2 == plain (delta, full, telemetry; starting costs, slots, "
              f"costs, accepts, curves) at the {big}x{big} {lv} level"
              f"{' (its largest launch)' if lv == 'detail' else ''}: "
              f"R={r_} chains x "
              + (f"S={s_} steps (not cut)" if steps is None else
                 f"the first {steps} of S={s_} steps (cut: the plain "
                 f"version takes about a millisecond a step)")
              + f", N={d['net_pins'].shape[1]}, K={d['ent_nets'].shape[2]}"
              f"{', boxes' if 'net_fix' in d else ''}, in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)

    # flat beside it at the smaller size, the same budget
    spec, nl = nets[small]
    t0 = time.perf_counter()
    flat = place(nl, spec, chains=16, sweeps=32, seed=HIER_SEED + 1,
                 device="cuda")
    t1 = time.perf_counter()
    h64 = place_hierarchical(nl, spec, chains=16, sweeps=32,
                             seed=HIER_SEED + 1, device="cuda")
    t2 = time.perf_counter()
    print(f"{small}x{small} at chains 16 x sweeps 32: flat place "
          f"{t1 - t0:.3f} s, "
          f"HPWL {flat.cost}; hierarchical {t2 - t1:.3f} s, HPWL "
          f"{h64.cost} (level costs {h64.level_costs})", flush=True)

    # flat at the larger size: its own path fits a chain in shared memory;
    # the grouped path (the Explorer's, padded to the bucket signature)
    # keeps the chain's state in global memory
    spec, nl = nets[big]
    p = lower(nl, spec)
    n_, d_ = p.net_pins.shape
    w, stage, chain, smem = pnr_cost.anneal_layout(n_, d_, p.n_entities,
                                                   p.ent_nets.shape[1])
    print(f"flat {big}x{big} (place, unpadded N={n_}, D={d_}, "
          f"E={p.n_entities}, K={p.ent_nets.shape[1]}): {smem} B of shared "
          f"memory a block, tables {'staged' if stage else 'global'}, chain "
          f"{'shared' if chain else 'global'}", flush=True)
    sig = batch_signature(p, 32)
    w, stage, chain, smem = pnr_cost.anneal_layout(*sig[1:])
    chain_bytes = (2 * sig[3] + sig[1]) * 4
    if chain or chain_bytes <= pnr_cost.SMEM_LIMIT:
        fail(f"the grouped flat {big}x{big} bucket {sig} keeps a chain of "
             f"{chain_bytes} B in shared memory")
    t0 = time.perf_counter()
    _, gcalls, _ = record_k2_calls(lambda: anneal_jax_batch(
        [p], chains=16, sweeps=32, seed=HIER_SEED + 1, device="cuda"))
    g_wall = time.perf_counter() - t0
    _, inputs, _, g_k2_wall = gcalls[0]
    d = {k: v.to(dev) for k, v in inputs.items()}
    g_ms = cuda_ms(lambda: pnr_cost.anneal_chains(
        *[d[k] for k in KERNEL_INPUTS]), 1)
    t1 = time.perf_counter()
    box_err = max(box_err, *k2_vs_plain(d, f"grouped flat {big}x{big}",
                                        HIER_CHECK_STEPS))
    print(f"flat {big}x{big} on the grouped path (anneal_jax_batch, padded "
          f"to {sig}): the chain's {chain_bytes} B of state in global "
          f"memory (> {pnr_cost.SMEM_LIMIT} B), {smem} B shared a block; "
          f"{g_wall:.3f} s wall, K2 {g_ms:.4f} ms on the card (CUDA "
          f"events) for R={d['a'].shape[0]} chains x S={d['a'].shape[1]} "
          f"steps ({1e3 * g_ms / d['a'].shape[1]:.4f} us a step); == plain "
          f"on the first {HIER_CHECK_STEPS} steps (cut) in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    return {"box_err": box_err, "hier_wall": wall, "spans": spans,
            "per_level": per_level}


#: phase 9: the four overlapping clients of the JAX package's serve smoke
#: (src/repro/serve/__main__.py), over the image suite's apps
SERVE_CLIENTS = (("r1", ("camera",)), ("r2", ("camera", "harris")),
                 ("r3", ("harris", "gaussian")),
                 ("r4", ("camera", "laplacian")))


def analyze_check(card_pnrs: dict, cpu_pnrs: dict, skip: set) -> None:
    """``analyze_pnr`` of the largest scheduled pair: the report from the
    card's ``PnRResult`` equals the report from the CPU rerun's."""
    from repro_torch.obs import analyze_pnr
    from repro_torch.sim import modulo_schedule
    pair = max((p for p in card_pnrs if p not in skip),
               key=lambda p: (len(card_pnrs[p].netlist.pe_cells), p))
    reports = []
    for pnr in (card_pnrs[pair], cpu_pnrs[pair]):
        sched = modulo_schedule(pnr.netlist, pnr.placement, pnr.routes,
                                pnr.spec)
        rep = analyze_pnr(pnr, sched)
        reports.append((rep.to_dict(), rep.render()))
    if reports[0] != reports[1]:
        fail(f"analyze_pnr of {pair} differs between the card's and the "
             f"cpu's PnRResult")
    d = reports[0][0]
    print(f"analyze_pnr {pair[0]}/{pair[1]} (card == cpu): pe_util "
          f"{d['pe_util']}, channels {d['used_edges']}/{d['total_edges']}, "
          f"II {d['ii']} (min {d['min_ii']}), skew-critical nets "
          f"{len(d['skew_critical'])}", flush=True)


def buildprof_nvcc_check() -> None:
    """``buildprof`` on one ``nvcc`` run: mamba_scan.cu (the smallest
    source) built into a fresh build directory with a tracer on records
    one compile event and one span on the ``kernel-compile`` track."""
    import tempfile
    from repro_torch.kernels import build
    from repro_torch.obs import buildprof, disable_tracing, enable_tracing
    from repro_torch.obs.metrics import MetricsRegistry
    reg = MetricsRegistry()
    old = os.environ.get("REPRO_TORCH_BUILD_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_BUILD_DIR"] = tmp
        buildprof.enable(registry=reg)
        tracer = enable_tracing()
        try:
            lib, _ = build.build("mamba_scan.cu")
            built = lib.exists()
        finally:
            disable_tracing()
            buildprof.disable()
            if old is None:
                del os.environ["REPRO_TORCH_BUILD_DIR"]
            else:
                os.environ["REPRO_TORCH_BUILD_DIR"] = old
    spans = [r for r in tracer.to_rows() if r.get("track") == "kernel-compile"]
    secs = reg.histogram("kernels.compile.secs")
    print(f"buildprof: nvcc on mamba_scan.cu {secs.total:.2f} s; counters "
          f"{reg.counters('kernels.compile')}; kernel-compile spans "
          f"{[(r['name'], round(r['dur_s'], 3)) for r in spans]}",
          flush=True)
    if not built or reg.counter("kernels.compile.events") != 1 \
            or reg.counter("kernels.compile.mamba_scan") != 1 \
            or [r["name"] for r in spans] != ["mamba_scan"]:
        fail("buildprof did not record exactly one nvcc compile")


def serve_phase(apps, cfg, front, card_rows, card_fails, card) -> dict:
    """Phase 9: the four overlapping clients of :data:`SERVE_CLIENTS`
    served at once by ``repro_torch.serve.ExploreService`` on the card,
    each held byte for byte to a solo ``Explorer`` run on the card and
    record for record to phase 4's card records; every run starts from a
    copy of phase 3's ``front``, so what is served is pnr, schedule and
    simulate (K2 and K3).  Then a cache hit and a TCP round trip."""
    import asyncio
    from repro_torch.explore import Explorer
    from repro_torch.kernels import pnr_cost, sim_step
    from repro_torch.serve import ExploreService, encode_request

    cfg = cfg.replace(on_error="isolate")       # what the service runs under
    want_row = {(r["pe_name"], r["app"]): r for r in card_rows}

    def counts():
        return (pnr_cost.anneal_chains.launches,
                sim_step.simulate_batch_stepper.launches)

    def fails_of(failures, names):
        return sorted((f["stage"], f["pe_name"], f["app"], f["error_type"])
                      for f in failures if f["app"] in names)

    # solo: one Explorer a client, on the card
    solo, solo_wall, solo_disp, solo_k = {}, 0.0, 0, (0, 0)
    for rid, names in SERVE_CLIENTS:
        ex = Explorer({n: apps[n] for n in names}, cfg, store=dict(front),
                      device="cuda")
        k0 = counts()
        t0 = time.perf_counter()
        res = ex.run()
        solo_wall += time.perf_counter() - t0
        solo_k = tuple(s + b - a for s, a, b in zip(solo_k, k0, counts()))
        solo_disp += ex.stats["pnr_dispatch"] + ex.stats["sim_dispatch"]
        if ex.stats["mine"] or ex.stats["map"]:
            fail(f"solo {rid} re-mined: it must start from phase 3's front")
        solo[rid] = [json.dumps(r.to_dict()) for r in res.records()]
        if fails_of([f.to_dict() for f in res.failures], names) \
                != fails_of(card_fails, names):
            fail(f"solo {rid}'s failure rows differ from phase 4's")

    svc = ExploreService(store=dict(front), max_batch_apps=4,
                         max_wait_ms=100, queue_limit=16)
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(svc.start())

        async def clients():
            return await asyncio.gather(*[
                svc.explore(rid, {n: apps[n] for n in names}, cfg)
                for rid, names in SERVE_CLIENTS])

        def served():
            t0 = time.perf_counter()
            out = loop.run_until_complete(clients())
            return out, time.perf_counter() - t0

        # the served batch, traced: K2 and K3 run in the batcher's worker
        # thread, which CUPTI sees as it sees any other
        pnr_cost.anneal_chains.launches = 0
        sim_step.simulate_batch_stepper.launches = 0
        (resps, wall), kern, busy_ms = device_kernels(served)
        served_k = counts()
        stats = svc.metrics.view()
        for (rid, names), resp in zip(SERVE_CLIENTS, resps):
            if not resp.ok or resp.cached:
                fail(f"served {rid}: ok={resp.ok} cached={resp.cached} "
                     f"{resp.error}")
            if resp.record_lines() != solo[rid]:
                fail(f"served {rid}'s records differ from its solo run's")
            for r in resp.records:
                if r != want_row.get((r["pe_name"], r["app"])):
                    fail(f"served record {r['pe_name']}/{r['app']} differs "
                         f"from phase 4's card record")
            if fails_of(resp.failures, names) != fails_of(card_fails, names) \
                    or any(f["stage"] != "schedule" for f in resp.failures):
                fail(f"served {rid}'s failure rows {resp.failures} are not "
                     f"phase 4's schedule rows for {names}")
        served_disp = stats["pnr_dispatch"] + stats["sim_dispatch"]
        if stats["serve.batch_degraded"] or stats["serve.request_errors"] \
                or stats["mine"] or stats["map"]:
            fail(f"the served batch degraded, failed or re-mined: "
                 f"{dict(stats)}")
        if min(served_k) == 0 or sum(served_k) >= sum(solo_k) \
                or any(a > b for a, b in zip(served_k, solo_k)):
            fail(f"served launches (K2, K3) {served_k} against solo "
                 f"{solo_k}: not amortized")
        if (launches_of(kern, "anneal_kernel"),
                launches_of(kern, "sim_stepper_kernel")) != served_k:
            fail(f"the served batch's trace disagrees with the launch "
                 f"counters {served_k}")
        if served_disp >= solo_disp:
            fail(f"served {served_disp} dispatches against {solo_disp} solo")

        # a cache hit: the same content under a new id launches nothing
        rid2, names2 = SERVE_CLIENTS[1]
        apps2 = {n: apps[n] for n in names2}
        k0 = counts()
        hit = loop.run_until_complete(svc.explore("r2-again", apps2, cfg))
        if not (hit.ok and hit.cached) or hit.record_lines() != solo[rid2] \
                or counts() != k0 or hit.elapsed_ms >= 1000:
            fail(f"the cache hit: ok={hit.ok} cached={hit.cached}, "
                 f"launches {k0} -> {counts()}, {hit.elapsed_ms:.1f} ms")

        # the wire: r2 and one malformed line over TCP
        async def wire():
            server = await svc.serve_tcp("127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            try:
                writer.write((json.dumps(encode_request(
                    "wire-1", apps2, cfg)) + "\n").encode())
                writer.write(b'{"this is": "not a request"}\n')
                await writer.drain()
                writer.write_eof()
                return [json.loads(await reader.readline())
                        for _ in range(2)]
            finally:
                writer.close()
                await writer.wait_closed()
                server.close()
                await server.wait_closed()

        by_ok = {d["ok"]: d for d in loop.run_until_complete(wire())}
        if set(by_ok) != {True, False} or by_ok[True]["id"] != "wire-1" \
                or [json.dumps(r) for r in by_ok[True]["records"]] \
                != solo[rid2]:
            fail(f"the TCP round trip: {sorted(by_ok)}")
        loop.run_until_complete(svc.aclose())
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
    print(card)
    print(f"served {len(SERVE_CLIENTS)} clients in "
          f"{stats['serve.batches']} batch(es): {wall:.3f} s wall (traced), "
          f"solo runs summed {solo_wall:.3f} s; K2, K3 launches served "
          f"{served_k[0]}, {served_k[1]} against solo {solo_k[0]}, "
          f"{solo_k[1]}; dispatches served {served_disp} against solo "
          f"{solo_disp}; device busy {busy_ms:.2f} ms of the served wall "
          f"({100 * busy_ms / (wall * 1e3):.2f}%); every response == solo "
          f"== phase 4's card records, failure rows "
          f"{fails_of(card_fails, apps)}; cache hit {hit.elapsed_ms:.3f} ms "
          f"with no launch; TCP round trip == solo, malformed line "
          f"answered ok: false", flush=True)
    return {"served_k": served_k, "solo_k": solo_k}


def bit_equal(a, b) -> bool:
    """Two tensors of one dtype and shape equal bit for bit (a NaN equal
    to a NaN of the same bits)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(as_int),
                       b.contiguous().view(as_int))


def lm_splice_checked(eng, solo: dict, refills: list):
    """``eng`` with every refill checked: the slot's spliced cache rows
    bit-equal to the request's solo prefill's (``solo[rid] = (first
    token, {leaf: rows})``, each cast to the slot's dtype, as the splice
    casts) and its first token that prefill's argmax; each checked
    request's id is appended to ``refills``."""
    real = eng._refill

    def refill():
        before = list(eng.active)
        real()
        for slot, req in enumerate(eng.active):
            if req is None or req is before[slot]:
                continue
            tok, rows = solo[req.rid]
            for key, want in rows.items():
                got = eng.cache[key][:, slot]
                if not bit_equal(got, want.to(got.dtype)):
                    fail(f"slot {slot}'s {key} after request {req.rid}'s "
                         f"refill differs from its solo prefill")
            if req.out[0] != tok:
                fail(f"request {req.rid}'s first token {req.out[0]} is not "
                     f"its solo prefill's {tok}")
            refills.append(req.rid)
    eng._refill = refill
    return eng


def lm_serve(eng, timers=None):
    """One served run of ``eng``'s queued requests: (tokens by request,
    wall s).  With ``timers``, the wall of each prefill and decode step,
    a synchronize around each, is appended to ``timers["prefill"]`` and
    ``timers["decode"]``."""
    import torch
    from repro_torch.serve import lm_engine
    real = (lm_engine.prefill, lm_engine.decode_step)
    if timers is not None:
        def timed(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timers[name].append(time.perf_counter() - t)
                return out
            return run
        lm_engine.prefill = timed("prefill", real[0])
        lm_engine.decode_step = timed("decode", real[1])
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t
    finally:
        lm_engine.prefill, lm_engine.decode_step = real


def lm_served_report(name, card, make_engine, n_req, n_new, slots, kinds,
                     vocab, solo) -> dict:
    """The served runs of phases 12 and 13: ``make_engine()`` gives an
    engine with the requests queued.  First, with the launch counters of
    K6 and K7 set to 0 just before and read just after, under
    ``torch.profiler``, each kernel of ``kinds`` (``{counter name: (the
    kernel's name, launches expected)}``) must be launched as expected and
    as often as the trace shows (a trace that shows fewer lost records:
    the run is served and traced again, up to ``LM_TRACE_WINDOWS``
    windows), no other kernel of this repository's sources at all; then
    an untraced run, every refill checked against ``solo``
    (:func:`lm_splice_checked`), gives the prefill and decode walls.
    Prints the serving numbers; returns ``{"outs", "device_ms" (each
    kernel's device ms in the traced run), "launches"}``."""
    import torch
    from repro_torch.kernels import flash_attention, mamba_scan
    counters = {"k6": flash_attention, "k7": mamba_scan}
    # The profiler drops device records now and then
    # (tools/k6_trace_count.py): a served run of 300,000 device events
    # once showed 511 of phase 11's 512 K7 launches.  A trace can lose a
    # launch, not invent one.  So every window's counters must be as
    # expected and its trace hold no more launches than they count; a
    # window whose trace holds fewer is served and traced again, up to
    # LM_TRACE_WINDOWS windows, and one must hold every launch
    for window in range(1, LM_TRACE_WINDOWS + 1):
        eng = make_engine()
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        (outs, wall), kern, busy_ms = device_kernels(lambda: lm_serve(eng))
        got = {k: c.launches for k, c in counters.items()}
        del eng
        lost = False
        for key in counters:
            kname, want = kinds.get(key, (None, 0))
            traced = launches_of(kern, kname) if kname else 0
            print(f"{key.upper()} launches in the served run (window "
                  f"{window}): {got[key]} (counter), {traced} (trace); "
                  f"expected {want}", flush=True)
            if got[key] != want or traced > got[key] \
                    or (traced < got[key] and window == LM_TRACE_WINDOWS):
                fail(f"{name}: {key.upper()} launched {got[key]} times "
                     f"(trace {traced}), expected {want}")
            lost |= traced < got[key]
        if not lost:
            break
        print(f"window {window}'s trace lost launches of ours among its "
              f"{sum(len(v) for v in kern.values())} device events; "
              f"served and traced again", flush=True)
    ours = {kname for kname, _ in kinds.values()} | {"kv_split_kernel"}
    others = {n: launches_of(kern, n) for n in source_kernels()
              if n not in ours}
    if any(others.values()):
        fail(f"{name}: the served run launched other kernels of this "
             f"repository: {others}")
    if sorted(outs) != list(range(n_req)) or any(
            len(v) != n_new or not all(0 <= t < vocab for t in v)
            for v in outs.values()):
        fail(f"{name}: served tokens malformed: "
             f"{ {r: len(v) for r, v in outs.items()} }")
    device_ms = {key: sum(sum(v) for k, v in kern.items() if kname in k)
                 for key, (kname, _) in kinds.items()}
    top = sorted(kern.items(), key=lambda kv: -sum(kv[1]))[:6]
    print(f"device time in the traced served run: "
          f"{sum(len(v) for v in kern.values())} launches; by kernel (ms, "
          f"launches): "
          + "; ".join(f"{k[:60]} {sum(v):.3f} ({len(v)})" for k, v in top),
          flush=True)
    timers, refills = {"prefill": [], "decode": []}, []
    timed_outs, timed_wall = lm_serve(
        lm_splice_checked(make_engine(), solo, refills), timers)
    if sorted(refills) != list(range(n_req)):
        fail(f"{name}: refills checked: {refills}")
    print(f"every refill ({len(refills)}): the slot's "
          f"{', '.join(sorted(solo[0][1]))} bit-equal to the request's solo "
          f"prefill (cast to the slot's dtype, as the splice casts), its "
          f"first token the solo prefill's argmax", flush=True)
    prefill_ms = 1e3 * sum(timers["prefill"]) / len(timers["prefill"])
    decode_ms = 1e3 * sum(timers["decode"]) / len(timers["decode"])
    n_tok = sum(len(v) for v in outs.values())
    print(card)
    print(f"{name}: served {n_req} requests x {n_new} tokens ({n_tok}), "
          f"{slots} slots: wall {timed_wall:.4f} s ({n_tok / timed_wall:.1f} "
          f"tokens/s; prefill {prefill_ms:.4f} ms a request over "
          f"{len(timers['prefill'])}, decode {decode_ms:.4f} ms a step of "
          f"{slots} slots over {len(timers['decode'])}, each timed with a "
          f"synchronize around it); the traced run: {wall:.4f} s, device "
          f"busy {busy_ms:.2f} ms of it ({100 * busy_ms / (wall * 1e3):.2f}%; "
          f"{100 * busy_ms / (timed_wall * 1e3):.2f}% of the untraced wall); "
          + "; ".join(f"{k.upper()} {ms:.3f} ms on the device "
                      f"({ms / max(got[k], 1):.4f} ms a launch)"
                      for k, ms in device_ms.items())
          + f"; tokens equal across the traced and the checked, timed runs: "
          f"{outs == timed_outs} (at {time.perf_counter() - _T0:.1f} s)",
          flush=True)
    return {"outs": outs, "device_ms": device_ms, "launches": got}


def k6_served_shape(dev, card, what, hq, hkv, s, d, window=0) -> dict:
    """K6 alone at a served prefill's shape (1, hq/hkv, s, d) bfloat16
    causal with ``window``, by CUDA events queued behind a sleep and
    issued back to back, beside its bound (4·D a pair inside the masks at
    989 TFLOP/s, or the bytes) and ``scaled_dot_product_attention`` on the
    same inputs (with a boolean mask when windowed)."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention
    from repro_torch.kernels import attention
    gen = torch.Generator(device=dev).manual_seed(26)
    q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    mask = None
    if window:
        i = torch.arange(s, device=dev)
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)

    def k6():
        return attention(q, k, v, causal=True, window=window)

    def sdpa():
        if mask is None:
            return scaled_dot_product_attention(q, k, v, is_causal=True,
                                                enable_gqa=True)
        return scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                            enable_gqa=True)
    # back to back at these sizes both calls are paced by their host work
    call_ms, lib_call_ms = cuda_ms(k6, 50), cuda_ms(sdpa, 50)
    ms, lib_ms = queued_ms(k6), queued_ms(sdpa)
    pairs = sum(min(i + 1, window or s) for i in range(s))
    ops = 4 * d * hq * pairs
    byts = 2 * nbytes(q) + nbytes(k, v)
    t_o, t_b = ops / BF16_OPS_PER_S * 1e3, byts / HBM_BYTES_PER_S * 1e3
    bound_ms, by = (t_o, "operations") if t_o >= t_b else (t_b, "bytes")
    print(card)
    print(f"K6 at (1, {hq}/{hkv}, {s}, {d}) bfloat16 causal, window "
          f"{window} ({what}): {ms:.4f} ms a launch (CUDA events, queued "
          f"behind a sleep) against a bound of {bound_ms:.5f} ms ({by}: "
          f"{ops} operations at 989 TFLOP/s, {byts} bytes at 3.35 TB/s; "
          f"{100 * bound_ms / ms:.2f}% of it), scaled_dot_product_attention "
          f"{lib_ms:.4f} ms (K6 at {ms / lib_ms:.2f}x); issued back to back "
          f"K6 {call_ms:.4f} ms a call, scaled_dot_product_attention "
          f"{lib_call_ms:.4f} ms (the host's pace)", flush=True)
    return {"ms": ms, "call_ms": call_ms, "bound_ms": bound_ms,
            "library_ms": lib_ms, "library_call_ms": lib_call_ms}


def k7_served_shape(dev, card, what, shape) -> dict:
    """K7 alone at a served prefill's shape (B, S, D, N) float32, from no
    state, with its final state, by CUDA events queued behind a sleep and
    issued back to back, beside its bound (the bytes of a, bx, c, y and h
    once each, or 4 operations a state a step at 67 TFLOP/s)."""
    import torch
    from repro_torch.kernels import mamba_scan
    gen = torch.Generator(device=dev).manual_seed(27)
    a = torch.rand(shape, generator=gen, device=dev) * 0.399 + 0.6
    bx = torch.randn(shape, generator=gen, device=dev) * 0.1
    c = torch.randn(shape[:2] + shape[3:], generator=gen, device=dev)

    def k7():
        return mamba_scan(a, bx, c, return_state=True)
    y, h = k7()
    call_ms, ms = cuda_ms(k7, 20), queued_ms(k7)
    byts = nbytes(a, bx, c, y, h)
    ops = 4 * a.numel()             # a*h, + bx, * c, + into y per state
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    bound_ms, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
    print(card)
    print(f"K7 at {shape} float32 with h_out ({what}): {ms:.4f} ms a launch "
          f"(CUDA events, queued behind a sleep) against a bound of "
          f"{bound_ms:.5f} ms ({by}: {byts} bytes at 3.35 TB/s, {ops} "
          f"operations at 67 TFLOP/s; {100 * bound_ms / ms:.2f}% of it, "
          f"{byts / ms / 1e9:.3f} TB/s); issued back to back {call_ms:.4f} "
          f"ms a call", flush=True)
    return {"ms": ms, "call_ms": call_ms, "bound_ms": bound_ms}


def prefill_departure(got, want) -> tuple:
    """Relative error norms of two prefills' (logits, cache): the
    logits', and the largest over every cache leaf."""
    return (rel_norms(got[0], want[0])[0],
            max(rel_norms(got[1][k], want[1][k])[0]
                for k in want[1] if k != "len"))


#: phase 10: src/repro_torch/configs/llama3_2_1b.py unreduced, served as
#: the JAX package's LM demo serves: 4 slots, two waves of 4 requests of
#: one prompt length and one max_new (the only traffic on which the
#: demo's one cache length is right)
LM_ARCH, LM_SLOTS, LM_SMAX = "llama3.2-1b", 4, 1024
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 512, 32
#: traced served runs at most in phases 10-13, until one trace holds every
#: launch the counters count (the profiler drops device records now and
#: then)
LM_TRACE_WINDOWS = 3
#: relative error norm of the full-width float32 prefill's logits and k/v
#: cache, K6 against its plain version swapped in (K6 is 3xTF32: what is
#: left is the two float32 summation orders, carried through 16 layers)
LM_F32_REL = 1e-4
#: the same in bfloat16, for every served prefill; a planted fault (the
#: causal mask one key too far) must exceed it
LM_BF16_REL = 2.0 ** -5


def lm_plain_attention(q, k, v, **kw):
    """K6's plain version with the wrapper's signature."""
    from repro_torch.kernels.flash_attention import attention_plain
    kw.pop("device")
    return attention_plain(q, k, v, **kw)


def lm_faulty_attention(q, k, v, **kw):
    """The plain version with the causal mask one key too far: query i
    sees keys 0..i+1 (a zero key and value past the last)."""
    import torch.nn.functional as F
    return lm_plain_attention(F.pad(q, (0, 0, 1, 0)), F.pad(k, (0, 0, 0, 1)),
                              F.pad(v, (0, 0, 0, 1)), **kw)[:, :, 1:]


def lm_run_with(attn, fn, *args, **kw):
    """``fn(*args, **kw)`` with ``attn`` in place of the model's
    flash-attention wrapper (``repro_torch.models.transformer.attention``)."""
    from repro_torch.models import transformer
    real = transformer.attention
    transformer.attention = attn
    try:
        return fn(*args, **kw)
    finally:
        transformer.attention = real


def lm_gpu_tests():
    """``tests/test_torch_lm_gpu.py``, loaded by its path: the card ==
    CPU checks live there once."""
    import importlib.util
    path = os.path.join(ROOT, "tests", "test_torch_lm_gpu.py")
    spec = importlib.util.spec_from_file_location("test_torch_lm_gpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_card_vs_cpu(dev, mixers) -> None:
    """The architectures of ``tests/test_torch_lm_gpu.py`` whose mixer is
    in ``mixers``, at ``.reduced()``, card against CPU: that file's
    ``card_vs_cpu`` on each (forward, prefill and 4 decode steps in
    float32, within its ``TOL``, every cache leaf, K6 and K7 counted; an
    assertion that fails ends the run)."""
    mod = lm_gpu_tests()
    from repro_torch.configs import get_config
    for arch in mod.ARCHS:
        cfg = get_config(arch).reduced()
        if cfg.mixer not in mixers:
            continue
        err = mod.card_vs_cpu(arch, dev)
        print(f"{arch} reduced (mixer {cfg.mixer}, window {cfg.window}, "
              f"softcap {cfg.attn_softcap}, qk_norm {cfg.qk_norm}, cross "
              f"layers {cfg.n_cross_layers}, MoE {cfg.moe is not None}): "
              f"forward, prefill and 4 decode "
              f"steps card == CPU within {mod.TOL} (max |diff| {err:.3e})",
              flush=True)


def lm_phase(dev, card) -> dict:
    """Phase 10: Llama 3.2 1B at full width served by
    ``repro_torch.serve.lm_engine.ServeEngine`` on the card, K6 in every
    prefill's self-attention layers, counted under ``torch.profiler``;
    K6 against its plain version inside the model; every refill's k/v
    equal to its solo prefill; the attn-only architectures card == CPU
    at reduced widths; the launcher; K6 alone at the served shape."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import cast_for_compute, init_params, prefill
    from repro_torch.serve import lm_engine

    phase("10 LM serving at full width: Llama 3.2 1B through "
          "repro_torch.serve.lm_engine, prefill attention on K6")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # by the earlier phases
    cfg = get_config(LM_ARCH)
    hd = cfg.head_dim_of
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, hd,
              cfg.d_ff, cfg.vocab)
    if widths != (16, 2048, 32, 8, 64, 8192, 128256):
        fail(f"{LM_ARCH} widths {widths} are not the published ones")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    bf16 = cast_for_compute(params, cfg, torch.bfloat16)
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    print(f"{LM_ARCH}: {n_params} parameters ({n_params * 4 / 1e9:.3f} GB "
          f"float32, bfloat16 copies beside them) made on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_REQUESTS, LM_PROMPT), dtype=np.int64)

    # K6 against its plain version inside the model: float32, request 0
    toks = torch.as_tensor(prompts[:1], device=dev)
    run32 = dict(smax=LM_SMAX, compute_dtype=torch.float32)
    rel32 = prefill_departure(prefill(params, cfg, toks, **run32),
                              lm_run_with(lm_plain_attention, prefill,
                                          params, cfg, toks, **run32))
    print(f"float32 prefill of request 0 at full width, K6 against its "
          f"plain version: relative error norm logits {rel32[0]:.3e}, k/v "
          f"cache {rel32[1]:.3e} (limit {LM_F32_REL})", flush=True)
    if max(rel32) > LM_F32_REL:
        fail(f"the float32 prefill with K6 departs from the plain version: "
             f"{rel32} above {LM_F32_REL}")
    # bfloat16: every request's solo prefill, and a planted fault that
    # must fail; its k/v rows and first token kept for the splices
    run16 = dict(smax=LM_SMAX, compute_dtype=torch.bfloat16)
    solo, worst, fault_min = {}, (0.0, 0.0), float("inf")
    for rid in range(LM_REQUESTS):
        toks = torch.as_tensor(prompts[rid:rid + 1], device=dev)
        got = prefill(bf16, cfg, toks, **run16)
        ref = lm_run_with(lm_plain_attention, prefill, bf16, cfg, toks,
                          **run16)
        bad = lm_run_with(lm_faulty_attention, prefill, bf16, cfg, toks,
                          **run16)
        dep, bad_dep = prefill_departure(got, ref), prefill_departure(bad,
                                                                      ref)
        worst = (max(worst[0], dep[0]), max(worst[1], dep[1]))
        fault_min = min(fault_min, max(bad_dep))
        if max(dep) > LM_BF16_REL:
            fail(f"the bfloat16 prefill of request {rid} with K6 departs "
                 f"from the plain version: {dep} above {LM_BF16_REL}")
        if max(bad_dep) <= LM_BF16_REL:
            fail(f"the planted fault passes the bfloat16 bound on request "
                 f"{rid}: {bad_dep}")
        solo[rid] = (int(torch.argmax(got[0][0])),
                     {k: got[1][k][:, 0] for k in ("k", "v")})
        del got, ref, bad
    print(f"bfloat16 prefills, K6 against its plain version: largest "
          f"relative error norm logits {worst[0]:.3e}, k/v cache "
          f"{worst[1]:.3e} (limit {LM_BF16_REL}); the planted fault (causal "
          f"mask one key too far) at least {fault_min:.3e}", flush=True)

    def engine():
        eng = lm_engine.ServeEngine(cfg, bf16, slots=LM_SLOTS, smax=LM_SMAX,
                                    compute_dtype=torch.bfloat16, device=dev)
        for rid in range(LM_REQUESTS):
            eng.submit(lm_engine.Request(rid, prompts[rid], max_new=LM_NEW))
        return eng

    served = lm_served_report(
        f"{LM_ARCH} ({LM_PROMPT}-token prompts)", card, engine, LM_REQUESTS,
        LM_NEW, LM_SLOTS, {"k6": ("flash_attention_kernel",
                                  LM_REQUESTS * cfg.n_self_layers)},
        cfg.vocab, solo)
    outs = served["outs"]
    plain_outs = lm_run_with(lm_plain_attention,
                             lambda: lm_serve(engine())[0])
    same = sum(a == b for r in outs for a, b in zip(outs[r], plain_outs[r]))
    whole = sum(outs[r] == plain_outs[r] for r in outs)
    print(f"greedy tokens with the plain version served: {same} of "
          f"{LM_REQUESTS * LM_NEW} equal, {whole} of {LM_REQUESTS} requests "
          f"whole", flush=True)
    del params, bf16, solo
    free_device_memory()

    lm_card_vs_cpu(dev, ("attn",))

    # the launcher at its defaults
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    if out.returncode != 0 or "served 8 requests" not in out.stdout:
        fail(f"python -m repro_torch.launch.serve exited {out.returncode}: "
             f"{out.stderr.strip()[-2000:]}")
    print(f"python -m repro_torch.launch.serve: "
          f"{out.stdout.splitlines()[0]}", flush=True)

    k6 = k6_served_shape(dev, card, LM_ARCH, cfg.n_heads, cfg.n_kv,
                         LM_PROMPT, hd)
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory in phase 10 {peak} bytes "
          f"({peak / 2 ** 30:.2f} GiB; {(peak - held) / 2 ** 30:.2f} GiB "
          f"above the {held} bytes the earlier phases hold)", flush=True)
    n = served["launches"]["k6"]
    return {"lm_launches": n, "lm_ms": k6["ms"], "lm_call_ms": k6["call_ms"],
            "lm_served_ms": served["device_ms"]["k6"] / n,
            "lm_bound_ms": k6["bound_ms"], "lm_library_ms": k6["library_ms"],
            "lm_library_call_ms": k6["library_call_ms"]}


#: phase 11: src/repro_torch/configs/falcon_mamba_7b.py unreduced, served
#: by the LM engine: 4 slots, 8 requests of four prompt lengths twice (the
#: Mamba mixer reads no position, so mixed lengths are served right; the
#: odd ones end K7's scan inside its 4-step chunk), 32 new tokens each
MB_ARCH, MB_SLOTS, MB_SMAX, MB_NEW = "falcon-mamba-7b", 4, 1024, 32
MB_PROMPTS = (512, 509, 384, 257) * 2
#: relative error norm of the full-width float32 prefill's logits,
#: ``ssm_h`` and ``ssm_conv``, K7 against its plain version swapped in
#: (the sum over states in another order, carried through 64 layers)
MB_F32_REL = 1e-4
#: the same in bfloat16, for every served prefill; a planted fault (each
#: y_t read from h_{t-1}) must exceed it
MB_BF16_REL = 2.0 ** -5
#: the streamed scan (perf flag ssm_impl="streamed"): one prefill of this
#: many tokens in chunks of MB_STREAM_CHUNK steps, against the default
#: materialized scan, within MB_BF16_REL
MB_STREAM_TOKENS, MB_STREAM_CHUNK = 4096, 256


def mb_plain_scan(a, bx, c, **kw):
    """K7's plain version with the wrapper's signature."""
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    kw.pop("device")
    return mamba_scan_plain(a, bx, c, **kw)


def mb_faulty_scan(a, bx, c, *, h0=None, return_state=False, device):
    """The scan with each y_t read from the state before step t (y_0 from
    h0, here zero), by K7 itself on c moved one step earlier."""
    import torch
    from repro_torch.kernels.mamba_scan import mamba_scan
    if h0 is not None:
        raise ValueError("the planted fault runs prefill, from no state")
    c_next = torch.cat([c[:, 1:], torch.zeros_like(c[:, :1])], 1)
    out = mamba_scan(a, bx, c_next, return_state=return_state,
                     device=device)
    y, h = out if return_state else (out, None)
    y = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], 1)
    return (y, h) if return_state else y


def mb_run_with(scan, fn, *args, **kw):
    """``fn(*args, **kw)`` with ``scan`` in place of the Mamba mixer's
    selective-scan wrapper (``repro_torch.models.ssm.mamba_scan``)."""
    from repro_torch.models import ssm
    real = ssm.mamba_scan
    ssm.mamba_scan = scan
    try:
        return fn(*args, **kw)
    finally:
        ssm.mamba_scan = real


def mamba_phase(dev, card) -> dict:
    """Phase 11: falcon-mamba-7b at full width served by
    ``repro_torch.serve.lm_engine.ServeEngine`` on the card, K7 in every
    prefill's Mamba mixers, counted under ``torch.profiler``; K7 against
    its plain version inside the model; every slot's spliced state equal
    to its request's solo prefill; the Mamba archs card == CPU at reduced
    widths; K7 alone at the served shape."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import cast_for_compute, init_params, prefill
    from repro_torch.models.ssm import discretize
    from repro_torch.serve import lm_engine

    phase("11 Mamba serving at full width: falcon-mamba-7b through "
          "repro_torch.serve.lm_engine, prefill's selective scan on K7")
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # by the earlier phases
    cfg = get_config(MB_ARCH)
    widths = (cfg.n_layers, cfg.d_model, cfg.ssm.expand * cfg.d_model,
              cfg.ssm.d_state, cfg.ssm.d_conv, cfg.ssm.dt_rank_of(
                  cfg.d_model), cfg.vocab, cfg.tie_embeddings, cfg.d_ff)
    if widths != (64, 4096, 8192, 16, 4, 256, 65024, True, 0):
        fail(f"{MB_ARCH} widths {widths} are not the published ones")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    bf16 = cast_for_compute(params, cfg, torch.bfloat16)
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    print(f"{MB_ARCH}: {n_params} parameters ({n_params * 4 / 1e9:.3f} GB "
          f"float32, bfloat16 copies beside them) made on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int64)
               for n in MB_PROMPTS]
    run16 = dict(smax=MB_SMAX, compute_dtype=torch.bfloat16)

    # every request's solo prefill (K7), held against the plain version and
    # the planted fault; its state and first token kept for the splices
    solo, worst, fault_min = {}, (0.0, 0.0), float("inf")
    for rid, p in enumerate(prompts):
        toks = torch.as_tensor(p, device=dev)[None]
        got = prefill(bf16, cfg, toks, **run16)
        ref = mb_run_with(mb_plain_scan, prefill, bf16, cfg, toks, **run16)
        bad = mb_run_with(mb_faulty_scan, prefill, bf16, cfg, toks, **run16)
        dep, bad_dep = prefill_departure(got, ref), prefill_departure(bad,
                                                                      ref)
        worst = tuple(max(w, g) for w, g in zip(worst, dep))
        fault_min = min(fault_min, max(bad_dep))
        if max(dep) > MB_BF16_REL:
            fail(f"the bfloat16 prefill of request {rid} ({len(p)} tokens) "
                 f"with K7 departs from the plain version: {dep} above "
                 f"{MB_BF16_REL}")
        if max(bad_dep) <= MB_BF16_REL:
            fail(f"the planted fault passes the bfloat16 bound on request "
                 f"{rid}: {bad_dep}")
        solo[rid] = (int(torch.argmax(got[0][0])),
                     {k: got[1][k][:, 0] for k in ("ssm_h", "ssm_conv")})
    print(f"bfloat16 prefills ({MB_PROMPTS} tokens), K7 against its plain "
          f"version: largest relative error norm logits {worst[0]:.3e}, "
          f"over ssm_h and ssm_conv {worst[1]:.3e} (limit {MB_BF16_REL}); "
          f"the planted fault (y_t from h_(t-1)) at least {fault_min:.3e} "
          f"(at {time.perf_counter() - _T0:.1f} s)", flush=True)
    # float32 at full width, request 0
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    run32 = dict(smax=MB_SMAX, compute_dtype=torch.float32)
    rel32 = prefill_departure(prefill(params, cfg, toks, **run32),
                              mb_run_with(mb_plain_scan, prefill, params,
                                          cfg, toks, **run32))
    print(f"float32 prefill of request 0 at full width, K7 against its "
          f"plain version: relative error norm logits {rel32[0]:.3e}, over "
          f"ssm_h and ssm_conv {rel32[1]:.3e} (limit {MB_F32_REL})",
          flush=True)
    if max(rel32) > MB_F32_REL:
        fail(f"the float32 prefill with K7 departs from the plain version: "
             f"{rel32} above {MB_F32_REL}")

    def engine():
        eng = lm_engine.ServeEngine(cfg, bf16, slots=MB_SLOTS, smax=MB_SMAX,
                                    compute_dtype=torch.bfloat16, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(lm_engine.Request(rid, p, max_new=MB_NEW))
        return eng

    served = lm_served_report(
        f"{MB_ARCH} ({MB_PROMPTS}-token prompts)", card, engine,
        len(prompts), MB_NEW, MB_SLOTS,
        {"k7": ("mamba_scan_kernel", len(prompts) * cfg.n_layers)},
        cfg.vocab, solo)
    stream = streamed_check(dev, card, cfg, bf16)
    del params, bf16, solo
    free_device_memory()

    lm_card_vs_cpu(dev, ("mamba", "hymba"))

    shape = (1, MB_PROMPTS[0], cfg.ssm.expand * cfg.d_model,
             cfg.ssm.d_state)
    k7 = k7_served_shape(dev, card, MB_ARCH, shape)
    # what builds K7's inputs in the mixer: the discretization, at the
    # served shape in bfloat16 compute (dt, x (1, S, di), B (1, S, N))
    gen = torch.Generator(device=dev).manual_seed(23)
    dt_, x_ = (torch.randn(shape[:3], generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(2))
    b_ = torch.randn(shape[:2] + shape[3:], generator=gen, device=dev,
                     dtype=torch.bfloat16)
    a_log = torch.log(torch.arange(1, shape[3] + 1, device=dev,
                                   dtype=torch.float32)).expand(shape[2:])
    disc_ms = queued_ms(lambda: discretize(dt_, x_, b_, -torch.exp(a_log)))
    peak = torch.cuda.max_memory_allocated()
    print(f"the discretization that builds K7's a and bx "
          f"(models.ssm.discretize, bfloat16 dt, x, B) at that shape: "
          f"{disc_ms:.4f} ms (queued) a layer; peak device memory in phase "
          f"11 {peak} bytes ({peak / 2 ** 30:.2f} GiB; "
          f"{(peak - held) / 2 ** 30:.2f} GiB above the {held} bytes the "
          f"earlier phases hold)", flush=True)
    n = served["launches"]["k7"]
    return {"lm_launches": n, "lm_ms": k7["ms"], "lm_call_ms": k7["call_ms"],
            "lm_served_ms": served["device_ms"]["k7"] / n,
            "lm_bound_ms": k7["bound_ms"], **stream}


def streamed_check(dev, card, cfg, params) -> dict:
    """Phase 11's perf-flag variant: one MB_STREAM_TOKENS-token prefill
    with ``ssm_impl="streamed"`` (K7 on chunks of MB_STREAM_CHUNK steps,
    the state carried) against the default materialized scan: logits and
    cache within MB_BF16_REL, K7 launched once a chunk a layer, counted
    and in the trace (up to 3 windows, none above the counter), each
    prefill's ms and the peak device memory above what was held before."""
    import numpy as np
    import torch
    from repro_torch.kernels import mamba_scan
    from repro_torch.models import prefill
    from repro_torch.models.perf_flags import reset_flags, set_flags
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab, MB_STREAM_TOKENS), device=dev)[None]

    def run(**flags):
        set_flags(**flags)
        try:
            return prefill(params, cfg, toks, smax=MB_STREAM_TOKENS,
                           compute_dtype=torch.bfloat16)
        finally:
            reset_flags()
    stream = dict(ssm_impl="streamed", ssm_chunk=MB_STREAM_CHUNK)
    out = {}
    for name, flags in (("materialized", {}), ("streamed", stream)):
        run(**flags)                              # warm-up
        free_device_memory()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mamba_scan.launches = 0
        t0 = time.perf_counter()
        got = run(**flags)
        torch.cuda.synchronize()
        out[name] = (got, (time.perf_counter() - t0) * 1e3,
                     mamba_scan.launches,
                     torch.cuda.max_memory_allocated() - base)
    # the ms a prefill in turns, the allocator's cache warm
    times = {"materialized": [], "streamed": []}
    for name in ("materialized", "streamed", "streamed", "materialized"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(**(stream if name == "streamed" else {}))
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    chunks = -(-MB_STREAM_TOKENS // MB_STREAM_CHUNK)
    want = chunks * cfg.n_layers
    if (out["materialized"][2], out["streamed"][2]) != (cfg.n_layers, want):
        fail(f"K7 launched {out['streamed'][2]} times in the streamed "
             f"prefill (want {want}), {out['materialized'][2]} in the "
             f"materialized one (want {cfg.n_layers})")
    dep = prefill_departure(out["streamed"][0], out["materialized"][0])
    if max(dep) > MB_BF16_REL:
        fail(f"the streamed prefill departs from the materialized one: "
             f"{dep} above {MB_BF16_REL}")
    seen = []
    for _ in range(LM_TRACE_WINDOWS):
        mamba_scan.launches = 0
        _, kern, _ = device_kernels(lambda: run(**stream))
        seen.append((launches_of(kern, "mamba_scan_kernel"),
                     mamba_scan.launches))
        if seen[-1][0] == want:
            break
    if any(c != want or t > c for t, c in seen) or seen[-1][0] != want:
        fail(f"K7 in the streamed prefill's traced windows (trace, "
             f"counted): {seen}; want {want}")
    ssm_bytes = MB_STREAM_TOKENS * cfg.ssm.expand * cfg.d_model \
        * cfg.ssm.d_state * 4
    print(card)
    print(f"streamed scan (ssm_impl=\"streamed\", chunk "
          f"{MB_STREAM_CHUNK}), a {MB_STREAM_TOKENS}-token bfloat16 "
          f"prefill against the materialized scan: relative error norm "
          f"logits {dep[0]:.3e}, over the cache {dep[1]:.3e} (limit "
          f"{MB_BF16_REL}); K7 {out['streamed'][2]} launches ({chunks} "
          f"chunks x {cfg.n_layers} layers), traced windows (trace, "
          f"counted) {seen}; {ms['streamed']:.1f} ms against "
          f"{ms['materialized']:.1f} ms a prefill (host clock, in turns: "
          f"{[round(t, 1) for t in times['streamed']]} against "
          f"{[round(t, 1) for t in times['materialized']]}); "
          f"peak device memory above the weights {out['streamed'][3]} "
          f"bytes against {out['materialized'][3]} (float32 da and dbx a "
          f"layer: {ssm_bytes} bytes each materialized, "
          f"{ssm_bytes * MB_STREAM_CHUNK // MB_STREAM_TOKENS} a chunk)",
          flush=True)
    return {"stream_launches": out["streamed"][2],
            "stream_prefill_ms": ms["streamed"],
            "materialized_prefill_ms": ms["materialized"],
            "stream_peak_bytes": out["streamed"][3],
            "materialized_peak_bytes": out["materialized"][3]}


class PinnedRouting:
    """A stand-in for the MoE MLP's router
    (``repro_torch.models.moe.router_topk``) that records the expert ids
    of one prefill and makes the next prefills take the same ids, in the
    same order of calls, each weighted by its own probabilities: so two
    prefills that differ in one kernel are compared through the model's
    continuous paths.  The router's choice is discrete: left free, a
    bfloat16 difference of a few ulps in attention moves some tokens to
    other experts, and their outputs differ wholly.  ``flips`` counts the
    tokens whose own top-k differs from the pinned ids."""

    def __init__(self):
        self.ids, self.replay, self.flips = [], None, 0

    def __call__(self, x, w_router, moe):
        import torch
        from repro_torch.models import moe as moe_mod
        vals, idx = self.real(x, w_router, moe)
        if self.replay is None:
            self.ids.append(idx)
            return vals, idx
        pinned = self.ids[self.replay]
        self.replay += 1
        self.flips += int((pinned != idx).any(-1).sum())
        logits = torch.matmul(x.float(), w_router.float())
        logits[..., moe.n_experts:] = moe_mod.PAD_LOGIT
        vals = torch.gather(torch.softmax(logits, -1), -1, pinned)
        if moe.router_norm_topk:
            vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        return vals, pinned

    def run(self, fn, *args, replay: bool, **kw):
        """``fn(*args, **kw)`` with the router pinned: the ids recorded
        (``replay`` false, after forgetting any) or replayed."""
        from repro_torch.models import moe as moe_mod
        self.real = moe_mod.router_topk
        if replay:
            self.replay = 0
        else:
            self.ids, self.replay = [], None
        moe_mod.router_topk = self
        try:
            return fn(*args, **kw)
        finally:
            moe_mod.router_topk = self.real


#: phase 12: src/repro_torch/configs/qwen2_moe_a2_7b.py unreduced, made in
#: bfloat16 (a float32 master and its bfloat16 copy would not fit 80 GB),
#: served as phase 10 serves Llama 3.2 1B
MOE_ARCH, MOE_SLOTS, MOE_SMAX = "qwen2-moe-a2.7b", 4, 1024
MOE_REQUESTS, MOE_PROMPT, MOE_NEW = 8, 512, 32


def moe_phase(dev, card) -> dict:
    """Phase 12: qwen2-moe-a2.7b at full width served by
    ``repro_torch.serve.lm_engine.ServeEngine`` on the card, the MoE MLP
    in every layer and K6 in every prefill's attention, counted under
    ``torch.profiler``; K6 against its plain version inside the model;
    every refill's k/v equal to its solo prefill; one MoE layer card
    against CPU; K6 alone at the served shape."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.serve import lm_engine

    phase("12 MoE serving at full width: qwen2-moe-a2.7b through "
          "repro_torch.serve.lm_engine, the MoE MLP, prefill attention on "
          "K6")
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # by the earlier phases
    cfg = get_config(MOE_ARCH)
    moe = cfg.moe
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
              cfg.head_dim_of, cfg.d_ff, cfg.vocab, cfg.tie_embeddings,
              moe.n_experts, moe.n_experts_padded, moe.top_k, moe.d_expert,
              moe.n_shared, moe.d_shared)
    if widths != (24, 2048, 16, 16, 128, 0, 151936, False, 60, 64, 4, 1408,
                  4, 5632):
        fail(f"{MOE_ARCH} widths {widths} are not the published ones")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    print(f"{MOE_ARCH}: {n_params} parameters ({n_params * 2 / 1e9:.3f} GB "
          f"bfloat16, made in bfloat16: no float32 master) made on the card "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (MOE_REQUESTS, MOE_PROMPT), dtype=np.int64)
    run16 = dict(smax=MOE_SMAX, compute_dtype=torch.bfloat16)
    cap = moe_mod.capacity_of(MOE_PROMPT, moe)

    # the drops of each served prefill's MoE layers, counted on the side
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    real_moe, real_router = transformer.moe_mlp, moe_mod.router_topk

    def counting_moe(x, mp, m):
        nonlocal dropped
        ids = real_router(x, mp["w_router"], m)[1]
        keep = moe_mod.dispatch(ids, mp["w_router"].shape[1],
                                moe_mod.capacity_of(x.shape[1], m))[1]
        dropped = dropped + (~keep).sum()
        return real_moe(x, mp, m)

    # every request's solo prefill (K6), held against the plain version
    # and the planted fault, each with the solo prefill's expert choices
    # (PinnedRouting); its k/v rows and first token kept
    solo, worst, fault_min = {}, (0.0, 0.0), float("inf")
    pin = PinnedRouting()
    flips = {"plain": 0, "fault": 0}
    for rid in range(MOE_REQUESTS):
        toks = torch.as_tensor(prompts[rid:rid + 1], device=dev)
        transformer.moe_mlp = counting_moe
        try:
            got = pin.run(prefill, params, cfg, toks, replay=False, **run16)
        finally:
            transformer.moe_mlp = real_moe
        for what, attn in (("plain", lm_plain_attention),
                           ("fault", lm_faulty_attention)):
            pin.flips = 0
            out = pin.run(lm_run_with, attn, prefill, params, cfg, toks,
                          replay=True, **run16)
            flips[what] += pin.flips
            if what == "plain":
                ref = out
            else:
                bad = out
        dep, bad_dep = prefill_departure(got, ref), prefill_departure(bad,
                                                                      ref)
        worst = (max(worst[0], dep[0]), max(worst[1], dep[1]))
        fault_min = min(fault_min, max(bad_dep))
        if max(dep) > LM_BF16_REL:
            fail(f"the bfloat16 prefill of request {rid} with K6 departs "
                 f"from the plain version: {dep} above {LM_BF16_REL}")
        if max(bad_dep) <= LM_BF16_REL:
            fail(f"the planted fault passes the bfloat16 bound on request "
                 f"{rid}: {bad_dep}")
        solo[rid] = (int(torch.argmax(got[0][0])),
                     {k: got[1][k][:, 0] for k in ("k", "v")})
        del got, ref, bad
    dropped = int(dropped)
    entries = MOE_REQUESTS * cfg.n_layers * MOE_PROMPT * moe.top_k
    print(f"bfloat16 prefills, K6 against its plain version, the expert "
          f"choices pinned to the K6 prefill's: largest relative error norm "
          f"logits {worst[0]:.3e}, k/v cache {worst[1]:.3e} (limit "
          f"{LM_BF16_REL}); the planted fault (causal mask one key too far) "
          f"at least {fault_min:.3e}; (token, layer) choices that would "
          f"have moved, left free: {flips['plain']} with the plain "
          f"version, {flips['fault']} with the fault, of "
          f"{MOE_REQUESTS * cfg.n_layers * MOE_PROMPT}; the MoE "
          f"layers dropped {dropped} of {entries} (token, choice) entries "
          f"(capacity {cap} an expert a row) (at "
          f"{time.perf_counter() - _T0:.1f} s)", flush=True)
    if not 0 < dropped < entries:
        fail(f"{dropped} of {entries} entries dropped: random routing at "
             f"capacity {cap} must overflow some experts, not all")

    def engine():
        eng = lm_engine.ServeEngine(cfg, params, slots=MOE_SLOTS,
                                    smax=MOE_SMAX,
                                    compute_dtype=torch.bfloat16, device=dev)
        for rid in range(MOE_REQUESTS):
            eng.submit(lm_engine.Request(rid, prompts[rid],
                                         max_new=MOE_NEW))
        return eng

    want = MOE_REQUESTS * cfg.n_layers
    served = lm_served_report(
        f"{MOE_ARCH} ({MOE_PROMPT}-token prompts)", card, engine,
        MOE_REQUESTS, MOE_NEW, MOE_SLOTS,
        {"k6": ("flash_attention_kernel", want)}, cfg.vocab, solo)
    del params, solo
    free_device_memory()

    # one MoE layer at full width in float32, card against CPU
    mod = lm_gpu_tests()
    near, differ, drops, rel = mod.moe_layer_card_vs_cpu(MOE_ARCH,
                                                         MOE_PROMPT, dev)
    print(f"one {MOE_ARCH} MoE layer at full width, float32, a "
          f"{MOE_PROMPT}-token input, card against CPU: {near} tokens with "
          f"the k-th and (k+1)-th router probabilities within "
          f"{mod.MOE_TIE}, {differ} tokens whose expert ids differ, drops "
          f"equal ({drops} of {MOE_PROMPT * moe.top_k} entries), output "
          f"relative error norm {rel:.3e} (limit {mod.TOL})", flush=True)

    k6 = k6_served_shape(dev, card, MOE_ARCH, cfg.n_heads, cfg.n_kv,
                         MOE_PROMPT, cfg.head_dim_of)
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory in phase 12 {peak} bytes "
          f"({peak / 2 ** 30:.2f} GiB; {(peak - held) / 2 ** 30:.2f} GiB "
          f"above the {held} bytes the earlier phases hold)", flush=True)
    n = served["launches"]["k6"]
    return {"moe_launches": n, "moe_ms": k6["ms"],
            "moe_call_ms": k6["call_ms"],
            "moe_served_ms": served["device_ms"]["k6"] / n,
            "moe_bound_ms": k6["bound_ms"],
            "moe_library_ms": k6["library_ms"],
            "moe_library_call_ms": k6["library_call_ms"]}


def lm_roundoff_attention(q, k, v, **kw):
    """The plain version with each output element times ``1 + 2^-9 z``,
    z standard normal (the same draws on every call of one shape): a
    bfloat16 roundoff (2^-9 is its unit roundoff) more or less on
    attention's output."""
    import torch
    out = lm_plain_attention(q, k, v, **kw)
    gen = torch.Generator(device=out.device).manual_seed(0)
    z = torch.randn(out.shape, generator=gen, device=out.device)
    return (out.float() * (1 + 2.0 ** -9 * z)).to(out.dtype)


class K6CallCheck:
    """Stands in for the model's flash-attention wrapper
    (``repro_torch.models.transformer.attention``): runs it, and on the
    same inputs K6's plain version and the planted fault; keeps the
    largest relative error norm of the wrapper's output against the plain
    version's and the smallest of the fault's, over ``n`` calls."""

    def __init__(self):
        from repro_torch.models import transformer
        self.real = transformer.attention
        self.n, self.worst, self.fault_min = 0, 0.0, float("inf")

    def __call__(self, q, k, v, **kw):
        out = self.real(q, k, v, **kw)
        ref = lm_plain_attention(q, k, v, **kw)
        self.worst = max(self.worst, rel_norms(out, ref)[0])
        self.fault_min = min(self.fault_min, rel_norms(
            lm_faulty_attention(q, k, v, **kw), ref)[0])
        self.n += 1
        return out


#: phase 13's bound on K6's bfloat16 prefill against the plain version's,
#: in units of the departure ``lm_roundoff_attention`` gives: over 32
#: hymba layers one bfloat16 roundoff on attention's output grows to a
#: departure of 0.07 in the last layer's keys and 0.09 in the logits, past
#: LM_BF16_REL, whichever attention computes it
HY_ROUNDOFF_X = 2.0

#: phase 13: src/repro_torch/configs/hymba_1_5b.py unreduced: 8 requests of
#: one prompt length (hymba has attention: the JAX demo's one cache length
#: needs one), longer than the 1024-token window, so the window cuts keys
#: in the 29 local layers, in K6's prefill and in decode's attention
HY_ARCH, HY_SLOTS, HY_SMAX = "hymba-1.5b", 4, 2048
HY_REQUESTS, HY_PROMPT, HY_NEW = 8, 1536, 32


def hymba_phase(dev, card) -> tuple:
    """Phase 13: hymba-1.5b at full width served by ``ServeEngine`` on the
    card, K6 and K7 in every prefill layer, counted under
    ``torch.profiler``; each against its plain version inside the model
    (float32 at full width and every bfloat16 prefill, with a planted
    fault each); every refill's k, v, ``ssm_conv`` and ``ssm_h`` equal to
    its solo prefill; K6 and K7 alone at the served shape.  Returns the
    K6 and the K7 keys of the kernels line."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import cast_for_compute, init_params, prefill
    from repro_torch.serve import lm_engine

    phase("13 hybrid serving at full width: hymba-1.5b through "
          "repro_torch.serve.lm_engine, prefill attention on K6 and the "
          "selective scan on K7")
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = get_config(HY_ARCH)
    kinds = cfg.layer_kinds()
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
              cfg.head_dim_of, cfg.ssm.expand * cfg.d_model,
              cfg.ssm.d_state, cfg.window, cfg.d_ff, cfg.vocab,
              tuple(i for i, g in enumerate(kinds) if g))
    if widths != (32, 1600, 25, 5, 64, 3200, 16, 1024, 5504, 32001,
                  (0, 15, 31)):
        fail(f"{HY_ARCH} widths {widths} are not the published ones")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    bf16 = cast_for_compute(params, cfg, torch.bfloat16)
    n_params = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    print(f"{HY_ARCH}: {n_params} parameters ({n_params * 4 / 1e9:.3f} GB "
          f"float32, bfloat16 copies of the matrices beside them) made on "
          f"the card in {time.perf_counter() - t0:.2f} s", flush=True)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (HY_REQUESTS, HY_PROMPT), dtype=np.int64)
    run16 = dict(smax=HY_SMAX, compute_dtype=torch.bfloat16)
    swaps = {"K6": (lm_run_with, lm_plain_attention, lm_faulty_attention),
             "K7": (mb_run_with, mb_plain_scan, mb_faulty_scan)}

    # every request's solo prefill, K6's calls held one by one against the
    # plain version and the planted fault on the inputs the model gives
    # them; the whole prefill held against the plain versions swapped in:
    # K7's at LM_BF16_REL, K6's at twice the departure a bfloat16 roundoff
    # on attention's output gives (HY_ROUNDOFF_X); the cache rows and first
    # token kept for the splices
    solo, calls = {}, K6CallCheck()
    worst = {k: (0.0, 0.0) for k in swaps}
    fault_min = {k: float("inf") for k in swaps}
    limit = {"K7": LM_BF16_REL}
    yard_max = 0.0
    for rid in range(HY_REQUESTS):
        toks = torch.as_tensor(prompts[rid:rid + 1], device=dev)
        got = lm_run_with(calls, prefill, bf16, cfg, toks, **run16)
        for kname, (run_with, plain, faulty) in swaps.items():
            ref = run_with(plain, prefill, bf16, cfg, toks, **run16)
            if kname == "K6":
                yard = max(prefill_departure(run_with(
                    lm_roundoff_attention, prefill, bf16, cfg, toks,
                    **run16), ref))
                yard_max = max(yard_max, yard)
                limit["K6"] = HY_ROUNDOFF_X * yard
            dep = prefill_departure(got, ref)
            bad = prefill_departure(run_with(faulty, prefill, bf16, cfg,
                                             toks, **run16), ref)
            worst[kname] = tuple(max(w, g) for w, g in zip(worst[kname],
                                                            dep))
            fault_min[kname] = min(fault_min[kname], max(bad))
            if max(dep) > limit[kname]:
                fail(f"the bfloat16 prefill of request {rid} with {kname} "
                     f"departs from the plain version: {dep} above "
                     f"{limit[kname]}")
            if max(bad) <= limit[kname]:
                fail(f"{kname}'s planted fault passes the bfloat16 bound on "
                     f"request {rid}: {bad} (limit {limit[kname]})")
            del ref
        solo[rid] = (int(torch.argmax(got[0][0])),
                     {k: v[:, 0] for k, v in got[1].items() if k != "len"})
        del got
    if not (calls.n == HY_REQUESTS * cfg.n_layers
            and calls.worst <= LM_BF16_REL < calls.fault_min):
        fail(f"K6's {calls.n} calls in the bfloat16 prefills against its "
             f"plain version on the same inputs: largest relative error "
             f"norm {calls.worst}, the planted fault's smallest "
             f"{calls.fault_min} (limit {LM_BF16_REL})")
    print(f"bfloat16 prefills ({HY_PROMPT} tokens), K6's {calls.n} calls "
          f"each against its plain version on the inputs the model gave "
          f"it: largest relative error norm {calls.worst:.3e} (limit "
          f"{LM_BF16_REL}), the planted fault at least "
          f"{calls.fault_min:.3e}; the whole prefill, K6 against the plain "
          f"version swapped in: logits {worst['K6'][0]:.3e}, over the cache "
          f"leaves {worst['K6'][1]:.3e}, where a relative 2^-9 Gaussian "
          f"(a bfloat16 roundoff) on the plain version's output departs by "
          f"up to {yard_max:.3e} (limit {HY_ROUNDOFF_X} times that, request "
          f"by request), the planted fault at least "
          f"{fault_min['K6']:.3e}", flush=True)
    print(f"bfloat16 prefills ({HY_PROMPT} tokens), K7 against its plain "
          f"version: largest relative error norm logits "
          f"{worst['K7'][0]:.3e}, over the cache leaves "
          f"{worst['K7'][1]:.3e} (limit {LM_BF16_REL}); its planted fault "
          f"at least {fault_min['K7']:.3e}", flush=True)
    # float32 at full width, request 0
    toks = torch.as_tensor(prompts[:1], device=dev)
    run32 = dict(smax=HY_SMAX, compute_dtype=torch.float32)
    got = prefill(params, cfg, toks, **run32)
    for kname, (run_with, plain, _) in swaps.items():
        rel32 = prefill_departure(got, run_with(plain, prefill, params, cfg,
                                                toks, **run32))
        print(f"float32 prefill of request 0 at full width, {kname} "
              f"against its plain version: relative error norm logits "
              f"{rel32[0]:.3e}, over the cache leaves {rel32[1]:.3e} "
              f"(limit {LM_F32_REL})", flush=True)
        if max(rel32) > LM_F32_REL:
            fail(f"the float32 prefill with {kname} departs from the plain "
                 f"version: {rel32} above {LM_F32_REL}")
    del got

    def engine():
        eng = lm_engine.ServeEngine(cfg, bf16, slots=HY_SLOTS, smax=HY_SMAX,
                                    compute_dtype=torch.bfloat16, device=dev)
        for rid in range(HY_REQUESTS):
            eng.submit(lm_engine.Request(rid, prompts[rid], max_new=HY_NEW))
        return eng

    want = HY_REQUESTS * cfg.n_layers
    served = lm_served_report(
        f"{HY_ARCH} ({HY_PROMPT}-token prompts)", card, engine, HY_REQUESTS,
        HY_NEW, HY_SLOTS, {"k6": ("flash_attention_kernel", want),
                           "k7": ("mamba_scan_kernel", want)}, cfg.vocab,
        solo)
    del params, bf16, solo
    free_device_memory()

    k6 = k6_served_shape(dev, card, f"{HY_ARCH}, a local layer",
                         cfg.n_heads, cfg.n_kv, HY_PROMPT, cfg.head_dim_of,
                         cfg.window)
    k7 = k7_served_shape(dev, card, HY_ARCH, (
        1, HY_PROMPT, cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state))
    peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory in phase 13 {peak} bytes "
          f"({peak / 2 ** 30:.2f} GiB; {(peak - held) / 2 ** 30:.2f} GiB "
          f"above the {held} bytes the earlier phases hold)", flush=True)
    n6, n7 = served["launches"]["k6"], served["launches"]["k7"]
    return ({"hymba_launches": n6, "hymba_ms": k6["ms"],
             "hymba_call_ms": k6["call_ms"],
             "hymba_served_ms": served["device_ms"]["k6"] / n6,
             "hymba_bound_ms": k6["bound_ms"],
             "hymba_library_ms": k6["library_ms"],
             "hymba_library_call_ms": k6["library_call_ms"]},
            {"hymba_launches": n7, "hymba_ms": k7["ms"],
             "hymba_call_ms": k7["call_ms"],
             "hymba_served_ms": served["device_ms"]["k7"] / n7,
             "hymba_bound_ms": k7["bound_ms"]})


#: phase 14: tests/test_lm_idioms.py's mining settings with no time budget
#: (a budget makes the mined patterns depend on the host's load), and the
#: idiom patterns applied through K4 from each graph's ranked list
IDIOM_MINING = dict(min_support=2, max_pattern_nodes=5,
                    max_patterns_per_level=40, time_budget_s=float("inf"))
IDIOM_PICKS = 5


def k4_library_call(prog, xs):
    """One torch call computing a lowered PE pattern, where there is one:
    a binary op or mul -> add over the inputs (``torch.addcmul``)."""
    import torch
    body = [(st.op, st.args) for st in prog.stmts]
    one = {"add": torch.add, "mul": torch.mul, "max": torch.maximum}
    if len(body) == 1 and body[0][0] in one and body[0][1] == ("p0", "p1"):
        return lambda: one[body[0][0]](xs[0], xs[1])
    if [op for op, _ in body] == ["mul", "add"] \
            and body[0][1] == ("p0", "p1") \
            and body[1][1] == (prog.stmts[0].dst, "p2"):
        return lambda: torch.addcmul(xs[2], xs[0], xs[1])
    return None


def valued(pattern, graph):
    """``pattern`` with each mined constant given the value it has at the
    pattern's first occurrence in ``graph`` (a mined pattern carries no
    constant values, and K4 bakes a missing one as 0.0)."""
    from repro_torch.core.isomorphism import find_embeddings
    emb = find_embeddings(pattern, graph, max_embeddings=1)
    if not emb:
        fail("a mined pattern does not occur in the graph it came from")
    filled = pattern.copy()
    for n, op in filled.nodes.items():
        if op == "const":
            filled.attrs.setdefault(n, {})["value"] = graph.attr(
                emb[0].mapping[n], "value")
    return filled


def lm_idiom_phase(dev, card) -> dict:
    """Phase 14: the four LM idiom graphs traced on the card with the
    port's ``trace_fn`` (equal to the CPU trace by ``canonical_label``),
    mined with no time budget, and the first PE-compatible ranked
    patterns of each applied through K4 at the Llama 3.2 1B MLP
    activation with their constants valued as in the graph, counted,
    held to the plain version and to the float64 oracle, every output
    finite, K4 timed at the largest."""
    import numpy as np
    import torch
    from repro_torch.apps.lm import lm_idiom_graphs
    from repro_torch.core import MiningConfig, mine_and_rank
    from repro_torch.core.merge import is_pe_pattern
    from repro_torch.graphir.graph import free_in_ports
    from repro_torch.kernels import fused_pe_apply, pe_fused
    from repro_torch.kernels.ref import ref_pe

    phase("14 LM idioms on K4: repro_torch.apps.lm traced on the card, "
          "mined, applied through fused_pe_apply")
    t0 = time.perf_counter()
    graphs = lm_idiom_graphs(device=dev)
    host = lm_idiom_graphs(device="cpu")
    for name, g in graphs.items():
        if g.canonical_label() != host[name].canonical_label():
            fail(f"the card's trace of {name} differs from the CPU's")
        if "opaque" in g.op_histogram():
            fail(f"{name} traced with an unmapped op: {g.op_histogram()}")
    picks = []
    for name, g in sorted(graphs.items()):
        ranked = mine_and_rank(g, MiningConfig(**IDIOM_MINING))
        pe = [m for m in ranked if is_pe_pattern(m.pattern)][:IDIOM_PICKS]
        print(f"{name}: {g.num_nodes()} nodes, {g.num_compute_nodes()} "
              f"compute, {len(ranked)} ranked patterns, {len(pe)} applied",
              flush=True)
        picks += [(f"{name}#{i}", valued(m.pattern, g))
                  for i, m in enumerate(pe)]
    print(f"traced and mined in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if not picks:
        fail("no PE-compatible LM idiom was mined")
    shape = (TOKENS, D_FF)
    gen = torch.Generator(device=dev).manual_seed(14)
    n_max = max(len(free_in_ports(p)) for _, p in picks)
    pool = [torch.rand(shape, generator=gen, device=dev) * 0.9 + 0.1
            for _ in range(n_max)]
    pe_fused.pe_apply.launches = 0
    outs = [fused_pe_apply(p, *pool[:len(free_in_ports(p))])
            for _, p in picks]
    torch.cuda.synchronize()
    n = pe_fused.pe_apply.launches
    if n != len(picks):
        fail(f"K4 launched {n} times for {len(picks)} LM idioms")
    err, n_out = 0.0, 0
    small = torch.rand((64, 128), generator=gen, device=dev) * 0.9 + 0.1
    for (label, pat), got in zip(picks, outs):
        n_in = len(free_in_ports(pat))
        want = pe_fused.pe_apply_plain(pat, *pool[:n_in])
        xs = [small * (i + 1) / n_in for i in range(n_in)]
        got_small = fused_pe_apply(pat, *xs)
        oracle = ref_pe(pat, *[x.cpu().numpy() for x in xs])
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got, want)]):
            # finite everywhere, so that the comparison holds K4 to a value
            if not bool(torch.isfinite(w).all()):
                fail(f"the plain version of {label} is not finite "
                     f"everywhere")
            if not bool(torch.isclose(g, w, rtol=K4_TOL, atol=K4_TOL).all()):
                fail(f"K4 differs from its plain version on {label}")
            err = max(err, float((g.double() - w.double()).abs().max()))
            n_out += 1
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got_small, oracle)]):
            w = torch.as_tensor(w, device=dev).double().expand(g.shape)
            if not bool(torch.isfinite(w).all()) or not bool(torch.isclose(
                    g.double(), w, rtol=K4_TOL, atol=K4_TOL).all()):
                fail(f"K4 differs from the float64 oracle on {label}")
    print(f"K4 applied {n} LM idioms ({n_out} outputs, every one finite "
          f"everywhere; constants valued as in the graph) at {shape} "
          f"float32, each == plain at {K4_TOL} (max |diff| {err:.3e}) and "
          f"== the float64 oracle on (64, 128)", flush=True)
    label, pat = max(picks, key=lambda lp: (
        pe_fused.lower_pattern(lp[1]).n_in
        + len(pe_fused.lower_pattern(lp[1]).outs),
        pe_fused.lower_pattern(lp[1]).n_compute, lp[0]))
    prog = pe_fused.lower_pattern(pat)
    xs = pool[:prog.n_in]
    fn = pe_fused.make_pe_kernel(pat)
    ms = cuda_ms(lambda: fn(*xs), 20)
    plain_ms = cuda_ms(lambda: pe_fused.pe_apply_plain(pat, *xs), 5)
    lib = k4_library_call(prog, xs)
    lib_ms = cuda_ms(lib, 20) if lib else None
    byts = (prog.n_in + len(prog.outs)) * 4 * pool[0].numel()
    ops = prog.n_compute * pool[0].numel()
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(t_b, t_o)
    print(card)
    print(f"K4 at the largest LM idiom {label} ({prog.n_in} in, "
          f"{len(prog.outs)} out, {prog.n_compute} ops, "
          f"{[s.op for s in prog.stmts]}): {ms:.4f} ms against a bound of "
          f"{bound_ms:.4f} ms ({'bytes' if t_b >= t_o else 'operations'}; "
          f"{100 * bound_ms / ms:.1f}%), plain {plain_ms:.4f} ms, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}", flush=True)
    return {"idiom_launches": n, "idiom_max_abs_err": err, "idiom_ms": ms,
            "idiom_plain_ms": plain_ms, "idiom_bound_ms": bound_ms,
            "idiom_library_ms": lib_ms, "idiom_pattern": label}


#: phase 15: src/repro_torch/configs/llama3_2_1b.py unreduced, trained on
#: SyntheticLM batches of 8 x 512 tokens, as the launcher trains it
TR_ARCH, TR_BATCH, TR_SEQ, TR_STEPS = "llama3.2-1b", 8, 512, 10
#: relative error norm of the loss and of every leaf's gradient, one
#: bfloat16 train step with K6 against the same step with K6's plain
#: version swapped in.  Both backwards are the plain version; what
#: differs is K6's forward, 2^-9 of an output in bfloat16 (phase 10), fed
#: through 16 layers forward and back
TR_BF16_REL = 2.0 ** -4
#: traced windows of 3 steps in phase 15 (c)
TR_TRACE_WINDOWS = 3
#: phase 15's chunked cross entropy (perf flag ce_impl="chunked"): chunks
#: of this many positions, 4 over a 512-token sequence's 511 predictions
TR_CE_CHUNK = 128


def k6_without_autograd(q, k, v, **kw):
    """The planted fault of phase 15 (a): K6 launched with no autograd
    Function (its operands detached), as a ctypes launch into a fresh
    buffer is seen by autograd."""
    from repro_torch.kernels import flash_attention
    return flash_attention(q.detach(), k.detach(), v.detach(), **kw)


def grad_departures(got, want) -> dict:
    """``{leaf name: ||got - want|| / ||want||}`` over two gradient trees
    (a stacked leaf's layers together), and the leaves whose ``want`` is
    nonzero where ``got`` is all zero, under the key ``"zero"``."""
    import torch
    from repro_torch.models.tree import leaves
    diff, ref, nonzero, zero = {}, {}, {}, []
    for a, b in zip(leaves(got), leaves(want)):
        d = float(torch.sum(torch.square(a.value.double()
                                         - b.value.double())))
        r = float(torch.sum(torch.square(b.value.double())))
        diff[a.name] = diff.get(a.name, 0.0) + d
        ref[a.name] = ref.get(a.name, 0.0) + r
        if r > 0 and not bool(a.value.any()):
            zero.append(f"{a.name}[{a.index}]")
    rel = {k: (diff[k] / ref[k]) ** 0.5 if ref[k] else diff[k] ** 0.5
           for k in diff}
    rel["zero"] = zero
    return rel


def train_check(loss, ref_loss, rel) -> list:
    """What phase 15 (a) finds wrong in a step's loss and gradients."""
    bad = [] if not rel["zero"] else [f"zero gradients: {rel['zero'][:4]}"]
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    if loss_rel > TR_BF16_REL:
        bad.append(f"loss {loss} against {ref_loss}")
    bad += [f"{k} {v:.3e}" for k, v in rel.items()
            if k != "zero" and v > TR_BF16_REL]
    return bad


def train_phase(dev, card) -> tuple:
    """Phase 15: Llama 3.2 1B trained at full width on the card: (a) one
    step with K6 against one with K6's plain version, and the planted
    fault; (b) the ten configurations' reduced train step card == CPU;
    (c) ms a step, tokens/s, peak memory and busy share, K6 counted in
    the trace; ``python -m repro_torch.launch.train`` for 10 steps and
    its checkpoint restored; (d) the trainer's fault injection.  Returns
    the K6 and K7 keys of the kernels line."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from torch.nn.functional import scaled_dot_product_attention
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention, mamba_scan
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.models.tree import leaves
    from repro_torch.train import (AdamWConfig, build_train_step,
                                   init_opt_state, lm_loss)

    phase("15 training at full width: Llama 3.2 1B through "
          "repro_torch.train, K6 under autograd")
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = get_config(TR_ARCH)
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
              cfg.head_dim_of, cfg.d_ff, cfg.vocab)
    if widths != (16, 2048, 32, 8, 64, 8192, 128256):
        fail(f"{TR_ARCH} widths {widths} are not the published ones")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_params = sum(leaf.value.numel() for leaf in leaves(params))
    data = DataConfig(vocab=cfg.vocab, seq_len=TR_SEQ,
                      global_batch=TR_BATCH, seed=0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in SyntheticLM(data).batch_at(0).items()}
    # the launcher's optimizer at TR_STEPS steps
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=max(10, TR_STEPS // 20),
                          total_steps=TR_STEPS)
    opt = init_opt_state(params, opt_cfg)

    # (a) K6 against its plain version, and the planted fault
    def grads_with(attn):
        """One step's loss, gradients and K6 launches, with ``attn`` in
        place of the model's K6 wrapper (None: K6 itself)."""
        seen = {}

        def capture(g):
            seen["g"] = g
            return g
        step = build_train_step(cfg, opt_cfg, grad_transform=capture)
        flash_attention.launches = 0
        if attn is None:
            _, _, metrics = step(params, opt, batch)
        else:
            _, _, metrics = lm_run_with(attn, step, params, opt, batch)
        torch.cuda.synchronize()
        return (float(metrics["loss"]), seen["g"],
                flash_attention.launches)
    loss_k6, g_k6, n_k6 = grads_with(None)
    loss_p, g_p, n_p = grads_with(lm_plain_attention)
    if (n_k6, n_p) != (cfg.n_layers, 0):
        fail(f"K6 launched {n_k6} times in a train step (plain: {n_p}), "
             f"not once a layer ({cfg.n_layers})")
    rel = grad_departures(g_k6, g_p)
    bad = train_check(loss_k6, loss_p, rel)
    worst = max((v, k) for k, v in rel.items() if k != "zero")
    print(f"bfloat16 train step at full width, K6 against its plain "
          f"version: loss {loss_k6:.6f} against {loss_p:.6f} (relative "
          f"{abs(loss_k6 - loss_p) / abs(loss_p):.3e}), largest relative "
          f"error norm of a leaf's gradient {worst[0]:.3e} ({worst[1]}), "
          f"q/k/v: "
          f"{', '.join(f'{k} {rel[k]:.3e}' for k in ('layers__wq', 'layers__wk', 'layers__wv'))}"
          f" (limit {TR_BF16_REL} each)", flush=True)
    if bad:
        fail(f"the train step with K6 departs from the plain version: "
             f"{bad[:6]}")
    del g_k6
    loss_f, g_f, _ = grads_with(k6_without_autograd)
    rel_f = grad_departures(g_f, g_p)
    bad_f = train_check(loss_f, loss_p, rel_f)
    if not bad_f:
        fail("the planted fault (K6 with no autograd Function) passes "
             "phase 15 (a)")
    print(f"the planted fault (K6 launched with no autograd Function) "
          f"fails it: {len(rel_f['zero'])} leaves with zero gradients "
          f"({rel_f['zero'][:3]} ...), q/k/v relative error norm "
          f"{rel_f['layers__wq']:.3e}", flush=True)
    del g_f, g_p
    free_device_memory()

    # (b) the ten configurations' reduced train step, card == CPU
    mod = lm_gpu_tests()
    k7_reduced = 0
    for arch in mod.ARCHS:
        mamba_scan.launches = 0
        err = mod.train_card_vs_cpu(arch, dev)
        k7_reduced += mamba_scan.launches
        print(f"{arch} reduced: one float32 train step card == CPU within "
              f"{mod.TOL} (loss, grad_norm, lr, every gradient, updated "
              f"leaf and moment; max |grad diff| {err:.3e})", flush=True)

    # (c) a step's time, tokens/s, peak memory and busy share
    step = build_train_step(cfg, opt_cfg)
    state = [params, opt]

    def steps(n):
        for _ in range(n):
            state[0], state[1], _ = step(state[0], state[1], batch)
        torch.cuda.synchronize()
    steps(2)                                      # warm-up
    t0 = time.perf_counter()
    steps(5)
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    flash_attention.launches = 0
    with torch.no_grad():
        lm_loss(state[0], cfg, batch)
    torch.cuda.synchronize()
    fwd_k6 = flash_attention.launches

    # The profiler loses device records in bursts, never adds one
    # (tools/k6_trace_count.py: in this script's process 3 of 6 windows of
    # these 3 steps lost 201 to 2,024 of their 38,138 events, most in the
    # last step's backward and optimizer; whole runs lost events in 4 of 4
    # windows, and with the steps synchronized in 3 of 4).  So each of
    # TR_TRACE_WINDOWS windows holds no more K6 events than the counter,
    # at least one holds all of them, and the busy share is read from the
    # window with the most device events
    def traced():
        t = time.perf_counter()
        steps(3)
        return time.perf_counter() - t
    seen = []
    for _ in range(TR_TRACE_WINDOWS):
        flash_attention.launches = 0
        wall, kern, busy_ms = device_kernels(traced)
        seen.append((sum(len(v) for v in kern.values()),
                     launches_of(kern, "flash_attention_kernel"),
                     flash_attention.launches, wall, busy_ms))
    want = 3 * cfg.n_layers
    if fwd_k6 != cfg.n_layers or any(c != want or t > c
                                     for _, t, c, _, _ in seen) \
            or max(t for _, t, _, _, _ in seen) != want:
        fail(f"K6 in 3 traced steps, each window's (device events, in the "
             f"trace, counted): {[w[:3] for w in seen]}, {fwd_k6} in a "
             f"forward; want {cfg.n_layers} a step, all in the forward")
    _, _, _, wall, busy_ms = max(seen)
    print(f"{TR_TRACE_WINDOWS} traced windows of 3 steps, each (device "
          f"events, K6 in the trace, K6 counted): "
          f"{[w[:3] for w in seen]}", flush=True)
    busy = busy_ms / (wall * 1e3)
    tokens = TR_BATCH * TR_SEQ
    peak = torch.cuda.max_memory_allocated()
    del state
    free_device_memory()
    flagged = train_flags_check(dev, card, cfg, opt_cfg, params, opt, batch)
    del params, opt
    free_device_memory()

    # K6 at the training shape, and the plain backward it runs
    hd = cfg.head_dim_of
    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn((TR_BATCH, h, TR_SEQ, hd), generator=gen,
                           device=dev, dtype=torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv, cfg.n_kv))
    g_out = torch.randn_like(q)
    # K6 and SDPA at the device's pace (queued behind a sleep: back to
    # back, a 0.1 ms launch is paced by the host)
    k6_ms = queued_ms(lambda: flash_attention(q, k, v, causal=True))
    fwd_plain = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 5)
    lib_ms = queued_ms(lambda: scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def plain_backward():
        with torch.enable_grad():
            out = attention_plain(qg, kg, vg, causal=True)
            return torch.autograd.grad(out, (qg, kg, vg), g_out)
    bwd_ms = cuda_ms(plain_backward, 5)
    pairs = TR_SEQ * (TR_SEQ + 1) // 2
    ops = 4 * hd * cfg.n_heads * TR_BATCH * pairs
    byts = 2 * nbytes(q) + nbytes(k, v)
    k6_bound = max(ops / BF16_OPS_PER_S, byts / HBM_BYTES_PER_S) * 1e3
    share = cfg.n_layers * bwd_ms / step_ms
    print(card)
    print(f"training {TR_ARCH} at full width ({n_params} parameters, "
          f"float32 masters, bfloat16 compute and moments, batch "
          f"{TR_BATCH} x {TR_SEQ}): {step_ms:.1f} ms a step, "
          f"{tokens / step_ms * 1e3:.0f} tokens/s, peak device memory "
          f"{peak} bytes ({peak / 2 ** 30:.2f} GiB; {held} bytes held "
          f"before), device busy {100 * busy:.1f}% of 3 traced steps "
          f"({busy_ms:.1f} ms of {wall * 1e3:.1f} ms)", flush=True)
    print(f"K6 at the training shape ({TR_BATCH}, {cfg.n_heads}/{cfg.n_kv}, "
          f"{TR_SEQ}, {hd}) bfloat16 causal: {k6_ms:.4f} ms (queued behind "
          f"a sleep) against a bound "
          f"of {k6_bound:.4f} ms, its plain version {fwd_plain:.4f} ms, "
          f"scaled_dot_product_attention {lib_ms:.4f} ms; the plain "
          f"backward (recompute + autograd) {bwd_ms:.4f} ms a layer, "
          f"{cfg.n_layers} a step: {100 * share:.1f}% of a step; "
          f"{cfg.n_layers} K6 launches a step, all in the forward",
          flush=True)
    del q, k, v, qg, kg, vg, g_out
    # K7's plain backward at falcon-mamba-7b's served shape (phase 11)
    gen = torch.Generator(device=dev).manual_seed(16)
    shape = (1, 512, 8192, 16)
    a = (torch.rand(shape, generator=gen, device=dev) * 0.399 + 0.6
         ).requires_grad_()
    bx = (torch.randn(shape, generator=gen, device=dev) * 0.1
          ).requires_grad_()
    c = torch.randn((1, 512, 16), generator=gen, device=dev
                    ).requires_grad_()
    gy = torch.randn((1, 512, 8192), generator=gen, device=dev)

    def k7_plain_backward():
        with torch.enable_grad():
            y = mamba_scan_plain(a, bx, c)
            return torch.autograd.grad(y, (a, bx, c), gy)
    k7_bwd_ms = cuda_ms(k7_plain_backward, 2)
    print(f"K7's plain backward at {shape} float32 (recompute + autograd): "
          f"{k7_bwd_ms:.2f} ms", flush=True)
    del a, bx, c, gy
    free_device_memory()

    # the launcher's run for TR_STEPS steps (it writes one checkpoint at
    # its end), then one checkpoint of its state written, restored and
    # compared, each timed
    from repro_torch.checkpoint import save_checkpoint
    tmp = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        flash_attention.launches = 0
        t0 = time.perf_counter()
        tr = launch_train.run(launch_train.parser().parse_args(
            ["--arch", TR_ARCH, "--steps", str(TR_STEPS), "--batch",
             str(TR_BATCH), "--seq", str(TR_SEQ), "--ckpt-dir", tmp]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        n_launcher = flash_attention.launches
        if (tr.state.step, tr.state.restarts, latest_step(tmp)) != \
                (TR_STEPS, 0, TR_STEPS):
            fail(f"the launcher stopped at step {tr.state.step} with "
                 f"{tr.state.restarts} restarts, latest checkpoint "
                 f"{latest_step(tmp)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if n_launcher != TR_STEPS * cfg.n_layers:
        fail(f"K6 launched {n_launcher} times in {TR_STEPS} launcher steps")
    losses = [h["loss"] for h in tr.history]
    if not all(np.isfinite(losses)):
        fail(f"the launcher's losses {losses}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    like = {"params": tr.params, "opt": tr.opt_state}
    try:
        t0 = time.perf_counter()
        save_checkpoint(tmp, TR_STEPS, like)
        save_s = time.perf_counter() - t0
        step_dir = os.path.join(tmp, f"step_{TR_STEPS:08d}")
        size = sum(os.path.getsize(os.path.join(step_dir, f))
                   for f in os.listdir(step_dir))
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        back = restore_checkpoint(tmp, TR_STEPS, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0

        checked = 0
        for a, b in zip(leaves(like), leaves(back)):
            if a.name in ("params__embed", "params__final_norm",
                          "opt__m__layers__wq", "opt__v__layers__wd",
                          "opt__step") or (a.name == "params__layers__wq"
                                           and a.index in (0, 15)):
                if a.value.device != b.value.device or \
                        not equal_bits(a.value, b.value):
                    fail(f"checkpoint leaf {a.name}[{a.index}] differs")
                checked += 1
        print(f"repro_torch.launch.train's run at full width, {TR_STEPS} "
              f"steps: {run_s:.1f} s with its checkpoint, losses "
              f"{[round(x, 4) for x in losses]}, {n_launcher} K6 launches "
              f"({cfg.n_layers} a step); a checkpoint of its step "
              f"{TR_STEPS}: {size} bytes written in {save_s:.1f} s, restored "
              f"in {restore_s:.1f} s, {checked} leaves bit-equal; {free} "
              f"bytes free on its disk", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del tr, like, back
    free_device_memory()

    # (d) the trainer's fault injection on the card
    tmp = tempfile.mkdtemp(prefix="repro_torch_fault_")
    try:
        tr = mod.trainer_fault_run(tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"fault injection at step 12 on the card: {tr.state.restarts} "
          f"restart, step {tr.state.step}, latest checkpoint 20, losses "
          f"{[round(h['loss'], 4) for h in tr.history]}", flush=True)
    k6 = {"train_launches": n_launcher, "train_ms": k6_ms,
          "train_plain_ms": fwd_plain, "train_bound_ms": k6_bound,
          "train_library_ms": lib_ms, "train_backward_plain_ms": bwd_ms,
          "train_step_ms": step_ms, **flagged}
    k7 = {"train_launches": k7_reduced,
          "train_backward_plain_ms": k7_bwd_ms}
    return k6, k7


def train_flags_check(dev, card, cfg, opt_cfg, params, opt, batch) -> dict:
    """Phase 15's perf-flag variants at full width: the train step with
    ``ce_impl="chunked"`` (TR_CE_CHUNK positions a chunk) against the
    default step, the loss and every leaf's gradient within TR_BF16_REL,
    K6 once a layer, ms a step in turns and each step's peak device
    memory; then one forward with ``norm_dtype="bf16"`` against the
    default forward within TR_BF16_REL."""
    import torch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import forward
    from repro_torch.models.perf_flags import reset_flags, set_flags
    from repro_torch.train import build_train_step
    chunked = dict(ce_impl="chunked", ce_chunk=TR_CE_CHUNK)

    def step_with(flags, capture=None, fresh=True):
        """One step under ``flags``: (loss, K6 launches, peak bytes above
        what was held before, ms).  ``fresh``: the allocator's cache
        emptied first (a fair peak; the step then pays its allocations)."""
        set_flags(**flags)
        try:
            if fresh:
                free_device_memory()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            flash_attention.launches = 0
            step = build_train_step(cfg, opt_cfg, grad_transform=capture)
            t0 = time.perf_counter()
            _, _, metrics = step(params, opt, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            return (loss, flash_attention.launches,
                    torch.cuda.max_memory_allocated() - base,
                    (time.perf_counter() - t0) * 1e3)
        finally:
            reset_flags()
    grads = {}
    for name, flags in (("full", {}), ("chunked", chunked)):
        def capture(g, name=name):
            grads[name] = g
            return g
        grads[name + "_run"] = step_with(flags, capture)
    loss_c, n_c = grads["chunked_run"][:2]
    loss_f = grads["full_run"][0]
    if n_c != cfg.n_layers:
        fail(f"K6 launched {n_c} times in the chunked-CE step, not once a "
             f"layer ({cfg.n_layers})")
    rel = grad_departures(grads["chunked"], grads["full"])
    bad = train_check(loss_c, loss_f, rel)
    worst = max((v, k) for k, v in rel.items() if k != "zero")
    if bad:
        fail(f"the chunked-CE step departs from the default step: {bad[:6]}")
    del grads["chunked"], grads["full"]
    # the peaks, each step from an emptied allocator cache; then the ms a
    # step in turns, the cache warm
    peaks = {w: step_with(f)[2] for w, f in (("full", {}),
                                             ("chunked", chunked))}
    times = {"full": [], "chunked": []}
    for which in ("full", "chunked", "chunked", "full") * 2:
        times[which].append(step_with(
            chunked if which == "chunked" else {}, fresh=False)[3])
    n_chunks = -(-(TR_SEQ - 1) // TR_CE_CHUNK)
    logits_bytes = TR_BATCH * TR_SEQ * cfg.vocab * 4
    print(card)
    print(f"chunked cross entropy (ce_impl=\"chunked\", {n_chunks} chunks "
          f"of {TR_CE_CHUNK}) in {TR_ARCH}'s full-width train step against "
          f"the default: loss {loss_c:.6f} against {loss_f:.6f}, largest "
          f"relative error norm of a leaf's gradient {worst[0]:.3e} "
          f"({worst[1]}; limit {TR_BF16_REL}); {n_c} K6 launches; "
          f"{sum(times['chunked']) / 4:.1f} ms a step against "
          f"{sum(times['full']) / 4:.1f} ms (in turns: "
          f"{[round(t, 1) for t in times['chunked']]} against "
          f"{[round(t, 1) for t in times['full']]}); peak device memory "
          f"above the weights and moments {peaks['chunked']} bytes "
          f"against {peaks['full']} ({(peaks['full'] - peaks['chunked']) / 2 ** 30:.2f} "
          f"GiB less; the float32 logits alone {logits_bytes} bytes)",
          flush=True)
    # the bfloat16 norm
    with torch.no_grad():
        want = forward(params, cfg, batch["inputs"])
        set_flags(norm_dtype="bf16")
        try:
            got = forward(params, cfg, batch["inputs"])
        finally:
            reset_flags()
    norm_rel = rel_norms(got, want)[0]
    differ = not equal_bits(got, want)
    del got, want
    print(f"bfloat16 RMSNorm (norm_dtype=\"bf16\") in the full-width "
          f"forward: logits' relative error norm {norm_rel:.3e} against the "
          f"float32 norm (limit {TR_BF16_REL}); bits differ: {differ}",
          flush=True)
    if norm_rel > TR_BF16_REL or not differ:
        fail(f"the bfloat16 norm's forward: relative error norm "
             f"{norm_rel}, bits differ {differ}")
    return {"ce_chunked_launches": n_c,
            "ce_chunked_step_ms": sum(times["chunked"]) / 4,
            "ce_full_step_ms": sum(times["full"]) / 4,
            "ce_chunked_peak_bytes": peaks["chunked"],
            "ce_full_peak_bytes": peaks["full"]}


#: phase 16: the distribution layer (repro_torch.sharding, moe_mlp_shardmap).
#: (a) phase 15's unreduced setup, one step with the int8 all-reduce over a
#: one-rank NCCL group; (b) DIST_RANKS processes sharing the card over gloo,
#: each with one Llama 3.2 1B decoder layer's gradient tree from seed
#: DIST_SEED + rank; (d) one qwen2-moe-a2.7b MoE layer
#: (src/repro_torch/configs/qwen2_moe_a2_7b.py unreduced) on 512 tokens as
#: DIST_MOE_X rows; (e) Llama 3.2 1B's 16 decoder layers as one GPipe stage,
#: DIST_MICRO microbatches of DIST_MB x 512 tokens
DIST_RANKS, DIST_SEED = 4, 1000
DIST_MOE_ARCH, DIST_MOE_X = "qwen2-moe-a2.7b", (4, 128)
DIST_MICRO, DIST_MB = 4, 2
#: (d) the one-rank card run in float32 against the CPU's (rtol = atol),
#: and the 4 ranks' against the one rank's by relative error norm: the
#: all-reduced partial sums add in another order
DIST_MOE_TOL, DIST_MOE_REL = 1e-4, 1e-5
#: (c) the quantization error is at most half a step of its block's scale;
#: float32 rounds the quotient and the product by at most 127 * 2^-23 of a
#: step, inside the 2^-12 allowed here
DIST_ERR_STEPS = 0.5 + 2.0 ** -12
#: seconds for the process groups' collectives and for the 4 ranks to end
DIST_TIMEOUT_S = 300


def layer_grads(shapes: dict, rank: int) -> dict:
    """(b) a decoder layer's gradient tree, float32 on the host, from seed
    DIST_SEED + rank: normal values, each leaf and each rank at its own
    scale."""
    import numpy as np
    rng = np.random.default_rng(DIST_SEED + rank)
    return {k: rng.standard_normal(shape, dtype=np.float32)
            * np.float32(1e-3 * (i + 1) * (rank + 1))
            for i, (k, shape) in enumerate(sorted(shapes.items()))}


def np_compressed_mean(shards: list):
    """The JAX package's ``compressed_psum`` arithmetic in numpy over the
    ranks' host copies of one leaf: a shared block max, round half to
    even, an int32 sum, ``q * scale / n``."""
    import numpy as np
    n = shards[0].size
    blocks = [np.pad(s.reshape(-1), (0, (-n) % 256)).reshape(-1, 256)
              for s in shards]
    shared = np.max([np.abs(b).max(axis=-1, keepdims=True)
                     for b in blocks], axis=0)
    scale = np.maximum(shared / np.float32(127.0), np.float32(1e-12))
    qsum = sum(np.clip(np.round(b / scale), -127, 127).astype(np.int8)
               .astype(np.int32) for b in blocks)
    mean = qsum.astype(np.float32) * scale / np.float32(len(shards))
    return mean.reshape(-1)[:n].reshape(shards[0].shape)


def moe_layer(dev, dtype, moe_shapes: dict, x_shape: tuple):
    """(d) one MoE layer's leaves and its input from seed 0 on ``dev``,
    rounded to bfloat16 and held in ``dtype``: normal values over the
    square root of the fan-in, the same on every process."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {}
    for k, shape in sorted(moe_shapes.items()):
        fan = shape[-2] if len(shape) > 1 else shape[0]
        params[k] = (torch.randn(shape, generator=gen, device=dev)
                     / fan ** 0.5).to(torch.bfloat16).to(dtype)
    x = torch.randn(x_shape, generator=gen, device=dev)
    return x.to(torch.bfloat16).to(dtype), params


def dist_rank(rank, store_path, out_dir, dev_type, grad_shapes, moe_shapes,
              x_shape, moe) -> None:
    """Phase 16 (b) and (d) on one of DIST_RANKS processes that share the
    card over gloo: the compressed all-reduce of this rank's layer
    gradients, then ``moe_mlp_shardmap`` with E_pad / DIST_RANKS experts
    a rank; saves both (on the host) to ``out_dir``."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    try:
        from repro_torch.models.moe import moe_mlp_shardmap
        from repro_torch.sharding.compression import compressed_psum
        dev = torch.device(dev_type)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, DIST_RANKS), rank=rank,
            world_size=DIST_RANKS,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        try:
            world = dist.group.WORLD
            grads = {k: torch.from_numpy(v).to(dev)
                     for k, v in layer_grads(grad_shapes, rank).items()}
            reduced = {k: compressed_psum(v, world)
                       for k, v in grads.items()}
            x, params = moe_layer(dev, torch.float32, moe_shapes, x_shape)
            y = moe_mlp_shardmap(x, params, moe, world)
            out = {"b": {k: v.cpu() for k, v in reduced.items()},
                   "d": y.cpu(),
                   "devices": sorted({str(v.device) for v in
                                      list(reduced.values()) + [y]})}
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_dist_ranks(tmp: str, *args) -> list:
    """:func:`dist_rank` on DIST_RANKS spawned processes; fails unless
    every one ends within DIST_TIMEOUT_S with its result saved."""
    import multiprocessing as mp
    import torch
    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir)
    store = os.path.join(tmp, "gloo_store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(r, store, out_dir) + args)
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    for r in range(DIST_RANKS):
        err = os.path.join(out_dir, f"{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                fail(f"rank {r} of {DIST_RANKS} failed:\n{f.read()}")
    if hung:
        fail(f"ranks {hung} of {DIST_RANKS} still ran after "
             f"{DIST_TIMEOUT_S} s")
    if any(p.exitcode != 0 for p in procs):
        fail(f"the ranks' exit codes {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(out_dir, f"{r}.pt"))
            for r in range(DIST_RANKS)]


def distribution_phase(dev, card) -> dict:
    """Phase 16: the distribution layer on ``torch.distributed``: (a) the
    int8 gradient all-reduce (``make_compressed_grad_transform``) inside
    Llama 3.2 1B's full-width train step over a one-rank NCCL group, every
    leaf bit-equal to the plain quantize -> dequantize, the updated
    leaves bit-equal to the same step given those gradients, times and
    the bytes its all-reduces move; (b) ``compressed_psum`` across 4
    processes sharing the card over gloo, bit-equal to each other and to
    a numpy emulation; (c) the quantization error of (a) within half a
    step; (d) ``moe_mlp_shardmap`` at qwen2-moe-a2.7b's width, one rank
    against the CPU and 4 ranks against one, timed against ``moe_mlp``,
    the drops of both capacity rules; (e) ``gpipe`` over Llama 3.2 1B's
    16 layers bit-equal to the model's own loop, K6 counted and traced.
    Returns K6's keys of the kernels line."""
    import datetime
    import itertools
    import shutil
    import tempfile
    from unittest import mock
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params, layer_shapes
    from repro_torch.models.model import _embed, forward
    from repro_torch.models.moe import (capacity_of, dispatch, moe_mlp,
                                        moe_mlp_shardmap, router_topk)
    from repro_torch.models.transformer import layer_body
    from repro_torch.models.tree import leaves, rebuild
    from repro_torch.sharding.compression import (
        BLOCK, _dequantize, _quantize, make_compressed_grad_transform)
    from repro_torch.sharding.pipeline import gpipe, stage_split
    from repro_torch.train import AdamWConfig, build_train_step, \
        init_opt_state

    phase("16 the distribution layer: the int8 gradient all-reduce in "
          "Llama 3.2 1B's train step, moe_mlp_shardmap at qwen2-moe-a2.7b's "
          "width, GPipe over Llama 3.2 1B's layers")
    free_device_memory()
    print(card)
    cfg = get_config(TR_ARCH)
    mcfg = get_config(DIST_MOE_ARCH)
    moe_shapes = {k: v for k, v in layer_shapes(mcfg).items()
                  if k in ("w_router", "wg", "wu", "wd", "sg", "su", "sd",
                           "shared_gate")}
    x_shape = DIST_MOE_X + (mcfg.d_model,)
    tmp = tempfile.mkdtemp(prefix="repro_torch_dist_")
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        group = dist.group.WORLD

        # (a) the compressed all-reduce inside the full-width train step
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        n_params = sum(leaf.value.numel() for leaf in leaves(params))
        data = DataConfig(vocab=cfg.vocab, seq_len=TR_SEQ,
                          global_batch=TR_BATCH, seed=0)
        tokens = SyntheticLM(data).batch_at(0)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in tokens.items()}
        opt_cfg = AdamWConfig(lr_peak=1e-3,
                              warmup_steps=max(10, TR_STEPS // 20),
                              total_steps=TR_STEPS)
        opt = init_opt_state(params, opt_cfg)
        compress = make_compressed_grad_transform(group, ())
        seen, moved = {}, []
        real_all_reduce = dist.all_reduce

        def counted_all_reduce(t, *a, **kw):
            moved.append((t.dtype, t.numel() * t.element_size(),
                          t.device.type))
            return real_all_reduce(t, *a, **kw)

        def capture(g):
            seen["raw"] = g
            with mock.patch.object(dist, "all_reduce", counted_all_reduce):
                seen["out"] = compress(g)
            return seen["out"]
        flash_attention.launches = 0
        new_c, _, _ = build_train_step(cfg, opt_cfg, grad_transform=capture)(
            params, opt, batch)
        torch.cuda.synchronize()
        n_k6_a = flash_attention.launches
        if n_k6_a != cfg.n_layers:
            fail(f"K6 launched {n_k6_a} times in the compressed train step, "
                 f"not once a layer ({cfg.n_layers})")
        if {d for _, _, d in moved} != {dev.type}:
            fail(f"the all-reduces ran on {set(d for _, _, d in moved)}")
        # every leaf against the plain quantize -> dequantize of its
        # stacked gradient, bit for bit; (c) the error within half a step
        plain, worst, n_el, n_stacked = [], 0.0, 0, 0
        for (_, raw), (_, out) in zip(
                itertools.groupby(leaves(seen["raw"]), key=lambda l: l.path),
                itertools.groupby(leaves(seen["out"]), key=lambda l: l.path)):
            raw, out = [l.value for l in raw], [l.value for l in out]
            flat = torch.cat([p.reshape(-1) for p in raw])
            q, scale = _quantize(flat)
            want = _dequantize(q, scale, flat.shape, flat.numel())
            got = torch.cat([p.reshape(-1) for p in out])
            if not equal_bits(got, want):
                fail(f"a compressed gradient leaf differs from the plain "
                     f"quantize -> dequantize ({raw[0].shape} x {len(raw)})")
            err = torch.nn.functional.pad((got - flat).abs(),
                                          (0, (-flat.numel()) % BLOCK))
            steps = float((err.view(-1, BLOCK) / scale).max())
            if steps > DIST_ERR_STEPS:
                fail(f"quantization error {steps} steps of a block's scale, "
                     f"above {DIST_ERR_STEPS}")
            worst = max(worst, steps)
            n_el += flat.numel()
            n_stacked += 1
            plain += [w.view(p.shape) for p, w in zip(
                raw, want.split([p.numel() for p in raw]))]
        plain_tree = rebuild(seen["raw"], plain)
        del seen, plain
        # the same step handed those plain gradients: the same update
        new_p, _, _ = build_train_step(
            cfg, opt_cfg, grad_transform=lambda g: plain_tree)(
            params, opt, batch)
        torch.cuda.synchronize()
        for a, b in zip(leaves(new_c), leaves(new_p)):
            if not equal_bits(a.value, b.value):
                fail(f"updated leaf {a.name}[{a.index}] differs from the "
                     f"step given the plain quantized gradients")
        del new_c, new_p
        free_device_memory()
        int32_b = sum(b for d, b, _ in moved if d == torch.int32)
        max_b = sum(b for d, b, _ in moved if d == torch.float32)
        if int32_b + max_b != sum(b for _, b, _ in moved):
            fail(f"all-reduces of other dtypes: {set(d for d, _, _ in moved)}")

        step_none = build_train_step(cfg, opt_cfg)
        step_comp = build_train_step(cfg, opt_cfg, grad_transform=compress)

        def step_ms(step) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3
        step_ms(step_none)                        # warm-up
        step_ms(step_comp)
        times = {"none": [], "comp": []}
        for which in ("none", "comp", "comp", "none") * 2:
            times[which].append(step_ms(step_none if which == "none"
                                        else step_comp))
        transform_ms = cuda_ms(lambda: compress(plain_tree), 3)
        del plain_tree, params, opt
        free_device_memory()
        print(card)
        print(f"(a) the int8 gradient all-reduce in {TR_ARCH}'s train step "
              f"at full width ({n_params} float32 gradient elements in "
              f"{n_stacked} stacked leaves, one-rank {backend} group): "
              f"every leaf bit-equal to the plain quantize -> dequantize, "
              f"the updated leaves bit-equal to the step given those; "
              f"{np.mean(times['comp']):.1f} ms a step with it against "
              f"{np.mean(times['none']):.1f} ms without (each of "
              f"{len(times['comp'])} steps in turns: "
              f"{[round(t, 1) for t in times['comp']]} against "
              f"{[round(t, 1) for t in times['none']]}); the transform "
              f"alone {transform_ms:.2f} ms over the {n_el} elements; "
              f"{n_k6_a} K6 launches in the step", flush=True)
        print(f"(a) bytes handed to its all-reduces: {int32_b + max_b} "
              f"({int32_b} as int32 sums of the padded int8 values, "
              f"{max_b} as float32 block maxima) against "
              f"{4 * n_el} for a float32 all-reduce of the gradient "
              f"({(int32_b + max_b) / (4 * n_el):.4f}x) and "
              f"{n_el + 4 * n_el // BLOCK} for int8 values with a float32 "
              f"scale a block, as the JAX package's docstring counts them",
              flush=True)
        print(f"(c) quantization error at most {worst:.6f} of a step of "
              f"its block's scale (limit {DIST_ERR_STEPS})", flush=True)

        # (b) and the 4-rank half of (d): DIST_RANKS processes sharing
        # the card over gloo
        t0 = time.perf_counter()
        grad_shapes = layer_shapes(cfg)
        ranks = run_dist_ranks(tmp, dev.type, grad_shapes, moe_shapes,
                               x_shape, mcfg.moe)
        ranks_s = time.perf_counter() - t0
        want_dev = [f"{dev.type}:0"] if dev.type == "cuda" else ["cpu"]
        for r in ranks:
            if r["devices"] != want_dev:
                fail(f"a rank computed on {r['devices']}, not {want_dev}")
        host = [layer_grads(grad_shapes, r) for r in range(DIST_RANKS)]
        n_b = 0
        for k in sorted(grad_shapes):
            want = np_compressed_mean([h[k] for h in host]).view(np.int32)
            for r in ranks:
                if not np.array_equal(r["b"][k].numpy().view(np.int32),
                                      want):
                    fail(f"(b) leaf {k} of a rank differs from the numpy "
                         f"emulation of the JAX arithmetic")
            n_b += want.size
        print(f"(b) compressed_psum across {DIST_RANKS} processes sharing "
              f"the card over gloo, one {TR_ARCH} decoder layer's "
              f"{len(grad_shapes)} gradient leaves ({n_b} elements) each: "
              f"all {DIST_RANKS} results bit-equal to each other and to a "
              f"numpy emulation (shared block max, round half to even, "
              f"int32 sum, scale / {DIST_RANKS}); {ranks_s:.1f} s with the "
              f"processes' start and (d)", flush=True)

        # (d) moe_mlp_shardmap at qwen2-moe-a2.7b's width on one rank
        moe = mcfg.moe
        x, mp32 = moe_layer(dev, torch.float32, moe_shapes, x_shape)
        y1 = moe_mlp_shardmap(x, mp32, moe, group)
        cpu_group = dist.new_group(backend="gloo")
        y_cpu = moe_mlp_shardmap(x.cpu(), {k: v.cpu() for k, v in
                                           mp32.items()}, moe, cpu_group)
        diff = float((y1.cpu() - y_cpu).abs().max())
        if not bool(((y1.cpu() - y_cpu).abs() <= DIST_MOE_TOL
                     + DIST_MOE_TOL * y_cpu.abs()).all()):
            fail(f"(d) moe_mlp_shardmap on the card differs from the CPU's "
                 f"by {diff}")
        rels = [rel_norms(r["d"], y1.cpu())[0] for r in ranks]
        if max(rels) > DIST_MOE_REL:
            fail(f"(d) moe_mlp_shardmap on {DIST_RANKS} ranks against one: "
                 f"relative error norms {rels}")
        xb = x.to(torch.bfloat16)
        pb = {k: v.to(torch.bfloat16) for k, v in mp32.items()}
        del mp32
        shard_ms = cuda_ms(lambda: moe_mlp_shardmap(xb, pb, moe, group), 10)
        dense_ms = cuda_ms(lambda: moe_mlp(xb, pb, moe), 10)
        _, experts = router_topk(xb, pb["w_router"], moe)
        e_pad = pb["w_router"].shape[1]
        b, s = DIST_MOE_X
        cap_row, cap_t = capacity_of(s, moe), capacity_of(b * s, moe)
        drop_row = int((~dispatch(experts, e_pad, cap_row)[1]).sum())
        drop_t = int((~dispatch(experts.reshape(1, b * s, -1), e_pad,
                                cap_t)[1]).sum())
        entries = b * s * moe.top_k
        del xb, pb, x, y1
        free_device_memory()
        print(card)
        print(f"(d) moe_mlp_shardmap at {DIST_MOE_ARCH}'s width (d "
              f"{mcfg.d_model}, {moe.n_experts} experts padded to {e_pad}, "
              f"top {moe.top_k}, d_expert {moe.d_expert}, {moe.n_shared} "
              f"shared experts of {moe.d_shared} in all; x {x_shape}): one "
              f"rank (E_loc {e_pad}) in float32 against the CPU's within "
              f"{DIST_MOE_TOL} (max |diff| {diff:.3e}); {DIST_RANKS} ranks "
              f"over gloo (E_loc {e_pad // DIST_RANKS}) against one rank, "
              f"relative error norms {[f'{v:.3e}' for v in rels]} (limit "
              f"{DIST_MOE_REL}); in bfloat16 {shard_ms:.4f} ms a call "
              f"against moe_mlp's {dense_ms:.4f} ms; entries dropped of "
              f"{entries}: moe_mlp's rule (capacity {cap_row} an expert a "
              f"row of {s} tokens) {drop_row}, moe_mlp_shardmap's (capacity "
              f"{cap_t} an expert over the local batch's {b * s} tokens) "
              f"{drop_t}", flush=True)

        # (e) GPipe: Llama 3.2 1B's 16 layers as one stage
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
        toks = torch.as_tensor(tokens["inputs"], device=dev).reshape(
            DIST_MICRO, DIST_MB, TR_SEQ)
        x_micro = torch.stack([_embed(params, cfg, t, torch.bfloat16)
                               for t in toks])
        kinds = cfg.layer_kinds()
        stacked = {k: torch.stack([lp[k] for lp in params.layers])
                   for k in params.layers[0].keys()}
        stages = stage_split(stacked, 1)
        q_pos = torch.arange(TR_SEQ, dtype=torch.int32,
                             device=dev)[None].expand(DIST_MB, TR_SEQ)

        def stage_fn(p, h):
            for i in range(p["ln1"].shape[0]):
                h, _, _ = layer_body(h, {k: v[i] for k, v in p.items()}, cfg,
                                     q_pos=q_pos, is_global=bool(kinds[i]),
                                     compute_dtype=torch.bfloat16)
            return h
        apply = gpipe(stage_fn, group)
        flash_attention.launches = 0
        t0 = time.perf_counter()
        y = apply(stages, x_micro)
        torch.cuda.synchronize()
        gpipe_ms = (time.perf_counter() - t0) * 1e3
        n_k6_e = flash_attention.launches
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = torch.stack([forward(params, cfg, t,
                                       compute_dtype=torch.bfloat16,
                                       return_hidden=True) for t in toks])
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
        want = DIST_MICRO * cfg.n_layers
        if n_k6_e != want:
            fail(f"(e) K6 launched {n_k6_e} times in gpipe, not {want}")
        if not equal_bits(y, ref):
            fail(f"(e) gpipe differs from the model's layer loop: max |diff| "
                 f"{float((y.float() - ref.float()).abs().max())}")
        # the profiler loses device records now and then (phase 15): no
        # window may hold more K6 launches than counted, one must hold all
        seen_k6 = []
        for _ in range(TR_TRACE_WINDOWS):
            flash_attention.launches = 0
            _, kern, _ = device_kernels(lambda: apply(stages, x_micro))
            seen_k6.append((launches_of(kern, "flash_attention_kernel"),
                            flash_attention.launches))
            if seen_k6[-1][0] == want:
                break
        if any(c != want or t > c for t, c in seen_k6) or \
                seen_k6[-1][0] != want:
            fail(f"(e) K6 in gpipe's traced windows (trace, counted): "
                 f"{seen_k6}; want {want}")
        del params, stacked, stages, x_micro, y, ref
        free_device_memory()
        print(card)
        print(f"(e) gpipe over the one-rank group, {TR_ARCH}'s "
              f"{cfg.n_layers} layers as one stage, {DIST_MICRO} "
              f"microbatches of ({DIST_MB}, {TR_SEQ}) bfloat16: bit-equal "
              f"to the model's own layer loop; {gpipe_ms:.1f} ms against "
              f"the loop's {loop_ms:.1f} ms (first calls, host clock); "
              f"{n_k6_e} K6 launches, traced windows (trace, counted) "
              f"{seen_k6}", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"dist_train_launches": n_k6_a, "dist_gpipe_launches": n_k6_e}


def shard_flags_check(dev, card) -> dict:
    """Phase 16's perf-flag and callback checks over a one-rank group
    (NCCL on the card) made from a ``FileStore`` and destroyed at the end:
    (f) ``moe_impl="shard_map"`` with a registered (1, 1) ``DeviceMesh``
    makes the model's MLP (``transformer._mlp``) call
    ``moe_mlp_shardmap``, bit-equal to that call on the group, at
    qwen2-moe-a2.7b's width in float32; (g) Llama 3.2 1B's bfloat16
    forward with ``DTensor`` params on that mesh and
    ``activation_shard_fn``'s callback, bit-equal to the plain forward, K6
    once a layer.  Returns K6's key of the kernels line."""
    import datetime
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import forward, init_params, layer_shapes
    from repro_torch.models.moe import moe_mlp_shardmap
    from repro_torch.models.perf_flags import reset_flags, set_flags, \
        set_mesh
    from repro_torch.models.transformer import _mlp
    from repro_torch.sharding import (PartitionSpec, activation_shard_fn,
                                      distribute_params, to_placements)
    cfg, mcfg = get_config(TR_ARCH), get_config(DIST_MOE_ARCH)
    moe_shapes = {k: v for k, v in layer_shapes(mcfg).items()
                  if k in ("w_router", "wg", "wu", "wd", "sg", "su", "sd",
                           "shared_gate")}
    tmp = tempfile.mkdtemp(prefix="repro_torch_flags_")
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        # (f) moe_impl="shard_map" through the model's MLP
        x, mp = moe_layer(dev, torch.float32, moe_shapes,
                          DIST_MOE_X + (mcfg.d_model,))
        want = moe_mlp_shardmap(x, mp, mcfg.moe, dist.group.WORLD)
        set_mesh(mesh, ("data",))
        set_flags(moe_impl="shard_map")
        try:
            got = _mlp(x, mp, mcfg, torch.float32)
        finally:
            reset_flags()
            set_mesh(None, ())
        if not equal_bits(got, want):
            fail(f"(f) moe_impl=\"shard_map\" through the model's MLP "
                 f"differs from moe_mlp_shardmap: max |diff| "
                 f"{float((got - want).abs().max())}")
        del x, mp, got, want
        free_device_memory()
        # (g) the shard callback on DTensor params
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
        toks = torch.as_tensor(np.random.default_rng(16).integers(
            0, cfg.vocab, (DIST_MB, TR_SEQ)), device=dev)
        dparams = distribute_params(params, cfg, mesh, axis_size=1)
        shard = activation_shard_fn(mesh, cfg, multi_pod=False)
        flash_attention.launches = 0
        with torch.no_grad(), implicit_replication():
            dtok = distribute_tensor(toks, mesh, to_placements(
                mesh, PartitionSpec("data", None)))
            y_shard = forward(dparams, cfg, dtok,
                              compute_dtype=torch.bfloat16,
                              shard=shard).full_tensor()
        n_k6 = flash_attention.launches
        with torch.no_grad():
            y_plain = forward(params, cfg, toks,
                              compute_dtype=torch.bfloat16)
        same = equal_bits(y_shard, y_plain)
        diff = float((y_shard.float() - y_plain.float()).abs().max())
        del params, dparams, y_shard, y_plain
        free_device_memory()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if n_k6 != cfg.n_layers or not same:
        fail(f"(g) the forward with the shard callback on a (1, 1) mesh: "
             f"{n_k6} K6 launches, bit-equal {same} (max |diff| {diff})")
    print(card)
    print(f"(f) moe_impl=\"shard_map\" with a registered (1, 1) "
          f"{backend} mesh: the model's MLP (transformer._mlp) at "
          f"{DIST_MOE_ARCH}'s width bit-equal to moe_mlp_shardmap on the "
          f"group; (g) {TR_ARCH}'s bfloat16 forward of ({DIST_MB}, "
          f"{TR_SEQ}) tokens with DTensor params on that mesh and "
          f"activation_shard_fn's callback bit-equal to the plain forward, "
          f"{n_k6} K6 launches", flush=True)
    return {"dist_shard_launches": n_k6}


#: phase 17: phase 15's step (TR_BATCH x TR_SEQ tokens, one rank)
#: counted on meta tensors by repro_torch.launch.hlo_cost, beside phase
#: 15's measured ms a step; then one single-pod dry-run cell
RF_CELL = ("llama3.2-1b", "train_4k")


#: phase 17: the Mamba configurations' dry-run cells, single pod, beside
#: RF_CELL (torch 2.11's redistribution planner failed falcon-mamba-7b's
#: train_4k at the conv's pad before the conv ran a shard a rank, then at
#: the dt projection before x_proj's partial sums were reduced); all but
#: hymba-1.5b's long_500k, which took 197 s of the run's time limit alone
#: on the card machine (``python -m repro_torch.launch.dryrun --arch
#: hymba-1.5b --shape long_500k --mesh single`` runs it)
RF_MAMBA_CELLS = tuple(
    (arch, shape) for arch in ("falcon-mamba-7b", "hymba-1.5b")
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    if (arch, shape) != ("hymba-1.5b", "long_500k"))


def mamba_cells_check() -> dict:
    """Every cell of RF_MAMBA_CELLS through ``dryrun.lower_cell`` on the
    fake 256-rank mesh, each required "ok"; prints each cell's seconds,
    dominant term, bound and useful ratio.  Returns {"arch/shape":
    seconds}."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape in RF_MAMBA_CELLS:
        t0 = time.perf_counter()
        cell = dryrun.lower_cell(arch, shape, multi_pod=False, verbose=False)
        secs = time.perf_counter() - t0
        if cell["status"] != "ok":
            fail(f"the dry-run cell ({arch}, {shape}): {cell}")
        out[f"{arch}/{shape}"] = secs
        bound = max(cell["compute_s"], cell["memory_s"],
                    cell["collective_s"])
        print(f"dry-run cell ({arch}, {shape}) single pod in {secs:.1f} s: "
              f"dominant {cell['dominant']}, bound {bound * 1e3:.3f} "
              f"ms (compute {cell['compute_s'] * 1e3:.3f}, memory "
              f"{cell['memory_s'] * 1e3:.3f}, collective "
              f"{cell['collective_s'] * 1e3:.3f}), useful ratio "
              f"{cell['useful_ratio']:.4f}", flush=True)
    return out


def roofline_phase(card, step_ms: float) -> dict:
    """Phase 17: ``hlo_cost.analyze`` of phase 15's exact train step
    (Llama 3.2 1B at full width, TR_BATCH x TR_SEQ tokens, one rank) on
    meta tensors: its FLOPs, bytes, ``model_flops`` (6·N·D) and
    ``useful_ratio``, the compute, memory and bound terms at the H100's
    data-sheet peaks beside phase 15's measured ``step_ms``, and the
    step's MFU, ``model_flops / (step_s x 989e12)``; then one single-pod
    ``lower_cell`` (``RF_CELL``) on the fake 256-rank mesh, timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, hlo_cost, roofline
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.models.transformer import _build
    from repro_torch.train import AdamWConfig, build_train_step, \
        init_opt_state

    phase("17 the roofline: phase 15's step counted on meta tensors, and "
          "a dry-run cell")
    cfg = get_config(TR_ARCH)
    params = _build(cfg, lambda path, name, shape: torch.empty(
        shape, dtype=torch.float32, device="meta"))
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=max(10, TR_STEPS // 20),
                          total_steps=TR_STEPS)
    opt = init_opt_state(params, opt_cfg)
    toks = torch.empty((TR_BATCH, TR_SEQ), dtype=torch.int64, device="meta")
    batch = {"inputs": toks, "targets": toks}
    t0 = time.perf_counter()
    cost = hlo_cost.analyze(build_train_step(cfg, opt_cfg), params, opt,
                            batch)
    count_s = time.perf_counter() - t0
    mflops = roofline.model_flops(cfg, "train", TR_BATCH, TR_SEQ)
    rl = roofline.Roofline(
        arch=TR_ARCH, shape=f"train {TR_BATCH}x{TR_SEQ}", mesh="one rank",
        chips=1, flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_bytes,
        model_flops=mflops)
    mfu = mflops / (step_ms / 1e3 * PEAK_FLOPS_BF16)
    dots = cost.flops_by_opcode.get("dot", 0.0)
    if not (cost.flops > 0 and cost.bytes > 0 and 0.3 < rl.useful_ratio
            <= 1.5 and dots > 0):
        fail(f"phase 15's step counted {cost.flops} FLOPs ({dots} in "
             f"products), {cost.bytes} bytes, useful ratio "
             f"{rl.useful_ratio}")
    print(card)
    print(f"phase 15's step counted on meta tensors in {count_s:.1f} s: "
          f"{cost.flops:.6e} FLOPs ({dots:.6e} in products, "
          f"{cost.flops_by_opcode.get('flash_attention_cost', 0.0):.6e} "
          f"in K6, {cost.flops_by_opcode.get('flash_attention_backward_cost', 0.0):.6e} "
          f"in K6's plain backward), {cost.bytes:.6e} bytes; model_flops "
          f"6·N·D = {mflops:.6e} (N {roofline.count_params(cfg)}, D "
          f"{TR_BATCH * TR_SEQ}), useful ratio {rl.useful_ratio:.4f}; at "
          f"the data-sheet peaks compute {rl.compute_s * 1e3:.3f} ms, "
          f"memory {rl.memory_s * 1e3:.3f} ms ({PEAK_FLOPS_BF16:.3g} "
          f"FLOP/s, {HBM_BW:.3g} B/s): bound {rl.bound_s * 1e3:.3f} ms "
          f"({rl.dominant}), against the measured {step_ms:.1f} ms a step "
          f"(phase 15): {100 * rl.bound_s * 1e3 / step_ms:.1f}% of it; "
          f"MFU {100 * mfu:.2f}%", flush=True)
    t0 = time.perf_counter()
    cell = dryrun.lower_cell(*RF_CELL, multi_pod=False, verbose=False)
    cell_s = time.perf_counter() - t0
    if cell["status"] != "ok":
        fail(f"the dry-run cell {RF_CELL}: {cell}")
    print(f"dry-run cell {RF_CELL} on the fake 256-rank mesh (counted "
          f"against H100 data-sheet peaks, no card) in {cell_s:.1f} s: "
          f"dominant {cell['dominant']}, bound "
          f"{max(cell['compute_s'], cell['memory_s'], cell['collective_s']) * 1e3:.3f} "
          f"ms (compute {cell['compute_s'] * 1e3:.3f}, memory "
          f"{cell['memory_s'] * 1e3:.3f}, collective "
          f"{cell['collective_s'] * 1e3:.3f}), useful ratio "
          f"{cell['useful_ratio']:.4f}", flush=True)
    mamba_s = mamba_cells_check()
    return {"roofline_flops": cost.flops, "roofline_bytes": cost.bytes,
            "model_flops": mflops, "useful_ratio": rl.useful_ratio,
            "bound_ms": rl.bound_s * 1e3, "mfu": mfu, "cell_s": cell_s,
            "mamba_cells_s": mamba_s}


def k3_mac_check(dev) -> None:
    """Phase 3's float-input bucket: a single-op ``mac`` program and a
    single-op ``mul`` program in one bucket (its table holds ``mul``, so
    ``mac`` rounds its product first), and the ``mac`` program alone (one
    FMA), on normal float inputs (B, K) = (2, 64) from a seed.  K3 (state
    in shared and in global memory) == its plain version bit for bit, and
    ``mac``'s outputs the rounding the table calls for, on lanes where one
    rounding and two differ."""
    import numpy as np
    import torch
    from repro_torch.core import baseline_datapath, map_application
    from repro_torch.core.dse import app_ops
    from repro_torch.fabric import FabricSpec
    from repro_torch.graphir.graph import Graph
    from repro_torch.kernels import sim_step
    from repro_torch.sim import build_sim, sim_signature
    from repro_torch.sim.cycle import bucket_tensors

    def program(op, arity):
        g = Graph()
        ins = [g.add_node("input", name=f"x{i}") for i in range(3)]
        n = g.add_node(op)
        for port in range(arity):
            g.add_edge(ins[port], n, port)
        g.mark_output(n)
        dp = baseline_datapath(app_ops(g))
        return build_sim(dp, map_application(dp, g, op), g,
                         FabricSpec(4, 4), place_backend="python", chains=1,
                         sweeps=8, device="cpu")[0]

    mac_p, mul_p = program("mac", 3), program("mul", 2)
    b_n, k_n = 2, 64
    x = np.random.default_rng(0).normal(size=(b_n, k_n, 3)).astype(
        np.float32)
    a, b, c = (torch.from_numpy(x[:, :, j]).to(dev) for j in range(3))
    fused, twice = sim_step._fma(a, b, c), a * b + c
    tells = int(((fused.view(torch.int32) != twice.view(torch.int32))
                 & ~(torch.isnan(fused) & torch.isnan(twice))).sum())
    if tells == 0:
        fail("phase 3's mac inputs tell one rounding from two on no lane")
    ids = []
    for progs, rule, what in (([mac_p, mul_p], twice, "rounded twice"),
                              ([mac_p], fused, "one FMA")):
        sig = sim_signature(progs[0], k_n, b_n)
        if {sim_signature(p, k_n, b_n) for p in progs} != {sig}:
            fail("the single-op mac and mul programs span two sim "
                 "signatures")
        arrs = [np.ascontiguousarray(x[:, :, [int(n[1:]) for n in
                                              p.input_names]])
                for p in progs]
        tabs, xs, op_ids = bucket_tensors(progs, arrs, sig, dev)
        ids.append(op_ids.tolist())
        kw = dict(cycles=sig[8], latch_depth=sig[9])
        want = sim_step.simulate_batch_plain(tabs, xs, op_ids, **kw)
        for force_global in (False, True):
            got = sim_step.simulate_batch_stepper(
                tabs, xs, op_ids, force_global=force_global, **kw)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                fail(f"K3 (global={force_global}) differs from its plain "
                     f"version on the float-input mac bucket "
                     f"{[p.ops for p in progs]}")
        if not same_bits(got[0][:, :, progs[0].out_cols[0]], rule):
            fail(f"K3's mac in the bucket {[p.app_name for p in progs]} is "
                 f"not {what}")
    print(f"  float-input mac buckets (op ids {ids[0]} with mul, {ids[1]} "
          f"alone): K3 shared/global == plain, mac rounded twice beside "
          f"mul and one FMA alone, {tells} of {b_n * k_n} lanes telling "
          f"them apart", flush=True)


#: phase 18: ``benchmarks/pnr_bench.py``'s batched-HPWL microbenchmark
#: shape, 256 placements of the harris app on an 8x8 fabric (slot
#: permutations, seed 0), and (rows, lanes) of the free-standing ALU step
EP_PLACEMENTS, EP_ALU_SHAPE = 256, (256, 4096)
EP_TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "rsqrt", "pow")


def entry_points_phase(dev, card) -> list:
    """Phase 18: the JAX package's remaining kernel entry points on the
    card, with their launch counters set to 0 just before and read just
    after one traced call each: ``hpwl_pallas`` (one placement) and
    ``hpwl_batched`` (pnr_bench's 256) each one zero-step ``anneal_kernel``
    (K2), ``hpwl_delta_pallas`` one ``swap_delta_kernel`` (K2's row cost)
    for a swap over the nets it touches, ``alu_step_pallas`` one
    ``alu_step_kernel`` (K3's ALU dispatch) over EP_ALU_SHAPE lanes and
    the whole op table; the counters equal to the trace, and no other
    kernel of the sources launched.  Each result held to its plain
    version on the card: bit-equal (HPWLs and deltas are integers; the
    IEEE-exact ALU ops), the transcendentals within 2 ulp; the ALU step
    also in a second, uncounted pass under the table without ``mul``,
    ``mac`` rounded twice in the first and one FMA in the second.  Then each
    timed with CUDA events beside its plain version and its bound, and
    ``hpwl_batched`` also the kernel alone (trace) and its wrapper's pin
    table.  Returns the kernels line's rows."""
    import numpy as np
    import torch
    from repro_torch.apps import image_graphs
    from repro_torch.core import baseline_datapath, map_application
    from repro_torch.core.dse import app_ops
    from repro_torch.fabric import FabricSpec, extract_netlist, lower
    from repro_torch.kernels import pnr_cost, sim_step

    phase("18 the JAX package's kernel entry points on K2 and K3")
    app = image_graphs()["harris"]
    spec = FabricSpec(rows=8, cols=8)
    prob = lower(extract_netlist(map_application(
        baseline_datapath(app_ops(app)), app, "harris"), app, spec), spec)
    rng = np.random.default_rng(0)
    e_n = prob.n_entities
    perms = np.stack([rng.permutation(e_n) for _ in range(EP_PLACEMENTS)])
    pos = torch.from_numpy(prob.slot_xy[perms]).to(dev)
    pins = torch.from_numpy(prob.net_pins).to(dev)
    mask = torch.from_numpy(prob.net_mask).to(dev)
    n_n, d_n = prob.net_pins.shape
    # a swap of two entities over the nets either lies on
    slot_xy = torch.from_numpy(prob.slot_xy).to(dev)
    slot_of = torch.from_numpy(perms[0].astype(np.int32)).to(dev)
    ea, eb = (int(v) for v in rng.choice(
        np.unique(prob.net_pins[prob.net_mask]), 2, replace=False))
    nets = [i for i in range(n_n) if np.isin(
        prob.net_pins[i][prob.net_mask[i]], (ea, eb)).any()]
    touched = torch.tensor(nets + [n_n] * 2, dtype=torch.int32, device=dev)
    pnc = pnr_cost._rows_plain(pos[:1], pins, mask)[0][0]
    # the ALU step: normal operands, small integers and specials
    ops = sim_step.op_table(list(sim_step.ALU_IMPLS))
    gen = torch.Generator(device=dev).manual_seed(18)
    rows, lanes = EP_ALU_SHAPE
    xs = [torch.exp(torch.empty(EP_ALU_SHAPE, device=dev).uniform_(
        -6.9, 6.9, generator=gen)) * torch.where(torch.rand(
            EP_ALU_SHAPE, generator=gen, device=dev) < 0.5, -1.0, 1.0)
        for _ in range(3)]
    xs[1][:, :lanes // 4] = torch.randint(-20, 21, (rows, lanes // 4),
                                          generator=gen, device=dev).float()
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1.0, -1.0], device=dev)
    for x in xs:
        hit = torch.rand(EP_ALU_SHAPE, generator=gen, device=dev) < 0.02
        x[hit] = special[torch.randint(0, len(special), (int(hit.sum()),),
                                       generator=gen, device=dev)]
    codes = torch.randint(0, len(ops), (lanes,), generator=gen, device=dev,
                          dtype=torch.int32)

    counters = {"hpwl_pallas": pnr_cost.hpwl_pallas,
                "hpwl_batched": pnr_cost.hpwl_batched,
                "hpwl_delta_pallas": pnr_cost.hpwl_delta_pallas,
                "alu_step_pallas": sim_step.alu_step_pallas}
    for f in counters.values():
        f.launches = 0
    out, kern, _ = device_kernels(lambda: (
        pnr_cost.hpwl_pallas(pos[0], pins, mask),
        pnr_cost.hpwl_batched(pos, pins, mask),
        pnr_cost.hpwl_delta_pallas(slot_xy, slot_of, pins, mask, pnc,
                                   touched, ea, eb),
        sim_step.alu_step_pallas(codes, *xs, ops)))
    launches = {k: f.launches for k, f in counters.items()}
    ours = {name: launches_of(kern, name) for name in source_kernels()}
    want_trace = {"anneal_kernel": 2, "swap_delta_kernel": 1,
                  "alu_step_kernel": 1}
    if launches != dict.fromkeys(counters, 1) or \
            {k: v for k, v in ours.items() if v} != want_trace:
        fail(f"the entry points launched {launches}, the trace holds "
             f"{ {k: v for k, v in ours.items() if v} }, expected one "
             f"each and {want_trace}")
    one, batched, (new, delta), alu = out
    want_net, want_tot = pnr_cost._rows_plain(pos, pins, mask)
    got_net, got_tot = pnr_cost._rows_k2(pos, pins, mask)
    want_new, want_delta = pnr_cost.hpwl_delta_pallas_plain(
        slot_xy, slot_of, pins, mask, pnc, touched, ea, eb)
    if not (torch.equal(one, want_tot[0]) and torch.equal(batched, want_tot)
            and torch.equal(got_net, want_net)
            and torch.equal(got_tot, want_tot)):
        fail("hpwl_pallas / hpwl_batched differ from their plain version")
    if not (torch.equal(new, want_new) and torch.equal(delta, want_delta)):
        fail("hpwl_delta_pallas differs from its plain version")
    tiny = float(torch.finfo(torch.float32).tiny)
    fused = sim_step._fma(*xs)
    twice = xs[0] * xs[1] + xs[2]
    tells = (fused.view(torch.int32) != twice.view(torch.int32)) & ~(
        torch.isnan(fused) & torch.isnan(twice))

    def alu_held(got, codes, ops):
        """``got`` against the plain version, op by op; ``mac`` also
        against the rounding its table calls for.  The largest |diff|."""
        want = sim_step.alu_step_plain(codes, *xs, ops)
        normal = ~((want.abs() < tiny) & (want != 0))
        code = torch.broadcast_to(codes, got.shape)
        err = 0.0
        for k, op in enumerate(ops):
            lanes_k = (code == k) & normal
            g, w = got[lanes_k], want[lanes_k]
            both_nan = torch.isnan(g) & torch.isnan(w)
            if op in EP_TRANSCENDENTAL:
                def ordered(x):
                    i = x.view(torch.int32).long()
                    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
                ulp = torch.where(both_nan, 0,
                                  (ordered(g) - ordered(w)).abs())
                if int(ulp.max()) > 2:
                    fail(f"alu_step_pallas: {op} {int(ulp.max())} ulp from "
                         f"its plain version")
            elif not same_bits(g, w):
                fail(f"alu_step_pallas differs from its plain version on "
                     f"{op} (table of {len(ops)} ops)")
            d = torch.where(both_nan | (g == w), 0.0, (g - w).abs())
            err = max(err, float(d.max()) if d.numel() else 0.0)
        mac = code == ops.index("mac")
        rule = twice if "mul" in ops else fused
        if int((mac & tells).sum()) == 0 or not same_bits(got[mac],
                                                          rule[mac]):
            fail(f"alu_step_pallas: mac under a table "
                 f"{'with' if 'mul' in ops else 'without'} mul is not "
                 f"{'rounded twice' if 'mul' in ops else 'one FMA'}, or no "
                 f"lane tells the roundings apart")
        return err, int((mac & tells).sum())

    alu_err, tell_full = alu_held(alu, codes, ops)
    # a second pass (not counted) under the table without mul, where mac
    # is one FMA; the whole table holds mul, so mac rounds twice there
    ops_nm = tuple(o for o in ops if o != "mul")
    codes_nm = torch.randint(0, len(ops_nm), (lanes,), generator=gen,
                             device=dev, dtype=torch.int32)
    err_nm, tell_nm = alu_held(sim_step.alu_step_pallas(codes_nm, *xs,
                                                        ops_nm),
                               codes_nm, ops_nm)
    alu_err = max(alu_err, err_nm)
    print(f"entry points on the card: one launch each, the trace's "
          f"{want_trace}; hpwl_pallas {float(one)} and hpwl_batched (256 "
          f"totals, per-net costs too) == plain bit for bit; "
          f"hpwl_delta_pallas over {len(nets)} nets (+2 padding): delta "
          f"{float(delta)} == plain, new costs bit-equal; alu_step_pallas "
          f"over {rows}x{lanes} lanes and {len(ops)} ops == plain (exact "
          f"ops bit for bit, transcendentals within 2 ulp; mac rounded "
          f"twice, {tell_full} lanes telling it from one FMA), and under "
          f"the {len(ops_nm)} ops without mul == plain (mac one FMA, "
          f"{tell_nm} lanes telling)", flush=True)

    # times: each call with its wrapper (CUDA events), its plain version
    # on the card, its bound; hpwl_batched also the kernel alone (trace)
    # and the wrapper's pin-table sort alone
    reps = 50
    _, kern_b, _ = device_kernels(lambda: [
        pnr_cost.hpwl_batched(pos, pins, mask) for _ in range(20)])
    k2_times = [t for k, v in kern_b.items() if "anneal_kernel" in k
                for t in v]
    if len(k2_times) != 20:
        fail(f"the profiler traced {len(k2_times)} launches of "
             f"hpwl_batched's K2 for 20")
    kernel_ms = sum(k2_times) / 20
    pin_ms = cuda_ms(lambda: pnr_cost.pin_table(pins[None], mask[None]),
                     reps)
    real = int(mask.sum())
    rows_out = []
    print(card)
    cases = (
        ("hpwl_pallas", "anneal_kernel with zero steps as hpwl_pallas (K1's "
         "entry point on K2)", "pnr_anneal.cu",
         "src/repro/kernels/pnr_cost.py:136",
         lambda: pnr_cost.hpwl_pallas(pos[0], pins, mask),
         lambda: pnr_cost._rows_plain(pos[:1], pins, mask),
         nbytes(pos[0], pins, mask) + 4, 4 * real + 3 * n_n, 0.0),
        ("hpwl_batched", "anneal_kernel with zero steps as hpwl_batched "
         "(K2, 256 chains)", "pnr_anneal.cu",
         "src/repro/kernels/pnr_cost.py:102",
         lambda: pnr_cost.hpwl_batched(pos, pins, mask),
         lambda: pnr_cost._rows_plain(pos, pins, mask),
         nbytes(pos, pins, mask) + 4 * EP_PLACEMENTS,
         EP_PLACEMENTS * (4 * real + 3 * n_n), 0.0),
        ("hpwl_delta_pallas", "swap_delta_kernel (K2's row cost)",
         "pnr_anneal.cu", "src/repro/kernels/pnr_cost.py:238",
         lambda: pnr_cost.hpwl_delta_pallas(slot_xy, slot_of, pins, mask,
                                            pnc, touched, ea, eb),
         lambda: pnr_cost.hpwl_delta_pallas_plain(
             slot_xy, slot_of, pins, mask, pnc, touched, ea, eb),
         # the touched nets' pin rows, their pins' slots and coordinates,
         # their costs, the list and the two entities; new costs and delta
         len(nets) * d_n * 5 + int(mask[nets].sum()) * 12
         + touched.numel() * 12 + 8 + 4,
         4 * int(mask[nets].sum()) + 5 * len(nets), 0.0),
        ("alu_step_pallas", "alu_step_kernel (K3's ALU dispatch)",
         "sim_step.cu", "src/repro/kernels/sim_step.py:179",
         lambda: sim_step.alu_step_pallas(codes, *xs, ops),
         lambda: sim_step.alu_step_plain(codes, *xs, ops),
         nbytes(codes, *xs) + xs[0].numel() * 4, rows * lanes, alu_err))
    for key, name, src, repl, fn, plain, b, opn, err in cases:
        ms = cuda_ms(fn, reps)
        plain_ms = cuda_ms(plain, 10)
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, opn / FP32_OPS_PER_S * 1e3
        b_ms, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        row = {"name": name, "route": "cuda", "source": CSRC + src,
               "replaces": repl, "launches": launches[key],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": by, "library_ms": None,
               "entry_point": "repro_torch.kernels." + (
                   "sim_step." if key.startswith("alu") else "pnr_cost.")
               + key,
               "timed": "the entry point with its wrapper (CUDA events)"}
        if key == "hpwl_batched":
            row["kernel_ms"], row["pin_table_ms"] = kernel_ms, pin_ms
            print(f"hpwl_batched at pnr_bench's shape ({EP_PLACEMENTS} "
                  f"placements of harris on 8x8: E={e_n}, N={n_n}, D={d_n}, "
                  f"{real} pins): {ms:.4f} ms with its wrapper, the kernel "
                  f"alone {kernel_ms:.4f} ms (torch.profiler), the wrapper's "
                  f"pin-table sort alone {pin_ms:.4f} ms; against a bound of "
                  f"{b_ms:.6f} ms ({by}: {b} bytes at 3.35 TB/s); plain "
                  f"{plain_ms:.4f} ms", flush=True)
        else:
            print(f"{key}: {ms:.4f} ms with its wrapper against a bound of "
                  f"{b_ms:.6f} ms ({by}), plain {plain_ms:.4f} ms",
                  flush=True)
        rows_out.append(row)
    return rows_out


def main() -> int:
    import torch

    # -- 1: the card ------------------------------------------------------
    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.apps import image_graphs, ml_graphs
        from repro_torch.core.mining import MiningConfig
        from repro_torch.explore import ExploreConfig, Explorer
        from repro_torch.fabric import (FabricOptions, FabricSpec,
                                        batch_signature, extract_netlist,
                                        lower)
        from repro_torch.fabric.place import KERNEL_INPUTS, batch_inputs
        from repro_torch.graphir import pattern_from_spec
        from repro_torch.graphir.graph import free_in_ports
        from repro_torch.kernels import (build, gemm, kernel_from_config,
                                         matmul_fused, pe_fused, pnr_cost,
                                         sim_step)
        from repro_torch.kernels.flash_attention import _lib as attention_lib
        from repro_torch.kernels.mamba_scan import _lib as scan_lib
        from repro_torch.kernels.ref import ref_gemm_pe, ref_pe
        from repro_torch.obs import buildprof, disable_tracing, enable_tracing
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.sim import random_inputs, sim_signature
        from repro_torch.sim.cycle import bucket_tensors
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    if any(m == "jax" or m.startswith(("jax.", "repro."))
           for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    dev = torch.device("cuda")

    # -- 2: build ---------------------------------------------------------
    phase("2 build")
    sources = sorted(f for f in os.listdir(os.path.join(
        ROOT, "src/repro_torch/kernels/csrc")) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(build.build, sources))
    print(f"built {len(built)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, (lib, report) in zip(sources, built):
        print(f"{src} -> {os.path.relpath(lib, ROOT)}")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())
    pnr_cost._lib()                     # load and type the libraries
    sim_step._lib()
    gemm._lib()
    attention_lib()
    scan_lib()

    # -- 3: front half + kernels vs plain on every signature -------------
    phase("3 front half, kernels vs plain versions")
    options = FabricOptions(spec=FabricSpec(rows=16, cols=16), chains=16,
                            sweeps=32, simulate=True)
    cfg = ExploreConfig(mode="per_app", max_merge=3,
                        mining=MiningConfig(min_support=3,
                                            max_pattern_nodes=6,
                                            time_budget_s=15,
                                            max_patterns_per_level=40),
                        fabric=options)
    apps = image_graphs()
    ex = Explorer(apps, cfg, device="cuda")
    t0 = time.perf_counter()
    mapped = ex.map()
    front = dict(ex._store)             # mined .. mapped, nothing placed
    print(f"front half: {len(mapped)} (variant, app) pairs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if len(mapped) != 16:
        fail(f"expected 16 (variant, app) pairs, got {len(mapped)}")
    groups = {}
    for (pe, app), m in sorted(mapped.items()):
        nl = extract_netlist(m, apps[app], options.spec)
        spec = options.spec.fit(len(nl.pe_cells), len(nl.io_cells))
        p = lower(nl, spec)
        groups.setdefault(batch_signature(p, options.sweeps), []).append(
            ((pe, app), p))
    print(f"{len(groups)} bucket signatures")
    max_err = {"k1": 0.0, "k2": 0.0}
    per_sig = []
    largest = None
    # K2 is held to its plain version in full depth on the signature with
    # the most steps, and on the first HIER_CHECK_STEPS steps elsewhere
    # (phase 4 holds every signature's full-depth run card == CPU)
    deepest = max(sorted(groups), key=lambda s: s[0])
    for sig in sorted(groups):
        items = groups[sig]
        probs = [p for _, p in items]
        inputs = batch_inputs(
            probs, chains=options.chains, seed=options.seed,
            sweeps=options.sweeps,
            nonces=[zlib.crc32(f"{pe}:{app}".encode()) for (pe, app), _ in
                    items])
        d = {k: v.to(dev) for k, v in inputs.items()}
        args = [d[k] for k in KERNEL_INPUTS]
        pnc0_plain = pnr_cost.net_hpwl_rows_plain(
            d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
            d["net_mask"])
        depth = None if sig == deepest else HIER_CHECK_STEPS
        errs = k2_vs_plain(d, f"signature {sig}", depth)
        max_err["k1"] = max(max_err["k1"], errs[0])
        max_err["k2"] = max(max_err["k2"], errs[1])
        k2_ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args), 2)
        pairs = [f"{pe}/{app}" for (pe, app), _ in items]
        per_sig.append((sig, pairs, k2_ms))
        print(f"  {'x'.join(map(str, sig))}: {pairs} K2's starting costs "
              f"(K1) == plain, K2 delta/full/telemetry == plain "
              f"({'full depth' if depth is None else f'first {depth} steps'}"
              f"); K2 "
              f"{k2_ms:.4f} ms "
              f"({1e3 * k2_ms / sig[0]:.4f} us a step)", flush=True)
        if largest is None or sig[0] > largest[0][0]:
            largest = (sig, d, pnc0_plain)

    k2_sum = sum(x[2] for x in per_sig)
    print(f"K2 summed over the {len(per_sig)} signatures (one launch each "
          f"on the main path): {k2_sum:.4f} ms", flush=True)

    # K3 on every sim signature: the pairs placed on a copy of the front,
    # so the main path below still places and simulates everything itself
    k_it, b_rows = options.sim_iterations, options.sim_batch
    ex3 = Explorer(apps, cfg, store=dict(front), device="cuda")
    t0 = time.perf_counter()
    progs = ex3.schedule()
    print(f"placed and scheduled {len(progs)} programs in "
          f"{time.perf_counter() - t0:.1f} s; schedule failures "
          f"{[(f.pe_name, f.app, f.error_type) for f in ex3.failures]}",
          flush=True)
    sim_groups = {}
    for (pe, app), prog in sorted(progs.items()):
        sim_groups.setdefault(sim_signature(prog, k_it, b_rows), []).append(
            ((pe, app), prog))
    print(f"{len(sim_groups)} sim signatures")
    max_err["k3"] = 0.0
    largest_sim, k3_sum, k3_wrap_sum = None, 0.0, 0.0
    for sig in sorted(sim_groups, key=lambda s: (s[8], s[0], s[4])):
        items = sim_groups[sig]
        arrs = [random_inputs(p, k_it, b_rows, seed=options.input_seed(
            zlib.crc32(f"{pe}:{app}".encode()))) for (pe, app), p in items]
        tabs, x, op_ids = bucket_tensors([p for _, p in items], arrs, sig,
                                         dev)
        kw = dict(cycles=sig[8], latch_depth=sig[9])
        want = sim_step.simulate_batch_plain(tabs, x, op_ids, **kw)
        for force_global in (False, True):
            got = sim_step.simulate_batch_stepper(
                tabs, x, op_ids, force_global=force_global, **kw)
            torch.cuda.synchronize()
            if not same_bits(got, want):
                fail(f"K3 (global={force_global}) differs from its plain "
                     f"version at {sig}")
            max_err["k3"] = max(max_err["k3"],
                                float((got - want).abs().max()))
        # the kernel alone, then with the wrapper's host work (checks,
        # event lists, buffers)
        prep = sim_step.prepare_stepper(tabs, x, op_ids, **kw)
        k3_ms = cuda_ms(lambda: sim_step.launch_stepper(prep), 3)
        k3_wrap = cuda_ms(lambda: sim_step.simulate_batch_stepper(
            tabs, x, op_ids, **kw), 3)
        state = sim_step.stepper_state_bytes(*sig[:7], sig[9])
        pairs = [f"{pe}/{app}" for (pe, app), _ in items]
        k3_sum += k3_ms
        k3_wrap_sum += k3_wrap
        print(f"  {'x'.join(map(str, sig))}: {pairs} K3 shared/global == "
              f"plain; state {state} B; K3 {k3_ms:.4f} ms "
              f"({1e3 * k3_ms / sig[8]:.3f} us a cycle), with its "
              f"wrapper's host work {k3_wrap:.4f} ms", flush=True)
        # signatures run in ascending (cycles, tiles, wires): keep the last
        largest_sim = (sig, [p for _, p in items], tabs, x, op_ids)
    print(f"K3 summed over the {len(sim_groups)} sim signatures: "
          f"{k3_sum:.4f} ms, with its wrapper's host work {k3_wrap_sum:.4f} "
          f"ms", flush=True)
    k3_mac_check(dev)

    # -- 4: the main path, counted ----------------------------------------
    phase("4 main path: Explorer.run() on the card vs pnr, schedule and "
          "simulate on the CPU")

    def traced_run(explorer):
        tracer = enable_tracing()
        t0 = time.perf_counter()
        try:
            out = explorer.run()
        finally:
            disable_tracing()
        wall = time.perf_counter() - t0
        stages = {}
        for sp, _depth, _path in tracer.iter_spans():
            if sp.name in ("pnr", "schedule", "simulate", "sim.dispatch"):
                stages[sp.name] = stages.get(sp.name, 0.0) + sp.dur
        return out, wall, stages

    # the run traced by torch.profiler: every device kernel it launched,
    # by name; K1 (the Pallas _hpwl_kernel's port was net_hpwl_kernel) is
    # counted there, as every launch of a kernel whose name holds "hpwl"
    pnr_cost.anneal_chains.launches = 0
    sim_step.simulate_batch_stepper.launches = 0
    (res, gpu_wall, gpu_stages), kern, busy_ms = device_kernels(
        lambda: traced_run(ex))
    launches = {"k1": sum(len(v) for k, v in kern.items() if "hpwl" in k),
                "k2": pnr_cost.anneal_chains.launches,
                "k3": sim_step.simulate_batch_stepper.launches}
    ours = {name: launches_of(kern, name) for name in source_kernels()}
    rows = [r.to_dict() for r in res.records()]
    buckets = {b for b in res.sim_buckets.values() if b}
    print(f"Explorer.run() on cuda (traced by torch.profiler): "
          f"{gpu_wall:.2f} s wall; stage walls (s) "
          f"{ {k: round(v, 3) for k, v in gpu_stages.items()} }; "
          f"{ex.stats['pnr_dispatch']} pnr dispatches, "
          f"{ex.stats['sim_dispatch']} sim dispatches, launches {launches}; "
          f"the trace holds {sum(len(v) for v in kern.values())} device "
          f"activities of {len(kern)} names, of this repository's kernels "
          f"{ {k: v for k, v in ours.items() if v} }; the device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / (gpu_wall * 1e3):.2f}% of "
          f"the wall)", flush=True)
    if ours["anneal_kernel"] != launches["k2"] \
            or ours["sim_stepper_kernel"] != launches["k3"]:
        fail(f"the profiler's trace ({ours}) disagrees with the launch "
             f"counters ({launches})")
    if launches["k1"] or any(v for k, v in ours.items() if k not in (
            "anneal_kernel", "sim_stepper_kernel")):
        fail(f"the main path launched K1 or a kernel off its path: "
             f"{launches}, {ours}")
    if launches["k2"] == 0:
        fail(f"the main path skipped a kernel: launches {launches}")
    if not (launches["k3"] == ex.stats["sim_dispatch"] == len(buckets) > 0):
        fail(f"K3 launched {launches['k3']} times for {len(buckets)} sim "
             f"buckets ({ex.stats['sim_dispatch']} dispatches)")
    if any(f.stage != "schedule" for f in res.failures):
        fail(f"cuda run degraded: {[f.to_dict() for f in res.failures]}")
    sims = [r for r in rows if r["sim_bucket"]]
    if len(rows) != 16 or len(sims) != 16 - len(res.failures) or not all(
            r["fabric_wirelength"] > 0 and r["fabric_energy_per_op_pj"] > 0
            and all(v == v and abs(v) != float("inf")
                    for v in r.values() if isinstance(v, float))
            for r in rows):
        fail("cuda records are incomplete or not finite")
    if not all(r["sim_verified"] == 1 and r["sim_ii"] >= r["sim_min_ii"] > 0
               for r in sims):
        fail("a simulated pair is not golden-verified against the "
             "interpreter")
    card_pnrs = ex.pnr()                # memo hits: the card's placements
    ex_cpu = Explorer(apps, cfg, store=ex._store, device="cpu")
    ex_cpu.forget("pnr", "sched", "sim")
    res_cpu, cpu_wall, cpu_stages = traced_run(ex_cpu)
    print(f"Explorer.run() on cpu (plain versions): {cpu_wall:.2f} s wall; "
          f"stage walls (s) "
          f"{ {k: round(v, 3) for k, v in cpu_stages.items()} }", flush=True)
    if [r.to_dict() for r in res_cpu.records()] != rows:
        fail("records on cuda differ from the cpu rerun")
    if res_cpu.sim_buckets != res.sim_buckets:
        fail("sim buckets on cuda differ from the cpu rerun")
    if [f.to_dict() for f in res_cpu.failures] \
            != [f.to_dict() for f in res.failures]:
        fail("failure rows on cuda differ from the cpu rerun")
    if ex_cpu.stats["mine"] or ex_cpu.stats["map"]:
        fail("the cpu rerun re-mined: the front half must be shared")
    fails = [(f.stage, f.pe_name, f.app, f.error_type)
             for f in res.failures]
    print(f"{len(rows)} records ({len(sims)} simulated and golden-verified, "
          f"{len(buckets)} sim buckets), failure rows {fails} identical on "
          f"cuda and cpu")
    print(res.table())
    cpu_pnrs = ex_cpu.pnr()

    # -- 5: kernel times and bounds at the largest signature ---------------
    phase("5 kernel timing")
    sig, d, pnc0 = largest
    k1_args = (d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
               d["net_mask"])
    r_n, e_n = d["slot0"].shape
    n_n, d_n = d["net_pins"].shape[1:]
    # K1's function is K2's prologue: K2 with zero steps stages the tables,
    # scores the start and writes it out as the best placement
    zero = {k: (v[:, :0].contiguous() if k in ("a", "t", "log_u", "temps",
                                                "active") else v)
            for k, v in d.items()}
    args0 = [zero[k] for k in KERNEL_INPUTS]
    pro = torch.full_like(pnc0, -1.0)
    out0 = pnr_cost.anneal_chains(*args0, pnc0_out=pro)
    torch.cuda.synchronize()
    if not (torch.equal(pro, pnc0) and torch.equal(out0[0], d["slot0"])
            and torch.equal(out0[1], pnc0.sum(dim=1))):
        fail("K2 with zero steps does not return its start")
    # the kernel alone (its device time in the profiler's trace) and with
    # its wrapper (the pin table and the outputs; CUDA events)
    reps = 20
    _, kern0, _ = device_kernels(lambda: [
        pnr_cost.anneal_chains(*args0, pnc0_out=pro) for _ in range(reps)])
    k1_times = [t for k, v in kern0.items() if "anneal_kernel" in k
                for t in v]
    if len(k1_times) != reps:
        fail(f"the profiler traced {len(k1_times)} launches of K2 with zero "
             f"steps for {reps}")
    k1_ms = sum(k1_times) / reps
    k1_wrap = cuda_ms(lambda: pnr_cost.anneal_chains(*args0, pnc0_out=pro),
                      reps)
    k1_plain = cuda_ms(lambda: pnr_cost.anneal_chains_plain(
        *args0, pnc0_out=pro), 5)
    k1_plain_costs = cuda_ms(
        lambda: pnr_cost.net_hpwl_rows_plain(*k1_args), 5)
    # what that launch must move: the problems' tables as the kernel reads
    # them (pin table, slot coordinates, ent_nets), the chains' start, and
    # the starting costs, slots and cost it writes; its operations are the
    # prologue's (K1's: 4 a pin, 3 a net)
    tab = pnr_cost.pin_table(d["net_pins"], d["net_mask"])
    k1_pins = int(d["net_mask"][d["prob"].long()].sum())
    k1_bytes = nbytes(d["prob"], d["slot_xy"], tab, d["ent_nets"],
                      d["slot0"], pnc0) + r_n * (e_n * 4 + 4)
    k1_ops = 4 * k1_pins + 3 * r_n * n_n
    args = [d[k] for k in KERNEL_INPUTS]
    k2_ms = cuda_ms(lambda: pnr_cost.anneal_chains(*args), 3)
    k2_steps = d["a"].shape[1]
    print(f"K2 at {'x'.join(map(str, sig))}: {k2_ms:.4f} ms, "
          f"{1e3 * k2_ms / k2_steps:.4f} us a step; with zero steps (staging, "
          f"the prologue, which computes K1's function, and writing the "
          f"start out) {k1_ms:.4f} ms alone (torch.profiler), {k1_wrap:.4f} "
          f"ms with its wrapper, {k1_plain:.4f} ms plain (the starting "
          f"costs alone {k1_plain_costs:.4f} ms); summed over the main "
          f"path's {launches['k2']} launches {k2_sum:.4f} ms", flush=True)
    if launches["k2"] != len(per_sig):
        fail(f"K2 launched {launches['k2']} times on the main path for "
             f"{len(per_sig)} bucket signatures")
    work = {}
    t0 = time.perf_counter()
    pnr_cost.anneal_chains_plain(*args, work=work)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    k2_bytes = nbytes(*args) + r_n * (e_n * 4 + 4)
    k2_ops = 4 * work["pins"] + 5 * work["nets"] + 4 * work["steps"]

    # K3 at the largest sim signature (the default 3 iterations x 2 rows),
    # and again at a larger input batch over the same programs
    ssig, sprogs, tabs, x, op_ids = largest_sim
    kw = dict(cycles=ssig[8], latch_depth=ssig[9])
    # the kernel alone (launch_stepper), state in shared and in global
    # memory, full and empty cycles (the floor: barriers and event walks)
    k3_t = {}
    for fl in (False, True):
        for fg in (False, True):
            prep = sim_step.prepare_stepper(tabs, x, op_ids, floor=fl,
                                            force_global=fg, **kw)
            k3_t[fl, fg] = cuda_ms(lambda: sim_step.launch_stepper(prep), 20)
    k3_ms, k3_global_ms = k3_t[False, False], k3_t[False, True]
    k3_floor, k3_floor_global = k3_t[True, False], k3_t[True, True]
    k3_wrap = cuda_ms(lambda: sim_step.simulate_batch_stepper(
        tabs, x, op_ids, **kw), 20)
    k3_plain = cuda_ms(lambda: sim_step.simulate_batch_plain(
        tabs, x, op_ids, **kw), 2)
    k3_bytes = nbytes(*tabs.values(), x, op_ids) \
        + x.shape[0] * x.shape[1] * x.shape[2] * ssig[7] * 4
    # one ALU operation per active micro-op slot, every cycle and row
    k3_ops = ssig[8] * x.shape[1] * sum(p.n_inst * p.n_steps for p in sprogs)
    bsig = sim_signature(sprogs[0], BIG_ITERS, BIG_BATCH)
    bprogs = [p for p in sprogs
              if sim_signature(p, BIG_ITERS, BIG_BATCH) == bsig]
    barrs = [random_inputs(p, BIG_ITERS, BIG_BATCH, seed=i)
             for i, p in enumerate(bprogs)]
    btabs, bx, bops = bucket_tensors(bprogs, barrs, bsig, dev)
    bkw = dict(cycles=bsig[8], latch_depth=bsig[9])
    bprep = sim_step.prepare_stepper(btabs, bx, bops, **bkw)
    k3_big_ms = cuda_ms(lambda: sim_step.launch_stepper(bprep), 5)
    big_got = sim_step.simulate_batch_stepper(btabs, bx, bops, **bkw)
    big_want = sim_step.simulate_batch_plain(btabs, bx, bops, **bkw)
    torch.cuda.synchronize()
    if not same_bits(big_got, big_want):
        fail(f"K3 differs from its plain version at {bsig}")
    cyc = ssig[8]
    print(f"K3 at {'x'.join(map(str, ssig))} ({len(sprogs)} program(s), "
          f"{sim_step.stepper_state_bytes(*ssig[:7], ssig[9])} B state, "
          f"{cyc} cycles): {k3_ms:.4f} ms ({1e3 * k3_ms / cyc:.3f} us a "
          f"cycle) with its state in shared memory, {k3_global_ms:.4f} ms "
          f"({1e3 * k3_global_ms / cyc:.3f} us) in global memory; empty "
          f"cycles (the floor) {k3_floor:.4f} ms "
          f"({1e3 * k3_floor / cyc:.3f} us a cycle), {k3_floor_global:.4f} "
          f"ms in global memory; bytes bound "
          f"{k3_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms; with the wrapper's "
          f"host work {k3_wrap:.4f} ms; plain {k3_plain:.1f} "
          f"ms; at sim_batch={BIG_BATCH}, sim_iterations={BIG_ITERS} "
          f"({'x'.join(map(str, bsig))}): {k3_big_ms:.4f} ms, == plain",
          flush=True)

    # -- 6: the fused-PE path: ML-suite PEs on K4, MAC + epilogue on K5 ---
    phase("6 fused-PE path: ML-suite configurations through K4, "
          "matmul + PE epilogue through K5")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the plain K5 "
             "product would not be float32")
    # benchmarks/common.py BENCH_MINING, benchmarks/fig11_ml_pe.py
    bench_mining = MiningConfig(min_support=4, max_pattern_nodes=8,
                                time_budget_s=45, max_patterns_per_level=60)
    t0 = time.perf_counter()
    ml = Explorer(ml_graphs(), ExploreConfig(
        mode="domain", mining=bench_mining, per_app_subgraphs=2,
        domain_name="PE_ML"), device="cuda")
    ml_runs = [ml.run(), ml.with_config(mode="per_app", max_merge=3).run()]
    variants = [v for r in ml_runs for dse in r.results.values()
                for v in dse.variants]
    configs = [(v.name, c, v.datapath) for v in variants
               for c in sorted(v.datapath.configs)]
    print(f"ML-suite front half: {len(variants)} variants, {len(configs)} "
          f"configurations in {time.perf_counter() - t0:.1f} s", flush=True)
    shape = (TOKENS, D_FF)
    gen = torch.Generator(device=dev).manual_seed(15)
    n_max = max(len(free_in_ports(dp.configs[c].pattern))
                for _, c, dp in configs)
    pool = [torch.rand(shape, generator=gen, device=dev) * 3 - 1.5
            for _ in range(n_max)]
    x5 = torch.randn((TOKENS, D_MODEL), generator=gen, device=dev)
    w5 = torch.randn((D_MODEL, D_FF), generator=gen, device=dev) \
        / D_MODEL ** 0.5                    # a layer's initialisation
    bias = torch.randn((D_FF,), generator=gen, device=dev) * 0.1
    skip = torch.randn(shape, generator=gen, device=dev)
    relu_tail = [("add", (-1, -1)), ("const", ()), ("max", (0, 1))]
    conv_tail = pattern_from_spec(relu_tail)      # apps/mlkernels.py Conv
    block_tail = pattern_from_spec(relu_tail)     # apps/mlkernels.py Block
    k5_cases = {
        "a": ((), dict()),
        "b": ((bias,), dict(epilogue=conv_tail, extra_kinds=("vec",))),
        "c": ((skip,), dict(epilogue=block_tail, extra_kinds=("full",))),
        "d": ((bias,), dict(epilogue=conv_tail, extra_kinds=("vec",),
                            out_dtype=torch.bfloat16)),
    }

    def max_diff(got, want) -> float:
        got, want = got.double(), want.double()
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        return float(torch.where(same, 0.0, (got - want).abs()).max())

    # every Triton JIT specialisation of K4 in this phase, recorded by
    # buildprof: one for each distinct (pattern, dtype) launched
    k4_builds = MetricsRegistry()
    buildprof.enable(registry=k4_builds)
    pe_fused.pe_apply.launches = 0
    gemm.gemm_pe.launches = 0
    applied, refused, k4_err = 0, [], 0.0
    distinct = {}
    for vname, cname, dp in configs:
        pat = dp.configs[cname].pattern
        try:
            fn = kernel_from_config(dp, cname)
        except ValueError as e:          # the reference refuses it too
            refused.append((vname, cname, str(e)))
            continue
        xs = pool[:len(free_in_ports(pat))]
        got = fn(*xs)
        applied += 1
        want = pe_fused.pe_apply_plain(pat, *xs)
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got, want)]):
            if not bool(torch.isclose(g, w, rtol=K4_TOL, atol=K4_TOL,
                                      equal_nan=True).all()):
                fail(f"K4 differs from its plain version on {vname}/{cname}")
            k4_err = max(k4_err, max_diff(g, w))
        distinct.setdefault(pe_fused.lower_pattern(pat).key,
                            (f"{vname}/{cname}", pat))
    k5_out = {}
    for case, (extras, kw) in k5_cases.items():
        k5_out[case] = matmul_fused(x5, w5, *extras, **kw)
    torch.cuda.synchronize()
    launches["k4"] = pe_fused.pe_apply.launches
    launches["k5"] = gemm.gemm_pe.launches
    print(f"K4 applied {applied} configurations ({len(distinct)} distinct "
          f"patterns), each == plain at {K4_TOL}; refused {len(refused)} "
          f"as the reference does: {refused}; launches "
          f"{ {k: launches[k] for k in ('k4', 'k5')} }", flush=True)
    if launches["k4"] != applied or applied == 0:
        fail(f"K4 launched {launches['k4']} times for {applied} "
             f"configurations")
    if launches["k5"] != len(k5_cases):
        fail(f"K5 launched {launches['k5']} times for {len(k5_cases)} "
             f"matmuls")
    k5_err = 0.0
    for case, (extras, kw) in k5_cases.items():
        got = k5_out[case]
        want = gemm.gemm_pe_plain(x5, w5, *extras, **kw)
        if got.shape != shape or got.dtype != want.dtype:
            fail(f"K5 ({case}) returned {got.dtype} {tuple(got.shape)}")
        d = (got.double() - want.double()).abs()
        lim = K5_TOL * want.double().abs().clamp(min=1.0)
        if case == "d":
            # float32 sums that differ in the last bits can round to
            # neighbouring bfloat16 values, 2^(e-7) apart in [2^e, 2^(e+1)):
            # allow that step where it is wider than 1e-4 * |plain|; the
            # kernel's own float32 result (b) rounds to (d) exactly
            step = torch.exp2(torch.floor(torch.log2(
                want.double().abs().clamp(min=2.0 ** -126))) - 7)
            lim = torch.maximum(lim, step)
            if not torch.equal(got, k5_out["b"].to(torch.bfloat16)):
                fail("K5 (d) is not K5 (b) rounded to bfloat16")
        if not bool((d <= lim).all()) or not bool(torch.isfinite(got).all()):
            fail(f"K5 ({case}) differs from its plain version: max |diff| "
                 f"{float(d.max())}")
        if case != "d":
            k5_err = max(k5_err, float(d.max()))
    print(f"K5 (a)-(d) == plain within 1e-4 * max(1, |plain|); max |diff| "
          f"{k5_err}", flush=True)

    # outside the counted run: bfloat16 once per distinct pattern, and
    # both kernels against the float64 oracles on small inputs
    small = torch.rand((64, 128), generator=gen, device=dev) * 3 - 1.5
    for key, (label, pat) in sorted(distinct.items()):
        n_in = len(free_in_ports(pat))
        xs = [x.to(torch.bfloat16) for x in pool[:n_in]]
        got = pe_fused.make_pe_kernel(pat)(*xs)
        want = pe_fused.pe_apply_plain(pat, *xs)
        filled = pat.copy()          # mined constants carry no value:
        for n, op in filled.nodes.items():     # the kernels bake 0.0
            if op == "const" and filled.attr(n, "value") is None:
                filled.attrs.setdefault(n, {})["value"] = 0.0
        oracle = ref_pe(filled, *[small * (i + 1) / n_in
                                  for i in range(n_in)])
        got_small = pe_fused.make_pe_kernel(pat)(
            *[small * (i + 1) / n_in for i in range(n_in)])
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got, want)]):
            if not bool(torch.isclose(g.float(), w.float(), rtol=K4_BF16_TOL,
                                      atol=K4_BF16_TOL, equal_nan=True).all()):
                fail(f"K4 in bfloat16 differs from its plain version on "
                     f"{label}")
        for g, w in zip(*[o if isinstance(o, tuple) else (o,)
                          for o in (got_small, oracle)]):
            w = torch.as_tensor(w, device=dev).double().expand(g.shape)
            if not bool(torch.isclose(g.double(), w, rtol=K4_TOL,
                                      atol=K4_TOL, equal_nan=True).all()):
                fail(f"K4 differs from the float64 oracle on {label}")
    xs5, ws5 = x5[:100, :70], w5[:70, :50]
    for extras, kw in ((), {}), ((bias[:50],), k5_cases["b"][1]), \
            ((skip[:100, :50],), k5_cases["c"][1]):
        got = matmul_fused(xs5, ws5, *extras, **kw)
        want = ref_gemm_pe(xs5.cpu(), ws5.cpu(),
                           *[e.cpu() for e in extras], **kw)
        if not torch.allclose(got.cpu(), want, rtol=K5_TOL, atol=K5_TOL):
            fail("K5 differs from the float64 oracle at 100x70x50")
    print(f"K4 in bfloat16 == plain at {K4_BF16_TOL} on {len(distinct)} "
          f"patterns; K4 and K5 == float64 oracles on small inputs",
          flush=True)

    # times: K4 at the largest and the median distinct pattern
    def pe_size(item):
        prog = pe_fused.lower_pattern(item[1])
        return (prog.n_in + len(prog.outs), prog.n_compute, item[0])

    ranked = sorted(distinct.values(), key=pe_size)
    numel = pool[0].numel()

    def library_call(prog, xs):
        """One torch call computing the pattern, where there is one: a
        binary op or mul -> add over the inputs (torch.addcmul)."""
        body = [(st.op, st.args) for st in prog.stmts]
        one = {"add": torch.add, "mul": torch.mul, "max": torch.maximum}
        if len(body) == 1 and body[0][0] in one \
                and body[0][1] == ("p0", "p1"):
            return lambda: one[body[0][0]](xs[0], xs[1])
        if [op for op, _ in body] == ["mul", "add"] \
                and body[0][1] == ("p0", "p1") \
                and body[1][1] == (prog.stmts[0].dst, "p2"):
            return lambda: torch.addcmul(xs[2], xs[0], xs[1])
        return None

    k4_rows = []
    for which, (label, pat) in (("largest", ranked[-1]),
                                ("median", ranked[len(ranked) // 2])):
        prog = pe_fused.lower_pattern(pat)
        xs = pool[:prog.n_in]
        fn = pe_fused.make_pe_kernel(pat)
        ms = cuda_ms(lambda: fn(*xs), 20)
        plain_ms = cuda_ms(lambda: pe_fused.pe_apply_plain(pat, *xs), 5)
        lib = library_call(prog, xs)
        lib_ms = cuda_ms(lib, 20) if lib else None
        k4_bytes = (prog.n_in + len(prog.outs)) * 4 * numel
        k4_ops = prog.n_compute * numel
        k4_rows.append((which, label, prog, ms, plain_ms, lib_ms, k4_bytes,
                        k4_ops))
        print(f"K4 at the {which} pattern {label} ({prog.n_in} in, "
              f"{len(prog.outs)} out, {prog.n_compute} ops, "
              f"{[s.op for s in prog.stmts]}): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
              f"{k4_bytes} bytes", flush=True)

    buildprof.disable()
    # float32 at (4096, 8192) and (64, 128), both with n % 16 == 0 (one
    # specialisation), and bfloat16, for every distinct Triton rendering
    renderings = {pe_fused.triton_source(pe_fused.lower_pattern(pat))
                  for _, pat in distinct.values()}
    k4_jit = k4_builds.counter("kernels.compile.triton")
    print(f"buildprof: {k4_jit} Triton specialisations of K4 in "
          f"{k4_builds.histogram('kernels.compile.secs').total:.2f} s for "
          f"{len(renderings)} distinct renderings ({len(distinct)} "
          f"patterns) x (float32, bfloat16)", flush=True)
    if k4_jit != 2 * len(renderings) \
            or k4_builds.counter("kernels.compile.events") != k4_jit:
        fail(f"buildprof counted {k4_builds.counters('kernels.compile')} "
             f"for {len(renderings)} distinct renderings in two dtypes")

    k5_ms = {}
    for case in ("a", "b", "c"):
        extras, kw = k5_cases[case]
        k5_ms[case] = cuda_ms(lambda: matmul_fused(x5, w5, *extras, **kw),
                              10)
    k5_plain = cuda_ms(lambda: gemm.gemm_pe_plain(x5, w5), 10)
    k5_lib = cuda_ms(lambda: torch.matmul(x5, w5), 10)
    k5_ops = 2 * TOKENS * D_MODEL * D_FF
    k5_bytes = nbytes(x5, w5) + TOKENS * D_FF * 4
    print(f"K5 at {TOKENS}x{D_MODEL}x{D_FF}: (a) {k5_ms['a']:.4f} ms "
          f"({k5_ops / k5_ms['a'] / 1e9:.2f} TFLOP/s of float32 product, "
          f"{3 * k5_ops / k5_ms['a'] / 1e9:.2f} of TF32 tensor-core work), "
          f"(b) {k5_ms['b']:.4f} ms, (c) {k5_ms['c']:.4f} ms; plain (a) "
          f"{k5_plain:.4f} ms; torch.matmul {k5_lib:.4f} ms", flush=True)
    if k5_ms["a"] >= k5_lib:
        fail(f"K5 ({k5_ms['a']:.4f} ms) is not faster than torch.matmul "
             f"({k5_lib:.4f} ms)")

    # -- 7: the attention / selective-scan boundary at model widths -------
    p7 = attention_scan_phase(dev, launches)

    # -- 8: hierarchical placement at mega-fabric size -------------------
    p8 = hier_phase(dev)

    # -- 9: serving on the card, and the rest of observability -----------
    phase("9 serving on the card: four overlapping clients through "
          "repro_torch.serve; analyze_pnr and buildprof")
    skip = {(f.pe_name, f.app) for f in res.failures}
    analyze_check(card_pnrs, cpu_pnrs, skip)
    buildprof_nvcc_check()
    p9 = serve_phase(apps, cfg, front, rows,
                     [f.to_dict() for f in res.failures], card)

    # -- 10: LM serving at full width, prefill attention on K6 -----------
    p10 = lm_phase(dev, card)

    # -- 11: Mamba serving at full width, prefill's scan on K7 ------------
    p11 = mamba_phase(dev, card)

    # -- 12: MoE serving at full width, prefill attention on K6 -----------
    p12 = moe_phase(dev, card)

    # -- 13: hybrid serving at full width, K6 and K7 in every prefill -----
    p13_k6, p13_k7 = hymba_phase(dev, card)

    # -- 14: the LM idiom graphs, mined and applied through K4 ------------
    p14 = lm_idiom_phase(dev, card)

    # -- 15: training at full width, K6 and K7 under autograd -------------
    p15_k6, p15_k7 = train_phase(dev, card)

    # -- 16: the distribution layer, K6 in (a), (e) and (g) ---------------
    p16 = distribution_phase(dev, card)
    p16.update(shard_flags_check(dev, card))

    # -- 17: phase 15's step counted, its roofline and MFU ---------------
    p17 = roofline_phase(card, p15_k6["train_step_ms"])

    # -- 18: the JAX package's kernel entry points on K2 and K3 ----------
    p18 = entry_points_phase(dev, card)

    # -- 19: the kernels line ---------------------------------------------
    phase("19 the kernels line")
    def bound(b, ops, peak=FP32_OPS_PER_S):
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    kernels = []
    for name, src, repl, n, err, ms, plain_ms, b, ops in (
            ("anneal_kernel with zero steps (K1, folded into K2's "
             "prologue)", "pnr_anneal.cu",
             "src/repro/kernels/pnr_cost.py:108", launches["k1"],
             max_err["k1"], k1_ms, k1_plain, k1_bytes, k1_ops),
            ("anneal_kernel (K2)", "pnr_anneal.cu",
             "src/repro/kernels/pnr_cost.py:185", launches["k2"],
             max_err["k2"], k2_ms, k2_plain, k2_bytes, k2_ops),
            ("sim_stepper_kernel (K3)", "sim_step.cu",
             "src/repro/kernels/sim_step.py:144", launches["k3"],
             max_err["k3"], k3_ms, k3_plain, k3_bytes, k3_ops)):
        b_ms, by = bound(b, ops)
        kernels.append({"name": name, "route": "cuda", "source": CSRC + src,
                        "replaces": repl, "launches": n, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": by, "library_ms": None})
    # K1's row times K2 launched with zero steps: staging, the prologue
    # (K1's function) and writing the start out, the kernel alone; its
    # launches are the profiler's count of K1 on the main path
    kernels[0]["timed"] = ("anneal_kernel with zero steps and pnc0_out: "
                           "staging, the prologue and writing the start "
                           "out; ms alone (torch.profiler), wrapper_ms with "
                           "its wrapper, launches counted in the main "
                           "path's trace")
    kernels[0]["wrapper_ms"] = k1_wrap
    # K3's ms is its launch alone; with the wrapper's host work (checks,
    # event lists, buffers), as the main path pays it:
    kernels[2]["wrapper_ms"] = k3_wrap
    # K2's and K3's launches on the second path into them: the served
    # batch of phase 9
    kernels[1]["serve_launches"], kernels[2]["serve_launches"] = \
        p9["served_k"]
    _, _, prog, ms, plain_ms, lib_ms, b, ops = k4_rows[0]
    b_ms, by = bound(b, ops)
    kernels.append({"name": "pe_kernel (K4)", "route": "triton",
                    "source": "src/repro_torch/kernels/pe_fused.py",
                    "replaces": "src/repro/kernels/pe_fused.py:71",
                    "launches": launches["k4"], "max_abs_err": k4_err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": lib_ms})
    # K4's launches on the LM idioms (phase 14) and its time at the
    # largest of them
    kernels[-1].update(p14)
    # the function's own operations at the tensor cores' TF32 rate; the
    # three TF32 products K5 does for each float32 one are its cost, not
    # the function's, and are printed apart as a share of that work
    b_ms, by = bound(k5_bytes, k5_ops, TF32_OPS_PER_S)
    tf32_ms = bound(k5_bytes, 3 * k5_ops, TF32_OPS_PER_S)[0]
    print(f"K5 (a): {k5_ms['a']:.4f} ms against a bound of {b_ms:.4f} ms "
          f"({by}, 2MNK at 495 TFLOP/s: {100 * b_ms / k5_ms['a']:.1f}%); "
          f"its 3xTF32 tensor-core work alone takes {tf32_ms:.4f} ms at that "
          f"rate ({100 * tf32_ms / k5_ms['a']:.1f}% of its time)")
    kernels.append({"name": "gemm_pe_kernel (K5)", "route": "cuda",
                    "source": CSRC + "gemm_pe.cu",
                    "replaces": "src/repro/kernels/gemm.py:51",
                    "launches": launches["k5"], "max_abs_err": k5_err,
                    "ms": k5_ms["a"], "plain_ms": k5_plain, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": k5_lib})
    k6_rows = p7["k6_rows"]
    k7_ms, k7_plain = p7["k7_ms"], p7["k7_plain"]
    k7_bytes, k7_ops = p7["k7_bytes"], p7["k7_ops"]
    ms, plain_ms, lib_ms, b, ops, peak, _ = k6_rows["a"]
    b_ms, by = bound(b, ops, peak)
    kernels.append({"name": "flash_attention_kernel (K6)", "route": "cuda",
                    "source": CSRC + "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:29",
                    "launches": launches["k6"], "max_abs_err": p7["k6_err"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": lib_ms})
    # K6's launches on the LM serving paths (phases 10, 12 and 13) and its
    # time there, a launch at each served prefill's shape, beside its
    # bound and SDPA
    kernels[-1].update(p10)
    kernels[-1].update(p12)
    kernels[-1].update(p13_k6)
    # K6 on the training path (phase 15): launches in the launcher's run,
    # its time at the training shape, its plain backward's
    kernels[-1].update(p15_k6)
    # K6 in the distribution layer's phase 16: the compressed train step's
    # forward (a) and gpipe's microbatches (e)
    kernels[-1].update(p16)
    b_ms, by = bound(k7_bytes, k7_ops)
    kernels.append({"name": "mamba_scan_kernel (K7)", "route": "cuda",
                    "source": CSRC + "mamba_scan.cu",
                    "replaces": "src/repro/kernels/mamba_scan.py:24",
                    "launches": launches["k7"], "max_abs_err": p7["k7_err"],
                    "ms": k7_ms, "plain_ms": k7_plain, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": None})
    # K7's launches on the Mamba serving paths (phases 11 and 13) and its
    # time at the served prefill's shape, beside its bound
    kernels[-1].update(p11)
    kernels[-1].update(p13_k7)
    # K7 on the training path: the reduced Mamba configurations' steps
    # (phase 15 b), its plain backward at falcon-mamba's served shape
    kernels[-1].update(p15_k7)
    for case, (ms, plain_ms, lib_ms, b, ops, peak, pairs) in k6_rows.items():
        b_ms, by = bound(b, ops, peak)
        split = "" if peak == BF16_OPS_PER_S else (
            f"; its 3xTF32 work alone {3 * ops / peak * 1e3:.4f} ms")
        lib = "none" if lib_ms is None else (
            f"{lib_ms:.4f} ms ({p7['sdpa_backend'][case]}), K6 at "
            f"{ms / lib_ms:.2f}x its time")
        print(f"K6 ({case}): {ms:.4f} ms against a bound of {b_ms:.4f} ms "
              f"({by}, 4·D a pair at {peak / 1e12:.0f} TFLOP/s: "
              f"{100 * b_ms / ms:.1f}% of it{split}; one expf a pair on "
              f"the SFUs {pairs / SFU_PER_S * 1e3:.4f} ms), plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib}")
    b_ms, by = bound(k7_bytes, k7_ops)
    print(f"K7: {k7_ms:.4f} ms against a bound of {b_ms:.4f} ms ({by}), "
          f"plain {k7_plain:.4f} ms, library none")
    print(f"K1/K2 timed at signature {'x'.join(map(str, sig))} "
          f"(R={r_n} chains, E={e_n}, N={n_n}, D={d_n}); K2 work {work}; "
          f"K3 work {k3_ops} ALU operations, {k3_bytes} bytes")
    # the JAX package's kernel entry points on K2 and K3 (phase 18)
    kernels.extend(p18)
    for row in kernels:
        if row["ms"] < row["bound_ms"]:
            fail(f"{row['name']} reads {row['ms']} ms, below its bound of "
                 f"{row['bound_ms']} ms: the bound is miscounted")
    print(f"phase walls (s): {phase_walls()}", flush=True)
    print(f"the roofline (phase 17): {json.dumps(p17)}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
