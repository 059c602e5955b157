"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. build every kernel under src/repro_torch/kernels/csrc with nvcc (sm_90a),
   print each kernel instance's registers, static shared memory and spills
   from ``-Xptxas -v``, require no spills in the attention and SSD kernels
   and ``HGMMA`` (wgmma) instructions in the flash kernel's SASS;
2. hold the makespan kernel against its plain PyTorch version on the card,
   bit for bit, at the shapes the main path gives it and at four edges
   (whole-number durations, so free times tie; a zero transfer rate and zero
   data on used links, so makespans are inf and NaN; 100 predecessors a
   task; a 128-slot core window), and time both (device time per call,
   ``cuda_ms``) at Table IX and at the 8-instance sweep, each with the
   core-free rows in shared memory and in L2;
3. the Table IX GA: ``ga`` on a 500-node x 500-task problem at the ``ga()``
   defaults (population 64, 60 generations), engine ``auto`` on ``cuda``;
   every generation's fitness must go through the kernel, the schedule must
   be valid, and the f32 oracle must re-score the best assignment to the
   kernel's makespan;
4. ``ga_sweep`` over eight such instances (seeds 0-7) through the batched
   kernel, with the same checks;
5. the same GA through the plain version (``GA_PLAIN``: 10 of its 60
   generations), and a ``torch.profiler`` pass
   over the kernel GA that splits its wall time into device kernel time by
   kernel name and the rest;
6. the flash and decode attention kernels against their plain versions on
   the card, at the shapes the serving paths give them (qwen2.5-3b prefill
   at the engine's prompt lengths, a chunked prefill, gemma2-2b's head width
   256 with its window and softcap, decode at the serving run's lockstep
   length, with mixed lengths and at one slot of 2048 keys; zamba2-7b's
   shared attention, 32 heads of width 112, prefill at the prompt lengths
   and decode at the lockstep and mixed lengths; qwen3-moe-30b-a3b's 32
   heads over 4 KV heads of width 128, prefill at the longest prompt and
   decode at the lockstep length), at the reduced configs'
   head width 16 and, at small shapes, at every width 8-256 in steps of
   8, in bf16 and f32; at the encdec and vlm families' shapes (whisper-base's
   encoder not causal at 1500 frames, its cross-attention with 8 and 64
   query rows against 1500 keys, its decode cross-attention at G = 1 over
   1500 keys; internvl2-76b's 64 heads over 8 KV heads of 128 behind 256
   patches, prefill and decode), with an explicit ``scale=`` and at
   deepseek-67b's reduced head width 8, each timed; each kernel's dynamic shared
   memory printed, timed (qwen's and zamba2's longest prefill and their
   4-slot decodes among others) beside their plain versions and one
   PyTorch call that computes the same function
   (``scaled_dot_product_attention``); the decode kernel's state variant
   (the output and each row's softmax state) at the sharded serving shapes
   of qwen2.5-3b on (1, 4) (4 slots against a share of 512 keys, some rows
   empty; 128 slots against a share of 8192), its output bit for bit the
   plain decode's, its state within 1e-5 of the plain version's, timed;
   and a card's heads of deepseek-67b and internvl2-76b on (1, 4) (16 over
   2 kv heads of 128) at phase 25 (c)'s shapes in bf16: a causal prompt of
   32,768 positions (held on its last 256 query rows, against every key)
   and deepseek-67b's decode tick at ``FIT_BATCH`` against 32,768 keys,
   timed; and gemma2-2b's heads on a card of (1, 4) (2 over 1 kv head of
   256, softcap 50) at its ``FIT_BATCH`` against a local layer's 4096 keys
   and a global layer's 32,768, the decode kernel and its state variant,
   timed;
7. qwen2.5-3b at full width cut to 12 of its 36 layers (``QWEN_LAYERS``;
   random bf16 weights from a seed; phase 25 (b) serves it whole on four
   cards) served by ``ServeEngine``: 8 requests through 4 slots, 32 new tokens
   each, every prefill layer through the flash kernel and every decode
   layer through the decode kernel; request 0 served alone must equal a
   manual greedy prefill + decode loop; a 2-layer cut of the same width is
   held against the CPU on a 128-token prompt (``CPU_CUT_PROMPTS``; the
   wrappers take the plain versions there); time
   to first token, output tokens/s over the serving window, decode-tick
   tokens/s and a ``torch.profiler`` split;
8. the SSD chunked-scan kernel against its plain version on the card at
   mamba2-780m's prefill shapes (the engine's prompt lengths, one length a
   multiple of the chunk and one under it, and cases with 4 groups and a
   batch of 4, per-head A and dt drawn at random) and at zamba2-7b's (112
   heads, N 64) at L 891 and 64, and at the reduced configs' shape (H 8,
   P 16, N 16, chunk 16, L 9 and 16, the chunk-serial kernel) with a head
   width of 48 at chunk 64, in bf16 and f32, timed
   beside its plain version (no single PyTorch call computes it); the bf16
   kernels' registers and spills, their HGMMA count, and the device kernels
   one wrapper call runs, each one's time;
9. mamba2-780m at full width cut to 12 of its 48 layers (``MAMBA_LAYERS``;
   random bf16 weights from a seed; phase 25 (d) serves it whole on four
   cards) served as in phase 7, every prefill layer through the SSD
   kernel, with the same checks and readings;
10. zamba2-7b at full width cut to 6 of its 81 Mamba2 layers (one
    invocation of the shared attention + MLP block, random bf16 weights
    from a seed; the ROADMAP's cuts once the run passed 1000 s, then to
    make room for phase 25's paths; 25 (d) serves it whole on four cards)
    served
    as in phase 7: every prefill layer through the SSD kernel, every shared
    invocation through the flash kernel in prefill and the decode kernel in
    decode; the card-against-CPU cut is 2 layers with the shared block
    after the second;
11. the serving CLI (``repro_torch.launch.serve``) with no ``--device``
    for the reduced qwen2.5-3b, qwen3-moe-30b-a3b and mixtral-8x7b (head
    width 16, mixtral's window 8), deepseek-67b (head width 8) and
    internvl2-76b (text-only) through both attention kernels, and the
    reduced mamba2-780m and zamba2-7b (chunk 16, N 16, P 16) through the SSD
    kernel's chunk-serial design; ``--arch whisper-base`` must exit with the
    reference CLI's message;
12. PSO, SA and ACO at Table IX 500x500 with the reference's defaults (PSO
    64 particles x 60 iterations, SA 32 chains x 200 steps, ACO 48 ants x
    60 iterations): each once through the kernel and once through the
    plain version on the card from the same seed (SA's comparison at 5
    steps, PSO's and ACO's at 5 iterations, both sides: ``MH_PLAIN``), which must agree bit for
    bit in the best assignment and the history; exactly 61 / 201 / 60
    kernel launches; a valid schedule whose f32 oracle re-score equals the
    kernel's makespan; a ``torch.profiler`` pass over a warm run of each;
    HEFT and OLB on the same instance beside them;
13. the scenario path: an MRI scenario (technique ``auto``: the policy
    routes it to the MILP) and a Table IX scenario (``auto``: GA at 500 <=
    600 tasks) saved as JSON and run through ``python -m repro_torch run``
    in a child process (MRI's makespan within one f64 ulp of 10; the GA
    schedule executed, which needs it valid); the Table IX scenario again
    in this process through ``run_scenario`` (61 launches), the
    ``solve_problems`` GA over phase 4's 8 instances (61 batched launches)
    and an MRI scenario whose slow node triggers a re-solve;
14. the scheduling service: the reference's documented trace (200
    submissions, node events) through ``python -m repro_torch serve`` in a
    child process with no ``--device`` (200 of 200 completed, strict JSON);
    the same trace in this process with the kernel and with the plain
    version on the card, which must serve the same events and records
    (one canonical hash), batch some GA admissions, degrade none, and make
    exactly 7 kernel launches a GA call (6 generations + 1), single or
    batched; a profiled run and a traced one (the host's time by span); the
    chaos lane (120 submissions under failure and drift storms, fallback
    ga -> heft), again with the kernel and with the plain version (one
    canonical hash, 7 launches a GA call), its degraded records printed
    with their trails and none degraded past a GA step that raised; the
    converging and fixed
    cycling streams, whose replay must give the pinned fingerprint; and the
    makespan kernel against its plain version bit for bit at the service's
    shapes (P 16, CMAX 512: an STGS workflow's exact shape and the bucket
    of the three), timed beside its bound;
15. campaigns: the documented Table IX grid ({layered, synthetic} x {5, 10,
    20} x seeds {0, 1} x {milp, heft, olb, ga} on 3 nodes, 48 cells) through
    ``python -m repro_torch campaign run`` in a child process with no
    ``--device`` and ``--trace`` (48 rows, 12 MILP rows ok, the gap report,
    13 kernel launches a GA call read from the trace's ``engine_fitness``),
    the trace validated by ``python -m repro_torch obs``; the same grid in
    this process with the kernel and with the plain version, which must give
    equal rows (wall columns aside), stats and gap report, profiled and
    traced; the Table IX 500 x 500 campaign (8 seeds x HEFT, OLB and the GA
    at its defaults: the 8 GA cells one ``ga_sweep`` of 61 launches, every
    schedule valid); the reference's lanes (smoke, cycling, engine, service,
    chaos) through their exporters into a temporary directory, with
    launches counted against the GA calls, no record degraded and, for the
    service and chaos lanes, one fingerprint over the exporter's run and
    two traced runs; the kernel against its plain version bit for bit at
    the smoke and engine lanes' shapes, timed beside its bound and the
    engine lane's host-timed rows; the tracing overhead on the smoke lane;
    and no ``BENCH_*.json`` of the repository changed;
16. the multi-device instance axis and generated continua: on the one card
    ``local_device_count("cuda")`` is 1 and ``ga_sweep(shard="auto")`` over
    phase 4's family equals ``shard="off"`` bit for bit with 61 launches
    each; a child process stripes that family over 2 and then 8 virtual
    stripes of the card (``REPRO_TORCH_VIRTUAL_DEVICES``): striped fitness
    at 8 x 512 x 512 x 64 x 64 equals the unsharded bits with one launch a
    stripe, ``ga_sweep`` at shard 8 and 3 equals ``"off"``, and the engine
    lane's 1/2/4/8 device-scaling rows are bit-identical; the generated
    1008-node ``large`` continuum (4 tiers, 2 HPC islands) with 8 x
    500-task layered workflows through ``ga_sweep`` at the GA's defaults
    (bucket 512 x 1024 x 64 x 8, 61 launches, every schedule valid,
    profiled for the device's idle share), its kernel held against the
    plain version bit for bit at that shape and timed beside its bound; the
    topology lane with the twin calibration on ``tiny`` and ``small`` into a
    temporary directory (twin error after < before); ``python -m
    repro_torch topology generate large`` and ``topology calibrate small``
    with no ``--device``; and no ``BENCH_*.json`` of the repository changed;
17. the MoE family, every earlier phase's model freed first:
    qwen3-moe-30b-a3b at full width cut to 2 of its 48 layers
    (``MOE_LAYERS``; 128 experts top-8, random bf16 weights and an f32 router
    from a seed; phase 25 (d) serves it whole on four cards) served as in
    phase 7 (16 flash launches, 2 decode launches a tick, request 0 alone == the
    manual loop), a 2-layer f32 cut held against the CPU, the peak memory,
    the decode tick beside its bound, the profile and each MoE stage of one
    layer timed; mixtral-8x7b at full width cut to 2 of its 32 layers
    (``MIXTRAL_LAYERS``), served the same way (16 flash launches);
18. the ML-job continuum: ``schedule_jobs`` with the GA at its defaults on
    the makespan kernel (61 launches, a valid schedule, the kernel's
    makespan == the f32 oracle's), HEFT and ``auto`` beside it, and the job
    scenario through the ``Orchestrator`` with the GA;
19. whisper-base at full width and depth (6 + 6 layers, d 512, 1500
    frames, 88,187,392 parameters, random bf16 weights from a seed): 8
    requests of random frames and 8-token prompts in batches of 4 through
    ``prefill(frames=)`` and 32 greedy decode ticks (18 flash launches a
    prefill, 12 decode a tick), request 0 alone against its row of the
    batch, a profiled batch, and the whole model in f32 card against CPU;
20. internvl2-76b at full width cut to 2 of its 80 layers (3,814,760,448
    parameters; phase 25 (c) serves all 80 on four cards): served text-only
    by ``ServeEngine`` as in phase 7, then 4 requests of 256 random patch
    embeddings and 128 tokens through ``prefill(patches=)`` and 31 decode
    ticks (2 flash a prefill, 2 decode a tick), request 0 alone against its
    row, the peak memory, the tick
    beside the bytes of the weights it reads, and a 1-layer f32 cut card
    against CPU;
21. sampling and the int8 KV cache: greedy == argmax, the top-k and top-p
    masks on the card == on the CPU bit for bit, draws from a CUDA
    generator inside the mask; ``quantize_kv`` / ``dequantize_kv`` of
    whisper's real cache on the card == on the CPU bit for bit, and decode
    attention through the kernel over the dequantized cache within 0.05 of
    the bf16 cache;
22. training: ``FlashAttentionFn`` and ``SSDScanFn`` (the kernel's forward,
    a backward by autograd of the plain version recomputed) against
    autograd of the plain version at the training shapes (qwen2.5-3b B 4 ×
    S 1024, gemma2-2b's D 256 with softcap and window, whisper-base's cross
    Sq 8 against 1500 keys, mamba2-780m's scan B 4 × L 1024) in bf16 and
    f32, timed beside SDPA's forward and backward; qwen2.5-3b and
    mamba2-780m at full width and depth in bf16 (random weights from a
    seed) trained for 5 steps at batch 4 × 1024 tokens with remat (72 flash
    launches a qwen step, 96 SSD launches a mamba2 step: the forward and
    its recomputation), every parameter's gradient finite and non-zero at
    step 1, ms a step against the bound 6·N·tokens (8·N·tokens beside
    it, with the remat forward), one step at
    ``microbatches=2``, a profiled step's idle share, the peak memory and
    ``evaluate`` on 2 batches; both cut to ``TRAIN_CPU_LAYERS`` (1) in f32,
    card against CPU (loss, every gradient, one AdamW step); the ``Trainer`` at the
    reduced qwen2.5-3b, straight against checkpointed and resumed, in the
    default and the deterministic mode; the training CLI with no
    ``--device`` for every reduced config the token stream can train (and
    gemma2-2b in a child process), whisper-base and internvl2-76b stopping
    with the reference's ``KeyError``;
23. the dry-run (``launch/dryrun.py``): the whole sweep (10 architectures x
    their shape suites x the meshes (16, 16) and (2, 16, 16), 68 cells on
    meta) in a child started before phase 1 on a core of its own, every
    cell ``ok``; on a (1, 1)
    mesh its prediction of qwen2.5-3b's and mamba2-780m's training steps at
    4 x 1024 and a qwen2.5-3b decode tick of 4 slots against the same steps
    on the card: argument bytes equal, FLOPs equal to the same counter
    (``launch/op_costs.py``) run over the real step, the peak within
    ``PEAK_BAND`` of ``torch.cuda.max_memory_allocated``, the roofline
    beside the measured ms; the four-card plan (per-card parameter bytes
    and the ``decode_32k`` peak of deepseek-67b, internvl2-76b and
    mixtral-8x7b under serve-tp on (data 1, model 4)); no kernel launch in
    any dry-run;
24. the sharded training step on real exchanges
    (``distributed/comm.py::DistComm``): four child processes share the
    card in a gloo group (each exchange staged through the host), each a
    device of (data 2, model 2) under ``baseline`` ((data 1, model 4) too
    until the families below came; four cards run both); qwen2.5-3b at
    full width cut to 2 layers in f32 (TF32
    off), batch 4 x 1024, two AdamW steps against the unsharded step on the
    card (losses within 1e-4, the parameters gathered whole within atol
    2e-4, rtol 2e-3); every rank's argument bytes, FLOPs, kernel calls and
    exchanges by kind == the dry-run's cell of the same cut and mesh on
    meta, exactly; 2 flash launches a layer a step on every rank;
    ``compressed_psum_pod`` over the four ranks, card == host bit for bit
    and within the reference's bound; ``pipeline_forward`` of 8 blocks in 4
    stages x 4 microbatches of 1 x 1024 against the blocks in sequence.
    Then (a) the five other trainable families of the one card
    (``SHARDED_FAMILIES_ONE_CARD``): mamba2-780m, zamba2-7b at 6 layers,
    whisper-base at 2 + 2 behind 1500 frames, gemma2-2b and stablelm-1.6b,
    each at full width in f32 (2 layers unless named), batch 4 x 512, on
    (data 2, model 2) under ``seqpar`` for two AdamW steps against one
    device's unsharded steps: both steps' gradients, the parameters after
    each step, every count == the plan's, each kernel's launches (flash,
    SSD) == the plan's calls, the peak beside the plan's.  On a host of four
    cards (c): the qwen2.5-3b step over NCCL, a card a rank, at full depth
    in bf16 on (2, 2) and (1, 4), the (2, 2) state (parameters and AdamW's)
    saved after step 2 and restored under (1, 4) bit for bit, its step 3
    against the (2, 2) run's: the exchanges and FLOPs against the
    dry-run's, the peak within
    ``PEAK_BAND`` of ``max_memory_allocated``, ms a step, NCCL's kernel
    time by collective, the loss against one card's bf16 step; and (d)
    (``SHARDED_FAMILIES_FOUR_CARDS``) the six families over NCCL on (2, 2)
    under ``seqpar``: in f32 at the one card's depths (internvl2-76b at 1
    layer behind 256 patches) held as (a), then at full depth in bf16 at 4
    x 1024 (internvl2-76b at ``FIT_LAYERS``, found on meta): ms a step,
    tokens/s a card, 6·N·tokens at 989 TFLOP/s, a profiled step's idle
    share and NCCL time, the peak beside the plan's, the loss against
    one card's where one card holds the model; alone: ``python3 -c "import
    chip_smoke; chip_smoke.four_card_main()"``, or (d) by itself
    ``chip_smoke.sharded_families_phase()`` after ``_build.build()``;
25. sharded serving on real exchanges (``launch/dryrun.py::build_cell(...,
    comm=)``: a prefill cell and a decode cell that carries its cache):
    four child processes share the card in a gloo group (staged through the
    host), each a device of (data 1, model 4) under ``serve-tp``;
    qwen2.5-3b (16 query heads over 2 kv heads: the cache's sequence split
    over the four, the decode kernel's state variant and the flash-decoding
    combine), mixtral-8x7b (its experts and kv heads split), deepseek-67b
    and internvl2-76b (its 256 patches from a seed, the same on every rank,
    through the sharded prefill), and the six remaining architectures:
    mamba2-780m (its Mamba2 blocks computed whole, their states stored
    split over the heads, every prefill layer through the SSD kernel),
    zamba2-7b at 6 layers (one shared invocation), whisper-base at 2
    encoder and 2 decoder layers behind 1500 frames from a seed (its cross
    cache written in place at the rank's heads), gemma2-2b (softcap,
    alternating windows), stablelm-1.6b and qwen3-moe-30b-a3b (the router
    in f32), each at full width cut to 2 layers in f32
    (TF32 off), the first four of phase 7's prompts cut to the shortest of
    them as one batch, prefilled into a cache of 512 (internvl2-76b's
    1024), then 8 greedy ticks: every step's logits within 1e-4 +
    1e-4·max|logit| of one device's unsharded run on the same weights (drawn
    a module at a time from the seed on each rank), the greedy tokens equal,
    each kernel's launches equal to the plan's kernel calls (the prefill's
    and the ticks': for a decoder transformer one flash a layer a prefill
    and one decode, the state variant where the sequence is split, a layer
    a tick), and every rank's
    argument bytes, FLOPs, kernel calls and exchanges by kind == the dry-run's
    prefill cell, and a tick at a full cache drawn from a seed == its decode
    cell, exactly.  On a host of four cards (b), alone in ``four_card_main``
    after phase 24 (c): the same over NCCL, a card a rank: mixtral-8x7b at 8
    layers in f32 against one card's run of the same 8 layers, then at all
    32 in bf16 (the weights, 93 GB, fit no card: each rank draws a module at
    a time and keeps its slices), qwen2.5-3b at all 36 in f32 against one
    card's run, over phase 7's 8 prompts and 32 ticks; each model's
    ``decode_32k`` cell in bf16 (batch 128, a cache of 32,768 positions from
    a seed): the counts == the plan's, the peak within ``PEAK_BAND`` of
    ``max_memory_allocated``.  Then (c), the two models that fit no card:
    deepseek-67b and internvl2-76b (behind 256 patches), each at 8 layers
    in f32 against one card's run of the same 8 layers (logits and tokens),
    at full depth in bf16 (95 and 80 layers, drawn a module at a time) over
    the same prompts and ticks, ms a tick; a full cache of 32,768 positions
    at the batch that fits (``FIT_BATCH``: the dry-run's peak at most 72 GB
    a card, found on meta and printed first) and one prompt of 32,768
    positions at full depth: every count == the plan's, each peak within
    ``PEAK_BAND``, the long prefill's seconds.  Then (d), the six remaining
    architectures (``SERVE_REMAINING_FOUR_CARDS``): each in f32 against one
    card's run (mamba2-780m, whisper-base, gemma2-2b and stablelm-1.6b
    whole, qwen3-moe-30b-a3b at 8 layers, zamba2-7b at 12), at full depth
    in bf16 (48, 81, 6 + 6, 26, 24 and 48 layers) with a full-cache tick,
    and a full 32k cache at ``FIT_BATCH`` (the largest batch up to 128
    whose plan fits 72 GB a card): every count == the plan's, the peaks
    within ``PEAK_BAND``, ms a tick.
26. the ``long_500k`` cell on four cards only (``four_card_main`` after
    25 (d), or alone: ``python3 -c "import chip_smoke;
    chip_smoke.long_context_phase()"``): a batch of one against a cache of
    524,288 positions under ``serve-tp`` on (data 1, model 4), every cache
    split by its kv heads, for mamba2-780m, zamba2-7b, gemma2-2b and
    mixtral-8x7b (``LONG_CONTEXT_FOUR_CARDS``).  First the decode kernel on
    card 0 at a card's share of the two long caches it reads (gemma2-2b's
    global layers, zamba2-7b's shared attention) at 524,288 and 523,288
    keys, held against its plain version and timed beside its bound and
    SDPA.  Then the four NCCL ranks: (i) in f32 (mamba2-780m at 48 layers,
    zamba2-7b at 6, gemma2-2b and mixtral-8x7b at 2; TF32 off, the router
    f32), a cache drawn from a seed at its last position and 4 greedy
    ticks, every rank's logits within 1e-4 + 1e-4·max|logit| of one card's
    ticks of the same model and cache, the greedy tokens equal, the decode
    launches equal to the plan's calls; (ii) at full depth in bf16 (48, 81,
    26 and 32 layers), one tick counted (every count == the plan's, the
    decode launches == the plan's calls, the peak within ``PEAK_BAND``,
    finite logits), then 3 uncounted at the same position, ms a tick beside
    the plan's bytes at 3.35 TB/s.  ``four_card_main`` ends with the
    kernels' launches on its paths (JSON).

The last lines are the kernels' record (JSON), the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  Needs one
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, f32
# operations/s outside the tensor cores and bf16 operations/s in them
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores
GA = {"pop_size": 64, "generations": 60}
#: phase 5's GA through the plain version, a yardstick of the path's wall:
#: 10 of GA's 60 generations since phase 24 (a) took the five other
#: trainable families (the run took 1056.1 s of phases on an H100 80GB HBM3
#: at 700 W before this cut; ``tools/cut_probe.py 5``)
GA_PLAIN = {"pop_size": 64, "generations": 10}
SWEEP_SEEDS = range(8)
SERVE = {"requests": 8, "slots": 4, "max_len": 2048, "new_tokens": 32}
# zamba2-7b's serving depth in phase 10: 81 layers took 118-139 s; with
# phase 22 the whole run took 1026.2 s (H100 at 700 W), past the 1000 s
# at which the ROADMAP cuts this path's depth first (phases 6 and 8 still
# hold its attention and SSD shapes against the plain versions); 12 since
# phase 25 served deepseek-67b and internvl2-76b on one card too (the cut
# rule, ``tools/cut_probe.py 10``: two shared invocations, 4 before); 6
# since phase 25 (a) served the six remaining architectures and 25 (d)
# serves zamba2-7b whole on four cards (one shared invocation)
ZAMBA_LAYERS = 6
# the cut rule before phase 25 (sharded serving) came: the whole run took
# 1183.3 s on a slow machine (H100 at 700 W), so phase 17 serves
# qwen3-moe-30b-a3b at 4 of its 48 layers and mixtral-8x7b at 2 of its 32
# (8 before; phase 6 still holds their attention shapes, phase 25 (b)
# serves mixtral whole on four cards), and the serving phases'
# card-against-CPU checks (phases 7, 9, 10) run the 128-token prompt alone,
# not the 1000-token one too; ``tools/cut_probe.py`` times each cut before
# and after; qwen3-moe-30b-a3b at 2 layers since phase 25 (d) serves it
# whole on four cards and 25 (a) at 2 layers on one
MOE_LAYERS = 2
# mamba2-780m's serving depth in phase 9: 12 of its 48 layers since phase 25
# (d) serves it whole on four cards and 25 (a) adds the six remaining
# architectures on one card (the cut rule; ``tools/cut_probe.py 9``; phase 8
# still holds its SSD shapes)
MAMBA_LAYERS = 12
# qwen2.5-3b's serving depth in phase 7: 12 of its 36 layers since phase 25
# (a) added the six remaining architectures (phase 25 (b) serves it whole
# on four cards; phase 6 holds its attention shapes; ``tools/cut_probe.py
# 7d``)
QWEN_LAYERS = 12
MIXTRAL_LAYERS = 2
CPU_CUT_PROMPTS = (128,)
KEYS = ("durations", "cores", "data", "feasible", "release", "pred_matrix", "dtr",
        "init_free", "node_cores")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (``torch.equal`` fails on NaN)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def cuda_ms(fn, reps: int, warmup: int = 2, rounds: int = 5) -> float:
    """Device milliseconds per ``fn()``: the median over ``rounds`` of
    ``reps`` calls enqueued back to back behind a spin kernel that keeps the
    device busy while the host enqueues them, timed with CUDA events and
    divided by ``reps``.  So the host's own time per call (Python, checks,
    launches) is not counted, unless ``fn`` waits for the device itself or
    takes so long on the host that the spin (at most a quarter second) ends
    first: then its host gaps count, as before."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0  # one call's enqueueing, at least
    torch.cuda.synchronize()
    spin_cycles = int(min(0.25, 2 * reps * host_s + 1e-3) * 2e9)  # SM clocks stay under 2 GHz
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def call_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of one ``fn()`` alone on an idle stream, by CUDA
    events around it: the device time plus whatever host time the device
    waits for (how every kernel was timed before ``cuda_ms``)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_assignments(problem, pop: int, seed: int) -> np.ndarray:
    """Candidates over each task's feasible nodes (node 0 where none is)."""
    rng = np.random.default_rng(seed)
    feas = problem.feasible
    A = np.zeros((pop, problem.num_tasks), np.int32)
    for j in range(problem.num_tasks):
        ok = np.flatnonzero(feas[j])
        A[:, j] = rng.choice(ok, pop) if ok.size else 0
    return A


def problem_kw(problem, dev) -> dict:
    """The makespan function's arrays of one problem on ``dev``, unpadded,
    without deadlines; fresh tensors, so a case may edit them."""
    from repro_torch.engine import pack

    arrays = pack(problem, pad=False).device_arrays(dev)
    kw = {k: arrays[k].clone() for k in KEYS}
    kw["deadline"] = None
    return kw


def makespan_work(A: torch.Tensor, kw: dict) -> tuple[int, int]:
    """(bytes, operations) that one makespan call on ``A [P, T]`` needs with
    this data, whatever the implementation.

    Bytes: the assignments, the per-task vectors (cores, data, release,
    deadline) and the predecessor lists read once, the two outputs written
    once, and of the tables only the entries this population reaches: the
    durations and feasibility of each distinct (task, node) pair, the rate
    of each distinct (pred node, node) pair that a cross-node edge uses, and
    the initial core-free row and core count of each node used.
    Operations: per candidate and task, a linear selection of the c-th
    smallest of CMAX free times and a CMAX-wide overwrite of the c smallest
    (2*CMAX), and four more (release max, start max, add the duration, the
    feasibility or deadline test); per candidate and edge, a divide, an add
    and a max across nodes, one max on the same node."""
    P, T = A.shape
    N, C = kw["init_free"].shape
    a = A.long()
    preds = kw["pred_matrix"].long()
    q_task, q_slot = torch.nonzero(preds >= 0, as_tuple=True)  # every edge p -> j
    p_node = a[:, preds[q_task, q_slot]]  # [P, E]
    j_node = a[:, q_task]
    cross = p_node != j_node
    n_cross, n_edges = int(cross.sum()), P * q_task.numel()
    pairs_tn = torch.unique(torch.arange(T, device=a.device) * N + a).numel()
    pairs_nn = torch.unique((p_node * N + j_node)[cross]).numel()
    nodes = torch.unique(a).numel()
    per_task = 3 + (kw["deadline"] is not None)
    nbytes = (
        A.numel() * 4 + 2 * P * 4 + per_task * T * 4 + preds.numel() * 4
        + pairs_tn * (4 + 1) + pairs_nn * 4 + nodes * (C * 4 + 4)
    )
    ops = P * T * (2 * C + 4) + 3 * n_cross + (n_edges - n_cross)
    return nbytes, ops


def makespan_bound_ms(A: torch.Tensor, kw: dict) -> tuple[float, str, int, int]:
    """Least time an H100 could take for the makespan of ``A [P, T]`` or of
    a family ``A [B, P, T]`` (see :func:`makespan_work`): its bytes at the
    HBM rate against its operations at the f32 rate, the larger."""
    if A.dim() == 2:
        A, kw = A[None], {k: None if v is None else v[None] for k, v in kw.items()}
    nbytes = ops = 0
    for b in range(A.shape[0]):
        nb, op = makespan_work(A[b], {k: None if v is None else v[b] for k, v in kw.items()})
        nbytes, ops = nbytes + nb, ops + op
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations", nbytes, ops


def ptxas_resources(log: str) -> list[dict]:
    """Each kernel instance in a build's ``-Xptxas -v`` report: its
    (demangled) name, registers, static shared memory, stack frame and
    spill bytes."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"kernel": m.group(1), "registers": None, "static_smem": 0})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[-1]["static_smem"] = int(m[1])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in out), check=True,
                               capture_output=True, text=True).stdout.splitlines()
        for r, name in zip(out, names):
            r["kernel"] = re.sub(r"^void |\(anonymous namespace\)::|\(.*\)$", "", name)
    except (FileNotFoundError, subprocess.CalledProcessError):
        pass  # mangled names
    return out


def sass_count(library: Path, opcode: str) -> int:
    """How many ``opcode`` instructions the library's SASS holds, by
    ``cuobjdump -sass`` from the toolkit of the build's nvcc."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    return sum(1 for line in sass.splitlines() if re.search(rf"\b{opcode}\b", line))


def device_time_breakdown(run, classify=None) -> dict:
    """Run ``run()`` under ``torch.profiler`` and split its wall time into
    the device's kernel time, by kernel name (and by ``classify(name)``
    where given), and the rest (host work and device idle).  Kernels of one
    stream run one at a time, so their durations add up to the device's
    busy time.  Only the device's kernels are recorded, not the host's
    operators: the busy time needs only the kernels, and recording every
    host operator slows the host enough to inflate the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    out = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if by_name else None,  # None: the profiler saw no kernel
        "device_idle_share": 1 - busy_ms / wall_ms if by_name else None,
        "kernels": [{"name": n[:80], "count": c, "ms": ms} for n, (c, ms) in top],
    }
    if classify is not None:
        classes: dict[str, list] = {}
        for name, (c, ms) in by_name.items():
            row = classes.setdefault(classify(name), [0, 0.0])
            row[0] += c
            row[1] += ms
        out["by_class"] = {k: {"count": c, "ms": ms} for k, (c, ms) in classes.items()}
    return out


def roofline_ms(flops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    """Least time of ``flops`` at the dtype's peak (bf16 tensor cores, or
    f32 outside them) and ``nbytes`` at the HBM rate, and which bounds."""
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def attention_work(q: torch.Tensor, k: torch.Tensor, pairs: int, kv_rows: int):
    """The attention kernels' one formula (``kernels/work.py``, read by the
    dry-run's counter too) for ``pairs`` visible (query head, key) pairs
    and the ``kv_rows`` rows of k and v they touch."""
    from repro_torch.launch import op_costs

    return op_costs.attention_work("attention", B=q.shape[0], H=q.shape[1], Hkv=k.shape[1], D=q.shape[-1],
                                   q_rows=q.shape[2] if q.dim() == 4 else 1, pairs=pairs, kv_rows=kv_rows,
                                   dtype=q.dtype)


def attention_bound_ms(q: torch.Tensor, k: torch.Tensor, pairs: int, kv_rows: int) -> tuple[float, str]:
    """Least time an H100 could take for an attention call (flash or decode):
    q read and the output written once, the ``kv_rows`` rows of k and v that
    some visible pair touches read once, against 4 * D operations per
    visible (query head, key) pair at the rate of the dtype (bf16 tensor
    cores, or f32 outside them): :func:`attention_work`."""
    w = attention_work(q, k, pairs, kv_rows)
    return roofline_ms(w.flops, w.bytes, q.dtype)


def attention_phase(prompt_lens: list[int]) -> dict:
    """Phase 6: each attention kernel against its plain version on the card
    at the serving paths' shapes (qwen2.5-3b's D 128, gemma2-2b's D 256,
    zamba2-7b's D 112) and at the reduced configs' D 16, timed beside the
    plain version and ``scaled_dot_product_attention``, and at the MoE
    serving paths' (qwen3-moe-30b-a3b's H 32, Hkv 4, D 128; mixtral-8x7b's H
    32, Hkv 8, D 128, window 4096); returns the kernels' records, with
    zamba2's times under ``zamba2_*`` keys and qwen3-moe's under
    ``qwen3moe_*``.

    Each output is held against the plain version run on the same inputs in
    f32, the kernel's own arithmetic, unrounded: within atol = rtol = 2e-5
    for f32 tensors, and for bf16 tensors within 2e-5 + 2**-8 * |y|, half a
    bf16 step at y plus the f32 summation-order slack, since a bf16 output
    is the f32 result rounded once to nearest."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_ref
    from repro_torch.kernels.flash_attention import (
        attention_mask,
        flash_attention_cuda,
        flash_attention_ref,
        kernel_takes_head_dim,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.bfloat16: (2e-5, 2**-8), torch.float32: (2e-5, 2e-5)}  # (atol, rtol)
    records: dict[str, dict] = {}
    zamba: dict[str, dict] = {}  # the zamba2 shapes' times, added to the records at the end
    moe: dict[str, dict] = {}  # the qwen3-moe shapes' times, likewise
    max_err = {"flash_attention": 0.0, "decode_attention": 0.0}

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(name, label, out, plain, plain32, dtype):
        """Max abs diff of the kernel's output from the plain version in its
        dtype (recorded) and in f32 (held to ``tol``)."""
        torch.cuda.synchronize()
        err = float((out.float() - plain.float()).abs().max())
        err32 = float((out.float() - plain32).abs().max())
        atol, rtol = tol[dtype]
        check(bool(torch.isfinite(out.float()).all()), f"{label}: finite output")
        check(torch.allclose(out.float(), plain32, atol=atol, rtol=rtol),
              f"{label}: kernel == plain in f32 within atol {atol} rtol {rtol} (max abs diff {err32})")
        max_err[name] = max(max_err[name], err)
        return err, err32

    # (label, B, H, Hkv, Sq, Skv, D, options); qwen2.5-3b: H 16, Hkv 2, D 128
    flash_cases = [(f"qwen prefill S={n}", 1, 16, 2, n, n, 128, {}) for n in prompt_lens]
    flash_cases += [
        ("qwen chunked prefill Sq=256 Skv=1280", 1, 16, 2, 256, 1280, 128, {}),
        ("gemma2 S=5000 window 4096 softcap 50", 1, 8, 4, 5000, 5000, 256,
         {"window": 4096, "softcap": 50.0}),
    ]
    # at the engine's prompt lengths, only the longest timed: zamba2-7b's
    # shared attention (H 32, Hkv 32, D 112), qwen3-moe-30b-a3b's (H 32, Hkv
    # 4, D 128) and mixtral-8x7b's (H 32, Hkv 8, D 128, window 4096)
    longest_flash = [(f"zamba2 prefill S={n}", 1, 32, 32, n, n, 112, {}) for n in prompt_lens]
    longest_flash += [(f"qwen3-moe prefill S={n}", 1, 32, 4, n, n, 128, {}) for n in prompt_lens]
    longest_flash += [(f"mixtral prefill S={n}", 1, 32, 8, n, n, 128, {"window": 4096}) for n in prompt_lens]
    main_flash = f"qwen prefill S={max(prompt_lens)}"
    zamba_main_flash = f"zamba2 prefill S={max(prompt_lens)}"
    moe_main_flash = f"qwen3-moe prefill S={max(prompt_lens)}"
    untimed_flash = {case[0] for case in longest_flash} - {
        f"{arch} prefill S={max(prompt_lens)}" for arch in ("zamba2", "qwen3-moe", "mixtral")}
    flash_lib, decode_lib = flash_mod._library(), decode_mod._library()
    check(all(bool(flash_lib.flash_attention_supports(D)) == kernel_takes_head_dim(D) for D in range(300)),
          "the flash library and the wrappers take the same head widths")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    print("dynamic shared memory per block: " + ", ".join(
        [f"flash {t} D={D} {flash_lib.flash_attention_smem(D, int(t == 'bf16'))} B"
         for t in ("bf16", "f32") for D in (16, 64, 112, 128, 256)]
        + [f"decode {t} G={G} D={D} {decode_lib.decode_attention_smem(G, D, int(t == 'bf16'))} B"
           for t in ("bf16", "f32") for G, D in ((8, 128), (2, 256), (1, 112), (4, 16))]), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, Sq, Skv, D, kw in flash_cases + longest_flash:
            q, k, v = normal((B, H, Sq, D), dtype), normal((B, Hkv, Skv, D), dtype), normal((B, Hkv, Skv, D), dtype)
            err, err32 = compare("flash_attention", label, flash_attention_cuda(q, k, v, **kw),
                                 flash_attention_ref(q, k, v, **kw),
                                 flash_attention_ref(q.float(), k.float(), v.float(), **kw), dtype)
            if label in untimed_flash:
                print(f"flash {label} {str(dtype)[6:]}: max abs diff {err:.3g} (from f32 plain {err32:.3g})",
                      flush=True)
                continue
            ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=20)
            one_call_ms = call_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=20)
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=3, warmup=1)
            mask = attention_mask(Sq, Skv, causal=True, window=kw.get("window"), device=dev)
            library_ms = None
            if "softcap" not in kw:
                if Sq == Skv and "window" not in kw:
                    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
                else:
                    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)  # noqa: E731
                library_ms = cuda_ms(lib, reps=20)
            pairs = B * H * int(mask.sum())
            kv_rows = B * Hkv * int(mask.any(dim=0).sum())
            bound_ms, bound_by = attention_bound_ms(q, k, pairs, kv_rows)
            print(f"flash {label} {str(dtype)[6:]}: max abs diff {err:.3g} (from f32 plain "
                  f"{err32:.3g}); kernel {ms:.4f} ms (one call with its host work {one_call_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms if library_ms is None else round(library_ms, 4)} ms, "
                  f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)
            if label == main_flash and dtype == torch.bfloat16:
                records["flash_attention"] = {"ms": ms, "call_ms": one_call_ms, "plain_ms": plain_ms,
                                              "bound_ms": bound_ms, "bound_by": bound_by,
                                              "library_ms": library_ms}
            if label == moe_main_flash and dtype == torch.bfloat16:
                moe["flash_attention"] = {"qwen3moe_ms": ms, "qwen3moe_plain_ms": plain_ms,
                                          "qwen3moe_bound_ms": bound_ms, "qwen3moe_bound_by": bound_by,
                                          "qwen3moe_library_ms": library_ms}
            if label == zamba_main_flash and dtype == torch.bfloat16:
                zamba["flash_attention"] = {"zamba2_ms": ms, "zamba2_plain_ms": plain_ms,
                                            "zamba2_bound_ms": bound_ms, "zamba2_bound_by": bound_by,
                                            "zamba2_library_ms": library_ms}

    # the masks' and shapes' edges, held as above and not timed
    flash_edges = [
        ("ragged S=37 D=64 B=2", 2, 4, 2, 37, 37, 64, {}),
        ("not causal S=77", 1, 4, 2, 77, 77, 64, {"causal": False}),
        ("rows that see nothing Sq=100 Skv=40", 1, 4, 2, 100, 40, 128, {}),
        ("window 16 softcap 30 S=300 D=256", 1, 4, 2, 300, 300, 256, {"window": 16, "softcap": 30.0}),
        ("one row Sq=1 Skv=1000", 1, 16, 2, 1, 1000, 128, {}),
        ("head width 16 (the reduced configs) S=200 B=2", 2, 4, 4, 200, 200, 16, {}),
        ("head width 16 window 40 softcap 30 Sq=90 Skv=300", 1, 4, 2, 90, 300, 16,
         {"window": 40, "softcap": 30.0}),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, Sq, Skv, D, kw in flash_edges:
            q, k, v = normal((B, H, Sq, D), dtype), normal((B, Hkv, Skv, D), dtype), normal((B, Hkv, Skv, D), dtype)
            err, err32 = compare("flash_attention", label, flash_attention_cuda(q, k, v, **kw),
                                 flash_attention_ref(q, k, v, **kw),
                                 flash_attention_ref(q.float(), k.float(), v.float(), **kw), dtype)
            print(f"flash {label} {str(dtype)[6:]}: max abs diff {err:.3g} (from f32 plain {err32:.3g})", flush=True)

    # (label, B, H, Hkv, S, D, lengths, softcap); the engine decodes its slots
    # in lockstep, so the serving run's first tick has every length at the
    # longest prompt + 1
    lockstep = max(prompt_lens) + 1
    main_decode = "qwen decode 4 slots lockstep, cache 2048"
    zamba_main_decode = "zamba2 decode 4 slots lockstep, cache 2048"
    moe_main_decode = "qwen3-moe decode 4 slots lockstep, cache 2048"
    decode_cases = [
        (main_decode, 4, 16, 2, 2048, 128, [lockstep] * 4, None),
        ("qwen decode 4 slots mixed, cache 2048", 4, 16, 2, 2048, 128, [1, 517, 1024, 2048], None),
        ("qwen decode 1 slot, 2048 keys", 1, 16, 2, 2048, 128, [2048], None),
        ("gemma2 decode, cache 4096, softcap 50", 4, 8, 4, 4096, 256, [4096, 1, 2000, 3000], 50.0),
        (zamba_main_decode, 4, 32, 32, 2048, 112, [lockstep] * 4, None),
        (moe_main_decode, 4, 32, 4, 2048, 128, [lockstep] * 4, None),
        # mixtral's window of 4096 spans the whole 2048-position cache, so
        # its decode reads every cached key
        ("mixtral decode 4 slots lockstep, cache 2048", 4, 32, 8, 2048, 128, [lockstep] * 4, None),
        ("zamba2 decode 4 slots mixed, cache 2048", 4, 32, 32, 2048, 112, [1, 517, 1024, 2048], None),
        ("zamba2 decode 1 slot, 2048 keys", 1, 32, 32, 2048, 112, [2048], None),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, S, D, lens, softcap in decode_cases:
            q, k, v = normal((B, H, D), dtype), normal((B, Hkv, S, D), dtype), normal((B, Hkv, S, D), dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            err, err32 = compare("decode_attention", label, decode_attention_cuda(q, k, v, lengths, softcap=softcap),
                                 decode_attention_ref(q, k, v, lengths, softcap=softcap),
                                 decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=softcap),
                                 dtype)
            ms = cuda_ms(lambda: decode_attention_cuda(q, k, v, lengths, softcap=softcap), reps=50)
            one_call_ms = call_ms(lambda: decode_attention_cuda(q, k, v, lengths, softcap=softcap), reps=50)
            plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, lengths, softcap=softcap), reps=10)
            library_ms = None
            if softcap is None:
                valid = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=valid, enable_gqa=True), reps=50)
            bound_ms, bound_by = attention_bound_ms(q, k, H * sum(lens), Hkv * sum(lens))
            splits, chunk = decode_mod.decode_split_plan(Hkv, S, sm_count)
            print(f"decode {label} lengths {lens} (splits {splits} of {chunk} keys) {str(dtype)[6:]}: "
                  f"max abs diff {err:.3g} (from f32 plain "
                  f"{err32:.3g}); kernel {ms:.4f} ms (one call with its host work {one_call_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms if library_ms is None else round(library_ms, 4)} ms, "
                  f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)
            if label == main_decode and dtype == torch.bfloat16:
                records["decode_attention"] = {"ms": ms, "call_ms": one_call_ms, "plain_ms": plain_ms,
                                               "bound_ms": bound_ms, "bound_by": bound_by,
                                               "library_ms": library_ms}
            if label == moe_main_decode and dtype == torch.bfloat16:
                moe["decode_attention"] = {"qwen3moe_ms": ms, "qwen3moe_plain_ms": plain_ms,
                                           "qwen3moe_bound_ms": bound_ms, "qwen3moe_bound_by": bound_by,
                                           "qwen3moe_library_ms": library_ms}
            if label == zamba_main_decode and dtype == torch.bfloat16:
                zamba["decode_attention"] = {"zamba2_ms": ms, "zamba2_plain_ms": plain_ms,
                                             "zamba2_bound_ms": bound_ms, "zamba2_bound_by": bound_by,
                                             "zamba2_library_ms": library_ms}
    # the state variant (o, lse [B, H] f32) at the sharded serving shapes of
    # qwen2.5-3b on (1, 4), every query head against a device's share of the
    # keys: phase 25's 4 slots against a share of 128 of 512 positions (a
    # share past a row's keys is empty), decode_32k's 128 against 8192 of
    # 32,768; ``lse`` held to the plain version's in f32 within 1e-5 of
    # max(1, |lse|)
    from repro_torch.kernels import work as work_mod
    from repro_torch.kernels.decode_attention import decode_attention_state_cuda, decode_attention_state_ref

    state_main = "qwen decode_32k on (1, 4): 128 slots against a share of 8192 of 32768 keys"
    state_cases = [
        ("qwen on (1, 4): 4 slots against a share of 128 of 512 keys", 4, 16, 2, 128, 128, [121, 0, 128, 100]),
        (state_main, 128, 16, 2, 8192, 128, [8192] * 128),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, S, D, lens in state_cases:
            q, k, v = normal((B, H, D), dtype), normal((B, Hkv, S, D), dtype), normal((B, Hkv, S, D), dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            o, lse = decode_attention_state_cuda(q, k, v, lengths)
            o_p, lse_p = decode_attention_state_ref(q, k, v, lengths)
            o32, lse32 = decode_attention_state_ref(q.float(), k.float(), v.float(), lengths)
            err, err32 = compare("decode_attention", f"state variant {label}", o, o_p, o32, dtype)
            check(torch.equal(o, decode_attention_cuda(q, k, v, lengths)), f"{label}: the state variant's output "
                                                                           f"== decode_attention_cuda's, bit for bit")
            lse_err = float(((lse - lse32).abs() / lse32.abs().clamp(min=1.0)).max())
            check(lse_err <= 1e-5, f"state variant {label}: lse within 1e-5 of max(1, |lse|) ({lse_err})")
            check(bool((lse[lengths == 0] == -1e30).all()), f"state variant {label}: -1e30 for rows with no key")
            ms = cuda_ms(lambda: decode_attention_state_cuda(q, k, v, lengths), reps=50)
            plain_ms = cuda_ms(lambda: decode_attention_state_ref(q, k, v, lengths), reps=10)
            # the library's one call for (o, lse): the memory-efficient SDPA
            # kernel with its log-sum-exp, the lengths as an additive bias and
            # the kv heads expanded beforehand (it takes no GQA); its output
            # and lse against the f32 plain version's on the rows with keys
            ke, ve = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
            valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]
            bias = torch.zeros(B, H, 1, S, dtype=dtype, device=dev).masked_fill_(~valid[:, None, None, :],
                                                                                 float("-inf"))

            def efficient():
                return torch.ops.aten._scaled_dot_product_efficient_attention(q[:, :, None], ke, ve, bias, True)[:2]

            o_l, lse_l = efficient()
            live = lengths > 0
            lib_err = max(float((o_l[:, :, 0].float() - o32)[live].abs().max()),
                          float((lse_l[:, :, 0] - lse32)[live].abs().max()))
            library_ms = cuda_ms(efficient, reps=50)
            del ke, ve, bias, o_l, lse_l
            w = work_mod.decode_attention_work(q, k, lengths, state=True)
            bound_ms, bound_by = roofline_ms(w.flops, w.bytes, dtype)
            print(f"decode state variant {label} lengths {sorted(set(lens))} {str(dtype)[6:]}: max abs diff {err:.3g} "
                  f"(from f32 plain {err32:.3g}), lse max rel err {lse_err:.3g}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, efficient sdpa with lse {library_ms:.4f} ms (its o and lse within "
                  f"{lib_err:.3g} of the f32 plain's), bound {bound_ms:.6f} ms ({bound_by})", flush=True)
            if label == state_main and dtype == torch.bfloat16:
                records["decode_attention"].update(state_ms=ms, state_plain_ms=plain_ms, state_bound_ms=bound_ms,
                                                   state_bound_by=bound_by, state_lse_max_rel_err=lse_err,
                                                   state_library_ms=library_ms, state_library_max_abs_err=lib_err)
    decode_edges = [
        ("lengths 0 to S, softcap 30, D=64", 6, 16, 4, 2048, 64, [0, 1, 63, 64, 65, 2000], 30.0),
        ("cache of 100, D=256", 3, 8, 4, 100, 256, [100, 37, 0], None),
        ("head width 16 (the reduced configs), cache 128", 4, 4, 4, 128, 16, [0, 5, 64, 128], None),
        ("head width 16, GQA 4, softcap 30, cache 2048", 2, 8, 2, 2048, 16, [2048, 700], 30.0),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, S, D, lens, softcap in decode_edges:
            q, k, v = normal((B, H, D), dtype), normal((B, Hkv, S, D), dtype), normal((B, Hkv, S, D), dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            err, err32 = compare("decode_attention", label, decode_attention_cuda(q, k, v, lengths, softcap=softcap),
                                 decode_attention_ref(q, k, v, lengths, softcap=softcap),
                                 decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=softcap),
                                 dtype)
            print(f"decode {label} lengths {lens} {str(dtype)[6:]}: max abs diff {err:.3g} "
                  f"(from f32 plain {err32:.3g})", flush=True)
    # the encdec and vlm families' shapes (whisper-base: H 8, D 64, 1500
    # frames, its encoder and cross-attention not causal, its decode
    # cross-attention at G = 1 over every frame; internvl2-76b: H 64, Hkv 8,
    # D 128 behind 256 patches), an explicit scale and deepseek-67b's reduced
    # head width 8: each held in bf16 and f32 as above, timed in bf16 beside
    # its plain version, its bound and SDPA
    vlm_len = 256 + max(prompt_lens)
    more_flash = [
        ("whisper encoder S=1500 not causal B=4", 4, 8, 8, 1500, 1500, 64, {"causal": False}),
        ("whisper cross Sq=8 Skv=1500 B=4", 4, 8, 8, 8, 1500, 64, {"causal": False}),
        ("whisper cross Sq=64 Skv=1500 B=4", 4, 8, 8, 64, 1500, 64, {"causal": False}),
        (f"internvl2 prefill S={vlm_len}", 1, 64, 8, vlm_len, vlm_len, 128, {}),
        (f"qwen prefill S={max(prompt_lens)} scale 0.1", 1, 16, 2, max(prompt_lens), max(prompt_lens), 128,
         {"scale": 0.1}),
        ("deepseek reduced D=8 S=200 B=2", 2, 8, 2, 200, 200, 8, {}),
    ]
    more_decode = [
        ("whisper cross 4 x 1500 keys, G 1", 4, 8, 8, 1500, 64, [1500] * 4, {}),
        (f"internvl2 decode 4 x {vlm_len + 32} keys, cache 2048", 4, 64, 8, 2048, 128, [vlm_len + 32] * 4, {}),
        ("qwen decode 4 slots lockstep, cache 2048, scale 0.1", 4, 16, 2, 2048, 128, [lockstep] * 4,
         {"scale": 0.1}),
        ("deepseek reduced D=8, cache 128", 4, 8, 2, 128, 8, [0, 5, 64, 128], {}),
    ]
    more = {"flash_attention": {}, "decode_attention": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, Sq, Skv, D, kw in more_flash:
            q, k, v = normal((B, H, Sq, D), dtype), normal((B, Hkv, Skv, D), dtype), normal((B, Hkv, Skv, D), dtype)
            err, err32 = compare("flash_attention", label, flash_attention_cuda(q, k, v, **kw),
                                 flash_attention_ref(q, k, v, **kw),
                                 flash_attention_ref(q.float(), k.float(), v.float(), **kw), dtype)
            line = f"flash {label} {str(dtype)[6:]}: max abs diff {err:.3g} (from f32 plain {err32:.3g})"
            if dtype == torch.bfloat16:
                causal = kw.get("causal", True)
                mask = attention_mask(Sq, Skv, causal=causal, window=None, device=dev)
                sdpa = {"enable_gqa": True, "scale": kw.get("scale")}
                if causal and Sq == Skv:
                    sdpa["is_causal"] = True
                elif causal:
                    sdpa["attn_mask"] = mask
                row = {
                    "ms": cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=20),
                    "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=3, warmup=1),
                    "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa), reps=20),
                }
                row["bound_ms"], row["bound_by"] = attention_bound_ms(
                    q, k, B * H * int(mask.sum()), B * Hkv * int(mask.any(dim=0).sum()))
                more["flash_attention"][label] = row
                line += (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                         f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
            print(line, flush=True)
        for label, B, H, Hkv, S, D, lens, kw in more_decode:
            q, k, v = normal((B, H, D), dtype), normal((B, Hkv, S, D), dtype), normal((B, Hkv, S, D), dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            err, err32 = compare("decode_attention", label, decode_attention_cuda(q, k, v, lengths, **kw),
                                 decode_attention_ref(q, k, v, lengths, **kw),
                                 decode_attention_ref(q.float(), k.float(), v.float(), lengths, **kw), dtype)
            line = f"decode {label} lengths {lens} {str(dtype)[6:]}: max abs diff {err:.3g} (from f32 plain {err32:.3g})"
            if dtype == torch.bfloat16:
                valid = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
                row = {
                    "ms": cuda_ms(lambda: decode_attention_cuda(q, k, v, lengths, **kw), reps=50),
                    "plain_ms": cuda_ms(lambda: decode_attention_ref(q, k, v, lengths, **kw), reps=10),
                    "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                        q[:, :, None], k, v, attn_mask=valid, enable_gqa=True, scale=kw.get("scale")), reps=50),
                }
                row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, H * sum(lens), Hkv * sum(lens))
                more["decode_attention"][label] = row
                line += (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
                         f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
            print(line, flush=True)

    # deepseek-67b's and internvl2-76b's heads on a card of (data 1, model
    # 4) (phase 25 (c): 16 query heads over 2 kv heads of 128), in bf16: a
    # causal prompt of LONG positions, held against the plain version on its
    # last 256 query rows against every key (a slice of the same function:
    # the whole score matrix, [16, LONG, LONG] in f32, is 68.7 GB), its plain
    # time that slice's; and deepseek-67b's tick at FIT_BATCH against LONG
    # keys; each beside its bound and SDPA (no math backend: it would
    # materialise the scores)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]

    def library(fn):
        try:
            with sdpa_kernel(fused):
                return cuda_ms(fn, reps=5)
        except RuntimeError as e:  # no fused backend takes the shape
            print(f"sdpa: no fused backend ({str(e).splitlines()[0]})", flush=True)
            return None

    t_long = time.perf_counter()
    bf16, rows = torch.bfloat16, 256
    label = f"long prefill S={LONG} (H 16, Hkv 2 a card)"
    q, k, v = normal((1, 16, LONG, 128), bf16), normal((1, 2, LONG, 128), bf16), normal((1, 2, LONG, 128), bf16)
    tail = q[:, :, -rows:]
    err, err32 = compare("flash_attention", label, flash_attention_cuda(q, k, v)[:, :, -rows:],
                         flash_attention_ref(tail, k, v), flash_attention_ref(tail.float(), k.float(), v.float()), bf16)
    row = {"ms": cuda_ms(lambda: flash_attention_cuda(q, k, v), reps=5), "plain_ms": None, "plain_rows": rows,
           "plain_rows_ms": cuda_ms(lambda: flash_attention_ref(tail, k, v), reps=3, warmup=1),
           "library_ms": library(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))}
    row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, 16 * LONG * (LONG + 1) // 2, 2 * LONG)
    more["flash_attention"][label] = row
    print(f"flash {label} bfloat16: the last {rows} rows' max abs diff {err:.3g} (from f32 plain {err32:.3g}); kernel "
          f"{row['ms']:.4f} ms, plain on the last {rows} rows {row['plain_rows_ms']:.4f} ms, sdpa "
          f"{row['library_ms']} ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    del q, k, v, tail
    B = FIT_BATCH["deepseek-67b"]
    label = f"deepseek-67b decode {B} x {LONG} keys (H 16, Hkv 2 a card)"
    q, k, v = normal((B, 16, 128), bf16), normal((B, 2, LONG, 128), bf16), normal((B, 2, LONG, 128), bf16)
    lengths = torch.full((B,), LONG, dtype=torch.int32, device=dev)
    err, err32 = compare("decode_attention", label, decode_attention_cuda(q, k, v, lengths),
                         decode_attention_ref(q, k, v, lengths),
                         decode_attention_ref(q.float(), k.float(), v.float(), lengths), bf16)
    valid = (torch.arange(LONG, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    row = {"ms": cuda_ms(lambda: decode_attention_cuda(q, k, v, lengths), reps=20),
           "plain_ms": cuda_ms(lambda: decode_attention_ref(q, k, v, lengths), reps=5),
           "library_ms": library(lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=valid,
                                                                        enable_gqa=True))}
    row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, 16 * B * LONG, 2 * B * LONG)
    more["decode_attention"][label] = row
    print(f"decode {label} bfloat16: max abs diff {err:.3g} (from f32 plain {err32:.3g}); kernel {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']})", flush=True)
    del q, k, v, valid
    print(f"phase 25 (c)'s attention shapes: {time.perf_counter() - t_long:.1f} s", flush=True)

    # gemma2-2b's heads on a card of (data 1, model 4) (phase 25 (d): 2 query
    # heads over 1 kv head of 256, softcap 50) at its FIT_BATCH, in bf16:
    # a local layer's ring buffer of ``window`` keys and a global layer's
    # LONG, through the decode kernel and its state variant (the output bit
    # for bit the plain decode's, lse held as above); no PyTorch call takes
    # a softcap, so no library time
    from repro_torch.models.registry import get_model

    t_gemma = time.perf_counter()
    gemma = get_model("gemma2-2b").config
    B, softcap = FIT_BATCH["gemma2-2b"], gemma.attn_softcap
    for S in (gemma.window, LONG):
        label = f"gemma2-2b decode {B} x {S} keys (H 2, Hkv 1, D 256, softcap {softcap:g} a card)"
        q, k, v = normal((B, 2, 256), bf16), normal((B, 1, S, 256), bf16), normal((B, 1, S, 256), bf16)
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        o = decode_attention_cuda(q, k, v, lengths, softcap=softcap)
        err, err32 = compare("decode_attention", label, o, decode_attention_ref(q, k, v, lengths, softcap=softcap),
                             decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=softcap), bf16)
        o_s, lse = decode_attention_state_cuda(q, k, v, lengths, softcap=softcap)
        lse32 = decode_attention_state_ref(q.float(), k.float(), v.float(), lengths, softcap=softcap)[1]
        check(torch.equal(o_s, o), f"{label}: the state variant's output == decode_attention_cuda's, bit for bit")
        lse_err = float(((lse - lse32).abs() / lse32.abs().clamp(min=1.0)).max())
        check(lse_err <= 1e-5, f"state variant {label}: lse within 1e-5 of max(1, |lse|) ({lse_err})")
        row = {"ms": cuda_ms(lambda: decode_attention_cuda(q, k, v, lengths, softcap=softcap), reps=20),
               "plain_ms": cuda_ms(lambda: decode_attention_ref(q, k, v, lengths, softcap=softcap), reps=5),
               "state_ms": cuda_ms(lambda: decode_attention_state_cuda(q, k, v, lengths, softcap=softcap), reps=20),
               "state_plain_ms": cuda_ms(lambda: decode_attention_state_ref(q, k, v, lengths, softcap=softcap),
                                         reps=5),
               "library_ms": None, "state_lse_max_rel_err": lse_err}
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, 2 * B * S, B * S)
        w = work_mod.decode_attention_work(q, k, lengths, state=True)
        row["state_bound_ms"], row["state_bound_by"] = roofline_ms(w.flops, w.bytes, bf16)
        more["decode_attention"][label] = row
        print(f"decode {label} bfloat16: max abs diff {err:.3g} (from f32 plain {err32:.3g}), state variant lse max "
              f"rel err {lse_err:.3g}; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}); state variant {row['state_ms']:.4f} ms, plain "
              f"{row['state_plain_ms']:.4f} ms, bound {row['state_bound_ms']:.6f} ms ({row['state_bound_by']}); "
              f"library: none (no PyTorch call takes a softcap)", flush=True)
        del q, k, v, o, o_s, lse, lse32

    # the card shares of phase 25 (d)'s families on (data 1, model 4), in
    # bf16, at its prompts (8 of 142 tokens; whisper-base's encoder over
    # 1500 frames) and its ticks (8 slots, 174 of a cache of 256 keys;
    # whisper-base's cross-attention over 1500 frames), each held against
    # its plain version and timed beside its bound and SDPA (none where a
    # softcap applies)
    share_flash = [  # (label, B, H, Hkv, Sq, Skv, D, options)
        ("gemma2-2b share S=142 (H 2, Hkv 1, D 256, softcap 50)", 8, 2, 1, 142, 142, 256,
         {"window": gemma.window, "softcap": softcap}),
        ("stablelm-1.6b share S=142 (H 8, Hkv 8, D 64)", 8, 8, 8, 142, 142, 64, {}),
        ("qwen3-moe share S=142 (H 8, Hkv 1, D 128)", 8, 8, 1, 142, 142, 128, {}),
        ("zamba2-7b share S=142 (H 8, Hkv 8, D 112)", 8, 8, 8, 142, 142, 112, {}),
        ("whisper-base share encoder S=1500 not causal (H 2, D 64)", 8, 2, 2, 1500, 1500, 64, {"causal": False}),
        ("whisper-base share decoder S=142 (H 2, D 64)", 8, 2, 2, 142, 142, 64, {}),
        ("whisper-base share cross Sq=142 Skv=1500 (H 2, D 64)", 8, 2, 2, 142, 1500, 64, {"causal": False}),
    ]
    for label, B, H, Hkv, Sq, Skv, D, kw in share_flash:
        q, k, v = normal((B, H, Sq, D), bf16), normal((B, Hkv, Skv, D), bf16), normal((B, Hkv, Skv, D), bf16)
        err, err32 = compare("flash_attention", label, flash_attention_cuda(q, k, v, **kw),
                             flash_attention_ref(q, k, v, **kw),
                             flash_attention_ref(q.float(), k.float(), v.float(), **kw), bf16)
        causal = kw.get("causal", True)
        pairs, keys = work_mod.attention_visible(Sq, Skv, causal=causal, window=kw.get("window"))
        row = {"ms": cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=20),
               "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=5),
               "library_ms": None if "softcap" in kw else library(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, enable_gqa=True))}
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, B * H * pairs, B * Hkv * keys)
        more["flash_attention"][label] = row
        print(f"flash {label} bfloat16: max abs diff {err:.3g} (from f32 plain {err32:.3g}); kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']} ms, bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})", flush=True)
    share_decode = [  # (label, B, H, Hkv, S, D, keys a row, softcap)
        ("gemma2-2b share tick, 174 of 256 keys (H 2, Hkv 1, D 256, softcap 50)", 8, 2, 1, 256, 256, 174, softcap),
        ("stablelm-1.6b share tick, 174 of 256 keys (H 8, Hkv 8, D 64)", 8, 8, 8, 256, 64, 174, None),
        ("qwen3-moe share tick, 174 of 256 keys (H 8, Hkv 1, D 128)", 8, 8, 1, 256, 128, 174, None),
        ("zamba2-7b share tick, 174 of 256 keys (H 8, Hkv 8, D 112)", 8, 8, 8, 256, 112, 174, None),
        ("whisper-base share self tick, 174 of 256 keys (H 2, D 64)", 8, 2, 2, 256, 64, 174, None),
        ("whisper-base share cross tick, 1500 frames (H 2, D 64)", 8, 2, 2, 1500, 64, 1500, None),
    ]
    for label, B, H, Hkv, S, D, n, cap in share_decode:
        q, k, v = normal((B, H, D), bf16), normal((B, Hkv, S, D), bf16), normal((B, Hkv, S, D), bf16)
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
        err, err32 = compare("decode_attention", label, decode_attention_cuda(q, k, v, lengths, softcap=cap),
                             decode_attention_ref(q, k, v, lengths, softcap=cap),
                             decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=cap), bf16)
        valid = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        row = {"ms": cuda_ms(lambda: decode_attention_cuda(q, k, v, lengths, softcap=cap), reps=20),
               "plain_ms": cuda_ms(lambda: decode_attention_ref(q, k, v, lengths, softcap=cap), reps=5),
               "library_ms": None if cap else library(lambda: F.scaled_dot_product_attention(
                   q[:, :, None], k, v, attn_mask=valid, enable_gqa=True))}
        row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, H * B * n, Hkv * B * n)
        more["decode_attention"][label] = row
        print(f"decode {label} bfloat16: max abs diff {err:.3g} (from f32 plain {err32:.3g}); kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']} ms, bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']})", flush=True)
    del q, k, v
    print(f"phase 25 (d)'s attention shapes: {time.perf_counter() - t_gemma:.1f} s", flush=True)

    # every head width the kernels take, at small shapes, held as above and
    # not timed
    for D in range(8, 257, 8):
        for dtype in (torch.bfloat16, torch.float32):
            kw = {"window": 50, "softcap": 30.0}
            q, k, v = normal((2, 4, 77, D), dtype), normal((2, 2, 130, D), dtype), normal((2, 2, 130, D), dtype)
            compare("flash_attention", f"flash D={D}", flash_attention_cuda(q, k, v, **kw),
                    flash_attention_ref(q, k, v, **kw), flash_attention_ref(q.float(), k.float(), v.float(), **kw),
                    dtype)
            q, k, v = normal((3, 8, D), dtype), normal((3, 2, 300, D), dtype), normal((3, 2, 300, D), dtype)
            lengths = torch.tensor([0, 150, 300], dtype=torch.int32, device=dev)
            compare("decode_attention", f"decode D={D}", decode_attention_cuda(q, k, v, lengths, softcap=30.0),
                    decode_attention_ref(q, k, v, lengths, softcap=30.0),
                    decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=30.0), dtype)
    print("flash and decode == plain at every head width 8-256 (step 8), bf16 and f32, GQA 2, "
          "window 50 and softcap 30 (flash), lengths 0/150/300 and softcap 30 (decode)", flush=True)
    for name in records:
        records[name].update(zamba[name], **moe[name], more_shapes=more[name], max_abs_err=max_err[name])
    return records


def serve_prompts(vocab: int) -> list[np.ndarray]:
    """The serving run's prompts: lengths drawn from 128-1024, then tokens,
    from numpy seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, SERVE["requests"])
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def kernel_class(name: str) -> str:
    """The serving path's kernels by kind, for the profile."""
    low = name.lower()
    if "flash_attention_kernel" in name:
        return "flash_attention (ours)"
    if "decode_attention_kernel" in name:
        return "decode_attention (ours)"
    if "ssd_scan_kernel" in name or "ssd_chunk_" in name or "ssd_state_pass" in name:
        return "ssd_scan (ours)"
    if any(t in low for t in ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if any(t in low for t in ("sort", "radix", "searchsorted", "index", "scatter", "gather")):
        return "sort, search, scatter and gather (PyTorch)"
    return "other PyTorch kernels"


class Served(NamedTuple):
    """What :func:`serve_phase` measured: each kernel's launches in the
    serving run, the run's readings, and the served model's parameters."""

    launches: dict[str, int]
    readings: dict
    params: torch.nn.Module


def serve_phase(arch: str, kernels: dict, cut: dict | None, *, layers: int | None = None,
                cut_prompts: tuple[int, ...] = CPU_CUT_PROMPTS, cut_ticks: int = 4,
                profile_tokens: int | None = None) -> Served:
    """Phases 7, 9, 10 and 17: ``arch`` at full width served by the engine
    on the card.  ``kernels`` maps each kernel of the path to its wrapper,
    what launches it (every ``"prefill"`` or every decode ``"tick"``) and
    how many times each of those does.  ``layers`` cuts the depth of the
    served model.  ``cut`` replaces config fields for the card-against-CPU
    check, run on ``cut_prompts`` for the prefill and ``cut_ticks`` decode
    steps; ``None`` leaves the check out.  The profile covers one wave of 4
    requests, each to ``profile_tokens`` new tokens (default: the run's
    32)."""
    import dataclasses

    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.serve.kvcache import merge_slot

    api = get_model(arch)
    cfg = api.config
    if layers is not None:
        print(f"serve: {arch} cut to {layers} of its {cfg.num_layers} layers at full width", flush=True)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ecfg = EngineConfig(max_slots=SERVE["slots"], max_len=SERVE["max_len"])
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(), f"{n_params} parameters, the config counts {cfg.param_count()}")
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"serve: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model}, {n_params} parameters "
          f"({n_bytes / 1e9:.2f} GB as held, f32 where the model keeps f32) made on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    prompts = serve_prompts(cfg.vocab)
    lens = np.array([len(p) for p in prompts])

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=SERVE["new_tokens"]) for i, p in enumerate(prompts)]

    # warm-up: cuBLAS handles, the kernels' first launches, allocator pools
    warm = ServeEngine(api, cfg, params, ecfg)
    warm.submit(Request(rid=-1, prompt=prompts[0][:64], max_new_tokens=4))
    warm.run_until_done()
    del warm

    for wrapper, _, _ in kernels.values():
        wrapper.launches = 0
    engine = ServeEngine(api, cfg, params, ecfg)
    reqs = requests()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: wrapper.launches for name, (wrapper, _, _) in kernels.items()}
    st = engine.stats
    check(all(r.done and len(r.output) == SERVE["new_tokens"] for r in reqs),
          f"every request done with {SERVE['new_tokens']} tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.output), "tokens in the vocabulary")
    for name, (_, per, each) in kernels.items():
        count = len(reqs) if per == "prefill" else st.decode_ticks
        check(launches[name] == each * count,
              f"{name} launches {launches[name]} == {each} a {per} x {count} {per}s")
    ttft = [r.first_token_at - t0 for r in reqs]
    out_tokens = sum(len(r.output) for r in reqs)  # the prefills' first tokens too
    print(f"serve: {len(reqs)} requests (prompts {lens.tolist()}), {SERVE['new_tokens']} new tokens each, "
          f"{SERVE['slots']} slots, max_len {SERVE['max_len']}: wall {wall:.3f} s, "
          f"{out_tokens} output tokens ({out_tokens / wall:.1f} tokens/s over the wall); "
          f"prefill {st.prefills} x in {st.prefill_s:.3f} s ({int(lens.sum()) / st.prefill_s:.0f} prompt tokens/s); "
          f"decode {st.decode_ticks} ticks, {st.decode_tokens} tokens in {st.decode_s:.3f} s "
          f"({st.decode_tokens / st.decode_s:.1f} tokens/s, {1e3 * st.decode_s / st.decode_ticks:.2f} ms/tick); "
          f"launches {launches}", flush=True)
    readings = {"arch": arch, "serve_ttft_s": [round(t, 4) for t in ttft],
                "output_tokens_per_s": out_tokens / wall,
                "decode_tick_tokens_per_s": st.decode_tokens / st.decode_s,
                "decode_ms_per_tick": 1e3 * st.decode_s / st.decode_ticks,
                "prefill_s": st.prefill_s,
                "wall_s": wall,
                "decode_ticks": st.decode_ticks,
                "lockstep_len": int(lens.max()) + 1}
    print(json.dumps(readings), flush=True)

    # request 0 alone: one slot, against a manual greedy prefill + decode loop
    alone = ServeEngine(api, cfg, params, EngineConfig(max_slots=1, max_len=SERVE["max_len"]))
    r0 = Request(rid=0, prompt=prompts[0], max_new_tokens=SERVE["new_tokens"])
    alone.submit(r0)
    alone.run_until_done()
    cache = api.init_cache(1, SERVE["max_len"], cfg)
    logits, cache = api.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None], cache, cfg)
    manual, gaps = [], []  # greedy tokens, and the gap between each step's two best logits
    for step in range(SERVE["new_tokens"]):
        top2 = logits[0].topk(2).values
        manual.append(int(logits[0].argmax()))
        gaps.append(float(top2[0] - top2[1]))
        if step < SERVE["new_tokens"] - 1:
            logits, cache = api.decode_step(params, torch.tensor([manual[-1]], device="cuda"), cache, cfg)
    check(r0.output == manual, "request 0 served alone == manual greedy prefill + decode loop")
    same4 = sum(a == b for a, b in zip(reqs[0].output, manual))
    first = next((i for i, (a, b) in enumerate(zip(reqs[0].output, manual)) if a != b), None)
    print(f"serve: request 0 alone == manual loop ({len(manual)} tokens); in the 4-slot run "
          f"{same4}/{len(manual)} tokens agree with it"
          + ("" if first is None else f", first apart at token {first}, where the alone run's two best "
             f"logits are {gaps[first]:.4g} apart"), flush=True)

    # the batch's own rounding: request 0's prefill state in all 4 slots, one
    # decode step, against the same step at batch 1
    one = api.init_cache(1, SERVE["max_len"], cfg)
    _, one = api.prefill(params, torch.as_tensor(prompts[0], device="cuda")[None], one, cfg)
    four = api.init_cache(SERVE["slots"], SERVE["max_len"], cfg)
    states = [k for k in one if k != "pos"]
    for slot in range(SERVE["slots"]):
        merge_slot({k: four[k] for k in states}, {k: one[k] for k in states}, slot, SERVE["slots"])
    four["pos"] = one["pos"]
    tok = torch.full((SERVE["slots"],), manual[0], dtype=torch.int32, device="cuda")
    l4, _ = api.decode_step(params, tok, four, cfg)
    l1, _ = api.decode_step(params, tok[:1], one, cfg)
    print(f"serve: one decode step of request 0's state at batch {SERVE['slots']} against batch 1: max abs "
          f"logit diff {float((l4[0] - l1[0]).abs().max()):.4g} (rows of the batch equal: "
          f"{bool((l4 == l4[:1]).all())}); smallest gap between the alone run's two best logits "
          f"{min(gaps):.4g}", flush=True)

    if cut is not None:
        _card_against_cpu(api, dataclasses.replace(cfg, **cut), cut_prompts, cut_ticks)

    # where the time goes: one wave of 4 requests under the profiler
    def one_wave():
        eng = ServeEngine(api, cfg, params, ecfg)
        for r in requests()[: SERVE["slots"]]:
            r.max_new_tokens = profile_tokens or r.max_new_tokens
            eng.submit(r)
        eng.run_until_done()

    print(json.dumps({"arch": arch, "serve_profile": device_time_breakdown(one_wave, classify=kernel_class)}),
          flush=True)
    return Served(launches, readings, params)


def _card_against_cpu(api, cut, prompts: tuple[int, ...], ticks: int) -> None:
    """The served width cut to ``cut``, on the card and on the CPU with the
    same weights: each prompt's prefill logits, then ``ticks`` decode steps
    on the CPU's tokens, within 5e-2 (atol and rtol) for a bf16 model and
    1e-3 for an f32 one."""
    tol = 1e-3 if cut.dtype == "float32" else 5e-2
    t0 = time.perf_counter()
    on_cpu = api.init(torch.Generator().manual_seed(1), cut, device="cpu")
    on_gpu = load_like(on_cpu, cut, "cuda")  # the same weights, drawn once on the host
    worst, agree, total = 0.0, 0, 0
    for n in prompts:
        toks = np.random.default_rng(n).integers(0, cut.vocab, n).astype(np.int32)
        caches = {d: api.init_cache(1, SERVE["max_len"], cut, device=d) for d in ("cpu", "cuda")}
        lg, caches["cuda"] = api.prefill(on_gpu, torch.as_tensor(toks, device="cuda")[None], caches["cuda"], cut)
        lc, caches["cpu"] = api.prefill(on_cpu, torch.as_tensor(toks)[None], caches["cpu"], cut)
        for step in range(ticks + 1):  # the prefill logits, then the decode steps
            lg = lg.cpu()
            diff = float((lg - lc).abs().max())
            check(torch.allclose(lg, lc, atol=tol, rtol=tol),
                  f"{cut.num_layers}-layer full width, prompt {n}, step {step}: card == CPU within {tol} "
                  f"(max abs diff {diff})")
            worst = max(worst, diff)
            agree += int(lg.argmax()) == int(lc.argmax())
            total += 1
            tok = lc.argmax(dim=-1).to(torch.int32)
            if step < ticks:
                lg, caches["cuda"] = api.decode_step(on_gpu, tok.cuda(), caches["cuda"], cut)
                lc, caches["cpu"] = api.decode_step(on_cpu, tok, caches["cpu"], cut)
    print(f"serve: {cut.num_layers}-layer full-width card vs CPU, prompts {list(prompts)}, prefill + {ticks} "
          f"decode steps: max abs logit diff {worst:.4g} ({cut.dtype}, tolerance {tol}), greedy tokens agree "
          f"{agree}/{total} ({time.perf_counter() - t0:.1f} s)", flush=True)


def ssd_work(x: torch.Tensor, G: int, N: int):
    """The SSD kernel's one formula (``kernels/work.py``, read by the
    dry-run's counter too) for ``x [B, L, H, P]`` with B and C of ``G``
    groups of width ``N``."""
    from repro_torch.launch import op_costs

    return op_costs.ssd_scan_work(x, torch.empty(x.shape[0], x.shape[1], G, N, dtype=x.dtype, device="meta"))


def ssd_bound_ms(x: torch.Tensor, G: int, N: int) -> tuple[float, str]:
    """Least time an H100 could take for an SSD scan of ``x [B, L, H, P]``
    with B and C of ``G`` groups of width ``N``: x, B, C, dt and A read
    once, y and the f32 final state written once, against the recurrence's
    4 * P * N operations per (batch, step, head) (a multiply-add each for the
    state update and the read of y) at the rate of x's dtype (bf16 tensor
    cores, or f32 outside them): :func:`ssd_work`."""
    w = ssd_work(x, G, N)
    return roofline_ms(w.flops, w.bytes, x.dtype)


def ssd_phase(prompt_lens: list[int]) -> dict:
    """Phase 8: the SSD kernel against its plain version on the card at
    mamba2-780m's prefill shapes (H 48, P 64, N 128, G 1, chunk 128), at
    zamba2-7b's (H 112, P 64, N 64, G 1) and at the reduced configs' (H 8, P
    16, N 16, chunk 16: the chunk-serial kernel, over one chunk and over
    many), timed beside the plain
    version; returns the kernel's record, with zamba2's times under
    ``zamba2_*`` keys and the reduced shape's under ``reduced_*``.

    f32 inputs: y and the final state within atol = rtol = 3e-4 of the plain
    version, the reference's own chunked-against-sequential limit
    (tests/test_kernels_ssd.py).  bf16 inputs: y within 3e-4 + 2**-8 * |y| of
    the plain version run in f32 on the same (bf16) values, half a bf16 step
    at y plus the f32 limit, since the kernel rounds its f32 result once; the
    final state (f32 in both) within 3e-4."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan_cuda, ssd_scan_ref

    # the bf16 kernels' resources and their tensor-core instructions
    for r in ptxas_resources(_build.build_log("ssd_scan")):
        if r["kernel"].startswith(("ssd_chunk_", "ssd_state_pass")):
            print(f"ssd ptxas {r['kernel']}: {r['registers']} registers, {r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads, {r['static_smem']} B static shared memory", flush=True)
    hgmma = sass_count(_build.library_path("ssd_scan"), "HGMMA")
    print(f"sass: ssd_scan holds {hgmma} HGMMA (wgmma) instructions", flush=True)
    check(hgmma > 0, "the bf16 SSD kernels run their products on wgmma")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P = 64
    # (label, B, L, G, H, N); per-head A and dt at the reference test's scales
    cases = [(f"mamba2 prefill L={n}", 1, n, 1, 48, 128) for n in prompt_lens]
    cases += [("L=1024 (8 whole chunks)", 1, 1024, 1, 48, 128), ("L=64 (under one chunk)", 1, 64, 1, 48, 128),
              ("G=4 L=891", 1, 891, 4, 48, 128), ("B=4 L=512", 4, 512, 1, 48, 128)]
    main = f"mamba2 prefill L={max(prompt_lens)}"
    zamba_main = f"zamba2 prefill L={max(prompt_lens)}"
    cases += [(zamba_main, 1, max(prompt_lens), 1, 112, 64), ("zamba2 L=64 (under one chunk)", 1, 64, 1, 112, 64)]
    record, max_err, zamba = None, 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, L, G, H, N in cases:
            x = torch.randn(B, L, H, P, generator=gen, device=dev).to(dtype)
            dt = torch.randn(B, L, H, generator=gen, device=dev).abs() * 0.1 + 0.01
            A = -(torch.randn(H, generator=gen, device=dev).abs() + 0.2)
            Bm = (torch.randn(B, L, G, N, generator=gen, device=dev) * 0.3).to(dtype)
            Cm = (torch.randn(B, L, G, N, generator=gen, device=dev) * 0.3).to(dtype)
            args = (x, dt, A, Bm, Cm)
            y, state = ssd_scan_cuda(*args)
            y_p, state_p = ssd_scan_ref(*args)
            y32, state32 = ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float())
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all()), f"ssd {label}: finite")
            rtol = 2**-8 if dtype == torch.bfloat16 else 3e-4
            err_y32 = float((y.float() - y32).abs().max())
            err_s32 = float((state - state32).abs().max())
            check(torch.allclose(y.float(), y32, atol=3e-4, rtol=rtol),
                  f"ssd {label} {dtype}: y == plain in f32 within atol 3e-4 rtol {rtol} (max abs diff {err_y32})")
            check(torch.allclose(state, state32, atol=3e-4, rtol=3e-4),
                  f"ssd {label} {dtype}: final state == plain within 3e-4 (max abs diff {err_s32})")
            err = max(float((y.float() - y_p.float()).abs().max()), float((state - state_p).abs().max()))
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: ssd_scan_cuda(*args), reps=20)
            plain_ms = cuda_ms(lambda: ssd_scan_ref(*args), reps=20)
            bound_ms, bound_by = ssd_bound_ms(x, G, N)
            print(f"ssd {label} B={B} G={G} H={H} N={N} {str(dtype)[6:]}: max abs diff {err:.3g} (y from f32 plain "
                  f"{err_y32:.3g}, state {err_s32:.3g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)
            if label == zamba_main and dtype == torch.bfloat16:
                zamba = {"zamba2_ms": ms, "zamba2_plain_ms": plain_ms, "zamba2_bound_ms": bound_ms,
                         "zamba2_bound_by": bound_by, "zamba2_library_ms": None}
            if label == main and dtype == torch.bfloat16:
                record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": None}
                # the device kernels one wrapper call runs, and each one's time
                # with the CPU activity too: with CUDA alone the profiler of
                # torch 2.11 recorded no device kernel (the count read 0)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        ssd_scan_cuda(*args)
                    torch.cuda.synchronize()
                per_kernel: dict[str, list] = {}
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        m = re.search(r"ssd_\w+", e.name)
                        row = per_kernel.setdefault(m.group(0) if m else e.name[:40], [0, 0.0])
                        row[0] += 1
                        row[1] += e.time_range.elapsed_us() / 1e3
                record["device_kernels_per_call"] = len(per_kernel)  # distinct kernels, each once a call
                print(f"ssd {label} bf16: {len(per_kernel)} device kernels per wrapper call (20 calls "
                      f"profiled): " + ", ".join(f"{k} {c} seen, {ms / c:.4f} ms each"
                                                 for k, (c, ms) in per_kernel.items()), flush=True)
    # the reduced ssm and hybrid configs' shape (H 8, P 16, N 16, chunk 16),
    # which the chunk-serial CUDA-core kernel takes in chunks of min(16, L),
    # timed: L 9 (a prompt under one chunk), 16 (one whole chunk), 40 (the
    # state carried over 3 chunks, the last ragged) and 891 (56 chunks); a
    # chunk of 48, not a multiple of the 32-row strip, at batch 2; and, held
    # but not timed, a head width of 48 (a 32-column tile and one of 16) at N
    # 32 and chunk 64, batch 2 and 2 groups, over ragged chunks
    reduced = [("reduced L=9", 1, 9, 1, 8, 16, 16, 16), ("reduced L=16", 1, 16, 1, 8, 16, 16, 16),
               ("reduced L=40", 1, 40, 1, 8, 16, 16, 16), ("reduced L=891", 1, 891, 1, 8, 16, 16, 16),
               ("reduced chunk 48 L=200", 2, 200, 1, 8, 16, 16, 48),
               ("P=48 N=32 chunk 64 L=300", 2, 300, 2, 8, 48, 32, 64)]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, L, G, H, P, N, chunk in reduced:
            check(ssd_plan(dtype, L, N, P, chunk) == (False, min(chunk, L)), f"ssd {label}: the chunk-serial kernel")
            x = torch.randn(B, L, H, P, generator=gen, device=dev).to(dtype)
            dt = torch.randn(B, L, H, generator=gen, device=dev).abs() * 0.1 + 0.01
            A = -(torch.randn(H, generator=gen, device=dev).abs() + 0.2)
            Bm = (torch.randn(B, L, G, N, generator=gen, device=dev) * 0.3).to(dtype)
            Cm = (torch.randn(B, L, G, N, generator=gen, device=dev) * 0.3).to(dtype)
            args = (x, dt, A, Bm, Cm)
            y, state = ssd_scan_cuda(*args, chunk=chunk)
            y_p, state_p = ssd_scan_ref(*args, chunk=chunk)
            y32, state32 = ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(), chunk=chunk)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all()), f"ssd {label}: finite")
            rtol = 2**-8 if dtype == torch.bfloat16 else 3e-4
            err_y32 = float((y.float() - y32).abs().max())
            err_s32 = float((state - state32).abs().max())
            check(torch.allclose(y.float(), y32, atol=3e-4, rtol=rtol),
                  f"ssd {label} {dtype}: y == plain in f32 within atol 3e-4 rtol {rtol} (max abs diff {err_y32})")
            check(torch.allclose(state, state32, atol=3e-4, rtol=3e-4),
                  f"ssd {label} {dtype}: final state == plain within 3e-4 (max abs diff {err_s32})")
            err = max(float((y.float() - y_p.float()).abs().max()), float((state - state_p).abs().max()))
            max_err = max(max_err, err)
            line = (f"ssd {label} B={B} G={G} H={H} P={P} N={N} chunk {chunk} {str(dtype)[6:]} (chunk-serial kernel): "
                    f"max abs diff {err:.3g} (y from f32 plain {err_y32:.3g}, state {err_s32:.3g})")
            if label.startswith("reduced"):
                ms = cuda_ms(lambda: ssd_scan_cuda(*args, chunk=chunk), reps=50)
                plain_ms = cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk), reps=20)
                bound_ms, bound_by = ssd_bound_ms(x, G, N)
                line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})"
                if label == "reduced L=16" and dtype == torch.bfloat16:
                    record.update(reduced_ms=ms, reduced_plain_ms=plain_ms, reduced_bound_ms=bound_ms,
                                  reduced_bound_by=bound_by)
            print(line, flush=True)
    record.update(zamba, max_abs_err=max_err)
    return record


def moe_decode_bound_ms(params, cfg, slots: int, length: int, experts_read: int) -> tuple[float, int]:
    """Least time an H100 could take for one MoE decode tick of ``slots``
    tokens at ``length`` cached positions each that reads the weights of
    ``experts_read`` (layer, expert) pairs: those experts, every other
    parameter the tick reads (each layer's attention and router, the norms
    and the unembedding; of the embedding table only the ``slots`` rows)
    and the KV cache rows the decode kernel reads, once, at the HBM rate.
    ``experts_read`` of layers x E is the bound of this design, whose dense
    capacity buffer runs every expert; the distinct experts the tick's
    tokens reach give the bound of the function.  The operations (2 per
    multiply-add) are far below the bytes at the bf16 rate.  Returns (ms,
    bytes)."""
    nbytes, expert_bytes = 0, 0
    for name, p in params.named_parameters():
        if name == "embed.tok":
            nbytes += slots * p.shape[1] * p.element_size()
        elif name.endswith((".moe.gate", ".moe.up", ".moe.down")):
            expert_bytes += p.numel() * p.element_size()
        else:
            nbytes += p.numel() * p.element_size()
    nbytes += expert_bytes * experts_read // (cfg.num_layers * cfg.num_experts)
    nbytes += cfg.num_layers * slots * length * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2  # bf16 k and v
    return 1e3 * nbytes / HBM_BYTES_PER_S, nbytes


def routed_decode_experts(api, cfg, params) -> torch.Tensor:
    """The serving run's 8 requests served again, each MoE layer's expert
    ids recorded: for each decode tick, the distinct experts its tokens
    reach, summed over the layers (``[ticks]``)."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    route, decode_ids = moe.route, []

    def recording_route(p, xt, cfg):
        out = route(p, xt, cfg)
        if xt.shape[0] == SERVE["slots"]:  # a decode tick; every prefill has 128 or more tokens
            decode_ids.append(out[2])
        return out

    moe.route = recording_route
    try:
        engine = ServeEngine(api, cfg, params, EngineConfig(max_slots=SERVE["slots"], max_len=SERVE["max_len"]))
        for i, prompt in enumerate(serve_prompts(cfg.vocab)):
            engine.submit(Request(rid=i, prompt=prompt, max_new_tokens=SERVE["new_tokens"]))
        engine.run_until_done()
    finally:
        moe.route = route
    ids = torch.stack(decode_ids).flatten(1).sort(dim=1).values  # [ticks x layers, slots x k]
    distinct = 1 + (ids[:, 1:] != ids[:, :-1]).sum(dim=1)
    return distinct.view(-1, cfg.num_layers).sum(dim=1).cpu()


def moe_stage_times(params, cfg, tokens: int) -> dict:
    """Device ms of each stage of one MoE layer (layer 0's weights) on
    ``tokens`` random bf16 tokens: route (the f32 router, softmax, top-k
    sort), dispatch (the stable sort of the pairs, searchsorted), scatter
    (the capacity buffer), experts (three bmm and the SwiGLU), combine (the
    gather, gates and adds), and the whole ``moe_ffn``; beside them the
    least time the experts' weights take to read, for all E experts (the
    dense capacity buffer's) and for the experts these tokens reach."""
    from repro_torch.models import moe

    p = params.blocks[0][0].moe
    x = torch.randn(1, tokens, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(tokens),
                    device="cuda").to(torch.bfloat16)
    xt = x.reshape(tokens, cfg.d_model)
    E, C = cfg.num_experts, moe.moe_capacity(cfg, tokens)
    _, gates, experts = moe.route(p, xt, cfg)
    slot, keep = moe.dispatch(experts, E, C)
    buf = moe.scatter(xt, slot, keep, E, C)
    out_buf = moe.experts_ffn(p, buf)
    stages = {
        "route": lambda: moe.route(p, xt, cfg),
        "dispatch": lambda: moe.dispatch(experts, E, C),
        "scatter": lambda: moe.scatter(xt, slot, keep, E, C),
        "experts (bmm)": lambda: moe.experts_ffn(p, buf),
        "combine": lambda: moe.combine(out_buf, slot, keep, gates, experts),
        "moe_ffn": lambda: moe.moe_ffn(p, x, cfg),
    }
    out = {name: cuda_ms(fn, reps=20) for name, fn in stages.items()}
    expert_bytes = sum(w.numel() * w.element_size() for w in (p.gate, p.up, p.down))
    reached = int(experts.unique().numel())
    out["dense_experts_bound_ms"] = 1e3 * expert_bytes / HBM_BYTES_PER_S
    out["routed_experts_bound_ms"] = 1e3 * expert_bytes * reached / E / HBM_BYTES_PER_S
    out["experts_reached"] = reached
    out["capacity"] = C
    print(f"moe {cfg.name} one layer at {tokens} tokens (C {C}): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items() if k in stages)
        + f"; reading the experts' weights bounds the layer at {out['dense_experts_bound_ms']:.4f} ms for the "
        f"dense capacity buffer (all {E} experts) and {out['routed_experts_bound_ms']:.4f} ms for the "
        f"{reached} experts these tokens reach (bytes)", flush=True)
    return out


def qwen_phase(layers: int = QWEN_LAYERS) -> dict[str, int]:
    """Phase 7: qwen2.5-3b at full width cut to ``layers`` served by the
    engine (every prefill layer through the flash kernel, every decode
    layer through the decode kernel), with its card-against-CPU cut of 2
    layers; its launches."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    return serve_phase("qwen2.5-3b", {"flash_attention": (flash_attention_cuda, "prefill", layers),
                                      "decode_attention": (decode_attention_cuda, "tick", layers)},
                       cut={"num_layers": 2}, layers=layers).launches


def mamba_phase(layers: int = MAMBA_LAYERS) -> dict[str, int]:
    """Phase 9: mamba2-780m at full width cut to ``layers`` served by the
    engine (every Mamba2 layer's prefill through the SSD kernel), with its
    card-against-CPU cut of 2 layers; its launches."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    return serve_phase("mamba2-780m", {"ssd_scan": (ssd_scan_cuda, "prefill", layers)}, cut={"num_layers": 2},
                       layers=layers).launches


def zamba_phase(layers: int = ZAMBA_LAYERS) -> dict[str, int]:
    """Phase 10: zamba2-7b at full width cut to ``layers`` served by the
    engine (every Mamba2 layer's prefill through the SSD kernel, every
    shared invocation through flash and decode), with its card-against-CPU
    cut of one Mamba2 layer, then the shared block; its launches."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models.hybrid import num_shared_invocations
    from repro_torch.models.registry import get_model

    n_inv = num_shared_invocations(dataclasses.replace(get_model("zamba2-7b").config, num_layers=layers))
    return serve_phase("zamba2-7b", {
        "ssd_scan": (ssd_scan_cuda, "prefill", layers),
        "flash_attention": (flash_attention_cuda, "prefill", n_inv),
        "decode_attention": (decode_attention_cuda, "tick", n_inv),
    }, cut={"num_layers": 2, "hybrid_period": 2}, layers=layers).launches


def moe_phase(moe_layers: int = MOE_LAYERS, mixtral_layers: int = MIXTRAL_LAYERS) -> dict[str, dict[str, int]]:
    """Phase 17: the MoE family on the card.  qwen3-moe-30b-a3b at full
    width cut to ``moe_layers`` of its 48 layers (128 experts top-8, random
    bf16 weights and an f32 router made on the card from a seed) served as
    in phase 7: 8
    requests through 4 slots, every prefill layer through the flash kernel,
    every decode layer through the decode kernel; request 0 alone equal to
    the manual loop; a 2-layer f32 cut held against the CPU on one prompt and
    three decode steps; the peak memory, the decode tick beside its bound
    for this design (every expert read) and for the experts the run's ticks
    reach (the requests served again, routing recorded), the profile (a wave
    of 4 requests to 8 new tokens: some 50,000 device kernels), and each MoE
    stage of one layer timed at the decode and the longest prefill's token
    counts.  Then mixtral-8x7b at full width cut to ``mixtral_layers`` of
    its 32 layers (E 8, top-2, d_ff 14336), served the same way without the
    CPU check; phase 6
    holds its attention shapes.  Every earlier phase's model is freed first.
    Returns each path's launches by kernel."""
    import gc

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    out: dict[str, dict[str, int]] = {}
    arch = "qwen3-moe-30b-a3b"
    api = get_model(arch)
    cfg = dataclasses.replace(api.config, num_layers=moe_layers)
    L = cfg.num_layers
    served = serve_phase(arch, {"flash_attention": (flash_attention_cuda, "prefill", L),
                                "decode_attention": (decode_attention_cuda, "tick", L)},
                         cut={"num_layers": 2, "dtype": "float32"}, layers=L, cut_prompts=(128,), cut_ticks=3,
                         profile_tokens=8)
    out[arch] = served.launches
    check(out[arch]["flash_attention"] == L * SERVE["requests"], f"{arch}: {L} x 8 flash launches")
    peak = torch.cuda.max_memory_allocated()
    params, readings = served.params, served.readings
    del served
    slots, length = SERVE["slots"], readings["lockstep_len"]
    dense_ms, dense_bytes = moe_decode_bound_ms(params, cfg, slots, length, L * cfg.num_experts)
    reached = routed_decode_experts(api, cfg, params)
    check(len(reached) == readings["decode_ticks"], f"the replay ran the {readings['decode_ticks']} decode ticks")
    routed = [moe_decode_bound_ms(params, cfg, slots, length, int(n)) for n in reached]
    routed_ms = statistics.mean(ms for ms, _ in routed)
    print(f"moe {arch}: peak {peak / 1e9:.2f} GB allocated of the card's {total / 1e9:.2f} GB; decode "
          f"{readings['decode_ms_per_tick']:.2f} ms a tick ({readings['decode_ticks']} ticks) against a bound of "
          f"{routed_ms:.2f} ms for the experts the ticks reach ({reached.min().item()}-{reached.max().item()} "
          f"of the {L * cfg.num_experts} (layer, expert) pairs a tick, mean {reached.float().mean().item():.1f}; "
          f"{min(b for _, b in routed) / 1e9:.2f}-{max(b for _, b in routed) / 1e9:.2f} GB) and of {dense_ms:.2f} ms "
          f"for this design's dense capacity buffer, which reads every expert ({dense_bytes / 1e9:.2f} GB); "
          f"{slots} slots at {length} positions, bytes", flush=True)
    stages = {"decode": moe_stage_times(params, cfg, slots),
              "prefill": moe_stage_times(params, cfg, max(len(p) for p in serve_prompts(cfg.vocab)))}
    print(json.dumps({"moe": {"arch": arch, "peak_bytes": peak, "card_bytes": total,
                              "decode_ms_per_tick": readings["decode_ms_per_tick"],
                              "decode_routed_bound_ms": routed_ms,
                              "decode_routed_experts_per_tick": reached.tolist(),
                              "decode_dense_bound_ms": dense_ms, "decode_dense_bound_bytes": dense_bytes,
                              "stages_ms": stages}}), flush=True)
    del params, readings
    gc.collect()
    torch.cuda.empty_cache()

    arch, layers = "mixtral-8x7b", mixtral_layers
    out[arch] = serve_phase(arch, {"flash_attention": (flash_attention_cuda, "prefill", layers),
                                   "decode_attention": (decode_attention_cuda, "tick", layers)},
                            cut=None, layers=layers, profile_tokens=8).launches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def continuum_phase() -> dict[str, int]:
    """Phase 18: the ML-job continuum on the card.  ``schedule_jobs`` with
    the GA at its defaults (population 64, 60 generations: 61 launches of
    the makespan kernel), a valid schedule whose f32 oracle re-score equals
    the kernel's makespan; HEFT and ``auto`` beside it (which solver auto
    chose); the job scenario through the ``Orchestrator`` with the GA.
    Returns the makespan kernel's launches by path."""
    import tempfile

    from repro_torch.core import api, continuum, evaluate_assignment, verify_schedule
    from repro_torch.engine import population_fitness_fn
    from repro_torch.kernels.makespan import population_makespan_cuda

    out: dict[str, int] = {}
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    rep, system = continuum.schedule_jobs(technique="ga", seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["continuum ga"] = population_makespan_cuda.launches
    check(out["continuum ga"] == 61, f"schedule_jobs(ga) made {out['continuum ga']} kernel launches, expected 61")
    check(verify_schedule(rep.problem, rep.schedule) == [], "schedule_jobs(ga): valid schedule")
    check(bool(np.isfinite(rep.schedule.makespan)), "schedule_jobs(ga): finite makespan")
    _, mk = population_fitness_fn(rep.problem, engine="cuda", device="cuda")(rep.schedule.assignment[None])
    oracle32 = evaluate_assignment(rep.problem, rep.schedule.assignment, dtype=np.float32).makespan
    check(float(mk[0]) == oracle32, "schedule_jobs(ga): the f32 oracle re-scores the best to the kernel's makespan")
    print(f"continuum: schedule_jobs(ga) over {rep.problem.num_tasks} jobs on {system.num_nodes} slices: "
          f"{wall:.3f} s wall, {out['continuum ga']} kernel launches, makespan {rep.schedule.makespan!r} "
          f"(kernel re-score {float(mk[0])!r}, f32 oracle {oracle32!r})", flush=True)
    for technique in ("heft", "auto"):
        t0 = time.perf_counter()
        rep, _ = continuum.schedule_jobs(technique=technique)
        check(verify_schedule(rep.problem, rep.schedule) == [], f"schedule_jobs({technique}): valid schedule")
        print(f"continuum: schedule_jobs({technique}) chose {rep.schedule.technique}: makespan "
              f"{rep.schedule.makespan!r} in {time.perf_counter() - t0:.3f} s", flush=True)
    population_makespan_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        result = api.Orchestrator(continuum.jobs_scenario(technique="ga"), out_dir=tmp).run()
        torch.cuda.synchronize()
        summary = result.summary()
    out["continuum scenario"] = population_makespan_cuda.launches
    check(out["continuum scenario"] > 0 and out["continuum scenario"] % 61 == 0,
          f"the job scenario's GA solves made {out['continuum scenario']} launches, 61 a solve")
    print(f"continuum: jobs_scenario(ga) through the Orchestrator in {time.perf_counter() - t0:.3f} s: "
          f"technique {summary['technique']}, predicted makespan {summary['predicted_makespan']!r}, "
          f"{out['continuum scenario']} kernel launches", flush=True)
    return out


WHISPER = {"requests": 8, "batch": 4, "prompt": 8, "ticks": 32, "max_len": 64}
# phase 20 serves internvl2-76b at 2 of its 80 layers (8 before phase 25 (c)
# served it whole on four cards: the cut rule, ``tools/cut_probe.py 20``),
# and pins the cut's parameters at each depth it has served
VLM = {"layers": 2, "requests": 4, "prompt": 128, "ticks": 31, "max_len": 512, "cut_prompt": 32}
VLM_PARAMS = {2: 3_814_760_448, 8: 8_948_686_848}
BF16_TOL = 5e-2  # atol = rtol of two bf16 runs of one model that round at other places


def load_like(params: torch.nn.Module, cfg, device: str) -> torch.nn.Module:
    """A copy of ``params`` (a model of ``cfg``) on ``device``."""
    copy = type(params)(cfg, torch.device("meta")).to_empty(device=device)
    copy.load_state_dict(params.state_dict())
    return copy


def teacher_forced(api, cfg, params, prompt, extras: dict, tokens: torch.Tensor, max_len: int) -> list:
    """Logits [1, V] of one request alone: its prefill, then a decode step
    on each of ``tokens`` (the batch's greedy tokens of that request)."""
    cache = api.init_cache(1, max_len, cfg)
    logits, cache = api.prefill(params, prompt, cache, cfg, **extras)
    out = [logits]
    for tok in tokens:
        logits, cache = api.decode_step(params, tok.reshape(1).to(torch.int32), cache, cfg)
        out.append(logits)
    return out


def alone_against_batch(label: str, batch_logits: list, alone_logits: list, alone_tokens: list) -> None:
    """Request 0 alone against its row of the batch: the teacher-forced
    logits within :data:`BF16_TOL` at every step (checked), and how many of
    the greedy tokens of a free run alone agree with the batch's (printed,
    with the gap of the alone run's two best logits where they part)."""
    worst = 0.0
    for step, (b, a) in enumerate(zip(batch_logits, alone_logits)):
        diff = float((b[0].float() - a[0].float()).abs().max())
        check(torch.allclose(b[0].float(), a[0].float(), atol=BF16_TOL, rtol=BF16_TOL),
              f"{label}: request 0 alone == its row of the batch at step {step} within {BF16_TOL} (max {diff})")
        worst = max(worst, diff)
    batch_tokens = [int(b[0].argmax()) for b in batch_logits]
    agree = sum(x == y for x, y in zip(batch_tokens, alone_tokens))
    first = next((i for i, (x, y) in enumerate(zip(batch_tokens, alone_tokens)) if x != y), None)
    gap = ""
    if first is not None:
        top2 = alone_logits[first][0].float().topk(2).values
        gap = f", first apart at token {first}, where the batch row's two best logits are {float(top2[0] - top2[1]):.4g} apart"
    print(f"{label}: request 0 alone, teacher-forced on its batch tokens, within {worst:.4g} of its row of the "
          f"batch ({len(batch_logits)} steps); greedy alone {agree}/{len(batch_tokens)} tokens as in the batch"
          + gap, flush=True)


def whisper_phase() -> tuple[dict[str, int], dict]:
    """Phase 19: whisper-base at full width and depth (6 + 6 layers, d 512,
    8 heads of 64, vocab 51,865, 1500 frames; random bf16 weights made on
    the card from a seed).  8 requests of 1500 random frames (numpy seed 0,
    normals x 0.1, as the reference's test makes them) and 8-token decoder
    prompts, in batches of 4 through ``prefill(frames=)`` and 32 greedy
    ``decode_step`` ticks: every encoder, decoder and cross-attention layer
    of a prefill through the flash kernel (18), every self- and
    cross-attention layer of a tick through the decode kernel (12).
    Request 0 alone against its row of the batch; one batch under the
    profiler; the whole model in f32 on the card against the CPU, prefill
    and 4 ticks within 1e-3.  Returns the launches and the last batch's
    self- and cross-attention caches (a real KV cache for phase 21)."""
    import gc

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    W = WHISPER
    api = get_model("whisper-base")
    cfg = api.config
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count() == 88_187_392, f"whisper-base: {n_params} parameters")
    print(f"whisper: {cfg.name} {cfg.enc_layers} + {cfg.num_layers} layers d_model {cfg.d_model}, {n_params} "
          f"parameters made on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    frames32 = (rng.standard_normal((W["requests"], cfg.enc_frames, cfg.d_model)) * 0.1).astype(np.float32)
    frames = torch.from_numpy(frames32).to("cuda", torch.bfloat16)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (W["requests"], W["prompt"])).astype(np.int32)).cuda()

    def generate(rows: slice):
        """The requests ``rows`` as one batch: (each step's logits, prefill s, decode s, cache)."""
        cache = api.init_cache(rows.stop - rows.start, W["max_len"], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, prompts[rows], cache, cfg, frames=frames[rows])
        steps = [logits]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(W["ticks"]):
            logits, cache = api.decode_step(params, logits.argmax(-1).to(torch.int32), cache, cfg)
            steps.append(logits)
        torch.cuda.synchronize()
        return steps, t1 - t0, time.perf_counter() - t1, cache

    generate(slice(0, W["batch"]))  # warm-up: cuBLAS handles, first launches, allocator pools
    flash_attention_cuda.launches = decode_attention_cuda.launches = 0
    runs = [generate(slice(b, b + W["batch"])) for b in range(0, W["requests"], W["batch"])]
    launches = {"flash_attention": flash_attention_cuda.launches,
                "decode_attention": decode_attention_cuda.launches}
    batches = len(runs)
    check(launches["flash_attention"] == 18 * batches,
          f"whisper: flash launches {launches['flash_attention']} == 18 a prefill x {batches}")
    check(launches["decode_attention"] == 12 * W["ticks"] * batches,
          f"whisper: decode launches {launches['decode_attention']} == 12 a tick x {W['ticks']} x {batches}")
    tokens = torch.cat([torch.stack([s.argmax(-1) for s in steps], 1) for steps, _, _, _ in runs]).cpu()
    check(all(bool(torch.isfinite(s.float()).all()) for steps, _, _, _ in runs for s in steps), "whisper: finite logits")
    check(tuple(tokens.shape) == (W["requests"], W["ticks"] + 1) and bool((tokens < cfg.vocab).all()),
          "whisper: every request's tokens in the vocabulary")
    prefill_s = [r[1] for r in runs]
    tick_ms = [1e3 * r[2] / W["ticks"] for r in runs]
    print(f"whisper: {W['requests']} requests of {cfg.enc_frames} frames and {W['prompt']}-token prompts in "
          f"batches of {W['batch']}: prefill {[round(x, 4) for x in prefill_s]} s, decode "
          f"{[round(x, 3) for x in tick_ms]} ms a tick ({W['ticks']} ticks); launches {launches}", flush=True)

    steps0 = runs[0][0]
    batch0 = [s[:1] for s in steps0]
    alone = teacher_forced(api, cfg, params, prompts[:1], {"frames": frames[:1]},
                           torch.stack([s[0].argmax() for s in steps0[:-1]]), W["max_len"])
    free = generate(slice(0, 1))[0]
    alone_against_batch("whisper", batch0, alone, [int(s[0].argmax()) for s in free])

    profile = device_time_breakdown(lambda: generate(slice(0, W["batch"])), classify=kernel_class)
    print(json.dumps({"arch": "whisper-base", "serve_profile": profile}), flush=True)
    cache = runs[-1][3]

    # the whole model in f32, on the card and on the CPU, the same weights
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    on_cpu = api.init(torch.Generator().manual_seed(1), cfg32, device="cpu")
    on_gpu = load_like(on_cpu, cfg32, "cuda")
    f32 = torch.from_numpy(frames32[:1])
    prompt = prompts[:1].cpu()
    caches = {d: api.init_cache(1, W["max_len"], cfg32, device=d) for d in ("cpu", "cuda")}
    lg, caches["cuda"] = api.prefill(on_gpu, prompt.cuda(), caches["cuda"], cfg32, frames=f32.cuda())
    lc, caches["cpu"] = api.prefill(on_cpu, prompt, caches["cpu"], cfg32, frames=f32)
    worst = 0.0
    for step in range(5):
        diff = float((lg.cpu() - lc).abs().max())
        check(torch.allclose(lg.cpu(), lc, atol=1e-3, rtol=1e-3),
              f"whisper f32 full model, step {step}: card == CPU within 1e-3 (max abs diff {diff})")
        worst = max(worst, diff)
        tok = lc.argmax(-1).to(torch.int32)
        if step < 4:
            lg, caches["cuda"] = api.decode_step(on_gpu, tok.cuda(), caches["cuda"], cfg32)
            lc, caches["cpu"] = api.decode_step(on_cpu, tok, caches["cpu"], cfg32)
    print(f"whisper: the whole model in f32, card vs CPU, prefill + 4 decode steps: max abs logit diff "
          f"{worst:.4g} (tolerance 1e-3; {time.perf_counter() - t0:.1f} s)", flush=True)
    del on_cpu, on_gpu, caches, params
    return launches, {k: cache[k] for k in ("self_k", "cross_k", "cross_v")}


def weights_read_bound_ms(params: torch.nn.Module, cfg, slots: int, length: int) -> tuple[float, int]:
    """Least time of a decode tick of a dense LM on an H100 (bytes): every
    weight read once but the input embedding (a row a slot) and a vlm's
    patch positions, and the keys
    and values of ``slots`` sequences of ``length`` positions in every
    layer."""
    nbytes = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
                 if name not in ("embed.tok", "patch_pos"))
    size = params.embed.tok.element_size()
    nbytes += slots * cfg.d_model * size
    nbytes += cfg.num_layers * 2 * slots * length * cfg.num_kv_heads * cfg.resolved_head_dim * size
    return 1e3 * nbytes / HBM_BYTES_PER_S, nbytes


def internvl2_phase(layers: int = VLM["layers"]) -> dict[str, dict[str, int]]:
    """Phase 20: internvl2-76b at full width (d 8192, 64 heads over 8 KV
    heads of 128, d_ff 28,672, vocab 128,256, 256 patches) cut to ``layers``
    of its 80 (full depth is 141.1 GB in bf16; phase 25 (c) serves all 80 on
    four cards).  The reference's serving
    path for a vlm, text-only through ``ServeEngine`` as phase 17 serves
    mixtral; then the multimodal path: 4 requests of 256 random patch
    embeddings and a 128-token prompt through ``prefill(patches=)`` at batch
    4 and 31 greedy decode ticks (8 flash launches a prefill, 8 decode a
    tick), request 0 alone against its row; the peak memory; the decode
    tick beside the bytes of the weights it reads; a cut of 1 layer at full
    width in f32 held card against CPU on 256 patches and a 32-token prompt.
    Returns each path's launches."""
    import gc

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    V = VLM
    arch = "internvl2-76b"
    api = get_model(arch)
    cfg = dataclasses.replace(api.config, num_layers=layers)
    check(cfg.param_count() == VLM_PARAMS[layers], f"{arch} cut to {layers} layers: {cfg.param_count()} parameters")
    out: dict[str, dict[str, int]] = {}
    served = serve_phase(arch, {"flash_attention": (flash_attention_cuda, "prefill", layers),
                                "decode_attention": (decode_attention_cuda, "tick", layers)},
                         cut=None, layers=layers, profile_tokens=8)
    out[f"{arch} {layers} layers"] = served.launches
    params, readings = served.params, served.readings
    del served
    init_peak = torch.cuda.max_memory_allocated()  # the weights' f32 draws on the card, then serving
    torch.cuda.reset_peak_memory_stats()
    bound_ms, bound_bytes = weights_read_bound_ms(params, cfg, SERVE["slots"], readings["lockstep_len"])
    print(f"vlm {arch}: decode {readings['decode_ms_per_tick']:.2f} ms a tick against a bound of {bound_ms:.3f} ms "
          f"(bytes: {bound_bytes / 1e9:.2f} GB of weights and KV read once a tick)", flush=True)

    rng = np.random.default_rng(0)
    patches = torch.from_numpy((rng.standard_normal((V["requests"], cfg.num_patches, cfg.d_model)) * 0.1)
                               .astype(np.float32)).to("cuda", torch.bfloat16)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (V["requests"], V["prompt"])).astype(np.int32)).cuda()

    def multimodal(n: int):
        cache = api.init_cache(n, V["max_len"], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, prompts[:n], cache, cfg, patches=patches[:n])
        steps = [logits]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(V["ticks"]):
            logits, cache = api.decode_step(params, logits.argmax(-1).to(torch.int32), cache, cfg)
            steps.append(logits)
        torch.cuda.synchronize()
        check(cache["pos"] == cfg.num_patches + V["prompt"] + V["ticks"], "vlm: the cache position counts the patches")
        return steps, t1 - t0, time.perf_counter() - t1

    multimodal(1)  # warm-up at the multimodal shapes
    flash_attention_cuda.launches = decode_attention_cuda.launches = 0
    steps, prefill_s, decode_s = multimodal(V["requests"])
    mm = {"flash_attention": flash_attention_cuda.launches, "decode_attention": decode_attention_cuda.launches}
    check(mm["flash_attention"] == layers, f"vlm multimodal: flash launches {mm['flash_attention']} == {layers}")
    check(mm["decode_attention"] == layers * V["ticks"],
          f"vlm multimodal: decode launches {mm['decode_attention']} == {layers} x {V['ticks']}")
    check(all(bool(torch.isfinite(s).all()) for s in steps), "vlm multimodal: finite logits")
    out[f"{arch} multimodal"] = mm
    peak = torch.cuda.max_memory_allocated()
    print(f"vlm {arch}: {V['requests']} requests of {cfg.num_patches} patches + {V['prompt']} tokens at batch "
          f"{V['requests']}: prefill {prefill_s:.4f} s, decode {1e3 * decode_s / V['ticks']:.3f} ms a tick "
          f"({V['ticks']} ticks), launches {mm}; peak {peak / 1e9:.2f} GB allocated of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB (with the weights' f32 draws at "
          f"their making and the text-only serving run: {init_peak / 1e9:.2f} GB)", flush=True)
    alone = teacher_forced(api, cfg, params, prompts[:1], {"patches": patches[:1]},
                           torch.stack([s[0].argmax() for s in steps[:-1]]), V["max_len"])
    free = multimodal(1)[0]
    alone_against_batch(f"vlm {arch} multimodal", [s[:1] for s in steps], alone, [int(s[0].argmax()) for s in free])
    mm_bound_ms, _ = weights_read_bound_ms(params, cfg, V["requests"], cfg.num_patches + V["prompt"] + V["ticks"])
    print(json.dumps({"vlm": {"arch": arch, "layers": layers, "peak_bytes": peak, "init_peak_bytes": init_peak,
                              "serve_decode_ms_per_tick": readings["decode_ms_per_tick"],
                              "serve_decode_bound_ms": bound_ms, "multimodal_prefill_s": prefill_s,
                              "multimodal_decode_ms_per_tick": 1e3 * decode_s / V["ticks"],
                              "multimodal_decode_bound_ms": mm_bound_ms}}), flush=True)
    del params, steps, alone, free
    gc.collect()
    torch.cuda.empty_cache()

    # one layer at full width in f32, on the card and on the CPU
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    # drawn on the card and copied to the host: 3 billion draws on the host took 28.8 s
    on_gpu = api.init(torch.Generator(device="cuda").manual_seed(1), cut, device="cuda")
    on_cpu = load_like(on_gpu, cut, "cpu")
    made_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = V["cut_prompt"]
    caches = {d: api.init_cache(1, 512, cut, device=d) for d in ("cpu", "cuda")}
    extras = {d: {"patches": patches[:1].float().to(d)} for d in ("cpu", "cuda")}
    lg, caches["cuda"] = api.prefill(on_gpu, prompts[:1, :n], caches["cuda"], cut, **extras["cuda"])
    lc, caches["cpu"] = api.prefill(on_cpu, prompts[:1, :n].cpu(), caches["cpu"], cut, **extras["cpu"])
    worst = 0.0
    for step in range(4):
        diff = float((lg.cpu() - lc).abs().max())
        check(torch.allclose(lg.cpu(), lc, atol=1e-3, rtol=1e-3),
              f"vlm f32 1-layer cut, step {step}: card == CPU within 1e-3 (max abs diff {diff})")
        worst = max(worst, diff)
        tok = lc.argmax(-1).to(torch.int32)
        if step < 3:
            lg, caches["cuda"] = api.decode_step(on_gpu, tok.cuda(), caches["cuda"], cut)
            lc, caches["cpu"] = api.decode_step(on_cpu, tok, caches["cpu"], cut)
    print(f"vlm {arch}: a 1-layer full-width cut in f32 ({cut.param_count()} parameters, made in {made_s:.1f} s), "
          f"card vs CPU on {cfg.num_patches} patches + {n} tokens, prefill + 3 decode steps: max abs logit diff "
          f"{worst:.4g} (tolerance 1e-3; {time.perf_counter() - t0:.1f} s)", flush=True)
    del on_cpu, on_gpu, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sampling_phase(kv: dict) -> None:
    """Phase 21: sampling and the int8 KV cache on the card.  Seeded logits
    [4, V] at qwen2.5-3b's vocabulary, ties planted at the top-k cut of row
    0: greedy == argmax; each mask on the card == on the CPU bit for bit;
    draws from a CUDA ``torch.Generator`` inside the mask.  whisper's real
    KV cache from phase 19: ``quantize_kv`` / ``dequantize_kv`` on the card
    == on the CPU bit for bit, and decode attention through the kernel over
    the dequantized cross-attention cache within the reference's 0.05 of
    the bf16 cache."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.models.registry import get_model
    from repro_torch.serve.kvcache import dequantize_kv, quantize_kv
    from repro_torch.serve.sampling import SamplingConfig, mask_logits, sample

    vocab = get_model("qwen2.5-3b").config.vocab
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.standard_normal((4, vocab)) * 3).astype(np.float32))
    order = torch.argsort(logits[0], descending=True)
    logits[0, order[30:60]] = float(logits[0, order[49]])  # ties across the 50th value
    on_card = logits.cuda()
    greedy = sample(on_card, torch.Generator(device="cuda").manual_seed(0))
    check(torch.equal(greedy.cpu(), logits.argmax(-1).to(torch.int32)), "sampling: greedy == argmax on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cfg in (SamplingConfig(temperature=0.7), SamplingConfig(temperature=1.0, top_k=50),
                SamplingConfig(temperature=1.0, top_p=0.9), SamplingConfig(temperature=0.8, top_k=200, top_p=0.7)):
        masked = mask_logits(on_card, cfg)
        plain = mask_logits(logits, cfg)
        check(torch.equal(masked.cpu(), plain), f"sampling {cfg}: the mask on the card == on the CPU, bit for bit")
        kept = torch.isfinite(plain).sum(-1).tolist()
        if cfg.top_k == 50 and not cfg.top_p < 1.0:
            check(kept == [60, 50, 50, 50], f"sampling {cfg}: the tied row keeps its 30 ties at the 50th value")
        draws = torch.stack([sample(on_card, gen, cfg) for _ in range(50)])
        inside = torch.isfinite(masked.gather(1, draws.T.long())).all()
        check(bool(inside), f"sampling {cfg}: 50 draws a row from a CUDA generator inside the mask")
        print(f"sampling {cfg}: mask card == CPU bit for bit, kept {kept} of {vocab} a row, 50 draws a row "
              f"inside it", flush=True)

    for name, t in kv.items():
        codes, scale = quantize_kv(t)
        codes_c, scale_c = quantize_kv(t.cpu())
        check(torch.equal(codes.cpu(), codes_c) and torch.equal(scale.cpu(), scale_c),
              f"int8 {name} {tuple(t.shape)}: codes and scales on the card == on the CPU")
        back = dequantize_kv(codes, scale)
        check(torch.equal(back.cpu(), dequantize_kv(codes_c, scale_c)), f"int8 {name}: dequantized card == CPU")
        print(f"int8 {name} {tuple(t.shape)} {t.dtype}: card == CPU bit for bit; round trip max abs error "
              f"{float((back.float() - t.float()).abs().max()):.4g} (largest scale {float(scale.max()):.4g})",
              flush=True)
    k, v = kv["cross_k"][0], kv["cross_v"][0]  # layer 0: [B, Hkv, 1500, D] bf16
    B, Hkv, S, D = k.shape
    q = torch.from_numpy(rng.standard_normal((B, 8, D)).astype(np.float32)).to("cuda", k.dtype)
    lengths = torch.full((B,), S, dtype=torch.int32, device="cuda")
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    out = decode_attention_cuda(q, k, v, lengths)
    out_q = decode_attention_cuda(q, dequantize_kv(kq, ks), dequantize_kv(vq, vs), lengths)
    err = float((out.float() - out_q.float()).abs().max())
    check(err < 0.05, f"int8: decode attention over the dequantized cache within 0.05 of the bf16 cache ({err})")
    print(f"int8: decode attention (the kernel) over whisper's dequantized cross-attention cache {tuple(k.shape)}: "
          f"max abs diff {err:.4g} from the bf16 cache (bound 0.05)", flush=True)


MH = {  # the reference's defaults (src/repro/core/metaheuristics.py) and launches a run
    "pso": ({"pop_size": 64, "iterations": 60}, 61),
    "sa": ({"chains": 32, "steps": 200}, 201),
    "aco": ({"ants": 48, "iterations": 60}, 60),
}
# The kernel == plain comparison's options where they differ from MH, the
# cuts the ROADMAP's facts allow, in their order, once a run passes 800 s:
# SA's plain run (94 s of a 930.9 s run on an H100 at 700 W) was cut to 50
# steps, then, at 912 s before phase 21 with the encdec and vlm phases,
# to 20 steps, and PSO's and ACO's (25-28 s each) to 20 iterations; with
# phase 23 (the dry-run, 64 s in its probe) after an 837.3 s run, SA's to 10
# steps and PSO's and ACO's to 10 iterations; with phase 24 (the sharded
# step, 217.8 s) after a 1000.9 s run, SA's to 5 steps and PSO's and ACO's
# to 5 iterations (5.1-6.8 s each at 10); the kernel runs the same options
# beside each.
MH_PLAIN = {"pso": {"pop_size": 64, "iterations": 5}, "sa": {"chains": 32, "steps": 5},
            "aco": {"ants": 48, "iterations": 5}}


def makespan_class(name: str) -> str:
    """The makespan kernels (``void (anonymous namespace)::population_makespan_...``)
    against the rest."""
    return "makespan kernel" if "population_makespan" in name else "other"


def metaheuristics_phase(problem, ga_result) -> dict[str, int]:
    """Phase 12: PSO, SA and ACO at Table IX through the kernel, held to
    the same runs through the plain version on the card; each one's
    launches, validity and a profiled warm run.  Returns the launches."""
    from repro_torch.core import evaluate_assignment, verify_schedule
    from repro_torch.core.heuristics import heft, olb
    from repro_torch.core.metaheuristics import TECHNIQUES
    from repro_torch.engine import population_fitness_fn
    from repro_torch.kernels.makespan import population_makespan_cuda

    out: dict[str, int] = {}
    profiles: dict[str, dict] = {}
    for tech, (opts, want) in MH.items():
        fn = TECHNIQUES[tech]
        population_makespan_cuda.launches = 0
        t0 = time.perf_counter()
        res = fn(problem, backend="auto", device="cuda", seed=0, **opts)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        out[tech] = population_makespan_cuda.launches
        check(out[tech] == want, f"{tech} made {out[tech]} kernel launches, expected {want}")
        plain_opts = MH_PLAIN.get(tech, opts)
        ker = res if plain_opts == opts else fn(problem, backend="auto", device="cuda", seed=0, **plain_opts)
        t0 = time.perf_counter()
        plain = fn(problem, backend="torch", device="cuda", seed=0, **plain_opts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(np.array_equal(ker.schedule.assignment, plain.schedule.assignment),
              f"{tech} {plain_opts}: kernel and plain version give the same best assignment")
        check(ker.history.dtype == plain.history.dtype and
              np.array_equal(ker.history.view(np.int32), plain.history.view(np.int32)),
              f"{tech} {plain_opts}: kernel and plain version give the same history, bit for bit")
        check(verify_schedule(problem, res.schedule) == [], f"{tech} schedule is valid")
        check(bool(np.isfinite(res.schedule.makespan)), f"{tech}: finite makespan")
        _, mk_best = population_fitness_fn(problem, engine="cuda", device="cuda")(res.schedule.assignment[None])
        oracle32 = evaluate_assignment(problem, res.schedule.assignment, dtype=np.float32).makespan
        check(float(mk_best[0]) == oracle32, f"{tech}: f32 oracle re-scores the best to the kernel's makespan")
        check(bool(np.isfinite(res.history).all() and (np.diff(res.history) <= 0).all()), f"{tech} history")
        t0 = time.perf_counter()
        fn(problem, backend="auto", device="cuda", seed=0, **opts)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        profiles[tech] = device_time_breakdown(
            lambda: fn(problem, backend="auto", device="cuda", seed=0, **opts), classify=makespan_class
        )
        prof = profiles[tech]
        prof["warm_wall_ms"] = warm_ms  # the same run without the profiler
        kernel = prof.get("by_class", {}).get("makespan kernel", {"count": 0, "ms": 0.0})
        print(f"{tech} 500x500 {opts}: {wall_s:.3f} s wall (first run), plain version {plain_s:.3f} s "
              f"({plain_opts}), "
              f"{out[tech]} kernel launches, makespan {res.schedule.makespan:.4f}, history "
              f"{res.history[0]:.2f} -> {res.history[-1]:.2f}, kernel == plain bit for bit; warm run "
              f"{warm_ms:.2f} ms wall ({prof['wall_ms']:.2f} ms under the profiler), device busy "
              f"{prof['device_busy_ms']:.2f} ms, makespan kernel {kernel['ms']:.2f} ms ({kernel['count']} "
              f"device kernels), host share {1 - prof['device_busy_ms'] / warm_ms:.3f} "
              f"({prof['device_idle_share']:.3f} under the profiler)", flush=True)
    for fn in (heft, olb):
        t0 = time.perf_counter()
        sched = fn(problem)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        check(verify_schedule(problem, sched) == [], f"{fn.__name__} schedule is valid")
        profiles[fn.__name__] = {"wall_ms": wall_ms, "makespan": sched.makespan}
        print(f"{fn.__name__} 500x500: {wall_ms:.2f} ms wall on the host, makespan {sched.makespan:.4f} "
              f"(GA {ga_result.schedule.makespan:.4f})", flush=True)
    print(json.dumps({"mh_profile": profiles}), flush=True)
    return out


def scenario_phase(table9_main, family) -> dict[str, int]:
    """Phase 13: scenarios through the CLI in a child process and through
    the API in this one.  Returns the makespan kernel's launches by path."""
    import tempfile

    from repro_torch.core import (
        api,
        mri_system,
        mri_workload,
        synthetic_system,
        synthetic_workload,
        verify_schedule,
    )
    from repro_torch.kernels.makespan import population_makespan_cuda

    mri = api.Scenario(name="mri", system=mri_system(), workload=mri_workload(), technique="auto")
    table9 = api.Scenario(name="table9-500x500", system=synthetic_system(500, seed=500),
                          workload=synthetic_workload(500, seed=500), technique="auto")
    src = Path(__file__).resolve().parent / "src"
    summaries = {}
    with tempfile.TemporaryDirectory() as tmp:
        for sc in (mri, table9):
            path, out = Path(tmp) / f"{sc.name}.json", Path(tmp) / f"{sc.name}.out.json"
            sc.save(path)
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "repro_torch", "run", str(path), "--out", str(out)],
                                  env={**os.environ, "PYTHONPATH": str(src)},
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"python -m repro_torch run {sc.name}: exit {proc.returncode}\n"
                  f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            summaries[sc.name] = json.loads(out.read_text())
            print(f"cli run {sc.name}: exit 0 in {time.perf_counter() - t0:.2f} s, technique "
                  f"{summaries[sc.name]['technique']}, makespan {summaries[sc.name]['predicted_makespan']!r}",
                  flush=True)
    s = summaries["mri"]
    check(s["technique"] == "milp[event]", "the policy routes MRI to the MILP")
    check(abs(s["predicted_makespan"] - 10.0) <= np.spacing(10.0), "MILP's MRI makespan is 10 s")
    s = summaries["table9-500x500"]
    check(s["technique"] == "ga" and s["rounds"] == 1, "the policy routes Table IX to the GA, one round")
    check(s["observed_makespan"] == s["predicted_makespan"], "the GA schedule executed as predicted")

    out: dict[str, int] = {}
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    result = api.run_scenario(table9, device="cuda")
    torch.cuda.synchronize()
    out["scenario_ga"] = population_makespan_cuda.launches
    check(out["scenario_ga"] == GA["generations"] + 1, f"run_scenario made {out['scenario_ga']} launches")
    check(verify_schedule(table9_main, result.final_schedule) == [], "the scenario's GA schedule is valid")
    print(f"run_scenario table9-500x500: {time.perf_counter() - t0:.3f} s wall, {out['scenario_ga']} "
          f"kernel launches, makespan {result.final_schedule.makespan:.4f}", flush=True)

    # the fallback chain keeps the GA on the kernel: no step degrades to HEFT
    population_makespan_cuda.launches = 0
    rep = api.solve_with_fallback(table9_main, technique="ga", chain=("heft",), device="cuda")
    torch.cuda.synchronize()
    out["fallback_ga"] = population_makespan_cuda.launches
    check(rep.schedule.technique == "ga" and rep.fallbacks == (),
          f"solve_with_fallback resolved to {rep.schedule.technique} after {rep.fallbacks}")
    check(out["fallback_ga"] == GA["generations"] + 1, f"solve_with_fallback made {out['fallback_ga']} launches")
    check(verify_schedule(table9_main, rep.schedule) == [], "the fallback chain's GA schedule is valid")

    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    reports = api.solve_problems(family, "ga", device="cuda", seed=0, **GA)
    torch.cuda.synchronize()
    out["solve_problems"] = population_makespan_cuda.launches
    check(out["solve_problems"] == GA["generations"] + 1,
          f"solve_problems made {out['solve_problems']} launches, expected one batched launch a generation")
    for problem, rep in zip(family, reports):
        check(verify_schedule(problem, rep.schedule) == [], "solve_problems schedule is valid")
    print(f"solve_problems ga {len(family)}x(500x500): {time.perf_counter() - t0:.3f} s wall, "
          f"{out['solve_problems']} kernel launches", flush=True)

    drift = mri.replace(name="mri-n2-slow", perturbation=api.Perturbation(speed_factors={"N2": 0.4}))
    summary = api.run_scenario(drift, device="cuda").summary()
    check(summary["adapted"], "the slow node triggers a re-solve")
    print(json.dumps({"drift_run": summary}), flush=True)
    return out


#: the service's chaos lane (the reference's ``chaos_campaign``) and its
#: converging/fixed cycling streams (``_CYCLING_STREAMS``, pinned replay)
SERVICE_CHAOS = {
    "trace": {"num_submissions": 120, "seed": 0, "rate": 4.0, "burst_prob": 0.15, "burst_size": 8,
              "chaos": {"horizon": 1200.0, "failure_rate": 0.004, "outage_mean": 60.0, "drift_rate": 0.01,
                        "drift_range": [0.4, 1.6]}},
    "config": {"batch_window": 0.5, "max_batch": 32, "seed": 0, "max_retries": 4, "backoff_base": 0.5,
               "backoff_cap": 30.0, "fallback": ("ga", "heft")},
}
CYCLING_STREAMS = (
    ("s-meet", "mri-w1", {"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3},
                          "period": 5.0, "cycle_deadline": 12.0}),
    ("s-miss", "mri-w2", {"converge": {"prob": 0.5, "min_cycles": 2, "max_cycles": 6, "seed": 3},
                          "period": 5.0, "cycle_deadline": 8.0}),
    ("s-fixed", "mri-w1", {"cycles": 3, "period": 5.0}),
)
CYCLING_FINGERPRINT = "820bbd5dcab25e9a644031ba39cdcd0ed4e0e34b33bf20c0e3c0d8844d2d15cb"


def strict_json(text: str):
    """``json.loads`` that refuses bare NaN and Infinity."""
    def refuse(token):
        raise ValueError(f"bare {token} in the output")

    return json.loads(text, parse_constant=refuse)


class GACalls:
    """Count the GA calls of a block, singly (``ga``) and batched
    (``ga_sweep``), each with its generations: a call on the card launches
    the makespan kernel generations + 1 times."""

    def __enter__(self) -> "GACalls":
        from repro_torch.core import metaheuristics as mh

        self.mh, self.calls = mh, []
        self._ga, self._sweep = mh.TECHNIQUES["ga"], mh.ga_sweep

        def ga(problem, *a, **kw):
            self.calls.append(("single", kw.get("generations", 60)))
            return self._ga(problem, *a, **kw)

        def ga_sweep(problems, *a, **kw):
            self.calls.append(("batch", kw.get("generations", 60)))
            return self._sweep(problems, *a, **kw)

        mh.TECHNIQUES["ga"], mh.ga_sweep = ga, ga_sweep
        return self

    def __exit__(self, *exc) -> bool:
        self.mh.TECHNIQUES["ga"], self.mh.ga_sweep = self._ga, self._sweep
        return False

    @property
    def launches(self) -> int:
        return sum(g + 1 for _, g in self.calls)

    def kinds(self) -> dict[str, int]:
        kinds = Counter(k for k, _ in self.calls)
        return {"single": kinds["single"], "batch": kinds["batch"]}

    def __str__(self) -> str:
        kinds = self.kinds()
        return f"GA calls {len(self.calls)} ({kinds['single']} single, {kinds['batch']} batched)"


def service_run_line(name: str, result, launches: int, calls: "GACalls | None" = None) -> str:
    s = result.summary()
    line = (f"service {name}: {s['completed']}/{s['submissions']} completed, {s['rejected']} rejected, "
            f"{s['failed']} failed, {s['events']} events, wall {s['wall_seconds']:.3f} s, "
            f"throughput_per_wall_s {s['throughput_per_wall_s']:.2f}, solver calls {s['solver_calls']}, "
            f"batched groups {s['batched_groups']} ({s['batched_submissions']} submissions), solve cache "
            f"hit rate {s['cache']['hit_rate']:.4f}, pack cache hit rate {s['pack_cache']['hit_rate']:.4f}, "
            f"turnaround p50/p95 {s['turnaround']['p50']:.2f}/{s['turnaround']['p95']:.2f} virtual s, "
            f"kernel launches {launches}")
    if calls is not None:
        line += f" ({calls})"
    return line


def span_breakdown(run, top: int = 10) -> dict:
    """Run ``run()`` with the port's tracer on and split its wall time by
    span name (a solve's by the technique it resolved to), each span's own
    time (its wall time less its children's): where the host spends a
    service run, by the reference's span names."""
    from repro_torch import obs

    obs.TRACER.enable()
    try:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        obs.TRACER.disable()
    own = {s.id: s.wall_dur for s in obs.TRACER.spans}
    for s in obs.TRACER.spans:
        if s.parent is not None:
            own[s.parent] -= s.wall_dur
    by_name: dict[str, list] = {}
    for s in obs.TRACER.spans:
        # a solve's span by the technique it resolved to (GA, MILP, HEFT)
        name = f"{s.name}[{s.args['resolved']}]" if "resolved" in s.args else s.name
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += 1e3 * own[s.id]
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_ms, "spans": len(obs.TRACER.spans),
            "own_ms": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in rows]}


def serve_kernel_and_plain(trace, config, name: str):
    """Serve ``trace`` on the card with the kernel (``engine="auto"``) and
    with the plain version (``engine="torch"``, the same draws), counting
    the GA calls.  Both must give one fingerprint of events and records
    (degraded records and their trails included); the kernel run must make
    exactly (generations + 1) launches a GA call, the plain run none.
    Returns the kernel run's result, its launches and its GA calls."""
    from repro_torch.core import canonical_hash
    from repro_torch.kernels.makespan import population_makespan_cuda
    from repro_torch.service import serve_trace
    from repro_torch.service.traces import GA_OPTIONS

    per_ga = GA_OPTIONS["generations"] + 1
    runs = {}
    for engine in ("auto", "torch"):
        population_makespan_cuda.launches = 0
        with GACalls() as calls:
            result = serve_trace(trace, config=config, device="cuda", engine=engine)
            torch.cuda.synchronize()
        n = population_makespan_cuda.launches
        strict_json(json.dumps(result.summary()))
        if engine == "auto":
            want = per_ga * len(calls.calls)
            check(n == want == calls.launches, f"service {name}: {n} kernel launches, expected {per_ga} x "
                  f"{len(calls.calls)} = {want}")
        else:
            check(n == 0, f"service {name}: the plain-version run launched the kernel {n} times")
        print(service_run_line(f"{name} engine={engine}", result, n, calls), flush=True)
        fp = canonical_hash({"events": result.event_log, "records": [r.to_json() for r in result.records]})
        runs[engine] = (result, n, calls.kinds(), fp)
    check(runs["auto"][3] == runs["torch"][3], f"service {name}: kernel and plain version serve the same "
          f"events and records ({runs['auto'][3]} against {runs['torch'][3]})")
    print(f"service {name}: kernel and plain version give one fingerprint {runs['auto'][3]}", flush=True)
    return runs["auto"][:3]


def service_phase() -> tuple[dict[str, int], dict]:
    """Phase 14: the scheduling service on the card.  The reference's
    documented 200-submission trace through ``python -m repro_torch serve``
    (no ``--device``), then in this process with the kernel and with the
    plain version (the same draws: equal event logs and records), launches
    counted against the GA calls, profiled and traced (host time by span);
    the chaos lane, with the kernel and with the plain version; the cycling
    streams' pinned replay; the kernel against its plain version at the service's
    shapes (CMAX 512).  Returns the launches by path and the kernel's
    service-shape readings."""
    import tempfile

    from repro_torch.core import Workload, build_problem, canonical_hash, mri_w1, mri_w2
    from repro_torch.core.workload_model import stgs_workflows
    from repro_torch.cycling import cycle_spec_from_json
    from repro_torch.engine import pack, stack_packed
    from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref
    from repro_torch.service import (
        ServiceConfig,
        Submission,
        Trace,
        continuum_system,
        generate_trace,
        serve_trace,
    )
    from repro_torch.service.traces import GA_OPTIONS

    trace = generate_trace(200, seed=0, node_events=True)
    src = Path(__file__).resolve().parent / "src"
    with tempfile.TemporaryDirectory() as tmp:
        path, out = Path(tmp) / "trace.json", Path(tmp) / "result.json"
        trace.save(path)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch", "serve", str(path), "--out", str(out)],
                              env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True, text=True,
                              timeout=600)
        check(proc.returncode == 0, f"python -m repro_torch serve: exit {proc.returncode}\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        cli = strict_json(out.read_text())
        check(strict_json(proc.stdout) == cli, "the CLI printed the summary it wrote")
    check(cli["completed"] == cli["submissions"] == 200 and cli["rejected"] == 0,
          f"the CLI served {cli['completed']} of {cli['submissions']}, rejected {cli['rejected']}")
    print(f"cli serve 200 (node events): exit 0 in {time.perf_counter() - t0:.2f} s, "
          f"{cli['completed']}/{cli['submissions']} completed, wall {cli['wall_seconds']:.3f} s, "
          f"throughput_per_wall_s {cli['throughput_per_wall_s']:.2f}, batched groups {cli['batched_groups']}",
          flush=True)

    launches: dict[str, int] = {}
    result, launches["service_200"], ga_calls = serve_kernel_and_plain(trace, ServiceConfig(), "200 (node events)")
    s = result.summary()
    check(s["completed"] == s["submissions"] == 200 and s["rejected"] == 0,
          f"{s['completed']} of 200 completed, {s['rejected']} rejected")
    check(s["batched_groups"] > 0, "some GA admissions batch")
    check(not any(r.fallbacks for r in result.records), "no record degraded")

    population_makespan_cuda.launches = 0
    profile = device_time_breakdown(lambda: serve_trace(trace, device="cuda"), classify=makespan_class)
    check(population_makespan_cuda.launches == launches["service_200"], "the profiled run launches as the first")
    kernel = profile.get("by_class", {}).get("makespan kernel", {"count": 0, "ms": 0.0})
    print(json.dumps({"service_profile": profile}), flush=True)
    print(f"service 200 under the profiler: wall {profile['wall_ms']:.2f} ms, device busy "
          f"{profile['device_busy_ms']:.2f} ms, idle share {profile['device_idle_share']:.4f}, makespan kernel "
          f"{kernel['ms']:.3f} ms ({kernel['count']} device kernels)", flush=True)

    spans = span_breakdown(lambda: serve_trace(trace, device="cuda"))
    print(json.dumps({"service_spans": spans}), flush=True)

    chaos = generate_trace(**SERVICE_CHAOS["trace"])
    result, launches["service_chaos"], _ = serve_kernel_and_plain(
        chaos, ServiceConfig(**SERVICE_CHAOS["config"]), "chaos 120")
    s = result.summary()
    check(s["completed"] + s["rejected"] + s["failed"] == s["submissions"] == 120, "every chaos record ends")
    check(all(r.status == "completed" or r.reason for r in result.records), "no chaos record ends silently")
    check(launches["service_chaos"] > 0, "the chaos lane runs GA admissions on the kernel")
    # the chain ga -> heft may degrade a GA schedule that is invalid while
    # nodes are down; a GA step that raised on the card is a fault
    degraded = {r.id: r.fallbacks for r in result.records if r.fallbacks}
    print(f"service chaos 120: {len(degraded)} records degraded, trails {json.dumps(degraded)}; "
          f"robustness {json.dumps(s['robustness'])}", flush=True)
    raised = [f for trail in degraded.values() for f in trail
              if f.startswith("ga:") and not re.fullmatch(r"ga:violations=\d+", f)]
    check(not raised, f"a GA step raised on the card: {raised}")

    wfs = {"mri-w1": mri_w1(), "mri-w2": mri_w2()}
    streams = Trace(name="cycling", system=continuum_system(), submissions=tuple(
        Submission(id=sid, tenant="t0", time=float(i), family=fam, workflow=wfs[fam], technique="heft",
                   cycling=cycle_spec_from_json(dict(spec)))
        for i, (sid, fam, spec) in enumerate(CYCLING_STREAMS)))
    result = serve_trace(streams, config=ServiceConfig(seed=0), device="cuda")
    fp = canonical_hash({"events": result.event_log, "records": [r.to_json() for r in result.records]})
    check(fp == CYCLING_FINGERPRINT, f"the cycling streams replay to {fp}, pinned {CYCLING_FINGERPRINT}")
    print(f"service cycling streams: {len(result.records)} submissions, {json.dumps(result.cycling)}, "
          f"fingerprint == pinned {fp}", flush=True)

    # the kernel at the service's shapes: an STGS workflow on the continuum
    # (N3's 2,572 cores cap CMAX at 512: 16 slots a lane), P 16, exact shape
    # (a single GA) and the bucket of a batched group
    system = continuum_system()
    stgs = [build_problem(system, Workload((wf,))) for wf in stgs_workflows().values()]
    dev = torch.device("cuda")
    record = {}
    P = GA_OPTIONS["pop_size"]
    packed = pack(stgs[0], pad=False)
    arrays = packed.device_arrays(dev)
    kw = {k: arrays[k] for k in KEYS}
    kw["deadline"] = None
    check(kw["init_free"].shape[-1] == 512, f"CMAX {kw['init_free'].shape[-1]} at the service's shapes")
    A = torch.from_numpy(random_assignments(stgs[0], P, seed=14)).to(dev)
    stacked, bucket = stack_packed(stgs, device=dev)
    kw_b = {k: stacked[k] for k in KEYS}
    kw_b["deadline"] = None
    A_b = torch.zeros(len(stgs), P, bucket[0], dtype=torch.int32)
    for b, problem in enumerate(stgs):
        A_b[b, :, : problem.num_tasks] = torch.from_numpy(random_assignments(problem, P, seed=20 + b))
    A_b = A_b.to(dev)
    max_err = 0.0
    for name, a, k in (("single", A, kw), ("batch", A_b, kw_b)):
        mk_k, v_k = population_makespan_cuda(a, **k)
        mk_p, v_p = population_makespan_ref(a, **k)
        torch.cuda.synchronize()
        check(same_bits(mk_k, mk_p) and same_bits(v_k, v_p), f"service {name}: kernel == plain version, bit for bit")
        max_err = max(max_err, float((mk_k - mk_p).abs().max()), float((v_k - v_p).abs().max()))
        ms = cuda_ms(lambda: population_makespan_cuda(a, **k), reps=50)
        plain = cuda_ms(lambda: population_makespan_ref(a, **k), reps=3, warmup=1)
        bound, by, nbytes, ops = makespan_bound_ms(a, k)
        record[f"service_{name}"] = {"shape": list(a.shape), "cmax": int(k["init_free"].shape[-1]), "ms": ms,
                                     "plain_ms": plain, "bound_ms": bound, "bound_by": by}
        print(f"makespan service {name} {list(a.shape)} CMAX {k['init_free'].shape[-1]}: kernel == plain bit for "
              f"bit; kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.6f} ms ({by}: {nbytes} B, {ops} ops)",
              flush=True)
    record["service_max_abs_err"] = max_err
    record["service_ga_calls"] = ga_calls
    record["service_device"] = {"wall_ms": profile["wall_ms"], "device_busy_ms": profile["device_busy_ms"],
                                "device_idle_share": profile["device_idle_share"], "makespan_kernel_ms": kernel["ms"],
                                "traced_wall_ms": spans["wall_ms"]}
    return launches, record


TABLE9_GRID = Path(__file__).resolve().parent / "examples" / "campaign_table9.json"
#: the Table IX 500 x 500 campaign: 8 seeds x HEFT, OLB and the GA at its
#: defaults, the 8 GA cells one batched group
TABLE9_500 = {"name": "table9-500", "runner": "inline",
              "axes": [{"name": "scale", "zip": True, "values": [{"size": 500, "nodes": 500}]},
                       {"name": "seed", "values": list(range(8))},
                       {"name": "technique", "values": ["heft", "olb", "ga"]}],
              "defaults": {"family": "synthetic", "engine": "auto",
                           "solver_options": {"ga": {"seed": 0, "pop_size": 64, "generations": 60}}}}
#: the campaign lanes' kernel shapes held against the plain version: the
#: smoke lane's two scale points and the engine lane's three buckets
#: (label, system nodes, workload builder, population)
CAMPAIGN_SHAPES = (
    ("smoke 5x5", 5, ("synthetic", 5), 32),
    ("smoke 50x50", 50, ("synthetic", 50), 32),
    ("engine small", 4, ("layered", 24), 64),
    ("engine medium", 8, ("layered", 96), 64),
    ("engine large", 16, ("layered", 384), 32),
)


class CapturedServes:
    """Keep every ``ServiceResult`` that ``serve_trace`` returns in a block
    (the trace runner calls it through the package)."""

    def __enter__(self) -> "CapturedServes":
        import repro_torch.service as service

        self.service, self.results = service, []
        self._serve = service.serve_trace

        def serve(*a, **kw):
            result = self._serve(*a, **kw)
            self.results.append(result)
            return result

        service.serve_trace = serve
        return self

    def __exit__(self, *exc) -> bool:
        self.service.serve_trace = self._serve
        return False


def campaign_fingerprint(rs) -> str:
    """Hash of a campaign ResultSet's deterministic part: its rows without
    the wall-clock columns (``wall_us``, the solver's ``solve_time_s``), its
    stats without ``wall_seconds``, and its gap report against MILP."""
    from repro_torch.core import canonical_hash

    stats = {k: v for k, v in rs.meta.get("stats", {}).items() if k != "wall_seconds"}
    if "summary" in stats:
        stats["summary"] = {k: v for k, v in stats["summary"].items()
                            if k not in ("wall_seconds", "throughput_per_wall_s", "pack_cache")}
    rows = [{k: v for k, v in r.items() if k not in ("wall_us", "solve_time_s")} for r in rs]
    report = rs.deviation_report("milp").to_csv() if rs.baseline_present("milp") else ""
    return canonical_hash({"rows": rows, "stats": stats, "report": report})


def recording_registry():
    """A copy of the solver registry that keeps every report it returns, so
    each row's schedule can be checked against its problem."""
    from repro_torch.core import api

    reports = []
    reg = api.SolverRegistry()
    for e in api.REGISTRY:
        def fn(problem, weights=api.ObjectiveWeights(), _fn=e.fn, **kw):
            rep = _fn(problem, weights, **kw)
            reports.append(rep)
            return rep

        batch_fn = None
        if e.batch_fn is not None:
            def batch_fn(problems, weights=api.ObjectiveWeights(), _fn=e.batch_fn, **kw):
                reps = _fn(problems, weights, **kw)
                reports.extend(reps or ())
                return reps
        caps = e.capabilities
        reg.register(e.name, fn, batch_fn=batch_fn, exact=caps.exact, max_tasks=caps.max_tasks,
                     needs_time_limit=caps.needs_time_limit, engine_aware=caps.engine_aware,
                     constraint_aware=caps.constraint_aware)
    return reg, reports


def fitness_from_metrics(flat: dict) -> dict[str, dict]:
    """The ``engine_fitness`` table out of a flat ``--trace`` metrics file."""
    table: dict[str, dict] = {}
    for k, v in flat.items():
        if k.startswith("engine_fitness."):
            key, field = k[len("engine_fitness."):].rsplit(".", 1)
            table.setdefault(key, {})[field] = v
    return table


def campaign_phase() -> tuple[dict[str, int], dict]:
    """Phase 15: campaigns on the card.  The documented Table IX grid
    through ``python -m repro_torch campaign run`` (no ``--device``) with a
    trace read back by ``python -m repro_torch obs``; the same grid in this
    process with the kernel and with the plain version (equal results);
    the Table IX 500 x 500 campaign (its 8 GA cells one ``ga_sweep``); the
    reference's lanes through their exporters into a temporary directory;
    the kernel against its plain version at the lanes' shapes; the tracing
    overhead on the smoke lane.  Returns the launches by path and the
    kernel's readings at the lanes' shapes."""
    import tempfile

    from repro_torch import obs
    from repro_torch.campaigns import ResultSet, builtin, campaign_from_json, load_campaign, run_campaign
    from repro_torch.core import (
        Workload,
        build_problem,
        canonical_hash,
        random_layered_workflow,
        synthetic_system,
        synthetic_workload,
        verify_schedule,
    )
    from repro_torch.engine import backends, pack, pack_cache
    from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref

    repo = Path(__file__).resolve().parent
    src = repo / "src"
    bench_before = {p.name: p.read_bytes() for p in repo.glob("BENCH_*.json")}
    launches: dict[str, int] = {"campaign_lanes": 0}
    record: dict = {}
    tmp = Path(tempfile.mkdtemp(prefix="campaigns-"))
    try:
        # the documented grid through the CLI, on the card by default
        cli = {"out": tmp / "t9.json", "csv": tmp / "t9.csv", "trace": tmp / "t9.trace.json"}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch", "campaign", "run", str(TABLE9_GRID), "--vs", "milp",
             *(a for k, p in cli.items() for a in (f"--{k}", str(p)))],
            env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True, text=True, timeout=600)
        cli_wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m repro_torch campaign run: exit {proc.returncode}\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        rs = ResultSet.load(cli["out"])
        milp = rs.select(technique="milp")
        check(len(rs) == 48, f"the grid gave {len(rs)} rows, expected 48")
        check(len(milp) == 12 and all(r["status"] == "ok" for r in milp), "12 MILP rows ok")
        check(all(r["status"] == "ok" for r in rs), "every cell of the grid solved")
        ga_rows = rs.select(technique="ga")
        ga_calls = sum(1 for r in ga_rows if not r["batched"]) + round(
            sum(1 / r["group_size"] for r in ga_rows if r["batched"]))
        report = proc.stdout.partition("# deviation vs milp (makespan):\n")[2]
        check(report.startswith("technique,gap_pct_mean"), "the CLI printed its gap report")
        print(f"cli campaign table9 grid: exit 0 in {cli_wall:.2f} s, {len(rs)} rows, 12 MILP rows ok, "
              f"GA calls {ga_calls} ({rs.meta['stats']['batched_groups']} batched groups), stats "
              f"{json.dumps({k: v for k, v in rs.meta['stats'].items() if k != 'cache'})}", flush=True)
        print("cli campaign table9 gap report vs milp:\n" + report.rstrip(), flush=True)

        proc = subprocess.run([sys.executable, "-m", "repro_torch", "obs", str(cli["trace"]), "--json"],
                              env={**os.environ, "PYTHONPATH": str(src)}, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0, f"python -m repro_torch obs: exit {proc.returncode}\n{proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout)
        names = Counter(e["name"] for e in json.loads(cli["trace"].read_text())["traceEvents"] if e["ph"] == "X")
        counts = {n: names[n] for n in ("campaign.cell", "campaign.batch", "mh.ga_sweep", "engine.pack")}
        check(counts["mh.ga_sweep"] == counts["campaign.batch"] == rs.meta["stats"]["batched_groups"],
              "one mh.ga_sweep span a batched group")
        print(f"cli obs: valid trace, {summary['events']} events, categories "
              f"{json.dumps(summary['categories'])}, spans {json.dumps(counts)}", flush=True)
        table = fitness_from_metrics(json.loads(cli["trace"].with_suffix(".metrics.json").read_text()))
        for key, rec in table.items():
            print(f"  engine_fitness {key}: calls {rec['calls']}, compiles {rec['compiles']}, compile_us "
                  f"{rec['compile_us']:.1f}, execute_us_mean {rec['execute_us_mean']:.1f}")
        cli_launches = sum(rec["calls"] for key, rec in table.items() if key.split("|")[0] in ("cuda", "cuda-batch"))
        check(cli_launches == 13 * ga_calls, f"the CLI's cuda fitness calls {cli_launches} == 13 x {ga_calls}")
        print(f"cli campaign table9 grid: {cli_launches} makespan kernel launches (cuda fitness calls) "
              f"= 13 x {ga_calls} GA calls", flush=True)

        # the same grid in this process: kernel, plain version, profiled kernel
        grid = load_campaign(TABLE9_GRID)
        runs = {}
        for engine, fn in (("cuda", population_makespan_cuda), ("plain", population_makespan_ref)):
            pack_cache().clear()
            kept = backends.CudaEngine.makespan_fn
            backends.CudaEngine.makespan_fn = staticmethod(fn)
            population_makespan_cuda.launches = 0
            try:
                with GACalls() as calls:
                    t0 = time.perf_counter()
                    grid_rs = run_campaign(grid, device="cuda")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                backends.CudaEngine.makespan_fn = kept
            n = population_makespan_cuda.launches
            check(n == (calls.launches if engine == "cuda" else 0), f"grid {engine}: {n} launches, {calls}")
            runs[engine] = (campaign_fingerprint(grid_rs), grid_rs)
            print(f"campaign table9 grid engine={engine}: wall {wall:.3f} s, {calls}, launches {n}, "
                  f"fingerprint {runs[engine][0]}", flush=True)
            if engine == "cuda":
                launches["campaign_grid"] = n
        check(runs["cuda"][0] == runs["plain"][0], "grid: kernel and plain version give equal rows, stats and "
              "gap report")
        check(runs["cuda"][1].deviation_report("milp").to_csv() == report,
              "grid: the in-process gap report equals the CLI's")
        print("campaign table9 grid: kernel == plain version in every row, the stats and the gap report", flush=True)
        # one more run, traced under the profiler: the device's idle share
        # and the host's time by span (``campaign.run``'s own time is the
        # cells' expansion and problem building)
        spans: dict = {}
        grid_profile = device_time_breakdown(
            lambda: spans.update(span_breakdown(lambda: run_campaign(grid, device="cuda"))), classify=makespan_class)
        kernel = grid_profile.get("by_class", {}).get("makespan kernel", {"count": 0, "ms": 0.0})
        print(f"campaign table9 grid traced under the profiler: wall {grid_profile['wall_ms']:.2f} ms, device busy "
              f"{grid_profile['device_busy_ms']:.2f} ms, idle share {grid_profile['device_idle_share']:.4f}, "
              f"makespan kernel {kernel['ms']:.3f} ms ({kernel['count']} device kernels)", flush=True)
        print(json.dumps({"campaign_grid_spans": spans}), flush=True)

        # the paper's scale: Table IX 500 x 500, 8 seeds
        c500 = campaign_from_json({"campaign": TABLE9_500})
        reg, reports = recording_registry()
        population_makespan_cuda.launches = 0
        with GACalls() as calls:
            t0 = time.perf_counter()
            rs500 = run_campaign(c500, registry=reg, device="cuda")
            torch.cuda.synchronize()
            wall500 = time.perf_counter() - t0
        n = launches["campaign_table9_500"] = population_makespan_cuda.launches
        stats = rs500.meta["stats"]
        check(len(rs500) == 24 and all(r["status"] == "ok" for r in rs500), "24 rows solved")
        check(calls.calls == [("batch", 60)] and n == 61, f"the 8 GA cells are one ga_sweep: {calls}, {n} launches")
        check(stats["batched_groups"] == 1 and stats["batched_submissions"] == 8, "one batched group of 8")
        check(len(reports) == 24, f"{len(reports)} reports kept")
        for rep in reports:
            bad = verify_schedule(rep.problem, rep.schedule)
            check(not bad and rep.schedule.violations == 0, f"a Table IX 500 schedule is invalid: {bad[:3]}")
        bucket = "x".join(str(d) for d in pack(reports[-1].problem).bucket)
        spans500: dict = {}
        prof500 = device_time_breakdown(
            lambda: spans500.update(span_breakdown(lambda: run_campaign(c500, device="cuda"))),
            classify=makespan_class)
        kernel = prof500.get("by_class", {}).get("makespan kernel", {"count": 0, "ms": 0.0})
        print(f"campaign table9 500x500: 24 rows valid, wall {wall500:.3f} s, {calls} in bucket {bucket}, launches "
              f"{n}; traced under the profiler wall {prof500['wall_ms']:.2f} ms, device busy "
              f"{prof500['device_busy_ms']:.2f} ms, idle share {prof500['device_idle_share']:.4f}, makespan kernel "
              f"{kernel['ms']:.3f} ms", flush=True)
        print(json.dumps({"campaign_table9_500_spans": spans500}), flush=True)
        print("campaign table9 500x500 gap report vs heft:\n" + rs500.deviation_report("heft").to_csv().rstrip(),
              flush=True)

        # the reference's lanes through their exporters, into the temporary directory
        lanes = {
            "smoke": lambda: builtin.run_smoke(tmp / "BENCH_table9.json"),
            "cycling": lambda: builtin.run_cycling_bench(tmp / "BENCH_cycling.json"),
            "engine": lambda: builtin.run_engine_bench_export(tmp / "BENCH_engine.json"),
            "service": lambda: builtin.run_service_bench(out_path=tmp / "BENCH_service.json"),
            "chaos": lambda: builtin.run_chaos_bench(out_path=tmp / "BENCH_chaos.json"),
        }
        lane_record = {}
        for name, export in lanes.items():
            if name == "engine":
                obs.FITNESS.reset()  # the table then holds this lane's calls alone
            population_makespan_cuda.launches = 0
            with GACalls() as calls, CapturedServes() as serves:
                t0 = time.perf_counter()
                rows = export()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n = population_makespan_cuda.launches
            launches["campaign_lanes"] += n
            payload = strict_json((tmp / f"BENCH_{'table9' if name == 'smoke' else name}.json").read_text())
            if name == "engine":
                # 3 cuda rows and 2 families, each 1 warm-up + 3 timed calls
                check(n == 20 and not calls.calls, f"engine lane: {n} launches, expected 20")
            else:
                check(n == calls.launches and n > 0, f"{name} lane: {n} launches, {calls}")
            line = f"campaign lane {name}: wall {wall:.3f} s, {len(rows)} rows, {calls}, launches {n}"
            if serves.results:
                (result,) = serves.results
                s = result.summary()
                degraded = [r.id for r in result.records if r.fallbacks]
                check(not degraded, f"{name} lane: records degraded {degraded}")
                line += (f", {s['completed']}/{s['submissions']} completed, solver calls {s['solver_calls']}, "
                         f"batched groups {s['batched_groups']}, 0 degraded")
                lane_record[name] = canonical_hash(
                    {"events": result.event_log, "records": [r.to_json() for r in result.records]})
            print(line, flush=True)
            if name == "engine":
                for r in rows:
                    print(f"  {r[0]}: {r[1]:.1f} us/call, {r[2]}")
                fitness = payload["telemetry"]["engine_fitness"]
                engine_rows = {k: v for k, v in payload.items() if k.startswith("engine_") and k.endswith("_cuda")}

        # repeated service and chaos lanes, traced: one fingerprint each
        for name, campaign in (("service", builtin.service_campaign()), ("chaos", builtin.chaos_campaign())):
            fps = []
            for _ in range(2):
                obs.TRACER.enable()
                try:
                    with CapturedServes() as serves:
                        population_makespan_cuda.launches = 0
                        run_campaign(campaign, device="cuda")
                        torch.cuda.synchronize()
                        launches["campaign_lanes"] += population_makespan_cuda.launches
                finally:
                    obs.TRACER.disable()
                (result,) = serves.results
                fps.append((canonical_hash({"events": result.event_log,
                                            "records": [r.to_json() for r in result.records]}),
                            obs.virtual_fingerprint()))
            check(fps[0] == fps[1] and fps[0][0] == lane_record[name],
                  f"{name} lane: the exporter's run and two traced runs give one fingerprint: {fps}, "
                  f"{lane_record[name]}")
            print(f"campaign lane {name}: exporter run and two traced runs give fingerprint {fps[0][0]}, "
                  f"virtual_fingerprint {fps[0][1]}", flush=True)

        # the kernel against its plain version at the lanes' shapes
        dev = torch.device("cuda")
        max_err = 0.0
        for label, nodes, (family, tasks), P in CAMPAIGN_SHAPES:
            system = synthetic_system(nodes, seed=nodes)
            workload = (synthetic_workload(tasks, seed=tasks) if family == "synthetic" else Workload(
                (random_layered_workflow(tasks, seed=tasks, max_cores=8, feature_pool=("F1",)),)))
            problem = build_problem(system, workload)
            kw = problem_kw(problem, dev)
            A = torch.from_numpy(random_assignments(problem, P, seed=15)).to(dev)
            mk_k, v_k = population_makespan_cuda(A, **kw)
            mk_p, v_p = population_makespan_ref(A, **kw)
            torch.cuda.synchronize()
            check(same_bits(mk_k, mk_p) and same_bits(v_k, v_p), f"campaign {label}: kernel == plain, bit for bit")
            max_err = max(max_err, float((mk_k - mk_p).abs().max()), float((v_k - v_p).abs().max()))
            ms = cuda_ms(lambda: population_makespan_cuda(A, **kw), reps=50)
            plain = cuda_ms(lambda: population_makespan_ref(A, **kw), reps=3, warmup=1)
            bound, by, nbytes, ops = makespan_bound_ms(A, kw)
            key = "x".join(str(d) for d in pack(problem, pad=False).bucket)
            entry = {"shape": [P, problem.num_tasks, problem.num_nodes], "cmax": int(kw["init_free"].shape[-1]),
                     "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by}
            line = (f"makespan campaign {label} {entry['shape']} CMAX {entry['cmax']}: kernel == plain bit for bit; "
                    f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.6f} ms ({by}: {nbytes} B, {ops} ops)")
            if label.startswith("engine"):
                row = engine_rows[f"engine_{label.split()[1]}_cuda"]
                fit = fitness[f"cuda|{key}|fixed"]
                entry.update(lane_us_per_call=row["us_per_call"], fitness_execute_us_mean=fit["execute_us_mean"])
                line += (f"; the engine lane's cuda row {row['us_per_call']:.1f} us/call (host-timed, synchronized), "
                         f"FITNESS execute_us_mean {fit['execute_us_mean']:.1f} us (host time, not synchronized)")
            record[f"campaign_{label.replace(' ', '_')}"] = entry
            print(line, flush=True)
        record["campaign_max_abs_err"] = max_err

        # tracing overhead on the smoke lane: untraced and traced, twice each
        walls: dict[bool, list] = {False: [], True: []}
        fps = set()
        for traced in (False, True, False, True):
            if traced:
                obs.TRACER.enable()
            try:
                population_makespan_cuda.launches = 0
                t0 = time.perf_counter()
                smoke_rs = run_campaign(builtin.smoke_campaign(), device="cuda")
                torch.cuda.synchronize()
                walls[traced].append(time.perf_counter() - t0)
                launches["campaign_lanes"] += population_makespan_cuda.launches
            finally:
                obs.TRACER.disable()
            fps.add(campaign_fingerprint(smoke_rs))
        check(len(fps) == 1, "the traced smoke runs give the untraced rows")
        ratio = statistics.median(walls[True]) / statistics.median(walls[False])
        record["campaign_tracing_ratio"] = ratio
        print(f"campaign smoke tracing overhead: untraced {walls[False]} s, traced {walls[True]} s, ratio of "
              f"medians {ratio:.4f} (the reference gates 5% on its CPU; printed, not gated)", flush=True)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    bench_after = {p.name: p.read_bytes() for p in repo.glob("BENCH_*.json")}
    check(bench_after == bench_before, "no BENCH_*.json of the repository changed")
    record["campaign_device"] = {
        "cli_wall_s": cli_wall, "grid_profile": {k: grid_profile[k] for k in ("wall_ms", "device_busy_ms",
                                                                             "device_idle_share")},
        "table9_500_wall_s": wall500,
        "table9_500_profile": {k: prof500[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")},
    }
    return launches, record


#: phase 16's child: the instance axis striped over virtual stripes on the
#: one card, at the Table IX sweep's shape (8 x 512 x 512 x 64 x 64), and on
#: a host of several cards over the cards themselves (run alone there with
#: ``PYTHONPATH=src python3 -c "import chip_smoke; exec(chip_smoke.STRIPES_CHILD)"``)
STRIPES_CHILD = r"""
import json, os, sys, time
import numpy as np, torch
from repro_torch.campaigns import builtin
from repro_torch.core import build_problem, ga_sweep, synthetic_system, synthetic_workload
from repro_torch.engine import ENGINES, choose_shards, local_device_count, pack_cache
from repro_torch.kernels.makespan import population_makespan_cuda

def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))

problems = [build_problem(synthetic_system(500, seed=s), synthetic_workload(500, seed=s)) for s in range(8)]
rng = np.random.default_rng(16)
out = {}
for k in (2, 8):
    os.environ["REPRO_TORCH_VIRTUAL_DEVICES"] = str(k)
    assert local_device_count("cuda") == k, local_device_count("cuda")
    eng = ENGINES.get("cuda")
    off = eng.batched_fitness(problems, device="cuda", shard="off")
    striped = eng.batched_fitness(problems, device="cuda")  # shard="auto": k stripes
    assert striped.shards == k and off.shards == 1, (striped.shards, off.shards)
    A = np.zeros((8, 64, off.bucket[0]), np.int32)
    for b, p in enumerate(problems):
        A[b, :, :p.num_tasks] = rng.integers(0, p.num_nodes, (64, p.num_tasks))
    A = torch.from_numpy(A).cuda()
    o1, m1 = off(A)
    population_makespan_cuda.launches = 0
    os_, ms_ = striped(A)
    torch.cuda.synchronize()
    n = population_makespan_cuda.launches
    assert n == k, f"{k} stripes made {n} launches in one call"
    assert same_bits(o1, os_) and same_bits(m1, ms_), f"{k} stripes: striped fitness == unsharded, bit for bit"
    stripes = sorted(d for d in pack_cache().device_stats if "/s" in d and d.startswith("cuda"))
    out[k] = {"bucket": list(off.bucket), "launches_per_call": n, "stripes": stripes}
    if k == 8:
        sweeps = {}
        for shard in ("off", 8, 3):
            population_makespan_cuda.launches = 0
            t0 = time.perf_counter()
            res = ga_sweep(problems, device="cuda", seed=0, shard=shard, pop_size=64, generations=60)
            torch.cuda.synchronize()
            sweeps[shard] = (res, time.perf_counter() - t0, population_makespan_cuda.launches)
        base = sweeps["off"][0]
        for shard in (8, 3):
            for a, b in zip(base, sweeps[shard][0]):
                assert np.array_equal(a.schedule.assignment, b.schedule.assignment), shard
                assert np.array_equal(a.history, b.history), shard
        out["sweeps"] = {str(d): {"wall_s": w, "launches": n} for d, (_, w, n) in sweeps.items()}
        out["device_scaling"] = builtin._device_scaling_section(np.random.default_rng(0), "cuda")
cards = torch.cuda.device_count()
if cards > 1:  # a host of several cards: the stripes are the cards themselves
    del os.environ["REPRO_TORCH_VIRTUAL_DEVICES"]
    assert local_device_count("cuda") == cards, local_device_count("cuda")
    d = choose_shards(8, device="cuda")
    striped = eng.batched_fitness(problems, device="cuda")
    assert striped.shards == d > 1, (striped.shards, d)
    striped(A)
    torch.cuda.synchronize()
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    os_, ms_ = striped(A)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    n = population_makespan_cuda.launches
    assert n == d, f"{d} cards made {n} launches in one call"
    assert os_.device == A.device and same_bits(o1, os_) and same_bits(m1, ms_), "cards: striped == unsharded"
    t0 = time.perf_counter()
    off(A)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    sweeps = {}
    for shard in ("off", "auto"):
        population_makespan_cuda.launches = 0
        t0 = time.perf_counter()
        res = ga_sweep(problems, device="cuda", seed=0, shard=shard, pop_size=64, generations=60)
        torch.cuda.synchronize()
        sweeps[shard] = (res, time.perf_counter() - t0, population_makespan_cuda.launches)
    for a, b in zip(sweeps["off"][0], sweeps["auto"][0]):
        assert np.array_equal(a.schedule.assignment, b.schedule.assignment), "cards: sweep"
        assert np.array_equal(a.history, b.history), "cards: sweep history"
    out["cards"] = {
        "count": cards, "shards": d, "launches_per_call": n, "fitness_wall_s": wall_s, "unsharded_wall_s": off_s,
        "stripes": sorted(k for k in pack_cache().device_stats if "/s" not in k and k.startswith("cuda")),
        "sweeps": {str(k): {"wall_s": w, "launches": m} for k, (_, w, m) in sweeps.items()},
        "device_scaling": builtin._device_scaling_section(np.random.default_rng(0), "cuda"),
    }
print("STRIPES " + json.dumps(out))
"""


def shard_topology_phase(sweep_problems) -> tuple[dict[str, int], dict]:
    """Phase 16: the multi-device instance axis and generated continua.
    ``ga_sweep(shard="auto")`` over phase 4's family on the one card equals
    ``shard="off"`` with the same launches; a child process stripes the
    family over 2 and then 8 virtual stripes of the card (striped fitness ==
    unsharded, one launch a stripe; striped sweeps == ``"off"``; the engine
    lane's device-scaling rows); the GA sweep over 8 x 500-task workflows on
    the generated 1008-node ``large`` continuum, its kernel held against the
    plain version at that shape and timed; the topology lane with the twin
    calibration into a temporary directory; the ``topology`` CLI with no
    ``--device``; no ``BENCH_*.json`` changed.  Returns the launches by path
    and the kernel's readings at the ``large`` shape."""
    import tempfile

    from repro_torch.campaigns import builtin
    from repro_torch.core import Workload, build_problem, ga_sweep, random_layered_workflow, verify_schedule
    from repro_torch.engine import local_device_count, stack_packed
    from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref
    from repro_torch.topology import PRESETS, cached_system, tier_slices

    repo = Path(__file__).resolve().parent
    src = repo / "src"
    env = {k: v for k, v in os.environ.items() if k != "REPRO_TORCH_VIRTUAL_DEVICES"}
    env["PYTHONPATH"] = str(src)
    bench_before = {p.name: p.read_bytes() for p in repo.glob("BENCH_*.json")}
    launches: dict[str, int] = {}
    record: dict = {}
    tmp = Path(tempfile.mkdtemp(prefix="topology-"))
    procs: list[subprocess.Popen] = []
    try:
        # the children start first: the topology CLI on the card by default
        # and the virtual stripes; this process's untimed work runs beside
        # them, its timed work after them
        for argv in ([sys.executable, "-m", "repro_torch", "topology", "generate", "large", "--out",
                      str(tmp / "large.json")],
                     [sys.executable, "-m", "repro_torch", "topology", "calibrate", "small"],
                     [sys.executable, "-c", STRIPES_CHILD]):
            procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        cli_gen, cli_cal, stripes = procs

        # one card: shard="auto" is the unsharded path
        check(local_device_count("cuda") == 1, f"one card: local_device_count {local_device_count('cuda')}")
        sweeps = {}
        for shard in ("auto", "off"):
            population_makespan_cuda.launches = 0
            res = ga_sweep(sweep_problems, backend="auto", device="cuda", seed=0, shard=shard, **GA)
            torch.cuda.synchronize()
            sweeps[shard] = (res, population_makespan_cuda.launches)
            launches[f"shard_{shard}_sweep"] = population_makespan_cuda.launches
        for a, b in zip(sweeps["auto"][0], sweeps["off"][0]):
            check(np.array_equal(a.schedule.assignment, b.schedule.assignment) and np.array_equal(a.history, b.history),
                  "ga_sweep(shard='auto') == ga_sweep(shard='off') on one card")
        check(sweeps["auto"][1] == sweeps["off"][1] == GA["generations"] + 1,
              f"auto and off sweeps: {sweeps['auto'][1]} and {sweeps['off'][1]} launches, expected 61 each")
        print(f"shard one card: local_device_count 1, ga_sweep 8x(500x500) shard=auto == shard=off bit for bit, "
              f"{sweeps['auto'][1]} launches each", flush=True)

        # the large continuum: 1008 nodes, 8 x 500-task workflows as the topology lane draws them
        spec = PRESETS["large"]()
        t0 = time.perf_counter()
        large = cached_system(spec)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        problems = [build_problem(large, Workload((random_layered_workflow(
            500, name="W500", seed=s, max_cores=4, feature_pool=("F1",)),))) for s in SWEEP_SEEDS]
        build_s = time.perf_counter() - t0
        tiers = {name: sl.stop - sl.start for name, sl in tier_slices(spec).items()}
        check(large.num_nodes == 1008, f"large preset: {large.num_nodes} nodes")

        for name, proc in (("topology generate large", cli_gen), ("topology calibrate small", cli_cal)):
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"python -m repro_torch {name}: exit {proc.returncode}\n{err[-3000:]}")
            if name.endswith("small"):
                rep = json.loads(out)
                check(rep["twin_error_after"] < rep["twin_error_before"], "CLI calibrate: twin error shrinks")
                print(f"cli {name}: exit 0, {json.dumps(rep)}", flush=True)
            else:
                system = json.loads((tmp / "large.json").read_text())
                check(len(system["nodes"]) == 1008, "CLI generate large: 1008 nodes")
                print(f"cli {name}: exit 0, {len(system['nodes'])} nodes; {err.strip().splitlines()[0]}", flush=True)
        out, err = stripes.communicate(timeout=900)
        check(stripes.returncode == 0, f"virtual stripes child: exit {stripes.returncode}\n{out[-2000:]}\n{err[-4000:]}")
        child = json.loads(out.split("STRIPES ", 1)[1])
        for k in ("2", "8"):
            check(child[k]["launches_per_call"] == int(k) and len(child[k]["stripes"]) >= int(k),
                  f"{k} stripes: {child[k]}")
        scaling = child["device_scaling"]
        check(all(s["bit_identical_to_single_device"] and set(s["per_device"]) == {"1", "2", "4", "8"}
                  for s in scaling["shapes"].values()), f"device scaling rows: {scaling}")
        launches["stripes_child"] = sum(v["launches"] for v in child["sweeps"].values())
        print(f"stripes (child, 2 and 8 virtual stripes on the card): striped fitness at {child['2']['bucket']} "
              f"== unsharded bit for bit, launches a call {child['2']['launches_per_call']} / "
              f"{child['8']['launches_per_call']}; ga_sweep shard 8 and 3 == off: {json.dumps(child['sweeps'])}; "
              f"device scaling {json.dumps(scaling)}", flush=True)
        record["stripes"] = {"sweeps": child["sweeps"], "device_scaling": scaling}
        if "cards" in child:
            print(f"stripes over the {child['cards']['count']} cards: {json.dumps(child['cards'])}", flush=True)
            record["stripes"]["cards"] = child["cards"]

        # the large sweep, alone on the card now
        population_makespan_cuda.launches = 0
        t0 = time.perf_counter()
        results = ga_sweep(problems, backend="auto", device="cuda", seed=0, **GA)
        torch.cuda.synchronize()
        large_s = time.perf_counter() - t0
        n = population_makespan_cuda.launches
        launches["large_sweep"] = n
        check(n == GA["generations"] + 1, f"large ga_sweep made {n} launches, expected 61")
        for problem, r in zip(problems, results):
            check(verify_schedule(problem, r.schedule) == [], "large sweep schedule is valid")
            check(np.isfinite(r.history).all() and (np.diff(r.history) <= 0).all(), "large sweep history")
        prof = device_time_breakdown(lambda: ga_sweep(problems, backend="auto", device="cuda", seed=0, **GA),
                                     classify=makespan_class)
        # the kernel against its plain version at the large sweep's shape
        dev = torch.device("cuda")
        stacked, bucket = stack_packed(problems, device=dev)
        kw = {k: stacked[k] for k in KEYS}
        kw["deadline"] = None
        A = torch.zeros(len(problems), GA["pop_size"], bucket[0], dtype=torch.int32)
        for b, problem in enumerate(problems):
            A[b, :, : problem.num_tasks] = torch.from_numpy(random_assignments(problem, GA["pop_size"], 16 + b))
        A = A.to(dev)
        mk_k, v_k = population_makespan_cuda(A, **kw)
        mk_p, v_p = population_makespan_ref(A, **kw)
        torch.cuda.synchronize()
        check(same_bits(mk_k, mk_p) and same_bits(v_k, v_p), f"large {bucket}: kernel == plain version, bit for bit")
        check(bool(torch.isfinite(mk_k).all()), "large: finite makespans")
        ms = cuda_ms(lambda: population_makespan_cuda(A, **kw), reps=10)
        plain = call_ms(lambda: population_makespan_ref(A, **kw), reps=1, warmup=0)
        bound, by, nbytes, ops = makespan_bound_ms(A, kw)
        record.update(large_ms=ms, large_plain_ms=plain, large_bound_ms=bound, large_bound_by=by,
                      large_bucket=list(bucket), large_max_abs_err=float((mk_k - mk_p).abs().max()))
        print(f"topology large: {large.num_nodes} nodes {tiers} generated in {gen_s:.3f} s, 8 problems built in "
              f"{build_s:.2f} s, bucket {bucket}", flush=True)
        print(f"ga_sweep large 8x(500 tasks x 1008 nodes) pop={GA['pop_size']} gens={GA['generations']}: "
              f"{large_s:.3f} s wall, {n} kernel launches, every schedule valid, makespans "
              f"{[round(r.schedule.makespan, 2) for r in results]}; warm, profiled: wall {prof['wall_ms']:.2f} ms, "
              f"device busy {prof['device_busy_ms']:.2f} ms, idle {prof['device_idle_share']:.4f}, by class "
              f"{json.dumps(prof.get('by_class'))}", flush=True)
        print(f"makespan large {list(A.shape)} x N {bucket[1]} CMAX {bucket[2]}: kernel == plain bit for bit; "
              f"kernel {ms:.4f} ms, plain {plain:.2f} ms (one call), bound {bound:.6f} ms ({by}: {nbytes} B, "
              f"{ops} ops)", flush=True)
        record["large_sweep"] = {"wall_s": large_s, "generate_s": gen_s, "build_s": build_s,
                                 **{k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}}

        # the topology lane and the twin calibration, written where it is told
        population_makespan_cuda.launches = 0
        t0 = time.perf_counter()
        rows = builtin.run_topology_bench(tmp / "topology.json", device="cuda")
        torch.cuda.synchronize()
        lane_s = time.perf_counter() - t0
        launches["topology_lane"] = population_makespan_cuda.launches
        payload = json.loads((tmp / "topology.json").read_text())
        check(launches["topology_lane"] > 0, "the topology lane's GA cells ran the kernel")
        for preset, cal in payload["calibration"].items():
            check(cal["twin_error_after"] < cal["twin_error_before"], f"{preset}: twin error after < before")
            check(cal["speed_factor_rel_mae"] < 0.05, f"{preset}: speed factors within 5%")
        statuses = payload["campaign"]["data"]["status"]
        check(statuses and all(st == "ok" for st in statuses), f"every topology lane cell solved: {statuses}")
        calib = {p: {k: c[k] for k in ("twin_error_before", "twin_error_after", "speed_factor_rel_mae",
                                       "loss_initial", "loss_final")} for p, c in payload["calibration"].items()}
        print(f"topology lane: {len(statuses)} cells in {lane_s:.2f} s, "
              f"{launches['topology_lane']} launches; calibration {json.dumps(calib)}; generate_large "
              f"{payload['generate_large']['seconds']:.4f} s ({payload['generate_large']['nodes']} nodes); "
              f"rows {[r[0] for r in rows]}", flush=True)
        record["topology_lane"] = {"wall_s": lane_s, "generate_large_s": payload["generate_large"]["seconds"],
                                   "calibration": payload["calibration"]}
    finally:
        import shutil

        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    bench_after = {p.name: p.read_bytes() for p in repo.glob("BENCH_*.json")}
    check(bench_after == bench_before, "no BENCH_*.json of the repository changed")
    return launches, record


# -----------------------------------------------------------------------------
# phase 22: training
# -----------------------------------------------------------------------------

#: the training runs at full width and depth: batch 4 × 1024 tokens, the
#: training CLI's AdamW settings, 5 steps, then 2 held-out batches
TRAIN = {"batch": 4, "seq": 1024, "steps": 5, "eval_batches": 2}
#: the depth of phase 22's f32 cuts held against the CPU: 1 since phase 24
#: (a) took the five other trainable families (2 before, when the run took
#: 873.82 s of phases on an H100 80GB HBM3 at 700 W; ``tools/cut_probe.py
#: 22``)
TRAIN_CPU_LAYERS = 1


def train_attention_bound_ms(q: torch.Tensor, k: torch.Tensor, pairs: int, kv_rows: int) -> tuple[float, str]:
    """Least time an H100 could take for attention's forward and backward:
    q, k, v and the output's cotangent read once, the output and the three
    gradients written once (twice the forward's bytes), against 12·D
    operations a visible pair (QKᵀ and PV forward; dV, dP, dQ and dK
    backward: three times the forward's) at the rate of the dtype."""
    w = attention_work(q, k, pairs, kv_rows)
    return roofline_ms(3 * w.flops, 2 * w.bytes, q.dtype)


def train_ssd_bound_ms(x: torch.Tensor, G: int, N: int) -> tuple[float, str]:
    """Least time for the SSD scan's forward and backward: x, B, C, dt, A
    and y's cotangent read once, y, the final state and the five gradients
    written once (twice the forward's bytes less one final state), against
    12·P·N operations a (batch, step, head): the forward's 4·P·N
    (:func:`ssd_bound_ms`) and twice that backward."""
    w = ssd_work(x, G, N)
    Bsz, _, H, P = x.shape
    return roofline_ms(3 * w.flops, 2 * w.bytes - Bsz * H * P * N * 4, x.dtype)


def with_grads(fn, inputs: tuple, cotangents: tuple):
    """``fn``'s outputs on fresh leaves of ``inputs`` and the leaves'
    gradients for ``cotangents``."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs, leaves, cotangents)


def autograd_phase() -> dict[str, dict]:
    """Phase 22, first part: ``FlashAttentionFn`` and ``SSDScanFn`` on the
    card against autograd of their plain versions on the same inputs and
    output cotangents, in bf16 and f32, at the training shapes: qwen2.5-3b's
    attention (B 4, S 1024, H 16 over Hkv 2, D 128, causal), gemma2-2b's D
    256 with softcap 50 and a window of 512 (B 2, S 1024, H 8 over 4),
    whisper-base's cross-attention (B 4, H 8, D 64, Sq 8 against 1500 keys,
    not causal) and mamba2-780m's scan (B 4, L 1024, H 48, P 64, N 128,
    chunk 128; the final state's cotangent zero, as in training).

    The Function's output is the kernel's, held to the plain version in f32
    as in phases 6 and 8.  Its gradients are autograd of the plain version
    recomputed, so they are held to the plain version's own within
    2**-7·max|g| (bf16) or 1e-6·max|g| (f32), and the run prints whether they
    are equal bit for bit.  Timed in bf16 (``cuda_ms``): the kernel's
    forward, the Function's forward and backward, the plain version's, and
    SDPA's where one call computes the function (not with a softcap), beside
    the bounds of the forward and of both; returns the records by kernel and
    shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn,
        attention_mask,
        flash_attention_cuda,
        flash_attention_ref,
    )
    from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan_cuda, ssd_scan_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    records: dict[str, dict] = {"flash_attention": {}, "ssd_scan": {}}

    def normal(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def held(label, fn, plain, inputs, cotangents, plain32_out, dtype, out_tol) -> dict:
        (outs, grads), (plain_outs, plain_grads) = with_grads(fn, inputs, cotangents), with_grads(
            plain, inputs, cotangents)
        torch.cuda.synchronize()
        atol, rtol = out_tol
        y = outs[0].detach().float()
        out_err = float((y - plain32_out).abs().max())
        check(bool(torch.isfinite(y).all()), f"{label}: finite output")
        check(torch.allclose(y, plain32_out, atol=atol, rtol=rtol),
              f"{label}: the Function's output == plain in f32 within atol {atol} rtol {rtol} (max abs diff {out_err})")
        rel = 2**-7 if dtype == torch.bfloat16 else 1e-6
        worst = 0.0
        for i, (g, g_plain) in enumerate(zip(grads, plain_grads)):
            check(g.dtype == inputs[i].dtype and bool(torch.isfinite(g.float()).all()), f"{label}: gradient {i} finite")
            scale = float(g_plain.float().abs().max())
            err = float((g.float() - g_plain.float()).abs().max())
            check(err <= rel * scale, f"{label}: gradient {i} == plain autograd within {rel}·max|g| "
                                      f"(max abs diff {err}, max|g| {scale})")
            worst = max(worst, err / scale if scale else err)
        bits = all(torch.equal(g, g_plain) for g, g_plain in zip(grads, plain_grads))
        return {"out_max_abs_err": out_err, "grad_max_rel_err": worst, "grads_bit_equal": bits}

    flash_cases = [  # (label, B, H, Hkv, Sq, Skv, D, options)
        ("qwen2.5-3b", 4, 16, 2, 1024, 1024, 128, {"causal": True}),
        ("gemma2-2b D 256 softcap 50 window 512", 2, 8, 4, 1024, 1024, 256,
         {"causal": True, "window": 512, "softcap": 50.0}),
        ("whisper-base cross Sq 8 against 1500", 4, 8, 8, 8, 1500, 64, {"causal": False}),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for label, B, H, Hkv, Sq, Skv, D, kw in flash_cases:
            opts = {"causal": kw["causal"], "window": kw.get("window"), "softcap": kw.get("softcap"), "scale": None}
            q, k, v = normal((B, H, Sq, D), dtype), normal((B, Hkv, Skv, D), dtype), normal((B, Hkv, Skv, D), dtype)
            go = normal((B, H, Sq, D), dtype)

            def fn(q, k, v):
                return FlashAttentionFn.apply(q, k, v, *opts.values())

            def plain(q, k, v):
                return flash_attention_ref(q, k, v, **opts)

            row = held(f"train flash {label} {str(dtype)[6:]}", fn, plain, (q, k, v), (go,),
                       flash_attention_ref(q.float(), k.float(), v.float(), **opts), dtype,
                       (2e-5, 2**-8) if dtype == torch.bfloat16 else (2e-5, 2e-5))
            line = (f"train flash {label} {str(dtype)[6:]}: Function output from f32 plain {row['out_max_abs_err']:.3g}, "
                    f"gradients from plain autograd {row['grad_max_rel_err']:.3g}·max|g| "
                    f"(bit for bit: {row['grads_bit_equal']})")
            if dtype == torch.bfloat16:
                mask = attention_mask(Sq, Skv, causal=opts["causal"], window=opts["window"], device=dev)
                pairs = int(mask.sum()) * B * H
                row["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, **opts), reps=20)
                row["fwd_bwd_ms"] = cuda_ms(lambda: with_grads(fn, (q, k, v), (go,)), reps=5)
                row["plain_fwd_bwd_ms"] = cuda_ms(lambda: with_grads(plain, (q, k, v), (go,)), reps=5)
                row["backward_ms"] = row["fwd_bwd_ms"] - row["ms"]
                row["library_fwd_bwd_ms"] = None
                if opts["softcap"] is None:
                    sdpa_mask = None if opts["window"] is None and not (opts["causal"] and Sq != Skv) else mask
                    causal = opts["causal"] and sdpa_mask is None

                    def sdpa(q, k, v):
                        return F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask, is_causal=causal,
                                                              enable_gqa=True)

                    row["library_fwd_bwd_ms"] = cuda_ms(lambda: with_grads(sdpa, (q, k, v), (go,)), reps=5)
                row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, pairs, B * Hkv * Skv)
                row["fwd_bwd_bound_ms"], row["fwd_bwd_bound_by"] = train_attention_bound_ms(q, k, pairs,
                                                                                         B * Hkv * Skv)
                lib = row["library_fwd_bwd_ms"]
                line += (f"; kernel forward {row['ms']:.4f} ms (bound {row['bound_ms']:.6f}, {row['bound_by']}), "
                         f"Function forward + backward {row['fwd_bwd_ms']:.4f} ms (the plain backward "
                         f"{row['backward_ms']:.4f}), plain {row['plain_fwd_bwd_ms']:.4f}, sdpa "
                         f"{'none' if lib is None else f'{lib:.4f}'} ms, bound {row['fwd_bwd_bound_ms']:.6f} "
                         f"({row['fwd_bwd_bound_by']})")
            records["flash_attention"][f"{label} {str(dtype)[6:]}"] = row
            print(line, flush=True)

    B, L, H, P, G, N, chunk = 4, 1024, 48, 64, 1, 128, 128  # mamba2-780m
    for dtype in (torch.bfloat16, torch.float32):
        x = normal((B, L, H, P), dtype)
        dt = torch.randn(B, L, H, generator=gen, device=dev).abs() * 0.1 + 0.01
        A = -(torch.randn(H, generator=gen, device=dev).abs() + 0.2)
        Bm, Cm = normal((B, L, G, N), dtype), normal((B, L, G, N), dtype)
        inputs = (x, dt, A, Bm, Cm)
        cot = (normal((B, L, H, P), dtype), torch.zeros(B, H, P, N, device=dev))

        def fn(*a):
            return SSDScanFn.apply(*a, chunk)

        def plain(*a):
            return ssd_scan_ref(*a, chunk=chunk)

        label = f"train ssd mamba2-780m B={B} L={L} {str(dtype)[6:]}"
        row = held(label, fn, plain, inputs, cot, ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(), chunk=chunk)[0],
                   dtype, (3e-4, 2**-8) if dtype == torch.bfloat16 else (3e-4, 3e-4))
        line = (f"{label}: Function output from f32 plain {row['out_max_abs_err']:.3g}, gradients from plain "
                f"autograd {row['grad_max_rel_err']:.3g}·max|g| (bit for bit: {row['grads_bit_equal']})")
        if dtype == torch.bfloat16:
            row["ms"] = cuda_ms(lambda: ssd_scan_cuda(*inputs, chunk=chunk), reps=20)
            row["fwd_bwd_ms"] = cuda_ms(lambda: with_grads(fn, inputs, cot), reps=3)
            row["plain_fwd_bwd_ms"] = cuda_ms(lambda: with_grads(plain, inputs, cot), reps=3)
            row["backward_ms"] = row["fwd_bwd_ms"] - row["ms"]
            row["library_fwd_bwd_ms"] = None
            row["bound_ms"], row["bound_by"] = ssd_bound_ms(x, G, N)
            row["fwd_bwd_bound_ms"], row["fwd_bwd_bound_by"] = train_ssd_bound_ms(x, G, N)
            line += (f"; kernel forward {row['ms']:.4f} ms (bound {row['bound_ms']:.6f}, {row['bound_by']}), "
                     f"Function forward + backward {row['fwd_bwd_ms']:.4f} ms (the plain backward "
                     f"{row['backward_ms']:.4f}), plain {row['plain_fwd_bwd_ms']:.4f}, bound "
                     f"{row['fwd_bwd_bound_ms']:.6f} ({row['fwd_bwd_bound_by']})")
        records["ssd_scan"][f"mamba2-780m {str(dtype)[6:]}"] = row
        print(line, flush=True)
    return records


def per_forward(cfg) -> dict[str, int]:
    """Each kernel's launches in one forward of a model of ``cfg``."""
    from repro_torch.models.hybrid import num_shared_invocations

    if cfg.family == "ssm":
        return {"ssd_scan": cfg.num_layers}
    if cfg.family == "hybrid":
        return {"ssd_scan": cfg.num_layers, "flash_attention": num_shared_invocations(cfg)}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.enc_layers + 2 * cfg.num_layers}
    return {"flash_attention": cfg.num_layers}


def train_full_width(arch: str) -> tuple[int, dict]:
    """Phase 22: ``arch`` at full width and depth in bf16 (random weights
    from a seed) trained for ``TRAIN["steps"]`` steps on the synthetic
    stream (batch 4 × 1024 tokens, two bigram chains) with the training
    CLI's AdamW settings and remat: step 1 through the step's two halves
    (``make_grad_fn``, then ``adamw.update``), so that every parameter's
    gradient is held to a finite, non-zero norm; steps 2-5 through
    ``make_train_step``, timed until the loss reaches the host; one step at
    ``microbatches=2``; one profiled step; then ``evaluate`` on 2 held-out
    batches.  Every step makes 2 kernel launches a layer (the forward and
    the remat recomputation), a microbatched step 4, an evaluation batch 1.
    Returns (the launches of the run, its readings)."""
    import gc

    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.evaluate import evaluate
    from repro_torch.train.train_step import make_grad_fn, make_train_step

    api = get_model(arch)
    cfg = api.config
    (kernel, per), = per_forward(cfg).items()
    wrapper = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda}[kernel]
    steps, tokens = TRAIN["steps"], TRAIN["batch"] * TRAIN["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = L.trainable(api.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda"))
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(), f"{arch}: {n_params} parameters, the config's {cfg.param_count()}")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], seed=0,
                          mixture_components=2)
    stream = SyntheticLMStream(data_cfg)
    state = {"opt": adamw.init(opt_cfg, params)}
    torch.cuda.synchronize()
    state_gb = sum(p.numel() * (p.element_size() * 2 + 8) for p in params.parameters()) / 1e9
    print(f"train {arch}: {n_params:,} parameters made in {time.perf_counter() - t0:.1f} s; parameters, "
          f"gradients and f32 moments {state_gb:.2f} GB; {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)

    def batch() -> dict:
        return {k: torch.from_numpy(v).cuda() for k, v in stream.next_batch().items()}

    step_fn = make_train_step(api, cfg, opt_cfg, remat=True)

    def one_step(fn=step_fn) -> dict:
        _, state["opt"], metrics = fn(params, state["opt"], batch())
        return {k: float(v) for k, v in metrics.items()}

    # step 1: the gradients, each parameter's checked, then the update
    wrapper.launches = 0
    t0 = time.perf_counter()
    grads, metrics = make_grad_fn(api, cfg, remat=True)(params, batch())
    norms = torch.stack([g.float().norm() for g in grads.values()]).cpu()
    grad_s = time.perf_counter() - t0
    check(wrapper.launches == 2 * per, f"{arch} step 1: {wrapper.launches} {kernel} launches, expected {2 * per}")
    check(sorted(grads) == sorted(dict(params.named_parameters())), f"{arch}: every parameter has a gradient")
    check(bool(torch.isfinite(norms).all() and (norms > 0).all()),
          f"{arch}: every gradient finite with a non-zero norm ({int((norms == 0).sum())} zero)")
    t1 = time.perf_counter()
    _, state["opt"], opt_metrics = adamw.update(opt_cfg, grads, state["opt"], params)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t1
    del grads
    losses, gnorms = [float(metrics["loss"])], [float(opt_metrics["grad_norm"])]
    step_s = [time.perf_counter() - t0]
    for _ in range(1, steps):
        t0 = time.perf_counter()
        m = one_step()
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), f"{arch}: finite losses {losses} and grad norms {gnorms}")
    check(wrapper.launches == steps * 2 * per, f"{arch}: {wrapper.launches} launches in {steps} steps, expected "
                                               f"{steps * 2 * per}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"steps": wrapper.launches}

    before = wrapper.launches
    t0 = time.perf_counter()
    m = one_step(make_train_step(api, cfg, opt_cfg, remat=True, microbatches=2))
    mb_s = time.perf_counter() - t0
    launches["microbatches=2 step"] = wrapper.launches - before
    check(launches["microbatches=2 step"] == 4 * per and np.isfinite(m["loss"]),
          f"{arch}: a microbatches=2 step made {launches['microbatches=2 step']} launches, expected {4 * per}")

    before = wrapper.launches
    profile = device_time_breakdown(one_step, classify=kernel_class)
    launches["profiled step"] = wrapper.launches - before
    check(profile["device_busy_ms"] is not None, f"{arch}: the profiler saw the step's kernels")

    before = wrapper.launches
    t0 = time.perf_counter()
    ev = evaluate(api, cfg, params, data_cfg, batches=TRAIN["eval_batches"])
    eval_s = time.perf_counter() - t0
    launches["evaluate"] = wrapper.launches - before
    check(launches["evaluate"] == TRAIN["eval_batches"] * per and np.isfinite(ev["nll"]),
          f"{arch}: evaluate made {launches['evaluate']} launches, expected {TRAIN['eval_batches'] * per}; {ev}")

    steady = step_s[1:]
    step_ms = 1e3 * statistics.median(steady)
    bound_ms = 1e3 * 6 * n_params * tokens / BF16_OPS_PER_S  # a forward and a backward
    remat_bound_ms = 1e3 * 8 * n_params * tokens / BF16_OPS_PER_S  # and the remat recomputation
    readings = {
        "parameters": n_params, "tokens_per_step": tokens, "losses": losses, "grad_norms": gnorms,
        "step_s": step_s, "step_ms_steps_2_to_5": [1e3 * s for s in steady], "step_ms_median": step_ms,
        "tokens_per_s": tokens / statistics.median(steady), "bound_ms_6NT": bound_ms,
        "bound_ms_8NT_with_remat": remat_bound_ms,
        "step1_grad_s": grad_s, "step1_adamw_update_s": update_s, "microbatches_2_step_s": mb_s,
        "peak_memory_gb": peak_gb, "state_gb": state_gb, "evaluate": ev, "evaluate_s": eval_s,
        "profile": profile, "launches": launches,
    }
    print(f"train {arch}: losses {[round(x, 4) for x in losses]}, grad norms {[round(x, 4) for x in gnorms]}; "
          f"steps 2-{steps} {[round(1e3 * s, 2) for s in steady]} ms (median {step_ms:.2f} ms, "
          f"{readings['tokens_per_s']:.0f} tokens/s) against a bound of {bound_ms:.2f} ms (6·N·tokens, "
          f"operations; {remat_bound_ms:.2f} ms at 8·N·tokens with the remat forward); step 1 {1e3 * step_s[0]:.1f} ms (gradients {1e3 * grad_s:.1f}, AdamW {1e3 * update_s:.1f}); "
          f"microbatches=2 {1e3 * mb_s:.1f} ms; peak {peak_gb:.2f} GB; idle share of a profiled step "
          f"{profile['device_idle_share']}; evaluate nll {ev['nll']:.4f} in {eval_s:.2f} s; launches {launches}",
          flush=True)
    print(json.dumps({f"train_{arch}": readings}), flush=True)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return sum(launches.values()), readings


def train_card_against_cpu(arch: str, layers: int) -> dict:
    """Phase 22: ``arch`` at full width cut to ``layers`` layers in f32
    (TF32 off), the same weights on the card and on the CPU, one batch of 1
    × 128 tokens: the loss within rtol 1e-5 and each gradient within 1e-5 +
    1e-4·max|g|, the tolerances of the CPU tests against the reference;
    then one AdamW step on each side from the CPU's gradients, whose
    parameters and moments are held within 1e-6 of their largest value, the
    tests' tolerance for AdamW on the same inputs; then the composed step,
    the card's gradients through AdamW on the card against the CPU's through
    AdamW on the CPU.  AdamW's first step moves each element by lr·g/(|g| +
    eps) of its clipped gradient g, whose slope is at most 1/(|g| + eps), so
    the composed step's parameters are held per element within lr·|Δg| /
    (min|g| + eps) + 1e-6·max|p|, and the largest deviation is printed
    beside the two gradients at that element.  Returns the measured maxima."""
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_grad_fn

    check(not torch.backends.cuda.matmul.allow_tf32, "f32 products run in f32 (TF32 off)")
    api = get_model(arch)
    cut = dataclasses.replace(api.config, num_layers=layers, dtype="float32")
    t0 = time.perf_counter()
    on_gpu = L.trainable(api.init(torch.Generator(device="cuda").manual_seed(1), cut, device="cuda"))
    on_cpu = L.trainable(load_like(on_gpu, cut, "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(22).integers(0, cut.vocab, (1, 128)).astype(np.int32))
    sides = {"cpu": on_cpu, "card": on_gpu}
    grads, losses = {}, {}
    for side, params in sides.items():
        dev = next(params.parameters()).device
        g, metrics = make_grad_fn(api, cut, remat=True)(params, {"tokens": tokens.to(dev)})
        grads[side], losses[side] = g, float(metrics["loss"])
    worst = {"loss_rel": abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])}
    check(worst["loss_rel"] <= 1e-5, f"{arch} {layers} layers f32: loss card {losses['card']} against CPU {losses['cpu']}")

    def held(part: str, on_card: dict, on_host: dict, atol: float, rel: float) -> None:
        high = 0.0
        for k, ref in on_host.items():
            scale = float(ref.abs().max())
            err = float((on_card[k].detach().cpu() - ref).abs().max())
            check(err <= atol + rel * scale, f"{arch} {layers} layers f32: {part} {k} card against CPU {err} > "
                                             f"{atol} + {rel}·{scale}")
            high = max(high, err / scale if scale else err)
        worst[f"{part}_max_rel_err"] = high

    held("grads", grads["card"], grads["cpu"], 1e-5, 1e-4)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
    start = {k: p.detach().clone() for k, p in on_gpu.named_parameters()}
    states = {}
    for side, params in sides.items():
        g = {k: t.to(next(params.parameters()).device) for k, t in grads["cpu"].items()}
        _, states[side], _ = adamw.update(opt_cfg, g, adamw.init(opt_cfg, params), params)
    held("adamw params", dict(on_gpu.named_parameters()), {k: p.detach() for k, p in on_cpu.named_parameters()},
         0.0, 1e-6)
    held("adamw m", states["card"]["m"], states["cpu"]["m"], 0.0, 1e-6)
    held("adamw v", states["card"]["v"], states["cpu"]["v"], 0.0, 1e-6)

    adamw.update(opt_cfg, grads["card"], adamw.init(opt_cfg, start), start)  # the composed step on the card
    lr = float(adamw.lr_at(opt_cfg, torch.tensor(1)))
    clip = {side: min(1.0, opt_cfg.grad_clip / (float(adamw.global_norm(g)) + 1e-9)) for side, g in grads.items()}
    high = {"excess": -math.inf}
    for k, ref in on_cpu.named_parameters():
        g_card, g_cpu = grads["card"][k].detach().cpu() * clip["card"], grads["cpu"][k] * clip["cpu"]
        dev = (start[k].cpu() - ref.detach()).abs()
        bound = lr * (g_card - g_cpu).abs() / (torch.minimum(g_card.abs(), g_cpu.abs()) + opt_cfg.eps)
        bound += 1e-6 * float(ref.detach().abs().max())
        excess = dev - bound
        i = int(excess.argmax())
        if float(excess.flatten()[i]) > high["excess"]:
            high = {"excess": float(excess.flatten()[i]), "param": k, "deviation": float(dev.flatten()[i]),
                    "bound": float(bound.flatten()[i]), "g_card": float(g_card.flatten()[i]),
                    "g_cpu": float(g_cpu.flatten()[i])}
        j = int(dev.argmax())
        if float(dev.flatten()[j]) > worst.get("composed_max_abs_dev", -1.0):
            worst["composed_max_abs_dev"] = float(dev.flatten()[j])
            worst["composed_at_max"] = {"param": k, "bound": float(bound.flatten()[j]),
                                        "g_card": float(g_card.flatten()[j]), "g_cpu": float(g_cpu.flatten()[j])}
    worst["composed_closest_to_bound"] = high
    check(high["excess"] <= 0, f"{arch} {layers} layers f32: the composed step's parameters beyond lr·|Δg|/(min|g| + "
                               f"eps) + 1e-6·max|p|: {high}")
    print(f"train {arch} cut to {layers} layers, f32, B 1 × S 128: card against CPU {json.dumps(worst)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return worst


def trainer_phase() -> tuple[int, dict]:
    """Phase 22: the ``Trainer`` on the card at the reference's resume test
    (reduced qwen2.5-3b in f32 at vocab 64, batch 4 × 32, checkpoints every 5
    steps in a temporary directory): 10 steps straight, then 5 and a resume
    for 5 more.  Once in PyTorch's default mode (the losses compared, their
    largest difference printed) and once under
    ``torch.use_deterministic_algorithms``, where they must be equal bit for
    bit.  Returns (the flash launches, the readings)."""
    import tempfile
    import warnings

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    api = get_model("qwen2.5-3b")
    cfg = dataclasses.replace(api.reduced, dtype="float32", vocab=64)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20, schedule="constant")
    data_cfg = DataConfig(vocab=64, seq_len=32, global_batch=4, seed=5)
    readings = {}
    flash_attention_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("default", "deterministic"):
            def make(name: str, steps: int) -> Trainer:
                return Trainer(api, cfg, opt_cfg, data_cfg,
                               TrainerConfig(steps=steps, checkpoint_every=5, checkpoint_dir=f"{tmp}/{mode}-{name}",
                                             remat=False, resume=True), device="cuda")

            t0 = time.perf_counter()
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")  # warn_only: cuBLAS's workspace setting
                    full = make("full", 10).run()
                    make("resume", 5).run()
                    resumed = make("resume", 10).run()
            finally:
                torch.use_deterministic_algorithms(False)
            check(resumed.resumed_from == 5 and len(resumed.losses) == 5, f"trainer {mode}: resumed from step 5")
            check(all(np.isfinite(full.losses)) and full.losses[-1] < full.losses[0],
                  f"trainer {mode}: finite, falling losses {full.losses}")
            diff = max(abs(a - b) for a, b in zip(resumed.losses, full.losses[5:]))
            bits = resumed.losses == full.losses[5:]
            if mode == "deterministic":
                check(bits, f"trainer deterministic: resumed losses {resumed.losses} == straight {full.losses[5:]}")
            readings[mode] = {"losses": full.losses, "resumed": resumed.losses, "max_abs_diff": diff,
                              "bit_for_bit": bits, "s": time.perf_counter() - t0}
            print(f"trainer qwen2.5-3b reduced f32 on the card ({mode}): 10 steps {[round(x, 5) for x in full.losses]}; "
                  f"resumed at 5: bit for bit {bits}, max abs diff {diff:.3g} ({readings[mode]['s']:.1f} s)",
                  flush=True)
    return flash_attention_cuda.launches, readings


def train_cli_phase() -> dict[str, dict[str, int]]:
    """Phase 22: ``python -m repro_torch.launch.train`` with no ``--device``
    for every reduced config the stream can train (its batches hold tokens
    only), 3 steps each in process (2 launches a layer a step: the forward
    and the remat recomputation), gemma2-2b again as a real child process,
    and whisper-base and internvl2-76b, which stop with the reference's
    ``KeyError``.  Returns each arch's launches by kernel."""
    import contextlib
    import io
    import tempfile

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.launch import train as train_cli
    from repro_torch.models.registry import ALL_ARCHS, get_model

    wrappers = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda}
    out: dict[str, dict[str, int]] = {}
    steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        for arch in ALL_ARCHS:
            cfg = get_model(arch).reduced
            argv = ["--arch", arch, "--steps", str(steps), "--ckpt-dir", f"{tmp}/{arch}"]
            if cfg.family in ("encdec", "vlm"):
                key = "frames" if cfg.family == "encdec" else "patches"
                try:
                    train_cli.main(argv)
                    got = None
                except KeyError as e:
                    got = e.args[0]
                check(got == key, f"the {arch} training CLI stops with the reference's KeyError({key!r}), not {got!r}")
                print(f"train cli {arch}: KeyError({got!r}), as the reference's CLI", flush=True)
                continue
            for w in wrappers.values():
                w.launches = 0
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                train_cli.main(argv)
            torch.cuda.synchronize()
            line = text.getvalue().strip().splitlines()[-1]
            check(line.startswith(f"arch={arch} steps={steps} loss "), f"the {arch} training CLI printed {line!r}")
            out[arch] = {name: wrappers[name].launches for name in per_forward(cfg)}
            expected = {name: steps * 2 * n for name, n in per_forward(cfg).items()}
            check(out[arch] == expected, f"the {arch} training CLI made {out[arch]} launches, expected {expected}")
            print(f"train cli {arch}: {line}; launches {out[arch]}", flush=True)
        src = Path(__file__).resolve().parent / "src"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma2-2b", "--steps",
                               str(steps), "--ckpt-dir", f"{tmp}/child"], env={**os.environ, "PYTHONPATH": str(src)},
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0 and proc.stdout.strip().startswith(f"arch=gemma2-2b steps={steps} loss "),
              f"python -m repro_torch.launch.train: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        print(f"train cli gemma2-2b in a child process: {proc.stdout.strip()} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return out


def training_phase() -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 22, training (see the module docstring); returns each kernel's
    launches by path and the readings, by kernel for the record."""
    clock = [time.perf_counter()]

    def part(what: str) -> None:
        now = time.perf_counter()
        print(f"phase 22 {what}: {now - clock[0]:.2f} s", flush=True)
        clock[0] = now

    autograd = autograd_phase()
    part("the autograd Functions at the training shapes")
    qwen_launches, qwen = train_full_width("qwen2.5-3b")
    part("qwen2.5-3b at full width")
    mamba_launches, mamba = train_full_width("mamba2-780m")
    part("mamba2-780m at full width")
    cut = {arch: train_card_against_cpu(arch, TRAIN_CPU_LAYERS) for arch in ("qwen2.5-3b", "mamba2-780m")}
    part("the f32 cuts against the CPU")
    trainer_launches, trainer = trainer_phase()
    part("the Trainer")
    cli = train_cli_phase()
    part("the training CLI")
    by_path = {"flash_attention": {"train qwen2.5-3b": qwen_launches,
                                   "train Trainer qwen2.5-3b reduced": trainer_launches},
               "ssd_scan": {"train mamba2-780m": mamba_launches}}
    for arch, run in cli.items():
        for name, n in run.items():
            by_path[name][f"train cli {arch}"] = n
    readings = {
        "flash_attention": {"training_shapes": autograd["flash_attention"],
                            "training": {"qwen2.5-3b": qwen, "card_against_cpu_f32": cut["qwen2.5-3b"],
                                         "trainer": trainer}},
        "ssd_scan": {"training_shapes": autograd["ssd_scan"],
                     "training": {"mamba2-780m": mamba, "card_against_cpu_f32": cut["mamba2-780m"]}},
    }
    return by_path, readings


# -----------------------------------------------------------------------------
# 23. the dry-run and its cost model
# -----------------------------------------------------------------------------

#: phase 23's steps on the card, (batch, sequence): phase 22's training
#: shape and a decode tick of 4 slots against a full cache of 2048
PREDICT = {"train": (4, 1024), "decode": (4, 2048)}
#: the band the dry-run's peak bytes must fall in, as a share of the
#: card's ``torch.cuda.max_memory_allocated`` over the same step
PEAK_BAND = (0.9, 1.1)
#: the four-card plan for the sharded step: the layouts that do not fit one
#: card, under serve-tp on (data 1, model 4); phase 25 (b) serves
#: mixtral-8x7b on four cards, and 25 (c) deepseek-67b and internvl2-76b
FOUR_CARDS = ("deepseek-67b", "internvl2-76b", "mixtral-8x7b")


def start_dryrun_sweep() -> tuple[subprocess.Popen, Path, list[int]]:
    """Phase 23 (a), started before phase 1: the whole dry-run
    (``python -m repro_torch.launch.dryrun --all --mesh both --force``) in a
    child on the host's CPU beside the card's phases, its log in
    ``build/dryrun_sweep.log``.  The child runs on the last core of this
    process's set and this process (with the children it starts meanwhile)
    on the others, so the host-bound phases' readings do not share a core
    with the sweep; returns the child, its log and this process's cores."""
    repo = Path(__file__).resolve().parent
    log = repo / "build" / "dryrun_sweep.log"
    log.parent.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="1")
    cores = sorted(os.sched_getaffinity(0))
    pin = None
    if len(cores) > 1:
        os.sched_setaffinity(0, cores[:-1])
        torch.set_num_threads(len(cores) - 1)
        pin = cores[-1]
    print(f"dryrun sweep: its child on core {pin}, this process on cores {sorted(os.sched_getaffinity(0))}",
          flush=True)
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both",
                                 "--force"], env=env, stdout=out, stderr=subprocess.STDOUT, cwd=repo,
                                preexec_fn=None if pin is None else (lambda: os.sched_setaffinity(0, {pin})))

    def stop() -> None:  # a run that fails before phase 23 leaves no child behind
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, log, cores


def finish_dryrun_sweep(proc: subprocess.Popen, log: Path, cores: list[int]) -> dict:
    """Phase 23 (a): wait for the sweep, give this process its ``cores``
    back, require every cell ``ok`` and no kernel launch in the child."""
    rc = proc.wait(timeout=900)
    os.sched_setaffinity(0, cores)
    torch.set_num_threads(len(cores))
    text = log.read_text()
    ok = len(re.findall(r"^\[ok", text, re.M))
    errors = re.findall(r"^\[error\].*$", text, re.M)
    done = re.search(r"^done: (\d+) cells, (\d+) failures in ([\d.]+) s; kernel launches (\{.*\})$", text, re.M)
    check(rc == 0 and done is not None and not errors, f"the dry-run sweep: rc {rc}, {errors[:3]}, {text[-1500:]}")
    cells, failures, seconds, launches = int(done[1]), int(done[2]), float(done[3]), json.loads(done[4])
    check(cells == ok == 68 and failures == 0, f"the dry-run sweep: {ok} of {cells} cells ok")
    check(not any(launches.values()), f"the dry-run child launched kernels: {launches}")
    print(f"dryrun sweep: {ok} of {cells} cells ok (10 architectures x their suites x meshes (16, 16) and "
          f"(2, 16, 16)) in {seconds:.1f} s on the host beside the card's phases; launches {launches}", flush=True)
    return {"cells": cells, "ok": ok, "seconds": seconds}


def _card_step(arch: str, kind: str):
    """``(run, arguments)`` of one step of ``arch`` at full width and depth on
    the card: a training step (remat, AdamW) at phase 22's shape, or a
    decode tick of 4 slots at position 2047 of a 2048-long cache."""
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step

    api = get_model(arch)
    cfg = api.config
    B, S = PREDICT[kind]
    g = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(g, cfg, device="cuda")
    if kind == "train":
        L.trainable(params)
        opt_cfg = adamw.AdamWConfig()
        state = adamw.init(opt_cfg, params)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32, device="cuda", generator=g)}
        step = make_train_step(api, cfg, opt_cfg, remat=True)
        return (lambda: step(params, state, batch)), (params, state, batch)
    cache = api.init_cache(B, S, cfg, device="cuda")
    cache["pos"] = S - 1
    token = torch.randint(0, cfg.vocab, (B,), dtype=torch.int32, device="cuda", generator=g)

    def tick():
        with torch.no_grad():
            return api.decode_step(params, token, cache)

    return tick, (params, token, cache)


def dryrun_phase() -> dict:
    """Phase 23 (b)-(d): the dry-run's prediction of one step on a (1, 1)
    mesh against the same step on the card (qwen2.5-3b and mamba2-780m
    training steps, a qwen2.5-3b decode tick): argument bytes equal,
    FLOPs equal to the counter run over the real step, the peak within
    ``PEAK_BAND`` of ``max_memory_allocated``, the roofline beside the
    measured ms; the four-card plan of ``FOUR_CARDS``; no kernel launch
    during any dry-run."""
    import gc

    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_costs import OpCounter

    one = make_mesh((1, 1), ("data", "model"))
    rows = {}
    for arch, kind in (("qwen2.5-3b", "train"), ("mamba2-780m", "train"), ("qwen2.5-3b", "decode")):
        B, S = PREDICT[kind]
        before = dryrun._launches()
        t0 = time.perf_counter()
        cell = dryrun.build_cell(arch, ShapeSuite(f"{kind}_{B}x{S}", kind, S, B), one, dryrun.POLICIES["baseline"])
        _, meta = dryrun.count_cell(cell, scopes=False)
        trace_s = time.perf_counter() - t0
        check(dryrun._launches() == before, f"{arch} {kind}: the dry-run launched no kernel")
        predicted = meta.memory()
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        run, args = _card_step(arch, kind)
        run()  # warm: the libraries, cuBLAS's workspace
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        with OpCounter(arguments=args) as card:  # not timed
            run()
            torch.cuda.synchronize()
        card_args = card.memory()["argument_bytes"]
        flops, nbytes = meta.costs.flops, meta.costs.bytes
        roof_ms, bound_by = roofline_ms(flops, nbytes, torch.bfloat16)
        ratio = predicted["peak_bytes"] / peak
        label = f"{arch} {kind} {B}x{S}"
        check(predicted["argument_bytes"] == card_args,
              f"{label}: dry-run argument bytes {predicted['argument_bytes']} == the card's {card_args}")
        check(card.costs.flops == flops,
              f"{label}: dry-run FLOPs {flops:.0f} == the counter over the card's step {card.costs.flops:.0f}")
        check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1],
              f"{label}: dry-run peak {predicted['peak_bytes']} within {PEAK_BAND} of the card's {peak} ({ratio:.4f})")
        rows[label] = {
            "argument_bytes": predicted["argument_bytes"], "card_argument_bytes": card_args,
            "flops": flops, "card_flops": card.costs.flops, "matmul_flops": meta.costs.matmul_flops,
            "bytes": nbytes, "card_bytes": card.costs.bytes, "peak_bytes": predicted["peak_bytes"],
            "card_max_memory_allocated": peak, "peak_ratio": ratio, "temp_bytes": predicted["temp_bytes"],
            "roofline_ms": roof_ms, "bound_by": bound_by, "step_ms": ms, "trace_s": trace_s,
            "kernels": meta.costs.kernels,
        }
        print(f"dryrun {label}: arguments {predicted['argument_bytes']:,} B == card {card_args:,} B; FLOPs "
              f"{flops:.6e} == card {card.costs.flops:.6e} (matmul {meta.costs.matmul_flops:.6e}); bytes "
              f"{nbytes:.6e} (card {card.costs.bytes:.6e}); peak {predicted['peak_bytes'] / 1e9:.3f} GB against "
              f"max_memory_allocated {peak / 1e9:.3f} GB (ratio {ratio:.4f}, band {PEAK_BAND}); roofline "
              f"{roof_ms:.3f} ms ({bound_by}) against {ms:.2f} ms measured; traced on meta in {trace_s:.1f} s",
              flush=True)
        del run, args, card
        gc.collect()
        torch.cuda.empty_cache()

    four = make_mesh((1, 4), ("data", "model"))
    plan = {}
    before = dryrun._launches()
    for arch in FOUR_CARDS:
        rec = dryrun.run_cell(arch, "decode_32k", "1x4", policy=dryrun.POLICIES["serve-tp"], mesh=four, write=False,
                              tag="@serve-tp")
        check(rec["status"] == "ok", f"four-card plan {arch}: {rec.get('error')}")
        cell = dryrun.build_cell(arch, "decode_32k", four, dryrun.POLICIES["serve-tp"])
        param_bytes = sum(p.numel() * p.element_size() for p in cell.params.parameters())
        mem = rec["memory"]
        cache_bytes = mem["argument_bytes"] - param_bytes
        plan[arch] = {"param_bytes_per_card": param_bytes, "decode_32k_peak_bytes": mem["peak_bytes"],
                      "cache_bytes_per_card": cache_bytes, "collective_bytes": rec["collectives"]["total_bytes"],
                      "layout": rec["layout"]["attention"]}
        print(f"dryrun four-card plan {arch} serve-tp (data 1, model 4): parameters {param_bytes / 1e9:.3f} GB a card; "
              f"decode_32k (128 x 32768) peak {mem['peak_bytes'] / 1e9:.3f} GB a card (cache {cache_bytes / 1e9:.3f} GB), "
              f"exchanges {rec['collectives']['total_bytes'] / 1e9:.4f} GB a tick; attention {rec['layout']['attention']}",
              flush=True)
    check(dryrun._launches() == before, "the four-card plan launched no kernel")
    print(json.dumps({"dryrun_predict": rows, "dryrun_four_cards": plan}), flush=True)
    return {"predict": rows, "four_cards": plan}


# -----------------------------------------------------------------------------
# 24. the sharded training step on real exchanges
# -----------------------------------------------------------------------------

#: phase 24 (a)-(b): four processes share the one card in a gloo group
#: (NCCL refuses two ranks on one card).  Gloo's TCP transport cannot send a
#: CUDA tensor (``writev ... Bad address`` on torch 2.11), so ``DistComm``
#: copies each exchange's tensors through the host (``staged=True``, named
#: here, never a fallback).
#: ``meshes``: the state after the first one's step 2 is saved and restored
#: under the second.  The one card ran (1, 4) too until phase 24 (a) took
#: the five other trainable families (the run then took 873.82 s of phases
#: on an H100 80GB HBM3 at 700 W); four cards run both, the restore between
#: them included
SHARDED_ONE_CARD = {"backend": "gloo", "staged": True, "world": 4, "cards": 1, "arch": "qwen2.5-3b",
                    "layers": 2, "dtype": "float32", "batch": 4, "seq": 1024, "pipe_layers": 8,
                    "pipe_micro": 4, "meshes": [[2, 2]]}
#: phase 24 (c): a process a card over NCCL, full width and depth in bf16
SHARDED_FOUR_CARDS = {"backend": "nccl", "staged": False, "world": 4, "cards": 4, "arch": "qwen2.5-3b",
                      "layers": None, "dtype": None, "batch": 4, "seq": 1024, "pipe_layers": None,
                      "pipe_micro": 4, "meshes": [[2, 2], [1, 4]]}
#: the reference's tolerance for a sharded step against one device's
#: (tests/test_distributed.py:142), held in f32 with TF32 off.  AdamW's
#: first move of an element is lr·g/(|g| + eps): where the first gradient
#: is non-zero and below ``EPS_REGIME`` the order of f32 sums (~1e-8
#: absolute at this width, measured element by element on an H100) decides
#: its sign.  So the first gradients themselves are held first, whole, to
#: the CPU tests' tolerance against the reference (``GRAD_TOL``: 1e-5 +
#: 1e-4·max|g| a tensor); then every parameter after two steps to the
#: reference's tolerance, but those elements within ``EPS_REGIME_ATOL``:
#: 2.5 times the largest deviation measured among them (4.06e-4), and half
#: of the 2·lr that one step taken the other way moves an element.
SHARDED_TOL = {"loss": 1e-4, "atol": 2e-4, "rtol": 2e-3}
GRAD_TOL = {"atol": 1e-5, "rel": 1e-4}
EPS_REGIME = 1e-7
EPS_REGIME_ATOL = 1e-3
#: (c): bf16 sums in another order: the sharded loss within this share of
#: one card's bf16 loss
FOUR_CARD_LOSS_RTOL = 5e-3
#: (b): the pipeline runs the same kernels at the same shapes in the same
#: order as the blocks in sequence: equal within this share of the largest
#: value (f32 at one card; bf16 at four)
PIPE_RTOL = {"float32": 1e-6, "bfloat16": 2 ** -8}


def plan_counts(counter) -> dict:
    """What a rank's step and the dry-run's plan must count alike."""
    j = counter.costs.to_json()
    return {"arguments": counter.memory()["argument_bytes"], "flops": j["flops"],
            "collective_counts": j["collective_counts"], "collective_bytes": j["collective_bytes"],
            "kernels": j["kernels"]}


def sharded_child() -> None:
    """One rank of phase 24 (``SHARDED_CHILD`` in the environment: its rank,
    the group's settings and the directory it reports to)."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed.comm import DistComm
    from repro_torch.distributed.compression import compressed_psum_pod
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_grad_fn, make_train_step

    job = json.loads(os.environ["SHARDED_CHILD"])
    rank, world, out_dir = job["rank"], job["world"], Path(job["dir"])
    torch.set_num_threads(2)
    card = rank % job["cards"]
    dev = torch.device("cuda", card)
    torch.cuda.set_device(card)
    dist.init_process_group(job["backend"], init_method=f"file://{out_dir / 'store'}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    report: dict = {"rank": rank, "card": card, "backend": job["backend"], "staged": job["staged"]}
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        report.setdefault("seconds", {})[what] = now - clock[0]
        clock[0] = now

    api = get_model(job["arch"])
    cut = api.config if job["layers"] is None else dataclasses.replace(api.config, num_layers=job["layers"])
    if job["dtype"]:
        cut = dataclasses.replace(cut, dtype=job["dtype"])
    B, S = job["batch"], job["seq"]
    tokens = torch.from_numpy(np.random.default_rng(24).integers(0, cut.vocab, (B, S)).astype(np.int32)).to(dev)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    suite = ShapeSuite(f"train_{B}x{S}", "train", S, B)

    def model():
        return L.trainable(api.init(torch.Generator(device=dev).manual_seed(0), cut, device=dev))

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    held = job["backend"] == "gloo"  # (a) in f32 to the reference's tolerance; (c) in bf16 to a loss band
    single = {}

    def unsharded() -> None:
        """The unsharded steps on rank 0's card: the first gradients, the
        parameters after step 2 and three losses."""
        one = model()
        grads, _ = make_grad_fn(api, cut, remat=True)(one, {"tokens": tokens})
        single["eps_regime"] = {k: ((g != 0) & (g.abs() < EPS_REGIME)).cpu() for k, g in grads.items()}
        if held:
            single["g1"] = {k: g.to("cpu", copy=True) for k, g in grads.items()}
        del grads
        state = adamw.init(opt_cfg, one)
        step = make_train_step(api, cut, opt_cfg, remat=True)
        losses = []
        for i in range(3):
            _, state, m = step(one, state, {"tokens": tokens})
            losses.append(float(m["loss"]))
            if i == 1:
                single["params"] = {k: p.detach().to("cpu", copy=True) for k, p in one.named_parameters()}
        single["losses"] = losses
        del one, state, step
        gc.collect()
        torch.cuda.empty_cache()

    saved_whole = None
    manager = CheckpointManager(out_dir / "ck", keep=1, async_save=True)
    meshes = [tuple(m) for m in job["meshes"]]
    for shape in meshes:
        mesh = make_mesh(shape, ("data", "model"))
        name = f"({shape[0]}, {shape[1]})"
        comm = DistComm(mesh, rank, job["backend"], staged=job["staged"])
        cell = dryrun.build_cell(job["arch"], suite, mesh, dryrun.POLICIES["baseline"], cfg=cut, comm=comm,
                                 source=model(), batch={"tokens": tokens}, opt_cfg=opt_cfg)
        plan = dryrun.build_cell(job["arch"], suite, mesh, dryrun.POLICIES["baseline"], cfg=cut, opt_cfg=opt_cfg)
        _, planned = dryrun.count_cell(plan, scopes=False)
        del plan
        lap(f"{name} cell built, its plan counted on meta")
        flash_attention_cuda.launches = 0
        (_, opt, m1), counted = dryrun.count_cell(cell, scopes=False)
        torch.cuda.synchronize()
        launches = flash_attention_cuda.launches
        specs = cell.program.specs
        m_whole = {}  # the first gradients, from AdamW's m = (1 - b1)·scale·g after step 1, whole on rank 0
        for k, t in opt["m"].items() if held else ():
            w = comm.gather_whole(t, specs[k], dst=0)
            m_whole[k] = w.clone() if w is t else w  # a replicated leaf is the live m, which step 2 updates
        lap(f"{name} step 1, its m gathered")
        torch.cuda.reset_peak_memory_stats()
        (_, opt, m2), ms2 = sync_ms(cell.run)
        peak = torch.cuda.max_memory_allocated()
        lap(f"{name} step 2")
        row = {
            "launches_step1": launches, "losses": [float(m1["loss"]), float(m2["loss"])],
            "grad_norms": [float(m1["grad_norm"]), float(m2["grad_norm"])], "step2_ms": ms2,
            "counted": plan_counts(counted), "plan": plan_counts(planned),
            "plan_peak_bytes": planned.memory()["peak_bytes"], "max_memory_allocated": peak,
            "layout": dryrun.layout(cell.program),
        }

        def step3() -> float:
            """Step 3, under the profiler where the exchanges are NCCL's
            kernels on the card."""
            done = []
            if job["backend"] == "nccl":
                row["profile"] = device_time_breakdown(lambda: done.append(cell.run()), classify=sharded_kernel_class)
            else:
                done.append(cell.run())
            return float(done[0][2]["loss"])

        named = dict(cell.params.named_parameters())
        if shape == meshes[0] and len(meshes) > 1:  # the state after step 2, saved whole; device 0 writes it
            tree = {"params": named, "m": opt["m"], "v": opt["v"], "step": opt["step"]}
            sh = {"params": {k: comm.sharding(specs[k]) for k in named},
                  "m": {k: comm.sharding(specs[k]) for k in named},
                  "v": {k: comm.sharding(specs[k]) for k in named}, "step": comm.sharding(())}
            t0 = time.perf_counter()
            manager.save(2, tree, shardings=sh)
            row["save_gather_s"] = time.perf_counter() - t0
            del tree, sh
        whole = cell.program.whole(cell.params, dst=0)
        if shape == meshes[0]:
            saved_whole = {k: t.to("cpu", copy=True) for k, t in whole.items()} if rank == 0 else None
            whole = saved_whole  # no copy left on the card while the unsharded steps run
            if rank == 0:  # while device 0 writes; the others wait in step 3's exchanges
                unsharded()
            lap(f"{name} saved, the unsharded steps on rank 0")
        if rank == 0:
            grads_row = {}
            if held:
                scale = min(1.0, opt_cfg.grad_clip / (float(m1["grad_norm"]) + 1e-9))
                worst, over = 0.0, []
                for k, ref in single["g1"].items():
                    ref = ref.to(dev)
                    g = m_whole[k].to(dev).float() / ((1 - opt_cfg.beta1) * scale)
                    err, top = float((g - ref).abs().max()), float(ref.abs().max())
                    worst = max(worst, err / top if top else err)
                    if err > GRAD_TOL["atol"] + GRAD_TOL["rel"] * top:
                        over.append([k, err, top])
                grads_row = {"grads_max_rel_err": worst, "grads_over_tolerance": over}
            errs, over, outside, regime, regime_err = {}, 0, 0, 0, 0.0
            for k, ref in single["params"].items():
                ref = ref.to(dev).float()
                d = (whole[k].to(dev).float() - ref).abs()  # gathered on the host when staged
                bad = d > SHARDED_TOL["atol"] + SHARDED_TOL["rtol"] * ref.abs()
                tiny = single["eps_regime"][k].to(dev)
                errs[k] = float(d.max())
                over += int(bad.sum())
                outside += int((bad & ~tiny).sum())
                regime += int(tiny.sum())
                if tiny.any():
                    regime_err = max(regime_err, float(d[tiny].max()))
            row.update(param_max_abs_err=max(errs.values()), params_over_tolerance=over,
                       params_over_tolerance_outside_eps_regime=outside, eps_regime_elements=regime,
                       eps_regime_max_abs_err=regime_err,
                       params_close=outside == 0 and regime_err <= EPS_REGIME_ATOL,
                       worst_params=sorted(errs.items(), key=lambda kv: -kv[1])[:3], **grads_row)
            row["single_losses"] = single["losses"]
        del m_whole
        if shape == meshes[0]:
            if len(meshes) > 1:  # step 3, against the restored state's
                row["losses"].append(step3())
                lap(f"{name} compared, step 3")
        else:  # the (2, 2) state restored under this layout, and its step 3
            t0 = time.perf_counter()
            manager.wait()  # until device 0 has written the (2, 2) state
            row["save_wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            sh = {"params": {k: comm.sharding(specs[k]) for k in named}, "m": {k: comm.sharding(specs[k]) for k in named},
                  "v": {k: comm.sharding(specs[k]) for k in named}, "step": comm.sharding(())}  # device 0 scatters
            got, at = manager.restore({"params": named, "m": opt["m"], "v": opt["v"], "step": opt["step"]}, shardings=sh)
            row["restore_s"] = time.perf_counter() - t0
            row["restored_from_step"] = at
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(got["params"][k])
                    opt["m"][k].copy_(got["m"][k])
                    opt["v"][k].copy_(got["v"][k])
            row["restored_step"] = int(got["step"])
            back = cell.program.whole(cell.params, dst=0)
            if rank == 0:
                row["restore_bit_for_bit"] = all(torch.equal(back[k].cpu(), saved_whole[k]) for k in saved_whole)
            del got, back
            row["restored_step3_loss"] = step3()
            lap(f"{name} restored the (2, 2) state, step 3")
        report[name] = row
        del cell, whole, opt, named  # the layout's state, before the next's peak is read
        gc.collect()
        torch.cuda.empty_cache()

    # (b) compressed_psum_pod over the four ranks, the card against the host
    pods = make_mesh((world,), ("pod",))
    comm = DistComm(pods, rank, job["backend"], staged=job["staged"])
    x = torch.from_numpy(np.random.default_rng(240 + rank).standard_normal(1 << 20).astype(np.float32))
    psum = compressed_psum_pod(x.to(dev), comm, "pod").cpu()
    if job["backend"] == "gloo":  # the same exchanges of host tensors
        on_host = compressed_psum_pod(x, DistComm(pods, rank, "gloo"), "pod")
        report["psum_bit_for_bit"] = same_bits(psum, on_host)
    exact = comm.all_reduce(x.to(dev), ("pod",)).cpu()
    top = comm.all_reduce(x.abs().max().to(dev), ("pod",), op="max").cpu()
    report["psum"] = {"max_abs_err": float((psum - exact).abs().max()),
                      "bound": float(top) / 127 * world * 1.5}  # the reference's bound (test_distributed.py:199)
    lap("compressed_psum_pod")

    # (b) the pipeline of the model's blocks over four stages
    pipe = dataclasses.replace(cut, num_layers=job["pipe_layers"] or cut.num_layers)
    stages = make_mesh((world,), ("stage",))
    comm = DistComm(stages, rank, job["backend"], staged=job["staged"])
    with torch.no_grad():
        params = api.init(torch.Generator(device=dev).manual_seed(1), pipe, device=dev)
        blocks = [blk for _, _, _, blk in T._layers(params, pipe)]
        per = len(blocks) // world
        x_micro = L.embed(params.embed, tokens, pipe)[:job["pipe_micro"], None]  # [M, 1, S, d]

        def block_fn(stage_blocks, h):
            for blk in stage_blocks:
                h, _, _ = T._block_forward(blk, h, pipe, None)
            return h

        flash_attention_cuda.launches = 0
        out, pipe_ms = sync_ms(lambda: pipeline_forward(block_fn, blocks[rank * per:(rank + 1) * per], x_micro, comm))
        report["pipeline"] = {"layers": len(blocks), "stages": world, "microbatches": int(x_micro.shape[0]),
                              "ms": pipe_ms, "launches": flash_attention_cuda.launches}
        if rank == 0:
            seq = torch.stack([block_fn(blocks, xm) for xm in x_micro])
            scale = float(seq.float().abs().max())
            report["pipeline"]["max_abs_err"] = float((out.float() - seq.float()).abs().max())
            report["pipeline"]["scale"] = scale
    del params, blocks
    lap("the pipeline")
    (out_dir / f"rank_{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def sharded_kernel_class(name: str) -> str:
    """An NCCL kernel's collective, else the kernel's family."""
    for kind in ("AllGather", "ReduceScatter", "AllReduce", "SendRecv", "AllToAll"):
        if "nccl" in name.lower() and kind.lower() in name.lower():
            return f"nccl {kind}"
    return "nccl other" if "nccl" in name.lower() else kernel_class(name)


def run_sharded(job: dict, timeout: float, child: str = "sharded_child", name: str = "phase24") -> list[dict]:
    """Start a phase's ranks (phase 24's, or ``child``'s) as children of
    this process, each a rank of ``job``; wait for all (a failed rank fails
    the phase at once); their reports."""
    repo = Path(__file__).resolve().parent
    out_dir = repo / "build" / f"{name}_{job['backend']}"
    if out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), OMP_NUM_THREADS="2")
    logs, procs = [], []
    for rank in range(job["world"]):
        env["SHARDED_CHILD"] = json.dumps({**job, "rank": rank, "dir": str(out_dir)})
        log = open(out_dir / f"log_{rank}.txt", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.{child}()"],
                                      env=env, cwd=repo, stdout=log, stderr=subprocess.STDOUT))

    def stop() -> None:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        stop()
        for log in logs:
            log.close()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    text = "".join(f"--- rank {r} ---\n{(out_dir / f'log_{r}.txt').read_text()[-2500:]}" for r, _ in failed)
    check(not failed, f"{name} ranks {failed} failed or outlasted {timeout} s:\n{text}")
    return [json.loads((out_dir / f"rank_{r}.json").read_text()) for r in range(job["world"])]


def sharded_report(job: dict, reports: list[dict], label: str) -> dict[str, int]:
    """Phase 24's checks on the ranks' reports, printed (the reports first,
    whole); returns the flash kernel's launches by path."""
    print(json.dumps({f"sharded_{label}": reports}), flush=True)
    layers = job["layers"] or 36
    by_path = {}
    meshes = [tuple(m) for m in job["meshes"]]
    for shape in meshes:
        name = f"({shape[0]}, {shape[1]})"
        for r in reports:
            row = r[name]
            tag = f"sharded {label} {name} rank {r['rank']}"
            check(row["counted"] == row["plan"], f"{tag}: arguments, FLOPs, kernel calls and exchanges == the "
                                                 f"dry-run's: {row['counted']} against {row['plan']}")
            check(row["launches_step1"] == 2 * layers, f"{tag}: {row['launches_step1']} flash launches, expected "
                                                       f"{2 * layers}")
            by_path[f"sharded train {label} {name} rank {r['rank']}"] = row["launches_step1"]
            ratio = row["plan_peak_bytes"] / row["max_memory_allocated"]
            print(f"{tag}: layout {row['layout']['attention']}; arguments {row['counted']['arguments']:,} B, FLOPs "
                  f"{row['counted']['flops']:.6e}, exchanges {row['counted']['collective_counts']} "
                  f"{ {k: round(v / 1e9, 6) for k, v in row['counted']['collective_bytes'].items()} } GB == the "
                  f"dry-run's; flash launches {row['launches_step1']}; losses {row['losses']}; step 2 "
                  f"{row['step2_ms']:.1f} ms; peak {row['max_memory_allocated'] / 1e9:.3f} GB "
                  f"(dry-run {row['plan_peak_bytes'] / 1e9:.3f} GB, ratio {ratio:.4f}); seconds {r['seconds']}",
                  flush=True)
            if row.get("profile"):
                print(f"{tag}: profiled step {json.dumps(row['profile'].get('by_class'))}", flush=True)
        row0 = reports[0][name]
        single = row0["single_losses"]
        if job["backend"] == "gloo":
            for r in reports:
                d = [abs(a - b) for a, b in zip(r[name]["losses"][:2], single[:2])]
                check(max(d) <= SHARDED_TOL["loss"], f"sharded {label} {name} rank {r['rank']}: losses "
                                                     f"{r[name]['losses'][:2]} against one device's {single[:2]}")
            check(not row0["grads_over_tolerance"], f"sharded {label} {name}: first gradients within "
                                                    f"{GRAD_TOL['atol']} + {GRAD_TOL['rel']}·max|g| of one device's: "
                                                    f"{row0['grads_over_tolerance']}")
            check(row0["params_close"], f"sharded {label} {name}: parameters after 2 steps within atol "
                                        f"{SHARDED_TOL['atol']}, rtol {SHARDED_TOL['rtol']} outside AdamW's eps regime, "
                                        f"within {EPS_REGIME_ATOL} in it: "
                                        f"{row0['params_over_tolerance_outside_eps_regime']} elements over, eps regime "
                                        f"max {row0['eps_regime_max_abs_err']}")
            print(f"sharded {label} {name}: first gradients (from AdamW's m after step 1) against one device's, max "
                  f"err {row0['grads_max_rel_err']:.3e} of each tensor's largest", flush=True)
        else:
            for r in reports:
                for a, b in zip(r[name]["losses"][:2], single[:2]):
                    check(abs(a - b) <= FOUR_CARD_LOSS_RTOL * abs(b), f"sharded {label} {name} rank {r['rank']}: "
                                                                      f"loss {a} against one card's {b}")
            for r in reports:
                ratio = r[name]["plan_peak_bytes"] / r[name]["max_memory_allocated"]
                check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1], f"sharded {label} {name} rank {r['rank']}: dry-run peak "
                                                             f"within {PEAK_BAND} of max_memory_allocated ({ratio:.4f})")
        print(f"sharded {label} {name}: one device's losses {single}; parameters gathered whole after step 2, "
              f"max abs err {row0['param_max_abs_err']:.3e}; {row0['params_over_tolerance']} elements over atol "
              f"{SHARDED_TOL['atol']} + rtol {SHARDED_TOL['rtol']}, {row0['params_over_tolerance_outside_eps_regime']} of "
              f"them outside AdamW's eps regime (0 < |g1| < {EPS_REGIME}: {row0['eps_regime_elements']} elements, max abs "
              f"err {row0['eps_regime_max_abs_err']:.3e}, held within {EPS_REGIME_ATOL}); largest "
              f"{row0['worst_params']}", flush=True)
    if len(meshes) > 1:
        two, four = (f"({a}, {b})" for a, b in meshes[:2])
        r0 = reports[0][four]
        check(r0["restore_bit_for_bit"], f"sharded {label}: the {two} state restored under {four} bit for bit")
        for r in reports:
            a, b = r[four]["restored_step3_loss"], reports[0][two]["losses"][2]
            tol = SHARDED_TOL["loss"] if job["backend"] == "gloo" else FOUR_CARD_LOSS_RTOL * abs(b)
            check(r[four]["restored_step"] == 2 and r[four]["restored_from_step"] == 2 and abs(a - b) <= tol,
                  f"sharded {label} rank {r['rank']}: step 3 from the restored state {a} against {two}'s {b}")
        print(f"sharded {label}: {two} state after step 2 gathered in {reports[0][two]['save_gather_s']:.1f} s and "
              f"written by rank 0 in the background (waited {max(r[four]['save_wait_s'] for r in reports):.1f} s "
              f"more), restored under {four} in {max(r[four]['restore_s'] for r in reports):.1f} s, bit for bit; "
              f"step 3 {[r[four]['restored_step3_loss'] for r in reports]} against {reports[0][two]['losses'][2]}",
              flush=True)
    if job["backend"] == "gloo":
        check(all(r["psum_bit_for_bit"] for r in reports),
              f"sharded {label}: compressed_psum_pod on the card == on the host, bit for bit")
    for r in reports:
        check(r["psum"]["max_abs_err"] <= r["psum"]["bound"], f"sharded {label}: compressed_psum_pod {r['psum']}")
    pipe = reports[0]["pipeline"]
    rtol = PIPE_RTOL[job["dtype"] or "bfloat16"]
    check(pipe["max_abs_err"] <= rtol * pipe["scale"], f"sharded {label}: the pipeline {pipe}")
    launches = sum(r["pipeline"]["launches"] for r in reports)
    check(launches == pipe["layers"] * pipe["microbatches"],
          f"sharded {label}: {launches} flash launches in the pipeline, expected one a layer and microbatch")
    by_path[f"pipeline {label}"] = launches
    print(f"sharded {label}: compressed_psum_pod card == host bit for bit: {reports[0].get('psum_bit_for_bit')}; "
          f"pipeline of {pipe['layers']} layers in {pipe['stages']} stages x {pipe['microbatches']} microbatches "
          f"{pipe['ms']:.1f} ms, max abs err {pipe['max_abs_err']:.3e} of {pipe['scale']:.3e} against the blocks in "
          f"sequence (rtol {rtol})", flush=True)
    return by_path


#: phase 24 (a), the families beside qwen2.5-3b: four gloo ranks on the one
#: card, staged through the host, each model at full width in f32 (TF32 off)
#: cut in depth (zamba2-7b to ``ZAMBA_LAYERS``, one shared invocation;
#: whisper-base to 2 + 2 behind 1500 frames from a seed), on (2, 2) under
#: seqpar for two AdamW steps against one device's unsharded steps on rank
#: 0: every count and each kernel's launches against the plan's, the peak
#: beside the plan's; both steps' gradients (from AdamW's m) within
#: ``GRAD_TOL``; the parameters after step 1 within ``SHARDED_TOL`` outside
#: AdamW's eps regime and within ``EPS_REGIME_ATOL`` in it (the rule is
#: derived for AdamW's first move); after step 2 within ``EPS_REGIME_ATOL``:
#: at full width a second move on a gradient near zero, or on a first
#: moment that nearly cancels, turns a difference that ``GRAD_TOL`` holds
#: into one past ``SHARDED_TOL`` (gemma2-2b: 4.09e-4 where g1 -1.06e-07 and
#: g2 -8.3e-08; stablelm-1.6b: 3.01e-4 where g1 -8.76e-07 and g2 1.21e-06).
#: internvl2-76b runs on four cards only: at 2 layers it is 15 GB of f32
#: weights, staged through the host on every step here
FAMILIES = ("mamba2-780m", "zamba2-7b", "whisper-base", "gemma2-2b", "stablelm-1.6b")
FAMILY_LAYERS = {"mamba2-780m": 2, "zamba2-7b": ZAMBA_LAYERS, "whisper-base": 2, "gemma2-2b": 2,
                 "stablelm-1.6b": 2, "internvl2-76b": 1}
SHARDED_FAMILIES_ONE_CARD = {"backend": "gloo", "staged": True, "world": 4, "cards": 1, "mesh": [2, 2],
                             "policy": "seqpar", "runs": [
    {"arch": arch, "layers": FAMILY_LAYERS[arch], "dtype": "float32", "batch": 4, "seq": 512, "against_one": True}
    for arch in FAMILIES]}
#: phase 24 (d), four cards over NCCL (``four_card_main``, or
#: ``sharded_families_phase()`` alone), (2, 2) under seqpar: (i) the six in
#: f32 at the one card's depths (internvl2-76b at 1 layer behind 256
#: patches) against one card's unsharded steps, held as (a); (ii) each at
#: full depth in bf16 at 4 x 1024 (internvl2-76b at ``FIT_LAYERS``, the
#: deepest whose plan fits ``FIT_LIMIT_BYTES`` a card, found on meta), the
#: loss against one card's bf16 steps where one card holds the model and
#: AdamW's state, with step 2 timed and step 3 profiled
FIT_LAYERS = {"internvl2-76b": 23}  # 70.66 GB a card planned; 24: 73.22 (measured 73.27)
SHARDED_FAMILIES_FOUR_CARDS = {"backend": "nccl", "staged": False, "world": 4, "cards": 4, "mesh": [2, 2],
                               "policy": "seqpar", "runs": [
    *({"arch": arch, "layers": FAMILY_LAYERS[arch], "dtype": "float32", "batch": 4, "seq": 512, "against_one": True}
      for arch in (*FAMILIES, "internvl2-76b")),
    *({"arch": arch, "layers": FIT_LAYERS.get(arch), "dtype": None, "batch": 4, "seq": 1024, "against_one": False,
       "profile": True} for arch in (*FAMILIES, "internvl2-76b"))]}
#: one card holds a model's bf16 step where its weights, gradients and AdamW's
#: two f32 moments (12 bytes a parameter) fit this many bytes
ONE_CARD_STATE_BYTES = 60e9


def sharded_family_child() -> None:
    """One rank of phase 24 (a) or (d) (``SHARDED_CHILD`` in the
    environment: its rank, the group's runs and the directory it reports
    to)."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.distributed.comm import DistComm, take_local
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_grad_fn

    job = json.loads(os.environ["SHARDED_CHILD"])
    rank, world, out_dir = job["rank"], job["world"], Path(job["dir"])
    torch.set_num_threads(2)
    card = rank % job["cards"]
    dev = torch.device("cuda", card)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(job["backend"], init_method=f"file://{out_dir / 'store'}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=900))
    mesh = make_mesh(tuple(job["mesh"]), ("data", "model"))
    comm = DistComm(mesh, rank, job["backend"], staged=job["staged"])
    pol = dryrun.POLICIES[job["policy"]]
    wrappers = {"flash_attention": flash_attention_cuda, "ssd_scan": ssd_scan_cuda}
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant")
    report: dict = {"rank": rank, "card": card, "backend": job["backend"], "staged": job["staged"], "runs": []}

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    for run in job["runs"]:
        t_run = time.perf_counter()
        api = get_model(run["arch"])
        cfg = api.config
        if run["layers"] is not None:  # an encoder-decoder cut as deep on both sides
            cut = {"enc_layers": run["layers"]} if cfg.family == "encdec" else {}
            cfg = dataclasses.replace(cfg, num_layers=run["layers"], **cut)
        if run["dtype"]:
            cfg = dataclasses.replace(cfg, dtype=run["dtype"])
        B, S = run["batch"], run["seq"]
        rng = np.random.default_rng(24)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)}
        name, rows = {"vlm": ("patches", cfg.num_patches), "encdec": ("frames", cfg.enc_frames)}.get(
            cfg.family, (None, 0))
        if name is not None:  # the family's inputs beside the tokens, the same on every rank
            x = rng.standard_normal((B, rows, cfg.d_model)) * 0.1
            batch[name] = torch.from_numpy(x.astype(np.float32)).to(dev, getattr(torch, cfg.dtype))
        suite = ShapeSuite(f"train_{B}x{S}", "train", S, B)
        n_params = cfg.param_count()
        row: dict = {"arch": run["arch"], "family": cfg.family, "layers": cfg.num_layers,
                     "enc_layers": cfg.enc_layers if cfg.family == "encdec" else None, "dtype": cfg.dtype,
                     "batch": B, "seq": S, "extras": {k: list(v.shape) for k, v in batch.items() if k != "tokens"},
                     "params": n_params}
        plan = dryrun.build_cell(run["arch"], suite, mesh, pol, cfg=cfg, opt_cfg=opt_cfg,
                                 batch={k: v.to("meta") for k, v in batch.items()})
        _, planned = dryrun.count_cell(plan, scopes=False)
        del plan
        gen = torch.Generator(device=dev).manual_seed(0)  # the model drawn a module at a time, sliced
        cell, row["build_s"] = sync_s(lambda: dryrun.build_cell(run["arch"], suite, mesh, pol, cfg=cfg, comm=comm,
                                                                source=gen, batch=batch, opt_cfg=opt_cfg))
        free()
        for w in wrappers.values():
            w.launches = 0
        row["allocated_before_step1"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ((_, opt, m1), counted), row["step1_s"] = sync_s(lambda: dryrun.count_cell(cell, scopes=False))
        row["step1_max_memory_allocated"] = torch.cuda.max_memory_allocated()  # counted: Python's collector off
        row["launches"] = {k: w.launches for k, w in wrappers.items()}
        specs = cell.program.specs
        held = run["against_one"]

        def mine(tensors: dict) -> dict:
            """This rank's slices, copied to the host (a step updates the live ones in place)."""
            return {k: tensors[k].detach().to("cpu", copy=True) for k in specs} if held else {}

        m1_sh, p1_sh = mine(opt["m"]), mine(dict(cell.params.named_parameters()))  # after step 1
        torch.cuda.reset_peak_memory_stats()
        (_, opt, m2), ms2 = sync_s(cell.run)
        row.update(step2_ms=1e3 * ms2, max_memory_allocated=torch.cuda.max_memory_allocated(),
                   plan_peak_bytes=planned.memory()["peak_bytes"], counted=plan_counts(counted),
                   plan=plan_counts(planned), layout=dryrun.layout(cell.program),
                   losses=[float(m1["loss"]), float(m2["loss"])],
                   grad_norms=[float(m1["grad_norm"]), float(m2["grad_norm"])])
        m2_sh, p2_sh = mine(opt["m"]), mine(dict(cell.params.named_parameters()))
        if run.get("profile"):  # step 3, where the exchanges are NCCL's kernels on the card
            row["profile"] = device_time_breakdown(cell.run, classify=sharded_kernel_class)
        del cell, opt
        free()
        holds = n_params * 12 <= ONE_CARD_STATE_BYTES
        row["one_card_holds"] = holds

        def against_one() -> None:
            """One device's two steps of the whole model on this rank's card
            (the same weights; each step's two halves, so that its gradients
            are seen whole), each of this rank's slices held against its
            share of them: both steps' gradients (the sharded run's from
            AdamW's m), the parameters after each step."""
            one = L.trainable(api.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev))
            state = adamw.init(opt_cfg, one)
            grad_fn = make_grad_fn(api, cfg, remat=True)
            single, g_one, p_one, tops = [], [], [], []
            for _ in range(2):
                grads, metrics = grad_fn(one, batch)
                single.append(float(metrics["loss"]))
                if held:  # this rank's share of the step's gradient, and each tensor's largest
                    g_one.append({k: take_local(g, specs[k], mesh, rank).cpu() for k, g in grads.items()})
                    tops.append({k: float(g.abs().max()) for k, g in grads.items()})
                one, state, _ = adamw.update(opt_cfg, grads, state, one)
                del grads
                if held:
                    p_one.append({k: take_local(p.detach(), specs[k], mesh, rank).cpu()
                                  for k, p in one.named_parameters()})
            row["single_losses"] = single
            del one, state
            free()
            if not held:
                return
            b1 = opt_cfg.beta1
            clip = [min(1.0, opt_cfg.grad_clip / (x + 1e-9)) for x in row["grad_norms"]]
            # the sharded run's gradients from AdamW's m: g1 = m1 / ((1 - b1)·clip1), g2 = (m2 - b1·m1) /
            # ((1 - b1)·clip2)
            g_sh = [{k: m1_sh[k] / ((1 - b1) * clip[0]) for k in specs},
                    {k: (m2_sh[k] - b1 * m1_sh[k]) / ((1 - b1) * clip[1]) for k in specs}]
            tiny_of = {}
            for n in (1, 2):
                worst, over = 0.0, []
                for k, ref in g_one[n - 1].items():
                    ref = ref.to(dev)
                    err, top = float((g_sh[n - 1][k].to(dev) - ref).abs().max()), tops[n - 1][k]
                    worst = max(worst, err / top if top else err)
                    if err > GRAD_TOL["atol"] + GRAD_TOL["rel"] * top:
                        over.append([k, err, top])
                    if n == 1:
                        tiny_of[k] = (ref != 0) & (ref.abs() < EPS_REGIME)
                row[f"grads{n}"] = {"max_rel_err": worst, "over_tolerance": over}
            for n, got_of in ((1, p1_sh), (2, p2_sh)):
                errs, n_over, outside, regime, regime_err = {}, 0, 0, 0, 0.0
                for k, ref in p_one[n - 1].items():
                    ref = ref.to(dev).float()
                    d = (got_of[k].to(dev).float() - ref).abs()
                    bad = d > SHARDED_TOL["atol"] + SHARDED_TOL["rtol"] * ref.abs()
                    tiny = tiny_of[k]
                    errs[k] = float(d.max())
                    n_over += int(bad.sum())
                    outside += int((bad & ~tiny).sum())
                    regime += int(tiny.sum())
                    if tiny.any():
                        regime_err = max(regime_err, float(d[tiny].max()))
                row[f"params{n}"] = {"max_abs_err": max(errs.values()), "over_tolerance": n_over,
                                     "over_tolerance_outside_eps_regime": outside, "eps_regime_elements": regime,
                                     "eps_regime_max_abs_err": regime_err,
                                     "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3]}

        # one device's steps: on every rank against its own slices (on one
        # card two ranks at a time, so that two whole models are held at
        # once), or on rank 0 alone for a bf16 loss
        turns = world // 2 if held and job["cards"] == 1 else 1
        for turn in range(turns):
            if (held and (turns == 1 or rank // 2 == turn)) or (not held and holds and rank == 0):
                against_one()
                free()
            dist.barrier()
        del m1_sh, p1_sh, m2_sh, p2_sh
        free()
        dist.barrier()
        row["seconds"] = time.perf_counter() - t_run
        report["runs"].append(row)
        (out_dir / f"rank_{rank}.json").write_text(json.dumps(report))  # what is done so far, if a later run fails
    dist.barrier()
    dist.destroy_process_group()


def sharded_family_report(job: dict, reports: list[dict], label: str) -> dict[str, dict[str, int]]:
    """Phase 24 (a) / (d)'s checks on the ranks' reports, printed (the
    reports first, whole); returns each kernel's launches by path."""
    print(json.dumps({f"sharded_families_{label}": reports}), flush=True)
    by_path: dict[str, dict[str, int]] = {"flash_attention": {}, "ssd_scan": {}}
    mesh = tuple(job["mesh"])
    n_cards = job["cards"]
    for i, run in enumerate(job["runs"]):
        rows = [r["runs"][i] for r in reports]
        row0 = rows[0]
        depth = f"{row0['layers']} + {row0['enc_layers']}" if row0["enc_layers"] else f"{row0['layers']}"
        tag = f"sharded {label} {run['arch']} {depth} layers {row0['dtype']} {mesh} {job['policy']}"
        calls = plan_calls(row0["plan"]["kernels"])
        for r, row in zip(reports, rows):
            check(row["counted"] == row["plan"], f"{tag} rank {r['rank']}: arguments, FLOPs, kernel calls and "
                                                 f"exchanges == the dry-run's: {row['counted']} against {row['plan']}")
            for kernel, n in row["launches"].items():
                check(n == calls[kernel], f"{tag} rank {r['rank']}: {n} {kernel} launches in step 1, the plan's "
                                          f"{calls[kernel]}")
                if n:
                    by_path[kernel][f"{tag} rank {r['rank']}"] = n
            check(all(math.isfinite(x) for x in row["losses"] + row["grad_norms"]), f"{tag}: finite losses and norms")
        ratios = [row["plan_peak_bytes"] / row["max_memory_allocated"] for row in rows]
        tokens = row0["batch"] * row0["seq"]
        bound_ms = 1e3 * 6 * row0["params"] * tokens / (BF16_OPS_PER_S * n_cards)  # a card's share at bf16's peak
        step_ms = max(row["step2_ms"] for row in rows)
        print(f"{tag}: {row0['params']:,} parameters, batch {row0['batch']} x {row0['seq']} {row0['extras'] or ''}; "
              f"layout {row0['layout']['attention']} {row0['layout']['modules']} sequence parallel "
              f"{row0['layout']['sequence_parallel']}; counts == the dry-run's (exchanges "
              f"{row0['counted']['collective_counts']}, "
              f"{ {k: round(v / 1e9, 6) for k, v in row0['counted']['collective_bytes'].items()} } GB); launches "
              f"{row0['launches']} == the plan's calls; losses {row0['losses']}; step 2 {step_ms:.1f} ms "
              f"({tokens / step_ms * 1e3 / n_cards:.1f} tokens/s a card; 6·N·tokens at 989 TFLOP/s {bound_ms:.3f} ms); "
              f"peak {max(row['max_memory_allocated'] for row in rows) / 1e9:.3f} GB (dry-run "
              f"{row0['plan_peak_bytes'] / 1e9:.3f} GB, ratios {[round(x, 4) for x in ratios]}; the counted step 1 "
              f"{max(row['step1_max_memory_allocated'] for row in rows) / 1e9:.3f} GB); built "
              f"{row0['build_s']:.1f} s, step 1 {row0['step1_s']:.1f} s, run {max(row['seconds'] for row in rows):.1f} s",
              flush=True)
        for row in rows:
            if row.get("profile"):
                prof = row["profile"]
                nccl = sum(v["ms"] for k, v in (prof.get("by_class") or {}).items() if k.startswith("nccl"))
                print(f"{tag}: profiled step 3 {prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} ms, "
                      f"idle {prof['device_idle_share']:.4f}, NCCL {nccl:.1f} ms; by class "
                      f"{json.dumps(prof.get('by_class'))}", flush=True)
                break
        if run["against_one"]:
            single = row0["single_losses"]
            for r, row in zip(reports, rows):
                d = [abs(a - b) for a, b in zip(row["losses"], single)]
                check(max(d) <= SHARDED_TOL["loss"], f"{tag} rank {r['rank']}: losses {row['losses']} against one "
                                                     f"device's {single}")
            grads = {n: {"max_rel_err": max(row[f"grads{n}"]["max_rel_err"] for row in rows),
                         "over_tolerance": [x for row in rows for x in row[f"grads{n}"]["over_tolerance"]]}
                     for n in (1, 2)}
            params = {n: {"max_abs_err": max(row[f"params{n}"]["max_abs_err"] for row in rows),
                          **{k: sum(row[f"params{n}"][k] for row in rows) for k in (
                              "over_tolerance", "over_tolerance_outside_eps_regime", "eps_regime_elements")},
                          "eps_regime_max_abs_err": max(row[f"params{n}"]["eps_regime_max_abs_err"] for row in rows),
                          "worst": sorted((w for row in rows for w in row[f"params{n}"]["worst"]),
                                          key=lambda kv: -kv[1])[:3]}
                      for n in (1, 2)}
            for n, which in ((1, "first"), (2, "second")):
                check(not grads[n]["over_tolerance"], f"{tag}: {which} gradients within {GRAD_TOL['atol']} + "
                                                      f"{GRAD_TOL['rel']}·max|g| of one device's: "
                                                      f"{grads[n]['over_tolerance']}")
            p1, p2 = params[1], params[2]
            check(p1["over_tolerance_outside_eps_regime"] == 0 and p1["eps_regime_max_abs_err"] <= EPS_REGIME_ATOL,
                  f"{tag}: parameters after step 1 within atol {SHARDED_TOL['atol']}, rtol {SHARDED_TOL['rtol']} "
                  f"outside AdamW's eps regime, within {EPS_REGIME_ATOL} in it: {p1}")
            check(p2["max_abs_err"] <= EPS_REGIME_ATOL, f"{tag}: parameters after step 2 within {EPS_REGIME_ATOL}: {p2}")
            print(f"{tag}: one device's losses {single}; each rank's slices against it: gradients max err "
                  f"{grads[1]['max_rel_err']:.3e} (step 1), {grads[2]['max_rel_err']:.3e} (step 2) of each tensor's "
                  f"largest; parameters after step 1 max abs err {p1['max_abs_err']:.3e}, {p1['over_tolerance']} "
                  f"elements over atol + rtol, all in AdamW's eps regime ({p1['eps_regime_elements']} elements "
                  f"summed over the ranks' slices, max {p1['eps_regime_max_abs_err']:.3e}); after step 2 max abs err "
                  f"{p2['max_abs_err']:.3e}, {p2['over_tolerance']} over atol + rtol, "
                  f"{p2['over_tolerance_outside_eps_regime']} of them outside the first step's eps regime; largest "
                  f"{p2['worst']}", flush=True)
        elif row0["one_card_holds"]:
            single = row0["single_losses"]
            for r, row in zip(reports, rows):
                for a, b in zip(row["losses"], single):
                    check(abs(a - b) <= FOUR_CARD_LOSS_RTOL * abs(b), f"{tag} rank {r['rank']}: loss {a} against "
                                                                      f"one card's {b}")
            print(f"{tag}: losses within {FOUR_CARD_LOSS_RTOL} of one card's bf16 {single}", flush=True)
        else:
            print(f"{tag}: one card does not hold its bf16 step ({row0['params'] * 12 / 1e9:.1f} GB of weights, "
                  f"gradients and moments): no one-card loss", flush=True)
    return by_path


def fit_layers(arch: str, mesh_shape, policy: str, batch: int, seq: int) -> tuple[int, int, int | None]:
    """The deepest cut of ``arch`` in bf16 whose training step's dry-run peak
    a card (AdamW's f32 moments included) at ``batch`` x ``seq`` on
    ``mesh_shape`` under ``policy`` is at most ``FIT_LIMIT_BYTES``,
    found on meta; with its peak and the next depth's (None at full
    depth)."""
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model
    from repro_torch.optim import adamw

    cfg = get_model(arch).config
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"))

    def peak(n: int) -> int:
        plan = dryrun.build_cell(arch, ShapeSuite("train", "train", seq, batch), mesh, dryrun.POLICIES[policy],
                                 cfg=dataclasses.replace(cfg, num_layers=n),
                                 opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=0, schedule="constant"))
        return dryrun.count_cell(plan, scopes=False)[1].memory()["peak_bytes"]

    return largest_fit(peak, cfg.num_layers)


def sharded_phase() -> dict[str, dict[str, int]]:
    """Phase 24 (a)-(b) on the one card; (c) where the host has four.
    Returns each kernel's launches by path."""
    print(f"phase 24: exchanges {SHARDED_ONE_CARD['backend']}, staged through the host: {SHARDED_ONE_CARD['staged']}",
          flush=True)
    by_path = {"flash_attention": sharded_report(SHARDED_ONE_CARD, run_sharded(SHARDED_ONE_CARD, 600), "one card")}
    families = sharded_family_report(
        SHARDED_FAMILIES_ONE_CARD, run_sharded(SHARDED_FAMILIES_ONE_CARD, 900, child="sharded_family_child",
                                               name="phase24a"), "one card")
    for name, run in families.items():
        by_path.setdefault(name, {}).update(run)
    if torch.cuda.device_count() >= 4:
        by_path["flash_attention"].update(sharded_report(SHARDED_FOUR_CARDS, run_sharded(SHARDED_FOUR_CARDS, 1200),
                                                         "four cards"))
    else:
        print("phase 24 (c), (d): one card here; the four-card run is `python3 -c \"import chip_smoke; "
              "chip_smoke.four_card_main()\"` on a host of four", flush=True)
    return by_path


def sharded_families_phase() -> dict[str, dict[str, int]]:
    """Phase 24 (d) on four cards: internvl2-76b's depth found on meta and
    printed, then the four NCCL ranks of ``SHARDED_FAMILIES_FOUR_CARDS``."""
    job = SHARDED_FAMILIES_FOUR_CARDS
    for arch, want in FIT_LAYERS.items():
        n, at, past = fit_layers(arch, job["mesh"], job["policy"], 4, 1024)
        nxt = "full depth" if past is None else f"{n + 1} layers: {past / 1e9:.3f} GB"
        print(f"phase 24 (d) {arch}: {n} layers fit, the dry-run's peak {at / 1e9:.3f} GB a card ({nxt}; at most "
              f"{FIT_LIMIT_BYTES / 1e9:.0f} GB)", flush=True)
        check(n == want, f"{arch}: the depth that fits, {n}, is FIT_LAYERS's")
    return sharded_family_report(job, run_sharded(job, 2400, child="sharded_family_child", name="phase24d"),
                                 "four cards")


#: phase 25: sharded serving under serve-tp on (data 1, model 4), a group of
#: four ranks: (a) on the one card over gloo staged through the host, each
#: model at full width cut to 2 layers in f32 (zamba2-7b to 6, one shared
#: invocation; whisper-base to 2 + 2), the first four of the serving run's
#: prompts cut to the shortest of them as one batch (internvl2-76b's behind
#: 256 patches, whisper-base's behind 1500 frames, from a seed), then 8
#: greedy ticks; (b) on four cards
#: over NCCL (``four_card_main``): mixtral-8x7b at 8 layers in f32 and at all
#: 32 in bf16, qwen2.5-3b at all 36 in f32, over the serving run's 8 prompts
#: (cut to the shortest) and 32 ticks, and each model's ``decode_32k`` cell
#: in bf16 (batch 128, a cache of 32,768 positions drawn from a seed). Each
#: ``max_len`` is cut so that the prompts and ticks fill several of
#: qwen2.5-3b's four shares of the cache's sequence and leave the last
#: empty: (a) 369 + 8 positions in shares of 128, (b) 142 + 32 in shares of
#: 64, so the combine merges live shares and weighs an empty one nothing;
#: internvl2-76b's cache holds its 256 patches too (a run's own ``max_len``)
SERVE_SHARDED_ONE_CARD = {"backend": "gloo", "staged": True, "world": 4, "cards": 1, "max_len": 512, "runs": [
    {"arch": "qwen2.5-3b", "layers": 2, "dtype": "float32", "prompts": 4, "ticks": 8, "against_one": True,
     "full_tick": True},
    {"arch": "mixtral-8x7b", "layers": 2, "dtype": "float32", "prompts": 4, "ticks": 8, "against_one": True,
     "full_tick": True},
    {"arch": "deepseek-67b", "layers": 2, "dtype": "float32", "prompts": 4, "ticks": 8, "against_one": True,
     "full_tick": True},
    {"arch": "internvl2-76b", "layers": 2, "dtype": "float32", "prompts": 4, "ticks": 8, "against_one": True,
     "full_tick": True, "max_len": 1024},
    # the six remaining architectures: whisper-base at 2 encoder and 2
    # decoder layers behind 1500 frames, zamba2-7b at 6 (2 hold no shared
    # invocation); mamba2-780m and zamba2-7b at 2 ticks: a Mamba2 block
    # computes whole, so each step gathers its f32 weights through the host
    # over gloo (130 MB a tick for mamba2-780m's 2 layers, 0.45-0.91 s;
    # 1.9 GB for zamba2-7b's 6, 5.0 s)
    *({"arch": arch, "layers": layers, "dtype": "float32", "prompts": 4, "ticks": ticks, "against_one": True,
       "full_tick": True} for arch, layers, ticks in (
        ("mamba2-780m", 2, 2), ("zamba2-7b", 6, 2), ("whisper-base", 2, 8), ("gemma2-2b", 2, 8),
        ("stablelm-1.6b", 2, 8), ("qwen3-moe-30b-a3b", 2, 8))),
]}
SERVE_SHARDED_FOUR_CARDS = {"backend": "nccl", "staged": False, "world": 4, "cards": 4, "max_len": 256, "runs": [
    {"arch": "mixtral-8x7b", "layers": 8, "dtype": "float32", "prompts": 8, "ticks": 32, "against_one": True},
    {"arch": "mixtral-8x7b", "layers": None, "dtype": None, "prompts": 8, "ticks": 32, "against_one": False,
     "decode_32k": True},
    {"arch": "qwen2.5-3b", "layers": None, "dtype": "float32", "prompts": 8, "ticks": 32, "against_one": True},
    {"arch": "qwen2.5-3b", "layers": None, "dtype": None, "prompts": 0, "ticks": 0, "against_one": False,
     "decode_32k": True},
]}
#: phase 25 (c): the two models that fit no card (``FOUR_CARDS``), on four
#: cards over NCCL (``four_card_main``, after 25 (b)): each (i) at 8 layers
#: in f32 against one card's run of the same 8 layers, over the serving
#: run's 8 prompts cut to the shortest (142 tokens; internvl2-76b's behind
#: 256 patches) and 32 ticks; (ii) at full depth in bf16 (95 and 80 layers:
#: 67 and 76 billion parameters, each rank drawing a module at a time) over
#: the same prompts and ticks, with a tick at a full cache of ``max_len``;
#: (iii) a full 32k cache at the batch that fits (``FIT_BATCH``); (iv) one
#: prompt of 32,768 positions (internvl2-76b: 256 patches + 32,512 tokens)
SERVE_FULL_FOUR_CARDS = {"backend": "nccl", "staged": False, "world": 4, "cards": 4, "max_len": 256, "runs": [
    run for arch, extra in (("deepseek-67b", {}), ("internvl2-76b", {"max_len": 512}))
    for run in (
        {"arch": arch, "layers": 8, "dtype": "float32", "prompts": 8, "ticks": 32, "against_one": True, **extra},
        {"arch": arch, "layers": None, "dtype": None, "prompts": 8, "ticks": 32, "against_one": False,
         "full_tick": True, **extra},
        {"arch": arch, "layers": None, "dtype": None, "prompts": 0, "ticks": 0, "against_one": False,
         "decode_fit": True, **extra},
        {"arch": arch, "layers": None, "dtype": None, "prompts": 0, "ticks": 0, "against_one": False,
         "prefill_long": True, **extra},
    )
]}
#: the cache's length in (iii) and the prompt's positions in (iv)
LONG = 32768
#: (iii)'s batch: the largest whose dry-run peak a card at a cache of
#: ``LONG`` is at most ``FIT_LIMIT_BYTES``, 0.9 of the card's 80 GB (on meta,
#: cuBLAS's workspace included: deepseek-67b 68.81 GB at 11, 72.003 at 12;
#: internvl2-76b 70.22 at 13, 72.90 at 14); ``fit_batch`` finds it again
#: before (iii) runs, and phase 6 times the decode kernel at deepseek-67b's
FIT_LIMIT_BYTES = 0.9 * 80e9
FIT_BATCH = {"deepseek-67b": 11, "internvl2-76b": 13,
             # phase 25 (d): up to decode_32k's 128 (on meta: stablelm-1.6b
             # 71.73 GB at 44, 73.34 at 45; qwen3-moe-30b-a3b 71.73 at 70, 72.54
             # at 71; zamba2-7b 71.10 at 43, 72.68 at 44; mamba2-780m 3.90,
             # whisper-base 13.66 and gemma2-2b 64.25 at 128)
             "mamba2-780m": 128, "whisper-base": 128, "stablelm-1.6b": 44, "gemma2-2b": 128,
             "qwen3-moe-30b-a3b": 70, "zamba2-7b": 43}
#: phase 25 (d): the six remaining architectures on four cards over NCCL
#: (``four_card_main``, after 25 (c)), each (i) in f32 against one card's
#: run of the same model: at full depth where the f32 weights fit one card
#: beside the run (mamba2-780m, whisper-base, gemma2-2b, stablelm-1.6b),
#: qwen3-moe-30b-a3b at 8 layers (the router f32, TF32 off) and zamba2-7b at
#: ``ZAMBA_FOUR_LAYERS``, over the serving run's 8 prompts cut to the
#: shortest (142 tokens; whisper-base's behind 1500 frames) and 32 ticks;
#: (ii) at full depth in bf16 (48, 81, 6 + 6, 26, 24 and 48 layers), each
#: rank drawing a module at a time, over the same prompts and ticks, with a
#: tick at a full cache of ``max_len``; (iii) a full 32k cache at the batch
#: that fits (``FIT_BATCH``)
ZAMBA_FOUR_LAYERS = 12  # two shared invocations
SERVE_REMAINING_FOUR_CARDS = {"backend": "nccl", "staged": False, "world": 4, "cards": 4, "max_len": 256, "runs": [
    run for arch, layers in (("mamba2-780m", None), ("zamba2-7b", ZAMBA_FOUR_LAYERS), ("whisper-base", None),
                             ("gemma2-2b", None), ("stablelm-1.6b", None), ("qwen3-moe-30b-a3b", 8))
    for run in (
        {"arch": arch, "layers": layers, "dtype": "float32", "prompts": 8, "ticks": 32, "against_one": True},
        {"arch": arch, "layers": None, "dtype": None, "prompts": 8, "ticks": 32, "against_one": False,
         "full_tick": True},
        {"arch": arch, "layers": None, "dtype": None, "prompts": 0, "ticks": 0, "against_one": False,
         "decode_fit": True},
    )
]}
#: a sharded step's logits against one device's unsharded run in f32: within
#: ``atol + rtol * max|logit|`` of the step
SERVE_SHARDED_TOL = {"atol": 1e-4, "rtol": 1e-4}
#: phase 26: the ``long_500k`` cell (batch 1, a cache of 524,288 positions)
#: on four cards over NCCL, each arch (i) in f32 at ``LONG_F32_LAYERS``,
#: ``LONG_TICKS`` greedy ticks from a cache drawn from a seed at its last
#: position against one card's ticks of the same model and cache (a cut
#: depth: one card holds the f32 model and the whole cache; zamba2-7b's 6
#: layers hold one shared invocation, gemma2-2b's 2 a local and a global
#: layer); (ii) at full depth in bf16, a counted tick and 3 uncounted
LONG_TICKS = 4
LONG_F32_LAYERS = {"mamba2-780m": 48, "zamba2-7b": 6, "gemma2-2b": 2, "mixtral-8x7b": 2}
LONG_CONTEXT_FOUR_CARDS = {"backend": "nccl", "staged": False, "world": 4, "cards": 4, "max_len": 256, "runs": [
    run for arch, layers in LONG_F32_LAYERS.items()
    for run in (
        {"arch": arch, "layers": layers, "dtype": "float32", "prompts": 0, "ticks": LONG_TICKS, "against_one": True,
         "drawn": "long_500k"},
        {"arch": arch, "layers": None, "dtype": None, "prompts": 0, "ticks": 0, "against_one": False,
         "long_500k": True},
    )
]}
#: phase 26's decode kernel shapes, a card's share of a ``long_500k`` cache
#: on (data 1, model 4) in bf16: (label, H, Hkv, D, softcap)
LONG_DECODE_SHAPES = (("gemma2-2b share (H 2, Hkv 1, D 256, softcap 50)", 2, 1, 256, 50.0),
                      ("zamba2-7b share (H 8, Hkv 8, D 112)", 8, 8, 112, None))
#: the keys cut from the cache for the shorter length of each shape: not a
#: multiple of the split chunk
LONG_DECODE_CUT = 1000


def serve_sharded_child() -> None:
    """One rank of phase 25 (``SHARDED_CHILD`` in the environment: its rank,
    the group's runs and the directory it reports to)."""
    import datetime
    import gc

    import torch.distributed as dist

    from repro_torch.configs.shapes import SHAPES, ShapeSuite
    from repro_torch.distributed.comm import DistComm
    from repro_torch.distributed.sharding import logits_sharding, make_cache_shardings
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_state_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_model

    job = json.loads(os.environ["SHARDED_CHILD"])
    rank, world, out_dir = job["rank"], job["world"], Path(job["dir"])
    torch.set_num_threads(2)
    card = rank % job["cards"]
    dev = torch.device("cuda", card)
    torch.cuda.set_device(card)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32: MoE routing is discontinuous
    dist.init_process_group(job["backend"], init_method=f"file://{out_dir / 'store'}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    on = torch.device("cpu") if job["backend"] == "gloo" else dev  # where the broadcast of one device's run lies
    mesh = make_mesh((1, world), ("data", "model"))
    comm = DistComm(mesh, rank, job["backend"], staged=job["staged"])
    pol = dryrun.POLICIES["serve-tp"]
    wrappers = {"flash_attention": flash_attention_cuda, "decode_attention": decode_attention_cuda,
                "decode_attention_state": decode_attention_state_cuda, "ssd_scan": ssd_scan_cuda}
    report: dict = {"rank": rank, "card": card, "backend": job["backend"], "runs": []}

    def sync_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def on_meta(batch: dict) -> dict:
        return {k: v.to("meta") for k, v in batch.items()}

    def extras(rng, n: int, cfg) -> dict:
        """The family's prefill inputs beside the prompt, the same on every
        rank: the vlm's ``[n, P, d]`` patch embeddings, the
        encoder-decoder's ``[n, F, d]`` frames."""
        name, rows = {"vlm": ("patches", cfg.num_patches), "encdec": ("frames", cfg.enc_frames)}.get(
            cfg.family, (None, 0))
        if name is None:
            return {}
        x = rng.standard_normal((n, rows, cfg.d_model)) * 0.1
        return {name: torch.from_numpy(x.astype(np.float32)).to(dev, getattr(torch, cfg.dtype))}

    def counted_run(arch: str, cfg, suite, batch: dict, **kw):
        """A cell of ``arch`` at ``suite``, its model drawn from the seed, run
        once under the counter after its plan on meta: the cell, its output,
        the run's seconds and a record of the counts, the peaks and the
        launches."""
        plan = dryrun.build_cell(arch, suite, mesh, pol, cfg=cfg, batch=on_meta(batch))
        _, planned = dryrun.count_cell(plan, scopes=False)
        del plan
        cell, build_s = sync_s(lambda: dryrun.build_cell(
            arch, suite, mesh, pol, cfg=cfg, comm=comm, source=torch.Generator(device=dev).manual_seed(0),
            batch=batch, **kw))
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        (out, counted), seconds = sync_s(lambda: dryrun.count_cell(cell, scopes=False))
        return cell, out, seconds, {
            "batch": suite.global_batch, "cache": suite.seq_len, "build_s": build_s,
            "plan": plan_counts(planned), "counted": plan_counts(counted),
            "plan_peak_bytes": planned.memory()["peak_bytes"], "plan_bytes": planned.costs.to_json()["bytes"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": {k: w.launches for k, w in wrappers.items()}, "finite": bool(torch.isfinite(out[0]).all())}

    for run in job["runs"]:
        t_run = time.perf_counter()
        api = get_model(run["arch"])
        cfg = api.config
        if run["layers"] is not None:  # an encoder-decoder cut as deep on both sides
            cut = {"enc_layers": run["layers"]} if cfg.family == "encdec" else {}
            cfg = dataclasses.replace(cfg, num_layers=run["layers"], **cut)
        if run["dtype"]:
            cfg = dataclasses.replace(cfg, dtype=run["dtype"])
        max_len = run.get("max_len", job["max_len"])
        row: dict = {"arch": run["arch"], "family": cfg.family, "layers": cfg.num_layers, "dtype": cfg.dtype}
        if run["prompts"] or run.get("drawn"):  # ticks after a prefill, or from a cache drawn from a seed
            T = run["ticks"]
            if run["prompts"]:
                n = run["prompts"]
                prompts = serve_prompts(cfg.vocab)[:n]
                S = min(len(p) for p in prompts)
                extra = extras(np.random.default_rng(20), n, cfg)
                batch = {"tokens": torch.from_numpy(np.stack([p[:S] for p in prompts])).to(dev), **extra}
                positions = S + (cfg.num_patches if cfg.family == "vlm" else 0)
                pre = ShapeSuite("prefill", "prefill", max_len, n)
                dec = ShapeSuite("decode", "decode", max_len, n)
            else:  # phase 26 (i): no prompt; the first token against a cache at its suite's last position
                dec = SHAPES[run["drawn"]]
                n, S, extra, max_len, positions = dec.global_batch, 0, {}, dec.seq_len, dec.seq_len - 1
                batch = {"token": torch.from_numpy(np.random.default_rng(26).integers(0, cfg.vocab, n)
                                                   .astype(np.int32)).to(dev)}
            spec = logits_sharding(mesh, cfg, n, pol)
            row.update(batch=n, prompt=S, positions=positions, ticks=T, max_len=max_len)
            single_logits = torch.zeros(1 + T, n, cfg.vocab, device=on)
            single_tokens = torch.zeros(T, n, dtype=torch.int32, device=on)
            if run["against_one"]:
                if rank == 0:  # one device's run of the whole model, the same weights
                    whole = api.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
                    with torch.no_grad():
                        if run["prompts"]:
                            cache = api.init_cache(n, max_len, cfg, device=dev)
                            lg, cache = api.prefill(whole, batch["tokens"], cache, cfg, **extra)
                            single_logits[0] = lg.to(on)
                        else:  # the whole cache the ranks cut theirs from: the same seed on a mesh of one
                            one = make_mesh((1, 1), ("data", "model"))
                            specs = api.cache_specs(cfg, dec)
                            cache = dryrun._draw_cache(specs, make_cache_shardings(one, cfg, specs, pol), one, 0, 26,
                                                       dev)
                            cache["pos"], lg = positions, None
                        for t in range(T):
                            tok = batch["token"] if lg is None else lg.argmax(-1).to(torch.int32)
                            single_tokens[t] = tok.to(on)
                            lg, cache = api.decode_step(whole, tok, cache, cfg)
                            single_logits[t + 1] = lg.to(on)
                    del whole, cache, lg
                    gc.collect()
                    torch.cuda.empty_cache()
                dist.broadcast(single_logits, 0)
                dist.broadcast(single_tokens, 0)
            if run["prompts"]:
                plan = dryrun.build_cell(run["arch"], pre, mesh, pol, cfg=cfg, batch=on_meta(batch))
                _, planned = dryrun.count_cell(plan, scopes=False)
            plan = dryrun.build_cell(run["arch"], dec, mesh, pol, cfg=cfg,
                                     batch={"token": torch.zeros(n, dtype=torch.int32, device="meta")})
            row["tick_plan_kernels"] = plan_counts(dryrun.count_cell(plan, scopes=False)[1])["kernels"]
            del plan
            gen = torch.Generator(device=dev).manual_seed(0)  # the model drawn a module at a time, sliced
            if run["prompts"]:
                cell, build_s = sync_s(lambda: dryrun.build_cell(run["arch"], pre, mesh, pol, cfg=cfg, comm=comm,
                                                                 source=gen, batch=batch))
                for w in wrappers.values():
                    w.launches = 0
                # the logits alone are kept: a name bound to a step's cache would hold it past the run
                (out, counted), prefill_s = sync_s(lambda: dryrun.count_cell(cell, scopes=False))
                local = out[0]
                del out
                check(cell.cache["pos"] == positions, f"{run['arch']}: the cache's position {cell.cache['pos']} "
                                                      f"counts the prompt's {positions} positions")
                row.update(prefill_s=prefill_s, prefill_plan=plan_counts(planned),
                           prefill_counted=plan_counts(counted))
            else:  # every rank's cut of the cache drawn whole from seed 26
                cell, build_s = sync_s(lambda: dryrun.build_cell(run["arch"], dec, mesh, pol, cfg=cfg, comm=comm,
                                                                 source=gen, batch=batch, cache=26))
                for w in wrappers.values():
                    w.launches = 0
            kv = dryrun.kv_cache_of(cell.cache)  # the first attention's keys; None for an SSM
            row.update(build_s=build_s, seq_axes=[] if kv is None else list(cell.program.cache_seq_axes(kv)),
                       span=None if kv is None else list(cell.program.cache_span(kv)),
                       layout=dryrun.layout(cell.program))
            del kv
            errs, bounds, tokens_out, tick_s = [], [], [], []

            def held(step, local):
                whole_logits = comm.gather_whole(local, spec)
                if run["against_one"]:
                    ref = single_logits[step].to(dev)
                    errs.append(float((whole_logits - ref).abs().max()))
                    bounds.append(SERVE_SHARDED_TOL["atol"] + SERVE_SHARDED_TOL["rtol"] * float(ref.abs().max()))
                row["finite"] &= bool(torch.isfinite(whole_logits).all())
                return whole_logits.argmax(-1).to(torch.int32)

            row["finite"] = True
            if run["prompts"]:
                tok = held(0, local)
                ticks = dryrun.build_cell(run["arch"], dec, mesh, pol, cfg=cfg, comm=comm, batch={"token": tok},
                                          cache=cell)
            else:
                tok, ticks = batch["token"], cell
            for t in range(T):
                tokens_out.append(tok.cpu().tolist())
                local, s = sync_s(lambda: ticks.run(tok)[0])
                tick_s.append(s)
                tok = held(t + 1, local)
            row.update(launches={k: w.launches for k, w in wrappers.items()}, logits_max_abs_err=errs,
                       logits_bound=bounds, tokens=tokens_out, tick_ms=[1e3 * s for s in tick_s])
            if run["against_one"]:
                row["tokens_equal"] = tokens_out == single_tokens.cpu().tolist()
            del cell, ticks, local, single_logits, batch, extra
            gc.collect()
            torch.cuda.empty_cache()
        full = next((k for k in ("decode_32k", "decode_fit", "full_tick", "long_500k") if run.get(k)), None)
        if full:  # a tick at a full cache drawn from a seed, against the plan's counts and peak
            suite = {"decode_32k": SHAPES["decode_32k"],
                     "decode_fit": ShapeSuite("decode_32k", "decode", LONG, run.get("batch", 0)),
                     "full_tick": ShapeSuite("decode", "decode", max_len, run["prompts"]),
                     "long_500k": SHAPES["long_500k"]}[full]
            token = torch.from_numpy(np.random.default_rng(25).integers(0, cfg.vocab, suite.global_batch)
                                     .astype(np.int32)).to(dev)
            cell, out, tick_s, row[full] = counted_run(run["arch"], cfg, suite, {"token": token}, cache=25)
            del out
            row[full]["tick_ms"] = 1e3 * tick_s
            kv = dryrun.kv_cache_of(cell.cache)
            row[full]["seq_axes"] = [] if kv is None else list(cell.program.cache_seq_axes(kv))
            del kv
            if full in ("decode_fit", "long_500k"):  # the same tick again, uncounted, at the same position
                times = []
                for _ in range(3):
                    cell.cache["pos"] = suite.seq_len - 1
                    times.append(sync_s(cell.run)[1])
                row[full]["uncounted_tick_ms"] = [1e3 * t for t in times]
            del cell
            gc.collect()
            torch.cuda.empty_cache()
        if run.get("prefill_long"):  # one prompt of LONG positions at full depth
            rng = np.random.default_rng(32)
            P = cfg.num_patches if cfg.family == "vlm" else 0
            batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, LONG - P)).astype(np.int32)).to(dev)}
            batch.update(extras(rng, 1, cfg))
            cell, out, counted_s, rec = counted_run(run["arch"], cfg, ShapeSuite("prefill_32k", "prefill", LONG, 1),
                                                    batch)
            del out
            check(cell.cache["pos"] == LONG, f"{run['arch']}: the long prompt fills the cache's {LONG} positions "
                                             f"({cell.cache['pos']})")
            rec.update(tokens=LONG - P, patches=P, counted_s=counted_s,
                       prefill_s=sync_s(cell.run)[1])  # again, uncounted, into the same cache
            row["prefill_long"] = rec
            del cell, batch
            gc.collect()
            torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_run
        report["runs"].append(row)
        print(f"rank {rank}: {row['arch']} {row['layers']} layers done in {row['seconds']:.1f} s", flush=True)
    (out_dir / f"rank_{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def plan_calls(kernels: dict) -> dict[str, int]:
    """A plan's kernel calls by wrapper (the counter records the decode
    kernel's state variant under ``decode_attention``)."""
    return {name: kernels.get(name, {}).get("calls", 0) for name in ("flash_attention", "decode_attention",
                                                                      "ssd_scan")}


def launched(launches: dict) -> dict[str, int]:
    """A run's launches in :func:`plan_calls`'s terms."""
    return {"flash_attention": launches["flash_attention"],
            "decode_attention": launches["decode_attention"] + launches["decode_attention_state"],
            "ssd_scan": launches["ssd_scan"]}


def serve_sharded_report(job: dict, reports: list[dict], label: str) -> dict[str, dict[str, int]]:
    """Phase 25's checks on the ranks' reports, printed (the reports first,
    whole); returns each kernel's launches by path.  Each kernel's launches
    are held against the plan's own kernel calls (the prefill's, plus the
    ticks times a tick's); a decoder transformer's plan makes one flash call
    a layer a prefill and one decode call a layer a tick."""
    print(json.dumps({f"sharded_serve_{label}": reports}), flush=True)
    by_path: dict[str, dict[str, int]] = {}
    for i, run in enumerate(job["runs"]):
        rows = [r["runs"][i] for r in reports]
        name = f"{run['arch']} {rows[0]['layers']} layers {rows[0]['dtype']}"
        L = rows[0]["layers"]
        decoder = rows[0]["family"] in ("dense", "moe", "vlm")
        for r, row in zip(reports, rows):
            tag = f"sharded serve {label} {name} rank {r['rank']}"
            if run["prompts"] or run.get("drawn"):
                T = row["ticks"]
                seq = bool(row["seq_axes"])
                prefill = plan_calls(row["prefill_plan"]["kernels"] if run["prompts"] else {})
                tick = plan_calls(row["tick_plan_kernels"])
                if run["prompts"]:
                    check(row["prefill_counted"] == row["prefill_plan"],
                          f"{tag}: the prefill's arguments, FLOPs, kernel calls and exchanges == the dry-run's: "
                          f"{row['prefill_counted']} against {row['prefill_plan']}")
                    check(not decoder or prefill["flash_attention"] == L,
                          f"{tag}: the plan calls flash once a layer a prefill: {prefill}")
                else:
                    check(not seq, f"{tag}: the {run['drawn']} caches split by heads, not over {row['seq_axes']}")
                check(not decoder or tick["decode_attention"] == L,
                      f"{tag}: the plan calls decode once a layer a tick: {tick}")
                decodes = prefill["decode_attention"] + T * tick["decode_attention"]
                want = {"flash_attention": prefill["flash_attention"] + T * tick["flash_attention"],
                        "decode_attention": 0 if seq else decodes, "decode_attention_state": decodes if seq else 0,
                        "ssd_scan": prefill["ssd_scan"] + T * tick["ssd_scan"]}
                check(row["launches"] == want and (sum(want.values()) > 0 or not run["prompts"]),
                      f"{tag}: launches {row['launches']}, expected the plan's {want}")  # a prefill runs a kernel
                path = f"sharded serve {label} {name}{' ' + run['drawn'] if run.get('drawn') else ''} rank {r['rank']}"
                for k, v in row["launches"].items():
                    if v:
                        by_path.setdefault(k, {})[path] = v
                if run["against_one"] and seq:
                    live = sum(rw["span"][0] < rw["positions"] + T for rw in rows)
                    check(live >= 2, f"{tag}: the prompts and ticks fill {live} of the cache's {len(rows)} shares, "
                                     f"so the combine merges at least two")
                if run["against_one"]:
                    over = [(s, e, b) for s, (e, b) in enumerate(zip(row["logits_max_abs_err"], row["logits_bound"]))
                            if e > b]
                    check(not over, f"{tag}: every step's logits within {SERVE_SHARDED_TOL['atol']} + "
                                    f"{SERVE_SHARDED_TOL['rtol']}·max|logit| of one device's: {over}")
                    check(row["tokens_equal"], f"{tag}: the greedy tokens equal one device's")
                check(row["finite"], f"{tag}: finite logits at every step")
                ticks = row["tick_ms"]
                counts = f"; counts {row['prefill_counted']['collective_counts']} == the plan's" if run["prompts"] else ""
                start = (f"prefill {row['batch']} x {row['prompt']} ({row['positions']} positions, a cache of "
                         f"{row['max_len']}) in {row['prefill_s']:.3f} s" if run["prompts"] else
                         f"{run['drawn']}: batch {row['batch']} from a cache of {row['max_len']} drawn at position "
                         f"{row['positions']}")
                print(f"{tag}: layout {row['layout']['attention']}, modules {row['layout']['modules']}, cache sequence "
                      f"over {row['seq_axes']}; {start} (built in "
                      f"{row['build_s']:.1f} s), {T} ticks: median {statistics.median(ticks):.2f} ms a tick "
                      f"({row['batch'] * 1e3 / statistics.median(ticks):.1f} tokens/s), max logit err "
                      f"{max(row['logits_max_abs_err'] or [0.0]):.3g}; launches {row['launches']}{counts}", flush=True)
            for full in ("full_tick", "decode_32k", "decode_fit", "prefill_long", "long_500k"):
                if full not in row:
                    continue
                f = row[full]
                check(f["counted"] == f["plan"], f"{tag} {full}: arguments, FLOPs, kernel calls and exchanges == the "
                                                 f"dry-run's: {f['counted']} against {f['plan']}")
                check(f["finite"], f"{tag} {full}: finite logits")
                ratio = f["plan_peak_bytes"] / f["max_memory_allocated"]
                if full != "full_tick":
                    check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1], f"{tag} {full}: dry-run peak within {PEAK_BAND} of "
                                                                 f"max_memory_allocated ({ratio:.4f})")
                long = full == "prefill_long"
                calls = plan_calls(f["plan"]["kernels"])
                check(launched(f["launches"]) == calls,
                      f"{tag} {full}: launches {f['launches']} == the plan's kernel calls {calls}")
                if decoder:
                    check(calls["flash_attention"] == (L if long else 0) and calls["decode_attention"] == (0 if long
                                                                                                         else L),
                          f"{tag} {full}: one {'flash' if long else 'decode'} call a layer in the plan: {calls}")
                if full == "long_500k":
                    check(f["seq_axes"] == [], f"{tag} {full}: the caches split by heads, not over {f['seq_axes']}")
                if full in ("decode_fit", "prefill_long", "long_500k"):
                    for k, v in f["launches"].items():
                        if v:
                            by_path.setdefault(k, {})[f"sharded serve {label} {name} {full} rank {r['rank']}"] = v
                if full == "decode_fit":
                    check(f["batch"] == FIT_BATCH[run["arch"]], f"{tag} {full}: batch {f['batch']} is FIT_BATCH's")
                    check(f["plan_peak_bytes"] <= FIT_LIMIT_BYTES, f"{tag} {full}: the plan's peak fits "
                                                                   f"{FIT_LIMIT_BYTES / 1e9:.0f} GB")
                timing = (f"the prompt of {f['tokens']} tokens behind {f['patches']} patches in {f['prefill_s']:.3f} s "
                          f"({f['counted_s']:.3f} s counted)" if long else f"the tick {f['tick_ms']:.1f} ms counted")
                if "uncounted_tick_ms" in f:
                    med = statistics.median(f["uncounted_tick_ms"])
                    timing += f", {med:.2f} ms uncounted ({f['batch'] * 1e3 / med:.1f} tokens/s)"
                if full == "long_500k":
                    timing += (f" against the plan's {f['plan_bytes'] / 1e9:.3f} GB a card at 3.35 TB/s: "
                               f"{1e3 * f['plan_bytes'] / HBM_BYTES_PER_S:.3f} ms")
                print(f"{tag} {full} (batch {f['batch']}, cache {f['cache']}): arguments {f['counted']['arguments']:,} B, "
                      f"FLOPs {f['counted']['flops']:.6e}, exchanges {f['counted']['collective_counts']} "
                      f"{ {k: round(v / 1e6, 3) for k, v in f['counted']['collective_bytes'].items()} } MB == the "
                      f"dry-run's; peak {f['max_memory_allocated'] / 1e9:.3f} GB (dry-run {f['plan_peak_bytes'] / 1e9:.3f} GB,"
                      f" ratio {ratio:.4f}); {timing}; launches {f['launches']}; built in {f['build_s']:.1f} s",
                      flush=True)
    return by_path


def serve_sharded_phase() -> dict[str, dict[str, int]]:
    """Phase 25 (a) on the one card."""
    print(f"phase 25: exchanges {SERVE_SHARDED_ONE_CARD['backend']}, staged through the host: "
          f"{SERVE_SHARDED_ONE_CARD['staged']}", flush=True)
    return serve_sharded_report(SERVE_SHARDED_ONE_CARD,
                                run_sharded(SERVE_SHARDED_ONE_CARD, 600, child="serve_sharded_child",
                                            name="phase25"), "one card")


def fit_batch(arch: str) -> tuple[int, int, int | None]:
    """The batch of phase 25 (c) (iii) and (d) (iii) for ``arch`` on (data
    1, model 4) under serve-tp: the largest, up to ``decode_32k``'s 128,
    whose dry-run peak a card at a cache of ``LONG`` is at most
    ``FIT_LIMIT_BYTES``, found on meta (the peak grows by one sequence's
    share of the cache a row); with its peak and the next batch's (None at
    the suite's batch)."""
    from repro_torch.configs.shapes import SHAPES, ShapeSuite
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((1, 4), ("data", "model"))

    def peak(B: int) -> int:
        plan = dryrun.build_cell(arch, ShapeSuite("decode_32k", "decode", LONG, B), mesh, dryrun.POLICIES["serve-tp"])
        return dryrun.count_cell(plan, scopes=False)[1].memory()["peak_bytes"]

    return largest_fit(peak, SHAPES["decode_32k"].global_batch)


def largest_fit(peak, cap: int) -> tuple[int, int, int | None]:
    """The largest n in 1..``cap`` whose ``peak(n)`` (a dry-run's peak a
    card, growing with n) is at most ``FIT_LIMIT_BYTES``: a guess from the
    growth of one step, then a walk; with its peak and the next one's (None
    at ``cap``)."""
    peaks: dict[int, int] = {}

    def at(n: int) -> int:
        if n not in peaks:
            peaks[n] = peak(n)
        return peaks[n]

    grows = max(1, at(2) - at(1))
    n = min(cap, max(1, int((FIT_LIMIT_BYTES - at(1)) // grows) + 1))
    while n > 1 and at(n) > FIT_LIMIT_BYTES:
        n -= 1
    while n < cap and at(n + 1) <= FIT_LIMIT_BYTES:
        n += 1
    return n, at(n), at(n + 1) if n < cap else None


def fit_batches(job: dict, label: str) -> dict:
    """A copy of ``job`` with each ``decode_fit`` run's batch found on meta
    (:func:`fit_batch`), printed and held to ``FIT_BATCH``."""
    job = json.loads(json.dumps(job))
    for run in job["runs"]:
        if run.get("decode_fit"):
            B, at, past = fit_batch(run["arch"])
            nxt = "the suite's batch" if past is None else f"batch {B + 1}: {past / 1e9:.3f} GB"
            print(f"{label} {run['arch']}: a cache of {LONG} positions at batch {B}, the dry-run's peak "
                  f"{at / 1e9:.3f} GB a card ({nxt}; at most {FIT_LIMIT_BYTES / 1e9:.0f} GB)", flush=True)
            check(B == FIT_BATCH[run["arch"]], f"{run['arch']}: the batch that fits, {B}, is FIT_BATCH's")
            run["batch"] = B
    return job


def serve_full_phase() -> dict[str, dict[str, int]]:
    """Phase 25 (c) on four cards: (iii)'s batches found on meta and
    printed, then the four NCCL ranks of ``SERVE_FULL_FOUR_CARDS``."""
    job = fit_batches(SERVE_FULL_FOUR_CARDS, "phase 25 (c)")
    return serve_sharded_report(job, run_sharded(job, 1500, child="serve_sharded_child", name="phase25c"),
                                "four cards")


def serve_remaining_phase() -> dict[str, dict[str, int]]:
    """Phase 25 (d) on four cards: (iii)'s batches found on meta and
    printed, then the four NCCL ranks of ``SERVE_REMAINING_FOUR_CARDS``."""
    job = fit_batches(SERVE_REMAINING_FOUR_CARDS, "phase 25 (d)")
    return serve_sharded_report(job, run_sharded(job, 1500, child="serve_sharded_child", name="phase25d"),
                                "four cards")


def long_decode_kernel_phase() -> dict[str, dict]:
    """Phase 26's first part, on card 0: the decode kernel at each of
    ``LONG_DECODE_SHAPES`` (a batch of one against 524,288 keys in bf16),
    at lengths S and S - ``LONG_DECODE_CUT``, held against its plain version
    run in f32 within 2e-5 + 2**-8·|y| (half a bf16 step) and timed
    (``cuda_ms``) beside the plain version, its bound (the K and V bytes
    read once at 3.35 TB/s, against its operations) and SDPA with a length
    mask (none under a softcap); the records by shape and length."""
    import torch.nn.functional as F

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_ref, decode_split_plan

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(26)
    S = SHAPES["long_500k"].seq_len
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    records: dict[str, dict] = {}
    for label, H, Hkv, D, cap in LONG_DECODE_SHAPES:
        q = torch.randn((1, H, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((1, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((1, Hkv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        for n in (S, S - LONG_DECODE_CUT):
            lengths = torch.full((1,), n, dtype=torch.int32, device=dev)
            out = decode_attention_cuda(q, k, v, lengths, softcap=cap)
            plain = decode_attention_ref(q, k, v, lengths, softcap=cap)
            plain32 = decode_attention_ref(q.float(), k.float(), v.float(), lengths, softcap=cap)
            torch.cuda.synchronize()
            err = float((out.float() - plain.float()).abs().max())
            err32 = float((out.float() - plain32).abs().max())
            check(bool(torch.isfinite(out.float()).all()), f"decode {label} {n} keys: finite output")
            check(torch.allclose(out.float(), plain32, atol=2e-5, rtol=2**-8),
                  f"decode {label} {n} keys: kernel == plain in f32 within atol 2e-5 rtol 2^-8 (max abs diff {err32})")
            del plain, plain32
            valid = (torch.arange(S, device=dev) < n)[None, None, None, :]
            row = {"keys": n, "max_abs_err": err, "max_abs_err_f32": err32,
                   "splits_chunk": list(decode_split_plan(Hkv, S, sm_count)),
                   "ms": cuda_ms(lambda: decode_attention_cuda(q, k, v, lengths, softcap=cap), reps=20),
                   "plain_ms": cuda_ms(lambda: decode_attention_ref(q, k, v, lengths, softcap=cap), reps=3, warmup=1),
                   "library_ms": None if cap else cuda_ms(lambda: F.scaled_dot_product_attention(
                       q[:, :, None], k, v, attn_mask=valid, enable_gqa=True), reps=20)}
            row["bound_ms"], row["bound_by"] = attention_bound_ms(q, k, H * n, Hkv * n)
            records[f"{label} {n} keys"] = row
            print(f"decode long_500k {label}, {n} of {S} keys bfloat16: max abs diff {err:.3g} (from f32 plain "
                  f"{err32:.3g}); splits x chunk {row['splits_chunk']}; kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']} ms, bound {row['bound_ms']:.6f} ms "
                  f"({row['bound_by']})", flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()
    return records


def long_context_phase() -> tuple[dict[str, dict[str, int]], dict[str, dict]]:
    """Phase 26 on four cards: the decode kernel at 524,288 keys on card 0
    (:func:`long_decode_kernel_phase`), then the four NCCL ranks of
    ``LONG_CONTEXT_FOUR_CARDS``; each kernel's launches by path, and the
    kernel's records at the long shapes.  Alone: ``python3 -c "import
    chip_smoke; chip_smoke.long_context_phase()"`` (builds the kernels)."""
    from repro_torch.kernels import _build

    check(torch.cuda.is_available() and torch.cuda.device_count() >= 4,
          f"{torch.cuda.device_count()} cards: phase 26 needs four")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"phase 26: {smi}", flush=True)
    _build.build()
    t0 = time.perf_counter()
    shapes = long_decode_kernel_phase()
    print(f"phase 26: the decode kernel at the long shapes in {time.perf_counter() - t0:.1f} s", flush=True)
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # card 0's share of the long shapes, freed for rank 0
    job = LONG_CONTEXT_FOUR_CARDS
    by_path = serve_sharded_report(job, run_sharded(job, 900, child="serve_sharded_child", name="phase26"),
                                   "four cards")
    print(f"phase 26: {time.perf_counter() - t0:.1f} s; launches {by_path}", flush=True)
    print(json.dumps({"long_500k_decode": shapes}), flush=True)
    return by_path, shapes


def four_card_main() -> int:
    """Phases 24 (c)-(d), 25 (b)-(d) and 26 alone, on a host of four cards:
    build the kernels, run the four NCCL ranks of each, print the reports,
    then the kernels' launches on these paths (JSON)."""
    from repro_torch.kernels import _build

    check(torch.cuda.device_count() >= 4, f"{torch.cuda.device_count()} cards: phases 24 (c)-(d) and 25 (b)-(d) need "
                                          f"four")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"four cards: {smi}", flush=True)
    _build.build()
    t0 = time.perf_counter()
    by_path = sharded_report(SHARDED_FOUR_CARDS, run_sharded(SHARDED_FOUR_CARDS, 1500), "four cards")
    print(f"phase 24 (c): {time.perf_counter() - t0:.1f} s; flash launches {by_path}", flush=True)
    t0 = time.perf_counter()
    families = sharded_families_phase()
    print(f"phase 24 (d): {time.perf_counter() - t0:.1f} s; launches {families}", flush=True)
    t0 = time.perf_counter()
    serving = serve_sharded_report(SERVE_SHARDED_FOUR_CARDS,
                                   run_sharded(SERVE_SHARDED_FOUR_CARDS, 1500, child="serve_sharded_child",
                                               name="phase25"), "four cards")
    print(f"phase 25 (b): {time.perf_counter() - t0:.1f} s; launches {serving}", flush=True)
    t0 = time.perf_counter()
    full = serve_full_phase()
    print(f"phase 25 (c): {time.perf_counter() - t0:.1f} s; launches {full}", flush=True)
    t0 = time.perf_counter()
    remaining = serve_remaining_phase()
    print(f"phase 25 (d): {time.perf_counter() - t0:.1f} s; launches {remaining}", flush=True)
    long, long_shapes = long_context_phase()
    kernels = four_card_kernels({"flash_attention": by_path}, families, serving, full, remaining, long)
    for k in kernels:
        if k["name"] == "decode_attention":
            k["long_500k_shapes"] = long_shapes
    print(json.dumps({"kernels_four_cards": kernels}), flush=True)
    return 0


def four_card_kernels(*paths: dict[str, dict[str, int]]) -> list[dict]:
    """The kernels' launches by path over the four-card phases (the state
    variant under the decode kernel)."""
    out = {"flash_attention": {}, "decode_attention": {}, "ssd_scan": {}}
    for by_path in paths:
        for name in out:
            out[name].update(by_path.get(name, {}))
        out["decode_attention"].update({f"{k} (state variant)": n for k, n in
                                        by_path.get("decode_attention_state", {}).items()})
    return [{"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "launches": sum(run.values()), "launches_by_path": run} for name, run in out.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from repro_torch.core import (
        Constraints,
        Workload,
        build_problem,
        evaluate_assignment,
        ga,
        ga_sweep,
        mri_system,
        mri_workload,
        random_layered_workflow,
        synthetic_system,
        synthetic_workload,
        verify_schedule,
    )
    from repro_torch.engine import pack, population_fitness_fn, stack_packed
    from repro_torch.kernels import _build
    from repro_torch.kernels.makespan import population_makespan_cuda, population_makespan_ref

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    clock = [time.perf_counter()]
    sweep = start_dryrun_sweep()  # phase 23 (a), on the host beside the card's phases

    def phase_done(n: int, what: str) -> None:
        now = time.perf_counter()
        print(f"phase {n} ({what}): {now - clock[0]:.2f} s", flush=True)
        clock[0] = now

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {sorted(seconds)} in {time.perf_counter() - t0:.2f} s "
          f"(per source: {json.dumps({k: round(v, 2) for k, v in seconds.items()})})", flush=True)
    resources = {name: ptxas_resources(_build.build_log(name)) for name in seconds}
    for name, rows in resources.items():
        for r in rows:
            print(f"  ptxas[{name}] {r['kernel']}: {r['registers']} registers, {r['static_smem']} B static "
                  f"shared memory, {r.get('stack')} B stack, {r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads")
    print(json.dumps({"ptxas": resources}), flush=True)
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        for r in resources[name]:
            check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0, f"{r['kernel']}: no register spills")
    hgmma = sass_count(_build.library_path("flash_attention"), "HGMMA")
    print(f"sass: flash_attention holds {hgmma} HGMMA (wgmma) instructions", flush=True)
    check(hgmma > 0, "the bf16 flash kernel runs its products on wgmma")
    phase_done(1, "build")

    # 2. kernel against plain version -----------------------------------------
    def table9(seed: int):
        return build_problem(synthetic_system(500, seed=seed), synthetic_workload(500, seed=seed))

    t0 = time.perf_counter()
    table9_main = table9(500)
    constrained = build_problem(
        synthetic_system(20, seed=5),
        synthetic_workload(20, seed=5, num_workflows=2),
        Constraints(deadline={"W0": 9.0}),
    )
    layered = build_problem(synthetic_system(8, seed=4),
                            Workload((random_layered_workflow(40, seed=4, max_cores=8),)))
    cases = [
        ("mri", build_problem(mri_system(), mri_workload()), 16),
        ("layered_40x8", layered, 64),
        ("deadline_20x20", constrained, 64),
        ("table9_500x500", table9_main, 64),
    ]
    print(f"problems built in {time.perf_counter() - t0:.2f} s", flush=True)
    from repro_torch.kernels import makespan as makespan_mod

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    max_smem = makespan_mod._library().population_makespan_max_smem()

    def both_places(A: torch.Tensor, kw: dict, reps: int) -> dict:
        """Device ms per call with the core-free rows in shared memory and in
        L2 (each held to the plain version by bits), and which the wrapper's
        plan picks."""
        a = A if A.dim() == 3 else A[None]
        arr = kw if A.dim() == 3 else {k: None if v is None else v[None] for k, v in kw.items()}
        B, P, T = a.shape
        N, C = arr["init_free"].shape[-2:]
        mk_p, v_p = population_makespan_ref(a, **arr)
        out = {"plan": "shared" if makespan_mod.makespan_plan(B, P, T, N, C, sm_count, max_smem).rows_in_smem
               else "L2"}
        for place, in_smem in (("shared", True), ("L2", False)):
            plan = makespan_mod.makespan_plan(B, P, T, N, C, sm_count, max_smem, rows_in_smem=in_smem)
            mk, v = makespan_mod._launch(a, arr, plan)
            torch.cuda.synchronize()
            check(same_bits(mk, mk_p) and same_bits(v, v_p), f"rows in {place}: kernel == plain version")
            out[place] = cuda_ms(lambda: makespan_mod._launch(a, arr, plan), reps=reps)
        return out

    # the tie case: Table IX with whole-number durations and releases, so
    # core-free times tie; the inf/NaN case: a node that sends at rate 0
    # (inf transfer times) and two tasks with no output on such links (0/0)
    ties = problem_kw(table9_main, dev)
    ties["durations"] = ties["durations"].round().clamp(min=1.0)
    ties["release"] = ties["release"].round()
    nan_kw = problem_kw(layered, dev)
    nan_kw["dtr"][0, 1:] = 0.0
    nan_kw["data"][[30, 35]] = 0.0
    # past the kernel's usual widths: up to 100 predecessors a task (the
    # fold past the 64 a warp prefetches) and a 128-slot core window
    many_preds = problem_kw(table9_main, dev)
    j = torch.arange(table9_main.num_tasks, device=dev)[:, None]
    back = j - 1 - torch.arange(128, device=dev)[None, :]
    many_preds["pred_matrix"] = torch.where((back >= 0) & (back >= j - 100), back, -1).to(torch.int32)
    wide = problem_kw(layered, dev)
    wide["init_free"] = torch.cat([wide["init_free"], torch.full_like(wide["init_free"], 1e30)], 1)
    cases = [(name, problem, pop, None) for name, problem, pop in cases]
    cases += [("table9 whole-number durations (ties)", table9_main, 64, ties),
              ("layered rate 0, data 0 (inf, NaN)", layered, 64, nan_kw),
              ("table9 with 100 predecessors a task", table9_main, 64, many_preds),
              ("layered with CMAX 128", layered, 64, wide)]
    max_err = 0.0
    record = None
    for name, problem, pop, given in cases:
        if given is None:
            packed = pack(problem, pad=False)
            arrays = packed.device_arrays(dev)
            kw = {k: arrays[k] for k in KEYS}
            kw["deadline"] = arrays["deadline"] if packed.constrained else None
        else:
            kw = given
        A = torch.from_numpy(random_assignments(problem, pop, seed=len(name))).to(dev)
        mk_k, v_k = population_makespan_cuda(A, **kw)
        mk_p, v_p = population_makespan_ref(A, **kw)
        torch.cuda.synchronize()
        check(same_bits(mk_k, mk_p) and same_bits(v_k, v_p), f"{name}: kernel == plain version, bit for bit")
        special = {"nan": int(mk_p.isnan().sum()), "inf": int(mk_p.isinf().sum())}
        if given is nan_kw:
            check(special["nan"] > 0 and special["inf"] > 0, f"{name}: some makespans are NaN and some inf")
        else:
            check(bool(torch.isfinite(mk_k).all()), f"{name}: finite makespans")
        if kw["deadline"] is not None:
            check(bool((v_k > 0).any()), f"{name}: some deadline is missed")
        diff = torch.where(torch.isfinite(mk_p), mk_k - mk_p, 0.0)
        max_err = max(max_err, float(diff.abs().max()), float((v_k - v_p).abs().max()))
        line = f"makespan {name}: P={pop} kernel == plain bit for bit (NaN {special['nan']}, inf {special['inf']})"
        if name == "table9_500x500":
            ms = cuda_ms(lambda: population_makespan_cuda(A, **kw), reps=20)
            plain_ms = cuda_ms(lambda: population_makespan_ref(A, **kw), reps=3, warmup=1)
            bound_ms, bound_by, nbytes, ops = makespan_bound_ms(A, kw)
            places = both_places(A, kw, reps=20)
            line += (f"; kernel {ms:.4f} ms (rows in shared memory {places['shared']:.4f}, in L2 "
                     f"{places['L2']:.4f}; the plan takes {places['plan']}), plain {plain_ms:.2f} ms, "
                     f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} ops)")
            record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                      "ms_rows_in_shared": places["shared"], "ms_rows_in_l2": places["L2"]}
        print(line, flush=True)

    sweep_problems = [table9(s) for s in SWEEP_SEEDS]
    stacked, bucket = stack_packed(sweep_problems, device=dev)
    kw = {k: stacked[k] for k in KEYS}
    kw["deadline"] = None
    A = torch.zeros(len(sweep_problems), GA["pop_size"], bucket[0], dtype=torch.int32)
    for b, problem in enumerate(sweep_problems):
        A[b, :, : problem.num_tasks] = torch.from_numpy(random_assignments(problem, GA["pop_size"], b))
    A = A.to(dev)
    mk_k, v_k = population_makespan_cuda(A, **kw)
    mk_p, v_p = population_makespan_ref(A, **kw)
    torch.cuda.synchronize()
    check(same_bits(mk_k, mk_p) and same_bits(v_k, v_p), "batched family: kernel == plain version, bit for bit")
    batch_ms = cuda_ms(lambda: population_makespan_cuda(A, **kw), reps=10)
    places = both_places(A, kw, reps=10)
    bound_ms, bound_by, nbytes, ops = makespan_bound_ms(A, kw)
    print(f"makespan batched {len(sweep_problems)}x500x500: bucket={bucket} kernel == plain bit for bit; "
          f"kernel {batch_ms:.4f} ms (rows in shared memory {places['shared']:.4f}, in L2 {places['L2']:.4f}; "
          f"the plan takes {places['plan']}), bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} ops)",
          flush=True)
    record.update(sweep_ms=batch_ms, sweep_bound_ms=bound_ms, sweep_ms_rows_in_shared=places["shared"],
                  sweep_ms_rows_in_l2=places["L2"])

    phase_done(2, "makespan kernel against its plain version")

    # 3. single GA: the main path -----------------------------------------------
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    res = ga(table9_main, backend="auto", device="cuda", seed=0, **GA)
    torch.cuda.synchronize()
    ga_s = time.perf_counter() - t0
    launches = population_makespan_cuda.launches
    check(launches == GA["generations"] + 1, f"GA made {launches} kernel launches, expected 61")
    check(verify_schedule(table9_main, res.schedule) == [], "GA schedule is valid")
    best = res.schedule.assignment
    _, mk_best = population_fitness_fn(table9_main, engine="cuda", device="cuda")(best[None])
    oracle32 = evaluate_assignment(table9_main, best, dtype=np.float32).makespan
    check(float(mk_best[0]) == oracle32, "f32 oracle re-scores the GA's best to the kernel's makespan")
    check(np.isfinite(res.history).all() and (np.diff(res.history) <= 0).all(), "GA history")
    print(f"ga 500x500 pop={GA['pop_size']} gens={GA['generations']}: {ga_s:.3f} s wall, "
          f"makespan {res.schedule.makespan:.4f}, {launches} kernel launches, "
          f"history {res.history[0]:.2f} -> {res.history[-1]:.2f}", flush=True)

    phase_done(3, "Table IX GA")

    # 4. batched sweep ------------------------------------------------------------
    population_makespan_cuda.launches = 0
    t0 = time.perf_counter()
    results = ga_sweep(sweep_problems, backend="auto", device="cuda", seed=0, **GA)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep_launches = population_makespan_cuda.launches
    check(sweep_launches == GA["generations"] + 1, f"ga_sweep made {sweep_launches} launches, expected 61")
    for problem, r in zip(sweep_problems, results):
        check(verify_schedule(problem, r.schedule) == [], "sweep schedule is valid")
        _, mk_best = population_fitness_fn(problem, engine="cuda", device="cuda")(r.schedule.assignment[None])
        oracle32 = evaluate_assignment(problem, r.schedule.assignment, dtype=np.float32).makespan
        check(float(mk_best[0]) == oracle32, "f32 oracle re-scores each sweep best to the kernel's")
    print(f"ga_sweep {len(sweep_problems)}x(500x500) pop={GA['pop_size']} gens={GA['generations']}: "
          f"{sweep_s:.3f} s wall, {sweep_launches} kernel launches, makespans "
          f"{[round(r.schedule.makespan, 2) for r in results]}", flush=True)

    phase_done(4, "ga_sweep")

    # 5. the same GA through the plain version, as a yardstick of the path
    t0 = time.perf_counter()
    plain_res = ga(table9_main, backend="torch", device="cuda", seed=0, **GA_PLAIN)
    torch.cuda.synchronize()
    print(f"ga 500x500 pop={GA_PLAIN['pop_size']} gens={GA_PLAIN['generations']} through the plain version: "
          f"{time.perf_counter() - t0:.3f} s wall, makespan {plain_res.schedule.makespan:.4f}", flush=True)

    # where the GA's time goes: its kernels on the device against the wall
    t0 = time.perf_counter()
    evaluate_assignment(table9_main, res.schedule.assignment)
    oracle_ms = 1e3 * (time.perf_counter() - t0)
    breakdown = device_time_breakdown(
        lambda: ga(table9_main, backend="auto", device="cuda", seed=0, **GA)
    )
    breakdown["oracle_rescore_ms"] = oracle_ms
    print(json.dumps({"ga_profile": breakdown}), flush=True)
    phase_done(5, "plain GA and profile")

    # 6. attention kernels against their plain versions ------------------------
    from repro_torch.models.registry import get_model

    vocab = get_model("qwen2.5-3b").config.vocab
    attention = attention_phase([len(p) for p in serve_prompts(vocab)])
    phase_done(6, "attention kernels against their plain versions")

    # 7. qwen2.5-3b served at full width: the serving path ------------------------
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    qwen_launches = qwen_phase()
    phase_done(7, f"qwen2.5-3b served at full width, {QWEN_LAYERS} layers")

    # 8. the SSD kernel against its plain version ------------------------------------
    ssd = ssd_phase([len(p) for p in serve_prompts(get_model("mamba2-780m").config.vocab)])
    phase_done(8, "SSD kernel against its plain version")

    # 9. mamba2-780m served at full width: the ssm family's serving path -------------
    mamba_launches = mamba_phase()
    phase_done(9, f"mamba2-780m served at full width, {MAMBA_LAYERS} layers")

    # 10. zamba2-7b served at full width: the hybrid family's serving path ----------
    zamba_launches = zamba_phase()
    phase_done(10, f"zamba2-7b served at full width, {ZAMBA_LAYERS} layers")

    # 11. the serving CLI on the card, as a user runs it: the reduced configs
    # (head width 16) through the attention kernels, the reduced MoE ones
    # (mixtral's window of 8 through the ring caches and window=), and the
    # reduced ssm and hybrid ones (chunk 16, N 16, P 16) through the SSD
    # kernel's chunk-serial design ---------------------------------------------------
    from repro_torch.launch import serve as serve_cli

    wrappers = {"flash_attention": flash_attention_cuda, "decode_attention": decode_attention_cuda,
                "ssd_scan": ssd_scan_cuda}
    cli_kernels = {"qwen2.5-3b": ("flash_attention", "decode_attention"),
                   "qwen3-moe-30b-a3b": ("flash_attention", "decode_attention"),
                   "mixtral-8x7b": ("flash_attention", "decode_attention"),
                   "mamba2-780m": ("ssd_scan",),
                   "zamba2-7b": ("ssd_scan", "flash_attention", "decode_attention"),
                   "deepseek-67b": ("flash_attention", "decode_attention"),
                   "internvl2-76b": ("flash_attention", "decode_attention")}
    cli_launches: dict[str, dict[str, int]] = {}
    for arch, names in cli_kernels.items():
        for w in wrappers.values():
            w.launches = 0
        serve_cli.main(["--arch", arch, "--requests", "3"])
        torch.cuda.synchronize()
        cli_launches[arch] = {name: wrappers[name].launches for name in names}
        check(all(n > 0 for n in cli_launches[arch].values()), f"the {arch} CLI ran its kernels: {cli_launches[arch]}")
        print(f"cli {arch}: launches {cli_launches[arch]}", flush=True)
    refused = None
    try:
        serve_cli.main(["--arch", "whisper-base"])
    except SystemExit as e:
        refused = str(e)
    check(refused == "whisper-base serving needs frames input; see tests/test_models_smoke.py",
          f"the whisper-base CLI exits with the reference's message, not {refused!r}")
    print(f"cli whisper-base: exits with {refused!r}, as the reference's CLI", flush=True)
    phase_done(11, "the serving CLI on the card")

    # 12. PSO, SA and ACO on the makespan kernel at Table IX --------------------
    mh_launches = metaheuristics_phase(table9_main, res)
    phase_done(12, "PSO, SA and ACO at Table IX")

    # 13. the scenario path: the policy, the orchestrator and the CLI ------------
    scenario_launches = scenario_phase(table9_main, sweep_problems)
    phase_done(13, "the scenario path on the card")

    # 14. the scheduling service: tenants' GA admissions, single and batched
    service_launches, service_record = service_phase()
    phase_done(14, "the scheduling service on the card")

    # 15. campaigns: the Table IX grid, the paper's scale and the lanes
    campaign_launches, campaign_record = campaign_phase()
    phase_done(15, "campaigns on the card")

    # 16. the multi-device instance axis and generated continua
    topology_launches, topology_record = shard_topology_phase(sweep_problems)
    phase_done(16, "the instance axis and generated continua")

    # 17. the MoE family: qwen3-moe-30b-a3b at full width and depth, mixtral-8x7b cut
    moe_launches = moe_phase()
    phase_done(17, "the MoE family served at full width")

    # 18. the ML-job continuum: the job mix's GA on the makespan kernel
    continuum_launches = continuum_phase()
    phase_done(18, "the ML-job continuum on the card")

    # 19. the encdec family: whisper-base at full width and depth
    whisper_launches, whisper_cache = whisper_phase()
    phase_done(19, "whisper-base at full width and depth")

    # 20. the vlm family: internvl2-76b at full width, VLM["layers"] of its 80
    vlm_launches = internvl2_phase()
    phase_done(20, f"internvl2-76b at full width, {VLM['layers']} layers")

    # 21. sampling and the int8 KV cache on the card
    sampling_phase(whisper_cache)
    phase_done(21, "sampling and the int8 KV cache")

    # 22. training: the autograd Functions, qwen2.5-3b and mamba2-780m at full
    # width and depth, f32 cuts against the CPU, the Trainer and the CLI
    import gc

    del whisper_cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 22: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    train_by_path, train_record = training_phase()
    phase_done(22, "training")

    # 23. the dry-run: the sweep's cells, its prediction against the card,
    # the four-card plan, no launch
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase()
    finish_dryrun_sweep(*sweep)
    phase_done(23, "the dry-run and its cost model")

    # 24. the sharded training step on real exchanges: four ranks on the card
    # in a gloo group, the pipeline, compressed_psum_pod, the cross-mesh
    # restore; the four-card NCCL run where the host has four
    gc.collect()
    torch.cuda.empty_cache()
    sharded_by_path = sharded_phase()
    phase_done(24, "the sharded training step")

    # 25. sharded serving on real exchanges: four ranks on the card in a gloo
    # group, qwen2.5-3b (the cache's sequence split) and mixtral-8x7b cut to
    # 2 layers, prefill and greedy ticks against one device's run
    gc.collect()
    torch.cuda.empty_cache()
    serving_by_path = serve_sharded_phase()
    phase_done(25, "sharded serving")

    makespan_by_path = {"ga": launches, "ga_sweep": sweep_launches, **mh_launches, **scenario_launches,
                        **service_launches, **campaign_launches, **topology_launches, **continuum_launches}
    record.update(service_record)
    record.update(campaign_record)
    record.update(topology_record)
    max_err = max(max_err, service_record["service_max_abs_err"], campaign_record["campaign_max_abs_err"],
                  topology_record["large_max_abs_err"])

    # each kernel's launches on each serving path, and their sum
    by_path: dict[str, dict[str, int]] = {}
    paths = [("qwen2.5-3b", qwen_launches), ("mamba2-780m", mamba_launches), ("zamba2-7b", zamba_launches),
             ("qwen3-moe-30b-a3b", moe_launches["qwen3-moe-30b-a3b"]),
             (f"mixtral-8x7b {MIXTRAL_LAYERS} layers", moe_launches["mixtral-8x7b"]),
             ("whisper-base", whisper_launches),
             *vlm_launches.items()]
    paths += [(f"cli {arch}", run) for arch, run in cli_launches.items()]
    for path, run in paths:
        for name, n in run.items():
            by_path.setdefault(name, {})[path] = n
    for name, run in train_by_path.items():
        by_path[name].update(run)
    for name, run in sharded_by_path.items():
        by_path[name].update(run)
    by_path["flash_attention"].update(serving_by_path.get("flash_attention", {}))
    by_path["decode_attention"].update(serving_by_path.get("decode_attention", {}))
    by_path["decode_attention"].update({f"{k} (state variant)": n for k, n in
                                        serving_by_path.get("decode_attention_state", {}).items()})
    by_path["ssd_scan"].update(serving_by_path.get("ssd_scan", {}))

    kernels = [{
        "name": "population_makespan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/makespan.cu",
        "replaces": "src/repro/kernels/makespan.py:168",
        "launches": sum(makespan_by_path.values()),
        "launches_by_path": makespan_by_path,
        "sweep_launches": sweep_launches,
        "max_abs_err": max_err,
        **record,
        "library_ms": None,
    }]
    for name, replaces in (("flash_attention", "src/repro/kernels/flash_attention.py:117"),
                           ("decode_attention", "src/repro/kernels/decode_attention.py:90")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            **attention[name],
            **train_record.get(name, {}),
        })
    kernels.append({
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:96",
        "launches": sum(by_path["ssd_scan"].values()),
        "launches_by_path": by_path["ssd_scan"],
        **ssd,
        **train_record["ssd_scan"],
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
