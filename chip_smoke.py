#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the CUDA kernels of ``src/repro_torch/csrc`` from source, nine
   byte-layout launchers and seven packed-layout ones;
3. graph: RMAT scale 22, edge factor 16, seed 0 (4.19M vertices, about
   64M undirected edges, the Graph500 Kronecker parameters), and the
   4,096 union sets ``{v} ∪ N(v)`` of seeded random vertices of degree
   1-63;
4. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   the bound (bytes this run's data needs over the H100's 3.35 TB/s,
   ``repro_torch.analysis.roofline.HW().hbm_bw``) and, for
   accumulate, the ``scatter_reduce_`` yardstick. The estimate is also
   held on a sweep of p and ragged row counts in both layouts and timed
   on its own line at the triangle phase's block of 2^18 gathered rows.
   ``intersection_stats`` and ``union_estimate_stats`` are also timed as
   their C launchers alone (no wrapper), in both layouts; the pair
   kernel's byte sums of A and B must equal ``hll_estimate_stats`` of
   those rows bit for bit, and the union kernel is also held and timed
   on a skewed panel (4,096 sets ``{v} ∪ N(v)`` whose degrees follow the
   graph's own up to 1,023, a 4,096 x 1,024 panel).
   Accumulate runs the whole graph in one launch (every edge live, no
   mask) and is timed at
   the engine's launch shape, 2 x ``INGEST_BLOCK`` directed edges built
   on the card in the engine's order, on a fresh panel (ns per directed
   edge printed), and as a build's launches in a row, which must give
   the one-launch panel; propagate runs on the engine's dst-sorted
   routing, whose build (copy, orientations, stable sort on the card,
   slice by slice) is timed on a line of its own with the device memory
   it takes;
   ``hip_delta_rows`` on
   ``D^1``/``D^2`` of the scale-22 panel and on a sweep of ragged row
   counts with registers up to ``max_register`` and falling lanes, equal
   bit for bit; then each packed kernel on the packed scale-22 panel
   (512 MiB) at the same shapes, equal to its plain version bit for bit
   and to the byte kernel on the unpacked (clamped) panel, the packed
   accumulate equal to ``pack_rows`` of the byte panel and the packed
   propagate to ``pack_rows`` of the byte pass; and the two-panel
   launchers ``hll_propagate_into`` and ``_packed`` (the sharded
   schedules' merge, the port's kernel for the JAX package's plain
   ``packing.scatter_max_rows``) at the three shapes of the sharded
   phase, shard 0 of 4: a ring step (merging block 1, plus 4,096
   self-index pairs that a skip of ``src == dst`` would drop), the
   all-gather merge (every edge into shard 0 over all n_pad rows) and
   the replica pre-pass (a 1,024-row panel), each equal bit for bit and
   timed, with the run length the wrapper chose, the gather floor (one
   source row read an edge) beside the bound and, on the byte layout,
   the library yardstick ``index_reduce_(0, dst, rows, "amax")`` on the
   source rows gathered beforehand; the intersection MLE's Newton tail
   (``intersection_newton``, 50 steps, one launch a call) on the main
   path's 16,384 pairs and on 2^18 edge pairs, from the
   ``intersection_stats`` kernel's statistics and the initializer the
   engine takes: the pairs the overflow flag rejects keep their start
   bit for bit and the rest agree with the plain version as
   ``tests/test_torch_intersection_newton.py`` holds them, with the
   kernel's CUDA-event time, the plain version's, its launches, the
   bytes bound and the arithmetic estimate; and every tuned kernel at
   every value
   of its autotune grid (``kernels.autotune.SWEEPS``, phase 4t's
   candidates) on the same inputs, equal to the plain result bit for bit;
5. main path, with launch counters zeroed just before: ``engine.build``
   (``hll_accumulate`` launched once per ``INGEST_BLOCK`` chunk, 16
   times at scale 22), ``degrees`` (mean relative error against exact
   degrees), ``neighborhood(3)`` (``hll_propagate`` launched twice),
   ``intersection_size`` on 16,384 edge pairs with
   the MLE, ``union_size`` on the 4,096 sets (each must equal hop 2 of
   ``neighborhood(3)`` for its vertex) and ``query_batch`` over all three
   (bit for bit the per-kind answers); every kernel of the path must have
   launched (``intersection_newton`` once for ``intersection_size``);
   then the share of the pairs that the reference's Hessian-overflow
   flag holds still;
4t. autotune, right after phase 5 on its byte engine: the packed engine of
   the same panel answers phase 5's queries on the fallback shapes; every
   op and layout (7 byte, 6 packed) is swept on the card on the main
   path's own inputs (``autotune.sweep(op, p=8, inputs=...)``, see
   ``sweep_inputs``: the winners are filed under those calls' size
   classes; each candidate the median of 9 CUDA-event timings of its
   wrapper, L2 written over before each), one line each with every
   candidate's time, the fastest, the winner (the fallback unless beaten
   by more than ``autotune.WIN_MARGIN``), the fallback and, for the cost
   model's five ops, its bound
   (``analysis.roofline_terms`` of ``analysis.sketch_op_costs``) and the
   winner's share of it; ``drive_count()`` must rise by the candidates
   and a second sweep drive none; phase 4's candidate checks must cover
   all 13 cells; both engines answer ``degrees()``, ``neighborhood(3)``,
   ``intersection_size``, ``union_size`` and ``query_batch`` again with
   the winners installed, equal to the fallback's answers bit for bit,
   each step's seconds beside the fallback's; then ``clear_cache()``, so
   every later phase launches the fallback shapes;
5f. functional core, counters zeroed just before: ``degreesketch.
   accumulate`` (one ``hll_accumulate`` launch per 2^15 directed edges)
   equal to the main path's panel, ``hll.degree_estimates`` to
   ``degrees()`` and ``neighborhood_estimates(.., 3)`` from that sketch
   (two propagate and three estimate launches over one routing) to
   ``neighborhood(3)``, all bit for bit, timed, with peak memory;
5g. colored, counters zeroed just before: 3 seeded colors,
   ``colored_accumulate`` (one launch per ingest chunk over the 3 GiB of
   flattened planes) and ``colored_neighborhood(t_max=2)`` (one
   propagate launch per plane); the max over the planes equal to the
   panel at t=1 and to its ``D^2`` at t=2 bit for bit, each of 8 hubs'
   plane rows equal bit for bit to the plain version's sketch
   (``impl="ref"``, no kernel) of its exact neighbors of that color,
   ``count`` at t=1 against the exact counts: their root mean square
   error within ``2 * rel_std`` (gated), each count against
   ``4 * rel_std`` (reported), and ``count_and`` of 4 (x, c1, c2) finite
   through ``ertl_stats``;
5s. serving, on the same graph, launch counters zeroed just before each
   served run: a ``QueryServer`` over a fresh byte engine, 8 client
   threads x 24 seeded requests (1/8 ``degrees``, 3/8 ``union_size`` of 8
   sets ``{v} ∪ N(v)``, 3/8 ``intersection_size`` of 64 edge pairs, 1/8
   ``neighborhood(3)``) with an ingest of 2^20 new edges half way as the
   epoch barrier, every answer equal to the direct call at its epoch bit
   for bit (accumulate, estimate, propagate, pair and set kernels
   launched); then a ``ContinuousServer`` (``RotationPolicy(
   every_blocks=4)``) whose writer ingests 16 blocks of 2^18 new edges,
   flushed every 4, while 4 reader threads query: every reader answer
   equal to the direct call at the snapshot version that served it, a
   snapshot taken before answering as it did throughout (its check's
   launches taken out of the phase's counts), the flushed registers
   equal to a one-shot build, one lease clone a rotation, the first
   snapshot's panel no longer shared;
   rotations, shed and deadline counts, per-kind p50/p99, the lease
   clone's time (CUDA events) against its bound and the phase's peak
   memory printed;
5h. sharded, after phase 5c (counts taken over the sharded engine's calls
   only; the local engine's reference answers run between them): for
   each layout, the local engine's panels and answers, then
   ``engine.build(..., backend="sharded", shards=4)`` on the one card
   (one accumulate launch per owner shard a chunk), ``degrees``, the
   routing plan (built on the card, timed), ``neighborhood(3)`` under
   ``ring``, ``ring_overlap`` and ``allgather`` (every D^t shard panel
   equal to the local panel's rows, the two-panel launches one per
   non-empty group a pass, the bytes each schedule copies between
   shards and one pass in CUDA events printed), ``intersection_size``,
   ``union_size`` and ``query_batch``, all equal to the local engine's
   bit for bit; then (byte) 1,024 replicas, ``neighborhood(2)`` through
   the replica pre-pass, save at 4 shards under ``build/``, load at 1
   and 2 shards and on the local backend with registers, degrees,
   ``neighborhood(2)`` and unions unchanged and the replica set
   reinstalled; ``ADSConfig(p=8)`` at 4 shards (``distance_histogram
   (6)``, ``closeness``, ``effective_diameter`` equal to the local ADS
   engine's, ``hip_delta_rows`` 5 x 4 launches); and the Kronecker
   graph's ``triangle_heavy_hitters(100)`` in edge and vertex mode
   (per-edge estimates equal to the local engine's, totals within 1e-3,
   top-100 sets equal where the values are distinct). The one-panel
   propagate must not launch; every other launcher of the sharded path
   must. Peak memory printed per sub-phase (the peak statistic reset at
   each start), and the phase's maximum over them;
5r. failover coordinator, after phase 5h, counters zeroed just before
   and taken over the coordinator's run and the recovered engine's
   queries only: ``runtime.coordinator.coordinator`` over the phase-3
   graph in 16 blocks of 2^22 edges, 4 hosts, ``backend="sharded"``,
   checkpoints every 8 blocks under ``build/``, the 1,024 highest-degree
   vertices replicated, host 2 killed at block 10 (the owner of the
   block): one recovery and one eviction, 3 hosts alive, 2 blocks
   replayed from the step-7 checkpoint; the 3-shard engine's registers,
   ``degrees``, ``neighborhood(3)`` under ``ring``, ``ring_overlap`` and
   ``allgather`` and ``union_size`` of the 4,096 sets equal the local
   engine's bit for bit, the replica ids intact; the run's time, each
   checkpoint's time (calling thread and until written),
   ``last_recovery_ms``, the launch counts (at least 16 accumulate
   launches) and the peak memory printed; then the module's
   ``--smoke`` in process, a scale-16 run in which host 1 falls silent
   past its lease (evicted) and host 3 is slowed (a straggler, kept),
   and ``train_loop`` on CUDA tensors for 7 steps, restarted: restored
   from step 6 onto the card, equal to an uninterrupted run;
5b. packed main path, once the byte engine is freed, counters zeroed just
   before: the same steps with ``layout="packed"``, each timed, with peak
   memory and the same launch counts (then a short packed ``QueryServer``
   run, 8 x 8 requests, answers equal to the direct calls); the panel
   equal to ``pack_rows`` of the byte panel, every
   answer equal to the byte kernels' on the clamped panel bit for bit,
   ``pack_rows`` commuting with the propagate passes, the count of byte
   registers above 15 and of rows whose degrees differ from the byte
   engine's printed; every packed launcher of the path launched;
5c. packed durability, counters zeroed just before: ``save``/``load`` of
   the packed engine, ``load(layout="byte")`` equal to the exact unpack,
   and even/odd half builds merged equal to the one-shot packed build;
6. ADS, on the same graph once the main path's engine is freed, counters
   zeroed just before: ``engine.build(..., ADSConfig(p=8),
   family="ads")``, ``distance_histogram(6)``, ``closeness(6)``,
   ``effective_diameter(6, q=0.9)``, each timed; histograms non-negative
   and summing to ``glob``, ``C^1`` equal to ``degrees()``, the diameter
   in ``[0, 6]`` and equal to the curve's; repeats run no propagate pass
   and no kernel; ``hip_delta_rows`` launched 5 times; the per-vertex mean
   relative error of the curve against exact ball sizes of 32 seeded
   sources (a multi-source BFS with ``index_add_`` on the card) below
   ``3 * rel_std(8)``;
7. merge: the even- and odd-indexed edges built apart and merged equal
   the one-shot ADS panel bit for bit;
8. checkpoint: ``save`` the ADS engine under ``build/``, ``load`` it,
   registers and ``distance_histogram(6)`` bit for bit, and a further
   ingest into both engines gives the same registers;
8s. serving, continued: one served ``distance_histogram(6)`` on the ADS
   engine (cold), equal to the direct call, and its repeat served from a
   snapshot with no launch and no propagate pass; then the
   ``ContinuousServer``'s failover writer at RMAT scale 16 (the phase's
   cost is host checkpoint I/O, not kernels): checkpoints every 4 blocks
   under ``build/``, the writer killed at block 6, registers after
   ``flush`` equal to the run without faults, directory removed;
9. triangles, with launch counters zeroed just before: RMAT scale 20,
   edge factor 16, seed 0, ``engine.build`` and
   ``triangle_heavy_hitters(k=100, mode="edge")`` (finite values in
   descending order, real edges, a positive total, ``ertl_stats`` and
   ``hll_estimate_stats`` launched);
9k. Kronecker truth, counters zeroed just before the build: C = A x A,
   A = rmat(8, 8, seed=0) (65,536 vertices, 3,302,450 edges), whose
   exact per-edge triangle counts (``kron_edge_triangles``) must total
   83,253,750; ``triangle_heavy_hitters(k=100, mode="edge")`` gated as
   in phase 9, its top-100 recall against the exact counts and its
   total's relative error printed, not gated;
9t. telemetry, counters zeroed just before: Moonlight-16B-A3B's router
   shape (64 experts, top 6, a 163,840-token vocabulary) over a
   ``SyntheticCorpus`` batch of 256 x 4,096 tokens (6,291,456
   assignments), the routing a seeded function of the token id with
   experts 0 and 1 given identical token sets: ``RoutingSketch(64,
   p=10)`` (coverage against exact distinct counts from ``torch.unique``
   on the card, each expert's within 3 x rel_std; ``collapse_score``'s 2,016 pairs from one ``ertl_stats``
   launch, (0, 1) above 0.6 and every other pair below 0.2), and
   ``NGramSketch(n=2, p=12)`` over the corpus's 4 data shards (the merge
   equal to one sketch over every token byte for byte, ``distinct``
   within 3 x rel_std of the exact bigram count); times on their own
   lines;
9m. LM serving, counters zeroed just before, everything freed at its
   end: every arch at ``reduced()`` in float32 (TF32 off) with the same
   weights on the card and the CPU, the prefill's logits and 3 greedy
   decode steps within ``LM_REDUCED_TOL`` (an int8 cache carried from
   the CPU each step); Moonlight-16B-A3B at full width in bf16, weights
   drawn on the card from seed 0 one tensor at a time, 4 x 2,048
   ``SyntheticCorpus`` prompts (MoE capacity 961) through
   ``make_prefill_step`` and 16 greedy ``make_decode_step`` calls:
   values finite, tokens below ``vocab_padded``, the prefill's last
   logits equal to ``lm_logits(forward_hidden(...))`` there, and, with
   the MoE capacity raised so that no token drops, a prefill of 2,032
   tokens then 4 teacher-forced decode steps against the forward within
   ``LM_BF16_TOL`` (greedy tokens equal where the forward's top-2 margin
   exceeds it; a planted position + 1 fault must go over it); parameter
   GiB, init s, peak GiB, prefill s and tokens/s, decode ms a step (CUDA
   events, median of 16) beside two bytes bounds over ``HW().hbm_bw``
   (every weight but the embedding plus the KV cache, as the reference's
   dispatch reads them; and only the experts each step's routers picked,
   with the KV cache up to the step's position); the served prompts'
   layer-0 routing (``embed_lookup`` then ``moe_ffn``, 49,152
   assignments) into ``RoutingSketch(64, p=10)``, coverage within 3 x
   rel_std of ``torch.unique`` counts, ``collapse_score`` from one
   ``ertl_stats`` launch; after the counts are read, the same
   teacher-forced check at full width in float32 on 4 layers within
   ``LM_F32_TOL``, both planted faults (position + 1, a zeroed K/V) over
   it, and the routing's kernels against their plain versions on its own
   inputs (table byte for byte, ``ertl_stats`` bit for bit, the (s, z)
   behind ``coverage``); then ``python -m repro_torch.launch.serve --arch
   moonshot-v1-16b-a3b`` exits 0 and prints ``generated``;
9g. LM training, counters zeroed just before, everything freed at its
   end: Moonlight-16B-A3B at full width cut to ``TR_LAYERS`` = 8 of 48
   layers (bf16 weights, float32 AdamW moments, remat "full"; 5.24 B
   parameters, the most one card holds with a step's activations), 8
   steps of 4 x 2,048 ``SyntheticCorpus(seed=1)`` tokens through
   ``make_train_step`` and ``train_loop``: step ms (CUDA events, median
   of steps 2-8), tokens/s, model-FLOP share against 989 TFLOP/s, peak
   memory, every step's loss and gradient norm, all finite and the last
   loss below the first; after each step the step's tokens through the
   trained layer 0's router into ``RoutingSketch(64, p=10)`` and each
   batch into ``NGramSketch(n=2)`` (as ``examples/expert_telemetry.py``
   and ``examples/train_lm.py`` do), coverage against ``torch.unique``
   counts (root mean square within 2 x rel_std, each expert within 4 x),
   ``collapse_score``;
   ``hll_accumulate``, ``hll_estimate_stats`` and ``ertl_stats`` must
   have launched; after the counts are read, the routing's kernels
   against their plain versions (``routing_vs_plain``), every arch at
   ``reduced()`` one step card vs CPU in float32 (loss, gradients,
   updated parameters within 1e-4, ``models.parity.step_mismatches``),
   ``grad_accum=2`` against 1 within 1e-5, ``compressed_psum`` over 4
   card tensors equal to the CPU's, and ``python -m
   repro_torch.launch.train --arch qwen2-1.5b --steps 12 --ckpt-every 5``
   (the loss falls) then ``--steps 15`` (restores step 10);
9d. mesh and dry-run, counters zeroed just before (no kernel launches):
   (a) ``make_production_mesh()`` and ``(multi_pod=True)`` over the real
   card raise ``RuntimeError`` naming 256 / 512 devices against the
   count, and ``make_host_mesh()`` is a ("data",) mesh of the cards;
   (b) inside 9m (48 layers) and 9g (8 layers), before the model is
   freed: ``param_shapes(cfg)`` equals the model's shapes and dtypes key
   for key under the JAX tree keys, ``input_specs`` on a one-card (1, 1)
   ("data", "model") mesh reckons per-device parameter bytes (9g: and
   AdamW state bytes) equal to the tensors' ``nbytes``, and both equal
   the growth of ``memory_allocated()`` across the build within the
   allocator's rounding per tensor (printed); (c) with ``pshard`` set to
   that mesh, moonshot-v1-16b-a3b and qwen2-1.5b at ``reduced()`` give
   prefill logits, 3 decode steps and one train step on the card equal
   bit for bit to the runs with no mesh set, under
   ``torch.use_deterministic_algorithms(True)``; (d) ``python -m
   repro_torch.launch.dryrun --all`` in a subprocess: 80 cells, each OK
   or SKIP, the skips exactly ``cell_is_applicable``'s, and
   ``torch.cuda.is_initialized()`` false in that process; its seconds and
   Moonlight's modeled roofline terms printed;
10. small reference: the same queries at RMAT scale 10 on the CPU (plain
    versions) and on the card, which must agree, the top-20 recall of
    the estimated triangle heavy hitters against exact counts (reported),
    and the ADS curve of both against each other (``rtol=1e-6``) and
    against exact ball sizes (the tolerances of ``tests/test_ads.py``);
    then the packed engine on both, triangles (edge and vertex) included,
    with counters zeroed just before the card's run (the engine path of
    ``ertl_stats_packed``), the card's answers also equal to the byte
    kernels' on the clamped panel bit for bit; and ``impl="ref"`` engines
    (byte and ADS) on the card, counters zeroed just before them: no
    kernel launched, and every answer equal to the ``impl="cuda"``
    engines' on the card bit for bit but those of the MLE (intersections
    and triangles), whose Newton steps the plain version sums in another
    order than the kernel: held as the CPU's are (1e-4 of the estimates'
    scale).

Then the kernels JSON line (every launcher launched on a counted path),
the card line, and the last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without that line; so does a run without a CUDA device,
outside the repository, or with ``REPRO_TORCH_IMPL``,
``REPRO_TORCH_LAYOUT`` or ``REPRO_TORCH_FAMILY`` naming another default
than "cuda", "byte" and "hll".
"""
from __future__ import annotations

import collections
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
#: the Newton tail's arithmetic estimate: float32 expf / expm1f
#: evaluations a pair, step and bin in the kernel, lane-instructions each,
#: and the H100 SXM's boost clock (its 132 SMs x 128 lanes are read)
NEWTON_EVALS, NEWTON_EVAL_INSTR, NEWTON_CLOCK_HZ = 11, 25, 1.755e9
N_PAIRS = 16384
N_SETS = 4096
ERTL_PAIRS = 1 << 18
T_MAX = 3
TRI_SCALE, TRI_K = 20, 100
ADS_T, ADS_SOURCES = 6, 32
SERVE_CLIENTS, SERVE_REQS, SERVE_SETS, SERVE_PAIRS = 8, 24, 8, 64
SERVE_INGEST = 1 << 20
CONT_BLOCKS, CONT_BLOCK, CONT_READERS = 16, 1 << 18, 4
FT_SCALE, FT_BLOCKS = 16, 12
SERVE_WAIT = 300  # seconds any serving wait may take before the smoke fails
COLORS, COLOR_HUBS, COLOR_ANDS = 3, 8, 4
#: gate on the root mean square relative error of the hubs' color counts,
#: in units of rel_std(P) (see ``colored_phase``)
COLOR_RMS_BOUND = 2.0
#: C = A x A with A = rmat(KRON_FACTOR_SCALE, 8, seed=0): n = 65,536 and
#: 3,302,450 undirected edges, whose exact triangle count is KRON_TRIANGLES
KRON_FACTOR_SCALE, KRON_TRIANGLES = 8, 83_253_750
#: phase 5r: the coordinator's hosts, block, cadence, kill and replicas
#: at full width, and the delay of the scale-16 run's slow host
COORD_HOSTS, COORD_BLOCK, COORD_CKPT_EVERY, COORD_KILL = 4, 1 << 22, 8, 10
COORD_REPLICAS, COORD_SLOW_S = 1024, 0.5
#: phase 9t: Moonlight-16B-A3B's router (64 experts, top 6) and vocabulary,
#: a batch of 256 x 4,096 tokens, split into 4 data shards for the n-grams
TEL_EXPERTS, TEL_TOPK, TEL_VOCAB = 64, 6, 163_840
TEL_SEQ, TEL_BATCH, TEL_SHARDS = 4096, 256, 4
TEL_P_ROUTING, TEL_P_NGRAM = 10, 12
#: phase 9m: Moonlight-16B-A3B served at full width in bf16 (4 prompts of
#: 2,048 tokens, 16 greedy decode steps; the teacher-forced check decodes
#: the 4 positions after a 2,032-token prefill, 4 x 2,032 a multiple of
#: the 64 experts), and every arch's reduced config, 2 prompts of 32
#: tokens and 3 decode steps, card against CPU
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK_FROM = (
    "moonshot-v1-16b-a3b", 4, 2048, 16, 2032)
LM_RED_BATCH, LM_RED_LEN, LM_RED_DECODES = 2, 32, 3
#: float32 logits of one computation on two devices or two row counts:
#: the card's against the CPU's (reduced configs), a prefill's last
#: position against the forward's
LM_REDUCED_TOL = 1e-4
#: bf16 logits of decode against the teacher-forced forward, absolute,
#: and the planted faults that must go over it (``lm_teacher_forced``).
#: On an H100 the sound reading is 0.370, position + 1 gives 0.538 and a
#: zeroed K/V 0.415, too near to hold: the float32 check below holds it
LM_BF16_TOL, LM_BF16_FAULTS = 0.45, ("pos",)
#: the same check at full width in float32 on LM_F32_LAYERS layers, where
#: both planted faults must go over LM_F32_TOL (H100: sound 1.2e-5, the
#: faults 0.51-0.72 at their worst step)
LM_F32_LAYERS, LM_F32_TOL = 4, 1e-4
#: phase 9g: Moonlight-16B-A3B trained at full width in bf16 (its float32
#: AdamW moments, remat "full"), depth cut to TR_LAYERS of 48, the most
#: one card holds: weights, gradients and moments take 12 bytes a
#: parameter (6.85 GB a layer), and a step's peak on the H100 is 64.83 GiB
#: at 8 layers while 9 run out of memory in AdamW
#: (``scripts/profile_lm_train.py --layers``); TR_BATCH x TR_SEQ tokens a
#: step from SyntheticCorpus(seed=TR_SEED) (MoE capacity 961, as in 9m),
#: TR_STEPS steps at peak rate TR_LR after one warmup step
TR_LAYERS, TR_BATCH, TR_SEQ, TR_STEPS, TR_SEED, TR_LR = 8, 4, 2048, 8, 1, 3e-4
#: gates on the 64 experts' coverage, relative error in units of rel_std:
#: the root mean square within TR_COV_RMS, and each expert within
#: TR_COV_MAX (at 3 x rel_std one expert in 64 goes over by chance about
#: one run in six; 4 x is a broken expert's gate, not a tail's)
TR_COV_RMS, TR_COV_MAX = 2.0, 4.0
#: one train step of every reduced arch, card against CPU in float32 (TF32
#: off) at rate TR_RED_LR: loss, gradients and updated parameters within
#: TR_RED_TOL (a third of the rate: Adam moves a parameter whose gradient
#: is at its rounding floor by up to the rate); grad_accum=2 against 1 on
#: the card within TR_ACCUM_TOL; the launcher's steps before and after its
#: restart
TR_RED_LR, TR_RED_TOL, TR_ACCUM_TOL = 3e-4, 1e-4, 1e-5
TR_LAUNCH_ARCH, TR_LAUNCH_STEPS, TR_LAUNCH_RESUME = "qwen2-1.5b", 12, 15
#: phase 9d: the reduced archs (one MoE, one dense) run with and without
#: the one-card mesh set
MESH_ARCHS = ("moonshot-v1-16b-a3b", "qwen2-1.5b")
DEVICE = "cuda"

SOURCES = {
    "hll_accumulate": ("src/repro_torch/csrc/hll_accumulate.cu",
                       "src/repro/kernels/hll_accumulate.py:77"),
    "hll_estimate_stats": ("src/repro_torch/csrc/hll_estimate.cu",
                           "src/repro/kernels/hll_estimate.py:45"),
    "hll_propagate": ("src/repro_torch/csrc/hll_propagate.cu",
                      "src/repro/kernels/hll_propagate.py:55"),
    "intersection_stats": ("src/repro_torch/csrc/intersection_stats.cu",
                           "src/repro/kernels/intersection_stats.py:75"),
    "union_estimate_stats": ("src/repro_torch/csrc/union_estimate.cu",
                             "src/repro/kernels/union_estimate.py:69"),
    "ertl_stats": ("src/repro_torch/csrc/ertl_stats.cu",
                   "src/repro/kernels/ertl_stats.py:55"),
    "hip_delta_rows": ("src/repro_torch/csrc/hip_delta.cu",
                       "src/repro/kernels/hip_delta.py:39"),
    # the MLE's Newton steps: no Pallas site, jax.grad / jax.hessian under
    # vmap in the lax.scan of _newton_solve
    "intersection_newton": ("src/repro_torch/csrc/intersection_newton.cu",
                            "src/repro/core/intersection.py:119"),
    # packed-layout variants: the Pallas kernels' packed bodies
    "hll_accumulate_packed": ("src/repro_torch/csrc/hll_accumulate.cu",
                              "src/repro/kernels/hll_accumulate.py:63"),
    "hll_estimate_stats_packed": ("src/repro_torch/csrc/hll_estimate.cu",
                                  "src/repro/kernels/hll_estimate.py:31"),
    "hll_propagate_packed": ("src/repro_torch/csrc/hll_propagate.cu",
                             "src/repro/kernels/hll_propagate.py:32"),
    "intersection_stats_packed": (
        "src/repro_torch/csrc/intersection_stats.cu",
        "src/repro/kernels/intersection_stats.py:47"),
    "union_estimate_stats_packed": ("src/repro_torch/csrc/union_estimate.cu",
                                    "src/repro/kernels/union_estimate.py:40"),
    "ertl_stats_packed": ("src/repro_torch/csrc/ertl_stats.cu",
                          "src/repro/kernels/ertl_stats.py:34"),
    # the two-panel merge of the sharded schedules: no Pallas site, the
    # port's kernel for the plain jnp packing.scatter_max_rows
    "hll_propagate_into": ("src/repro_torch/csrc/hll_propagate.cu",
                           "src/repro/kernels/packing.py:124"),
    "hll_propagate_into_packed": ("src/repro_torch/csrc/hll_propagate.cu",
                                  "src/repro/kernels/packing.py:124"),
}
#: the sharded phase: shard panels on the one card, and the ring step that
#: phase 4 holds the two-panel launchers at (shard 0 merging block 1)
SHARDS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).

    ``setup`` (untimed) builds fresh arguments for each run.
    """
    pairs = []
    for _ in range(reps):
        args = setup() if setup is not None else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float) -> float:
    """Milliseconds ``n_bytes`` take at the H100's device-memory rate
    (``analysis.roofline.HW``'s default)."""
    from repro_torch.analysis.roofline import HW
    return n_bytes / HW().hbm_bw * 1e3


def launcher_ms(torch, name, args, reps: int = 20) -> float:
    """Median device time of C launcher ``name`` alone (no wrapper, no
    launch count) on ``args``, ``reps`` calls in a row."""
    from repro_torch.kernels import _build
    fn = getattr(_build.library(), name)

    def call():
        if fn(*args) != 0:
            fail(f"{name} failed to launch")
    return cuda_ms(torch, call, reps)


def pair_launcher_ms(torch, regs, pa, pb, q, layout) -> float:
    """``launcher_ms`` of intersection_stats on these pairs, at the
    fallback launch shape."""
    from repro_torch.kernels import _build, autotune
    b, w = pa.shape[0], regs.shape[1]
    stats = torch.empty((b, 5, q + 2), dtype=torch.float32,
                        device=regs.device)
    sz = torch.empty((b, 3, 2), dtype=torch.float32, device=regs.device)
    return launcher_ms(torch, _build.kernel_name("intersection_stats", layout),
                       (regs.data_ptr(), pa.data_ptr(), pb.data_ptr(),
                        stats.data_ptr(), sz.data_ptr(), b, regs.shape[0],
                        2 * w if layout == "packed" else w, q,
                        autotune.FALLBACK["intersection_stats"]["pair_block"],
                        torch.cuda.current_stream().cuda_stream))


def set_launcher_ms(torch, regs, ids, mask, layout) -> float:
    """``launcher_ms`` of union_estimate_stats on this set panel, at the
    fallback launch shape."""
    from repro_torch.kernels import _build, autotune
    b, w = ids.shape[0], regs.shape[1]
    out = torch.empty((b, 2), dtype=torch.float32, device=regs.device)
    return launcher_ms(torch, _build.kernel_name("union_estimate_stats",
                                                 layout),
                       (regs.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), b, regs.shape[0], ids.shape[1],
                        2 * w if layout == "packed" else w,
                        autotune.FALLBACK["union_estimate"]["set_block"],
                        torch.cuda.current_stream().cuda_stream))


def compare_skewed_union(torch, np, regs, skew, layout):
    """union_estimate_stats against its plain version on the skewed panel:
    4,096 sets whose degrees follow the graph's own distribution up to
    1,023 (a 4,096 x 1,024 panel); timed on a line of its own."""
    from repro_torch.engine import plans
    from repro_torch.kernels import union_estimate
    ids_np, mask_np = plans.pad_sets(skew)
    ids = torch.from_numpy(ids_np).to(regs.device)
    mask = torch.from_numpy(mask_np).to(regs.device)
    got = union_estimate.union_estimate_stats(regs, ids, mask, layout=layout)
    want = union_estimate.plain(regs, ids, mask, layout=layout)
    torch.cuda.synchronize()
    exact = torch.equal(got, want) if layout == "packed" else (
        torch.equal(got[:, 1], want[:, 1]) and torch.allclose(
            got[:, 0], want[:, 0], rtol=1e-6, atol=0))
    if not exact:
        fail(f"union_estimate_stats ({layout}) differs from its plain "
             f"version on the skewed panel")
    ms = cuda_ms(torch, lambda: union_estimate.union_estimate_stats(
        regs, ids, mask, layout=layout), 20)
    alone = set_launcher_ms(torch, regs, ids, mask, layout)
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(
        regs, ids, mask, layout=layout), 3)
    members = int(mask_np.sum())
    bnd = bound_ms(np.unique(ids_np[mask_np]).size * regs.shape[1]
                   + 5 * ids_np.size + 8 * ids_np.shape[0])
    log(f"kernel vs plain: union_estimate_stats ({layout}) on the skewed "
        f"panel: max abs err {float((got - want).abs().max())}, kernel "
        f"{ms:.4f} ms, launcher alone {alone:.4f} ms "
        f"({alone * 1e6 / members:.3f} ns a member row), plain "
        f"{plain_ms:.4f} ms, bound {bnd:.4f} ms (bytes); "
        f"{ids_np.shape[0]} x {ids_np.shape[1]} panel, {members} members")


def neighbor_sets(np, edges, n, rng, count=None, max_degree=63):
    """``{v} ∪ N(v)`` for ``count`` (default N_SETS) seeded random vertices
    of degree 1 to ``max_degree``, drawn uniformly, so their degrees
    follow the graph's own distribution below the cap.

    One vectorised pass over the edge list: the directed entries whose
    source was chosen are sorted by the source's slot and split per set.
    Returns (vertices int64[count], list of int64 id arrays).
    """
    count = N_SETS if count is None else count
    deg = np.bincount(edges.ravel(), minlength=n)
    verts = rng.choice(np.flatnonzero((deg >= 1) & (deg <= max_degree)),
                       count, replace=False)
    slot = np.full(n, -1, np.int64)
    slot[verts] = np.arange(count)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    keep = slot[src] >= 0
    order = np.argsort(slot[src[keep]], kind="stable")
    nbrs = dst[keep][order].astype(np.int64)
    parts = np.split(nbrs, np.cumsum(deg[verts])[:-1])
    return verts, [np.concatenate([[v], part]) for v, part in zip(verts, parts)]


def compare_kernels(torch, np, edges, n, pairs, sets, skew, report):
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.engine import plans
    from repro_torch.kernels import ertl_stats, hll_accumulate, hll_estimate
    from repro_torch.kernels import hll_propagate, intersection_stats
    from repro_torch.kernels import union_estimate

    dev = torch.device(DEVICE)
    r, q = 1 << P, 64 - P
    n_pad = -(-n // 8) * 8
    directed = np.concatenate([edges, edges[:, ::-1]])
    rows = torch.from_numpy(np.ascontiguousarray(directed[:, 0])).to(dev)
    keys = torch.from_numpy(directed[:, 1].astype(np.uint32)).to(dev)

    # accumulate: the whole graph through the kernel and the plain version,
    # every edge live (mask=None, as the engine launches it)
    regs_k = torch.zeros((n_pad, r), dtype=torch.uint8, device=dev)
    regs_p = torch.zeros_like(regs_k)
    hll_accumulate.hll_accumulate(regs_k, rows, keys, p=P, seed=0)
    hll_accumulate.plain(regs_p, rows, keys, p=P, seed=0)
    torch.cuda.synchronize()
    err = int((regs_k.to(torch.int16) - regs_p.to(torch.int16)).abs().max())
    if err != 0:
        fail(f"hll_accumulate differs from its plain version (max {err})")
    regs_c = torch.empty_like(regs_k)
    hold_candidates(torch, "accumulate", "byte",
                    lambda **kw: hll_accumulate.hll_accumulate(
                        regs_c.zero_(), rows, keys, p=P, seed=0, **kw),
                    regs_p)
    del regs_p, regs_c, rows, keys
    report(*accumulate_timing(torch, np, edges, n_pad, "byte", regs_k, err))

    # estimate: the built panel, then a sweep of p and ragged row counts
    out_k = hll_estimate.hll_estimate_stats(regs_k)
    out_p = hll_estimate.plain(regs_k)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("hll_estimate_stats differs from its plain version")
    err = float((out_k - out_p).abs().max())
    hold_candidates(torch, "estimate", "byte",
                    lambda **kw: hll_estimate.hll_estimate_stats(regs_k, **kw),
                    out_p)
    compare_estimate_sweep(torch, np)
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(regs_k), 10)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(regs_k), 3)
    report("hll_estimate_stats", err, ms, plain_ms,
           bound_ms(n_pad * r + n_pad * 8), None,
           f"{n_pad} rows; sweep of p 3-16 and ragged row counts equal")

    # propagate: the whole directed routing, as the engine routes it
    src, dst = routing_timing(torch, np, edges)
    prop_k = hll_propagate.hll_propagate(regs_k, src, dst)
    prop_p = hll_propagate.plain(regs_k, src, dst)
    torch.cuda.synchronize()
    err = int((prop_k.to(torch.int16) - prop_p.to(torch.int16)).abs().max())
    if err != 0:
        fail(f"hll_propagate differs from its plain version (max {err})")
    hold_candidates(torch, "propagate", "byte",
                    lambda **kw: hll_propagate.hll_propagate(regs_k, src, dst,
                                                             **kw), prop_p)
    del prop_p
    ms = cuda_ms(torch, lambda: hll_propagate.hll_propagate(regs_k, src, dst),
                 5)
    plain_ms = cuda_ms(torch, lambda: hll_propagate.plain(regs_k, src, dst), 1)
    e_live = src.numel()
    report("hll_propagate", err, ms, plain_ms,
           bound_ms(2 * n_pad * r + 8 * e_live), None,
           f"{e_live} directed edges, dst-sorted routing")
    compare_propagate_into(torch, np, regs_k, src, dst, "byte", report)
    del src, dst
    compare_hip_delta(torch, np, regs_k, prop_k, report)
    del prop_k

    # intersection_stats: the main path's pairs
    ids = torch.from_numpy(plans.pad_pairs(pairs)[0]).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st_k, sz_k = intersection_stats.intersection_stats(regs_k, pa, pb, q)
    st_p, sz_p = intersection_stats.plain(regs_k, pa, pb, q)
    est = hll_estimate.hll_estimate_stats(regs_k)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(sz_k[..., 1], sz_p[..., 1])
            and torch.allclose(sz_k[..., 0], sz_p[..., 0], rtol=1e-6, atol=0)):
        fail("intersection_stats differs from its plain version")
    if not (torch.equal(sz_k[:, 0, 0], est[pa.long(), 0])
            and torch.equal(sz_k[:, 1, 0], est[pb.long(), 0])):
        fail("intersection_stats' exact sums differ from hll_estimate_stats")
    hold_candidates(torch, "intersection_stats", "byte",
                    lambda **kw: intersection_stats.intersection_stats(
                        regs_k, pa, pb, q, **kw), (st_p, sz_p))
    err = max(float((st_k - st_p).abs().max()),
              float((sz_k - sz_p).abs().max()))
    ms = cuda_ms(torch, lambda: intersection_stats.intersection_stats(
        regs_k, pa, pb, q), 20)
    alone = pair_launcher_ms(torch, regs_k, pa, pb, q, "byte")
    plain_ms = cuda_ms(torch, lambda: intersection_stats.plain(
        regs_k, pa, pb, q), 3)
    rows_read = torch.unique(ids).numel()
    b = ids.shape[0]
    report("intersection_stats", err, ms, plain_ms,
           bound_ms(rows_read * r + 8 * b + 4 * b * (5 * (q + 2) + 6)), None,
           f"{b} pairs, {rows_read} distinct rows, launcher alone "
           f"{alone:.4f} ms; s of A and B equal hll_estimate_stats")
    compare_newton(torch, np, regs_k, edges, st_k, sz_k, report)

    # union_estimate_stats: the main path's padded set panel
    ids_np, mask_np = plans.pad_sets(sets)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    out_k = union_estimate.union_estimate_stats(regs_k, ids, mask)
    out_p = union_estimate.plain(regs_k, ids, mask)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("union_estimate_stats differs from its plain version")
    err = float((out_k - out_p).abs().max())
    hold_candidates(torch, "union_estimate", "byte",
                    lambda **kw: union_estimate.union_estimate_stats(
                        regs_k, ids, mask, **kw), out_p)
    ms = cuda_ms(torch, lambda: union_estimate.union_estimate_stats(
        regs_k, ids, mask), 20)
    alone = set_launcher_ms(torch, regs_k, ids, mask, "byte")
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(regs_k, ids, mask),
                       3)
    rows_read = np.unique(ids_np[mask_np]).size
    report("union_estimate_stats", err, ms, plain_ms,
           bound_ms(rows_read * r + 5 * ids_np.size + 8 * ids_np.shape[0]),
           None, f"{ids_np.shape[0]} x {ids_np.shape[1]} set panel, "
                 f"{int(mask_np.sum())} members, {rows_read} distinct rows, "
                 f"launcher alone {alone:.4f} ms")
    compare_skewed_union(torch, np, regs_k, skew, "byte")

    # ertl_stats: 2^18 edge pairs gathered from the built panel
    pick = np.random.default_rng(SEED + 1).choice(len(edges), ERTL_PAIRS,
                                                  replace=False)
    ends = torch.from_numpy(edges[pick].astype(np.int64)).to(dev)
    a, b = regs_k[ends[:, 0]], regs_k[ends[:, 1]]
    st_k = ertl_stats.ertl_stats(a, b, q)
    st_p = ertl_stats.plain(a, b, q)
    torch.cuda.synchronize()
    if not torch.equal(st_k, st_p):
        fail("ertl_stats differs from its plain version")
    err = float((st_k - st_p).abs().max())
    hold_candidates(torch, "ertl_stats", "byte",
                    lambda **kw: ertl_stats.ertl_stats(a, b, q, **kw), st_p)
    del st_k, st_p
    ms = cuda_ms(torch, lambda: ertl_stats.ertl_stats(a, b, q), 10)
    plain_ms = cuda_ms(torch, lambda: ertl_stats.plain(a, b, q), 3)
    report("ertl_stats", err, ms, plain_ms,
           bound_ms(ERTL_PAIRS * (2 * r + 4 * 5 * (q + 2))), None,
           f"{ERTL_PAIRS} gathered edge pairs")

    # estimate at the triangle phase's shape: one block of gathered rows
    out_k = hll_estimate.hll_estimate_stats(a)
    out_p = hll_estimate.plain(a)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("hll_estimate_stats differs from its plain version on the "
             "triangle block")
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(a), 20)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(a), 3)
    log(f"kernel vs plain: hll_estimate_stats at the triangle block: max abs "
        f"err {float((out_k - out_p).abs().max())}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound "
        f"{bound_ms(ERTL_PAIRS * (r + 8)):.4f} ms (bytes); {ERTL_PAIRS} "
        f"gathered rows")
    return regs_k.cpu()


def compare_estimate_sweep(torch, np):
    """hll_estimate_stats in both layouts against the plain versions at
    p 3-16 (packed 4-16) and row counts that leave the kernel's row groups
    ragged, with all-zero rows and byte registers up to 255 (the slow
    path): byte ``z`` exact and ``s`` within ``rtol=1e-6``; packed bit for
    bit, and equal to the byte kernel on the unpacked panel (both take
    the exact sum and round it once)."""
    from repro_torch.kernels import hll_estimate, packing
    rng = np.random.default_rng(SEED + 4)
    for p, m in ((3, 33), (4, 1), (6, 5), (8, 7), (8, 9), (8, 1001),
                 (9, 77), (10, 3), (12, 515), (14, 17), (16, 7)):
        full = rng.integers(0, 22, (m, 1 << p)).astype(np.uint8)
        full[::3] = 0
        byte = torch.from_numpy(full).to(DEVICE)
        wild = byte.clone()
        wild[1::3, ::5] = torch.from_numpy(rng.integers(
            100, 256, wild[1::3, ::5].shape).astype(np.uint8)).to(DEVICE)
        for panel in (byte, wild):
            got = hll_estimate.hll_estimate_stats(panel)
            want = hll_estimate.plain(panel)
            if not torch.equal(got[:, 1], want[:, 1]) or not torch.allclose(
                    got[:, 0], want[:, 0], rtol=1e-6, atol=0):
                fail(f"hll_estimate_stats differs from its plain version at "
                     f"p={p}, {m} rows")
        if p < 4:
            continue
        packed = packing.pack_rows(byte)
        got = hll_estimate.hll_estimate_stats(packed, layout="packed")
        if not torch.equal(got, hll_estimate.plain(packed, layout="packed")):
            fail(f"hll_estimate_stats_packed differs from its plain version "
                 f"at p={p}, {m} rows")
        if not torch.equal(got, hll_estimate.hll_estimate_stats(
                packing.unpack_rows(packed))):
            fail(f"hll_estimate_stats_packed differs from the byte kernel "
                 f"on the clamped panel at p={p}, {m} rows")


def accumulate_timing(torch, np, edges, n_pad, layout, built, err):
    """hll_accumulate at the engine's launch shape: each ``INGEST_BLOCK``
    chunk of undirected edges becomes 2 x ``INGEST_BLOCK`` directed edges
    built on the card by ``directed_block``, in the engine's order. Times
    one launch on a fresh panel (median over the first chunks), the plain
    version on the same, PyTorch's ``scatter_reduce_`` on pre-hashed
    indices (byte layout) and a build's launches in a row, whose panel
    must equal ``built`` (the one-launch panel). Returns ``report``'s
    arguments; ``err`` is the whole-graph comparison's."""
    from repro_torch.core.hashing import bucket_rho
    from repro_torch.engine.base import SketchEngine
    from repro_torch.kernels.inputs import directed_block
    from repro_torch.kernels import hll_accumulate

    dev = torch.device(DEVICE)
    packed = layout == "packed"
    name = "hll_accumulate_packed" if packed else "hll_accumulate"
    w = (1 << P) // (2 if packed else 1)
    blk = SketchEngine.INGEST_BLOCK
    chunks = [directed_block(edges[s:s + blk], dev)
              for s in range(0, len(edges), blk)]
    n_dir = chunks[0][0].numel()
    reps = min(5, len(chunks))
    panel = torch.zeros((n_pad, w), dtype=torch.uint8, device=dev)
    it = iter(chunks[:reps] * 2)

    def fresh():
        panel.zero_()
        return next(it)

    ms = cuda_ms(torch, lambda ro, ke: hll_accumulate.hll_accumulate(
        panel, ro, ke, p=P, layout=layout), reps, fresh)
    plain_ms = cuda_ms(torch, lambda ro, ke: hll_accumulate.plain(
        panel, ro, ke, p=P, layout=layout), reps, fresh)
    panel.zero_()
    build_ms = cuda_ms(torch, lambda: [hll_accumulate.hll_accumulate(
        panel, ro, ke, p=P, layout=layout) for ro, ke in chunks], 1)
    if not torch.equal(panel, built):
        fail(f"{name}: the build's {len(chunks)} chunk launches differ from "
             f"the one-launch panel")
    rows0, keys0 = chunks[0]
    bkt = bucket_rho(keys0, P)[0]
    if packed:  # bytes touched
        idx = rows0.to(torch.int64) * w + bkt % w
    else:
        idx = rows0.to(torch.int64) * w + bkt
    touched = torch.unique(idx).numel()
    lib_ms = None
    if not packed:
        hashed = [(ro, *bucket_rho(ke, P)) for ro, ke in chunks[:reps]]
        it_lib = iter([(ro.to(torch.int64) * w + b, rho)
                       for ro, b, rho in hashed])

        def fresh_lib():
            panel.zero_()
            return next(it_lib)

        lib_ms = cuda_ms(torch, lambda i, v: panel.view(-1).scatter_reduce_(
            0, i, v, reduce="amax"), reps, fresh_lib)
    log(f"accumulate: {name}: one launch of {n_dir} directed edges "
        f"{ms:.4f} ms = {ms * 1e6 / n_dir:.3f} ns per directed edge; a "
        f"build's {len(chunks)} launches {build_ms:.3f} ms")
    return (name, err, ms, plain_ms, bound_ms(8 * n_dir + 2 * touched),
            lib_ms, f"one launch of {n_dir} directed edges (2 x "
                    f"INGEST_BLOCK, engine order, fresh panel), "
                    f"{ms * 1e6 / n_dir:.3f} ns/edge, {touched} registers "
                    f"touched; the build's {len(chunks)} launches "
                    f"{build_ms:.3f} ms, equal to the one-launch panel")


def routing_timing(torch, np, edges):
    """The engine's propagate routing (``directed_routing``: the edge list
    copied to the card once, both orientations and the stable dst sort
    built there slice by slice), timed three times on the host clock, one
    ``sort_routing`` of the whole routing with CUDA events, and the device
    memory the build takes at its peak and keeps. Prints one line;
    returns the routing."""
    from repro_torch.kernels.inputs import directed_routing
    from repro_torch.kernels.hll_propagate import sort_routing

    dev = torch.device(DEVICE)
    secs = []
    routing = None
    for _ in range(3):
        routing = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        routing, t = timed(torch, lambda: directed_routing(edges, dev))
        secs.append(t)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    kept = (torch.cuda.memory_allocated() - base) / 2 ** 30
    e = torch.from_numpy(edges).to(dev)
    src, dst = torch.cat([e[:, 0], e[:, 1]]), torch.cat([e[:, 1], e[:, 0]])
    del e
    sort_ms = cuda_ms(torch, lambda: sort_routing(src, dst), 3)
    del src, dst
    log(f"routing: directed_routing of {len(edges)} undirected edges "
        f"({2 * len(edges)} directed): {statistics.median(secs):.4f} s "
        f"median of {[round(t, 4) for t in secs]} (host clock); one stable "
        f"dst sort of the whole routing {sort_ms:.3f} ms (CUDA events); device memory "
        f"+{peak:.2f} GiB at its peak, {kept:.2f} GiB kept")
    return routing


def _check_into(torch, name, out0, src_panel, src, dst, layout, reps):
    """The two-panel launcher on ``(out0, src_panel)`` over one dst-sorted
    group: fail unless it equals its plain version bit for bit. Returns
    (kernel ms, plain ms, bytes bound ms, gather floor ms, library ms, the
    plain result): the wrapper's call on a fresh copy of ``out0`` (CUDA
    events); the bound reads each distinct source and destination row
    once, writes each destination row once, 8 bytes an edge; the gather
    floor reads one source row an edge. The library yardstick (byte layout
    only: no PyTorch call merges nibbles) is ``index_reduce_(0, dst, rows,
    "amax")`` on the source rows gathered beforehand (untimed), which must
    give the same panel; the port never calls it."""
    from repro_torch.kernels import hll_propagate

    got = hll_propagate.hll_propagate_into(out0.clone(), src_panel, src, dst,
                                           layout=layout)
    want = hll_propagate.plain_into(out0.clone(), src_panel, src, dst,
                                    layout=layout)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name} differs from its plain version")
    del got
    ms = cuda_ms(torch, lambda o: hll_propagate.hll_propagate_into(
        o, src_panel, src, dst, layout=layout, check_order=False), reps,
        setup=lambda: (out0.clone(),))
    plain_ms = cuda_ms(torch, lambda o: hll_propagate.plain_into(
        o, src_panel, src, dst, layout=layout), 1,
        setup=lambda: (out0.clone(),))
    lib_ms = None
    if layout == "byte":
        rows, index = src_panel[src.long()], dst.long()
        lib = out0.clone().index_reduce_(0, index, rows, "amax")
        if not torch.equal(lib, want):
            fail(f"{name}: the index_reduce_ yardstick differs from the "
                 f"plain version")
        del lib
        lib_ms = cuda_ms(torch, lambda o: o.index_reduce_(0, index, rows,
                                                          "amax"), reps,
                         setup=lambda: (out0.clone(),))
        del rows, index
    w = out0.shape[1]
    rows_src = torch.unique(src).numel()
    rows_dst = torch.unique(dst).numel()
    bnd = bound_ms(rows_src * w + 2 * rows_dst * w + 8 * src.numel())
    return ms, plain_ms, bnd, bound_ms(src.numel() * w), lib_ms, want


def _into_line(name, what, ms, plain_ms, bnd, floor, lib_ms) -> str:
    lib = "null" if lib_ms is None else f"{lib_ms:.4f} ms (index_reduce_)"
    return (f"kernel vs plain: {name}: {what}: equal; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms (bytes), gather "
            f"floor {floor:.4f} ms, library {lib}")


def compare_propagate_into(torch, np, regs, src, dst, layout, report):
    """The two-panel launcher against its plain version, bit for bit, at
    the three shapes the sharded phase gives it, shard 0 of SHARDS on the
    scale-22 panel (``out`` is rows [0, v_loc), its own allocation):

    * a ring step: the edges whose source lies in block 1 (another
      allocation of v_loc rows), plus 4,096 self-index pairs ``(x, x)``,
      which name two different vertices there; the result must also
      differ from the plain version without those pairs (a skip would
      show). This shape is the kernels line's row.
    * the all-gather merge: every edge into shard 0 over the gathered
      panel (a copy of all n_pad rows, V_src = SHARDS * V_out);
    * the replica pre-pass: the edges into shard 0 whose source is one of
      the 1,024 highest in-degree vertices, over a panel of those rows.

    Each shape's line gives the run length the wrapper chose
    (``hll_propagate.run_edges``) and the gather floor beside the bound.
    """
    from repro_torch.kernels import hll_propagate

    v_loc = regs.shape[0] // SHARDS
    name = "hll_propagate_into" + ("_packed" if layout == "packed" else "")
    sms = torch.cuda.get_device_properties(regs.device).multi_processor_count
    out0 = regs[:v_loc].clone()

    keep = (dst < v_loc) & (src >= v_loc) & (src < 2 * v_loc)
    s_blk, d_blk = src[keep] - v_loc, dst[keep]
    k = min(4096, v_loc)
    x = torch.from_numpy(np.random.default_rng(SEED + 7).choice(
        v_loc, k, replace=False).astype(np.int32)).to(regs.device)
    s_all, d_all = hll_propagate.sort_routing(torch.cat([s_blk, x]),
                                              torch.cat([d_blk, x]))
    block = regs[v_loc:2 * v_loc].clone()
    ms, plain_ms, bnd, floor, lib_ms, want = _check_into(
        torch, name, out0, block, s_all, d_all, layout, 10)
    without = hll_propagate.plain_into(out0.clone(), block, s_blk, d_blk,
                                       layout=layout)
    if torch.equal(want, without):
        fail(f"{name}: the self-index pairs changed nothing; the check "
             f"cannot see a skip")
    report(name, 0, ms, plain_ms, bnd, lib_ms,
           f"ring step of {SHARDS} shards: {s_all.numel()} edges "
           f"({int(keep.sum())} of block 1 into shard 0, {k} self-index "
           f"pairs), {v_loc} + {v_loc} rows, runs of "
           f"{hll_propagate.run_edges(s_all.numel(), sms)} edges; gather "
           f"floor {floor:.4f} ms; equal, and a skip of src == dst would "
           f"differ")
    del block, want, without, s_all, d_all, s_blk, d_blk, keep

    into0 = dst < v_loc  # the whole routing is dst-sorted: so is the group
    s_ag, d_ag = src[into0], dst[into0]
    full = regs.clone()
    ms, plain_ms, bnd, floor, lib_ms, _ = _check_into(
        torch, name, out0, full, s_ag, d_ag, layout, 5)
    log(_into_line(name, f"all-gather merge of shard 0: {s_ag.numel()} "
                   f"edges, {full.shape[0]} source rows into {v_loc}, runs "
                   f"of {hll_propagate.run_edges(s_ag.numel(), sms)} edges",
                   ms, plain_ms, bnd, floor, lib_ms))
    del full

    deg = torch.bincount(src.to(torch.int64), minlength=regs.shape[0])
    hot = torch.topk(deg, 1024).indices.sort().values
    hit = torch.isin(s_ag.to(torch.int64), hot)
    slot = torch.searchsorted(hot, s_ag[hit].to(torch.int64)).to(torch.int32)
    rep = regs[hot].clone()
    ms, plain_ms, bnd, floor, lib_ms, _ = _check_into(
        torch, name, out0, rep, slot, d_ag[hit], layout, 10)
    log(_into_line(name, f"replica pre-pass of shard 0: {slot.numel()} "
                   f"edges, {rep.shape[0]} replica rows into {v_loc}, runs "
                   f"of {hll_propagate.run_edges(slot.numel(), sms)} edges",
                   ms, plain_ms, bnd, floor, lib_ms))


def compare_newton(torch, np, regs, edges, stats16, sz16, report):
    """Phase 4: ``intersection_newton`` (50 steps) against its plain
    version on the main path's 16,384 pairs (``stats16``, ``sz16``: their
    ``intersection_stats``) and on 2^18 edge pairs, from the initializer
    the engine takes. The pairs the overflow flag rejects keep their start
    bit for bit; the rest as ``tests/test_torch_intersection_newton.py``
    holds them (a gap: a rate's change over the pair's union): resolved
    pairs within 1e-5, all but 0.5% within 1e-3. Times, launches and both
    bounds printed; the 2^18 call is the kernel's row."""
    from repro_torch.core import hll, intersection
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build, intersection_stats
    from repro_torch.kernels import intersection_newton as newton

    dev = torch.device(DEVICE)
    cfg = HLLConfig(p=P)
    q, r, iters = cfg.q, cfg.r, intersection.NEWTON_ITERS
    pick = np.random.default_rng(SEED + 1).choice(len(edges), ERTL_PAIRS,
                                                  replace=False)
    ends = torch.from_numpy(edges[pick].astype(np.int32)).to(dev)
    st18, sz18 = intersection_stats.intersection_stats(
        regs, ends[:, 0].contiguous(), ends[:, 1].contiguous(), q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for stats, sz in ((stats16, sz16), (st18, sz18)):
        b = stats.shape[0]
        ea, eb, eu = (hll.estimate_from_stats(sz[:, i, 0], sz[:, i, 1], cfg)
                      for i in range(3))
        theta0 = intersection._initial_theta(ea, eb, eu).contiguous()
        before = _build.launch_counts()["intersection_newton"]
        got = newton.intersection_newton(theta0, stats, q, r, iters)
        torch.cuda.synchronize()
        launches = _build.launch_counts()["intersection_newton"] - before
        want = newton.plain(theta0, stats, q, r, iters)
        u, d = newton.survival_weights(q, dev)
        flags = newton.hessian_overflows(theta0, u, d, r)
        if launches != 1 or not torch.equal(got[flags], theta0[flags]):
            fail(f"intersection_newton: {launches} launches for one call, or "
                 f"a pair the overflow flag rejects moved ({b} pairs)")
        lg, lw = torch.exp(got.double()), torch.exp(want.double())
        union = lw.sum(-1)
        gap = (lg - lw).abs().amax(-1) / union
        resolved = lw[:, 2] / union >= 1.04 / r ** 0.5
        widest = float(gap[resolved].max()) if bool(resolved.any()) else 0.0
        wide = float((gap > 1e-3).double().mean())
        if (not bool(torch.isfinite(got).all()) or widest > 1e-5
                or wide > 0.005):
            fail(f"intersection_newton differs from its plain version ({b} "
                 f"pairs): resolved gap {widest:.3e}, share over 1e-3 {wide}")
        ms = cuda_ms(torch, lambda: newton.intersection_newton(
            theta0, stats, q, r, iters), 10)
        plain_ms = cuda_ms(torch, lambda: newton.plain(
            theta0, stats, q, r, iters), 1 if b > N_PAIRS else 3)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            newton.plain(theta0, stats, q, r, iters)
            torch.cuda.synchronize()
        plain_launches = sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        bytes_ms = bound_ms(b * (4 * 5 * (q + 2) + 2 * 4 * 3))
        arith_ms = (b * iters * (q + 2) * NEWTON_EVALS * NEWTON_EVAL_INSTR
                    / (sms * 128 * NEWTON_CLOCK_HZ) * 1e3)
        shape = (f"{b} pairs x {iters} steps, 1 launch (plain: "
                 f"{plain_launches} device operations); bytes bound "
                 f"{bytes_ms:.4f} ms; flagged {int(flags.sum())} kept, "
                 f"resolved {int(resolved.sum())}: widest gap {widest:.3e}, "
                 f"share over 1e-3 {wide:.2e}")
        if b > N_PAIRS:
            report("intersection_newton", widest, ms, plain_ms, arith_ms,
                   None, shape, bound_by="arithmetic estimate")
        else:
            log(f"kernel vs plain: intersection_newton at the main path's "
                f"pairs: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"arithmetic estimate {arith_ms:.4f} ms; {shape}")


def compare_hip_delta(torch, np, prev, cur, report):
    """hip_delta_rows against its plain version: D^1 -> D^2 of the main
    panel, then ragged row counts with registers up to max_register and
    lanes that fell. Exact equality (both sum exactly, round once)."""
    from repro_torch.kernels import hip_delta
    out_k = hip_delta.hip_delta_rows(prev, cur)
    out_p = hip_delta.plain(prev, cur)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail("hip_delta_rows differs from its plain version on D^1 -> D^2")
    err = float((out_k - out_p).abs().max())
    hold_candidates(torch, "hip_delta", "byte",
                    lambda **kw: hip_delta.hip_delta_rows(prev, cur, **kw),
                    out_p)
    rows, r = prev.shape
    grew = int((out_k > 0).sum())
    rng = np.random.default_rng(SEED + 3)
    for p, m in ((4, 1), (8, 33), (8, 4097), (12, 515), (16, 7)):
        top = 65 - p
        a = rng.integers(0, top + 1, (m, 1 << p))
        b = np.clip(a + rng.integers(-3, 4, a.shape), 0, top)
        a_t, b_t = (torch.from_numpy(x.astype(np.uint8)).to(DEVICE)
                    for x in (a, b))
        if not torch.equal(hip_delta.hip_delta_rows(a_t, b_t),
                           hip_delta.plain(a_t, b_t)):
            fail(f"hip_delta_rows differs from its plain version at p={p}, "
                 f"{m} rows")
    ms = cuda_ms(torch, lambda: hip_delta.hip_delta_rows(prev, cur), 10)
    plain_ms = cuda_ms(torch, lambda: hip_delta.plain(prev, cur), 3)
    report("hip_delta_rows", err, ms, plain_ms,
           bound_ms(2 * rows * r + 4 * rows), None,
           f"D^1 -> D^2, {rows} rows, {grew} grew; sweep of p 4-16 equal")


def compare_packed_kernels(torch, np, edges, n, pairs, sets, skew, panel,
                           report):
    """Phase 4, packed layout: each packed kernel against its plain
    version on the card at the main path's shapes (the scale-22 panel
    packed, 512 MiB), every output equal bit for bit, and equal to the
    byte kernel on the unpacked (clamped) panel. ``panel`` is the byte
    panel on the host; returns its packed image, on the host."""
    from repro_torch.engine import plans
    from repro_torch.kernels import ertl_stats, hll_accumulate, hll_estimate
    from repro_torch.kernels import hll_propagate, intersection_stats
    from repro_torch.kernels import packing, union_estimate

    dev = torch.device(DEVICE)
    w, q = 1 << (P - 1), 64 - P
    n_pad = panel.shape[0]
    byte = panel.to(dev)
    want = packing.pack_rows(byte)

    def reg_err(a, b):
        """Max abs difference over the unpacked registers."""
        return int((packing.unpack_rows(a).to(torch.int16)
                    - packing.unpack_rows(b).to(torch.int16)).abs().max())

    directed = np.concatenate([edges, edges[:, ::-1]])
    rows = torch.from_numpy(np.ascontiguousarray(directed[:, 0])).to(dev)
    keys = torch.from_numpy(directed[:, 1].astype(np.uint32)).to(dev)

    # accumulate: the whole graph through the kernel and the plain version
    regs_k = torch.zeros((n_pad, w), dtype=torch.uint8, device=dev)
    regs_p = torch.zeros_like(regs_k)
    hll_accumulate.hll_accumulate(regs_k, rows, keys, p=P, seed=0,
                                  layout="packed")
    hll_accumulate.plain(regs_p, rows, keys, p=P, seed=0, layout="packed")
    torch.cuda.synchronize()
    err = reg_err(regs_k, regs_p)
    if err != 0:
        fail(f"hll_accumulate_packed differs from its plain version "
             f"(max {err})")
    if not torch.equal(regs_k, want):
        fail("hll_accumulate_packed differs from pack_rows of the byte panel")
    regs_c = torch.empty_like(regs_k)
    hold_candidates(torch, "accumulate", "packed",
                    lambda **kw: hll_accumulate.hll_accumulate(
                        regs_c.zero_(), rows, keys, p=P, seed=0,
                        layout="packed", **kw), regs_p)
    del regs_p, regs_c, rows, keys
    report(*accumulate_timing(torch, np, edges, n_pad, "packed", regs_k,
                              err))

    # estimate: the packed panel; the byte kernel on the clamped panel
    clamped = packing.unpack_rows(regs_k)
    out_k = hll_estimate.hll_estimate_stats(regs_k, layout="packed")
    out_p = hll_estimate.plain(regs_k, layout="packed")
    out_b = hll_estimate.hll_estimate_stats(clamped)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_k, out_b)):
        fail("hll_estimate_stats_packed differs from its plain version or "
             "from the byte kernel on the clamped panel")
    err = float((out_k - out_p).abs().max())
    hold_candidates(torch, "estimate", "packed",
                    lambda **kw: hll_estimate.hll_estimate_stats(
                        regs_k, layout="packed", **kw), out_p)
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(
        regs_k, layout="packed"), 10)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(
        regs_k, layout="packed"), 3)
    report("hll_estimate_stats_packed", err, ms, plain_ms,
           bound_ms(n_pad * w + n_pad * 8), None,
           f"{n_pad} rows; equal to the byte kernel on the clamped panel")

    # propagate: the engine's routing; pack_rows commutes with the pass
    from repro_torch.kernels.inputs import directed_routing
    src, dst = directed_routing(edges, dev)
    prop_k = hll_propagate.hll_propagate(regs_k, src, dst, layout="packed")
    prop_p = hll_propagate.plain(regs_k, src, dst, layout="packed")
    torch.cuda.synchronize()
    err = reg_err(prop_k, prop_p)
    if err != 0:
        fail(f"hll_propagate_packed differs from its plain version "
             f"(max {err})")
    hold_candidates(torch, "propagate", "packed",
                    lambda **kw: hll_propagate.hll_propagate(
                        regs_k, src, dst, layout="packed", **kw), prop_p)
    del prop_p
    prop_b = hll_propagate.hll_propagate(byte, src, dst)
    if not torch.equal(packing.pack_rows(prop_b), prop_k):
        fail("pack_rows does not commute with the propagate pass")
    del prop_b, prop_k, byte
    ms = cuda_ms(torch, lambda: hll_propagate.hll_propagate(
        regs_k, src, dst, layout="packed"), 5)
    plain_ms = cuda_ms(torch, lambda: hll_propagate.plain(
        regs_k, src, dst, layout="packed"), 1)
    e_live = src.numel()
    report("hll_propagate_packed", err, ms, plain_ms,
           bound_ms(2 * n_pad * w + 8 * e_live), None,
           f"{e_live} directed edges, dst-sorted routing; pack_rows(byte "
           f"pass) equal")
    compare_propagate_into(torch, np, regs_k, src, dst, "packed", report)
    del src, dst

    # intersection_stats: the main path's pairs
    ids = torch.from_numpy(plans.pad_pairs(pairs)[0]).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st_k, sz_k = intersection_stats.intersection_stats(regs_k, pa, pb, q,
                                                       layout="packed")
    st_p, sz_p = intersection_stats.plain(regs_k, pa, pb, q, layout="packed")
    st_b, sz_b = intersection_stats.intersection_stats(clamped, pa, pb, q)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(sz_k, sz_p)
            and torch.equal(st_k, st_b) and torch.equal(sz_k, sz_b)):
        fail("intersection_stats_packed differs from its plain version or "
             "from the byte kernel on the clamped panel")
    hold_candidates(torch, "intersection_stats", "packed",
                    lambda **kw: intersection_stats.intersection_stats(
                        regs_k, pa, pb, q, layout="packed", **kw),
                    (st_p, sz_p))
    err = max(float((st_k - st_p).abs().max()),
              float((sz_k - sz_p).abs().max()))
    ms = cuda_ms(torch, lambda: intersection_stats.intersection_stats(
        regs_k, pa, pb, q, layout="packed"), 20)
    alone = pair_launcher_ms(torch, regs_k, pa, pb, q, "packed")
    plain_ms = cuda_ms(torch, lambda: intersection_stats.plain(
        regs_k, pa, pb, q, layout="packed"), 3)
    rows_read = torch.unique(ids).numel()
    b = ids.shape[0]
    report("intersection_stats_packed", err, ms, plain_ms,
           bound_ms(rows_read * w + 8 * b + 4 * b * (5 * (q + 2) + 6)), None,
           f"{b} pairs, {rows_read} distinct rows, launcher alone "
           f"{alone:.4f} ms")

    # union_estimate_stats: the main path's padded set panel
    ids_np, mask_np = plans.pad_sets(sets)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    out_k = union_estimate.union_estimate_stats(regs_k, ids, mask,
                                                layout="packed")
    out_p = union_estimate.plain(regs_k, ids, mask, layout="packed")
    out_b = union_estimate.union_estimate_stats(clamped, ids, mask)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_k, out_b)):
        fail("union_estimate_stats_packed differs from its plain version "
             "or from the byte kernel on the clamped panel")
    hold_candidates(torch, "union_estimate", "packed",
                    lambda **kw: union_estimate.union_estimate_stats(
                        regs_k, ids, mask, layout="packed", **kw), out_p)
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(torch, lambda: union_estimate.union_estimate_stats(
        regs_k, ids, mask, layout="packed"), 20)
    alone = set_launcher_ms(torch, regs_k, ids, mask, "packed")
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(
        regs_k, ids, mask, layout="packed"), 3)
    rows_read = np.unique(ids_np[mask_np]).size
    report("union_estimate_stats_packed", err, ms, plain_ms,
           bound_ms(rows_read * w + 5 * ids_np.size + 8 * ids_np.shape[0]),
           None, f"{ids_np.shape[0]} x {ids_np.shape[1]} set panel, "
                 f"{rows_read} distinct rows, launcher alone {alone:.4f} ms")
    compare_skewed_union(torch, np, regs_k, skew, "packed")

    # ertl_stats: 2^18 edge pairs gathered from the packed panel
    pick = np.random.default_rng(SEED + 1).choice(len(edges), ERTL_PAIRS,
                                                  replace=False)
    ends = torch.from_numpy(edges[pick].astype(np.int64)).to(dev)
    a, c = regs_k[ends[:, 0]], regs_k[ends[:, 1]]
    st_k = ertl_stats.ertl_stats(a, c, q, layout="packed")
    st_p = ertl_stats.plain(a, c, q, layout="packed")
    st_b = ertl_stats.ertl_stats(packing.unpack_rows(a),
                                 packing.unpack_rows(c), q)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(st_k, st_b)):
        fail("ertl_stats_packed differs from its plain version or from the "
             "byte kernel on the unpacked rows")
    hold_candidates(torch, "ertl_stats", "packed",
                    lambda **kw: ertl_stats.ertl_stats(a, c, q,
                                                       layout="packed", **kw),
                    st_p)
    err = float((st_k - st_p).abs().max())
    del st_k, st_p, st_b, clamped
    ms = cuda_ms(torch, lambda: ertl_stats.ertl_stats(a, c, q,
                                                      layout="packed"), 10)
    plain_ms = cuda_ms(torch, lambda: ertl_stats.plain(a, c, q,
                                                       layout="packed"), 3)
    report("ertl_stats_packed", err, ms, plain_ms,
           bound_ms(ERTL_PAIRS * (2 * w + 4 * 5 * (q + 2))), None,
           f"{ERTL_PAIRS} gathered edge pairs")
    return regs_k.cpu()


#: phase 4t, step 2: (op, layout) -> seconds its grid took to be held
#: against phase 4's plain result (``hold_candidates``, inside phase 4)
CANDIDATES: dict[tuple[str, str], float] = {}


def hold_candidates(torch, op, layout, run, want):
    """Phase 4t, step 2, run inside phase 4 where its plain result
    ``want`` (a tensor, or a tuple of them) lives: ``run(**candidate)``
    for every candidate of ``op``'s autotune grid, each through the
    kernel's wrapper on phase 4's inputs, equal to ``want`` bit for
    bit."""
    from repro_torch.kernels import autotune
    (name,) = autotune.FALLBACK[op]
    grid = autotune.SWEEPS[op]
    t0 = time.perf_counter()
    for cand in grid:
        got = run(**cand)
        torch.cuda.synchronize()
        pairs = (zip(got, want) if isinstance(want, tuple)
                 else [(got, want)])
        if not all(torch.equal(g, w) for g, w in pairs):
            fail(f"autotune: {op} ({layout}) with {name}={cand[name]} "
                 f"differs from its plain version at phase 4's shape")
    secs = CANDIDATES[(op, layout)] = time.perf_counter() - t0
    log(f"autotune: candidates: {op} ({layout}) {name} "
        f"{[c[name] for c in grid]} each equal to the plain version bit "
        f"for bit at phase 4's shape ({secs:.2f} s)")


def sweep_inputs(torch, np, regs, edges, routing, pairs, sets, layout):
    """Phase 4t: ``ops.<op>``'s tensor arguments at the main path's own
    shapes on one layout's panel ``regs``: the first ``INGEST_BLOCK``
    chunk's directed rows and keys (accumulate), the engine's dst-sorted
    ``routing`` (propagate), the panel (estimate), phase 5's 4,096 sets
    padded as the engine pads them, its 16,384 pairs, phase 4's 2^18
    gathered edge pairs (``ertl_stats``) and D^1 -> D^2 (``hip_delta``,
    byte only)."""
    from repro_torch.engine import plans
    from repro_torch.engine.base import SketchEngine
    from repro_torch.kernels import hll_propagate
    from repro_torch.kernels.inputs import directed_block

    dev = regs.device
    ids_np, mask_np = plans.pad_sets(sets)
    pick = np.random.default_rng(SEED + 1).choice(len(edges), ERTL_PAIRS,
                                                  replace=False)
    ends = torch.from_numpy(edges[pick].astype(np.int64)).to(dev)
    src, dst = routing
    out = {
        "accumulate": (regs, *directed_block(
            edges[:SketchEngine.INGEST_BLOCK], dev)),
        "propagate": (regs, src, dst),
        "estimate": (regs,),
        "union_estimate": (regs, torch.from_numpy(ids_np).to(dev),
                           torch.from_numpy(mask_np).to(dev)),
        "intersection_stats": (regs, torch.from_numpy(
            np.asarray(pairs, dtype=np.int32)).to(dev)),
        "ertl_stats": (regs[ends[:, 0]], regs[ends[:, 1]]),
    }
    if layout == "byte":
        out["hip_delta"] = (regs, hll_propagate.hll_propagate(
            regs, src, dst))
    return out


def _sweep_bound_ms(op, layout, inputs):
    """The cost model's bound of one ``op`` call on ``inputs``
    (``analysis.flops.sketch_op_costs`` into ``roofline_terms`` with the
    default H100 ``HW``), or None for an op the model does not cover."""
    from repro_torch.analysis import flops, roofline_terms, sketch_op_costs
    if op not in flops.SKETCH_OPS:
        return None
    regs = inputs[0]
    shape = {"n": regs.shape[0]}
    if op in ("accumulate", "propagate"):
        shape["edges"] = inputs[1].numel()
    elif op == "union_estimate":
        shape.update(sets=inputs[1].shape[0],
                     set_size=float(inputs[2].sum()) / inputs[1].shape[0])
    elif op == "intersection_stats":
        shape["pairs"] = inputs[1].shape[0]
    c = sketch_op_costs(op, p=P, layout=layout, **shape)
    return roofline_terms(c["flops"], c["hbm_bytes"], 0.0)["bound_s"] * 1e3


def _same_answers(np, got, want):
    """Engine answers equal bit for bit (arrays, tuples and dicts)."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _same_answers(np, got[k], want[k]) for k in want)
    if isinstance(want, tuple):
        return all(_same_answers(np, g, w) for g, w in zip(got, want))
    return np.array_equal(got, want)


def autotune_phase(torch, np, eng, edges, n, pairs, sets, want, secs):
    """Phase 4t, after phase 5 on its byte engine ``eng`` (``want``: its
    answers, ``secs``: its steps' seconds). The packed engine of the same
    panel (``pack_rows``) answers first on the fallback shapes; then
    every op and layout is swept on the card (7 byte, 6 packed) on the
    main path's inputs (``sweep_inputs``), each candidate's time, the
    winner, the fallback and the cost model's bound printed, the drives counted, a second sweep driving none; phase 4's
    candidate checks (``hold_candidates``) must cover all 13; both
    engines answer again with the winners installed, equal to the
    fallback's answers bit for bit (the byte engine's to phase 5's too),
    each step's seconds beside the fallback's rerun here (and, byte,
    phase 5's first run); then the cache is cleared, so every later phase
    runs on the fallback shapes."""
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine.local import LocalEngine
    from repro_torch.kernels import _build, autotune, packing
    from repro_torch.kernels.inputs import directed_routing

    t_phase = time.perf_counter()
    autotune.clear_cache()

    def queries(e):
        """Phase 5's queries on engine ``e``: {step: (answer, seconds)}."""
        e._invalidate_caches()  # neighborhood(3) propagates again
        steps = {
            "degrees": e.degrees,
            "neighborhood": lambda: e.neighborhood(T_MAX),
            "intersection_size": lambda: e.intersection_size(
                pairs, method="mle"),
            "union_size": lambda: e.union_size(sets),
            "query_batch": lambda: e.query_batch(
                degrees=True, vertex_sets=sets, pairs=pairs, method="mle")}
        out = {}
        for name, fn in steps.items():
            t0 = time.perf_counter()
            ans = fn()
            torch.cuda.synchronize()
            out[name] = (ans, time.perf_counter() - t0)
        return out

    peng = LocalEngine.from_regs(packing.pack_rows(eng.regs), n,
                                 HLLConfig(p=P), edges=edges,
                                 layout="packed", device=DEVICE)
    fallback = {"byte": queries(eng), "packed": queries(peng)}
    for name, (ans, _) in fallback["byte"].items():
        if not _same_answers(np, ans, want[name]):
            fail(f"autotune: {name} (byte) rerun on the fallback shapes "
                 f"differs from phase 5's answer")

    # 1. the sweep: every op and layout, from an empty cache, on the main
    # path's own inputs (winners are filed under their size class)
    drives = autotune.drive_count()
    cells = [(op, layout) for op in autotune.SWEEPS
             for layout in ("byte", "packed")
             if not (op == "hip_delta" and layout == "packed")]
    routing = directed_routing(edges, eng.regs.device)
    inputs = {layout: sweep_inputs(torch, np, e.regs, edges, routing, pairs,
                                   sets, layout)
              for layout, e in (("byte", eng), ("packed", peng))}
    expected = 0
    t0 = time.perf_counter()
    for op, layout in cells:
        (name,) = autotune.FALLBACK[op]
        args = inputs[layout][op]
        size = autotune.work_size(op, args)
        won = autotune.sweep(op, p=P, impl="cuda", layout=layout,
                             inputs=args)[name]
        times = {c[name]: ms for c, ms in autotune.sweep_times(
            op, p=P, layout=layout, size=size)}
        expected += len(autotune.SWEEPS[op])
        if sorted(times) != sorted(c[name] for c in autotune.SWEEPS[op]):
            fail(f"autotune: {op} ({layout}) timed {sorted(times)}, not "
                 f"its grid")
        fb = autotune.FALLBACK[op][name]
        best = min(times, key=times.get)
        bnd = _sweep_bound_ms(op, layout, args)
        model = ("modeled bound null" if bnd is None else
                 f"modeled bound {bnd:.4f} ms, the winner at "
                 f"{100 * bnd / times[won]:.1f}% of it")
        log(f"autotune: sweep: {op} ({layout}) {name} at {size} "
            f"(size class {autotune.size_class(size)}): "
            + ", ".join(f"{v} {ms:.4f} ms" for v, ms in times.items())
            + f"; fastest {best} ({times[best] / times[fb]:.3f} of the "
              f"fallback's); winner {won} ({times[won]:.4f} ms), fallback "
              f"{fb} ({times[fb]:.4f} ms); {model}")
    sweep_s = time.perf_counter() - t0
    driven = autotune.drive_count() - drives
    if driven != expected:
        fail(f"autotune: the sweep drove {driven} candidates, not "
             f"{expected}")
    winners = {cell: autotune.tuned_params(
        cell[0], p=P, layout=cell[1],
        size=autotune.work_size(cell[0], inputs[cell[1]][cell[0]]))
        for cell in cells}
    for op, layout in cells:
        if autotune.sweep(op, p=P, impl="cuda", layout=layout,
                          inputs=inputs[layout][op]) != winners[(op, layout)]:
            fail(f"autotune: a second sweep of {op} ({layout}) changed its "
                 f"winner")
    if autotune.drive_count() - drives != expected:
        fail("autotune: a second sweep drove candidates")
    del inputs, routing
    log(f"autotune: swept {len(cells)} cells, {driven} candidates driven in "
        f"{sweep_s:.1f} s (device {autotune.device_kind()}); a second sweep "
        f"drove none; winners "
        + ", ".join(f"{op} ({layout}) {w}" for (op, layout), w in
                    winners.items()))

    # 2. phase 4 held every candidate of every cell against its plain result
    missing = [cell for cell in cells if cell not in CANDIDATES]
    if missing:
        fail(f"autotune: candidates never held against the plain versions: "
             f"{missing}")
    log(f"autotune: phase 4 held {expected} candidates of {len(cells)} cells "
        f"against the plain versions bit for bit in "
        f"{sum(CANDIDATES.values()):.1f} s")

    # 3. the main path's queries with the winners, both layouts
    _build.reset_launch_counts()
    for label, e in (("byte", eng), ("packed", peng)):
        got = queries(e)
        for name, (ans, s) in got.items():
            base, base_s = fallback[label][name]
            if not _same_answers(np, ans, base):
                fail(f"autotune: {name} ({label}) with the winners differs "
                     f"from the fallback's answer")
            first = (f", phase 5 {secs[name]:.3f} s" if label == "byte"
                     else "")
            log(f"autotune: main path ({label}) with the winners: {name}: "
                f"{s:.3f} s (fallback {base_s:.3f} s{first}), equal bit for "
                f"bit")
    counts = _build.launch_counts()
    idle = [k for k in ("hll_estimate_stats", "hll_propagate",
                        "intersection_stats", "union_estimate_stats")
            for k in (k, k + "_packed") if counts[k] == 0]
    if idle:
        fail(f"autotune: the winners' queries never launched {idle}")

    # 4. back to the fallback shapes for every later phase
    autotune.clear_cache()
    if autotune._CACHE:
        fail("autotune: the cache still holds winners")
    log(f"autotune: phase 4t {time.perf_counter() - t_phase:.1f} s; cache "
        f"cleared, later phases on the fallback shapes")


def main_path(torch, np, edges, n, pairs, verts, sets, panel):
    """Phase 5: the port's main path through its entry points."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.kernels import _build

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_secs = {}

    def step(name, fn, extra=lambda out: ""):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        step_secs[name] = secs
        log(f"main: {name}: {secs:.3f} s, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {_build.launch_counts()}{extra(out)}")
        return out, secs

    eng, secs = step("build", lambda: engine.build(
        edges, n, HLLConfig(p=P), device=DEVICE))
    launch_check("main", "hll_accumulate", _build.launch_counts(), 0,
                 -(-len(edges) // eng.INGEST_BLOCK), "build")
    log(f"main: build: {len(edges) / secs / 1e6:.2f} M undirected edges/s "
        f"({2 * len(edges) / secs / 1e6:.2f} M directed inserts/s)")
    if eng.device.type != DEVICE or not torch.equal(eng.regs.cpu(), panel):
        fail("engine.build's panel differs from the kernel-checked panel")

    exact = np.bincount(edges.ravel(), minlength=n).astype(np.float64)
    has = exact > 0

    def mre(deg):
        return float(np.mean(np.abs(deg[has] - exact[has]) / exact[has]))

    deg, _ = step("degrees", eng.degrees,
                  lambda d: f", mean relative error {mre(d):.4f}")
    if not (np.isfinite(deg).all() and deg.shape == (n,)):
        fail("degrees are not finite or have the wrong shape")
    if mre(deg) >= 3 * rel_std(P):
        fail(f"degree error {mre(deg):.4f} >= 3 x 1.04/sqrt(r)")

    before = _build.launch_counts()
    (loc, glob), _ = step("neighborhood", lambda: eng.neighborhood(T_MAX),
                          lambda o: f", global sizes {o[1].tolist()}")
    launch_check("main", "hll_propagate", _build.launch_counts(), before,
                 T_MAX - 1, f"neighborhood({T_MAX})")
    if loc.shape != (T_MAX, n) or not np.isfinite(loc).all():
        fail("neighborhood sizes are not finite or have the wrong shape")
    if not np.array_equal(loc[0], deg) or not np.all(np.diff(glob) > 0):
        fail("neighborhood: hop 1 must equal degrees and sizes must grow")

    before = _build.launch_counts()
    est, _ = step("intersection_size",
                  lambda: eng.intersection_size(pairs, method="mle"),
                  lambda e: f", {len(pairs)} pairs, median estimate "
                            f"{np.median(e):.3f}")
    launch_check("main", "intersection_newton", _build.launch_counts(),
                 before, 1, "intersection_size")
    if est.shape != (len(pairs),) or not np.isfinite(est).all():
        fail("intersection estimates are not finite or have the wrong shape")

    uni, _ = step("union_size", lambda: eng.union_size(sets),
                  lambda u: f", {len(sets)} sets of up to "
                            f"{max(map(len, sets))} ids, median "
                            f"{np.median(u):.3f}")
    hop2 = loc[1][verts]
    if uni.shape != (len(sets),) or not np.allclose(uni, hop2, rtol=1e-5,
                                                    atol=0):
        fail("union_size({v} u N(v)) differs from hop 2 of neighborhood")
    log(f"main: union_size: max relative difference to hop 2 "
        f"{float(np.max(np.abs(uni - hop2) / hop2)):.3e}")

    batch, _ = step("query_batch", lambda: eng.query_batch(
        degrees=True, vertex_sets=sets, pairs=pairs, method="mle"))
    if not (np.array_equal(batch["degrees"], deg)
            and np.array_equal(batch["union"], uni)
            and np.array_equal(batch["intersection"], est)):
        fail("query_batch differs from the per-kind answers")
    log("main: query_batch: degrees, union and intersection equal the "
        "per-kind answers bit for bit")
    counts = _build.launch_counts()
    log(f"kernels: {counts}")
    missing = [k for k in ("hll_accumulate", "hll_estimate_stats",
                           "hll_propagate", "intersection_stats",
                           "union_estimate_stats", "intersection_newton")
               if counts[k] == 0]
    if missing:
        fail(f"main-path kernels never launched: {missing}")
    overflow_share(torch, eng, pairs)
    autotune_phase(torch, np, eng, edges, n, pairs, sets, {
        "degrees": deg, "neighborhood": (loc, glob),
        "intersection_size": est, "union_size": uni, "query_batch": batch},
        step_secs)
    return counts, deg, (loc, glob)


def launch_check(label, kernel, counts, before, want, what):
    """Fail unless ``kernel`` launched ``want`` times in ``what``:
    ``counts`` now, ``before`` the counts at its start (0: all zero)."""
    got = counts[kernel] - (before[kernel] if before else 0)
    log(f"{label}: launches: {what} launched {kernel} {got} times "
        f"(expected {want})")
    if got != want:
        fail(f"{label}: {what} launched {kernel} {got} times, not {want}")


def packed_path(torch, np, edges, n, pairs, verts, sets, panel, packed_panel,
                byte_deg):
    """Phase 5b: the main path on the packed layout, launch counters zeroed
    just before; then its answers against the byte kernels on the clamped
    panel, and the registers the clamp changed. ``panel`` and
    ``packed_panel`` are the byte panel and its packed image on the host,
    ``byte_deg`` the byte engine's degrees. Returns (engine, launch
    counts)."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.kernels import _build, packing

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = {}

    def step(name, fn):
        out, times[name] = timed(torch, fn)
        return out

    eng = step("build", lambda: engine.build(
        edges, n, HLLConfig(p=P), layout="packed", device=DEVICE))
    launch_check("packed", "hll_accumulate_packed", _build.launch_counts(),
                 0, -(-len(edges) // eng.INGEST_BLOCK), "build")
    deg = step("degrees", eng.degrees)
    before = _build.launch_counts()
    loc, glob = step("neighborhood", lambda: eng.neighborhood(T_MAX))
    launch_check("packed", "hll_propagate_packed", _build.launch_counts(),
                 before, T_MAX - 1, f"neighborhood({T_MAX})")
    est = step("intersection_size",
               lambda: eng.intersection_size(pairs, method="mle"))
    uni = step("union_size", lambda: eng.union_size(sets))
    batch = step("query_batch", lambda: eng.query_batch(
        degrees=True, vertex_sets=sets, pairs=pairs, method="mle"))
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = len(edges) / times["build"] / 1e6
    steps = ", ".join(f"{name} {secs:.3f} s" for name, secs in times.items())
    log(f"packed: {steps} (build {rate:.2f} M edges/s, neighborhood "
        f"t_max={T_MAX}); max_memory_allocated {peak:.2f} GiB; global sizes "
        f"{glob.tolist()}; launches {counts}")
    if not (eng.layout == "packed" and eng.regs.shape[1] == (1 << P) // 2
            and torch.equal(eng.regs.cpu(), packed_panel)):
        fail("packed: the packed build differs from pack_rows of the byte "
             "panel")
    if not (np.isfinite(deg).all() and np.isfinite(loc).all()
            and np.isfinite(est).all() and np.isfinite(uni).all()):
        fail("packed: answers are not finite")
    if not np.array_equal(loc[0], deg) or not np.all(np.diff(glob) > 0):
        fail("packed: hop 1 must equal degrees and sizes must grow")
    if not np.allclose(uni, loc[1][verts], rtol=1e-5, atol=0):
        fail("packed: union_size({v} u N(v)) differs from hop 2")
    if not (np.array_equal(batch["degrees"], deg)
            and np.array_equal(batch["union"], uni)
            and np.array_equal(batch["intersection"], est)):
        fail("packed: query_batch differs from the per-kind answers")
    exact = np.bincount(edges.ravel(), minlength=n).astype(np.float64)
    has = exact > 0
    mre = float(np.mean(np.abs(deg[has] - exact[has]) / exact[has]))
    if mre >= 3 * rel_std(P):
        fail(f"packed: degree error {mre:.4f} >= 3 x 1.04/sqrt(r)")
    missing = [k + "_packed" for k in (
        "hll_accumulate", "hll_estimate_stats", "hll_propagate",
        "intersection_stats", "union_estimate_stats")
        if counts[k + "_packed"] == 0]
    if missing:
        fail(f"packed: main-path kernels never launched: {missing}")

    # the byte kernels on the clamped panel give the same answers, and
    # pack_rows commutes with every propagate pass
    clamped = engine.LocalEngine.from_regs(
        packing.unpack_rows(eng.regs), n, HLLConfig(p=P), edges=edges,
        device=DEVICE)
    c_loc, _ = clamped.neighborhood(T_MAX)
    same = {"degrees": np.array_equal(clamped.degrees(), deg),
            "neighborhood": np.array_equal(c_loc, loc),
            "intersection_size": np.array_equal(
                clamped.intersection_size(pairs, method="mle"), est),
            "union_size": np.array_equal(clamped.union_size(sets), uni)}
    commute = all(torch.equal(packing.pack_rows(b), a) for a, b in zip(
        eng._panel_set.panels, clamped._panel_set.panels))
    del clamped
    if not all(same.values()) or not commute:
        fail(f"packed: answers differ from the byte kernels on the clamped "
             f"panel ({same}, panels commute: {commute})")
    saturated = int((panel > packing.SATURATION).sum())
    rows_sat = int((panel > packing.SATURATION).any(dim=1).sum())
    differ = int((deg != byte_deg).sum())
    log(f"packed: registers equal pack_rows of the byte panel; degrees, "
        f"neighborhood({T_MAX}), intersection_size and union_size equal the "
        f"byte kernels' on the clamped panel bit for bit; pack_rows commutes "
        f"with the {len(eng._panel_set.panels) - 1} propagate passes; "
        f"{saturated} of {panel.numel()} byte registers exceed 15 "
        f"({rows_sat} rows); degrees of {differ} of {n} rows differ from "
        f"the byte engine's; degree mean relative error {mre:.4f}")
    return eng, counts


def packed_durability(torch, np, edges, n, eng):
    """Phase 5c: save and load the packed scale-22 engine, load it as
    byte (exact unpack), and merge even/odd half builds. Returns the
    launch counts, zeroed just before."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build, packing

    _build.reset_launch_counts()
    path = ROOT / "build" / "chip_smoke_packed_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        step, t_save = timed(torch, lambda: eng.save(str(path)))
        written = sum(f.stat().st_size for f in Path(step).iterdir())
        back, t_load = timed(torch, lambda: engine.load(str(path),
                                                        device=DEVICE))
        if not (back.layout == "packed" and torch.equal(back.regs, eng.regs)
                and back.m == eng.m):
            fail("packed checkpoint: the loaded engine differs")
        del back
        as_byte, t_cross = timed(torch, lambda: engine.load(
            str(path), layout="byte", device=DEVICE))
        if not (as_byte.layout == "byte" and torch.equal(
                as_byte.regs, packing.unpack_rows(eng.regs))):
            fail("packed checkpoint: load(layout='byte') is not the exact "
                 "unpack")
        del as_byte
    finally:
        shutil.rmtree(path, ignore_errors=True)
    (left, right), t_build = timed(torch, lambda: tuple(
        engine.build(edges[i::2], n, HLLConfig(p=P), layout="packed",
                     device=DEVICE) for i in (0, 1)))
    _, t_merge = timed(torch, lambda: left.merge(right))
    if not torch.equal(left.regs, eng.regs) or left.m != len(edges):
        fail("packed merge: the merged halves differ from the one-shot build")
    counts = _build.launch_counts()
    log(f"packed: save {t_save:.3f} s ({written / 2**20:.1f} MiB written), "
        f"load {t_load:.3f} s, load(layout='byte') {t_cross:.3f} s, both "
        f"bit for bit; two half builds {t_build:.3f} s, merge "
        f"{t_merge:.4f} s, equal to the one-shot build; launches {counts}")
    return counts


def timed(torch, fn):
    """(result, seconds) of ``fn`` on the host clock, ending in a sync."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_balls(torch, np, edges, n, sources, t_max):
    """int64[t_max, len(sources)]: |{y : d(s, y) <= t}| counting s itself,
    by a multi-source BFS on the card (a float reach panel [n, sources]
    grown by ``index_add_`` over the directed edges, one hop a step)."""
    dev = torch.device(DEVICE)
    src = torch.from_numpy(np.concatenate([edges[:, 0], edges[:, 1]])).to(
        dev, torch.int64)
    dst = torch.from_numpy(np.concatenate([edges[:, 1], edges[:, 0]])).to(
        dev, torch.int64)
    k = len(sources)
    reach = torch.zeros((n, k), dtype=torch.float32, device=dev)
    reach[torch.from_numpy(sources).to(dev), torch.arange(k, device=dev)] = 1
    sizes = []
    chunk = 1 << 24
    for _ in range(t_max):
        grown = reach.clone()
        for s0 in range(0, src.numel(), chunk):
            grown.index_add_(0, dst[s0:s0 + chunk], reach[src[s0:s0 + chunk]])
        reach = (grown > 0).to(torch.float32)
        sizes.append(reach.sum(dim=0))
    return torch.stack(sizes).to(torch.int64).cpu().numpy()


def ads_path(torch, np, edges, n):
    """Phase 6: the ADS family's distance queries at RMAT scale SCALE.

    Returns (engine, launch counts, distance histogram)."""
    from repro_torch import engine
    from repro_torch.core import ads
    from repro_torch.core.ads import ADSConfig
    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    eng, t_build = timed(torch, lambda: engine.build(
        edges, n, ADSConfig(p=P), family="ads", device=DEVICE))
    (hist, glob), t_hist = timed(torch,
                                 lambda: eng.distance_histogram(ADS_T))
    hist_counts = _build.launch_counts()
    close, t_close = timed(torch, lambda: eng.closeness(ADS_T))
    eff, t_eff = timed(torch, lambda: eng.effective_diameter(ADS_T, q=0.9))
    counts = _build.launch_counts()
    log(f"ads: build {t_build:.3f} s ({len(edges) / t_build / 1e6:.2f} M "
        f"edges/s); distance_histogram({ADS_T}) {t_hist:.3f} s, "
        f"closeness({ADS_T}) {t_close:.4f} s, effective_diameter({ADS_T}, "
        f"0.9) {t_eff:.4f} s = {eff:.4f}; global histogram "
        f"{glob.tolist()}; launches {counts}")
    if hist.shape != (ADS_T, n) or not np.isfinite(hist).all():
        fail("ads: histograms are not finite or have the wrong shape")
    if not ((hist >= 0).all() and np.array_equal(glob, hist.sum(axis=1))):
        fail("ads: histograms are negative or do not sum to glob")
    passes = eng.propagate_passes
    deg = eng.degrees()
    if not np.array_equal(hist[0], deg.astype(np.float64)):
        fail("ads: C^1 differs from degrees() of the same engine")
    curve = eng._hip_curve(ADS_T)  # the cached rows: no kernel runs
    if not (0.0 <= eff <= ADS_T and eff == ads.effective_diameter_from_curve(
            curve.sum(axis=1), 0.9)):
        fail(f"ads: effective diameter {eff} is outside [0, {ADS_T}] or "
             f"differs from the curve's")
    if not (np.isfinite(close).all() and close.shape == (n,)):
        fail("ads: closeness is not finite or has the wrong shape")
    before = _build.launch_counts()
    again, _ = eng.distance_histogram(ADS_T)
    eng.closeness(ADS_T)
    eng.effective_diameter(ADS_T, q=0.9)
    if (_build.launch_counts() != before or eng.propagate_passes != passes
            or not np.array_equal(again, hist)):
        fail("ads: repeat queries ran kernels or changed their answers")
    if hist_counts["hip_delta_rows"] != ADS_T - 1:
        fail(f"ads: hip_delta_rows launched {hist_counts['hip_delta_rows']}"
             f" times for distance_histogram({ADS_T}), not {ADS_T - 1}")
    missing = [k for k in ("hip_delta_rows", "hll_estimate_stats",
                           "hll_propagate", "hll_accumulate")
               if counts[k] == 0]
    if missing:
        fail(f"ads: kernels never launched: {missing}")
    log(f"ads: repeats of all three queries: 0 launches, 0 propagate "
        f"passes; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    deg_exact = np.bincount(edges.ravel(), minlength=n)
    rng = np.random.default_rng(SEED + 5)
    sources = rng.choice(np.flatnonzero(deg_exact >= 1), ADS_SOURCES,
                         replace=False)
    balls, t_bfs = timed(torch, lambda: exact_balls(
        torch, np, edges, n, sources, ADS_T))
    # Algorithm 2's target: y != s within t hops, plus s itself from t = 2
    truth = balls - 1 + (np.arange(1, ADS_T + 1) >= 2)[:, None]
    est = curve[:, sources]
    mre = float(np.mean(np.abs(est - truth) / truth))
    per_hop = np.mean(np.abs(est - truth) / truth, axis=1)
    log(f"ads: accuracy against exact balls of {ADS_SOURCES} sources "
        f"(BFS {t_bfs:.2f} s): per-vertex mean relative error {mre:.4f} "
        f"(limit {3 * ads.rel_std(P):.4f}), per hop "
        f"{np.round(per_hop, 4).tolist()}, mean exact ball "
        f"{np.round(truth.mean(axis=1), 1).tolist()}")
    if not mre < 3 * ads.rel_std(P):
        fail(f"ads: per-vertex error {mre:.4f} >= 3 x rel_std(p)")
    return eng, counts, hist


def merge_phase(torch, np, edges, n, ads_eng):
    """Phase 7: two half-graph engines merged equal the one-shot panel."""
    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    (left, right), t_build = timed(torch, lambda: tuple(
        engine.build(edges[i::2], n, ADSConfig(p=P), device=DEVICE)
        for i in (0, 1)))
    _, t_merge = timed(torch, lambda: left.merge(right))
    counts = _build.launch_counts()
    if not torch.equal(left.regs, ads_eng.regs) or left.m != len(edges):
        fail("merge: the merged halves differ from the one-shot build")
    log(f"merge: two half builds {t_build:.3f} s, merge {t_merge:.4f} s; "
        f"registers equal the one-shot build bit for bit; launches {counts}")
    return counts


def checkpoint_phase(torch, np, n, ads_eng, hist):
    """Phase 8: save, load, repeat and resume the scale-22 ADS engine."""
    from repro_torch import engine
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    path = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        step, t_save = timed(torch, lambda: ads_eng.save(str(path)))
        written = sum(f.stat().st_size for f in Path(step).iterdir())
        back, t_load = timed(torch, lambda: engine.load(str(path),
                                                        device=DEVICE))
        if not (torch.equal(back.regs, ads_eng.regs) and back.m == ads_eng.m
                and back.family.name == "ads"):
            fail("checkpoint: the loaded engine differs from the saved one")
        (again, _), t_hist = timed(torch,
                                   lambda: back.distance_histogram(ADS_T))
        if not np.array_equal(again, hist):
            fail("checkpoint: distance_histogram differs after load")
        block = np.random.default_rng(SEED + 7).integers(0, n, (1 << 20, 2))
        back.ingest(block)
        ads_eng.ingest(block)
        if not torch.equal(back.regs, ads_eng.regs) or back.m != ads_eng.m:
            fail("checkpoint: ingest after load does not resume")
        counts = _build.launch_counts()
        log(f"checkpoint: save {t_save:.3f} s ({written / 2**20:.1f} MiB "
            f"written), load {t_load:.3f} s, registers equal; "
            f"distance_histogram({ADS_T}) after load {t_hist:.3f} s, bit for "
            f"bit; 2^20 further edges into both: registers equal; launches "
            f"{counts}")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return counts


def triangle_path(torch, np):
    """Phase 9: triangle heavy hitters at RMAT scale TRI_SCALE."""
    from repro_torch import engine
    from repro_torch.core import degreesketch
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    edges = generators.rmat(TRI_SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << TRI_SCALE
    log(f"triangles: graph rmat scale {TRI_SCALE} edge factor {EDGE_FACTOR} "
        f"seed {SEED}: n={n}, m={len(edges)}, "
        f"{time.perf_counter() - t0:.1f} s on the host")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    total, vals, top = eng.triangle_heavy_hitters(TRI_K, mode="edge")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    log(f"triangles: build {t_build:.3f} s; triangle_heavy_hitters(k={TRI_K},"
        f" edge): {secs:.3f} s ({len(edges) / secs / 1e6:.3f} M edges/s), "
        f"edge block {degreesketch.EDGE_BLOCK}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}, total {total:.1f}, top values {vals[:3].tolist()}")
    if not (np.isfinite(vals).all() and len(vals) == TRI_K
            and np.all(np.diff(vals) <= 0)):
        fail("triangle heavy hitters are not finite and descending")
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    if not np.isin(top[:, 0].astype(np.int64) * n + top[:, 1], keys).all():
        fail("triangle heavy hitters returned a pair that is not an edge")
    if not total > 0:
        fail(f"triangle total {total} is not positive")
    if counts["ertl_stats"] == 0 or counts["hll_estimate_stats"] == 0:
        fail(f"the triangle path skipped its kernels: {counts}")
    sample = np.random.default_rng(SEED).choice(len(edges), N_PAIRS,
                                                replace=False)
    overflow_share(torch, eng, edges[sample], "triangles", iters=30)
    return counts


def overflow_share(torch, eng, pairs, label="main: intersection_size",
                   iters=None):
    """Share of ``pairs`` whose Newton step the reference's Hessian-overflow
    flag rejects (kept for parity with the JAX package)."""
    from repro_torch.core import intersection
    ids = torch.as_tensor(pairs).to(eng.device, torch.int32)
    stats, sz = eng.kernels.intersection_stats(eng.regs, ids, eng.cfg)
    start, end = intersection.hessian_overflow_share(
        stats, sz, eng.cfg, iters or intersection.NEWTON_ITERS)
    log(f"{label}: Hessian-overflow flag on {start:.4f} of "
        f"{len(pairs)} pairs at the initializer, {end:.4f} at the final "
        f"iterate")


def small_reference(torch, np):
    """Phase 10: CPU (plain versions) and card agree at RMAT scale 10, in
    both layouts. Returns the launch counts of the packed card run."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators

    tiny = torch.maximum(torch.zeros(1, device=DEVICE),
                         torch.full((1,), 1e-38, device=DEVICE))
    if not bool(tiny[0] > 0):
        fail("the 1e-38 likelihood floor flushes to zero on the card")
    edges = generators.rmat(10, 8, seed=3)
    n = 1 << 10
    cpu = engine.build(edges, n, HLLConfig(p=P), device="cpu")
    gpu = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    if not torch.equal(cpu.regs, gpu.regs.cpu()):
        fail("small reference: registers differ between CPU and card")
    checks = {"degrees": (cpu.degrees(), gpu.degrees(), 1e-5),
              "neighborhood": (cpu.neighborhood(T_MAX)[0],
                               gpu.neighborhood(T_MAX)[0], 1e-5)}
    sample = edges[np.random.default_rng(3).choice(len(edges), 256,
                                                   replace=False)]
    deg = cpu.degrees()
    # |A u B| <= |A| + |B|: the terms of the difference, as in the tests
    scale = 2 * (deg[sample[:, 0]] + deg[sample[:, 1]])
    for method, rtol in (("ie", 1e-5), ("mle", 1e-4)):
        a = cpu.intersection_size(sample, method=method, iters=10)
        b = gpu.intersection_size(sample, method=method, iters=10)
        if not np.all(np.abs(a - b) <= rtol * (np.abs(a) + scale)):
            fail(f"small reference: intersection {method} differs")
    rng = np.random.default_rng(4)
    sets = [rng.integers(0, n, rng.integers(1, 70)) for _ in range(100)]
    checks["union_size"] = (cpu.union_size(sets), gpu.union_size(sets), 1e-5)
    for name, (a, b, rtol) in checks.items():
        if not np.allclose(a, b, rtol=rtol, atol=0):
            fail(f"small reference: {name} differs between CPU and card")
    batch = gpu.query_batch(degrees=True, vertex_sets=sets, pairs=sample,
                            iters=10)
    if not (np.array_equal(batch["degrees"], gpu.degrees())
            and np.array_equal(batch["union"], gpu.union_size(sets))
            and np.array_equal(batch["intersection"], gpu.intersection_size(
                sample, iters=10))):
        fail("small reference: query_batch differs from per-kind answers")
    small_triangles(np, cpu, gpu, edges, n)
    small_ads(torch, np, edges, n)
    ref_on_card(torch, np, gpu, edges, n, sample, sets)
    log("small reference: rmat10 p=8 CPU plain vs card kernels: registers "
        "identical, degrees/neighborhood/union rtol 1e-5, intersection ie "
        "1e-5 / mle 1e-4, query_batch bit for bit, triangles 1e-4 of the "
        "estimates' scale")
    return small_packed(torch, np, edges, n, sample, sets)


def ref_on_card(torch, np, gpu, edges, n, sample, sets):
    """``impl="ref"`` on the card: an engine of the plain versions, byte
    and ADS, with every launch counter still 0 after its calls (the
    counters are zeroed just before them). Its registers and answers equal
    the ``impl="cuda"`` engines' on the card bit for bit, but those of
    the MLE: the plain Newton steps sum in another order than the kernel,
    so intersections and triangles are held as the CPU's are (1e-4 of the
    estimates' scale, ``small_reference`` and ``small_triangles``)."""
    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build

    def answers(eng):
        batch = eng.query_batch(degrees=True, vertex_sets=sets, pairs=sample,
                                iters=10)
        exact = [eng.regs.cpu().numpy(), eng.degrees(),
                 *eng.neighborhood(T_MAX), eng.union_size(sets),
                 eng.intersection_size(sample, method="ie"),
                 batch["degrees"], batch["union"]]
        mle = [eng.intersection_size(sample, iters=10), batch["intersection"]]
        return exact, mle

    def ads_answers(eng):
        hist, glob = eng.distance_histogram(ADS_T)
        return [eng.regs.cpu().numpy(), hist, glob, eng.closeness(ADS_T)]

    want, want_mle = answers(gpu)
    want_ads = ads_answers(engine.build(edges, n, ADSConfig(p=P),
                                        device=DEVICE))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    ref = engine.build(edges, n, HLLConfig(p=P), impl="ref", device=DEVICE)
    got, got_mle = answers(ref)
    for mode in ("edge", "vertex"):
        ref.triangle_heavy_hitters(20, mode=mode)
    got_ads = ads_answers(engine.build(edges, n, ADSConfig(p=P), impl="ref",
                                       device=DEVICE))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: c for k, c in _build.launch_counts().items() if c}
    if ref.device.type != DEVICE or ref.impl != "ref" or launched:
        fail(f"impl='ref' on the card launched kernels: {launched}")
    differ = [i for i, (a, b) in enumerate(zip(got + got_ads,
                                               want + want_ads))
              if not np.array_equal(a, b)]
    if differ:
        fail(f"impl='ref' on the card differs from impl='cuda' in answers "
             f"{differ}")
    deg = want[1]
    scale = 2 * (deg[sample[:, 0]] + deg[sample[:, 1]])
    for a, b in zip(got_mle, want_mle):
        if not np.all(np.abs(a - b) <= 1e-4 * (np.abs(b) + scale)):
            fail("impl='ref' on the card differs from impl='cuda' in its "
                 "MLE intersections beyond 1e-4 of the estimates' scale")
    small_triangles(np, gpu, ref, edges, n, "impl='ref' against 'cuda'")
    log(f"small reference: impl='ref' on the card ({secs:.1f} s, byte and "
        f"ADS engines): registers and {len(want) + len(want_ads) - 2} "
        f"answers equal impl='cuda' bit for bit, the MLE's "
        f"{len(want_mle)} within 1e-4 of the estimates' scale and the "
        f"triangles as the CPU's; launches 0")


def small_packed(torch, np, edges, n, sample, sets):
    """The packed engine at RMAT scale 10 on the card, launch counters
    zeroed just before (its triangles are the engine path of
    ``ertl_stats_packed``), against the CPU's plain versions (the
    tolerances of the byte checks) and against the byte kernels on the
    clamped panel (bit for bit). Returns the launch counts."""
    from repro_torch import engine
    from repro_torch.core import degreesketch as dsk
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build, packing

    cfg = HLLConfig(p=P)

    def answers(eng):
        return {"degrees": eng.degrees(),
                "neighborhood": eng.neighborhood(T_MAX)[0],
                "union_size": eng.union_size(sets),
                "ie": eng.intersection_size(sample, method="ie", iters=10),
                "mle": eng.intersection_size(sample, method="mle", iters=10),
                "edge": eng.triangle_heavy_hitters(20, mode="edge"),
                "vertex": eng.triangle_heavy_hitters(20, mode="vertex")}

    _build.reset_launch_counts()
    gpu = engine.build(edges, n, cfg, layout="packed", device=DEVICE)
    got = answers(gpu)
    batch = gpu.query_batch(degrees=True, vertex_sets=sets, pairs=sample,
                            iters=10)
    counts = _build.launch_counts()
    # the local engine's packed kernels (the two-panel merge is the
    # sharded backend's, launched in phase 5h)
    missing = [k for k, c in counts.items() if k.endswith("_packed")
               and k != "hll_propagate_into_packed" and c == 0]
    if missing:
        fail(f"small reference: packed kernels never launched: {missing}")
    if not (np.array_equal(batch["degrees"], got["degrees"])
            and np.array_equal(batch["union"], got["union_size"])
            and np.array_equal(batch["intersection"], got["mle"])):
        fail("small reference: packed query_batch differs from per-kind "
             "answers")
    cpu = engine.build(edges, n, cfg, layout="packed", device="cpu")
    if not torch.equal(cpu.regs, gpu.regs.cpu()):
        fail("small reference: packed registers differ between CPU and card")
    want = answers(cpu)
    for name in ("degrees", "neighborhood", "union_size"):
        if not np.allclose(got[name], want[name], rtol=1e-5, atol=0):
            fail(f"small reference: packed {name} differs between CPU and "
                 f"card")
    deg = want["degrees"]
    scale = 2 * (deg[sample[:, 0]] + deg[sample[:, 1]])
    for method, rtol in (("ie", 1e-5), ("mle", 1e-4)):
        if not np.all(np.abs(got[method] - want[method])
                      <= rtol * (np.abs(want[method]) + scale)):
            fail(f"small reference: packed intersection {method} differs")
    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cpu.regs, n=n, cfg=cfg, layout="packed"), edges)
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        (g_tot, g_vals, _), (c_tot, c_vals, _) = got[mode], want[mode]
        if not (abs(g_tot - c_tot) <= tol.sum() / 3
                and np.allclose(g_vals, c_vals, rtol=0, atol=atol)):
            fail(f"small reference: packed {mode} triangles differ")
    clamped = answers(engine.LocalEngine.from_regs(
        packing.unpack_rows(gpu.regs), n, cfg, edges=edges, device=DEVICE))
    def same(a, b):  # triangle answers are (total, values, ids) tuples
        if isinstance(a, tuple):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    differ = [name for name in got if not same(got[name], clamped[name])]
    if differ:
        fail(f"small reference: packed answers differ from the byte kernels "
             f"on the clamped panel: {differ}")
    log(f"small reference: packed rmat10 p={P}: registers identical CPU vs "
        f"card; degrees/neighborhood/union rtol 1e-5, intersection ie 1e-5 "
        f"/ mle 1e-4, triangles (edge, vertex) 1e-4 of the estimates' scale;"
        f" card answers equal the byte kernels' on the clamped panel bit for"
        f" bit; launches {counts}")
    return counts


def small_ads(torch, np, edges, n):
    """The ADS curve from the CPU's plain versions and from the card
    (``rtol=1e-6``), both against exact ball sizes with the tolerances of
    ``tests/test_ads.py``."""
    from repro_torch import engine
    from repro_torch.core import ads
    from repro_torch.core.ads import ADSConfig
    from repro_torch.graph import exact

    cpu = engine.build(edges, n, ADSConfig(p=P), device="cpu")
    gpu = engine.build(edges, n, ADSConfig(p=P), device=DEVICE)
    curves = {"cpu": cpu._hip_curve(ADS_T), "card": gpu._hip_curve(ADS_T)}
    if not np.allclose(curves["card"], curves["cpu"], rtol=1e-6, atol=0):
        fail("small reference: the ADS curve differs between CPU and card")
    truth = exact.neighborhood_truth(n, edges, ADS_T)
    truth_glob = truth.sum(axis=1).astype(np.float64)
    eff_exact = ads.effective_diameter_from_curve(truth_glob, 0.9)
    tol = ads.rel_std(P)
    mask = truth > 0
    for name, curve in curves.items():
        glob = curve.sum(axis=1)
        g_mre = float(np.mean(np.abs(glob - truth_glob)
                              / np.maximum(truth_glob, 1.0)))
        v_mre = float(np.mean(np.abs(curve[mask] - truth[mask])
                              / truth[mask]))
        eff = ads.effective_diameter_from_curve(glob, 0.9)
        log(f"small reference: ads {name}: global MRE {g_mre:.4f} (< "
            f"{2 * tol:.4f}), per-vertex {v_mre:.4f} (< {3 * tol:.4f}), "
            f"effective diameter {eff:.4f} vs exact {eff_exact:.4f}")
        if not (g_mre < 2 * tol and v_mre < 3 * tol
                and abs(eff - eff_exact) < 0.5):
            fail(f"small reference: the {name} ADS curve misses the exact "
                 f"ball sizes")


def small_triangles(np, cpu, gpu, edges, n, label="CPU against card"):
    """Both triangle modes, ``cpu`` against ``gpu`` (1e-4 of each edge's
    estimates' scale, summed as the query sums them), and the top-20
    recall against exact counts (reported, not gated)."""
    from repro_torch.core import degreesketch as dsk
    from repro_torch.graph import exact

    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cpu.regs, n=n, cfg=cpu.cfg), edges)
    deg = cpu.degrees()
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    truth = exact.exact_edge_triangles(n, edges)
    want_ids = {"edge": edges, "vertex": np.arange(n)}
    want_top = {"edge": truth, "vertex": exact.exact_vertex_triangles(
        n, edges, truth)}
    recall = {}
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        c_tot, c_vals, _ = cpu.triangle_heavy_hitters(20, mode=mode)
        g_tot, g_vals, g_ids = gpu.triangle_heavy_hitters(20, mode=mode)
        if not (abs(c_tot - g_tot) <= tol.sum() / 3
                and np.allclose(g_vals, c_vals, rtol=0, atol=atol)):
            fail(f"small reference: {mode} triangles differ ({label})")
        exact_top = want_ids[mode][np.argsort(-want_top[mode])[:20]]
        hits = {tuple(np.atleast_1d(x)) for x in g_ids} & {
            tuple(np.atleast_1d(x)) for x in exact_top}
        recall[mode] = len(hits) / 20
    log(f"small reference: triangles ({label}): estimated total "
        f"{g_tot:.1f}, exact "
        f"{exact.exact_global_triangles(n, edges, truth)}; top-20 recall "
        f"against exact counts: edges {recall['edge']:.2f}, vertices "
        f"{recall['vertex']:.2f} (reported, not gated)")


def functional_phase(torch, np, edges, n, panel, deg, hops):
    """Phase 5f: the functional core API on the main path's graph, launch
    counters zeroed just before: ``degreesketch.accumulate`` (one launch
    per 2^15 directed edges, the JAX package's block), its registers the
    main path's panel bit for bit; ``hll.degree_estimates`` the engine's
    ``degrees()`` bit for bit; ``neighborhood_estimates(.., 3)`` from that
    sketch (one routing, two propagate and three estimate launches) the
    engine's ``neighborhood(3)`` bit for bit, ``glob`` included (both sum
    the same float32 estimates in numpy). Returns the launch counts."""
    from repro_torch.core import degreesketch as dsk, hll
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build

    cfg = HLLConfig(p=P)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    secs = {}
    t0 = time.perf_counter()
    ds = dsk.accumulate(edges, n, cfg, device=DEVICE)
    torch.cuda.synchronize()
    secs["accumulate"] = time.perf_counter() - t0
    block = 1 << 15
    launch_check("functional", "hll_accumulate", _build.launch_counts(), 0,
                 -(-2 * len(edges) // block), "degreesketch.accumulate")
    if not torch.equal(ds.regs.cpu(), panel):
        fail("functional: degreesketch.accumulate differs from the main "
             "path's panel")
    before = _build.launch_counts()
    t0 = time.perf_counter()
    d = hll.degree_estimates(ds.regs, cfg).cpu().numpy()[:n]
    secs["degree_estimates"] = time.perf_counter() - t0
    launch_check("functional", "hll_estimate_stats", _build.launch_counts(),
                 before, 1, "hll.degree_estimates")
    if not np.array_equal(d, deg):
        fail("functional: hll.degree_estimates differs from engine.degrees()")
    before = _build.launch_counts()
    t0 = time.perf_counter()
    local, glob, d3 = dsk.neighborhood_estimates(edges, n, cfg, T_MAX,
                                                 sketch=ds)
    torch.cuda.synchronize()
    secs["neighborhood_estimates"] = time.perf_counter() - t0
    after = _build.launch_counts()
    launch_check("functional", "hll_propagate", after, before, T_MAX - 1,
                 f"neighborhood_estimates(.., {T_MAX})")
    launch_check("functional", "hll_estimate_stats", after, before, T_MAX,
                 f"neighborhood_estimates(.., {T_MAX})")
    if not (np.array_equal(local, hops[0]) and np.array_equal(glob, hops[1])):
        fail("functional: neighborhood_estimates differs from "
             "engine.neighborhood")
    if torch.equal(d3.regs, ds.regs) or not torch.equal(ds.regs.cpu(),
                                                        panel):
        fail("functional: the passes changed the accumulated sketch")
    log(f"functional: rmat{SCALE} p={P}: accumulate {secs['accumulate']:.3f}"
        f" s, degree_estimates {secs['degree_estimates']:.4f} s, "
        f"neighborhood_estimates({T_MAX}) "
        f"{secs['neighborhood_estimates']:.3f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; registers, "
        f"degrees, local and glob equal the engine's bit for bit; launches "
        f"{_build.launch_counts()}")
    return _build.launch_counts()


def colored_phase(torch, np, edges, n, panel):
    """Phase 5g: colored sketches on the main path's graph, ``COLORS``
    seeded colors, launch counters zeroed just before:
    ``colored_accumulate`` then ``colored_neighborhood(t_max=2)``; the max
    over the planes equals the plain panel bit for bit at t=1 and its
    ``D^2`` at t=2 (register max is associative); the t=1 plane row of
    each of ``COLOR_HUBS`` hubs and each color equal to the sketch of the
    hub's exact neighbors of that color built by the plain version
    (``ops.accumulate(.., impl="ref")``, which the CPU tests hold byte
    for byte to the JAX package's ``hll.insert``); ``count`` of those
    rows against the exact counts: gated on the root mean square of the
    relative errors, ``COLOR_RMS_BOUND * rel_std``, and reported against
    ``tests/test_colored.py``'s ``4 * rel_std`` per count. One count at
    the smoke's seed is a 4.2-sigma draw of the hash, equal in the JAX
    package and inside 2.3 sigma under 32 other hash seeds
    (``scripts/colored_draws.py``); a one-count bound at 4 sigma fails
    on such draws, while the root mean square of 24 unit errors exceeds
    2 with a probability under 1e-9 (chi-square, 24 degrees), and a
    plane in the wrong place or a lost color lifts it far past that.
    ``count_and`` of ``COLOR_ANDS`` (x, c1, c2) finite. Returns the launch
    counts."""
    from repro_torch.core import colored, degreesketch as dsk, hll
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.inputs import INGEST_BLOCK, directed_routing

    cfg = HLLConfig(p=P)
    rng = np.random.default_rng(SEED + 7)
    colors = rng.integers(0, COLORS, n)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    sk1 = colored.colored_accumulate(edges, colors, n, cfg, device=DEVICE)
    torch.cuda.synchronize()
    t_acc = time.perf_counter() - t0
    launch_check("colored", "hll_accumulate", _build.launch_counts(), 0,
                 -(-len(edges) // INGEST_BLOCK), "colored_accumulate")
    if not torch.equal(sk1.regs.amax(dim=0).cpu(), panel):
        fail("colored: the max over the planes differs from the plain panel "
             "at t=1")
    before = _build.launch_counts()
    t0 = time.perf_counter()
    sk2 = colored.colored_neighborhood(sk1, edges, 2)
    torch.cuda.synchronize()
    t_pass = time.perf_counter() - t0
    launch_check("colored", "hll_propagate", _build.launch_counts(), before,
                 COLORS, "colored_neighborhood(t_max=2)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    src, dst = directed_routing(edges, sk2.regs.device)
    d2 = dsk.neighborhood_pass(panel.to(DEVICE), src, dst)
    del src, dst
    if not torch.equal(sk2.regs.amax(dim=0), d2):
        fail("colored: the max over the planes differs from D^2 at t=2")
    del d2
    deg = np.bincount(edges.ravel(), minlength=n)
    hubs = np.argsort(-deg)[:COLOR_HUBS]
    near = edges[np.isin(edges[:, 0], hubs) | np.isin(edges[:, 1], hubs)]
    bound = 4 * rel_std(P)
    errs, misses = [], []
    before = _build.launch_counts()
    for x in map(int, hubs):
        nbrs = np.concatenate([near[near[:, 0] == x, 1],
                               near[near[:, 1] == x, 0]])
        for c in range(COLORS):
            own = nbrs[colors[nbrs] == c]
            # the plane row is the sketch of exactly x's c-colored
            # neighbors, as the plain version builds it
            plain = torch.zeros((1, cfg.r), dtype=torch.uint8, device=DEVICE)
            keys = torch.from_numpy(own.astype(np.int32)).to(DEVICE)
            ops.accumulate(plain, torch.zeros_like(keys),
                           keys.view(torch.uint32), cfg, impl="ref")
            if not torch.equal(sk1.regs[c, x], plain[0]):
                fail(f"colored: plane {c} row {x} is not the sketch of its "
                     f"{len(own)} neighbors of color {c}")
            est = sk1.count(x, c)
            errs.append((est - len(own)) / max(len(own), 1))
            if abs(est - len(own)) > max(bound * len(own), 3):
                misses.append((x, c, round(est, 1), len(own)))
    if _build.launch_counts()["hll_accumulate"] != before["hll_accumulate"]:
        fail("colored: the plain version launched hll_accumulate")
    rms = float(np.sqrt(np.mean(np.square(errs))))
    if not rms <= COLOR_RMS_BOUND * rel_std(P):
        fail(f"colored: root mean square error of the {len(errs)} counts "
             f"{rms:.4f} exceeds {COLOR_RMS_BOUND} x rel_std = "
             f"{COLOR_RMS_BOUND * rel_std(P):.4f}: {errs}")
    ands = [(int(hubs[i]), i % COLORS, (i + 1) % COLORS)
            for i in range(COLOR_ANDS)]
    before = _build.launch_counts()
    inter = [sk1.count_and(*a) for a in ands]
    if _build.launch_counts()["ertl_stats"] == before["ertl_stats"]:
        fail("colored: count_and did not launch ertl_stats")
    if not np.isfinite(inter).all():
        fail(f"colored: count_and is not finite: {inter}")
    log(f"colored: rmat{SCALE} p={P}, {COLORS} colors, planes "
        f"{sk1.regs.numel() / 2**30:.2f} GiB: colored_accumulate {t_acc:.3f}"
        f" s, colored_neighborhood(2) {t_pass:.3f} s, max_memory_allocated "
        f"{peak:.2f} GiB; plane max equals the plain panel at t=1 and D^2 "
        f"at t=2 bit for bit; the {COLOR_HUBS} hubs' plane rows equal the "
        f"plain sketches of their exact color classes bit for bit; count "
        f"at t=1 against exact: relative errors {min(errs):+.4f} .. "
        f"{max(errs):+.4f}, root mean square {rms:.4f} (gate "
        f"{COLOR_RMS_BOUND} x rel_std = {COLOR_RMS_BOUND * rel_std(P):.4f})"
        f", {len(misses)} of {len(errs)} outside 4 x rel_std = {bound:.4f} "
        f"{misses} (reported); count_and "
        f"{[round(v, 1) for v in inter]} for {ands}; launches "
        f"{_build.launch_counts()}")
    return _build.launch_counts()


def kron_phase(torch, np):
    """Phase 9k: the Kronecker graph C = A x A, A = rmat(KRON_FACTOR_SCALE,
    8, seed=0), with exact per-edge triangle counts from
    ``kron_edge_triangles`` (their total must be KRON_TRIANGLES), launch
    counters zeroed just before ``engine.build`` and
    ``triangle_heavy_hitters(k=TRI_K, mode="edge")``: finite descending
    values, real edges, ``ertl_stats`` launched; the top-k recall against
    the exact counts (ties at the k-th count included) and the relative
    error of the estimated total are reported, not gated. Returns the
    launch counts."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import exact, generators
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    f = generators.rmat(KRON_FACTOR_SCALE, 8, seed=0)
    nf = 1 << KRON_FACTOR_SCALE
    edges = generators.kronecker_edges(f, nf, f, nf)
    n = nf * nf
    truth = exact.kron_edge_triangles(f, nf, edges)
    t_gen = time.perf_counter() - t0
    total_exact = int(truth.sum()) // 3
    if total_exact != KRON_TRIANGLES:
        fail(f"kron: {total_exact} triangles, expected {KRON_TRIANGLES}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    total, vals, top = eng.triangle_heavy_hitters(TRI_K, mode="edge")
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    if not (np.isfinite(vals).all() and len(vals) == TRI_K
            and np.all(np.diff(vals) <= 0)):
        fail("kron: triangle heavy hitters are not finite and descending")
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    got = top[:, 0].astype(np.int64) * n + top[:, 1]
    if not np.isin(got, keys).all():
        fail("kron: triangle heavy hitters returned a pair that is not an "
             "edge")
    if counts["ertl_stats"] == 0:
        fail(f"kron: the triangle path skipped ertl_stats: {counts}")
    kth = np.sort(truth)[-TRI_K]
    recall = float(np.isin(got, keys[truth >= kth]).sum()) / TRI_K
    log(f"kron: C = A x A, A = rmat({KRON_FACTOR_SCALE}, 8, seed=0) with "
        f"{len(f)} edges: n={n}, m={len(edges)}, exact triangles "
        f"{total_exact} ({t_gen:.1f} s on the host); build {t_build:.3f} s; "
        f"triangle_heavy_hitters(k={TRI_K}, edge) {secs:.3f} s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; estimated total {total:.1f} (relative error "
        f"{(total - total_exact) / total_exact:+.4f}); top-{TRI_K} recall "
        f"{recall:.2f} against exact counts >= {kth} "
        f"({int((truth >= kth).sum())} edges; reported, not gated); launches "
        f"{counts}")
    return counts


# ------------------------------------------------------------------ sharded
def mem_start(torch) -> int:
    """Reset the card's peak memory statistic; returns the bytes held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def mem_peak(torch, base, peaks) -> str:
    """The peak since :func:`mem_start` returned ``base``, as text; the
    peak in bytes is appended to ``peaks``."""
    peak = torch.cuda.max_memory_allocated()
    peaks.append(peak)
    return (f"max_memory_allocated {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:+.2f} GiB over the "
            f"{base / 2**30:.2f} GiB held at the sub-phase's start)")


def _schedule_pass(sd, plan, parts, layout, schedule):
    """One Algorithm 2 pass of ``schedule`` over the shard panels."""
    if schedule == "allgather":
        return sd.dist_propagate_allgather(plan, parts, layout=layout)
    return sd.dist_propagate_ring(plan, parts, layout=layout,
                                  overlap=schedule == "ring_overlap")


def _merges_per_pass(plan, schedule):
    """Two-panel launches one pass of ``schedule`` makes: one per
    non-empty group (ring: shard x source block; all-gather: shard;
    replica groups first)."""
    S = plan.num_shards
    if schedule == "allgather":
        n = sum(int(t.numel() > 0) for t in plan.flat_dst)
    else:
        n = sum(int(plan.ring_off[s][b + 1] > plan.ring_off[s][b])
                for s in range(S) for b in range(S))
    if plan.has_replicas:
        n += sum(int(t.numel() > 0) for t in plan.rep_dst)
    return n


def _same_shards(torch, parts, full, what):
    """Fail unless the shard panels are the row blocks of ``full``."""
    v = parts[0].shape[0]
    for s, part in enumerate(parts):
        if not torch.equal(part, full[s * v:(s + 1) * v]):
            fail(f"sharded: {what}: shard {s} differs from the local panel")


def sharded_layout(torch, np, edges, n, pairs, sets, layout, counted):
    """Phase 5h, one layout: the local engine's panels and answers first
    (outside the counted windows), then the sharded engine at SHARDS
    shards through its entry points, every panel and answer equal to the
    local engine's bit for bit. Returns the sharded engine and the local
    answers."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.distributed import sketch_dist as sd
    from repro_torch.kernels import _build

    local = engine.build(edges, n, HLLConfig(p=P), layout=layout,
                         device=DEVICE)
    want = {"deg": local.degrees(), "nb": local.neighborhood(T_MAX),
            "inter": local.intersection_size(pairs),
            "uni": local.union_size(sets),
            "batch": local.query_batch(degrees=True, vertex_sets=sets,
                                       pairs=pairs)}
    hops = local._panels_up_to(T_MAX)  # D^1 (the built panel) .. D^T_MAX
    del local
    torch.cuda.empty_cache()
    base = mem_start(torch)  # the local panels D^1..D^T_MAX stay held

    def step(name, fn):
        out, secs = timed(torch, lambda: counted(fn))
        log(f"sharded: {layout}: {name}: {secs:.3f} s, "
            f"{mem_peak(torch, base, counted.peaks)}")
        return out

    before = dict(counted.counts)
    eng = step("build", lambda: engine.build(
        edges, n, HLLConfig(p=P), layout=layout, device=DEVICE,
        backend="sharded", shards=SHARDS))
    v_loc = eng.v_loc
    owners = sum(int((np.bincount(edges[c:c + eng.INGEST_BLOCK].ravel()
                                  // v_loc, minlength=SHARDS) > 0).sum())
                 for c in range(0, len(edges), eng.INGEST_BLOCK))
    launch_check("sharded", _build.kernel_name("hll_accumulate", layout),
                 counted.counts, before, owners, f"{layout} build")
    _same_shards(torch, eng.shard_regs, hops[0], f"{layout} build")
    if not np.array_equal(step("degrees", eng.degrees), want["deg"]):
        fail(f"sharded: {layout} degrees differ from the local engine's")
    plan, secs = timed(torch, lambda: eng.plan)
    log(f"sharded: {layout}: routing plan on the card {secs:.3f} s "
        f"(directed edges per shard {[int(t.numel()) for t in plan.acc_dst]}"
        f"), {mem_peak(torch, base, counted.peaks)}")
    into = _build.kernel_name("hll_propagate_into", layout)
    for schedule in ("ring", "ring_overlap", "allgather"):
        sd.reset_copied_bytes()
        before = dict(counted.counts)
        loc, glob = step(f"neighborhood({T_MAX}, {schedule})",
                         lambda: eng.neighborhood(T_MAX, schedule=schedule))
        moved = sd.copied_bytes()
        launch_check("sharded", into, counted.counts, before,
                     (T_MAX - 1) * _merges_per_pass(plan, schedule),
                     f"{layout} neighborhood({T_MAX}, {schedule})")
        for t, panel in enumerate(eng._panels_up_to(T_MAX, schedule)):
            _same_shards(torch, panel, hops[t], f"{layout} {schedule} D^{t + 1}")
        if not (np.array_equal(loc, want["nb"][0])
                and np.array_equal(glob, want["nb"][1])):
            fail(f"sharded: {layout} neighborhood({T_MAX}, {schedule}) "
                 f"differs from the local engine's")
        ms = cuda_ms(torch, lambda: _schedule_pass(
            sd, plan, eng.shard_regs, layout, schedule), 3)
        log(f"sharded: {layout}: {schedule}: one pass {ms:.3f} ms (CUDA "
            f"events, {SHARDS} shards on one card); copied between shards "
            f"per pass: " + ", ".join(
                f"{k} {v / (T_MAX - 1) / 2**30:.3f} GiB"
                for k, v in moved.items() if v) +
            f"; D^1..D^{T_MAX} panels and answers equal the local engine's")
    got = {"inter": step("intersection_size",
                         lambda: eng.intersection_size(pairs)),
           "uni": step("union_size", lambda: eng.union_size(sets)),
           "batch": step("query_batch", lambda: eng.query_batch(
               degrees=True, vertex_sets=sets, pairs=pairs))}
    for key in ("inter", "uni"):
        if not np.array_equal(got[key], want[key]):
            fail(f"sharded: {layout} {key} differs from the local engine's")
    if got["batch"].keys() != want["batch"].keys() or not all(
            np.array_equal(got["batch"][k], want["batch"][k])
            for k in want["batch"]):
        fail(f"sharded: {layout} query_batch differs from the local engine's")
    log(f"sharded: {layout}: build, degrees, neighborhood({T_MAX}) under "
        f"ring, ring_overlap and allgather, {len(pairs)} pairs, {len(sets)} "
        f"sets and query_batch equal the local engine's bit for bit")
    return eng, want, hops[0]


def sharded_reshard(torch, np, eng, edges, n, want, panel, counted):
    """Phase 5h, reshard: install a replica set of the 1,024 highest
    degrees (``neighborhood(2)`` again through the replica pre-pass), save
    at SHARDS shards, load at 1 and 2 shards and on the local backend:
    registers, degrees, ``neighborhood(2)`` and unions unchanged, the
    replica set reinstalled. The directory is removed."""
    from repro_torch import engine

    base = mem_start(torch)
    hot = np.argsort(-np.bincount(edges.ravel(), minlength=n))[:1024]
    counted(lambda: eng.replicate(hot))
    loc, _ = counted(lambda: eng.neighborhood(2, schedule="ring"))
    if not np.array_equal(loc, want["nb"][0][:2]):
        fail("sharded: neighborhood(2) with replicas differs")
    path = ROOT / "build" / "chip_smoke_sharded_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        _, secs = timed(torch, lambda: eng.save(str(path)))
        log(f"sharded: reshard: save at {SHARDS} shards with {len(hot)} "
            f"replicas {secs:.2f} s")
        for backend, shards in (("sharded", 1), ("sharded", 2),
                                ("local", None)):
            def load():
                return engine.load(str(path), backend=backend, shards=shards,
                                   device=DEVICE)
            back, secs = timed(torch, lambda: counted(load)
                               if backend == "sharded" else load())
            if not np.array_equal(back.replicated_ids, np.sort(hot)):
                fail(f"sharded: reshard to {backend} {shards}: replica set "
                     f"not reinstalled")
            if backend == "sharded":
                _same_shards(torch, back.shard_regs, panel,
                             f"reshard to {shards}")
                loc, _ = counted(lambda: back.neighborhood(2))
                deg = counted(back.degrees)
                uni = counted(lambda: back.union_size(want["sets"]))
            else:  # the local engine launches the one-panel kernel
                if not torch.equal(back.regs[:n], panel[:n]):
                    fail("sharded: reshard to local: registers differ")
                loc, _ = back.neighborhood(2)
                deg, uni = back.degrees(), back.union_size(want["sets"])
            if not (np.array_equal(loc, want["nb"][0][:2])
                    and np.array_equal(deg, want["deg"])
                    and np.array_equal(uni, want["uni"])):
                fail(f"sharded: reshard to {backend} {shards}: answers "
                     f"changed")
            log(f"sharded: reshard: load as {backend} shards={shards} "
                f"{secs:.2f} s; registers, degrees, neighborhood(2) through "
                f"the reinstalled replicas and unions unchanged; "
                f"{mem_peak(torch, base, counted.peaks)}")
            del back
    finally:
        shutil.rmtree(path, ignore_errors=True)


def sharded_ads(torch, np, edges, n, counted):
    """Phase 5h, ADS: ``ADSConfig(p=8)`` at SHARDS shards,
    ``distance_histogram``, ``closeness`` and ``effective_diameter`` at
    ADS_T hops equal to the local ADS engine's."""
    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.kernels import _build

    local = engine.build(edges, n, ADSConfig(p=P), family="ads",
                         device=DEVICE)
    want = (local.distance_histogram(ADS_T), local.closeness(ADS_T),
            local.effective_diameter(ADS_T, 0.9))
    del local
    torch.cuda.empty_cache()
    base = mem_start(torch)
    before = dict(counted.counts)
    t0 = time.perf_counter()
    eng = counted(lambda: engine.build(edges, n, ADSConfig(p=P),
                                       family="ads", device=DEVICE,
                                       backend="sharded", shards=SHARDS))
    got = (counted(lambda: eng.distance_histogram(ADS_T)),
           counted(lambda: eng.closeness(ADS_T)),
           counted(lambda: eng.effective_diameter(ADS_T, 0.9)))
    secs = time.perf_counter() - t0
    launch_check("sharded", "hip_delta_rows", counted.counts, before,
                 (ADS_T - 1) * SHARDS, f"ADS distance_histogram({ADS_T})")
    same = (all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
            and np.array_equal(got[1], want[1]) and got[2] == want[2])
    if not same:
        fail("sharded: ADS distance queries differ from the local engine's")
    log(f"sharded: ADS: build, distance_histogram({ADS_T}), closeness, "
        f"effective_diameter {got[2]:.4f} in {secs:.3f} s, equal to the "
        f"local ADS engine's; {mem_peak(torch, base, counted.peaks)}")


def sharded_triangles(torch, np, counted):
    """Phase 5h, triangles on the Kronecker phase's graph: per-edge
    estimates of the sharded engine equal to the local engine's, the
    edge and vertex totals within 1e-3 relative (float64 sums in another
    order), the top-``TRI_K`` equal as sets wherever the values are
    distinct."""
    from repro_torch import engine
    from repro_torch.core import degreesketch as dsk
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators

    f = generators.rmat(KRON_FACTOR_SCALE, 8, seed=0)
    nf = 1 << KRON_FACTOR_SCALE
    edges = generators.kronecker_edges(f, nf, f, nf)
    n = nf * nf
    local = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    est, secs_l = timed(torch, lambda: dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=local.regs, n=n, cfg=local.cfg), edges))
    del local
    want_v = dsk._vertex_counts(n, edges, est)
    torch.cuda.empty_cache()
    base = mem_start(torch)
    eng = counted(lambda: engine.build(edges, n, HLLConfig(p=P),
                                       device=DEVICE, backend="sharded",
                                       shards=SHARDS))
    t0 = time.perf_counter()
    e_tot, e_vals, e_top = counted(lambda: eng.triangle_heavy_hitters(
        TRI_K, mode="edge"))
    secs = time.perf_counter() - t0
    v_tot, v_vals, v_top = counted(lambda: eng.triangle_heavy_hitters(
        TRI_K, mode="vertex"))
    got = counted(eng.edge_triangle_estimates)
    if not np.array_equal(got, est):
        fail("sharded: per-edge triangle estimates differ from the local "
             "engine's")
    total = float(est.sum()) / 3.0
    for mode, tot in (("edge", e_tot), ("vertex", v_tot)):
        if abs(tot - total) > 1e-3 * abs(total):
            fail(f"sharded: {mode} total {tot} vs local {total}")
    order = np.argsort(-est)
    key = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    top_key = e_top[:, 0].astype(np.int64) * n + e_top[:, 1]
    v_order = np.argsort(-want_v)
    for what, vals, ids, ref_vals, ref_ids in (
            ("edge", e_vals, top_key, est[order], key[order]),
            ("vertex", v_vals, v_top, want_v[v_order], v_order)):
        cut = TRI_K  # (near-)ties at the cut: compare the ids above them
        while cut > 0 and abs(ref_vals[cut - 1] - ref_vals[cut]) <= \
                1e-9 * abs(ref_vals[cut]):
            cut -= 1
        if not (np.allclose(vals, ref_vals[:TRI_K], rtol=1e-12, atol=0)
                and set(ids[:cut].tolist()) == set(ref_ids[:cut].tolist())):
            fail(f"sharded: {what} top-{TRI_K} differs from the local "
                 f"engine's")
    log(f"sharded: triangles: rmat({KRON_FACTOR_SCALE}, 8)^2, m={len(edges)}:"
        f" triangle_heavy_hitters(k={TRI_K}, edge) {secs:.3f} s (local "
        f"per-edge estimates {secs_l:.3f} s), vertex mode from the kept "
        f"estimates; per-edge estimates equal, totals {e_tot:.1f} / "
        f"{v_tot:.1f} against {total:.1f}, top-{TRI_K} sets equal; "
        f"{mem_peak(torch, base, counted.peaks)}")


def launch_counter(torch):
    """``counted(fn)``: run ``fn``, synchronize, and add the launches it
    made to ``counted.counts`` (launches outside such calls not counted)."""
    from repro_torch.kernels import _build

    def counted(fn):
        before = _build.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in _build.launch_counts().items():
            counted.counts[k] += v - before[k]
        return out
    counted.counts = {k: 0 for k in _build.launch_counts()}
    return counted


def sharded_phase(torch, np, edges, n, pairs, sets):
    """Phase 5h: the sharded backend at SHARDS shards on the one card, the
    main path's graph, byte then packed; then reshard, ADS and triangles.
    Launch counts are taken over the sharded engine's calls only (the
    local engine's reference answers run between the counted windows).
    Returns the counts."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    counted = launch_counter(torch)
    counted.peaks = []  # each sub-phase's peaks (bytes), for the maximum

    for layout in ("byte", "packed"):
        eng, want, panel = sharded_layout(torch, np, edges, n, pairs, sets,
                                          layout, counted)
        if layout == "byte":
            want["sets"] = sets
            sharded_reshard(torch, np, eng, edges, n, want, panel, counted)
        del eng, want, panel
        torch.cuda.empty_cache()
    sharded_ads(torch, np, edges, n, counted)
    torch.cuda.empty_cache()
    sharded_triangles(torch, np, counted)
    counts = counted.counts
    need = ["hll_accumulate", "hll_accumulate_packed", "hll_estimate_stats",
            "hll_estimate_stats_packed", "hll_propagate_into",
            "hll_propagate_into_packed", "intersection_stats",
            "intersection_stats_packed", "union_estimate_stats",
            "union_estimate_stats_packed", "ertl_stats", "hip_delta_rows"]
    missing = [k for k in need if counts[k] == 0]
    if missing:
        fail(f"sharded: kernels never launched: {missing}")
    if counts["hll_propagate"] or counts["hll_propagate_packed"]:
        fail(f"sharded: a schedule ran the one-panel propagate: {counts}")
    log(f"sharded: phase {time.perf_counter() - t_phase:.1f} s, "
        f"max_memory_allocated over its sub-phases "
        f"{max(counted.peaks) / 2**30:.2f} GiB; launches "
        f"{({k: v for k, v in counts.items() if v})}")
    return counts


# ------------------------------------------------------------------ serving
def run_threads(fn, count, timeout=SERVE_WAIT):
    """Run ``fn(i)`` on ``count`` threads; fail on an error or a thread
    still running after ``timeout`` seconds."""
    import threading
    errors = []

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive():
            fail(f"a serving thread ran past {timeout} s")
    if errors:
        fail(f"a serving thread failed: {errors[0]!r}")


def serving_requests(np, rng, edges, sets, clients, per_client):
    """Seeded client requests: per client a list of (kind, argument),
    1/8 degrees, 3/8 unions of SERVE_SETS sets from ``sets``, 3/8
    intersections of SERVE_PAIRS edge pairs, 1/8 neighborhood(T_MAX)."""
    mix = ["degrees"] + ["union"] * 3 + ["intersection"] * 3 + [
        "neighborhood"]
    out = []
    for _ in range(clients):
        reqs = []
        for _ in range(per_client):
            kind = mix[int(rng.integers(len(mix)))]
            arg = None
            if kind == "union":
                arg = [sets[i] for i in rng.integers(0, len(sets),
                                                     SERVE_SETS)]
            elif kind == "intersection":
                arg = edges[rng.integers(0, len(edges), SERVE_PAIRS)]
            reqs.append((kind, arg))
        out.append(reqs)
    return out


def ask(srv, kind, arg):
    """One client call of ``kind`` through a server (or an engine)."""
    if kind == "degrees":
        return srv.degrees()
    if kind == "union":
        return srv.union_size(arg)
    if kind == "intersection":
        return srv.intersection_size(arg)
    return srv.neighborhood(T_MAX)


def direct_answers(np, eng, reqs):
    """The direct engine answers to ``reqs`` (a flat list of (kind, arg)),
    unions and intersections each as one batched call, sliced back."""
    sets = [s for kind, arg in reqs if kind == "union" for s in arg]
    pairs = [arg for kind, arg in reqs if kind == "intersection"]
    uni = eng.union_size(sets) if sets else None
    inter = eng.intersection_size(np.concatenate(pairs)) if pairs else None
    deg = eng.degrees()
    hood = eng.neighborhood(T_MAX) if any(
        kind == "neighborhood" for kind, _ in reqs) else None
    out, u, i = [], 0, 0
    for kind, arg in reqs:
        if kind == "degrees":
            out.append(deg)
        elif kind == "union":
            out.append(uni[u:u + len(arg)])
            u += len(arg)
        elif kind == "intersection":
            out.append(inter[i:i + len(arg)])
            i += len(arg)
        else:
            out.append(hood)
    return out


def same_answer(np, got, want):
    if isinstance(want, tuple):
        return all(np.array_equal(g, w) for g, w in zip(got, want))
    return np.array_equal(got, want)


def kind_stats(stats):
    """``kind: n, p50/p99 ms`` for every kind a server's stats hold."""
    return "; ".join(
        f"{kind} {s['requests']} requests in {s['batches']} batches, p50 "
        f"{s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms"
        for kind, s in stats.items()
        if isinstance(s, dict) and "p50_ms" in s and s["requests"])


def query_server_phase(torch, np, edges, n, sets):
    """Serving 1: a QueryServer over a byte engine at RMAT scale SCALE,
    SERVE_CLIENTS client threads x SERVE_REQS seeded requests, an ingest
    of SERVE_INGEST new edges as the epoch barrier half way; every answer
    equal, bit for bit, to the direct call at its epoch. Returns the
    serving run's launch counts, zeroed just before."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine import plans
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer

    rng = np.random.default_rng(SEED + 11)
    work = serving_requests(np, rng, edges, sets, SERVE_CLIENTS, SERVE_REQS)
    half = SERVE_REQS // 2
    new = rng.integers(0, n, (SERVE_INGEST, 2))
    t0 = time.perf_counter()
    direct = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    want = [direct_answers(np, direct,
                           [r for reqs in work for r in reqs[:half]])]
    direct.ingest(new)
    want.append(direct_answers(np, direct,
                               [r for reqs in work for r in reqs[half:]]))
    del direct
    t_direct = time.perf_counter() - t0
    torch.cuda.empty_cache()
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = [[None] * SERVE_REQS for _ in range(SERVE_CLIENTS)]
    plans.reset_trace_counts()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with QueryServer(eng) as srv:
        def clients(lo, hi):
            def client(c):
                for j in range(lo, hi):
                    got[c][j] = ask(srv, *work[c][j])
            run_threads(client, SERVE_CLIENTS)
        clients(0, half)
        epoch = srv.ingest(new)
        clients(half, SERVE_REQS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        stats = srv.stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flat = [[got[c][j] for c in range(SERVE_CLIENTS) for j in range(half)],
            [got[c][j] for c in range(SERVE_CLIENTS)
             for j in range(half, SERVE_REQS)]]
    bad = [(e, i) for e in (0, 1) for i, (g, w) in enumerate(
        zip(flat[e], want[e])) if not same_answer(np, g, w)]
    if epoch != 1 or bad:
        fail(f"serving: QueryServer answers differ from the direct calls "
             f"at their epoch: {len(bad)} of {SERVE_CLIENTS * SERVE_REQS} "
             f"(epoch {epoch})")
    log(f"serving: QueryServer, byte, rmat scale {SCALE}: {SERVE_CLIENTS} "
        f"clients x {SERVE_REQS} requests, an ingest of {SERVE_INGEST} "
        f"edges half way (epoch 0 -> 1): {secs:.2f} s "
        f"({stats['requests_total'] / secs:.1f} requests/s), every answer "
        f"equal to the direct call at its epoch bit for bit (direct calls "
        f"{t_direct:.2f} s); {kind_stats(stats)}; fused batches "
        f"{stats['fused_batches']}; plans built {stats['plan_traces']}; "
        f"max_memory_allocated {peak:.2f} GiB; launches {counts}")
    missing = [k for k in ("hll_accumulate", "hll_estimate_stats",
                           "hll_propagate", "intersection_stats",
                           "union_estimate_stats", "intersection_newton")
               if counts[k] == 0]
    if missing:
        fail(f"serving: QueryServer never launched {missing}")
    return counts


def submit_continuous(srv, n, kind, arg):
    """Submit one degrees / union / intersection request to a
    ContinuousServer as its client methods do, and return the request:
    after ``wait()`` its ``epoch`` is the snapshot version that served
    it."""
    from repro_torch.engine import plans
    if kind == "degrees":
        payload = ()
    elif kind == "union":
        payload = plans.split_sets(arg, n)
    else:
        arr, scalar = plans.split_pairs(arg, n)
        payload = (arr, scalar, "mle", srv.engine._resolve_iters(None))
    return srv._submit(kind, payload, None)


def continuous_phase(torch, np, edges, n, sets, pairs):
    """Serving 2: a ContinuousServer over a byte engine at RMAT scale
    SCALE; the writer ingests CONT_BLOCKS blocks of CONT_BLOCK new edges
    (RotationPolicy(every_blocks=4), the source flushing every 4 blocks,
    so 4 rotations) while CONT_READERS reader threads
    serve degrees / unions / intersections. Every served answer equals
    the direct call at the snapshot version that served it; a snapshot
    taken before keeps its answers throughout; after flush the served
    registers equal a one-shot build; one lease clone a rotation. Returns
    the serving run's launch counts, zeroed just before, less the
    launches of the snapshot check made while the writer works."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine import plans
    from repro_torch.kernels import _build
    from repro_torch.serve import ContinuousServer, RotationPolicy
    import threading

    rng = np.random.default_rng(SEED + 12)
    new = rng.integers(0, n, (CONT_BLOCKS * CONT_BLOCK, 2))
    blocks = np.split(new, CONT_BLOCKS)
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    v0 = eng.version
    first = eng.snapshot()
    probe = (sets[:64], pairs[:1024])

    def answers(e):
        return (e.degrees(), e.union_size(probe[0]),
                e.intersection_size(probe[1]))

    _build.reset_launch_counts()
    want_first = answers(first)
    torch.cuda.synchronize()
    probe_counts = _build.launch_counts()  # subtracted for ``mid`` below
    torch.cuda.reset_peak_memory_stats()
    plans.reset_event_counts()
    _build.reset_launch_counts()
    stop = threading.Event()
    seen = [[] for _ in range(CONT_READERS)]  # (kind, arg, epoch, answer)
    t0 = time.perf_counter()
    with ContinuousServer(eng, rotation=RotationPolicy(every_blocks=4)) \
            as srv:
        def reader(i):
            r = np.random.default_rng(SEED + 100 + i)
            while not stop.is_set():
                kind = ("degrees", "union", "intersection")[i % 3]
                arg = None
                if kind == "union":
                    arg = [sets[k] for k in r.integers(0, len(sets),
                                                       SERVE_SETS)]
                elif kind == "intersection":
                    arg = edges[r.integers(0, len(edges), SERVE_PAIRS)]
                req = submit_continuous(srv, n, kind, arg)
                if not req.done.wait(timeout=SERVE_WAIT):
                    raise TimeoutError(f"{kind} not served in {SERVE_WAIT} s")
                seen[i].append((kind, arg, req.epoch, req.wait()))

        readers = threading.Thread(
            target=run_threads, args=(reader, CONT_READERS), daemon=True)
        readers.start()
        for g in range(0, CONT_BLOCKS, 4):  # a source that flushes every 4
            for blk in blocks[g:g + 4]:
                srv.ingest(blk)
            if g == 4:
                mid = answers(first)  # while the writer works
            srv.flush(timeout=SERVE_WAIT)
        secs = time.perf_counter() - t0
        stop.set()
        readers.join(timeout=SERVE_WAIT)
        if readers.is_alive():
            fail("serving: ContinuousServer readers did not stop")
        torch.cuda.synchronize()
        counts = {k: c - probe_counts.get(k, 0)
                  for k, c in _build.launch_counts().items()}
        stats = srv.stats()
        served_regs = srv._slot.get().regs
        writer = srv.engine
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    clones = plans.event_counts().get("lease_clone", 0)
    rotations = stats["snapshot"]["rotations"]
    clone_ms = cuda_ms(torch, lambda: writer.regs.clone(), 10)
    after = answers(first)
    # every reader answer against the direct call at its version: one
    # engine steps through the versions, ingesting the blocks as the
    # writer did, and answers each version's requests in one batch
    by_epoch = {}
    for got in seen:
        for kind, arg, epoch, answer in got:
            by_epoch.setdefault(epoch, []).append((kind, arg, answer))
    step = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    wrong, applied = [], 0
    for epoch in sorted(by_epoch):
        if not v0 <= epoch <= v0 + CONT_BLOCKS:
            fail(f"serving: ContinuousServer served version {epoch}, "
                 f"outside [{v0}, {v0 + CONT_BLOCKS}]")
        for blk in blocks[applied:epoch - v0]:
            step.ingest(blk)
        applied = max(applied, epoch - v0)
        reqs = by_epoch[epoch]
        want = direct_answers(np, step, [(k, a) for k, a, _ in reqs])
        wrong += [(epoch, k) for (k, _, g), w in zip(reqs, want)
                  if not same_answer(np, g, w)]
    del step
    n_seen = sum(len(got) for got in seen)
    once = engine.build(np.concatenate([edges, new]), n, HLLConfig(p=P),
                        device=DEVICE)
    checks = {
        "every reader answer equal to the direct call at its version": (
            n_seen > 0 and not wrong),
        "snapshot answers during the stream": all(
            np.array_equal(a, b) for a, b in zip(mid, want_first)),
        "snapshot answers after the stream": all(
            np.array_equal(a, b) for a, b in zip(after, want_first)),
        "served registers equal a one-shot build": torch.equal(
            served_regs, once.regs),
        "one lease clone a rotation": clones == rotations >= 1,
        "the first snapshot's panel no longer shared": (
            first.regs.untyped_storage().data_ptr()
            != writer.regs.untyped_storage().data_ptr()),
    }
    del once
    log(f"serving: ContinuousServer, byte, rmat scale {SCALE}: "
        f"{CONT_BLOCKS} blocks of {CONT_BLOCK} edges in {secs:.2f} s while "
        f"{CONT_READERS} readers served {n_seen} requests at versions "
        f"{sorted(by_epoch)} ({len(wrong)} differ from the direct call); "
        f"rotations "
        f"{rotations}, lease clones {clones}, shed {stats['shed_total']}, "
        f"deadline misses {stats['deadline_misses']}; {kind_stats(stats)}; "
        f"lease clone of the {writer.regs.numel() / 2**30:.2f} GiB panel "
        f"{clone_ms:.4f} ms (CUDA events; bound "
        f"{bound_ms(2 * writer.regs.numel()):.4f} ms, bytes); "
        f"max_memory_allocated {peak:.2f} GiB; launches {counts}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"serving: ContinuousServer: {bad}")
    log(f"serving: ContinuousServer: {', '.join(checks)}: all hold")
    missing = [k for k in ("hll_accumulate", "hll_estimate_stats",
                           "intersection_stats", "union_estimate_stats")
               if counts[k] == 0]
    if missing:
        fail(f"serving: ContinuousServer never launched {missing}")
    return counts


def packed_serving_phase(torch, np, eng, edges, sets):
    """Serving 3: a short QueryServer run (SERVE_CLIENTS x 8 requests) on
    the packed scale-SCALE engine, every answer equal to the direct call.
    Returns the serving run's launch counts, zeroed just before."""
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer

    work = serving_requests(np, np.random.default_rng(SEED + 13), edges,
                            sets, SERVE_CLIENTS, 8)
    want = direct_answers(np, eng, [r for reqs in work for r in reqs])
    got = [[None] * 8 for _ in range(SERVE_CLIENTS)]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with QueryServer(eng) as srv:
        def client(c):
            for j in range(8):
                got[c][j] = ask(srv, *work[c][j])
        run_threads(client, SERVE_CLIENTS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        stats = srv.stats()
    flat = [g for row in got for g in row]
    bad = sum(not same_answer(np, g, w) for g, w in zip(flat, want))
    if bad:
        fail(f"serving: packed QueryServer: {bad} answers differ from the "
             f"direct calls")
    log(f"serving: QueryServer, packed: {SERVE_CLIENTS} clients x 8 "
        f"requests in {secs:.2f} s, every answer equal to the direct call "
        f"bit for bit; {kind_stats(stats)}; launches {counts}")
    missing = [k + "_packed" for k in ("hll_estimate_stats",
                                       "intersection_stats",
                                       "union_estimate_stats")
               if counts[k + "_packed"] == 0]
    if missing:
        fail(f"serving: packed QueryServer never launched {missing}")
    return counts


def ads_serving_phase(torch, np, ads_eng):
    """Serving 4: one served distance_histogram(ADS_T) on the scale-SCALE
    ADS engine (cold caches), equal to the direct call on a snapshot; its
    repeat served from a snapshot runs no kernel and no propagate pass.
    Returns the served call's launch counts, zeroed just before."""
    from repro_torch.engine import plans
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer

    view = ads_eng.snapshot()  # computes its own panels: the direct call
    want, want_glob = view.distance_histogram(ADS_T)
    del view
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    with QueryServer(ads_eng) as srv:
        (hist, glob), secs = timed(torch,
                                   lambda: srv.distance_histogram(ADS_T))
        counts = _build.launch_counts()
    snap = ads_eng.snapshot()
    plans.reset_event_counts()
    _build.reset_launch_counts()
    with QueryServer(snap) as srv:
        (again, again_glob), secs2 = timed(
            torch, lambda: srv.distance_histogram(ADS_T))
        repeat = (_build.launch_counts(), plans.event_counts())
    if not (np.array_equal(hist, want) and np.array_equal(glob, want_glob)
            and np.array_equal(again, want)
            and np.array_equal(again_glob, want_glob)):
        fail("serving: served distance_histogram differs from the direct "
             "call")
    if any(repeat[0].values()) or repeat[1].get("propagate_pass", 0):
        fail(f"serving: the repeat on a snapshot ran work: {repeat}")
    log(f"serving: ADS: served distance_histogram({ADS_T}) {secs:.3f} s "
        f"(cold), equal to the direct call bit for bit, launches {counts}; "
        f"repeated on a snapshot {secs2:.4f} s: 0 kernel launches, 0 "
        f"propagate passes")
    missing = [k for k in ("hip_delta_rows", "hll_propagate",
                           "hll_estimate_stats") if counts[k] == 0]
    if missing:
        fail(f"serving: served distance_histogram never launched {missing}")
    return counts


def failover_phase(torch, np):
    """Serving 5: the ContinuousServer's failover writer at RMAT scale
    FT_SCALE (its cost is host checkpoint I/O, not kernels): checkpoints
    every 4 blocks under build/, the writer killed at block 6, registers
    after flush equal the same run without faults; directory removed.
    Returns the launch counts of both runs, zeroed just before."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.kernels import _build
    from repro_torch.runtime.faults import FaultInjector, KillHost
    from repro_torch.runtime.ft import FTConfig
    from repro_torch.serve import ContinuousServer

    edges = generators.rmat(FT_SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << FT_SCALE
    blocks = np.array_split(edges, FT_BLOCKS)
    path = ROOT / "build" / "chip_smoke_ft"
    shutil.rmtree(path, ignore_errors=True)

    def run(ft, faults):
        with ContinuousServer(engine.open(n, HLLConfig(p=P), device=DEVICE),
                              ft=ft, faults=faults) as srv:
            for blk in blocks:
                srv.ingest(blk)
            srv.flush(timeout=SERVE_WAIT)
            out = (srv.engine.regs.clone(), srv.engine.m,
                   srv.stats()["runtime"])
        return out

    _build.reset_launch_counts()
    try:
        inj = FaultInjector(faults=(KillHost(host=0, at_block=6),))
        (regs, m, rt), secs = timed(torch, lambda: run(
            FTConfig(ckpt_dir=str(path), ckpt_every=4), inj))
        (want, want_m, _), secs0 = timed(torch, lambda: run(None, None))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    counts = _build.launch_counts()
    if not (torch.equal(regs, want) and m == want_m == len(edges)
            and rt["recoveries"] == 1 and len(inj.fired) == 1):
        fail(f"serving: failover writer: registers or edge count differ "
             f"from the run without faults ({rt})")
    log(f"serving: failover writer, rmat scale {FT_SCALE} (cut from "
        f"{SCALE}: the phase's cost is host checkpoint I/O, not kernels): "
        f"{FT_BLOCKS} blocks, checkpoints every 4, writer killed at block "
        f"6: recoveries {rt['recoveries']}, last recovery "
        f"{rt['last_recovery_ms']:.1f} ms, checkpoints written "
        f"{rt['checkpoints_written']}; registers and m={m} equal the run "
        f"without faults bit for bit ({secs:.2f} s against {secs0:.2f} s); "
        f"directory removed; launches {counts}")
    if counts["hll_accumulate"] == 0:
        fail("serving: the failover writer never launched hll_accumulate")
    return counts


# -------------------------------------------------------- failover runtime
def _checkpoint_clock(c):
    """Time each checkpoint of Coordinator ``c``: the calling thread's
    share (the host copy of the panel and the edges, the thread's start)
    and the time until its write completes. Returns the list the times
    land in, one dict a checkpoint with its ``step``, ``own`` (calling
    thread, s) and ``done`` (to written, s); a write that never completed
    has no ``done``. Writes complete in the order they began (each save
    waits for the previous write), so the writer thread takes the oldest
    pending entry."""
    times, pending = [], collections.deque()
    take, gc = c._checkpoint, c.ckpt._gc

    def checkpoint(eng, step):
        rec = {"step": step, "t0": time.perf_counter()}
        times.append(rec)
        pending.append(rec)  # before take(): its write may end first
        take(eng, step)
        rec["own"] = time.perf_counter() - rec["t0"]

    def written():
        gc()
        rec = pending.popleft()
        rec["done"] = time.perf_counter() - rec["t0"]

    c._checkpoint, c.ckpt._gc = checkpoint, written
    return times


def coordinator_phase(torch, np, edges, n, sets):
    """Phase 5r: the failover coordinator at full width, counters zeroed
    just before and taken over the coordinator's run and the recovered
    engine's queries only (the local reference runs between them): 4
    hosts, sharded, host 2 killed at block 10 of 16, checkpoints every 8
    blocks under build/; the recovered 3-shard engine against the local
    engine bit for bit. Then the module's own smoke, a scale-16 run with
    a silent and a slow host, and a train_loop restart on the card.
    Returns the counts."""
    import importlib

    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.runtime.faults import (DropHeartbeat, FaultInjector,
                                            KillHost, SlowHost)
    from repro_torch.runtime.ft import FTConfig
    coord = importlib.import_module("repro_torch.runtime.coordinator")

    t_phase = time.perf_counter()
    path = ROOT / "build" / "chip_smoke_coord"
    shutil.rmtree(path, ignore_errors=True)
    counted = launch_counter(torch)
    counts = counted.counts

    deg = np.bincount(edges.ravel(), minlength=n)
    hot = np.sort(np.argsort(-deg, kind="stable")[:COORD_REPLICAS])
    base = mem_start(torch)
    c = coord.Coordinator(
        edges, n, HLLConfig(p=P), ft=FTConfig(ckpt_dir=str(path)),
        config=coord.CoordinatorConfig(hosts=COORD_HOSTS, block=COORD_BLOCK,
                                       ckpt_every=COORD_CKPT_EVERY),
        faults=FaultInjector(faults=(KillHost(host=2,
                                              at_block=COORD_KILL),)),
        backend="sharded", replicate=hot, device=DEVICE)
    ckpt_times = _checkpoint_clock(c)
    try:
        t0 = time.perf_counter()
        eng = counted(c.run)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    stats = c.stats
    blocks = -(-len(edges) // COORD_BLOCK)
    log(f"coordinator: run: {secs:.3f} s, {blocks} blocks of "
        f"{COORD_BLOCK} edges, {COORD_HOSTS} hosts, sharded, host 2 killed "
        f"at block {COORD_KILL}, checkpoints every {COORD_CKPT_EVERY} "
        f"blocks, {COORD_REPLICAS} replicas; "
        f"{mem_peak(torch, base, [])}")
    for rec in ckpt_times:
        log(f"coordinator: checkpoint step {rec['step']}: "
            f"{rec['own']:.3f} s on the calling thread, written "
            f"{rec.get('done', float('nan')):.3f} s after it began")
    if (len(ckpt_times) != stats["checkpoints_written"]
            or not all("done" in rec for rec in ckpt_times)):
        fail(f"coordinator: {stats['checkpoints_written']} checkpoints, "
             f"{sum('done' in rec for rec in ckpt_times)} of "
             f"{len(ckpt_times)} timed to their write")
    log(f"coordinator: last_recovery_ms {stats['last_recovery_ms']:.1f}")
    log(f"coordinator: stats {json.dumps(stats)}")
    want = {"recoveries": 1, "evictions": 1, "hosts_alive": 3,
            "blocks_replayed": 2, "hosts_evicted": [2]}
    got = {k: stats[k] for k in want}
    if got != want or eng.shards != 3 or eng.m != len(edges):
        fail(f"coordinator: stats {got} (shards {eng.shards}, m {eng.m}), "
             f"want {want}, 3 shards, m {len(edges)}")
    if counts["hll_accumulate"] < blocks:
        fail(f"coordinator: {counts['hll_accumulate']} accumulate launches "
             f"for {blocks} blocks")

    ref = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    regs = eng.regs
    if not torch.equal(regs[:n], ref.regs[:n]):
        fail("coordinator: the recovered registers differ from the local "
             "engine's")
    del regs
    checks = ["registers"]
    if not np.array_equal(counted(eng.degrees), ref.degrees()):
        fail("coordinator: degrees differ from the local engine's")
    checks.append("degrees")
    want_hops = ref.neighborhood(T_MAX)
    for schedule in ("ring", "ring_overlap", "allgather"):
        got_hops, t = timed(torch, lambda: counted(
            lambda: eng.neighborhood(T_MAX, schedule=schedule)))
        if not all(np.array_equal(a, b) for a, b in zip(got_hops,
                                                        want_hops)):
            fail(f"coordinator: neighborhood({T_MAX}) under {schedule} "
                 f"differs from the local engine's")
        checks.append(f"neighborhood({T_MAX}) {schedule} ({t:.3f} s)")
    if not np.array_equal(counted(lambda: eng.union_size(sets)),
                          ref.union_size(sets)):
        fail("coordinator: union_size differs from the local engine's")
    checks.append(f"union_size of {len(sets)} sets")
    if not np.array_equal(eng.replicated_ids, hot):
        fail("coordinator: the replica ids did not survive recovery")
    checks.append("replica ids")
    log(f"coordinator: recovered 3-shard engine equals the local engine "
        f"bit for bit: {', '.join(checks)}; "
        f"{mem_peak(torch, base, [])}")
    log(f"coordinator: launches {({k: v for k, v in counts.items() if v})}")
    for k in ("hll_accumulate", "hll_estimate_stats", "hll_propagate_into",
              "union_estimate_stats"):
        if counts[k] == 0:
            fail(f"coordinator: {k} never launched on the recovered path")
    del eng, ref, want_hops
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    if counted(lambda: coord._smoke(DEVICE)) != 0:
        fail("coordinator: the module's --smoke failed")
    log(f"coordinator: --smoke in process: {time.perf_counter() - t0:.2f} s")

    small = generators.rmat(FT_SCALE, EDGE_FACTOR, seed=SEED)
    small_n = 1 << FT_SCALE
    inj = FaultInjector(faults=(
        DropHeartbeat(host=1, at_block=5, count=1000),
        SlowHost(host=3, at_block=11, delay_s=COORD_SLOW_S, count=4)))
    try:
        (eng, stats), t = timed(torch, lambda: counted(
            lambda: coord.coordinator(
                small, small_n, HLLConfig(p=P),
                ft=FTConfig(ckpt_dir=str(path)),
                config=coord.CoordinatorConfig(hosts=4, block=small_n,
                                               ckpt_every=4),
                faults=inj, device=DEVICE)))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    ref = engine.build(small, small_n, HLLConfig(p=P), device=DEVICE)
    if not (stats["hosts_evicted"] == [1] and stats["evictions"] == 1
            and stats["straggler_steps"] >= 1
            and torch.equal(eng.regs, ref.regs)):
        fail(f"coordinator: silent and slow hosts: {stats}")
    log(f"coordinator: rmat scale {FT_SCALE}, host 1 silent from block 5, "
        f"host 3 slowed {COORD_SLOW_S} s from block 11: {t:.2f} s, "
        f"evicted {stats['hosts_evicted']}, straggler steps "
        f"{stats['straggler_steps']}, the slow host kept; registers equal "
        f"a one-shot build")

    train_restart(torch, path)
    log(f"coordinator: phase {time.perf_counter() - t_phase:.1f} s, "
        f"launches with the smoke and the scale-{FT_SCALE} run "
        f"{({k: v for k, v in counts.items() if v})}")
    return counts


def train_restart(torch, path):
    """train_loop on CUDA tensors for 7 steps, then a restart that must
    restore step 6 onto the card; the directory is removed."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.runtime.ft import FTConfig, train_loop

    def step_fn(params, opt, batch, step):
        params = {"w": params["w"] + batch["tokens"].float().mean()}
        return params, opt + 1, {"loss": params["w"].sum()}

    def run(steps):
        return train_loop(
            step_fn=step_fn, params={"w": torch.zeros(8, device=DEVICE)},
            opt_state=torch.zeros((), dtype=torch.int64, device=DEVICE),
            corpus=SyntheticCorpus(vocab_size=1000, seq_len=64,
                                   global_batch=4, seed=SEED),
            num_steps=steps, ft=FTConfig(ckpt_dir=str(path), ckpt_every=3),
            to_device=lambda b: {k: torch.from_numpy(v).to(DEVICE)
                                 for k, v in b.items()}, log_every=0)

    try:
        full, _, _ = run(9)
        shutil.rmtree(path)
        _, _, first = run(7)
        params, opt, hist = run(9)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if not (hist["restored_from"] == 6 and params["w"].is_cuda
            and int(opt) == 9 and len(first["loss"]) == 7
            and torch.equal(params["w"], full["w"])):
        fail(f"coordinator: train_loop restart: restored from "
             f"{hist['restored_from']}, opt {int(opt)}")
    log("coordinator: train_loop: 7 steps on the card, then a restart "
        "restored step 6 onto the card and ran steps 7-8; params equal an "
        "uninterrupted 9-step run")


# ---------------------------------------------------------------- telemetry
def telemetry_phase(torch, np):
    """Phase 9t: sketch telemetry at a real routing shape, counters zeroed
    just before: Moonlight-16B-A3B's router (64 experts, top 6) over a
    SyntheticCorpus batch of 256 x 4,096 tokens from a 163,840-token
    vocabulary; the routing a seeded function of the token id, experts
    0 and 1 given identical token sets. RoutingSketch(64, p=10) and
    NGramSketch(n=2, p=12) over the corpus in 4 shards, against exact
    counts on the card. Returns the counts."""
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.data.telemetry import NGramSketch, RoutingSketch
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    base = mem_start(torch)
    corpus = dict(vocab_size=TEL_VOCAB, seq_len=TEL_SEQ,
                  global_batch=TEL_BATCH, seed=SEED)
    t0 = time.perf_counter()
    tokens = SyntheticCorpus(**corpus).batch(0)["tokens"]
    shards = [SyntheticCorpus(**corpus, num_shards=TEL_SHARDS,
                              shard=s).batch(0)["tokens"]
              for s in range(TEL_SHARDS)]
    log(f"telemetry: corpus: {tokens.size} tokens and {TEL_SHARDS} shards "
        f"of {shards[0].size}, {time.perf_counter() - t0:.2f} s on the host")
    _build.reset_launch_counts()

    # the router: a seeded function of the token id; one token in 8 (the
    # planted set) goes to experts 0 and 1 together, and neither expert
    # sees any other token
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pick = torch.rand(TEL_VOCAB, TEL_EXPERTS - 2, generator=gen,
                      device=DEVICE).argsort(dim=1)[:, :TEL_TOPK] + 2
    planted = torch.rand(TEL_VOCAB, generator=gen, device=DEVICE) < 0.125
    pair = torch.tensor([0, 1], device=DEVICE).expand(TEL_VOCAB, 2)
    route = torch.where(planted[:, None],
                        torch.cat([pair, pick[:, :TEL_TOPK - 2]], dim=1),
                        pick)
    tok = torch.from_numpy(tokens.ravel()).to(DEVICE)
    experts = route[tok]
    rs = RoutingSketch(TEL_EXPERTS, HLLConfig(p=TEL_P_ROUTING))
    table, t_up = timed(torch, lambda: rs.update(rs.init(DEVICE), experts, tok))
    cov, t_cov = timed(torch, lambda: rs.coverage(table))
    before = _build.launch_counts()["ertl_stats"]
    jac, t_jac = timed(torch, lambda: rs.collapse_score(table))
    ertl = _build.launch_counts()["ertl_stats"] - before
    keys = torch.unique(experts.reshape(-1) * TEL_VOCAB
                        + tok.repeat_interleave(TEL_TOPK))
    exact = torch.bincount(keys // TEL_VOCAB, minlength=TEL_EXPERTS)
    rel = ((cov.double() - exact.double()).abs() / exact.double()).cpu()
    log(f"telemetry: routing: {experts.numel()} assignments of "
        f"{tok.numel()} tokens to {TEL_EXPERTS} experts (top {TEL_TOPK}), "
        f"update {t_up * 1e3:.2f} ms, coverage {t_cov * 1e3:.2f} ms, "
        f"collapse_score {t_jac * 1e3:.2f} ms ({TEL_EXPERTS * (TEL_EXPERTS - 1) // 2} "
        f"pairs, ertl_stats launched {ertl} time(s)); exact distinct "
        f"{int(exact.min())}-{int(exact.max())} an expert; coverage "
        f"relative error mean {float(rel.mean()):.4f}, max "
        f"{float(rel.max()):.4f} (rel_std {rel_std(TEL_P_ROUTING):.4f})")
    if ertl != 1:
        fail(f"telemetry: collapse_score launched ertl_stats {ertl} times")
    if float(rel.max()) >= 3 * rel_std(TEL_P_ROUTING):
        fail("telemetry: an expert's coverage is outside 3 x rel_std of "
             "its exact distinct count")
    others = jac.copy()
    others[0, 1] = others[1, 0] = 0.0
    log(f"telemetry: collapse_score: (0, 1) {jac[0, 1]:.4f}, every other "
        f"pair at most {others.max():.4f}")
    if not (jac.shape == (TEL_EXPERTS, TEL_EXPERTS) and np.isfinite(jac).all()
            and jac[0, 1] > 0.6 and others.max() < 0.2):
        fail("telemetry: collapse_score does not single out the planted "
             "pair (0, 1)")

    ns = NGramSketch(n=2, cfg=HLLConfig(p=TEL_P_NGRAM))
    parts = [torch.from_numpy(s).to(DEVICE) for s in shards]
    sketches, t_ng = timed(torch, lambda: [ns.update(ns.init(DEVICE), s)
                                           for s in parts])
    merged = sketches[0]
    for sk in sketches[1:]:
        merged = ns.merge(merged, sk)
    whole = torch.cat(parts)
    one, t_one = timed(torch, lambda: ns.update(ns.init(DEVICE), whole))
    if not torch.equal(merged, one):
        fail("telemetry: the merged shard sketches differ from one sketch "
             "over every token")
    est, t_est = timed(torch, lambda: ns.distinct(merged))
    bigrams = torch.unique(whole[:, :-1].long() * TEL_VOCAB
                           + whole[:, 1:].long()).numel()
    err = abs(est - bigrams) / bigrams
    log(f"telemetry: n-grams: {TEL_SHARDS} shard sketches {t_ng * 1e3:.2f} "
        f"ms, one sketch over all {whole.numel()} tokens {t_one * 1e3:.2f} "
        f"ms, equal to their merge byte for byte; distinct "
        f"{est:.1f} against {bigrams} exact bigrams ({err:.4f}, "
        f"{t_est * 1e3:.2f} ms)")
    if err >= 3 * rel_std(TEL_P_NGRAM):
        fail(f"telemetry: distinct bigrams off by {err:.4f}")
    counts = dict(_build.launch_counts())
    log(f"telemetry: phase {time.perf_counter() - t_phase:.1f} s, "
        f"{mem_peak(torch, base, [])}, launches "
        f"{({k: v for k, v in counts.items() if v})}")
    for k in ("hll_accumulate", "hll_estimate_stats", "ertl_stats"):
        if counts[k] == 0:
            fail(f"telemetry: {k} never launched")
    telemetry_vs_plain(torch, np, rs, table, cov, experts, tok, ns,
                       sketches[0], shards[0], merged, est)
    return counts


def telemetry_vs_plain(torch, np, rs, table, cov, experts, tok, ns,
                       shard_sketch, shard, merged, est):
    """Phase 9t's kernels against their plain versions on the phase's own
    inputs, after its counts are taken (these launches are not the
    path's): the routing table (6,291,456 keys into 64 rows) as
    ``routing_vs_plain`` holds it; the (s, z) behind ``distinct`` (one
    row at p=12) as ``estimate_vs_plain`` holds it; one n-gram shard's
    sketch byte for byte against the same update on the CPU, where the
    hash and the accumulate run their plain versions."""
    routing = routing_vs_plain(torch, np, "telemetry", rs.cfg, table, cov,
                               experts.reshape(-1),
                               tok.repeat_interleave(TEL_TOPK))
    distinct = estimate_vs_plain(torch, "telemetry", "distinct",
                                 merged.reshape(1, -1), ns.cfg,
                                 torch.tensor([est], device=merged.device))
    cpu = ns.update(ns.init("cpu"), shard)
    if not torch.equal(shard_sketch.cpu(), cpu):
        fail("telemetry: an n-gram shard sketch differs from the same "
             "update on the CPU")
    log(f"telemetry: kernels vs plain on the phase's inputs: {routing}; "
        f"(s, z) {distinct}, the n-gram shard sketch of {shard.size} tokens "
        f"equal to the CPU's")


def estimate_vs_plain(torch, tag, what, regs, cfg, got):
    """The (s, z) of ``regs`` from ``hll_estimate_stats`` against its
    plain version, ``z`` exact and ``s`` within ``rtol=1e-6`` (phase 4's
    estimate tolerance), and the estimates ``got`` within the same rtol of
    the estimate from the plain (s, z). Returns the text for a log line."""
    from repro_torch.core.hll import estimate_from_stats
    from repro_torch.kernels import hll_estimate

    sz_k = hll_estimate.hll_estimate_stats(regs)
    sz_p = hll_estimate.plain(regs)
    from_plain = estimate_from_stats(sz_p[:, 0], sz_p[:, 1], cfg)
    if not (torch.equal(sz_k[:, 1], sz_p[:, 1])
            and torch.allclose(sz_k[:, 0], sz_p[:, 0], rtol=1e-6, atol=0)
            and torch.allclose(got.to(from_plain.dtype), from_plain,
                               rtol=1e-6, atol=0)):
        fail(f"{tag}: the (s, z) behind {what} differ from the plain "
             f"estimate's")
    return (f"{what} {regs.shape[0]} x {regs.shape[1]} max abs err "
            f"{float((sz_k - sz_p).abs().max())}")


def routing_vs_plain(torch, np, tag, cfg, table, cov, rows, keys):
    """A ``RoutingSketch``'s kernels against their plain versions on the
    path's own inputs, after its counts are taken (these launches are not
    the path's): ``table`` byte for byte against the plain accumulate of
    ``keys`` into ``rows`` on the card; ``ertl_stats`` over every pair of
    rows bit for bit (the pairs ``collapse_score`` sends); the (s, z)
    behind ``coverage`` as ``estimate_vs_plain`` holds them. Returns the
    text for a log line."""
    from repro_torch.kernels import ertl_stats, hll_accumulate

    rows = rows.reshape(-1).to(torch.int32)
    keys = keys.reshape(-1).to(torch.int32).view(torch.uint32)
    want, t_acc = timed(torch, lambda: hll_accumulate.plain(
        torch.zeros_like(table), rows, keys, p=cfg.p, seed=cfg.seed))
    if not torch.equal(table, want):
        fail(f"{tag}: the routing table differs from the plain accumulate "
             f"in {int((table != want).sum())} registers")
    del rows, keys, want

    i, j = np.triu_indices(table.shape[0], k=1)
    idx = torch.from_numpy(np.stack([i, j])).to(table.device)
    a, b = table[idx[0]].contiguous(), table[idx[1]].contiguous()
    st_k = ertl_stats.ertl_stats(a, b, cfg.q)
    st_p, t_ertl = timed(torch, lambda: ertl_stats.plain(a, b, cfg.q))
    if not torch.equal(st_k, st_p):
        fail(f"{tag}: ertl_stats differs from its plain version on the "
             f"{len(i)} expert pairs (max abs err "
             f"{float((st_k - st_p).abs().max())})")
    cov_text = estimate_vs_plain(torch, tag, "coverage", table, cfg, cov)
    return (f"routing table {table.shape[0]} x {table.shape[1]} equal byte "
            f"for byte (plain accumulate {t_acc * 1e3:.2f} ms), ertl_stats "
            f"on {len(i)} pairs equal bit for bit (plain "
            f"{t_ertl * 1e3:.2f} ms), (s, z) {cov_text}")


# ------------------------------------------------------------ LM serving
def lm_reduced_archs(torch, np):
    """Phase 9m, part 1: every arch at ``reduced()`` in float32,
    ``models.parity.logits_on_both`` (the check the card tests run): the
    same weights (drawn on the CPU from seed 0, carried to the card by
    ``models.convert``) and seeded inputs on both devices, the prefill's
    logits, then 3 greedy decode steps fed the CPU's tokens (an int8
    cache carried from the CPU before each step); the card's logits
    within ``LM_REDUCED_TOL`` of the CPU's. Returns the largest error."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.parity import logits_on_both

    worst, lines = 0.0, []
    for name in sorted(ARCHS):
        steps = logits_on_both(ARCHS[name].reduced(), DEVICE,
                               batch=LM_RED_BATCH, length=LM_RED_LEN,
                               decodes=LM_RED_DECODES, seed=SEED,
                               data_seed=SEED)
        if not all(torch.isfinite(got).all() for _, got in steps):
            fail(f"models: {name}: non-finite logits on the card")
        errs = [float((want - got).abs().max()) for want, got in steps]
        worst = max(worst, max(errs))
        lines.append(f"{name} {max(errs):.2e}")
        if max(errs) > LM_REDUCED_TOL:
            fail(f"models: {name} reduced: card logits differ from the "
                 f"CPU's by {max(errs):.3e} (prefill, 3 decodes: {errs})")
    log(f"models: reduced configs, card vs CPU in float32 (TF32 off), "
        f"prefill + {LM_RED_DECODES} decode logits max abs err: "
        f"{', '.join(lines)} (tolerance {LM_REDUCED_TOL})")
    return worst


def _margin_ok(logits, got_tok, tol):
    """The greedy token equal to ``logits``' argmax in every row whose
    top-2 margin exceeds ``tol``; returns (rows checked, rows equal)."""
    top2 = logits.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1] > tol).cpu().numpy()
    same = (logits.argmax(-1).cpu() == got_tok.cpu()).numpy()
    return int(sure.sum()), bool(same[sure].all())


def _teacher_forced(torch, tfm, model, cfg, tokens, cache, want, fault):
    """4 decode steps of the prompt's tokens after ``LM_CHECK_FROM`` from
    ``cache`` (a prefill of the first ``LM_CHECK_FROM``, written in place)
    against ``want`` (the forward's logits there): (max abs err by step,
    root mean square error, greedy tokens equal to the forward's, the
    logits). ``fault`` plants a fault the check must see: "pos" tells each
    step its position + 1 (RoPE and the cache slot off by one); "drop"
    zeroes the previous position's K/V in every layer before each step."""
    got = []
    for i in range(4):
        pos = LM_CHECK_FROM + i
        if fault == "drop":
            for c in cache["blocks"]:
                c["k"][:, pos - 1] = 0
                c["v"][:, pos - 1] = 0
        got.append(tfm.decode_step(model, cfg, tokens[:, pos:pos + 1], cache,
                                   pos + (fault == "pos"))[0])
    got = torch.stack(got, dim=1)
    diff = got - want
    errs = [float(diff[:, i].abs().max()) for i in range(4)]
    rms = float(diff.double().pow(2).mean().sqrt())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    return errs, rms, agree, got


def lm_moonlight(torch, np):
    """Phase 9m, part 2: Moonlight-16B-A3B at full width in bf16 on the
    card, weights drawn on the card from seed 0 one tensor at a time;
    4 x 2,048 SyntheticCorpus prompts (MoE capacity 961 in the prefill),
    ``make_prefill_step`` and 16 greedy ``make_decode_step`` calls, with
    the checks and times of the module docstring. Returns (the model,
    the prompts) for the telemetry part."""
    from repro_torch.analysis.roofline import HW
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.steps import make_decode_step, make_prefill_step

    cfg = ARCHS[LM_ARCH]
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = tfm.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                            cfg, DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rules_vs_state(torch, "9m", cfg, model,
                   torch.cuda.memory_allocated() - mem0)
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"models: {LM_ARCH} at full width ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts top "
        f"{cfg.num_experts_per_tok}, vocabulary {cfg.vocab_size}), bf16: "
        f"{n_params / 1e9:.3f} B parameters, {w_bytes / 2**30:.2f} GiB, "
        f"init {t_init:.2f} s on the card (seed {SEED})")

    t0 = time.perf_counter()
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=LM_PROMPT,
                             global_batch=LM_BATCH, seed=SEED)
    tokens = torch.from_numpy(corpus.batch(0)["tokens"]).to(DEVICE)
    t_corpus = time.perf_counter() - t0
    s_cache = LM_PROMPT + LM_GEN + 8
    cache = tfm.init_cache(cfg, LM_BATCH, s_cache, DEVICE)
    cap = max(int(LM_BATCH * LM_PROMPT // cfg.num_experts
                  * cfg.num_experts_per_tok * cfg.capacity_factor) + 1,
              cfg.num_experts_per_tok)

    # the prefill's last logits against the forward's, exactly: the same
    # products on the same rows (one warm-up each)
    logits, _ = tfm.prefill(model, cfg, tokens, cache)
    hidden, _ = tfm.forward_hidden(model, cfg, tokens)
    fwd_last = tfm.lm_logits(model, cfg, hidden[:, -1])
    del hidden
    if not (torch.isfinite(logits).all() and torch.equal(logits, fwd_last)):
        fail(f"models: prefill's last logits differ from the forward's by "
             f"{float((logits - fwd_last).abs().max())}")

    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    (tok, cache), t_prefill = timed(
        torch, lambda: prefill(model, {"tokens": tokens}, cache))
    if not torch.equal(tok, logits.argmax(-1).to(tok.dtype)):
        fail("models: make_prefill_step's tokens are not the argmax of the "
             "prefill's logits")
    tok = tok[:, None]
    # each MoE layer's expert ids are kept (a list append a layer, no
    # synchronize) for the routed-expert bound
    routed, moe_ffn = [], moe.moe_ffn

    def recording(p, x, c):
        out = moe_ffn(p, x, c)
        routed.append(out[2])
        return out

    out, ms = [tok], []
    moe.moe_ffn = recording
    try:
        for i in range(LM_GEN):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tok, cache = decode(model, tok, cache, LM_PROMPT + i)
            end.record()
            out.append(tok)
            ms.append((start, end))
    finally:
        moe.moe_ffn = moe_ffn
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ms]
    gen = torch.cat(out, dim=1)
    if not (gen.shape == (LM_BATCH, LM_GEN + 1) and int(gen.min()) >= 0
            and int(gen.max()) < cfg.vocab_padded):
        fail(f"models: generated tokens {tuple(gen.shape)} outside "
             f"[0, {cfg.vocab_padded})")
    kv_bytes = sum(t.numel() * t.element_size()
                   for c in cache["blocks"] for t in c.values())
    del cache
    med = statistics.median(ms)
    n_tok = LM_BATCH * LM_PROMPT
    log(f"models: prefill {LM_BATCH} x {LM_PROMPT} tokens (MoE capacity "
        f"{cap} an expert): {t_prefill:.3f} s, {n_tok / t_prefill:.0f} "
        f"tokens/s (host clock ending in a synchronize, after one warm "
        f"prefill and one forward); corpus {t_corpus:.2f} s on the host; "
        f"last logits equal to lm_logits(forward_hidden)[:, -1]")
    log(f"models: decode {LM_GEN} greedy steps of {LM_BATCH} tokens: median "
        f"{med:.3f} ms a step (min {min(ms):.3f}, max {max(ms):.3f}; CUDA "
        f"events), {LM_BATCH * 1e3 / med:.1f} tokens/s")
    lm_decode_bounds(torch, model, cfg, w_bytes, kv_bytes, s_cache, routed,
                     ms, HW().hbm_bw)
    del routed

    lm_teacher_forced(torch, model, cfg, tokens, LM_BF16_TOL, LM_BF16_FAULTS)
    return model, tokens


def lm_teacher_forced(torch, model, cfg, tokens, tol, must_see):
    """A prefill of the first ``LM_CHECK_FROM`` tokens, then decode of the
    next 4, against the forward over all the prompt, with the MoE capacity
    raised so that no token is dropped (drops depend on a batch's token
    count, so the two would drop different tokens otherwise): the
    prefill's logits within ``LM_REDUCED_TOL`` of the forward's at its
    last position (the same hidden state; the float32 head's product
    differs in its accumulation order), each decode step's within ``tol``
    (max abs err), and the greedy tokens equal where the forward's top-2
    margin exceeds ``tol``. The same 4 steps with a planted fault
    (``_teacher_forced``) must go over ``tol`` for every fault in
    ``must_see``; the others are reported."""
    from dataclasses import replace

    from repro_torch.models import transformer as tfm

    e, k = cfg.num_experts, cfg.num_experts_per_tok
    nodrop = replace(cfg, capacity_factor=e / k * (1 + 1e-6))
    hidden, _ = tfm.forward_hidden(model, nodrop, tokens)
    want = tfm.lm_logits(model, nodrop,
                         hidden[:, LM_CHECK_FROM - 1:LM_CHECK_FROM + 4])
    del hidden
    cache = tfm.init_cache(nodrop, LM_BATCH, LM_CHECK_FROM + 8, DEVICE)
    first, cache = tfm.prefill(model, nodrop, tokens[:, :LM_CHECK_FROM],
                               cache)
    err_first = float((first - want[:, 0]).abs().max())
    runs = {}
    for fault in ("pos", "drop", None):
        c = cache if fault is None else {"blocks": [
            {n: t.clone() for n, t in b.items()} for b in cache["blocks"]]}
        runs[fault] = _teacher_forced(torch, tfm, model, nodrop, tokens, c,
                                      want[:, 1:], fault)
        del c
    del cache
    errs, rms, agree, got = runs[None]
    checked, same = 0, True
    for i in range(4):
        n, ok = _margin_ok(want[:, 1 + i], got[:, i].argmax(-1), tol)
        checked, same = checked + n, same and ok
    label = (f"{cfg.dtype}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
             f"{e} experts")
    rows = 4 * LM_BATCH
    log(f"models: teacher-forced ({label}): prefill of {LM_CHECK_FROM} "
        f"(max abs err {err_first:.3e} against the forward there; "
        f"tolerance {LM_REDUCED_TOL}) then 4 decode steps vs the forward "
        f"over {LM_PROMPT} (no capacity drops; logits up to "
        f"{float(want.abs().max()):.2f}): max abs err by step "
        f"{[f'{x:.3e}' for x in errs]}, rms {rms:.3e}, greedy tokens equal "
        f"in {agree} of {rows}; tolerance {tol} on the max; {checked} of "
        f"{rows} rows have a top-2 margin above it")
    faults = {"pos": "each step told its position + 1",
              "drop": "the previous position's K/V zeroed"}
    for fault, what in faults.items():
        f_errs, f_rms, f_agree, _ = runs[fault]
        log(f"models: teacher-forced ({label}), planted fault, {what}: max "
            f"abs err by step {[f'{x:.3e}' for x in f_errs]}, rms "
            f"{f_rms:.3e}, greedy tokens equal in {f_agree} of {rows} "
            f"({'must exceed' if fault in must_see else 'reported;'} "
            f"tolerance {tol})")
    if not torch.isfinite(got).all():
        fail("models: non-finite logits in the teacher-forced check")
    if err_first > LM_REDUCED_TOL:
        fail(f"models: the prefill of {LM_CHECK_FROM} tokens differs from "
             f"the forward at its last position by {err_first}")
    if max(errs) > tol:
        fail(f"models: decode differs from the teacher-forced forward by "
             f"{max(errs)} ({label})")
    if not same:
        fail(f"models: a greedy token differs from the forward's where its "
             f"top-2 margin exceeds {tol} ({label})")
    for fault in must_see:
        if max(runs[fault][0]) <= tol:
            fail(f"models: the teacher-forced check ({label}) does not see "
                 f"a planted fault ({faults[fault]}: max abs err "
                 f"{max(runs[fault][0])} within {tol})")


def lm_float32_check(torch):
    """Phase 9m, part 2b: the teacher-forced check at full width in
    float32 (TF32 off), where rounding cannot hide a fault: Moonlight-
    16B-A3B cut to ``LM_F32_LAYERS`` layers, weights drawn on the card
    from seed 0, the same prompts; held at ``LM_F32_TOL``, and both
    planted faults must go over it."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.models import transformer as tfm

    cfg = replace(ARCHS[LM_ARCH], dtype="float32", num_layers=LM_F32_LAYERS)
    model = tfm.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                            cfg, DEVICE)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=LM_PROMPT,
                             global_batch=LM_BATCH, seed=SEED)
    tokens = torch.from_numpy(corpus.batch(0)["tokens"]).to(DEVICE)
    lm_teacher_forced(torch, model, cfg, tokens, LM_F32_TOL, ("pos", "drop"))
    del model, tokens


def lm_decode_bounds(torch, model, cfg, w_bytes, kv_bytes, s_cache, routed,
                     ms, hbm_bw):
    """Print the decode step's two bytes bounds over ``hbm_bw`` and the
    share of each that the median step reaches: the reference's dispatch
    (every weight but the embedding table, the 64 experts of every layer
    included, plus the whole KV cache), and the least the step's output
    needs (every weight but the embedding and the experts, the experts
    the step's routers picked, each read once a layer, and the KV cache
    up to the step's position). ``routed``: the expert ids of every MoE
    layer of every timed step, in order."""
    import torch.nn.functional as F

    embed = model.embed.w.numel() * model.embed.w.element_size()
    one_expert = sum(t[0].numel() * t.element_size()
                     for t in (model.blocks[0].ffn.gate,
                               model.blocks[0].ffn.up,
                               model.blocks[0].ffn.down))
    layers = len(routed) // len(ms)
    experts = layers * cfg.num_experts * one_expert
    ids = torch.stack(routed).long().reshape(len(ms), layers, -1)
    picked = (F.one_hot(ids, cfg.num_experts).sum(dim=2) > 0).sum(
        dim=(1, 2)).cpu()
    kv_slot = kv_bytes / s_cache
    all_b = (w_bytes - embed + kv_bytes) / hbm_bw * 1e3
    routed_b = [(w_bytes - embed - experts + int(n) * one_expert
                 + kv_slot * (LM_PROMPT + i + 1)) / hbm_bw * 1e3
                for i, n in enumerate(picked)]
    med = statistics.median(ms)
    r_med = statistics.median(routed_b)
    log(f"models: decode bound, every expert (the reference's dispatch): "
        f"{all_b:.3f} ms a step ({(w_bytes - embed) / 1e9:.2f} GB of "
        f"weights but the embedding, the {experts / 1e9:.2f} GB of all "
        f"{cfg.num_experts} experts in {layers} layers included, plus the "
        f"{kv_bytes / 1e9:.2f} GB KV cache, over {hbm_bw / 1e12:.2f} TB/s); "
        f"the median step reaches {100 * all_b / med:.1f}% of it")
    log(f"models: decode bound, routed experts only: median {r_med:.3f} ms "
        f"a step ({min(routed_b):.3f}-{max(routed_b):.3f}; "
        f"{int(picked.min())}-{int(picked.max())} distinct experts a step "
        f"over {layers} layers, at most "
        f"{min(cfg.num_experts, LM_BATCH * cfg.num_experts_per_tok)} a layer, {one_expert / 1e6:.2f} MB each; the non-expert weights "
        f"{(w_bytes - embed - experts) / 1e9:.2f} GB; the KV cache up to "
        f"the step's position); the median step reaches "
        f"{100 * r_med / med:.1f}% of it")


def lm_routing(torch, np, model, tokens):
    """Phase 9m, part 3: the served prompts' routing into RoutingSketch,
    as ``examples/expert_telemetry.py`` does: ``embed_lookup``, the first
    MoE layer's ``moe_ffn``, ``RoutingSketch(64, HLLConfig(p=10))`` over
    the 8,192 x 6 assignments; coverage against ``torch.unique`` counts
    (within 3 x rel_std), ``collapse_score``'s 2,016 pairs from one
    ``ertl_stats`` launch. Returns (the sketch's config, its table, its
    coverage, the expert ids, the token ids) for ``routing_vs_plain``."""
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.data.telemetry import RoutingSketch
    from repro_torch.kernels import _build
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    x = tfm.embed_lookup(model, cfg, tokens)
    _, _, ids = moe.moe_ffn(model.blocks[0].ffn, x, cfg)
    tok = tokens.reshape(-1)
    rs = RoutingSketch(cfg.num_experts, HLLConfig(p=TEL_P_ROUTING))
    table, t_up = timed(torch, lambda: rs.update(rs.init(DEVICE), ids, tok))
    cov, t_cov = timed(torch, lambda: rs.coverage(table))
    before = _build.launch_counts()["ertl_stats"]
    jac, t_jac = timed(torch, lambda: rs.collapse_score(table))
    ertl = _build.launch_counts()["ertl_stats"] - before
    k = cfg.num_experts_per_tok
    keys = torch.unique(ids.reshape(-1).long() * cfg.vocab_padded
                        + tok.long().repeat_interleave(k))
    exact = torch.bincount(keys // cfg.vocab_padded,
                           minlength=cfg.num_experts).double()
    rel = ((cov.double() - exact).abs() / exact.clamp(min=1)).cpu()
    log(f"models: routing telemetry: {ids.numel()} assignments of "
        f"{tok.numel()} served tokens (layer 0's router) into "
        f"RoutingSketch({cfg.num_experts}, p={TEL_P_ROUTING}): update "
        f"{t_up * 1e3:.2f} ms, coverage {t_cov * 1e3:.2f} ms, collapse_score "
        f"{t_jac * 1e3:.2f} ms (ertl_stats launched {ertl} time(s)); exact "
        f"distinct {int(exact.min())}-{int(exact.max())} an expert, coverage "
        f"relative error max {float(rel.max()):.4f} (3 x rel_std "
        f"{3 * rel_std(TEL_P_ROUTING):.4f}); max pairwise Jaccard "
        f"{float(jac.max()):.4f}")
    if ertl != 1:
        fail(f"models: collapse_score launched ertl_stats {ertl} times")
    if float(rel.max()) >= 3 * rel_std(TEL_P_ROUTING):
        fail("models: an expert's coverage is outside 3 x rel_std of its "
             "exact distinct count")
    if not (jac.shape == (cfg.num_experts, cfg.num_experts)
            and np.isfinite(jac).all()):
        fail("models: collapse_score is not a finite E x E matrix")
    return rs.cfg, table, cov, ids, tok


def lm_launcher(torch):
    """Phase 9m, part 4: ``python -m repro_torch.launch.serve --arch
    moonshot-v1-16b-a3b`` on the card (its reduced config) exits 0 and
    prints ``generated``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    line = next((ln for ln in out.stdout.splitlines()
                 if ln.startswith("generated")), None)
    if out.returncode != 0 or line is None:
        fail(f"models: launch.serve exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    log(f"models: python -m repro_torch.launch.serve --arch {LM_ARCH}: "
        f"{line} ({time.perf_counter() - t0:.1f} s with the process start)")


def model_phase(torch, np):
    """Phase 9m: the LM substrate's serving path, counters zeroed just
    before; everything freed at its end. Returns the counts."""
    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    base = mem_start(torch)
    _build.reset_launch_counts()
    lm_reduced_archs(torch, np)
    model, tokens = lm_moonlight(torch, np)
    rcfg, table, cov, ids, tok = lm_routing(torch, np, model, tokens)
    counts = dict(_build.launch_counts())
    log(f"models: peak {mem_peak(torch, base, [])}")
    del model, tokens
    torch.cuda.empty_cache()
    lm_float32_check(torch)
    held = routing_vs_plain(torch, np, "models", rcfg, table, cov, ids,
                            tok.repeat_interleave(ids.shape[1]))
    log(f"models: kernels vs plain on the served routing: {held}")
    del table, cov, ids, tok
    torch.cuda.empty_cache()
    lm_launcher(torch)
    log(f"models: phase {time.perf_counter() - t_phase:.1f} s, launches "
        f"{({k: v for k, v in counts.items() if v})}")
    for k in ("hll_accumulate", "hll_estimate_stats"):
        if counts[k] == 0:
            fail(f"models: {k} never launched")
    if counts["ertl_stats"] != 1:
        fail(f"models: ertl_stats launched {counts['ertl_stats']} times")
    return counts


# ------------------------------------------------------------- LM training
def train_moonlight(torch, np):
    """Phase 9g, part 1: Moonlight-16B-A3B at full width, cut to
    ``TR_LAYERS`` layers, trained ``TR_STEPS`` steps through
    ``make_train_step`` and ``train_loop`` (weights from seed 0 on the
    card, float32 AdamW moments, remat "full"); its routing sketched as
    ``examples/expert_telemetry.py`` and ``examples/train_lm.py`` do.
    Returns (the sketch's config, table, coverage, expert ids, token ids)
    for ``routing_vs_plain``."""
    from dataclasses import replace

    from repro_torch.analysis.roofline import HW, model_flops
    from repro_torch.configs import ARCHS
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.data.telemetry import NGramSketch, RoutingSketch
    from repro_torch.models import convert, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.ft import FTConfig, train_loop

    cfg = replace(ARCHS[LM_ARCH], num_layers=TR_LAYERS)
    base = mem_start(torch)
    t0 = time.perf_counter()
    model = tfm.init_params(torch.Generator(device=DEVICE).manual_seed(SEED),
                            cfg, DEVICE)
    w_grown = torch.cuda.memory_allocated() - base
    opt_cfg = AdamWConfig(dtype=cfg.adam_dtype)
    opt = adamw_init(model, opt_cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rules_vs_state(torch, "9g", cfg, model, w_grown, opt,
                   torch.cuda.memory_allocated() - base - w_grown)
    n_params = sum(p.numel() for p in model.parameters())
    held = torch.cuda.memory_allocated() - base
    log(f"train: {LM_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.num_experts} experts top {cfg.num_experts_per_tok}, "
        f"vocabulary {cfg.vocab_size}), {TR_LAYERS} of "
        f"{ARCHS[LM_ARCH].num_layers} layers, {cfg.dtype} weights, "
        f"{opt_cfg.dtype} AdamW moments, remat {cfg.remat!r}: "
        f"{n_params / 1e9:.3f} B parameters, weights and moments "
        f"{held / 2**30:.2f} GiB, init {t_init:.2f} s on the card")

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=TR_SEQ,
                             global_batch=TR_BATCH, seed=TR_SEED)
    rs = RoutingSketch(cfg.num_experts, HLLConfig(p=TEL_P_ROUTING))
    ngrams = NGramSketch(n=2)
    sk = {"table": rs.init(DEVICE), "ngrams": ngrams.init(DEVICE)}
    toks, ids, events, norms = [], [], [], []

    def to_device(b):
        out = {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
        sk["ngrams"] = ngrams.update(sk["ngrams"], out["tokens"])
        toks.append(out["tokens"])
        return out

    step_fn = make_train_step(cfg, opt_cfg, peak_lr=TR_LR, warmup=1,
                              total_steps=TR_STEPS)

    def timed_step(params, opt_state, batch, step):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(params, opt_state, batch, step)
        end.record()
        events.append((start, end))
        return out

    def on_metrics(step, metrics, dt):
        # the step's tokens through the trained layer 0's router
        norms.append(float(metrics["grad_norm"]))
        with torch.no_grad():
            x = tfm.embed_lookup(model, cfg, toks[-1])
            ids.append(moe.moe_ffn(model.blocks[0].ffn, x, cfg)[2])
        sk["table"] = rs.update(sk["table"], ids[-1], toks[-1].reshape(-1))

    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    model, opt, hist = train_loop(
        step_fn=timed_step, params=model, opt_state=opt, corpus=corpus,
        num_steps=TR_STEPS, ft=FTConfig(ckpt_dir=str(ckpt_dir), ckpt_every=0),
        to_device=to_device, log_every=0, on_metrics=on_metrics,
        codec=convert.TRAIN_STATE)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    med = statistics.median(ms[1:])
    n_tok = TR_BATCH * TR_SEQ
    mfu = model_flops(cfg, n_tok, "train") / (med / 1e3) / HW().peak_flops
    losses = hist["loss"]
    log(f"train: {TR_STEPS} steps of {TR_BATCH} x {TR_SEQ} tokens: median "
        f"{med:.1f} ms a step over steps 2-{TR_STEPS} (CUDA events; first "
        f"{ms[0]:.1f} ms, min {min(ms[1:]):.1f}, max {max(ms[1:]):.1f}), "
        f"{n_tok * 1e3 / med:.0f} tokens/s, model-FLOP utilisation "
        f"{mfu:.4f} ({model_flops(cfg, n_tok, 'train') / 1e12:.2f} TFLOP a "
        f"step of 6 x active parameters x tokens over "
        f"{HW().peak_flops / 1e12:.0f} TFLOP/s dense bf16); loop "
        f"{t_loop:.1f} s with the telemetry; {mem_peak(torch, base, [])}")
    log(f"train: loss by step {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}")
    if not (len(losses) == TR_STEPS and all(np.isfinite(losses))
            and all(np.isfinite(norms))):
        fail(f"train: non-finite loss or gradient norm: {losses}, {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: {losses}")

    table, tok = sk["table"], torch.cat(toks).reshape(-1)
    ids = torch.cat(ids)
    cov, t_cov = timed(torch, lambda: rs.coverage(table))
    jac, t_jac = timed(torch, lambda: rs.collapse_score(table))
    k = cfg.num_experts_per_tok
    keys = torch.unique(ids.reshape(-1).long() * cfg.vocab_padded
                        + tok.long().repeat_interleave(k))
    exact = torch.bincount(keys // cfg.vocab_padded,
                           minlength=cfg.num_experts).double()
    rel_all = ((cov.double() - exact).abs() / exact.clamp(min=1)).cpu()
    rel, rms = float(rel_all.max()), float(rel_all.pow(2).mean().sqrt())
    pairs = torch.cat([t.reshape(-1, TR_SEQ) for t in toks]).long()
    bigrams = torch.unique(pairs[:, :-1] * cfg.vocab_padded + pairs[:, 1:])
    distinct = ngrams.distinct(sk["ngrams"])
    ng_rel = abs(distinct - bigrams.numel()) / bigrams.numel()
    log(f"train: routing telemetry of the trained layer 0 over the "
        f"{TR_STEPS} steps: {ids.numel()} assignments into "
        f"RoutingSketch({cfg.num_experts}, p={TEL_P_ROUTING}), exact distinct "
        f"{int(exact.min())}-{int(exact.max())} an expert, coverage relative "
        f"error root mean square {rms:.4f} (gate {TR_COV_RMS} x rel_std "
        f"{TR_COV_RMS * rel_std(TEL_P_ROUTING):.4f}), max {rel:.4f} (gate "
        f"{TR_COV_MAX} x rel_std {TR_COV_MAX * rel_std(TEL_P_ROUTING):.4f}) "
        f"({t_cov * 1e3:.2f} ms), collapse_score "
        f"{t_jac * 1e3:.2f} ms, max pairwise Jaccard {float(jac.max()):.4f}; "
        f"NGramSketch(n=2) {distinct:.0f} distinct bigrams against "
        f"{bigrams.numel()} exact (relative error {ng_rel:.4f})")
    if rms >= TR_COV_RMS * rel_std(TEL_P_ROUTING):
        fail("train: the coverage's root mean square relative error is "
             f"outside {TR_COV_RMS} x rel_std")
    if rel >= TR_COV_MAX * rel_std(TEL_P_ROUTING):
        fail(f"train: an expert's coverage is outside {TR_COV_MAX} x "
             f"rel_std: {rel_all.tolist()}")
    if ng_rel >= 3 * rel_std(ngrams.cfg.p):
        fail("train: the n-gram sketch is outside 3 x rel_std")
    if not (jac.shape == (cfg.num_experts, cfg.num_experts)
            and np.isfinite(jac).all()):
        fail("train: collapse_score is not a finite E x E matrix")
    del model, opt
    return rs.cfg, table, cov, ids, tok


def train_reduced(torch, np):
    """Phase 9g, part 2: every arch at ``reduced()`` (grok-1's moments in
    bfloat16, its ``adam_dtype``), one train step in float32 with TF32
    off on the card and on the CPU (``models.parity.train_step_on_both``,
    shared with the card test): loss, every gradient and every updated
    parameter within ``TR_RED_TOL`` (``models.parity.step_mismatches``:
    a parameter whose gradient is at its rounding floor, which Adam's
    first step normalises, within 2 x the rate, at most a thousandth of
    them); then qwen2-1.5b's step at ``grad_accum=2`` against its
    ``grad_accum=1`` step on the card within ``TR_ACCUM_TOL``."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models.parity import step_mismatches, train_step_on_both

    lines, one = [], None
    for name in sorted(ARCHS):
        cpu, gpu = train_step_on_both(ARCHS[name].reduced(), DEVICE,
                                      peak_lr=TR_RED_LR, seed=SEED,
                                      data_seed=SEED)
        errs, bad = step_mismatches(cpu, gpu, TR_RED_TOL)
        finite = all(torch.isfinite(t).all() for t in
                     list(gpu["grads"].values())
                     + list(gpu["params"].values()))
        lines.append(f"{name} {errs['loss']:.1e}/{errs['grads']:.1e}/"
                     f"{errs['params']:.1e}/{errs['floor']}"
                     + (f" ({errs['floor_lr']:.2f} lr)" if errs['floor']
                        else ""))
        if bad or not finite:
            fail(f"train: {name} reduced: the card's step differs from the "
                 f"CPU's (finite {finite}): {bad[:5]}")
        if name == TR_LAUNCH_ARCH:
            one = gpu
    log(f"train: reduced configs, one step card vs CPU in float32 (TF32 "
        f"off, rate {TR_RED_LR}), max abs err loss/gradients/parameters, "
        f"then the parameters beyond {TR_RED_TOL} (floor gradients): "
        f"{', '.join(lines)}")
    _, two = train_step_on_both(
        replace(ARCHS[TR_LAUNCH_ARCH].reduced(), grad_accum=2), DEVICE,
        peak_lr=TR_RED_LR, seed=SEED, data_seed=SEED)
    errs, bad = step_mismatches(one, two, TR_ACCUM_TOL)
    log(f"train: {TR_LAUNCH_ARCH} reduced, grad_accum=2 against 1 on the "
        f"card: loss {errs['loss']:.1e}, grad_norm {errs['grad_norm']:.1e}, "
        f"parameters {errs['params']:.1e}, {errs['floor']} beyond "
        f"{TR_ACCUM_TOL} (tolerance {TR_ACCUM_TOL})")
    if bad:
        fail(f"train: grad_accum=2 differs from one microbatch: {bad[:5]}")


def train_compressed_psum(torch, np):
    """Phase 9g, part 3: ``optim.compressed_psum`` over 4 pods' tensors on
    the card equals the CPU's bit for bit."""
    from repro_torch.optim import compressed_psum

    x = np.random.default_rng(SEED).normal(size=(4, 1 << 20)).astype(
        np.float32)
    want = compressed_psum([torch.from_numpy(r) for r in x])
    got, t = timed(torch, lambda: compressed_psum(
        [torch.from_numpy(r).to(DEVICE) for r in x]))
    if not torch.equal(got.cpu(), want):
        fail(f"train: compressed_psum on the card differs from the CPU's by "
             f"{float((got.cpu() - want).abs().max())}")
    log(f"train: compressed_psum of 4 x {x.shape[1]} float32 on the card "
        f"equal to the CPU's bit for bit ({t * 1e3:.2f} ms)")


def train_launcher(torch):
    """Phase 9g, part 4: ``python -m repro_torch.launch.train --arch
    qwen2-1.5b --steps 12 --ckpt-every 5`` on the card (its reduced
    config): the loss falls; a second run to 15 steps restores step 10
    and resumes. The directory is removed."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ckpt_dir = ROOT / "build" / "chip_smoke_train_launch"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    outs = []
    try:
        for steps in (TR_LAUNCH_STEPS, TR_LAUNCH_RESUME):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 TR_LAUNCH_ARCH, "--steps", str(steps), "--ckpt-every", "5",
                 "--ckpt-dir", str(ckpt_dir)],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=300)
            line = next((ln for ln in out.stdout.splitlines()
                         if ln.startswith("final loss")), None)
            if out.returncode != 0 or line is None:
                fail(f"train: launch.train exited {out.returncode}: "
                     f"{out.stderr[-2000:]}")
            outs.append((out.stdout, line, time.perf_counter() - t0))
        saved = sorted(os.listdir(ckpt_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    last, first = outs[0][1][len("final loss: "):].split(")")[0].split(
        " (first: ")
    if not float(last) < float(first):
        fail(f"train: launch.train's loss did not fall: {outs[0][1]}")
    if ("restored from step 10" not in outs[1][0]
            or saved != ["step_10", "step_5"]):
        fail(f"train: the second launch.train did not resume from step 10 "
             f"({saved}): {outs[1][0][-500:]}")
    log(f"train: python -m repro_torch.launch.train --arch {TR_LAUNCH_ARCH} "
        f"--steps {TR_LAUNCH_STEPS} --ckpt-every 5: {outs[0][1]} "
        f"({outs[0][2]:.1f} s with the process start); --steps "
        f"{TR_LAUNCH_RESUME}: restored from step 10, {outs[1][1]} "
        f"({outs[1][2]:.1f} s)")


def train_phase(torch, np):
    """Phase 9g: the LM training path, counters zeroed just before;
    everything freed at its end. Returns the counts."""
    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    rcfg, table, cov, ids, tok = train_moonlight(torch, np)
    counts = dict(_build.launch_counts())
    torch.cuda.empty_cache()
    held = routing_vs_plain(torch, np, "train", rcfg, table, cov, ids,
                            tok.repeat_interleave(ids.shape[1]))
    log(f"train: kernels vs plain on the trained model's routing: {held}")
    del table, cov, ids, tok
    train_reduced(torch, np)
    train_compressed_psum(torch, np)
    train_launcher(torch)
    log(f"train: phase {time.perf_counter() - t_phase:.1f} s, launches "
        f"{({k: v for k, v in counts.items() if v})}")
    for k in ("hll_accumulate", "hll_estimate_stats", "ertl_stats"):
        if counts[k] == 0:
            fail(f"train: {k} never launched")
    return counts


# ------------------------------------------------------- mesh and dry-run
def _alloc_slack(nbytes: int) -> int:
    """Most the caching allocator may add to one tensor's bytes: blocks
    are multiples of 512 bytes, and a block is handed out whole when what
    would be left of it is under 512 bytes (small pool) or under 1 MiB
    (large pool, requests above 1 MiB)."""
    return 1024 if nbytes <= 1 << 20 else (1 << 20) + 512


def one_card_mesh(torch):
    """The (1, 1) ("data", "model") mesh over the real card."""
    from repro_torch.launch.mesh import Mesh
    return Mesh((1, 1), ("data", "model"), (torch.device(DEVICE, 0),))


def rules_vs_state(torch, tag, cfg, model, grown, opt=None, opt_grown=None):
    """Phase 9d, part (b), inside phase ``tag`` before it frees the model:
    ``param_shapes(cfg)`` equals the model's shapes and dtypes key for key
    under the JAX tree keys; ``input_specs`` on the one-card mesh gives
    per-device parameter bytes (and, with ``opt``, AdamW state bytes)
    equal to the sum of the tensors' ``nbytes``; and both equal the growth
    of ``memory_allocated()`` across the build (``grown``, ``opt_grown``)
    within the allocator's rounding per tensor (``_alloc_slack``)."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import convert, sharding
    from repro_torch.models import transformer as tfm

    named = dict(model.named_parameters())
    held = convert._stacked(
        cfg, {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in named.items()}, torch.stack)
    want = tfm.param_shapes(cfg)
    pairs = list(sharding.leaves_with_specs(want, held))
    if len(pairs) != len(list(sharding.leaves_with_specs(held, want))):
        fail(f"mesh ({tag}): param_shapes and the model differ in leaves")
    for path, w, h in pairs:
        if (tuple(w.shape), w.dtype) != (tuple(h.shape), h.dtype):
            fail(f"mesh ({tag}): {'/'.join(map(str, path))}: param_shapes "
                 f"{tuple(w.shape)} {w.dtype}, model {tuple(h.shape)} "
                 f"{h.dtype}")
    mesh = one_card_mesh(torch)
    specs = sharding.input_specs(
        cfg, SHAPES["train_4k" if opt is not None else "prefill_32k"], mesh)
    held = [("parameters", list(named.values()), grown, "params")]
    if opt is not None:
        held.append(("AdamW state", list(opt["m"].values())
                     + list(opt["v"].values()) + [opt["count"]],
                     opt_grown, "opt_state"))
    parts = []
    for what, tensors, got, key in held:
        nbytes = sum(t.nbytes for t in tensors)
        rules = sharding.bytes_per_device(*specs[key], mesh)
        slack = sum(_alloc_slack(t.nbytes) for t in tensors)
        if rules != nbytes:
            fail(f"mesh ({tag}): the rules reckon {rules} bytes of "
                 f"{what} on one card, the tensors hold {nbytes}")
        if not 0 <= got - nbytes <= slack:
            fail(f"mesh ({tag}): {what}: memory_allocated grew {got} bytes "
                 f"for {nbytes} in {len(tensors)} tensors (allowed rounding "
                 f"{slack})")
        parts.append(f"{what} {nbytes} bytes in {len(tensors)} tensors = the "
                     f"rules' per-device bytes on (1, 1); memory_allocated "
                     f"grew {got}, rounding {got - nbytes} bytes "
                     f"({(got - nbytes) / len(tensors):.1f} a tensor, allowed "
                     f"{slack})")
    log(f"mesh ({tag}): param_shapes({cfg.name}, {cfg.num_layers} layers) "
        f"equals the model's {len(pairs)} leaves key for key; "
        + "; ".join(parts))


def mesh_production(torch):
    """Phase 9d, part (a): the production meshes refuse the real card;
    ``make_host_mesh()`` spans the card(s)."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    n = torch.cuda.device_count()
    for multi, need in ((False, 256), (True, 512)):
        try:
            make_production_mesh(multi_pod=multi)
        except RuntimeError as e:
            if f"needs {need} devices, have {n}" not in str(e):
                fail(f"mesh: make_production_mesh(multi_pod={multi}) raised "
                     f"{e}")
            msg = str(e)
        else:
            fail(f"mesh: make_production_mesh(multi_pod={multi}) took "
                 f"{n} card(s)")
    host = make_host_mesh()
    if not (host.axis_names == ("data",) and host.shape == {"data": n}
            and all(d.type == "cuda" for d in host.devices)):
        fail(f"mesh: make_host_mesh() gave {host}")
    log(f"mesh: make_production_mesh() and (multi_pod=True) refuse {n} "
        f"card(s) ({msg!r}); make_host_mesh() is ('data',) over {n}")


def mesh_hints(torch):
    """Phase 9d, part (c): ``pshard.set_mesh`` on the one-card mesh;
    ``MESH_ARCHS`` (a MoE and a dense arch at ``reduced()``) give prefill
    logits, 3 decode steps and one train step on the card equal bit for
    bit to the runs with no mesh set, under deterministic algorithms."""
    import os

    from repro_torch.configs import ARCHS
    from repro_torch.models import parity, pshard

    # cuBLAS reads this before deterministic mode is first turned on
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    lines = []
    try:
        for name in MESH_ARCHS:
            cfg = ARCHS[name].reduced()
            plain = parity.mesh_runs(cfg, DEVICE, None, seed=SEED)
            hinted = parity.mesh_runs(cfg, DEVICE, one_card_mesh(torch),
                                      seed=SEED)
            bad = parity.mesh_mismatches(plain, hinted)
            if bad or pshard._MESH is not None:
                fail(f"mesh: {name} with the (1, 1) mesh set differs from "
                     f"the run without: {bad[:5]}")
            lines.append(f"{name} ({cfg.family}) {len(plain['logits'])} "
                         f"logits and {len(plain['step']['params'])} "
                         f"updated parameters")
    finally:
        torch.use_deterministic_algorithms(False)
        pshard.clear_mesh()
    log(f"mesh: hints on the (1, 1) mesh over the card change nothing, bit "
        f"for bit under deterministic algorithms: {'; '.join(lines)}")


def mesh_sweep(torch):
    """Phase 9d, part (d): ``python -m repro_torch.launch.dryrun --all`` in
    a subprocess (no JAX on this host): all 80 arch x shape x mesh cells
    ``OK`` or ``SKIP``, the skips exactly ``cell_is_applicable``'s, CUDA
    never initialised in that process; prints the Moonlight cells' modeled
    roofline (the H100 ``HW``). Returns the sweep's seconds."""
    import os

    from repro_torch.configs import ARCHS
    from repro_torch.configs.registry import cell_is_applicable
    from repro_torch.launch.dryrun import SWEEP_SHAPES

    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--out", str(out_dir)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        secs = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines or not lines[-1].startswith(
                "DRYRUN SWEEP "):
            fail(f"mesh: the dry-run sweep exited {res.returncode}: "
                 f"{(res.stdout + res.stderr)[-2000:]}")
        counts = json.loads(lines[-1][len("DRYRUN SWEEP "):])
        cells = {tuple(ln.split()[2:5]): ln.split()[1] for ln in lines[:-1]
                 if ln.startswith("DRYRUN ")}
        skips = {(a, sh, m) for a in ARCHS for sh in SWEEP_SHAPES
                 for m in ("single_pod", "multi_pod")
                 if not cell_is_applicable(a, sh)[0]}
        if not (len(cells) == counts["cells"] == 80 and counts["fail"] == 0
                and set(cells.values()) <= {"OK", "SKIP"}
                and {c for c, st in cells.items() if st == "SKIP"} == skips):
            fail(f"mesh: the sweep's cells are not 80 OK/SKIP with "
                 f"cell_is_applicable's skips: {counts}")
        if counts["cuda_initialized"] is not False:
            fail("mesh: the dry-run sweep initialised CUDA")
        roof = []
        for sh in SWEEP_SHAPES:
            for m in ("single_pod", "multi_pod"):
                rec = json.loads((out_dir / f"{LM_ARCH}__{sh}__{m}.json")
                                 .read_text())
                if rec.get("skipped"):
                    continue
                r = rec["roofline"]
                roof.append(f"{sh}/{m}: compute {r['t_compute_s']:.4g} s, "
                            f"memory {r['t_memory_s']:.4g} s, collective "
                            f"{r['t_collective_s']:.4g} s ({r['dominant']}), "
                            f"{rec['collectives']['count']} collectives, "
                            f"{rec['memory']['total_bytes_per_dev'] / 2**30:.2f}"
                            f" GiB a device")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"mesh: dry-run sweep in a subprocess: {counts['ok']} OK, "
        f"{counts['skip']} SKIP (= cell_is_applicable's), 0 FAIL, "
        f"torch.cuda.is_initialized() {counts['cuda_initialized']} there; "
        f"{secs:.1f} s with the process start ({counts['seconds']} s of "
        f"cells)")
    log(f"mesh: {LM_ARCH} modeled on the H100 HW (analysis.roofline.HW: "
        f"989 TFLOP/s, 3.35 TB/s, 25 GB/s a link): {'; '.join(roof)}")
    return secs


def mesh_phase(torch, np):
    """Phase 9d: the mesh and dry-run part, counters zeroed just before
    (it launches no kernel); part (b) ran inside phases 9m and 9g.
    Returns the counts."""
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    mesh_production(torch)
    mesh_hints(torch)
    secs = mesh_sweep(torch)
    counts = dict(_build.launch_counts())
    log(f"mesh: phase {time.perf_counter() - t_phase:.1f} s (sweep "
        f"{secs:.1f} s), launches "
        f"{({k: v for k, v in counts.items() if v})}")
    return counts


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import engine
    defaults = {"REPRO_TORCH_IMPL": (engine.default_impl(), "cuda"),
                "REPRO_TORCH_LAYOUT": (engine.default_layout(), "byte"),
                "REPRO_TORCH_FAMILY": (engine.default_family(), "hll")}
    for var, (got, want) in defaults.items():
        if got != want:
            print(f"chip_smoke: {var}={got!r}: the smoke drives the CUDA "
                  f"kernels on the default {want!r}, unset it",
                  file=sys.stderr)
            return 2
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    regs_used = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln] if lib.with_suffix(
                     ".log").exists() else []
    log(f"build: {time.perf_counter() - t0:.1f} s, {lib.name}; ptxas: "
        f"{' | '.join(regs_used)}")

    from repro_torch.graph import generators
    t0 = time.perf_counter()
    edges = generators.rmat(SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << SCALE
    rng = np.random.default_rng(SEED)
    pairs = edges[rng.choice(len(edges), N_PAIRS, replace=False)]
    verts, sets = neighbor_sets(np, edges, n, rng)
    log(f"graph: rmat scale {SCALE} edge factor {EDGE_FACTOR} seed {SEED}: "
        f"n={n}, m={len(edges)} undirected edges, {N_SETS} sets of "
        f"{min(map(len, sets))}-{max(map(len, sets))} ids, "
        f"{time.perf_counter() - t0:.1f} s on the host")

    rows = []

    def report(kname, err, ms, plain_ms, bnd, lib_ms, shape,
               bound_by="bytes"):
        rows.append({"name": kname, "route": "cuda",
                     "source": SOURCES[kname][0],
                     "replaces": SOURCES[kname][1], "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": bound_by,
                     "library_ms": lib_ms})
        log(f"kernel vs plain: {kname}: max abs err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({bound_by}), "
            f"library {'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
            f"{shape}")

    skew = neighbor_sets(np, edges, n, np.random.default_rng(SEED + 5),
                         max_degree=1023)[1]
    panel = compare_kernels(torch, np, edges, n, pairs, sets, skew, report)
    packed_panel = compare_packed_kernels(torch, np, edges, n, pairs, sets,
                                          skew, panel, report)
    del skew
    counts, byte_deg, hops = main_path(torch, np, edges, n, pairs, verts,
                                       sets, panel)
    t_new = time.perf_counter()
    phases_new = [functional_phase(torch, np, edges, n, panel, byte_deg,
                                   hops),
                  colored_phase(torch, np, edges, n, panel)]
    t_new = time.perf_counter() - t_new
    del hops
    torch.cuda.empty_cache()
    t_serve = time.perf_counter()
    phases = [counts, query_server_phase(torch, np, edges, n, sets),
              continuous_phase(torch, np, edges, n, sets, pairs)]
    t_serve = time.perf_counter() - t_serve
    torch.cuda.empty_cache()
    packed_eng, packed_counts = packed_path(
        torch, np, edges, n, pairs, verts, sets, panel, packed_panel,
        byte_deg)
    t0 = time.perf_counter()
    phases += [packed_counts,
               packed_serving_phase(torch, np, packed_eng, edges, sets)]
    t_serve += time.perf_counter() - t0
    phases.append(packed_durability(torch, np, edges, n, packed_eng))
    del panel, packed_panel, packed_eng
    torch.cuda.empty_cache()
    phases.append(sharded_phase(torch, np, edges, n, pairs, sets))
    torch.cuda.empty_cache()
    phases.append(coordinator_phase(torch, np, edges, n, sets))
    torch.cuda.empty_cache()
    ads_eng, ads_counts, hist = ads_path(torch, np, edges, n)
    phases += [ads_counts, merge_phase(torch, np, edges, n, ads_eng),
               checkpoint_phase(torch, np, n, ads_eng, hist)]
    t0 = time.perf_counter()
    phases += [ads_serving_phase(torch, np, ads_eng),
               failover_phase(torch, np)]
    t_serve += time.perf_counter() - t0
    log(f"serving: the five serving phases took {t_serve:.1f} s")
    del edges, ads_eng
    phases.append(triangle_path(torch, np))
    t0 = time.perf_counter()
    phases += phases_new + [kron_phase(torch, np)]
    t_new += time.perf_counter() - t0
    phases.append(telemetry_phase(torch, np))
    phases.append(model_phase(torch, np))
    phases.append(train_phase(torch, np))
    phases.append(mesh_phase(torch, np))
    t0 = time.perf_counter()
    phases.append(small_reference(torch, np))
    log(f"small reference: {time.perf_counter() - t0:.1f} s")
    log(f"functional core, colored and Kronecker phases: {t_new:.1f} s "
        f"together")
    for row in rows:
        row["launches"] = sum(c[row["name"]] for c in phases)
    idle = [row["name"] for row in rows if row["launches"] == 0]
    if idle:
        fail(f"kernels never launched on a counted path: {idle}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
