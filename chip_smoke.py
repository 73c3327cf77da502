#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100) and ``nvcc``; imports nothing of JAX or of
the JAX package.  Phases, each fatal on failure:

1. device: name, power limit, the properties the DSE reads; TF32 and
   reduced-precision bf16 reductions off;
2. build ``csrc/fused_rnn.cu``, ``csrc/rwkv_step.cu``,
   ``csrc/flash_attention.cu``, ``csrc/matmul_int8.cu`` (these two
   with the shared ``csrc/hopper.cuh``) and ``csrc/decode_loop.cu`` with
   nvcc for sm_90a, one compiler per source, all started together
   (seconds, ptxas report);
3. hold each kernel (``fused_lstm``/``fused_gru``, streaming and
   persistent, the streaming input projection ``xproj``, ``rwkv6_step``, ``flash_attention``, ``flash_decode`` and
   ``matmul_w8a16``) against its plain PyTorch version on the card, at a
   few shapes
   including a ragged tile, D != H, bf16 weights and B > 4, and the
   persistent kernel at lstm-2048's and gru-2560's full width (gru-2560
   in clusters of 2 too), two calls bit-equal; for the int8
   projection (``wgmma``) every bm the tile chooser can pick bit-equal,
   and x and w off a 16-byte boundary bit-equal to aligned copies, at
   lstm-2048's K and N and at a ragged shape; for
   ``rwkv6_step`` the decode shape of rwkv6-1.6b at B=1, 2, 4 and 8 (the
   engines' and the fleet replicas' batches, in place too), T=16, the
   reduced shapes and head tiles of 1, 4 and 32 heads, and every head
   tile (1, 4, H) x column slab bit-equal to the default geometry at three
   shapes (K = V = 64, K = V = 16, K = 16 with V = 64); for the attention
   kernels qwen2.5-14b's own shapes (B 4, 40/8 heads of 128, prefill at
   512 and 1023 with padding rows, decode over 1024 slots with holes),
   the MoE archs' (qwen3-moe's 32/4 heads of 128 and granite-moe's 16/8
   heads of 64: the 4-row bucket-512 prefill and decode over 1024 slots
   with holes, three calls bit-equal at each), hymba-1.5b's (25/5 heads
   of 64: the 4 x 2048 prefill with window 1024 and with window 0,
   decode over 2048 slots and over a wrapped 1024-slot ring under window
   1024 with holes, three calls bit-equal at each), small
   shapes with window and softcap and a ragged tail, every output finite;
   ``flash_attention`` also with a batch row of padding alone, query
   tiles of real and padding rows at bq 64 and 128, window and softcap
   through the skipped tiles at d 128, each head dim (16, 32, 64, 128)
   and queries at the end of longer key rows (Sq != Skv), every case
   bit-equal at every tile the kernel runs, its causal padding rows held
   to the mean of V, and three calls at the main path's shape bit-equal;
   ``flash_decode`` also at chunks 64, 256 and 512 and G = 16 at d 128, a
   wrapped ring cache under a window (slot order is not position order),
   rows that see no key (q_pos = -1; kv_pos all -1) held to the mean of V,
   a plan's chunk made legal by the adapter (2048 over 1500 slots), and
   three calls at the main path's shape bit-equal; for ``matmul_w8a16`` every epilogue with and without bias at M = 4
   (decode) and 512 (prefill), qwen2.5-14b's decode shapes at M = 1 and
   4, its four projection shapes at M = 2048 (the 4-row bucket-512
   prefill), w_gate at M = 128 and 512, and ragged 3 x 200 x 300 and
   40 x 320 x 300; the split-K decode kernel at the seven projections and
   a ragged K 4097 x N 300 at M = 1, 2, 4, 16 and S = 1, the default S and
   the largest S, each geometry bit-equal over three calls, and rows off a
   16-byte boundary bit-equal to aligned ones; the prefill kernel's tiles
   bit-equal at M = 40, three calls bit-equal at w_gate's M = 2048 shape,
   and unaligned rows bit-equal to aligned at every tile; ``rwkv6_step``
   in place (``out=state``) bit-equal to out of place at every head tile
   and slab; the decode loop's control kernel (``decode_loop``) bit-equal
   to its plain version on random states at B 1, 4 and 16 with every
   limit, ``stop_on_free``, EOS hits and full caches, and its time;
4. main path: all ten DeepBench tasks at full H and full T, batch 1,
   through ``cells.serve(impl="kernel")``, streaming and persistent (W_h
   resident; every task must be eligible; two persistent calls
   bit-equal), each compared with the plain version over all T; then
   four requests served as one batch, each row held against that request
   served alone, in both modes (lstm-512 at T=25, and at T=5 for lstm-512
   and gru-2560, where the batch's M = 20 crosses the projection's 16-row
   tile and its rows alone do not).  Launch counters are set to 0
   just before and read just after, and must be 1 projection + T steps
   a streaming call, 1 projection + 1 persistent launch a persistent
   call.  Plan tiles the step kernel
   cannot run as asked (the JAX DSE's whole-H tiles at lstm-1536,
   gru-1536 and gru-2048, and tiles 8 and 24) are made legal and served,
   held to the plain version.  Timings come after, in their
   own calls: the kernel (CUDA events, median), the plain version, and
   ``torch.nn.LSTM``/``GRU`` (cuDNN, bf16) as the library yardstick; for
   a streaming call also the projection alone (device time from a CUDA
   graph, ``torch.matmul`` on bf16 weights as its yardstick, its tile
   and the host time of a call over 1,000 calls), the steps
   alone with programmatic dependent launch on and off and from a CUDA
   graph, the step grid and W_h's bound (``wh_stream_ms``); then, for
   each task with H >= 1024, the step kernel at every streaming tile the
   DSE scores, beside its model; and the int8 projection at every (bm,
   splits) it runs, at each task's M and at M = 1 (the data its tile
   chooser was fitted to); for a persistent call the projection's and
   the persistent launch's device time (``torch.profiler``), µs a step,
   the host time of a call and the grid, and the persistent kernel at
   every resident tile the DSE scores (100 steps and 1, so that the
   slice copy comes apart from a step), beside its model;
4b. LM main path: rwkv6-1.6b at full width (24 layers, d 2048, 32 wkv
   heads of 64, d_ff 7168, vocab 65536), seeded random weights with the
   zero-initialised leaves perturbed.  The port's ``ServingEngine``
   serves 8 requests (max_batch 4, max_len 256, prompts of 16-200
   tokens, 32 new tokens, greedy); the ``rwkv6_step`` counter is set to
   0 just before and read just after, and must be 24 x the decode ticks.
   The same engine with ``tile_plans={"rwkv": {"impl": "plain"}}`` must
   give the same tick schedule; fed the same tokens, kernel and plain
   paths agree on every layer's wkv state and on the logits.  Timings
   follow in their own calls: decode tick at B=1 and B=4, the device's
   busy share of a B=4 tick (``torch.profiler``), a 4-row prefill at
   bucket 128, tokens/s of the 8-request run, and ``rwkv6_step`` at B=1
   and B=4: the device time of a call from a CUDA graph of 24 calls on 24
   operand sets (one tick's layers), its device time a launch in the tick
   (profiler) and a call back to back with the host in, against its plain
   version and its bound;
4c. dense LM main path: qwen2.5-14b at full width (48 layers, d 5120,
   40 query and 8 KV heads of 128, d_ff 13824, vocab 152064), seeded
   random weights built leaf by leaf in bf16 (~29.5 GB) with the
   zero-initialised leaves perturbed.  The port's ``ServingEngine``
   serves 8 requests (max_batch 4, max_len 1024, prompts of 16-500
   tokens, one at bucket 512, 32 new tokens, greedy); the flash counters
   are set to 0 just before and read just after: ``flash_attention`` must
   be 48 x the prefill calls and ``flash_decode`` 48 x the decode ticks.
   The same engine with ``tile_plans={"attn": {"impl": "plain"}}``
   launches neither and gives the same tick schedule; fed the same
   tokens, kernel and plain paths agree on the prefill logits, on every
   layer's k/v cache and on the logits of each decode step.  Timings
   follow in their own calls: decode tick at B=1 and B=4, the device's
   busy share (``torch.profiler``), a 4-row prefill at bucket 512,
   tokens/s of the run, and each kernel per launch against its plain
   version, ``scaled_dot_product_attention`` (timed only) and its bound:
   ``flash_attention`` at the 4-row prefills of buckets 512, 128 and 32
   as the device time of one call from a CUDA graph and the host time of
   a call (wall clock over 1,000 calls), SDPA alike, and at bucket 512
   every tile the kernel runs beside the DSE model's time; ``flash_decode``
   back to back (CUDA events), from a CUDA graph and its host time a
   call, beside two bounds (the K/V rows a query sees, and all 1024
   slots), by chunk (64 to 1024, from a graph) and at B=1 over every
   slot filled; and ``flash_decode``'s device time in a tick (profiler),
   in 4c and 4d;
4d. int8 weights: phase 4c's bf16 tree quantized with ``quantize_tree``
   (consumed leaf by leaf: ~14.0 GB of int8 and scales plus the 1.56 GB
   bf16 embedding), its logits held within 0.15 of the bf16 tree's.  The
   same 8 requests through ``ServingEngine``; the ``matmul_w8a16`` counter
   is set to 0 just before and read just after, and must be 7 x 48 x
   (decode ticks + prefill calls), of which ``matmul_w8a16_prefill``
   (the prefill kernel) 7 x 48 x prefill calls.
   ``tile_plans={"matmul_int8": {"impl": "plain"}}`` launches none and
   gives the same tick schedule; fed the same tokens, the two paths agree
   on logits and k/v as in 4c.  Timings as in 4c, ``matmul_w8a16``'s
   device time per tick (profiler) beside cuBLAS's in 4c's bf16 tick, the
   int8 4 x 512 prefill against 4c's, and one call at each decode shape
   (M = 4), each prefill shape at M = 2048 and w_gate at M = 128 and 512:
   device time (a CUDA graph of calls over weight copies rotated past
   60 MB, so each reads device memory as in a tick, the host's cost out),
   host time (wall clock over 1,000 calls, 20 at prefill), the
   plain version, the bound, and ``torch.matmul`` with bf16 weights made
   beforehand (cuBLAS, the product phase 4c runs; rotated and timed the
   same way, only); device time by split count at the wq and w_down
   shapes, and of a one-step call at S = 1 and 2 (the fixed cost);
   In 4b, 4c and 4d the engine runs each decode chunk as one CUDA graph
   launch (``serving/decode_graph.py``: the tick captured once when the
   engine is built, in a while node) with one host read; the 8 requests
   are served at sync_every 1 and 4, every chunk held bit-equal (n,
   tokens, cache) to the eager chunk run first on a copy of the cache,
   ``host_syncs`` = decode chunks + prefill calls, the launch counters
   grown by the captured tick's launches times the ticks run; timings
   add the capture, ms a tick of a replayed 8-tick and 1-tick chunk at
   B=1 and B=4 against the same chunks run eagerly, the device's busy
   share of a replayed chunk (profiler) and tokens/s at sync_every 1 and
   4; the eager tick timings stay, now in place (``decode_step_``);
4e. open-loop serving (``plan``, ``workload.drive``, ``metrics``): the
   ``SERVING_LOAD_SWEEP`` cells at full width (plans with
   ``reduced=False``, seed 0, duration 32 unless the cell has its own),
   each served through ``ServingEngine.from_plan`` by ``drive`` on a
   ``VirtualClock`` and summed by ``aggregate``: rwkv6-1.6b/b4/r1 and
   rwkv6-1.6b/b4/r0.8/heavy/edf+p (overload, duration 128, preemptive
   EDF, deadlines at 3 x max_new) on a fresh rwkv6-1.6b tree perturbed
   as in 4b, and qwen2.5-14b/b4/r1 inside 4c on its bf16 tree.  Each
   cell: the launch counters set to 0 just before and read just after
   equal the graph's nodes x ticks (``rwkv6_step`` 24 x decode ticks,
   ``flash_decode`` 48 x decode ticks, ``flash_attention`` 48 x prefill
   calls, ``decode_loop`` ticks + chunks); ``host_syncs`` = chunks +
   synchronous prefill calls + preemption bursts; the first 4 chunks
   and every first chunk after a restore bit-equal to the eager chunk
   on a copy of the cache; every restore in place (each leaf's
   ``data_ptr`` kept); the overload cell preempts and resumes every
   victim; the plain path (``{"rwkv": {"impl": "plain"}}``, ``{"attn":
   {"impl": "plain"}}``) launches none of the kernels and gives the same
   stamps and an equal ``aggregate``; the base rwkv cell with
   ``overlap_prefill=False`` too, with one more read for each
   overlapped prefill.  Timings: each cell's drive (wall s, tokens/s),
   a calibrated tick (a warm closed-loop rerun on the same engine, wall
   / ticks) and ``scale_latencies`` by it (queue wait, TTFT, TPOT p50 /
   p95 / p99 ms), the same with overlap off, and one ``WallClock`` drive
   of the base rwkv cell (its aggregate at busy seconds / ticks);
4f. paged serving, inside 4c on its bf16 tree: the three paged cells
   (``cache_layout="paged:16"``: qwen2.5-14b/b4/r1/paged16, the twin of
   4c's dense cell, and qwen2.5-14b/b8/r1/lognormal/paged16 and
   .../bimodal/paged16) served as 4e serves its cells, with the same
   checks (kernel vs plain path, counters, host syncs, the first 4 chunks
   against the eager chunk on a copy of the view) and these: the twin's
   stamps, utilization and aggregate equal to 4c's dense cell; over
   each drive every view leaf, pool leaf and flat index keeps its
   ``data_ptr``, the pool invariants hold after every step, every block
   is free again after the drive and the peak of ``bytes_resident``
   stays below the dense layout's.  Timings as in 4e, and the median
   ``materialize`` (pool -> view) and ``repage`` (view -> pool) ms a
   call in the drive (CUDA events) and alone from a CUDA graph against
   the view's bytes, the host seconds of the paged bookkeeping, the
   engines' capture s and graph pool, each cell's peak device memory
   (its engines freed before the next), and the twin and the dense cell
   driven in turns (dense, paged, paged, dense);
4g. fault storms and crash restart: the six storm cells of the JAX
   package's chaos benchmark whose arch the port serves
   (``rwkv6-1.6b/dense/storm2``, ``/storm4``, ``/storm8`` and
   ``rwkv6-1.6b/paged:8/storm4`` on 4e's tree after 4e;
   ``qwen2.5-14b/dense/storm4`` and ``qwen2.5-14b/paged:8/storm4`` on
   4c's tree after 4f), their plan (``max_batch`` 4, ``max_len`` 64,
   ``retry_budget`` 3, ``watchdog_ticks`` 4), workload (Poisson 0.8 over
   32 units, prompts 4-12, 6-10 new, deadlines at 1.5 x max_new) and
   storm (``make_storm`` seeded with its size) copied as constants,
   ``reduced=False``, each through ``drive_resilient`` with a checkpoint
   every 8 ticks into a temporary directory, twice, beside a fault-free
   ``drive``.  Fatal: nothing lost; storm8 restarts once; the two runs'
   deterministic views (stamps, retries, tokens, events, fault stats,
   restarts, aggregate) byte-identical; every completed request the
   fault-free drive's tokens; every cache, view, pool and index tensor
   at its address after every step of every engine; paged, the pool
   invariants after every step and every block free after the drive; a
   restored engine on its own decode graph, its first chunk bit-equal to
   the eager chunk; the launch counters equal to the graph's nodes x
   decode ticks and layers x prefill calls summed over the run's engines.
   Printed: each drive's host seconds beside the fault-free drive's, the
   recovery snapshot's ms a chunk and bytes, the guard scan's ms, the
   checkpoint save's ms and bytes, the restore's seconds (engine build,
   capture, load) and the phase's seconds;
4h. the engine's trace hooks (``repro_torch.obs``), on trees built
   before: ``rwkv6-1.6b/b4/r1`` on 4e's tree after 4g, driven untraced,
   traced (a ``Tracer`` and a ``LiveMetrics`` window longer than the
   drive), traced, untraced; ``rwkv6-1.6b/dense/storm4`` traced twice
   through ``drive_resilient`` there; ``qwen2.5-14b/b4/r1/paged16``
   traced twice and its dense cell once on 4c's tree after 4g.  Fatal:
   each cell's two traces byte-identical and passing ``check_trace``;
   the rwkv trace byte-identical to the same plan's at reduced width on
   the CPU (``device="cpu"``, the same items with prompt ids modulo the
   reduced vocabulary: the schedule is model-independent without an
   ``eos_id``); traced and untraced drives with the same stamps,
   ``stats()``, ``fault_stats()``, ``host_syncs``, utilization and
   launch counters, every cache tensor at its address; the live
   window's snapshot the ``aggregate``; the storm's deterministic view
   4g's untraced one, with ``fault``, ``retry`` and ``quarantine``
   events; the paged trace with the three fragmentation counters at
   every ``util`` tick and, without them, the dense cell's bytes.
   Printed: drive seconds traced against untraced and each drive's
   prefill, chunk and other step seconds, the host seconds inside the
   tracer's and the live window's calls, event counts by name (beside
   ``fault_stats()`` for the storm), the trace's bytes and the phase's
   seconds;
4i. the serving tier (``serving/router.py``), on 4e's tree after 4h: the
   six ``FLEET_SERVING_SWEEP`` cells at full width (the twin of
   rwkv6-1.6b/b2/r1; capacity x1, x2 and x4 under least_queue; the
   colocated edf+preempt fleet of four and its disaggregated twin, one
   b4 prefill replica and three b8 decode replicas), each through
   ``Router.from_plan`` (one engine and decode graph a replica) and
   ``drive_fleet`` on a ``VirtualClock``, seed 0, duration 32 unless the
   cell has its own.  Fatal: the census equal to the arrivals submitted
   after every round and, at drain, finished + shed = submitted; the
   launch counters, set to 0 just before each drive and read just after,
   equal to the graphs' nodes x ticks summed over the replicas and, for
   each replica, its own (``rwkv6_step`` and ``decode_loop`` in every
   replica that decoded); every cache tensor of every replica at its
   address and every restore in place; the deterministic view (per
   request uid, replica, stamps and shed flag; every replica's
   ``stats()``; ``transit_stats()`` but its bytes; the census; the
   tick-domain aggregate) of the twin, capacity x2 and the disaggregated
   cell equal to the same fleet's at reduced width on the CPU (prompt
   ids modulo the reduced vocabulary; the other three cells are not held
   so, to keep the script inside half its time limit); the twin's
   ``fleet_aggregate()`` equal to a bare ``drive()`` of its plan and
   items on the same tree, with the same stamps, tokens and ``stats()``;
   the disaggregated cell's hand-offs all delivered, none in flight, no
   decode replica prefilling, the first three read back from the
   destination slot byte-equal to their snapshot.  Printed: each cell's
   drive seconds and tokens/s, replicas' routed requests, ticks, prefill
   calls and host syncs, capture seconds and peak memory; the transit's
   hand-offs, bytes, ticks and bytes a tick; the hand-off's snapshot and
   restore ms on the host clock (restore also by CUDA events) and bytes;
   the capacity cells' SLO-met tokens and attainment in ticks; the
   phase's seconds.  The ``rwkv6_step`` and ``decode_loop`` launches of
   the kernels line include these drives';
4j. the MoE archs (``models/moe.py``, the JAX package's dense GShard
   dispatch), after 4i with 4c/4d's qwen tree freed: qwen3-moe-30b-a3b
   at full width (48 layers, d 2048, 32/4 heads of 128, qk_norm, 128
   experts top-8, d_ff 768, vocab 151,936; ~61 GB of bf16 weights built
   by ``init_serving``, the MoE leaves one layer slice at a time, the
   zero-initialised norm scales perturbed; its GB, build seconds and
   peak logged).  The closed run of 4c (8 requests of 16-500 tokens, 32
   new, max_batch 4, max_len 1024, greedy) through the graph engine,
   its first 8 chunks bit-equal to the eager chunk (an eager MoE tick is
   ~0.3 s of host time); the flash counters, set to 0 just before and
   read just after, 48 x prefill calls and 48 x decode ticks; ``{"attn":
   {"impl": "plain"}}`` the same tick schedule and no flash launch; fed
   the same tokens (4c's ``qwen_teacher_forced``), kernel and plain paths
   on the prefill and each decode step's logits and k/v: with the seeded
   router logged only (the paths' bf16 ulps move router logits across
   the top-8 boundary and change capacity drops, which later layers
   carry), with the router zeroed (every token ties: the same experts on
   both paths) held within 4e-2.  Timings, each in its own calls: the
   graph tick at B=1 and B=4, the busy and idle share of a profiled B=4
   chunk, the 4-row bucket-512 prefill, tokens/s and peak GB of the
   8-request run, and the expert products of a B=4 tick alone (a CUDA
   graph over the 48 layers' weights) against the byte bound of every
   expert's weights.  Then the
   four base-grid cells ``qwen3-moe-30b-a3b/b2/r0.1``, ``/b2/r1``,
   ``/b4/r0.1`` and ``/b4/r1`` through ``drive`` (counters = nodes x
   ticks, the first 4 chunks against the eager chunk, their aggregates
   logged); ``/b4/r1`` also on the plain path (equal stamps and
   aggregate) and at reduced width on the CPU (equal stamps, utilization
   and aggregate).  Then granite-moe-1b-a400m at full width (24 layers,
   16/8 heads of 64, 32 experts, tied embeddings): the same closed run
   and checks.  Peak memory must stay below the card's.  The flash and
   ``decode_loop`` launches of the kernels line include this phase's;
4k. hymba-1.5b (``models/ssm.py``, the "swa_ssm" kind: windowed
   attention over a ring cache of 1024 slots beside the SSD heads),
   after 4j with its trees freed, at full width (32 layers: two periods
   of one "attn" and 15 "swa_ssm" layers, d 1600, 25/5 heads of 64, SSD
   heads of 64 with d_state 16; ~3.1 GB of bf16 weights, the
   zero-initialised leaves perturbed; its GB, build seconds and peak
   logged).  The closed run: 8 requests of 16-1500 tokens (two past the
   window, so their prefill fills the swa rings wrapped), 32 new,
   max_batch 4, max_len 2048, greedy, through the graph engine, its first
   8 chunks bit-equal to the eager chunk; the flash counters, set to 0
   just before and read just after, 32 x prefill calls and 32 x decode
   ticks; ``{"attn": {"impl": "plain"}}`` (which reaches the swa_ssm
   layers' attention half too) the same tick schedule and no flash
   launch; fed the same tokens, kernel and plain paths' logits within
   4e-2 of the largest on the prefill and each of 12 decode steps (the
   k/v, conv_state and ssd_state gaps logged).  The paged twin: the same
   requests on ``paged:16`` (two ring lengths, 2048 and 1024), the dense
   run's stamps and tokens exactly, invariants after every step, every
   tensor at its address.  Timings, each in its own calls: an eager B=4
   tick under the profiler (``flash_decode``'s device time in it), the
   graph tick at B=1 and B=4 and its nodes, the busy and idle share of a
   profiled B=4 chunk, the SSD halves of a B=4 tick alone (a CUDA graph
   of the 30 ``ssm_mixer`` decode calls: ms, kernels, share of the tick),
   the 4-row prefill at buckets 512 and 2047, tokens/s and peak GB of the
   8-request run.  Then the chaos grid's two hybrid storm cells,
   ``hymba-1.5b/dense/storm4`` and ``/paged:8/storm4``, through 4g's
   ``chaos_main_path``: nothing lost, and each cell's deterministic view
   (but the tokens) equal to the same cell at reduced width on the CPU.
   The flash and ``decode_loop`` launches of the kernels line include
   this phase's;
4l. the planner (``plan/planner.py``), after 4k.  On rwkv6-1.6b, built
   anew at full width: the planner's two times (``HOST_SYNC_S``: a
   1-tick graph chunk at B=4 less a tick of an 8-tick chunk;
   ``COMPILE_S``: the first prefill at a (rows, length) no phase has run
   less a warm call; medians of 7).  ``autotune`` of the FCFS overload
   cell's workload (reduced probes, as the JAX package's
   ``autotuned_overload_cell``) on the card's graph engines, then the
   same call with ``device="cpu"``: the plans equal; its seconds, probes,
   capture seconds and winner logged.  The winner served at full width
   through ``drive`` (``.../auto``): counters = nodes x ticks, every
   cache leaf at its address, the deterministic view (stamps,
   ``stats()``, utilization, tick-domain aggregate) equal to the same
   plan at reduced width on the CPU; its SLO beside 4e's edf+p cell.
   The drift pair of ``benchmarks/serving_load.py``: the plan autotuned
   on the calm profile (card = CPU) serves the drifted traffic at full
   width with a ``Tracer`` (view and trace bytes = the reduced CPU
   run's), ``autotune_from_trace`` of that trace (card = the same
   pipeline on the CPU), the replan served at full width (view = CPU);
   the replan's ``max_batch`` and SLO attainment above the stale plan's.
   Inside 4k, on its hymba-1.5b tree: ``autotune`` of the base profile at
   rate 1.0 (``max_batches`` 2, 4, 8), the plan valid with an
   ``"attn"`` entry and a persistent ``"swa_ssm"`` entry with its
   evidence, its layout's modeled bytes logged; served at full width:
   flash counters 32 x prefill calls and 32 x decode ticks, the wrappers'
   bq/bk and decode chunk the planned tiles made legal, the view = CPU;
   then the plan with an ``attn`` entry of bq 128 / bk 32 at max_len 128
   (buckets 16 and 127) on four requests: its launches at those tiles
   made legal, and both the prefill's and the decode's tiles other than
   the defaults' made legal (at max_len 64 the planned entry and the
   defaults give the same tiles).
   The ``rwkv6_step``, flash and ``decode_loop`` launches of the kernels
   line include the served cells';
5. every launch counter > 0; one ``{"kernels": [...]}`` line
   (``matmul_w8a16``: the mean call of a decode layer; ``matmul_w8a16_
   prefill``: of a 4 x 512 prefill layer);
6. last line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``, the whole log to
``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Kernel vs plain version on the card.  Both sum exact bf16 x int8/bf16
# products in f32, in different orders; a last-bit difference in h can
# flip one bf16 ulp of y (2^-8 relative, |y| < 1) and feeds the next step.
ATOL = 2e-2
REPS_KERNEL = 7
REPS_PLAIN = 3
# The streaming input projection against xproj_ref: the same exact bf16
# products summed in f32 (on tensor cores) in another order, over up to
# 2560 terms of either sign: within 1e-4 of the largest |zx|.
XPROJ_REL = 1e-4
# The JAX package's reference tables name the Pallas function each CUDA
# kernel replaces.
REPLACES = {"lstm": "src/repro/kernels/fused_rnn/fused_rnn.py:238",
            "gru": "src/repro/kernels/fused_rnn/fused_rnn.py:299",
            "rwkv6_step": "src/repro/kernels/rwkv_step/rwkv_step.py:65",
            "flash_attention":
                "src/repro/kernels/flash_attention/flash_attention.py:136",
            "flash_decode":
                "src/repro/kernels/flash_attention/flash_decode.py:71",
            "matmul_w8a16":
                "src/repro/kernels/matmul_int8/matmul_int8.py:63"}
# the decode loop's control kernel replaces no Pallas kernel: it is the
# JAX engine's loop-body epilogue and cond, fused by XLA into its jitted
# lax.while_loop
REPLACES["decode_loop"] = "src/repro/serving/engine.py:195"
LOOP_SOURCE = "src/repro_torch/csrc/decode_loop.cu"
SOURCE = "src/repro_torch/csrc/fused_rnn.cu"
RWKV_SOURCE = "src/repro_torch/csrc/rwkv_step.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
MM_SOURCE = "src/repro_torch/csrc/matmul_int8.cu"
# matmul_w8a16 vs its plain version: the same exact bf16 x int8 products
# summed in f32 in another order, one rounding to bf16: a bf16 ulp of the
# largest output (2^-8) plus the f32 order difference.
MM_REL = 1e-2
# Cold-weight timings rotate over copies of the operands past this many
# bytes (the H100's L2 holds 50 MB), as in a tick, where each layer's
# weight is read once.
ROTATE_BYTES = 60_000_000
# cuBLAS's kernels in a profiler trace, by name
CUBLAS_MARKS = ("gemv", "gemm", "cublas", "cutlass", "xmma", "splitkreduce",
                "nvjet")
# int8 against bf16 weights through the whole LM, relative to the largest
# logit: the bound tests/test_int8_serving.py holds the JAX package to.
INT8_VS_BF16 = 0.15
# qwen2.5-14b's projections at decode: (name, K, N), 7 launches a layer
QWEN_PROJ = (("wq", 5120, 5120), ("wk", 5120, 1024), ("wv", 5120, 1024),
             ("wo", 5120, 5120), ("w_gate", 5120, 13824),
             ("w_up", 5120, 13824), ("w_down", 13824, 5120))
# flash_attention / flash_decode vs their plain versions: the same f32
# scores, exponentials and sums in another order (tensor-core sums for
# the prefill), so one bf16 ulp of p or of the output may flip.
FLASH_TOL = (2e-2, 2e-2)           # atol, rtol
# qwen2.5-14b kernel vs plain path, as for rwkv6 above: one decode step
# (or the prefill) from the same cache within 4e-2 of the largest
# magnitude; each path on its own cache for 31 steps, a gross-error guard.
# The plain decode path normalises p before rounding it to bf16, the
# kernel (like the TPU kernel) rounds the unnormalised p, so the two
# differ by bf16 ulps by construction.
QWEN_MAX_LEN = 1024
QWEN_ZERO_INIT = {"bq": 0.5, "bk": 0.5, "bv": 0.5}   # leaf: noise std
QWEN_PRE_LEN = [512, 400, 300, 17]   # the timed 4-row prefill at bucket 512
# rwkv6_step vs its plain version: the same f32 recurrence in another sum
# order (and with fused multiply-adds), so the state agrees to 1e-4 of
# its magnitude; y is bf16, where that can flip one ulp (2^-8 relative).
RWKV_STATE_REL = 1e-4
RWKV_Y_TOL = (2e-2, 2e-2)          # atol, rtol
# Kernel vs plain path through the whole LM, one decode step from the same
# cache: activations are rounded to bf16 at the same places, so the
# one-ulp flips above propagate through 24 layers; held relative to the
# largest magnitude, as the CPU parity tests hold the port to the JAX
# package.
LM_REL = 4e-2
# The same comparison with each path carrying its own cache over 31
# steps: the flips compound through the state (decays up to 0.9975 a
# step) and the random weights amplify them: on an H100 they reached
# 4.2e-2 (logits) and 5.3e-2 (state).  A kernel that dropped the bonus or
# misapplied the decay is off by O(1), hence this guard.
LM_CHAIN_GUARD = 0.25
ZERO_INIT = ("bonus", "mu", "mu_base", "mu_ck", "mu_cr", "ln1", "ln2",
             "wkv_norm")


LOG_FILE = []    # the run's log, in full, once the card is found


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG_FILE:
        print(msg, file=f, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median ms of one ``fn()`` call between CUDA events, after a warm-up."""
    import torch

    fn()
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


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def operands(cell, H, D, B, T, wdtype, device, seed):
    """Random kernel operands on the card, from a seed."""
    import torch

    G = 4 if cell == "lstm" else 3
    gen = torch.Generator().manual_seed(seed)
    s = (H + D) ** -0.5

    def w(rows):
        if wdtype == torch.int8:
            return torch.randint(-127, 128, (rows, G, H), generator=gen,
                                 dtype=torch.int8)
        return (torch.rand((rows, G, H), generator=gen) * 2 * s - s).to(
            torch.bfloat16)

    scale = (s / 127 if wdtype == torch.int8 else 1.0)
    ops = dict(
        x=torch.randn((T, B, D), generator=gen).to(torch.bfloat16),
        w_x=w(D), w_h=w(H),
        s_x=torch.rand((G, H), generator=gen) * scale + scale / 2,
        s_h=torch.rand((G, H), generator=gen) * scale + scale / 2,
        b=torch.randn((G, H), generator=gen) * 0.1,
        b_h=torch.randn((G, H), generator=gen) * 0.1,
        h0=torch.randn((B, H), generator=gen) * 0.5,
        c0=torch.randn((B, H), generator=gen) * 0.5)
    return {k: v.to(device) for k, v in ops.items()}


def call(fr, cell, o, bh, persistent, plain=False):
    """(y, h_T, c_T or None) from the kernel wrapper or its plain version."""
    from repro_torch.kernels.fused_rnn import ref

    if cell == "lstm":
        if plain:
            return ref.fused_lstm_ref(o["x"], o["w_x"], o["w_h"], o["s_x"],
                                      o["s_h"], o["b"], o["h0"], o["c0"])
        return fr.fused_lstm(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"],
                             o["b"], o["h0"], o["c0"], bh=bh,
                             persistent=persistent)
    if plain:
        y, hT = ref.fused_gru_ref(o["x"], o["w_x"], o["w_h"], o["s_x"],
                                  o["s_h"], o["b"], o["b_h"], o["h0"])
    else:
        y, hT = fr.fused_gru(o["x"], o["w_x"], o["w_h"], o["s_x"], o["s_h"],
                             o["b"], o["b_h"], o["h0"], bh=bh,
                             persistent=persistent)
    return y, hT, None


def unaligned_copy(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary (the kernels' element-wise loads)."""
    import torch

    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    u = u.view(t.shape)
    u.copy_(t)
    assert u.data_ptr() % 16
    return u


def check_xproj(fr, dev) -> dict:
    """Phase 3: the streaming projection kernel against ``xproj_ref`` at
    ragged shapes (T*B off the row tiles, G*H off the 128-column tile,
    D != H, rows that defeat the TMA loads, bf16 weights, B > 4) and at
    the main path's gru-2560 and lstm-2048 shapes; three calls bit-equal.
    Then, at lstm-2048's K and N (M = 300) and at a ragged shape, every
    bm the tile chooser can pick gives the same bits, and x and w off a
    16-byte boundary (element-wise loads) give the bits of the aligned
    copies (TMA loads).  Returns the max abs error by counter name."""
    import torch

    from repro_torch.kernels.fused_rnn import ref

    errs = {"fused_lstm_xproj": 0.0, "fused_gru_xproj": 0.0}
    for i, (cell, H, D, B, T, wdt) in enumerate((
            ("gru", 96, 80, 5, 7, torch.int8),
            ("gru", 90, 75, 1, 3, torch.int8),
            ("lstm", 64, 200, 6, 5, torch.bfloat16),
            ("lstm", 512, 512, 4, 25, torch.int8),
            ("lstm", 2048, 2048, 1, 25, torch.int8),
            ("gru", 2560, 2560, 1, 375, torch.int8))):
        o = operands(cell, H, D, B, T, wdt, dev, seed=300 + i)
        runs = [fr.xproj(o["x"], o["w_x"], o["s_x"], o["b"]) for _ in range(3)]
        want = ref.xproj_ref(o["x"], o["w_x"], o["s_x"], o["b"])
        torch.cuda.synchronize()
        e = max_err(runs[0], want)
        top = float(want.abs().max())
        same = all(torch.equal(runs[0], r) for r in runs[1:])
        name = f"fused_{cell}_xproj"
        errs[name] = max(errs[name], e)
        G = runs[0].shape[2]
        tile = (fr.xproj_tile(T * B, G * H, D, torch.cuda.get_device_properties(
            dev).multi_processor_count) if wdt == torch.int8 else "mma.sync")
        log(f"[3] {name:22s} M=T*B={T * B} K={D} N={G * H} "
            f"{str(wdt)[6:]:8s} tile (bm, splits) {tile}: max|kernel-plain| "
            f"= {e:.3e} = {e / top:.2e} of max|zx| (limit {XPROJ_REL}); "
            f"three calls bit-equal: {same}")
        if not (e <= XPROJ_REL * top and same):
            raise AssertionError(f"{name} disagrees with its plain version")
    for cell, H, D, B, T in (("lstm", 2048, 2048, 4, 75),
                             ("gru", 96, 80, 5, 7)):
        o = operands(cell, H, D, B, T, torch.int8, dev, seed=320 + H)
        x, w, sx, b = o["x"], o["w_x"], o["s_x"], o["b"]
        xu, wu = unaligned_copy(x), unaligned_copy(w)
        want = ref.xproj_ref(x, w, sx, b)
        outs = {bm: fr.xproj(x, w, sx, b, bm=bm) for bm in fr.XPROJ_BMS}
        outs_u = {bm: fr.xproj(xu, wu, sx, b, bm=bm) for bm in fr.XPROJ_BMS}
        torch.cuda.synchronize()
        first = outs[fr.XPROJ_BMS[0]]
        same = all(torch.equal(first, z) for z in outs.values())
        same_u = all(torch.equal(outs[bm], outs_u[bm]) for bm in outs)
        e = max_err(first, want)
        top = float(want.abs().max())
        name = f"fused_{cell}_xproj"
        errs[name] = max(errs[name], e)
        log(f"[3] {name:22s} M={T * B} K={D} N={first.shape[2] * H}: every "
            f"bm {fr.XPROJ_BMS} bit-equal: {same}; unaligned x and w "
            f"bit-equal to aligned at every bm: {same_u}; max|kernel-plain| "
            f"{e / top:.2e} of max|zx|")
        if not (same and same_u and e <= XPROJ_REL * top):
            raise AssertionError(f"{name}: tiles or unaligned rows differ")
    return errs


def xproj_tile_sweep(fr, inputs, dev, smi) -> list:
    """Phase 4: the int8 projection at every (bm, splits) it runs, at each
    task's M = T (B = 1) and at M = 1, N and K: device µs of one call from
    a CUDA graph of 10, beside the tile ``xproj_tile`` picks (the data
    the chooser and ``core/dse.py``'s projection constants were fitted
    to)."""
    import torch

    from repro_torch.kernels.fused_rnn.ops import _weights_for_kernel

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sweep = []
    for task, cfg, w, x in inputs:
        wx, _, s_x, _ = _weights_for_kernel(cfg, w)
        N, K = cfg.n_gates * cfg.hidden, cfg.d
        nk = fr.xproj_k_steps(K)
        for M in sorted({x.shape[0], 1}, reverse=True):
            xm = x[:M]
            pick = fr.xproj_tile(M, N, K, sms)
            bms = [bm for bm in fr.XPROJ_BMS
                   if bm == fr.XPROJ_BMS[0] or bm // 2 < M]
            for bm in bms:
                for S in range(1, min(fr.XPROJ_MAX_SPLIT, nk) + 1):
                    us = graph_ms([lambda: fr.xproj(xm, wx, s_x, w["b"], bm=bm,
                                                    splits=S)] * 10) * 1e3
                    sweep.append(dict(task=task.name, M=M, N=N, K=K, bm=bm,
                                      splits=S, us=us,
                                      chosen=(bm, S) == pick))
            best = min((r for r in sweep if r["task"] == task.name
                        and r["M"] == M), key=lambda r: r["us"])
            chosen = next(r for r in sweep if r["task"] == task.name
                          and r["M"] == M and r["chosen"])
            log(f"[4] xproj sweep {task.name:16s} M={M:<5d} N={N} K={K}: "
                f"fastest (bm {best['bm']}, splits {best['splits']}) "
                f"{best['us']:.2f} us; chosen {pick} {chosen['us']:.2f} us; "
                + " ".join(f"{r['bm']}/{r['splits']}:{r['us']:.1f}"
                           for r in sweep if r["task"] == task.name
                           and r["M"] == M) + f" [{smi}]")
    return sweep


def stream_timings(fr, row, cfg, o, x, bh, dev, spec, smi) -> None:
    """Phase 4, a streaming row: the projection alone (device time from a
    CUDA graph, its plain version, ``torch.matmul`` on bf16 weights made
    beforehand as the yardstick, its bound), the steps alone on its zx
    (CUDA events, host in) with programmatic dependent launch on and off
    and from a CUDA graph (host out), the step grid and whether the next
    step's CTAs fit beside this step's."""
    import torch

    from repro_torch.kernels.fused_rnn import ref

    T, B = x.shape[0], x.shape[1]
    G, H, D = cfg.n_gates, cfg.hidden, cfg.d
    wb = o["w_h"].element_size()
    row["xproj_ms"] = graph_ms(
        [lambda: fr.xproj(x, o["w_x"], o["s_x"], o["b"])] * 10)
    row["xproj_tile"] = list(fr.xproj_tile(
        T * B, G * H, D, torch.cuda.get_device_properties(
            dev).multi_processor_count))
    row["xproj_host_ms"] = host_ms(
        [lambda: fr.xproj(x, o["w_x"], o["s_x"], o["b"])])
    row["xproj_plain_ms"] = cuda_ms(
        lambda: ref.xproj_ref(x, o["w_x"], o["s_x"], o["b"]), REPS_PLAIN)
    xm = x.reshape(T * B, D).to(torch.bfloat16)
    wm = (o["w_x"].float() * o["s_x"][None]).reshape(D, G * H).to(
        torch.bfloat16)
    row["xproj_library_ms"] = graph_ms([lambda: torch.matmul(xm, wm)] * 10)
    row["xproj_bound_bytes_ms"] = (T * B * D * 2 + D * G * H * wb + 2 * G * H * 4
                                   + T * B * G * H * 4) / spec.hbm_bw * 1e3
    row["xproj_bound_ops_ms"] = 2.0 * T * B * D * G * H / spec.peak_bf16_flops * 1e3
    zx = fr.xproj(x, o["w_x"], o["s_x"], o["b"])
    if cfg.cell == "lstm":
        def steps():
            return fr.lstm_steps(zx, o["w_h"], o["s_h"], o["h0"], o["c0"],
                                 bh=bh)
    else:
        def steps():
            return fr.gru_steps(zx, o["w_h"], o["s_h"], o["b_h"], o["h0"],
                                bh=bh)
    row["steps_ms"] = cuda_ms(steps, REPS_KERNEL)
    fr.PDL = False
    try:
        row["steps_no_pdl_ms"] = cuda_ms(steps, REPS_KERNEL)
    finally:
        fr.PDL = True
    row["steps_graph_ms"] = graph_ms([steps])
    row["step_us"] = row["steps_ms"] / T * 1e3
    row["step_no_pdl_us"] = row["steps_no_pdl_ms"] / T * 1e3
    cs, ctas = fr.stream_geometry(G, H, bh, wb, dev)
    smem = fr.smem_bytes(G, D, H, bh, B, wb, False)
    per_sm = fr.stream_blocks_per_sm(G, wb, B, smem, dev)
    row.update(cluster=cs, ctas=ctas, smem=smem, blocks_per_sm=per_sm,
               pdl_coresident=per_sm >= 2 and ctas <= spec.sms,
               pdl_gain_us=row["step_no_pdl_us"] - row["step_us"],
               wh_rate_tbs=G * H * H * wb / (row["step_us"] * 1e-6) / 1e12)
    log(f"[4] {row['task']:16s} streaming: xproj {row['xproj_ms'] * 1e3:.2f} "
        f"us (plain {row['xproj_plain_ms'] * 1e3:.1f}, torch.matmul bf16 "
        f"{row['xproj_library_ms'] * 1e3:.2f}, bound "
        f"{max(row['xproj_bound_bytes_ms'], row['xproj_bound_ops_ms']) * 1e3:.2f}; "
        f"tile (bm, splits) {tuple(row['xproj_tile'])}, host "
        f"{row['xproj_host_ms'] * 1e3:.2f} us a call) "
        f"| steps {row['steps_ms']:.4f} ms = {row['step_us']:.3f} us a step "
        f"(PDL off {row['step_no_pdl_us']:.3f}; from a CUDA graph "
        f"{row['steps_graph_ms'] / T * 1e3:.3f}; W_h at "
        f"{row['wh_rate_tbs']:.3f} TB/s) | grid {cs} x {H // bh} = {ctas} "
        f"CTAs, {smem} B smem, {per_sm} CTAs/SM, next step co-resident: "
        f"{row['pdl_coresident']} | W_h bound {row['wh_stream_ms']:.4f} ms "
        f"[{smi}]")


def stream_tile_sweep(fr, dse, inputs, dev, spec, smi) -> list:
    """Phase 4: the step kernel at every streaming tile the DSE scores, for
    each task with H >= 1024: device µs a step from a CUDA graph of up to
    100 steps (host out), beside the grid and the DSE's modelled step (the
    data ``core/dse.py``'s streaming constants were fitted to)."""
    import torch

    from repro_torch.kernels.fused_rnn.ops import _weights_for_kernel

    sweep = []
    for task, cfg, w, x in inputs:
        if cfg.hidden < 1024:
            continue
        T = min(x.shape[0], 100)
        wx, wh, s_x, s_h = _weights_for_kernel(cfg, w)
        zx = fr.xproj(x[:T], wx, s_x, w["b"])
        h0 = torch.zeros((1, cfg.hidden), device=dev)
        best = dse.best_plan(cfg, spec).bh
        for plan in dse.search(cfg, spec):
            bh = plan.bh
            if cfg.cell == "lstm":
                def steps():
                    return fr.lstm_steps(zx, wh, s_h, h0, h0, bh=bh)
            else:
                def steps():
                    return fr.gru_steps(zx, wh, s_h, w["b_h"], h0, bh=bh)
            us = graph_ms([steps]) / T * 1e3
            cs, ctas = fr.stream_geometry(cfg.n_gates, cfg.hidden, bh, 1, dev)
            sweep.append(dict(task=task.name, bh=bh, cluster=cs, ctas=ctas,
                              step_us=us, model_us=plan.step_latency_s * 1e6,
                              chosen=bh == best))
            log(f"[4] tile sweep {task.name:16s} bh={bh:<5d} {cs} x "
                f"{cfg.hidden // bh:<4d} = {ctas:3d} CTAs: {us:7.3f} us a step "
                f"(graph), dse model {plan.step_latency_s * 1e6:7.3f} us"
                f"{' <- chosen' if bh == best else ''} [{smi}]")
    return sweep


def traced_ms(fn, marks, tries: int = 3) -> float:
    """Device ms of the kernels named by ``marks`` in one ``fn()``
    (``torch.profiler``), traced again where the trace lost them."""
    for _ in range(tries):
        ms = kernel_ms(device_busy(fn, 1.0), marks)
        if ms > 0:
            return ms
    raise AssertionError(f"no {marks} kernel in {tries} traces")


def persist_timings(fr, row, cfg, o, x, bh, dev, smi) -> None:
    """Phase 4, a persistent row: the device time of the projection and of
    the persistent launch in one call (``torch.profiler``), the persistent
    launch's µs a step (its slice copy included), its grid, and the host
    time of a call."""
    G, H, T = cfg.n_gates, cfg.hidden, x.shape[0]
    wb = o["w_h"].element_size()
    busy = device_busy(lambda: call(fr, cfg.cell, o, bh, True), 1.0)
    row["persist_kernel_ms"] = traced_ms(
        lambda: call(fr, cfg.cell, o, bh, True), ("rnn_persistent_kernel",))
    row["xproj_ms"] = kernel_ms(busy, ("xproj_kernel",))
    row["call_device_ms"] = busy["busy_ms"]
    row["step_us"] = row["persist_kernel_ms"] / T * 1e3
    row["host_ms"] = host_ms([lambda: call(fr, cfg.cell, o, bh, True)], 50)
    cs = fr.persist_geometry_on_card(G, H, bh, wb, dev)
    row.update(cluster=cs, ctas=cs * (H // bh),
               smem=fr.persist_smem_bytes(G, H, bh, cs, x.shape[1], wb))
    log(f"[4] {row['task']:16s} persistent: xproj {row['xproj_ms'] * 1e3:.2f} "
        f"us, persistent launch {row['persist_kernel_ms'] * 1e3:.2f} us = "
        f"{row['step_us']:.3f} us a step; the call's kernels "
        f"{row['call_device_ms'] * 1e3:.2f} us on the device, host "
        f"{row['host_ms'] * 1e3:.1f} us a call | grid {cs} x {H // bh} = "
        f"{row['ctas']} CTAs, {row['smem']} B smem [{smi}]")


def persist_tile_sweep(fr, dse, inputs, dev, spec, smi) -> list:
    """Phase 4: the persistent kernel at every resident tile the DSE scores,
    for each task, on 100 steps of random input (1 step too, so that the
    slice copy comes apart from a step): device µs a step and of the copy
    (``torch.profiler``), beside the grid and the DSE's modelled step (the
    data ``core/dse.py``'s persistent constants were fitted to)."""
    import torch

    from repro_torch.kernels.fused_rnn.ops import _weights_for_kernel

    sweep = []
    gen = torch.Generator().manual_seed(13)
    for task, cfg, w, _ in inputs:
        wx, wh, s_x, s_h = _weights_for_kernel(cfg, w)
        x = torch.randn((100, 1, cfg.d), generator=gen).to(dev, torch.bfloat16)
        z = torch.zeros((1, cfg.hidden), device=dev)
        o = dict(x=x, w_x=wx, w_h=wh, s_x=s_x, s_h=s_h, b=w["b"],
                 b_h=w.get("b_h"), h0=z, c0=z)
        o1 = dict(o, x=x[:1])
        best = dse.best_plan(cfg, spec, persistent=True).bh
        for plan in dse.search(cfg, spec, persistent=True):
            bh = plan.bh
            k100, k1 = (traced_ms(lambda: call(fr, cfg.cell, oo, bh, True),
                                  ("rnn_persistent_kernel",))
                        for oo in (o, o1))
            step_us = (k100 - k1) / 99 * 1e3
            cs = fr.persist_geometry_on_card(cfg.n_gates, cfg.hidden, bh, 1,
                                             dev)
            sweep.append(dict(task=task.name, bh=bh, cluster=cs,
                              ctas=cs * (cfg.hidden // bh), step_us=step_us,
                              copy_us=k1 * 1e3 - step_us,
                              model_us=plan.step_latency_s * 1e6,
                              chosen=bh == best))
            log(f"[4] persistent sweep {task.name:16s} bh={bh:<4d} {cs} x "
                f"{cfg.hidden // bh:<4d} CTAs: {step_us:7.3f} us a step, "
                f"copy {sweep[-1]['copy_us']:7.2f} us, dse model "
                f"{plan.step_latency_s * 1e6:7.3f} us"
                f"{' <- chosen' if bh == best else ''} [{smi}]")
    return sweep


def kernel_name(cell: str, persistent: bool) -> str:
    return f"fused_{cell}" + ("_persistent" if persistent else "")


def library_module(cfg, w, device):
    """torch.nn.LSTM/GRU in bf16 holding the dequantized weights; LSTM
    gates permuted from (i, j, f, o) to PyTorch's (i, f, g, o)."""
    import torch

    from repro_torch.core.cells import dequantize_weights

    wd = dequantize_weights(w)
    H, D = cfg.hidden, cfg.d
    perm = [0, 2, 1, 3] if cfg.cell == "lstm" else [0, 1, 2]
    mod = (torch.nn.LSTM if cfg.cell == "lstm" else torch.nn.GRU)(D, H)
    with torch.no_grad():
        mod.weight_ih_l0.copy_(wd["w_x"][:, perm].permute(1, 2, 0)
                               .reshape(-1, D))
        mod.weight_hh_l0.copy_(wd["w_h"][:, perm].permute(1, 2, 0)
                               .reshape(-1, H))
        mod.bias_ih_l0.copy_(wd["b"][perm].reshape(-1))
        mod.bias_hh_l0.copy_(wd["b_h"][perm].reshape(-1) if "b_h" in wd
                             else torch.zeros(cfg.n_gates * H))
    # PyTorch keeps bf16 RNN weights unflattened, so cuDNN compacts them
    # in every call: that copy is part of the yardstick's time
    warnings.filterwarnings("ignore", message="RNN module weights are not")
    return mod.to(device=device, dtype=torch.bfloat16)


def rwkv_operands(T, B, H, K, V, device, seed):
    """Decode-path operand types on the card: bf16 r/k/v, f32 log-decays
    spanning the model's clip range exp(-e^3) .. exp(-e^-8), a nonzero
    bonus u and a nonzero state."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    f32 = lambda *s: torch.randn(s, generator=gen)
    w = -torch.exp(torch.rand((T, B, H, K), generator=gen) * 11.0 - 8.0)
    ops = [f32(T, B, H, K).to(torch.bfloat16), f32(T, B, H, K).to(
        torch.bfloat16), f32(T, B, H, V).to(torch.bfloat16), w,
        f32(H, K), f32(B, H, K, V)]
    return [t.to(device) for t in ops]


def check_rwkv6_step(rk, dev) -> float:
    """Phase 3 for ``rwkv6_step``: kernel vs plain version at the decode
    shape of rwkv6-1.6b and around it.  Returns the largest absolute
    error over y and the state."""
    import torch

    from repro_torch.kernels.rwkv_step import ref

    log(f"[3] rwkv6_step tolerance: state max|kernel-plain| <= "
        f"{RWKV_STATE_REL} x max|state| (same f32 recurrence, another sum "
        f"order); y (bf16) within atol {RWKV_Y_TOL[0]} + rtol "
        f"{RWKV_Y_TOL[1]} x |y| (one bf16 ulp may flip)")
    worst = 0.0
    shapes = [  # T, B, H, K, V, heads per CTA
        (1, 1, 32, 64, 64, 1),      # decode shape of rwkv6-1.6b at B=1
        (1, 4, 32, 64, 64, 1),      # the engine's B=4
        (1, 2, 32, 64, 64, 1),      # the fleet's b2 replicas (4i)
        (1, 8, 32, 64, 64, 1),      # the disagg cell's b8 decode replicas
        (16, 2, 32, 64, 64, 4),     # T > 1: the state carried in registers
        (3, 3, 4, 16, 16, 1),       # reduced rwkv6
        (1, 1, 32, 64, 64, 4),      # head tiles of 4 and 32 heads
        (1, 1, 32, 64, 64, 32),
        (2, 2, 32, 64, 64, 32),
    ]
    for i, (T, B, H, K, V, bh) in enumerate(shapes):
        o = rwkv_operands(T, B, H, K, V, dev, seed=300 + i)
        y, s = rk.rwkv6_step(*o, bh=bh)
        y_p, s_p = ref.rwkv6_step_ref(*o)
        torch.cuda.synchronize()
        e_y, e_s = max_err(y, y_p), max_err(s, s_p)
        s_scale = float(s_p.abs().max())
        y_ok = bool(((y.float() - y_p.float()).abs() <= RWKV_Y_TOL[0]
                     + RWKV_Y_TOL[1] * y_p.float().abs()).all())
        worst = max(worst, e_y, e_s)
        log(f"[3] rwkv6_step T={T} B={B} H={H} K={K} V={V} heads/CTA={bh}: "
            f"max|y-plain| = {e_y:.3e}, max|state-plain| = {e_s:.3e} "
            f"(max|state| {s_scale:.3g}, limit "
            f"{RWKV_STATE_REL * s_scale:.3e})")
        if not (y_ok and e_s <= RWKV_STATE_REL * s_scale):
            raise AssertionError("rwkv6_step disagrees with its plain version")
    # every head tile and column slab against the default geometry's bits
    for T, B, H, K, V in ((4, 2, 32, 64, 64), (3, 3, 4, 16, 16),
                          (2, 2, 4, 16, 64)):
        o = rwkv_operands(T, B, H, K, V, dev, seed=399)
        y1, s1 = rk.rwkv6_step(*o)
        geo = rk.geometry(B, H, K, V, 1, rk._sms(dev.index or 0))
        ok = []
        for bh in sorted({1, 4, H}):
            for bv in rk._legal_bv(V):
                y, s = rk.rwkv6_step(*o, bh=bh, bv=bv)
                ok.append(bool(torch.equal(y, y1) and torch.equal(s, s1)))
        log(f"[3] rwkv6_step T={T} B={B} H={H} K={K} V={V}: heads/CTA 1, 4, "
            f"{H} x slabs {rk._legal_bv(V)} bit-equal to the default "
            f"(bv={geo.bv}, {geo.ctas} CTAs): {sum(ok)}/{len(ok)}")
        if not all(ok):
            raise AssertionError("rwkv6_step head tiles or slabs differ")
    # in place (out=state, as the engine's decode step calls it): the
    # out-of-place bits at every head tile and column slab
    for T, B, H, K, V in ((1, 4, 32, 64, 64), (1, 1, 32, 64, 64),
                          (1, 2, 32, 64, 64), (1, 8, 32, 64, 64),
                          (3, 3, 4, 16, 16)):
        o = rwkv_operands(T, B, H, K, V, dev, seed=398)
        ok = []
        for bh in sorted({1, 4, H}):
            for bv in rk._legal_bv(V):
                y0, s0 = rk.rwkv6_step(*o, bh=bh, bv=bv)
                st = o[5].clone()
                y1, s1 = rk.rwkv6_step(*o[:5], st, bh=bh, bv=bv, out=st)
                ok.append(bool(torch.equal(y0, y1) and torch.equal(s0, s1)
                               and s1.data_ptr() == st.data_ptr()))
        log(f"[3] rwkv6_step T={T} B={B} H={H} K={K} V={V} in place "
            f"(out=state): bit-equal to out of place at every head tile x "
            f"slab: {sum(ok)}/{len(ok)}")
        if not all(ok):
            raise AssertionError("rwkv6_step in place differs")
    return worst


def perturb_zero_init(params, gen) -> None:
    """Seeded noise on the leaves that start at zero (norm scales, mu*,
    bonus), in place, so the kernel's bonus term and the norm scales do
    work."""
    for name in ZERO_INIT:
        t = params["blocks"]["p0"][name]
        t.normal_(0.0, 0.5 if name == "bonus" else 0.1, generator=gen)
    params["final_norm"].normal_(0.0, 0.1, generator=gen)


def events_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn`` back to back, divided by ``inner``; after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fns, reps: int = 7) -> float:
    """Device time of one call: the calls ``fns`` (one launch each, on
    distinct operands) captured once in a ``torch.cuda.CUDAGraph`` after a
    warm-up, the graph replayed ``reps`` times between CUDA events; the
    median replay over ``len(fns)``.  The host's cost is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for f in fns:
            f()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(fns))
    del g
    return statistics.median(times)


def host_ms(fns, calls: int = 1000) -> float:
    """Host time of one call: wall clock over ``calls`` calls cycling
    through ``fns``, with no synchronize inside (one before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fns[i % len(fns)]()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e3


def copies_for(nbytes: int) -> int:
    """Distinct copies of an operand of ``nbytes`` that rotate past
    ``ROTATE_BYTES``, so each launch reads device memory, not L2."""
    return max(2, -(-ROTATE_BYTES // nbytes))


def device_busy(fn, tick_ms: float) -> dict:
    """What one ``fn()`` puts on the device, from ``torch.profiler``
    (after a warm-up): its activities (kernels, copies, fills), their
    summed time and its share of ``tick_ms``, the union of their
    intervals and the span they cover, and ``launched``, the kernels
    alone (neither a copy nor a fill)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA]
    except RuntimeError as err:   # no device tracing here: not measured
        log(f"torch.profiler failed ({err}); busy share not measured")
        kern = []
    by_name: dict = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    # the device's own view: the union of the kernels' intervals over the
    # span from the first kernel's start to the last one's end (kernels
    # that overlap, as programmatic dependent launches do, count once)
    union_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if end is None or a > end:
            union_us, end = union_us + (b - a), b
        elif b > end:
            union_us, end = union_us + (b - end), b
    span_us = (max(e.time_range.end for e in kern)
               - min(e.time_range.start for e in kern)) if kern else 0.0
    launched = sum(1 for e in kern
                   if not e.name.startswith(("Memcpy", "Memset")))
    return dict(kernels=len(kern), launched=launched, busy_ms=busy_ms,
                busy_share=busy_ms / tick_ms, top=top, by_name=by_name,
                union_ms=union_us / 1e3, span_ms=span_us / 1e3,
                span_share=union_us / span_us if span_us else 0.0)


def kernel_ms(busy: dict, marks) -> float:
    """Device ms of the kernels in ``busy["by_name"]`` whose name holds
    one of ``marks`` (lower case)."""
    return sum(us for name, us in busy.get("by_name", {}).items()
               if any(m in name.lower() for m in marks)) / 1e3


def loop_state(B, k, max_len, seed, device, *, n, limit, stop):
    """Random decode-loop buffers at tick n (sampled, lengths, inp, out,
    ctl): slots active or not, EOS ids that the sampled tokens hit,
    lengths at the cache's end, budgets spent or not."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    V = 12
    sampled = rng.integers(0, V, B)
    inp = np.concatenate([
        rng.integers(0, V, B), rng.integers(0, 2, B),
        np.where(rng.random(B) < 0.4, sampled, rng.integers(-1, V, B)),
        rng.integers(-1, 4, B), [limit, stop]])
    out = np.zeros(1 + 3 * k * B)
    out[0] = n
    out[1:1 + 3 * n * B] = rng.integers(0, 2, 3 * n * B)
    lengths = np.where(rng.random(B) < 0.3, max_len - 1,
                       rng.integers(1, max_len - 1, B))
    ctl = np.array([rng.integers(0, 2), 1])
    return [torch.from_numpy(np.asarray(a, np.int32)).to(device)
            for a in (sampled, lengths, inp, out, ctl)]


def check_decode_loop(dl, dev, spec) -> dict:
    """Phase 3 for the decode loop's control kernel: bit-equal to its
    plain version on random states at B 1, 4 and 16, at every tick of a
    4-tick chunk with the limit before, at and past it, stop_on_free on
    and off, EOS hits, full caches and spent budgets, and the init form.
    Then its time at the engine's B=4 (a graph of 24 launches), the plain
    version's and its bound."""
    import torch

    from repro_torch.kernels.decode_loop import ref

    k, max_len, cases, bad = 4, 1024, 0, 0
    for B in (1, 4, 16):
        for n in range(k):
            for limit in (n, n + 1, k):
                for stop in (0, 1):
                    cases += 1
                    got = loop_state(B, k, max_len, 7000 + cases, dev, n=n,
                                     limit=limit, stop=stop)
                    want = [t.clone() for t in got]
                    dl.epilogue(*got, k=k, max_len=max_len)
                    ref.epilogue_plain(*want, k=k, max_len=max_len)
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    dl.epilogue(None, None, *got[2:], k=k, max_len=max_len,
                                init=True)
                    ref.init_plain(*want[2:], B=B, k=k)
                    same = same and all(torch.equal(a, b)
                                        for a, b in zip(got, want))
                    bad += not same
    torch.cuda.synchronize()
    log(f"[3] decode_loop: the control kernel bit-equal to its plain "
        f"version on {cases - bad}/{cases} random states (B 1, 4, 16; every "
        f"tick of a {k}-tick chunk; limit before, at and past it; "
        f"stop_on_free on and off; EOS, full caches, spent budgets), then "
        f"the init form")
    if bad:
        raise AssertionError("decode_loop disagrees with its plain version")
    B = 4
    bufs = loop_state(B, k, max_len, 7999, dev, n=0, limit=k, stop=0)
    out = dict(max_abs_err=0.0)
    out["ms"] = graph_ms([lambda: dl.epilogue(*bufs, k=k, max_len=max_len)]
                         * 24)
    out["plain_ms"] = events_ms(
        lambda: ref.epilogue_plain(*bufs, k=k, max_len=max_len), 7, inner=20)
    # least work: sampled, lengths and inp read, tokens, active, remaining,
    # a row of toks/acts/dones, n and ctl written; no arithmetic to speak of
    nbytes = 4 * ((2 + 4) * B + 2 + 2 + 1 + 3 * B + 3 * B + 1 + 2)
    out["bound_ms"] = nbytes / spec.hbm_bw * 1e3
    out["bound_by"] = "bytes"
    log(f"[3] decode_loop at B={B}: {out['ms'] * 1e3:.3f} us a launch from a "
        f"graph of 24 (plain version {out['plain_ms'] * 1e3:.2f} us, about "
        f"a dozen launches; bound {out['bound_ms'] * 1e6:.2f} ns by bytes)")
    return out


def attach_eager_reference(eng, only=None) -> dict:
    """Hold decode chunks of ``eng`` (a graph launch on the card) to the
    plain chunk function (``_decode_many``: the same tick in a Python
    loop, eager) run first on a copy of the engine's cache with the same
    inputs, an overlapped admission's first tokens (``first``) included:
    n, the token, active and done rows, the first tokens read back and
    the whole cache after the chunk must be bit-equal.  The reference's
    launches, counted by the wrappers, are a comparison and are taken
    back out of the counters, but each chunk's launches counted at the
    graph's launch (its kernel nodes, a tick's times the ticks the device
    ran) must equal them.  ``only(index, restored)``, if given, picks the
    chunks compared (``restored``: a snapshot was restored since the
    previous chunk); the others run unchecked.  Returns the running
    tallies (``after_restore``: the first chunks after a restore)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launches
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.serving.engine import _decode_many

    ref_cache = tree_map(torch.clone, eng.sm.cache)
    graph_run = eng._loop.run
    tally = dict(chunks=0, ticks=0, equal=0, same_launches=0, graph={},
                 eager={}, skipped=0, overlapped=0, after_restore=0,
                 after_restore_equal=0)
    seen = dict(index=0, resumes=eng.resumes)

    def run(tokens, active, eos, remaining, limit, stop_on_free,
            first=None):
        restored = eng.resumes != seen["resumes"]
        seen["resumes"] = eng.resumes
        index = seen["index"]
        seen["index"] += 1
        if only is not None and not only(index, restored):
            tally["skipped"] += 1
            return graph_run(tokens, active, eos, remaining, limit,
                             stop_on_free, first=first)
        tree_map(lambda a, b: a.copy_(b), ref_cache, eng.sm.cache)
        ref_tokens = np.array(tokens, copy=True)
        mark = launches.counters()
        want = _decode_many(eng.model, eng.sampler, eng.max_len,
                            eng.sync_every, eng.params, ref_cache,
                            ref_tokens, None, active, eos, remaining, limit,
                            stop_on_free, first=first)
        eager = launches.since(mark)
        launches.restore(mark)
        mark = launches.counters()
        got = graph_run(tokens, active, eos, remaining, limit, stop_on_free,
                        first=first)
        graph = launches.since(mark)
        same = got[0] == want[0] and all(
            (a == b).all() for a, b in zip(got[1:], want[3:])) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(eng.sm.cache),
                                              tree_leaves(ref_cache))) \
            and (np.asarray(tokens) == ref_tokens).all()
        tally["chunks"] += 1
        tally["ticks"] += got[0]
        tally["equal"] += bool(same)
        tally["same_launches"] += graph == eager
        tally["overlapped"] += first is not None
        if restored:
            tally["after_restore"] += 1
            tally["after_restore_equal"] += bool(same)
        for side, counts in (("graph", graph), ("eager", eager)):
            for key, n in counts.items():
                tally[side][key] = tally[side].get(key, 0) + n
        return got

    eng._loop.run = run
    return tally


def want_host_syncs(st) -> int:
    """One read a decode chunk, a synchronous prefill call and a
    preemption burst (an overlapped prefill's tokens ride on a chunk's)."""
    return (st["decode_chunks"] + st["prefill_calls"]
            - st["overlap_prefills"] + st["preempt_bursts"])


def check_graph_run(tag, eng, tally) -> None:
    """After a served run through ``attach_eager_reference``: one host
    read a chunk, a synchronous prefill and a preemption burst, every
    compared chunk equal to the eager one, and its launches (the graph's
    nodes times the ticks) the eager chunk's."""
    st = eng.stats()
    syncs = want_host_syncs(st)
    log(f"[{tag}] sync_every={eng.sync_every}: {st['decode_chunks']} decode "
        f"chunks as graph launches, {st['decode_ticks']} ticks; host_syncs "
        f"{st['host_syncs']} = {st['decode_chunks']} chunks + "
        f"{st['prefill_calls'] - st['overlap_prefills']} synchronous "
        f"prefills ({st['overlap_prefills']} overlapped) + "
        f"{st['preempt_bursts']} preemption bursts: "
        f"{st['host_syncs'] == syncs}; chunks bit-equal to the eager chunk "
        f"on a copy of the cache (n, tokens, acts, dones, first tokens, "
        f"cache): {tally['equal']}/{tally['chunks']} compared "
        f"({tally['skipped']} not compared, {tally['overlapped']} with "
        f"overlapped first tokens, {tally['after_restore_equal']}/"
        f"{tally['after_restore']} first chunks after a restore); launches "
        f"of the graph chunks (kernel nodes x ticks) {tally['graph']} equal "
        f"to the eager chunks' wrapper counts {tally['eager']} in "
        f"{tally['same_launches']}/{tally['chunks']}; a tick's nodes "
        f"{eng._loop.tick_nodes}; tick capture {eng._loop.capture_s:.2f} s")
    if st["host_syncs"] != syncs:
        raise AssertionError("host_syncs != decode chunks + synchronous "
                             "prefill calls + preemption bursts")
    if tally["equal"] != tally["chunks"] or tally["chunks"] + \
            tally["skipped"] != st["decode_chunks"] or tally["chunks"] < 1:
        raise AssertionError("a graph chunk differs from the eager chunk")
    if not tally["skipped"] and tally["ticks"] != st["decode_ticks"]:
        raise AssertionError("the compared chunks' ticks differ from the "
                             "engine's")
    if tally["after_restore_equal"] != tally["after_restore"]:
        raise AssertionError("a chunk after a restore differs from the "
                             "eager chunk")
    if tally["same_launches"] != tally["chunks"]:
        raise AssertionError("a graph chunk's launches differ from the "
                             "eager chunk's")


def watch_restores(eng) -> dict:
    """Count ``eng``'s restores and those that left the cache tree and
    every leaf's ``data_ptr`` as they were (the decode graph holds them)."""
    from repro_torch.models.params import tree_leaves

    rec = dict(n=0, in_place=0)
    real = eng.sm.restore

    def restore(slot, snap, req):
        cache = eng.sm.cache
        before = [t.data_ptr() for t in tree_leaves(cache)]
        real(slot, snap, req)
        rec["n"] += 1
        rec["in_place"] += bool(eng.sm.cache is cache and before == [
            t.data_ptr() for t in tree_leaves(eng.sm.cache)])

    eng.sm.restore = restore
    return rec


def watch_paged(eng) -> dict:
    """On a paged engine: the ``data_ptr`` of every view leaf, pool leaf
    and flat index before the drive; CUDA events around every
    ``materialize`` (pool -> view, before each chunk and snapshot) and
    ``repage`` (view -> pool, after each chunk, insert and restore); the
    peak of ``bytes_resident`` (read at each of those calls and after
    each step, where admissions and releases have moved it); the pool
    invariants after every step; host seconds in each of those and in
    the cover and release bookkeeping (``host_s``)."""
    import torch

    from repro_torch.models.params import tree_leaves

    sm = eng.sm
    rec = dict(ptrs=[t.data_ptr() for t in tree_leaves(sm.cache)
                     + sm.tensors()],
               peak_bytes=sm.bytes_resident(), steps=0,
               events=dict(materialize=[], repage=[]),
               host_s=dict(materialize=0.0, repage=0.0, cover=0.0,
                           release=0.0, check=0.0))

    def timed(name, real):
        def call():
            t = time.perf_counter()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            real()
            b.record()
            rec["events"][name].append((a, b))
            rec["peak_bytes"] = max(rec["peak_bytes"], sm.bytes_resident())
            rec["host_s"][name] += time.perf_counter() - t
        return call

    def host_timed(name, real):
        def call(*a):
            t = time.perf_counter()
            try:
                return real(*a)
            finally:
                rec["host_s"][name] += time.perf_counter() - t
        return call

    sm.materialize = timed("materialize", sm.materialize)
    sm.repage = timed("repage", sm.repage)
    sm._cover = host_timed("cover", sm._cover)
    sm.release = host_timed("release", sm.release)
    step = eng.step

    def watched(*a, **k):
        busy = step(*a, **k)
        t = time.perf_counter()
        rec["peak_bytes"] = max(rec["peak_bytes"], sm.bytes_resident())
        sm.check_invariants()
        rec["host_s"]["check"] += time.perf_counter() - t
        rec["steps"] += 1
        return busy

    eng.step = watched
    return rec


def check_paged(tag, name, run, timings=False) -> dict:
    """After a drive through ``watch_paged``: every view, pool and index
    tensor at its address, the pool invariants, every block free again
    (capacity - 1 a pool), the peak of ``bytes_resident`` below the dense
    layout's; the materialize and repage times (ms a call, CUDA events
    around each call in the drive) and the host seconds of the paged
    bookkeeping.  With ``timings``, on the drained engine: each one's
    device time a call from a CUDA graph of 10 calls, its host time a
    call (200 calls) and its bound (the view's bytes read once and
    written once).  Raises on a failed check; returns the numbers."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.paged import PagedSlotManager

    eng, rec = run["eng"], run["paged"]
    sm = eng.sm
    same_ptrs = rec["ptrs"] == [t.data_ptr() for t in tree_leaves(sm.cache)
                                + sm.tensors()]
    sm.check_invariants()
    want_free = sum(p.capacity - 1 for p in sm._pools.values())
    ms = {k: [a.elapsed_time(b) for a, b in ev]
          for k, ev in rec["events"].items()}
    out = dict(same_ptrs=same_ptrs, steps=rec["steps"],
               blocks_free=sm.blocks_free(), capacity_free=want_free,
               peak_bytes_resident=rec["peak_bytes"],
               dense_bytes=sm._dense_cache_bytes,
               pools={s: dict(block=p.block, capacity=p.capacity)
                      for s, p in sm._pools.items()},
               view_mb=sum(t.numel() * t.element_size()
                           for t in tree_leaves(sm.cache)) / 1e6,
               pool_mb=sum(t.numel() * t.element_size()
                           for t in sm.tensors()) / 1e6)
    for k, xs in ms.items():
        out[f"{k}_calls"] = len(xs)
        out[f"{k}_ms"] = statistics.median(xs) if xs else None
        out[f"{k}_ms_max"] = max(xs) if xs else None
    out["host_s"] = dict(rec["host_s"])
    if timings:
        from repro_torch.hw import from_device

        spec = from_device(sm.cache["lengths"].device)
        for k in ("materialize", "repage"):
            fn = getattr(PagedSlotManager, k).__get__(sm)   # unwatched
            out[f"{k}_graph_ms"] = graph_ms([fn] * 10)
            out[f"{k}_host_ms"] = host_ms([fn], 200)
        out["bound_ms"] = 2 * out["view_mb"] * 1e6 / spec.hbm_bw * 1e3
        log(f"[{tag}] {name} paged, drained engine: materialize "
            f"{out['materialize_graph_ms']:.5f} ms a call from a CUDA graph "
            f"(host {out['materialize_host_ms']:.5f} ms a call), repage "
            f"{out['repage_graph_ms']:.5f} (host "
            f"{out['repage_host_ms']:.5f}); bound {out['bound_ms']:.5f} ms "
            f"(the view's bytes read once and written once)")
    log(f"[{tag}] {name} paged: view {out['view_mb']:.1f} MB, pools + "
        f"indices {out['pool_mb']:.1f} MB ({out['pools']}); every view, "
        f"pool and index tensor at its address over the drive: "
        f"{same_ptrs}; pool invariants after each of {rec['steps']} steps "
        f"and after the drive: True; blocks free {out['blocks_free']} = "
        f"capacity - 1 ({want_free}): {out['blocks_free'] == want_free}; "
        f"peak bytes_resident {rec['peak_bytes']} < dense "
        f"{out['dense_bytes']}: {rec['peak_bytes'] < out['dense_bytes']}; "
        f"materialize {out['materialize_calls']} calls, median "
        f"{out['materialize_ms']} ms (max {out['materialize_ms_max']}), "
        f"repage {out['repage_calls']} calls, median {out['repage_ms']} ms "
        f"(max {out['repage_ms_max']}) (CUDA events); host s in the "
        f"drive: {out['host_s']}")
    if not same_ptrs:
        raise AssertionError(f"{name}: a paged tensor moved")
    if out["blocks_free"] != want_free:
        raise AssertionError(f"{name}: blocks leaked after the drive")
    if not rec["peak_bytes"] < out["dense_bytes"]:
        raise AssertionError(f"{name}: paged bytes_resident reached the "
                             f"dense layout's")
    return out


def time_parts(eng) -> dict:
    """Host seconds inside ``eng``'s steps, its prefill calls
    (``_prefill_group``: the dispatch, plus the first tokens' read when
    the round is synchronous) and its decode chunks (``_loop.run``: the
    upload, the launch and the blocking read, so the chunk also waits
    there for device work queued before it, an overlapped prefill's)."""
    parts = dict(step_s=0.0, steps=0, prefill_s=0.0, prefills=0,
                 chunk_s=0.0, chunks=0)

    def timed(fn, key, n):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[key] += time.perf_counter() - t
                parts[n] += 1
        return call

    eng.step = timed(eng.step, "step_s", "steps")
    eng._prefill_group = timed(eng._prefill_group, "prefill_s", "prefills")
    eng._loop.run = timed(eng._loop.run, "chunk_s", "chunks")
    return parts


def prefill_costs(model, params, shapes, max_len) -> dict:
    """One prefill call at each (rows, S) of ``shapes`` on random tokens
    (every row full): ms with the host in (CUDA events, median of 5) and
    the device's busy ms and kernel count in one call (profiler)."""
    import torch

    out = {}
    for rows, S in sorted(shapes):
        batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (rows, S),
                                         dtype=torch.int32, device="cuda"),
                 "lengths": torch.full((rows,), S, dtype=torch.int32,
                                       device="cuda")}
        fn = lambda: model.prefill(params, batch, max_len=max_len)[1]
        ms = events_ms(fn, 5)
        bz = device_busy(fn, ms)
        out[f"{rows}x{S}"] = dict(ms=ms, busy_ms=bz["busy_ms"],
                                  kernels=bz["kernels"])
    return out


def serve_cell(model, params, plan, items, clock=None, reference=None,
               tracer=None):
    """One drive of ``items`` through a fresh engine built from ``plan``
    (``ServingEngine.from_plan``, with ``tracer`` if given), on a
    ``VirtualClock`` unless given, the host clock around ``drive``
    ending in a synchronize.  ``reference`` picks chunks held to the
    eager chunk (``attach_eager_reference``'s ``only``).  Returns a dict:
    eng, reqs, agg (``aggregate`` on the virtual clock's ticks), wall,
    tally, restores, clock, parts (``time_parts``), paged
    (``watch_paged`` on a paged engine, else None), kept (every cache
    leaf at its address after the drive)."""
    import torch

    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged import PagedSlotManager

    eng = ServingEngine.from_plan(plan, params, model=model, seed=0,
                                  tracer=tracer)
    ptrs = [t.data_ptr() for t in tree_leaves(eng.sm.cache)]
    parts = time_parts(eng)
    paged = watch_paged(eng) if isinstance(eng.sm, PagedSlotManager) \
        else None
    restores = watch_restores(eng)
    tally = attach_eager_reference(eng, only=reference) if reference \
        else None
    clock = clock if clock is not None else wl.VirtualClock()
    t = time.perf_counter()
    reqs = wl.drive(eng, items, clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if not all(r.done for r in reqs):
        raise AssertionError("a request of the cell was left unfinished")
    agg = smet.aggregate(reqs, ticks=eng.ticks,
                         util_history=eng.util_history)
    kept = ptrs == [t.data_ptr() for t in tree_leaves(eng.sm.cache)]
    return dict(eng=eng, reqs=reqs, agg=agg, wall=wall, tally=tally,
                restores=restores, clock=clock, parts=dict(parts),
                paged=paged, kept=kept)


def calibrate_tick_s(eng, vocab_size: int, seed: int = 0,
                     n_requests: int = 6) -> float:
    """A tick's wall cost on a warm engine: a closed-loop rerun (6
    requests of 4-12 tokens, 8 new tokens each, submitted at once), wall
    seconds / ticks."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 0x5EED)
    before = eng.ticks
    for _ in range(n_requests):
        n = int(rng.integers(4, 13))
        eng.submit([int(x) for x in rng.integers(0, vocab_size, n)],
                   max_new_tokens=8)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / max(1, eng.ticks - before)


def cell_stamps(reqs) -> list:
    return [(r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
             len(r.output), r.n_preempts, tuple(r.t_preempts),
             tuple(r.t_resumes)) for r in reqs]


def same_cell(tag, what, a, b) -> None:
    """Raises unless two runs of a cell gave the same tick stamps, the
    same utilization and an equal ``aggregate`` dict."""
    same = (cell_stamps(a["reqs"]) == cell_stamps(b["reqs"])
            and a["eng"].util_history == b["eng"].util_history
            and json.dumps(a["agg"], sort_keys=True)
            == json.dumps(b["agg"], sort_keys=True))
    log(f"[{tag}] {what}: the same tick stamps for every request, "
        f"utilization and aggregate dict: {same}")
    if not same:
        raise AssertionError(f"{tag}: {what} scheduled differently")


def parts_text(run) -> str:
    """``time_parts`` of a served run as text."""
    pt = run["parts"]
    rest = pt["step_s"] - pt["prefill_s"] - pt["chunk_s"]
    return (f"{pt['step_s']:.3f} s in {pt['steps']} steps: prefill calls "
            f"{pt['prefill_s']:.3f} s ({pt['prefills']}, "
            f"{1e3 * pt['prefill_s'] / max(1, pt['prefills']):.2f} ms "
            f"each), chunks {pt['chunk_s']:.3f} s ({pt['chunks']}, "
            f"{1e3 * pt['chunk_s'] / max(1, pt['chunks']):.2f} ms each), "
            f"the rest of the steps {rest:.3f} s; outside the steps "
            f"{run['wall'] - pt['step_s']:.3f} s")


def latency_line(agg, tick_s) -> tuple:
    """``scale_latencies`` of ``agg`` at ``tick_s`` and its log text."""
    from repro_torch.serving import metrics as smet

    sc = smet.scale_latencies(agg, tick_s)
    text = "; ".join(
        f"{k} p50/p95/p99 {sc[k + '_ms']['p50']:.2f} / "
        f"{sc[k + '_ms']['p95']:.2f} / {sc[k + '_ms']['p99']:.2f} ms"
        for k in ("queue_wait", "ttft", "tpot"))
    return sc, text


def open_loop_cell(tag, name, model, params, plain_plans, kernels, want,
                   smi, *, overlap_off=False, wall_clock=False) -> dict:
    """One serving cell of ``SERVING_LOAD_SWEEP`` at full width (the plan
    with ``reduced=False``, seed 0, duration 32 unless the cell has its
    own) through ``drive`` on a ``VirtualClock``:

    * the kernel path, the launch counters of ``kernels`` ((module,
      counter) pairs) set to 0 just before and read just after, equal to
      ``want(stats)``; ``host_syncs`` = chunks + synchronous prefills +
      preemption bursts; the first 4 chunks and every first chunk after
      a restore held bit-equal to the eager chunk; every restore in place;
      a preemptive cell must evict and resume every victim;
    * the plain path (``plain_plans``): no launch of those kernels, the
      same stamps and an equal aggregate;
    * timings: the kernel path again without a reference (wall seconds,
      tokens/s), then a tick calibrated on that warm engine (closed loop)
      and the aggregate's latencies scaled by it;
    * ``overlap_off``: the cell with ``overlap_prefill=False``: the same
      stamps and aggregate, one more read for each overlapped prefill;
    * ``wall_clock``: one drive on a ``WallClock``, its aggregate with
      tick_seconds = busy seconds / ticks."""
    import dataclasses

    from repro_torch.configs import serving_cell
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import workload as wl

    cell = serving_cell(name)
    plan = dataclasses.replace(cell.plan, reduced=False)
    duration = cell.duration if cell.duration is not None else 32.0
    items = wl.profile_items(cell.workload, vocab_size=model.cfg.vocab_size,
                             seed=0, duration=duration)
    t_cell = time.perf_counter()
    for mod, key in kernels:
        mod.LAUNCHES[key] = 0
    k = serve_cell(model, params, plan, items,
                   reference=lambda i, restored: i < 4 or restored)
    got = {key: mod.LAUNCHES[key] for mod, key in kernels}
    eng = k["eng"]
    st = eng.stats()
    exp = want(st)
    log(f"[{tag}] {name} ({plan.summary()}): {len(items)} requests over "
        f"{duration:g} clock units; engine {st}")
    log(f"[{tag}] {name}: launches {got} = {exp} from the decode ticks "
        f"({st['decode_ticks']}), chunks ({st['decode_chunks']}) and "
        f"prefill calls ({st['prefill_calls']}): {got == exp}")
    if got != exp or min(got.values()) <= 0:
        raise AssertionError(f"{name}: launches differ from nodes x ticks")
    check_graph_run(tag, eng, k["tally"])
    rs = k["restores"]
    victims = [r for r in k["reqs"] if r.n_preempts]
    log(f"[{tag}] {name}: {st['preemptions']} preemptions in "
        f"{st['preempt_bursts']} bursts over {len(victims)} requests, "
        f"{st['resumes']} resumes; every victim resumed as often as it was "
        f"evicted: {all(len(r.t_resumes) == r.n_preempts for r in victims)};"
        f" restores in place (cache tree and every leaf's data_ptr kept): "
        f"{rs['in_place']}/{rs['n']}")
    if rs["in_place"] != rs["n"] or rs["n"] != st["resumes"]:
        raise AssertionError(f"{name}: a restore rebound the cache")
    if any(len(r.t_resumes) != r.n_preempts for r in victims):
        raise AssertionError(f"{name}: a victim was not resumed")
    if plan.preempt and (st["preemptions"] < 1
                         or st["resumes"] != st["preemptions"]
                         or k["tally"]["after_restore"] < 1):
        raise AssertionError(f"{name}: the overload cell did not preempt "
                             f"and resume")
    paged = k["paged"] is not None
    if paged:
        check_paged(tag, f"{name} kernel path", k)
    capture_s, pool_mb = eng._loop.capture_s, eng._loop.pool_bytes / 1e6
    p = serve_cell(model, params,
                   dataclasses.replace(plan, tile_plans=plain_plans), items)
    plain_launches = {key: mod.LAUNCHES[key] for mod, key in kernels
                      if key != "decode_loop"}
    if plain_launches != {key: got[key] for key in plain_launches}:
        raise AssertionError(f"{name}: the plain path launched a kernel")
    same_cell(tag, f"{name} kernel vs plain path", k, p)
    if paged:
        check_paged(tag, f"{name} plain path", p)
    tok_eq = sum(a == b for x, y in zip(k["reqs"], p["reqs"])
                 for a, b in zip(x.output, y.output))
    out = dict(name=name, plan=plan.summary(), requests=len(items),
               stats=st, agg=k["agg"], launches=got,
               tokens_equal_plain=tok_eq,
               tokens=k["agg"]["tokens"], restores=rs["n"],
               reference_chunks=k["tally"]["chunks"],
               after_restore_chunks=k["tally"]["after_restore"],
               stamps=cell_stamps(k["reqs"]), util=k["eng"].util_history,
               capture_s=capture_s, graph_pool_mb=pool_mb)
    t = serve_cell(model, params, plan, items)
    runs = [k, p, t]        # their decode graphs are closed at the end
    same_cell(tag, f"{name} timed rerun", k, t)
    if paged:
        out["paged"] = check_paged(tag, f"{name} timed rerun", t,
                                   timings=True)
    out["wall_s"] = t["wall"]
    out["tokens_per_s"] = t["agg"]["tokens"] / t["wall"]
    out["parts"] = t["parts"]
    out["prefill"] = prefill_costs(model, params, t["eng"].prefill_shapes,
                                   plan.max_len)
    out["tick_s"] = calibrate_tick_s(t["eng"], model.cfg.vocab_size)
    out["calibrated"], text = latency_line(k["agg"], out["tick_s"])
    log(f"[{tag}] {name}: drive {out['wall_s']:.3f} s wall, "
        f"{out['tokens']} tokens = {out['tokens_per_s']:.1f} tokens/s (host "
        f"clock, virtual arrivals); {st['ticks']} ticks, mean util "
        f"{k['agg']['mean_util']:.3f}; greedy tokens equal to the plain "
        f"path's {tok_eq}/{out['tokens']}; calibrated tick "
        f"{out['tick_s'] * 1e3:.3f} ms (closed-loop rerun, wall / ticks): "
        f"{text} [{smi}]")
    log(f"[{tag}] {name}: where the drive's time went: {parts_text(t)}; "
        f"one prefill call a shape (ms with the host in, device busy ms, "
        f"kernels): {out['prefill']} [{smi}]")
    if "slo" in k["agg"]:
        log(f"[{tag}] {name}: slo {k['agg']['slo']}; preemption "
            f"{k['agg'].get('preemption')}")
    if overlap_off:
        o = serve_cell(model, params,
                       dataclasses.replace(plan, overlap_prefill=False),
                       items)
        so = o["eng"].stats()
        same_cell(tag, f"{name} with overlap_prefill off", k, o)
        more = so["host_syncs"] - st["host_syncs"]
        log(f"[{tag}] {name} overlap off: host_syncs {so['host_syncs']} "
            f"against {st['host_syncs']} with overlap ({more} more = "
            f"{st['overlap_prefills']} overlapped prefill calls: "
            f"{more == st['overlap_prefills']}; = chunks + prefill calls + "
            f"bursts: {so['host_syncs'] == want_host_syncs(so)})")
        if more != st["overlap_prefills"] or more <= 0 or \
                so["host_syncs"] != want_host_syncs(so):
            raise AssertionError(f"{name}: overlap off must read once more "
                                 f"for each overlapped prefill")
        o2 = serve_cell(model, params,
                        dataclasses.replace(plan, overlap_prefill=False),
                        items)
        runs += [o, o2]
        out["overlap_off"] = dict(stats=so, wall_s=o2["wall"],
                                  tokens_per_s=o2["agg"]["tokens"]
                                  / o2["wall"], parts=o2["parts"])
        out["overlap_off"]["tick_s"] = calibrate_tick_s(
            o2["eng"], model.cfg.vocab_size)
        out["overlap_off"]["calibrated"], text = latency_line(
            o["agg"], out["overlap_off"]["tick_s"])
        log(f"[{tag}] {name} overlap off: drive {o2['wall']:.3f} s wall "
            f"({parts_text(o2)}) = "
            f"{out['overlap_off']['tokens_per_s']:.1f} tokens/s; calibrated "
            f"tick {out['overlap_off']['tick_s'] * 1e3:.3f} ms: {text} "
            f"[{smi}]")
    if wall_clock:
        w = serve_cell(model, params, plan, items, clock=wl.WallClock())
        runs.append(w)
        ws = w["eng"].stats()
        busy = w["clock"].busy_seconds
        tick_s = busy / max(1, ws["ticks"])
        agg = smet.aggregate(w["reqs"], ticks=ws["ticks"],
                             util_history=w["eng"].util_history,
                             tick_seconds=tick_s)
        out["wall_clock"] = dict(agg=agg, stats=ws, wall_s=w["wall"],
                                 busy_s=busy, tick_s=tick_s,
                                 parts=w["parts"])
        log(f"[{tag}] {name} on a WallClock: {w['wall']:.3f} s wall, "
            f"{busy:.3f} s inside step ({parts_text(w)}) over "
            f"{ws['ticks']} ticks = "
            f"{tick_s * 1e3:.3f} ms a tick; {ws['host_syncs']} host syncs; "
            f"aggregate at that tick_seconds: queue_wait p50/p95/p99 "
            f"{agg['queue_wait']['p50'] * 1e3:.2f} / "
            f"{agg['queue_wait']['p95'] * 1e3:.2f} / "
            f"{agg['queue_wait']['p99'] * 1e3:.2f} ms, ttft "
            f"{agg['ttft']['p50'] * 1e3:.2f} / {agg['ttft']['p95'] * 1e3:.2f}"
            f" / {agg['ttft']['p99'] * 1e3:.2f} ms, tpot "
            f"{agg['tpot']['p50'] * 1e3:.2f} / {agg['tpot']['p95'] * 1e3:.2f}"
            f" / {agg['tpot']['p99'] * 1e3:.2f} ms, {agg['tokens_per_sec']:.1f}"
            f" tokens/s over the ticks [{smi}]")
    for run in runs:
        run["eng"]._loop.close()
    out["cell_s"] = time.perf_counter() - t_cell
    return out


# phase 4f: the paged cells of SERVING_LOAD_SWEEP, the b4 one the twin of
# the dense qwen2.5-14b/b4/r1
PAGED_CELLS = ("qwen2.5-14b/b4/r1/paged16",
               "qwen2.5-14b/b8/r1/lognormal/paged16",
               "qwen2.5-14b/b8/r1/bimodal/paged16")


def paged_main_path(model, params, plain_plans, kernels, want, dense, dev,
                    smi) -> dict:
    """Phase 4f: the three paged qwen2.5-14b cells at full width on phase
    4c's bf16 tree, each through ``open_loop_cell`` (kernel vs plain
    path, counters, host syncs, the first 4 chunks against the eager
    chunk on a copy of the view, timings) and ``check_paged`` (fixed
    addresses, pool invariants, every block freed, bytes_resident below
    dense; materialize and repage ms); the b4 twin's stamps, utilization
    and aggregate equal to ``dense`` (4c's qwen2.5-14b/b4/r1 run); the
    peak device memory of each cell, its engines freed before the next;
    then ``paged_dense_turns``."""
    import gc

    import torch

    t0 = time.perf_counter()
    out = {}
    for name in PAGED_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        cell = open_loop_cell("4f", name, model, params, plain_plans,
                              kernels, want, smi)
        cell["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        cell["peak_rise_gb"] = cell["peak_gb"] - base / 1e9
        pg = cell["paged"]
        log(f"[4f] {name}: peak device memory {cell['peak_gb']:.2f} GB "
            f"({cell['peak_rise_gb']:.3f} GB above the weights and what "
            f"came before); the kernel path's decode graph captured in "
            f"{cell['capture_s']:.2f} s, graph pool "
            f"{cell['graph_pool_mb']:.1f} MB; a chunk's materialize "
            f"{pg['materialize_ms']} ms and repage {pg['repage_ms']} ms "
            f"(medians, CUDA events) beside its chunk "
            f"{1e3 * cell['parts']['chunk_s'] / max(1, cell['parts']['chunks']):.2f}"
            f" ms (host clock); peak bytes_resident "
            f"{pg['peak_bytes_resident']} against dense {pg['dense_bytes']}"
            f" [{smi}]")
        if name.split("/")[1] == "b4":
            twin = (cell["stamps"] == dense["stamps"]
                    and cell["util"] == dense["util"]
                    and json.dumps(cell["agg"], sort_keys=True)
                    == json.dumps(dense["agg"], sort_keys=True))
            log(f"[4f] {name} against the dense {dense['name']} (4c): the "
                f"same tick stamps for every request, utilization and "
                f"aggregate dict: {twin}")
            if not twin:
                raise AssertionError(f"{name}: the paged twin scheduled "
                                     f"differently from the dense cell")
            cell["twin_of"] = dense["name"]
        out[name] = cell
    gc.collect()
    torch.cuda.empty_cache()
    out["turns"] = paged_dense_turns(model, params, PAGED_CELLS[0], smi)
    out["phase_s"] = time.perf_counter() - t0
    each = ", ".join(f"{out[n]['cell_s']:.1f}" for n in PAGED_CELLS)
    log(f"[4f] phase 4f: {out['phase_s']:.1f} s, three paged cells ({each}"
        f" s) [{smi}]")
    return out


def paged_dense_turns(model, params, name, smi, rounds: int = 1) -> dict:
    """The paged twin ``name`` and its dense cell driven in turns (dense,
    paged, paged, dense, ``rounds`` times), each a fresh engine without
    a reference: every drive's wall s and its parts (prefill calls,
    chunks, the rest of the steps), so that the two layouts' host-clock
    times compare within one call."""
    import dataclasses

    from repro_torch.configs import serving_cell
    from repro_torch.serving import workload as wl

    cell = serving_cell(name)
    paged = dataclasses.replace(cell.plan, reduced=False)
    dense = dataclasses.replace(paged, cache_layout="dense")
    items = wl.profile_items(cell.workload, vocab_size=model.cfg.vocab_size,
                             seed=0, duration=32.0)
    runs = {"dense": [], "paged": []}
    for layout in ("dense", "paged", "paged", "dense") * rounds:
        run = serve_cell(model, params, paged if layout == "paged" else dense,
                         items)
        pt = run["parts"]
        runs[layout].append(dict(
            wall_s=run["wall"],
            prefill_ms=1e3 * pt["prefill_s"] / max(1, pt["prefills"]),
            chunk_ms=1e3 * pt["chunk_s"] / max(1, pt["chunks"]),
            rest_s=pt["step_s"] - pt["prefill_s"] - pt["chunk_s"]))
        run["eng"]._loop.close()
    med = {lay: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for lay, rs in runs.items()}
    log(f"[4f] {name} against its dense cell, in turns (dense, paged, "
        f"paged, dense) x {rounds}: drive s dense "
        f"{[round(r['wall_s'], 3) for r in runs['dense']]}, paged "
        f"{[round(r['wall_s'], 3) for r in runs['paged']]}; medians dense "
        f"{ {k: round(v, 3) for k, v in med['dense'].items()} }, paged "
        f"{ {k: round(v, 3) for k, v in med['paged'].items()} } (prefill and "
        f"chunk ms a call, host clock) [{smi}]")
    return dict(runs=runs, medians=med)


def open_loop_main_path(rk, dev, smi) -> dict:
    """Phase 4e: the open-loop serving path at full width: rwkv6-1.6b
    (seeded random weights, the zero-initialised leaves perturbed as in
    4b) under its base cell (with overlap off and a wall-clock drive)
    and its overload cell with preemptive EDF."""
    from repro_torch.kernels.decode_loop import decode_loop as dl

    t0 = time.perf_counter()
    model, params = build_rwkv(dev)
    cfg = model.cfg
    kernels = ((rk, "rwkv6_step"), (dl, "decode_loop"))
    want = lambda st: {"rwkv6_step": cfg.n_layers * st["decode_ticks"],
                       "decode_loop": st["decode_ticks"]
                       + st["decode_chunks"]}
    plain = {"rwkv": {"impl": "plain"}}
    out = {"base": open_loop_cell("4e", "rwkv6-1.6b/b4/r1", model, params,
                                  plain, kernels, want, smi,
                                  overlap_off=True, wall_clock=True),
           "overload": open_loop_cell("4e", "rwkv6-1.6b/b4/r0.8/heavy/edf+p",
                                      model, params, plain, kernels, want,
                                      smi)}
    out["phase_s"] = time.perf_counter() - t0
    log(f"[4e] phase 4e: {out['phase_s']:.1f} s (the weights built, two "
        f"cells: {out['base']['cell_s']:.1f} s and "
        f"{out['overload']['cell_s']:.1f} s) [{smi}]")
    # phase 4g's rwkv6-1.6b storm cells, on this tree
    out["chaos"] = chaos_main_path("4g", model, params, kernels, want, smi)
    # phase 4h's rwkv6-1.6b traced drives, on this tree after 4g
    out["trace"] = trace_rwkv_main_path(model, params, out["chaos"], smi)
    # phase 4i's fleet cells, on this tree after 4h
    out["fleet"] = fleet_main_path(model, params, kernels, want, smi)
    return out


# phase 4g: the storm cells of the JAX chaos benchmark whose arch the port
# serves (its plan, workload and storm, copied as constants)
CHAOS_CELLS = {"rwkv6-1.6b": (("dense", 2), ("dense", 4), ("dense", 8),
                              ("paged:8", 4)),
               "qwen2.5-14b": (("dense", 4), ("paged:8", 4)),
               "hymba-1.5b": (("dense", 4), ("paged:8", 4))}
CHAOS_PLAN = dict(max_batch=4, max_len=64, retry_budget=3, watchdog_ticks=4)
CHAOS_WORKLOAD = dict(kind="poisson", rate=0.8, duration=32.0,
                      prompt_len=(4, 12), max_new_tokens=(6, 10),
                      deadline_slack=1.5)
CHAOS_CHECKPOINT_EVERY = 8


def watch_faulted(eng, rec) -> None:
    """On one engine of a faulted drive (the first, or one ``restore``
    built): after every step every cache, view, pool and index tensor at
    the address it had when the engine was built (the decode graph's),
    the decode loop's cache leaves the manager's, the pool invariants
    (paged); host seconds of each recovery snapshot (``_refresh_recovery``,
    its slots), guard scan and checkpoint save (and the step's bytes on
    disk)."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.paged import PagedSlotManager

    # no tensor is held here: a closed engine's cache must be freed
    paged = isinstance(eng.sm, PagedSlotManager)
    tensors = lambda: tree_leaves(eng.sm.cache) + (
        eng.sm.tensors() if paged else [])
    ptrs = [t.data_ptr() for t in tensors()]
    rec["col_bytes"] = sum(t.numel() * t.element_size()
                           for t in tree_leaves(eng.sm.column_template()))
    step = eng.step

    def watched(*a, **k):
        try:
            return step(*a, **k)
        finally:
            rec["steps"] += 1
            rec["moved"] += not (
                [t.data_ptr() for t in tensors()] == ptrs
                and all(x is y for x, y in zip(
                    tree_leaves(eng._loop.cache), tree_leaves(eng.sm.cache))))
            if paged:
                eng.sm.check_invariants()
                rec["invariant_checks"] += 1

    def timed(name, fn, nbytes):
        def call(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            rec[name].append((time.perf_counter() - t, nbytes(out, a, k)))
            return out
        return call

    def recovery(real):
        def call():
            n = len([i for i in eng.sm.occupied() if i not in eng._stalled])
            t = time.perf_counter()
            real()
            if n:
                rec["snapshot"].append((time.perf_counter() - t,
                                        n * rec["col_bytes"]))
        return call

    def ckpt_bytes(step, a, k):
        d = Path(a[0].directory) / f"step_{step:010d}"
        return sum(p.stat().st_size for p in d.iterdir())

    eng.step = watched
    eng._refresh_recovery = recovery(eng._refresh_recovery)
    scan = timed("scan", eng._scan_poisoned, lambda out, a, k: len(out))
    real_scan = eng._scan_poisoned
    # timed only where it scans (a poison outstanding in an occupied slot)
    eng._scan_poisoned = lambda idx: scan(idx) if any(
        eng.sm.slots[s] is not None for s in eng._poison_outstanding) \
        else real_scan(idx)
    eng.checkpoint = timed("checkpoint", eng.checkpoint, ckpt_bytes)
    rec["engines"].append(eng)


def chaos_drive(model, params, plan, items, storm, ckpt_dir, watch=False,
                tracer=None):
    """One ``drive_resilient`` of a storm cell on a fresh engine (seed 0,
    a checkpoint every 8 ticks into ``ckpt_dir``), the host clock around
    it ending in a synchronize.  ``watch``: every engine of the drive
    under ``watch_faulted``, and each engine ``restore`` builds timed
    (its construction, the decode graph's capture in it, the leaves'
    load) and its first chunk held to the eager chunk on a copy of its
    cache (``attach_eager_reference``).  ``tracer``: the first engine's
    (``drive_resilient`` hands it to a restored one).  Returns (report,
    record)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultInjector, drive_resilient
    from repro_torch.serving.workload import VirtualClock

    rec = dict(steps=0, moved=0, invariant_checks=0, snapshot=[], scan=[],
               checkpoint=[], engines=[], restores=[], tallies=[])
    eng = ServingEngine.from_plan(plan, params, model=model, seed=0,
                                  tracer=tracer)
    real_restore = ServingEngine.__dict__["restore"]
    if watch:
        watch_faulted(eng, rec)
        real_build = ServingEngine.__dict__["from_plan"]
        real_load = CheckpointManager.restore

        def restore(cls, manager, params, **kw):
            part = dict(build_s=0.0, load_s=0.0)

            def build(cls2, *a, **k):
                t = time.perf_counter()
                try:
                    return real_build.__func__(cls2, *a, **k)
                finally:
                    part["build_s"] += time.perf_counter() - t

            def load(self, *a, **k):
                t = time.perf_counter()
                try:
                    return real_load(self, *a, **k)
                finally:
                    part["load_s"] += time.perf_counter() - t
            t = time.perf_counter()
            ServingEngine.from_plan = classmethod(build)
            CheckpointManager.restore = load
            try:
                new = real_restore.__func__(cls, manager, params, **kw)
            finally:
                ServingEngine.from_plan = real_build
                CheckpointManager.restore = real_load
            torch.cuda.synchronize()
            part["total_s"] = time.perf_counter() - t
            part["capture_s"] = new._loop.capture_s
            part["graph"] = bool(new._loop.graph)
            part["own_graph"] = all(new._loop is not e._loop
                                    for e in rec["engines"])
            rec["restores"].append(part)
            watch_faulted(new, rec)
            rec["tallies"].append(attach_eager_reference(
                new, only=lambda i, restored: i == 0))
            return new

        ServingEngine.restore = classmethod(restore)
    t = time.perf_counter()
    try:
        rep = drive_resilient(eng, items, VirtualClock(),
                              injector=FaultInjector(storm),
                              manager=CheckpointManager(ckpt_dir),
                              checkpoint_every=CHAOS_CHECKPOINT_EVERY)
        torch.cuda.synchronize()
    finally:
        ServingEngine.restore = real_restore
    rec["wall"] = time.perf_counter() - t
    return rep, rec


def chaos_view(rep, tokens: bool = True) -> str:
    """A storm run's deterministic view as JSON: every request's stamps,
    retries and tokens (their count alone without ``tokens``), the fault
    events, ``fault_stats()``, restarts and ticks replayed, and
    ``aggregate``."""
    from repro_torch.serving import metrics as smet

    eng = rep.engine
    return json.dumps(dict(
        requests=[(r.uid, r.t_submit, r.t_admit, r.t_first, r.t_done,
                   r.done, r.shed, r.retries,
                   list(r.output) if tokens else len(r.output))
                  for r in rep.requests],
        events=rep.fault_events, faults=eng.fault_stats(),
        restarts=[rep.n_restarts, rep.restart_ticks_lost],
        agg=smet.aggregate(rep.requests, ticks=eng.ticks,
                           util_history=eng.util_history)), sort_keys=True)


def chaos_main_path(tag, model, params, kernels, want, smi,
                    cpu=None) -> dict:
    """Phase 4g for one arch, on an earlier phase's weight tree: each of
    its storm cells (``CHAOS_CELLS``) at full width under its seeded
    storm through ``drive_resilient``, twice; beside a fault-free
    ``drive`` of the same plan and workload.  Fatal checks: nothing
    lost; storm8 restarts once; the two runs' deterministic views
    byte-identical; every completed request the fault-free drive's
    tokens; every cache tensor at its address after every step of every
    engine; a restored engine on its own decode graph, its first chunk
    bit-equal to the eager chunk; paged, the invariants after every step
    and every block free after the drive; the launch counters (zeroed
    just before the first run) equal to the graph's nodes x the decode
    ticks and layers x the prefill calls, summed over the run's engines,
    restarts included.  With ``cpu`` = (model, params) at reduced width
    on the CPU: each cell's run there under the same plan, storm and
    items (prompt ids modulo the reduced vocabulary) has the same
    deterministic view but for the tokens themselves."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.plan.plan import ServingPlan, WorkloadProfile
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving import workload as wl
    from repro_torch.serving.faults import make_storm

    arch = model.cfg.name
    items = wl.profile_items(WorkloadProfile(**CHAOS_WORKLOAD),
                             vocab_size=model.cfg.vocab_size, seed=0)
    t_phase = time.perf_counter()
    base: dict = {}
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chaos_ckpt_"))
    try:
        for layout, n in CHAOS_CELLS[arch]:
            name = f"{arch}/{layout}/storm{n}"
            plan = ServingPlan(arch=arch, reduced=False,
                               cache_layout=layout, **CHAOS_PLAN).resolve()
            if layout not in base:        # the cell's fault-free drive
                eng = ServingEngine.from_plan(plan, params, model=model)
                t = time.perf_counter()
                reqs = wl.drive(eng, items, wl.VirtualClock())
                torch.cuda.synchronize()
                base[layout] = dict(wall=time.perf_counter() - t,
                                    tokens={r.uid: r.output for r in reqs})
                eng.close()
            storm = make_storm(duration=int(CHAOS_WORKLOAD["duration"]),
                               seed=n, n_faults=n,
                               max_batch=CHAOS_PLAN["max_batch"])
            for mod, key in kernels:
                mod.LAUNCHES[key] = 0
            rep, rec = chaos_drive(model, params, plan, items, storm,
                                   str(tmp / f"{layout}_{n}_a"), watch=True)
            got = {key: mod.LAUNCHES[key] for mod, key in kernels}
            runs = [eng.metrics.view({
                "decode_ticks": "engine.decode_ticks",
                "decode_chunks": "engine.decode_chunks",
                "prefill_calls": "engine.prefill_calls"})
                for eng in rec["engines"]]
            exp = {}
            for st in runs:
                for key, v in want(st).items():
                    exp[key] = exp.get(key, 0) + v
            view_a = chaos_view(rep)
            final = rep.engine
            paged = layout != "dense"
            blocks = None
            if paged:
                final.sm.check_invariants()
                blocks = (final.sm.blocks_free(),
                          sum(p.capacity - 1
                              for p in final.sm._pools.values()))
            fs = final.fault_stats()
            final.close()
            rep_b, rec_b = chaos_drive(model, params, plan, items, storm,
                                       str(tmp / f"{layout}_{n}_b"))
            view_b = chaos_view(rep_b)
            rep_b.engine.close()
            gc.collect()
            same_cpu = cpu_s = None
            if cpu is not None:
                small_model, small_params = cpu
                vocab = small_model.cfg.vocab_size
                small = [dataclasses.replace(it, prompt=tuple(
                    t % vocab for t in it.prompt)) for it in items]
                t = time.perf_counter()
                rep_c, _ = chaos_drive(
                    small_model, small_params,
                    dataclasses.replace(plan, reduced=True), small, storm,
                    str(tmp / f"{layout}_{n}_cpu"))
                cpu_s = time.perf_counter() - t
                same_cpu = chaos_view(rep, tokens=False) == chaos_view(
                    rep_c, tokens=False)
                log(f"[{tag}] {name}: the deterministic view (stamps, "
                    f"retries, token counts, events, fault stats, restarts, "
                    f"aggregate) equal to the same cell at reduced width on "
                    f"the CPU ({cpu_s:.1f} s there): {same_cpu}")
            lost = rep.lost_uids() + rep_b.lost_uids()
            clean = [r.uid for r in rep.completed
                     if r.output != base[layout]["tokens"][r.uid]]
            tallies = rec["tallies"]
            ms = lambda xs: (statistics.median(x[0] for x in xs) * 1e3
                             if xs else None)
            cell = dict(
                name=name, plan=plan.summary(), requests=len(items),
                storm=storm.to_dict(), faults=fs,
                restarts=rep.n_restarts,
                restart_ticks_lost=rep.restart_ticks_lost,
                completed=len(rep.completed), shed=len(rep.shed_uids),
                lost=lost, ticks=final.ticks, launches=got,
                want_launches=exp, engines=runs,
                wall_s=[rec["wall"], rec_b["wall"]],
                fault_free_wall_s=base[layout]["wall"],
                steps=rec["steps"], moved=rec["moved"],
                invariant_checks=rec["invariant_checks"],
                blocks_free=blocks, restores=rec["restores"],
                first_chunk_after_restore_equal=[
                    (t["equal"], t["chunks"], t["same_launches"])
                    for t in tallies],
                snapshot_calls=len(rec["snapshot"]),
                snapshot_ms=ms(rec["snapshot"]),
                snapshot_bytes=statistics.median(
                    x[1] for x in rec["snapshot"]) if rec["snapshot"]
                else None,
                snapshot_ms_max=max(x[0] for x in rec["snapshot"]) * 1e3
                if rec["snapshot"] else None,
                column_bytes=rec["col_bytes"],
                scan_calls=len(rec["scan"]), scan_ms=ms(rec["scan"]),
                checkpoint_calls=len(rec["checkpoint"]),
                checkpoint_ms=ms(rec["checkpoint"]),
                checkpoint_bytes=max(x[1] for x in rec["checkpoint"])
                if rec["checkpoint"] else None,
                same_views=view_a == view_b, not_fault_free_tokens=clean,
                same_as_cpu=same_cpu, cpu_s=cpu_s, view=view_a)
            log(f"[{tag}] {name} ({plan.summary()}): {len(items)} requests, "
                f"storm {[(f['kind'], f['tick'], f['slot']) for f in storm.to_dict()['faults']]}; "
                f"faults {fs}, {rep.n_restarts} restarts "
                f"({rep.restart_ticks_lost} ticks replayed), "
                f"{len(rep.completed)} completed, {len(rep.shed_uids)} shed, "
                f"lost {lost}; {final.ticks} ticks")
            log(f"[{tag}] {name}: drive {rec['wall']:.3f} s and "
                f"{rec_b['wall']:.3f} s (host clock) against the fault-free "
                f"drive's {base[layout]['wall']:.3f} s; two runs' "
                f"deterministic views byte-identical: {view_a == view_b}; "
                f"completed requests with the fault-free drive's tokens: "
                f"{len(rep.completed) - len(clean)}/{len(rep.completed)}; "
                f"launches {got} = nodes x ticks and layers x prefills over "
                f"{len(runs)} engine(s) {exp}: {got == exp}")
            log(f"[{tag}] {name}: every cache tensor at its address after "
                f"each of {rec['steps']} steps: {rec['moved'] == 0}; paged "
                f"invariants after {rec['invariant_checks']} steps; blocks "
                f"free after the drive {blocks}; recovery snapshot "
                f"{cell['snapshot_ms']} ms a chunk (median of "
                f"{cell['snapshot_calls']}, max {cell['snapshot_ms_max']}; "
                f"{cell['snapshot_bytes']} B, a slot column "
                f"{rec['col_bytes']} B); guard scan {cell['scan_ms']} ms "
                f"({cell['scan_calls']} calls); checkpoint save "
                f"{cell['checkpoint_ms']} ms (median of "
                f"{cell['checkpoint_calls']}, up to "
                f"{cell['checkpoint_bytes']} B on disk); restores "
                f"{rec['restores']}; a restored engine's first chunk "
                f"against the eager chunk (equal, compared, same launches) "
                f"{cell['first_chunk_after_restore_equal']} [{smi}]")
            if lost:
                raise AssertionError(f"{name}: requests lost {lost}")
            if n == 8 and rep.n_restarts != 1:
                raise AssertionError(f"{name}: storm8 must restart once")
            if view_a != view_b:
                raise AssertionError(f"{name}: two runs differ")
            if same_cpu is False:
                raise AssertionError(f"{name}: the card's run differs from "
                                     f"the reduced run on the CPU")
            if clean:
                raise AssertionError(f"{name}: requests {clean} completed "
                                     f"with other tokens than the fault-free "
                                     f"drive's")
            if rec["moved"] or rec["steps"] < 1:
                raise AssertionError(f"{name}: a cache tensor moved")
            if paged and (rec["invariant_checks"] != rec["steps"]
                          or blocks[0] != blocks[1]):
                raise AssertionError(f"{name}: blocks leaked")
            if got != exp or min(got.values()) <= 0:
                raise AssertionError(f"{name}: launches differ from nodes x "
                                     f"ticks")
            if len(rec["restores"]) != rep.n_restarts or any(
                    not (r["graph"] and r["own_graph"])
                    for r in rec["restores"]) or any(
                    t["chunks"] != 1 or t["equal"] != 1
                    or t["same_launches"] != 1 for t in tallies):
                raise AssertionError(f"{name}: a restored engine did not "
                                     f"replay from its own graph")
            out[name] = cell
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["fault_free"] = {k: v["wall"] for k, v in base.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase 4g ({arch}): {out['phase_s']:.1f} s, "
        f"{len(CHAOS_CELLS[arch])} storm cells [{smi}]")
    return out


# phase 4h: the engine's trace hooks on the graph engine
TRACE_WINDOW = 1_000_000    # a LiveMetrics window longer than any drive
FRAG_COUNTERS = ("blocks_free", "bytes_resident", "padding_waste")
TRACER_HOOKS = ("request_submit", "request_shed", "request_preempt",
                "request_resume", "request_done", "request_fault",
                "request_retry", "request_quarantine", "engine_fault",
                "decode_chunk", "prefill", "host_sync", "compile",
                "counter")


def time_hooks(obj, names, acc) -> None:
    """Host seconds inside ``obj``'s methods ``names``, summed into
    ``acc["hook_s"]`` (calls in ``acc["hook_calls"]``): what tracing
    costs the drive, apart from the drive's own spread."""
    for name in names:
        def call(*a, _fn=getattr(obj, name), **k):
            t = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc["hook_s"] += time.perf_counter() - t
                acc["hook_calls"] += 1
        setattr(obj, name, call)


def traced_drive(model, params, plan, items, traced) -> dict:
    """One ``drive`` of ``items`` on a fresh engine built from ``plan``
    (seed 0, ``VirtualClock``), with a ``Tracer`` and a ``LiveMetrics``
    window of ``TRACE_WINDOW`` ticks when ``traced``; the host clock
    around the drive ends in a synchronize.  Returns a dict: tracer,
    live, eng, reqs, wall, launches (every launch counter's growth over
    the drive), moved (cache, view, pool or index tensors whose
    ``data_ptr`` changed), view (stamps, ``stats()``, ``fault_stats()``,
    utilization as JSON), stats, agg, parts (``time_parts``) and, traced,
    hook_s / hook_calls (``time_hooks`` over the tracer's and the live
    window's methods and, paged, the fragmentation counters' reads).  The
    engine is closed."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.models.params import tree_leaves
    from repro_torch.obs import Tracer
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged import PagedSlotManager

    tracer = Tracer() if traced else None
    eng = ServingEngine.from_plan(plan, params, model=model, seed=0,
                                  tracer=tracer)
    live = eng.enable_live_metrics(TRACE_WINDOW) if traced else None
    paged = isinstance(eng.sm, PagedSlotManager)
    parts = time_parts(eng)
    hooks = dict(hook_s=0.0, hook_calls=0)
    if traced:
        time_hooks(tracer, TRACER_HOOKS, hooks)
        time_hooks(live, ("observe_tick", "observe_request"), hooks)
        if paged:       # the fragmentation counters' host reads
            time_hooks(eng.sm, FRAG_COUNTERS, hooks)
    tensors = lambda: tree_leaves(eng.sm.cache) + (
        eng.sm.tensors() if paged else [])
    ptrs = [t.data_ptr() for t in tensors()]
    before = launches.counters()
    t = time.perf_counter()
    reqs = wl.drive(eng, items, wl.VirtualClock())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    grown = launches.since(before)
    moved = sum(a != b.data_ptr() for a, b in zip(ptrs, tensors()))
    if not all(r.done for r in reqs):
        raise AssertionError("a request of the traced cell was left "
                             "unfinished")
    view = json.dumps(dict(stamps=cell_stamps(reqs), stats=eng.stats(),
                           faults=eng.fault_stats(),
                           util=eng.util_history), sort_keys=True)
    agg = smet.aggregate(reqs, ticks=eng.ticks,
                         util_history=eng.util_history)
    stats = eng.stats()
    eng.close()
    return dict(tracer=tracer, live=live, stats=stats, reqs=reqs, wall=wall,
                launches=grown, moved=moved, view=view, agg=agg,
                parts=dict(parts), **hooks)


def event_counts(tracer) -> dict:
    counts: dict = {}
    for e in tracer.events:
        counts[e.name] = counts.get(e.name, 0) + 1
    return dict(sorted(counts.items()))


def check_traced(tag, name, runs) -> None:
    """Raises unless the traced ``runs`` (dicts with ``tracer``) all
    wrote the same bytes and the trace passes ``check_trace``."""
    from repro_torch.obs import check_trace

    text = runs[0]["tracer"].dumps()
    same = all(r["tracer"].dumps() == text for r in runs)
    check_trace(runs[0]["tracer"].to_chrome())
    log(f"[{tag}] {name}: {len(runs)} traced drives' dumps() "
        f"byte-identical: {same}; check_trace passed")
    if not same:
        raise AssertionError(f"{name}: traced drives wrote other bytes")


def parts_row(run) -> tuple:
    """A drive's (wall, prefill calls, chunks, rest of the steps) s."""
    pt = run["parts"]
    return tuple(round(x, 3) for x in (
        run["wall"], pt["prefill_s"], pt["chunk_s"],
        pt["step_s"] - pt["prefill_s"] - pt["chunk_s"]))


def live_equals_aggregate(live, agg) -> bool:
    """A window longer than the drive against ``aggregate`` in ticks."""
    snap = live.snapshot()
    want_slo = agg["slo"]["attainment"] if "slo" in agg else None
    return (snap["completed"] == agg["completed"]
            and snap["ttft_p95"] == agg["ttft"]["p95"]
            and json.dumps(snap["tpot_p95"]) == json.dumps(agg["tpot"]["p95"])
            and abs(snap["mean_util"] - agg["mean_util"]) <= 1e-12
            and snap["slo_attainment"] == want_slo)


def trace_rwkv_main_path(model, params, chaos, smi) -> dict:
    """Phase 4h on 4e's rwkv6-1.6b tree (after 4g): ``rwkv6-1.6b/b4/r1``
    driven untraced, traced, traced, untraced, and ``rwkv6-1.6b/
    dense/storm4`` traced twice through ``drive_resilient``.  Fatal: the traced
    drives' bytes equal, ``check_trace``, the bytes of the reduced CPU
    twin (``reduced_cpu_cell``); traced stamps, ``stats()``,
    ``host_syncs``, launch counters and utilization equal to the
    untraced drives'; no cache tensor moved; the live window's snapshot
    the aggregate; the storm's traces equal, its schedule 4g's untraced
    one, with ``fault``, ``retry`` and ``quarantine`` events."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import serving_cell
    from repro_torch.obs import Tracer, check_trace
    from repro_torch.plan.plan import ServingPlan, WorkloadProfile
    from repro_torch.serving import workload as wl
    from repro_torch.serving.faults import make_storm

    t0 = time.perf_counter()
    name = "rwkv6-1.6b/b4/r1"
    cell = serving_cell(name)
    plan = dataclasses.replace(cell.plan, reduced=False)
    items = wl.profile_items(cell.workload, vocab_size=model.cfg.vocab_size,
                             seed=0, duration=32.0)
    order = (False, True, True, False)     # in turns
    runs = [traced_drive(model, params, plan, items, t) for t in order]
    plain = [r for r, t in zip(runs, order) if not t]
    traced = [r for r, t in zip(runs, order) if t]
    check_traced("4h", name, traced)
    text = traced[0]["tracer"].dumps()
    t_cpu = time.perf_counter()
    cpu = reduced_cpu_cell(plan, items, reduced_cpu_model(plan.arch),
                           traced=True)["trace"]
    cpu_s = time.perf_counter() - t_cpu
    same_cpu = cpu == text
    same_views = all(r["view"] == plain[0]["view"] for r in runs)
    same_launches = all(r["launches"] == plain[0]["launches"] for r in runs)
    moved = sum(r["moved"] for r in runs)
    live_ok = all(live_equals_aggregate(r["live"], r["agg"]) for r in traced)
    st = traced[0]["stats"]
    ev = len(traced[0]["tracer"])
    walls = [r["wall"] for r in runs]
    med = lambda rs: statistics.median(r["wall"] for r in rs)
    hook_ms = [1e3 * r["hook_s"] for r in traced]
    calls = traced[0]["hook_calls"]
    out = dict(name=name, plan=plan.summary(), events=ev,
               trace_bytes=len(text.encode()),
               event_counts=event_counts(traced[0]["tracer"]),
               walls_in_turns=walls, traced=list(order),
               parts=[parts_row(r) for r in runs],
               traced_over_untraced=med(traced) / med(plain) - 1,
               hook_ms=hook_ms, hook_calls=calls,
               cpu_twin_s=cpu_s, same_as_cpu=same_cpu, same_views=same_views,
               same_launches=same_launches, launches=plain[0]["launches"],
               moved=moved, live_equals_aggregate=live_ok,
               live=traced[0]["live"].snapshot(), stats=st)
    host = sum(e.name == "host_sync" for e in traced[0]["tracer"].events)
    log(f"[4h] {name} ({plan.summary()}): drives in turns (untraced, traced, "
        f"traced, untraced) {[round(w, 3) for w in walls]} s (host "
        f"clock); traced / untraced median - 1 = "
        f"{out['traced_over_untraced']:+.4f}; each drive's (wall, prefill "
        f"calls, chunks, rest of the steps) s {out['parts']}; host time "
        f"inside the tracer's and the live window's calls "
        f"{[round(x, 3) for x in hook_ms]} ms a traced drive ({calls} calls, "
        f"{1e3 * statistics.median(hook_ms) / max(1, calls):.2f} us a "
        f"call); {ev} events, {out['trace_bytes']} bytes of trace, {host} "
        f"host_sync instants / host_syncs {st['host_syncs']}; counts "
        f"{out['event_counts']} [{smi}]")
    log(f"[4h] {name}: the trace byte-identical to the reduced CPU twin's "
        f"(same plan at reduced width, device=cpu, prompt ids mod "
        f"{model.cfg.vocab_size} -> reduced vocab; {cpu_s:.2f} s): "
        f"{same_cpu}; stamps, stats(), fault_stats(), utilization equal "
        f"traced and untraced: {same_views}; launches equal {same_launches} "
        f"({plain[0]['launches']}); cache tensors moved: {moved}; the live "
        f"window's snapshot the aggregate in ticks: {live_ok} "
        f"({out['live']})")
    if not same_cpu:
        raise AssertionError(f"{name}: the card's trace differs from the "
                             f"reduced CPU twin's")
    if not (same_views and same_launches) or moved or not live_ok:
        raise AssertionError(f"{name}: tracing changed the drive")
    if min(plain[0]["launches"].values(), default=0) <= 0:
        raise AssertionError(f"{name}: no kernel launched")

    # the storm4 cell of 4g, traced twice through drive_resilient
    storm_name = "rwkv6-1.6b/dense/storm4"
    splan = ServingPlan(arch=model.cfg.name, reduced=False,
                        cache_layout="dense", **CHAOS_PLAN).resolve()
    sitems = wl.profile_items(WorkloadProfile(**CHAOS_WORKLOAD),
                              vocab_size=model.cfg.vocab_size, seed=0)
    storm = make_storm(duration=int(CHAOS_WORKLOAD["duration"]), seed=4,
                       n_faults=4, max_batch=CHAOS_PLAN["max_batch"])
    tmp = Path(tempfile.mkdtemp(prefix="trace_ckpt_"))
    sruns = []
    try:
        for i in range(2):
            tracer = Tracer()
            hooks = dict(hook_s=0.0, hook_calls=0)
            time_hooks(tracer, TRACER_HOOKS, hooks)
            rep, rec = chaos_drive(model, params, splan, sitems, storm,
                                   str(tmp / f"s{i}"), tracer=tracer)
            view = chaos_view(rep)
            fs = rep.engine.fault_stats()
            rep.engine.close()
            sruns.append(dict(tracer=tracer, view=view, wall=rec["wall"],
                              faults=fs, **hooks))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_traced("4h", storm_name, sruns)
    counts = event_counts(sruns[0]["tracer"])
    same_4g = all(r["view"] == chaos[storm_name]["view"] for r in sruns)
    has = {"fault", "retry", "quarantine"} <= set(counts)
    out["storm"] = dict(name=storm_name, walls=[r["wall"] for r in sruns],
                        untraced_4g_walls=chaos[storm_name]["wall_s"],
                        events=len(sruns[0]["tracer"]),
                        trace_bytes=len(sruns[0]["tracer"].dumps().encode()),
                        event_counts=counts, faults=sruns[0]["faults"],
                        same_as_4g=same_4g,
                        hook_ms=[1e3 * r["hook_s"] for r in sruns])
    log(f"[4h] {storm_name}: traced drives "
        f"{[round(r['wall'], 3) for r in sruns]} s (inside the tracer's "
        f"calls {[round(x, 3) for x in out['storm']['hook_ms']]} ms) "
        f"against 4g's untraced "
        f"{[round(w, 3) for w in chaos[storm_name]['wall_s']]} s (host "
        f"clock); its deterministic view (stamps, retries, tokens, events, "
        f"fault stats, aggregate) 4g's untraced one: {same_4g}; "
        f"{out['storm']['events']} events, {out['storm']['trace_bytes']} "
        f"bytes; counts {counts} beside fault_stats() "
        f"{sruns[0]['faults']} [{smi}]")
    if not same_4g:
        raise AssertionError(f"{storm_name}: tracing changed the storm")
    if not has:
        raise AssertionError(f"{storm_name}: the trace lacks fault, retry "
                             f"or quarantine events")
    out["phase_s"] = time.perf_counter() - t0
    log(f"[4h] phase 4h (rwkv6-1.6b): {out['phase_s']:.1f} s [{smi}]")
    return out


# phase 4i: the serving tier, the JAX package's fleet grid (all rwkv6-1.6b)
FLEET_READBACKS = 3     # the first hand-offs read back from their slot


def watch_fleet(router) -> dict:
    """Before a fleet drive: each replica's cache ``data_ptr``s; each
    replica's launches, counted around its decode loop's ``run``
    (``launches.since``); the host clock around the prefill replicas'
    ``snapshot_many`` (it ends in the one blocking read) and the host
    clock and CUDA events around every ``restore``, each checked to keep
    the cache tree and its addresses; the first ``FLEET_READBACKS``
    hand-offs read back from the destination slot and held byte for byte
    to the snapshot (the source column's bytes).  Returns the record."""
    import torch

    from repro_torch.kernels import launches
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.slotstate import gather_slots

    engines = router.engines
    rec = dict(ptrs=[[t.data_ptr() for t in tree_leaves(e.sm.cache)]
                     for e in engines],
               replica_launches=[{} for _ in engines],
               snapshot_s=[], snapshot_slots=[], snapshot_bytes=[],
               restore_s=[], restore_events=[], restore_bytes=[],
               restores=[0] * len(engines), restores_in_place=0,
               readbacks=0, readbacks_equal=0)
    for i, eng in enumerate(engines):
        def run(*a, real=eng._loop.run, i=i, **k):
            mark = launches.counters()
            try:
                return real(*a, **k)
            finally:
                for key, n in launches.since(mark).items():
                    got = rec["replica_launches"][i]
                    got[key] = got.get(key, 0) + n

        eng._loop.run = run

        def restore(slot, snap, req, real=eng.sm.restore, eng=eng, i=i):
            cache = eng.sm.cache
            before = [t.data_ptr() for t in tree_leaves(cache)]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            a.record()
            real(slot, snap, req)
            b.record()
            rec["restore_s"].append(time.perf_counter() - t)
            rec["restore_events"].append((a, b))
            rec["restore_bytes"].append(snap.nbytes())
            rec["restores"][i] += 1
            rec["restores_in_place"] += bool(
                eng.sm.cache is cache and before == [
                    t.data_ptr() for t in tree_leaves(eng.sm.cache)])
            if i >= router.n_prefill and router.n_prefill \
                    and rec["readbacks"] < FLEET_READBACKS:
                col = gather_slots(eng.sm.cache, eng.sm.axes, [slot])
                rec["readbacks"] += 1
                rec["readbacks_equal"] += all(
                    torch.equal(x.cpu(), y) for x, y in zip(
                        tree_leaves(col), tree_leaves(snap.cache_col)))

        eng.sm.restore = restore
        if i < router.n_prefill:
            def snapshot_many(slots, real=eng.sm.snapshot_many):
                t = time.perf_counter()
                snaps = real(slots)
                rec["snapshot_s"].append(time.perf_counter() - t)
                rec["snapshot_slots"].append(len(snaps))
                rec["snapshot_bytes"].append(sum(s.nbytes() for s in snaps))
                return snaps

            eng.sm.snapshot_many = snapshot_many
    return rec


def fleet_view(router, reqs) -> dict:
    """A fleet drive's deterministic view: per request (arrival order) its
    uid, replica, stamps, output length and shed flag; every replica's
    ``stats()``; ``transit_stats()`` without its bytes (a slot column's
    bytes follow the width); the census; the tick-domain aggregate as
    JSON."""
    where = {id(r): i for i, rs in enumerate(router.assigned) for r in rs}
    transit = dict(router.transit_stats())
    transit.pop("bytes")
    return dict(
        requests=[(r.uid, where[id(r)], r.t_submit, r.t_admit, r.t_first,
                   r.t_done, len(r.output), r.done, r.shed,
                   tuple(r.t_preempts), tuple(r.t_resumes)) for r in reqs],
        stats=[e.stats() for e in router.engines], transit=transit,
        census=router.conservation_census(),
        aggregate=json.dumps(router.fleet_aggregate(), sort_keys=True))


def reduced_cpu_fleet(fleet, items, cpu) -> tuple:
    """The same fleet at reduced width on the CPU (``device="cpu"``, the
    tree ``cpu`` = (model, params)), fed the same items with prompt ids
    taken modulo the reduced vocabulary: its ``fleet_view`` and host
    seconds.  Without an ``eos_id`` the schedule, the routing and the
    transits depend only on lengths, budgets and deadlines, so the
    full-width fleet on the card must give this view.  An explicit
    reference, not a fallback."""
    import dataclasses

    from repro_torch.serving.router import Router, drive_fleet

    if any(it.eos_id is not None for it in items):
        raise AssertionError("the fleet cell's items carry an eos_id")
    model, params = cpu
    vocab = model.cfg.vocab_size
    small = [dataclasses.replace(it, prompt=tuple(t % vocab
                                                  for t in it.prompt))
             for it in items]
    reduced = dataclasses.replace(fleet, replicas=tuple(
        dataclasses.replace(p, reduced=True) for p in fleet.replicas))
    t = time.perf_counter()
    router = Router.from_plan(reduced, seed=0, device="cpu",
                              _built={(model.cfg.name, True): cpu})
    reqs = drive_fleet(router, small)
    return fleet_view(router, reqs), time.perf_counter() - t


def slo_met_tokens(reqs) -> int:
    """Tokens of requests done inside their deadline (the JAX fleet
    benchmark's capacity metric, in ticks)."""
    return sum(len(r.output) for r in reqs
               if r.deadline is not None and r.t_done is not None
               and r.t_done + 1 <= r.deadline)


def fleet_cell_run(cell, model, params, kernels, want, cpu, smi) -> dict:
    """One ``FLEET_SERVING_SWEEP`` cell at full width (every replica plan
    with ``reduced=False``, seed 0, duration 32 unless the cell has its
    own) through ``Router.from_plan`` (4e's tree, one engine and decode
    graph a replica, built one after another) and ``drive_fleet`` on a
    ``VirtualClock``.  Fatal: the census after every round and at drain;
    the launch counters of ``kernels``, set to 0 just before the drive
    and read just after, and each replica's, equal to ``want`` of its
    ``stats()`` (summed), ``rwkv6_step`` and ``decode_loop`` in every
    replica that decoded; every cache tensor of every replica at its
    address and every restore in place; disaggregated: every hand-off
    delivered, none in flight, no decode replica prefilling, the first
    hand-offs read back byte-equal; with ``cpu`` (the reduced tree), the
    view equal to the reduced CPU twin's."""
    import dataclasses

    import torch

    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import workload as wl
    from repro_torch.serving.router import Router, drive_fleet

    t_cell = time.perf_counter()
    fleet = dataclasses.replace(cell.fleet, replicas=tuple(
        dataclasses.replace(p, reduced=False)
        for p in cell.fleet.replicas)).validate()
    name = cell.name
    duration = (cell.workload.duration if cell.workload.duration is not None
                else 32.0)
    items = wl.profile_items(cell.workload, vocab_size=model.cfg.vocab_size,
                             seed=0, duration=duration)
    dev = params["embedding"].device
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    router = Router.from_plan(fleet, seed=0, device=dev,
                              _built={(model.cfg.name, False):
                                      (model, params)})
    build_s = time.perf_counter() - t
    capture_s = [e._loop.capture_s for e in router.engines]
    if not all(e._loop.graph for e in router.engines):
        raise AssertionError(f"{name}: a replica has no decode graph")
    rec = watch_fleet(router)
    census_ok = []

    def on_tick(_):
        c = router.conservation_census()
        census_ok.append(c["total"] == len(router.requests))

    for mod, key in kernels:
        mod.LAUNCHES[key] = 0
    t = time.perf_counter()
    reqs = drive_fleet(router, items, wl.VirtualClock(), on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = {key: mod.LAUNCHES[key] for mod, key in kernels}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    engines = router.engines
    stats = [e.stats() for e in engines]
    exp = {key: sum(want(st)[key] for st in stats) for key in got}
    per_ok = all(rec["replica_launches"][i] == {
        k: v for k, v in want(st).items() if v} for i, st in enumerate(stats))
    decoded_ok = all(
        min(rec["replica_launches"][i].get(k, 0) for k in got) > 0
        for i, st in enumerate(stats) if st["decode_ticks"])
    same_ptrs = rec["ptrs"] == [[t.data_ptr() for t in tree_leaves(e.sm.cache)]
                                for e in engines]
    census = router.conservation_census()
    ts = router.transit_stats()
    agg = router.fleet_aggregate()
    view = fleet_view(router, reqs)
    cpu_view, cpu_s = (reduced_cpu_fleet(fleet, items, cpu) if cpu
                       else (None, None))
    same_cpu = view == cpu_view if cpu else None
    out = dict(name=name, fleet=fleet.summary(), requests=len(items),
               duration=duration, wall_s=wall,
               tokens=agg["tokens"], tokens_per_s=agg["tokens"] / wall,
               ticks=agg["ticks"], agg=agg, transit=ts, census=census,
               stats=stats, routed=[len(a) for a in router.assigned],
               launches=got, replica_launches=rec["replica_launches"],
               build_s=build_s, capture_s=capture_s,
               peak_gb=peak_gb, peak_rise_gb=peak_gb - base / 1e9,
               slo_met_tokens=slo_met_tokens(reqs), same_as_cpu=same_cpu,
               cpu_twin_s=cpu_s, restores=sum(rec["restores"]),
               restores_in_place=rec["restores_in_place"])
    log(f"[4i] {name} ({fleet.summary()}): {len(items)} requests over "
        f"{duration:g} units; drive {wall:.3f} s wall (host clock), "
        f"{agg['tokens']} tokens = {out['tokens_per_s']:.1f} tokens/s; "
        f"{agg['ticks']} ticks; built in {build_s:.2f} s, captures "
        f"{[round(c, 3) for c in capture_s]} s; peak device memory "
        f"{peak_gb:.2f} GB ({out['peak_rise_gb']:.3f} GB above the tree "
        f"and what came before) [{smi}]")
    for i, (e, st) in enumerate(zip(engines, stats)):
        role = ("colocated" if not fleet.n_prefill else
                "prefill" if i < fleet.n_prefill else "decode")
        log(f"[4i] {name} replica[{i}] ({role}, b{e.max_batch}): "
            f"{len(router.assigned[i])} routed, {st['ticks']} ticks, "
            f"{st['decode_ticks']} decode ticks in {st['decode_chunks']} "
            f"chunks, {st['prefill_calls']} prefill calls, "
            f"{st['host_syncs']} host syncs, {st['resumes']} resumes; "
            f"launches {rec['replica_launches'][i]}")
    log(f"[4i] {name}: launches {got} = nodes x ticks summed over the "
        f"replicas {exp}: {got == exp}; each replica's equal to its own: "
        f"{per_ok}; rwkv6_step and decode_loop in every replica that "
        f"decoded: {decoded_ok}; every cache tensor of every replica at its "
        f"address: {same_ptrs}; restores in place "
        f"{rec['restores_in_place']}/{sum(rec['restores'])}; census after "
        f"every round = submitted: {all(census_ok)} ({len(census_ok)} "
        f"rounds), at drain {census}")
    log(f"[4i] {name}: transit {ts}; the view (per request uid, replica, "
        f"stamps, shed; every replica's stats(); transit_stats() but its "
        f"bytes; census; the aggregate in ticks) equal to the same fleet's "
        f"at reduced width on the CPU "
        + (f"({cpu_s:.2f} s, prompt ids mod the reduced vocabulary): "
           f"{same_cpu}" if cpu else "not run for this cell"))
    if got != exp or not per_ok or not decoded_ok:
        raise AssertionError(f"{name}: launches differ from nodes x ticks")
    if not same_ptrs or rec["restores_in_place"] != sum(rec["restores"]):
        raise AssertionError(f"{name}: a replica's cache moved")
    if not (census_ok and all(census_ok)) or census["total"] != len(items) \
            or census["finished"] + census["shed"] != len(items):
        raise AssertionError(f"{name}: a request was not conserved")
    if not all(r.done or r.shed for r in reqs):
        raise AssertionError(f"{name}: a request was left unfinished")
    if cpu and not same_cpu:
        for key in view:
            if view[key] != cpu_view[key]:
                log(f"[4i] {name}: {key} differs: card {view[key]} cpu "
                    f"{cpu_view[key]}")
        raise AssertionError(f"{name}: the card's fleet differs from the "
                             f"reduced CPU fleet")
    if fleet.n_prefill:
        dec = range(fleet.n_prefill, len(engines))
        snap_ms = [1e3 * s for s in rec["snapshot_s"]]
        rest_ms = [1e3 * s for s in rec["restore_s"]]
        rest_dev = [a.elapsed_time(b) for a, b in rec["restore_events"]]
        col = statistics.median(rec["restore_bytes"])
        out["handoff"] = dict(
            snapshots=len(snap_ms), slots=sum(rec["snapshot_slots"]),
            snapshot_ms=statistics.median(snap_ms),
            snapshot_ms_max=max(snap_ms),
            snapshot_ms_a_slot=sum(snap_ms) / sum(rec["snapshot_slots"]),
            snapshot_bytes=sum(rec["snapshot_bytes"]),
            restore_ms=statistics.median(rest_ms),
            restore_ms_max=max(rest_ms),
            restore_device_ms=statistics.median(rest_dev),
            column_bytes=col, readbacks=rec["readbacks"],
            readbacks_equal=rec["readbacks_equal"],
            decode_prefills=[stats[i]["prefill_calls"] for i in dec])
        h = out["handoff"]
        log(f"[4i] {name}: {ts['handoffs']} hand-offs, {ts['delivered']} "
            f"delivered, {ts['in_flight']} in flight, {ts['bytes']} bytes "
            f"over {ts['ticks']} modeled transit ticks (bytes_per_tick "
            f"{ts['bytes_per_tick']}: every column of {col:.0f} bytes at "
            f"the 1-tick floor); on the host clock: snapshot_many "
            f"{h['snapshot_ms']:.3f} ms median ({h['snapshot_ms_max']:.3f} "
            f"max) over {h['snapshots']} sweeps of {h['slots']} slots "
            f"({h['snapshot_ms_a_slot']:.3f} ms a slot, "
            f"{h['snapshot_bytes']} bytes), restore "
            f"{h['restore_ms']:.3f} ms median ({h['restore_ms_max']:.3f} "
            f"max; {h['restore_device_ms']:.3f} ms by CUDA events); the "
            f"first {h['readbacks']} hand-offs read back from the "
            f"destination slot byte-equal to the snapshot: "
            f"{h['readbacks_equal']}/{h['readbacks']}; decode replicas' "
            f"prefill calls {h['decode_prefills']} [{smi}]")
        if ts["handoffs"] != ts["delivered"] or ts["in_flight"] \
                or ts["handoffs"] < 1 or ts["delivered"] != sum(
                    rec["restores"][i] for i in dec):
            raise AssertionError(f"{name}: a hand-off was not delivered")
        if any(h["decode_prefills"]):
            raise AssertionError(f"{name}: a decode replica prefilled")
        if h["readbacks"] < 1 or h["readbacks_equal"] != h["readbacks"]:
            raise AssertionError(f"{name}: a hand-off's slot differs from "
                                 f"its snapshot")
    out["router"], out["reqs"] = router, reqs
    out["cell_s"] = time.perf_counter() - t_cell
    return out


def fleet_main_path(model, params, kernels, want, smi) -> dict:
    """Phase 4i on 4e's rwkv6-1.6b tree (after 4h): the six
    ``FLEET_SERVING_SWEEP`` cells through ``fleet_cell_run``; the twin's
    ``fleet_aggregate()`` equal to a bare ``drive()`` of the same plan and
    items on the same tree, with the same stamps and tokens; the capacity
    cells' SLO-met tokens and attainment from x1 to x4.  Returns the
    cells, the launches summed over the phase and its seconds."""
    import dataclasses

    import torch

    from repro_torch.configs import FLEET_SERVING_SWEEP
    from repro_torch.models.lm import build_model
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.testing import reduced_config

    t0 = time.perf_counter()
    small = build_model(reduced_config(model.cfg.name))
    cpu = (small, small.init_serving(torch.Generator().manual_seed(0),
                                     "cpu"))
    out = {"cells": {}, "launches": {}}
    for cell in FLEET_SERVING_SWEEP:
        # the reduced CPU fleet holds the twin, capacity x2 and disagg
        held = cell.tag in ("twin", "disagg") or (
            cell.tag == "capacity" and cell.fleet.n_replicas == 2)
        run = fleet_cell_run(cell, model, params, kernels, want,
                             cpu if held else None, smi)
        router, reqs = run.pop("router"), run.pop("reqs")
        for key, n in run["launches"].items():
            out["launches"][key] = out["launches"].get(key, 0) + n
        if cell.tag == "twin":
            plan = dataclasses.replace(cell.fleet.replicas[0], reduced=False)
            items = wl.profile_items(cell.workload,
                                     vocab_size=model.cfg.vocab_size, seed=0,
                                     duration=run["duration"])
            eng = ServingEngine.from_plan(plan, params, model=model, seed=0)
            bare = wl.drive(eng, items, wl.VirtualClock())
            agg = smet.aggregate(bare, ticks=eng.ticks,
                                 util_history=eng.util_history)
            stamps = lambda rs: [(r.uid, r.t_submit, r.t_admit, r.t_first,
                                  r.t_done, list(r.output)) for r in rs]
            same = (json.dumps(agg, sort_keys=True)
                    == json.dumps(run["agg"], sort_keys=True)
                    and stamps(bare) == stamps(reqs)
                    and eng.stats() == run["stats"][0])
            eng.close()
            log(f"[4i] {cell.name}: fleet_aggregate() equal to a bare drive()"
                f" of the same plan and items on the same tree, dict for "
                f"dict, with the same stamps, tokens and stats(): {same}")
            if not same:
                raise AssertionError(f"{cell.name}: the one-replica fleet "
                                     f"differs from the bare engine")
            run["twin_equal"] = same
        for e in router.engines:
            e.close()
        del router, reqs
        out["cells"][cell.name] = run
    cap = [c for c in out["cells"].values() if c["name"].endswith(
        "/capacity")]
    one = cap[0]["slo_met_tokens"]
    text = ", ".join(
        f"x{len(c['stats'])} {c['slo_met_tokens']} SLO-met tokens "
        f"({c['slo_met_tokens'] / max(1, one):.3f} x x1), attainment "
        f"{c['agg']['slo']['attainment']:.4f}" for c in cap)
    log(f"[4i] capacity (ticks): {text}")
    out["capacity"] = [dict(replicas=len(c["stats"]),
                            slo_met_tokens=c["slo_met_tokens"],
                            attainment=c["agg"]["slo"]["attainment"])
                       for c in cap]
    out["phase_s"] = time.perf_counter() - t0
    each = ", ".join(f"{c['cell_s']:.1f}" for c in out["cells"].values())
    log(f"[4i] phase 4i: {out['phase_s']:.1f} s, six fleet cells ({each} s);"
        f" launches {out['launches']} [{smi}]")
    return out


# phase 4j: the MoE archs at full width on the graph engine
MOE_ARCH = "qwen3-moe-30b-a3b"
GRANITE_ARCH = "granite-moe-1b-a400m"
MOE_CELLS = tuple(f"{MOE_ARCH}/b{b}/r{r}" for b in (2, 4)
                  for r in ("0.1", "1"))
MOE_TWIN = f"{MOE_ARCH}/b4/r1"     # also on the plain path and on the CPU
MOE_ZERO_INIT = ("norm1", "norm2")            # block leaves: noise std 0.1
MOE_ZERO_INIT_ATTN = ("q_norm", "k_norm")
MOE_EAGER_CHUNKS = 8        # closed-run chunks held to the eager chunk
MOE_ROUTED_STEPS = 6        # teacher-forced decode steps, seeded router
MOE_HELD_STEPS = 12         # and with the router zeroed (held)


def build_moe(tag, arch, dev) -> tuple:
    """``arch`` at full width as served (``init_serving``: every leaf
    drawn from a generator seeded 0 on the card, the MoE leaves one layer
    slice at a time), its zero-initialised norm scales perturbed (std 0.1)
    so they do work.  Returns (model, params, info): parameters, GB as
    served, build seconds and the peak device memory of the build."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import tree_leaves

    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_serving(gen, dev)
    blk = params["blocks"]["p0"]
    for t in ([blk[n] for n in MOE_ZERO_INIT]
              + [blk["attn"][n] for n in MOE_ZERO_INIT_ATTN if n in blk["attn"]]
              + [params["final_norm"]]):
        t.normal_(0.0, 0.1, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in tree_leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated(dev)
    moe = params["blocks"]["p0"]["moe"]
    dtypes = {k: str(v.dtype)[6:] for k, v in moe.items()}
    info = dict(params=n_par, params_gb=wbytes / 1e9, build_s=build_s,
                peak_build_gb=peak / 1e9, live_before_gb=live / 1e9,
                param_count=cfg.param_count(),
                active_param_count=cfg.active_param_count(),
                moe_dtypes=dtypes)
    log(f"[{tag}] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, "
        f"qk_norm {cfg.qk_norm}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, tied "
        f"{cfg.tie_embeddings}: {n_par} params (the config's count "
        f"{cfg.param_count()}, without the qk-norm scales; active "
        f"{cfg.active_param_count()}), "
        f"{wbytes / 1e9:.2f} GB as served (MoE leaves {dtypes}); built in "
        f"{build_s:.1f} s with peak device memory {peak / 1e9:.2f} GB "
        f"({live / 1e9:.2f} GB allocated before)")
    # the config's count is the JAX package's formula, which leaves out
    # the qk-norm scales (2 x head_dim a layer); the spec tree is exact
    if n_par != model.n_params():
        raise AssertionError(f"{arch}: the tree holds {n_par} parameters, "
                             f"its specs {model.n_params()}")
    return model, params, info


def closed_run(tag, model, params, fa, fd, dev, smi, *, prompts=None,
               max_len=QWEN_MAX_LEN, bucket=512) -> dict:
    """Phase 4j's and 4k's closed run, as 4c's: 8 requests (``prompts``,
    default 4c's of 16-500 tokens, one at bucket 512; 32 new, greedy,
    max_batch 4, ``max_len``) through the graph engine with the first
    MOE_EAGER_CHUNKS chunks held bit-equal to the eager chunk (an eager
    MoE tick takes ~0.3 s of host time); a prefill at ``bucket`` or
    above; the flash counters, set to 0 just before and read just after,
    layers x prefill calls and layers x decode ticks; the plain attention
    path the same tick schedule and no flash launch."""
    import torch

    cfg = model.cfg
    prompts = prompts or qwen_prompts(cfg)
    max_new = 32
    torch.cuda.reset_peak_memory_stats(dev)
    fa.LAUNCHES["flash_attention"] = 0
    fd.LAUNCHES["flash_decode"] = 0
    t = time.perf_counter()
    eng, reqs, wall = serve_qwen(model, params, prompts, max_new,
                                 reference=tag,
                                 only=lambda i, restored: i < MOE_EAGER_CHUNKS,
                                 max_len=max_len)
    n_fa, n_fd = fa.LAUNCHES["flash_attention"], fd.LAUNCHES["flash_decode"]
    st = eng.stats()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}] {cfg.name} engine: {st}; prefill shapes "
        f"{sorted(eng.prefill_shapes)}; peak device memory while serving, "
        f"the eager reference's copy of the cache included, "
        f"{peak / 1e9:.2f} GB")
    log(f"[{tag}] {cfg.name} flash_attention launches {n_fa} = "
        f"{cfg.n_layers} layers x {st['prefill_calls']} prefill calls: "
        f"{n_fa == cfg.n_layers * st['prefill_calls']}; flash_decode "
        f"launches {n_fd} = {cfg.n_layers} x {st['decode_ticks']} decode "
        f"ticks: {n_fd == cfg.n_layers * st['decode_ticks']}")
    if n_fa != cfg.n_layers * st["prefill_calls"] or n_fa <= 0:
        raise AssertionError("flash_attention launches != layers x prefills")
    if n_fd != cfg.n_layers * st["decode_ticks"] or n_fd <= 0:
        raise AssertionError("flash_decode launches != layers x decode ticks")
    check_requests(eng, reqs, cfg, max_new, bucket)
    eng_p, reqs_p, _ = serve_qwen(model, params, prompts, max_new,
                                  {"attn": {"impl": "plain"}},
                                  max_len=max_len)
    if (fa.LAUNCHES["flash_attention"], fd.LAUNCHES["flash_decode"]) != (
            n_fa, n_fd):
        raise AssertionError("the plain path launched a flash kernel")
    same_tok = same_schedule(tag, eng, reqs, eng_p, reqs_p)
    out = dict(flash_attention_launches=n_fa, flash_decode_launches=n_fd,
               graph_launches=eng.reference_tally["graph"],
               nodes_per_tick=eng._loop.per_tick_launches(),
               decode_ticks=st["decode_ticks"],
               prefill_calls=st["prefill_calls"], stats=st,
               peak_run_gb=peak / 1e9, free_running_tokens_equal=same_tok,
               run_s=time.perf_counter() - t)
    for e in (eng, eng_p):
        e._loop.close()
    return out, eng, reqs


def graph_timings(tag, model, params, prompts, max_new, dev, smi, *,
                  max_len=QWEN_MAX_LEN, prefills=None) -> dict:
    """Phase 4j's and 4k's timings, each in its own calls: the graph tick
    at B=1 and B=4 (a replayed 8-tick chunk on a fresh cache of
    ``max_len``, every slot active; CUDA events around the chunk:
    upload, launch, read), the device's busy and idle share within one
    profiled B=4 chunk (where the profiler's record of it is whole), the
    4-row prefill at each bucket of ``prefills`` (bucket -> lengths;
    default 512 -> QWEN_PRE_LEN), and tokens/s and peak memory of the
    8-request run with no eager reference (host clock, warm)."""
    import numpy as np
    import torch

    from repro_torch.serving.decode_graph import DecodeLoop
    from repro_torch.serving.sampler import SamplerConfig

    out = {}
    # a profiler session before the graphs are instantiated: the record
    # of a while node's iterations is whole only then
    device_busy(lambda: torch.zeros(1, device=dev), 1.0)
    for B in (1, 4):
        cache = model.init_cache(B, max_len, dev)
        loop = DecodeLoop(model, params, cache, SamplerConfig(), max_len, 8)
        args = (np.zeros(B, np.int32), np.ones(B, bool),
                np.full(B, -1, np.int32), np.full(B, 10_000, np.int32), 8,
                False)
        out[f"capture_s_b{B}"] = loop.capture_s
        out[f"tick_nodes_b{B}"] = dict(loop.tick_nodes)
        out[f"graph_tick_ms_b{B}"] = events_ms(lambda: loop.run(*args), 3) / 8
        if B == 4:
            runs = []
            bz = device_busy(lambda: runs.append(loop.run(*args)),
                             out["graph_tick_ms_b4"] * 8)
            ran = lambda n: n["kernel"] + n["memcpy"] + n["memset"]
            want = (ran(loop.tick_nodes) * int(runs[-1][0])
                    + ran(loop.chunk_nodes) + 2)
            whole = bz["kernels"] >= 0.99 * want > 0
            out["busy_b4"] = bz
            out["idle_share_b4"] = 1 - bz["span_share"] if whole else None
            top = ", ".join(f"{n[:40]} {us:.0f} us" for n, us in bz["top"])
            log(f"[{tag}] B=4 replayed 8-tick chunk under the profiler: "
                f"{bz['kernels']} device operations recorded of the {want} "
                f"the graph ran; " + (
                    f"busy {bz['union_ms']:.3f} ms of the profiled run's "
                    f"{bz['span_ms']:.3f} ms device span (idle "
                    f"{100 * out['idle_share_b4']:.1f} % within that run); "
                    f"largest (names inside a graph unreliable): {top}"
                    if whole else "the record is not whole: idle share not "
                    "measured") + f" [{smi}]")
        log(f"[{tag}] B={B} graph tick: capture {loop.capture_s:.2f} s, "
            f"{loop.tick_nodes} nodes a tick, "
            f"{out[f'graph_tick_ms_b{B}']:.3f} ms a tick of a replayed "
            f"8-tick chunk [{smi}]")
        loop.close()
        del loop, cache
        torch.cuda.empty_cache()
    for S, lens in (prefills or {512: QWEN_PRE_LEN}).items():
        pre = {"tokens": torch.randint(
            0, model.cfg.vocab_size, (4, S), device=dev, dtype=torch.int32,
            generator=torch.Generator(device=dev).manual_seed(1)),
            "lengths": torch.tensor(lens, dtype=torch.int32, device=dev)}
        out[f"prefill_ms_4x{S}"] = events_ms(
            lambda: model.prefill(params, pre, max_len=max_len)[1], 3)
        log(f"[{tag}] prefill 4 rows x bucket {S} (lengths {lens}): "
            f"{out[f'prefill_ms_4x{S}']:.3f} ms [{smi}]")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    eng, reqs, wall = serve_qwen(model, params, prompts, max_new,
                                 max_len=max_len)
    out["peak_serve_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["live_before_gb"] = live / 1e9
    eng._loop.close()
    n_tok = sum(len(r.output) for r in reqs)
    out["run_s"] = wall
    out["tokens_per_s"] = n_tok / wall
    log(f"[{tag}] 8-request run through the graph "
        f"engine: {n_tok} tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} "
        f"tokens/s (host clock, warm); its peak device memory "
        f"{out['peak_serve_gb']:.2f} GB, {live / 1e9:.2f} GB of it "
        f"allocated before [{smi}]")
    return out


def moe_expert_products(tag, model, params, dev, spec, smi) -> dict:
    """The expert products of a B=4 decode tick (G x C = 1 row an expert)
    on their own: ``w_up``, ``w_gate`` and ``w_down`` of every layer,
    each a batched product over all 128 experts as ``moe_mlp`` runs it,
    captured in one CUDA graph over the 48 layers' weights (each read
    from device memory, as in a tick); device ms a tick against the byte
    bound of reading every expert's weights once."""
    import torch

    from repro_torch.models.moe import _bmm

    cfg = model.cfg
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    moe = params["blocks"]["p0"]["moe"]
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((E, 1, d), generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn((E, 1, f), generator=g, device=dev).to(torch.bfloat16)
    calls = []
    for layer in range(cfg.n_layers):
        calls += [lambda l=layer: _bmm(x, moe["w_up"][l], torch.float32),
                  lambda l=layer: _bmm(x, moe["w_gate"][l], torch.float32),
                  lambda l=layer: _bmm(h, moe["w_down"][l], torch.bfloat16)]
    tick_ms = graph_ms(calls, reps=5) * len(calls)
    nbytes = sum(moe[n].numel() * moe[n].element_size()
                 for n in ("w_up", "w_gate", "w_down"))
    bound_ms = nbytes / spec.hbm_bw * 1e3
    out = dict(expert_products_tick_ms=tick_ms,
               expert_products_bound_ms=bound_ms,
               expert_products_gb=nbytes / 1e9,
               expert_products_tb_s=nbytes / (tick_ms * 1e-3) / 1e12)
    log(f"[{tag}] {cfg.name} expert products of a B=4 decode tick (3 x "
        f"{cfg.n_layers} batched products over {E} experts, CUDA graph, "
        f"weights cold): {tick_ms:.3f} ms a tick against a byte bound of "
        f"{bound_ms:.3f} ms ({nbytes / 1e9:.2f} GB at "
        f"{spec.hbm_bw / 1e12:.2f} TB/s), {out['expert_products_tb_s']:.2f}"
        f" TB/s achieved [{smi}]")
    return out


def moe_cell_run(tag, name, model, params, kernels, want, smi, *,
                 plain=None, cpu=None) -> dict:
    """One qwen3-moe cell of ``SERVING_LOAD_SWEEP`` at full width through
    ``drive`` on a ``VirtualClock`` (seed 0, duration 32 unless the cell
    has its own): the launch counters set to 0 just before and read just
    after equal to ``want(stats)``, the first 4 chunks bit-equal to the
    eager chunk, ``host_syncs`` = chunks + synchronous prefills + bursts;
    with ``plain`` the plain attention path's stamps, utilization and
    aggregate equal and no flash launch; with ``cpu`` = (model, params)
    at reduced width on the CPU, the same plan fed the same items (prompt
    ids modulo the reduced vocabulary) with the same stamps, utilization
    and aggregate."""
    import dataclasses

    from repro_torch.configs import serving_cell
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine

    t_cell = time.perf_counter()
    cell = serving_cell(name)
    plan = dataclasses.replace(cell.plan, reduced=False)
    duration = cell.duration if cell.duration is not None else 32.0
    items = wl.profile_items(cell.workload, vocab_size=model.cfg.vocab_size,
                             seed=0, duration=duration)
    for mod, key in kernels:
        mod.LAUNCHES[key] = 0
    k = serve_cell(model, params, plan, items,
                   reference=lambda i, restored: i < 4 or restored)
    got = {key: mod.LAUNCHES[key] for mod, key in kernels}
    st = k["eng"].stats()
    exp = want(st)
    log(f"[{tag}] {name} ({plan.summary()}): {len(items)} requests over "
        f"{duration:g} clock units; engine {st}")
    log(f"[{tag}] {name}: launches {got} = {exp} from the decode ticks "
        f"({st['decode_ticks']}), chunks ({st['decode_chunks']}) and "
        f"prefill calls ({st['prefill_calls']}): {got == exp}")
    if got != exp or min(got.values()) <= 0:
        raise AssertionError(f"{name}: launches differ from nodes x ticks")
    check_graph_run(tag, k["eng"], k["tally"])
    out = dict(name=name, requests=len(items), stats=st, agg=k["agg"],
               launches=got, wall_s=k["wall"],
               tokens_per_s=k["agg"]["tokens"] / k["wall"],
               parts=k["parts"], stamps=cell_stamps(k["reqs"]),
               util=k["eng"].util_history)
    runs = [k]
    if plain is not None:
        p = serve_cell(model, params,
                       dataclasses.replace(plan, tile_plans=plain), items)
        runs.append(p)
        if {key: mod.LAUNCHES[key] for mod, key in kernels
                if key != "decode_loop"} != {
                key: got[key] for key in got if key != "decode_loop"}:
            raise AssertionError(f"{name}: the plain path launched a kernel")
        same_cell(tag, f"{name} kernel vs plain path", k, p)
        out["plain_wall_s"] = p["wall"]
    if cpu is not None:
        small_model, small_params = cpu
        vocab = small_model.cfg.vocab_size
        small = [dataclasses.replace(it, prompt=tuple(t % vocab
                                                      for t in it.prompt))
                 for it in items]
        t = time.perf_counter()
        eng = ServingEngine.from_plan(dataclasses.replace(plan, reduced=True),
                                      small_params, model=small_model, seed=0)
        reqs = wl.drive(eng, small, wl.VirtualClock())
        from repro_torch.serving import metrics as smet

        c = dict(eng=eng, reqs=reqs, agg=smet.aggregate(
            reqs, ticks=eng.ticks, util_history=eng.util_history))
        out["cpu_s"] = time.perf_counter() - t
        same_cell(tag, f"{name} at full width on the card vs reduced width "
                  f"on the CPU ({out['cpu_s']:.1f} s there)", k, c)
    for run in runs:
        run["eng"]._loop.close()
    agg = k["agg"]
    pct = lambda m: "/".join(f"{agg[m][q]:g}" for q in ("p50", "p95", "p99"))
    out["cell_s"] = time.perf_counter() - t_cell
    log(f"[{tag}] {name}: {st['ticks']} ticks, {agg['tokens']} tokens, mean "
        f"util {agg['mean_util']:.3f}; queue wait / TTFT / TPOT p50/p95/p99 "
        f"in ticks {pct('queue_wait')} / {pct('ttft')} / {pct('tpot')}; "
        f"drive {k['wall']:.3f} s = {out['tokens_per_s']:.1f} tokens/s "
        f"({parts_text(k)})" + (f"; plain path drive "
                                f"{out['plain_wall_s']:.3f} s"
                                if plain is not None else "")
        + f"; cell {out['cell_s']:.1f} s [{smi}]")
    return out


def moe_main_path(fa, fd, dev, spec, smi) -> dict:
    """Phase 4j: qwen3-moe-30b-a3b at full width (~61 GB of bf16 weights,
    after 4c/4d's qwen tree is freed): the closed run and its checks, the
    teacher-forced kernel vs plain comparison, the timings, the four
    base-grid cells through ``drive``; then granite-moe-1b-a400m's closed
    run.  Returns the phase's results."""
    import gc

    import torch

    from repro_torch.kernels.decode_loop import decode_loop as dl
    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cap_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    out = {"card_gb": cap_gb}
    model, params, out["build"] = build_moe("4j", MOE_ARCH, dev)
    cfg = model.cfg
    closed, eng, reqs = closed_run("4j", model, params, fa, fd, dev, smi)
    out.update(closed)
    plain_plans = {"attn": {"impl": "plain"}}
    plain = model.with_tile_plans(plain_plans)
    # Kernel vs plain path fed the same tokens.  With the seeded router the
    # two paths' bf16 ulp differences in the attention output move router
    # logits across the top-8 boundary and change which tokens overflow an
    # expert's capacity, a discontinuous change that later layers carry:
    # logged, not held.  Held within LM_REL: the same comparison with the
    # router zeroed, where every token ties on every expert and both paths
    # route to experts 0..7 whatever their attention gives.
    out["routed"] = qwen_teacher_forced("4j", model, plain, params, eng,
                                        reqs, MOE_ROUTED_STEPS + 1, dev,
                                        held=False)
    router = params["blocks"]["p0"]["moe"]["router"]
    kept = router.clone()
    router.zero_()
    log("[4j] the same with the router zeroed (every token ties on every "
        "expert: both paths route to experts 0..7)")
    out.update(qwen_teacher_forced("4j", model, plain, params, eng, reqs,
                                   MOE_HELD_STEPS + 1, dev))
    router.copy_(kept)
    del eng, kept
    out.update(graph_timings("4j", model, params, qwen_prompts(cfg), 32, dev,
                             smi))
    out.update(moe_expert_products("4j", model, params, dev, spec, smi))
    kernels = ((fa, "flash_attention"), (fd, "flash_decode"),
               (dl, "decode_loop"))
    want = lambda st: {
        "flash_attention": cfg.n_layers * st["prefill_calls"],
        "flash_decode": cfg.n_layers * st["decode_ticks"],
        "decode_loop": st["decode_ticks"] + st["decode_chunks"]}
    small = build_model(reduced_config(MOE_ARCH))
    cpu = (small, small.init_serving(torch.Generator().manual_seed(0), "cpu"))
    out["cells"] = {}
    for name in MOE_CELLS:
        twin = name == MOE_TWIN
        out["cells"][name] = moe_cell_run(
            "4j", name, model, params, kernels, want, smi,
            plain=plain_plans if twin else None, cpu=cpu if twin else None)
    launches = dict(
        flash_attention=out["flash_attention_launches"] + sum(
            c["launches"]["flash_attention"] for c in out["cells"].values()),
        flash_decode=out["flash_decode_launches"] + sum(
            c["launches"]["flash_decode"] for c in out["cells"].values()),
        decode_loop=sum(c["launches"]["decode_loop"]
                        for c in out["cells"].values()))
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[4j] {MOE_ARCH}: peak device memory {out['peak_gb']:.2f} GB of the "
        f"card's {cap_gb:.2f} GB; 8-request run {out['tokens_per_s']:.1f} "
        f"tokens/s (sync_every 1), graph tick B=1 "
        f"{out['graph_tick_ms_b1']:.3f} ms, B=4 "
        f"{out['graph_tick_ms_b4']:.3f} ms, a B=4 tick's byte bound "
        f"{2 * cfg.param_count() / spec.hbm_bw * 1e3:.2f} ms (every bf16 "
        f"weight read once) [{smi}]")
    if out["peak_gb"] >= cap_gb:
        raise AssertionError("peak memory above the card's capacity")
    del model, params, plain
    gc.collect()
    torch.cuda.empty_cache()

    gmodel, gparams, ginfo = build_moe("4j", GRANITE_ARCH, dev)
    gclosed, geng, greqs = closed_run("4j", gmodel, gparams, fa, fd, dev,
                                      smi)
    out["granite"] = dict(build=ginfo, **gclosed)
    launches["flash_attention"] += gclosed["flash_attention_launches"]
    launches["flash_decode"] += gclosed["flash_decode_launches"]
    out["launches"] = launches
    del gmodel, gparams, geng
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[4j] phase 4j: {out['phase_s']:.1f} s; launches of the phase "
        f"{launches} [{smi}]")
    return out


# phase 4k: hymba at full width on the graph engine
HYMBA_ARCH = "hymba-1.5b"
HYMBA_MAX_LEN = 2048
HYMBA_HELD_STEPS = 12       # teacher-forced decode steps
HYMBA_PAGED = "paged:16"
# the timed 4-row prefills: lengths at buckets 512 and 2047 (= max_len - 1)
HYMBA_PRE = {512: [512, 400, 300, 17], 2047: [2047, 1500, 1100, 300]}


def hymba_prompts(cfg) -> list:
    """The 8 requests of phase 4k's closed run: prompts of 16-1500 tokens
    from a seeded numpy generator; the first two (1500 and 1100 tokens)
    cross the window of 1024, so their prefill fills the swa rings
    wrapped and every decode step writes over the oldest slot."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1501, 8)
    lens[0], lens[1] = 1500, 1100
    return [rng.integers(0, cfg.vocab_size, int(L)).tolist() for L in lens]


def build_hymba(tag, dev) -> tuple:
    """hymba-1.5b at full width as served (``init_serving`` from a
    generator seeded 0 on the card), its zero-initialised leaves (every
    block's norm scales, the fused halves' norms, ``conv_bias``,
    ``ssm_norm``, the final norm) perturbed (std 0.1) so they do work.
    Returns (model, params, info): parameters, GB as served, build
    seconds and the peak device memory of the build."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import tree_leaves

    cfg = get_config(HYMBA_ARCH)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_serving(gen, dev)
    for blk in params["blocks"].values():
        zero = [blk[n] for n in ("norm1", "norm2", "attn_out_norm",
                                 "ssm_out_norm") if n in blk]
        if "ssm" in blk:
            zero += [blk["ssm"]["conv_bias"], blk["ssm"]["ssm_norm"]]
        for t in zero:
            t.normal_(0.0, 0.1, generator=gen)
    params["final_norm"].normal_(0.0, 0.1, generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_par = sum(t.numel() for t in tree_leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated(dev)
    ssm = params["blocks"]["p1"]["ssm"]
    dtypes = {k: str(v.dtype)[6:] for k, v in ssm.items()}
    info = dict(params=n_par, params_gb=wbytes / 1e9, build_s=build_s,
                peak_build_gb=peak / 1e9, live_before_gb=live / 1e9,
                param_count=cfg.param_count(), spec_count=model.n_params(),
                ssm_dtypes=dtypes)
    log(f"[{tag}] {HYMBA_ARCH}: {cfg.n_layers} layers ({cfg.n_periods} x "
        f"{cfg.layer_pattern.count('attn')} attn + "
        f"{cfg.layer_pattern.count('swa_ssm')} swa_ssm), d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, window "
        f"{cfg.local_window}, SSD {cfg.ssm}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.padded_vocab}, tied {cfg.tie_embeddings}: {n_par} params in "
        f"the tree (its specs {model.n_params()}: dt_bias and a_log hold "
        f"one value a layer, as in the JAX package; the config's count "
        f"{cfg.param_count()}, JAX's formula), {wbytes / 1e9:.3f} GB as "
        f"served (SSM leaves {dtypes}); built in {build_s:.2f} s with peak "
        f"device memory {peak / 1e9:.2f} GB ({live / 1e9:.2f} GB allocated "
        f"before)")
    return model, params, info


def hymba_teacher_forced(tag, model, plain, params, eng, reqs, steps,
                         dev) -> dict:
    """Kernel path (``model``) against plain path (``plain``), both fed the
    kernel run's tokens: the prefill of the first four prompts (two of
    them past the window), then each decode step from the same (plain)
    cache, and each path on its own cache for all steps.  The logits
    relative to the plain side's largest are held within LM_REL (prefill
    and one step) and LM_CHAIN_GUARD (chained); the gaps of every
    layer's k/v, conv_state and ssd_state (relative to each layer's
    largest) are logged, and the prefill's k/v gap layer by layer in
    depth order (the gap grows with depth: each layer's input carries
    the earlier layers' bf16 ulp flips); the cache positions must be
    equal."""
    import torch

    cfg = model.cfg
    batch = qwen_batch(eng, reqs, dev)
    cache, logits0 = model.prefill(params, batch, max_len=HYMBA_MAX_LEN)
    cache_p, logits0_p = plain.prefill(params, batch, max_len=HYMBA_MAX_LEN)
    leaves = ("k", "v", "conv_state", "ssd_state")

    def gaps(ca, la, cb, lb):
        if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
            raise AssertionError("non-finite logits")
        g = dict(logit=max_err(la, lb) / float(lb.abs().max()))
        for name in leaves:
            g[name] = 0.0
            for key, blk in cb["blocks"].items():
                if name not in blk:
                    continue
                xa, xb = ca["blocks"][key][name], blk[name]
                for i in range(xb.shape[0]):
                    scale = float(xb[i].float().abs().max()) or 1.0
                    g[name] = max(g[name], max_err(xa[i], xb[i]) / scale)
        if not all(torch.equal(ca["blocks"][key]["pos"], blk["pos"])
                   for key, blk in cb["blocks"].items()):
            raise AssertionError("kernel and plain paths wrote other cache "
                                 "positions")
        return g

    pre = gaps(cache, logits0, cache_p, logits0_p)
    depth = []
    for layer in range(cfg.n_layers):
        key, i = f"p{layer % cfg.period}", layer // cfg.period
        xa, xb = cache["blocks"][key], cache_p["blocks"][key]
        depth.append(max(max_err(xa[n][i], xb[n][i])
                         / (float(xb[n][i].float().abs().max()) or 1.0)
                         for n in ("k", "v")))
    pre["kv_by_depth"] = depth
    log(f"[{tag}] prefill k/v gap by depth (layers 1-{cfg.n_layers}): "
        + ", ".join(f"{e:.1e}" for e in depth))
    log(f"[{tag}] prefill 4 rows at bucket {batch['tokens'].shape[1]} "
        f"(lengths {batch['lengths'].tolist()}), kernel vs plain path: max "
        f"|logits k-p|/max|logits| = {pre['logit']:.3e} (limit {LM_REL}); "
        f"max per-layer gaps k {pre['k']:.3e}, v {pre['v']:.3e}, "
        f"conv_state {pre['conv_state']:.3e}, ssd_state "
        f"{pre['ssd_state']:.3e}")
    if not pre["logit"] <= LM_REL:
        raise AssertionError("kernel and plain prefill paths disagree")
    del cache_p
    ck, cp = cache, cache
    step = dict(logit=0.0, agree=0, **{n: 0.0 for n in leaves})
    chain = dict(logit=0.0, agree=0, **{n: 0.0 for n in leaves})
    for j in range(steps):
        t = torch.tensor([r.output[j] for r in reqs[:4]], dtype=torch.int32,
                         device=dev)
        c1, l1 = model.decode_step(params, cp, t)
        ck, lk = model.decode_step(params, ck, t)
        cp, lp = plain.decode_step(params, cp, t)
        for acc, (ca, la) in ((step, (c1, l1)), (chain, (ck, lk))):
            g = gaps(ca, la, cp, lp)
            for key in g:
                acc[key] = max(acc[key], g[key])
            acc["agree"] += int((la.argmax(-1) == lp.argmax(-1)).sum())
        del c1
    for name, acc, lim in (("one step", step, LM_REL),
                           ("chained", chain, LM_CHAIN_GUARD)):
        log(f"[{tag}] teacher-forced, {name}, {steps} steps x 4 rows (the "
            f"swa rings wrapped): max |logits k-p|/max|logits| = "
            f"{acc['logit']:.3e} (limit {lim}); max per-layer gaps k "
            f"{acc['k']:.3e}, v {acc['v']:.3e}, conv_state "
            f"{acc['conv_state']:.3e}, ssd_state {acc['ssd_state']:.3e}; "
            f"argmax agrees {acc['agree']}/{4 * steps}")
        if not acc["logit"] <= lim:
            raise AssertionError(f"kernel and plain hymba paths disagree "
                                 f"({name})")
    return dict(prefill=pre, step=step, chained=chain, steps=steps)


def hymba_paged_twin(tag, model, params, prompts, eng, reqs) -> dict:
    """The closed run's 8 requests on ``paged:16`` (two ring lengths, 2048
    and 1024, one pool each): the dense run's stamps and greedy tokens
    exactly, the pool invariants after every step, every cache, view,
    pool and index tensor at its address, every block free after."""
    import torch

    from repro_torch.serving.engine import ServingEngine

    peng = ServingEngine(model, params, max_batch=4, max_len=HYMBA_MAX_LEN,
                         cache_layout=HYMBA_PAGED)
    run = dict(eng=peng, paged=watch_paged(peng))
    preqs = [peng.submit(p, max_new_tokens=32) for p in prompts]
    t = time.perf_counter()
    peng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rings = sorted(peng.sm._pools)
    out = check_paged(tag, f"{HYMBA_ARCH} closed run on {HYMBA_PAGED}", run)
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, r.output)
                         for r in rs]
    same = stamps(preqs) == stamps(reqs) and \
        peng.util_history == eng.util_history
    log(f"[{tag}] {HYMBA_PAGED} twin: ring lengths {rings}; the dense run's "
        f"stamps and greedy tokens: {same}; run {wall:.3f} s")
    if rings != [HYMBA_MAX_LEN // 2, HYMBA_MAX_LEN]:
        raise AssertionError("the paged twin has not two ring lengths")
    if not same:
        raise AssertionError("the paged twin differs from the dense run")
    peng._loop.close()
    out.update(rings=rings, same_as_dense=same, run_s=wall)
    return out


def hymba_timings(tag, model, params, prompts, dev, smi) -> dict:
    """Phase 4k's timings, each in its own calls: 4j's
    (``graph_timings`` at max_len 2048, the prefill at buckets 512 and
    2047); an eager B=4 tick under the profiler (its kernels,
    ``flash_decode``'s device time in it); the SSD halves of a B=4 tick
    alone (the 30 ``ssm_mixer`` decode calls in one CUDA graph: device
    ms, kernels, share of the graph tick)."""
    import torch

    from repro_torch.models.params import tree_map
    from repro_torch.models.ssm import ssm_mixer

    cfg = model.cfg
    out = graph_timings(tag, model, params, prompts, 32, dev, smi,
                        max_len=HYMBA_MAX_LEN, prefills=HYMBA_PRE)
    c = model.init_cache(4, HYMBA_MAX_LEN, dev)
    tk = torch.zeros((4,), dtype=torch.int32, device=dev)
    out["eager_tick_ms_b4"] = events_ms(
        lambda: model.decode_step_(params, c, tk).argmax(-1), 5)
    bz = device_busy(lambda: model.decode_step_(params, c, tk).argmax(-1),
                     out["eager_tick_ms_b4"])
    out["eager_busy_b4"] = {k: bz[k] for k in ("kernels", "launched",
                                               "busy_ms", "busy_share")}
    out["fd_tick_ms_b4"] = kernel_ms(bz, ("flash_decode",))
    log(f"[{tag}] B=4 eager tick {out['eager_tick_ms_b4']:.3f} ms: "
        f"{bz['launched']} kernels, {bz['busy_ms']:.3f} ms busy "
        f"({100 * bz['busy_share']:.1f} %); flash_decode's device time in "
        f"the tick (both launches of its {cfg.n_layers} calls, profiler) "
        f"{out['fd_tick_ms_b4']:.3f} ms [{smi}]")
    # the SSD halves of a B=4 tick alone
    h = torch.randn((4, 1, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3)).to(
        torch.bfloat16)
    calls = []
    for layer in range(cfg.n_periods):
        for i, kind in enumerate(cfg.layer_pattern):
            if kind != "swa_ssm":
                continue
            p = tree_map(lambda a: a[layer], params["blocks"][f"p{i}"]["ssm"])
            cc = {n: c["blocks"][f"p{i}"][n][layer]
                  for n in ("conv_state", "ssd_state")}
            calls.append(lambda p=p, cc=cc: ssm_mixer(p, h, cfg,
                                                      mode="decode",
                                                      cache=cc))
    ssd = lambda: [f() for f in calls]
    out["ssd_tick_ms_b4"] = graph_ms([ssd], reps=5)
    bz = device_busy(ssd, out["ssd_tick_ms_b4"])
    out["ssd_kernels_b4"] = bz["launched"]
    out["ssd_share_b4"] = out["ssd_tick_ms_b4"] / out["graph_tick_ms_b4"]
    nodes = out["tick_nodes_b4"]["kernel"]
    log(f"[{tag}] the SSD halves of a B=4 tick ({len(calls)} ssm_mixer "
        f"decode calls, one CUDA graph): {out['ssd_tick_ms_b4']:.3f} ms = "
        f"{100 * out['ssd_share_b4']:.1f} % of the "
        f"{out['graph_tick_ms_b4']:.3f} ms graph tick; {bz['launched']} "
        f"kernels of the tick's {nodes} kernel nodes "
        f"({100 * bz['launched'] / nodes:.1f} %) [{smi}]")
    del c, calls
    torch.cuda.empty_cache()
    return out


def hymba_main_path(fa, fd, dev, spec, smi) -> dict:
    """Phase 4k: hymba-1.5b at full width (~3.1 GB of bf16 weights, after
    4j's trees are freed): the closed run and its checks, the
    teacher-forced kernel vs plain comparison, the paged twin, the
    timings, and the chaos grid's two hybrid storm cells (phase 4g's
    ``chaos_main_path``, each also at reduced width on the CPU).  Returns
    the phase's results."""
    import gc

    import torch

    from repro_torch.kernels.decode_loop import decode_loop as dl
    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cap_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    out = {"card_gb": cap_gb}
    model, params, out["build"] = build_hymba("4k", dev)
    cfg = model.cfg
    prompts = hymba_prompts(cfg)
    closed, eng, reqs = closed_run("4k", model, params, fa, fd, dev, smi,
                                   prompts=prompts, max_len=HYMBA_MAX_LEN,
                                   bucket=HYMBA_MAX_LEN - 1)
    out.update(closed)
    plain = model.with_tile_plans({"attn": {"impl": "plain"}})
    out["teacher_forced"] = hymba_teacher_forced(
        "4k", model, plain, params, eng, reqs, HYMBA_HELD_STEPS, dev)
    out["paged"] = hymba_paged_twin("4k", model, params, prompts, eng, reqs)
    eng._loop.close()
    del eng, plain
    out.update(hymba_timings("4k", model, params, prompts, dev, smi))
    kernels = ((fa, "flash_attention"), (fd, "flash_decode"),
               (dl, "decode_loop"))
    want = lambda st: {
        "flash_attention": cfg.n_layers * st["prefill_calls"],
        "flash_decode": cfg.n_layers * st["decode_ticks"],
        "decode_loop": st["decode_ticks"] + st["decode_chunks"]}
    small = build_model(reduced_config(HYMBA_ARCH))
    cpu = (small, small.init_serving(torch.Generator().manual_seed(0), "cpu"))
    out["chaos"] = chaos_main_path("4k", model, params, kernels, want, smi,
                                   cpu=cpu)
    # phase 4l's hymba plan, on this tree before it is freed
    out["planner"] = hymba_planner(model, params, fa, fd, dl, smi, cpu)
    cells = [c for k, c in out["chaos"].items() if "/" in k]
    launches = dict(
        flash_attention=out["flash_attention_launches"] + sum(
            c["launches"]["flash_attention"] for c in cells),
        flash_decode=out["flash_decode_launches"] + sum(
            c["launches"]["flash_decode"] for c in cells),
        decode_loop=sum(c["launches"]["decode_loop"] for c in cells))
    out["launches"] = launches
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if out["peak_gb"] >= cap_gb:
        raise AssertionError("peak memory above the card's capacity")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[4k] phase 4k: {out['phase_s']:.1f} s; graph tick B=1 "
        f"{out['graph_tick_ms_b1']:.3f} ms, B=4 {out['graph_tick_ms_b4']:.3f}"
        f" ms, a B=4 tick's byte bound "
        f"{out['build']['params_gb'] / spec.hbm_bw * 1e12:.3f} ms (every "
        f"served weight read once); launches of the phase {launches} [{smi}]")
    return out


# phase 4l: the planner's engine half (plan/planner.py) on the card

PLANNER_ARCH = "rwkv6-1.6b"
# benchmarks/serving_load.py's drift pair: the calm, deadline-free profile
# the stale plan is tuned on, and the drifted traffic it then serves
DRIFT_CALM = dict(kind="poisson", rate=0.03, duration=96.0,
                  prompt_len=(4, 12), max_new_tokens=(6, 10),
                  prompt_len_long=63)
DRIFT_WORKLOAD = dict(DRIFT_CALM, rate=0.9, heavy_decode=(0.05, 24, 40),
                      deadline_slack=3.0)
# the hymba plan: SERVING_LOAD_SWEEP's base profile at rate 1.0
HYMBA_PLAN_RATE = 1.0
HYMBA_PLAN_BATCHES = (2, 4, 8)
# the hymba plan again with an attn entry the defaults would not give, at a
# max_len where both adapters keep it apart from them: a 127-token bucket
# runs bq 128 (the default 64), a 128-slot cache a decode chunk of 32 (the
# default 128); four requests at once, two of them in each bucket
ODD_ATTN = {"bq": 128, "bk": 32}
ODD_MAX_LEN = 128
ODD_BUCKETS = (16, 127)
ODD_PROMPTS = (10, 14, 40, 120)
# (rows, length) prefill shapes no earlier phase runs (every bucket so
# far is a power of two or max_len - 1): the new-bucket cost's samples
NEW_PREFILL_SHAPES = ((3, 24), (3, 40), (3, 48), (3, 56), (5, 24), (5, 40),
                      (5, 56))
CONST_REPS = 7


def watch_probes():
    """Wrap ``ServingEngine.from_plan`` while the planner probes: each
    engine it builds, its device and decode-graph capture seconds.
    Returns (records, undo)."""
    from repro_torch.serving.engine import ServingEngine

    real = ServingEngine.__dict__["from_plan"]
    recs = []

    def from_plan(cls, *a, **k):
        eng = real.__func__(cls, *a, **k)
        loop = eng._loop
        recs.append(dict(device=eng.device.type,
                         capture_s=getattr(loop, "capture_s", 0.0)))
        return eng

    ServingEngine.from_plan = classmethod(from_plan)
    return recs, lambda: setattr(ServingEngine, "from_plan", real)


def timed_autotune(tag, what, call, smi) -> tuple:
    """One planner call (``call()``) on the host clock, ending in a
    synchronize: (plan, info) with its seconds, probes, the probe
    engines' devices and capture seconds, and the winner."""
    import torch

    from repro_torch.plan.plan import tiles_summary

    recs, undo = watch_probes()
    t = time.perf_counter()
    try:
        plan = call()
    finally:
        undo()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    prov = plan.provenance["autotune"]
    info = dict(seconds=secs, probes=len(prov["probes"]),
                devices=sorted({r["device"] for r in recs}),
                capture_s=sum(r["capture_s"] for r in recs),
                plan=plan.summary(), tiles=tiles_summary(plan.tile_plans),
                cache_layout=plan.cache_layout, buckets=plan.buckets,
                best_score=prov["best_score"],
                layouts=prov["cache_layouts"])
    log(f"[{tag}] {what}: {secs:.2f} s, {info['probes']} probes on "
        f"{info['devices']} (decode-graph captures {info['capture_s']:.2f} "
        f"s of it); winner {info['plan']}, tiles {info['tiles']}, best "
        f"score {info['best_score']} [{smi}]")
    if len(recs) != info["probes"]:
        raise AssertionError(f"{what}: {len(recs)} engines for "
                             f"{info['probes']} probes")
    return plan, info


def same_plans(tag, what, a, b) -> None:
    """Raises unless two plans are equal as ``plan.io.to_dict``."""
    from repro_torch.plan import io as plan_io

    same = json.dumps(plan_io.to_dict(a), sort_keys=True) == json.dumps(
        plan_io.to_dict(b), sort_keys=True)
    log(f"[{tag}] {what}: equal as plan.io.to_dict: {same}")
    if not same:
        raise AssertionError(f"{tag}: {what} differ")


def det_view(eng, reqs, agg) -> str:
    """A served run's deterministic view: every request's tick stamps,
    ``stats()``, utilization and the tick-domain aggregate."""
    return json.dumps(dict(stamps=cell_stamps(reqs), stats=eng.stats(),
                           util=eng.util_history, agg=agg), sort_keys=True)


def reduced_cpu_model(arch) -> tuple:
    """``arch`` at reduced width on the CPU: (model, params), the served
    tree from a generator seeded 0."""
    import torch

    from repro_torch.models.lm import build_model
    from repro_torch.testing import reduced_config

    model = build_model(reduced_config(arch))
    return model, model.init_serving(torch.Generator().manual_seed(0), "cpu")


def reduced_cpu_cell(plan, items, cpu, traced=False) -> dict:
    """The same plan at reduced width on the CPU (``cpu``: the reduced
    (model, params)), fed ``items`` with prompt ids taken modulo the
    reduced vocabulary: the deterministic view, and with ``traced`` the
    trace's bytes and the tracer.  Without an ``eos_id`` a schedule
    depends only on lengths, budgets and deadlines."""
    from repro_torch.obs import Tracer
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import workload as wl
    from repro_torch.serving.engine import ServingEngine

    if any(it.eos_id is not None for it in items):
        raise AssertionError("the cell's items carry an eos_id")
    model, params = cpu
    vocab = model.cfg.vocab_size
    small = [dataclasses.replace(it, prompt=tuple(t % vocab
                                                  for t in it.prompt))
             for it in items]
    tracer = Tracer() if traced else None
    t = time.perf_counter()
    eng = ServingEngine.from_plan(dataclasses.replace(plan, reduced=True),
                                  params, model=model, seed=0, tracer=tracer)
    reqs = wl.drive(eng, small, wl.VirtualClock())
    agg = smet.aggregate(reqs, ticks=eng.ticks,
                         util_history=eng.util_history)
    return dict(view=det_view(eng, reqs, agg), tracer=tracer,
                trace=tracer.dumps() if traced else None,
                seconds=time.perf_counter() - t)


def planned_cell(tag, name, model, params, plan, items, kernels, want, smi,
                 tracer=None, tiles=None) -> dict:
    """``plan`` served at full width through ``serve_cell`` (seed 0, a
    ``VirtualClock``, ``tracer`` if given).  Fatal: the launch counters
    of ``kernels``, set to 0 just before and read just after, equal
    ``want(stats)`` (nodes x ticks); ``host_syncs`` = chunks +
    synchronous prefills + preemption bursts; every cache leaf at its
    address after the drive and every restore in place (a paged plan:
    ``check_paged``).  ``tiles(eng)`` may hold the wrappers' tiles to the
    plan."""
    for mod, key in kernels:
        mod.LAUNCHES[key] = 0
    run = serve_cell(model, params, plan, items, tracer=tracer)
    got = {key: mod.LAUNCHES[key] for mod, key in kernels}
    eng, agg, wall, rs = run["eng"], run["agg"], run["wall"], run["restores"]
    st = eng.stats()
    exp = want(st)
    out = dict(name=name, plan=plan.summary(), requests=len(items),
               stats=st, agg=agg, launches=got, wall_s=wall,
               tokens=agg["tokens"], tokens_per_s=agg["tokens"] / wall,
               parts=run["parts"], capture_s=eng._loop.capture_s,
               view=det_view(eng, run["reqs"], agg), restores=rs["n"])
    log(f"[{tag}] {name} ({plan.summary()}): {len(items)} requests; engine "
        f"{st}; launches {got} = {exp} from the decode ticks "
        f"({st['decode_ticks']}), chunks ({st['decode_chunks']}) and "
        f"prefill calls ({st['prefill_calls']}): {got == exp}; host_syncs "
        f"= chunks + synchronous prefills + bursts: "
        f"{st['host_syncs'] == want_host_syncs(st)}; every cache leaf at "
        f"its address: {run['kept']}; restores in place {rs['in_place']}/"
        f"{rs['n']}")
    if got != exp or min(got.values()) <= 0:
        raise AssertionError(f"{name}: launches differ from nodes x ticks")
    if st["host_syncs"] != want_host_syncs(st):
        raise AssertionError(f"{name}: host_syncs != chunks + synchronous "
                             f"prefills + bursts")
    if not run["kept"] or rs["in_place"] != rs["n"]:
        raise AssertionError(f"{name}: a cache leaf moved")
    if run["paged"] is not None:
        out["paged"] = check_paged(tag, name, run)
    if tiles is not None:
        out["tiles"] = tiles(eng)
    slo = agg.get("slo", {})
    log(f"[{tag}] {name}: drive {wall:.3f} s wall, {out['tokens']} tokens "
        f"= {out['tokens_per_s']:.1f} tokens/s (host clock, virtual "
        f"arrivals); {st['ticks']} ticks, SLO attainment "
        f"{slo.get('attainment')} ({slo.get('met')} met); TTFT p95 "
        f"{agg['ttft']['p95']} ticks; {parts_text(run)} [{smi}]")
    eng.close()
    return out


def same_view(tag, what, card, cpu) -> None:
    log(f"[{tag}] {what}: full width on the card = reduced width on the CPU "
        f"(stamps, stats(), utilization, tick-domain aggregate): "
        f"{card == cpu} (the CPU run {len(cpu)} bytes of view)")
    if card != cpu:
        raise AssertionError(f"{tag}: {what} differs from the reduced CPU "
                             f"run")


def build_rwkv(dev):
    """rwkv6-1.6b at full width as 4e and 4l serve it (seeded 0 on the
    card, the zero-initialised leaves perturbed as in 4b)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    model = build_model(get_config(PLANNER_ARCH))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, dev)
    perturb_zero_init(params, gen)
    params = model.serving_params(params)
    torch.cuda.synchronize()
    return model, params


def planner_constants(model, params, dev, smi) -> dict:
    """The planner's two times at rwkv6-1.6b full width, each median of
    ``CONST_REPS``.  ``host_sync_s``: a 1-tick chunk of the graph loop
    (the inputs' upload, one graph launch, the blocking read; CUDA events
    around it) less one tick of an 8-tick chunk, in turns, on one loop
    captured at sync_every 8 over 4 active slots.  ``compile_s``: the
    first prefill call at a (rows, length) the process has not run (host
    clock, synchronized) less the median of 3 warm calls at it, over
    ``NEW_PREFILL_SHAPES``."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.serving.decode_graph import DecodeLoop
    from repro_torch.serving.sampler import SamplerConfig

    B, max_len = 4, 256
    cache = model.init_cache(B, max_len, dev)
    loop = DecodeLoop(model, params, cache, SamplerConfig(), max_len, 8)
    args = lambda k: (np.zeros(B, np.int32), np.ones(B, bool),
                      np.full(B, -1, np.int32), np.full(B, 10_000, np.int32),
                      k, False)

    def chunk_ms(k):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        n = loop.run(*args(k))[0]
        b.record()
        b.synchronize()
        if n != k:
            raise AssertionError(f"a {k}-tick chunk ran {n} ticks")
        return a.elapsed_time(b)

    chunk_ms(8)
    chunk_ms(1)
    one, eight = [], []
    for _ in range(CONST_REPS):
        one.append(chunk_ms(1))
        eight.append(chunk_ms(8))
    loop.close()
    del loop, cache
    out = dict(chunk1_ms=statistics.median(one),
               chunk8_ms=statistics.median(eight), chunk1_all=one,
               chunk8_all=eight)
    out["host_sync_s"] = (out["chunk1_ms"] - out["chunk8_ms"] / 8) / 1e3
    costs = []
    for rows, S in NEW_PREFILL_SHAPES:
        batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (rows, S),
                                         dtype=torch.int32, device=dev),
                 "lengths": torch.full((rows,), S, dtype=torch.int32,
                                       device=dev)}
        torch.cuda.synchronize()
        walls = []
        for _ in range(4):
            t = time.perf_counter()
            model.prefill(params, batch, max_len=64)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        costs.append(dict(shape=f"{rows}x{S}", first_ms=walls[0] * 1e3,
                          warm_ms=statistics.median(walls[1:]) * 1e3))
    out["prefills"] = costs
    out["compile_s"] = statistics.median(
        c["first_ms"] - c["warm_ms"] for c in costs) / 1e3
    log(f"[4l] planner constants at {PLANNER_ARCH} full width: a 1-tick "
        f"chunk {out['chunk1_ms']:.3f} ms, an 8-tick chunk "
        f"{out['chunk8_ms']:.3f} ms (B={B}, medians of {CONST_REPS} in "
        f"turns): HOST_SYNC_S = {out['host_sync_s']:.6f} s; a prefill at a "
        f"new (rows, length), first call less a warm one: "
        + ", ".join(f"{c['shape']} {c['first_ms']:.2f} - {c['warm_ms']:.2f}"
                    for c in costs)
        + f" ms: COMPILE_S = {out['compile_s']:.6f} s (median) [{smi}]")
    return out


def planner_main_path(rk, dev, smi, overload) -> dict:
    """Phase 4l: the planner on the card, rwkv6-1.6b (built anew after
    4k).  The planner's constants; ``autotune`` of the FCFS overload
    cell on the card and on the CPU (equal plans), its winner served at
    full width as the ``.../auto`` cell; the drift pair (the calm-tuned
    stale plan serving the drifted traffic traced, ``autotune_from_trace``
    of that trace, the replan serving it), each drive held to the same
    plan at reduced width on the CPU.  ``overload``: 4e's overload cell,
    logged beside the auto cell.  The hymba plan runs inside 4k."""
    import gc

    import torch

    from repro_torch.configs import SERVING_LOAD_SWEEP
    from repro_torch.kernels.decode_loop import decode_loop as dl
    from repro_torch.obs import Tracer
    from repro_torch.plan import WorkloadProfile
    from repro_torch.plan import planner
    from repro_torch.serving import workload as wl

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, params = build_rwkv(dev)
    cfg = model.cfg
    kernels = ((rk, "rwkv6_step"), (dl, "decode_loop"))
    want = lambda st: {"rwkv6_step": cfg.n_layers * st["decode_ticks"],
                       "decode_loop": st["decode_ticks"]
                       + st["decode_chunks"]}
    out = {"constants": planner_constants(model, params, dev, smi),
           "modeled": dict(host_sync_s=planner.HOST_SYNC_S,
                           compile_s=planner.COMPILE_S)}
    launches = {"rwkv6_step": 0, "decode_loop": 0}

    def served(key, run):
        out[key] = run
        for k in launches:
            launches[k] += run["launches"][k]
        return run

    # 1. the autotuned overload cell
    base = next(c for c in SERVING_LOAD_SWEEP
                if c.deadline_slack is not None and c.policy == "fcfs")
    call = lambda device=None: planner.autotune(
        base.arch, base.workload, seed=0, max_len=base.plan.max_len,
        device=device)
    for mod, key in kernels:
        mod.LAUNCHES[key] = 0
    auto, out["autotune_card"] = timed_autotune(
        "4l", f"autotune({base.name}'s workload) on the card", call, smi)
    out["probe_launches"] = {key: mod.LAUNCHES[key] for mod, key in kernels}
    auto_cpu, out["autotune_cpu"] = timed_autotune(
        "4l", "the same call with device='cpu'",
        lambda: call("cpu"), smi)
    same_plans("4l", "the card's autotune and the CPU's", auto, auto_cpu)
    full = dataclasses.replace(auto, reduced=False)
    name = f"{base.arch}/b{auto.max_batch}/r{base.rate:g}/heavy/auto"
    items = wl.profile_items(base.workload, vocab_size=cfg.vocab_size,
                             seed=0)
    run = served("auto", planned_cell("4l", name, model, params, full, items,
                                      kernels, want, smi))
    small = reduced_cpu_model(PLANNER_ARCH)
    cpu = reduced_cpu_cell(full, items, small)
    same_view("4l", name, run["view"], cpu["view"])
    slo = run["agg"]["slo"]["attainment"]
    slo_e = overload["agg"]["slo"]["attainment"]
    log(f"[4l] {name}: SLO attainment {slo:.4f} in {run['stats']['ticks']} "
        f"ticks beside 4e's {overload['name']}: {slo_e:.4f} in "
        f"{overload['stats']['ticks']} ticks")
    run["beside"] = dict(name=overload["name"], slo=slo_e,
                         ticks=overload["stats"]["ticks"])

    # 2. the drift pair
    calm = WorkloadProfile(**DRIFT_CALM)
    drift = WorkloadProfile(**DRIFT_WORKLOAD)
    stale, out["stale_autotune"] = timed_autotune(
        "4l", "autotune(the calm profile) on the card",
        lambda: planner.autotune(PLANNER_ARCH, calm, seed=0, max_len=64),
        smi)
    stale_cpu, _ = timed_autotune(
        "4l", "the same call with device='cpu'",
        lambda: planner.autotune(PLANNER_ARCH, calm, seed=0, max_len=64,
                                 device="cpu"), smi)
    same_plans("4l", "the stale plan on the card and on the CPU", stale,
               stale_cpu)
    items = wl.profile_items(drift, vocab_size=cfg.vocab_size, seed=0)
    tracer = Tracer()
    name = f"{PLANNER_ARCH}/b{stale.max_batch}/r0.9/heavy/drift-stale"
    run = served("stale", planned_cell(
        "4l", name, model, params, dataclasses.replace(stale, reduced=False),
        items, kernels, want, smi, tracer=tracer))
    cpu = reduced_cpu_cell(stale, items, small, traced=True)
    same_view("4l", name, run["view"], cpu["view"])
    same = tracer.dumps() == cpu["trace"]
    log(f"[4l] {name}: the card's trace ({len(tracer)} events) byte-equal "
        f"to the reduced CPU run's: {same}")
    if not same:
        raise AssertionError("the drift trace differs from the CPU's")
    replan, out["replan_autotune"] = timed_autotune(
        "4l", "autotune_from_trace(the card's trace) on the card",
        lambda: planner.autotune_from_trace(
            PLANNER_ARCH, tracer, seed=0, max_len=64,
            duration=drift.duration), smi)
    replan_cpu, _ = timed_autotune(
        "4l", "the same pipeline on the CPU (its own trace)",
        lambda: planner.autotune_from_trace(
            PLANNER_ARCH, cpu["tracer"], seed=0, max_len=64,
            duration=drift.duration, device="cpu"), smi)
    same_plans("4l", "the replan on the card and on the CPU", replan,
               replan_cpu)
    name = f"{PLANNER_ARCH}/b{replan.max_batch}/r0.9/heavy/drift-replan"
    rep = served("replan", planned_cell(
        "4l", name, model, params, dataclasses.replace(replan, reduced=False),
        items, kernels, want, smi))
    same_view("4l", name, rep["view"],
              reduced_cpu_cell(replan, items, small)["view"])
    s_slo = run["agg"]["slo"]["attainment"]
    r_slo = rep["agg"]["slo"]["attainment"]
    ok = replan.max_batch > stale.max_batch and r_slo > s_slo
    log(f"[4l] drift pair: replan {replan.summary()} against stale "
        f"{stale.summary()}: max_batch {replan.max_batch} > "
        f"{stale.max_batch} and SLO attainment {r_slo:.4f} > {s_slo:.4f}: "
        f"{ok}; fitted {replan.provenance['observed_traffic']['fitted_profile']}")
    if not ok:
        raise AssertionError("the replan does not beat the stale plan")
    out["launches"] = launches
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[4l] phase 4l (rwkv6-1.6b): {out['phase_s']:.1f} s; launches of "
        f"the served cells {launches} [{smi}]")
    return out


def watch_tiles(fa, fd):
    """Record the tiles the flash wrappers launch with: (Sq, Skv, bq, bk)
    of each prefill launch and (slots, window, bk) of each decode launch
    (the decode graph's capture included).  Returns (seen, undo)."""
    seen = dict(prefill=set(), decode=set())
    real_fa, real_fd = fa._launch, fd._launch

    def fa_launch(q, k, v, q_pos, kv_pos, causal, window, softcap, bq, bk):
        seen["prefill"].add((q.shape[2], k.shape[2], bq, bk))
        return real_fa(q, k, v, q_pos, kv_pos, causal, window, softcap, bq,
                       bk)

    def fd_launch(q, k, v, kv_pos, q_pos, causal, window, softcap, bk):
        seen["decode"].add((k.shape[2], window, bk))
        return real_fd(q, k, v, kv_pos, q_pos, causal, window, softcap, bk)

    fa._launch, fd._launch = fa_launch, fd_launch

    def undo():
        fa._launch, fd._launch = real_fa, real_fd
    return seen, undo


def hymba_planner(model, params, fa, fd, dl, smi, cpu) -> dict:
    """Phase 4l's hymba plan, on 4k's tree before it is freed:
    ``autotune`` of SERVING_LOAD_SWEEP's base profile at rate 1.0 (max_len
    64, max_batches 2, 4, 8) on the card; the plan valid, with an
    ``"attn"`` entry and a persistent ``"swa_ssm"`` entry with its
    evidence; served at full width: the flash counters 32 x prefill calls
    and 32 x decode ticks, the model given the plan's ``"attn"`` entry,
    and every tile the wrappers ran with the planned bq/bk and chunk made
    legal by the adapters; its deterministic view equal to the reduced
    CPU run's (``cpu``: the reduced (model, params)).  Then the plan with
    ``ODD_ATTN`` at ``ODD_MAX_LEN`` on four requests, held the same way,
    and its prefill and decode tiles other than the defaults' made
    legal."""
    import numpy as np
    import torch

    from repro_torch import hw
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_tiles)
    from repro_torch.kernels.flash_attention.flash_decode import decode_bk
    from repro_torch.kernels.flash_attention.ops import (
        DEFAULT_BK, DEFAULT_BQ, DEFAULT_DECODE_BK)
    from repro_torch.plan import WorkloadProfile
    from repro_torch.plan import planner
    from repro_torch.serving import workload as wl

    t_phase = time.perf_counter()
    cfg = model.cfg
    profile = WorkloadProfile(kind="poisson", rate=HYMBA_PLAN_RATE,
                              prompt_len=(4, 12), max_new_tokens=(6, 10),
                              prompt_len_long=63)
    plan, info = timed_autotune(
        "4l", f"autotune({HYMBA_ARCH}, base profile r{HYMBA_PLAN_RATE:g}) "
        f"on the card", lambda: planner.autotune(
            HYMBA_ARCH, profile, seed=0, max_len=64,
            max_batches=HYMBA_PLAN_BATCHES), smi)
    plan.validate()
    tp = plan.tile_plans
    ssm = tp.get("swa_ssm", {})
    ok = (set(tp) == {"attn", "swa_ssm"} and ssm.get("persistent") is True
          and ssm.get("resident") is True
          and ssm.get("vmem_bytes", 1 << 30) <= hw.smem_budget()
          and tp["attn"].get("bq", 0) > 0 and tp["attn"].get("bk", 0) > 0)
    log(f"[4l] {HYMBA_ARCH} plan {plan.summary()}: tiles {tp}; an attn "
        f"entry and a persistent swa_ssm entry with its evidence (resident,"
        f" {ssm.get('vmem_bytes')} shared-memory bytes a CTA of "
        f"{hw.smem_budget()}): {ok}; cache layout {plan.cache_layout}, "
        f"modeled bytes {info['layouts']}")
    if not ok:
        raise AssertionError("the hymba plan lacks its tile entries")
    kernels = ((fa, "flash_attention"), (fd, "flash_decode"),
               (dl, "decode_loop"))
    want = lambda st: {
        "flash_attention": cfg.n_layers * st["prefill_calls"],
        "flash_decode": cfg.n_layers * st["decode_ticks"],
        "decode_loop": st["decode_ticks"] + st["decode_chunks"]}
    items = wl.profile_items(profile, vocab_size=cfg.vocab_size, seed=0,
                             duration=32.0)
    seen, undo = watch_tiles(fa, fd)

    def held(attn, apart):
        """Hold the wrappers' tiles to ``attn`` made legal by the
        adapters; ``apart``: some tile must differ from the defaults'."""
        def tiles(eng):
            given = eng.model.tile_plans.get("attn") == attn
            pre = sorted(seen["prefill"])
            dec = sorted(seen["decode"])
            legal = all(
                (bq, bk) == kernel_tiles(attn["bq"], attn["bk"], sq, skv)
                for sq, skv, bq, bk in pre) and all(
                bk == decode_bk(attn["bk"], s) for s, _, bk in dec)
            differ = (
                any((bq, bk) != kernel_tiles(DEFAULT_BQ, DEFAULT_BK, sq, skv)
                    for sq, skv, bq, bk in pre),
                any(bk != decode_bk(DEFAULT_DECODE_BK, s)
                    for s, _, bk in dec))
            log(f"[4l] {HYMBA_ARCH}: the model runs the plan's attn entry: "
                f"{given}; prefill launches (Sq, Skv, bq, bk) {pre}, decode "
                f"launches (slots, window, bk) {dec}: each the plan's bq "
                f"{attn['bq']} / bk {attn['bk']} made legal by kernel_tiles "
                f"/ decode_bk: {legal}; prefill and decode tiles other than "
                f"the defaults' (bq {DEFAULT_BQ} / bk {DEFAULT_BK}, decode "
                f"bk {DEFAULT_DECODE_BK}) made legal: {differ}")
            if not (given and legal and pre and dec) or (
                    apart and not all(differ)):
                raise AssertionError("the flash kernels ran off the planned "
                                     "tiles")
            seen["prefill"].clear()
            seen["decode"].clear()
            return dict(prefill=pre, decode=dec, differ=differ)
        return tiles

    name = f"{HYMBA_ARCH}/b{plan.max_batch}/r{HYMBA_PLAN_RATE:g}/auto"
    # the autotuned plan's attn entry made legal equals the defaults made
    # legal at max_len 64, so the plan is served again with an attn entry
    # and a max_len at which both adapters keep it apart from them
    odd = dataclasses.replace(
        plan, reduced=False, max_len=ODD_MAX_LEN, buckets=ODD_BUCKETS,
        tile_plans={**tp, "attn": dict(ODD_ATTN)}).validate()
    rng = np.random.default_rng(0)
    odd_items = [wl.WorkloadItem(
        t=0.0, prompt=tuple(int(x) for x in rng.integers(0, cfg.vocab_size, n)),
        max_new_tokens=6) for n in ODD_PROMPTS]
    try:
        run = planned_cell("4l", name, model, params,
                           dataclasses.replace(plan, reduced=False), items,
                           kernels, want, smi, tiles=held(tp["attn"], False))
        odd_run = planned_cell("4l", f"{name}/bq128-bk32/len{ODD_MAX_LEN}",
                               model, params, odd,
                               odd_items, kernels, want, smi,
                               tiles=held(odd.tile_plans["attn"], True))
    finally:
        undo()
    same_view("4l", name, run["view"],
              reduced_cpu_cell(plan, items, cpu)["view"])
    torch.cuda.synchronize()
    out = dict(autotune_card=info, cell=run, odd_tiles=odd_run,
               launches={k: v + odd_run["launches"][k]
                         for k, v in run["launches"].items()},
               phase_s=time.perf_counter() - t_phase)
    log(f"[4l] phase 4l ({HYMBA_ARCH}): {out['phase_s']:.1f} s [{smi}]")
    return out


def trace_qwen_main_path(model, params, smi) -> dict:
    """Phase 4h on 4c's qwen2.5-14b tree (after 4f and 4g):
    ``qwen2.5-14b/b4/r1/paged16`` traced twice and its dense cell
    ``qwen2.5-14b/b4/r1`` once.  Fatal: the two paged traces' bytes
    equal, ``check_trace``; the three fragmentation counters at every
    ``util`` tick; the paged trace without them the dense cell's bytes;
    stamps, ``stats()`` and launches of the two paged drives equal; no
    tensor moved."""
    import dataclasses

    from repro_torch.configs import serving_cell
    from repro_torch.obs import dumps_trace_doc
    from repro_torch.serving import workload as wl

    t0 = time.perf_counter()
    name = "qwen2.5-14b/b4/r1/paged16"
    cell = serving_cell(name)
    plan = dataclasses.replace(cell.plan, reduced=False)
    dense_plan = dataclasses.replace(plan, cache_layout="dense")
    items = wl.profile_items(cell.workload, vocab_size=model.cfg.vocab_size,
                             seed=0, duration=32.0)
    a, b = (traced_drive(model, params, plan, items, True) for _ in (0, 1))
    check_traced("4h", name, [a, b])
    d = traced_drive(model, params, dense_plan, items, True)
    ev = a["tracer"].events
    util = [e.ts for e in ev if e.name == "util"]
    frag = all([e.ts for e in ev if e.name == c] == util
               for c in FRAG_COUNTERS)
    doc = a["tracer"].to_chrome()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e["name"] not in FRAG_COUNTERS]
    same_dense = dumps_trace_doc(doc) == d["tracer"].dumps()
    same = a["view"] == b["view"] and a["launches"] == b["launches"]
    moved = a["moved"] + b["moved"] + d["moved"]
    out = dict(name=name, walls=[a["wall"], b["wall"]],
               dense_wall=d["wall"], events=len(a["tracer"]),
               dense_events=len(d["tracer"]),
               trace_bytes=len(a["tracer"].dumps().encode()),
               event_counts=event_counts(a["tracer"]),
               frag_at_every_util=frag, same_as_dense=same_dense,
               same_runs=same, moved=moved,
               hook_ms=[1e3 * r["hook_s"] for r in (a, b)],
               dense_hook_ms=1e3 * d["hook_s"])
    log(f"[4h] {name}: traced drives {[round(x, 3) for x in out['walls']]} "
        f"s (inside the tracer's and the live window's calls and the "
        f"fragmentation counters' reads "
        f"{[round(x, 3) for x in out['hook_ms']]} ms, {a['hook_calls']} "
        f"calls), its dense cell traced {d['wall']:.3f} s "
        f"({out['dense_hook_ms']:.3f} ms, {d['hook_calls']} calls; host "
        f"clock); "
        f"{out['events']} events ({out['dense_events']} dense), "
        f"{out['trace_bytes']} bytes; the fragmentation counters at every "
        f"util tick ({len(util)}): {frag}; without them the dense cell's "
        f"trace byte for byte: {same_dense}; the two drives' stamps, "
        f"stats() and launches equal: {same}; tensors moved: {moved} "
        f"[{smi}]")
    if not (frag and same_dense and same) or moved:
        raise AssertionError(f"{name}: the paged trace is not the dense "
                             f"cell's with the fragmentation counters")
    out["phase_s"] = time.perf_counter() - t0
    log(f"[4h] phase 4h (qwen2.5-14b): {out['phase_s']:.1f} s [{smi}]")
    return out


def graph_tick_timings(tag, model, params, max_len, dev, smi) -> dict:
    """The decode tick as the engine now runs it, at B=1 and B=4 on a
    fresh cache (every slot active, the budget never reached): the
    capture's time and its graph pool; ms a tick of a replayed 8-tick
    chunk and of a 1-tick chunk (CUDA events around the whole chunk: the
    inputs' upload, the graph launch and the one read), the same chunks
    run eagerly (the tick in a Python loop, a host read of go each tick),
    and one replayed 8-tick chunk under ``torch.profiler``: the device
    operations it recorded against those the graph ran (its nodes, a
    tick's times the ticks, the init, the upload and the read), and,
    where that record is whole (within 1 %), the device's busy share
    within that profiled run (the union of its activities over their
    span).  The profiler has left out iterations of a while node: all but
    the first in a graph instantiated before its first session, so the
    phases profile an eager tick first."""
    import numpy as np
    import torch

    from repro_torch.serving.decode_graph import DecodeLoop
    from repro_torch.serving.sampler import SamplerConfig

    out = {}
    for B in (1, 4):
        args = lambda k: (np.zeros(B, np.int32), np.ones(B, bool),
                          np.full(B, -1, np.int32),
                          np.full(B, 10_000, np.int32), k, False)
        for k in (8, 1):
            cache = model.init_cache(B, max_len, dev)
            loop = DecodeLoop(model, params, cache, SamplerConfig(), max_len,
                              k)
            eager = DecodeLoop(model, params, cache, SamplerConfig(),
                               max_len, k, graph=False)
            key = f"b{B}_k{k}"
            out[f"capture_s_{key}"] = loop.capture_s
            out[f"pool_gb_{key}"] = loop.pool_bytes / 1e9
            out[f"tick_nodes_{key}"] = dict(loop.tick_nodes)
            for name, lp in (("graph", loop), ("eager", eager)):
                # a fresh cache each rep would cost a copy; lengths grow by
                # k a chunk, a few dozen slots over the reps of max_len
                out[f"{name}_tick_ms_{key}"] = events_ms(
                    lambda lp=lp: lp.run(*args(k)), 5) / k
            if k == 8:
                runs = []      # the profiled chunk's is the last
                bz = device_busy(lambda: runs.append(loop.run(*args(k))),
                                 out[f"graph_tick_ms_{key}"] * k)
                out[f"busy_{key}"] = bz
                out[f"profiled_ticks_{key}"] = int(runs[-1][0])
                ran = lambda nodes: (nodes["kernel"] + nodes["memcpy"]
                                     + nodes["memset"])
                # every node a tick's n times, the init, the chunk's upload
                # and its read
                n = out[f"profiled_ticks_{key}"]
                out[f"device_ops_want_{key}"] = (
                    ran(loop.tick_nodes) * n + ran(loop.chunk_nodes) + 2)
            loop.close()
            del loop, eager, cache
            torch.cuda.empty_cache()
        bz = out[f"busy_b{B}_k8"]
        timed = out[f"graph_tick_ms_b{B}_k8"] * 8
        want = out[f"device_ops_want_b{B}_k8"]
        # busy and idle within the profiled run alone (the profiler
        # stretches a replayed graph, so its span is not the timed
        # chunk's), and only where its record of the chunk is whole: it
        # has left out iterations of a while node
        whole = bz["kernels"] >= 0.99 * want > 0
        out[f"idle_share_b{B}"] = 1 - bz["span_share"] if whole else None
        nodes = out[f"tick_nodes_b{B}_k8"]
        top = ", ".join(f"{n[:40]} {us:.0f} us" for n, us in bz["top"])
        busy = (f"{bz['kernels']} device operations recorded of the {want} "
                f"the graph ran ({nodes} nodes a tick x "
                f"{out[f'profiled_ticks_b{B}_k8']} ticks, the init, "
                f"the upload and the read); ")
        busy += (f"busy {bz['union_ms']:.3f} ms of the profiled run's "
                 f"{bz['span_ms']:.3f} ms device span (idle "
                 f"{100 * out[f'idle_share_b{B}']:.1f} % within that run; "
                 f"its span {bz['span_ms'] / timed:.2f} x the timed "
                 f"{timed:.3f} ms chunk; kernel time summed "
                 f"{bz['busy_ms']:.3f} ms); largest (names inside a graph "
                 f"unreliable): {top}"
                 if whole else "the record is not whole: idle share not "
                 "measured")
        log(f"[{tag}] B={B} graph tick: capture {out[f'capture_s_b{B}_k8']:.2f}"
            f" s (8-tick chunk), {out[f'capture_s_b{B}_k1']:.2f} s (1-tick), "
            f"graph pool {out[f'pool_gb_b{B}_k8'] * 1e3:.1f} MB; "
            f"{out[f'graph_tick_ms_b{B}_k8']:.3f} ms a tick of a replayed "
            f"8-tick chunk, {out[f'graph_tick_ms_b{B}_k1']:.3f} ms a 1-tick "
            f"chunk; eager {out[f'eager_tick_ms_b{B}_k8']:.3f} / "
            f"{out[f'eager_tick_ms_b{B}_k1']:.3f} ms; replayed 8-tick chunk "
            f"under the profiler: {busy} [{smi}]")
    return out


def lm_main_path(rk, dev, spec, smi) -> dict:
    """Phase 4b: rwkv6-1.6b at full width through the port's engine."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_loop import decode_loop as dl
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv_step.ref import rwkv6_step_ref
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, dev)
    perturb_zero_init(params, gen)
    params = model.serving_params(params)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[4b] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv.head_dim} wkv heads of "
        f"{cfg.rwkv.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}: "
        f"{n_par / 1e9:.3f} B params, {wbytes / 1e9:.2f} GB as served "
        f"(dot-only leaves bf16), built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(16, 201))).tolist()
               for _ in range(8)]
    max_new, max_len, max_batch = 32, 256, 4

    def serve(tile_plans=None, sync_every=1, reference=False):
        eng = ServingEngine(model, params, max_batch=max_batch,
                            max_len=max_len, tile_plans=tile_plans,
                            sync_every=sync_every)
        tally = attach_eager_reference(eng) if reference else None
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        if reference:
            check_graph_run("4b", eng, tally)
            eng.reference_tally = tally
        return eng, reqs, time.perf_counter() - t

    rk.LAUNCHES["rwkv6_step"] = 0
    dl.LAUNCHES["decode_loop"] = 0
    eng, reqs, _ = serve(reference=True)
    launches = rk.LAUNCHES["rwkv6_step"]
    loop_launches = dl.LAUNCHES["decode_loop"]
    st = eng.stats()
    log(f"[4b] engine: {st}")
    log(f"[4b] rwkv6_step launches {launches} = {cfg.n_layers} layers x "
        f"{st['decode_ticks']} decode ticks: "
        f"{launches == cfg.n_layers * st['decode_ticks']}; decode_loop "
        f"launches {loop_launches} = {st['decode_ticks']} ticks + "
        f"{st['decode_chunks']} chunk inits: "
        f"{loop_launches == st['decode_ticks'] + st['decode_chunks']}")
    if launches != cfg.n_layers * st["decode_ticks"] or launches <= 0:
        raise AssertionError("rwkv6_step launches != layers x decode ticks")
    if loop_launches != st["decode_ticks"] + st["decode_chunks"]:
        raise AssertionError("decode_loop launches != ticks + chunks")
    if not all(r.done and len(r.output) == max_new for r in reqs):
        raise AssertionError("a request did not produce its tokens")
    if not all(0 <= t < cfg.padded_vocab for r in reqs for t in r.output):
        raise AssertionError("a token outside the vocabulary")
    before = rk.LAUNCHES["rwkv6_step"]
    eng4, reqs4, _ = serve(sync_every=4, reference=True)
    if rk.LAUNCHES["rwkv6_step"] - before != \
            cfg.n_layers * eng4.stats()["decode_ticks"]:
        raise AssertionError("rwkv6_step launches != layers x decode ticks "
                             "at sync_every=4")
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, len(r.output))
                         for r in rs]
    log(f"[4b] sync_every=4: the same tick stamps as at 1: "
        f"{stamps(reqs4) == stamps(reqs)}; greedy tokens equal "
        f"{sum(a == b for r, q in zip(reqs, reqs4) for a, b in zip(r.output, q.output))}"
        f"/{len(reqs) * max_new}")
    del eng4

    before = rk.LAUNCHES["rwkv6_step"]
    eng_p, reqs_p, _ = serve({"rwkv": {"impl": "plain"}})
    if rk.LAUNCHES["rwkv6_step"] != before:
        raise AssertionError("the plain path launched the kernel")
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, len(r.output))
                         for r in rs]
    same_sched = stamps(reqs) == stamps(reqs_p) and \
        eng.util_history == eng_p.util_history
    same_tok = sum(a == b for r, q in zip(reqs, reqs_p)
                   for a, b in zip(r.output, q.output))
    log(f"[4b] plain path: same tick schedule {same_sched}; free-running "
        f"greedy tokens equal {same_tok}/{len(reqs) * max_new}")
    if not same_sched:
        raise AssertionError("kernel and plain paths scheduled differently")

    # teacher-forced: both paths fed the kernel run's tokens
    plain = model.with_tile_plans({"rwkv": {"impl": "plain"}})
    first4 = reqs[:4]
    S = eng.bucket(max(len(r.prompt) for r in first4))
    toks = torch.zeros((4, S), dtype=torch.int32)
    for i, r in enumerate(first4):
        toks[i, :len(r.prompt)] = torch.tensor(r.prompt)
    lens = torch.tensor([len(r.prompt) for r in first4], dtype=torch.int32)
    cache, logits0 = model.prefill(params, {"tokens": toks.to(dev),
                                            "lengths": lens.to(dev)})
    def rel_errs(ca, la, cb, lb):
        """Logits and worst per-layer wkv-state difference, each relative
        to the plain side's largest magnitude."""
        if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
            raise AssertionError("non-finite logits")
        sa, sb = ca["blocks"]["p0"]["wkv_state"], cb["blocks"]["p0"][
            "wkv_state"]
        e_s = max(max_err(sa[i], sb[i]) / float(sb[i].abs().max())
                  for i in range(cfg.n_layers))
        return max_err(la, lb) / float(lb.abs().max()), e_s

    # step by step: both paths take the same cache (the plain chain's) and
    # the same token, so each comparison holds one decode step
    # chained: each path carries its own cache for all the steps, so the
    # per-step differences compound (reported; a gross-error guard only)
    ck = cp = cache
    step = dict(logit=0.0, state=0.0, agree=0)
    chain = dict(logit=0.0, state=0.0, agree=0)
    for j in range(max_new - 1):
        t = torch.tensor([r.output[j] for r in first4], dtype=torch.int32,
                         device=dev)
        c1, l1 = model.decode_step(params, cp, t)
        ck, lk = model.decode_step(params, ck, t)
        cp, lp = plain.decode_step(params, cp, t)
        for acc, (ca, la) in ((step, (c1, l1)), (chain, (ck, lk))):
            e_l, e_s = rel_errs(ca, la, cp, lp)
            acc["logit"] = max(acc["logit"], e_l)
            acc["state"] = max(acc["state"], e_s)
            acc["agree"] += int((la.argmax(-1) == lp.argmax(-1)).sum())
    n_cmp = 4 * (max_new - 1)
    for name, acc, lim in (("one step", step, LM_REL),
                           ("chained", chain, LM_CHAIN_GUARD)):
        log(f"[4b] teacher-forced, {name}, {max_new - 1} steps x 4 rows: "
            f"max |logits k-p|/max|logits| = {acc['logit']:.3e}, max "
            f"per-layer |wkv_state k-p|/max|state| = {acc['state']:.3e} "
            f"(limit {lim}); argmax agrees {acc['agree']}/{n_cmp}")
        if not (acc["logit"] <= lim and acc["state"] <= lim):
            raise AssertionError(f"kernel and plain LM paths disagree "
                                 f"({name})")
    e_logit, e_state, agree = step["logit"], step["state"], step["agree"]

    # ---- timings, each in its own calls --------------------------------
    out = dict(launches=launches, loop_launches=loop_launches,
               graph_launches=eng.reference_tally["graph"],
               nodes_per_tick=eng._loop.per_tick_launches(),
               decode_ticks=st["decode_ticks"],
               stats=st, step_logit_rel=e_logit, step_state_rel=e_state,
               step_argmax_agree=agree, chained_logit_rel=chain["logit"],
               chained_state_rel=chain["state"],
               chained_argmax_agree=chain["agree"], argmax_compared=n_cmp,
               free_running_tokens_equal=same_tok)
    H, K = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    for B in (1, 4):
        c = model.init_cache(B, max_len, dev)
        tk = torch.zeros((B,), dtype=torch.int32, device=dev)
        for name, m in (("tick", model), ("tick_plain", plain)):
            out[f"{name}_ms_b{B}"] = events_ms(
                lambda: m.decode_step_(params, c, tk).argmax(-1), 10)
        # the decode step, T=1 at the model's default geometry: the device
        # time of a call from a CUDA graph of one tick's layers, each on
        # its own operands (at B=4 their states exceed the 50 MB L2, as a
        # tick's do), and a call back to back with the host in
        sets = [rwkv_operands(1, B, H, K, K, dev, seed=500 + 24 * B + i)
                for i in range(cfg.n_layers)]
        out[f"step_ms_b{B}"] = graph_ms([lambda o=o: rk.rwkv6_step(*o)
                                         for o in sets])
        o = sets[0]
        out[f"step_host_in_ms_b{B}"] = events_ms(
            lambda: rk.rwkv6_step(*o), 7, inner=50)
        out[f"step_plain_ms_b{B}"] = events_ms(lambda: rwkv6_step_ref(*o),
                                               7, inner=20)
        # least work: the f32 state read and written once; r, k, v (bf16),
        # w and u (f32) read and y (bf16) written once; per state element
        # ~6 f32 operations (two products and sums for y, decay update)
        nbytes = (2 * B * H * K * K * 4 + 3 * B * H * K * 2 + B * H * K * 4
                  + H * K * 4 + B * H * K * 2)
        ops = 6.0 * B * H * K * K
        b_bytes = nbytes / spec.hbm_bw * 1e3
        b_ops = ops / spec.peak_fp32_flops * 1e3
        out[f"step_bound_ms_b{B}"] = max(b_bytes, b_ops)
        out[f"step_bound_by_b{B}"] = "bytes" if b_bytes >= b_ops \
            else "operations"
        out[f"kernel_share_b{B}"] = (cfg.n_layers * out[f"step_ms_b{B}"]
                                     / out[f"tick_ms_b{B}"])
    # device busy share of one tick, from a profiler trace (kernels on
    # the device's timeline against the tick's CUDA-event time above)
    for B in (1, 4):
        c = model.init_cache(B, max_len, dev)
        tk = torch.zeros((B,), dtype=torch.int32, device=dev)
        out[f"busy_b{B}"] = device_busy(
            lambda: model.decode_step_(params, c, tk).argmax(-1),
            out[f"tick_ms_b{B}"])
        # rwkv6_step's own device time a launch inside that tick
        out[f"step_tick_ms_b{B}"] = kernel_ms(
            out[f"busy_b{B}"], ("rwkv6_step",)) / cfg.n_layers
    pre_tok = torch.randint(0, cfg.vocab_size, (4, 128), device=dev,
                            dtype=torch.int32)
    pre_len = torch.tensor([128, 100, 64, 17], dtype=torch.int32,
                           device=dev)
    out["prefill_ms_4x128"] = events_ms(
        lambda: model.prefill(params, {"tokens": pre_tok,
                                       "lengths": pre_len})[1], 5)
    out.update(graph_tick_timings("4b", model, params, max_len, dev, smi))
    _, reqs_w, wall = serve()
    n_tok = sum(len(r.output) for r in reqs_w)
    out["run_s"] = wall
    out["tokens_per_s"] = n_tok / wall
    _, _, wall4 = serve(sync_every=4)
    out["run_s_sync4"] = wall4
    out["tokens_per_s_sync4"] = n_tok / wall4
    # the kernels line reports the engine's shape, B = max_batch = 4: ms is
    # the device time of a call from the graph
    out["step_ms"] = out["step_ms_b4"]
    out["step_plain_ms"] = out["step_plain_ms_b4"]
    out["step_bound_ms"] = out["step_bound_ms_b4"]
    out["step_bound_by"] = out["step_bound_by_b4"]
    for B in (1, 4):
        log(f"[4b] B={B}: decode tick {out[f'tick_ms_b{B}']:.3f} ms (plain "
            f"path {out[f'tick_plain_ms_b{B}']:.3f}); rwkv6_step "
            f"{out[f'step_ms_b{B}'] * 1e3:.3f} us a call from a graph of "
            f"{cfg.n_layers}, {out[f'step_tick_ms_b{B}'] * 1e3:.3f} us a "
            f"launch in the tick (profiler), "
            f"{out[f'step_host_in_ms_b{B}'] * 1e3:.2f} us with the host in "
            f"(plain {out[f'step_plain_ms_b{B}'] * 1e3:.2f} us, bound "
            f"{out[f'step_bound_ms_b{B}'] * 1e3:.3f} us by "
            f"{out[f'step_bound_by_b{B}']}); kernel share of a tick "
            f"{cfg.n_layers} x step / tick = "
            f"{100 * out[f'kernel_share_b{B}']:.1f} %")
    for B in (1, 4):
        bz = out[f"busy_b{B}"]
        if not bz["kernels"]:
            log(f"[4b] B={B}: the profiler recorded no device kernels: busy "
                f"share not measured")
            continue
        top = ", ".join(f"{n[:48]} {us:.0f} us" for n, us in bz["top"])
        log(f"[4b] B={B} tick under the profiler: {bz['kernels']} kernels, "
            f"{bz['busy_ms']:.3f} ms busy on the device = "
            f"{100 * bz['busy_share']:.1f} % of the "
            f"{out[f'tick_ms_b{B}']:.3f} ms tick (idle "
            f"{100 * (1 - bz['busy_share']):.1f} %); largest: {top}")
    log(f"[4b] prefill 4 rows x bucket 128: {out['prefill_ms_4x128']:.3f} ms;"
        f" 8-request run through the graph engine: {n_tok} tokens in "
        f"{wall:.3f} s = {out['tokens_per_s']:.1f} tokens/s at sync_every=1, "
        f"{wall4:.3f} s = {out['tokens_per_s_sync4']:.1f} tokens/s at 4 "
        f"(host clock, warm) [{smi}]")
    return out


def flash_positions(lengths, S, device):
    """(B, S) int32: position i for i < lengths[b], else -1 (padding)."""
    import torch

    pos = torch.arange(S, dtype=torch.int32).expand(len(lengths), S).clone()
    pos[pos >= torch.tensor(lengths, dtype=torch.int32)[:, None]] = -1
    return pos.to(device)


def bf16_randn(gen, *shape, device):
    import torch

    return torch.randn(shape, generator=gen).to(device, torch.bfloat16)


def check_flash(fa, fd, dev) -> tuple:
    """Phase 3 for ``flash_attention`` and ``flash_decode``: each kernel
    against its plain version at qwen2.5-14b's shapes and around them.
    Returns the largest absolute error of each."""
    import torch

    from repro_torch.kernels.flash_attention import ref

    log(f"[3] flash tolerance: |kernel - plain| <= {FLASH_TOL[0]} + "
        f"{FLASH_TOL[1]} x |plain| (same f32 math in another sum order; "
        f"one bf16 ulp of p or of the output may flip); every output finite")
    errs = {"flash_attention": 0.0, "flash_decode": 0.0}

    def held(name, got, want, what):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite output ({what})")
        e = max_err(got, want)
        ok = bool(((got.float() - want.float()).abs() <= FLASH_TOL[0]
                   + FLASH_TOL[1] * want.float().abs()).all())
        errs[name] = max(errs[name], e)
        log(f"[3] {name} {what}: max|kernel-plain| = {e:.3e}, all finite")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    gen = torch.Generator().manual_seed(600)

    def same_bits(got, call, what):
        if not torch.equal(got, call()):
            raise AssertionError(f"flash_attention: {what} changed the "
                                 f"result")

    def prefill_case(B, H, Hkv, Sq, Skv, d, kw, bq, bk, q_pos, kv_pos):
        q = bf16_randn(gen, B, H, Sq, d, device=dev)
        k = bf16_randn(gen, B, Hkv, Skv, d, device=dev)
        v = bf16_randn(gen, B, Hkv, Skv, d, device=dev)
        bq, bk = fa.kernel_tiles(bq, bk, Sq, Skv)
        got = fa.flash_attention(q, k, v, q_pos, kv_pos, bq=bq, bk=bk, **kw)
        want = ref.flash_attention_plain(q, k, v, q_pos, kv_pos, bk=fa.SUB,
                                         **kw)
        torch.cuda.synchronize()
        what = (f"B={B} H={H}/{Hkv} Sq={Sq} Skv={Skv} d={d} {kw} bq={bq} "
                f"bk={bk}")
        held("flash_attention", got, want, what)
        # no tile changes a bit: the softmax steps by SUB keys and a tile
        # no row sees adds exactly 0
        for t in sorted({fa.kernel_tiles(tq, tk, Sq, Skv)
                         for tq in (fa.WG_ROWS, fa.MAX_BQ)
                         for tk in (fa.SUB, fa.MAX_BK)}):
            same_bits(got, lambda: fa.flash_attention(
                q, k, v, q_pos, kv_pos, bq=t[0], bk=t[1], **kw),
                f"the tile {t}")
        # a causal row that sees no key is the mean of V over all keys
        pad = q_pos < 0
        if kw.get("causal", True) and bool(pad.any()):
            mean = v.float().mean(dim=2).repeat_interleave(H // Hkv, dim=1)
            mean = mean[:, :, None].expand(B, H, Sq, d)
            held("flash_attention", got.transpose(1, 2)[pad],
                 mean.transpose(1, 2)[pad], f"{what}: padding rows against "
                 f"the mean of V")
        return q, k, v, got

    prefill = [  # B, H, Hkv, S, d, causal, window, softcap, bq, bk, lengths
        (4, 40, 8, 512, 128, True, 0, 0.0, 64, 64, [512, 500, 300, 17]),
        (4, 40, 8, 1023, 128, True, 0, 0.0, 64, 64, [1023, 1000, 600, 1]),
        (2, 4, 2, 100, 64, True, 32, 0.0, 32, 128, [100, 61]),
        (1, 2, 1, 77, 16, False, 0, 30.0, 16, 64, [77]),
        (1, 4, 4, 256, 128, True, 64, 50.0, 128, 192, [256]),
        # a batch row of padding alone, query tiles of real and padding
        # rows and of padding alone, at both bq
        (4, 8, 2, 320, 128, True, 0, 0.0, 128, 128, [0, 100, 64, 300]),
        (4, 8, 2, 320, 128, True, 0, 0.0, 64, 64, [0, 100, 64, 300]),
        # window and softcap through the skipped tiles at d 128
        (2, 8, 2, 640, 128, True, 100, 30.0, 128, 128, [640, 450]),
        # one case at each head dim
        (2, 6, 2, 200, 16, True, 0, 0.0, 128, 64, [200, 130]),
        (2, 6, 3, 200, 32, True, 0, 0.0, 64, 128, [200, 77]),
        (2, 6, 1, 200, 64, True, 0, 0.0, 128, 128, [200, 190]),
        (2, 6, 2, 200, 128, True, 0, 0.0, 64, 64, [200, 3]),
        # the MoE archs' 4-row bucket-512 prefill (phase 4j): qwen3-moe's
        # 32/4 heads of 128 (G = 8), granite-moe's 16/8 heads of 64 (G = 2)
        (4, 32, 4, 512, 128, True, 0, 0.0, 64, 64, [512, 500, 300, 17]),
        (4, 16, 8, 512, 64, True, 0, 0.0, 64, 64, [512, 500, 300, 17]),
        # hymba's 4 x 2048 prefill (phase 4k): 25/5 heads of 64 (G = 5),
        # window 1024 (its swa_ssm layers) and 0 (its attn layers)
        (4, 25, 5, 2048, 64, True, 1024, 0.0, 64, 64,
         [2048, 1500, 1100, 300]),
        (4, 25, 5, 2048, 64, True, 0, 0.0, 64, 64, [2048, 1500, 1100, 300]),
    ]
    main = {0} | set(range(len(prefill) - 4, len(prefill)))
    for i, (B, H, Hkv, S, d, causal, window, cap, bq, bk,
            lens) in enumerate(prefill):
        pos = flash_positions(lens, S, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v, got = prefill_case(B, H, Hkv, S, S, d, kw, bq, bk, pos, pos)
        if i in main:   # a main path's shape: three calls, one set of bits
            for _ in range(2):
                same_bits(got, lambda: fa.flash_attention(
                    q, k, v, pos, pos, bq=fa.MAX_BQ, bk=fa.MAX_BK, **kw),
                    "a repeated call")
            log(f"[3] flash_attention at a main path's shape (H={H}/{Hkv}, "
                f"d={d}): three calls bit-equal")
    # Sq != Skv: bucket-padded queries at the end of longer key rows
    B, Sq, Skv, kv_len, q_len = 3, 96, 320, [320, 250, 40], [96, 70, 5]
    kv_pos = flash_positions(kv_len, Skv, dev)
    q_pos = torch.full((B, Sq), -1, dtype=torch.int32)
    for b in range(B):
        q_pos[b, :q_len[b]] = torch.arange(kv_len[b] - q_len[b], kv_len[b])
    prefill_case(B, 8, 2, Sq, Skv, 128, dict(causal=True), 128, 128,
                 q_pos.to(dev), kv_pos)
    def decode_case(B, H, Hkv, S, d, kw, kv_pos, q_pos, what):
        q = bf16_randn(gen, B, H, d, device=dev)
        k = bf16_randn(gen, B, Hkv, S, d, device=dev)
        v = bf16_randn(gen, B, Hkv, S, d, device=dev)
        got = fd.flash_decode(q, k, v, kv_pos, q_pos, **kw)
        want = ref.flash_decode_plain(q, k, v, kv_pos, q_pos, **kw)
        torch.cuda.synchronize()
        held("flash_decode", got, want, f"B={B} H={H}/{Hkv} slots={S} d={d} "
             f"{kw} {what}")
        return q, k, v, got

    decode = [  # B, H, Hkv, S, d, bk, causal, window, softcap, filled
        (4, 40, 8, 1024, 128, 128, True, 0, 0.0, [532, 400, 250, 17]),
        (1, 40, 8, 1024, 128, 128, True, 0, 0.0, [1024]),
        (2, 4, 2, 300, 64, 128, True, 64, 0.0, [300, 200]),
        (1, 2, 2, 77, 16, 32, False, 0, 30.0, [77]),
        # every chunk a plan may ask for at the main path's shape
        (4, 40, 8, 1024, 128, 64, True, 0, 0.0, [532, 400, 250, 17]),
        (4, 40, 8, 1024, 128, 256, True, 0, 0.0, [532, 400, 250, 17]),
        (4, 40, 8, 1024, 128, 512, True, 0, 0.0, [532, 400, 250, 17]),
        # G = 16 at d 128, a ragged last chunk
        (2, 32, 2, 600, 128, 128, True, 0, 0.0, [600, 333]),
        # the MoE archs' decode over 1024 slots with holes (phase 4j):
        # qwen3-moe (G = 8, d 128), granite-moe (G = 2, d 64)
        (4, 32, 4, 1024, 128, 128, True, 0, 0.0, [532, 400, 250, 17]),
        (4, 16, 8, 1024, 64, 128, True, 0, 0.0, [532, 400, 250, 17]),
        # hymba's global layers (phase 4k): 25/5 heads of 64 over 2048
        (4, 25, 5, 2048, 64, 128, True, 0, 0.0, [1532, 1100, 250, 17]),
    ]
    main = {0, len(decode) - 3, len(decode) - 2, len(decode) - 1}
    for i, (B, H, Hkv, S, d, bk, causal, window, cap,
            filled) in enumerate(decode):
        kv_pos = flash_positions(filled, S, dev)
        kv_pos[:, torch.arange(S, device=dev) % 7 == 5] = -1   # ring holes
        q_pos = torch.tensor(filled, dtype=torch.int32, device=dev) - 1
        kw = dict(causal=causal, window=window, softcap=cap, bk=bk)
        q, k, v, got = decode_case(B, H, Hkv, S, d, kw, kv_pos, q_pos,
                                   f"filled={filled}")
        if i in main:   # a main path's shape: three calls, one set of bits
            for _ in range(2):
                if not torch.equal(got, fd.flash_decode(q, k, v, kv_pos,
                                                        q_pos, **kw)):
                    raise AssertionError("flash_decode: a repeated call "
                                         "changed the result")
            log(f"[3] flash_decode at a main path's shape (H={H}/{Hkv}, "
                f"d={d}): three calls bit-equal")
    # a wrapped ring cache (slot s holds the last position congruent to s,
    # so slot order is not position order) under a window
    S, last = 1024, torch.tensor([1500, 2100], dtype=torch.int32)
    kv_pos = last[:, None] - torch.remainder(last[:, None] - torch.arange(
        S, dtype=torch.int32)[None], S)
    kv_pos[:, torch.arange(S) % 7 == 5] = -1
    decode_case(2, 40, 8, S, 128, dict(window=300, bk=128), kv_pos.to(dev),
                last.to(dev), "ring layout, positions 1500 and 2100")
    # hymba's swa_ssm layers (phase 4k): a wrapped 1024-slot ring under
    # window 1024, 25/5 heads of 64, with holes; three calls bit-equal
    last = torch.tensor([1531, 2047, 1100, 1030], dtype=torch.int32)
    kv_pos = last[:, None] - torch.remainder(last[:, None] - torch.arange(
        S, dtype=torch.int32)[None], S)
    kv_pos[:, torch.arange(S) % 7 == 5] = -1
    kw = dict(window=1024, bk=128)
    q, k, v, got = decode_case(4, 25, 5, S, 64, kw, kv_pos.to(dev),
                               last.to(dev), "wrapped ring, window 1024")
    for _ in range(2):
        if not torch.equal(got, fd.flash_decode(q, k, v, kv_pos.to(dev),
                                                last.to(dev), **kw)):
            raise AssertionError("flash_decode: a repeated call changed "
                                 "the result")
    log("[3] flash_decode over hymba's wrapped ring (H=25/5, d=64, window "
        "1024): three calls bit-equal")
    # rows that see no key (q_pos = -1; kv_pos all -1) beside one that
    # does: the mean of V over every slot
    kv_pos = flash_positions([1024, 0, 300], S, dev)
    q_pos = torch.tensor([-1, 50, 299], dtype=torch.int32, device=dev)
    _, _, v, got = decode_case(3, 40, 8, S, 128, dict(bk=128), kv_pos, q_pos,
                               "rows 0 and 1 see no key")
    mean = v.float().mean(dim=2).repeat_interleave(5, dim=1)
    held("flash_decode", got[:2], mean[:2], "rows that see no key against "
         "the mean of V")
    # a plan's chunk made legal by the adapter: 2048 -> 1024 over 1500 slots
    from repro_torch.kernels.flash_attention import ops as aops

    S, bk = 1500, fd.decode_bk(2048, 1500)
    qd = bf16_randn(gen, 2, 8, 64, device=dev)
    kc = bf16_randn(gen, 2, S, 2, 64, device=dev)
    vc = bf16_randn(gen, 2, S, 2, 64, device=dev)
    kv_pos = flash_positions([1500, 901], S, dev)
    q_pos = torch.tensor([1499, 900], dtype=torch.int32, device=dev)
    got = aops.decode(qd, kc, vc, kv_pos, q_pos, plan={"bk": 2048})
    want = ref.flash_decode_plain(qd, kc.transpose(1, 2), vc.transpose(1, 2),
                                  kv_pos, q_pos, bk=bk)
    torch.cuda.synchronize()
    held("flash_decode", got, want.to(torch.bfloat16),
         f"the adapter at a plan's bk 2048 over {S} slots (runs {bk})")
    return errs["flash_attention"], errs["flash_decode"]


def attn_bounds(spec, B, H, Hkv, Sq, Skv, d, q_pos, kv_pos, causal,
                out_bytes) -> tuple:
    """(bound ms, "bytes" | "operations") of one attention call: q, the
    K/V rows some query sees, the output and the positions moved once;
    4 d operations (QK^T and PV) per visible (query, key) pair, over the
    bf16 tensor-core peak.  Masked pairs (causal, padding, empty slots)
    are not counted: this run's data does not need them."""
    vis = (kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= 0)
    if causal:
        vis &= kv_pos[:, None, :] <= q_pos[:, :, None]
    pairs = int(vis.sum())
    keys = int(vis.any(dim=1).sum())
    nbytes = (B * H * Sq * d * 2 + 2 * Hkv * keys * d * 2
              + B * H * Sq * d * out_bytes + 4 * B * (Sq + Skv))
    ops = 4.0 * d * H * pairs
    b_bytes = nbytes / spec.hbm_bw * 1e3
    b_ops = ops / spec.peak_bf16_flops * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations"), pairs


def sdpa_call(q, k, v, q_pos, kv_pos, causal):
    """``scaled_dot_product_attention`` on the same masked problem (bf16,
    the KV heads shared through ``enable_gqa``): the library yardstick,
    timed only, never used by the port."""
    import torch

    mask = (kv_pos[:, None, None, :] >= 0)
    if causal:
        mask = mask & (kv_pos[:, None, None, :] <= q_pos[:, None, :, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def qwen_prompts(cfg) -> list:
    """The 8 requests of phases 4c and 4d: prompts of 16-500 tokens from
    a seeded numpy generator, one of 500 (prefill bucket 512)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(16, 501, 8)
    lens[0] = 500
    return [rng.integers(0, cfg.vocab_size, int(L)).tolist() for L in lens]


def serve_qwen(model, params, prompts, max_new, tile_plans=None,
               sync_every=1, reference=None, only=None,
               max_len=QWEN_MAX_LEN):
    """The requests through a fresh ``ServingEngine`` (max_batch 4,
    ``max_len``, greedy); host clock around ``run`` ending in a
    synchronize.  ``reference`` (a phase tag) holds every chunk (those
    ``only`` picks, if given) to the eager chunk
    (``attach_eager_reference``).  Returns (engine, requests, seconds)."""
    import torch

    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(model, params, max_batch=4, max_len=max_len,
                        tile_plans=tile_plans, sync_every=sync_every)
    tally = attach_eager_reference(eng, only=only) if reference else None
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    t = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if reference:
        check_graph_run(reference, eng, tally)
        eng.reference_tally = tally
    return eng, reqs, wall


def qwen_sync4(tag, model, params, prompts, max_new, reqs, count,
               want) -> None:
    """The requests again at sync_every=4 through the graph engine, every
    chunk held to the eager one; the kernel launches ``count()`` must grow
    by ``want(stats)``; the tick stamps against sync_every=1's."""
    before = count()
    eng4, reqs4, _ = serve_qwen(model, params, prompts, max_new,
                                sync_every=4, reference=tag)
    if count() - before != want(eng4.stats()):
        raise AssertionError("kernel launches at sync_every=4 differ from "
                             "the ticks and prefills run")
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, len(r.output))
                         for r in rs]
    log(f"[{tag}] sync_every=4: launches {count() - before} as the ticks and "
        f"prefills ask; the same tick stamps as at 1: "
        f"{stamps(reqs4) == stamps(reqs)}; greedy tokens equal "
        f"{sum(a == b for r, q in zip(reqs, reqs4) for a, b in zip(r.output, q.output))}"
        f"/{len(reqs) * max_new}")


def check_requests(eng, reqs, cfg, max_new, bucket: int = 512) -> None:
    if max(s for _, s in eng.prefill_shapes) < bucket:
        raise AssertionError(f"no prefill reached bucket {bucket}")
    if not all(r.done and len(r.output) == max_new for r in reqs):
        raise AssertionError("a request did not produce its tokens")
    if not all(0 <= t < cfg.padded_vocab for r in reqs for t in r.output):
        raise AssertionError("a token outside the vocabulary")


def same_schedule(tag, eng, reqs, eng_p, reqs_p) -> int:
    """Raises unless both runs have the same tick schedule; returns how
    many free-running greedy tokens agree."""
    stamps = lambda rs: [(r.t_admit, r.t_first, r.t_done, len(r.output))
                         for r in rs]
    same = stamps(reqs) == stamps(reqs_p) and \
        eng.util_history == eng_p.util_history
    same_tok = sum(a == b for r, q in zip(reqs, reqs_p)
                   for a, b in zip(r.output, q.output))
    log(f"[{tag}] plain path: same tick schedule {same}; free-running "
        f"greedy tokens equal {same_tok}/{sum(len(r.output) for r in reqs)}")
    if not same:
        raise AssertionError("kernel and plain paths scheduled differently")
    return same_tok


def qwen_batch(eng, reqs, dev) -> dict:
    """The first four requests' prompts as one right-padded prefill batch
    at the engine's bucket."""
    import torch

    first4 = reqs[:4]
    S = eng.bucket(max(len(r.prompt) for r in first4))
    toks = torch.zeros((4, S), dtype=torch.int32)
    for i, r in enumerate(first4):
        toks[i, :len(r.prompt)] = torch.tensor(r.prompt)
    plens = torch.tensor([len(r.prompt) for r in first4], dtype=torch.int32)
    return {"tokens": toks.to(dev), "lengths": plens.to(dev)}


def qwen_teacher_forced(tag, model, plain, params, eng, reqs, max_new,
                        dev, held: bool = True) -> dict:
    """Kernel path (``model``) against plain path (``plain``), both fed the
    kernel run's tokens: the prefill of the first four prompts, then each
    decode step from the same (plain) cache, and each path on its own
    cache for all steps.  Logits and every layer's k/v relative to the
    plain side's largest magnitude; raises past LM_REL (prefill, one step)
    or LM_CHAIN_GUARD (chained) when ``held`` (otherwise only logs them;
    non-finite logits and other cache positions raise either way)."""
    import torch

    n_layers = model.cfg.n_layers
    batch = qwen_batch(eng, reqs, dev)
    cache, logits0 = model.prefill(params, batch, max_len=QWEN_MAX_LEN)
    cache_p, logits0_p = plain.prefill(params, batch, max_len=QWEN_MAX_LEN)

    def rel_errs(ca, la, cb, lb):
        if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
            raise AssertionError("non-finite logits")
        e_kv = 0.0
        for name in ("k", "v"):
            xa, xb = ca["blocks"]["p0"][name], cb["blocks"]["p0"][name]
            e_kv = max(e_kv, max(max_err(xa[i], xb[i])
                                 / float(xb[i].float().abs().max())
                                 for i in range(n_layers)))
        if not torch.equal(ca["blocks"]["p0"]["pos"],
                           cb["blocks"]["p0"]["pos"]):
            raise AssertionError("kernel and plain paths wrote other "
                                 "cache positions")
        return max_err(la, lb) / float(lb.abs().max()), e_kv

    e_pl, e_pkv = rel_errs(cache, logits0, cache_p, logits0_p)
    log(f"[{tag}] prefill 4 rows at bucket {batch['tokens'].shape[1]}, "
        f"kernel vs plain path: max |logits k-p|/max|logits| = {e_pl:.3e}, "
        f"max per-layer |k/v k-p|/max|k/v| = {e_pkv:.3e} (limit {LM_REL})")
    if held and not (e_pl <= LM_REL and e_pkv <= LM_REL):
        raise AssertionError("kernel and plain prefill paths disagree")
    del cache_p
    ck, cp = cache, cache
    step = dict(logit=0.0, kv=0.0, agree=0)
    chain = dict(logit=0.0, kv=0.0, agree=0)
    for j in range(max_new - 1):
        t = torch.tensor([r.output[j] for r in reqs[:4]], dtype=torch.int32,
                         device=dev)
        c1, l1 = model.decode_step(params, cp, t)
        ck, lk = model.decode_step(params, ck, t)
        cp, lp = plain.decode_step(params, cp, t)
        for acc, (ca, la) in ((step, (c1, l1)), (chain, (ck, lk))):
            e_l, e_kv = rel_errs(ca, la, cp, lp)
            acc["logit"] = max(acc["logit"], e_l)
            acc["kv"] = max(acc["kv"], e_kv)
            acc["agree"] += int((la.argmax(-1) == lp.argmax(-1)).sum())
        del c1
    n_cmp = 4 * (max_new - 1)
    for name, acc, lim in (("one step", step, LM_REL),
                           ("chained", chain, LM_CHAIN_GUARD)):
        log(f"[{tag}] teacher-forced, {name}, {max_new - 1} steps x 4 rows: "
            f"max |logits k-p|/max|logits| = {acc['logit']:.3e}, max "
            f"per-layer |k/v k-p|/max|k/v| = {acc['kv']:.3e} (limit {lim}"
            f"{'' if held else ', not held'}); argmax agrees "
            f"{acc['agree']}/{n_cmp}")
        if held and not (acc["logit"] <= lim and acc["kv"] <= lim):
            raise AssertionError(f"kernel and plain qwen paths disagree "
                                 f"({name})")
    return dict(prefill_logit_rel=e_pl, prefill_kv_rel=e_pkv,
                step_logit_rel=step["logit"], step_kv_rel=step["kv"],
                step_argmax_agree=step["agree"],
                chained_logit_rel=chain["logit"], chained_kv_rel=chain["kv"],
                chained_argmax_agree=chain["agree"], argmax_compared=n_cmp)


def qwen_timings(tag, model, plain, params, prompts, max_new, dev,
                 smi) -> dict:
    """Phase 4c's and 4d's end-to-end timings, each in its own calls:
    the eager decode tick (in place) at B=1 and B=4 on the kernel and the
    plain path (CUDA events, median of 10), the device's busy share of a
    kernel-path tick (``torch.profiler``), a 4-row prefill at bucket 512
    on both paths, the graph tick (``graph_tick_timings``), and tokens/s
    of the 8-request run through the graph engine at sync_every 1 and 4
    (host clock, warm)."""
    import torch

    out = {}
    for B in (1, 4):
        c = model.init_cache(B, QWEN_MAX_LEN, dev)
        tk = torch.zeros((B,), dtype=torch.int32, device=dev)
        for name, m in (("tick", model), ("tick_plain", plain)):
            out[f"{name}_ms_b{B}"] = events_ms(
                lambda: m.decode_step_(params, c, tk).argmax(-1), 10)
        out[f"busy_b{B}"] = device_busy(
            lambda: model.decode_step_(params, c, tk).argmax(-1),
            out[f"tick_ms_b{B}"])
        del c
    pre_tok = torch.randint(0, model.cfg.vocab_size, (4, 512), device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(1))
    pre = {"tokens": pre_tok, "lengths": torch.tensor(
        QWEN_PRE_LEN, dtype=torch.int32, device=dev)}
    for name, m in (("prefill_ms_4x512", model),
                    ("prefill_plain_ms_4x512", plain)):
        out[name] = events_ms(
            lambda: m.prefill(params, pre, max_len=QWEN_MAX_LEN)[1], 5)
    out.update(graph_tick_timings(tag, model, params, QWEN_MAX_LEN, dev,
                                  smi))
    # peak memory of a run with no eager reference beside it: the weights,
    # the cache, the tick's graph pool and the prefills' transients
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    live = torch.cuda.memory_allocated(dev)
    eng_w, reqs_w, wall = serve_qwen(model, params, prompts, max_new)
    out["peak_serve_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["live_before_gb"] = live / 1e9
    out["pool_gb"] = eng_w._loop.pool_bytes / 1e9
    del eng_w
    n_tok = sum(len(r.output) for r in reqs_w)
    out["run_s"] = wall
    out["tokens_per_s"] = n_tok / wall
    _, _, wall4 = serve_qwen(model, params, prompts, max_new, sync_every=4)
    out["run_s_sync4"] = wall4
    out["tokens_per_s_sync4"] = n_tok / wall4
    for B in (1, 4):
        log(f"[{tag}] B={B}: eager decode tick (in place) "
            f"{out[f'tick_ms_b{B}']:.3f} ms (plain path "
            f"{out[f'tick_plain_ms_b{B}']:.3f})")
        bz = out[f"busy_b{B}"]
        if not bz["kernels"]:
            log(f"[{tag}] B={B}: the profiler recorded no device kernels: "
                f"busy share not measured")
            continue
        top = ", ".join(f"{n[:48]} {us:.0f} us" for n, us in bz["top"])
        out[f"fd_tick_ms_b{B}"] = kernel_ms(bz, ("flash_decode",))
        log(f"[{tag}] B={B}: flash_decode's device time in the tick (both "
            f"launches, profiler): {out[f'fd_tick_ms_b{B}']:.3f} ms")
        log(f"[{tag}] B={B} tick under the profiler: {bz['kernels']} "
            f"kernels, {bz['busy_ms']:.3f} ms busy on the device = "
            f"{100 * bz['busy_share']:.1f} % of the "
            f"{out[f'tick_ms_b{B}']:.3f} ms tick (idle "
            f"{100 * (1 - bz['busy_share']):.1f} %); largest: {top}")
    log(f"[{tag}] prefill 4 rows x bucket 512 (lengths {QWEN_PRE_LEN}): "
        f"{out['prefill_ms_4x512']:.3f} ms (plain path "
        f"{out['prefill_plain_ms_4x512']:.3f}); 8-request run through the "
        f"graph engine: {n_tok} tokens in {wall:.3f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s at sync_every=1, {wall4:.3f} s "
        f"= {out['tokens_per_s_sync4']:.1f} tokens/s at 4 (host clock, "
        f"warm); peak device memory of the sync_every=1 run with no eager "
        f"reference {out['peak_serve_gb']:.2f} GB, {out['live_before_gb']:.2f}"
        f" GB of it allocated before the run (the weights, the phase's "
        f"earlier engines), so the run's own rise "
        f"{out['peak_serve_gb'] - out['live_before_gb']:.2f} GB (its cache, "
        f"the tick's graph pool of {out['pool_gb'] * 1e3:.1f} MB, the "
        f"prefills' transients) [{smi}]")
    return out


def qwen_main_path(fa, fd, dev, spec, smi):
    """Phase 4c: qwen2.5-14b at full width through the port's engine.
    Returns (results, the served bf16 tree), the tree for phase 4d."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dse
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import tree_leaves

    cfg = get_config("qwen2.5-14b")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init_serving(gen, dev)
    attn_p = params["blocks"]["p0"]["attn"]
    for name, std in QWEN_ZERO_INIT.items():
        attn_p[name].normal_(0.0, std, generator=gen)
    for t in (params["blocks"]["p0"]["norm1"], params["blocks"]["p0"][
            "norm2"], params["final_norm"]):
        t.normal_(0.0, 0.1, generator=gen)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_leaves(params))
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    peak_init = torch.cuda.max_memory_allocated(dev)
    log(f"[4c] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.padded_vocab}: {n_par / 1e9:.3f} B params, "
        f"{wbytes / 1e9:.2f} GB as served (built leaf by leaf in "
        f"{time.perf_counter() - t0:.1f} s; peak device memory "
        f"{peak_init / 1e9:.2f} GB)")

    prompts = qwen_prompts(cfg)
    max_new = 32

    torch.cuda.reset_peak_memory_stats(dev)
    fa.LAUNCHES["flash_attention"] = 0
    fd.LAUNCHES["flash_decode"] = 0
    eng, reqs, _ = serve_qwen(model, params, prompts, max_new,
                              reference="4c")
    n_fa, n_fd = fa.LAUNCHES["flash_attention"], fd.LAUNCHES["flash_decode"]
    st = eng.stats()
    peak_run = torch.cuda.max_memory_allocated(dev)
    log(f"[4c] engine: {st}; prefill shapes {sorted(eng.prefill_shapes)}; "
        f"peak device memory while serving, the eager reference's copy of "
        f"the cache included, {peak_run / 1e9:.2f} GB")
    log(f"[4c] flash_attention launches {n_fa} = {cfg.n_layers} layers x "
        f"{st['prefill_calls']} prefill calls: "
        f"{n_fa == cfg.n_layers * st['prefill_calls']}; flash_decode "
        f"launches {n_fd} = {cfg.n_layers} x {st['decode_ticks']} decode "
        f"ticks: {n_fd == cfg.n_layers * st['decode_ticks']}")
    if n_fa != cfg.n_layers * st["prefill_calls"] or n_fa <= 0:
        raise AssertionError("flash_attention launches != layers x prefills")
    if n_fd != cfg.n_layers * st["decode_ticks"] or n_fd <= 0:
        raise AssertionError("flash_decode launches != layers x decode ticks")
    check_requests(eng, reqs, cfg, max_new)

    plain_plans = {"attn": {"impl": "plain"}}
    eng_p, reqs_p, _ = serve_qwen(model, params, prompts, max_new,
                                  plain_plans)
    if (fa.LAUNCHES["flash_attention"], fd.LAUNCHES["flash_decode"]) != (
            n_fa, n_fd):
        raise AssertionError("the plain path launched a flash kernel")
    same_tok = same_schedule("4c", eng, reqs, eng_p, reqs_p)
    qwen_sync4("4c", model, params, prompts, max_new, reqs,
               lambda: fd.LAUNCHES["flash_decode"],
               lambda st: cfg.n_layers * st["decode_ticks"])

    plain = model.with_tile_plans(plain_plans)
    tf = qwen_teacher_forced("4c", model, plain, params, eng, reqs, max_new,
                             dev)

    out = dict(flash_attention_launches=n_fa, flash_decode_launches=n_fd,
               graph_launches=eng.reference_tally["graph"],
               nodes_per_tick=eng._loop.per_tick_launches(),
               decode_ticks=st["decode_ticks"],
               prefill_calls=st["prefill_calls"], stats=st,
               params_gb=wbytes / 1e9, peak_init_gb=peak_init / 1e9,
               peak_run_gb=peak_run / 1e9, free_running_tokens_equal=same_tok,
               **tf)

    # ---- timings, each in its own calls --------------------------------
    out.update(qwen_timings("4c", model, plain, params, prompts, max_new,
                            dev, smi))
    pre_len = QWEN_PRE_LEN

    # each kernel per launch at the main path's shapes: flash_attention at
    # the 4-row prefills (bucket 512 as above, and 128 and 32), its device
    # time one call from a CUDA graph (K/V of a prefill sit in L2 in the
    # model too) and its host time a call; flash_decode at B=4 over 1024
    # slots filled as the first four requests' caches are mid-decode
    H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g2 = torch.Generator().manual_seed(700)
    rows = []
    for S, lens in ((512, pre_len), (128, [128, 100, 65, 33]),
                    (32, [32, 24, 17, 9])):
        q = bf16_randn(g2, 4, H, S, d, device=dev)
        k = bf16_randn(g2, 4, Hkv, S, d, device=dev)
        v = bf16_randn(g2, 4, Hkv, S, d, device=dev)
        pos = flash_positions(lens, S, dev)
        bq, bk = fa.kernel_tiles(aops.DEFAULT_BQ, aops.DEFAULT_BK, S, S)
        call = lambda: fa.flash_attention(q, k, v, pos, pos, bq=bq, bk=bk)
        sdpa = lambda: sdpa_call(q, k, v, pos, pos, True)
        row = dict(S=S, lengths=lens, bq=bq, bk=bk,
                   ms=graph_ms([call] * 20), host_ms=host_ms([call]),
                   plain_ms=events_ms(lambda: ref.flash_attention_plain(
                       q, k, v, pos, pos, bk=fa.SUB), 5, inner=3),
                   sdpa_ms=graph_ms([sdpa] * 20), sdpa_host_ms=host_ms([sdpa]),
                   dse_model_ms=dse.attn_plan_metrics(
                       S, S, d, bq, bk, spec, n_heads=H,
                       batch=4).step_latency_s * 1e3)
        mask = (pos[:, None, None, :] >= 0) & (pos[:, None, None, :]
                                               <= pos[:, None, :, None])
        row["sdpa_mask_built_ms"] = graph_ms([
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)] * 20)
        row["bound_ms"], row["bound_by"], row["pairs"] = attn_bounds(
            spec, 4, H, Hkv, S, S, d, pos, pos, True, 2)
        if S == 512:   # every tile the kernel runs, for the DSE's fit
            row["tile_ms"] = {
                f"{tq}x{tk}": graph_ms([lambda: fa.flash_attention(
                    q, k, v, pos, pos, bq=tq, bk=tk)] * 20)
                for tq, tk in dse.attn_kernel_tiles(S, S)}
            row["tile_model_ms"] = {
                f"{tq}x{tk}": dse.attn_plan_metrics(
                    S, S, d, tq, tk, spec, n_heads=H,
                    batch=4).step_latency_s * 1e3
                for tq, tk in dse.attn_kernel_tiles(S, S)}
        rows.append(row)
        log(f"[4c] flash_attention B=4 H={H}/{Hkv} S={S} d={d} lengths "
            f"{lens} (bq={bq}, bk={bk}): device {row['ms'] * 1e3:.2f} us a "
            f"call (graph), host {row['host_ms'] * 1e3:.2f} us; SDPA device "
            f"{row['sdpa_ms'] * 1e3:.2f} us (mask built beforehand "
            f"{row['sdpa_mask_built_ms'] * 1e3:.2f}), host "
            f"{row['sdpa_host_ms'] * 1e3:.2f} us; plain "
            f"{row['plain_ms'] * 1e3:.2f} us; bound "
            f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
            f"({row['pairs']} visible (query, key) pairs x {H} heads); DSE "
            f"model {row['dse_model_ms'] * 1e3:.2f} us"
            + (f"; by tile {row['tile_ms']} (model {row['tile_model_ms']})"
               if S == 512 else "") + f" [{smi}]")
        del q, k, v
    out["fa_rows"] = rows
    for key in ("ms", "host_ms", "plain_ms", "sdpa_ms", "bound_ms",
                "bound_by", "pairs"):
        out[f"fa_{key}"] = rows[0][key]
    if not out["fa_ms"] <= out["fa_sdpa_ms"]:
        log(f"[4c] NOTE: flash_attention {out['fa_ms'] * 1e3:.2f} us is "
            f"slower than SDPA's {out['fa_sdpa_ms'] * 1e3:.2f} us")
    filled = [len(r.prompt) + max_new // 2 for r in reqs[:4]]
    qd = bf16_randn(g2, 4, H, d, device=dev)
    kc = bf16_randn(g2, 4, Hkv, QWEN_MAX_LEN, d, device=dev)
    vc = bf16_randn(g2, 4, Hkv, QWEN_MAX_LEN, d, device=dev)
    kv_pos = flash_positions(filled, QWEN_MAX_LEN, dev)
    q_pos = torch.tensor(filled, dtype=torch.int32, device=dev) - 1
    dbk = fd.decode_bk(aops.DEFAULT_DECODE_BK, QWEN_MAX_LEN)
    call = lambda: fd.flash_decode(qd, kc, vc, kv_pos, q_pos, bk=dbk)
    out["fd_bk"] = dbk
    out["fd_ms"] = events_ms(call, 7, inner=50)
    out["fd_graph_ms"] = graph_ms([call] * 20)
    out["fd_host_ms"] = host_ms([call])
    out["fd_plain_ms"] = events_ms(lambda: ref.flash_decode_plain(
        qd, kc, vc, kv_pos, q_pos, bk=dbk), 5, inner=10)
    out["fd_sdpa_ms"] = events_ms(lambda: sdpa_call(
        qd[:, :, None], kc, vc, q_pos[:, None], kv_pos, True), 7, inner=50)
    out["fd_sdpa_graph_ms"] = graph_ms([lambda: sdpa_call(
        qd[:, :, None], kc, vc, q_pos[:, None], kv_pos, True)] * 20)
    out["fd_bound_ms"], out["fd_bound_by"], _ = attn_bounds(
        spec, 4, H, Hkv, 1, QWEN_MAX_LEN, d, q_pos[:, None], kv_pos, True, 4)
    out["fd_bound_all_slots_ms"] = (2 * 4 * Hkv * QWEN_MAX_LEN * d * 2
                                    / spec.hbm_bw * 1e3)
    out["fd_filled"] = filled
    # the chunk sweep (the default's data), device time from a graph
    out["fd_bk_sweep"] = {
        str(b): graph_ms([lambda: fd.flash_decode(
            qd, kc, vc, kv_pos, q_pos, bk=b)] * 20)
        for b in (64, 128, 256, 512, 1024)}
    # B=1 with every slot seen: nothing to skip
    full = torch.arange(QWEN_MAX_LEN, dtype=torch.int32, device=dev)[None]
    last = torch.tensor([QWEN_MAX_LEN - 1], dtype=torch.int32, device=dev)
    out["fd_b1_full_graph_ms"] = graph_ms([lambda: fd.flash_decode(
        qd[:1], kc[:1], vc[:1], full, last, bk=dbk)] * 20)
    out["fd_b1_full_bound_ms"] = (2 * Hkv * QWEN_MAX_LEN * d * 2
                                  / spec.hbm_bw * 1e3)
    sweep = {b: round(t * 1e3, 2) for b, t in out["fd_bk_sweep"].items()}
    log(f"[4c] flash_decode B=4 H={H}/{Hkv} slots={QWEN_MAX_LEN} d={d} "
        f"filled {filled} (bk={dbk}): device {out['fd_graph_ms'] * 1e3:.2f} "
        f"us a call from a CUDA graph, {out['fd_ms'] * 1e3:.2f} us back to "
        f"back, host {out['fd_host_ms'] * 1e3:.2f} us a call; plain "
        f"{out['fd_plain_ms'] * 1e3:.2f} us; SDPA "
        f"{out['fd_sdpa_ms'] * 1e3:.2f} us back to back "
        f"({out['fd_sdpa_graph_ms'] * 1e3:.2f} from a graph); bound over the "
        f"visible slots (fd_bound_ms) {out['fd_bound_ms'] * 1e3:.3f} us by "
        f"{out['fd_bound_by']}, over all {QWEN_MAX_LEN} slots "
        f"(fd_bound_all_slots_ms) {out['fd_bound_all_slots_ms'] * 1e3:.3f} "
        f"us; by chunk (graph, us) {sweep}; B=1 over {QWEN_MAX_LEN} filled "
        f"slots {out['fd_b1_full_graph_ms'] * 1e3:.2f} us (bound "
        f"{out['fd_b1_full_bound_ms'] * 1e3:.3f}) [{smi}]")
    # the open-loop base cell on this bf16 tree (phase 4e's qwen cell),
    # then its paged twin and the two b8 paged cells (phase 4f)
    from repro_torch.kernels.decode_loop import decode_loop as dl
    kernels = ((fa, "flash_attention"), (fd, "flash_decode"),
               (dl, "decode_loop"))
    want = lambda st: {
        "flash_attention": cfg.n_layers * st["prefill_calls"],
        "flash_decode": cfg.n_layers * st["decode_ticks"],
        "decode_loop": st["decode_ticks"] + st["decode_chunks"]}
    out["open_loop"] = open_loop_cell(
        "4c", "qwen2.5-14b/b4/r1", model, params, plain_plans, kernels,
        want, smi)
    out["paged"] = paged_main_path(model, params, plain_plans, kernels,
                                   want, out["open_loop"], dev, smi)
    # phase 4g's qwen2.5-14b storm cells, on this tree after 4f
    out["chaos"] = chaos_main_path("4g", model, params, kernels, want, smi)
    # phase 4h's qwen2.5-14b traced drives, on this tree after 4g
    out["trace"] = trace_qwen_main_path(model, params, smi)
    return out, params


def mm_bounds(spec, M, K, N) -> tuple:
    """(bound ms, "bytes" | "operations") of one W8A16 product: x (bf16),
    the int8 weight and its f32 scales read once, the bf16 output written
    once; 2 M N K operations over the bf16 tensor-core peak (the kernel
    widens the codes to bf16)."""
    nbytes = M * K * 2 + K * N + N * 4 + M * N * 2
    b_bytes = nbytes / spec.hbm_bw * 1e3
    b_ops = 2.0 * M * N * K / spec.peak_bf16_flops * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops
                                 else "operations")


def check_matmul(mm, dev) -> float:
    """Phase 3 for ``matmul_w8a16``: kernel vs plain version at
    qwen2.5-14b's shapes and around them, the decode kernel (M <= 16) at
    S = 1, its default S and the largest S, the prefill kernel (M > 16) at
    its default tiles, every tile, repeated calls and unaligned rows.
    Returns the largest absolute error of each kernel, ``{"decode": e,
    "prefill": e}`` (each case is held relative to its largest output)."""
    import torch

    from repro_torch.kernels.matmul_int8 import ref
    from repro_torch.kernels.matmul_int8.ops import default_tiles

    log(f"[3] matmul_w8a16 tolerance: max|kernel - plain| <= {MM_REL} x "
        f"max|plain| (the same exact products summed in f32 in another "
        f"order, one rounding to bf16: a bf16 ulp of the largest output "
        f"plus the f32 order difference); every output finite")
    gen = torch.Generator().manual_seed(800)

    def operands(M, K, N, bias):
        x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
        w = torch.randint(-127, 128, (K, N), generator=gen,
                          dtype=torch.int8).to(dev)
        sc = ((torch.rand((N,), generator=gen) + 0.5)
              / (127 * K ** 0.5)).to(dev)
        b = (torch.randn((N,), generator=gen) * 0.5).to(dev) if bias \
            else None
        return x, w, sc, b

    worst = {"decode": 0.0, "prefill": 0.0}

    def held(got, want, what):
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"matmul_w8a16 {what}: non-finite output")
        err = max_err(got, want)
        rel = err / float(want.float().abs().max())
        kind = "decode" if got.shape[0] <= mm.DECODE_M else "prefill"
        worst[kind] = max(worst[kind], err)
        if not rel <= MM_REL:
            raise AssertionError(f"matmul_w8a16 {what} disagrees with its "
                                 f"plain version ({rel:.3e})")
        return err, rel

    acts = ("none", "silu", "gelu", "relu")
    cases = [(M, 5120, 5120, act, bias) for M in (4, 512) for act in acts
             for bias in (False, True)]
    cases += [(M, K, N, "none", False) for M in (1, 4)
              for _, K, N in QWEN_PROJ[1:5]]
    # the prefill kernel: qwen's four projection shapes at M = 2048 (a
    # 4-row prefill at bucket 512), w_gate at M = 128 and 512, ragged
    cases += [(2048, K, N, "none", False) for _, K, N in QWEN_PROJ[1:5]]
    cases += [(M, 5120, 13824, "silu", False) for M in (128, 512)]
    cases += [(3, 200, 300, "silu", True), (40, 320, 300, "silu", True)]
    for M, K, N, act, bias in cases:
        x, w, sc, b = operands(M, K, N, bias)
        tiles = mm.kernel_tiles(*default_tiles(M, N, K), M, N, K)
        got = mm.matmul_w8a16(x, w, sc, b, act=act, bm=tiles[0],
                              bn=tiles[1], bk=tiles[2])
        want = ref.matmul_w8a16_plain(x, w, sc, b, act=act)
        err, rel = held(got, want, f"M={M} K={K} N={N} act={act}")
        geo = (f"splits={mm.decode_geometry(M, N, K).splits}"
               if M <= mm.DECODE_M else f"tiles={tiles}")
        log(f"[3] matmul_w8a16 M={M} K={K} N={N} act={act} bias={bias} "
            f"{geo}: max|kernel-plain| = {err:.3e}, relative to "
            f"max|plain| {rel:.3e}")
    # the decode kernel: every qwen projection, ragged K and N, and
    # unaligned rows, at M = 1, 2, 4, 16 and S = 1, default, largest; each
    # geometry gives the same bits on three calls
    dec = [(name, K, N) for name, K, N in QWEN_PROJ]
    dec += [("ragged", 4097, 300)]
    n_geo = 0
    for name, K, N in dec:
        for M in (1, 2, 4, 16):
            x, w, sc, b = operands(M, K, N, name == "ragged")
            want = ref.matmul_w8a16_plain(x, w, sc, b, act="silu")
            res = []
            for S in sorted({1, mm.decode_geometry(M, N, K).splits,
                             mm.k_steps(K)}):
                outs = [mm.matmul_w8a16(x, w, sc, b, act="silu", splits=S)
                        for _ in range(3)]
                err, rel = held(outs[0], want, f"decode {name} M={M} S={S}")
                if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                    raise AssertionError(f"matmul_w8a16 decode {name} M={M} "
                                         f"S={S}: repeated calls differ")
                res.append(f"S={S} {rel:.2e}")
                n_geo += 1
            log(f"[3] matmul_w8a16 decode {name} M={M} K={K} N={N}, "
                f"relative error at " + ", ".join(res)
                + "; 3 calls bit-equal at each")
    # rows off a 16-byte boundary take the element-wise loads: the same
    # bits as the 16-byte path at the same geometry
    x, w, sc, b = operands(4, 5120, 1024, True)
    xu = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(
        x.shape)
    wu = torch.empty(w.numel() + 1, dtype=w.dtype, device=dev)[1:].view(
        w.shape)
    xu.copy_(x)
    wu.copy_(w)
    want = ref.matmul_w8a16_plain(x, w, sc, b)
    for S in (1, mm.decode_geometry(4, 1024, 5120).splits):
        got = mm.matmul_w8a16(xu, wu, sc, b, splits=S)
        err, rel = held(got, want, f"unaligned S={S}")
        if not torch.equal(got, mm.matmul_w8a16(x, w, sc, b, splits=S)):
            raise AssertionError("matmul_w8a16 decode: unaligned rows give "
                                 "other bits")
        n_geo += 1
    log(f"[3] matmul_w8a16 decode: {n_geo} geometries within {MM_REL}, "
        f"unaligned rows (x, w off 16 bytes) bit-equal to aligned")
    # above M = 16 every tile sums an output's products in the same k order
    x, w, sc, b = operands(40, 320, 300, True)
    outs = [mm.matmul_w8a16(x, w, sc, b, bm=bm, bn=bn, bk=mm.BK)
            for bm in mm.BMS for bn in mm.BNS]
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    held(outs[0], ref.matmul_w8a16_plain(x, w, sc, b), "prefill M=40 tiles")
    log(f"[3] matmul_w8a16 M=40: all {len(outs)} prefill tiles bit-equal: "
        f"{same}")
    if not same:
        raise AssertionError("matmul_w8a16 tiles differ")
    # the prefill kernel: repeated calls give the same bits at w_gate's
    # shape; rows off a 16-byte boundary (element-wise loads) give the
    # bits of the aligned copies (TMA loads) at every tile
    x, w, sc, b = operands(2048, 5120, 13824, True)
    outs = [mm.matmul_w8a16(x, w, sc, b) for _ in range(3)]
    held(outs[0], ref.matmul_w8a16_plain(x, w, sc, b), "prefill repeats")
    if not all(torch.equal(o, outs[0]) for o in outs[1:]):
        raise AssertionError("matmul_w8a16 prefill: repeated calls differ")
    x, w, sc, b = operands(300, 1024, 512, True)
    xu = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(
        x.shape)
    wu = torch.empty(w.numel() + 1, dtype=w.dtype, device=dev)[1:].view(
        w.shape)
    xu.copy_(x)
    wu.copy_(w)
    for bm in mm.BMS:
        got = mm.matmul_w8a16(xu, wu, sc, b, bm=bm)
        held(got, ref.matmul_w8a16_plain(x, w, sc, b), f"unaligned bm={bm}")
        if not torch.equal(got, mm.matmul_w8a16(x, w, sc, b, bm=bm)):
            raise AssertionError("matmul_w8a16 prefill: unaligned rows give "
                                 "other bits")
    log(f"[3] matmul_w8a16 prefill: 3 calls at M=2048 K=5120 N=13824 "
        f"bit-equal; unaligned rows (x, w off 16 bytes) bit-equal to aligned "
        f"at bm {mm.BMS}")
    return worst


def tree_gb(tree, dtypes) -> float:
    from repro_torch.models.params import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if t.dtype in dtypes) / 1e9


def qwen_int8_main_path(mm, dev, spec, smi, params) -> dict:
    """Phase 4d: qwen2.5-14b at full width and depth with int8 weights,
    from phase 4c's served bf16 tree ``params`` (consumed)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_tree
    from repro_torch.kernels.matmul_int8 import ref
    from repro_torch.kernels.matmul_int8.ops import default_tiles
    from repro_torch.models.lm import build_model
    from repro_torch.serving.engine import default_buckets

    cfg = get_config("qwen2.5-14b")
    model = build_model(cfg)
    prompts = qwen_prompts(cfg)
    max_new = 32

    # bf16 logits of the first four prompts and the next step, for the
    # int8-against-bf16 comparison
    lens = [len(p) for p in prompts[:4]]
    S = min(b for b in default_buckets(QWEN_MAX_LEN) if b >= max(lens))
    toks = torch.zeros((4, S), dtype=torch.int32)
    for i, p in enumerate(prompts[:4]):
        toks[i, :len(p)] = torch.tensor(p)
    batch = {"tokens": toks.to(dev),
             "lengths": torch.tensor(lens, dtype=torch.int32, device=dev)}
    cache, bf_logits = model.prefill(params, batch, max_len=QWEN_MAX_LEN)
    nxt = bf_logits.argmax(-1).to(torch.int32)
    _, bf_logits2 = model.decode_step(params, cache, nxt)
    del cache

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = quantize_tree(params, consume=True)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    peak_quant = torch.cuda.max_memory_allocated(dev)
    int8_gb = tree_gb(params, (torch.int8, torch.float32))
    bf16_gb = tree_gb(params, (torch.bfloat16,))
    n_int8 = sum(1 for k, v in params["blocks"]["p0"]["attn"].items()
                 if isinstance(v, dict)) + sum(
        1 for v in params["blocks"]["p0"]["mlp"].values()
        if isinstance(v, dict))
    log(f"[4d] {cfg.name} int8: quantize_tree of the served bf16 tree in "
        f"{quant_s:.1f} s (leaf by leaf, one layer at a time; peak device "
        f"memory {peak_quant / 1e9:.2f} GB): {int8_gb:.2f} GB of int8 codes "
        f"and f32 scales ({n_int8} projections a layer and lm_head) + "
        f"{bf16_gb:.2f} GB bf16 (embedding, norms, biases)")
    if n_int8 != len(QWEN_PROJ) or not isinstance(params["lm_head"], dict):
        raise AssertionError("quantize_tree left a projection in bf16")

    cache, q_logits = model.prefill(params, batch, max_len=QWEN_MAX_LEN)
    _, q_logits2 = model.decode_step(params, cache, nxt)
    del cache
    vs_bf16 = max(max_err(a, b) / float(a.abs().max())
                  for a, b in ((bf_logits, q_logits), (bf_logits2, q_logits2)))
    log(f"[4d] int8 vs bf16 tree, prefill and next step, kernel path: max "
        f"|logits int8 - bf16|/max|logits| = {vs_bf16:.3e} (limit "
        f"{INT8_VS_BF16})")
    if not vs_bf16 <= INT8_VS_BF16:
        raise AssertionError("int8 logits too far from the bf16 tree's")

    torch.cuda.reset_peak_memory_stats(dev)
    for k in mm.LAUNCHES:
        mm.LAUNCHES[k] = 0
    eng, reqs, _ = serve_qwen(model, params, prompts, max_new,
                              reference="4d")
    n_mm = mm.LAUNCHES["matmul_w8a16"]
    n_pre = mm.LAUNCHES["matmul_w8a16_prefill"]
    st = eng.stats()
    peak_run = torch.cuda.max_memory_allocated(dev)
    want = len(QWEN_PROJ) * cfg.n_layers * (st["decode_ticks"]
                                            + st["prefill_calls"])
    log(f"[4d] engine: {st}; prefill shapes {sorted(eng.prefill_shapes)}; "
        f"peak device memory while serving, the eager reference's copy of "
        f"the cache included, {peak_run / 1e9:.2f} GB")
    log(f"[4d] matmul_w8a16 launches {n_mm} = {len(QWEN_PROJ)} x "
        f"{cfg.n_layers} layers x ({st['decode_ticks']} decode ticks + "
        f"{st['prefill_calls']} prefill calls): {n_mm == want}")
    if n_mm != want or n_mm <= 0:
        raise AssertionError("matmul_w8a16 launches != 7 x layers x "
                             "(ticks + prefills)")
    want_pre = len(QWEN_PROJ) * cfg.n_layers * st["prefill_calls"]
    log(f"[4d] of them on the prefill kernel: {n_pre} = {len(QWEN_PROJ)} x "
        f"{cfg.n_layers} layers x {st['prefill_calls']} prefill calls: "
        f"{n_pre == want_pre}")
    if n_pre != want_pre or n_pre <= 0:
        raise AssertionError("matmul_w8a16_prefill launches != 7 x layers x "
                             "prefills")
    check_requests(eng, reqs, cfg, max_new)

    plain_plans = {"matmul_int8": {"impl": "plain"}}
    eng_p, reqs_p, _ = serve_qwen(model, params, prompts, max_new,
                                  plain_plans)
    if mm.LAUNCHES["matmul_w8a16"] != n_mm:
        raise AssertionError("the plain path launched matmul_w8a16")
    same_tok = same_schedule("4d", eng, reqs, eng_p, reqs_p)
    qwen_sync4("4d", model, params, prompts, max_new, reqs,
               lambda: mm.LAUNCHES["matmul_w8a16"],
               lambda st: len(QWEN_PROJ) * cfg.n_layers * (
                   st["decode_ticks"] + st["prefill_calls"]))
    plain = model.with_tile_plans(plain_plans)
    tf = qwen_teacher_forced("4d", model, plain, params, eng, reqs, max_new,
                             dev)
    out = dict(launches=n_mm, prefill_launches=n_pre,
               graph_launches=eng.reference_tally["graph"],
               nodes_per_tick=eng._loop.per_tick_launches(),
               decode_ticks=st["decode_ticks"],
               prefill_calls=st["prefill_calls"], stats=st,
               quantize_s=quant_s, int8_gb=int8_gb, bf16_gb=bf16_gb,
               peak_quantize_gb=peak_quant / 1e9, peak_run_gb=peak_run / 1e9,
               int8_vs_bf16_logit_rel=vs_bf16,
               free_running_tokens_equal=same_tok, **tf)
    del eng, eng_p

    # ---- timings, each in its own calls --------------------------------
    out.update(qwen_timings("4d", model, plain, params, prompts, max_new,
                            dev, smi))
    # one call at each decode shape (M = 4, the engine's batch) and at each
    # prefill shape of the 4-row bucket-512 prefill (M = 2048), and w_gate
    # at M = 128 and 512: device time from a CUDA graph of launches over
    # rotated weight copies (cold, as in a tick; the host's cost out), host
    # time from the wall clock over 1,000 calls (20 at prefill), the plain
    # version, and torch.matmul on bf16 weights made beforehand (cuBLAS,
    # the product phase 4c runs; rotated and timed the same way, only)
    gen = torch.Generator().manual_seed(900)

    def mm_operands(M, K, N, copies):
        x = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
        ws = [torch.randint(-127, 128, (K, N), generator=gen,
                            dtype=torch.int8).to(dev) for _ in range(copies)]
        sc = (torch.rand((N,), generator=gen) / (127 * K ** 0.5)).to(dev)
        return x, ws, sc

    def mm_calls(x, ws, sc, **kw):
        return [lambda w=w: mm.matmul_w8a16(x, w, sc, **kw) for w in ws]

    shapes = [(name, 4, K, N) for name, K, N in QWEN_PROJ]
    shapes += [(f"prefill {name}", 2048, K, N) for name, K, N in QWEN_PROJ]
    shapes += [("prefill w_gate", M, 5120, 13824) for M in (128, 512)]
    rows = []
    for name, M, K, N in shapes:
        x, ws, sc = mm_operands(M, K, N, copies_for(K * N))
        bm, bn, bk = mm.kernel_tiles(*default_tiles(M, N, K), M, N, K)
        kw = dict(bm=bm, bn=bn, bk=bk)
        row = dict(name=name, M=M, K=K, N=N, copies=len(ws))
        if M <= mm.DECODE_M:
            geo = mm.decode_geometry(M, N, K)
            row.update(splits=geo.splits, ctas=geo.ctas)
        else:
            row["tiles"] = [bm, bn, bk]
        calls = mm_calls(x, ws, sc, **kw)
        row["ms"] = graph_ms(calls * max(1, 24 // len(calls))
                             if M <= mm.DECODE_M else calls)
        row["host_ms"] = host_ms(calls, 1000 if M <= mm.DECODE_M else 20)
        row["plain_ms"] = events_ms(
            lambda: ref.matmul_w8a16_plain(x, ws[0], sc), 5, inner=3)
        wbs = [(ws[i % len(ws)].float() * sc).to(torch.bfloat16)
               for i in range(copies_for(2 * K * N))]
        blas = [lambda wb=wb: torch.matmul(x, wb) for wb in wbs]
        row["cublas_bf16_ms"] = graph_ms(
            blas * max(1, 24 // len(blas)) if M <= mm.DECODE_M else blas)
        row["cublas_host_ms"] = host_ms(blas, 1000 if M <= mm.DECODE_M
                                        else 20)
        row["bound_ms"], row["bound_by"] = mm_bounds(spec, M, K, N)
        rows.append(row)
        del x, ws, sc, wbs, calls, blas
        geo_s = (f"S={row['splits']} ({row['ctas']} CTAs)" if "splits" in row
                 else f"tiles {row['tiles']}")
        log(f"[4d] matmul_w8a16 {name} M={M} K={K} N={N} {geo_s}: device "
            f"{row['ms'] * 1e3:.2f} us a call over {row['copies']} rotated "
            f"weights (cuBLAS bf16 {row['cublas_bf16_ms'] * 1e3:.2f} us, "
            f"bound {row['bound_ms'] * 1e3:.3f} us by {row['bound_by']}); "
            f"host {row['host_ms'] * 1e3:.2f} us a call (cuBLAS "
            f"{row['cublas_host_ms'] * 1e3:.2f} us); plain "
            f"{row['plain_ms'] * 1e3:.2f} us [{smi}]")
    out["mm_rows"] = rows
    # the split count at the wq and w_down shapes: whether the time now
    # follows the bytes
    out["splits_sweep_ms"] = {}
    for name, K, N in (QWEN_PROJ[0], QWEN_PROJ[6]):
        x, ws, sc = mm_operands(4, K, N, copies_for(K * N))
        d = mm.decode_geometry(4, N, K).splits
        sweep = {}
        for S in sorted({1, 2, 4, d, 2 * d, 4 * d, mm.k_steps(K)}):
            if S <= mm.k_steps(K):
                sweep[S] = graph_ms(mm_calls(x, ws, sc, splits=S) * max(
                    1, 24 // len(ws)))
        out["splits_sweep_ms"][name] = sweep
        del x, ws, sc
        log(f"[4d] matmul_w8a16 {name} M=4 device time by split count S "
            f"(default {d}): " + ", ".join(
                f"S={S} {t * 1e3:.2f} us" for S, t in sweep.items())
            + f" (bound {mm_bounds(spec, 4, K, N)[0] * 1e3:.3f} us)")
    # the fixed cost of a call: one 64 x 128 step at S = 1 (one kernel) and
    # S = 2 (two steps, and the reduction pass)
    x, ws, sc = mm_operands(4, 128, 128, 24)
    out["fixed_ms"] = {S: graph_ms(mm_calls(x, ws, sc, splits=S))
                       for S in (1, 2)}
    del x, ws, sc
    log(f"[4d] matmul_w8a16 M=4 K=128 N=128 (one CTA a split): "
        f"S=1 {out['fixed_ms'][1] * 1e3:.2f} us, S=2 "
        f"{out['fixed_ms'][2] * 1e3:.2f} us a call (the fixed cost of one "
        f"and of two launches)")
    # the kernels line: the mean call of one decode layer (7 calls, B = 4)
    # and of one 4 x 512 prefill layer (7 calls, M = 2048), each number the
    # mean of the same 7 shapes
    n = len(QWEN_PROJ)
    for tag, sel, what in (("layer", rows[:n], "decode layer's 7 calls at "
                            "B=4"),
                           ("prefill_layer", rows[n:2 * n], "4 x 512 prefill "
                            "layer's 7 calls at M=2048")):
        for key in ("ms", "host_ms", "plain_ms", "cublas_bf16_ms",
                    "bound_ms"):
            out[f"{tag}_mean_{key}"] = sum(r[key] for r in sel) / len(sel)
        by_bytes = sum(r["bound_ms"] for r in sel if r["bound_by"] == "bytes")
        out[f"{tag}_bound_by"] = ("bytes" if 2 * by_bytes >= sum(
            r["bound_ms"] for r in sel) else "operations")
        layer = sum(r["ms"] for r in sel)
        bound = sum(r["bound_ms"] for r in sel)
        blas = sum(r["cublas_bf16_ms"] for r in sel)
        log(f"[4d] one {what}, device: {layer * 1e3:.2f} us (bound "
            f"{bound * 1e3:.2f} us, cuBLAS bf16 {blas * 1e3:.2f} us = "
            f"{layer / blas:.3f}x); x 48 layers = {48 * layer:.3f} ms")
    for B in (1, 4):
        out[f"mm_tick_ms_b{B}"] = kernel_ms(out[f"busy_b{B}"],
                                            ("matmul_w8a16",))
        out[f"cublas_tick_ms_b{B}"] = kernel_ms(out[f"busy_b{B}"],
                                                CUBLAS_MARKS)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (SRC / "repro_torch").is_dir():
        log(f"chip_smoke: {SRC / 'repro_torch'} not found")
        return 1
    sys.path.insert(0, str(SRC))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    LOG_FILE.append(open(ROOT / "chiprun_out" / "chip_smoke.log", "w"))
    from repro_torch import hw
    from repro_torch.configs import DEEPBENCH_TASKS
    from repro_torch.core import cells, dse
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_loop import decode_loop as dl
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_decode as fd
    from repro_torch.kernels.fused_rnn import fused_rnn as fr
    from repro_torch.kernels.matmul_int8 import matmul_int8 as mm
    from repro_torch.kernels.rwkv_step import rwkv_step as rk
    from repro_torch.kernels.fused_rnn.ops import (_weights_for_kernel,
                                                   default_bh)
    from repro_torch.launch.deepbench import task_inputs

    dev = torch.device("cuda", 0)
    report = {}

    # ---- 1. device ------------------------------------------------------
    smi = nvidia_smi()
    spec = hw.from_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls sum in f32 and round once, as the JAX package's dot
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(f"[1] device: {torch.cuda.get_device_name(0)}")
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[1] dse spec: sms={spec.sms} smem_per_block_optin="
        f"{spec.smem_per_block_optin} smem_per_sm={spec.smem_per_sm} "
        f"hbm_bytes={spec.hbm_bytes:.0f} l2_bytes={spec.l2_bytes:.0f} "
        f"regs_per_sm={spec.regs_per_sm} (hbm_bw {spec.hbm_bw:.3g} B/s and "
        f"peaks from the data sheet)")
    log(f"[1] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; "
        f"allow_bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    report["device"] = dict(name=torch.cuda.get_device_name(0), smi=smi,
                            sms=spec.sms, torch=torch.__version__)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    names = ("fused_rnn", "rwkv_step", "flash_attention", "matmul_int8",
             "decode_loop")
    with ThreadPoolExecutor(len(names)) as pool:
        lib_paths = list(pool.map(_build.build, names))
    build_s = time.perf_counter() - t0
    log(f"[2] built {', '.join(p.name for p in lib_paths)} in "
        f"{build_s:.1f} s (compilers run together)")
    for lib_path in lib_paths:
        ptxas = lib_path.with_suffix(".log").read_text().splitlines() \
            if lib_path.with_suffix(".log").is_file() else []
        for line in ptxas:
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                log(f"[2] {lib_path.name.split('-')[0]}: {line.strip()}")
    report["build_s"] = build_s

    # ---- 3. kernels vs plain version ------------------------------------
    log(f"[3] tolerance: max abs error <= {ATOL}; kernel and plain version "
        f"sum the same exact bf16 x int8/bf16 products in f32 in another "
        f"order, so one bf16 ulp of y (or of the h fed back) may flip")
    errs = {kernel_name(c, p): 0.0 for c in ("lstm", "gru")
            for p in (False, True)}  # the projections' come from check_xproj
    shapes = [  # cell, H, D, B, T, weights, bh, persistent
        ("lstm", 256, 256, 1, 8, torch.int8, 16, False),
        ("lstm", 256, 256, 1, 8, torch.int8, 8, True),
        ("gru", 512, 512, 3, 5, torch.int8, 64, False),
        ("gru", 512, 512, 3, 5, torch.int8, 16, True),
        ("lstm", 96, 80, 5, 6, torch.int8, 48, False),      # ragged tile, B > 4
        ("lstm", 96, 80, 5, 6, torch.int8, 24, True),
        ("gru", 96, 80, 2, 6, torch.bfloat16, 24, False),   # bf16 weights
        ("gru", 96, 80, 2, 6, torch.bfloat16, 12, True),
        ("lstm", 1024, 1024, 1, 12, torch.int8, 8, True),   # main-path widths
        ("gru", 2560, 2560, 1, 4, torch.int8, 64, False),
        ("lstm", 2048, 2048, 1, 6, torch.int8, 16, True),   # W_h resident at
        ("gru", 2560, 2560, 1, 6, torch.int8, 20, True),    # full width
        ("gru", 2560, 2560, 4, 4, torch.int8, 40, True),    # clusters of 2
    ]
    for i, (cell, H, D, B, T, wdt, bh, pers) in enumerate(shapes):
        o = operands(cell, H, D, B, T, wdt, dev, seed=100 + i)
        got = call(fr, cell, o, bh, pers)
        want = call(fr, cell, o, bh, pers, plain=True)
        torch.cuda.synchronize()
        e = max(max_err(g, w_) for g, w_ in zip(got, want) if g is not None)
        name = kernel_name(cell, pers)
        errs[name] = max(errs[name], e)
        log(f"[3] {name:22s} H={H} D={D} B={B} T={T} {str(wdt)[6:]:8s} "
            f"bh={bh}: max|kernel-plain| over y,h_T,c_T = {e:.3e} "
            f"(atol {ATOL})")
        if not e <= ATOL:
            raise AssertionError(f"{name} disagrees with its plain version")
        if pers:
            cs = fr.persist_geometry_on_card(4 if cell == "lstm" else 3, H, bh,
                                             o["w_h"].element_size(), dev)
            again = call(fr, cell, o, bh, pers)
            same = all(torch.equal(g, a_) for g, a_ in zip(got, again)
                       if g is not None)
            log(f"[3] {name:22s} H={H} bh={bh}: cluster of {cs}, "
                f"{cs * (H // bh)} CTAs; a second call bit-equal: {same}")
            if not same:
                raise AssertionError(f"{name}: two calls differ")
    errs.update(check_xproj(fr, dev))
    rwkv_err = check_rwkv6_step(rk, dev)
    fa_err, fd_err = check_flash(fa, fd, dev)
    mm_err = check_matmul(mm, dev)
    loop_k = check_decode_loop(dl, dev, spec)
    report["decode_loop"] = loop_k

    # ---- 4. main path ---------------------------------------------------
    inputs = [(task,) + task_inputs(task, dev, seed=7) for task in
              DEEPBENCH_TASKS]
    for k in fr.LAUNCHES:
        fr.LAUNCHES[k] = 0
    outs, again = {}, {}
    pplan = {"persistent": True}
    for task, cfg, w, x in inputs:
        if not dse.persistent_eligible(cfg):
            raise AssertionError(f"{task.name}: W_h cannot be resident")
        outs[(task.name, False)] = cells.serve(cfg, w, x, impl="kernel")
        outs[(task.name, True)] = cells.serve(cfg, w, x, impl="kernel",
                                              plan=pplan)
        again[task.name] = cells.serve(cfg, w, x, impl="kernel", plan=pplan)
    btask, bcfg, bw, _ = inputs[1]
    gen = torch.Generator().manual_seed(11)
    xb = torch.randn((btask.timesteps, 4, bcfg.d), generator=gen).to(
        dev, torch.bfloat16)
    # four requests as one batch and each alone, at the batch's tile:
    # streaming, then persistent
    batches = []
    for pers in (False, True):
        plan = {"bh": default_bh(bcfg, 4, pers), "persistent": pers}
        batches.append((btask, bcfg, plan,
                        cells.serve(bcfg, bw, xb, impl="kernel", plan=plan),
                        [cells.serve(bcfg, bw, xb[:, i:i + 1], impl="kernel",
                                     plan=plan) for i in range(4)]))
    # B = 4, T = 5: M = 20 crosses the projection's 16-row tile, its rows
    # alone (M = 5) do not; lstm-512 and gru-2560's widths
    short = []
    for task, cfg, w, _ in (inputs[1], inputs[9]):
        xs = torch.randn((5, 4, cfg.d), generator=gen).to(dev, torch.bfloat16)
        for pers in (False, True):
            plan = {"bh": default_bh(cfg, 4, pers), "persistent": pers}
            short.append((task, cfg, plan,
                          cells.serve(cfg, w, xs, impl="kernel", plan=plan),
                          [cells.serve(cfg, w, xs[:, i:i + 1], impl="kernel",
                                       plan=plan) for i in range(4)]))
    torch.cuda.synchronize()
    launches = dict(fr.LAUNCHES)
    log(f"[4] main-path launches: {launches}")
    # a streaming call is 1 projection + T steps, a persistent call 1
    # projection + 1 persistent launch
    want = {k: 0 for k in fr.LAUNCHES}
    calls = [(cfg.cell, x.shape[0], pers) for task, cfg, w, x in inputs
             for pers in (False, True, True)]
    calls += [(c.cell, t.timesteps, pl["persistent"])
              for t, c, pl, _, _ in batches for _ in range(5)]
    calls += [(c.cell, 5, pl["persistent"])
              for _, c, pl, _, _ in short for _ in range(5)]
    for cell, T, pers in calls:
        want[f"fused_{cell}_xproj"] += 1
        if pers:
            want[f"fused_{cell}_persistent"] += 1
        else:
            want[f"fused_{cell}"] += T
    log(f"[4] expected: {want}")
    if launches != want:
        raise AssertionError("launch counters differ from 1 projection + T "
                             "steps a streaming call, 1 projection + 1 "
                             "persistent launch a persistent call")
    for task, cfg, w, x in inputs:
        same = bool(torch.equal(outs[(task.name, True)], again[task.name]))
        log(f"[4] {task.name:16s} persistent: a second call bit-equal: "
            f"{same}")
        if not same:
            raise AssertionError(f"{task.name}: two persistent calls differ")

    # agreement with the plain version, all of T
    rows = []
    for task, cfg, w, x in inputs:
        y_plain = cells.serve(cfg, w, x, impl="kernel",
                              plan={"impl": "plain"})
        for pers in (False, True):
            if (task.name, pers) not in outs:
                continue
            e = max_err(outs[(task.name, pers)], y_plain)
            name = kernel_name(cfg.cell, pers)
            errs[name] = max(errs[name], e)
            rows.append(dict(task=task.name, kernel=name, T=x.shape[0],
                             max_abs_err=e))
            log(f"[4] {task.name:16s} {name:22s} y over all T={x.shape[0]}: "
                f"max|kernel-plain| = {e:.3e} (atol {ATOL})")
            if not e <= ATOL:
                raise AssertionError(f"{task.name}: {name} disagrees")
    # at the same tile the kernel runs each row's arithmetic in the same
    # order whatever the batch, so the rows must be bit-equal
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for task, cfg, plan, yb, ya in batches + short:
        T, N = yb.shape[0], cfg.n_gates * cfg.hidden
        mode = "persistent" if plan["persistent"] else "streaming"
        for i in range(4):
            same = bool(torch.equal(yb[:, i:i + 1], ya[i]))
            log(f"[4] batch row {i} of {task.name} at B=4, T={T}, {mode} "
                f"(projection tile {fr.xproj_tile(4 * T, N, cfg.d, sms)}, "
                f"alone {fr.xproj_tile(T, N, cfg.d, sms)}; bh={plan['bh']}) "
                f"equals the request alone: {same}")
            if not same:
                raise AssertionError("a batch row differs from its request "
                                     "alone")

    # plan tiles the step kernel cannot run as asked: the JAX DSE's whole-H
    # picks (tests/test_torch_fused_rnn.py holds these to
    # repro.core.dse.best_plan) and plan tiles 8 and 24, made legal
    by_name = {t.name: (t, c, w_, x_) for t, c, w_, x_ in inputs}
    for name, ask in (("lstm-h1536-t50", 1536), ("gru-h1536-t375", 1536),
                      ("gru-h2048-t375", 2048), ("lstm-h1024-t25", 8),
                      ("gru-h2560-t375", 24)):
        task, cfg, w, x = by_name[name]
        y = cells.serve(cfg, w, x, impl="kernel", plan={"bh": ask})
        y_p = cells.serve(cfg, w, x, impl="kernel", plan={"impl": "plain"})
        torch.cuda.synchronize()
        e = max_err(y, y_p)
        legal = fr.legal_bh(cfg.n_gates, cfg.hidden, ask, 1, False)
        log(f"[4] {name:16s} plan bh={ask} served at bh={legal}: "
            f"max|kernel-plain| over all T={x.shape[0]} = {e:.3e} (atol {ATOL})")
        if not e <= ATOL:
            raise AssertionError(f"{name}: plan bh={ask} disagrees")

    # timings: kernel wrapper, plain version, cuDNN yardstick
    for row in rows:
        task, cfg, w, x = next(t for t in inputs if t[0].name == row["task"])
        pers = row["kernel"].endswith("persistent")
        wx, wh, s_x, s_h = _weights_for_kernel(cfg, w)
        o = dict(x=x, w_x=wx, w_h=wh, s_x=s_x, s_h=s_h, b=w["b"],
                 b_h=w.get("b_h"), h0=torch.zeros((1, cfg.hidden), device=dev),
                 c0=torch.zeros((1, cfg.hidden), device=dev))
        bh = default_bh(cfg, 1, pers)
        row["bh"] = bh
        row["ms"] = cuda_ms(lambda: call(fr, cfg.cell, o, bh, pers), REPS_KERNEL)
        row["serve_ms"] = cuda_ms(
            lambda: cells.serve(cfg, w, x, impl="kernel",
                                plan={"persistent": True} if pers else None),
            REPS_KERNEL)
        row["plain_ms"] = cuda_ms(
            lambda: call(fr, cfg.cell, o, bh, pers, plain=True), REPS_PLAIN)
        mod = library_module(cfg, w, dev)
        with torch.no_grad():
            row["library_ms"] = cuda_ms(lambda: mod(x), REPS_KERNEL)
            row["library_vs_kernel_err"] = max_err(mod(x)[0],
                                                   outs[(task.name, pers)])
        T, G, H, R = x.shape[0], cfg.n_gates, cfg.hidden, cfg.d + cfg.hidden
        nbytes = (G * H * R * 1 + 4 * G * H * 4 + T * cfg.d * 2 + T * H * 2)
        ops = 2.0 * G * H * R * T
        row["bound_bytes_ms"] = nbytes / spec.hbm_bw * 1e3
        row["bound_ops_ms"] = ops / spec.peak_bf16_flops * 1e3
        row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
        row["weight_stream_ms"] = dse.weight_stream_bound_s(cfg, T, spec) * 1e3
        row["handoff_model_ms"] = dse.handoff_bound_s(T) * 1e3
        row["dse_model_ms"] = (dse.best_plan(
            cfg, spec, persistent=pers).step_latency_s * T
            + dse.xproj_latency_s(cfg, T, spec)) * 1e3
        row["launches_one_request"] = 2 if pers else T + 1
        row["wh_stream_ms"] = dse.wh_stream_bound_s(cfg, T, spec) * 1e3
        if pers:
            persist_timings(fr, row, cfg, o, x, bh, dev, smi)
        else:
            stream_timings(fr, row, cfg, o, x, bh, dev, spec, smi)
        log(f"[4] {row['task']:16s} {row['kernel']:22s} bh={bh:<4d} "
            f"kernel {row['ms']:.4f} ms | serve {row['serve_ms']:.4f} | "
            f"plain {row['plain_ms']:.4f} | cuDNN {row['library_ms']:.4f} "
            f"(|cuDNN-kernel| {row['library_vs_kernel_err']:.2e}) | bound "
            f"{row['bound_ms']:.5f} ("
            f"{'bytes' if row['bound_bytes_ms'] >= row['bound_ops_ms'] else 'operations'}"
            f") | weights/step "
            f"{row['weight_stream_ms']:.4f} | W_h/step "
            f"{row['wh_stream_ms']:.4f} | dse model "
            f"{row['dse_model_ms']:.4f}")
    report["tasks"] = rows
    report["tile_sweep"] = stream_tile_sweep(fr, dse, inputs, dev, spec, smi)
    report["persist_sweep"] = persist_tile_sweep(fr, dse, inputs, dev, spec,
                                                 smi)
    report["xproj_sweep"] = xproj_tile_sweep(fr, inputs, dev, smi)

    # ---- 4b. LM main path: rwkv6-1.6b through the serving engine ---------
    lm = lm_main_path(rk, dev, spec, smi)
    report["lm"] = lm

    # ---- 4c. dense LM main path: qwen2.5-14b through the engine ----------
    qw, qparams = qwen_main_path(fa, fd, dev, spec, smi)
    report["qwen"] = qw

    # ---- 4d. qwen2.5-14b with int8 weights through the engine ------------
    q8 = qwen_int8_main_path(mm, dev, spec, smi, qparams)
    del qparams
    report["qwen_int8"] = q8
    q8["prefill_vs_bf16"] = q8["prefill_ms_4x512"] / qw["prefill_ms_4x512"]
    log(f"[4d] 4-row prefill at bucket 512: int8 {q8['prefill_ms_4x512']:.3f} "
        f"ms = {q8['prefill_vs_bf16']:.3f} x the bf16 tree's "
        f"{qw['prefill_ms_4x512']:.3f} ms (4c) [{smi}]")
    for B in (1, 4):
        q8[f"bf16_cublas_tick_ms_b{B}"] = kernel_ms(qw[f"busy_b{B}"],
                                                    CUBLAS_MARKS)
        log(f"[4d] B={B} tick, device time by the profiler: matmul_w8a16 "
            f"{q8[f'mm_tick_ms_b{B}']:.3f} ms a int8 tick (cuBLAS in it, "
            f"the plain head: {q8[f'cublas_tick_ms_b{B}']:.3f} ms) against "
            f"cuBLAS {q8[f'bf16_cublas_tick_ms_b{B}']:.3f} ms a bf16 tick "
            f"(4c); the int8 tick {q8[f'tick_ms_b{B}']:.3f} ms = "
            f"{q8[f'tick_ms_b{B}'] / qw[f'tick_ms_b{B}']:.3f} x 4c's "
            f"{qw[f'tick_ms_b{B}']:.3f} ms [{smi}]")

    # ---- 4e. open-loop serving: rwkv6-1.6b cells through drive ----------
    report["open_loop"] = open_loop_main_path(rk, dev, smi)
    report["open_loop"]["qwen_base"] = qw["open_loop"]
    report["open_loop"]["qwen_paged"] = qw["paged"]
    report["chaos"] = {"rwkv6-1.6b": report["open_loop"].pop("chaos"),
                       "qwen2.5-14b": qw["chaos"]}
    log(f"[4g] phase 4g: "
        f"{sum(c['phase_s'] for c in report['chaos'].values()):.1f} s, six "
        f"storm cells [{smi}]")
    report["trace"] = {"rwkv6-1.6b": report["open_loop"].pop("trace"),
                       "qwen2.5-14b": qw.pop("trace")}
    log(f"[4h] phase 4h: "
        f"{sum(c['phase_s'] for c in report['trace'].values()):.1f} s, "
        f"three traced cells [{smi}]")
    fleet = report["fleet"] = report["open_loop"].pop("fleet")

    # ---- 4j. the MoE archs at full width through the engine -------------
    moe = report["moe"] = moe_main_path(fa, fd, dev, spec, smi)

    # ---- 4k. hymba at full width through the engine -----------------------
    hy = report["hymba"] = hymba_main_path(fa, fd, dev, spec, smi)

    # ---- 4l. the planner: autotuned plans served at full width -----------
    pl = report["planner"] = planner_main_path(
        rk, dev, smi, report["open_loop"]["overload"])
    pl["hymba"] = hy.pop("planner")

    # ---- 5. counters and the kernels line ---------------------------------
    kernels = []
    for name in fr.LAUNCHES:
        cell = name.split("_")[1]
        # the projection's numbers come from its cell's streaming rows
        proj = name.endswith("_xproj")
        key = "xproj_" if proj else ""
        sel = [r for r in rows
               if r["kernel"] == (f"fused_{cell}" if proj else name)]
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
        b_bytes = sum(r[f"{key}bound_bytes_ms"] for r in sel)
        b_ops = sum(r[f"{key}bound_ops_ms"] for r in sel)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[cell],
            launches=launches[name], max_abs_err=errs[name],
            ms=sum(r[f"{key}ms"] for r in sel),
            plain_ms=sum(r[f"{key}plain_ms"] for r in sel),
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=sum(r[f"{key}library_ms"] for r in sel)))
    # rwkv6_step and decode_loop also count phase 4i's fleet drives and
    # 4l's served rwkv cells, and the flash kernels and decode_loop phase
    # 4j's and 4k's runs and 4l's hymba cell (each run's counters set to 0
    # just before it and read just after)
    pla, plh = pl["launches"], pl["hymba"]["launches"]
    for key in ("rwkv6_step", "decode_loop"):
        if fleet["launches"].get(key, 0) <= 0 or pla[key] <= 0:
            raise AssertionError(f"{key} was never launched in the fleet "
                                 f"or the autotuned cells")
    if lm["launches"] <= 0:
        raise AssertionError("rwkv6_step was never launched on the main path")
    # of a kernel's launches, those made by decode graph launches (its
    # nodes in the captured tick x the ticks the device ran) and its nodes
    # in that tick, read from the instantiated graph
    in_graph = lambda res, key: dict(
        graph_launches=res["graph_launches"].get(key, 0),
        nodes_per_tick=res["nodes_per_tick"].get(key, 0))
    kernels.append(dict(
        name="rwkv6_step", route="cuda", source=RWKV_SOURCE,
        replaces=REPLACES["rwkv6_step"],
        launches=(lm["launches"] + fleet["launches"]["rwkv6_step"]
                  + pla["rwkv6_step"]),
        planner_launches=pla["rwkv6_step"], max_abs_err=rwkv_err, ms=lm["step_ms"], plain_ms=lm["step_plain_ms"],
        bound_ms=lm["step_bound_ms"], bound_by=lm["step_bound_by"],
        library_ms=None, **in_graph(lm, "rwkv6_step")))
    kernels[-1]["graph_launches"] += (fleet["launches"]["rwkv6_step"]
                                      + pla["rwkv6_step"])
    # ms and library_ms: a call's device time from a CUDA graph, for both
    for name, key, err, ms, lib in (
            ("flash_attention", "fa", fa_err, "fa_ms", "fa_sdpa_ms"),
            ("flash_decode", "fd", fd_err, "fd_graph_ms",
             "fd_sdpa_graph_ms")):
        if qw[f"{name}_launches"] <= 0 or moe["launches"][name] <= 0 \
                or hy["launches"][name] <= 0 or plh[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")
        kernels.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE,
            replaces=REPLACES[name],
            launches=(qw[f"{name}_launches"] + moe["launches"][name]
                      + hy["launches"][name] + plh[name]),
            moe_launches=moe["launches"][name],
            hymba_launches=hy["launches"][name], planner_launches=plh[name],
            max_abs_err=err, ms=qw[ms],
            plain_ms=qw[f"{key}_plain_ms"], bound_ms=qw[f"{key}_bound_ms"],
            bound_by=qw[f"{key}_bound_by"], library_ms=qw[lib],
            **in_graph(qw, name)))
        if name == "flash_decode":   # 4j's, 4k's and 4l's decode launches
            kernels[-1]["graph_launches"] += (      # are the graph's
                moe["launches"][name] + hy["launches"][name] + plh[name])
    if q8["launches"] <= 0:
        raise AssertionError("matmul_w8a16 was never launched on the main "
                             "path")
    kernels.append(dict(
        name="matmul_w8a16", route="cuda", source=MM_SOURCE,
        replaces=REPLACES["matmul_w8a16"], launches=q8["launches"],
        max_abs_err=mm_err["decode"], ms=q8["layer_mean_ms"],
        plain_ms=q8["layer_mean_plain_ms"],
        bound_ms=q8["layer_mean_bound_ms"], bound_by=q8["layer_bound_by"],
        library_ms=q8["layer_mean_cublas_bf16_ms"],
        **in_graph(q8, "matmul_w8a16")))
    if q8["prefill_launches"] <= 0:
        raise AssertionError("matmul_w8a16_prefill was never launched on the "
                             "main path")
    kernels.append(dict(
        name="matmul_w8a16_prefill", route="cuda", source=MM_SOURCE,
        replaces=REPLACES["matmul_w8a16"], launches=q8["prefill_launches"],
        max_abs_err=mm_err["prefill"], ms=q8["prefill_layer_mean_ms"],
        plain_ms=q8["prefill_layer_mean_plain_ms"],
        bound_ms=q8["prefill_layer_mean_bound_ms"],
        bound_by=q8["prefill_layer_bound_by"],
        library_ms=q8["prefill_layer_mean_cublas_bf16_ms"],
        **in_graph(q8, "matmul_w8a16_prefill")))
    if lm["loop_launches"] <= 0:
        raise AssertionError("decode_loop was never launched on the main "
                             "path")
    kernels.append(dict(
        name="decode_loop", route="cuda", source=LOOP_SOURCE,
        replaces=REPLACES["decode_loop"],
        launches=(lm["loop_launches"] + fleet["launches"]["decode_loop"]
                  + moe["launches"]["decode_loop"]
                  + hy["launches"]["decode_loop"] + pla["decode_loop"]
                  + plh["decode_loop"]),
        planner_launches=pla["decode_loop"] + plh["decode_loop"],
        max_abs_err=loop_k["max_abs_err"], ms=loop_k["ms"],
        plain_ms=loop_k["plain_ms"], bound_ms=loop_k["bound_ms"],
        bound_by=loop_k["bound_by"], library_ms=None,
        **in_graph(lm, "decode_loop")))
    kernels[-1]["graph_launches"] += (fleet["launches"]["decode_loop"]
                                      + moe["launches"]["decode_loop"]
                                      + hy["launches"]["decode_loop"]
                                      + pla["decode_loop"]
                                      + plh["decode_loop"])
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(nvidia_smi())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
