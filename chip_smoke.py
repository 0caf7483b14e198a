#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving paths (Llama, greedy and sampled,
with and without self-speculation, every decode tick, verify window,
prefill chunk and batched prefill a CUDA graph replay, behind the HTTP
server, across a fleet of replicas, and GPT, rotary too) and
training paths (GPT under amp O1 and O2, with and without recompute, and
Llama on packed documents; the resilient loop with its data feed and
checkpoints; elastic data-parallel ranks as processes, reforming after a
SIGKILL; data parallelism over torch.distributed, two ranks on the card;
context parallelism, ring and Ulysses, two sequence ranks on the card;
tensor parallelism, two mp ranks on the card; ZeRO, stages os, os_g and
p_g_os, two sharding ranks on the card; pipeline parallelism, two stages
on the card) on one H100 and hold each of its hand-written kernels
against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
final line):

  1. device  - the card's name and power limit (nvidia-smi); capability 9.0
  2. build   - nvcc builds every CUDA source under paddle_tpu_torch/csrc/,
               one process per source, all at once
  3. kernels - each kernel against its plain version on the card, in bf16
               and fp32 (and fp16 at the main shapes), at its path's
               shapes: max |error| within the stated tolerance, and median
               time (CUDA events; 5 x 20 calls, a plain version or library
               call slower than 2 ms a call 3 x 3) beside the plain
               version's, one PyTorch
               library call's where one computes the same function (a
               yardstick only; the port never calls it), and the bound: the
               larger of bytes moved / 3.35 TB/s and operations / the peak
               rate of the input type; for the short serving rows (RMSNorm,
               both RoPEs, paged decode, bf16) also device_ms, the
               profiler's kernel time a call, and host_us, the host's wall
               time a call over 200 calls without a synchronise, for the
               kernel and its library call. RMSNorm's forward route (the
               CUDA kernel alone, no Triton launch) and the host time of
               each part of a serving call. Paged decode runs at the main path's
               shapes with the split count the wrapper chooses there and
               with five splits, and at GQA groups 2-32 (16 and 32 run the
               verify kernel as a window of one token), plus a sweep of
               its split count (by time_ms and, the host's launches
               hidden, by queued_ms) beside the tensor-core verify kernel
               run as a window of one token on the same inputs; the paged
               verify window at the spec slice's (8 slots, W = 5, 32
               heads, d 128, windows ending at 17-2048) at the chosen
               count and at one
               split, a GQA window of 72 rows (hq 32, hkv 4, sq 9), windows
               that run past a 4-page table into the null page, and sq = 1
               against the decode kernel at base + 1, plus a sweep of its
               split count; flash attention at GPT-3 1.3B's (b 4, s 2048, h
               16, d 128, causal) and at an mp rank's (h 8), at d 64,
               non-causal with sq != sk, at d
               256 and at d 80 (ragged s 300); which template each call
               takes (tensor cores for bf16 at d % 8 == 0 with aligned
               tensors, CUDA cores at d 36, one element off alignment, fp32
               and fp16; the same for the verify window, a g 16 decode
               step and a bf16 one off alignment, and the decode kernel
               for g <= 8 in every dtype; kernel names from
               torch.profiler); segmented flash at
               the packed slice's (b 2, s 4096, h 32, d 128, causal, its
               segment layout; bf16 and fp16) and a small case in every
               dtype (d 64, s 300, non-causal, a -1 padding tail, rows with
               no live key and keys with no live query, whose o and dq, dk
               and dv must be exactly 0); dense and segmented flash at b *
               h = 65,540 (past grid.y's 65535); the RMSNorm backward at
               [8192, 4096]; RoPE of q and k in one launch (32 + 32
               heads, d 128) at a prefill chunk, a decode tick, a batched
               prefill and a verify window, each beside the one-tensor
               call, and with sign -1 (the backward) at [2, 4096, 32 + 32,
               128], contiguous and at the slice's per-document positions,
               in fp32, bf16 and fp16, plus GQA (32 over 8 heads) and the
               scalar path (d 90, positions past the table); RoPE's route
               (one CUDA kernel a fused call, vector or scalar path, and
               one each for an autograd forward and backward: kernel names
               from torch.profiler); AdamW over GPT-3 1.3B's flat size and
               a ragged small one, in its fp32 form and in its master form
               (amp O2: fp32 master, m and v, a bf16 gradient and a device
               clip factor; the bf16 copy must equal the kernel's master
               cast to bf16 and a launch with the skip flag set must change
               no byte), and its fp32 form on ZeRO's shard at two ranks:
               parameters and gradients as views that start at rank 1's
               chunk of GPT-3 1.3B's padded flat buffers (zero_slice's
               stages os and os_g)
  4. parity  - Llama at full width, 2 layers, fp32 (TF32 off), seeded
               weights: ServingEngine.generate must equal model.generate token
               for token, greedy; every tick of a kind replayed its graph;
               generate()'s calls (a host-int pos) launch contiguous RoPE
               once a layer a call (the kernel summary's count for it)
  5. spec_parity - Llama-2-7B's and GPT-3 1.3B's widths, 2 layers each,
               fp32, prefix cache on: ServingEngine(spec_k=4) must equal
               ServingEngine(spec_k=0) and model.generate token for token,
               with the seeded weights and then with the head zeroed (every
               target 0); over the phase, verify ticks, accepted drafts and
               rollbacks must all be > 0, and every tick replayed its graph
  6. fuse_parity - the same widths and 2 layers, fp32 (TF32 off):
               ServingEngine(fuse_steps=4), whose greedy ticks replay a
               captured 4-step CUDA graph, must equal fuse_steps=1 and
               model.generate token for token (budgets not multiples of 4,
               an eos inside a fused chunk, a request reaching
               max_model_len while another decodes on its cached prefix);
               then a prefill_only prompt's KV blocks over /kv/export and
               /kv/ingest between two ServingServers: pages bitwise equal,
               the receiver's decode (a full prefix hit) equal to the
               sender's
  7. sampler - the same widths and 2 layers, fp32: the engine's sampler
               captured as a CUDA graph with its generator registered,
               replayed between eager draws: each of 6 x 20,000 draws of a
               64-way row within total variation 0.02 of softmax(logits /
               0.8), no two alike; two engines seeded alike give the same
               tokens on a mixed batch (greedy, 0.8, greedy, 1e-6), another
               seed other sampled tokens; greedy and 1e-6 rows equal
               generate(); every sampled tick replayed the sampled graph
  8. slice   - main path 1: Llama-2-7B at full depth in bf16 served by
               ServingEngine (8 slots, 16-token blocks, 2048 context) over 10
               requests (prompts 16-1024 tokens, two sharing a 256-token
               prefix, one repeated for a copy-on-write hit), 64 new tokens
               each, at fuse_steps 1 and then 4 (tokens/s, TTFT, the two
               runs' bf16 agreement); every serving kernel's launch count
               over each run must be > 0, per-token RoPE must launch once a
               layer a step in a pure decode tick (a graph replay's
               launches added to the counts), paged decode once a layer a
               decode step, and every decode tick and single-prompt
               prefill chunk must have replayed its graph
  9. sampled_slice - the same requests with every other one at
               temperature 0.8, fuse_steps 4: tokens/s, TTFT, replays and
               ticks by kind, launches a replay; every sampled tick must
               have replayed the sampled graph, with paged decode 32 a step
 10. graph_tick - Llama-2-7B's widths cut to 2 layers (CUT_LAYERS, to
               fit the time limit beside the elastic phases), bf16, 8 slots
               decoding at 512 context: each
               graph body run eagerly against its replay from one saved
               state: greedy k = 1 and 4 (tokens, bitwise K/V rows), the
               sampled step (the greedy slots' tokens, K/V rows), a 256-token
               prefill chunk in the lane (logits, lane rows), a batched
               prefill of 8 rows of 64 tokens at P 256 and at a 2,000-token
               offset (the largest P captured; first tokens, the rows'
               suffix blocks bitwise) and, on a spec_k = 4 engine, the
               verify window (greedy, acc, nxt, K/V rows);
               a replay's launches RMSNorm 2L + 1, RoPE L, and paged decode
               L a step or paged verify L; the kernel names torch.profiler
               records for one decode replay; wall and device-busy ms and
               the busy share, eager body against graph, for each, and
               whole engine ticks at fuse_steps 1 and 4; pool bytes by kind
 11. server_slice - main path 5: a ServingServer(port=0) over the 7B
               engine with fuse_steps=4: 8 concurrent HTTP clients (4
               streaming), 64 new tokens each, every stream's lines adding
               up to its count; /metrics parsed back (TTFT count = the
               requests), /healthz 200, /stats consistent; every tick
               replayed its graph; a prefill_only 1,024-token prompt
               exported over /kv/export and ingested by a second server (64
               blocks, their bytes, pages bitwise equal, a full prefix hit
               on the receiver)
 12. spec_slice - main path 4: the same model and engine with spec_k=4
               (ngram 3, pause 32) over 10 requests (7 repetitive: 16-48
               token patterns repeated to 128-1024 tokens; 3 random), 64
               new tokens each, then the same requests with spec_k=0:
               tokens/s, mean TTFT, the speculation counters, launches a
               tick and the bf16 agreement of the two runs; first with the
               seeded weights, then (the main path) with the head zeroed,
               every target 0; paged verify launches must be 32 x verify
               ticks and paged decode 32 x plain decode ticks, every tick
               must have replayed its graph, verify replays > 0 on the main
               path, with drafts accepted and rolled back
 13. fleet_parity - the fleet in fp32 (TF32 off): two replicas from an
               identically seeded factory (Llama-2-7B widths, 2 layers; 4
               slots, 1024 context), real threads under a FleetRouter;
               every request's tokens must equal model.generate's in each
               scenario: affinity (a shared 256-token prefix served where
               it is cached), a kill mid-decode with re-dispatch, a hedge
               past the TTFT deadline (loser cancelled, its slot and KV
               freed), drain and resume, a migrating drain mid-decode
               (every migrated session a full prefix hit on its streamed
               chain), 1 prefill + 1 decode (no prefill token on the decode
               replica), the autoscaler growing 1 -> 2 (the new engine
               captured while replica-0 replays: equal launch deltas) and
               shrinking back; no breaker strike, no unfinished request;
               then a rotary GPT (GPT-3 1.3B widths, 2 layers):
               generate() and the engine equal, RoPE launched by both
 14. fleet_slice - two replicas of Llama-2-7B's widths cut to 2 layers
               (CUT_LAYERS) in bf16 (8
               slots, 16-token blocks, 256-token chunks, 2048 context)
               under a FleetRouter with real threads, fresh engines an
               arm: one replica against two on slice 1's 10 requests and
               a burst of 24 prompts of 16-48 tokens (32-64 new); 1
               prefill + 1 decode on the burst; one 16-slot replica on
               both; two replicas with a migrate=True drain of replica-0
               a third into a burst answered at 128-256 tokens, once as
               a user drains (the replica ticking on) and once with it
               paused: tokens/s,
               mean TTFT, re-dispatched, hedged, shed and migrated
               requests, each KV transfer's blocks, bytes and export
               and ingest seconds, prefill tokens by replica,
               graph_stats() by replica, peak memory, construction
               seconds; a device trace of one burst on one replica and
               on two (busy share, streams, gaps); raises on a breaker
               strike, an unfinished request, a prefill token on the
               decode replica, a drain that moved nothing or a
               moved session without its streamed prefix, a serving
               kernel not launched or a tick not replayed (batched
               prefills included)
 15. proc_fleet_parity - the fleet's replicas as child processes
               (serving/fleet_proc.py), in fp32 (TF32 off): two children
               from an identically seeded factory (chip_smoke:
               proc_llama_2l: Llama-2-7B widths, 2 layers; 4 slots, 1024
               context) under a FleetRouter over a native.TCPStore, the
               children's store traffic through a StorePartitionProxy;
               generate()'s tokens are computed first and the card
               freed. Every request's tokens must equal them across:
               a cancel while the child replays decode graphs (the
               child sheds it as a disconnect and frees its slot); a
               SIGKILL mid-decode (re-dispatched; a respawn under fence
               + 1, warming until its probe passes, last_exit -9); a
               SIGSTOP (lease expiry, a respawn after the grace; on
               SIGCONT the zombie exits 43 without beating its lease
               again); a store stall that heals inside the grace (no
               respawn, no fence bump); a migrate=1 drain mid-decode
               (at least one session moved); 1 prefill + 1 decode (the
               KV over /kv/export and /kv/ingest, no prefill token on
               the decode child); the autoscaler spawning a process
               replica from a spec under a burst and retiring one
               through a migrating drain and remove_replica (its child
               gone); every child launched every serving kernel; no
               breaker strike, no unplanned respawn or exit, no child
               alive after router.stop()
 16. proc_fleet_slice - Llama-2-7B's widths cut to 2 layers (CUT_LAYERS) in
               bf16, each replica a
               child process (proc_llama_7b; 8 slots, 16-token blocks,
               256-token chunks, 2048 context), fresh children an arm:
               one and two on fleet_slice's traffic, 1 prefill + 1
               decode on its burst, and on the two a SIGKILL of
               replica-0 a third into another burst (every request
               finishes, replica-0 comes back): tokens/s, mean TTFT,
               spawn-to-ready seconds by part, respawn seconds, KV
               transfers, each child's memory (/stats) and nvidia-smi's
               compute apps, replays by child, the serving kernels'
               launches summed over the children (from each child's
               /stats before and after a run), beside fleet_slice's
               thread replicas of the same run; raises as
               proc_fleet_parity does, and on a request without its
               tokens or a prefill token on the decode child
 17. gpt_serve_slice - GPT-3 1.3B at full depth in bf16 with spec_k=4 (8
               slots, 16-token blocks, 2048 context = its positions): a
               1,990-token repetitive prompt that reaches the end of the
               context, five shorter ones, then a 1,984-token cached prefix
               plus 10 tokens batched with a 200-token prompt (bucket
               padding past the wpe table); with the seeded weights and
               then with the tied head zeroed (every target 0, so the long
               request's windows run past the table too); no output logit
               may be non-finite, paged decode and verify must launch, and
               every tick must have replayed its graph
 18. train_parity - GPT at GPT-3 1.3B's width, 1 layer (CPU_PARITY_LAYERS),
               fp32 (TF32 off):
               three TrainSteps (AdamW, global-norm clip) on the card and the
               same three on the CPU (plain versions) from the same weights
               and batch; losses and parameters must agree (bounds below)
 19. train_slice - main path 2: GPT-3 1.3B at full depth, amp O1 (bf16),
               AdamW, batch 4 x 2048 through TrainStep: one warm-up step and
               three timed steps on one repeated batch; loss, step time,
               tokens/s, peak memory and launches per step; every training
               kernel's launch count over this phase must be > 0
 20. train_o2_parity - GPT at GPT-3 1.3B's width, 1 layer, amp O2
               (decorate: bf16 parameters, fp32 masters): three TrainSteps
               on the card and on the CPU from the same weights and batch;
               losses and masters must agree (bounds below)
 21. train_o2_slice - main path 2 under amp O2: GPT-3 1.3B decorated,
               auto_cast O2, global-norm clip, AdamW over LinearWarmup(
               CosineAnnealingDecay), TrainStep(nan_guard=True,
               telemetry=True) with FLAGS_metrics on: a warm-up and three
               timed steps on the O1 slice's batch (step time beside O1's,
               tokens/s, peak memory), a step with a NaN loss that must be
               skipped with every flat buffer's bits and the beta powers
               unchanged, a clean step; launches per step (flash 24 each,
               the AdamW master form once per run, the fp32 form 0), one
               step record a step, a nan_guard flight dump, MFU from the
               H100 peak; then GradScaler over two eager steps (an
               overflowing one skipped with the scale halved, a clean one
               that updates)
 22. train_parity (packed Llama) - Llama-2-7B's width, 1 layer, fp32, one
               packed row of 256 tokens (four documents and a padding tail):
               three TrainSteps on the card and on the CPU, as in 18
 23. train_packed_slice - main path 3: Llama-2-7B at its published widths
               cut to 8 layers, amp O1, AdamW, one packed batch of 2 x 4096
               tokens from PackedLMBatches: one warm-up step and three
               timed steps; loss, step time, tokens/s (all and non-padding),
               peak memory and launches per step, which must be the
               expected counts (segmented flash 8 each, RMSNorm and its
               backward 17, per-token RoPE 16 (q and k in one launch,
               forward and backward), AdamW 1, dense flash 0)
 24. recompute_parity - GPT at GPT-3 1.3B's width, 2 layers, fp32 (TF32
               off) and amp O2, and the packed Llama at Llama-2-7B's
               width, 2 layers, fp32 on one 256-token row: three
               TrainSteps with recompute on and three with it off from the
               same weights and batch; losses, parameters, masters and
               moments must be bitwise equal, and the launches a step
               those of `_want_launches` (a block's forward kernels twice,
               the backward ones once)
 25. recompute_slice - main path 5: GPT-3 1.3B at full depth under amp O2
               as the O2 slice runs it, first without recompute and then
               with recompute=True, batch 4 x 2048: a warm-up and three
               timed steps each (step time beside the O2 slice's, tokens/s,
               peak memory; flash forward 48, dQ 24, dK/dV 24 and the AdamW
               master form 1 a step with recompute); then batch 16 x 2048
               with recompute, a warm-up and two steps, whose peak must
               stay under the card's memory, beside the no-recompute peak
               extrapolated from batch 4
 26. io_feed - a seeded dataset of 64 token rows of 2048 through
               DataLoader(num_workers=2, forked process workers, shared
               memory, shuffle=True): the batch order must equal
               num_workers=0's; then through DevicePrefetcher(depth=2):
               batches/s, the prefetcher's wait, every batch on the card
 27. resilient_slice - GPT-3 1.3B's widths cut to 1 layer (a ~2.2 GB
               checkpoint), amp O2, recompute, hidden dropout 0.1, fed by
               io_feed's loader through the prefetcher, through
               ResilientTrainer over an async CheckpointManager
               (keep_last_n=2, save every 2 steps, NaN guard, FLAGS_metrics
               on); one step poisoned by chaos in every run: 8 steps
               uninterrupted (the poisoned step skipped, every flat
               buffer's bits unchanged across it); a crash injected at the
               step-6 commit, then a fresh trainer from other weights
               resumes from step 4; a SIGTERM before batch 3 (status
               "preempted", a final checkpoint), then a resume: both end
               bitwise equal to the uninterrupted run (parameters, masters,
               moments, beta powers, losses from the resume on); checkpoint
               bytes, the async save's caller and background seconds, the
               restore's seconds, telemetry's data and save phases; raises
               first if the temporary directory has less free space than
               five checkpoints, and removes it at the end
 28. elastic_parity - tools/faultbench.py's gate 4 with the port:
               ElasticTrainer ranks as processes (distributed.spawn) over a
               native.TCPStore this process hosts, GPT tiny (2 layers,
               hidden 128) in fp32, AdamW: two incumbents and a joiner
               that request_joins once the step-3 checkpoint committed,
               then a SIGKILL of rank 1; survivors 0 and 2 must finish all
               40 steps at world 2 after a grow to [0, 1, 2] and a shrink
               to [0, 2], replay at most save_every steps, hold bitwise-
               equal parameters and stay within 5e-3 of a clean two-thread
               world's losses; then two processes of ResilientTrainer(
               cluster=ClusterTelemetry) where rank 0 must flag the rank
               that sleeps in its loss, and its flight dump must carry the
               cluster view
 29. elastic_slice - GPT-3 1.3B at full width, cut to 1 layer
               (RANK_LAYERS, room for dp_slice and cp_slice), fp32
               parameters, amp O1, AdamW (the fused kernel's fp32 form),
               2 x 2048 tokens a rank, two rank processes on the card,
               save_every 2; rank 1 SIGKILLed once the step-2 checkpoint
               committed; the survivor reforms at world 1 from the
               rank-sharded checkpoint and finishes step 6: each rank's
               step split into fwd+bwd, D2H, pack, publish, collect,
               unpack+average, H2D and apply, bytes and MB/s, peak device
               memory, RSS of each rank and of the store's host, each
               save's bytes and seconds, the reform's detection, restore
               and first-step seconds, flash and AdamW launches summed over
               the ranks; the survivor against a clean run of the same
               six steps at world 1: its losses from the resumed step on
               within 1e-3, its final parameters within 5e-4 relative,
               a bound that must sit below the clean last update's move
 30. dp_slice - GPT-3 1.3B at full width, cut to 1 layer (RANK_LAYERS,
               room for cp_slice and mp_slice), under elastic_slice's
               settings (fp32 parameters, amp O1, AdamW's fp32 form) with a
               global-norm clip, sequence 2048, global batch 4, two rank
               processes on the card (distributed.spawn, init_parallel_env,
               fleet.init at dp_degree 2) stepping through
               fleet.dp_train_step: a warm-up and three timed steps with 4 MB
               buckets, then with one bucket. The backend is named:
               PADDLE_DISTRI_BACKEND=gloo, because NCCL refuses two ranks on
               one device; gloo reduces the CUDA tensors by staging them
               through pinned host memory (the tensors stay on the card, the
               transport is the host's). Each rank's step wall split into
               fwd+bwd (the hooks' reduces issued), the wait for the last
               bucket and apply; reduce_s (the comm-only probe), buckets,
               bytes reduced and GB/s; peak device memory and sampled RSS a
               rank; flash and AdamW launches summed over the ranks, which
               must be 24 of each flash kernel and 1 AdamW a step and rank;
               which collectives gloo takes on CUDA tensors (all_reduce and
               broadcast must; a bf16 all-reduce, all-gather and
               reduce-scatter, which mp_slice needs, are probed too);
               elastic_slice's world-2 step beside them.
               The ranks' flat buffers must be bitwise equal after every
               step (bit sums through the store); then a world-1 TrainStep
               runs the same eight steps from the same weights: losses
               within 1e-3, rank 0's final parameters within 5e-4 relative,
               a bound that must sit below the world-1 run's last update
 31. cp_slice - context parallelism: GPT-3 1.3B at full width, cut to 1
               layer (RANK_LAYERS, room for mp_slice; 24 before it)
               (fp32 parameters, amp O1, AdamW's fp32 form, a global-norm
               clip), global batch 4 x 2048, two sep rank processes on the
               card (distributed.spawn, init_parallel_env, fleet.init at
               sep_degree 2), each computing [4, 1024] of every step
               through TrainStep(dp_axis="dp"): GPT's sequence_parallel
               'ring', then 'ulysses', in the same processes from the same
               initial weights, a warm-up and three timed steps each. Over
               gloo; the K/V permutes and all-to-alls take the stated host
               route ("transport": "host-staged gloo": pinned host copies,
               gloo on the CPU tensors, copies back; the kernels stay on
               the card). Each rank's step wall split into fwd+bwd (the
               exchanges inside), the wait for the sep gradient sum and
               apply; the exchange's calls, bytes, seconds and MB/s; peak
               device memory and sampled RSS a rank; flash and AdamW
               launches summed over the ranks, which must be exactly 3 of
               each flash kernel a layer and step for the ring (rank 0 the
               diagonal chunk, rank 1 the diagonal and one past chunk), 2
               for Ulysses, and AdamW 1 a step and rank. The ranks' flat
               buffers must be bitwise equal after every step; then a
               world-1 TrainStep at sep=1 runs the same four steps on the
               whole batch from the same weights: each mode's losses within
               1e-3, rank 0's final parameters within 1e-3 relative, a bound
               that must sit below the world-1 run's last update
 32. mp_slice - tensor parallelism: GPT-3 1.3B at full width, cut to 1
               layer (RANK_LAYERS, room for zero_slice; 24 before it)
               (fp32 parameters, amp O1, AdamW's fp32 form, a global-norm
               clip through fleet's HybridParallelClipGrad), global batch 4
               x 2048, two mp rank processes on the card (distributed.spawn,
               init_parallel_env, fleet.init at mp_degree 2), each holding
               half of every sharded weight (8 heads, half the MLP, half
               the vocabulary: this rank's blocks of the seeded whole
               draw) and running the whole batch through TrainStep: a
               warm-up and three timed steps. Over gloo, whose own
               all-reduces, all-gathers and reduce-scatters of CUDA tensors
               stage through host memory (the routes named, "gloo-staged").
               Each rank's step wall split into fwd+bwd (the mp all-reduces
               inside), the clip's square-sum (its mp reduce) and apply;
               the mp collectives' calls, bytes, seconds, GB/s and the
               dtype each carried; peak device memory and sampled RSS a
               rank; flash and AdamW launches summed over the ranks, which
               must be 1 of each flash kernel a layer, step and rank and 1
               AdamW a step and rank.
               The replicated parameters must be bitwise equal across the
               ranks after every step (bit sums through the store); then a
               world-1 TrainStep runs the same four steps from the same
               seed: losses within 1e-3, the gathered final parameters
               within 1e-3 relative, a bound that must sit below the
               world-1 run's last update. On the ranks also: the Megatron
               pair (ColumnSequenceParallelLinear -> GELU ->
               RowSequenceParallelLinear at GPT's MLP widths, 2048 -> 8192
               -> 2048, [4, 2048] tokens, each rank on half the sequence) in
               fp32 against the dense product and its gradients (5e-5 of
               the largest value), and dp_slice's probe of which
               collectives gloo takes on CUDA tensors (a bf16 all-reduce
               among them)
 33. zero_slice - ZeRO: GPT-3 1.3B at full width (fp32 parameters, amp
               O1, AdamW's fp32 form, a global-norm clip of 1.0), global
               batch 4 x 2048, two sharding rank processes on the card
               (distributed.spawn, init_parallel_env under
               PADDLE_DISTRI_BACKEND=gloo, fleet.init at sharding_degree
               2, group_sharded_parallel, TrainStep), each on [2, 2048]
               of every step: stage os and stage os_g at RANK_LAYERS, a
               warm-up and three timed steps each, stage p_g_os at
               ZERO_STAGE3_LAYERS (2: it ran 24, then 8, then 4, until the
               script neared its limit), a warm-up and two timed steps
               (each unit gathered where it is used). Each rank's step wall split
               into fwd+bwd (stage 3's gathers and reduce-scatters inside,
               their host seconds apart), reduce-scatter, square-sum,
               AdamW and all-gather; the collectives' calls, bytes,
               seconds, GB/s and dtypes; the bytes allocated between
               steps, cuBLAS's workspaces freed and measured apart, which
               must be within 3% of 12, 10 and 8 bytes a parameter (and
               the batch); peak device memory and sampled RSS; stage 3's
               peak of live gathered bytes, at most the embeddings' and
               one block's fp32 bytes; flash and AdamW launches summed
               over the ranks, exactly 1 of each flash kernel a layer,
               step and rank and 1 AdamW a step and rank. At os and os_g
               the ranks' parameters must be bitwise equal after every
               step (bit sums through the store). Each stage against a
               world-1 TrainStep from the same seed on the whole batch:
               losses within 1e-3,
               the (gathered) final parameters within 5e-4 relative, a
               bound that must sit below the world-1 run's last update.
               The ranks save the os_g stage's model and optimizer after
               its steps with save_group_sharded_model(async_save=True)
               and wait_all; this process reads it back with
               load_sharded(target_world_size=1), which must equal the
               ranks' gathered state bitwise (a digest a leaf), and each
               rank's chunks of it its own shard buffers (bit sums of
               parameters, m and v, which no gather touched)
 34. pp_slice - pipeline parallelism: GPT-3 1.3B at full width, cut to 4
               layers (PIPE_LAYERS) (fp32 parameters, amp O1, AdamW's fp32
               form, a global-norm clip of 1.0 through fleet's hybrid
               optimizer), global batch 4 x 2048 in 4 microbatches of
               [1, 2048], two pp rank processes on the card
               (distributed.spawn, init_parallel_env, fleet.init at
               pp_degree 2): GPTForCausalLM.pipeline_descs into a
               PipelineLayer of two stages, copy_weights,
               fleet.distributed_model, train_batch; a warm-up and three
               timed steps at V = 1 (the tied head takes the interleave
               engine), then at virtual_pp_degree 2 from the same
               weights. The stage handoffs are collective_permutes over
               gloo's host route. Each rank's step wall split into the
               forward and backward slots, the handoffs, the tied ends'
               gradient sum, the clip's square-sum and AdamW; the
               handoffs' calls, bytes, MB/s and how many carried a
               microbatch; idle ticks; the most microbatch graphs held at
               once; peak device memory, bytes allocated between steps,
               sampled RSS; flash and AdamW launches summed over the
               ranks, exactly PIPE_LAYERS x 4 of each flash kernel a step
               and 1 AdamW a step and rank. The shared parameters must be
               bitwise equal across the ranks after every step; then a
               world-1 TrainStep runs the same steps on the whole batch
               from the same weights: each schedule's losses within 1e-3,
               its final parameters (the stages broadcast into rank 0's
               state_dict) within 5e-4 relative, a bound that must sit
               below the world-1 run's last update
 35. hybrid_pp_slice - pipeline parallelism beside tensor and data
               parallelism, four rank processes on the card over gloo
               (distributed.spawn, init_parallel_env, fleet.init with
               each mesh's hybrid configs in turn): mesh A, pp 2 x mp 2,
               Llama-2-7B at its published widths; mesh B, dp 2 x pp 2,
               GPT-3 1.3B at its published widths; both cut to 2 layers
               (HYBRID_LAYERS, one a stage), fp32 parameters, amp O1,
               AdamW's fp32 form, a global-norm clip of 1.0 through
               fleet's hybrid optimizer, 4 microbatches of [1, 2048] a
               rank (A: batch 4 x 2048; B: 8 x 2048, 4 rows a dp rank):
               pipeline_descs into a PipelineLayer of two stages built
               under the mesh (each rank's mp blocks), copy_weights,
               fleet.distributed_model, train_batch; a warm-up and three
               timed steps. Each rank's step wall split into the forward
               and backward slots (the mp all-reduces inside), the
               handoffs, the tied ends' sum, the dp reduce, the
               square-sum and AdamW; the handoffs' and mp collectives'
               calls, bytes and MB/s; peak and between-step memory and
               sampled RSS; every kernel's launches summed over the
               ranks, exact (A: flash, RMSNorm forward and backward,
               contiguous RoPE and AdamW; B: flash and AdamW). After
               every step the dp replicas must be bitwise equal, each mp
               pair's whole parameters and each pp pair's shared ends;
               then a world-1 TrainStep runs each mesh's steps on the
               whole batch from the same seed: losses within 1e-3, final
               parameters (gathered over mp) within 1e-3 (A) and 5e-4 (B)
               relative, a bound that must sit below the world-1 run's
               last update. `python3 chip_smoke.py hybrid_pp_slice A=8
               B=12` runs the build and this phase alone at those depths

Every phase's row carries `at_s`, the script's seconds when it ended. The
last two lines are the kernel summary {"kernels": [...]} and
{"ok": true, "device": {...}}. Exits non-zero without them when no CUDA
device is present or the package is not beside this script.
"""
import gc
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
# the depth of the Llama-2-7B-width models of graph_tick, fleet_slice and
# proc_fleet_slice, cut from 32 so that the elastic phases fit the
# script's time limit (main path 1, the serving slice, keeps all 32): 8
# until pp_slice joined the script after a full run from a git archive of
# 1,061 s on an H100 80GB HBM3 at 700 W (graph_tick 24 s, fleet_slice 56
# s, proc_fleet_slice 79 s at 8); then 4, until hybrid_pp_slice joined
# the script (a full run of 1,135 s on an H100 80GB HBM3 at 700 W:
# graph_tick 15.6 s, fleet_slice 35.2 s, proc_fleet_slice 69.7 s at 4);
# now 2. Their counts follow the depth (RMSNorm 2L + 1, RoPE L and paged
# decode L a replay)
CUT_LAYERS = 2
# the depth of the models that train_parity, train_o2_parity and the
# packed Llama's train_parity train on the card and again on the host's
# CPU: 2 until hybrid_pp_slice joined the script (the same full run:
# 10.8, 18.6 and 30.9 s, most of it the CPU's steps, whose embedding and
# head do not shrink with depth); now 1, a block of each kernel's path
CPU_PARITY_LAYERS = 1
# the depth of elastic_slice's and dp_slice's GPT-3 1.3B: 24 until the
# store exchange took 323 s of a 1,205 s run (elastic) and cp_slice joined
# the script (dp, 92-126 s); then 8, until runs of 960 and 1,245 s with
# cp_slice, where their exchanges took 116-138 s and 39-59 s (their time
# follows the parameters' bytes: 2.05 GB at 8 layers, 1.24 GB at 4); then
# 4, until a run of 1,155 s on a slow host (elastic 104 s, dp 37 s); now 2
# (0.83 GB). cp_slice's too since mp_slice joined the script (24 layers:
# 107-136 s), and mp_slice's since zero_slice did (24 layers: 51.8-72.8
# s, its collectives 4.97 GB a step and rank). zero_slice's stages os and
# os_g run it too. 1 since pp_slice joined the script (a full run of
# 1,127 s on an H100 80GB HBM3 at 700 W: elastic_slice 69 s, dp 35, cp
# 36, mp 27, zero 101 at 2 layers; their exchanges follow the parameters'
# bytes, 0.83 GB at 2 layers, 0.63 at 1)
RANK_LAYERS = 1
# the depth of zero_slice's stage p_g_os: 24 until a full run from a git
# archive took 1,186.3 s of the script's 1,200 on an H100 80GB HBM3 at
# 700 W (zero_slice 164.1 s, its stage 3 ~100 s of that: 16.65 GB of
# gathers and reduce-scatters a step and rank at 0.6-0.9 GB/s; 998.4 s
# on a faster host); then 8, until a run from a git archive took 1,102.2
# s on a slow host (zero_slice 123.9 s, stage 3 ~40 s of it: 8.8-11.4 s
# a step); then 4, until pp_slice joined the script (a run from a git
# archive of 1,061 s: zero_slice 94 s, a stage-3 step 5.2-8.2 s); now 2.
# The per-unit gathers, the backward's reduce-scatters and the
# gathered-bytes bound (the embeddings and one block) are the same at any
# depth of 2 or more
ZERO_STAGE3_LAYERS = 2
# the depth of pp_slice's GPT-3 1.3B (24 in the reference preset): its
# exchanges, the stage handoffs ([1, 2048, 2048] fp32 a microbatch) and
# the tied ends' gradient sum, are the same bytes at any depth. 8 until
# hybrid_pp_slice joined the script (full runs took 1,031.5-
# 1,127.1 s of the 1,200 on an H100 80GB HBM3 at 700 W, pp_slice
# 54.3-70.4 s of them); now 4, the least that V = 2's four chunks of
# equal blocks allow
PIPE_LAYERS = 4
# a yardstick (plain version, library call) slower than this a call is
# timed over 3 x 3 calls (time_ms), not 5 x 20: the slow plain versions
# took most of the kernels phase, and a run on a slow host passed the
# script's time limit
YARDSTICK_MS = 2.0
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
                  "torch.float32": 67e12}
SEED = 0


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row also gets `at_s`, the script's seconds
    when it ended."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def release(torch):
    """Free what the last phase left: collect the reference cycles that can
    keep a finished phase's model and KV pool alive, then return the cached
    blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(fn, iters=20, reps=5, long_ms=None):
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    by CUDA events, after a warm-up. With `long_ms`, a call that takes
    longer than that (one call timed after the warm-up) is timed over 3
    x 3 calls: a yardstick of several ms a call needs no hundred calls
    (the plain versions took most of the kernels phase that way)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if long_ms is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if start.elapsed_time(end) > long_ms:
            iters, reps = 3, 3
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


# the host's wait inside each profiler session before and after the
# profiled call (cuda_events): the room a kernel's device timestamp has
# around the call on the host's clock
PROFILE_PAD_S = 0.005
# every profiler session of the run (cuda_events): how many, how many came
# back empty, and where each session's first and last kernel sat in it
# (microseconds from the session's start, and to its end)
PROFILER_SESSIONS = {"sessions": 0, "empty": 0, "first_kernel_us": [],
                     "last_kernel_to_end_us": []}


def cuda_events(torch, fn, sessions=3):
    """The CUDA kernel events of one run of fn, by torch.profiler. Every fn
    profiled here launches at least one kernel.

    On the H100 (torch 2.11) a session deep into a full run now and then
    came back with no kernel, three in a row in one full run, which
    stopped it. The likely cause: Kineto keeps a device event only when
    it falls inside the session's capture window, which the host's clock
    bounds (it drops the others as out of range), and a device timestamp
    reaches the host's clock through a conversion whose offset can move
    over a long run; a session that held only the call (tens of
    microseconds for a RoPE launch) left no room for that offset. So
    each session waits PROFILE_PAD_S on the host before the call and
    after its synchronise, and a session that still records no kernel is
    run again with four times the wait, up to `sessions` in all; the
    last empty one raises. Every session's count, emptiness and its
    kernels' place in the window go to PROFILER_SESSIONS, which the
    kernels phase reports, so a run shows how far the kernels sat from
    the window's edges. fn must bear running more than once."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    pad = PROFILE_PAD_S
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            window_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.events() if e.device_type == cuda]
        PROFILER_SESSIONS["sessions"] += 1
        if events:
            PROFILER_SESSIONS["first_kernel_us"].append(
                min(e.time_range.start for e in events))
            PROFILER_SESSIONS["last_kernel_to_end_us"].append(
                window_us - max(e.time_range.end for e in events))
            return events
        PROFILER_SESSIONS["empty"] += 1
        pad *= 4
    raise AssertionError(f"torch.profiler recorded no kernel of the call "
                         f"in {sessions} sessions (PROFILER_SESSIONS: "
                         f"{_profiler_summary()})")


def _profiler_summary():
    """PROFILER_SESSIONS with each list as its least, median and most."""
    out = {"pad_s": PROFILE_PAD_S}
    for k, v in PROFILER_SESSIONS.items():
        out[k] = ([min(v), statistics.median(v), max(v)] if v else None) \
            if isinstance(v, list) else v
    return out


def device_ms(fn, calls=20):
    """Device time per call (ms): the sum of the durations of the CUDA
    kernels that `calls` calls launch, by torch.profiler, over the calls,
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()

    def run():
        for _ in range(calls):
            fn()

    spans = [e.time_range.end - e.time_range.start
             for e in cuda_events(torch, run)]
    return sum(spans) / 1e3 / calls


def host_us(fn, calls=200):
    """Host wall time per call (microseconds) over `calls` calls without a
    synchronise: what the Python call costs the host, launch included."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def queued_ms(fn, iters=20, reps=5):
    """Device time per call with the host's launch cost hidden: the stream
    first runs a 5 ms sleep kernel, long enough for the host to queue all
    `iters` calls behind it, which then run back to back between two CUDA
    events. Median over `reps`, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes, nops, dtype):
    """(least time in ms, what bounds it) for this work on an H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_OPS_PER_S[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ kernel cases
def _tol(dtype):
    import torch

    # Both sides do the same fp32 arithmetic in another order (max |error|
    # measured at most 1.2e-6 in fp32); in bf16 (fp16) both then round that
    # fp32 value once, so they may differ by one ulp, at most 2**-7 (2**-10)
    # of the value. The fp32 slack stays as the absolute term in all three.
    return {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7),
            torch.float16: (1e-5, 2.0 ** -10)}[dtype]


def _compare(name, shape, dtype, got, want, tol=None):
    """Max |got - want| over a tensor or a tuple of tensors. Without `tol`
    the bound is _tol(dtype)'s atol + rtol |want|; with tol = {dtype: (rtol,
    rms)} it is rtol |want| + rms * RMS(want), float32 outputs (lse)
    taking the float32 entry."""
    import torch

    if isinstance(got, (tuple, list)):
        return max(_compare(name, shape, dtype, g, w, tol)
                   for g, w in zip(got, want))
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if tol is None:
        atol, rtol = _tol(dtype)
        limit = atol + rtol * w.abs()
        said = f"atol {atol}, rtol {rtol:.3g}"
    else:
        rtol, rms = tol[got.dtype]
        limit = rtol * w.abs() + rms * w.square().mean().sqrt()
        said = f"rtol {rtol:.3g}, {rms:.3g} x RMS"
    ok = bool(torch.isfinite(g).all()) and bool((err <= limit).all())
    if not ok:
        raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees with "
                             f"the plain version (max abs err "
                             f"{err.max().item():.3g}, {said})")
    return float(err.max())


def rms_case(torch, gen, dtype, n, d=4096):
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    es = x.element_size()
    return dict(
        name="rms_norm", shape=[n, d],
        kernel=lambda: fused_norm.fused_rms_norm(x, w, eps),
        plain=lambda: fused_norm.rms_norm_plain(x, w, eps),
        library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps),
        nbytes=2 * n * d * es + d * es, nops=4 * n * d)


def rms_fwd_case(torch, gen, dtype, n, d=4096):
    """The forward as training runs it: both outputs of rms_norm_fwd, y and
    the fp32 rstd [n, 1] that the backward reads. fp32 y and rstd: the same
    fp32 arithmetic in another order, 1e-5 of the value and of the RMS; bf16
    y: one bf16 rounding (2**-7) of the value, plus the fp32 slack."""
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    eps = 1e-5
    es = x.element_size()
    return dict(
        name="rms_norm", shape=[n, d, "y and rstd"],
        tol={torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)},
        kernel=lambda: fused_norm.rms_norm_fwd(x, w, eps),
        plain=lambda: fused_norm.rms_norm_fwd_plain(x, w, eps),
        library=lambda: torch.nn.functional.rms_norm(x, (d,), w, eps),
        nbytes=2 * n * d * es + d * es + n * 4, nops=4 * n * d)


def _sign_shape(shape, sign):
    return shape if sign == 1 else shape + ["sign -1 (backward)"]


def _qk(torch, gen, dtype, b, s, h, hkv, d):
    """x [b, s, h, d], or (q, k) with k [b, s, hkv, d] where hkv is set."""
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    if hkv is None:
        return q, None
    return q, torch.randn(b, s, hkv, d, device="cuda", generator=gen).to(
        dtype)


def _rope_shape(b, s, h, hkv, d, sign):
    heads = h if hkv is None else f"{h}+{hkv}"
    return _sign_shape([b, s, heads, d], sign)


def rope_case(torch, gen, dtype, s, h=32, d=128, start=512, b=1, sign=1,
              hkv=None):
    """RoPE at contiguous positions [start, start + s): of x [b, s, h, d]
    alone, or, with hkv, of q and k [b, s, hkv, d] in one fused call (the
    model's call)."""
    from paddle_tpu_torch.ops.gpu import rope

    q, k = _qk(torch, gen, dtype, b, s, h, hkv, d)
    cos_t, sin_t = _tables(torch, start + s, d)
    cos, sin = cos_t[start:start + s].contiguous(), \
        sin_t[start:start + s].contiguous()
    n = q.numel() + (0 if k is None else k.numel())
    if k is None:
        kernel = lambda: rope.rope(q, cos, sin, sign)
        plain = lambda: rope.rope_plain(q, cos, sin, sign)
    else:
        kernel = lambda: rope.rope_qk(q, k, cos, sin, None, sign)
        plain = lambda: rope.rope_qk_plain(q, k, cos, sin, None, sign)
    return dict(
        name="rope", shape=_rope_shape(b, s, h, hkv, d, sign),
        kernel=kernel, plain=plain, library=None,
        nbytes=2 * n * q.element_size() + 2 * s * d * 4, nops=3 * n)


def rope_packed_case(torch, gen, dtype, b, s, h=32, d=128, P=4096,
                     pos=None, sign=1, hkv=None):
    """Per-token RoPE of x [b, s, h, d] alone, or, with hkv, of q and k
    [b, s, hkv, d] in one fused call. pos=None: ragged serving offsets;
    else the given positions [b, s]."""
    from paddle_tpu_torch.ops.gpu import rope

    q, k = _qk(torch, gen, dtype, b, s, h, hkv, d)
    cos_t, sin_t = _tables(torch, P, d)
    if pos is None:
        # ragged offsets, some rows running past the table's last position
        base = torch.randint(0, P + 64 - s, (b,), device="cuda",
                             generator=gen)
        pos = (base[:, None] + torch.arange(s, device="cuda")[None]).to(
            torch.int32).contiguous()
    rows = int(torch.unique(pos.clamp(0, P - 1)).numel())
    n = q.numel() + (0 if k is None else k.numel())
    if k is None:
        kernel = lambda: rope.rope_packed(q, cos_t, sin_t, pos, sign)
        plain = lambda: rope.rope_packed_plain(q, cos_t, sin_t, pos, sign)
    else:
        kernel = lambda: rope.rope_qk(q, k, cos_t, sin_t, pos, sign)
        plain = lambda: rope.rope_qk_plain(q, k, cos_t, sin_t, pos, sign)
    return dict(
        name="rope_packed", shape=_rope_shape(b, s, h, hkv, d, sign),
        kernel=kernel, plain=plain, library=None,
        nbytes=(2 * n * q.element_size() + pos.numel() * 4
                + 2 * rows * d * 4),
        nops=3 * n)


def rope_other_cases(torch, gen, dtype):
    """(None, case) pairs of the fused q+k call off the main shapes: GQA
    (32 over 8 heads) at decode and in a prefill chunk, and the scalar
    path (d 90: 45 elements a half-row are not whole 16-byte vectors) at
    per-token positions past a 64-row table, with sign 1 and -1."""
    return [(None, rope_packed_case(torch, gen, dtype, 8, 1, hkv=8)),
            (None, rope_case(torch, gen, dtype, 256, hkv=8)),
            (None, rope_packed_case(torch, gen, dtype, 2, 64, h=8, d=90,
                                    P=64, hkv=2)),
            (None, rope_packed_case(torch, gen, dtype, 2, 64, h=8, d=90,
                                    P=64, hkv=2, sign=-1)),
            (None, rope_case(torch, gen, dtype, 64, h=8, d=90, hkv=2))]


def paged_case(torch, gen, dtype, slots, hq, hkv, d, bs, ctx_lens,
               splits=None):
    """splits=None leaves the split count to the wrapper, as the serving
    path does (the printed shape then holds the count it chooses)."""
    from paddle_tpu_torch.ops.gpu import paged_attention as pa

    max_ctx = max(ctx_lens)
    maxb = -(-max_ctx // bs)
    nb = slots * maxb + 1
    kp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    q = torch.randn(slots, hq, d, device="cuda", generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    bt = perm[:slots * maxb].reshape(slots, maxb).to(torch.int32)
    cl = torch.tensor(ctx_lens, dtype=torch.int32, device="cuda")
    for r, c in enumerate(ctx_lens):      # null pages past each context
        bt[r, -(-c // bs):] = 0
    bt = bt.contiguous()
    scale = d ** -0.5
    shown = splits if splits is not None else pa.decode_splits(
        q, kp, vp, bt, torch.cuda.get_device_properties(0).multi_processor_count)
    # yardstick: one SDPA call over K/V already gathered (gather not timed)
    kg = kp[bt.long()].reshape(slots, maxb * bs, hkv, d)
    vg = vp[bt.long()].reshape(slots, maxb * bs, hkv, d)
    kg = kg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(maxb * bs, device="cuda")[None, :]
            < cl[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    es = q.element_size()
    live = sum(ctx_lens)
    return dict(
        name="paged_decode", inputs=(q, kp, vp, bt, cl, scale),
        shape=[slots, hq, hkv, d, bs, max_ctx, shown],
        kernel=lambda: pa.paged_attention(q, kp, vp, bt, cl, scale, splits),
        plain=lambda: pa.paged_attention_plain(q, kp, vp, bt, cl, scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale),
        nbytes=(2 * live * hkv * d * es + 2 * q.numel() * es
                + sum(-(-c // bs) for c in ctx_lens) * 4 + slots * 4),
        nops=4 * live * hq * d)


# the serving slice's decode contexts (8 slots, 17-2048 tokens)
DECODE_CTX = [2048, 1791, 1500, 1203, 900, 611, 300, 17]
# base lengths of the spec slice's verify shape: windows of 5 ending at
# 2048 ... 17, the decode cases' contexts
VERIFY_BASES = [2043, 1786, 1495, 1198, 895, 606, 295, 12]


def verify_case(torch, gen, dtype, slots, sq, hq, hkv, d, bs, bases,
                max_blocks=None, splits=None, as_decode=False):
    """The speculative verify window: sq queries a slot over base lengths
    `bases` (the window's own K/V already in the pages). The table is
    max_blocks wide (default: room for every window), null past each
    slot's window; a narrower one makes windows run past it. as_decode
    holds the kernel at sq = 1 against the decode kernel at bases + 1."""
    from paddle_tpu_torch.ops.gpu import paged_attention as pa

    maxb = max_blocks or -(-(max(bases) + sq) // bs)
    span = maxb * bs
    nb = slots * maxb + 1
    kp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(nb, bs, hkv, d, device="cuda", generator=gen).to(dtype)
    q = torch.randn(slots, sq, hq, d, device="cuda", generator=gen).to(dtype)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    bt = perm[:slots * maxb].reshape(slots, maxb).to(torch.int32)
    cl = torch.tensor(bases, dtype=torch.int32, device="cuda")
    for r, c in enumerate(bases):         # null pages past each window
        bt[r, -(-(c + sq) // bs):] = 0
    bt = bt.contiguous()
    scale = d ** -0.5
    shown = splits if splits is not None else pa.verify_splits(
        q, kp, vp, bt, torch.cuda.get_device_properties(0).multi_processor_count)
    # yardstick: one masked SDPA call over K/V already gathered
    kg = kp[bt.long()].reshape(slots, span, hkv, d)
    vg = vp[bt.long()].reshape(slots, span, hkv, d)
    kg = kg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vg = vg.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(span, device="cuda")[None, None, :]
            < (cl[:, None, None] + torch.arange(sq, device="cuda")[None, :,
                                                                   None]
               + 1))[:, None]
    qs = q.transpose(1, 2)
    es = q.element_size()
    # bytes: every position some row of a slot sees, read once; operations:
    # 4 flops per head-dim element for each (query, position) it sees
    seen = sum(min(c + sq, span) for c in bases)
    pairs = sum(min(c + i + 1, span) for c in bases for i in range(sq))
    case = dict(
        name="paged_verify",
        shape=[slots, sq, hq, hkv, d, bs, maxb, shown],
        kernel=lambda: pa.paged_attention_multi(q, kp, vp, bt, cl, scale,
                                                splits),
        plain=lambda: pa.paged_attention_multi_plain(q, kp, vp, bt, cl,
                                                     scale),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale),
        nbytes=(2 * seen * hkv * d * es + 2 * q.numel() * es
                + sum(-(-min(c + sq, span) // bs) for c in bases) * 4
                + slots * 4),
        nops=4 * pairs * hq * d)
    if as_decode:
        case["check"] = lambda: (
            pa.paged_attention_multi(q, kp, vp, bt, cl, scale, splits),
            pa.paged_attention(q[:, 0].contiguous(), kp, vp, bt, cl + 1,
                               scale, splits)[:, None])
    return case


# Flash attention: both sides compute in fp32 from the same inputs. fp32
# sums over up to s = 2048 products in another order (and the forward's
# online softmax rescales as it goes), so outputs differ by up to ~1e-4 of
# their RMS (measured 1.6e-4 for dK at the main shape): fp32 bound 1e-5 of
# the value + 1e-3 of the RMS. bf16: one bf16 rounding (2**-7) of the value
# and of the RMS, as in tests/test_torch_flash.py; fp16 (the CUDA-core
# templates, fp32 products) one fp16 rounding (2**-10) of each, which also
# covers the fp32 term.
def _flash_tol(torch):
    return {torch.float32: (1e-5, 1e-3),
            torch.bfloat16: (2.0 ** -7, 2.0 ** -7),
            torch.float16: (2.0 ** -10, 2.0 ** -10)}


def flash_cases(torch, gen, dtype, b, sq, sk, h, d, causal, library=True):
    """Three cases (forward, dQ, dK/dV) on one set of inputs; with library,
    SDPA's forward and backward as their yardsticks."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    def rnd(s):
        return torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)

    q, k, v, do = rnd(sq), rnd(sk), rnd(sk), rnd(sq)
    scale = d ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, scale, causal)
    delta = fa.attention_delta(o, do)
    sdpa_fwd = sdpa_bwd = None
    if library:
        # yardsticks: SDPA in its [b, h, s, d] layout, forward and backward
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        for t in (qt, kt, vt):
            t.requires_grad_(True)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale)

        out_t = sdpa()

        def sdpa_fwd():
            return sdpa().detach()

        def sdpa_bwd():
            return torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                       retain_graph=True)

    pairs = sq * (sq + 1) // 2 if causal else sq * sk   # unmasked (q, k)
    es = q.element_size()
    tensor = b * h * d * es
    rows = b * h * sq * 4                   # one fp32 lse / delta row
    shape = [b, sq, sk, h, d, "causal" if causal else "full"]
    ops = b * h * d * pairs
    tol = _flash_tol(torch)
    args = (q, k, v, do, lse, delta, scale, causal)
    return [
        dict(name="flash_fwd", shape=shape, tol=tol,
             kernel=lambda: fa.flash_fwd(q, k, v, scale, causal),
             plain=lambda: fa.flash_fwd_plain(q, k, v, scale, causal),
             library=sdpa_fwd,
             nbytes=tensor * (2 * sq + 2 * sk) + rows, nops=4 * ops),
        dict(name="flash_dq", shape=shape, tol=tol,
             kernel=lambda: fa.flash_dq(*args),
             plain=lambda: fa.flash_dq_plain(*args), library=sdpa_bwd,
             nbytes=tensor * (3 * sq + 2 * sk) + 2 * rows, nops=6 * ops),
        dict(name="flash_dkv", shape=shape, tol=tol,
             kernel=lambda: fa.flash_dkv(*args),
             plain=lambda: fa.flash_dkv_plain(*args), library=sdpa_bwd,
             nbytes=tensor * (2 * sq + 4 * sk) + 2 * rows, nops=8 * ops),
    ]


def live_pairs(torch, seg_q, seg_k, causal):
    """(q, k) pairs of this data that the segmented kernels must compute:
    equal segment ids (and k <= q when causal), summed over the batch: for
    packed rows, the sum over documents of L (L + 1) / 2 when causal."""
    live = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        live &= torch.ones(live.shape[1:], dtype=torch.bool,
                           device=live.device).tril()
    return int(live.sum())


def seg_flash_cases(torch, gen, dtype, seg_q, h, d, causal, seg_k=None,
                    library=True):
    """Segmented forward, dQ and dK/dV on one set of inputs: q, k, v
    [b, s, h, d] with segment ids seg_q (and seg_k, default seg_q) [b, s].
    Yardsticks: SDPA with the boolean block-diagonal mask (causal folded in),
    forward and backward through autograd; only where every query row has a
    live key (SDPA gives NaN for a row with none)."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    seg_k = seg_q if seg_k is None else seg_k
    b, s = seg_q.shape

    def rnd():
        return torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    scale = d ** -0.5
    o, lse = fa.flash_seg_fwd_plain(q, k, v, seg_q, seg_k, scale, causal)
    delta = fa.attention_delta(o, do)
    pairs = live_pairs(torch, seg_q, seg_k, causal)
    lib_fwd = lib_bwd = None
    if library:
        mask = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
        if causal:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device="cuda").tril()
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        for t in (qt, kt, vt):
            t.requires_grad_(True)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale)

        out_t = sdpa()

        def lib_fwd():
            return sdpa().detach()

        def lib_bwd():
            return torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                       retain_graph=True)

    es = q.element_size()
    tensor = b * s * h * d * es             # one [b, s, h, d] tensor
    rows = b * h * s * 4                    # one fp32 lse / delta row
    ids = 2 * b * s * 4                     # seg_q and seg_k
    ops = h * d * pairs
    nsegs = int(sum(torch.unique(r).numel() for r in seg_q))
    shape = [b, s, h, d, "causal" if causal else "full",
             f"{nsegs} segments, {pairs} live pairs"]
    # fp32 (the small case, sums over documents of at most 200 keys): 1e-4
    # of the RMS, not the dense cases' 1e-3, which a product rounded to TF32
    # or a dropped rescale term would pass; measured at most 4.8e-7
    tol = {**_flash_tol(torch), torch.float32: (1e-5, 1e-4)}
    args = (q, k, v, seg_q, seg_k, do, lse, delta, scale, causal)
    return [
        dict(name="flash_seg_fwd", shape=shape, tol=tol,
             kernel=lambda: fa.flash_seg_fwd(q, k, v, seg_q, seg_k, scale,
                                             causal),
             plain=lambda: fa.flash_seg_fwd_plain(q, k, v, seg_q, seg_k,
                                                  scale, causal),
             library=lib_fwd, nbytes=4 * tensor + rows + ids, nops=4 * ops),
        dict(name="flash_seg_dq", shape=shape, tol=tol,
             kernel=lambda: fa.flash_seg_dq(*args),
             plain=lambda: fa.flash_seg_dq_plain(*args), library=lib_bwd,
             nbytes=5 * tensor + 2 * rows + ids, nops=6 * ops),
        dict(name="flash_seg_dkv", shape=shape, tol=tol,
             kernel=lambda: fa.flash_seg_dkv(*args),
             plain=lambda: fa.flash_seg_dkv_plain(*args), library=lib_bwd,
             nbytes=6 * tensor + 2 * rows + ids, nops=8 * ops),
    ]


def no_live_key_check(torch, gen, dtype):
    """A small non-causal case at d 64 with ragged tiles (s 300), a -1
    padding tail, query rows whose segment id no key carries and keys whose
    id no query carries: o and dq of those rows, and dk and dv of those
    keys, must be exactly 0 from the kernels (o and dq from the plain
    versions too). Returns the three cases for run_case."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    b, s = 2, 300
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg[0, 90:200] = 1
    seg[0, 200:] = 2
    seg[1, 100:110] = 5                     # keys no query sees
    seg[1, 150:260] = 1
    seg[1, 260:] = -1                       # padding tail
    seg_q = seg.clone()
    seg_q[0, 5] = seg_q[1, 299] = 7         # no key carries id 7
    seg_q[1, 100:110] = 7
    cases = seg_flash_cases(torch, gen, dtype, seg_q.contiguous(), 4, 64,
                            False, seg_k=seg, library=False)
    fwd, dq, dkv = cases
    dead = seg_q != seg                     # the rows with no live key
    dead_k = torch.zeros_like(dead)
    dead_k[1, 100:110] = True               # the keys with no live query
    for name, fn in (("kernel", fwd["kernel"]), ("plain", fwd["plain"])):
        o, _ = fn()
        torch.cuda.synchronize()
        if not bool((o[dead] == 0).all()):
            raise AssertionError(f"segmented forward ({name}, {dtype}): a "
                                 f"query row with no live key must give "
                                 f"o = 0 exactly; max |o| "
                                 f"{o[dead].abs().max()}")
    if not bool((dq["kernel"]()[dead] == 0).all()):
        raise AssertionError(f"segmented dQ ({dtype}): a row with no live "
                             f"key must give dq = 0 exactly")
    for g in dkv["kernel"]():
        if not bool((g[dead_k] == 0).all()):
            raise AssertionError(f"segmented dK/dV ({dtype}): a key no "
                                 f"query sees must get 0 exactly")
    rows = dead.repeat_interleave(4, dim=0).reshape(-1, s)   # [b * h, s]

    def check():
        # the dead rows' lse is the mask value (-1e30 + log 1e-30) on both
        # sides; it is left out so the RMS term stays on the live rows'
        (o, lse), (o_p, lse_p) = fwd["kernel"](), fwd["plain"]()
        return ((o, lse.masked_fill(rows, 0.0)),
                (o_p, lse_p.masked_fill(rows, 0.0)))

    fwd["check"] = check
    return cases


def kernel_names(torch, fn):
    """Names of the CUDA kernels one call of fn launches (torch.profiler)."""
    return {e.name for e in cuda_events(torch, fn)}


def _offset_randn(torch, gen, shape, dtype, offset=0):
    """A contiguous tensor `offset` elements past an allocation's start (a
    16-byte aligned one at offset 0)."""
    n = 1
    for x in shape:
        n *= x
    buf = torch.randn(n + offset, device="cuda", generator=gen)
    return buf.to(dtype)[offset:].view(shape)


def _route(kind, names, want):
    """The one kernel of ours among `names` whose name holds `kind`; raises
    unless it is the template family `want` ("mma_kernel" for the tensor
    cores, else the CUDA-core templates)."""
    ours = [n for n in names if kind in n and "combine" not in n]
    tensor_core = any("mma_kernel" in n for n in ours)
    if len(ours) != 1 or tensor_core != (want == "tensor"):
        raise AssertionError(f"expected the {want}-core template of {kind}, "
                             f"launched {ours} (all: {sorted(names)})")
    return ours[0][:80]


def flash_routes(torch, gen):
    """Which hand-written template each call takes: the tensor-core ones for
    bf16 at d % 8 == 0 with 16-byte aligned tensors, the CUDA-core ones for
    bf16 at d 36 and with q, k, v, dout one element off a 16-byte boundary,
    and for fp32 and fp16; forward, dQ and dK/dV. Kernel names come from
    torch.profiler; each call also holds against its plain version."""
    from paddle_tpu_torch.ops.gpu import flash_attention as fa

    out = []
    tol = _flash_tol(torch)
    for dtype, d, offset, want in (
            (torch.bfloat16, 64, 0, "tensor"), (torch.bfloat16, 36, 0, "CUDA"),
            (torch.bfloat16, 64, 1, "CUDA"), (torch.float32, 64, 0, "CUDA"),
            (torch.float16, 64, 0, "CUDA")):
        shape = (2, 256, 4, d)
        q, k, v, do = (_offset_randn(torch, gen, shape, dtype, offset)
                       for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_fwd_plain(q, k, v, scale, True)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, scale, True)
        for name, kern, plain in (
                ("fwd", lambda: fa.flash_fwd(q, k, v, scale, True),
                 lambda: fa.flash_fwd_plain(q, k, v, scale, True)),
                ("dq", lambda: fa.flash_dq(*args),
                 lambda: fa.flash_dq_plain(*args)),
                ("dkv", lambda: fa.flash_dkv(*args),
                 lambda: fa.flash_dkv_plain(*args))):
            got = _route(f"flash_{name}_", kernel_names(torch, kern), want)
            err = _compare(f"flash_{name}", list(shape), dtype, kern(),
                           plain(), tol)
            out.append({"dtype": str(dtype).replace("torch.", ""), "d": d,
                        "offset_elements": offset, "call": name,
                        "kernel": got, "max_abs_err": err})
    return {"phase": "kernels", "name": "flash_routes", "routes": out}


def paged_routes(torch, gen):
    """Which paged kernel each call takes (torch.profiler's names): the
    verify window on the tensor cores for bf16 at d % 8 == 0 with aligned
    q and pages, on the CUDA cores for bf16 one element off alignment and
    for fp32 and fp16; a decode step with g <= 8 and aligned 16-byte rows
    on the decode kernel (paged_decode_ring_kernel) in every dtype, one
    element off alignment through the verify kernel (CUDA cores), and with
    g 16 and 32 through the verify kernel (tensor cores for bf16, CUDA
    cores for fp32 and fp16). Each call also holds against its plain
    version."""
    from paddle_tpu_torch.ops.gpu import paged_attention as pa

    out = []
    for dtype, offset, hq, hkv, sq, want in (
            (torch.bfloat16, 0, 8, 2, 5, ("paged_verify_", "tensor")),
            (torch.bfloat16, 1, 8, 2, 5, ("paged_verify_", "CUDA")),
            (torch.float32, 0, 8, 2, 5, ("paged_verify_", "CUDA")),
            (torch.float16, 0, 8, 2, 5, ("paged_verify_", "CUDA")),
            (torch.bfloat16, 0, 8, 2, 0, ("paged_decode_ring_", "CUDA")),
            (torch.float32, 0, 8, 2, 0, ("paged_decode_ring_", "CUDA")),
            (torch.float16, 0, 8, 2, 0, ("paged_decode_ring_", "CUDA")),
            (torch.bfloat16, 1, 8, 2, 0, ("paged_verify_", "CUDA")),
            (torch.bfloat16, 0, 32, 2, 0, ("paged_verify_", "tensor")),
            (torch.bfloat16, 0, 32, 1, 0, ("paged_verify_", "tensor")),
            (torch.float32, 0, 32, 2, 0, ("paged_verify_", "CUDA")),
            (torch.float16, 0, 32, 1, 0, ("paged_verify_", "CUDA"))):
        slots, d, bs, maxb = 3, 64, 16, 8
        nb = slots * maxb + 1
        shape = (slots, sq, hq, d) if sq else (slots, hq, d)
        q = _offset_randn(torch, gen, shape, dtype, offset)
        kp = _offset_randn(torch, gen, (nb, bs, hkv, d), dtype, offset)
        vp = _offset_randn(torch, gen, (nb, bs, hkv, d), dtype, offset)
        bt = (torch.randperm(nb - 1, device="cuda", generator=gen)[
            :slots * maxb] + 1).reshape(slots, maxb).to(torch.int32)
        cl = torch.tensor([100, 7, 120], dtype=torch.int32, device="cuda")
        if sq:
            kern = lambda: pa.paged_attention_multi(q, kp, vp, bt, cl)
            plain = lambda: pa.paged_attention_multi_plain(q, kp, vp, bt, cl)
        else:
            kern = lambda: pa.paged_attention(q, kp, vp, bt, cl)
            plain = lambda: pa.paged_attention_plain(q, kp, vp, bt, cl)
        got = _route(want[0], kernel_names(torch, kern), want[1])
        err = _compare("paged_routes", list(shape), dtype, kern(), plain())
        out.append({"dtype": str(dtype).replace("torch.", ""),
                    "offset_elements": offset, "q": list(shape),
                    "g": hq // hkv, "kernel": got, "max_abs_err": err})
    return {"phase": "kernels", "name": "paged_routes", "routes": out}


def verify_split_sweep(torch, gen, counts=(1, 2, 3, 4, 5, 6, 8, 10, 12, 16)):
    """The bf16 verify kernel's time for each split count at the spec
    slice's shape (8 slots, W = 5, 32 heads, d 128, windows ending at
    17-2048) and with two slots (the two longest windows), and the count
    the wrapper chooses at each (verify_splits)."""
    out = {}
    for slots, bases in ((8, VERIFY_BASES), (2, VERIFY_BASES[:2])):
        times = {}
        for n in counts:
            case = verify_case(torch, gen, torch.bfloat16, slots, 5, 32, 32,
                               128, 16, bases, splits=n)
            times[n] = time_ms(case["kernel"])
        case = verify_case(torch, gen, torch.bfloat16, slots, 5, 32, 32, 128,
                           16, bases)
        out[f"slots {slots}"] = {"ms_by_splits": times,
                                 "chosen": case["shape"][-1]}
    return {"phase": "kernels", "name": "verify_split_sweep",
            "shape": ["slots", 5, 32, 32, 128, 16], **out}


def decode_split_sweep(torch, gen, counts=(1, 2, 3, 4, 5, 6, 8, 10, 12,
                                            16)):
    """The bf16 decode kernel's time for each split count at the serving
    slice's shape (8 slots, 32 heads, d 128, contexts 17-2048) and with two
    slots (the two longest contexts), each count held against the plain
    version, by time_ms and by queued_ms (the host's launches hidden: a
    split adds the combine's launch), the count
    the wrapper chooses at each (decode_splits), and, on the same inputs at
    the main shape, the tensor-core verify kernel run as a window of one
    token (base = context - 1, its own split choice): the route a bf16
    decode step could take."""
    from paddle_tpu_torch.ops.gpu import paged_attention as pa

    out = {}
    for slots, ctx in ((8, DECODE_CTX), (2, DECODE_CTX[:2])):
        times, queued = {}, {}
        for n in counts:
            case = paged_case(torch, gen, torch.bfloat16, slots, 32, 32, 128,
                              16, ctx, splits=n)
            _compare(f"paged_decode splits {n}", case["shape"],
                     torch.bfloat16, case["kernel"](), case["plain"]())
            times[n] = time_ms(case["kernel"])
            queued[n] = queued_ms(case["kernel"])
        case = paged_case(torch, gen, torch.bfloat16, slots, 32, 32, 128, 16,
                          ctx)
        out[f"slots {slots}"] = {"ms_by_splits": times,
                                 "queued_ms_by_splits": queued,
                                 "chosen": case["shape"][-1],
                                 "chosen_ms": time_ms(case["kernel"])}
        if slots == 8:
            q, kp, vp, bt, cl, scale = case["inputs"]

            def verify():
                return pa.paged_attention_multi(q[:, None], kp, vp, bt,
                                                cl - 1, scale)[:, 0]

            if pa.route(q[:, None], kp, vp) != pa.VERIFY_TENSOR_CORES:
                raise AssertionError("the verify window at the decode shape "
                                     "does not take the tensor cores")
            err = _compare("verify as decode", case["shape"], torch.bfloat16,
                           verify(), case["plain"]())
            out["verify_mma_sq1"] = {
                "ms": time_ms(verify), "queued_ms": queued_ms(verify),
                "decode_queued_ms": queued_ms(case["kernel"]),
                "max_abs_err": err,
                "splits": pa.verify_splits(
                    q[:, None], kp, vp, bt,
                    torch.cuda.get_device_properties(0).multi_processor_count),
                "decode_ms": out["slots 8"]["chosen_ms"]}
    return {"phase": "kernels", "name": "decode_split_sweep",
            "shape": ["slots", 32, 32, 128, 16], **out}


def short_rows_device(torch, gen, rows):
    """device_ms (torch.profiler) of the short serving rows' kernels and
    library calls, on fresh inputs of the same shapes as their rows in
    the kernels phase (bf16); added to those rows for the summary."""
    cases = {"rms_norm": rms_case(torch, gen, torch.bfloat16, 8),
             "rope": rope_case(torch, gen, torch.bfloat16, 256, hkv=32),
             "rope_packed": rope_packed_case(torch, gen, torch.bfloat16, 8, 1,
                                             hkv=32),
             "paged_decode": paged_case(torch, gen, torch.bfloat16, 8, 32, 32,
                                        128, 16, DECODE_CTX)}
    out = {}
    for name, case in cases.items():
        lib = case["library"]
        out[name] = {"shape": case["shape"],
                     "device_ms": device_ms(case["kernel"]),
                     "library_device_ms": device_ms(lib) if lib else None}
        rows[name].update(device_ms=out[name]["device_ms"],
                          library_device_ms=out[name]["library_device_ms"])
    return {"phase": "kernels", "name": "short_rows_device", "rows": out}


def rms_host_parts(torch, gen, calls=200):
    """Where the host's time goes in one serving RMSNorm call (bf16 [8,
    4096], no rstd): host_us of the whole call (fused_rms_norm), of each
    of its parts alone (the checks, the output's allocation, the stream
    handle, the ctypes call with its launch, and the same ctypes call with
    n = 0, which the entry point refuses before any launch), and of
    F.rms_norm."""
    from paddle_tpu_torch.ops.gpu import _build, fused_norm

    x = torch.randn(8, 4096, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    y = torch.empty_like(x)
    entry = fused_norm._fwd_entry()
    stream = _build.stream_ptr(x)
    parts = {
        "fused_rms_norm": lambda: fused_norm.fused_rms_norm(x, w, 1e-5),
        "check": lambda: fused_norm._check(x, w),
        "empty_like": lambda: torch.empty_like(x),
        "stream_ptr": lambda: _build.stream_ptr(x),
        "ctypes_launch": lambda: entry(x.data_ptr(), w.data_ptr(),
                                       y.data_ptr(), None, 8, 4096, 1e-5, 1,
                                       1, stream),
        "ctypes_refused": lambda: entry(x.data_ptr(), w.data_ptr(),
                                        y.data_ptr(), None, 0, 4096, 1e-5, 1,
                                        1, stream),
        "F.rms_norm": lambda: torch.nn.functional.rms_norm(x, (4096,), w,
                                                           1e-5),
    }
    return {"phase": "kernels", "name": "rms_host_parts", "calls": calls,
            "host_us": {k: host_us(fn, calls) for k, fn in parts.items()}}


def rms_norm_route(torch, gen):
    """The RMSNorm forward launches the CUDA kernel and no Triton one:
    torch.profiler's names for the serving call (no rstd) and for the
    training forward (y and rstd), bf16 and fp32, and for the scalar path
    (d 90)."""
    from paddle_tpu_torch.ops.gpu import fused_norm

    out = []
    for dtype, n, d in ((torch.bfloat16, 8, 4096), (torch.float32, 256, 4096),
                        (torch.bfloat16, 300, 90)):
        x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
        w = torch.ones(d, device="cuda", dtype=dtype)
        for call, fn, plain, tol in (
                ("serving", lambda: fused_norm.fused_rms_norm(x, w, 1e-5),
                 lambda: fused_norm.rms_norm_plain(x, w, 1e-5), None),
                ("training", lambda: fused_norm.rms_norm_fwd(x, w, 1e-5),
                 lambda: fused_norm.rms_norm_fwd_plain(x, w, 1e-5),
                 {torch.float32: (1e-5, 1e-5),
                  torch.bfloat16: (2.0 ** -7, 1e-5)})):
            names = sorted(kernel_names(torch, fn))
            if len(names) != 1 or "rms_fwd_kernel" not in names[0]:
                raise AssertionError(f"rms_norm forward ({call}, {dtype}, "
                                     f"d {d}) launched {names}, not the "
                                     f"CUDA kernel alone")
            err = _compare("rms_norm route", [n, d], dtype, fn(), plain(),
                           tol)
            out.append({"dtype": str(dtype).replace("torch.", ""),
                        "shape": [n, d], "call": call,
                        "kernel": names[0][:80], "max_abs_err": err})
    return {"phase": "kernels", "name": "rms_norm_route", "routes": out}


def rope_route(torch, gen):
    """Each fused q+k RoPE call launches one CUDA kernel and no Triton one:
    torch.profiler's names for contiguous and per-token calls, sign 1 and
    -1, the vector path (4-element slices: bf16, fp32, fp16 at d 128, GQA)
    and the scalar path (d 90, and q and k one element off their slice's
    alignment); and an autograd forward and backward of fused_rope_packed,
    one launch each. Each call also holds against its plain version."""
    from paddle_tpu_torch.ops.gpu import rope

    def launched(fn):
        return [e.name for e in cuda_events(torch, fn)]

    out = []
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    for dtype, hq, hkv, d, packed, sign, offset, vec in (
            (bf16, 32, 32, 128, True, 1, 0, True),
            (bf16, 32, 32, 128, True, -1, 0, True),
            (bf16, 32, 32, 128, False, 1, 0, True),
            (bf16, 32, 32, 128, False, -1, 0, True),
            (bf16, 32, 8, 128, True, 1, 0, True),
            (f32, 32, 32, 128, True, 1, 0, True),
            (f16, 32, 32, 128, False, -1, 0, True),
            (bf16, 8, 2, 90, True, 1, 0, False),
            (f32, 8, 2, 90, False, -1, 0, False),
            (bf16, 32, 32, 128, True, 1, 1, False)):
        b, s = 2, 16
        q = _offset_randn(torch, gen, (b, s, hq, d), dtype, offset)
        k = _offset_randn(torch, gen, (b, s, hkv, d), dtype, offset)
        cos, sin = _tables(torch, 64, d)
        pos = torch.randint(0, 80, (b, s), device="cuda", generator=gen,
                            dtype=torch.int32) if packed else None
        if not packed:
            cos, sin = cos[:s].contiguous(), sin[:s].contiguous()
        kern = lambda: rope.rope_qk(q, k, cos, sin, pos, sign)
        names = launched(kern)
        path = "vector" if vec else "scalar"
        if len(names) != 1 or "rope_qk_kernel" not in names[0] \
                or ("true>" in names[0]) != vec:
            raise AssertionError(f"rope ({dtype}, d {d}, packed {packed}, "
                                 f"sign {sign}, offset {offset}) launched "
                                 f"{names}, not the {path} CUDA kernel "
                                 f"alone")
        err = _compare("rope route", [b, s, f"{hq}+{hkv}", d], dtype, kern(),
                       rope.rope_qk_plain(q, k, cos, sin, pos, sign))
        out.append({"dtype": str(dtype).replace("torch.", ""),
                    "q": [b, s, hq, d], "kv_heads": hkv, "per_token": packed,
                    "sign": sign, "offset_elements": offset,
                    "kernel": names[0][:80], "max_abs_err": err})
    # autograd: one launch forward (q and k), one backward (sign -1)
    q = torch.randn(2, 16, 32, 128, device="cuda", generator=gen,
                    dtype=bf16).requires_grad_(True)
    k = torch.randn(2, 16, 8, 128, device="cuda", generator=gen,
                    dtype=bf16).requires_grad_(True)
    cos, sin = _tables(torch, 64, 128)
    pos = torch.randint(0, 64, (2, 16), device="cuda", generator=gen,
                        dtype=torch.int32)
    outs = []

    def forward():
        outs[:] = rope.fused_rope_packed(q, k, cos, sin, pos)

    def backward():
        q.grad = k.grad = None
        torch.autograd.backward(outs, (gq, gk), retain_graph=True)

    fwd = launched(forward)
    gq, gk = torch.randn_like(outs[0]), torch.randn_like(outs[1])
    bwd = launched(backward)
    counts = [sum("rope_qk_kernel" in n for n in names)
              for names in (fwd, bwd)]
    if counts != [1, 1] or any("triton" in n.lower() or "_rope_fwd" in n
                               for n in fwd + bwd):
        raise AssertionError(f"fused_rope_packed launched {fwd} forward "
                             f"and {bwd} backward, not one CUDA RoPE "
                             f"kernel each")
    want = rope.rope_qk_plain(gq, gk, cos, sin, pos, -1)
    err = _compare("rope autograd", [2, 16, "32+8", 128], bf16,
                   (q.grad, k.grad), want)
    out.append({"dtype": "bfloat16", "call": "fused_rope_packed autograd",
                "forward": [n[:80] for n in fwd],
                "backward": [n[:80] for n in bwd], "max_abs_err": err})
    return {"phase": "kernels", "name": "rope_route", "routes": out}


def wide_bh_cases(torch, gen):
    """b * h = 65,540 (past grid.y's 65535): dense forward, dQ and dK/dV in
    bf16 (tensor cores) and fp16 (CUDA cores), and the segmented three in
    bf16, at b 16385, h 4, s 128, d 64, causal. Checks, timed briefly and
    without a yardstick. Yields (dtype, case), one input set at a time."""
    b, s, h, d = 16385, 128, 4, 64
    seg = torch.zeros(b, s, dtype=torch.int32, device="cuda")
    seg[:, 40:] = 1
    seg[:, 100:] = 2
    seg[1::2, 120:] = -1                    # padding tails on odd rows
    for dtype, make in (
            (torch.bfloat16, lambda: flash_cases(
                torch, gen, torch.bfloat16, b, s, s, h, d, True,
                library=False)),
            (torch.float16, lambda: flash_cases(
                torch, gen, torch.float16, b, s, s, h, d, True,
                library=False)),
            (torch.bfloat16, lambda: seg_flash_cases(
                torch, gen, torch.bfloat16, seg.contiguous(), h, d, True,
                library=False))):
        for case in make():
            case.update(iters=3, reps=3)
            yield dtype, case


def rms_bwd_case(torch, gen, dtype, n, d=4096):
    """RMSNorm backward from the forward's saved fp32 rstd: the kernel side
    reads the forward kernel's rstd, as the training path does, the plain
    side the plain forward's. Yardstick: the backward of F.rms_norm through
    autograd (dx and dw)."""
    from paddle_tpu_torch.ops.gpu import fused_norm

    x = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(dtype)
    g = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    eps = 1e-5
    _, rstd = fused_norm.rms_norm_fwd_plain(x, w, eps)
    _, rstd_k = fused_norm.rms_norm_fwd(x, w, eps)
    xt = x.clone().requires_grad_(True)
    wt = w.clone().requires_grad_(True)
    out = torch.nn.functional.rms_norm(xt, (d,), wt, eps)
    es = x.element_size()
    # dx: rstd * (g w - x^ mean(g w x^)); dw: column sums of g x^. fp32:
    # sums of 4096 (dx) and 8192 (dw) products in another order, so 1e-5 of
    # the value plus 1e-5 of the RMS (|dw| grows as sqrt(n)); bf16: one
    # rounding of each (2**-7) of the value and of the RMS.
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -7,
                                                         2.0 ** -7)}
    return dict(
        name="rms_norm_bwd", shape=[n, d], tol=tol,
        kernel=lambda: fused_norm.fused_rms_norm_bwd(x, w, rstd_k, g),
        plain=lambda: fused_norm.rms_norm_bwd_plain(x, w, rstd, g),
        library=lambda: torch.autograd.grad(out, (xt, wt), g,
                                            retain_graph=True),
        nbytes=3 * n * d * es + 2 * d * es + n * 4, nops=9 * n * d)


def gpt_numel(cfg):
    """Parameters of a GPTForCausalLM (tied head) from its config."""
    H, inter = cfg.hidden_size, cfg.intermediate_size
    per_layer = (4 * H + 3 * H * H + 3 * H + H * H + H + H * inter + inter
                 + inter * H + H)
    return ((cfg.vocab_size + cfg.max_position_embeddings) * H
            + cfg.num_layers * per_layer + 2 * H)


def adamw_case(torch, gen, n, zero_shard=False):
    """AdamW over one flat fp32 group of n elements at step 3 with a
    device-scalar gradient scale (the clip's). The kernel updates clones,
    the plain version the originals, both in place; then each is timed in
    place again. Both do the same fp32 operations on the same scalars: 1e-6
    of the value + 1e-6 of the RMS (an FMA here and there). With
    `zero_shard`, the group is rank 1's ZeRO shard of n parameters at two
    ranks (distributed/sharding.py, stages os and os_g): p and g are views
    that start at rank 1's chunk of flat buffers padded to 2 x ALIGN
    elements, m and v the shard's own buffers."""
    from paddle_tpu_torch.distributed.sharding import ALIGN
    from paddle_tpu_torch.ops.gpu import fused_adamw as fw

    name = "adamw"
    if zero_shard:
        name, step = "adamw_zero_shard", 2 * ALIGN
        n = -(-n // step) * step // 2
        full_p = torch.randn(2 * n, device="cuda", generator=gen)
        full_g = torch.randn(2 * n, device="cuda", generator=gen)
        p, g, kfull = full_p[n:], full_g[n:], full_p.clone()
        kp = kfull[n:]
    else:
        p = torch.randn(n, device="cuda", generator=gen)
        g = torch.randn(n, device="cuda", generator=gen)
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = 0.01 * torch.rand(n, device="cuda", generator=gen)
    if not zero_shard:
        kp = p.clone()
    km, kv = m.clone(), v.clone()
    scale = torch.tensor(0.5, device="cuda")
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3,
              bias_correction2=1 - 0.999 ** 3, grad_scale=scale)
    steps = torch.tensor(3.0, device="cuda")

    def check():
        got = fw.fused_adamw(kp, g, km, kv, **kw)
        want = fw.adamw_plain(p, g, m, v, **kw)
        return got, want

    def library():
        torch._fused_adamw_([kp], [g], [km], [kv], [], [steps], lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False,
                            grad_scale=None, found_inf=None)

    big = n > 1 << 26
    return dict(name=name, shape=[n], check=check,
                tol={torch.float32: (1e-6, 1e-6)},
                kernel=lambda: fw.fused_adamw(kp, g, km, kv, **kw),
                plain=lambda: fw.adamw_plain(p, g, m, v, **kw),
                library=library, nbytes=28 * n, nops=15 * n,
                iters=3 if big else 20, reps=3 if big else 5)



def bit_sums(torch, tensors, chunk=1 << 27):
    """A bit-level checksum of each tensor: its bits viewed as int16 (2-byte
    types) or int32 (4-byte) and summed in int64, a chunk at a time. A
    store of any changed value changes the sum (but for cancellations),
    so "no byte changed" needs no clone of a 21 GB state."""
    out = []
    for t in tensors:
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), chunk):
            total += bits[i:i + chunk].sum(dtype=torch.int64)
        out.append(int(total))
    return out


def adamw_master_case(torch, gen, n):
    """AdamW's master form (amp O2) over one flat group of n elements at
    step 3 with a device-scalar clip factor: an fp32 master, m and v, a bf16
    gradient and the bf16 parameters' copy. The kernel updates clones, the
    plain version the originals. Master, m and v within 1e-6 of the value
    + 1e-6 of the RMS (the same fp32 operations, an FMA here and there);
    the kernel's bf16 copy must equal its own master cast to bf16 (round to
    nearest even), bitwise; a launch with the skip flag set must change no
    byte of any of its buffers (bit_sums before and after). Yardstick:
    torch._fused_adamw_ over the fp32 master (with an fp32 copy of the
    gradient, made once) followed by one copy_ into the bf16 buffer."""
    from paddle_tpu_torch.ops.gpu import fused_adamw as fw

    master = torch.randn(n, device="cuda", generator=gen)
    g = torch.randn(n, device="cuda", generator=gen).to(torch.bfloat16)
    m = 0.1 * torch.randn(n, device="cuda", generator=gen)
    v = 0.01 * torch.rand(n, device="cuda", generator=gen)
    low = master.to(torch.bfloat16)
    km, kmm, kv, klow = master.clone(), m.clone(), v.clone(), low.clone()
    scale = torch.tensor(0.5, device="cuda")
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3,
              bias_correction2=1 - 0.999 ** 3, grad_scale=scale)
    steps = torch.tensor(3.0, device="cuda")
    g32 = []

    def check():
        fw.fused_adamw_master(km, g, kmm, kv, klow, **kw)
        fw.adamw_plain(master, g, m, v, low=low, **kw)
        torch.cuda.synchronize()
        if not torch.equal(klow, km.to(torch.bfloat16)):
            raise AssertionError("adamw_master: the bf16 copy differs from "
                                 "the kernel's master cast to bf16")
        bufs = (km, kmm, kv, klow, g)
        before = bit_sums(torch, bufs)
        fw.fused_adamw_master(km, g, kmm, kv, klow, skip=torch.ones(
            (), dtype=torch.int32, device="cuda"), **kw)
        if bit_sums(torch, bufs) != before:
            raise AssertionError("adamw_master: a launch with the skip flag "
                                 "set changed its buffers")
        return (km, kmm, kv), (master, m, v)

    def library():
        if not g32:
            g32.append(g.float())
        torch._fused_adamw_([km], g32, [kmm], [kv], [], [steps], lr=1e-4,
                            beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False,
                            grad_scale=None, found_inf=None)
        klow.copy_(km)

    big = n > 1 << 26
    return dict(name="adamw_master", shape=[n], check=check,
                tol={torch.float32: (1e-6, 1e-6)},
                kernel=lambda: fw.fused_adamw_master(km, g, kmm, kv, klow,
                                                     **kw),
                plain=lambda: fw.adamw_plain(master, g, m, v, low=low, **kw),
                library=library, nbytes=28 * n, nops=15 * n,
                iters=3 if big else 20, reps=3 if big else 5)


def _tables(torch, P, d, theta=10000.0):
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device="cuda") / d))
    f = torch.outer(torch.arange(P, dtype=torch.float32, device="cuda"), inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos().contiguous(), emb.sin().contiguous()


def run_case(torch, case, dtype, timed=True):
    """Hold the case's kernel against its plain version (max |error|
    within the tolerance) and, `timed`, time the kernel, the plain version
    and the library call; one JSON row."""
    if "check" in case:
        got, want = case["check"]()
    else:
        got, want = case["kernel"](), case["plain"]()
    torch.cuda.synchronize()
    tol = case.get("tol")
    err = _compare(case["name"], case["shape"], dtype, got, want, tol)
    del got, want
    lib = case["library"]
    b_ms, b_by = bound_ms(case["nbytes"], case["nops"], dtype)
    reps = dict(iters=case.get("iters", 20), reps=case.get("reps", 5))
    row = {
        "phase": "kernels", "name": case["name"], "shape": case["shape"],
        "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
        "tolerance": (dict(zip(("atol", "rtol"), _tol(dtype))) if tol is None
                      else {str(k).replace("torch.", ""): dict(
                          zip(("rtol", "rms"), v)) for k, v in tol.items()}),
        "bound_ms": b_ms, "bound_by": b_by}
    if not timed:
        emit(row)
        return row
    row.update({
        "ms": time_ms(case["kernel"], **reps),
        "plain_ms": time_ms(case["plain"], **reps, long_ms=YARDSTICK_MS),
        "library_ms": (time_ms(lib, **reps, long_ms=YARDSTICK_MS)
                       if lib is not None else None)})
    if case.get("costs"):
        # a short call's host cost (its device time: short_rows_device)
        row.update(host_us=host_us(case["kernel"]),
                   library_host_us=host_us(lib) if lib else None)
    emit(row)
    return row


def kernels_phase(torch):
    from paddle_tpu_torch.models.generation import packed_positions
    from paddle_tpu_torch.tools.profile_training import packed_batch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    # the packed slice's segment layout and per-document positions
    seg = torch.from_numpy(packed_batch(32000)[1]).cuda().contiguous()
    pos = packed_positions(seg, seg.shape[1]).contiguous()
    for dtype in (torch.bfloat16, torch.float32):
        cases = [
            ("rms_norm", rms_case(torch, gen, dtype, 8)),          # decode
            (None, rms_case(torch, gen, dtype, 256)),              # chunk
            # RoPE as Llama-2-7B calls it, q and k (32 + 32 heads) in one
            # launch: a prefill chunk, a decode tick, a batched prefill, a
            # verify window; each beside the single-tensor call
            ("rope", rope_case(torch, gen, dtype, 256, hkv=32)),
            (None, rope_case(torch, gen, dtype, 256)),
            ("rope_packed", rope_packed_case(torch, gen, dtype, 8, 1,
                                             hkv=32)),
            (None, dict(rope_packed_case(torch, gen, dtype, 8, 1),
                        costs=True)),
            (None, rope_packed_case(torch, gen, dtype, 8, 128, hkv=32)),
            (None, rope_packed_case(torch, gen, dtype, 8, 128)),
            (None, rope_packed_case(torch, gen, dtype, 8, 5, hkv=32)),
            *rope_other_cases(torch, gen, dtype),
            # decode at the main path's table width (2048 / 16 = 128 pages):
            # the wrapper's own split count (one here), then five splits
            # (partials and the combine)
            ("paged_decode", paged_case(
                torch, gen, dtype, 8, 32, 32, 128, 16, DECODE_CTX)),
            (None, paged_case(torch, gen, dtype, 8, 32, 32, 128, 16,
                              DECODE_CTX, splits=5)),
        ]
        for g, ctx in ((2, [77, 5, 300]), (4, [1, 129, 640]),
                       (8, [33, 1000, 16])):
            cases.append((None, paged_case(torch, gen, dtype, 3, 8 * g, 8,
                                           128, 16, ctx, splits=2)))
        # GQA groups past the decode kernel's 8 rows (32 heads over 2 kv
        # heads, and MQA): the verify kernel as a window of one token
        for hkv, ctx in ((2, [77, 1000, 300]), (1, [1, 640, 129])):
            cases.append((None, paged_case(torch, gen, dtype, 3, 32, hkv,
                                           128, 16, ctx)))
        # the verify window at the spec slice's shapes (8 slots, W = 5,
        # windows ending at 17-2048), at the wrapper's split count and at
        # one split; a GQA window of 72 rows; windows that run past a
        # 4-page table; sq = 1 against the decode kernel
        cases += [
            ("paged_verify", verify_case(torch, gen, dtype, 8, 5, 32, 32,
                                         128, 16, VERIFY_BASES)),
            (None, verify_case(torch, gen, dtype, 8, 5, 32, 32, 128, 16,
                               VERIFY_BASES, splits=1)),
            (None, verify_case(torch, gen, dtype, 3, 9, 32, 4, 128, 16,
                               [77, 5, 300])),
            (None, verify_case(torch, gen, dtype, 3, 5, 16, 4, 64, 16,
                               [62, 64, 10], max_blocks=4)),
            (None, verify_case(torch, gen, dtype, 8, 1, 32, 32, 128, 16,
                               VERIFY_BASES, as_decode=True)),
        ]
        # training at the packed Llama slice's shapes: RoPE with sign -1
        # (contiguous and per-token) and per-token RoPE forward at the
        # slice's positions; RMSNorm forward (y and rstd) and backward, whose
        # main path runs in fp32 under amp O1
        cases += [
            (None, rope_case(torch, gen, dtype, 4096, b=2, start=0,
                             sign=-1, hkv=32)),
            (None, rope_case(torch, gen, dtype, 4096, b=2, start=0,
                             sign=-1)),
            (None, rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos,
                                    hkv=32)),
            (None, rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos)),
            (None, rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos,
                                    sign=-1, hkv=32)),
            (None, rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos,
                                    sign=-1)),
            (None, rms_fwd_case(torch, gen, dtype, 8192)),
            ("rms_norm_bwd" if dtype == torch.float32 else None,
             rms_bwd_case(torch, gen, dtype, 8192)),
        ]
        for key, case in cases:
            # the short rows' two costs, device and host, in bf16
            case["costs"] = (key in SHORT or case.get("costs", False)) \
                and dtype == torch.bfloat16
            row = run_case(torch, case, dtype)
            if key is not None and (dtype == torch.bfloat16
                                    or key == "rms_norm_bwd"):
                rows[key] = row
            del case
        cases = None
        torch.cuda.empty_cache()
        # training: GPT-3 1.3B's attention (main path), bench.py's "large"
        # preset's head size, and non-causal attention with sq != sk
        # head_dim 256 and 80 (mma depth padded to 96), ragged s 300
        for geo, main in (((4, 2048, 2048, 16, 128, True), True),
                          ((4, 2048, 2048, 8, 128, True), False),  # mp 2
                          ((8, 1024, 1024, 16, 64, True), False),
                          ((2, 1024, 2048, 16, 128, False), False),
                          ((2, 1024, 1024, 8, 256, True), False),
                          ((2, 300, 300, 4, 80, False), False)):
            for case in flash_cases(torch, gen, dtype, *geo):
                row = run_case(torch, case, dtype)
                if main and dtype == torch.bfloat16:
                    rows[case["name"]] = row
                del case
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            emit(rms_host_parts(torch, gen))
            # Every reader of torch.profiler runs here, one after another,
            # after the host's times: on the H100 (torch 2.11) a profiler
            # session followed by heavy work left the later sessions seeing
            # no kernel (device_ms raises then), and after many sessions
            # the host's launches ran slower
            emit(flash_routes(torch, gen))
            emit(paged_routes(torch, gen))
            emit(rms_norm_route(torch, gen))
            emit(rope_route(torch, gen))
            emit(short_rows_device(torch, gen, rows))
            emit(verify_split_sweep(torch, gen))
            emit(decode_split_sweep(torch, gen))
            emit({"phase": "kernels", "name": "profiler_sessions",
                  **_profiler_summary()})
        # segmented: the packed slice's attention (b 2, s 4096, h 32,
        # d 128, causal, bf16), and the small case with dead rows and keys
        seg_cases = no_live_key_check(torch, gen, dtype)
        if dtype == torch.bfloat16:
            seg_cases = seg_flash_cases(torch, gen, dtype, seg, 32, 128,
                                        True) + seg_cases
        for i, case in enumerate(seg_cases):
            row = run_case(torch, case, dtype)
            if dtype == torch.bfloat16 and i < 3:
                rows[case["name"]] = row
            del case
        seg_cases = None
        torch.cuda.empty_cache()
    # fp16 (the CUDA-core templates) at the main paths' shapes: paged decode
    # and verify, dense flash at GPT-3 1.3B's, segmented at the packed
    # slice's, and the small segmented case with dead rows and keys; each
    # held against its plain version, untimed since hybrid_pp_slice joined
    # the script (timing them took 19.8 s of a full run of 1,135 s on an
    # H100 80GB HBM3 at 700 W; no main path runs fp16, PERF.md keeps their
    # earlier times)
    dtype = torch.float16
    cases = [rope_case(torch, gen, dtype, 256, hkv=32),
             rope_packed_case(torch, gen, dtype, 8, 1, hkv=32),
             rope_packed_case(torch, gen, dtype, 2, 4096, pos=pos, sign=-1,
                              hkv=32),
             *(case for _, case in rope_other_cases(torch, gen, dtype)),
             paged_case(torch, gen, dtype, 8, 32, 32, 128, 16, DECODE_CTX),
             paged_case(torch, gen, dtype, 3, 32, 2, 128, 16,
                        [77, 1000, 300]),
             verify_case(torch, gen, dtype, 8, 5, 32, 32, 128, 16,
                         VERIFY_BASES)]
    cases += flash_cases(torch, gen, dtype, 4, 2048, 2048, 16, 128, True)
    cases += seg_flash_cases(torch, gen, dtype, seg, 32, 128, True)
    cases += no_live_key_check(torch, gen, dtype)
    for case in cases:
        run_case(torch, case, dtype, timed=False)
    cases = None
    torch.cuda.empty_cache()
    for dtype, case in wide_bh_cases(torch, gen):
        run_case(torch, case, dtype)
    torch.cuda.empty_cache()
    # AdamW runs in fp32 only: GPT-3 1.3B's one flat group, a ragged one
    from paddle_tpu_torch.models import GPTConfig

    for n, main in ((gpt_numel(GPTConfig.gpt3_1p3b()), True),
                    (1_000_003, False)):
        for make in (adamw_case, adamw_master_case):
            row = run_case(torch, make(torch, gen, n), torch.float32)
            if main:
                rows[row["name"]] = row
            release(torch)
    # the fp32 form as ZeRO hands it rank 1's shard (zero_slice)
    run_case(torch, adamw_case(torch, gen, gpt_numel(GPTConfig.gpt3_1p3b()),
                               zero_shard=True), torch.float32)
    release(torch)
    return rows


# --------------------------------------------------------- served path
def graph_gate(eng, must=()):
    """The engine's graph stats by kind; raises unless every tick of each
    kind replayed its CUDA graph, and each kind in `must` replayed."""
    g = eng.graph_stats()
    if g["replays"] != g["ticks"] or any(g["replays"][k] <= 0 for k in must):
        raise AssertionError(f"graph replays {g['replays']} against ticks "
                             f"{g['ticks']}; must replay {must}")
    return g


def top2_margin(torch, model, seq, t):
    """Gap between the two largest logits predicting token t of seq."""
    with torch.no_grad():
        ids = torch.tensor([seq[:t]], device=model.device)
        lg = model(ids)[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def parity_phase(torch, cfg, device, new_tokens=16, engine_kw=None,
                 prompt_lens=(700, 40, 23, 300)):
    """ServingEngine.generate vs model.generate, greedy, token for token;
    every engine tick of a kind replayed its graph. generate()'s calls
    (a host-int pos) must launch the contiguous RoPE kernel once a layer a
    call: its launches here are the kernel's count in the summary."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=SEED)
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in prompt_lens]
    eng = ServingEngine(model, device=device, **(engine_kw or {}))
    got = eng.generate(prompts, max_new_tokens=new_tokens)
    graphs = graph_gate(eng, ("decode", "prefill"))
    # generate() passes a host-int pos: the contiguous RoPE kernel
    gpu.reset_launch_counts()
    wants = [model.generate(torch.tensor([p], device=model.device),
                            max_new_tokens=new_tokens)[0].tolist()
             for p in prompts]
    rope = gpu.launch_counts(("rope",))["rope"]
    if rope != cfg.num_layers * new_tokens * len(prompts):
        raise AssertionError(f"generate() launched contiguous RoPE {rope} "
                             f"times, expected one a layer a call")
    for p, g, want in zip(prompts, got, wants):
        if g != want:
            t = next(i for i, (a, b) in enumerate(zip(g, want)) if a != b)
            raise AssertionError(
                f"engine and generate() diverge at token {t} of a "
                f"{len(p)}-token prompt ({g[t]} vs {want[t]}); top-2 logit "
                f"margin there {top2_margin(torch, model, want, t):.3g}")
    st = eng.stats()
    return {"phase": "parity", "prompts": [len(p) for p in prompts],
            "new_tokens": new_tokens, "token_match": True,
            "batched_prefills": st["batched_prefills"],
            "prefill_programs": st["prefill_programs"], "graphs": graphs,
            "generate_rope_launches": rope}


def slice_phase(torch, model, engine_kw, new_tokens, wave1_lens, prefix_len,
                reset, counts, temperature=0.0):
    """Main path 1: waves of requests through ServingEngine, every other
    one sampled at `temperature` when it is > 0. Returns the sequences and
    the phase summary; launch counts are read just after the drive. Every
    tick of a kind must have replayed its graph (decode or sampled, and
    prefill, at least once), paged decode must have launched once a layer
    a decode step, and per-token RoPE once a layer a step in the first
    pure decode tick."""
    import numpy as np
    from paddle_tpu_torch.serving import ServingEngine

    cfg, device = model.config, model.device
    t0 = time.perf_counter()
    eng = ServingEngine(model, device=device, **engine_kw)
    sync = torch.cuda.synchronize if device.type != "cpu" else (
        lambda: None)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 1)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    shared = toks(prefix_len)
    lens = list(wave1_lens)
    wave1 = [toks(n) for n in lens[:-2]]
    wave1 += [shared + toks(lens[-2] - prefix_len),
              shared + toks(lens[-1] - prefix_len)]
    # wave 2: a partial prefix hit and a full-prompt (copy-on-write) hit
    repeat = next(p for p in wave1 if len(p) % engine_kw["block_size"] == 0)
    wave2 = [shared + toks(48), list(repeat)]
    if device.type != "cpu":
        torch.cuda.reset_peak_memory_stats()
    reqs = []
    decode_tick = tick_steps = None

    def steps():
        t = eng.graph_stats()["ticks"]
        return t["decode"] * eng.fuse_steps + t["sampled"]

    reset()
    t1 = time.perf_counter()
    for wave in (wave1, wave2):
        reqs += [eng.submit(p, max_new_tokens=new_tokens,
                            temperature=temperature if i % 2 else 0.0)
                 for i, p in enumerate(wave, start=len(reqs))]
        while eng.sched.has_work():
            pure = not eng.sched.waiting and not eng.sched.prefilling
            before, steps_before = counts(), steps()
            eng.step()
            if pure and decode_tick is None:
                after = counts()
                decode_tick = {k: after[k] - before[k] for k in after}
                tick_steps = steps() - steps_before
    sync()
    wall = time.perf_counter() - t1
    launches = counts()
    short = [r.request_id for r in reqs
             if len(r.output_tokens) != new_tokens
             or not all(0 <= t < cfg.vocab_size for t in r.output_tokens)]
    if short:
        raise AssertionError(f"requests without their {new_tokens} valid "
                             f"tokens: {short}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    # one fused q+k RoPE launch a layer a step in a pure decode tick (a
    # graph replay's launches are added to the counts)
    want = cfg.num_layers * (tick_steps or 0)
    if decode_tick is None or not want or decode_tick["rope_packed"] != want:
        raise AssertionError(f"per-token RoPE launches in a pure decode "
                             f"tick {decode_tick}, expected {want} (one a "
                             f"layer a step)")
    graphs = graph_gate(eng, ("sampled" if temperature > 0 else "decode",
                              "prefill"))
    if launches["paged_decode"] != cfg.num_layers * steps():
        raise AssertionError(f"paged decode launched "
                             f"{launches['paged_decode']} times over "
                             f"{steps()} decode steps ({graphs})")
    st = eng.stats()
    if st["kv"]["used_blocks"] or not st["kv"]["conservation_ok"]:
        raise AssertionError(f"KV blocks leaked: {st['kv']}")
    generated = sum(len(r.output_tokens) for r in reqs)
    return [r.prompt + r.output_tokens for r in reqs], {
        "phase": "sampled_slice" if temperature > 0 else "slice",
        "fuse_steps": eng.fuse_steps, "temperature": temperature,
        "sampled_requests": sum(r.temperature > 0 for r in reqs),
        "graphs": graphs,
        "launches_per_replay": {
            kind: eng.graph_launches(kind, size) for kind, size in (
                ("decode", eng.fuse_steps), ("sampled", 1),
                ("prefill", eng.prefill_chunk))},
        "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "dtype": str(model._cache_dtype()),
        "requests": len(reqs), "prompt_tokens": [len(r.prompt) for r in reqs],
        "new_tokens_each": new_tokens, "init_s": init_s, "wall_s": wall,
        "engine_steps": st["steps"], "generated_tokens": generated,
        "tokens_per_s": generated / wall,
        "mean_ttft_s": statistics.mean(r.ttft_seconds() for r in reqs),
        "prefill_tokens": st["prefill_tokens"],
        "batched_prefills": st["batched_prefills"],
        "cow_admissions": st["cow_admissions"],
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if device.type != "cpu" else None),
        "kv_pool_bytes": eng.pool.nbytes(),
        "launches": launches, "launches_per_decode_tick": decode_tick,
    }


def _spec_prompts(rng, vocab):
    """Greedy parity prompts: a repeated 12-token pattern, a constant run,
    a random one, and [3, 0, 9, 5, 3], whose history makes a wrong first
    draft for a model that always answers 0 (rejected, rolled back)."""
    pat = [int(t) for t in rng.integers(0, vocab, 12)]
    return [pat * 8, [5] * 24,
            [int(t) for t in rng.integers(0, vocab, 40)], [3, 0, 9, 5, 3]]


def spec_parity_phase(torch, models, new_tokens=24, engine_kw=None):
    """Greedy speculation parity on the card in fp32 (TF32 off), prefix
    cache on: for each (name, model), ServingEngine(spec_k=4) must equal
    ServingEngine(spec_k=0) and model.generate token for token, first with
    the seeded weights, then with the head zeroed (every target token 0:
    the reference's deterministic case, where drafts are accepted and a
    wrong one is rolled back). Over the phase the engines must have run
    verify ticks, accepted drafts and rolled back rejected ones."""
    import numpy as np
    from paddle_tpu_torch.serving import ServingEngine

    kw = dict(max_slots=4, block_size=16, prefill_chunk=256,
              max_model_len=1024, prefix_cache=True, **(engine_kw or {}))
    rows, totals = [], {"ticks": 0, "accepted": 0, "rollbacks": 0}
    for name, model in models:
        head = (model.lm_head.weight if model.lm_head is not None else
                (model.model.embed_tokens.weight if hasattr(model, "model")
                 else model.gpt.wte.weight))
        prompts = _spec_prompts(np.random.default_rng(SEED + 5),
                                model.config.vocab_size)
        for weights in ("seeded", "zero_head"):
            if weights == "zero_head":
                with torch.no_grad():
                    head.zero_()
            on = ServingEngine(model, spec_k=4, **kw)
            off = ServingEngine(model, spec_k=0, **kw)
            got = on.generate(prompts, max_new_tokens=new_tokens)
            plain = off.generate(prompts, max_new_tokens=new_tokens)
            for p, g, o in zip(prompts, got, plain):
                want = model.generate(torch.tensor([p], device=model.device),
                                      max_new_tokens=new_tokens)[0].tolist()
                for other, what in ((o, "spec_k=0"), (want, "generate()")):
                    if g != other:
                        t = next(i for i, (a, b) in enumerate(zip(g, other))
                                 if a != b)
                        raise AssertionError(
                            f"{name} ({weights}): spec_k=4 and {what} "
                            f"diverge at token {t} of a {len(p)}-token "
                            f"prompt ({g[t]} vs {other[t]}); top-2 logit "
                            f"margin there "
                            f"{top2_margin(torch, model, other, t):.3g}")
            spec = on.stats()["speculative"]
            for e in (on, off):
                graph_gate(e)
            for k in totals:
                totals[k] += spec[k]
            rows.append({"model": name, "weights": weights,
                         "engine_steps": [on.steps, off.steps], **spec})
    if min(totals.values()) <= 0:
        raise AssertionError(f"speculation did not run, accept and roll "
                             f"back: {totals} ({rows})")
    return {"phase": "spec_parity", "dtype": "float32",
            "prompts": [len(p) for p in prompts], "new_tokens": new_tokens,
            "token_match": True, "totals": totals, "runs": rows}


def _drive(torch, eng, prompts, new_tokens, reset, counts, layers):
    """Submit every prompt, reset the launch counts, run the engine dry.
    Returns the run's summary with its launch counts, read just after, and
    the launches of the first pure-decode plain tick and verify tick."""
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    decode_ticks, per_tick = 0, {}
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    while eng.sched.has_work():
        pure = not eng.sched.waiting and not eng.sched.prefilling
        before, spec_before = counts(), eng.spec_ticks
        out = eng.step()
        decode_ticks += out["decoded_tokens"] > 0
        kind = "verify" if eng.spec_ticks > spec_before else "plain"
        if pure and kind not in per_tick:
            after = counts()
            per_tick[kind] = {k: after[k] - before[k] for k in after}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    vocab = eng.model.config.vocab_size
    bad = [r.request_id for r in reqs if r.finish_reason != "length"
           or not all(0 <= t < vocab for t in r.output_tokens)]
    if bad:
        raise AssertionError(f"requests without their valid tokens: {bad}")
    st = eng.stats()
    if st["kv"]["used_blocks"] or not st["kv"]["conservation_ok"]:
        raise AssertionError(f"KV blocks leaked: {st['kv']}")
    plain = decode_ticks - st["speculative"]["ticks"]
    expect = {"paged_verify": layers * st["speculative"]["ticks"],
              "paged_decode": layers * plain}
    if any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f"paged launches {launches} are not {layers} "
                             f"a tick ({expect})")
    graphs = graph_gate(eng, ("prefill",))
    generated = sum(len(r.output_tokens) for r in reqs)
    return reqs, {
        "wall_s": wall, "engine_steps": st["steps"],
        "decode_ticks": decode_ticks, "plain_decode_ticks": plain,
        "generated_tokens": generated, "tokens_per_s": generated / wall,
        "mean_ttft_s": statistics.mean(r.ttft_seconds() for r in reqs),
        "speculative": st["speculative"], "graphs": graphs,
        "launches": launches, "launches_per_tick": per_tick}


def _agreement(torch, model, on, off):
    """How many of two runs' sequences are identical, and where the first
    pair parts: its token and the top-2 logit margin there."""
    same = sum(a == b for a, b in zip(on, off))
    out = {"requests_identical": same, "requests": len(on)}
    for i, (x, y) in enumerate(zip(on, off)):
        if x != y:
            t = next(t for t, (a, b) in enumerate(zip(x, y)) if a != b)
            out.update(first_mismatch_request=i, first_mismatch_token=t,
                       top2_margin=top2_margin(torch, model, y, t))
            break
    return out


def spec_slice_phase(torch, model, engine_kw, new_tokens, reset, counts,
                     kernels):
    """Main path 4: self-speculative serving of Llama-2-7B (the serving
    slice's model) over 10 requests, 7 of them repetitive (seeded 16-48
    token patterns repeated to 128-1024 tokens: the traffic of code
    editing, extraction and summaries that quote, where the output copies
    the input) and 3 random, with spec_k=4 and then spec_k=0 on the same
    requests, in two arms:

      * seeded: the random weights as they are. A random 7B never repeats
        its own history, so the n-gram drafter may find nothing to
        propose and every tick may be plain; reported as measured;
      * zero_head: the same model with its head zeroed, so every target is
        token 0 (the reference's deterministic speculation case): drafts
        of 0s are accepted, and each pattern ends in a 0 with the prompt
        cut just before it, so the first draft (the pattern's next
        tokens) is rejected and rolled back. This arm is the main path.

    Gates, in every run: paged verify launches == layers x verify ticks and
    paged decode launches == layers x plain decode ticks, and every tick of
    a kind (verify ones included) replayed its CUDA graph; in the main path
    verify replays > 0, every kernel of the path launched, drafts accepted
    and rolled back. In bf16 the two runs of an arm may part at a near-tie (the
    window's GEMMs round at slots x W rows): reported as agreement and the
    first mismatch's top-2 logit margin."""
    import numpy as np
    from paddle_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(SEED + 4)
    vocab, layers = model.config.vocab_size, model.config.num_layers
    prompts = []
    for _ in range(7):
        pat = rng.integers(1, vocab, int(rng.integers(16, 49)))
        pat[-1] = 0
        n = int(rng.integers(128, 1025))
        n -= (n + 1) % len(pat)              # ends just before a 0
        prompts.append([int(t) for t in np.resize(pat, n)])
    prompts += [[int(t) for t in rng.integers(0, vocab, int(
        rng.integers(128, 1025)))] for _ in range(3)]
    spec_k = engine_kw["spec_k"]
    arms = {}
    for weights in ("seeded", "zero_head"):
        if weights == "zero_head":
            with torch.no_grad():
                model.lm_head.weight.zero_()
        runs, outs = {}, {}
        for k in (spec_k, 0):
            eng = ServingEngine(model, **{**engine_kw, "spec_k": k})
            reqs, runs[k] = _drive(torch, eng, prompts, new_tokens, reset,
                                   counts, layers)
            outs[k] = [r.prompt + r.output_tokens for r in reqs]
            del eng
            release(torch)
        arms[weights] = {"spec": runs[spec_k], "plain": runs[0],
                         "bf16_agreement": _agreement(torch, model,
                                                      outs[spec_k], outs[0])}
    main = arms["zero_head"]["spec"]
    missing = [k for k in kernels if main["launches"][k] <= 0]
    spec = main["speculative"]
    if missing or min(spec["ticks"], spec["accepted"], spec["rollbacks"],
                      main["graphs"]["replays"]["verify"]) <= 0:
        raise AssertionError(f"the spec path did not run every kernel, "
                             f"accept and roll back: {missing} ({main})")
    return {"phase": "spec_slice", "layers": layers,
            "hidden": model.config.hidden_size,
            "dtype": str(model._cache_dtype()), "engine": dict(engine_kw),
            "prompt_tokens": [len(p) for p in prompts],
            "new_tokens_each": new_tokens, "arms": arms,
            "launches": main["launches"]}


def _greedy(torch, model, prompt, n, eos=None):
    """model.generate's greedy continuation of prompt, cut after eos."""
    out = model.generate(torch.tensor([prompt], device=model.device),
                         max_new_tokens=n,
                         eos_token_id=eos)[0].tolist()[len(prompt):]
    return out[:out.index(eos) + 1] if eos in out else out


def _http(url, obj=None, data=None, timeout=600):
    """POST obj as JSON (or raw bytes), or GET when both are None. Returns
    (status, body bytes)."""
    import urllib.request

    if obj is not None:
        data = json.dumps(obj).encode()
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def fuse_parity_phase(torch, cfg, device="cuda"):
    """Fused greedy decode in fp32 (TF32 off) at Llama-2-7B's widths, 2
    layers: ServingEngine(fuse_steps=4), whose greedy ticks replay a
    captured 4-step CUDA graph, must equal fuse_steps=1 (a 1-step graph)
    and model.generate token for token over budgets that are not multiples
    of 4, a request whose eos is its third token (inside a fused chunk),
    and a request that reaches max_model_len mid-chunk while another
    decodes on the same cached 512-token prefix. Then the KV wire between
    two ServingServers: a prefill_only request's 768-token prompt exported
    from A over /kv/export and ingested by B over /kv/ingest; B's pages
    must equal A's bit for bit, and B's decode of the prompt (a full
    prefix hit) must equal A's own."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import (ServingEngine, ServingServer,
                                          kv_wire_decode)

    model = LlamaForCausalLM(cfg, device=device, dtype="float32", seed=SEED)
    kw = dict(max_slots=4, block_size=16, prefill_chunk=256,
              max_model_len=1024)
    rng = np.random.default_rng(SEED + 6)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    shared = toks(512)
    while True:
        eos_prompt = toks(40)
        g = _greedy(torch, model, eos_prompt, 3)
        if g[2] not in g[:2]:
            break
    waves = [[(toks(30), 6, None), (toks(300), 7, None),
              (eos_prompt, 12, g[2]), (shared + toks(20), 9, None)],
             [(shared + toks(490), 60, None), (shared + toks(100), 9, None)]]
    outs, finish = {}, {}
    for fuse in (4, 1):
        eng = ServingEngine(model, fuse_steps=fuse, **kw)
        reqs = []
        for wave in waves:
            reqs += [eng.submit(p, max_new_tokens=n, eos_token_id=e)
                     for p, n, e in wave]
            eng.run_until_idle()
        outs[fuse] = [r.output_tokens for r in reqs]
        finish[fuse] = [r.finish_reason for r in reqs]
        graph_gate(eng, ("decode", "prefill"))
        if fuse == 4:
            replays, matched = eng.graph_replays, reqs[-1].prefix_matched
        del eng
    items = [x for w in waves for x in w]
    for i, (p, n, eos) in enumerate(items):
        want = _greedy(torch, model, p, min(n, kw["max_model_len"] - len(p)
                                            + 1), eos)
        for fuse in (4, 1):
            if outs[fuse][i] != want:
                t = next((j for j, (a, b) in enumerate(zip(outs[fuse][i],
                                                           want))
                          if a != b), min(len(want), len(outs[fuse][i])))
                raise AssertionError(
                    f"fuse_steps={fuse} and generate() diverge at token {t} "
                    f"of request {i} ({len(p)}-token prompt): "
                    f"{outs[fuse][i][t:t + 3]} vs {want[t:t + 3]}")
    if finish[4] != finish[1] or finish[4].count("stop") != 1 \
            or matched != 512 or replays <= 0:
        raise AssertionError(f"fuse parity did not reach its cases: "
                             f"{finish}, prefix hit {matched}, graph "
                             f"replays {replays}")
    # the KV wire between two servers, fp32
    prompt = toks(768)
    sa = ServingServer(ServingEngine(model, **kw), port=0)
    sb = ServingServer(ServingEngine(model, **kw), port=0)
    try:
        _http(sa.url() + "/generate", {"prompt": prompt,
                                       "prefill_only": True})
        _, wire = _http(sa.url() + "/kv/export", {"tokens": prompt})
        _, st = _http(sb.url() + "/kv/ingest", data=wire)
        st = json.loads(st)
        blocks = [r["block"] for r in
                  sb.engine.allocator.export_prefix(prompt)]
        blocks_a = [r["block"] for r in
                    sa.engine.allocator.export_prefix(prompt)]
        same = all(torch.equal(pa[blocks_a], pb[blocks])
                   for (ka, va), (kb, vb) in zip(sa.engine.pool.layers,
                                                 sb.engine.pool.layers)
                   for pa, pb in ((ka, kb), (va, vb)))
        got = {}
        for name, s in (("a", sa), ("b", sb)):
            _, body = _http(s.url() + "/generate", {"prompt": prompt,
                                                    "max_new_tokens": 12})
            got[name] = json.loads(body)["output_tokens"]
        b_prefill = sb.engine.prefill_tokens
    finally:
        sa.stop()
        sb.stop()
    if st["imported"] != 48 or not same or got["a"] != got["b"] \
            or b_prefill != 0 or len(kv_wire_decode(wire)) != 48:
        raise AssertionError(f"fp32 KV wire: ingest {st}, pages equal "
                             f"{same}, A {got['a']} vs B {got['b']}, B "
                             f"prefill tokens {b_prefill}")
    return {"phase": "fuse_parity", "dtype": "float32",
            "layers": cfg.num_layers, "engine": kw,
            "prompts": [len(p) for p, _, _ in items],
            "budgets": [n for _, n, _ in items],
            "output_tokens": [len(o) for o in outs[4]],
            "finish_reasons": finish[4], "graph_replays": replays,
            "token_match": True,
            "kv_wire_fp32": {"prompt_tokens": len(prompt), **st,
                             "pages_bitwise_equal": same,
                             "b_decode_equals_a": True}}


def sampler_phase(torch, cfg, n=20_000, temp=0.8):
    """Sampling on the card, at Llama-2-7B's widths, 2 layers, fp32 (TF32
    off):

      * the captured sampler: the engine's `_sample` over n copies of one
        64-entry logits row, captured as a CUDA graph with the engine's
        generator registered, replayed three times between eager draws on
        the same generator: each draw's total variation from
        softmax(logits / T) <= 0.02 (about 0.008 expected of exact draws),
        and no two of the six alike (a generator whose offset did not
        advance would repeat a replay's numbers);
      * engines: two seeded alike give the same tokens on a mixed batch
        (greedy, 0.8, greedy, 1e-6), a third seed other sampled tokens and
        the same greedy ones; the greedy and 1e-6 rows equal generate();
        every sampled tick replayed the sampled graph."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    model = LlamaForCausalLM(cfg, device="cuda", dtype="float32", seed=SEED)
    kw = dict(max_slots=4, block_size=16, prefill_chunk=256,
              max_model_len=1024)
    eng = ServingEngine(model, seed=11, **kw)
    logits = (torch.from_numpy(np.random.default_rng(SEED + 11)
                               .standard_normal(64).astype(np.float32)) * 2)
    logits = logits.cuda().expand(n, 64).contiguous()
    temps = torch.full((n,), temp, device="cuda")
    draw = torch.zeros(n, dtype=torch.int64, device="cuda")
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(eng._gen)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        draw.copy_(eng._sample(logits, temps))
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        draw.copy_(eng._sample(logits, temps))
    draws = []
    for _ in range(3):
        graph.replay()
        draws += [draw.clone(), eng._sample(logits, temps)]
    p = torch.softmax(logits[0].double() / temp, dim=-1)
    tv = [0.5 * float((torch.bincount(d, minlength=64).double() / n
                       - p).abs().sum()) for d in draws]
    distinct = len({tuple(d.tolist()) for d in draws})
    if max(tv) > 0.02 or distinct != len(draws):
        raise AssertionError(f"captured sampler: total variation {tv}, "
                             f"{distinct} distinct of {len(draws)} draws")
    del graph, eng
    rng = np.random.default_rng(SEED + 12)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, m)]
               for m in (40, 300, 23, 260)]
    temps = (0.0, 0.8, 0.0, 1e-6)
    runs = []
    for seed in (11, 11, 12):
        e = ServingEngine(model, seed=seed, **kw)
        reqs = [e.submit(pr, max_new_tokens=16, temperature=t)
                for pr, t in zip(prompts, temps)]
        e.run_until_idle()
        graphs = graph_gate(e, ("sampled", "prefill"))
        runs.append([r.output_tokens for r in reqs])
        del e
    greedy = [_greedy(torch, model, pr, 16) for pr in prompts]
    if runs[0] != runs[1] or runs[2][1] == runs[0][1] \
            or any(runs[j][i] != greedy[i] for j in range(3)
                   for i in (0, 2, 3)):
        raise AssertionError(f"seeded engines: {runs}; generate() "
                             f"{greedy}")
    return {"phase": "sampler", "dtype": "float32", "draws": n,
            "temperature": temp, "total_variation": tv,
            "distinct_draws": distinct, "engine_temps": list(temps),
            "same_seed_equal": True, "other_seed_differs": True,
            "greedy_rows_equal_generate": True, "graphs": graphs}


def _tick_rows(torch, eng, k):
    """(page, offset) of every K/V row the next k steps (or a window of k
    tokens) write for the live slots (the column clamped to the table, as
    the decode op clamps; the windows here stay inside their tables)."""
    bs = eng.block_size
    slots = eng._d_live.nonzero()[:, 0]
    pos = (eng._d_lens.long()[slots][:, None]
           + torch.arange(k, device=eng.device)[None])
    col = (pos // bs).clamp(max=eng.max_blocks_per_seq - 1)
    page = eng._d_tables[slots[:, None], col].long()
    return page.reshape(-1), (pos % bs).reshape(-1)


def _page_rows(torch, eng, k):
    """(snapshot, restore) of the decode state and the K/V rows the next k
    steps write: snapshot() reads the rows, restore() puts back the state
    (tokens, lengths, rows) saved now."""
    page, off = _tick_rows(torch, eng, k)
    saved = (eng._d_toks.clone(), eng._d_lens.clone(),
             [(kp[page, off].clone(), vp[page, off].clone())
              for kp, vp in eng.pool.layers])

    def snapshot():
        return [t[page, off] for kv in eng.pool.layers for t in kv]

    def restore():
        toks, lens, rows = saved
        for (kp, vp), (k_, v_) in zip(eng.pool.layers, rows):
            kp[page, off] = k_
            vp[page, off] = v_
        eng._d_toks.copy_(toks)
        eng._d_lens.copy_(lens)

    return snapshot, restore


def _body_vs_replay(torch, eng, key, snapshot, restore, pick):
    """From one state, run the graph body of `key` eagerly, restore, replay
    its captured graph. Returns the launch counts' deltas of the replay,
    whether pick(output) is equal and whether the rows snapshot() reads
    are bitwise equal; the state is restored after."""
    from paddle_tpu_torch.ops import gpu

    body, out = eng._bodies[key]
    with torch.no_grad():
        body(out)
    eager = (pick(out).clone(), [r.clone() for r in snapshot()])
    restore()
    before = gpu.launch_counts()
    got = pick(eng._run(key)).clone()
    after = gpu.launch_counts()
    rows_equal = all(torch.equal(a, b) for a, b in zip(eager[1],
                                                       snapshot()))
    restore()
    return ({n: after[n] - before[n] for n in after if after[n] != before[n]},
            torch.equal(eager[0], got), rows_equal)


def _busy_ms(events):
    """Union of the kernels' device intervals, ms."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy / 1e3


def _tick_times(torch, fn, calls=8):
    """Wall ms per call (one synchronise after `calls` calls) and the
    device's busy ms per call (the union of the kernels' intervals in a
    torch.profiler session over `calls` calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == cuda]
    busy = _busy_ms(kernels) / calls if kernels else None
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall if busy is not None else None,
            "kernels_per_call": len(kernels) / calls}


def _decoding(torch, eng, vocab, prompt_len, new_tokens, seed):
    """Fill every slot with a decoding request; fetch what is pending."""
    import numpy as np

    rng = np.random.default_rng(seed)
    reqs = [eng.submit([int(t) for t in rng.integers(0, vocab, prompt_len)],
                       max_new_tokens=new_tokens)
            for _ in range(eng.max_slots)]
    while eng.sched.waiting or eng.sched.prefilling:
        eng.step()
    eng._flush_pending()
    torch.cuda.synchronize()
    return reqs


def graph_tick_phase(torch, model, engine_kw, new_tokens=512,
                     prompt_len=512):
    """Each kind of graph body on a bf16 model of Llama-2-7B's widths (main
    passes one cut to CUT_LAYERS), 8 slots decoding 512-token prompts:

      * replay against eager: from one saved state, the body run eagerly
        and its captured graph replayed must give equal outputs and bitwise
        equal new K/V rows: greedy decode at k = 1 and 4 (tokens), the
        sampled step with half the slots at temperature 0.8 (the greedy
        slots' tokens; every slot's K/V rows), the verify window (spec_k
        4, drafts of 0-4 tokens: greedy, acc and nxt) and a 256-token
        prefill chunk at position 512 in the lane (the kept row's logits,
        the lane's new rows);
      * launches: the counts' deltas a replay adds must be RMSNorm 2L + 1
        and per-token RoPE L, and paged decode L a step (decode, sampled),
        paged verify L (verify) or no paged kernel (prefill), L the
        layers;
      * profiler: the kernel names torch.profiler records for one replay
        of the k = 1 and 4 decode graphs (or that it records none inside
        a graph);
      * timing: wall and device-busy ms per call and the busy share, the
        eager body against the graph, for every body, and whole engine
        ticks (graph, deferred fetch, bookkeeping) at fuse_steps 1 and 4;
      * memory: the bytes each kind's captures added to the engine's
        shared graph pool.

    Every measurement starts from the saved state and puts it back."""
    import collections

    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import ServingEngine

    layers = model.config.num_layers
    vocab = model.config.vocab_size
    eng = ServingEngine(model, **dict(engine_kw, fuse_steps=4))
    reqs = _decoding(torch, eng, vocab, prompt_len, new_tokens, SEED + 7)
    out = {"phase": "graph_tick", "layers": layers, "slots": eng.max_slots,
           "prompt_tokens": prompt_len,
           "graph_pool_bytes": dict(eng.graph_pool_bytes)}
    cuda = torch.autograd.DeviceType.CUDA
    norm_rope = {"rms_norm": 2 * layers + 1, "rope_packed": layers}

    def check(name, key, snapshot, restore, pick, want):
        captured = eng.graph_launches(*key)
        replayed, equal, rows_equal = _body_vs_replay(
            torch, eng, key, snapshot, restore, pick)
        if captured != want or replayed != want or not equal \
                or not rows_equal:
            raise AssertionError(
                f"graph {name}: launches captured {captured}, a replay "
                f"{replayed}, expected {want}; outputs equal {equal}, K/V "
                f"rows bitwise equal {rows_equal}")
        body, buf = eng._bodies[key]
        timing = {}
        for what, fn in (("eager", lambda: body(buf)),
                         ("graph", lambda: eng._run(key))):
            with torch.no_grad():
                timing[what] = _tick_times(torch, fn)
            restore()
        return {"launches_per_replay": replayed, "outputs_equal": True,
                "kv_rows_bitwise_equal": True, "eager_body": timing["eager"],
                "graph_replay": timing["graph"]}

    for k in (1, 4):
        want = {n: v * k for n, v in norm_rope.items()}
        want["paged_decode"] = layers * k
        snapshot, restore = _page_rows(torch, eng, k)
        out[f"k{k}"] = check(f"decode k={k}", ("decode", k), snapshot,
                             restore, lambda o: o, want)
        # what the profiler sees of one replay
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._run(("decode", k))
            torch.cuda.synchronize()
        restore()
        names = collections.Counter(
            e.name[:60] for e in prof.events() if e.device_type == cuda)
        out[f"k{k}"].update(
            profiler_kernels_one_replay=sum(names.values()),
            profiler_sees_graph_kernels=bool(names),
            profiler_top_kernels=dict(names.most_common(8)))
    # the sampled step: odd slots at temperature 0.8
    sampled = torch.arange(eng.max_slots, device=eng.device) % 2 == 1
    eng._d_temps.copy_(sampled.float() * 0.8)
    snapshot, restore = _page_rows(torch, eng, 1)
    out["sampled"] = check("sampled", ("sampled", 1), snapshot, restore,
                           lambda o: o[:, ~sampled],
                           {**norm_rope, "paged_decode": layers})
    eng._d_temps.zero_()
    # a 256-token chunk at position 512 of the lane (its rows below 512
    # are the last prompt's), over its first 768 rows
    chunk, at = eng.prefill_chunk, prompt_len
    ws = eng._lane
    x = eng._lane_in.host()
    x[:chunk] = np.random.default_rng(SEED + 9).integers(0, vocab, chunk)
    x[chunk], x[chunk + 1] = at, chunk - 1
    eng._lane_in.push()
    key = ("prefill", at + chunk)
    pf_out = eng._bodies[key][1]

    def lane_rows():
        return [t[0, at:at + chunk] for kv in ws for t in kv]

    def scribble():
        for t in lane_rows():
            t.zero_()
        pf_out.zero_()

    out["prefill"] = check("prefill", key, lane_rows, scribble,
                           lambda o: o, norm_rope)
    # a burst of max_slots rows through the batched prefill, fresh rows at
    # P 256 and rows at a 2,000-token offset at the largest P captured;
    # each row's suffix blocks are free blocks of the pool, its prefix the
    # null page
    rng = np.random.default_rng(SEED + 11)
    free = list(eng.allocator._free)
    bs, n, s_top = eng.block_size, eng.max_slots, eng._bp_S[-1]
    for name, S, off in (("batched_prefill_p256", 64, 0),
                         ("batched_prefill_pmax", 64, 2000)):
        P = next(v for v in eng._bp_P if v >= off + S)
        ns = -(-S // bs)
        blocks = torch.tensor(free[:n * ns], device=eng.device)
        free = free[n * ns:]
        x = eng._bp_in.host()
        x[:] = 0
        x[:, :S] = rng.integers(0, vocab, (n, S))
        x[:, s_top] = off
        x[:, s_top + 1] = S - 1 - np.arange(n)
        x[:, s_top + 2 + off // bs:s_top + 2 + off // bs + ns] = (
            blocks.cpu().numpy().reshape(n, ns))
        eng._bp_in.push()
        saved = [(kp[blocks].clone(), vp[blocks].clone())
                 for kp, vp in eng.pool.layers]

        def block_rows(blocks=blocks):
            return [t[blocks] for kv in eng.pool.layers for t in kv]

        def put_back(blocks=blocks, saved=saved):
            for (kp, vp), (k_, v_) in zip(eng.pool.layers, saved):
                kp[blocks] = k_
                vp[blocks] = v_

        out[name] = dict(check(name, ("batched_prefill", (S, P)),
                               block_rows, put_back, lambda o: o,
                               norm_rope), S=S, P=P, offset=off, rows=n)
    # whole engine ticks: replay, deferred fetch and bookkeeping
    ticks = {}
    for k in (1, 4):
        eng.fuse_steps = k
        ticks[f"fuse_steps_{k}"] = _tick_times(torch, eng.step, calls=8)
    out["engine_tick"] = ticks
    for r in reqs:
        eng.cancel(r)
    del eng
    release(torch)
    # the verify window, spec_k 4
    eng = ServingEngine(model, **dict(engine_kw, spec_k=4))
    reqs = _decoding(torch, eng, vocab, prompt_len, new_tokens, SEED + 7)
    W = eng.spec_k + 1
    x = eng._spec_in.host()
    x[:, :W - 1] = np.random.default_rng(SEED + 10).integers(
        0, vocab, (eng.max_slots, W - 1))
    x[:, W - 1] = np.arange(eng.max_slots) % W
    eng._spec_in.push()
    snapshot, restore = _page_rows(torch, eng, W)
    out["verify"] = check("verify", ("verify", W), snapshot, restore,
                          lambda o: o,
                          {**norm_rope, "paged_verify": layers})
    out["graph_pool_bytes_spec"] = dict(eng.graph_pool_bytes)
    for r in reqs:
        eng.cancel(r)
    return out


def server_slice_phase(torch, model, engine_kw, reset, counts, kernels,
                       new_tokens=64, kv_prompt=1024):
    """Main path 5: a ServingServer(port=0) over the 7B bf16 engine with
    fuse_steps=4. Eight concurrent HTTP clients (four streaming) ask for
    64 new tokens each on prompts of 64-1024 tokens: every request must
    finish with its 64 valid tokens, and each stream's lines must add up
    to the count its last line reports. /metrics must parse back with a
    TTFT count equal to the requests, /healthz answer 200 and /stats be
    one consistent snapshot. Then the KV wire: a prefill_only request with
    a 1,024-token prompt on server A, /kv/export, /kv/ingest into server B
    over a second engine: 64 blocks imported, bytes 64 x 2 x layers x the
    block's bytes, B's pages bitwise equal to A's, and B serving the
    prompt as a full prefix hit. Launch counts are read just after the
    clients' run, from 0 just before."""
    import threading

    import numpy as np
    from paddle_tpu_torch.observability import sinks
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    vocab, layers = model.config.vocab_size, model.config.num_layers
    kw = dict(engine_kw, fuse_steps=4)
    t0 = time.perf_counter()
    sa = ServingServer(ServingEngine(model, **kw), port=0)
    sb = ServingServer(ServingEngine(model, **kw), port=0)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 8)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in (64, 1024, 300, 512, 128, 777, 200, 1000)]
    results = [None] * len(prompts)

    def client(i):
        stream = i % 2 == 1
        _, body = _http(sa.url() + "/generate", {
            "prompt": prompts[i], "max_new_tokens": new_tokens,
            "tier": "smoke", "stream": stream})
        if stream:
            lines = [json.loads(x) for x in body.decode().splitlines() if x]
            results[i] = {"stream": True, "lines": len(lines),
                          "tokens": [t for x in lines[:-1]
                                     for t in x["tokens"]],
                          "last": lines[-1]}
        else:
            results[i] = {"stream": False, **json.loads(body)}

    try:
        torch.cuda.synchronize()
        reset()
        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        launches = counts()
        graphs = graph_gate(sa.engine, ("decode", "prefill"))
        bad = []
        for i, r in enumerate(results):
            if r is None:
                bad.append((i, "no answer"))
                continue
            toks = r["tokens"] if r["stream"] else r["output_tokens"]
            fin = r["last"] if r["stream"] else r
            n = fin["telemetry"]["output_tokens"]
            if fin["finish_reason"] != "length" or len(toks) != new_tokens \
                    or n != new_tokens \
                    or not all(0 <= t < vocab for t in toks):
                bad.append((i, fin["finish_reason"], len(toks), n))
        missing = [k for k in kernels if launches[k] <= 0]
        if bad or missing:
            raise AssertionError(f"server clients: {bad}; kernels not "
                                 f"launched: {missing} ({launches})")
        _, text = _http(sa.url() + "/metrics")
        parsed = sinks.parse_prometheus_text(text.decode())
        ttft_n = parsed[("serving_ttft_seconds_count", (("tier", "smoke"),))]
        code, health = _http(sa.url() + "/healthz")
        health = json.loads(health)
        _, stats = _http(sa.url() + "/stats")
        stats = json.loads(stats)
        if ttft_n != len(prompts) or code != 200 or not health["ok"] \
                or not stats["kv"]["conservation_ok"] \
                or stats["running"] + stats["prefilling"] \
                + stats["free_slots"] != kw["max_slots"]:
            raise AssertionError(f"scrape: ttft count {ttft_n}, healthz "
                                 f"{code} {health}, stats {stats}")
        # the KV wire, bf16 at full depth
        kvp = [int(t) for t in rng.integers(0, vocab, kv_prompt)]
        _, body = _http(sa.url() + "/generate", {"prompt": kvp,
                                                 "prefill_only": True})
        if json.loads(body)["finish_reason"] != "prefill_complete":
            raise AssertionError(f"prefill_only answered {body[:200]}")
        t2 = time.perf_counter()
        _, wire = _http(sa.url() + "/kv/export", {"tokens": kvp})
        t3 = time.perf_counter()
        _, st = _http(sb.url() + "/kv/ingest", data=wire)
        t4 = time.perf_counter()
        st = json.loads(st)
        ea, eb = sa.engine, sb.engine
        ba = [r["block"] for r in ea.allocator.export_prefix(kvp)]
        bb = [r["block"] for r in eb.allocator.export_prefix(kvp)]
        same = len(ba) == len(bb) and all(
            torch.equal(pa[ba], pb[bb])
            for (ka, va), (kb, vb) in zip(ea.pool.layers, eb.pool.layers)
            for pa, pb in ((ka, kb), (va, vb)))
        page = ea.pool.layers[0][0][0]
        blk_bytes = page.numel() * page.element_size()
        n_blocks = kv_prompt // ea.block_size
        prefill_before = eb.prefill_tokens
        _, body = _http(sb.url() + "/generate", {"prompt": kvp,
                                                 "max_new_tokens": 8})
        b_out = json.loads(body)
        hit = (eb.prefill_tokens == prefill_before
               and eb.cow_admissions == 1)
        if st["imported"] != n_blocks or st["rejected"] \
                or st["bytes"] != n_blocks * 2 * layers * blk_bytes \
                or not same or not hit \
                or b_out["finish_reason"] != "length":
            want_bytes = n_blocks * 2 * layers * blk_bytes
            raise AssertionError(f"KV wire: ingest {st} (want {n_blocks} "
                                 f"blocks, {want_bytes} bytes), pages "
                                 f"equal {same}, full prefix hit {hit}, "
                                 f"B {b_out}")
    finally:
        sa.stop()
        sb.stop()
    generated = sum(len(r["tokens"] if r["stream"] else r["output_tokens"])
                    for r in results)
    ttfts = [(r["last"] if r["stream"] else r)["telemetry"]["ttft_s"]
             for r in results]
    return {
        "phase": "server_slice", "layers": layers,
        "dtype": str(model._cache_dtype()), "engine": kw,
        "init_s": init_s, "clients": len(prompts), "streaming": 4,
        "prompt_tokens": [len(p) for p in prompts],
        "new_tokens_each": new_tokens, "wall_s": wall,
        "generated_tokens": generated, "tokens_per_s": generated / wall,
        "mean_ttft_s": statistics.mean(ttfts),
        "graphs": graphs,
        "stream_lines": [r["lines"] for r in results if r["stream"]],
        "metrics_ttft_count": ttft_n, "healthz": health["status"],
        "kv_wire": {"prompt_tokens": kv_prompt, **st,
                    "wire_bytes": len(wire), "export_s": t3 - t2,
                    "ingest_s": t4 - t3, "pages_bitwise_equal": same,
                    "full_prefix_hit": hit},
        "launches": launches,
    }


def gpt_serve_slice_phase(torch, reset, counts, cfg=None, device="cuda",
                          new_tokens=64):
    """GPT-3 1.3B (full depth, bf16, seeded weights) served with spec_k=4:
    8 slots, 16-token blocks, max_model_len 2048 = its
    max_position_embeddings. Wave 1: a repetitive 1,990-token prompt,
    which reaches the end of the context, and five shorter ones; wave 2,
    after the long prompt's blocks are cached: its first 1,984 tokens plus
    10 new ones, batched with a 200-token prompt, so the short suffix's row
    pads past the wpe table. Two arms on one model: the seeded weights,
    then the tied head (the token embedding) zeroed, so every target is
    token 0 and the long request drafts to its last token: its verify
    windows then run past the wpe table. Gates, in each arm: every output
    logit finite (checked on each model call, counted on the device, so
    the check also runs inside every decode graph replay; a NaN from an
    embedding would still show through the zero head), the pool finite at
    the end,
    the paged decode and verify kernels launched, the batched row asked
    for positions past the table; in the zero-head arm the windows too."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import ServingEngine

    if cfg is None:
        cfg = GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    ctx = cfg.max_position_embeddings
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, dtype="bfloat16", seed=SEED)
    sync()
    init_s = time.perf_counter() - t0
    calls = {"n": 0}
    # calls with a non-finite logit, counted on the device: no host sync,
    # so the check is captured into the decode graphs and runs at every
    # replay
    nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    def check(_, __, out):
        calls["n"] += 1
        nonfinite.add_((~torch.isfinite(out[0])).any().long())

    # the largest position each kind of cached call asks wpe for (the
    # model clamps it to the table), kept on the device so the verify
    # graphs record it too: [batched prefill rows, verify windows]
    asked_dev = torch.zeros(2, dtype=torch.int64, device=device)
    cached = model.gpt._cached

    def spy(ids, caches, pos):
        s = ids.shape[1]
        if hasattr(caches[0], "block_table"):
            if s > 1:
                asked_dev[1] = torch.maximum(
                    asked_dev[1], caches[0].seq_lens.max().long() + s - 1)
        elif torch.is_tensor(pos) and pos.dim() == 1:
            asked_dev[0] = torch.maximum(asked_dev[0],
                                         pos.max().long() + s - 1)
        return cached(ids, caches, pos)

    hook = model.register_forward_hook(check)
    model.gpt._cached = spy
    rng = np.random.default_rng(SEED + 6)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    long = [int(t) for t in np.resize(toks(40), ctx - 58)]
    prefix = len(long) // 16 * 16
    wave1 = [long] + [[int(t) for t in np.resize(toks(24), n)]
                      for n in (64, 100)] + [toks(n) for n in (96, 150, 33)]
    wave2 = [long[:prefix] + toks(10), toks(200)]
    arms = {}
    for weights in ("seeded", "zero_head"):
        if weights == "zero_head":
            with torch.no_grad():
                model.gpt.wte.weight.zero_()
        calls.update(n=0)
        nonfinite.zero_()
        asked_dev.zero_()
        eng = ServingEngine(model, device=device, max_slots=8, block_size=16,
                            prefill_chunk=256, max_model_len=ctx, spec_k=4)
        reqs = []
        reset()
        t1 = time.perf_counter()
        for wave in (wave1, wave2):
            reqs += [eng.submit(p, max_new_tokens=new_tokens) for p in wave]
            eng.run_until_idle()
        sync()
        wall = time.perf_counter() - t1
        launches = counts()
        calls["nonfinite"] = int(nonfinite)
        asked = dict(zip(("batched_prefill", "verify_window"),
                         asked_dev.tolist()))
        graphs = graph_gate(eng, ("prefill",))
        st = eng.stats()
        pool_finite = all(bool(torch.isfinite(k).all()
                               and torch.isfinite(v).all())
                          for k, v in eng.pool.layers)
        arm = arms[weights] = {
            "wall_s": wall, "output_tokens": [len(r.output_tokens)
                                              for r in reqs],
            "engine_steps": st["steps"],
            "batched_prefills": st["batched_prefills"],
            "prefix_hit_tokens": reqs[-2].prefix_matched,
            "speculative": st["speculative"],
            "eager_model_calls": calls["n"], "graphs": graphs,
            "nonfinite_logit_calls": calls["nonfinite"],
            "pool_finite": pool_finite, "max_position_asked": dict(asked),
            "launches": launches}
        window_past = asked["verify_window"] >= ctx or weights == "seeded"
        if calls["nonfinite"] or not pool_finite \
                or min(launches.values()) <= 0 or st["kv"]["used_blocks"] \
                or reqs[-2].prefix_matched < prefix \
                or asked["batched_prefill"] < ctx or not window_past:
            raise AssertionError(f"GPT serving ({weights}) failed its "
                                 f"gates: {arm}")
        del eng
    hook.remove()
    del model.gpt._cached
    return {"phase": "gpt_serve_slice", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "dtype": "torch.bfloat16",
            "init_s": init_s, "prompt_tokens": [len(p) for p in
                                                wave1 + wave2],
            "wpe_positions": ctx, "arms": arms}


# ------------------------------------------------------------ the fleet
def _fleet_faults(replicas):
    """Raise unless no replica's breaker was struck and no replica loop
    raised: a tick that raises is a breaker strike, which the router hides
    behind re-dispatch."""
    bad = {rid: (rep.breaker.failures, rep.last_error)
           for rid, rep in replicas.items()
           if rep.breaker.failures or rep.last_error}
    if bad:
        raise AssertionError(f"unplanned replica faults: {bad}")


def _settle(freqs, timeout=600):
    late = [f.request_id for f in freqs if not f.wait(timeout)]
    if late:
        raise AssertionError(f"fleet requests left unfinished: {late}")


def _until(cond, what, timeout=120):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _hold(rep):
    """Pause a thread replica's loop and let a tick that began before the
    pause end, so that only this thread steps its engine from here on."""
    rep.pause()
    time.sleep(0.05)


def _step_held(rep, cond, what, ticks=512):
    """Tick a held replica's engine from this thread until `cond()`. A
    state a few ticks wide (every request of a replica past its first
    token and none finished) is then reached on every host: polling a
    running loop for it missed it on a loaded one."""
    for _ in range(ticks):
        if cond():
            return
        rep.engine.step()
    if not cond():
        raise AssertionError(f"{what} not reached in {ticks} ticks")


def _mid_decode(f):
    """The fleet request's live attempt has its first token (its fetch
    may be deferred) and has not finished."""
    att = f.live_attempts()
    return bool(att) and att[-1].req.first_token_time is not None \
        and att[-1].req.state != "finished"


def fleet_parity_phase(torch, cfg, new_tokens=48):
    """The fleet on the card in fp32 (TF32 off): two replicas from an
    identically seeded factory (Llama-2-7B widths, 2 layers; 4 slots,
    16-token blocks, 256-token chunks, 1024 context), each a ServingEngine
    whose ticks replay CUDA graphs, run by real threads under a
    FleetRouter. Every request's tokens must equal model.generate's, in
    every scenario: affinity (a shared 256-token prefix lands on the
    replica that holds it and is served from its cache); a kill with
    re-dispatch (replica-0 dies mid-decode); a hedge (replica-0 paused past
    the TTFT deadline: the hedge wins, the loser's slot and KV are freed);
    drain and resume (routed around, then affinity back); a drain with
    migrate=True mid-decode (every migrated session admits its streamed
    chain as a full prefix hit); disaggregated 1 prefill + 1 decode (no
    prefill token on the decode replica); the autoscaler growing 1 -> 2
    replicas (the new engine built and captured while replica-0's loop
    replays its graphs: its launch deltas must equal replica-0's) and
    shrinking back. No replica's breaker may be struck and no request left
    unfinished. Then a rotary GPT (GPT-3 1.3B widths, 2 layers,
    use_rotary): generate() and the engine equal, through the RoPE kernel
    (contiguous in generate(), per token in the engine's graphs)."""
    import numpy as np
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaForCausalLM)
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.serving import (FleetAutoscaler, FleetRouter,
                                          ServingEngine)

    kw = dict(max_slots=4, block_size=16, prefill_chunk=256,
              max_model_len=1024)

    def factory():
        return LlamaForCausalLM(cfg, device="cuda", dtype="float32",
                                seed=SEED)

    ref = factory()
    rng = np.random.default_rng(SEED + 20)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    def check(freqs, name):
        for f in freqs:
            want = _greedy(torch, ref, f.prompt, f.max_new_tokens)
            if f.output_tokens != want or f.finish_reason != "length":
                raise AssertionError(
                    f"fleet {name}: request {f.request_id} "
                    f"({len(f.prompt)} tokens) gave {f.output_tokens[:8]}"
                    f"..., generate() {want[:8]}... ({f.finish_reason})")

    engines = [ServingEngine(factory(), **kw) for _ in range(2)]
    seen = {}
    out = {"phase": "fleet_parity", "layers": cfg.num_layers,
           "new_tokens": new_tokens}

    def router(n=2, **rkw):
        r = FleetRouter(engines[:n], **rkw)
        seen.update({f"{len(seen)}:{k}": v for k, v in r.replicas.items()})
        return r.start()

    # affinity: the prefix's owner gets the follow-up
    prefix = toks(256)
    r = router()
    a = r.submit(prefix + toks(20), max_new_tokens=new_tokens)
    _settle([a])
    b = r.submit(prefix + toks(30), max_new_tokens=new_tokens)
    c = r.submit(toks(40), max_new_tokens=new_tokens)
    _settle([b, c])
    check([a, b, c], "affinity")
    homes = [f.attempts[0].replica.rid for f in (a, b, c)]
    if homes[1] != homes[0] or b.attempts[0].req.prefix_matched != 256:
        raise AssertionError(f"affinity: homes {homes}, matched "
                             f"{b.attempts[0].req.prefix_matched}")
    out["affinity"] = {"homes": homes,
                       "prefix_matched": b.attempts[0].req.prefix_matched}
    r.stop()

    # kill: replica-0 dies mid-decode, its requests move to replica-1
    r = router()
    for rep in r.replicas.values():
        _hold(rep)
    freqs = [r.submit(toks(n), max_new_tokens=4 * new_tokens)
             for n in (40, 300, 77, 150)]
    doomed = [f for f in freqs if f.attempts[0].replica.rid == "replica-0"]
    _step_held(r.replicas["replica-0"],
               lambda: all(_mid_decode(f) for f in doomed),
               "replica-0 decoding")
    r.kill_replica("replica-0")
    r.replicas["replica-1"].unpause()
    _settle(freqs)
    check(freqs, "kill")
    moved = sum(f.redispatches for f in freqs)
    if moved != len(doomed) or not doomed:
        raise AssertionError(f"kill: {moved} re-dispatched of "
                             f"{len(doomed)} on replica-0")
    out["kill"] = {"requests": len(freqs), "redispatched": moved}
    r.stop()

    # hedge: replica-0 hangs, the hedge on replica-1 wins
    r = router(hedge_ttft_ms=100.0)
    _hold(r.replicas["replica-0"])
    h = r.submit(toks(60), max_new_tokens=new_tokens)
    _settle([h])
    check([h], "hedge")
    kinds = [(a.kind, a.replica.rid, a.failed) for a in h.attempts]
    st = engines[0].stats()
    if kinds != [("primary", "replica-0", True),
                 ("hedge", "replica-1", False)] or st["running"] \
            or st["waiting"] or st["prefilling"] or st["reserved_blocks"]:
        raise AssertionError(f"hedge: attempts {kinds}, loser {st}")
    r.replicas["replica-0"].unpause()
    out["hedge"] = {"attempts": kinds}
    r.stop()

    # drain and resume
    r = router()
    p = toks(100)
    long = r.submit(p, max_new_tokens=4 * new_tokens)
    r.drain("replica-0")
    side = r.submit(p, max_new_tokens=new_tokens)
    _settle([long, side])
    _until(lambda: r.drained("replica-0"), "the drain")
    r.resume("replica-0")
    back = r.submit(p, max_new_tokens=new_tokens)
    _settle([back])
    check([long, side, back], "drain")
    homes = [f.attempts[0].replica.rid for f in (long, side, back)]
    if homes != ["replica-0", "replica-1", "replica-0"]:
        raise AssertionError(f"drain: homes {homes}")
    out["drain_resume"] = {"homes": homes}
    r.stop()

    # a migrating drain mid-decode: block-multiple prompts, so the
    # streamed chain is the whole prompt
    r = router()
    _hold(r.replicas["replica-0"])
    freqs = [r.submit(toks(n), max_new_tokens=new_tokens)
             for n in (64, 128, 256, 192)]
    on0 = [f for f in freqs if f.attempts[0].replica.rid == "replica-0"]
    _step_held(r.replicas["replica-0"],
               lambda: all(_mid_decode(f) for f in on0),
               "replica-0 decoding")
    r.drain("replica-0", migrate=True)
    r.replicas["replica-0"].unpause()
    _settle(freqs)
    check(freqs, "migrate")
    migs = [f for f in freqs if f.migrations]
    matched = [(len(f.prompt), f.attempts[-1].req.prefix_matched)
               for f in migs]
    if len(migs) != len(on0) or any(m != n for n, m in matched):
        raise AssertionError(f"migrate: {len(migs)} of {len(on0)} moved, "
                             f"(prompt, matched) {matched}")
    out["migrate"] = {"migrated": len(migs), "prompt_and_matched": matched,
                      "kv": [f.kv_streamed for f in migs]}
    r.resume("replica-0")
    r.stop()

    # disaggregated: 1 prefill + 1 decode
    r = router(roles="prefill:1,decode:1")
    before = engines[1].prefill_tokens
    freqs = [r.submit(toks(n), max_new_tokens=new_tokens)
             for n in (16, 32, 48, 64, 128, 256)]
    _settle(freqs)
    check(freqs, "disaggregated")
    decode_prefill = engines[1].prefill_tokens - before
    if decode_prefill or any(f.attempts[-1].replica.rid != "replica-1"
                             or f.kv_streamed is None for f in freqs):
        raise AssertionError(f"disaggregated: {decode_prefill} prefill "
                             f"tokens on the decode replica")
    out["disaggregated"] = {"decode_replica_prefill_tokens": decode_prefill,
                            "kv_bytes": sum(f.kv_streamed["bytes"]
                                            for f in freqs)}
    r.stop()

    # the autoscaler: 1 -> 2 while replica-0 replays, then back to 1
    r = router(n=1)
    spawned = []

    def spawn():
        # replica-0 is held until the scaler fires, so the burst's load
        # crosses `hi` on every host; it replays while the new engine is
        # built and captured
        r.replicas["replica-0"].unpause()
        spawned.append(ServingEngine(factory(), **kw))
        return spawned[-1]

    scaler = FleetAutoscaler(r, spawn, min_replicas=1, max_replicas=2,
                             hi=0.75, lo=0.25, cooldown_s=0.5,
                             slots_per_replica=kw["max_slots"])
    r.attach_autoscaler(scaler)
    _hold(r.replicas["replica-0"])
    freqs = [r.submit(toks(n), max_new_tokens=new_tokens)
             for n in (30, 60, 90, 120, 150, 180, 210, 240)]
    _until(lambda: len(r.replicas) == 2, "the scale-up")
    seen.update({f"{len(seen)}:{k}": v for k, v in r.replicas.items()})
    freqs += [r.submit(toks(n), max_new_tokens=new_tokens)
              for n in (50, 70, 90, 110)]
    _settle(freqs)
    check(freqs, "autoscaler")
    _until(lambda: len(r.replicas) == 1 and scaler._retiring is None,
           "the scale-down")
    deltas = {k: v[1] for k, v in engines[0]._graphs.items()}
    if {k: v[1] for k, v in spawned[0]._graphs.items()} != deltas:
        raise AssertionError("the engine captured beside a replaying one "
                             "recorded other launch deltas")
    out["autoscaler"] = {"events": [(e["dir"], e["replica"],
                                     e["utilization"])
                                    for e in scaler.events],
                         "served_by_new": sum(
                             f.attempts[-1].replica.engine is spawned[0]
                             for f in freqs)}
    r.stop()
    _fleet_faults(seen)
    out["graphs"] = [graph_gate(e) for e in engines + spawned]
    del engines, spawned, ref
    release(torch)

    # the rotary GPT
    gcfg = GPTConfig.gpt3_1p3b()
    gcfg.num_layers = 2
    gcfg.use_rotary = True
    gcfg.hidden_dropout_prob = gcfg.attention_dropout_prob = 0.0
    gpt = GPTForCausalLM(gcfg, device="cuda", dtype="float32", seed=SEED)
    prompts = [[int(t) for t in rng.integers(0, gcfg.vocab_size, n)]
               for n in (30, 300, 41)]
    gpu.reset_launch_counts()
    wants = [_greedy(torch, gpt, q, new_tokens) for q in prompts]
    rope_gen = gpu.launch_counts(("rope",))["rope"]
    eng = ServingEngine(gpt, **kw)
    gpu.reset_launch_counts()
    got = eng.generate(prompts, max_new_tokens=new_tokens)
    rope_eng = gpu.launch_counts(("rope_packed",))["rope_packed"]
    same = [g[len(q):] for g, q in zip(got, prompts)] == wants
    if not same or not rope_gen or not rope_eng:
        raise AssertionError(f"rotary GPT: engine equals generate() "
                             f"{same}, RoPE launches {rope_gen}, "
                             f"{rope_eng}")
    out["rotary_gpt"] = {"layers": gcfg.num_layers, "token_match": True,
                         "rope_launches_generate": rope_gen,
                         "rope_packed_launches_engine": rope_eng,
                         "graphs": graph_gate(eng, ("decode", "prefill"))}
    return out


def _burst(rng, vocab, count=24, new=(32, 64)):
    """tools/servebench.py's disaggregation trace, cut to one burst:
    block-multiple prompts of 16, 32 or 48 tokens, 32-64 new tokens (or
    `new`, inclusive)."""
    return [([int(t) for t in rng.integers(0, vocab, int(rng.choice(
        (16, 32, 48))))], int(rng.integers(new[0], new[1] + 1)))
        for _ in range(count)]


def _union_s(spans):
    """Seconds covered by the union of (start, end) spans in microseconds,
    and the idle gaps between them."""
    busy, gaps = 0.0, []
    cur = None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append(s - cur[1])
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / 1e6, [g / 1e6 for g in gaps]


def _device_trace(torch, run):
    """Run `run()` under torch.profiler (device activity only) and sum the
    trace's kernels, copies and sets: the window from the first one's
    start to the last one's end, the busy share (their union over the
    window), per stream its events and busy seconds, `concurrent_s` (the
    streams' busy seconds summed, less the union: time two streams ran at
    once), and the five longest idle gaps. A trace with no device event
    says so; a profiler that fails gives its error, not the phase's."""
    import json
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    # the trace is a measurement: a profiler fault is reported, and `run`
    # runs (and raises) whatever the profiler does
    err = None
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # noqa: BLE001
        prof, err = None, repr(e)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception as e:  # noqa: BLE001
                prof, err = None, repr(e)
    if prof is None:
        return {"error": err}
    try:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    except Exception as e:  # noqa: BLE001
        return {"error": repr(e)}
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e.get("args", {}).get("stream"), e.get("cat"))
           for e in events if isinstance(e, dict) and "ts" in e
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return {"device_events": 0}
    window = (max(e for _, e, _, _ in dev)
              - min(s for s, _, _, _ in dev)) / 1e6
    busy, gaps = _union_s([(s, e) for s, e, _, _ in dev])
    streams = {}
    for st in {st for _, _, st, _ in dev}:
        mine = [(s, e) for s, e, x, _ in dev if x == st]
        streams[str(st)] = {"events": len(mine),
                            "busy_s": _union_s(mine)[0]}
    return {"device_events": len(dev),
            "kernels": sum(c == "kernel" for *_, c in dev),
            "window_s": window, "busy_s": busy,
            "busy_share": busy / window if window else None,
            "streams": streams,
            "concurrent_s": sum(v["busy_s"] for v in streams.values())
            - busy,
            "longest_gaps_s": sorted(gaps, reverse=True)[:5]}


def _fleet_traffic(vocab, new_tokens):
    """The fleet slices' traffic: slice 1's 10 requests in two waves
    (slice_phase's seed and order) and a burst of 24 short prompts."""
    import numpy as np

    rng = np.random.default_rng(SEED + 1)

    def toks(n):
        return [int(t) for t in rng.integers(0, vocab, n)]

    shared = toks(256)
    lens = (16, 64, 128, 512, 768, 1024, 288, 356)
    wave1 = [toks(n) for n in lens[:-2]]
    wave1 += [shared + toks(n - 256) for n in lens[-2:]]
    repeat = next(p for p in wave1 if len(p) % 16 == 0)
    slice10 = [[(p, new_tokens) for p in wave1],
               [(shared + toks(48), new_tokens), (list(repeat), new_tokens)]]
    burst = [_burst(np.random.default_rng(SEED + 30), vocab)]
    return slice10, burst


def fleet_slice_phase(torch, reset, counts, kernels, new_tokens=64):
    """Two replicas of Llama-2-7B's widths cut to CUT_LAYERS (bf16, seeded
    alike) on one card, each a ServingEngine as slice 1 runs it (8 slots, 16-token
    blocks, 256-token chunks, 2048 context), under a FleetRouter with real
    replica threads. Arms, each on fresh engines: one replica against two
    symmetric ones on slice 1's 10 requests (two waves) and on a burst of
    24 short greedy prompts; one replica of 16 slots on both; 1 prefill +
    1 decode on the same burst; two symmetric replicas with a
    migrate=True drain of replica-0 once the first request of another
    such burst, answered at 1024-1536 tokens, has finished: once as
    FleetServer's /drain?migrate=1 and the autoscaler drain do it
    (replica-0 ticking on: a session that finishes before its transfer
    does stays) and
    once with replica-0 paused around the drain (a replica that must go
    now). For each: tokens/s,
    mean TTFT (router arrival to first token), requests re-dispatched,
    hedged, shed and migrated, every KV transfer's blocks, bytes, seconds
    and its export and ingest halves, prefill tokens on the decode
    replica, graph_stats() per replica, peak memory and engine
    construction seconds. One more burst on one replica and on two runs
    under torch.profiler (_device_trace). Raises on an unplanned breaker
    strike, an unfinished request, a request without its tokens, a
    prefill token on the decode replica, a drain that moved no session,
    a moved session that did not admit its streamed chain, a
    serving kernel not launched, or a tick not replayed. Two replicas
    share one card's SMs and memory: this is not scale-out, and no gain
    is expected."""
    import numpy as np
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.serving import FleetRouter, ServingEngine

    cfg = LlamaConfig.llama2_7b()
    cfg.num_layers = CUT_LAYERS
    kw = dict(max_slots=8, block_size=16, prefill_chunk=256,
              max_model_len=2048)
    t0 = time.perf_counter()
    models = [LlamaForCausalLM(cfg, device="cuda", dtype="bfloat16",
                               seed=SEED) for _ in range(2)]
    torch.cuda.synchronize()
    model_init_s = time.perf_counter() - t0
    slice10, burst = _fleet_traffic(cfg.vocab_size, new_tokens)
    # the drains' burst answers at 1024-1536 tokens and drains once its
    # first request is done: replica-0's sessions then outlast their KV
    # transfers (0.05-0.8 s each, one after another, behind both
    # replicas' ticks) by seconds. Draining after a third of the burst,
    # at 128-256 tokens, the ticking drain found replica-0's sessions
    # finished before their turn and moved none; at 512-1024 tokens
    # after the first request, it moved 2-3
    burst_m = [_burst(np.random.default_rng(SEED + 31), cfg.vocab_size,
                      new=(1024, 1536))]
    burst_p = [_burst(np.random.default_rng(SEED + 32), cfg.vocab_size)]
    names = ("fleet_requests_redispatched_total",
             "fleet_requests_hedged_total", "fleet_requests_shed_total")

    def total(name):
        return registry.REGISTRY.get(name).total()

    def run_arm(n, traces, roles=None, drain_after=None, pause=False,
                slots=8, traced=None):
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engines = [ServingEngine(models[i], **dict(kw, max_slots=slots))
                   for i in range(n)]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        router = FleetRouter(engines, roles=roles)
        transfers = []
        stream = router._stream_kv

        def timed_stream(freq, src, dst, kind):
            t = time.perf_counter()
            st = stream(freq, src, dst, kind)
            if st is not None:
                transfers.append({"kind": kind, "blocks": st["imported"]
                                  + st["dedup"], "bytes": st["bytes"],
                                  "seconds": time.perf_counter() - t,
                                  "export_s": st["export_s"],
                                  "ingest_s": st["ingest_s"]})
            return st

        router._stream_kv = timed_stream
        router.start()
        runs = []
        device_trace = None

        def serve(trace):
            freqs = []
            for wave in trace:
                mine = [router.submit(p, max_new_tokens=m) for p, m in wave]
                freqs += mine
                if drain_after is not None:
                    _until(lambda: sum(f.done for f in mine)
                           >= drain_after, "the first request done")
                    if pause:
                        router.replicas["replica-0"].pause()
                    router.drain("replica-0", migrate=True)
                    if pause:
                        router.replicas["replica-0"].unpause()
                _settle(mine)
            return freqs

        for trace in traces + ([traced] if traced else []):
            before = {k: total(k) for k in names}
            pf0 = [e.prefill_tokens for e in engines]
            reset()
            t1 = time.perf_counter()
            if trace is traced:
                out = {}
                device_trace = _device_trace(
                    torch, lambda: out.setdefault("f", serve(trace)))
                freqs = out["f"]
            else:
                freqs = serve(trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = counts()
            short = [f.request_id for f in freqs
                     if len(f.output_tokens) != f.max_new_tokens
                     or not all(0 <= t < cfg.vocab_size
                                for t in f.output_tokens)]
            if short or any(v <= 0 for v in launches.values()):
                raise AssertionError(f"requests without their tokens "
                                     f"{short}; launches {launches}")
            gen = sum(len(f.output_tokens) for f in freqs)
            runs.append({
                "profiled": trace is traced,
                "requests": len(freqs), "generated_tokens": gen,
                "wall_s": wall, "tokens_per_s": gen / wall,
                "mean_ttft_s": statistics.mean(
                    f.first_token_ts - f.submit_ts for f in freqs),
                **{k.split("_")[2]: total(k) - before[k] for k in names},
                "migrated": sum(f.migrations for f in freqs),
                "prefill_tokens": [e.prefill_tokens - b
                                   for e, b in zip(engines, pf0)],
                "launches": launches,
                "tokens": {i: f.output_tokens for i, f in enumerate(freqs)},
                # sessions whose KV streamed (those still queued had none)
                "migrated_matched": [
                    (len(f.prompt), f.attempts[-1].req.prefix_matched)
                    for f in freqs if f.migrations and f.kv_streamed]})
        router.stop()
        _fleet_faults(router.replicas)
        graphs = [graph_gate(e) for e in engines]
        out = {"replicas": n, "slots": slots,
               "roles": roles or "symmetric",
               "drain": (None if drain_after is None else
                         "paused" if pause else "ticking"),
               "engine_init_s": init_s, "runs": runs,
               "device_trace": device_trace,
               "kv_transfers": transfers, "graphs": graphs,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "kv_pool_bytes": [e.pool.nbytes() for e in engines]}
        del router, engines
        return out

    arms = {"one": run_arm(1, [slice10, burst], traced=burst_p),
            "two": run_arm(2, [slice10, burst], traced=burst_p),
            "one_16_slots": run_arm(1, [slice10, burst], slots=16),
            "disaggregated": run_arm(2, [burst], roles="prefill:1,decode:1"),
            "migrate_drain": run_arm(2, [burst_m], drain_after=1),
            "migrate_drain_paused": run_arm(2, [burst_m], drain_after=1,
                                            pause=True)}
    release(torch)
    dis = arms["disaggregated"]["runs"][0]
    if dis["prefill_tokens"][1]:
        raise AssertionError(f"{dis['prefill_tokens'][1]} prefill tokens "
                             f"on the decode replica")
    for arm in ("migrate_drain", "migrate_drain_paused"):
        mig = arms[arm]["runs"][0]
        if not mig["migrated"] or any(m != n for n, m in
                                      mig["migrated_matched"]):
            raise AssertionError(
                f"{arm}: {mig['migrated']} moved, (prompt, matched) "
                f"{mig['migrated_matched']}")
    if not any(g["replays"]["batched_prefill"]
               for a in arms.values() for g in a["graphs"]):
        raise AssertionError("no batched prefill replayed on the fleet")
    # the bf16 agreement of one and two replicas on the same requests
    agree = {}
    for i, trace in enumerate(("slice", "burst")):
        a = arms["one"]["runs"][i]["tokens"]
        b = arms["two"]["runs"][i]["tokens"]
        agree[trace] = sum(a[k] == b[k] for k in a) / len(a)
    for arm in arms.values():
        for run in arm["runs"]:
            del run["tokens"]
    return {"phase": "fleet_slice", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "dtype": "torch.bfloat16",
            "engine_kw": kw, "model_init_s": model_init_s,
            "kernels": list(kernels), "arms": arms,
            "same_tokens_one_vs_two": agree}


# ------------------------------------------------------ process replicas
def proc_llama_2l():
    """Process replica factory of proc_fleet_parity (a child imports it as
    chip_smoke:proc_llama_2l): Llama-2-7B's widths cut to 2 layers, fp32
    with TF32 off, the weights seeded on the card by the model's explicit
    generator, so every incarnation is bitwise the parent's reference."""
    import torch
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b()
    cfg.num_layers = 2
    return LlamaForCausalLM(cfg, device="cuda", dtype="float32", seed=SEED)


def proc_llama_7b():
    """Process replica factory of proc_fleet_slice: Llama-2-7B's widths
    cut to CUT_LAYERS in bf16, seeded as fleet_slice's replicas are."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b()
    cfg.num_layers = CUT_LAYERS
    return LlamaForCausalLM(cfg, device="cuda", dtype="bfloat16", seed=SEED)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _compute_apps():
    """nvidia-smi's processes on the card: [(pid, used MiB)] (a sandbox's
    pid namespace may hide them)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": repr(e)}
    rows = []
    for line in out.stdout.strip().splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            rows.append((int(parts[0]), parts[1]))
    return rows


class _ProcFleet:
    """One process fleet of a phase: a TCPStore master in this process
    (the children's store traffic through a StorePartitionProxy when
    asked), a FleetRouter over supervised process replicas built from
    `factory`, each child's stderr in a temporary directory. ready() raises
    with a child's last_exit and log tail as soon as an incarnation dies
    before it is up; close() stops the router and raises if any child it
    ever started is still alive."""

    def __init__(self, n, factory, engine_kw, *, tag, roles=None,
                 proxy=False, warmup_s=120.0, backoff_s=2.0,
                 lease_ttl_s=2.0):
        import tempfile

        from paddle_tpu_torch import native
        from paddle_tpu_torch.resilience import chaos
        from paddle_tpu_torch.serving import build_process_fleet

        self.log_dir = tempfile.mkdtemp(prefix=f"proc_fleet_{tag}_")
        self.store = native.TCPStore("127.0.0.1", 0, is_master=True)
        self.proxy = (chaos.StorePartitionProxy("127.0.0.1",
                                                self.store.port)
                      if proxy else None)
        self.addr = ((self.proxy.host, self.proxy.port) if proxy
                     else ("127.0.0.1", self.store.port))
        root = os.path.dirname(os.path.abspath(__file__))
        path = os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.spec_kwargs = dict(
            factory=factory, engine_kwargs=engine_kw, child_heartbeat_s=0.2,
            warmup_timeout_s=warmup_s, respawn_backoff_s=backoff_s,
            respawn_max=2, extra_env={"PYTHONPATH": path},
            log_dir=self.log_dir)
        self.prefix = f"/chip/{tag}"
        self.router = build_process_fleet(
            n, store=self.store, store_addr=self.addr,
            spec_kwargs=self.spec_kwargs,
            router_kwargs=dict(roles=roles, heartbeat_s=0.05,
                               lease_ttl_s=lease_ttl_s, prefix=self.prefix))
        self.pids = set()
        self.t0 = time.monotonic()
        self.router.start()

    def logs(self, limit=1500):
        out = {}
        for name in sorted(os.listdir(self.log_dir)):
            with open(os.path.join(self.log_dir, name), "rb") as f:
                out[name] = f.read()[-limit:].decode(errors="replace")
        return out

    def note_pids(self):
        for rep in self.router.replicas.values():
            self.pids.update(rep.children())

    def ready(self, timeout, exits_ok=()):
        """Seconds until every replica passed its warm-up probe. Raises at
        once when a replica not in `exits_ok` records an exit."""
        t0 = time.monotonic()
        while True:
            reps = list(self.router.replicas.values())
            bad = {r.rid: r.last_exit for r in reps
                   if r.last_exit and r.rid not in exits_ok}
            if bad:
                raise AssertionError(f"a process replica died: {bad}; "
                                     f"child logs {self.logs()}")
            if all(not r.warming() for r in reps):
                self.note_pids()
                return time.monotonic() - t0
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"process replicas not ready after "
                                     f"{timeout} s; logs {self.logs()}")
            time.sleep(0.02)

    def stats(self):
        return {rid: rep.engine.stats()
                for rid, rep in self.router.replicas.items()}

    def histograms(self, series):
        """{rid: (sum, count)} of a histogram in each child's /metrics."""
        from paddle_tpu_torch.observability.sinks import \
            parse_prometheus_text

        out = {}
        for rid, rep in self.router.replicas.items():
            text = _http(rep.engine.base_url + "/metrics")[1].decode()
            m = parse_prometheus_text(text)
            out[rid] = tuple(sum(v for (name, _), v in m.items()
                                 if name == f"{series}_{part}")
                             for part in ("sum", "count"))
        return out

    def launches(self):
        return {rid: dict(s.get("launches") or {})
                for rid, s in self.stats().items()}

    def faults(self, planned=()):
        """Raise on any breaker strike, and on a respawn or a last_exit of
        a replica not in `planned`."""
        bad = {rid: (rep.breaker.failures, rep.respawns, rep.last_exit)
               for rid, rep in self.router.replicas.items()
               if rep.breaker.failures or (rid not in planned and (
                   rep.respawns or rep.last_exit))}
        if bad:
            raise AssertionError(f"unplanned process replica faults "
                                 f"(strikes, respawns, last exit): {bad}")

    def close(self):
        import shutil

        try:
            self.note_pids()
            self.router.stop()
        finally:
            if self.proxy is not None:
                self.proxy.close()
            self.store.close()
        left = sorted(p for p in self.pids if _alive(p))
        for p in left:
            os.kill(p, 9)
        shutil.rmtree(self.log_dir, ignore_errors=True)
        if left:
            raise AssertionError(f"children alive after router.stop(): "
                                 f"{left}")


def _child_decoding(rep, ticks=16):
    """Wait until the replica's child decodes a request and has ticked
    `ticks` more times: a process replica's greedy stream is silent until
    its end, so the child's /stats says where its requests are."""
    _until(lambda: rep.engine.stats().get("running", 0) > 0,
           f"{rep.rid} decoding")
    s0 = rep.engine.stats()["steps"]
    _until(lambda: rep.engine.stats()["steps"] >= s0 + ticks,
           f"{rep.rid} ticking")


def _launch_delta(before, after):
    """{rid: {kernel: launches}} after minus before, and the sum over the
    children (a child that is not in `before` counts from 0)."""
    per = {rid: {k: v - before.get(rid, {}).get(k, 0) for k, v in l.items()}
           for rid, l in after.items()}
    summed = {}
    for l in per.values():
        for k, v in l.items():
            summed[k] = summed.get(k, 0) + v
    return per, summed


def proc_fleet_parity_phase(torch, new_tokens=48):
    """The fleet's process replicas on the card in fp32 (TF32 off): two
    child processes from an identically seeded factory (proc_llama_2l:
    Llama-2-7B widths, 2 layers; 4 slots, 16-token blocks, 256-token
    chunks, 1024 context), each its own ServingEngine (CUDA graphs) behind
    a ServingServer, under a FleetRouter over a native.TCPStore whose
    children's traffic runs through a StorePartitionProxy. The parent
    computes generate()'s tokens for every prompt first, then frees the
    card. Scenarios, every request's tokens equal to generate()'s:
    parity over both children; a cancel of a stream while its child
    replays decode graphs (the child frees the slot and reservation,
    having generated fewer tokens than asked); a SIGKILL of a replica
    mid-decode (re-dispatched; the replica respawns under fence + 1,
    warming until its probe passes, last_exit -9); a SIGSTOP (the lease
    expires, a respawn after the grace; on SIGCONT the zombie exits 43
    and never beats its lease again); a store stall that heals inside
    the grace (leases expire and revive, no respawn, no fence bump); a
    migrate=1 drain mid-decode that moves at least one session; 1
    prefill + 1 decode (the roles set on the running fleet, as roles=
    assigns them at construction: the KV over /kv/export and /kv/ingest,
    no prefill token on the decode child); then a fleet of one with the
    autoscaler, which spawns a process replica from a spec under a burst
    and retires one through a migrating drain and remove_replica, whose
    child then has exited. Raises on a serving kernel no child launched,
    an unplanned strike, respawn or exit, an unfinished request, or a
    child alive after router.stop()."""
    import threading

    import numpy as np
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.observability.flight_recorder import \
        get_flight_recorder
    from paddle_tpu_torch.observability.sinks import parse_prometheus_text
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import FleetAutoscaler, ProcessReplicaSpec

    kw = dict(max_slots=4, block_size=16, prefill_chunk=256,
              max_model_len=1024)
    cfg = LlamaConfig.llama2_7b()
    cfg.num_layers = 2
    rng = np.random.default_rng(SEED + 40)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    long_new = 4 * new_tokens
    work = {
        "parity": [(toks(n), new_tokens) for n in (16, 40, 77, 150, 256,
                                                    300)],
        "kill": [(toks(n), long_new) for n in (40, 300, 77, 150)],
        "stop": [(toks(n), new_tokens) for n in (33, 120)],
        "heal": [(toks(n), new_tokens) for n in (50, 90)],
        # sessions that outlast a drain's KV transfer (0.5-0.9 s) on a
        # fast host too: 480 new tokens
        "migrate": [(toks(n), 10 * new_tokens) for n in (64, 128, 256, 192)],
        "disagg": [(toks(n), new_tokens) for n in (16, 32, 48, 64, 128,
                                                    256)],
        # a burst that holds the load past the autoscaler's `hi` for
        # several of its polls on a fast host too: 512 new tokens (at 48
        # the scale-up was missed once; at 192 the load it saw peaked at
        # 0.75, just `hi`, once in three runs: the serial submits over
        # HTTP keep pace with short requests' ends)
        "scale": [(toks(n), 512) for n in (30, 60, 90, 120, 150, 180,
                                           210, 240)],
        "scale2": [(toks(n), new_tokens) for n in (50, 70, 90, 110)],
        "after": [(toks(n), new_tokens) for n in (45,)],
    }
    cancel_prompt = toks(64)
    t0 = time.perf_counter()
    ref = proc_llama_2l()
    want = {}
    for reqs in work.values():
        for p, n in reqs:
            want[(tuple(p), n)] = _greedy(torch, ref, p, n)
    ref_s = time.perf_counter() - t0
    del ref
    release(torch)

    def serve(key, router):
        freqs = [router.submit(p, max_new_tokens=n) for p, n in work[key]]
        _settle(freqs)
        check(freqs, key)
        return freqs

    def check(freqs, name):
        for f in freqs:
            w = want[(tuple(f.prompt), f.max_new_tokens)]
            if f.output_tokens != w or f.finish_reason != "length":
                raise AssertionError(
                    f"proc fleet {name}: request {f.request_id} "
                    f"({len(f.prompt)} tokens) gave {f.output_tokens[:8]}"
                    f"..., generate() {w[:8]}... ({f.finish_reason})")

    rec = get_flight_recorder()
    prev_dir = flags.get_flag("metrics_dir")
    out = {"phase": "proc_fleet_parity", "layers": cfg.num_layers,
           "new_tokens": new_tokens, "reference_generate_s": ref_s}
    fa = _ProcFleet(2, "chip_smoke:proc_llama_2l", kw, tag="parity",
                    proxy=True)
    flags.set_flags({"metrics_dir": fa.log_dir})   # respawn dumps
    try:
        out["ready_s"] = fa.ready(300)
        router = fa.router
        out["spawns"] = {rid: rep.spawns[-1]
                         for rid, rep in router.replicas.items()}
        l0 = fa.launches()
        freqs = serve("parity", router)
        per, summed = _launch_delta(l0, fa.launches())
        idle = [k for k in SERVING if not all(per[r].get(k) for r in per)]
        if idle:
            raise AssertionError(f"a child did not launch {idle}: {per}")
        out["parity"] = {
            "requests": len(freqs),
            "homes": [f.attempts[-1].replica.rid for f in freqs],
            "launches_by_child": per, "launches_summed": summed}

        # cancel while the child replays decode graphs
        r0 = router.replicas["replica-0"]
        url = r0.engine.base_url

        def metric(series, **labels):
            text = _http(url + "/metrics")[1].decode()
            return sum(v for (name, lab), v in parse_prometheus_text(
                text).items() if name == series
                and all((k, v2) in lab for k, v2 in labels.items()))

        g0 = metric("serving_generated_tokens_total")
        shed0 = metric("serving_shed_requests_total", reason="disconnect")
        req = r0.engine.submit(cancel_prompt, max_new_tokens=900)
        _child_decoding(r0)
        t_c = time.monotonic()
        r0.engine.cancel(req)
        if not req.wait(30):
            raise AssertionError("the cancelled stream did not end")

        def freed():
            s = r0.engine.stats()
            return not (s["running"] or s["waiting"] or s["prefilling"]
                        or s["reserved_blocks"])

        _until(freed, "the child freeing the cancelled slot", 30)
        freed_s = time.monotonic() - t_c
        made = metric("serving_generated_tokens_total") - g0
        shed = metric("serving_shed_requests_total",
                      reason="disconnect") - shed0
        if shed != 1 or made >= 900:
            raise AssertionError(f"the cancel: {shed} disconnects shed, "
                                 f"{made} tokens generated")
        out["cancel"] = {"tokens_flushed_by_child": made,
                         "slot_freed_s": freed_s,
                         "finish_reason": req.finish_reason}

        # SIGKILL mid-decode
        freqs = [router.submit(p, max_new_tokens=n)
                 for p, n in work["kill"]]
        victim = freqs[0].attempts[0].replica
        doomed = [f for f in freqs if f.attempts[0].replica is victim]
        _child_decoding(victim)
        vinc, vpid = victim.incarnation, victim.pid
        warming, sampled = [], threading.Event()

        def sample():
            # when the victim was warming: from its death to its probe
            while not sampled.is_set():
                if victim.warming():
                    warming.append(time.monotonic() - t_k)
                time.sleep(0.002)

        t_k = time.monotonic()
        chaos.kill_process(vpid)
        threading.Thread(target=sample, daemon=True).start()
        _settle(freqs)
        check(freqs, "kill")
        _until(lambda: (victim.incarnation > vinc and not victim.warming()
                        and not victim.dead(router.lease_ttl_s)),
               f"{victim.rid} respawned", 300)
        respawn_s = time.monotonic() - t_k
        sampled.set()
        fence = fa.store.add(f"{fa.prefix}/fence/{victim.rid}", 0)
        moved = sum(f.redispatches for f in freqs)
        le = victim.last_exit
        if (moved < len(doomed) or victim.incarnation != vinc + 1
                or fence != vinc + 1 or not warming
                or le.get("exit_code") != -9 or le.get("reason") != "exit"
                or _alive(vpid)):
            raise AssertionError(
                f"kill: {moved} re-dispatched of {len(doomed)}, "
                f"incarnation {vinc} -> {victim.incarnation}, fence "
                f"{fence}, warming seen {bool(warming)}, last_exit {le}")
        fa.note_pids()
        out["kill"] = {"replica": victim.rid, "requests": len(freqs),
                       "redispatched": moved, "respawn_s": respawn_s,
                       "warming_for_s": max(warming) - min(warming),
                       "incarnation": [vinc, victim.incarnation],
                       "last_exit": le, "spawn": victim.spawns[-1]}

        # SIGSTOP: lease death, respawn, then the zombie fences itself
        z = router.replicas["replica-1" if victim.rid == "replica-0"
                            else "replica-0"]
        zpid, zinc = z.pid, z.incarnation
        hb_key = f"{fa.prefix}/hb/{z.rid}@{zinc}"
        t_s = time.monotonic()
        chaos.hang_process(zpid)
        _until(lambda: (z.incarnation > zinc and not z.warming()
                        and not z.dead(router.lease_ttl_s)),
               f"{z.rid} replaced", 300)
        replaced_s = time.monotonic() - t_s
        if z.last_exit.get("reason") != "lease_expired" \
                or z.last_exit.get("pid") != zpid or not _alive(zpid):
            raise AssertionError(f"stop: last_exit {z.last_exit}")
        fa.note_pids()
        serve("stop", router)
        hb = fa.store.get(hb_key, blocking=False)
        n_ev = len(rec.events())
        chaos.resume_process(zpid)
        _until(lambda: (z.last_exit or {}).get("fenced_pid") == zpid,
               "the zombie fencing itself", 60)
        fenced = [e for e in rec.events()[n_ev:]
                  if e["kind"] == "fleet_replica_fenced"
                  and e.get("pid") == zpid]
        beat = fa.store.get(hb_key, blocking=False) != hb
        if (not fenced or fenced[0].get("exit_code") != 43 or beat
                or _alive(zpid)):
            raise AssertionError(f"stop: zombie events {fenced}, lease "
                                 f"beaten after waking {beat}")
        out["sigstop"] = {"replica": z.rid, "replaced_s": replaced_s,
                          "incarnation": [zinc, z.incarnation],
                          "zombie_exit_code": fenced[0]["exit_code"],
                          "spawn": z.spawns[-1]}

        # a store stall that heals inside the grace
        before = {rid: (rep.incarnation, rep.respawns, rep.pid,
                        fa.store.add(f"{fa.prefix}/fence/{rid}", 0))
                  for rid, rep in router.replicas.items()}
        n_ev = len(rec.events())
        fa.proxy.partition(router.lease_ttl_s + 0.3, mode="stall")
        _until(lambda: not fa.proxy.partitioned, "the heal", 30)

        def events():
            return [e["kind"] for e in rec.events()[n_ev:]]

        # both leases revive within a few heartbeats of the heal
        _until(lambda: events().count("fleet_replica_lease_revived") >= 2,
               "the leases reviving", 10)
        kinds = events()
        after = {rid: (rep.incarnation, rep.respawns, rep.pid,
                       fa.store.add(f"{fa.prefix}/fence/{rid}", 0))
                 for rid, rep in router.replicas.items()}
        if after != before or "fleet_replica_lease_revived" not in kinds \
                or "fleet_replica_lease_expired" not in kinds:
            raise AssertionError(f"heal: {before} -> {after}, events "
                                 f"{kinds}")
        serve("heal", router)
        out["healed_partition"] = {
            "stall_s": router.lease_ttl_s + 0.3,
            "expired": kinds.count("fleet_replica_lease_expired"),
            "revived": kinds.count("fleet_replica_lease_revived")}

        # a migrating drain mid-decode
        transfers = []
        stream = router._stream_kv

        def timed_stream(freq, src, dst, kind):
            t = time.perf_counter()
            st = stream(freq, src, dst, kind)
            if st is not None:
                transfers.append({"kind": kind, "bytes": st["bytes"],
                                  "blocks": st["imported"] + st["dedup"],
                                  "seconds": time.perf_counter() - t,
                                  "export_s": st["export_s"],
                                  "ingest_s": st["ingest_s"]})
            return st

        router._stream_kv = timed_stream
        freqs = [router.submit(p, max_new_tokens=n)
                 for p, n in work["migrate"]]
        on0 = [f for f in freqs if f.attempts[0].replica.rid == "replica-0"]
        _child_decoding(router.replicas["replica-0"])
        router.drain("replica-0", migrate=True)
        _settle(freqs)
        check(freqs, "migrate")
        migs = [f for f in freqs if f.migrations]
        if not migs:
            raise AssertionError(f"migrate: none of {len(on0)} moved")
        router.resume("replica-0")
        out["migrate"] = {
            "on_replica_0": len(on0), "migrated": len(migs),
            "prompt_and_matched": [(len(f.prompt),
                                    f.attempts[-1].req.prefix_matched)
                                   for f in migs],
            "kv": [t for t in transfers if t["kind"] == "migrate"]}

        # 1 prefill + 1 decode across the processes
        router.replicas["replica-0"].role = "prefill"
        router.replicas["replica-1"].role = "decode"
        pf0 = {rid: s["prefill_tokens"] for rid, s in fa.stats().items()}
        n_t = len(transfers)
        freqs = serve("disagg", router)
        pf = {rid: s["prefill_tokens"] - pf0[rid]
              for rid, s in fa.stats().items()}
        homes = [f.attempts[-1].replica.rid for f in freqs]
        if pf["replica-1"] or any(h != "replica-1" for h in homes) \
                or any(f.kv_streamed is None for f in freqs):
            raise AssertionError(f"disaggregated: prefill tokens {pf}, "
                                 f"homes {homes}")
        out["disaggregated"] = {"prefill_tokens_by_replica": pf,
                                "kv": transfers[n_t:]}
        fa.faults(planned=(victim.rid, z.rid))
        out["graphs"] = {rid: s["graphs"] for rid, s in fa.stats().items()}
    except BaseException:
        fa.close()
        flags.set_flags({"metrics_dir": prev_dir})
        raise
    fa.close()

    # the autoscaler spawns a process replica and retires one
    fb = _ProcFleet(1, "chip_smoke:proc_llama_2l", kw, tag="scale")
    flags.set_flags({"metrics_dir": fb.log_dir})
    try:
        fb.ready(300)
        router = fb.router
        scaler = FleetAutoscaler(
            router, lambda: ProcessReplicaSpec(fb.addr, **fb.spec_kwargs),
            min_replicas=1, max_replicas=2, hi=0.75, lo=0.25,
            cooldown_s=0.5, slots_per_replica=kw["max_slots"])
        router.attach_autoscaler(scaler)
        t_b = time.monotonic()
        freqs = [router.submit(p, max_new_tokens=n)
                 for p, n in work["scale"]]
        _until(lambda: len(router.replicas) == 2, "the scale-up")
        new = [rid for rid in router.replicas if rid != "replica-0"][0]
        pids = {"replica-0": router.replicas["replica-0"].children()}
        fb.ready(300)
        up_s = time.monotonic() - t_b
        pids[new] = router.replicas[new].children()
        spawn_new = router.replicas[new].spawns[-1]
        freqs += [router.submit(p, max_new_tokens=n)
                  for p, n in work["scale2"]]
        _settle(freqs)
        check(freqs, "autoscaler")
        _until(lambda: len(router.replicas) == 1
               and scaler._retiring is None, "the scale-down")
        down = [e["replica"] for e in scaler.events if e["dir"] == "down"]
        left = [p for p in pids[down[0]] if _alive(p)]
        if left or len(down) != 1:
            raise AssertionError(f"retired {down}; its children {left} "
                                 f"still run")
        after = serve("after", router)
        fb.faults()
        out["autoscaler"] = {
            "events": [(e["dir"], e["replica"], e["utilization"])
                       for e in scaler.events],
            "spawned": new, "retired": down, "scale_up_to_ready_s": up_s,
            "served_by_new": sum(f.attempts[-1].replica.rid == new
                                 for f in freqs + after),
            "spawn": spawn_new}
    except BaseException:
        fb.close()
        raise
    finally:
        flags.set_flags({"metrics_dir": prev_dir})
    fb.close()
    return out


def proc_fleet_slice_phase(torch, threads=None, new_tokens=64):
    """Llama-2-7B replicas at full width in bf16, each a child process of
    its own (proc_llama_7b; the serving cell's engine: 8 slots, 16-token
    blocks, 256-token chunks, 2048 context) under a FleetRouter, fresh
    children an arm: one replica and two on fleet_slice's traffic (slice
    1's 10 requests and the 24-prompt burst), 1 prefill + 1 decode on the
    burst, and on the two-replica fleet after its runs a SIGKILL of
    replica-0 a third into another burst (every request finishes, replica-0
    comes back). Each child first serves one short request of its own
    (its seconds reported: a child's first request loads the kernels'
    libraries and sets up cuBLAS), then the measured runs. For each arm:
    tokens/s and mean TTFT, each child's mean time an output token (its
    /metrics), spawn-to-ready seconds by part (the child's import,
    weights, engine with its graphs; the ready line; the probe), respawn
    seconds, every KV transfer's bytes and seconds, each child's peak and
    reserved memory (its /stats) and nvidia-smi's compute apps, graph
    replays by child, and each serving kernel's launches summed over the
    children (read from each child's /stats before and after a run). `threads`, fleet_slice's thread
    replicas of the same run, is copied in for comparison. Raises on a
    serving kernel no child launched, an unplanned strike, respawn or
    exit, a request without its tokens, or a child alive after
    router.stop()."""
    import numpy as np
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.resilience import chaos

    cfg = LlamaConfig.llama2_7b()
    cfg.num_layers = CUT_LAYERS
    kw = dict(max_slots=8, block_size=16, prefill_chunk=256,
              max_model_len=2048)
    prev_dir = flags.get_flag("metrics_dir")
    slice10, burst = _fleet_traffic(cfg.vocab_size, new_tokens)
    burst_k = [_burst(np.random.default_rng(SEED + 33), cfg.vocab_size)]
    warm = [[int(t) for t in np.random.default_rng(SEED + 34 + i).integers(
        0, cfg.vocab_size, 16)] for i in range(2)]

    def serve(router, trace):
        freqs = []
        for wave in trace:
            mine = [router.submit(p, max_new_tokens=m) for p, m in wave]
            freqs += mine
            _settle(mine)
        return freqs

    def measured(freqs, wall):
        short = [f.request_id for f in freqs
                 if len(f.output_tokens) != f.max_new_tokens
                 or not all(0 <= t < cfg.vocab_size
                            for t in f.output_tokens)]
        if short:
            raise AssertionError(f"requests without their tokens {short}")
        gen = sum(len(f.output_tokens) for f in freqs)
        return {"requests": len(freqs), "generated_tokens": gen,
                "wall_s": wall, "tokens_per_s": gen / wall,
                "mean_ttft_s": statistics.mean(
                    f.first_token_ts - f.submit_ts for f in freqs)}

    def run_arm(n, traces, roles=None, kill=None):
        release(torch)
        fleet = _ProcFleet(n, "chip_smoke:proc_llama_7b", kw,
                           tag=f"slice{n}" + ("_disagg" if roles else ""),
                           roles=roles, warmup_s=180.0)
        flags.set_flags({"metrics_dir": fleet.log_dir})   # respawn dumps
        try:
            ready_s = fleet.ready(600)
            router = fleet.router
            spawns = {rid: rep.spawns[-1]
                      for rid, rep in router.replicas.items()}
            # each child's first request pays its one-time costs (the
            # kernels' libraries loaded, cuBLAS set up): one short request
            # a child before the measured runs, its seconds reported
            first = {}
            for i, (rid, rep) in enumerate(router.replicas.items()):
                t = time.perf_counter()
                req = rep.engine.submit(warm[i], max_new_tokens=8)
                if not req.wait(120) or req.finish_reason != "length":
                    raise AssertionError(f"{rid}'s warm-up request: "
                                         f"{req.finish_reason}")
                first[rid] = time.perf_counter() - t
            transfers = []
            stream = router._stream_kv

            def timed_stream(freq, src, dst, kind):
                t = time.perf_counter()
                st = stream(freq, src, dst, kind)
                if st is not None:
                    transfers.append({
                        "kind": kind,
                        "blocks": st["imported"] + st["dedup"],
                        "bytes": st["bytes"],
                        "seconds": time.perf_counter() - t,
                        "export_s": st["export_s"],
                        "ingest_s": st["ingest_s"]})
                return st

            router._stream_kv = timed_stream
            runs = []
            tokens = []
            for trace in traces:
                l0 = fleet.launches()
                pf0 = {rid: s["prefill_tokens"]
                       for rid, s in fleet.stats().items()}
                tp0 = fleet.histograms("serving_tpot_seconds")
                t1 = time.perf_counter()
                freqs = serve(router, trace)
                wall = time.perf_counter() - t1
                tp = fleet.histograms("serving_tpot_seconds")
                st = fleet.stats()
                per, summed = _launch_delta(l0, {
                    rid: s["launches"] for rid, s in st.items()})
                if any(not summed.get(k) for k in SERVING):
                    raise AssertionError(f"a serving kernel no child "
                                         f"launched: {summed}")
                runs.append({**measured(freqs, wall),
                             "prefill_tokens": {
                                 rid: s["prefill_tokens"] - pf0[rid]
                                 for rid, s in st.items()},
                             "homes": {rid: sum(
                                 f.attempts[-1].replica.rid == rid
                                 for f in freqs) for rid in st},
                             # a child's mean seconds an output token
                             "child_tpot_s": {
                                 rid: (tp[rid][0] - tp0[rid][0])
                                 / max(1, tp[rid][1] - tp0[rid][1])
                                 for rid in tp},
                             "launches_summed": summed,
                             "launches_by_child": per})
                tokens.append({i: f.output_tokens
                               for i, f in enumerate(freqs)})
            st = fleet.stats()
            smi = _compute_apps()
            out = {"replicas": n, "roles": roles or "symmetric",
                   "ready_s": ready_s, "spawns": spawns,
                   "first_request_s": first, "runs": runs,
                   "kv_transfers": transfers,
                   "memory": {rid: s["memory"]["device"]
                              for rid, s in st.items()},
                   "nvidia_smi_compute_apps": smi,
                   "child_pids": {rid: rep.pid for rid, rep in
                                  router.replicas.items()},
                   "graphs": {rid: s["graphs"] for rid, s in st.items()}}
            for rid, g in out["graphs"].items():
                for kind, ticks in g["ticks"].items():
                    if g["replays"][kind] != ticks:
                        raise AssertionError(f"{rid}: {kind} replays "
                                             f"{g['replays']} ticks "
                                             f"{g['ticks']}")
            fleet.faults()
            if kill is not None:
                t1 = time.perf_counter()
                freqs = [router.submit(p, max_new_tokens=m)
                         for p, m in kill[0]]
                _until(lambda: sum(f.done for f in freqs)
                       >= len(freqs) / 3, "a third done", 600)
                victim = router.replicas["replica-0"]
                vinc, vpid = victim.incarnation, victim.pid
                t_k = time.monotonic()
                chaos.kill_process(vpid)
                _settle(freqs)
                wall = time.perf_counter() - t1
                _until(lambda: (victim.incarnation > vinc
                                and not victim.warming()
                                and not victim.dead(router.lease_ttl_s)),
                       "replica-0 back", 600)
                respawn_s = time.monotonic() - t_k
                le = victim.last_exit
                if le.get("exit_code") != -9 or _alive(vpid):
                    raise AssertionError(f"kill: last_exit {le}")
                fleet.note_pids()
                fleet.faults(planned=("replica-0",))
                out["kill"] = {**measured(freqs, wall),
                               "redispatched": sum(f.redispatches
                                                   for f in freqs),
                               "respawn_s": respawn_s, "last_exit": le,
                               "spawn": victim.spawns[-1]}
        except BaseException:
            fleet.close()
            raise
        finally:
            flags.set_flags({"metrics_dir": prev_dir})
        fleet.close()
        return out, tokens

    t0 = time.perf_counter()
    one, one_tokens = run_arm(1, [slice10, burst])
    two, two_tokens = run_arm(2, [slice10, burst], kill=burst_k)
    dis, _ = run_arm(2, [burst], roles="prefill:1,decode:1")
    if dis["runs"][0]["prefill_tokens"]["replica-1"]:
        raise AssertionError(f"{dis['runs'][0]['prefill_tokens']} prefill "
                             f"tokens on the decode replica")
    agree = {trace: sum(a[k] == b[k] for k in a) / len(a)
             for trace, a, b in zip(("slice", "burst"), one_tokens,
                                    two_tokens)}
    return {"phase": "proc_fleet_slice", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "dtype": "torch.bfloat16",
            "engine_kw": kw, "kernels": list(SERVING),
            "arms": {"one": one, "two": two, "disaggregated": dis},
            "same_tokens_one_vs_two": agree,
            "phase_s": time.perf_counter() - t0,
            "threads_same_run": threads}


# ------------------------------------------------------------ training path
def _gpt_step(torch, model, opt, device, amp_on):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep

    def loss_fn(ids):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    return TrainStep(model, loss_fn, opt, device=device)


def _parity(torch, phase, models, make_loss, batch, steps, lr):
    """`steps` fp32 TrainSteps (AdamW, global-norm clip at 1.0) of each of
    models = {"cuda": ..., "cpu": ...}, holding the same weights, on the
    same batch; losses and parameters held to the bounds below. Adam divides
    each first moment by the root of the second, so its first step moves
    every element by lr in the sign of its gradient, whatever the
    gradient's size; an element whose gradient sits at fp32 rounding noise
    can step the other way on the other device, and so can one whose
    gradients nearly cancel later. Two such runs end at most 2 lr per step
    apart, hence every element within 2 lr * steps; the mean difference
    must stay under 1e-2 lr, which rounding alone meets. Losses must agree
    to 1e-4 relative."""
    import numpy as np
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["cuda"].state_dict().items()})
    losses = {}
    for device, model in models.items():
        opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = TrainStep(model, make_loss(model), opt, device=device)
        losses[device] = [step(*batch) for _ in range(steps)]
    got = [float(x) for x in losses["cuda"]]
    want = [float(x) for x in losses["cpu"]]
    rel = max(abs(g / w - 1) for g, w in zip(got, want))
    cpu = dict(models["cpu"].named_parameters())
    worst, total, count = 0.0, 0.0, 0
    for name, p in models["cuda"].named_parameters():
        diff = (p.detach().cpu() - cpu[name].detach()).abs()
        worst = max(worst, float(diff.max()))
        total += float(diff.sum())
        count += diff.numel()
    bounds = {"loss_rel": 1e-4, "param_max": 2 * lr * steps,
              "param_mean": 1e-2 * lr}
    row = {"phase": phase, "lr": lr, "loss_card": got, "loss_cpu": want,
           "max_rel_loss_diff": rel, "max_param_diff": worst,
           "mean_param_diff": total / count, "bounds": bounds}
    if not all(np.isfinite(got)) or rel > bounds["loss_rel"] \
            or worst > bounds["param_max"] \
            or total / count > bounds["param_mean"]:
        raise AssertionError(f"card and CPU training differ: {row}")
    return row


def train_parity_phase(torch, steps=3, lr=1e-5, batch=2, seq=128):
    """Three fp32 TrainSteps of a CPU_PARITY_LAYERS-deep full-width GPT on
    the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch (`_parity`'s bounds). Parameters: Adam divides
    each first moment by the root of the second, so its first step moves
    every element by lr in the sign of its gradient, whatever the
    gradient's size; an element whose gradient sits at fp32 rounding noise
    can step the other way on the other device, and so can one whose
    gradients nearly cancel later. Two such runs end at most 2 lr per step
    apart, hence every element within 2 lr * steps; the mean difference
    must stay under 1e-2 lr (1e-7, some fifty fp32 roundings of a weight
    of 0.02), which rounding alone meets. Elements that step apart also
    move the loss: at lr 1e-4 the third loss differed by 3.9e-4 relative
    (the second by 3.7e-6), so the phase runs at lr 1e-5, where that
    effect shrinks with the steps."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_layers = CPU_PARITY_LAYERS
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (batch, seq))
    models = {"cuda": GPTForCausalLM(cfg, device="cuda", seed=SEED),
              "cpu": GPTForCausalLM(cfg, device="cpu", seed=SEED)}

    def make_loss(model):
        return lambda x: model(x, labels=x)

    row = _parity(torch, "train_parity", models, make_loss, (ids,), steps,
                  lr)
    return {**row, "model": "GPT", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "batch": [batch, seq]}


def packed_parity_phase(torch, steps=3, lr=1e-5, seq=256):
    """The packed Llama's `_parity`: Llama-2-7B widths, CPU_PARITY_LAYERS
    deep, fp32, one
    packed row of `seq` tokens holding four documents and a padding tail
    (segmented flash, per-token RoPE and RMSNorm backward on the card, their
    plain versions on the CPU), three TrainSteps at lr 1e-5 as the GPT
    phase runs."""
    import numpy as np
    from paddle_tpu_torch.io import pack_examples
    from paddle_tpu_torch.tools.profile_training import packed_llama_config
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = packed_llama_config(layers=CPU_PARITY_LAYERS)
    rng = np.random.default_rng(SEED + 3)
    docs = [rng.integers(0, cfg.vocab_size, n) for n in (70, 50, 90, 30)]
    ids, seg, labels = pack_examples(docs, seq)
    models = {"cuda": LlamaForCausalLM(cfg, device="cuda", seed=SEED),
              "cpu": LlamaForCausalLM(cfg, device="cpu", seed=SEED)}

    def make_loss(model):
        return lambda x, s, y: model(x, labels=y, segments=s)

    row = _parity(torch, "train_parity", models, make_loss,
                  (ids, seg, labels), steps, lr)
    return {**row, "model": "Llama packed", "layers": cfg.num_layers,
            "hidden": cfg.hidden_size, "batch": list(ids.shape),
            "documents": [len(d) for d in docs]}


def train_slice_phase(torch, reset, counts, batch=4, seq=2048, steps=3,
                      lr=1e-4):
    """Main path 2: GPT-3 1.3B, amp O1 (bf16 matmuls and attention, fp32
    parameters), AdamW as bench.py drives it, through TrainStep; one
    warm-up step, then `steps` timed steps on the same batch."""
    import math

    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    resident = torch.cuda.memory_allocated()   # left by earlier phases
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, seed=SEED)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01)
    step = _gpt_step(torch, model, opt, None, amp_on=True)
    ids = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (batch, seq))).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != gpt_numel(cfg):
        raise AssertionError(f"{n_params} parameters, {gpt_numel(cfg)} "
                             f"expected")
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = time.perf_counter()
    losses = [step(ids)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    peak_first = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = counts()
    losses = [float(x) for x in losses]
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"GPT-3 1.3B losses {losses}: the first should "
                             f"be within 0.5 of ln(vocab) = "
                             f"{math.log(cfg.vocab_size):.3f} and the last "
                             f"below it")
    groups = len(opt._groups)
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    want = {"flash_fwd": cfg.num_layers, "flash_dq": cfg.num_layers,
            "flash_dkv": cfg.num_layers, "adamw": groups}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    step_s = wall / steps
    return {
        "phase": "train_slice", "model": "GPT-3 1.3B", "params": n_params,
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "amp": "O1 bfloat16", "batch": [batch, seq], "init_s": init_s,
        "warmup_step_s": warm_s, "losses": losses, "step_s": step_s,
        "tokens_per_s": batch * seq / step_s,
        "peak_mem_bytes": max(peak_first, torch.cuda.max_memory_allocated()),
        "peak_mem_bytes_timed_steps": torch.cuda.max_memory_allocated(),
        "resident_bytes_before": resident,
        "adamw_groups": groups, "launches": launches,
        "launches_per_step": per_step,
    }


def _o2_step(torch, model, opt, device, **kw):
    """TrainStep under amp O2 for a model and optimizer that `decorate`
    has turned bf16 with fp32 masters; loss_fn(ids, poison) multiplies the
    loss by the 0-d `poison` (1, or NaN for a poisoned step)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep

    amp.decorate(model, opt, level="O2", dtype="bfloat16")

    def loss_fn(ids, poison):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return model(ids, labels=ids) * poison

    return TrainStep(model, loss_fn, opt, device=device, **kw)


def train_o2_parity_phase(torch, steps=3, lr=1e-5, batch=2, seq=128):
    """Three amp O2 TrainSteps (bf16 parameters, fp32 masters through the
    kernel's master form, global-norm clip) of a CPU_PARITY_LAYERS-deep
    GPT at GPT-3
    1.3B's width on the card and on the CPU (plain versions), from the
    same weights and batch. Losses to 1e-3 relative, the bound the CPU O1
    and O2 parity tests hold against the reference (the matmuls, attention
    and the residual stream round to bf16 on both sides, in another order
    here). Masters: every element within 2.02 lr a step (Adam moves an
    element by |m_hat| / sqrt(v_hat) lr a step, at most 1.0036 lr in the
    first three at beta1 0.9 and beta2 0.999, and an element whose bf16
    gradients round to opposite signs near zero can step the other way on
    the other device), the mean difference under 0.02 lr (the CPU O2
    test's bound). Every parameter is bf16 and equals its master cast to
    bf16 on the card."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.gpt3_1p3b()
    cfg.num_layers = CPU_PARITY_LAYERS
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                               (batch, seq))
    models = {"cuda": GPTForCausalLM(cfg, device="cuda", seed=SEED),
              "cpu": GPTForCausalLM(cfg, device="cpu", seed=SEED)}
    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["cuda"].state_dict().items()})
    losses, opts, secs = {}, {}, {}
    one = np.float32(1.0)
    for device, model in models.items():
        opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = _o2_step(torch, model, opt, device)
        t0 = time.perf_counter()
        losses[device] = [float(step(ids, one)) for _ in range(steps)]
        secs[device] = time.perf_counter() - t0
        opts[device] = opt
    got, want = losses["cuda"], losses["cpu"]
    rel = max(abs(g / w - 1) for g, w in zip(got, want))
    worst, total, count = 0.0, 0.0, 0
    cpu_params = list(models["cpu"].parameters())
    for p, q in zip(models["cuda"].parameters(), cpu_params):
        sc = opts["cuda"]._get_state(p)
        if p.dtype != torch.bfloat16 or \
                sc["master"].dtype != torch.float32 or \
                not torch.equal(p.detach(), sc["master"].to(torch.bfloat16)):
            raise AssertionError("O2: a parameter is not the bf16 copy of "
                                 "its fp32 master")
        diff = (sc["master"].cpu() - opts["cpu"]._get_state(q)["master"]
                ).abs()
        worst = max(worst, float(diff.max()))
        total += float(diff.sum())
        count += diff.numel()
    bounds = {"loss_rel": 1e-3, "master_max": 2.02 * lr * steps,
              "master_mean": 0.02 * lr}
    row = {"phase": "train_o2_parity", "model": "GPT", "amp": "O2 bfloat16",
           "layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "batch": [batch, seq], "lr": lr, "loss_card": got,
           "loss_cpu": want, "max_rel_loss_diff": rel,
           "max_master_diff": worst, "mean_master_diff": total / count,
           "bounds": bounds, "seconds": secs}
    if not all(np.isfinite(got)) or rel > bounds["loss_rel"] \
            or worst > bounds["master_max"] \
            or total / count > bounds["master_mean"]:
        raise AssertionError(f"card and CPU O2 training differ: {row}")
    return row


def train_o2_slice_phase(torch, reset, counts, o1_step_s, batch=4,
                         seq=2048, steps=3, lr=1e-4):
    """Main path 2 under amp O2: GPT-3 1.3B decorated to bf16 with fp32
    masters, auto_cast O2, global-norm clip 1.0, AdamW over
    LinearWarmup(CosineAnnealingDecay), TrainStep(nan_guard=True,
    telemetry=True) with FLAGS_metrics on (a temporary metrics dir), on
    the O1 slice's seeded batch: one warm-up step, `steps` timed steps,
    one step whose loss is NaN, one clean step. Checks: every parameter
    bf16 and every master fp32; the three flash kernels and the AdamW
    master form launched (and the fp32 form not); the poisoned step
    skipped (last_skipped, skipped_steps 1) with the flat buffers' bits
    (parameters, masters, moments) and the beta powers unchanged across
    it; one step record a step in the JSONL log, skipped only on the
    poisoned one, MFU from the H100 peak; a nan_guard flight dump. Then
    GradScaler drives two eager steps of the same model: the first's loss
    is multiplied by inf, so its scaled gradients overflow (bf16 shares
    fp32's exponent range: at any finite scale this model's scaled
    gradients stay finite, so the overflow comes from the loss) and
    found-inf skips it and halves the scale; the second is clean and
    updates."""
    import glob
    import math
    import tempfile

    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lrs

    cfg = GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    resident = torch.cuda.memory_allocated()
    metrics_dir = tempfile.TemporaryDirectory()
    tobs.reset_all()
    flags.set_flags({"metrics": "on", "metrics_dir": metrics_dir.name})
    try:
        t0 = time.perf_counter()
        model = GPTForCausalLM(cfg, seed=SEED)
        sched = lrs.LinearWarmup(lrs.CosineAnnealingDecay(lr, T_max=1000),
                                 warmup_steps=2, start_lr=lr / 10,
                                 end_lr=lr)
        opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        step = _o2_step(torch, model, opt, None, nan_guard=True,
                        telemetry=True)
        ids = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
            0, cfg.vocab_size, (batch, seq))).cuda()
        one = torch.ones((), device="cuda")
        nan = torch.full((), float("nan"), device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        if {p.dtype for p in model.parameters()} != {torch.bfloat16}:
            raise AssertionError("O2: parameters are not all bf16")
        torch.cuda.reset_peak_memory_stats()
        reset()
        t1 = time.perf_counter()
        losses = [step(ids, one)]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t1
        masters = {g.master.dtype for g in opt._groups}
        if masters != {torch.float32} or \
                any(g.p.dtype != torch.bfloat16 for g in opt._groups):
            raise AssertionError(f"O2: masters {masters}, parameters "
                                 f"{[g.p.dtype for g in opt._groups]}")
        t2 = time.perf_counter()
        for _ in range(steps):
            losses.append(step(ids, one))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t2
        peak = torch.cuda.max_memory_allocated()
        # the poisoned step: bits of every flat buffer and the beta powers
        bufs = [t for g in opt._groups for t in (g.p, g.master, g.m, g.v)]
        pows = [(st["beta1_pow"], st["beta2_pow"])
                for st in opt._state.values()]
        before = bit_sums(torch, bufs)
        losses.append(step(ids, nan))
        if not step.last_skipped or step.skipped_steps != 1:
            raise AssertionError(f"the poisoned step was not skipped "
                                 f"(last_skipped {step.last_skipped}, "
                                 f"skipped_steps {step.skipped_steps})")
        if bit_sums(torch, bufs) != before or pows != [
                (st["beta1_pow"], st["beta2_pow"])
                for st in opt._state.values()]:
            raise AssertionError("the skipped step changed the parameters, "
                                 "masters, moments or beta powers")
        losses.append(step(ids, one))
        if step.last_skipped or step.skipped_steps != 1:
            raise AssertionError("the clean step after the poisoned one "
                                 "was skipped")
        torch.cuda.synchronize()
        launches = counts()
        tele = tobs.telemetry.get_telemetry()
        tele.finalize()
        with open(os.path.join(metrics_dir.name, "events.jsonl")) as f:
            records = [r for r in (json.loads(x) for x in f)
                       if r["kind"] == "step"]
        dumps = [json.load(open(p)) for p in glob.glob(
            os.path.join(metrics_dir.name, "flight", "*.json"))]
    finally:
        flags.set_flags({"metrics": "off", "metrics_dir": ""})
        tobs.reset_all()
        metrics_dir.cleanup()
    losses = [float(x) for x in losses]
    n_calls = steps + 3
    per_step = {k: v / n_calls for k, v in launches.items()}
    want = {"flash_fwd": cfg.num_layers, "flash_dq": cfg.num_layers,
            "flash_dkv": cfg.num_layers, "adamw_master": len(opt._groups),
            "adamw": 0}
    if per_step != want:
        raise AssertionError(f"O2 launches per step {per_step}, expected "
                             f"{want}")
    clean = losses[:steps + 1] + losses[-1:]
    if not all(math.isfinite(x) for x in clean) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 \
            or not losses[steps] < losses[0] or not math.isnan(losses[-2]):
        raise AssertionError(f"GPT-3 1.3B O2 losses {losses}: the first "
                             f"should be within 0.5 of ln(vocab), the last "
                             f"timed one below it, the poisoned one NaN")
    if [r["step"] for r in records] != list(range(n_calls)) or \
            [r["skipped"] for r in records] != [i == steps + 1 for i in
                                                range(n_calls)]:
        raise AssertionError(f"step records: "
                             f"{[(r['step'], r['skipped']) for r in records]}")
    peak_flops = tobs.telemetry.H100_BF16_PEAK_FLOPS
    for r in records:
        want_mfu = 6.0 * n_params * batch * seq / r["step_wall_s"] / \
            peak_flops
        # the record rounds mfu and step_wall_s to 6 decimals
        if "mfu" not in r or abs(r["mfu"] - want_mfu) > 1e-3 * want_mfu \
                + 1e-6:
            raise AssertionError(f"step record's mfu {r.get('mfu')} is not "
                                 f"6 N tokens / wall / the H100 peak "
                                 f"({want_mfu:.6f})")
    if [d["reason"] for d in dumps] != ["nan_guard"]:
        raise AssertionError(f"flight dumps: {[d['reason'] for d in dumps]}")
    # GradScaler: two eager steps of the same model and optimizer
    scaler = amp.GradScaler()
    scaler_steps = []
    for poison in (float("inf"), 1.0):
        bits = bit_sums(torch, [g.p for g in opt._groups])
        scale = scaler.get_loss_scaling()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = model(ids, labels=ids) * poison
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        scaler_steps.append({
            "loss_factor": str(poison), "scale_before": scale,
            "found_inf": bool(scaler._found_inf_t),
            "scale_after": scaler.get_loss_scaling(),
            "updated": bit_sums(torch, [g.p for g in opt._groups]) != bits})
    first, second = scaler_steps
    if not (first["found_inf"] and not first["updated"]
            and first["scale_after"] == first["scale_before"] * 0.5
            and not second["found_inf"] and second["updated"]
            and second["scale_after"] == first["scale_after"]):
        raise AssertionError(f"GradScaler steps: {scaler_steps}")
    step_s = wall / steps
    return {
        "phase": "train_o2_slice", "model": "GPT-3 1.3B", "params": n_params,
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "amp": "O2 bfloat16 (decorate, fp32 masters)",
        "batch": [batch, seq], "init_s": init_s, "warmup_step_s": warm_s,
        "losses": [x if math.isfinite(x) else str(x) for x in losses],
        "step_s": step_s, "o1_step_s": o1_step_s,
        "o2_over_o1": step_s / o1_step_s,
        "tokens_per_s": batch * seq / step_s,
        "peak_mem_bytes": peak, "resident_bytes_before": resident,
        "skipped_steps": step.skipped_steps,
        "records": len(records), "mfu": [r["mfu"] for r in records],
        "grad_norm": [r["grad_norm"] if math.isfinite(r["grad_norm"])
                      else str(r["grad_norm"]) for r in records],
        "lr": [r["lr"] for r in records], "flight_dumps": len(dumps),
        "grad_scaler": scaler_steps, "adamw_groups": len(opt._groups),
        "launches": launches, "launches_per_step": per_step,
    }


def train_packed_slice_phase(torch, reset, counts, rows=2, seq=4096,
                             steps=3, lr=1e-4):
    """Main path 3: Llama-2-7B at its published widths, depth cut to 8
    layers, amp O1 (bf16 matmuls and attention, fp32 parameters and
    RMSNorm), AdamW, through TrainStep on one packed batch of `rows` x
    `seq` tokens from PackedLMBatches (seeded documents of 64-2048 tokens);
    one warm-up step, then `steps` timed steps on the same batch."""
    import math

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.profile_training import (packed_batch,
                                                         packed_llama_config)

    cfg = packed_llama_config()
    resident = torch.cuda.memory_allocated()   # left by earlier phases
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=SEED)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01)

    def loss_fn(ids, seg, labels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return model(ids, labels=labels, segments=seg)

    step = TrainStep(model, loss_fn, opt)
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in packed_batch(cfg.vocab_size, rows, seq))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    real = int((batch[1] >= 0).sum())
    docs = int(sum(torch.unique(r[r >= 0]).numel() for r in batch[1]))
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = time.perf_counter()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    peak_first = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    for _ in range(steps):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = counts()
    losses = [float(x) for x in losses]
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    L = cfg.num_layers
    want = {"flash_seg_fwd": L, "flash_seg_dq": L, "flash_seg_dkv": L,
            "rms_norm": 2 * L + 1, "rms_norm_bwd": 2 * L + 1,
            "rope_packed": 2 * L, "adamw": len(opt._groups),
            "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "rope": 0}
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    # random weights (std 0.02) give logits of std 0.02 * sqrt(4096) = 1.28
    # after the final RMSNorm: the first loss sits near ln(vocab) + 1.28^2 /
    # 2 = 11.19, so within 1.0 of ln(vocab); the repeated batch must fall
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 1.0 \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"packed Llama losses {losses}: the first "
                             f"should be within 1.0 of ln(vocab) = "
                             f"{math.log(cfg.vocab_size):.3f} and the last "
                             f"below it")
    step_s = wall / steps
    return {
        "phase": "train_packed_slice",
        "model": f"Llama-2-7B widths, {L} layers", "params": n_params,
        "layers": L, "hidden": cfg.hidden_size, "amp": "O1 bfloat16",
        "batch": [rows, seq], "documents": docs, "real_tokens": real,
        "init_s": init_s, "warmup_step_s": warm_s, "losses": losses,
        "step_s": step_s, "tokens_per_s": rows * seq / step_s,
        "real_tokens_per_s": real / step_s,
        "peak_mem_bytes_warmup": peak_first,
        "peak_mem_bytes_timed_steps": torch.cuda.max_memory_allocated(),
        "resident_bytes_before": resident,
        "launches": launches, "launches_per_step": per_step,
    }


# ------------------------------------------- recompute, checkpoints, feed
def _flat_bufs(opt):
    """Every flat buffer of the optimizer's groups that holds state:
    parameters, masters, moments (not the gradients)."""
    return [t for g in opt._groups for t in (g.p, g.master, g.m, g.v)
            if t is not None]


def _want_launches(kind, layers, groups, master, recompute):
    """Launches a step by kernel name (every kernel of KERNELS keyed) for
    the GPT ("gpt") or packed Llama ("llama") step: under recompute each
    kernel inside a block launches twice (the forward, then again in the
    backward), the backward kernels and those outside the blocks once."""
    L, r = layers, 2 if recompute else 1
    want = dict.fromkeys(KERNELS, 0)
    if kind == "gpt":
        want.update(flash_fwd=r * L, flash_dq=L, flash_dkv=L)
    else:
        want.update(flash_seg_fwd=r * L, flash_seg_dq=L, flash_seg_dkv=L,
                    rms_norm=2 * r * L + 1, rms_norm_bwd=2 * L + 1,
                    rope_packed=(r + 1) * L)
    want["adamw_master" if master else "adamw"] = groups
    return want


def _same_floats(a, b):
    """Bitwise equal lists of floats (NaN equal to NaN)."""
    import math

    return len(a) == len(b) and all(
        x == y or (math.isnan(x) and math.isnan(y)) for x, y in zip(a, b))


def recompute_parity_phase(torch, reset, counts, steps=3, lr=1e-5, batch=2,
                           seq=128, device="cuda", gpt_cfg=None,
                           llama_cfg=None, llama_seq=256):
    """Three TrainSteps (AdamW, global-norm clip) with recompute on and
    three with it off, from the same weights and batch, for GPT at GPT-3
    1.3B's width (2 layers) in fp32 and under amp O2, and the packed Llama
    at Llama-2-7B's width (2 layers) in fp32 on one 256-token row of four
    documents: losses, parameters, masters and moments must be bitwise
    equal (the kernels use no atomics, so the recomputed forward is the
    first one bit for bit, and non-reentrant checkpointing keeps the
    backward graph). Launches a step must be `_want_launches`' (`counts`
    None skips that check, for a run on the CPU)."""
    import copy

    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.io import pack_examples
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaForCausalLM)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.profile_training import packed_llama_config

    if gpt_cfg is None:
        gpt_cfg = GPTConfig.gpt3_1p3b()
        gpt_cfg.num_layers = 2
        gpt_cfg.hidden_dropout_prob = gpt_cfg.attention_dropout_prob = 0.0
    llama_cfg = llama_cfg or packed_llama_config(layers=2)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, gpt_cfg.vocab_size, (batch, seq))
    docs = [rng.integers(0, llama_cfg.vocab_size, n) for n in (70, 50, 90, 30)]
    packed = pack_examples(docs, llama_seq)
    cases = (("GPT fp32", "gpt", gpt_cfg, None, (ids,)),
             ("GPT amp O2", "gpt", gpt_cfg, "O2", (ids,)),
             ("Llama packed fp32", "llama", llama_cfg, None, packed))
    rows = []
    for label, kind, base, level, args in cases:
        runs = {}
        for rc in (False, True):
            cfg = copy.deepcopy(base)
            cfg.recompute = rc
            cls = GPTForCausalLM if kind == "gpt" else LlamaForCausalLM
            model = cls(cfg, device=device, seed=SEED)
            opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                        grad_clip=ClipGradByGlobalNorm(1.0))
            if level:
                amp.decorate(model, opt, level=level, dtype="bfloat16")

            def loss_fn(x, seg=None, labels=None, model=model):
                with amp.auto_cast(enable=level is not None,
                                   level=level or "O1", dtype="bfloat16"):
                    return model(x, labels=x if labels is None else labels,
                                 segments=seg)

            step = TrainStep(model, loss_fn, opt, device=device)
            reset()
            t0 = time.perf_counter()
            losses = [float(step(*args)) for _ in range(steps)]
            secs = time.perf_counter() - t0
            per_step = {k: v / steps for k, v in counts().items()} \
                if counts else None
            runs[rc] = (opt, losses, per_step, secs)
        (o_off, l_off, c_off, s_off), (o_on, l_on, c_on, s_on) = \
            runs[False], runs[True]
        groups = len(o_on._groups)
        want = {rc: _want_launches(kind, base.num_layers, groups,
                                   level == "O2", rc) for rc in runs}
        same_bufs = all(torch.equal(a, b) for a, b in
                        zip(_flat_bufs(o_off), _flat_bufs(o_on)))
        pows = [[(st["beta1_pow"], st["beta2_pow"])
                 for st in o._state.values()] for o in (o_off, o_on)]
        row = {"case": label, "layers": base.num_layers,
               "hidden": base.hidden_size,
               "batch": list(np.shape(args[0])), "losses_off": l_off,
               "losses_on": l_on, "bitwise_equal_state": same_bufs,
               "launches_per_step_off": c_off,
               "launches_per_step_on": c_on, "seconds_off": s_off,
               "seconds_on": s_on}
        if not all(np.isfinite(l_on)) or l_on != l_off or not same_bufs \
                or pows[0] != pows[1]:
            raise AssertionError(f"recompute changed the training: {row}")
        if counts and (c_off != want[False] or c_on != want[True]):
            raise AssertionError(f"launches a step {row}, expected {want}")
        rows.append(row)
        del runs, o_off, o_on
        release(torch)
    return {"phase": "recompute_parity", "steps": steps, "lr": lr,
            "cases": rows}


def recompute_slice_phase(torch, reset, counts, o2_step_s, batch=4,
                          seq=2048, steps=3, big_batch=16, big_steps=2,
                          lr=1e-4, cfg=None):
    """Main path 5: GPT-3 1.3B at full depth under amp O2 as the O2 slice
    runs it (decorate, auto_cast O2, global-norm clip, AdamW over
    LinearWarmup(CosineAnnealingDecay), the NaN guard; telemetry off),
    first without recompute (the same options, for the step time and the
    activations' footprint in this call), then with recompute=True: at
    batch x seq one warm-up and `steps` timed steps (step time, tokens/s,
    peak memory, launches a step: flash forward 2 a layer, dQ and dK/dV 1,
    the AdamW master form once a group), then at big_batch x seq a warm-up
    and `big_steps` steps, whose peak must stay under the card's memory.
    Beside it, the no-recompute peak at big_batch extrapolated from batch:
    the state plus big_batch / batch times the activations."""
    import copy
    import math

    import numpy as np
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as lrs

    if cfg is None:
        cfg = GPTConfig.gpt3_1p3b()
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    resident = torch.cuda.memory_allocated()
    one = torch.ones((), device="cuda")

    def build(recompute):
        c = copy.deepcopy(cfg)
        c.recompute = recompute
        model = GPTForCausalLM(c, seed=SEED)
        sched = lrs.LinearWarmup(lrs.CosineAnnealingDecay(lr, T_max=1000),
                                 warmup_steps=2, start_lr=lr / 10, end_lr=lr)
        opt = AdamW(sched, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        return model, opt, _o2_step(torch, model, opt, None, nan_guard=True)

    def timed(step, ids, n):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step(ids, one)]
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t1 = time.perf_counter()
        for _ in range(n):
            losses.append(step(ids, one))
        torch.cuda.synchronize()
        return ([float(x) for x in losses], warm,
                (time.perf_counter() - t1) / n,
                torch.cuda.max_memory_allocated())

    rng = np.random.default_rng(SEED + 2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (batch, seq))).cuda()
    model, opt, step = build(False)
    n_params = sum(p.numel() for p in model.parameters())
    off_losses, _, off_s, off_peak = timed(step, ids, steps)
    state = torch.cuda.memory_allocated() - resident
    del model, opt, step
    release(torch)

    model, opt, step = build(True)
    reset()
    losses, warm_s, step_s, peak = timed(step, ids, steps)
    launches = counts()
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    want = _want_launches("gpt", cfg.num_layers, len(opt._groups), True,
                          True)
    if per_step != want:
        raise AssertionError(f"recompute launches per step {per_step}, "
                             f"expected {want}")
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"recompute losses {losses}: the first should "
                             f"be within 0.5 of ln(vocab), the last below it")
    if losses[0] != off_losses[0]:
        raise AssertionError(f"the first step's loss differs with recompute: "
                             f"{losses[0]} against {off_losses[0]}")
    big = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (big_batch, seq))).cuda()
    big_losses, big_warm_s, big_step_s, big_peak = timed(step, big,
                                                         big_steps)
    card = torch.cuda.get_device_properties(0).total_memory
    if not all(math.isfinite(x) for x in big_losses) or big_peak >= card:
        raise AssertionError(f"batch {big_batch}: losses {big_losses}, peak "
                             f"{big_peak} of the card's {card} bytes")
    activations = off_peak - resident - state
    peak_flops = 989e12
    return {
        "phase": "recompute_slice", "model": "GPT-3 1.3B",
        "params": n_params, "layers": cfg.num_layers,
        "amp": "O2 bfloat16 (decorate, fp32 masters)", "recompute": True,
        "batch": [batch, seq], "warmup_step_s": warm_s, "losses": losses,
        "step_s": step_s, "no_recompute_step_s": off_s,
        "recompute_over_no_recompute": step_s / off_s,
        "o2_slice_step_s": o2_step_s,
        "recompute_over_o2_slice": step_s / o2_step_s,
        "tokens_per_s": batch * seq / step_s,
        "mfu_6n": 6.0 * n_params * batch * seq / step_s / peak_flops,
        "peak_mem_bytes": peak, "no_recompute_peak_mem_bytes": off_peak,
        "state_bytes": state, "resident_bytes_before": resident,
        "launches": launches, "launches_per_step": per_step,
        "big_batch": [big_batch, seq], "big_losses": big_losses,
        "big_warmup_step_s": big_warm_s, "big_step_s": big_step_s,
        "big_tokens_per_s": big_batch * seq / big_step_s,
        "big_peak_mem_bytes": big_peak,
        "no_recompute_big_peak_extrapolated_bytes":
            resident + state + big_batch / batch * activations,
        "card_memory_bytes": card,
    }


class TokenRows:
    """A seeded map-style dataset of token rows, as numpy: row i is `seq`
    tokens below `vocab` from default_rng((seed, i)), with a loss weight
    of 1.0 (a float leaf the chaos harness can poison)."""

    def __init__(self, n, seq, vocab, seed=SEED):
        self.n, self.seq, self.vocab, self.seed = n, seq, vocab, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        ids = np.random.default_rng((self.seed, i)).integers(
            0, self.vocab, self.seq)
        return ids, np.float32(1.0)


def io_feed_phase(torch, rows=64, batch=4, seq=2048, vocab=50304,
                  device="cuda"):
    """TokenRows through DataLoader(num_workers=2, process workers, shared
    memory, shuffle=True): the batch order must equal the same loader's
    with num_workers=0; then through DevicePrefetcher(depth=2): batches/s,
    the prefetcher's wait seconds, every batch on `device` and equal to the
    host one."""
    from paddle_tpu_torch.io import DataLoader, DevicePrefetcher

    ds = TokenRows(rows, seq, vocab)
    kw = dict(batch_size=batch, shuffle=True, places="cpu")
    inline = list(DataLoader(ds, **kw))
    t0 = time.perf_counter()
    proc = list(DataLoader(ds, num_workers=2, mode="process",
                           use_shared_memory=True, **kw))
    proc_s = time.perf_counter() - t0

    def same(a, b):
        return len(a) == len(b) and all(
            torch.equal(x.cpu(), y) for u, v in zip(a, b)
            for x, y in zip(u, v))

    if not same(proc, inline):
        raise AssertionError("the process loader's batches differ from the "
                             "inline loader's")
    it = iter(DataLoader(ds, num_workers=2, mode="process", **kw))
    t1 = time.perf_counter()
    with DevicePrefetcher(it, depth=2, device=device) as pf:
        placed = list(pf)
    if placed[0][0].is_cuda:
        torch.cuda.synchronize()
    feed_s = time.perf_counter() - t1
    on_device = all(t.device.type == torch.device(device).type
                    for b in placed for t in b)
    if not on_device or not same(placed, inline):
        raise AssertionError("prefetched batches are not the host batches "
                             f"on {device}")
    return {"phase": "io_feed", "rows": rows, "batch": [batch, seq],
            "batches": len(placed), "workers": 2,
            "process_loader_batches_per_s": len(proc) / proc_s,
            "prefetched_batches_per_s": len(placed) / feed_s,
            "prefetched_tokens_per_s": len(placed) * batch * seq / feed_s,
            "prefetch_wait_s": pf.stats["wait_s"],
            "prefetch_batches": pf.stats["batches"],
            "on_device": on_device, "device": str(device)}


def resilient_slice_phase(torch, steps=8, save_every=2, batch=4, seq=2048,
                          lr=1e-4, poison_step=5, preempt_at=3, cfg=None,
                          device="cuda"):
    """GPT-3 1.3B's widths cut to 1 layer (a checkpoint of ~2.2 GB; 2
    until cp_slice joined the script), amp
    O2 with recompute, hidden dropout 0.1 from the model's generator, fed
    by io_feed's loader through the DevicePrefetcher, through
    ResilientTrainer(CheckpointManager(tmp, keep_last_n=2,
    async_save=True), save_every=2, nan_guard=True) with FLAGS_metrics on.
    Step `poison_step` is poisoned by chaos.poison_steps in every run.
    1. `steps` steps uninterrupted: the poisoned step skipped with every
       flat buffer's bits unchanged across it; then one more async save,
       timed on the caller's side and in the background.
    2. A crash injected at ckpt.before_commit of the step-6 save (it
       surfaces at the step-8 save); a fresh trainer from other initial
       weights restores step 4 (timed) and runs to `steps`.
    3. chaos.fake_preemption before batch `preempt_at`: "preempted" with a
       final checkpoint; a fresh trainer resumes and runs to `steps`.
    The resumed runs' losses from the resume on, and their final
    parameters, masters, moments and beta powers, must equal run 1's
    bitwise. Raises first if the temporary directory has less free space
    than five checkpoints; deletes it at the end."""
    import copy
    import math
    import shutil
    import signal
    import tempfile

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.io import DataLoader, DevicePrefetcher
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import CheckpointManager, chaos
    from paddle_tpu_torch.resilience.trainer import ResilientTrainer

    if cfg is None:
        cfg = GPTConfig.gpt3_1p3b()
        cfg.num_layers = 1
        cfg.attention_dropout_prob = 0.0      # flash; hidden dropout 0.1
    cfg = copy.deepcopy(cfg)
    cfg.recompute = True
    n_params = gpt_numel(cfg)
    estimate = 14 * n_params     # bf16 parameters, fp32 masters, m and v
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(root).free
    if free < 5 * estimate:
        shutil.rmtree(root)
        raise RuntimeError(f"{free} bytes free under {root}; the phase "
                           f"needs five checkpoints of ~{estimate}")
    ds = TokenRows(steps * batch, seq, cfg.vocab_size)
    tobs.reset_all()
    flags.set_flags({"metrics": "on",
                     "metrics_dir": os.path.join(root, "metrics")})

    def feed(preempt=None):
        def epoch():
            it = iter(DataLoader(ds, batch_size=batch, shuffle=True,
                                 places="cpu", num_workers=2))
            pf = DevicePrefetcher(it, depth=2, device=device)
            try:
                for i, b in enumerate(pf):
                    if i == preempt:
                        chaos.fake_preemption(signal.SIGTERM)
                    yield b
            finally:
                pf.close()
                it.close()
        return epoch

    def make(tag, seed):
        model = GPTForCausalLM(cfg, device=device, seed=seed)
        opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0))
        amp.decorate(model, opt, level="O2", dtype="bfloat16")
        losses, bits = {}, {}

        def loss_fn(ids, w):
            i = tr.step._step_i - 1      # this step's global index
            if i in (poison_step, poison_step + 1):
                bits[i] = bit_sums(torch, _flat_bufs(opt))
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                loss = model(ids, labels=ids) * w.mean()
            losses[i] = loss.detach()
            return loss

        mgr = CheckpointManager(os.path.join(root, tag), keep_last_n=2,
                                async_save=True)
        tr = ResilientTrainer(model, loss_fn, opt, mgr,
                              save_every=save_every, nan_guard=True,
                              device=device)
        return tr, losses, bits

    def state_of(tr):
        opt = tr.optimizer
        return (_flat_bufs(opt), [(st["beta1_pow"], st["beta2_pow"])
                                  for st in opt._state.values()])

    def floats(losses, start):
        return [float(losses[i]) for i in sorted(losses) if i >= start]

    try:
        # 1. uninterrupted
        chaos.poison_steps([poison_step])
        ref, ref_losses, ref_bits = make("uninterrupted", SEED)
        t0 = time.perf_counter()
        rep1 = ref.run(feed())
        run_s = time.perf_counter() - t0
        chaos.clear()
        last = ref.manager._dir_for(ref.manager.latest_step())
        ckpt_bytes = sum(os.path.getsize(os.path.join(last, f))
                         for f in os.listdir(last))
        if rep1["status"] != "completed" or rep1["step"] != steps \
                or rep1["steps_skipped"] != 1 \
                or ref_bits[poison_step] != ref_bits[poison_step + 1]:
            raise AssertionError(f"uninterrupted run {rep1}: the poisoned "
                                 f"step must be skipped with every flat "
                                 f"buffer's bits unchanged")
        t1 = time.perf_counter()
        ref.save()
        caller_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        ref.manager.wait()
        write_s = time.perf_counter() - t2
        want_state = state_of(ref)
        want_losses = floats(ref_losses, 0)

        def check(tr, losses, start, what):
            got = state_of(tr)
            same = all(torch.equal(a, b) for a, b in
                       zip(got[0], want_state[0])) and got[1] == want_state[1]
            if not same or not _same_floats(floats(losses, start),
                                            want_losses[start:]):
                raise AssertionError(f"{what}: the resumed run differs from "
                                     f"the uninterrupted one (losses "
                                     f"{floats(losses, start)} against "
                                     f"{want_losses[start:]})")

        # 2. killed at the step-6 commit, resumed from step 4
        chaos.poison_steps([poison_step])
        chaos.inject_crash("ckpt.before_commit", after=2)
        crashed, _, _ = make("crash", SEED)
        try:
            crashed.run(feed())
            raise AssertionError("the injected crash did not surface")
        except chaos.InjectedCrash:
            pass
        crashed_at = crashed.step._step_i
        del crashed
        gc.collect()
        chaos.clear()
        chaos.poison_steps([poison_step])
        resumed, losses2, _ = make("crash", SEED + 7)
        t3 = time.perf_counter()
        restored = resumed.restore()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t3
        rep2 = resumed.run(feed(), resume=False)
        chaos.clear()
        if restored.step != 4 or rep2["step"] != steps:
            raise AssertionError(f"crash case: restored {restored.step}, "
                                 f"report {rep2}")
        check(resumed, losses2, 4, "crash at ckpt.before_commit")
        del resumed
        gc.collect()

        # 3. preempted by SIGTERM, resumed
        chaos.poison_steps([poison_step])
        pre, _, _ = make("preempt", SEED)
        rep3 = pre.run(feed(preempt=preempt_at))
        del pre
        gc.collect()
        resumed, losses3, _ = make("preempt", SEED + 7)
        rep3b = resumed.run(feed())
        chaos.clear()
        if rep3["status"] != "preempted" or rep3["step"] != preempt_at \
                or rep3b["resumed_from"] != preempt_at \
                or rep3b["status"] != "completed" or rep3b["step"] != steps:
            raise AssertionError(f"preemption case: {rep3} then {rep3b}")
        check(resumed, losses3, preempt_at, "preemption")
        del resumed, ref
        gc.collect()
        children = multiprocessing.active_children()
        if children:
            raise AssertionError(f"worker processes left: {children}")
    finally:
        chaos.clear()
        flags.set_flags({"metrics": "off", "metrics_dir": ""})
        tobs.reset_all()
        shutil.rmtree(root, ignore_errors=True)
    tele = rep1.get("telemetry", {})
    return {
        "phase": "resilient_slice",
        "model": f"GPT-3 1.3B widths, {cfg.num_layers} layers (depth cut)",
        "params": n_params, "amp": "O2 bfloat16",
        "recompute": True, "hidden_dropout": cfg.hidden_dropout_prob,
        "batch": [batch, seq], "steps": steps, "save_every": save_every,
        "poisoned_step": poison_step,
        "losses": [x if math.isfinite(x) else str(x) for x in want_losses],
        "run_s": run_s, "checkpoint_bytes": ckpt_bytes,
        "free_bytes_before": free,
        "async_save_caller_s": caller_s, "background_write_s": write_s,
        "background_write_gb_per_s": ckpt_bytes / write_s / 1e9,
        "restore_s": restore_s, "restored_step": restored.step,
        "crashed_at_step": crashed_at, "preempted": rep3,
        "resumed_after_preemption": {k: rep3b[k] for k in
                                     ("status", "step", "resumed_from",
                                      "steps_run", "steps_skipped")},
        "telemetry_phase_ms_avg": tele.get("phase_ms_avg"),
        "telemetry_records": tele.get("records"),
    }


# -- elastic data parallelism: ranks as processes on the one card -----------

# tools/faultbench.py's gate 4 knobs (_proc_elastic_gates) and its loss
# continuity bound (LOSS_CONTINUITY_TOL: fp reassociation across a reshard)
ELASTIC_PARITY = dict(nsteps=40, n_batches=12, save_every=3,
                      lease_ttl_s=2.0, heartbeat_s=0.25,
                      allreduce_timeout_s=8.0, sync_timeout_s=10.0)
LOSS_CONTINUITY_TOL = 5e-3
# elastic_slice (GPT-3 1.3B, bf16 O1, lr 1e-4): the survivor against a clean
# world-1 run. On an H100 its losses read 2.2e-5 apart, where one update
# moves the loss 0.008-0.025, and its final parameters 2.7e-4 apart
# (relative), where the last update moves them 1.7e-3; the parameter bound
# must stay under the last update's move (checked in the run)
ELASTIC_SLICE_LOSS_TOL = 1e-3
ELASTIC_SLICE_PARAM_TOL = 5e-4
# the ElasticTrainer's training kernels (rows 6, 7, 8 and 13)
ELASTIC = ("flash_fwd", "flash_dq", "flash_dkv", "adamw")


def _elastic_batches(spec):
    """`n_batches` global batches of token ids [rows, seq], from the seed."""
    import numpy as np
    from paddle_tpu_torch.models import GPTConfig

    vocab = (GPTConfig.tiny() if spec["model"] == "tiny"
             else GPTConfig.gpt3_1p3b()).vocab_size
    rng = np.random.default_rng(spec["seed"])
    ids = rng.integers(0, vocab, (spec["n_batches"], spec["rows"],
                                  spec["seq"]))
    return [(ids[i],) for i in range(spec["n_batches"])]


def _elastic_model(torch, spec, device):
    """(model, AdamW, loss_fn) of an elastic rank: GPTConfig.tiny() (2
    layers, hidden 128) in fp32, or GPT-3 1.3B at full width and depth
    with fp32 parameters under amp O1 (bf16); seeded alike on every rank."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    if spec["model"] == "tiny":
        cfg = GPTConfig.tiny()
    else:
        cfg = GPTConfig.gpt3_1p3b()
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    cfg.num_layers = spec.get("layers", cfg.num_layers)
    cfg.recompute = bool(spec.get("recompute"))
    model = GPTForCausalLM(cfg, device=device, seed=spec["seed"])
    clip = None
    if spec.get("clip"):
        from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

        clip = ClipGradByGlobalNorm(spec["clip"])
    opt = AdamW(spec["lr"], parameters=model.parameters(),
                weight_decay=0.01, grad_clip=clip)
    amp_on = bool(spec.get("amp"))

    def loss_fn(ids):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    return model, opt, loss_fn


def _rel_dev(torch, got, want):
    """|got - want| / |want| over lists of tensors, the norms in fp64."""
    num = den = 0.0
    for g, w in zip(got, want):
        g, w = g.detach(), w.detach()
        num += float(torch.linalg.vector_norm(
            g.double() - w.double())) ** 2
        den += float(torch.linalg.vector_norm(w, dtype=torch.float64)) ** 2
    return (num / den) ** 0.5


def _vm(pid, field):
    """A /proc/<pid>/status size field (VmRSS) in bytes; 0 when the
    process is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _write_json(path, doc):
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def elastic_rank_main(spec):
    """One elastic data-parallel rank as a process of its own, started by
    distributed.spawn (which imports this module in the child). Connects a
    TCPStore client to the parent's store, builds the seeded model, joins
    the running world first when `join` (faultbench's choreography: wait
    for the published view, then request_join with a membership that
    heartbeats until the trainer's own takes over), and runs an
    ElasticTrainer on the card. After every step and save it rewrites
    `report_dir/rank<member>.json` (step parts and bytes, saves with their
    bytes, reforms, launch counts, peak device memory), so a rank
    that is killed leaves its last state behind; the finished report goes
    there too and is returned."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    import hashlib

    import torch
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed.elastic import ElasticMembership
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.resilience.elastic import ElasticTrainer

    device = spec.get("device", "cuda")
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:                   # three ranks' thread pools would fight for cores
        torch.set_num_threads(1)
    mid = int(spec.get("member_id", os.environ.get("PADDLE_TRAINER_ID", 0)))
    host, port = spec["store"]
    store = native.TCPStore(host, int(port), is_master=False,
                            timeout_s=60.0)
    model, opt, loss_fn = _elastic_model(torch, spec, device)
    batches = _elastic_batches(spec)
    if spec.get("step_delay_s"):
        chaos.slow_rank(mid, spec["step_delay_s"])
    path = os.path.join(spec["report_dir"], f"rank{mid}.json")

    def progress(tr, **extra):
        return {"member": mid, "pid": os.getpid(),
                "step_parts": tr.step_parts, "saves": tr.saves,
                "reforms": tr.reforms,
                "losses": {str(k): v for k, v in tr.losses.items()},
                "launches": gpu.launch_counts(ELASTIC),
                "max_allocated": (torch.cuda.max_memory_allocated()
                                  if on_card else 0),
                "max_reserved": (torch.cuda.max_memory_reserved()
                                 if on_card else 0), **extra}

    class Reporting(ElasticTrainer):
        def _train_step(self, batch):
            super()._train_step(batch)
            _write_json(path, progress(self))

        def _save(self):
            super()._save()
            shard = os.path.join(
                self.manager._dir_for(self._gstep), "shards",
                f"shard_{self.manager.rank:05d}")
            self.saves[-1]["bytes"] = sum(
                os.path.getsize(os.path.join(shard, f))
                for f in os.listdir(shard)) if os.path.isdir(shard) else 0
            _write_json(path, progress(self))

    pre = None
    if spec.get("join"):
        # into a running world: once the incumbents committed the
        # `join_after` checkpoint
        key = f"/pt/ckpt/g0/{spec['join_after']}/committed"
        t0 = time.monotonic()
        while store.get(key, blocking=False) is None:
            if time.monotonic() - t0 > 240:
                raise RuntimeError(f"member {mid}: the world never "
                                   f"committed step {spec['join_after']}")
            time.sleep(0.05)
        pre = ElasticMembership(store, mid, [mid],
                                lease_ttl_s=spec["lease_ttl_s"],
                                heartbeat_s=spec["heartbeat_s"])
        pre.start()
        pre.request_join(timeout_s=120)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gpu.reset_launch_counts()
    tr = Reporting(
        model, loss_fn, opt, spec["root"], store=store, member_id=mid,
        members=spec["members"], save_every=spec["save_every"],
        keep_last_n=spec.get("keep_last_n", 3),
        lease_ttl_s=spec["lease_ttl_s"], heartbeat_s=spec["heartbeat_s"],
        allreduce_timeout_s=spec["allreduce_timeout_s"],
        sync_timeout_s=spec["sync_timeout_s"], device=device)
    try:
        rep = tr.run(batches, total_steps=spec["nsteps"])
    finally:
        if pre is not None:
            pre.stop()
    if spec.get("hash_params"):
        sha = hashlib.sha256()
        for p in model.parameters():
            sha.update(p.detach().cpu().numpy().tobytes())
        rep["params_sha"] = sha.hexdigest()
    if spec.get("dump_params"):
        # the final parameters as fp32 words in model.parameters() order,
        # one tensor at a time, for the parent's comparison with its clean
        # run
        with open(os.path.join(spec["report_dir"], f"rank{mid}.params"),
                  "wb") as f:
            for p in model.parameters():
                f.write(p.detach().float().cpu().numpy().tobytes())
    _write_json(path, progress(tr, report=rep))
    store.close()
    return rep


def _thread_world(torch, spec, root, members, device):
    """A clean run: one ElasticTrainer thread per member in this process,
    over one InProcStore; their reports."""
    import threading

    from paddle_tpu_torch.distributed.env import InProcStore
    from paddle_tpu_torch.resilience.elastic import ElasticTrainer

    store = InProcStore()
    batches = _elastic_batches(spec)
    trainers = []
    for mid in members:
        model, opt, loss_fn = _elastic_model(torch, spec, device)
        trainers.append(ElasticTrainer(
            model, loss_fn, opt, root, store=store, member_id=mid,
            members=members, save_every=spec["save_every"],
            lease_ttl_s=spec["lease_ttl_s"], heartbeat_s=spec["heartbeat_s"],
            allreduce_timeout_s=spec["allreduce_timeout_s"],
            sync_timeout_s=spec["sync_timeout_s"], device=device))
    reports = [None] * len(members)

    def go(i):
        reports[i] = trainers[i].run(batches, total_steps=spec["nsteps"])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(members))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or None in reports:
        raise AssertionError(f"the clean thread world did not finish: "
                             f"{reports}")
    return reports


def _view_members(store):
    raw = store.get("/pt/elastic/view", blocking=False)
    return set(json.loads(bytes(raw).decode())["members"]) if raw else set()


def _failures(*ctxs):
    """The error of each spawned world that has one (a worker's traceback,
    or how it exited), for a phase that saw a rank exit early."""
    out = []
    for ctx in ctxs:
        try:
            ctx.join(5)
        except RuntimeError as e:
            out.append(str(e)[-4000:])
    return out


def _join_killed(ctx, victim, timeout):
    """ProcessContext.join for a world whose rank `victim` was SIGKILLed:
    that rank must be the only failure, with no result and exit -9."""
    try:
        ctx.join(timeout)
    except RuntimeError as e:
        if f"spawn worker {victim} failed" not in str(e) \
                or "exitcode -9" not in str(e):
            raise AssertionError(f"a rank failed other than by the kill: "
                                 f"{e}") from e
    else:
        raise AssertionError(f"rank {victim} finished despite its SIGKILL")


def cluster_rank_main(spec):
    """One rank of the ResilientTrainer(cluster=ClusterTelemetry) check, a
    process of its own (distributed.spawn): a 2-layer fp32 GPT, metrics
    on, every step record published through the parent's store; rank 1
    sleeps in its loss function from step `slow_from` on. Rank 0 returns
    its straggler events and the `cluster` entry of a flight-recorder dump
    taken after the run."""
    sys.stdout = sys.stderr
    import torch
    from paddle_tpu_torch import native
    from paddle_tpu_torch import observability as tobs
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.observability.cluster import ClusterTelemetry
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.resilience.trainer import ResilientTrainer

    device = spec.get("device", "cuda")
    if device == "cpu":     # two ranks' thread pools would fight for cores
        torch.set_num_threads(1)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    root = os.path.join(spec["root"], f"rank{rank}")
    tobs.reset_all()
    flags.set_flags({"metrics": "on",
                     "metrics_dir": os.path.join(root, "metrics")})
    host, port = spec["store"]
    store = native.TCPStore(host, int(port), is_master=False,
                            timeout_s=60.0)
    cluster = ClusterTelemetry(store, rank, 2, k=spec["k"], m=spec["m"],
                               timeout_s=60.0)
    model, opt, inner = _elastic_model(torch, spec, device)
    calls = [0]

    def loss_fn(ids):
        if rank == 1 and calls[0] >= spec["slow_from"]:
            time.sleep(spec["delay_s"])
        calls[0] += 1
        return inner(ids)

    tr = ResilientTrainer(model, loss_fn, opt,
                          CheckpointManager(os.path.join(root, "ckpt")),
                          save_every=0, cluster=cluster, device=device)
    rep = tr.run(_elastic_batches(spec))
    out = {"rank": rank, "status": rep["status"], "step": rep["step"]}
    if rank == 0:
        dump = tobs.flight_recorder.get_flight_recorder().dump(
            "cluster_check")
        with open(dump) as f:
            out["dump_cluster"] = json.load(f).get("cluster")
        out["straggler_events"] = cluster.straggler_events
        out["aggregated_steps"] = len(cluster.aggregates)
        out["last_aggregate"] = cluster.aggregates[-1] \
            if cluster.aggregates else None
    store.close()
    return out


def elastic_parity_phase(torch, device="cuda"):
    """tools/faultbench.py's gate 4 (`_proc_elastic_gates`) with the port
    on the card: elastic ranks as processes over a native.TCPStore this
    process hosts, started by distributed.spawn: two incumbents (members
    0, 1) and a third (member 2) that request_join()s the running world;
    once its grow reform is published, chaos.kill_process SIGKILLs rank 1
    (1.2 s later, as faultbench does). The joiner asks once the step-3
    checkpoint has committed, so it enters a world already training. The
    model is GPTConfig.tiny() (2
    layers, hidden 128) in fp32 with TF32 off, trained by AdamW, 6 x 64
    tokens a global step, faultbench's knobs (ELASTIC_PARITY), each rank
    sleeping 0.2 s a step so the world is still running when the joiner
    is up. Gates: survivors 0 and 2 finish all 40 steps at world 2; the
    reforms show the grow to [0, 1, 2] and the shrink to [0, 2]; their
    losses stay within LOSS_CONTINUITY_TOL of a clean two-thread world in
    this process; their parameters hash equal; the shrink replays at most
    `save_every` steps; rank 1 is the only rank that died, by the kill.
    Then two processes through ResilientTrainer(cluster=ClusterTelemetry(
    k=1.5, m=2)) with FLAGS_metrics on, rank 1 sleeping 0.4 s (1 s on the
    CPU) in its loss from step 2: rank 0 must flag rank 1's compute phase at step 3 (m
    steps on), never rank 0, and its flight-recorder dump must carry the
    cluster snapshot. (At world 2 the median of two is their midpoint, so
    k must be below 2 to flag anyone.)"""
    import shutil
    import tempfile

    import chip_smoke as cs     # spawn pickles functions of an importable
    from paddle_tpu_torch import native          # module, not __main__
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.resilience import chaos

    backend = "cuda" if device == "cuda" else "cpu"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    spec = dict(ELASTIC_PARITY, model="tiny", amp=False, rows=6, seq=64,
                lr=1e-3, seed=SEED, device=device, step_delay_s=0.2,
                hash_params=True)
    t0 = time.perf_counter()
    try:
        clean = _thread_world(torch, spec, os.path.join(tmp, "clean"),
                              [0, 1], device)
        clean_s = time.perf_counter() - t0
        clean_losses = clean[0]["losses"]
        store = native.TCPStore("127.0.0.1", 0, is_master=True)
        reports_dir = os.path.join(tmp, "reports")
        os.makedirs(reports_dir)
        base = dict(spec, store=["127.0.0.1", store.port],
                    root=os.path.join(tmp, "proc"), members=[0, 1],
                    report_dir=reports_dir)
        t1 = time.perf_counter()
        ctx = spawn(cs.elastic_rank_main, args=(base,), nprocs=2,
                    join=False, backend=backend)
        jctx = spawn(cs.elastic_rank_main,
                     args=(dict(base, member_id=2, members=[0, 1, 2],
                                join=True, join_after=3),),
                     nprocs=1, join=False, backend=backend)
        procs = {0: ctx.processes[0], 1: ctx.processes[1],
                 2: jctx.processes[0]}
        try:
            t_join = time.monotonic()
            while 2 not in _view_members(store):
                dead = {m: p.returncode for m, p in procs.items()
                        if p.poll() is not None}
                if dead or time.monotonic() - t_join > 240:
                    raise AssertionError(
                        f"the joiner never entered the view (exited: "
                        f"{dead}: {_failures(ctx, jctx)})")
                time.sleep(0.05)
            joined_s = time.perf_counter() - t1
            time.sleep(1.2)     # let the grown world commit a checkpoint
            chaos.kill_process(procs[1].pid)
            _join_killed(ctx, 1, 600)
            jctx.join(600)
            procs_s = time.perf_counter() - t1
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
            store.close()
        docs = {m: _read_json(os.path.join(reports_dir, f"rank{m}.json"))
                for m in (0, 1, 2)}
        r0, r2 = docs[0]["report"], docs[2]["report"]
        nsteps = spec["nsteps"]
        survivors_done = all(
            r["status"] == "completed" and r["step"] == nsteps
            and r["final_world_size"] == 2 and r["final_members"] == [0, 2]
            for r in (r0, r2)) and r2["steps_run"] > 0
        grew = any(f["members"] == [0, 1, 2] for f in r0["reforms"])
        shrinks = [f for f in r0["reforms"] if f["members"] == [0, 2]]
        replay = (max(f["detected_at_step"] - f["resumed_step"]
                      for f in shrinks) if shrinks else None)
        losses = {int(k): v for k, v in r0["losses"].items()}
        loss_dev = (max(abs(losses[s] - clean_losses[s])
                        for s in clean_losses)
                    if set(losses) >= set(clean_losses) else None)
        gates = {
            "survivors_complete_at_world_2": bool(survivors_done),
            "grow_then_shrink": bool(grew and shrinks),
            "loss_continuity": (loss_dev is not None
                                and loss_dev <= LOSS_CONTINUITY_TOL),
            "survivors_bitwise": r0["params_sha"] == r2["params_sha"],
            "replay_within_save_every": (replay is not None
                                         and replay <= spec["save_every"]),
        }
        if not all(gates.values()):
            raise AssertionError(f"elastic_parity gates {gates}: survivors "
                                 f"{r0} {r2}, clean {clean_losses}")

        # ResilientTrainer(cluster=...) in two processes, rank 1 slowed
        store = native.TCPStore("127.0.0.1", 0, is_master=True)
        # the sleep must exceed twice the other rank's compute (k 1.5 on
        # a median of two): ~10 ms on the card, up to ~0.3 s on a loaded
        # CPU
        cspec = dict(model="tiny", amp=False, rows=4, seq=64, lr=1e-3,
                     seed=SEED, n_batches=6, device=device, k=1.5, m=2,
                     slow_from=2, delay_s=0.4 if device == "cuda" else 1.0,
                     store=["127.0.0.1", store.port],
                     root=os.path.join(tmp, "cluster"))
        t2 = time.perf_counter()
        try:
            out = spawn(cs.cluster_rank_main, args=(cspec,), nprocs=2,
                        backend=backend, timeout=600)
        finally:
            store.close()
        cluster_s = time.perf_counter() - t2
        c0 = out[0]
        flagged = [(e["rank"], e["phase"], e["step"])
                   for e in c0["straggler_events"]]
        want = [(1, "compute", cspec["slow_from"] + cspec["m"] - 1)]
        snap = c0["dump_cluster"] or {}
        if flagged != want or "1" not in snap.get("flagged", {}) \
                or any(o["status"] != "completed" for o in out):
            raise AssertionError(f"cluster check: straggler events "
                                 f"{flagged}, expected {want}; dump "
                                 f"cluster {snap}; reports {out}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "phase": "elastic_parity", "model": "GPT tiny (2 layers, hidden "
        "128), fp32, TF32 off", "knobs": ELASTIC_PARITY,
        "step_delay_s": spec["step_delay_s"], "gates": gates,
        "loss_continuity_dev": loss_dev,
        "loss_continuity_tol": LOSS_CONTINUITY_TOL,
        "reforms": r0["reforms"], "replayed_steps": replay,
        "clean_world_s": clean_s, "join_s": joined_s, "procs_s": procs_s,
        "survivor_steps_run": {0: r0["steps_run"], 2: r2["steps_run"]},
        "rank1_last_step": max((p["step"] for p in docs[1]["step_parts"]),
                               default=None) if docs[1] else None,
        "cluster": {"straggler_events": flagged, "k": cspec["k"],
                    "m": cspec["m"], "slow_from": cspec["slow_from"],
                    "delay_s": cspec["delay_s"],
                    "aggregated_steps": c0["aggregated_steps"],
                    "dump_flagged": snap.get("flagged"),
                    "last_compute_s": (c0["last_aggregate"] or {}).get(
                        "phases", {}).get("compute"),
                    "seconds": cluster_s},
    }


def elastic_slice_phase(torch, device="cuda", spec=None):
    """GPT-3 1.3B at full width, cut to RANK_LAYERS layers (fp32
    parameters, amp O1, AdamW through the fused kernel's fp32 form),
    sequence 2048,
    global batch 4 (two rows a rank), in two rank processes on the one
    card (distributed.spawn) over a native.TCPStore this process hosts,
    save_every 2: once
    the step-2 checkpoint's commit marker is in the store, SIGKILL rank 1;
    the survivor finds the loss, reforms at world 1 from the rank-sharded
    checkpoint and finishes step 6, so four updates (steps 2-5) run after
    the reform. Reports per rank and step the parts of the wall
    (ElasticTrainer.step_parts), bytes sent and MB/s, peak device memory,
    the ranks' and this process's (the store's host) RSS peaks, each
    save's bytes and seconds, the reform's detection, restore and
    first-step seconds, and the launches of rows 6-8 and 13 summed over
    the ranks. The survivor is held against a clean run of the same six
    steps at world 1 in this process (TrainStep, same seed and batches):
    its losses from the resumed step on within ELASTIC_SLICE_LOSS_TOL, and
    its final parameters (dumped by the rank) within
    ELASTIC_SLICE_PARAM_TOL as |p - p_clean| / |p_clean| over all of them.
    The parameter bound must also sit below the clean run's last update,
    |p6 - p5| / |p6|, so a dropped update, AdamW moments lost in the
    restore or an older step restored cannot pass. Raises if a rank dies
    other than by the kill, or the survivor does not finish. Checks the
    free disk first: two kept checkpoints, one in flight and the dump
    (keep_last_n 2), else one kept (keep_last_n 1)."""
    import math
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.resilience import chaos

    backend = "cuda" if device == "cuda" else "cpu"
    spec = dict(spec or dict(
        model="gpt3_1p3b", amp=True, rows=4, seq=2048, lr=1e-4, seed=SEED,
        nsteps=6, n_batches=6, save_every=2, lease_ttl_s=5.0,
        heartbeat_s=0.25, allreduce_timeout_s=20.0, sync_timeout_s=300.0,
        layers=RANK_LAYERS))
    spec["device"] = device
    spec["dump_params"] = True
    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.num_layers = spec.get("layers", cfg.num_layers)
    state_bytes = 3 * 4 * gpt_numel(cfg)     # fp32 parameters, m and v
    dump_bytes = 4 * gpt_numel(cfg)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_slice_")
    free = shutil.disk_usage(tmp).free
    with open("/proc/meminfo") as f:
        meminfo = {ln.split(":")[0]: int(ln.split()[1]) * 1024
                   for ln in f if ln.split(":")[0] in
                   ("MemTotal", "MemAvailable")}
    spec["keep_last_n"] = 2 if free >= 3.2 * state_bytes + dump_bytes \
        else 1
    if free < 2.2 * state_bytes + dump_bytes:
        shutil.rmtree(tmp)
        raise RuntimeError(f"{free} bytes free under {tmp}: two "
                           f"checkpoints of {state_bytes} and a dump of "
                           f"{dump_bytes} do not fit")
    reports_dir = os.path.join(tmp, "reports")
    os.makedirs(reports_dir)
    store = native.TCPStore("127.0.0.1", 0, is_master=True)
    base = dict(spec, store=["127.0.0.1", store.port],
                root=os.path.join(tmp, "ckpt"), members=[0, 1],
                report_dir=reports_dir)
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    commit = f"/pt/ckpt/g0/{spec['save_every']}/committed"
    t0 = time.perf_counter()
    sampler = None
    try:
        ctx = spawn(cs.elastic_rank_main, args=(base,), nprocs=2,
                    join=False, backend=backend)
        procs = dict(enumerate(ctx.processes))
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {"store_host": os.getpid(),
             **{f"rank{m}": p.pid for m, p in procs.items()}},))
        sampler.start()
        try:
            while store.get(commit, blocking=False) is None:
                dead = {m: p.returncode for m, p in procs.items()
                        if p.poll() is not None}
                if dead or time.perf_counter() - t0 > 900:
                    raise AssertionError(
                        f"the step-{spec['save_every']} checkpoint never "
                        f"committed (exited: {dead}: {_failures(ctx)}; "
                        f"reports {[_read_json(os.path.join(reports_dir, f'rank{m}.json')) for m in procs]})")
                time.sleep(0.05)
            t_kill = time.perf_counter()
            chaos.kill_process(procs[1].pid)
            _join_killed(ctx, 1, 1200)
            done_s = time.perf_counter()
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
            stop.set()
            if sampler is not None:
                sampler.join()
            store.close()
        docs = {m: _read_json(os.path.join(reports_dir, f"rank{m}.json"))
                for m in (0, 1)}
        rep = (docs[0] or {}).get("report")
        if rep is None or rep["status"] != "completed" \
                or rep["step"] != spec["nsteps"] \
                or rep["final_world_size"] != 1:
            raise AssertionError(f"the survivor did not finish at world 1: "
                                 f"{docs[0]}")
        (reform,) = rep["reforms"]
        first = next(p for p in docs[0]["step_parts"]
                     if p["gen"] == reform["gen"])
        first_wall = next(w for s, w, g, _ in rep["step_walls"]
                          if g == reform["gen"])

        # the clean run: the same steps at world 1 on the same batches,
        # keeping the parameters before the last update
        model, opt, loss_fn = _elastic_model(torch, spec, device)
        step = TrainStep(model, loss_fn, opt, device=device)
        batches = _elastic_batches(spec)
        params = list(model.parameters())
        t1 = time.perf_counter()
        clean = []
        for s in range(spec["nsteps"]):
            if s == spec["nsteps"] - 1:
                before = [p.detach().clone() for p in params]
            clean.append(float(step(*batches[s % len(batches)])))
        clean_s = time.perf_counter() - t1
        step_rel = _rel_dev(torch, before, params)
        del before
        words = np.memmap(os.path.join(reports_dir, "rank0.params"),
                          dtype=np.float32, mode="r")
        if words.size != sum(p.numel() for p in params):
            raise AssertionError(f"the survivor dumped {words.size} "
                                 f"parameters, the model has "
                                 f"{sum(p.numel() for p in params)}")
        offs = np.cumsum([0] + [p.numel() for p in params])
        param_rel = _rel_dev(torch, (
            torch.from_numpy(np.array(words[a:b])).to(p.device).view_as(p)
            for p, a, b in zip(params, offs[:-1], offs[1:])), params)
        del words, model, opt, step, params
        release(torch)
        losses = {int(k): v for k, v in rep["losses"].items()}
        post = range(reform["resumed_step"], spec["nsteps"])
        dev = max(abs(losses[s] - clean[s]) for s in post)
        loss_tol, param_tol = ELASTIC_SLICE_LOSS_TOL, ELASTIC_SLICE_PARAM_TOL
        if not all(math.isfinite(losses[s]) for s in losses) \
                or len(post) < 2 or dev > loss_tol \
                or not param_rel <= param_tol < step_rel:
            raise AssertionError(
                f"post-reform losses {losses} (steps {list(post)}, at "
                f"least two wanted) against the clean run "
                f"{clean}: {dev} (bound {loss_tol}); final parameters "
                f"{param_rel} from the clean run's (bound {param_tol}, "
                f"which must sit below the clean last update's {step_rel})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum((d or {}).get("launches", {}).get(k, 0)
                       for d in docs.values()) for k in ELASTIC}
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"kernels not launched by the ranks: "
                             f"{launches}")

    def steps_of(doc):
        out = []
        for p in doc["step_parts"]:
            sent, parts = p["bytes"]["sent"], p["parts"]
            out.append({"step": p["step"], "gen": p["gen"],
                        "world": p["world_size"], "parts_s": parts,
                        "wall_s": sum(parts.values()),
                        "bytes_sent": sent,
                        "bytes_received": p["bytes"]["received"],
                        "publish_mb_per_s": (sent / parts["publish"] / 1e6
                                             if parts["publish"] else None),
                        "collect_mb_per_s": (
                            p["bytes"]["received"] / parts["collect"] / 1e6
                            if parts["collect"] else None)})
        return out

    return {
        "phase": "elastic_slice", "model": "GPT-3 1.3B", "layers":
        cfg.num_layers, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
        "amp": "O1 bfloat16, fp32 parameters", "batch": [spec["rows"],
                                                         spec["seq"]],
        "rows_a_rank": spec["rows"] // 2, "steps": spec["nsteps"],
        "save_every": spec["save_every"], "keep_last_n": spec["keep_last_n"],
        "free_disk_bytes": free, "meminfo": meminfo,
        "state_bytes": state_bytes,
        "per_rank": {m: {"steps": steps_of(d), "saves": d["saves"],
                         "max_allocated": d["max_allocated"],
                         "max_reserved": d["max_reserved"],
                         "launches": d["launches"]}
                     for m, d in docs.items() if d},
        "rss_peak_sampled": rss,
        "killed_after_s": t_kill - t0, "survivor_done_s": done_s - t0,
        "reform": reform, "reform_first_step_s": first_wall,
        "reform_first_step_parts": first["parts"],
        "losses": [losses[s] for s in sorted(losses)],
        "clean_losses": clean, "clean_run_s": clean_s,
        "post_reform_steps": list(post),
        "post_reform_max_abs_dev": dev, "loss_tolerance": loss_tol,
        "clean_min_step_loss_move": min(abs(b - a) for a, b in
                                        zip(clean, clean[1:])),
        "final_params_rel_dev": param_rel, "param_tolerance": param_tol,
        "clean_last_update_rel": step_rel,
        "launches": launches,
    }


# dp_slice (GPT-3 1.3B, bf16 O1, lr 1e-4, two ranks over gloo): the ranks
# against a world-1 run of the same eight steps on the same global batches;
# the parameter bound must stay under the world-1 run's last update (checked
# in the run)
DP_SLICE_LOSS_TOL = 1e-3
DP_SLICE_PARAM_TOL = 5e-4
# the data-parallel step's training kernels (rows 6, 7, 8 and 13)
DP = ("flash_fwd", "flash_dq", "flash_dkv", "adamw")
# every collective of distributed.collective, tried on the card's tensors
# under gloo after the slice's steps (which need all_reduce and broadcast);
# send/recv last: handed to gloo on an H100 under torch 2.11 it broke the
# ranks' pair, and once aborted both ranks, so the port now refuses it
DP_PROBE = ("all_reduce", "all_reduce_bf16", "broadcast", "all_gather",
            "reduce_scatter", "reduce", "all_to_all", "gather", "scatter",
            "barrier", "send_recv")


def _dp_flat_sums(torch, opt):
    """bit_sums of AdamW's flat parameter and moment buffers."""
    return bit_sums(torch, [b for g in opt._groups for b in (g.p, g.m, g.v)])


def _dp_collectives(torch, dist, device):
    """Each collective of the port on this rank's small tensors on
    `device`: "ok", or the exception the backend raised (every rank raises
    alike: the device check comes before any communication)."""
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_bf16": lambda: dist.all_reduce(x.to(torch.bfloat16)),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: dist.all_gather([], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.ones(2 * n, device=device)),
        "reduce": lambda: dist.reduce(x.clone(), dst=0),
        "all_to_all": lambda: dist.all_to_all([], [x.clone()
                                                    for _ in range(n)]),
        "gather": lambda: dist.gather(x, [], dst=0),
        "scatter": lambda: dist.scatter(x.clone(), [x.clone()] * n
                                        if r == 0 else None, src=0),
        "send_recv": lambda: dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.clone(), (r + 1) % n),
            dist.P2POp(dist.irecv, x.clone(), (r - 1) % n)]),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name in DP_PROBE:
        try:
            calls[name]()
            if device != "cpu":
                torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _dump_params(model, path):
    """The parameters' fp32 bytes, in order, to `path`. A function of its
    own: a loop variable left holding a parameter would keep AdamW's flat
    parameter and gradient buffers (views) alive after the model."""
    with open(path, "wb") as f:
        for p in model.parameters():
            f.write(p.detach().float().cpu().numpy().tobytes())


def dp_rank_main(spec):
    """One data-parallel rank as a process of its own (distributed.spawn
    imports this module in the child): init_parallel_env under
    PADDLE_DISTRI_BACKEND=spec["backend"] (both ranks on the one card, so
    gloo, which stages CUDA tensors through the host), fleet.init at
    dp_degree 2, the seeded model, and fleet.dp_train_step at each bucket
    size of spec["mbs"], `steps_per` steps each (the first a warm-up that
    also takes the reduce probe) on the global batches. After every step
    the flat buffers' bit sums go through the store and must equal the
    other rank's. Returns the steps (wall, parts, loss), reduce_s and the
    buckets of each size, launches, peak memory and which collectives the
    backend took on the device's tensors; rank 0 dumps its final
    parameters for the parent's world-1 comparison."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    os.environ["PADDLE_DISTRI_BACKEND"] = spec["backend"]
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import gpu

    device = spec.get("device", "cuda")
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t_start = time.perf_counter()
    dist.init_parallel_env(device=None if on_card else "cpu")
    import torch.distributed as tdist

    backend = tdist.get_backend()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["dp_degree"] = 2
    fleet.init(is_collective=True, strategy=strategy)
    rank = dist.get_rank()
    store = denv.get_store()
    model, opt, loss_fn = _elastic_model(torch, spec, device)
    opt = fleet.distributed_optimizer(opt)
    batches = _elastic_batches(spec)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    gpu.reset_launch_counts()
    steps, configs = [], {}
    for mb in spec["mbs"]:
        strategy.dp_comm_configs.update(bucketed_allreduce=mb >= 0,
                                        grad_bucket_mb=max(mb, 0))
        step = fleet.dp_train_step(model, loss_fn, opt, strategy=strategy,
                                   device=device, telemetry=True)
        for k in range(spec["steps_per"]):
            s = len(steps)
            t0 = time.perf_counter()
            loss = float(step(*batches[s % len(batches)]))
            wall = time.perf_counter() - t0
            sums = _dp_flat_sums(torch, opt)
            store.set(f"/pt/dp_slice/{s}/{rank}", json.dumps(sums))
            other = json.loads(bytes(store.get(
                f"/pt/dp_slice/{s}/{1 - rank}", timeout_s=600)).decode())
            if other != sums:
                raise AssertionError(f"step {s}: the ranks' flat buffers "
                                     f"differ: {sums} against {other}")
            steps.append({"step": s, "grad_bucket_mb": mb, "warmup": k == 0,
                          "loss": loss, "wall_s": wall,
                          "parts_s": dict(step.last_parts)})
        trigger = step._trigger[1]
        configs[mb] = {"reduce_s": step._reduce_s,
                       "buckets": len(trigger.buckets),
                       "bucket_bytes": step._trigger[0][1]}
    launches = gpu.launch_counts(DP)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if rank == 0 and spec.get("dump"):
        _dump_params(model, spec["dump"])
    del model, opt, step
    if on_card:
        torch.cuda.empty_cache()
    probe = _dp_collectives(torch, dist, device)
    store.barrier("dp_slice_done")      # rank 0 hosts the store
    return {"rank": rank, "pid": os.getpid(), "backend": backend,
            "setup_s": setup_s, "steps": steps, "configs": configs,
            "bytes_reduced": nbytes, "launches": launches,
            "max_allocated": peak, "collectives": probe}


def dp_slice_phase(torch, device="cuda", spec=None, elastic=None):
    """GPT-3 1.3B at full width, cut to RANK_LAYERS since cp_slice joined
    the script (fp32 parameters, amp O1, AdamW
    through the fused kernel's fp32 form, a global-norm clip), sequence
    2048, global batch 4 (two rows a rank), data-parallel over two rank
    processes on the one card (distributed.spawn, init_parallel_env and
    fleet.init at dp_degree 2), through fleet.dp_train_step: a warm-up and
    three timed steps with 4 MB buckets, then the same with one bucket.
    The backend is named, gloo: NCCL refuses two ranks on one device, and
    gloo reduces CUDA tensors by staging them through the host (the
    tensors stay on the card; the transport is the host's). Reports each
    rank's step wall split into fwd+bwd (the hooks' reduces issued), the
    wait for the last bucket and apply, reduce_s (the comm-only probe),
    buckets, bytes reduced and GB/s, peak device memory and sampled RSS a
    rank, flash and AdamW launches summed over the ranks (they must be 24
    each and 1 a step and rank), which collectives gloo took on CUDA
    tensors, and elastic_slice's world-2 step beside them (`elastic`, that
    phase's row). The ranks' flat buffers must be bitwise equal after every
    step; after they exit a world-1 TrainStep runs the same eight steps on
    the card from the same weights: the ranks' losses within
    DP_SLICE_LOSS_TOL, rank 0's final parameters within DP_SLICE_PARAM_TOL
    (|p - p1| / |p1|), a bound that must sit below the world-1 run's last
    update |p8 - p7| / |p8|."""
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig

    spec = dict(spec or dict(
        model="gpt3_1p3b", amp=True, rows=4, seq=2048, lr=1e-4, seed=SEED,
        n_batches=8, clip=1.0, mbs=(4, -1), steps_per=4, layers=RANK_LAYERS))
    spec.setdefault("backend", "gloo")
    spec["device"] = device
    nsteps = spec["steps_per"] * len(spec["mbs"])
    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.num_layers = spec.get("layers", cfg.num_layers)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_slice_")
    free = shutil.disk_usage(tmp).free
    if free < 1.2 * 4 * gpt_numel(cfg):
        shutil.rmtree(tmp)
        raise RuntimeError(f"{free} bytes free under {tmp}: the parameter "
                           "dump does not fit")
    spec["dump"] = os.path.join(tmp, "rank0.params")
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    t0 = time.perf_counter()
    sampler = None
    try:
        ctx = spawn(cs.dp_rank_main, args=(spec,), nprocs=2, join=False,
                    backend="cuda" if device == "cuda" else "cpu")
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {f"rank{r}": p.pid for r, p in enumerate(ctx.processes)},))
        sampler.start()
        try:
            ranks = ctx.join(900)
        finally:
            for p in ctx.processes:
                if p.poll() is None:
                    p.kill()
            stop.set()
            sampler.join()
        ranks_s = time.perf_counter() - t0

        # the world-1 run: the same steps on the same global batches
        model, opt, loss_fn = _elastic_model(torch, spec, device)
        step = TrainStep(model, loss_fn, opt, device=device)
        batches = _elastic_batches(spec)
        params = list(model.parameters())
        world1, walls = [], []
        for s in range(nsteps):
            if s == nsteps - 1:
                before = [p.detach().clone() for p in params]
            t1 = time.perf_counter()
            world1.append(float(step(*batches[s % len(batches)])))
            walls.append(time.perf_counter() - t1)
        step_rel = _rel_dev(torch, before, params)
        del before
        words = np.memmap(spec["dump"], dtype=np.float32, mode="r")
        offs = np.cumsum([0] + [p.numel() for p in params])
        if words.size != offs[-1]:
            raise AssertionError(f"rank 0 dumped {words.size} parameters, "
                                 f"the model has {offs[-1]}")
        param_rel = _rel_dev(torch, (
            torch.from_numpy(np.array(words[a:b])).to(p.device).view_as(p)
            for p, a, b in zip(params, offs[:-1], offs[1:])), params)
        del words, model, opt, step, params
        if device == "cuda":
            release(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [st["loss"] for st in ranks[0]["steps"]]
    if [st["loss"] for st in ranks[1]["steps"]] != losses:
        raise AssertionError("the ranks' losses differ")
    dev = max(abs(a - b) for a, b in zip(losses, world1))
    loss_tol, param_tol = DP_SLICE_LOSS_TOL, DP_SLICE_PARAM_TOL
    if not all(np.isfinite(losses)) or dev > loss_tol \
            or not param_rel <= param_tol < step_rel:
        raise AssertionError(
            f"losses {losses} against the world-1 run's {world1}: {dev} "
            f"(bound {loss_tol}); final parameters {param_rel} from the "
            f"world-1 run's (bound {param_tol}, which must sit below its "
            f"last update's {step_rel})")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in DP}
    want = {k: (1 if k == "adamw" else cfg.num_layers) * nsteps * 2
            for k in DP}
    if device == "cuda" and launches != want:
        raise AssertionError(f"launches over both ranks {launches}, "
                             f"expected {want}")
    for r in ranks:
        refused = [k for k in ("all_reduce", "broadcast")
                   if r["collectives"][k] != "ok"]
        if refused:
            raise AssertionError(f"gloo refused {refused} on {device} "
                                 f"tensors: {r['collectives']}")

    def summary(r):
        out = {}
        for mb, c in r["configs"].items():
            timed = [st for st in r["steps"]
                     if st["grad_bucket_mb"] == mb and not st["warmup"]]
            parts = {k: statistics.median(st["parts_s"][k] for st in timed)
                     for k in timed[0]["parts_s"]}
            out[str(mb)] = {
                "buckets": c["buckets"], "bucket_bytes": c["bucket_bytes"],
                "step_s": [st["wall_s"] for st in timed],
                "median_step_s": statistics.median(st["wall_s"]
                                                   for st in timed),
                "median_parts_s": parts, "reduce_s": c["reduce_s"],
                "reduce_gb_per_s": r["bytes_reduced"] / c["reduce_s"] / 1e9,
                "warmup_s": next(st["wall_s"] for st in r["steps"]
                                 if st["grad_bucket_mb"] == mb)}
        return out

    world2 = None
    if elastic:
        world2 = [st["wall_s"] for d in elastic["per_rank"].values()
                  for st in d["steps"] if st["world"] == 2 and st["step"] > 0]
    tokens = spec["rows"] * spec["seq"]
    per_rank = {r["rank"]: {"setup_s": r["setup_s"],
                            "by_bucket_mb": summary(r),
                            "max_allocated": r["max_allocated"],
                            "launches": r["launches"]} for r in ranks}
    med = per_rank[0]["by_bucket_mb"][str(spec["mbs"][0])]["median_step_s"]
    return {
        "phase": "dp_slice", "model": ("GPT tiny" if spec["model"] == "tiny"
                                       else "GPT-3 1.3B"),
        "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "heads": cfg.num_heads,
        "amp": "O1 bfloat16, fp32 parameters", "batch": [spec["rows"],
                                                         spec["seq"]],
        "rows_a_rank": spec["rows"] // 2, "world": 2,
        "backend": ranks[0]["backend"],
        "backend_why": "two ranks on one card: NCCL refuses that; gloo "
                       "stages CUDA tensors through the host",
        "steps": nsteps, "bytes_reduced": ranks[0]["bytes_reduced"],
        "per_rank": per_rank, "rss_peak_sampled": rss,
        "tokens_per_s": tokens / med,
        "elastic_layers": elastic["layers"] if elastic else None,
        "elastic_world2_step_s": world2,
        "elastic_world2_median_s": (statistics.median(world2)
                                    if world2 else None),
        "world1_step_s": statistics.median(walls[1:]),
        "losses": losses, "world1_losses": world1,
        "max_abs_loss_dev": dev, "loss_tolerance": loss_tol,
        "final_params_rel_dev": param_rel, "param_tolerance": param_tol,
        "world1_last_update_rel": step_rel,
        "collectives_on_device": {r["rank"]: r["collectives"]
                                  for r in ranks},
        "launches": launches, "ranks_s": ranks_s,
    }


# cp_slice (GPT-3 1.3B, bf16 O1, lr 1e-4, two sep ranks over gloo, each on
# half of every row): the ranks against a world-1 run of the same four
# steps on the same global batches. On an H100 the ring's losses read
# 1.9e-4 apart and its final parameters 5.1e-4 apart (relative), where the
# world-1 run's last update moves them 2.2e-3: each ring chunk's output is
# rounded to bf16 before the fp32 merge. The parameter bound must stay
# under the last update's move (checked in the run): a lost or repeated
# update is a whole one
CP_SLICE_LOSS_TOL = 1e-3
CP_SLICE_PARAM_TOL = 1e-3
CP_MODES = ("ring", "ulysses")


def _cp_want(mode, layers, steps):
    """Launches over both ranks of one mode's steps: the ring runs a causal
    diagonal chunk on each rank and rank 1's one past chunk (rank 0's only
    other chunk is in its future: skipped), so 3 of each flash kernel a
    layer and step; Ulysses one full-sequence attention a rank, 2; AdamW's
    fp32 form once a step and rank."""
    n = {"ring": 3, "ulysses": 2}[mode] * layers * steps
    return {"flash_fwd": n, "flash_dq": n, "flash_dkv": n, "adamw": 2 * steps}


def _cp_model(torch, spec, device, mode):
    """_elastic_model with GPT's sequence_parallel = mode (`None`: the
    world-1 run on the whole sequence)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    cfg.num_layers = spec.get("layers", cfg.num_layers)
    cfg.sequence_parallel = mode
    model = GPTForCausalLM(cfg, device=device, seed=spec["seed"])
    opt = AdamW(spec["lr"], parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(spec["clip"]))
    amp_on = bool(spec.get("amp"))

    def loss_fn(ids):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    return model, opt, loss_fn


def cp_rank_main(spec):
    """One sequence-parallel rank as a process of its own (distributed.spawn
    imports this module in the child): init_parallel_env under
    PADDLE_DISTRI_BACKEND=spec["backend"] (gloo: both ranks are on the one
    card), fleet.init at sep_degree 2, then for each mode of CP_MODES the
    seeded model (the same initial bits in every mode, checked) through
    TrainStep(dp_axis="dp"): `steps` steps on the global batches, the
    first a warm-up. Each rank computes half of every row; the exchanges
    (ring permutes, Ulysses all-to-alls) take collective.py's host-staged
    gloo route. After every step the flat buffers' bit sums go through the
    store and must equal the other rank's. Returns, a mode, the steps
    (wall, parts, loss, the exchange's calls, bytes and seconds), launches,
    peak memory; rank 0 dumps each mode's final parameters."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    os.environ["PADDLE_DISTRI_BACKEND"] = spec["backend"]
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import gpu

    device = spec.get("device", "cuda")
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t_start = time.perf_counter()
    dist.init_parallel_env(device=None if on_card else "cpu")
    import torch.distributed as tdist

    backend = tdist.get_backend()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["sep_degree"] = 2
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_sep_parallel_group()
    rank = dist.get_rank()
    store = denv.get_store()
    batches = _elastic_batches(spec)
    route = collective.transport(torch.empty(1, device=device), group)
    out = {"rank": rank, "pid": os.getpid(), "backend": backend,
           "transport": route, "sep_rank": group.rank,
           "sep_ranks": group.ranks, "modes": {}}
    init_sums = None
    for mode in CP_MODES:
        model, opt, loss_fn = _cp_model(torch, spec, device, mode)
        sums0 = bit_sums(torch, [p.detach() for p in model.parameters()])
        if init_sums is not None and sums0 != init_sums:
            raise AssertionError(f"{mode}: initial weights differ from "
                                 f"{CP_MODES[0]}'s")
        init_sums = sums0
        # no comm-only reduce probe (a second 5.26 GB sum in the warm-up):
        # the step's parts time the sum itself
        step = TrainStep(model, loss_fn, opt, device=device, dp_axis="dp",
                         telemetry=True, reduce_probe=False)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        steps = []
        gpu.reset_launch_counts()
        for s in range(spec["steps"]):
            collective.reset_transport_stats()
            t0 = time.perf_counter()
            loss = float(step(*batches[s % len(batches)]))
            wall = time.perf_counter() - t0
            ex = collective.transport_stats()
            sums = _dp_flat_sums(torch, opt)
            key = f"/pt/cp_slice/{mode}/{s}"
            store.set(f"{key}/{rank}", json.dumps(sums))
            other = json.loads(bytes(store.get(
                f"{key}/{1 - rank}", timeout_s=600)).decode())
            if other != sums:
                raise AssertionError(f"{mode} step {s}: the ranks' flat "
                                     f"buffers differ: {sums} against "
                                     f"{other}")
            steps.append({"step": s, "warmup": s == 0, "loss": loss,
                          "wall_s": wall, "parts_s": dict(step.last_parts),
                          "exchange": ex})
        launches = gpu.launch_counts(DP)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if rank == 0 and spec.get("dump"):
            _dump_params(model, f"{spec['dump']}.{mode}")
        out["modes"][mode] = {
            "setup_s": setup_s, "steps": steps, "launches": launches,
            "max_allocated": peak,
            "grad_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}
        del model, opt, step, loss_fn
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_start = time.perf_counter()
    store.barrier("cp_slice_done")      # rank 0 hosts the store
    return out


def cp_slice_phase(torch, device="cuda", spec=None):
    """GPT-3 1.3B at full width, cut to RANK_LAYERS since mp_slice joined
    the script (fp32 parameters, amp O1, AdamW's
    fused fp32 form, a global-norm clip), global batch 4 x 2048, context-
    parallel over two sep rank processes on the one card (distributed.spawn,
    init_parallel_env, fleet.init at sep_degree 2): each rank computes
    [4, 1024], through TrainStep(dp_axis="dp") with GPT's
    sequence_parallel 'ring' and then 'ulysses' in the same processes
    from the same initial weights, a warm-up and three timed steps each.
    The backend is gloo (NCCL refuses two ranks on one device), and the
    K/V permutes and all-to-alls take collective.py's stated host route,
    "host-staged gloo". Reports, a mode, each rank's step wall split into
    fwd+bwd (the exchanges inside), the wait for the sep gradient sum and
    apply; the exchange's calls, bytes, seconds and MB/s with the
    transport named; peak device memory and sampled RSS a rank; flash and
    AdamW launches summed over the ranks, which must be `_cp_want`'s. The
    ranks' flat buffers must be bitwise equal after every step; then a
    world-1 TrainStep at sep=1 runs the same four steps on the card on the
    whole batch from the same weights: each mode's losses within
    CP_SLICE_LOSS_TOL, rank 0's final parameters within CP_SLICE_PARAM_TOL
    (|p - p1| / |p1|), a bound that must sit below the world-1 run's last
    update."""
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig

    spec = dict(spec or dict(
        model="gpt3_1p3b", amp=True, rows=4, seq=2048, lr=1e-4, seed=SEED,
        n_batches=4, clip=1.0, steps=4, layers=RANK_LAYERS))
    spec.setdefault("backend", "gloo")
    spec["device"] = device
    nsteps = spec["steps"]
    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.num_layers = spec.get("layers", cfg.num_layers)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cp_slice_")
    free = shutil.disk_usage(tmp).free
    if free < 1.2 * len(CP_MODES) * 4 * gpt_numel(cfg):
        shutil.rmtree(tmp)
        raise RuntimeError(f"{free} bytes free under {tmp}: the parameter "
                           "dumps do not fit")
    spec["dump"] = os.path.join(tmp, "rank0.params")
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    t0 = time.perf_counter()
    sampler = None
    try:
        ctx = spawn(cs.cp_rank_main, args=(spec,), nprocs=2, join=False,
                    backend="cuda" if device == "cuda" else "cpu")
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {f"rank{r}": p.pid for r, p in enumerate(ctx.processes)},))
        sampler.start()
        try:
            ranks = ctx.join(900)
        finally:
            for p in ctx.processes:
                if p.poll() is None:
                    p.kill()
            stop.set()
            sampler.join()
        ranks_s = time.perf_counter() - t0

        # the world-1 run: sep=1, the same steps on the same global batches
        model, opt, loss_fn = _cp_model(torch, spec, device, None)
        step = TrainStep(model, loss_fn, opt, device=device)
        batches = _elastic_batches(spec)
        params = list(model.parameters())
        world1, walls = [], []
        for s in range(nsteps):
            if s == nsteps - 1:
                before = [p.detach().clone() for p in params]
            t1 = time.perf_counter()
            world1.append(float(step(*batches[s % len(batches)])))
            walls.append(time.perf_counter() - t1)
        step_rel = _rel_dev(torch, before, params)
        del before
        offs = np.cumsum([0] + [p.numel() for p in params])
        param_rel = {}
        for mode in CP_MODES:
            words = np.memmap(f"{spec['dump']}.{mode}", dtype=np.float32,
                              mode="r")
            if words.size != offs[-1]:
                raise AssertionError(f"rank 0 dumped {words.size} "
                                     f"parameters, the model has {offs[-1]}")
            param_rel[mode] = _rel_dev(torch, (
                torch.from_numpy(np.array(words[a:b])).to(p.device)
                .view_as(p) for p, a, b in zip(params, offs[:-1], offs[1:])),
                params)
            del words
        del model, opt, step, params
        if device == "cuda":
            release(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    per_mode = {}
    for mode in CP_MODES:
        losses = [st["loss"] for st in ranks[0]["modes"][mode]["steps"]]
        if [st["loss"] for st in ranks[1]["modes"][mode]["steps"]] != losses:
            raise AssertionError(f"{mode}: the ranks' losses differ")
        dev = max(abs(a - b) for a, b in zip(losses, world1))
        if not all(np.isfinite(losses)) or dev > CP_SLICE_LOSS_TOL \
                or not param_rel[mode] <= CP_SLICE_PARAM_TOL < step_rel:
            raise AssertionError(
                f"{mode}: losses {losses} against the world-1 run's "
                f"{world1}: {dev} (bound {CP_SLICE_LOSS_TOL}); final "
                f"parameters {param_rel[mode]} from the world-1 run's "
                f"(bound {CP_SLICE_PARAM_TOL}, which must sit below its "
                f"last update's {step_rel})")
        launches = {k: sum(r["modes"][mode]["launches"][k] for r in ranks)
                    for k in DP}
        want = _cp_want(mode, cfg.num_layers, nsteps)
        if device == "cuda" and launches != want:
            raise AssertionError(f"{mode}: launches over both ranks "
                                 f"{launches}, expected {want}")

        def summary(r):
            d = r["modes"][mode]
            timed = [st for st in d["steps"] if not st["warmup"]]
            ex = [sum(v["bytes"] for v in st["exchange"].values())
                  for st in timed]
            ex_s = [sum(v["seconds"] for v in st["exchange"].values())
                    for st in timed]
            calls = {k: v["calls"] for k, v in timed[0]["exchange"].items()}
            return {
                "setup_s": d["setup_s"],
                "step_s": [st["wall_s"] for st in timed],
                "median_step_s": statistics.median(st["wall_s"]
                                                   for st in timed),
                "median_parts_s": {
                    k: statistics.median(st["parts_s"][k] for st in timed)
                    for k in timed[0]["parts_s"]},
                "warmup_s": d["steps"][0]["wall_s"],
                "exchange_calls_a_step": calls,
                "exchange_bytes_a_step": ex[0],
                "median_exchange_s": statistics.median(ex_s),
                "exchange_mb_per_s": ex[0] / statistics.median(ex_s) / 1e6,
                "sum_gb_per_s": d["grad_bytes"] / statistics.median(
                    st["parts_s"]["reduce_wait_s"] for st in timed) / 1e9,
                "max_allocated": d["max_allocated"],
                "launches": d["launches"]}

        per_rank = {r["rank"]: summary(r) for r in ranks}
        med = per_rank[0]["median_step_s"]
        per_mode[mode] = {
            "per_rank": per_rank, "losses": losses,
            "tokens_per_s": spec["rows"] * spec["seq"] / med,
            "max_abs_loss_dev": dev, "final_params_rel_dev": param_rel[mode],
            "launches": launches, "want": want}
    return {
        "phase": "cp_slice", "model": ("GPT tiny" if spec["model"] == "tiny"
                                       else "GPT-3 1.3B"),
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_heads,
        "amp": ("O1 bfloat16, fp32 parameters" if spec.get("amp")
                else "off, fp32"),
        "batch": [spec["rows"], spec["seq"]],
        "a_rank": [spec["rows"], spec["seq"] // 2], "sep": 2,
        "backend": ranks[0]["backend"], "transport": ranks[0]["transport"],
        "transport_why": "two ranks on one card: NCCL refuses that, and "
                         "gloo refuses all_to_all and send/recv of CUDA "
                         "tensors; the exchanges stage through pinned host "
                         "memory, the kernels stay on the card",
        "sep_group": ranks[0]["sep_ranks"], "steps": nsteps,
        "modes": per_mode, "rss_peak_sampled": rss,
        "world1_step_s": statistics.median(walls[1:]),
        "world1_losses": world1, "loss_tolerance": CP_SLICE_LOSS_TOL,
        "param_tolerance": CP_SLICE_PARAM_TOL,
        "world1_last_update_rel": step_rel, "ranks_s": ranks_s,
    }


# mp_slice (GPT-3 1.3B, bf16 O1, lr 1e-4, two mp ranks over gloo, each with
# half of every sharded weight and the whole batch): the ranks against a
# world-1 run of the same four steps on the same batches. The rows' partial
# products are rounded to bf16 before their sum (the world-1 product
# rounds once), so the bounds are cp_slice's; the parameter bound must stay
# under the world-1 run's last update (checked in the run)
MP_SLICE_LOSS_TOL = 1e-3
MP_SLICE_PARAM_TOL = 1e-3
# the Megatron pair at GPT's MLP widths against the dense product, fp32
# (TF32 off): sums of up to 8,192 products in another order, whose
# rounding grows as sqrt(8192) x 2^-24 (~5e-6 of max |value|, a few times
# that at the tails), |error| / max |value|
MP_PAIR_TOL = 5e-5


def _mp_pair(torch, group, device, rows=4, seq=2048, hidden=2048,
             inter=8192):
    """ColumnSequenceParallelLinear -> GELU (tanh) -> RowSequenceParallel-
    Linear on this rank's sequence shard of [rows, seq, hidden] (GPT's MLP
    widths), fp32, against the dense product on the whole input: the
    output shard and every gradient (the row bias's summed over the group,
    as TrainStep sums a sequence-parallel parameter), |error| / max
    |dense|; the pair's fwd+bwd seconds and the collectives it ran."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.fleet import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear)
    from paddle_tpu_torch.distributed.mesh import shard_block
    from paddle_tpu_torch.ops import nn_ops

    gen = torch.Generator(device=device).manual_seed(SEED + 7)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, device=device, generator=gen) * std

    x, cot = rnd(rows, seq, hidden), rnd(rows, seq, hidden)
    dense = [rnd(hidden, inter, std=0.02), rnd(inter, std=0.02),
             rnd(inter, hidden, std=0.02), rnd(hidden, std=0.02)]
    xd = x.clone().requires_grad_(True)
    for t in dense:
        t.requires_grad_(True)
    w1, b1, w2, b2 = dense
    y = nn_ops.linear(nn_ops.gelu(nn_ops.linear(xd, w1, b1),
                                  approximate=True), w2, b2)
    (y * cot).sum().backward()
    col = ColumnSequenceParallelLinear(hidden, inter, mp_group=group,
                                       device=device)
    row = RowSequenceParallelLinear(inter, hidden, mp_group=group,
                                    device=device)
    with torch.no_grad():
        for p, t in zip((col.weight, col.bias, row.weight, row.bias), dense):
            p.copy_(shard_block(t.detach(), p))
    m = seq // group.nranks
    part = slice(group.rank * m, (group.rank + 1) * m)
    xs = x[:, part].clone().requires_grad_(True)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    collective.reset_transport_stats()
    sync()
    t0 = time.perf_counter()
    ys = row(nn_ops.gelu(col(xs), approximate=True))
    (ys * cot[:, part]).sum().backward()
    collective.all_reduce(row.bias.grad, group=group)
    sync()
    seconds = time.perf_counter() - t0
    pairs = {"y": (ys, y[:, part]), "dx": (xs.grad, xd.grad[:, part]),
             "dw1": (col.weight.grad, shard_block(w1.grad, col.weight)),
             "db1": (col.bias.grad, shard_block(b1.grad, col.bias)),
             "dw2": (row.weight.grad, shard_block(w2.grad, row.weight)),
             "db2": (row.bias.grad, b2.grad)}
    errs = {k: float((got - want).abs().max() / want.abs().max())
            for k, (got, want) in pairs.items()}
    if max(errs.values()) > MP_PAIR_TOL:
        raise AssertionError(f"the Megatron pair against the dense "
                             f"product: {errs} (bound {MP_PAIR_TOL})")
    return {"shape": [rows, seq, hidden, inter], "a_rank": [rows, m],
            "rel_err": errs, "tolerance": MP_PAIR_TOL,
            "fwd_bwd_s": seconds,
            "collectives": collective.transport_stats()}


def mp_rank_main(spec):
    """One tensor-parallel rank as a process of its own (distributed.spawn
    imports this module in the child): init_parallel_env under
    PADDLE_DISTRI_BACKEND=spec["backend"] (gloo: both ranks are on the one
    card), fleet.init at mp_degree 2, the seeded model built under the mesh
    (this rank's blocks of the whole draw), TrainStep on the global
    batches, `steps` steps, the first a warm-up. After every step the
    replicated parameters' bit sums go through the store and must equal
    the other rank's. Returns the steps (wall, parts, loss, the mp
    collectives' calls, bytes, seconds and dtypes), launches, peak memory,
    the routes of the collectives, the Megatron pair's check and the
    gloo probe; rank 0 dumps the gathered parameters."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    os.environ["PADDLE_DISTRI_BACKEND"] = spec["backend"]
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import mp_group_of
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import gather_state_dict
    from paddle_tpu_torch.ops import gpu

    device = spec.get("device", "cuda")
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t_start = time.perf_counter()
    dist.init_parallel_env(device=None if on_card else "cpu")
    import torch.distributed as tdist

    backend = tdist.get_backend()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["mp_degree"] = 2
    fleet.init(is_collective=True, strategy=strategy)
    group = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    rank = dist.get_rank()
    store = denv.get_store()
    batches = _elastic_batches(spec)
    probe = torch.empty(1, device=device)
    routes = {op: collective.transport(probe, group, op=op)
              for op in ("all_reduce", "all_gather", "reduce_scatter")}
    # built under the mesh: its mp layers hold this rank's blocks
    model, opt, loss_fn = _cp_model(torch, spec, device, None)
    opt = fleet.distributed_optimizer(opt)
    params = list(model.parameters())
    replicated = [p for p in params if mp_group_of(p) is None]
    step = TrainStep(model, loss_fn, opt, device=device, dp_axis="dp",
                     telemetry=True)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    steps = []
    gpu.reset_launch_counts()
    for s in range(spec["steps"]):
        collective.reset_transport_stats()
        t0 = time.perf_counter()
        loss = float(step(*batches[s % len(batches)]))
        wall = time.perf_counter() - t0
        ex = collective.transport_stats()
        sums = bit_sums(torch, [p.detach() for p in replicated])
        key = f"/pt/mp_slice/{s}"
        store.set(f"{key}/{rank}", json.dumps(sums))
        other = json.loads(bytes(store.get(
            f"{key}/{1 - rank}", timeout_s=600)).decode())
        if other != sums:
            raise AssertionError(f"step {s}: the ranks' replicated "
                                 f"parameters differ")
        steps.append({"step": s, "warmup": s == 0, "loss": loss,
                      "wall_s": wall, "parts_s": dict(step.last_parts),
                      "collectives": ex})
    launches = gpu.launch_counts(DP)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    local_bytes = sum(p.numel() * p.element_size() for p in params)
    gathered = gather_state_dict(model)
    if rank == 0 and spec.get("dump"):
        with open(spec["dump"], "wb") as f:
            for name, _ in model.named_parameters():
                f.write(gathered[name].tobytes())
    del gathered, model, opt, step, params, replicated, loss_fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()          # rank 0's dump done: the pair times itself
    pair = _mp_pair(torch, group, device, **spec.get("pair", {}))
    if on_card:
        torch.cuda.empty_cache()
    collectives = _dp_collectives(torch, dist, device)
    store.barrier("mp_slice_done")      # rank 0 hosts the store
    return {"rank": rank, "pid": os.getpid(), "backend": backend,
            "routes": routes, "mp_rank": group.rank, "mp_ranks": group.ranks,
            "setup_s": setup_s, "steps": steps, "launches": launches,
            "max_allocated": peak, "param_bytes": local_bytes,
            "pair": pair, "collectives_on_device": collectives}


def mp_slice_phase(torch, device="cuda", spec=None):
    """Tensor parallelism: GPT-3 1.3B at full width, RANK_LAYERS deep (fp32
    parameters, amp O1, AdamW's fused fp32 form, a global-norm clip, the
    hybrid optimizer's clip), global batch 4 x 2048, two mp rank processes
    on the one card (distributed.spawn, init_parallel_env, fleet.init at
    mp_degree 2): each holds half of every sharded weight (8 heads, half
    the MLP, half the vocabulary) and runs the whole batch, a warm-up and
    three timed steps through TrainStep. Over gloo, whose all-reduces,
    all-gathers and reduce-scatters of CUDA tensors it stages through host
    memory itself (the routes named). Reports each rank's step wall split
    into fwd+bwd (the mp all-reduces inside), the clip's square-sum (its
    mp reduce) and apply; the mp collectives' calls, bytes, seconds, GB/s
    and dtypes; peak device memory and sampled RSS a rank; flash and AdamW
    launches summed over the ranks, which must be 1 of each flash kernel
    a layer, step and rank and 1 AdamW. The replicated parameters must be
    bitwise equal across the ranks after every step; then a world-1
    TrainStep runs the same four steps on the card from the same seed:
    losses within MP_SLICE_LOSS_TOL, the gathered final parameters within
    MP_SLICE_PARAM_TOL (|p - p1| / |p1|), a bound that must sit below the
    world-1 run's last update. On the ranks also: the Megatron pair at
    GPT's MLP widths against the dense product (MP_PAIR_TOL) and
    dp_slice's probe of which collectives gloo takes on CUDA tensors."""
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig

    spec = dict(spec or dict(
        model="gpt3_1p3b", amp=True, rows=4, seq=2048, lr=1e-4, seed=SEED,
        n_batches=4, clip=1.0, steps=4, layers=RANK_LAYERS))
    spec.setdefault("backend", "gloo")
    spec["device"] = device
    nsteps = spec["steps"]
    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.num_layers = spec.get("layers", cfg.num_layers)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_slice_")
    free = shutil.disk_usage(tmp).free
    if free < 1.2 * 4 * gpt_numel(cfg):
        shutil.rmtree(tmp)
        raise RuntimeError(f"{free} bytes free under {tmp}: the parameter "
                           "dump does not fit")
    spec["dump"] = os.path.join(tmp, "rank0.params")
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    t0 = time.perf_counter()
    try:
        ctx = spawn(cs.mp_rank_main, args=(spec,), nprocs=2, join=False,
                    backend="cuda" if device == "cuda" else "cpu")
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {f"rank{r}": p.pid for r, p in enumerate(ctx.processes)},))
        sampler.start()
        try:
            ranks = ctx.join(900)
        finally:
            for p in ctx.processes:
                if p.poll() is None:
                    p.kill()
            stop.set()
            sampler.join()
        ranks_s = time.perf_counter() - t0

        # the world-1 run: mp=1, the same steps on the same batches
        model, opt, loss_fn = _cp_model(torch, spec, device, None)
        step = TrainStep(model, loss_fn, opt, device=device)
        batches = _elastic_batches(spec)
        params = list(model.parameters())
        world1, walls = [], []
        for s in range(nsteps):
            if s == nsteps - 1:
                before = [p.detach().clone() for p in params]
            t1 = time.perf_counter()
            world1.append(float(step(*batches[s % len(batches)])))
            walls.append(time.perf_counter() - t1)
        step_rel = _rel_dev(torch, before, params)
        del before
        words = np.memmap(spec["dump"], dtype=np.float32, mode="r")
        offs = np.cumsum([0] + [p.numel() for p in params])
        if words.size != offs[-1]:
            raise AssertionError(f"rank 0 dumped {words.size} parameters, "
                                 f"the model has {offs[-1]}")
        param_rel = _rel_dev(torch, (
            torch.from_numpy(np.array(words[a:b])).to(p.device).view_as(p)
            for p, a, b in zip(params, offs[:-1], offs[1:])), params)
        del words, model, opt, step, params
        if device == "cuda":
            release(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [st["loss"] for st in ranks[0]["steps"]]
    if [st["loss"] for st in ranks[1]["steps"]] != losses:
        raise AssertionError("the ranks' losses differ")
    dev = max(abs(a - b) for a, b in zip(losses, world1))
    if not all(np.isfinite(losses)) or dev > MP_SLICE_LOSS_TOL \
            or not param_rel <= MP_SLICE_PARAM_TOL < step_rel:
        raise AssertionError(
            f"losses {losses} against the world-1 run's {world1}: {dev} "
            f"(bound {MP_SLICE_LOSS_TOL}); final parameters {param_rel} "
            f"from the world-1 run's (bound {MP_SLICE_PARAM_TOL}, which "
            f"must sit below its last update's {step_rel})")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in DP}
    want = {k: (1 if k == "adamw" else cfg.num_layers) * nsteps * 2
            for k in DP}
    if device == "cuda" and launches != want:
        raise AssertionError(f"launches over both ranks {launches}, "
                             f"expected {want}")

    def summary(r):
        timed = [st for st in r["steps"] if not st["warmup"]]
        kinds = timed[0]["collectives"]
        ex_s = [sum(v["seconds"] for v in st["collectives"].values())
                for st in timed]
        nbytes = sum(v["bytes"] for v in kinds.values())
        return {
            "setup_s": r["setup_s"],
            "step_s": [st["wall_s"] for st in timed],
            "median_step_s": statistics.median(st["wall_s"] for st in timed),
            "median_parts_s": {
                k: statistics.median(st["parts_s"][k] for st in timed)
                for k in timed[0]["parts_s"]},
            "warmup_s": r["steps"][0]["wall_s"],
            "collectives_a_step": {
                k: {"calls": v["calls"], "bytes": v["bytes"],
                    "dtypes": v.get("dtypes", {}),
                    "gb_per_s": v["bytes"] / v["seconds"] / 1e9
                    if v["seconds"] else None}
                for k, v in kinds.items()},
            "collective_bytes_a_step": nbytes,
            "median_collective_s": statistics.median(ex_s),
            "collective_gb_per_s": nbytes / statistics.median(ex_s) / 1e9,
            "max_allocated": r["max_allocated"],
            "param_bytes": r["param_bytes"], "launches": r["launches"]}

    per_rank = {r["rank"]: summary(r) for r in ranks}
    med = per_rank[0]["median_step_s"]
    return {
        "phase": "mp_slice", "model": ("GPT tiny" if spec["model"] == "tiny"
                                       else "GPT-3 1.3B"),
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_heads, "heads_a_rank": cfg.num_heads // 2,
        "amp": ("O1 bfloat16, fp32 parameters" if spec.get("amp")
                else "off, fp32"),
        "batch": [spec["rows"], spec["seq"]], "mp": 2,
        "backend": ranks[0]["backend"], "routes": ranks[0]["routes"],
        "routes_why": "two ranks on one card: NCCL refuses that; gloo's "
                      "own collectives copy CUDA tensors through host "
                      "memory, the kernels stay on the card",
        "mp_group": ranks[0]["mp_ranks"], "steps": nsteps,
        "per_rank": per_rank, "rss_peak_sampled": rss,
        "tokens_per_s": spec["rows"] * spec["seq"] / med,
        "losses": losses, "world1_losses": world1,
        "world1_step_s": statistics.median(walls[1:]),
        "max_abs_loss_dev": dev, "loss_tolerance": MP_SLICE_LOSS_TOL,
        "final_params_rel_dev": param_rel,
        "param_tolerance": MP_SLICE_PARAM_TOL,
        "world1_last_update_rel": step_rel, "launches": launches,
        "want": want,
        "pair": {r["rank"]: r["pair"] for r in ranks},
        "collectives_on_device": {r["rank"]: r["collectives_on_device"]
                                  for r in ranks},
        "ranks_s": ranks_s,
    }


ZERO_SLICE_LOSS_TOL = 1e-3
ZERO_SLICE_PARAM_TOL = 5e-4
# the bytes a rank allocates between steps, against a stage's bytes a
# parameter at two ranks (fp32: os 4 + 4 + 8/2, os_g 4 + 12/2, p_g_os 16/2)
# plus the batch; the excess is each unit's padding to 2 x 64 elements and
# whatever else the step keeps
ZERO_BYTES_TOL = 0.03
ZERO_LEVELS = {"os": 12, "os_g": 10, "p_g_os": 8}


def _zero_unit_bytes(torch, cfg):
    """fp32 bytes of the embeddings (wte and wpe) and of one block, the two
    largest stage-3 units of GPT (the final norm is 2 x hidden)."""
    H = cfg.hidden_size
    emb = (cfg.vocab_size + cfg.max_position_embeddings) * H
    block = (gpt_numel(cfg) - emb - 2 * H) // cfg.num_layers
    return 4 * emb, 4 * block


def _digests(state):
    """blake2b of every tensor leaf's bytes, by its path in `state`."""
    import hashlib

    import numpy as np

    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif hasattr(x, "shape") and len(x.shape):
            a = np.ascontiguousarray(x.detach().cpu().numpy()
                                     if hasattr(x, "detach") else x)
            out[prefix] = hashlib.blake2b(a.tobytes()).hexdigest()

    walk("", state)
    return out


def _zero_save(torch, model, opt, path):
    """Save the stage's model and optimizer by save_group_sharded_model
    (async_save=True) and wait_all into `path`: the seconds; the digests
    of the ranks' gathered state (state_dict, through the gather that
    wrote the rows); and, apart from any gather, each group's units
    (parameter names, padded length, chunk) and the bit sums of this
    rank's own shard buffers (parameters, m and v), which the parent
    holds against the same chunks of what it reads back."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ck

    t0 = time.perf_counter()
    dist.save_group_sharded_model(model, path, opt, async_save=True)
    returned_s = time.perf_counter() - t0
    ck.wait_all()
    save_s = time.perf_counter() - t0
    names = {id(p): n for n, p in model.named_parameters()}
    groups = [{"units": [{"params": [(names[id(p)], opt._names[id(p)])
                                     for p in u.params],
                          "padded": u.padded, "chunk": u.chunk}
                         for u in g.units],
               "sums": bit_sums(torch, [g.p, g.m, g.v])}
              for g in opt._groups]
    return {"async_returned_s": returned_s, "saved_s": save_s,
            "digests": _digests({"model": dict(model.state_dict()),
                                 "optimizer": opt.state_dict()}),
            "groups": groups}


def _shard_sums(torch, whole, units, rank):
    """The bit sums of rank `rank`'s chunks of `units` (one group's, as
    _zero_save lists them), rebuilt from the whole state read back:
    parameters, m and v."""
    import numpy as np

    out = []
    for leaf in ("model", "moment1", "moment2"):
        parts = []
        for u in units:
            flat = torch.zeros(u["padded"], dtype=torch.float32)
            at = 0
            for name, key in u["params"]:
                x = whole["model"][name] if leaf == "model" \
                    else whole["optimizer"][f"{key}.{leaf}"]
                x = torch.as_tensor(np.asarray(x)).reshape(-1)
                flat[at:at + x.numel()] = x
                at += x.numel()
            parts.append(flat[rank * u["chunk"]:(rank + 1) * u["chunk"]])
        out.append(bit_sums(torch, [torch.cat(parts)])[0])
    return out


def _zero_stage(torch, spec, level, layers, nsteps, group, store, rank,
                device, dump, ckpt=None):
    """One stage on this rank (see zero_rank_main); with `ckpt`, saved
    there after its steps (_zero_save)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import gpu

    on_card = device == "cuda"
    t0 = time.perf_counter()
    model, opt, loss_fn = _cp_model(torch, dict(spec, layers=layers),
                                    device, None)
    n_params = sum(p.numel() for p in model.parameters())
    model, opt, _ = dist.group_sharded_parallel(model, opt, level,
                                                group=group)
    step = TrainStep(model, loss_fn, opt, device=device, telemetry=True)
    zero = opt._zero
    batches = _elastic_batches(spec)
    batch_bytes = 8 * spec["rows"] * spec["seq"]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    gpu.reset_launch_counts()
    steps = []
    for s in range(nsteps):
        collective.reset_transport_stats()
        t1 = time.perf_counter()
        loss = float(step(*batches[s % len(batches)]))
        wall = time.perf_counter() - t1
        ex = collective.transport_stats()
        held = workspaces = 0
        if on_card:
            # cuBLAS's workspaces (a handle and stream's each, taken from
            # the caching allocator by the first products) are counted as
            # allocated: freed here and measured apart; the next product
            # takes them again
            torch.cuda.synchronize()
            raw = torch.cuda.memory_allocated()
            torch._C._cuda_clearCublasWorkspaces()
            held = torch.cuda.memory_allocated()
            workspaces = raw - held
        if level != "p_g_os":
            sums = bit_sums(torch, [g.full_p for g in opt._groups])
            key = f"/pt/zero_slice/{level}/{s}"
            store.set(f"{key}/{rank}", json.dumps(sums))
            other = json.loads(bytes(store.get(
                f"{key}/{1 - rank}", timeout_s=600)).decode())
            if other != sums:
                raise AssertionError(f"{level} step {s}: the ranks' "
                                     f"parameters differ")
        steps.append({"step": s, "warmup": s == 0, "loss": loss,
                      "wall_s": wall, "parts_s": dict(step.last_parts),
                      "collectives": ex, "allocated_between_steps": held,
                      "cublas_workspace_bytes": workspaces})
    launches = gpu.launch_counts(DP)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    saved = None if ckpt is None else _zero_save(torch, model, opt, ckpt)
    t2 = time.perf_counter()
    with zero.gathered():
        if rank == 0:
            with open(dump, "wb") as f:
                for p in model.parameters():
                    # a copy: a CPU tensor's numpy view would pin the
                    # gathered storage, which the release frees
                    f.write(p.detach().float().to("cpu", copy=True)
                            .numpy().tobytes())
    dump_s = time.perf_counter() - t2
    padded = sum(u.padded for g in opt._groups for u in g.units)
    del model, opt, step, zero, loss_fn
    gc.collect()
    want = ZERO_LEVELS[level] * n_params + batch_bytes
    held = [st["allocated_between_steps"] for st in steps]
    if on_card and not all(abs(h - want) <= ZERO_BYTES_TOL * want
                           for h in held):
        raise AssertionError(f"{level}: {held} bytes allocated between "
                             f"steps (cuBLAS's workspaces apart), "
                             f"expected {want} within {ZERO_BYTES_TOL}")
    if on_card:
        torch.cuda.empty_cache()
    print(f"zero_slice rank {rank}: {level} done", file=sys.stderr,
          flush=True)
    return {"level": level, "layers": layers, "n_params": n_params,
            "padded_elements": padded, "setup_s": setup_s, "steps": steps,
            "launches": launches, "max_allocated": peak,
            "bytes_per_param": ZERO_LEVELS[level], "want_bytes": want,
            "allocated_between_steps": held,
            "cublas_workspace_bytes": [st["cublas_workspace_bytes"]
                                       for st in steps], "dump_s": dump_s,
            "checkpoint": saved}


def zero_rank_main(spec):
    """One ZeRO sharding rank as a process of its own (distributed.spawn
    imports this module in the child): init_parallel_env under
    PADDLE_DISTRI_BACKEND=spec["backend"] (gloo: both ranks are on the one
    card), fleet.init at sharding_degree 2, then each stage of
    spec["stages"] ((level, layers, steps)): the seeded model and AdamW
    through group_sharded_parallel over the hybrid group's sharding group
    and TrainStep on the global batches, the first step a warm-up. At os
    and os_g the parameters' bit sums go through the store after every
    step and must equal the other rank's. Rank 0 dumps each stage's final
    (gathered) parameters. The os_g stage's model and optimizer are saved
    after its steps by save_group_sharded_model(async_save=True) and
    wait_all into spec["ckpt"] (_zero_save), for the parent's read."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    os.environ["PADDLE_DISTRI_BACKEND"] = spec["backend"]
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.distributed import fleet

    device = spec.get("device", "cuda")
    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t_start = time.perf_counter()
    dist.init_parallel_env(device=None if on_card else "cpu")
    import torch.distributed as tdist

    backend = tdist.get_backend()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["sharding_degree"] = 2
    fleet.init(is_collective=True, strategy=strategy)
    group = fleet.get_hybrid_communicate_group().get_sharding_parallel_group()
    rank = dist.get_rank()
    store = denv.get_store()
    probe = torch.empty(1, device=device)
    routes = {op: collective.transport(probe, group, op=op)
              for op in ("all_gather", "reduce_scatter", "all_reduce")}
    init_s = time.perf_counter() - t_start
    stages = [_zero_stage(torch, spec, level, layers, nsteps, group, store,
                          rank, device, f"{spec['dump']}.{level}",
                          spec["ckpt"] if level == "os_g" else None)
              for level, layers, nsteps in spec["stages"]]
    saved = [st.pop("checkpoint") for st in stages]
    store.barrier("zero_slice_done")    # rank 0 hosts the store
    return {"rank": rank, "pid": os.getpid(), "backend": backend,
            "routes": routes, "sharding_ranks": group.ranks,
            "init_s": init_s, "stages": stages,
            "checkpoint": next(c for c in saved if c is not None)}


def zero_slice_phase(torch, device="cuda", spec=None):
    """ZeRO: GPT-3 1.3B at full width (fp32 parameters, amp O1, AdamW's
    fused fp32 form, a global-norm clip of 1.0), global batch 4 x 2048,
    two sharding rank processes on the card (zero_rank_main), each on
    [2, 2048] of every step: stages os and os_g at RANK_LAYERS (a warm-up
    and three timed steps), p_g_os at ZERO_STAGE3_LAYERS (a warm-up and
    two). Over
    gloo, whose own reduce-scatters and all-gathers of CUDA buffers stage
    through host memory (the routes named). Reports each rank's step wall
    split into fwd+bwd (stage 3's gathers and reduce-scatters inside),
    reduce-scatter, square-sum, AdamW and all-gather; the collectives'
    calls, bytes, seconds, GB/s and dtypes; bytes allocated between steps
    (cuBLAS's workspaces freed and measured apart; within ZERO_BYTES_TOL
    of 12, 10 and 8 bytes a parameter and the batch), peak device memory
    and sampled RSS; stage 3's peak of live
    gathered bytes (at most the embeddings' and one block's); flash and
    AdamW launches summed over the ranks, 1 of each flash kernel a layer,
    step and rank and 1 AdamW a step and rank. Each stage against a
    world-1 TrainStep from the same seed on the whole batches: losses
    within ZERO_SLICE_LOSS_TOL, the final parameters within
    ZERO_SLICE_PARAM_TOL relative, a bound below the world-1 run's last
    update. Then the os_g stage's async checkpoint, read back here by
    load_sharded(target_world_size=1): every leaf's digest equal to the
    ranks' gathered state's, and each rank's chunks of it bitwise its own
    shard buffers (parameters, m and v; bit sums)."""
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig

    spec = dict(spec or dict(
        model="gpt3_1p3b", amp=True, rows=4, seq=2048, lr=1e-4, seed=SEED,
        n_batches=4, clip=1.0,
        stages=[("os", RANK_LAYERS, 4), ("os_g", RANK_LAYERS, 4),
                ("p_g_os", ZERO_STAGE3_LAYERS, 3)]))
    spec.setdefault("backend", "gloo")
    spec["device"] = device
    base = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()

    def cfg_at(layers):
        cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
            else GPTConfig.gpt3_1p3b()
        cfg.num_layers = layers
        return cfg

    tmp = tempfile.mkdtemp(prefix="chip_smoke_zero_slice_")
    need = 4 * sum(gpt_numel(cfg_at(layers)) for _, layers, _ in
                   spec["stages"]) + 12 * gpt_numel(cfg_at(RANK_LAYERS))
    free = shutil.disk_usage(tmp).free
    if free < 1.2 * need:
        shutil.rmtree(tmp)
        raise RuntimeError(f"{free} bytes free under {tmp}: the dumps and "
                           f"the checkpoint ({need} bytes) do not fit")
    spec["dump"] = os.path.join(tmp, "rank0.params")
    spec["ckpt"] = os.path.join(tmp, "ckpt")
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    t0 = time.perf_counter()
    try:
        ctx = spawn(cs.zero_rank_main, args=(spec,), nprocs=2, join=False,
                    backend="cuda" if device == "cuda" else "cpu")
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {f"rank{r}": p.pid for r, p in enumerate(ctx.processes)},))
        sampler.start()
        try:
            ranks = ctx.join(900)
        finally:
            for p in ctx.processes:
                if p.poll() is None:
                    p.kill()
            stop.set()
            sampler.join()
        ranks_s = time.perf_counter() - t0

        # the checkpoint, read back whole in this process
        t1 = time.perf_counter()
        whole = ck.load_sharded(spec["ckpt"], target_world_size=1)
        load_s = time.perf_counter() - t1
        got = _digests(whole)
        digests = ranks[0]["checkpoint"]["digests"]
        if got != digests or ranks[1]["checkpoint"]["digests"] != digests:
            bad = sorted(k for k in set(got) | set(digests)
                         if got.get(k) != digests.get(k))
            raise AssertionError(f"the checkpoint read back differs from "
                                 f"the ranks' state at {bad[:5]}")
        # and each rank's own shard buffers, which no gather touched
        for r in ranks:
            for i, g in enumerate(r["checkpoint"]["groups"]):
                want = _shard_sums(torch, whole, g["units"], r["rank"])
                if want != g["sums"]:
                    raise AssertionError(
                        f"rank {r['rank']}'s shard of group {i} (bit sums "
                        f"of parameters, m, v {g['sums']}) differs from "
                        f"its chunks of the checkpoint read back {want}")
        del whole

        # each stage against world 1 (os and os_g share one run: the same
        # depth, seed, batches and steps)
        world1 = {}
        for level, layers, nsteps in spec["stages"]:
            key = (layers, nsteps)
            if key not in world1:
                model, opt, loss_fn = _cp_model(
                    torch, dict(spec, layers=layers), device, None)
                step = TrainStep(model, loss_fn, opt, device=device)
                batches = _elastic_batches(spec)
                params = list(model.parameters())
                losses, walls = [], []
                for s in range(nsteps):
                    if s == nsteps - 1:
                        before = [p.detach().clone() for p in params]
                    t1 = time.perf_counter()
                    losses.append(float(step(*batches[s % len(batches)])))
                    walls.append(time.perf_counter() - t1)
                step_rel = _rel_dev(torch, before, params)
                del before
                world1[key] = {"losses": losses, "step_s": walls,
                               "last_update_rel": step_rel,
                               "params": params, "model": model}
            w = world1[key]
            params = w["params"]
            words = np.memmap(f"{spec['dump']}.{level}", dtype=np.float32,
                              mode="r")
            offs = np.cumsum([0] + [p.numel() for p in params])
            if words.size != offs[-1]:
                raise AssertionError(f"{level}: rank 0 dumped {words.size} "
                                     f"parameters, the model has "
                                     f"{offs[-1]}")
            w[level] = _rel_dev(torch, (
                torch.from_numpy(np.array(words[a:b])).to(p.device)
                .view_as(p) for p, a, b in zip(params, offs[:-1], offs[1:])),
                params)
            del words
        for w in world1.values():
            del w["params"], w["model"]
        if device == "cuda":
            release(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    emb_b, block_b = _zero_unit_bytes(torch, base)
    gathered_bound = emb_b + block_b
    rows = {}
    for i, (level, layers, nsteps) in enumerate(spec["stages"]):
        per = [r["stages"][i] for r in ranks]
        w = world1[(layers, nsteps)]
        losses = [st["loss"] for st in per[0]["steps"]]
        if [st["loss"] for st in per[1]["steps"]] != losses:
            raise AssertionError(f"{level}: the ranks' losses differ")
        dev = max(abs(a - b) for a, b in zip(losses, w["losses"]))
        param_rel = w[level]
        if not all(np.isfinite(losses)) or dev > ZERO_SLICE_LOSS_TOL \
                or not param_rel <= ZERO_SLICE_PARAM_TOL \
                < w["last_update_rel"]:
            raise AssertionError(
                f"{level}: losses {losses} against the world-1 run's "
                f"{w['losses']}: {dev} (bound {ZERO_SLICE_LOSS_TOL}); final "
                f"parameters {param_rel} from the world-1 run's (bound "
                f"{ZERO_SLICE_PARAM_TOL}, which must sit below its last "
                f"update's {w['last_update_rel']})")
        launches = {k: sum(r["launches"][k] for r in per) for k in DP}
        want = {k: (1 if k == "adamw" else layers) * nsteps * 2 for k in DP}
        if device == "cuda" and launches != want:
            raise AssertionError(f"{level}: launches over both ranks "
                                 f"{launches}, expected {want}")
        peaks = [st["parts_s"].get("gathered_peak_bytes", 0)
                 for r in per for st in r["steps"]]
        if level == "p_g_os" and device == "cuda" and \
                max(peaks) > gathered_bound:
            raise AssertionError(f"p_g_os: {max(peaks)} live gathered "
                                 f"bytes, more than the embeddings' and "
                                 f"one block's {gathered_bound}")

        def summary(r):
            timed = [st for st in r["steps"] if not st["warmup"]]
            kinds = timed[0]["collectives"]
            ex_s = [sum(v["seconds"] for v in st["collectives"].values())
                    for st in timed]
            nbytes = sum(v["bytes"] for v in kinds.values())
            held = r["allocated_between_steps"]
            return {
                "setup_s": r["setup_s"], "dump_s": r["dump_s"],
                "step_s": [st["wall_s"] for st in timed],
                "median_step_s": statistics.median(
                    st["wall_s"] for st in timed),
                "median_parts_s": {
                    k: statistics.median(st["parts_s"][k] for st in timed)
                    for k in timed[0]["parts_s"]},
                "warmup_s": r["steps"][0]["wall_s"],
                "collectives_a_step": {
                    k: {"calls": v["calls"], "bytes": v["bytes"],
                        "dtypes": v.get("dtypes", {}),
                        "gb_per_s": v["bytes"] / v["seconds"] / 1e9
                        if v["seconds"] else None}
                    for k, v in kinds.items()},
                "collective_bytes_a_step": nbytes,
                "median_collective_s": statistics.median(ex_s),
                "collective_gb_per_s": nbytes / statistics.median(ex_s)
                / 1e9 if statistics.median(ex_s) else None,
                "allocated_between_steps": held,
                "cublas_workspace_bytes": r["cublas_workspace_bytes"],
                "want_bytes": r["want_bytes"],
                "excess_bytes": max(held) - r["want_bytes"],
                "max_allocated": r["max_allocated"],
                "launches": r["launches"]}

        per_rank = {r["rank"]: summary(r["stages"][i]) for r in ranks}
        rows[level] = {
            "layers": layers, "steps": nsteps,
            "n_params": per[0]["n_params"],
            "padded_elements": per[0]["padded_elements"],
            "bytes_per_param": per[0]["bytes_per_param"],
            "per_rank": per_rank, "losses": losses,
            "world1_losses": w["losses"],
            "world1_step_s": statistics.median(w["step_s"][1:]),
            "tokens_per_s": spec["rows"] * spec["seq"]
            / per_rank[0]["median_step_s"],
            "max_abs_loss_dev": dev, "final_params_rel_dev": param_rel,
            "world1_last_update_rel": w["last_update_rel"],
            "launches": launches, "want": want,
            "gathered_peak_bytes": max(peaks) if level == "p_g_os"
            else None}
    return {
        "phase": "zero_slice", "model": ("GPT tiny" if spec["model"] == "tiny"
                                         else "GPT-3 1.3B"),
        "hidden": base.hidden_size,
        "amp": ("O1 bfloat16, fp32 parameters" if spec.get("amp")
                else "off, fp32"),
        "batch": [spec["rows"], spec["seq"]], "a_rank": [spec["rows"] // 2,
                                                         spec["seq"]],
        "sharding": 2, "backend": ranks[0]["backend"],
        "routes": ranks[0]["routes"],
        "routes_why": "two ranks on one card: NCCL refuses that; gloo's "
                      "own collectives copy CUDA tensors through host "
                      "memory, the kernels stay on the card",
        "sharding_group": ranks[0]["sharding_ranks"],
        "stages": rows, "rss_peak_sampled": rss,
        "loss_tolerance": ZERO_SLICE_LOSS_TOL,
        "param_tolerance": ZERO_SLICE_PARAM_TOL,
        "bytes_tolerance": ZERO_BYTES_TOL,
        "gathered_bound_bytes": gathered_bound,
        "gathered_bound_parts": {"embeddings": emb_b, "block": block_b},
        "checkpoint": {"leaves": len(digests),
                       "load_s": load_s,
                       **{k: v for k, v in ranks[0]["checkpoint"].items()
                          if k not in ("digests", "groups")}},
        "ranks_s": ranks_s,
    }


PP_SLICE_LOSS_TOL = 1e-3
PP_SLICE_PARAM_TOL = 5e-4
# the pipeline's kernels: each GPT block's flash forward, dQ and dK/dV in
# its stage's slots, AdamW's fp32 form over a rank's stage and the shared
# ends
PP = ("flash_fwd", "flash_dq", "flash_dkv", "adamw")


def _pp_run(torch, spec, vpp, store, rank, device, dump):
    """One schedule of pp_slice on this rank: the seeded GPT through
    pipeline_descs, a PipelineLayer of two stages (V = vpp chunks a rank),
    copy_weights, fleet.distributed_model and the hybrid optimizer; then
    spec["steps"] train_batch steps, the first a warm-up, the shared
    parameters' bit sums through the store after each. Rank 0 dumps the
    final parameters (state_dict, in the model's order) to `dump`."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed import pipeline as engine
    from paddle_tpu_torch.distributed.fleet import PipelineLayer
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.optimizer import AdamW

    on_card = device == "cuda"
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["pp_degree"] = 2
    strategy.pipeline_configs.update(accumulate_steps=spec["micro"],
                                     virtual_pp_degree=vpp)
    fleet.init(is_collective=True, strategy=strategy)
    t0 = time.perf_counter()
    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    cfg.num_layers = spec["layers"]
    # seeded on the card as the world-1 run is, then kept on the host: the
    # pipeline's layers are built there and each rank moves its stage over
    model = GPTForCausalLM(cfg, device=device, seed=spec["seed"]).to("cpu")
    descs, loss_fn, copy_weights = model.pipeline_descs()
    pl = PipelineLayer(descs, num_stages=2, loss_fn=loss_fn,
                       num_virtual_pipeline_stages=vpp)
    copy_weights(pl)
    pp = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(AdamW(
        spec["lr"], parameters=pp.parameters(), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(spec["clip"])))
    n_params = sum(p.numel() for p in pp.parameters())
    # the parameters themselves: AdamW's first step moves their storage
    # into its flat buffers, so a tensor taken before it reads stale bits
    shared = list(pp._shared_params)
    batches = _elastic_batches(spec)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    build_s = time.perf_counter() - t0
    steps = []
    gpu.reset_launch_counts()
    for s in range(spec["steps"]):
        collective.reset_transport_stats()
        ids = torch.from_numpy(batches[s % len(batches)][0])
        t1 = time.perf_counter()
        with amp.auto_cast(enable=bool(spec.get("amp")), level="O1",
                           dtype="bfloat16"):
            loss = float(pp.train_batch((ids, ids), opt))
        wall = time.perf_counter() - t1
        st = engine.last_stats()
        between = torch.cuda.memory_allocated() if on_card else 0
        sums = bit_sums(torch, [p.detach() for p in shared])
        key = f"/pt/pp_slice/{vpp}/{s}"
        store.set(f"{key}/{rank}", json.dumps(sums))
        other = json.loads(bytes(store.get(
            f"{key}/{1 - rank}", timeout_s=600)).decode())
        if other != sums:
            raise AssertionError(f"V {vpp} step {s}: the ranks' shared "
                                 f"parameters differ")
        steps.append({"step": s, "warmup": s == 0, "loss": loss,
                      "wall_s": wall, "parts_s": dict(pp.last_parts),
                      "engine": st, "allocated_between": between,
                      "handoffs": collective.transport_stats().get(
                          "collective_permute", {})})
    launches = gpu.launch_counts(PP)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    state = pp.state_dict()          # every stage broadcast to every rank
    if rank == 0:
        copy_weights(pl, reverse=True)
        with open(dump, "wb") as f:
            for _, p in model.named_parameters():
                f.write(p.detach().float().cpu().numpy().tobytes())
    del state, pp, pl, opt, model, shared
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"vpp": vpp, "build_s": build_s, "steps": steps,
            "launches": launches, "max_allocated": peak,
            "n_params": n_params,
            "transport": collective.transport(
                torch.empty(1, device=device),
                fleet.get_hybrid_communicate_group()
                .get_pipe_parallel_group())}


def pp_rank_main(spec):
    """One pipeline stage as a process of its own (distributed.spawn
    imports this module in the child): init_parallel_env under
    PADDLE_DISTRI_BACKEND=spec["backend"] (gloo: both ranks are on the one
    card), then for each V of spec["vpps"] fleet.init at pp_degree 2 and
    _pp_run. Returns each run's steps (wall, parts, loss, the engine's
    counters and the handoffs'), launches, peak and between-step memory."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    os.environ["PADDLE_DISTRI_BACKEND"] = spec["backend"]
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env as denv

    device = spec.get("device", "cuda")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t_start = time.perf_counter()
    dist.init_parallel_env(device=None if device == "cuda" else "cpu")
    import torch.distributed as tdist

    rank = dist.get_rank()
    store = denv.get_store()
    init_s = time.perf_counter() - t_start
    runs = [_pp_run(torch, spec, vpp, store, rank, device,
                    f"{spec['dump']}.{vpp}") for vpp in spec["vpps"]]
    store.barrier("pp_slice_done")      # rank 0 hosts the store
    return {"rank": rank, "pid": os.getpid(),
            "backend": tdist.get_backend(), "init_s": init_s, "runs": runs}


def _pp_want(layers, micro, steps):
    """Launches over both ranks of one schedule's steps: every layer lives
    on one rank and runs once a microbatch (no recompute), so each flash
    kernel layers x micro a step; AdamW's fp32 form once a step and rank
    (one group over the stage and the shared ends)."""
    n = layers * micro * steps
    return {"flash_fwd": n, "flash_dq": n, "flash_dkv": n,
            "adamw": 2 * steps}


def pp_slice_phase(torch, device="cuda", spec=None):
    """Pipeline parallelism: GPT-3 1.3B at full width, PIPE_LAYERS deep
    (fp32 parameters, amp O1, AdamW's fused fp32 form, a global-norm clip
    of 1.0 through fleet's hybrid optimizer), global batch 4 x 2048 in 4
    microbatches of [1, 2048], two pp rank processes on the one card
    (distributed.spawn, init_parallel_env, fleet.init at pp_degree 2):
    GPTForCausalLM.pipeline_descs into PipelineLayer(num_stages=2),
    copy_weights, fleet.distributed_model, train_batch: a warm-up and
    three timed steps at V = 1 (the tied head makes it the interleave
    engine), then at virtual_pp_degree 2 from the same weights. The
    handoffs are collective_permutes over gloo's host route. Reports each
    rank's step wall split into the forward and backward slots' compute,
    the handoffs, the tied ends' gradient sum, the clip's square-sum and
    AdamW; the handoffs' calls, bytes, seconds, MB/s and how many carried
    a microbatch; the share of idle ticks; the most microbatch graphs held
    at once; peak device memory, bytes allocated between steps and
    sampled RSS; flash and AdamW launches summed over the ranks, exactly
    PIPE_LAYERS x 4 of each flash kernel a step and 1 AdamW a step and
    rank. The shared parameters must be bitwise equal across the ranks
    after every step; then a world-1 TrainStep runs the same steps on the
    whole batch from the same weights: each schedule's losses within
    PP_SLICE_LOSS_TOL, its final parameters (rank 0's state_dict after the
    stages' broadcast) within PP_SLICE_PARAM_TOL relative, a bound that
    must sit below the world-1 run's last update."""
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig

    spec = dict(spec or dict(
        model="gpt3_1p3b", amp=True, rows=4, seq=2048, lr=1e-4, seed=SEED,
        n_batches=4, clip=1.0, steps=4, micro=4, vpps=(1, 2),
        layers=PIPE_LAYERS))
    spec.setdefault("backend", "gloo")
    spec["device"] = device
    nsteps = spec["steps"]
    cfg = GPTConfig.tiny() if spec["model"] == "tiny" \
        else GPTConfig.gpt3_1p3b()
    cfg.num_layers = spec["layers"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_slice_")
    free = shutil.disk_usage(tmp).free
    if free < 1.2 * 4 * gpt_numel(cfg) * len(spec["vpps"]):
        shutil.rmtree(tmp)
        raise RuntimeError(f"{free} bytes free under {tmp}: the parameter "
                           "dumps do not fit")
    spec["dump"] = os.path.join(tmp, "rank0.params")
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    t0 = time.perf_counter()
    try:
        ctx = spawn(cs.pp_rank_main, args=(spec,), nprocs=2, join=False,
                    backend="cuda" if device == "cuda" else "cpu")
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {f"rank{r}": p.pid for r, p in enumerate(ctx.processes)},))
        sampler.start()
        try:
            ranks = ctx.join(900)
        finally:
            for p in ctx.processes:
                if p.poll() is None:
                    p.kill()
            stop.set()
            sampler.join()
        ranks_s = time.perf_counter() - t0

        # the world-1 run: the whole batch a step, the same weights
        spec1 = dict(spec, layers=cfg.num_layers)
        model, opt, loss_fn = _cp_model(torch, spec1, device, None)
        step = TrainStep(model, loss_fn, opt, device=device)
        batches = _elastic_batches(spec)
        params = list(model.parameters())
        world1, walls = [], []
        for s in range(nsteps):
            if s == nsteps - 1:
                before = [p.detach().clone() for p in params]
            t1 = time.perf_counter()
            world1.append(float(step(*batches[s % len(batches)])))
            walls.append(time.perf_counter() - t1)
        step_rel = _rel_dev(torch, before, params)
        del before
        offs = np.cumsum([0] + [p.numel() for p in params])
        param_rel = {}
        for vpp in spec["vpps"]:
            words = np.memmap(f"{spec['dump']}.{vpp}", dtype=np.float32,
                              mode="r")
            if words.size != offs[-1]:
                raise AssertionError(f"rank 0 dumped {words.size} "
                                     f"parameters, the model has "
                                     f"{offs[-1]}")
            param_rel[vpp] = _rel_dev(torch, (
                torch.from_numpy(np.array(words[a:b])).to(p.device)
                .view_as(p)
                for p, a, b in zip(params, offs[:-1], offs[1:])), params)
            del words
        del model, opt, step, params
        if device == "cuda":
            release(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = _pp_want(cfg.num_layers, spec["micro"], nsteps)
    rows = {}
    for i, vpp in enumerate(spec["vpps"]):
        runs = [r["runs"][i] for r in ranks]
        losses = [st["loss"] for st in runs[0]["steps"]]
        if [st["loss"] for st in runs[1]["steps"]] != losses:
            raise AssertionError(f"V {vpp}: the ranks' losses differ")
        dev = max(abs(a - b) for a, b in zip(losses, world1))
        if not all(np.isfinite(losses)) or dev > PP_SLICE_LOSS_TOL \
                or not param_rel[vpp] <= PP_SLICE_PARAM_TOL < step_rel:
            raise AssertionError(
                f"V {vpp}: losses {losses} against the world-1 run's "
                f"{world1}: {dev} (bound {PP_SLICE_LOSS_TOL}); final "
                f"parameters {param_rel[vpp]} from the world-1 run's "
                f"(bound {PP_SLICE_PARAM_TOL}, which must sit below its "
                f"last update's {step_rel})")
        launches = {k: sum(r["launches"][k] for r in runs) for k in PP}
        if device == "cuda" and launches != want:
            raise AssertionError(f"V {vpp}: launches over both ranks "
                                 f"{launches}, expected {want}")
        per_rank = {r["rank"]: _pp_summary(r["runs"][i]) for r in ranks}
        rows[vpp] = {"losses": losses, "max_abs_loss_dev": dev,
                     "final_params_rel_dev": param_rel[vpp],
                     "launches": launches, "per_rank": per_rank,
                     "tokens_per_s": spec["rows"] * spec["seq"]
                     / per_rank[0]["median_step_s"]}
    return {
        "phase": "pp_slice", "model": ("GPT tiny" if spec["model"] == "tiny"
                                       else "GPT-3 1.3B"),
        "layers": cfg.num_layers, "hidden": cfg.hidden_size,
        "amp": ("O1 bfloat16, fp32 parameters" if spec.get("amp")
                else "off, fp32"),
        "batch": [spec["rows"], spec["seq"]], "microbatches": spec["micro"],
        "pp": 2, "backend": ranks[0]["backend"],
        "transport": ranks[0]["runs"][0]["transport"],
        "transport_why": "two ranks on one card: NCCL refuses that; the "
                         "handoffs' permutes copy through pinned host "
                         "memory, the kernels stay on the card",
        "steps": nsteps, "schedules": rows, "rss_peak_sampled": rss,
        "world1_losses": world1,
        "world1_step_s": statistics.median(walls[1:]),
        "loss_tolerance": PP_SLICE_LOSS_TOL,
        "param_tolerance": PP_SLICE_PARAM_TOL,
        "world1_last_update_rel": step_rel, "want": want,
        "ranks_s": ranks_s,
    }


def _pp_summary(run):
    """A rank's timed steps of one schedule: medians of the wall and its
    parts, the handoffs' calls, bytes and MB/s, the engine's counters."""
    timed = [st for st in run["steps"] if not st["warmup"]]
    eng = timed[-1]["engine"]
    hand_s = statistics.median(st["engine"]["handoff_s"] for st in timed)
    return {
        "build_s": run["build_s"],
        "step_s": [st["wall_s"] for st in timed],
        "median_step_s": statistics.median(st["wall_s"] for st in timed),
        "warmup_s": run["steps"][0]["wall_s"],
        "warmup_parts_s": run["steps"][0]["parts_s"],
        "median_parts_s": {
            k: statistics.median(st["parts_s"][k] for st in timed)
            for k in timed[0]["parts_s"]},
        "ticks": eng["ticks"], "idle_ticks": eng["idle_ticks"],
        "idle_share": eng["idle_ticks"] / eng["ticks"],
        "slots": [eng["fwd_slots"], eng["bwd_slots"]],
        "max_inflight": eng["max_inflight"],
        "handoffs_a_step": eng["permutes"],
        "handoff_bytes_a_step": eng["permute_bytes"],
        "handoffs_carrying": eng["carried"],
        "median_handoff_s": hand_s,
        "handoff_mb_per_s": eng["permute_bytes"] / hand_s / 1e6
        if hand_s else None,
        "shared_sum_bytes": eng["sum_bytes"],
        "allocated_between": [st["allocated_between"] for st in timed],
        "max_allocated": run["max_allocated"], "n_params": run["n_params"],
        "bytes_per_param": timed[-1]["allocated_between"] / run["n_params"],
        "launches": run["launches"]}


# -- pipeline beside data and tensor parallelism: four ranks on the card -----

HYBRID_SLICE_LOSS_TOL = 1e-3
# the final parameters against the world-1 run: mesh B's as pp_slice's;
# mesh A's as mp_slice's (its mp all-reduces add bf16 partial products in
# another order than the world-1 run's one product)
HYBRID_PARAM_TOL = {"A": 1e-3, "B": 5e-4}
# the depth of both meshes' models: 2, one decoder layer a stage. The
# handoffs, the tied ends' sum, the mp collectives a layer and the dp
# reduce of the ends are the same at any depth; Llama-2-7B at 24 layers
# (12 a stage: 21.5 GB of state a rank, 86 GB over the four) does not fit
# the card
HYBRID_LAYERS = 2
# the two meshes of hybrid_pp_slice, each over the same four processes
HYBRID_MESHES = {
    "A": dict(model="llama2_7b", dp=1, pp=2, mp=2, rows=4),
    "B": dict(model="gpt3_1p3b", dp=2, pp=2, mp=1, rows=8)}
# the kernels of each mesh's path: every block's flash forward, dQ and
# dK/dV; Llama's RMSNorm forward and backward (two a layer, and the final
# norm on the last stage) and contiguous RoPE (q and k in one launch,
# forward, and the backward at sign -1), which must not take the
# per-token kernel; AdamW's fp32 form, once a step and rank
HYBRID_KERNELS = {
    "A": ("flash_fwd", "flash_dq", "flash_dkv", "rms_norm", "rms_norm_bwd",
          "rope", "rope_packed", "adamw"),
    "B": ("flash_fwd", "flash_dq", "flash_dkv", "adamw")}


def _hybrid_cfg(spec):
    """The model config of a mesh: the published widths (or a tiny one for
    a CPU rehearsal), spec["layers"] deep, no dropout."""
    from paddle_tpu_torch.models import GPTConfig, LlamaConfig

    cfg = {"llama2_7b": LlamaConfig.llama2_7b, "llama_tiny": LlamaConfig.tiny,
           "gpt3_1p3b": GPTConfig.gpt3_1p3b,
           "gpt_tiny": GPTConfig.tiny}[spec["model"]]()
    if isinstance(cfg, GPTConfig):
        cfg.hidden_dropout_prob = cfg.attention_dropout_prob = 0.0
    cfg.num_layers = spec["layers"]
    return cfg


def _hybrid_model(spec, device):
    """The seeded model of a mesh: under a mesh with an mp axis each rank's
    blocks of the model built at mp 1 from the same seed."""
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaConfig,
                                         LlamaForCausalLM)

    cfg = _hybrid_cfg(spec)
    cls = LlamaForCausalLM if isinstance(cfg, LlamaConfig) \
        else GPTForCausalLM
    return cls(cfg, device=device, seed=spec["seed"])


def _hybrid_numel(cfg):
    """Parameters of the mesh's model (whole) from its config."""
    from paddle_tpu_torch.models import GPTConfig

    if isinstance(cfg, GPTConfig):
        return gpt_numel(cfg)
    H, kv = cfg.hidden_size, cfg.num_key_value_heads * (
        cfg.hidden_size // cfg.num_heads)
    per_layer = 2 * H * H + 2 * H * kv + 3 * H * cfg.intermediate_size \
        + 2 * H
    heads = 1 if cfg.tie_word_embeddings else 2
    return cfg.num_layers * per_layer + heads * cfg.vocab_size * H + H


def _hybrid_batches(spec):
    """`n_batches` global batches of token ids [rows, seq], from the seed."""
    import numpy as np

    rng = np.random.default_rng(spec["seed"])
    ids = rng.integers(0, _hybrid_cfg(spec).vocab_size,
                       (spec["n_batches"], spec["rows"], spec["seq"]))
    return [ids[i] for i in range(spec["n_batches"])]


def _hybrid_peers(store, key, rank, group, mine, what):
    """Publish this rank's bit sums under `key` and check them against
    every other rank of `group`'s."""
    store.set(f"{key}/{rank}", json.dumps(mine))
    for peer in group.ranks:
        if peer == rank:
            continue
        other = json.loads(bytes(store.get(f"{key}/{peer}",
                                           timeout_s=600)).decode())
        if other != mine:
            raise AssertionError(f"{key}: rank {rank}'s {what} differ "
                                 f"from rank {peer}'s")


def _hybrid_run(torch, spec, name, store, rank, device, dump):
    """One mesh of hybrid_pp_slice on this rank: fleet.init with the mesh's
    hybrid configs, the seeded model (under the mesh: this rank's mp
    blocks) through pipeline_descs, a PipelineLayer of two stages,
    copy_weights, fleet.distributed_model and the hybrid optimizer; then
    spec["steps"] train_batch steps on this rank's dp rows, the first a
    warm-up. After every step the bit sums go through the store: the dp
    replicas' whole state, each mp pair's whole (uncut) parameters and
    each pp pair's shared ends must be equal. Rank 0 dumps the final
    parameters, gathered over its mp group, in the model's order."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import collective, fleet, get_mesh
    from paddle_tpu_torch.distributed import pipeline as engine
    from paddle_tpu_torch.distributed.fleet import PipelineLayer
    from paddle_tpu_torch.distributed.sharding_utils import shard_batch
    from paddle_tpu_torch.models.convert import gather_state_dict
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.optimizer import AdamW

    on_card = device == "cuda"
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=spec["dp"],
                                   pp_degree=spec["pp"],
                                   mp_degree=spec["mp"])
    strategy.pipeline_configs["accumulate_steps"] = spec["micro"]
    fleet.init(is_collective=True, strategy=strategy)
    mesh = get_mesh()
    coord = mesh.coordinate(rank)
    t0 = time.perf_counter()
    # seeded on the card, then kept on the host: the pipeline's layers are
    # built there and each rank moves its stage over
    model = _hybrid_model(spec, device).to("cpu")
    descs, loss_fn, copy_weights = model.pipeline_descs()
    pl = PipelineLayer(descs, num_stages=spec["pp"], loss_fn=loss_fn)
    copy_weights(pl)
    pp = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(AdamW(
        spec["lr"], parameters=pp.parameters(), weight_decay=0.01,
        grad_clip=ClipGradByGlobalNorm(spec["clip"])))
    # the parameters themselves: AdamW's first step moves their storage
    # into its flat buffers, so a tensor taken before it reads stale bits
    params = pp.parameters()
    shared = list(pp._shared_params)
    whole = [p for p in params if getattr(p, "_mp_shard", None) is None]
    n_params = sum(p.numel() for p in params)
    batches = _hybrid_batches(spec)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    build_s = time.perf_counter() - t0
    steps = []
    gpu.reset_launch_counts()
    for s in range(spec["steps"]):
        collective.reset_transport_stats()
        ids = shard_batch(torch.from_numpy(batches[s % len(batches)]), mesh,
                          ("dp",))
        t1 = time.perf_counter()
        with amp.auto_cast(enable=bool(spec.get("amp")), level="O1",
                           dtype="bfloat16"):
            loss = float(pp.train_batch((ids, ids), opt))
        wall = time.perf_counter() - t1
        st = engine.last_stats()
        between = torch.cuda.memory_allocated() if on_card else 0
        key = f"/pt/hybrid_pp_slice/{name}/{s}"
        for axis, what, tensors in (("dp", "parameters", params),
                                    ("mp", "whole parameters", whole),
                                    ("pp", "shared ends", shared)):
            if mesh.shape[axis] > 1:
                _hybrid_peers(store, f"{key}/{axis}", rank,
                              mesh.group(axis), bit_sums(
                                  torch, [p.detach() for p in tensors]),
                              what)
        steps.append({"step": s, "warmup": s == 0, "loss": loss,
                      "wall_s": wall, "parts_s": dict(pp.last_parts),
                      "engine": st, "allocated_between": between,
                      "transport": collective.transport_stats()})
    launches = gpu.launch_counts(HYBRID_KERNELS[name])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    pp.state_dict()                  # every stage broadcast to every rank
    if coord["dp"] == 0 and coord["pp"] == 0:
        # rank 0's mp group gathers the whole model; rank 0 writes it
        copy_weights(pl, reverse=True)
        state = gather_state_dict(model)
        if rank == 0:
            with open(dump, "wb") as f:
                for n, _ in model.named_parameters():
                    f.write(state[n].tobytes())
        del state
    out = {"mesh": name, "coord": coord, "build_s": build_s, "steps": steps,
           "launches": launches, "max_allocated": peak,
           "n_params": n_params, "n_whole": sum(p.numel() for p in whole),
           # the dp reduce: every gradient of the rank, fp32, once a step
           "dp_reduce_bytes": 4 * n_params if mesh.shape["dp"] > 1 else 0,
           "n_shared": sum(p.numel() for p in shared),
           "transport": collective.transport(
               torch.empty(1, device=device), mesh.group("pp"))}
    del pp, pl, opt, model, params, shared, whole
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def hybrid_rank_main(spec):
    """One rank of hybrid_pp_slice as a process of its own (distributed.
    spawn imports this module in the child): init_parallel_env under
    PADDLE_DISTRI_BACKEND=spec["backend"] (gloo: the four ranks are on the
    one card), then each mesh of spec["meshes"] in turn (_hybrid_run).
    Returns each mesh's steps, launches and memory."""
    sys.stdout = sys.stderr      # the parent's stdout carries its own lines
    os.environ["PADDLE_DISTRI_BACKEND"] = spec["backend"]
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env as denv

    device = spec.get("device", "cuda")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    t_start = time.perf_counter()
    dist.init_parallel_env(device=None if device == "cuda" else "cpu")
    import torch.distributed as tdist

    rank = dist.get_rank()
    store = denv.get_store()
    init_s = time.perf_counter() - t_start
    runs = {name: _hybrid_run(torch, {**spec, **mesh}, name, store, rank,
                              device, f"{spec['dump']}.{name}")
            for name, mesh in spec["meshes"].items()}
    store.barrier("hybrid_pp_slice_done")     # rank 0 hosts the store
    return {"rank": rank, "pid": os.getpid(),
            "backend": tdist.get_backend(), "init_s": init_s, "runs": runs}


def _hybrid_want(name, spec, cfg):
    """Launches over the four ranks of one mesh's steps: every layer lives
    on one stage and runs once a microbatch on each of its mp ranks and
    dp replicas (no recompute), so each flash kernel layers x micro x dp x
    mp a step; Llama's RMSNorm forward and backward 2 a layer and 1 (the
    final norm, on the last stage) a microbatch and mp rank, contiguous
    RoPE 1 forward and 1 backward a layer, microbatch and mp rank, the
    per-token kernel never; AdamW's fp32 form once a step and rank."""
    steps, micro = spec["steps"], spec["micro"]
    lanes = spec["dp"] * spec["mp"]
    n = cfg.num_layers * micro * lanes * steps
    want = {"flash_fwd": n, "flash_dq": n, "flash_dkv": n,
            "adamw": spec["dp"] * spec["pp"] * spec["mp"] * steps}
    if name == "A":
        norms = (2 * cfg.num_layers + 1) * micro * lanes * steps
        want.update(rms_norm=norms, rms_norm_bwd=norms, rope=2 * n,
                    rope_packed=0)
    return want


def _hybrid_world1(torch, spec, device):
    """The world-1 run of a mesh: the seeded model whole on one device,
    TrainStep on the whole global batch a step, the same optimizer, clip
    and amp; (losses, step walls, the model's parameters, the relative
    size of the last update)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = _hybrid_model(spec, device)
    opt = AdamW(spec["lr"], parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(spec["clip"]))
    amp_on = bool(spec.get("amp"))

    def loss_fn(ids):
        with amp.auto_cast(enable=amp_on, level="O1", dtype="bfloat16"):
            return model(ids, labels=ids)

    step = TrainStep(model, loss_fn, opt, device=device)
    params = list(model.parameters())
    losses, walls = [], []
    batches = _hybrid_batches(spec)
    for s in range(spec["steps"]):
        if s == spec["steps"] - 1:
            before = [p.detach().clone() for p in params]
        t1 = time.perf_counter()
        losses.append(float(step(batches[s % len(batches)])))
        walls.append(time.perf_counter() - t1)
    step_rel = _rel_dev(torch, before, params)
    return losses, walls, model, step_rel


def hybrid_pp_slice_phase(torch, device="cuda", spec=None,
                          meshes=HYBRID_MESHES):
    """Pipeline parallelism beside tensor and data parallelism, four rank
    processes on the one card (distributed.spawn, init_parallel_env over
    gloo, fleet.init with the hybrid configs of each mesh in turn, the
    child starts paid once): mesh A, pp 2 x mp 2, Llama-2-7B at its
    published widths; mesh B, dp 2 x pp 2, GPT-3 1.3B at its published
    widths; both HYBRID_LAYERS deep (one layer a stage), fp32 parameters,
    amp O1, AdamW's fused fp32 form, a global-norm clip of 1.0 through
    fleet's hybrid optimizer, 4 microbatches of [1, 2048] a rank (A: the
    global batch 4 x 2048; B: 8 x 2048, 4 rows a dp rank). Each mesh
    takes pipeline_descs into a PipelineLayer of two stages (built under
    the mesh: each rank's mp blocks), copy_weights,
    fleet.distributed_model and train_batch: a warm-up and three timed
    steps. Reports each rank's step wall split into the forward and
    backward slots (the mp all-reduces inside), the handoffs, the tied
    ends' sum, the dp reduce, the square-sum and AdamW; the handoffs' and
    mp collectives' calls, bytes, seconds and MB/s; peak device memory,
    bytes between steps and sampled RSS; every kernel's launches summed
    over the ranks (exact, or the phase raises). After every step the dp
    replicas must be bitwise equal, each mp pair's whole parameters and
    each pp pair's shared ends. Then a world-1 TrainStep runs each mesh's
    steps on the whole batch from the same seed: losses within
    HYBRID_SLICE_LOSS_TOL, final parameters (gathered over mp) within
    HYBRID_PARAM_TOL relative, a bound that must sit below the world-1
    run's last update."""
    import shutil
    import tempfile
    import threading

    import chip_smoke as cs
    import numpy as np
    from paddle_tpu_torch.distributed import spawn

    spec = dict(spec or dict(
        amp=True, seq=2048, lr=1e-4, seed=SEED, n_batches=4, clip=1.0,
        steps=4, micro=4, layers=HYBRID_LAYERS, meshes=meshes))
    spec.setdefault("backend", "gloo")
    spec["device"] = device
    world = {spec["meshes"][m]["dp"] * spec["meshes"][m]["pp"]
             * spec["meshes"][m]["mp"] for m in spec["meshes"]}
    if len(world) != 1:
        raise ValueError(f"the meshes need {world} ranks: one world only")
    world = world.pop()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hybrid_pp_slice_")
    need = sum(4 * _hybrid_numel(_hybrid_cfg({**spec, **m}))
               for m in spec["meshes"].values())
    spec["dump"] = os.path.join(tmp, "rank0.params")
    rss = {}
    stop = threading.Event()

    def sample(pids):
        while not stop.wait(0.25):
            for name, pid in pids.items():
                rss[name] = max(rss.get(name, 0), _vm(pid, "VmRSS"))

    t0 = time.perf_counter()
    try:
        if shutil.disk_usage(tmp).free < 1.2 * need:
            raise RuntimeError(f"too little disk under {tmp} for the "
                               "parameter dumps")
        ctx = spawn(cs.hybrid_rank_main, args=(spec,), nprocs=world,
                    join=False, backend="cuda" if device == "cuda" else "cpu")
        sampler = threading.Thread(target=sample, daemon=True, args=(
            {f"rank{r}": p.pid for r, p in enumerate(ctx.processes)},))
        sampler.start()
        try:
            ranks = ctx.join(900)
        finally:
            for p in ctx.processes:
                if p.poll() is None:
                    p.kill()
            stop.set()
            sampler.join()
        ranks_s = time.perf_counter() - t0
        meshes = {}
        for name, mesh in spec["meshes"].items():
            mspec = {**spec, **mesh}
            cfg = _hybrid_cfg(mspec)
            world1, walls, model, step_rel = _hybrid_world1(torch, mspec,
                                                            device)
            params = list(model.parameters())
            offs = np.cumsum([0] + [p.numel() for p in params])
            words = np.memmap(f"{spec['dump']}.{name}", dtype=np.float32,
                              mode="r")
            if words.size != offs[-1]:
                raise AssertionError(f"{name}: rank 0 dumped {words.size} "
                                     f"parameters, the model has "
                                     f"{offs[-1]}")
            param_rel = _rel_dev(torch, (
                torch.from_numpy(np.array(words[a:b])).to(p.device)
                .view_as(p)
                for p, a, b in zip(params, offs[:-1], offs[1:])), params)
            del words, model, params
            if device == "cuda":
                release(torch)
            runs = [r["runs"][name] for r in ranks]
            losses = [st["loss"] for st in runs[0]["steps"]]
            for r in runs[1:]:
                if [st["loss"] for st in r["steps"]] != losses:
                    raise AssertionError(f"mesh {name}: the ranks' losses "
                                         f"differ")
            dev = max(abs(a - b) for a, b in zip(losses, world1))
            tol = HYBRID_PARAM_TOL[name]
            if not all(np.isfinite(losses)) or dev > HYBRID_SLICE_LOSS_TOL \
                    or not param_rel <= tol < step_rel:
                raise AssertionError(
                    f"mesh {name}: losses {losses} against the world-1 "
                    f"run's {world1}: {dev} (bound {HYBRID_SLICE_LOSS_TOL});"
                    f" final parameters {param_rel} from the world-1 run's "
                    f"(bound {tol}, which must sit below its last "
                    f"update's {step_rel})")
            want = _hybrid_want(name, mspec, cfg)
            launches = {k: sum(r["launches"][k] for r in runs)
                        for k in HYBRID_KERNELS[name]}
            if device == "cuda" and launches != want:
                raise AssertionError(f"mesh {name}: launches over the ranks "
                                     f"{launches}, expected {want}")
            per_rank = {r["rank"]: _hybrid_summary(r["runs"][name])
                        for r in ranks}
            meshes[name] = {
                "model": ("Llama-2-7B" if mspec["model"] == "llama2_7b"
                          else "GPT-3 1.3B" if mspec["model"] == "gpt3_1p3b"
                          else mspec["model"]),
                "dp": mesh["dp"], "pp": mesh["pp"], "mp": mesh["mp"],
                "layers": cfg.num_layers, "hidden": cfg.hidden_size,
                "batch": [mesh["rows"], spec["seq"]],
                "rows_a_rank": mesh["rows"] // mesh["dp"],
                "microbatches": spec["micro"], "losses": losses,
                "max_abs_loss_dev": dev, "final_params_rel_dev": param_rel,
                "param_tolerance": tol, "world1_losses": world1,
                "world1_step_s": statistics.median(walls[1:]),
                "world1_last_update_rel": step_rel,
                "launches": launches, "want": want, "per_rank": per_rank,
                "tokens_per_s": mesh["rows"] * spec["seq"]
                / per_rank[0]["median_step_s"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "phase": "hybrid_pp_slice", "ranks": world,
        "amp": ("O1 bfloat16, fp32 parameters" if spec.get("amp")
                else "off, fp32"),
        "backend": ranks[0]["backend"],
        "transport": ranks[0]["runs"][next(iter(spec["meshes"]))]
        ["transport"],
        "transport_why": "four ranks on one card: NCCL refuses that; the "
                         "handoffs' permutes copy through pinned host "
                         "memory, gloo stages its all-reduces through the "
                         "host, the kernels stay on the card",
        "steps": spec["steps"], "meshes": meshes,
        "init_s": {r["rank"]: r["init_s"] for r in ranks},
        "rss_peak_sampled": rss, "loss_tolerance": HYBRID_SLICE_LOSS_TOL,
        "ranks_s": ranks_s,
    }


def _hybrid_summary(run):
    """A rank's timed steps of one mesh: medians of the wall and its parts,
    the engine's counters, the handoffs' and mp collectives' calls, bytes
    and MB/s, memory."""
    timed = [st for st in run["steps"] if not st["warmup"]]
    eng = timed[-1]["engine"]
    colls = {}
    for k in timed[-1]["transport"]:
        secs = statistics.median(st["transport"].get(k, {}).get(
            "seconds", 0.0) for st in timed)
        ent = timed[-1]["transport"][k]
        colls[k] = {"calls": ent["calls"], "bytes": ent["bytes"],
                    "median_s": secs,
                    "mb_per_s": ent["bytes"] / secs / 1e6 if secs else None}
    return {
        "coord": run["coord"], "build_s": run["build_s"],
        "step_s": [st["wall_s"] for st in timed],
        "median_step_s": statistics.median(st["wall_s"] for st in timed),
        "warmup_s": run["steps"][0]["wall_s"],
        # where a fresh process's first step spends its extra seconds
        "warmup_parts_s": run["steps"][0]["parts_s"],
        "warmup_collectives_s": {
            k: v["seconds"]
            for k, v in run["steps"][0]["transport"].items()},
        "median_parts_s": {
            k: statistics.median(st["parts_s"][k] for st in timed)
            for k in timed[0]["parts_s"]},
        "ticks": eng["ticks"], "idle_ticks": eng["idle_ticks"],
        "max_inflight": eng["max_inflight"],
        "handoffs_carrying": eng["carried"],
        "shared_sum_bytes": eng["sum_bytes"],
        "dp_reduce_bytes": run["dp_reduce_bytes"],
        "collectives": colls,
        "allocated_between": [st["allocated_between"] for st in timed],
        "max_allocated": run["max_allocated"], "n_params": run["n_params"],
        "n_whole": run["n_whole"], "n_shared": run["n_shared"],
        "bytes_per_param": timed[-1]["allocated_between"] / run["n_params"],
        "launches": run["launches"]}


KERNELS = {
    "rms_norm": ("cuda", "paddle_tpu_torch/csrc/fused_norm.cu",
                 "paddle_tpu/ops/pallas/fused_norm.py:24"),
    "rms_norm_bwd": ("triton", "paddle_tpu_torch/ops/gpu/fused_norm.py",
                     "paddle_tpu/ops/pallas/fused_norm.py:33"),
    "rope": ("cuda", "paddle_tpu_torch/csrc/rope.cu",
             "paddle_tpu/ops/pallas/rope.py:22"),
    "rope_packed": ("cuda", "paddle_tpu_torch/csrc/rope.cu",
                    "paddle_tpu/ops/pallas/rope.py:126"),
    "paged_decode": ("cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:50"),
    "paged_verify": ("cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:165"),
    "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:53"),
    "flash_dq": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:137"),
    "flash_dkv": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                  "paddle_tpu/ops/pallas/flash_attention.py:177"),
    "flash_seg_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:411"),
    "flash_seg_dq": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:455"),
    "flash_seg_dkv": ("cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
                      "paddle_tpu/ops/pallas/flash_attention.py:494"),
    "adamw": ("triton", "paddle_tpu_torch/ops/gpu/fused_adamw.py",
              "paddle_tpu/ops/pallas/fused_adamw.py:21"),
    "adamw_master": ("triton", "paddle_tpu_torch/ops/gpu/fused_adamw.py",
                     "paddle_tpu/ops/pallas/fused_adamw.py:21"),
}
# the serving graphs' kernels (contiguous RoPE runs in generate(), whose
# host-int pos the parity phase drives)
SERVING = ("rms_norm", "rope_packed", "paged_decode")
# the rows whose call is short enough that the host's cost shows
SHORT = ("rms_norm", "rope", "rope_packed", "paged_decode")
SPEC = SERVING + ("paged_verify",)
GPT_SERVING = ("paged_decode", "paged_verify")
TRAINING = ("flash_fwd", "flash_dq", "flash_dkv", "adamw")
# the O2 slice's kernels, and the fp32 AdamW form it must not launch
TRAINING_O2 = ("flash_fwd", "flash_dq", "flash_dkv", "adamw_master", "adamw")
# the packed slice's kernels, and those it must not launch (read as 0)
PACKED = ("flash_seg_fwd", "flash_seg_dq", "flash_seg_dkv", "rms_norm",
          "rms_norm_bwd", "rope_packed", "adamw", "flash_fwd", "flash_dq",
          "flash_dkv", "rope")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                             LlamaConfig, LlamaForCausalLM)
        from paddle_tpu_torch.ops import gpu
        from paddle_tpu_torch.ops.gpu import _build
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside the script "
              f"({e})", file=sys.stderr)
        return 2

    card = nvidia_smi()
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": card, "capability": list(cap),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise RuntimeError(f"needs a Hopper card (capability 9.0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {k: v["seconds"] for k, v in built.items()},
          "ptxas": [ln.strip().removeprefix("ptxas info    : ")
                    for v in built.values()
                    for ln in v["log"].splitlines()
                    if "Used" in ln or "entry function" in ln
                    or "spill stores" in ln]})

    rows = kernels_phase(torch)
    release(torch)

    cfg2 = LlamaConfig.llama2_7b()
    cfg2.num_layers = 2
    parity = parity_phase(torch, cfg2, "cuda", engine_kw=dict(
        max_slots=4, block_size=16, prefill_chunk=256, max_model_len=1024))
    emit(parity)
    release(torch)

    gpt2 = GPTConfig.gpt3_1p3b()
    gpt2.num_layers = 2
    gpt2.hidden_dropout_prob = gpt2.attention_dropout_prob = 0.0
    emit(spec_parity_phase(torch, [
        ("Llama-2-7B widths, 2 layers",
         LlamaForCausalLM(cfg2, device="cuda", dtype="float32", seed=SEED)),
        ("GPT-3 1.3B widths, 2 layers",
         GPTForCausalLM(gpt2, device="cuda", dtype="float32", seed=SEED))]))
    release(torch)

    emit(fuse_parity_phase(torch, cfg2))
    release(torch)

    emit(sampler_phase(torch, cfg2))
    release(torch)

    t0 = time.perf_counter()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(), device="cuda",
                             dtype="bfloat16", seed=SEED)
    torch.cuda.synchronize()
    model_init_s = time.perf_counter() - t0
    engine_kw = dict(max_slots=8, block_size=16, prefill_chunk=256,
                     max_model_len=2048)
    seqs = {}
    for fuse in (1, 4):
        seqs[fuse], summary = slice_phase(
            torch, model, dict(engine_kw, fuse_steps=fuse), new_tokens=64,
            wave1_lens=(16, 64, 128, 512, 768, 1024, 288, 356),
            prefix_len=256, reset=gpu.reset_launch_counts,
            counts=lambda: gpu.launch_counts(SERVING))
        if fuse == 4:
            summary["bf16_agreement_with_fuse_steps_1"] = _agreement(
                torch, model, seqs[4], seqs[1])
        emit({**summary, "model_init_s": model_init_s})
        release(torch)
    _, summary = slice_phase(
        torch, model, dict(engine_kw, fuse_steps=4), new_tokens=64,
        wave1_lens=(16, 64, 128, 512, 768, 1024, 288, 356), prefix_len=256,
        reset=gpu.reset_launch_counts,
        counts=lambda: gpu.launch_counts(SERVING), temperature=0.8)
    emit(summary)
    release(torch)

    cfg8 = LlamaConfig.llama2_7b()
    cfg8.num_layers = CUT_LAYERS
    tick_model = LlamaForCausalLM(cfg8, device="cuda", dtype="bfloat16",
                                  seed=SEED)
    emit(graph_tick_phase(torch, tick_model, engine_kw))
    del tick_model
    release(torch)

    server = server_slice_phase(
        torch, model, engine_kw, reset=gpu.reset_launch_counts,
        counts=lambda: gpu.launch_counts(SERVING), kernels=SERVING)
    emit(server)
    release(torch)

    spec = spec_slice_phase(
        torch, model, dict(engine_kw, spec_k=4, spec_ngram=3, spec_pause=32),
        new_tokens=64, reset=gpu.reset_launch_counts,
        counts=lambda: gpu.launch_counts(SPEC), kernels=SPEC)
    emit(spec)
    del model
    release(torch)

    emit(fleet_parity_phase(torch, cfg2))
    release(torch)

    fleet = fleet_slice_phase(torch, gpu.reset_launch_counts,
                              lambda: gpu.launch_counts(SERVING), SERVING)
    emit(fleet)
    release(torch)

    # the process replicas: the parent holds nothing on the card now, and
    # every library is built, so no child compiles inside its warm-up
    emit(proc_fleet_parity_phase(torch))
    release(torch)
    emit(proc_fleet_slice_phase(torch, threads={
        arm: [{k: run[k] for k in ("requests", "tokens_per_s",
                                   "mean_ttft_s")}
              for run in fleet["arms"][arm]["runs"] if not run["profiled"]]
        for arm in ("one", "two")}))
    release(torch)

    gpt_serve = gpt_serve_slice_phase(
        torch, gpu.reset_launch_counts,
        lambda: gpu.launch_counts(GPT_SERVING))
    emit(gpt_serve)

    emit(train_parity_phase(torch))
    release(torch)

    train = train_slice_phase(torch, gpu.reset_launch_counts,
                              lambda: gpu.launch_counts(TRAINING))
    emit(train)
    release(torch)

    emit(train_o2_parity_phase(torch))
    release(torch)

    o2 = train_o2_slice_phase(torch, gpu.reset_launch_counts,
                              lambda: gpu.launch_counts(TRAINING_O2),
                              train["step_s"])
    emit(o2)
    release(torch)

    emit(packed_parity_phase(torch))
    release(torch)

    packed = train_packed_slice_phase(torch, gpu.reset_launch_counts,
                                      lambda: gpu.launch_counts(PACKED))
    emit(packed)
    release(torch)

    emit(recompute_parity_phase(torch, gpu.reset_launch_counts,
                                gpu.launch_counts))
    release(torch)

    emit(recompute_slice_phase(torch, gpu.reset_launch_counts,
                               gpu.launch_counts, o2["step_s"]))
    release(torch)

    emit(io_feed_phase(torch))
    emit(resilient_slice_phase(torch))
    release(torch)

    # elastic ranks, each a process on this card: this process hosts the
    # store and holds nothing on the card meanwhile
    emit(elastic_parity_phase(torch))
    release(torch)
    elastic = elastic_slice_phase(torch)
    emit(elastic)
    release(torch)
    # data parallelism over gloo: two ranks on the card, this process idle
    emit(dp_slice_phase(torch, elastic=elastic))
    release(torch)
    # context parallelism: two sep ranks on the card, each on half of
    # every row, ring then Ulysses
    emit(cp_slice_phase(torch))
    release(torch)
    # tensor parallelism: two mp ranks on the card, each with half of
    # every sharded weight and the whole batch
    emit(mp_slice_phase(torch))
    release(torch)
    # ZeRO: two sharding ranks on the card, each on half of the batch with
    # its shard of the optimizer state (and gradients, and parameters)
    emit(zero_slice_phase(torch))
    release(torch)
    # pipeline parallelism: two pp ranks on the card, each with its stage
    # (and the tied ends), handing microbatches on
    emit(pp_slice_phase(torch))
    release(torch)
    # pipeline beside tensor and data parallelism: four ranks on the card,
    # Llama-2-7B at pp 2 x mp 2, then GPT-3 1.3B at dp 2 x pp 2
    hybrid = hybrid_pp_slice_phase(torch)
    emit(hybrid)
    release(torch)
    # each kernel's launches on the path it was ported for: the HTTP
    # server over the engine's graphs for RMSNorm, per-token RoPE and paged
    # decode (replays included), generate() for contiguous RoPE,
    # speculative serving for paged verify, GPT training for dense flash
    # and AdamW, GPT training under amp O2 for AdamW's master form, packed
    # Llama training for segmented flash and RMSNorm backward
    launches = {**packed["launches"], **train["launches"],
                **server["launches"], "rope": parity["generate_rope_launches"],
                "paged_verify": spec["launches"]["paged_verify"],
                "adamw_master": o2["launches"]["adamw_master"]}

    print(card, flush=True)
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # the short serving rows' device and host costs
            **{k: r[k] for k in ("device_ms", "host_us", "library_device_ms",
                                 "library_host_us") if k in r}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def hybrid_alone(args):
    """`chip_smoke.py hybrid_pp_slice [A=<layers>] [B=<layers>]`: the build
    and hybrid_pp_slice alone, each mesh at the depth given (HYBRID_LAYERS
    otherwise), for the deeper runs that the whole script has no time
    for."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops.gpu import _build

    card = nvidia_smi()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    depths = dict(a.split("=", 1) for a in args)
    meshes = {k: dict(m, layers=int(depths.get(k, HYBRID_LAYERS)))
              for k, m in HYBRID_MESHES.items()}
    emit(hybrid_pp_slice_phase(torch, meshes=meshes))
    return 0


if __name__ == "__main__":
    try:
        code = hybrid_alone(sys.argv[2:]) \
            if sys.argv[1:2] == ["hybrid_pp_slice"] else main()
    except Exception:           # any failed phase: report it, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
