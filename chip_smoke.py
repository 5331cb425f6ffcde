#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It builds every hand-written CUDA kernel from ``src/repro_torch`` and
then drives the port's paths at the paper's full encoder width: the
serving tick, the per-frame split path (``SplitEngine.run``), the tick
with a fleet refine round after it, the edge learner's training step, the
always-on ``StreamServer`` with the RL split policy, the LM cascade
server at the full width and depth of qwen1.5-0.5b and qwen3-1.7b, the
LM trainer at the full width and depth of qwen1.5-0.5b, the control
plane (PPO training of the RL splitter, the paper's system tables and
the edge loop serving the trained encoder under the trained policy), and
LM prefill and decode for every family (dense, MoE, SSM, hybrid).

Phase 1 holds the wire kernel against its plain PyTorch version on the
card, bitwise, at every shape the serving path gives it (plus constant,
outlier, NaN, +inf and -inf rows), and at B=1 against the per-tensor
quantize∘dequantize; then ``wire_roundtrip_grouped`` (the tick's buckets
in one launch) bitwise against its plain version, against one
``wire_roundtrip`` launch a group and from run to run: the tick's eight
groups ragged (28/29 rows) and padded (32), one group, the most groups a
launch takes, B = 1 groups and groups of one width, with those rows in
every group.

Phase 2 runs ``StreamSplitGateway`` (``AudioEncCfg()``, random weights
from a seed, a host fleet of 256 sessions x 100 frames, refine off)
with a policy that spreads k = 0..8 over the sessions: 9 buckets a tick,
each padded to 32 frames.  One warm-up tick and 8 timed ticks, with the
kernels' launch counts set to 0 just before and read just after; each
tick must launch ``wire_roundtrip_grouped`` once (all its buckets' edge
stages, one wire, all server stages).  It
checks results, counters and launches, compares the first tick with
``overlap=False`` on the card (bitwise) and with the same port run on
the CPU (atol 1e-4), and times each kernel at the shapes of the run.
Then the per-frame split path: ``SplitEngine.run`` on each of the first
tick's 256 frames at its k, counted the same way, whose per-tensor wire
must launch ``int8_quantize_roundtrip`` once for each frame with k < L
(and no other wire kernel), and each frame's
embedding must equal, bitwise, the same stages run on the plain
per-tensor wire of that frame's edge activation; it prints the bucketed
against per-frame bound.

Phase 3 holds each refine kernel (``swd_sessions``, ``laplacian_energy``,
``gmm_posterior``) against its plain PyTorch version on the card at the
refine shapes (256 sessions x 100 frames x 128 dims, 50 directions,
k = 5, 64 components), at W in {16, 100, 128}, k >= T, T = 1, with an
all-masked row, a zero session and direction counts that are not a
multiple of the kernel's block; ``swd_sessions`` also at the edges of its
in-register sort, W = 1, 300 (16 values a lane) and 1,200 (d in chunks,
the directions in groups), at M = 1 and d = 127; the GMM also at the
variance floor,
at the cascade's (8, 64, 1,024), at (64, 64, 2,048) and at the edges of
its tiling, (1, 64, 128), (8, 64, 1,000), (8, 10, 1,024); the Laplacian
also at the edges of its plan: whole chunks and a last chunk of one
frame, K at a chunk's length and past its register ring, d = 127 and
2,048, B = 1 with T = 1,000, B = 300 and a misaligned z; tolerances SWD
rtol 1e-4, Laplacian rtol 1e-5, GMM resp atol 1e-4 and entropy atol 5e-4,
the reference's own for its Pallas kernels.  Two launches on one input must
be bitwise equal.

Phase 4 runs the gateway with ``refine_every=1`` over a
``HostFleetBackend`` of 256 sessions x 100 frames with a linear 128->10
head and a 64-component GMM memory, rings pre-filled with 99 frames per
session: one warm-up and 8 timed ticks, the counts set to 0 just before
and read just after.  Every tick must refine once and launch each refine
kernel once; the first round is compared with the port on the CPU (same
snapshot, draws, head and memory; rtol 1e-4).  It prints the refine
round's host p50/p95, the tick p50 against phase 2's, a profiled round,
and each refine kernel's time at the refine shape.

Phase 5 holds the training path's kernels against their plain PyTorch
versions on the card: ``infonce_vneg`` forward and backward at the
path's (8, 264, 128) and at (1, 1, 128), (3, 100, 64), (5, 77, 128),
(8, 263, 128) (N not a multiple of the kernels' split), (4, 50, 127) and
a z_neg view one float off 16 bytes (the scalar path); ``swd_rank``
forward (loss, projections, ranks) and backward at W in {104, 16, 128}
and M in {32, 50}, at the LM step's W 128, M 50 with d 1,024 and 2,048,
at W = 1 and at W = 1,000 (32 values a lane), with 96 (or W/2) identical
rows;
``laplacian_energy`` forward and backward at (1, 104, 128) k = 3, k >= T,
T = 1 and an all-masked row, T = 105 (a last chunk of one frame), k = 20
and the LM step's (8, 16, 1,024) k = 5, aligned and misaligned;
``hybrid_reg_bwd`` (both regularisers' gradients in one launch) at the
edge learner's (1, 104, 128) M 32 k 3, the LM steps' (8, 16, 1,024) and
(4, 16, 2,048) M 50 k 5 with an expanded (stride-0) g_tot, and the edges
of its tiling (W and d not multiples of the tile, d = 127, T = 1, k >= T,
M past one staged chunk, W = 1,000), where it must also equal, bitwise,
``swd_rank_bwd`` + ``laplacian_energy_bwd`` added by torch (its two
one-half launches, the composition it replaced), each half alone the
one-half launch.  Forwards within phase 3's tolerances
(InfoNCE rtol 1e-5, SWD loss rtol 1e-4, ranks exact against
``torch.sort(stable=True)`` of the kernel's projections), gradients
within 1e-5 of each gradient's max |g|; the autograd entries must give
their backward kernel's bits, and two launches on one input the same
bits.

Phase 6 runs ``train_representation("streamsplit")`` at full width
(``AudioEncCfg()``, batch 8, 256 virtual negatives, 98 mel frames) for 60
steps, so steps 50-59 are past cold start, then evaluates on 240 frames.
The counts are set to 0 just before and read just after; every step must
launch each training kernel once: the SW and Laplacian terms' forwards,
and one ``hybrid_reg_bwd`` for both gradients (no ``swd_rank_bwd`` or
``laplacian_energy_bwd``).  Step 0's loss, every gradient and the
GMM after ``em_update`` are compared with the port on the CPU (same
weights, data and draws; rtol 1e-4 of each tensor's max |x|).  It prints
cold and warm step times, a profiled step, the final loss, probe accuracy
and collapse, and each training kernel's time at the path's shape (``swd_rank_fwd``
and ``_bwd`` also at the LM step's (128, 1,024), M 50, and
``laplacian_energy``, ``_bwd`` and ``hybrid_reg_bwd`` at its (8, 16,
1,024), k 5), ``hybrid_reg_bwd`` beside the composition it replaced.

Phase 7 holds the per-tensor wire kernels ``int8_quantize`` (one block
up to 16,384 elements, two passes above), ``int8_dequantize`` and
``int8_quantize_roundtrip`` (the quantize's launch writing the
dequantized values too; its payload and header bitwise the quantize
kernel's, its values the dequantize kernel's of them) bitwise
against their plain versions on the card: every full-width boundary
shape of ``SplitEngine.run`` at B=1 (k = 0..7, 3,200-12,800 elements,
3,328 and 6,656 at k = 6 and 7), B=32 at k=0, sizes 1, 3, 5, 4095, 4097,
16,384, 16,385 and 2^24 + 3, a constant tensor (the scale floor), one
outlier, views that are not 16-byte aligned (12,800 and 16,385 elements)
and one NaN (at 3,328 and 16,385), +inf or -inf element (NaN equal to
NaN); two launches
must give the same bits, and ``run`` at B=1 must equal
``run_batch_async`` at B=1 bitwise at every k.  It times the three
kernels, their plain versions and ``torch.aminmax`` (beside pass 1; it
is the min/max pass alone, so the record keeps it as ``minmax_pass_ms``
and ``library_ms`` is null) at the per-frame shapes and at 2^24 + 3, and
the round trip against quantize + dequantize.

Phase 8 runs ``StreamServer`` over a full-width gateway (capacity 256,
window 100, overlapped) with ``make_policy("rl")`` on ``init_policy``
from a seed: 16 INTERACTIVE, 48 STANDARD and 192 BULK sessions send 8
frames each with seeded telemetry, ``SchedulerCfg(max_batch=128)``, half
of what a round offers.  (a) Stepped on a fake clock, counted: every
served embedding must equal, bitwise, a sequential gateway on the card
replaying ``schedule()``; every tick 1 sync and 1 D2H, and one
grouped wire launch if it has a bucket with k < L; pipelined ticks;
conservation at every round; preemption of BULK only.  (b) Live: the
serving thread on the real clock, 4 client threads submitting and then
closing their sessions, gated on conservation and the sync counts only;
it prints frames/s, tick period and launch-to-collect p50/p95, the
pipelined share, per-class queue waits, deadline misses and sheds, and
the k histogram.  (c) (a)'s frames queued up front and stepped back to
back with ``pipeline`` on and off in turns (on, off, off, on): host ms
a tick, so the difference is what the overlap hides.  Last, a profiled
pipelined tick pair: device busy time and idle share.

Phase 9 holds ``flash_attention_fwd`` against its plain version on the
card (o atol 2e-5, lse atol 1e-5, two launches bitwise equal) at both
tiers' layers (B 8, H 16, S 1,024, hd 64; B 4, H 16 over KV 8, hd 128),
S = 4,096 at hd 64 and (GQA) at hd 128, ragged and single-row lengths,
Sq != Sk without the mask, head dims 16 and 32, and phase 14's prefill
shapes of zamba2-1.2b (B 8, H 32, S 1,024, hd 64) and of the arctic-480b
cut (B 2, H 56 over KV 8, S 256, hd 128); it times the kernel,
its plain version and ``scaled_dot_product_attention`` (timed only) at
the two layer shapes beside the bound, and prints the kernel's ratio to
SDPA at each.  The three attention rows share one bound: their
products at float32 accuracy on the tensor cores, 3xTF32 at a third of
the data sheet's TF32 rate (``bound_ms``), with the float32 SIMT figure
beside it (``simt_bound_ms``).

Phase 10 runs ``CascadeServer`` with qwen1.5-0.5b (small tier) and
qwen3-1.7b (large) at full width and depth, float32, weights from seeded
generators: a warm-up on a server that escalates everything, then 6
batches of 8 requests x 1,024 tokens, threshold "auto", with the counts
set to 0 just before and read just after.  Every request must be
answered once and finite, each forward must launch the flash kernel once
a layer (24 small, 28 large) and each batch the GMM kernel twice.  Then
the small tier's hidden states with the kernel against plain attention
on the card (atol 1e-4), a 2-layer qwen3-1.7b at (2, 256) on the card
against the port on the CPU (1e-4 of each tensor's max), and one
profiled small forward; it prints route, small and large ms,
requests/s and tokens/s.

Phase 11 holds the flash-attention backward kernels,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv``, against the
plain backward and against autograd through ``flash_attention_ref`` on the
card (1e-5 of each gradient's max |g|) at phase 9's cases plus Sq > Sk
under the mask and ragged GQA at hd 128; two launches must give the same
bits and the autograd entry ``flash_attention`` the kernels' bits.  It
times both kernels, their plain versions and the backward of
``scaled_dot_product_attention`` (timed only) at the two tiers' layers
beside their bounds, and the delta op of ``flash_attention``'s backward
(``delta_ms``).  SDPA's backward gives dq, dk and dv in one call, its
own delta included, so the kernels' records carry it as
``pair_library_ms`` beside ``pair_ms`` (dq + dk/dv + delta), and
``library_ms`` is null: no one PyTorch call computes dq or dk/dv alone.

Phase 12 trains.  First a 2-layer qwen1.5-0.5b at full width, (2, 256):
step 0's loss and every gradient with the hybrid term on, card against
the port on the CPU (same weights, batch and SW draws; 1e-4 of each
tensor's max; the k bias's gradient, a cancellation over the dk rows,
also on its own line), and packed positions (two sequences a row) must take the
plain path on the card (no flash launch) and match the CPU.  Then
``Trainer`` (AdamW, cosine, grad_clip 1.0, the hybrid term on, remat on,
float32) at qwen1.5-0.5b's full width and depth, B 8 x S 1,024 (3 warm-up
steps, 5 counted), and at qwen3-1.7b's full width with 4 layers, B 4 x S
1,024 (its GQA, hd-128 backward; 2 and 3), random tokens from seeded
generators on the card.  In each counted run every step must launch the
flash forward twice a layer (remat replays it), dq and dk/dv once a
layer, and ``swd_rank_fwd``, ``laplacian_energy`` and ``hybrid_reg_bwd``
once, and no other kernel; the loss must be finite and lower at the end
than at step 0.  It prints step p50/p95, tokens/s, peak memory and a
profiled step's device time by kind of kernel and idle share.

Phase 13 runs the control plane.  (a) One ``train_ppo`` iteration at
``PPOCfg()`` (2,048 steps, 32 updates of 256) on the pi4 profiles of
``get_policy``, on the card and on the CPU from the same params and
Gumbel draws: the rollouts bitwise, the params within 1e-4 of each
leaf's max; then two iterations each way, the second rollout (acting
on each device's own updated params) equal up to the first near-tie;
the card's update loop runs under ``set_sync_debug_mode("error")``, and
the card's iteration again under the profiler (bitwise the first) shows
one H2D of the pinned buffer, one D2H of the params, and no sync call in
the update loop (a profile without runtime calls fails).  (b)
``get_policy("pi4")`` and ``get_policy("m2")`` retrained on the card
(40 iterations each): every history entry finite; the rollout (host
clock) and update (CUDA events) ms of each iteration, and the card's
busy share during the updates.  (c) ``system_tables.run_all()`` under
those policies: 57 finite rows, printed as the simulator's outputs.
(d) ``wire_roundtrip_grouped`` bitwise against its plain version at
every width the loop serves, then the edge loop: ``serve_stream`` on the
``variable`` network with
phase 6's trained encoder (``AudioEncCfg()``'s widths at the stream's
98 frames) over 300 frames of ``AudioStream(StreamCfg(seed=1))``, under
``"rl"`` (the trained pi4 policy) and ``"server"``, the counts set to 0
just before and read just after (the ``control`` path): every tick one
sync, one D2H and ``wire_roundtrip_grouped`` launched once if k < L,
else no kernel; under each policy the k sequence and env summary equal
to a CPU run's, the first 32 embeddings within atol 1e-4 of it, every
embedding finite and of unit norm.  It prints the tick p50/p95 and part 3's lines of the example.

Phase 14 runs ``lm.prefill`` and ``lm.decode_step``, float32, weights
from seeded generators: qwen1.5-0.5b (B 8), qwen3-1.7b (B 4), gemma2-2b
(B 4), mamba2-780m (B 8) and zamba2-1.2b (B 8) at full width and depth
with a prompt of 1,024 random tokens and 32 greedy steps, and arctic-480b
cut to 2 layers and 8 experts (every other width as published; B 2 x
256, 8 steps); the state holds the prompt + 64 positions.  For each, a
warm-up prefill of the whole prompt and one step, ``flash_attention_fwd``
held against its plain version at the inputs that prefill gave each of
its calls (phase 9's tolerances), then three timed prefills (the median
printed) and the steps after the last, the counts set to 0 just before
each prefill and read after it and after the steps: a prefill launches
``flash_attention_fwd`` once for each attention layer ``uses_kernel``
admits (24, 28, 0, 0, 6, 2) and no other kernel, the steps launch none;
each step runs under
``set_sync_debug_mode("error")``, leaves every state tensor at its
``data_ptr`` and grows ``max_memory_allocated`` by less than one layer's
cache; ``index`` is read once, at the end (S + steps); one more step under
the profiler shows no sync, no copy call and no H2D or D2H.  Then the
prefill's logits against one teacher-forced forward over the prompt and
the decoded tokens at the prompt's last position (1e-5 of the max
|logit|), each step's logits against it at its position (1e-4; for the
families with mamba layers, whose float32 rounding the layers amplify
past 1e-4 at 48 layers (``tools/decode_bar.py --full``), 1.5e-2, and the
same steps and forward run again in float64 as the truth: decode vs
forward there within 1e-8, the float32 decode within 4e-3 of it), and
the configuration cut to 2 layers (the
hybrid to one group and its tail) at full width, the same weights on
the card and on the CPU: a prefill of 64 and 4 steps fed the same
tokens, logits and every state tensor within 1e-4 of each one's max.
It prints prefill ms, decode step p50 / p95 and tokens/s beside each
step's bytes bound (weights plus the whole ``max_len`` cache at 3.35
TB/s) and the profiled step's idle share (the ``prefill`` and ``decode``
paths of the kernels' record).

Phase 15 runs the gateway federation (``repro_torch.cluster``) of
full-width members: each a ``StreamServer`` over a ``StreamSplitGateway``
on the card with ``AudioEncCfg()`` and phase 2's seeded weights, a
mixed-k policy spreading the sessions' constant uncertainties over all 9
k-buckets, refine off, and room for every session (the survivor absorbs
the fleet).  (a) ``runtime/cluster_serve.cluster_drain`` at N = 2 and 4
members of 64 sessions (256 at N = 4), 8 rounds a phase: frames/s
before, during and after a live drain, the warm migration pause
p50/p95/max, the cold first-contact pause, the migrated sessions,
frames and bytes, the cluster step p50; the lane asserts conservation at
every snapshot, zero shed, zero lost and exactly the victim's sessions
moved with queued frames; every migrated session's stream is then held
against an unmigrated replay on one fresh card gateway (``(t, k, route,
wire_bytes)`` equal, ``z`` atol 1e-4, the bitwise share printed).  (b)
``cluster_chaos`` at N = 2 with replication off and on: a seeded kill
mid-stream, loss above 0 off and 0 on, every frame served, journal
frames replayed, the recovered streams held as in (a).  (c) the chaos
lane with replication at 2 x 8 sessions on the card and on the CPU:
every ``(sid, t, k, route, wire_bytes)`` equal, ``z`` within 1e-4 (the
largest printed), every ``ClusterStats`` book equal but the pause
times.  (d) Over (a), the counts set to 0 just before and read just
after: each member tick with a frame at k < L launches
``wire_roundtrip_grouped`` exactly once (none otherwise), no other wire
kernel runs, and every member tick makes one sync and one D2H (the
``cluster`` path of the kernels' record).  (e) ``runtime/cluster_demo``
and ``runtime/streaming_demo`` on the card, each to its end with its own
assertions.

Phase 16 runs the representation-quality tables
(``runtime/quality_tables.py``) and the three gateway examples
(``runtime/quickstart.py``, ``adaptive_serving.py``, ``fleet_demo.py``)
on the card.  (a) Each kernel at the shapes they give it, against its
plain version at phase 5's and phase 3's tolerances: ``infonce_vneg`` at
(8, 24, 32); ``swd_rank`` forward and one-half backward at (104, 32) M
32 and at §3.3's (512, 32) M 64; ``laplacian_energy`` and
its one-half backward at (1, 104, 32) k 3 and the forward at §3.3's (1,
80, 3) k 5; ``hybrid_reg_bwd`` at (1, 104, 32); ``gmm_posterior`` at
(96 and 8, 16, 32); the demos' refine kernels at (8, 32, 32) and (32,
50, 32), M 50, k 5, and their wire bitwise (grouped and one-group, B
1-32, every width).  (b) Every table at the reference's widths (14
training runs of 80 steps, Fig 9's of 55: the reference's 220 and 150
cut for the script's time limit on a slow host), with the counts set to 0
just before and read just after (the ``quality`` path), each step's
launches checked against those the code implies for its (mode, variant):
``task_sw`` and ``task_lap`` launch ``swd_rank_bwd`` and
``laplacian_energy_bwd`` (their first counted path), ``hybrid`` one
``hybrid_reg_bwd``, ``mse`` and ``kl`` neither regulariser, ``edge_only``
and ``server`` no kernel; every row finite, printed beside the paper's
number.  (c) Each distinct run's step 0 against ``EdgeTrainer`` on the
CPU from the same state and draws (loss, every gradient, the GMM; 1e-4
of each one's max).  (d) The three demos, counted by tick (the
``examples`` path): a quickstart or fleet tick one sync, one D2H and one
``wire_roundtrip_grouped`` launch iff a frame has k < L; adaptive
serving's profiled ticks a sync a bucket and one for the copy, and one
``wire_roundtrip`` a bucket with k < L; a refine round's
``swd_sessions`` and ``laplacian_energy`` in its tick.

Phase 17 runs the sharded fleet on the card, several shards as logical
shards of the one card (a sessions mesh naming it S times).  The three
refine kernels are held against their plain versions at a shard's
blocks of 2 and 4 shards, and the grouped wire at each shard's groups.
(a) ``ShardedFleetBackend`` with one shard against ``HostFleetBackend``
at phase 4's fleet (256 x 100 x 128 rings, ``HybridCfg()``, the 128->10
head, a 64-component GMM): 9 refine rounds on the same draws, bitwise
(loss, parts, per-session losses, head, memory), no snapshot copied,
round p50 / p95 of both.  (b) 2 and 4 shards: S launches of each
refine kernel a round (gated), every round and the final head and
memory against one shard at rtol 1e-4 (the bound printed), round 0
card vs CPU at rtol 1e-4.  (c) The gateway's ``shard_dispatch`` at
phase 2's serving shape, refine off: one shard bitwise against the
one-device plane, four shards at z atol 1e-4 with every (t, k, route,
wire_bytes) equal; one sync and one D2H a tick, S
``wire_roundtrip_grouped`` launches a tick and no other wire kernel, a
profiled tick's one H2D, one D2H and one wait; tick p50 / p95.  (d)
``make_compressed_dp_step`` on a quadratic over 4 shards (exact below
1e-4, int8 + error feedback below 1e-3) and ``int8_psum`` of 4 copies
of one edge training step's gradients at ``AudioEncCfg()`` (relative
error below 0.05; int8 and fp32 wire bytes).  (e) The podwise split
pipeline at the demo's shapes (``runtime/multipod_demo.py``): fp32 wire
within 1e-5 of the sequential stack, INT8 within 0.05.  (f) The drain
lane at N = 2 over members on one-shard ``ShardedFleetBackend``s under
phase 15's asserts (zero shed, zero lost, the replay oracle), and one
migration host -> sharded.  Counted as the ``sharded`` path: (a)'s
sharded rounds, (b)'s rounds and (c)'s sharded ticks.

Phase 21, run right after phase 17, refines (b)'s 2-shard fleet from two
processes: two ranks spawned on the card join a job over gloo through
the environment contract and ``maybe_init_distributed`` (ranks on one
card get no NCCL group; the collectives stage through pinned host
memory), each builds the fleet on its shard of ``make_sessions_mesh()``
(spanning the job), prefills it and runs 9 rounds.  Gated: every round's
loss, parts and per-session losses, the head and the memory bitwise
(b)'s 2-shard run; each round's SWD draws, and the head and the memory
after every round, equal across the ranks; one ``swd_sessions``, one
``laplacian_energy`` and one ``gmm_posterior`` launch a process a round
and no other; the collective counts those of (b)'s run; a rank that
dies or hangs past 300 s fails the phase.  Printed: each rank's round
p50 / p95 beside (b)'s 2-shard p50, and its staging a round (exchanges,
D2H and H2D bytes, host ms).  The kernels are held at these per-shard
shapes in phase 17.  Counted as the ``multiprocess`` path (both ranks'
rounds), with a ``{"multiprocess": ...}`` line after phase 17's.

Phase 18 runs the LM half of sharding on the card, float32, seeded
random weights, meshes of logical shards of the one card. The flash
kernels are held at each shard's block of heads against their plain
versions (phase 9's and phase 11's tolerances), and timed at (a)'s. (a)
qwen1.5-0.5b at full width and depth on (data 2, model 2), B 8 x 1,024,
AdamW, the hybrid term, remat: step 0's loss and gradients on the mesh
against the unsharded port (loss rtol 1e-5, each gathered gradient 1e-4
of its max), bitwise from run to run; ``Trainer`` under ``rules_for``
for 3 + 5 steps (the ``sharded_lm`` path: counts set to 0 before the 5),
its step 0 loss against phase 12's at rtol 1e-5, per step 2 flash
forwards, 1 dq and 1 dk/dv a layer a shard and one ``swd_rank_fwd``,
``laplacian_energy`` and ``hybrid_reg_bwd``, replicas bitwise equal, the
loss finite and falling; step p50 / p95 beside phase 12's, tokens/s,
peak memory, one profiled step. (b) qwen3-1.7b cut to 4 layers on (data
1, model 16), B 4 x 1,024: k and v row-parallel (8 kv heads over 16),
one step's loss and gradients against the unsharded port. (c)
arctic-480b cut as in phase 14 on (data 1, model 4), B 2 x 256: a
forward and one ``Trainer`` step with ``moe_ep``; a layer's ``moe_ep``
at cap 8.0 against ``moe_reference`` (2e-4), at the default 1.25 against
``moe_ep`` on the CPU (1e-4 of the max; the dropped copies printed), and
an S = 1 call (the replicated path) against ``moe_reference``. (d) (a)'s
state saved through ``CheckpointManager``, laid by ``reshard_state``
onto ``largest_feasible_mesh`` over two shards (bitwise equal to what
was saved), and one more step there.

Phase 19 runs the rest of the LM on a mesh, float32, seeded random
weights, logical shards of the card. The flash kernels are held at the
phase's per-shard shapes (forward, dq, dk/dv at (b)'s and (c)'s, the
forward at the prefills') against their plain versions and timed. (a)
mamba2-780m at full width and depth on (data 2, model 2), B 8 x 1,024,
AdamW, the hybrid term, remat: step 0's loss and gradients against the
unsharded port (rtol 1e-5, 1e-4 of each gradient's max), bitwise from
run to run, then ``Trainer`` for 1 + 2 steps, replicas bitwise after
every step, one ``swd_rank_fwd``, ``laplacian_energy`` and
``hybrid_reg_bwd`` a step; (b) zamba2-1.2b cut to 13 of its 38 mamba
layers (two uses of the shared block and a tail), B 4 x 1,024, the same
gates plus, per shard and use of the shared block, 2 flash forwards
(remat) and 1 dq and 1 dk/dv; (c) qwen3-1.7b at full width and depth
under ``rules_for(..., fsdp=True)``, B 4 x 1,024, the same gates, each
param block the shape its spec gives, then a 2-layer cut's FSDP
checkpoint restored onto (1, 2) by ``reshard_state(..., fsdp=True)``
(bitwise) and trained one step there. (d) Prefill and greedy decode
against the unsharded port in the same call (logits 1e-4 of the max
for the attention families, ``LM19_SSM_RTOL`` with mamba layers;
greedy tokens equal but for near-ties): qwen3-1.7b, B 4, prompt 1,024,
8 steps on (2, 2) (kv heads over 'model') and 4 on (1, 16) (positions
over 'model'); zamba2-1.2b at batch 1, prompt 4,096, ``max_len`` 131,072
(``long_500k``'s 524,288 cut by 4), on (2, 2) under ``kind="decode"``
(positions over 'data', SSM heads over 'model'); mamba2-780m at batch 1,
``max_len`` 524,288; phase 14's arctic cut on (1, 4). Each mesh step
under ``set_sync_debug_mode("error")`` with the state's ``data_ptr``s
fixed, one profiled step with no sync, H2D or D2H; the flash calls of
each sharded prefill held at their own inputs. Counted as the
``lm_mesh`` path: (a)-(c)'s counted steps and (d)'s mesh prefills and
steps.

Phase 20 runs the dry-run's dtype, bf16, on the card, and the head dim
of kimi-k2, 112. (a) The flash forward, dq and dk/dv kernels in bf16, and
in float32 and bf16 at hd 112, against their plain versions at the small
tier's layer (8, 16, 1,024, hd 64), the large tier's (4, 16 over 8, hd
128) and kimi-k2's (2, 64 over 8, hd 112), causal and full, and at the
edges (Sq != Sk, Sq = Sk = 1, S no multiple of a tile, GQA): bf16 o
within the reference's 3e-2 and, element by element, within one bf16 ulp
of o (2^-7 |o|) plus 2^-8 of sum_j p_j |v_j| (p rounded to bf16 for P V,
2^-9 of each term, doubled), lse 1e-5, gradients 2e-2 of each gradient's
max (p and ds are rounded to bf16 before their products); float32 at
phase 9's and 11's bars; each bitwise run to run. (b) Each kernel timed
at those shapes with CUDA events behind a spin kernel, beside its plain
version, its bound (bf16 products at 989 TFLOP/s or bytes at 3.35 TB/s)
and scaled_dot_product_attention's forward and backward (timed only).
(c) The bf16 LM (dtype and param_dtype bf16, as the dry-run sets them):
qwen3-1.7b at full width and depth, 1 + 3 ``Trainer`` steps at B 4 x
1,024 (AdamW, remat, hybrid off), a prefill of 4 x 1,024 and 32 greedy
decode steps; kimi-k2-1t-a32b cut to 2 layers (its leading dense layer
and one MoE layer) and 16 of 384 experts, top-8, at full width (d 7,168,
64 over 8 heads, hd 112), 1 + 1 steps at B 2 x 1,024 (Adafactor, 2
microbatches, the dry-run's policy), a prefill of 2 x 1,024 and 8 decode
steps. Gates: 2 flash forwards, 1 dq and 1 dk/dv a layer and microbatch
a step, of the model's variant; one forward an attention layer a
prefill; finite, falling losses; decode steps free of syncs and copies
with the state in place; prefill vs forward and decode vs a
teacher-forced forward (3e-2, 5e-2 of the max |logit|); the 2-layer cuts
of both card vs CPU in bf16 (loss 1e-2, gradients 5e-2 of every leaf's
max; the CPU's MoE router takes the experts the card's chose, so a
near-tie that rounds the other way does not reroute a token) and float32
(1e-4). Counted as the ``lm_bf16`` path, by variant.
(d) The dry-run (``repro_torch.launch.dryrun.build_and_compile``) of six
of the reference test's seven cells (not kimi-k2's) on
``make_production_mesh(devices=["meta"] * 256)`` and its 2 x 16 x 16 form
on 512: host work in ``LM20_DRYRUN_WORKERS`` worker processes, started
after (b) and (c)'s timed runs, so that nothing timed runs beside them,
and traced while (a) and (c)'s card-vs-CPU comparisons run (awaited at
most 300 s), each cell cut to its least depth (see ``LM20_DRYRUN``),
gated as
the reference's test gates them; their summary lines and the report's
two tables. A ``{"lm_bf16": ...}`` line comes before the kernels' line,
which gains a record for each bf16 and hd-112 variant.

Any failure exits non-zero.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any
result.  The line before the last is the kernels' JSON record (after a
line with phase 12's summary, one with phase 13's, one with phase 14's
one with phase 15's, one with phase 16's, one with phase 17's, one with
phase 21's, one with phase 18's, one with phase 19's and one with phase
20's records);
the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SESSIONS = 256
TIMED_TICKS = 8
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor) peak
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the same data sheet's dense TF32 tensor-core peak, 495 TFLOP/s, over the
# three TF32 products a float32-accurate product takes in 3xTF32: the
# attention rows' yardstick, since float32 accuracy is their contract
TF32X3_OPS_PER_S = 495e12 / 3
BATCH_SIZES = (1, 3, 8, 32, 256)
CPU_ATOL = 1e-4
# the refine path: fleet rings, SW directions, Laplacian window, GMM
WINDOW, N_DIRS, KNN, N_COMPONENTS, N_CLASSES = 100, 50, 5, 64, 10
SWD_RTOL, LAP_RTOL, RESP_ATOL, ENT_ATOL = 1e-4, 1e-5, 1e-4, 5e-4
REFINE_RTOL = 1e-4      # card vs CPU, relative to each tensor's max |x|


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def same_values(a, b):
    """Equal tensors, NaN equal to NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0),
                                               b.masked_fill(nb, 0))


class SpreadPolicy:
    """Frame i of a tick gets k = i % (L+1): every split index, every
    tick, in buckets of equal size (+-1)."""

    def __init__(self, L):
        self.L = L

    def decide(self, obs_batch):
        return np.arange(len(obs_batch), dtype=np.int64) % (self.L + 1)


def wire_widths(cfg):
    """Elements per frame that cross the wire at k = 0..L-1: the raw mel
    at k=0, then the activation after block k ("SAME" convolutions keep
    ⌈t/s⌉ frames)."""
    out, t = [cfg.frames * cfg.n_mels], cfg.frames
    for w, s in zip(cfg.widths[:-1], cfg.strides[:-1]):
        t = -(-t // s)
        out.append(t * w)
    return out


def time_ms(fn, x, reps=200):
    """Mean ms per call of ``fn(x)`` over ``reps`` calls, CUDA events."""
    for _ in range(10):
        fn(x)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase1(cfg, dev, ops, dequantize, quantize):
    """Each kernel against its plain version on the card -> max |err|."""
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for n in sorted(set(wire_widths(cfg))):
        for B in BATCH_SIZES:
            x = torch.randn(B, n, device=dev, generator=g) * 3.0 + 1.0
            if B >= 3:
                x[0] = 1.25                  # constant row: scale floor
                x[1, 17] = 1e4               # outlier row
                x[2, 5] = float("nan")       # NaN row: NaN throughout
            if B >= 5:
                x[3, 11] = float("inf")      # NaN but +inf's own element
                x[4, 7] = float("-inf")      # NaN throughout
            got = ops.wire_roundtrip(x)
            want = ops.wire_roundtrip_ref(x)
            torch.cuda.synchronize()
            err = (got - want).nan_to_num().abs().max().item()
            worst = max(worst, err)
            check(same_values(got, want),
                  f"wire_roundtrip != plain version at B={B}, n={n} "
                  f"(max |err| {err})")
        x = torch.randn(1, n, device=dev, generator=g)
        check(torch.equal(ops.wire_roundtrip(x), dequantize(quantize(x))),
              f"wire_roundtrip at B=1, n={n} != per-tensor round trip")
    torch.cuda.synchronize()
    print(f"phase 1: wire_roundtrip bitwise == plain version at B in "
          f"{BATCH_SIZES} x n in {sorted(set(wire_widths(cfg)))} (constant, "
          f"outlier and NaN rows at B >= 3, +inf and -inf rows at B >= 5), "
          f"and == "
          f"per-tensor at B=1 (max |err| {worst})")
    cases = grouped_cases(cfg, g, dev)
    for what, xs in cases:
        got, again = (ops.wire_roundtrip_grouped(xs),
                      ops.wire_roundtrip_grouped(xs))
        want = ops.wire_roundtrip_grouped_ref(xs)
        each = [ops.wire_roundtrip(x) for x in xs]
        torch.cuda.synchronize()
        check(len(got) == len(xs), f"grouped wire at {what}: {len(got)} "
              f"outputs for {len(xs)} groups")
        for i, (a, b, c, w) in enumerate(zip(got, again, each, want)):
            err = (a - w).nan_to_num().abs().max().item()
            worst = max(worst, err)
            check(same_values(a, w), f"wire_roundtrip_grouped != plain "
                  f"version at {what}, group {i} {tuple(w.shape)} (max "
                  f"|err| {err})")
            check(same_values(a, c), f"wire_roundtrip_grouped != its "
                  f"one-group launch at {what}, group {i}")
            check(same_values(a, b), f"wire_roundtrip_grouped not bitwise "
                  f"from run to run at {what}, group {i}")
    print(f"phase 1: wire_roundtrip_grouped bitwise == plain version, == "
          f"one wire_roundtrip launch a group and from run to run at "
          f"{len(cases)} cases (" + "; ".join(w for w, _ in cases)
          + f"), special rows in every group (max |err| {worst})")
    hold16_wire(cfg, g, dev, ops)
    return worst


def special_rows(x):
    """Constant, outlier, NaN, +inf and -inf rows, as many as ``x`` (B,
    n) has rows for."""
    for row, (col, v) in enumerate(((None, 1.25), (17, 1e4),
                                    (5, float("nan")), (11, float("inf")),
                                    (7, -float("inf")))):
        if row >= x.shape[0]:
            break
        if col is None:
            x[row] = v
        else:
            x[row, col % x.shape[1]] = v
    return x


def grouped_cases(cfg, g, dev):
    """(what, [tensors]) for the grouped wire: the tick's eight groups at
    phase 2's bucket sizes and padded to 32, one group, the most groups
    a launch takes, B = 1 groups, and groups of one width."""
    from repro_torch.kernels.int8_quant import MAX_GROUPS as most
    widths = wire_widths(cfg)

    def groups(rows, ns):
        return [special_rows(torch.randn(B, n, device=dev, generator=g)
                             * 3.0 + 1.0) for B, n in zip(rows, ns)]
    return [
        ("the tick's 8 groups, 28/29 rows",
         groups((28, 29, 28, 28, 29, 28, 28, 29), widths)),
        ("the tick's 8 groups padded to 32", groups((32,) * 8, widths)),
        ("one group (256, 12,800)", groups((256,), widths[:1])),
        (f"{most} groups", groups(
            [1 + i % 6 for i in range(most)],
            [widths[i % len(widths)] + 4 * (i // len(widths))
             for i in range(most)])),
        ("B = 1 groups", groups((1,) * len(widths), widths)),
        ("3 groups of n = 6,656", groups((5, 1, 7), (6656,) * 3)),
        ("odd widths (the two-read path)", groups((3, 2), (12801, 16388))),
    ]


def serve(gw, sids, mels_by_tick, *, timed, t0=0, label_mod=0):
    """Submit and tick, frame indices from ``t0`` (labelled ``t %
    label_mod`` when given); -> (results of each tick, tick seconds)."""
    from repro_torch.api import FrameRequest
    out, secs = [], []
    for t, mels in enumerate(mels_by_tick, start=t0):
        label = t % label_mod if label_mod else -1
        for i, sid in enumerate(sids):
            gw.submit(sid, FrameRequest(t=t, mel=mels[i], label=label))
        start = time.perf_counter()
        out.append(gw.tick())
        secs.append(time.perf_counter() - start)
        if timed:
            s = gw.stats()
            check(s.device_syncs_per_tick == 1 and s.d2h_copies_per_tick == 1,
                  f"tick {t}: {s.device_syncs_per_tick} syncs, "
                  f"{s.d2h_copies_per_tick} D2H copies (want 1 and 1)")
    return out, secs


def gateway(cfg, params, device, **kw):
    from repro_torch.api import HostFleetBackend, QoSClass, StreamSplitGateway
    gw = StreamSplitGateway(
        cfg, params, policy=SpreadPolicy(cfg.n_blocks),
        backend=HostFleetBackend(capacity=SESSIONS, window=100,
                                 dim=cfg.d_embed),
        qos_reserve=0, device=device, **kw)
    sids = [gw.open_session(qos=QoSClass.INTERACTIVE).sid
            for _ in range(SESSIONS)]
    return gw, sids


def phase2(cfg, dev, ops):
    """The serving path at full width, then comparisons and one profiled
    tick -> the kernels' launch counts from the counted run."""
    from repro_torch.core.splitter import SplitEngine
    from repro_torch.models.audio_encoder import init_audio_encoder
    from repro_torch.weights import to_device
    L = cfg.n_blocks
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((SESSIONS, cfg.frames, cfg.n_mels),
                                np.float32) for _ in range(1 + TIMED_TICKS)]
    gw, sids = gateway(cfg, params, "cuda")

    # --- the main path, counted: warm-up tick + timed ticks -------------
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    per_tick = []
    results, secs = [], []
    for t in range(1 + TIMED_TICKS):
        before = ops.wire_roundtrip_grouped.launches
        res, sec = serve(gw, sids, [mels[t]], timed=True, t0=t)
        results += res
        secs += sec
        per_tick.append(ops.wire_roundtrip_grouped.launches - before)
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()

    for t, res in enumerate(results):
        check(len(res) == SESSIONS, f"tick {t}: {len(res)} results")
        check([r.sid for r in res] == sids, f"tick {t}: not in submission "
              "order")
        z = np.stack([r.z for r in res])
        check(z.shape == (SESSIONS, cfg.d_embed) and np.isfinite(z).all(),
              f"tick {t}: embeddings not finite or of shape {z.shape}")
        norm_err = float(np.abs(np.linalg.norm(z, axis=1) - 1.0).max())
        check(norm_err <= 1e-5, f"tick {t}: | ||z|| - 1 | = {norm_err}")
        check(sorted({r.k for r in res}) == list(range(L + 1)),
              f"tick {t}: not every k served")
        check({r.bucket_size for r in res} <= {28, 29}, "bucket sizes")
        for r in res:
            want = 0 if r.k == L else wire_widths(cfg)[r.k] + 8
            check(r.wire_bytes == want, f"k={r.k}: wire bytes {r.wire_bytes}")
    check(per_tick == [1] * (1 + TIMED_TICKS),
          f"grouped wire launches per tick {per_tick}, want 1 (k=0..{L-1} "
          "in one launch)")
    check(launches["wire_roundtrip_grouped"] == 1 + TIMED_TICKS
          and launches["wire_roundtrip"] == 0, f"launches {launches}")
    stats = gw.stats()
    want_staged = (1 + TIMED_TICKS) * SESSIONS * cfg.frames * cfg.n_mels * 4
    check(stats.staged_h2d_bytes == want_staged,
          f"staged_h2d_bytes {stats.staged_h2d_bytes} != {want_staged}")
    check(stats.frames == (1 + TIMED_TICKS) * SESSIONS
          and stats.dispatches == (1 + TIMED_TICKS) * (L + 1), "counters")
    tick_ms = np.array(secs[1:]) * 1e3
    print(f"phase 2: {1 + TIMED_TICKS} ticks x {SESSIONS} frames at full "
          f"width, 1 sync + 1 D2H per tick, 1 wire launch per tick ({L} "
          f"buckets), "
          f"staged {stats.staged_h2d_bytes} bytes")
    print(f"tick ms p50 {np.percentile(tick_ms, 50):.3f} p95 "
          f"{np.percentile(tick_ms, 95):.3f} mean {tick_ms.mean():.3f}; "
          f"frames/s {SESSIONS / tick_ms.mean() * 1e3:.1f} "
          f"(warm-up tick {secs[0] * 1e3:.1f} ms)")

    # --- comparisons (outside the counted run) ----------------------------
    first = np.stack([r.z for r in results[0]])
    gw_sync, sids_sync = gateway(cfg, params, "cuda", overlap=False)
    (res_sync,), _ = serve(gw_sync, sids_sync, [mels[0]], timed=False)
    check(np.array_equal(np.stack([r.z for r in res_sync]), first),
          "overlap=False on the card != overlap=True")
    gw_cpu, sids_cpu = gateway(cfg, params, "cpu")
    (res_cpu,), _ = serve(gw_cpu, sids_cpu, [mels[0]], timed=False)
    cpu_err = float(np.abs(np.stack([r.z for r in res_cpu]) - first).max())
    check(cpu_err <= CPU_ATOL, f"card vs CPU max |dz| {cpu_err}")
    eng = SplitEngine(cfg, device=dev)
    p_dev = to_device(params, dev)

    # --- the per-frame split path, counted: SplitEngine.run per frame,
    # its per-tensor wire through the int8_quantize/int8_dequantize
    # kernels ------------------------------------------------------------
    # Each frame's z is held bitwise against the same stages with the
    # plain wire (int8_dequantize_ref(int8_quantize_ref(act))) on the same
    # edge activation, which launches no kernel.
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    frame_err = 0.0
    for i, r in enumerate(results[0]):
        mel = mels[0][i:i + 1]
        z, _ = eng.run(p_dev, mel, r.k)
        if r.k < L:
            act = eng._edge_fn(r.k, p_dev, eng._to_device(mel))
            plain = eng._server_fn(r.k, p_dev, ops.int8_dequantize_ref(
                ops.int8_quantize_ref(act)))
            check(torch.equal(z, plain), f"SplitEngine.run frame {i} (k="
                  f"{r.k}) != the same stages on the plain per-tensor wire")
        frame_err = max(frame_err, float(np.abs(z.cpu().numpy()[0]
                                                - r.z).max()))
    frame_launches = {name: w.launches for name, w in ops.KERNELS.items()}
    n_wire = sum(r.k < L for r in results[0])
    check(frame_launches["int8_quantize_roundtrip"] == n_wire
          and all(frame_launches[name] == 0 for name in (
              "int8_quantize", "int8_dequantize", "wire_roundtrip",
              "wire_roundtrip_grouped")),
          f"per-frame run launches {frame_launches}, want {n_wire} of "
          "int8_quantize_roundtrip and no other wire kernel")
    print(f"overlap=False == overlap=True bitwise; card vs CPU port max "
          f"|dz| {cpu_err:.3e} (atol {CPU_ATOL}); bucketed vs per-frame "
          f"SplitEngine.run max |dz| {frame_err:.3e} (per-frame path: "
          f"{SESSIONS} frames, each bitwise == its stages on the plain "
          f"per-tensor wire, int8_quantize_roundtrip launches "
          f"{frame_launches['int8_quantize_roundtrip']})")
    profile_tick(gw, sids, mels[0], 1 + TIMED_TICKS, tick_ms)
    return launches, tick_ms, frame_launches


def device_ms(fn, x, reps=40, spin_cycles=200_000_000):
    """Mean device ms per call of ``fn(x)``: a spin kernel holds the
    stream while the host enqueues ``reps`` calls, so they run back to
    back and the CUDA events time the device, not the host's launch
    overhead.  Fails if the host took longer to enqueue than the spin."""
    for _ in range(3):
        fn(x)
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    torch.cuda.synchronize()
    spin.record()
    torch.cuda._sleep(spin_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(host_ms < spin.elapsed_time(start),
          f"enqueue of {reps} calls ({host_ms:.1f} ms) outlasted the spin")
    return start.elapsed_time(end) / reps


def profile_tick(gw, sids, mels, t, tick_ms):
    """One more tick under torch.profiler: device time by kind of kernel
    and the device's idle share of an unprofiled tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve(gw, sids, [mels], timed=False, t0=t)
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiled tick: not measured (torch.profiler recorded no "
              "device activity)")
        return
    kinds = {"conv": 0.0, "wire": 0.0, "copy": 0.0, "other": 0.0}
    count = 0
    for name, us in events:
        low = name.lower()
        kind = ("wire" if "wire_roundtrip" in low
                else "copy" if low.startswith(("memcpy", "memset"))
                else "conv" if any(w in low for w in (
                    "conv", "xmma", "gemm", "cudnn", "winograd", "fft"))
                else "other")
        kinds[kind] += us
        count += 1
    busy_ms = sum(kinds.values()) / 1e3
    p50 = float(np.percentile(tick_ms, 50))
    print(f"profiled tick: {count} device activities, busy {busy_ms:.3f} ms "
          f"(" + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in kinds.items())
          + f"); idle share of the unprofiled p50 tick ({p50:.3f} ms): "
          f"{1.0 - busy_ms / p50:.3f}")


def kernel_times(cfg, dev, ops):
    """The tick's wire at the serving shapes (32 rows a bucket, the padded
    bucket, k = 0..L-1): ``wire_roundtrip_grouped`` (one launch), eight
    ``wire_roundtrip`` launches (one a bucket, as the tick ran before the
    grouped launch) and the plain version, as device time
    (``device_ms``) and time per call (CUDA events around back-to-back
    calls, which the host's launch overhead sets when it exceeds the
    device time) -> the tick's times and the bound."""
    bucket = 32
    g = torch.Generator(device=dev).manual_seed(1)
    xs = [torch.randn(bucket, n, device=dev, generator=g)
          for n in wire_widths(cfg)]

    def eight(ys):
        return [ops.wire_roundtrip(y) for y in ys]
    for k, x in enumerate(xs):
        print(f"wire k={k} {tuple(x.shape)}: one-group launch "
              f"{device_ms(ops.wire_roundtrip, x) * 1e3:.2f} us")
    elems = sum(x.numel() for x in xs)
    # read x once, write out once; min + max + div + add + round + 2 clamps
    # + sub + mul per element
    tot = {"ms": device_ms(ops.wire_roundtrip_grouped, xs),
           "eight_launches_ms": device_ms(eight, xs),
           # ~80 PyTorch launches a call: fewer calls, so that their
           # enqueue stays inside the spin
           "plain_ms": device_ms(ops.wire_roundtrip_grouped_ref, xs, reps=8),
           "call_ms": time_ms(ops.wire_roundtrip_grouped, xs),
           "eight_launches_call_ms": time_ms(eight, xs),
           "bytes_ms": 8 * elems / HBM_BYTES_PER_S * 1e3,
           "ops_ms": 9 * elems / FP32_OPS_PER_S * 1e3}
    tot["bound_ms"] = max(tot["bytes_ms"], tot["ops_ms"])
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                       else "operations")
    print(f"wire per tick ({len(xs)} buckets of {bucket} rows): grouped "
          f"(1 launch) device {tot['ms'] * 1e3:.2f} us, per call "
          f"{tot['call_ms'] * 1e3:.2f} us; {len(xs)} wire_roundtrip launches "
          f"device {tot['eight_launches_ms'] * 1e3:.2f} us, per call "
          f"{tot['eight_launches_call_ms'] * 1e3:.2f} us; plain "
          f"{tot['plain_ms'] * 1e3:.2f} us; bound "
          f"{tot['bound_ms'] * 1e3:.2f} us ({tot['bound_by']})")
    return tot


# --- the refine path -------------------------------------------------------

def unit_rows(g, shape, dev):
    z = torch.randn(*shape, device=dev, generator=g)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def refine_inputs(g, dev, S, W, d, M):
    """Unit-norm z (S, W, d) with ~10% gaps (z = 0, mask = 0), row 1
    all-masked (its z kept), session 2 all zero; M unit directions and
    the sorted slice quantiles of a W-sample sphere prior."""
    z = unit_rows(g, (S, W, d), dev)
    mask = (torch.rand(S, W, device=dev, generator=g) >= 0.1).float()
    keep = z[1].clone() if S > 1 else None
    z *= mask[..., None]
    if S > 2:
        z[1], mask[1] = keep, 0.0
        z[2], mask[2] = 0.0, 0.0
    dirs = unit_rows(g, (M, d), dev)
    prior = unit_rows(g, (W, d), dev)
    prior_q = torch.sort(prior @ dirs.T, dim=0).values.contiguous()
    return z.contiguous(), mask, dirs, prior_q


def gmm_inputs(g, dev, B, C, d, floor=False):
    """z (B, d) on the sphere against a GMM from ``gmm.init_gmm`` (var
    0.05); ``floor`` puts half the variances at the 1e-4 floor and every
    third frame next to one of those means."""
    from repro_torch.core import gmm
    pi, mu, var = gmm.params_of(gmm.init_gmm(
        torch.Generator(device=dev).manual_seed(C + d), C, d))
    z = unit_rows(g, (B, d), dev)
    var = var.clone()
    if floor:
        var[::2] = 1e-4
        idx = torch.arange(0, B, 3, device=dev)
        z[idx] = mu[(idx * 2) % C] + 1e-3 * torch.randn(
            len(idx), d, device=dev, generator=g)
    return z, mu.contiguous(), var.contiguous(), torch.log(pi)


def hold(name, kernel, plain, args, tols, what):
    """``kernel(*args)`` against ``plain(*args)``, output by output,
    within ``tols`` [(rtol, atol)], and bitwise against a second launch
    -> the largest |difference|."""
    got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for a, b, c, (rtol, atol) in zip(got, again, want, tols):
        check(torch.equal(a, b), f"{name} not bitwise from run to run at "
              f"{what}")
        err = (a - c).abs().max().item()
        worst = max(worst, err)
        check(torch.allclose(a, c, rtol=rtol, atol=atol),
              f"{name} != plain version at {what}: max |err| {err} "
              f"(rtol {rtol}, atol {atol})")
    return worst


def off_16_bytes(x):
    """A contiguous copy of ``x`` one float past a 16-byte boundary (the
    kernels' scalar path)."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def phase3(dev, ops):
    """Each refine kernel against its plain version on the card ->
    {name: max |err|}."""
    g = torch.Generator(device=dev).manual_seed(3)
    d, S = 128, SESSIONS
    worst = dict.fromkeys(("swd_sessions", "laplacian_energy",
                           "gmm_posterior"), 0.0)
    swd = lambda z, dirs, pq: (ops.swd_sessions(z, dirs, pq),)  # noqa: E731
    swd_ref = lambda z, dirs, pq: (  # noqa: E731
        ops.swd_sessions_ref(z, dirs, pq),)
    # the edges of the kernel's tiling and sort: W = 1 (one lane's value,
    # 31 sentinels), W = 300 (P = 512, 16 values a lane), W = 1,200 (P =
    # 2,048: d in chunks, the directions in groups), M = 1, and d = 127
    # (4-byte copies, a zero-filled column)
    for s_, W, M, d_ in ((S, WINDOW, N_DIRS, d), (S, 16, N_DIRS, d),
                         (S, 128, N_DIRS, d), (64, WINDOW, 8, d),
                         (64, WINDOW, 3, d), (7, 37, 13, d),
                         (64, 1, N_DIRS, d), (32, 300, N_DIRS, d),
                         (4, 1200, N_DIRS, d), (64, WINDOW, 1, d),
                         (9, WINDOW, N_DIRS, 127)):
        z, _, dirs, pq = refine_inputs(g, dev, s_, W, d_, M)
        worst["swd_sessions"] = max(worst["swd_sessions"], hold(
            "swd_sessions", swd, swd_ref, (z, dirs, pq), [(SWD_RTOL, 0.0)],
            f"S={s_} W={W} M={M} d={d_}"))
    lap_cases = [(g, s_, T, d, k, False) for s_, T, k in (
        (S, WINDOW, KNN), (S, 16, KNN), (S, 128, KNN), (64, 16, 20),
        (16, 1, KNN), (9, 37, 3))]
    # the Laplacian kernel's plan at its edges (inputs from their own
    # generator): whole chunks (T 64: 8 chunks of 8 frames) and a last
    # chunk of one frame (T 57), K at a chunk's length (13 frames at T 100:
    # three delta groups of the 5-frame ring) and past it (20: four), d =
    # 127 (scalar lanes) and 2,048 (16 column slices, a cluster of 8 blocks
    # a row), B = 1 with T = 1,000 (63 chunks of 16), B = 300, and z one
    # float off 16 bytes (scalar lanes)
    g_lap = torch.Generator(device=dev).manual_seed(33)
    lap_cases += [(g_lap, *c) for c in (
        (S, 64, d, KNN, False), (S, 57, d, KNN, False),
        (S, WINDOW, d, 13, False), (S, WINDOW, d, 20, False),
        (9, 37, 127, 3, False), (4, WINDOW, 2048, KNN, False),
        (1, 1000, d, KNN, False), (300, WINDOW, d, KNN, False),
        (8, WINDOW, d, KNN, True))]
    for gen, s_, T, d_, k, off in lap_cases:
        z, mask, _, _ = refine_inputs(gen, dev, s_, T, d_, 1)
        if off:
            z = off_16_bytes(z)
        lap = lambda z, m: ops.laplacian_energy(z, m, k)  # noqa: E731
        lap_ref = lambda z, m: ops.laplacian_energy_ref(z, m, k)  # noqa
        worst["laplacian_energy"] = max(worst["laplacian_energy"], hold(
            "laplacian_energy", lap, lap_ref, (z, mask),
            [(LAP_RTOL, 0.0), (0.0, 0.0)],
            f"B={s_} T={T} d={d_} k={k}" + (" misaligned" if off else "")))
    for B, C, floor in ((S * WINDOW, N_COMPONENTS, False),
                        (1007, N_COMPONENTS, True), (333, 10, False)):
        worst["gmm_posterior"] = max(worst["gmm_posterior"], hold(
            "gmm_posterior", ops.gmm_posterior, ops.gmm_posterior_ref,
            gmm_inputs(g, dev, B, C, d, floor),
            [(0.0, RESP_ATOL), (0.0, ENT_ATOL)],
            f"B={B} C={C}{' at the variance floor' if floor else ''}"))
    # the cascade's GMM at d_model = 1,024, d = 2,048, and the edges of the
    # kernel's tiling: one row, a ragged last chunk of d, few components
    wide = max(hold(
        "gmm_posterior", ops.gmm_posterior, ops.gmm_posterior_ref,
        gmm_inputs(g, dev, B, C, d_), [(0.0, RESP_ATOL), (0.0, ENT_ATOL)],
        f"B={B} C={C} d={d_}")
        for B, C, d_ in ((8, N_COMPONENTS, 1024), (64, N_COMPONENTS, 2048),
                         (1, N_COMPONENTS, d), (8, N_COMPONENTS, 1000),
                         (8, 10, 1024)))
    print("phase 3: swd_sessions (rtol 1e-4; also W = 1, 300, 1,200, M = "
          "1, d = 127), laplacian_energy (rtol 1e-5, counts exact; also "
          "whole chunks and a last chunk of one frame, K 13 and 20, d = 127 "
          "and 2,048, B = 1 with T = 1,000, B = 300, a misaligned z) and "
          "gmm_posterior (resp atol 1e-4, entropy atol "
          "5e-4) == plain version at the refine shapes and edge cases, "
          "bitwise from run to run; max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f"; gmm_posterior at (B, C, d) = (8, 64, 1,024), (64, 64, "
          f"2,048), (1, 64, 128), (8, 64, 1,000), (8, 10, 1,024) "
          f"{wide:.3e}")
    worst["gmm_posterior"] = max(worst["gmm_posterior"], wide)
    hold16_gmm(g, dev, ops)
    return worst


def init_linear_head(generator):
    """A linear 128 -> 10 head from a seeded generator."""
    return {"w": 0.01 * torch.randn(128, N_CLASSES, generator=generator),
            "b": torch.zeros(N_CLASSES)}


def linear_head(p, z):
    return z @ p["w"] + p["b"]


def refine_backend(cfg, device, head_init):
    from repro_torch.api import HostFleetBackend
    from repro_torch.core.hybrid import HybridCfg
    return HostFleetBackend(
        capacity=SESSIONS, window=WINDOW, dim=cfg.d_embed,
        head_init=head_init, head_apply=linear_head, cfg=HybridCfg(),
        lr=1e-2, seed=0, n_components=N_COMPONENTS, memory_decay=0.05,
        device=device)


def prefill(backend, sids, rng):
    """99 frames a session of unit-norm embeddings with ~10% drops,
    labelled t mod 10 (as ``benchmarks/fleet_serve.py`` fills rings)."""
    sids = np.asarray(sids)
    for t in range(WINDOW - 1):
        keep = sids[rng.random(len(sids)) >= 0.1]
        z = rng.standard_normal((len(keep), 128)).astype(np.float32)
        z /= np.linalg.norm(z, axis=1, keepdims=True)
        backend.insert_batch(keep, np.full(len(keep), t), z,
                             np.full(len(keep), t % N_CLASSES))


def rel_err(a, b):
    """max |a - b| / max |b| over two tensors (or arrays)."""
    a, b = (torch.as_tensor(np.asarray(x), dtype=torch.float32)
            for x in (a, b))
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase4(cfg, dev, ops, serve_tick_ms):
    """The gateway with a refine round every tick at full width ->
    (launch counts of the counted run, refine round host ms)."""
    from repro_torch.api import QoSClass, StreamSplitGateway
    from repro_torch.models.audio_encoder import init_audio_encoder
    L = cfg.n_blocks
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))
    be = refine_backend(cfg, "cuda", init_linear_head)
    gw = StreamSplitGateway(cfg, params, policy=SpreadPolicy(L), backend=be,
                            qos_reserve=0, refine_every=1, device="cuda")
    sids = [gw.open_session(qos=QoSClass.INTERACTIVE).sid
            for _ in range(SESSIONS)]
    rng = np.random.default_rng(1)
    prefill(be, sids, rng)
    mels = [rng.standard_normal((SESSIONS, cfg.frames, cfg.n_mels),
                                np.float32) for _ in range(1 + TIMED_TICKS)]
    head0 = {k: v.detach().cpu().clone()
             for k, v in be.refiner.state.params.items()}
    mem0 = be.memory.to("cpu")
    rounds = []          # (loss, parts, per-session losses), host seconds
    refine = be.refine

    def timed_refine(rnd):
        start = time.perf_counter()
        out = refine(rnd)
        rounds.append((out, time.perf_counter() - start))
        return out
    be.refine = timed_refine

    # --- the refine path, counted: warm-up tick + timed ticks -----------
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    secs = []
    for i in range(1 + TIMED_TICKS):
        _, sec = serve(gw, sids, [mels[i]], timed=True, t0=WINDOW - 1 + i,
                       label_mod=N_CLASSES)
        secs += sec
        if i == 0:       # round 0's snapshot, and the state it left
            rows = [be.export_row(sid) for sid in sids]
            head1 = {k: v.detach().cpu().clone()
                     for k, v in be.refiner.state.params.items()}
            mem1 = be.memory.to("cpu")
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()

    n_rounds = 1 + TIMED_TICKS
    stats = gw.stats()
    check(stats.ticks == n_rounds and stats.refine_rounds == n_rounds
          and len(rounds) == n_rounds,
          f"{stats.refine_rounds} refine rounds in {stats.ticks} ticks")
    for (loss, parts, per), _ in rounds:
        check(np.isfinite(loss) and np.isfinite(list(parts.values())).all()
              and np.isfinite(per).all() and per.shape == (SESSIONS,),
              f"refine round not finite: {loss}, {parts}")
    check(stats.last_refine_loss == rounds[-1][0][0], "last_refine_loss")
    for name in ("swd_sessions", "laplacian_energy", "gmm_posterior"):
        check(launches[name] == n_rounds,
              f"{name} launched {launches[name]} times in {n_rounds} rounds")
    check(launches["wire_roundtrip_grouped"] == n_rounds
          and launches["wire_roundtrip"] == 0, f"launches {launches}")
    snap = (SESSIONS * WINDOW * (cfg.d_embed * 4 + 4 + 8) + SESSIONS)
    check(stats.snapshot_h2d_bytes == n_rounds * snap,
          f"snapshot_h2d_bytes {stats.snapshot_h2d_bytes} != {n_rounds} x "
          f"{snap}")
    refine_ms = np.array([sec for _, sec in rounds[1:]]) * 1e3
    tick_ms = np.array(secs[1:]) * 1e3
    print(f"phase 4: {n_rounds} ticks x {SESSIONS} frames with a refine "
          f"round each, 1 sync + 1 D2H per tick, launches "
          f"{launches}, snapshot "
          f"{stats.snapshot_h2d_bytes} bytes ({n_rounds} x {snap}); losses "
          f"{rounds[0][0][0]:.6f} -> {rounds[-1][0][0]:.6f}")
    warm_ms = rounds[0][1] * 1e3
    print(f"refine round ms p50 {np.percentile(refine_ms, 50):.3f} p95 "
          f"{np.percentile(refine_ms, 95):.3f} (warm-up {warm_ms:.1f}); "
          f"tick with refine ms p50 {np.percentile(tick_ms, 50):.3f} "
          f"p95 {np.percentile(tick_ms, 95):.3f} against phase 2's p50 "
          f"{np.percentile(serve_tick_ms, 50):.3f}")

    # --- round 0 against the port on the CPU (outside the counted run) --
    cpu = refine_backend(cfg, "cpu", lambda generator: head0)
    cpu.memory = mem0
    for sid, row in zip(sids, rows):
        check(cpu.admit() == sid, "CPU backend admitted another row")
        cpu.import_row(sid, *row)
    (loss, parts, per), _ = rounds[0]
    c_loss, c_parts, c_per = cpu.refine(0)
    errs = {"loss": abs(loss - c_loss) / abs(c_loss),
            **{k: abs(parts[k] - c_parts[k]) / abs(c_parts[k])
               for k in parts},
            "per-session": float(np.max(np.abs(per - c_per)
                                        / np.abs(c_per))),
            **{f"head.{k}": rel_err(head1[k], v)
               for k, v in cpu.refiner.state.params.items()},
            **{f"gmm.{k}": rel_err(getattr(mem1, k), getattr(cpu.memory, k))
               for k in ("s0", "s1", "s2")}}
    print("round 0, card vs the port on the CPU (relative; head and GMM "
          "relative to each tensor's max |x|): " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= REFINE_RTOL, f"round 0 card vs CPU: {k} {v} > "
              f"{REFINE_RTOL}")
    profile_refine(be, n_rounds, float(np.percentile(refine_ms, 50)))
    return launches, refine_ms


def profile_refine(be, rnd, p50):
    """The host numpy snapshot's share of a round, then one more round
    under torch.profiler: device time by kind and the device's idle share
    of the unprofiled p50 round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = time.perf_counter()
    for _ in range(5):
        be.snapshot()
    print(f"host snapshot of the rings (numpy, inside every round): "
          f"{(time.perf_counter() - start) / 5 * 1e3:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        be.refine(rnd)
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiled refine round: not measured (torch.profiler recorded "
              "no device activity)")
        return
    kinds = dict.fromkeys(("swd", "laplacian", "gmm_posterior", "gemm",
                           "copy", "other"), 0.0)
    for name, us in events:
        low = name.lower()
        # the GMM call's two kernels are gmm_maha_kernel and
        # gmm_softmax_kernel
        kind = next((k for w, k in (("swd", "swd"), ("laplacian", "laplacian"),
                                    ("gmm_", "gmm_posterior")) if w in low),
                    None) or (
            "copy" if low.startswith(("memcpy", "memset")) else
            "gemm" if any(w in low for w in ("gemm", "cutlass", "xmma"))
            else "other")
        kinds[kind] += us
    busy_ms = sum(kinds.values()) / 1e3
    print(f"profiled refine round: {len(events)} device activities, busy "
          f"{busy_ms:.3f} ms (" + ", ".join(
              f"{k} {v / 1e3:.3f} ms" for k, v in kinds.items())
          + f"); idle share of the unprofiled p50 round ({p50:.3f} ms): "
          f"{1.0 - busy_ms / p50:.3f}")


def refine_kernel_times(dev, ops):
    """Each refine kernel and its plain version at the refine shape:
    device time (``device_ms``) and the bound from these inputs."""
    g = torch.Generator(device=dev).manual_seed(4)
    S, W, d, M, C = SESSIONS, WINDOW, 128, N_DIRS, N_COMPONENTS
    B = S * W
    z, mask, dirs, pq = refine_inputs(g, dev, S, W, d, M)
    gz, mu, var, logpi = gmm_inputs(g, dev, B, C, d)
    pairs = sum(T for T in range(W - 1, W - 1 - min(KNN, W - 1), -1))
    cases = {
        # projection multiply-adds + (sorted - q)^2 summed; the sort
        # network's compares are not counted, so this is a lower bound
        "swd_sessions": (
            lambda a: ops.swd_sessions(*a), lambda a: ops.swd_sessions_ref(*a),
            (z, dirs, pq), 4 * (S * W * d + M * d + W * M + S),
            2 * S * W * d * M + 3 * S * W * M),
        # per pair: subtract, square, add over d, then weight and sums
        "laplacian_energy": (
            lambda a: ops.laplacian_energy(*a, KNN),
            lambda a: ops.laplacian_energy_ref(*a, KNN), (z, mask),
            4 * (S * W * d + S * W + 2 * S), S * pairs * (3 * d + 4)),
        # direct Mahalanobis: subtract, square, divide, add per (b, c, j),
        # then ~11 operations per (b, c) for the log joint and softmax
        "gmm_posterior": (
            lambda a: ops.gmm_posterior(*a),
            lambda a: ops.gmm_posterior_ref(*a), (gz, mu, var, logpi),
            4 * (B * d + 2 * C * d + C + B * C + B),
            4 * B * C * d + 11 * B * C),
    }
    # calls of each plain version: they launch ~6, ~50 and ~140 kernels a
    # call, and the launches queued behind the spin must stay under the
    # queue's depth (about a thousand), past which enqueueing blocks
    plain_reps = {"swd_sessions": 40, "laplacian_energy": 10,
                  "gmm_posterior": 4}
    out = {}
    for name, (fn, plain, args, nbytes, nops) in cases.items():
        ms = device_ms(fn, args)
        plain_ms = device_ms(plain, args, reps=plain_reps[name])
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        out[name] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        print(f"{name} at the refine shape: device kernel {ms * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f} us; bound "
              f"{max(b_ms, o_ms) * 1e3:.2f} us ({out[name]['bound_by']}: "
              f"{nbytes} bytes, {nops} operations)")
    return out


# --- the training path -------------------------------------------------------

# the edge learner's objective: virtual negatives + batch, SW directions,
# Laplacian window, buffer frames; tolerances of phase 5 (forwards as in
# phase 3; gradients relative to each gradient's max |g|)
TRAIN_BATCH, N_SYN, TRAIN_DIRS, TRAIN_KNN, BUFFER = 8, 256, 32, 3, 96
TRAIN_STEPS, COLD_STEPS, EVAL_N = 60, 50, 240
INFONCE_RTOL, TRAIN_SWD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
# the LM step's SW term: 128 pooled points (pool 64 over B 8 x 1,024) at
# d_model 1,024 (qwen1.5-0.5b; 2,048 for qwen3-1.7b), HybridCfg's 50
# directions
LM_SW_POINTS, LM_SW_DIRS, LM_D = 128, 50, 1024
# the LM step's Laplacian term: B 8 rows of S 1,024 / pool 64 = 16 frames
LM_LAP_B, LM_LAP_T = 8, 16
# each launched once a training step; the one-half calls of the
# regularisers' backward kernel never on the path (one hybrid_reg_bwd)
TRAIN_KERNELS = ("infonce_vneg_fwd", "infonce_vneg_bwd", "swd_rank_fwd",
                 "laplacian_energy", "hybrid_reg_bwd", "gmm_posterior")
ONE_HALF = ("swd_rank_bwd", "laplacian_energy_bwd")
# hybrid_reg_bwd's cases in phase 5 (what, B, T, d, M, k, g_tot expanded):
# the edge learner's (1, 104, 128) with 96 tied rows, the LM steps'
# (8, 16, 1,024) and (4, 16, 2,048) whose g_tot arrives expanded, and the
# edges of its tiling (8 rows x 32 columns, 64 directions staged at a
# time): W and d not multiples of the tile, d = 127, T = 1, k >= T, M past
# one chunk, W = 1,000 with k 20
HYBRID_CASES = (("edge", 1, BUFFER + TRAIN_BATCH, 128, TRAIN_DIRS, TRAIN_KNN,
                 False),
                ("LM", LM_LAP_B, LM_LAP_T, LM_D, LM_SW_DIRS, KNN, True),
                ("LM d 2,048", 4, LM_LAP_T, 2 * LM_D, LM_SW_DIRS, KNN, True),
                ("ragged tile", 3, 7, 45, 3, 2, True),
                ("d = 127", 2, 9, 127, 8, 3, False),
                ("T = 1", 5, 1, 64, 4, KNN, True),
                ("k >= T", 2, 6, 40, 5, 9, False),
                ("M past a chunk", 1, 20, 33, 131, 3, False),
                ("W = 1,000", 1, 1000, 128, 8, 20, False))


def grad_err(got, want, what):
    """max |got - want| against GRAD_ATOL x max |want| -> max |err|."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= GRAD_ATOL * scale, f"{what}: max |err| {err} > "
          f"{GRAD_ATOL} x max |g| {scale}")
    return err


def same_bits(fn, args, what):
    """Two launches on one input -> the first's outputs; fails unless the
    two are bitwise equal."""
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        check(torch.equal(x, y), f"{what} not bitwise from run to run")
    return a


def infonce_inputs(g, dev, B, N, d, misaligned=False):
    """z, z_pos (B, d), z_neg (B, N, d) on the sphere and a cotangent (B,);
    ``misaligned`` puts z_neg in a contiguous view one float past a 16-byte
    boundary (the kernels' scalar path)."""
    z, zp = unit_rows(g, (B, d), dev), unit_rows(g, (B, d), dev)
    zn = unit_rows(g, (B, N, d), dev)
    if misaligned:
        zn = off_16_bytes(zn)
    return z, zp, zn, torch.randn(B, device=dev, generator=g)


def swd_train_inputs(g, dev, W, d, M):
    """x (W, d) on the sphere whose first rows repeat one row (96 of them
    when W > 96, as the edge trainer's cold buffer), M directions and the
    sorted prior quantiles."""
    x = unit_rows(g, (W, d), dev)
    dup = BUFFER if W > BUFFER else W // 2
    x[:dup] = x[0]
    dirs = unit_rows(g, (M, d), dev)
    prior_q = torch.sort(unit_rows(g, (W, d), dev) @ dirs.T,
                         dim=0).values.contiguous()
    return x.contiguous(), dirs, prior_q


def hybrid_inputs(g, dev, ops, B, T, d, M, k, expanded):
    """The arguments of ``hybrid_reg_bwd``: z (B, T, d) on the sphere whose
    first rows repeat one row (96, or half of the W = B*T), a mask with ~10%
    gaps, M directions, the sorted prior quantiles, the forward kernel's
    proj and rank, cotangents g_sw () and g_tot (B,), the latter a stride-0
    view where ``expanded`` (as the cotangent of ``tot.sum()`` arrives)."""
    W = B * T
    z = unit_rows(g, (W, d), dev)
    z[:min(BUFFER, W // 2)] = z[0]
    z = z.view(B, T, d).contiguous()
    mask = (torch.rand(B, T, device=dev, generator=g) >= 0.1).float()
    dirs = unit_rows(g, (M, d), dev)
    pq = torch.sort(unit_rows(g, (W, d), dev) @ dirs.T,
                    dim=0).values.contiguous()
    _, proj, rank = ops.swd_rank_fwd(z.view(W, d), dirs, pq)
    g_sw = torch.rand((), device=dev, generator=g) + 0.5
    g_tot = torch.randn((), device=dev, generator=g).expand(B) if expanded \
        else torch.randn(B, device=dev, generator=g)
    return z, mask, k, g_sw, proj, rank, pq, dirs, g_tot


def hold_hybrid(g, dev, ops, what, B, T, d, M, k, expanded):
    """``hybrid_reg_bwd`` at one case: against its plain version (within
    GRAD_ATOL of max |dz|), bitwise from run to run, bitwise the
    composition it replaced (the two one-half launches added by torch, in
    either order), each half alone bitwise the one-half launch, and the
    autograd entry ``hybrid_regularisers`` bitwise the kernel -> max
    |err|."""
    args = hybrid_inputs(g, dev, ops, B, T, d, M, k, expanded)
    z, mask, _, g_sw, proj, rank, pq, dirs, g_tot = args
    what = f"{what} ({B}, {T}, {d}) M {M} k {k}" + \
        (", g_tot expanded" if expanded else "")
    dz, = same_bits(lambda *a: (ops.hybrid_reg_bwd(*a),), args,
                    f"hybrid_reg_bwd at {what}")
    err = grad_err(dz, ops.hybrid_reg_bwd_ref(*args),
                   f"hybrid_reg_bwd at {what}")
    sw = ops.swd_rank_bwd(g_sw, proj, rank, pq, dirs).view(B, T, d)
    lap = ops.laplacian_energy_bwd(z, mask, g_tot.contiguous(), k)
    check(torch.equal(dz, sw + lap) and torch.equal(dz, lap + sw),
          f"hybrid_reg_bwd != swd_rank_bwd + laplacian_energy_bwd at {what}")
    check(torch.equal(ops.hybrid_reg_bwd(*args[:-1], None), sw)
          and torch.equal(ops.hybrid_reg_bwd(*args[:3], None, *args[4:]),
                          lap), f"hybrid_reg_bwd's halves != the one-half "
          f"launches at {what}")
    zl = z.clone().requires_grad_()
    with torch.enable_grad():
        sw_l, tot, _ = ops.hybrid_regularisers(zl, mask, k, dirs, pq)
        a, = torch.autograd.grad((sw_l, tot), zl, (g_sw, g_tot))
    check(torch.equal(a, dz), f"hybrid_regularisers autograd != "
          f"hybrid_reg_bwd at {what}")
    return err


def note(worst, name, err):
    """Keep the largest |err| of ``name`` in ``worst``, where it is one of
    the names the phase reports."""
    if name in worst:
        worst[name] = max(worst[name], err)


def hold_infonce(g, dev, ops, worst, B, N, d, off=False):
    """``infonce_vneg`` forward and backward against their plain versions
    at (B, N, d) (``off``: z_neg one float off 16 bytes), bitwise from run
    to run, and the autograd entry against the plain version's autograd."""
    what = f"B={B} N={N} d={d}" + (" misaligned" if off else "")
    z, zp, zn, cot = infonce_inputs(g, dev, B, N, d, off)
    loss, lse = same_bits(lambda *a: ops.infonce_vneg_fwd(*a, 0.1),
                          (z, zp, zn), f"infonce_vneg_fwd at {what}")
    p_loss, p_lse = ops.infonce_vneg_fwd_ref(z, zp, zn, 0.1)
    for a, b in ((loss, p_loss), (lse, p_lse)):
        err = (a - b).abs().max().item()
        note(worst, "infonce_vneg_fwd", err)
        check(torch.allclose(a, b, rtol=INFONCE_RTOL, atol=0.0),
              f"infonce_vneg_fwd != plain at {what}: max |err| {err}")
    got = same_bits(lambda *a: ops.infonce_vneg_bwd(*a, 0.1),
                    (z, zp, zn, lse, cot), f"infonce_vneg_bwd at {what}")
    want = ops.infonce_vneg_bwd_ref(z, zp, zn, p_lse, cot, 0.1)
    for a, b, n in zip(got, want, ("dz", "dz_pos", "dz_neg")):
        note(worst, "infonce_vneg_bwd",
             grad_err(a, b, f"infonce_vneg_bwd {n} at {what}"))
    # the autograd entry on the card: the kernels, wired as the plain
    # version's autograd
    leaves = [x.clone().requires_grad_() for x in (z, zp, zn)]
    with torch.enable_grad():
        a = torch.autograd.grad(ops.infonce_vneg(*leaves, 0.1), leaves, cot)
        b = torch.autograd.grad(ops.infonce_vneg_ref(*leaves, 0.1), leaves,
                                cot)
    for x, y, n in zip(a, b, ("dz", "dz_pos", "dz_neg")):
        grad_err(x, y, f"infonce_vneg autograd {n} at {what}")


def hold_swd_rank(g, dev, ops, worst, W, M, d):
    """``swd_rank_fwd`` (loss, projections, ranks) and ``swd_rank_bwd``
    against their plain versions at (W, d) and M directions, bitwise from
    run to run, and ``swd_single``'s autograd bitwise the backward."""
    from repro_torch.kernels.swd import rank_of
    what = f"W={W} M={M} d={d}"
    x, dirs, pq = swd_train_inputs(g, dev, W, d, M)
    loss, proj, rank = same_bits(ops.swd_rank_fwd, (x, dirs, pq),
                                 f"swd_rank_fwd at {what}")
    p_loss, p_proj, _ = ops.swd_rank_fwd_ref(x, dirs, pq)
    err = max((loss - p_loss).abs().item(),
              (proj - p_proj).abs().max().item())
    note(worst, "swd_rank_fwd", err)
    check(torch.allclose(loss, p_loss, rtol=TRAIN_SWD_RTOL, atol=0.0)
          and torch.allclose(proj, p_proj, rtol=0.0,
                             atol=GRAD_ATOL * p_proj.abs().max().item()),
          f"swd_rank_fwd != plain at {what}: max |err| {err}")
    check(torch.equal(rank, rank_of(torch.sort(
        proj, dim=0, stable=True).indices)),
          f"swd_rank_fwd ranks != torch.sort(stable=True) at {what}")
    cot = torch.rand((), device=dev, generator=g) + 0.5
    dx, = same_bits(lambda *a: (ops.swd_rank_bwd(*a),),
                    (cot, proj, rank, pq, dirs), f"swd_rank_bwd at {what}")
    note(worst, "swd_rank_bwd", grad_err(
        dx, ops.swd_rank_bwd_ref(cot, proj, rank, pq, dirs),
        f"swd_rank_bwd at {what}"))
    xl = x.clone().requires_grad_()
    with torch.enable_grad():
        a, = torch.autograd.grad(ops.swd_single(xl, dirs, pq), xl, cot)
    check(torch.equal(a, dx), f"swd_single autograd != swd_rank_bwd at "
          f"{what}")


def hold_laplacian_train(gen, dev, ops, worst, B, T, d, k, masked=False,
                         off=False):
    """``laplacian_energy`` and ``laplacian_energy_bwd`` against their
    plain versions at (B, T, d) and k (``masked``: row 1 all gaps;
    ``off``: z one float off 16 bytes), bitwise from run to run, and
    ``laplacian_energy_diff``'s autograd bitwise the backward."""
    what = f"B={B} T={T} d={d} k={k}" + (" misaligned" if off else "")
    z, mask, _, _ = refine_inputs(gen, dev, B, T, d, 1)
    if off:
        z = off_16_bytes(z)
    if masked:
        mask[1] = 0.0
    cot = torch.randn(B, device=dev, generator=gen)
    note(worst, "laplacian_energy", hold(
        "laplacian_energy", lambda z, m: ops.laplacian_energy(z, m, k),
        lambda z, m: ops.laplacian_energy_ref(z, m, k), (z, mask),
        [(LAP_RTOL, 0.0), (0.0, 0.0)], what))
    dz, = same_bits(lambda *a: (ops.laplacian_energy_bwd(*a, k),),
                    (z, mask, cot), f"laplacian_energy_bwd at {what}")
    want = ops.laplacian_energy_bwd_ref(z, mask, cot, k)
    err = (dz - want).abs().max().item()
    check(err <= GRAD_ATOL * max(want.abs().max().item(), 1e-30)
          or err == 0.0, f"laplacian_energy_bwd at {what}: max |err| {err}")
    note(worst, "laplacian_energy_bwd", err)
    if masked:
        check(bool((dz[1] == 0).all()), "laplacian_energy_bwd: masked row "
              "has a gradient")
    zl = z.clone().requires_grad_()
    with torch.enable_grad():
        a, = torch.autograd.grad(
            ops.laplacian_energy_diff(zl, mask, k)[0], zl, cot)
    check(torch.equal(a, dz), f"laplacian_energy_diff autograd != "
          f"laplacian_energy_bwd at {what}")


def phase5(dev, ops):
    """The training path's kernels against their plain versions on the
    card, forward values and gradients -> {name: max |err|}."""
    g = torch.Generator(device=dev).manual_seed(5)
    worst = dict.fromkeys(("infonce_vneg_fwd", "infonce_vneg_bwd",
                           "swd_rank_fwd", "swd_rank_bwd",
                           "laplacian_energy_bwd", "hybrid_reg_bwd"), 0.0)
    # N = 1, N not a multiple of the kernels' split (263: 16 splits of 17;
    # 100: 13 of 8), d = 127 and a z_neg view off 16 bytes (the scalar path)
    for case in ((TRAIN_BATCH, N_SYN + TRAIN_BATCH, 128, False),
                 (1, 1, 128, False), (3, 100, 64, False), (5, 77, 128, False),
                 (TRAIN_BATCH, 263, 128, False), (4, 50, 127, False),
                 (2, 33, 128, True)):
        hold_infonce(g, dev, ops, worst, *case)
    # the LM step's shapes (W 128, M 50 at d 1,024 and 2,048: x streamed
    # over d), W = 1 and W = 1,000 (P = 1,024, 32 values a lane)
    for case in ((BUFFER + TRAIN_BATCH, TRAIN_DIRS, 128),
                 (BUFFER + TRAIN_BATCH, 50, 128), (16, TRAIN_DIRS, 128),
                 (16, 50, 128), (128, TRAIN_DIRS, 128), (128, 50, 128),
                 (LM_SW_POINTS, LM_SW_DIRS, 1024),
                 (LM_SW_POINTS, LM_SW_DIRS, 2048), (1, TRAIN_DIRS, 128),
                 (1000, 8, 128)):
        hold_swd_rank(g, dev, ops, worst, *case)
    # and, from their own generator, the forward's plan at the edge
    # learner's and the LM step's shapes: a last chunk of one frame (T 105),
    # K past the 5-frame register ring over a cluster (k 20: four delta
    # groups), the LM step's (8, 16, 1,024) k 5 (8 column slices x 8 chunks
    # a row), and that in a z one float off 16 bytes
    g_lap = torch.Generator(device=dev).manual_seed(55)
    lap_cases = [(g, *c, False) for c in (
        (1, BUFFER + TRAIN_BATCH, 128, TRAIN_KNN, False),
        (2, 16, 128, 20, False), (4, 1, 128, TRAIN_KNN, False),
        (3, 37, 64, TRAIN_KNN, True))]
    lap_cases += [(g_lap, *c) for c in (
        (1, BUFFER + TRAIN_BATCH + 1, 128, TRAIN_KNN, False, False),
        (1, BUFFER + TRAIN_BATCH, 128, 20, False, False),
        (LM_LAP_B, LM_LAP_T, LM_D, KNN, False, False),
        (LM_LAP_B, LM_LAP_T, LM_D, KNN, False, True))]
    for gen, *case in lap_cases:
        hold_laplacian_train(gen, dev, ops, worst, *case)
    g_hyb = torch.Generator(device=dev).manual_seed(22)
    for case in HYBRID_CASES:
        worst["hybrid_reg_bwd"] = max(worst["hybrid_reg_bwd"],
                                      hold_hybrid(g_hyb, dev, ops, *case))
    torch.cuda.synchronize()
    print(f"phase 5: infonce_vneg fwd (rtol {INFONCE_RTOL}) and bwd (also "
          f"N = 263, d = 127, a misaligned z_neg), swd_rank fwd (loss rtol "
          f"{TRAIN_SWD_RTOL}, ranks exact; also the LM step's W "
          f"{LM_SW_POINTS}, M {LM_SW_DIRS} at d 1,024 and 2,048, W = 1 and "
          f"1,000) and bwd, "
          f"laplacian_energy fwd (rtol {LAP_RTOL}; also T 105, k 20, the LM "
          f"step's ({LM_LAP_B}, {LM_LAP_T}, {LM_D}) k {KNN}, misaligned) and "
          f"bwd, hybrid_reg_bwd (both paths' shapes, its tiling's edges; "
          f"bitwise == swd_rank_bwd + laplacian_energy_bwd) == plain versions "
          f"(gradients within {GRAD_ATOL} x max |g|), autograd entries == "
          f"their backward kernels, bitwise from run to run; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    hold16_infonce(g, dev, ops)
    return worst


def phase6(cfg, dev, ops):
    """The edge learner's training path at full width: TRAIN_STEPS steps of
    ``train_representation("streamsplit")`` with the counts set to 0 just
    before and read just after, step 0 against the port on the CPU, and
    one profiled step -> (launch counts of the run, step ms, the trained
    encoder params)."""
    from repro_torch.optim.sgd import tree_leaves
    from repro_torch.runtime.edge_train import (EdgeTrainer,
                                                train_representation)
    kw = dict(enc_cfg=cfg, batch=TRAIN_BATCH, n_syn=N_SYN, seed=0)
    ends, per_step, first, trainer = [], [], {}, []
    prev = {}

    def on_step(i, loss, grads, tr):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        now = {n: ops.KERNELS[n].launches for n in TRAIN_KERNELS + ONE_HALF}
        per_step.append({n: now[n] - prev.get(n, 0)
                         for n in TRAIN_KERNELS + ONE_HALF})
        prev.update(now)
        if i == 0:
            first.update(loss=loss.item(), grads=[g.cpu() for g in grads],
                         gmm=tr.gmm.to("cpu"))
            trainer.append(tr)

    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    start = time.perf_counter()
    res = train_representation("streamsplit", steps=TRAIN_STEPS,
                               eval_n=EVAL_N, device="cuda", on_step=on_step,
                               **kw)
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start

    check(res.losses.shape == (TRAIN_STEPS,) and np.isfinite(res.losses).all(),
          f"losses not finite: {res.losses}")
    check(res.eval_z.shape == (EVAL_N, cfg.d_embed)
          and np.isfinite(res.eval_z).all(), "eval embeddings")
    norm_err = float(np.abs(np.linalg.norm(res.eval_z, axis=1) - 1).max())
    check(norm_err <= 1e-5, f"eval | ||z|| - 1 | = {norm_err}")
    want = {**dict.fromkeys(TRAIN_KERNELS, 1), **dict.fromkeys(ONE_HALF, 0)}
    for i, c in enumerate(per_step):
        check(c == want, f"step {i}: launches {c}, want {want}")
    for n in TRAIN_KERNELS + ONE_HALF:
        check(launches[n] == want[n] * TRAIN_STEPS, f"{n} launched "
              f"{launches[n]} times in {TRAIN_STEPS} steps")
    check(launches["wire_roundtrip"] == launches["wire_roundtrip_grouped"]
          == launches["swd_sessions"] == 0,
          f"serving/refine kernels on the training path: {launches}")
    step_ms = np.diff(np.array(ends)) * 1e3          # steps 1 .. 59
    cold_ms, warm_ms = step_ms[:COLD_STEPS - 1], step_ms[COLD_STEPS - 1:]
    print(f"phase 6: {TRAIN_STEPS} steps of the streamsplit edge learner at "
          f"full width (batch {TRAIN_BATCH}, {N_SYN} virtual negatives, "
          f"{min(cfg.frames, 98)} mel frames: the stream's 98 cut at "
          f"frames={cfg.frames}), launches per step {want} on "
          f"every step, run total {launches}")
    print(f"step ms: cold (steps 1-{COLD_STEPS - 1}) p50 "
          f"{np.percentile(cold_ms, 50):.3f} p95 "
          f"{np.percentile(cold_ms, 95):.3f}; warm (steps {COLD_STEPS}-"
          f"{TRAIN_STEPS - 1}) p50 {np.percentile(warm_ms, 50):.3f} p95 "
          f"{np.percentile(warm_ms, 95):.3f}; steps/s "
          f"{1e3 / step_ms.mean():.2f}; step 0 with set-up "
          f"{(ends[0] - start) * 1e3:.1f} ms; whole run with eval "
          f"{total_s:.2f} s")
    print(f"loss step 0 {res.losses[0]:.6f}, step {COLD_STEPS - 1} "
          f"{res.losses[COLD_STEPS - 1]:.6f}, final {res.losses[-1]:.6f}; "
          f"eval set of {EVAL_N}: linear-probe accuracy {res.probe_acc:.4f}, "
          f"collapse {res.collapse:.4f}")

    # --- step 0 against the port on the CPU (outside the counted run) ---
    cpu = EdgeTrainer("streamsplit", device="cpu", **kw)
    c_loss, c_grads = cpu.step()
    errs = {"loss": abs(first["loss"] - float(c_loss)) / abs(float(c_loss))}
    names = [f"grad[{i}]{tuple(g.shape)}" for i, g in enumerate(c_grads)]
    grad_errs = [rel_err(a, b) for a, b in zip(first["grads"], c_grads)]
    errs["grads (worst)"] = max(grad_errs)
    for k in ("s0", "s1", "s2"):
        errs[f"gmm.{k}"] = rel_err(getattr(first["gmm"], k),
                                   getattr(cpu.gmm, k))
    check(len(first["grads"]) == len(tree_leaves(cpu.params)), "grads")
    print(f"step 0, card vs the port on the CPU (relative; gradients and GMM "
          f"relative to each tensor's max |x|, {len(c_grads)} gradients, "
          f"worst {names[int(np.argmax(grad_errs))]}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= REFINE_RTOL, f"step 0 card vs CPU: {k} {v} > {REFINE_RTOL}")
    profile_train_step(trainer[0], float(np.percentile(warm_ms, 50)))
    return launches, step_ms, res.params


def profile_train_step(tr, p50):
    """One more (warm) step under torch.profiler: device busy time, the
    idle share of the unprofiled p50 warm step, the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.step()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiled step: not measured (torch.profiler recorded no "
              "device activity)")
        return
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the SW term's forward, the regularisers' backward and the InfoNCE's
    # kernels (forward and backward, each with its second pass)
    own = {k: sum(us for n, us in by_name.items() if k in n.lower()) / 1e3
           for k in ("swd", "hybrid_reg", "infonce")}
    print(f"profiled warm step: {len(events)} device activities, busy "
          f"{busy_ms:.3f} ms (swd kernels {own['swd']:.4f} ms, hybrid_reg "
          f"{own['hybrid_reg']:.4f} ms, infonce "
          f"kernels {own['infonce']:.4f} ms); idle share of the unprofiled "
          f"warm p50 step ({p50:.3f} ms): {1.0 - busy_ms / p50:.3f}; top: "
          + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top))


def train_kernel_times(dev, ops):
    """Each training kernel and its plain version at the path's shape:
    device time (``device_ms``) and the bound from these inputs."""
    g = torch.Generator(device=dev).manual_seed(6)
    B, N, d = TRAIN_BATCH, N_SYN + TRAIN_BATCH, 128
    W, M, T, K = BUFFER + TRAIN_BATCH, TRAIN_DIRS, BUFFER + TRAIN_BATCH, \
        TRAIN_KNN
    z, zp, zn, cot = infonce_inputs(g, dev, B, N, d)
    _, lse = ops.infonce_vneg_fwd(z, zp, zn, 0.1)
    x, dirs, pq = swd_train_inputs(g, dev, W, d, M)
    _, proj, rank = ops.swd_rank_fwd(x, dirs, pq)
    one = torch.ones((), device=dev)
    lz, lmask, _, _ = refine_inputs(g, dev, 1, T, d, 1)
    lg = torch.ones(1, device=dev)
    C = 16                                    # the edge learner's GMM
    gmm_args = gmm_inputs(g, dev, BUFFER, C, d)
    pairs = sum(T - delta for delta in range(1, K + 1))
    # the step's regularisers' backward: the SW term's x as z (1, T, d)
    hyb = (x.view(1, T, d), lmask, K, one, proj, rank, pq, dirs, lg)
    cases = {
        # read z, z_pos, z_neg once, write loss and lse; a dot product per
        # logit, then max, subtract, exp and add per logit
        "infonce_vneg_fwd": (
            lambda a: ops.infonce_vneg_fwd(*a, 0.1),
            lambda a: ops.infonce_vneg_fwd_ref(*a, 0.1), (z, zp, zn),
            4 * (2 * B * d + B * N * d + 2 * B),
            2 * B * N * d + 2 * B * d + 4 * B * (N + 1)),
        # read the inputs, lse and g, write dz, dz_pos, dz_neg: the dot
        # products again, dz's sum over the negatives, dz_neg's products
        "infonce_vneg_bwd": (
            lambda a: ops.infonce_vneg_bwd(*a, 0.1),
            lambda a: ops.infonce_vneg_bwd_ref(*a, 0.1),
            (z, zp, zn, lse, cot),
            4 * (4 * B * d + 2 * B * N * d + 2 * B),
            5 * B * N * d + 6 * B * d + 3 * B * N),
        # projection multiply-adds and (sorted - q)^2 summed; the sort
        # network's compares are not counted, so this is a lower bound
        "swd_rank_fwd": (
            lambda a: ops.swd_rank_fwd(*a), lambda a: ops.swd_rank_fwd_ref(*a),
            (x, dirs, pq), 4 * (W * d + M * d + W * M + 1 + 2 * W * M),
            2 * W * d * M + 3 * W * M),
        # the (W, M) weights, then dx = weights @ dirs
        "swd_rank_bwd": (
            lambda a: ops.swd_rank_bwd(*a), lambda a: ops.swd_rank_bwd_ref(*a),
            (one, proj, rank, pq, dirs), 4 * (1 + 3 * W * M + M * d + W * d),
            2 * W * M * d + 4 * W * M),
        # per pair and element: subtract, multiply by the pair's weight,
        # add, for each of its two ends; then the scale by 2g
        "laplacian_energy_bwd": (
            lambda a: ops.laplacian_energy_bwd(*a, K),
            lambda a: ops.laplacian_energy_bwd_ref(*a, K), (lz, lmask, lg),
            4 * (2 * T * d + T + 1), 6 * pairs * d + 2 * T * d),
        # both: the SW half's bytes and operations, the Laplacian half's,
        # z read once for both, and the join
        "hybrid_reg_bwd": (
            lambda a: ops.hybrid_reg_bwd(*a),
            lambda a: ops.hybrid_reg_bwd_ref(*a), hyb,
            hybrid_bytes(1, T, d, M), hybrid_ops(1, T, d, M, K)),
        # the two forward kernels the refine path shares, at this path's
        # shapes (counted as in refine_kernel_times)
        "laplacian_energy": (
            lambda a: ops.laplacian_energy(*a, K),
            lambda a: ops.laplacian_energy_ref(*a, K), (lz, lmask),
            4 * (T * d + T + 2), pairs * (3 * d + 4)),
        "gmm_posterior": (
            lambda a: ops.gmm_posterior(*a), lambda a: ops.gmm_posterior_ref(*a),
            gmm_args, 4 * (BUFFER * d + 2 * C * d + C + BUFFER * C + BUFFER),
            4 * BUFFER * C * d + 11 * BUFFER * C),
    }
    # the LM step's SW term (qwen1.5-0.5b's d_model), counted as above
    W, d, M = LM_SW_POINTS, LM_D, LM_SW_DIRS
    lx, ldirs, lpq = swd_train_inputs(g, dev, W, d, M)
    _, lproj, lrank = ops.swd_rank_fwd(lx, ldirs, lpq)
    LB, LT = LM_LAP_B, LM_LAP_T
    lm_z = unit_rows(g, (LB, LT, d), dev)
    lm_mask, lm_g = torch.ones(LB, LT, device=dev), torch.ones(LB, device=dev)
    lm_pairs = sum(LT - delta for delta in range(1, min(KNN, LT - 1) + 1))
    # the step's regularisers' backward: z (8, 16, 1,024) the pooled
    # frames, g_tot the expanded cotangent of tot.sum()
    lm_hyb = (lx.view(LB, LT, d), lm_mask, KNN, one, lproj, lrank, lpq,
              ldirs, torch.ones((), device=dev).expand(LB))
    lm_cases = {
        "swd_rank_fwd": (
            lambda a: ops.swd_rank_fwd(*a), lambda a: ops.swd_rank_fwd_ref(*a),
            (lx, ldirs, lpq), 4 * (W * d + M * d + W * M + 1 + 2 * W * M),
            2 * W * d * M + 3 * W * M),
        "swd_rank_bwd": (
            lambda a: ops.swd_rank_bwd(*a), lambda a: ops.swd_rank_bwd_ref(*a),
            (one, lproj, lrank, lpq, ldirs),
            4 * (1 + 3 * W * M + M * d + W * d), 2 * W * M * d + 4 * W * M),
        # the hybrid term's Laplacian at (8, 16, 1,024), k 5, counted as at
        # the training shape
        "laplacian_energy": (
            lambda a: ops.laplacian_energy(*a, KNN),
            lambda a: ops.laplacian_energy_ref(*a, KNN), (lm_z, lm_mask),
            4 * (LB * LT * d + LB * LT + 2 * LB), LB * lm_pairs * (3 * d + 4)),
        "laplacian_energy_bwd": (
            lambda a: ops.laplacian_energy_bwd(*a, KNN),
            lambda a: ops.laplacian_energy_bwd_ref(*a, KNN),
            (lm_z, lm_mask, lm_g), 4 * (2 * LB * LT * d + LB * LT + LB),
            LB * (6 * lm_pairs * d + 2 * LT * d)),
        "hybrid_reg_bwd": (
            lambda a: ops.hybrid_reg_bwd(*a),
            lambda a: ops.hybrid_reg_bwd_ref(*a), lm_hyb,
            hybrid_bytes(LB, LT, d, M), hybrid_ops(LB, LT, d, M, KNN)),
    }
    out = {}
    for group in (cases, lm_cases):
        for name, (fn, plain, args, nbytes, nops) in group.items():
            where = ("the training shape" if group is cases else
                     f"the LM step's shape ({W}, {d}), M {M}"
                     if name.startswith("swd") else
                     f"the LM step's shape ({LB}, {LT}, {d}), k {KNN}")
            ms = device_ms(fn, args)
            # the plain Laplacian at k 5 launches ~47 kernels a call: 10
            # calls keep the queue behind the spin under its depth
            plain_ms = device_ms(plain, args,
                                 reps=20 if group is cases else 10)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = nops / FP32_OPS_PER_S * 1e3
            rec = {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(b_ms, o_ms),
                   "bound_by": "bytes" if b_ms >= o_ms else "operations"}
            if name == "hybrid_reg_bwd":
                # what it replaced: the two one-half launches and an add
                # (and at B > 1 the copy of the expanded g_tot)
                rec["composition_ms"] = device_ms(composition(ops), args)
            if group is cases:
                out[name] = rec
            else:
                out[name]["lm_shape"] = rec
            print(f"{name} at {where}: device kernel {ms * 1e3:.2f} us, "
                  f"plain {plain_ms * 1e3:.2f} us; bound "
                  f"{max(b_ms, o_ms) * 1e3:.3f} us ({rec['bound_by']}: "
                  f"{nbytes} bytes, {nops} operations)" + (
                      f"; swd_rank_bwd + laplacian_energy_bwd + add "
                      f"{rec['composition_ms'] * 1e3:.2f} us"
                      if "composition_ms" in rec else ""))
    return out


def hybrid_bytes(B, T, d, M):
    """``hybrid_reg_bwd``'s least bytes: z, mask, g_tot, g_sw, proj, rank,
    the gathered prior_q, dirs read once, dz written once."""
    W = B * T
    return 4 * (2 * W * d + W + B + 1 + 3 * W * M + M * d)


def hybrid_ops(B, T, d, M, k):
    """``hybrid_reg_bwd``'s operations: the SW half's weights and product,
    the Laplacian half's (counted as ``laplacian_energy_bwd``'s), the
    join."""
    pairs = sum(T - delta for delta in range(1, min(k, T - 1) + 1))
    return 2 * B * T * M * d + 4 * B * T * M \
        + B * (6 * pairs * d + 2 * T * d) + B * T * d


def composition(ops):
    """The regularisers' backward as the step launched it before the
    kernel joined them: ``swd_rank_bwd`` and ``laplacian_energy_bwd`` (on
    a contiguous g_tot) added by torch."""
    def run(a):
        z, mask, k, g_sw, proj, rank, pq, dirs, g_tot = a
        return ops.swd_rank_bwd(g_sw, proj, rank, pq, dirs).view(z.shape) \
            + ops.laplacian_energy_bwd(z, mask, g_tot.contiguous(), k)
    return run


# --- the per-frame split path's per-tensor wire kernels ----------------------

def boundary_shapes(cfg):
    """The wire's tensor at k = 0..L-1 for one frame: the raw mel at k=0,
    then the activation after block k ((1, frames, width); "SAME"
    convolutions keep ⌈t/s⌉ frames)."""
    out, t = [(1, cfg.frames, cfg.n_mels)], cfg.frames
    for w, s in zip(cfg.widths[:-1], cfg.strides[:-1]):
        t = -(-t // s)
        out.append((1, t, w))
    return out


def quant_cases(cfg, g, dev):
    """(what, x) for phase 7: every per-frame boundary shape, B=32 at k=0,
    sizes around the kernels' vector width and block, 2^24 + 3, a
    constant tensor, one outlier, a view that is not 16-byte aligned
    (the scalar path), and one NaN, +inf or -inf element."""
    cases = [(f"k={k} {shape}", torch.randn(*shape, device=dev, generator=g)
              * 3.0 + 1.0) for k, shape in enumerate(boundary_shapes(cfg))]
    cases.append(("B=32 k=0", torch.randn(32, cfg.frames, cfg.n_mels,
                                          device=dev, generator=g)))
    for n in (1, 4095, 4097, 2 ** 24 + 3):
        cases.append((f"n={n}", torch.randn(n, device=dev, generator=g)))
    cases.append(("constant", torch.full((3328,), 1.25, device=dev)))
    x = torch.randn(6656, device=dev, generator=g)
    x[17] = 1e4
    cases.append(("outlier", x))
    cases.append(("unaligned view", torch.randn(
        12801, device=dev, generator=g)[1:]))
    for what, v in (("nan", float("nan")), ("inf", float("inf")),
                    ("-inf", -float("inf"))):
        x = torch.randn(3328, device=dev, generator=g)
        x[5] = v
        cases.append((what, x))
    # the quantize's launch plan at its edges: n = 3 and 5 (float4 lanes and
    # their tail), one block's capacity (16,384) and one past it (the two
    # passes), a view off 16 bytes and a NaN past it
    for n in (3, 5, 16384, 16385):
        cases.append((f"n={n}", torch.randn(n, device=dev, generator=g)))
    cases.append(("unaligned view n=16385", torch.randn(
        16386, device=dev, generator=g)[1:]))
    x = torch.randn(16385, device=dev, generator=g)
    x[16000] = float("nan")
    cases.append(("nan n=16385", x))
    return cases


def phase7(cfg, dev, ops):
    """The per-tensor quantize and dequantize kernels against their plain
    versions on the card, bitwise; ``run`` against ``run_batch_async`` at
    B=1 -> max |err| of (quantize levels, dequantized values)."""
    from repro_torch.core.splitter import SplitEngine
    from repro_torch.models.audio_encoder import init_audio_encoder
    from repro_torch.weights import to_device
    g = torch.Generator(device=dev).manual_seed(7)
    worst = dict.fromkeys(("int8_quantize", "int8_dequantize",
                           "int8_quantize_roundtrip"), 0.0)
    cases = quant_cases(cfg, g, dev)
    for what, x in cases:
        qt, again, want = (ops.int8_quantize(x), ops.int8_quantize(x),
                           ops.int8_quantize_ref(x))
        out, out2 = ops.int8_dequantize(qt), ops.int8_dequantize(qt)
        (rq, rout), (rq2, rout2) = (ops.int8_quantize_roundtrip(x),
                                    ops.int8_quantize_roundtrip(x))
        want_out = ops.int8_dequantize_ref(want)
        torch.cuda.synchronize()
        worst["int8_quantize"] = max(worst["int8_quantize"], (
            qt.q.int() - want.q.int()).abs().max().item())
        worst["int8_dequantize"] = max(worst["int8_dequantize"], (
            out - want_out).nan_to_num().abs().max().item())
        worst["int8_quantize_roundtrip"] = max(
            worst["int8_quantize_roundtrip"],
            (rq.q.int() - want.q.int()).abs().max().item(),
            (rout - want_out).nan_to_num().abs().max().item())
        check(rq.q.dtype == torch.int8 and rq.q.shape == x.shape
              and rout.dtype == torch.float32 and rout.shape == x.shape,
              f"int8_quantize_roundtrip shapes at {what}")
        check(all(same_values(a, b) for a, b in zip(rq, qt)),
              f"int8_quantize_roundtrip's payload or header != "
              f"int8_quantize's at {what}")
        check(same_values(rout, out) and same_values(rout, want_out),
              f"int8_quantize_roundtrip's values != int8_dequantize of its "
              f"payload (or the plain version) at {what}")
        check(all(same_values(a, b) for a, b in zip(rq, rq2))
              and same_values(rout, rout2),
              f"int8_quantize_roundtrip not bitwise from run to run at "
              f"{what}")
        check(qt.q.dtype == torch.int8 and qt.q.shape == x.shape
              and all(same_values(a, b) for a, b in zip(qt, want)),
              f"int8_quantize != plain version at {what}")
        check(all(same_values(a, b) for a, b in zip(qt, again)),
              f"int8_quantize not bitwise from run to run at {what}")
        check(same_values(out, want_out) and same_values(out, out2),
              f"int8_dequantize != plain version (or not bitwise from run "
              f"to run) at {what}")
        if what == "constant":
            check(torch.equal(out, x), "constant tensor not restored")
        if what.startswith("nan"):
            check(not qt.q.any() and bool(torch.isnan(out).all()),
                  "a NaN element must give NaN scale, levels 0, NaN out")
    # SplitEngine.run (per-tensor kernels) == run_batch_async (per-row
    # wire kernel) at B=1, every k, at full width
    params = to_device(init_audio_encoder(
        cfg, torch.Generator().manual_seed(7)), dev)
    eng = SplitEngine(cfg, device=dev)
    mel = np.random.default_rng(7).standard_normal(
        (1, cfg.frames, cfg.n_mels), np.float32)
    for k in range(cfg.n_blocks + 1):
        a, wa = eng.run(params, mel, k)
        b, wb = eng.run_batch_async(params, torch.from_numpy(mel).to(dev), k)
        torch.cuda.synchronize()
        check(wa == wb and torch.equal(a, b),
              f"run != run_batch_async at B=1, k={k}")
    print(f"phase 7: int8_quantize, int8_dequantize and "
          f"int8_quantize_roundtrip (payload and header == int8_quantize's, "
          f"values == int8_dequantize's) bitwise == plain "
          f"versions at {len(cases)} cases (every per-frame boundary shape, "
          f"B=32 at k=0, n in 1, 3, 5, 4095, 4097, 16,384 (one block), "
          f"16,385 (two passes), 2^24+3, constant, outlier, unaligned at "
          f"12,800 and 16,385, NaN at 3,328 and 16,385, +inf, -inf) and "
          f"from run to run; run == "
          f"run_batch_async at B=1 "
          f"for k = 0..{cfg.n_blocks}, bitwise; max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))
    hold16_quant(cfg, g, dev, ops)
    return worst


def quant_kernel_times(cfg, dev, ops):
    """Each per-tensor kernel, its plain version and ``torch.aminmax``
    (beside pass 1: it is the min/max pass alone, not the function, so
    it is kept as ``minmax_ms`` and no library call is recorded) at every
    per-frame shape (summed: one frame through each k) and at the largest
    shape, 2^24 + 3; then the round trip against quantize + dequantize,
    the two launches ``SplitEngine.run`` made a frame before it."""
    g = torch.Generator(device=dev).manual_seed(8)
    shapes = [(f"k={k} {s}", s) for k, s in enumerate(boundary_shapes(cfg))]
    shapes.append(("largest", (2 ** 24 + 3,)))
    names = ("int8_quantize", "int8_dequantize", "int8_quantize_roundtrip")
    rows = {name: {"per_frame": dict.fromkeys(
        ("ms", "plain_ms", "bound_ms", "minmax_ms", "bytes_ms", "ops_ms"),
        0.0)} for name in names}
    for what, shape in shapes:
        x = torch.randn(*shape, device=dev, generator=g)
        qt = ops.int8_quantize(x)
        n = x.numel()
        lib = device_ms(torch.aminmax, x)
        for name, fn, plain, arg, nbytes, nops in (
                # read x once, write q and the 8-byte (scale, zero)
                # header; min + max, then divide, add, round, 2 clamps,
                # convert (above one block, pass 2 reads x again: not
                # counted)
                ("int8_quantize", ops.int8_quantize, ops.int8_quantize_ref,
                 x, 5 * n + 8, 8 * n),
                # read q and the header, write out: subtract, multiply
                ("int8_dequantize", ops.int8_dequantize,
                 ops.int8_dequantize_ref, qt, 5 * n + 8, 2 * n),
                # read x, write q, the header and out: the quantize's
                # operations and the dequantize's
                ("int8_quantize_roundtrip", ops.int8_quantize_roundtrip,
                 ops.int8_quantize_roundtrip_ref, x, 9 * n + 8, 10 * n)):
            ms = device_ms(fn, arg)
            plain_ms = device_ms(plain, arg)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = nops / FP32_OPS_PER_S * 1e3
            cell = {"ms": ms, "plain_ms": plain_ms,
                    "bound_ms": max(b_ms, o_ms),
                    "bound_by": "bytes" if b_ms >= o_ms else "operations",
                    "library_ms": None,
                    "minmax_ms": lib if name == "int8_quantize" else None}
            print(f"{name} {what} ({n} elements): device kernel "
                  f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us"
                  + (f", torch.aminmax {lib * 1e3:.2f} us"
                     if name == "int8_quantize" else "")
                  + f"; bound {max(b_ms, o_ms) * 1e3:.3f} us "
                  f"({'bytes' if b_ms >= o_ms else 'operations'})")
            if what == "largest":
                rows[name]["largest"] = cell
            else:
                acc = rows[name]["per_frame"]
                for key in ("ms", "plain_ms", "bound_ms"):
                    acc[key] += cell[key]
                acc["minmax_ms"] += lib
                acc["bytes_ms"] += b_ms
                acc["ops_ms"] += o_ms
    for name, r in rows.items():
        pf = r["per_frame"]
        print(f"{name} per frame through k = 0..{cfg.n_blocks - 1} (summed):"
              f" device kernel {pf['ms'] * 1e3:.2f} us, plain "
              f"{pf['plain_ms'] * 1e3:.2f} us, bound "
              f"{pf['bound_ms'] * 1e3:.3f} us"
              + (f", torch.aminmax (the min/max pass alone) "
                 f"{pf['minmax_ms'] * 1e3:.2f} us"
                 if name == "int8_quantize" else ""))
    two = {key: rows["int8_quantize"][key]["ms"]
           + rows["int8_dequantize"][key]["ms"]
           for key in ("per_frame", "largest")}
    for key in ("per_frame", "largest"):
        rows["int8_quantize_roundtrip"][key]["quantize_dequantize_ms"] = \
            two[key]
    print(f"int8_quantize_roundtrip (1 launch a frame) "
          f"{rows['int8_quantize_roundtrip']['per_frame']['ms'] * 1e3:.2f} us"
          f" a frame against int8_quantize + int8_dequantize (2 launches) "
          f"{two['per_frame'] * 1e3:.2f} us; at 2^24 + 3 "
          f"{rows['int8_quantize_roundtrip']['largest']['ms'] * 1e3:.2f} "
          f"against {two['largest'] * 1e3:.2f} us")
    return rows


# --- 16-bit inputs: the wire, INT8, GMM and InfoNCE kernels ------------------

# The reference's kernels take bf16 input (the wire float16 too) and widen it
# to float32 (tests/test_kernels.py sweeps them in bf16); the port's kernels
# load it as it is and widen it in registers.  Widening is exact, so each
# kernel on a 16-bit input must give the bits of its float32 launch on
# x.float() (the gradients rounded once to bf16), and its plain version's
# bits or its bar.  Phases 1, 3, 5 and 7 hold them (``hold16_*``) at the
# reference's bf16 sweep shapes and at the path's shapes; no path of either
# package reaches them (0 launches on every counted path).
WIRE_SWEEP = ((1, (40, 32)), (5, (16, 16)), (17, (7,)), (64, (16, 16)),
              (3, (100,)), (13, (10, 8, 4)), (2, (128,)), (33, (20, 24)))
GMM_SWEEP = ((64, 8, 32), (200, 64, 128), (33, 16, 64), (128, 32, 256))
INFONCE_SWEEP = ((32, 64, 32), (64, 256, 128), (16, 100, 64))
INT8_SWEEP = ((100,), (37, 91), (8, 16, 33), (5000,))
HALF = ((torch.bfloat16, "bf16"), (torch.float16, "f16"))   # and suffixes
# max |err| against the plain versions by kernel and type, filled by the
# holds in phases 1, 3, 5 and 7 for the kernels' line
WORST16 = {}


def note16(name, err):
    WORST16[name] = max(WORST16.get(name, 0.0), err)


def widened(fn, x, what):
    """``fn(x)`` bitwise equal to ``fn(x.float())`` (tuples of outputs),
    and to a second launch -> the outputs."""
    got, again = fn(x), fn(x)
    wide = fn([a.float() for a in x] if isinstance(x, list) else x.float())
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, wide):
        check(same_values(a, b), f"{what} not bitwise from run to run")
        check(same_values(a, w), f"{what} != its float32 launch on the "
              "widened input")
    return got


def hold16_wire(cfg, g, dev, ops):
    """Phase 1's wire in bf16 and float16: bitwise its plain version and
    its float32 launch on the widened rows, one batch (every width and
    batch size, special rows; the reference's sweep shapes) and the tick's
    eight groups."""
    cases = [special_rows(torch.randn(B, n, device=dev, generator=g)
                          * 3.0 + 1.0)
             for n in sorted(set(wire_widths(cfg))) for B in BATCH_SIZES]
    cases += [torch.randn(B, *s, device=dev, generator=g) * 3.0 + 1.0
              for B, s in WIRE_SWEEP]
    for dt, t in HALF:
        for x in cases:
            x16 = x.to(dt)
            (got,) = widened(lambda a: (ops.wire_roundtrip(a),), x16,
                             f"wire_roundtrip {dt} at {tuple(x.shape)}")
            want = ops.wire_roundtrip_ref(x16)
            check(got.dtype == torch.float32 and same_values(got, want),
                  f"wire_roundtrip {dt} != plain at {tuple(x.shape)}")
            note16(f"wire_roundtrip_{t}",
                   (got - want).nan_to_num().abs().max().item())
        for what, xs in grouped_cases(cfg, g, dev)[:2]:
            xs16 = [x.to(dt) for x in xs]
            got = widened(ops.wire_roundtrip_grouped, xs16,
                          f"wire_roundtrip_grouped {dt} at {what}")
            for a, w in zip(got, ops.wire_roundtrip_grouped_ref(xs16)):
                check(same_values(a, w), f"wire_roundtrip_grouped {dt} != "
                      f"plain at {what}")
                note16(f"wire_roundtrip_grouped_{t}",
                       (a - w).nan_to_num().abs().max().item())
    print(f"phase 1: wire_roundtrip and wire_roundtrip_grouped on bf16 and "
          f"float16 rows bitwise == plain versions and == their float32 "
          f"launches on the widened rows, at {len(cases)} batches (every "
          f"width x B in {BATCH_SIZES} with special rows, and the "
          f"reference's sweep shapes {WIRE_SWEEP}) and the tick's 8 groups")


def hold16_gmm(g, dev, ops):
    """Phase 3's GMM posterior on bf16 z (mu, var, logpi float32): its
    float32 launch's bits on the widened z, and its plain version at phase
    3's bars, at the reference's sweep shapes and the refine, cascade and
    training shapes."""
    shapes = GMM_SWEEP + ((SESSIONS * WINDOW, N_COMPONENTS, 128),
                          (8, N_COMPONENTS, 1024), (BUFFER, 16, 128))
    for B, C, d in shapes:
        z, mu, var, logpi = gmm_inputs(g, dev, B, C, d)
        z16 = z.to(torch.bfloat16)
        what = f"bf16 z (B, C, d) = ({B}, {C}, {d})"
        widened(lambda a: ops.gmm_posterior(a, mu, var, logpi), z16,
                f"gmm_posterior {what}")
        note16("gmm_posterior_bf16", hold(
            "gmm_posterior", ops.gmm_posterior, ops.gmm_posterior_ref,
            (z16, mu, var, logpi), [(0.0, RESP_ATOL), (0.0, ENT_ATOL)],
            what))
    print(f"phase 3: gmm_posterior on bf16 z == its float32 launch on the "
          f"widened z bitwise and its plain version (resp atol {RESP_ATOL}, "
          f"entropy atol {ENT_ATOL}) at (B, C, d) in {shapes}; max |err| "
          f"{WORST16['gmm_posterior_bf16']:.3e}")


def bf16_grad_err(got, want, what):
    """A bf16 gradient against its plain version's: both are float32
    values within GRAD_ATOL of the max of each other (the sums' order),
    each rounded once to bf16, so they may land one bf16 ulp apart (at most
    2^-7 of the element) -> max |err|."""
    a, b = got.float(), want.float()
    err = (a - b).abs()
    bar = 2.0 ** -7 * b.abs() + GRAD_ATOL * b.abs().max()
    check(got.dtype == torch.bfloat16 and bool((err <= bar).all()),
          f"{what}: max |err| {err.max().item()} past 2^-7 |g| + "
          f"{GRAD_ATOL} max |g|")
    return err.max().item()


def hold16_infonce(g, dev, ops):
    """Phase 5's InfoNCE forward and backward on bf16 z, z_pos, z_neg:
    the float32 launches' bits on the widened inputs (the gradients
    rounded to bf16), the plain versions at phase 5's bars, and the
    autograd entry's bf16 gradients the kernels' bits, at the reference's
    sweep shapes and the edge learner's."""
    shapes = INFONCE_SWEEP + ((TRAIN_BATCH, N_SYN + TRAIN_BATCH, 128),)
    for B, N, d in shapes:
        what = f"bf16 (B, N, d) = ({B}, {N}, {d})"
        z, zp, zn, cot = (x.to(torch.bfloat16) if x.dim() > 1 else x
                          for x in infonce_inputs(g, dev, B, N, d))
        loss, lse = same_bits(lambda *a: ops.infonce_vneg_fwd(*a, 0.1),
                              (z, zp, zn), f"infonce_vneg_fwd {what}")
        wl, wlse = ops.infonce_vneg_fwd(z.float(), zp.float(), zn.float(),
                                        0.1)
        check(torch.equal(loss, wl) and torch.equal(lse, wlse),
              f"infonce_vneg_fwd {what} != its float32 launch widened")
        for a, b in zip((loss, lse), ops.infonce_vneg_fwd_ref(z, zp, zn,
                                                              0.1)):
            err = (a - b).abs().max().item()
            note16("infonce_vneg_fwd_bf16", err)
            check(torch.allclose(a, b, rtol=INFONCE_RTOL, atol=0.0),
                  f"infonce_vneg_fwd {what} != plain: max |err| {err}")
        got = same_bits(lambda *a: ops.infonce_vneg_bwd(*a, 0.1),
                        (z, zp, zn, lse, cot), f"infonce_vneg_bwd {what}")
        wide = ops.infonce_vneg_bwd(z.float(), zp.float(), zn.float(), lse,
                                    cot, 0.1)
        check(all(torch.equal(a, w.to(torch.bfloat16))
                  for a, w in zip(got, wide)),
              f"infonce_vneg_bwd {what} != its float32 launch widened, "
              "rounded to bf16")
        for a, b, n in zip(got, ops.infonce_vneg_bwd_ref(z, zp, zn, lse,
                                                         cot, 0.1),
                           ("dz", "dz_pos", "dz_neg")):
            note16("infonce_vneg_bwd_bf16",
                   bf16_grad_err(a, b, f"infonce_vneg_bwd {n} {what}"))
        leaves = [x.clone().requires_grad_() for x in (z, zp, zn)]
        with torch.enable_grad():
            entry = torch.autograd.grad(ops.infonce_vneg(*leaves, 0.1),
                                        leaves, cot)
        check(all(torch.equal(a, b) for a, b in zip(entry, got)),
              f"infonce_vneg's bf16 gradients != the kernels' bits {what}")
    print(f"phase 5: infonce_vneg fwd and bwd on bf16 inputs == their "
          f"float32 launches on the widened inputs bitwise (the gradients "
          f"rounded to bf16), their plain versions (loss and lse rtol "
          f"{INFONCE_RTOL}, gradients one bf16 ulp + {GRAD_ATOL} max |g|), "
          f"the autograd entry the kernels' bits, at (B, N, d) in {shapes}; max "
          f"|err| fwd {WORST16['infonce_vneg_fwd_bf16']:.3e}, bwd "
          f"{WORST16['infonce_vneg_bwd_bf16']:.3e}")


def misaligned16(x):
    """A contiguous bf16 copy of ``x`` one value past an 8-byte boundary
    (the kernels' scalar path)."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=torch.bfloat16)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def hold16_quant(cfg, g, dev, ops):
    """Phase 7's quantize and round trip on bf16 x (one block and two
    passes), and the dequantize into bf16 and float16: bitwise their plain
    versions and their float32 launches on the widened x, at phase 7's
    cases, a bf16 view off 8 bytes and the reference's sweep shapes."""
    cases = [(what, x.to(torch.bfloat16)) for what, x in quant_cases(
        cfg, g, dev)]
    cases.append(("bf16 view off 8 bytes, n=16,385", misaligned16(
        torch.randn(16385, device=dev, generator=g))))
    cases += [(f"sweep {s}", (torch.randn(*s, device=dev, generator=g) * 3.0
                              + 1.0).to(torch.bfloat16)) for s in INT8_SWEEP]
    for what, x in cases:
        qt = widened(ops.int8_quantize, x, f"int8_quantize bf16 at {what}")
        want = ops.int8_quantize_ref(x)
        check(all(same_values(a, b) for a, b in zip(qt, want)),
              f"int8_quantize bf16 != plain at {what}")
        note16("int8_quantize_bf16",
               (qt.q.int() - want.q.int()).abs().max().item())
        rq, rout = ops.int8_quantize_roundtrip(x)
        wq, wout = ops.int8_quantize_roundtrip(x.float())
        want_out = ops.int8_dequantize_ref(want)
        check(all(same_values(a, b) for a, b in zip(rq, wq))
              and same_values(rout, wout) and same_values(rout, want_out),
              f"int8_quantize_roundtrip bf16 at {what} != its float32 launch"
              " widened or the plain version")
        note16("int8_quantize_roundtrip_bf16",
               (rout - want_out).nan_to_num().abs().max().item())
        for dt, t in HALF:
            out, out2 = (ops.int8_dequantize(qt, dtype=dt),
                         ops.int8_dequantize(qt, dtype=dt))
            plain = ops.int8_dequantize_ref(qt, dt)
            check(out.dtype == dt and same_values(out, out2)
                  and same_values(out, plain)
                  and same_values(out, ops.int8_dequantize(qt).to(dt)),
                  f"int8_dequantize into {dt} at {what} != plain, its "
                  "float32 launch rounded, or its second launch")
            note16(f"int8_dequantize_{t}", (out.float() - plain.float())
                   .nan_to_num().abs().max().item())
    print(f"phase 7: int8_quantize and int8_quantize_roundtrip on bf16 x "
          f"(one block and two passes), int8_dequantize into bf16 and "
          f"float16: bitwise == plain versions, == their float32 launches "
          f"on the widened x (the dequantize's rounded), from run to run, at "
          f"{len(cases)} cases (phase 7's in bf16, a view off 8 bytes, the "
          f"reference's sweep shapes {INT8_SWEEP})")


def times16(cfg, dev, ops):
    """Each 16-bit variant, its plain version and its bound at the path's
    shape: the wire at the tick's 8 buckets of 32 rows, INT8 per frame
    (summed over the boundary shapes), the GMM at the refine shape, InfoNCE
    at the edge learner's -> {record name: times and bound}."""
    g = torch.Generator(device=dev).manual_seed(16)
    out = {}

    def add(name, fn, plain, arg, nbytes, nops, reps=40, plain_reps=40):
        ms = device_ms(fn, arg, reps=reps)
        plain_ms = device_ms(plain, arg, reps=plain_reps)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / FP32_OPS_PER_S * 1e3
        row = out.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "bytes_ms": 0.0, "ops_ms": 0.0})
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bytes_ms"] += b_ms
        row["ops_ms"] += o_ms
    xs = [torch.randn(32, n, device=dev, generator=g)
          for n in wire_widths(cfg)]
    elems = sum(x.numel() for x in xs)
    for dt, t in HALF:
        # read x once (2 bytes), write float32 out once; kernel_times' 9
        # operations an element; the one-group call a launch a bucket
        add(f"wire_roundtrip_grouped_{t}", ops.wire_roundtrip_grouped,
            ops.wire_roundtrip_grouped_ref, [x.to(dt) for x in xs],
            6 * elems, 9 * elems, plain_reps=8)
        add(f"wire_roundtrip_{t}",
            lambda ys: [ops.wire_roundtrip(y) for y in ys],
            ops.wire_roundtrip_grouped_ref, [x.to(dt) for x in xs],
            6 * elems, 9 * elems, plain_reps=8)
    for shape in boundary_shapes(cfg):
        x = torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)
        qt = ops.int8_quantize(x)
        n = x.numel()
        # quant_kernel_times' counts with x (or out) at 2 bytes an element
        add("int8_quantize_bf16", ops.int8_quantize, ops.int8_quantize_ref,
            x, 3 * n + 8, 8 * n)
        add("int8_quantize_roundtrip_bf16", ops.int8_quantize_roundtrip,
            ops.int8_quantize_roundtrip_ref, x, 7 * n + 8, 10 * n)
        for dt, t in HALF:
            add(f"int8_dequantize_{t}",
                lambda a, dt=dt: ops.int8_dequantize(a, dtype=dt),
                lambda a, dt=dt: ops.int8_dequantize_ref(a, dt), qt,
                3 * n + 8, 3 * n)
    B, C, d = SESSIONS * WINDOW, N_COMPONENTS, 128
    z, mu, var, logpi = gmm_inputs(g, dev, B, C, d)
    # refine_kernel_times' counts with z at 2 bytes an element
    add("gmm_posterior_bf16", lambda a: ops.gmm_posterior(*a),
        lambda a: ops.gmm_posterior_ref(*a),
        (z.to(torch.bfloat16), mu, var, logpi),
        2 * B * d + 4 * (2 * C * d + C + B * C + B),
        4 * B * C * d + 11 * B * C, plain_reps=4)
    B, N = TRAIN_BATCH, N_SYN + TRAIN_BATCH
    z, zp, zn, cot = infonce_inputs(g, dev, B, N, d)
    z, zp, zn = (x.to(torch.bfloat16) for x in (z, zp, zn))
    _, lse = ops.infonce_vneg_fwd(z, zp, zn, 0.1)
    # train_kernel_times' counts with z, z_pos, z_neg (and their
    # gradients) at 2 bytes an element
    add("infonce_vneg_fwd_bf16", lambda a: ops.infonce_vneg_fwd(*a, 0.1),
        lambda a: ops.infonce_vneg_fwd_ref(*a, 0.1), (z, zp, zn),
        2 * (2 * B * d + B * N * d) + 4 * 2 * B,
        2 * B * N * d + 2 * B * d + 4 * B * (N + 1))
    add("infonce_vneg_bwd_bf16", lambda a: ops.infonce_vneg_bwd(*a, 0.1),
        lambda a: ops.infonce_vneg_bwd_ref(*a, 0.1), (z, zp, zn, lse, cot),
        2 * (4 * B * d + 2 * B * N * d) + 4 * 2 * B,
        5 * B * N * d + 6 * B * d + 3 * B * N)
    for name, row in out.items():
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                           else "operations")
        print(f"{name} at the path's shape: device kernel "
              f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} "
              f"us, bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")
    return out


def records16(times):
    """The kernels' line's records of the 16-bit variants: 0 launches, on
    no counted path."""
    base = {"wire_roundtrip_grouped": ("wire_roundtrip.cu",
                                       "int8_quant.py:90"),
            "wire_roundtrip": ("wire_roundtrip.cu", "int8_quant.py:90"),
            "int8_quantize": ("int8_quant.cu", "int8_quant.py:36"),
            "int8_quantize_roundtrip": ("int8_quant.cu",
                                        "int8_quant.py:36 and :129"),
            "int8_dequantize": ("int8_quant.cu", "int8_quant.py:129"),
            "gmm_posterior": ("gmm_posterior.cu", "gmm_posterior.py:50"),
            "infonce_vneg_fwd": ("infonce_vneg.cu", "infonce_vneg.py:52")}
    records = []
    for name, row in times.items():
        kernel = name.rsplit("_", 1)[0]
        if kernel == "infonce_vneg_bwd":
            source, replaces = "infonce_vneg.cu", (
                "no Pallas counterpart: the reference differentiates the jnp "
                "twin (src/repro/core/infonce.py:19)")
        else:
            source, line = base[kernel]
            replaces = f"src/repro/kernels/{line}"
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": 0,
            "max_abs_err": WORST16[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "launches_by_path": {}})
    return records


# --- StreamServer at full width with the RL split policy ---------------------

STREAM_CLASSES = (("interactive", 16), ("standard", 48), ("bulk", 192))
STREAM_FRAMES = 8          # frames per session
STREAM_BATCH = 128         # SchedulerCfg(max_batch): half a round
STREAM_DT = 0.05           # fake-clock seconds per step
STREAM_QUEUE = 2048        # per-class queue bound: the backlog never refuses


class FakeClock:
    """A clock that moves only when the caller moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def stream_server(cfg, params, device, clock=None, pipeline=True):
    """A full-width gateway (capacity 256, window 100, overlapped, the RL
    policy on ``init_policy`` from a seed) behind a ``StreamServer`` with
    ``max_batch`` 128, and its 256 sessions -> (server, sids)."""
    from repro_torch.api import QoSClass, StreamSplitGateway, make_policy
    from repro_torch.core.ppo import init_policy
    from repro_torch.serving import SchedulerCfg, StreamServer
    L = cfg.n_blocks
    policy = make_policy("rl", L, rl_params=init_policy(
        torch.Generator().manual_seed(0), 3, L + 1))
    kw = {"clock": clock} if clock is not None else {}
    gw = StreamSplitGateway(cfg, params, policy=policy, capacity=SESSIONS,
                            window=100, overlap=True, qos_reserve=0,
                            device=device, **kw)
    srv = StreamServer(gw, cfg=SchedulerCfg(max_batch=STREAM_BATCH),
                       queue_maxlen=STREAM_QUEUE, pipeline=pipeline)
    sids = [srv.open_session(qos=QoSClass(c)).sid
            for c, n in STREAM_CLASSES for _ in range(n)]
    return srv, sids


def stream_frames(cfg, sids, seed):
    """{(sid, t): FrameRequest}: a seeded mel and telemetry (u, cpu,
    bandwidth) for each session's STREAM_FRAMES frames."""
    from repro_torch.api import FrameRequest
    rng = np.random.default_rng(seed)
    frames = {}
    for t in range(STREAM_FRAMES):
        mels = rng.standard_normal((len(sids), cfg.frames, cfg.n_mels),
                                   np.float32)
        tel = rng.random((len(sids), 3))
        for i, sid in enumerate(sids):
            frames[(sid, t)] = FrameRequest(
                t=t, mel=mels[i], u=float(tel[i, 0]), cpu=float(tel[i, 1]),
                bandwidth_mbps=float(60.0 * tel[i, 2]))
    return frames


def conserved(st):
    """The server's conservation identities at one snapshot -> a failure
    message, or None when they hold."""
    for c in st.frames_submitted:
        if st.frames_submitted[c] != (st.frames_served[c] + st.queue_depth[c]
                                      + st.in_flight[c] + st.shed_expired[c]):
            return f"class {c}: {st}"
    if st.preempted != st.requeued:
        return f"preempted {st.preempted} != requeued {st.requeued}"
    return None


def count_ticks(gw):
    """Wrap ``gw.tick_collect`` so that each collected tick records (its
    syncs, its D2H copies, the host clock, its launch-to-collect ms) ->
    the list they go to."""
    counts, collect = [], gw.tick_collect

    def counted(plan):
        out = collect(plan)
        counts.append((gw.registry.value("gateway_device_syncs_per_tick"),
                       gw.registry.value("gateway_d2h_copies_per_tick"),
                       time.perf_counter(),
                       gw.registry.value("gateway_last_tick_ms")))
        return out
    gw.tick_collect = counted
    return counts


def phase8(cfg, dev, ops):
    """``StreamServer`` at full width with the RL policy: (a) a stepped
    fake-clock run held bitwise against a sequential replay, counted;
    (b) a live run on the real clock; then one profiled pipelined tick
    pair -> the kernels' launch counts from (a)."""
    import threading

    from repro_torch.api import StreamSplitGateway
    from repro_torch.models.audio_encoder import init_audio_encoder
    L = cfg.n_blocks
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))

    # --- (a) deterministic: step() on a fake clock, counted -------------
    clock = FakeClock()
    srv, sids = stream_server(cfg, params, "cuda", clock)
    frames = stream_frames(cfg, sids, 8)
    counts = count_ticks(srv.gateway)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    for t in range(STREAM_FRAMES):
        for sid in sids:
            srv.submit(sid, frames[(sid, t)])
        clock.t += STREAM_DT
        srv.step()
        msg = conserved(srv.stats())
        check(msg is None, f"phase 8 (a) conservation after round {t}: {msg}")
    while srv.busy():
        clock.t += STREAM_DT
        srv.step()
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()
    st = srv.stats()
    results = {(r.sid, r.t): r for r in srv.drain_results()}
    n = len(sids) * STREAM_FRAMES
    check(len(results) == n and st.ticks == len(counts),
          f"(a) {len(results)} results of {n}, {st.ticks} ticks")
    check(all(c[:2] == (1, 1) for c in counts),
          f"(a) syncs/D2H per tick {[c[:2] for c in counts]}, want 1 and 1")
    check(st.pipelined_ticks > 0, "(a) no pipelined tick")
    msg = conserved(st)
    check(msg is None, f"(a) conservation: {msg}")
    check(sum(st.frames_served.values()) == n
          and sum(st.shed_expired.values()) == 0, "(a) served")
    check(st.preempted["bulk"] > 0 and st.preempted["interactive"] == 0
          and st.preempted["standard"] == 0,
          f"(a) preemption {st.preempted}: want BULK only, and some")
    schedule = srv.schedule()
    want_wire = sum(bool({results[key].k for key in tick} - {L})
                    for tick in schedule)
    check(launches["wire_roundtrip_grouped"] == want_wire
          and launches["wire_roundtrip"] == 0,
          f"(a) wire launches {launches['wire_roundtrip_grouped']} grouped, "
          f"{launches['wire_roundtrip']} one-group; want {want_wire} grouped "
          "(one a tick with a bucket of k < L) and no other")
    ks = np.bincount([r.k for r in results.values()], minlength=L + 1)
    check((ks > 0).sum() >= 3, f"(a) the policy chose k {ks}")
    # the sequential replay on the card: same schedule, same embeddings
    gw = StreamSplitGateway(cfg, params, policy=srv.gateway.policy,
                            capacity=SESSIONS, window=100, qos_reserve=0,
                            device="cuda")
    check([gw.open_session(qos=srv.gateway.session(sid).qos).sid
           for sid in sids] == sids, "replay sids")
    for tick in schedule:
        for key in tick:
            gw.submit(key[0], frames[key])
        for r in gw.tick():
            ref = results[(r.sid, r.t)]
            check(r.k == ref.k and np.array_equal(r.z, ref.z),
                  f"(a) ({r.sid}, {r.t}) != the sequential replay")
    z = np.stack([r.z for r in results.values()])
    check(np.isfinite(z).all() and np.abs(np.linalg.norm(z, axis=1) - 1)
          .max() <= 1e-5, "(a) embeddings not finite unit vectors")
    print(f"phase 8 (a): StreamServer, {len(sids)} sessions ("
          + ", ".join(f"{n} {c}" for c, n in STREAM_CLASSES)
          + f") x {STREAM_FRAMES} frames, "
          f"max_batch {STREAM_BATCH}, fake clock {STREAM_DT} s a step: "
          f"{st.ticks} ticks, {st.pipelined_ticks} pipelined, 1 sync + 1 "
          f"D2H on every tick; preempted {st.preempted} == requeued; "
          f"deadline misses {st.deadline_misses}; k histogram "
          f"{ks.tolist()}; every embedding bitwise == the sequential replay "
          f"of schedule() ({len(schedule)} ticks); launches {launches}")

    # --- (b) live: the serving thread on the real clock ------------------
    srv_b, sids_b = stream_server(cfg, params, "cuda")
    frames_b = stream_frames(cfg, sids_b, 9)
    counts_b = count_ticks(srv_b.gateway)
    errors = []

    def client(my_sids):
        try:
            for t in range(STREAM_FRAMES):
                for sid in my_sids:
                    srv_b.submit(sid, frames_b[(sid, t)])
                time.sleep(0.005)
            for sid in my_sids:
                srv_b.close_session(sid, timeout=300.0)
        except BaseException as e:        # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(sids_b[i::4],))
               for i in range(4)]
    start = time.perf_counter()
    srv_b.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600.0)
    wall = time.perf_counter() - start
    srv_b.stop(timeout=120.0)
    check(not any(th.is_alive() for th in threads), "(b) a client hung")
    check(not errors, f"(b) client error: {errors[:1]}")
    st_b = srv_b.stats()
    msg = conserved(st_b)
    check(msg is None, f"(b) conservation: {msg}")
    check(all(c[:2] == (1, 1) for c in counts_b),
          f"(b) syncs/D2H per tick {[c[:2] for c in counts_b]}")
    res_b = srv_b.drain_results()
    served = sum(st_b.frames_served.values())
    check(served + sum(st_b.shed_expired.values()) == n
          and len(res_b) == served, f"(b) served {served} of {n}")
    period = np.diff([c[2] for c in counts_b]) * 1e3
    span = np.array([c[3] for c in counts_b])
    ks_b = np.bincount([r.k for r in res_b], minlength=L + 1)
    waits = {c: {q: round(v, 3) for q, v in w.items() if q in ("p50", "p95")}
             for c, w in st_b.queue_wait_ms.items()}
    print(f"phase 8 (b): live, 4 client threads, {n} frames in "
          f"{wall:.3f} s = {served / wall:.1f} frames/s; {st_b.ticks} ticks,"
          f" {st_b.pipelined_ticks} pipelined (share "
          f"{st_b.pipelined_ticks / max(st_b.ticks, 1):.3f}); tick period "
          f"(collect to collect) ms p50 {np.percentile(period, 50):.3f} p95 "
          f"{np.percentile(period, 95):.3f}; tick in flight (launch to "
          f"collect) ms p50 {np.percentile(span, 50):.3f} p95 "
          f"{np.percentile(span, 95):.3f}; queue wait ms {waits}; deadline "
          f"misses {st_b.deadline_misses}; shed {st_b.shed_expired}; "
          f"preempted {st_b.preempted}; k histogram {ks_b.tolist()}; 1 sync "
          f"+ 1 D2H on every tick")
    pipeline_on_off(cfg, params, frames)
    profile_pipelined_pair(srv, sids, frames, clock,
                           float(np.percentile(period, 50)))
    return launches


def pipeline_on_off(cfg, params, frames):
    """(a)'s frames, all queued up front, then stepped back to back until
    served, with ``pipeline`` on and off in turns (on, off, off, on) ->
    host ms a tick of the stepping loop, of ``tick_launch`` and of the
    collect's wait.  Off, each step collects tick t (waiting for its
    device tail) before it launches t+1; on, t+1's launches run while t's
    chains finish, so only a tail that outlasts them is waited for."""
    per_tick = {True: [], False: []}
    for pipeline in (True, False, False, True):
        clock = FakeClock()
        srv, sids = stream_server(cfg, params, "cuda", clock, pipeline)
        gw, spent = srv.gateway, {"launch": 0.0, "wait": 0.0}
        launch, block = gw.tick_launch, gw._block

        def timed(key, fn):
            def call(*args, **kwargs):
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                spent[key] += time.perf_counter() - start
                return out
            return call
        gw.tick_launch, gw._block = timed("launch", launch), timed(
            "wait", block)
        for t in range(STREAM_FRAMES):
            for sid in sids:
                srv.submit(sid, frames[(sid, t)])
        torch.cuda.synchronize()
        start = time.perf_counter()
        while srv.busy():
            clock.t += STREAM_DT
            srv.step()
        total = time.perf_counter() - start
        st = srv.stats()
        check(sum(st.frames_served.values()) == len(frames)
              and (st.pipelined_ticks > 0) == pipeline,
              f"pipeline={pipeline}: {st.frames_served}, "
              f"{st.pipelined_ticks} pipelined")
        per_tick[pipeline].append(tuple(
            v * 1e3 / st.ticks for v in (total, spent["launch"],
                                         spent["wait"])))
    def mean_ms(pipeline):
        return float(np.mean([x[0] for x in per_tick[pipeline]]))
    print("stepped back to back, pipeline on / off in turns (on, off, off, "
          "on): ms a tick (of which tick_launch, collect's wait) "
          + ", ".join(f"{'on' if p else 'off'} {a:.3f} ({b:.3f}, {c:.3f})"
                      for p, (a, b, c) in (
                          (True, per_tick[True][0]),
                          (False, per_tick[False][0]),
                          (False, per_tick[False][1]),
                          (True, per_tick[True][1])))
          + f"; on saves {mean_ms(False) - mean_ms(True):.3f} ms a tick")


def profile_pipelined_pair(srv, sids, frames, clock, period_p50):
    """Two more pipelined steps of the stepped server under
    torch.profiler (each launches tick t+1 before it collects tick t):
    device busy time, the idle share of the profiled window, and a tick's
    busy time against the live run's p50 tick period."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import FrameRequest
    for t in range(STREAM_FRAMES, STREAM_FRAMES + 2):
        for sid in sids:
            f = frames[(sid, t - STREAM_FRAMES)]
            srv.submit(sid, FrameRequest(t=t, mel=f.mel, u=f.u, cpu=f.cpu,
                                         bandwidth_mbps=f.bandwidth_mbps))
    clock.t += STREAM_DT
    srv.step()                         # a tick in flight
    torch.cuda.synchronize()
    pipelined = srv.stats().pipelined_ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(2):
            clock.t += STREAM_DT
            srv.step()
        window_ms = (time.perf_counter() - start) * 1e3
    while srv.busy():
        clock.t += STREAM_DT
        srv.step()
    check(srv.stats().pipelined_ticks >= pipelined + 2,
          "profiled steps were not pipelined")
    events = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiled pipelined tick pair: not measured (torch.profiler "
              "recorded no device activity)")
        return
    busy_ms = sum(events) / 1e3
    print(f"profiled pipelined tick pair: {len(events)} device activities, "
          f"busy {busy_ms:.3f} ms in a {window_ms:.3f} ms window (idle "
          f"share {1.0 - busy_ms / window_ms:.3f} under the profiler); a "
          f"tick's busy {busy_ms / 2:.3f} ms against the live p50 tick "
          f"period {period_p50:.3f} ms: idle share "
          f"{1.0 - busy_ms / 2 / period_p50:.3f}")


# --- the cascade's attention kernel -------------------------------------------

# (B, H, KV, Sq, Sk, hd, causal): the two tiers' layers (qwen1.5-0.5b MHA,
# qwen3-1.7b GQA), long causal rows (GQA at hd 128 too, where a drift of
# the sums over keys and the registers of the o accumulator would show),
# ragged and single-row tails, Sq != Sk without the mask, and the two small
# head dims
FLASH_CASES = ((8, 16, 16, 1024, 1024, 64, True),
               (4, 16, 8, 1024, 1024, 128, True),
               (1, 16, 16, 4096, 4096, 64, True),
               (1, 16, 8, 4096, 4096, 128, True),
               (2, 4, 4, 1000, 1000, 64, True),
               (1, 2, 2, 1, 1, 64, True),
               (2, 2, 2, 128, 256, 64, False),
               (2, 4, 2, 200, 200, 16, True),
               (2, 4, 4, 300, 300, 32, False))
# phase 14's prefill shapes that FLASH_CASES lacks: zamba2-1.2b's shared
# block (8 x 1,024, 32 heads of 64) and the arctic-480b cut's layers (2 x
# 256, 56 heads over 8 (a group of 7), hd 128)
PREFILL_FLASH_CASES = ((8, 32, 32, 1024, 1024, 64, True),
                       (2, 56, 8, 256, 256, 128, True))
FLASH_O_ATOL, FLASH_LSE_ATOL = 2e-5, 1e-5
# the tiers' layer shapes at phase 10's batch of 8 x 1,024 tokens (the
# large tier's padded sub-batch of 4)
FLASH_TIMED = {"small": (8, 16, 16, 1024, 1024, 64),
               "large": (4, 16, 8, 1024, 1024, 128)}


def flash_inputs(g, dev, B, H, KV, Sq, Sk, hd):
    return (torch.randn(B, H, Sq, hd, device=dev, generator=g),
            torch.randn(B, KV, Sk, hd, device=dev, generator=g),
            torch.randn(B, KV, Sk, hd, device=dev, generator=g))


def phase9(dev, ops):
    """``flash_attention_fwd`` against its plain version on the card ->
    max |err| of o and lse."""
    g = torch.Generator(device=dev).manual_seed(9)
    worst = 0.0
    for B, H, KV, Sq, Sk, hd, causal in FLASH_CASES + PREFILL_FLASH_CASES:
        fa = lambda q, k, v: ops.flash_attention_fwd(  # noqa: E731
            q, k, v, causal=causal)
        ref = lambda q, k, v: ops.flash_attention_ref(  # noqa: E731
            q, k, v, causal)
        worst = max(worst, hold(
            "flash_attention_fwd", fa, ref,
            flash_inputs(g, dev, B, H, KV, Sq, Sk, hd),
            [(0.0, FLASH_O_ATOL), (0.0, FLASH_LSE_ATOL)],
            f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} hd={hd} causal={causal}"))
    print(f"phase 9: flash_attention_fwd == plain version (o atol "
          f"{FLASH_O_ATOL}, lse atol {FLASH_LSE_ATOL}), bitwise from run to "
          f"run, at (B, H, KV, Sq, Sk, hd, causal) in "
          f"{FLASH_CASES + PREFILL_FLASH_CASES}; max "
          f"|err| {worst:.3e}")
    return worst


def cascade_kernel_times(dev, ops):
    """The flash kernel, its plain version and
    ``scaled_dot_product_attention`` (timed only: the port never calls it)
    at each tier's layer shape, and the GMM kernel at the cascade's
    (8, 64, 1,024) -> {"small" | "large" | "gmm": times and bound}."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(10)
    out = {}
    for tier, (B, H, KV, Sq, Sk, hd) in FLASH_TIMED.items():
        q, k, v = flash_inputs(g, dev, B, H, KV, Sq, Sk, hd)
        ms = device_ms(lambda a: ops.flash_attention_fwd(*a), (q, k, v))
        plain_ms = device_ms(lambda a: ops.flash_attention_ref(*a),
                             (q, k, v), reps=5)
        lib_ms = device_ms(lambda a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True), (q, k, v))
        pairs = sum(min(i + 1, Sk) for i in range(Sq))    # causal (i, j)
        nops = 4 * B * H * pairs * hd          # two products, 2 ops a FMA
        nbytes = 4 * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd + B * H * Sq)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = nops / TF32X3_OPS_PER_S * 1e3
        out[tier] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_ratio": ms / lib_ms,
                     "bound_ms": max(b_ms, o_ms),
                     "bound_by": "bytes" if b_ms >= o_ms else "operations",
                     "simt_bound_ms": max(b_ms,
                                          nops / FP32_OPS_PER_S * 1e3),
                     "shape": [B, H, KV, Sq, Sk, hd]}
        print(f"flash_attention_fwd at the {tier} tier's layer (B {B}, H {H}, "
              f"KV {KV}, S {Sq}, hd {hd}, causal): device kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"scaled_dot_product_attention {lib_ms * 1e3:.2f} us (kernel at "
              f"{ms / lib_ms:.3f}x it); bound "
              f"{max(b_ms, o_ms) * 1e3:.2f} us in 3xTF32 "
              f"({out[tier]['bound_by']}: {nops} operations, {nbytes} "
              f"bytes; float32 SIMT "
              f"{out[tier]['simt_bound_ms'] * 1e3:.2f} us); kernel at "
              f"{max(b_ms, o_ms) / ms:.3f} of the bound")
    B, C, d = CASCADE_B, N_COMPONENTS, 1024
    args = gmm_inputs(g, dev, B, C, d)
    ms = device_ms(lambda a: ops.gmm_posterior(*a), args)
    plain_ms = device_ms(lambda a: ops.gmm_posterior_ref(*a), args, reps=10)
    nbytes = 4 * (B * d + 2 * C * d + C + B * C + B)
    nops = 4 * B * C * d + 11 * B * C
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    out["gmm"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, o_ms),
                  "bound_by": "bytes" if b_ms >= o_ms else "operations",
                  "shape": [B, C, d]}
    print(f"gmm_posterior at the cascade's shape (B {B}, C {C}, d {d}): "
          f"device kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; "
          f"bound {max(b_ms, o_ms) * 1e3:.2f} us ({out['gmm']['bound_by']}: "
          f"{nbytes} bytes, {nops} operations)")
    return out


# --- the cascade server ------------------------------------------------------

# phase 10's traffic: 6 batches (after one warm-up) of 8 requests x 1,024
# tokens; the two tiers' parameter counts (the reference's jax.eval_shape
# of init_lm)
CASCADE_BATCHES, CASCADE_B, CASCADE_S = 6, 8, 1024
PARAMS = {"qwen1.5-0.5b": 463_987_712, "qwen3-1.7b": 1_720_574_976}
CASCADE_ATOL = 1e-4      # kernel vs plain attention; card vs CPU (of max)


def plain_attention(attn_mod):
    """A context in which ``attention`` takes the reference's plain path on
    the card too (the comparisons only; the served path never does)."""
    @contextlib.contextmanager
    def ctx():
        rule = attn_mod.uses_kernel
        attn_mod.uses_kernel = lambda cfg, window, S: False
        try:
            yield
        finally:
            attn_mod.uses_kernel = rule
    return ctx()


def phase10(dev, ops):
    """``CascadeServer`` at full width and depth on the card: one warm-up
    batch, then the counted batches with the counts set to 0 just before
    and read just after; then the kernel against plain attention inside
    the small tier, a 2-layer large tier against the port on the CPU, and
    one profiled small forward -> the launch counts of the counted run."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import CascadeServer, CascadeStats
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.weights import to_device
    small, large = get_config("qwen1.5-0.5b"), get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    sp = lm.init_lm(small, torch.Generator(device=dev).manual_seed(0))
    lp = lm.init_lm(large, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for cfg, p in ((small, sp), (large, lp)):
        check(lm.param_count(p) == PARAMS[cfg.name],
              f"{cfg.name}: {lm.param_count(p)} parameters, want "
              f"{PARAMS[cfg.name]}")
    rng = np.random.default_rng(10)
    batches = [rng.integers(0, small.vocab, (CASCADE_B, CASCADE_S))
               for _ in range(1 + CASCADE_BATCHES)]
    # warm-up on a server of the same weights that escalates every
    # request (both tiers at full batch); the served one calibrates its
    # "auto" threshold on its own first batch, as the reference's does
    CascadeServer(small, sp, large, lp, threshold=-1.0,
                  device=dev).handle(batches[0])
    srv = CascadeServer(small, sp, large, lp, threshold="auto", device=dev)
    flash, gmm = ops.KERNELS["flash_attention_fwd"], ops.KERNELS[
        "gmm_posterior"]
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    batch_ms, per_batch, n_hard = [], [], []
    prev = CascadeStats()
    for toks in batches[1:]:
        f0, g0 = flash.launches, gmm.launches
        start = time.perf_counter()
        out, hard = srv.handle(toks)
        batch_ms.append((time.perf_counter() - start) * 1e3)
        st = srv.stats
        per_batch.append((st.route_ms - prev.route_ms,
                          st.small_ms - prev.small_ms,
                          st.large_ms - prev.large_ms))
        prev = CascadeStats(**vars(st))
        n_hard.append(int(hard.sum()))
        check(out.shape == (CASCADE_B, small.vocab) and hard.shape
              == (CASCADE_B,) and np.isfinite(out).all(),
              f"batch: logits {out.shape} (finite {np.isfinite(out).all()})"
              f", hard {hard.shape}")
        check((np.abs(out).max(-1) > 0).all(), "a request left unanswered")
        want_flash = small.n_layers + (large.n_layers if hard.any() else 0)
        check(flash.launches - f0 == want_flash,
              f"flash_attention_fwd launched {flash.launches - f0} times in "
              f"a batch with {hard.sum()} hard requests, want {want_flash}")
        check(gmm.launches - g0 == 2, f"gmm_posterior launched "
              f"{gmm.launches - g0} times in a batch, want 2")
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    st = srv.stats
    n_req = CASCADE_BATCHES * CASCADE_B
    check(st.served_small + st.served_large == n_req
          and st.served_large == sum(n_hard),
          f"served small {st.served_small} + large {st.served_large} != "
          f"{n_req} (hard {sum(n_hard)})")
    check(launches["flash_attention_fwd"] == CASCADE_BATCHES * small.n_layers
          + st.large_batches * large.n_layers
          and launches["gmm_posterior"] == 2 * CASCADE_BATCHES,
          f"launches {launches}")
    total_s = sum(batch_ms) / 1e3
    route, small_ms, large_ms = (np.array(c) for c in zip(*per_batch))
    print(f"phase 10: CascadeServer, qwen1.5-0.5b ({PARAMS[small.name]:,} "
          f"parameters) -> qwen3-1.7b ({PARAMS[large.name]:,}) at full width "
          f"and depth, float32, weights from seeded generators ({init_s:.2f} "
          f"s); threshold {srv.threshold!r} from the first batch; "
          f"{CASCADE_BATCHES} batches of {CASCADE_B} x {CASCADE_S} tokens: "
          f"served small {st.served_small}, large {st.served_large} (hard "
          f"per batch {n_hard}) in {st.large_batches} large sub-batches; "
          f"launches flash_attention_fwd {launches['flash_attention_fwd']} "
          f"({small.n_layers} per small forward, {large.n_layers} per large)"
          f", gmm_posterior {launches['gmm_posterior']} (2 per batch)")
    print(f"cascade ms p50: batch {np.percentile(batch_ms, 50):.3f} (p95 "
          f"{np.percentile(batch_ms, 95):.3f}), route {np.percentile(route, 50):.3f}"
          f", small {np.percentile(small_ms, 50):.3f}, large (batches with "
          f"hard requests) {np.percentile(large_ms[large_ms > 0], 50) if (large_ms > 0).any() else 0.0:.3f}; "
          f"{n_req / total_s:.2f} requests/s, "
          f"{n_req * CASCADE_S / total_s:.1f} tokens/s")

    # --- comparisons, outside the counted run ---
    toks = torch.as_tensor(batches[1]).to(dev)
    with torch.no_grad():
        h_kernel, _ = lm.forward(small, srv.small_params, tokens=toks)
        with plain_attention(attn_mod):
            h_plain, _ = lm.forward(small, srv.small_params, tokens=toks)
    err = (h_kernel - h_plain).abs().max().item()
    print(f"small tier hidden states (8 x 1,024 x 1,024), kernel vs plain "
          f"attention on the card: max |err| {err:.3e} (atol {CASCADE_ATOL})")
    check(err <= CASCADE_ATOL, f"kernel vs plain attention: {err}")
    del h_kernel, h_plain
    two = replace(large, n_layers=2)
    p2 = lm.init_lm(two, torch.Generator(device=dev).manual_seed(2))
    t2 = torch.as_tensor(rng.integers(0, two.vocab, (2, 256)))
    with torch.no_grad():
        h_card, _ = lm.forward(two, p2, tokens=t2.to(dev))
        l_card = lm.logits_from_hidden(two, p2, h_card[:, -1:])[:, -1].cpu()
        p2_cpu = to_device(p2, "cpu")
        h_cpu, _ = lm.forward(two, p2_cpu, tokens=t2)
        l_cpu = lm.logits_from_hidden(two, p2_cpu, h_cpu[:, -1:])[:, -1]
    errs = {"hidden": rel_err(h_card.cpu(), h_cpu),
            "logits": rel_err(l_card, l_cpu)}
    print("2-layer qwen3-1.7b at full width, (2, 256), card (flash kernel) "
          "vs the port on the CPU (plain attention), relative to each "
          "tensor's max |x|: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= CASCADE_ATOL, f"card vs CPU {k}: {v} > {CASCADE_ATOL}")
    del p2, p2_cpu
    profile_small_forward(srv, toks)
    return launches


def profile_small_forward(srv, toks):
    """The small tier's forward (the routing embedding and the easy
    answers) timed alone, then once under torch.profiler: device busy,
    idle share, top kernels and the flash kernel's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    times = []
    with torch.no_grad():
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            srv._embed(toks)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            srv._embed(toks)
            torch.cuda.synchronize()
    p50 = float(np.percentile(times, 50))
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    if not by_name:
        print(f"small forward p50 {p50:.3f} ms; profiled: not measured "
              "(torch.profiler recorded no device activity)")
        return
    busy = sum(by_name.values()) / 1e3
    flash = sum(v for k, v in by_name.items() if "flash_fwd" in k) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"small forward (8 x 1,024): p50 {p50:.3f} ms unprofiled; "
          f"profiled: device busy {busy:.3f} ms, idle share of the p50 "
          f"{1.0 - busy / p50:.3f}; flash kernel {flash:.3f} ms "
          f"({flash / busy:.3f} of busy); top: " + "; ".join(
              f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))


# --- the flash-attention backward kernels -------------------------------------

# phase 9's cases, and Sq > Sk under the mask and GQA at hd 128 with ragged
# Sq != Sk
FLASH_BWD_CASES = FLASH_CASES + ((1, 2, 2, 100, 37, 16, True),
                                 (2, 8, 2, 129, 65, 128, False))
FLASH_BWD_RTOL = 1e-5    # of each gradient's max |g| (see rel_grads)
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def rel_grads(gots, wants):
    """max |got - want| over max |want|, gradient by gradient, with a floor
    of 0.1x the largest of the set: dq and dk at Sk = 1 are exactly 0 (the
    softmax of one key is constant) and come out as rounding of
    dp - delta."""
    floor = 0.1 * max(w.abs().max().item() for w in wants)
    return max((a - w).abs().max().item() / max(w.abs().max().item(), floor)
               for a, w in zip(gots, wants))


def phase11(dev, ops):
    """``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` against
    the plain backward and against autograd through ``flash_attention_ref``
    on the card; bitwise from run to run, and the autograd entry
    ``flash_attention`` gives the kernels' bits -> {name: max |err|}."""
    g = torch.Generator(device=dev).manual_seed(11)
    worst = dict.fromkeys(BWD_KERNELS, 0.0)
    worst_rel = 0.0
    for B, H, KV, Sq, Sk, hd, causal in FLASH_BWD_CASES:
        what = (f"B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} hd={hd} "
                f"causal={causal}")
        q, k, v = flash_inputs(g, dev, B, H, KV, Sq, Sk, hd)
        do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        (dq,) = same_bits(lambda *a: (ops.flash_attention_bwd_dq(
            *a, causal=causal),), args, f"flash_attention_bwd_dq at {what}")
        dk, dv = same_bits(lambda *a: ops.flash_attention_bwd_dkv(
            *a, causal=causal), args, f"flash_attention_bwd_dkv at {what}")
        plain = (ops.flash_attention_bwd_dq_ref(*args, causal),
                 *ops.flash_attention_bwd_dkv_ref(*args, causal))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_ref, _ = ops.flash_attention_ref(*leaves, causal)
        auto = torch.autograd.grad(o_ref, leaves, do)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        entry = torch.autograd.grad(ops.flash_attention(*leaves, causal),
                                    leaves, do)
        torch.cuda.synchronize()
        for name, want in (("plain backward", plain), ("autograd", auto)):
            err = rel_grads((dq, dk, dv), want)
            worst_rel = max(worst_rel, err)
            check(err <= FLASH_BWD_RTOL, f"flash backward kernels != {name}"
                  f" at {what}: {err} of the max |g| > {FLASH_BWD_RTOL}")
        check(all(torch.equal(a, b) for a, b in zip(entry, (dq, dk, dv))),
              f"flash_attention's gradients != the kernels' bits at {what}")
        worst["flash_attention_bwd_dq"] = max(
            worst["flash_attention_bwd_dq"],
            (dq - plain[0]).abs().max().item())
        worst["flash_attention_bwd_dkv"] = max(
            worst["flash_attention_bwd_dkv"],
            (dk - plain[1]).abs().max().item(),
            (dv - plain[2]).abs().max().item())
        del q, k, v, do, o, lse, args, plain, auto, entry, leaves, o_ref
        torch.cuda.empty_cache()
    print(f"phase 11: flash_attention_bwd_dq and flash_attention_bwd_dkv == "
          f"the plain backward and autograd through flash_attention_ref "
          f"(within {FLASH_BWD_RTOL} of each gradient's max |g|; worst "
          f"{worst_rel:.3e}), bitwise from run to run, flash_attention's "
          f"gradients == the kernels' bits, at (B, H, KV, Sq, Sk, hd, causal)"
          f" in {FLASH_BWD_CASES}; max |err| vs plain: dq "
          f"{worst['flash_attention_bwd_dq']:.3e}, dk/dv "
          f"{worst['flash_attention_bwd_dkv']:.3e}")
    return worst


def bwd_kernel_times(dev, ops):
    """dq and dk/dv kernels, their plain versions, the delta op of
    ``flash_attention``'s backward and the backward of
    ``scaled_dot_product_attention`` (timed only: the port never calls it;
    one call gives dq, dk and dv, its own delta included) at each tier's
    layer -> {tier: {name: times and bound}}."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for tier, (B, H, KV, Sq, Sk, hd) in FLASH_TIMED.items():
        q, k, v = flash_inputs(g, dev, B, H, KV, Sq, Sk, hd)
        do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
        o, lse = ops.flash_attention_fwd(q, k, v)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        # the delta op as _FlashAttention.backward runs it
        delta_ms = device_ms(lambda a: (a[0] * a[1]).sum(-1), (do, o))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                enable_gqa=True)
        lib_ms = device_ms(lambda a: torch.autograd.grad(
            o_sdpa, leaves, a, retain_graph=True), do)
        pairs = sum(min(i + 1, Sk) for i in range(Sq))    # causal (i, j)
        product = 2 * B * H * pairs * hd                  # 2 ops a FMA
        qkv_bytes = 4 * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd
                         + 2 * B * H * Sq)     # q, do, k, v, lse, delta
        out[tier] = {}
        for name, fn, plain, n_products, out_bytes in (
                ("flash_attention_bwd_dq", ops.flash_attention_bwd_dq,
                 ops.flash_attention_bwd_dq_ref, 3, 4 * B * H * Sq * hd),
                ("flash_attention_bwd_dkv", ops.flash_attention_bwd_dkv,
                 ops.flash_attention_bwd_dkv_ref, 4,
                 8 * B * KV * Sk * hd)):
            ms = device_ms(lambda a, fn=fn: fn(*a), args)
            plain_ms = device_ms(lambda a, fn=plain: fn(*a), args, reps=5)
            nops, nbytes = n_products * product, qkv_bytes + out_bytes
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = nops / TF32X3_OPS_PER_S * 1e3
            simt_ms = max(b_ms, nops / FP32_OPS_PER_S * 1e3)
            out[tier][name] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "simt_bound_ms": simt_ms,
                "shape": [B, H, KV, Sq, Sk, hd]}
            print(f"{name} at the {tier} tier's layer (B {B}, H {H}, KV {KV}"
                  f", S {Sq}, hd {hd}, causal): device kernel "
                  f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; bound "
                  f"{max(b_ms, o_ms) * 1e3:.2f} us in 3xTF32 "
                  f"({out[tier][name]['bound_by']}: {nops} operations, "
                  f"{n_products} products; {nbytes} bytes; float32 SIMT "
                  f"{simt_ms * 1e3:.2f} us); kernel at "
                  f"{max(b_ms, o_ms) / ms:.3f} of the bound")
        least = 5 * product / TF32X3_OPS_PER_S * 1e3
        both = sum(r["ms"] for r in out[tier].values()) + delta_ms
        for r in out[tier].values():
            # SDPA's backward gives dq, dk and dv in one call, its delta
            # included: it is timed against the pair and the delta op, not
            # against either kernel
            r.update(delta_ms=delta_ms, pair_ms=both, pair_library_ms=lib_ms)
        print(f"flash backward at the {tier} tier's layer: dq + dk/dv + "
              f"delta {both * 1e3:.2f} us (delta {delta_ms * 1e3:.2f} us) "
              f"against the backward's least work (five products, "
              f"{5 * product} operations) {least * 1e3:.2f} us in 3xTF32; "
              f"scaled_dot_product_attention's backward {lib_ms * 1e3:.2f} "
              f"us (dq, dk and dv in one call), the pair at "
              f"{both / lib_ms:.3f}x it")
        del q, k, v, do, o, lse, args, leaves, o_sdpa
        torch.cuda.empty_cache()
    return out


# --- the LM trainer -----------------------------------------------------------

# phase 12: qwen1.5-0.5b at full width and depth, and qwen3-1.7b at full
# width with 4 layers (its GQA, hd-128 backward), B x S tokens a step;
# warm-up steps, then the counted, timed steps
LM_TRAIN = (("qwen1.5-0.5b", None, 8, 1024, 3, 5),
            ("qwen3-1.7b", 4, 4, 1024, 2, 3))
LM_PATH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv", "swd_rank_fwd",
                   "laplacian_energy", "hybrid_reg_bwd")
LM_RTOL = 1e-4           # card vs CPU, of each tensor's max |x|


def lm_train_cfg(steps, S):
    """The launcher's TrainCfg (AdamW, cosine, grad_clip 1.0) with the
    hybrid term on, as ``launch/train.py --hybrid`` makes it."""
    from repro_torch.runtime.trainer import TrainCfg
    return TrainCfg(total_steps=steps, warmup=max(steps // 20, 5),
                    hybrid=True, hybrid_pool=max(S // 16, 8))


def lm_train_run(dev, ops, name, n_layers, B, S, warm, timed):
    """``Trainer`` on the card: ``warm`` steps, then ``timed`` steps with
    the counts set to 0 just before and read just after, then one profiled
    step -> (launches of the counted run, summary)."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import random_batch
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import Trainer
    cfg = get_config(name)
    if n_layers:
        cfg = replace(cfg, n_layers=n_layers)
    L = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, lm_train_cfg(warm + timed, S), lambda step: random_batch(
        torch.Generator(device=dev).manual_seed(100 + step), cfg.vocab, B, S),
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(tr.state["params"])
    tr.run(warm, log_every=0)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    tr.run(timed, log_every=0)
    launches = {n: w.launches for n, w in ops.KERNELS.items()}
    want = {"flash_attention_fwd": 2 * L * timed,
            "flash_attention_bwd_dq": L * timed,
            "flash_attention_bwd_dkv": L * timed, "swd_rank_fwd": timed,
            "laplacian_energy": timed, "hybrid_reg_bwd": timed}
    check(launches == {n: want.get(n, 0) for n in launches},
          f"{name}: launches {launches} in {timed} steps, want {want} (2 "
          f"flash forwards a layer under remat, 1 dq and 1 dk/dv a layer, "
          f"the SW and Laplacian forwards and one backward for both a step) "
          f"and no other")
    hist = tr.history
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{name}: losses {losses} not finite and falling")
    times = [h["time_s"] * 1e3 for h in hist[warm:]]
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    peak = torch.cuda.max_memory_allocated()
    summary = {"name": name, "layers": L, "params": n_params, "B": B, "S": S,
               "step_ms_p50": p50, "step_ms_p95": p95,
               "tokens_per_s": B * S / (p50 / 1e3), "peak_bytes": peak,
               "loss_first": losses[0], "loss_last": losses[-1]}
    print(f"phase 12: Trainer, {name} at full width ({L} layers, "
          f"{n_params:,} parameters; init {init_s:.2f} s), float32, AdamW, "
          f"cosine, hybrid on, remat on; B {B} x S {S}; {warm} warm-up and "
          f"{timed} counted steps: step ms p50 {p50:.3f} (p95 {p95:.3f}), "
          f"{summary['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.3f} GB; loss {losses[0]:.4f} (step 0) -> "
          f"{losses[-1]:.4f} (step {len(losses) - 1}); launches "
          + ", ".join(f"{n} {launches[n]}" for n in LM_PATH_KERNELS))
    summary["profile"] = profile_train_lm_step(tr, p50)
    del tr
    torch.cuda.empty_cache()
    return launches, summary


def profile_train_lm_step(tr, p50):
    """One more step under torch.profiler: device time by kind of kernel
    and the idle share of the p50 -> {kind: ms} or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run(1, log_every=0)
        torch.cuda.synchronize()
    by_kind = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n = e.name.lower()
        kind = ("flash forward" if "flash_fwd" in n else
                "dq" if "flash_bwd_dq" in n else
                "dk/dv" if "flash_bwd_dkv" in n else
                "GEMMs" if "gemm" in n else
                "SWD and Laplacian" if ("swd" in n or "laplacian" in n
                                        or "hybrid_reg" in n) else
                "copies" if "memcpy" in n or "memset" in n else
                "elementwise and other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.time_range.elapsed_us()
    if not by_kind:
        print("profiled step: not measured (torch.profiler recorded no "
              "device activity)")
        return None
    busy = sum(by_kind.values()) / 1e3
    out = {k: v / 1e3 for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])}
    print(f"profiled step: device busy {busy:.3f} ms, idle share of the p50 "
          f"{1.0 - busy / p50:.3f}; " + "; ".join(
              f"{k} {v:.3f} ms ({v / busy:.3f})" for k, v in out.items()))
    return {"busy_ms": busy, "idle_share": 1.0 - busy / p50, **out}


def lm_card_vs_cpu(dev, ops):
    """qwen1.5-0.5b at full width with 2 layers, (2, 256): step 0's loss
    and gradients (hybrid on, the same draws) on the card against the
    port on the CPU; then packed positions, which must take the plain path
    on the card and match the CPU -> {what: max relative error}."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.core.swd import draw, seeded_generator
    from repro_torch.data.tokens import random_batch
    from repro_torch.models import lm
    from repro_torch.optim.sgd import value_and_grad
    from repro_torch.runtime.trainer import make_loss_fn
    from repro_torch.weights import to_device
    two = replace(get_config("qwen1.5-0.5b"), n_layers=2)
    B, S = 2, 256
    tcfg = lm_train_cfg(1, S)
    p_cpu = lm.init_lm(two, torch.Generator().manual_seed(3))
    p_dev = to_device(p_cpu, dev)
    batch = random_batch(torch.Generator().manual_seed(4), two.vocab, B, S)
    dirs, prior = draw(seeded_generator(0, 0), 50,
                       B * (S // tcfg.hybrid_pool), two.d_model)
    loss_fn = make_loss_fn(two, tcfg)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    (l_dev, m_dev), g_dev = value_and_grad(
        loss_fn, p_dev, {k: v.to(dev) for k, v in batch.items()},
        (dirs.to(dev), prior.to(dev)))
    g_dev = [g.cpu() for g in g_dev]
    check(ops.KERNELS["flash_attention_bwd_dq"].launches == 2
          and ops.KERNELS["flash_attention_fwd"].launches == 4,
          "the 2-layer step did not run the flash kernels")
    (l_cpu, m_cpu), g_cpu = value_and_grad(loss_fn, p_cpu, batch,
                                           (dirs, prior))
    from repro_torch.checkpoint.serial import _paths
    names = [k for k, _ in _paths(p_cpu)]
    errs = {"loss": abs(l_dev.item() - l_cpu.item()) / abs(l_cpu.item())}
    for k in ("ce", "swd", "lap"):
        errs[k] = abs(m_dev[k].item() - m_cpu[k].item()) / abs(m_cpu[k].item())
    leaf = {n: rel_err(a, b) for n, a, b in zip(names, g_dev, g_cpu)}
    errs["gradients"] = max(leaf.values())
    # the k bias's gradient is a cancellation over the dk rows (the bias
    # enters before RoPE as q_i . R_(j-i) b_k): the leaf most exposed to
    # the dk kernel's summation order, reported on its own
    errs["k bias gradient"] = max(v for n, v in leaf.items()
                                  if n.endswith("attn/wk/b"))
    # packed positions: two sequences a row, the second restarting at 0
    row = torch.cat([torch.arange(100), torch.arange(S - 100)]).int()
    pos = row.expand(B, S)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    with torch.no_grad():
        h_dev, _ = lm.forward(two, p_dev, tokens=batch["tokens"].to(dev),
                              positions=pos.to(dev))
        packed_launches = ops.KERNELS["flash_attention_fwd"].launches
        h_cpu, _ = lm.forward(two, p_cpu, tokens=batch["tokens"],
                              positions=pos)
    check(packed_launches == 0, f"packed positions launched the flash "
          f"kernel {packed_launches} times: its mask is by index")
    errs["packed positions hidden"] = rel_err(h_dev.cpu(), h_cpu)
    print("phase 12: 2-layer qwen1.5-0.5b at full width, (2, 256), card "
          "(flash kernels) vs the port on the CPU, relative to each tensor's "
          "max |x|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; packed positions took the plain path on the card "
          f"({packed_launches} flash launches)")
    for k, v in errs.items():
        check(v <= LM_RTOL, f"card vs CPU {k}: {v} > {LM_RTOL}")
    return errs


def phase12(dev, ops):
    """The LM training slice on the card -> (launches of qwen1.5-0.5b's
    counted run, the two runs' summaries, the card-vs-CPU errors)."""
    errs = lm_card_vs_cpu(dev, ops)
    runs = [lm_train_run(dev, ops, *spec) for spec in LM_TRAIN]
    return runs[0][0], [s for _, s in runs], errs

# phase 13: the control plane
PPO_RTOL = 1e-4          # card vs CPU params after an iteration, of each max
PPO_MARGIN = 1e-5        # a step whose top two Gumbel scores lie closer is a
                         # near-tie: ~1e-7 of a param may flip its action
CONTROL_FRAMES = 300     # frames the edge loop serves a policy
CONTROL_CPU_FRAMES = 32  # of them compared card vs CPU at CPU_ATOL
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel")


def ppo_profile_counts(prof):
    """A profiled ``train_ppo`` iteration on the card -> its device copies
    and kernels (their device time, the longest), and the CUDA runtime's
    copy, sync and launch calls inside its update loop and inside its
    copy of the params to the host.  Fails where the profiler recorded no
    runtime call in the update loop: the counts would prove nothing."""
    from torch.autograd import DeviceType
    events = prof.events()
    # the ranges also show on the device's timeline, as annotations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("train_ppo.")]

    def calls(range_name):
        rng = [e for e in events if e.name == range_name
               and e.device_type == DeviceType.CPU]
        check(len(rng) == 1, f"{len(rng)} {range_name} ranges")
        lo, hi = rng[0].time_range.start, rng[0].time_range.end
        inside = [e.name for e in events if e.device_type == DeviceType.CPU
                  and lo <= e.time_range.start and e.time_range.end <= hi]
        return {"copies": sum(n == "cudaMemcpyAsync" for n in inside),
                "syncs": sum(n in SYNC_CALLS for n in inside),
                "launches": sum(n in LAUNCH_CALLS for n in inside)}

    upd, back = calls("train_ppo.update"), calls("train_ppo.params_to_host")
    check(upd["launches"] > 0 and back["copies"] > 0,
          f"the profile recorded no CUDA runtime call in the update loop "
          f"({upd}) or the params' return ({back})")
    kernels = [e for e in dev if "Memcpy" not in e.name]
    longest = max(kernels, key=lambda e: e.time_range.elapsed_us(),
                  default=None)
    return {
        "h2d": sorted(e.name for e in dev if "HtoD" in e.name),
        "d2h": sorted(e.name for e in dev if "DtoH" in e.name),
        "d2d": sum("DtoD" in e.name for e in dev),
        "kernels": len(kernels),
        "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        "longest": longest and [longest.name[:60],
                                longest.time_range.elapsed_us()],
        "update_copies": upd["copies"], "update_syncs": upd["syncs"],
        "update_launches": upd["launches"],
        "to_host_copies": back["copies"]}


def ppo_second_rollout(card, cpu, card_params, draws):
    """Iteration 1 of a two-iteration ``train_ppo`` card vs CPU: each
    side's rollout acted on its host copy of the params its own updates
    gave (``card_params``: the card's after iteration 0).  Steps are
    compared up to the first near-tie (top two Gumbel scores within
    ``PPO_MARGIN`` under the card's params), after which the trajectories
    may rightly part -> steps compared."""
    from repro_torch.core import ppo
    T = len(card["act"])
    with torch.inference_mode():
        logits, _ = ppo.policy_apply(card_params,
                                     torch.from_numpy(card["obs"]))
    top2 = (logits + draws[T:2 * T]).topk(2, dim=1).values
    margin = (top2[:, 0] - top2[:, 1]).numpy()
    near = np.flatnonzero(margin <= PPO_MARGIN)
    n = int(near[0]) if len(near) else T
    for k in ("obs", "act", "rewards", "dones"):
        check(np.array_equal(card[k][:n], cpu[k][:n]),
              f"PPO iteration 1 rollout {k}: card != CPU in its first {n} "
              "steps (before any near-tie)")
    for k in ("logp", "values"):
        err = rel_err(card[k][:n], cpu[k][:n]) if n else 0.0
        check(err <= PPO_RTOL, f"PPO iteration 1 rollout {k}: card vs CPU "
              f"rel err {err} in its first {n} steps")
    return n, float(margin.min())


def ppo_card_vs_cpu(enc_cfg):
    """(a) ``train_ppo`` at ``PPOCfg()`` on the pi4 factory of
    ``get_policy``, on the card (the update loop under
    ``set_sync_debug_mode("error")``) and on the CPU, from the same params
    and Gumbel draws: one iteration, and two, so that the second rollout
    is driven by the params each device's updates gave; then the card's
    one iteration again under the profiler -> the profile's counts."""
    from dataclasses import replace
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ppo
    from repro_torch.runtime import control_plane as cp
    cfg = ppo.PPOCfg(iters=2)
    one = replace(cfg, iters=1)
    n_act = enc_cfg.n_blocks + 1
    params = ppo.init_policy(torch.Generator().manual_seed(0), 3, n_act)
    g = torch.Generator().manual_seed(1)
    draws = ppo.gumbel_noise(g, (cfg.iters * cfg.steps_per_iter, n_act))
    epochs = ppo.ppo_epochs

    def no_sync_epochs(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return epochs(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def run(device, c):
        infos = []
        params_out, hist = ppo.train_ppo(
            cp.policy_factory("pi4"), n_act, c, device=device,
            params=params, noise=draws.__getitem__,
            on_iter=lambda it, i: infos.append(i))
        return params_out, hist, infos

    ppo.ppo_epochs = no_sync_epochs
    try:
        pc, hc, ic = run("cuda", one)
        pc2, hc2, ic2 = run("cuda", cfg)
    except RuntimeError as e:
        fail(f"train_ppo on the card: {e}")
    finally:
        ppo.ppo_epochs = epochs
    pp, hp, ip = run("cpu", one)
    pp2, hp2, ip2 = run("cpu", cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pr, hr, ir = run("cuda", one)
    rollout = ("obs", "act", "logp", "values", "rewards", "dones", "adv",
               "ret")
    for k in rollout:
        for what, other in (("CPU", ip), ("card run to run", ir),
                            ("card, two iterations", ic2),
                            ("CPU, two iterations", ip2)):
            check(np.array_equal(ic[0][k], other[0][k]),
                  f"PPO rollout {k}: card != {what}")
    check(hc == hp == hr == hc2[:1] == hp2[:1],
          f"PPO history card {hc} != CPU {hp} or {hr}, {hc2}, {hp2}")
    errs = {k: rel_err(pc[k], pp[k]) for k in pp}
    check(max(errs.values()) <= PPO_RTOL,
          f"PPO params after one iteration card vs CPU {errs}")
    check(all(torch.equal(pc[k], pr[k]) for k in pc),
          "PPO params after one iteration: card run to run")
    check(all(v.device.type == "cpu" for v in pc.values()), "params device")
    T = cfg.steps_per_iter
    n, least = ppo_second_rollout(ic2[1], ip2[1], pc, draws)
    errs2 = {k: rel_err(pc2[k], pp2[k]) for k in pp2}
    if n == T:
        check(hc2[1] == hp2[1], f"PPO history, iteration 1: card {hc2} != "
              f"CPU {hp2}")
        check(max(errs2.values()) <= PPO_RTOL,
              f"PPO params after two iterations card vs CPU {errs2}")
    counts = ppo_profile_counts(prof)
    check(sum("Pinned" in c for c in counts["h2d"]) == 1
          and len(counts["d2h"]) == 1,
          f"profiled iteration's device copies {counts}: want one H2D of "
          "the pinned buffer and one D2H of the params")
    check(counts["update_syncs"] == 0
          and counts["update_copies"] == 1 + counts["d2d"]
          and counts["to_host_copies"] == 1,
          f"profiled iteration's runtime calls {counts}: want in the "
          "update loop no sync and one copy besides the device-to-device "
          "ones, in the params' return one copy")
    print(f"phase 13 (a): one train_ppo iteration at PPOCfg() (2,048 steps, "
          f"{cfg.epochs} x {cfg.steps_per_iter // cfg.minibatch} updates of "
          f"{cfg.minibatch}) on the pi4 profiles, card vs CPU from the same "
          f"params and draws: rollouts (obs, actions, log-probs, values, "
          f"rewards, dones, advantages) bitwise "
          f"({len(set(ic[0]['act'].tolist()))} distinct actions), mean "
          f"episode reward {hc[0]:.6f} both, params rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (<= {PPO_RTOL}); the card's iteration again: bitwise")
    print(f"phase 13 (a): two iterations card vs CPU: iteration 1's rollout "
          f"acted on each device's updated params: {n} of {T} steps "
          f"compared (least top-two Gumbel gap {least:.3e}, near-tie guard "
          f"{PPO_MARGIN}): obs, actions, rewards, dones bitwise, log-probs "
          f"and values within {PPO_RTOL} of their max; "
          + (f"mean episode reward {hc2[1]:.6f} both, params after 64 "
             f"updates rel err " + ", ".join(
                 f"{k} {v:.3e}" for k, v in errs2.items())
             if n == T else "a near-tie: the rest, the history and the "
             "params not compared"))
    cpu_ms = [i["update_ms"] for i in ip + ip2]
    print(f"profiled card iteration: device copies {counts['h2d']} "
          f"(the buffer pinned; the set-up's initial params pageable, where "
          f"recorded), {counts['d2h']}, {counts['d2d']} device-to-device; "
          f"runtime calls in the update loop: {counts['update_copies']} "
          f"copies ({counts['d2d']} of them device to device), "
          f"{counts['update_syncs']} syncs, "
          f"{counts['update_launches']} kernel launches; in the params' "
          f"return {counts['to_host_copies']} copy; "
          f"set_sync_debug_mode('error') over the update loop "
          f"raised nothing; {counts['kernels']} kernels, their device time "
          f"{counts['kernel_ms']:.3f} ms (longest {counts['longest']}); "
          f"update {ir[0]['update_ms']:.3f} ms profiled, "
          + ", ".join(f"{i['update_ms']:.3f}" for i in ic + ic2)
          + " unprofiled (CUDA events), the CPU's "
          + ", ".join(f"{x:.3f}" for x in cpu_ms)
          + f" (host clock); rollout {ic[0]['rollout_ms']:.1f} ms (host)")
    counts["cpu_update_ms"] = cpu_ms
    counts["second_rollout_steps_compared"] = n
    return counts


def train_policies():
    """(b) ``get_policy(platform, force=True)`` at ``PPOCfg()`` on the
    card for pi4 and m2 -> ({platform: params}, {platform: per-iteration
    record})."""
    from repro_torch.runtime import control_plane as cp
    policies, record = {}, {}
    for plat in ("pi4", "m2"):
        its = []
        start = time.perf_counter()
        policies[plat] = cp.get_policy(plat, force=True, device="cuda",
                                       on_iter=lambda it, i: its.append(i))
        total = time.perf_counter() - start
        hist = [i["mean_reward"] for i in its]
        check(len(hist) == 40 and np.isfinite(hist).all(),
              f"{plat} history not finite: {hist}")
        check(os.path.exists(cp.policy_path(plat)), f"{plat} not cached")
        roll = np.array([i["rollout_ms"] for i in its])
        upd = np.array([i["update_ms"] for i in its])
        record[plat] = {"history": hist, "rollout_ms": roll.tolist(),
                        "update_ms": upd.tolist(), "total_s": total}
        print(f"phase 13 (b): get_policy({plat!r}, force=True) on the card: "
              f"40 iterations in {total:.2f} s; mean episode reward "
              f"{hist[0]:.3f} -> {hist[-1]:.3f} (final); rollout p50 "
              f"{np.percentile(roll, 50):.3f} ms (host), update p50 "
              f"{np.percentile(upd, 50):.3f} ms (CUDA events)")
        print(f"{plat} rollout ms per iteration: "
              + " ".join(f"{x:.3f}" for x in roll))
        print(f"{plat} update ms per iteration: "
              + " ".join(f"{x:.3f}" for x in upd))
    return policies, record


def hold_wire_at(cfg, ops):
    """``wire_roundtrip_grouped`` against its plain version on the card,
    bitwise, at every width that ``cfg`` puts on the wire: a (1, n) group
    as a tick of one frame gives it, the special rows at (5, n), and every
    width at B = 1 in one launch -> max |err|."""
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    widths = wire_widths(cfg)

    def rand(B, n):
        return torch.randn(B, n, device=dev, generator=g) * 3.0 + 1.0
    cases = ([(f"(1, {n})", [rand(1, n)]) for n in widths]
             + [(f"(5, {n}), special rows", [special_rows(rand(5, n))])
                for n in widths]
             + [("every width at B = 1", [rand(1, n) for n in widths])])
    worst = 0.0
    for what, xs in cases:
        got = ops.wire_roundtrip_grouped(xs)
        want = ops.wire_roundtrip_grouped_ref(xs)
        torch.cuda.synchronize()
        for i, (a, w) in enumerate(zip(got, want)):
            err = (a - w).nan_to_num().abs().max().item()
            worst = max(worst, err)
            check(same_values(a, w), f"wire_roundtrip_grouped != plain "
                  f"version at {what}, group {i} (max |err| {err})")
    print(f"phase 13 (d): wire_roundtrip_grouped bitwise == plain version "
          f"at the served widths {widths}: B = 1, the special rows at B = "
          f"5, all in one launch (max |err| {worst})")
    return worst


def edge_loop_on_card(enc_cfg, ops, enc_params, rl):
    """(d) ``serve_stream`` on the ``variable`` network with phase 6's
    trained encoder under ``"rl"`` (the trained pi4 policy) and
    ``"server"``, counted per tick, and each again on the CPU -> (the
    kernels' launch counts of the two card runs, summary)."""
    from dataclasses import replace
    from repro_torch.data.audio_stream import AudioStream, StreamCfg
    from repro_torch.runtime.edge_loop import part3_line, serve_stream
    mels, ys, _ = AudioStream(StreamCfg(seed=1)).batch(CONTROL_FRAMES)
    # the stream gives 98 frames a second: AudioEncCfg() at that length
    # (its widths and phase 6's weights; the gateway takes cfg.frames)
    cfg = replace(enc_cfg, frames=min(enc_cfg.frames, mels.shape[1]))
    mels = np.asarray(mels[:, :cfg.frames], np.float32)
    L = cfg.n_blocks
    wire_err = hold_wire_at(cfg, ops)

    def run(kind, device, counted):
        ticks, prev = [], {n: w.launches for n, w in ops.KERNELS.items()}

        def on_tick(t, r, gw):
            if counted:
                now = {n: w.launches for n, w in ops.KERNELS.items()}
                st = gw.stats()
                ticks.append((r, {n: now[n] - prev[n] for n in now},
                              st.device_syncs_per_tick,
                              st.d2h_copies_per_tick, st.last_tick_ms))
                prev.update(now)
            else:
                ticks.append((r,))
        out = serve_stream(kind, enc_params, mels, ys, net="variable",
                           device=device, rl_params=rl, enc_cfg=cfg,
                           on_tick=on_tick)
        return out, ticks

    kinds = ("rl", "server")
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    card = {kind: run(kind, "cuda", True) for kind in kinds}
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()
    cpu = {kind: run(kind, "cpu", False) for kind in kinds}

    summary = {}
    for kind, ((s, st, info, drops), ticks) in card.items():
        check(len(ticks) == CONTROL_FRAMES, f"{kind}: {len(ticks)} ticks")
        for t, (r, delta, syncs, d2h, _) in enumerate(ticks):
            want = {n: 0 for n in delta}
            want["wire_roundtrip_grouped"] = int(r.k < L)
            check(delta == want, f"{kind} tick {t} (k={r.k}): launches "
                  f"{ {n: c for n, c in delta.items() if c} }")
            check(syncs == 1 and d2h == 1, f"{kind} tick {t}: {syncs} "
                  f"syncs, {d2h} D2H (want 1 and 1)")
        z = np.stack([tk[0].z for tk in ticks])
        check(z.shape == (CONTROL_FRAMES, cfg.d_embed)
              and np.isfinite(z).all(), f"{kind}: embeddings {z.shape}")
        norm_err = float(np.abs(np.linalg.norm(z, axis=1) - 1).max())
        check(norm_err <= 1e-5, f"{kind}: | ||z|| - 1 | = {norm_err}")
        (cs, _, _, cdrops), cpu_ticks = cpu[kind]
        check([tk[0].k for tk in ticks] == [tk[0].k for tk in cpu_ticks],
              f"{kind} k sequence: card != CPU")
        check(cs == s and cdrops == drops, f"{kind} env summary: card != "
              "CPU")
        cpu_err = float(max(np.abs(a[0].z - b[0].z).max() for a, b in zip(
            ticks[:CONTROL_CPU_FRAMES], cpu_ticks[:CONTROL_CPU_FRAMES])))
        check(cpu_err <= CPU_ATOL, f"{kind} edge loop card vs CPU max |dz| "
              f"{cpu_err}")
        tick_ms = np.array([tk[4] for tk in ticks])
        ks = [tk[0].k for tk in ticks]
        summary[kind] = {
            "env": s, "drops": drops, "frames": st.frames,
            "wire_bytes": st.wire_bytes, "transitions": info.transitions,
            "k_hist": np.bincount(ks, minlength=L + 1).tolist(),
            "tick_ms_p50": float(np.percentile(tick_ms, 50)),
            "tick_ms_p95": float(np.percentile(tick_ms, 95)),
            "cpu_max_abs_dz": cpu_err}
        print(f"phase 13 (d) {kind}: {CONTROL_FRAMES} ticks of one frame "
              f"(AudioEncCfg() widths at the stream's {cfg.frames} frames, "
              f"phase 6's weights), every tick 1 sync + 1 D2H and "
              f"wire_roundtrip_grouped launched iff k < {L} "
              f"({sum(k < L for k in ks)} ticks), no other kernel; k "
              f"histogram {summary[kind]['k_hist']}, {info.transitions} "
              f"transitions; tick ms p50 {summary[kind]['tick_ms_p50']:.3f} "
              f"p95 {summary[kind]['tick_ms_p95']:.3f} (host clock); k "
              f"sequence and env summary card == CPU, first "
              f"{CONTROL_CPU_FRAMES} frames card vs CPU max |dz| "
              f"{cpu_err:.3e} (atol {CPU_ATOL})")
        print(f"      simulated Pi 4 costs: {s['lat_ms']*8:.1f} ms/batch, "
              f"{s['kb_per_batch']:.1f} KB/batch, {s['energy_mj']:.1f} "
              f"mJ/frame, drops {drops / max(st.frames, 1):.2%}; gateway: "
              f"{st.frames} frames, routed={st.routed}, split-link "
              f"{st.wire_bytes / 1024:.0f} KB")
    line = part3_line(summary["rl"]["env"], summary["server"]["env"])
    summary["part3"] = line
    summary["wire_max_abs_err"] = wire_err
    print(f"edge loop part 3 (rl vs server-only, simulated): {line}")
    return launches, summary


def phase13(cfg, ops, enc_params):
    """The control plane on the card -> (launch counts of the edge loop's
    card runs, summary)."""
    from repro_torch.runtime import system_tables
    marks = [time.perf_counter()]
    counts = ppo_card_vs_cpu(cfg)
    marks.append(time.perf_counter())
    policies, record = train_policies()
    marks.append(time.perf_counter())
    upd_p50 = float(np.percentile(record["pi4"]["update_ms"], 50))
    counts["busy_share"] = counts["kernel_ms"] / upd_p50
    print(f"the card's busy share during the updates: the profiled "
          f"iteration's kernels, {counts['kernel_ms']:.3f} ms, over pi4's "
          f"unprofiled update p50, {upd_p50:.3f} ms: "
          f"{counts['busy_share']:.3f}")
    rows = system_tables.run_all()
    check(len(rows) == 57 and all(np.isfinite(v) for _, v, _ in rows),
          f"system tables: {len(rows)} rows, non-finite "
          f"{[r for r in rows if not np.isfinite(r[1])]}")
    print("phase 13 (c): the paper's system tables under the two policies "
          "(outputs of the calibrated Pi 4 / M2 simulator, core/env.py; "
          "not card times): name,value,derived")
    for name, value, derived in rows:
        print(f"  {name},{value:.4f},{derived}")
    marks.append(time.perf_counter())
    launches, summary = edge_loop_on_card(cfg, ops, enc_params,
                                          policies["pi4"])
    marks.append(time.perf_counter())
    parts = dict(zip("abcd", np.diff(marks).tolist()))
    print(f"phase 13: {marks[-1] - marks[0]:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in parts.items()) + ")")
    summary.update(ppo=record, ppo_profile=counts, phase_s=parts,
                   tables={name: value for name, value, _ in rows})
    return launches, summary


# --- prefill and decode ------------------------------------------------------

# phase 14's runs: (config, layers kept (None: all), experts kept (None:
# all), B, prompt, decode steps); the decode state holds the prompt plus
# PD_SLACK positions
PD_RUNS = (("qwen1.5-0.5b", None, None, 8, 1024, 32),
           ("qwen3-1.7b", None, None, 4, 1024, 32),
           ("gemma2-2b", None, None, 4, 1024, 32),
           ("mamba2-780m", None, None, 8, 1024, 32),
           ("zamba2-1.2b", None, None, 8, 1024, 32),
           ("arctic-480b", 2, 8, 2, 256, 8))
PD_SLACK = 64
# flash_attention_fwd launches in a prefill: one for each attention layer
# that uses_kernel admits (gemma2's soft-cap keeps the plain path, mamba2
# has no attention, zamba2's shared block runs 38 // 6 = 6 times)
PD_FLASH = {"qwen1.5-0.5b": 24, "qwen3-1.7b": 28, "gemma2-2b": 0,
            "mamba2-780m": 0, "zamba2-1.2b": 6, "arctic-480b": 2}
PD_PREFILL_RTOL = 1e-5   # prefill vs forward at the prompt's last position
PD_PREFILLS = 3          # timed prefills (the median is reported)
# decode vs teacher-forced forward (the families without mamba layers);
# card vs CPU
PD_RTOL = 1e-4
# the families with mamba layers (see pd_float64), set from the readings
# at these seeds (mamba2-780m 5.627e-3, 1.377e-3 and 2.501e-11; zamba2-1.2b
# 5.411e-4, 7.801e-4 and 3.508e-12): decode vs teacher-forced forward in
# float32, the float32 decode vs the float64 run, decode vs forward in
# float64
PD_SSM_RTOL, PD_SSM_TRUTH_RTOL, PD_F64_RTOL = 1.5e-2, 4e-3, 1e-8
PD_CPU = (2, 64, 4)      # card vs CPU at the 2-layer cut: B, prompt, steps


def pd_config(name, layers, experts):
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    cfg = get_config(name)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    if experts:
        cfg = replace(cfg, moe=replace(cfg.moe, n_experts=experts))
    return cfg


def pd_rel(a, b):
    """max |a - b| over max |b|."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def pd_cache_bytes(st):
    """The smallest one-layer slice of the state's caches (a layer's k, or
    a layer's SSM state): the bound on a decode step's memory growth."""
    return min(st[k][0].numel() * st[k].element_size()
               for k in ("k", "ssm") if k in st)


def pd_step_bytes(cfg, params, st):
    """What a decode step must move at least: every weight it reads (all
    experts: ``moe_reference`` runs them all; not an untied embedding
    table, of which it gathers B rows), the whole ``max_len`` KV cache
    read, the SSM and conv states read and written."""
    from repro_torch.models import lm
    w = lm.param_count(params)
    if not cfg.tie_embeddings:
        w -= params["embed"]["table"].numel()
    kv = sum(st[k].numel() for k in ("k", "v") if k in st)
    ssm = 2 * sum(st[k].numel() for k in ("ssm", "conv") if k in st)
    return 4 * (w + kv + ssm)


def profile_decode_step(cfg, params, st, tok, step_ms):
    """One more decode step under torch.profiler -> its CUDA runtime copy,
    sync and launch calls, its device copies, its kernels' device time and
    the idle share of the unprofiled step's p50.  Fails where the profile
    recorded no launch: the counts would prove nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import lm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("decode_step"):
            lm.decode_step(cfg, params, st, tok)
        torch.cuda.synchronize()
    events = prof.events()
    rng = [e for e in events if e.name == "decode_step"
           and e.device_type == DeviceType.CPU]
    check(len(rng) == 1, f"{len(rng)} decode_step ranges")
    lo, hi = rng[0].time_range.start, rng[0].time_range.end
    inside = [e.name for e in events if e.device_type == DeviceType.CPU
              and lo <= e.time_range.start and e.time_range.end <= hi]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "decode_step"]
    kernels = [e for e in dev if "Memcpy" not in e.name
               and "Memset" not in e.name]
    out = {"launches": sum(n in LAUNCH_CALLS for n in inside),
           "syncs": sum(n in SYNC_CALLS for n in inside),
           "copy_calls": sum(n.startswith("cudaMemcpy") for n in inside),
           "h2d": sum("HtoD" in e.name for e in dev),
           "d2h": sum("DtoH" in e.name for e in dev),
           "d2d": sum("DtoD" in e.name for e in dev),
           "kernels": len(kernels),
           "busy_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3}
    check(out["launches"] > 0, f"the profile recorded no launch in the "
          f"decode step: {out}")
    out["idle_share"] = 1.0 - out["busy_ms"] / step_ms
    return out


@contextlib.contextmanager
def record_flash(calls):
    """A context in which every call of the attention layers' flash
    kernel appends its arguments (q, k, v, causal, scale) to ``calls``."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.flash_attention

    def recorded(q, k, v, causal=True, scale=None):
        calls.append((q, k, v, causal, scale))
        return real(q, k, v, causal, scale)
    fa.flash_attention = recorded
    try:
        yield
    finally:
        fa.flash_attention = real


def hold_prefill_flash(ops, calls, name):
    """``flash_attention_fwd`` against its plain version at every recorded
    call's inputs (phase 9's tolerances, bitwise run to run) -> (calls
    held, the largest |err| of o and lse)."""
    check(len(calls) == PD_FLASH[name], f"{name}: {len(calls)} flash calls "
          f"recorded in a prefill, want {PD_FLASH[name]}")
    worst = 0.0
    for i, (q, k, v, causal, scale) in enumerate(calls):
        worst = max(worst, hold(
            "flash_attention_fwd",
            lambda q, k, v: ops.flash_attention_fwd(
                q, k, v, causal=causal, scale=scale),
            lambda q, k, v: ops.flash_attention_ref(
                q, k, v, causal, scale),
            (q, k, v), [(0.0, FLASH_O_ATOL), (0.0, FLASH_LSE_ATOL)],
            f"{name} prefill layer {i}: q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}"))
    return len(calls), worst


def pd_main_path(dev, ops, cfg, params, B, S, steps, seed):
    """A warm-up prefill of a random prompt of S tokens and one step (the
    kernel held against its plain version at the inputs the prefill gave
    it), PD_PREFILLS timed prefills, then ``steps`` greedy decode steps
    after the last, the counts set to 0 just before and read after each
    prefill and after the steps ->
    (record, launches of the prefill, launches of the decode steps,
    prompt, fed tokens, prefill logits, decode logits (steps, B, V))."""
    from repro_torch.models import lm
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    max_len = S + PD_SLACK
    # warm-up at the served shapes: the whole prompt and one step; the
    # kernel's inputs in its prefill are held against the plain version
    calls = []
    with record_flash(calls):
        st, logits = lm.prefill(cfg, params, tokens=toks, max_len=max_len)
    lm.decode_step(cfg, params, st, logits.argmax(-1))
    del st, logits
    flash_err = hold_prefill_flash(ops, calls, cfg.name)
    del calls
    prefill_ms, st, first = [], None, None
    for _ in range(PD_PREFILLS):
        st = first = None
        for wrapper in ops.KERNELS.values():
            wrapper.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        st, first = lm.prefill(cfg, params, tokens=toks, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - start) * 1e3)
        pre = {n: w.launches for n, w in ops.KERNELS.items()}
        check(pre["flash_attention_fwd"] == PD_FLASH[cfg.name]
              and sum(pre.values()) == pre["flash_attention_fwd"],
              f"{cfg.name} prefill launched {pre}, want flash_attention_fwd "
              f"{PD_FLASH[cfg.name]} and no other kernel")
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    out = torch.empty((steps, B, cfg.vocab), device=dev)
    fed = torch.empty((B, steps), dtype=toks.dtype, device=dev)
    logits = first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_ms = []
    for t in range(steps):
        fed[:, t] = logits.argmax(-1)
        torch.cuda.synchronize()
        start = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, st2 = lm.decode_step(cfg, params, st, fed[:, t])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
        check(st2 is st and {k: v.data_ptr() for k, v in st.items()} == ptrs,
              f"{cfg.name} decode step {t}: the state was not updated in "
              "place")
        out[t].copy_(logits)
    growth = torch.cuda.max_memory_allocated() - base
    dec = {n: w.launches - pre[n] for n, w in ops.KERNELS.items()}
    index = int(st["index"])
    check(index == S + steps, f"{cfg.name}: index {index} after the steps, "
          f"want {S + steps}")
    check(not any(dec.values()), f"{cfg.name} decode steps launched {dec}")
    bound = pd_cache_bytes(st)
    check(growth < bound, f"{cfg.name}: max_memory_allocated grew by "
          f"{growth} B over {steps} decode steps, not less than one "
          f"layer's cache ({bound} B)")
    p50 = float(np.percentile(step_ms, 50))
    prof = profile_decode_step(cfg, params, st, fed[:, -1], p50)
    check(prof["syncs"] == 0 and prof["h2d"] == 0 and prof["d2h"] == 0,
          f"{cfg.name}: the profiled decode step synced or copied to or "
          f"from the host: {prof}")
    nbytes = pd_step_bytes(cfg, params, st)
    prefill_p50 = float(np.percentile(prefill_ms, 50))
    rec = {"name": cfg.name, "n_layers": cfg.n_layers, "B": B, "prompt": S,
           "steps": steps, "max_len": max_len, "prefill_ms": prefill_p50,
           "prefill_ms_each": prefill_ms,
           "prefill_tokens_per_s": B * S / prefill_p50 * 1e3,
           "decode_p50_ms": p50,
           "decode_p95_ms": float(np.percentile(step_ms, 95)),
           "decode_tokens_per_s": B / p50 * 1e3, "step_bytes": nbytes,
           "step_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "mem_growth_bytes": growth, "mem_bound_bytes": bound,
           "flash_launches": pre["flash_attention_fwd"],
           "flash_calls_held": flash_err[0], "flash_err": flash_err[1],
           "profile": prof}
    del st
    return rec, pre, dec, toks, fed, first, out


@contextlib.contextmanager
def float64_port():
    """The port's explicit float32 casts made float64, so that a float64
    configuration computes every operation in double precision."""
    real = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = real


def pd_float64(cfg, params, toks, fed, dec32, tf32):
    """The main path's prefill and decode steps (fed the same tokens) and
    the teacher-forced forward again, the port run in float64 on the same
    weights -> decode vs forward in float64, and the float32 decode's and
    forward's distances from that truth.  A mamba layer amplifies the
    rounding of its input, so in float32 the two paths part by more than
    phase 10's 1e-4 at 48 layers (``tools/decode_bar.py --full``); in
    float64 they agree to ~1e-11."""
    from dataclasses import replace

    from repro_torch.models import lm
    S, steps = toks.shape[1], fed.shape[1]
    c64 = replace(cfg, dtype="float64", param_dtype="float64")
    p64 = map_tree(params, torch.Tensor.double)
    with float64_port():
        st, logits = lm.prefill(c64, p64, tokens=toks, max_len=S + steps)
        dec = torch.empty((steps,) + tuple(logits.shape), dtype=torch.float64,
                          device=logits.device)
        for t in range(steps):
            logits, st = lm.decode_step(c64, p64, st, fed[:, t])
            dec[t] = logits
        del st
        h, _ = lm.forward(c64, p64, tokens=torch.cat([toks, fed], 1))
        tf = lm.logits_from_hidden(c64, p64, h[:, S - 1:S + steps])
        del h, p64
    return {"decode_vs_forward": max(pd_rel(dec[t], tf[:, t + 1])
                                     for t in range(steps)),
            "decode32_vs_float64": max(pd_rel(dec32[t], dec[t])
                                       for t in range(steps)),
            "forward32_vs_float64": pd_rel(tf32, tf)}


def map_tree(tree, fn):
    """``fn`` applied to every leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def pd_card_vs_cpu(dev, cfg, params, seed):
    """The configuration cut to 2 layers (a hybrid: one group and its
    tail) at full width, the same weights on the card and on the CPU: a
    prefill of PD_CPU's prompt and its steps, fed the same tokens ->
    relative errors of the logits and of each state tensor."""
    from dataclasses import replace

    from repro_torch.models import lm
    from repro_torch.weights import to_device
    n = cfg.hybrid_period + 1 if cfg.family == "hybrid" else 2
    cut = replace(cfg, n_layers=n)
    blocks = dict(params["blocks"], layers=map_tree(
        params["blocks"]["layers"], lambda t: t[:n]))
    p_card = dict(params, blocks=blocks)
    p_cpu = to_device(p_card, "cpu")
    B, S, steps = PD_CPU
    toks = torch.randint(0, cut.vocab, (B, S + steps),
                         generator=torch.Generator().manual_seed(seed))
    runs = {}
    for d, p in ((dev, p_card), ("cpu", p_cpu)):
        st, logits = lm.prefill(cut, p, tokens=toks[:, :S].to(d),
                                max_len=S + steps)
        outs = [logits.cpu()]
        for t in range(steps):
            logits, st = lm.decode_step(cut, p, st, toks[:, S + t].to(d))
            outs.append(logits.cpu())
        runs[d] = (torch.stack(outs), {k: v.cpu() for k, v in st.items()})
    (l_card, st_card), (l_cpu, st_cpu) = runs[dev], runs["cpu"]
    check(torch.equal(st_card["index"], st_cpu["index"]),
          f"{cfg.name} cut: index {st_card['index']} != {st_cpu['index']}")
    errs = {"logits": pd_rel(l_card, l_cpu)}
    errs.update({k: pd_rel(st_card[k], st_cpu[k]) for k in st_cpu
                 if k != "index"})
    return n, errs


def phase14(dev, ops):
    """``lm.prefill`` and ``lm.decode_step`` on the card for every LM
    family at full width (and depth, but for the arctic cut) -> (launches
    of the prefill path, of the decode path, the records)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    marks = time.perf_counter()
    paths = {"prefill": {n: 0 for n in ops.KERNELS},
             "decode": {n: 0 for n in ops.KERNELS}}
    records = []
    for i, (name, layers, experts, B, S, steps) in enumerate(PD_RUNS):
        t0 = time.perf_counter()
        cfg = pd_config(name, layers, experts)
        with torch.inference_mode():
            params = lm.init_lm(cfg, torch.Generator(device=dev)
                                .manual_seed(14 + i))
            rec, pre, dec, toks, fed, first, out = pd_main_path(
                dev, ops, cfg, params, B, S, steps, 140 + i)
            for n in ops.KERNELS:
                paths["prefill"][n] += pre[n]
                paths["decode"][n] += dec[n]
            # teacher-forced: one forward over the prompt and the decoded
            # tokens, logits at the compared positions only
            h, _ = lm.forward(cfg, params, tokens=torch.cat([toks, fed], 1))
            tf = lm.logits_from_hidden(cfg, params, h[:, S - 1:S + steps])
            del h
            rec["prefill_err"] = pd_rel(first, tf[:, 0])
            errs = [pd_rel(out[t], tf[:, t + 1]) for t in range(steps)]
            rec["decode_err"] = max(errs)
            rec["decode_err_step"] = int(np.argmax(errs))
            if cfg.ssm is not None:
                rec["float64"] = pd_float64(cfg, params, toks, fed, out, tf)
            del tf, out, first
            n_cut, rec["card_vs_cpu"] = pd_card_vs_cpu(dev, cfg, params,
                                                       240 + i)
        rec["params"] = lm.param_count(params)
        del params
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t0
        records.append(rec)
        prof = rec["profile"]
        full = get_config(name)
        cut = (f" (cut: {layers} of {full.n_layers} layers, {experts} of "
               f"{full.moe.n_experts} experts; every other width as "
               "published)" if layers else "")
        print(f"phase 14 ({'abcdef'[i]}) {name}{cut}: {rec['params']:,} "
              f"parameters, B {B} x prompt {S}, max_len {S + PD_SLACK}, "
              f"{steps} greedy steps; prefill p50 {rec['prefill_ms']:.3f} ms "
              f"of {PD_PREFILLS} ("
              + ", ".join(f"{t:.3f}" for t in rec["prefill_ms_each"])
              + f"; {rec['prefill_tokens_per_s']:.1f} tokens/s, "
              f"flash_attention_fwd {rec['flash_launches']}); decode step "
              f"p50 {rec['decode_p50_ms']:.3f} ms (p95 "
              f"{rec['decode_p95_ms']:.3f}), {rec['decode_tokens_per_s']:.1f}"
              f" tokens/s, bytes bound {rec['step_bound_ms']:.3f} ms "
              f"({rec['step_bytes'] / 1e9:.3f} GB: weights + the whole "
              f"max_len cache); profiled step: {prof['launches']} launches, "
              f"{prof['syncs']} syncs, {prof['h2d']} H2D, {prof['d2h']} "
              f"D2H, {prof['d2d']} device-to-device copies, kernels "
              f"{prof['busy_ms']:.3f} ms, idle share "
              f"{prof['idle_share']:.3f}; memory growth "
              f"{rec['mem_growth_bytes']:,} B (< {rec['mem_bound_bytes']:,})")
        if "float64" in rec:
            f64 = rec["float64"]
            bars = (("decode vs teacher-forced forward", rec["decode_err"],
                     PD_SSM_RTOL),
                    ("the float32 decode vs the float64 run",
                     f64["decode32_vs_float64"], PD_SSM_TRUTH_RTOL),
                    ("decode vs forward in float64",
                     f64["decode_vs_forward"], PD_F64_RTOL))
            more = (f"; the float32 forward {f64['forward32_vs_float64']:.3e}"
                    " from the float64 run")
        else:
            bars = (("decode vs teacher-forced forward", rec["decode_err"],
                     PD_RTOL),)
            more = ""
        print(f"phase 14 ({'abcdef'[i]}) {name} checks: flash_attention_fwd "
              f"== plain version at its {rec['flash_calls_held']} calls' "
              f"inputs in the prefill, max |err| {rec['flash_err']:.3e} (o "
              f"atol {FLASH_O_ATOL}, lse atol {FLASH_LSE_ATOL}); prefill vs "
              f"forward {rec['prefill_err']:.3e} (bar {PD_PREFILL_RTOL}); "
              + "; ".join(f"{what} {got:.3e} (bar {bar})"
                          for what, got, bar in bars)
              + f" (worst decode step {rec['decode_err_step']}){more}; "
              f"{n_cut}-layer cut card vs CPU: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in rec["card_vs_cpu"].items())
              + f" (bar {PD_RTOL}); {rec['seconds']:.1f} s")
        check(rec["prefill_err"] <= PD_PREFILL_RTOL,
              f"{name}: prefill vs forward {rec['prefill_err']}")
        for what, got, bar in bars:
            check(got <= bar, f"{name}: {what} {got} (bar {bar})")
        for k, v in rec["card_vs_cpu"].items():
            check(v <= PD_RTOL, f"{name} cut card vs CPU {k}: {v}")
    print(f"phase 14: {time.perf_counter() - marks:.1f} s")
    return paths["prefill"], paths["decode"], records


# --- the gateway federation at full width ------------------------------------

CLUSTER_SPM = 64           # sessions a member in the drain and chaos lanes
CLUSTER_ROUNDS = 8         # rounds a timed phase of the drain lane
CLUSTER_CPU_SPM = 8        # sessions a member, card against CPU
WIRE_KERNELS = ("wire_roundtrip_grouped", "wire_roundtrip", "int8_quantize",
                "int8_quantize_roundtrip", "int8_dequantize")


def count_member_ticks(ops, records, lane):
    """An ``on_member`` hook: wrap each member gateway's ``tick_launch``
    and ``tick_collect`` so that each collected member tick records
    (lane, member, the wire kernels' launches in its launch, its syncs,
    its D2H copies, the smallest k it served)."""
    def hook(name, srv):
        gw = srv.gateway
        launch, collect = gw.tick_launch, gw.tick_collect
        launched = {}

        def counted_launch(*args, **kw):
            before = [ops.KERNELS[k].launches for k in WIRE_KERNELS]
            plan = launch(*args, **kw)
            launched[id(plan)] = tuple(
                ops.KERNELS[k].launches - b
                for k, b in zip(WIRE_KERNELS, before))
            return plan

        def counted_collect(plan):
            out = collect(plan)
            records.append((
                lane, name, launched.pop(id(plan)),
                gw.registry.value("gateway_device_syncs_per_tick"),
                gw.registry.value("gateway_d2h_copies_per_tick"),
                min(r.k for r in out)))
            return out
        gw.tick_launch, gw.tick_collect = counted_launch, counted_collect
    return hook


def phase15(cfg, ops):
    """The gateway federation on the card: (a) the drain lane at N = 2
    and 4, counted (d); (b) the chaos lane, replication off and on; (c)
    card against CPU; (e) the two demos -> (the kernels' launch counts
    from (a), the phase's record)."""
    from repro_torch.models.audio_encoder import init_audio_encoder
    from repro_torch.runtime import cluster_demo, streaming_demo
    from repro_torch.runtime import cluster_serve as cs
    L = cfg.n_blocks
    start = time.perf_counter()
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))

    # --- (a) the drain lane, counted (d) ----------------------------------
    ticks = []
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    lanes = {n: cs.cluster_drain(
        n, device="cuda", enc_cfg=cfg, params=params, rounds=CLUSTER_ROUNDS,
        spm=CLUSTER_SPM, oracle=False,
        on_member=count_member_ticks(ops, ticks, n)) for n in (2, 4)}
    launches = {name: w.launches for name, w in ops.KERNELS.items()}
    torch.cuda.synchronize()
    bad = [t for t in ticks
           if t[2] != ((1 if t[5] < L else 0),) + (0,) * 4]
    check(not bad, f"phase 15 (d): member ticks whose wire launches "
          f"(grouped, one-group, quantize, round trip, dequantize) are not "
          f"(1 if a frame has k < {L}, else 0; then none): {bad[:3]} of "
          f"{len(ticks)}")
    want = sum(t[5] < L for t in ticks)
    check(launches["wire_roundtrip_grouped"] == want and all(
        launches[k] == 0 for k in WIRE_KERNELS[1:]),
        f"phase 15 (d): launches {launches}, want {want} grouped wire "
        "launches and no other wire kernel")
    check(all(t[3:5] == (1, 1) for t in ticks),
          f"phase 15 (d): syncs/D2H per member tick "
          f"{sorted({t[3:5] for t in ticks})}, want 1 and 1")
    record = {"drain": {}, "ticks": len(ticks),
              "wire_launches": launches["wire_roundtrip_grouped"]}
    for n, lane in lanes.items():
        check(lane["migrations"] == len(lane["homed"]) > 0
              and lane["migrated_frames"] > 0
              and lane["shed_expired"] == 0 and lane["lost_in_flight"] == 0,
              f"phase 15 (a) N={n}: {cs.summary(lane)}")
        lane["parity"] = cs.replay_parity(lane, cfg, params, device="cuda")
        rec = cs.summary(lane)
        record["drain"][n] = rec
        fps, warm, cold = (rec["frames_per_s"], rec["migration_pause_ms"],
                           rec["migration_pause_cold_ms"])
        par = rec["parity"]
        print(f"phase 15 (a): drain lane N={n}, {rec['sessions']} sessions, "
              f"{CLUSTER_ROUNDS} rounds a phase: frames/s before "
              f"{fps['before']:.1f}, during drain {fps['during_drain']:.1f}, "
              f"after {fps['after']:.1f}; a round's host ms p50: build "
              f"{rec['build_ms']['p50']:.3f}, submit "
              f"{rec['submit_ms']['p50']:.3f}, cluster step "
              f"{rec['step_ms']['p50']:.3f} (p95 {rec['step_ms']['p95']:.3f});"
              " "
              f"warm migration pause ms p50 {warm['p50']:.3f} p95 "
              f"{warm['p95']:.3f} max {warm['max']:.3f}; cold p50 "
              f"{cold['p50']:.3f} max {cold['max']:.3f}; "
              f"{rec['migrations']} sessions, {rec['migrated_frames']} "
              f"queued frames, {rec['migrated_bytes']} bytes migrated; 0 "
              f"shed, 0 lost; replay oracle {par['frames']} frames of "
              f"{par['sessions']} migrated sessions, max |dz| "
              f"{par['max_abs_dz']:.3e}, {par['bitwise_frames']} bitwise")
    print(f"phase 15 (d): {len(ticks)} member ticks, "
          f"{launches['wire_roundtrip_grouped']} wire_roundtrip_grouped "
          f"launches (1 a tick with k < {L}), no other wire kernel, 1 sync "
          "+ 1 D2H on every member tick")

    # --- (b) chaos: a member killed mid-stream, replication off and on ----
    record["chaos"] = {}
    for replicate in (False, True):
        lane = cs.cluster_chaos(2, replicate=replicate, device="cuda",
                                enc_cfg=cfg, params=params, spm=CLUSTER_SPM)
        st = lane["stats"]
        if replicate:
            check(lane["lost_in_flight"] == 0 and st.served == st.submitted
                  and lane["replayed_frames"] > 0 and lane["failures"] == 1,
                  f"phase 15 (b) replication on: {cs.summary(lane)}")
        else:
            check(lane["lost_in_flight"] > 0 and lane["failures"] == 1,
                  f"phase 15 (b) replication off: {cs.summary(lane)}")
        rec = cs.summary(lane)
        record["chaos"]["on" if replicate else "off"] = rec
        par = rec["parity"]
        print(f"phase 15 (b): chaos N=2, {rec['sessions']} sessions, "
              f"replication {'on' if replicate else 'off'}: victim "
              f"{rec['victim']}, lost_in_flight {rec['lost_in_flight']}, "
              f"{rec['failovers']} failovers, {rec['replayed_frames']} "
              f"journal frames replayed, {rec['journal_bytes']} journal "
              f"bytes, {rec['frames_per_s']:.1f} frames/s; served "
              f"{sum(st.served.values())} of {sum(st.submitted.values())}; "
              f"replay oracle {par['frames']} frames, max |dz| "
              f"{par['max_abs_dz']:.3e}, {par['bitwise_frames']} bitwise")

    # --- (c) card against CPU ------------------------------------------------
    # on a member clock that never moves, as the CPU tests run the lanes: on
    # the wall clock the slower CPU members age and shed other frames, and
    # the books (ticks, shed_expired, ...) then differ by timing alone
    runs = {dev: cs.cluster_chaos(2, replicate=True, device=dev, enc_cfg=cfg,
                                  params=params, spm=CLUSTER_CPU_SPM,
                                  oracle=False, clock=lambda: 0.0)
            for dev in ("cuda", "cpu")}
    card = {(r.sid, r.t): r for r in runs["cuda"]["results"]}
    cpu = {(r.sid, r.t): r for r in runs["cpu"]["results"]}
    check(card.keys() == cpu.keys()
          and len(card) == len(runs["cuda"]["results"]),
          "phase 15 (c): the card and the CPU served other frames")
    check(all((card[k].k, card[k].route, card[k].wire_bytes)
              == (cpu[k].k, cpu[k].route, cpu[k].wire_bytes) for k in card),
          "phase 15 (c): k, route or wire bytes differ card vs CPU")
    dz = max(float(np.abs(card[k].z - cpu[k].z).max()) for k in card)
    check(dz <= cs.Z_ATOL, f"phase 15 (c): card vs CPU max |dz| {dz}")
    books = {dev: cs.books(run["stats"]) for dev, run in runs.items()}
    diff = [k for k in books["cuda"] if books["cuda"][k] != books["cpu"][k]]
    check(not diff, f"phase 15 (c): ClusterStats books differ card vs "
          f"CPU in {diff}")
    record["card_vs_cpu"] = {"frames": len(card), "max_abs_dz": dz}
    print(f"phase 15 (c): chaos with replication at 2 x {CLUSTER_CPU_SPM} "
          f"sessions, card vs CPU: {len(card)} frames with equal (sid, t, k, "
          f"route, wire_bytes), max |dz| {dz:.3e} (atol {cs.Z_ATOL}), every "
          "ClusterStats book equal but the pause times (a frozen member "
          "clock)")

    # --- (e) the two demos on the card ---------------------------------------
    record["cluster_demo"] = cluster_demo.main(device="cuda")
    record["streaming_demo"] = streaming_demo.main(device="cuda")
    record["seconds"] = time.perf_counter() - start
    print(f"phase 15: {record['seconds']:.1f} s")
    return launches, record


# --- the representation-quality tables and the gateway examples ----------

# phase 16: the training steps a Fig 8 / Table 5 run and Fig 9's
# (runtime/quality_tables.py), cut from the reference's 220 and 150: at
# those the whole script took 1,261 s of a 1,200 s limit on a slow host
# (phase 16 334 s of it; see PERF.md), at 110 and 75 1,089 s once phase 21
# was added (phase 16 192 s); the edge learner's shapes at ENC: d 32, 16
# virtual negatives, the 96-frame buffer and a batch of 8
QUALITY_STEPS, QUALITY_CALIB_STEPS = 80, 55
Q_D, Q_SYN, Q_DIRS, Q_KNN, Q_C = 32, 16, 32, 3, 16
# the demos' refine shapes (sessions, window): quickstart, fleet demo
DEMO_REFINE = ((8, 32), (32, 50))
WIRE_ONE_GROUP = "wire_roundtrip"
# a ReLU pre-activation the card and the CPU may round to either sign:
# within this of its call's max |x| (their forwards agree to ~1e-6)
RELU_TIE = 1e-5


def quality_step_launches(ops, mode, variant):
    """Every kernel's launches in one training step of (mode, variant),
    read from the code: ``streamsplit`` runs the virtual-negative InfoNCE
    forward and backward and the GMM's ``em_update`` every step, and the
    regularisers of its variant (``core/hybrid.py::hybrid_loss``): both
    forwards and one ``hybrid_reg_bwd`` for ``hybrid``, the SW term's
    forward and one-half backward for ``task_sw``, the Laplacian's for
    ``task_lap``, none for ``mse`` and ``kl``; ``edge_only`` and
    ``server`` launch no kernel (plain batch InfoNCE)."""
    want = dict.fromkeys(ops.KERNELS, 0)
    if mode != "streamsplit":
        return want
    on = ["infonce_vneg_fwd", "infonce_vneg_bwd", "gmm_posterior"]
    on += {"hybrid": ["swd_rank_fwd", "laplacian_energy", "hybrid_reg_bwd"],
           "task_sw": ["swd_rank_fwd", "swd_rank_bwd"],
           "task_lap": ["laplacian_energy", "laplacian_energy_bwd"]}.get(
               variant, [])
    want.update(dict.fromkeys(on, 1))
    return want


def hold_quality_kernels(dev, ops):
    """Each kernel of the quality path and the demos against its plain
    version on the card at the shapes they give it, at phase 5's and
    phase 3's tolerances -> {name: max |err|}."""
    g = torch.Generator(device=dev).manual_seed(16)
    W = BUFFER + TRAIN_BATCH
    worst = dict.fromkeys(("infonce_vneg_fwd", "infonce_vneg_bwd",
                           "swd_rank_fwd", "swd_rank_bwd", "laplacian_energy",
                           "laplacian_energy_bwd", "hybrid_reg_bwd",
                           "gmm_posterior", "swd_sessions"), 0.0)
    # a streamsplit step: 16 virtual + 8 batch negatives at d 32, the SW
    # and Laplacian terms over the buffer and the batch (drop 0.4 masks
    # batch frames), both regularisers' backward; §3.3's SW term
    hold_infonce(g, dev, ops, worst, TRAIN_BATCH, Q_SYN + TRAIN_BATCH, Q_D)
    for case in ((W, Q_DIRS, Q_D), (512, 64, Q_D)):
        hold_swd_rank(g, dev, ops, worst, *case)
    hold_laplacian_train(g, dev, ops, worst, 1, W, Q_D, Q_KNN)
    note(worst, "hybrid_reg_bwd", hold_hybrid(g, dev, ops, "quality", 1, W,
                                              Q_D, Q_DIRS, Q_KNN, False))
    # §3.3's jittered curve (1, 80, 3) k 5: the forward alone
    z, mask, _, _ = refine_inputs(g, dev, 1, 80, 3, 1)
    note(worst, "laplacian_energy", hold(
        "laplacian_energy", lambda z, m: ops.laplacian_energy(z, m, 5),
        lambda z, m: ops.laplacian_energy_ref(z, m, 5), (z, mask),
        [(LAP_RTOL, 0.0), (0.0, 0.0)], "B=1 T=80 d=3 k=5"))
    # the GMM: em_update on the buffer (96, 16, 32), Fig 9's batch of 8
    for B in (BUFFER, TRAIN_BATCH):
        note(worst, "gmm_posterior", hold(
            "gmm_posterior", ops.gmm_posterior, ops.gmm_posterior_ref,
            gmm_inputs(g, dev, B, Q_C, Q_D), [(0.0, RESP_ATOL),
                                               (0.0, ENT_ATOL)],
            f"B={B} C={Q_C} d={Q_D}"))
    # the demos' refine rounds: HybridCfg's 50 directions and k 5
    for S, Wd in DEMO_REFINE:
        z, mask, dirs, pq = refine_inputs(g, dev, S, Wd, Q_D, N_DIRS)
        note(worst, "swd_sessions", hold(
            "swd_sessions", lambda *a: (ops.swd_sessions(*a),),
            lambda *a: (ops.swd_sessions_ref(*a),), (z, dirs, pq),
            [(SWD_RTOL, 0.0)], f"S={S} W={Wd} M={N_DIRS} d={Q_D}"))
        note(worst, "laplacian_energy", hold(
            "laplacian_energy", lambda z, m: ops.laplacian_energy(z, m, KNN),
            lambda z, m: ops.laplacian_energy_ref(z, m, KNN), (z, mask),
            [(LAP_RTOL, 0.0), (0.0, 0.0)], f"B={S} T={Wd} d={Q_D} k={KNN}"))
    torch.cuda.synchronize()
    return worst


def hold_demo_wire(cfg, ops):
    """The demos' wire bitwise against its plain version: the grouped
    launch over every width ``cfg`` puts on the wire at the padded bucket
    sizes a tick of up to 32 frames gives (the special rows in each), and
    the one-group ``wire_roundtrip`` at each width and size -> max |err|."""
    dev = ops.resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    widths = sorted(set(wire_widths(cfg)))
    worst = 0.0
    for B in (1, 2, 4, 8, 16, 32):
        xs = [special_rows(torch.randn(B, n, device=dev, generator=g) * 3.0
                           + 1.0) for n in widths]
        for got, want, what in (
                (ops.wire_roundtrip_grouped(xs),
                 ops.wire_roundtrip_grouped_ref(xs), "wire_roundtrip_grouped"),
                ([ops.wire_roundtrip(x) for x in xs],
                 [ops.wire_roundtrip_ref(x) for x in xs], WIRE_ONE_GROUP)):
            torch.cuda.synchronize()
            for n, a, w in zip(widths, got, want):
                worst = max(worst, (a - w).nan_to_num().abs().max().item())
                check(same_values(a, w), f"{what} != plain version at "
                      f"({B}, {n})")
    return worst


def count_demo_ticks(ops, records, demo, L):
    """An ``on_tick`` hook: each tick's (demo, wire launches (grouped,
    one-group, per-tensor quantize, round trip, dequantize), refine
    kernels' launches (swd_sessions, laplacian_energy), syncs, D2H, the
    k-buckets, the buckets with k < L, refine rounds so far)."""
    prev = {n: w.launches for n, w in ops.KERNELS.items()}

    def on_tick(gw, out):
        now = {n: w.launches for n, w in ops.KERNELS.items()}
        delta = {n: now[n] - prev[n] for n in now}
        prev.update(now)
        ks = {r.k for r in out}
        records.append((
            demo, tuple(delta[k] for k in WIRE_KERNELS),
            (delta["swd_sessions"], delta["laplacian_energy"]),
            gw.registry.value("gateway_device_syncs_per_tick"),
            gw.registry.value("gateway_d2h_copies_per_tick"),
            len(ks), sum(k < L for k in ks),
            gw.registry.value("gateway_refine_rounds")))
    return on_tick


class ReluPattern:
    """Installed as ``torch.relu`` (the encoder's nonlinearity): records
    each call's pre-activation on the host, or, given a recorded
    ``replay``, applies that sign pattern, ``x * (pre > 0)`` (its
    gradient is the pattern), counting the elements whose own sign
    differs and the largest of them relative to the call's max |x|.  A
    pre-activation within rounding of 0 may take either sign on the card
    and on the CPU, which moves a whole gradient path; step 0 card vs CPU
    runs the CPU on the card's pattern and reports such flips."""

    relu = torch.relu

    def __init__(self, replay=None):
        self.pre, self.replay = [], replay
        self.calls, self.flips, self.flip_max_rel = 0, 0, 0.0

    def __call__(self, x):
        i, self.calls = self.calls, self.calls + 1
        if self.replay is None:
            self.pre.append(x.detach().cpu())
            return ReluPattern.relu(x)
        mask = self.replay[i] > 0
        flip = mask != (x.detach() > 0)
        if flip.any():
            self.flips += int(flip.sum())
            self.flip_max_rel = max(self.flip_max_rel, float(
                x.detach().abs()[flip].max() / x.detach().abs().max()))
        return x * mask.to(x.dtype)

    def install(self):
        torch.relu = self
        return self

    @staticmethod
    def remove():
        torch.relu = ReluPattern.relu


def quality_card_vs_cpu(first):
    """Step 0 of each distinct (mode, variant, drop) run on the card
    against ``EdgeTrainer`` on the CPU from the same seeded state and
    draws, on the card's ReLU sign pattern: the loss and every gradient
    within QUALITY_RTOL of each one's max, and the GMM after the step; a
    sign the CPU rounds the other way must be a near-tie (within
    RELU_TIE of its call's max |x|) -> {run: (worst relative error, sign
    flips, the largest flipped |x| relative to its call's max)}."""
    from repro_torch.runtime.edge_train import EdgeTrainer
    out = {}
    for (mode, variant, drop), card in first.items():
        cpu = EdgeTrainer(mode, variant=variant, drop_rate=drop,
                          device="cpu")
        pattern = ReluPattern(replay=card["relu"]).install()
        try:
            c_loss, c_grads = cpu.step()
        finally:
            ReluPattern.remove()
        name = f"{mode},{variant},drop={drop}"
        check(pattern.calls == len(card["relu"])
              and len(card["grads"]) == len(c_grads),
              f"phase 16 (c) {name}: ReLU calls or gradients card vs CPU")
        errs = [abs(card["loss"] - float(c_loss)) / abs(float(c_loss))]
        errs += [rel_err(a, b) for a, b in zip(card["grads"], c_grads)]
        if mode == "streamsplit":
            errs += [rel_err(getattr(card["gmm"], k), getattr(cpu.gmm, k))
                     for k in ("s0", "s1", "s2")]
        out[name] = (max(errs), pattern.flips, pattern.flip_max_rel)
        check(max(errs) <= REFINE_RTOL and pattern.flip_max_rel <= RELU_TIE,
              f"phase 16 step 0 card vs CPU ({name}): {max(errs)} > "
              f"{REFINE_RTOL}, or a ReLU sign flip at {pattern.flip_max_rel}"
              f" of its max > {RELU_TIE}")
    return out


def phase16(ops):
    """The representation-quality tables and the three gateway examples
    on the card: (a) the kernels at the quality path's and the demos'
    shapes; (b) every table at the reference's widths, launches counted
    each step by (mode, variant) (the ``quality`` path); (c) each run's
    step 0 card vs CPU; (d) the three demos, counted each tick (the
    ``examples`` path) -> (quality launches, examples launches, the
    phase's record, max |err| by kernel)."""
    from repro_torch.runtime import (adaptive_serving, fleet_demo,
                                     quality_tables, quickstart)
    dev = ops.resolve_device("cuda")
    start = time.perf_counter()

    # --- (a) the kernels at the new shapes -----------------------------------
    worst = hold_quality_kernels(dev, ops)
    worst["wire"] = hold_demo_wire(quickstart.CFG, ops)
    print("phase 16 (a): the quality path's kernels == plain versions at its "
          f"shapes (infonce_vneg ({TRAIN_BATCH}, {Q_SYN + TRAIN_BATCH}, "
          f"{Q_D}); swd_rank ({BUFFER + TRAIN_BATCH}, {Q_D}) M {Q_DIRS} and "
          f"(512, {Q_D}) M 64, fwd + one-half bwd; laplacian_energy (1, "
          f"{BUFFER + TRAIN_BATCH}, {Q_D}) k {Q_KNN} fwd + one-half bwd, (1, "
          "80, 3) k 5 fwd; hybrid_reg_bwd; gmm_posterior at "
          f"({BUFFER}|{TRAIN_BATCH}, {Q_C}, {Q_D})), the demos' refine "
          f"kernels at {DEMO_REFINE} and their wire bitwise (grouped and "
          "one-group, B 1-32); max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))

    # --- (b) the tables, counted by step -------------------------------------
    runs, first = [], {}

    def run_kw(mode, variant, drop):
        want = quality_step_launches(ops, mode, variant)
        rec = {"mode": mode, "variant": variant, "drop": drop,
               "ends": [time.perf_counter()]}
        runs.append(rec)
        prev = {n: w.launches for n, w in ops.KERNELS.items()}
        key = (mode, variant, drop)
        # step 0's ReLU pre-activations, for (c), once a distinct run
        pattern = ReluPattern().install() if key not in first else None

        def on_step(i, loss, grads, tr):
            torch.cuda.synchronize()
            rec["ends"].append(time.perf_counter())
            now = {n: w.launches for n, w in ops.KERNELS.items()}
            got = {n: now[n] - prev[n] for n in now}
            prev.update(now)
            check(got == want, f"phase 16 (b) {mode} {variant} drop {drop} "
                  f"step {i}: launches {got}, want {want}")
            if i == 0 and pattern is not None:
                ReluPattern.remove()
                first[key] = {"loss": loss.item(), "relu": pattern.pre,
                              "grads": [x.cpu() for x in grads],
                              "gmm": tr.gmm.to("cpu")}
        return {"on_step": on_step}

    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    t_tables = time.perf_counter()
    rows = quality_tables.run_all(steps=QUALITY_STEPS,
                                  calib_steps=QUALITY_CALIB_STEPS,
                                  device="cuda", run_kw=run_kw)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t_tables
    q_launches = {n: w.launches for n, w in ops.KERNELS.items()}
    check(all(np.isfinite(v) for _, v, _ in rows), f"phase 16 (b): a row "
          f"is not finite: {[r for r in rows if not np.isfinite(r[1])]}")
    # the run totals, and §3.3 (9 cones, 9 jitter levels) and Fig 9 (60
    # batches: normalized_entropy and em_update) outside the runs
    want = dict.fromkeys(ops.KERNELS, 0)
    for r in runs:
        for n, c in quality_step_launches(ops, r["mode"],
                                               r["variant"]).items():
            want[n] += c * (len(r["ends"]) - 1)
    want["swd_rank_fwd"] += len(quality_tables.ANGLES)
    want["laplacian_energy"] += 9              # jitter 0, 0.1, ..., 0.8
    want["gmm_posterior"] += 2 * quality_tables.CALIB_BATCHES
    check(q_launches == want, f"phase 16 (b): launches {q_launches}, want "
          f"{want}")
    run_recs = []
    for r in runs:
        ms = np.diff(np.array(r["ends"])) * 1e3
        run_recs.append({"mode": r["mode"], "variant": r["variant"],
                         "drop": r["drop"], "steps": len(ms),
                         "step_ms_p50": float(np.percentile(ms[1:], 50))
                         if len(ms) > 1 else None,
                         "step_ms_p95": float(np.percentile(ms[1:], 95))
                         if len(ms) > 1 else None})
    for name, value, derived in rows:
        print(f"phase 16 (b) row: {name} = {value:.4f} ({derived})")
    for r in run_recs:
        print(f"phase 16 (b) run: {r['mode']} {r['variant']} drop "
              f"{r['drop']}: {r['steps']} steps, step ms p50 "
              f"{r['step_ms_p50']:.3f} p95 {r['step_ms_p95']:.3f}")
    print(f"phase 16 (b): {len(runs)} training runs, "
          f"{sum(r['steps'] for r in run_recs)} steps, launches per step by "
          f"(mode, variant) as the code implies on every step; the tables "
          f"in {tables_s:.1f} s; launches {q_launches}")

    # --- (c) card vs CPU at step 0 -------------------------------------------
    cvc = quality_card_vs_cpu(first)
    print(f"phase 16 (c): step 0 card vs the port on the CPU on the card's "
          f"ReLU pattern, {len(cvc)} runs (loss, every gradient, the GMM; "
          f"relative to each tensor's max), worst "
          f"{max(v[0] for v in cvc.values()):.3e}; (error, ReLU signs the "
          f"CPU rounds the other way, the largest of them / its max): "
          + ", ".join(f"{k} ({e:.2e}, {n}, {r:.1e})"
                      for k, (e, n, r) in cvc.items()))

    # --- (d) the three demos, counted by tick --------------------------------
    L = quickstart.CFG.n_blocks
    ticks = []
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    demos = {"quickstart": quickstart.main(
                 device="cuda", on_tick=count_demo_ticks(ops, ticks,
                                                         "quickstart", L)),
             "adaptive_serving": adaptive_serving.main(
                 device="cuda", on_tick=count_demo_ticks(
                     ops, ticks, "adaptive_serving", L)),
             "fleet_demo": fleet_demo.main(
                 device="cuda", on_tick=count_demo_ticks(ops, ticks,
                                                         "fleet_demo", L))}
    e_launches = {n: w.launches for n, w in ops.KERNELS.items()}
    torch.cuda.synchronize()
    rounds = {}
    for demo, wire, refine, syncs, d2h, buckets, wire_buckets, rnd in ticks:
        refined = rnd - rounds.get(demo, 0)
        rounds[demo] = rnd
        check(refine == (refined, refined), f"phase 16 (d) {demo}: refine "
              f"launches {refine} in a tick of {refined} rounds")
        if demo == "adaptive_serving":      # profile=True: a chain a bucket
            ok = (wire == (0, wire_buckets, 0, 0, 0)
                  and (syncs, d2h) == (buckets + 1, 1))
        else:
            ok = (wire == (int(wire_buckets > 0), 0, 0, 0, 0)
                  and (syncs, d2h) == (1, 1))
        check(ok, f"phase 16 (d) {demo}: a tick of {buckets} buckets "
              f"({wire_buckets} with k < {L}): wire launches {wire}, "
              f"{syncs} syncs, {d2h} D2H")
    n_ticks = {d: sum(t[0] == d for t in ticks) for d in demos}
    check(n_ticks == {"quickstart": quickstart.N_FRAMES,
                      "adaptive_serving": adaptive_serving.N_TICKS,
                      "fleet_demo": fleet_demo.ROUNDS
                      * fleet_demo.FRAMES_PER_ROUND},
          f"phase 16 (d): ticks {n_ticks}")
    q, a, f = (demos[d] for d in demos)
    check(q["stats"].frames == quickstart.N_FRAMES
          and q["stats"].refine_rounds == quickstart.N_FRAMES // 4
          and a["stats"].frames == adaptive_serving.N_SESSIONS
          * adaptive_serving.N_TICKS
          and f["stats"].frames == f["simulated"] - f["dropped"]
          and f["stats"].refine_rounds == fleet_demo.ROUNDS
          and all(np.isfinite(r.z).all() for d in demos.values()
                  for r in d["results"]),
          "phase 16 (d): served frames, refine rounds or embeddings")
    examples = {
        "quickstart": {"frames": q["stats"].frames,
                       "routed": q["stats"].routed,
                       "refine_rounds": q["stats"].refine_rounds,
                       "last_refine_loss": q["stats"].last_refine_loss},
        "adaptive_serving": {
            "frames": a["stats"].frames,
            "escalation_rate": a["escalation_rate"],
            "edge_ms_per_frame": a["edge_ms_per_frame"],
            "split_ms_per_frame": a["split_ms_per_frame"]},
        "fleet_demo": {"frames": f["stats"].frames,
                       "dropped": f["dropped"],
                       "round_losses": f["round_losses"],
                       "frames_per_dispatch":
                           f["stats"].frames_per_dispatch},
        "ticks": n_ticks, "wire_roundtrip_grouped":
            e_launches["wire_roundtrip_grouped"],
        "wire_roundtrip": e_launches[WIRE_ONE_GROUP],
        "swd_sessions": e_launches["swd_sessions"]}
    print(f"phase 16 (d): the three demos on the card, {len(ticks)} ticks "
          f"counted: one wire_roundtrip_grouped launch, one sync and one D2H "
          f"a quickstart / fleet tick (none of the wire with every frame at "
          f"k = {L}); adaptive serving's profiled ticks one wire_roundtrip "
          f"a bucket with k < {L} and a sync a bucket + 1; a refine round's "
          f"swd_sessions + laplacian_energy in its tick; launches "
          f"{e_launches}")
    record = {"rows": [list(r) for r in rows], "runs": run_recs,
              "tables_s": tables_s, "card_vs_cpu": cvc,
              "examples": examples,
              "seconds": time.perf_counter() - start}
    print(f"phase 16: {record['seconds']:.1f} s")
    return q_launches, e_launches, record, worst


# --- phase 17: the sharded fleet ------------------------------------------------

SHARDS = (2, 4)            # logical shards of the one card in (b)
SHARD_ROUNDS = 9           # refine rounds a backend (round 0 the warm-up)
DISPATCH_SHARDS = 4        # the sharded dispatch plane's shards in (c)
SHARD_RTOL = 1e-4          # several shards against one, of each max |x|
DP_STEPS = 200             # the compressed data-parallel quadratic's steps
SYNC_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
CARD = "cuda"              # phase 17's device (a CPU rehearsal sets "cpu")


def shard_mesh(shards, device):
    from repro_torch.launch.mesh import make_sessions_mesh
    return make_sessions_mesh(devices=[device] * shards)


def sharded_refine_backend(cfg, shards, device, head_init, mesh=None):
    """``refine_backend``'s fleet as a ``ShardedFleetBackend`` of
    ``shards`` logical shards on ``device`` (or on ``mesh``)."""
    from repro_torch.core.fleet_backend import ShardedFleetBackend
    from repro_torch.core.hybrid import HybridCfg
    return ShardedFleetBackend(
        capacity=SESSIONS, window=WINDOW, dim=cfg.d_embed,
        head_init=head_init, head_apply=linear_head, cfg=HybridCfg(),
        lr=1e-2, seed=0, n_components=N_COMPONENTS, memory_decay=0.05,
        mesh=mesh or shard_mesh(shards, device))


def zero_counts(ops):
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0


def read_counts(ops):
    torch.cuda.synchronize()
    return {name: w.launches for name, w in ops.KERNELS.items()}


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def refine_rounds(be, rounds):
    """``rounds`` refine rounds -> [(loss, parts, per-session losses)],
    host ms of each."""
    outs, ms = [], []
    for r in range(rounds):
        start = time.perf_counter()
        outs.append(be.refine(r))
        ms.append((time.perf_counter() - start) * 1e3)
    return outs, np.array(ms)


def pct(ms):
    return {"p50": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95))}


def state_of(be):
    """The head and the GMM memory, on the host."""
    return ({k: v.detach().cpu() for k, v in be.refiner.state.params.items()},
            be.memory.to("cpu"))


def round_rel(a, b):
    """Largest relative difference between two rounds' (loss, parts,
    per-session losses), each relative to its own max |x|."""
    (la, pa, qa), (lb, pb, qb) = a, b
    return max([abs(la - lb) / abs(lb)]
               + [abs(pa[k] - pb[k]) / abs(pb[k]) for k in pb]
               + [rel_err(qa, qb)])


def state_rel(a, b):
    (ha, ma), (hb, mb) = a, b
    return max([rel_err(ha[k], hb[k]) for k in hb]
               + [rel_err(getattr(ma, k), getattr(mb, k))
                  for k in ("s0", "s1", "s2")])


def hold_sharded_kernels(dev, ops):
    """The three refine kernels at the per-shard shapes of (b) against
    their plain versions (phase 3's tolerances) -> {name: max |err|}."""
    g = torch.Generator(device=dev).manual_seed(17)
    worst = dict.fromkeys(("swd_sessions", "laplacian_energy",
                           "gmm_posterior"), 0.0)
    for S in SHARDS:
        n = SESSIONS // S
        z, mask, dirs, pq = refine_inputs(g, dev, n, WINDOW, 128, N_DIRS)
        worst["swd_sessions"] = max(worst["swd_sessions"], hold(
            "swd_sessions", lambda *a: (ops.swd_sessions(*a),),
            lambda *a: (ops.swd_sessions_ref(*a),), (z, dirs, pq),
            [(SWD_RTOL, 0.0)], f"a shard's ({n}, {WINDOW}, 128) of {S}"))
        worst["laplacian_energy"] = max(worst["laplacian_energy"], hold(
            "laplacian_energy",
            lambda z_, m_: ops.laplacian_energy(z_, m_, KNN),
            lambda z_, m_: ops.laplacian_energy_ref(z_, m_, KNN), (z, mask),
            [(LAP_RTOL, 0.0), (0.0, 0.0)], f"a shard's ({n}, {WINDOW}) of "
            f"{S}"))
        worst["gmm_posterior"] = max(worst["gmm_posterior"], hold(
            "gmm_posterior", ops.gmm_posterior, ops.gmm_posterior_ref,
            gmm_inputs(g, dev, n * WINDOW, N_COMPONENTS, 128),
            [(0.0, RESP_ATOL), (0.0, ENT_ATOL)],
            f"a shard's {n * WINDOW} rows of {S}"))
    return worst


def hold_shard_wire(cfg, dev, ops, results):
    """``wire_roundtrip_grouped`` bitwise against its plain version on the
    groups each shard's tick hands it in (c), read off a tick's
    ``results``: the shard's buckets with k < L at their padded sizes ->
    max |err|."""
    g = torch.Generator(device=dev).manual_seed(27)
    widths = wire_widths(cfg)
    buckets = {(r.shard, r.k): r.bucket_size for r in results
               if r.k < cfg.n_blocks}
    per_shard = {}
    for (s, k), n in sorted(buckets.items()):
        per_shard.setdefault(s, []).append(
            (1 << (n - 1).bit_length(), widths[k]))
    worst = 0.0
    for s, shapes in per_shard.items():
        xs = [special_rows(torch.randn(B, n, device=dev, generator=g) * 3.0
                           + 1.0) for B, n in shapes]
        got, want = (ops.wire_roundtrip_grouped(xs),
                     ops.wire_roundtrip_grouped_ref(xs))
        for a, w in zip(got, want):
            worst = max(worst, (a - w).nan_to_num().abs().max().item())
            check(same_values(a, w), f"wire_roundtrip_grouped != plain "
                  f"version at shard {s}'s groups {shapes}")
    return worst


def profile_sharded_tick(gw, sids, mels, t):
    """One more sharded tick under torch.profiler -> its device copy
    records (host->device, device->host, device->device; the encoder's
    stages make device-to-device copies of their own), and inside the
    tick its CUDA runtime copy calls and waits; ``None`` where the
    profiler recorded no device activity.  In runs of the whole script
    the staged host->device copy had no device record (twice, after the
    earlier phases' profiles; a run of phase 17 alone recorded it), so
    the one H2D is read off the runtime's copy calls: those that are not
    a device-to-device or device-to-host record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("sharded_tick"):
            serve(gw, sids, [mels], timed=True, t0=t)
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name != "sharded_tick"]
    rng = [e for e in events if e.name == "sharded_tick"
           and e.device_type == DeviceType.CPU]
    if not dev or len(rng) != 1:
        return None
    lo, hi = rng[0].time_range.start, rng[0].time_range.end
    inside = [e.name for e in events if e.device_type == DeviceType.CPU
              and lo <= e.time_range.start and e.time_range.end <= hi]
    out = {"h2d": sum("HtoD" in e.name for e in dev),
           "d2h": sum("DtoH" in e.name for e in dev),
           "d2d": sum("DtoD" in e.name for e in dev),
           "copy_calls": sum(n.startswith("cudaMemcpy") for n in inside),
           "waits": sum(n in SYNC_WAITS for n in inside),
           "copy_records": sorted({e.name for e in dev
                                   if e.name.startswith("Memcpy")})}
    out["h2d_calls"] = out["copy_calls"] - out["d2d"] - out["d2h"]
    return out


def sharded_gateway(cfg, params, shards, shard_dispatch):
    from repro_torch.api import QoSClass, StreamSplitGateway
    from repro_torch.core.fleet_backend import ShardedFleetBackend
    be = ShardedFleetBackend(capacity=SESSIONS, window=WINDOW,
                             dim=cfg.d_embed, mesh=shard_mesh(shards, CARD))
    gw = StreamSplitGateway(cfg, params, policy=SpreadPolicy(cfg.n_blocks),
                            backend=be, qos_reserve=0,
                            shard_dispatch=shard_dispatch, device=CARD)
    sids = [gw.open_session(qos=QoSClass.INTERACTIVE).sid
            for _ in range(SESSIONS)]
    return gw, sids


def phase17_refine(cfg, dev, ops, counted):
    """(a) one shard against the host backend, bitwise; (b) 2 and 4
    logical shards: round 0 card vs CPU, every round against one shard,
    launches gated -> (the readings, the 2-shard run's rounds, head and
    memory, collectives and round ms, which phase 21 holds its processes
    to)."""
    from repro_torch.distributed.sharding import count_collectives
    out = {}
    host = refine_backend(cfg, CARD, init_linear_head)
    one = sharded_refine_backend(cfg, 1, CARD, init_linear_head)
    rows = np.arange(SESSIONS)
    for be in (host, one):
        check([be.admit() for _ in range(SESSIONS)] == rows.tolist(),
              f"{be.kind} backend admitted rows out of order")
        prefill(be, rows, np.random.default_rng(1))
    for a, b in zip(host.snapshot(), one.snapshot()):
        check(np.array_equal(a, b) and a.dtype == b.dtype,
              "1-shard snapshot != host snapshot")
    h_out, h_ms = refine_rounds(host, SHARD_ROUNDS)
    zero_counts(ops)
    s_out, s_ms = refine_rounds(one, SHARD_ROUNDS)
    launches = read_counts(ops)
    add_counts(counted, launches)
    for r, (a, b) in enumerate(zip(h_out, s_out)):
        check(a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2]),
              f"round {r}: 1-shard sharded != host backend: {a[:2]} vs "
              f"{b[:2]}")
    ref_state = state_of(one)
    (hh, hm) = state_of(host)
    check(all(torch.equal(hh[k], ref_state[0][k]) for k in hh)
          and all(torch.equal(x, y) for x, y in zip(hm, ref_state[1])),
          "1-shard head or memory != host backend's")
    check(one.snapshot_h2d_bytes == 0, "sharded backend copied a snapshot")
    for name in ("swd_sessions", "laplacian_energy", "gmm_posterior"):
        check(launches[name] == SHARD_ROUNDS, f"1 shard: {name} launched "
              f"{launches[name]} times in {SHARD_ROUNDS} rounds")
    out["one_shard"] = {"host_round_ms": pct(h_ms[1:]),
                        "sharded_round_ms": pct(s_ms[1:]),
                        "launches": {k: launches[k] for k in (
                            "swd_sessions", "laplacian_energy",
                            "gmm_posterior")}}
    print(f"phase 17 (a): ShardedFleetBackend(S=1) == HostFleetBackend "
          f"bitwise over {SHARD_ROUNDS} rounds (loss, parts, per-session "
          f"losses, head, GMM memory), snapshot_h2d_bytes 0 (host "
          f"{host.snapshot_h2d_bytes}); round ms host p50 "
          f"{out['one_shard']['host_round_ms']['p50']:.3f} p95 "
          f"{out['one_shard']['host_round_ms']['p95']:.3f}, sharded p50 "
          f"{out['one_shard']['sharded_round_ms']['p50']:.3f} p95 "
          f"{out['one_shard']['sharded_round_ms']['p95']:.3f}")
    for S in SHARDS:
        be = sharded_refine_backend(cfg, S, CARD, init_linear_head)
        sids = [be.admit() for _ in range(SESSIONS)]
        check(sorted(sids) == rows.tolist()
              and np.bincount(be.shards_of(sids)).tolist()
              == [SESSIONS // S] * S, f"S={S}: placement {sids[:8]}...")
        prefill(be, rows, np.random.default_rng(1))
        exported = [be.export_row(sid) for sid in rows]
        zero_counts(ops)
        with count_collectives() as collectives:
            outs, ms = refine_rounds(be, SHARD_ROUNDS)
        launches = read_counts(ops)
        if S == 2:
            two = {"sids": sids, "outs": outs, "state": state_of(be),
                   "collectives": collectives, "round_ms": pct(ms[1:])}
        add_counts(counted, launches)
        for name in ("swd_sessions", "laplacian_energy", "gmm_posterior"):
            check(launches[name] == S * SHARD_ROUNDS,
                  f"S={S}: {name} launched {launches[name]} times in "
                  f"{SHARD_ROUNDS} rounds, want {S} a round")
        for r, (loss, parts, per) in enumerate(outs):
            check(np.isfinite(loss) and np.isfinite(per).all()
                  and per.shape == (SESSIONS,), f"S={S} round {r} not "
                  "finite")
        vs_one = max(round_rel(a, b) for a, b in zip(outs, s_out))
        vs_one_state = state_rel(state_of(be), ref_state)
        check(vs_one <= SHARD_RTOL and vs_one_state <= SHARD_RTOL,
              f"S={S} against one shard: rounds {vs_one}, head/memory "
              f"{vs_one_state} > {SHARD_RTOL}")
        cpu = sharded_refine_backend(cfg, S, "cpu", init_linear_head)
        check([cpu.admit() for _ in range(SESSIONS)] == sids,
              f"S={S}: CPU placement differs")
        for sid, row in zip(rows, exported):
            cpu.import_row(sid, *row)
        c0 = cpu.refine(0)
        vs_cpu = round_rel(outs[0], c0)
        check(vs_cpu <= REFINE_RTOL, f"S={S} round 0 card vs CPU {vs_cpu}")
        check(be.snapshot_h2d_bytes == 0, f"S={S} copied a snapshot")
        out[f"S{S}"] = {"round_ms": pct(ms[1:]), "vs_one_shard": vs_one,
                        "vs_one_shard_state": vs_one_state,
                        "card_vs_cpu": vs_cpu}
        print(f"phase 17 (b): S={S} logical shards: round ms p50 "
              f"{out[f'S{S}']['round_ms']['p50']:.3f} p95 "
              f"{out[f'S{S}']['round_ms']['p95']:.3f}; {S} launches of "
              f"each refine kernel a round; against one shard (rel) rounds "
              f"{vs_one:.3e}, head and memory after {SHARD_ROUNDS} rounds "
              f"{vs_one_state:.3e}; round 0 card vs CPU {vs_cpu:.3e}")
    return out, two


def phase17_dispatch(cfg, ops, counted):
    """(c) the gateway's shard_dispatch at phase 2's serving shape ->
    the readings and the plane's wire record."""
    from repro_torch.models.audio_encoder import init_audio_encoder
    L = cfg.n_blocks
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((SESSIONS, cfg.frames, cfg.n_mels),
                                np.float32) for _ in range(2 + TIMED_TICKS)]
    ticks = mels[:1 + TIMED_TICKS]
    plain, sp = sharded_gateway(cfg, params, 1, False)
    p_res, p_secs = serve(plain, sp, ticks, timed=True)
    out = {"plain_tick_ms": pct(np.array(p_secs[1:]) * 1e3)}
    for S in (1, DISPATCH_SHARDS):
        gw, sids = sharded_gateway(cfg, params, S, True)
        check(gw.shard_dispatch and gw.stats().dispatch_shards == S,
              f"S={S}: shard_dispatch off")
        zero_counts(ops)
        res, secs = serve(gw, sids, ticks, timed=True)
        launches = read_counts(ops)
        add_counts(counted, launches)
        check(launches["wire_roundtrip_grouped"] == S * len(ticks)
              and all(launches[k] == 0 for k in WIRE_KERNELS[1:]),
              f"S={S}: wire launches {launches}, want {S} grouped a tick")
        worst = 0.0
        check(S > 1 or sids == sp, "S=1: other rows than the plain plane's")
        for t, (a_, b_) in enumerate(zip(p_res, res)):
            for a, b in zip(a_, b_):
                check((a.t, a.k, a.route, a.wire_bytes)
                      == (b.t, b.k, b.route, b.wire_bytes),
                      f"S={S} tick {t}: {a.t, a.k, a.wire_bytes} != "
                      f"{b.t, b.k, b.wire_bytes}")
                worst = max(worst, float(np.abs(a.z - b.z).max()))
        check(worst == 0.0 if S == 1 else worst <= CPU_ATOL,
              f"S={S}: max |dz| {worst} against the one-device plane")
        st = gw.stats()
        want_staged = len(ticks) * SESSIONS * cfg.frames * cfg.n_mels * 4
        check(st.staged_h2d_bytes == want_staged and st.ingest_h2d_bytes
              == 0 and sum(st.dispatch_shard_frames) == st.frames
              == len(ticks) * SESSIONS, f"S={S}: stats {st}")
        for a, b in zip(plain.backend.snapshot(), gw.backend.snapshot()):
            d = float(np.abs(a[np.array(sp)] - b[np.array(sids)]).max())
            check(d <= (0.0 if S == 1 else CPU_ATOL), f"S={S}: rings "
                  f"differ by {d}")
        prof = profile_sharded_tick(gw, sids, mels[-1], len(ticks))
        if prof is not None:
            check(prof["h2d_calls"] == 1 and prof["h2d"] <= 1
                  and prof["d2h"] == 1 and prof["waits"] == 1,
                  f"S={S}: profiled sharded tick {prof}, want one H2D, "
                  "one D2H, one wait")
        wire_err = hold_shard_wire(cfg, torch.device(CARD), ops, res[-1])
        key = f"S{S}"
        out[key] = {"tick_ms": pct(np.array(secs[1:]) * 1e3),
                    "max_abs_dz": worst, "profiled_tick": prof,
                    "wire_launches_per_tick": S, "wire_max_abs_err": wire_err}
        print(f"phase 17 (c): shard_dispatch S={S}: {len(ticks)} ticks x "
              f"{SESSIONS} frames, 1 sync + 1 D2H a tick, {S} "
              f"wire_roundtrip_grouped launches a tick (no other wire "
              f"kernel), max |dz| against the one-device plane {worst:.3e}"
              f"{' (bitwise)' if worst == 0 else ''}; tick ms p50 "
              f"{out[key]['tick_ms']['p50']:.3f} p95 "
              f"{out[key]['tick_ms']['p95']:.3f} (one-device plane p50 "
              f"{out['plain_tick_ms']['p50']:.3f}); profiled tick "
              f"{prof if prof is not None else 'not measured'}")
    return out


def phase17_sync(cfg):
    """(d) compressed gradient sync on the card -> the readings."""
    from repro_torch.distributed.grad_sync import (ef_init,
                                                   make_compressed_dp_step)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import sgd_init, sgd_update
    from repro_torch.optim.compression import (int8_psum, wire_bytes_fp32,
                                               wire_bytes_int8)
    from repro_torch.runtime.edge_train import EdgeTrainer
    g = torch.Generator().manual_seed(0)
    w_true = torch.randn(8, 4, generator=g)
    X = torch.randn(64, 8, generator=g).to(CARD)
    Y = X @ w_true.to(CARD)

    def loss_fn(params, batch):
        r = batch["x"] @ params["w"] - batch["y"]
        return (r * r).mean()
    mesh = make_test_mesh((4,), ("data",), devices=[CARD] * 4)
    finals = {}
    for compress in (False, True):
        p = {"w": torch.zeros(8, 4, device=CARD)}
        st, ef = sgd_init(p), ef_init(p)
        step = make_compressed_dp_step(mesh, loss_fn, sgd_update,
                                       axis="data", lr=0.1,
                                       compress=compress)
        for _ in range(DP_STEPS):
            p, st, ef = step(p, st, ef, {"x": X, "y": Y})
        finals[compress] = float(loss_fn(p, {"x": X, "y": Y}))
    check(finals[False] < 1e-4 and finals[True] < 1e-3,
          f"compressed DP on the quadratic: exact {finals[False]}, "
          f"compressed {finals[True]}")
    _, grads = EdgeTrainer("streamsplit", enc_cfg=cfg, device=CARD).step()
    rel = 0.0
    for gr in grads:
        got = int8_psum([gr] * 4, "data")[0]
        want = 4.0 * gr
        rel = max(rel, float((got - want).abs().max()
                             / want.abs().max().clamp_min(1e-30)))
    check(rel < 0.05, f"int8_psum of the edge step's gradients: rel {rel}")
    b8, b32 = wire_bytes_int8(grads), wire_bytes_fp32(grads)
    out = {"dp_exact_loss": finals[False], "dp_compressed_loss":
           finals[True], "int8_psum_rel_err": rel, "grad_leaves": len(grads),
           "wire_bytes_int8": b8, "wire_bytes_fp32": b32}
    print(f"phase 17 (d): compressed DP over 4 shards, {DP_STEPS} steps: "
          f"exact loss {finals[False]:.3e} (< 1e-4), int8+EF "
          f"{finals[True]:.3e} (< 1e-3); int8_psum of 4 copies of one edge "
          f"step's {len(grads)} gradients at AudioEncCfg(): rel err "
          f"{rel:.3e}, wire {b8} bytes int8 against {b32} fp32 "
          f"({b8 / b32:.4f})")
    return out


def phase17_federation(cfg):
    """(e) the podwise split pipeline, (f) the federation over sharded
    members and a host -> sharded migration -> the readings."""
    from repro_torch.runtime import cluster_serve, multipod_demo
    lines = []
    demo = multipod_demo.main(CARD, out=lines.append)
    check(demo["fp32"]["max_err"] < 1e-5 and demo["INT8"]["max_err"] < 0.05,
          f"podwise pipeline: {demo}")
    print("phase 17 (e): " + " | ".join(lines[:2]))
    try:
        lane = cluster_serve.cluster_drain(
            2, device=CARD, enc_cfg=cfg, spm=CLUSTER_SPM,
            rounds=CLUSTER_ROUNDS, fleet="sharded")
    except AssertionError as e:
        fail(f"drain lane over sharded members: {e!r}")
    check(lane["shed_expired"] == 0 and lane["lost_in_flight"] == 0,
          "drain lane over sharded members shed or lost frames")
    fps = lane["frames_per_s"]
    # one migration host -> sharded, the row and the next frame held
    from repro_torch.api import FrameRequest
    from repro_torch.models.audio_encoder import init_audio_encoder
    params = init_audio_encoder(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    host = cluster_serve.gateway(cfg, params, 4, CARD)
    shrd = cluster_serve.gateway(cfg, params, 4, CARD, fleet="sharded")
    twin = cluster_serve.gateway(cfg, params, 4, CARD)
    sid, tsid = host.open_session().sid, twin.open_session().sid
    for t in range(3):
        mel = rng.standard_normal((cfg.frames, cfg.n_mels), np.float32)
        for gw, s in ((host, sid), (twin, tsid)):
            gw.submit(s, FrameRequest(t=t, mel=mel, u=0.5))
            gw.tick()
    snap = host.export_session(sid)
    info = shrd.import_session(snap)
    row = shrd.backend.export_row(info.sid)
    check(all(np.array_equal(a, b) for a, b in zip(
        row[:3], (snap.ring_z, snap.ring_t, snap.ring_label)))
        and row[3] == snap.ring_newest, "host -> sharded row changed")
    mel = rng.standard_normal((cfg.frames, cfg.n_mels), np.float32)
    outs = []
    for gw, s in ((shrd, info.sid), (twin, tsid)):
        gw.submit(s, FrameRequest(t=3, mel=mel, u=0.5))
        outs.append(gw.tick()[0])
    check(np.array_equal(outs[0].z, outs[1].z) and outs[0].k == outs[1].k,
          "the migrated stream's next frame != the unmigrated twin's")
    out = {"pipeline": demo, "drain": {
        "frames_per_s": fps, "migrations": lane["migrations"],
        "migration_pause_ms": lane["migration_pause_ms"],
        "parity": lane["parity"]}}
    print(f"phase 17 (f): drain lane at N = 2 x {CLUSTER_SPM} sessions on "
          f"ShardedFleetBackend members: frames/s before "
          f"{fps['before']:.1f}, during {fps['during_drain']:.1f}, after "
          f"{fps['after']:.1f}; {lane['migrations']} migrations, 0 shed, 0 "
          f"lost, replay oracle {lane['parity']}; a host -> sharded "
          "migration keeps the row and the next frame bitwise")
    return out


def phase17(cfg, ops):
    """The sharded fleet on the card -> (the sharded path's launch
    counts, the readings, max |err| by kernel at the per-shard shapes,
    (b)'s 2-shard run for phase 21)."""
    dev = torch.device(CARD)
    start = time.perf_counter()
    counted = {}
    worst = hold_sharded_kernels(dev, ops)
    readings = {}
    readings["refine"], two = phase17_refine(cfg, dev, ops, counted)
    readings["dispatch"] = phase17_dispatch(cfg, ops, counted)
    worst["wire"] = max(readings["dispatch"][f"S{s}"]["wire_max_abs_err"]
                        for s in (1, DISPATCH_SHARDS))
    readings["sync"] = phase17_sync(cfg)
    readings.update(phase17_federation(cfg))
    readings["seconds"] = time.perf_counter() - start
    print(f"phase 17: {readings['seconds']:.1f} s; per-shard kernels "
          "against their plain versions, max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))
    return counted, readings, worst, two


# phase 21: phase 17's 2-shard fleet refined by 2 processes, a shard each,
# both on the card, over gloo (ranks that share a card stage the
# collectives through pinned host memory)
MP_WORLD = 2
MP_TIMEOUT_S = 300         # the ranks' deadline, their start included
REFINE_KERNELS = ("swd_sessions", "laplacian_energy", "gmm_posterior")


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def replicas_agree(job, owners, tensors, what):
    """Whether every rank holds ``tensors`` bit for bit (gathered over
    the job; the exchange is counted in ``job.staged``, not as a
    collective)."""
    from repro_torch.distributed.job import exchange
    every = exchange([list(tensors)], owners, what)
    return all(torch.equal(a, b) for theirs in every
               for a, b in zip(theirs, tensors))


def phase21_rank(rank, port, device, path, sizes):
    """One rank of phase 21, spawned: joins the job through the
    environment contract, builds the full-width fleet on its shard of
    ``make_sessions_mesh()`` (spanning the job), prefills it and runs
    ``SHARD_ROUNDS`` refine rounds -> its readings, saved to ``path``.
    ``sizes``: the parent's ``SESSIONS``, ``SHARD_ROUNDS`` and
    ``N_COMPONENTS`` (a CPU rehearsal cuts them)."""
    globals().update(sizes)
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.distributed.job import current_job, exchange
    from repro_torch.distributed.sharding import count_collectives
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import (make_sessions_mesh,
                                         maybe_init_distributed)
    check(maybe_init_distributed(env={
        "REPRO_COORDINATOR": f"127.0.0.1:{port}",
        "REPRO_NUM_PROCESSES": str(MP_WORLD),
        "REPRO_PROCESS_ID": str(rank)}), f"rank {rank} joined no job")
    job = current_job()
    mesh = make_sessions_mesh(devices=None if device == "cuda" else [device])
    be = sharded_refine_backend(CFG, None, device, init_linear_head,
                                mesh=mesh)
    check(be.shards == MP_WORLD and be.local == [rank],
          f"rank {rank}: shards {be.shards}, local {be.local}")
    rows = np.arange(SESSIONS)
    sids = [be.admit() for _ in range(SESSIONS)]
    prefill(be, rows, np.random.default_rng(1))
    draws = all(replicas_agree(job, be.owners, be.refiner.draw(
        r, WINDOW, CFG.d_embed), "draws") for r in range(SHARD_ROUNDS))
    zero_counts(ops)
    outs, ms, staged, replicated = [], [], [], True
    with count_collectives() as collectives:
        for r in range(SHARD_ROUNDS):
            before = dict(job.staged)
            start = time.perf_counter()
            outs.append(be.refine(r))
            ms.append((time.perf_counter() - start) * 1e3)
            staged.append({k: job.staged[k] - before[k] for k in before})
            head, memory = state_of(be)
            replicated &= replicas_agree(
                job, be.owners, [*head.values(), *memory], "head, memory")
    if device == "cuda":
        torch.cuda.synchronize()
    # a bare exchange of 16 host bytes: the gloo round trip alone
    probe = [torch.zeros(4)]
    rtt = []
    for _ in range(50):
        start = time.perf_counter()
        exchange(probe, be.owners, "probe")
        rtt.append((time.perf_counter() - start) * 1e3)
    torch.save({"sids": sids, "outs": outs, "ms": ms, "staged": staged,
                "exchange_ms": pct(np.array(rtt[5:])),
                "draws_equal": draws, "replicated": replicated,
                "state": state_of(be), "collectives": collectives,
                "launches": {n: w.launches for n, w in ops.KERNELS.items()},
                "device": str(be.device), "nccl": job.nccl is not None},
               path)


def phase21(ops, two):
    """The sharded fleet across processes: ``MP_WORLD`` spawned ranks,
    a shard each on the card, held to phase 17's one process x 2
    logical shards (``two``) -> (the ``multiprocess`` path's launches,
    summed over the ranks; the readings)."""
    import multiprocessing
    start = time.perf_counter()
    if CARD == "cuda":
        torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "build", "phase21")
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, f"rank{r}.pt") for r in range(MP_WORLD)]
    for p in paths:
        if os.path.exists(p):
            os.unlink(p)
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    sizes = {"SESSIONS": SESSIONS, "SHARD_ROUNDS": SHARD_ROUNDS,
             "N_COMPONENTS": N_COMPONENTS}
    procs = [ctx.Process(target=phase21_rank,
                         args=(r, port, CARD, p, sizes))
             for r, p in enumerate(paths)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + MP_TIMEOUT_S
        while any(p.is_alive() for p in procs):
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)]
            check(not dead, f"phase 21: rank {dead[:1]} exited "
                  f"{[procs[r].exitcode for r in dead]}")
            check(time.monotonic() < deadline,
                  f"phase 21: the ranks ran past {MP_TIMEOUT_S} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"phase 21: exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(p, weights_only=False) for p in paths]
    total = {}
    readings = {"ranks": [], "phase17_two_shards_round_ms": two["round_ms"],
                "collectives": two["collectives"]}
    for r, got in enumerate(ranks):
        check(got["sids"] == two["sids"], f"rank {r}: placement "
              f"{got['sids'][:8]}... != one process's")
        check(got["draws_equal"], f"rank {r}: a round's SWD draws differ "
              "across the ranks")
        check(got["replicated"], f"rank {r}: the head or the memory "
              "differs across the ranks after a round")
        check(not got["nccl"], f"rank {r}: an NCCL group on one card")
        for i, (a, b) in enumerate(zip(got["outs"], two["outs"])):
            check(a[0] == b[0] and a[1] == b[1]
                  and np.array_equal(a[2], b[2]),
                  f"rank {r} round {i}: 2 processes != 1 process x 2 "
                  f"shards: {a[:2]} vs {b[:2]}")
        (gh, gm), (wh, wm) = got["state"], two["state"]
        check(all(torch.equal(gh[k], wh[k]) for k in wh)
              and all(torch.equal(x, y) for x, y in zip(gm, wm)),
              f"rank {r}: head or memory != 1 process x 2 shards")
        check(got["collectives"] == two["collectives"],
              f"rank {r}: collectives {got['collectives']} != one "
              f"process's {two['collectives']}")
        launches = got["launches"]
        check(all(launches[k] == (SHARD_ROUNDS if k in REFINE_KERNELS
                                  else 0) for k in launches),
              f"rank {r}: launches {launches}, want one of each refine "
              f"kernel a round ({SHARD_ROUNDS})")
        add_counts(total, launches)
        steady = got["staged"][1:]
        per_round = {k: float(np.mean([x[k] for x in steady]))
                     for k in steady[0]}
        readings["ranks"].append({"round_ms": pct(np.array(got["ms"][1:])),
                                  "staged_per_round": per_round,
                                  "bare_exchange_ms": got["exchange_ms"],
                                  "device": got["device"]})
    readings["seconds"] = time.perf_counter() - start
    print(f"phase 21: {MP_WORLD} processes x 1 shard of phase 4's fleet on "
          f"{ranks[0]['device']} over gloo, bitwise phase 17's 1 process x "
          f"2 shards over {SHARD_ROUNDS} rounds (loss, parts, per-session "
          "losses, head, memory; draws, head and memory equal across the "
          "ranks; collectives " + json.dumps(two["collectives"]["per_kind_"
                                                               "counts"])
          + "); round ms a process " + "; ".join(
              f"rank {r} p50 {x['round_ms']['p50']:.3f} p95 "
              f"{x['round_ms']['p95']:.3f}, staged a round "
              f"{x['staged_per_round']['calls']:.0f} exchanges, D2H "
              f"{x['staged_per_round']['d2h_bytes']:.0f} B, H2D "
              f"{x['staged_per_round']['h2d_bytes']:.0f} B, "
              f"{x['staged_per_round']['ms']:.3f} ms (a bare exchange of 16 "
              f"host bytes p50 {x['bare_exchange_ms']['p50']:.3f} ms)"
              for r, x in enumerate(readings["ranks"]))
          + f"; phase 17's 2-shard p50 {two['round_ms']['p50']:.3f}; "
          f"{readings['seconds']:.1f} s")
    return total, readings


# phase 18: the LM half of sharding on logical shards of the card
# (name, layers or None, B, S, warm-up steps, counted steps, mesh)
LM18_TRAIN = ("qwen1.5-0.5b", None, 8, 1024, 3, 5, (2, 2))
LM18_ROW = ("qwen3-1.7b", 4, 4, 1024, (1, 16))
# (name, layers, experts, B, S, mesh)
LM18_MOE = ("arctic-480b", 2, 8, 2, 256, (1, 4))
LM18_LOSS_RTOL = 1e-5    # sharded vs unsharded loss
LM18_RTOL = 1e-4         # each gathered gradient, of its leaf's max |g|
MOE_EP_ATOL = 2e-4       # moe_ep vs moe_reference (the reference's bar)
LM18_CPU = "cpu"         # the MoE layer's moe_ep, card vs this device


def lm18_mesh(shape):
    from repro_torch.launch.mesh import make_test_mesh
    return make_test_mesh(shape, devices=[CARD] * int(np.prod(shape)))


def lm18_rules(cfg, shape, B, fsdp=False):
    from repro_torch.distributed import sharding as shd
    return shd.rules_for(lm18_mesh(shape), cfg, batch=B, kind="train",
                         fsdp=fsdp)


def lm18_grads(cfg, tcfg, rules, params, batch, draws, times=1):
    """Step 0's loss, metrics and gradients on the mesh of ``rules`` (the
    params laid out, each block's gradient psum'd over its replicas),
    ``times`` times, bitwise the same each time -> (loss, metrics, one
    gathered gradient a leaf)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.optim.sgd import tree_leaves
    from repro_torch.runtime import trainer as tr
    lay = shd.ShardLayout(rules)
    placed = shd.place_tree(params, lm.param_shardings(cfg, lay))
    blocks = {k: lay.batch_blocks(v) for k, v in batch.items()}
    loss_fn = tr.make_sharded_loss_fn(cfg, tcfg, lay)
    runs = []
    for _ in range(times):
        (loss, m), g = tr.sharded_value_and_grad(loss_fn, placed, lay.n,
                                                 blocks, draws)
        runs.append((loss, m, tr.reduce_replicas(placed, g)))
    torch.cuda.synchronize()
    loss, m, g = runs[0]
    for l2, _, g2 in runs[1:]:
        check(torch.equal(loss, l2) and all(
            torch.equal(a, b) for ga, gb in zip(g, g2)
            for a, b in zip(ga, gb)),
            f"{cfg.name}: the sharded step 0 is not bitwise from run to run")
    gathered = [shd.Placed(gs, t.sharding, t.shape).gather()
                for t, gs in zip(tree_leaves(placed), g)]
    return loss, m, gathered


def lm18_against_unsharded(cfg, tcfg, shape, params, batch, draws, times,
                           fsdp=False, gate_gradients=True):
    """Step 0 unsharded and on the mesh (FSDP rules with ``fsdp``) from
    the same params, batch and draws -> {"loss": rel err, "gradients":
    worst rel err, ...}; the gradients gated at LM18_RTOL where
    ``gate_gradients``."""
    from repro_torch.optim.sgd import value_and_grad
    from repro_torch.runtime import trainer as tr
    B = batch["labels"].shape[0]
    (lu, mu), gu = value_and_grad(tr.make_loss_fn(cfg, tcfg), params, batch,
                                  draws)
    ls, ms, gs = lm18_grads(cfg, tcfg, lm18_rules(cfg, shape, B, fsdp),
                            params, batch, draws, times)
    errs = {"loss": abs(ls.item() - lu.item()) / abs(lu.item())}
    for k in mu:
        errs[k] = abs(ms[k].item() - mu[k].item()) / max(abs(mu[k].item()),
                                                         1e-30)
    errs["gradients"] = max(pd_rel(a, b) for a, b in zip(gs, gu))
    check(errs["loss"] <= LM18_LOSS_RTOL,
          f"{cfg.name} on {shape}: loss {ls.item()} vs unsharded "
          f"{lu.item()}: {errs['loss']} > {LM18_LOSS_RTOL}")
    check(errs["gradients"] <= LM18_RTOL or not gate_gradients,
          f"{cfg.name} on {shape}: gradients {errs['gradients']} of a "
          f"leaf's max > {LM18_RTOL}")
    return errs, lu.item()


def replicas_equal(state):
    """Every block of every ``Placed`` leaf of ``state`` bitwise equal to
    the other replicas of its block."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.optim.sgd import tree_leaves
    for t in tree_leaves(state):
        if not isinstance(t, shd.Placed):
            continue
        first = {}
        for b, sl in zip(t.blocks, t.sharding.slices(t.shape)):
            key = tuple((x.start, x.stop) for x in sl)
            if key in first and not torch.equal(first[key], b):
                return False
            first.setdefault(key, b)
    return True


def lm18_train(dev, ops, p12_first_loss, p12_p50):
    """(a) and (d) -> (launches of the counted run, readings)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.swd import draw, seeded_generator
    from repro_torch.data.tokens import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import Trainer
    name, n_layers, B, S, warm, timed, shape = LM18_TRAIN
    cfg = get_config(name)
    if n_layers:
        from dataclasses import replace
        cfg = replace(cfg, n_layers=n_layers)
    L, n = cfg.n_layers, int(np.prod(shape))
    tcfg = lm_train_cfg(warm + timed, S)
    data_fn = lambda step: random_batch(  # noqa: E731
        torch.Generator(device=dev).manual_seed(100 + step), cfg.vocab, B, S)
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
    draws = draw(seeded_generator(tcfg.seed, 0, dev), 50,
                 B * (S // tcfg.hybrid_pool), cfg.d_model)
    errs, loss0 = lm18_against_unsharded(cfg, tcfg, shape, params,
                                         data_fn(0), draws, times=2)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rules = lm18_rules(cfg, shape, B)
    with shd.axis_rules(rules):
        trainer = Trainer(cfg, tcfg, data_fn, device=dev)
    trainer.run(warm, log_every=0)
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    trainer.run(timed, log_every=0)
    launches = {k: w.launches for k, w in ops.KERNELS.items()}
    want = {"flash_attention_fwd": 2 * L * n * timed,
            "flash_attention_bwd_dq": L * n * timed,
            "flash_attention_bwd_dkv": L * n * timed,
            "swd_rank_fwd": timed, "laplacian_energy": timed,
            "hybrid_reg_bwd": timed}
    check(launches == {k: want.get(k, 0) for k in launches},
          f"sharded {name}: launches {launches} in {timed} steps, want "
          f"{want} (per shard 2 flash forwards a layer under remat, 1 dq and"
          " 1 dk/dv a layer; the hybrid term once a step) and no other")
    check(replicas_equal(trainer.state),
          f"sharded {name}: replicas of a block differ after the steps")
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"sharded {name}: losses {losses} not finite and falling")
    p12_err = abs(losses[0] - p12_first_loss) / abs(p12_first_loss)
    check(p12_err <= LM18_LOSS_RTOL,
          f"sharded {name}: step 0 loss {losses[0]} vs phase 12's "
          f"{p12_first_loss}: {p12_err} > {LM18_LOSS_RTOL}")
    times = [h["time_s"] * 1e3 for h in hist[warm:]]
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    peak = torch.cuda.max_memory_allocated()
    out = {"name": name, "mesh": list(shape), "B": B, "S": S,
           "step0_vs_unsharded": errs, "step0_loss_vs_phase12": p12_err,
           "step_ms_p50": p50, "step_ms_p95": p95,
           "phase12_step_ms_p50": p12_p50,
           "tokens_per_s": B * S / (p50 / 1e3), "peak_bytes": peak,
           "loss_first": losses[0], "loss_last": losses[-1]}
    print(f"phase 18 (a): {name} at full width ({L} layers) on (data, "
          f"model) = {shape} logical shards of the card, B {B} x S {S}, "
          f"AdamW, hybrid, remat; step 0 vs the unsharded port: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + f" (bitwise from "
          f"run to run); Trainer {warm} + {timed} steps: step ms p50 "
          f"{p50:.3f} (p95 {p95:.3f}) beside phase 12's p50 {p12_p50:.3f}, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {peak / 1e9:.3f} GB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (step 0 vs phase 12 "
          f"{p12_err:.3e}); replicas bitwise equal; launches " + ", ".join(
              f"{k} {launches[k]}" for k in LM_PATH_KERNELS))
    out["profile"] = profile_train_lm_step(trainer, p50)
    out["elastic"] = lm18_elastic(cfg, tcfg, trainer, data_fn, B)
    return launches, out


def lm18_elastic(cfg, tcfg, trainer, data_fn, B):
    """(d): ``trainer``'s state saved, resharded onto two shards, bitwise,
    and one more step there -> readings."""
    import tempfile

    from repro_torch.checkpoint.elastic import (largest_feasible_mesh,
                                                reshard_state)
    from repro_torch.checkpoint.manager import CheckpointManager, snapshot
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import Trainer
    t0 = time.perf_counter()
    step = trainer.step
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        saved = snapshot(trainer.state)
        del trainer
        torch.cuda.empty_cache()
        mgr.save(step, saved)
        restored, at = mgr.restore_latest(saved)
    check(at == step, f"elastic: restored step {at}, saved {step}")
    mesh2 = largest_feasible_mesh([torch.device(CARD)] * 2,
                                  model_divisors={1, 2})
    check(mesh2 is not None and mesh2.shape == {"data": 1, "model": 2},
          f"elastic: largest_feasible_mesh gave {mesh2}")
    axes = lm.param_axes(cfg)
    state = {"params": reshard_state(restored["params"], axes, mesh2),
             "opt": {"m": reshard_state(restored["opt"]["m"], axes, mesh2),
                     "v": reshard_state(restored["opt"]["v"], axes, mesh2),
                     "step": reshard_state(restored["opt"]["step"], (),
                                           mesh2)},
             "step": torch.as_tensor(restored["step"]).to(CARD)}
    got = shd.gather_tree(state)
    from repro_torch.checkpoint.serial import _paths
    for (k, a), (_, b) in zip(_paths(got), _paths(saved)):
        check(torch.equal(a.cpu(), torch.from_numpy(b)),
              f"elastic: {k} not bitwise what was saved")
    reshard_s = time.perf_counter() - t0
    with shd.axis_rules(shd.rules_for(mesh2, cfg, batch=B, kind="train")):
        t2 = Trainer(cfg, tcfg, data_fn, device=CARD)
    for (k, a), (_, b) in zip(_paths(t2.state["params"]),
                              _paths(state["params"])):
        check(tuple(a.sharding.spec) == tuple(b.sharding.spec),
              f"elastic: {k} laid out as {b.sharding.spec}, the trainer's "
              f"rules say {a.sharding.spec}")
    t2.state = state
    t2._step = step
    m = t2.run(1, log_every=0)[-1]
    check(np.isfinite(m["loss"]), f"elastic: step {step} loss {m['loss']}")
    out = {"mesh": mesh2.shape, "step": step, "loss": m["loss"],
           "save_restore_reshard_s": reshard_s}
    print(f"phase 18 (d): state at step {step} saved, restored and "
          f"resharded onto {mesh2.shape} (largest_feasible_mesh over 2 "
          f"shards, model_divisors {{1, 2}}) in {reshard_s:.2f} s, bitwise "
          f"what was saved; one more step there: loss {m['loss']:.4f}")
    del t2, state, got
    torch.cuda.empty_cache()
    return out


def lm18_row_parallel(dev, ops):
    """(b) -> readings."""
    from dataclasses import replace

    from repro_torch.configs.base import get_config
    from repro_torch.core.swd import draw, seeded_generator
    from repro_torch.data.tokens import random_batch
    from repro_torch.models import lm
    name, layers, B, S, shape = LM18_ROW
    cfg = replace(get_config(name), n_layers=layers)
    tcfg = lm_train_cfg(1, S)
    rules = lm18_rules(cfg, shape, B)
    check(rules.param_rules["kv_in"] == "model"
          and rules.param_rules["heads"] == "model",
          f"{name} on {shape}: not the row-parallel kv fallback "
          f"({rules.param_rules})")
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(1))
    batch = random_batch(torch.Generator(device=dev).manual_seed(2),
                         cfg.vocab, B, S)
    draws = draw(seeded_generator(0, 1, dev), 50,
                 B * (S // tcfg.hybrid_pool), cfg.d_model)
    for w in ops.KERNELS.values():
        w.launches = 0
    errs, _ = lm18_against_unsharded(cfg, tcfg, shape, params, batch, draws,
                                     times=1)
    n, L = int(np.prod(shape)), cfg.n_layers
    got = ops.KERNELS["flash_attention_bwd_dq"].launches
    check(got == L + L * n, f"{name} on {shape}: {got} dq launches, want "
          f"{L} unsharded + {L * n} sharded")
    print(f"phase 18 (b): {name} cut to {L} layers on (data, model) = "
          f"{shape}, B {B} x S {S}: q column-parallel, k and v row-parallel "
          f"(kv heads {cfg.n_kv_heads} over {shape[1]}), each shard's q head "
          "meeting its kv head; step 0 vs the unsharded port: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()))
    del params
    torch.cuda.empty_cache()
    return {"name": name, "layers": L, "mesh": list(shape),
            "step0_vs_unsharded": errs}


def lm18_moe(dev, ops):
    """(c) -> readings."""
    from repro_torch.data.tokens import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.trainer import TrainCfg, Trainer
    name, layers, experts, B, S, shape = LM18_MOE
    cfg = pd_config(name, layers, experts)
    rules = lm18_rules(cfg, shape, B)
    data_fn = lambda step: random_batch(  # noqa: E731
        torch.Generator(device=dev).manual_seed(300 + step), cfg.vocab, B, S)
    torch.cuda.empty_cache()
    with shd.axis_rules(rules):
        trainer = Trainer(cfg, TrainCfg(total_steps=1, warmup=1), data_fn,
                          device=dev)
        lay = trainer.layout
        ps = shd.local_trees(trainer.state["params"], lay.n)
        batch = {k: lay.batch_blocks(v.to(dev))
                 for k, v in data_fn(0).items()}
        with torch.no_grad():
            hs, aux = lm.forward_sharded(lay, cfg, ps, tokens=batch["tokens"])
        fwd_ok = all(torch.isfinite(h).all().item() for h in hs)
        m = trainer.run(1, log_every=0)[-1]
    check(fwd_ok and np.isfinite(m["loss"]),
          f"{name} on {shape}: forward finite {fwd_ok}, step loss "
          f"{m['loss']}")
    # one layer's MoE at its params, on random unit-scale inputs
    moe_p = shd.gather_tree({k: shd.map_placed(
        lambda t: shd.Placed([b[0] for b in t.blocks], shd.NamedSharding(
            t.sharding.mesh, t.sharding.spec[1:]), t.shape[1:]), v)
        for k, v in trainer.state["params"]["blocks"]["layers"]["moe"].items()})
    del trainer, ps, hs
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(B, S, cfg.d_model, device=dev, generator=g)
    mc = cfg.moe
    with torch.no_grad():
        ref, aux_ref = moe_mod.moe_reference(moe_p, mc, x)
        lay = shd.ShardLayout(rules)
        with shd.axis_rules(rules):
            y8, aux8 = moe_mod.moe_ep(moe_p, mc, x, cap_factor=8.0)
            ys = moe_mod.moe_ep_sharded(
                lay, shd.local_trees(shd.place_tree(
                    moe_p, shd.param_sharding(moe_mod._moe_axes(mc))),
                    lay.n), mc, lay.batch_blocks(x), with_drops=True)
            y_dev = lay.gather_batch(ys[0])
            dropped = int(sum(d.item() for d in ys[2]))
            x1 = x[:, :1]
            y1, _ = moe_mod.moe_ep(moe_p, mc, x1)
            r1, _ = moe_mod.moe_reference(moe_p, mc, x1)
        cpu_mesh = make_test_mesh(shape, devices=[LM18_CPU]
                                  * int(np.prod(shape)))
        cpu_rules = shd.rules_for(cpu_mesh, cfg, batch=B, kind="train")
        with shd.axis_rules(cpu_rules):
            y_cpu, _ = moe_mod.moe_ep(_to_cpu(moe_p), mc, x.to(LM18_CPU))
    err8 = (y8 - ref).abs().max().item()
    aux_err = abs(aux8.item() - aux_ref.item()) / abs(aux_ref.item())
    err_cpu = rel_err(y_dev.cpu(), y_cpu)
    err1 = (y1 - r1).abs().max().item()
    check(err8 <= MOE_EP_ATOL and aux_err <= 1e-4,
          f"moe_ep (cap 8.0) vs moe_reference: y {err8} > {MOE_EP_ATOL} or "
          f"aux {aux_err} > 1e-4")
    check(err_cpu <= LM18_RTOL, f"moe_ep (cap 1.25) card vs CPU: {err_cpu} "
          f"of the max > {LM18_RTOL}")
    check(err1 <= MOE_EP_ATOL, f"moe_ep at S = 1 (replicated) vs "
          f"moe_reference: {err1} > {MOE_EP_ATOL}")
    copies = B * S * mc.top_k
    print(f"phase 18 (c): {name} cut to {layers} layers and {experts} "
          f"experts on (data, model) = {shape}, B {B} x S {S}: forward "
          f"finite, one Trainer step loss {m['loss']:.4f}; a layer's moe_ep "
          f"at cap 8.0 vs moe_reference: y {err8:.3e}, aux {aux_err:.3e}; "
          f"at cap 1.25 card vs CPU {err_cpu:.3e} of the max, dropped "
          f"{dropped} of {copies} copies; S = 1 (replicated path) vs "
          f"moe_reference {err1:.3e}")
    return {"name": name, "layers": layers, "experts": experts,
            "mesh": list(shape), "step_loss": m["loss"],
            "ep_cap8_vs_reference": err8, "aux_rel": aux_err,
            "ep_card_vs_cpu": err_cpu, "dropped": dropped,
            "copies": copies, "replicated_vs_reference": err1}


def _to_cpu(tree):
    return {k: _to_cpu(v) if isinstance(v, dict) else v.to(LM18_CPU)
            for k, v in tree.items()}


LM18_FLASH = ((8 // 2, 16 // 2, 16 // 2, 1024, 1024, 64, True),
              (4, 16 // 16, 1, 1024, 1024, 128, True),
              (2, 56 // 4, 8 // 4, 256, 256, 128, True))


def hold_sharded_flash(dev, ops):
    """The flash kernels at each shard's block in (a), (b), (c) against
    their plain versions (phase 9's atols; phase 11's 1e-5 of each
    gradient's max), bitwise from run to run, and timed at (a)'s ->
    ({name: max |err|}, times)."""
    g = torch.Generator(device=dev).manual_seed(18)
    worst = dict.fromkeys(("flash_attention_fwd",) + BWD_KERNELS, 0.0)
    for B, H, KV, Sq, Sk, hd, causal in LM18_FLASH:
        what = f"B={B} H={H} KV={KV} S={Sq} hd={hd}"
        q, k, v = flash_inputs(g, dev, B, H, KV, Sq, Sk, hd)
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], hold(
            "flash_attention_fwd",
            lambda q, k, v: ops.flash_attention_fwd(q, k, v, causal=causal),
            lambda q, k, v: ops.flash_attention_ref(q, k, v, causal),
            (q, k, v), [(0.0, FLASH_O_ATOL), (0.0, FLASH_LSE_ATOL)], what))
        do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        args = (q, k, v, do, lse, (do * o).sum(-1))
        (dq,) = same_bits(lambda *a: (ops.flash_attention_bwd_dq(
            *a, causal=causal),), args, f"dq at {what}")
        dk, dv = same_bits(lambda *a: ops.flash_attention_bwd_dkv(
            *a, causal=causal), args, f"dk/dv at {what}")
        plain = (ops.flash_attention_bwd_dq_ref(*args, causal),
                 *ops.flash_attention_bwd_dkv_ref(*args, causal))
        err = rel_grads((dq, dk, dv), plain)
        check(err <= FLASH_BWD_RTOL, f"flash backward != plain at {what}: "
              f"{err} > {FLASH_BWD_RTOL}")
        worst["flash_attention_bwd_dq"] = max(
            worst["flash_attention_bwd_dq"],
            (dq - plain[0]).abs().max().item())
        worst["flash_attention_bwd_dkv"] = max(
            worst["flash_attention_bwd_dkv"],
            (dk - plain[1]).abs().max().item(),
            (dv - plain[2]).abs().max().item())
    B, H, KV, Sq, Sk, hd, causal = LM18_FLASH[0]
    q, k, v = flash_inputs(g, dev, B, H, KV, Sq, Sk, hd)
    do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    times = {"shape": [B, H, KV, Sq, Sk, hd],
             "flash_attention_fwd": device_ms(
                 lambda a: ops.flash_attention_fwd(*a, causal=True),
                 (q, k, v)),
             "flash_attention_bwd_dq": device_ms(
                 lambda a: ops.flash_attention_bwd_dq(*a, causal=True), args),
             "flash_attention_bwd_dkv": device_ms(
                 lambda a: ops.flash_attention_bwd_dkv(*a, causal=True),
                 args)}
    for w in ops.KERNELS.values():
        w.launches = 0
    print("phase 18: flash kernels at the per-shard shapes (B, H, KV, Sq, "
          f"Sk, hd, causal) {LM18_FLASH} == plain (o atol {FLASH_O_ATOL}, "
          f"lse atol {FLASH_LSE_ATOL}; backward {FLASH_BWD_RTOL} of each "
          "gradient's max), bitwise from run to run; max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()) + "; device ms at "
          f"{times['shape']}: " + ", ".join(
              f"{k} {times[k]:.3f}" for k in worst))
    return worst, times


def phase18(dev, ops, p12_first_loss, p12_p50):
    """The LM half of sharding on the card -> (the ``sharded_lm`` path's
    launch counts, the readings, max |err| by flash kernel at the
    per-shard shapes)."""
    start = time.perf_counter()
    worst, times = hold_sharded_flash(dev, ops)
    launches, train = lm18_train(dev, ops, p12_first_loss, p12_p50)
    readings = {"train": train, "row_parallel": lm18_row_parallel(dev, ops),
                "moe": lm18_moe(dev, ops), "flash_ms": times}
    readings["seconds"] = time.perf_counter() - start
    print(f"phase 18: {readings['seconds']:.1f} s")
    return launches, readings, worst


# phase 19: the rest of the LM on a mesh, logical shards of the card
# training runs: (name, layers or None, B, S, warm-up, counted steps, mesh,
# fsdp); each step 0 also runs unsharded in the same call
LM19_TRAIN = (("mamba2-780m", None, 8, 1024, 1, 2, (2, 2), False),
              ("zamba2-1.2b", 13, 4, 1024, 1, 2, (2, 2), False),
              ("qwen3-1.7b", None, 4, 1024, 1, 2, (2, 2), True))
# (c)'s checkpoint: the same FSDP run cut to 2 layers (its full state,
# 20.6 GB with AdamW's moments, would take ~100 s to save and restore at
# phase 18's measured rate), one step on (2, 2), restored onto (1, 2)
LM19_RESTORE = ("qwen3-1.7b", 2, 4, 1024, (2, 2), (1, 2))
# prefill and decode: (name, layers, experts, B, prompt, max_len, decode
# steps, mesh); every run under rules_for(kind="decode"); 8 steps (32
# before phase 21 was added), 4 on 16 shards, whose step is 16x the
# launches (1.35 s)
LM19_DECODE = (("qwen3-1.7b", None, None, 4, 1024, 1024 + 64, 8, (2, 2)),
               ("qwen3-1.7b", None, None, 4, 1024, 1024 + 64, 4, (1, 16)),
               ("zamba2-1.2b", None, None, 1, 4096, 131072, 8, (2, 2)),
               ("mamba2-780m", None, None, 1, 4096, 524288, 8, (2, 2)),
               ("arctic-480b", 2, 8, 2, 256, 256 + 64, 8, (1, 4)))
# sharded vs unsharded decode logits, of the max |logit|: the attention
# families' bar, and the families with mamba layers', set from the first
# chip reading (mamba2-780m 9.358e-04, zamba2-1.2b 3.688e-05 in decode;
# 2.701e-04, 4.030e-05 in prefill) below phase 14's PD_SSM_RTOL
LM19_RTOL = 1e-4
LM19_SSM_RTOL = 3e-3
# the flash kernels at this phase's per-shard shapes (B, H, KV, Sq, Sk,
# hd): (b)'s shared block and (c)'s layers in training (forward, dq,
# dk/dv), then the prefills' (forward): qwen3-1.7b on (2, 2) is (c)'s, on
# (1, 16) one q head meeting its kv head, zamba2's batch-1 prompt, the
# arctic cut on (1, 4)
LM19_FLASH_TRAIN = ((2, 16, 16, 1024, 1024, 64), (2, 8, 4, 1024, 1024, 128))
LM19_FLASH_PREFILL = ((4, 1, 1, 1024, 1024, 128),
                      (1, 16, 16, 4096, 4096, 64),
                      (2, 14, 2, 256, 256, 128))


def lm19_train(dev, ops, spec, launches):
    """One of (a)-(c): step 0 on the mesh against the unsharded port
    (bitwise run to run), then ``Trainer`` under the rules for warm-up +
    counted steps (the counts set to 0 before the counted ones and added
    to ``launches``), replicas bitwise after every step -> readings."""
    from repro_torch.checkpoint.serial import _paths
    from repro_torch.core.swd import draw, seeded_generator
    from repro_torch.data.tokens import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import Trainer
    name, layers, B, S, warm, timed, shape, fsdp = spec
    cfg = pd_config(name, layers, None)
    tcfg = lm_train_cfg(warm + timed, S)
    n = int(np.prod(shape))
    data_fn = lambda step: random_batch(  # noqa: E731
        torch.Generator(device=dev).manual_seed(190 + step), cfg.vocab, B, S)
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(19))
    draws = draw(seeded_generator(tcfg.seed, 0, dev), 50,
                 B * (S // tcfg.hybrid_pool), cfg.d_model)
    mamba = cfg.family in ("ssm", "hybrid")
    errs, _ = lm18_against_unsharded(cfg, tcfg, shape, params, data_fn(0),
                                     draws, times=2, fsdp=fsdp,
                                     gate_gradients=not mamba)
    if mamba:
        errs["float64 gradients"] = lm19_float64_grads(
            cfg, shape, params, data_fn(0), fsdp)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rules = lm18_rules(cfg, shape, B, fsdp=fsdp)
    with shd.axis_rules(rules):
        trainer = Trainer(cfg, tcfg, data_fn, device=dev)
    for k, t in _paths(trainer.state["params"]):
        want = [tuple(s.stop - s.start for s in sl)
                for sl in t.sharding.slices(t.shape)]
        check([tuple(b.shape) for b in t.blocks] == want,
              f"{name}: {k} blocks {[tuple(b.shape) for b in t.blocks]} "
              f"under spec {t.sharding.spec}, want {want}")
    if fsdp:
        split = [k for k, t in _paths(trainer.state["params"])
                 if "data" in shd.spec_axes(t.sharding.spec)]
        check(split, f"{name}: FSDP rules split no param over 'data'")
    for _ in range(warm):
        trainer.run(1, log_every=0)
        check(replicas_equal(trainer.state), f"{name}: replicas differ")
    zero_counts(ops)
    for _ in range(timed):
        trainer.run(1, log_every=0)
        check(replicas_equal(trainer.state), f"{name}: replicas of a block "
              "differ after a step")
    got = read_counts(ops)
    add_counts(launches, got)
    G = (cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid"
         else 0 if cfg.family == "ssm" else cfg.n_layers)
    want = {"swd_rank_fwd": timed, "laplacian_energy": timed,
            "hybrid_reg_bwd": timed}
    if G:
        want.update(flash_attention_fwd=2 * G * n * timed,
                    flash_attention_bwd_dq=G * n * timed,
                    flash_attention_bwd_dkv=G * n * timed)
    check(got == {k: want.get(k, 0) for k in got},
          f"{name} on {shape}: launches {got} in {timed} steps, want {want}"
          " (per shard 2 flash forwards an attention layer or shared-block "
          "use under remat, 1 dq and 1 dk/dv; the hybrid term once a step)")
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    check(all(np.isfinite(losses)), f"{name}: losses {losses}")
    times = [h["time_s"] * 1e3 for h in hist[warm:]]
    p50, p95 = float(np.percentile(times, 50)), float(np.percentile(times, 95))
    peak = torch.cuda.max_memory_allocated()
    out = {"name": name, "layers": cfg.n_layers, "mesh": list(shape),
           "fsdp": fsdp, "B": B, "S": S, "step0_vs_unsharded": errs,
           "step_ms_p50": p50, "step_ms_p95": p95,
           "tokens_per_s": B * S / (p50 / 1e3), "peak_bytes": peak,
           "losses": losses, "launches": got}
    print(f"phase 19: {name} ({cfg.n_layers} layers, full width) on (data, "
          f"model) = {shape}{' under FSDP' if fsdp else ''}, B {B} x S {S}, "
          "AdamW, hybrid, remat; step 0 vs the unsharded port: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items()) + " (bitwise run to "
          f"run); Trainer {warm} + {timed} steps: step ms p50 {p50:.3f} (p95 "
          f"{p95:.3f}), {out['tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 1e9:.3f} GB; losses {[round(x, 4) for x in losses]}; "
          f"replicas bitwise after every step; launches {got}")
    del trainer
    torch.cuda.empty_cache()
    return out


def lm19_float64_grads(cfg, shape, params, batch, fsdp):
    """Step 0's gradients (the hybrid term off: its kernels take float32)
    unsharded and on the mesh with the port in float64, on the first two
    rows -> the worst gathered gradient's distance, of its leaf's max,
    gated at LM18_RTOL.  In float32 a mamba layer amplifies the rounding
    of its input: at full depth the float32 gradient itself is not
    determined to that bar (the unsharded float32 gradient is up to
    3.9e-3 of a leaf's max from a float64 run at 12 of mamba2's layers,
    the mesh's 2.9e-3; ``tools/mamba_grad_precision.py``),
    so float64 is where the mesh's arithmetic is held to the unsharded
    step's."""
    from dataclasses import replace

    from repro_torch.optim.sgd import value_and_grad
    from repro_torch.runtime import trainer as tr
    c64 = replace(cfg, dtype="float64", param_dtype="float64")
    tcfg = replace(lm_train_cfg(1, batch["tokens"].shape[1]), hybrid=False)
    rows = {k: v[:2] for k, v in batch.items()}
    p64 = map_tree(params, torch.Tensor.double)
    with float64_port():
        (lu, _), gu = value_and_grad(tr.make_loss_fn(c64, tcfg), p64, rows,
                                     None)
        _, _, gs = lm18_grads(c64, tcfg, lm18_rules(c64, shape, 2, fsdp),
                              p64, rows, None)
    del p64
    err = max(pd_rel(a, b) for a, b in zip(gs, gu))
    check(err <= LM18_RTOL, f"{cfg.name} on {shape} in float64: gradients "
          f"{err} of a leaf's max > {LM18_RTOL}")
    del gu, gs
    torch.cuda.empty_cache()
    return err


def lm19_restore(dev):
    """(c)'s checkpoint: an FSDP trainer's state saved through
    ``CheckpointManager``, restored, laid onto another mesh by
    ``reshard_state(..., fsdp=True)`` (bitwise what was saved), taken by
    a trainer under FSDP rules there, which trains one step -> readings."""
    import tempfile

    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.checkpoint.manager import CheckpointManager, snapshot
    from repro_torch.checkpoint.serial import _paths
    from repro_torch.data.tokens import random_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import Trainer
    name, layers, B, S, shape, shape2 = LM19_RESTORE
    cfg = pd_config(name, layers, None)
    tcfg = lm_train_cfg(2, S)
    data_fn = lambda step: random_batch(  # noqa: E731
        torch.Generator(device=dev).manual_seed(290 + step), cfg.vocab, B, S)
    with shd.axis_rules(lm18_rules(cfg, shape, B, fsdp=True)):
        trainer = Trainer(cfg, tcfg, data_fn, device=dev)
    trainer.run(1, log_every=0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        saved = snapshot(trainer.state)
        del trainer
        torch.cuda.empty_cache()
        mgr.save(1, saved)
        restored, at = mgr.restore_latest(saved)
    check(at == 1, f"FSDP restore: step {at}")
    mesh2 = lm18_mesh(shape2)
    axes = lm.param_axes(cfg)
    state = {"params": reshard_state(restored["params"], axes, mesh2,
                                     fsdp=True),
             "opt": {k: reshard_state(restored["opt"][k], axes, mesh2,
                                      fsdp=True) for k in ("m", "v")},
             "step": torch.as_tensor(restored["step"])}
    state["opt"]["step"] = torch.as_tensor(restored["opt"]["step"])
    for (k, a), (_, b) in zip(_paths(shd.gather_tree(state)), _paths(saved)):
        check(torch.equal(torch.as_tensor(a).cpu(), torch.from_numpy(
            np.asarray(b))), f"FSDP restore: {k} not bitwise what was saved")
    emb = state["params"]["embed"]["table"]
    check("data" in shd.spec_axes(emb.sharding.spec),
          f"reshard_state(fsdp=True) laid the table out as "
          f"{emb.sharding.spec}")
    seconds = time.perf_counter() - t0
    with shd.axis_rules(lm18_rules(cfg, shape2, B, fsdp=True)):
        t2 = Trainer(cfg, tcfg, data_fn, device=dev)
    t2.load_state(state)
    del state
    m = t2.run(1, log_every=0)[-1]
    check(np.isfinite(m["loss"]) and replicas_equal(t2.state),
          f"FSDP restore: step loss {m['loss']}, replicas equal "
          f"{replicas_equal(t2.state)}")
    out = {"name": name, "layers": layers, "from": list(shape),
           "to": list(shape2), "save_restore_reshard_s": seconds,
           "loss": m["loss"]}
    print(f"phase 19 (c): {name} cut to {layers} layers, one FSDP step on "
          f"{shape}, saved, restored and resharded onto {shape2} with "
          f"fsdp=True in {seconds:.2f} s, bitwise what was saved; one step "
          f"there under FSDP rules: loss {m['loss']:.4f}")
    del t2
    torch.cuda.empty_cache()
    return out


def lm19_decode_steps(cfg, params, st, fed, rules):
    """The steps of (d) on the mesh, ``fed[:, t]`` the token of step t,
    each under ``set_sync_debug_mode("error")``, the state's blocks at
    fixed ``data_ptr``s -> (logits (steps, B, V), step ms)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    ptrs = lm19_ptrs(st)
    B, steps = fed.shape
    out = torch.empty((steps, B, cfg.vocab), device=fed.device)
    ms = []
    with shd.axis_rules(rules):
        for t in range(steps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, st2 = lm.decode_step(cfg, params, st, fed[:, t])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
            check(st2 is st and lm19_ptrs(st) == ptrs,
                  f"{cfg.name} decode step {t}: the state moved")
            out[t].copy_(logits)
    return out, ms


def lm19_ptrs(st):
    return [b.data_ptr() for v in st.values() for b in v.blocks]


def lm19_greedy_misses(ref, got, err):
    """Steps and rows whose greedy token differs, where the unsharded top
    two logits lie further apart than twice the step's max |err| (a
    nearer pair is a tie at this precision) -> (misses, near ties)."""
    top = ref.topk(2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    differ = ref.argmax(-1) != got.argmax(-1)
    tie = gap <= 2 * err
    return int((differ & ~tie).sum()), int((differ & tie).sum())


def lm19_decode(dev, ops, spec, launches):
    """One prefill-and-decode run of (d): the unsharded port's prefill and
    greedy steps, then the same on the mesh fed the same tokens (the
    counts set to 0 before the mesh's prefill and steps and added to
    ``launches``) -> readings."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.weights import lm_to_mesh
    name, layers, experts, B, S, max_len, steps, shape = spec
    cfg = pd_config(name, layers, experts)
    n = int(np.prod(shape))
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(29))
    g = torch.Generator(device=dev).manual_seed(39)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    with torch.inference_mode():
        st, first = lm.prefill(cfg, params, tokens=toks, max_len=max_len)
        fed = torch.empty((B, steps), dtype=toks.dtype, device=dev)
        ref = torch.empty((steps, B, cfg.vocab), device=dev)
        logits = first
        for t in range(steps):
            fed[:, t] = logits.argmax(-1)
            logits, _ = lm.decode_step(cfg, params, st, fed[:, t])
            ref[t].copy_(logits)
        del st
    rules = shd.rules_for(lm18_mesh(shape), cfg, batch=B, kind="decode")
    pm = lm_to_mesh(params, cfg, rules, copy=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    with torch.inference_mode(), shd.axis_rules(rules):
        # warm-up at the served shapes, the flash calls recorded
        with record_flash(calls):
            st, first_s = lm.prefill(cfg, pm, tokens=toks, max_len=max_len)
        lm.decode_step(cfg, pm, st, fed[:, 0])
        del st
        flash_worst = 0.0
        for q, k, v, causal, scale in calls:
            flash_worst = max(flash_worst, hold(
                "flash_attention_fwd",
                lambda q, k, v: ops.flash_attention_fwd(
                    q, k, v, causal=causal, scale=scale),
                lambda q, k, v: ops.flash_attention_ref(q, k, v, causal,
                                                        scale),
                (q, k, v), [(0.0, FLASH_O_ATOL), (0.0, FLASH_LSE_ATOL)],
                f"{name} on {shape} prefill: q {tuple(q.shape)}, k "
                f"{tuple(k.shape)}"))
        shapes = sorted({(tuple(q.shape), tuple(k.shape))
                         for q, k, _, _, _ in calls})
        del calls
        zero_counts(ops)
        torch.cuda.synchronize()
        start = time.perf_counter()
        st, first_s = lm.prefill(cfg, pm, tokens=toks, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - start) * 1e3
        pre = read_counts(ops)
        attn = (cfg.n_layers // cfg.hybrid_period if cfg.family == "hybrid"
                else 0 if cfg.family == "ssm" else cfg.n_layers)
        check(pre == {k: (attn * n if k == "flash_attention_fwd" else 0)
                      for k in pre},
              f"{name} on {shape}: the prefill launched {pre}, want "
              f"{attn * n} flash forwards (one an attention layer a shard) "
              "and no other kernel")
    zero_counts(ops)
    with torch.inference_mode():
        got, step_ms = lm19_decode_steps(cfg, pm, st, fed, rules)
    dec = read_counts(ops)
    check(not any(dec.values()), f"{name} on {shape}: decode launched {dec}")
    add_counts(launches, pre)
    index = [int(i) for i in st["index"].blocks]
    check(index == [S + steps] * n, f"{name}: index {index}")
    p50 = float(np.percentile(step_ms, 50))
    with torch.inference_mode(), shd.axis_rules(rules):
        prof = profile_decode_step(cfg, pm, st, fed[:, -1], p50)
    check(prof["syncs"] == 0 and prof["h2d"] == 0 and prof["d2h"] == 0,
          f"{name} on {shape}: the profiled sharded decode step synced or "
          f"copied to or from the host: {prof}")
    peak = torch.cuda.max_memory_allocated()
    bar = LM19_SSM_RTOL if cfg.family in ("ssm", "hybrid") else LM19_RTOL
    prefill_err = pd_rel(first_s, first)
    step_err = [pd_rel(a, b) for a, b in zip(got, ref)]
    errs = {"prefill": prefill_err, "decode": max(step_err)}
    abs_err = [(a - b).abs().max().item() for a, b in zip(got, ref)]
    misses, ties = lm19_greedy_misses(
        ref, got, torch.tensor(abs_err, device=dev)[:, None])
    first_miss = lm19_greedy_misses(first[None], first_s[None], torch.full(
        (1, 1), (first_s - first).abs().max().item(), device=dev))
    check(max(errs.values()) <= bar, f"{name} on {shape}: sharded vs "
          f"unsharded logits {errs} of the max > {bar}")
    check(misses == 0 and first_miss[0] == 0,
          f"{name} on {shape}: {misses} decode and {first_miss[0]} prefill "
          "greedy tokens differ from the unsharded port's beyond a near-tie")
    kv_seq = rules.act_rules["kv_seq"] if "k" in st else None
    rec = {"name": name, "layers": cfg.n_layers, "mesh": list(shape), "B": B,
           "prompt": S, "max_len": max_len, "steps": steps,
           "kv_heads_split": rules.act_rules["kv_heads"],
           "kv_seq_split": kv_seq, "vs_unsharded": errs, "bar": bar,
           "greedy_near_ties": ties + first_miss[1],
           "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
           "decode_p50_ms": p50,
           "decode_p95_ms": float(np.percentile(step_ms, 95)),
           "decode_tokens_per_s": B / p50 * 1e3, "peak_bytes": peak,
           "cache_bytes": sum(b.numel() * b.element_size()
                              for k in ("k", "v") if k in st
                              for b in st[k].blocks),
           "flash_launches": pre["flash_attention_fwd"],
           "flash_shapes": [list(q) + list(k) for q, k in shapes],
           "flash_err": flash_worst, "profile": prof}
    print(f"phase 19 (d): {name} ({cfg.n_layers} layers) on {shape}, B {B}, "
          f"prompt {S}, max_len {max_len}: kv heads over "
          f"{rec['kv_heads_split']}, kv positions over {kv_seq}; vs the "
          f"unsharded port prefill {prefill_err:.3e}, decode "
          f"{errs['decode']:.3e} of the max (bar {bar}), greedy tokens equal "
          f"({rec['greedy_near_ties']} near-ties); prefill {prefill_ms:.3f} "
          f"ms ({rec['prefill_tokens_per_s']:.1f} tokens/s), decode p50 "
          f"{p50:.3f} ms (p95 {rec['decode_p95_ms']:.3f}), peak "
          f"{peak / 1e9:.3f} GB; {pre['flash_attention_fwd']} flash launches "
          f"a prefill (held, max |err| {flash_worst:.3e}), none a step; steps "
          "under set_sync_debug_mode('error'), data_ptrs fixed; profiled "
          f"step: {prof['launches']} launches, no sync or copy, idle share "
          f"{prof['idle_share']:.3f}")
    del st, pm, params, ref, got
    torch.cuda.empty_cache()
    return rec


def hold_lm19_flash(dev, ops):
    """The flash kernels at this phase's per-shard shapes against their
    plain versions (phase 9's atols; phase 11's 1e-5 of each gradient's
    max), bitwise run to run, each timed -> ({name: max |err|}, [{shape,
    name: device ms}])."""
    g = torch.Generator(device=dev).manual_seed(19)
    worst = dict.fromkeys(("flash_attention_fwd",) + BWD_KERNELS, 0.0)
    times = []
    for shape in LM19_FLASH_TRAIN + LM19_FLASH_PREFILL:
        B, H, KV, Sq, Sk, hd = shape
        what = f"B={B} H={H} KV={KV} S={Sq} hd={hd}"
        q, k, v = flash_inputs(g, dev, B, H, KV, Sq, Sk, hd)
        worst["flash_attention_fwd"] = max(worst["flash_attention_fwd"], hold(
            "flash_attention_fwd",
            lambda q, k, v: ops.flash_attention_fwd(q, k, v, causal=True),
            lambda q, k, v: ops.flash_attention_ref(q, k, v, True),
            (q, k, v), [(0.0, FLASH_O_ATOL), (0.0, FLASH_LSE_ATOL)], what))
        row = {"shape": list(shape), "flash_attention_fwd": device_ms(
            lambda a: ops.flash_attention_fwd(*a, causal=True), (q, k, v)),
            "bound_ms": {n: lm19_flash_bound_ms(shape, n)
                         for n in ("flash_attention_fwd",) + (
                             BWD_KERNELS if shape in LM19_FLASH_TRAIN
                             else ())}}
        if shape in LM19_FLASH_TRAIN:
            do = torch.randn(B, H, Sq, hd, device=dev, generator=g)
            o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
            args = (q, k, v, do, lse, (do * o).sum(-1))
            (dq,) = same_bits(lambda *a: (ops.flash_attention_bwd_dq(
                *a, causal=True),), args, f"dq at {what}")
            dk, dv = same_bits(lambda *a: ops.flash_attention_bwd_dkv(
                *a, causal=True), args, f"dk/dv at {what}")
            plain = (ops.flash_attention_bwd_dq_ref(*args, True),
                     *ops.flash_attention_bwd_dkv_ref(*args, True))
            err = rel_grads((dq, dk, dv), plain)
            check(err <= FLASH_BWD_RTOL, f"flash backward != plain at "
                  f"{what}: {err} > {FLASH_BWD_RTOL}")
            worst["flash_attention_bwd_dq"] = max(
                worst["flash_attention_bwd_dq"],
                (dq - plain[0]).abs().max().item())
            worst["flash_attention_bwd_dkv"] = max(
                worst["flash_attention_bwd_dkv"],
                (dk - plain[1]).abs().max().item(),
                (dv - plain[2]).abs().max().item())
            row["flash_attention_bwd_dq"] = device_ms(
                lambda a: ops.flash_attention_bwd_dq(*a, causal=True), args)
            row["flash_attention_bwd_dkv"] = device_ms(
                lambda a: ops.flash_attention_bwd_dkv(*a, causal=True), args)
        times.append(row)
    print("phase 19: flash kernels at the per-shard shapes (B, H, KV, Sq, "
          f"Sk, hd) {LM19_FLASH_TRAIN + LM19_FLASH_PREFILL} == plain (o atol "
          f"{FLASH_O_ATOL}, lse atol {FLASH_LSE_ATOL}; backward at the "
          f"training shapes {FLASH_BWD_RTOL} of each gradient's max), "
          "bitwise run to run; max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()) + "; device ms " +
          "; ".join(f"{r['shape']}: " + ", ".join(
              f"{k} {v:.3f} (bound {r['bound_ms'][k]:.3f})"
              for k, v in r.items() if k not in ("shape", "bound_ms"))
              for r in times))
    return worst, times


def lm19_flash_bound_ms(shape, name):
    """The least time of a causal flash kernel at ``shape`` (B, H, KV, Sq,
    Sk, hd): its products (forward 2, dq 3, dk/dv 4) at 3xTF32's rate or
    its inputs and outputs once at the HBM rate, the larger."""
    B, H, KV, Sq, Sk, hd = shape
    pairs = sum(min(i + 1, Sk) for i in range(Sq))
    products = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 3,
                "flash_attention_bwd_dkv": 4}[name]
    q, kv, row = B * H * Sq * hd, B * KV * Sk * hd, B * H * Sq
    nbytes = 4 * {"flash_attention_fwd": 2 * q + 2 * kv + row,
                  "flash_attention_bwd_dq": 3 * q + 2 * kv + 2 * row,
                  "flash_attention_bwd_dkv": 2 * q + 4 * kv + 2 * row}[name]
    return max(nbytes / HBM_BYTES_PER_S,
               2 * products * B * H * pairs * hd / TF32X3_OPS_PER_S) * 1e3


def phase19(dev, ops):
    """SSM and hybrid training on a mesh, FSDP, sharded prefill and decode
    on the card -> (the ``lm_mesh`` path's launch counts, the readings,
    max |err| by flash kernel at the per-shard shapes)."""
    start = time.perf_counter()
    worst, flash_ms = hold_lm19_flash(dev, ops)
    launches = dict.fromkeys(ops.KERNELS, 0)
    train = [lm19_train(dev, ops, spec, launches) for spec in LM19_TRAIN]
    restore = lm19_restore(dev)
    decode = [lm19_decode(dev, ops, spec, launches) for spec in LM19_DECODE]
    readings = {"train": train, "restore": restore, "decode": decode,
                "flash_ms": flash_ms,
                "seconds": time.perf_counter() - start}
    print(f"phase 19: {readings['seconds']:.1f} s")
    return launches, readings, worst


# --- phase 20: the dry-run's dtype on the card -------------------------------

# the flash kernels in bf16 and at hd 112: the layer shapes of the small
# tier, the large tier (qwen3-1.7b) and kimi-k2's full width, causal and
# full, then the edges: Sq != Sk, Sq = Sk = 1, S no multiple of a tile,
# GQA (B, H, KV, Sq, Sk, hd)
LM20_SHAPES = {"small": (8, 16, 16, 1024, 1024, 64),
               "large": (4, 16, 8, 1024, 1024, 128),
               "kimi": (2, 64, 8, 1024, 1024, 112)}
LM20_EDGES = ((2, 8, 2, 200, 333, 64, False), (1, 2, 2, 1, 1, 112, True),
              (2, 4, 1, 1000, 1000, 128, True), (1, 8, 2, 77, 300, 112, False),
              (2, 4, 4, 130, 130, 32, True), (1, 8, 8, 100, 37, 16, True))
BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores (H100 SXM data sheet, 700 W)
# bf16 o against the plain version (upcast, float32, o rounded once): the
# reference's own bar on unit-normal inputs (tests/test_flash_attention.py);
# lse is float32 from exact bf16 products, summed in another order: phase
# 9's bar
BF16_O_ATOL, BF16_LSE_ATOL = 3e-2, 1e-5
# and element by element: |o - plain| <= BF16_O_ULP |plain| +
# BF16_P_RTOL sum_j p_j |v_j|.  Both round o once, so they may differ by
# one bf16 ulp (at most 2^-7 of |o|); the kernel rounds each p to bf16
# for P V (2^-9 of each term p_j |v_j|), a bound doubled here.  A P V
# fault in any key tile shows, where the 3e-2 bar is about |o|'s own size
# for full attention at Sk 1,024
BF16_O_ULP, BF16_P_RTOL = 2.0 ** -7, 2.0 ** -8
# bf16 gradients against the plain backward, of each gradient's max |g|
# (rel_grads): the kernels round p and ds to bf16 (2^-9 relative each)
# before they meet v, k, q and dO, and round dq, dk, dv to bf16 (2^-9 of
# each element), where the plain version rounds only the outputs
BF16_GRAD_RTOL = 2e-2
# (c): qwen3-1.7b at full width and depth, kimi-k2 cut to 2 layers (its
# leading dense layer and one MoE layer) and 16 of 384 experts, top-8, at
# full width; name, layers, experts, B, S, warm-up steps, counted steps,
# decode steps
LM20_RUNS = (("qwen3-1.7b", None, None, 4, 1024, 1, 3, 32),
             ("kimi-k2-1t-a32b", 2, 16, 2, 1024, 1, 1, 8))
LM20_LR = 1e-3           # the runs' AdamW / Adafactor peak, no warm-up
LM20_CPU = (2, 16)       # the 2-layer cuts card vs CPU: B, S
# card vs CPU in bf16: both round every product's output and every
# activation to bf16 (2^-9 relative), in orders of their own (cuBLAS and
# the flash kernel against the CPU's products and plain attention)
LM20_BF16_LOSS_RTOL, LM20_BF16_GRAD_RTOL = 1e-2, 5e-2
# bf16 prefill vs the forward over the prompt and the decoded tokens, and
# decode vs that teacher-forced forward, of the max |logit|: the products
# of the two runs have other shapes, so their bf16 roundings differ, and
# decode's attention is the plain one over the cache
LM20_PREFILL_RTOL, LM20_DECODE_RTOL = 3e-2, 5e-2
# (d): six of the reference test's seven dry-run cells
# (tests/test_dryrun_cells.py) on the production meshes, each cut to the
# least depth that keeps its layer kinds (the trace runs every shard's
# work on the host: the reference test's cuts would take longer than the
# script has; see PERF.md).  The seventh, kimi-k2 train_4k on 2 x 16 x 16
# (~370 s of host at 2 layers), is left to tests/test_torch_dryrun.py's
# (2, 2, 4) mesh.  They run in worker processes of one thread each, the
# longest cell first, from the end of (c)'s timed runs, beside (a) and the
# card-vs-CPU comparisons, which are not timed.
LM20_DRYRUN = (("arctic-480b", "train_4k", {"n_layers": 1}, False),
               ("qwen3-1.7b", "train_4k", {"n_layers": 1}, True),
               ("gemma2-2b", "prefill_32k", {"n_layers": 2}, False),
               ("qwen3-1.7b", "train_4k", {"n_layers": 1}, False),
               ("zamba2-1.2b", "decode_32k",
                {"n_layers": 1, "hybrid_period": 1}, False),
               ("mamba2-780m", "long_500k", {"n_layers": 1}, False))
LM20_DRYRUN_WORKERS = 4
LM20_DRYRUN_WAIT_S = 300  # the longest (d) waits for the last cell


def flash_bound(name, dt, shape, causal=True):
    """The least time of a flash kernel at ``shape`` (B, H, KV, Sq, Sk,
    hd): its products (forward 2, dq 3, dk/dv 4) at the tensor cores' rate
    for ``dt`` (bf16's, or 3xTF32's for float32), or its inputs and
    outputs once at the HBM rate, the larger -> (ms, "bytes" or
    "operations")."""
    B, H, KV, Sq, Sk, hd = shape
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[name]
    q, kv, row = B * H * Sq * hd, B * KV * Sk * hd, B * H * Sq
    width = 2 if dt == torch.bfloat16 else 4
    nbytes = {"fwd": width * (2 * q + 2 * kv) + 4 * row,
              "dq": width * (3 * q + 2 * kv) + 8 * row,
              "dkv": width * (2 * q + 4 * kv) + 8 * row}[name]
    rate = BF16_OPS_PER_S if dt == torch.bfloat16 else TF32X3_OPS_PER_S
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = 2 * products * B * H * pairs * hd / rate * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def fwd_hold(ops, q, k, v, o, lse, causal, what, name="flash_attention_fwd"):
    """A forward's o and lse at (q, k, v) against the plain version, at
    phase 9's bars (float32) or phase 20's (bf16: o atol ``BF16_O_ATOL``,
    each element within ``BF16_O_ULP`` |o| + ``BF16_P_RTOL`` sum p |v|,
    lse ``BF16_LSE_ATOL``) -> (max |o err|, max |lse err|, the worst
    element's share of the per-element bar, 0 in float32)."""
    dt = q.dtype
    ro, rlse = ops.flash_attention_ref(q, k, v, causal)
    bf = dt == torch.bfloat16
    o_err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    o_bar = BF16_O_ATOL if bf else FLASH_O_ATOL
    lse_bar = BF16_LSE_ATOL if bf else FLASH_LSE_ATOL
    check(o.dtype == dt and o_err <= o_bar and lse_err <= lse_bar,
          f"{name} != plain at {what}: o {o.dtype} {o_err} "
          f"(bar {o_bar}), lse {lse_err} (bar {lse_bar})")
    o_ratio = 0.0
    if bf:
        # sum_j p_j |v_j|: the plain forward of |v| in float32
        pv = ops.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                     causal)[0]
        o_ratio = ((o.float() - ro.float()).abs() / (
            BF16_O_ULP * ro.float().abs() + BF16_P_RTOL * pv).clamp_min(
                1e-30)).max().item()
        del pv
        check(o_ratio <= 1.0, f"{name} != plain at {what}: "
              f"an element of o beyond {BF16_O_ULP} |o| + {BF16_P_RTOL} "
              f"sum p |v| ({o_ratio} of it)")
    return o_err, lse_err, o_ratio


def lm20_hold(g, dev, ops, dt, shape, causal):
    """The forward, dq and dk/dv kernels at ``shape`` in ``dt`` against
    their plain versions (bf16: ``BF16_*``; float32: phase 9's and 11's
    bars), each bitwise run to run, and the autograd entry's gradients the
    kernels' bits -> {"fwd", "dq", "dkv": max |err|, "grad_rel": the worst
    gradient's error of its max}."""
    B, H, KV, Sq, Sk, hd = shape
    what = f"{dt} (B, H, KV, Sq, Sk, hd) {shape} causal={causal}"
    q, k, v = (x.to(dt) for x in flash_inputs(g, dev, *shape))
    do = torch.randn(B, H, Sq, hd, device=dev, generator=g).to(dt)
    o, lse = same_bits(lambda *a: ops.flash_attention_fwd(*a, causal=causal),
                       (q, k, v), f"flash_attention_fwd at {what}")
    o_err, lse_err, o_ratio = fwd_hold(ops, q, k, v, o, lse, causal, what)
    bf = dt == torch.bfloat16
    args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
    (dq,) = same_bits(lambda *a: (ops.flash_attention_bwd_dq(
        *a, causal=causal),), args, f"flash_attention_bwd_dq at {what}")
    dk, dv = same_bits(lambda *a: ops.flash_attention_bwd_dkv(
        *a, causal=causal), args, f"flash_attention_bwd_dkv at {what}")
    plain = (ops.flash_attention_bwd_dq_ref(*args, causal),
             *ops.flash_attention_bwd_dkv_ref(*args, causal))
    got = [x.float() for x in (dq, dk, dv)]
    err = rel_grads(got, [x.float() for x in plain])
    bar = BF16_GRAD_RTOL if bf else FLASH_BWD_RTOL
    check(all(x.dtype == dt for x in (dq, dk, dv)) and err <= bar,
          f"flash backward != plain at {what}: {err} of the max |g| "
          f"(bar {bar})")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    entry = torch.autograd.grad(ops.flash_attention(*leaves, causal),
                                leaves, do)
    check(all(torch.equal(a, b) for a, b in zip(entry, (dq, dk, dv))),
          f"flash_attention's gradients != the kernels' bits at {what}")
    return {"fwd": max(o_err, lse_err), "o_ratio": o_ratio,
            "dq": (got[0] - plain[0].float()).abs().max().item(),
            "dkv": max((got[i] - plain[i].float()).abs().max().item()
                       for i in (1, 2)), "grad_rel": err}


def lm20_holds(dev, ops):
    """(a): every case of ``LM20_SHAPES`` (causal and full) and
    ``LM20_EDGES`` in bf16, and those at hd 112 in float32 too ->
    {variant: {kernel: max |err|}}, the worst gradient error by type."""
    from repro_torch.kernels.flash_attention import variant
    g = torch.Generator(device=dev).manual_seed(20)
    worst = {}
    rel = {"bf16": 0.0, "f32": 0.0}
    o_ratio = 0.0
    cases = [(s, c) for s in LM20_SHAPES.values() for c in (True, False)]
    cases += [(e[:6], e[6]) for e in LM20_EDGES]
    for shape, causal in cases:
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and shape[5] != 112:
                continue
            got = lm20_hold(g, dev, ops, dt, shape, causal)
            w = worst.setdefault(variant(dt, shape[5]),
                                 {"fwd": 0.0, "dq": 0.0, "dkv": 0.0})
            for k in w:
                w[k] = max(w[k], got[k])
            t = "bf16" if dt == torch.bfloat16 else "f32"
            rel[t] = max(rel[t], got["grad_rel"])
            o_ratio = max(o_ratio, got["o_ratio"])
            torch.cuda.empty_cache()
    print(f"phase 20 (a): the flash forward, dq and dk/dv in bf16 (o atol "
          f"{BF16_O_ATOL} and per element {BF16_O_ULP} |o| + {BF16_P_RTOL} "
          f"sum p |v|, worst at {o_ratio:.3f} of it, lse {BF16_LSE_ATOL}, "
          f"gradients {BF16_GRAD_RTOL} of"
          f" each max, worst {rel['bf16']:.3e}) and at hd 112 in float32 (o "
          f"{FLASH_O_ATOL}, lse {FLASH_LSE_ATOL}, gradients {FLASH_BWD_RTOL}, "
          f"worst {rel['f32']:.3e}) == their plain versions, bitwise run to "
          f"run, the autograd entry's gradients the kernels' bits, at "
          f"{len(cases)} (shape, causal) cases: the shapes {LM20_SHAPES} "
          f"causal and full and the edges {LM20_EDGES}; max |err| " +
          "; ".join(f"{v}: " + ", ".join(f"{k} {e:.3e}" for k, e in w.items())
                    for v, w in worst.items()))
    return worst, rel


def lm20_times(dev, ops):
    """(b): each kernel variant, its plain version and
    ``scaled_dot_product_attention`` (forward; its backward, one call for
    dq, dk and dv; timed only, the port never calls it) at the shapes of
    ``LM20_SHAPES`` (float32 at kimi-k2's hd 112 only) ->
    {variant: {shape name: {kernel: times and bound}}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import variant
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for tier, shape in LM20_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and shape[5] != 112:
                continue
            B, H, KV, Sq, Sk, hd = shape
            q, k, v = (x.to(dt) for x in flash_inputs(g, dev, *shape))
            do = torch.randn(B, H, Sq, hd, device=dev, generator=g).to(dt)
            o, lse = ops.flash_attention_fwd(q, k, v)
            args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o_sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                    enable_gqa=True)
            lib = {"fwd": device_ms(lambda a: F.scaled_dot_product_attention(
                       *a, is_causal=True, enable_gqa=True), (q, k, v)),
                   "bwd": device_ms(lambda a: torch.autograd.grad(
                       o_sdpa, leaves, a, retain_graph=True), do)}
            row = {}
            for name, fn, plain, a in (
                    ("fwd", ops.flash_attention_fwd, ops.flash_attention_ref,
                     (q, k, v)),
                    ("dq", ops.flash_attention_bwd_dq,
                     ops.flash_attention_bwd_dq_ref, args),
                    ("dkv", ops.flash_attention_bwd_dkv,
                     ops.flash_attention_bwd_dkv_ref, args)):
                bound, by = flash_bound(name, dt, shape)
                row[name] = {
                    "ms": device_ms(lambda x, fn=fn: fn(*x), a),
                    "plain_ms": device_ms(lambda x, fn=plain: fn(*x), a,
                                          reps=5),
                    "bound_ms": bound, "bound_by": by,
                    "library_ms": lib["fwd" if name == "fwd" else "bwd"],
                    "shape": list(shape)}
            out.setdefault(variant(dt, hd), {})[tier] = row
            pair = (row["dq"]["ms"] + row["dkv"]["ms"]) / lib["bwd"]
            print(f"phase 20 (b): {variant(dt, hd)} at the {tier} shape "
                  f"{shape} (causal): " + "; ".join(
                      f"{n} {r['ms'] * 1e3:.2f} us (plain "
                      f"{r['plain_ms'] * 1e3:.2f}, bound "
                      f"{r['bound_ms'] * 1e3:.2f} by {r['bound_by']}, at "
                      f"{r['bound_ms'] / r['ms']:.3f} of it)"
                      for n, r in row.items())
                  + f"; scaled_dot_product_attention forward "
                  f"{lib['fwd'] * 1e3:.2f} us (the forward at "
                  f"{row['fwd']['ms'] / lib['fwd']:.3f}x it), backward (dq, "
                  f"dk, dv in one call) {lib['bwd'] * 1e3:.2f} us (dq + dk/dv"
                  f" at {pair:.3f}x it)")
            del q, k, v, do, o, lse, args, leaves, o_sdpa
            torch.cuda.empty_cache()
    return out


def lm20_config(name, layers, experts, dtype):
    """``pd_config``'s configuration with ``dtype`` and ``param_dtype``
    ``dtype``, as the dry-run sets them."""
    from dataclasses import replace
    return replace(pd_config(name, layers, experts), dtype=dtype,
                   param_dtype=dtype)


def lm20_variant_counts(ops):
    """The flash wrappers' launches by variant (read after a sync)."""
    torch.cuda.synchronize()
    return {n: dict(ops.KERNELS[n].variant_launches)
            for n in ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")}


def lm20_zero(ops):
    from repro_torch.kernels.flash_attention import zero_variant_counts
    for wrapper in ops.KERNELS.values():
        wrapper.launches = 0
    zero_variant_counts()


def lm20_add(total, ops):
    """Add the current counts (total and by variant) into ``total``."""
    torch.cuda.synchronize()
    for n, w in ops.KERNELS.items():
        total["launches"][n] = total["launches"].get(n, 0) + w.launches
    for n, by in lm20_variant_counts(ops).items():
        for v, c in by.items():
            key = f"{n}:{v}"
            total["variants"][key] = total["variants"].get(key, 0) + c


def lm20_train(dev, ops, cfg, B, S, warm, timed, total):
    """``Trainer`` on the card in bf16 (the dry-run's policy: optimizer,
    microbatches; remat on, hybrid off; ``LM20_LR`` from step 0) on one
    fixed batch: ``warm`` steps, then ``timed`` counted ones
    -> summary."""
    from repro_torch.data.tokens import random_batch
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.launch.dryrun import policy_for
    from repro_torch.models import lm
    from repro_torch.runtime.trainer import TrainCfg, Trainer
    pol = policy_for(cfg.name)
    tcfg = TrainCfg(optimizer=pol["optimizer"],
                    microbatches=pol["microbatches"], lr=LM20_LR, warmup=0,
                    total_steps=warm + timed + 1)
    batch = random_batch(torch.Generator(device=dev).manual_seed(2000),
                         cfg.vocab, B, S)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, lambda step: batch, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(tr.state["params"])
    tr.run(warm, log_every=0)
    lm20_zero(ops)
    tr.run(timed, log_every=0)
    counts = lm20_variant_counts(ops)
    launches = {n: w.launches for n, w in ops.KERNELS.items()}
    lm20_add(total, ops)
    L, mb = cfg.n_layers, pol["microbatches"]
    v = variant(cfg.xdtype, cfg.head_dim)
    want = {"flash_attention_fwd": 2 * L * mb * timed,
            "flash_attention_bwd_dq": L * mb * timed,
            "flash_attention_bwd_dkv": L * mb * timed}
    check(launches == {n: want.get(n, 0) for n in launches}
          and all(counts[n][v] == c for n, c in want.items()),
          f"{cfg.name} bf16: launches {launches}, by variant {counts} in "
          f"{timed} steps; want {want} of {v} (2 flash forwards a layer and "
          f"microbatch under remat, 1 dq and 1 dk/dv) and no other")
    losses = [h["loss"] for h in tr.history]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{cfg.name} bf16: losses {losses} not finite and falling")
    times = [h["time_s"] * 1e3 for h in tr.history[warm:]]
    p50, p95 = np.percentile(times, 50), np.percentile(times, 95)
    peak = torch.cuda.max_memory_allocated()
    rec = {"name": cfg.name, "layers": L, "params": n_params, "B": B,
           "S": S, "optimizer": pol["optimizer"], "microbatches": mb,
           "step_ms_p50": p50, "step_ms_p95": p95,
           "tokens_per_s": B * S / (p50 / 1e3), "peak_bytes": peak,
           "losses": losses, "init_s": init_s}
    print(f"phase 20 (c): Trainer, {cfg.name} bf16 ({L} layers, "
          f"{n_params:,} parameters; init {init_s:.2f} s), "
          f"{pol['optimizer']}, {mb} microbatch(es), remat, hybrid off; B {B}"
          f" x S {S}; {warm} + {timed} steps: step ms p50 {p50:.3f} (p95 "
          f"{p95:.3f}), {rec['tokens_per_s']:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.3f} GB; losses " + ", ".join(f"{x:.4f}"
                                                     for x in losses)
          + f"; launches by variant {counts}")
    params = tr.state["params"]
    del tr
    return rec, params


def lm20_decode(dev, ops, cfg, params, B, S, steps, total):
    """bf16 prefill of a random prompt (one warm-up, two timed) and
    ``steps`` greedy decode steps, counted; then prefill against the
    forward over the prompt and the decoded tokens, and each step against
    it at its position -> record."""
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.models import attention
    from repro_torch.models import lm
    g = torch.Generator(device=dev).manual_seed(2001)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    max_len = S + PD_SLACK
    n_attn = sum(attention.uses_kernel(cfg, w, S)
                 for w in cfg.layer_windows())
    v = variant(cfg.xdtype, cfg.head_dim)
    with torch.inference_mode():
        st, logits = lm.prefill(cfg, params, tokens=toks, max_len=max_len)
        lm.decode_step(cfg, params, st, logits.argmax(-1))
        del st, logits
        prefill_ms = []
        for _ in range(2):
            st = first = None
            lm20_zero(ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, first = lm.prefill(cfg, params, tokens=toks, max_len=max_len)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            pre = {n: w.launches for n, w in ops.KERNELS.items()}
            by = lm20_variant_counts(ops)["flash_attention_fwd"][v]
            check(pre["flash_attention_fwd"] == n_attn == by
                  and sum(pre.values()) == n_attn,
                  f"{cfg.name} bf16 prefill launched {pre} ({by} of {v}), "
                  f"want flash_attention_fwd {n_attn} of {v} and no other")
        ptrs = {k: x.data_ptr() for k, x in st.items()}
        out = torch.empty((steps, B, cfg.vocab), dtype=first.dtype,
                          device=dev)
        fed = torch.empty((B, steps), dtype=toks.dtype, device=dev)
        logits, step_ms = first, []
        for t in range(steps):
            fed[:, t] = logits.argmax(-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, st2 = lm.decode_step(cfg, params, st, fed[:, t])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(st2 is st and {k: x.data_ptr() for k, x in st.items()}
                  == ptrs, f"{cfg.name} bf16 decode step {t}: the state was "
                  "not updated in place")
            out[t].copy_(logits)
        lm20_add(total, ops)
        dec = {n: w.launches - pre[n] for n, w in ops.KERNELS.items()}
        check(not any(dec.values()), f"{cfg.name} bf16 decode steps "
              f"launched {dec}")
        p50 = float(np.percentile(step_ms, 50))
        prof = profile_decode_step(cfg, params, st, fed[:, -1], p50)
        check(prof["syncs"] == 0 and prof["h2d"] == 0 and prof["d2h"] == 0,
              f"{cfg.name} bf16: the profiled decode step synced or copied "
              f"to or from the host: {prof}")
        del st
        h, _ = lm.forward(cfg, params, tokens=torch.cat([toks, fed], 1))
        tf = lm.logits_from_hidden(cfg, params, h[:, S - 1:S + steps])
        del h
        pre_err = pd_rel(first.float(), tf[:, 0].float())
        errs = [pd_rel(out[t].float(), tf[:, t + 1].float())
                for t in range(steps)]
    rec = {"name": cfg.name, "B": B, "prompt": S, "steps": steps,
           "prefill_ms": float(np.median(prefill_ms)),
           "prefill_ms_each": prefill_ms,
           "decode_p50_ms": p50,
           "decode_p95_ms": float(np.percentile(step_ms, 95)),
           "decode_tokens_per_s": B / p50 * 1e3, "flash_launches": n_attn,
           "prefill_err": pre_err, "decode_err": max(errs),
           "decode_err_step": int(np.argmax(errs)), "profile": prof}
    print(f"phase 20 (c): {cfg.name} bf16 prefill B {B} x {S}: "
          f"{rec['prefill_ms']:.3f} ms ({n_attn} flash forwards of {v}); "
          f"{steps} decode steps p50 {p50:.3f} ms (p95 "
          f"{rec['decode_p95_ms']:.3f}), {rec['decode_tokens_per_s']:.1f} "
          f"tokens/s, profiled step {prof['syncs']} syncs, {prof['h2d']} "
          f"H2D, {prof['d2h']} D2H; prefill vs forward {pre_err:.3e} (bar "
          f"{LM20_PREFILL_RTOL}), decode vs teacher-forced forward "
          f"{rec['decode_err']:.3e} (bar {LM20_DECODE_RTOL}, worst step "
          f"{rec['decode_err_step']})")
    check(pre_err <= LM20_PREFILL_RTOL, f"{cfg.name} bf16: prefill vs "
          f"forward {pre_err} > {LM20_PREFILL_RTOL}")
    check(rec["decode_err"] <= LM20_DECODE_RTOL, f"{cfg.name} bf16: decode "
          f"vs teacher-forced forward {rec['decode_err']} > "
          f"{LM20_DECODE_RTOL}")
    return rec


@contextlib.contextmanager
def record_routing(calls):
    """A context in which every call of the MoE router appends its chosen
    experts (a CPU copy) to ``calls``."""
    from repro_torch.models import moe
    real = moe._router

    def recorded(p, moe_cfg, x2d):
        out = real(p, moe_cfg, x2d)
        calls.append(out[1].detach().cpu())
        return out
    moe._router = recorded
    try:
        yield
    finally:
        moe._router = real


@contextlib.contextmanager
def replay_routing(calls, flips):
    """A context in which the MoE router's i-th call takes the experts of
    ``calls[i]`` (``record_routing``'s) in place of its own top-k, their
    weights its own probabilities of them, renormalised, as ``_router``
    does; ``flips[0]`` counts the tokens whose own choice differed.  Every
    recorded call must be replayed (checked on leaving)."""
    from repro_torch.models import moe
    real = moe._router
    n = [0]

    def replayed(p, moe_cfg, x2d):
        _, own, probs = real(p, moe_cfg, x2d)
        check(n[0] < len(calls), f"the router was called more than the "
              f"{len(calls)} times the card's run called it")
        top_e = calls[n[0]].to(own.device)
        n[0] += 1
        check(top_e.shape == own.shape, f"router call {n[0]}: experts "
              f"{tuple(top_e.shape)} on the card, {tuple(own.shape)} here")
        flips[0] += int((own.sort(-1).values != top_e.sort(-1).values)
                        .any(-1).sum())
        top_p = probs.gather(-1, top_e)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        return top_p, top_e, probs
    moe._router = replayed
    try:
        yield
    finally:
        moe._router = real
    check(n[0] == len(calls), f"the router was called {n[0]} times, the "
          f"card's run {len(calls)}")


def lm20_card_vs_cpu(dev, ops, name, experts, total):
    """The configuration cut to 2 layers at full width, in bf16 and in
    float32: ``lm_loss`` and its gradient on the card (the flash kernels,
    counted) against the port on the CPU, the same weights and batch ->
    {dtype: {"loss", "gradients": relative errors, ...}}.

    A MoE router picks its top-k experts from probabilities that carry the
    layer input's rounding, so a token whose k-th and next experts lie
    within that rounding could take another expert on each side (bf16: a
    near-tie).  So the CPU run takes the card's choices
    (``replay_routing``), its weights from its own probabilities, and
    every leaf keeps the bar; the tokens whose own choice differed are
    reported."""
    from repro_torch.checkpoint.serial import _paths
    from repro_torch.data.tokens import random_batch
    from repro_torch.models import lm
    from repro_torch.optim.sgd import value_and_grad
    from repro_torch.weights import to_device
    B, S = LM20_CPU
    out = {}
    for dt in ("bfloat16", "float32"):
        cfg = lm20_config(name, 2, experts, dt)
        batch = random_batch(torch.Generator().manual_seed(2002), cfg.vocab,
                             B, S)
        p_dev = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(2003))
        p_cpu = to_device(p_dev, "cpu")

        def loss_fn(p, b):
            loss, m = lm.lm_loss(cfg, p, b)
            return loss, {}
        lm20_zero(ops)
        routes, flips = [], [0]
        with record_routing(routes):
            (l_dev, _), g_dev = value_and_grad(
                loss_fn, p_dev, {k: x.to(dev) for k, x in batch.items()})
        launched = ops.KERNELS["flash_attention_bwd_dq"].launches
        lm20_add(total, ops)
        g_dev = [x.cpu() for x in g_dev]
        del p_dev
        with replay_routing(routes, flips):
            (l_cpu, _), g_cpu = value_and_grad(loss_fn, p_cpu, batch)
        names = [k for k, _ in _paths(p_cpu)]
        leaf = {n: pd_rel(a.float(), b.float())
                for n, a, b in zip(names, g_dev, g_cpu)}
        worst = max(leaf, key=leaf.get)
        out[dt] = {"loss": abs(l_dev.item() - l_cpu.item())
                   / abs(l_cpu.item()), "gradients": leaf[worst],
                   "worst_leaf": worst, "dq_launches": launched,
                   "router_calls": len(routes), "routing_flips": flips[0]}
        loss_bar, grad_bar = ((LM20_BF16_LOSS_RTOL, LM20_BF16_GRAD_RTOL)
                              if dt == "bfloat16" else (LM_RTOL, LM_RTOL))
        check(launched == 2, f"{name} 2-layer {dt}: {launched} dq launches "
              "on the card, want 2")
        check(out[dt]["loss"] <= loss_bar and out[dt]["gradients"]
              <= grad_bar, f"{name} 2-layer cut card vs CPU in {dt}: "
              f"{out[dt]} (bars {loss_bar}, {grad_bar})")
        del p_cpu, g_dev, g_cpu
        torch.cuda.empty_cache()
    print(f"phase 20 (c): {name} cut to 2 layers at full width, (B, S) "
          f"{LM20_CPU}, card (flash kernels) vs the port on the CPU, "
          f"relative to each tensor's max |x|: " + "; ".join(
              f"{dt} loss {e['loss']:.3e}, gradients {e['gradients']:.3e} "
              f"(worst {e['worst_leaf']}); the CPU took the card's experts "
              f"in {e['router_calls']} router calls, {e['routing_flips']} "
              "tokens of them otherwise than its own top-k would"
              for dt, e in out.items())
          + f" (bars: bf16 {LM20_BF16_LOSS_RTOL}, {LM20_BF16_GRAD_RTOL}; "
          f"float32 {LM_RTOL})")
    return out


def lm20_worker_init():
    """A dry-run worker: one intra-op thread (the workers share the
    host's cores)."""
    torch.set_num_threads(1)


def lm20_dryrun_cell(spec):
    """One dry-run cell in a worker process -> its record."""
    arch, shape, overrides, multi_pod = spec
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * (
        512 if multi_pod else 256))
    return dryrun.build_and_compile(arch, shape, mesh, overrides=overrides)


def lm20_dryrun_start():
    """(d): ``LM20_DRYRUN``'s cells in a pool of spawned worker processes
    -> (pool, pending results)."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(
        LM20_DRYRUN_WORKERS, initializer=lm20_worker_init)
    return pool, [pool.apply_async(lm20_dryrun_cell, (spec,))
                  for spec in LM20_DRYRUN]


def lm20_dryrun_finish(pool, pending, t0):
    """(d): the cells' records (the pool terminated on leaving, a
    failure's too), each checked as the reference's test checks it, their
    summary lines and the report's two tables -> records.  ``t0``: the
    pool's start on ``time.perf_counter``."""
    from repro_torch.launch.dryrun import summary_line
    from repro_torch.runtime.roofline_report import fmt_table
    t1 = time.perf_counter()
    try:
        recs = [r.get(timeout=max(1.0, LM20_DRYRUN_WAIT_S
                                  - (time.perf_counter() - t0)))
                for r in pending]
    finally:
        pool.terminate()
        pool.join()
    now = time.perf_counter()
    print(f"phase 20 (d): the dry-run's cells in {LM20_DRYRUN_WORKERS} "
          f"workers took {now - t0:.1f} s, {now - t1:.1f} s of it awaited")
    for (arch, shape, ovr, mp), rec in zip(LM20_DRYRUN, recs):
        r = rec["roofline"]
        print(f"=== {arch}__{shape}__{'multi' if mp else 'single'} "
              f"{ovr} on {rec['mesh']} ===\n" + summary_line(rec)
              + "  peak/chip "
              f"{rec['memory']['peak_memory_in_bytes'] / 1e9:.2f} GB "
              f"fits={rec['memory']['fits']}  collectives "
              f"{rec['collectives']['per_kind_counts']}")
        check(r["compute_s"] > 0 and r["bottleneck"] in (
            "compute", "memory", "collective")
            and rec["collectives"]["collective_bytes"] >= 0
            and rec["memory"]["peak_memory_in_bytes"] > 0,
            f"dry-run cell {arch} {shape}: {r}, {rec['memory']}")
    print("## single-pod (16x16)\n\n" + fmt_table(recs, "single")
          + "\n\n## multi-pod (2x16x16)\n\n" + fmt_table(recs, "multi"))
    return recs


def lm20_records(total, worst, times):
    """The kernels' line's records of phase 20's variants: bf16 at the
    large tier's layer (qwen3-1.7b's), hd 112 at kimi-k2's, each with its
    launches on the ``lm_bf16`` path and its times at the other shapes."""
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                      bwd_bf16_attributes,
                                                      fwd_bf16_attributes)
    # the bf16 forward and backward (wgmma, warp-specialised) as built:
    # registers a thread at launch (the consumers rise to 232 with
    # setmaxnreg) and local bytes (spills and stack), which must be none
    attrs = {hd: {"fwd": fwd_bf16_attributes(hd), **bwd_bf16_attributes(hd)}
             for hd in HEAD_DIMS}
    print("phase 20: the bf16 forward and backward kernels' registers at "
          "launch and local bytes: " + "; ".join(
              f"hd {hd} " + ", ".join(f"{k} {a['registers']} / "
                                      f"{a['local_bytes']} B"
                                      for k, a in at.items())
              for hd, at in attrs.items()))
    check(all(a["local_bytes"] == 0 for at in attrs.values()
              for a in at.values()),
          f"a bf16 flash kernel spills: {attrs}")
    records = []
    for v, tier in (("bf16", "large"), ("bf16_hd112", "kimi"),
                    ("f32_hd112", "kimi")):
        for name, short, line in (("flash_attention_fwd", "fwd", "143"),
                                  ("flash_attention_bwd_dq", "dq", "190"),
                                  ("flash_attention_bwd_dkv", "dkv", "207")):
            n = total["variants"].get(f"{name}:{v}", 0)
            records.append({
                "name": f"{name}_{v}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": f"src/repro/kernels/flash_attention.py:{line}",
                "launches": n, "max_abs_err": worst[v][short],
                **times[v][tier][short], "launches_by_path": {"lm_bf16": n},
                "other_shapes": {k: r[short] for k, r in times[v].items()
                                 if k != tier}})
            if v.startswith("bf16"):
                records[-1]["built"] = attrs[112 if "hd112" in v
                                             else 128][short]
    return records


def phase20(dev, ops):
    """bf16 and hd 112: the flash kernels held and timed, the bf16 LM at
    full width (qwen3-1.7b) and kimi-k2's cut, and the dry-run's cells on
    the production meshes -> (the ``lm_bf16`` path's launches and launches
    by variant, the readings, max |err| by variant, the kernel times)."""
    start = time.perf_counter()
    marks = {}
    times = lm20_times(dev, ops)
    marks["b"] = time.perf_counter() - start
    total = {"launches": {}, "variants": {}}
    runs = []
    for name, layers, experts, B, S, warm, timed, steps in LM20_RUNS:
        cfg = lm20_config(name, layers, experts, "bfloat16")
        train, params = lm20_train(dev, ops, cfg, B, S, warm, timed, total)
        decode = lm20_decode(dev, ops, cfg, params, B, S, steps, total)
        del params
        torch.cuda.empty_cache()
        marks[f"c {name}"] = time.perf_counter() - start
        runs.append({"train": train, "decode": decode})
    # nothing is timed from here on: the dry-run's cells trace beside it
    t0 = time.perf_counter()
    pool, pending = lm20_dryrun_start()
    try:
        worst, rel = lm20_holds(dev, ops)
        marks["a"] = time.perf_counter() - start
        for run, (name, _, experts, *_) in zip(runs, LM20_RUNS):
            run["card_vs_cpu"] = lm20_card_vs_cpu(dev, ops, name, experts,
                                                  total)
            marks[f"c {name} card vs CPU"] = time.perf_counter() - start
    except BaseException:
        pool.terminate()
        raise
    lm_s = time.perf_counter() - start
    recs = lm20_dryrun_finish(pool, pending, t0)
    missing = [k for k in ("flash_attention_fwd:bf16",
                           "flash_attention_bwd_dq:bf16",
                           "flash_attention_bwd_dkv:bf16",
                           "flash_attention_fwd:bf16_hd112",
                           "flash_attention_bwd_dq:bf16_hd112",
                           "flash_attention_bwd_dkv:bf16_hd112",
                           "flash_attention_fwd:f32_hd112",
                           "flash_attention_bwd_dq:f32_hd112",
                           "flash_attention_bwd_dkv:f32_hd112")
               if not total["variants"].get(k)]
    check(not missing, f"the lm_bf16 path never launched {missing}")
    readings = {"runs": runs, "dryrun": recs, "lm_seconds": lm_s,
                "seconds": time.perf_counter() - start,
                "grad_rel": rel, "marks_s": marks}
    print(f"phase 20: {readings['seconds']:.1f} s ({lm_s:.1f} s before the "
          "dry-run's last cell was awaited; parts ended at " + ", ".join(
              f"{k} {v:.1f} s" for k, v in marks.items()) + ")")
    return total, readings, worst, times


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout "
             "of the repository")
    sys.path.insert(0, src)
    from repro_torch.configs.streamsplit_audio import CFG
    from repro_torch.kernels import build, ops
    from repro_torch.quant.int8 import dequantize, quantize

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    dev = ops.resolve_device("cuda")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{[os.path.basename(p) for p in libs]}")

    worst = phase1(CFG, dev, ops, dequantize, quantize)
    launches, serve_tick_ms, frame_launches = phase2(CFG, dev, ops)
    tot = kernel_times(CFG, dev, ops)
    refine_worst = phase3(dev, ops)
    refine_launches, _ = phase4(CFG, dev, ops, serve_tick_ms)
    refine_times = refine_kernel_times(dev, ops)
    train_worst = phase5(dev, ops)
    train_launches, _, enc_params = phase6(CFG, dev, ops)
    train_times = train_kernel_times(dev, ops)
    quant_worst = phase7(CFG, dev, ops)
    quant_times = quant_kernel_times(CFG, dev, ops)
    times_16 = times16(CFG, dev, ops)
    stream_launches = phase8(CFG, dev, ops)
    flash_worst = phase9(dev, ops)
    cascade_times = cascade_kernel_times(dev, ops)
    cascade_launches = phase10(dev, ops)
    bwd_worst = phase11(dev, ops)
    bwd_times = bwd_kernel_times(dev, ops)
    lm_launches, lm_runs, _ = phase12(dev, ops)
    control_launches, control = phase13(CFG, ops, enc_params)
    prefill_launches, decode_launches, lm_decode = phase14(dev, ops)
    cluster_launches, cluster = phase15(CFG, ops)
    quality_launches, example_launches, quality, quality_worst = \
        phase16(ops)
    sharded_launches, sharded, sharded_worst, two_shards = phase17(CFG, ops)
    multiprocess_launches, multiprocess = phase21(ops, two_shards)
    sharded_lm_launches, sharded_lm, sharded_lm_worst = phase18(
        dev, ops, lm_runs[0]["loss_first"], lm_runs[0]["step_ms_p50"])
    lm_mesh_launches, lm_mesh, lm_mesh_worst = phase19(dev, ops)
    lm_bf16, bf16_readings, bf16_worst, bf16_times = phase20(dev, ops)
    paths = {"serve": launches, "refine": refine_launches,
             "train": train_launches, "per_frame": frame_launches,
             "stream": stream_launches, "cascade": cascade_launches,
             "lm_train": lm_launches, "control": control_launches,
             "prefill": prefill_launches, "decode": decode_launches,
             "cluster": cluster_launches, "quality": quality_launches,
             "examples": example_launches, "sharded": sharded_launches,
             "sharded_lm": sharded_lm_launches, "lm_mesh": lm_mesh_launches,
             "lm_bf16": lm_bf16["launches"],
             "multiprocess": multiprocess_launches}
    print("kernels: " + "; ".join(f"{p} path " + ", ".join(
        f"{n} launches={c}" for n, c in counts.items())
        for p, counts in paths.items()))

    def by_path(name):
        return {p: counts[name] for p, counts in paths.items()}
    # the tick's wire: one grouped launch, and (the one-group call) one
    # launch a bucket, both timed over the tick's eight padded buckets
    records = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wire_roundtrip.cu",
        "replaces": "src/repro/kernels/int8_quant.py:90",
        "launches": launches[name],
        # the grouped wire is also held at the control path's widths
        "max_abs_err": (max(worst, control["wire_max_abs_err"])
                        if name == "wire_roundtrip_grouped" else worst),
        "ms": tot[ms], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
        "library_ms": None, "call_ms": tot[call],
        "launches_by_path": by_path(name)}
        for name, ms, call in (
            ("wire_roundtrip_grouped", "ms", "call_ms"),
            ("wire_roundtrip", "eight_launches_ms", "eight_launches_call_ms"))]
    for name, source, replaces in (
            ("swd_sessions", "swd.cu", "swd_kernel.py:67"),
            ("laplacian_energy", "laplacian_energy.cu",
             "laplacian_energy.py:33"),
            ("gmm_posterior", "gmm_posterior.cu", "gmm_posterior.py:50")):
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": refine_launches[name],
            "max_abs_err": refine_worst[name], **refine_times[name],
            "library_ms": None, "launches_by_path": by_path(name)})
        if name in train_times:              # also on the training path
            records[-1]["train_shape"] = train_times.pop(name)
            if "lm_shape" in records[-1]["train_shape"]:
                records[-1]["lm_shape"] = records[-1]["train_shape"].pop(
                    "lm_shape")
    no_pallas = ("no Pallas counterpart: the reference differentiates the "
                 "jnp twin ({})")
    for name, source, replaces in (
            ("infonce_vneg_fwd", "infonce_vneg.cu",
             "src/repro/kernels/infonce_vneg.py:52"),
            ("infonce_vneg_bwd", "infonce_vneg.cu", no_pallas.format(
                "src/repro/core/infonce.py:19")),
            ("swd_rank_fwd", "swd.cu", "src/repro/kernels/swd_kernel.py:67"),
            ("swd_rank_bwd", "hybrid_reg_bwd.cu", no_pallas.format(
                "src/repro/core/swd.py:108")),
            ("laplacian_energy_bwd", "hybrid_reg_bwd.cu", no_pallas.format(
                "src/repro/core/laplacian.py:29")),
            ("hybrid_reg_bwd", "hybrid_reg_bwd.cu", no_pallas.format(
                "src/repro/core/swd.py:108 and "
                "src/repro/core/laplacian.py:29"))):
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": train_worst[name], **train_times[name],
            "library_ms": None, "launches_by_path": by_path(name)})
    for name, line in (("int8_quantize", "36"), ("int8_dequantize", "129"),
                       ("int8_quantize_roundtrip", "36 and :129")):
        per_frame = quant_times[name]["per_frame"]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
            "replaces": f"src/repro/kernels/int8_quant.py:{line}",
            "launches": frame_launches[name],
            "max_abs_err": quant_worst[name], "ms": per_frame["ms"],
            "plain_ms": per_frame["plain_ms"],
            "bound_ms": per_frame["bound_ms"],
            "bound_by": ("bytes" if per_frame["bytes_ms"]
                         >= per_frame["ops_ms"] else "operations"),
            "library_ms": None, "launches_by_path": by_path(name),
            **({"minmax_pass_ms": per_frame["minmax_ms"]}
               if name == "int8_quantize" else {}),
            **({"quantize_dequantize_ms": per_frame["quantize_dequantize_ms"]}
               if name == "int8_quantize_roundtrip" else {}),
            "largest_shape": quant_times[name]["largest"]})
    records += records16(times_16)
    records.append({
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:143",
        "launches": cascade_launches["flash_attention_fwd"],
        "max_abs_err": flash_worst, **cascade_times["small"],
        "launches_by_path": by_path("flash_attention_fwd"),
        "large_tier_shape": cascade_times["large"]})
    for name, line in zip(BWD_KERNELS, ("190", "207")):
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": lm_launches[name], "max_abs_err": bwd_worst[name],
            **bwd_times["small"][name], "launches_by_path": by_path(name),
            "large_tier_shape": bwd_times["large"][name]})
    next(r for r in records if r["name"] == "gmm_posterior")[
        "cascade_shape"] = cascade_times["gmm"]
    print(json.dumps({"lm_decode": lm_decode}))
    print(json.dumps({"control": control}))
    print(json.dumps({"lm_train": lm_runs}))
    print(json.dumps({"cluster": cluster}))
    # phase 16's holds at the quality path's and the demos' shapes
    for r in records:
        r["quality_max_abs_err"] = quality_worst.get(
            "wire" if r["name"].startswith("wire_") else r["name"])
    print(json.dumps({"quality": quality}))
    # phase 17's holds at the per-shard shapes
    for r in records:
        r["sharded_max_abs_err"] = sharded_worst.get(
            "wire" if r["name"] == "wire_roundtrip_grouped" else r["name"])
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"multiprocess": multiprocess}))
    # phase 18's holds at the LM's per-shard shapes, and its flash times
    for r in records:
        r["sharded_lm_max_abs_err"] = sharded_lm_worst.get(r["name"])
        if r["name"] in sharded_lm["flash_ms"]:
            r["sharded_lm_shape_ms"] = sharded_lm["flash_ms"][r["name"]]
    print(json.dumps({"sharded_lm": sharded_lm}))
    # phase 19's holds at the per-shard shapes of the SSM, hybrid and FSDP
    # steps and the sharded prefills, and its flash times there
    for r in records:
        r["lm_mesh_max_abs_err"] = lm_mesh_worst.get(r["name"])
        if r["name"] in lm_mesh_worst:
            r["lm_mesh_shapes_ms"] = [
                {"shape": row["shape"], "ms": row[r["name"]],
                 "bound_ms": row["bound_ms"][r["name"]]}
                for row in lm_mesh["flash_ms"] if r["name"] in row]
    print(json.dumps({"lm_mesh": lm_mesh}))
    records += lm20_records(lm_bf16, bf16_worst, bf16_times)
    print(json.dumps({"lm_bf16": bf16_readings}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
