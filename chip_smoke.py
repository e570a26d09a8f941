#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ray_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. device: the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build: every kernel of the port compiled from `ray_tpu_torch/kernels/csrc`
   (one nvcc per source, all at once), with the build seconds, ptxas's
   register, spill and advisory lines, and the tensor-core instructions
   (HGMMA, HMMA) in each kernel's SASS; a bf16 kernel (forward or
   backward) without HGMMA fails, and so does a float32 backward kernel
   with a tensor-core instruction (its route is the CUDA cores);
3. kernels: K1 against its plain PyTorch version on the card at the shapes
   the serving and training paths give it and a few more (a ragged block
   count, D 64 at the train shape, a peaked softmax, and D 256: the
   D-256 phase's train and serving shapes, ragged, peaked), with the error
   against the stated tolerance, the kernel's time (CUDA events) and
   achieved TFLOP/s, the plain version's time, one PyTorch library call's
   time as a yardstick, and the least time the card could take (bytes
   over 3.35 TB/s or operations over the peak rate for the type, whichever
   is larger); two launches on the same inputs must give bitwise-equal o
   and lse;
4. forward: `models.forward` at the flagship width (bf16, 1 x 1024 tokens)
   through the flash kernel, against the same forward on plain attention;
5. engine: the serving engine (`InferenceEngine` over
   `TransformerEngineModel`, paged decode, float32 flagship weights) answers
   8 requests, 4 of them sharing a 256-token prefix, after a warm-up pass of
   the same requests on an engine of its own; the flash kernel must be
   launched by the prefills, and each request's prefill logits, first token
   and greedy continuation are held against a no-cache float32 forward;
5a. fleet: three replicas of that engine (pools of 512 blocks) over the
   same weights behind `ServeFleet`. Twelve conversations of 32 new tokens
   share a 512-token system prompt: cold (KV-aware routing and prefix
   shipping off: each replica prefills the prompt through K1), then warm
   (on, after one warm-up conversation: the burst spills onto the other
   replicas with the prompt's 32 sealed blocks shipped ahead, card pool to
   host frames to card pool). Tokens/s, TTFT p50 cold and of the shipped
   conversations, ships and bytes, K1 launches (fewer warm than cold); every
   conversation held to a no-cache float32 forward as in the engine phase,
   and each shipped one's prefill logits to the same request's on the
   holder. One ship timed by its parts: export (card to host),
   encode+decode, install (host to card). Then a seeded kill of replica-0
   on its 8th streamed token of a 40-token conversation: the survivor
   finishes it, recovery ms (kill to first survivor token), the stream
   held to the same request's no-fault stream (a difference only where the
   forward's top two logits tie);
5b. serve: that engine as one replica of an `LLM` deployment behind
   `serve.run` on the port's in-process runtime, with `serve.start`'s HTTP
   proxy on 127.0.0.1. The engine phase's 8 prompts at once, 4 streamed
   over `handle.options(stream=True)` and 4 over HTTP POST with `Accept:
   text/event-stream`, then one plain HTTP POST and one `handle.remote`;
   then `serve.run` of version v2 while 4 HTTP streams are in flight, and
   `serve.shutdown()` with the runtime's. Tokens/s beside the engine
   phase's, client TTFT p50 per path beside the engine's own, the update's
   time, `torch.cuda.memory_allocated()` before deploy, after v1, after
   v2, after shutdown and after the orphaned engines stop. Gated: every
   stream's tokens are the no-cache forward's argmax or tie it within
   1e-3 (teacher-forced), K1 launched 12 times per no-prefix prefill the
   replica's model counts, every first token reaches its client before
   its stream ends, no stream fails during the update, which ends at one
   RUNNING v2 replica with v1 drained and killed (two replicas built in
   all), and shutdown returns within 10 s leaving no thread of the
   runtime or Serve;
5c. cluster serve: the same deployment on the port's cluster runtime
   (`ray_tpu_torch.init(num_cpus=8)`: GCS, raylet, controller, proxy and
   replicas as processes; the node's GPU detected, not passed). Each
   replica is a worker process leasing 0.25 of the card; it makes the
   flagship float32 weights itself from this script's seed on the card
   its lease shows it (a checksum of every leaf's bits must equal the
   driver's) and warms its engine with the engine phase's prompts. The 8
   prompts at once (4 handle streams, 4 HTTP SSE), then v1 -> v2 under 4
   HTTP streams (v1's exit must free at least its weights and pool,
   2,617,923,584 B, of the card's memory), a SIGKILL of the replica's
   process (the replacement's checksum and 4 streams held), a SIGKILL of
   the controller's under HTTP traffic (0 failed requests), the same 24
   handle requests through 1 and through 3 replicas, and shutdown (no
   `-m ray_tpu_torch.core.*` process left within 10 s). Tokens/s beside
   the engine phase's and the in-process serve phase's, client TTFT and
   Serve's share per path, the replica's build seconds by step, the
   update's, replacement's, recovery's and scale-up's seconds. Gated as
   the serve phase, with K1 counted in the replica process;
5c1. multiplex: `MuxLLM` on the cluster runtime, two replica processes
   leasing 0.5 of the card each, `serve.multiplexed` holding at most two
   float32 flagship engines a replica, each model id's weights made from
   a seed of its own (three ids). A cold wave of 4 streams an id (all
   three ids at once), two warm passes of the engine phase's 8 prompts
   an id (two waves of 4; the second timed), then one replica sent a fixed order of requests
   directly, and an engine evicted under a 512-token stream of its own.
   Gated: every stream's tokens its id's no-cache forward's argmax or a
   tie and each prompt's prefill logits within 1e-3 of it (a), the fixed
   order's loads the LRU rule's (b), each eviction with no loan freeing
   at least 2,617,923,584 B of the replica's `memory_allocated` and the
   loaned one freeing its bytes only after its stream ended (c), one load
   for an id's 4 concurrent cold requests (d), each id's routed requests
   on one replica (e), K1 launched 12 times a no-prefix prefill in the
   replicas (f). Prints cold load s, warm tokens/s by id and resident
   bytes by replica;
5c2. grpc: `serve.start_grpc_ingress()` in front of that deployment;
   each id's 16 tokens through `GrpcServeClient.call(..., model_id=)` in
   the pickle and msgpack payload modes equal the handle's, and an
   `allow_pickle=False` ingress refuses a pickled payload. Where grpcio
   is missing, the ImportError naming it is the gate;
5c3. trace: `util.tracing.enable_tracing(dir)` before `init()`, `MuxLLM`
   on one replica process: an HTTP SSE request and a handle request are
   each one trace id with their proxy (HTTP), router and replica spans,
   the replica's read from the replica process's own span file; the
   chrome trace loads; at sample rate 0 a request records no span; one
   id's warm tokens/s traced and unsampled (alternating passes) beside
   the multiplex phase's, tracing off. Then
   `perf.run_timeline_capture` (its merged trace holding the driver and
   workers), `wire_decode_bench` and the flight and metrics overhead
   benches, printed without a gate;
5d. microbench: `python -m ray_tpu_torch.perf --microbench`'s
   `run_microbench` on the cluster (tasks/s, actor calls/s, put/get
   10 MB, a 3-actor chain lazily and compiled, a 4 MB array over compiled
   `"array"` edges, on this machine's host), printed as a JSON line;
5e. perf twins: `ray_tpu_torch.perf`'s `run_llm_serve_bench` (its paged
   section's model on the card: paged parity 1, no host gather) and
   `run_fleet_bench`, each printed as a JSON line.
6. backward kernels: K2 (dK, dV) and K3 (dQ) against their plain versions
   at the shapes the train step gives them and a few more (bf16 and
   float32; a ragged block count, D 64, QKV views, a peaked softmax, and
   the D-256 phase's rows, as for K1), with
   error, time, achieved TFLOP/s, plain time, bound at the route's peak
   (float32 also at the tensor cores' 3xTF32 rate) and, as a yardstick
   for the pair, the backward of one `scaled_dot_product_attention` call
   (CUDA events, and the device time of its own kernels from
   `torch.profiler`); two launches on the same inputs must give
   bitwise-equal dQ, dK and dV;
7. gradients: `lm_loss` gradients at the flagship width (bf16, 2 x 1024
   tokens) through the kernels and through plain attention, each against a
   float32 plain-attention reference; the kernel path must be about as
   close to it as the plain path is, on every leaf, at full depth and
   again on the first 2 layers, where a 2% error in dK or dQ stands out
   of the bf16 noise (`tools/grad_gate_mutation.py` checks that it does);
8. float32 gradients: `lm_loss` gradients of a float32 model at the
   flagship width, depth cut to 2 layers (2 x 1024 tokens, remat
   "save_attn_qkv"), through K1, K2 and K3's float32 kernels against plain
   attention, leaf by leaf (wqkv split into q, k, v): rel L2 at most 1e-4
   on every part, each kernel launched once a layer;
9. train: bench.py's configuration and batch (bf16, remat with
   "save_attn_qkv", AdamW 1e-4, 16 x 1024 tokens) for 1 warm-up and 10
   timed steps on one fixed random batch: tokens/s, MFU, peak memory and
   kernel launches per step; every loss must be finite, the last below the
   first, and K1, K2 and K3 must each run once per layer per step. One
   more step runs under `torch.profiler`, which splits the card's time
   over its kernels;
9a. cluster train: that step through the Train library on the cluster
   runtime (`ray_tpu_torch.init(num_cpus=8)`): `TorchTrainer.fit` as a
   one-trial Tune job, one worker process leasing the card
   (`ScalingConfig(num_workers=1, use_gpu=True, gpus_per_worker=1)`,
   `TorchConfig()`: NCCL, world 1, `FailureConfig(max_failures=1)`), whose
   loop makes the flagship weights from this script's seed (checksummed
   against the driver's), runs the train phase's batch for 9 steps and
   reports each step's loss, ms and K1, K2, K3 launches with a
   checkpoint of the step. The driver SIGKILLs the worker after step 3;
   the gang restarts, leases the card again and resumes at step 4.
   Gated: every attempt's losses bitwise equal to the train phase's from
   its first step, K1, K2, K3 12 times a step, a
   `TrainConfig(profile_steps=(2, 3))` trace naming the three kernels,
   each step once in `Result.metrics_history`, and no port process left
   after shutdown. Prints the worker's step ms beside the train phase's
   and the restart's split (detect, group re-reserve, worker start with
   imports, first step);
9b. data: the Data library on the cluster runtime. (a) 48 sequences of
   512 tokens (numpy seed) in 12 blocks of 4 through
   `map_batches(FlagshipScorer, compute="actors", concurrency=2,
   num_gpus=0.5)`: two replica processes sharing the card, each making the
   float32 flagship from this script's seed and scoring each sequence by
   its mean logit; gated on the scores within 1e-3 (relative to their
   largest) of an in-process float32 forward of the same blocks, K1 (f32)
   launched 12 times a block in the replicas (144 in all), the stats'
   two `actor_pool_map[replica=N]` entries, and the replicas gone within
   10 s of the stage; sequences/s and tokens/s through the pool beside
   the in-process forward's. (b) 6 batches of bench.py's train shape
   (96 x 1025 tokens, numpy seed) as `from_numpy` in 12 blocks, then
   `random_shuffle(seed=0)`, into `TorchTrainer(datasets={"train": ds})`
   with one worker leasing the card (NCCL world 1), whose loop runs the
   train phase's step over `get_dataset_shard("train").iter_torch_batches(
   batch_size=16, drop_last=True)`; gated on its losses bitwise equal to
   the same steps run in-process on the batches the driver reads through
   `iter_batches`, in the same order, K1-K3 12 a step, every step's
   `data_wait` telemetry, no port process left; step ms beside the
   in-process step's, data_wait ms a step. (c) in that worker, before its
   first step, an `nccl` `util.collective` group of world 1 runs
   allreduce, allgather, broadcast, reducescatter and barrier on CUDA
   tensors, each giving its input back, and their seconds land in the
   step's `collective` telemetry;
9c. cgraph: the lazy DAG and compiled graphs on the cluster runtime. The
   float32 flagship forward split over two actors leasing 0.5 of the card
   each, `FlagshipHead` (the embedding and layers 0-5) and `FlagshipTail`
   (layers 6-11, the final norm, the tied-embedding logits, and from them
   each position's log-probability of the next token [4, 511] and the
   last position's logits [4, 32768]), each making the flagship weights
   from this script's seed (checksummed against the driver's) and keeping
   its half. `tail.score.bind(head.hidden.bind(inp).with_channel("array"),
   inp)`: the hidden state [4, 512, 1536] crosses as a CUDA tensor, host
   bytes re-landed on the tail's card. 24 batches of [4, 512] (numpy seed)
   in-process, through `dag.execute` (two actor tasks a batch, the hidden
   state through the object store) and through
   `experimental_compile(max_in_flight=4)` after one warm-up: ms a batch
   and sequences/s of each; gated on every output bitwise the in-process
   forward's, K1 (f32) 6 times a batch in each stage process (144 a run),
   the hidden state arriving in the tail as a CUDA tensor. Then an error
   fan-out (one execution of a window holds the id 32768: it alone raises
   the head's host-side range check), a SIGKILL of the tail with a window
   in flight (the next execute recompiles onto the restarted tail; its
   seconds split into detection, the tail's restart and the recompile;
   later outputs bitwise), teardown (no loop thread, no stage process
   within 10 s; card memory freed), the same halves as Serve deployments
   (0.25 GPU each) compiled by `serve.compile_deployment_chain` (8 batches
   bitwise), and a durable three-step workflow on the host whose middle
   step fails once: FAILED, then `workflow.resume` loads the first step's
   checkpoint and reads SUCCEEDED. No port process is left after shutdown;
9c1. rllib: RLlib with its learners on the card and its env runners as
   CPU actors of `init(num_cpus=4)`. (a) IMPALA at `IMPALAConfig`'s
   defaults (2 runners of 4 envs, fragments of 32, 2 fragments an update:
   256 frames and 8 bootstrap frames) on `SyntheticAtariEnv` with
   `model="auto"`: the Nature-CNN module at full width (84x84x4 ->
   512, 1,686,180 parameters) learning on cuda:0; a warm-up iteration and
   a measured one (20 updates each): env steps/s, updates/s, the
   learner's ms an update (CUDA events); then one `APPOConfig` iteration.
   (b) PPO at `rllib/bench.py main()`'s configuration (2 runners x 8 envs
   x 64 steps, 4 epochs, minibatch 256) on `CartPoleFixture` (CartPole's
   dynamics in numpy: the card's machine has no gymnasium): one
   iteration and its keys. (c) `LearnerGroup(num_learners=1)`: a learner
   process leasing the card (NCCL, world 1) takes PPO's first batch,
   against the local learner on the card from the same seed. Gated: the
   first IMPALA and PPO updates on the card against the same updates on
   the CPU from the same weights and batch, and the remote learner's
   against the local one's, each within `RLLIB_UPDATE_REL_L2` (relative
   L2 of the update) and `RLLIB_STATS_RTOL`; finite losses; the remote
   learner's device, backend and lease. (d) DQN at `DQNConfig`'s defaults
   (2 runners x 4 envs x 16 steps, batch 64, 50 updates an iteration,
   hiddens (64, 64), double-Q) with prioritized replay and
   `learning_starts=256` on `CartPoleFixture`, three iterations (the third
   measured: learner ms an update by CUDA events, updates/s, env
   steps/s), built together with multi-agent PPO (`TargetMatchFixture`,
   the reference test's env: 2 agents, one-hot targets of 4, 8-step
   episodes; independent policies p0 and p1 of hiddens (32,), 2 runners,
   fragments of 64), one iteration (per-policy update ms). Gated: every
   learner on cuda:0; DQN's updates 1 and 51 against the CPU from the
   same online and target weights, Adam state and prioritized batch
   (|td| per sample where double-Q's argmax agrees; the disagreements
   printed), importance weights other than 1 in the batches; each
   policy's first update against its CPU twin; finite losses,
   `learner/p0/total_loss` and `learner/p1/total_loss`. (e) The state API
   lists the four runners ALIVE and counts their `sample` calls, and none
   ALIVE after `stop()`; a `Queue` (0.25 GPU) carries 1 MiB of float32
   from a 0.25-GPU actor's card to the driver's `cuda:0`, bitwise;
   `Pool(2).map` equals `map`. No port process left;
9d. d256: heads of 256. The flagship's widths with 6 heads of 256 in place
   of 12 of 128 (the same 503,354,880 parameters, from the same seed)
   through the engine phase (float32, its 8 prompts and 32 new tokens, its
   gates: logits within 1e-3 of a no-cache forward, token agreement, K1 12
   a no-prefix prefill), the bf16 gradient gate at depth 2, float32
   gradients at depth 2 (rel L2 1e-4 per part, K1-K3 once a layer) and 5
   steps of bench.py's train step (losses finite and falling, K1-K3 12 a
   step, one profiled step). Fails if `plain_attention` runs on the card
   other than as a reference (explicit positions). K1, K2 and K3 run their
   D-256 instantiations (`flash_bwd_*_tc_wide` in bf16), which the kernel
   phases hold to their plain versions on rows of their own;
10. MoE float32 gradients: the same widths with 4 experts (top 2, capacity
    factor 1.25), depth 2, float32, 2 x 1024 tokens, remat
    "save_attn_qkv": `lm_loss` gradients through K1, K2 and K3's float32
    kernels against plain attention. First the routing: each layer's
    choices per token on both paths (and in the kernel path's recompute),
    with the number of token-layer pairs that differ; a difference is a
    tie only where the router probabilities it turns on lie within 1e-5,
    and anything else fails. With equal routing every part (wqkv split
    into q, k, v; router, moe_w1, moe_w2 whole) must agree within 1e-4
    rel L2; a tie is printed and excuses that bound for the run;
11. MoE train: that model at full depth (1,069,659,648 parameters; bf16,
    remat "save_attn_qkv", AdamW 1e-4, 8 x 1024 tokens of one fixed
    batch), 1 warm-up and 5 timed steps: step ms, tokens/s, peak memory;
    every loss and every step's aux finite, aux > 0, the last loss below
    the first, and K1, K2, K3 once per layer per step. Then one profiled
    step and the forward FLOPs of the dispatch and combine products
    against the experts' (by count), beside each part's CUDA-event time in
    one layer at the step's shapes;
12. mesh train: the parallel layer on `make_mesh()` of this one card (every
    axis 1, which JAX treats as unsharded): bench.py's dense step through
    `init_sharded` (DTensor params), `batch_sharding`, `make_train_step`
    and `lm_loss(..., mesh=mesh)`. Its first 3 steps against two
    mesh-free runs from the same init and batch: bitwise equal losses and
    params when the two mesh-free runs agree bitwise, else within twice
    their difference. Then 10 timed steps (K1, K2, K3 once per layer per
    step, the loss falling) and one profiled step, each beside the
    mesh-free step of phase 9: the host cost of the mesh path;
13. pipeline float32: `lm_loss_pipelined` (one stage, 2 microbatches) at
    depth 2 on 2 x 1024 tokens against the unpipelined plain-attention
    path from the same weights: the loss and every gradient part within
    1e-5 rel L2; K1-K3 launch no time (the pipelined path takes plain
    attention, as JAX's does);
14. pipeline train: the bf16 pipelined step at full depth, 16 x 1024
    tokens in 2 microbatches, 1 warm-up and 3 timed steps: step ms and
    peak memory, losses finite and falling.

Then it prints a `{"kernels": [...]}` line and, last, the result line
`{"ok": true, "device": {...}}`. It imports nothing of JAX or of `ray_tpu`.
Without a CUDA card, or run away from the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import re
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
# float32 is the CUDA cores' rate, the route of every float32 kernel.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# float32 products on the tensor cores as 3xTF32 (three TF32 passes at 495
# TFLOP/s dense): the bound the float32 K2 and K3 would have there, printed
# beside their own. tools/tf32x3_products.py measured that route missing
# the float32 tolerance, so they run on the CUDA cores (PERF.md).
PEAK_FLOPS_F32_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12
FULL_POWER_W = 700.0

# Flagship configuration (bench.py's model): V32768 D1536 L12 H12 F6144.
FLAGSHIP = dict(vocab_size=32768, d_model=1536, n_layers=12, n_heads=12,
                d_ff=6144, max_seq_len=1024)

# Tolerances (atol, rtol). float32: the kernel and its plain version
# differ only in summation order. bf16: the plain version rounds p where
# the kernel does, so the two differ by float32 noise, which can move the
# bf16 output by one ulp (at most 2^-7 of it), plus a p-rounding term (see
# p_flip_bound).
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2.0 ** -7)}
# bf16 forward: both attention paths round at 8 mantissa bits, at different
# places, and the difference grows through 12 bf16 layers (flash vs plain
# logits differ by some 1.6e-2 relative L2 on the H100). So each path is
# held against a float32 forward, and the flash path must be about as close
# to it as the plain path is.
FORWARD_ERR_RATIO = 1.25
# float32 engine vs no-cache float32 forward: absolute logit error (logits
# are O(1) at this init); padding, buckets and summation order differ.
ENGINE_LOGIT_ATOL = 1e-3
# Greedy continuation, teacher-forced on the engine's own tokens: a token
# may differ only where the reference's top two logits tie within the
# logit tolerance; below this share of agreeing tokens the run fails.
MIN_TOKEN_AGREEMENT = 0.98

# (shape [B, S, H, D], dtype, layout, factor on q and k); the engine
# prefills f32. Layout "qkv" passes q, k, v as views of one [B, S, 3, H, D]
# tensor, the fused QKV projection's layout the engine hands the kernel
# (its v is such a view), so rows are 3 H D elements apart. Row i draws its
# inputs from seed i, so new rows go at the end. Then: a ragged block
# count (S 384: three 128-row blocks), D 64 at the train shape, q and k
# scaled by 4, whose peaked softmax moves the running max from tile to
# tile and puts p near 1 and 0, where the rounding of p acts, and the MoE
# train step's shape (96 (batch, head) pairs: K1's block groups of 64
# pairs at D 128 split 64 + 32 there, as at no other row), and the float32
# blocks `phase_data`'s actor pool scores (48 pairs), v a view of the fused
# projection there as in the model.
KERNEL_SHAPES = [
    ((1, 128, 12, 128), "float32", "contiguous", 1.0),
    ((1, 256, 12, 128), "float32", "contiguous", 1.0),
    ((1, 512, 12, 128), "float32", "contiguous", 1.0),
    ((1, 1024, 12, 128), "float32", "contiguous", 1.0),
    ((1, 1024, 12, 128), "float32", "qkv", 1.0),
    ((1, 1024, 12, 128), "bfloat16", "contiguous", 1.0),
    ((4, 1024, 12, 128), "bfloat16", "contiguous", 1.0),
    ((1, 256, 12, 64), "bfloat16", "contiguous", 1.0),
    ((16, 1024, 12, 128), "bfloat16", "qkv", 1.0),   # the train step's K1
    ((2, 384, 3, 128), "bfloat16", "contiguous", 1.0),
    ((16, 1024, 12, 64), "bfloat16", "qkv", 1.0),
    ((4, 1024, 12, 128), "bfloat16", "qkv", 4.0),
    ((8, 1024, 12, 128), "bfloat16", "qkv", 1.0),    # the MoE train step's
    ((4, 512, 12, 128), "float32", "qkv", 1.0),      # the data pool's blocks
    # Heads of 256 (`phase_d256`): its train step's, its engine's largest
    # bucket, a ragged block count in both types, a peaked softmax.
    ((16, 1024, 6, 256), "bfloat16", "qkv", 1.0),
    ((1, 1024, 6, 256), "float32", "qkv", 1.0),
    ((2, 384, 3, 256), "bfloat16", "contiguous", 1.0),
    ((2, 384, 3, 256), "float32", "contiguous", 1.0),
    ((4, 1024, 6, 256), "bfloat16", "qkv", 4.0),
]
# The engine's largest bucket, the train step's shape and the MoE train
# step's.
MAIN_SHAPE = ((1, 1024, 12, 128), "float32", "contiguous", 1.0)
TRAIN_SHAPE = ((16, 1024, 12, 128), "bfloat16", "qkv", 1.0)
MOE_TRAIN_SHAPE = ((8, 1024, 12, 128), "bfloat16", "qkv", 1.0)
# K2 and K3: (shape, dtype, layout, factor on q and k). The train step's
# shape (bf16, bench.py's batch; q and k come out of the rotary embedding,
# v is a view of the fused QKV projection, so "qkv" is the stricter
# layout), the serving width in both types, D 64, a ragged block count (S
# 384: three 128-row blocks, six 64-row tiles), D 64 at the train shape,
# and q and k scaled by 4, whose peaked softmax puts p near 1 and 0 on and
# off the diagonal, where the mask and the rounding of p act. Then the
# float32 route at the serving width as QKV views, D 64, a ragged block
# count and a peaked softmax; last, the MoE train step's shape. Row i draws its inputs from seed 100 +
# 2 i, so new rows go at the end.
BWD_SHAPES = [
    ((1, 1024, 12, 128), "float32", "contiguous", 1.0),
    ((1, 1024, 12, 128), "bfloat16", "contiguous", 1.0),
    ((16, 1024, 12, 128), "bfloat16", "qkv", 1.0),
    ((1, 1024, 12, 64), "bfloat16", "contiguous", 1.0),
    ((2, 384, 3, 128), "bfloat16", "contiguous", 1.0),
    ((16, 1024, 12, 64), "bfloat16", "qkv", 1.0),
    ((4, 1024, 12, 128), "bfloat16", "qkv", 4.0),
    ((1, 1024, 12, 128), "float32", "qkv", 1.0),
    ((1, 1024, 12, 64), "float32", "contiguous", 1.0),
    ((2, 384, 3, 128), "float32", "contiguous", 1.0),
    ((4, 1024, 12, 128), "float32", "qkv", 4.0),
    MOE_TRAIN_SHAPE,
    # Heads of 256 (`phase_d256`): its train step's, the float32 route at
    # its serving width, a ragged block count in both types, a peaked
    # softmax.
    ((16, 1024, 6, 256), "bfloat16", "qkv", 1.0),
    ((1, 1024, 6, 256), "float32", "qkv", 1.0),
    ((2, 384, 3, 256), "bfloat16", "contiguous", 1.0),
    ((2, 384, 3, 256), "float32", "contiguous", 1.0),
    ((4, 1024, 6, 256), "bfloat16", "qkv", 4.0),
]
MAIN_BWD_SHAPE = ((16, 1024, 12, 128), "bfloat16", "qkv", 1.0)
# The float32 route's row reported in the kernels line.
F32_BWD_SHAPE = ((1, 1024, 12, 128), "float32", "contiguous", 1.0)
# The rows of heads of 256 reported in the kernels line (K1, K2, K3): the
# D-256 train step's (bf16) and the float32 route at its serving width.
D256_SHAPE = ((16, 1024, 6, 256), "bfloat16", "qkv", 1.0)
D256_F32_SHAPE = ((1, 1024, 6, 256), "float32", "qkv", 1.0)
# K2/K3 against their plain versions, (atol, rtol) plus, in bf16,
# `bwd_flip_bound`. float32: summation order only. bf16: both sides round p
# and ds where the TPU kernel does, so they differ by float32 noise, which
# can move a bf16 output by one ulp (at most 2^-7 of it) or flip the
# rounding of a p or ds term.
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2.0 ** -7)}
# Flipped roundings of p or ds allowed per output row in bf16: a flip needs
# the two sides' float32 values to straddle a rounding boundary, some 1e-5
# of elements.
BWD_FLIPS_PER_ROW = 2
# bench.py's train step.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
GRAD_BATCH = 2
# bf16 gradients: both attention paths round at 8 mantissa bits, at
# different places, so each is held against a float32 reference and the
# kernel path must be about as close to it as the plain path is, leaf by
# leaf, with wqkv split into its q, k and v parts, which dQ, dK and dV
# each reach alone (this implies it on whole leaves, on the worst leaf and
# on the mean). tools/grad_faults.py reads what it catches.
GRAD_ERR_RATIO = 1.25
# The same gate on the model's first GRAD_GATE_LAYERS layers: the plain
# path's bf16 distance to float32 on the q and k parts grows with depth
# (1.3% at depth 1, 2.2% at 2, 3.3% at 12; tools/grad_faults.py
# --depth), and at full depth a 2% error in dK or dQ reads 1.22-1.27 x
# plain, within the gate. At depth 2 it reads 1.55 and passes no gate,
# where the kernels read 0.99-1.02 (seeds 0 and 1).
GRAD_GATE_LAYERS = 2
# float32 gradients, kernels against plain attention: both sides are
# float32 and differ only in attention's summation order (some 1e-6
# relative L2); the depth is cut to F32_GRAD_LAYERS.
F32_GRAD_REL_L2 = 1e-4
F32_GRAD_LAYERS = 2
# The MoE flagship: bench.py's widths with 4 experts (as
# `__graft_entry__.py`'s MoE flagship), top 2, capacity factor 1.25. Its
# train step takes 8 x 1024 tokens: the dense dispatch and combine tensors
# [T, E, C] grow as T^2 / E (C = 5120 at T = 8192: 0.67 GB in float32).
MOE = dict(num_experts=4, moe_top_k=2, capacity_factor=1.25)
MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 8, 5
# A routing choice that differs between two paths is a tie when the
# consecutive router probabilities it turns on (among the top k + 1 of its
# token) lie within this: the paths' float32 attention differs by some
# 1e-6 relative.
ROUTE_TIE_GAP = 1e-5
# Token batches of the MoE float32 gradient phase, tried in turn until one
# routes alike on both paths.
MOE_GRAD_SEEDS = (31, 32, 33)


# The parallel layer on the mesh of one card (all axes 1): the mesh train
# step is checked against the mesh-free step for MESH_CHECK_STEPS steps
# from the same init and batch, then timed for TRAIN_STEPS more. The
# pipeline runs PIPE_MICRO microbatches: in float32 at depth
# PIPE_F32_LAYERS on PIPE_F32_BATCH x TRAIN_SEQ tokens against the
# unpipelined plain-attention path (the same float32 math cut into
# microbatches, so some 1e-7 relative; JAX's pipeline takes plain
# attention too), then in bf16 at full depth for 1 + PIPE_TRAIN_STEPS
# steps.
MESH_CHECK_STEPS = 3
PIPE_MICRO = 2
PIPE_F32_LAYERS, PIPE_F32_BATCH = 2, 2
PIPE_GRAD_REL_L2 = 1e-5
PIPE_TRAIN_STEPS = 3


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sass_mma_counts(library) -> dict:
    """{kernel function: (HGMMA, HMMA)}: the tensor-core instructions
    (wgmma, mma.sync) in each function's SASS in a built library, read
    with the toolkit's cuobjdump."""
    from ray_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise PhaseError(f"cuobjdump failed: {out.stderr.strip()}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += " HMMA" in line
    return {f: tuple(c) for f, c in counts.items()}


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_flops(shape) -> float:
    """Operations of causal attention: 2 B H S (S+1) D, the lower triangle
    of Q K^T and of P V."""
    b, s, h, d = shape
    return 2.0 * b * h * s * (s + 1) * d


def attention_bound(shape, dtype: str, power_w: float):
    """(bound_ms at the published peaks, bound_ms derated to the power
    limit, what sets it) for causal attention: `attention_flops` operations
    and q, k, v read once, o written once."""
    b, s, h, d = shape
    flops = attention_flops(shape)
    nbytes = 4.0 * b * s * h * d * (4 if dtype == "float32" else 2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    derate = max(1.0, FULL_POWER_W / power_w) if power_w > 0 else 1.0
    return bound, bound * derate, ("operations" if t_ops >= t_bytes
                                   else "bytes")


def p_flip_bound(q, k, v, lse):
    """[B, S, H, D] bound on what a flipped bf16 rounding of p can do to
    o: where the two sides' float32 p straddle a rounding boundary, the
    casts differ by one ulp, at most 2^-7 of p, which moves o[row, :] by at
    most 2^-7 * max_j prob[row, j] * |v[j, :]| over keys j <= row."""
    import torch

    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    row_max = scores.masked_fill(~mask, float("-inf")).amax(-1)
    p_max = torch.exp(row_max - lse).transpose(1, 2)[..., None]
    v_max = torch.cummax(v.float().abs(), dim=1).values
    return 2.0 ** -7 * p_max * v_max


def kernel_inputs(shape, dtype: str, layout: str, qk_scale: float,
                  seed: int):
    """q, k, v of one K1 row: normal draws from `seed`, q and k times
    `qk_scale` (exact when it is 1), cast to `dtype`; views of one
    [B, S, 3, H, D] tensor when `layout` is "qkv"."""
    import torch

    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if layout == "qkv":
        b, s, h, d = shape
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
        qkv[:, :, :2] *= qk_scale
        return qkv.to(dt).unbind(2)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    return (q * qk_scale).to(dt), (k * qk_scale).to(dt), v.to(dt)


def fwd_errors(q, k, v, out, lse):
    """(max abs error, worst diff/tol, a note on the tolerance, max abs
    lse error) of K1's (out, lse) against its plain version on the same
    inputs, under KERNEL_TOL (plus, in bf16, `p_flip_bound`). The gate:
    worst diff/tol <= 1 and lse error <= 1e-3."""
    from ray_tpu_torch.kernels import flash_attn

    ref, ref_lse = flash_attn.flash_attn_fwd_plain(q, k, v,
                                                   return_lse=True)
    dtype = str(q.dtype).removeprefix("torch.")
    diff = (out.float() - ref.float()).abs()
    atol, rtol = KERNEL_TOL[dtype]
    tol = atol + rtol * ref.float().abs()
    note = ""
    if dtype == "bfloat16":
        note = (f" + p_flip_bound; without it: worst diff/tol "
                f"{(diff / tol).max().item():.3f}, "
                f"{int((diff > tol).sum())} of {diff.numel()} "
                f"elements over")
        tol = tol + p_flip_bound(q, k, v, ref_lse)
        note += f"; median tol {tol.median().item():.3e}"
    return (diff.max().item(), (diff / tol).max().item(), note,
            (lse - ref_lse).abs().max().item())


def phase_kernels(card: str, power_w: float):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels import flash_attn

    rows = {}
    for shape, dtype, layout, qk_scale in KERNEL_SHAPES:
        q, k, v = kernel_inputs(shape, dtype, layout, qk_scale, len(rows))
        out, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
        out2, lse2 = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        tag = f"{dtype} {list(shape)} {layout}" + (
            f" q,k x{qk_scale:g}" if qk_scale != 1.0 else "")
        check(torch.equal(out, out2) and torch.equal(lse, lse2),
              f"flash_attn_fwd {tag}: two launches on the same inputs "
              f"differ")
        del out2, lse2
        err, worst, note, lse_err = fwd_errors(q, k, v, out, lse)
        atol, rtol = KERNEL_TOL[dtype]
        ms = cuda_ms(lambda: flash_attn.flash_attn_fwd(q, k, v), 20)
        plain_ms = cuda_ms(
            lambda: flash_attn.flash_attn_fwd_plain(q, k, v), 5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 20)
        bound, derated, bound_by = attention_bound(shape, dtype, power_w)
        tflops = attention_flops(shape) / ms / 1e9
        rows[(shape, dtype, layout, qk_scale)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_ms_at_power_limit=derated, bound_by=bound_by,
            library_ms=library_ms)
        print(f"kernel flash_attn_fwd {tag}: "
              f"max_abs_err {err:.3e} (tol {atol:g} + {rtol:g}|ref|"
              f"{note}; worst diff/tol {worst:.3f}; bitwise-equal over two "
              f"launches) lse_err {lse_err:.3e} kernel_ms {ms:.4f} "
              f"achieved_tflops {tflops:.1f} plain_ms {plain_ms:.4f} "
              f"library_ms {library_ms:.4f} "
              f"bound_us {bound * 1e3:.2f} ({bound_by}; "
              f"{derated * 1e3:.2f} at the power limit) [{card}]",
              flush=True)
        check(worst <= 1 and lse_err <= 1e-3,
              f"flash_attn_fwd {tag} disagrees "
              f"with its plain version: max_abs_err {err:.3e}, "
              f"lse_err {lse_err:.3e}")
    return rows


def phase_forward(params, cfg, card: str):
    from dataclasses import replace

    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import forward

    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    flash_attn.launches = 0
    logits, _ = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = flash_attn.launches
    plain, _ = forward(params, tokens, cfg, positions=torch.arange(1024))
    check(flash_attn.launches == launches,
          "the plain-attention forward launched the kernel")
    check(tuple(logits.shape) == (1, 1024, cfg.vocab_size),
          f"forward logits have shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "forward logits not finite")
    exact, _ = forward(params, tokens, replace(cfg, dtype=torch.float32),
                       positions=torch.arange(1024))

    def rel_l2(x, y):
        return ((x.float() - y).norm() / y.norm()).item()

    a, b = logits.float(), plain.float()
    rel = rel_l2(a, b)
    err_flash, err_plain = rel_l2(a, exact), rel_l2(b, exact)
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    ms = cuda_ms(lambda: forward(params, tokens, cfg), 5, warmup=1)
    plain_ms = cuda_ms(lambda: forward(params, tokens, cfg,
                                       positions=torch.arange(1024)),
                       5, warmup=1)
    print(f"forward flagship bf16 [1, 1024]: kernel launches {launches} "
          f"(layers {cfg.n_layers}); rel_l2 to a float32 forward: flash "
          f"{err_flash:.3e}, plain {err_plain:.3e} (flash <= "
          f"{FORWARD_ERR_RATIO:g} x plain); flash vs plain rel_l2 "
          f"{rel:.3e} max_abs {(a - b).abs().max().item():.3e} "
          f"top1_agreement {top1:.4f} forward_ms {ms:.3f} "
          f"plain_attention_forward_ms {plain_ms:.3f} [{card}]", flush=True)
    check(launches == cfg.n_layers,
          f"forward launched the kernel {launches} times, expected "
          f"{cfg.n_layers}")
    check(err_flash <= FORWARD_ERR_RATIO * err_plain,
          f"the flash forward is further from float32 ({err_flash:.3e}) "
          f"than the plain one ({err_plain:.3e}) allows")


# The engine phase's engine and traffic (the serve phase's too): a paged
# pool of 256 16-token blocks, batch 8; 8 prompts of 128-640 tokens, 4 of
# them sharing a 256-token prefix, ENGINE_NEW new tokens each.
ENGINE_CONFIG = dict(paged_decode=True, block_size=16, num_blocks=256,
                     max_batch_size=8)
ENGINE_NEW = 32


def engine_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(5)
    shared = rng.integers(2, cfg.vocab_size, 256).tolist()
    prompts = [rng.integers(2, cfg.vocab_size, n).tolist()
               for n in (128, 200, 384, 520)]
    prompts += [shared + rng.integers(2, cfg.vocab_size, n - 256).tolist()
                for n in (320, 448, 576, 640)]
    return prompts


def phase_engine(params, cfg, card: str, label: str = "flagship"):
    """Returns the K1 launches and the measured pass's tokens/s."""
    import numpy as np
    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import forward
    from ray_tpu_torch.serve.engine import (EngineConfig, InferenceEngine,
                                            TransformerEngineModel)

    class Recording(TransformerEngineModel):
        """Keeps each prompt's first prefill logits and counts the
        prefills that start from no cached prefix."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first_logits = {}
            self.full_prefills = 0

        def prefill(self, tokens, prefix_kv=None):
            logits, kv = super().prefill(tokens, prefix_kv)
            self.full_prefills += prefix_kv is None
            self.first_logits.setdefault(tuple(tokens), logits)
            return logits, kv

        def prefill_paged(self, tokens, *a, **k):
            logits, kv = super().prefill_paged(tokens, *a, **k)
            self.first_logits.setdefault(tuple(tokens), logits)
            return logits, kv

    def serve(engine):
        engine.start()
        try:
            t0 = time.perf_counter()
            streams = [engine.submit(p, max_new) for p in prompts]
            outs = [list(s) for s in streams]   # raises a request's error
            wall = time.perf_counter() - t0
        finally:
            engine.stop()
        return streams, outs, wall

    model = Recording(params, cfg)
    config = EngineConfig(**ENGINE_CONFIG)
    prompts = engine_prompts(cfg)
    max_new = ENGINE_NEW
    # Warm-up pass on an engine of its own: cuBLAS picks its GEMMs and the
    # allocator grows on first use, which a single cold pass would time.
    serve(InferenceEngine(model, config))
    model.first_logits.clear()
    model.full_prefills = 0
    engine = InferenceEngine(model, config)
    flash_attn.launches = 0
    streams, outs, wall = serve(engine)
    launches = flash_attn.launches
    st = engine.stats()
    n_tokens = sum(len(o) for o in outs)
    check(all(s.finished for s in streams), "a request did not finish")
    check(launches > 0 and launches == cfg.n_layers * model.full_prefills,
          f"prefill launched the kernel {launches} times for "
          f"{model.full_prefills} no-prefix prefills of {cfg.n_layers} "
          f"layers")
    check(st["prefix_hit_tokens"] > 0, "no prefix was shared")
    # The metrics push that `step` makes once a step, on this host.
    t0 = time.perf_counter()
    for _ in range(1000):
        engine._update_gauges()
    gauge_us = (time.perf_counter() - t0) * 1e3

    agree = total = first_ok = 0
    worst = 0.0
    for prompt, gen in zip(prompts, outs):
        seq = prompt + gen[:-1]
        ref, _ = forward(params, [seq], cfg,
                         positions=torch.arange(len(seq)))
        ref = ref[0].float().cpu().numpy()
        n = len(prompt)
        got = model.first_logits[tuple(prompt)]
        worst = max(worst, float(np.abs(got - ref[n - 1]).max()))
        tie = ref[n - 1].max() - ref[n - 1][gen[0]] <= ENGINE_LOGIT_ATOL
        first_ok += gen[0] == int(ref[n - 1].argmax()) or tie
        picks = ref[n - 1:n - 1 + len(gen)].argmax(-1)
        agree += int((picks == np.asarray(gen)).sum())
        total += len(gen)
    share = agree / total
    print(f"engine {label} f32 paged: {len(prompts)} requests, "
          f"{n_tokens} tokens in {wall:.3f} s, tokens_per_s "
          f"{n_tokens / wall:.2f}, ttft_p50_ms {st['ttft_p50_ms']}, "
          f"prefills {st['prefills']} (no-prefix {model.full_prefills}), "
          f"prefix_hit_tokens {st['prefix_hit_tokens']}, kernel launches "
          f"{launches}, preemptions {st['preemptions']}, "
          f"prefill_s {st['prefill_s']} decode_s {st['decode_s']} "
          f"(kv_gather_s {st['kv_gather_s']} model_step_s "
          f"{st['model_step_s']}, {st['steps']} steps), gauge push "
          f"{gauge_us:.2f} us a step [{card}]", flush=True)
    print(f"engine vs no-cache forward: prefill logits max_abs_err "
          f"{worst:.3e} (tol {ENGINE_LOGIT_ATOL:g}), first tokens "
          f"{first_ok}/{len(prompts)}, token agreement {agree}/{total} "
          f"= {share:.4f} [{card}]", flush=True)
    check(worst <= ENGINE_LOGIT_ATOL,
          f"engine prefill logits differ from forward by {worst:.3e}")
    check(first_ok == len(prompts), "a first token differs from forward")
    check(share >= MIN_TOKEN_AGREEMENT,
          f"greedy token agreement {share:.4f} < {MIN_TOKEN_AGREEMENT}")
    return launches, n_tokens / wall


# The serving fleet: FLEET_REPLICAS flagship float32 replicas over one
# parameter set, each an engine with a pool of FLEET_BLOCKS 16-token blocks
# (147,456 B of KV a token: 1.2 GB a replica). FLEET_CONVS conversations of
# FLEET_NEW new tokens share a FLEET_SHARED-token system prompt (32 sealed
# blocks; a cold prefill's bucket of 1024 runs K1), each with its own tail
# of 3 to 16 tokens. Recovery: replica-0 dies on its FLEET_KILL_AT-th
# streamed token of one FLEET_RECOVER_NEW-token conversation. The ship
# timing repeats one ship FLEET_SHIP_REPEATS times.
FLEET_REPLICAS, FLEET_BLOCKS = 3, 512
FLEET_SHARED, FLEET_CONVS, FLEET_NEW = 512, 12, 32
FLEET_KILL_AT, FLEET_RECOVER_NEW = 8, 40
FLEET_SHIP_REPEATS = 5


def hold_to_forward(params, cfg, prompt, gen):
    """A stream against a no-cache float32 forward over prompt + gen[:-1],
    teacher-forced: (the forward's logits at the prompt's last position,
    whether the first token is its argmax or ties it within
    ENGINE_LOGIT_ATOL, tokens that are the forward's argmax, tokens)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import forward

    seq = prompt + gen[:-1]
    ref, _ = forward(params, [seq], cfg, positions=torch.arange(len(seq)),
                     device=params["embed"].device)
    ref = ref[0].float().cpu().numpy()
    n = len(prompt)
    first = ref[n - 1]
    first_ok = bool(gen[0] == int(first.argmax())
                    or first.max() - first[gen[0]] <= ENGINE_LOGIT_ATOL)
    picks = ref[n - 1:n - 1 + len(gen)].argmax(-1)
    return first, first_ok, int((picks == np.asarray(gen)).sum()), len(gen)


def phase_fleet(params, cfg, card: str):
    """Three flagship replicas behind `ServeFleet`: a cold burst (KV-aware
    routing and shipping off), a warm burst (on, after one warm-up
    conversation), one ship timed by its parts, and a seeded replica kill.
    Returns the K1 launches of each part."""
    import numpy as np
    import torch

    from ray_tpu_torch.core.faults import FaultPlan
    from ray_tpu_torch.serve.engine import (EngineConfig,
                                            TransformerEngineModel)
    from ray_tpu_torch.serve.fleet import (FleetConfig, ServeFleet,
                                           decode_prefix_frames,
                                           encode_prefix_frames)

    class Recording(TransformerEngineModel):
        """Keeps each prompt's first prefill logits (one dict a replica)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.first_logits = {}

        def prefill(self, tokens, prefix_kv=None):
            logits, kv = super().prefill(tokens, prefix_kv)
            self.first_logits.setdefault(tuple(tokens), logits)
            return logits, kv

        def prefill_paged(self, tokens, *a, **k):
            logits, kv = super().prefill_paged(tokens, *a, **k)
            self.first_logits.setdefault(tuple(tokens), logits)
            return logits, kv

    rng = np.random.default_rng(8)
    shared = rng.integers(2, cfg.vocab_size, FLEET_SHARED).tolist()
    prompts = [shared + rng.integers(2, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(3, 17, FLEET_CONVS)]
    engine_config = EngineConfig(max_batch_size=8, block_size=16,
                                 num_blocks=FLEET_BLOCKS, paged_decode=True)

    def make_fleet(kv_routing, shipping, plan=None):
        return ServeFleet(FleetConfig(
            model_factory=lambda: Recording(params, cfg,
                                            params["embed"].device),
            num_replicas=FLEET_REPLICAS, engine_config=engine_config,
            kv_routing=kv_routing, shipping=shipping,
            digest_max_age_s=0.01, fault_plan=plan))

    def warm_up(fleet):
        """One request on each replica's engine, straight past the
        router, on a prompt of its own (no prefix of the measured
        traffic): the first prefill at the 1024 bucket and the first
        decode steps of each engine thread leave the timed burst."""
        streams = [fleet.replica(rid).engine.submit(
            rng.integers(2, cfg.vocab_size, FLEET_SHARED + 8).tolist(), 4)
            for rid in fleet.live_replicas()]
        for stream in streams:
            list(stream)

    def burst(fleet):
        t0 = time.perf_counter()
        convs = [fleet.submit(p, FLEET_NEW, session_id=f"s{i}")
                 for i, p in enumerate(prompts)]
        outs = [list(c.stream) for c in convs]   # raises a lost stream
        wall = time.perf_counter() - t0
        return convs, outs, wall

    def engine_split(fleet):
        """Engine time summed over the replicas (stats() are
        cumulative, warm-up included)."""
        sts = [fleet.replica(r).engine.stats() for r in fleet.live_replicas()]
        return (f"engines: prefill_s {sum(s['prefill_s'] for s in sts):.3f} "
                f"decode_s {sum(s['decode_s'] for s in sts):.3f} "
                f"(model_step_s {sum(s['model_step_s'] for s in sts):.3f}) "
                f"steps {sum(s['steps'] for s in sts)} prefills "
                f"{sum(s['prefills'] for s in sts)}")

    def p50_ms(convs):
        ts = sorted(c.first_token_at - c.submitted_at for c in convs)
        return round(ts[len(ts) // 2] * 1e3, 3) if ts else None

    def hold(fleet, convs, outs, what):
        """Every conversation against the no-cache forward: prefill logits
        within ENGINE_LOGIT_ATOL, first token, token agreement."""
        worst = 0.0
        agree = total = first_ok = 0
        for conv, gen in zip(convs, outs):
            model = fleet.replica(conv.owner).engine.model
            first, ok, a, t = hold_to_forward(params, cfg, conv.prompt, gen)
            got = model.first_logits[tuple(conv.prompt)]
            worst = max(worst, float(np.abs(got - first).max()))
            first_ok += ok
            agree += a
            total += t
        share = agree / total
        print(f"fleet {what} vs no-cache forward: prefill logits "
              f"max_abs_err {worst:.3e} (tol {ENGINE_LOGIT_ATOL:g}), first "
              f"tokens {first_ok}/{len(convs)}, token agreement "
              f"{agree}/{total} = {share:.4f} [{card}]", flush=True)
        check(worst <= ENGINE_LOGIT_ATOL,
              f"fleet {what}: prefill logits differ from forward by "
              f"{worst:.3e}")
        check(first_ok == len(convs), f"fleet {what}: a first token "
              f"differs from forward")
        check(share >= MIN_TOKEN_AGREEMENT, f"fleet {what}: greedy token "
              f"agreement {share:.4f} < {MIN_TOKEN_AGREEMENT}")

    launches = {}
    # -- cold: least-loaded placement, every replica prefills the prompt --
    fleet = make_fleet(kv_routing=False, shipping=False)
    fleet.start()
    try:
        warm_up(fleet)
        _zero_counts()
        convs, outs, wall = burst(fleet)
        launches["cold"] = _counts()[0]
        cold = dict(tokens_per_s=sum(map(len, outs)) / wall,
                    ttft_p50_ms=p50_ms(convs), lost=fleet.lost_conversations)
        print(f"fleet cold: {FLEET_REPLICAS} replicas, {len(convs)} "
              f"conversations, {sum(map(len, outs))} tokens in {wall:.3f} s, "
              f"tokens_per_s {cold['tokens_per_s']:.2f}, ttft_p50_ms "
              f"{cold['ttft_p50_ms']}, K1 launches {launches['cold']}, lost "
              f"{cold['lost']}, {engine_split(fleet)} [{card}]", flush=True)
        hold(fleet, convs, outs, "cold")
    finally:
        fleet.stop()
    check(launches["cold"] >= FLEET_REPLICAS * cfg.n_layers,
          f"the cold burst launched K1 {launches['cold']} times, fewer than "
          f"one prefill a replica")

    # -- warm: one holder, shipped to the replicas the burst spills onto --
    fleet = make_fleet(kv_routing=True, shipping=True)
    fleet.start()
    try:
        warm_up(fleet)
        _zero_counts()
        warm_conv = fleet.submit(shared + [2, 3, 4], 4, session_id="warmup")
        list(warm_conv.stream)
        time.sleep(0.05)   # the holder's digest publishes
        convs, outs, wall = burst(fleet)
        launches["warm"] = _counts()[0]
        shipped = [c for c in convs if c.shipped]
        warm = dict(tokens_per_s=sum(map(len, outs)) / wall,
                    ttft_p50_ms=p50_ms(convs),
                    shipped_ttft_p50_ms=p50_ms(shipped),
                    ships=fleet.prefix_ships,
                    ship_tokens=fleet.prefix_ship_tokens,
                    lost=fleet.lost_conversations)
        block_bytes = (engine_config.block_size * 4
                       * int(np.prod(fleet.replica("replica-0").engine
                                     .model.kv_token_shape)))
        print(f"fleet warm: {len(convs)} conversations, "
              f"{sum(map(len, outs))} tokens in {wall:.3f} s, tokens_per_s "
              f"{warm['tokens_per_s']:.2f}, ttft_p50_ms "
              f"{warm['ttft_p50_ms']}, shipped ttft_p50_ms "
              f"{warm['shipped_ttft_p50_ms']} ({len(shipped)} shipped), "
              f"ships {warm['ships']}, shipped tokens {warm['ship_tokens']} "
              f"({warm['ship_tokens'] // engine_config.block_size * block_bytes}"
              f" bytes), K1 launches {launches['warm']} (cold "
              f"{launches['cold']}), lost {warm['lost']}, "
              f"tokens_per_s warm/cold "
              f"{warm['tokens_per_s'] / cold['tokens_per_s']:.3f}, "
              f"{engine_split(fleet)} [{card}]",
              flush=True)
        check(warm["ships"] >= 1 and shipped, "the warm burst shipped no "
              "prefix")
        check(cold["lost"] == 0 and warm["lost"] == 0, "a conversation was "
              "lost")
        check(launches["warm"] < launches["cold"],
              f"the warm burst launched K1 {launches['warm']} times, not "
              f"fewer than the cold burst's {launches['cold']}")
        hold(fleet, convs, outs, "warm")
        # A shipped conversation's prefill against the same request on the
        # holder: both read the same blocks, copied bitwise.
        holder = fleet.replica(warm_conv.owner)
        worst = 0.0
        for conv in shipped:
            list(holder.engine.submit(conv.prompt, 1))
            got = fleet.replica(conv.owner).engine.model.first_logits[
                tuple(conv.prompt)]
            want = holder.engine.model.first_logits[tuple(conv.prompt)]
            worst = max(worst, float(np.abs(got - want).max()))
        print(f"fleet shipped vs holder: prefill logits max_abs_err "
              f"{worst:.3e} over {len(shipped)} conversations (tol "
              f"{ENGINE_LOGIT_ATOL:g}) [{card}]", flush=True)
        check(worst <= ENGINE_LOGIT_ATOL, f"a shipped conversation's "
              f"prefill differs from the holder's by {worst:.3e}")

        # One ship timed by its parts: the holder's card pool to host
        # frames and into another replica's card pool (the chain is held
        # there already, so the installed copies free at once).
        dst = next(fleet.replica(r) for r in fleet.live_replicas()
                   if r != holder.rid)
        on_card = params["embed"].device.type == "cuda"
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        parts = []
        for _ in range(FLEET_SHIP_REPEATS):
            sync()
            t0 = time.perf_counter()
            chunks, kvs = holder.engine.export_prefix(shared)
            t1 = time.perf_counter()
            frames = encode_prefix_frames(chunks, kvs)
            chunks2, kvs2 = decode_prefix_frames(frames)
            t2 = time.perf_counter()
            covered = dst.engine.import_prefix(chunks2, kvs2)
            sync()
            t3 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                          (t3 - t2) * 1e3))
            check(covered == FLEET_SHARED, f"a ship covered {covered} "
                  f"tokens, not {FLEET_SHARED}")
            for a, b in zip(kvs, kvs2):
                check(np.array_equal(a, b), "a block changed through the "
                      "frames")
        export_ms, codec_ms, install_ms = (
            float(np.median([p[i] for p in parts])) for i in range(3))
        nbytes = sum(k.nbytes for k in kvs)
        print(f"fleet ship of {len(chunks)} blocks ({nbytes} bytes), median "
              f"of {FLEET_SHIP_REPEATS}: export {export_ms:.3f} ms (card to "
              f"host), encode+decode {codec_ms:.3f} ms, install "
              f"{install_ms:.3f} ms (host to card), total "
              f"{export_ms + codec_ms + install_ms:.3f} ms [{card}]",
              flush=True)
    finally:
        fleet.stop()

    # -- recovery: a seeded kill mid-decode, finished on a survivor --------
    plan = FaultPlan(seed=19)
    fleet = make_fleet(kv_routing=True, shipping=True, plan=plan)
    t_kill = []

    def kill(dst):
        t_kill.append(time.perf_counter())
        fleet.kill_replica(dst)

    plan.crash_after("replica-0", FLEET_KILL_AT, method="token",
                     on_crash=kill)
    fleet.start()
    try:
        warm_up(fleet)
        _zero_counts()
        prompt = prompts[0]
        conv = fleet.submit(prompt, FLEET_RECOVER_NEW, session_id="r0")
        got = list(conv.stream)
        for t in list(fleet._migrators):
            t.join(timeout=30.0)
        launches["recovery"] = _counts()[0]
        check(bool(t_kill) and conv.recovered_token_at is not None,
              "the seeded kill did not fire or nothing recovered")
        recovery_ms = (conv.recovered_token_at - t_kill[0]) * 1e3
        survivor = fleet.replica(conv.owner)
        # The no-fault stream, from the live replica that never served the
        # conversation: its cache holds none of the blocks the survivor
        # re-prefilled, so it prefills the prompt cold, as replica-0 did.
        fresh = next(fleet.replica(r) for r in fleet.live_replicas()
                     if r != conv.owner)
        check(not any(k[:len(prompt)] == tuple(prompt)
                      for k in fresh.engine.model.first_logits),
              f"{fresh.rid} served the recovered conversation")
        want = list(fresh.engine.submit(prompt, FLEET_RECOVER_NEW))
        first, first_ok, agree, total = hold_to_forward(params, cfg, prompt,
                                                        got)
        diverge = next((i for i, (a, b) in enumerate(zip(got, want))
                        if a != b), None)
        tie_ok = True
        if diverge is not None:
            ref, _, _, _ = hold_to_forward(params, cfg,
                                           prompt + want[:diverge],
                                           [want[diverge]])
            tie_ok = ref.max() - ref[got[diverge]] <= ENGINE_LOGIT_ATOL
        print(f"fleet recovery: replica-0 killed on its {FLEET_KILL_AT}th "
              f"token, recovery_ms {recovery_ms:.3f} (kill to first survivor "
              f"token), recoveries {fleet.recoveries}, lost "
              f"{fleet.lost_conversations}, K1 launches "
              f"{launches['recovery']}, stream vs no-fault stream: "
              f"{'equal' if diverge is None else f'first differs at {diverge}'}"
              f", vs forward: first token {'ok' if first_ok else 'differs'}, "
              f"agreement {agree}/{total} [{card}]", flush=True)
        eos = survivor.engine.model.eos_token
        check((len(got) == FLEET_RECOVER_NEW or got[-1] == eos)
              and fleet.recoveries == 1 and fleet.lost_conversations == 0,
              f"the recovered stream has {len(got)} tokens, "
              f"{fleet.recoveries} recoveries, "
              f"{fleet.lost_conversations} lost")
        check(tie_ok, f"the recovered stream differs from the no-fault "
              f"stream at {diverge} where the forward has no tie")
        check(first_ok and agree / total >= MIN_TOKEN_AGREEMENT,
              f"the recovered stream against forward: first token "
              f"{first_ok}, agreement {agree}/{total}")
    finally:
        fleet.stop()
    return launches


# Serve: the engine phase's engine as one `LLM` replica behind `serve.run`
# (the in-process runtime hosts replicas as threads, and engine threads of
# one process slow each other some 8x on one card: PERF.md, PR 8). The
# replica's constructor builds its engine in the controller's loop, so
# serve.run waits up to SERVE_READY_S. The rolling update runs under
# SERVE_ROLL_STREAMS HTTP streams; shutdown must end within SERVE_DOWN_S.
SERVE_READY_S = 300.0
SERVE_ROLL_STREAMS = 4
SERVE_DOWN_S = 10.0
SERVE_TIMEOUT_S = 300.0
_SERVE_MODEL = {}      # the factory's parameters and config
_SERVE_ENGINES = []    # every engine a replica started (their threads
                       # outlive a killed replica: the in-process gap)


def serve_model():
    """The `LLM` deployment's model factory: the flagship engine model on
    chip_smoke's one float32 parameter set, on its card, counting the
    prefills that start from no cached prefix."""
    from ray_tpu_torch.serve.engine import TransformerEngineModel

    class Counting(TransformerEngineModel):
        full_prefills = 0

        def prefill(self, tokens, prefix_kv=None):
            out = super().prefill(tokens, prefix_kv)
            self.full_prefills += prefix_kv is None
            return out

    params = _SERVE_MODEL["params"]
    return Counting(params, _SERVE_MODEL["cfg"], params["embed"].device)


class LLM:
    """The deployment of the engine's documentation: a sync generator
    that streams (handle and HTTP) and an async `__call__`."""

    def __init__(self, model_factory):
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        self.model = model_factory()
        self.engine = InferenceEngine(self.model,
                                      EngineConfig(**ENGINE_CONFIG))
        self.engine.start()
        _SERVE_ENGINES.append(self.engine)
        self.first_token_s = {}

    def generate(self, req):
        """Streams the tokens; keeps, by the request's tag, the seconds
        from submit to the first token here in the replica (engine time
        and queueing, no Serve)."""
        t0 = time.perf_counter()
        stream = self.engine.submit(req["prompt"], req["max_new_tokens"])
        for i, tok in enumerate(stream):
            if i == 0 and "tag" in req:
                self.first_token_s[req["tag"]] = time.perf_counter() - t0
            yield tok

    async def __call__(self, req):
        stream = self.engine.submit(req["prompt"], req["max_new_tokens"])
        return [tok async for tok in stream]

    def reset_counts(self):
        self.model.full_prefills = 0
        self.engine._ttfts.clear()
        self.first_token_s.clear()
        return True

    def counts(self):
        st = self.engine.stats()
        return dict(full_prefills=self.model.full_prefills,
                    first_token_s=dict(self.first_token_s),
                    **{k: st[k] for k in ("ttft_p50_ms", "prefills",
                                          "prefix_hit_tokens", "steps",
                                          "prefill_s", "decode_s")})


def sse_request(port: int, payload: dict,
                path: str = "/llm?method=generate"):
    """POST `path` with `Accept: text/event-stream`:
    (tokens, seconds to the first event, seconds to the end, whether the
    first event came in a read before the stream's last chunk)."""
    import socket

    body = json.dumps(payload).encode()
    t0 = time.perf_counter()
    first = None
    early = False
    buf = b""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=SERVE_TIMEOUT_S) as sock:
        sock.sendall(b"POST " + path.encode() + b" HTTP/1.1\r\n"
                     b"Host: localhost\r\nAccept: text/event-stream\r\n"
                     b"Content-Type: application/json\r\nContent-Length: "
                     + str(len(body)).encode() + b"\r\n\r\n" + body)
        while b"\r\n0\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise PhaseError(f"an SSE stream closed early: {buf[-300:]!r}")
            buf += chunk
            if first is None and b"data: " in buf:
                first = time.perf_counter() - t0
                early = b"\r\n0\r\n\r\n" not in buf
    end = time.perf_counter() - t0
    head = buf.partition(b"\r\n\r\n")[0]
    check(head.startswith(b"HTTP/1.1 200") and b"event: error" not in buf,
          f"an SSE stream failed: {buf[:300]!r}")
    tokens = [int(line[6:]) for line in buf.split(b"\n")
              if line.startswith(b"data: ")]
    return tokens, first, end, early


def stream_handle(handle, req, out):
    """One request over the handle's stream into `out`: its tokens, the
    client's seconds to the first and to the last, and whether the first
    came before the stream was complete."""
    t0 = time.perf_counter()
    gen = handle.options(stream=True, method_name="generate").remote(req)
    toks, first, early = [], None, False
    for tok in gen:
        if first is None:
            first = time.perf_counter() - t0
            early = not gen.completed()
        toks.append(tok)
    out.update(path="handle", tokens=toks, ttft=first,
               end=time.perf_counter() - t0, early=early)


def stream_http(port, req, out):
    """The same over HTTP SSE."""
    toks, first, end, early = sse_request(port, req)
    out.update(path="http", tokens=toks, ttft=first, end=end, early=early)


def run_threads(jobs):
    """Run (fn, args) jobs at once; each fills a dict of its own or
    records its exception."""
    import threading

    outs = [{} for _ in jobs]

    def guard(fn, args, out):
        try:
            fn(*args, out)
        except BaseException as e:  # noqa: BLE001
            out["error"] = f"{type(e).__name__}: {e}"

    threads = [threading.Thread(target=guard, args=(fn, args, out))
               for (fn, args), out in zip(jobs, outs)]
    for t in threads:
        t.start()
    return threads, outs


def join_all(threads, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))


def ttft_p50_ms(outs, first_token_s, path: str, serve_share: int) -> float:
    """Client TTFT p50 of a path; with serve_share, the p50 of each
    request's client TTFT less its first token's time in the replica:
    what routing and the way back add."""
    import numpy as np

    return round(float(np.median([
        o["ttft"] - serve_share * first_token_s[o["tag"]]
        for o in outs if o["path"] == path])) * 1e3, 3)


def stream_vs_forward(params, cfg, prompt, gen):
    """Teacher-forced, each token of a stream against a no-cache float32
    forward over prompt + gen[:-1]: (tokens that are the forward's argmax,
    tokens that are not but tie it within ENGINE_LOGIT_ATOL)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import forward

    seq = prompt + gen[:-1]
    ref, _ = forward(params, [seq], cfg, positions=torch.arange(len(seq)),
                     device=params["embed"].device)
    n = len(prompt)
    ref = ref[0, n - 1:n - 1 + len(gen)].float().cpu().numpy()
    picked = ref[np.arange(len(gen)), gen]
    best = ref.max(-1)
    is_max = ref.argmax(-1) == np.asarray(gen)
    ties = ~is_max & (best - picked <= ENGINE_LOGIT_ATOL)
    return int(is_max.sum()), int(ties.sum())


def phase_serve(params, cfg, card: str, engine_tps: float):
    """The engine behind `serve.run` on the port's in-process runtime: the
    engine phase's 8 prompts at once (4 over the handle's stream, 4 over
    HTTP SSE), one plain HTTP POST and one handle call, then a rolling
    update from v1 to v2 under 4 HTTP streams, and shutdown. Returns the
    K1 launches of the 8-request traffic and its tokens/s."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve

    _SERVE_MODEL.update(params=params, cfg=cfg)
    prompts = engine_prompts(cfg)
    new = ENGINE_NEW
    mem = {"before deploy": torch.cuda.memory_allocated()}
    before = set(threading.enumerate())
    app = serve.deployment(LLM, num_replicas=1, version="v1")

    def complete(toks):
        eos = _SERVE_ENGINES[0].model.eos_token
        return len(toks) == new or (toks and toks[-1] == eos)

    ray_tpu_torch.init(local_mode=True)
    try:
        port = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
        t0 = time.perf_counter()
        handle = serve.run(app.bind(serve_model), route_prefix="/llm",
                           _blocking_timeout_s=SERVE_READY_S)
        deploy_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        mem["after v1"] = torch.cuda.memory_allocated()
        # One request of a prompt of its own first: the replica's first
        # prefill and decode steps leave the timed traffic.
        warm = np.random.default_rng(9).integers(2, cfg.vocab_size,
                                                 128).tolist()
        list(handle.options(stream=True, method_name="generate").remote(
            {"prompt": warm, "max_new_tokens": 4}))
        handle.options(method_name="reset_counts").remote().result(
            timeout_s=SERVE_TIMEOUT_S)

        _zero_counts()
        reqs = [{"prompt": p, "max_new_tokens": new, "tag": i}
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        threads, outs = run_threads(
            [(stream_handle, (handle, r)) if i % 2 == 0
             else (stream_http, (port, r)) for i, r in enumerate(reqs)])
        for t in threads:
            t.join(SERVE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        launches = _counts()[0]
        errors = [o["error"] for o in outs if "error" in o]
        check(not errors and all("tokens" in o for o in outs),
              f"a request through Serve failed: {errors[:2]}")
        counts = handle.options(method_name="counts").remote().result(
            timeout_s=SERVE_TIMEOUT_S)
        n_tokens = sum(len(o["tokens"]) for o in outs)
        check(all(complete(o["tokens"]) for o in outs),
              "a stream through Serve ended short")
        check(launches > 0
              and launches == cfg.n_layers * counts["full_prefills"],
              f"the serve traffic launched K1 {launches} times for "
              f"{counts['full_prefills']} no-prefix prefills of "
              f"{cfg.n_layers} layers")
        check(all(o["early"] for o in outs), "a first token reached its "
              "client only when its stream was complete")
        for i, o in enumerate(outs):
            o["tag"] = i
        ttft = {path: ttft_p50_ms(outs, counts["first_token_s"], path, 0)
                for path in ("handle", "http")}
        share = {path: ttft_p50_ms(outs, counts["first_token_s"], path, 1)
                 for path in ("handle", "http")}

        # One plain HTTP POST and one handle call (`__call__`).
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/llm", data=json.dumps(reqs[1]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as resp:
            posted = json.loads(resp.read())
        called = handle.remote(reqs[0]).result(timeout_s=SERVE_TIMEOUT_S)
        check(type(called) is list and all(type(t) is int for t in called),
              f"a handle call returned {type(called).__name__}, not ints")

        # The rolling update, under SERVE_ROLL_STREAMS HTTP streams.
        v1 = [r["id"] for r in serve.status()["LLM"]["replicas"]]
        roll_threads, roll_outs = run_threads(
            [(stream_http, (port, reqs[4 + i]))
             for i in range(SERVE_ROLL_STREAMS)])
        v1_engine = _SERVE_ENGINES[0]
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while (time.monotonic() < deadline
               and v1_engine.stats()["running"] < SERVE_ROLL_STREAMS):
            time.sleep(0.001)
        in_flight = v1_engine.stats()["running"]
        check(in_flight == SERVE_ROLL_STREAMS, f"{in_flight} streams in "
              f"flight when the update began")
        def v1_alive():
            alive = False
            for rid in v1:
                try:
                    ray_tpu_torch.get_actor(f"SERVE_REPLICA::{rid}")
                    alive = True
                except ValueError:
                    pass
            return alive

        t0 = time.perf_counter()
        serve.run(app.options(version="v2").bind(serve_model),
                  route_prefix="/llm", _blocking_timeout_s=SERVE_READY_S)
        # The update ends when one v2 replica runs alone and the v1
        # replica, drained of its streams, is killed.
        final = None
        while time.monotonic() < deadline:
            reps = serve.status()["LLM"]["replicas"]
            if (len(reps) == 1 and reps[0]["state"] == "RUNNING"
                    and reps[0]["version"] == "v2" and not v1_alive()):
                final = reps
                break
            time.sleep(0.01)
        roll_s = time.perf_counter() - t0
        for t in roll_threads:
            t.join(SERVE_TIMEOUT_S)
        torch.cuda.synchronize()
        mem["after v2"] = torch.cuda.memory_allocated()
        errors = [o["error"] for o in roll_outs if "error" in o]
        check(not errors and all(complete(o.get("tokens", []))
                                 for o in roll_outs),
              f"a stream failed during the rolling update: {errors[:2]}")
        check(final is not None, f"the rolling update did not end at one "
              f"RUNNING v2 replica: {serve.status()}")
        check(final[0]["id"] not in v1, "no new replica took v1's place")
        post_roll = handle.remote(reqs[2]).result(timeout_s=SERVE_TIMEOUT_S)
    finally:
        t0 = time.perf_counter()
        serve.shutdown()
        ray_tpu_torch.shutdown()
        down_s = time.perf_counter() - t0
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name != "inference-engine"]
    engines_alive = sum(t.name == "inference-engine"
                        for t in set(threading.enumerate()) - before)
    torch.cuda.synchronize()
    mem["after shutdown"] = torch.cuda.memory_allocated()
    check(down_s <= SERVE_DOWN_S, f"serve and runtime shutdown took "
          f"{down_s:.3f} s")
    check(not left, f"threads of the runtime or Serve outlived shutdown: "
          f"{left}")
    # The killed v1 replica's engine thread still holds its model and pool
    # (a thread of the user's object; a process runtime would end it).
    check(len(_SERVE_ENGINES) == 2, f"{len(_SERVE_ENGINES)} replicas were "
          f"built for v1 and v2")
    for engine in _SERVE_ENGINES:
        engine.stop()
    _SERVE_ENGINES.clear()
    del engine, v1_engine
    gc.collect()
    torch.cuda.empty_cache()
    mem["after the engines stop"] = torch.cuda.memory_allocated()

    held = [(o["path"], reqs[i]["prompt"], o["tokens"])
            for i, o in enumerate(outs)]
    held += [("http", reqs[4 + i]["prompt"], o["tokens"])
             for i, o in enumerate(roll_outs)]
    held += [("post", reqs[1]["prompt"], posted),
             ("call", reqs[0]["prompt"], called),
             ("after roll", reqs[2]["prompt"], post_roll)]
    is_max = ties = total = 0
    for _, prompt, toks in held:
        a, t = stream_vs_forward(params, cfg, prompt, toks)
        is_max += a
        ties += t
        total += len(toks)
    tps = n_tokens / wall
    print(f"serve flagship f32 paged, 1 replica: {len(outs)} requests at "
          f"once (4 handle streams, 4 HTTP SSE), {n_tokens} tokens in "
          f"{wall:.3f} s, tokens_per_s {tps:.2f} (engine phase "
          f"{engine_tps:.2f}, serve/engine {tps / engine_tps:.3f}), client "
          f"ttft_p50_ms handle {ttft['handle']} http {ttft['http']}, engine "
          f"stats ttft_p50_ms {counts['ttft_p50_ms']}, Serve's share of a "
          f"request's TTFT (client less first token in the replica) p50_ms "
          f"handle {share['handle']} http {share['http']}, K1 launches "
          f"{launches} ({counts['full_prefills']} no-prefix prefills x "
          f"{cfg.n_layers} layers), prefix_hit_tokens "
          f"{counts['prefix_hit_tokens']}, prefill_s {counts['prefill_s']} "
          f"decode_s {counts['decode_s']} ({counts['steps']} steps), "
          f"serve.run to ready {deploy_s:.3f} s [{card}]", flush=True)
    print(f"serve vs no-cache forward: {len(held)} streams (8 at once, "
          f"{SERVE_ROLL_STREAMS} under the update, a plain POST, a handle "
          f"call, one after the update), {is_max}/{total} tokens the "
          f"forward's argmax, {ties} more tie it within "
          f"{ENGINE_LOGIT_ATOL:g}; first token before the stream's end "
          f"{sum(o['early'] for o in outs)}/{len(outs)} [{card}]",
          flush=True)
    print(f"serve rolling update v1 -> v2: {SERVE_ROLL_STREAMS} HTTP streams "
          f"in flight, 0 failed, {roll_s:.3f} s from serve.run(v2) to one "
          f"RUNNING v2 replica with v1 drained and killed; shutdown "
          f"(serve + runtime) {down_s:.3f} s, runtime/Serve threads left "
          f"{len(left)}, engine threads left {engines_alive} [{card}]",
          flush=True)
    print("serve memory_allocated bytes: " + ", ".join(
        f"{k} {v}" for k, v in mem.items()) + f" [{card}]", flush=True)
    check(is_max + ties == total, f"{total - is_max - ties} streamed tokens "
          f"through Serve differ from the forward's argmax beyond a tie")
    return launches, tps


# Serve on the cluster runtime: the `LLM` deployment as replica processes,
# each leasing a quarter of the card (fractional GPU leases share a card).
# v1's exit must free at least its float32 weights (503,354,880 x 4 B) and
# its KV pool (604,504,064 B): what PR 9's in-process replicas kept held.
CLUSTER_GPU_SHARE = 0.25
CLUSTER_FREED_MIN_B = 503_354_880 * 4 + 604_504_064
CLUSTER_REPLICAS = 3
CLUSTER_REQUESTS = 24
CLUSTER_DOWN_S = 10.0
CLUSTER_CPUS = 8


def flagship_params():
    """chip_smoke's flagship parameters (float32, from its seed) on this
    process's card: the driver's, and a replica process's own."""
    import torch

    from ray_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(dtype=torch.bfloat16, **FLAGSHIP)
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg


def param_checksum(params) -> list:
    """[name, sum of the 32-bit words, sum of each word times its index mod
    65521 plus 1] per leaf, in int64 on the card: equal only where the
    bytes are (but for a vanishing chance)."""
    import torch

    out = []
    for name, t in _flat(params):
        w = t.detach().contiguous().view(torch.int32).reshape(-1).to(
            torch.int64)
        idx = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append([name, int(w.sum()), int((w * idx).sum())])
        del w, idx
    return out


def counting_model(params, cfg):
    """The flagship engine model, counting the prefills that start from no
    cached prefix."""
    from ray_tpu_torch.serve.engine import TransformerEngineModel

    class Counting(TransformerEngineModel):
        full_prefills = 0

        def prefill(self, tokens, prefix_kv=None):
            out = super().prefill(tokens, prefix_kv)
            self.full_prefills += prefix_kv is None
            return out

    return Counting(params, cfg, params["embed"].device)


def actor_pid(instance):
    """`__ray_call__` body: the actor's process id."""
    return os.getpid()


class ClusterLLM(LLM):
    """The `LLM` deployment in a replica process of the cluster runtime. It
    makes the flagship parameters itself, from chip_smoke's seed, on the
    card its GPU lease shows it (`device=None`: cuda:0 of its own
    CUDA_VISIBLE_DEVICES), and counts K1's launches in its process."""

    def __init__(self):
        # Each step of the build, in seconds.
        t = time.perf_counter()
        import dataclasses

        import torch

        self.build_s = {"import_torch": round(time.perf_counter() - t, 3)}
        t = time.perf_counter()
        from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

        self.build_s["import_port"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        torch.cuda.init()
        self.build_s["cuda_init"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        params, cfg = flagship_params()
        torch.cuda.synchronize()
        self.build_s["params"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        self.sum = param_checksum(params)
        self.build_s["checksum"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        self.model = counting_model(
            params, dataclasses.replace(cfg, dtype=torch.float32))
        # A warm-up pass of the engine phase's prompts on an engine of
        # its own, as the engine phase runs one: cuBLAS picks its GEMMs
        # and the allocator grows on first use, which the timed traffic
        # would otherwise pay in this fresh process.
        warm = InferenceEngine(self.model, EngineConfig(**ENGINE_CONFIG))
        warm.start()
        try:
            for stream in [warm.submit(p, ENGINE_NEW)
                           for p in engine_prompts(cfg)]:
                list(stream)
        finally:
            warm.stop()
        del warm
        self.model.full_prefills = 0
        torch.cuda.synchronize()
        self.build_s["warm_up"] = round(time.perf_counter() - t, 3)
        t = time.perf_counter()
        self.engine = InferenceEngine(self.model,
                                      EngineConfig(**ENGINE_CONFIG))
        self.engine.start()
        torch.cuda.synchronize()
        self.build_s["engine"] = round(time.perf_counter() - t, 3)
        self.first_token_s = {}

    def checksum(self):
        return self.sum

    def card(self):
        import torch

        return dict(pid=os.getpid(), build_s=self.build_s,
                    visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                    count=torch.cuda.device_count(),
                    name=torch.cuda.get_device_name(0),
                    device=str(self.model.device))

    def running(self):
        return self.engine.stats()["running"]

    def eos(self):
        return self.model.eos_token

    def reset_counts(self):
        _zero_counts()
        return super().reset_counts()

    def counts(self):
        return dict(super().counts(), k1=_counts()[0])


def proc_alive(pid: int) -> bool:
    """The process runs (not gone, not a zombie awaiting its reaper)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


# Set in the environment before this run's cluster starts, so that its
# GCS, raylet and workers inherit it: the shutdown gate counts only this
# run's processes, not those of another cluster on the same host.
RUN_MARKER = "RAY_TPU_SMOKE_RUN"


def port_processes() -> list:
    """(pid, module) of this run's `python -m ray_tpu_torch.core.*`
    processes: those whose environment carries this run's RUN_MARKER."""
    marker = f"{RUN_MARKER}={os.environ.get(RUN_MARKER, '')}"
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = [a.decode("utf-8", "replace")
                        for a in f.read().split(b"\0") if a]
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read().decode("utf-8", "replace").split("\0")
        except OSError:
            continue
        if marker not in env:
            continue
        for a, b in zip(argv, argv[1:]):
            if a == "-m" and b.startswith("ray_tpu_torch.core.") and \
                    proc_alive(int(entry)):
                found.append((int(entry), b))
    return found


def phase_cluster_serve(params, cfg, card: str, engine_tps: float,
                        inproc_tps: float):
    """Serve on the cluster runtime: GCS, raylet and workers as processes,
    each replica a worker process with a quarter-card GPU lease. The
    engine phase's 8 prompts at once (4 handle streams, 4 HTTP SSE), a
    rolling update under 4 HTTP streams with v1's card memory freed at its
    exit, a replica's SIGKILL, the controller's SIGKILL under HTTP
    traffic, the same 24 handle requests through 1 and 3 replicas, and
    shutdown. Returns the K1 launches of the 8-request traffic, counted
    in the replica."""
    import signal
    import threading
    import urllib.request

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    prompts = engine_prompts(cfg)
    new = ENGINE_NEW
    rng = np.random.default_rng(11)
    many = [rng.integers(2, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(128, 513, CLUSTER_REQUESTS)]
    reqs = [{"prompt": p, "max_new_tokens": new, "tag": i}
            for i, p in enumerate(prompts)]
    want_sum = param_checksum(params)
    eos = None
    held = []   # (what, prompt, tokens) for the forward

    def complete(toks):
        return len(toks) == new or (toks and toks[-1] == eos)

    def replica_ids():
        return [r["id"] for r in serve.status()["LLM"]["replicas"]]

    def wait(cond, what):
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while time.monotonic() < deadline:
            value = cond()
            if value:
                return value
            time.sleep(0.01)
        raise PhaseError(f"timed out waiting for {what}: {serve.status()}")

    def only_running(version, n=1, besides=()):
        reps = serve.status()["LLM"]["replicas"]
        return (len(reps) == n
                and all(r["state"] == "RUNNING" and r["version"] == version
                        and r["id"] not in besides for r in reps))

    def streams(handle, port, rs, what):
        threads, outs = run_threads(
            [(stream_handle, (handle, r)) if i % 2 == 0
             else (stream_http, (port, r)) for i, r in enumerate(rs)])
        join_all(threads, SERVE_TIMEOUT_S)
        errors = [o.get("error", "no answer") for o in outs
                  if "tokens" not in o]
        check(not errors, f"a request through Serve failed ({what}): "
              f"{errors[:2]}")
        check(all(complete(o["tokens"]) for o in outs),
              f"a stream through Serve ended short ({what})")
        for r, o in zip(rs, outs):
            o["tag"] = r["tag"]
            held.append((what, r["prompt"], o["tokens"]))
        return outs

    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    ray_tpu_torch.init(num_cpus=CLUSTER_CPUS)
    res = ray_tpu_torch.cluster_resources()
    print(f"cluster node resources {json.dumps(res, sort_keys=True)} "
          f"(GPU detected, not passed) [{card}]", flush=True)
    check(res.get("GPU") == 1.0, f"the node did not detect one GPU: {res}")
    driver_pid = os.getpid()
    try:
        port = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
        app = serve.deployment(
            ClusterLLM, name="LLM", num_replicas=1, version="v1",
            ray_actor_options={"num_gpus": CLUSTER_GPU_SHARE})
        t0 = time.perf_counter()
        handle = serve.run(app.bind(), route_prefix="/llm",
                           _blocking_timeout_s=SERVE_READY_S)
        deploy_s = time.perf_counter() - t0

        def call(method, timeout=SERVE_TIMEOUT_S):
            return handle.options(method_name=method).remote().result(
                timeout_s=timeout)

        info = call("card")
        eos = call("eos")
        check(info["pid"] != driver_pid and proc_alive(info["pid"]),
              f"the replica is not a process of its own: {info}")
        check(info["visible"] == "0" and info["count"] == 1
              and info["device"] == "cuda:0",
              f"the replica does not see its leased card: {info}")
        got_sum = call("checksum")
        check(got_sum == want_sum, "the replica's flagship parameters "
              "differ from the driver's")
        print(f"cluster replica v1: pid {info['pid']} (driver {driver_pid}), "
              f"CUDA_VISIBLE_DEVICES={info['visible']}, {info['count']} "
              f"card ({info['name']}), model on {info['device']}; "
              f"parameter checksum equal to the driver's on "
              f"{len(got_sum)} leaves; serve.run to ready {deploy_s:.3f} s, "
              f"the replica's build s {json.dumps(info['build_s'])} "
              f"[{card}]", flush=True)
        # One request first: the route and the connections the streams
        # take leave the timed traffic (the replica warmed its engine).
        warm = np.random.default_rng(9).integers(2, cfg.vocab_size,
                                                 128).tolist()
        list(handle.options(stream=True, method_name="generate").remote(
            {"prompt": warm, "max_new_tokens": 4}))
        sse_request(port, {"prompt": warm, "max_new_tokens": 4})
        call("reset_counts")

        _zero_counts()
        t0 = time.perf_counter()
        outs = streams(handle, port, reqs, "8 at once")
        wall = time.perf_counter() - t0
        check(_counts()[0] == 0, "the driver launched K1 in the cluster "
              "phase (the replica process holds the model)")
        counts = call("counts")
        launches = counts["k1"]
        n_tokens = sum(len(o["tokens"]) for o in outs)
        check(launches > 0
              and launches == cfg.n_layers * counts["full_prefills"],
              f"the replica launched K1 {launches} times for "
              f"{counts['full_prefills']} no-prefix prefills of "
              f"{cfg.n_layers} layers")
        check(all(o["early"] for o in outs), "a first token reached its "
              "client only when its stream was complete")
        ttft = {path: ttft_p50_ms(outs, counts["first_token_s"], path, 0)
                for path in ("handle", "http")}
        share = {path: ttft_p50_ms(outs, counts["first_token_s"], path, 1)
                 for path in ("handle", "http")}
        tps = n_tokens / wall

        # The rolling update v1 -> v2 under 4 HTTP streams; v1's exit
        # must give its card memory back.
        v1 = replica_ids()
        v1_pid = info["pid"]
        roll_threads, roll_outs = run_threads(
            [(stream_http, (port, reqs[4 + i]))
             for i in range(SERVE_ROLL_STREAMS)])
        wait(lambda: call("running") >= SERVE_ROLL_STREAMS,
             "the update's streams to start")
        samples = []   # (free bytes, v1 alive)
        sampling = threading.Event()

        def sample():
            while not sampling.is_set():
                alive = proc_alive(v1_pid)
                samples.append((torch.cuda.mem_get_info()[0], alive))
                time.sleep(0.002)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        serve.run(app.options(version="v2").bind(), route_prefix="/llm",
                  _blocking_timeout_s=SERVE_READY_S)
        wait(lambda: only_running("v2", besides=v1)
             and not proc_alive(v1_pid), "v2 alone with v1's process gone")
        roll_s = time.perf_counter() - t0
        time.sleep(1.0)
        sampling.set()
        sampler.join()
        join_all(roll_threads, SERVE_TIMEOUT_S)
        errors = [o.get("error", "no answer") for o in roll_outs
                  if "tokens" not in o]
        check(not errors and all(complete(o["tokens"]) for o in roll_outs),
              f"a stream failed during the rolling update: {errors[:2]}")
        for i, o in enumerate(roll_outs):
            held.append(("update", reqs[4 + i]["prompt"], o["tokens"]))
        # Free card memory at its lowest while v1's process lived (v2
        # built beside it) against its highest in the second after v1's
        # exit.
        alive = [free for free, up in samples if up]
        after = [free for free, up in samples if not up]
        check(alive and after, "no memory sample on both sides of v1's exit")
        freed = max(after) - min(alive)
        check(freed >= CLUSTER_FREED_MIN_B, f"v1's exit freed {freed} B of "
              f"the card, under {CLUSTER_FREED_MIN_B} B (its weights and "
              f"pool)")

        # A replica's SIGKILL: the controller replaces it.
        v2 = replica_ids()
        v2_pid = call("card")["pid"]
        os.kill(v2_pid, signal.SIGKILL)
        t0 = time.perf_counter()
        wait(lambda: only_running("v2", besides=v2), "the replacement")
        replace_s = time.perf_counter() - t0
        check(call("checksum") == want_sum, "the replacement's parameters "
              "differ from the driver's")
        streams(handle, port, [dict(r, tag=100 + r["tag"])
                               for r in reqs[:4]], "after the replica kill")

        # The controller's SIGKILL under HTTP traffic.
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        stop = threading.Event()
        tally = {"ok": 0, "failed": 0, "errors": []}

        def hammer():
            body = json.dumps({"prompt": reqs[0]["prompt"][:64],
                               "max_new_tokens": 4}).encode()
            while not stop.is_set():
                try:
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/llm", data=body,
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        toks = json.loads(resp.read())
                    assert len(toks) == 4, toks
                    tally["ok"] += 1
                except Exception as e:  # noqa: BLE001
                    tally["failed"] += 1
                    tally["errors"].append(repr(e)[:200])

        hammers = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(2)]
        for t in hammers:
            t.start()
        time.sleep(1.0)
        ctl_pid = ray_tpu_torch.get(
            controller.__ray_call__.remote(actor_pid), timeout=60)
        os.kill(ctl_pid, signal.SIGKILL)
        t0 = time.perf_counter()

        def recovered():
            try:
                st = ray_tpu_torch.get(controller.status.remote(), timeout=5)
            except Exception:  # noqa: BLE001
                return False
            return any(r["state"] == "RUNNING"
                       for r in st.get("LLM", {}).get("replicas", []))

        wait(recovered, "the controller's recovery")
        recover_s = time.perf_counter() - t0
        new_ctl = ray_tpu_torch.get(
            controller.__ray_call__.remote(actor_pid), timeout=60)
        time.sleep(1.0)
        stop.set()
        join_all(hammers, SERVE_TIMEOUT_S)
        check(tally["failed"] == 0 and tally["ok"] > 0,
              f"requests failed through the controller's SIGKILL: {tally}")
        check(new_ctl != ctl_pid, "the controller did not restart")

        # The same 24 handle requests through 1 replica, then 3.
        def through(n_replicas):
            rs = [{"prompt": p, "max_new_tokens": new, "tag": 200 + i}
                  for i, p in enumerate(many)]
            t0 = time.perf_counter()
            threads, outs = run_threads([(stream_handle, (handle, r))
                                         for r in rs])
            join_all(threads, SERVE_TIMEOUT_S)
            dt = time.perf_counter() - t0
            errors = [o.get("error", "no answer") for o in outs
                      if "tokens" not in o]
            check(not errors and all(complete(o["tokens"]) for o in outs),
                  f"a request failed through {n_replicas} replicas: "
                  f"{errors[:2]}")
            for r, o in zip(rs, outs):
                held.append((f"{n_replicas} replicas", r["prompt"],
                             o["tokens"]))
            return sum(len(o["tokens"]) for o in outs) / dt

        one_tps = through(1)
        before3 = replica_ids()
        t0 = time.perf_counter()
        serve.run(app.options(version="v3", num_replicas=CLUSTER_REPLICAS)
                  .bind(), route_prefix="/llm",
                  _blocking_timeout_s=SERVE_READY_S)
        wait(lambda: only_running("v3", CLUSTER_REPLICAS, before3),
             "three v3 replicas")
        scale_s = time.perf_counter() - t0
        pids = {call("card")["pid"] for _ in range(24)}
        check(len(pids) == CLUSTER_REPLICAS and driver_pid not in pids,
              f"{len(pids)} replica processes answered, not "
              f"{CLUSTER_REPLICAS}")
        three_tps = through(CLUSTER_REPLICAS)
    finally:
        t0 = time.perf_counter()
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
        deadline = time.monotonic() + CLUSTER_DOWN_S
        left = port_processes()
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = port_processes()
        down_s = time.perf_counter() - t0
    check(not left, f"port processes outlived shutdown by "
          f"{CLUSTER_DOWN_S} s: {left}")

    is_max = ties = total = 0
    for _, prompt, toks in held:
        a, t = stream_vs_forward(params, cfg, prompt, toks)
        is_max += a
        ties += t
        total += len(toks)
    print(f"cluster serve flagship f32 paged, 1 replica process "
          f"({CLUSTER_GPU_SHARE} GPU): 8 requests at once (4 handle streams, "
          f"4 HTTP SSE), {n_tokens} tokens in {wall:.3f} s, tokens_per_s "
          f"{tps:.2f} (engine phase {engine_tps:.2f}, cluster/engine "
          f"{tps / engine_tps:.3f}; in-process serve {inproc_tps:.2f}, "
          f"cluster/in-process {tps / inproc_tps:.3f}), client ttft_p50_ms "
          f"handle {ttft['handle']} http {ttft['http']}, engine stats "
          f"ttft_p50_ms {counts['ttft_p50_ms']}, Serve's share of a "
          f"request's TTFT (client less first token in the replica) p50_ms "
          f"handle {share['handle']} http {share['http']}, K1 launches "
          f"{launches} in the replica ({counts['full_prefills']} no-prefix "
          f"prefills x {cfg.n_layers} layers), prefill_s "
          f"{counts['prefill_s']} decode_s {counts['decode_s']} "
          f"({counts['steps']} steps) [{card}]", flush=True)
    print(f"cluster serve rolling update v1 -> v2: {SERVE_ROLL_STREAMS} HTTP "
          f"streams in flight, 0 failed, {roll_s:.3f} s from serve.run(v2) "
          f"to v2 alone with v1's process gone; card memory freed at v1's "
          f"exit {freed} B (gate {CLUSTER_FREED_MIN_B}) [{card}]",
          flush=True)
    print(f"cluster serve faults: replica SIGKILL -> replacement RUNNING in "
          f"{replace_s:.3f} s, its checksum equal, 4 streams after it "
          f"held; controller SIGKILL under HTTP traffic: {tally['ok']} "
          f"requests ok, {tally['failed']} failed, recovered in "
          f"{recover_s:.3f} s (pid {ctl_pid} -> {new_ctl}) [{card}]",
          flush=True)
    print(f"cluster serve replicas: the same {CLUSTER_REQUESTS} handle "
          f"requests through 1 replica {one_tps:.2f} tokens_per_s, through "
          f"{CLUSTER_REPLICAS} ({CLUSTER_GPU_SHARE} GPU each, one card) "
          f"{three_tps:.2f}, ratio {three_tps / one_tps:.3f}; scale-up to "
          f"{CLUSTER_REPLICAS} v3 replicas {scale_s:.3f} s; shutdown "
          f"{down_s:.3f} s, port processes left {len(left)} [{card}]",
          flush=True)
    print(f"cluster serve vs no-cache forward: {len(held)} streams, "
          f"{is_max}/{total} tokens the forward's argmax, {ties} more tie "
          f"it within {ENGINE_LOGIT_ATOL:g} [{card}]", flush=True)
    check(is_max + ties == total, f"{total - is_max - ties} streamed tokens "
          f"through the cluster's Serve differ from the forward's argmax "
          f"beyond a tie")
    return launches


# Model multiplexing on the cluster runtime: `MuxLLM` holds up to
# MUX_MAX_MODELS float32 flagship engines a replica behind
# `serve.multiplexed`'s LRU, each model id's weights made from a seed of its
# own (MUX_SEEDS); MUX_REPLICAS replica processes lease MUX_GPU_SHARE of the
# card each. An engine holds CLUSTER_FREED_MIN_B of the card (weights and
# KV pool), which its eviction must give back. A model id's wave is
# MUX_WAVE streams at once (the router keeps an id on its replica up to 4
# requests in flight there beyond the other's). MUX_ORDER is the fixed
# order of requests one replica is sent directly; MUX_HOLD_NEW the new
# tokens of the stream that its model's eviction must wait for.
MUX_IDS = ("tenant-a", "tenant-b", "tenant-c")
MUX_SEEDS = {"tenant-a": 101, "tenant-b": 202, "tenant-c": 303}
MUX_MAX_MODELS = 2
MUX_REPLICAS = 2
MUX_GPU_SHARE = 0.5
MUX_WAVE = 4
MUX_ORDER = ("tenant-a", "tenant-b", "tenant-a", "tenant-c", "tenant-b",
             "tenant-c", "tenant-a")
MUX_ORDER_NEW = 4
MUX_HOLD_NEW = 512
_MUX_PREFILLS = [0]     # a replica's no-prefix prefills, every engine's


def mux_params(model_id: str):
    """`model_id`'s float32 flagship parameters, from its own seed, on this
    process's card."""
    import torch

    from ray_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(dtype=torch.float32, **FLAGSHIP)
    gen = torch.Generator(device="cuda").manual_seed(MUX_SEEDS[model_id])
    return init_params(cfg, gen), cfg


def allocated() -> int:
    import torch

    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def lru(requests, cap: int, resident=()):
    """(the loads, what it holds after, least recent first) of an LRU of
    `cap` models holding `resident` for `requests` in this order (the
    rule of `ray_tpu/serve/multiplex.py`: a hit moves the id to the back,
    a miss loads it and evicts from the front)."""
    resident, loads = list(resident), []
    for mid in requests:
        if mid in resident:
            resident.remove(mid)
        else:
            loads.append(mid)
            if len(resident) >= cap:
                resident.pop(0)
        resident.append(mid)
    return loads, resident


class MuxEngine:
    """One model id's flagship engine in a replica process. Its scheduler
    thread holds the engine, so dropping this object (the multiplex LRU's
    eviction, or the release of its last loan) stops that thread: then
    nothing holds the weights and the KV pool. It counts its no-prefix
    prefills into the replica's `_MUX_PREFILLS` and keeps each prompt's
    first prefill logits in `first_logits` (the replica's dict)."""

    def __init__(self, model_id: str, first_logits: dict):
        import torch

        from ray_tpu_torch.serve.engine import (EngineConfig,
                                                InferenceEngine,
                                                TransformerEngineModel)

        class Recording(TransformerEngineModel):
            def prefill(self, tokens, prefix_kv=None):
                logits, kv = super().prefill(tokens, prefix_kv)
                _MUX_PREFILLS[0] += prefix_kv is None
                first_logits.setdefault((model_id, tuple(tokens)), logits)
                return logits, kv

            def prefill_paged(self, tokens, *a, **k):
                logits, kv = super().prefill_paged(tokens, *a, **k)
                first_logits.setdefault((model_id, tuple(tokens)), logits)
                return logits, kv

        t0 = time.perf_counter()
        params, cfg = mux_params(model_id)
        self.engine = InferenceEngine(
            Recording(params, cfg, params["embed"].device),
            EngineConfig(**ENGINE_CONFIG))
        self.engine.start()
        torch.cuda.synchronize()
        self.load_s = time.perf_counter() - t0

    def __del__(self):
        self.engine.stop()


class MuxLLM:
    """The multiplexed deployment: `generate` streams a request's tokens
    from the engine of its `multiplexed_model_id` (or, over HTTP, of the
    body's "model_id"), `__call__` returns them at once (the gRPC
    ingress's unary call). It logs, in this replica process, every
    request's model id, every load with its seconds, and for each load
    the card bytes allocated before and after its evictions."""

    def __init__(self):
        from ray_tpu_torch import serve

        self.pid = os.getpid()
        self.requests = []     # model id of each request, in order
        self.loads = []        # (model id, seconds)
        # Loads into a full LRU: (loaded id, bytes with it and the evicted
        # one, bytes after the eviction, ids parked by loans then).
        self.evictions = []
        self.first_logits = {}
        self._bytes_loaded = 0
        # serve.multiplexed, applied here so that this module imports
        # without the port (chip_smoke refuses to run away from it).
        loader = serve.multiplexed(
            max_num_models_per_replica=MUX_MAX_MODELS)(MuxLLM._load)
        self.get_model = loader.__get__(self)

    async def _load(self, model_id: str):
        eng = MuxEngine(model_id, self.first_logits)
        self.loads.append((model_id, round(eng.load_s, 3)))
        self._bytes_loaded = allocated()
        return eng

    async def _model(self, req):
        from ray_tpu_torch import serve

        mid = req.get("model_id") or serve.get_multiplexed_model_id()
        self.requests.append(mid)
        wrapper = getattr(self, "__serve_multiplex__load", None)
        full = (wrapper is not None and mid not in wrapper.model_ids
                and len(wrapper.model_ids) >= MUX_MAX_MODELS)
        n = len(self.loads)
        eng = await self.get_model(mid)
        if full and len(self.loads) > n:
            wrapper = getattr(self, "__serve_multiplex__load")
            self.evictions.append((mid, self._bytes_loaded, allocated(),
                                   sorted(wrapper._pending_evict)))
        return eng

    async def generate(self, req):
        eng = await self._model(req)
        async for tok in eng.engine.submit(req["prompt"],
                                           req["max_new_tokens"]):
            yield tok

    async def __call__(self, req):
        eng = await self._model(req)
        return [tok async for tok in eng.engine.submit(
            req["prompt"], req["max_new_tokens"])]

    def reset_counts(self):
        _zero_counts()
        _MUX_PREFILLS[0] = 0
        return True

    def stats(self):
        wrapper = getattr(self, "__serve_multiplex__load", None)
        return dict(pid=self.pid, requests=list(self.requests),
                    loads=list(self.loads), evictions=list(self.evictions),
                    resident=wrapper.model_ids if wrapper else [],
                    parked=sorted(wrapper._pending_evict) if wrapper else [],
                    allocated=allocated(), k1=_counts()[0],
                    full_prefills=_MUX_PREFILLS[0])

    def logits(self):
        return dict(self.first_logits)


def replica_actors(name: str):
    """[(replica id, actor handle)] of a deployment's running replicas, in
    the controller's order."""
    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import CONTROLLER_NAME

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.get_routing_table.remote(name),
                             timeout=60)["replicas"]


def replica_call(actor, method: str, *args):
    """A method of one replica through its data plane (the router's call,
    made to that replica)."""
    import ray_tpu_torch

    return ray_tpu_torch.get(actor.handle_request.remote(method, args, {}),
                             timeout=SERVE_TIMEOUT_S)


def replica_stream(actor, model_id: str, req, out: list) -> list:
    """`generate` of one replica, for `model_id`, its tokens appended to
    `out` as they come."""
    import ray_tpu_torch

    gen = actor.handle_request_streaming.options(
        num_returns="streaming").remote(
            "generate", (req,), {}, {"multiplexed_model_id": model_id})
    for ref in gen:
        out.append(ray_tpu_torch.get(ref, timeout=SERVE_TIMEOUT_S))
    return out


def phase_multiplex(cfg, card: str, engine_launches: int):
    """`@serve.multiplexed` flagship engines on the cluster runtime, then
    the gRPC ingress (`phase_grpc`) on the same deployment. Returns the K1
    launches of the handle traffic, counted in the replicas, and each
    model id's tokens/s."""
    import threading

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import serve

    prompts = engine_prompts(cfg)
    new = ENGINE_NEW
    held = []      # (model id, prompt, tokens)

    def complete(toks, n):
        return len(toks) == n or (toks and toks[-1] == 1)

    def handle_wave(handle, mid, rs):
        """Streams of `rs` for `mid` over the handle, assigned at once
        (here) and read on threads."""
        h = handle.options(multiplexed_model_id=mid, stream=True,
                           method_name="generate")
        gens = [h.remote(r) for r in rs]
        outs = [[] for _ in rs]

        def read(gen, out):
            for tok in gen:
                out.append(tok)

        threads = [threading.Thread(target=read, args=(g, o), daemon=True)
                   for g, o in zip(gens, outs)]
        return threads, outs

    def finish(waves):
        for threads, _, _, _ in waves:
            for t in threads:
                t.start()
        for threads, outs, mid, rs in waves:
            join_all(threads, SERVE_TIMEOUT_S)
            check(all(complete(o, r["max_new_tokens"])
                      for o, r in zip(outs, rs)),
                  f"a multiplexed stream of {mid} ended short")
            for o, r in zip(outs, rs):
                held.append((mid, r["prompt"], list(o)))

    def stats():
        return {rid: replica_call(actor, "stats") for rid, actor in actors}

    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    ray_tpu_torch.init(num_cpus=CLUSTER_CPUS)
    driver_pid = os.getpid()
    try:
        serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
        app = serve.deployment(
            MuxLLM, name="MuxLLM", num_replicas=MUX_REPLICAS,
            ray_actor_options={"num_gpus": MUX_GPU_SHARE})
        t0 = time.perf_counter()
        handle = serve.run(app.bind(), route_prefix="/mux",
                           _blocking_timeout_s=SERVE_READY_S)
        deadline = time.monotonic() + SERVE_READY_S
        while (len(replica_actors("MuxLLM")) < MUX_REPLICAS
               and time.monotonic() < deadline):
            time.sleep(0.1)
        actors = replica_actors("MuxLLM")
        deploy_s = time.perf_counter() - t0
        check(len(actors) == MUX_REPLICAS,
              f"{len(actors)} MuxLLM replicas running, not {MUX_REPLICAS}")
        for _, actor in actors:
            replica_call(actor, "reset_counts")

        # Cold: a wave of MUX_WAVE streams for each id, all assigned at
        # once (the second id goes to the idle replica), read together.
        cold = [dict(prompt=p, max_new_tokens=new) for p in prompts[:4]]
        t0 = time.perf_counter()
        waves = [handle_wave(handle, mid, cold) + (mid, cold)
                 for mid in MUX_IDS]
        finish(waves)
        cold_s = time.perf_counter() - t0
        after_cold = stats()

        # Warm: each id in turn, the engine phase's 8 prompts as two
        # waves, twice; the second pass is timed (the first runs the
        # longer prompts' shapes in the replica for the first time).
        def id_pass(mid):
            t0 = time.perf_counter()
            n_tok = 0
            for lo in (0, MUX_WAVE):
                rs = [dict(prompt=p, max_new_tokens=new)
                      for p in prompts[lo:lo + MUX_WAVE]]
                wave = handle_wave(handle, mid, rs) + (mid, rs)
                finish([wave])
                n_tok += sum(len(o) for o in wave[1])
            return n_tok / (time.perf_counter() - t0)

        first_tps, tps = {}, {}
        for mid in MUX_IDS:
            first_tps[mid] = id_pass(mid)
            tps[mid] = id_pass(mid)
        routed = stats()

        # One replica, sent MUX_ORDER directly: loads by the LRU's rule,
        # and each unloaned eviction frees an engine's bytes at once.
        rid, actor = actors[0]
        rng = np.random.default_rng(13)
        short = rng.integers(2, cfg.vocab_size, 64).tolist()
        for mid in MUX_ORDER:
            toks = replica_stream(actor, mid, dict(
                prompt=short, max_new_tokens=MUX_ORDER_NEW), [])
            check(complete(toks, MUX_ORDER_NEW), f"a direct stream of {mid} "
                  f"ended short")
            held.append((mid, short, toks))
        ordered = replica_call(actor, "stats")

        # Drain-deferred: X streams MUX_HOLD_NEW tokens; Y is touched and
        # Z loaded under it, which evicts X while its loan is out.
        x = ordered["resident"][-1]
        y = ordered["resident"][0]
        z = next(m for m in MUX_IDS if m not in ordered["resident"])
        long_prompt = prompts[0]
        x_out: list = []
        x_thread = threading.Thread(target=replica_stream, args=(
            actor, x, dict(prompt=long_prompt, max_new_tokens=MUX_HOLD_NEW),
            x_out), daemon=True)
        x_thread.start()
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while not x_out and time.monotonic() < deadline:
            time.sleep(0.005)
        for mid in (y, z):
            toks = replica_stream(actor, mid, dict(
                prompt=short, max_new_tokens=MUX_ORDER_NEW), [])
            held.append((mid, short, toks))
        under = replica_call(actor, "stats")
        x_was_streaming = x_thread.is_alive()
        x_thread.join(SERVE_TIMEOUT_S)
        check(complete(x_out, MUX_HOLD_NEW),
              f"the stream of evicted {x} ended short ({len(x_out)} tokens)")
        held.append((x, long_prompt, list(x_out)))
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        after = replica_call(actor, "stats")
        while after["parked"] and time.monotonic() < deadline:
            time.sleep(0.05)
            after = replica_call(actor, "stats")
        logits = {}
        for _, a in actors:
            logits.update(replica_call(a, "logits"))
        phase_grpc(handle, cfg, card, held)
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
        deadline = time.monotonic() + CLUSTER_DOWN_S
        left = port_processes()
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = port_processes()
    check(not left, f"port processes outlived shutdown by {CLUSTER_DOWN_S} "
          f"s: {left}")

    # (d) and (e): each id's cold wave made one load, and every request of
    # the routed traffic for an id went to one replica.
    cold_loads = [m for s in after_cold.values() for m, _ in s["loads"]]
    check(sorted(cold_loads) == sorted(MUX_IDS),
          f"{MUX_WAVE} concurrent cold requests a model id did not make one "
          f"load each: {cold_loads}")
    homes = {mid: [r for r, s in routed.items() if mid in s["requests"]]
             for mid in MUX_IDS}
    check(all(len(h) == 1 for h in homes.values()),
          f"a model id's requests went to more than one replica: {homes}")
    check(all(s["pid"] != driver_pid for s in routed.values())
          and len({s["pid"] for s in routed.values()}) == MUX_REPLICAS,
          "the replicas are not processes of their own")
    # (b): the fixed order's loads are the LRU rule's from the state the
    # routed traffic left.
    want_loads, want_resident = lru(MUX_ORDER, MUX_MAX_MODELS,
                                    routed[rid]["resident"])
    got_loads = [m for m, _ in ordered["loads"][len(routed[rid]["loads"]):]]
    check(got_loads == want_loads and ordered["resident"] == want_resident,
          f"replica {rid} holding {routed[rid]['resident']} loaded "
          f"{got_loads} for {MUX_ORDER} and holds {ordered['resident']}; "
          f"the LRU rule loads {want_loads} and holds {want_resident}")
    # (c): unloaned evictions free an engine at once; the loaned one's
    # bytes stay while its stream runs and go after.
    direct = ordered["evictions"][len(routed[rid]["evictions"]):]
    freed = [before - after_ for _, before, after_, _ in direct]
    check(direct and all(not parked for *_, parked in direct)
          and all(f >= CLUSTER_FREED_MIN_B for f in freed),
          f"an eviction with no loans freed {freed} B, under "
          f"{CLUSTER_FREED_MIN_B} B: {direct}")
    z_event = under["evictions"][-1]
    check(z_event[0] == z and z_event[3] == [x] and x_was_streaming,
          f"loading {z} under {x}'s stream did not park {x}: {z_event}, "
          f"stream in flight {x_was_streaming}")
    parked_held = z_event[1] - z_event[2]
    released = under["allocated"] - after["allocated"]
    check(parked_held < CLUSTER_FREED_MIN_B and under["parked"] == [x],
          f"{x}'s bytes left while its stream ran: {parked_held} B freed at "
          f"its eviction")
    check(released >= CLUSTER_FREED_MIN_B and not after["parked"],
          f"{x}'s bytes were not freed after its stream ended: {released} B")
    # (f): K1 in the replicas, once a layer a no-prefix prefill.
    k1 = sum(s["k1"] for s in routed.values())
    prefills = sum(s["full_prefills"] for s in routed.values())
    check(k1 > 0 and k1 == cfg.n_layers * prefills,
          f"the replicas launched K1 {k1} times for {prefills} no-prefix "
          f"prefills of {cfg.n_layers} layers")
    # (a): every stream against its id's no-cache forward.
    worst = 0.0
    is_max = ties = total = 0
    for mid in MUX_IDS:
        mparams, mcfg = mux_params(mid)
        streams = {tuple(p): g for m, p, g in held if m == mid}
        for (lid, toks), got in logits.items():
            if lid == mid:
                first, _, _, _ = hold_to_forward(mparams, mcfg, list(toks),
                                                 streams[toks])
                worst = max(worst, float(np.abs(got - first).max()))
        for m, prompt, toks in held:
            if m == mid:
                a, t = stream_vs_forward(mparams, mcfg, prompt, toks)
                is_max += a
                ties += t
                total += len(toks)
        del mparams

    per = {r: dict(pid=s["pid"], resident=s["resident"],
                   allocated=s["allocated"], loads=s["loads"])
           for r, s in routed.items()}
    load_s = [s for st in dict(routed, **{rid: after}).values()
              for _, s in st["loads"]]
    print(f"multiplex flagship f32 paged, {MUX_REPLICAS} replica processes "
          f"({MUX_GPU_SHARE} GPU each), {len(MUX_IDS)} model ids, at most "
          f"{MUX_MAX_MODELS} engines a replica: serve.run to ready "
          f"{deploy_s:.3f} s; cold waves ({MUX_WAVE} streams an id, all "
          f"ids at once) {cold_s:.3f} s; cold load s (weights from the "
          f"id's seed on the card, engine started) {load_s} [{card}]",
          flush=True)
    print(f"multiplex warm tokens_per_s by id "
          f"{json.dumps({m: round(v, 2) for m, v in tps.items()})} (8 "
          f"prompts as 2 waves of {MUX_WAVE}, the second pass; the first "
          f"{json.dumps({m: round(v, 2) for m, v in first_tps.items()})}); "
          f"K1 launches {k1} in the "
          f"replicas for {prefills} no-prefix prefills x {cfg.n_layers} "
          f"layers (the engine phase's pass: {engine_launches}); resident "
          f"by replica {json.dumps(per)} [{card}]", flush=True)
    print(f"multiplex LRU: replica {rid} holding "
          f"{routed[rid]['resident']} sent {list(MUX_ORDER)} directly, "
          f"loads {got_loads} (the LRU rule's), evictions with no loan "
          f"freed {freed} B (gate {CLUSTER_FREED_MIN_B}); {z} loaded under "
          f"{x}'s {MUX_HOLD_NEW}-token stream parked {x} ({parked_held} B "
          f"freed then), {released} B freed after that stream ended; cold "
          f"loads {cold_loads} for {MUX_WAVE} concurrent requests an id; "
          f"homes {json.dumps(homes)} [{card}]", flush=True)
    print(f"multiplex vs no-cache forward: {len(held)} streams, "
          f"{is_max}/{total} tokens the forward's argmax, {ties} more tie "
          f"it within {ENGINE_LOGIT_ATOL:g}; prefill logits max_abs_err "
          f"{worst:.3e} (tol {ENGINE_LOGIT_ATOL:g}) over {len(logits)} "
          f"prompts [{card}]", flush=True)
    check(worst <= ENGINE_LOGIT_ATOL,
          f"multiplexed prefill logits differ from the forward by "
          f"{worst:.3e}")
    check(is_max + ties == total, f"{total - is_max - ties} multiplexed "
          f"tokens differ from their id's forward beyond a tie")
    return k1, tps


def phase_grpc(handle, cfg, card: str, held: list):
    """The gRPC ingress (`serve.start_grpc_ingress`) in front of the
    multiplexed deployment: each model id's tokens through
    `GrpcServeClient.call(..., model_id=...)` in both payload modes equal
    the handle's for the same request, and an `allow_pickle=False` ingress
    refuses a pickled payload. Without grpcio, both refuse with an
    ImportError naming it."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import serve

    if not importable("grpc"):
        for start in (serve.start_grpc_ingress,
                      lambda: serve.GrpcServeClient("127.0.0.1:1")):
            try:
                start()
            except ImportError as e:
                check("grpcio" in str(e), f"the refusal does not name "
                      f"grpcio: {e}")
            else:
                raise PhaseError("the gRPC ingress started without grpc")
        print(f"grpc: absent on this machine; start_grpc_ingress and "
              f"GrpcServeClient raise ImportError naming grpcio [{card}]",
              flush=True)
        return
    rng = np.random.default_rng(17)
    req = dict(prompt=rng.integers(2, cfg.vocab_size, 96).tolist(),
               max_new_tokens=16)
    port = serve.start_grpc_ingress()
    times, wants = {}, {}
    for mid in MUX_IDS:
        t0 = time.perf_counter()
        want = handle.options(multiplexed_model_id=mid).remote(req).result(
            timeout_s=SERVE_TIMEOUT_S)
        times[mid] = [round((time.perf_counter() - t0) * 1e3, 3)]
        for fmt in ("pickle", "msgpack"):
            client = serve.GrpcServeClient(f"127.0.0.1:{port}",
                                           payload_format=fmt)
            try:
                t0 = time.perf_counter()
                got = client.call("MuxLLM", req, model_id=mid,
                                  timeout=SERVE_TIMEOUT_S)
                times[mid].append(round((time.perf_counter() - t0) * 1e3, 3))
            finally:
                client.close()
            check(got == want, f"{mid} through gRPC ({fmt}) gave {got}, "
                  f"the handle {want}")
        wants[mid] = want
        held.append((mid, req["prompt"], want))
    # The pickling ingress goes; one with allow_pickle=False refuses a
    # pickled payload and answers a msgpack one.
    proxy = ray_tpu_torch.get_actor(serve._GRPC_PROXY_NAME)
    ray_tpu_torch.get(proxy.stop.remote(), timeout=60)
    ray_tpu_torch.kill(proxy)
    serve._grpc_port = None
    port = serve.start_grpc_ingress(allow_pickle=False)
    pickled = serve.GrpcServeClient(f"127.0.0.1:{port}")
    plain = serve.GrpcServeClient(f"127.0.0.1:{port}",
                                  payload_format="msgpack")
    try:
        try:
            pickled.call("MuxLLM", req, model_id=MUX_IDS[0])
        except serve.RayServeException as e:
            refusal = str(e)
        else:
            raise PhaseError("an allow_pickle=False ingress took a pickled "
                             "payload")
        check("allow_pickle=False" in refusal, f"unexpected refusal: "
              f"{refusal}")
        check(plain.call("MuxLLM", req, model_id=MUX_IDS[0])
              == wants[MUX_IDS[0]],
              "the no-pickle ingress's msgpack answer differs")
    finally:
        pickled.close()
        plain.close()
    print(f"grpc ingress on 127.0.0.1: {len(MUX_IDS)} model ids, tokens "
          f"equal the handle's in both payload modes (pickle, msgpack); "
          f"ms by id [handle, grpc pickle, grpc msgpack] "
          f"{json.dumps(times)} ({req['max_new_tokens']} new tokens, 96-token "
          f"prompt); allow_pickle=False refused a pickled payload "
          f"({refusal[:80]!r}) [{card}]", flush=True)


def phase_trace(cfg, card: str, mux_tps: dict):
    """Tracing across processes: `enable_tracing(out_dir)` before `init()`,
    the multiplexed deployment on one replica process, one HTTP (SSE) and
    one handle request: each one trace id, the replica's span from the
    replica process's own file; with sample rate 0 a request records no
    span; the warm tokens/s of one model id with tracing on beside the
    multiplex phase's (off). Then `run_timeline_capture`,
    `wire_decode_bench` and the two overhead benches, printed."""
    import tempfile

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import perf, serve
    from ray_tpu_torch.util import tracing

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    mid = MUX_IDS[0]
    rng = np.random.default_rng(19)
    short = rng.integers(2, cfg.vocab_size, 64).tolist()
    prompts = engine_prompts(cfg)
    tracing.enable_tracing(out_dir)
    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    ray_tpu_torch.init(num_cpus=CLUSTER_CPUS)
    try:
        port = serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
        app = serve.deployment(
            MuxLLM, name="MuxLLM", num_replicas=1,
            ray_actor_options={"num_gpus": MUX_GPU_SHARE})
        handle = serve.run(app.bind(), route_prefix="/mux",
                           _blocking_timeout_s=SERVE_READY_S)
        (_, actor), = replica_actors("MuxLLM")
        replica_pid = replica_call(actor, "stats")["pid"]
        http_toks, _, _, _ = sse_request(
            port, dict(prompt=short, max_new_tokens=8, model_id=mid),
            path="/mux?method=generate")
        handle_toks = list(handle.options(
            multiplexed_model_id=mid, stream=True,
            method_name="generate").remote(dict(prompt=short,
                                                max_new_tokens=8)))
        check(http_toks == handle_toks and len(http_toks) == 8,
              f"HTTP and handle tokens differ: {http_toks} {handle_toks}")

        def complete(spans):
            proxies = [s for s in spans if s["name"] == "serve.proxy"]
            routers = [s for s in spans if s["name"] == "serve.router"
                       and s["pid"] == os.getpid()]
            return proxies and routers and all(
                "serve.replica" in {x["name"] for x in spans
                                    if x["trace_id"] == s["trace_id"]}
                for s in proxies + routers)

        deadline = time.monotonic() + 30
        spans = tracing.collect(out_dir)
        while not complete(spans) and time.monotonic() < deadline:
            time.sleep(0.25)
            spans = tracing.collect(out_dir)
        check(complete(spans), f"no whole trace of the two requests: "
              f"{[(s['name'], s['pid']) for s in spans]}")
        proxy = next(s for s in spans if s["name"] == "serve.proxy")
        router = min((s for s in spans if s["name"] == "serve.router"
                      and s["pid"] == os.getpid()),
                     key=lambda s: s["start_us"])
        with open(os.path.join(out_dir, f"{replica_pid}.jsonl")) as f:
            replica_file = [json.loads(line) for line in f if line.strip()]
        traces = {}
        for what, root in (("http", proxy), ("handle", router)):
            same = [s for s in spans if s["trace_id"] == root["trace_id"]]
            names = {s["name"] for s in same}
            want = {"serve.router", "serve.replica"} | (
                {"serve.proxy"} if what == "http" else set())
            check(want <= names, f"the {what} request's trace lacks "
                  f"{want - names}")
            rep = next(s for s in same if s["name"] == "serve.replica")
            check(rep["pid"] == replica_pid != os.getpid()
                  and rep in replica_file,
                  f"the {what} request's replica span is not from the "
                  f"replica process's file")
            traces[what] = sorted({(s["name"], s["pid"]) for s in same})
        chrome = os.path.join(out_dir, "trace.json")
        tracing.to_chrome_trace(spans, chrome)
        with open(chrome) as f:
            events = json.load(f)
        check({proxy["trace_id"], router["trace_id"]}
              <= {e["args"]["trace_id"] for e in events},
              "the chrome trace lacks the requests' traces")

        # The multiplex phase's warm pass of one id, with tracing on; a
        # pass first, untimed, as the multiplex phase's cold waves ran
        # those prompt lengths before its timed pass.
        def warm_pass():
            t0 = time.perf_counter()
            n_tok = 0
            for lo in (0, MUX_WAVE):
                gens = [handle.options(
                    multiplexed_model_id=mid, stream=True,
                    method_name="generate").remote(
                        dict(prompt=p, max_new_tokens=ENGINE_NEW))
                    for p in prompts[lo:lo + MUX_WAVE]]
                threads, outs = run_threads([((lambda g, o: o.update(
                    tokens=list(g))), (g,)) for g in gens])
                join_all(threads, SERVE_TIMEOUT_S)
                check(all("tokens" in o for o in outs),
                      f"a traced stream failed: {outs}")
                n_tok += sum(len(o["tokens"]) for o in outs)
            return n_tok / (time.perf_counter() - t0)

        # Then two passes traced (sample rate 1 at the driver, the
        # handle requests' root) alternating with two unsampled (rate 0:
        # the same spans' code runs, nothing records): what recording
        # costs, on one replica.
        first_tps = warm_pass()
        rates = {1.0: [], 0.0: []}
        for rate in (1.0, 0.0, 1.0, 0.0):
            tracing.enable_tracing(out_dir, sample_rate=rate)
            rates[rate].append(warm_pass())
        tracing.enable_tracing(out_dir, sample_rate=1.0)
        traced_tps = float(np.mean(rates[1.0]))
        unsampled_tps = float(np.mean(rates[0.0]))

        def request_spans():
            def of_requests():
                return [s for s in tracing.collect(out_dir)
                        if s["name"].startswith("serve.")
                        or "handle_request" in s["name"]]

            got, n = of_requests(), -1
            while len(got) != n:
                n = len(got)
                time.sleep(1.0)
                got = of_requests()
            return got

        before = request_spans()
        tracing.enable_tracing(out_dir, sample_rate=0.0)
        list(handle.options(multiplexed_model_id=mid, stream=True,
                            method_name="generate").remote(
            dict(prompt=short, max_new_tokens=8)))
        unsampled = len(request_spans()) - len(before)
        check(unsampled == 0, f"an unsampled request recorded {unsampled} "
              f"spans")
        n_spans = len(tracing.collect(out_dir))
        files = sorted(f for f in os.listdir(out_dir)
                       if f.endswith(".jsonl"))
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
            tracing.disable_tracing()
        deadline = time.monotonic() + CLUSTER_DOWN_S
        left = port_processes()
        while left and time.monotonic() < deadline:
            time.sleep(0.05)
            left = port_processes()
    check(not left, f"port processes outlived shutdown by {CLUSTER_DOWN_S} "
          f"s: {left}")
    print(f"trace: enable_tracing before init, {len(files)} span files "
          f"({n_spans} spans); the HTTP request's trace "
          f"{json.dumps(traces['http'])}, the handle request's "
          f"{json.dumps(traces['handle'])} (driver pid {os.getpid()}, "
          f"replica pid {replica_pid}, its span read from {replica_pid}"
          f".jsonl); chrome trace {len(events)} events; sample rate 0: a "
          f"request recorded {unsampled} spans; {mid} warm tokens_per_s "
          f"traced {traced_tps:.2f} {[round(v, 2) for v in rates[1.0]]}, "
          f"unsampled {unsampled_tps:.2f} "
          f"{[round(v, 2) for v in rates[0.0]]} (alternating, after an "
          f"untimed pass at {first_tps:.2f}), beside {mux_tps[mid]:.2f} "
          f"with tracing off (multiplex phase) [{card}]", flush=True)

    path = os.path.join(out_dir, "timeline.json")
    timeline = perf.run_timeline_capture(path, scale=0.25)
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    print(f"perf timeline {json.dumps(timeline)}; {n_events} chrome events "
          f"[{card}]", flush=True)
    check({"driver", "worker"} <= set(timeline["timeline_roles"])
          and timeline["timeline_events"] > 0,
          f"the merged timeline lacks the driver or a worker: {timeline}")
    wire = perf.wire_decode_bench()
    flight_out = perf.run_flight_overhead_bench(scale=0.25, bursts=2)
    metrics_out = perf.run_metrics_overhead_bench(scale=0.25, bursts=2)
    print(f"perf wire_decode_bench {json.dumps(wire)}; flight overhead "
          f"{json.dumps(flight_out)}; metrics overhead "
          f"{json.dumps(metrics_out)} (host, no gate) [{card}]", flush=True)


def phase_microbench(card: str):
    """`python -m ray_tpu_torch.perf --microbench`: the runtime on this
    machine's host (tasks/s, actor calls/s, put/get 10 MB), cluster."""
    from ray_tpu_torch.perf import run_microbench

    out = run_microbench(scale=0.5)
    print(f"perf microbench {json.dumps(out)} [{card}]", flush=True)
    keys = ("dag_chain_calls_per_s", "dag_chain_call_ms",
            "cgraph_calls_per_s", "cgraph_call_ms", "cgraph_vs_dag_speedup",
            "array_chan_MBps")
    check(all(isinstance(out.get(k), float) and out[k] > 0 for k in keys),
          f"the microbench's DAG and compiled-graph keys are not all "
          f"positive numbers: {[out.get(k) for k in keys]}")


def phase_perf_twins(card: str):
    """`python -m ray_tpu_torch.perf --llm-serve` (paged section on the
    card) and `--fleet`, once each, each printed as a JSON line."""
    from ray_tpu_torch.perf import run_fleet_bench, run_llm_serve_bench

    llm = run_llm_serve_bench(device="cuda")
    print(f"perf llm_serve [{card}]: {json.dumps(llm)}", flush=True)
    check(llm["llm_paged_parity"] == 1 and llm["llm_paged_host_gathers"] == 0,
          f"paged decode: parity {llm['llm_paged_parity']}, host gathers "
          f"{llm['llm_paged_host_gathers']}")
    fleet = run_fleet_bench()
    print(f"perf fleet [{card}]: {json.dumps(fleet)}", flush=True)
    check(fleet["fleet_prefix_ships"] >= 1
          and fleet["fleet_lost_conversations"] == 0,
          f"fleet bench: ships {fleet['fleet_prefix_ships']}, lost "
          f"{fleet['fleet_lost_conversations']}")


def bwd_bounds(shape, dtype: str, power_w: float):
    """{kernel: (bound_ms, bound_ms at the power limit, what sets it,
    operations, bound_ms at the tensor cores' 3xTF32 rate)} for K2 (4 B H
    S (S+1) D operations; q, k, v, dO read, dk, dv written, plus lse and
    di in float32) and K3 (3 B H S (S+1) D; q, k, v, dO read, dq written,
    plus lse and di). The peak is the route's, PEAK_FLOPS (bf16 on the
    tensor cores, float32 on the CUDA cores); the last entry is None for
    bf16."""
    b, s, h, d = shape
    esize = 4 if dtype == "float32" else 2
    peak = PEAK_FLOPS[dtype]
    derate = max(1.0, FULL_POWER_W / power_w) if power_w > 0 else 1.0
    out = {}
    for name, n_products, n_tensors in (("dkv", 4, 6), ("dq", 3, 5)):
        flops = n_products * b * h * s * (s + 1) * d
        nbytes = n_tensors * b * s * h * d * esize + 2 * b * h * s * 4
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        bound = max(t_ops, t_bytes) * 1e3
        tf32x3 = (max(flops / PEAK_FLOPS_F32_3XTF32, t_bytes) * 1e3
                  if dtype == "float32" else None)
        out[name] = (bound, bound * derate,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     tf32x3)
    return out


def device_ms(fn, iters: int, attempts: int = 3):
    """Device time per call of `fn`: the sum of its kernels' durations
    over `iters` calls under `torch.profiler`, after one warm-up call, so
    that gaps on the host between kernels do not count. A profiler session
    that records no kernel is tried again; after `attempts` such sessions
    this returns None (not measured): the figure is a yardstick, not a
    gate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            return sum(e.time_range.end - e.time_range.start
                       for e in events) / 1e3 / iters
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bwd_flip_bound(q, k, v, do, lse, di):
    """[B, S, H, D] bounds on what one flipped bf16 rounding of p or ds can
    do to (dq, dk, dv): a flip changes one term of a row's sum by one ulp
    of p or ds (at most 2^-7 of it) times the other factor, so dV[key] moves
    by at most 2^-7 max_q p[q, key] max_q |dO[q]|, dK[key] by 2^-7 max_q
    |ds[q, key]| max_q |q[q]|, and dQ[q] by 2^-7 max_key |ds[q, key]|
    max_key |k[key]|."""
    import torch

    s = q.shape[1]
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(scores - lse[..., None]).masked_fill(~mask, 0.0)
    del scores
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - di[..., None]) * scale).abs()
    del dp
    ulp = 2.0 ** -7

    def col(t, dim):
        return t.amax(dim).transpose(1, 2)[..., None]

    dq = ulp * col(ds, 3) * k.float().abs().amax(1, keepdim=True)
    dk = ulp * col(ds, 2) * q.float().abs().amax(1, keepdim=True)
    dv = ulp * col(p, 2) * do.float().abs().amax(1, keepdim=True)
    return dq, dk, dv


def bwd_errors(q, k, v, do, lse, di, dq, dk, dv):
    """{"dq"|"dk"|"dv": (max abs error, worst diff/tol, worst diff/tol
    without the flip term)} of (dq, dk, dv) against the plain versions on
    the same inputs, under BWD_TOL (plus, in bf16, BWD_FLIPS_PER_ROW x
    `bwd_flip_bound`)."""
    from ray_tpu_torch.kernels import flash_attn

    ref_dk, ref_dv = flash_attn.flash_attn_bwd_dkv_plain(q, k, v, do, lse,
                                                         di)
    ref_dq = flash_attn.flash_attn_bwd_dq_plain(q, k, v, do, lse, di)
    dtype = str(q.dtype).removeprefix("torch.")
    atol, rtol = BWD_TOL[dtype]
    flips = ((None,) * 3 if dtype == "float32" else
             bwd_flip_bound(q, k, v, do, lse, di))
    errs = {}
    for name, got, ref, flip in (("dq", dq, ref_dq, flips[0]),
                                 ("dk", dk, ref_dk, flips[1]),
                                 ("dv", dv, ref_dv, flips[2])):
        diff = (got.float() - ref.float()).abs()
        tol = atol + rtol * ref.float().abs()
        over_plain = 0.0
        if flip is not None:
            over_plain = (diff / tol).max().item()
            tol = tol + BWD_FLIPS_PER_ROW * flip
        errs[name] = (diff.max().item(), (diff / tol).max().item(),
                      over_plain)
    return errs


def phase_bwd_kernels(card: str, power_w: float):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.kernels import flash_attn

    # A first profiler session starts CUPTI before any row is measured.
    device_ms(lambda: torch.zeros(1, device="cuda").add_(1), 1)
    rows = {}
    for i_row, (shape, dtype, layout, qk_scale) in enumerate(BWD_SHAPES):
        dt = getattr(torch, dtype)
        gen = torch.Generator(device="cuda").manual_seed(100 + 2 * i_row)
        b, s, h, d = shape
        if layout == "qkv":
            qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda")
            qkv[:, :, :2] *= qk_scale
            q, k, v = qkv.to(dt).unbind(2)
            del qkv
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(3))
            q, k, v = ((q * qk_scale).to(dt), (k * qk_scale).to(dt),
                       v.to(dt))
        do = torch.randn(shape, generator=gen, device="cuda").to(dt)
        o, lse = flash_attn.flash_attn_fwd(q, k, v, return_lse=True)
        di = flash_attn.attention_di(o, do)
        dk, dv = flash_attn.flash_attn_bwd_dkv(q, k, v, do, lse, di)
        dq = flash_attn.flash_attn_bwd_dq(q, k, v, do, lse, di)
        dk2, dv2 = flash_attn.flash_attn_bwd_dkv(q, k, v, do, lse, di)
        dq2 = flash_attn.flash_attn_bwd_dq(q, k, v, do, lse, di)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in ((dq, dq2), (dk, dk2),
                                                   (dv, dv2)))
        del dq2, dk2, dv2
        tag = f"{dtype} {list(shape)} {layout}" + (
            f" q,k x{qk_scale:g}" if qk_scale != 1.0 else "")
        check(same, f"flash_attn_bwd {tag}: two launches on the same "
                    f"inputs differ")
        errs = bwd_errors(q, k, v, do, lse, di, dq, dk, dv)
        atol, rtol = BWD_TOL[dtype]
        bounds = bwd_bounds(shape, dtype, power_w)
        times = {
            "dkv": cuda_ms(lambda: flash_attn.flash_attn_bwd_dkv(
                q, k, v, do, lse, di), 10),
            "dq": cuda_ms(lambda: flash_attn.flash_attn_bwd_dq(
                q, k, v, do, lse, di), 10)}
        plain = {
            "dkv": cuda_ms(lambda: flash_attn.flash_attn_bwd_dkv_plain(
                q, k, v, do, lse, di), 3, warmup=1),
            "dq": cuda_ms(lambda: flash_attn.flash_attn_bwd_dq_plain(
                q, k, v, do, lse, di), 3, warmup=1)}
        torch.cuda.empty_cache()
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        library_ms = cuda_ms(sdpa_bwd, 10)
        library_device_ms = device_ms(sdpa_bwd, 10)
        del out
        for kname, parts in (("dkv", ("dk", "dv")), ("dq", ("dq",))):
            err = max(errs[p][0] for p in parts)
            worst = max(errs[p][1] for p in parts)
            bound, derated, bound_by, flops, tf32x3 = bounds[kname]
            tflops = flops / times[kname] / 1e9
            rows[(kname, shape, dtype, layout, qk_scale)] = dict(
                max_abs_err=err, ms=times[kname], plain_ms=plain[kname],
                bound_ms=bound, bound_ms_at_power_limit=derated,
                bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_device_ms,
                achieved_tflops=tflops, worst_diff_over_tol=worst)
            note = route = ""
            if dtype == "bfloat16":
                note = (f" + {BWD_FLIPS_PER_ROW} x bwd_flip_bound; without "
                        f"it: worst diff/tol "
                        f"{max(errs[p][2] for p in parts):.3f}")
            else:
                route = (f"; at the tensor cores' 3xTF32 rate "
                         f"{tf32x3 * 1e3:.2f}")
            print(f"kernel flash_attn_bwd_{kname} {tag}: max_abs_err "
                  f"{err:.3e} (tol {atol:g} + "
                  f"{rtol:g}|ref|{note}; worst diff/tol {worst:.3f}; "
                  f"bitwise-equal over two launches) "
                  f"kernel_ms {times[kname]:.4f} achieved_tflops "
                  f"{tflops:.1f} plain_ms "
                  f"{plain[kname]:.4f} library_ms (SDPA backward, K2+K3 "
                  f"pair) {library_ms:.4f} (device "
                  f"{fmt_ms(library_device_ms)}) "
                  f"bound_us {bound * 1e3:.2f} ({bound_by}; "
                  f"{derated * 1e3:.2f} at the power limit{route}) "
                  f"[{card}]", flush=True)
            check(worst <= 1, f"flash_attn_bwd_{kname} {tag} disagrees "
                  f"with its plain version: max_abs_err {err:.3e}, worst "
                  f"diff/tol {worst:.3f}")
        print(f"kernel flash_attn_bwd K2+K3 {tag}: kernels_ms "
              f"{times['dkv'] + times['dq']:.4f} library_ms "
              f"{library_ms:.4f} library_device_ms "
              f"{fmt_ms(library_device_ms)} "
              f"[{card}]", flush=True)
        del q, k, v, do, o, lse, di, dk, dv, dq, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return rows


def _leaves(params):
    return [params["embed"], params["ln_f"]] + [
        t for lp in params["layers"] for t in lp.values()]


def _leaf_names(params):
    return ["embed", "ln_f"] + [
        f"layers.{i}.{key}" for i, lp in enumerate(params["layers"])
        for key in lp]


def _split_qkv(names, tensors):
    """(names, tensors) with each wqkv [D, 3, H hd] split into its q, k
    and v parts: dQ and dK reach only their own part."""
    out_names, out = [], []
    for name, t in zip(names, tensors):
        if name.endswith(".wqkv"):
            out_names += [f"{name}.{p}" for p in "qkv"]
            out += list(t.unbind(1))
        else:
            out_names.append(name)
            out.append(t)
    return out_names, out


def plain_lm_loss(params, tokens, cfg):
    """`lm_loss` of tokens [B, S+1] with explicit positions, which take
    plain attention."""
    import torch

    from ray_tpu_torch.models.transformer import _token_nll, backbone

    positions = torch.arange(tokens.shape[1] - 1, device=tokens.device)
    x, aux = backbone(params, tokens[:, :-1], cfg, positions)
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(cfg.dtype))
    return _token_nll(logits, tokens[:, 1:]) + cfg.aux_loss_weight * aux


def grad_errors(params, cfg):
    """`lm_loss` gradients (in cfg's dtype, GRAD_BATCH x TRAIN_SEQ tokens)
    through the kernels and through plain attention, each leaf's relative
    L2 distance to a float32 plain-attention reference, and the K1, K2, K3
    launches of the kernel path (counted from 0 just before it)."""
    from dataclasses import replace

    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import lm_loss

    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    tokens = torch.randint(0, cfg.vocab_size, (GRAD_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")

    def plain_loss(c):
        return plain_lm_loss(params, tokens, c)

    try:
        flash_attn.launches = flash_attn.dkv_launches = 0
        flash_attn.dq_launches = 0
        loss_k = lm_loss(params, {"tokens": tokens}, cfg)
        g_kernel = torch.autograd.grad(loss_k, leaves)
        torch.cuda.synchronize()
        counts = (flash_attn.launches, flash_attn.dkv_launches,
                  flash_attn.dq_launches)
        loss_p = plain_loss(cfg)
        g_plain = torch.autograd.grad(loss_p, leaves)
        loss_r = plain_loss(replace(cfg, dtype=torch.float32))
        g_ref = torch.autograd.grad(loss_r, leaves)
        check(flash_attn.dkv_launches == counts[1],
              "the plain-attention gradient launched a kernel")
    finally:
        for t in leaves:
            t.requires_grad_(False)

    def rel(g, r):
        return ((g.float() - r).norm() / r.norm()).item()

    names = _leaf_names(params)
    part_names, ref_parts = _split_qkv(names, g_ref)
    return dict(
        losses=(loss_k.item(), loss_p.item(), loss_r.item()),
        names=names, part_names=part_names,
        err_k=[rel(g, r) for g, r in zip(g_kernel, g_ref)],
        err_p=[rel(g, r) for g, r in zip(g_plain, g_ref)],
        part_k=[rel(g, r) for g, r in zip(
            _split_qkv(names, g_kernel)[1], ref_parts)],
        part_p=[rel(g, r) for g, r in zip(
            _split_qkv(names, g_plain)[1], ref_parts)],
        finite=all(bool(torch.isfinite(g).all()) for g in g_kernel),
        counts=counts)


def grad_summary(err_k, err_p, names):
    """(worst leaf index, its kernel/plain ratio, mean kernel, mean plain,
    whether every leaf is within GRAD_ERR_RATIO)."""
    ratios = [a / b for a, b in zip(err_k, err_p)]
    worst = max(range(len(names)), key=ratios.__getitem__)
    return (worst, ratios[worst], sum(err_k) / len(err_k),
            sum(err_p) / len(err_p), ratios[worst] <= GRAD_ERR_RATIO)


def phase_grad(params, cfg, card: str):
    """The bf16 gradient gate at full depth, then at GRAD_GATE_LAYERS,
    where it tells a 2% error in dK or dQ from bf16 noise."""
    from dataclasses import replace

    grad_gate(params, cfg, card)
    grad_gate(dict(params, layers=params["layers"][:GRAD_GATE_LAYERS]),
              replace(cfg, n_layers=GRAD_GATE_LAYERS), card)


def grad_gate(params, cfg, card: str, label: str = "flagship"):
    """The bf16 gradient gate at cfg's depth: each leaf and wqkv part of
    the kernel path within GRAD_ERR_RATIO of the plain path's distance to
    float32, K1, K2, K3 once a layer."""
    r = grad_errors(params, cfg)
    names, err_k, err_p, counts = (r["names"], r["err_k"], r["err_p"],
                                   r["counts"])
    worst, ratio, mean_k, mean_p, _ = grad_summary(err_k, err_p, names)
    part_names, part_k, part_p = r["part_names"], r["part_k"], r["part_p"]
    pworst, pratio, _, _, ok = grad_summary(part_k, part_p, part_names)
    loss_k, loss_p, loss_r = r["losses"]
    print(f"grad {label} bf16 depth {cfg.n_layers} [{GRAD_BATCH}, "
          f"{TRAIN_SEQ}] remat "
          f"{cfg.remat_policy}: loss kernels {loss_k:.5f} plain "
          f"{loss_p:.5f} float32 {loss_r:.5f}; per-leaf "
          f"rel_l2 to float32 over {len(names)} leaves: kernels max "
          f"{max(err_k):.3e} mean {mean_k:.3e}, plain max {max(err_p):.3e} "
          f"mean {mean_p:.3e}; largest per-leaf ratio {ratio:.3f} "
          f"({names[worst]}: {err_k[worst]:.3e} vs {err_p[worst]:.3e}); "
          f"with wqkv split into q, k, v parts {pratio:.3f} "
          f"({part_names[pworst]}; each part's kernels <= "
          f"{GRAD_ERR_RATIO:g} x plain); launches K1 {counts[0]} K2 {counts[1]} K3 {counts[2]} "
          f"[{card}]", flush=True)
    check(all(c == cfg.n_layers for c in counts),
          f"the kernel gradient launched K1, K2, K3 {counts} times, "
          f"expected {cfg.n_layers} each")
    check(r["finite"], "kernel-path gradients are not finite")
    check(ok, f"the kernel-path gradient of {part_names[pworst]} at "
              f"depth {cfg.n_layers} is further from float32 "
              f"({part_k[pworst]:.3e}) than the plain path's "
              f"({part_p[pworst]:.3e}) allows")


def phase_grad_f32(params, cfg, card: str, label: str = "flagship"):
    """The float32 training path through K1, K2 and K3's float32 route:
    `lm_loss` gradients of a float32 model at the flagship width, depth
    cut to F32_GRAD_LAYERS, against plain attention's, leaf by leaf with
    wqkv split into q, k, v. Returns the K1, K2, K3 launches."""
    from dataclasses import replace

    import torch

    cfg = replace(cfg, n_layers=F32_GRAD_LAYERS, dtype=torch.float32)
    params = dict(params, layers=params["layers"][:F32_GRAD_LAYERS])
    r = grad_errors(params, cfg)
    names, part_k, counts = r["part_names"], r["part_k"], r["counts"]
    worst = max(range(len(names)), key=part_k.__getitem__)
    loss_k, loss_p, _ = r["losses"]
    print(f"grad {label} f32 depth {cfg.n_layers} [{GRAD_BATCH}, "
          f"{TRAIN_SEQ}] remat {cfg.remat_policy}: loss kernels "
          f"{loss_k:.6f} plain {loss_p:.6f}; rel_l2 kernels vs plain "
          f"attention over {len(names)} parts (wqkv split into q, k, v): "
          f"max {part_k[worst]:.3e} ({names[worst]}), mean "
          f"{sum(part_k) / len(part_k):.3e} (limit {F32_GRAD_REL_L2:g}); "
          f"launches K1 {counts[0]} K2 {counts[1]} K3 {counts[2]} [{card}]",
          flush=True)
    check(all(c == cfg.n_layers for c in counts),
          f"the float32 gradient launched K1, K2, K3 {counts} times, "
          f"expected {cfg.n_layers} each")
    check(r["finite"], "float32 kernel-path gradients are not finite")
    check(part_k[worst] <= F32_GRAD_REL_L2,
          f"the float32 kernel-path gradient of {names[worst]} is "
          f"{part_k[worst]:.3e} from plain attention's (rel L2), over "
          f"{F32_GRAD_REL_L2:g}")
    return counts


def phase_train(params, cfg, card: str, power_w: float,
                steps: int = TRAIN_STEPS, label: str = "flagship"):
    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import lm_loss
    from ray_tpu_torch.parallel import adamw, make_train_step

    n_params = sum(t.numel() for t in _leaves(params))
    start_sum = param_checksum(params)
    optimizer = adamw(1e-4)
    opt_state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), optimizer)
    batch = train_batch(cfg)
    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, batch)
    losses = [loss]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    flash_attn.launches = flash_attn.dkv_launches = 0
    flash_attn.dq_launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (flash_attn.launches, flash_attn.dkv_launches,
                flash_attn.dq_launches)
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * steps / dt
    mfu = 6.0 * n_params * tokens_per_s / PEAK_FLOPS["bfloat16"]
    per_step = [n / steps for n in launches]
    print(f"train {label} bf16 remat {cfg.remat_policy} AdamW 1e-4 "
          f"[{TRAIN_BATCH}, {TRAIN_SEQ}], {n_params} params: warm-up step "
          f"{warm_s:.3f} s; {steps} steps in {dt:.4f} s, step_ms "
          f"{dt / steps * 1e3:.2f}, tokens_per_s {tokens_per_s:.1f}, "
          f"MFU {mfu:.4f} (6 N tokens/s over 989 TFLOP/s bf16; "
          f"{mfu * FULL_POWER_W / power_w if power_w else mfu:.4f} of the "
          f"peak derated to the power limit), peak_memory_bytes {peak} "
          f"({peak / 2 ** 30:.2f} GiB), launches per step K1 {per_step[0]:g}"
          f" K2 {per_step[1]:g} K3 {per_step[2]:g} [{card}]", flush=True)
    tag = "train" if label == "flagship" else f"{label} train"
    print(f"{tag} losses {' '.join(f'{x:.5f}' for x in values)}",
          flush=True)
    check(all(x == x and abs(x) != float("inf") for x in values),
          "a train loss is not finite")
    check(values[-1] < values[0],
          f"the loss did not fall: {values[0]:.5f} -> {values[-1]:.5f}")
    check(all(n == cfg.n_layers * steps for n in launches),
          f"the train steps launched K1, K2, K3 {launches} times, expected "
          f"{cfg.n_layers * steps} each (once per layer per step)")
    prof = profile_step(lambda: step(params, opt_state, batch),
                        dt / steps * 1e3, card, f"{tag} step")
    return launches, dict(tokens_per_s=tokens_per_s, mfu=mfu,
                          peak_memory_bytes=peak,
                          step_ms=dt / steps * 1e3, profile=prof,
                          losses=values, start_checksum=start_sum)


def train_batch(cfg):
    """bench.py's token batch of the train phase, [TRAIN_BATCH,
    TRAIN_SEQ + 1], from its seed on this process's card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    return {"tokens": torch.randint(0, cfg.vocab_size,
                                    (TRAIN_BATCH, TRAIN_SEQ + 1),
                                    generator=gen, device="cuda")}


# Heads of 256: the flagship's widths with 6 heads of 256 in place of 12
# of 128 (V32768 D1536 L12 F6144, the same 503,354,880 parameters), as
# Gemma's and PaLM's heads are 256 wide. `phase_d256` drives it through
# the engine phase, the bf16 gradient gate at GRAD_GATE_LAYERS, the
# float32 gradients at F32_GRAD_LAYERS and D256_TRAIN_STEPS of bench.py's
# step.
D256 = dict(FLAGSHIP, n_heads=6)
D256_TRAIN_STEPS = 5


@contextlib.contextmanager
def plain_attention_calls():
    """Counts `ops.attention.plain_attention`'s calls on CUDA tensors while
    open: {"dispatch": calls without positions, which only `attention`'s
    fallback from the flash kernels makes; "reference": calls with explicit
    positions, the plain-attention references this script runs on
    purpose}."""
    mod = importlib.import_module("ray_tpu_torch.ops.attention")
    real = mod.plain_attention
    calls = {"dispatch": 0, "reference": 0}

    def counting(q, k, v, *, causal=True, positions=None):
        if q.is_cuda:
            calls["dispatch" if positions is None else "reference"] += 1
        return real(q, k, v, causal=causal, positions=positions)

    mod.plain_attention = counting
    try:
        yield calls
    finally:
        mod.plain_attention = real


def phase_d256(card: str, power_w: float):
    """The D256 model from the flagship's seed: the engine phase (float32,
    its 8 prompts, ENGINE_NEW new tokens, its gates), the bf16 gradient
    gate at GRAD_GATE_LAYERS, float32 gradients at F32_GRAD_LAYERS, then
    D256_TRAIN_STEPS of bench.py's train step (bf16, remat
    "save_attn_qkv", 16 x 1024), gated as the train phase. Fails if
    `plain_attention` ran on the card other than as a reference (explicit
    positions). Returns the K1 launches of the engine pass, and the K1, K2,
    K3 launches of the float32 gradient and of the train steps."""
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(dtype=torch.bfloat16, **D256)
    check(cfg.head_dim == 256, f"head_dim {cfg.head_dim}, expected 256")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == 503_354_880,
          f"the D256 model has {n_params} parameters, not the flagship's")
    train_cfg = replace(cfg, remat=True, remat_policy="save_attn_qkv")
    t0 = time.perf_counter()
    with plain_attention_calls() as plain:
        engine_launches, _ = phase_engine(
            params, replace(cfg, dtype=torch.float32), card, label="d256")
        grad_gate(dict(params, layers=params["layers"][:GRAD_GATE_LAYERS]),
                  replace(train_cfg, n_layers=GRAD_GATE_LAYERS), card,
                  label="d256")
        f32_launches = phase_grad_f32(params, train_cfg, card, label="d256")
        train_launches, _ = phase_train(params, train_cfg, card, power_w,
                                        steps=D256_TRAIN_STEPS,
                                        label="d256")
    print(f"d256 [6 heads of 256, {n_params} params]: plain_attention on "
          f"the card {plain['dispatch']} times through the flash dispatch "
          f"(must be 0), {plain['reference']} as the references "
          f"(explicit positions); phase {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    check(plain["dispatch"] == 0,
          f"plain_attention ran {plain['dispatch']} times on the card "
          f"through the flash dispatch at head_dim 256")
    return dict(engine=engine_launches, f32=f32_launches,
                train=train_launches)


def d256_kernel_entries(rows, bwd_rows, d256):
    """The kernels line's entries of the six D-256 variants: each row's
    numbers from the kernel phases (K1's `rows`, K2/K3's `bwd_rows`), its
    launches from `phase_d256` (`d256`)."""
    jax_site = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    fwd_src = "ray_tpu_torch/kernels/csrc/flash_attn_fwd.cu"
    bwd_src = "ray_tpu_torch/kernels/csrc/flash_attn_bwd.cu"
    d256_in = f"the D-256 phase's train steps ({D256_TRAIN_STEPS})"
    entries = [
        dict(name="flash_attn_fwd_d256", route="cuda",
             kernel="flash_fwd_tc<256>", source=fwd_src,
             replaces="ray_tpu/ops/attention.py:28",
             pallas_call=f"{jax_site}:758", launches=d256["train"][0],
             launches_in=d256_in, shape=list(D256_SHAPE[0]),
             dtype=D256_SHAPE[1], layout=D256_SHAPE[2], **rows[D256_SHAPE]),
        dict(name="flash_attn_fwd_f32_d256", route="cuda",
             kernel="flash_fwd_f32<256>", source=fwd_src,
             replaces="ray_tpu/ops/attention.py:28",
             pallas_call=f"{jax_site}:758", launches=d256["engine"],
             launches_in="the D-256 phase's engine pass",
             f32_grad_launches=d256["f32"][0],
             shape=list(D256_F32_SHAPE[0]), dtype=D256_F32_SHAPE[1],
             layout=D256_F32_SHAPE[2], **rows[D256_F32_SHAPE])]
    for kname, line, i in (("dkv", 1121, 1), ("dq", 1456, 2)):
        for shape_row, suffix, kernel, n, where in (
                (D256_SHAPE, "", f"flash_bwd_{kname}_tc_wide<256>",
                 d256["train"][i], d256_in),
                (D256_F32_SHAPE, "_f32", f"flash_bwd_{kname}_f32<256>",
                 d256["f32"][i], "the D-256 phase's float32 gradients")):
            shape, dtype, layout, _ = shape_row
            entries.append(dict(
                name=f"flash_attn_bwd_{kname}{suffix}_d256", route="cuda",
                kernel=kernel, source=bwd_src,
                replaces="ray_tpu/ops/attention.py:28",
                pallas_call=f"{jax_site}:{line}", launches=n,
                launches_in=where, shape=list(shape), dtype=dtype,
                layout=layout, **bwd_rows[(kname,) + shape_row]))
    return entries


# The cluster train phase: steps of bench.py's step in the train worker,
# the step after whose report the driver SIGKILLs that worker, and the
# steps of each attempt that torch.profiler captures (session steps).
CLUSTER_TRAIN_STEPS = 9
CLUSTER_TRAIN_KILL_AFTER = 3
CLUSTER_TRAIN_PROFILE = (2, 3)
CLUSTER_TRAIN_TIMEOUT_S = 600.0
TRAIN_KERNELS = ("flash_fwd_tc", "flash_bwd_dkv_tc", "flash_bwd_dq_tc")


def proc_start_time() -> float:
    """This process's start, in seconds since the epoch (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def cluster_train_loop(config):
    """`TorchTrainer`'s loop in the GPU-leased train worker: bench.py's
    flagship step as `phase_train` runs it (bf16, remat "save_attn_qkv",
    AdamW 1e-4, its token batch), from weights this worker makes from
    chip_smoke's seed. Each step reports its loss, its ms (CUDA-synced)
    and its K1, K2, K3 launches in this process, with a checkpoint of
    the step; a restarted attempt resumes at the checkpointed step + 1
    (with fresh weights: the checkpoint holds the step only)."""
    t_loop = time.time()
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import lm_loss
    from ray_tpu_torch.parallel import adamw, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ckpt = train.get_checkpoint()
    start = ckpt.to_dict()["step"] + 1 if ckpt is not None else 1
    params, cfg = flagship_params()
    cfg = replace(cfg, remat=True, remat_policy="save_attn_qkv")
    info = dict(pid=os.getpid(), start=start, proc_start=proc_start_time(),
                t_loop=t_loop,
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                cards=torch.cuda.device_count(),
                backend=dist.get_backend(), world=dist.get_world_size(),
                checksum_equal=param_checksum(params) == config["checksum"])
    optimizer = adamw(1e-4)
    opt_state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), optimizer)
    batch = train_batch(cfg)
    info["t_ready"] = time.time()
    for i in range(start, config["steps"] + 1):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        value = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        k1, k2, k3 = _counts()
        train.report(dict(info, step=i, loss=value, step_ms=ms, k1=k1,
                          k2=k2, k3=k3, t_report=time.time()),
                     checkpoint=train.Checkpoint.from_dict({"step": i}))


def phase_cluster_train(card: str, stats: dict):
    """bench.py's train step through the Train library on the cluster
    runtime: one `TorchTrainer` gang of one worker leasing the card (NCCL,
    world 1), run as a one-trial Tune job. The worker's losses against
    the train phase's, its K1, K2, K3 launches a step, a torch.profiler
    trace of two steps, a SIGKILL of the worker after step
    CLUSTER_TRAIN_KILL_AFTER and the gang's restart from the checkpoint,
    and shutdown. Returns the K1, K2, K3 launches a step in the worker."""
    import signal
    import tempfile
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch.util import placement_group_table

    n = CLUSTER_TRAIN_STEPS
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    run = "cluster_train"
    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=CLUSTER_CPUS)
    init_s = time.perf_counter() - t0
    res = ray_tpu_torch.cluster_resources()
    check(res.get("GPU") == 1.0, f"the node did not detect one GPU: {res}")
    try:
        trainer = train.TorchTrainer(
            cluster_train_loop,
            train_loop_config={"steps": n,
                               "checksum": stats["start_checksum"]},
            torch_config=train.TorchConfig(),
            scaling_config=train.ScalingConfig(
                num_workers=1, use_gpu=True, gpus_per_worker=1),
            run_config=train.RunConfig(
                name=run, storage_path=storage,
                failure_config=train.FailureConfig(max_failures=1)),
            train_config=train.TrainConfig(
                profile_steps=CLUSTER_TRAIN_PROFILE,
                profile_dir=os.path.join(storage, "profile")))
        out = {}

        def fit():
            try:
                out["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001
                out["error"] = e

        t_fit = time.time()
        thread = threading.Thread(target=fit, daemon=True)
        thread.start()
        killed = None      # (pid, kill time, the group it held)
        t_detect = t_pg = None
        deadline = time.monotonic() + CLUSTER_TRAIN_TIMEOUT_S
        while thread.is_alive() and time.monotonic() < deadline:
            if killed is None:
                for line in result_lines(os.path.join(storage, run)):
                    if line["step"] == CLUSTER_TRAIN_KILL_AFTER:
                        held = [g for g, i in placement_group_table().items()
                                if i["state"] == "CREATED"]
                        t_kill = time.time()
                        os.kill(line["pid"], signal.SIGKILL)
                        killed = (line["pid"], t_kill, held)
                        break
            elif t_pg is None:
                table = placement_group_table()
                now = time.time()
                if t_detect is None and any(
                        table[g]["state"] != "CREATED" for g in killed[2]):
                    t_detect = now
                if t_detect is not None and any(
                        i["state"] == "CREATED" and g not in killed[2]
                        for g, i in table.items()):
                    t_pg = now
            time.sleep(0.01)
        thread.join(max(deadline - time.monotonic(), 0.0))
        check(not thread.is_alive(), f"TorchTrainer.fit did not end within "
              f"{CLUSTER_TRAIN_TIMEOUT_S} s")
        if "error" in out:
            raise PhaseError(f"TorchTrainer.fit failed: {out['error']!r}")
        result = out["result"]
    finally:
        ray_tpu_torch.shutdown()
    t0 = time.perf_counter()
    left = port_processes()
    while left and time.perf_counter() - t0 < CLUSTER_DOWN_S:
        time.sleep(0.1)
        left = port_processes()
    down_s = time.perf_counter() - t0
    check(not left, f"port processes outlived shutdown by "
          f"{CLUSTER_DOWN_S} s: {left}")

    history = result.metrics_history
    steps = [m["step"] for m in history]
    check(killed is not None, "the worker never reported step "
          f"{CLUSTER_TRAIN_KILL_AFTER}: nothing was killed")
    check(steps == list(range(1, n + 1)), f"Result.metrics_history does "
          f"not hold every step exactly once: steps {steps}")
    attempts = {}
    for m in history:
        attempts.setdefault(m["pid"], []).append(m)
    first, second = (list(attempts.values()) + [[], []])[:2]
    check(len(attempts) == 2 and first[0]["pid"] == killed[0]
          and second[0]["start"] == first[-1]["step"] + 1,
          f"the gang did not restart once, resuming after the checkpointed "
          f"step: attempts (pid, first step, steps) "
          f"{[(a[0]['pid'], a[0]['start'], len(a)) for a in attempts.values()]}")
    want = stats["losses"]
    diffs = [abs(m["loss"] - want[j]) for a in (first, second)
             for j, m in enumerate(a)]
    for a in (first, second):
        m = a[0]
        check(m["checksum_equal"], "the train worker's flagship weights "
              "differ from the driver's")
        check(m["visible"] == "0" and m["cards"] == 1
              and m["backend"] == "nccl" and m["world"] == 1,
              f"the train worker does not hold the card over NCCL: "
              f"visible {m['visible']} cards {m['cards']} backend "
              f"{m['backend']} world {m['world']}")
    counts = [(m["k1"], m["k2"], m["k3"]) for m in history]
    trace = os.path.join(storage, "profile", run, "rank0", "trace.json")
    check(os.path.exists(trace), f"no profile trace at {trace}")
    with open(trace) as f:
        text = f.read()
    named = {k: text.count(k) for k in TRAIN_KERNELS}
    clean = [m["step_ms"] for m in second[1:]
             if not (CLUSTER_TRAIN_PROFILE[0] <= m["step"] - second[0]["step"]
                     + 1 <= CLUSTER_TRAIN_PROFILE[1])]
    step_ms = sorted(clean)[len(clean) // 2]
    r = second[0]
    split = dict(detect=t_detect - killed[1], pg_reserve=t_pg - t_detect,
                 worker_start_with_imports=r["t_loop"] - t_pg,
                 setup=r["t_ready"] - r["t_loop"],
                 first_step=r["t_report"] - r["t_ready"])
    print(f"cluster train flagship bf16 remat save_attn_qkv AdamW 1e-4 "
          f"[{TRAIN_BATCH}, {TRAIN_SEQ}]: TorchTrainer, 1 worker leasing "
          f"the card (CUDA_VISIBLE_DEVICES={first[0]['visible']}, NCCL "
          f"world {first[0]['world']}), fit as a one-trial Tune job; init "
          f"{init_s:.3f} s; worker weights' checksum equal to the driver's "
          f"on both attempts; step_ms {step_ms:.2f} in the worker (median "
          f"of {len(clean)} unprofiled steps after the restart's first; "
          f"phase_train {stats['step_ms']:.2f}, worker/in-process "
          f"{step_ms / stats['step_ms']:.3f}); launches a step K1 K2 K3 "
          f"{sorted(set(counts))} [{card}]", flush=True)
    shown = ["{} {} {}".format(a[0]["pid"], [m["step"] for m in a],
                               " ".join(f"{m['loss']:.5f}" for m in a))
             for a in (first, second)]
    print(f"cluster train losses by attempt (pid, steps, losses): "
          f"{'; '.join(shown)}; each attempt "
          f"against phase_train's losses from its first step: largest "
          f"difference {max(diffs):.3e} (gate: bitwise equal) [{card}]",
          flush=True)
    print(f"cluster train restart: SIGKILL of pid {killed[0]} after step "
          f"{CLUSTER_TRAIN_KILL_AFTER}; split s "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})}, total "
          f"{r['t_report'] - killed[1]:.3f} s from the kill to the resumed "
          f"step {r['step']}'s report; setup is the loop's imports of the "
          f"model and optimizer, the weights made on the card and their "
          f"checksum; the first step {r['step_ms']:.1f} ms on the card "
          f"(first attempt's {first[0]['step_ms']:.1f}); the resumed "
          f"worker's process started {r['proc_start'] - killed[1]:.3f} s "
          f"after the kill (negative: a spare the raylet had started); "
          f"the resumed "
          f"worker pid {r['pid']} leased the card again "
          f"(CUDA_VISIBLE_DEVICES={r['visible']}); fit {time.time() - t_fit:.3f} "
          f"s; shutdown {down_s:.3f} s, port processes left {len(left)} "
          f"[{card}]", flush=True)
    print(f"cluster train profile: TrainConfig(profile_steps="
          f"{CLUSTER_TRAIN_PROFILE}) trace {os.path.getsize(trace)} B, "
          f"kernel names {json.dumps(named)} [{card}]", flush=True)
    check(max(diffs) == 0.0, f"the train worker's losses differ from "
          f"phase_train's by up to {max(diffs):.3e}")
    layers = FLAGSHIP["n_layers"]
    check(all(c == (layers,) * 3 for c in counts),
          f"the train worker launched K1, K2, K3 {sorted(set(counts))} "
          f"times a step, expected {layers} each (once per layer)")
    check(all(named.values()), f"the profile trace does not name every "
          f"train kernel: {named}")
    return counts[0]


def result_lines(exp_dir: str) -> list:
    """The lines of the run's result.json so far (its one trial's)."""
    import glob

    out = []
    for path in glob.glob(os.path.join(exp_dir, "*", "result.json")):
        with open(path) as f:
            for ln in f:
                try:
                    out.append(json.loads(ln))
                except ValueError:
                    pass        # a line still being written
    return out


# The data phase: batch inference through a Dataset's actor pool, and bench.py's
# train step fed from a shuffled Dataset in a GPU-leased TorchTrainer worker,
# with the eager NCCL collectives inside that worker.
DATA_SEQS, DATA_SEQ_LEN, DATA_BLOCKS = 48, 512, 12
DATA_REPLICAS, DATA_GPU_SHARE = 2, 0.5
DATA_SCORE_RTOL = 1e-3
DATA_TRAIN_BATCHES, DATA_TRAIN_BLOCKS = 6, 12
DATA_TIMEOUT_S = 600.0


class FlagshipScorer:
    """`map_batches(..., compute="actors")` replica of the data phase: it
    makes the float32 flagship once, from chip_smoke's seed, on the card
    its GPU lease shows it, then scores each block of token sequences by
    each sequence's mean logit. Each block's result carries this process's
    pid and the K1 launches the block's forward made here."""

    def __init__(self):
        from dataclasses import replace

        import torch

        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params, cfg = flagship_params()
        self.params, self.cfg = params, replace(cfg, dtype=torch.float32)
        self.checksum = param_checksum(params)
        self.build_s = time.perf_counter() - t0
        self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")

    def __call__(self, block):
        import numpy as np
        import torch

        from ray_tpu_torch.models import forward
        from ray_tpu_torch.util import to_torch

        before = _counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = forward(self.params, to_torch(block["tokens"]),
                                self.cfg)
            score = logits.mean(dim=(1, 2)).cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        after = _counts()
        n = len(score)
        return {"score": score,
                "pid": np.full(n, os.getpid()),
                "k1": np.full(n, after[0] - before[0]),
                "k2k3": np.full(n, after[1] + after[2] - before[1]
                                - before[2]),
                "ms": np.full(n, ms),
                "build_s": np.full(n, self.build_s),
                "visible": np.full(n, int(self.visible or -1))}


def data_tokens(rows: int, cols: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, FLAGSHIP["vocab_size"], (rows, cols), dtype=np.int64)


def data_train_loop(config):
    """`TorchTrainer`'s loop of the data phase, in the GPU-leased worker:
    bench.py's step (as `cluster_train_loop` runs it) over the batches of
    this worker's Dataset shard through `iter_torch_batches`. Before the
    first step, an `nccl` `util.collective` group of world 1 runs
    allreduce, allgather, broadcast, reducescatter and barrier on CUDA
    tensors (each must give its input back), inside the step's
    telemetry."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import lm_loss
    from ray_tpu_torch.parallel import adamw, make_train_step
    from ray_tpu_torch.util import collective as col

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params, cfg = flagship_params()
    cfg = replace(cfg, remat=True, remat_policy="save_attn_qkv")
    info = dict(pid=os.getpid(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                backend=dist.get_backend(), world=dist.get_world_size(),
                checksum_equal=param_checksum(params) == config["checksum"])
    optimizer = adamw(1e-4)
    opt_state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), optimizer)
    shard = train.get_dataset_shard("train")
    batches = shard.iter_torch_batches(
        batch_size=TRAIN_BATCH, drop_last=True,
        dtypes={"tokens": torch.int64})
    coll = None
    for i, batch in enumerate(batches, start=1):
        if coll is None:
            coll = data_collectives(col)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        value = loss.item()
        ms = (time.perf_counter() - t0) * 1e3
        k1, k2, k3 = _counts()
        train.report(dict(info, step=i, loss=value, step_ms=ms, k1=k1,
                          k2=k2, k3=k3, coll=coll if i == 1 else None,
                          device=str(batch["tokens"].device),
                          shape=list(batch["tokens"].shape)))


def data_collectives(col) -> dict:
    """The eager collectives on an `nccl` group of world 1 (this worker's
    card): each op's result against its input, and their seconds."""
    import torch

    t0 = time.perf_counter()
    col.init_collective_group(1, 0, backend="nccl", group_name="smoke")
    init_s = time.perf_counter() - t0
    x = torch.arange(8, dtype=torch.float32, device="cuda") * 1.5
    ok = {}
    t0 = time.perf_counter()
    out = col.allreduce(x, group_name="smoke")
    ok["allreduce"] = bool(out.is_cuda and torch.equal(out, x))
    outs = col.allgather(x, group_name="smoke")
    ok["allgather"] = bool(len(outs) == 1 and outs[0].is_cuda
                           and torch.equal(outs[0], x))
    out = col.broadcast(x, src_rank=0, group_name="smoke")
    ok["broadcast"] = bool(out.is_cuda and torch.equal(out, x))
    out = col.reducescatter(x, group_name="smoke")
    ok["reducescatter"] = bool(out.is_cuda and torch.equal(out, x))
    col.barrier(group_name="smoke")
    ok["barrier"] = True
    ops_s = time.perf_counter() - t0
    col.destroy_collective_group("smoke")
    return dict(ok=ok, init_s=init_s, ops_s=ops_s)


def phase_data(card: str):
    """The Data library on the cluster runtime: (a) flagship float32 batch
    inference through `map_batches(FlagshipScorer, compute="actors",
    concurrency=2, num_gpus=0.5)` against an in-process forward of the same
    blocks; (b) bench.py's train step fed by `iter_torch_batches` of a
    `random_shuffle`d Dataset in a `TorchTrainer` worker leasing the card,
    against the same steps in-process on the same batches in the same
    order; (c) the worker's NCCL collectives. Returns the K1 launches in
    the pool's replicas and the K1, K2, K3 launches a step in the train
    worker."""
    import gc as _gc
    import tempfile
    import threading
    from dataclasses import replace

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data, train
    from ray_tpu_torch.models import forward, lm_loss
    from ray_tpu_torch.parallel import adamw, make_train_step

    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=CLUSTER_CPUS)
    init_s = time.perf_counter() - t0
    res = ray_tpu_torch.cluster_resources()
    check(res.get("GPU") == 1.0, f"the node did not detect one GPU: {res}")
    try:
        # (a) batch inference: the in-process forward first.
        tokens = data_tokens(DATA_SEQS, DATA_SEQ_LEN, seed=5)
        per_block = DATA_SEQS // DATA_BLOCKS
        params, cfg = flagship_params()
        checksum = param_checksum(params)
        f32 = replace(cfg, dtype=torch.float32)
        want, fwd_ms = [], []
        with torch.no_grad():
            for i in range(DATA_BLOCKS):
                blk = torch.from_numpy(
                    tokens[i * per_block:(i + 1) * per_block]).cuda()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                logits, _ = forward(params, blk, f32)
                want.append(logits.mean(dim=(1, 2)).cpu().numpy())
                fwd_ms.append((time.perf_counter() - t1) * 1e3)
                del logits
        want = np.concatenate(want)
        del params
        _gc.collect()
        torch.cuda.empty_cache()
        ds = data.from_numpy({"tokens": tokens}, parallelism=DATA_BLOCKS)
        scored = ds.map_batches(FlagshipScorer, compute="actors",
                                concurrency=DATA_REPLICAS,
                                num_gpus=DATA_GPU_SHARE)
        t1 = time.perf_counter()
        blocks = list(scored.iter_blocks())
        pool_s = time.perf_counter() - t1
        got = np.concatenate([b["score"] for b in blocks])
        pids = sorted(set(int(p) for b in blocks for p in b["pid"]))
        k1 = [int(b["k1"][0]) for b in blocks]
        k2k3 = sum(int(b["k2k3"][0]) for b in blocks)
        stats = scored.stats()
        replicas = sorted(o.name for o in stats.operators
                          if o.name.startswith("actor_pool_map[replica="))
        t1 = time.perf_counter()
        alive = [p for p in pids if proc_alive(p)]
        while alive and time.perf_counter() - t1 < CLUSTER_DOWN_S:
            time.sleep(0.1)
            alive = [p for p in pids if proc_alive(p)]
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        steady = [float(b["ms"][0]) for b in blocks]
        n_tok = DATA_SEQS * DATA_SEQ_LEN
        print(f"data pool flagship f32 [{per_block}, {DATA_SEQ_LEN}] x "
              f"{DATA_BLOCKS} blocks: map_batches(FlagshipScorer, "
              f"compute=actors, concurrency={DATA_REPLICAS}, num_gpus="
              f"{DATA_GPU_SHARE}) on the cluster (init {init_s:.3f} s); "
              f"replica pids {pids}, CUDA_VISIBLE_DEVICES "
              f"{sorted(set(int(b['visible'][0]) for b in blocks))}, "
              f"build s {sorted(set(round(float(b['build_s'][0]), 3)
                                    for b in blocks))}; "
              f"{pool_s:.3f} s through the pool: "
              f"{DATA_SEQS / pool_s:.2f} sequences/s, "
              f"{n_tok / pool_s:.1f} tokens/s (replica startup included); "
              f"a block's forward in a replica median "
              f"{sorted(steady)[len(steady) // 2]:.2f} ms; in-process "
              f"forward {sum(fwd_ms):.2f} ms for all blocks: "
              f"{DATA_SEQS / sum(fwd_ms) * 1e3:.2f} sequences/s, "
              f"{n_tok / sum(fwd_ms) * 1e3:.1f} tokens/s (first block "
              f"{fwd_ms[0]:.2f} ms); scores vs in-process max abs diff "
              f"{err:.3e} (scale {scale:.4f}, gate {DATA_SCORE_RTOL} "
              f"relative); K1 launches in the replicas {sum(k1)} "
              f"(per block {sorted(set(k1))}), K2+K3 {k2k3}; stats "
              f"{replicas}; replicas alive after the stage {alive} "
              f"[{card}]", flush=True)
        check(err <= DATA_SCORE_RTOL * scale, f"the pool's scores differ "
              f"from the in-process forward by {err:.3e} (scale {scale})")
        layers = FLAGSHIP["n_layers"]
        check(sum(k1) == layers * DATA_BLOCKS and set(k1) == {layers},
              f"the replicas launched K1 {k1} times per block, expected "
              f"{layers} each ({layers * DATA_BLOCKS} in all)")
        check(k2k3 == 0, "a replica's forward launched K2 or K3")
        check(len(pids) == DATA_REPLICAS and len(replicas) == DATA_REPLICAS,
              f"expected {DATA_REPLICAS} replicas and their stats entries: "
              f"pids {pids}, stats {replicas}")
        check(not alive, f"the pool's replicas outlived the stage by "
              f"{CLUSTER_DOWN_S} s: {alive}")

        # (b) ingest into TorchTrainer from a shuffled Dataset.
        rows = DATA_TRAIN_BATCHES * TRAIN_BATCH
        ds = data.from_numpy(
            {"tokens": data_tokens(rows, TRAIN_SEQ + 1, seed=6)},
            parallelism=DATA_TRAIN_BLOCKS).random_shuffle(seed=0)
        host = [b["tokens"] for b in ds.iter_batches(
            batch_size=TRAIN_BATCH, drop_last=True)]
        check(len(host) == DATA_TRAIN_BATCHES, f"the shuffled Dataset gave "
              f"{len(host)} batches of {TRAIN_BATCH}")
        params, cfg = flagship_params()
        tcfg = replace(cfg, remat=True, remat_policy="save_attn_qkv")
        optimizer = adamw(1e-4)
        opt_state = optimizer.init(params)
        step = make_train_step(lambda p, b: lm_loss(p, b, tcfg), optimizer)
        ref_losses, ref_ms = [], []
        for b in host:
            batch = {"tokens": torch.from_numpy(np.array(b)).cuda()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, batch)
            ref_losses.append(loss.item())
            ref_ms.append((time.perf_counter() - t1) * 1e3)
        del params, opt_state, step, batch, loss
        _gc.collect()
        torch.cuda.empty_cache()
        storage = tempfile.mkdtemp(prefix="chip_smoke_data_")
        run = "data_train"
        trainer = train.TorchTrainer(
            data_train_loop, train_loop_config={"checksum": checksum},
            torch_config=train.TorchConfig(),
            scaling_config=train.ScalingConfig(
                num_workers=1, use_gpu=True, gpus_per_worker=1),
            run_config=train.RunConfig(name=run, storage_path=storage),
            datasets={"train": ds})
        out = {}

        def fit():
            try:
                out["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001
                out["error"] = e

        t1 = time.perf_counter()
        thread = threading.Thread(target=fit, daemon=True)
        thread.start()
        thread.join(DATA_TIMEOUT_S)
        fit_s = time.perf_counter() - t1
        check(not thread.is_alive(), f"TorchTrainer.fit did not end within "
              f"{DATA_TIMEOUT_S} s")
        if "error" in out:
            raise PhaseError(f"TorchTrainer.fit failed: {out['error']!r}")
        result = out["result"]
        lines = result_lines(os.path.join(storage, run))
    finally:
        ray_tpu_torch.shutdown()
    t0 = time.perf_counter()
    left = port_processes()
    while left and time.perf_counter() - t0 < CLUSTER_DOWN_S:
        time.sleep(0.1)
        left = port_processes()
    check(not left, f"port processes outlived shutdown by "
          f"{CLUSTER_DOWN_S} s: {left}")
    if result.error is not None:
        raise PhaseError(f"the data train loop failed: {result.error!r}")
    history = result.metrics_history
    losses = [m["loss"] for m in history]
    counts = sorted(set((m["k1"], m["k2"], m["k3"]) for m in history))
    waits = [ln["_telemetry"]["data_wait_s"] for ln in lines
             if "_telemetry" in ln]
    colls = [ln["_telemetry"]["collective_s"] for ln in lines
             if "_telemetry" in ln]
    coll = history[0]["coll"] if history else None
    step_ms = sorted(m["step_ms"] for m in history[1:])
    diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    first = history[0] if history else {}
    print(f"data train flagship bf16 remat save_attn_qkv AdamW 1e-4: "
          f"TorchTrainer(datasets={{'train': from_numpy({rows} x "
          f"{TRAIN_SEQ + 1} tokens, {DATA_TRAIN_BLOCKS} blocks)"
          f".random_shuffle(seed=0)}}), 1 worker leasing the card "
          f"(CUDA_VISIBLE_DEVICES={first.get('visible')}, "
          f"{first.get('backend')} world {first.get('world')}), "
          f"iter_torch_batches(batch_size={TRAIN_BATCH}, drop_last=True) "
          f"on {first.get('device')} {first.get('shape')}; fit "
          f"{fit_s:.3f} s; {len(history)} steps, step_ms median "
          f"{step_ms[len(step_ms) // 2] if step_ms else float('nan'):.2f} "
          f"after the first (in-process "
          f"{sorted(ref_ms[1:])[len(ref_ms[1:]) // 2]:.2f}); data_wait ms "
          f"a step {' '.join(f'{w * 1e3:.3f}' for w in waits)}; launches "
          f"a step K1 K2 K3 {counts}; losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; against the "
          f"in-process steps on the same batches: largest difference "
          f"{max(diffs) if diffs else float('nan'):.3e} (gate: bitwise "
          f"equal); shutdown left {len(left)} port processes [{card}]",
          flush=True)
    print(f"data collective nccl world 1 in the train worker: "
          f"{json.dumps(coll)}; the step's collective telemetry s "
          f"{' '.join(f'{c:.6f}' for c in colls)} [{card}]", flush=True)
    check(len(history) == DATA_TRAIN_BATCHES, f"the data train loop ran "
          f"{len(history)} steps, expected {DATA_TRAIN_BATCHES}")
    check(first.get("checksum_equal") and first.get("visible") == "0"
          and first.get("backend") == "nccl" and first.get("world") == 1,
          f"the data train worker does not hold the card over NCCL with "
          f"the driver's weights: {first}")
    check(losses == ref_losses, f"the Dataset-fed worker's losses differ "
          f"from the in-process steps' by up to {max(diffs):.3e}")
    layers = FLAGSHIP["n_layers"]
    check(counts == [(layers,) * 3], f"the data train worker launched K1, "
          f"K2, K3 {counts} times a step, expected {layers} each")
    check(len(waits) == DATA_TRAIN_BATCHES and all(w > 0 for w in waits),
          f"the steps' data_wait telemetry is missing: {waits}")
    check(coll is not None and all(coll["ok"].values()),
          f"an NCCL collective did not give its input back: {coll}")
    check(colls and colls[0] >= coll["ops_s"] * 0.5,
          f"the collectives' {coll['ops_s'] if coll else None} s did not "
          f"land in the first step's collective telemetry {colls}")
    return sum(k1), counts[0]


# The compiled-graph phase: the float32 flagship forward split over two
# GPU-leased actors (embedding and layers 0-5; layers 6-11, the final norm
# and the tied-embedding logits), the hidden edge a CUDA tensor over an
# "array" channel.
CGRAPH_BATCHES, CGRAPH_BATCH, CGRAPH_SEQ = 24, 4, 512
CGRAPH_SPLIT = 6
CGRAPH_IN_FLIGHT = 4
CGRAPH_GPU_SHARE = 0.5
CGRAPH_SERVE_GPU_SHARE = 0.25
CGRAPH_SERVE_BATCHES = 8
# The error fan-out's window: batch 2 of it holds the id vocab_size.
CGRAPH_FANOUT, CGRAPH_BAD = 8, 3
CGRAPH_RESTART_BATCHES = 8
CGRAPH_TIMEOUT_S = 600.0
CGRAPH_RESTART_S = 240.0


class FlagshipStage:
    """One half of the float32 flagship in a worker leasing half the card.
    It makes the flagship weights from chip_smoke's seed on the card its
    lease shows it (their checksum must equal the driver's), keeps its
    half and frees the rest. Each call counts the K1 launches it makes in
    this process. The compiled loop calls the methods on its own thread,
    so each sets `no_grad` itself."""

    def __init__(self, checksum, half: str):
        self.init_s = time.time()
        from dataclasses import replace

        import torch

        self.start_s = proc_start_time()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params, cfg = flagship_params()
        self.checksum_equal = param_checksum(params) == checksum
        self.cfg = replace(cfg, dtype=torch.float32)
        self.embed = params["embed"]
        layers = params["layers"]
        self.layers = (layers[:CGRAPH_SPLIT] if half == "head"
                       else layers[CGRAPH_SPLIT:])
        self.ln_f = params["ln_f"]
        del params, layers
        gc.collect()
        torch.cuda.empty_cache()
        self.ready_s = time.time()
        self.build_s = self.ready_s - self.init_s
        self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        self.k1 = 0
        self.arrived = []

    def info(self) -> dict:
        return dict(pid=os.getpid(), visible=self.visible,
                    checksum_equal=self.checksum_equal, k1=self.k1,
                    start_s=self.start_s, init_s=self.init_s,
                    ready_s=self.ready_s, build_s=self.build_s,
                    arrived=sorted(set(self.arrived)))

    def reset(self) -> bool:
        self.k1 = 0
        self.arrived = []
        return True

    def _layers(self, x):
        from ray_tpu_torch.models.transformer import _layers

        before = _counts()[0]
        x, _ = _layers(x, self.layers, self.cfg, None)
        self.k1 += _counts()[0] - before
        return x


class FlagshipHead(FlagshipStage):
    def __init__(self, checksum):
        super().__init__(checksum, "head")

    def hidden(self, tokens):
        """tokens [B, S] (numpy) -> the hidden states after layer 5, [B,
        S, D] float32 on the card. Ids outside the vocabulary raise here
        on the host, as `forward` raises them."""
        import numpy as np
        import torch

        from ray_tpu_torch.models.transformer import _check_ids, _embed

        with torch.no_grad():
            t = _check_ids(torch.from_numpy(np.array(tokens, np.int64)),
                           self.cfg).cuda()
            return self._layers(_embed(self.embed, t, self.cfg))

    def __call__(self, tokens):
        """The Serve chain's head: the hidden states and the tokens, which
        the tail scores against."""
        return self.hidden(tokens), tokens


class FlagshipTail(FlagshipStage):
    def __init__(self, checksum):
        super().__init__(checksum, "tail")

    def score(self, hidden, tokens):
        """hidden [B, S, D] from the head, tokens [B, S] -> (each position's
        log-probability of the next token [B, S-1], the last position's
        logits [B, V]), float32 on the card."""
        import torch

        from ray_tpu_torch.models.transformer import _rmsnorm

        self.arrived.append(f"{type(hidden).__name__} on "
                            f"{getattr(hidden, 'device', None)}")
        with torch.no_grad():
            x = _rmsnorm(self._layers(hidden), self.ln_f)
            logits = torch.einsum("bsd,vd->bsv", x,
                                  self.embed.to(self.cfg.dtype))
            return next_token_scores(logits, tokens)

    def __call__(self, pair):
        hidden, tokens = pair
        return self.score(hidden, tokens)


def next_token_scores(logits, tokens):
    """(log-probability of each next token [B, S-1], last logits [B, V])
    of [B, S, V] logits."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.array(tokens, np.int64)).to(logits.device)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return (logp.gather(-1, t[:, 1:, None])[..., 0].contiguous(),
            logits[:, -1].contiguous())


def cgraph_tokens(seed: int):
    """CGRAPH_BATCHES batches of [CGRAPH_BATCH, CGRAPH_SEQ] token ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, FLAGSHIP["vocab_size"],
                         (CGRAPH_BATCH, CGRAPH_SEQ), dtype=np.int64)
            for _ in range(CGRAPH_BATCHES)]


def wf_tokens(seed):
    """Workflow step 1 (host): a batch of token ids."""
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, FLAGSHIP["vocab_size"], (CGRAPH_BATCH, CGRAPH_SEQ),
        dtype=np.int64)


def wf_histogram(tokens, flag):
    """Workflow step 2 (host): the ids' counts in 16 bins of the
    vocabulary; its first attempt fails (it leaves `flag` behind)."""
    import numpy as np

    if not os.path.exists(flag):
        open(flag, "w").close()
        raise RuntimeError("first attempt fails by design")
    return np.bincount(np.asarray(tokens).ravel()
                       // (FLAGSHIP["vocab_size"] // 16), minlength=16)


def wf_summary(counts):
    """Workflow step 3 (host)."""
    return {"total": int(sum(counts)), "bins": [int(c) for c in counts]}


def same_scores(a, b) -> bool:
    """Both parts of two (log-probabilities, last logits) pairs bitwise
    equal."""
    import torch

    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x.to(y.device), y) for x, y in zip(a, b))


def phase_cgraph(card: str):
    """The lazy DAG and compiled graphs on the cluster runtime: the
    float32 flagship forward as a two-stage pipeline of GPU-leased actors
    (`FlagshipHead`, `FlagshipTail`, 0.5 of the card each), the hidden
    edge `.with_channel("array")` (a CUDA tensor, re-landed on the tail's
    card). 24 batches of [4, 512] in-process, lazily (`dag.execute`) and
    compiled (`experimental_compile(max_in_flight=4)`), each output
    bitwise the in-process forward's; an error fan-out; a SIGKILL of the
    tail and the graph's restart; the same halves as a compiled Serve
    deployment chain; a durable workflow with a failed step and its
    resume; teardown. Returns the K1 launches in each stage process of
    the compiled run."""
    import signal
    import tempfile
    import threading
    from dataclasses import replace

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve, workflow
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import forward

    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    batches = cgraph_tokens(seed=7)
    n_seq = CGRAPH_BATCHES * CGRAPH_BATCH
    params, cfg = flagship_params()
    checksum = param_checksum(params)
    f32 = replace(cfg, dtype=torch.float32)
    want, inproc_ms = [], []
    with torch.no_grad():
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = forward(params, b, f32)
            want.append(next_token_scores(logits, b))
            torch.cuda.synchronize()
            inproc_ms.append((time.perf_counter() - t0) * 1e3)
            del logits
    del params
    gc.collect()
    torch.cuda.empty_cache()
    inproc_total = sum(inproc_ms[1:]) / (len(inproc_ms) - 1) * len(batches)
    free_before = torch.cuda.mem_get_info()[0]

    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=CLUSTER_CPUS)
    init_s = time.perf_counter() - t0
    storage = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    pids, stage_info = [], {}
    try:
        check(ray_tpu_torch.cluster_resources().get("GPU") == 1.0,
              "the node did not detect one GPU")
        opts = dict(num_gpus=CGRAPH_GPU_SHARE, max_restarts=1,
                    max_task_retries=1)
        head = ray_tpu_torch.remote(**opts)(FlagshipHead).remote(checksum)
        tail = ray_tpu_torch.remote(**opts)(FlagshipTail).remote(checksum)
        t0 = time.perf_counter()
        stage_info = dict(zip(("head", "tail"), ray_tpu_torch.get(
            [head.info.remote(), tail.info.remote()],
            timeout=CGRAPH_TIMEOUT_S)))
        stages_s = time.perf_counter() - t0
        pids = [i["pid"] for i in stage_info.values()]
        free_up = torch.cuda.mem_get_info()[0]
        check(all(i["checksum_equal"] and i["visible"] == "0"
                  for i in stage_info.values()),
              f"a stage does not hold the card with the driver's weights: "
              f"{stage_info}")
        with InputNode() as inp:
            dag = tail.score.bind(head.hidden.bind(inp).with_channel("array"),
                                  inp)

        def launches():
            return ray_tpu_torch.get(
                [head.info.remote(), tail.info.remote()], timeout=60)

        def reset():
            ray_tpu_torch.get([head.reset.remote(), tail.reset.remote()],
                              timeout=60)

        # 2. lazy: two actor tasks a batch, the hidden state through the
        # object store.
        ray_tpu_torch.get(dag.execute(batches[0]), timeout=CGRAPH_TIMEOUT_S)
        reset()
        t0 = time.perf_counter()
        refs = [dag.execute(b) for b in batches]
        lazy = ray_tpu_torch.get(refs, timeout=CGRAPH_TIMEOUT_S)
        lazy_s = time.perf_counter() - t0
        lazy_info = launches()
        del refs

        # 3. compiled, after one warm-up execution.
        compiled = dag.experimental_compile(max_in_flight=CGRAPH_IN_FLIGHT)
        ray_tpu_torch.get(compiled.execute(batches[0]),
                          timeout=CGRAPH_TIMEOUT_S)
        reset()
        t0 = time.perf_counter()
        crefs = [compiled.execute(b) for b in batches]
        got = [ray_tpu_torch.get(r, timeout=CGRAPH_TIMEOUT_S) for r in crefs]
        compiled_s = time.perf_counter() - t0
        compiled_info = launches()
        del crefs

        lazy_bitwise = [same_scores(g, w) for g, w in zip(lazy, want)]
        compiled_bitwise = [same_scores(g, w) for g, w in zip(got, want)]
        lazy_ms = lazy_s / len(batches) * 1e3
        compiled_ms = compiled_s / len(batches) * 1e3
        inproc_batch_ms = inproc_total / len(batches)
        k1 = {name: (lazy_info[i]["k1"], compiled_info[i]["k1"])
              for i, name in enumerate(("head", "tail"))}
        print(f"cgraph flagship f32 two-stage pipeline [{CGRAPH_BATCH}, "
              f"{CGRAPH_SEQ}] x {CGRAPH_BATCHES} batches: head (embedding, "
              f"layers 0-{CGRAPH_SPLIT - 1}) and tail (layers "
              f"{CGRAPH_SPLIT}-{FLAGSHIP['n_layers'] - 1}, norm, logits) "
              f"as actors leasing {CGRAPH_GPU_SHARE} GPU each (pids "
              f"{pids}, CUDA_VISIBLE_DEVICES "
              f"{[i['visible'] for i in stage_info.values()]}, build s "
              f"{[round(i['build_s'], 3) for i in stage_info.values()]}, "
              f"both up {stages_s:.3f} s after init {init_s:.3f} s); "
              f"hidden edge [{CGRAPH_BATCH}, {CGRAPH_SEQ}, "
              f"{FLAGSHIP['d_model']}] f32 "
              f"{CGRAPH_BATCH * CGRAPH_SEQ * FLAGSHIP['d_model'] * 4} B an "
              f"execution over an array channel; in-process "
              f"{inproc_batch_ms:.2f} ms a batch "
              f"({CGRAPH_BATCH / inproc_batch_ms * 1e3:.2f} sequences/s; "
              f"first {inproc_ms[0]:.2f} ms); lazy dag.execute "
              f"{lazy_ms:.2f} ms a batch ({n_seq / lazy_s:.2f} "
              f"sequences/s); compiled max_in_flight={CGRAPH_IN_FLIGHT} "
              f"{compiled_ms:.2f} ms a batch ({n_seq / compiled_s:.2f} "
              f"sequences/s): compiled over lazy "
              f"{lazy_ms / compiled_ms:.3f}x, compiled over in-process "
              f"{inproc_batch_ms / compiled_ms:.3f}x; bitwise the "
              f"in-process forward: lazy {sum(lazy_bitwise)}/"
              f"{len(batches)}, compiled {sum(compiled_bitwise)}/"
              f"{len(batches)}; K1 launches (lazy, compiled) {k1}; the "
              f"tail received {compiled_info[1]['arrived']} (lazy "
              f"{lazy_info[1]['arrived']}) [{card}]", flush=True)
        check(all(lazy_bitwise), f"lazy outputs differ from the in-process "
              f"forward: {lazy_bitwise}")
        check(all(compiled_bitwise), f"compiled outputs differ from the "
              f"in-process forward: {compiled_bitwise}")
        per_stage = CGRAPH_SPLIT * CGRAPH_BATCHES
        check(all(v == (per_stage, per_stage) for v in k1.values()),
              f"K1 ran {k1} times in the stages (lazy, compiled), expected "
              f"{per_stage} each ({CGRAPH_SPLIT} a batch)")
        check(compiled_info[1]["arrived"] == ["Tensor on cuda:0"]
              and lazy_info[1]["arrived"] == ["Tensor on cuda:0"],
              f"the hidden state did not arrive in the tail as a CUDA "
              f"tensor: {compiled_info[1]['arrived']}, "
              f"{lazy_info[1]['arrived']}")

        # Error fan-out: one batch in the window holds an id past the
        # vocabulary; only its execution raises.
        window = list(batches[:CGRAPH_FANOUT])
        bad = window[CGRAPH_BAD].copy()
        bad[1, 7] = FLAGSHIP["vocab_size"]
        window[CGRAPH_BAD] = bad
        frefs = [compiled.execute(b) for b in window]
        outcome = []
        for i, r in enumerate(frefs):
            try:
                outcome.append(same_scores(ray_tpu_torch.get(
                    r, timeout=CGRAPH_TIMEOUT_S), want[i]))
            except ValueError as e:
                outcome.append(str(e).splitlines()[-1])
        print(f"cgraph error fan-out: {CGRAPH_FANOUT} executions, #"
              f"{CGRAPH_BAD} holds id {FLAGSHIP['vocab_size']}: {outcome} "
              f"[{card}]", flush=True)
        check(all(o is True for i, o in enumerate(outcome)
                  if i != CGRAPH_BAD)
              and isinstance(outcome[CGRAPH_BAD], str)
              and "token ids must lie" in outcome[CGRAPH_BAD],
              f"the error fan-out did not fail exactly its bad execution: "
              f"{outcome}")

        # Restart: SIGKILL the tail with a window in flight.
        old_tail = stage_info["tail"]["pid"]
        krefs = [compiled.execute(b) for b in batches[:CGRAPH_IN_FLIGHT]]
        t_kill = time.time()
        os.kill(old_tail, signal.SIGKILL)
        failed, detect_t = 0, None
        for r in krefs:
            try:
                ray_tpu_torch.get(r, timeout=60)
            except Exception:  # noqa: BLE001
                failed += 1
                detect_t = detect_t or time.time()
        recovered_t, attempts, after = None, 0, []
        deadline = time.time() + CGRAPH_RESTART_S
        while recovered_t is None and time.time() < deadline:
            attempts += 1
            try:
                r = compiled.execute(batches[0])
                out = ray_tpu_torch.get(r, timeout=60)
                recovered_t = time.time()
                after.append(same_scores(out, want[0]))
            except Exception:  # noqa: BLE001
                detect_t = detect_t or time.time()
                time.sleep(0.2)
        check(recovered_t is not None, "the compiled graph never recovered "
              "from the tail's SIGKILL")
        rrefs = [compiled.execute(b)
                 for b in batches[1:CGRAPH_RESTART_BATCHES]]
        after += [same_scores(ray_tpu_torch.get(r, timeout=CGRAPH_TIMEOUT_S),
                              w)
                  for r, w in zip(rrefs, want[1:CGRAPH_RESTART_BATCHES])]
        new_tail = ray_tpu_torch.get(tail.info.remote(), timeout=60)
        detect_t = detect_t or recovered_t
        print(f"cgraph restart: SIGKILL of the tail (pid {old_tail}) with "
              f"{CGRAPH_IN_FLIGHT} executions in flight, {failed} of them "
              f"failed; recovered in {recovered_t - t_kill:.3f} s after "
              f"{attempts} execute(s): detection "
              f"{detect_t - t_kill:.3f} s; the tail's restart "
              f"{new_tail['ready_s'] - detect_t:.3f} s (to its __init__ in "
              f"pid {new_tail['pid']}, a process started "
              f"{new_tail['start_s'] - t_kill:+.3f} s from the kill: "
              f"{new_tail['init_s'] - detect_t:.3f} s; imports and weights "
              f"{new_tail['build_s']:.3f} s); recompile and first execution "
              f"{recovered_t - new_tail['ready_s']:.3f} s; "
              f"{sum(after)}/{len(after)} later outputs bitwise "
              f"[{card}]", flush=True)
        check(all(after) and len(after) == CGRAPH_RESTART_BATCHES,
              f"outputs after the restart differ: {after}")
        check(new_tail["pid"] != old_tail and new_tail["checksum_equal"],
              f"the restarted tail is not a new process with the driver's "
              f"weights: {new_tail}")
        pids.append(new_tail["pid"])

        compiled.teardown()
        loops = [t.name for t in threading.enumerate()
                 if t.name.startswith("cgraph-loop")]
        stage_loops = [ray_tpu_torch.get(s.__ray_call__.remote(
            cgraph_live_loops), timeout=60) for s in (head, tail)]
        free_stages = torch.cuda.mem_get_info()[0]
        ray_tpu_torch.kill(head)
        ray_tpu_torch.kill(tail)
        t0 = time.perf_counter()
        alive = [p for p in pids if proc_alive(p)]
        while alive and time.perf_counter() - t0 < CLUSTER_DOWN_S:
            time.sleep(0.1)
            alive = [p for p in pids if proc_alive(p)]
        # CUDA returns a dead process's card memory a moment after
        # its exit: read until it stops rising.
        free_after = torch.cuda.mem_get_info()[0]
        while time.perf_counter() - t0 < CLUSTER_DOWN_S:
            time.sleep(0.5)
            now = torch.cuda.mem_get_info()[0]
            if now <= free_after:
                break
            free_after = now
        print(f"cgraph teardown: loop threads in the driver {loops}, in "
              f"the stages {stage_loops}; stage processes alive "
              f"{CLUSTER_DOWN_S} s after kill {alive}; card memory free "
              f"{free_before} B before the stages, {free_up} B once they "
              f"were up, {free_stages} B before the kill, {free_after} B "
              f"after: {free_after - free_stages} B freed [{card}]",
              flush=True)
        check(not loops and stage_loops == [0, 0], f"loop threads left: "
              f"driver {loops}, stages {stage_loops}")
        check(not alive, f"stage processes outlived teardown: {alive}")

        # The Serve chain: the same halves as deployments, compiled.
        serve.start(serve.HTTPOptions(host="127.0.0.1", port=0))
        try:
            actor_opts = {"num_gpus": CGRAPH_SERVE_GPU_SHARE}
            t0 = time.perf_counter()
            serve.run(serve.deployment(
                FlagshipHead, ray_actor_options=actor_opts).bind(checksum),
                name="cgraph_head", route_prefix="/cgraph_head")
            serve.run(serve.deployment(
                FlagshipTail, ray_actor_options=actor_opts).bind(checksum),
                name="cgraph_tail", route_prefix="/cgraph_tail")
            deploy_s = time.perf_counter() - t0
            chain = serve.compile_deployment_chain(
                ["FlagshipHead", "FlagshipTail"],
                max_in_flight=CGRAPH_IN_FLIGHT)
            try:
                ray_tpu_torch.get(chain.execute(batches[0]),
                                  timeout=CGRAPH_TIMEOUT_S)
                t0 = time.perf_counter()
                srefs = [chain.execute(b)
                         for b in batches[:CGRAPH_SERVE_BATCHES]]
                sgot = [ray_tpu_torch.get(r, timeout=CGRAPH_TIMEOUT_S)
                        for r in srefs]
                chain_s = time.perf_counter() - t0
            finally:
                chain.teardown()
            serve_bitwise = [same_scores(g, w) for g, w in
                             zip(sgot, want[:CGRAPH_SERVE_BATCHES])]
        finally:
            serve.shutdown()
        print(f"cgraph serve chain: FlagshipHead -> FlagshipTail as "
              f"deployments leasing {CGRAPH_SERVE_GPU_SHARE} GPU each "
              f"(deployed {deploy_s:.3f} s), compile_deployment_chain, "
              f"{CGRAPH_SERVE_BATCHES} batches {chain_s:.3f} s "
              f"({chain_s / CGRAPH_SERVE_BATCHES * 1e3:.2f} ms a batch): "
              f"{sum(serve_bitwise)}/{len(serve_bitwise)} bitwise [{card}]",
              flush=True)
        check(all(serve_bitwise), f"the Serve chain's outputs differ: "
              f"{serve_bitwise}")

        # A durable workflow on the host: a failed step, then resume.
        os.environ["RAY_TPU_WORKFLOW_STORAGE"] = storage
        flag = os.path.join(storage, "attempted")
        rf = ray_tpu_torch.remote
        wdag = rf(wf_summary).bind(rf(wf_histogram).bind(
            rf(wf_tokens).bind(11), flag))
        try:
            workflow.run(wdag, workflow_id="smoke")
            first = "ran"
        except RuntimeError as e:
            first = str(e).splitlines()[-1]
        failed_status = workflow.get_status("smoke")
        value = workflow.resume("smoke")
        status = workflow.get_status("smoke")
        print(f"cgraph workflow: first run {first!r}, status "
              f"{failed_status['status']} (ran "
              f"{failed_status['steps_ran']}); resume -> {value['total']} "
              f"ids, status {status['status']}, loaded "
              f"{status['steps_loaded']}, ran {status['steps_ran']}; "
              f"cloudpickle importable here: "
              f"{importable('cloudpickle')} [{card}]", flush=True)
        check(failed_status["status"] == "FAILED"
              and status["status"] == "SUCCEEDED"
              and [s.split("-")[0] for s in status["steps_loaded"]]
              == ["wf_tokens"]
              and [s.split("-")[0] for s in status["steps_ran"]]
              == ["wf_histogram", "wf_summary"]
              and value["total"] == CGRAPH_BATCH * CGRAPH_SEQ,
              f"the workflow did not fail once and resume from its first "
              f"step's checkpoint: {failed_status}, {status}, {value}")
    finally:
        ray_tpu_torch.shutdown()
        import shutil

        shutil.rmtree(storage, ignore_errors=True)
        os.environ.pop("RAY_TPU_WORKFLOW_STORAGE", None)
    t0 = time.perf_counter()
    left = port_processes()
    while left and time.perf_counter() - t0 < CLUSTER_DOWN_S:
        time.sleep(0.1)
        left = port_processes()
    print(f"cgraph shutdown: {len(left)} port processes left [{card}]",
          flush=True)
    check(not left, f"port processes outlived shutdown by "
          f"{CLUSTER_DOWN_S} s: {left}")
    return {name: v[1] for name, v in k1.items()}


def cgraph_live_loops(instance):
    """`__ray_call__` body: compiled-graph loop threads alive in the
    actor's process."""
    from ray_tpu_torch.cgraph.loop import _live_loop_count

    return _live_loop_count()


# ---------------------------------------------------------------------------
# RLlib: PPO and IMPALA/APPO with their learners on the card
# ---------------------------------------------------------------------------
# The RLlib phase's cluster: two env-runner actors (one CPU each), the
# remote learner's one, and a spare; or DQN's and multi-agent PPO's four
# runners.
RLLIB_CPUS = 4
RLLIB_TIMEOUT_S = 300.0
# A learner update on the card against the same update on the CPU, from
# the same weights and batch (float32 both, TF32 off). The forward's
# statistics differ by summation order only. The weights move by Adam
# steps, lr * m / (sqrt(v) + eps): at the first step about +-lr for every
# element, so an element whose gradient lies within the two devices'
# rounding of zero may step the other way. Such elements are a share of
# the order of the gradients' relative error (some 1e-6), so the update's
# relative L2 distance (after - before on each side) stays far below
# this bound, where a wrong gradient moves it to O(1). PPO's statistics
# are its last minibatch's, after 15 such steps on each side.
RLLIB_STATS_RTOL = 1e-3
RLLIB_UPDATE_REL_L2 = 1e-2


class CartPoleFixture:
    """CartPole's dynamics and shapes in numpy (4 floats observed, 2
    actions; the classic Barto, Sutton and Anderson cart-pole, as
    gymnasium's CartPole-v1 steps it, with its 500-step time limit): a
    fixture of this script, since the card's machine has no gymnasium."""

    class _Box:
        shape = (4,)
        dtype = "float32"

    class _Discrete:
        n = 2

    observation_space = _Box()
    action_space = _Discrete()
    MAX_STEPS = 500

    def __init__(self):
        import numpy as np

        self._rng = np.random.default_rng()
        self._state = None
        self._steps = 0

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, 4)
        self._steps = 0
        return self._state.astype(np.float32), {}

    def step(self, action: int):
        import math

        import numpy as np

        x, x_dot, theta, theta_dot = self._state
        force = 10.0 if action == 1 else -10.0
        cos, sin = math.cos(theta), math.sin(theta)
        total_mass, pole_mass_length, length = 1.1, 0.05, 0.5
        temp = (force + pole_mass_length * theta_dot ** 2 * sin) / total_mass
        theta_acc = (9.8 * sin - cos * temp) / (
            length * (4.0 / 3.0 - 0.1 * cos ** 2 / total_mass))
        x_acc = temp - pole_mass_length * theta_acc * cos / total_mass
        tau = 0.02
        x, x_dot = x + tau * x_dot, x_dot + tau * x_acc
        theta, theta_dot = theta + tau * theta_dot, theta_dot + tau * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(abs(x) > 2.4 or abs(theta) > 12 * 2 * math.pi / 360)
        truncated = self._steps >= self.MAX_STEPS and not terminated
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})

    def close(self) -> None:
        pass


def remote_learner_lease() -> dict:
    """Run in the remote learner's worker: where its learner lives."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.rllib.core import learner_group

    device = learner_group._LEARNER.device
    return dict(device=str(device), pid=os.getpid(),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                backend=dist.get_backend(), world=dist.get_world_size(),
                name=(torch.cuda.get_device_name(device)
                      if device.type == "cuda" else None),
                params_on=sorted({str(p.device) for p in
                                  learner_group._LEARNER.module.parameters()}))


def update_distance(before: dict, after: dict, ref_after: dict) -> float:
    """The largest relative L2 distance, over the parameters, between two
    updates of the same weights: (after - before) against
    (ref_after - before)."""
    import numpy as np

    worst = 0.0
    for k in before:
        want = ref_after[k].astype(np.float64) - before[k]
        got = after[k].astype(np.float64) - before[k]
        worst = max(worst, float(np.linalg.norm(got - want)
                                 / max(np.linalg.norm(want), 1e-30)))
    return worst


def hold_update(label: str, card: str, before, batch, after, stats,
                cpu_learner) -> None:
    """The card's update against `cpu_learner`'s of the same weights and
    batch; prints and gates both."""
    import numpy as np

    cpu_learner.set_weights(before)
    t0 = time.perf_counter()
    cpu_stats = cpu_learner.update(batch)
    cpu_s = time.perf_counter() - t0
    ref = cpu_learner.get_weights()
    dist = update_distance(before, after, ref)
    stat_err = max(abs(stats[k] - cpu_stats[k]) / max(abs(cpu_stats[k]),
                                                      1e-6)
                   for k in cpu_stats)
    diff = max(float(np.abs(after[k] - ref[k]).max()) for k in ref)
    print(f"rllib {label} card vs cpu: update rel L2 {dist:.3e} (bound "
          f"{RLLIB_UPDATE_REL_L2}), stats rel err {stat_err:.3e} (bound "
          f"{RLLIB_STATS_RTOL}), weights max abs diff {diff:.3e}, cpu update "
          f"{cpu_s * 1e3:.1f} ms [{card}]", flush=True)
    check(all(np.isfinite(v) for v in stats.values()),
          f"rllib {label}: a non-finite statistic on the card: {stats}")
    check(dist <= RLLIB_UPDATE_REL_L2,
          f"rllib {label}: the card's update is {dist:.3e} (rel L2) from "
          f"the CPU's")
    check(stat_err <= RLLIB_STATS_RTOL,
          f"rllib {label}: the card's statistics {stats} differ from the "
          f"CPU's {cpu_stats}")


class UpdateRecorder:
    """Wraps a learner's `update`: times each call with CUDA events and
    keeps the first call's weights before, batch, weights after and
    statistics."""

    def __init__(self, learner):
        self.learner = learner
        self.update = learner.update
        self.ms = []
        self.first = None
        learner.update = self

    def __call__(self, batch):
        import torch

        first = None
        if self.first is None:
            first = dict(before=self.learner.get_weights(),
                         batch={k: v.copy() for k, v in batch.items()})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = self.update(batch)
        end.record()
        end.synchronize()
        self.ms.append(start.elapsed_time(end))
        if first is not None:
            first.update(after=self.learner.get_weights(), stats=dict(stats))
            self.first = first
        return stats


class DQNUpdateRecorder(UpdateRecorder):
    """`UpdateRecorder` for a `DQNLearner`: keeps, for the updates whose
    0-based index is in `at`, the whole state the update starts from (the
    online and target weights, Adam's state, the update count) besides
    the batch, the weights after and the statistics; and the importance
    weights of every batch."""

    def __init__(self, learner, at):
        super().__init__(learner)
        self.at = set(at)
        self.records = {}
        self.batch_weights = []

    def __call__(self, batch):
        import copy

        learner = self.learner
        index = learner._updates
        self.batch_weights.append(batch["weights"].copy())
        if index not in self.at:
            return super().__call__(batch)
        rec = dict(before=learner.get_weights(),
                   target=learner.get_target_weights(),
                   opt=copy.deepcopy(learner.optimizer.state_dict()),
                   updates=index,
                   batch={k: v.copy() for k, v in batch.items()})
        stats = super().__call__(batch)
        rec.update(after=learner.get_weights(), stats=dict(stats))
        self.records[index] = rec
        return stats


def build_together(*builds):
    """Runs each zero-argument `build` in a thread of its own and returns
    their results in order: algorithms whose actors start together wait
    on their processes' imports once."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        futures = [pool.submit(b) for b in builds]
        return [f.result(timeout=RLLIB_TIMEOUT_S) for f in futures]


class TargetMatchFixture:
    """The reference's multi-agent test env (`tests/test_rllib_multiagent.py
    TargetMatch`) in numpy: two agents each observe a one-hot target of
    4 and earn +1 for choosing it (agent_1's target is shifted by 1), in
    episodes of 8 steps."""

    possible_agents = ["agent_0", "agent_1"]
    N = 4

    def __init__(self):
        import numpy as np

        self._rng = np.random.default_rng(0)
        self._t = 0
        self._targets = {}

    def _obs(self):
        import numpy as np

        out = {}
        for aid in self.possible_agents:
            onehot = np.zeros(self.N, np.float32)
            onehot[self._targets[aid]] = 1.0
            out[aid] = onehot
        return out

    def _resample(self):
        base = int(self._rng.integers(0, self.N))
        self._targets = {"agent_0": base, "agent_1": (base + 1) % self.N}

    def reset(self, *, seed=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._resample()
        return self._obs(), {}

    def step(self, action_dict):
        rewards = {aid: 1.0 if action_dict.get(aid) == self._targets[aid]
                   else 0.0 for aid in self.possible_agents}
        self._t += 1
        self._resample()
        done = self._t >= 8
        return self._obs(), rewards, {"__all__": done}, {"__all__": False}, {}


def target_match_policy(agent_id) -> str:
    """Independent policies: agent_0 -> p0, agent_1 -> p1."""
    return "p0" if agent_id == "agent_0" else "p1"


class TensorMaker:
    """A GPU-leased actor that makes float32 data from a seed on its card
    and puts it on a queue."""

    def put_tensor(self, queue, n: int, seed: int) -> str:
        import torch

        t = torch.randn(n, generator=torch.Generator().manual_seed(seed))
        t = t.to("cuda:0")
        queue.put(t, timeout=RLLIB_TIMEOUT_S)
        return str(t.device)


def pool_square(x: int) -> int:
    return x * x


def q_argmax(weights: dict, obs, device: str, hiddens):
    """The online net's greedy action on `obs` (double-Q's choice of a'),
    computed on `device`."""
    import torch

    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

    module = DiscreteMLPModule(obs.shape[1], 2, hiddens).to(device)
    module.set_weights(weights)
    with torch.no_grad():
        q, _ = module(torch.from_numpy(obs).to(device))
    return q.argmax(dim=1).cpu().numpy()


def hold_dqn_update(label: str, card: str, rec: dict, config) -> None:
    """A DQN update on the card against the same update on the CPU: the
    same online and target weights, Adam state, update count and
    prioritized batch (importance weights included). The update and the
    statistics are gated as `hold_update`'s; |td| per sample within
    RLLIB_STATS_RTOL of max(|td|, 1e-2) where the online net's argmax
    (double-Q's choice of a') agrees on the two devices. The count of
    argmax disagreements is printed: where two Q-values differ by less
    than the devices' rounding, the two may pick different a'."""
    import numpy as np

    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule

    hiddens = tuple(config.hiddens)
    cpu = DQNLearner(DiscreteMLPModule(4, 2, hiddens),
                     dict(config.learner_config(), device="cpu"))
    cpu.set_weights(rec["before"], target=rec["target"])
    cpu.optimizer.load_state_dict(rec["opt"])
    cpu._updates = rec["updates"]
    t0 = time.perf_counter()
    cpu_stats = cpu.update(rec["batch"])
    cpu_s = time.perf_counter() - t0
    ref = cpu.get_weights()
    dist = update_distance(rec["before"], rec["after"], ref)
    stats = dict(rec["stats"])
    td, cpu_td = stats.pop("td_abs"), cpu_stats.pop("td_abs")
    stat_err = max(abs(stats[k] - cpu_stats[k]) / max(abs(cpu_stats[k]),
                                                      1e-6)
                   for k in cpu_stats)
    next_obs = rec["batch"]["next_obs"]
    agree = (q_argmax(rec["before"], next_obs, "cuda:0", hiddens)
             == q_argmax(rec["before"], next_obs, "cpu", hiddens))
    td_err = float(np.max(np.abs(td - cpu_td)[agree]
                          / np.maximum(np.abs(cpu_td[agree]), 1e-2)))
    w = rec["batch"]["weights"]
    print(f"rllib {label} card vs cpu (update {rec['updates'] + 1}, "
          f"importance weights {w.min():.4f}..{w.max():.4f}): update rel L2 "
          f"{dist:.3e} (bound {RLLIB_UPDATE_REL_L2}), stats rel err "
          f"{stat_err:.3e}, |td| rel err {td_err:.3e} over "
          f"{int(agree.sum())} samples (bound {RLLIB_STATS_RTOL}), double-Q "
          f"argmax disagreements {int((~agree).sum())} of {len(agree)}, cpu "
          f"update {cpu_s * 1e3:.1f} ms [{card}]", flush=True)
    check(all(np.isfinite(v) for v in stats.values())
          and np.isfinite(td).all(),
          f"rllib {label}: a non-finite statistic on the card: {stats}")
    check(dist <= RLLIB_UPDATE_REL_L2,
          f"rllib {label}: the card's update is {dist:.3e} (rel L2) from "
          f"the CPU's")
    check(stat_err <= RLLIB_STATS_RTOL and td_err <= RLLIB_STATS_RTOL,
          f"rllib {label}: the card's statistics {stats} or |td| differ "
          f"from the CPU's {cpu_stats}")


def alive_actors(ids) -> dict:
    """The state API's ALIVE entries among the actors `ids` (hex), by
    actor id."""
    from ray_tpu_torch.util.state import list_actors

    return {x["actor_id"]: x for x in list_actors()
            if x.get("actor_id") in ids and x.get("state") == "ALIVE"}


def phase_rllib(card: str) -> dict:
    """RLlib on the card: IMPALA and APPO on 84x84x4 frames with the
    Nature-CNN learner on cuda:0, PPO at `rllib/bench.py`'s configuration,
    and a GPU-leased remote learner; then DQN and multi-agent PPO, and the
    utilities (`phase_rllib_dqn_mappo`); the env runners are CPU actors of
    `init(num_cpus=4)`. Each card update is held against its CPU twin.
    IMPALA and APPO (two runners each) are built together, then PPO and
    the remote learner (two runners and one learner process), then DQN
    and multi-agent PPO (two runners each)."""
    import functools
    import statistics

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.rllib import (APPOConfig, IMPALAConfig, LearnerGroup,
                                     PPOConfig)
    from ray_tpu_torch.rllib.core.impala_learner import ImpalaLearner
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import (DiscreteMLPModule,
                                                    make_discrete_module)
    from ray_tpu_torch.rllib.env.synthetic_atari import SyntheticAtariEnv

    phase_t0 = time.perf_counter()
    os.environ[RUN_MARKER] = f"{os.getpid()}-{time.time_ns()}"
    ray_tpu_torch.init(num_cpus=RLLIB_CPUS)
    out = {}
    try:
        res = ray_tpu_torch.cluster_resources()
        check(res.get("GPU") == 1.0, f"the node did not detect one GPU: {res}")
        # 1. IMPALA on images, the Nature-CNN learner on the card, and
        # APPO's pipeline beside it.
        config = IMPALAConfig(env_creator=SyntheticAtariEnv)
        appo_config = APPOConfig(env_creator=SyntheticAtariEnv)
        t0 = time.perf_counter()
        algo, appo = build_together(config.build, appo_config.build)
        build_s = time.perf_counter() - t0
        try:
            learner = algo.learner
            n_params = sum(p.numel() for p in learner.module.parameters())
            check(learner.device == torch.device("cuda", 0)
                  and type(learner.module).__name__ == "DiscreteConvModule"
                  and n_params == 1_686_180,
                  f"the IMPALA learner is {type(learner.module).__name__} "
                  f"({n_params} params) on {learner.device}")
            rec = UpdateRecorder(learner)
            t0 = time.perf_counter()
            warm = algo.train()
            warm_s = time.perf_counter() - t0
            rec.ms.clear()
            t0 = time.perf_counter()
            m = algo.train()
            wall = time.perf_counter() - t0
            algo.stop()   # its runners would sample on beside APPO's
            # APPO: one iteration of the same pipeline, clipped surrogate.
            check(appo.learner.config["use_clip_loss"]
                  and appo.learner.device.type == "cuda",
                  "the APPO learner is not the clipped surrogate on the card")
            appo_rec = UpdateRecorder(appo.learner)
            t0 = time.perf_counter()
            appo_m = appo.train()
            appo_s = time.perf_counter() - t0
        finally:
            algo.stop()
            appo.stop()
        frames = rec.first["batch"]["obs"].shape
        check(frames == (config.rollout_fragment_length,
                         config.train_batch_fragments
                         * config.num_envs_per_runner, 84, 84, 4),
              f"IMPALA's batch frames are {frames}")
        learner_ms = statistics.median(rec.ms)
        out["impala"] = dict(
            env_steps_per_s=m["env_steps_per_sec"],
            updates_per_s=config.updates_per_iteration / wall,
            learner_ms=learner_ms, total_loss=m["learner/total_loss"])
        print(f"rllib impala: Nature-CNN learner ({n_params} params) on "
              f"{learner.device}, batch {list(frames)} + "
              f"{rec.first['batch']['final_obs'].shape[0]} bootstrap frames; "
              f"IMPALA and APPO built together in {build_s:.1f} s, warm-up "
              f"iteration {warm_s:.1f} s; measured iteration: "
              f"{m['env_steps_per_sec']:.1f} env steps/s, "
              f"{config.updates_per_iteration / wall:.2f} updates/s, learner "
              f"{learner_ms:.2f} ms an update (median of "
              f"{len(rec.ms)}, CUDA events; min {min(rec.ms):.2f}, max "
              f"{max(rec.ms):.2f}), loss {m['learner/total_loss']:.4f}, "
              f"return {m['episode_return_mean']:.3f} [{card}]", flush=True)
        check(np.isfinite(warm["learner/total_loss"])
              and np.isfinite(m["learner/total_loss"]),
              f"IMPALA's loss is not finite: {m}")
        first = rec.first
        hold_update("impala", card, first["before"], first["batch"],
                    first["after"], first["stats"],
                    ImpalaLearner(make_discrete_module((84, 84, 4), 3),
                                  dict(config.learner_config(),
                                       device="cpu")))
        out["appo"] = dict(env_steps_per_s=appo_m["env_steps_per_sec"],
                           learner_ms=statistics.median(appo_rec.ms))
        print(f"rllib appo: one iteration "
              f"({appo_config.updates_per_iteration} updates) in "
              f"{appo_s:.1f} s, {appo_m['env_steps_per_sec']:.1f} env "
              f"steps/s, learner {statistics.median(appo_rec.ms):.2f} ms an "
              f"update (median), loss {appo_m['learner/total_loss']:.4f}, "
              f"mean rho {appo_m['learner/mean_rho']:.4f} [{card}]",
              flush=True)
        check(np.isfinite(appo_m["learner/total_loss"]),
              f"APPO's loss is not finite: {appo_m}")
        first = appo_rec.first
        hold_update("appo", card, first["before"], first["batch"],
                    first["after"], first["stats"],
                    ImpalaLearner(make_discrete_module((84, 84, 4), 3),
                                  dict(appo_config.learner_config(),
                                       device="cpu")))

        # 2. PPO end to end at rllib/bench.py main()'s configuration, and
        # 3. the remote learner: one learner process leasing the card
        # (NCCL, world 1), started beside PPO's runners.
        config = PPOConfig(env_creator=CartPoleFixture, num_env_runners=2,
                           num_envs_per_runner=8, rollout_fragment_length=64,
                           num_epochs=4, minibatch_size=256)
        factory = functools.partial(DiscreteMLPModule, obs_dim=4,
                                    num_actions=2,
                                    hiddens=tuple(config.hiddens))
        t0 = time.perf_counter()
        algo, group = build_together(
            config.build, lambda: LearnerGroup(
                factory, config.learner_config(), num_learners=1))
        start_s = time.perf_counter() - t0
        try:
            local = algo.learner_group._local
            check(local.device == torch.device("cuda", 0),
                  f"the PPO learner is on {local.device}")
            rec = UpdateRecorder(local)
            t0 = time.perf_counter()
            m = algo.train()
            ppo_s = time.perf_counter() - t0
            algo.stop()
            first = rec.first
            lease = ray_tpu_torch.get(group._workers[0].execute.remote(
                remote_learner_lease), timeout=RLLIB_TIMEOUT_S)
            before = group.get_weights()
            t0 = time.perf_counter()
            stats = group.update(first["batch"])
            remote_ms = (time.perf_counter() - t0) * 1e3
            after = group.get_weights()
        finally:
            algo.stop()
            group.shutdown()
        out["ppo"] = dict(env_steps_per_s=m["env_steps_per_sec"],
                          learner_ms=rec.ms[0])
        print(f"rllib ppo: PPO and the remote learner built together in "
              f"{start_s:.1f} s; one iteration in {ppo_s:.1f} s: "
              f"{m['num_env_steps_sampled_lifetime']} env steps, "
              f"{m['env_steps_per_sec']:.1f} env steps/s, sample "
              f"{m['time_sample_s']:.3f} s, learn {m['time_learn_s']:.3f} s "
              f"(learner update {rec.ms[0]:.1f} ms, CUDA events, "
              f"{config.num_epochs} epochs of minibatch "
              f"{config.minibatch_size}) [{card}]", flush=True)
        print(f"rllib ppo keys: {sorted(m)}", flush=True)
        check(m["num_env_steps_sampled_lifetime"] == 2 * 8 * 64
              and np.isfinite(m["learner/total_loss"]),
              f"PPO's iteration is off: {m}")
        hold_update("ppo", card, first["before"], first["batch"],
                    first["after"], first["stats"],
                    PPOLearner(factory(), dict(config.learner_config(),
                                               device="cpu")))

        print(f"rllib remote learner: {lease}; its first update "
              f"{remote_ms:.1f} ms round trip (the batch shipped, the "
              f"worker's first CUDA work) [{card}]", flush=True)
        check(lease["device"] == "cuda:0" and lease["backend"] == "nccl"
              and lease["world"] == 1 and lease["visible"]
              and lease["params_on"] == ["cuda:0"],
              f"the remote learner is not on a leased card: {lease}")
        local = PPOLearner(factory(), config.learner_config())
        start = local.get_weights()
        check(all(np.array_equal(start[k], before[k]) for k in start),
              "the remote learner did not start from the seed's weights")
        local_stats = local.update(first["batch"])
        ref = local.get_weights()
        dist = update_distance(before, after, ref)
        bitwise = all(np.array_equal(after[k], ref[k]) for k in ref)
        print(f"rllib remote learner vs local on the card: update rel L2 "
              f"{dist:.3e} (bound {RLLIB_UPDATE_REL_L2}), bitwise {bitwise}, "
              f"loss {stats['total_loss']:.6f} vs "
              f"{local_stats['total_loss']:.6f} [{card}]", flush=True)
        check(dist <= RLLIB_UPDATE_REL_L2 and all(
            abs(stats[k] - local_stats[k])
            <= RLLIB_STATS_RTOL * max(abs(local_stats[k]), 1e-6)
            for k in local_stats),
              "the remote learner's update is not the local learner's")

        # (d) DQN with prioritized replay and multi-agent PPO with two
        # independent policies, built together: four runners on the four
        # CPUs, both learners on the card.
        out.update(phase_rllib_dqn_mappo(card))
    finally:
        ray_tpu_torch.shutdown()
    t0 = time.perf_counter()
    left = port_processes()
    while left and time.perf_counter() - t0 < CLUSTER_DOWN_S:
        time.sleep(0.1)
        left = port_processes()
    check(not left, f"port processes outlived shutdown by "
          f"{CLUSTER_DOWN_S} s: {left}")
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"rllib phase: {out['phase_s']:.1f} s [{card}]", flush=True)
    return out


def phase_rllib_dqn_mappo(card: str) -> dict:
    """Parts (d) and (e) of the RLlib phase, on its cluster: DQN and
    multi-agent PPO with their learners on the card, then the state API
    while their runners live and after, a `Queue` carrying a CUDA tensor
    from a GPU-leased actor, and `Pool.map`."""
    import ray_tpu_torch
    from ray_tpu_torch.util.multiprocessing import Pool
    from ray_tpu_torch.util.queue import Queue

    part_t0 = time.perf_counter()
    out = {}
    # The queue's two GPU-leased actors (no CPU each) start beside (d)'s
    # runners, so that their processes' imports overlap.
    queue = Queue(maxsize=2, actor_options={"num_gpus": 0.25})
    maker = ray_tpu_torch.remote(num_cpus=0, num_gpus=0.25)(
        TensorMaker).remote()
    try:
        phase_rllib_algorithms(card, out)
        phase_rllib_queue(card, queue, maker)
    finally:
        queue.shutdown()
        ray_tpu_torch.kill(maker)

    t0 = time.perf_counter()
    with Pool(2) as pool:
        pooled = pool.map(pool_square, range(32))
    pool_s = time.perf_counter() - t0
    check(pooled == list(map(pool_square, range(32))),
          f"Pool(2).map gave {pooled}")
    print(f"rllib pool: Pool(2).map of 32 items equals map, {pool_s:.2f} s "
          f"[{card}]", flush=True)
    out["dqn_mappo_s"] = time.perf_counter() - part_t0
    print(f"rllib dqn, multi-agent ppo and utilities: "
          f"{out['dqn_mappo_s']:.1f} s [{card}]", flush=True)
    return out


def phase_rllib_algorithms(card: str, out: dict) -> None:
    """Part (d), and (e)'s state API while (d)'s runners live and after
    they stop."""
    import functools
    import statistics

    import numpy as np
    import torch

    from ray_tpu_torch.rllib import DQNConfig, MultiAgentPPOConfig
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import DiscreteMLPModule
    from ray_tpu_torch.rllib.utils.replay_buffers import \
        PrioritizedReplayBuffer

    dqn_config = DQNConfig(env_creator=CartPoleFixture,
                           prioritized_replay=True, learning_starts=256)
    policy = functools.partial(DiscreteMLPModule, obs_dim=TargetMatchFixture.N,
                               num_actions=TargetMatchFixture.N,
                               hiddens=(32,))
    ma_config = MultiAgentPPOConfig(
        env_creator=TargetMatchFixture, policies={"p0": policy, "p1": policy},
        policy_mapping_fn=target_match_policy, num_env_runners=2,
        rollout_fragment_length=64)
    t0 = time.perf_counter()
    dqn, mappo = build_together(dqn_config.build, ma_config.build)
    build_s = time.perf_counter() - t0
    runner_ids = {r._actor_id.hex() for a in (dqn, mappo) for r in a._runners}
    # Earlier parts' runners of the same classes finished their calls
    # long since: the count from here on is (d)'s.
    calls_before = sample_calls()
    try:
        learners = dict(mappo.learners, dqn=dqn.learner)
        check(all(l.device == torch.device("cuda", 0)
                  and {str(p.device) for p in l.module.parameters()}
                  == {"cuda:0"} for l in learners.values())
              and {str(p.device) for p in dqn.learner.target.parameters()}
              == {"cuda:0"},
              f"the learners are not on cuda:0: "
              f"{ {k: str(l.device) for k, l in learners.items()} }")
        check(isinstance(dqn.buffer, PrioritizedReplayBuffer),
              f"DQN's buffer is {type(dqn.buffer).__name__}")
        per_iter = dqn_config.updates_per_iteration
        rec = DQNUpdateRecorder(dqn.learner, at=(0, per_iter))
        first_m = [dqn.train(), dqn.train()]
        rec.ms.clear()
        t0 = time.perf_counter()
        m = dqn.train()
        dqn_s = time.perf_counter() - t0
        check([x["num_updates"] for x in first_m + [m]] == [0, per_iter,
                                                          per_iter],
              f"DQN's updates an iteration: "
              f"{[x['num_updates'] for x in first_m + [m]]}")
        check(sorted(rec.records) == [0, per_iter],
              f"DQN recorded updates {sorted(rec.records)}")
        varied = sum(not np.all(w == 1.0) for w in rec.batch_weights)
        check(varied >= per_iter,
              f"only {varied} of DQN's {len(rec.batch_weights)} prioritized "
              f"batches have importance weights other than 1")
        dqn_ms = statistics.median(rec.ms)
        out["dqn"] = dict(learner_ms=dqn_ms, updates_per_s=per_iter / dqn_s,
                          env_steps_per_s=m["env_steps_per_sec"])
        print(f"rllib dqn: DQN (double-Q, prioritized replay, "
              f"{dqn_config.num_env_runners} runners x "
              f"{dqn_config.num_envs_per_runner} envs x "
              f"{dqn_config.rollout_fragment_length} steps, batch "
              f"{dqn_config.train_batch_size}, hiddens "
              f"{tuple(dqn_config.hiddens)}) and multi-agent PPO built "
              f"together in {build_s:.1f} s; measured iteration 3: "
              f"{per_iter} updates in {dqn_s:.3f} s, {per_iter / dqn_s:.1f} "
              f"updates/s, {m['env_steps_per_sec']:.1f} env steps/s, learner "
              f"{dqn_ms:.3f} ms an update (median of {len(rec.ms)}, CUDA "
              f"events; min {min(rec.ms):.3f}, max {max(rec.ms):.3f}), loss "
              f"{m['learner/total_loss']:.4f}, epsilon {m['epsilon']:.4f}, "
              f"buffer {m['buffer_size']}, {varied} of "
              f"{len(rec.batch_weights)} batches with importance weights "
              f"other than 1 [{card}]", flush=True)
        check(all(np.isfinite(x["learner/total_loss"])
                  for x in (first_m[1], m)),
              f"DQN's loss is not finite: {m}")
        for index in sorted(rec.records):
            hold_dqn_update("dqn", card, rec.records[index], dqn_config)

        recs = {pid: UpdateRecorder(l) for pid, l in mappo.learners.items()}
        t0 = time.perf_counter()
        ma = mappo.train()
        mappo_s = time.perf_counter() - t0
        check(all(f"learner/{pid}/total_loss" in ma
                  and np.isfinite(ma[f"learner/{pid}/total_loss"])
                  for pid in ("p0", "p1")),
              f"multi-agent PPO's per-policy losses: {ma}")
        out["mappo"] = {pid: dict(update_ms=r.ms[0])
                        for pid, r in recs.items()}
        print(f"rllib multi-agent ppo: one iteration in {mappo_s:.3f} s, "
              f"{ma['num_env_steps_sampled_lifetime']} agent steps, "
              f"{ma['env_steps_per_sec']:.1f} agent steps/s; per-policy "
              f"update "
              + ", ".join(f"{pid} {r.ms[0]:.1f} ms ({ma_config.num_epochs} "
                          f"epochs of {len(r.first['batch']['obs'])} rows, "
                          f"loss {ma[f'learner/{pid}/total_loss']:.4f})"
                          for pid, r in recs.items())
              + f" (CUDA events) [{card}]", flush=True)
        for pid, r in recs.items():
            hold_update(f"multi-agent ppo {pid}", card, r.first["before"],
                        r.first["batch"], r.first["after"], r.first["stats"],
                        PPOLearner(policy(), dict(ma_config.learner_config(),
                                                  device="cpu")))

        # (e) The state API while the runners live: 3 DQN iterations of
        # 2 runners, 1 multi-agent iteration of 2.
        alive = alive_actors(runner_ids)
        want = {"SingleAgentEnvRunner": 3 * dqn_config.num_env_runners,
                "MultiAgentEnvRunner": ma_config.num_env_runners}
        t0 = time.perf_counter()
        while True:   # the workers flush their task events each second
            after = sample_calls()
            calls = {k: after[k] - calls_before[k] for k in after}
            if calls == want or time.perf_counter() - t0 > 10:
                break
            time.sleep(0.25)
        print(f"rllib state: {len(alive)} of {len(runner_ids)} runners ALIVE "
              f"({sorted(x['class_name'] for x in alive.values())}); "
              f"finished sample calls {calls} [{card}]", flush=True)
        check(len(runner_ids) == 4 and set(alive) == runner_ids,
              f"the state API lists {len(alive)} of the runners ALIVE")
        check(calls == want,
              f"summarize_tasks counts {calls} sample calls, not {want}")
    finally:
        dqn.stop()
        mappo.stop()
    t0 = time.perf_counter()
    while alive_actors(runner_ids) and time.perf_counter() - t0 < 30:
        time.sleep(0.1)
    left = alive_actors(runner_ids)
    print(f"rllib state after stop(): {len(left)} runners ALIVE [{card}]",
          flush=True)
    check(not left, f"runners still ALIVE after stop(): {left}")


def sample_calls() -> dict:
    """`summarize_tasks()`'s finished `sample` calls of each runner
    class."""
    from ray_tpu_torch.util.state import summarize_tasks

    summary = summarize_tasks()
    return {name: summary.get(f"{name}.sample", {}).get("FINISHED", 0)
            for name in ("SingleAgentEnvRunner", "MultiAgentEnvRunner")}


def phase_rllib_queue(card: str, queue, maker) -> None:
    """A CUDA tensor through a Queue: from a GPU-leased actor's card to
    the driver's, through the queue actor's (a CUDA tensor lands on the
    card of each process that reads it)."""
    import torch

    import ray_tpu_torch

    n = (1 << 20) // 4
    t0 = time.perf_counter()
    maker_device = ray_tpu_torch.get(maker.put_tensor.remote(queue, n, 18),
                                     timeout=RLLIB_TIMEOUT_S)
    got = queue.get(timeout=RLLIB_TIMEOUT_S)
    queue_ms = (time.perf_counter() - t0) * 1e3
    want = torch.randn(n, generator=torch.Generator().manual_seed(18))
    check(isinstance(got, torch.Tensor)
          and got.device == torch.device("cuda", 0)
          and got.dtype == torch.float32 and torch.equal(got.cpu(), want),
          f"the queue's tensor is not the maker's: "
          f"{getattr(got, 'device', type(got))}")
    print(f"rllib queue: {n * 4} B of float32 from a 0.25-GPU actor "
          f"({maker_device}) through a 0.25-GPU queue to the driver's "
          f"{got.device}, bitwise equal, {queue_ms:.1f} ms put and get (the "
          f"actors started during part d) [{card}]", flush=True)


def importable(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None



class RoutingRecorder:
    """While open, keeps each `ops.moe.top_k_gating` call's router logits
    and aux loss, in call order (`moe_ffn` looks the function up in its
    module at each call): a model's forward calls it once per MoE layer,
    first to last, and a remat backward once more per layer, last to
    first."""

    def __enter__(self):
        import importlib

        self._moe = importlib.import_module("ray_tpu_torch.ops.moe")
        self._real = real = self._moe.top_k_gating
        self.calls = []

        def record(logits, k, capacity):
            out = real(logits, k, capacity)
            self.calls.append((logits.detach(), out[2].detach()))
            return out

        self._moe.top_k_gating = record
        return self

    def __exit__(self, *exc):
        self._moe.top_k_gating = self._real


def route_choices(logits, k: int):
    """([T, k] experts in the order `top_k_gating` picks them, by rounds of
    argmax; [T] the least gap between consecutive ones of the token's k + 1
    largest router probabilities: how near a tie its choices are)."""
    import torch

    probs = torch.softmax(logits.float(), dim=-1)
    remaining, picks = probs.clone(), []
    for _ in range(k):
        idx = remaining.argmax(dim=-1)
        picks.append(idx)
        remaining.scatter_(1, idx[:, None], 0.0)
    top = probs.topk(min(k + 1, probs.shape[1]), dim=-1).values
    return torch.stack(picks, 1), (top[:, :-1] - top[:, 1:]).amin(-1)


def routing_flips(calls, ref_calls, k: int):
    """(token-layer pairs whose choices differ, the largest tie gap among
    them or 0.0) between two lists of recorded gating calls, layer by
    layer; the gaps are read on `ref_calls`' probabilities."""
    import torch

    flips, worst = 0, 0.0
    for (logits, _), (ref_logits, _) in zip(calls, ref_calls):
        choice, _ = route_choices(logits, k)
        ref_choice, gap = route_choices(ref_logits, k)
        differ = (choice != ref_choice).any(-1)
        flips += int(differ.sum())
        if bool(differ.any()):
            worst = max(worst, gap[differ].max().item())
    torch.cuda.synchronize()
    return flips, worst


def moe_grad_attempt(params, cfg, seed: int):
    """One float32 MoE gradient comparison on a token batch drawn from
    `seed`: the `lm_loss` gradients through the kernels and through plain
    attention, each with its recorded gating calls. Returns (K1, K2, K3
    launches of the kernel path, kernel-path and plain losses, gradients
    and routing recorders)."""
    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import lm_loss

    leaves = _leaves(params)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (GRAD_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")
    for t in leaves:
        t.requires_grad_(True)
    try:
        flash_attn.launches = flash_attn.dkv_launches = 0
        flash_attn.dq_launches = 0
        with RoutingRecorder() as kernel_route:
            loss_k = lm_loss(params, {"tokens": tokens}, cfg)
            g_kernel = torch.autograd.grad(loss_k, leaves)
        torch.cuda.synchronize()
        counts = (flash_attn.launches, flash_attn.dkv_launches,
                  flash_attn.dq_launches)
        with RoutingRecorder() as plain_route:
            loss_p = plain_lm_loss(params, tokens, cfg)
            g_plain = torch.autograd.grad(loss_p, leaves)
        torch.cuda.synchronize()
        check(flash_attn.dkv_launches == counts[1],
              "the plain-attention gradient launched a kernel")
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return (counts, (loss_k, loss_p), (g_kernel, g_plain),
            (kernel_route, plain_route))


def phase_moe_grad_f32(params, cfg, card: str):
    """The float32 MoE gradients through K1, K2 and K3's float32 route
    against plain attention's, routing compared first. Where a tie flips a
    routing choice, the next token batch is drawn, so the rel L2 bound is
    held on one batch of every run; ties on all MOE_GRAD_SEEDS fail.
    Returns the K1, K2, K3 launches of the last batch."""
    from dataclasses import replace

    import torch

    cfg = replace(cfg, n_layers=F32_GRAD_LAYERS, dtype=torch.float32)
    params = dict(params, layers=params["layers"][:F32_GRAD_LAYERS])
    n, k = cfg.n_layers, cfg.moe_top_k
    tokens_routed = GRAD_BATCH * TRAIN_SEQ * n
    for seed in MOE_GRAD_SEEDS:
        counts, (loss_k, loss_p), (g_kernel, g_plain), (kernel_route,
                                                         plain_route) = \
            moe_grad_attempt(params, cfg, seed)
        check(len(kernel_route.calls) == 2 * n
              and len(plain_route.calls) == 2 * n,
              f"gating ran {len(kernel_route.calls)} and "
              f"{len(plain_route.calls)} times, expected {2 * n} (a "
              f"forward and a recompute per layer)")
        flips, flip_gap = routing_flips(kernel_route.calls[:n],
                                        plain_route.calls[:n], k)
        re_flips, re_gap = routing_flips(kernel_route.calls[n:][::-1],
                                         kernel_route.calls[:n], k)
        names, parts_k = _split_qkv(_leaf_names(params), g_kernel)
        parts_p = _split_qkv(_leaf_names(params), g_plain)[1]
        rel = [((a - b).norm() / b.norm()).item()
               for a, b in zip(parts_k, parts_p)]
        worst = max(range(len(names)), key=rel.__getitem__)
        moe_parts = [i for i, name in enumerate(names)
                     if name.split(".")[-1] in ("router", "moe_w1",
                                                "moe_w2")]
        worst_moe = max(moe_parts, key=rel.__getitem__)
        aux_k = sum(a for _, a in kernel_route.calls[:n]).item()
        aux_p = sum(a for _, a in plain_route.calls[:n]).item()
        print(f"moe grad flagship f32 depth {n} experts {cfg.num_experts} "
              f"top {k} capacity_factor {cfg.capacity_factor} "
              f"[{GRAD_BATCH}, {TRAIN_SEQ}] tokens seed {seed} remat "
              f"{cfg.remat_policy}: routing differs kernels vs plain in "
              f"{flips} of {tokens_routed} token-layer pairs (largest tie "
              f"gap {flip_gap:.3e}, limit {ROUTE_TIE_GAP:g}), recompute vs "
              f"forward in {re_flips} (largest gap {re_gap:.3e}); loss "
              f"kernels {loss_k.item():.6f} plain {loss_p.item():.6f}, aux "
              f"kernels {aux_k:.6f} plain {aux_p:.6f}; rel_l2 kernels vs "
              f"plain over {len(names)} parts: max {rel[worst]:.3e} "
              f"({names[worst]}), MoE parts max {rel[worst_moe]:.3e} "
              f"({names[worst_moe]}), mean {sum(rel) / len(rel):.3e} "
              f"(limit {F32_GRAD_REL_L2:g}); launches K1 {counts[0]} K2 "
              f"{counts[1]} K3 {counts[2]} [{card}]", flush=True)
        check(all(c == n for c in counts),
              f"the MoE float32 gradient launched K1, K2, K3 {counts} "
              f"times, expected {n} each")
        check(flip_gap <= ROUTE_TIE_GAP and re_gap <= ROUTE_TIE_GAP,
              f"routing differs where no tie explains it: gaps "
              f"{flip_gap:.3e} (kernels vs plain), {re_gap:.3e} "
              f"(recompute vs forward)")
        check(all(bool(torch.isfinite(g).all()) for g in g_kernel),
              "MoE float32 kernel-path gradients are not finite")
        if not (flips or re_flips):
            check(rel[worst] <= F32_GRAD_REL_L2,
                  f"the MoE float32 kernel-path gradient of {names[worst]} "
                  f"is {rel[worst]:.3e} from plain attention's (rel L2), "
                  f"over {F32_GRAD_REL_L2:g}")
            return counts
        print(f"moe grad: {flips + re_flips} tied routing choices differ "
              f"on seed {seed}'s tokens; the rel L2 bound is held on the "
              f"next batch", flush=True)
        del g_kernel, g_plain, kernel_route, plain_route
    raise PhaseError(f"tied routing choices differed on all "
                     f"{len(MOE_GRAD_SEEDS)} token batches "
                     f"{MOE_GRAD_SEEDS}: the rel L2 bound held on none")


def moe_flops(cfg, n_tokens: int):
    """Forward operations of one MoE layer by count: (dispatch, combine,
    experts), 2 T E C D each for the dispatch and combine products and
    4 E C D F for the two expert products."""
    from ray_tpu_torch.ops.moe import capacity

    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    c = capacity(n_tokens, e, cfg.moe_top_k, cfg.capacity_factor)
    return 2.0 * n_tokens * e * c * d, 2.0 * n_tokens * e * c * d, \
        4.0 * e * c * d * f


def moe_layer_ms(lp, cfg, n_tokens: int):
    """One MoE layer's forward at [n_tokens, D] random tokens in cfg's
    dtype with `lp`'s weights: CUDA-event ms of `ops.moe.top_k_gating` on
    the router logits and of `ops.moe.moe_ffn` whole, and the card time of
    one `moe_ffn` call under `torch.profiler` by the aten op that launched
    each kernel ({op: ms})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops.moe import capacity, moe_ffn, top_k_gating

    e, k = cfg.num_experts, cfg.moe_top_k
    gen = torch.Generator(device="cuda").manual_seed(41)
    with torch.no_grad():
        x = torch.randn((1, n_tokens, cfg.d_model), generator=gen,
                        device="cuda").to(cfg.dtype)
        logits = x[0].float() @ lp["router"].float()
        c = capacity(n_tokens, e, k, cfg.capacity_factor)

        def ffn():
            return moe_ffn(x, lp["router"], lp["moe_w1"], lp["moe_w2"],
                           top_k=k, capacity_factor=cfg.capacity_factor)

        gating_ms = cuda_ms(lambda: top_k_gating(logits, k, c), 5, warmup=1)
        ffn_ms = cuda_ms(ffn, 5, warmup=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ffn()
            torch.cuda.synchronize()
    # The ops' own device time; the kernels' events, which repeat it, are
    # left out.
    by_op = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU:
            continue
        us = (ev.self_device_time_total
              if hasattr(ev, "self_device_time_total")
              else ev.self_cuda_time_total)
        if us > 0:
            by_op[ev.key] = by_op.get(ev.key, 0.0) + us / 1e3
    del x, logits
    torch.cuda.empty_cache()
    return gating_ms, ffn_ms, by_op


def phase_moe_train(params, cfg, card: str, power_w: float):
    """The MoE model's train step at full depth. Returns the K1, K2, K3
    launches of the timed steps."""
    import torch

    from ray_tpu_torch.kernels import flash_attn
    from ray_tpu_torch.models import lm_loss
    from ray_tpu_torch.parallel import adamw, make_train_step

    n = cfg.n_layers
    n_params = sum(t.numel() for t in _leaves(params))
    optimizer = adamw(1e-4)
    opt_state = optimizer.init(params)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), optimizer)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (MOE_TRAIN_BATCH, TRAIN_SEQ + 1),
                                     generator=gen, device="cuda")}
    with RoutingRecorder() as route:
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch)
        losses = [loss]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        flash_attn.launches = flash_attn.dkv_launches = 0
        flash_attn.dq_launches = 0
        t0 = time.perf_counter()
        for _ in range(MOE_TRAIN_STEPS):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = (flash_attn.launches, flash_attn.dkv_launches,
                flash_attn.dq_launches)
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    # Each step's gating calls: the forward's n, then the recompute's n.
    check(len(route.calls) == 2 * n * len(values),
          f"gating ran {len(route.calls)} times in {len(values)} steps, "
          f"expected {2 * n} a step")
    auxes = [sum(a for _, a in route.calls[i * 2 * n:i * 2 * n + n]).item()
             for i in range(len(values))]
    n_tokens = MOE_TRAIN_BATCH * TRAIN_SEQ
    step_ms = dt / MOE_TRAIN_STEPS * 1e3
    per_step = [c / MOE_TRAIN_STEPS for c in launches]
    print(f"moe train flagship bf16 experts {cfg.num_experts} top "
          f"{cfg.moe_top_k} capacity_factor {cfg.capacity_factor} remat "
          f"{cfg.remat_policy} AdamW 1e-4 [{MOE_TRAIN_BATCH}, {TRAIN_SEQ}], "
          f"{n_params} params: warm-up step {warm_s:.3f} s; "
          f"{MOE_TRAIN_STEPS} steps in {dt:.4f} s, step_ms {step_ms:.2f}, "
          f"tokens_per_s {n_tokens * MOE_TRAIN_STEPS / dt:.1f}, "
          f"peak_memory_bytes {peak} ({peak / 2 ** 30:.2f} GiB), launches "
          f"per step K1 {per_step[0]:g} K2 {per_step[1]:g} K3 "
          f"{per_step[2]:g} [{card}]", flush=True)
    print(f"moe train losses {' '.join(f'{x:.5f}' for x in values)}; aux "
          f"{' '.join(f'{x:.5f}' for x in auxes)}", flush=True)
    check(all(x == x and abs(x) != float("inf") for x in values + auxes),
          "an MoE train loss or aux is not finite")
    check(all(x > 0 for x in auxes), "an MoE step's aux loss is not > 0")
    check(values[-1] < values[0],
          f"the MoE loss did not fall: {values[0]:.5f} -> {values[-1]:.5f}")
    check(all(c == n * MOE_TRAIN_STEPS for c in launches),
          f"the MoE train steps launched K1, K2, K3 {launches} times, "
          f"expected {n * MOE_TRAIN_STEPS} each (once per layer per step)")
    profile_step(lambda: step(params, opt_state, batch), step_ms, card,
                 label="moe train step")
    dispatch, combine, experts = moe_flops(cfg, n_tokens)
    gating_ms, ffn_ms, by_op = moe_layer_ms(params["layers"][0], cfg,
                                            n_tokens)
    mm_ms, bmm_ms = by_op.get("aten::mm", 0.0), by_op.get("aten::bmm", 0.0)

    def rate(flops, ms):
        return f"{flops / ms / 1e9:.1f} TFLOP/s" if ms > 0 else "not recorded"

    rest = sorted(((ms, op) for op, ms in by_op.items()
                   if op not in ("aten::mm", "aten::bmm")), reverse=True)
    print(f"moe layer forward at [{MOE_TRAIN_BATCH}, {TRAIN_SEQ}] by count: "
          f"dispatch {dispatch / 1e12:.4f} + combine {combine / 1e12:.4f} "
          f"TFLOP against experts {experts / 1e12:.4f} TFLOP (ratio "
          f"{(dispatch + combine) / experts:.3f}); by CUDA events, bf16: "
          f"moe_ffn {ffn_ms:.3f} ms, of which top_k_gating {gating_ms:.3f} "
          f"ms and the rest (router, casts, products, activation) "
          f"{ffn_ms - gating_ms:.3f} ms; one moe_ffn under the profiler, "
          f"card time by aten op: mm (router, dispatch, combine) "
          f"{mm_ms:.3f} ms ({rate(dispatch + combine, mm_ms)} on the "
          f"dispatch and combine count), bmm (experts) {bmm_ms:.3f} ms "
          f"({rate(experts, bmm_ms)}), "
          f"others {sum(ms for ms, _ in rest):.3f} ms ("
          + ", ".join(f"{op} {ms:.3f}" for ms, op in rest[:6])
          + f") [{card}]", flush=True)
    del opt_state
    return launches


def _zero_counts():
    from ray_tpu_torch.kernels import flash_attn

    flash_attn.launches = flash_attn.dkv_launches = 0
    flash_attn.dq_launches = 0


def _counts():
    from ray_tpu_torch.kernels import flash_attn

    return (flash_attn.launches, flash_attn.dkv_launches,
            flash_attn.dq_launches)


def _flat(params):
    """[(name, tensor)] of a params tree, layer leaves stacked or not; a
    DTensor leaf as its local block (the whole, on a mesh of one)."""
    from torch.distributed.tensor import DTensor

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    out = [("embed", local(params["embed"])),
           ("ln_f", local(params["ln_f"]))]
    layers = params["layers"]
    if isinstance(layers, dict):        # to_pipelined: [1, L, ...]
        for key, t in layers.items():
            t = local(t)[0]
            out += [(f"layers.{i}.{key}", t[i]) for i in range(t.shape[0])]
    else:
        out += [(f"layers.{i}.{key}", local(t))
                for i, lp in enumerate(layers) for key, t in lp.items()]
    return sorted(out, key=lambda kv: kv[0])


def phase_mesh_train(cfg, card: str, base: dict):
    """bench.py's dense step on `make_mesh()` of this one card (every axis
    1): params from `init_sharded` (DTensors), the batch placed by
    `batch_sharding`, `make_train_step` over `lm_loss(..., mesh=mesh)`.
    First MESH_CHECK_STEPS steps against the mesh-free step from the same
    init and batch: losses and every updated param bitwise equal (the
    mesh path runs the same kernels on the same local blocks; it adds no
    collective on an axis of one). Then TRAIN_STEPS timed steps (K1, K2,
    K3 once per layer per step) and one profiled step, beside the
    mesh-free step of the train phase (`base`): the difference is the host
    cost of the mesh path. Returns (mesh, K1/K2/K3 launches of the timed
    steps)."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import init_params, lm_loss, param_specs
    from ray_tpu_torch.parallel import (adamw, batch_sharding, init_sharded,
                                        make_mesh, make_train_step)

    mesh = make_mesh()
    check(tuple(mesh.shape) == (1, 1, 1, 1),
          f"make_mesh() on one card is {tuple(mesh.shape)}, not all 1")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda")

    def init():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(0))

    def run(params, loss_fn, batch, steps):
        optimizer = adamw(1e-4)
        state = optimizer.init(params)
        step = make_train_step(loss_fn, optimizer)
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, batch)
            losses.append(loss)
        return params, state, step, [x.item() for x in losses]

    def mesh_free():
        params, state, _, losses = run(
            init(), lambda p, b: lm_loss(p, b, cfg), {"tokens": tokens},
            MESH_CHECK_STEPS)
        del state
        return [(n, t.detach()) for n, t in _flat(params)], losses

    def largest(a, b):
        return max((x.float() - y.float()).abs().max().item()
                   for (_, x), (_, y) in zip(a, b))

    # Two mesh-free runs: their difference is the card's own run-to-run
    # noise at these steps (zero if every kernel on the path is
    # deterministic), the floor of any comparison with a third run.
    ref, ref_losses = mesh_free()
    again, again_losses = mesh_free()
    noise = largest(ref, again)
    noise_loss = max(abs(x - y) for x, y in zip(ref_losses, again_losses))
    del again
    gc.collect()
    torch.cuda.empty_cache()

    params = init_sharded(init, param_specs(cfg), mesh)
    check(all(isinstance(t, DTensor) for t in _leaves(params)),
          "init_sharded gave plain tensors")
    place = batch_sharding(mesh)
    batch = {"tokens": DTensor.from_local(tokens, mesh, place)}
    t0 = time.perf_counter()
    params, state, step, losses = run(
        params, lambda p, b: lm_loss(p, b, cfg, mesh=mesh), batch,
        MESH_CHECK_STEPS)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    got = _flat(params)
    diff = largest(ref, got)
    n_equal = sum(torch.equal(a, t.detach())
                  for (_, a), (_, t) in zip(ref, got))
    diff_loss = max(abs(x - y) for x, y in zip(ref_losses, losses))
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"mesh train check: make_mesh() {axes} on one card, {len(ref)} "
          f"DTensor leaves; {MESH_CHECK_STEPS} steps ({check_s:.3f} s, the "
          f"first a warm-up): losses mesh "
          f"{' '.join(f'{x:.6f}' for x in losses)} mesh-free "
          f"{' '.join(f'{x:.6f}' for x in ref_losses)}, bitwise equal "
          f"{losses == ref_losses}; params bitwise equal {n_equal} of "
          f"{len(ref)}, largest difference {diff:.3e}; two mesh-free runs "
          f"differ by {noise:.3e} (params), {noise_loss:.3e} (losses) "
          f"[{card}]", flush=True)
    if noise == 0 and noise_loss == 0:
        # The mesh-free step is deterministic here: the mesh step must be
        # the same computation, bit for bit.
        check(losses == ref_losses and n_equal == len(ref),
              f"the mesh step is not bitwise the mesh-free step: losses "
              f"{losses} vs {ref_losses}, {len(ref) - n_equal} params "
              f"differ, by up to {diff:.3e}")
    else:
        # The card's run-to-run noise: the mesh step may differ from the
        # mesh-free one as much as two mesh-free runs do, twice over.
        check(diff <= 2 * noise and diff_loss <= 2 * noise_loss,
              f"the mesh step differs from the mesh-free step by {diff:.3e}"
              f" (params) and {diff_loss:.3e} (losses), over twice two "
              f"mesh-free runs' {noise:.3e} and {noise_loss:.3e}")
    del ref
    gc.collect()

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    values = losses[:MESH_CHECK_STEPS] + [x.item() for x in
                                          losses[MESH_CHECK_STEPS:]]
    step_ms = dt / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / dt
    print(f"mesh train flagship bf16 remat {cfg.remat_policy} [{TRAIN_BATCH}"
          f", {TRAIN_SEQ}] on make_mesh(): {TRAIN_STEPS} steps in "
          f"{dt:.4f} s, step_ms {step_ms:.2f} (mesh-free step in the train "
          f"phase {base['step_ms']:.2f}: {step_ms - base['step_ms']:+.2f} "
          f"ms, {step_ms / base['step_ms']:.4f}x), tokens_per_s "
          f"{tokens_per_s:.1f} (mesh-free {base['tokens_per_s']:.1f}), "
          f"peak_memory_bytes {peak} ({peak / 2 ** 30:.2f} GiB), launches "
          f"K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} in "
          f"{TRAIN_STEPS} steps; losses "
          f"{' '.join(f'{x:.5f}' for x in values)} [{card}]", flush=True)
    check(all(x == x and abs(x) != float("inf") for x in values),
          "a mesh train loss is not finite")
    check(values[-1] < values[0], f"the mesh train loss did not fall: "
          f"{values[0]:.5f} -> {values[-1]:.5f}")
    check(all(n == cfg.n_layers * TRAIN_STEPS for n in launches),
          f"the mesh train steps launched K1, K2, K3 {launches} times, "
          f"expected {cfg.n_layers * TRAIN_STEPS} each (once per layer per "
          f"step)")
    prof = profile_step(lambda: step(params, state, batch), step_ms, card,
                        label="mesh train step")
    if prof and base.get("profile"):
        b = base["profile"]
        print(f"mesh train vs mesh-free, one profiled step each: card busy "
              f"{prof['busy_ms']:.2f} vs {b['busy_ms']:.2f} ms, idle share "
              f"{prof['idle']:.4f} vs {b['idle']:.4f}, host clock "
              f"{prof['host_ms']:.2f} vs {b['host_ms']:.2f} ms [{card}]",
              flush=True)
    return mesh, launches


def phase_pipeline_f32(mesh, cfg, card: str):
    """`lm_loss_pipelined` on the one-card mesh (one stage, PIPE_MICRO
    microbatches), float32 at depth PIPE_F32_LAYERS, PIPE_F32_BATCH x
    TRAIN_SEQ tokens, against the unpipelined plain-attention path
    (`plain_lm_loss`) from the same weights: the loss and every gradient
    part (wqkv split into q, k, v) within PIPE_GRAD_REL_L2 rel L2. The
    pipelined path takes plain attention (explicit positions, as JAX's),
    so K1-K3 launch no time."""
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models import (init_params, lm_loss_pipelined,
                                      pipelined_param_specs, to_pipelined)
    from ray_tpu_torch.parallel import shard_pytree

    cfg = replace(cfg, n_layers=PIPE_F32_LAYERS, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size,
                           (PIPE_F32_BATCH, TRAIN_SEQ + 1),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(5), device="cuda")
    pp = shard_pytree(to_pipelined(params, 1), pipelined_param_specs(cfg),
                      mesh)
    names, leaves = zip(*_flat(params))
    for t in leaves:
        t.requires_grad_(True)
    ref = plain_lm_loss(params, tokens, cfg)
    ref.backward()
    ref_grads = [t.grad for _, t in _flat(params)]
    for t in (pp["embed"], pp["ln_f"], *pp["layers"].values()):
        t.requires_grad_(True)
    _zero_counts()
    loss = lm_loss_pipelined(pp, {"tokens": tokens}, cfg, mesh,
                             num_microbatches=PIPE_MICRO)
    loss.backward()
    launches = _counts()
    grads = {"embed": pp["embed"].grad, "ln_f": pp["ln_f"].grad,
             "layers": {k: t.grad for k, t in pp["layers"].items()}}
    got = [t for _, t in _flat(grads)]
    part_names, ref_parts = _split_qkv(names, ref_grads)
    _, parts = _split_qkv(names, got)
    rel = [((a - b).norm() / b.norm()).item()
           for a, b in zip(parts, ref_parts)]
    worst = max(range(len(rel)), key=rel.__getitem__)
    loss_v, ref_v = loss.item(), ref.item()
    loss_rel = abs(loss_v - ref_v) / abs(ref_v)
    print(f"pipeline f32 depth {cfg.n_layers} [{PIPE_F32_BATCH}, "
          f"{TRAIN_SEQ}] {PIPE_MICRO} microbatches, one stage: loss "
          f"{loss_v:.6f} unpipelined plain {ref_v:.6f} (rel {loss_rel:.3e});"
          f" rel_l2 over {len(rel)} parts (wqkv split into q, k, v): max "
          f"{rel[worst]:.3e} ({part_names[worst]}), mean "
          f"{sum(rel) / len(rel):.3e} (limit {PIPE_GRAD_REL_L2:g}); "
          f"launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} "
          f"[{card}]", flush=True)
    check(loss_rel <= PIPE_GRAD_REL_L2,
          f"the pipelined loss is {loss_rel:.3e} from the unpipelined one")
    check(rel[worst] <= PIPE_GRAD_REL_L2,
          f"the pipelined gradient of {part_names[worst]} is "
          f"{rel[worst]:.3e} from the unpipelined one (rel L2), over "
          f"{PIPE_GRAD_REL_L2:g}")
    check(launches == (0, 0, 0), f"the pipelined path launched K1, K2, K3 "
          f"{launches} times; it takes plain attention, as JAX's")


def phase_pipeline_train(mesh, cfg, card: str):
    """The bf16 pipelined train step at full depth on the one-card mesh
    (one stage, PIPE_MICRO microbatches, plain attention), TRAIN_BATCH x
    TRAIN_SEQ tokens: 1 warm-up and PIPE_TRAIN_STEPS timed steps, step ms
    and peak memory; losses finite and falling."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import (init_params, lm_loss_pipelined,
                                      pipelined_param_specs, to_pipelined)
    from ray_tpu_torch.parallel import (adamw, batch_sharding, init_sharded,
                                        make_train_step)

    params = init_sharded(
        lambda: to_pipelined(init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0)), 1),
        pipelined_param_specs(cfg), mesh)
    gc.collect()
    torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1), device="cuda")
    batch = {"tokens": DTensor.from_local(tokens, mesh,
                                          batch_sharding(mesh))}
    optimizer = adamw(1e-4)
    state = optimizer.init(params)
    step = make_train_step(
        lambda p, b: lm_loss_pipelined(p, b, cfg, mesh,
                                       num_microbatches=PIPE_MICRO),
        optimizer)
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)
    losses = [loss]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(PIPE_TRAIN_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    values = [x.item() for x in losses]
    step_ms = dt / PIPE_TRAIN_STEPS * 1e3
    print(f"pipeline train flagship bf16 remat {cfg.remat_policy} "
          f"[{TRAIN_BATCH}, {TRAIN_SEQ}] {PIPE_MICRO} microbatches, one "
          f"stage, plain attention: warm-up step {warm_s:.3f} s; "
          f"{PIPE_TRAIN_STEPS} steps in {dt:.4f} s, step_ms {step_ms:.2f}, "
          f"tokens_per_s {TRAIN_BATCH * TRAIN_SEQ / dt * PIPE_TRAIN_STEPS:.1f}"
          f", peak_memory_bytes {peak} ({peak / 2 ** 30:.2f} GiB), launches "
          f"K1 {launches[0]} K2 {launches[1]} K3 {launches[2]}; losses "
          f"{' '.join(f'{x:.5f}' for x in values)} [{card}]", flush=True)
    check(all(x == x and abs(x) != float("inf") for x in values),
          "a pipelined train loss is not finite")
    check(values[-1] < values[0], f"the pipelined train loss did not fall: "
          f"{values[0]:.5f} -> {values[-1]:.5f}")
    check(launches == (0, 0, 0), f"the pipelined step launched K1, K2, K3 "
          f"{launches} times; it takes plain attention, as JAX's")


def busy_union(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def profile_step(run, step_ms: float, card: str,
                 label: str = "train step"):
    """One train step under `torch.profiler`: the card's kernel time by
    group (the port's attention kernels, matrix products, the rest), the
    largest kernels, each attention kernel's time, and the card's idle
    share, read from this step's own trace: the union of its kernels'
    intervals over the span from the first kernel's start to the last
    one's end. Returns {busy_ms, span_ms, idle, host_ms}, or None when the
    profiler saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    # Device activity (kernels, copies, sets), less user annotations
    # (AdamW's step is one), which span kernels already counted.
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        print("profile: the profiler recorded no kernel on the card",
              flush=True)
        return None
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    busy_ms = busy_union(spans) / 1e3
    total = sum(b - a for a, b in spans) / 1e3
    groups = {"attention (K1, K2, K3)": 0.0, "matrix products": 0.0,
              "other": 0.0}
    by_name = {}
    for e, (a, b) in zip(events, spans):
        name = e.name.lower()
        if "flash_fwd" in name or "flash_bwd" in name:
            group = "attention (K1, K2, K3)"
        elif any(w in name for w in ("gemm", "xmma", "cutlass", "nvjet",
                                     "cublas")):
            group = "matrix products"
        else:
            group = "other"
        groups[group] += (b - a) / 1e3
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (b - a) / 1e3, n + 1)
    print(f"profile {label}: {len(events)} device activities "
          f"({len(by_name)} distinct) sum to {total:.2f} ms; their union "
          f"{busy_ms:.2f} ms over the {span_ms:.2f} ms from the first "
          f"start to the last end, card idle share "
          f"{1 - busy_ms / span_ms:.4f} (profiled step {host_ms:.2f} ms on "
          f"the host clock, unprofiled {step_ms:.2f} ms); "
          + "; ".join(f"{g} {ms:.2f} ms ({ms / total:.3f})"
                      for g, ms in groups.items()) + f" [{card}]",
          flush=True)
    for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                 )[:12]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {kname[:110]}", flush=True)
    for kname, (ms, n) in sorted(by_name.items()):
        if "flash_fwd" in kname or "flash_bwd" in kname:
            print(f"  attention kernel {ms:9.3f} ms  x{n:<5d} "
                  f"{kname[:110]}", flush=True)
    return dict(busy_ms=busy_ms, span_ms=span_ms,
                idle=1 - busy_ms / span_ms, host_ms=host_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import ray_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    if not os.path.abspath(ray_tpu_torch.__file__).startswith(here):
        print("chip_smoke: ray_tpu_torch is not this checkout's",
              file=sys.stderr)
        return 1
    from dataclasses import replace

    from ray_tpu_torch.kernels import build
    from ray_tpu_torch.kernels.flash_attn import HEAD_DIMS
    from ray_tpu_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        name = torch.cuda.get_device_name(0)
        card = smi()
        print(f"device {name} count {torch.cuda.device_count()}",
              flush=True)
        print(card, flush=True)
        try:
            power_w = float(card.split(",")[1].strip().split()[0])
        except (IndexError, ValueError):
            power_w = 0.0

        t0 = time.perf_counter()
        build.build()
        print(f"build {sorted(build.KERNELS)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for kname, info in build.build_log.items():
            fn = kname
            for line in info["log"].splitlines():
                entry = re.search(r"Compiling entry function .*?"
                                  r"(flash_(?:fwd|bwd)_\w+?)ILi(\d+)E", line)
                if entry:
                    fn = f"{entry[1]}<{entry[2]}>"
                elif "registers" in line or "spill" in line or "(C75" in line:
                    print(f"  ptxas {fn}: {line.strip()}")
        libs = build.build()
        counts = {}
        for kname, tc_names in (("flash_attn_fwd", ("flash_fwd_tc",)),
                                ("flash_attn_bwd", ("flash_bwd_dkv_tc",
                                                    "flash_bwd_dq_tc"))):
            counts[kname] = sass_mma_counts(libs[kname])
            tc = {f: c for f, c in counts[kname].items()
                  if any(n in f for n in tc_names)}
            for fn, (hgmma, hmma) in sorted(counts[kname].items()):
                print(f"  sass {kname} {fn}: HGMMA {hgmma} HMMA {hmma}")
            # One instantiation per head dim of each kernel (at D 256 the
            # backward's are the *_tc_wide kernels).
            check(len(tc) == len(HEAD_DIMS) * len(tc_names)
                  and all(c[0] > 0 for c in tc.values()),
                  f"the bf16 kernels of {kname} are not all on the tensor "
                  f"cores (wgmma): {tc}")
        f32 = {f: c for f, c in counts["flash_attn_bwd"].items()
               if "flash_bwd_dkv_f32" in f or "flash_bwd_dq_f32" in f}
        check(len(f32) == 2 * len(HEAD_DIMS)
              and all(c == (0, 0) for c in f32.values()),
              f"the float32 backward kernels are on the CUDA-core route "
              f"but run tensor-core instructions: {f32}")
        print("  sass: the float32 backward kernels run no tensor-core "
              "instruction (CUDA-core route)", flush=True)

        rows = phase_kernels(card, power_w)

        params, cfg = flagship_params()
        phase_forward(params, cfg, card)
        launches, engine_tps = phase_engine(
            params, replace(cfg, dtype=torch.float32), card)
        fleet_launches = phase_fleet(params,
                                     replace(cfg, dtype=torch.float32), card)
        gc.collect()             # the fleets' pools
        torch.cuda.empty_cache()
        serve_launches, serve_tps = phase_serve(
            params, replace(cfg, dtype=torch.float32), card, engine_tps)
        gc.collect()
        torch.cuda.empty_cache()
        cluster_launches = phase_cluster_serve(
            params, replace(cfg, dtype=torch.float32), card, engine_tps,
            serve_tps)
        mux_launches, mux_tps = phase_multiplex(
            replace(cfg, dtype=torch.float32), card, launches)
        phase_trace(replace(cfg, dtype=torch.float32), card, mux_tps)
        phase_microbench(card)
        phase_perf_twins(card)
        bwd_rows = phase_bwd_kernels(card, power_w)
        train_cfg = replace(cfg, remat=True, remat_policy="save_attn_qkv")
        phase_grad(params, train_cfg, card)
        f32_launches = phase_grad_f32(params, train_cfg, card)
        train_launches, train_stats = phase_train(params, train_cfg, card,
                                                  power_w)
        # The dense model's params, gradients and optimizer state go
        # before the train worker and the MoE model are made.
        del params
        gc.collect()
        torch.cuda.empty_cache()
        cluster_train_launches = phase_cluster_train(card, train_stats)
        data_pool_launches, data_train_launches = phase_data(card)
        cgraph_launches = phase_cgraph(card)
        phase_rllib(card)
        d256 = phase_d256(card, power_w)
        gc.collect()
        torch.cuda.empty_cache()
        moe_cfg = replace(train_cfg, **MOE)
        params = init_params(moe_cfg,
                             torch.Generator(device="cuda").manual_seed(2))
        moe_f32_launches = phase_moe_grad_f32(params, moe_cfg, card)
        moe_launches = phase_moe_train(params, moe_cfg, card, power_w)
        # The parallel layer on the mesh of this one card, dense flagship.
        del params
        gc.collect()
        torch.cuda.empty_cache()
        try:
            mesh, mesh_launches = phase_mesh_train(train_cfg, card,
                                                   train_stats)
            phase_pipeline_f32(mesh, train_cfg, card)
            phase_pipeline_train(mesh, train_cfg, card)
        finally:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    main_row = rows[MAIN_SHAPE]
    shape, dtype, layout, qk_scale = MAIN_BWD_SHAPE
    jax_site = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    moe_shape, _, _, _ = MOE_TRAIN_SHAPE
    bwd = [dict(name=f"flash_attn_bwd_{kname}", route="cuda",
                source="ray_tpu_torch/kernels/csrc/flash_attn_bwd.cu",
                replaces="ray_tpu/ops/attention.py:28",
                pallas_call=f"{jax_site}:{line}", launches=n,
                moe_train_launches=m,
                shape=list(shape), dtype=dtype, layout=layout,
                **bwd_rows[(kname, shape, dtype, layout, qk_scale)],
                at_moe_train_shape=dict(
                    shape=list(moe_shape), dtype=dtype, layout=layout,
                    **bwd_rows[(kname,) + MOE_TRAIN_SHAPE]))
           for kname, line, n, m in (
               ("dkv", 1121, train_launches[1], moe_launches[1]),
               ("dq", 1456, train_launches[2], moe_launches[2]))]
    for entry, n, m, d in zip(bwd, mesh_launches[1:],
                              cluster_train_launches[1:],
                              data_train_launches[1:]):
        entry["mesh_train_launches"] = n
        entry["cluster_train_launches_per_step"] = m
        entry["cluster_train_launches_in"] = "the train worker process"
        entry["data_train_launches_per_step"] = d
        entry["data_train_launches_in"] = "the Dataset-fed train worker"
    shape, dtype, layout, qk_scale = F32_BWD_SHAPE
    bwd += [dict(name=f"flash_attn_bwd_{kname}_f32", route="cuda",
                 kernel=f"flash_bwd_{kname}_f32",
                 source="ray_tpu_torch/kernels/csrc/flash_attn_bwd.cu",
                 replaces="ray_tpu/ops/attention.py:28",
                 pallas_call=f"{jax_site}:{line}", launches=n,
                 launches_in="float32 gradient phase",
                 moe_f32_grad_launches=m,
                 shape=list(shape), dtype=dtype, layout=layout,
                 **bwd_rows[(kname, shape, dtype, layout, qk_scale)])
            for kname, line, n, m in (
                ("dkv", 1121, f32_launches[1], moe_f32_launches[1]),
                ("dq", 1456, f32_launches[2], moe_f32_launches[2]))]
    print(json.dumps({"kernels": [dict(
        name="flash_attn_fwd", route="cuda",
        source="ray_tpu_torch/kernels/csrc/flash_attn_fwd.cu",
        replaces="ray_tpu/ops/attention.py:28",
        pallas_call=f"{jax_site}:758", launches=launches,
        fleet_launches=sum(fleet_launches.values()),
        fleet_launches_by_part=fleet_launches,
        serve_launches=serve_launches,
        cluster_serve_launches=cluster_launches,
        cluster_serve_launches_in="the replica process",
        multiplex_launches=mux_launches,
        multiplex_launches_in=("the multiplexed deployment's two replica "
                               "processes, three model ids"),
        train_launches=train_launches[0],
        moe_train_launches=moe_launches[0],
        moe_f32_grad_launches=moe_f32_launches[0],
        mesh_train_launches=mesh_launches[0],
        cluster_train_launches_per_step=cluster_train_launches[0],
        cluster_train_launches_in="the train worker process",
        data_pool_launches_f32=data_pool_launches,
        data_pool_launches_in="the actor pool's two replica processes",
        cgraph_launches_per_stage=cgraph_launches,
        cgraph_launches_in=("each stage process of the compiled two-stage "
                            "pipeline, 24 batches"),
        data_train_launches_per_step=data_train_launches[0],
        data_train_launches_in="the Dataset-fed train worker",
        shape=list(MAIN_SHAPE[0]), dtype=MAIN_SHAPE[1],
        layout=MAIN_SHAPE[2], **main_row,
        at_train_shape=dict(shape=list(TRAIN_SHAPE[0]),
                            dtype=TRAIN_SHAPE[1], layout=TRAIN_SHAPE[2],
                            **rows[TRAIN_SHAPE]),
        at_moe_train_shape=dict(shape=list(moe_shape),
                                dtype=MOE_TRAIN_SHAPE[1],
                                layout=MOE_TRAIN_SHAPE[2],
                                **rows[MOE_TRAIN_SHAPE]))] + bwd
        + d256_kernel_entries(rows, bwd_rows, d256)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
